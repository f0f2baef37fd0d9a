"""Whole-solve batched iLQR on the card: the wrapper of the hand-written
CUDA kernel ``csrc/ilqr_fused.cu`` and its plain PyTorch version.

Counterpart of ``dilqr_tpu/ops/pallas/ilqr_fused.py`` (``ilqr_fused`` and
the Pallas kernel ``_ilqr_kernel``) for the configurations ``covered``
admits: static per-control bounds, an example-invariant QuadCost
([n,n]+[n] or [T,n,n]+[T,n]), a zero or given warm start,
GradMethod.ANALYTIC with the env's hand-derived Jacobian, f32, and an env
with device code: cartpole and the simple pendulum (n_ctrl == 1, the
closed-form 1-D box-QP) and the rocket (n_ctrl == 3, the in-kernel
projected-Newton box-QP).

Semantics, shared by the kernel and ``ilqr_fused_reference``: the batch is
zero-padded to a multiple of 1024 with the real cost, and the line search's
any(cost worsened), the not-improved reset's any(improved), the stopping
rule's max(du) < eps and the box-QP's Newton and Armijo exits are decided
per 1024-example tile, as the JAX kernel decides them (ilqr_fused.py:35-47,
:570-678). The env steps and Jacobians are the kernel forms
(``Dynamics.kernel_step`` / ``jac_lanes``).

Launch geometry (``geometry``): one tile is one thread-block cluster of G
blocks, 1024/G examples a block, one thread an example; the tile's
decisions are cluster votes. G is 8 unless a caller measuring the kernel
passes another (``cluster``); the result does not depend on it. A launch
the card refuses raises: nothing falls back to another geometry or to the
plain version.

``ilqr_fused`` launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ...models.base import Dynamics
from ...types import GradMethod, ILQRConfig
from ...utils.batch import clamp, inv_small
from ..pnqp import ARMIJO_DECAY, CONV_TOL, GAMMA, MAX_ARMIJO_ITER, REG
from . import build

SOURCE = "ilqr_fused.cu"
TILE = 1024  # examples per tile: the JAX kernel's base tile
# cluster sizes G (blocks a tile) csrc/ilqr_fused.cu instantiates
CLUSTERS = (8, 16)
DEFAULT_CLUSTER = 8
# device_env -> (params, controls) the device code reads
DEVICE_ENVS = {0: (4, 1), 1: (3, 1), 2: (5, 3)}
MAX_NU = 3  # kMaxNu in csrc/ilqr_fused.cuh: the length of the bound arrays

# kernel launches made by ilqr_fused (the plain version does not count)
LAUNCHES = 0


def _bound_is_static(v, nu: int) -> bool:
    return (v is None or isinstance(v, (int, float))
            or (isinstance(v, torch.Tensor) and (v.dim() == 0 or tuple(v.shape) == (nu,))))


def static_bounds(u_lower, u_upper, nu: int) -> Optional[Tuple[Tuple[float, ...], ...]]:
    """Per-control (lo, hi) tuples of floats for example- and
    time-invariant bounds (None | scalar | [nu] tensor), with one host read
    for the tensors among them; None = the bounds vary over time or
    examples and the kernel does not take them. A missing bound is +-inf."""
    if not (_bound_is_static(u_lower, nu) and _bound_is_static(u_upper, nu)):
        return None
    dev = next((v.device for v in (u_lower, u_upper) if isinstance(v, torch.Tensor)), "cpu")
    lo, hi = torch.stack([
        torch.as_tensor(sign * math.inf if v is None else v, dtype=torch.float64,
                        device=dev).expand(nu)
        for v, sign in ((u_lower, -1.0), (u_upper, 1.0))]).tolist()
    return tuple(lo), tuple(hi)


def covered(cfg: ILQRConfig, dyn, params, dtype, cost_small, u_zero_I, delta_u,
            u_lower, u_upper) -> bool:
    """True when the configuration is one the kernel computes (counterpart
    of ``fused_supported`` plus ``lane_compatible`` for this subset)."""
    return (
        isinstance(dyn, Dynamics)
        and dyn.device_env in DEVICE_ENVS
        and dyn.jacobian is None
        and cfg.n_ctrl == dyn.n_ctrl == DEVICE_ENVS[dyn.device_env][1]
        and cfg.n_state == dyn.n_state
        and cfg.grad_method is GradMethod.ANALYTIC
        and cfg.qp_solver == "auto"
        and not cfg.unroll
        and cfg.verbose < 1
        and cfg.slew_rate_penalty is None
        and dtype == torch.float32
        and cost_small is not None
        and u_zero_I is None
        and delta_u is None
        and _bound_is_static(u_lower, cfg.n_ctrl)
        and _bound_is_static(u_upper, cfg.n_ctrl)
        and isinstance(params, torch.Tensor)
        and params.dim() == 1
        and params.shape[0] == DEVICE_ENVS[dyn.device_env][0]
    )


def _padded(B: int) -> int:
    return -(-B // TILE) * TILE


class Geometry(NamedTuple):
    Bp: int        # the batch padded to whole tiles
    tiles: int     # clusters (1024-example tiles)
    cluster: int   # blocks a cluster, G
    block: int     # examples (threads) a block, 1024 / G
    blocks: int    # blocks in the launch


def geometry(B: int, cluster: int = 0) -> Geometry:
    """The kernel's launch shape for a batch of B; ``cluster`` 0 takes the
    default G."""
    G = cluster or DEFAULT_CLUSTER
    if G not in CLUSTERS:
        raise ValueError(f"ilqr_fused instantiates clusters of {CLUSTERS} blocks; got {G}")
    Bp = _padded(B)
    return Geometry(Bp, Bp // TILE, G, TILE // G, Bp // TILE * G)


def _cost_arrays(cost_small, T: int, n: int, device):
    """Example-invariant cost as f32 (C [Tc, n, n], c [Tc, n]), Tc in {1, T}."""
    Cs, cs = (torch.as_tensor(a, device=device).to(torch.float32) for a in cost_small)
    if Cs.dim() == 2:
        Cs, cs = Cs[None], cs[None]
    if Cs.shape[1:] != (n, n) or cs.shape[1:] != (n,) or Cs.shape[0] not in (1, T) \
            or cs.shape[0] != Cs.shape[0]:
        raise ValueError(
            f"cost_small must be ([n,n], [n]) or ([T,n,n], [T,n]) with n={n}, "
            f"T={T}; got {tuple(Cs.shape)}, {tuple(cs.shape)}")
    return Cs, cs


def _check_inputs(cfg, dyn, params, x_init, u_init, u_lower, u_upper):
    """Validates the inputs; returns the static bounds."""
    if dyn.device_env not in DEVICE_ENVS or cfg.n_ctrl != DEVICE_ENVS[dyn.device_env][1]:
        raise ValueError("ilqr_fused covers cartpole, the simple pendulum (n_ctrl == 1) "
                         "and the rocket with normalize_quat=False (n_ctrl == 3)")
    n_params = DEVICE_ENVS[dyn.device_env][0]
    if x_init.dtype != torch.float32:
        raise ValueError(f"ilqr_fused is f32 only, got {x_init.dtype}")
    if x_init.dim() != 2 or x_init.shape[1] != cfg.n_state:
        raise ValueError(f"x_init must be [B, {cfg.n_state}], got {tuple(x_init.shape)}")
    if params.dim() != 1 or params.shape[0] != n_params:
        raise ValueError(f"params must be [{n_params}], got {tuple(params.shape)}")
    nu = cfg.n_ctrl
    if u_init is not None and tuple(u_init.shape) != (cfg.T, x_init.shape[0], nu):
        raise ValueError(f"u_init must be [T, B, {nu}], got {tuple(u_init.shape)}")
    for name, t in (("params", params), ("u_init", u_init)):
        if t is not None and t.device != x_init.device:
            raise ValueError(f"{name} is on {t.device}, x_init on {x_init.device}")
    bounds = static_bounds(u_lower, u_upper, nu)
    if bounds is None:
        raise ValueError("ilqr_fused takes example- and time-invariant bounds only "
                         f"(None, a scalar or [{nu}])")
    return bounds


def ilqr_fused(cfg: ILQRConfig, dyn: Dynamics, params: torch.Tensor,
               x_init: torch.Tensor, cost_small, u_init: Optional[torch.Tensor] = None,
               u_lower=None, u_upper=None, cluster: int = 0):
    """Run the whole solve. x_init [B, nx]; cost_small the example-invariant
    (C, c); u_init [T, B, nu] time-major or None (zeros); u_lower/u_upper
    None, a scalar or [nu]. Returns time-major (x [T,B,nx], u [T,B,nu],
    costs [B], full_du_norm [B], n_iter []). ``cluster``: blocks a tile, 0
    for the default (the result does not depend on it).

    CUDA tensors launch the kernel; CPU tensors take ilqr_fused_reference."""
    if not x_init.is_cuda:
        return ilqr_fused_reference(cfg, dyn, params, x_init, cost_small, u_init,
                                    u_lower=u_lower, u_upper=u_upper)
    return _launch(cfg, dyn, params, x_init, cost_small, u_init, u_lower, u_upper, cluster)[0]


def ilqr_fused_probe(cfg: ILQRConfig, dyn: Dynamics, params: torch.Tensor,
                     x_init: torch.Tensor, cost_small, u_init: Optional[torch.Tensor] = None,
                     u_lower=None, u_upper=None, cluster: int = 0):
    """One launch of the kernel on CUDA tensors that also records what it
    did: (ilqr_fused's outputs, per tile [tiles, 3] the votes it took, the
    SM clock cycles its rank-0 thread 0 spent in them and in the whole
    kernel, the SM each block ran on [blocks])."""
    if not x_init.is_cuda:
        raise ValueError("ilqr_fused_probe launches the kernel: x_init must be on the card")
    return _launch(cfg, dyn, params, x_init, cost_small, u_init, u_lower, u_upper, cluster,
                   probe=True)


def _launch(cfg, dyn, params, x_init, cost_small, u_init, u_lower, u_upper, cluster,
            probe=False):
    global LAUNCHES
    lo, hi = _check_inputs(cfg, dyn, params, x_init, u_init, u_lower, u_upper)
    T, B, nx, nu = cfg.T, x_init.shape[0], cfg.n_state, cfg.n_ctrl
    geo = geometry(B, cluster)
    n = nx + nu
    dev = x_init.device
    Bp = geo.Bp
    Cs, cs = _cost_arrays(cost_small, T, n, dev)
    Cs = Cs.reshape(Cs.shape[0], n * n).contiguous()
    cs = cs.contiguous()
    xi = torch.zeros(nx, Bp, dtype=torch.float32, device=dev)
    xi[:, :B] = x_init.T
    u0 = None
    if u_init is not None:
        u0 = torch.zeros(T, nu, Bp, dtype=torch.float32, device=dev)
        u0[:, :, :B] = u_init.permute(0, 2, 1)
    p = params.to(torch.float32).contiguous()

    # three trajectories [T, nx + nu, Bp], K [T, nu*nx, Bp], k [T, nu, Bp]
    work = torch.empty(T * (3 * (nx + nu) + nu * nx + nu) * Bp, dtype=torch.float32, device=dev)
    bx = torch.zeros(T, nx, Bp, dtype=torch.float32, device=dev)
    bu = torch.zeros(T, nu, Bp, dtype=torch.float32, device=dev)
    bc = torch.empty(Bp, dtype=torch.float32, device=dev)
    bdu = torch.empty(Bp, dtype=torch.float32, device=dev)
    iters = torch.empty(geo.tiles, dtype=torch.int32, device=dev)
    stats = torch.zeros(geo.tiles, 3, dtype=torch.int64, device=dev) if probe else None
    smids = torch.full((geo.blocks,), -1, dtype=torch.int32, device=dev) if probe else None

    fn = _entry()
    # kMaxNu-long arrays for the kernel's arguments, the env's bounds first
    pad = (0.0,) * (MAX_NU - nu)
    lo_c, hi_c = ((ctypes.c_float * MAX_NU)(*v, *pad) for v in (lo, hi))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(dyn.device_env, T, Bp, Cs.shape[0], p.data_ptr(), xi.data_ptr(),
                Cs.data_ptr(), cs.data_ptr(), 0 if u0 is None else u0.data_ptr(),
                lo_c, hi_c, cfg.lqr_iter, cfg.eps, cfg.linesearch_decay,
                cfg.max_linesearch_iter, cfg.best_cost_eps, cfg.not_improved_lim,
                cfg.pnqp_iter, geo.cluster, work.data_ptr(), bx.data_ptr(), bu.data_ptr(),
                bc.data_ptr(), bdu.data_ptr(), iters.data_ptr(),
                0 if stats is None else stats.data_ptr(),
                0 if smids is None else smids.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ilqr_fused kernel launch failed ({geo.tiles} clusters of "
                           f"{geo.cluster} blocks of {geo.block} threads): CUDA error {rc}")
    LAUNCHES += 1
    out = (bx.permute(0, 2, 1)[:, :B], bu.permute(0, 2, 1)[:, :B], bc[:B], bdu[:B],
           iters.max())
    return out, stats, smids


def kernel_info(device_env: int, cluster: int = 0) -> dict:
    """What the card says of one instantiation: the clusters of G blocks it
    can hold at once (cudaOccupancyMaxActiveClusters), registers and local
    bytes a thread, static and dynamic shared bytes a block."""
    G = geometry(TILE, cluster).cluster
    fn = build.load(SOURCE).dilqr_ilqr_fused_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(device_env, G, out)
    if rc != 0:
        raise RuntimeError(f"ilqr_fused_info (env {device_env}, cluster {G}): CUDA error {rc}")
    keys = ("max_active_clusters", "registers", "local_bytes", "static_smem", "dynamic_smem")
    return dict(zip(keys, out), cluster=G)


def _entry():
    fn = build.load(SOURCE).dilqr_ilqr_fused
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I, I, I, I, P, P, P, P, P, P, P, I, F, F, I, F, I, I, I,
                       P, P, P, P, P, P, P, P, P]
        fn.restype = I
    return fn


def _pnqp_tiles(H, q, lb, ub, x0, n_iter: int, tile: int):
    """The kernel's box-QP over a batch [Bp, nu] of examples in tiles of
    ``tile`` (counterpart of ``_pnqp_lanes``): per-tile Newton exit (no
    example with ||dx|| >= 1e-4) and Armijo exit (max(armijo) > 0.1, NaN
    included); a done tile's iterate stays. Returns (x, If, H_free) with
    If/H_free of the last Newton step. Not ops/pnqp.pnqp: that one exits
    over the whole batch."""
    Bp, nu = q.shape
    G = Bp // tile
    eye = torch.eye(nu, dtype=H.dtype, device=H.device)

    def mv(A, x):
        return (A * x[:, None, :]).sum(-1)

    def obj(x):
        return 0.5 * (x * mv(H, x)).sum(-1) + (q * x).sum(-1)

    def newton(x):
        g = mv(H, x) + q
        Ic = ((x <= lb) & (g > 0.0)) | ((x >= ub) & (g < 0.0))
        If = torch.where(Ic, 0.0, 1.0).to(H.dtype)
        Hf = H * If[:, :, None] * If[:, None, :] + REG * eye
        return g, If, Hf, -mv(inv_small(Hf), g * If)

    sentinel = torch.full((Bp,), GAMMA + 1e-6, dtype=H.dtype, device=H.device)
    x = clamp(x0, lb, ub)
    g, If, Hf, dx = newton(x)
    for i in range(n_iter):
        if i > 0:
            g, If, Hf, dx = newton(x)
        J = torch.sqrt((dx * dx).sum(-1)) >= CONV_TOL
        run = J.view(G, tile).any(1)
        if not bool(run.any()):
            break
        ox = obj(x)
        alpha = torch.ones(Bp, dtype=H.dtype, device=H.device)
        mx, cont = x, run
        for _ in range(MAX_ARMIJO_ITER):
            nmx = clamp(x + alpha[:, None] * dx, lb, ub)
            arm = torch.where(J, (ox - obj(nmx)) / (g * (x - nmx)).sum(-1), sentinel)
            c = cont.repeat_interleave(tile)
            mx = torch.where(c[:, None], nmx, mx)
            alpha = torch.where(c & (arm <= GAMMA), alpha * ARMIJO_DECAY, alpha)
            cont = cont & (arm <= GAMMA).view(G, tile).all(1)
            if not bool(cont.any()):
                break
        x = torch.where(run.repeat_interleave(tile)[:, None], mx, x)
    return x, If, Hf


def _q_terms(C, c, tau, F, V, v):
    """Q = C + F^T (V F) and q = C tau + c + F^T v over the batch."""
    FT = F.transpose(-1, -2)
    return C + FT @ (V.transpose(-1, -2) @ F), tau @ C.T + c + (FT @ v[..., None])[..., 0]


def _box_gains(Q, q, nx: int, ut, lo, hi, warm, n_iter: int, tile: int):
    """The n_ctrl > 1 Riccati step's box-QP, gains and V/v update from Q
    [Bp, n, n] and q [Bp, n] at the controls ut [Bp, nu], bounds lo/hi
    [nu]: the per-tile box-QP in delta space warm-started with ``warm``
    (k_{t+1}; None at T-1: the clipped ridged Newton point), K =
    -inv(H_free) (Q_ux * If), V' = Qxx + M + M^T + K^T Quu K with M = Qxu K,
    v' = qx + Qxu k + K^T (qu + Quu k). Returns (K, k, V', v')."""
    Quu, qu = Q[:, nx:, nx:], q[:, nx:]
    lb, ub = lo - ut, hi - ut
    if warm is None:
        eye = torch.eye(qu.shape[1], dtype=Q.dtype, device=Q.device)
        warm = clamp(-(inv_small(Quu + REG * eye) @ qu[..., None])[..., 0], lb, ub)
    kt, If, Hf = _pnqp_tiles(Quu, qu, lb, ub, warm, n_iter, tile)
    Kt = -(inv_small(Hf) @ (Q[:, nx:, :nx] * If[:, :, None]))
    M = Q[:, :nx, nx:] @ Kt
    V = Q[:, :nx, :nx] + M + M.transpose(-1, -2) + Kt.transpose(-1, -2) @ (Quu @ Kt)
    v = (q[:, :nx] + (Q[:, :nx, nx:] @ kt[..., None])[..., 0]
         + (Kt.transpose(-1, -2) @ (qu + (Quu @ kt[..., None])[..., 0])[..., None])[..., 0])
    return Kt, kt, V, v


def ilqr_fused_reference(cfg: ILQRConfig, dyn: Dynamics, params: torch.Tensor,
                         x_init: torch.Tensor, cost_small,
                         u_init: Optional[torch.Tensor] = None,
                         u_lower=None, u_upper=None):
    """The kernel's function in plain PyTorch, on the tensors' own device:
    the same padding, per-tile decisions, kernel-form step and Jacobian,
    Riccati arithmetic (the closed-form QP for n_ctrl == 1, the per-tile
    box-QP with explicit inverses and the kernel's warm start otherwise)
    and accept/best-tracking order. Same arguments and returns as
    ilqr_fused."""
    lo, hi = _check_inputs(cfg, dyn, params, x_init, u_init, u_lower, u_upper)
    T, B, nx, nu = cfg.T, x_init.shape[0], cfg.n_state, cfg.n_ctrl
    n = nx + nu
    f32, dev = torch.float32, x_init.device
    Bp = _padded(B)
    G = Bp // TILE
    Cs, cs = _cost_arrays(cost_small, T, n, dev)
    Cf = (lambda t: Cs[0]) if Cs.shape[0] == 1 else (lambda t: Cs[t])
    cf = (lambda t: cs[0]) if cs.shape[0] == 1 else (lambda t: cs[t])
    p = params.to(f32)
    step, jac = dyn.kernel_step, dyn.jac_lanes
    if nu == 1:
        lo, hi = lo[0], hi[0]
    else:
        lo, hi = (torch.tensor(v, dtype=f32, device=dev) for v in (lo, hi))

    x0 = torch.zeros(Bp, nx, dtype=f32, device=dev)
    x0[:B] = x_init
    u = torch.zeros(T, Bp, nu, dtype=f32, device=dev)
    if u_init is not None:
        u[:, :B] = u_init

    def obj(t, xt, ut):
        tau = torch.cat([xt, ut], -1)
        Ctau = (Cf(t) * tau[:, None, :]).sum(-1)
        return 0.5 * (tau * Ctau).sum(-1) + (cf(t) * tau).sum(-1)

    def lanes(m):  # [G] per-tile value -> [Bp]
        return m.repeat_interleave(TILE)

    def tiles(v):  # [Bp] -> [G, TILE]
        return v.view(G, TILE)

    # 1) initial open-loop rollout and objective
    xs, oc, xt = [], torch.zeros(Bp, dtype=f32, device=dev), x0
    for t in range(T):
        xs.append(xt)
        oc = oc + obj(t, xt, u[t])
        xt = step(xt, u[t], p)
    x = torch.stack(xs)

    bx = torch.zeros(T, Bp, nx, dtype=f32, device=dev)
    bu = torch.zeros(T, Bp, nu, dtype=f32, device=dev)
    bc = torch.full((Bp,), float("inf"), dtype=f32, device=dev)
    bdu = bc.clone()
    stopped = torch.zeros(G, dtype=torch.bool, device=dev)
    nni = torch.zeros(G, dtype=torch.int64, device=dev)
    iters = torch.zeros(G, dtype=torch.int32, device=dev)
    zF = torch.zeros(Bp, nx, n, dtype=f32, device=dev)

    for it in range(cfg.lqr_iter):
        run = ~stopped
        if not bool(run.any()):
            break
        run_l = lanes(run)

        # 2-5) Riccati with F = jac (zero at T-1), delta-space shift,
        # box-QP gains, V/v update
        V = torch.zeros(Bp, nx, nx, dtype=f32, device=dev)
        v = torch.zeros(Bp, nx, dtype=f32, device=dev)
        K, k = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            xt, ut = x[t], u[t]
            Ct = Cf(t)
            tau = torch.cat([xt, ut], -1)
            F = jac(xt, ut, p) if t < T - 1 else zF
            Q, q = _q_terms(Ct, cf(t), tau, F, V, v)
            if nu == 1:
                # exact closed-form 1-D box-QP
                H, qu, ut = Q[:, nx, nx], q[:, nx], ut[:, 0]
                lb, ub = lo - ut, hi - ut
                kt = clamp(-qu / H, lb, ub)
                g = H * kt + qu
                Ic = ((kt <= lb) & (g > 0.0)) | ((kt >= ub) & (g < 0.0))
                If = torch.where(Ic, 0.0, 1.0).to(f32)
                Hinv = 1.0 / (H * If + 1e-11)
                Kt = -(Hinv[:, None] * (Q[:, nx, :nx] * If[:, None]))
                M = Q[:, :nx, nx:] * Kt[:, None, :]
                V = (Q[:, :nx, :nx] + M + M.transpose(-1, -2)
                     + Kt[:, :, None] * (H[:, None, None] * Kt[:, None, :]))
                v = q[:, :nx] + Q[:, :nx, nx] * kt[:, None] + Kt * (qu + H * kt)[:, None]
                K[t], k[t] = Kt, kt[:, None]
                continue
            # the per-tile box-QP, warm-started with this sweep's k_{t+1}
            # (at T-1 with the clipped ridged Newton point)
            K[t], k[t], V, v = _box_gains(Q, q, nx, ut, lo, hi, k[t + 1] if t < T - 1 else None,
                                          cfg.pnqp_iter, TILE)

        # 6) line search; the trial runs on every lane and is kept on the
        # lanes of tiles that run it
        def trial(alpha):
            xt, cost, du2 = x0, torch.zeros_like(alpha), torch.zeros_like(alpha)
            txs, tus = [], []
            for t in range(T):
                if nu == 1:
                    kdx = (K[t] * (xt - x[t])).sum(-1, keepdim=True)
                else:
                    kdx = (K[t] * (xt - x[t])[:, None, :]).sum(-1)
                new_u = clamp(kdx + u[t] + alpha[:, None] * k[t], lo, hi)
                d = u[t] - new_u
                du2 = du2 + (d * d).sum(-1)
                txs.append(xt)
                tus.append(new_u)
                cost = cost + obj(t, xt, new_u)
                xt = step(xt, new_u, p)
            return cost, du2, torch.stack(txs), torch.stack(tus)

        alpha = torch.ones(Bp, dtype=f32, device=dev)
        cc, du2s, tx, tu = oc.clone(), torch.zeros_like(oc), x, u
        for i in range(cfg.max_linesearch_iter):
            active = run if i == 0 else run & tiles(cc > oc).any(1)
            if bool(active.any()):
                cost, du2, ntx, ntu = trial(alpha)
                a = lanes(active)
                cc = torch.where(a, cost, cc)
                tx = torch.where(a[None, :, None], ntx, tx)
                tu = torch.where(a[None, :, None], ntu, tu)
                if i == 0:
                    du2s = torch.where(a, du2, du2s)
            alpha = torch.where(cc > oc, alpha * cfg.linesearch_decay, alpha)
        cur_du = torch.sqrt(du2s)

        # 7) accept the last trial and track the best
        improved = (cc <= bc + cfg.best_cost_eps) & run_l
        x = torch.where(run_l[None, :, None], tx, x)
        u = torch.where(run_l[None, :, None], tu, u)
        bx = torch.where(improved[None, :, None], tx, bx)
        bu = torch.where(improved[None, :, None], tu, bu)
        oc = torch.where(run_l, cc, oc)
        bc = torch.where(improved, cc, bc)
        bdu = torch.where(improved, cur_du, bdu)

        # 8) per-tile stopping rule (NaN du compares False, as in the kernel)
        imp_tile = tiles(improved).any(1)
        nni_new = torch.where(imp_tile & (it > 0), torch.zeros_like(nni), nni + 1)
        stop = (tiles(cur_du).amax(1) < cfg.eps) | (nni_new > cfg.not_improved_lim)
        nni = torch.where(run, nni_new, nni)
        stopped = stopped | (run & stop)
        iters = iters + run.to(torch.int32)

    return bx[:, :B], bu[:, :B], bc[:B], bdu[:B], iters.max()

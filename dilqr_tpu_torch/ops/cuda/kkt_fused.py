"""Module-KKT VJP on the card: the wrapper of the hand-written CUDA kernel
``csrc/kkt_fused.cu`` and its plain PyTorch version.

Counterpart of ``dilqr_tpu/ops/pallas/kkt_fused.py`` (``make_kkt_vjp_pallas``,
the Pallas kernels ``_kkt_kernel`` / ``_kkt_stream_kernel`` and the rank-1
assembly the JAX wrapper leaves to XLA, kkt_fused.py:561-572): for a fixed
solution point (C, c, F, x, u) and frozen active set, one call maps a
cotangent (g_x, g_u) to the auxiliary LQR's solution dtau, the two adjoint
recursions lam and dlam, and from them

    dF_t = -(dlam_{t+1} tau_t^T + lam_{t+1} dtau_t^T),   df_t = -dlam_{t+1},

and in full mode dx_init = -dlam_0, the symmetrized dC = -1/2 (dtau tau^T +
tau dtau^T) and dc = -dtau. On the card that is one kernel launch.

``make_kkt_vjp_cuda`` lays the cotangent-invariant operands out once
(``prepare``: one slab per step and example, [T, B, S]) and returns
``call(g_x, g_u, full)``; the IFT GMRES loop calls it every iteration. CUDA
tensors launch the kernel; CPU tensors take ``kkt_fused_reference``; there
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...utils.batch import inv_small
from . import build

SOURCE = "kkt_fused.cu"
# the largest n_state for each n_ctrl: what the JAX package's gate admits
# (kkt_fused_supported; its VMEM budget, whatever the horizon)
MAX_N_STATE = {1: 16, 2: 15, 3: 14}
BLOCK = 128            # threads a block by default
BLOCKS = (64, 128, 256)  # the block sizes the kernel takes; the bits do not change

# kernel launches made by kkt_fused (the plain version does not count)
LAUNCHES = 0


def covered(T: int, n_state: int, n_ctrl: int, dtype, parallel: bool = False) -> bool:
    """True when the kernel computes this shape -- exactly the shapes JAX's
    ``kkt_fused_supported`` admits: f32, T >= 2, not the parallel Riccati,
    n_ctrl 1..3 with n_state 1..16, 1..15, 1..14."""
    return (dtype == torch.float32 and T >= 2 and not parallel
            and 1 <= n_state <= MAX_N_STATE.get(n_ctrl, 0))


def slab_layout(n_state: int, n_ctrl: int) -> Dict[str, Tuple[int, int]]:
    """(start, end) of each part of a step's slab (csrc/kkt_fused.cuh
    kkt_layout): C's packed upper triangle, F [nx, nF] (rows padded with
    zeros to nF, a multiple of 4), the mask [nu], the adjoint offset [nx],
    tau [n]; the triangle and the slab padded to a multiple of 4 floats, so
    that F's rows and every slab are 16-byte aligned. "S" is (0, S)."""
    nx, nu = n_state, n_ctrl
    n = nx + nu
    r4 = lambda v: (v + 3) // 4 * 4  # noqa: E731
    out = {"C": (0, n * (n + 1) // 2)}
    o = r4(out["C"][1])
    for name, k in (("F", nx * r4(n)), ("uz", nu), ("lb", nx), ("tau", n)):
        out[name] = (o, o + k)
        o += k
    out["S"] = (0, r4(o))
    return out


def _tri_index(n: int):
    """Row-major (i, j >= i) pairs of the packed upper triangle."""
    iu = [(i, j) for i in range(n) for j in range(i, n)]
    return [p[0] for p in iu], [p[1] for p in iu]


class KKTOperands:
    """The cotangent-invariant operands: ``slab`` [T, B, S], one run of S
    floats per step and example (``slab_layout``), and, once a call has
    needed it, the kernel's global K/k/dtau store."""

    def __init__(self, n_state: int, n_ctrl: int, slab: torch.Tensor):
        self.n_state, self.n_ctrl, self.slab = n_state, n_ctrl, slab
        self.T, self.B = slab.shape[0], slab.shape[1]
        self.store: Optional[torch.Tensor] = None

    def part(self, name: str) -> torch.Tensor:
        a, b = slab_layout(self.n_state, self.n_ctrl)[name]
        return self.slab[..., a:b]


def prepare(n_state: int, n_ctrl: int, C, c, F, x, u, u_zero_I=None) -> KKTOperands:
    """Lay the operands out once. C [T,B,n,n], c [T,B,n], F [T-1,B,nx,n],
    x [T,B,nx], u [T,B,nu], u_zero_I [T,B,nu] bool or None."""
    T, B = C.shape[0], C.shape[1]
    nx, nu = n_state, n_ctrl
    n = nx + nu
    if T < 2:
        raise ValueError(f"the KKT VJP needs T >= 2, got T={T}")
    if C.shape[2:] != (n, n) or F.shape != (T - 1, B, nx, n):
        raise ValueError(f"C must be [T,B,{n},{n}] and F [T-1,B,{nx},{n}]; got "
                         f"{tuple(C.shape)}, {tuple(F.shape)}")
    tau = torch.cat([x, u], -1)
    ii, jj = _tri_index(n)
    lay = slab_layout(nx, nu)
    slab = torch.zeros(T, B, lay["S"][1], dtype=C.dtype, device=C.device)
    part = lambda name: slab[..., lay[name][0]:lay[name][1]]  # noqa: E731
    part("C").copy_(C[:, :, ii, jj])
    part("F").unflatten(-1, (nx, -1))[:T - 1, :, :, :n] = F
    if u_zero_I is not None:
        part("uz").copy_(u_zero_I)
    part("lb").copy_(torch.einsum("tbij,tbj->tbi", C[:, :, :nx, :], tau) + c[:, :, :nx])
    part("tau").copy_(tau)
    return KKTOperands(nx, nu, slab)


def _outputs(ops: KKTOperands, full: bool):
    nx, n, T, B = ops.n_state, ops.n_state + ops.n_ctrl, ops.T, ops.B
    e = lambda *s: torch.empty(*s, dtype=torch.float32, device=ops.slab.device)  # noqa: E731
    dF, df = e(T - 1, B, nx, n), e(T - 1, B, nx)
    if not full:
        return None, None, None, dF, df
    return e(B, nx), e(T, B, n, n), e(T, B, n), dF, df


def kkt_fused(ops: KKTOperands, g_x: torch.Tensor, g_u: torch.Tensor, full: bool = True,
              block: int = BLOCK, store: str = "auto"):
    """One VJP: (dx_init, dC, dc, dF, df), the first three None when
    ``full`` is False. g_x [T,B,nx], g_u [T,B,nu] as the caller has them
    (any T and B strides, unit last stride). CUDA tensors launch the kernel,
    one launch; CPU tensors take kkt_fused_reference. ``block`` (threads a
    block) and ``store="global"`` (K, k and dtau in device memory whatever
    the horizon) change the launch, never the bits; the card tests and
    chip_smoke.py use them."""
    if not g_x.is_cuda:
        return kkt_fused_reference(ops, g_x, g_u, full)
    global LAUNCHES
    nx, nu, T, B = ops.n_state, ops.n_ctrl, ops.T, ops.B
    if not covered(T, nx, nu, ops.slab.dtype):
        raise ValueError(f"kkt_fused covers f32, T >= 2, n_ctrl 1..3 and n_state up to "
                         f"{MAX_N_STATE}; got ({nx}, {nu}), T={T}, {ops.slab.dtype}")
    if block not in BLOCKS or store not in ("auto", "global"):
        raise ValueError(f"block must be one of {BLOCKS} and store 'auto' or 'global'")
    g = []
    for name, a, k in (("g_x", g_x, nx), ("g_u", g_u, nu)):
        if tuple(a.shape) != (T, B, k) or a.dtype != torch.float32 or a.device != ops.slab.device:
            raise ValueError(f"{name} must be a float32 [{T}, {B}, {k}] tensor on "
                             f"{ops.slab.device}; got {a.dtype} {tuple(a.shape)} on {a.device}")
        g.append(a if a.stride(-1) == 1 else a.contiguous())
    p = _plan(nx, nu, T, block, store == "global")
    if p["global"] and (ops.store is None or ops.store.numel() < T * B * p["KS"]):
        ops.store = torch.empty(T * B * p["KS"], dtype=torch.float32, device=ops.slab.device)
    dxi, dC, dc, dF, df = _outputs(ops, full)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dev = ops.slab.device
    with torch.cuda.device(dev):
        rc = _entry("dilqr_kkt_fused")(
            nx, nu, T, B, block, int(store == "global"), ops.slab.data_ptr(),
            g[0].data_ptr(), g[0].stride(0), g[0].stride(1),
            g[1].data_ptr(), g[1].stride(0), g[1].stride(1),
            dF.data_ptr(), df.data_ptr(), ptr(dxi), ptr(dC), ptr(dc),
            ptr(ops.store) if p["global"] else None, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kkt_fused kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return dxi, dC, dc, dF, df


_PLANS: Dict[tuple, dict] = {}


def _plan(nx: int, nu: int, T: int, block: int, force_global: bool) -> dict:
    """The kernel's launch plan (csrc/kkt_fused.cu plan): team size, teams
    a block, shared bytes a block, whether K/k/dtau go to the global store
    and its floats a step."""
    key = (nx, nu, T, block, force_global)
    if key not in _PLANS:
        out = (ctypes.c_int * 6)()
        rc = _entry("dilqr_kkt_plan")(nx, nu, T, block, int(force_global), out)
        if rc != 0:
            raise ValueError(f"kkt_fused has no launch plan for ({nx}, {nu}), block {block}")
        if out[5] != slab_layout(nx, nu)["S"][1]:
            raise RuntimeError("internal: the kernel's slab layout differs from prepare's")
        _PLANS[key] = dict(zip(("L", "teams", "smem", "global", "KS"), list(out)[:5]))
    return _PLANS[key]


def plan(ops: KKTOperands, block: int = BLOCK, store: str = "auto") -> dict:
    """The launch plan of ``kkt_fused(ops, ..., block=block, store=store)``."""
    return _plan(ops.n_state, ops.n_ctrl, ops.T, block, store == "global")


def _entry(name: str):
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([I, I, I, I, I, P] if name == "dilqr_kkt_plan" else
                       [I, I, I, I, I, I, P, P, L, L, P, L, L] + [P] * 7)
        fn.restype = I
    return fn


def kkt_fused_reference(ops: KKTOperands, g_x: torch.Tensor, g_u: torch.Tensor,
                        full: bool = True):
    """The kernel's function in plain PyTorch over the batch, on the
    tensors' own device: the same slab (packed-triangle C), zero-mask gains
    (k divides by the unmasked Quu for nu == 1, closed-form inverse for
    nu = 2, 3), V/v update, rollout, recursions and assembly. Same arguments
    and returns as kkt_fused."""
    nx, nu, T, B = ops.n_state, ops.n_ctrl, ops.T, ops.B
    n = nx + nu
    dt = ops.slab.dtype
    dev = ops.slab.device
    ii, jj = _tri_index(n)
    Cf = torch.zeros(T, B, n, n, dtype=dt, device=dev)
    Ct = ops.part("C")
    Cf[:, :, ii, jj] = Ct
    Cf[:, :, jj, ii] = Ct
    F = ops.part("F").unflatten(-1, (nx, -1))[..., :n]
    uz, lb, tau = ops.part("uz"), ops.part("lb"), ops.part("tau")
    rr = torch.cat([g_x, g_u], -1).to(dt)

    def mv(A, x):
        return (A * x[..., None, :]).sum(-1)

    def mm(A, Bm):
        return (A[..., :, :, None] * Bm[..., None, :, :]).sum(-2)

    # pass 1: reverse Riccati on (C, -r, F)
    V = torch.zeros(B, nx, nx, dtype=dt, device=dev)
    v = torch.zeros(B, nx, dtype=dt, device=dev)
    Ks, ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        Ft = F[t]
        FT = Ft.transpose(-1, -2)
        Q = Cf[t] + mm(FT, mm(V, Ft))
        q = -rr[t] + mv(FT, v)
        Qxx, Qxu = Q[:, :nx, :nx], Q[:, :nx, nx:]
        Qux, Quu = Q[:, nx:, :nx], Q[:, nx:, nx:]
        qx, qu = q[:, :nx], q[:, nx:]
        notI = 1.0 - uz[t]
        Quu_m = (Quu * notI[:, :, None] * notI[:, None, :]
                 + torch.diag_embed(1e-8 * uz[t]))
        Qux_m = Qux * notI[:, :, None]
        qu_m = qu * notI
        if nu == 1:
            kt = -qu_m / Quu[:, 0]
            K = -Qux_m / Quu_m
        else:
            Hi = inv_small(Quu_m)
            kt = -mv(Hi, qu_m)
            K = -mm(Hi, Qux_m)
        KT = K.transpose(-1, -2)
        V = Qxx + mm(Qxu, K) + mm(KT, Qux) + mm(KT, mm(Quu, K))
        v = qx + mv(Qxu, kt) + mv(KT, qu) + mv(KT, mv(Quu, kt))
        Ks[t], ks[t] = K, kt

    # pass 2: rollout from dx_0 = 0
    dx = torch.zeros(B, nx, dtype=dt, device=dev)
    dtau = []
    for t in range(T):
        du = (mv(Ks[t], dx) + ks[t]) * (1.0 - uz[t])
        d = torch.cat([dx, du], -1)
        dtau.append(d)
        dx = mv(F[t], d)
    dtau = torch.stack(dtau)

    # pass 3: joint reverse adjoints
    lam = torch.zeros(B, nx, dtype=dt, device=dev)
    dlam = torch.zeros_like(lam)
    lams, dlams = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        FxT = F[t][:, :, :nx].transpose(-1, -2)
        lam = lb[t] + mv(FxT, lam)
        dlam = mv(Cf[t][:, :nx, :], dtau[t]) - rr[t][:, :nx] + mv(FxT, dlam)
        lams[t], dlams[t] = lam, dlam
    lam, dlam = torch.stack(lams), torch.stack(dlams)

    # the assembly
    dF = -(dlam[1:, :, :, None] * tau[:-1, :, None, :]
           + lam[1:, :, :, None] * dtau[:-1, :, None, :])
    df = -dlam[1:]
    if not full:
        return None, None, None, dF, df
    dC = -0.5 * (dtau[..., :, None] * tau[..., None, :] + tau[..., :, None] * dtau[..., None, :])
    return -dlam[0], dC, -dtau, dF, df


def make_kkt_vjp_cuda(n_state: int, n_ctrl: int, C, c, F, x, u,
                      u_zero_I: Optional[torch.Tensor] = None):
    """Factory: lays the invariant operands out once and returns
    ``call(g_x, g_u, full) -> (dx_init, dC, dc, dF, df)`` (None for the
    first three when full is False): one kernel launch a call on the card."""
    ops = prepare(n_state, n_ctrl, C, c, F, x, u, u_zero_I)

    def call(g_x, g_u, full: bool = True):
        return kkt_fused(ops, g_x, g_u, full)

    return call

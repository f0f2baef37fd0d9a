"""Whole-solve batched iLQR on the card: the wrapper of the hand-written
CUDA kernel (``csrc/ilqr_kernel.cuh``, instantiated in ``csrc/ilqr_fused.cu``,
per env and method with the Jacobian by forward mode in ``csrc/ilqr_jvp.cu``,
per LinDx shape in ``csrc/ilqr_lindx.cu``, per MLP shape in
``csrc/ilqr_mlp.cu`` and per traced user model in ``csrc/ilqr_user.cu``)
and its plain PyTorch version.

Counterpart of ``dilqr_tpu/ops/pallas/ilqr_fused.py`` (``ilqr_fused`` and
the Pallas kernel ``_ilqr_kernel``) for the configurations ``covered``
admits: f32 and either an env with device code -- cartpole, the simple and
the complex pendulum (n_ctrl == 1, the closed-form 1-D box-QP), the rocket
with normalize_quat False or True (n_ctrl == 3, the in-kernel
projected-Newton box-QP), the learned MLP with its widths fixed
(``nn_dynamics.make(..., hidden_sizes=...)``, n_ctrl 1..8, its weights
flat, up to ``nn_dynamics.weight_limit``: 1,205 for one hidden layer, JAX's
256 for a deeper net) and the slew-rate wrapper of each
(``models/ctrl_passthrough``), or a user's own model whose step and
linearize_point ``traced.py`` traces into C++ (flat params, n_ctrl 1..8,
JAX's per-tile memory admission; its slew-rate wrapper is traced as it
stands) -- under GradMethod.ANALYTIC or AUTO_DIFF, or
a time-varying affine (LQR) problem,
``LinDx`` F [T-1,B,nx,nx+nu] and f [T-1,B,nx] or None, as data (n_ctrl
1..8 and n_state up to JAX's gate, ``LINDX_MAX_NX``; the box-QP's inverse
by Gauss-Jordan past 3 controls) -- and, as data, a QuadCost that is
example-invariant ([n,n]+[n] or [T,n,n]+[T,n]) or per example
([T,B,n,n]+[T,B,n], "the lanes cost"), or a callable cost that ``traced.py``
traces (``CallableCost``: flat or no params; with any of the models above
but the slew-rate wrappers, whose augmented cost captures a matrix), bounds
that are static (None, a number or [nu]) or per time and example (anything
that broadcasts to [T,B,nu]), a u_zero_I mask [T,B,nu], a static scalar
delta_u, and a zero or given warm start. A callable cost's true value is
the objective of the rollouts and the line search, and each Riccati step
takes its (H, g) at tau by forward over forward (JAX's quad_at,
:1063-1080) in place of (C, C tau + c); the model's library is built once
more with the cost's generated header for it (``with_cost``).

Semantics, shared by the kernel and ``ilqr_fused_reference``: the batch is
zero-padded to a multiple of 1024 (the lanes cost's padded examples get the
identity C, a tensor bound's padded entries are 0, as JAX pads them), and
the line search's any(cost worsened), the not-improved reset's
any(improved), the stopping rule's max(du) < eps and the box-QP's Newton
and Armijo exits are decided per 1024-example tile, as the JAX kernel
decides them (ilqr_fused.py:35-47, :570-678). The env steps are the
kernel forms (``Dynamics.kernel_step``). The Jacobian is the hand-derived
one (``jac_lanes``, ``csrc/ilqr_fused.cu``) under ANALYTIC where the env
has it; otherwise it is JAX's jvp sweep (``lin_at``, :1258-1266): one
forward-mode evaluation per column, of the clamped step under AUTO_DIFF (a
saturated control's column is 0, torch.clamp's derivative) and of the
un-clamped physics under ANALYTIC (the complex pendulum, the renormalizing
rocket and their slew-rate wrappers), ``JvpJac`` in ``csrc/ilqr_jvp.cu``,
one library per (env, method) built at first use; the MLP's, which has no
clamp, is under either method the hand one of a net of one hidden layer
(the reference's grad_input, ``Mlp::jac``; ``jac_lanes``) and the jvp
sweep of its one step for a deeper net (``JvpJac<Mlp>``; ``mlp_hand``),
in ``csrc/ilqr_mlp.cu``, one library per shape, activation, residual,
slew rate and cost form, which serves both methods; a traced user model's,
likewise, is the jvp sweep of its generated step (``JvpJac<Traced>`` in
``csrc/ilqr_user.cu``, one library per model, method and cost form). A
LinDx problem's step
is x' = F_t tau + f_t and its Jacobian F_t (its padded examples' F and f
are zero, as JAX pads them: they stay at x = 0). The
variants' arithmetic is JAX's: delta_u intersects the QP bounds with
+-delta_u and widens the trial clamp around the current iterate
(:1307-1311, :1404-1408); a mask zeroes its coordinates before the trial
clamp (:1399-1402), and an unboxed (u_lower None) masked solve takes the
free-subspace gains with 1e-8 on frozen diagonals instead of the box-QP
(:1313-1334).

Launch geometry (``geometry``): one tile is one thread-block cluster of G
blocks, 1024/G examples a block, one thread an example; the tile's
decisions are cluster votes. G is 8 unless a caller measuring the kernel
passes another (``cluster``), or 16 where two blocks of 128 examples cannot
share an SM (past ``TWO_BLOCK_FLOATS``: the slew-rate rockets and the
larger LinDx, MLP and traced shapes; ``box_layout``, ``lindx_clusters``,
``ENV_CLUSTERS``); the result does not depend on G. A launch of more tiles
than the card holds at once runs in waves (``WAVES``).
A LinDx shape's library, an (env, method)'s jvp library, an MLP shape's,
a traced model's and a callable cost's libraries are built at first use
(one nvcc each) and cached in ``dilqr_tpu_torch/_build/``. A launch the card
refuses raises: nothing falls back to another geometry or to the plain
version.

``ilqr_fused`` launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.func import jvp, vmap

from ...models.base import Dynamics, MlpSpec
from ...models.nn_dynamics import weight_limit
from ...types import GradMethod, ILQRConfig, LinDx
from ...utils.batch import clamp, inv_small
from ...utils.profiling import span
from ..pnqp import ARMIJO_DECAY, CONV_TOL, GAMMA, MAX_ARMIJO_ITER, REG
from . import build, traced
from .traced import StepOps

SOURCE = "ilqr_fused.cu"
TILE = 1024  # examples per tile: the JAX kernel's base tile
# cluster sizes G (blocks a tile) csrc/ilqr_fused.cu instantiates
CLUSTERS = (8, 16)
# device_env -> (params, controls) the device code reads (EnvId in
# csrc/ilqr_fused.cuh): cartpole, pendulum, rocket, Passthrough<> of each
# (the slew-rate state), the complex pendulum, the renormalizing rocket and
# Passthrough<> of those two
DEVICE_ENVS = {0: (4, 1), 1: (3, 1), 2: (5, 3), 3: (4, 1), 4: (3, 1), 5: (5, 3),
               6: (5, 1), 7: (5, 3), 8: (5, 1), 9: (5, 3)}
# the envs with a hand-derived Jacobian, instantiated in csrc/ilqr_fused.cu;
# the others, and every env under AUTO_DIFF, take csrc/ilqr_jvp.cu
HAND_JAC_ENVS = (0, 1, 2, 3, 4, 5)
# the slew-rate rockets (16 states, 3 controls: 320 shared floats an
# example, one block of 128 or two of 64 an SM) take G = 16 first, as
# lindx_clusters orders such a shape: at B=1,024 it ran 0-3% faster than
# G = 8, at B=16,384 about 1% slower (H100, PERF.md)
ENV_CLUSTERS = {5: (16, 8), 9: (16, 8)}
# the slew-rate wrappers are instantiated for the per-example cost only:
# ``prepare`` expands an example-invariant cost for them
LANES_ONLY = (3, 4, 5, 8, 9, 11)
# the jvp sweep's kernel: one library per (device env, clamped)
JVP_SOURCE = "ilqr_jvp.cu"
# the MLP's kernel: one library per (MlpSpec, cost form); its device ids
# (EnvId ENV_MLP, ENV_MLP_SLEW) and activation ids (MlpAct)
MLP_SOURCE = "ilqr_mlp.cu"
ENV_MLP, ENV_MLP_SLEW = 10, 11
MLP_ACTS = {"sigmoid": 0, "relu": 1, "elu": 2}
# a traced user model's kernel: one library per (model, method, cost form)
USER_SOURCE = "ilqr_user.cu"
ENV_TRACED = 12


# each base env's, the clamped and the un-clamped step alike, counted on a
# host build of the steps over a counting scalar (tests/test_torch_csrc.py)
STEP_OPS = {0: StepOps(38, 38, 41, 38, 66), 1: StepOps(20, 38, 23, 38, 37),
            2: StepOps(133, 0, 133, 0, 216), 6: StepOps(12, 76, 15, 76, 18),
            7: StepOps(146, 0, 147, 0, 244)}
# an MLP hidden unit's activation: (operations of its float value, those
# its derivative adds to the values on a Dual, those of its tangent);
# exp and expm1 count one, as a division does
_MLP_ACT_OPS = {"sigmoid": (3, 2, 1), "relu": (0, 0, 0), "elu": (1, 1, 1)}


def mlp_step_ops(spec: MlpSpec) -> StepOps:
    """STEP_OPS of an MLP's step (Mlp in csrc/ilqr_fused.cuh), from its
    widths: a layer nin -> nout takes 2 nin operations a row (the products,
    the sums but the first, the bias), each hidden unit its activation and
    the residual one add a state; on Duals each row's tangent takes 2 nin -
    1 (the bias adds none), each hidden unit its derivative's and the
    residual one add a state. No FP64. tests/test_torch_csrc.py holds it to
    the count of a host build."""
    sizes = (spec.n_state + spec.n_ctrl,) + spec.hidden + (spec.n_state,)
    prods = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    rows, units = sum(sizes[1:]), sum(spec.hidden)
    val, dval, tan = _MLP_ACT_OPS[spec.activation]
    res = spec.n_state if spec.residual else 0
    return StepOps(2 * prods + val * units + res, 0, 2 * prods + (val + dval) * units + res, 0,
                   2 * prods - rows + tan * units + res)
MAX_NU = 8  # kMaxNu in csrc/ilqr_fused.cuh: the length of the bound arrays

# a LinDx problem's kernel: one library per (n_state, n_ctrl, cost form)
LINDX_SOURCE = "ilqr_lindx.cu"
# the most states JAX's fused_supported admits for a LinDx problem at
# n_ctrl = 1..8, by cost form (True: example-invariant, ``cost_small``; False:
# per example), whatever T, mask, warm start or bound form: probed on the
# JAX package (its VMEM model, which has no CUDA counterpart) and held
# equal by tests/test_torch_ilqr_lindx.py's table test
LINDX_MAX_NX = {False: (15, 15, 14, 14, 13, 12, 12, 11),
                True: (17, 16, 16, 15, 15, 14, 14, 13)}
REGISTER_NX = 6  # kRegisterNx in csrc/ilqr_kernel.cuh
MAX_SMEM = 232448  # kMaxSmem: dynamic shared bytes a Hopper block may have
# kTwoBlockFloats in csrc/ilqr_fused.cuh: the floats an example may take in
# shared memory for two blocks of 128 examples to share an SM (233,472
# bytes an SM, 1,024 kept a block, 32 bytes of vote words a block)
TWO_BLOCK_FLOATS = (233472 // 2 - 1024 - 32) // (4 * 128)

# kernel launches made by ilqr_fused (the plain version does not count)
LAUNCHES = 0
# waves of the last launch: its tiles over the clusters the card holds at
# once (cudaOccupancyMaxActiveClusters of the launched kernel)
WAVES = 0
# (library spec, entry arguments, G) -> max active clusters, read once
_MAX_CLUSTERS = {}


def _bound_is_static(v, nu: int) -> bool:
    return (v is None or isinstance(v, (int, float))
            or (isinstance(v, torch.Tensor) and (v.dim() == 0 or tuple(v.shape) == (nu,))))


def _bound_is_lanes(v, T: int, nu: int) -> bool:
    """A tensor bound that broadcasts to [T, B, nu] for some B."""
    if not isinstance(v, torch.Tensor) or v.dim() > 3 or not v.is_floating_point():
        return False
    shape = (1,) * (3 - v.dim()) + tuple(v.shape)
    return shape[0] in (1, T) and shape[2] in (1, nu)


def static_bounds(u_lower, u_upper, nu: int) -> Optional[Tuple[Tuple[float, ...], ...]]:
    """Per-control (lo, hi) tuples of floats for example- and
    time-invariant bounds (None | scalar | [nu] tensor), with one host read
    for the tensors among them; None = the bounds vary over time or
    examples and the kernel takes them as [T, nu, Bp] inputs. A missing
    bound is +-inf."""
    if not (_bound_is_static(u_lower, nu) and _bound_is_static(u_upper, nu)):
        return None
    dev = next((v.device for v in (u_lower, u_upper) if isinstance(v, torch.Tensor)), "cpu")
    lo, hi = torch.stack([
        torch.as_tensor(sign * math.inf if v is None else v, dtype=torch.float64,
                        device=dev).expand(nu)
        for v, sign in ((u_lower, -1.0), (u_upper, 1.0))]).tolist()
    return tuple(lo), tuple(hi)


def static_scalar(v) -> Optional[float]:
    """A number or a 0-d tensor as a float (one host read); None otherwise
    (JAX's _static_scalar, :253-260)."""
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, torch.Tensor) and v.dim() == 0:
        return float(v)
    return None


def jax_tile_fits(cfg: ILQRConfig, lanes_cost: bool, uz: bool, warm: bool,
                  dyn_bounds: bool) -> bool:
    """JAX's per-tile memory admission for a model whose shape is not fixed
    (fused_supported's test of ``_vmem_bytes``, dilqr_tpu/ops/pallas/
    ilqr_fused.py:106-171 and :322-328): a 1024-example tile's f32 arrays,
    in tiles, at most 15 MiB in one of its three residencies (the whole
    horizon, the gains streamed, everything streamed). The TPU's budget has
    no CUDA counterpart, but it decides which MLP solves JAX runs on its
    kernel, so the port's gate holds to it: it binds from about 12 states
    (tests/test_torch_ilqr_mlp.py holds it to JAX's)."""
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl
    n = nx + nu
    inputs = (2 * (n * n + n) if lanes_cost else 0) + 2 * nu * (uz + warm + 2 * dyn_bounds)
    fixed = nx * nx + nx + 3 + 2 * (n * n + 2 * nx * n + nx * nx)
    whole = T * (3 * nu + 2 * nx + nu * nx + inputs) + fixed
    stream_k = T * (3 * nu + 2 * nx + inputs) + 2 * nu * nx + fixed
    stream_all = 2 * (5 * n + nu * (nx + 1)) + inputs + fixed
    return min(whole, stream_k, stream_all) <= 15 * 2 ** 20 // (4 * TILE)


class CallableCost(NamedTuple):
    """A callable cost as the kernel takes it: its trace (``traced.cost``),
    the function ``fn(tau [n], params)`` the plain version evaluates, and
    its flat params [Pc] (None for a cost without params, called with ())."""
    trace: traced.TracedCost
    fn: Callable
    params: Optional[torch.Tensor]


def is_traced(dyn) -> bool:
    """A user's own model: a Dynamics with neither device code nor MLP
    widths, whose step the kernel runs as traced.py generates it."""
    return isinstance(dyn, Dynamics) and dyn.device_env is None and dyn.device_mlp is None


def covered(cfg: ILQRConfig, dyn, params, dtype, cost_small, u_zero_I, delta_u,
            u_lower, u_upper, u_init_zero: bool = False, cost_callable: bool = False) -> bool:
    """True when the configuration is one the kernel computes (counterpart
    of ``fused_supported`` plus ``lane_compatible`` for the envs with
    device code, under ANALYTIC or AUTO_DIFF, the MLP with its widths fixed
    and its weights flat (``nn_dynamics.flat_params``), a user's own model
    with flat params whose step and linearize_point trace (``traced.model``:
    JAX's lane_compatible), and LinDx problems, whose ``params`` are
    ignored, as in JAX). ``cost_small`` None means the per-example cost;
    ``u_init_zero``: the warm start is known to be zeros (JAX's, which the
    memory admission reads); ``cost_callable``: the cost is a callable that
    traces (``traced.cost``: JAX's cost_lane_compatible), which the memory
    admission counts as no cost input."""
    nu, nx = cfg.n_ctrl, cfg.n_state
    common = (
        cfg.qp_solver == "auto"
        and not cfg.unroll
        and cfg.verbose < 1
        and dtype == torch.float32
        and (delta_u is None or static_scalar(delta_u) is not None)
        and (u_zero_I is None or (isinstance(u_zero_I, torch.Tensor) and u_zero_I.dim() == 3
                                  and u_zero_I.shape[0] == cfg.T and u_zero_I.shape[2] == nu))
        and all(_bound_is_static(v, nu) or _bound_is_lanes(v, cfg.T, nu)
                for v in (u_lower, u_upper))
    )
    if isinstance(dyn, LinDx):
        F, f = dyn
        return (
            common
            and 1 <= nu <= MAX_NU
            and nx <= LINDX_MAX_NX[cost_small is not None or cost_callable][nu - 1]
            and isinstance(F, torch.Tensor) and F.dim() == 4 and F.shape[0] == cfg.T - 1
            and tuple(F.shape[2:]) == (nx, nx + nu)
            and (f is None or (isinstance(f, torch.Tensor) and f.dim() == 3
                               and f.shape[0] == cfg.T - 1 and f.shape[2] == nx))
        )
    mlp = dyn.device_mlp if isinstance(dyn, Dynamics) else None
    if mlp is not None:
        return (
            common
            and dyn.jacobian is None
            and cfg.grad_method in (GradMethod.ANALYTIC, GradMethod.AUTO_DIFF)
            and 1 <= nu <= MAX_NU
            and nu == mlp.n_ctrl
            and nx == dyn.n_state == mlp.n_state + (nu if mlp.slew else 0)
            and isinstance(params, torch.Tensor)
            and params.dim() == 1
            and params.shape[0] == mlp.n_weights <= weight_limit(mlp)
            and jax_tile_fits(cfg, cost_small is None and not cost_callable,
                              u_zero_I is not None, not u_init_zero,
                              not (_bound_is_static(u_lower, nu)
                                   and _bound_is_static(u_upper, nu)))
        )
    if is_traced(dyn):
        return (
            common
            and dyn.jacobian is None
            and cfg.grad_method in (GradMethod.ANALYTIC, GradMethod.AUTO_DIFF)
            and 1 <= nu <= MAX_NU
            and nu == dyn.n_ctrl
            and nx == dyn.n_state
            and isinstance(params, torch.Tensor)
            and params.dim() == 1
            and jax_tile_fits(cfg, cost_small is None and not cost_callable,
                              u_zero_I is not None, not u_init_zero,
                              not (_bound_is_static(u_lower, nu)
                                   and _bound_is_static(u_upper, nu)))
            and traced.model(dyn, nx, nu, params.shape[0], params.device) is not None
        )
    return (
        common
        and isinstance(dyn, Dynamics)
        and dyn.device_env in DEVICE_ENVS
        and dyn.jacobian is None
        and nu == dyn.n_ctrl == DEVICE_ENVS[dyn.device_env][1]
        and nx == dyn.n_state
        and cfg.grad_method in (GradMethod.ANALYTIC, GradMethod.AUTO_DIFF)
        and isinstance(params, torch.Tensor)
        and params.dim() == 1
        and params.shape[0] == DEVICE_ENVS[dyn.device_env][0]
        and not (cost_callable and dyn.device_env in LANES_ONLY)
    )


def clusters(device_env: int) -> Tuple[int, ...]:
    """The cluster sizes the env's instantiation has, its default first:
    every env's blocks fit the shared memory at both."""
    return ENV_CLUSTERS.get(device_env, CLUSTERS)


class BoxLayout(NamedTuple):
    floats: int   # shared floats an example takes, 0 on the register path
    split: bool   # F out of shared memory, Quu in registers
    scratch: int  # floats an example of the launch's scratch (F, then q)


def box_layout(nx: int, nu: int) -> BoxLayout:
    """The strided path's layout (BoxStepLayout in csrc/ilqr_fused.cuh):
    V and Q as triangles, and F dense, in shared memory where the three
    take at most TWO_BLOCK_FLOATS an example; past that V and Q without
    its Quu block, and F and q in a device-memory scratch of the launch,
    (nx + 1)*(nx+nu) floats an example. One control with at most
    REGISTER_NX states keeps everything in registers."""
    if nu == 1 and nx <= REGISTER_NX:
        return BoxLayout(0, False, 0)
    n = nx + nu
    whole = nx * (nx + 1) // 2 + n * (n + 1) // 2 + nx * n
    if whole <= TWO_BLOCK_FLOATS:
        return BoxLayout(whole, False, 0)
    return BoxLayout(whole - nx * n - nu * (nu + 1) // 2, True, (nx + 1) * n)


def lindx_floats(nx: int, nu: int) -> int:
    """Floats of shared memory an example of a LinDx shape (or an MLP, or
    a traced model, of its n_state and n_ctrl) takes: ``box_layout``."""
    return box_layout(nx, nu).floats


def lindx_clusters(nx: int, nu: int) -> Tuple[int, ...]:
    """The cluster sizes a LinDx shape's library has: those whose blocks
    (1024 / G examples) fit the shared memory (csrc/ilqr_lindx.cu), the
    default first: G = 16 where two blocks of 128 cannot share an SM (past
    TWO_BLOCK_FLOATS), where two or three of 64 can (LinDx (15, 2): 35.4
    ms at B=16,384 against G = 8's 47.4 on an H100, PERF.md)."""
    floats = lindx_floats(nx, nu)
    sizes = tuple(G for G in CLUSTERS if 4 * floats * (TILE // G) <= MAX_SMEM)
    return sizes[::-1] if floats > TWO_BLOCK_FLOATS else sizes


def waves(geo: "Geometry", max_clusters: int) -> int:
    """The waves a launch of ``geo`` runs in where the card holds
    ``max_clusters`` of its clusters at once."""
    return -(-geo.tiles // max(max_clusters, 1))


def uses_jvp(grad_method: GradMethod, device_env: int) -> bool:
    """The env's Jacobian comes from the jvp sweep (csrc/ilqr_jvp.cu): every
    env under AUTO_DIFF, and under ANALYTIC the envs with no hand-derived
    one."""
    return grad_method is GradMethod.AUTO_DIFF or device_env not in HAND_JAC_ENVS


def jvp_spec(device_env: int, clamped: bool):
    """The build spec (source, defines) of the jvp library of a device env:
    the clamped step's Jacobian (AUTO_DIFF) or the un-clamped physics'."""
    return (JVP_SOURCE, (("DILQR_JVP_ENV", device_env), ("DILQR_JVP_CLAMPED", int(clamped))))


def jvp_specs():
    """Every jvp library the gate can reach: each env under AUTO_DIFF, and
    under ANALYTIC those with no hand Jacobian."""
    return [jvp_spec(env, clamped) for env in DEVICE_ENVS for clamped in (True, False)
            if clamped or env not in HAND_JAC_ENVS]


def env_spec(grad_method: GradMethod, device_env: int):
    """The library whose kernel solves the device env under the method."""
    if uses_jvp(grad_method, device_env):
        return jvp_spec(device_env, grad_method is GradMethod.AUTO_DIFF)
    return SOURCE


def mlp_clusters(nx: int, nu: int) -> Tuple[int, ...]:
    """The cluster sizes an MLP library of n_state ``nx`` (the slew-rate
    wrapper's: its own) has: those whose blocks fit the shared memory, which
    holds what a LinDx shape's does (V, Q and F; none on the register
    path)."""
    return lindx_clusters(nx, nu)


def mlp_hand(spec: MlpSpec) -> bool:
    """The MLP's Jacobian is its hand one (Mlp::jac, ``jac_lanes``) under
    either method for a net of one hidden layer (csrc/ilqr_mlp.cu's
    kHand); else JvpJac<Mlp>'s. The step has no clamp, so ANALYTIC and
    AUTO_DIFF differentiate the same function and one library serves
    both."""
    return len(spec.hidden) == 1


def mlp_spec(spec: MlpSpec, lanes: bool):
    """The build spec (source, defines) of an MLP's library: its widths,
    activation, residual, slew rate and cost form (the slew-rate wrapper's
    is the per-example one); its widths fix its Jacobian (``mlp_hand``)."""
    defines = [("DILQR_MLP_NX", spec.n_state), ("DILQR_MLP_NU", spec.n_ctrl)]
    if spec.hidden:
        defines.append(("DILQR_MLP_HIDDEN", "x".join(str(h) for h in spec.hidden)))
    defines += [("DILQR_MLP_ACT", MLP_ACTS[spec.activation]),
                ("DILQR_MLP_RESIDUAL", int(spec.residual)), ("DILQR_MLP_SLEW", int(spec.slew)),
                ("DILQR_MLP_LANES", int(lanes or spec.slew))]
    return (MLP_SOURCE, tuple(defines))


def user_spec(model: traced.TracedModel, cost: Optional[traced.TracedCost], clamped: bool,
              lanes: bool):
    """The build spec (source, defines, generated header) of a traced user
    model's library: the clamped step's Jacobian (AUTO_DIFF) or the
    linearization point's, and the cost form (a callable cost's, traced
    into the same header, or a QuadCost's)."""
    defines = (("DILQR_USER_CLAMPED", int(clamped)), ("DILQR_USER_LANES", int(lanes)))
    if cost is not None:
        defines += (("DILQR_CALLABLE_COST", 1),)
    return (USER_SOURCE, defines, traced.header(model, cost))


def with_cost(spec, cost: Optional[traced.TracedCost]):
    """``spec`` built for a callable cost (csrc/callable_cost.cuh): the
    source with -DDILQR_CALLABLE_COST=1 and the cost's generated header;
    ``spec`` itself for cost None."""
    if cost is None:
        return spec
    source, defines, _ = build._split(spec)
    return (source, tuple(defines) + (("DILQR_CALLABLE_COST", 1),), traced.header(cost=cost))


def kernel_clusters(cfg: ILQRConfig, dyn) -> Tuple[int, ...]:
    """The cluster sizes of the instantiation that solves ``dyn``."""
    if isinstance(dyn, LinDx) or is_traced(dyn):
        return lindx_clusters(cfg.n_state, cfg.n_ctrl)
    if dyn.device_mlp is not None:
        return mlp_clusters(cfg.n_state, cfg.n_ctrl)
    return clusters(dyn.device_env)


def lindx_spec(nx: int, nu: int, lanes: bool):
    """The build spec (source, defines) of a LinDx shape's library."""
    return (LINDX_SOURCE, (("DILQR_LINDX_NX", nx), ("DILQR_LINDX_NU", nu),
                           ("DILQR_LINDX_LANES", int(lanes))))


def _padded(B: int) -> int:
    return -(-B // TILE) * TILE


class Geometry(NamedTuple):
    Bp: int        # the batch padded to whole tiles
    tiles: int     # clusters (1024-example tiles)
    cluster: int   # blocks a cluster, G
    block: int     # examples (threads) a block, 1024 / G
    blocks: int    # blocks in the launch


def geometry(B: int, cluster: int = 0, device_env: int = 0,
             sizes: Optional[Tuple[int, ...]] = None) -> Geometry:
    """The kernel's launch shape for a batch of B; ``cluster`` 0 takes the
    instantiation's default G, the first of its sizes. ``sizes``: the
    cluster sizes of the instantiation, by default the env's."""
    sizes = sizes or clusters(device_env)
    G = cluster or sizes[0]
    if G not in sizes:
        raise ValueError(f"ilqr_fused instantiates clusters of {sizes} blocks here; got {G}")
    Bp = _padded(B)
    return Geometry(Bp, Bp // TILE, G, TILE // G, Bp // TILE * G)


class Inputs(NamedTuple):
    """The solve's data in the kernel's layout, the batch padded to Bp
    (the last axis of every per-example array)."""
    x_init: torch.Tensor              # [nx, Bp]
    u_init: Optional[torch.Tensor]    # [T, nu, Bp] or None (zeros)
    lanes: bool                       # the per-example cost
    C: torch.Tensor                   # [Tc, n*n] or [T, n*n, Bp]
    c: torch.Tensor                   # [Tc, n] or [T, n, Bp]
    lo: Tuple[float, ...]             # static bounds ([nu] each) or
    hi: Tuple[float, ...]             # None beside lb/ub
    lb: Optional[torch.Tensor]        # [T, nu, Bp] per-time and per-example
    ub: Optional[torch.Tensor]        # bounds, or None
    uz: Optional[torch.Tensor]        # [T, nu, Bp] uint8 mask, or None
    uz_free: bool                     # unboxed (u_lower None) and masked
    du: Optional[float]               # the static delta_u
    F: Optional[torch.Tensor] = None  # LinDx: [T-1, nx*n, Bp]
    f: Optional[torch.Tensor] = None  # LinDx: [T-1, nx, Bp] or None
    cost: Optional[CallableCost] = None  # a callable cost (C: its params)


def _lanes(a: torch.Tensor, B: int, Bp: int, fill: float = 0.0) -> torch.Tensor:
    """[T, B, *small] -> [T, prod(small), Bp] (the batch last, padded with
    ``fill``)."""
    T = a.shape[0]
    out = torch.full((T, math.prod(a.shape[2:]), Bp), fill, dtype=a.dtype, device=a.device)
    out[:, :, :B] = a.reshape(T, B, -1).permute(0, 2, 1)
    return out


def _cost_inputs(cost, T: int, B: int, Bp: int, n: int, device, lanes_only: bool = False):
    """(lanes, C, c) from ``cost``: the example-invariant (C [n,n] or
    [T,n,n], c [n] or [T,n]) as (False, [Tc, n*n], [Tc, n]), or the
    per-example (C [T,B,n,n], c [T,B,n]) as (True, [T, n*n, Bp], [T, n,
    Bp]) with the identity C on the padded examples (JAX's
    pad_cost_identity: a positive Quu there). ``lanes_only``: an
    example-invariant cost too comes as (True, ...), every example and
    padded example its C and c, so the function is the same."""
    C, c = (torch.as_tensor(a, device=device).to(torch.float32) for a in cost)
    if lanes_only and C.dim() < 4:
        lanes, C, c = _cost_inputs(cost, T, B, Bp, n, device)
        C = C.expand(T, n * n) if C.shape[0] == 1 else C
        c = c.expand(T, n) if c.shape[0] == 1 else c
        return True, C[:, :, None].expand(T, n * n, Bp).contiguous(), \
            c[:, :, None].expand(T, n, Bp).contiguous()
    if C.dim() == 4:
        if C.shape != (T, B, n, n) or c.shape != (T, B, n):
            raise ValueError(f"a per-example cost must be ([T,B,n,n], [T,B,n]) with T={T}, "
                             f"B={B}, n={n}; got {tuple(C.shape)}, {tuple(c.shape)}")
        Cl = _lanes(C, B, Bp)
        Cl[:, torch.arange(n) * (n + 1), B:] = 1.0
        return True, Cl, _lanes(c, B, Bp)
    if C.dim() == 2:
        C, c = C[None], c[None]
    if C.shape[1:] != (n, n) or c.shape[1:] != (n,) or C.shape[0] not in (1, T) \
            or c.shape[0] != C.shape[0]:
        raise ValueError(
            f"cost must be ([n,n], [n]), ([T,n,n], [T,n]) or ([T,B,n,n], [T,B,n]) with "
            f"n={n}, T={T}; got {tuple(C.shape)}, {tuple(c.shape)}")
    return False, C.reshape(C.shape[0], n * n).contiguous(), c.contiguous()


def _expand_bound(v, T: int, B: int, Bp: int, nu: int, sign: float, device) -> torch.Tensor:
    """A bound as [T, nu, Bp] (JAX's expand_bound): None is sign*inf and a
    number fills every entry, the padded ones too; a tensor broadcasts to
    [T, B, nu] and its padded entries are 0."""
    if v is None or not isinstance(v, torch.Tensor) or v.dim() == 0:
        val = sign * math.inf if v is None else float(v)
        return torch.full((T, nu, Bp), val, dtype=torch.float32, device=device)
    v = v.to(device=device, dtype=torch.float32)
    return _lanes(v.expand(T, B, nu), B, Bp)


def prepare(cfg: ILQRConfig, dyn, params, x_init, cost, u_init, u_lower, u_upper,
            u_zero_I, delta_u, Bp: int) -> Inputs:
    """Validates the inputs and lays them out for the kernel (the lanes
    transpose, once a solve; a LinDx problem's F and f too)."""
    T, nx, nu = cfg.T, cfg.n_state, cfg.n_ctrl
    lin = isinstance(dyn, LinDx)
    mlp = None if lin else dyn.device_mlp
    user = not lin and is_traced(dyn)
    if lin or mlp is not None or user:
        if not 1 <= nu <= MAX_NU:
            raise ValueError(f"ilqr_fused takes LinDx problems, MLPs and traced models with "
                             f"1 <= n_ctrl <= {MAX_NU}")
    elif dyn.device_env not in DEVICE_ENVS or nu != DEVICE_ENVS[dyn.device_env][1]:
        raise ValueError("ilqr_fused covers cartpole, both pendulums (n_ctrl == 1), the "
                         "rocket (n_ctrl == 3), the MLP with hidden_sizes, their slew-rate "
                         "wrappers, traced user models and LinDx problems")
    if not lin and cfg.grad_method not in (GradMethod.ANALYTIC, GradMethod.AUTO_DIFF):
        raise ValueError(f"ilqr_fused linearizes by ANALYTIC or AUTO_DIFF, got "
                         f"{cfg.grad_method}")
    if x_init.dtype != torch.float32:
        raise ValueError(f"ilqr_fused is f32 only, got {x_init.dtype}")
    if x_init.dim() != 2 or x_init.shape[1] != nx:
        raise ValueError(f"x_init must be [B, {nx}], got {tuple(x_init.shape)}")
    B = x_init.shape[0]
    if lin:
        F, f = dyn
        if tuple(F.shape) != (T - 1, B, nx, nx + nu) or (
                f is not None and tuple(f.shape) != (T - 1, B, nx)):
            raise ValueError(f"a LinDx problem must be F [T-1, B, nx, n] = "
                             f"{(T - 1, B, nx, nx + nu)} and f [T-1, B, nx] or None; got "
                             f"{tuple(F.shape)}, {None if f is None else tuple(f.shape)}")
        params = None
    elif user:
        if not isinstance(params, torch.Tensor) or params.dim() != 1:
            raise ValueError(f"a traced model's params must be one flat tensor [P], got "
                             f"{getattr(params, 'shape', type(params).__name__)}")
    else:
        n_params = mlp.n_weights if mlp is not None else DEVICE_ENVS[dyn.device_env][0]
        if not isinstance(params, torch.Tensor) or params.dim() != 1 \
                or params.shape[0] != n_params:
            raise ValueError(f"params must be [{n_params}] (an MLP's flat_params), got "
                             f"{getattr(params, 'shape', type(params).__name__)}")
    if u_init is not None and tuple(u_init.shape) != (T, B, nu):
        raise ValueError(f"u_init must be [T, B, {nu}], got {tuple(u_init.shape)}")
    if u_zero_I is not None and tuple(u_zero_I.shape) != (T, B, nu):
        raise ValueError(f"u_zero_I must be [T, B, {nu}], got {tuple(u_zero_I.shape)}")
    for name, t in (("params", params), ("u_init", u_init), ("u_zero_I", u_zero_I)) + (
            (("F", dyn[0]), ("f", dyn[1])) if lin else ()):
        if t is not None and t.device != x_init.device:
            raise ValueError(f"{name} is on {t.device}, x_init on {x_init.device}")
    du = None
    if delta_u is not None:
        du = static_scalar(delta_u)
        if du is None:
            raise ValueError("ilqr_fused takes a static scalar delta_u (a number or a 0-d "
                             f"tensor), got {type(delta_u).__name__}")
    dev = x_init.device
    cc = cost if isinstance(cost, CallableCost) else None
    if cc is not None:
        if not lin and dyn.device_env in LANES_ONLY:
            raise ValueError("a callable cost does not run on a slew-rate wrapper")
        if cc.trace.n != nx + nu:
            raise ValueError(f"the callable cost was traced for n = {cc.trace.n}, the problem "
                             f"has {nx + nu}")
        lanes = False
        C = (torch.empty(0, dtype=torch.float32, device=dev) if cc.params is None
             else cc.params.to(device=dev, dtype=torch.float32).contiguous())
        if C.shape != (cc.trace.n_params,):
            raise ValueError(f"the callable cost's params must be [{cc.trace.n_params}], got "
                             f"{tuple(C.shape)}")
        c = C
    else:
        lanes, C, c = _cost_inputs(cost, T, B, Bp, nx + nu, dev,
                                   lanes_only=not lin and dyn.device_env in LANES_ONLY)
    bounds = static_bounds(u_lower, u_upper, nu)
    lb = ub = None
    if bounds is None:
        for v in (u_lower, u_upper):
            if not (_bound_is_static(v, nu) or _bound_is_lanes(v, T, nu)):
                raise ValueError(f"a bound must be None, a number, [{nu}] or broadcast to "
                                 f"[T, B, {nu}]; got {tuple(v.shape)}")
        lb = _expand_bound(u_lower, T, B, Bp, nu, -1.0, dev)
        ub = _expand_bound(u_upper, T, B, Bp, nu, 1.0, dev)
        bounds = ((0.0,) * nu, (0.0,) * nu)
    xi = torch.zeros(nx, Bp, dtype=torch.float32, device=dev)
    xi[:, :B] = x_init.T
    u0 = None if u_init is None else _lanes(u_init.to(torch.float32), B, Bp)
    uz = None if u_zero_I is None else _lanes(u_zero_I.to(torch.uint8), B, Bp)
    Fl = fl = None
    if lin:  # zero-padded: a padded example stays at x = 0
        Fl = _lanes(dyn[0].to(torch.float32), B, Bp)
        fl = None if dyn[1] is None else _lanes(dyn[1].to(torch.float32), B, Bp)
    return Inputs(xi, u0, lanes, C, c, bounds[0], bounds[1], lb, ub, uz,
                  uz is not None and u_lower is None, du, Fl, fl, cc)


def ilqr_fused(cfg: ILQRConfig, dyn, params, x_init: torch.Tensor, cost,
               u_init: Optional[torch.Tensor] = None, u_lower=None, u_upper=None,
               u_zero_I: Optional[torch.Tensor] = None, delta_u=None, cluster: int = 0):
    """Run the whole solve. dyn: a Dynamics with device code, or a user's
    model that traces (``covered``), and its params [P], or a time-major
    LinDx (F [T-1,B,nx,n], f [T-1,B,nx] or None; params ignored). x_init
    [B, nx]; cost the pair (C, c), either example-invariant ([n,n]+[n] or
    [T,n,n]+[T,n]) or per example ([T,B,n,n]+[T,B,n]), or a
    ``CallableCost``; u_init [T, B, nu] time-major or None (zeros);
    u_lower/u_upper None, a number, [nu] or anything that broadcasts to
    [T, B, nu]; u_zero_I a [T, B, nu] bool mask or None; delta_u None, a
    number or a 0-d tensor. Returns time-major (x [T,B,nx], u [T,B,nu],
    costs [B], full_du_norm [B], n_iter []). ``cluster``: blocks a tile, 0
    for the default (the result does not depend on it).

    CUDA tensors launch the kernel; CPU tensors take ilqr_fused_reference."""
    if not x_init.is_cuda:
        return ilqr_fused_reference(cfg, dyn, params, x_init, cost, u_init, u_lower=u_lower,
                                    u_upper=u_upper, u_zero_I=u_zero_I, delta_u=delta_u)
    return _launch(cfg, dyn, params, x_init, cost, u_init, u_lower, u_upper, u_zero_I,
                   delta_u, cluster)[0]


def ilqr_fused_probe(cfg: ILQRConfig, dyn, params, x_init: torch.Tensor, cost,
                     u_init: Optional[torch.Tensor] = None,
                     u_lower=None, u_upper=None, u_zero_I: Optional[torch.Tensor] = None,
                     delta_u=None, cluster: int = 0):
    """One launch of the kernel on CUDA tensors that also records what it
    did: (ilqr_fused's outputs, per tile [tiles, 3] the votes it took, the
    SM clock cycles its rank-0 thread 0 spent in them and in the whole
    kernel, the SM each block ran on [blocks])."""
    if not x_init.is_cuda:
        raise ValueError("ilqr_fused_probe launches the kernel: x_init must be on the card")
    return _launch(cfg, dyn, params, x_init, cost, u_init, u_lower, u_upper, u_zero_I,
                   delta_u, cluster, probe=True)


def _launch(cfg, dyn, params, x_init, cost, u_init, u_lower, u_upper, u_zero_I, delta_u,
            cluster, probe=False):
    global LAUNCHES, WAVES
    with span("ilqr_fused.prepare"):
        T, B, nx, nu = cfg.T, x_init.shape[0], cfg.n_state, cfg.n_ctrl
        lin = isinstance(dyn, LinDx)
        geo = geometry(B, cluster, sizes=kernel_clusters(cfg, dyn))
        Bp = geo.Bp
        inp = prepare(cfg, dyn, params, x_init, cost, u_init, u_lower, u_upper, u_zero_I, delta_u,
                      Bp)
        dev = x_init.device

        # three trajectories [T, nx + nu, Bp], K [T, nu*nx, Bp], k [T, nu, Bp]
        # and the Riccati step's F and q [(nx+1)*(nx+nu), Bp] where its layout
        # puts them there
        scratch = box_layout(nx, nu).scratch
        work = torch.empty((T * (3 * (nx + nu) + nu * nx + nu) + scratch) * Bp,
                           dtype=torch.float32, device=dev)
        bx = torch.zeros(T, nx, Bp, dtype=torch.float32, device=dev)
        bu = torch.zeros(T, nu, Bp, dtype=torch.float32, device=dev)
        bc = torch.empty(Bp, dtype=torch.float32, device=dev)
        bdu = torch.empty(Bp, dtype=torch.float32, device=dev)
        iters = torch.empty(geo.tiles, dtype=torch.int32, device=dev)
        stats = torch.zeros(geo.tiles, 3, dtype=torch.int64, device=dev) if probe else None
        smids = torch.full((geo.blocks,), -1, dtype=torch.int32, device=dev) if probe else None

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        # the head of the arguments: the LinDx shape's library and its F/f, or
        # the env's and its params
        ctr = None if inp.cost is None else inp.cost.trace
        Tc = 1 if ctr is not None else inp.C.shape[0]
        # a callable cost's params, then what its captured tensors hold now
        cp = None if ctr is None else traced.launch_params(inp.C, ctr.captured, dev)
        if lin:
            spec = with_cost(lindx_spec(nx, nu, inp.lanes), ctr)
            fn = _entry(spec, "dilqr_ilqr_lindx", 6, 2)
            head = (nx, nu, T, Bp, int(inp.lanes), Tc, ptr(inp.F), ptr(inp.f))
            which = ("dilqr_ilqr_lindx_info", (nx, nu, int(inp.lanes)))
        else:
            env = dyn.device_env
            p = params.to(torch.float32).contiguous()
            if is_traced(dyn):
                model = traced.model(dyn, nx, nu, params.shape[0], dev)
                if model is None:
                    raise ValueError("the model's step or linearize_point does not trace into the "
                                     "kernel (ops/cuda/traced.py)")
                spec = user_spec(model, ctr, cfg.grad_method is GradMethod.AUTO_DIFF, inp.lanes)
                env = ENV_TRACED
                p = traced.launch_params(p, model.captured, dev)
            elif dyn.device_mlp is not None:
                spec = with_cost(mlp_spec(dyn.device_mlp, inp.lanes), ctr)
            else:
                spec = with_cost(env_spec(cfg.grad_method, dyn.device_env), ctr)
            fn = _entry(spec, "dilqr_ilqr_fused", 5, 1)
            head = (env, T, Bp, int(inp.lanes), Tc, p.data_ptr())
            which = ("dilqr_ilqr_fused_info", (env, int(inp.lanes)))
        # kMaxNu-long arrays for the kernel's arguments, the env's bounds first
        pad = (0.0,) * (MAX_NU - nu)
        lo_c, hi_c = ((ctypes.c_float * MAX_NU)(*v, *pad) for v in (inp.lo, inp.hi))
        stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev), span("ilqr_fused.launch"):
        rc = fn(*head, inp.x_init.data_ptr(), (inp.C if cp is None else cp).data_ptr(),
                0 if ctr is not None else inp.c.data_ptr(), ptr(inp.u_init),
                lo_c, hi_c, ptr(inp.lb), ptr(inp.ub), ptr(inp.uz), int(inp.uz_free),
                int(inp.du is not None), 0.0 if inp.du is None else inp.du,
                cfg.lqr_iter, cfg.eps, cfg.linesearch_decay, cfg.max_linesearch_iter,
                cfg.best_cost_eps, cfg.not_improved_lim, cfg.pnqp_iter, geo.cluster,
                work.data_ptr(), bx.data_ptr(), bu.data_ptr(), bc.data_ptr(), bdu.data_ptr(),
                iters.data_ptr(), ptr(stats), ptr(smids), stream)
    if rc != 0:
        raise RuntimeError(f"ilqr_fused kernel launch failed ({geo.tiles} clusters of "
                           f"{geo.cluster} blocks of {geo.block} threads): CUDA error {rc}")
    LAUNCHES += 1
    key = (spec, which, geo.cluster)
    if key not in _MAX_CLUSTERS:
        with torch.cuda.device(dev):
            _MAX_CLUSTERS[key] = _info(spec, *which, geo.cluster)[0]
    WAVES = waves(geo, _MAX_CLUSTERS[key])
    out = (bx.permute(0, 2, 1)[:, :B], bu.permute(0, 2, 1)[:, :B], bc[:B], bdu[:B],
           iters.max())
    return out, stats, smids


_INFO_KEYS = ("max_active_clusters", "registers", "local_bytes", "static_smem",
              "dynamic_smem")


def _info(spec, name: str, args: Tuple[int, ...], G: int):
    """The five numbers the info entry ``name`` of the library of ``spec``
    gives for the kernel of ``args`` (the env's id or the LinDx shape, and
    the cost form) at clusters of G blocks (_INFO_KEYS)."""
    fn = getattr(build.load(spec), name)
    fn.argtypes = [ctypes.c_int] * (len(args) + 1) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(*args, G, out)
    if rc != 0:
        raise RuntimeError(f"{name} {args}, cluster {G}: CUDA error {rc}")
    return list(out)


def kernel_info(device_env: int, cluster: int = 0, lanes: bool = False,
                grad_method: GradMethod = GradMethod.ANALYTIC,
                cost: Optional[traced.TracedCost] = None) -> dict:
    """What the card says of one instantiation (``lanes``: the per-example
    cost's; the slew-rate wrappers have no other; ``grad_method`` picks the
    hand Jacobian's or the jvp sweep's, ``env_spec``; ``cost``: a callable
    cost's library, ``with_cost``): the clusters of G blocks it can hold at
    once (cudaOccupancyMaxActiveClusters), registers and local bytes a
    thread, static and dynamic shared bytes a block."""
    G = geometry(TILE, cluster, device_env).cluster
    lanes = (lanes or device_env in LANES_ONLY) and cost is None
    out = _info(with_cost(env_spec(grad_method, device_env), cost), "dilqr_ilqr_fused_info",
                (device_env, int(lanes)), G)
    return dict(zip(_INFO_KEYS, out), cluster=G, lanes=lanes)


def _store(nx: int, nu: int) -> str:
    """Where V, Q and F live: "registers", "shared" or, in the split
    layout, "split" (V and Q but Quu in shared memory, F out of it)."""
    layout = box_layout(nx, nu)
    return "split" if layout.split else "shared" if layout.floats else "registers"


def mlp_info(spec: MlpSpec, cluster: int = 0, lanes: bool = False) -> dict:
    """kernel_info for an MLP's library (built first if needed), with where
    V, Q and F live (``_store``)."""
    nu = spec.n_ctrl
    nx = spec.n_state + (nu if spec.slew else 0)
    G = geometry(TILE, cluster, sizes=mlp_clusters(nx, nu)).cluster
    lanes = lanes or spec.slew
    out = _info(mlp_spec(spec, lanes), "dilqr_ilqr_fused_info",
                (ENV_MLP_SLEW if spec.slew else ENV_MLP, int(lanes)), G)
    return dict(zip(_INFO_KEYS, out), cluster=G, lanes=lanes, store=_store(nx, nu))


def user_info(model: traced.TracedModel, cost: Optional[traced.TracedCost],
              grad_method: GradMethod, cluster: int = 0, lanes: bool = False) -> dict:
    """kernel_info for a traced model's library (built first if needed),
    with where V, Q and F live (``_store``)."""
    nx, nu = model.n_state, model.n_ctrl
    G = geometry(TILE, cluster, sizes=lindx_clusters(nx, nu)).cluster
    lanes = lanes and cost is None
    out = _info(user_spec(model, cost, grad_method is GradMethod.AUTO_DIFF, lanes),
                "dilqr_ilqr_fused_info", (ENV_TRACED, int(lanes)), G)
    return dict(zip(_INFO_KEYS, out), cluster=G, lanes=lanes, store=_store(nx, nu))


def lindx_info(nx: int, nu: int, cluster: int = 0, lanes: bool = False) -> dict:
    """kernel_info for a LinDx shape's library (built first if needed),
    with where V, Q and F live (``_store``)."""
    G = geometry(TILE, cluster, sizes=lindx_clusters(nx, nu)).cluster
    out = _info(lindx_spec(nx, nu, lanes), "dilqr_ilqr_lindx_info", (nx, nu, int(lanes)), G)
    return dict(zip(_INFO_KEYS, out), cluster=G, lanes=lanes, store=_store(nx, nu))


def _entry(spec, name: str, n_int: int, n_ptr: int):
    """The C entry ``name`` of the library of ``spec``: ``n_int`` ints and
    ``n_ptr`` pointers lead, then the arguments the two entries share."""
    fn = getattr(build.load(spec), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [I] * n_int + [P] * n_ptr + [P, P, P, P, P, P, P, P, P, I, I, F,
                                                      I, F, F, I, F, I, I, I, P, P, P, P, P,
                                                      P, P, P, P]
        fn.restype = I
    return fn


def inv_lanes(A: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of small SPD-plus-ridge matrices A [..., m, m], m =
    1..8: the kernel's inv_small<M> (JAX's _inv_lanes, ilqr_fused.py:492-545).
    The closed forms of utils/batch.inv_small for m <= 3; unpivoted
    Gauss-Jordan for m >= 4, every entry in the kernel's order: row k scaled
    by 1/pivot, then every other row i less a[i][k] times row k."""
    m = A.shape[-1]
    if m <= 3:
        return inv_small(A)
    a = A.clone()
    inv = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for k in range(m):
        piv = (1.0 / a[..., k, k])[..., None]
        ak, ik = a[..., k, :] * piv, inv[..., k, :] * piv
        fct = a[..., :, k, None]  # a[i][k] before row i changes
        a = a - fct * ak[..., None, :]
        inv = inv - fct * ik[..., None, :]
        a[..., k, :] = ak
        inv[..., k, :] = ik
    return inv


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
        return g, If, Hf, -mv(inv_lanes(Hf), g * If)

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


def cost_quad(cost_b, n: int):
    """(H [Bp, n, n], g [Bp, n]) of a batched cost cost_b(tau [Bp, n]) ->
    [Bp] at tau, as the kernel's quad_at forms them (JAX's forward-over-
    forward one-hot probes, :1063-1080): g by n jvps, H[:, i, j] the jvp of
    g_i along e_j."""

    def grad_at(tv):
        eye = torch.eye(n, dtype=tv.dtype, device=tv.device)[:, None].expand(n, *tv.shape)
        return vmap(lambda e: jvp(cost_b, (tv,), (e,))[1])(eye).movedim(0, -1)

    def quad(tau):
        eye = torch.eye(n, dtype=tau.dtype, device=tau.device)[:, None].expand(n, *tau.shape)
        H = vmap(lambda e: jvp(grad_at, (tau,), (e,))[1])(eye).movedim(0, -1)
        return H, grad_at(tau)

    return quad


def _q_terms(C, c, tau, F, V, v):
    """Q = C + F^T (V F) and q = C tau + c + F^T v over the batch (C [n,n]
    or [Bp,n,n])."""
    FT = F.transpose(-1, -2)
    Ctau = tau @ C.T if C.dim() == 2 else (C @ tau[..., None])[..., 0]
    return C + FT @ (V.transpose(-1, -2) @ F), Ctau + c + (FT @ v[..., None])[..., 0]


def _update(Q, q, nx: int, Kt, kt):
    """V' = Qxx + M + M^T + K^T Quu K with M = Qxu K, v' = qx + Qxu k +
    K^T (qu + Quu k), from Q [Bp, n, n], q [Bp, n] and the gains."""
    Quu, qu = Q[:, nx:, nx:], q[:, nx:]
    M = Q[:, :nx, nx:] @ Kt
    V = Q[:, :nx, :nx] + M + M.transpose(-1, -2) + Kt.transpose(-1, -2) @ (Quu @ Kt)
    v = (q[:, :nx] + (Q[:, :nx, nx:] @ kt[..., None])[..., 0]
         + (Kt.transpose(-1, -2) @ (qu + (Quu @ kt[..., None])[..., 0])[..., None])[..., 0])
    return V, v


def _box_gains(Q, q, nx: int, lb, ub, warm, n_iter: int, tile: int):
    """The n_ctrl > 1 box-QP and gains from Q [Bp, n, n] and q [Bp, n] with
    the delta-space bounds lb/ub [Bp, nu]: the per-tile box-QP warm-started
    with ``warm`` (k_{t+1}; None at T-1: the clipped ridged Newton point),
    K = -inv(H_free) (Q_ux * If). Returns (K, k)."""
    Quu, qu = Q[:, nx:, nx:], q[:, nx:]
    if warm is None:
        eye = torch.eye(qu.shape[1], dtype=Q.dtype, device=Q.device)
        warm = clamp(-(inv_lanes(Quu + REG * eye) @ qu[..., None])[..., 0], lb, ub)
    kt, If, Hf = _pnqp_tiles(Quu, qu, lb, ub, warm, n_iter, tile)
    return -(inv_lanes(Hf) @ (Q[:, nx:, :nx] * If[:, :, None])), kt


def _free_gains(Q, q, nx: int, Iz):
    """The gains of an unboxed solve with a u_zero_I mask Iz [Bp, nu] (0/1):
    If = 1 - Iz, H_free = Quu * If If^T + 1e-8 diag(Iz), k = -inv(H_free)
    (qu * If) -- for n_ctrl == 1 the reference's -(qu * If) / Quu -- and
    K = -inv(H_free) (Q_ux * If) (JAX :1313-1334). Returns (K, k)."""
    Quu, qu = Q[:, nx:, nx:], q[:, nx:]
    If = 1.0 - Iz
    Hf = Quu * If[:, :, None] * If[:, None, :] + 1e-8 * torch.diag_embed(Iz)
    Hinv = inv_lanes(Hf)
    if Iz.shape[1] == 1:
        kt = -(qu * If) / Quu[:, :, 0]
    else:
        kt = -(Hinv @ (qu * If)[..., None])[..., 0]
    return -(Hinv @ (Q[:, nx:, :nx] * If[:, :, None])), kt


def riccati_step(Q, q, nx: int, ut, lo, hi, warm, n_iter: int, tile: int, du=None, Iz=None):
    """One Riccati step's gains and V/v update from Q [Bp, n, n], q [Bp, n]
    at the controls ut [Bp, nu], the kernel's arithmetic: the delta-space
    bounds lo - ut, hi - ut (lo/hi [nu] or [Bp, nu]) intersected with
    +-du, then the exact closed-form 1-D box-QP for n_ctrl == 1 or the
    per-tile box-QP (warm-started with ``warm``, None at T-1) otherwise; or,
    with a mask Iz [Bp, nu] (an unboxed masked solve), the free-subspace
    gains. Returns (K [Bp, nu, nx], k [Bp, nu], V', v')."""
    if Iz is not None:
        K, k = _free_gains(Q, q, nx, Iz)
        return (K, k) + _update(Q, q, nx, K, k)
    lb, ub = lo - ut, hi - ut
    if du is not None:
        lb = torch.maximum(lb, torch.tensor(-du, dtype=lb.dtype, device=lb.device))
        ub = torch.minimum(ub, torch.tensor(du, dtype=ub.dtype, device=ub.device))
    if ut.shape[1] == 1:
        # exact closed-form 1-D box-QP
        H, qu = Q[:, nx:, nx], q[:, nx:]
        k = clamp(-qu / H, lb, ub)
        g = H * k + qu
        Ic = ((k <= lb) & (g > 0.0)) | ((k >= ub) & (g < 0.0))
        If = torch.where(Ic, 0.0, 1.0).to(Q.dtype)
        Hinv = 1.0 / (H * If + 1e-11)
        K = -(Hinv[:, :, None] * (Q[:, nx:, :nx] * If[:, :, None]))
    else:
        K, k = _box_gains(Q, q, nx, lb, ub, warm, n_iter, tile)
    return (K, k) + _update(Q, q, nx, K, k)


def jvp_jacobian(step_fn):
    """[dx'/dx | dx'/du] of step_fn(x [Bp, nx], u [Bp, nu], p) by forward
    mode, as the kernel's JvpJac forms it: ``torch.func.jvp`` of the batched
    step with the one-hot tangent e_j for column j, x's columns first, then
    u's (JAX's ``lin_at`` order), the n columns mapped with
    ``torch.func.vmap`` (the bits of n separate calls, in one). Not jacfwd:
    at a single point it turns f32 into f64."""

    def jac(x, u, p):
        nx, n = x.shape[-1], x.shape[-1] + u.shape[-1]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)[:, None]

        def column(tx, tu):
            return jvp(lambda x_, u_: step_fn(x_, u_, p), (x, u), (tx, tu))[1]

        return vmap(column)(eye[..., :nx].expand(n, *x.shape),
                            eye[..., nx:].expand(n, *u.shape)).movedim(0, -1)

    return jac


def _kernel_step(dyn: Dynamics):
    """The step the kernel takes: the env's kernel form, or a traced
    model's own step."""
    return dyn.kernel_step if dyn.kernel_step is not None else dyn.step


def _jacobian(grad_method: GradMethod, dyn: Dynamics):
    """The kernel's Jacobian of a device env, an MLP or a traced model: the
    hand-derived ``jac_lanes`` under ANALYTIC where the env has one, and
    under either method for an MLP that has one (``mlp_hand``), else the
    jvp sweep of the clamped kernel step (AUTO_DIFF) or of the un-clamped
    physics (ANALYTIC; an env with no hand Jacobian has no kernel form of
    its own, so that is ``linearize_point``)."""
    hand = (mlp_hand(dyn.device_mlp) if dyn.device_mlp is not None
            else not uses_jvp(grad_method, dyn.device_env))
    if hand:
        return dyn.jac_lanes
    return jvp_jacobian(_kernel_step(dyn) if grad_method is GradMethod.AUTO_DIFF
                        else dyn.linearize_point)


def ilqr_fused_reference(cfg: ILQRConfig, dyn, params, x_init: torch.Tensor, cost,
                         u_init: Optional[torch.Tensor] = None,
                         u_lower=None, u_upper=None, u_zero_I: Optional[torch.Tensor] = None,
                         delta_u=None):
    """The kernel's function in plain PyTorch, on the tensors' own device:
    the same padding, per-tile decisions, kernel-form step and Jacobian (the
    hand one or the jvp sweep, ``_jacobian``; a LinDx problem's F_t tau +
    f_t and F_t), objective (a callable cost's true value) and, for a
    callable cost, its (H, g) at each step (``cost_quad``) in place of (C,
    C tau + c), Riccati arithmetic (the
    closed-form QP for n_ctrl == 1, the per-tile box-QP with the explicit
    inverses of inv_lanes and the kernel's warm start otherwise,
    the free-subspace gains of an unboxed masked solve), the variants'
    bounds and accept/best-tracking order. Same arguments and returns as
    ilqr_fused."""
    T, B, nx, nu = cfg.T, x_init.shape[0], cfg.n_state, cfg.n_ctrl
    n = nx + nu
    f32, dev = torch.float32, x_init.device
    Bp = _padded(B)
    G = Bp // TILE
    inp = prepare(cfg, dyn, params, x_init, cost, u_init, u_lower, u_upper, u_zero_I, delta_u,
                  Bp)
    ucost = inp.cost
    if ucost is not None:  # [Bp, n] -> [Bp]
        cpa = () if ucost.params is None else inp.C
        one = ucost.fn if ucost.trace.unary else (lambda t: ucost.fn(t, cpa))

        def cost_b(tau):
            return vmap(one)(tau)

        quad = cost_quad(cost_b, n)
    elif inp.lanes:  # [T, Bp, n, n] and [T, Bp, n]
        Cl = inp.C.permute(0, 2, 1).reshape(T, Bp, n, n)
        cl = inp.c.permute(0, 2, 1)
        Cf, cf = (lambda t: Cl[t]), (lambda t: cl[t])
    else:
        Cs, cs = inp.C.reshape(-1, n, n), inp.c
        Cf = (lambda t: Cs[0]) if Cs.shape[0] == 1 else (lambda t: Cs[t])
        cf = (lambda t: cs[0]) if cs.shape[0] == 1 else (lambda t: cs[t])
    if inp.lb is None:  # static, [nu] each
        lo_s, hi_s = (torch.tensor(v, dtype=f32, device=dev) for v in (inp.lo, inp.hi))
        bounds = lambda t: (lo_s, hi_s)  # noqa: E731
    else:  # [T, Bp, nu]
        lbs, ubs = (a.permute(0, 2, 1) for a in (inp.lb, inp.ub))
        bounds = lambda t: (lbs[t], ubs[t])  # noqa: E731
    uz = None if inp.uz is None else inp.uz.permute(0, 2, 1).to(f32)  # [T, Bp, nu]
    du = inp.du
    if isinstance(dyn, LinDx):  # [T-1, Bp, nx, n] and [T-1, Bp, nx]
        Fs = inp.F.permute(0, 2, 1).reshape(T - 1, Bp, nx, n)
        fs = None if inp.f is None else inp.f.permute(0, 2, 1)

        def step(t, xt, ut):
            xn = (Fs[t] * torch.cat([xt, ut], -1)[:, None, :]).sum(-1)
            return xn if fs is None else xn + fs[t]

        def jac(t, xt, ut):
            return Fs[t]
    else:
        p = params.to(f32)
        jac_p = _jacobian(cfg.grad_method, dyn)
        kstep = _kernel_step(dyn)

        def step(t, xt, ut):
            return kstep(xt, ut, p)

        def jac(t, xt, ut):
            return jac_p(xt, ut, p)

    x0 = inp.x_init.T.contiguous()
    u = torch.zeros(T, Bp, nu, dtype=f32, device=dev)
    if inp.u_init is not None:
        u = inp.u_init.permute(0, 2, 1).contiguous()

    def obj(t, xt, ut):
        tau = torch.cat([xt, ut], -1)
        if ucost is not None:
            return cost_b(tau)
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
        if t < T - 1:
            xt = step(t, xt, u[t])
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
        # box-QP (or free-subspace) gains, V/v update
        V = torch.zeros(Bp, nx, nx, dtype=f32, device=dev)
        v = torch.zeros(Bp, nx, dtype=f32, device=dev)
        K, k = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            xt, ut = x[t], u[t]
            tau = torch.cat([xt, ut], -1)
            F = jac(t, xt, ut) if t < T - 1 else zF
            if ucost is not None:
                H, g = quad(tau)
                FT = F.transpose(-1, -2)
                Q = H + FT @ (V.transpose(-1, -2) @ F)
                q = g + (FT @ v[..., None])[..., 0]
            else:
                Q, q = _q_terms(Cf(t), cf(t), tau, F, V, v)
            lo, hi = bounds(t)
            K[t], k[t], V, v = riccati_step(
                Q, q, nx, ut, lo, hi, k[t + 1] if t < T - 1 else None, cfg.pnqp_iter, TILE,
                du=du, Iz=uz[t] if inp.uz_free else None)

        # 6) line search; the trial runs on every lane and is kept on the
        # lanes of tiles that run it
        def trial(alpha):
            xt, cost_, du2 = x0, torch.zeros_like(alpha), torch.zeros_like(alpha)
            txs, tus = [], []
            for t in range(T):
                kdx = (K[t] * (xt - x[t])[:, None, :]).sum(-1)
                new_u = kdx + u[t] + alpha[:, None] * k[t]
                if uz is not None:  # masked coordinates zeroed before the clamp
                    new_u = new_u * (1.0 - uz[t])
                lo, hi = bounds(t)
                if du is not None:  # the clamp widened around the iterate
                    lo = torch.maximum(u[t] - du, lo)
                    hi = torch.minimum(u[t] + du, hi)
                new_u = clamp(new_u, lo, hi)
                d = u[t] - new_u
                du2 = du2 + (d * d).sum(-1)
                txs.append(xt)
                tus.append(new_u)
                cost_ = cost_ + obj(t, xt, new_u)
                if t < T - 1:
                    xt = step(t, xt, new_u)
            return cost_, du2, torch.stack(txs), torch.stack(tus)

        alpha = torch.ones(Bp, dtype=f32, device=dev)
        cc, du2s, tx, tu = oc.clone(), torch.zeros_like(oc), x, u
        for i in range(cfg.max_linesearch_iter):
            active = run if i == 0 else run & tiles(cc > oc).any(1)
            if bool(active.any()):
                cost_, du2, ntx, ntu = trial(alpha)
                a = lanes(active)
                cc = torch.where(a, cost_, cc)
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

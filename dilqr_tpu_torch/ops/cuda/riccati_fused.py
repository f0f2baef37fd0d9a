"""Reverse Riccati recursion on the card: the wrapper of the hand-written
CUDA kernel ``csrc/riccati_fused.cu`` and its plain PyTorch version.

Counterpart of ``dilqr_tpu/ops/pallas/riccati_fused.py``
(``lqr_backward_pallas`` and the Pallas kernel ``_riccati_kernel``): one
control, the closed-form QP, f32, in three gain modes -- free, box (the
exact 1-D box-QP in delta-space bounds) and zero (the u_zero_I mask of
the KKT/IFT backward's frozen active set). ``ops/riccati.lqr_backward``
sends here the plain loop's Riccati steps that the JAX package sends to
its kernel: solves the whole-solve kernel refuses (the MLP model, the
slew-rate augmentation, the affine model, u_zero_I, delta_u, LinDx,
callable costs) and the KKT backward's auxiliary LQR for shapes the KKT
kernel does not instantiate.

What the kernel computes, as the TPU kernel does (riccati_fused.py:57-158):
Q is built from C's upper triangle, mirrored (the plain recursion reads the
full C, so the two agree for symmetric C, which every cost path gives); at
t = T-1, Q = C and q = c exactly (V_T = 0); in zero mode k divides by the
unmasked Quu while K uses Quu (1 - I) + 1e-8 I; in box mode the active set
is a bound with the gradient pointing outward and H_free = Quu If + 1e-11.

The kernel reads C [T,B,n,n], c [T,B,n] and F [T-1,B,nx,n] where they lie,
through their time and batch strides (an expanded, example-invariant C is
read once, without a copy), forms the box mode's delta-space bounds itself
from u, the bounds (numbers, [1] or [T,B,1] tensors) and delta_u, and reads
the u_zero_I mask as bytes, so a call is one launch and nothing else on the
device; it writes K [T,B,1,nx] and k [T,B,1]. An example is a team of lanes
(``plan``). CUDA tensors launch the kernel; CPU tensors take
``riccati_fused_reference``; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional

import torch

from ...utils.batch import clamp
from . import build

SOURCE = "riccati_fused.cu"
MODES = {"free": 0, "box": 1, "zero": 2}  # kMode* in csrc/riccati_fused.cuh
BLOCK = 128              # threads a block by default
BLOCKS = (64, 128, 256)  # the block sizes the kernel takes; the bits do not change

# kernel launches made by riccati_fused (the plain version does not count)
LAUNCHES = 0


def covered(n_state: int, n_ctrl: int, dtype, u_zero_I, qp_solver: str, boxed: bool,
            f=None) -> bool:
    """True when the kernel computes this configuration -- JAX's gate,
    ``pallas_supported`` plus the f-is-None test of ops/riccati.py:135: one
    control, f32, the closed-form QP, the u_zero_I mask only without a box,
    no f; any n_state >= 1."""
    return (
        n_ctrl == 1
        and dtype == torch.float32
        and qp_solver == "auto"
        and (u_zero_I is None or not boxed)
        and f is None
        and n_state >= 1
    )


def _operands(C, u, u_lower, u_upper, u_zero_I, delta_u):
    """(mode, lb [T,B], ub [T,B]) for the plain version. Box: the
    delta-space bounds lower - u, upper - u, folded with delta_u; zero: lb
    carries the mask as a float; free: both zero."""
    T, B = C.shape[0], C.shape[1]
    dt, dev = C.dtype, C.device
    if u_lower is not None:
        def bound(v):  # a python number stays one: no copy to the device
            v = v if isinstance(v, (int, float)) else torch.as_tensor(v, dtype=dt, device=dev)
            return (v - u).expand(T, B, 1)

        lb, ub = bound(u_lower), bound(u_upper)
        if delta_u is not None:
            lb, ub = clamp(lb, -delta_u, None), clamp(ub, None, delta_u)
        return "box", lb[..., 0].contiguous(), ub[..., 0].contiguous()
    z = torch.zeros(T, B, dtype=dt, device=dev)
    if u_zero_I is not None:
        return "zero", u_zero_I[..., 0].to(dt).contiguous(), z
    return "free", z, z


def _bound(v, T: int, B: int, like: torch.Tensor):
    """A bound as the kernel takes it: (the tensor it is read from, (pointer,
    T stride, B stride), number); a number passes by value (null pointer), a
    tensor (scalar, [1] or broadcastable to [T,B,1]) is read through its
    strides. The caller keeps the tensor until the launch."""
    if isinstance(v, (int, float)):
        return None, (0, 0, 0), float(v)
    v = torch.as_tensor(v)
    if v.dtype != torch.float32 or v.device != like.device:
        v = v.to(like.device, torch.float32)
    v = v.expand(T, B, 1)
    return v, (v.data_ptr(), v.stride(0), v.stride(1)), 0.0


_TLS = threading.local()


def _packed():
    """This thread's argument arrays of dilqr_riccati_fused (csrc/
    riccati_fused.cu): 30 integers and 3 floats, and their addresses."""
    buf = getattr(_TLS, "buf", None)
    if buf is None:
        ia, fa = (ctypes.c_longlong * 30)(), (ctypes.c_double * 3)()
        buf = _TLS.buf = (ia, fa, ctypes.addressof(ia), ctypes.addressof(fa))
    return buf


def riccati_fused(n_state: int, C, c, F, u, u_lower=None, u_upper=None,
                  u_zero_I: Optional[torch.Tensor] = None, delta_u=None, block: int = BLOCK,
                  store: str = "auto"):
    """The reverse Riccati for one control. C [T,B,n,n] (symmetric), c
    [T,B,n], F [T-1,B,nx,n], u [T,B,1]; u_lower/u_upper a number, [1] or
    [T,B,1] (box mode), or u_zero_I [T,B,1] bool (zero mode). Returns
    (K [T,B,1,nx], k [T,B,1]). CUDA tensors launch the kernel, one launch;
    CPU tensors take riccati_fused_reference. ``block`` (threads a block)
    and ``store="global"`` (the looped form's team memory in device memory
    whatever its size) change the launch, never the bits; the card tests
    and chip_smoke.py use them."""
    if not C.is_cuda:
        return riccati_fused_reference(n_state, C, c, F, u, u_lower, u_upper, u_zero_I, delta_u)
    global LAUNCHES
    T, B = C.shape[0], C.shape[1]
    nx, n = n_state, n_state + 1
    boxed = u_lower is not None
    if not covered(nx, 1, C.dtype, u_zero_I, "auto", boxed):
        raise ValueError(f"riccati_fused covers f32, one control and n_state >= 1, the mask "
                         f"only without a box; got n_state={nx}, {C.dtype}")
    if C.shape != (T, B, n, n) or c.shape != (T, B, n) or F.shape != (T - 1, B, nx, n):
        raise ValueError(f"C must be [T,B,{n},{n}], c [T,B,{n}] and F [T-1,B,{nx},{n}]; got "
                         f"{tuple(C.shape)}, {tuple(c.shape)}, {tuple(F.shape)}")
    dev = C.device
    if c.device != dev or F.device != dev or c.dtype != C.dtype or F.dtype != C.dtype:
        raise ValueError(f"c, F must be float32 on {dev}; got {c.dtype} {c.device}, "
                         f"{F.dtype} {F.device}")
    # the kernel walks the small dims densely and the T and B dims by stride
    sC, sc, sF = C.stride(), c.stride(), F.stride()
    if sC[3] != 1 or sC[2] != n:
        C = C.contiguous()
        sC = C.stride()
    if sc[2] != 1:
        c = c.contiguous()
        sc = c.stride()
    if sF[3] != 1 or sF[2] != n:
        F = F.contiguous()
        sF = F.stride()
    if store not in ("auto", "global"):
        raise ValueError("store must be 'auto' or 'global'")
    p = _plan(nx, block, store == "global")
    K = torch.empty(T, B, 1, nx, dtype=torch.float32, device=dev)
    k = torch.empty(T, B, 1, dtype=torch.float32, device=dev)
    # tensors the kernel reads or writes that no caller holds: kept until the
    # launch, so that no allocation in between can take their memory
    scratch = lo = hi = None
    if p["global"]:
        teams = -(-B // p["teams"]) * p["teams"]
        scratch = torch.empty(teams * p["team"], dtype=torch.float32, device=dev)
    # box: u and the bounds (pointer and strides, or a number); zero: the mask
    mode, box, zero, lo_v, hi_v, du = MODES["free"], (0,) * 9, (0, 0, 0), 0.0, 0.0, math.inf
    if boxed:
        if u.shape != (T, B, 1) or u.dtype != torch.float32 or u.device != dev:
            raise ValueError(f"u must be a float32 [{T}, {B}, 1] tensor on {dev}")
        su = u.stride()
        lo, lo_arg, lo_v = _bound(u_lower, T, B, C)
        hi, hi_arg, hi_v = _bound(u_upper, T, B, C)
        mode, box = MODES["box"], (u.data_ptr(), su[0], su[1], *lo_arg, *hi_arg)
        if delta_u is not None:
            du = float(delta_u)
    elif u_zero_I is not None:
        if u_zero_I.dtype != torch.bool or u_zero_I.device != dev:
            raise ValueError(f"u_zero_I must be a bool tensor on {dev}")
        mask = u_zero_I.expand(T, B, 1)
        mode, zero = MODES["zero"], (mask.data_ptr(), mask.stride(0), mask.stride(1))
    ia, fa, pia, pfa = _packed()
    ia[:] = (nx, mode, T, B, block, int(store == "global"), C.data_ptr(), sC[0], sC[1],
             c.data_ptr(), sc[0], sc[1], F.data_ptr(), sF[0], sF[1], *box, *zero,
             K.data_ptr(), k.data_ptr(), 0 if scratch is None else scratch.data_ptr())
    fa[:] = (lo_v, hi_v, du)
    fn = _entry("dilqr_riccati_fused")
    if dev.index == torch.cuda.current_device():
        rc = fn(pia, pfa, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(pia, pfa, torch._C._cuda_getCurrentRawStream(dev.index))
    del scratch, lo, hi
    if rc != 0:
        raise RuntimeError(f"riccati_fused kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return K, k


_PLANS: Dict[tuple, dict] = {}


def _plan(nx: int, block: int, force_global: bool) -> dict:
    key = (nx, block, force_global)
    p = _PLANS.get(key)
    if p is None:
        if block not in BLOCKS:
            raise ValueError(f"block must be one of {BLOCKS}")
        out = (ctypes.c_int * 6)()
        if _entry("dilqr_riccati_plan")(nx, block, int(force_global), out) != 0:
            raise ValueError(f"riccati_fused has no launch plan for n_state {nx}, block {block}"
                             + (", store 'global' (the team form keeps nothing there)"
                                if force_global else ""))
        p = _PLANS[key] = dict(zip(("L", "teams", "smem", "global", "team", "looped"),
                                   (int(v) for v in out)))
    return p


def plan(n_state: int, B: int, block: int = BLOCK, store: str = "auto") -> dict:
    """The launch plan of a call at this n_state and batch (csrc/
    riccati_fused.cuh riccati_plan): "L" lanes a team (a power of two >=
    n_state + 1; 32 in the looped form past 32), "teams" a block, "smem"
    shared bytes a block, "global" 1 when the looped form's team memory is
    the device-memory scratch, "team" its floats a team, "looped", and
    "scratch" the scratch's floats for B examples (0 in shared memory)."""
    if store not in ("auto", "global"):
        raise ValueError("store must be 'auto' or 'global'")
    if store not in ("auto", "global"):
        raise ValueError("store must be 'auto' or 'global'")
    p = dict(_plan(n_state, block, store == "global"))
    p["scratch"] = -(-B // p["teams"]) * p["teams"] * p["team"] if p["global"] else 0
    return p


_ENTRIES: Dict[str, object] = {}


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(build.load(SOURCE), name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I, P] if name == "dilqr_riccati_plan" else [P, P, P]
        fn.restype = I
        _ENTRIES[name] = fn
    return fn


def riccati_fused_reference(n_state: int, C, c, F, u, u_lower=None, u_upper=None,
                            u_zero_I: Optional[torch.Tensor] = None, delta_u=None):
    """The kernel's function in plain PyTorch over the batch, on the
    tensors' own device: Q from C's upper triangle mirrored, Q = C and
    q = c at t = T-1, the three gain modes of riccati_fused.py:110-140 and
    the V/v update with V kept symmetric. Same arguments and returns as
    riccati_fused."""
    T, B = C.shape[0], C.shape[1]
    nx = n_state
    mode, lb, ub = _operands(C, u, u_lower, u_upper, u_zero_I, delta_u)

    def sym(M):
        return M.triu() + M.triu(1).transpose(-1, -2)

    V = torch.zeros(B, nx, nx, dtype=C.dtype, device=C.device)
    v = torch.zeros(B, nx, dtype=C.dtype, device=C.device)
    Ks, ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        if t == T - 1:
            Q, q = sym(C[t]), c[t]
        else:
            Ft = F[t]
            tmp = (V[:, :, :, None] * Ft[:, None, :, :]).sum(2)  # V F [B, nx, n]
            Q = sym(C[t] + (Ft[:, :, :, None] * tmp[:, :, None, :]).sum(1))
            q = c[t] + (Ft * v[:, :, None]).sum(1)
        Quu, Qux, qu = Q[:, nx, nx], Q[:, :nx, nx], q[:, nx]
        if mode == "box":
            kt = clamp(-qu / Quu, lb[t], ub[t])
            g = Quu * kt + qu
            Ic = ((kt <= lb[t]) & (g > 0.0)) | ((kt >= ub[t]) & (g < 0.0))
            If = torch.where(Ic, 0.0, 1.0).to(Q.dtype)
            K = -(Qux * If[:, None]) / (Quu * If + 1e-11)[:, None]
        elif mode == "zero":
            uz = lb[t]
            notI = 1.0 - uz
            kt = -(qu * notI) / Quu
            K = -(Qux * notI[:, None]) / (Quu * notI + 1e-8 * uz)[:, None]
        else:
            kt = -qu / Quu
            K = -Qux / Quu[:, None]
        qu_plus = qu + Quu * kt
        V = sym(Q[:, :nx, :nx] + Qux[:, :, None] * K[:, None, :] + K[:, :, None] * Qux[:, None, :]
                + Quu[:, None, None] * K[:, :, None] * K[:, None, :])
        v = q[:, :nx] + Qux * kt[:, None] + K * qu_plus[:, None]
        Ks[t], ks[t] = K, kt
    return torch.stack(Ks)[:, :, None, :], torch.stack(ks)[:, :, None]

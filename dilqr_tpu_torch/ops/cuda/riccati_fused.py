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

The wrapper folds delta_u into the delta-space bounds and carries the mask
as a float, as ``lqr_backward_pallas`` does (:205-216). The kernel reads
C [T,B,n,n], c [T,B,n] and F [T-1,B,nx,n] where they lie, through their
time and batch strides (an expanded, example-invariant C is read without a
copy), and writes K [T,B,1,nx] and k [T,B,1]. CUDA tensors launch the
kernel; CPU tensors take ``riccati_fused_reference``; there is no fallback
from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...utils.batch import clamp
from . import build

SOURCE = "riccati_fused.cu"
MAX_NX = 8  # csrc/riccati_fused.cu instantiates n_state 1..8
MODES = {"free": 0, "box": 1, "zero": 2}  # kMode* in csrc/riccati_fused.cuh

# kernel launches made by riccati_fused (the plain version does not count)
LAUNCHES = 0


def covered(n_state: int, n_ctrl: int, dtype, u_zero_I, qp_solver: str, boxed: bool,
            f=None) -> bool:
    """True when the kernel computes this configuration (counterpart of
    ``pallas_supported`` plus the f-is-None gate of ops/riccati.py:135):
    one control, f32, the closed-form QP, the u_zero_I mask only without a
    box, no f, and an instantiated 1 <= n_state <= 8."""
    return (
        n_ctrl == 1
        and dtype == torch.float32
        and qp_solver == "auto"
        and (u_zero_I is None or not boxed)
        and f is None
        and 1 <= n_state <= MAX_NX
    )


def _operands(C, u, u_lower, u_upper, u_zero_I, delta_u):
    """(mode, lb [T,B], ub [T,B]). Box: the delta-space bounds lower - u,
    upper - u, folded with delta_u; zero: lb carries the mask as a float;
    free: both zero."""
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


def riccati_fused(n_state: int, C, c, F, u, u_lower=None, u_upper=None,
                  u_zero_I: Optional[torch.Tensor] = None, delta_u=None, block: int = 0):
    """The reverse Riccati for one control. C [T,B,n,n] (symmetric), c
    [T,B,n], F [T-1,B,nx,n], u [T,B,1]; u_lower/u_upper a scalar,
    [1] or [T,B,1] (box mode), or u_zero_I [T,B,1] bool (zero mode).
    Returns (K [T,B,1,nx], k [T,B,1]). ``block``: threads a block, 0 for the
    kernel's default (the result does not depend on it). CUDA tensors
    launch the kernel; CPU tensors take riccati_fused_reference."""
    if not C.is_cuda:
        return riccati_fused_reference(n_state, C, c, F, u, u_lower, u_upper, u_zero_I, delta_u)
    global LAUNCHES
    T, B = C.shape[0], C.shape[1]
    nx, n = n_state, n_state + 1
    mode, lb, ub = _operands(C, u, u_lower, u_upper, u_zero_I, delta_u)
    if not covered(nx, 1, C.dtype, u_zero_I, "auto", u_lower is not None):
        raise ValueError(f"riccati_fused covers f32 and 1 <= n_state <= {MAX_NX}; got "
                         f"n_state={nx}, {C.dtype}")
    if tuple(C.shape) != (T, B, n, n) or tuple(c.shape) != (T, B, n) \
            or tuple(F.shape) != (T - 1, B, nx, n):
        raise ValueError(f"C must be [T,B,{n},{n}], c [T,B,{n}] and F [T-1,B,{nx},{n}]; got "
                         f"{tuple(C.shape)}, {tuple(c.shape)}, {tuple(F.shape)}")
    for name, t in (("C", C), ("c", c), ("F", F), ("lb", lb), ("ub", ub)):
        if t.device != C.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {t.device} {t.dtype}, C on {C.device}")
    # the kernel walks the small dims densely and the T and B dims by stride
    C = C if C.stride()[2:] == (n, 1) else C.contiguous()
    c = c if c.stride(2) == 1 else c.contiguous()
    F = F if F.stride()[2:] == (n, 1) else F.contiguous()
    K = torch.empty(T, B, 1, nx, dtype=torch.float32, device=C.device)
    k = torch.empty(T, B, 1, dtype=torch.float32, device=C.device)
    fn = _entry()
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        rc = fn(nx, MODES[mode], T, B, block, C.data_ptr(), C.stride(0), C.stride(1),
                c.data_ptr(), c.stride(0), c.stride(1), F.data_ptr(), F.stride(0), F.stride(1),
                lb.data_ptr(), ub.data_ptr(), K.data_ptr(), k.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"riccati_fused kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return K, k


def _entry():
    fn = build.load(SOURCE).dilqr_riccati_fused
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, I, I, I, I, P, L, L, P, L, L, P, L, L, P, P, P, P, P]
        fn.restype = I
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

"""Module-KKT VJP on the card: the wrapper of the hand-written CUDA kernel
``csrc/kkt_fused.cu`` and its plain PyTorch version.

Counterpart of ``dilqr_tpu/ops/pallas/kkt_fused.py`` (``make_kkt_vjp_pallas``
and the Pallas kernels ``_kkt_kernel`` / ``_kkt_stream_kernel``): for a fixed
solution point (C, c, F, x, u) and frozen active set, one call maps a
cotangent r = (g_x, g_u) to the auxiliary LQR's solution dtau and the two
adjoint recursions lam, dlam; ``assemble`` turns those into
(dx_init, dC, dc, dF, df) outside the kernel, as the JAX wrapper does
(kkt_fused.py:561-572).

``make_kkt_vjp_cuda`` builds the cotangent-invariant operands once (C as
its packed upper triangle, F padded to T, the mask, the adjoint offset
b_t = C_t[:nx, :] tau_t + c_t[:nx]) in the kernel's [T, k, B] layout and
returns ``call(g_x, g_u, full)``; the IFT GMRES loop calls it every
iteration. CUDA tensors launch the kernel; CPU tensors take
``kkt_fused_reference``; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ...utils.batch import inv_small
from . import build

SOURCE = "kkt_fused.cu"
# the (n_state, n_ctrl) pairs csrc/kkt_fused.cu instantiates
SHAPES = ((3, 1), (4, 1), (5, 1), (4, 2), (4, 3), (13, 3))

# kernel launches made by kkt_fused (the plain version does not count)
LAUNCHES = 0


def covered(T: int, n_state: int, n_ctrl: int, dtype, parallel: bool = False) -> bool:
    """True when the kernel computes this shape (counterpart of
    ``kkt_fused_supported``): an instantiated (n_state, n_ctrl), f32, T >= 2,
    and not the parallel Riccati."""
    return (n_state, n_ctrl) in SHAPES and dtype == torch.float32 and T >= 2 and not parallel


def _tri_index(n: int):
    """Row-major (i, j >= i) pairs of the packed upper triangle."""
    iu = [(i, j) for i in range(n) for j in range(i, n)]
    return [p[0] for p in iu], [p[1] for p in iu]


class KKTOperands(NamedTuple):
    """Cotangent-invariant operands in the kernel layout [T, k, B]."""
    n_state: int
    n_ctrl: int
    C: torch.Tensor    # [T, n(n+1)/2, B] packed upper triangle
    F: torch.Tensor    # [T, nx*n, B], zero slab at T-1
    uz: torch.Tensor   # [T, nu, B] 1.0 = frozen
    lb: torch.Tensor   # [T, nx, B] adjoint offset C[:nx, :] tau + c[:nx]
    tau: torch.Tensor  # [T, B, n] the solution, for the assembly


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
    Ct = C[:, :, ii, jj].permute(0, 2, 1).contiguous()
    Fp = torch.cat([F, torch.zeros_like(F[:1])], 0)
    Fk = Fp.reshape(T, B, nx * n).permute(0, 2, 1).contiguous()
    uz = (torch.zeros(T, B, nu, dtype=C.dtype, device=C.device) if u_zero_I is None
          else u_zero_I.to(C.dtype))
    lb = torch.einsum("tbij,tbj->tbi", C[:, :, :nx, :], tau) + c[:, :, :nx]
    return KKTOperands(nx, nu, Ct, Fk, uz.permute(0, 2, 1).contiguous(),
                       lb.permute(0, 2, 1).contiguous(), tau)


def kkt_fused(ops: KKTOperands, r: torch.Tensor):
    """One VJP. r [T, n, B] in the kernel layout. Returns (dtau [T,n,B],
    lam [T,nx,B], dlam [T,nx,B]). CUDA tensors launch the kernel; CPU
    tensors take kkt_fused_reference."""
    if not r.is_cuda:
        return kkt_fused_reference(ops, r)
    global LAUNCHES
    nx, nu = ops.n_state, ops.n_ctrl
    n = nx + nu
    T, B = ops.C.shape[0], ops.C.shape[2]
    if not covered(T, nx, nu, r.dtype):
        raise ValueError(f"kkt_fused covers f32, T >= 2 and (n_state, n_ctrl) in {SHAPES}; "
                         f"got ({nx}, {nu}), T={T}, {r.dtype}")
    if tuple(r.shape) != (T, n, B) or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous [T, {n}, B] = [{T}, {n}, {B}] tensor")
    for name, t in zip(("C", "F", "uz", "lb"), ops[2:6]):
        if t.device != r.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"operand {name}: {t.device} {t.dtype}, r on {r.device}")
    dev = r.device
    dtau = torch.empty(T, n, B, dtype=torch.float32, device=dev)
    lam = torch.empty(T, nx, B, dtype=torch.float32, device=dev)
    dlam = torch.empty(T, nx, B, dtype=torch.float32, device=dev)
    K = torch.empty(T, nu * nx, B, dtype=torch.float32, device=dev)
    k = torch.empty(T, nu, B, dtype=torch.float32, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(nx, nu, T, B, ops.C.data_ptr(), ops.F.data_ptr(), r.data_ptr(),
                ops.uz.data_ptr(), ops.lb.data_ptr(), dtau.data_ptr(), lam.data_ptr(),
                dlam.data_ptr(), K.data_ptr(), k.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kkt_fused kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return dtau, lam, dlam


def _entry():
    fn = build.load(SOURCE).dilqr_kkt_fused
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I, I, P, P, P, P, P, P, P, P, P, P, P]
        fn.restype = I
    return fn


def kkt_fused_reference(ops: KKTOperands, r: torch.Tensor):
    """The kernel's function in plain PyTorch over the batch, on the
    tensors' own device: the same packed-triangle C, zero-mask gains (k
    divides by the unmasked Quu for nu == 1, closed-form inverse for
    nu = 2, 3), V/v update and recursions. Same arguments and returns as
    kkt_fused."""
    nx, nu = ops.n_state, ops.n_ctrl
    n = nx + nu
    T, B = ops.C.shape[0], ops.C.shape[2]
    dt = ops.C.dtype
    ii, jj = _tri_index(n)
    Cf = torch.zeros(T, B, n, n, dtype=dt, device=ops.C.device)
    Ct = ops.C.permute(0, 2, 1)
    Cf[:, :, ii, jj] = Ct
    Cf[:, :, jj, ii] = Ct
    F = ops.F.permute(0, 2, 1).reshape(T, B, nx, n)
    uz = ops.uz.permute(0, 2, 1)
    lb = ops.lb.permute(0, 2, 1)
    rr = r.permute(0, 2, 1)

    def mv(A, x):
        return (A * x[..., None, :]).sum(-1)

    def mm(A, Bm):
        return (A[..., :, :, None] * Bm[..., None, :, :]).sum(-2)

    # pass 1: reverse Riccati on (C, -r, F)
    V = torch.zeros(B, nx, nx, dtype=dt, device=Cf.device)
    v = torch.zeros(B, nx, dtype=dt, device=Cf.device)
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
    dx = torch.zeros(B, nx, dtype=dt, device=Cf.device)
    dtau = []
    for t in range(T):
        du = (mv(Ks[t], dx) + ks[t]) * (1.0 - uz[t])
        d = torch.cat([dx, du], -1)
        dtau.append(d)
        dx = mv(F[t], d)

    # pass 3: joint reverse adjoints
    lam = torch.zeros(B, nx, dtype=dt, device=Cf.device)
    dlam = torch.zeros_like(lam)
    lams, dlams = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        FxT = F[t][:, :, :nx].transpose(-1, -2)
        lam = lb[t] + mv(FxT, lam)
        dlam = mv(Cf[t][:, :nx, :], dtau[t]) - rr[t][:, :nx] + mv(FxT, dlam)
        lams[t], dlams[t] = lam, dlam
    to_k = lambda xs: torch.stack(xs).permute(0, 2, 1).contiguous()  # noqa: E731
    return to_k(dtau), to_k(lams), to_k(dlams)


def assemble(ops: KKTOperands, dtau, lam, dlam, full: bool = True):
    """(dx_init, dC, dc, dF, df) from the kernel's outputs (kkt_fused.py:
    561-572): dF = -(dlam_{t+1} tau_t^T + lam_{t+1} dtau_t^T), df =
    -dlam_{1:}; in full mode also dx_init = -dlam_0, the symmetrized
    dC = -1/2 (dtau tau^T + tau dtau^T) and dc = -dtau."""
    tau = ops.tau
    dtau = dtau.permute(0, 2, 1)
    lam = lam.permute(0, 2, 1)
    dlam = dlam.permute(0, 2, 1)
    dF = -(dlam[1:, :, :, None] * tau[:-1, :, None, :]
           + lam[1:, :, :, None] * dtau[:-1, :, None, :])
    df = -dlam[1:]
    if not full:
        return None, None, None, dF, df
    dC = -0.5 * (dtau[..., :, None] * tau[..., None, :] + tau[..., :, None] * dtau[..., None, :])
    return -dlam[0], dC, -dtau, dF, df


def cotangent(g_x: torch.Tensor, g_u: torch.Tensor) -> torch.Tensor:
    """(g_x [T,B,nx], g_u [T,B,nu]) -> r [T, n, B] in the kernel layout."""
    return torch.cat([g_x, g_u], -1).permute(0, 2, 1).contiguous()


def make_kkt_vjp_cuda(n_state: int, n_ctrl: int, C, c, F, x, u,
                      u_zero_I: Optional[torch.Tensor] = None):
    """Factory: lays the invariant operands out once and returns
    ``call(g_x, g_u, full) -> (dx_init, dC, dc, dF, df)`` (None for the
    first three when full is False)."""
    ops = prepare(n_state, n_ctrl, C, c, F, x, u, u_zero_I)

    def call(g_x, g_u, full: bool = True):
        return assemble(ops, *kkt_fused(ops, cotangent(g_x, g_u)), full=full)

    return call

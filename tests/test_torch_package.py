"""Package rules of the PyTorch port: it loads nothing of JAX or of the JAX
package, it refuses what it does not implement instead of returning
something else, and CPU tensors never reach the CUDA kernels."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import cartpole
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from dilqr_tpu_torch.ops.cuda import kkt_fused, riccati_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_nothing_of_dilqr_tpu():
    code = r"""
import importlib, pkgutil, sys
import dilqr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dilqr_tpu_torch.__path__, "dilqr_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "dilqr_tpu" or m.startswith("dilqr_tpu.")]
print(len(names), bad)
assert len(names) >= 47, names
new = {"dilqr_tpu_torch.ops.parallel_riccati", "dilqr_tpu_torch.il.lstm",
       "dilqr_tpu_torch.utils.logging", "dilqr_tpu_torch.utils.numdiff",
       "dilqr_tpu_torch.utils.profiling", "dilqr_tpu_torch.parallel.audit",
       "dilqr_tpu_torch.parallel.comm", "dilqr_tpu_torch.parallel.mesh",
       "dilqr_tpu_torch.parallel.multihost", "dilqr_tpu_torch.tools.multihost_demo",
       "dilqr_tpu_torch.tools.fuzz_gradients", "dilqr_tpu_torch.viz"}
new |= {"dilqr_tpu_torch.examples." + e for e in (
    "cost_sweep", "closed_loop", "mismatch_loop", "rocket_landing", "sysid_pendulum",
    "external_plant")}
assert new <= set(names), new - set(names)
assert not bad, bad
# viz imports matplotlib when it draws, never at import: the card's machine has none
assert "matplotlib" not in sys.modules
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _problem(B=3, T=6, **cfg_kw):
    dyn = cartpole.make()
    q, p = cartpole.get_true_obj()
    rng = np.random.RandomState(0)
    th = rng.uniform(-1, 1, B)
    x0 = from_numpy(np.stack([np.zeros(B), np.zeros(B), np.cos(th), np.sin(th),
                              np.zeros(B)], 1), dtype=torch.float32)
    kw = dict(n_state=5, n_ctrl=1, T=T, lqr_iter=3, eps=1e-4, backprop=False,
              exit_unconverged=False)
    kw.update(cfg_kw)
    return P.ILQRConfig(**kw), x0, P.QuadCost(torch.diag(q), p), dyn, cartpole.default_params()


def test_backend_cuda_on_cpu_tensors_raises():
    cfg, x0, cost, dyn, params = _problem(backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.solve(cfg, x0, cost, dyn, params=params, u_lower=-100.0, u_upper=100.0)


@pytest.mark.parametrize("mode", list(P.BackwardMode))
def test_backprop_on_cpu_tensors_launches_no_kernel(mode):
    """backprop=True (the default) gives a differentiable result in every
    mode on CPU tensors, through the plain versions only."""
    cfg, x0, cost, dyn, params = _problem(backprop=True, backward_mode=mode,
                                          unroll=mode is P.BackwardMode.UNROLL,
                                          detach_unconverged=False)
    params = params.clone().requires_grad_(True)
    before = (fused.LAUNCHES, kkt_fused.LAUNCHES, riccati_fused.LAUNCHES)
    res = P.solve(cfg, x0, cost, dyn, params=params, u_lower=-100.0, u_upper=100.0)
    assert res.u.requires_grad and not res.costs.requires_grad
    (g,) = torch.autograd.grad((res.u ** 2).sum(), params)
    assert (fused.LAUNCHES, kkt_fused.LAUNCHES, riccati_fused.LAUNCHES) == before
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_unported_options_raise():
    """riccati_parallel solves (unboxed: the associative-scan backward; f32,
    the sequential solve's costs to 1e-5 relative); a backend the port does
    not have raises."""
    cfg, x0, cost, dyn, params = _problem(riccati_parallel=True)
    res = P.solve(cfg, x0, cost, dyn, params=params)
    seq = P.solve(dataclasses.replace(cfg, riccati_parallel=False), x0, cost, dyn,
                  params=params)
    assert torch.isfinite(res.u).all()
    torch.testing.assert_close(res.costs, seq.costs, rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="backend"):
        P.ILQRConfig(n_state=5, n_ctrl=1, T=4, backend="pallas")


def test_cpu_path_launches_nothing():
    cfg, x0, cost, dyn, params = _problem()
    before = fused.LAUNCHES
    res = P.MPC(5, 1, 6, u_lower=-100.0, u_upper=100.0, lqr_iter=3, eps=1e-4,
                backprop=False, exit_unconverged=False).solve(x0, cost, dyn, params=params)
    assert fused.LAUNCHES == before
    assert res.x.device.type == "cpu" and torch.isfinite(res.costs).all()
    assert not res.x.requires_grad


def test_input_validation():
    cfg, x0, cost, dyn, params = _problem()
    with pytest.raises(ValueError, match="x_init"):
        P.solve(cfg, x0[:, :3], cost, dyn, params=params)
    with pytest.raises(ValueError, match="both"):
        P.solve(cfg, x0, cost, dyn, params=params, u_lower=-1.0)
    with pytest.raises(ValueError, match="delta_u"):
        P.solve(cfg, x0, cost, dyn, params=params, delta_u=0.1)
    with pytest.raises(ValueError, match="n_batch"):
        P.MPC(5, 1, 6, n_batch=7, backprop=False)(x0, cost, dyn, params=params)
    with pytest.raises(ValueError, match="back_eps"):
        dataclasses.replace(cfg, back_eps=1e-3)


def test_from_numpy_keeps_structure():
    tree = {"cost": P.QuadCost(np.eye(2), np.zeros(2)),
            "dyn": P.LinDx(np.ones((1, 2, 2, 3)), None),
            "seq": (np.arange(3, dtype=np.int64), 1.5, None)}
    out = from_numpy(tree, dtype=torch.float32)
    assert isinstance(out["cost"], P.QuadCost) and out["cost"].C.dtype == torch.float32
    assert isinstance(out["dyn"], P.LinDx) and out["dyn"].f is None
    assert out["seq"][0].dtype == torch.int64 and out["seq"][1] == 1.5
    with pytest.raises(TypeError):
        from_numpy(object())

"""The port's multi-process path on the CPU: real gloo clusters of the
port's demo (dilqr_tpu_torch/tools/multihost_demo.py, which imports no
JAX), one process a rank on a file store, held against the JAX package
computed here on the same numpy inputs.

Each rank of the demo checks itself against the one-process port program;
this test holds rank 0's gathered results against ``dilqr_tpu.solve`` and
JAX's single-device optax.rmsprop(1e-2, decay=0.5) step at
scripts/multihost_demo.py's tolerances: u 1e-6, params 1e-6, loss 1e-7, at
f64. Every cluster has its own timeout (``launch``: the first rank that
fails, or the timeout, ends every rank); the 4-rank cluster takes about
15 s here, so it stays in the tier-1 lane, where JAX marks its own 4-process
test slow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import dilqr_tpu
from dilqr_tpu import BackwardMode, ILQRConfig, QuadCost
from dilqr_tpu.models import pendulum
from dilqr_tpu_torch.tools.multihost_demo import launch

TIMEOUT = 240.0


def _jax_problem():
    dyn, params = pendulum.make(), jnp.asarray(pendulum.default_params(), jnp.float64)
    q, p = (jnp.asarray(a, jnp.float64) for a in pendulum.get_true_obj())
    cfg = ILQRConfig(n_state=3, n_ctrl=1, T=8, lqr_iter=6, eps=1e-4,
                     linesearch_decay=dyn.linesearch_decay,
                     max_linesearch_iter=dyn.max_linesearch_iter, exit_unconverged=False,
                     detach_unconverged=False, backward_mode=BackwardMode.IFT, backend="xla")
    return cfg, dyn, params, q, p


def _jax_u(x, **kw):
    cfg, dyn, params, q, p = _jax_problem()
    return np.asarray(dilqr_tpu.solve(cfg, jnp.asarray(x), QuadCost(jnp.diag(q), p), dyn,
                                      params=params, u_lower=dyn.lower, u_upper=dyn.upper,
                                      **kw).u)


def _run(tmp_path, n, *argv):
    out = tmp_path / "rank0.npz"
    outs = launch(n, ["--device", "cpu", "--dtype", "float64", "--out", str(out), *argv],
                  timeout=TIMEOUT)
    assert all("MULTIHOST OK" in o for o in outs), outs
    return dict(np.load(out))


def test_two_rank_cluster_matches_jax(tmp_path):
    """2 ranks of 8: the sharded solve, the warm-started solve and one train
    step against JAX's one-process program; no per-example collective, no
    kernel launch on the CPU."""
    d = _run(tmp_path, 2)
    assert d["mode"] == "even" and d["u"].shape == (16, 8, 1)
    np.testing.assert_allclose(d["u"], _jax_u(d["x_init"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d["u_warm"], _jax_u(d["x_init"], u_init=jnp.asarray(d["u0"])),
                               rtol=0, atol=1e-6)

    cfg, dyn, params, q, p = _jax_problem()
    opt = optax.rmsprop(1e-2, decay=0.5)

    def loss_fn(pp, x, ue):
        r = dilqr_tpu.solve(cfg, x, QuadCost(jnp.diag(q), p), dyn, params=pp,
                            u_lower=dyn.lower, u_upper=dyn.upper)
        return jnp.mean((r.u - ue) ** 2)

    x, ue = jnp.asarray(d["x_init"]), jnp.zeros((16, cfg.T, 1))
    loss, grads = jax.value_and_grad(loss_fn)(params, x, ue)
    upd, _ = opt.update(grads, opt.init(params), params)
    np.testing.assert_allclose(d["params"], np.asarray(optax.apply_updates(params, upd)),
                               rtol=0, atol=1e-6)
    assert abs(float(d["loss"]) - float(loss)) <= 1e-7
    # the collectives: 1-element flags and n_iter in the solve; in the step
    # 1-element flags and one buffer of the 3 params' gradient, the loss
    # and the example count
    n_solve, e_solve = d["collectives_solve"]
    assert n_solve >= 2 and e_solve == n_solve
    n_step, e_step = d["collectives_step"]
    assert n_step >= 2 and e_step == n_step - 1 + 5
    assert (d["launches"] == 0).all()


def test_four_rank_uneven_padded_cluster(tmp_path):
    """4 ranks with 3+5+2+3 examples: distribute_batch_padded's 16-row
    padded batch with its validity mask, the real examples against JAX's
    solve of the 13, and the strict equal-share path (2 a rank)."""
    d = _run(tmp_path, 4, "--batches", "3,5,2,3")
    assert d["mode"] == "uneven" and d["u"].shape == (13, 8, 1)
    np.testing.assert_array_equal(d["valid"], np.arange(16) < 13)
    np.testing.assert_allclose(d["u"], _jax_u(d["x_init"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d["u_strict"], _jax_u(d["x_init"][:8]), rtol=0, atol=1e-6)


def test_a_failing_rank_ends_the_cluster(tmp_path):
    """A rank that raises exits 1 and the launcher ends the cluster with
    every rank's output instead of waiting on the others."""
    with pytest.raises(RuntimeError, match="3 sizes for 2 ranks"):
        launch(2, ["--device", "cpu", "--batches", "1,2,3"], timeout=TIMEOUT)

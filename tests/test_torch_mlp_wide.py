"""The learned cartpole model at its published widths (the reference's
NNDynamics, 6 -> 100 -> 5 sigmoid with passthrough, 1,205 weights;
``models/cartpole_mlp``) on the CPU, in float64 with seeded weights:

 * the benchmark's plain reference model (benchmark/configs/cartpole_mlp.py)
   against the port's kernel form ``kernel_step`` and hand Jacobian
   ``jac_lanes`` (1e-12), and its Jacobian against torch.func.jacfwd of its
   step (1e-9);
 * per-example weights [B, P] against a loop over [P];
 * ``MPC.solve`` on one tile of 16 against the plain reference solver
   (benchmark/reference/ilqr.solve): relative cost within 1e-9 and u within
   1e-6, as benchmark/tests/test_bench_reference.py holds the cartpole;
 * the gate: the port admits the model past JAX's 256 weights, as a pytree
   or flat, and counts the CPU solve as a plain one (``PLAIN_SOLVES``);
 * cartpole_mlp.json's weights regenerated from the seed it states.
"""
import json
import os

import pytest
import torch

import dilqr_tpu_torch as P
from benchmark import spec
from benchmark.problem import Problem
from dilqr_tpu_torch.core import ilqr as tilqr
from dilqr_tpu_torch.models import cartpole_mlp, nn_dynamics
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused

SEED = 21


def _inputs(B, gen, dtype=torch.float64):
    x = torch.randn(B, 5, generator=gen, dtype=dtype)
    u = 10.0 * torch.randn(B, 1, generator=gen, dtype=dtype)
    return x, u


def test_reference_model_matches_kernel_forms():
    """The reference's step and jac against the port's kernel_step and
    jac_lanes at f64 (1e-12), at starts and at random points."""
    ref = spec.config_model("cartpole_mlp")
    dyn = cartpole_mlp.make()
    p = cartpole_mlp.flat_init_params(SEED, dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    x, u = _inputs(32, gen)
    x = torch.cat([x, ref.start(gen, 8, spec.config("cartpole_mlp")["start"], torch.float64)])
    u = torch.cat([u, torch.zeros(8, 1, dtype=torch.float64)])
    torch.testing.assert_close(ref.step(x, u, p), dyn.kernel_step(x, u, p), rtol=0, atol=1e-12)
    torch.testing.assert_close(ref.jac(x, u, p), dyn.jac_lanes(x, u, p), rtol=0, atol=1e-12)


def test_reference_jacobian_matches_jacfwd():
    """The reference's hand Jacobian (grad_input) against forward-mode
    autodiff of its own step (1e-9)."""
    ref = spec.config_model("cartpole_mlp")
    p = cartpole_mlp.flat_init_params(SEED, dtype=torch.float64)
    x, u = _inputs(16, torch.Generator().manual_seed(2))
    jx, ju = torch.func.vmap(torch.func.jacfwd(lambda a, b: ref.step(a, b, p),
                                               argnums=(0, 1)))(x, u)
    torch.testing.assert_close(ref.jac(x, u, p), torch.cat([jx, ju], -1), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("form", ["kernel_step", "jac_lanes", "step pytree"])
def test_per_example_weights_match_a_loop(form):
    """Weights [B, P] (a plant whose weights differ per example) give what
    each example's own weights [P] give: bit for bit in the kernel forms
    (the same row sums), to 1e-12 in the pytree step (a batched matmul)."""
    dyn = cartpole_mlp.make()
    gen = torch.Generator().manual_seed(3)
    p = cartpole_mlp.flat_init_params(SEED, dtype=torch.float64)
    B = 6
    pb = p * (1.0 + 0.05 * (2.0 * torch.rand(B, p.shape[0], generator=gen,
                                             dtype=torch.float64) - 1.0))
    x, u = _inputs(B, gen)
    if form == "step pytree":
        def tree(v):
            W1, b1 = v[..., :600].reshape(v.shape[:-1] + (100, 6)), v[..., 600:700]
            W2, b2 = v[..., 700:1200].reshape(v.shape[:-1] + (5, 100)), v[..., 1200:]
            return [(W1, b1), (W2, b2)]

        got = dyn.step(x, u, tree(pb))
        want = torch.stack([dyn.step(x[i], u[i], tree(pb[i])) for i in range(B)])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
        torch.testing.assert_close(got, dyn.kernel_step(x, u, pb), rtol=0, atol=1e-12)
        return
    fn = getattr(dyn, form)
    got = fn(x, u, pb)
    want = torch.stack([fn(x[i], u[i], pb[i]) for i in range(B)])
    assert torch.equal(got, want)


def test_mpc_solve_matches_reference_solver():
    """MPC.solve of the configuration (its program, the port's plain loop
    on the CPU) on one tile of 16 from warm starts against the plain
    reference solver at f64."""
    prob = Problem("cartpole_mlp", "cpu")
    for k in ("params", "q", "p"):
        setattr(prob, k, getattr(prob, k).double())
    gen = torch.Generator().manual_seed(5)
    B = 16
    x0 = prob.start(gen, B).double()
    u0 = 0.3 * torch.randn(B, prob.T, prob.nu, generator=gen, dtype=torch.float64)
    ref = prob.solve_reference(x0, u0, tile=B)
    mpc, dyn, cost = prob.program()
    res = mpc.solve(x0, cost, dyn, params=prob.params, u_init=u0)
    rel = ((ref.costs - res.costs).abs() / ref.costs.abs().clamp(min=1.0)).max()
    assert rel < 1e-9, rel
    assert (ref.u.transpose(0, 1) - res.u).abs().max() < 1e-6


@pytest.mark.parametrize("form", ["pytree", "flat"])
def test_the_port_admits_the_model_past_jax_limit(form):
    """The kernel's gate takes the 1,205 weights as the pytree of init_params
    (flattened by kernel_params past flat_params' JAX limit, which still
    gives None) or flat; a CPU solve runs the plain loop and is counted."""
    dyn = cartpole_mlp.make()
    ws = cartpole_mlp.init_params(SEED)
    params = ws if form == "pytree" else cartpole_mlp.flat_init_params(SEED)
    assert nn_dynamics.flat_params(ws) is None
    assert nn_dynamics.weight_limit(dyn.device_mlp) == nn_dynamics.MAX_STREAMED_PARAMS
    kp = tilqr.kernel_params(dyn, params)
    assert torch.equal(kp, cartpole_mlp.flat_init_params(SEED))
    cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20)
    q = torch.ones(6)
    assert fused.covered(cfg, dyn, kp, torch.float32, (torch.diag(q), torch.zeros(6)), None,
                         None, -100.0, 100.0)
    assert fused.mlp_hand(dyn.device_mlp)
    x0 = torch.zeros(4, 5)
    x0[:, 2] = -1.0
    before = (tilqr.PLAIN_SOLVES, fused.LAUNCHES)
    res = P.MPC(5, 1, 20, u_lower=-100.0, u_upper=100.0, lqr_iter=2, backprop=False,
                exit_unconverged=False).solve(x0, P.QuadCost(torch.diag(q), torch.zeros(6)),
                                              dyn, params=params)
    assert torch.isfinite(res.costs).all()
    assert (tilqr.PLAIN_SOLVES, fused.LAUNCHES) == (before[0] + 1, before[1])


def test_a_deeper_net_keeps_jax_limit():
    """Two hidden layers past 256 weights: each earlier hidden layer is an
    array per thread, so the port keeps JAX's limit there."""
    dyn = nn_dynamics.make(5, 1, hidden_sizes=(16, 16))
    ws = nn_dynamics.init_params(5, 1, (16, 16), generator=torch.Generator().manual_seed(0))
    assert dyn.device_mlp.n_weights > nn_dynamics.MAX_PYTREE_PARAMS
    assert nn_dynamics.weight_limit(dyn.device_mlp) == nn_dynamics.MAX_PYTREE_PARAMS
    kp = tilqr.kernel_params(dyn, ws)
    assert kp is ws and dyn.jac_lanes is None and not fused.mlp_hand(dyn.device_mlp)
    flat = torch.cat([a.reshape(-1) for layer in ws for a in layer])
    assert not fused.covered(P.ILQRConfig(n_state=5, n_ctrl=1, T=20), dyn, flat, torch.float32,
                             (torch.eye(6), torch.zeros(6)), None, None, -1.0, 1.0)


def test_plain_version_takes_the_hand_jacobian():
    """The kernel's plain version (ilqr_fused_reference, the CPU dispatch)
    linearizes the model by jac_lanes under either method, as the library's
    Mlp::jac does: the step has no clamp, so one library serves ANALYTIC
    and AUTO_DIFF, and the two solves give the same bits. jac_lanes is the
    jvp sweep of the kernel step (the Jacobian a deeper net's JvpJac forms)
    at f64 to 1e-12, and one solve under each agrees after one iteration on
    one tile (f32: costs rtol 1e-5)."""
    dyn = cartpole_mlp.make()
    p = cartpole_mlp.flat_init_params(SEED)
    for method in (P.GradMethod.ANALYTIC, P.GradMethod.AUTO_DIFF):
        assert fused._jacobian(method, dyn) is dyn.jac_lanes
    prob = Problem("cartpole_mlp", "cpu")
    x0 = prob.start(torch.Generator().manual_seed(7), 16)
    u = torch.randn(16, 1, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    p64 = p.double()
    torch.testing.assert_close(dyn.jac_lanes(x0.double(), u, p64),
                               fused.jvp_jacobian(dyn.kernel_step)(x0.double(), u, p64),
                               rtol=0, atol=1e-12)
    out = {}
    for method in (P.GradMethod.ANALYTIC, P.GradMethod.AUTO_DIFF):
        cfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=1, grad_method=method,
                           linesearch_decay=0.5, max_linesearch_iter=2, backprop=False)
        out[method] = fused.ilqr_fused_reference(cfg, dyn, p, x0, (torch.diag(prob.q), prob.p),
                                                 None, -100.0, 100.0)
    a, b = out[P.GradMethod.ANALYTIC], out[P.GradMethod.AUTO_DIFF]
    assert torch.isfinite(a[2]).all()
    torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=1e-5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_config_weights_regenerate_from_their_seed():
    """cartpole_mlp.json's 1,205 weights are flat_init_params(params_seed),
    float32 bit for bit, in flat_params' order."""
    path = os.path.join(spec.HERE, "configs", "cartpole_mlp.json")
    with open(path) as f:
        cfg = json.load(f)
    got = torch.tensor(cfg["params"], dtype=torch.float32)
    want = cartpole_mlp.flat_init_params(cfg["params_seed"])
    assert got.shape == (cartpole_mlp.N_WEIGHTS,) == (1205,)
    assert torch.equal(got, want)
    assert cfg["hidden_sizes"] == list(cartpole_mlp.HIDDEN)
    assert cfg["activation"] == cartpole_mlp.ACTIVATION and cfg["passthrough"] is True

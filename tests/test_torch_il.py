"""The port's imitation-learning harness: populate_data2 against the
reference's golden, RMSprop and Adam against optax's, one ILExp.train_step
against the JAX package's at f64 (imempc learning the cost and the
dynamics, sysid, and nn), the LSTM policy against JAX's with JAX's weights
carried across, a one-epoch ILExp.run on the shipped pendulum dataset and
a two-epoch mode-'nn' run, all on the CPU (device="cpu").

Tolerances: the golden keeps the JAX test's bars (tests/test_il.py:103-132);
1e-12 for the optimizers (the same arithmetic at f64); rtol 1e-6 for the
MPC train step at f64 (the same solve and IFT backward, summation order
aside). The LSTM policy: outputs within 1e-12 and gradients within 1e-10
of their largest entry at f64, 1e-5 and 1e-4 at f32 (the same products of
width 256, summed in another order, over 5 steps). The mode-'nn' step at
f64: loss within 1e-12 relative, new parameters within 1e-12, Adam's first
moments (a tenth of the gradient) within 1e-10 of their largest entry.
The gradients of the JAX MPC step are read from its optimizer state: from
a zero state optax's RMSprop keeps nu = (1 - decay) g^2, and the update has
the sign of -g."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dilqr_tpu.il.env import ILEnv as JILEnv
from dilqr_tpu.il.exp import ILExp as JILExp
from dilqr_tpu.il.lstm import LSTMPolicy as JLSTMPolicy
from dilqr_tpu_torch.il.env import ILEnv, sample_xinit
from dilqr_tpu_torch.il.exp import ILExp
from dilqr_tpu_torch.il.lstm import LSTMPolicy, jax_state_dict
from dilqr_tpu_torch.utils import checkpoint
from dilqr_tpu_torch.utils.optim import adam_init, adam_update, rmsprop_init, rmsprop_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def test_populate_data2_golden(golden):
    """Receding-horizon expert against the reference at f64, initial states
    injected: 1e-4 overall, the first five closed-loop steps to 1e-12."""
    g = golden("populate_data2_pendulum_f64")
    tau_ref = np.concatenate([g["train"], g["val"], g["test"]], 0)
    env = ILEnv(env="pendulum", mpc_T=10, lqr_iter=10, qp_solver="pnqp", device="cpu",
                dtype=F64)
    env.populate_data2(n_train=2, n_val=1, n_test=1, xinit=tau_ref[:, 0, :3])
    tau = np.concatenate([env.train_data, env.val_data, env.test_data], 0)
    np.testing.assert_allclose(tau, tau_ref, atol=1e-4)
    np.testing.assert_allclose(tau[:, :5], tau_ref[:, :5], atol=1e-12)


def test_populate_data_and_sample_xinit():
    env = ILEnv(env="cartpole", mpc_T=5, lqr_iter=3, device="cpu")
    x = sample_xinit(torch.Generator().manual_seed(0), "cartpole", 3)
    assert torch.equal(x[0], x[2])  # the reference's deterministic start
    env.populate_data(n_train=3, n_val=1, n_test=1, seed=0)
    assert env.train_data.shape == (3, 5, 6) and np.isfinite(env.train_data).all()
    assert np.abs(env.train_data[..., -1]).max() <= 100.0
    with pytest.raises(ValueError):
        ILEnv(env="rocket", device="cpu")


def test_rmsprop_matches_optax():
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(4), "b": rng.randn(2, 3)}
    grads = [{k: rng.randn(*v.shape) for k, v in p0.items()} for _ in range(5)]
    opt = optax.rmsprop(1e-2, decay=0.5)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    ts = rmsprop_init(tp)
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = rmsprop_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                                lr=1e-2, decay=0.5)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-12)


def _batch(B, T, seed):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.5, 0.5, B)
    x0 = np.stack([np.cos(th), np.sin(th), rng.uniform(-0.5, 0.5, B)], 1)
    xs = np.repeat(x0[:, None], T, 1) + 0.01 * rng.randn(B, T, 3)
    xs[:, 0] = x0
    return (x0, xs, 0.3 * rng.randn(B, T, 1), 0.1 * rng.randn(B, T, 1),
            {"q_logit": rng.randn(4), "p_hat": 0.3 * rng.randn(4),
             "dx": np.array([12.0, 2.0, 0.8])})


def _jax_grads_from_step(params0, new_params, opt_state):
    """g = -sign(update) sqrt(nu / (1 - decay)) from a zero RMSprop state."""
    nu = opt_state[0].nu
    return {k: -np.sign(np.asarray(new_params[k]) - params0[k])
            * np.sqrt(np.asarray(nu[k]) / 0.5) for k in params0}


@pytest.mark.parametrize("mode", ["imempc", "sysid"])
def test_train_step_matches_jax_f64(mode, tmp_path):
    T, B = 6, 4
    x0, xs, us, ws, params0 = _batch(B, T, seed=1)
    kw = dict(learn_cost=True, learn_dx=True) if mode == "imempc" else {}
    jenv = JILEnv(env="pendulum", mpc_T=T, lqr_iter=20)
    jexp = JILExp(env=jenv, mode=mode, work=str(tmp_path / "jax"), **kw)
    params0 = {k: v for k, v in params0.items() if k in jexp.params}
    tenv = ILEnv(env="pendulum", mpc_T=T, lqr_iter=20, device="cpu", dtype=F64)
    # the JAX env keeps its true cost and params in f32: give the port the
    # same values
    tenv.true_q = torch.from_numpy(np.asarray(jenv.true_q, np.float64))
    tenv.true_p = torch.from_numpy(np.asarray(jenv.true_p, np.float64))
    texp = ILExp(env=tenv, mode=mode, work=str(tmp_path / "port"), **kw)
    batch_j = [jnp.asarray(a) for a in (x0, xs, us, ws)]
    batch_t = [torch.from_numpy(a) for a in (x0, xs, us, ws)]
    tparams = {k: torch.from_numpy(v) for k, v in params0.items()}
    # update_q alternates which of q / p moves: run both from the same start
    for update_q in ([True, False] if mode == "imempc" else [True]):
        jp0 = {k: jnp.asarray(v) for k, v in params0.items()}
        jnew, jstate, jloss, jws = jexp.train_step(jp0, jexp.opt.init(jp0), *batch_j,
                                                   jnp.asarray(update_q))
        tnew, tstate, tloss, tws = texp.train_step(tparams, rmsprop_init(tparams), *batch_t,
                                                   update_q)
        for k in jloss:
            np.testing.assert_allclose(float(tloss[k]), float(jloss[k]), rtol=1e-6)
        np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=1e-6, atol=1e-6)
        jg = _jax_grads_from_step(params0, jnew, jstate)
        tg = {k: np.sqrt(tstate[k].numpy() / 0.5) * -np.sign(tnew[k].numpy() - params0[k])
              for k in params0}
        for k in params0:
            scale = max(1e-3, np.abs(jg[k]).max())
            np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-6 * scale, err_msg=k)
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
    # the port's grads() is what its step applies
    g, _, _ = texp.grads(tparams, *batch_t)
    assert set(g) == set(params0) and all(torch.isfinite(v).all() for v in g.values())


def test_run_one_epoch_on_shipped_data(tmp_path):
    d = np.load(os.path.join(REPO, "data", "pendulum.npz"))
    # lqr_iter 30: enough for these swing-ups to converge, so that their
    # gradients are not detached
    env = ILEnv(env="pendulum", mpc_T=int(d["mpc_T"]), lqr_iter=30, device="cpu")
    env.train_data, env.val_data, env.test_data = d["train"][:8], d["val"][:8], d["test"][:8]
    exp = ILExp(env=env, mode="imempc", learn_cost=True, learn_dx=True, n_batch=4,
                n_epoch=1, n_train=8, work=str(tmp_path))
    p0 = {k: v.clone() for k, v in exp.params.items()}
    best = exp.run(verbose=False)
    assert np.isfinite(best)
    for name in ("train_losses.csv", "val_test_losses.csv", "dx_hist.csv", "cost_hist.csv",
                 "best.ckpt"):
        assert os.path.exists(os.path.join(exp.save, name)), name
    with open(os.path.join(exp.save, "train_losses.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 2  # header, two batches
    assert any(not torch.equal(p0[k], exp.params[k]) for k in p0)
    state = checkpoint.load(os.path.join(exp.save, "best.ckpt"))
    assert state["epoch"] == 0 and state["warmstart"]["val"].shape == (8, 20, 1)
    exp.params = p0
    exp.restore()
    assert torch.equal(exp.params["dx"], state["params"]["dx"])


def test_from_cli_and_mode_nn(tmp_path):
    """The CLI, and mode 'nn': the LSTM policy at the reference width with
    Adam's state, from the CLI too."""
    data = os.path.join(REPO, "data", "pendulum.npz")
    exp = ILExp.from_cli(["--mode", "sysid", "--env", "pendulum", "--data", data,
                          "--n_train", "4", "--n_epoch", "1", "--mpc_T", "6",
                          "--work", str(tmp_path)], device="cpu")
    assert exp.env.mpc_T == 20 and exp.env.train_data.shape[1] == 20
    assert exp.env.device.type == "cpu" and exp.params["dx"].device.type == "cpu"
    with pytest.raises(SystemExit, match="generated for env"):
        ILExp.from_cli(["--env", "cartpole", "--data", data], device="cpu")
    nn_exp = ILExp(env=exp.env, mode="nn", work=str(tmp_path))
    assert nn_exp.lstm.n_hidden == 256 and nn_exp.lstm.T == 20
    assert set(nn_exp.params) == {k for k, _ in nn_exp.lstm.named_parameters()}
    assert nn_exp.opt_state["count"] == 0 and set(nn_exp.opt_state["mu"]) == set(nn_exp.params)
    cli = ILExp.from_cli(["--mode", "nn", "--env", "pendulum", "--data", data,
                          "--work", str(tmp_path)], device="cpu")
    assert cli.mode == "nn" and "nn" in cli.save
    with pytest.raises(ValueError, match="mode"):
        ILExp(env=exp.env, mode="lstm", work=str(tmp_path))
    # no silent CPU default: the env runs on the card unless told otherwise
    assert ILEnv.__dataclass_fields__["device"].default == "cuda"


def test_adam_matches_optax():
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(4), "b": rng.randn(2, 3)}
    grads = [{k: rng.randn(*v.shape) for k, v in p0.items()} for _ in range(5)]
    grads[2]["a"][1] = 0.0  # a zero gradient meets eps
    opt = optax.adam(1e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    ts = adam_init(tp)
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = adam_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert ts["count"] == int(js[0].count) == 5
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js[0].mu[k]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js[0].nu[k]), rtol=0,
                                   atol=1e-12)


def _rel(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(1e-30, np.abs(want).max())
    assert err <= tol, f"{name}: rel err {err:.2e}"


@pytest.mark.parametrize("dtype,out_tol,grad_tol", [("float64", 1e-12, 1e-10),
                                                     ("float32", 1e-5, 1e-4)])
def test_lstm_policy_matches_jax(dtype, out_tol, grad_tol):
    """JAX's weights (width 256) carried across by jax_state_dict: the
    controls [B, T, n_ctrl] and the gradients of a weighted sum of them
    with respect to every parameter."""
    B, T, ns, nc = 3, 5, 3, 1
    jpol = JLSTMPolicy(n_state=ns, n_ctrl=nc, T=T)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                     jpol.init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    x, w = rng.randn(B, ns).astype(dtype), rng.randn(B, T, nc).astype(dtype)
    want_u = jax.jit(jpol.apply)(jparams, jnp.asarray(x))
    want_g = jax.jit(jax.grad(lambda p: jnp.sum(jpol.apply(p, jnp.asarray(x)) * w)))(jparams)

    tdt = getattr(torch, dtype)
    pol = LSTMPolicy(ns, nc, T, dtype=tdt)
    sd = jax_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(sd) == set(pol.state_dict())
    pol.load_state_dict(sd)
    u = pol(torch.from_numpy(x))
    assert u.shape == (B, T, nc) and u.dtype == tdt
    _rel(u.detach().numpy(), want_u, out_tol, "u")
    (u * torch.from_numpy(w)).sum().backward()
    got_g = jax_state_dict(jax.tree_util.tree_map(np.asarray, want_g))
    for name, p in pol.named_parameters():
        _rel(p.grad.numpy(), got_g[name].numpy(), grad_tol, name)


def test_lstm_policy_init():
    """Every weight and bias uniform in +-1/sqrt(fan_in) (the cell's from
    its hidden width), drawn from the given generator alone."""
    state = torch.random.get_rng_state()
    a = LSTMPolicy(3, 1, 4, generator=torch.Generator().manual_seed(3))
    b = LSTMPolicy(3, 1, 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(state, torch.random.get_rng_state())
    fan_in = {"state_emb.0": 3, "ctrl_emb.0": 1}
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        bound = 1.0 / fan_in.get(name.rsplit(".", 1)[0], 256) ** 0.5
        assert p.abs().max() <= bound, name
        if p.numel() >= 64:  # and fills its range
            assert p.abs().max() > 0.9 * bound and p.min() < -0.9 * bound, name
    assert a.cell.weight_ih.shape == (4 * 256, 256)


def test_nn_train_step_matches_jax_f64(tmp_path):
    """One Adam step of mode 'nn' from JAX's initial weights at f64: the
    loss, the new parameters and Adam's first moments (a tenth of the
    gradient)."""
    T, B = 6, 4
    x0, xs, us, _, _ = _batch(B, T, seed=2)
    jenv = JILEnv(env="pendulum", mpc_T=T, lqr_iter=5)
    jexp = JILExp(env=jenv, mode="nn", work=str(tmp_path / "jax"))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jexp.params)
    step = jax.jit(jexp.train_step)
    jnew, jstate, jloss, jws = step(jp, jexp.opt.init(jp), jnp.asarray(x0), jnp.asarray(xs),
                                    jnp.asarray(us), None, jnp.asarray(False))
    assert jws is None
    tenv = ILEnv(env="pendulum", mpc_T=T, lqr_iter=5, device="cpu", dtype=F64)
    texp = ILExp(env=tenv, mode="nn", work=str(tmp_path / "port"))
    assert texp.params["cell.weight_ih"].dtype == F64
    params = jax_state_dict(jax.tree_util.tree_map(np.asarray, jp["nn"]))
    tnew, tstate, tloss, tws = texp.train_step(params, adam_init(params), *(
        torch.from_numpy(a) for a in (x0, xs, us)), None, False)
    assert tws is None and tstate["count"] == 1
    np.testing.assert_allclose(float(tloss["im_loss"]), float(jloss["im_loss"]), rtol=1e-12)
    want_new = jax_state_dict(jax.tree_util.tree_map(np.asarray, jnew["nn"]))
    want_mu = jax_state_dict(jax.tree_util.tree_map(np.asarray, jstate[0].mu["nn"]))
    for name in params:
        np.testing.assert_allclose(tnew[name].numpy(), want_new[name].numpy(), rtol=0,
                                   atol=1e-12, err_msg=name)
        _rel(tstate["mu"][name].numpy(), want_mu[name].numpy(), 1e-10, name)
        assert not torch.equal(tnew[name], params[name]), name


def test_nn_run_two_epochs_on_shipped_data(tmp_path):
    """Mode 'nn' for two epochs on the shipped pendulum dataset: finite
    losses, the CSV of every step and the validation rows, a checkpoint
    that restores, and the parameters moved."""
    d = np.load(os.path.join(REPO, "data", "pendulum.npz"))
    env = ILEnv(env="pendulum", mpc_T=int(d["mpc_T"]), device="cpu")
    env.train_data, env.val_data, env.test_data = d["train"][:8], d["val"][:8], d["test"][:8]
    exp = ILExp(env=env, mode="nn", n_batch=4, n_epoch=2, n_train=8, work=str(tmp_path))
    p0 = {k: v.clone() for k, v in exp.params.items()}
    best = exp.run(verbose=False)
    assert np.isfinite(best)
    for name in ("train_losses.csv", "val_test_losses.csv", "best.ckpt"):
        assert os.path.exists(os.path.join(exp.save, name)), name
    for name in ("dx_hist.csv", "cost_hist.csv"):
        assert not os.path.exists(os.path.join(exp.save, name)), name
    with open(os.path.join(exp.save, "train_losses.csv")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "epoch,im_loss" and len(lines) == 1 + 2 * 2
    assert all(np.isfinite(float(v)) for ln in lines[1:] for v in ln.split(","))
    with open(os.path.join(exp.save, "val_test_losses.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 2
    assert all(not torch.equal(p0[k], exp.params[k]) for k in p0)
    state = checkpoint.load(os.path.join(exp.save, "best.ckpt"))
    assert state["opt_state"]["count"] in (2, 4)
    exp.params = p0
    exp.restore()
    assert torch.equal(exp.params["decode.4.bias"], state["params"]["decode.4.bias"])

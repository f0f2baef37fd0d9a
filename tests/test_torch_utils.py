"""The port's utilities against the JAX package's: table_log's text and the
solver's verbose table, numdiff's central differences, and the profiling
helpers (the busy time as a union of intervals, timeit, a trace file with
the solve path's spans), on the CPU.

Tolerances: the table text is compared character for character; the
verbose solve's numbers (printed to 5 significant digits) within 5e-4
relative; numdiff at f64 within 1e-9 of JAX's (the same differences of the
same function, rounding aside) and within 1e-6 of the exact derivative
(central differences at eps 1e-4 on order-one functions)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.utils import logging as jlog
from dilqr_tpu.utils import numdiff as jnd
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.utils import logging as tlog
from dilqr_tpu_torch.utils import numdiff as tnd
from dilqr_tpu_torch.utils import profiling as tprof


@pytest.fixture
def fresh_tables():
    """Both packages print a table's header once per tag and process: let
    each test start with no table seen, and leave none behind."""
    saved = (set(jlog._seen_tables), set(tlog._seen_tables))
    jlog._seen_tables.clear()
    tlog._seen_tables.clear()
    yield
    for mod, s in zip((jlog, tlog), saved):
        mod._seen_tables.clear()
        mod._seen_tables.update(s)


def test_table_log_text_matches_jax(capsys, fresh_tables):
    rows = [[("epoch", 0), ("loss", 0.123456789, "{:.4e}"), ("name", "a")],
            [("epoch", 1), ("loss", -2.5e-7, "{:.4e}"), ("name", "bb")]]
    for tag in ("t1", "t2"):
        for r in rows:
            jlog.table_log(tag, r)
    want = capsys.readouterr().out
    for tag in ("t1", "t2"):
        for r in rows:
            tlog.table_log(tag, r)
    got = capsys.readouterr().out
    assert got == want
    assert got.count("| epoch | loss | name |") == 2 and len(got.splitlines()) == 6
    with pytest.raises(ValueError):
        tlog.table_log("t3", [("only a name",)])


def _parse(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("|")]
    return lines[0], [[float(v) for v in ln.strip("| ").split(" | ")] for ln in lines[1:]]


def test_verbose_solve_prints_jax_table(capsys, fresh_tables):
    """verbose=1: one header, then one row per iteration with JAX's keys,
    their order (jax.debug.callback sorts them) and format, and JAX's
    numbers (pendulum, f64, unboxed)."""
    B, T = 3, 6
    rng = np.random.RandomState(0)
    th = rng.uniform(-1.5, 1.5, B)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    q, p = (np.asarray(a, np.float64) for a in jpend.get_true_obj())
    params = np.asarray(jpend.default_params(), np.float64)
    kw = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0, verbose=1, backprop=False,
              exit_unconverged=False)
    J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
            J.QuadCost(jnp.asarray(np.diag(q)), jnp.asarray(p)), jpend.make(),
            params=jnp.asarray(params))
    jax.effects_barrier()
    jhead, jrows = _parse(capsys.readouterr().out)
    res = P.solve(P.ILQRConfig(**kw), from_numpy(x0),
                  P.QuadCost(from_numpy(np.diag(q)), from_numpy(p)), tpend.make(),
                  params=from_numpy(params))
    out = capsys.readouterr().out
    head, rows = _parse(out)
    assert head == jhead == "| du_max | iter | mean_alpha | mean_cost |"
    assert len(rows) == int(res.n_iter) == len(jrows) == 4
    assert [r[1] for r in rows] == [0.0, 1.0, 2.0, 3.0]
    assert out.splitlines()[1].split(" | ")[1] == "0.0000e+00"
    np.testing.assert_allclose(np.array(rows), np.array(jrows), rtol=5e-4, atol=0)
    # a second solve prints rows only
    P.solve(P.ILQRConfig(**kw), from_numpy(x0), P.QuadCost(from_numpy(np.diag(q)),
                                                            from_numpy(p)),
            tpend.make(), params=from_numpy(params))
    assert "iter" not in capsys.readouterr().out


def test_numdiff_matches_jax_f64():
    x = np.random.RandomState(0).randn(4, 3)

    def jfn(v):
        return jnp.sum(jnp.sin(v) * v ** 2, -1) + v[..., 0] * v[..., 1] ** 3

    def tfn(v):
        return (torch.sin(v) * v ** 2).sum(-1) + v[..., 0] * v[..., 1] ** 3

    tx = from_numpy(x)
    g, H = tnd.grad(tfn, tx), tnd.hess(tfn, tx)
    assert g.shape == (4, 3) and H.shape == (4, 3, 3)
    np.testing.assert_allclose(g.numpy(), np.asarray(jnd.grad(jfn, jnp.asarray(x))),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(H.numpy(), np.asarray(jnd.hess(jfn, jnp.asarray(x))),
                               rtol=0, atol=1e-9)
    assert torch.equal(H, H.transpose(-1, -2))
    # against the exact derivatives
    exact_g = torch.func.vmap(torch.func.grad(tfn))(tx)
    exact_H = torch.func.vmap(torch.func.hessian(tfn))(tx)
    torch.testing.assert_close(g, exact_g, rtol=0, atol=1e-6)
    torch.testing.assert_close(H, exact_H, rtol=0, atol=1e-6)


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, start, end):
        self.time_range = _Range(start, end)


def test_busy_ms_is_the_union_of_intervals():
    """Overlapping, nested, touching and disjoint intervals (microseconds):
    the union, not the sum of durations."""
    ev = [_Event(a, b) for a, b in ((0, 10), (5, 15), (6, 8), (15, 20), (30, 31), (29, 30))]
    assert tprof.busy_ms(ev) == pytest.approx((20 + 2) / 1e3)
    assert tprof.busy_ms([]) == 0.0
    assert tprof.busy_ms([_Event(3, 3)]) == 0.0


def test_timeit_and_reports_on_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    x = torch.ones(8)
    dt = tprof.timeit(fn, x, n=5, warmup=2)
    assert dt > 0 and len(calls) == 7
    # the chrome trace holds the solve path's spans beside its operators
    th = torch.tensor([0.3, -0.4])
    x0 = torch.stack([th.cos(), th.sin(), torch.zeros(2)], 1)
    q, p = tpend.get_true_obj()
    mpc = P.MPC(3, 1, 4, u_lower=-2.0, u_upper=2.0, lqr_iter=2, exit_unconverged=False,
                backprop=False)
    with tprof.trace(str(tmp_path / "tr")):
        fn(x)
        mpc.solve(x0, P.QuadCost(torch.diag(q), p), tpend.make(), params=tpend.default_params())
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dilqr.solve", "dilqr.solve.canonicalize", "dilqr.ilqr.gate"} <= names

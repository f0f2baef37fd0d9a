"""System identification through the differentiable MPC solver -- the
DiLQR paper's headline use case (reference il_exp.py --mode sysid/imempc
--learn_dx); the port of examples/sysid_pendulum.py.

An expert controls the pendulum with the TRUE physics (g, m, l) =
(10, 1, 1); the learner starts from the reference's mis-specified init
(15, 3, 0.5) (il_exp.py:136-142) and recovers the true parameters by
differentiating the imitation loss THROUGH the iLQR fixed point
(BackwardMode.IFT).

    python -m dilqr_tpu_torch.examples.sysid_pendulum [--epochs 300]
        [--mode imempc|sysid] [--n-train 128] [--work DIR] [--device cpu]

--work defaults to dilqr_sysid under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..il.env import ILEnv
from ..il.exp import ILExp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--mode", default="sysid", choices=["imempc", "sysid"])
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "dilqr_sysid"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    env = ILEnv(env="pendulum", mpc_T=20, lqr_iter=10, device=args.device)
    print("generating expert demonstrations (batched true-physics MPC)...")
    env.populate_data(n_train=args.n_train, n_val=32, n_test=32, seed=0)

    exp = ILExp(env=env, mode=args.mode, learn_dx=True, n_batch=min(64, args.n_train),
                n_epoch=args.epochs, n_train=args.n_train, work=args.work)
    true = env.true_params.cpu().numpy().astype(np.float64)
    start = exp.params["dx"].cpu().numpy().astype(np.float64)
    print(f"true params (g, m, l): {true}")
    print(f"init params           : {start}  "
          f"(reference's mis-specified init, il_exp.py:136-142)")

    t0 = time.perf_counter()
    best_val = exp.run(verbose=False)
    dt = time.perf_counter() - t0

    learned = exp.params["dx"].cpu().numpy().astype(np.float64)

    # the pendulum dynamics theta_dd = 1.5 g/l sin(theta) + 3 u/(m l^2)
    # only identify the combinations (g/l, m l^2); raw (g, m, l) lie on an
    # unidentifiable manifold, so convergence is judged on the combinations
    def combos(p):
        return np.array([p[0] / p[2], p[1] * p[2] ** 2])

    c_true, c0, c1 = combos(true), combos(start), combos(learned)
    print(f"\nlearned params        : {learned}")
    print(f"identifiable (g/l, m l^2): true {c_true}, init {c0}, learned {c1}")
    e0 = np.abs(c0 - c_true) / c_true
    e1 = np.abs(c1 - c_true) / c_true
    print(f"rel err on identifiable combos: {e0} -> {e1}")
    print(f"best val imitation loss: {best_val:.5f}")
    print(f"{args.epochs} epochs in {dt:.1f}s (CSV logs + best checkpoint in {exp.save})")
    ok = bool(e1.max() < 0.1)
    print("OK: physics recovered through the differentiable solver" if ok else
          "sysid did not converge on identifiable combos")
    return {"learned": learned.tolist(), "rel_err_init": e0.tolist(),
            "rel_err": e1.tolist(), "best_val": float(best_val), "seconds": dt, "ok": ok}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)

"""Imitation-learning / system-identification trainer (counterpart of
``dilqr_tpu/il/exp.py``):

 * modes 'nn' (LSTM behavioral cloning, il/lstm.py, with the reference's
   decode-from-cell-state quirk), 'empc' / 'imempc' (imitation through
   the differentiable MPC) and 'sysid' (next-state prediction loss);
 * learnable cost q = sigmoid(q_logit), p = sqrt(q) * p_hat, with
   round-robin q/p updates every 10 epochs;
 * learnable dynamics params from the reference's mis-specified inits;
 * RMSprop(lr=1e-2, decay=0.5) with eps inside the square root, and
   Adam(1e-4) in mode 'nn' (utils/optim.py, optax's rules);
 * a per-example warm-start store, reset every 50 epochs;
 * CSV logs (train_losses.csv, val_test_losses.csv, dx_hist.csv,
   cost_hist.csv) and best-validation checkpointing (utils/checkpoint.py).

The trainer runs on its env's device (ILEnv.device, default "cuda"); its
parameters are a dict of tensors (in mode 'nn' the policy's parameters by
name, applied with ``torch.func.functional_call``) and one step is
functional: train_step returns new parameters and optimizer state.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..utils import checkpoint as ckpt
from ..utils.optim import adam_init, adam_update, rmsprop_init, rmsprop_update
from .env import ILEnv
from .lstm import LSTMPolicy

RESTART_WARMSTART_EVERY = 50  # il_exp.py:86
COST_ROUND_ROBIN = 10  # il_exp.py:290


def _dx_init_params(env_name: str, seed: int):
    """Mis-specified dynamics inits (il_exp.py:136-149), as float64 numpy."""
    if env_name == "pendulum":
        return np.array([15.0, 3.0, 0.5])
    if env_name == "cartpole":
        return np.array([9.8, 3.0, 0.1, 1.0])
    if env_name == "pendulum-complex":
        rng = np.random.RandomState(seed)
        return np.array([5.0, 1.0, 1.0]) + np.array([3.0, 1.0, 1.0]) * (rng.rand(3) - 0.5)
    raise ValueError(env_name)


def _row(t: torch.Tensor):
    return ",".join(map(str, t.detach().cpu().numpy().tolist()))


@dataclasses.dataclass
class ILExp:
    env: ILEnv
    mode: str = "sysid"  # nn | empc | imempc | sysid
    learn_cost: bool = False
    learn_dx: bool = False
    n_batch: int = 32
    n_epoch: int = 1000
    n_train: int = 100
    seed: int = 5
    work: str = "./work"
    save: Optional[str] = None

    def __post_init__(self):
        if self.mode not in ("nn", "empc", "imempc", "sysid"):
            raise ValueError(f"mode must be nn, empc, imempc or sysid, got {self.mode!r}")
        if self.mode in ("empc", "imempc") and not (self.learn_cost or self.learn_dx):
            raise ValueError(f"mode {self.mode!r} needs learn_cost or learn_dx")
        if self.mode == "sysid":
            self.learn_dx = True
        env_name = self.env.env
        tag = f"il.{env_name}.{self.mode}.n_train={self.n_train}"
        if self.learn_cost:
            tag += ".learn_cost"
        if self.learn_dx:
            tag += ".learn_dx"
        self.save = self.save or os.path.join(self.work, tag, str(self.seed))
        os.makedirs(self.save, exist_ok=True)

        dx = self.env.true_dx
        self.n_state, self.n_ctrl, self.T = dx.n_state, dx.n_ctrl, self.env.mpc_T
        self.params: Dict[str, torch.Tensor] = {}
        if self.mode == "nn":
            self.lstm = LSTMPolicy(self.n_state, self.n_ctrl, self.T,
                                   generator=torch.Generator().manual_seed(self.seed),
                                   device=self.env.device, dtype=self.env.dtype)
            self.params = {k: v.detach() for k, v in self.lstm.named_parameters()}
            self.opt_state = adam_init(self.params)
            return
        if self.learn_cost:
            self.params["q_logit"] = torch.zeros_like(self.env.true_q)
            self.params["p_hat"] = torch.zeros_like(self.env.true_p)
        if self.learn_dx:
            self.params["dx"] = self.env.tensor(_dx_init_params(env_name, self.seed))
        self.opt_state = rmsprop_init(self.params)

    # -- pieces --------------------------------------------------------------
    def _cost_qp(self, params):
        """(q, p) from the learnables (il_exp.py:330-334)."""
        if self.learn_cost:
            q = torch.sigmoid(params["q_logit"])
            return q, torch.sqrt(q) * params["p_hat"]
        return self.env.true_q, self.env.true_p

    def _dx_params(self, params):
        return params["dx"] if self.learn_dx else self.env.true_params

    def _losses(self, params, xinits, xs, us, warmstart):
        """im_loss (il_exp.py:346) and sysid_loss (il_exp.py:348-357); also
        returns the new warm-start controls (None in mode 'nn')."""
        if self.mode == "nn":
            pred_u = torch.func.functional_call(self.lstm, params, (xinits,))
            return {"im_loss": ((us - pred_u) ** 2).mean()}, None
        q, p = self._cost_qp(params)
        dxp = self._dx_params(params)
        _, nom_u = self.env.mpc(dxp, xinits, q, p, u_init=warmstart)
        out = {"im_loss": ((us - nom_u) ** 2).mean()}
        if self.learn_dx:
            pred_next = self.env.true_dx.step(xs[:, :-1], us[:, :-1], dxp)
            out["sysid_loss"] = ((xs[:, 1:] - pred_next) ** 2).mean()
        return out, nom_u.detach()

    def grads(self, params, xinits, xs, us, warmstart):
        """Gradients of the training loss (sysid_loss in 'sysid', im_loss
        otherwise) with respect to every parameter; returns (grads, losses,
        new warm start)."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        losses, new_ws = self._losses(leaves, xinits, xs, us, warmstart)
        main = losses["sysid_loss"] if self.mode == "sysid" else losses["im_loss"]
        g = torch.autograd.grad(main, list(leaves.values()), allow_unused=True)
        g = {k: torch.zeros_like(v) if gk is None else gk
             for (k, v), gk in zip(leaves.items(), g)}
        return g, {k: v.detach() for k, v in losses.items()}, new_ws

    def train_step(self, params, opt_state, xinits, xs, us, warmstart, update_q: bool):
        """One optimizer step; returns (params, opt_state, losses, new warm
        start)."""
        g, losses, new_ws = self.grads(params, xinits, xs, us, warmstart)
        if self.mode == "nn":
            params, opt_state = adam_update(params, g, opt_state, lr=1e-4)
            return params, opt_state, losses, new_ws
        if self.learn_cost:
            # round-robin: alternate q / p updates (il_exp.py:375-381)
            g["p_hat"] = g["p_hat"] * (0.0 if update_q else 1.0)
            g["q_logit"] = g["q_logit"] * (1.0 if update_q else 0.0)
        params, opt_state = rmsprop_update(params, g, opt_state, lr=1e-2, decay=0.5)
        return params, opt_state, losses, new_ws

    def _split(self, data):
        t = self.env.tensor(data)
        xs, us = t[:, :, :self.n_state], t[:, :, -self.n_ctrl:]
        return xs[:, 0], xs, us

    # -- training loop -------------------------------------------------------
    def run(self, verbose: bool = True):
        env = self.env
        rng = np.random.RandomState(self.seed)
        tr_xinit, tr_xs, tr_us = self._split(np.asarray(env.train_data[:self.n_train]))
        val, test = np.asarray(env.val_data), np.asarray(env.test_data)
        n = tr_xinit.shape[0]
        zeros = lambda m: torch.zeros(m, self.T, self.n_ctrl, dtype=env.dtype,  # noqa: E731
                                      device=env.device)
        ws = {"train": zeros(n), "val": zeros(val.shape[0]), "test": zeros(test.shape[0])}

        train_f = open(os.path.join(self.save, "train_losses.csv"), "w")
        names = ["epoch", "im_loss"] + (["sysid_loss"] if self.learn_dx else [])
        train_f.write(",".join(names) + "\n")
        vt_f = open(os.path.join(self.save, "val_test_losses.csv"), "w")
        vt_f.write("epoch,im_loss_val,im_loss_test\n")
        dx_f = cost_f = None
        if self.learn_dx:
            dx_f = open(os.path.join(self.save, "dx_hist.csv"), "w")
            dx_f.write(_row(env.true_params) + "\n")
        if self.learn_cost:
            cost_f = open(os.path.join(self.save, "cost_hist.csv"), "w")
            cost_f.write(_row(torch.cat([env.true_q, env.true_p])) + "\n")

        best_val = None
        update_q = False
        n_train_batch = max(1, n // self.n_batch)
        for epoch in range(self.n_epoch):
            if epoch > 0 and epoch % COST_ROUND_ROBIN == 0:
                update_q = not update_q
            if self.mode != "nn" and epoch % RESTART_WARMSTART_EVERY == 0:
                ws = {k: torch.zeros_like(v) for k, v in ws.items()}
            perm = rng.permutation(n)
            for j in range(n_train_batch):
                idx = torch.as_tensor(perm[j * self.n_batch:(j + 1) * self.n_batch],
                                      device=env.device)
                self.params, self.opt_state, losses, new_ws = self.train_step(
                    self.params, self.opt_state, tr_xinit[idx], tr_xs[idx], tr_us[idx],
                    ws["train"][idx] if self.mode != "nn" else None, update_q)
                if new_ws is not None:
                    ws["train"][idx] = new_ws
                row = [epoch + j / n_train_batch, float(losses["im_loss"])]
                if self.learn_dx:
                    row.append(float(losses["sysid_loss"]))
                train_f.write(",".join(map(str, row)) + "\n")
                if dx_f is not None:
                    dx_f.write(_row(self.params["dx"]) + "\n")
                if cost_f is not None:
                    q, p = self._cost_qp(self.params)
                    cost_f.write(_row(torch.cat([q, p])) + "\n")
                if verbose:
                    print(f"epoch {row[0]:.2f} losses "
                          f"{ {k: float(v) for k, v in losses.items()} }")

            val_loss, ws["val"] = self.dataset_loss(val, ws["val"])
            test_loss, ws["test"] = self.dataset_loss(test, ws["test"])
            vt_f.write(f"{epoch},{val_loss},{test_loss}\n")
            for f in (train_f, vt_f):
                f.flush()
            if best_val is None or val_loss < best_val:
                best_val = val_loss
                # the warm starts go with the parameters, so that a restore
                # resumes identically (il_exp.py:424-429)
                ckpt.save(os.path.join(self.save, "best.ckpt"),
                          dict(params=self.params, opt_state=self.opt_state, epoch=epoch,
                               val_loss=val_loss, warmstart=ws))
        for f in (train_f, vt_f, dx_f, cost_f):
            if f is not None:
                f.close()
        return best_val

    def restore(self, path: Optional[str] = None):
        """Load a best.ckpt (params and optimizer state onto the env's
        device; the warm starts are returned for the caller's loop)."""
        state = ckpt.load(path or os.path.join(self.save, "best.ckpt"))
        to = lambda d: pytree.tree_map(  # noqa: E731
            lambda v: v.to(self.env.device) if isinstance(v, torch.Tensor) else v, d)
        self.params, self.opt_state = to(state["params"]), to(state["opt_state"])
        return state

    def dataset_loss(self, data, warmstart):
        """Mean imitation loss over a dataset (il_exp.py:442-504); returns
        (loss, the next warm start: the predicted controls, or in mode 'nn'
        the given one)."""
        xinits, _, us = self._split(data)
        if self.mode == "nn":
            with torch.no_grad():
                pred_u = torch.func.functional_call(self.lstm, self.params, (xinits,))
            return float(((us - pred_u) ** 2).mean()), warmstart
        q, p = self._cost_qp(self.params)
        _, pred_u = self.env.mpc(self._dx_params(self.params), xinits, q, p,
                                 u_init=warmstart, backprop=False)
        return float(((us - pred_u) ** 2).mean()), pred_u

    @staticmethod
    def from_cli(argv=None, device: str = "cuda") -> "ILExp":
        """The reference's argparse surface (il_exp.py:40-54). --data loads
        a shipped .npz dataset (data/*.npz) and adopts its horizon; without
        it, --env generates the expert data in-process."""
        import argparse

        ap = argparse.ArgumentParser(description=__doc__)
        ap.add_argument("--env", default="pendulum",
                        choices=["pendulum", "cartpole", "pendulum-complex"])
        ap.add_argument("--data", default=None, help=".npz dataset (data/*.npz)")
        ap.add_argument("--work", default="./work")
        ap.add_argument("--save", default=None)
        ap.add_argument("--n_batch", type=int, default=32)
        ap.add_argument("--mode", default="sysid", choices=["nn", "empc", "imempc", "sysid"])
        ap.add_argument("--learn_cost", action="store_true")
        ap.add_argument("--learn_dx", action="store_true")
        ap.add_argument("--seed", type=int, default=5)
        ap.add_argument("--n_epoch", type=int, default=1000)
        ap.add_argument("--n_train", type=int, default=100)
        ap.add_argument("--mpc_T", type=int, default=20)
        ap.add_argument("--lqr_iter", type=int, default=10)
        ap.add_argument("--device", default=device)
        args = ap.parse_args(argv)

        mpc_T = args.mpc_T
        d = None
        if args.data is not None:
            d = np.load(args.data)
            # a dataset fixes its env and horizon
            if "env" in d and str(d["env"]) != args.env:
                raise SystemExit(f"--data {args.data} was generated for env "
                                 f"'{d['env']}', not '{args.env}'")
            if "mpc_T" in d and int(d["mpc_T"]) != mpc_T:
                print(f"--data horizon mpc_T={int(d['mpc_T'])} overrides --mpc_T {mpc_T} "
                      "(the expert trajectories fix the horizon)")
                mpc_T = int(d["mpc_T"])
        env = ILEnv(env=args.env, mpc_T=mpc_T, lqr_iter=args.lqr_iter, device=args.device)
        if d is not None:
            env.train_data, env.val_data, env.test_data = d["train"], d["val"], d["test"]
        else:
            env.populate_data(n_train=args.n_train, n_val=max(8, args.n_train // 5),
                              n_test=max(8, args.n_train // 5), seed=args.seed)
        return ILExp(env=env, mode=args.mode, learn_cost=args.learn_cost,
                     learn_dx=args.learn_dx, n_batch=args.n_batch, n_epoch=args.n_epoch,
                     n_train=args.n_train, seed=args.seed, work=args.work, save=args.save)


if __name__ == "__main__":
    ILExp.from_cli().run()

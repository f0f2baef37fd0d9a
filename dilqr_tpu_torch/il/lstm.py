"""The LSTM behavioral-cloning policy of the trainer's mode 'nn'
(counterpart of ``dilqr_tpu/il/lstm.py``).

The reference architecture (il_exp.py:97-120): three-layer ReLU MLP state
and control embeddings of width 256, an LSTM cell (gate order i, f, g, o,
as ``nn.LSTMCell``) and a decoder MLP, which reads the control from the
LSTM's *cell* state c rather than its hidden state h (the reference's
quirk, il_exp.py:176). Every weight and bias is drawn uniform in
+-1/sqrt(fan_in) (the LSTM's from its hidden width) from an explicit
generator, as JAX draws them from its key; the values differ from JAX's.
``jax_state_dict`` carries JAX's parameters across.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

N_HIDDEN = 256


def _mlp(sizes, device, dtype) -> nn.Sequential:
    layers = []
    for i, (kin, kout) in enumerate(zip(sizes[:-1], sizes[1:])):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Linear(kin, kout, device=device, dtype=dtype))
    return nn.Sequential(*layers)


class LSTMPolicy(nn.Module):
    """xinits [B, n_state] -> controls [B, T, n_ctrl] (the reference's
    lstm_forward, il_exp.py:168-181)."""

    def __init__(self, n_state: int, n_ctrl: int, T: int, n_hidden: int = N_HIDDEN,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_state, self.n_ctrl, self.T, self.n_hidden = n_state, n_ctrl, T, n_hidden
        h = n_hidden
        # built on the meta device, so that construction draws nothing from
        # torch's global generator; the values come from ``generator`` below
        self.state_emb = _mlp([n_state, h, h, h], "meta", dtype)
        self.ctrl_emb = _mlp([n_ctrl, h, h, h], "meta", dtype)
        self.decode = _mlp([h, h, h, n_ctrl], "meta", dtype)
        self.cell = nn.LSTMCell(h, h, device="meta", dtype=dtype)
        self.to_empty(device=device if device is not None else "cpu")
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.LSTMCell)):
                    fan_in = m.in_features if isinstance(m, nn.Linear) else m.hidden_size
                    for p in m.parameters():
                        r = torch.rand(p.shape, generator=gen, dtype=p.dtype)
                        p.copy_((2.0 * r - 1.0) / math.sqrt(fan_in))

    def forward(self, xinits: torch.Tensor) -> torch.Tensor:
        B = xinits.shape[0]
        y = self.state_emb(xinits)
        h = torch.zeros(B, self.n_hidden, dtype=y.dtype, device=y.device)
        c = torch.zeros_like(h)
        us = []
        for _ in range(self.T):
            h, c = self.cell(y, (h, c))
            u = self.decode(c)  # decode from the cell state
            y = self.ctrl_emb(u)
            us.append(u)
        return torch.stack(us, 1)


def jax_state_dict(params: Dict[str, Any], dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """JAX's ``LSTMPolicy.init_params`` tree, as numpy arrays, -> the port's
    state dict: each MLP's ``[(W (out, in), b), ...]`` becomes its Linear
    layers' weight and bias, and the cell's Wi, Wh, bi, bh become
    weight_ih, weight_hh, bias_ih, bias_hh."""

    def t(a):
        x = torch.from_numpy(np.array(a))
        return x.to(dtype) if dtype is not None else x

    out = {}
    for mlp in ("state_emb", "ctrl_emb", "decode"):
        for i, (W, b) in enumerate(params[mlp]):
            out[f"{mlp}.{2 * i}.weight"], out[f"{mlp}.{2 * i}.bias"] = t(W), t(b)
    for jname, tname in (("Wi", "weight_ih"), ("Wh", "weight_hh"), ("bi", "bias_ih"),
                         ("bh", "bias_hh")):
        out[f"cell.{tname}"] = t(params["cell"][jname])
    return out

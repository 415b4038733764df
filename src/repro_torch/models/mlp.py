"""The paper's MNIST classifier: one hidden layer of 200 ReLU units.

Port of ``repro/models/mlp.py``.  Parameters keep the JAX package's
layout — ``fc*.w`` is (n_in, n_out), applied as ``x @ w + b`` — so a
flat row holds the same numbers in both packages.  ``MLP`` is the
``nn.Module`` (state-dict keys ``fc1.b``, ``fc1.w``, ``fc2.b``,
``fc2.w``); :func:`mlp_logits` is the functional form the batched
local solve differentiates (``torch.func``), on a nested params dict.
Weights go to ``device``: CUDA unless the caller passes another.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import prng
from repro_torch.device import resolve_device


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.w = nn.Parameter(torch.zeros(n_in, n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))


class MLP(nn.Module):
    def __init__(self, n_in: int = 784, hidden: int = 200, n_out: int = 10,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.fc1 = Dense(n_in, hidden, device=device)
        self.fc2 = Dense(hidden, n_out, device=device)

    def params(self) -> dict:
        """The nested params dict the round engine and solver take."""
        return {name: {"w": m.w, "b": m.b}
                for name, m in (("fc1", self.fc1), ("fc2", self.fc2))}

    def forward(self, x):
        return mlp_logits(self.params(), x)


def _dense_init(key, n_in, n_out, device):
    wk, _ = prng.split(key)
    scale = torch.sqrt(torch.tensor(2.0 / n_in, dtype=torch.float32))
    return {"w": prng.normal(wk, (n_in, n_out)) * float(scale),
            "b": torch.zeros(n_out, dtype=torch.float32, device=device)}


def init_mlp(key, n_in: int = 784, hidden: int = 200, n_out: int = 10,
             device=None) -> dict:
    """He-normal weights and zero biases (nested dict) on ``device``:
    the JAX package's ``init_mlp(key)`` for the same key words
    (``prng.PRNGKey(s)`` ↔ ``jax.random.PRNGKey(s)``), drawn by the
    ``jax.random`` twin within its ulp bound (ROADMAP D5)."""
    device = resolve_device(device)
    k1, k2 = prng.split(key.to(device))
    return {"fc1": _dense_init(k1, n_in, hidden, device),
            "fc2": _dense_init(k2, hidden, n_out, device)}


def mlp_logits(params, x):
    h = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


def make_loss_fn(logits_fn=mlp_logits):
    def loss_fn(params, x, y):
        return cross_entropy(logits_fn(params, x), y)

    return loss_fn


def make_loss_and_acc_fn(logits_fn=mlp_logits):
    def fn(params, x, y):
        logits = logits_fn(params, x)
        loss = cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y.long()).to(torch.float32).mean()
        return loss, acc

    return fn

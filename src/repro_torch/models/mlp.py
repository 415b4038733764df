"""The paper's experiment models.

Port of ``repro/models/mlp.py``:

* the MNIST classifier — one hidden layer of 200 ReLU units
  (:func:`init_mlp`, :func:`mlp_logits`, the ``MLP`` module);
* the CIFAR-10 classifier — three 3×3 convolutions (32, 64, 64
  channels, SAME padding, ReLU, 2×2 max-pool each) and three dense
  layers (128, 64, 10) (:func:`init_cnn`, :func:`cnn_logits`).

Parameters keep the JAX package's layout — ``fc*.w`` is (n_in, n_out),
applied as ``x @ w + b``; ``conv*.w`` is HWIO (kh, kw, c_in, c_out) —
so a flat row holds the same numbers in both packages.  ``MLP`` is the
``nn.Module`` (state-dict keys ``fc1.b``, ``fc1.w``, ``fc2.b``,
``fc2.w``); the ``*_logits`` functions are the functional forms the
batched local solve differentiates (``torch.func``), on a nested params
dict.  Weights go to ``device``: CUDA unless the caller passes another.
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


def _conv_init(key, kh, kw, cin, cout, device):
    # The reference draws straight from its key (no split, unlike
    # _dense_init).
    scale = torch.sqrt(torch.tensor(2.0 / (kh * kw * cin),
                                    dtype=torch.float32))
    return {"w": prng.normal(key, (kh, kw, cin, cout)) * float(scale),
            "b": torch.zeros(cout, dtype=torch.float32, device=device)}


def init_cnn(key, image_hw: int = 32, channels: int = 3, n_out: int = 10,
             device=None) -> dict:
    """He-normal HWIO kernels, dense weights and zero biases (nested
    dict) on ``device``: the JAX package's ``init_cnn(key)`` for the
    same key words, from its key tree (``split(key, 6)``, one key per
    layer), within the ``jax.random`` twin's ulp bound (ROADMAP D5)."""
    device = resolve_device(device)
    ks = prng.split(key.to(device), 6)
    params = {"conv1": _conv_init(ks[0], 3, 3, channels, 32, device),
              "conv2": _conv_init(ks[1], 3, 3, 32, 64, device),
              "conv3": _conv_init(ks[2], 3, 3, 64, 64, device)}
    feat = (image_hw // 8) ** 2 * 64  # three stride-2 pools
    params["fc1"] = _dense_init(ks[3], feat, 128, device)
    params["fc2"] = _dense_init(ks[4], 128, 64, device)
    params["fc3"] = _dense_init(ks[5], 64, n_out, device)
    return params


def conv3x3_same(x, w):
    """3×3 SAME convolution (stride 1: one pixel of padding each side)
    of NCHW activations with an HWIO kernel, permuted to OIHW here.
    Batched over clients by ``torch.func.vmap``, it runs as one grouped
    cuDNN convolution per pass on CUDA (TF32 off where a round is built:
    ``device.fp32_products``)."""
    return torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), padding=1)


def _conv_block(p, x):
    """:func:`conv3x3_same`, bias, ReLU, 2×2 max-pool of stride 2."""
    y = torch.relu(conv3x3_same(x, p["w"]) + p["b"][:, None, None])
    return torch.nn.functional.max_pool2d(y, 2, 2)


def cnn_logits(params, x, image_hw: int = 32, channels: int = 3):
    """Logits of flat images x (B, H·W·C) stored NHWC, as the reference
    stores them.  The convolutions run NCHW; the features go back to
    NHWC before they are flattened, so fc1 sees them in the reference's
    order."""
    x = x.reshape(x.shape[0], image_hw, image_hw, channels)
    x = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2", "conv3"):
        x = _conv_block(params[name], x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]


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

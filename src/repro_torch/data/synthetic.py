"""Deterministic synthetic datasets (numpy copies of the JAX package's).

Port of ``repro/data/synthetic.py``, the same bytes from the same
numpy seed:

* ``make_synthetic_mnist`` — 10 classes, 784-dim inputs in (0, 1), a
  mixture of Gaussian modes per class around prototypes in a 24-dim
  signal subspace, a shared nuisance subspace, 5.5% label flips;
* ``make_synthetic_cifar`` — 10 classes, 32×32×3 inputs in (−1, 1)
  stored flat (NHWC), 8 modes per class in a 40-dim signal subspace
  whose basis is drawn as coarse 8×8 grids upsampled to 32×32 (spatial
  patterns a CNN can use), 17% label flips;
* ``make_least_squares`` draws the engine tests' least-squares shards
  and returns them as torch tensors on the requested device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Dataset(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def _make_blobs(rng: np.random.Generator, *, n_train, n_test, dim,
                num_classes, modes_per_class, proto_scale, mode_scale,
                noise, nuisance_dim, nuisance_scale, clip01,
                signal_dim=None, label_flip=0.0, smooth_hwc=None):
    """Class modes in a ``signal_dim``-dim random subspace, noise, a
    shared nuisance subspace, squashed by a sigmoid (``clip01``) or
    tanh, then ``label_flip`` of the labels redrawn.  ``smooth_hwc=(H,
    W, C, coarse)`` draws the bases as coarse grids upsampled to H×W."""
    sd = signal_dim or dim

    def draw_basis(k):
        if smooth_hwc is None:
            return rng.normal(size=(k, dim)) / np.sqrt(sd)
        h, w, c, coarse = smooth_hwc
        g = rng.normal(size=(k, coarse, coarse, c))
        up = np.kron(g, np.ones((1, h // coarse, w // coarse, 1)))
        return up.reshape(k, h * w * c) / np.sqrt(sd)

    basis = draw_basis(sd)
    protos = rng.normal(size=(num_classes, sd)) * proto_scale
    modes = protos[:, None, :] + rng.normal(
        size=(num_classes, modes_per_class, sd)) * mode_scale
    nuis = draw_basis(nuisance_dim) * np.sqrt(sd / max(nuisance_dim, 1))

    def sample(n):
        y = rng.integers(0, num_classes, size=n)
        m = rng.integers(0, modes_per_class, size=n)
        x = modes[y, m] @ basis
        x = x + rng.normal(size=(n, dim)) * noise
        coef = rng.normal(size=(n, nuisance_dim)) * nuisance_scale
        x = x + coef @ nuis
        if clip01:
            x = 1.0 / (1.0 + np.exp(-x))  # squash into (0, 1) like pixels
        else:
            x = np.tanh(x)
        if label_flip > 0:
            flip = rng.random(n) < label_flip
            y = np.where(flip, rng.integers(0, num_classes, size=n), y)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return Dataset(x_tr, y_tr, x_te, y_te, num_classes)


def make_synthetic_mnist(n_train: int = 12000, n_test: int = 2000,
                         seed: int = 1234) -> Dataset:
    """784-dim, 10-class 'MNIST' (numpy arrays, host memory)."""
    rng = np.random.default_rng(seed)
    return _make_blobs(
        rng, n_train=n_train, n_test=n_test, dim=784, num_classes=10,
        modes_per_class=3, proto_scale=1.0, mode_scale=0.45, noise=1.2,
        nuisance_dim=32, nuisance_scale=0.8, clip01=True,
        signal_dim=24, label_flip=0.055)


def make_synthetic_cifar(n_train: int = 10000, n_test: int = 2000,
                         seed: int = 4321) -> Dataset:
    """32×32×3, 10-class 'CIFAR-10', flat (n, 3072) NHWC (numpy arrays,
    host memory)."""
    rng = np.random.default_rng(seed)
    return _make_blobs(
        rng, n_train=n_train, n_test=n_test, dim=3072, num_classes=10,
        modes_per_class=8, proto_scale=0.7, mode_scale=0.9, noise=1.5,
        nuisance_dim=96, nuisance_scale=0.6, clip01=False,
        signal_dim=40, label_flip=0.17, smooth_hwc=(32, 32, 3, 8))


def make_least_squares(n_clients: int, n_points: int = 16, dim: int = 8,
                       seed: int = 0, *, device=None):
    """Per-client least-squares shards b_i = A_i θ_i^true.

    Returns (data, params0, ls_loss) like the JAX package, with data =
    {"x": (N, n_points, dim), "y": (N, n_points)} fp32 tensors on
    ``device`` and params0 = {"theta": zeros(dim)}.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_clients, n_points, dim)).astype(np.float32)
    theta_true = rng.normal(size=(n_clients, dim)).astype(np.float32)
    b = np.einsum("npd,nd->np", A, theta_true).astype(np.float32)

    def ls_loss(params, x, y):
        r = x @ params["theta"] - y
        return 0.5 * torch.mean(r * r)

    data = {"x": torch.from_numpy(A).to(device),
            "y": torch.from_numpy(b).to(device)}
    return data, {"theta": torch.zeros(dim, device=device)}, ls_loss

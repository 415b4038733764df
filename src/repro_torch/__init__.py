"""FedBack (paper Alg. 2) on PyTorch and CUDA: the port of ``repro``.

The package mirrors the JAX package's layout (``core``, ``kernels``,
``utils``, ``optim``, ``models``, ``data``, ``configs``) so each module
has an obvious counterpart, but it never imports ``jax`` or anything of
``repro``: it carries its own copies of what it needs.  The hot server
passes of the round run as hand-written CUDA kernels for Hopper
(``csrc/fedback_kernels.cu``); each kernel keeps a plain PyTorch
version beside it, which is what runs when the tensors lie on the CPU.

Entry points (``core.fedback.init_state``, ``make_round_fn``,
``make_eval_fn``, ``data.federated_arrays``, ``data.make_least_squares``)
run on ``cuda`` unless the caller passes ``device="cpu"``; with the
default device and no CUDA device they raise (``device.default_device``).
"""
from .device import default_device, resolve_device  # noqa: F401

__version__ = "0.11.0"

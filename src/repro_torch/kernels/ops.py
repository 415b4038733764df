"""Public kernel entry points of the port (``repro/kernels/ops.py``).

Each op takes the hand-written CUDA kernel for CUDA tensors and the
plain PyTorch version for CPU tensors; the choice is made by the
wrapper from where its inputs lie, never by a fallback.  Every kernel
wrapper counts its launches; :func:`launch_counts` reads the counts and
:func:`reset_launch_counts` sets them to 0 (flash attention's counts by
instance, ``flash_attention.instance_launches``, too), so a run can
show that its main path went through the kernels.
K1's leaf-table kernel (``trigger_norms.table_kernel``) is launched by
three wrappers, each counting its own launches: ``trigger_sq_norms``
for a bf16 z or ω (K1a), ``trigger_sq_norms_sharded`` (K1b, once per
device of a client mesh) and ``trigger_sq_norms_pytree`` (K1c, a
stacked tree that is not the flat matrix, once per device with
``mesh=``; its ``leaf_copies`` counts leaves that had to be made
contiguous first, which :func:`reset_launch_counts` sets to 0 too).
K2b (``admm_update_sharded``) launches K2's kernel once per shard and
counts those launches, not K2; ``admm_update`` and
``trigger_sq_norms_pytree`` take ``mesh=``.

Each wrapper is also counted where it runs its plain version
(``utils/spans.py::kernel_wrapper``): ``calls`` ticks on both paths,
inside a ``kernel/<name>`` span, and a wrapper that hands its work to
another (the pytree front end on a flat matrix, ``mesh=``) leaves the
count to the innermost.  :func:`call_counts` reads them, and
:func:`reset_launch_counts` sets them to 0 with the launches.
"""
from __future__ import annotations

from .admm_update import (  # noqa: F401
    admm_update,
    admm_update_hbm_bytes,
    admm_update_sharded,
    admm_update_sharded_ref,
)
from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_flops,
    flash_attention_hbm_bytes,
)
from .fused_gss import fused_gss, fused_gss_hbm_bytes  # noqa: F401
from .ref import (  # noqa: F401
    admm_update_ref,
    flash_attention_ref,
    fused_gss_ref,
    ssd_scan_ref,
    trigger_sq_norms_pytree_ref,
    trigger_sq_norms_ref,
)
from .ssd_scan import ssd_scan, ssd_scan_hbm_bytes  # noqa: F401
from .trigger_norms import (  # noqa: F401
    trigger_sq_norms,
    trigger_sq_norms_hbm_bytes,
    trigger_sq_norms_sharded,
    trigger_sq_norms_sharded_ref,
    trigger_table_args,
)
from .trigger_pytree import (  # noqa: F401
    trigger_sq_norms_pytree,
    trigger_sq_norms_pytree_hbm_bytes,
)

KERNELS = {"trigger_sq_norms": trigger_sq_norms,
           "trigger_sq_norms_sharded": trigger_sq_norms_sharded,
           "trigger_sq_norms_pytree": trigger_sq_norms_pytree,
           "admm_update": admm_update,
           "admm_update_sharded": admm_update_sharded,
           "fused_gss": fused_gss,
           "flash_attention": flash_attention,
           "ssd_scan": ssd_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def call_counts() -> dict[str, int]:
    return {name: fn.calls for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.calls = 0
    trigger_sq_norms_pytree.leaf_copies = 0
    flash_attention.instance_launches = dict.fromkeys(
        flash_attention.instance_launches, 0)


"""Kernel shelf of the port: hand-written Hopper kernels and their plain
versions, registered as function blocks (the port of
``repro/kernels/__init__.py`` and ``ops.py``).

Targets per block: ``torch`` (the plain version), ``cuda`` (the kernel's
wrapper) and ``ref`` where the reference has one.  Unbound calls pick
``cuda`` for CUDA tensors and ``torch`` for CPU tensors
(:mod:`repro_torch.core.blocks`), as ``ops._auto_backend`` picks the
Pallas kernel on a TPU.  Nothing is built at import: the CUDA library is
compiled at the first kernel launch (:mod:`repro_torch.kernels.build`).
"""

from repro_torch.core import blocks
from repro_torch.kernels import attention, paged_attention, ref, rmsnorm

#: the wrappers whose ``launches`` counters show a run went through them
KERNELS = {
    "rmsnorm": rmsnorm.rmsnorm,
    "paged_attention": paged_attention.paged_attention,
    "flash_attention": attention.flash_attention,
}


def _register_all() -> None:
    r = blocks.registry
    for block, target, fn, note in [
        ("rmsnorm", "ref", ref.rmsnorm_ref, "plain-torch oracle"),
        ("rmsnorm", "torch", rmsnorm.rmsnorm_torch, "plain torch"),
        ("rmsnorm", "cuda", rmsnorm.rmsnorm, "csrc/rmsnorm.cu"),
        ("attention", "ref", ref.attention_ref, "softmax einsum oracle"),
        ("attention", "torch", attention.flash_attention_torch,
         "dense masked softmax"),
        ("attention", "cuda", attention.flash_attention,
         "csrc/flash_attention.cu"),
        ("paged_attention", "torch", paged_attention.paged_attention_torch,
         "page gather + dense masked softmax"),
        ("paged_attention", "cuda", paged_attention.paged_attention,
         "csrc/paged_attention.cu"),
    ]:
        r.register(block, target, fn, note)


_register_all()


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}

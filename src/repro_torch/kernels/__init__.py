"""Kernel shelf of the port: hand-written Hopper kernels and their plain
versions, registered as function blocks (the port of
``repro/kernels/__init__.py`` and ``ops.py``).

Targets per block: ``torch`` (the plain version), ``cuda`` (the kernel's
wrapper) and ``ref`` where the reference has one. Unbound calls pick
``cuda`` for CUDA tensors and ``torch`` for CPU tensors
(:mod:`repro_torch.core.blocks`), as ``ops._auto_backend`` picks the
Pallas kernel on a TPU; but a call that autograd will differentiate and
that the ``cuda`` target cannot (``NO_BACKWARD``: the gated norm and the
SSD chunk kernel have no backward kernel) picks ``torch``, counted in
:func:`counters` as ``grad_default/<block>[.<form>]``. Nothing is built at
import: the CUDA library is compiled at the first kernel launch
(:mod:`repro_torch.kernels.build`).
"""

import functools

from repro_torch.core import blocks
from repro_torch.kernels import attention, fft, matmul, ops, paged_attention, ref, rmsnorm, ssd

#: the wrappers whose ``launches`` counters show a run went through them
KERNELS = {
    "rmsnorm": rmsnorm.rmsnorm,
    "paged_attention": paged_attention.paged_attention,
    "flash_attention": attention.flash_attention,
    "matmul": matmul.matmul,
    "schur_update": matmul.schur_update,
    "complex_matmul": fft.complex_matmul,
    "ssd_chunks": ssd.ssd_chunks,
    # the backward kernels, which the train step's autograd launches
    "flash_attention_bwd": attention.flash_attention_bwd,
    "rmsnorm_bwd": rmsnorm.rmsnorm_bwd,
}

#: the counters' prefix for the calls resolved to ``torch`` for a gradient
GRAD_DEFAULT = "grad_default"
#: the counters kept per route or form beside a kernel's launches
_SUBCOUNTS = {"flash_attention": "routes", "flash_attention_bwd": "routes", "rmsnorm": "forms",
              "rmsnorm_bwd": "forms"}


#: (block, target) -> the calls that target cannot differentiate
#: (:data:`repro_torch.core.blocks.NoBackward`); the shelf's other targets
#: differentiate every call (flash attention and RMSNorm's plain and add
#: forms through their backward kernels, the plain versions through autograd)
NO_BACKWARD = {
    ("rmsnorm", "cuda"): lambda args, kwargs: "gated" if kwargs.get("gate") is not None else None,
    ("ssd_scan", "cuda"): lambda args, kwargs: "",
}


def _register_all() -> list[tuple]:
    r = blocks.registry
    impls = [
        # one block, three forms: plain, delta= (the residual add fused) and
        # gate= (Mamba-2's gated norm); a binding of it covers all three
        ("rmsnorm", "ref", rmsnorm.rmsnorm_torch, "plain-torch oracle (ref.rmsnorm_ref)"),
        ("rmsnorm", "torch", rmsnorm.rmsnorm_torch, "plain torch"),
        ("rmsnorm", "cuda", rmsnorm.rmsnorm, "csrc/rmsnorm.cu, three forms"),
        ("attention", "ref", ref.attention_ref, "softmax einsum oracle"),
        ("attention", "torch", attention.flash_attention_torch,
         "dense masked softmax"),
        ("attention", "cuda", attention.flash_attention,
         "csrc/flash_attention.cu"),
        ("paged_attention", "torch", paged_attention.paged_attention_torch,
         "page gather + dense masked softmax"),
        ("paged_attention", "cuda", paged_attention.paged_attention,
         "csrc/paged_attention.cu"),
        ("ssd_scan", "ref", functools.partial(ops.ssd_scan, backend="ref"),
         "sequential recurrence oracle"),
        ("ssd_scan", "torch", functools.partial(ops.ssd_scan, backend="torch"),
         "chunked SSD, plain chunk terms"),
        ("ssd_scan", "cuda", functools.partial(ops.ssd_scan, backend="cuda"),
         "chunked SSD, csrc/ssd_chunks.cu"),
        # the offload pipeline's shelf: cuBLAS / cuFFT / cuSOLVER analogues
        ("matmul", "ref", ref.matmul_ref, "torch.matmul oracle"),
        ("matmul", "torch", functools.partial(ops.matmul, backend="torch"),
         "plain torch"),
        ("matmul", "cuda", functools.partial(ops.matmul, backend="cuda"),
         "csrc/matmul.cu"),
        ("fft2d", "ref", functools.partial(ops.fft2d, backend="ref"),
         "torch.fft.fft2 oracle"),
        ("fft2d", "torch", functools.partial(ops.fft2d, backend="torch"),
         "matmul-DFT stages, plain complex matmul"),
        ("fft2d", "cuda", functools.partial(ops.fft2d, backend="cuda"),
         "matmul-DFT stages, csrc/complex_matmul.cu"),
        ("lu", "torch", functools.partial(ops.lu, backend="torch"),
         "blocked LU, plain trailing update"),
        ("lu", "cuda", functools.partial(ops.lu, backend="cuda"),
         "blocked LU, csrc/matmul.cu Schur update"),
    ]
    for block, target, fn, note in impls:
        r.register(block, target, fn, note, NO_BACKWARD.get((block, target)))
    return [(block, target, fn) for block, target, fn, _ in impls]


_SHELF_IMPLS = _register_all()

#: block names registered by this package: the kernel shelf
SHELF_BLOCKS = tuple(sorted({block for block, _, _ in _SHELF_IMPLS}))

#: registration-time hash of the shelf's implementations (the wrappers'
#: and plain versions' sources); with the CUDA sources' hash it is the
#: ``kernel_shelf`` component of a stored plan's environment fingerprint,
#: so a rewritten wrapper or kernel invalidates plans measured before it
SHELF_FINGERPRINT = blocks.implementations_fingerprint(_SHELF_IMPLS)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    attention.flash_attention.routes = dict.fromkeys(attention.ROUTES, 0)
    attention.flash_attention_bwd.routes = dict.fromkeys(attention.BWD_ROUTES, 0)
    rmsnorm.rmsnorm.forms = dict.fromkeys(rmsnorm.FORMS, 0)
    rmsnorm.rmsnorm_bwd.forms = dict.fromkeys(rmsnorm.BWD_FORMS, 0)
    blocks.registry.grad_defaults.clear()


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def counters() -> dict[str, int]:
    """Every launch counter by name: each kernel's launches, flash's per
    route and rmsnorm's (forward and backward) per form; and
    ``grad_default/<block>[.<form>]``, the unbound calls resolved to
    ``torch`` for a gradient their ``cuda`` target cannot take (never
    under a CUDA graph's capture, which records no gradient).  A CUDA graph
    replay runs no wrapper, so a step program adds what its capture
    counted at every replay."""
    out = launch_counts()
    for name, attr in _SUBCOUNTS.items():
        out.update({f"{name}/{k}": n for k, n in getattr(KERNELS[name], attr).items()})
    out.update({f"{GRAD_DEFAULT}/{k}": n for k, n in blocks.registry.grad_defaults.items()})
    return out


def add_counters(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys of :func:`counters`) to the counters."""
    for key, n in delta.items():
        name, _, sub = key.partition("/")
        if not sub:
            KERNELS[name].launches += n
        else:
            getattr(KERNELS[name], _SUBCOUNTS[name])[sub] += n

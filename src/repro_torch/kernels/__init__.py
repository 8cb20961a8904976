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

from repro_torch.analysis.legality import TargetConstraints
from repro_torch.analysis.resources import ResourceHint
from repro_torch.core import blocks
from repro_torch.kernels import (
    attention,
    build,
    fft,
    matmul,
    moe_experts,
    ops,
    paged_attention,
    ref,
    rmsnorm,
    ssd,
)

#: the wrappers whose ``launches`` counters show a run went through them
KERNELS = {
    "rmsnorm": rmsnorm.rmsnorm,
    "paged_attention": paged_attention.paged_attention,
    "flash_attention": attention.flash_attention,
    "matmul": matmul.matmul,
    "schur_update": matmul.schur_update,
    "complex_matmul": fft.complex_matmul,
    "ssd_chunks": ssd.ssd_chunks,
    "moe_experts": moe_experts.moe_experts,
    # the backward kernels, which the train step's autograd launches
    "flash_attention_bwd": attention.flash_attention_bwd,
    "rmsnorm_bwd": rmsnorm.rmsnorm_bwd,
}

#: the counters' prefix for the calls resolved to ``torch`` for a gradient
GRAD_DEFAULT = "grad_default"
#: the counters kept per route or form beside a kernel's launches
_SUBCOUNTS = {"flash_attention": "routes", "flash_attention_bwd": "routes", "rmsnorm": "forms",
              "rmsnorm_bwd": "forms", "paged_attention": "routes"}


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

#: every registered (block, target) pair: the coverage universe the
#: shelf-coverage lint checks BLOCK_LEGALITY / BLOCK_RESOURCES against
SHELF_IMPL_PAIRS = tuple((block, target) for block, target, _ in _SHELF_IMPLS)

#: registration-time hash of the shelf's implementations (the wrappers'
#: and plain versions' sources); with the CUDA sources' hash it is the
#: ``kernel_shelf`` component of a stored plan's environment fingerprint,
#: so a rewritten wrapper or kernel invalidates plans measured before it
SHELF_FINGERPRINT = blocks.implementations_fingerprint(_SHELF_IMPLS)


def _legality_metadata() -> dict[tuple[str, str], TargetConstraints]:
    """Static envelope of every shelf implementation, consumed by the
    ``repro_torch.analysis.legality`` pre-filter (paper Step 1): ``ref``
    and ``torch`` run anywhere; a ``cuda`` target launches a kernel built
    for ``sm_90a`` and needs the card, over the dtypes its wrapper takes
    (``build.dtype_code``: float32 / bfloat16; ``build.check_float32``
    for the three GEMM kernels, whose complex operands the FFT splits
    into float32 planes)."""
    anywhere = TargetConstraints()
    out = {(block, target): anywhere for block, target in SHELF_IMPL_PAIRS if target != "cuda"}
    f32_bf16 = ("float32", "bfloat16")
    for block, dtypes, note in (
        ("rmsnorm", f32_bf16, "csrc/rmsnorm.cu (plain, add, gated) and rmsnorm_bwd.cu"),
        ("attention", f32_bf16, "csrc/flash_attention.cu and flash_attention_bwd.cu"),
        ("paged_attention", f32_bf16, "csrc/paged_attention.cu; int32 page table"),
        ("ssd_scan", f32_bf16, "csrc/ssd_chunks.cu; dt float32"),
        ("matmul", ("float32",), "csrc/matmul.cu, 3xTF32"),
        ("fft2d", ("float32", "complex64"), "csrc/complex_matmul.cu on float32 planes"),
        ("lu", ("float32",), "blocked LU; csrc/matmul.cu Schur update, 3xTF32"),
    ):
        out[(block, "cuda")] = TargetConstraints(requires_platform=("gpu",), dtypes=dtypes,
                                                 notes=note)
    return out


#: (block, target) -> TargetConstraints for the whole shelf
BLOCK_LEGALITY = _legality_metadata()

#: the most shared memory one CTA of each kernel takes, from its launch
#: constants in csrc/: the GEMM body's (tf32_gemm.cuh kSmem: three stages
#: of 128 x 32 f32 A and B tiles, B's hi/lo split, barriers, alignment),
#: the CUDA-core flash forward's at D = Dv = 512 (flash_attention.cu
#: launch_dv: 4 * (kBQ D + kBKV (D + 1) + kBKV Dv)), and the limits the
#: others size their tiles to (paged_attention.cu kSmemLimit, ssd_chunks.cu
#: kSmemMax, rmsnorm_bwd.cu kMaxSmem, the 227 KiB that
#: flash_attention_bwd.cu's tiles stay within); the forward RMSNorm keeps
#: one float a warp
SMEM_BYTES = {
    "gemm": 3 * 2 * 128 * 32 * 4 + 2 * 2 * 128 * 32 * 4 + 2 * 3 * 8 + 1024,
    "flash_attention": 4 * (32 * 512 + 32 * 513 + 32 * 512),
    "flash_attention_bwd": 227 * 1024,
    "paged_attention": 227 * 1024,
    "ssd_chunks": 232448,
    "rmsnorm": 4 * 512 // 32,
    "rmsnorm_bwd": 232448 - 1024,
}


def _resource_metadata() -> dict[tuple[str, str], ResourceHint]:
    """Memory-envelope hints for every shelf implementation, consumed by
    the ``repro_torch.analysis.resources`` fit pass (the paper's Step 5
    resource check).  ``ref`` and the plain ``torch`` formulations add no
    working-set overhead beyond the traced program, but the page gather
    and the matmul-DFT's split planes; a ``cuda`` target declares the
    shared memory a CTA of its kernels takes (checked against
    ``DeviceEnvelope.smem_bytes``) and, as the reference's Pallas kernels,
    any extra device copies."""
    plain = ResourceHint()
    out = {(block, target): plain for block, target in SHELF_IMPL_PAIRS}
    # the torch paged target gathers each slot's (max_pages * page_size)
    # K/V view per decode step: about one more cache-sized copy per leaf
    out[("paged_attention", "torch")] = ResourceHint(
        memory_multiplier=1.5, notes="gathered per-slot K/V view materialised per step")
    split = ResourceHint(memory_multiplier=2.0,
                         notes="matmul-DFT carries complex values as split re/im planes")
    out[("fft2d", "torch")] = split
    smem = SMEM_BYTES
    out[("rmsnorm", "cuda")] = ResourceHint(
        smem_tile_bytes=max(smem["rmsnorm"], smem["rmsnorm_bwd"]),
        notes="forward: a float a warp; backward: its copy ring")
    out[("attention", "cuda")] = ResourceHint(
        smem_tile_bytes=max(smem["flash_attention"], smem["flash_attention_bwd"]),
        notes="q tile + streamed K/V tiles (CUDA-core route at D = 512)")
    out[("paged_attention", "cuda")] = ResourceHint(
        smem_tile_bytes=smem["paged_attention"],
        notes="q rows + staged page rings + partials; no gathered view")
    out[("ssd_scan", "cuda")] = ResourceHint(
        memory_multiplier=1.25, smem_tile_bytes=smem["ssd_chunks"],
        notes="chunk states kept in device memory between the kernel and the scan")
    out[("matmul", "cuda")] = ResourceHint(smem_tile_bytes=smem["gemm"],
                                          notes="TMA-staged A/B tiles, B hi/lo")
    out[("fft2d", "cuda")] = ResourceHint(
        memory_multiplier=2.0, smem_tile_bytes=smem["gemm"],
        notes="split re/im planes; the complex GEMM's tiles")
    out[("lu", "cuda")] = ResourceHint(smem_tile_bytes=smem["gemm"],
                                      notes="the Schur update's GEMM tiles")
    return out


#: (block, target) -> ResourceHint for the whole shelf
BLOCK_RESOURCES = _resource_metadata()


def _routed() -> dict:
    """The model functions that count their calls by route beside the
    kernels' counters (imported here, late: the models import the
    kernels): the MoE's grouped and capacity routes."""
    from repro_torch.models.moe import moe_forward

    return {"moe_forward": moe_forward}


def traced_counts() -> dict[str, int]:
    """The abstract calls of each kernel (a trace's stand-ins, kept apart
    from the launch counters: :func:`counters` never moves under a
    trace)."""
    return {name: build.traced[name] for name in KERNELS}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    attention.flash_attention.routes = dict.fromkeys(attention.ROUTES, 0)
    attention.flash_attention_bwd.routes = dict.fromkeys(attention.BWD_ROUTES, 0)
    paged_attention.paged_attention.routes = dict.fromkeys(paged_attention.ROUTES, 0)
    rmsnorm.rmsnorm.forms = dict.fromkeys(rmsnorm.FORMS, 0)
    rmsnorm.rmsnorm_bwd.forms = dict.fromkeys(rmsnorm.BWD_FORMS, 0)
    for fn in _routed().values():
        fn.routes = dict.fromkeys(fn.routes, 0)
    blocks.registry.grad_defaults.clear()


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def counters() -> dict[str, int]:
    """Every launch counter by name: each kernel's launches, flash's and
    paged attention's per route and rmsnorm's (forward and backward) per
    form; ``moe_forward/<route>``, the MoE's calls by route; and
    ``grad_default/<block>[.<form>]``, the unbound calls resolved to
    ``torch`` for a gradient their ``cuda`` target cannot take (never
    under a CUDA graph's capture, which records no gradient).  A CUDA graph
    replay runs no wrapper, so a step program adds what its capture
    counted at every replay."""
    out = launch_counts()
    for name, attr in _SUBCOUNTS.items():
        out.update({f"{name}/{k}": n for k, n in getattr(KERNELS[name], attr).items()})
    for name, fn in _routed().items():
        out.update({f"{name}/{k}": n for k, n in fn.routes.items()})
    out.update({f"{GRAD_DEFAULT}/{k}": n for k, n in blocks.registry.grad_defaults.items()})
    return out


def add_counters(delta: dict[str, int]) -> None:
    """Add ``delta`` (keys of :func:`counters`) to the counters."""
    for key, n in delta.items():
        name, _, sub = key.partition("/")
        if not sub:
            KERNELS[name].launches += n
        elif name in KERNELS:
            getattr(KERNELS[name], _SUBCOUNTS[name])[sub] += n
        else:
            _routed()[name].routes[sub] += n

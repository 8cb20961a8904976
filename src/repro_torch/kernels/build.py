"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``.  The library
lives in ``build/repro_torch/`` at the repository root, named by a hash of
the sources and flags: it is built at first use and rebuilt whenever a
source changes.  A missing ``nvcc`` raises — there is no fallback.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises on a non-zero code.

The abstract path: under a trace (``make_fx`` with fake tensors) an
operand's ``data_ptr()`` is no address, so a wrapper must not
reach :func:`launch` (on the card that would run a kernel on bogus
pointers; without one, build with ``nvcc``).  Each wrapper runs its own
checks, allocates its outputs and workspace, and then asks
:func:`skip_launch`, which notes the kernel in :data:`traced` (never in the
launch counters) and tells it to return them unlaunched.  Each wrapper
declares there the work its kernel would do (:class:`Work`: FLOPs and the
bytes it must move, from its own formula in the kernel's module, the one
``chip_smoke.py`` phase 2 takes its bounds from): a trace counts no aten op
for a kernel, so the cost model (``launch/graph_cost.py``) reads this.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.blocks import GradRefused, wants_grad

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

#: C entry point -> argtypes.  Pointers and the stream are ``c_void_p`` so
#: ctypes never truncates them to 32 bits.
ENTRY_POINTS = {
    # form, a, b, c, skip, w, s_out, out, the (batch, sequence, head, dim)
    # strides of a, b and c, rows, seq, d, head_dim, eps, dtype, w_dtype,
    # tpr, nv, stream
    "repro_rmsnorm": [_I] + [_P] * 7 + [_L] * 12 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    # q, k_pool, v_pool, q_rope, kr_pool, pages, index, out, workspace,
    # workspace_elems, B, H, KH, S, Dk, Dv, Dr, page_size, max_pages,
    # pool_pages, pages_per_split, n_splits, scale, dtype, route, stream
    "repro_paged_attention": [_P] * 9 + [_L] + [_I] * 12 + [_F, _I, _I, _P],
    # q, k, v, out, lse (or null), B, H, KH, Sq, Skv, D, Dv, causal, scale,
    # dtype, route, stream
    "repro_flash_attention": [_P] * 5 + [_I] * 8 + [_F, _I, _I, _P],
    # q, k, v, out, lse, do, dq, dk, dv, workspace (or null),
    # workspace_elems, B, H, KH, Sq, Skv, D, Dv, causal, scale, dtype, route,
    # stream
    "repro_flash_attention_bwd": [_P] * 10 + [_L] + [_I] * 8 + [_F, _I, _I, _P],
    # x, dy, ds (or null), w, dx, partial, dw, rows, d, eps, dtype, w_dtype,
    # ctas, groups, tpr, nv, stages, stream
    "repro_rmsnorm_bwd": [_P] * 7 + [_I] * 2 + [_F] + [_I] * 7 + [_P],
    # a, b, out, M, N, K, stream
    "repro_matmul": [_P] * 3 + [_I] * 3 + [_P],
    # c, a, b, out, M, N, K, stream
    "repro_schur_update": [_P] * 4 + [_I] * 3 + [_P],
    # ar, ai, br, bi, out_r, out_i, M, N, K, stream
    "repro_complex_matmul": [_P] * 6 + [_I] * 3 + [_P],
    # x, topi, topv, w_gate, w_up, w_down, offsets, order, h, y, out, tally,
    # tokens, top_k, n_experts, d, f, dtype, stream
    "repro_moe_experts": [_P] * 12 + [_I] * 6 + [_P],
    # x, dt, a, bmat, cmat, y, states, cumdecay, totals,
    # x/bmat/cmat batch and sequence strides, B, S, H, P, N, L, dtype, stream
    "repro_ssd_chunks": [_P] * 9 + [_L] * 6 + [_I] * 7 + [_P],
}

#: dtype code the C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build did: seconds, library path, nvcc's output
build_info: dict = {}
#: the abstract calls of each kernel (:func:`skip_launch`), by the name of
#: its wrapper in ``kernels.KERNELS``: a trace's stand-ins, never launches
traced: Counter = Counter()
#: the lists :func:`collect_work` is filling (any thread: autograd may
#: trace a backward on a thread of its own)
_collecting: list[list] = []
#: the SMs of the card the kernels are written for (an H100 SXM): the
#: launch plan of an abstract call on a host without a card
H100_SMS = 132


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: repro_torch's CUDA kernels are built from "
            f"{CSRC} with nvcc for sm_90a, and there is no fallback"
        )
    return found


def build() -> Path:
    """Compile the sources into ``build/repro_torch/`` unless a library
    for the current source hash exists; returns its path."""
    lib_path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, path=str(lib_path), log="(cached)")
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources(), objs)
        ]
        logs, failed = [], []
        for src, proc in zip(sources(), procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half
    build_info.update(
        seconds=time.perf_counter() - t0, path=str(lib_path),
        log="\n".join(logs),
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise if its launch failed."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def is_abstract(*tensors: "torch.Tensor | None") -> bool:
    """True when any operand is a ``FakeTensor`` (a trace's: its
    ``data_ptr()`` is no address).  A meta tensor is not abstract here: the
    CPU tests pass meta tensors as stand-ins for CUDA operands to a
    wrapper whose ``launch`` they patch, to read its launch arguments."""
    return any(isinstance(t, FakeTensor) for t in tensors)


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do, whatever its design: the FLOPs of the
    function it computes, counted once; the bytes it must move, each input
    read once and each output written once; the peak its FLOPs run at
    (``"bfloat16"``, ``"tf32"``, ``"float32"``: the keys of
    ``launch.mesh.HW.peak_flops``); and the tensor-core passes a product
    takes (3 for 3xTF32), which the roofline multiplies in."""

    flops: int
    bytes: int
    peak: str
    passes: int = 1


def peak_of(dtype: torch.dtype) -> str:
    """The peak a kernel's FLOPs on ``dtype`` operands run at."""
    return "bfloat16" if dtype in (torch.bfloat16, torch.float16) else "float32"


def skip_launch(name: str, *tensors: "torch.Tensor | None",
                work: "Callable[[], Work]") -> bool:
    """The abstract path's test, just before a launch: True (and ``name``
    noted as traced, with ``work()``, the call's declared :class:`Work`)
    when the operands are abstract, so the wrapper returns its outputs
    without building or launching anything.  ``work`` is called only then:
    a launch pays nothing for it."""
    if not is_abstract(*tensors):
        return False
    declared = work()
    with _lock:
        traced[name] += 1
        for out in _collecting:
            out.append((name, declared))
    return True


@contextlib.contextmanager
def collect_work():
    """The kernels the abstract calls in this scope stood in for, in call
    order: a list of ``(name, Work)`` filled as they are noted."""
    out: list = []
    with _lock:
        _collecting.append(out)
    try:
        yield out
    finally:
        with _lock:  # by identity: two lists may hold the same entries
            del _collecting[next(i for i, e in enumerate(_collecting) if e is out)]


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s base is 16-byte aligned, as TMA loads it; an
    abstract tensor counts as aligned (the allocator's are)."""
    return is_abstract(t) or t.data_ptr() % 16 == 0


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (read once per device); without a card (a
    trace of a CUDA program on a host) the H100's."""
    if not torch.cuda.is_available():
        return H100_SMS
    return _device_sms(torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}"
        ) from None


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def tma_operand(t: torch.Tensor, shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """``t`` as a TMA kernel can load it: zero-padded to ``shape`` (by
    default its last dim rounded up to 16 bytes), and copied unless its
    base and its strides (but the last, which must be 1) are multiples of
    16 bytes.  A dim of length 1 is not checked: its stride is never
    stepped, and the wrapper gives the kernel a valid one.  An operand that
    needs neither comes back as itself, so aligned shapes pay nothing; the
    zeros add nothing to a product, and the wrapper slices off what they
    give."""
    e = t.element_size()
    if shape is None:
        shape = (*t.shape[:-1], -(-t.shape[-1] * e // 16) * 16 // e)
    strides_ok = t.stride(-1) == 1 and all(
        st * e % 16 == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1
    )
    if tuple(t.shape) == tuple(shape) and aligned(t) and strides_ok:
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def refuse_grad(name: str, block: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would differentiate through a kernel that has no
    backward: its output has no gradient path, so every gradient through
    it would silently be lost.  The message names the shelf block whose
    ``torch`` target (the plain version, which autograd differentiates)
    can be bound in its place.  An unbound block never gets here: the
    registry resolves such a call to ``torch`` (``kernels.NO_BACKWARD``)."""
    if wants_grad(*tensors):
        raise GradRefused(
            f"{name}: the CUDA kernel has no backward, so autograd cannot take a "
            f"gradient through it; bind the '{block}' block's 'torch' target "
            f"(repro_torch.core.blocks.bind({{'{block}': 'torch'}})) or wait for its "
            "backward kernel (ROADMAP B10)"
        )


def check_float32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32 (the GEMM kernels' one type)."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")

"""Step-1 analysis for traced torch programs (the port of
``repro/core/jaxpr_analysis.py``).

The reference walks a ``ClosedJaxpr`` from ``jax.make_jaxpr``; the port
walks an aten-level FX graph from
``torch.fx.experimental.proxy_tensor.make_fx(fn, tracing_mode="fake")``:
nothing executes and no device memory is taken, every value's shape and
dtype sit in ``node.meta["val"]``, and a tensor the function reads without
taking it as an argument (a closed-over weight, a table built inside)
becomes a ``get_attr`` constant, the counterpart of a jaxpr const.  The
hand-written kernels run no aten op under a trace: their wrappers take
the abstract path (``kernels/build.py``) and are noted by name in
:attr:`GraphReport.kernels`.

The walker builds:

* an **op histogram** (the FX counterpart of a Deckard characteristic
  vector), by aten name (``aten.mm``) or higher-order op
  (``higher_order.while_loop``);
* the **FLOPs** of the matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``linear``, ``mv``, ``dot``), convolutions and FFTs, with the
  reference's formulas;
* the structural flags the offload pre-filter reads.  The port's loops
  over layers and chunks are Python, unrolled by the trace, so
  ``has_scan`` / ``has_while`` are false where the reference's
  ``lax.scan`` makes them true.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: call targets whose output aliases an input's storage (no new bytes)
VIEW_OPS = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.t", "aten.transpose",
    "aten.permute", "aten.expand", "aten.slice", "aten.select", "aten.squeeze",
    "aten.unsqueeze", "aten.as_strided", "aten.alias", "aten.detach", "aten.diagonal",
    "aten.unfold", "aten.split", "aten.split_with_sizes", "aten.chunk", "aten.unbind",
    "aten.narrow", "aten.view_as_real", "aten.view_as_complex", "aten.real", "aten.imag",
    "aten.lift_fresh", "aten.movedim", "aten.flatten", "aten.unflatten",
    "_operator.getitem",
})

_MATMULS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.linear",
            "aten.mv", "aten.dot", "aten.matmul")
_FFTS = ("aten._fft_c2c", "aten._fft_r2c", "aten._fft_c2r")


def op_name(target: Any) -> str:
    """``aten.mm`` for ``torch.ops.aten.mm.default``; ``higher_order.cond``
    for a higher-order op; the qualified name of any other callable."""
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return str(packet)
    if isinstance(target, torch._ops.HigherOrderOperator):
        return f"higher_order.{target.name()}"
    module = getattr(target, "__module__", None) or ""
    return f"{module}.{getattr(target, '__name__', repr(target))}".lstrip(".")


def is_inplace(name: str) -> bool:
    """An aten op that writes its first argument in place (``add_``,
    ``copy_``, ``index_put_``)."""
    return name.startswith("aten.") and name.endswith("_") and not name.endswith("__")


def _shape(node: Any) -> tuple:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return tuple(getattr(val, "shape", ()))


def _numel(shape: tuple) -> int:
    return math.prod(int(d) for d in shape)


def _matmul_flops(name: str, node: Any) -> float:
    """2*M*N*K (times the batch) from the operands' static shapes."""
    args = node.args
    if name in ("aten.addmm", "aten.baddbmm"):
        a, b = _shape(args[1]), _shape(args[2])
    else:
        a, b = _shape(args[0]), _shape(args[1])
    if name == "aten.linear":  # x (..., K) @ w (N, K)^T
        return 2.0 * _numel(a) * b[0]
    if name == "aten.dot":
        return 2.0 * a[0]
    if name == "aten.mv":
        return 2.0 * a[0] * a[1]
    # mm / bmm / matmul: (..., M, K) @ (..., K, N)
    out = _shape(node)
    return 2.0 * _numel(out) * a[-1]


def _conv_flops(node: Any) -> float:
    """2 MACs per output element per contributing kernel tap: 2 * out_elems
    * (kernel_elems / out_features), as the reference counts feature groups."""
    w, out = _shape(node.args[1]), _shape(node)
    return 2.0 * _numel(out) * max(_numel(w) // max(out[1], 1), 1)


def _fft_flops(node: Any) -> float:
    """5 N log2 N per transform over the transformed dims, times the batch."""
    x = _shape(node.args[0])
    dims = [d % len(x) for d in node.args[1]]
    n = _numel(tuple(x[d] for d in dims))
    if n == 0:
        return 0.0
    return 5.0 * (_numel(x) / n) * n * math.log2(max(n, 2))


@dataclasses.dataclass
class GraphReport:
    histogram: dict[str, int]
    dot_flops: float  # 2*M*N*K summed over the matmuls (static shapes)
    has_scan: bool
    has_while: bool
    conv_flops: float = 0.0  # convolution MACs * 2
    fft_flops: float = 0.0  # 5*N*log2(N) per transformed axis set
    #: the hand-written kernels the trace stood in for, in call order
    kernels: tuple[str, ...] = ()

    @property
    def flops(self) -> float:
        """Total counted FLOPs across matmuls, convolutions and FFTs — the
        roofline numerator."""
        return self.dot_flops + self.conv_flops + self.fft_flops


def subgraphs(gm: Any) -> list[Any]:
    """The graph modules a higher-order op's body lives in (``get_attr``
    submodules of ``gm``)."""
    return [m for _, m in gm.named_children() if isinstance(m, torch.fx.GraphModule)]


def analyze_graph(gm: Any, kernels: tuple[str, ...] = ()) -> GraphReport:
    """Histogram and FLOPs of an FX graph module (its subgraphs included)."""
    hist: Counter[str] = Counter()
    flops = {"dot": 0.0, "conv": 0.0, "fft": 0.0}

    def walk(module: Any) -> None:
        for node in module.graph.nodes:
            if node.op != "call_function":
                continue
            name = op_name(node.target)
            hist[name] += 1
            if name in _MATMULS:
                flops["dot"] += _matmul_flops(name, node)
            elif name == "aten.convolution":
                flops["conv"] += _conv_flops(node)
            elif name in _FFTS:
                flops["fft"] += _fft_flops(node)
        for sub in subgraphs(module):
            walk(sub)

    walk(gm)
    return GraphReport(
        histogram=dict(hist),
        dot_flops=flops["dot"],
        has_scan=hist.get("higher_order.scan", 0) > 0,
        has_while=hist.get("higher_order.while_loop", 0) > 0,
        conv_flops=flops["conv"],
        fft_flops=flops["fft"],
        kernels=tuple(kernels),
    )


_TORCH_DIR = os.path.dirname(torch.__file__)


class _FrameRecorder(TorchDispatchMode):
    """Notes, for each aten op of a trace, the Python frames it ran under
    (those outside torch, outermost first, by identity): what holds an
    eager run's tensors alive, a frame's locals until it returns."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: list[tuple[str, tuple[int, ...]]] = []
        self._frames: list[Any] = []  # alive to the trace's end: no id is reused

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", None) == "aten":
            chain = []
            frame = sys._getframe(1)
            while frame is not None:
                if not frame.f_code.co_filename.startswith(_TORCH_DIR):
                    chain.append(frame)
                frame = frame.f_back
            self._frames.extend(chain)
            self.ops.append((str(func.overloadpacket), tuple(id(f) for f in reversed(chain))))
        return func(*args, **(kwargs or {}))


def _attach_frames(gm: Any, ops: list[tuple[str, tuple[int, ...]]]) -> None:
    """Set each call node's ``meta["frames"]`` from the recorded ops (in
    node order; a ``getitem`` takes its producer's).  Left unset where the
    two orders disagree."""
    nodes = [n for n in gm.graph.nodes
             if n.op == "call_function" and op_name(n.target) != "_operator.getitem"]
    if [op_name(n.target) for n in nodes] != [name for name, _ in ops]:
        return
    for node, (_, frames) in zip(nodes, ops):
        node.meta["frames"] = frames
    for node in gm.graph.nodes:
        if node.op == "call_function" and "frames" not in node.meta and node.args:
            node.meta["frames"] = getattr(node.args[0], "meta", {}).get("frames", ())


def fake_mode() -> Any:
    """A fake mode for a trace: static shapes (the sizes in a trace stay
    ints; the card's torch otherwise makes them symbolic), and a shape
    environment, so a host read (``.item()``) traces as an unbacked value
    instead of failing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    return FakeTensorMode(allow_non_fake_inputs=True, shape_env=ShapeEnv(), static_shapes=True)


def trace(fn: Callable[..., Any], *example_args: Any) -> tuple[Any, tuple[str, ...]]:
    """``fn`` traced under fake tensors: (its FX graph module, the kernels
    the trace stood in for).  ``example_args`` may be real tensors (on any
    device: they are converted to fake ones, their data never read),
    fake tensors, or pytrees of them; nothing runs and no memory is
    taken.  Each call node's ``meta["frames"]`` names the Python frames
    its op ran under (:class:`_FrameRecorder`)."""
    gm, kernels = trace_with_work(fn, *example_args)
    return gm, tuple(name for name, _ in kernels)


def trace_with_work(fn: Callable[..., Any], *example_args: Any) -> tuple[Any, list]:
    """:func:`trace`, each kernel the trace stood in for as ``(name,
    build.Work)``: the work its wrapper declared."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import build

    recorder = _FrameRecorder()

    def recorded(*args: Any) -> Any:
        with recorder:
            return fn(*args)

    with build.collect_work() as kernels:
        gm = make_fx(recorded, tracing_mode="fake", _allow_non_fake_inputs=True)(*example_args)
    _attach_frames(gm, recorder.ops)
    return gm, list(kernels)


def histogram_similarity(a: dict[str, int], b: dict[str, int]) -> float:
    """Size-normalised L1 similarity between op histograms, the graph
    counterpart of Deckard vector distance: 1 for equal histograms, 0 for
    disjoint ones."""
    keys = set(a) | set(b)
    dist = sum(abs(a.get(k, 0) - b.get(k, 0)) for k in keys)
    denom = sum(a.values()) + sum(b.values())
    if denom == 0:
        return 1.0
    return 1.0 - dist / denom


def trace_report(fn: Callable[..., Any], *example_args: Any) -> GraphReport:
    return analyze_graph(*trace(fn, *example_args))


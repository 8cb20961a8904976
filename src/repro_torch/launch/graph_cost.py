"""Cost model of traced torch programs: the port's counterpart of
``repro/launch/hlo_cost.py``.

The reference re-derives FLOPs, HBM bytes and collective bytes from a
compiled XLA module's HLO text, loop-aware.  The port has no HLO: it runs
aten ops eagerly or as CUDA graphs of the same kernels, so the model
walks the aten-level FX graph of a fake ``make_fx`` trace
(``core/graph_analysis.py``; nothing runs, no memory is taken) and
builds a **node table**, one row per kernel of eager or graphed
execution:

* ``flops`` — the matmuls', convolutions' and FFTs' FLOPs with the FX
  walker's formulas (held to the reference's jaxpr counts), at the peak of
  their result's type: bf16 on the tensor cores, f32 on the CUDA cores
  (tf32 when torch allows it for matmuls); under a mesh every value is
  this device's shard, so each count is per device;
* ``bytes`` — what the kernel reads and writes, each operand and result
  once.  A view (``view``, ``t``, ``permute``, ``expand``, ``slice``,
  ``select``, ``unsqueeze``, ``as_strided``, ...) moves nothing.  An
  operand costs the elements its strides reach, not ``numel``: a (D,)
  weight broadcast over (B, S, D) reads D.  ``embedding``,
  ``index_select``, ``gather`` and ``index`` read the rows they take;
  ``index_put_``, ``scatter`` and ``copy_`` into a slice move the slice
  (the counterpart of the reference's dynamic-slice rule).  An in-place op
  reads and writes its buffer;
* ``collective`` — a ``_c10d_functional`` collective's kind and its
  result bytes (``collective_bytes``), as the reference counts them (none
  on one device; a mesh trace's ``DTensor`` redistributions and the
  manual tensor-parallel paths emit them);
* the hand-written kernels run no aten op under a trace: each wrapper
  declares its call's :class:`~repro_torch.kernels.build.Work` there, and
  each becomes a row of its own (``op`` = ``kernel.<name>``).

Python loops are unrolled by the trace, so every layer and step counts
its own rows; under ``torch.utils.checkpoint`` the backward's recompute is
in the trace and counts (it is real work).  The port's programs make no
higher-order op; one in a trace (``while_loop``, ``cond``) raises, since
its body's trip count is not in the graph: counting the body once is the
very error ``hlo_cost`` exists to avoid.

The table saves to gzip JSON and re-analyses (:func:`save_table`,
:func:`load_table`), the counterpart of the dry-run's saved HLO and
``reparse``.
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from repro_torch.core import graph_analysis as ga
from repro_torch.launch.mesh import HW, Hardware

#: ops that allocate or read metadata only
_FREE = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.sym_size", "aten.sym_stride", "aten.sym_numel",
    "aten.sym_storage_offset",
})
#: ``_c10d_functional`` op -> the reference's collective kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
#: gathers: read the rows taken, (op -> positions of the index operands)
_GATHERS = {"aten.embedding": (1,), "aten.index_select": (2,), "aten.gather": (2,),
            "aten.index": (1,)}
#: scatters: move the slice, (op -> position of the source, of the index)
_SCATTERS = {
    "aten.index_put_": (2, 1), "aten.index_put": (2, 1), "aten._index_put_impl_": (2, 1),
    "aten.scatter": (3, 2), "aten.scatter_": (3, 2), "aten.scatter_add": (3, 2),
    "aten.scatter_add_": (3, 2), "aten.scatter_reduce": (3, 2),
    "aten.scatter_reduce_": (3, 2), "aten.index_copy": (3, 2), "aten.index_copy_": (3, 2),
}


def reached_bytes(t: Any) -> int:
    """Bytes of the elements a tensor's strides reach: ``numel`` times the
    item size, less every broadcast (stride 0) dim (a ``DTensor``: of this
    device's shard)."""
    if not isinstance(t, torch.Tensor):
        return 0
    t = getattr(t, "_local_tensor", t)
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if int(size) == 0:
            return 0
        if int(stride) != 0:
            n *= int(size)
    return n * t.element_size()


def _vals(x: Any) -> list:
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _vals(item)]
    return [x] if isinstance(x, torch.Tensor) else []


def _arg_bytes(x: Any) -> int:
    """Bytes of the tensors an argument (a node, or a list of them) holds."""
    if isinstance(x, torch.fx.Node):
        return sum(reached_bytes(v) for v in _vals(x.meta.get("val")))
    if isinstance(x, (list, tuple)):
        return sum(_arg_bytes(a) for a in x)
    return 0


def _operand_bytes(node: Any) -> int:
    seen, total = set(), 0
    for a in node.all_input_nodes:
        if a not in seen:
            seen.add(a)
            total += _arg_bytes(a)
    return total


def _arg(node: Any, i: int) -> Any:
    return node.args[i] if len(node.args) > i else None


def matmul_peak(dtype: torch.dtype) -> str:
    """The peak a matmul's FLOPs on ``dtype`` run at."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bfloat16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "float32"


def _row(op: str, flops: float = 0.0, nbytes: float = 0.0, peak: str = "float32",
         passes: int = 1, collective: str | None = None,
         collective_bytes: float = 0.0) -> dict:
    return {"op": op, "flops": float(flops), "bytes": float(nbytes), "peak": peak,
            "passes": passes, "collective": collective,
            "collective_bytes": float(collective_bytes)}


def _node_row(node: Any) -> dict:
    name = ga.op_name(node.target)
    result = _arg_bytes(node)
    if name in ga.VIEW_OPS or name in _FREE:
        return _row(name)
    if name.startswith("_c10d_functional."):
        kind = _COLLECTIVES.get(name.split(".", 1)[1])
        if kind is None:  # wait_tensor and the like: no traffic of their own
            return _row(name)
        return _row(name, nbytes=result + _operand_bytes(node), collective=kind,
                    collective_bytes=result)
    if name in ga._MATMULS or name == "aten.convolution" or name in ga._FFTS:
        if name in ga._MATMULS:
            flops = ga._matmul_flops(name, node)
        elif name == "aten.convolution":
            flops = ga._conv_flops(node)
        else:
            flops = ga._fft_flops(node)
        out = _vals(node.meta.get("val"))
        peak = matmul_peak(out[0].dtype) if out else "float32"
        return _row(name, flops, result + _operand_bytes(node), peak)
    if name in _GATHERS:
        index = sum(_arg_bytes(_arg(node, i)) for i in _GATHERS[name])
        return _row(name, nbytes=2 * result + index)
    if name in _SCATTERS:
        src_i, idx_i = _SCATTERS[name]
        src, index = _arg(node, src_i), _arg(node, idx_i)
        moved = _arg_bytes(src)
        if not moved:  # a scalar source: the indexed elements of self
            dst = _vals(_arg(node, 0).meta.get("val"))
            idx = _vals(index.meta.get("val")) if isinstance(index, torch.fx.Node) else []
            moved = idx[0].numel() * dst[0].element_size() if dst and idx else 0
        return _row(name, nbytes=2 * moved + _arg_bytes(index))
    if name == "aten.index_add_" or name == "aten.index_add":
        return _row(name, nbytes=3 * _arg_bytes(_arg(node, 3)) + _arg_bytes(_arg(node, 2)))
    if name == "aten.copy_":  # writes dst, reads src: dst is not read
        return _row(name, nbytes=_arg_bytes(_arg(node, 0)) + _arg_bytes(_arg(node, 1)))
    return _row(name, nbytes=result + _operand_bytes(node))


def _graph_rows(gm: Any) -> list[dict]:
    rows = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = ga.op_name(node.target)
        if name.startswith("higher_order."):
            raise ValueError(
                f"graph_cost: {name} states no trip count of its body; counting it once "
                "would undercount it"
            )
        rows.append(_node_row(node))
    return rows


def node_table(gm: Any, kernels: Iterable = ()) -> list[dict]:
    """One row per kernel of the traced program ``gm``, then one per
    hand-written kernel the trace stood in for (``(name, Work)`` pairs,
    :func:`repro_torch.core.graph_analysis.trace_with_work`)."""
    rows = _graph_rows(gm)
    for name, work in kernels:
        rows.append(_row(f"kernel.{name}", work.flops, work.bytes, work.peak, work.passes))
    return rows


def abstract(tree: Any, mode: Any = None) -> Any:
    """``tree`` with every real tensor replaced by a fake one of its shape,
    dtype and device (one fake mode for the whole tree); fake tensors and
    other leaves as they are.  No memory is taken."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_map

    mode = mode or ga.fake_mode()

    def leaf(x: Any) -> Any:
        if isinstance(x, torch.Tensor) and not isinstance(x, FakeTensor):
            return mode.from_tensor(x)
        return x

    return tree_map(leaf, tree)


def trace_table(fn: Callable[..., Any], *example_args: Any) -> list[dict]:
    """The node table of ``fn`` on ``example_args`` (real tensors, on any
    device, are made fake first: nothing runs and no memory is taken)."""
    return node_table(*ga.trace_with_work(fn, *abstract(example_args)))


def analyze(table: Iterable[dict]) -> dict:
    """The reference's keys (``flops``, ``hbm_bytes``, ``collectives``,
    ``collective_bytes``) summed over a node table, and
    ``flops_by_peak``: the FLOPs each peak executes (a 3xTF32 product
    counted three times), which the roofline divides by that peak."""
    flops = hbm = 0.0
    collectives: dict[str, float] = defaultdict(float)
    by_peak: dict[str, float] = defaultdict(float)
    for r in table:
        flops += r["flops"]
        hbm += r["bytes"]
        by_peak[r["peak"]] += r["flops"] * r["passes"]
        if r["collective"]:
            collectives[r["collective"]] += r["collective_bytes"]
    return {
        "flops": flops,
        "hbm_bytes": hbm,
        "collectives": dict(collectives),
        "collective_bytes": sum(collectives.values()),
        "flops_by_peak": {k: v for k, v in by_peak.items() if v},
    }


def roofline(cost: dict, hw: Hardware = HW) -> tuple[float, str]:
    """``(seconds, bound_by)``: the larger of the compute time (each peak's
    FLOPs at that peak) and the HBM time, and which it is."""
    t_compute = sum(f / hw.peak(p) for p, f in cost["flops_by_peak"].items())
    t_memory = cost["hbm_bytes"] / hw.hbm_bw
    if t_compute >= t_memory:
        return max(t_compute, 1e-12), "operations"
    return max(t_memory, 1e-12), "bytes"


def save_table(table: list[dict], path: "str | Path") -> None:
    """The node table as gzip JSON."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(gzip.compress(json.dumps(table).encode()))


def load_table(path: "str | Path") -> list[dict]:
    return json.loads(gzip.decompress(Path(path).read_bytes()).decode())

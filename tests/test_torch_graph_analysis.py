"""``repro_torch.core.graph_analysis`` (the FX walker) against
``repro.core.jaxpr_analysis``: the FLOPs of the same programs counted from
a fake ``make_fx`` trace and from a jaxpr, the op histogram, and the
kernels a trace of a CUDA program stands in for.  CPU only.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import jaxpr_analysis as ja
from repro.kernels import ops as jops
from repro_torch.core import graph_analysis as ga
from repro_torch.kernels import ops, rmsnorm


def _spec(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


PROGRAMS = {
    # name: (torch fn, jax fn, operand shapes)
    "mm": (lambda x, w: torch.tanh(x @ w), lambda x, w: jnp.tanh(x @ w), [(8, 16), (16, 4)]),
    "bmm": (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
            lambda a, b: jnp.einsum("bij,bjk->bik", a, b), [(3, 8, 16), (3, 16, 5)]),
    "linear_bias": (lambda x, w, b: torch.nn.functional.linear(x, w, b),
                    lambda x, w, b: x @ w.T + b, [(2, 7, 16), (12, 16), (12,)]),
    "chain": (lambda x, w: (x @ w @ w).sum(), lambda x, w: (x @ w @ w).sum(), [(32, 32), (32, 32)]),
}


@pytest.mark.parametrize("name", PROGRAMS)
def test_dot_flops_equal_the_references(name):
    fn, jfn, shapes = PROGRAMS[name]
    ours = ga.trace_report(fn, *(torch.empty(s) for s in shapes))
    theirs = ja.trace_report(jfn, *(_spec(*s) for s in shapes))
    assert ours.dot_flops == theirs.dot_flops > 0
    assert not ours.has_scan and not ours.has_while


def test_matmul_block_dot_flops_equal_the_references():
    ours = ga.trace_report(lambda a, b: ops.matmul(a, b, backend="torch"),
                           torch.empty(96, 160), torch.empty(160, 64))
    theirs = ja.trace_report(lambda a, b: jops.matmul(a, b, backend="xla"),
                             _spec(96, 160), _spec(160, 64))
    assert ours.dot_flops == theirs.dot_flops == 2 * 96 * 160 * 64


def test_conv_and_fft_flops_equal_the_references():
    ours = ga.trace_report(lambda x, k: torch.nn.functional.conv2d(x, k, padding=1),
                           torch.empty(1, 3, 8, 8), torch.empty(4, 3, 3, 3))
    theirs = ja.trace_report(
        lambda x, k: jax.lax.conv_general_dilated(x, k, (1, 1), "SAME"),
        _spec(1, 3, 8, 8), _spec(4, 3, 3, 3))
    assert ours.conv_flops == theirs.conv_flops == 2 * 256 * 27
    ours = ga.trace_report(torch.fft.fft2, torch.empty(2, 16, 32, dtype=torch.complex64))
    theirs = ja.trace_report(jnp.fft.fft2, _spec(2, 16, 32, dtype=jnp.complex64))
    assert ours.fft_flops == pytest.approx(theirs.fft_flops, rel=1e-12)
    assert ours.flops == ours.fft_flops > 0


#: the zoo cells' matmul FLOPs against the reference's: attention-family
#: cells count the same products (to rounding); mamba2's SSD terms are
#: formed by other einsums (the port's plain chunk terms against the
#: reference's XLA path), 3.4% fewer at decode, 0.2% at prefill
CELL_TOL = {"llama3.2-1b": 1e-9, "deepseek-v2-236b": 1e-9, "mamba2-2.7b": 0.05}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", list(CELL_TOL))
def test_zoo_cell_dot_flops_within_tolerance(arch, kind):
    from repro.offload import zoo as jzoo
    from repro_torch.offload import zoo as tzoo

    kw = dict(reduced=True, layers=1, batch=1, seq=8, seed=0)
    builder, args, _ = tzoo._cell_target(arch, kind, device="cpu", **kw)
    jbuilder, jargs, _ = jzoo._cell_target(arch, kind, **kw)
    ours = ga.trace_report(builder(), *args)
    theirs = ja.trace_report(jbuilder(), *jargs)
    assert ours.dot_flops == pytest.approx(theirs.dot_flops, rel=CELL_TOL[arch])
    assert ours.histogram.get("aten.mm", 0) > 0


def test_trace_notes_the_kernels_of_a_cuda_program():
    """A CUDA program's trace runs no kernel: each wrapper's abstract call
    is noted in the report's ``kernels`` (its aten ops are only the
    allocations)."""
    def prog(x, w):
        return rmsnorm.rmsnorm(x, w, delta=x)[1] @ torch.ones(64, 64, device=x.device,
                                                             dtype=x.dtype)

    with FakeTensorMode():
        x = torch.empty(2, 8, 64, device="cuda", dtype=torch.bfloat16)
        w = torch.empty(64, device="cuda")
    report = ga.trace_report(prog, x, w)
    assert report.kernels == ("rmsnorm",)
    assert report.dot_flops == 2 * 16 * 64 * 64
    assert "aten.empty_like" in report.histogram or "aten.empty" in report.histogram


def test_trace_notes_each_op_under_its_python_frames():
    """Each call node carries the Python frames its op ran under: what the
    memory walk holds a local by."""
    def inner(x):
        return x * 2

    def outer(x):
        return inner(x) + inner(x)

    gm, _ = ga.trace(outer, torch.empty(4))
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    frames = [n.meta["frames"] for n in calls]
    assert len(frames) == 3 and frames[0][-1] != frames[1][-1]  # two calls of inner
    assert frames[0][:-1] == frames[1][:-1] == frames[2]  # under outer

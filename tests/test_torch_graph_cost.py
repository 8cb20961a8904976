"""``repro_torch.launch.graph_cost`` (the node table of a fake trace)
against ``repro.launch.hlo_cost`` (compiled HLO): FLOPs of dot programs
and of a loop against ``lax.scan``, the bytes of one matmul and of a chain
XLA fuses, the rules for views, broadcasts and gathers, every kernel
stand-in's declared work, collectives, and the saved table.  CPU only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo_cost
from repro_torch.kernels import attention, fft, matmul, paged_attention, rmsnorm, ssd
from repro_torch.launch import graph_cost
from repro_torch.launch.mesh import HW


def _ours(fn, *shapes):
    return graph_cost.analyze(graph_cost.trace_table(fn, *(torch.empty(s) for s in shapes)))


def _theirs(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


DOTS = {
    "mm": (lambda a, b: a @ b, lambda a, b: a @ b, [(64, 128), (128, 32)]),
    "bmm": (lambda a, b: torch.einsum("bij,bjk->bik", a, b),
            lambda a, b: jnp.einsum("bij,bjk->bik", a, b), [(3, 8, 16), (3, 16, 5)]),
    "einsum_contract2": (lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b),
                         lambda a, b: jnp.einsum("bhqd,bhkd->bhqk", a, b),
                         [(2, 4, 16, 8), (2, 4, 12, 8)]),
    "chain": (lambda x, w: (x @ w) @ w, lambda x, w: (x @ w) @ w, [(32, 32), (32, 32)]),
}


@pytest.mark.parametrize("name", DOTS)
def test_dot_flops_equal_hlo_cost(name):
    fn, jfn, shapes = DOTS[name]
    assert _ours(fn, *shapes)["flops"] == _theirs(jfn, *shapes)["flops"] > 0


def test_python_loop_counts_as_lax_scan():
    """Five 64^3 f32 matmuls: the trace unrolls the loop, hlo_cost
    multiplies the while body by its trip count."""
    def loop(x):
        for _ in range(5):
            x = x @ x
        return x

    def scan(x):
        return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=5)[0]

    ours, theirs = _ours(loop, (64, 64)), _theirs(scan, (64, 64))
    assert ours["flops"] == theirs["flops"] == 2_621_440


def test_one_matmul_bytes_equal_and_a_fused_chain_counts_at_least_xla():
    fn, jfn, shapes = DOTS["mm"]
    ours, theirs = _ours(fn, *shapes), _theirs(jfn, *shapes)
    assert ours["hbm_bytes"] == theirs["hbm_bytes"] == 57_344
    # tanh(x @ w) * 2 + 1: XLA fuses the elementwise tail into one kernel,
    # eager runs each op apart
    chain = (lambda x, w: torch.tanh(x @ w) * 2 + 1, lambda x, w: jnp.tanh(x @ w) * 2 + 1)
    ours = _ours(chain[0], (64, 128), (128, 32))
    theirs = _theirs(chain[1], (64, 128), (128, 32))
    assert ours["hbm_bytes"] >= theirs["hbm_bytes"]
    assert ours["flops"] == theirs["flops"]


def test_views_cost_nothing_and_a_broadcast_reads_its_storage():
    x = torch.empty(64, 64)
    table = graph_cost.trace_table(
        lambda x: x.t().unsqueeze(0).expand(3, 64, 64).permute(0, 2, 1)[:, :2].select(0, 1), x)
    assert {r["op"] for r in table} >= {"aten.t", "aten.expand", "aten.permute"}
    assert all(r["bytes"] == 0 for r in table)
    # a (D,) weight over (B, S, D): reads D, not B*S*D
    (row,) = graph_cost.trace_table(lambda y, w: y * w, torch.empty(4, 8, 16), torch.empty(16))
    assert row["bytes"] == 4 * (2 * 4 * 8 * 16 + 16)
    (row,) = [r for r in graph_cost.trace_table(
        lambda y, w: y * w.expand(4, 8, 16), torch.empty(4, 8, 16), torch.empty(16))
        if r["op"] == "aten.mul"]
    assert row["bytes"] == 4 * (2 * 4 * 8 * 16 + 16)


def test_embedding_and_gathers_count_rows_scatters_the_slice():
    table = torch.empty(1000, 16)
    tok = torch.zeros(2, 3, dtype=torch.int64)
    (row,) = graph_cost.trace_table(lambda e, t: torch.nn.functional.embedding(t, e), table, tok)
    assert row["bytes"] == 2 * (2 * 3 * 16 * 4) + 6 * 8  # rows read and written, ids read
    rows = graph_cost.trace_table(lambda e, i: e.index_select(0, i), table,
                                  torch.zeros(5, dtype=torch.int64))
    assert rows[-1]["bytes"] == 2 * 5 * 16 * 4 + 5 * 8

    def put(e, i, v):
        e.index_put_((i,), v)
        return e

    rows = graph_cost.trace_table(put, table, torch.zeros(5, dtype=torch.int64),
                                  torch.empty(5, 16))
    assert sum(r["bytes"] for r in rows) == 2 * 5 * 16 * 4 + 5 * 8

    def copy_in(e, v):
        e[10:15].copy_(v)
        return e

    rows = graph_cost.trace_table(copy_in, table, torch.empty(5, 16))
    assert sum(r["bytes"] for r in rows) == 2 * 5 * 16 * 4


def test_inplace_reads_and_writes_its_buffer():
    def f(x, y):
        return x.add_(y)

    (row,) = graph_cost.trace_table(f, torch.empty(32), torch.empty(32))
    assert row["bytes"] == 3 * 32 * 4


def test_while_loop_raises():
    """A loop whose trip count the graph does not state is refused, never
    counted once."""
    from torch._higher_order_ops.while_loop import while_loop
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x, i):
        return while_loop(lambda x, i: i < 3, lambda x, i: (x @ x, i + 1), (x, i))

    gm = make_fx(f, tracing_mode="fake")(torch.empty(8, 8), torch.zeros((), dtype=torch.int64))
    assert any(r == "higher_order.while_loop" for r in
               (graph_cost.ga.op_name(n.target) for n in gm.graph.nodes if n.op == "call_function"))
    with pytest.raises(ValueError, match="trip count"):
        graph_cost.node_table(gm)


# -- kernel stand-ins: each counts its declared work ------------------------------------


def _stand_ins():
    """(kernel, call on tensors made by ``t(shape, dtype)``, its Work from
    the same tensors)."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def flash(t):
        q, k, v = t((1, 4, 16, 64), bf), t((1, 2, 16, 64), bf), t((1, 2, 16, 64), bf)
        return attention.flash_attention(q, k, v), attention.flash_work(q, k, v)

    def flash_bwd(t):
        q, k, v = t((1, 4, 16, 64), bf), t((1, 2, 16, 64), bf), t((1, 2, 16, 64), bf)
        out = attention.flash_attention_bwd(q, k, v, t((1, 4, 16, 64), bf), t((1, 4, 16), f32),
                                            t((1, 4, 16, 64), bf))
        return out, attention.flash_bwd_work(q, k, v)

    def paged(t):
        q, kp, vp, pages = t((2, 4, 1, 64), bf), t((9, 2, 4, 64), bf), t((9, 2, 4, 64), bf), \
            t((2, 4), i32)
        out = paged_attention.paged_attention(q, kp, vp, pages, t((2,), i32))
        return out, paged_attention.paged_work(q, kp, vp, pages)

    def norm(t):
        x, w = t((2, 8, 64), bf), t((64,), f32)
        return rmsnorm.rmsnorm(x, w), rmsnorm.norm_work("plain", x, w)

    def norm_add(t):
        x, w = t((2, 8, 64), bf), t((64,), f32)
        return rmsnorm.rmsnorm(x, w, delta=t((2, 8, 64), bf)), rmsnorm.norm_work("add", x, w)

    def norm_gated(t):
        z, w, d = t((1, 4, 16), bf), t((16,), f32), t((2,), f32)
        out = rmsnorm.rmsnorm(t((1, 4, 2, 8), f32), w, gate=(t((1, 4, 2, 8), bf), d, z))
        return out, rmsnorm.norm_work("gated", z, w, d)

    def norm_bwd(t):
        x, w = t((2, 8, 64), bf), t((64,), f32)
        return rmsnorm.rmsnorm_bwd(x, t((2, 8, 64), bf), w), rmsnorm.norm_bwd_work(x, w)

    def mm(t):
        out = matmul.matmul(t((128, 128), f32), t((128, 128), f32))
        return out, matmul.matmul_work(128, 128, 128)

    def schur(t):
        out = matmul.schur_update(t((128, 128), f32), t((128, 128), f32), t((128, 128), f32))
        return out, matmul.schur_work(128, 128, 128)

    def cmm(t):
        out = fft.complex_matmul(*(t((128, 128), f32) for _ in range(4)))
        return out, fft.complex_matmul_work(128, 128, 128)

    def ssd_chunks(t):
        x = t((1, 32, 2, 8), bf)
        out = ssd.ssd_chunks(x, t((1, 32, 2), f32), t((2,), f32), t((1, 32, 16), bf),
                             t((1, 32, 16), bf), chunk=16)
        return out, ssd.ssd_work(x, 16, 16)

    return [("flash_attention", flash), ("flash_attention_bwd", flash_bwd),
            ("paged_attention", paged), ("rmsnorm", norm), ("rmsnorm", norm_add),
            ("rmsnorm", norm_gated), ("rmsnorm_bwd", norm_bwd), ("matmul", mm),
            ("schur_update", schur), ("complex_matmul", cmm), ("ssd_chunks", ssd_chunks)]


STAND_INS = _stand_ins()


def test_every_kernel_has_a_stand_in():
    from repro_torch import kernels

    assert {name for name, _ in STAND_INS} == set(kernels.KERNELS)


@pytest.mark.parametrize("name,call", STAND_INS, ids=[c.__name__ for _, c in STAND_INS])
def test_stand_in_counts_its_declared_work(name, call):
    """A CUDA program's trace runs no kernel; its row is the work the
    wrapper declares, never 0, and the roofline divides its FLOPs by the
    declared peak (3xTF32: three passes)."""
    with FakeTensorMode():
        work = call(lambda shape, dtype: torch.empty(shape, dtype=dtype, device="cuda"))[1]
        args = ()
    table = graph_cost.trace_table(
        lambda: call(lambda shape, dtype: torch.empty(shape, dtype=dtype, device="cuda"))[0],
        *args)
    (row,) = [r for r in table if r["op"].startswith("kernel.")]
    assert row["op"] == f"kernel.{name}"
    assert (row["flops"], row["bytes"], row["peak"], row["passes"]) == (
        work.flops, work.bytes, work.peak, work.passes)
    assert row["flops"] > 0 and row["bytes"] > 0
    cost = graph_cost.analyze(table)
    assert cost["flops_by_peak"][work.peak] >= work.flops * work.passes


def test_paged_work_counts_full_context_without_lengths():
    q = torch.empty(2, 4, 1, 64, dtype=torch.bfloat16)
    pool = torch.empty(9, 2, 4, 64, dtype=torch.bfloat16)
    pages = torch.empty(2, 4, dtype=torch.int32)
    full = paged_attention.paged_work(q, pool, pool.clone(), pages)
    assert full == paged_attention.paged_work(q, pool, pool.clone(), pages, [16, 16])
    short = paged_attention.paged_work(q, pool, pool.clone(), pages, [3, 0])
    assert short.flops < full.flops and short.bytes < full.bytes
    # one pool as keys and values (MLA's latent) is read once
    assert paged_attention.paged_work(q, pool, pool, pages).bytes < full.bytes


# -- collectives and the saved table -----------------------------------------------------


def test_hand_made_all_reduce_counts_its_bytes_and_the_table_round_trips(tmp_path):
    mm = {"op": "aten.mm", "flops": 1e6, "bytes": 4e3, "peak": "bfloat16", "passes": 1,
          "collective": None, "collective_bytes": 0.0}
    table = [mm, dict(mm), {"op": "_c10d_functional.all_reduce", "flops": 0.0,
                            "bytes": 2 * 8192.0, "peak": "float32", "passes": 1,
                            "collective": "all-reduce", "collective_bytes": 8192.0}]
    cost = graph_cost.analyze(table)
    assert cost["collectives"] == {"all-reduce": 8192.0}
    assert cost["collective_bytes"] == 8192.0
    assert cost["flops"] == 2e6 and cost["hbm_bytes"] == 8e3 + 16384
    path = tmp_path / "t.nodes.json.gz"
    graph_cost.save_table(table, path)
    assert graph_cost.load_table(path) == table
    assert graph_cost.analyze(graph_cost.load_table(path)) == cost
    seconds, by = graph_cost.roofline(cost, HW)
    assert by == "bytes" and seconds == pytest.approx(cost["hbm_bytes"] / HW.hbm_bw)


def test_traced_table_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    table = graph_cost.trace_table(lambda x: torch.relu(x @ x).sum(), x)
    graph_cost.save_table(table, tmp_path / "a.json.gz")
    assert graph_cost.analyze(graph_cost.load_table(tmp_path / "a.json.gz")) == \
        graph_cost.analyze(table)

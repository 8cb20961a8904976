"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels cannot run here (no card, no nvcc): their wrappers take
the plain PyTorch version for CPU tensors, and ``chip_smoke.py`` holds each
kernel against that plain version on the card.  These tests hold the plain
versions (and the page plumbing) against the reference: the Pallas kernel
in interpret mode, its XLA/ref target, and a float64 oracle.  Inputs are
made from a seed with numpy and fed to both sides.

Tolerances: 1e-5 in f32 against the reference's ``xla``/``ref`` targets
(the same f32 formulas, summed in another order); 1e-4 against Pallas
interpret mode (an online softmax over blocks, another order again); bf16
outputs one bf16 rounding step apart (2^-8 relative), since both sides
compute in f32 and round once.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels.attention import flash_attention_pallas
from repro.kernels.ref import attention_ref as jattention_ref
from repro.kernels.ref import rmsnorm_ref as jrmsnorm_ref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch.core import blocks
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import build, launch_counts, ref as tref
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import rmsnorm as trms

BF16_RTOL = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# -- paged attention ---------------------------------------------------------------


def _paged_case(rng, *, b, h, kh, s, dk, dv, ps, mp, lengths, dr=0):
    """Shuffled page tables with per-slot lengths; entries past the pages a
    slot needs point at the null page, whose contents are poisoned."""
    n_pages = b * mp
    null = n_pages
    k_pool = rng.standard_normal((n_pages + 1, kh, ps, dk)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages + 1, kh, ps, dv)).astype(np.float32)
    k_pool[null] = 1e6  # poison: masked rows must never contribute
    v_pool[null] = 1e6
    pages = rng.permutation(n_pages).astype(np.int32).reshape(b, mp)
    for i, ln in enumerate(lengths):
        pages[i, -(-(ln + s) // ps):] = null
    case = {
        "q": rng.standard_normal((b, h, s, dk)).astype(np.float32),
        "k_pool": k_pool,
        "v_pool": v_pool,
        "pages": pages,
        "index": np.asarray(lengths, np.int32),
    }
    if dr:
        kr_pool = rng.standard_normal((n_pages + 1, 1, ps, dr)).astype(np.float32)
        kr_pool[null] = 1e6
        case["q_rope"] = rng.standard_normal((b, h, s, dr)).astype(np.float32)
        case["kr_pool"] = kr_pool
        case["scale"] = 1.0 / float(np.sqrt(dk + dr))
    return case


def _sides(case, dtype=np.float32):
    jx, th = {}, {}
    for k, v in case.items():
        if isinstance(v, np.ndarray) and v.dtype == np.float32:
            jx[k] = jnp.asarray(v).astype(dtype)
            th[k] = _t(v).to(torch.bfloat16 if dtype != np.float32 else torch.float32)
        elif isinstance(v, np.ndarray):
            jx[k], th[k] = jnp.asarray(v), _t(v)
        else:
            jx[k] = th[k] = v
    return jx, th


# (s, lengths) with ps=8, mp=4: empty history, a write landing on a page
# boundary, the final table slot, extend chunks crossing a page boundary
GQA_CASES = [(1, (15, 8)), (1, (0, 31)), (4, (12, 0)), (4, (6, 20))]


@pytest.mark.parametrize("s,lengths", GQA_CASES)
def test_paged_attention_gqa_matches_reference(s, lengths, rng):
    case = _paged_case(rng, b=2, h=4, kh=2, s=s, dk=32, dv=32, ps=8, mp=4, lengths=lengths)
    jx, th = _sides(case)
    got = tpa.paged_attention_torch(**th).numpy()
    np.testing.assert_allclose(got, np.asarray(jpa.paged_attention_xla(**jx)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_attention_pallas(**jx, interpret=True)), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("s,lengths", [(1, (15, 8)), (4, (6, 20))])
def test_paged_attention_mla_operands_match_reference(s, lengths, rng):
    case = _paged_case(
        rng, b=2, h=4, kh=1, s=s, dk=32, dv=32, ps=8, mp=4, lengths=lengths, dr=16
    )
    jx, th = _sides(case)
    got = tpa.paged_attention_torch(**th).numpy()
    np.testing.assert_allclose(got, np.asarray(jpa.paged_attention_xla(**jx)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_attention_pallas(**jx, interpret=True)), rtol=1e-4, atol=1e-4
    )


def test_paged_attention_partial_final_page_and_bf16(rng):
    # mp * ps leaves the final page partially filled at the longest length
    case = _paged_case(rng, b=2, h=4, kh=2, s=1, dk=32, dv=32, ps=8, mp=3, lengths=(17, 23))
    jx, th = _sides(case)
    np.testing.assert_allclose(
        tpa.paged_attention_torch(**th).numpy(),
        np.asarray(jpa.paged_attention_pallas(**jx, interpret=True)), rtol=1e-4, atol=1e-4,
    )
    case["k_pool"][-1] = case["v_pool"][-1] = 100.0  # finite in bf16
    jx, th = _sides(case, jnp.bfloat16)
    got = tpa.paged_attention_torch(**th)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got), _np(jpa.paged_attention_xla(**jx)), rtol=BF16_RTOL, atol=1e-2
    )


def test_paged_attention_wrapper_uses_plain_version_on_cpu(rng):
    case = _paged_case(rng, b=2, h=4, kh=2, s=1, dk=16, dv=16, ps=4, mp=4, lengths=(3, 9))
    _, th = _sides(case)
    before = launch_counts()
    assert torch.equal(tpa.paged_attention(**th), tpa.paged_attention_torch(**th))
    assert torch.equal(
        blocks.call("paged_attention", th["q"], th["k_pool"], th["v_pool"], th["pages"], th["index"]),
        tpa.paged_attention_torch(th["q"], th["k_pool"], th["v_pool"], th["pages"], th["index"]),
    )
    assert launch_counts() == before  # no kernel ran


# -- paged attention: the split kernel's split / partial / merge algebra ---------------

#: SMs the planner is given off the card (an H100's)
SMS = 132
#: (positions a group scores at a time, position groups a CTA): the CUDA
#: kernel picks its own at launch (8-32 positions, 1-4 groups), which
#: chip_smoke.py's phase 2 holds on the card; these span that range
TILINGS = [(4, 4), (8, 1), (16, 2)]


def _split_merge_algebra(q, k_pool, v_pool, pages, index, *, q_rope=None, kr_pool=None,
                         scale=None, plan, sub, groups):
    """The algebra of ``csrc/paged_attention.cu`` in plain f32 torch, at a
    given split plan and tiling: in each split a CTA runs (its first
    position at or before its slot's last query position; the others exit
    at once), group g walks sub-tiles g, g + groups, ... of ``sub``
    positions through the online softmax with the re-mask, leaving a
    partial (m, l, acc) per row; then the merge of every (split, group)
    partial of the splits that ran, with the l == 0 -> 1 guard.  It holds
    the split-and-merge arithmetic, not the kernel's own tiling.  Returns
    the output and what the walk met, for the coverage checks."""
    b, h, s, dk = q.shape
    _, kh, ps, _ = k_pool.shape
    dv = v_pool.shape[-1]
    mp = pages.shape[1]
    g = h // kh
    dr = q_rope.shape[-1] if q_rope is not None else 0
    if scale is None:
        scale = 1.0 / dk ** 0.5
    split_len, cap = plan.pages_per_split * ps, ps * mp
    rows = q.float().reshape(b, kh, g * s, dk)  # row r <-> (g = r // S, s = r % S)
    rrows = q_rope.float().reshape(b, kh, g * s, dr) if dr else None
    out = torch.zeros(b, kh, g * s, dv)
    met = {"splits_past_slot": 0, "empty_row_partials": 0, "split_ends_at_table_end": 0,
           "chunk_crosses_split": 0, "n_splits": plan.n_splits, "partials": 0}
    for bi in range(b):
        base = int(index[bi])
        n_pos = min(base + s, cap)  # the slot's last row attends these
        ran = -(-n_pos // split_len)
        met["splits_past_slot"] += plan.n_splits - ran
        qpos = base + torch.arange(g * s) % s
        if s > 1 and base // split_len != (base + s - 1) // split_len:
            met["chunk_crosses_split"] += 1
        for k in range(kh):
            parts = []
            for sp in range(ran):
                pos0, pos1 = sp * split_len, min((sp + 1) * split_len, n_pos)
                met["split_ends_at_table_end"] += pos1 == cap
                for grp in range(groups):
                    m, l, acc = torch.full((g * s,), -1e30), torch.zeros(g * s), torch.zeros(g * s, dv)
                    for t0 in range(pos0 + grp * sub, pos1, groups * sub):
                        t = torch.arange(t0, min(t0 + sub, pos1))
                        pg, row = pages[bi, t // ps].long(), t % ps
                        sc = rows[bi, k] @ k_pool[pg, k, row].float().T
                        if dr:
                            sc = sc + rrows[bi, k] @ kr_pool[pg, 0, row].float().T
                        valid = t[None, :] <= qpos[:, None]
                        sc = torch.where(valid, sc * scale, torch.tensor(-1e30))
                        m_new = torch.maximum(m, sc.max(dim=1).values)
                        p = torch.where(valid, torch.exp(sc - m_new[:, None]), torch.tensor(0.0))
                        alpha = torch.exp(m - m_new)
                        l = l * alpha + p.sum(dim=1)
                        acc = acc * alpha[:, None] + p @ v_pool[pg, k, row].float()
                        m = m_new
                    met["empty_row_partials"] += int((l == 0).sum())
                    parts.append((m, l, acc))
            met["partials"] = max(met["partials"], len(parts))
            # the merge kernel
            ms = torch.stack([m for m, _, _ in parts])
            w = torch.exp(ms - ms.max(dim=0).values)
            l = (torch.stack([lp for _, lp, _ in parts]) * w).sum(dim=0)
            acc = (torch.stack([ap for _, _, ap in parts]) * w[:, :, None]).sum(dim=0)
            out[bi, k] = acc / torch.where(l == 0, torch.tensor(1.0), l)[:, None]
    return out.reshape(b, h, s, dv).to(q.dtype), met


#: planner knobs for the small cases (ps=8, mp=4): one page a split, and
#: the planner's own minimums (which give one split)
SMALL_SPLITS = {
    "page_splits": dict(ctas_per_sm=10_000, min_positions=1, min_elems=1),
    "planner": {},
}


def _small_plan(plan, th):
    b, h, _, dk = th["q"].shape
    _, kh, ps, dv = th["v_pool"].shape
    return tpa.split_plan(b, kh, th["pages"].shape[1], ps, dk, dv, SMS, **SMALL_SPLITS[plan])


def _hold_split_algebra(jx, th, plan, sub, groups):
    got, met = _split_merge_algebra(**th, plan=plan, sub=sub, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpa.paged_attention_xla(**jx)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpa.paged_attention_pallas(**jx, interpret=True)),
        rtol=1e-4, atol=1e-4,
    )
    return met


@pytest.mark.parametrize("sub,groups", TILINGS)
@pytest.mark.parametrize("plan", sorted(SMALL_SPLITS))
@pytest.mark.parametrize("s,lengths", GQA_CASES)
def test_paged_split_arithmetic_matches_reference_gqa(s, lengths, plan, sub, groups, rng):
    case = _paged_case(rng, b=2, h=4, kh=2, s=s, dk=32, dv=32, ps=8, mp=4, lengths=lengths)
    jx, th = _sides(case)
    split = _small_plan(plan, th)
    met = _hold_split_algebra(jx, th, split, sub, groups)
    assert met["n_splits"] == (4 if plan == "page_splits" else 1)


@pytest.mark.parametrize("sub,groups", TILINGS)
@pytest.mark.parametrize("plan", sorted(SMALL_SPLITS))
@pytest.mark.parametrize("s,lengths", [(1, (15, 8)), (4, (6, 20))])
def test_paged_split_arithmetic_matches_reference_mla(s, lengths, plan, sub, groups, rng):
    case = _paged_case(
        rng, b=2, h=4, kh=1, s=s, dk=32, dv=32, ps=8, mp=4, lengths=lengths, dr=16
    )
    jx, th = _sides(case)
    _hold_split_algebra(jx, th, _small_plan(plan, th), sub, groups)


def test_paged_split_cases_cover_the_edges(rng):
    """Across GQA_CASES at one page a split: a slot of length 0, splits
    wholly past a slot, a split that ends at the table's last page, an S=4
    chunk across a split boundary, and rows whose share of a split that
    ran is empty (m = -1e30, l = 0 merged in)."""
    total = dict.fromkeys(("splits_past_slot", "empty_row_partials",
                           "split_ends_at_table_end", "chunk_crosses_split"), 0)
    for s, lengths in GQA_CASES:
        case = _paged_case(rng, b=2, h=4, kh=2, s=s, dk=32, dv=32, ps=8, mp=4, lengths=lengths)
        th = _sides(case)[1]
        _, met = _split_merge_algebra(**th, plan=_small_plan("page_splits", th), sub=4, groups=4)
        for key in total:
            total[key] += met[key]
    assert 0 in {ln for _, lengths in GQA_CASES for ln in lengths}
    assert all(n > 0 for n in total.values()), total


@pytest.mark.parametrize("s,lengths", [(1, (1023, 0, 700)), (4, (1020, 126, 0))])
def test_paged_split_arithmetic_at_the_planners_own_splits(s, lengths, rng):
    """A 64-page table (1024 positions) at small head dims: the planner's
    own plan splits it (8 splits of 8 pages of 16); 1023 + 1 and 1020 + 4
    end at the table's last position, 126..129 crosses a split boundary."""
    case = _paged_case(rng, b=3, h=4, kh=2, s=s, dk=32, dv=32, ps=16, mp=64, lengths=lengths)
    jx, th = _sides(case)
    plan = tpa.split_plan(3, 2, 64, 16, 32, 32, SMS)
    got, met = _split_merge_algebra(**th, plan=plan, sub=32, groups=4)
    assert met["n_splits"] == 8 and met["splits_past_slot"] > 0
    assert met["split_ends_at_table_end"] > 0 and (s == 1 or met["chunk_crosses_split"] > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpa.paged_attention_xla(**jx)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("knobs", [{}, dict(min_positions=1, min_elems=1)])
def test_paged_split_arithmetic_on_a_table_past_4096_pages(knobs, rng):
    """5000 pages of one position: the planner's own plan walks 512 pages
    a split (more page ids than a CTA has threads) in 10 splits; with its
    minimums at 1 it takes 264 splits of 19 pages (4 CTAs on each of 132
    SMs over 2 slots), up to 1052 partials a row for the merge.  Held against
    the reference's XLA path."""
    case = _paged_case(rng, b=2, h=2, kh=1, s=1, dk=8, dv=8, ps=1, mp=5000, lengths=(4990, 1500))
    jx, th = _sides(case)
    plan = tpa.split_plan(2, 1, 5000, 1, 8, 8, SMS, **knobs)
    assert plan == ((512, 10) if not knobs else (19, 264))
    got, met = _split_merge_algebra(**th, plan=plan, sub=32, groups=4)
    assert met["partials"] == 4 * -(-4991 // plan.pages_per_split)  # the longest slot's
    np.testing.assert_allclose(got.numpy(), np.asarray(jpa.paged_attention_xla(**jx)),
                               rtol=1e-4, atol=1e-4)


def test_paged_split_planner_covers_the_table_from_shapes_alone():
    """Every position of max_pages * page_size falls in exactly one split,
    for tables of any length (past 4096 pages too); llama3.2-1b's and
    zamba2-7b's decode (B=8, KH=8 / 32, 64 pages of 16) get at least two
    CTAs per SM; the planner takes only shapes (ints), and the wrapper
    reads no value of ``index`` or ``pages`` on the host."""
    import inspect

    for b, kh, mp, ps, dk, dv in ((8, 8, 64, 16, 64, 64), (8, 32, 64, 16, 112, 112),
                                  (4, 1, 64, 16, 512, 512), (1, 8, 1, 16, 64, 64),
                                  (2, 2, 4, 8, 32, 32), (3, 5, 37, 7, 48, 40),
                                  (1, 1, 4096, 1, 64, 64), (64, 8, 512, 16, 64, 64),
                                  (8, 8, 8192, 16, 64, 64), (8, 8, 8192, 1, 64, 64),
                                  (64, 8, 131072, 1, 64, 64), (1, 1, 131072, 1, 512, 512)):
        plan = tpa.split_plan(b, kh, mp, ps, dk, dv, SMS)
        covered = [0] * (mp * ps)
        for sp in range(plan.n_splits):
            first = sp * plan.pages_per_split * ps
            for t in range(first, min(first + plan.pages_per_split * ps, mp * ps)):
                covered[t] += 1
        assert covered == [1] * (mp * ps)
        assert (plan.n_splits - 1) * plan.pages_per_split < mp  # no split is empty
        assert 1 <= plan.pages_per_split <= tpa.MAX_PAGES_PER_SPLIT
    for kh, d in ((8, 64), (32, 112)):
        plan = tpa.split_plan(8, kh, 64, 16, d, d, SMS)
        assert 8 * kh * plan.n_splits >= 2 * SMS
        assert plan.pages_per_split * 16 >= 64
    # a card with fewer SMs takes fewer splits
    assert tpa.split_plan(8, 8, 64, 16, 64, 64, 66).n_splits < tpa.split_plan(
        8, 8, 64, 16, 64, 64, SMS).n_splits
    code = inspect.getsource(tpa.paged_attention) + inspect.getsource(tpa.split_plan)
    for host_read in (".item(", ".tolist(", ".max(", ".cpu(", ".numpy(", "int(index",
                      "int(pages", "bool("):
        assert host_read not in code, host_read


def test_paged_wrapper_passes_its_plan_and_raises_past_512(monkeypatch):
    """Off the CPU the wrapper launches (meta tensors stand in for CUDA
    ones, 132 SMs for the card's): the C entry point gets the plan and a
    workspace of a partial per (split, group, query row), with its size,
    and one launch is counted per call.  A head dim past 512 raises in
    Python before any launch."""
    import repro_torch.kernels as kernels

    calls = []
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tpa, "sm_count", lambda device: SMS)
    meta = dict(device="meta", dtype=torch.bfloat16)

    def operands(b, h, kh, s, dk, dv, mp, ps=16):
        return (torch.empty(b, h, s, dk, **meta), torch.empty(b * mp + 1, kh, ps, dk, **meta),
                torch.empty(b * mp + 1, kh, ps, dv, **meta),
                torch.empty(b, mp, dtype=torch.int32, device="meta"),
                torch.empty(b, dtype=torch.int32, device="meta"))

    kernels.reset_launches()
    out = tpa.paged_attention(*operands(8, 32, 8, 1, 64, 64, 64))
    assert tuple(out.shape) == (8, 32, 1, 64)
    tpa.paged_attention(*operands(1, 32, 8, 1, 64, 64, 1))
    (name, args), (_, single) = calls
    assert name == "repro_paged_attention"
    plan = tpa.split_plan(8, 8, 64, 16, 64, 64, SMS)
    assert args[19:22] == (8 * 64 + 1, *plan)
    assert args[9] == plan.n_splits * tpa.WORKSPACE_GROUPS * 8 * 32 * (64 + 2)
    assert single[20:22] == (1, 1)
    assert launch_counts()["paged_attention"] == 2
    for dk, dv in ((520, 64), (64, 520)):
        with pytest.raises(ValueError, match="exceeds 512"):
            tpa.paged_attention(*operands(2, 4, 2, 1, dk, dv, 4))
    assert len(calls) == 2
    kernels.reset_launches()


# -- page plumbing: bit for bit ------------------------------------------------------


def test_gather_and_scatter_pages_match_reference_bitwise(rng):
    b, kh, ps, d, mp = 3, 2, 4, 8, 5
    n_pages = b * mp
    pool = rng.standard_normal((n_pages + 1, kh, ps, d)).astype(np.float32)
    pages = rng.permutation(n_pages).astype(np.int32).reshape(b, mp)
    got = tpa.gather_kv_pages(_t(pool), _t(pages), seq_axis=2)
    want = jpa.gather_kv_pages(jnp.asarray(pool), jnp.asarray(pages), seq_axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # one token per row, an index past the table clamps into the last page
    index = np.asarray([0, 7, mp * ps + 2], np.int32)
    val = rng.standard_normal((b, kh, d)).astype(np.float32)
    want = jpa.scatter_token_pages(jnp.asarray(pool), jnp.asarray(val), jnp.asarray(pages),
                                   jnp.asarray(index), seq_axis=2)
    got = tpa.scatter_token_pages(_t(pool), _t(val), _t(pages), _t(index), seq_axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # an S-token extend chunk crossing page boundaries
    chunk = rng.standard_normal((b, kh, 3, d)).astype(np.float32)
    index = np.asarray([2, 3, 9], np.int32)
    want = jpa.scatter_chunk_pages(jnp.asarray(pool), jnp.asarray(chunk), jnp.asarray(pages),
                                   jnp.asarray(index), seq_axis=2)
    got = tpa.scatter_chunk_pages(_t(pool), _t(chunk), _t(pages), _t(index), seq_axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_insert_pages_matches_reference_bitwise(rng):
    layers, kh, ps, d, mp, n_pages = 2, 2, 4, 8, 3, 7
    pool = rng.standard_normal((layers, n_pages + 1, kh, ps, d)).astype(np.float32)
    b1 = rng.standard_normal((layers, 1, kh, mp * ps, d)).astype(np.float32)
    page_ids = np.asarray([5, 1, 3], np.int32)  # distinct: no null-page duplicates
    want = jpa.insert_pages(jnp.asarray(pool), jnp.asarray(b1), jnp.asarray(page_ids), seq_axis=2)
    got = tpa.insert_pages(_t(pool), _t(b1), _t(page_ids), seq_axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- rmsnorm -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype, rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(x).to(tdt)
    got = trms.rmsnorm(tx, _t(w), eps=1e-5)  # a CPU tensor: the plain version
    assert got.dtype == tdt and got.shape == tx.shape
    for want in (rmsnorm_pallas(jx, jnp.asarray(w), eps=1e-5, interpret=True),
                 jrmsnorm_ref(jx, jnp.asarray(w), eps=1e-5)):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=1e-6)
    assert torch.equal(tref.rmsnorm_ref(tx, _t(w), 1e-5), got)


# -- flash attention -------------------------------------------------------------------


@pytest.mark.parametrize("s", [128, 256])
def test_flash_attention_matches_pallas_interpret(s, rng):
    q = rng.standard_normal((1, 4, s, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, s, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, s, 32)).astype(np.float32)
    got = tatt.flash_attention(_t(q), _t(k), _t(v))  # CPU: the plain version
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_flash_attention_matches_attention_ref_at_ragged_lengths(s, rng):
    q = rng.standard_normal((2, 4, s, 16)).astype(np.float32)
    k = rng.standard_normal((2, 1, s, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1, s, 16)).astype(np.float32)
    want = np.asarray(jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(
        tatt.flash_attention_torch(_t(q), _t(k), _t(v)).numpy(), want, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        tref.attention_ref(_t(q), _t(k), _t(v)).numpy(), want, rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("dqk,dv", [(48, 32), (192, 128)])
def test_flash_attention_dv_differs_matches_pallas_interpret(dqk, dv, rng):
    """v's head dim apart from q's and k's: the reference test's qk 48 / v
    32 and deepseek-v2's MLA prefill, qk 192 / v 128 (GQA 4 / 2, S 128).
    The plain version and the CPU wrapper return (b, h, s, dv) and agree
    with the Pallas kernel in interpret mode within 1e-4 (its online
    softmax over blocks sums in another order); the scale is 1/sqrt(qk)."""
    q = rng.standard_normal((1, 4, 128, dqk)).astype(np.float32)
    k = rng.standard_normal((1, 2, 128, dqk)).astype(np.float32)
    v = rng.standard_normal((1, 2, 128, dv)).astype(np.float32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    for fn in (tatt.flash_attention_torch, tatt.flash_attention):
        got = fn(_t(q), _t(k), _t(v))
        assert tuple(got.shape) == (1, 4, 128, dv) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _flash_bf16_kernel_arithmetic(q, k, v, causal=True):
    """The bf16 CUDA kernel's arithmetic (``csrc/flash_attention.cu``, the
    wgmma route) in torch: key tiles of 128 (64 when D > 64), the scale
    taken after the product in f32, the online softmax in f32, P rounded to
    bf16 before P.V (sums in f32), the output rounded once to bf16."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    g = h // kh
    bkv = 128 if d <= 64 else 64
    qf = q.float().reshape(b, kh, g, sq, d)
    m = torch.full((b, kh, g, sq, 1), -1e30)
    l = torch.zeros((b, kh, g, sq, 1))
    o = torch.zeros((b, kh, g, sq, d))
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bkv):
        kt, vt = k[:, :, k0:k0 + bkv].float(), v[:, :, k0:k0 + bkv].float()
        s = torch.einsum("bkgqd,bktd->bkgqt", qf, kt) * (1.0 / d ** 0.5)
        if causal:
            s = torch.where(qi >= torch.arange(k0, k0 + kt.shape[2])[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bkgqt,bktd->bkgqd", p.bfloat16().float(), vt)
        m = m_new
    return (o / torch.where(l == 0, 1.0, l)).reshape(b, h, sq, d).bfloat16()


@pytest.mark.parametrize("h,kh,s,d", [(4, 2, 300, 64), (2, 2, 300, 112), (4, 1, 77, 112), (4, 2, 129, 64)])
def test_flash_bf16_kernel_arithmetic_meets_bf16_tol(h, kh, s, d, rng):
    """P rounded to bf16 and the scale after the product stay within
    chip_smoke's bf16 TOL (2e-2 abs + 2e-2 rel) of the f32 plain version and
    of the Pallas kernel in interpret mode, at llama's and zamba2's head
    dims and ragged lengths (one Pallas block of S rows)."""
    q, k, v = (rng.standard_normal((1, n, s, d)).astype(np.float32) for n in (h, kh, kh))
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    got = _flash_bf16_kernel_arithmetic(tq, tk, tv).float().numpy()
    plain = tatt.flash_attention_torch(tq.float(), tk.float(), tv.float()).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-2, atol=2e-2)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, block_q=s, block_kv=s, interpret=True)
    np.testing.assert_allclose(got, _np(want), rtol=2e-2, atol=2e-2)


# -- the shelf and the build -------------------------------------------------------------


def test_blocks_pick_target_from_device_and_bind_overrides(monkeypatch):
    assert blocks.registry.targets("rmsnorm") == ["cuda", "ref", "torch"]
    assert blocks.registry.targets("paged_attention") == ["cuda", "torch"]
    seen = []
    monkeypatch.setitem(
        blocks.registry._impls["rmsnorm"], "ref",
        blocks.Impl("rmsnorm", "ref", lambda *a, **k: seen.append("ref")),
    )
    x, w = torch.ones(2, 4), torch.ones(4)
    assert torch.equal(blocks.call("rmsnorm", x, w, eps=1e-5), trms.rmsnorm_torch(x, w, 1e-5))
    with blocks.bind({"rmsnorm": "ref"}):
        blocks.call("rmsnorm", x, w, eps=1e-5)
    assert seen == ["ref"]
    with pytest.raises(KeyError):
        with blocks.bind({"rmsnorm": "pallas"}):
            pass


def test_flash_route_is_picked_by_the_wrapper_passed_and_counted(monkeypatch):
    """The wrapper alone picks flash's route: what TMA can load (bf16, head
    dims multiples of 8, q's <= 256 and v's <= 128, 16-byte aligned
    operands; deepseek-v2's qk 192 / v 128 among them) goes to wgmma, the
    rest to the CUDA cores.  It passes the route's code to the C entry
    point and counts the launch under it; ``reset_launches`` clears the
    counts.  (Meta tensors stand in for CUDA ones.)"""
    from repro_torch import kernels

    def qkv(d, dv, dtype=torch.bfloat16, device="cpu"):
        return tuple(torch.zeros(1, 4, 8, e, dtype=dtype, device=device) for e in (d, d, dv))

    for args in (qkv(64, 64), qkv(112, 112), qkv(48, 32), qkv(192, 128)):
        assert tatt.flash_route(*args) == "wgmma"
    for args in (qkv(100, 100), qkv(256, 256), qkv(64, 64, torch.float32)):
        assert tatt.flash_route(*args) == "cuda_cores"
    q, k, v = qkv(64, 64)
    shifted = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)[1:].view(q.shape)
    assert tatt.flash_route(shifted, k, v) == "cuda_cores"  # a 2-byte offset

    calls = []
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    kernels.reset_launches()
    tatt.flash_attention(*qkv(64, 64, device="meta"))
    out = tatt.flash_attention(*qkv(192, 128, device="meta"))
    assert tuple(out.shape) == (1, 4, 8, 128)
    tatt.flash_attention(*qkv(256, 256, device="meta"))
    # the route code follows q, k, v, out, lse and the eight sizes
    assert [args[15] for _, args in calls] == [tatt.ROUTES.index("wgmma"),
                                               tatt.ROUTES.index("wgmma"),
                                               tatt.ROUTES.index("cuda_cores")]
    assert [args[4] for _, args in calls] == [None, None, None]  # serving asks for no lse
    assert tatt.flash_attention.routes == {"cuda_cores": 1, "wgmma": 2}
    assert launch_counts()["flash_attention"] == 3
    kernels.reset_launches()
    assert tatt.flash_attention.routes == {"cuda_cores": 0, "wgmma": 0}


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_kernel_sources_carry_their_notes_and_hash(tmp_path, monkeypatch):
    kernel_sources = {p.name for p in build.sources() if "__global__" in p.read_text()}
    assert kernel_sources == {
        "rmsnorm.cu", "paged_attention.cu", "flash_attention.cu", "matmul.cu",
        "complex_matmul.cu", "ssd_chunks.cu", "flash_attention_bwd.cu", "rmsnorm_bwd.cu",
    }
    for name in kernel_sources:
        text = (build.CSRC / name).read_text()
        assert "Replaces: repro/kernels/" in text and "Bound on the H100" in text, name
    assert build.source_hash() == build.source_hash()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    # a header the kernels include (the Hopper primitives) is part of the hash
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    before = build.source_hash()
    (copy / "hopper.cuh").write_text((copy / "hopper.cuh").read_text() + "\n// edited\n")
    assert build.source_hash() != before

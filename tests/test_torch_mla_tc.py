"""deepseek-v2's MLA shapes on the tensor-core routes, on the CPU.

Two kernels take MLA's shapes on wgmma: flash attention's forward at qk
192 / v 128 (``csrc/flash_attention.cu``, its column boxes counted apart
for q / k and for v), and paged attention's latent walk
(``csrc/paged_attention.cu``, one 512-wide latent pool as keys and values
with its rope pool beside it, 64 query rows a tile).  Neither runs here (no
card, no nvcc), so these tests hold what surrounds them: the wrappers'
route rules and the arguments they pass to the C entry points (meta
tensors stand in for CUDA ones, ``build.launch`` patched), and a torch
emulation of each route's tile arithmetic (tile widths, P rounded to bf16
as the A operand, exp2 in the log2 domain; for the latent walk its 64-row
tiles, its sub-tiles of positions, the two halves of the latent's columns
and the split / merge) against the reference's Pallas kernels in interpret
mode at reduced MLA shapes.

Tolerances: the emulations round as the kernels do (bf16 inputs and P,
f32 sums), so they are held to ``chip_smoke.TOL["bfloat16"]`` (2e-2 abs +
2e-2 rel), the tolerance phase 2 holds the kernels to on the card,
against the Pallas kernels run on the same bf16 inputs in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels.attention import flash_attention_pallas
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import build, launch_counts
from repro_torch.kernels import paged_attention as tpa

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOG2E = 1.4426950408889634
#: SMs the planners are given off the card (an H100's)
SMS = 132


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _patch_launch(monkeypatch) -> list:
    calls = []
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    return calls


# -- flash attention: the wgmma route at dv != d ------------------------------------------


def _qkv(d, dv, dtype=torch.bfloat16, device="cpu", h=4, kh=4, s=8):
    return (torch.zeros(1, h, s, d, dtype=dtype, device=device),
            torch.zeros(1, kh, s, d, dtype=dtype, device=device),
            torch.zeros(1, kh, s, dv, dtype=dtype, device=device))


@pytest.mark.parametrize("d,dv,dtype,route", [
    (192, 128, torch.bfloat16, "wgmma"),      # deepseek-v2's MLA prefill
    (256, 128, torch.bfloat16, "wgmma"),      # four column boxes for q and k
    (256, 64, torch.bfloat16, "wgmma"),
    (48, 32, torch.bfloat16, "wgmma"),        # the reference test's dv != d
    (264, 128, torch.bfloat16, "cuda_cores"),  # q's dims past four boxes
    (192, 192, torch.bfloat16, "cuda_cores"),  # v's dims past two boxes
    (196, 128, torch.bfloat16, "cuda_cores"),  # not a multiple of 8 (TMA's 16-byte rows)
    (192, 120, torch.bfloat16, "wgmma"),
    (192, 124, torch.bfloat16, "cuda_cores"),
    (192, 128, torch.float32, "cuda_cores"),
])
def test_flash_route_boundaries_at_dv_differs(d, dv, dtype, route):
    assert tatt.flash_route(*_qkv(d, dv, dtype)) == route


def test_flash_route_refuses_a_misaligned_operand_at_mla_shapes():
    q, k, v = _qkv(192, 128)
    for i in range(3):
        ops = [q, k, v]
        t = ops[i]
        ops[i] = torch.zeros(1 + t.numel(), dtype=t.dtype)[1:].view(t.shape)  # 2 bytes off
        assert tatt.flash_route(*ops) == "cuda_cores"
    assert tatt.flash_route(q, k, v) == "wgmma"


def test_flash_wrapper_passes_dv_route_and_lse_at_mla_shapes(monkeypatch):
    """At qk 192 / v 128 the wrapper gives the C entry point D 192, Dv 128,
    the scale 1/sqrt(192) (the qk dim, as the TPU kernel), the wgmma route's
    code and, for training, an lse buffer (B, H, Sq); the output is (B, H,
    Sq, Dv), which the kernel writes at the Dv stride."""
    from repro_torch import kernels

    calls = _patch_launch(monkeypatch)
    kernels.reset_launches()
    q, k, v = _qkv(192, 128, device="meta", h=8, kh=8, s=130)
    out, lse = tatt._flash_cuda(q, k, v, True, with_lse=True)
    assert tuple(out.shape) == (1, 8, 130, 128) and tuple(lse.shape) == (1, 8, 130)
    assert lse.dtype == torch.float32
    out2 = tatt.flash_attention(q, k, v)
    assert tuple(out2.shape) == (1, 8, 130, 128)
    (n1, a1), (n2, a2) = calls
    assert n1 == n2 == "repro_flash_attention"
    # q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale, dtype, route, stream
    assert a1[5:13] == (1, 8, 8, 130, 130, 192, 128, 1)
    assert a1[13] == pytest.approx(1.0 / 192 ** 0.5)
    assert a1[14] == build.DTYPE_CODES[torch.bfloat16]
    assert a1[15] == a2[15] == tatt.ROUTES.index("wgmma")
    assert a1[4] is not None and a2[4] is None
    assert tatt.flash_attention.routes == {"cuda_cores": 0, "wgmma": 2}
    assert launch_counts()["flash_attention"] == 2
    kernels.reset_launches()


def _flash_wgmma_arithmetic(q, k, v, causal=True):
    """The wgmma route's arithmetic in torch, tile by tile: key tiles of
    128 / NBV (NBV = ceil(Dv / 64): 64 keys at v 128), S = q . k in f32 from
    bf16 operands, scaled after the product in the log2 domain (scale *
    log2 e), the online softmax with exp2, P rounded to bf16 as the A
    operand of P . V (sums in f32), O / l rounded once to bf16, and the lse
    (m + log2 l) ln 2.  Returns (out (B, H, Sq, Dv) bf16, lse (B, H, Sq))."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    bkv = 128 // -(-dv // 64)
    scale_log2 = LOG2E / d ** 0.5
    qf = q.float().reshape(b, kh, g, sq, d)
    m = torch.full((b, kh, g, sq, 1), -1e30)
    l = torch.zeros((b, kh, g, sq, 1))
    o = torch.zeros((b, kh, g, sq, dv))
    qi = torch.arange(sq)[:, None]
    n_kv = -(-skv // bkv)
    for t in range(n_kv):
        k0 = t * bkv
        if causal and k0 > sq - 1:
            break  # tiles above the diagonal are skipped
        kt, vt = k[:, :, k0:k0 + bkv].float(), v[:, :, k0:k0 + bkv].float()
        x = torch.einsum("bkgqd,bktd->bkgqt", qf, kt) * scale_log2
        if causal:
            x = torch.where(qi >= torch.arange(k0, k0 + kt.shape[2])[None, :], x, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp2(x - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bkgqt,bktd->bkgqd", p.bfloat16().float(), vt)
        m = m_new
    l = torch.where(l == 0, 1.0, l)
    lse = ((m + torch.log2(l)) * np.log(2.0)).reshape(b, h, sq)
    return (o / l).reshape(b, h, sq, dv).bfloat16(), lse


@pytest.mark.parametrize("h,kh,s,d,dv", [
    (4, 4, 130, 192, 128),  # deepseek-v2's MLA prefill, reduced heads, a ragged edge
    (4, 2, 96, 192, 128),   # GQA over it
    (2, 2, 77, 256, 64),    # four boxes for q and k, one for v: 128-key tiles
    (4, 4, 64, 48, 32),
])
def test_flash_wgmma_arithmetic_at_dv_differs_matches_pallas(h, kh, s, d, dv, rng):
    """The emulation of the wgmma route at dv != d stays within phase 2's
    bf16 TOL of the Pallas kernel in interpret mode on the same bf16 inputs
    (one block of S rows: the TPU kernel tiles S evenly) and of the f32
    plain version; its lse within 1e-4 of the plain forward's (the
    reference's chunked core, attention_chunked._chunked_fwd_core)."""
    from repro_torch.kernels.attention_chunked import _chunked_fwd_core

    q, k = (rng.standard_normal((1, n, s, d)).astype(np.float32) for n in (h, kh))
    v = rng.standard_normal((1, kh, s, dv)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got, lse = _flash_wgmma_arithmetic(tq, tk, tv)
    assert tuple(got.shape) == (1, h, s, dv)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv, block_q=s, block_kv=s, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    plain = tatt.flash_attention_torch(tq.float(), tk.float(), tv.float())
    np.testing.assert_allclose(_np(got), plain.numpy(), **BF16_TOL)
    want_lse = _chunked_fwd_core(tq.float(), tk.float(), tv.float(), True, s, s)[1]
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(1, h, s).numpy(),
                               rtol=1e-4, atol=1e-4)


# -- paged attention: the latent walk ----------------------------------------------------


def _pools(dk=512, dr=64, ps=16, kh=1, dtype=torch.bfloat16, device="cpu", b=2, h=8, s=1,
           mp=4, latent=True):
    """Operands of a paged call at MLA's layout: q (B, H, S, Dk), one pool
    (P, KH, ps, Dk) as keys and values (``latent``) or two, q_rope and the
    rope pool (P, 1, ps, Dr)."""
    n = b * mp + 1
    k_pool = torch.zeros(n, kh, ps, dk, dtype=dtype, device=device)
    v_pool = k_pool if latent else torch.zeros(n, kh, ps, dk, dtype=dtype, device=device)
    q = torch.zeros(b, h, s, dk, dtype=dtype, device=device)
    q_rope = torch.zeros(b, h, s, dr, dtype=dtype, device=device) if dr else None
    kr_pool = torch.zeros(n, 1, ps, dr, dtype=dtype, device=device) if dr else None
    pages = torch.zeros(b, mp, dtype=torch.int32, device=device)
    index = torch.zeros(b, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, pages, index, q_rope, kr_pool


@pytest.mark.parametrize("kw,route", [
    ({}, "latent"),                          # deepseek-v2: 512-wide latent, rope 64, pages of 16
    (dict(dk=256), "latent"),
    (dict(dk=128, dr=16, ps=8), "latent"),   # the reduced shapes the emulation runs
    (dict(ps=24), "latent"),                 # 8-row TMA boxes
    (dict(latent=False), "split"),           # separate pools with rope (the G=16 row)
    (dict(dtype=torch.float32), "split"),
    (dict(dk=480), "split"),                 # not a multiple of 64
    (dict(dr=72), "split"),                  # rope past one box
    (dict(dr=60), "split"),                  # rope rows not whole 16-byte chunks
    (dict(dr=0), "split"),                   # no rope pool
    (dict(ps=12), "split"),                  # pages TMA boxes of 8 rows do not tile
    (dict(kh=2), "split"),                   # more than one kv head
])
def test_paged_route_boundaries(kw, route):
    q, k_pool, v_pool, _, _, q_rope, kr_pool = _pools(**kw)
    assert tpa.paged_route(q, k_pool, v_pool, q_rope, kr_pool) == route


def test_paged_route_needs_one_pool_object_and_aligned_operands():
    q, k_pool, v_pool, _, _, q_rope, kr_pool = _pools()
    # the same values in another tensor are two pools: the split walk
    assert tpa.paged_route(q, k_pool, k_pool.clone(), q_rope, kr_pool) == "split"
    for i in range(4):
        ops = [q, k_pool, q_rope, kr_pool]
        t = ops[i]
        ops[i] = torch.zeros(1 + t.numel(), dtype=t.dtype)[1:].view(t.shape)  # 2 bytes off
        qq, kp, qr, kr = ops
        assert tpa.paged_route(qq, kp, kp, qr, kr) == "split"


def test_paged_wrapper_passes_the_latent_route_plan_and_workspace(monkeypatch):
    """On the latent walk the wrapper gives the C entry point the route's
    code (last before the stream), :func:`latent_plan` (one split where
    one CTA an SM covers the (slot, 64-row tile) pairs in one, else two
    CTAs an SM, splits of at least 128 positions) and a
    workspace of one partial per (split, query row); the split walk keeps
    its own plan and ``WORKSPACE_GROUPS`` partials.  Each launch is counted
    under its route."""
    from repro_torch import kernels

    calls = _patch_launch(monkeypatch)
    monkeypatch.setattr(tpa, "sm_count", lambda device: SMS)
    kernels.reset_launches()
    # deepseek-v2's decode (B 8, H 128, S 1) and a 128-token chunk (B 1)
    for b, s in ((8, 1), (1, 128)):
        q, k_pool, v_pool, pages, index, q_rope, kr_pool = _pools(
            b=b, h=128, s=s, mp=64, device="meta")
        out = tpa.paged_attention(q, k_pool, v_pool, pages, index, q_rope=q_rope,
                                  kr_pool=kr_pool, scale=0.07)
        assert tuple(out.shape) == (b, 128, s, 512)
    q, k_pool, v_pool, pages, index, q_rope, kr_pool = _pools(
        b=4, h=16, mp=64, device="meta", latent=False)
    tpa.paged_attention(q, k_pool, v_pool, pages, index, q_rope=q_rope, kr_pool=kr_pool)
    (_, dec), (_, chunk), (_, sep) = calls
    for args, (b, r) in ((dec, (8, 128)), (chunk, (1, 128 * 128))):
        plan = tpa.latent_plan(b, r, 64, 16, 512, SMS)
        assert args[20:22] == tuple(plan)
        assert args[9] == plan.n_splits * b * r * (512 + 2)
        assert args[22] == pytest.approx(0.07)
        assert args[24] == tpa.ROUTES.index("latent")
        assert args[2] == args[1]  # one pool: keys and values
    assert tpa.latent_plan(8, 128, 64, 16, 512, SMS) == tpa.SplitPlan(8, 8)
    assert tpa.latent_plan(1, 128 * 128, 64, 16, 512, SMS) == tpa.SplitPlan(64, 1)
    # a 16-token chunk: 32 tiles take 8 splits (two CTAs an SM), not 5
    assert tpa.latent_plan(1, 128 * 16, 64, 16, 512, SMS) == tpa.SplitPlan(8, 8)
    plan = tpa.split_plan(4, 1, 64, 16, 512, 512, SMS)
    assert sep[20:22] == tuple(plan) and sep[24] == tpa.ROUTES.index("split")
    assert sep[9] == plan.n_splits * tpa.WORKSPACE_GROUPS * 4 * 16 * (512 + 2)
    assert tpa.paged_attention.routes == {"split": 1, "latent": 2}
    assert kernels.counters()["paged_attention/latent"] == 2
    kernels.reset_launches()
    assert tpa.paged_attention.routes == {"split": 0, "latent": 0}


def _latent_walk_arithmetic(q, pool, pages, index, q_rope, kr_pool, scale, plan, *,
                            rows=tpa.LATENT_ROWS, sub=64, half=256):
    """The latent walk's arithmetic in torch (``csrc/paged_attention.cu``,
    ``latent::paged_attention_latent``, and the merge kernel), from bf16
    operands: per (split, tile of ``rows`` query rows, slot) a CTA runs if
    its split starts before the slot's last query position; it walks
    sub-tiles of ``sub`` positions up to its own tile's last query
    position, S = [q | q_rope] [c | k_rope]^T in f32, x = S * scale *
    log2 e (masked: -1e30), the online softmax with exp2 and the explicit
    re-mask, P rounded to bf16 against the latent rows as values, each
    ``half`` of the latent's columns its own product (the two consumer
    warpgroups); its partial is (m ln 2, l, acc) per row.  The merge weighs
    the partials of every split that ran with exp(m - max), the l == 0 -> 1
    guard, and rounds once to bf16; a plan of one split has the walk write
    acc * (1 / l) itself, which is the merge of one partial.  Returns the
    output and what the walk met, for the coverage checks."""
    b, h, s, dk = q.shape
    ps = pool.shape[2]
    mp = pages.shape[1]
    r_all = h * s
    split_len, cap = plan.pages_per_split * ps, ps * mp
    qf = torch.cat([q.float(), q_rope.float()], -1).reshape(b, r_all, -1)
    keys = torch.cat([pool.float(), kr_pool.float()], -1)[:, 0]  # (P, ps, Dk + Dr)
    vals = pool.float()[:, 0]
    out = torch.zeros(b, r_all, dk)
    met = {"tiles": 0, "partial_tiles": 0, "splits_past_slot": 0, "empty_partials": 0,
           "multi_sub": 0, "causal_skips": 0}
    for bi in range(b):
        base = int(index[bi])
        n_pos = min(base + s, cap)
        ran = -(-n_pos // split_len)
        met["splits_past_slot"] += plan.n_splits - ran
        parts = []
        for sp in range(ran):
            pos0, pos1 = sp * split_len, min((sp + 1) * split_len, n_pos)
            acc_t, m_t, l_t = torch.zeros(r_all, dk), torch.zeros(r_all), torch.zeros(r_all)
            for rbase in range(0, r_all, rows):
                r = torch.arange(rbase, min(rbase + rows, r_all))
                met["tiles"] += 1
                met["partial_tiles"] += len(r) < rows
                qpos = base + r % s
                tile_end = min(pos1, base + int((r % s).max()) + 1)
                met["causal_skips"] += tile_end < pos1
                m = torch.full((len(r),), -1e30)
                l, acc = torch.zeros(len(r)), torch.zeros(len(r), dk)
                n_sub = max(0, -(-(tile_end - pos0) // sub))
                met["multi_sub"] += n_sub > 1
                for k in range(n_sub):
                    t = torch.arange(pos0 + k * sub, min(pos0 + (k + 1) * sub, tile_end))
                    pg, row = pages[bi, t // ps].long(), t % ps
                    x = (qf[bi, r] @ keys[pg, row].T) * (scale * LOG2E)
                    valid = t[None, :] <= qpos[:, None]
                    x = torch.where(valid, x, torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.max(dim=1).values)
                    p = torch.where(valid, torch.exp2(x - m_new[:, None]), torch.tensor(0.0))
                    alpha = torch.exp2(m - m_new)
                    l = l * alpha + p.sum(dim=1)
                    pb, v = p.bfloat16().float(), vals[pg, row]
                    acc = acc * alpha[:, None]
                    for c0 in range(0, dk, half):  # each warpgroup's columns
                        acc[:, c0:c0 + half] += pb @ v[:, c0:c0 + half]
                    m = m_new
                met["empty_partials"] += int((l == 0).sum())
                acc_t[r], m_t[r], l_t[r] = acc, m * np.log(2.0), l
            parts.append((m_t, l_t, acc_t))
        ms = torch.stack([m for m, _, _ in parts])
        w = torch.exp(ms - ms.max(dim=0).values)
        l = (torch.stack([lp for _, lp, _ in parts]) * w).sum(dim=0)
        acc = (torch.stack([ap for _, _, ap in parts]) * w[:, :, None]).sum(dim=0)
        out[bi] = acc / torch.where(l == 0, torch.tensor(1.0), l)[:, None]
    return out.reshape(b, h, s, dk).bfloat16(), met


def _mla_case(rng, *, b, h, s, dk, dr, ps, mp, lengths):
    """A paged MLA case: one latent pool (keys and values) and its rope
    pool, shuffled page tables, null-page entries past each slot's pages
    (the null page poisoned: it must never contribute), as numpy."""
    n_pages = b * mp
    null = n_pages
    pool = rng.standard_normal((n_pages + 1, 1, ps, dk)).astype(np.float32)
    kr_pool = rng.standard_normal((n_pages + 1, 1, ps, dr)).astype(np.float32)
    pool[null] = kr_pool[null] = 1e6
    pages = rng.permutation(n_pages).astype(np.int32).reshape(b, mp)
    for i, ln in enumerate(lengths):
        pages[i, -(-(ln + s) // ps):] = null
    return {"q": rng.standard_normal((b, h, s, dk)).astype(np.float32), "pool": pool,
            "pages": pages, "index": np.asarray(lengths, np.int32),
            "q_rope": rng.standard_normal((b, h, s, dr)).astype(np.float32),
            "kr_pool": kr_pool, "scale": 1.0 / float(np.sqrt(dk + dr))}


def _hold_latent_walk(case, plan, **tiling):
    """The emulation against the reference's Pallas kernel in interpret
    mode and its XLA target, on the same bf16 operands (the pool passed as
    keys and values), within phase 2's bf16 TOL."""
    th = {k: torch.from_numpy(v).bfloat16() if isinstance(v, np.ndarray) and v.dtype == np.float32
          else torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in case.items()}
    got, met = _latent_walk_arithmetic(th["q"], th["pool"], th["pages"], th["index"],
                                       th["q_rope"], th["kr_pool"], th["scale"], plan, **tiling)
    jx = {k: jnp.asarray(_np(v)).astype(jnp.bfloat16) if isinstance(v, torch.Tensor)
          and v.dtype == torch.bfloat16 else (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                                              else v) for k, v in th.items()}
    args = dict(q=jx["q"], k_pool=jx["pool"], v_pool=jx["pool"], pages=jx["pages"],
                index=jx["index"], q_rope=jx["q_rope"], kr_pool=jx["kr_pool"], scale=jx["scale"])
    want = jpa.paged_attention_pallas(**args, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(jpa.paged_attention_xla(**args)), **BF16_TOL)
    # and the port's plain version, which chip_smoke holds the kernel to
    plain = tpa.paged_attention_torch(th["q"], th["pool"], th["pool"], th["pages"], th["index"],
                                      q_rope=th["q_rope"], kr_pool=th["kr_pool"],
                                      scale=th["scale"])
    np.testing.assert_allclose(_np(got), _np(plain), **BF16_TOL)
    return met


#: reduced MLA shapes (latent 128 of the kernel's 256-column halves, rope
#: 16, pages of 8): decode (S 1) and extend chunks (S 4, 16, 128) over
#: ragged lengths, a partial last page and an empty history
LATENT_CASES = [
    dict(b=3, h=8, s=1, lengths=(70, 8, 0)),
    dict(b=2, h=16, s=4, lengths=(37, 150)),
    dict(b=1, h=8, s=16, lengths=(100,)),
    dict(b=2, h=96, s=1, lengths=(155, 3)),  # two 64-row tiles, the second partial
    dict(b=1, h=2, s=128, lengths=(20,)),     # a 64-row tile is half a head's chunk
]


@pytest.mark.parametrize("case_kw", LATENT_CASES)
@pytest.mark.parametrize("plan_kw", [{}, dict(min_positions=1)])
def test_latent_walk_arithmetic_matches_pallas(case_kw, plan_kw, rng):
    """At the kernel's own tiling (64 rows, 64 positions) over the latent
    plan, and over splits of one page each: the split / partial / merge
    algebra of 64-row tiles against the reference."""
    case = _mla_case(rng, dk=128, dr=16, ps=8, mp=20, **case_kw)
    b, h, s = case_kw["b"], case_kw["h"], case_kw["s"]
    plan = tpa.split_plan(b, -(-h * s // tpa.LATENT_ROWS), 20, 8, 128, 128, SMS,
                          ctas_per_sm=tpa.LATENT_CTAS_PER_SM,
                          min_positions=plan_kw.get("min_positions", tpa.LATENT_MIN_POSITIONS))
    if not plan_kw:
        assert plan == tpa.latent_plan(b, h * s, 20, 8, 128, SMS)
    _hold_latent_walk(case, plan)


@pytest.mark.parametrize("rows,sub", [(16, 8), (8, 16), (64, 16)])
def test_latent_walk_arithmetic_at_finer_tilings(rows, sub, rng):
    """Finer tiles and sub-tiles than the kernel's reach the paths a reduced
    shape cannot at 64 x 64: many sub-tiles a tile (the online softmax
    across them), tiles of part of a head's 16 chunk positions (the causal
    skip: a tile stops at its own rows' last position), splits past the
    slot."""
    case = _mla_case(rng, b=2, h=4, s=16, dk=128, dr=16, ps=8, mp=20, lengths=(93, 0))
    plan = tpa.split_plan(2, 8, 20, 8, 128, 128, SMS, ctas_per_sm=4, min_positions=1)
    met = _hold_latent_walk(case, plan, rows=rows, sub=sub, half=64)
    assert met["multi_sub"] > 0 and met["splits_past_slot"] > 0
    assert (met["causal_skips"] > 0) == (rows < 16)  # a tile of part of a head's chunk


def test_latent_walk_cases_cover_the_edges(rng):
    """The kernel's tiling over LATENT_CASES meets a partial row tile,
    splits past a slot, a tile that stops before its split ends (the
    causal skip of a 128-token chunk's first half) and whose rows see no
    position of a later split (an empty partial), and one tile's several
    sub-tiles (mp 20 pages of 8 = 160 positions)."""
    met_all = {}
    for case_kw in LATENT_CASES:
        case = _mla_case(rng, dk=128, dr=16, ps=8, mp=20, **case_kw)
        b, h, s = case_kw["b"], case_kw["h"], case_kw["s"]
        plan = tpa.split_plan(b, 1, 20, 8, 128, 128, SMS, ctas_per_sm=4, min_positions=1)
        met = _hold_latent_walk(case, plan)
        for k, v in met.items():
            met_all[k] = met_all.get(k, 0) + v
    assert met_all["partial_tiles"] > 0 and met_all["splits_past_slot"] > 0
    assert met_all["causal_skips"] > 0 and met_all["empty_partials"] > 0
    case = _mla_case(rng, b=1, h=4, s=1, dk=128, dr=16, ps=8, mp=20, lengths=(150,))
    met = _hold_latent_walk(case, tpa.SplitPlan(20, 1))
    assert met["multi_sub"] > 0


# -- the variants the card's experiments build --------------------------------------------


def _paged_variants():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "paged_variants.py"
    spec = importlib.util.spec_from_file_location("paged_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PAGED_VARIANTS = _paged_variants()


@pytest.mark.parametrize("name", sorted(PAGED_VARIANTS.VARIANTS))
def test_paged_variant_edits_one_line_of_this_tree(name):
    """Each of ``scripts/paged_variants.py``'s variants (the latent walk's
    stages taken out, its planted faults, its plan at one CTA an SM, the
    split walk's forks, the faults planted in the split walk and in
    flash) finds the text it replaces exactly once in this
    tree's kernel sources, so a change to a kernel that moves the text
    shows here and not as a failed build on the card."""
    from pathlib import Path

    file, old, new = PAGED_VARIANTS.VARIANTS[name]
    source = (Path(tpa.__file__).resolve().parent / file).read_text()
    assert source.count(old) == 1 and old != new

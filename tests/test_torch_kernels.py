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
    """The wrapper alone picks flash's route: what TMA can load (bf16, one
    head dim <= 128 and a multiple of 8, 16-byte aligned operands) goes to
    wgmma, the rest to the CUDA cores.  It passes the route's code to the C
    entry point and counts the launch under it; ``reset_launches`` clears
    the counts.  (Meta tensors stand in for CUDA ones.)"""
    from repro_torch import kernels

    def qkv(d, dv, dtype=torch.bfloat16, device="cpu"):
        return tuple(torch.zeros(1, 4, 8, e, dtype=dtype, device=device) for e in (d, d, dv))

    assert tatt.flash_route(*qkv(64, 64)) == tatt.flash_route(*qkv(112, 112)) == "wgmma"
    for args in (qkv(48, 32), qkv(192, 128), qkv(100, 100), qkv(256, 256),
                 qkv(64, 64, torch.float32)):
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
    assert [args[14] for _, args in calls] == [tatt.ROUTES.index("wgmma"),
                                               tatt.ROUTES.index("cuda_cores")]
    assert tatt.flash_attention.routes == {"cuda_cores": 1, "wgmma": 1}
    assert launch_counts()["flash_attention"] == 2
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
        "complex_matmul.cu", "ssd_chunks.cu",
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

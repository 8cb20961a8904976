"""The port's SSD chunk scan against the reference's.

``ssd_chunks_torch`` (the plain version of ``csrc/ssd_chunks.cu``) is held
against ``repro.kernels.ssd.ssd_chunks_pallas`` in interpret mode, all four
outputs; ``ops.ssd_scan`` (targets ``torch`` and ``ref``) against the
reference's ``ops.ssd_scan(backend="xla")`` and its sequential
``ref.ssd_ref``.  Inputs are made with numpy from a seed and fed to both
sides.  Tolerance: atol 2e-5 in f32, as ``tests/test_kernels_ssd.py`` holds
the reference's own targets to each other — the same f32 formulas, summed
in another order.  bf16 inputs are upcast to f32 by both sides before any
arithmetic, so they keep the f32 tolerance.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_chunks_pallas
from repro_torch.core import blocks
from repro_torch.core.pattern_db import default_db
from repro_torch.kernels import build, ops, ref, ssd

ATOL = 2e-5


def _inputs(rng, b, s, h, p, n, with_h0=False):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 1e-1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if with_h0 else None
    return x, dt, a, bm, cm, h0


def _t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunks_match_pallas_interpret(chunk, dtype, rng):
    """S=128: eight chunks of 16 down to one of 128, the main path's."""
    x, dt, a, bm, cm, _ = _inputs(rng, 2, 128, 3, 8, 16)
    if dtype == "bfloat16":
        x, bm, cm = (v.astype(ml_dtypes.bfloat16) for v in (x, bm, cm))
    want = ssd_chunks_pallas(_j(x), _j(dt), _j(a), _j(bm), _j(cm), chunk=chunk, interpret=True)
    for fn in (ssd.ssd_chunks_torch, ssd.ssd_chunks):  # the wrapper: plain on the CPU
        got = fn(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_ssd_scan_matches_reference_with_padding_and_h0(chunk, rng):
    """S=100 pads to a multiple of chunks 16/32/64 and runs one chunk of
    100 at 128 (S < chunk); the carried h0 enters the first chunk."""
    x, dt, a, bm, cm, h0 = _inputs(rng, 2, 100, 3, 8, 16, with_h0=True)
    jargs = tuple(map(_j, (x, dt, a, bm, cm)))
    targs = tuple(map(_t, (x, dt, a, bm, cm)))
    want_y, want_h = jops.ssd_scan(*jargs, chunk=chunk, h0=_j(h0), backend="xla")
    oracle_y, oracle_h = jref.ssd_ref(*jargs, h0=_j(h0))
    for backend in ("torch", "ref"):
        y, hfin = ops.ssd_scan(*targs, chunk=chunk, h0=_t(h0), backend=backend)
        assert y.shape == (2, 100, 3, 8) and hfin.shape == (2, 3, 16, 8)
        for want, wh in ((want_y, want_h), (oracle_y, oracle_h)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=ATOL)
            np.testing.assert_allclose(hfin.numpy(), np.asarray(wh), rtol=0, atol=ATOL)


def test_ssd_scan_bf16_inputs_and_no_h0_match_reference(rng):
    x, dt, a, bm, cm, _ = _inputs(rng, 1, 40, 2, 8, 16)
    x, bm, cm = (v.astype(ml_dtypes.bfloat16) for v in (x, bm, cm))
    want_y, want_h = jops.ssd_scan(*map(_j, (x, dt, a, bm, cm)), chunk=16, backend="xla")
    y, hfin = blocks.call("ssd_scan", *map(_t, (x, dt, a, bm, cm)), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0, atol=ATOL)
    np.testing.assert_allclose(hfin.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)


def test_ssd_ref_matches_reference_oracle(rng):
    x, dt, a, bm, cm, h0 = _inputs(rng, 2, 12, 2, 4, 8, with_h0=True)
    want_y, want_h = jref.ssd_ref(*map(_j, (x, dt, a, bm, cm)), h0=_j(h0))
    y, hfin = ref.ssd_ref(*map(_t, (x, dt, a, bm, cm)), h0=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0, atol=ATOL)
    np.testing.assert_allclose(hfin.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)


def test_ssd_chunks_tiling_contract_and_wrapper_counts(rng):
    x, dt, a, bm, cm, _ = map(_t, _inputs(rng, 1, 48, 2, 8, 16))
    with pytest.raises(ValueError, match="% chunk"):
        ssd.ssd_chunks(x, dt, a, bm, cm, chunk=32)
    before = ssd.ssd_chunks.launches
    ssd.ssd_chunks(x, dt, a, bm, cm, chunk=16)
    assert ssd.ssd_chunks.launches == before  # CPU tensors launch nothing
    # the strides the kernel gets: a dim of length 1 takes the dense one
    x = torch.zeros(2, 48, 3, 8)
    assert ssd._seq_strides(x) == (48 * 24, 24)
    assert ssd._seq_strides(torch.zeros(1, 48, 5376)[..., 5120:5248]) == (48 * 5376, 5376)
    assert ssd._seq_strides(torch.zeros(3, 1, 40)[..., :20]) == (40, 20)


def test_ssd_chunks_off_the_cpu_goes_to_the_kernel_and_raises_without_nvcc(monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no nvcc the
    launch raises.  (Meta tensors stand in for CUDA ones here.)"""
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    meta = dict(device="meta")
    x = torch.empty((1, 32, 2, 8), dtype=torch.bfloat16, **meta)
    dt = torch.empty((1, 32, 2), **meta)
    a = torch.empty((2,), **meta)
    bm = torch.empty((1, 32, 16), dtype=torch.bfloat16, **meta)
    before = ssd.ssd_chunks.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ssd.ssd_chunks(x, dt, a, bm, bm, chunk=32)
    assert ssd.ssd_chunks.launches == before
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_chunks(x, dt.to(torch.bfloat16), a, bm, bm, chunk=32)
    # P = 72 (past the old limit of 64, and padded to a multiple of 8 for
    # TMA's strides) goes to the kernel as well
    wide = torch.empty((1, 32, 2, 72), dtype=torch.bfloat16, **meta)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ssd.ssd_chunks(wide, dt, a, bm, bm, chunk=32)
    assert ssd.ssd_chunks.launches == before


def test_ssd_scan_block_targets_and_pattern_db_entry(rng):
    assert blocks.registry.targets("ssd_scan") == ["cuda", "ref", "torch"]
    impl = default_db().get("ssd_scan").resolve()
    assert impl is ops.ssd_scan
    x, dt, a, bm, cm, _ = _inputs(rng, 1, 20, 2, 4, 8)
    y, hfin = impl(*map(_t, (x, dt, a, bm, cm)), chunk=8)
    want_y, want_h = ref.ssd_ref(*map(_t, (x, dt, a, bm, cm)))
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(hfin.numpy(), want_h.numpy(), rtol=0, atol=ATOL)


# -- the bf16 route's arithmetic and the shapes C2 opens ----------------------------

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
SSD_TOL = chip_smoke.SSD_TOL  # the tolerances the card holds the kernel to


def _bf16(v):
    return torch.from_numpy(v).to(torch.bfloat16)


def _card_inputs(rng, b, s, h, p, n):
    """chip_smoke's ``_ssd_cases`` distribution: x, B and C standard normal
    in bf16, dt in [1e-3, 0.1], a from -U[1, 16)."""
    x = _bf16(rng.standard_normal((b, s, h, p)).astype(np.float32))
    bm = _bf16(rng.standard_normal((b, s, n)).astype(np.float32))
    cm = _bf16(rng.standard_normal((b, s, n)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(1.0, 16.0, (h,)).astype(np.float32))
    return x, dt, a, bm, cm


def _split(v):
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _ssd_bf16_route_arithmetic(x, dt, a, bmat, cmat, *, chunk, split=True):
    """The bf16 CUDA route's arithmetic (``csrc/ssd_chunks.cu``, namespace
    ``tc``) in torch: G = C B^T in f32 from the bf16 inputs (exact
    products); W = G o Lambda o dt_j and B o sw in f32, each split into
    hi = bf16(v) and lo = bf16(v - hi); y = W_hi x + W_lo x and state =
    (B o sw)_hi^T x + (B o sw)_lo^T x, products of bf16 values summed in
    f32.  ``split=False`` runs one bf16 pass (hi only)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    bf = bmat.float().reshape(b, nc, chunk, n)
    cf = cmat.float().reshape(b, nc, chunk, n)
    a_cum = torch.cumsum(dtf * a.float(), dim=2)
    a_tot = a_cum[:, :, -1, :]
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[None, None, :, :, None]
    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]
    lam = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)
    g = torch.einsum("bcin,bcjn->bcij", cf, bf)
    w = g[..., None] * lam * dtf[:, :, None, :, :]  # (B, NC, L, L, H)
    sw = dtf * torch.exp(a_tot[:, :, None, :] - a_cum)  # (B, NC, L, H)
    bsw = bf[..., None] * sw[:, :, :, None, :]  # (B, NC, L, N, H)
    w_hi, w_lo = _split(w)
    b_hi, b_lo = _split(bsw)
    y = torch.einsum("bcijh,bcjhp->bcihp", w_hi, xf)
    states = torch.einsum("bcjnh,bcjhp->bchnp", b_hi, xf)
    if split:
        y = y + torch.einsum("bcijh,bcjhp->bcihp", w_lo, xf)
        states = states + torch.einsum("bcjnh,bcjhp->bchnp", b_lo, xf)
    return y.reshape(b, s, h, p), states, torch.exp(a_cum).reshape(b, s, h), torch.exp(a_tot)


def _within(got, want, tol):
    atol, rtol = tol
    return bool(((got.double() - want.double()).abs() <= atol + rtol * want.double().abs()).all())


def test_bf16_route_split_meets_ssd_tol_at_mamba2_chunk_and_one_pass_does_not(rng):
    """At mamba2's chunk (L 128, N 128, P 64; two chunks, four heads) the
    split products stay within chip_smoke's SSD_TOL of an f64 computation,
    every output on its own; one bf16 pass of W and B o sw does not, which
    is why the kernel runs each product twice."""
    x, dt, a, bm, cm = _card_inputs(rng, 1, 256, 4, 64, 128)
    want = ssd.ssd_chunks_torch(x, dt, a, bm, cm, chunk=128, dtype=torch.float64)
    got = _ssd_bf16_route_arithmetic(x, dt, a, bm, cm, chunk=128)
    for name, g, w in zip(("y", "states", "cumdecay", "totals"), got, want):
        assert _within(g, w, SSD_TOL[name]), name
    one = _ssd_bf16_route_arithmetic(x, dt, a, bm, cm, chunk=128, split=False)
    assert not _within(one[0], want[0], SSD_TOL["y"])
    assert not _within(one[1], want[1], SSD_TOL["states"])


def test_bf16_route_arithmetic_matches_pallas_interpret(rng):
    """At a small size (S 64 in chunks of 32, N 16, P 8) the bf16 route's
    arithmetic agrees with the reference's Pallas kernel in interpret mode
    within SSD_TOL."""
    x, dt, a, bm, cm = _card_inputs(rng, 2, 64, 3, 8, 16)
    jx, jb, jc = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, bm, cm))
    want = ssd_chunks_pallas(jx, jnp.asarray(dt.numpy()), jnp.asarray(a.numpy()), jb, jc,
                             chunk=32, interpret=True)
    got = _ssd_bf16_route_arithmetic(x, dt, a, bm, cm, chunk=32)
    for name, g, w in zip(("y", "states", "cumdecay", "totals"), got, want):
        assert _within(g, torch.from_numpy(np.array(w)), SSD_TOL[name]), name


@pytest.mark.parametrize("s,chunk,n,p", [(512, 256, 16, 8), (128, 64, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunks_at_the_shapes_the_old_limits_refused(s, chunk, n, p, dtype, rng):
    """Chunk 256 (Mamba-2's published default), and N 256 with P 128: the
    plain version and the CPU wrapper against the Pallas kernel in
    interpret mode.  f32 sums over N = 256 in another order: atol 2e-5
    plus 1e-5 of the value (|y| up to ~1e2 there)."""
    x, dt, a, bm, cm, _ = _inputs(rng, 1, s, 2, p, n)
    if dtype == "bfloat16":
        x, bm, cm = (v.astype(ml_dtypes.bfloat16) for v in (x, bm, cm))
    want = ssd_chunks_pallas(_j(x), _j(dt), _j(a), _j(bm), _j(cm), chunk=chunk, interpret=True)
    for fn in (ssd.ssd_chunks_torch, ssd.ssd_chunks):
        got = fn(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


def test_tma_operands_and_bf16_route_grid():
    """The bf16 route's operands through ``build.tma_operand``: views TMA
    can load pass through, others are copied, and N or P not a multiple of
    8 is zero-padded (the grid itself is sized in the C entry point)."""
    base = torch.zeros(1, 64, 5376, dtype=torch.bfloat16)  # mamba2's conv channels
    view = base[..., 5120:5248]  # B: a slice of the conv output
    assert build.tma_operand(view) is view
    odd = torch.zeros(2, 64, 100, dtype=torch.bfloat16)[..., :96]  # 200-byte rows
    assert build.tma_operand(odd).is_contiguous()
    x = torch.arange(2 * 6 * 3 * 12, dtype=torch.bfloat16).reshape(2, 6, 3, 12)
    xp = build.tma_operand(x)
    assert xp.shape == (2, 6, 3, 16) and torch.equal(xp[..., :12], x)
    assert not xp[..., 12:].any()

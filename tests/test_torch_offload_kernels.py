"""The port's offload-shelf kernels against the JAX package, on the CPU.

The CUDA kernels (``csrc/matmul.cu``, ``csrc/complex_matmul.cu``) cannot
run here: their wrappers take the plain PyTorch versions for CPU tensors,
and ``chip_smoke.py`` holds each kernel against that plain version on the
card.  These tests hold the wrappers' contract (tiling and contraction
errors) and the plain versions against the Pallas kernels in interpret
mode, as ``tests/test_kernels_{matmul,fft,lu}.py`` run them, on the same
numpy inputs.

Tolerances: matmul/schur/complex matmul 2e-5 relative (+ 2e-4 absolute on
unit-normal operands summed over K <= 512: the same f32 products summed
in another order); fft2d 1e-5 of the spectrum's max (two f32 DFT stages,
as the reference's own test); LU: identical pivots and d, packed factors
within 1e-4 (the same f32 eliminations; dot products in the triangular
solve summed in another order).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import matrix as jmatrix
from repro.kernels import ops as jops
from repro.kernels.fft import complex_matmul_pallas
from repro.kernels.matmul import matmul_pallas, schur_update_pallas
from repro_torch.core import blocks
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import launch_counts, ops as tops, ref as tref
from repro_torch.kernels import matmul as tmm

SHAPES = [(128, 128, 128), (256, 128, 128), (128, 384, 256), (256, 256, 512)]


def _chip_smoke():
    """chip_smoke.py at the repository root (its tolerances), loaded by path."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=2e-5, atol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_plain_matches_pallas(m, k, n, rng):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = matmul_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = tmm.matmul(_t(a), _t(b))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("m,k,n", SHAPES[:2])
def test_schur_update_plain_matches_pallas(m, k, n, rng):
    c = rng.standard_normal((m, n)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = schur_update_pallas(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), interpret=True)
    _close(tmm.schur_update(_t(c), _t(a), _t(b)), want)


@pytest.mark.parametrize("bm,bn,bk", [(128, 128, 128), (128, 256, 128), (256, 128, 256)])
def test_block_size_sweep(bm, bn, bk, rng):
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    c = rng.standard_normal((256, 256)).astype(np.float32)
    blocks_kw = dict(block_m=bm, block_n=bn, block_k=bk)
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    _close(tmm.matmul(_t(a), _t(b), **blocks_kw), matmul_pallas(ja, jb, interpret=True, **blocks_kw))
    _close(
        tmm.schur_update(_t(c), _t(a), _t(b), **blocks_kw),
        schur_update_pallas(jc, ja, jb, interpret=True, **blocks_kw),
    )
    yr, yi = tfft.complex_matmul(_t(a), _t(c), _t(b), _t(c.T.copy()), **blocks_kw)
    wr, wi = complex_matmul_pallas(ja, jc, jb, jnp.asarray(c.T.copy()), interpret=True, **blocks_kw)
    _close(yr, wr, atol=1e-3)
    _close(yi, wi, atol=1e-3)


def test_complex_matmul_plain_matches_pallas(rng):
    planes = [rng.standard_normal((128, 128)).astype(np.float32) for _ in range(4)]
    wr, wi = complex_matmul_pallas(*map(jnp.asarray, planes), interpret=True)
    yr, yi = tfft.complex_matmul(*map(_t, planes))
    _close(yr, wr, atol=1e-3)
    _close(yi, wi, atol=1e-3)


def test_untiled_shapes_and_contraction_mismatch_raise(rng):
    a = _t(rng.standard_normal((100, 128)).astype(np.float32))
    b = _t(rng.standard_normal((128, 128)).astype(np.float32))
    with pytest.raises(ValueError, match="must tile"):
        tmm.matmul(a, b)
    with pytest.raises(ValueError, match="contraction mismatch"):
        tmm.matmul(b, a)
    with pytest.raises(ValueError, match="tile by the block sizes"):
        tmm.schur_update(a @ b, a, b)
    with pytest.raises(ValueError, match="c shape"):
        tmm.schur_update(b, a, b)
    with pytest.raises(ValueError, match="must tile"):
        tfft.complex_matmul(a, a, b, b)
    # the reference raises the same on its side
    with pytest.raises(ValueError):
        matmul_pallas(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), interpret=True)


def test_plain_wrappers_on_cpu_launch_nothing(rng):
    a = _t(rng.standard_normal((128, 128)).astype(np.float32))
    before = launch_counts()
    tmm.matmul(a, a)
    tmm.schur_update(a, a, a)
    tfft.complex_matmul(a, a, a, a)
    tops.fft2d(a.to(torch.complex64))
    assert launch_counts() == before


@pytest.mark.parametrize("variant,n,m", [
    ("direct", 128, 128), ("direct", 64, 128), ("four-step", 128, 128), ("four-step", 64, 128),
])
def test_fft2d_matches_pallas(variant, n, m, rng):
    x = (rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))).astype(np.complex64)
    want = np.asarray(jops.fft2d(jnp.asarray(x), backend="pallas", variant=variant, interpret=True))
    got = tops.fft2d(x, variant=variant, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == (n, m)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale < 1e-5
    assert np.abs(got.numpy() - np.fft.fft2(x)).max() / scale < 1e-5


def test_fft2d_block_targets_agree(rng):
    x = torch.from_numpy((rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))).astype(np.complex64))
    want = tref.fft2d_ref(x)
    for target in ("ref", "torch", "cuda"):
        with blocks.bind({"fft2d": target}):
            got = blocks.call("fft2d", x)
        assert (got - want).abs().max() / want.abs().max() < 1e-5, target
    assert blocks.registry.targets("lu") == ["cuda", "torch"]
    assert blocks.registry.targets("matmul") == ["cuda", "ref", "torch"]


@pytest.mark.parametrize("n,nb", [(96, None), (128, 64)])
def test_lu_matches_pallas(n, nb, rng):
    a = jmatrix.make_input(n, seed=n).astype(np.float32)
    a = a + 0.1 * rng.standard_normal((n, n)).astype(np.float32)  # generic pivots
    jlu, jpiv = jops.lu(jnp.asarray(a), nb=nb, backend="pallas", interpret=True)
    lu, piv = tops.lu(a, nb=nb, device="cpu")
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-4, atol=1e-4)
    rec = tref.lu_reconstruct(lu, piv)
    np.testing.assert_allclose(rec.numpy(), a, atol=5e-5)

    jlu, jindx, jd = jops.lu_nr_compat(jnp.asarray(a), backend="pallas", interpret=True)
    lu, indx, d = tops.lu_nr_compat(a, device="cpu")
    assert indx.dtype == torch.int32
    np.testing.assert_array_equal(indx.numpy(), np.asarray(jindx))
    assert float(d) == float(jd)


def test_lu_identity_padding_never_pivots_into_pad():
    a = jmatrix.make_input(100)
    lu, piv = tops.lu(a, device="cpu")  # nb=32: pads to 128
    assert int(piv.max()) < 100
    rec = tref.lu_reconstruct(lu, piv)
    np.testing.assert_allclose(rec.numpy(), a.astype(np.float32), atol=5e-5)


def test_ops_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.ones((4, 4))
    for fn in (tops.fft2d, tops.lu, tops.lu_nr_compat):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(x)


# -- the matmul kernel's 3xTF32 arithmetic ------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does: on the bit pattern, add half of the 13
    dropped bits' unit to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-3])
    got = _tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2.0 ** -10  # a tie rounds away from zero
    assert got[2] == 1.0 + 2.0 ** -10
    assert got[3] == -(1.0 + 2.0 ** -10)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert float((got[4] - x[4]).abs() / x[4]) <= 2.0 ** -11


def test_3xtf32_split_meets_gemm_tol_where_one_pass_does_not(rng):
    """The matmul kernel's design (``csrc/matmul.cu``): x = hi + lo with
    hi = tf32(x), lo = tf32(x - hi), and A_lo B_hi + A_hi B_lo + A_hi B_hi
    summed in f32 holds chip_smoke's GEMM_TOL against an f64 product at
    K = 2048; one TF32 pass (tf32(A) tf32(B)) does not."""
    atol, rtol = _chip_smoke().GEMM_TOL
    a = rng.standard_normal((64, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 64)).astype(np.float32)
    want = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    ta, tb = _t(a), _t(b)
    a_hi, b_hi = _tf32(ta), _tf32(tb)
    a_lo, b_lo = _tf32(ta - a_hi), _tf32(tb - b_hi)
    three = (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).double()
    one = (a_hi @ b_hi).double()
    limit = atol + rtol * want.abs()
    assert bool(((three - want).abs() <= limit).all())
    assert not bool(((one - want).abs() <= limit).all())
    assert float((one - want).abs().max()) > 10 * float((three - want).abs().max())


# -- the TMA GEMM body shared by matmul, Schur update and complex matmul ---------------------


def _tc_product(legs) -> torch.Tensor:
    """The arithmetic of ``csrc/tf32_gemm.cuh``: the legs (A, B, sign) are
    walked in order in K steps of 32; each step's B is negated (when the
    sign is -1) before it is split, its three TF32 products A_lo B_hi +
    A_hi B_lo + A_hi B_hi form a fresh f32 partial, and the partial is
    added in f32 to the running sum."""
    acc = torch.zeros((legs[0][0].shape[0], legs[0][1].shape[1]))
    for a, b, sign in legs:
        for k0 in range(0, a.shape[1], 32):
            ak, bk = a[:, k0:k0 + 32], sign * b[k0:k0 + 32]
            a_hi, b_hi = _tf32(ak), _tf32(bk)
            a_lo, b_lo = _tf32(ak - a_hi), _tf32(bk - b_hi)
            acc = acc + (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi)
    return acc


def _tc_complex(ar, ai, br, bi):
    """The complex kernel's block form: the real plane walks (Ar, Br) then
    (Ai, -Bi), the imaginary plane (Ar, Bi) then (Ai, Br)."""
    return (_tc_product([(ar, br, 1.0), (ai, bi, -1.0)]),
            _tc_product([(ar, bi, 1.0), (ai, br, 1.0)]))


def _within(got: torch.Tensor, want, atol: float, rtol: float) -> bool:
    want = torch.as_tensor(np.asarray(want, dtype=np.float64))
    return bool(((got.double() - want).abs() <= atol + rtol * want.abs()).all())


def test_negated_split_is_the_split_negated(rng):
    """Negating B before the split costs nothing: tf32 rounds to nearest
    with ties away from zero, symmetric in the sign, so the hi and lo of
    -x are exactly -hi and -lo."""
    x = _t(rng.standard_normal(4096).astype(np.float32))
    hi = _tf32(x)
    assert torch.equal(_tf32(-x), -hi)
    assert torch.equal(_tf32(-x - _tf32(-x)), -_tf32(x - hi))


def test_complex_tc_arithmetic_meets_gemm_tol(rng):
    """The complex kernel's arithmetic (block form, leg order, negated Bi
    split, 3xTF32 per 32-wide step promoted in f32) holds chip_smoke's
    GEMM_TOL (1e-3 + 1e-4 relative) against an f64 complex product at
    K = 2048, and against the Pallas kernel in interpret mode at 128^3."""
    atol, rtol = _chip_smoke().GEMM_TOL
    ar, ai = (rng.standard_normal((32, 2048)).astype(np.float32) for _ in range(2))
    br, bi = (rng.standard_normal((2048, 32)).astype(np.float32) for _ in range(2))
    want = (ar + 1j * ai).astype(np.complex128) @ (br + 1j * bi).astype(np.complex128)
    yr, yi = _tc_complex(*map(_t, (ar, ai, br, bi)))
    assert _within(yr, want.real, atol, rtol) and _within(yi, want.imag, atol, rtol)

    planes = [rng.standard_normal((128, 128)).astype(np.float32) for _ in range(4)]
    wr, wi = complex_matmul_pallas(*map(jnp.asarray, planes), interpret=True)
    yr, yi = _tc_complex(*map(_t, planes))
    assert _within(yr, wr, atol, rtol) and _within(yi, wi, atol, rtol)


@pytest.mark.parametrize("m,n,k", [(32, 32, 2048), (128, 128, 128), (160, 160, 32)])
def test_schur_tc_arithmetic_meets_gemm_tol(m, n, k, rng):
    """The Schur kernel's arithmetic, C minus the 3xTF32 sum of A @ B in
    promoted 32-wide steps (subtracted in the epilogue), holds GEMM_TOL
    against f64 at K up to 2048 and against the Pallas kernel in
    interpret mode."""
    atol, rtol = _chip_smoke().GEMM_TOL
    c = rng.standard_normal((m, n)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = _t(c) - _tc_product([(_t(a), _t(b), 1.0)])
    want = c.astype(np.float64) - a.astype(np.float64) @ b.astype(np.float64)
    assert _within(got, want, atol, rtol)
    blk = dict(block_m=m, block_n=n, block_k=min(k, 128))
    pallas = schur_update_pallas(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), interpret=True, **blk)
    assert _within(got, pallas, atol, rtol)


def test_tma_operands_pad_ragged_copy_misaligned_pass_aligned(rng):
    """The TMA kernels' operand helper: K and N padded to multiples of 4
    with zeros (integer-valued operands make every product and sum exact
    in f32, so the padded product must equal the plain one bit for bit),
    a misaligned view copied unchanged, aligned operands passed as the
    same tensors."""
    def ints(*shape):
        return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32)).clone()

    a, b, c = ints(7, 9), ints(9, 6), ints(7, 6)
    (ap,), (bp,), cp = tmm.tma_operands([a], [b], c)
    assert (ap.shape, bp.shape, cp.shape) == ((7, 12), (12, 8), (7, 8))
    assert all(x.data_ptr() % 16 == 0 for x in (ap, bp, cp))
    assert torch.equal((ap @ bp)[:, :6], a @ b)
    assert torch.equal((cp - ap @ bp)[:, :6], c - a @ b)
    (ar, ai), (br, bi), _ = tmm.tma_operands([a, c[:, :5].contiguous()], [b, b])
    assert ar.shape == ai.shape == (7, 12) and br.shape == bi.shape == (12, 8)

    base = torch.zeros(1 + 8 * 8)
    view = base[1:].view(8, 8)
    view.copy_(ints(8, 8))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    (va,), _, _ = tmm.tma_operands([view], [ints(8, 12)])
    assert va is not view and va.data_ptr() % 16 == 0 and torch.equal(va, view)

    x, y, z = ints(8, 12), ints(12, 16), ints(8, 16)
    (xa,), (ya,), za = tmm.tma_operands([x], [y], z)
    assert xa is x and ya is y and za is z

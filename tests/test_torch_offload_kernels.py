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

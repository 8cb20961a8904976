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

import types

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
    # the kernel's one wave of CTAs
    assert ssd.heads_per_cta(1, 4, 80, 132) == 3
    assert ssd.heads_per_cta(1, 4, 112, 132) == 4
    assert ssd.heads_per_cta(1, 1, 80, 132) == 1


def test_ssd_chunks_off_the_cpu_goes_to_the_kernel_and_raises_without_nvcc(monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no nvcc the
    launch raises.  (Meta tensors stand in for CUDA ones here.)"""
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: types.SimpleNamespace(multi_processor_count=132),
    )
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
    wide = torch.empty((1, 32, 2, 72), dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="P <= 64"):  # past the kernel's limits
        ssd.ssd_chunks(wide, dt, a, bm, bm, chunk=32)


def test_ssd_scan_block_targets_and_pattern_db_entry(rng):
    assert blocks.registry.targets("ssd_scan") == ["cuda", "ref", "torch"]
    impl = default_db().get("ssd_scan").resolve()
    assert impl is ops.ssd_scan
    x, dt, a, bm, cm, _ = _inputs(rng, 1, 20, 2, 4, 8)
    y, hfin = impl(*map(_t, (x, dt, a, bm, cm)), chunk=8)
    want_y, want_h = ref.ssd_ref(*map(_t, (x, dt, a, bm, cm)))
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(hfin.numpy(), want_h.numpy(), rtol=0, atol=ATOL)

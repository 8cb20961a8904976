"""RMSNorm's three forms (``repro_torch.kernels.rmsnorm``) against the JAX
package, and the models' norm sites.

- The add form's plain version against the reference's composition (``x +
  delta`` in x's dtype, then ``rmsnorm_pallas`` in interpret mode and
  ``ref.rmsnorm_ref``); the gated form's against the reference's lines of
  ``repro/models/ssm.py`` evaluated in ``jnp``; the plain form with a bf16
  weight against ``rmsnorm_pallas``.
- The CUDA wrappers' host side: what each passes to the C entry point
  (pointers, strides, plan, vector flag) is read back by an emulation of
  the kernel over CPU memory and held against the plain versions.
- Reduced llama and mamba2 forwards route every norm through the shelf's
  ``rmsnorm`` block, and every residual add lands in a norm.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels.ref import rmsnorm_ref as jrmsnorm_ref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import blocks
from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as trms
from repro_torch.models import lm

# bf16 outputs rounded once from f32 by both sides: one bf16 step apart at most
BF16_RTOL = 2.0 ** -8
EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _tdtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# XLA and torch sum a row's squares in another order: f32 norms sit a few
# ulps apart (~3e-7 relative seen at d 64-100); rounded to bf16 they agree
F32_ULPS = dict(rtol=1e-6, atol=1e-7)


def _same_norm(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32_ULPS)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


# -- plain versions against the reference ------------------------------------------


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_matches_reference_composition(dtype, d, rng):
    """s = x + delta rounded to x's dtype is bit-identical to the
    reference's add in both dtypes; the norm of it matches rmsnorm_pallas
    (interpret) and ref.rmsnorm_ref bit for bit in bf16 and within F32_ULPS
    in f32."""
    x = rng.standard_normal((3, 5, d)).astype(np.float32) * 3
    delta = rng.standard_normal((3, 5, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jx, jdelta = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (x, delta))
    js = jx + jdelta
    tdt = _tdtype(dtype)
    s, y = trms.add_rmsnorm(_t(x).to(tdt), _t(delta).to(tdt), _t(w), eps=EPS)
    assert s.dtype == y.dtype == tdt and s.shape == y.shape == (3, 5, d)
    np.testing.assert_array_equal(_np(s), _np(js))
    for want in (rmsnorm_pallas(js, jnp.asarray(w), eps=EPS, interpret=True),
                 jrmsnorm_ref(js, jnp.asarray(w), eps=EPS)):
        _same_norm(y, want, dtype)


def _reference_gated_lines(y, x, d_skip, z, w, eps, cdty):
    """``repro/models/ssm.py:149-157`` up to the out_proj product, in jnp."""
    b, seq = y.shape[:2]
    di = y.shape[2] * y.shape[3]
    y = y + d_skip.astype(jnp.float32)[None, None, :, None] * x.astype(jnp.float32)
    y = y.reshape(b, seq, di)
    g = y * jax.nn.silu(z.astype(jnp.float32))
    ms = jnp.mean(g * g, axis=-1, keepdims=True)
    g = g * jax.lax.rsqrt(ms + eps) * w.astype(jnp.float32)
    return g.astype(cdty)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_reference_lines(dtype, rng):
    """f32 y, x and z in the compute dtype (z cut from a wider row, as the
    block cuts it from in_proj's output): f32 within 1e-5 (the same
    formula, reduced in another order), bf16 within one bf16 step."""
    b, seq, h, p = 2, 3, 4, 16
    di = h * p
    y = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    zx = rng.standard_normal((b, seq, di + 9)).astype(np.float32) * 2
    d_skip = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(di)).astype(np.float32)
    cd = jnp.dtype(dtype)
    want = _reference_gated_lines(
        jnp.asarray(y), jnp.asarray(x).astype(cd), jnp.asarray(d_skip),
        jnp.asarray(zx).astype(cd)[..., :di], jnp.asarray(w), EPS, cd,
    )
    tdt = _tdtype(dtype)
    got = trms.gated_rmsnorm(_t(y), _t(x).to(tdt), _t(d_skip), _t(zx).to(tdt)[..., :di],
                             _t(w), eps=EPS)
    assert got.dtype == tdt and got.shape == (b, seq, di)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_with_bf16_weight_matches_pallas(dtype, rng):
    """The reference casts whatever weight it gets; so does the port (its
    first wrapper refused a bf16 weight on the card)."""
    x = rng.standard_normal((4, 7, 96)).astype(np.float32) * 2
    w = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = rmsnorm_pallas(jx, jw, eps=EPS, interpret=True)
    got = trms.rmsnorm(_t(x).to(_tdtype(dtype)), _t(w).to(torch.bfloat16), eps=EPS)
    _same_norm(got, want, dtype)


# -- the CUDA wrappers' host side, read back by an emulated kernel ----------------


def _read(ptr, offsets, code):
    """Elements at ``ptr`` + ``offsets`` (in elements) as float32."""
    n = int(offsets.max()) + 1
    if code == 0:
        return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))[offsets].copy()
    u = np.ctypeslib.as_array((ctypes.c_uint16 * n).from_address(ptr))[offsets]
    return (u.astype(np.uint32) << 16).view(np.float32)


def _write(ptr, vals, code):
    t = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    t = t if code == 0 else t.to(torch.bfloat16)
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


class KernelEmulator:
    """Stands in for ``build.launch("repro_rmsnorm", ...)``: checks what the
    C entry point checks, then computes each row from the memory the
    arguments point at, as the kernel reads it (element (h, p) of row r at
    batch r // seq, sequence r % seq, through each operand's four strides),
    and writes s and out as contiguous rows."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        assert name == "repro_rmsnorm"
        # the arguments ctypes will convert: one of the right kind each
        argtypes = build.ENTRY_POINTS[name]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            want = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
                    ctypes.c_longlong: int, ctypes.c_float: float}[kind]
            assert isinstance(arg, want) and (kind is not ctypes.c_int or -2**31 <= arg < 2**31)
        form, a, b, c, skip, w, s_out, out, *rest = args
        strides = np.asarray(rest[:12]).reshape(3, 4)
        rows, seq, d, head_dim, eps, dtype, w_dtype, tpr, nv, _stream = rest[12:]
        chunks = -(-d // 8)
        assert 32 <= tpr <= 512 and tpr % 32 == 0
        assert nv in (0, 1, 2) and (nv == 0 or chunks <= nv * tpr)
        assert rows > 0 and seq > 0 and rows % seq == 0 and d > 0 and d % head_dim == 0
        self.calls.append(dict(form=trms.FORMS[form], tpr=tpr, nv=nv,
                               strides=[tuple(map(int, st)) for st in strides]))
        i = np.arange(d)
        h, p = i // head_dim, i % head_dim

        def row(ptr, st, r, code):
            bb, t = divmod(r, seq)
            return _read(ptr, bb * st[0] + t * st[1] + h * st[2] + p * st[3], code)

        wv = _read(w, i, w_dtype)
        e = 4 if dtype == 0 else 2
        for r in range(rows):
            if form == 2:
                yv, xv, zv = row(a, strides[0], r, 0), row(b, strides[1], r, dtype), \
                    row(c, strides[2], r, dtype)
                sk = _read(skip, np.arange(d // head_dim), w_dtype)[h]
                v = (yv + sk * xv) * (zv / (1 + np.exp(-zv)))
            else:
                v = row(a, strides[0], r, dtype)
                if form == 1:
                    _write(s_out + e * r * d, v + row(b, strides[1], r, dtype), dtype)
                    v = _read(s_out + e * r * d, i, dtype)  # rounded to x's type
            inv = 1 / np.sqrt(np.mean(v * v, dtype=np.float64) + eps)
            _write(out + e * r * d, v * np.float32(inv) * wv, dtype)


@pytest.fixture
def emulated(monkeypatch):
    emu = KernelEmulator()
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", emu)
    kernels.reset_launches()
    yield emu
    kernels.reset_launches()


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("rows,d,dtype,wdtype", [
    (8, 64, torch.float32, torch.float32),
    (5, 100, torch.float32, torch.float32),  # ragged d: the scalar path
    (3, 2056, torch.bfloat16, torch.bfloat16),
    (2, 9000, torch.bfloat16, torch.float32),  # past the registers: two passes
])
def test_plain_and_add_wrappers_launch_what_the_kernel_reads(emulated, rows, d, dtype, wdtype,
                                                             rng):
    x = _t(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype)
    delta = _t(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype)
    w = _t((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(wdtype)
    _close(trms._rmsnorm_cuda(x, w, EPS), trms.rmsnorm_torch(x, w, EPS), dtype)
    s, y = trms._add_rmsnorm_cuda(x, delta, w, EPS)
    s_want, y_want = trms.add_rmsnorm_torch(x, delta, w, EPS)
    assert torch.equal(s, s_want)
    _close(y, y_want, dtype)
    plan = trms.norm_plan(d)
    assert [c["form"] for c in emulated.calls] == ["plain", "add"]
    assert all((c["tpr"], c["nv"]) == dataclasses.astuple(plan) for c in emulated.calls)
    assert trms.rmsnorm.forms == {"plain": 1, "add": 1, "gated": 0}
    assert kernels.launch_counts()["rmsnorm"] == 2


@pytest.mark.parametrize("b,seq,h,p,width", [
    (2, 3, 8, 16, 2 * 128 + 8 + 8),  # a Mamba-2 in_proj row: 16-byte strides
    (1, 4, 6, 20, 2 * 120 + 12),  # head dim 20: the scalar path
    (3, 1, 4, 16, 64 + 3),  # z's row stride not a multiple of 8
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_wrapper_reads_operands_in_place(emulated, b, seq, h, p, width, dtype, rng):
    """x is a column slice of a wider row laid out head dim outermost (as a
    conv or einsum may return it on the card), z a column slice of
    in_proj's output, y a sequence slice of a longer (padded) scan output:
    the wrapper hands the kernel each view's strides and copies nothing."""
    di = h * p
    zx = _t(rng.standard_normal((b, seq, width)).astype(np.float32)).to(dtype)
    xbc_t = _t(rng.standard_normal((di + 24, seq, b)).astype(np.float32)).to(dtype)
    y_pad = _t(rng.standard_normal((b, seq + 5, h, p)).astype(np.float32))
    z, y = zx[..., :di], y_pad[:, :seq]
    x = xbc_t.permute(2, 1, 0)[..., :di].reshape(b, seq, h, p)
    assert x.data_ptr() == xbc_t.data_ptr()  # a view
    d_skip = _t((1 + 0.1 * rng.standard_normal(h)).astype(np.float32))
    w = _t((1 + 0.1 * rng.standard_normal(di)).astype(np.float32))
    got = trms._gated_rmsnorm_cuda(y, x, d_skip, z, w, EPS)
    _close(got, trms.gated_rmsnorm_torch(y, x, d_skip, z, w, EPS), dtype)
    (call,) = emulated.calls

    def strides(t):
        return tuple(st if n > 1 else 0 for n, st in zip(t.shape, t.stride()))

    assert call["form"] == "gated"
    assert call["strides"] == [strides(y), strides(x), strides(z.unflatten(-1, (h, p)))]
    assert trms.rmsnorm.forms["gated"] == 1


def test_wrappers_raise_on_layouts_they_do_not_take(emulated):
    f32, bf16 = torch.float32, torch.bfloat16
    x, w = torch.ones(2, 3, 64, dtype=bf16), torch.ones(64)
    with pytest.raises(ValueError, match="w must be"):
        trms._rmsnorm_cuda(x, torch.ones(32), EPS)
    with pytest.raises(ValueError, match="w must be"):
        trms._rmsnorm_cuda(x, torch.ones(64, dtype=torch.float16), EPS)
    with pytest.raises(ValueError, match="delta must be"):
        trms._add_rmsnorm_cuda(x, torch.ones(2, 3, 64, dtype=f32), w, EPS)
    y, xs, z = torch.ones(2, 3, 4, 16), torch.ones(2, 3, 4, 16, dtype=bf16), torch.ones(2, 3, 64, dtype=bf16)
    d_skip = torch.ones(4)
    with pytest.raises(ValueError, match="y must be float32"):
        trms._gated_rmsnorm_cuda(y.to(bf16), xs, d_skip, z, w, EPS)
    with pytest.raises(ValueError, match="z must be"):
        trms._gated_rmsnorm_cuda(y, xs, d_skip, z[..., :32], w, EPS)
    with pytest.raises(ValueError, match="share a type"):
        trms._gated_rmsnorm_cuda(y, xs, d_skip.to(bf16), z, w, EPS)
    with pytest.raises(ValueError, match="not both"):
        trms.rmsnorm(x, w, EPS, delta=x, gate=(xs, d_skip, z))
    assert emulated.calls == []


def test_norm_plan_at_the_paths_widths():
    """A CTA a row, the row in registers up to d = 8192, one or two chunks
    of 8 a thread; the two-pass loop takes longer rows."""
    want = {2048: (256, 1), 2560: (320, 1), 3584: (448, 1), 5120: (320, 2), 7168: (448, 2),
            8192: (512, 2), 8200: (512, 0), 100: (32, 1), 2050: (288, 1)}
    for d, (tpr, nv) in want.items():
        assert trms.norm_plan(d) == trms.NormPlan(tpr, nv), d
    for d in range(1, 20000, 37):
        plan = trms.norm_plan(d)
        chunks = -(-d // 8)
        assert plan.tpr % 32 == 0 and 32 <= plan.tpr <= 512
        # every chunk has a thread, and under a warp of threads idles
        assert plan.nv == 0 or plan.nv * (plan.tpr - 32) < chunks <= plan.nv * plan.tpr


# -- the models' norm sites ---------------------------------------------------------


class _CountAdds(TorchFunctionMode):
    """Counts residual adds, ``a + b`` of two (B, S, d_model) tensors, made
    outside the rmsnorm block."""

    def __init__(self, d_model):
        super().__init__()
        self.d_model, self.adds, self.inside = d_model, 0, False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not self.inside and func in (torch.Tensor.__add__, torch.Tensor.add, torch.add)
                and all(isinstance(a, torch.Tensor) and a.ndim == 3
                        and a.shape[-1] == self.d_model for a in args[:2])):
            self.adds += 1
        return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", "zamba2-7b"])
def test_every_norm_goes_through_the_shelf_and_takes_the_residual_add(arch, monkeypatch, rng):
    cfg = get_config(arch).reduced()
    n = cfg.n_layers
    impl = blocks.registry._impls["rmsnorm"]["torch"]
    seen = []
    counter = _CountAdds(cfg.d_model)

    def counted(*args, **kw):
        seen.append("add" if "delta" in kw else "gated" if "gate" in kw else "plain")
        counter.inside = True
        try:
            return impl.fn(*args, **kw)
        finally:
            counter.inside = False

    monkeypatch.setitem(blocks.registry._impls["rmsnorm"], "torch",
                        dataclasses.replace(impl, fn=counted))
    params = lm.init_params(cfg, seed=0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))
    pat = cfg.pattern()
    attn, mamba = sum(c != "m" for c in pat), pat.count("m")
    with counter:
        lm.forward(params, {"tokens": tokens}, cfg, "prefill", lm.init_cache(cfg, 2, 16))
    # a forward: the first block's norm plain, every other norm (ln2, the
    # next blocks' first norms, the final norm) fused with the add before it
    assert seen.count("plain") == 1
    assert seen.count("add") == 2 * attn + mamba
    assert seen.count("gated") == mamba
    assert len(seen) == 1 + 2 * n
    assert counter.adds == 0
    seen.clear()
    with counter:  # backbone alone applies the last add itself: the one left
        lm.backbone(params, {"tokens": tokens}, cfg, "prefill", lm.init_cache(cfg, 2, 16))
    assert counter.adds == 1 and seen.count("add") == 2 * attn + mamba - 1

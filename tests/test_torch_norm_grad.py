"""RMSNorm's backward: the plain versions of the backward kernel against
``jax.vjp`` of the reference's composition (``ref.rmsnorm_ref``; the add
form ``s = x + delta`` in x's dtype, then the norm, with a gradient on
both outputs), the autograd Functions' wiring, and the CUDA wrapper's host
side: the arguments ``_rmsnorm_bwd_cuda`` passes, read back by a numpy
emulation of the two kernels (per-CTA dw partials summed in CTA order,
``build.launch`` patched), as ``test_torch_norms.py`` does for the forward.

Tolerances: f32 within 1e-5 (the same formula summed in another order);
bf16 within two bf16 steps (2^-7 relative): both sides compute in f32 and
round once, but the reference's add form rounds the norm's gradient to
bf16 before adding the residual's, the port rounds the f32 sum (there the
tolerance is two bf16 steps of the addends, which may cancel).  dw is f32
in both (an f32 weight) and held to 1e-5 relative to its largest value.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rmsnorm_ref as jrmsnorm_ref
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as trms

EPS = 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=1e-3)


def _dw_close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def _inputs(rng, rows, d, dtype, n=3):
    out = [torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dtype)
           for _ in range(n)]
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    return out, w


def _jax(t):
    a = t.float().numpy()
    return jnp.asarray(a).astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_reference_vjp(dtype, d, rng):
    (x, dy, _), w = _inputs(rng, 6, d, dtype)
    _, vjp = jax.vjp(lambda x, w: jrmsnorm_ref(x, w, EPS), _jax(x), jnp.asarray(w.numpy()))
    jdx, jdw = vjp(_jax(dy))
    dx, dw = trms.rmsnorm_bwd_torch(x, dy, w, EPS)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _close(dx, jdx, dtype)
    _dw_close(dw, jdw)


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_backward_matches_reference_vjp(dtype, d, rng):
    """The add form: the gradient reaching ``s`` is the norm's plus the
    residual stream's own (``ds``); both ``x`` and ``delta`` get it."""
    (x, delta, dy), w = _inputs(rng, 6, d, dtype)
    ds = torch.from_numpy(rng.standard_normal((6, d)).astype(np.float32)).to(dtype)

    def composition(x, delta, w):
        s = x + delta.astype(x.dtype)
        return s, jrmsnorm_ref(s, w, EPS)

    _, vjp = jax.vjp(composition, _jax(x), _jax(delta), jnp.asarray(w.numpy()))
    jdx, jddelta, jdw = vjp((_jax(ds), _jax(dy)))
    s = x + delta
    dx, dw = trms.rmsnorm_bwd(s, dy, w, EPS, ds=ds)  # CPU: the plain version
    if dtype == torch.float32:
        _close(dx, jdx, dtype)
        _close(dx, jddelta, dtype)
    else:
        # the reference rounds the norm's gradient (|.| up to ~4 here) to
        # bf16 before adding ds: where the two cancel, the sums sit up to a
        # bf16 step of the addends apart
        atol = 2.0 ** -7 * 4
        for want in (jdx, jddelta):
            np.testing.assert_allclose(_np(dx), _np(want), rtol=2.0 ** -7, atol=atol)
    _dw_close(dw, jdw)


def test_autograd_through_the_plain_forms_matches_the_plain_backward(rng):
    """The plain forward forms under autograd (the CPU path, and the
    ``torch`` target on the card) give the plain backward's gradients."""
    (x, delta, dy), w = _inputs(rng, 5, 48, torch.float32)
    ds = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32))
    xs = [t.clone().requires_grad_(True) for t in (x, delta, w)]
    s, y = trms.rmsnorm(xs[0], xs[2], EPS, delta=xs[1])
    gx, gdelta, gw = torch.autograd.grad((s, y), xs, (ds, dy))
    dx, dw = trms.rmsnorm_bwd_torch(x + delta, dy, w, EPS, ds=ds)
    for got, want in ((gx, dx), (gdelta, dx), (gw, dw)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


# -- the CUDA wrapper's host side, against an emulation of the kernels ---------------


def _read(ptr, n, code):
    dt = torch.float32 if code == 0 else torch.bfloat16
    buf = torch.empty(n, dtype=dt)
    ctypes.memmove(buf.data_ptr(), ptr, n * buf.element_size())
    return buf.float().numpy()


def _write(ptr, vals, code):
    t = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    t = t if code == 0 else t.to(torch.bfloat16)
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


class BwdEmulator:
    """Stands in for ``build.launch("repro_rmsnorm_bwd", ...)``: checks what
    the C entry point checks, then computes each CTA's rows from the memory
    the arguments point at, writes dx, the CTA's dw partial row, and dw as
    the sum of the partial rows in CTA order."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, *args):
        assert name == "repro_rmsnorm_bwd"
        argtypes = build.ENTRY_POINTS[name]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            want = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want) and (kind is not ctypes.c_int or -2**31 <= arg < 2**31)
        x, dy, ds, w, dx, partial, dw, rows, d, eps, code, wcode, per_cta, tpr, nv, _ = args
        assert 32 <= tpr <= 512 and tpr % 32 == 0 and nv in (0, 1, 2)
        assert nv == 0 or -(-d // 8) <= nv * tpr
        n_cta = -(-rows // per_cta)
        self.calls.append(dict(add=ds is not None, n_cta=n_cta, per_cta=per_cta, tpr=tpr, nv=nv))
        xv = _read(x, rows * d, code).reshape(rows, d)
        dyv = _read(dy, rows * d, code).reshape(rows, d)
        wv = _read(w, d, wcode)
        r = 1 / np.sqrt((xv * xv).mean(-1, keepdims=True) + eps)
        c = r ** 3 * (xv * wv * dyv).mean(-1, keepdims=True)
        dxv = r * wv * dyv - xv * c
        if ds is not None:
            dxv = dxv + _read(ds, rows * d, code).reshape(rows, d)
        _write(dx, dxv, code)
        parts = np.stack([(dyv * xv * r)[i * per_cta:(i + 1) * per_cta].sum(0)
                          for i in range(n_cta)])
        _write(partial, parts, 0)
        total = np.zeros(d, np.float32)
        for row in _read(partial, n_cta * d, 0).reshape(n_cta, d):
            total = total + row
        _write(dw, total, wcode)


@pytest.fixture
def emulated(monkeypatch):
    emu = BwdEmulator()
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", emu)
    kernels.reset_launches()
    yield emu
    kernels.reset_launches()


@pytest.mark.parametrize("rows,d,dtype,wdtype", [
    (8, 64, torch.float32, torch.float32),
    (5, 100, torch.float32, torch.float32),  # ragged d: the scalar path
    (1100, 48, torch.bfloat16, torch.float32),  # more rows than CTAs: 3 rows a CTA
    (3, 2056, torch.bfloat16, torch.bfloat16),
    (2, 9000, torch.bfloat16, torch.float32),  # past the registers: two passes
])
def test_backward_wrapper_launches_what_the_kernels_read(emulated, rows, d, dtype, wdtype, rng):
    (x, dy, ds), w = _inputs(rng, rows, d, dtype)
    w = w.to(wdtype)
    for extra in ({}, {"ds": ds}):
        dx, dw = trms._rmsnorm_bwd_cuda(x, dy, w, EPS, extra.get("ds"))
        want_dx, want_dw = trms.rmsnorm_bwd_torch(x, dy, w, EPS, **extra)
        assert dx.dtype == dtype and dw.dtype == wdtype
        _close(dx, want_dx, dtype)
        if wdtype == torch.float32:
            _dw_close(dw, want_dw)
        else:
            np.testing.assert_allclose(_np(dw), _np(want_dw), rtol=2.0 ** -7, atol=1e-3)
    plan = trms.norm_plan(d)
    per_cta = -(-rows // trms.BWD_CTAS)
    assert [c["add"] for c in emulated.calls] == [False, True]
    assert all((c["tpr"], c["nv"], c["per_cta"]) == (plan.tpr, plan.nv, per_cta)
               for c in emulated.calls)
    assert all(c["n_cta"] <= trms.BWD_CTAS for c in emulated.calls)
    assert trms.rmsnorm_bwd.forms == {"plain": 1, "add": 1}
    assert kernels.launch_counts()["rmsnorm_bwd"] == 2


def test_backward_wrapper_raises_on_what_the_kernel_does_not_take(emulated):
    x, w = torch.ones(2, 64, dtype=torch.bfloat16), torch.ones(64)
    with pytest.raises(ValueError, match="dy must be"):
        trms._rmsnorm_bwd_cuda(x, torch.ones(2, 64), w, EPS, None)
    with pytest.raises(ValueError, match="ds must be"):
        trms._rmsnorm_bwd_cuda(x, x, w, EPS, torch.ones(2, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="w must be"):
        trms._rmsnorm_bwd_cuda(x, x, torch.ones(32), EPS, None)
    assert emulated.calls == []

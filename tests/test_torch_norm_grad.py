"""RMSNorm's backward: the plain versions of the backward kernel against
``jax.vjp`` of the reference's composition (``ref.rmsnorm_ref``; the add
form ``s = x + delta`` in x's dtype, then the norm, with a gradient on
both outputs), the autograd Functions' wiring, and the CUDA wrapper's host
side: the arguments ``_rmsnorm_bwd_cuda`` passes, read back by a numpy
emulation of the two kernels (rows dealt to the persistent grid's row
groups, each CTA's groups' dw terms added in group order into one partial
row, the partial rows summed a column at a time by sixteen lanes and a
fixed tree; ``build.launch`` patched), as ``test_torch_norms.py`` does for the
forward; and the backward's plan (``bwd_plan``) at the main paths' shapes.

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


#: lanes of the dw reduction's CTA over the partial rows (``csrc/rmsnorm_bwd.cu``: kDwLanes)
DW_LANES = 16


def group_rows(rows, plan):
    """The rows each row group of the grid takes, in its order: group k
    (CTA k // groups, its group k % groups) takes k, k + G, k + 2G, ...
    with G the grid's groups."""
    n_groups = plan.ctas * plan.groups
    return [range(k, rows, n_groups) for k in range(n_groups)]


def emulate_dw(terms, plan):
    """dw from the per-row terms ``dy * x * r`` (rows, d), f32, in the
    kernels' fixed order: each group sums its rows in order, a CTA adds its
    groups in group order into its partial row, and a column's partial rows
    are summed by lane l over rows l, l + 16, ..., the lanes then added by
    a tree (lane l += lane l + 8, then l + 4, l + 2, l + 1).  Returns
    (dw, the partial rows, the rows each group took)."""
    terms = np.asarray(terms, np.float32)
    taken = group_rows(terms.shape[0], plan)
    partial = np.zeros((plan.ctas, terms.shape[1]), np.float32)
    for cta in range(plan.ctas):
        for g in range(plan.groups):
            acc = np.zeros(terms.shape[1], np.float32)
            for row in taken[cta * plan.groups + g]:
                acc = acc + terms[row]
            partial[cta] = acc if g == 0 else partial[cta] + acc
    lanes = np.zeros((DW_LANES, terms.shape[1]), np.float32)
    for lane in range(DW_LANES):
        for p in range(lane, plan.ctas, DW_LANES):
            lanes[lane] = lanes[lane] + partial[p]
    o = DW_LANES // 2
    while o:
        lanes[:o] = lanes[:o] + lanes[o:2 * o]
        o //= 2
    return lanes[0], partial, taken


class BwdEmulator:
    """Stands in for ``build.launch("repro_rmsnorm_bwd", ...)``: checks what
    the C entry point checks, then computes dx from the memory the
    arguments point at, and the partial rows and dw in the kernels' order
    (:func:`emulate_dw`)."""

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
        (x, dy, ds, w, dx, partial, dw, rows, d, eps, code, wcode, ctas, groups, tpr, nv,
         stages, _) = args
        assert 32 <= tpr and tpr % 32 == 0 and 1 <= groups <= 16 and groups * tpr <= 512
        assert nv in (0, 1, 2) and (nv == 0 or -(-d // 8) <= nv * tpr)
        assert nv > 0 or groups == 1
        assert stages in (0, 2, 3, 4) and (stages == 0 or (nv > 0 and d % 8 == 0))
        ring = stages * groups * (3 if ds is not None else 2) * nv * tpr * 8 * (2 if code else 4)
        assert max(ring, groups * d * 4 if groups > 1 else 0) <= 232448 - 1024  # the CTA's smem
        plan = trms.BwdPlan(tpr, nv, groups, ctas, stages)
        self.calls.append(dict(add=ds is not None, plan=plan))
        xv = _read(x, rows * d, code).reshape(rows, d)
        dyv = _read(dy, rows * d, code).reshape(rows, d)
        wv = _read(w, d, wcode)
        r = 1 / np.sqrt((xv * xv).mean(-1, keepdims=True) + eps)
        c = r ** 3 * (xv * wv * dyv).mean(-1, keepdims=True)
        dxv = r * wv * dyv - xv * c
        if ds is not None:
            dxv = dxv + _read(ds, rows * d, code).reshape(rows, d)
        _write(dx, dxv, code)
        total, parts, _ = emulate_dw(dyv * xv * r, plan)
        _write(partial, parts, 0)
        _write(dw, total, wcode)


@pytest.fixture
def emulated(monkeypatch):
    emu = BwdEmulator()
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", emu)
    monkeypatch.setattr(trms, "_sm_count", lambda device: SMS)
    kernels.reset_launches()
    yield emu
    kernels.reset_launches()


#: the H100's SMs, as the wrapper reads them on the card
SMS = 132


@pytest.mark.parametrize("rows,d,dtype,wdtype", [
    (8, 64, torch.float32, torch.float32),
    (5, 100, torch.float32, torch.float32),  # ragged d: the scalar path
    (1100, 48, torch.bfloat16, torch.float32),  # a warp a row, many rows a group
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
    plans = [trms.bwd_plan(rows, d, SMS, x.element_size(), add) for add in (False, True)]
    assert [c["add"] for c in emulated.calls] == [False, True]
    assert [c["plan"] for c in emulated.calls] == plans
    assert all(p.ctas <= -(-rows // p.groups) for p in plans)  # no CTA without a row
    assert trms.rmsnorm_bwd.forms == {"plain": 1, "add": 1}
    assert kernels.launch_counts()["rmsnorm_bwd"] == 2


# (rows, d, itemsize, add) -> (tpr, nv, groups, ctas, stages) on 132 SMs: the
# main paths' shapes (llama's train norm, bf16 and f32, plain and add;
# deepseek-v2's kv_norm; arctic's d; f32 d = 100), few rows, a warp a row,
# a ring of two rows, and the two-pass loop
PLANS = {
    (4096, 2048, 2, False): (256, 1, 2, 264, 3),
    (4096, 2048, 2, True): (256, 1, 2, 264, 3),
    (4096, 2048, 4, True): (256, 1, 2, 132, 3),
    (256, 2048, 4, False): (256, 1, 2, 128, 3),
    (300, 2048, 2, False): (256, 1, 2, 150, 3),
    (512, 100, 4, False): (32, 1, 4, 128, 0),
    (1100, 48, 2, False): (32, 1, 9, 123, 3),
    (4096, 512, 2, False): (64, 1, 8, 264, 3),
    (37, 512, 2, True): (64, 1, 1, 37, 3),
    (4096, 1024, 2, False): (128, 1, 4, 264, 3),
    (4096, 7168, 2, True): (448, 2, 1, 132, 3),
    (4096, 8192, 4, True): (512, 2, 1, 132, 2),
    (2, 9000, 2, False): (512, 0, 1, 2, 0),
    (8, 64, 4, False): (32, 1, 1, 8, 3),
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_backward_plan(shape):
    """A warp a row up to 32 chunks (d <= 256), one or two chunks a thread
    up to 1024, as many row groups a CTA as fit in 512 threads but no more
    than a group for every 132 rows, the grid the CTAs that fit in the
    threads an SM runs (1024 for one 2-byte chunk a thread or two passes,
    512 otherwise), and never more than the rows fill; a copy ring of up to
    three rows where the rows are whole chunks and the SM's shared memory
    holds them."""
    rows, d, itemsize, add = shape
    plan = trms.bwd_plan(rows, d, SMS, itemsize, add)
    assert (plan.tpr, plan.nv, plan.groups, plan.ctas, plan.stages) == PLANS[shape]
    assert plan.groups * plan.tpr <= trms.CTA_THREADS
    assert plan.nv == 0 or -(-d // trms.CHUNK) <= plan.nv * plan.tpr
    # rows of whole chunks always stream through the ring (the kernel's one
    # path for them), and the ring of the CTAs an SM holds fits its memory
    assert (plan.stages >= 2) == (plan.nv > 0 and d % trms.CHUNK == 0)
    per_sm = -(-plan.ctas // SMS)
    ring = plan.stages * plan.groups * (3 if add else 2) * plan.nv * plan.tpr * 8 * itemsize
    assert per_sm * ring <= trms.SMEM_PER_SM


@pytest.mark.parametrize("shape", [(4096, 64, 2), (512, 100, 4), (1100, 48, 2), (37, 512, 2),
                                   (300, 2048, 2)])
def test_fixed_dw_order_covers_every_row_once_and_repeats_bit_for_bit(shape, rng):
    """The numpy emulation of the kernels' dw order against the plain sum:
    every row taken by exactly one row group, the total within f32 sum
    order of the plain version's, and two runs equal to the bit."""
    rows, d, itemsize = shape
    plan = trms.bwd_plan(rows, d, SMS, itemsize)
    terms = rng.standard_normal((rows, d)).astype(np.float32)
    dw, partial, taken = emulate_dw(terms, plan)
    seen = np.zeros(rows, int)
    for rs in taken:
        seen[list(rs)] += 1
    assert (seen == 1).all()
    assert partial.shape == (plan.ctas, d)
    want = terms.astype(np.float64).sum(0)
    np.testing.assert_allclose(dw, want, rtol=0, atol=1e-5 * rows ** 0.5 * np.abs(terms).max())
    again, _, _ = emulate_dw(terms, plan)
    assert np.array_equal(dw.view(np.uint32), again.view(np.uint32))


def test_backward_wrapper_raises_on_what_the_kernel_does_not_take(emulated):
    x, w = torch.ones(2, 64, dtype=torch.bfloat16), torch.ones(64)
    with pytest.raises(ValueError, match="dy must be"):
        trms._rmsnorm_bwd_cuda(x, torch.ones(2, 64), w, EPS, None)
    with pytest.raises(ValueError, match="ds must be"):
        trms._rmsnorm_bwd_cuda(x, x, w, EPS, torch.ones(2, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="w must be"):
        trms._rmsnorm_bwd_cuda(x, x, torch.ones(32), EPS, None)
    assert emulated.calls == []

"""Attention's gradients: ``repro_torch.kernels.attention_chunked`` (the port
of ``repro/kernels/attention_xla.py`` with its custom VJP) against
``jax.vjp`` of the reference's ``attention_chunked``; the plain version of
the flash backward kernel on the reference's saved ``(out, lse)``;
autograd through the ``attention`` block's ``torch`` target; and the CUDA
wrappers' host side, the forward's ``lse`` and the backward kernel's
arguments read back by a numpy emulation of the kernels (``build.launch``
patched), as ``test_torch_norms.py`` does for RMSNorm.

Tolerances, f32: outputs and gradients within 1e-5 absolute and relative
(the same online-softmax and VJP formulas summed in another order; values
stay below ~10 at these sizes); the emulation is an f64 dense computation,
held to 1e-5 too.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_xla as jax_att
from repro.kernels.ref import attention_ref as jattention_ref
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import attention_chunked as tac
from repro_torch.kernels import build

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, H, KH, S, Dk, Dv, q_chunk, kv_chunk): GQA groups of 1, 2 and 4, dv != d,
# chunks that split the sequence or not
SHAPES = [
    (2, 4, 2, 32, 16, 16, None, None),
    (1, 4, 1, 64, 24, 16, 16, 32),
    (2, 6, 3, 48, 16, 8, 16, 16),
    (1, 2, 2, 40, 12, 20, 8, 20),
]


def _qkv(rng, b, h, kh, s, dk, dv):
    q = rng.standard_normal((b, h, s, dk)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, dk)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, dv)).astype(np.float32)
    do = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    return q, k, v, do


def _torch_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_chunked_forward_and_grads_match_reference_vjp(shape, causal, rng):
    b, h, kh, s, dk, dv, qc, kc = shape
    q, k, v, do = _qkv(rng, b, h, kh, s, dk, dv)
    jout, vjp = jax.vjp(
        lambda *a: jax_att.attention_chunked(*a, causal=causal, q_chunk=qc, kv_chunk=kc),
        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    out, grads = _torch_grads(
        lambda *a: tac.attention_chunked(*a, causal=causal, q_chunk=qc, kv_chunk=kc), q, k, v, do)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), **TOL)


def test_chunk_rule_matches_reference():
    for s in (1, 7, 16, 100, 512, 1024, 3000, 8192, 10000):
        assert tac._chunks(s) == jax_att._chunks(s)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s[:6])))
def test_plain_flash_backward_on_the_references_residuals(shape, rng):
    """``flash_attention_bwd_torch`` (the plain version of the backward
    kernel) from the reference forward's own ``out`` and ``lse``, laid out
    as the kernel takes them ((B, H, Sq, *)), gives the reference VJP's
    gradients."""
    b, h, kh, s, dk, dv, _, _ = shape
    q, k, v, do = _qkv(rng, b, h, kh, s, dk, dv)
    qc = kc = jax_att._chunks(s)
    jout, jlse = jax_att._chunked_fwd_core(*map(jnp.asarray, (q, k, v)), True, qc, kc)
    jgrads = jax_att._core_bwd(True, qc, kc, (*map(jnp.asarray, (q, k, v)), jout, jlse),
                               jnp.asarray(do))
    out = torch.from_numpy(np.asarray(jout)).reshape(b, h, s, dv)
    lse = torch.from_numpy(np.asarray(jlse)).reshape(b, h, s)
    grads = tatt.flash_attention_bwd(*map(torch.from_numpy, (q, k, v)), out, lse,
                                     torch.from_numpy(do))  # CPU: the plain version
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s[:6])))
def test_autograd_through_the_torch_target(shape, rng):
    """The ``attention`` block's ``torch`` target (dense masked softmax)
    differentiates under autograd to the reference's gradients (of
    ``attention_ref``, whose end-aligned mask equals the start-aligned one
    at Sq == Skv)."""
    b, h, kh, s, dk, dv, _, _ = shape
    q, k, v, do = _qkv(rng, b, h, kh, s, dk, dv)
    jout, vjp = jax.vjp(lambda *a: jattention_ref(*a, causal=True), *map(jnp.asarray, (q, k, v)))
    out, grads = _torch_grads(tatt.flash_attention_torch, q, k, v, do)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    for g, jg in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g, np.asarray(jg), **TOL)


# -- the CUDA wrappers' host side, against an emulation of the kernels ---------------


def _read(ptr, shape, code):
    n = int(np.prod(shape))
    dt = torch.float32 if code == 0 else torch.bfloat16
    buf = torch.empty(n, dtype=dt)
    ctypes.memmove(buf.data_ptr(), ptr, n * buf.element_size())
    return buf.double().numpy().reshape(shape)


def _write(ptr, vals, code):
    t = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    t = t if code == 0 else t.to(torch.bfloat16)
    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def _dense(q, k, v, causal, scale):
    """Scores, probabilities and lse in f64 (GQA: kv head h // G)."""
    g = q.shape[1] // k.shape[1]
    kq, vq = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    sc = np.einsum("bhqd,bhkd->bhqk", q, kq) * scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        sc = np.where(np.arange(skv)[None, :] <= np.arange(sq)[:, None], sc, -np.inf)
    lse = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + sc.max(-1)
    p = np.exp(sc - lse[..., None])
    return p, lse, kq, vq


class FlashEmulator:
    """Stands in for ``build.launch`` of the forward (``out`` and, when its
    pointer is given, ``lse``) and of the backward (dq, dk, dv summed over
    each kv head's group; a workspace exactly on the wgmma route): reads
    every operand from the memory the arguments point at and checks the
    argument kinds ctypes converts."""

    def __init__(self):
        self.calls, self.routes = [], []

    def __call__(self, name, *args):
        argtypes = build.ENTRY_POINTS[name]
        assert len(args) == len(argtypes)
        for arg, kind in zip(args, argtypes):
            want = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: int,
                    ctypes.c_longlong: int, ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (name, arg, kind)
        self.calls.append(name)
        if name == "repro_flash_attention":
            q, k, v, out, lse, b, h, kh, sq, skv, d, dv, causal, scale, code, route, _ = args
            qa, ka, va = (_read(q, (b, h, sq, d), code), _read(k, (b, kh, skv, d), code),
                          _read(v, (b, kh, skv, dv), code))
            p, lse_v, _, vq = _dense(qa, ka, va, causal, scale)
            _write(out, np.einsum("bhqk,bhkd->bhqd", p, vq), code)
            if lse is not None:
                _write(lse, lse_v, 0)
            return
        assert name == "repro_flash_attention_bwd"
        (q, k, v, out, lse, do, dq, dk, dv_p, ws, ws_elems, b, h, kh, sq, skv, d, dv, causal,
         scale, code, route, _) = args
        assert tatt.BWD_ROUTES[route] in ("cuda_cores", "wgmma")
        self.routes.append(tatt.BWD_ROUTES[route])
        assert (ws is not None) == (ws_elems > 0) == (tatt.BWD_ROUTES[route] == "wgmma")
        qa, ka, va = (_read(q, (b, h, sq, d), code), _read(k, (b, kh, skv, d), code),
                      _read(v, (b, kh, skv, dv), code))
        oa, doa = _read(out, (b, h, sq, dv), code), _read(do, (b, h, sq, dv), code)
        lse_a = _read(lse, (b, h, sq), 0)
        _, _, kq, vq = _dense(qa, ka, va, causal, scale)
        sc = np.einsum("bhqd,bhkd->bhqk", qa, kq) * scale
        if causal:
            sc = np.where(np.arange(skv)[None, :] <= np.arange(sq)[:, None], sc, -np.inf)
        p = np.exp(sc - lse_a[..., None])
        dp = np.einsum("bhqd,bhkd->bhqk", doa, vq)
        ds = p * (dp - (doa * oa).sum(-1)[..., None]) * scale
        g = h // kh
        _write(dq, np.einsum("bhqk,bhkd->bhqd", ds, kq), code)
        _write(dk, np.einsum("bhqk,bhqd->bhkd", ds, qa).reshape(b, kh, g, skv, d).sum(2), code)
        _write(dv_p, np.einsum("bhqk,bhqd->bhkd", p, doa).reshape(b, kh, g, skv, dv).sum(2), code)


@pytest.fixture
def emulated(monkeypatch):
    from repro_torch import kernels

    emu = FlashEmulator()
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", emu)
    kernels.reset_launches()
    yield emu
    kernels.reset_launches()


@pytest.mark.parametrize("shape", [(2, 4, 2, 24, 16, 16), (1, 6, 2, 20, 24, 8)])
def test_flash_function_passes_what_the_kernels_read(emulated, shape, rng):
    """``FlashAttentionFn`` with the forward kernel emulated: its ``out``
    and ``lse`` (the rows' log-sum-exp, as the reference's forward saves
    it) feed the backward, whose gradients equal autograd's through the
    plain version; then the backward kernel's wrapper alone, emulated,
    gives the plain backward's gradients on the same residuals."""
    b, h, kh, s, dk, dv = shape
    q, k, v, do = _qkv(rng, b, h, kh, s, dk, dv)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tatt.FlashAttentionFn.apply(*ts, True)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    want_out, want = _torch_grads(tatt.flash_attention_torch, q, k, v, do)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert emulated.calls == ["repro_flash_attention"]  # on the CPU, the plain backward

    o, lse = tatt._flash_cuda(*map(torch.from_numpy, (q, k, v)), True, with_lse=True)
    _, jlse = jax_att._chunked_fwd_core(*map(jnp.asarray, (q, k, v)), True, s, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(b, h, s), **TOL)
    args = (*map(torch.from_numpy, (q, k, v)), o, lse, torch.from_numpy(do))
    got = tatt._flash_attention_bwd_cuda(*args, True)
    for g, w in zip(got, tatt.flash_attention_bwd_torch(*args)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert tatt.flash_attention_bwd.launches == 1
    assert emulated.calls[-1] == "repro_flash_attention_bwd"


def test_backward_wrapper_raises_on_what_the_kernel_does_not_take(emulated):
    q = torch.zeros(1, 4, 8, 16)
    k = v = torch.zeros(1, 2, 8, 16)
    out, lse, do = torch.zeros(1, 4, 8, 16), torch.zeros(1, 4, 8), torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        tatt._flash_attention_bwd_cuda(q, k, v, out, lse[..., :4], do, True)
    with pytest.raises(TypeError, match="lse is f32"):
        tatt._flash_attention_bwd_cuda(q, k, v, out, lse.double(), do, True)
    big = torch.zeros(1, 2, 8, 264)
    with pytest.raises(ValueError, match="exceed"):
        tatt._flash_attention_bwd_cuda(big, big, big, big, torch.zeros(1, 2, 8), big, True)
    qm = torch.zeros(1, 2, 8, 264, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="up to 256"):
        tatt.flash_attention(qm, qm, qm)


def test_backward_route_is_picked_by_the_wrapper_passed_and_counted(emulated, monkeypatch):
    """bf16 with head dims multiples of 8, q / k's up to 256 and v's up to
    128, and 16-byte aligned operands takes the wgmma route (TMA loads),
    the rest the CUDA cores;
    the wrapper passes the route's code and counts the launch under it.
    (Meta tensors stand in for CUDA ones.)"""
    def ops(d, dv, dtype=torch.bfloat16, device="cpu"):
        q, k = (torch.zeros(1, 4, 8, d, dtype=dtype, device=device) for _ in range(2))
        v, do = (torch.zeros(1, 4, 8, dv, dtype=dtype, device=device) for _ in range(2))
        return q, k, v, do

    for d, dv in ((64, 64), (16, 48), (32, 64), (24, 24), (112, 112), (128, 128), (128, 64),
                  (192, 128), (256, 128), (200, 64)):
        assert tatt.flash_bwd_route(*ops(d, dv)) == "wgmma"
    for args in (ops(20, 20), ops(136, 136), ops(64, 64, torch.float32), ops(264, 128),
                 ops(192, 136), ops(192, 128, torch.float32)):
        assert tatt.flash_bwd_route(*args) == "cuda_cores"
    q, k, v, do = ops(64, 64)
    shifted = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)[1:].view(q.shape)
    assert tatt.flash_bwd_route(shifted, k, v, do) == "cuda_cores"  # a 2-byte offset

    seen = []
    for d, dv, dtype in ((64, 64, torch.bfloat16), (64, 64, torch.float32)):
        q, k, v, do = ops(d, dv, dtype, device="meta")
        lse = torch.zeros(1, 4, 8, device="meta")
        monkeypatch.setattr(build, "launch",
                            lambda name, *args: seen.append(tatt.BWD_ROUTES[args[-2]]))
        tatt._flash_attention_bwd_cuda(q, k, v, do, lse, do, True)
    assert seen == ["wgmma", "cuda_cores"]
    assert tatt.flash_attention_bwd.routes == {"cuda_cores": 1, "wgmma": 1}

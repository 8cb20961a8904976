"""The flash backward's wgmma route (``csrc/flash_attention_bwd.cu``,
``wg`` namespace) on the CPU: an emulation in torch of its arithmetic held
against ``jax.vjp`` of the reference's ``attention_chunked``, the delta
pass's plain version against the reference's ``dsum``, and the wrapper's
workspace.

The emulation follows the three kernels: the delta pass's rows (lse in
log2 units, ``+inf`` past Sq; delta from the bf16 ``out`` and ``do``), then
the dK / dV kernel's 64-key tiles walking the group's heads and the query
blocks on and below the diagonal, and the dQ kernel's 64-query tiles
walking the key blocks up to the diagonal, in that order (above qk 128
the dK / dV tile's products are shared by two warpgroups and a dQ CTA
may hold two query tiles: each sum keeps this order), with tiles past
S zero-filled as TMA loads them.  Scores and dP accumulate in f32; P^T and
dS^T (dS in the dQ kernel) are rounded to bf16 as the A operands of the
accumulating products, which accumulate in f32; dK and dQ take the scale
once at the end, and every output is rounded to bf16.

Tolerance: ``chip_smoke.TOL["bfloat16"]`` (2e-2 absolute and relative),
what phase 2 holds the kernel to against its plain version: the bf16
inputs are exact in f32, so the gap to the f32 reference is the bf16
roundings of ``out``, P, dS and the outputs (each ~2^-9 relative).
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_xla as jax_att
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import build

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TILE = tatt.BWD_TILE
RTOL, ATOL = chip_smoke.TOL["bfloat16"]  # what phase 2 holds the kernel to


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (..., S, D) zero-filled to n rows, as TMA fills a box past S."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def emulate_wgmma_bwd(q, k, v, out, lse, do, causal=True):
    """(dq, dk, dv) in bf16 by the wgmma route's arithmetic, tile by tile in
    the kernels' order (see the module docstring)."""
    b, h, sq, d = q.shape
    kh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    c = scale * 1.4426950408889634
    ws = tatt.bwd_workspace_torch(out, lse, do)  # the delta pass
    qpad, kpad = ws.shape[-1], -(-skv // TILE) * TILE
    lse2 = ws[:, 0].reshape(b, h, qpad)
    delta = ws[:, 1].reshape(b, h, qpad)
    qf, dof = _pad_rows(q.float(), qpad), _pad_rows(do.float(), qpad)
    kf, vf = _pad_rows(k.float(), kpad), _pad_rows(v.float(), kpad)
    ar = torch.arange(TILE)

    def probs(s, l2, keys, queries):  # s and l2 broadcast (keys x queries or back)
        p = torch.exp2(s * c - l2)
        mask = keys >= skv
        if causal:
            mask = mask | (keys > queries)
        return torch.where(mask, torch.zeros_like(p), p)

    dk_all = torch.zeros(b, kh, kpad, d)
    dv_all = torch.zeros(b, kh, kpad, dv)
    for bi in range(b):
        for j in range(kh):
            for kb in range(kpad // TILE):
                k0 = kb * TILE
                kt, vt = kf[bi, j, k0:k0 + TILE], vf[bi, j, k0:k0 + TILE]
                acc_k, acc_v = torch.zeros(TILE, d), torch.zeros(TILE, dv)
                for hq in range(g):
                    hh = j * g + hq
                    for qb in range(kb if causal else 0, qpad // TILE):
                        q0 = qb * TILE
                        qt, dot = qf[bi, hh, q0:q0 + TILE], dof[bi, hh, q0:q0 + TILE]
                        st = kt @ qt.T  # S^T: keys x queries
                        p = probs(st, lse2[bi, hh, q0:q0 + TILE][None, :],
                                  (k0 + ar)[:, None], (q0 + ar)[None, :])
                        ds = p * (vt @ dot.T - delta[bi, hh, q0:q0 + TILE][None, :])
                        acc_v = acc_v + _bf(p) @ dot
                        acc_k = acc_k + _bf(ds) @ qt
                dk_all[bi, j, k0:k0 + TILE] = acc_k * scale
                dv_all[bi, j, k0:k0 + TILE] = acc_v

    dq_all = torch.zeros(b, h, qpad, d)
    for bi in range(b):
        for hh in range(h):
            j = hh // g
            for qb in range(qpad // TILE):
                q0 = qb * TILE
                qt, dot = qf[bi, hh, q0:q0 + TILE], dof[bi, hh, q0:q0 + TILE]
                n_kv = min(kpad // TILE, qb + 1) if causal else kpad // TILE
                acc = torch.zeros(TILE, d)
                for kb in range(n_kv):
                    k0 = kb * TILE
                    kt, vt = kf[bi, j, k0:k0 + TILE], vf[bi, j, k0:k0 + TILE]
                    p = probs(qt @ kt.T, lse2[bi, hh, q0:q0 + TILE][:, None],
                              (k0 + ar)[None, :], (q0 + ar)[:, None])
                    ds = p * (dot @ vt.T - delta[bi, hh, q0:q0 + TILE][:, None])
                    acc = acc + _bf(ds) @ kt
                dq_all[bi, hh, q0:q0 + TILE] = acc * scale
    bf16 = torch.bfloat16
    return (dq_all[:, :, :sq].to(bf16), dk_all[:, :, :skv].to(bf16),
            dv_all[:, :, :skv].to(bf16))


def _inputs(seed, b, h, kh, s, d, dv):
    """bf16 q, k, v, do (as f32 numpy, exact) from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, dv), (b, h, s, dv))]
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]


def _reference(q, k, v, do):
    """The reference's forward residuals (out (B, H, S, Dv) rounded to bf16,
    as the forward kernel writes it, and lse (B, H, S)) and its VJP."""
    b, h, s, _ = q.shape
    s_chunk = jax_att._chunks(s)
    jout, jlse = jax_att._chunked_fwd_core(*map(jnp.asarray, (q, k, v)), True, s_chunk, s_chunk)
    _, vjp = jax.vjp(lambda *a: jax_att.attention_chunked(*a, causal=True),
                     *map(jnp.asarray, (q, k, v)))
    grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    out = torch.from_numpy(np.asarray(jout)).reshape(b, h, s, -1).to(torch.bfloat16)
    lse = torch.from_numpy(np.asarray(jlse)).reshape(b, h, s)
    return out, lse, grads


# (S, D, Dv): llama's 64, zamba2's 112 (two boxes, zero-filled past 112),
# arctic's 128, each at a ragged S 300 and at 512; D != Dv below one box;
# deepseek-v2's qk 192 / v 128 and qk 256 / v 128 (dK / dV on two consumer
# warpgroups, three and four boxes of q and k)
SHAPES = [(s, d, d) for d in (64, 112, 128) for s in (300, 512)] + [
    (300, 48, 32), (300, 192, 128), (512, 192, 128), (300, 256, 128)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "S%d-D%d-Dv%d" % t)
def test_wgmma_route_arithmetic_matches_reference_vjp(shape):
    """The emulated wgmma route (B 1, H 4 over KH 2: a group of two heads)
    against ``jax.vjp`` of the reference's chunked attention."""
    s, d, dv = shape
    q, k, v, do = _inputs(s + d, 1, 4, 2, s, d, dv)
    out, lse, want = _reference(q, k, v, do)
    bf16 = torch.bfloat16
    got = emulate_wgmma_bwd(*(torch.from_numpy(a).to(bf16) for a in (q, k, v)), out, lse,
                            torch.from_numpy(do).to(bf16))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_wgmma_emulation_fails_without_the_causal_mask():
    """A control: the same emulation with keys above the diagonal left in
    misses the reference by far more than the tolerance."""
    q, k, v, do = _inputs(1, 1, 4, 2, 128, 64, 64)
    out, lse, want = _reference(q, k, v, do)
    bf16 = torch.bfloat16
    got = emulate_wgmma_bwd(*(torch.from_numpy(a).to(bf16) for a in (q, k, v)), out, lse,
                            torch.from_numpy(do).to(bf16), causal=False)
    err = max(float(np.abs(g.float().numpy() - w).max()) for g, w in zip(got, want))
    assert err > 10 * ATOL


def test_delta_plain_version_is_the_references_dsum():
    """``bwd_delta_torch`` (rowsum(do * out) in f32) on the reference
    forward's own residual equals ``_core_bwd``'s ``dsum`` expression on
    its grouped (B, KH, G, Sq, Dv) f32 ``out``."""
    b, h, kh, s, d, dv = 2, 6, 3, 40, 16, 24
    q, k, v, do = _inputs(3, b, h, kh, s, d, dv)
    jout, _ = jax_att._chunked_fwd_core(*map(jnp.asarray, (q, k, v)), True, s, s)
    dog = jnp.asarray(do).reshape(b, kh, h // kh, s, dv).astype(jnp.float32)
    dsum = np.asarray(jnp.sum(dog * jout, axis=-1)).reshape(b, h, s)  # attention_xla.py:130
    out = torch.from_numpy(np.asarray(jout)).reshape(b, h, s, dv)
    got = tatt.bwd_delta_torch(out, torch.from_numpy(do))
    np.testing.assert_allclose(got.numpy(), dsum, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [64, 70, 300])
def test_workspace_rows_pad_to_whole_tiles(s):
    """The workspace the delta pass writes: (B H, 2, Sq padded to 64), the
    lse in log2 units then delta; past Sq, +inf (a probability of exactly
    0) and 0."""
    rng = np.random.default_rng(s)
    out, do = (torch.from_numpy(rng.standard_normal((2, 3, s, 8)).astype(np.float32))
               for _ in range(2))
    lse = torch.from_numpy(rng.standard_normal((2, 3, s)).astype(np.float32))
    ws = tatt.bwd_workspace_torch(out, lse, do)
    pad = -(-s // 64) * 64
    assert ws.shape == tatt.bwd_workspace_shape(2, 3, s) == (6, 2, pad)
    np.testing.assert_allclose(ws[:, 0, :s].numpy(), (lse * math.log2(math.e)).reshape(6, s),
                               rtol=1e-6)
    np.testing.assert_allclose(ws[:, 1, :s].numpy(), (out * do).sum(-1).reshape(6, s),
                               rtol=1e-5, atol=1e-6)
    assert torch.all(ws[:, 0, s:] == float("inf")) and torch.all(ws[:, 1, s:] == 0)
    assert torch.all(torch.exp2(torch.tensor(3.0) - ws[:, 0, s:]) == 0)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "cuda_cores")])
def test_wrapper_allocates_the_workspace_for_the_wgmma_route(monkeypatch, dtype, route):
    """The wrapper passes a workspace of ``bwd_workspace_shape``'s floats on
    the wgmma route and none (null, 0) on the CUDA cores.  (Meta tensors
    stand in for CUDA ones.)"""
    from repro_torch import kernels

    b, h, kh, s, d = 2, 4, 2, 70, 64
    q, out, do = (torch.zeros(b, h, s, d, dtype=dtype, device="meta") for _ in range(3))
    k, v = (torch.zeros(b, kh, s, d, dtype=dtype, device="meta") for _ in range(2))
    lse = torch.zeros(b, h, s, device="meta")
    seen = []
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", lambda name, *args: seen.append(args))
    kernels.reset_launches()
    tatt._flash_attention_bwd_cuda(q, k, v, out, lse, do, True)
    (args,) = seen
    assert len(args) == len(build.ENTRY_POINTS["repro_flash_attention_bwd"])
    ws, ws_elems = args[9], args[10]
    assert tatt.BWD_ROUTES[args[-2]] == route
    if route == "wgmma":
        assert isinstance(ws, int) and ws_elems == b * h * 2 * 128
    else:
        assert ws is None and ws_elems == 0
    assert tatt.flash_attention_bwd.routes[route] == 1
    kernels.reset_launches()


def test_emulator_runs_the_wgmma_route_through_the_wrapper(monkeypatch):
    """bf16 CPU tensors through the CUDA wrapper with ``build.launch``
    replaced by the emulation, reading and writing the memory the
    arguments point at: the workspace the wrapper allocated gets the delta
    pass's rows, and the gradients are the emulation's."""
    import ctypes

    from repro_torch import kernels

    b, h, kh, s, d = 1, 4, 2, 100, 64
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(5, b, h, kh, s, d, d))
    out, lse, _ = _reference(*(t.float().numpy() for t in (q, k, v, do)))
    seen = {}

    def view(ptr, like):
        t = torch.empty_like(like)
        ctypes.memmove(t.data_ptr(), ptr, t.numel() * t.element_size())
        return t

    def put(ptr, t):
        ctypes.memmove(ptr, t.contiguous().data_ptr(), t.numel() * t.element_size())

    def launch(name, *args):
        qp, kp, vp, op, lp, dop, dqp, dkp, dvp, wsp, ws_elems = args[:11]
        tq, tk, tv, to, tl, tdo = (view(p_, t) for p_, t in zip((qp, kp, vp, op, lp, dop),
                                                                (q, k, v, out, lse, do)))
        rows = tatt.bwd_workspace_torch(to, tl, tdo)
        assert ws_elems == rows.numel()
        put(wsp, rows)
        seen["rows"] = rows
        for ptr, t in zip((dqp, dkp, dvp), emulate_wgmma_bwd(tq, tk, tv, to, tl, tdo)):
            put(ptr, t)

    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "launch", launch)
    kernels.reset_launches()
    got = tatt._flash_attention_bwd_cuda(q, k, v, out, lse, do, True)
    want = emulate_wgmma_bwd(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert seen["rows"].shape == tatt.bwd_workspace_shape(b, h, s)
    assert tatt.flash_attention_bwd.routes == {"cuda_cores": 0, "wgmma": 1}
    kernels.reset_launches()

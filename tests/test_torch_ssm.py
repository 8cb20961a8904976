"""The port's SSM and hybrid model path against ``repro.models``:
mamba2-2.7b and zamba2-7b reduced (zamba2's reduced pattern is ``"mmms"``,
one shared-attention site).

The reference's weights (``repro.models.lm.init_params``) are carried across
with ``repro_torch.bridge``; caches are made with numpy and fed to both
sides.  Both sides compute in float32 (``compute_dtype="float32"``), so
logits and caches agree within ``F32_TOL`` (1e-4): the same f32 formulas
(the port's depthwise ``F.conv1d`` against XLA's grouped conv, torch
einsums against XLA's), summed in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ARCHS = ("mamba2-2.7b", "zamba2-7b")
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", remat="none")
    tcfg = dataclasses.replace(tget(arch).reduced(), compute_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """arch -> (reference params, the port's params from the same numbers)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jparams = jlm.init_params(jcfg, seed=0)
        out[arch] = (jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return out


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_cache_close(tcache, jcache):
    got = bridge.cache_to_numpy(tcache)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    assert set(got) == set(want)
    for key in want:
        if key == "index":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            for leaf in want[key]:
                np.testing.assert_allclose(got[key][leaf], want[key][leaf], **F32_TOL)


def _random_tree(rng, tree):
    return jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def test_configs_match_the_reference():
    for arch in ARCHS:
        jcfg, tcfg = jget(arch), tget(arch)
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                      "vocab_size", "padded_vocab", "rope_theta", "tie_embeddings"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (arch, field)
        assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(jcfg.ssm)
        assert tcfg.pattern() == jcfg.pattern()
        assert tcfg.reduced().pattern() == jcfg.reduced().pattern()
    assert tget("zamba2-7b").reduced().pattern() == "mmms"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [11, 2], ids=["s11", "s2"])
def test_ssm_forward_prefill_then_decode_match_reference(arch, seq, weights, rng):
    """One Mamba-2 block: prefill from a random carried state (seq 2 is
    shorter than the conv window), then one decode step."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = weights[arch]
    key = next(k for k in jparams["blocks"] if k.endswith("_m"))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][key]["mixer"])
    tp = {k: v[0] for k, v in tparams["blocks"][key]["mixer"].items()}
    state = {
        "conv": (0.5 * rng.standard_normal((2, 3, jcfg.ssm.conv_dim(64)))).astype(np.float32),
        "ssm": (0.5 * rng.standard_normal(
            (2, jcfg.ssm.n_heads(64), jcfg.ssm.d_state, jcfg.ssm.head_dim))).astype(np.float32),
    }
    x = rng.standard_normal((2, seq, 64)).astype(np.float32)
    jout, jstate = jssm.ssm_forward(jp, jnp.asarray(x), jcfg, jax.tree.map(jnp.asarray, state), "prefill")
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tout, tstate = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg, tstate, "prefill")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(tstate["ssm"].numpy(), np.asarray(jstate["ssm"]), **F32_TOL)
    if seq >= 3:  # the reference keeps a short prompt's window short
        np.testing.assert_allclose(tstate["conv"].numpy(), np.asarray(jstate["conv"]), **F32_TOL)

    step = rng.standard_normal((2, 1, 64)).astype(np.float32)
    if seq < 3:  # continue the reference from the port's full window
        # copies: the port's decode below writes its state in place, and
        # JAX on the CPU may alias a numpy buffer while its call runs
        jstate = jax.tree.map(lambda t: jnp.asarray(t.numpy().copy()), tstate)
    jout, jstate = jssm.ssm_forward(jp, jnp.asarray(step), jcfg, jstate, "decode")
    tout, tstate = tssm.ssm_forward(tp, torch.from_numpy(step), tcfg, tstate, "decode")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    for leaf in ("conv", "ssm"):
        np.testing.assert_allclose(tstate[leaf].numpy(), np.asarray(jstate[leaf]), **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_then_contiguous_decode_match_reference(arch, weights, rng):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = weights[arch]
    tokens = _tokens(rng, jcfg, 2, 12)
    jcache = jlm.init_cache(jcfg, 2, 32)
    jlogits, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jcache)
    tcache = tlm.init_cache(tcfg, 2, 32)
    tlogits, tcache = tlm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    _assert_cache_close(tcache, jcache)

    for _ in range(2):  # two decode steps carry the SSM state forward
        step = _tokens(rng, jcfg, 2, 1)
        jlogits, jcache = jlm.decode_step(jparams, jnp.asarray(step), jcfg, jcache)
        tlogits, tcache = tlm.decode_step(tparams, torch.from_numpy(step), tcfg, tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
        _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_paged_decode_matches_reference(arch, weights, rng):
    """A random-filled paged cache (shuffled pages, null-page entries past
    each slot's allocation; SSM states per slot) through one decode step."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = weights[arch]
    b, ps, n_pages, mp, lengths = 3, 4, 12, 4, (9, 0, 15)
    filled = _random_tree(rng, jlm.init_cache(jcfg, b, mp * ps, page_size=ps, n_pages=n_pages))
    filled["index"] = np.asarray(lengths, np.int32)
    pages = np.full((b, mp), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    for i, ln in enumerate(lengths):
        used = -(-(ln + 1) // ps)
        pages[i, :used] = perm[i * mp : i * mp + used]
    tcache = bridge.cache_from_numpy(filled, tcfg, b, mp * ps, page_size=ps, n_pages=n_pages)
    for key, kind in ((g.key, g.kind) for g in tlm.groups_of(tcfg)):
        if kind == "m":  # per-slot state, never paged
            assert tcache[key]["ssm"].shape[1] == b
    tokens = _tokens(rng, jcfg, b, 1)
    jlogits, _, jnew = jlm.forward(
        jparams, {"tokens": jnp.asarray(tokens)}, jcfg, "decode",
        dict(jax.tree.map(jnp.asarray, filled), pages=jnp.asarray(pages)),
    )
    tlogits, tnew = tlm.forward(
        tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, "decode",
        dict(tcache, pages=torch.from_numpy(pages)),
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    tnew.pop("pages")
    jnew.pop("pages", None)
    _assert_cache_close(tnew, jnew)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_mode_raises_for_ssm_blocks(arch, weights, rng):
    _, tcfg = _cfgs(arch)
    _, tparams = weights[arch]
    cache = tlm.init_cache(tcfg, 1, 16)
    with pytest.raises(ValueError, match="extend mode"):
        tlm.forward(tparams, {"tokens": torch.zeros((1, 3), dtype=torch.int32)}, tcfg,
                    "extend", cache)


def test_bridge_round_trips_the_shared_block(weights):
    jparams, tparams = weights["zamba2-7b"]
    tree = jax.tree.map(np.asarray, jparams)
    assert set(tparams) == {"embed", "blocks", "shared_block", "final_norm"}
    assert tparams["shared_block"]["attn"]["wq"].shape == (64, 4 * 16)  # unstacked
    assert sorted(tparams["blocks"]) == ["g0_m"]
    jax.tree.map(np.testing.assert_array_equal, bridge.params_to_numpy(tparams), tree)
    cast = tlm.cast_for_compute(tparams, tget("zamba2-7b").reduced())
    assert cast["shared_block"]["mlp"]["gate"].dtype == torch.bfloat16
    assert cast["shared_block"]["ln1"].dtype == torch.float32
    mixer = cast["blocks"]["g0_m"]["mixer"]
    assert mixer["in_proj"].dtype == torch.bfloat16
    for vec in ("a_log", "d_skip", "dt_bias", "norm", "conv_b"):
        assert mixer[vec].dtype == torch.float32
    del tree["shared_block"]
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy(tree, tget("zamba2-7b").reduced())


def test_seeded_ssm_inits_fall_in_their_ranges():
    cfg = dataclasses.replace(tget("mamba2-2.7b").reduced(), n_layers=4)
    p = tlm.init_params(cfg, seed=5)["blocks"]["g0_m"]["mixer"]
    a_log = p["a_log"]
    assert ((a_log >= 0) & (a_log < np.log(16.0) + 1e-6)).all()  # log U[1, 16)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert ((dt >= 1e-3 * (1 - 1e-4)) & (dt <= 1e-1 * (1 + 1e-4))).all()
    assert a_log.std() > 0.1 and dt.std() > 1e-3  # drawn, not constant
    again = tlm.init_params(cfg, seed=5)["blocks"]["g0_m"]["mixer"]
    assert torch.equal(again["a_log"], a_log) and torch.equal(again["dt_bias"], p["dt_bias"])
    assert (p["d_skip"] == 1).all() and (p["conv_b"] == 0).all()


def test_prefill_hands_the_scan_dense_rows(monkeypatch, weights, rng):
    """The chunk kernel reads x (B, S, H, P) and B/C (B, S, N) with any
    batch and sequence strides but dense rows; the conv output must not
    leave them channel-strided."""
    from repro_torch.core import blocks
    from repro_torch.kernels import ops

    seen = []

    def recording_scan(x, dt, a, bmat, cmat, **kw):
        seen.append((x.stride()[-2:], bmat.stride(-1), cmat.stride(-1), x.shape[-1]))
        return ops.ssd_scan(x, dt, a, bmat, cmat, backend="torch", **kw)

    monkeypatch.setitem(
        blocks.registry._impls["ssd_scan"], "torch",
        blocks.Impl("ssd_scan", "torch", recording_scan),
    )
    _, tcfg = _cfgs("mamba2-2.7b")
    _, tparams = weights["mamba2-2.7b"]
    tlm.prefill(tparams, {"tokens": torch.from_numpy(_tokens(rng, tcfg, 2, 9))}, tcfg,
                tlm.init_cache(tcfg, 2, 16))
    assert len(seen) == tcfg.n_layers
    for (x_rows, b_inner, c_inner, p) in seen:
        assert x_rows == (p, 1) and b_inner == 1 and c_inner == 1

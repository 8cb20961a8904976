"""The port's dense LM against ``repro.models.lm`` on llama3.2-1b reduced.

The reference's weights (``repro.models.lm.init_params``) are carried across
with ``repro_torch.bridge``; caches are made with numpy and fed to both
sides.  With ``compute_dtype="float32"`` logits and caches agree within
1e-4 in prefill, decode (contiguous and paged) and paged extend: the same
f32 formulas, summed in another order by another matmul library.  In the
default bf16 the two frameworks round intermediates at other places; the
logits there are held to 5e-2 (they differ by ~5e-3 on logits of ~1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm

JCFG = jget("llama3.2-1b").reduced()
TCFG = tget("llama3.2-1b").reduced()
J32 = dataclasses.replace(JCFG, compute_dtype="float32", remat="none")
T32 = dataclasses.replace(TCFG, compute_dtype="float32")
F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(JCFG, seed=0)


def _assert_cache_close(tcache, jcache, **tol):
    got = bridge.cache_to_numpy(tcache)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    for key in want:
        if key == "index":
            np.testing.assert_array_equal(got[key], want[key])
        else:
            for leaf in want[key]:
                np.testing.assert_allclose(got[key][leaf], want[key][leaf], **tol)


def _tokens(rng, b, s):
    return rng.integers(0, JCFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("jcfg,tcfg,tol", [
    (J32, T32, F32_TOL),
    (JCFG, TCFG, dict(rtol=0, atol=5e-2)),
], ids=["f32", "bf16"])
def test_prefill_then_contiguous_decode_match_reference(jcfg, tcfg, tol, jparams, rng):
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    tokens = _tokens(rng, 2, 12)
    jcache = jlm.init_cache(jcfg, 2, 32)
    jlogits, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jcache)
    tcache = tlm.init_cache(tcfg, 2, 32)
    tlogits, tcache = tlm.prefill(params, {"tokens": torch.from_numpy(tokens)}, tcfg, tcache)
    np.testing.assert_allclose(tlogits.float().numpy(), np.asarray(jlogits, np.float32), **tol)
    _assert_cache_close(tcache, jcache, **tol)

    # decode at per-slot positions: row 1 rewinds to position 7
    index = np.asarray([12, 7], np.int32)
    jcache = dict(jcache, index=jnp.asarray(index))
    tcache["index"] = torch.from_numpy(index)
    step = _tokens(rng, 2, 1)
    jlogits, jcache = jlm.decode_step(jparams, jnp.asarray(step), jcfg, jcache)
    tlogits, tcache = tlm.decode_step(params, torch.from_numpy(step), tcfg, tcache)
    np.testing.assert_allclose(tlogits.float().numpy(), np.asarray(jlogits, np.float32), **tol)
    _assert_cache_close(tcache, jcache, **tol)


def _paged_caches(rng, cfg_j, cfg_t, b, ps, n_pages, mp, lengths, s):
    """A random-filled paged cache and its page table (slots' pages
    shuffled; entries past a slot's allocation at the null page)."""
    jcache = jlm.init_cache(cfg_j, b, mp * ps, page_size=ps, n_pages=n_pages)
    filled = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jcache
    )
    filled["index"] = np.asarray(lengths, np.int32)
    pages = np.full((b, mp), n_pages, np.int32)
    perm = rng.permutation(n_pages)
    for i, ln in enumerate(lengths):
        used = -(-(ln + s) // ps)
        pages[i, :used] = perm[i * mp : i * mp + used]
    jcache = jax.tree.map(jnp.asarray, filled)
    tcache = bridge.cache_from_numpy(
        filled, cfg_t, b, mp * ps, page_size=ps, n_pages=n_pages
    )
    return jcache, tcache, pages


@pytest.mark.parametrize("s,lengths", [(1, (9, 0, 15)), (3, (5, 12, 0))], ids=["decode", "extend"])
def test_paged_decode_and_extend_match_reference(s, lengths, jparams, rng):
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), T32)
    jcache, tcache, pages = _paged_caches(rng, J32, T32, 3, 4, 12, 4, lengths, s)
    tokens = _tokens(rng, 3, s)
    mode = "decode" if s == 1 else "extend"
    jlogits, _, jnew = jlm.forward(
        jparams, {"tokens": jnp.asarray(tokens)}, J32, mode, dict(jcache, pages=jnp.asarray(pages))
    )
    tlogits, tnew = tlm.forward(
        params, {"tokens": torch.from_numpy(tokens)}, T32, mode,
        dict(tcache, pages=torch.from_numpy(pages)),
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    tnew.pop("pages")
    jnew.pop("pages", None)
    _assert_cache_close(tnew, jnew, **F32_TOL)


def test_bridge_round_trip_and_checks(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    params = bridge.params_from_numpy(tree, TCFG)
    assert params["blocks"]["g0_a"]["attn"]["wq"].shape == (4, 64, 64)
    back = bridge.params_to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    # a bf16 cache keeps its bits; the inverse returns them as f32
    jcache = jax.tree.map(
        lambda a: jnp.asarray(np.random.default_rng(0).standard_normal(a.shape), a.dtype),
        jlm.init_cache(JCFG, 2, 8),
    )
    tcache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jcache), TCFG, 2, 8)
    assert tcache["g0_a"]["k"].dtype == torch.bfloat16
    jax.tree.map(
        np.testing.assert_array_equal,
        bridge.cache_to_numpy(tcache),
        jax.tree.map(lambda a: np.asarray(a, np.float32), jcache),
    )
    tree["blocks"]["g0_a"]["attn"]["wq"] = tree["blocks"]["g0_a"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(tree, TCFG)
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy({"embed": {}}, TCFG)


def test_unported_architectures_raise():
    """Every architecture of the reference resolves in the port (none is
    left unported); an unknown name still raises."""
    from repro.configs import ARCH_NAMES as JNAMES
    from repro_torch.configs import ARCH_NAMES

    assert ARCH_NAMES == JNAMES
    for name in JNAMES:
        assert tget(name).name == name
        assert tlm.build_metas(tget(name).reduced())
    with pytest.raises(KeyError, match="unknown arch"):
        tget("gpt-2")
    assert tget("llama3_2_1b") == tget("llama3.2-1b")


def test_seeded_init_is_reproducible_and_casts_matrices_only():
    a = tlm.init_params(TCFG, seed=3)
    b = tlm.init_params(TCFG, seed=3)
    assert torch.equal(a["embed"]["embedding"], b["embed"]["embedding"])
    assert not torch.equal(a["embed"]["embedding"], tlm.init_params(TCFG, seed=4)["embed"]["embedding"])
    cast = tlm.cast_for_compute(a, TCFG)
    assert cast["embed"]["embedding"].dtype == torch.bfloat16
    assert cast["blocks"]["g0_a"]["mlp"]["gate"].dtype == torch.bfloat16
    assert cast["blocks"]["g0_a"]["ln1"].dtype == torch.float32
    assert cast["final_norm"].dtype == torch.float32

"""The zoo's dense configs at their real head geometry, against the
reference, on the CPU; and ``chip_smoke.py``'s depth cuts of them.

``tests/test_torch_zoo.py`` holds the zoo on ``reduced()`` configs, whose 4
heads of 16 dims hide the heads the card serves: MHA at D 64 (stablelm-1.6b,
musicgen-large: G = 1), G = 4 at D 128 (granite-3-8b, pixtral-12b) and 64
query heads over 8 at D 128 (command-r-35b: G = 8, tied embeddings).  Here
each config keeps its ``n_heads``, ``n_kv_heads``, ``d_head``,
``rope_theta``, ``tie_embeddings`` and ``frontend`` at one layer, with a
narrow d_model / d_ff and a vocab of 512, in float32, the same
``dataclasses.replace`` on both sides and the reference's weights carried
across.  The four served configs give a greedy trace on the paged cache
token-identical to ``repro.serve.ServeEngine``'s; pixtral (the engine
refuses a patch-embed frontend) its forward on patch embeddings within the
1e-4 of ``test_torch_zoo.py::test_forward_matches_reference``, as every
config's.  Then the cuts phase 27 and phase 29 serve and train on the
card: every width of ``get_config(arch)`` kept, each served cut within the
capacity plan of an ``h100-80g``, pixtral's attention backward on the
wgmma route at its train shape.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.analysis.resources import plan_serve_capacity
from repro_torch.configs import get_config
from repro_torch.kernels import attention as tatt
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SERVED = ("stablelm-1.6b", "granite-3-8b", "command-r-35b", "musicgen-large")
ARCHS = (*SERVED, "pixtral-12b")
#: what the narrow configs keep of each published one
HEADS = ("n_heads", "n_kv_heads", "d_head", "rope_theta", "tie_embeddings", "frontend")
#: every width of a config (a depth cut keeps them all)
WIDTHS = ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size", "rope_theta",
          "norm_eps", "tie_embeddings", "frontend", "param_dtype", "compute_dtype",
          "opt_dtype", "remat")
NARROW = dict(n_layers=1, d_model=64, d_ff=128, vocab_size=512, compute_dtype="float32")


def _narrow(arch):
    """(reference config, port config, reference params, port params)."""
    jcfg = dataclasses.replace(jget(arch), remat="none", **NARROW)
    tcfg = dataclasses.replace(get_config(arch), **NARROW)
    jparams = jlm.init_params(jcfg, seed=0)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_narrow_config_keeps_the_real_heads(arch):
    jcfg, tcfg, _, _ = _narrow(arch)
    full = get_config(arch)
    assert {k: getattr(tcfg, k) for k in HEADS} == {k: getattr(full, k) for k in HEADS}
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) | {"remat": full.remat}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_at_real_heads(arch, rng):
    jcfg, tcfg, jparams, tparams = _narrow(arch)
    if tcfg.frontend == "patch_embed":
        embeds = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
        jbatch, tbatch = {"embeds": jnp.asarray(embeds)}, {"embeds": torch.from_numpy(embeds)}
    else:
        tokens = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
        jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    jlogits, _, _ = jlm.forward(jparams, jbatch, jcfg, mode="train")
    tlogits, _ = lm.forward(tparams, tbatch, tcfg, mode="train")
    assert tlogits.shape == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=2000)
    return [engine.completions[i].tokens for i in ids], engine


@pytest.mark.parametrize("arch", SERVED)
def test_paged_trace_token_identical_at_real_heads(arch, rng):
    """Three requests over two slots (a slot reused) on 8-token pages."""
    jcfg, tcfg, jparams, tparams = _narrow(arch)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in (13, 5, 20)]
    gens, kw = (6, 9, 4), dict(n_slots=2, max_len=48, page_size=8, seed=0)
    want, jeng = _trace(JServeEngine(jcfg, params=jparams, **kw), JRequest, prompts, gens)
    got, teng = _trace(ServeEngine(tcfg, params=tparams, device="cpu", **kw), Request,
                       prompts, gens)
    assert got == want
    assert teng.stats.slot_reuses == jeng.stats.slot_reuses >= 1
    teng.kv.pool.check_leaks()


def test_engine_refuses_pixtral_at_full_width():
    with pytest.raises(ValueError, match="patch-embed"):
        ServeEngine(get_config("pixtral-12b"), device="cpu")


def test_zoo_cuts_are_the_served_archs():
    assert tuple(chip_smoke.ZOO_LAYERS) == SERVED
    for arch in SERVED:
        assert chip_smoke.NORM_FORMS[arch] == ("plain", "add")
        assert chip_smoke.FLASH_ROUTE[arch] == "wgmma" and chip_smoke.PAGED_ROUTE[arch] == "split"
        assert arch in chip_smoke.PATH_CHECKED


@pytest.mark.parametrize("arch", SERVED)
def test_served_cut_keeps_every_width_and_fits_the_card(arch):
    full, cut = get_config(arch), chip_smoke._serve_config(arch)
    assert {k: getattr(cut, k) for k in WIDTHS} == {k: getattr(full, k) for k in WIDTHS}
    assert cut.n_layers == chip_smoke.ZOO_LAYERS[arch] <= full.n_layers
    assert cut.pattern() == full.pattern()[:cut.n_layers]
    # only command-r-35b is cut: its f32 init beside the bf16 cast (~6 B a
    # parameter) passes 80 GB a few layers deeper
    assert (cut.n_layers < full.n_layers) == (arch == "command-r-35b")
    if arch == "command-r-35b":
        assert 6 * cut.param_count() < 75e9 < 6 * full.cut(cut.n_layers + 1).param_count()
    plan = plan_serve_capacity(cut, n_slots=8, max_len=1024, page_size=16,
                               envelope="h100-80g", device="cpu")
    assert plan.fits, plan.summary()


def test_train_vlm_is_pixtral_at_full_width_on_the_wgmma_backward():
    spec = chip_smoke.TRAIN_VLM
    cfg, full = chip_smoke.train_cut_config(spec), get_config("pixtral-12b")
    assert {k: getattr(cfg, k) for k in WIDTHS} == {k: getattr(full, k) for k in WIDTHS}
    assert cfg.n_layers == spec["layers"] < full.n_layers and cfg.frontend == "patch_embed"
    assert cfg.param_dtype == cfg.opt_dtype == "float32" and cfg.compute_dtype == "bfloat16"
    b, s = spec["batch"], spec["seq"]
    q = torch.zeros(b, cfg.n_heads, s, cfg.d_head, dtype=torch.bfloat16)
    k = torch.zeros(b, cfg.n_kv_heads, s, cfg.d_head, dtype=torch.bfloat16)
    assert tatt.flash_route(q, k, k) == "wgmma" and tatt.flash_bwd_route(q, k, k) == "wgmma"


@pytest.mark.parametrize("block", ["attention", "paged_attention"])
def test_path_floor_rounds_only_p(block):
    """The bf16 path check's rounding floor (``_p_in_bf16``): the plain
    attention with P rounded to nearest bf16 before P V, at granite's
    heads (32 over 8, D 128), on the CPU.  Computed by hand the same way it
    is bit-identical, within P's rounding of the plain output, not equal
    to it, and ``torch.softmax`` is restored after the call."""
    from repro_torch.kernels import paged_attention as tpaged

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn(1, 32, 1 if block == "paged_attention" else 40, 128, generator=g).to(bf)
    if block == "attention":
        k, v = (torch.randn(1, 8, 40, 128, generator=g).to(bf) for _ in range(2))
        fn, args = tatt.flash_attention_torch, (q, k, v)
    else:
        k, v = (torch.randn(5, 8, 16, 128, generator=g).to(bf) for _ in range(2))
        pages = torch.tensor([[3, 1, 4]], dtype=torch.int32)
        fn, args = tpaged.paged_attention_torch, (q, k, v, pages, torch.tensor([37]))
    softmax = torch.softmax
    got = chip_smoke._p_in_bf16(torch, fn)(*args)
    assert torch.softmax is softmax
    plain = fn(*args)
    torch.softmax = lambda *a, **kw: softmax(*a, **kw).to(bf).float()
    try:
        want = fn(*args)
    finally:
        torch.softmax = softmax
    assert torch.equal(got, want) and got.dtype == bf
    assert not torch.equal(got, plain)
    # each P off by under 2^-9 of itself, the P's of a row summing to 1;
    # each output rounded to bf16 twice
    bound = 2.0 ** -9 * float(v.float().abs().max()) + 2.0 ** -7 * float(plain.float().abs().max())
    assert float((got.float() - plain.float()).abs().max()) <= bound

"""The port's model zoo against the reference's: every architecture of
``repro.configs`` registered, each config equal field by field, the
parameter counts equal, ``lm.forward`` of the seven architectures added
with MoE and MLA (stablelm, granite, command-r, musicgen, pixtral,
deepseek-v2, arctic) within 1e-4 of ``repro.models.lm.forward`` on reduced
float32 configs (pixtral through its patch embeddings), the engine's
pixtral refusal and the serve CLI on the CPU for deepseek-v2 and arctic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JNAMES
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.serve import ServeEngine

#: the architectures this slice registers
NEW_ARCHS = ("stablelm-1.6b", "granite-3-8b", "command-r-35b", "musicgen-large",
             "pixtral-12b", "deepseek-v2-236b", "arctic-480b")


def _fields(cfg) -> dict:
    """A config as nested plain values (its sub-configs as dicts)."""
    return dataclasses.asdict(cfg)


def test_registry_names_the_reference_architectures():
    assert ARCH_NAMES == JNAMES
    assert set(NEW_ARCHS) <= set(ARCH_NAMES)


@pytest.mark.parametrize("arch", JNAMES)
def test_config_equals_reference_field_by_field(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert _fields(tcfg) == _fields(jcfg)
    assert _fields(tcfg.reduced()) == _fields(jcfg.reduced())
    assert tcfg.pattern() == jcfg.pattern() and tcfg.padded_vocab == jcfg.padded_vocab
    for cfg_t, cfg_j in ((tcfg, jcfg), (tcfg.reduced(), jcfg.reduced())):
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_build_metas_equal_reference_shapes(arch):
    """The port's parameter tree has the reference's keys and shapes: the
    bridge carries the ``moe`` and MLA leaves with no special case."""
    jcfg, tcfg = jget(arch).reduced(), get_config(arch).reduced()
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    back = bridge.params_to_numpy(tparams)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, jparams))
    if tcfg.moe is not None:
        key = next(k for k in tparams["blocks"] if k.endswith("_a"))
        assert "moe" in tparams["blocks"][key] and "mlp" not in tparams["blocks"][key]
    if tcfg.first_k_dense:
        assert "mlp" in tparams["blocks"]["g0_d"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch, rng):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", remat="none")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    if tcfg.frontend == "patch_embed":
        embeds = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
        jbatch, tbatch = {"embeds": jnp.asarray(embeds)}, {"embeds": torch.from_numpy(embeds)}
    else:
        tokens = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
        jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    jlogits, _, _ = jlm.forward(jparams, jbatch, jcfg, mode="train")
    tlogits, cache = lm.forward(tparams, tbatch, tcfg, mode="train")
    assert cache is None and tlogits.shape == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


def test_engine_refuses_pixtral_as_the_reference():
    cfg = get_config("pixtral-12b").reduced()
    with pytest.raises(ValueError) as want:
        JServeEngine(jget("pixtral-12b").reduced())
    with pytest.raises(ValueError) as got:
        ServeEngine(cfg, device="cpu")
    assert str(got.value) == str(want.value)
    assert "patch-embed" in str(got.value)


@pytest.mark.parametrize("arch,flags", [
    ("deepseek-v2-236b", ["--page-size", "8", "--prefill-chunk", "8"]),
    ("arctic-480b", ["--page-size", "8", "--prefill-bucket", "8"]),
    # a depth cut: deepseek-v2's dense layer and one MoE layer
    ("deepseek-v2-236b", ["--layers", "2"]),
])
def test_serve_cli_runs_moe_archs_on_cpu(arch, flags, capsys, monkeypatch):
    made = []
    monkeypatch.setattr(serve_cli, "ServeEngine",
                        lambda cfg, **kw: made.append(cfg) or ServeEngine(cfg, **kw))
    assert serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                           "--prompt-len", "12", "--gen", "3", "--slots", "2",
                           "--max-len", "32", *flags]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out
    assert "continuous batching:" in out and "step programs:" in out
    (cfg,) = made
    assert cfg.pattern() == ("da" if "--layers" in flags else get_config(arch).reduced().pattern())


@pytest.mark.parametrize("arch", JNAMES)
def test_cut_keeps_the_leading_layers_at_full_width(arch):
    """``ArchConfig.cut`` (the CLI's ``--layers`` and the card's depth cuts)
    keeps the pattern's first layers and every width."""
    cfg = get_config(arch)
    cut = cfg.cut(2)
    assert cut.n_layers == 2 and cut.pattern() == cfg.pattern()[:2]
    rest = lambda c: {k: v for k, v in _fields(c).items()  # noqa: E731
                      if k not in ("n_layers", "block_pattern")}
    assert rest(cut) == rest(cfg)
    if arch == "deepseek-v2-236b":
        assert cfg.cut(4).pattern() == "daaa"

"""The port's dry-run (``repro_torch.launch.dryrun``) and abstract steps
(``repro_torch.launch.steps``) against the reference's
(``repro.launch.dryrun`` / ``repro.launch.steps``): the abstract inputs'
shapes and dtypes for every arch, the prefill and decode steps' values,
a record with every key through the CLI, the graph FLOPs of the cells
against ``hlo_cost`` of the reference's jitted steps, the sharding
overrides a one-card cell refuses and the precision ones the port
refuses.
Reduced configs, CPU only.

Tolerances: prefill and decode logits and caches in f32 within 1e-4
(absolute and relative): the same f32 formulas, summed in another order by
another library.  Graph FLOPs of the reduced llama and deepseek cells equal
the reference's compiled module's exactly (``CELL_TOL``): no dot of these
steps is rewritten by XLA in a way that changes its FLOPs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlo_cost
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, steps
from repro_torch.optim.adamw import AdamW

B, S = 2, 32
ATOL = RTOL = 1e-4
#: graph FLOPs of the port's cells over the reference's compiled ones
CELL_TOL = {"llama3.2-1b": 1e-9, "deepseek-v2-236b": 1e-9}
RECORD_KEYS = ("arch", "shape", "mesh", "status", "chips", "trace_s", "graph_flops_per_device",
               "graph_bytes_per_device", "collectives_per_device", "collective_bytes_per_device",
               "model_flops", "argument_size_in_bytes", "temp_size_in_bytes",
               "output_size_in_bytes", "peak_bytes_per_device", "fits_device", "roofline_s",
               "bound_by")


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (and an OptState's fields)."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        tree = {"mu": tree.mu, "nu": tree.nu, "step": tree.step}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _sig(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_inputs_match_the_reference(arch, kind):
    jcfg, tcfg = jget(arch).reduced(), get_config(arch).reduced()
    jshape, tshape = JShape("t", S, B, kind), ShapeConfig("t", S, B, kind)
    assert _sig(steps.input_specs(tcfg, tshape)) == _sig(jsteps.input_specs(jcfg, jshape))
    if kind == "train":
        tstate = steps.abstract_state(tcfg, AdamW(moment_dtype=tcfg.opt_dtype))
        jstate = jsteps.abstract_state(jcfg, JAdamW(moment_dtype=jcfg.opt_dtype))
        assert _sig(tstate[0]) == _sig(jstate[0])
        assert _sig(tstate[1]) == _sig(jstate[1])
    elif kind == "decode":
        assert _sig(steps.abstract_cache(tcfg, tshape)) == _sig(jsteps.abstract_cache(jcfg, jshape))
        if any(ch in "ads" for ch in tcfg.pattern()):
            kw = dict(page_size=8, n_pages=2 * S // 8)
            assert (_sig(steps.abstract_cache(tcfg, tshape, **kw))
                    == _sig(jsteps.abstract_cache(jcfg, jshape, **kw)))


def _close(ours, theirs):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(theirs, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "mamba2-2.7b", "zamba2-7b"])
def test_prefill_and_decode_steps_match_the_reference(arch, rng):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    jparams = jlm.init_params(jcfg, seed=0)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)

    jlogits, jcache = jax.jit(jsteps.make_prefill_step(jcfg, JShape("p", S, B, "prefill")))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, cache = steps.make_prefill_step(tcfg, ShapeConfig("p", S, B, "prefill"))(
            tparams, {"tokens": torch.from_numpy(tokens)})
    _close(logits, jlogits)
    jflat = _flat(jax.tree.map(np.asarray, jcache))
    assert _flat(cache).keys() == jflat.keys()
    for k, v in _flat(cache).items():
        _close(v, jflat[k])

    # the decode step from one cache of seeded contents, rows at their own
    # positions
    jcache = _fill(jax.tree.map(np.asarray, jlm.init_cache(jcfg, B, S)), rng)
    jcache["index"] = np.array([5, 17], np.int32)
    tcache = bridge.cache_from_numpy(jcache, tcfg, B, S)
    nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    jlogits, jcache = jax.jit(jsteps.make_decode_step(jcfg))(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, jcache),
        {"tokens": jnp.asarray(nxt)})
    with torch.no_grad():
        logits, tcache = steps.make_decode_step(tcfg)(tparams, tcache,
                                                      {"tokens": torch.from_numpy(nxt)})
    _close(logits, jlogits)
    jflat = _flat(jax.tree.map(np.asarray, jcache))
    for k, v in _flat(tcache).items():
        _close(v, jflat[k])


def _fill(tree, rng):
    """Every float leaf of a cache tree drawn at 0.5 scale."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng) for k, v in tree.items()}
    if np.issubdtype(tree.dtype, np.floating):
        return (0.5 * rng.standard_normal(tree.shape)).astype(tree.dtype)
    return tree


@pytest.fixture
def reduced_cells(monkeypatch):
    """The dry-run on reduced configs and a small train / prefill / decode
    shape each (only the reference's flags)."""
    shapes = {"train_4k": ShapeConfig("train_4k", S, B, "train"),
              "prefill_32k": ShapeConfig("prefill_32k", S, B, "prefill"),
              "decode_32k": ShapeConfig("decode_32k", S, B, "decode"),
              "long_500k": ShapeConfig("long_500k", S, 1, "decode")}
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "get_shape", lambda s: shapes[s])
    return shapes


def test_run_cell_records_every_key_through_the_cli(reduced_cells, tmp_path, capsys):
    out, graphs = tmp_path / "dryrun.json", tmp_path / "graphs"
    dryrun.main(["--arch", "llama3.2-1b", "--out", str(out), "--save-hlo", str(graphs)],
                device="cpu")
    recs = json.loads(out.read_text())
    assert [r["shape"] for r in recs] == list(reduced_cells)
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 3 and recs[-1]["status"] == "skipped"  # long_500k: full attention
    for rec in ok:
        assert all(k in rec for k in RECORD_KEYS), [k for k in RECORD_KEYS if k not in rec]
        assert rec["mesh"] == "1" and rec["chips"] == 1 and rec["fits_device"]
        assert rec["roofline_s"] > 0 and rec["bound_by"] in ("bytes", "operations")
        assert rec["graph_flops_per_device"] > 0
        assert rec["peak_bytes_per_device"] >= rec["argument_size_in_bytes"]
    assert "done: 3 ok, 1 skipped, 0 errors" in capsys.readouterr().out
    # the saved node tables re-analyse to the same fields
    before = json.loads(out.read_text())
    dryrun.main(["--reparse", "--out", str(out), "--save-hlo", str(graphs)], device="cpu")
    after = json.loads(out.read_text())
    for a, b in zip(before, after):
        assert {k: a.get(k) for k in RECORD_KEYS} == {k: b.get(k) for k in RECORD_KEYS}


def _reference_cost(arch, kind):
    jcfg = jget(arch).reduced()
    shape = JShape("t", S, B, kind)
    if kind == "train":
        opt = JAdamW(moment_dtype=jcfg.opt_dtype)
        params, state = jsteps.abstract_state(jcfg, opt)
        fn = jsteps.make_train_step(jcfg, opt, jsteps.TrainHyper(microbatch=2))
        args = (params, state, jsteps.input_specs(jcfg, shape))
    elif kind == "prefill":
        params, _ = jsteps.abstract_state(jcfg)
        fn, args = jsteps.make_prefill_step(jcfg, shape), (params, jsteps.input_specs(jcfg, shape))
    else:
        params, _ = jsteps.abstract_state(jcfg)
        fn = jsteps.make_decode_step(jcfg)
        args = (params, jsteps.abstract_cache(jcfg, shape), jsteps.input_specs(jcfg, shape))
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(CELL_TOL))
def test_cell_graph_flops_match_hlo_cost(arch, kind, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    rec = dryrun.run_cell(arch, ShapeConfig("t", S, B, kind), device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    theirs = _reference_cost(arch, kind)
    assert rec["graph_flops_per_device"] == pytest.approx(theirs["flops"], rel=CELL_TOL[arch])
    assert rec["model_flops"] == pytest.approx(
        (6 if kind == "train" else 2) * get_config(arch).reduced().active_param_count()
        * B * (1 if kind == "decode" else S))


@pytest.mark.parametrize("override", ["ep_mode", "bf16_tp_reduce", "megatron_mlp"])
def test_sharding_overrides_raise(override):
    """On one card (no mesh) the sharding overrides raise; mesh cells take
    them (``tests/test_torch_dryrun_mesh.py``)."""
    with pytest.raises(ValueError, match="shard across devices: give a mesh cell"):
        dryrun.build_cell("llama3.2-1b", "train_4k", {override: True}, device="cpu")
    with pytest.raises(ValueError, match="unknown overrides"):
        dryrun.build_cell("llama3.2-1b", "train_4k", {"no_such_knob": 1}, device="cpu")
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", overrides={override: "psum"}, device="cpu")
    assert rec["status"] == "error" and "give a mesh cell" in rec["error"]


@pytest.mark.parametrize("override", ["scores_dtype", "norm_precision"])
def test_precision_overrides_are_refused(override):
    """The reference's knobs on XLA's plain attention and norm: the card
    runs kernels there, so the port refuses them as unknown."""
    with pytest.raises(ValueError, match=f"unknown overrides: \\['{override}'\\]"):
        dryrun.build_cell("llama3.2-1b", "train_4k", {override: "bfloat16"}, device="cpu")


def test_shapes_and_cells_are_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cells as jcells
    from repro_torch.configs import SHAPES, cells, get_shape

    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert get_shape("decode_32k").seq_len == 32768
    assert cells() == jcells() and cells(True) == jcells(True)

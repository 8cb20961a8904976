"""The dry-run's mesh cells (``repro_torch.launch.dryrun``, ``mesh="2x4"``):
reduced llama3.2-1b cut to 2 layers, traced as rank 0 of a fake 8-rank
(data=2, model=4) process group — the per-device parameter bytes are the
spec tree's shards, the train cell counts the FSDP all-gathers and the
sequence-parallel reduce-scatters, and the manual tensor-parallel knobs
change the collective mix as the reference's comments say.  One-card
records are unchanged: equal, field by field, to what the tree before the
mesh cells recorded for the same reduced cells."""

import math

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.params import ParamMeta, spec_tree, torch_dtype
from repro_torch.sharding import rules_for

MESH, SIZES = "2x4", {"data": 2, "model": 4}
B, S = 4, 32
#: one-card records of reduced llama3.2-1b at B=2, S=32 (all 4 layers), as
#: the dry-run wrote them before its mesh cells existed
ONE_CARD = {
    "train": dict(graph_flops_per_device=92274688.0, graph_bytes_per_device=67602702.0,
                  argument_size_in_bytes=3452692, temp_size_in_bytes=1646592,
                  output_size_in_bytes=690444, peak_bytes_per_device=5099284),
    "prefill": dict(graph_flops_per_device=20054016.0, graph_bytes_per_device=6983880.0,
                    argument_size_in_bytes=690688, temp_size_in_bytes=259072,
                    output_size_in_bytes=18440, peak_bytes_per_device=949760),
    "decode": dict(graph_flops_per_device=753664.0, graph_bytes_per_device=1833184.0,
                   argument_size_in_bytes=706832, temp_size_in_bytes=68096,
                   output_size_in_bytes=18440, peak_bytes_per_device=774928),
}


def _cfg():
    return get_config("llama3.2-1b").reduced().cut(2)


@pytest.fixture
def reduced(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: _cfg())


@pytest.fixture(scope="module")
def train_mix():
    """The train cell's record under each manual TP setting (one
    microbatch, no remat: a shorter trace of the same collectives)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_config", lambda a: _cfg())
    short = {"microbatch": 1, "remat": "none"}
    try:
        return {name: dryrun.run_cell("llama3.2-1b", ShapeConfig("t", S, B, "train"),
                                      overrides={**short, **ov}, device="cpu", mesh=MESH)
                for name, ov in (("propagation", {}), ("bf16_tp_reduce", {"bf16_tp_reduce": True}),
                                 ("megatron_mlp", {"megatron_mlp": True}))}
    finally:
        mp.undo()


def _shard_bytes(meta: ParamMeta, spec: tuple) -> int:
    """Rank 0's shard of a leaf: each dim split over the mesh axes its spec
    names (the first chunk of ``torch.chunk``)."""
    n = 1
    for size, entry in zip(meta.shape, spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        k = math.prod(SIZES.get(a, 1) for a in names)
        n *= -(-size // k)
    return n * torch_dtype(meta.dtype).itemsize


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_per_device_parameter_bytes_are_the_spec_trees_shards(reduced):
    cfg = _cfg()
    shape = ShapeConfig("t", S, B, "train")
    metas = lm.build_metas(cfg)
    specs = spec_tree(metas, rules_for(cfg, shape, SIZES))
    want = sum(_shard_bytes(m, s) for m, s in zip(_leaves(metas), _leaves(specs)))
    with dryrun.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        _, _, _, (params, opt_state, _) = dryrun.build_cell(
            "llama3.2-1b", shape, device="cpu", mesh=mesh)
        got = [p.to_local() for p in _leaves(params)]
    assert sum(t.numel() * t.element_size() for t in got) == want
    assert want < sum(math.prod(m.shape) * 4 for m in _leaves(metas)) / 4
    # the moments take the parameters' placements, the step count is whole
    assert [tuple(m.placements) for m in _leaves(opt_state.mu)] == \
        [tuple(p.placements) for p in _leaves(params)]
    assert all(p.is_replicate() for p in opt_state.step.placements)


def test_train_cell_counts_gathers_and_scatters(train_mix):
    rec = train_mix["propagation"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == MESH and rec["chips"] == 8 and rec["fits_device"]
    coll = rec["collectives_per_device"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert rec["collective_bytes_per_device"] == pytest.approx(sum(coll.values()))
    assert rec["peak_bytes_per_device"] >= rec["argument_size_in_bytes"] > 0


def test_manual_tp_knobs_change_the_collective_mix(train_mix):
    """BF16_TP_REDUCE: the output projections' partial sums reduce-scatter
    in the compute dtype straight into the sequence shards (fewer
    reduce-scatter bytes); MEGATRON_MLP: one all-gather and one
    reduce-scatter per MLP, the weights gathered at the boundary in the
    compute dtype (fewer all-gather and reduce-scatter bytes)."""
    base, tp, meg = (train_mix[k]["collectives_per_device"]
                     for k in ("propagation", "bf16_tp_reduce", "megatron_mlp"))
    assert tp["reduce-scatter"] < base["reduce-scatter"]
    assert meg["all-gather"] < base["all-gather"]
    assert meg["reduce-scatter"] < base["reduce-scatter"]
    assert sum(tp.values()) < sum(base.values()) and sum(meg.values()) < sum(base.values())
    # the loss's FLOPs do not move: the same products, other collectives
    flops = {k: r["graph_flops_per_device"] for k, r in train_mix.items()}
    assert flops["bf16_tp_reduce"] == flops["propagation"] == flops["megatron_mlp"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cells_trace_on_the_mesh(reduced, kind):
    rec = dryrun.run_cell("llama3.2-1b", ShapeConfig("t", S, B, kind), device="cpu", mesh=MESH)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 8 and rec["graph_flops_per_device"] > 0
    assert rec["peak_bytes_per_device"] > 0


@pytest.mark.parametrize("kind", list(ONE_CARD))
def test_one_card_records_are_unchanged(monkeypatch, kind):
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    rec = dryrun.run_cell("llama3.2-1b", ShapeConfig("t", 32, 2, kind), device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert {k: rec[k] for k in ONE_CARD[kind]} == ONE_CARD[kind]
    assert rec["mesh"] == "1" and rec["chips"] == 1 and rec["collective_bytes_per_device"] == 0


def test_multi_pod_flag_picks_the_reference_meshes():
    assert dryrun.POD_MESHES == {"single": ("16x16",), "multi": ("2x16x16",),
                                 "both": ("16x16", "2x16x16")}
    assert dryrun.mesh_dims("2x16x16") == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="give a mesh cell"):
        dryrun.build_cell("llama3.2-1b", "train_4k", {"ep_mode": "psum"}, device="cpu")

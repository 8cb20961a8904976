"""The port's sharding rules and logical-axis context
(``repro_torch.sharding``) against the reference's (``repro.sharding``):
``rules_for`` for every arch, shape, mesh and expert-parallel mode, and
``resolve_spec`` on the reference tests' cases; the spec -> ``DTensor``
placement map; ``constrain`` without a mesh."""

import pytest
import torch

from repro.configs import ARCH_NAMES, SHAPES
from repro.configs import get_config as jget
from repro.configs import get_shape as jshape
from repro.sharding import specs as jspecs
from repro.sharding import utils as jutils
from repro_torch.configs import get_config, get_shape
from repro_torch.sharding import (
    DEFAULT_RULES,
    constrain,
    current_mesh,
    current_rules,
    resolve_spec,
    rules_for,
    use_sharding,
)

MESHES = {"1pod": {"data": 16, "model": 16}, "2pod": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}


def test_default_rules_are_the_references():
    assert DEFAULT_RULES == jspecs.DEFAULT_RULES


@pytest.mark.parametrize("ep_mode", ["gather", "psum"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_for_matches_the_reference(arch, shape, mesh, ep_mode):
    ours = rules_for(get_config(arch), get_shape(shape), MESHES[mesh], ep_mode=ep_mode)
    theirs = jspecs.rules_for(jget(arch), jshape(shape), MESHES[mesh], ep_mode=ep_mode)
    assert ours == theirs


@pytest.mark.parametrize("fsdp", [True, False])
def test_rules_for_explicit_fsdp_matches_the_reference(fsdp):
    for arch in ARCH_NAMES:
        ours = rules_for(get_config(arch), get_shape("decode_32k"), MESHES["1pod"], fsdp=fsdp)
        assert ours == jspecs.rules_for(jget(arch), jshape("decode_32k"), MESHES["1pod"],
                                        fsdp=fsdp)


RESOLVE_CASES = [
    (("a", "b", "c"), {"a": "model", "b": "model", "c": ("data",)}),  # dedupe
    (("batch", None), {"batch": ("pod", "data")}),  # multi-axis
    (("act_batch", "act_seq", None), {"act_batch": ("pod", "data"), "act_seq": ("data",)}),
    (("act_batch", "kv_heads_act", "cache_seq", None),
     {"act_batch": ("data",), "kv_heads_act": "model", "cache_seq": ("pod", "model")}),
    (("embed", "heads"), {"embed": None, "heads": "model"}),
    ((None, None), {}),
]


@pytest.mark.parametrize("axes,rules", RESOLVE_CASES)
def test_resolve_spec_matches_the_reference(axes, rules):
    assert resolve_spec(axes, rules) == tuple(jutils.resolve_spec(axes, rules))


def test_resolve_spec_reads_the_active_rules():
    rules = {"a": "model"}
    with use_sharding(None, rules):
        assert current_rules() == rules and current_mesh() is None
        assert resolve_spec(("a", None)) == ("model", None)
    assert current_rules() == {}


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert constrain(x, "act_batch", "act_seq", None) is x
    with use_sharding(None, {"act_batch": ("data",)}):
        assert constrain(x, "act_batch", None, None) is x


class _Mesh:
    mesh_dim_names = ("pod", "data", "model")


def test_placements_split_a_dimension_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import placements

    assert placements((("pod", "data"), None, "model"), _Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), _Mesh()) == (Replicate(), Shard(1), Replicate())
    assert placements(("no_such_axis",), _Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements((("data", "pod"),), _Mesh())

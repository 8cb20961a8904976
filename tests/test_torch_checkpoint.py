"""The port's checkpoint manager, on the reference's cases
(``tests/test_checkpoint.py``): atomicity, retention, restore, a missing key
and a shape mismatch raising; and the port's own trees: nested dicts of
tensors with an ``OptState``, bfloat16 leaves, the restored leaves on the
target tree's device and dtype, and the host copy taken in the caller (the
train step updates its tensors in place)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.adamw import AdamW, OptState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 4, generator=g), "b": torch.randn(4, generator=g)},
        "opt": {"mu": torch.randn(4, 4, generator=g)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(10, tree, blocking=True)
    step, restored = mgr.restore(_tree(seed=99))
    assert step == 10
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert torch.equal(restored["step"], tree["step"])
    assert restored["step"].dtype == torch.int32


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(1))
    mgr.wait()
    assert mgr.latest_step() == 5


def test_retention_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.steps() == [3, 4]


def test_half_written_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, _tree(), blocking=True)
    # simulate a crash mid-write: directory without manifest
    broken = tmp_path / "step_00000009"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 3  # not 9
    step, _ = mgr.restore(_tree())
    assert step == 3


def test_restore_missing_key_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.zeros(2)}, blocking=True)
    with pytest.raises(KeyError):
        mgr.restore({"a": torch.zeros(2), "new_key": torch.zeros(3)})


@settings(max_examples=10, deadline=None)
@given(
    shapes=st.lists(st.tuples(st.integers(1, 5), st.integers(1, 5)), min_size=1, max_size=4),
    seed=st.integers(0, 2**16),
)
def test_roundtrip_property(tmp_path_factory, shapes, seed):
    g = torch.Generator().manual_seed(seed)
    tree = {f"k{i}": torch.randn(s, generator=g) for i, s in enumerate(shapes)}
    mgr = CheckpointManager(tmp_path_factory.mktemp("ckpt"))
    mgr.save(1, tree, blocking=True)
    _, restored = mgr.restore(tree)
    for k in tree:
        assert torch.equal(restored[k], tree[k])


def test_restore_shape_mismatch_fails_loudly(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros(4, 4)}, blocking=True)
    with pytest.raises(ValueError, match="does not match the current model"):
        mgr.restore({"w": torch.zeros(8, 8)})


def test_train_state_with_opt_state_and_bf16_roundtrips(tmp_path):
    """A train state (params and an ``OptState`` with bf16 moments) restores
    leaf for leaf into its own structure, each leaf in the target's dtype."""
    params = {"embed": {"embedding": torch.randn(8, 4)}, "final_norm": torch.ones(4)}
    opt = AdamW(moment_dtype="bfloat16")
    state = {"params": params, "opt": opt.init(params)}
    state["opt"].mu["embed"]["embedding"].normal_()
    state["opt"].step += 3
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state, blocking=True)
    step, restored = mgr.restore({"params": params, "opt": opt.init(params)})
    assert step == 3 and isinstance(restored["opt"], OptState)
    mu = restored["opt"].mu["embed"]["embedding"]
    assert mu.dtype == torch.bfloat16 and torch.equal(mu, state["opt"].mu["embed"]["embedding"])
    assert int(restored["opt"].step) == 3
    assert torch.equal(restored["params"]["embed"]["embedding"], params["embed"]["embedding"])


def test_save_copies_to_host_before_returning(tmp_path):
    """The write runs on a thread; the caller's in-place update right after
    ``save`` must not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    tree = {"w": torch.zeros(256, 256)}
    mgr.save(1, tree)
    tree["w"].add_(1.0)  # the next step, in place
    _, restored = mgr.restore({"w": torch.empty(256, 256)})
    assert not restored["w"].any()
    assert np.all(tree["w"].numpy() == 1.0)

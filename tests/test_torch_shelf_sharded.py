"""The kernel shelf on local shards (``repro_torch.sharding.shelf``): a
function block called on ``DTensor``s runs the implementation its
binding resolves to — a ``cuda`` binding stays the kernel's wrapper — on
plain local shards placed by the block's contract, in one process on a
fake 8-rank (data=2, model=4) group (rank 0; its collectives move
nothing, so only shapes, targets and placements are checked here; the
values are the 4-rank gloo tests')."""

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.core import blocks
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh


@pytest.fixture
def mesh():
    with fake_world(8):
        yield make_mesh((2, 4), ("data", "model"), "cpu")


@pytest.fixture
def recorded(monkeypatch):
    """The ``cuda`` targets of rmsnorm and attention replaced by stubs that
    record what they were given and return the plain version's output."""
    calls = []
    reg = blocks.registry
    for block in ("rmsnorm", "attention"):
        impl = reg.implementation(block, "cuda")
        plain = reg.implementation(block, "torch").fn

        def stub(*args, _plain=plain, _block=block, **kwargs):
            calls.append((_block, args, kwargs))
            return _plain(*args, **kwargs)

        monkeypatch.setitem(reg._impls[block], "cuda", impl.__class__(
            block, "cuda", stub, impl.note, impl.no_backward))
    return calls


def _dt(shape, mesh, placements):
    return DTensor.from_local(torch.randn(shape), mesh, placements, run_check=False)


def test_a_cuda_binding_runs_on_the_local_shards(mesh, recorded):
    x = _dt((4, 4, 32), mesh, (Shard(0), Shard(1)))  # global (8, 16, 32)
    w = distribute_tensor(torch.ones(32), mesh, (Replicate(), Replicate()))
    with blocks.bind({"rmsnorm": "cuda"}):
        y = blocks.call("rmsnorm", x, w, eps=1e-6)
    (block, args, _), = recorded
    assert block == "rmsnorm"
    assert type(args[0]) is torch.Tensor and args[0].shape == (4, 4, 32)
    assert isinstance(y, DTensor) and y.shape == (8, 16, 32)
    assert tuple(y.placements) == (Shard(0), Shard(1))


def test_the_normalised_dim_is_gathered(mesh, recorded):
    x = _dt((8, 16, 8), mesh, (Replicate(), Shard(2)))  # the norm's dim sharded
    w = distribute_tensor(torch.ones(32), mesh, (Replicate(), Replicate()))
    with blocks.bind({"rmsnorm": "cuda"}):
        x2, y = blocks.call("rmsnorm", x, w, eps=1e-6, delta=x)
    (_, args, kwargs), = recorded
    assert args[0].shape == (8, 16, 32) and kwargs["delta"].shape == (8, 16, 32)
    assert tuple(y.placements) == (Replicate(), Replicate()) and y.shape == (8, 16, 32)


def test_gqa_with_replicated_kv_heads_takes_the_heads_its_q_heads_read(mesh, recorded):
    # 8 q heads over model=4 (2 a rank), 2 kv heads (2 % 4 != 0: replicated);
    # rank 0's q heads 0, 1 read kv head 0 (group 4)
    q = _dt((2, 2, 16, 8), mesh, (Shard(0), Shard(1)))  # global (4, 8, 16, 8)
    k = _dt((2, 2, 16, 8), mesh, (Shard(0), Replicate()))
    v = _dt((2, 2, 16, 8), mesh, (Shard(0), Replicate()))
    with blocks.bind({"attention": "cuda"}):
        o = blocks.call("attention", q, k, v, causal=True)
    (block, args, _), = recorded
    assert block == "attention"
    assert args[0].shape == (2, 2, 16, 8) and args[1].shape == (2, 1, 16, 8)
    torch.testing.assert_close(args[1], k.to_local()[:, :1])
    assert tuple(o.placements) == (Shard(0), Shard(1)) and o.shape == (4, 8, 16, 8)


def test_paged_attention_refuses_a_sharded_call(mesh):
    q = _dt((2, 2, 1, 8), mesh, (Shard(0), Replicate()))
    pool = torch.zeros(4, 2, 8, 8)
    with pytest.raises(ValueError, match="does not run under a mesh"):
        blocks.call("paged_attention", q, pool, pool, torch.zeros(4, 2, dtype=torch.int32),
                    torch.zeros(4, dtype=torch.int32))


def test_plain_tensors_reach_the_implementation_untouched(recorded):
    x, w = torch.randn(2, 3, 8), torch.ones(8)
    with blocks.bind({"rmsnorm": "cuda"}):
        blocks.call("rmsnorm", x, w, eps=1e-6)
    (_, args, _), = recorded
    assert args[0] is x and args[1] is w

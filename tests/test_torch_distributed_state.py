"""The port's distributed state on 4 gloo ranks: ``compressed_psum_mean``
(``repro_torch.optim.compression``) against a numpy transcription of the
reference's formula (``repro/optim/compression.py``), with equal and with
unequal per-rank scales; ``reshard_restore``
(``repro_torch.checkpoint.elastic``) of a checkpoint saved at world 1."""

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.checkpoint import CheckpointManager

WORLD = 4


def _grads(rank: int) -> dict:
    """Rank ``rank``'s gradients: ``equal`` has max|g| 1 on every rank (equal
    scales), ``unequal`` a max that grows with the rank."""
    rng = np.random.default_rng(rank)
    equal = rng.uniform(-1, 1, (6, 5)).astype(np.float32)
    equal[0, 0] = 1.0
    unequal = (rng.standard_normal((7,)) * (rank + 1)).astype(np.float32)
    return {"equal": torch.from_numpy(equal), "nested": {"unequal": torch.from_numpy(unequal)}}


def _reference_mean(per_rank: list[np.ndarray]) -> np.ndarray:
    """The reference's ``compressed_psum_mean`` body in numpy (f32): each
    rank quantizes with its own scale; the int32 sum of the int8 values
    times the largest scale, over the rank count."""
    qs, scales = [], []
    for g in per_rank:
        s = np.float32(np.abs(g).max()) / np.float32(127.0) + np.float32(1e-12)
        qs.append(np.clip(np.round(g / s), -127, 127).astype(np.int8))
        scales.append(np.float32(s))
    tot = np.sum([q.astype(np.int32) for q in qs], axis=0)
    return tot.astype(np.float32) * max(scales) / np.float32(len(per_rank))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_state")
    for r in range(WORLD):
        torch.save(_grads(r), out / f"grads_{r}.pt")
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "b": torch.arange(8, dtype=torch.float32) * -1.5, "s": torch.tensor(7.0)}
    CheckpointManager(out / "ckpt").save(3, tree, blocking=True)
    torch.save({k: torch.zeros_like(v) for k, v in tree.items()}, out / "like.pt")
    torch_ranks.run_ranks(torch_ranks.distributed_state_rank, WORLD, out, str(out),
                          timeout=120)
    return tree, [torch.load(out / f"state_{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("leaf", ["equal", "unequal"])
def test_compressed_psum_mean_is_the_reference_formula(ranks, leaf):
    _, states = ranks
    pick = (lambda t: t["equal"]) if leaf == "equal" else (lambda t: t["nested"]["unequal"])
    per_rank = [pick(_grads(r)).numpy() for r in range(WORLD)]
    want = _reference_mean(per_rank)
    for st in states:  # every rank holds the same mean, a plain tensor
        assert st["mean_is_plain"]
        np.testing.assert_allclose(pick(st["mean"]).numpy(), want, rtol=1e-6, atol=0)
    dequantized = np.mean([np.asarray(pick(st["mean"])) for st in states[:1]], axis=0)
    exact_mean = np.mean(per_rank, axis=0)
    if leaf == "equal":  # equal scales: the mean of the dequantized gradients
        assert np.abs(dequantized - exact_mean).max() < 1.0 / 127
    else:  # the largest scale rescales every rank's int8 values
        assert np.abs(dequantized - exact_mean).max() > 1.0 / 127


@pytest.mark.parametrize("key", ["w", "b", "s"])
def test_reshard_restore_gives_each_rank_its_slice(ranks, key):
    tree, states = ranks
    full = tree[key]
    for st in states:
        assert st["step"] == 3
        torch.testing.assert_close(st["full"][key], full, rtol=0, atol=0)
        d, m = st["coord"]
        local = st["local"][key]
        if key == "w":  # ("data", "model"): rows over data, columns over model
            want = full[4 * d:4 * d + 4, 2 * m:2 * m + 2]
        elif key == "b":  # (("data", "model"),): one dim split data-major
            i = 2 * d + m
            want = full[2 * i:2 * i + 2]
        else:
            want = full
        torch.testing.assert_close(local, want, rtol=0, atol=0)

"""The frozen work formulas against values worked by hand at real shapes
(granite-3-8b and deepseek-v2-236b-daaa as their files state them), not
against the program's own ``Work``."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench.harness import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def dims(name: str) -> work.Dims:
    with open(CONFIGS / f"{name}.json", encoding="utf-8") as f:
        return work.dims_of(json.load(f), page_size=16)


def test_dims_from_the_files():
    g = dims("granite-3-8b")
    assert (g.d_model, g.n_layers, g.pattern, g.n_heads, g.n_kv_heads, g.d_head) == (
        4096, 40, "a" * 40, 32, 8, 128)
    d = dims("deepseek-v2-236b-daaa")
    assert (d.pattern, d.kv_lora_rank, d.qk_rope, d.n_experts, d.top_k, d.n_shared) == (
        "daaa", 512, 64, 160, 6, 2)


def test_split_walk_one_granite_row():
    # one row at resident length 1023 (1024 positions seen), 16-token pages:
    # q and out 2 B x 32 heads x (128 + 128) = 16,384; K and V 2 B x 1024
    # positions x 8 heads x 256 = 4,194,304; 64 page entries + 1 index, 4 B
    # each = 260.  FLOPs 2 x 32 heads x 1024 x (128 + 128) = 16,777,216.
    w = work.paged_decode_work(dims("granite-3-8b"), [1023])
    assert w.nbytes == 16_384 + 4_194_304 + 260
    assert w.flops == 16_777_216
    assert w.bound_s() == pytest.approx(4_210_948 / 3.35e12)  # bytes bound it


def test_latent_walk_one_deepseek_row():
    # absorbed q (512) + rope q (64) + latent out (512), 2 B x 128 heads =
    # 278,528; the latent and rope key rows 2 B x 1024 x 576 = 1,179,648;
    # 260 for the table.  FLOPs 2 x 128 x 1024 x (512 + 512 + 64).
    w = work.paged_decode_work(dims("deepseek-v2-236b-daaa"), [1023])
    assert w.nbytes == 278_528 + 1_179_648 + 260
    assert w.flops == 285_212_672


def test_flash_forward_deepseek_prompt():
    # S = 4096, qk 192, v 128, 128 heads: 4096 x 4097 / 2 = 8,390,656 causal
    # pairs, each 2 x (192 + 128) x 128 FLOPs; q, k (2 x 128 x 192), v and
    # out (2 x 128 x 128) a token, 2 B each: 2 x 4096 x 81,920
    w = work.flash_forward_work(dims("deepseek-v2-236b-daaa"), 4096)
    assert w.flops == 8_390_656 * 81_920
    assert w.nbytes == 671_088_640
    assert w.bound_s() == pytest.approx(8_390_656 * 81_920 / 989e12)  # FLOPs bound it


def test_model_flops_a_granite_token():
    # a layer: attention projections 2 x (4096 x 4096 + 2 x 4096 x 1024 +
    # 4096 x 4096) = 83,886,080 and SwiGLU 2 x 3 x 4096 x 12800 =
    # 314,572,800; 40 layers 15,938,355,200.  At resident length 1023, 1024
    # positions x 40 layers x 2 x 32 x 256 = 671,088,640; the head 2 x 4096 x
    # 49155 = 402,677,760.
    g = dims("granite-3-8b")
    assert work.layer_flops_per_token(g) == 15_938_355_200
    assert work.decode_flops(g, 1023) == 15_938_355_200 + 671_088_640 + 402_677_760


def test_model_flops_a_deepseek_token_counts_the_experts_it_needs():
    # MLA projections 2 x (5120 x 128 x 192 + 5120 x 512 + 5120 x 64 +
    # 2 x 512 x 128 x 128 + 128 x 128 x 5120) = 458,883,072 a layer; the dense
    # layer's FFN 2 x 3 x 5120 x 12288 = 377,487,360; an MoE layer's router
    # and 6 routed + 2 shared experts 2 x (5120 x 160 + 3 x 5120 x 1536 x 8)
    # = 379,125,760
    d = dims("deepseek-v2-236b-daaa")
    assert work.layer_flops_per_token(d) == 4 * 458_883_072 + 377_487_360 + 3 * 379_125_760
    # a 2-token prompt: 2 tokens through the layers, 3 causal pairs x 4
    # layers x 2 x 128 x 320, one head 2 x 5120 x 102400
    assert work.prefill_flops(d, 2) == (2 * work.layer_flops_per_token(d)
                                        + 3 * 4 * 81_920 + 1_048_576_000)

"""``chip_smoke.py`` phase 21b's settings (``train_mla``) on the CPU:
deepseek-v2-236b at full width cut to its leading dense layer, whose
attention backward takes the wgmma route at qk 192 / v 128, and whose step
the port's own dry-run (``launch/dryrun.run_cell``, as phase 24 traces a
train step; fake tensors, nothing allocated) puts under the card's 80 GB.
A bad cut fails here rather than on the card."""

import importlib.util
import pathlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import attention as tatt
from repro_torch.launch.mesh import HW

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

WIDTH = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "mla", "param_dtype",
         "opt_dtype", "compute_dtype", "remat")


def test_train_mla_is_deepseeks_dense_layer_at_full_width():
    cfg, full = chip_smoke.train_cut_config(chip_smoke.TRAIN_MLA), get_config("deepseek-v2-236b")
    assert cfg.pattern() == "d" and cfg.n_layers == 1
    assert {k: getattr(cfg, k) for k in WIDTH} == {k: getattr(full, k) for k in WIDTH}
    assert cfg.param_dtype == cfg.opt_dtype == "bfloat16"
    assert cfg.param_count() == pytest.approx(1.467e9, rel=1e-3)
    # the attention the step differentiates: 128 heads at qk 192 / v 128, bf16
    m = cfg.mla
    d, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    assert (d, dv) == (192, 128)
    b, s = chip_smoke.TRAIN_MLA["batch"], chip_smoke.TRAIN_MLA["seq"]
    q, k = (torch.zeros(b, cfg.n_heads, s, d, dtype=torch.bfloat16) for _ in range(2))
    v = torch.zeros(b, cfg.n_heads, s, dv, dtype=torch.bfloat16)
    assert tatt.flash_bwd_route(q, k, v) == "wgmma"


def test_train_mla_step_fits_the_card_by_the_dry_run():
    rec = chip_smoke.train_estimate(chip_smoke.TRAIN_MLA, "cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["shape"] == "train_mla" and rec["chips"] == 1
    # weights, gradients and two bf16 moments alone: ~11.7 GB
    assert 4 * 2 * 1.467e9 < rec["peak_bytes_per_device"] < HW.memory_bytes() == 80e9
    assert rec["fits_device"]

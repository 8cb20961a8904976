"""Serving the SSM and hybrid models on the CPU: greedy served traces
token-identical to ``repro.serve.ServeEngine``, the SSM refusal of
``prefill_bucket``, and the serve CLI with ``--arch mamba2-2.7b``.

Parity traces run mamba2-2.7b and zamba2-7b reduced in float32 on both
sides with the reference's weights carried across by ``repro_torch.bridge``:
greedy argmax over f32 logits that agree to ~1e-6 picks the same token.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(arch):
    jcfg = dataclasses.replace(jget(arch).reduced(), compute_dtype="float32", remat="none")
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ("mamba2-2.7b", "zamba2-7b"):
        jcfg, tcfg = _cfgs(arch)
        jparams = jlm.init_params(jcfg, seed=0)
        out[arch] = (jparams, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return out


def _trace(engine, request_cls, prompts, gens):
    ids = [engine.submit(request_cls(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=2000)
    return [engine.completions[i].tokens for i in ids], engine


TRACES = {
    # name: (arch, prompt lengths, generation lengths, engine kwargs)
    "mamba2_contiguous": ("mamba2-2.7b", (5, 9, 4), (6, 3, 8), dict(n_slots=4)),
    "mamba2_slot_reuse": ("mamba2-2.7b", (5, 9, 4, 7, 6), (6, 3, 8, 2, 5), dict(n_slots=2)),
    "zamba2_paged": ("zamba2-7b", (5, 9, 4, 7), (6, 3, 8, 2), dict(n_slots=4, page_size=4)),
    # 6 pages of 8 = 48 tokens for 3 requests needing 32 each at the end
    "zamba2_preemption": (
        "zamba2-7b", (20, 20, 20), (12, 12, 12), dict(n_slots=3, page_size=8, n_pages=6),
    ),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_greedy_trace_token_identical_to_reference(name, weights, rng):
    arch, lens, gens, kw = TRACES[name]
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = weights[arch]
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist() for n in lens]
    want, jeng = _trace(
        JServeEngine(jcfg, params=jparams, max_len=64, seed=0, **kw), JRequest, prompts, gens
    )
    got, teng = _trace(
        ServeEngine(tcfg, params=tparams, max_len=64, seed=0, device="cpu", **kw),
        Request, prompts, gens,
    )
    assert got == want
    assert teng.stats.slot_reuses == jeng.stats.slot_reuses
    assert teng.stats.preemptions == jeng.stats.preemptions
    if name.endswith("slot_reuse"):
        assert teng.stats.slot_reuses >= 3
    if name.endswith("preemption"):
        assert teng.stats.preemptions > 0
    if teng.kv is not None:
        teng.kv.pool.check_leaks()
        assert teng.kv.pool.used_pages == 0


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_prefill_bucket_refused_for_ssm_patterns(arch):
    with pytest.raises(ValueError, match="recurrent SSM"):
        ServeEngine(get_config(arch).reduced(), prefill_bucket=8, device="cpu")


def test_serve_cli_runs_mamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-2.7b",
            "--reduced", "--device", "cpu", "--requests", "4", "--prompt-len", "10",
            "--len-jitter", "3", "--gen", "4", "--slots", "2", "--max-len", "32"]
    out = subprocess.run(base, capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "arch=mamba2-2.7b-reduced" in out.stdout
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("continuous batching:"))
    assert int(line.split()[2]) >= 1
    refused = subprocess.run(base + ["--prefill-bucket", "8"], capture_output=True, text=True,
                             timeout=300, env=env, cwd=ROOT)
    assert refused.returncode != 0 and "recurrent SSM" in refused.stderr

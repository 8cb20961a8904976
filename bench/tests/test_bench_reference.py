"""The plain reference computes what the port computes: served in float32
on the CPU (the port's compute dtype set to float32), every served token
is the reference's best, to float32 rounding, through prefill, paged
decode, chunked prefill, MLA and capacity-routed experts."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from bench.harness import check, driver, loadgen, spec, weights
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


@pytest.mark.parametrize("name", ["granite-3-8b.chat-rate", "deepseek-v2-236b-daaa.doc-rate",
                                  "deepseek-v2-236b-daaa.chat"])
def test_reference_matches_the_port_in_float32(name):
    cell = spec.load_cell(name)
    mix = dict(cell.traffic)
    mix.update(mix["reduced"])
    cfg = dataclasses.replace(driver.port_config(cell, True), compute_dtype="float32")
    dims = driver.dims_of_arch(cfg, mix["engine"]["page_size"])
    params = weights.draw(lm.compute_metas(cfg), 3, torch.device("cpu"))
    engine = ServeEngine(cfg, params=params, device="cpu", **mix["engine"])
    stream = loadgen.Stream(mix, cfg.vocab_size, 3)
    draws = [stream.next() for _ in range(5)]
    ids = [engine.submit(Request(d.prompt, max_new_tokens=d.out_len)) for d in draws]
    engine.run_until_idle(max_steps=10_000)
    sample = [check.Sampled(d.prompt, list(engine.completions[i].tokens))
              for d, i in zip(draws, ids)]
    gap = check.gap_readings(params, dims, cell.config["port"], sample, torch.device("cpu"),
                            mix["engine"]["prefill_chunk"])
    assert gap["tokens"] == sum(d.out_len for d in draws)
    assert gap["program"] < 1e-5


def test_capacity_drops_choices_past_an_experts_slots():
    from bench.harness import reference

    dims = driver.work.Dims(d_model=4, n_layers=1, pattern="a", n_heads=1, n_kv_heads=1,
                            d_head=4, d_ff=4, vocab=8, n_experts=4, top_k=2, d_expert=4)
    sem = {"capacity_factor": 1.0, "capacity_multiple": 4, "capacity_min": 4}
    # 10 tokens: capacity ceil(10 x 2 / 4) = 5, rounded up to 8; all ten pick
    # expert 0 first (the ninth and tenth are dropped), their second choices
    # spread over experts 1-3 (4, 3 and 3 tokens: all kept)
    topi = torch.tensor([[0, 1 + i % 3] for i in range(10)])
    keep = reference.kept_choices(topi, [(0, 10)], dims, sem)
    assert keep[:, 0].tolist() == [True] * 8 + [False] * 2
    assert keep[:, 1].all()
    # decode tokens (outside every group) keep all
    assert reference.kept_choices(topi, [], dims, sem).all()

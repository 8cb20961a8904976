"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed with the longest among them,
is run through the plain reference (:mod:`bench.harness.reference`), each
prompt with the tokens the program served.  Sampling is greedy, so each
served token should be the reference's best up to rounding: the number
compared is the widest gap, over every served token of the sample, by
which the served token's reference logit lies below the reference's best
logit at that position.  Its limit is the cell's (``bench/limits``).

Where single routing flips make the widest gap swing as far as the
control's (an MoE in bf16: a rounding at a top-k boundary reroutes a token
to another expert), the cell compares the mean gap over the served tokens
instead; the cell's limits file names the numbers it compares
(:data:`NUMBERS`).

The control puts the reference in the program's place one precision below
the configuration's bf16 (fp8 e4m3 operands, :func:`reference.matmul_fp8`)
and reads the same gap for the token it ranks first at each position.
"""

from __future__ import annotations

import dataclasses

import torch

from bench.harness import loadgen, reference


#: the numbers a cell may compare, by name: their keys in the readings
#: (the control's are ``control`` + the same suffix)
NUMBERS = {"widest_logit_gap": "program", "mean_logit_gap": "program_mean"}


@dataclasses.dataclass
class Sampled:
    prompt: list[int]
    served: list[int]


def pick(finished: list[Sampled], n: int, seed: int, min_tokens: int = 1) -> list[Sampled]:
    """The finished request with the most served tokens, then others drawn
    from the seed: ``n`` requests, and more until they hold ``min_tokens``
    served tokens (or none is left)."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: -len(finished[i].served))
    rest = loadgen.rng_for(seed, loadgen.STREAM_SAMPLE).permutation(order[1:]).tolist()
    out = [finished[order[0]]]
    for i in rest:
        if len(out) >= n and sum(len(r.served) for r in out) >= min_tokens:
            break
        out.append(finished[i])
    return out


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit for the
    chosen token."""
    return ref.max(dim=-1).values - ref.gather(1, chosen[:, None])[:, 0]


@torch.no_grad()
def gap_readings(params: dict, dims, sem: dict, sample: list[Sampled], device: torch.device,
                chunk: int | None, control: bool = False) -> dict:
    """The program's widest and mean gap over the sample's served tokens,
    the share of them that are not the reference's best, and (with
    ``control``) the same of the control's; with the count compared."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {"tokens": 0, "program": 0.0, "control": 0.0 if control else None}
        every = {"program": [], "control": []}  # each served position's gap
        for req in sample:
            ref = served_ref = reference.served_logits(
                params, dims, sem, req.prompt, req.served, device, chunk=chunk)
            served = torch.tensor(req.served, dtype=torch.long, device=device)
            every["program"].append(gaps(ref, served))
            out["tokens"] += len(req.served)
            if control:
                low = reference.served_logits(params, dims, sem, req.prompt, req.served, device,
                                              mm=reference.matmul_fp8, chunk=chunk)
                every["control"].append(gaps(served_ref, low.argmax(dim=-1)))
            del ref, served_ref
        for side, parts in every.items():
            if parts:
                g = torch.cat(parts)
                out[side] = float(g.max())
                out[f"{side}_mean"] = float(g.mean())
                out[f"{side}_mismatch"] = float((g > 0).float().mean())
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

#!/usr/bin/env python3
"""RMSNorm's backward kernel (``csrc/rmsnorm_bwd.cu``) under other launch
plans than ``kernels/rmsnorm.py:bwd_plan`` picks, on one H100: for each
shape of chip_smoke.py's phase 2, the device ms (CUDA graphs, cold L2, as
chip_smoke's ``Timer``) of the chosen plan and of others (tpr, nv, groups,
ctas, stages: 0 is the register double buffer), every result held to the
plain version's.

    PYTHONPATH=src python3 scripts/norm_bwd_plans.py

Prints one JSON line per (shape, plan) with the card's name and power limit
first.
"""

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as c
    from repro_torch.kernels import rmsnorm as rn

    print(c.nvidia_smi(), flush=True)
    timer = c.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = rn.bwd_plan
    for rows, d, dtype, form, plans in (
            (4096, 2048, torch.bfloat16, "plain",
             ((256, 1, 2, 264, 0), (256, 1, 2, 264, 2), (256, 1, 2, 264, 3))),
            (4096, 2048, torch.bfloat16, "add",
             ((256, 1, 2, 264, 0), (256, 1, 2, 264, 2), (256, 1, 2, 264, 3))),
            (4096, 2048, torch.float32, "add", ((256, 1, 2, 132, 0),)),
            (512, 100, torch.float32, "plain", ()),
            (4096, 512, torch.bfloat16, "plain", ((64, 1, 8, 264, 0),)),
            (4096, 7168, torch.bfloat16, "plain", ((448, 2, 1, 132, 0), (448, 2, 1, 132, 2))),
            (4096, 7168, torch.bfloat16, "add", ((448, 2, 1, 132, 0),))):
        x, dy, ds = (torch.randn((rows, d), generator=g, device="cuda").to(dtype)
                     for _ in range(3))
        ds = ds if form == "add" else None
        w = 1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")
        want_dx, want_dw = rn.rmsnorm_bwd_torch(x, dy, w, 1e-5, ds=ds)
        for plan in ((None,) + plans):
            rn.bwd_plan = chosen if plan is None else (
                lambda *a, plan=plan: rn.BwdPlan(*plan))
            run = lambda: rn.rmsnorm_bwd(x, dy, w, 1e-5, ds=ds)  # noqa: E731
            dx, dw = run()
            c.compare(torch, dx, want_dx, str(dtype).split(".")[1])
            c.compare(torch, dw, want_dw, "float32", c.NORM_DW_TOL)
            used = (chosen(rows, d, sms, x.element_size(), ds is not None) if plan is None
                    else rn.BwdPlan(*plan))
            print(json.dumps({"shape": [rows, d], "dtype": str(dtype), "form": form,
                              "plan": dataclasses.astuple(used), "chosen": plan is None,
                              "ms": timer.ms(run)}), flush=True)
        rn.bwd_plan = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quick check of the tensor-core kernels on one H100: build the library,
print ptxas's lines for flash_attention.cu and matmul.cu, hold the bf16 and
f32 flash kernels and the 3xTF32 matmul against their plain versions
(chip_smoke.py's tolerances) at the serving and offload shapes and a few
edges, and time the large cases with CUDA events (warm L2, 20 calls)
beside SDPA and ``torch.matmul``.  Matmul errors are also taken against an
f64 product, for the kernel and for cuBLAS.

    python3 scripts/check_tc_kernels.py

Ends with "ALL OK" or "SOME FAILED" (exit code 1).
"""

import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

FLASH_CASES = [  # B, H, KH, S, D, dtype, causal
    (1, 4, 2, 1, 64, torch.bfloat16, True), (1, 4, 1, 65, 32, torch.bfloat16, True),
    (1, 32, 8, 512, 64, torch.bfloat16, True), (1, 32, 8, 300, 64, torch.bfloat16, True),
    (2, 32, 32, 300, 112, torch.bfloat16, True), (1, 32, 32, 512, 112, torch.bfloat16, True),
    (1, 8, 8, 200, 64, torch.bfloat16, False), (1, 32, 8, 300, 64, torch.float32, True),
]
MATMUL_CASES = [  # M, N, K, block size
    (96, 160, 96, 32), (100, 128, 64, 4), (128, 128, 2048, 128), (2048, 2048, 2048, 128),
    (1024, 1024, 1024, 128),
]


def events_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("check_tc_kernels: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash_attention, flash_attention_torch
    from repro_torch.kernels.matmul import matmul, matmul_torch

    t0 = time.perf_counter()
    build.library()
    print("build seconds", time.perf_counter() - t0)
    for section in build.build_info["log"].split("== "):
        if section.startswith(("flash_attention", "matmul")):
            print("== " + "\n".join(
                line for line in section.splitlines()
                if "registers" in line or "spill" in line or "C7515" in line
                or line.startswith(("flash", "matmul"))))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ok = True
    for b, h, kh, s, d, dtype, causal in FLASH_CASES:
        try:
            q, k, v = randn(b, h, s, d, dtype=dtype), randn(b, kh, s, d, dtype=dtype), randn(b, kh, s, d, dtype=dtype)
            got = flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            want = flash_attention_torch(q, k, v, causal).float()
            atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
            err = (got.float() - want).abs()
            bad = bool((err > atol + rtol * want.abs()).any()) or not bool(torch.isfinite(got.float()).all())
            ok &= not bad
            row = {"case": [b, h, kh, s, d, str(dtype), causal], "max_err": float(err.max()), "bad": bad}
            if s >= 300:
                row["ms"] = events_ms(lambda: flash_attention(q, k, v, causal))
                row["sdpa_ms"] = events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True))
            print(json.dumps(row), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
    for m, n, k, blk in MATMUL_CASES:
        try:
            a, b = randn(m, k), randn(k, n)
            got = matmul(a, b, block_m=blk if m % blk == 0 else 4, block_n=blk, block_k=blk)
            torch.cuda.synchronize()
            want = matmul_torch(a, b)
            err = (got - want).abs()
            bad = bool((err > 1e-3 + 1e-4 * want.abs()).any()) or not bool(torch.isfinite(got).all())
            ok &= not bad
            f64 = a.double() @ b.double()
            row = {"case": [m, n, k, blk], "max_err": float(err.max()),
                   "err_vs_f64": float((got.double() - f64).abs().max()),
                   "cublas_err_vs_f64": float((want.double() - f64).abs().max()), "bad": bad}
            if m >= 1024:
                row["ms"] = events_ms(lambda: matmul(a, b))
                row["torch_ms"] = events_ms(lambda: torch.matmul(a, b))
            print(json.dumps(row), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
    print("ALL OK" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

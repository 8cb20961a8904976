#!/usr/bin/env python3
"""Quick check of the tensor-core kernels on one H100: build the library,
print ptxas's lines for flash_attention.cu, ssd_chunks.cu and the three
GEMM kernels (matmul.cu: matmul and the Schur update; complex_matmul.cu),
hold the SSD kernel's two routes against the plain version
(chip_smoke.SSD_TOL) with each output's error against an f64 computation
beside the plain version's, the flash kernel's two routes (f32, v's head
dim past 128, D past 256 and D % 8 != 0 on the CUDA cores; dv != d up to
qk 256 / v 128 on wgmma) and the three 3xTF32 GEMM kernels against their
plain versions (chip_smoke.py's tolerances) at the serving and offload
shapes, the flash backward's routes (bf16 up to qk 256 / v 128 on wgmma:
every instantiation of its dK / dV and dQ kernels, causal and not, a group
and ragged S; f32 on the CUDA cores) against its plain version, with
ptxas's registers and spills for each of the backward's wgmma kernels
(a spill or a C7515 warning, wgmma serialized, fails), ragged shapes whose N or K is not a multiple of 4 and a misaligned
operand view (both padded or copied by the wrappers for TMA), and time
the large cases with CUDA events (warm L2, 20 calls) beside SDPA and the
PyTorch call for the same function (``torch.matmul``, complex64
``torch.matmul``, ``torch.addmm(alpha=-1)``).  GEMM errors are also taken
against an f64 (complex128) product, for the kernel and for that call.

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
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

FLASH_CASES = [  # B, H, KH, S, D, Dv, dtype, causal
    (1, 4, 2, 1, 64, 64, torch.bfloat16, True), (1, 4, 1, 65, 32, 32, torch.bfloat16, True),
    (1, 32, 8, 512, 64, 64, torch.bfloat16, True), (1, 32, 8, 300, 64, 64, torch.bfloat16, True),
    (2, 32, 32, 300, 112, 112, torch.bfloat16, True), (1, 32, 32, 512, 112, 112, torch.bfloat16, True),
    (1, 8, 8, 200, 64, 64, torch.bfloat16, False), (1, 32, 8, 300, 64, 64, torch.float32, True),
    # dv != d (f32 on the CUDA cores, bf16 on wgmma up to qk 256 / v 128), D
    # past 256, a D not a multiple of 8 (the CUDA cores)
    (1, 4, 4, 128, 48, 32, torch.float32, True), (1, 4, 2, 128, 48, 32, torch.bfloat16, True),
    (1, 128, 128, 512, 192, 128, torch.bfloat16, True), (1, 8, 8, 300, 100, 100, torch.bfloat16, True),
    (1, 4, 4, 70, 512, 512, torch.bfloat16, True), (1, 2, 1, 33, 7, 200, torch.float32, False),
]
SSD_CASES = [  # B, S, H, P, N, L, dtype
    (1, 512, 80, 64, 128, 128, torch.bfloat16), (1, 97, 80, 64, 128, 97, torch.bfloat16),
    (1, 512, 112, 64, 64, 128, torch.bfloat16), (1, 512, 80, 64, 128, 256, torch.bfloat16),
    (1, 512, 8, 128, 256, 128, torch.bfloat16), (2, 96, 3, 12, 20, 48, torch.bfloat16),
    (1, 1024, 4, 64, 128, 1024, torch.bfloat16), (1, 512, 80, 64, 128, 256, torch.float32),
    (1, 97, 80, 64, 128, 97, torch.float32), (2, 96, 3, 12, 20, 48, torch.float32),
    (1, 512, 8, 128, 256, 128, torch.float32),
]
FLASH_BWD_CASES = [  # B, H, KH, S, D, Dv, dtype, causal: <NK, NV> noted
    (1, 32, 8, 512, 64, 64, torch.bfloat16, True),  # <1,1>, llama's train shape
    (1, 56, 8, 512, 128, 128, torch.bfloat16, True),  # <2,2>, arctic's
    (1, 128, 128, 512, 192, 128, torch.bfloat16, True),  # <3,2>, deepseek-v2's
    (2, 8, 4, 300, 192, 64, torch.bfloat16, True),  # <3,1>
    (1, 16, 4, 300, 256, 128, torch.bfloat16, True),  # <4,2>
    (1, 8, 2, 200, 256, 64, torch.bfloat16, True),  # <4,1>
    (1, 4, 4, 100, 200, 128, torch.bfloat16, True),  # <4,2> zero-filled past 200
    (1, 8, 8, 256, 192, 128, torch.bfloat16, False),  # <3,2>, every query block
    (1, 8, 8, 300, 192, 128, torch.float32, True),  # the CUDA cores' 32-row tiles
]
GEMM_CASES = [  # kernel, (M, N, K), (block_m, block_n, block_k), misaligned A view
    ("matmul", (96, 160, 96), (32, 32, 32), False), ("matmul", (100, 128, 64), (4, 128, 64), False),
    ("matmul", (128, 128, 2048), (128, 128, 128), False), ("matmul", (99, 99, 99), (99, 99, 99), False),
    ("matmul", (128, 128, 128), (128, 128, 128), True), ("matmul", (2048, 2048, 2048), (128, 128, 128), False),
    ("schur_update", (160, 160, 32), (32, 32, 32), False), ("schur_update", (100, 100, 30), (100, 100, 30), False),
    ("schur_update", (128, 256, 64), (128, 128, 64), True),
    ("schur_update", (1920, 1920, 128), (128, 128, 128), False),
    ("complex_matmul", (99, 99, 99), (99, 99, 99), False), ("complex_matmul", (256, 128, 64), (128, 128, 64), True),
    ("complex_matmul", (2048, 2048, 2048), (128, 128, 128), False),
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


def _ssd_f64(x, dt, a, bm, cm, chunk):
    """The chunk terms in f64 from the same inputs."""
    from repro_torch.kernels.ssd import ssd_chunks_torch

    return ssd_chunks_torch(x, dt, a, bm, cm, chunk=chunk, dtype=torch.float64)


def check_ssd(randn, gen) -> bool:
    """The SSD kernel's two routes against the plain version at
    chip_smoke.SSD_TOL, each output's error against an f64 computation
    beside the plain version's, and event times of the large cases."""
    import chip_smoke
    from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_torch

    ok = True
    names = ("y", "states", "cumdecay", "totals")
    for b, s, h, p, n, chunk, dtype in SSD_CASES:
        try:
            x, bm, cm = randn(b, s, h, p, dtype=dtype), randn(b, s, n, dtype=dtype), randn(b, s, n, dtype=dtype)
            dt = 1e-3 + (0.1 - 1e-3) * torch.rand((b, s, h), generator=gen, device="cuda")
            a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device="cuda"))
            got = ssd_chunks(x, dt, a, bm, cm, chunk=chunk)
            torch.cuda.synchronize()
            plain = ssd_chunks_torch(x, dt, a, bm, cm, chunk=chunk)
            f64 = _ssd_f64(x, dt, a, bm, cm, chunk)
            row = {"ssd": [b, s, h, p, n, chunk, str(dtype)], "err": {}, "plain_err_vs_f64": {}}
            for name, g, w, r in zip(names, got, plain, f64):
                atol, rtol = chip_smoke.SSD_TOL[name]
                bad = not bool(torch.isfinite(g).all()) or g.shape != w.shape or bool(
                    ((g - w).abs() > atol + rtol * w.abs()).any())
                ok &= not bad
                row["err"][name] = [float((g - w).abs().max()), float((g.double() - r).abs().max()),
                                    "BAD" if bad else "ok"]
                row["plain_err_vs_f64"][name] = float((w.double() - r).abs().max())
            if s >= 512 and h >= 80:
                row["ms"] = events_ms(lambda: ssd_chunks(x, dt, a, bm, cm, chunk=chunk))
                row["plain_ms"] = events_ms(lambda: ssd_chunks_torch(x, dt, a, bm, cm, chunk=chunk))
            print(json.dumps(row), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
    return ok


def check_bwd_ptxas(log: str) -> bool:
    """ptxas's registers and spills of every wgmma kernel of the flash
    backward (``flash_bwd_*``); False on a spill or a C7515 warning."""
    ok, fn, rows = True, None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "C7515" in line and "flash_bwd" in line + (fn or ""):
            ok = False
            print("BAD", line.strip()[:300])
        if fn is None or "flash_bwd" not in fn:
            continue
        name = fn[fn.find("flash_bwd"):][:40]
        if "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            rows.setdefault(name, {})["spill_bytes"] = nums[1:3]
            ok &= not any(nums[1:3])
        elif "Used" in line and "registers" in line:
            rows.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
    print(json.dumps({"flash_bwd_ptxas": rows}), flush=True)
    return ok and bool(rows)


def check_flash_bwd(randn) -> bool:
    """The flash backward against its plain version at FLASH_BWD_CASES,
    the route each took, two calls bit-identical, and event times beside
    SDPA's backward (through autograd) where S >= 300."""
    import chip_smoke
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels.attention_chunked import flash_attention_bwd_torch

    ok = True
    for b, h, kh, s, d, dv, dtype, causal in FLASH_BWD_CASES:
        try:
            q, k = randn(b, h, s, d, dtype=dtype), randn(b, kh, s, d, dtype=dtype)
            v, do = randn(b, kh, s, dv, dtype=dtype), randn(b, h, s, dv, dtype=dtype)
            out, lse = fa._flash_cuda(q, k, v, causal, with_lse=True)
            args = (q, k, v, out, lse, do, causal)
            before = dict(fa.flash_attention_bwd.routes)
            got = fa.flash_attention_bwd(*args)
            again = fa.flash_attention_bwd(*args)
            torch.cuda.synchronize()
            (route,) = [r for r, n in fa.flash_attention_bwd.routes.items() if n > before[r]]
            want = flash_attention_bwd_torch(*args)
            atol, rtol = chip_smoke.TOL[str(dtype).split(".")[1]]
            row = {"bwd_case": [b, h, kh, s, d, dv, str(dtype), causal], "route": route,
                   "repeat_bit_identical": all(torch.equal(x, y) for x, y in zip(got, again))}
            bad = not row["repeat_bit_identical"]
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs()
                bad |= bool((err > atol + rtol * w.float().abs()).any())
                bad |= not bool(torch.isfinite(g.float()).all())
                row[f"{name}_err"] = float(err.max())
            row["bad"] = bad
            ok &= not bad
            if s >= 300:
                row["ms"] = events_ms(lambda: fa.flash_attention_bwd(*args))
                ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
                lib = torch.nn.functional.scaled_dot_product_attention(
                    ql, kl, vl, is_causal=causal, enable_gqa=kh != h)
                row["sdpa_bwd_ms"] = events_ms(lambda: torch.autograd.grad(
                    lib, (ql, kl, vl), do, retain_graph=True))
            print(json.dumps(row), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("check_tc_kernels: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash_attention, flash_attention_torch
    from repro_torch.kernels import fft, matmul

    t0 = time.perf_counter()
    build.library()
    print("build seconds", time.perf_counter() - t0)
    for section in build.build_info["log"].split("== "):
        if section.startswith(("flash_attention", "matmul", "complex_matmul", "ssd_chunks")):
            print("== " + "\n".join(
                line for line in section.splitlines()
                if "Used" in line or "spill" in line or "C7515" in line
                or "Compiling entry function" in line
                or line.startswith(("flash", "matmul", "complex_matmul", "ssd"))))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ok = check_bwd_ptxas(build.build_info["log"])
    ok &= check_flash_bwd(randn)
    for b, h, kh, s, d, dv, dtype, causal in FLASH_CASES:
        try:
            q, k, v = randn(b, h, s, d, dtype=dtype), randn(b, kh, s, d, dtype=dtype), randn(b, kh, s, dv, dtype=dtype)
            before = dict(flash_attention.routes)
            got = flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            (route,) = [r for r, n in flash_attention.routes.items() if n > before[r]]
            want = flash_attention_torch(q, k, v, causal).float()
            atol, rtol = (2e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
            err = (got.float() - want).abs()
            bad = bool((err > atol + rtol * want.abs()).any()) or not bool(torch.isfinite(got.float()).all())
            bad |= tuple(got.shape) != (b, h, s, dv)
            ok &= not bad
            row = {"case": [b, h, kh, s, d, dv, str(dtype), causal], "route": route,
                   "shape": list(got.shape), "max_err": float(err.max()), "bad": bad}
            if s >= 300:
                row["ms"] = events_ms(lambda: flash_attention(q, k, v, causal))
                row["sdpa_ms"] = events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True))
            print(json.dumps(row), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
    for name, (m, n, k), (bm, bn, bk), misaligned in GEMM_CASES:
        try:
            kw = dict(block_m=bm, block_n=bn, block_k=bk)
            a, b, a2, b2, c = randn(m, k), randn(k, n), randn(m, k), randn(k, n), randn(m, n)
            if misaligned:  # a contiguous view 4 bytes past a 16-byte boundary
                a = torch.cat([torch.zeros(1, device="cuda"), a.flatten()])[1:].view(m, k)
            if name == "matmul":
                run = lambda: matmul.matmul(a, b, **kw)  # noqa: E731
                want, lib = matmul.matmul_torch(a, b), lambda: torch.matmul(a, b)  # noqa: E731
                f64 = a.double() @ b.double()
            elif name == "schur_update":
                run = lambda: matmul.schur_update(c, a, b, **kw)  # noqa: E731
                want, lib = matmul.schur_update_torch(c, a, b), lambda: torch.addmm(c, a, b, alpha=-1)  # noqa: E731
                f64 = c.double() - a.double() @ b.double()
            else:
                ac, bc = torch.complex(a, a2), torch.complex(b, b2)
                run = lambda: torch.cat(fft.complex_matmul(a, a2, b, b2, **kw))  # noqa: E731
                want = torch.cat(fft.complex_matmul_torch(a, a2, b, b2))
                lib = lambda: torch.matmul(ac, bc)  # noqa: E731
                z = ac.to(torch.complex128) @ bc.to(torch.complex128)
                f64 = torch.cat([z.real, z.imag])
            got = run()
            torch.cuda.synchronize()
            libout = lib()
            if libout.is_complex():
                libout = torch.cat([libout.real, libout.imag])
            err = (got - want).abs()
            bad = bool((err > 1e-3 + 1e-4 * want.abs()).any()) or not bool(torch.isfinite(got).all())
            ok &= not bad
            row = {"kernel": name, "case": [m, n, k], "blocks": [bm, bn, bk], "misaligned": misaligned,
                   "max_err": float(err.max()),
                   "err_vs_f64": float((got.double() - f64).abs().max()),
                   "library_err_vs_f64": float((libout.double() - f64).abs().max()), "bad": bad}
            if m >= 1024:
                row["ms"] = events_ms(run)
                row["library_ms"] = events_ms(lib)
            print(json.dumps(row), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
    ok &= check_ssd(randn, gen)
    print("ALL OK" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

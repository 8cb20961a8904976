"""Matmul-DFT 2-D FFT: the complex-matmul CUDA kernel's wrapper
(``csrc/complex_matmul.cu``, the port of ``repro/kernels/fft.py``'s
``complex_matmul_pallas``: 3xTF32 on the tensor cores, on the GEMM body
the matmul kernels share, each CTA one tile of one output plane), its
plain version, and the two-stage ``fft2d_dft`` that chains it as
``fft2d_pallas`` does:

    2-D FFT:  Y = X @ F_m (rows), then Z = (Y^T @ F_n)^T (columns)

with F the symmetric DFT matrix and complex numbers carried as separate
f32 real/imaginary planes (4 real products per stage).  The DFT matrix is
O(n^2) per vector where cuFFT's butterflies are O(n log n); the point of
the block is that it is one dense product per stage.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import check_tiles, tma_operands


def dft_matrix(n: int, sign: float = -1.0) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the n-point DFT matrix F[k,j] = exp(sign*2pi i kj/n)."""
    k = np.arange(n)
    angles = sign * 2.0 * np.pi * np.outer(k, k) / n
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_planes(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``dft_matrix(n)`` on ``device``, made once per (n, device) — the
    reference's jit bakes it in as a constant at trace time."""
    fr, fi = dft_matrix(n)
    return torch.from_numpy(fr).to(device), torch.from_numpy(fi).to(device)


def complex_matmul_torch(ar, ai, br, bi, **_blocks) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the same four real products in f32."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def complex_matmul_work(m: int, n: int, k: int) -> build.Work:
    """(M, K) @ (K, N) complex as f32 planes: the four input planes read
    once, the two output planes written once; four real products, 8 M N K
    FLOPs, each product three TF32 passes (3xTF32)."""
    return build.Work(8 * m * n * k, 4 * (2 * m * k + 2 * k * n + 2 * m * n), "tf32", passes=3)


def complex_matmul(
    ar: torch.Tensor,
    ai: torch.Tensor,
    br: torch.Tensor,
    bi: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(ar + i ai) @ (br + i bi) -> (real, imag), f32 planes (M,K) @ (K,N)."""
    m, k = ar.shape
    k2, n = br.shape
    if ai.shape != ar.shape or bi.shape != br.shape or k != k2:
        raise ValueError(
            f"complex_matmul: planes {tuple(ar.shape)}/{tuple(ai.shape)} @ "
            f"{tuple(br.shape)}/{tuple(bi.shape)} do not match"
        )
    check_tiles(m, n, k, block_m, block_n, block_k)
    if ar.device.type == "cpu":
        return complex_matmul_torch(ar, ai, br, bi)
    build.refuse_grad("complex_matmul", "fft2d", ar, ai, br, bi)
    build.check_cuda("complex_matmul", ar, ai, br, bi)
    build.check_float32("complex_matmul", ar, ai, br, bi)
    (ar, ai), (br, bi), _ = tma_operands([ar, ai], [br, bi])
    k4, n4 = br.shape
    out_r = torch.empty((m, n4), dtype=torch.float32, device=ar.device)
    out_i = torch.empty_like(out_r)
    if m and n and not build.skip_launch("complex_matmul", ar,
                                         work=lambda: complex_matmul_work(m, n, k)):
        build.launch(
            "repro_complex_matmul", ar.data_ptr(), ai.data_ptr(), br.data_ptr(),
            bi.data_ptr(), out_r.data_ptr(), out_i.data_ptr(), m, n4, k4,
            build.stream_of(ar),
        )
        complex_matmul.launches += 1
    if n4 != n:
        out_r, out_i = out_r[:, :n].contiguous(), out_i[:, :n].contiguous()
    return out_r, out_i


complex_matmul.launches = 0


def fft2d_dft(
    x: torch.Tensor,
    *,
    cmm: Callable[..., tuple[torch.Tensor, torch.Tensor]] = complex_matmul,
    block: int = 128,
) -> torch.Tensor:
    """2-D FFT of a complex (n, m) tensor via two DFT matmul stages, the
    stage product being ``cmm`` (the kernel's wrapper, or its plain
    version)."""
    n, m = x.shape
    xr = x.real.float().contiguous()
    xi = x.imag.float().contiguous()
    # a trace's planes are fake tensors: made anew, never cached
    planes = _dft_planes.__wrapped__ if build.is_abstract(x) else _dft_planes
    fr_m, fi_m = planes(m, x.device)
    # rows: X @ F_m  (F symmetric)
    yr, yi = cmm(
        xr, xi, fr_m, fi_m,
        block_m=min(block, n), block_n=min(block, m), block_k=min(block, m),
    )
    fr_n, fi_n = planes(n, x.device)
    # columns: F_n @ Y == (Y^T @ F_n)^T
    zr, zi = cmm(
        yr.T.contiguous(), yi.T.contiguous(), fr_n, fi_n,
        block_m=min(block, m), block_n=min(block, n), block_k=min(block, n),
    )
    return torch.complex(zr.T, zi.T).to(torch.complex64)

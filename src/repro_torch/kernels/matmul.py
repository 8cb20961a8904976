"""Blocked matmul and the fused LU trailing update: the CUDA kernels'
wrappers (``csrc/matmul.cu``, the port of ``repro/kernels/matmul.py``'s
``matmul_pallas`` and ``schur_update_pallas``), their plain versions, and
the operand padding of the three TMA GEMM kernels (these two and
``fft.complex_matmul``).

``block_m/block_n/block_k`` keep the reference's tiling contract: shapes
that do not divide by them raise ``ValueError``, on every device, and the
interface adapter pads first.  The CUDA kernels (3xTF32 on the tensor
cores, loaded by TMA, one body in ``csrc/tf32_gemm.cuh``) tile the output
by their own 128 x 128 and mask the ragged edge, so any block sizes that
pass the contract run.  They take float32 only.  TMA also needs N and K
that are multiples of 4 and 16-byte aligned operands: ``tma_operands``
zero-pads and copies what is not, and the wrapper slices the padded
columns off the output.

A wrapper runs the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

from repro_torch.kernels.ref import matmul_ref, schur_update_ref


# the plain versions are the oracles themselves, as the reference registers
# ref.matmul_ref for both its "ref" and "xla" targets; they take (and
# ignore) the block sizes so callers can swap them for the wrappers
def matmul_torch(a: torch.Tensor, b: torch.Tensor, **_blocks: int) -> torch.Tensor:
    return matmul_ref(a, b)


def schur_update_torch(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, **_blocks: int) -> torch.Tensor:
    return schur_update_ref(c, a, b)


def check_tiles(m: int, n: int, k: int, block_m: int, block_n: int, block_k: int) -> None:
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"shapes ({m},{k})x({k},{n}) must tile by "
            f"({block_m},{block_n},{block_k}); pad first (interface adapter "
            "handles this)"
        )


def tma_operands(
    a_planes: list[torch.Tensor],
    b_planes: list[torch.Tensor],
    c: torch.Tensor | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor], torch.Tensor | None]:
    """The A planes (M, K), B planes (K, N) and C (M, N) of a TMA GEMM
    kernel through :func:`build.tma_operand`: K and N zero-padded to
    multiples of 4 (TMA's 16-byte row strides), misaligned operands copied.
    The caller slices the padded columns off the output."""
    m, k = a_planes[0].shape
    n = b_planes[0].shape[1]
    k4, n4 = -(-k // 4) * 4, -(-n // 4) * 4
    return (
        [build.tma_operand(a, (m, k4)) for a in a_planes],
        [build.tma_operand(b, (k4, n4)) for b in b_planes],
        None if c is None else build.tma_operand(c, (m, n4)),
    )


def matmul_work(m: int, n: int, k: int) -> build.Work:
    """(M, K) @ (K, N) in f32: A and B read once, C written once; 2 M N K
    FLOPs, each product three TF32 passes (3xTF32)."""
    return build.Work(2 * m * n * k, 4 * (m * k + k * n + m * n), "tf32", passes=3)


def schur_work(m: int, n: int, k: int) -> build.Work:
    """C - A @ B in f32: C, A and B read once, the result written once."""
    return build.Work(2 * m * n * k, 4 * (2 * m * n + m * k + k * n), "tf32", passes=3)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), f32 accumulation."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    check_tiles(m, n, k, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return matmul_torch(a, b)
    build.refuse_grad("matmul", "matmul", a, b)
    build.check_cuda("matmul", a, b)
    build.check_float32("matmul", a, b)
    (a,), (b,), _ = tma_operands([a], [b])
    k4, n4 = b.shape
    out = torch.empty((m, n4), dtype=torch.float32, device=a.device)
    if m and n and not build.skip_launch("matmul", a, work=lambda: matmul_work(m, n, k)):
        build.launch(
            "repro_matmul", a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n4, k4,
            build.stream_of(a),
        )
        matmul.launches += 1
    return out if n4 == n else out[:, :n].contiguous()


def schur_update(
    c: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Fused C - A @ B: C is read once, in the epilogue, and the result
    written once (the HBM round trip of C that matmul-then-subtract pays)."""
    m, k = a.shape
    k2, n = b.shape
    if c.shape != (m, n):
        raise ValueError(f"c shape {tuple(c.shape)} != ({m},{n})")
    if k != k2:
        raise ValueError(f"contraction mismatch {k} vs {k2}")
    if m % block_m or n % block_n or k % block_k:
        raise ValueError("shapes must tile by the block sizes; pad first")
    if c.device.type == "cpu":
        return schur_update_torch(c, a, b)
    build.refuse_grad("schur_update", "lu", c, a, b)
    build.check_cuda("schur_update", c, a, b)
    build.check_float32("schur_update", c, a, b)
    (a,), (b,), c = tma_operands([a], [b], c)
    k4, n4 = b.shape
    out = torch.empty_like(c)
    if m and n and not build.skip_launch("schur_update", c, work=lambda: schur_work(m, n, k)):
        build.launch(
            "repro_schur_update", c.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), m, n4, k4, build.stream_of(c),
        )
        schur_update.launches += 1
    return out if n4 == n else out[:, :n].contiguous()


matmul.launches = 0
schur_update.launches = 0

"""RMSNorm: the CUDA kernel's wrapper (``csrc/rmsnorm.cu``, the port of
``repro/kernels/rmsnorm.py``'s ``rmsnorm_pallas``) and its plain version.

The wrapper runs the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

# the plain version is the oracle itself, as the reference registers
# ref.rmsnorm_ref for both its "ref" and "xla" targets
from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm_torch  # noqa: F401


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) float32/bfloat16, w (d,) float32 -> x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_torch(x, w, eps)
    build.check_cuda("rmsnorm", x, w)
    d = x.shape[-1]
    if w.dtype != torch.float32 or w.shape != (d,):
        raise ValueError(
            f"rmsnorm: w must be float32 ({d},), got {w.dtype} {tuple(w.shape)}"
        )
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    build.launch(
        "repro_rmsnorm", x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
        eps, build.dtype_code(x), build.stream_of(x),
    )
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0

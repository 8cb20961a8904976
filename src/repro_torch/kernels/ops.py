"""Public wrappers for the kernel shelf, with device dispatch (the port of
``repro/kernels/ops.py``: the offload pipeline's ``matmul``,
``schur_update``, ``fft2d``, ``lu`` and ``lu_nr_compat``, and the SSM
path's ``ssd_scan``).

Every wrapper takes tensors or array-likes.  Array-likes (the host
program's numpy arrays) move to ``device`` — the CUDA card unless the
caller passes ``device="cpu"`` — after the reference's canonicalisation
with x64 off: float64 becomes float32 and complex128 complex64.  Without a
card, ``device="cuda"`` raises; nothing falls back to the CPU.

``backend`` picks the formulation, as the reference's does between
``pallas`` and ``xla``: ``"cuda"`` runs the hand-written kernels (their
wrappers take the plain version only for CPU tensors), ``"torch"`` the
plain versions, ``"ref"`` the oracle.  Unset, it is ``"cuda"`` for CUDA
tensors and ``"torch"`` for CPU tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fft import complex_matmul, complex_matmul_torch, dft_matrix, fft2d_dft
from repro_torch.kernels.lu import lu_blocked, lu_program
from repro_torch.kernels.matmul import matmul as _matmul_kernel
from repro_torch.kernels.matmul import matmul_torch, schur_update as _schur_kernel
from repro_torch.kernels.matmul import schur_update_torch
from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_torch

BACKENDS = ("ref", "torch", "cuda")

#: the reference's dtype canonicalisation with x64 off
_CANONICAL = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
}


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """The offload device: CUDA unless ``"cpu"`` is asked for; CUDA
    without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch offloads to the CUDA card; "
            "pass device='cpu' to run the blocks' plain versions on the CPU"
        )
    return device


def as_tensor(x: Any, device: "torch.device | str | None" = None) -> torch.Tensor:
    """A tensor of ``x``: tensors stay where they are unless ``device``
    is given; anything else is canonicalised (x64 off) and moved to
    ``device`` (CUDA by default)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    arr = np.asarray(x)
    arr = arr.astype(_CANONICAL.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.asarray(arr, order="C")).to(resolve_device(device))


def _backend(backend: str | None, t: torch.Tensor) -> str:
    if backend is None:
        return "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend '{backend}'; known: {BACKENDS}")
    return backend


# -- matmul (cuBLAS analogue) --------------------------------------------------


def matmul(a, b, *, backend: str | None = None, device=None):
    a = as_tensor(a, device)
    b = as_tensor(b, a.device)
    be = _backend(backend, a)
    if be == "cuda":
        return _matmul_kernel(a, b)
    return matmul_torch(a, b) if be == "torch" else _ref.matmul_ref(a, b)


def schur_update(c, a, b, *, backend: str | None = None, device=None):
    c = as_tensor(c, device)
    a, b = as_tensor(a, c.device), as_tensor(b, c.device)
    be = _backend(backend, c)
    if be == "cuda":
        return _schur_kernel(c, a, b)
    fn = schur_update_torch if be == "torch" else _ref.schur_update_ref
    return fn(c, a, b)


# -- fft2d (cuFFT analogue) ----------------------------------------------------


def fft2d(x, *, backend: str | None = None, variant: str = "direct", device=None):
    """2-D complex FFT.  cuda/torch: matmul-DFT stages (the kernel or its
    plain version); ref: ``torch.fft.fft2``."""
    x = as_tensor(x, device)
    if not x.is_complex():
        x = x.to(torch.complex64)
    be = _backend(backend, x)
    if be == "ref":
        return _ref.fft2d_ref(x)
    if variant == "four-step":
        return _fft2d_four_step(x)
    cmm = complex_matmul if be == "cuda" else complex_matmul_torch
    return fft2d_dft(x.to(torch.complex64), cmm=cmm)


def _fft1d_four_step_axis1(x: torch.Tensor) -> torch.Tensor:
    """Four-step FFT along the last axis via two DFT stages (the
    reference's einsum formulation, which reaches no Pallas kernel).

    n = n1*n2:  X (rows, n) -> reshape (rows, n1, n2)
      1) DFT_n1 along axis1, 2) twiddle w^{k1*j2}, 3) DFT_n2 along axis2,
      4) transpose (k2, k1) -> index k2*n1 + k1.
    """
    rows, n = x.shape
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    dev = x.device

    def dft(k: int) -> torch.Tensor:
        fr, fi = dft_matrix(k)
        return torch.complex(torch.from_numpy(fr), torch.from_numpy(fi)).to(dev, x.dtype)

    y = torch.einsum("ab,rbc->rac", dft(n1), x.reshape(rows, n1, n2))
    k1 = torch.arange(n1, device=dev)[:, None]
    j2 = torch.arange(n2, device=dev)[None, :]
    tw = torch.exp(-2j * torch.pi * (k1 * j2) / n).to(x.dtype)
    z = torch.einsum("rac,cd->rad", y * tw[None], dft(n2))
    return z.permute(0, 2, 1).reshape(rows, n)


def _fft2d_four_step(x: torch.Tensor) -> torch.Tensor:
    y = _fft1d_four_step_axis1(x)
    y = _fft1d_four_step_axis1(y.T.contiguous()).T
    return y.to(torch.complex64)


# -- LU (cuSOLVER getrf analogue) ----------------------------------------------


def lu(a, *, nb: int | None = None, backend: str | None = None, device=None):
    """Blocked LU with partial pivoting.  Returns (lu_packed, piv).

    Arbitrary n: pads to a multiple of nb with an identity extension (pad
    rows can never be chosen as pivots for real columns).  The default
    block size adapts to the problem: small matrices are panel-dominated
    and want small blocks; large ones 128-wide panels.  On the card the
    factorisation runs as one captured program per (n, nb, trailing
    update) (:func:`repro_torch.kernels.lu.lu_program`, the reference's
    jitted ``lu_blocked``), the padding in its static input; on the CPU,
    and under a trace (fake tensors), ``lu_blocked`` runs eagerly.
    """
    a = as_tensor(a, device).to(torch.float32)
    n = a.shape[0]
    if nb is None:
        nb = 128 if n >= 512 else 32
    be = _backend(backend, a)
    if be == "ref":
        raise ValueError("lu has no 'ref' backend; use 'torch' or 'cuda'")
    schur = _schur_kernel if be == "cuda" else schur_update_torch
    if a.is_cuda and not build.is_abstract(a):
        lu_p, piv, _parity = lu_program(a, nb=nb, schur=schur)
        return lu_p, piv
    npad = ((n + nb - 1) // nb) * nb
    if npad != n:
        ap = torch.eye(npad, dtype=torch.float32, device=a.device)
        ap[:n, :n] = a
    else:
        ap = a
    lu_p, piv, _parity = lu_blocked(ap, nb=nb, n_real=n, schur=schur)
    return lu_p[:n, :n], piv[:n]


def lu_nr_compat(a, *, backend: str | None = None, device=None):
    """Numerical-Recipes-shaped interface: returns (lu, indx, d).

    This is the DB-registered replacement for ``ludcmp`` — C-1 glue that
    matches the host program's expected (lu, indx, d) signature.  ``d``
    (the swaps' parity) is computed on the device: nothing here waits for
    the card.
    """
    lu_p, piv = lu(a, backend=backend, device=device)
    n = piv.shape[0]
    swaps = (piv != torch.arange(n, dtype=piv.dtype, device=piv.device)).sum()
    d = torch.where(swaps % 2 == 0, 1.0, -1.0).to(torch.float32)
    return lu_p, piv.to(torch.int32), d


# on CUDA a new (n, nb, trailing update) runs its program's eager call,
# then its capture (``runtime.programs.Captures.WARMUP_CALLS``)
lu.warmup_calls = lu_nr_compat.warmup_calls = 2


# -- Mamba-2 SSD scan ------------------------------------------------------------


def _ssd_combine(y_intra, states, cumdecay, totals, cmat, h0, chunk: int):
    """The O(S / L) scan across chunks: the state entering each chunk
    (a Python loop in place of the reference's ``lax.scan``), its read-out
    ``C h`` decayed by ``cumdecay``, added to the intra-chunk output."""
    b, nc, h, n, p = states.shape
    s = nc * chunk
    hprev = (
        torch.zeros((b, h, n, p), dtype=torch.float32, device=states.device)
        if h0 is None else h0.float()
    )
    henter = []
    for c in range(nc):
        henter.append(hprev)
        hprev = hprev * totals[:, c, :, None, None] + states[:, c]
    c_chunks = cmat.float().reshape(b, nc, chunk, n)
    y_inter = torch.einsum("bcln,bchnp->bclhp", c_chunks, torch.stack(henter, dim=1))
    y_inter = y_inter * cumdecay.reshape(b, nc, chunk, h)[..., None]
    return y_intra + y_inter.reshape(b, s, h, p), hprev


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 128, h0=None, backend: str | None = None):
    """Chunked SSD selective scan.  Returns (y (B, S, H, P), final state
    (B, H, N, P)), both f32.  ``backend``: ``cuda`` (the chunk kernel),
    ``torch`` (its plain version), ``ref`` (the sequential oracle)."""
    be = _backend(backend, x)
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        # pad with dt=0 steps: decay exp(0)=1 and update dt*B*x=0, so the
        # final state is untouched; padded outputs are sliced away.
        pad = chunk - s % chunk
        y, hfin = ssd_scan(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
            F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad)),
            chunk=chunk, h0=h0, backend=backend,
        )
        return y[:, :s], hfin
    if be == "ref":
        return _ref.ssd_ref(x, dt, a, bmat, cmat, h0=h0)
    chunks = ssd_chunks if be == "cuda" else ssd_chunks_torch
    y_i, states, cumdecay, totals = chunks(x, dt, a, bmat, cmat, chunk=chunk)
    return _ssd_combine(y_i, states, cumdecay, totals, cmat, h0, chunk)

"""Blocked right-looking LU with partial pivoting (the port of
``repro/kernels/lu.py``'s ``lu_blocked``) — the cuSOLVER-getrf analogue
for the matrix-calculation application.

    for each column block kb:
        1. panel factorisation (rank-1 updates inside the panel, pivoting
           over the whole column) — latency-bound, plain torch;
        2. the panel's row swaps applied to the rest of the matrix;
        3. triangular solve U12 = L11^-1 A12 — plain torch;
        4. trailing update A22 -= L21 @ U12 (the FLOPs: >2/3 of n^3) — the
           ``schur_update`` block: the CUDA kernel for CUDA tensors.

The reference's ``fori_loop``s are Python loops over device tensors: the
pivot row is found, swapped and eliminated on the device.  The swap
sequence of a panel is applied to a device index vector (the reference's
``_apply_swaps``) and then to the columns outside the panel as one gather,
so nothing in ``lu_blocked`` reads the device from the host: it can be
captured.  The reference jits the whole of it; :func:`lu_program` runs it
per (n, nb, trailing update, device) as one captured program
(:mod:`repro_torch.runtime.programs`), the input in a static buffer whose
padding is the identity.

Pivot bookkeeping matches Numerical Recipes' ``indx`` convention (imax
per step, rows swapped in place) so the NR back-substitution consumes the
result unchanged; pad rows use an identity extension and can never be
selected as pivots for real columns.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.matmul import schur_update


def _panel_factor(panel: torch.Tensor, n_real_rows: int):
    """Unblocked LU of a (rows x nb) panel, pivoting over all rows.

    Returns (panel, piv, parity): piv[j] = row swapped with j at step j
    (panel-relative), NR semantics.  ``panel`` is updated in place.
    """
    rows, nb = panel.shape
    dev = panel.device
    ridx = torch.arange(rows, device=dev)
    cidx = torch.arange(nb, device=dev)
    # eligible pivots: at/below the diagonal, and never a pad row for a
    # real column (pad rows may only pivot for their own pad column)
    real = ridx < n_real_rows
    # constants as Python scalars: a host tensor copied to the card would
    # be a pageable copy, which a capture refuses
    piv = torch.zeros(nb, dtype=torch.int32, device=dev)
    parity = torch.ones((), dtype=panel.dtype, device=dev)
    for j in range(nb):
        eligible = (ridx >= j) & (real | (ridx == j))
        score = torch.where(eligible, panel[:, j].abs(), float("-inf"))
        imax = torch.argmax(score).view(1)  # stays on the device: no sync
        rj = panel[j:j + 1].clone()
        panel[j:j + 1] = panel.index_select(0, imax)
        panel.index_copy_(0, imax, rj)
        piv[j] = imax[0]
        parity = torch.where(imax[0] != j, -parity, parity)
        pivval = panel[j, j]
        pivval = torch.where(pivval == 0.0, 1.0e-20, pivval)
        panel[j, j] = pivval
        below = ridx > j
        fac = torch.where(below, panel[:, j] / pivval, 0.0)
        urow = torch.where(cidx > j, panel[j], 0.0)
        panel.sub_(torch.outer(fac, urow))
        panel[:, j] = torch.where(below, fac, panel[:, j])
    return panel, piv, parity


def _swap_permutation(piv: torch.Tensor, rows: int) -> torch.Tensor:
    """Row order after the NR swap sequence (row j <-> piv[j], in order),
    on ``piv``'s device: the reference's ``_apply_swaps`` applied to an
    index vector, which then gathers any number of columns at once."""
    perm = torch.arange(rows, device=piv.device)
    idx = piv.long()
    for j in range(piv.shape[0]):
        i = idx[j : j + 1]
        row_j = perm[j : j + 1].clone()
        perm[j : j + 1] = perm.index_select(0, i)
        perm.index_copy_(0, i, row_j)
    return perm


def _trsm_lower_unit(l11: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L11 @ X = B with L11 unit lower triangular (nb x nb)."""
    nb = l11.shape[0]
    ridx = torch.arange(nb, device=l11.device)
    x = torch.zeros_like(b)
    for r in range(nb):
        lrow = torch.where(ridx < r, l11[r], 0.0)  # (nb,)
        x[r] = b[r] - lrow @ x
    return x


def _schur_blocks(c: torch.Tensor, x: torch.Tensor, nb: int) -> dict[str, int]:
    """Block sizes for the trailing update: 128 where it divides, else nb
    (the reference's rule keeps block_n at 128, which does not tile e.g.
    n=192, nb=32; every trailing width is a multiple of nb)."""
    m, n = c.shape
    return dict(
        block_m=min(128 if m % 128 == 0 else nb, m),
        block_n=min(128 if n % 128 == 0 else nb, n),
        block_k=min(128 if x.shape[1] % 128 == 0 else nb, x.shape[1]),
    )


def lu_blocked(
    a: torch.Tensor,
    *,
    nb: int = 128,
    n_real: int | None = None,
    schur: Callable[..., torch.Tensor] = schur_update,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked LU.  Returns (lu_packed, piv, parity) on ``a``'s device.

    ``a`` must be square with n % nb == 0 (use ops.lu for auto-padding).
    ``n_real`` marks the boundary of identity padding.  ``schur`` is the
    trailing-update block: the kernel's wrapper (default) or its plain
    version.
    """
    n = a.shape[0]
    if a.ndim != 2 or a.shape[1] != n or n % nb:
        raise ValueError(f"need square n%nb==0 matrix, got {tuple(a.shape)}, nb={nb}")
    n_real = n if n_real is None else n_real
    a = a.to(torch.float32).clone()
    piv = torch.zeros(n, dtype=torch.int32, device=a.device)
    parity = torch.ones((), dtype=torch.float32, device=a.device)

    for kb in range(0, n, nb):
        rows = n - kb
        panel, ppiv, pparity = _panel_factor(
            a[kb:, kb:kb + nb].clone(), max(n_real - kb, 0) or nb
        )
        parity = parity * pparity
        a[kb:, kb:kb + nb] = panel
        piv[kb:kb + nb] = ppiv + kb
        perm = _swap_permutation(ppiv, rows)
        # swap rows in the columns left of and right of the panel
        if kb > 0:
            a[kb:, :kb] = a[kb:, :kb][perm]
        rcols = n - kb - nb
        if rcols > 0:
            right = a[kb:, kb + nb:][perm]  # a gather: a new contiguous tensor
            u12 = _trsm_lower_unit(panel[:nb], right[:nb])
            right[:nb] = u12
            if rows > nb:
                l21 = panel[nb:]
                c = right[nb:]
                right[nb:] = schur(c, l21, u12, **_schur_blocks(c, l21, nb))
            a[kb:, kb + nb:] = right

    return a, piv, parity


#: the captured LU programs: (n, nb, trailing update, device) -> _LUProgram
_PROGRAMS: dict[tuple, "_LUProgram"] = {}


class _LUProgram:
    """``lu_blocked`` of an n x n input at one block size as a captured
    program: the input is copied into the top-left of a static (npad,
    npad) buffer whose padding is the identity (written once), the program
    factors that buffer, and each call returns copies of the outputs (a
    replay overwrites them)."""

    def __init__(self, n: int, nb: int, schur: Callable[..., torch.Tensor],
                 device: torch.device) -> None:
        # imported here: runtime.programs imports this package
        from repro_torch.runtime.programs import Captures

        self.n, self.nb, self.schur = n, nb, schur
        npad = -(-n // nb) * nb
        self.static = torch.eye(npad, dtype=torch.float32, device=device)
        self.captures = Captures()
        self.calls = 0

    def run(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return lu_blocked(self.static, nb=self.nb, n_real=self.n, schur=self.schur)

    def __call__(self, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = self.n
        self.static[:n, :n].copy_(a)
        self.calls += 1
        lu_p, piv, parity = self.captures((), self.run)
        return lu_p[:n, :n].clone(), piv[:n].clone(), parity.clone()

    def summary(self) -> dict:
        """Calls, eager calls, captures, replays, capture seconds and the
        launches one replay adds."""
        captured = self.captures.keys()
        return {
            "n": self.n, "nb": self.nb, "schur": getattr(self.schur, "__name__", repr(self.schur)),
            "calls": self.calls, "eager_calls": self.calls - self.captures.replays,
            "captures": len(captured), "replays": self.captures.replays,
            "capture_seconds": self.captures.capture_seconds,
            "launches_per_replay": (self.captures.launches_per_replay(captured[0])
                                    if captured else {}),
        }


def lu_program(
    a: torch.Tensor,
    *,
    nb: int,
    schur: Callable[..., torch.Tensor] = schur_update,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``lu_blocked`` of a square CUDA matrix (any n: identity-padded to a
    multiple of ``nb``) through its captured program.  Returns (lu, piv,
    parity) of the n x n input, as ``lu_blocked(...)[:n]`` would."""
    n = a.shape[0]
    if a.ndim != 2 or a.shape[1] != n or not a.is_cuda:
        raise ValueError(f"lu_program takes a square CUDA matrix, got "
                         f"{tuple(a.shape)} on {a.device}")
    key = (n, nb, schur, a.device)
    program = _PROGRAMS.get(key)
    if program is None:
        program = _PROGRAMS[key] = _LUProgram(n, nb, schur, a.device)
    return program(a)


def program_stats() -> list[dict]:
    """Each captured LU program's :meth:`_LUProgram.summary`."""
    return [program.summary() for program in _PROGRAMS.values()]

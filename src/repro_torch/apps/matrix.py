"""Matrix-calculation application (paper §5.1.1) — the port of
``repro/apps/matrix.py``: the naive code and ``REFERENCE_CODE`` verbatim,
the device stages in torch.

Naive CPU port of the *Numerical Recipes in C* ``ludcmp`` routine: Crout LU
decomposition with implicit row scaling and partial pivoting, in pure Python
loops.  The paper's verification workload is LU decomposition of a 2048x2048
orthogonal matrix, auto-replaced by cuSOLVER; here the replacement is the
blocked LU in ``repro_torch.kernels`` (its trailing updates are the
``schur_update`` CUDA kernel).

Offload paths exercised by the engine:
  * A-1/B-1: ``matrix_app_libcall`` calls ``ludcmp_nr`` by name.
  * A-2/B-2: ``matrix_app_copied`` carries a local modified clone.
  * loop-GA baseline: ``LU_STAGES`` / ``build_lu_variant``.
"""

from __future__ import annotations

import numpy as np


def ludcmp_nr(a):
    """Crout LU with implicit scaling + partial pivoting (NR ``ludcmp``).

    Returns (lu, indx, d): packed LU in one matrix, pivot rows, row-swap
    parity d = +-1.
    """
    a = np.array(a, dtype=np.float64)
    n = a.shape[0]
    indx = np.zeros(n, dtype=np.int64)
    d = 1.0
    vv = np.zeros(n, dtype=np.float64)
    for i in range(n):
        big = 0.0
        for j in range(n):
            temp = abs(a[i, j])
            if temp > big:
                big = temp
        if big == 0.0:
            raise ValueError("singular matrix in ludcmp")
        vv[i] = 1.0 / big
    for j in range(n):
        for i in range(j):
            s = a[i, j]
            for k in range(i):
                s -= a[i, k] * a[k, j]
            a[i, j] = s
        big = 0.0
        imax = j
        for i in range(j, n):
            s = a[i, j]
            for k in range(j):
                s -= a[i, k] * a[k, j]
            a[i, j] = s
            dum = vv[i] * abs(s)
            if dum >= big:
                big = dum
                imax = i
        if j != imax:
            for k in range(n):
                a[imax, k], a[j, k] = a[j, k], a[imax, k]
            d = -d
            vv[imax] = vv[j]
        indx[j] = imax
        if a[j, j] == 0.0:
            a[j, j] = 1.0e-20
        if j != n - 1:
            dum = 1.0 / a[j, j]
            for i in range(j + 1, n):
                a[i, j] *= dum
    return a, indx, d


REFERENCE_CODE = '''
def ludcmp(a):
    a = np.array(a, dtype=np.float64)
    n = a.shape[0]
    indx = np.zeros(n, dtype=np.int64)
    d = 1.0
    vv = np.zeros(n, dtype=np.float64)
    for i in range(n):
        big = 0.0
        for j in range(n):
            temp = abs(a[i, j])
            if temp > big:
                big = temp
        if big == 0.0:
            raise ValueError("singular matrix")
        vv[i] = 1.0 / big
    for j in range(n):
        for i in range(j):
            s = a[i, j]
            for k in range(i):
                s -= a[i, k] * a[k, j]
            a[i, j] = s
        big = 0.0
        imax = j
        for i in range(j, n):
            s = a[i, j]
            for k in range(j):
                s -= a[i, k] * a[k, j]
            a[i, j] = s
            dum = vv[i] * abs(s)
            if dum >= big:
                big = dum
                imax = i
        if j != imax:
            for k in range(n):
                a[imax, k], a[j, k] = a[j, k], a[imax, k]
            d = -d
            vv[imax] = vv[j]
        indx[j] = imax
        if a[j, j] == 0.0:
            a[j, j] = 1.0e-20
        if j != n - 1:
            dum = 1.0 / a[j, j]
            for i in range(j + 1, n):
                a[i, j] *= dum
    return a, indx, d
'''


def matrix_app_libcall(a):
    """The application: factorize, then determinant from the diagonal.

    The determinant is invariant to the pivoting strategy, so it is the
    app-level output verified after substitution (NR uses *scaled* partial
    pivoting; the accelerated blocked LU uses plain partial pivoting — their
    packed LU matrices legitimately differ, the determinant must not).
    """
    lu, indx, d = ludcmp_nr(a)
    det = float(d)
    for i in range(lu.shape[0]):
        det *= float(lu[i, i])
    return det


# --- copied-code flavour (A-2/B-2) -------------------------------------------


def my_ludcmp(mat):
    # borrowed textbook factorisation, adapted for our project
    mat = np.array(mat, dtype=np.float64)
    size = mat.shape[0]
    pivots = np.zeros(size, dtype=np.int64)
    parity = 1.0
    scale = np.zeros(size, dtype=np.float64)
    for r in range(size):
        largest = 0.0
        for c in range(size):
            mag = abs(mat[r, c])
            if mag > largest:
                largest = mag
        if largest == 0.0:
            raise ValueError("matrix is singular")
        scale[r] = 1.0 / largest
    for c in range(size):
        for r in range(c):
            acc = mat[r, c]
            for k in range(r):
                acc -= mat[r, k] * mat[k, c]
            mat[r, c] = acc
        largest = 0.0
        best_row = c
        for r in range(c, size):
            acc = mat[r, c]
            for k in range(c):
                acc -= mat[r, k] * mat[k, c]
            mat[r, c] = acc
            gauge = scale[r] * abs(acc)
            if gauge >= largest:
                largest = gauge
                best_row = r
        if c != best_row:
            for k in range(size):
                mat[best_row, k], mat[c, k] = mat[c, k], mat[best_row, k]
            parity = -parity
            scale[best_row] = scale[c]
        pivots[c] = best_row
        if mat[c, c] == 0.0:
            mat[c, c] = 1.0e-20
        if c != size - 1:
            inv = 1.0 / mat[c, c]
            for r in range(c + 1, size):
                mat[r, c] *= inv
    return mat, pivots, parity


def matrix_app_copied(a):
    lu, pivots, parity = my_ludcmp(a)
    det = float(parity)
    for i in range(lu.shape[0]):
        det *= float(lu[i, i])
    return det


# --- staged decomposition for the loop-offload GA baseline -------------------


def _naive_rowscale(a):
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    vv = np.zeros(n, dtype=np.float64)
    for i in range(n):
        big = 0.0
        for j in range(n):
            t = abs(a[i, j])
            if t > big:
                big = t
        vv[i] = 1.0 / big
    return (a, vv)


def _dev_rowscale(a):
    import torch

    vv = 1.0 / torch.amax(torch.abs(a), dim=1)
    return (a, vv)


def _naive_factor(state):
    a, vv = state
    a = np.array(a, dtype=np.float64)
    vv = np.array(vv, dtype=np.float64)
    n = a.shape[0]
    indx = np.zeros(n, dtype=np.int64)
    d = 1.0
    for j in range(n):
        for i in range(j):
            s = a[i, j]
            for k in range(i):
                s -= a[i, k] * a[k, j]
            a[i, j] = s
        big = 0.0
        imax = j
        for i in range(j, n):
            s = a[i, j]
            for k in range(j):
                s -= a[i, k] * a[k, j]
            a[i, j] = s
            dum = vv[i] * abs(s)
            if dum >= big:
                big = dum
                imax = i
        if j != imax:
            for k in range(n):
                a[imax, k], a[j, k] = a[j, k], a[imax, k]
            d = -d
            vv[imax] = vv[j]
        indx[j] = imax
        if a[j, j] == 0.0:
            a[j, j] = 1.0e-20
        if j != n - 1:
            dum = 1.0 / a[j, j]
            for i in range(j + 1, n):
                a[i, j] *= dum
    return (a, indx, np.float64(d))


def _dev_factor(state):
    """Unblocked right-looking LU on device (the 'offload the loop nest'
    variant): row-vectorised, scaled partial pivoting, a Python loop over
    columns of device operations (the reference's lax.fori_loop), with no
    host round trip per column.  Algorithmically the paper's loop offload —
    same algorithm as the CPU code, just executed on the accelerator."""
    import torch

    a, vv = state
    a, vv = a.clone(), vv.clone()  # updated in place below
    n = a.shape[0]
    ii = torch.arange(n, device=a.device)
    # constants as Python scalars: a host tensor copied to the card would
    # be a pageable copy, which a capture refuses
    indx = torch.zeros(n, dtype=torch.int32, device=a.device)
    d = torch.ones((), dtype=a.dtype, device=a.device)
    for j in range(n):
        score = torch.where(ii >= j, vv * torch.abs(a[:, j]), float("-inf"))
        # NR keeps the *last* maximal row (>= comparison)
        imax = ((n - 1) - torch.argmax(torch.flip(score, (0,)))).view(1)
        rowj = a[j:j + 1].clone()
        a[j:j + 1] = a.index_select(0, imax)
        a.index_copy_(0, imax, rowj)
        vvj = vv[j:j + 1].clone()
        vv[j:j + 1] = vv.index_select(0, imax)
        vv.index_copy_(0, imax, vvj)
        d = torch.where(imax[0] != j, -d, d)
        indx[j] = imax[0]
        piv = a[j, j]
        piv = torch.where(piv == 0.0, 1.0e-20, piv)
        a[j, j] = piv
        fac = torch.where(ii > j, a[:, j] / piv, 0.0)
        cols = torch.where(ii > j, a[j], 0.0)  # only trailing columns update
        a.sub_(torch.outer(fac, cols))
        a[:, j] = torch.where(ii > j, fac, a[:, j])
    return (a, indx, d)


def _naive_det(state):
    lu, indx, d = state
    det = float(d)
    for i in range(lu.shape[0]):
        det *= lu[i, i]
    return np.float64(det)


def _dev_det(state):
    import torch

    lu, indx, d = state
    return torch.prod(torch.diagonal(lu)) * d


from repro_torch.apps.common import Stage  # noqa: E402


LU_STAGES = (
    Stage("rowscale", _naive_rowscale, _dev_rowscale),
    Stage("factor", _naive_factor, _dev_factor),
    Stage("det", _naive_det, _dev_det),
)


def build_lu_variant(genome, device=None):
    from repro_torch.apps.common import build_staged_variant

    return build_staged_variant(LU_STAGES, genome, device)


def make_input(n: int = 192, seed: int = 0):
    """Random orthogonal matrix (the paper uses a 2048^2 orthogonal input)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q.astype(np.float64)

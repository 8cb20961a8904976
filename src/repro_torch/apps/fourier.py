"""Fourier-transform application (paper §5.1.1) — the port of
``repro/apps/fourier.py``: the naive code and ``REFERENCE_CODE`` verbatim,
the device stages in torch.

Naive CPU port of the *Numerical Recipes in C* 2-D FFT: iterative radix-2
Cooley-Tukey (bit-reversal + Danielson-Lanczos butterflies) applied along
rows then columns — written as loop-heavy "translated C".  The paper's
verification workload is the 2048x2048 2-D FFT sample test.

Offload paths exercised by the engine:
  * A-1/B-1: ``fourier_app_libcall`` calls the library routine ``fft2d_nr``
    whose name is on the pattern-DB external-library list -> replaced by the
    accelerated ``repro_torch.kernels.ops:fft2d`` (the cuFFT analogue).
  * A-2/B-2: ``fourier_app_copied`` contains ``my_fft2d`` — a copied and
    lightly modified clone of the library code (renames + comments), found by
    the Deckard-style similarity detector.
  * loop-GA baseline: ``FFT_STAGES`` / ``build_fft_variant`` split the app
    into 4 loop nests, each offloadable individually (paper refs [32][33]).
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _bit_reverse_indices(n: int) -> list[int]:
    bits = n.bit_length() - 1
    out = []
    for i in range(n):
        r = 0
        x = i
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        out.append(r)
    return out


def fft1d_nr(row):
    """Radix-2 in-place FFT of one complex vector (Numerical Recipes four1)."""
    n = len(row)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    data = row.copy()
    # bit-reversal permutation
    j = 0
    for i in range(n):
        if j > i:
            data[i], data[j] = data[j], data[i]
        m = n >> 1
        while m >= 1 and j >= m:
            j -= m
            m >>= 1
        j += m
    # Danielson-Lanczos butterflies
    size = 2
    while size <= n:
        half = size >> 1
        theta = -2.0 * math.pi / size
        wstep = complex(math.cos(theta), math.sin(theta))
        for start in range(0, n, size):
            w = complex(1.0, 0.0)
            for k in range(half):
                u = data[start + k]
                t = w * data[start + k + half]
                data[start + k] = u + t
                data[start + k + half] = u - t
                w *= wstep
        size <<= 1
    return data


def fft2d_nr(x):
    """Naive 2-D FFT: row FFT loop then column FFT loop (the library code)."""
    x = np.asarray(x, dtype=np.complex128)
    n, m = x.shape
    out = x.copy()
    for i in range(n):
        out[i, :] = fft1d_nr(out[i, :])
    for jcol in range(m):
        out[:, jcol] = fft1d_nr(out[:, jcol])
    return out


# The source registered in the Code-Pattern DB for similarity matching (B-2).
# It is the library implementation above, as a literal (the DB stores
# comparison code, not a live object).
REFERENCE_CODE = '''
def fft2d_nr(x):
    x = np.asarray(x, dtype=np.complex128)
    n, m = x.shape
    out = x.copy()
    for i in range(n):
        out[i, :] = fft1d_nr(out[i, :])
    for jcol in range(m):
        out[:, jcol] = fft1d_nr(out[:, jcol])
    return out

def fft1d_nr(row):
    n = len(row)
    if n & (n - 1):
        raise ValueError("length must be a power of two")
    data = row.copy()
    j = 0
    for i in range(n):
        if j > i:
            data[i], data[j] = data[j], data[i]
        m = n >> 1
        while m >= 1 and j >= m:
            j -= m
            m >>= 1
        j += m
    size = 2
    while size <= n:
        half = size >> 1
        theta = -2.0 * math.pi / size
        wstep = complex(math.cos(theta), math.sin(theta))
        for start in range(0, n, size):
            w = complex(1.0, 0.0)
            for k in range(half):
                u = data[start + k]
                t = w * data[start + k + half]
                data[start + k] = u + t
                data[start + k + half] = u - t
                w *= wstep
        size <<= 1
    return data
'''


def fourier_app_libcall(x):
    """The application, library-call flavour: calls fft2d_nr by name."""
    spectrum = fft2d_nr(x)
    return spectrum


# --- copied-code flavour (A-2/B-2 discovery path) ---------------------------


def my_fft1d(vec):
    # local copy of the textbook routine, tweaked while debugging
    npts = len(vec)
    if npts & (npts - 1):
        raise ValueError("length must be a power of two")
    buf = vec.copy()
    jj = 0
    for ii in range(npts):
        # swap into bit-reversed position
        if jj > ii:
            buf[ii], buf[jj] = buf[jj], buf[ii]
        half_n = npts >> 1
        while half_n >= 1 and jj >= half_n:
            jj -= half_n
            half_n >>= 1
        jj += half_n
    span = 2
    while span <= npts:
        half_span = span >> 1
        ang = -2.0 * math.pi / span
        wdelta = complex(math.cos(ang), math.sin(ang))
        for base in range(0, npts, span):
            tw = complex(1.0, 0.0)
            for kk in range(half_span):
                top = buf[base + kk]
                bot = tw * buf[base + kk + half_span]
                buf[base + kk] = top + bot
                buf[base + kk + half_span] = top - bot
                tw *= wdelta
        span <<= 1
    return buf


def my_fft2d(img):
    # copied 2-D transform: rows first, then columns
    img = np.asarray(img, dtype=np.complex128)
    rows, cols = img.shape
    work = img.copy()
    for r in range(rows):
        work[r, :] = my_fft1d(work[r, :])
    for c in range(cols):
        work[:, c] = my_fft1d(work[:, c])
    return work


def fourier_app_copied(x):
    """The application, copied-code flavour: a local clone of the library."""
    return my_fft2d(x)


def unrelated_helper(records):
    """Negative control: independent code that must NOT match the DB."""
    table = {}
    for line in records:
        key, _, value = line.partition("=")
        key = key.strip()
        if not key:
            continue
        table.setdefault(key, []).append(value.strip())
    summary = []
    for key in sorted(table):
        summary.append(f"{key}:{len(table[key])}")
    return ";".join(summary)


# --- staged decomposition for the loop-offload GA baseline -------------------


def _naive_bitrev_rows(x):
    x = np.asarray(x, dtype=np.complex128)
    n, m = x.shape
    idx = _bit_reverse_indices(m)
    out = np.empty_like(x)
    for i in range(n):
        for jcol in range(m):
            out[i, idx[jcol]] = x[i, jcol]
    return out


def _naive_butterfly_rows(x):
    x = np.asarray(x, dtype=np.complex128)
    n, m = x.shape
    out = x.copy()
    for i in range(n):
        row = out[i, :]
        size = 2
        while size <= m:
            half = size >> 1
            theta = -2.0 * math.pi / size
            wstep = complex(math.cos(theta), math.sin(theta))
            for start in range(0, m, size):
                w = complex(1.0, 0.0)
                for k in range(half):
                    u = row[start + k]
                    t = w * row[start + k + half]
                    row[start + k] = u + t
                    row[start + k + half] = u - t
                    w *= wstep
            size <<= 1
        out[i, :] = row
    return out


def _naive_transpose(x):
    x = np.asarray(x)
    n, m = x.shape
    out = np.empty((m, n), dtype=x.dtype)
    for i in range(n):
        for jcol in range(m):
            out[jcol, i] = x[i, jcol]
    return out


@functools.lru_cache(maxsize=None)
def _dev_bitrev_gather(m: int, device):
    """The gather index of the bit-reversal permutation on ``device``, made
    once: a capture refuses the pageable copy that makes it, so the stage's
    eager first call makes it, and a replay reads it."""
    import torch

    return torch.as_tensor(np.argsort(_bit_reverse_indices(m)), device=device)


def _dev_bitrev_rows(x):
    return x[:, _dev_bitrev_gather(x.shape[1], x.device)]


def _dev_butterfly_rows(x):
    import torch

    n, m = x.shape
    size = 2
    while size <= m:
        half = size >> 1
        w = torch.exp(-2j * torch.pi * torch.arange(half, device=x.device) / size).to(x.dtype)
        xr = x.reshape(n, m // size, 2, half)
        even = xr[:, :, 0, :]
        odd = xr[:, :, 1, :] * w
        x = torch.cat([even + odd, even - odd], dim=-1).reshape(n, m)
        size <<= 1
    return x


def _dev_transpose(x):
    return x.T


from repro_torch.apps.common import Stage  # noqa: E402


FFT_STAGES = (
    Stage("row_bitrev", _naive_bitrev_rows, _dev_bitrev_rows),
    Stage("row_butterfly", _naive_butterfly_rows, _dev_butterfly_rows),
    Stage("transpose", _naive_transpose, _dev_transpose),
    Stage("col_bitrev", _naive_bitrev_rows, _dev_bitrev_rows),
    Stage("col_butterfly", _naive_butterfly_rows, _dev_butterfly_rows),
    Stage("transpose_back", _naive_transpose, _dev_transpose),
)


def build_fft_variant(genome, device=None):
    """Loop-offload variant of the FFT app selected by a 6-bit genome."""
    from repro_torch.apps.common import build_staged_variant

    return build_staged_variant(FFT_STAGES, genome, device)


def make_input(n: int = 256, m: int | None = None, seed: int = 0):
    rng = np.random.default_rng(seed)
    m = m or n
    return (rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))).astype(
        np.complex128
    )

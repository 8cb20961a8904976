"""RMSNorm in three forms: the CUDA kernel's wrappers (``csrc/rmsnorm.cu``,
the port of ``repro/kernels/rmsnorm.py``'s ``rmsnorm_pallas``, with the
residual add and Mamba-2's gated norm fused into it) and their plain
versions.

- ``rmsnorm(x, w, eps)``: per row in f32, cast back to ``x.dtype``;
- ``add_rmsnorm(x, delta, w, eps) -> (s, y)``: ``s = x + delta`` in
  ``x.dtype``, then ``y = rmsnorm(s)`` (a block's residual add and the
  next norm);
- ``gated_rmsnorm(y, x, d_skip, z, w, eps)``: ``g = (y + d_skip[h] x) *
  silu(z)`` in f32, normalised over rows of ``H * P``, cast to ``z.dtype``.

Each plain version is the op sequence the models ran before the fusion.
A wrapper runs its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.  ``rmsnorm`` and ``rmsnorm_torch`` take the
fused forms as keywords (``delta=``, ``gate=(x, d_skip, z)``), so the
shelf's one ``rmsnorm`` block, and any binding of it, covers all three.

Under autograd (grad mode on, an input requiring grad) the plain and add
forms on CUDA tensors go through :class:`RMSNormFn` / :class:`AddRMSNormFn`:
the forward kernel, then the backward kernel (``csrc/rmsnorm_bwd.cu``,
:func:`rmsnorm_bwd`); :func:`rmsnorm_bwd_torch` is its plain version.  The
gated form has no backward kernel and refuses a gradient; an unbound
``rmsnorm`` call of that form under autograd resolves to ``torch``
(:mod:`repro_torch.core.blocks`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref

FORMS = ("plain", "add", "gated")
#: the forms with a backward kernel
BWD_FORMS = ("plain", "add")
#: elements a thread loads at a time, the most threads of a CTA and the
#: chunks a thread keeps in registers (``csrc/rmsnorm.cu`` and
#: ``csrc/rmsnorm_bwd.cu``: kChunk, kCtaThreads, kRegChunks)
CHUNK, CTA_THREADS, REG_CHUNKS = 8, 512, 2
WARP = 32


@dataclasses.dataclass(frozen=True)
class NormPlan:
    tpr: int  # threads of the row's CTA, a multiple of 32 up to 512
    nv: int  # chunks a thread keeps in registers; 0: the two-pass loop


@functools.lru_cache(maxsize=256)
def norm_plan(d: int) -> NormPlan:
    """The kernel's layout, from the row's width: a CTA a row, each thread
    holding one chunk of 8 for rows of up to 512 chunks and two up to 1024
    (the CTA a multiple of 32 wide, so few threads idle); longer rows take
    the two-pass loop."""
    chunks = -(-d // CHUNK)
    nv = next((n for n in range(1, REG_CHUNKS + 1) if chunks <= n * CTA_THREADS), 0)
    if not nv:
        return NormPlan(CTA_THREADS, 0)
    threads = -(-chunks // nv)
    return NormPlan(max(32, (threads + 31) // 32 * 32), nv)


#: shared memory an SM gives its CTAs (the H100's 228 KB) and the most rows
#: of the backward's copy ring
SMEM_PER_SM, MAX_STAGES = 233472, 3


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    tpr: int  # threads of a row group (a warp, or a multiple of 32 up to 512)
    nv: int  # chunks a thread keeps in registers; 0: the two-pass loop
    groups: int  # row groups of a CTA
    ctas: int  # CTAs of the persistent grid, each writing one f32 row of dw terms
    stages: int  # rows of the copy ring (16-byte chunks); 0: elements tpr apart


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, d: int, sms: int, itemsize: int, add: bool = False) -> BwdPlan:
    """The backward kernel's layout (``csrc/rmsnorm_bwd.cu``): a warp a row
    for rows of up to 32 chunks of 8, else a group of threads as wide as
    the row in one chunk a thread up to 512 chunks and two up to 1024, else
    the two-pass loop.  A CTA holds as many row groups as fit in 512
    threads, but no more than a group for every ``sms`` rows, so few rows
    spread over many SMs.  The grid is what the card keeps resident:
    ``sms`` times the CTAs that fit in the threads an SM runs at the
    kernel's launch bounds (1024 for one chunk of 2-byte elements or the
    two-pass loop, else 512), never more CTAs than the rows fill.  Rows of
    whole chunks stream through a copy ring of as many rows (2 or 3) of x,
    dy and (``add``) ds as the SM's shared memory holds for those CTAs."""
    chunks = -(-d // CHUNK)
    if chunks <= WARP:
        tpr, nv = WARP, 1
    else:
        nv = next((n for n in range(1, REG_CHUNKS + 1) if chunks <= n * CTA_THREADS), 0)
        tpr = CTA_THREADS if not nv else -(-chunks // (nv * WARP)) * WARP
    groups = max(1, min(CTA_THREADS // tpr, -(-rows // sms)))
    resident = 2 * CTA_THREADS if nv == 0 or (nv == 1 and itemsize == 2) else CTA_THREADS
    per_sm = max(1, resident // (groups * tpr))
    stages = 0
    if nv and d % CHUNK == 0:
        ring_row = groups * (3 if add else 2) * nv * tpr * CHUNK * itemsize
        stages = min(MAX_STAGES, (SMEM_PER_SM // per_sm - 2048) // ring_row)
    return BwdPlan(tpr, nv, groups, min(-(-rows // groups), sms * per_sm),
                   stages if stages >= 2 else 0)


def _sm_count(device: torch.device) -> int:
    return build.sm_count(device)


# -- plain versions -----------------------------------------------------------------


def add_rmsnorm_torch(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    s = x + delta.to(x.dtype)
    return s, rmsnorm_ref(s, w, eps)


def gated_rmsnorm_torch(y: torch.Tensor, x: torch.Tensor, d_skip: torch.Tensor,
                        z: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y (B, S, H, P) f32, x (B, S, H, P), d_skip (H,), z (B, S, H * P),
    w (H * P,) -> (B, S, H * P) in z's dtype."""
    y = y + d_skip.float()[None, None, :, None] * x.float()
    g = y.reshape(z.shape) * F.silu(z.float())
    ms = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(ms + eps) * w.float()).to(z.dtype)


def rmsnorm_bwd_torch(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                      ds: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernel: (dx, dw) of
    ``rmsnorm_ref(x, w)`` for the output gradient ``dy``, per row in f32,
    ``dx = r (w dy) - x r^3 mean(x w dy)`` with ``r = rsqrt(mean(x^2) +
    eps)``, plus ``ds`` (the add form: the gradient of the sum output)
    before the cast to x's type; ``dw`` sums ``dy x r`` over the rows, in
    w's type."""
    xf, dyf, wf = x.float(), dy.float(), w.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wdy = wf * dyf
    c = r * r * r * torch.mean(xf * wdy, dim=-1, keepdim=True)
    dx = r * wdy - xf * c
    if ds is not None:
        dx = dx + ds.float()
    dw = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm_torch(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                  delta: torch.Tensor | None = None, gate: tuple | None = None):
    """The plain versions behind one signature, as :func:`rmsnorm`."""
    if delta is not None:
        return add_rmsnorm_torch(x, delta, w, eps)
    if gate is not None:
        return gated_rmsnorm_torch(x, *gate, w, eps)
    return rmsnorm_ref(x, w, eps)


# -- the kernel's wrappers ----------------------------------------------------------


def _check_param(name: str, p: torch.Tensor, n: int) -> None:
    if p.dtype not in (torch.float32, torch.bfloat16) or tuple(p.shape) != (n,):
        raise ValueError(
            f"{name} must be float32 or bfloat16 ({n},), got {p.dtype} {tuple(p.shape)}"
        )


def _strides4(t: torch.Tensor) -> tuple[int, ...]:
    """(batch, sequence, head, within-head) strides in elements of a
    (B, S, H, P) view; 0 where a dim is 1 (never stepped)."""
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape, t.stride()))


def norm_work(form: str, x: torch.Tensor, w: torch.Tensor,
              d_skip: torch.Tensor | None = None) -> build.Work:
    """The forward kernel's work over ``x``'s rows of w's width (x in the
    output's type; the gated form's ``z``): plain reads x and writes y; add
    reads x and delta and writes s and y; gated reads the f32 y, x and z
    and writes the output, and reads d_skip.  Each reads w.  FLOPs per
    element: 4 (square, sum, scale, weight), 5 with the add, 12 gated."""
    d = w.shape[0]
    n = x.numel()
    e = x.element_size()
    wb = w.element_size() * d
    if form == "plain":
        return build.Work(4 * n, 2 * n * e + wb, build.peak_of(x.dtype))
    if form == "add":
        return build.Work(5 * n, 4 * n * e + wb, build.peak_of(x.dtype))
    sb = d_skip.element_size() * d_skip.numel()
    return build.Work(12 * n, n * (4 + 3 * e) + wb + sb, build.peak_of(x.dtype))


def norm_bwd_work(x: torch.Tensor, w: torch.Tensor, add: bool = False) -> build.Work:
    """The backward kernel's work: x, dy (and the add form's ds) read and dx
    written in x's type, w read and dw written; 12 f32 FLOPs an element."""
    n = x.numel()
    n_in = 3 if add else 2
    return build.Work(12 * n, (n_in + 1) * n * x.element_size() + 2 * w.element_size() * w.shape[0],
                      "float32")


def _launch(form: str, out: torch.Tensor, w: torch.Tensor, rows: int, seq: int, d: int,
            head_dim: int, eps: float, operands, *, skip=None, s_out=None) -> None:
    """``operands``: up to three (tensor, strides4) pairs, the C entry
    point's a, b, c.  The kernel picks its vector path itself."""
    if build.skip_launch("rmsnorm", out, work=lambda: norm_work(form, out, w, skip)):
        return
    plan = norm_plan(d)
    ops = list(operands) + [(None, (0, 0, 0, 0))] * (3 - len(operands))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    build.launch(
        "repro_rmsnorm", FORMS.index(form), *(ptr(t) for t, _ in ops), ptr(skip), ptr(w),
        ptr(s_out), ptr(out), *(st for _, sts in ops for st in sts), rows, seq, d, head_dim,
        eps, build.dtype_code(out), build.dtype_code(w), plan.tpr, plan.nv, build.stream_of(out),
    )
    rmsnorm.launches += 1
    rmsnorm.forms[form] += 1


class RMSNormFn(torch.autograd.Function):
    """The plain form's ``cuda`` target under autograd: the forward kernel,
    then the backward kernel on the saved ``x``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, dy, w, ctx.eps)
        return dx, dw, None


class AddRMSNormFn(torch.autograd.Function):
    """The add form's ``cuda`` target under autograd: ``(s, y)`` from the
    forward kernel; the backward kernel takes the saved sum ``s``, the
    norm's gradient and the sum's own (the residual stream's), and gives
    their total to both ``x`` and ``delta``."""

    @staticmethod
    def forward(ctx, x, delta, w, eps):
        s, y = _add_rmsnorm_cuda(x, delta, w, eps)
        ctx.save_for_backward(s, w)
        ctx.eps = eps
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(s, dy, w, ctx.eps, ds=ds)
        return dx, dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
            delta: torch.Tensor | None = None, gate: tuple | None = None):
    """x (..., d) float32/bfloat16, w (d,) float32/bfloat16 -> x.dtype.
    ``delta=`` gives :func:`add_rmsnorm`, ``gate=(x, d_skip, z)``
    :func:`gated_rmsnorm` of ``x`` as its ``y``."""
    if delta is not None and gate is not None:
        raise ValueError("rmsnorm: give delta= or gate=, not both")
    if delta is not None:
        return add_rmsnorm(x, delta, w, eps)
    if gate is not None:
        return gated_rmsnorm(x, *gate, w, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if build.wants_grad(x, w):
        return RMSNormFn.apply(x, w, eps)
    return _rmsnorm_cuda(x, w, eps)


def _rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    build.check_cuda("rmsnorm", x, w)
    d = x.shape[-1]
    _check_param("rmsnorm: w", w, d)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:  # rows of one d-wide head
        _launch("plain", out, w, rows, rows, d, d, eps, [(x, (0, d, 0, 1))])
    return out


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x, delta (..., d), one type; w (d,) -> (s = x + delta, rmsnorm(s)),
    both in x's type.  One launch: s is rounded to x's type before the norm
    squares it, and written beside the norm's output (nothing in place)."""
    if x.device.type == "cpu":
        return add_rmsnorm_torch(x, delta, w, eps)
    if build.wants_grad(x, delta, w):
        return AddRMSNormFn.apply(x, delta, w, eps)
    return _add_rmsnorm_cuda(x, delta, w, eps)


def _add_rmsnorm_cuda(x, delta, w, eps):
    build.check_cuda("add_rmsnorm", x, delta, w)
    if delta.dtype != x.dtype or delta.shape != x.shape:
        raise ValueError(
            f"add_rmsnorm: delta must be {x.dtype} {tuple(x.shape)}, got "
            f"{delta.dtype} {tuple(delta.shape)}"
        )
    d = x.shape[-1]
    _check_param("add_rmsnorm: w", w, d)
    s, out = torch.empty_like(x), torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        _launch("add", out, w, rows, rows, d, d, eps, [(x, (0, d, 0, 1)), (delta, (0, d, 0, 1))],
                s_out=s)
    return s, out


def gated_rmsnorm(y: torch.Tensor, x: torch.Tensor, d_skip: torch.Tensor, z: torch.Tensor,
                  w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's gated norm: y (B, S, H, P) float32, x (B, S, H, P) and
    z (B, S, H * P) of one type, d_skip (H,) and w (H * P,) of one type ->
    (B, S, H * P) in z's type.  y, x and z are read in place through their
    strides, whatever the layout (the kernel takes 16-byte loads of each
    where the layout allows): in the Mamba-2 block x and z are column
    slices of wider tensors, and y and x may come from an einsum or a conv
    in another order."""
    if y.device.type == "cpu":
        return gated_rmsnorm_torch(y, x, d_skip, z, w, eps)
    return _gated_rmsnorm_cuda(y, x, d_skip, z, w, eps)


def _gated_rmsnorm_cuda(y, x, d_skip, z, w, eps):
    build.refuse_grad("gated_rmsnorm", "rmsnorm", y, x, d_skip, z, w)
    build.check_cuda("gated_rmsnorm", d_skip, w)
    if any(t.device != w.device for t in (y, x, z)):
        raise ValueError(f"gated_rmsnorm: every operand must be on {w.device}")
    if y.ndim != 4 or x.shape != y.shape:
        raise ValueError(f"gated_rmsnorm: y and x must be one (B, S, H, P) shape, got "
                         f"{tuple(y.shape)} and {tuple(x.shape)}")
    b, seq, h, p = y.shape
    di = h * p
    if tuple(z.shape) != (b, seq, di):
        raise ValueError(f"gated_rmsnorm: z must be {(b, seq, di)}, got {tuple(z.shape)}")
    if y.dtype != torch.float32 or x.dtype != z.dtype:
        raise ValueError(f"gated_rmsnorm: y must be float32 and x of z's type, got "
                         f"{y.dtype}, {x.dtype}, {z.dtype}")
    _check_param("gated_rmsnorm: d_skip", d_skip, h)
    _check_param("gated_rmsnorm: w", w, di)
    if d_skip.dtype != w.dtype:
        raise ValueError("gated_rmsnorm: d_skip and w must share a type")
    out = torch.empty((b, seq, di), dtype=z.dtype, device=z.device)
    if b * seq and di:
        ops = [(t, _strides4(t)) for t in (y, x, z.unflatten(-1, (h, p)))]
        _launch("gated", out, w, b * seq, seq, di, p, eps, ops, skip=d_skip)
    return out


def rmsnorm_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                ds: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of the plain form at ``x`` (of the add form at its sum, with
    ``ds`` the sum output's gradient): the backward kernel for CUDA
    tensors, :func:`rmsnorm_bwd_torch` for CPU ones.  x, dy and ds (..., d)
    share x's type; dx comes in x's type, dw in w's."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_torch(x, dy, w, eps, ds)
    return _rmsnorm_bwd_cuda(x, dy, w, eps, ds)


def _rmsnorm_bwd_cuda(x, dy, w, eps, ds):
    dy = dy.contiguous()
    ds = None if ds is None else ds.contiguous()
    build.check_cuda("rmsnorm_bwd", x, dy, w, *([] if ds is None else [ds]))
    d = x.shape[-1]
    for name, t in (("dy", dy), ("ds", ds)):
        if t is not None and (t.dtype != x.dtype or t.shape != x.shape):
            raise ValueError(f"rmsnorm_bwd: {name} must be {x.dtype} {tuple(x.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    _check_param("rmsnorm_bwd: w", w, d)
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    rows = x.numel() // d if d else 0
    if not rows:
        return dx, dw.zero_()
    plan = bwd_plan(rows, d, _sm_count(x.device), x.element_size(), ds is not None)
    partial = torch.empty((plan.ctas, d), dtype=torch.float32, device=x.device)
    form = "plain" if ds is None else "add"
    if build.skip_launch("rmsnorm_bwd", x, work=lambda: norm_bwd_work(x, w, ds is not None)):
        return dx, dw
    build.launch(
        "repro_rmsnorm_bwd", x.data_ptr(), dy.data_ptr(), None if ds is None else ds.data_ptr(),
        w.data_ptr(), dx.data_ptr(), partial.data_ptr(), dw.data_ptr(), rows, d, eps,
        build.dtype_code(x), build.dtype_code(w), plan.ctas, plan.groups, plan.tpr, plan.nv,
        plan.stages, build.stream_of(x),
    )
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.forms[form] += 1
    return dx, dw


#: every launch of the kernel, and the launches of each form
rmsnorm.launches = 0
rmsnorm.forms = dict.fromkeys(FORMS, 0)
#: every launch of the backward kernel, and the launches of each form
rmsnorm_bwd.launches = 0
rmsnorm_bwd.forms = dict.fromkeys(BWD_FORMS, 0)

"""Grouped MoE expert products over the routed (token, expert) pairs: the
wrapper of ``csrc/moe_experts.cu`` and its plain version.

For tokens x (T, D), each with ``top_k`` experts ``topi`` (T, k) and their
combine weights ``topv`` (T, k), the output (T, D) is, for every token, the
slot-order sum over its choices of ``(silu(x W_gate[e]) * (x W_up[e]))
W_down[e]`` times the choice's weight, rounded where the capacity route of
``repro_torch.models.moe`` rounds (g and u, h, the expert output and the
weight in x's type, each add of the sum).

Replaces no TPU kernel: the reference's expert products are einsums that
XLA compiles (``repro/models/moe.py``), batched over every expert's
capacity slots.  Where no choice can drop (decode, short extend chunks)
that reads every expert's weights for a few hundred routed rows; this
kernel reads only the experts some token chose, and builds no (B, E, C, D)
tensor.  Bounded on the H100 by bytes: the touched experts' three D x F
matrices (:func:`experts_work`).  The kernel groups the pairs by expert on
the device (no host read: a CUDA graph captures a call) and skips an
expert no token chose before any weight load; bf16 runs on the tensor
cores (mma.sync), f32 on the CUDA cores.

The pack step keeps a tally on the device (:func:`tally`): the experts read
and the experts held, summed over calls.  It is read on the host only by
:func:`read_pct`, never inside a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.blocks import wants_grad
from repro_torch.kernels import build

#: the kernel's column tile and K-slice: D and F must be multiples of it
TILE = 64
#: the most experts the pack step counts (its shared-memory table)
MAX_EXPERTS = 1024

#: per device, the (2,) int64 tally [experts read, experts held]
_tallies: dict[torch.device, torch.Tensor] = {}


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def tally(device) -> torch.Tensor:
    """The device's (2,) int64 tally, made (zeros) at its first use; made
    outside a CUDA graph's capture, which would record its zeroing."""
    key = _device_key(device)
    t = _tallies.get(key)
    if t is None:
        if key.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("moe_experts: the device tally must exist before a capture "
                               "(reset_tally(device) makes it)")
        t = _tallies[key] = torch.zeros(2, dtype=torch.int64, device=key)
    return t


def reset_tally(device) -> None:
    """Zero the device's tally (making it if it has none)."""
    tally(device).zero_()


def read_pct(device=None) -> float | None:
    """100 x experts read over experts held, over the grouped calls since the
    tally was zeroed (on ``device``, or on every device with a tally); None
    where no call was counted.  Reads the device: call it between steps."""
    keys = list(_tallies) if device is None else [_device_key(device)]
    read = held = 0
    for key in keys:
        if key in _tallies:
            r, h = _tallies[key].tolist()
            read, held = read + r, held + h
    return 100.0 * read / held if held else None


def experts_work(x: torch.Tensor, topi: torch.Tensor, w_gate: torch.Tensor,
                 touched: int | None = None) -> build.Work:
    """The call's work: the touched experts' three D x F matrices read once,
    x, the choices and their weights read once, the (T, D) output written
    once; FLOPs 2 D F for each of a pair's three products.  The bytes depend
    on the data: given ``touched`` (the distinct experts of ``topi``, a host
    count) it counts those; without it (a trace) as many experts as the
    pairs can reach, ``min(E, T k)``."""
    t, d = x.shape
    k = topi.shape[1]
    e, _, f = w_gate.shape
    touched = min(e, t * k) if touched is None else touched
    nbytes = (x.element_size() * (touched * 3 * d * f + 2 * t * d)
              + t * k * (topi.element_size() + 4))
    return build.Work(6 * t * k * d * f, nbytes, build.peak_of(x.dtype))


def moe_experts_torch(x, topi, topv, w_gate, w_up, w_down):
    """Plain version: each slot's experts gathered per token, the three
    products as batched matmuls in x's type, the slots summed in order."""
    out = None
    for j in range(topi.shape[1]):
        e = topi[:, j]
        xr = x[:, None, :]
        g = torch.bmm(xr, w_gate[e])[:, 0]
        u = torch.bmm(xr, w_up[e])[:, 0]
        h = F.silu(g) * u
        y = torch.bmm(h[:, None, :], w_down[e])[:, 0] * topv[:, j, None].to(x.dtype)
        out = y if out is None else out + y
    return out


def _count_experts(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[distinct experts of ``topi``, experts held], the CPU route's tally."""
    seen = torch.zeros(n_experts, dtype=torch.bool).index_fill_(0, topi.flatten(), True)
    return torch.stack([seen.sum(), torch.tensor(n_experts)])


def moe_experts(x: torch.Tensor, topi: torch.Tensor, topv: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """x (T, D), topi (T, k) int64, topv (T, k) f32, w_gate / w_up (E, D, F),
    w_down (E, F, D) -> (T, D) in x's type: the kernel for CUDA tensors
    (bf16 or f32, D and F multiples of ``TILE``), the plain version for CPU
    tensors.  Each call adds to the device's :func:`tally`."""
    t, d = x.shape
    k = topi.shape[1]
    e, _, f = w_gate.shape
    if topi.shape != (t, k) or topv.shape != (t, k) or w_gate.shape[1] != d or \
            w_up.shape != w_gate.shape or w_down.shape != (e, f, d):
        raise ValueError(
            f"moe_experts: x {tuple(x.shape)}, topi {tuple(topi.shape)}, topv "
            f"{tuple(topv.shape)}, w_gate {tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
            f"w_down {tuple(w_down.shape)} do not fit (T, D), (T, k), (E, D, F), (E, F, D)")
    if x.device.type == "cpu":
        out = moe_experts_torch(x, topi, topv, w_gate, w_up, w_down)
        if not build.is_abstract(x):
            tally(x.device).add_(_count_experts(topi, e))
        return out
    operands = (x, topi, topv, w_gate, w_up, w_down)
    if wants_grad(*operands):
        raise RuntimeError("moe_experts: the kernel has no backward; a gradient takes "
                           "moe_forward's capacity route")
    build.check_cuda("moe_experts", *operands)
    if topi.dtype != torch.int64 or topv.dtype != torch.float32:
        raise TypeError("moe_experts: topi must be int64 and topv float32")
    if any(w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError("moe_experts: x and the expert weights must share one dtype")
    if t < 1 or not 0 < k <= e <= MAX_EXPERTS or d % TILE or f % TILE:
        raise ValueError(f"moe_experts: takes T >= 1, 0 < top_k <= E <= {MAX_EXPERTS} and D, "
                         f"F multiples of {TILE}; got T {t}, top_k {k}, E {e}, D {d}, F {f}")
    if not all(build.aligned(w) for w in (x, w_gate, w_up, w_down)):
        raise ValueError("moe_experts: x and the weights must start 16-byte aligned")
    code = build.dtype_code(x)
    dev = x.device
    offsets = torch.empty(e + 1, dtype=torch.int32, device=dev)
    order = torch.empty(t * k, dtype=torch.int32, device=dev)
    h = torch.empty((t * k, f), dtype=x.dtype, device=dev)
    y = torch.empty((t * k, d), dtype=x.dtype, device=dev)
    out = torch.empty((t, d), dtype=x.dtype, device=dev)
    if build.skip_launch("moe_experts", x, work=lambda: experts_work(x, topi, w_gate)):
        return out
    count = tally(dev)
    build.launch(
        "repro_moe_experts", x.data_ptr(), topi.data_ptr(), topv.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), offsets.data_ptr(),
        order.data_ptr(), h.data_ptr(), y.data_ptr(), out.data_ptr(), count.data_ptr(),
        t, k, e, d, f, code, build.stream_of(x),
    )
    moe_experts.launches += 1
    return out


moe_experts.launches = 0

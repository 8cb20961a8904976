"""Mamba-2 block (SSD): in_proj -> causal depthwise conv -> selective scan
-> gated RMSNorm -> out_proj (the port of ``repro/models/ssm.py``).

The scan goes through the ``ssd_scan`` function block (``cuda`` = chunked
SSD with the chunk kernel, ``torch`` = its plain version, ``ref`` = the
sequential recurrence).  Decode keeps O(1) state per layer: the conv
window (the ``d_conv - 1`` last inputs) and the SSM state (H, N, P).
States are updated in place, as the attention caches are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blocks
from repro_torch.models.layers import gated_rmsnorm, tp_out_einsum
from repro_torch.models.params import ParamMeta, torch_dtype
from repro_torch.sharding.utils import constrain, is_dtensor


def ssm_metas(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    dt = cfg.param_dtype
    di = s.d_inner(d)
    h = s.n_heads(d)
    cd = s.conv_dim(d)
    d_in_proj = 2 * di + 2 * s.d_state + h  # z, xBC, dt
    return {
        "in_proj": ParamMeta((d, d_in_proj), ("embed", "ssm_inner"), dt),
        "conv_w": ParamMeta((s.d_conv, cd), (None, "ssm_inner"), dt, scale=0.1),
        "conv_b": ParamMeta((cd,), ("ssm_inner",), dt, init="zeros"),
        "a_log": ParamMeta((h,), ("ssm_heads",), dt, init="ssm_a"),
        "d_skip": ParamMeta((h,), ("ssm_heads",), dt, init="ones"),
        "dt_bias": ParamMeta((h,), ("ssm_heads",), dt, init="dt_bias"),
        "norm": ParamMeta((di,), ("ssm_inner",), dt, init="ones"),
        "out_proj": ParamMeta((di, d), ("ssm_inner", "embed"), dt),
    }


def ssm_state_metas(cfg: ArchConfig, batch: int) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    h = s.n_heads(d)
    return {
        "conv": ParamMeta(
            (batch, s.d_conv - 1, s.conv_dim(d)),
            ("act_batch", None, "ssm_inner"), "float32", init="zeros",
        ),
        "ssm": ParamMeta(
            (batch, h, s.d_state, s.head_dim),
            ("act_batch", "ssm_heads_act", None, None), "float32", init="zeros",
        ),
    }


def _causal_conv_sharded(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_causal_conv` of ``DTensor``s on each rank's shards: the
    batch and the channels (each its own group) may stay sharded, the
    sequence is whole."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.shelf import follow, lead_placements

    lead = lead_placements(xbc, {0, 2})
    return local_map(
        _causal_conv, out_placements=list(lead),
        in_placements=(lead, follow(lead, {2: 1}), follow(lead, {2: 0})),
        in_grad_placements=(lead, follow(lead, {2: 1}, grad=True),
                            follow(lead, {2: 0}, grad=True)),
        redistribute_inputs=True,
    )(xbc, w, b)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C): ``F.conv1d`` with ``groups=C``
    on ``d_conv - 1`` steps of left padding.  Both libraries compute a
    cross-correlation, so the (d_conv, C) window becomes the (C, 1,
    d_conv) weight unflipped."""
    dconv, c = w.shape
    xt = F.pad(xbc.transpose(1, 2), (dconv - 1, 0))  # (B, C, d_conv - 1 + S)
    out = F.conv1d(xt, w.t().reshape(c, 1, dconv).to(xbc.dtype), groups=c)
    # back to (B, S, C) rows: the scan reads x, B and C as dense rows
    return out.transpose(1, 2).contiguous() + b.to(xbc.dtype)


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ArchConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    cd = s.conv_dim(cfg.d_model)
    return zxbcdt[..., :di], zxbcdt[..., di : di + cd], zxbcdt[..., di + cd :]


def _conv_tail(xbc: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width`` inputs, the decode conv window.  A prompt shorter
    than the window is left-padded with zeros, the inputs the causal conv
    assumed before the first step."""
    if xbc.shape[1] < width:
        xbc = F.pad(xbc, (0, 0, width - xbc.shape[1], 0))
    return xbc[:, xbc.shape[1] - width :]


def ssm_forward(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ArchConfig,
    state: dict | None = None,
    mode: str = "train",
):
    """Returns (out (B, S, D), state): the state updated in place, or None
    when none was given."""
    s = cfg.ssm
    b, seq, d = x.shape
    cdty = torch_dtype(cfg.compute_dtype)
    di = s.d_inner(d)
    h = s.n_heads(d)
    xc = x.to(cdty)

    zxbcdt = constrain(xc @ p["in_proj"].to(cdty), "act_batch", None, "ssm_inner_act")
    z, xbc, dt_raw = _split_zxbcdt(zxbcdt, cfg)

    if mode == "decode":
        if state is None:
            raise ValueError("decode mode needs the SSM state")
        window = torch.cat([state["conv"].to(cdty), xbc], dim=1)  # (B, d_conv, C)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(cdty))
        conv_out = (conv_out + p["conv_b"].to(cdty))[:, None, :]
        new_conv = window[:, 1:, :]
    else:
        conv = _causal_conv_sharded if is_dtensor(xbc) else _causal_conv
        conv_out = conv(xbc, p["conv_w"], p["conv_b"])
        new_conv = _conv_tail(xbc, s.d_conv - 1) if state is not None else None
    xbc_a = F.silu(conv_out)

    x_ssm = xbc_a[..., :di].reshape(b, seq, h, s.head_dim)
    bmat = xbc_a[..., di : di + s.d_state]
    cmat = xbc_a[..., di + s.d_state :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, S, H)
    a = -torch.exp(p["a_log"].float())  # (H,)

    if mode == "decode":
        # one-step recurrence against the carried state
        dt0 = dt[:, 0]  # (B, H)
        decay = torch.exp(a[None, :] * dt0)
        upd = torch.einsum(
            "bh,bn,bhp->bhnp", dt0, bmat[:, 0].float(), x_ssm[:, 0].float()
        )
        ssm_new = state["ssm"].float() * decay[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), ssm_new)[:, None]  # (B, 1, H, P)
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(ssm_new)
    else:
        h0 = state["ssm"].float() if state is not None else None
        y, ssm_fin = blocks.call(
            "ssd_scan", x_ssm, dt, a, bmat, cmat, chunk=s.chunk, h0=h0
        )
        if state is not None:
            state["conv"].copy_(new_conv)
            state["ssm"].copy_(ssm_fin)

    # the D skip and the gated RMSNorm (Mamba-2), norm((y + D x) * silu(z)) * w
    # in f32: one call of the rmsnorm block, reading x and z in place
    g = gated_rmsnorm(p["norm"], y, x_ssm, p["d_skip"], z, cfg.norm_eps)
    return tp_out_einsum(g, p["out_proj"].to(cdty), cdty), state

"""The kernel shelf on local shards: how a function block runs when its
arguments are ``DTensor``s.

The shelf's implementations — the hand-written kernels' wrappers (ctypes
launches on raw pointers) and their plain versions — take plain tensors.
Under a mesh, :func:`call_local` runs the bound implementation through
``local_map`` on each rank's local shards: the target the registry
resolved is kept (a ``cuda`` binding stays the kernel), and the launch
counters count as they do on one card.  Each block declares which
dimensions may stay sharded (its *contract*); an input sharded on another
dimension, or holding partial sums, is redistributed first, and that
collective is in the program like any other:

* ``rmsnorm`` (every form): leading dimensions free, the normalised
  dimension whole (the gated form normalises ``H * P``: heads whole);
* ``attention``: batch and heads free, the sequence and head dims whole.
  Where the q heads are sharded on a mesh axis that cannot split the kv
  heads (``n_kv_heads`` not a multiple of the axis), k and v stay
  replicated on it and each rank takes the kv heads its q heads read, so
  the kernel's local head map ``h // (H_local / KH_local)`` keeps the
  global group;
* ``ssd_scan``: batch and heads free, the sequence whole;
* ``paged_attention`` raises: the serving engine is not sharded.

A weight the call broadcasts over sharded rows (a norm's ``w``, the SSD's
``a``) has partial gradients on the mesh axes that shard those rows: its
gradient placement there is ``Partial``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


def has_dtensor(args: tuple, kwargs: dict) -> bool:
    from torch.distributed.tensor import DTensor

    for a in (*args, *kwargs.values()):
        for t in a if isinstance(a, (tuple, list)) else (a,):
            if isinstance(t, DTensor):
                return True
    return False


def lead_placements(x: Any, dims: set[int]) -> tuple:
    """``x``'s placements with every shard of a dimension outside ``dims``
    (and every partial sum) replaced by ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in x.placements:
        keep = isinstance(p, Shard) and p.dim % x.ndim in dims
        out.append(Shard(p.dim % x.ndim) if keep else Replicate())
    return tuple(out)


def follow(lead: tuple, dim_map: dict[int, int], grad: bool = False) -> tuple:
    """``lead``'s shards moved to another tensor's dimensions (``dim_map``:
    lead dim -> that tensor's dim).  On a mesh axis where the lead is
    sharded on a dimension missing from the map, the tensor is replicated,
    and with ``grad`` its gradient there is a partial sum (the tensor is
    broadcast over the rows that axis splits)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for p in lead:
        if isinstance(p, Shard) and p.dim in dim_map:
            out.append(Shard(dim_map[p.dim]))
        elif isinstance(p, Shard) and grad:
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)


class Plan:
    """One call's placements: ``inputs`` / ``grads`` map ``id(tensor)`` to
    the placements each ``DTensor`` argument is given and its gradient
    takes; ``outputs`` has one entry per output tensor; ``prepare`` (if
    any) edits the local arguments before the call."""

    def __init__(self) -> None:
        self.inputs: dict[int, tuple] = {}
        self.grads: dict[int, tuple] = {}
        self.outputs: tuple = ()
        self.prepare: Callable[[tuple, dict], tuple[tuple, dict]] | None = None

    def put(self, t: Any, placements: tuple, grad: tuple | None = None) -> None:
        if t is None or not isinstance(t, torch.Tensor):
            return
        self.inputs[id(t)] = placements
        self.grads[id(t)] = placements if grad is None else grad


def _rmsnorm_plan(mesh: Any, args: tuple, kwargs: dict) -> Plan:
    x, w = args[0], args[1]
    plan = Plan()
    gate = kwargs.get("gate")
    if gate is not None:  # y (B, S, H, P), gate (x, d_skip, z (B, S, H * P))
        xs, d_skip, z = gate
        lead = lead_placements(z, set(range(z.ndim - 1)))
        rows = follow(lead, {d: d for d in range(z.ndim - 1)})
        for t in (x, xs):
            plan.put(t, rows)
        plan.put(z, lead)
        for t in (d_skip, w):
            plan.put(t, follow(lead, {}), follow(lead, {}, grad=True))
        plan.outputs = (lead,)
        return plan
    lead = lead_placements(x, set(range(x.ndim - 1)))
    plan.put(x, lead)
    plan.put(kwargs.get("delta"), lead)
    plan.put(w, follow(lead, {}), follow(lead, {}, grad=True))
    plan.outputs = (lead, lead) if kwargs.get("delta") is not None else (lead,)
    return plan


def _attention_plan(mesh: Any, args: tuple, kwargs: dict) -> Plan:
    from torch.distributed.tensor import Partial, Replicate, Shard

    q, k, v = args[0], args[1], args[2]
    n_heads, n_kv = q.shape[1], k.shape[1]
    lead = lead_placements(q, {0, 1})
    kv, kv_grad, sliced = [], [], []
    for i, p in enumerate(lead):
        if p == Shard(1) and n_kv % mesh.size(i):
            kv.append(Replicate())
            kv_grad.append(Partial())
            sliced.append(i)
        else:
            kv.append(p)
            kv_grad.append(p)
    plan = Plan()
    plan.put(q, lead)
    for t in (k, v):
        plan.put(t, tuple(kv), tuple(kv_grad))
    plan.outputs = (lead,)
    if sliced:
        if len(sliced) > 1:
            raise NotImplementedError("attention: q heads sharded on several mesh axes "
                                      "that cannot split the kv heads")
        plan.prepare = _kv_slicer(mesh, sliced[0], n_heads // n_kv)
    return plan


def _kv_slicer(mesh: Any, mesh_dim: int, group: int):
    """The local k / v narrowed to the kv heads this rank's q heads read
    (global q head ``h`` reads kv head ``h // group``)."""

    def prepare(args: tuple, kwargs: dict) -> tuple[tuple, dict]:
        q, k, v = args[0], args[1], args[2]
        local_heads = q.shape[1]
        if local_heads % group and group % local_heads:
            raise ValueError(f"attention: {local_heads} local q heads cannot keep the "
                             f"kv group of {group}")
        first = mesh.get_local_rank(mesh_dim) * local_heads
        lo, hi = first // group, (first + local_heads - 1) // group + 1
        # dense rows, as the kernel takes them
        return (q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(), *args[3:]), kwargs

    return prepare


def _ssd_plan(mesh: Any, args: tuple, kwargs: dict) -> Plan:
    x, dt, a, bmat, cmat = args[:5]
    lead = lead_placements(x, {0, 2})  # x (B, S, H, P)
    plan = Plan()
    plan.put(x, lead)
    plan.put(dt, follow(lead, {0: 0, 2: 2}))  # (B, S, H)
    plan.put(a, follow(lead, {2: 0}), follow(lead, {2: 0}, grad=True))  # (H,)
    for t in (bmat, cmat):  # (B, S, N): shared by every head
        plan.put(t, follow(lead, {0: 0}), follow(lead, {0: 0}, grad=True))
    plan.put(kwargs.get("h0"), follow(lead, {0: 0, 2: 1}))  # (B, H, N, P)
    plan.outputs = (lead, follow(lead, {0: 0, 2: 1}))
    return plan


def _unsharded(block: str):
    def plan(mesh: Any, args: tuple, kwargs: dict) -> Plan:
        raise ValueError(f"function block '{block}' does not run under a mesh: its "
                         "arguments must be plain tensors")

    return plan


#: block -> its contract: ``(mesh, args, kwargs) -> Plan``
CONTRACTS: dict[str, Callable[[Any, tuple, dict], Plan]] = {
    "rmsnorm": _rmsnorm_plan,
    "attention": _attention_plan,
    "ssd_scan": _ssd_plan,
}


def call_local(block: str, fn: Callable[..., Any], args: tuple, kwargs: dict) -> Any:
    """``fn(*args, **kwargs)`` on the local shards of the ``DTensor``
    arguments, placed by the block's contract; the outputs are ``DTensor``s
    with the contract's placements."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    leaves, spec = pytree.tree_flatten((args, kwargs))
    mesh = next(t.device_mesh for t in leaves if isinstance(t, DTensor))
    plan = CONTRACTS.get(block, _unsharded(block))(mesh, args, kwargs)
    in_pl, grad_pl = [], []
    for t in leaves:
        if isinstance(t, DTensor):
            in_pl.append(plan.inputs[id(t)])
            grad_pl.append(plan.grads[id(t)])
        else:
            in_pl.append(None)
            grad_pl.append(None)

    def local(*flat: Any) -> Any:
        a, kw = pytree.tree_unflatten(list(flat), spec)
        if plan.prepare is not None:
            a, kw = plan.prepare(a, kw)
        return fn(*a, **kw)

    # one output's placements as a list: local_map reads a tuple as one
    # placement sequence per output
    outs = [list(p) for p in plan.outputs]
    outputs = tuple(outs) if len(outs) > 1 else outs[0]
    return local_map(local, out_placements=outputs, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*leaves)

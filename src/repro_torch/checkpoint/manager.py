"""Checkpointing: atomic, async, retention-managed (the port of
``repro/checkpoint/manager.py`` over the port's trees: nested dicts of
tensors, :class:`repro_torch.optim.OptState`, tuples and lists).

Layout:  <dir>/step_<n>/  arrays.npz + manifest.json, written to a tmp dir
and renamed into place (rename is atomic on POSIX), so a job killed
mid-write can never leave a half checkpoint that restore would pick up.
The device-to-host copy happens in the caller (the train step updates its
tensors in place, so the copy must be taken before the next step); the
write runs on a background thread, and ``wait()`` joins it before the next
save or at shutdown.  Restore returns the latest complete step, each leaf
on the device and in the dtype of the tree it is restored into.  bfloat16
leaves are stored as float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch


def _items(tree: Any) -> list[tuple[str, Any]] | None:
    """A node's (key, child) pairs in a fixed order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{"path/to/leaf": leaf}`` over the tree's leaves."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, child in items:
        out.update(flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def unflatten(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """A tree of ``like``'s structure whose leaves come from ``leaves``."""
    items = _items(like)
    if items is None:
        return leaves[prefix]
    children = {k: unflatten(c, leaves, f"{prefix}/{k}" if prefix else k) for k, c in items}
    if isinstance(like, dict):
        return {k: children[str(k)] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(children[str(i)] for i in range(len(like)))
    return dataclasses.replace(like, **children)


def to_host(leaf: Any) -> np.ndarray:
    """A copy of ``leaf`` in host memory (a CPU tensor's storage is copied
    too: the step that follows updates it in place)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.float() if t.dtype == torch.bfloat16 else t
        return t.cpu().numpy().copy()
    return np.array(leaf, copy=True)


def from_host(a: np.ndarray, like: Any) -> Any:
    """``a`` as a leaf like ``like``: a tensor on its device, in its dtype."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(device=like.device, dtype=like.dtype)
    return a


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3) -> None:
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        flat = {k: to_host(v) for k, v in flatten(tree).items()}  # in the caller

        def _write() -> None:
            tmp = self.dir / f".tmp_step_{step}_{os.getpid()}_{time.time_ns()}"
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **flat)
            manifest = {"step": step, "keys": sorted(flat), "time": time.time()}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        for s in self._complete_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def _complete_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def steps(self) -> list[int]:
        self.wait()  # an in-flight async save counts once it is complete
        return self._complete_steps()

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: int | None = None) -> tuple[int, Any]:
        """Restore into the structure of ``like`` (values replaced; each
        tensor leaf on ``like``'s device, in its dtype)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(self.dir / f"step_{step:08d}" / "arrays.npz") as data:
            flat_like = flatten(like)
            missing = set(flat_like) - set(data.files)
            if missing:
                raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
            arrays = {k: data[k] for k in flat_like}
        # a checkpoint from a *different model config* must fail loudly, not
        # feed mis-shaped arrays into the step function
        bad = [(k, arrays[k].shape, tuple(np.shape(leaf))) for k, leaf in flat_like.items()
               if hasattr(leaf, "shape") and tuple(arrays[k].shape) != tuple(np.shape(leaf))]
        if bad:
            k, got, want = bad[0]
            raise ValueError(
                f"checkpoint at step {step} does not match the current model: "
                f"'{k}' has shape {got}, expected {want} "
                f"(+{len(bad) - 1} more) — wrong --ckpt-dir?"
            )
        leaves = {k: from_host(arrays[k], leaf) for k, leaf in flat_like.items()}
        return step, unflatten(like, leaves)

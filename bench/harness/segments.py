"""Readers of the engine's host segments (``ServeEngine.telemetry``
entries beside its phases: ``decode.prep``, ``decode.pages``,
``decode.launch``, ``decode.commit``, ``prefill.chunk``), over the
window's telemetry.

A program without the segments has no such entries: the readers then
return None, as they do when the window holds no call to divide by.
"""

from __future__ import annotations

#: the host's own work of a decode step, outside its program call
DECODE_HOST = ("decode.prep", "decode.pages", "decode.commit")


def _ms(run, names: tuple[str, ...], per: str) -> float | None:
    t = run.telemetry
    if per not in t or any(n not in t for n in names) or not t[per]["calls"]:
        return None
    return sum(t[n]["seconds"] for n in names) / t[per]["calls"] * 1e3


def decode_host_ms(run) -> float | None:
    """ms a decode step: page growth and the active set, the page table's
    upload, and the per-slot commit, over decode calls."""
    return _ms(run, DECODE_HOST, "decode")


def decode_launch_ms(run) -> float | None:
    """ms a call of the decode program, up to its return on the host."""
    return _ms(run, ("decode.launch",), "decode.launch")


def chunk_ms(run) -> float | None:
    """ms a prefill chunk, its sync included."""
    return _ms(run, ("prefill.chunk",), "prefill.chunk")

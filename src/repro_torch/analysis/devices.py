"""Device memory envelopes: what a candidate program must fit inside (the
port of ``repro/analysis/devices.py``).

The paper's FPGA path gates every offload pattern on a *resource-fit*
check — reject patterns whose HLS resource estimate exceeds the board —
before any measurement is spent.  The GPU analogue needs the board side of
that inequality: a :class:`DeviceEnvelope` names a target's device memory
(HBM, or host RAM for the CPU) and the shared memory one CTA may take,
which a hand-written kernel's tiles must fit.

Two sources:

* :func:`probe_device_envelope` asks the live device: for a CUDA device
  ``torch.cuda.mem_get_info`` (total bytes), ``torch.cuda.get_device_name``
  and the device's opt-in shared memory per block; for the CPU, host RAM.
* :data:`STATIC_ENVELOPES` is a table of named targets for "what-if"
  planning — size a serve config for an ``a100-40g`` from a CPU host, or
  against the synthetic ``tiny-32m`` board the preflight tests reject
  configs on.  The reference's TPU rows are not carried: asking for one
  raises the reference's ``KeyError`` with the known names.

:func:`resolve_envelope` is the one entry point the analysis passes use:
it accepts an envelope object, a static-table name, or ``"host"``/None/True
(probe the caller's device), and nothing else.
"""

from __future__ import annotations

import dataclasses
import os

import torch

MiB = 1 << 20
GiB = 1 << 30
KiB = 1 << 10


@dataclasses.dataclass(frozen=True)
class DeviceEnvelope:
    """Memory capacity of one offload target.

    ``memory_bytes`` is the working-set bound (device memory, or host RAM
    for the CPU); ``smem_bytes`` the shared memory one CTA may take (the
    opt-in limit per block), which a kernel's resident tiles must fit —
    the counterpart of the reference's ``vmem_bytes`` (a TPU core's VMEM);
    None where there is no such limit to check.  ``source`` records whether
    the numbers were probed from the live device or declared statically.
    """

    name: str
    platform: str  # "cpu" | "gpu"
    memory_bytes: int
    smem_bytes: int | None = None
    source: str = "static"  # "static" | "probed"
    notes: str = ""

    def headroom_bytes(self, need_bytes: int) -> int:
        """Bytes left after ``need_bytes`` (negative = does not fit)."""
        return self.memory_bytes - int(need_bytes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        mem = self.memory_bytes / GiB
        smem = f", smem {self.smem_bytes / KiB:.0f} KiB" if self.smem_bytes else ""
        return f"{self.name} ({self.platform}, {mem:.1f} GiB{smem}, {self.source})"


#: Named what-if targets.  Capacities are the published per-device numbers
#: (the reference's bytes); ``smem_bytes`` is the opt-in shared memory per
#: block of the card's compute capability (CUDA C++ Programming Guide:
#: 227 KiB on sm_90, 163 KiB on sm_80, 99 KiB on sm_89).
STATIC_ENVELOPES: dict[str, DeviceEnvelope] = {
    e.name: e
    for e in (
        DeviceEnvelope("a100-40g", "gpu", 40 * GiB, smem_bytes=163 * KiB,
                       notes="A100 SXM/PCIe 40 GiB HBM2"),
        DeviceEnvelope("a100-80g", "gpu", 80 * GiB, smem_bytes=163 * KiB,
                       notes="A100 80 GiB HBM2e"),
        DeviceEnvelope("h100-80g", "gpu", 80 * GiB, smem_bytes=227 * KiB,
                       notes="H100 SXM 80 GiB HBM3"),
        DeviceEnvelope("l4-24g", "gpu", 24 * GiB, smem_bytes=99 * KiB,
                       notes="L4 24 GiB GDDR6 (inference tier)"),
        DeviceEnvelope("cpu-host-16g", "cpu", 16 * GiB,
                       notes="CI-container class host; the lint default so "
                             "ratcheted verdicts are host-independent"),
        DeviceEnvelope("tiny-32m", "cpu", 32 * MiB,
                       notes="synthetic undersized board for preflight "
                             "rejection tests and CI smoke"),
    )
}


def _host_memory_bytes() -> int:
    """Total host RAM, best effort (psutil, then sysconf, then 16 GiB)."""
    try:
        import psutil

        return int(psutil.virtual_memory().total)
    except Exception:  # noqa: BLE001 — psutil is optional
        pass
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 16 * GiB


def probe_device_envelope(device: "torch.device | str" = "cuda") -> DeviceEnvelope:
    """Envelope of a live device: a CUDA device's total memory, name and
    opt-in shared memory per block; the CPU's host RAM.  A CUDA device
    without CUDA raises (there is no fallback to the host)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: probing a CUDA envelope needs the card; "
                "pass device='cpu' (or a static envelope name) to plan without it"
            )
        _free, total = torch.cuda.mem_get_info(device)
        props = torch.cuda.get_device_properties(device)
        return DeviceEnvelope(
            name=torch.cuda.get_device_name(device), platform="gpu",
            memory_bytes=int(total), smem_bytes=int(props.shared_memory_per_block_optin),
            source="probed",
        )
    return DeviceEnvelope(
        name=f"host:{device.type}", platform="cpu",
        memory_bytes=_host_memory_bytes(), source="probed",
        notes="host RAM",
    )


def resolve_envelope(spec, device: "torch.device | str" = "cuda") -> DeviceEnvelope:
    """One resolution policy for every pass.

    ``DeviceEnvelope`` passes through; ``None``/``True``/``"host"`` probe
    ``device``; any other string looks up :data:`STATIC_ENVELOPES`
    (unknown names fail loudly with the known ones listed).
    """
    if isinstance(spec, DeviceEnvelope):
        return spec
    if spec is None or spec is True or spec == "host":
        return probe_device_envelope(device)
    if isinstance(spec, str):
        try:
            return STATIC_ENVELOPES[spec]
        except KeyError:
            raise KeyError(
                f"unknown device envelope '{spec}'; known: "
                f"{sorted(STATIC_ENVELOPES)} (or 'host' to probe)"
            ) from None
    raise TypeError(
        f"envelope spec must be a DeviceEnvelope, a name, 'host' or None; "
        f"got {type(spec).__name__}"
    )

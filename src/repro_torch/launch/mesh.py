"""The card's hardware model (the port of ``repro/launch/mesh.py``'s ``HW``).

The reference's ``HW`` is the TPU v5e the roofline analysis assumes; the
port's target is one NVIDIA H100 SXM, and :data:`HW` holds its data
sheet's dense peaks: bf16 989e12 flop/s on the tensor cores, tf32 495e12,
f32 67e12 on the CUDA cores, HBM 3.35e12 bytes/s, and 80 GB of device
memory, which :meth:`Hardware.memory_bytes` replaces by the card's own
figure where a card is present.  ``launch/graph_cost.py``, the roofline
cost function (``core/planner/cost.py``), the dry-run and ``chip_smoke.py``
read these numbers from here.

The reference's meshes (``make_production_mesh``, ``make_mesh``,
``mesh_shape_dict``) wait for the port's distribution (ROADMAP A6): the
port's target is one card.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    #: flop/s by the compute class of the FLOPs: "bfloat16" (and f16) on the
    #: tensor cores, "tf32" on the tensor cores, "float32" on the CUDA cores
    peak_flops: Mapping[str, float]
    hbm_bw: float  # bytes/s
    datasheet_memory_bytes: int

    def peak(self, kind: str) -> float:
        return self.peak_flops[kind]

    def memory_bytes(self) -> int:
        """Device memory: the card's total as torch reports it when a card
        is present, the data sheet's otherwise."""
        import torch

        if torch.cuda.is_available():
            return int(torch.cuda.get_device_properties(0).total_memory)
        return self.datasheet_memory_bytes


#: NVIDIA H100 SXM, data sheet, dense
HW = Hardware(
    name="H100 SXM",
    peak_flops={"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12},
    hbm_bw=3.35e12,
    datasheet_memory_bytes=80 * 10**9,
)

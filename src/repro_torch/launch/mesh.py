"""Meshes and the card's hardware model (the port of ``repro/launch/mesh.py``).

Single pod: 256 GPUs as (data=16, model=16).  Multi-pod: 2 x 256 GPUs as
(pod=2, data=16, model=16) — the pod axis carries pure data parallelism.
The meshes are ``DeviceMesh`` objects on ``init_device_mesh``: each needs a
default process group whose world size is the mesh's size — NCCL on the
cards, ``gloo`` for CPU tests, and the ``fake`` backend
(``torch.testing._internal.distributed.fake_pg``) for the dry-run, which
traces 256 or 512 ranks in one process.  They are functions, not module
constants, so importing this module touches no process group.

The reference's ``HW`` is the TPU v5e the roofline analysis assumes; the
port's target is one NVIDIA H100 SXM, and :data:`HW` holds its data
sheet's dense peaks: bf16 989e12 flop/s on the tensor cores, tf32 495e12,
f32 67e12 on the CUDA cores, HBM 3.35e12 bytes/s, NVLink 900e9 bytes/s per
GPU (both directions, the counterpart of the reference's ``ici_bw``), and
80 GB of device memory, which :meth:`Hardware.memory_bytes` replaces by the card's own
figure where a card is present.  ``launch/graph_cost.py``, the roofline
cost function (``core/planner/cost.py``), the dry-run and ``chip_smoke.py``
read these numbers from here.
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
    nvlink_bw: float = 0.0  # bytes/s per GPU, both directions

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
    nvlink_bw=900e9,
)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (tests use small ones, e.g. (2, 2) on 4 gloo ranks with
    ``device_type="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_shape_dict(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))

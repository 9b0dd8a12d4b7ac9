"""Mesh descriptions and the H100 constants of the roofline.  The port's
counterpart of ``repro.launch.mesh``.

A :class:`MeshShape` names a mesh's axes and their sizes and holds no
devices: the port runs a model on one device, so the dry run
(``launch/dryrun.py``) only needs the shape to say what each device would
hold.  The production meshes keep the reference's shapes, so every cell maps
one to one: ``(16, 16)`` over ``("data", "model")`` for one pod of 256
cards, ``(2, 16, 16)`` over ``("pod", "data", "model")`` for two.

256 H100s span 32 hosts of 8 cards, so an axis of 16 crosses hosts and its
traffic leaves NVLink for the slower network between hosts: for such an
axis a collective time computed from ``LINK_BW`` is a floor.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 cards a pod; ``multi_pod`` stacks 2 pods = 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(device=None) -> MeshShape:
    """A 1-D ``"data"`` mesh over the local cards (one entry for the CPU when
    the caller passes ``device="cpu"``).  Raises when the card is asked for
    and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return MeshShape(("data",), (1,))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    return MeshShape(("data",), (torch.cuda.device_count(),))


# NVIDIA H100 SXM data sheet (dense, no sparsity), in place of the
# reference's TPU v5e numbers
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor-core FLOP/s per H100 SXM
HBM_BW = 3.35e12                # HBM3 bytes/s per H100 SXM
LINK_BW = 450e9                 # NVLink 4 bytes/s per H100 SXM, one direction

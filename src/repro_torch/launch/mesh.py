"""Production mesh description for the dry run.

Mirrors ``repro/launch/mesh.py``. The reference builds a jax ``Mesh`` over
256 or 512 forced host devices; the port's dry run traces on ``meta``
tensors and needs only the mesh's axis names and sizes, so a mesh here is
a plain record: no device, no process group, no ``torch.distributed``.

On H100s the two meshes are 256 and 512 cards: DGX nodes of 8 cards joined
by NVLink, the nodes joined by InfiniBand. The 16-wide ``model`` and
``data`` axes each span two or more nodes, so their collectives leave the
NVLink domain (``launch.roofline.Hardware.link_bw``).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["ProductionMesh", "make_production_mesh", "axis_sizes"]


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A device-free mesh: axis names and their sizes."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """16x16 single-pod (256 cards) or 2x16x16 two-pod (512 cards) mesh.

    Axes: ('data', 'model') / ('pod', 'data', 'model'). The 'pod' axis is
    hierarchical data parallelism (cross-pod gradient reduction); 'model'
    carries TP/EP; 'data' carries DP/FSDP (+ decode KV sequence shards).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ProductionMesh(axes, shape)


def axis_sizes(mesh: ProductionMesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))

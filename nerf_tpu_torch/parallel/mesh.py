"""The rank mesh, as ``nerf_tpu.parallel.mesh``.

A spec such as ``"data:8"`` or ``"scene:2,data:4"`` lays the ranks out as
an array of that shape in row-major order, as nerf_tpu lays out its
devices; an empty spec puts every rank on ``data``. A rank owns one device.
Along each axis the ranks that share every other coordinate form a process
group (``torch.distributed.new_group``), which is where that axis's
collectives run: a ``data`` group averages one scene's gradients. Without a
process group (one rank, or a layout built for inspection with
``world_size`` given) there are no groups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_tpu_torch.parallel import multihost


@dataclass
class Mesh:
    axis_names: tuple
    sizes: tuple
    rank: int
    groups: dict = field(default_factory=dict)   # axis -> ProcessGroup or None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self) -> dict:
        """This rank's coordinate on each axis."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank, self.sizes))))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank along ``axis`` (None: one rank)."""
        return self.groups.get(axis)


def parse_spec(spec: str, world: int) -> tuple[tuple, tuple]:
    """``(names, sizes)`` of a spec; raises when its product is not the
    number of ranks."""
    if not spec:
        return ("data",), (world,)
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition(":")
        names.append(name.strip())
        sizes.append(int(size))
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(f"mesh spec {spec!r} wants {total} devices, have {world}")
    return tuple(names), tuple(sizes)


def create_mesh(spec: str = "", world_size: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """The mesh of ``spec`` over the process group's ranks (one rank without
    a group), or over ``world_size`` ranks as seen from ``rank`` (default 0)
    without groups. Every rank of a group must call this, with the same
    spec, in the same order (``new_group`` is collective)."""
    grouped = world_size is None and dist.is_initialized()
    world = multihost.world_size() if world_size is None else int(world_size)
    me = multihost.rank() if rank is None else int(rank)
    names, sizes = parse_spec(spec, world)
    mesh = Mesh(names, sizes, me)
    if not grouped or world == 1:
        return mesh
    ids = np.arange(world).reshape(sizes)
    for a, name in enumerate(names):
        lines = np.moveaxis(ids, a, -1).reshape(-1, sizes[a])
        for line in lines:               # every rank creates every group
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mesh.groups[name] = g
    return mesh


def shard_pool(pool, mesh: Mesh, axis: str = "data"):
    """This rank's shard of a ``RayPool`` along ``axis``: the pool wrap-padded
    to a multiple of the axis size (duplicate rays are harmless for uniform
    with-replacement sampling), then its contiguous part."""
    n, i = mesh.size(axis), mesh.index(axis)

    def rows(x: torch.Tensor) -> torch.Tensor:
        rem = (-x.shape[0]) % n
        if rem:
            x = torch.cat([x, x[:rem]], 0)
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]

    return type(pool)(*(rows(x) for x in pool))

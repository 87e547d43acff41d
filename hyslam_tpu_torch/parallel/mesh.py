"""Process meshes over ``torch.distributed`` (counterpart of
``hyslam_tpu/parallel/mesh.py``).

A JAX mesh is an array of devices with named axes, and ``psum`` over an
axis name sums over the devices that differ only in that coordinate. Here
the mesh is an array of ranks of the default process group with named axes,
and every axis and every tuple of axes has a process group: the group of
the ranks that share this rank's coordinates on the other axes. ``("kf",
"lm")`` is every rank of the mesh (the world group where the mesh holds
every rank); ``"lm"`` is the ranks that share a ``kf`` coordinate.

``dist.new_group`` is collective over the whole default group, so every
rank creates every group, in one order, also the groups it is not in. The
backend is the one the caller gave ``init_process_group``; nothing here
picks or changes one. NCCL refuses two ranks on one card, so ranks that
share a card run ``gloo``, which on CUDA tensors supports ``all_reduce``
and ``broadcast`` only: the sharded solvers use ``all_reduce`` alone.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Ranks of the default process group laid out on named axes.

    ``shape`` maps each axis name to its size, in order. ``coords`` are this
    rank's coordinates, or None where the rank is not in the mesh (a mesh
    over the first n ranks of a larger world). ``device`` is where this rank
    puts its shards. ``group(axes)`` is the process group to reduce over for
    an axis name or a tuple of them."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...],
                 device: torch.device, groups: dict | None = None):
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d ranks for axes {axis_names}")
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.device = torch.device(device)
        me = dist.get_rank()
        where = np.argwhere(ranks == me)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        if groups is not None:
            self._groups = groups
            return
        world = dist.get_world_size()
        self._groups = {}
        for n_axes in range(1, len(self.axis_names) + 1):
            for axes in combinations(range(len(self.axis_names)), n_axes):
                names = tuple(self.axis_names[a] for a in axes)
                self._groups[names] = self._axis_group(axes, world, me)

    def _axis_group(self, axes, world: int, me: int):
        """This rank's group over ``axes``: one ``new_group`` for every
        combination of the other axes' coordinates, called on every rank."""
        if len(axes) == self.ranks.ndim and self.ranks.size == world:
            return dist.group.WORLD
        moved = np.moveaxis(self.ranks, axes, range(self.ranks.ndim - len(axes),
                                                    self.ranks.ndim))
        mine = None
        for members in moved.reshape(-1, int(np.prod([self.ranks.shape[a] for a in axes]))):
            g = dist.new_group([int(r) for r in members])
            if me in members:
                mine = g
        return mine

    def group(self, axes):
        """The process group of this rank over an axis name or a tuple of
        axis names (in the mesh's order)."""
        key = (axes,) if isinstance(axes, str) else tuple(
            a for a in self.axis_names if a in axes)
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in this mesh")
        return self._groups[key]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in this mesh")
        return self.coords[axis]

    def folded(self, name: str = "lm") -> "Mesh":
        """The same ranks as a 1-D mesh on one axis ``name`` (ranks in row
        order), over the group of all this mesh's axes: no new group, so a
        rank may fold alone."""
        whole = self._groups[self.axis_names]
        return Mesh(self.ranks.reshape(-1), (name,), self.device, {(name,): whole})

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords}, device={self.device})"


def _world(n_devices: int | None, device) -> tuple[np.ndarray, torch.device]:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no default process group: call torch.distributed."
            "init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) on every rank first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh's ranks run on the card by default; "
                "pass device=\"cpu\" to run on the CPU")
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return np.arange(n), torch.device(device)


def make_mesh(n_devices: int | None = None, axis_names=("lm", "model"),
              device=None) -> Mesh:
    """The first ``n_devices`` ranks (all by default) as an (lm, model)
    mesh: 'lm' shards landmark / observation blocks, 'model' is kept at 1.
    Each rank's device is ``cuda:{rank % device_count}`` unless ``device``
    names one. Needs an initialized default process group; every rank of
    the world calls it."""
    ranks, dev = _world(n_devices, device)
    return Mesh(ranks.reshape(len(ranks), 1), axis_names, dev)


def make_mesh_2d(n_devices: int | None = None, kf: int = 2, axis_names=("kf", "lm"),
                 device=None) -> Mesh:
    """A (kf, lm) mesh for the keyframe- and landmark-sharded BA: 'kf'
    shards the reduced camera system's column blocks, 'lm' the landmark
    blocks. kf is the largest divisor of the rank count not above the one
    asked for, as in the JAX package."""
    ranks, dev = _world(n_devices, device)
    n = len(ranks)
    kf = max(1, min(kf, n))
    while n % kf:
        kf -= 1
    return Mesh(ranks.reshape(kf, n // kf), axis_names, dev)


def gather_blocks(block: torch.Tensor, offset: int, total: int, mesh: Mesh,
                  axes) -> torch.Tensor:
    """The whole [total, ...] array on every rank of ``mesh.group(axes)``
    from each rank's rows [offset, offset + len(block)): each rank writes
    its block into zeros and the ranks sum. Adding zeros is exact, so every
    rank gets the same bits. Booleans travel as uint8."""
    dtype = block.dtype
    wire = block.to(torch.uint8) if dtype == torch.bool else block
    full = torch.zeros((total,) + tuple(block.shape[1:]), dtype=wire.dtype,
                       device=block.device)
    full[offset:offset + block.shape[0]] = wire
    dist.all_reduce(full, group=mesh.group(axes))
    return full.to(dtype) if dtype == torch.bool else full

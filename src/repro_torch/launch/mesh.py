"""The mesh on ``torch.distributed``, from ``src/repro/launch/mesh.py``.

A mesh names the axes (pod, data, model) of the processes, one card each,
in row-major order: the process of rank ``r`` sits at the coordinates of
``r`` in the mesh's shape.  ``pod`` and ``data`` are the data-parallel
axes, and the standard step also splits params over ``data`` (FSDP);
``model`` is tensor (and expert) parallelism.  ``Mesh.axes(names)`` is
one set of those axes as a process group (``DPAxes``): this process's
index along them, their extent, and the collectives the train step and
the model's parallel layers (``models/parallel.py``) hand their tensors
to; ``Mesh.model_axes()`` and ``Mesh.data_axes()`` are the ``model`` and
the ``data`` axis alone.  The
collectives count the bytes they are handed in ``COMM`` (``comm_reset`` /
``comm_snapshot``), the figure ``core/buckets.dp_comm_model`` models for
the data-parallel axes.

On gloo only ``all_reduce`` and ``broadcast`` take CUDA tensors (the
backend table of ``torch.distributed``), and its ``all_gather`` and
``reduce_scatter`` run at a third to a half of its broadcast's and
all-reduce's rate: an axes object of a gloo group (chosen by the group's
backend when the mesh is made) runs ``all_gather`` as one ``broadcast``
per process into its block of the output, and ``reduce_scatter`` as
broadcasts of each block to its owner, who sums them (one per pair of
processes: at 2 processes the least that must move), on CUDA tensors as
they are, and counts them as the collective they stand for.  That is how two processes
share one card (NCCL refuses two ranks on one device).

The mesh uses the default process group, so the caller starts it first
(``launch/train.maybe_init_distributed``; NCCL for CUDA tensors, gloo for
CPU ones).  ``single_device_mesh()`` is the (1, 1) mesh of one process,
which needs no process group.  ``make_production_mesh`` and
``shard_map_compat`` have no counterpart: there is no SPMD partitioner to
configure.
"""
from __future__ import annotations

import itertools
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")
DP_AXES = ("pod", "data")

# Bytes handed to each kind of collective (``all_reduce``, ``reduce_scatter``,
# ``all_gather``: the input, the input, the gathered output) and the calls
# of each (``<kind>_calls``), in all and over each set of axes
# (``<kind>@pod+data``); ``scalars_calls`` counts the calls on a handful of
# scalars (metrics, verdicts, norms), whose bytes are not counted.
COMM: Counter = Counter()


def comm_reset() -> None:
    COMM.clear()


def comm_snapshot() -> Dict[str, int]:
    return dict(COMM)


class DPAxes:
    """Axes of a mesh as one process group: data-parallel ones, or the
    ``model`` axis alone.

    ``index`` is this process's combined index over ``names``
    (major-to-minor in the given order, the row order of the gathered and
    scattered stacks), ``size`` their extent.  ``group`` None means no
    process group (a one-process mesh): every collective is then the
    identity and counts nothing.  ``stage`` (a gloo group) runs
    ``reduce_scatter`` and ``all_gather`` through gloo's ``broadcast``
    (module docstring)."""

    def __init__(self, names: Tuple[str, ...], size: int, index: int, group=None,
                 stage: bool = False):
        self.names = tuple(names)
        self.size = int(size)
        self.index = int(index)
        self.group = group
        self.stage = bool(stage)

    def __repr__(self) -> str:
        return f"DPAxes({self.names}, size={self.size}, index={self.index})"

    def _count(self, kind: str, nbytes: int) -> None:
        # by kind, and by kind over these axes ("all_reduce@data")
        for key in (kind, f"{kind}@{'+'.join(self.names)}"):
            COMM[key] += nbytes
            COMM[key + "_calls"] += 1

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``: the largest of) ``t`` over the axes, in
        place; returns ``t``."""
        if self.group is None:
            return t
        self._count("all_reduce", t.numel() * t.element_size())
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        return t

    def all_reduce_scalars(self, values: torch.Tensor) -> torch.Tensor:
        """Sum a small vector of scalars over the axes (out of place)."""
        if self.group is None:
            return values
        out = values.clone()
        COMM["scalars_calls"] += 1
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Sum ``t`` over the axes and keep this process's block along
        ``dim`` (0: its block of rows; ``t.shape[dim]`` must divide by
        ``size``)."""
        if self.group is None:
            return t
        dim = dim % t.dim()
        if t.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: {t.shape[dim]} rows over {self.size} processes")
        self._count("reduce_scatter", t.numel() * t.element_size())
        src = t.movedim(dim, 0).contiguous()
        n = src.shape[0] // self.size
        if self.stage:
            # each block's owner receives it from every other process in
            # turn (one broadcast each) and sums it onto its own, in rank
            # order
            ranks = dist.get_process_group_ranks(self.group)
            blocks = src.split(n)
            out = blocks[self.index].clone()
            buf = torch.empty_like(out)
            for owner in range(self.size):
                for sender in range(self.size):
                    if sender == owner:
                        continue
                    x = blocks[owner] if sender == self.index else buf
                    dist.broadcast(x, src=ranks[sender], group=self.group)
                    if owner == self.index:
                        out += buf
        else:
            out = src.new_empty((n,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=self.group)
        return out.movedim(0, dim).contiguous() if dim else out

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every process's ``t`` concatenated along ``dim`` (0: stacked
        rows) in index order."""
        if self.group is None:
            return t
        dim = dim % t.dim()
        src = t.movedim(dim, 0).contiguous()
        n = src.shape[0]
        out = src.new_empty((n * self.size,) + tuple(src.shape[1:]))
        self._count("all_gather", out.numel() * out.element_size())
        if self.stage:
            out[self.index * n:(self.index + 1) * n].copy_(src)
            ranks = dist.get_process_group_ranks(self.group)
            for i, block in enumerate(out.split(n)):
                dist.broadcast(block, src=ranks[i], group=self.group)
        else:
            dist.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous() if dim else out


class Mesh:
    """Axis names, extents and this process's coordinates, with a process
    group per set of data-parallel axes and one for ``model`` (``axes``)."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...], rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None, stage: bool = False):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.size = 1
        for s in self.shape.values():
            self.size *= s
        coords, r = {}, self.rank
        for a in reversed(self.axis_names):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.coords = {a: coords[a] for a in self.axis_names}
        self._groups = dict(groups or {})
        self.stage = bool(stage)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans processes (its collectives are real)."""
        return bool(self._groups)

    @property
    def tp(self) -> int:
        """The ``model`` extent (1 without the axis)."""
        return self.shape.get("model", 1)

    def axes(self, names: Sequence[str]) -> DPAxes:
        """The data-parallel axes ``names`` (taken in (pod, data) order,
        the order of the ranks in their group), or ``("model",)``, as a
        ``DPAxes``."""
        if tuple(names) != ("model",):
            for a in names:
                if a not in self.axis_names or a not in DP_AXES:
                    raise ValueError(f"{a!r} is not a data-parallel axis of {self.axis_names}")
            names = tuple(a for a in DP_AXES if a in names)
        elif "model" not in self.axis_names:
            return DPAxes(("model",), 1, 0)
        index = 0
        for a in names:
            index = index * self.shape[a] + self.coords[a]
        return DPAxes(names, axes_size(self, names), index, self._groups.get(names),
                      stage=self.stage)

    def model_axes(self) -> DPAxes:
        """The ``model`` axis as a ``DPAxes`` (extent 1 without one)."""
        return self.axes(("model",))

    @property
    def dp(self) -> int:
        """The ``data`` extent (1 without the axis)."""
        return self.shape.get("data", 1)

    def data_axes(self) -> DPAxes:
        """The ``data`` axis alone as a ``DPAxes`` (extent 1 without one):
        the group FSDP gathers its blocks over and reduce-scatters their
        gradients over (``models/parallel.gather_from_data``)."""
        if "data" not in self.axis_names:
            return DPAxes(("data",), 1, 0)
        return self.axes(("data",))


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None) -> Mesh:
    """A mesh over the processes of the default group, as the reference's
    ``make_mesh``: axes ("data", "model") for up to two dims, else ("pod",
    "data", "model").  The shape's product must be the world size; every
    process builds the same groups in the same order, as
    ``torch.distributed.new_group`` requires."""
    if axes is None:
        axes = ("data", "model")[: len(shape)] if len(shape) <= 2 else AXES
    axes = tuple(axes)
    if len(axes) != len(shape) or set(axes) - set(AXES):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    extents = dict(zip(axes, shape))
    rank, world = _world()
    total = 1
    for s in shape:
        total *= s
    if total != world:
        raise ValueError(f"mesh {dict(extents)} has {total} places for {world} processes")
    groups: Dict[Tuple[str, ...], object] = {}
    stage = False
    if dist.is_available() and dist.is_initialized():
        stage = dist.get_backend() == "gloo"
        dp = tuple(a for a in DP_AXES if a in axes)
        layout = Mesh(axes, shape)
        subsets = [s for k in range(1, len(dp) + 1) for s in itertools.combinations(dp, k)]
        if extents.get("model", 1) > 1:
            subsets.append(("model",))
        for subset in subsets:
            if axes_size(layout, subset) == 1 < world:
                continue  # an axis of extent 1 needs no group: its collectives are identities
            if axes_size(layout, subset) == world:
                groups[subset] = dist.group.WORLD
                continue
            # the processes that differ only along ``subset``
            parts: Dict[Tuple[int, ...], list] = {}
            for r in range(world):
                c = Mesh(axes, shape, r).coords
                parts.setdefault(tuple(c[a] for a in axes if a not in subset), []).append(r)
            for ranks in parts.values():
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[subset] = g
    return Mesh(axes, shape, rank, groups, stage)


def single_device_mesh() -> Mesh:
    """The (1, 1) mesh of one process: no process group, no collective."""
    return Mesh(("data", "model"), (1, 1))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def axes_size(mesh, axes: Sequence[str]) -> int:
    """Product of the mesh extents of ``axes`` (the DP replica count for the
    batch axes; the shard count for the ZeRO state layout)."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def barrier(mesh) -> None:
    """Wait for every process of a mesh that spans processes."""
    if mesh is not None and mesh.distributed:
        dist.barrier()

"""How the port runs a step on a device mesh: state at rest as DTensors,
compute on plain local tensors, collectives where the shards meet.

* At rest every leaf is a ``DTensor`` with its ``sharding`` placements
  (``distribute_tree``): each rank holds only its shard.
* For a step, ``gather`` makes a rank's compute copy of a leaf: the full
  tensor (an all-gather over the mesh dims that shard it, as FSDP gathers
  on use), or with ``keep`` the local shard over those mesh dims (the
  expert-parallel weights stay split over ``model``).  Model code, and so
  every hand kernel, sees plain local tensors: no DTensor reaches a
  kernel's extension call (``kernels.check_device`` raises on one).
* The data axes (``sharding.DATA_AXES`` present in the mesh) split the
  batch: each rank takes its rows (``local_rows``) by the batch spec, and
  every sum over the batch (the loss, its token count, the MoE aux mean,
  the gradients) is reduced over ALL data axes of the mesh.  Where the
  batch spec falls back and rows repeat over a data axis, numerator and
  denominator repeat alike, so every reduction stays exact.
* ``sum_across`` (forward all-reduce, backward identity) and
  ``copy_into`` (forward identity, backward all-reduce) are the two
  differentiable collectives: each rank backpropagates the same cotangent
  of a value all ranks hold, and a gradient that several ranks add parts
  of is summed where it leaves their region.
* A mesh dim of size 1 needs no communication: ``redistribute`` relabels
  its placements, so a one-rank mesh moves no bytes and copies nothing.

All ranks run the same program in the same order (SPMD); a collective is
made over the process group of one mesh dim at a time.
"""
from __future__ import annotations

import math
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (
    DATA_AXES,
    MODEL_AXIS,
    axis_names,
    batch_spec,
    spec_placements,
    tree_map_with_path,
)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sizes(mesh) -> List[int]:
    return [int(s) for s in tuple(mesh.shape)]


def data_dims(mesh) -> List[int]:
    """The mesh dims of the data axes present, in mesh order."""
    names = axis_names(mesh)
    return [i for i, a in enumerate(names) if a in DATA_AXES]


def model_dim(mesh) -> Optional[int]:
    names = axis_names(mesh)
    return names.index(MODEL_AXIS) if MODEL_AXIS in names else None


def coordinate(mesh) -> List[int]:
    """This rank's coordinate on ``mesh``; raises if it holds none."""
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh}")
    return list(c)


# ---------------------------------------------------------------- shards

def _split(shape, mesh, placements):
    """For each tensor dim, the mesh dims that shard it, in mesh order."""
    from torch.distributed.tensor import Shard
    by_dim: dict = {}
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            by_dim.setdefault(pl.dim % len(shape), []).append(i)
    return by_dim


def check_even(shape, mesh, placements) -> None:
    """Raise unless every sharded dim divides exactly: the port never
    takes DTensor's uneven shards."""
    sizes = _sizes(mesh)
    for d, dims in _split(shape, mesh, placements).items():
        n = math.prod(sizes[i] for i in dims)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over {n} ranks ({placements})")


def local_shard(full, mesh, placements):
    """This rank's shard of a tensor every rank holds whole: a view (no
    communication); dims sharded over several mesh dims split major
    first."""
    check_even(tuple(full.shape), mesh, placements)
    sizes = _sizes(mesh)
    coord = coordinate(mesh)
    out = full
    for d, dims in _split(tuple(full.shape), mesh, placements).items():
        n, idx = 1, 0
        for i in dims:
            idx = idx * sizes[i] + coord[i]
            n *= sizes[i]
        step = full.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out


def distribute(full, mesh, placements):
    """A DTensor of ``full`` (the same on every rank) with ``placements``:
    each rank keeps its own shard, contiguous (the tensor itself where
    the shard is all of it)."""
    from torch.distributed.tensor import DTensor
    local = local_shard(full, mesh, placements).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def distribute_tree(tree, shardings):
    """Every leaf of ``tree`` as a DTensor by the ``NamedSharding`` at the
    same place in ``shardings``."""
    flat = {}
    tree_map_with_path(lambda p, s: flat.__setitem__(p, s), shardings)
    return tree_map_with_path(
        lambda p, x: distribute(x, flat[p].mesh, flat[p].placements), tree)


def redistribute(x, placements):
    """``x.redistribute(placements)``, relabelled without communication
    on the mesh dims of size 1 (where a shard is the whole)."""
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    placements = tuple(placements)
    sizes = _sizes(mesh)
    moving = [i for i, (a, b) in enumerate(zip(x.placements, placements))
              if a != b]
    if all(sizes[i] == 1 for i in moving):
        return DTensor.from_local(x.to_local(), mesh, placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    if any(sizes[i] > 1 for i in moving):
        # the size-1 dims first, then DTensor moves the rest
        mid = tuple(placements[i] if sizes[i] == 1 else x.placements[i]
                    for i in range(len(sizes)))
        x = redistribute(x, mid)
    return x.redistribute(mesh, placements)


def gather(x, keep: Iterable[int] = ()):
    """A rank's compute copy of a DTensor leaf: replicated over every mesh
    dim but those in ``keep`` (which stay as they are), as a plain local
    tensor.  No copy where nothing moves."""
    from torch.distributed.tensor import Replicate
    keep = set(keep)
    target = tuple(pl if i in keep else Replicate()
                   for i, pl in enumerate(x.placements))
    return redistribute(x, target).to_local()


def local_rows(x, mesh):
    """This rank's rows of a batch-major tensor every rank holds whole,
    by the batch spec of its shape (a view)."""
    return local_shard(x, mesh, spec_placements(
        mesh, batch_spec(mesh, tuple(x.shape))))


def gather_rows(x, mesh, full_batch: int):
    """The whole batch from each rank's rows ``x`` (the inverse of
    ``local_rows`` for a batch of ``full_batch`` rows)."""
    from torch.distributed.tensor import DTensor
    shape = (full_batch,) + tuple(x.shape[1:])
    placements = spec_placements(mesh, batch_spec(mesh, shape))
    dt = DTensor.from_local(x, mesh, placements, run_check=False,
                            shape=torch.Size(shape),
                            stride=torch.empty(shape, device="meta").stride())
    return gather(dt)


def expert_parallel(cfg, mesh, path) -> bool:
    """Whether the leaf at ``path`` is an expert weight that stays split
    over ``model`` for compute (``tp_ep`` on a mesh with a model axis)."""
    names = tuple(path)
    return (cfg.sharding_profile == "tp_ep" and model_dim(mesh) is not None
            and len(names) >= 2 and names[-2] == "moe"
            and names[-1] in ("wi", "wg", "wo"))


def gather_params(cfg, mesh, params):
    """(compute, placements): each DTensor leaf of ``params`` gathered for
    compute (``gather``; the expert-parallel weights keep their ``model``
    shard), detached, and {path: the placements of that compute copy}."""
    from torch.distributed.tensor import Replicate
    md = model_dim(mesh)
    placements = {}

    def one(path, x):
        keep = [md] if expert_parallel(cfg, mesh, path) else []
        placements[path] = tuple(pl if i in keep else Replicate()
                                 for i, pl in enumerate(x.placements))
        return gather(x, keep).detach()
    return tree_map_with_path(one, params), placements


def to_dtensors(tree, mesh, placements):
    """Plain local tensors as DTensors, each with ``placements[path]`` (or
    ``placements`` itself for a single tensor); no communication."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        return DTensor.from_local(tree, mesh, placements, run_check=False)
    return tree_map_with_path(
        lambda p, t: DTensor.from_local(t, mesh, placements[p],
                                        run_check=False), tree)


def local(tree):
    """Each DTensor leaf's local tensor (sharing its storage)."""
    return tree_map_with_path(
        lambda _, x: x.to_local() if is_dtensor(x) else x, tree)


# ---------------------------------------------------------------- collectives

def _group(mesh, dim: int):
    return mesh.get_group(dim)


def all_reduce_(t, mesh, dims: Sequence[int]):
    """Sum ``t`` in place over the mesh dims ``dims`` (one group after
    another); gloo reduces 16-bit floats through a float32 copy."""
    for d in dims:
        if _sizes(mesh)[d] == 1:
            continue
        g = _group(mesh, d)
        if t.dtype in (torch.bfloat16, torch.float16) and \
                dist.get_backend(g) == "gloo":
            f = t.float()
            dist.all_reduce(f, group=g)
            t.copy_(f)
        else:
            dist.all_reduce(t, group=g)
    return t


class _SumAcross(torch.autograd.Function):
    """Forward: the sum over the ranks of ``dims``; backward: identity
    (every rank holds the sum and backpropagates its own cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return all_reduce_(x.clone(), mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyInto(torch.autograd.Function):
    """Forward: identity; backward: the sum over the ranks of ``dims`` of
    the cotangent (a region whose ranks each add part of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.dims), None, None


def sum_across(x, mesh, dims: Sequence[int]):
    dims = tuple(dims)
    if not dims:
        return x
    return _SumAcross.apply(x, mesh, dims)


def mean_across(x, mesh, dims: Sequence[int]):
    n = math.prod(_sizes(mesh)[d] for d in dims)
    return sum_across(x / n, mesh, dims) if dims else x


def copy_into(x, mesh, dims: Sequence[int]):
    dims = tuple(dims)
    if not dims:
        return x
    return _CopyInto.apply(x, mesh, dims)


# ---------------------------------------------------------------- norms

def replicas(x) -> int:
    """How many ranks hold each element of DTensor ``x``'s shards."""
    from torch.distributed.tensor import Replicate
    sizes = _sizes(x.device_mesh)
    return math.prod(sizes[i] for i, pl in enumerate(x.placements)
                     if isinstance(pl, Replicate))


def global_norm(leaves: Sequence[Any]) -> torch.Tensor:
    """The global L2 norm of DTensor leaves from their local shards: each
    shard's sum of squares over its replica count, summed over the whole
    mesh in one all-reduce."""
    mesh = leaves[0].device_mesh
    parts = [torch.sum(torch.square(x.to_local().float())) / replicas(x)
             for x in leaves]
    total = torch.sum(torch.stack(parts))
    all_reduce_(total, mesh, range(len(_sizes(mesh))))
    return torch.sqrt(total)

"""How the port runs a step on a device mesh: state at rest as DTensors,
compute on plain local tensors, collectives where the shards meet.

* At rest every leaf is a ``DTensor`` with its ``sharding`` placements
  (``distribute_tree``): each rank holds only its shard.
* For a step, ``gather_params`` makes a rank's compute copy of each
  leaf: gathered over the data axes (as FSDP gathers on use) and kept as
  its ``model`` shard, on which the layers compute tensor-parallel
  (``TensorParallel``, the JAX package's GSPMD split of each product over
  ``model``).  Model code, and so every hand kernel, sees plain local
  tensors: no DTensor reaches a kernel's extension call
  (``kernels.check_device`` raises on one).
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
  A ``model`` axis of one rank takes the unsharded ops
  (``tensor_parallel`` gives ``ONE``, whose every op is the identity).
* A gloo group carries a CUDA tensor's collective through host memory
  (``STAGED`` counts them by op and dtype).

All ranks run the same program in the same order (SPMD); a collective is
made over the process group of one mesh dim at a time.
"""
from __future__ import annotations

import functools
import math
from collections import Counter
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (
    DATA_AXES,
    MODEL_AXIS,
    axis_names,
    batch_spec,
    cache_spec,
    param_spec,
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
    each rank keeps its own shard in storage of its own (the tensor itself
    where the shard is all of it), so that ``full`` can be freed."""
    from torch.distributed.tensor import DTensor
    local = local_shard(full, mesh, placements)
    local = (local.contiguous() if local.numel() == full.numel()
             else local.clone(memory_format=torch.contiguous_format))
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


def gather_params(cfg, mesh, params):
    """(compute, placements): each DTensor leaf of ``params`` as a rank's
    compute copy, detached, and {path: the placements of that copy}.

    The compute rule: a leaf keeps its shard over ``model`` (the layers
    compute on it, Megatron-style: ``TensorParallel``) and is gathered over
    the data axes only, as FSDP gathers on use; a leaf the spec leaves
    whole over ``model`` stays whole.  The gradient of a compute copy is
    therefore the gradient of this rank's ``model`` shard."""
    from torch.distributed.tensor import Replicate
    md = model_dim(mesh)
    keep = [] if md is None else [md]
    placements = {}

    def one(path, x):
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


# (op, dtype) -> how many collectives went through host memory: a gloo
# group's collectives on CUDA tensors (``_host_staged``)
STAGED: Counter = Counter()


def _host_staged(t, g, op: str):
    """``t`` on the host for a collective on group ``g``: a gloo group
    carries CUDA tensors through host memory here (counted in ``STAGED``),
    and sums 16-bit floats in float32.  Returns (tensor to hand the
    collective, whether it is a copy of ``t``)."""
    if dist.get_backend(g) != "gloo":
        return t, False
    h = t
    if t.is_cuda:
        STAGED[(op, str(t.dtype).removeprefix("torch."))] += 1
        h = t.cpu()
    if op in ("all_reduce", "reduce_scatter") and t.dtype in (
            torch.bfloat16, torch.float16):
        h = h.float()
    return h, h is not t


def all_reduce_(t, mesh, dims: Sequence[int], op=None):
    """Reduce ``t`` in place over the mesh dims ``dims`` (one group after
    another; a sum unless ``op``); gloo reduces 16-bit floats through a
    float32 copy and CUDA tensors through host memory."""
    op = dist.ReduceOp.SUM if op is None else op
    for d in dims:
        if _sizes(mesh)[d] == 1:
            continue
        g = _group(mesh, d)
        h, copied = _host_staged(t, g, "all_reduce")
        dist.all_reduce(h, op=op, group=g)
        if copied:
            t.copy_(h)
    return t


def all_gather(t, mesh, dim: int, tensor_dim: int):
    """The ranks' ``t`` over mesh dim ``dim`` joined along ``tensor_dim``,
    in rank order (no gradient; ``TensorParallel.gather`` has one)."""
    n = _sizes(mesh)[dim]
    if n == 1:
        return t
    g = _group(mesh, dim)
    h, copied = _host_staged(t.contiguous(), g, "all_gather")
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=g)
    out = torch.cat(parts, tensor_dim)
    return out.to(t.device) if copied else out


def reduce_scatter(t, mesh, dim: int, tensor_dim: int):
    """This rank's block along ``tensor_dim`` of the sum over mesh dim
    ``dim``'s ranks of ``t`` (no gradient): ``all_reduce_`` and a narrow,
    at a 1/m share of the bytes."""
    n = _sizes(mesh)[dim]
    if n == 1:
        return t
    g = _group(mesh, dim)
    h, _ = _host_staged(t.movedim(tensor_dim, 0).contiguous(), g,
                        "reduce_scatter")
    out = h.new_empty((h.shape[0] // n,) + tuple(h.shape[1:]))
    # ``reduce_scatter_single`` is the newer name of the same collective
    rs = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    rs(out, h, group=g)
    return out.to(device=t.device, dtype=t.dtype).movedim(0, tensor_dim)


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


class _GatherAcross(torch.autograd.Function):
    """Forward: the ranks' ``x`` over ``dim`` joined along ``tensor_dim``;
    backward: this rank's slice of the cotangent, summed over the ranks
    first where each holds only its part of it (``partial``)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, tensor_dim, partial):
        ctx.mesh, ctx.dim, ctx.partial = mesh, dim, partial
        ctx.tensor_dim, ctx.n = tensor_dim, x.shape[tensor_dim]
        return all_gather(x, mesh, dim, tensor_dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = reduce_scatter(g, ctx.mesh, ctx.dim, ctx.tensor_dim)
        else:
            j = coordinate(ctx.mesh)[ctx.dim]
            g = g.narrow(ctx.tensor_dim, j * ctx.n, ctx.n)
        return g, None, None, None, None


class TensorParallel:
    """This rank's place on a mesh's ``model`` axis: the Megatron
    collectives of a layer whose weights are ``model`` shards
    (``gather_params``' compute copies).  Without a mesh, or with one rank
    on ``model``, every op is the identity (``ONE``), so a layer written
    once takes the unsharded ops there.

    A tensor-parallel region starts with ``copy`` of its replicated input
    (forward identity, backward the sum of the ranks' partial gradients)
    and ends with ``sum`` of the ranks' partial outputs (forward sum,
    backward identity).  Inside it, each rank's cotangents are its part of
    the whole: a replicated leaf used there goes through ``copy`` too (its
    gradient comes out whole on every rank), and ``gather`` joins the
    ranks' column blocks of an activation (backward: the reduce-scatter
    of the cotangent).  ``whole`` gathers where the consumer is
    replicated (backward: the own block alone).

    Which leaves are split is read from the specs alone
    (``param_dim``, ``cache_dim``, ``over``)."""

    def __init__(self, mesh=None):
        md = None if mesh is None else model_dim(mesh)
        self.size = 1 if md is None else _sizes(mesh)[md]
        if self.size == 1:
            mesh = md = None
        self.mesh, self.dim = mesh, md

    @functools.cached_property
    def rank(self) -> int:
        """This rank's place on ``model`` (read on first use: the specs
        alone can be asked of an ``AbstractMesh``, which has no ranks)."""
        return 0 if self.mesh is None else coordinate(self.mesh)[self.dim]

    def _model_entry(self, spec) -> Optional[int]:
        for d, e in enumerate(spec):
            if MODEL_AXIS in (e if isinstance(e, tuple) else (e,)):
                return d
        return None

    def param_dim(self, cfg, path, shape) -> Optional[int]:
        """The dim of a parameter of whole ``shape`` at ``path`` (its last
        two names are what ``sharding.param_spec`` reads) that the spec
        splits over ``model``; None where it stays whole."""
        if self.mesh is None:
            return None
        return self._model_entry(param_spec(cfg, self.mesh, path, shape))

    def cache_dim(self, cfg, path, shape) -> Optional[int]:
        """As ``param_dim``, for a decode-cache leaf (``cache_spec``)."""
        if self.mesh is None:
            return None
        return self._model_entry(cache_spec(cfg, self.mesh, path, shape))

    def over(self, cfg, path, shape) -> "TensorParallel":
        """This one where the spec splits the parameter at ``path`` over
        ``model``, else ``ONE``: the layer's weights are whole."""
        return ONE if self.param_dim(cfg, path, shape) is None else self

    def copy(self, x):
        return x if self.mesh is None else copy_into(x, self.mesh,
                                                     [self.dim])

    def sum(self, x):
        return x if self.mesh is None else sum_across(x, self.mesh,
                                                      [self.dim])

    def gather(self, x, d: int = -1):
        if self.mesh is None:
            return x
        return _GatherAcross.apply(x, self.mesh, self.dim, d % x.dim(), True)

    def whole(self, x, d: int = -1):
        if self.mesh is None:
            return x
        return _GatherAcross.apply(x, self.mesh, self.dim, d % x.dim(),
                                   False)

    def shard(self, x, d: int = -1):
        """This rank's block of ``x`` along ``d`` (a view)."""
        if self.mesh is None:
            return x
        n = x.shape[d] // self.size
        return x.narrow(d, self.rank * n, n)

    def max(self, x):
        """The elementwise maximum over the ranks (no gradient)."""
        if self.mesh is None:
            return x.detach()
        return all_reduce_(x.detach().clone(), self.mesh, [self.dim],
                           dist.ReduceOp.MAX)


ONE = TensorParallel()


def tensor_parallel(mesh) -> TensorParallel:
    """The ``TensorParallel`` of ``mesh``: ``ONE`` where there is no mesh
    or its ``model`` axis has one rank."""
    tp = ONE if mesh is None else TensorParallel(mesh)
    return ONE if tp.mesh is None else tp


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

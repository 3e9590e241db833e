"""One-device dry run: reckon an (arch x shape) cell's device bytes, FLOPs
and kernel calls without allocating (the port's counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell for a pod).

Under ``FakeTensorMode``, the cell builds its state the way its path
builds it and runs one step of the path's own function:

  train    f32 master params, Adam moments in ``optstate_dtype`` and step
           (``make_train_state``'s layout), then ``build_train_step``: the
           bf16 compute cast, gradients, microbatches, AdamW;
  fused    a ``FusedEnsemble``'s stacked members (``members``), then one
           cycle's device part (``core.ensemble.device_cycle``);
  prefill  bf16 params, then ``build_prefill_step`` with its cache;
  decode   bf16 params and a cache of ``seq`` positions (an
           encoder-decoder's with the encoder's cross-attention k, v),
           then one ``build_serve_step`` step.

The step runs under ``MemoryTracker`` (the peak of live device bytes, each
storage rounded up to the caching allocator's 512-byte blocks, from its
first op to its last reference) and ``roofline.op_costs.OpCounter``.  The
hand kernels' launchers take their fake-tensor route: ``kernels.
FAKE_CALLS`` is the tally of kernel calls (``LAUNCHES``' keys), and their
``cost()`` joins the counter's.  A cell reports the peak, the parameter,
state and cache bytes, the tally, the ``RooflineRow`` and whether it fits
the card (``fits``); a pod-scale cell that does not fit is reported, not
skipped.  ``host_alloc`` holds what the flash backward's C launcher
allocates outside PyTorch's allocator (its plans and scratch), which
``max_memory_allocated`` does not see.

The fake tensors stand on the meta device (``FAKE_DEVICE``), in place of
the card, on every host: where no CUDA device is visible (a PyTorch build
without CUDA, or a process that hides the cards) the autograd engine
takes no CUDA-typed tensor, fake or not, and where one is, fake CUDA
tensors make ``FakeTensorMode`` put constants built by ``torch.tensor``
on the card.  The model code does not branch on the device, and the
launchers take fake tensors on either, so the cell's ops, calls and bytes
are the card's (gemma2-2b's train cell: the same calls, a peak 512 bytes
lower, its one constant scalar).

Production meshes (``--multi-pod``, ``--both-meshes``): the cell is
reckoned for ONE rank of ``pod16x16`` (256 ranks) or ``pod2x16x16`` (512),
as the reference lowers it for its meshes; ``--mesh DxM`` reckons one rank
of a ("data", "model") mesh of D x M ranks (the card's two-rank
tensor-parallel runs: ``--mesh 1x2``).  This process joins a fake
process group of that many ranks (``torch.testing._internal.distributed.
fake_pg``: every collective returns at once), builds the production mesh
over it, and lays the state out by ``dist.sharding.state_shardings`` as
DTensors whose local tensors have this rank's shard shapes; the step is
the path's own mesh step (``build_train_step(cfg, mesh=...)``,
``build_prefill_step(..., mesh=...)``, ``build_serve_step(...,
mesh=...)``) on the cell's global batch.  ``state_bytes`` is this rank's
(``state_bytes_exact``: the shards' bytes unrounded, each leaf's numel
over its shard count times its item size) and ``peak_bytes`` its step's
peak; ``fits`` holds that against one card.  The step computes on each
rank's ``model`` shards (tensor-parallel: ``dist.spmd.gather_params``), as
the reference's GSPMD step does.  The roofline's per-device
terms are this rank's ops; the model-FLOP share divides the model's FLOPs
by all ranks'.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k [--batch 4 --seq 1024]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape decode_32k [--multi-pod | --both-meshes | --mesh 1x2]
Results accumulate in $DRYRUN_DIR (default dryrun_results/) as
<arch>_<shape>_<mesh>.json (mesh ``h100``, ``pod16x16``, ``pod2x16x16``
or ``DxM``).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback
import weakref
from functools import partial
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import kernels
from repro_torch.configs import (
    SHAPES,
    cell_applicable,
    input_specs,
    list_configs,
    resolve_config,
)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.flash_attention.ops import bwd_host_alloc_bytes
from repro_torch.dist.sharding import state_shardings, tree_map_with_path
from repro_torch.launch.mesh import HW, PRODUCTION_MESHES, make_host_mesh
from repro_torch.optim.adamw import adamw_init, tree_map
from repro_torch.roofline.op_costs import OpCounter
from repro_torch.roofline.report import make_row

RESULTS_DIR = os.environ.get("DRYRUN_DIR", "dryrun_results")
BLOCK = 512          # the CUDA caching allocator's block granularity
MESH = "h100"
PROMPT = 16          # a decode cell's cache comes from a prompt this long


FAKE_DEVICE = torch.device("meta")   # where the fake tensors stand


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as the caching allocator counts it: whole 512-byte
    blocks (0 for an empty storage)."""
    return -(-nbytes // BLOCK) * BLOCK


class MemoryTracker(TorchDispatchMode):
    """Live bytes of the storages on ``device_type`` that ops make while it
    is active (and of tensors handed to ``track``): each counted from the
    op that makes it until its last reference goes, rounded by
    ``block_bytes``.  ``peak`` is the most at once.

    ``gather``'s backward (``new_zeros`` then ``scatter_add_``) scatters
    in place in eager mode; under a fake tensor or a dispatch mode
    PyTorch takes the out-of-place ``scatter_add`` instead, which would
    count a second tensor of the gathered input's size (a chunk's logits
    in the loss).  So a ``scatter_add`` into the zeros the op before made
    is counted as the in-place op: its result takes over the zeros'
    bytes.

    Likewise the autograd engine sums the gradients of a tensor used more
    than once in place into the first (``old.add_(new)``) where it holds
    the only reference, but never for a fake tensor or under a dispatch
    mode, where it takes ``old + new``: three buffers at once where eager
    mode has two (the f32 LM head's gradient, summed over the loss's
    sequence chunks, is 6.3 GB for nemotron-4-15b).  The engine sums while
    it hands a node's gradients on, so the first is a gradient an earlier
    node made: an ``add`` in a backward pass of two tensors of one shape
    and dtype whose first is a whole storage made by another node than the
    one running is counted as the in-place sum (its result takes over the
    first's bytes).  An ``add`` inside a node's backward (of two tensors it
    made itself) stays out of place, as eager mode runs it.  The engine's
    other condition, that it holds the buffer's only reference, is not
    checked."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.live = 0
        self.peak = 0
        self._sizes = WeakIdKeyDictionary()
        self._refs: Dict[int, Any] = {}
        self._zeros = None     # the storage the last op made by new_zeros
        # a backward pass's storages: the sequence number of the node that
        # made each
        self._made_in = WeakIdKeyDictionary()

    def track(self, *trees) -> None:
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor) and \
                    t.device.type == self.device_type:
                self._add(t.untyped_storage())

    def _add(self, st) -> None:
        if st in self._sizes:
            return
        n = block_bytes(st.nbytes())
        self._sizes[st] = n
        self._refs[id(st)] = weakref.ref(st, partial(self._free, n, id(st)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int, key: int, _ref) -> None:
        self.live -= n
        self._refs.pop(key, None)

    def _adopt(self, old, new) -> None:
        """``new`` holds ``old``'s bytes from now on (an in-place op)."""
        ref = self._refs.pop(id(old), None)
        if ref is None:
            return
        n = self._sizes[old]
        self._sizes[new] = n
        self._refs[id(new)] = weakref.ref(new, partial(self._free, n,
                                                       id(new)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        zeros, self._zeros = self._zeros, None
        node = (torch._C._current_autograd_node()
                if torch._C._current_graph_task_id() != -1 else None)
        node = node and node._sequence_nr()   # the node running, if any
        if func is torch.ops.aten.new_zeros.default:
            self._zeros = out.untyped_storage()
        elif (func is torch.ops.aten.scatter_add.default
              and zeros is not None
              and args[0].untyped_storage() is zeros):
            self._adopt(zeros, out.untyped_storage())
        elif (func is torch.ops.aten.add.Tensor and node is not None
              and _gradient_sum(args, out)
              and self._made_in.get(args[0].untyped_storage(),
                                    node) != node):
            self._adopt(args[0].untyped_storage(), out.untyped_storage())
        if node is not None:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._made_in.setdefault(t.untyped_storage(), node)
        self.track(out)
        return out


def _gradient_sum(args, out) -> bool:
    """Whether ``add(*args) -> out`` may be the autograd engine's sum of
    two gradients of one tensor: two tensors of ``out``'s shape and dtype,
    the first holding its whole storage."""
    if len(args) != 2 or not all(isinstance(a, torch.Tensor) for a in args):
        return False
    old, new = args
    return (old.shape == new.shape == out.shape
            and old.dtype == new.dtype == out.dtype
            and old.untyped_storage().nbytes()
            == old.numel() * old.element_size())


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _nbytes(tree) -> int:
    return sum(block_bytes(_local(t).untyped_storage().nbytes())
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _exact_bytes(tree) -> int:
    return sum(_local(t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _sharded(t, sharding, dev, dtype=None):
    """Zeros of this rank's shard of ``t``'s shape on ``dev`` as a DTensor
    with ``sharding``'s placements (no tensor of the whole is made)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    shape = list(t.shape)
    sizes = [int(n) for n in tuple(mesh.shape)]
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            if shape[pl.dim] % sizes[i]:
                raise ValueError(f"uneven shard of {tuple(t.shape)}")
            shape[pl.dim] //= sizes[i]
    local = torch.zeros(shape, dtype=dtype or t.dtype, device=dev)
    full = torch.Size(t.shape)
    return DTensor.from_local(
        local, mesh, sharding.placements, run_check=False, shape=full,
        stride=torch.empty(full, device="meta").stride())


class _Leaf:
    """A parameter's shape and dtype (what the specs and shards read)."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype


@functools.lru_cache(maxsize=32)
def _param_shapes(cfg: ModelConfig):
    """``init_params``' leaves as ``_Leaf``s, made once per config on fake
    tensors from a CPU generator (a fake tensor cannot draw from a CUDA
    one)."""
    from repro_torch.models import init_params
    with FakeTensorMode():
        params = init_params(cfg, torch.Generator().manual_seed(0))
        return tree_map(lambda t: _Leaf(t.shape, t.dtype), params)


def _params(cfg: ModelConfig, dev: torch.device, lead=(), mesh=None,
            dtype=None):
    """``init_params``' leaves (shapes, dtypes) as empty tensors on
    ``dev`` with ``lead`` axes in front; with ``mesh``, this rank's shards
    as DTensors by ``state_shardings`` (``dtype``: another dtype for every
    leaf, an optimizer moment's)."""
    shapes = _param_shapes(cfg)
    if mesh is not None:
        sh = {}
        tree_map_with_path(lambda p, s: sh.__setitem__(p, s),
                           state_shardings(cfg, mesh, shapes))
        return tree_map_with_path(
            lambda p, t: _sharded(t, sh[p], dev, dtype), shapes)
    return tree_map(lambda t: torch.empty(tuple(lead) + tuple(t.shape),
                                          dtype=dtype or t.dtype,
                                          device=dev), shapes)


def _scalar(mesh, dev, dtype=torch.int32):
    """A replicated 0-d zero: a DTensor on ``mesh``, or a tensor."""
    z = torch.zeros((), dtype=dtype, device=dev)
    if mesh is None:
        return z
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(z, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0 (every
    collective returns at once); a group already initialised with ``n``
    ranks is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"is initialised; this needs {n}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch(cfg, shape, dev, lead=()):
    return {k: torch.zeros(tuple(lead) + tuple(s.shape), dtype=s.dtype,
                           device=dev)
            for k, s in input_specs(cfg, shape).items()}


class _HostAlloc:
    """Cost sink: the flash backward's C-side bytes, the plans of the
    distinct launch shapes and the largest scratch of one launch."""

    def __init__(self):
        self.plans: Dict[tuple, int] = {}
        self.scratch = 0

    def __call__(self, name, flops, nbytes, launch):
        if name != "flash_attention_bwd" or launch.get("variant") != "wgmma":
            return
        shape = {k: v for k, v in launch.items() if k != "variant"}
        got = bwd_host_alloc_bytes(**shape)
        self.plans[tuple(sorted(shape.items()))] = got["plan"]
        self.scratch = max(self.scratch, got["scratch"])

    def result(self) -> dict:
        plans = sorted(self.plans.values())[-32:]   # kMaxPlans kept
        return {"flash_bwd_plans": sum(plans),
                "flash_bwd_scratch": self.scratch,
                "total": sum(plans) + self.scratch}


def reckon(cfg: ModelConfig, shape: ShapeSpec, *,
           microbatches: Optional[int] = None, members: int = 0,
           steps_per_cycle: int = 1, mesh=None) -> dict:
    """Reckon one cell; ``shape.kind`` picks the path (train, prefill,
    decode), ``members`` > 0 the fused ensemble of that many members at
    batch ``shape.global_batch`` each.  Allocates nothing on the card.
    ``mesh``: a ``DeviceMesh`` holding this rank (a fake group's): the
    cell is reckoned for this rank of it."""
    if mesh is not None and members:
        raise ValueError("a fused population is reckoned on one device")
    from repro_torch.core.ensemble import device_cycle
    from repro_torch.serve import build_prefill_step, build_serve_step
    from repro_torch.train import TrainHyper, build_train_step
    if microbatches:
        cfg = cfg.replace(microbatches=microbatches)
    if shape.kind != "train":
        cfg = cfg.replace(param_dtype="bfloat16")   # serving params
    dev = FAKE_DEVICE
    launches = dict(kernels.LAUNCHES)
    kernels.reset_fake_calls()
    host = _HostAlloc()
    B, S = shape.global_batch, shape.seq_len
    with FakeTensorMode(allow_non_fake_inputs=True), \
            torch.autograd.set_multithreading_enabled(False), \
            kernels.cost_sink(host), MemoryTracker(dev.type) as mem:
        cache_bytes = 0
        if members:
            md = {"float32": torch.float32,
                  "bfloat16": torch.bfloat16}[cfg.optstate_dtype]
            params = _params(cfg, dev, (members,))
            n0 = torch.zeros(members, dtype=torch.int32, device=dev)
            state = {"members": {
                "params": params,
                "opt": {"m": tree_map(lambda t: torch.zeros(
                            t.shape, dtype=md, device=dev), params),
                        "v": tree_map(lambda t: torch.zeros(
                            t.shape, dtype=md, device=dev), params),
                        "count": n0.clone()},
                "step": n0},
                "temps": torch.ones(members, device=dev),
                "cycle": torch.zeros((), dtype=torch.int32, device=dev)}
            batches = _batch(cfg, ShapeSpec("f", "prefill", S, B), dev,
                             (members, steps_per_cycle))
            batches["labels"] = torch.zeros_like(batches["tokens"])
            u = torch.full((members,), 0.5, device=dev)
            param_bytes = _nbytes(params)

            def step():
                device_cycle(cfg, steps_per_cycle, state, batches, u)
        elif shape.kind == "train":
            params = _params(cfg, dev, mesh=mesh)
            if mesh is None:
                opt = adamw_init(params, cfg.optstate_dtype)
            else:
                md = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[cfg.optstate_dtype]
                opt = {"m": _params(cfg, dev, mesh=mesh, dtype=md),
                       "v": _params(cfg, dev, mesh=mesh, dtype=md),
                       "count": _scalar(mesh, dev)}
            state = {"params": params, "opt": opt,
                     "step": _scalar(mesh, dev)}
            batch = _batch(cfg, shape, dev)
            param_bytes = _nbytes(params)
            train_step = build_train_step(
                cfg, TrainHyper(warmup=2, total_steps=1000), mesh=mesh)

            def step():
                train_step(state, batch)
        else:
            params = _params(cfg, dev, mesh=mesh)
            state = {"params": params}
            param_bytes = _nbytes(params)
            if shape.kind == "prefill":
                prefill = build_prefill_step(cfg, cache_len=S, mesh=mesh)
                batch = _batch(cfg, shape, dev)

                def step():
                    prefill(params, batch)
            else:
                # the cache of a short prompt (longer than the conv
                # windows, whose states it sets) at S positions
                prompt = torch.zeros((B, min(S, PROMPT)), dtype=torch.int32,
                                     device=dev)
                batch = {"tokens": prompt}
                if cfg.encoder_layers:   # and the encoder's cross k, v
                    batch["enc_frames"] = torch.zeros(
                        (B, cfg.encoder_seq, cfg.d_model),
                        dtype=torch.bfloat16, device=dev)
                cache = build_prefill_step(cfg, cache_len=S, mesh=mesh)(
                    params, batch)["cache"]
                tokens = prompt[:, :1]
                state["cache"] = cache
                cache_bytes = _nbytes(cache)
                positions = torch.full((B,), S - 1, dtype=torch.int32,
                                       device=dev)
                serve_step = build_serve_step(cfg, mesh=mesh)

                def step():
                    serve_step(params, cache, tokens, positions)
        state_bytes = _nbytes(state)
        state_exact = _exact_bytes(state)
        kernels.reset_fake_calls()   # the decode cache's prefill aside
        with OpCounter() as counter:
            step()
        peak = mem.peak
    if kernels.LAUNCHES != launches:
        raise AssertionError("a dry run launched a kernel")
    calls = {k: v for k, v in kernels.FAKE_CALLS.items() if v}
    flops_shape = (ShapeSpec(shape.name, shape.kind, S, B * members)
                   if members else shape)
    mesh_name, chips = MESH, 1
    if mesh is not None:
        mesh_name = mesh_label(mesh)
        chips = math.prod(int(n) for n in tuple(mesh.shape))
    row = make_row(cfg, flops_shape, mesh_name, chips, counter.costs,
                   memory_stats={"peak_bytes": float(peak),
                                 "param_bytes": float(param_bytes),
                                 "state_bytes": float(state_bytes),
                                 "cache_bytes": float(cache_bytes)})
    host_alloc = host.result()
    return {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
            "batch": B, "seq": S, "microbatches": cfg.microbatches,
            "members": members, "device": str(dev), "mesh": mesh_name,
            "chips": chips, "peak_bytes": peak, "param_bytes": param_bytes,
            "state_bytes": state_bytes, "state_bytes_exact": state_exact,
            "cache_bytes": cache_bytes,
            "host_alloc": host_alloc,
            "fits": peak + host_alloc["total"] <= HW.hbm_bytes,
            "hbm_bytes": HW.hbm_bytes, "kernel_calls": calls,
            "kernel_costs": {k: dict(v) for k, v in counter.kernels.items()},
            "roofline": row.to_dict()}


def mesh_label(mesh) -> str:
    """``pod16x16`` / ``pod2x16x16`` for the production meshes' shapes and
    axes, else the shape joined by ``x``."""
    shape = tuple(int(n) for n in tuple(mesh.shape))
    for name, (s, axes) in PRODUCTION_MESHES.items():
        if s == shape and tuple(axes) == tuple(mesh.mesh_dim_names):
            return name
    return "x".join(map(str, shape))


def parse_mesh(name: str):
    """(shape, axes) of a mesh name: a production mesh, or ``DxM`` for a
    ("data", "model") mesh of D x M ranks."""
    if name in PRODUCTION_MESHES:
        return PRODUCTION_MESHES[name]
    try:
        shape = tuple(int(n) for n in name.split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh {name!r}: want {sorted(PRODUCTION_MESHES)} "
                         "or DxM (data x model ranks)")
    return shape, ("data", "model")


def run_cell(arch: str, shape_name: str, *, batch: int = 0, seq: int = 0,
             save: bool = True, mesh: Optional[str] = None) -> dict:
    """One cell on one device, or (``mesh`` "pod16x16" / "pod2x16x16", or
    "DxM") for one rank of that mesh over a fake group.  ``arch`` is a
    registered name or ``<base>-L<n>`` (``configs.resolve_config``)."""
    cfg = resolve_config(arch)
    shape = SHAPES[shape_name]
    name = mesh or MESH
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        res = {"arch": arch, "shape": shape_name, "mesh": name,
               "status": "skipped", "reason": why}
        _save(res, save)
        return res
    if batch or seq:
        shape = ShapeSpec(shape.name, shape.kind, seq or shape.seq_len,
                          batch or shape.global_batch)
    t0 = time.time()
    try:
        if mesh is None:
            got = reckon(cfg, shape)
        else:
            dims, axes = parse_mesh(mesh)
            with fake_world(math.prod(dims)):
                got = reckon(cfg, shape, mesh=make_host_mesh(dims, axes))
        res = {"status": "ok", **got, "t_reckon_s": time.time() - t0}
    except Exception as e:  # a failing cell is a bug in the system
        res = {"arch": arch, "shape": shape_name, "mesh": name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    _save(res, save)
    return res


def _save(res: dict, save: bool):
    if not save:
        return
    os.makedirs(RESULTS_DIR, exist_ok=True)
    fn = f"{res['arch']}_{res['shape']}_{res['mesh']}.json"
    with open(os.path.join(RESULTS_DIR, fn), "w") as f:
        json.dump(res, f, indent=1, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--batch", type=int, default=0,
                    help="one-device batch instead of the cell's")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence length instead of the cell's")
    ap.add_argument("--multi-pod", action="store_true",
                    help="one rank of pod2x16x16 (512 ranks)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="one rank of pod16x16 and of pod2x16x16")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="one rank of a (data, model) mesh of D x M ranks")
    args = ap.parse_args(argv)
    if args.mesh:
        parse_mesh(args.mesh)

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [None]
    if args.both_meshes:
        meshes = ["pod16x16", "pod2x16x16"]
    elif args.multi_pod:
        meshes = ["pod2x16x16"]
    elif args.mesh:
        meshes = [args.mesh]
    n_ok = n_skip = n_err = 0
    for a, s, m in [(a, s, m) for a in archs for s in shapes
                    for m in meshes]:
        res = run_cell(a, s, batch=args.batch, seq=args.seq, mesh=m)
        tag, name = res["status"], res["mesh"]
        n_ok += tag == "ok"
        n_skip += tag == "skipped"
        n_err += tag == "error"
        if tag == "ok":
            r = res["roofline"]
            print(f"[ok]   {a:24s} {s:12s} {name:10s} "
                  f"comp={r['t_compute']*1e3:10.2f}ms "
                  f"mem={r['t_memory']*1e3:10.2f}ms "
                  f"bound={r['bottleneck']:10s} "
                  f"peak={res['peak_bytes']/1e9:9.2f}GB "
                  f"state={res['state_bytes']/1e9:9.3f}GB "
                  f"fits={str(res['fits']).lower()} "
                  f"({res['t_reckon_s']:.0f}s)", flush=True)
        elif tag == "skipped":
            print(f"[skip] {a:24s} {s:12s} {name:10s} {res['reason']}",
                  flush=True)
        else:
            print(f"[ERR]  {a:24s} {s:12s} {name:10s} {res['error']}",
                  flush=True)
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())

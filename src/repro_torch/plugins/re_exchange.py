"""Replica-exchange kernels: the paper's Amber temperature-exchange analogue.

Members train at different "temperatures" (learning rates).  The exchange
kernel gathers member losses and proposes even/odd neighbor swaps with a
Metropolis criterion — the standard parallel-tempering move applied to the
hyperparameter dimension (population-based training, RE-style).

Placement: by default the swap runs on the host (numpy).  With
``args["device"]`` set, the swap decision is computed by
``metropolis_swap_device`` on a torch device: a string names it ("cpu",
"cuda", "cuda:0"), and ``True`` means the port's default device
(``flags.resolve_device(None)``, cuda; it raises without one).  The
uniforms come from a ``torch.Generator`` on that device seeded from
(seed, cycle); the decision comes back to the host, which applies it to the
float64 temperatures.  A mesh-aware pilot's ``ctx["submesh"]`` (the JAX
package places the swap on it) is not ported: ROADMAP A9.

Staging: under a ``repro_torch.staging`` pilot the member traffic arrives staged
instead of passed by value — bulk member fields (trajectories, states) are
``StagedRef`` handles nested in the result dicts.  The exchange reads only
the scalar ``member``/``loss`` fields, leaves every nested ref untouched,
and reports the traffic it avoided as ``staged_avoided_bytes`` (the t_data
the swap decision did NOT cost; a ref-valued ``loss`` is dereferenced via
``ctx["staging"]`` and charged to this task's t_data).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.kernel_plugin import register_kernel
from repro_torch.staging.ports import iter_refs
from repro_torch.staging.store import StagedRef


def metropolis_swaps(losses, temps, cycle: int, seed: int = 0):
    """Even/odd neighbor swap proposals on a 1-D replica chain.

    Returns (new_temps, accepted_pairs).  Energies = losses; acceptance
    p = min(1, exp((E_i - E_j) * (1/T_i - 1/T_j))).
    """
    losses = np.asarray(losses, dtype=np.float64)
    temps = np.asarray(temps, dtype=np.float64).copy()
    n = len(losses)
    rng = np.random.default_rng((seed, cycle))
    accepted = []
    start = cycle % 2
    for i in range(start, n - 1, 2):
        j = i + 1
        d = (losses[i] - losses[j]) * (1.0 / temps[i] - 1.0 / temps[j])
        if math.log(max(rng.random(), 1e-12)) < d:
            temps[i], temps[j] = temps[j], temps[i]
            accepted.append((i, j))
    return temps, accepted


def exchange_uniforms(n: int, seed: int, cycle: int, device):
    """The (n,) uniforms of the on-device swap of ``cycle``: drawn on torch
    ``device`` by a generator seeded from (seed, cycle)."""
    import torch

    from repro_torch.core.ensemble import draw_uniforms
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence((seed, cycle)).generate_state(1)[0]))
    return draw_uniforms(n, gen)


def _device_swaps(losses, temps, cycle: int, seed: int, device):
    """The swap decided on torch ``device`` (True: the default device) by
    ``metropolis_swap_device`` on ``exchange_uniforms``."""
    import torch

    from repro_torch.core.ensemble import metropolis_swap_device
    from repro_torch.flags import resolve_device

    dev = resolve_device(None if device is True else device)
    old32 = np.asarray(temps, dtype=np.float32)
    new_t, _ = metropolis_swap_device(
        torch.tensor(np.asarray(losses, np.float32), device=dev),
        torch.tensor(old32, device=dev), cycle,
        exchange_uniforms(len(old32), seed, cycle, dev))
    new32 = new_t.cpu().numpy()
    # the device decides; the swap is applied host-side in float64 so
    # temperatures stay exact across cycles (swap detection must compare in
    # float32 — comparing against the float64 originals would flag every
    # non-representable temperature as swapped)
    new_temps = np.asarray(temps, dtype=np.float64).copy()
    accepted = []
    for i in range(cycle % 2, len(new_temps) - 1, 2):
        if new32[i] != old32[i] or new32[i + 1] != old32[i + 1]:
            new_temps[i], new_temps[i + 1] = new_temps[i + 1], new_temps[i]
            accepted.append((i, i + 1))
    return new_temps, accepted


@register_kernel("re.exchange",
                 description="Metropolis temperature exchange over members")
def re_exchange(args, ctx):
    ens = args.get("ensemble", "default")
    n = int(args["replicas"])
    cycle = int(args.get("cycle", 0))
    temps = list(map(float, args["temps"]))
    losses = [None] * n
    # primary source: the ports API — a "members" input port carrying the
    # simulation stage's {task: result} dict (flow.StageFuture/Channel);
    # fall back to raw task dependencies for un-annotated graphs
    sources = []
    for payload in (ctx.get("inputs") or {}).values():
        if isinstance(payload, dict):
            sources.extend(payload.values())
    sources.extend((ctx.get("dep_results") or {}).values())
    avoided_bytes = 0
    staging = ctx.get("staging")
    for res in sources:
        if isinstance(res, dict) and "member" in res and "loss" in res:
            loss = res["loss"]
            if isinstance(loss, StagedRef):     # unusual: staged scalar
                loss = staging.get(loss) if staging is not None else \
                    float("nan")
            losses[int(res["member"])] = float(loss)
            # bulk fields (trajectories, member state) stay LAZY: the
            # exchange decision never dereferences them, so their bytes
            # never hit this task's t_data
            avoided_bytes += sum(r.nbytes
                                 for key, v in res.items() if key != "loss"
                                 for r in iter_refs(v))
    explicit = args.get("losses")
    for i in range(n):
        if losses[i] is None and explicit is not None \
                and explicit[i] is not None:
            losses[i] = float(explicit[i])
        if losses[i] is None:
            losses[i] = float("nan")
    if args.get("device"):
        if ctx.get("submesh") is not None:
            raise NotImplementedError(
                "re.exchange on a granted submesh: mesh-aware pilots are "
                "not ported (ROADMAP A9)")
        new_temps, accepted = _device_swaps(
            losses, temps, cycle, int(args.get("seed", 0)), args["device"])
    else:
        new_temps, accepted = metropolis_swaps(losses, temps, cycle,
                                               int(args.get("seed", 0)))
    out = {"temps": [float(t) for t in new_temps],
           "accepted": accepted, "losses": losses, "cycle": cycle}
    if avoided_bytes:
        out["staged_avoided_bytes"] = int(avoided_bytes)
    return out

"""CLI for the flight recorder: journal files in, traces/reports out.

  python -m repro_torch.obs trace <journal.jsonl | dir> [--out PATH]
      Export Chrome/Perfetto trace_event JSON (one process per session
      segment, one row per slot).  Load in ui.perfetto.dev.

  python -m repro_torch.obs decompose <journal.jsonl | dir> [--tol 1e-6] [--json]
      Exact per-slot TTC decomposition of the final session segment.
      Exits 1 when any slot's residual exceeds --tol or the final
      segment ends with unpaired (still-open) attempt spans — the CI
      gate over smoke journals.

  python -m repro_torch.obs critical-path <journal.jsonl> [-k 3] [--json]
      Top-k critical chains with per-link slack.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.obs.report import (critical_path, decompose, load_segments,
                              to_chrome)


def _journals(path: str):
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path) if n.endswith(".jsonl"))
        return [os.path.join(path, n) for n in names]
    return [path]


def _cmd_trace(args) -> int:
    paths = _journals(args.journal)
    if not paths:
        print(f"repro_torch.obs: no journals under {args.journal}",
              file=sys.stderr)
        return 1
    named = []
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        for seg in load_segments(p):
            name = stem if seg.index == 0 else f"{stem}#{seg.index}"
            named.append((name, seg))
    out = to_chrome(named)
    dest = args.out
    if dest is None:
        dest = (os.path.join(args.journal, "trace.json")
                if os.path.isdir(args.journal)
                else os.path.splitext(args.journal)[0] + ".trace.json")
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    with open(dest, "w") as f:
        f.write(out)
    print(f"repro_torch.obs: wrote {dest} "
          f"({len(named)} segment(s), {len(out)} bytes)")
    return 0


def _cmd_decompose(args) -> int:
    failures = 0
    for p in _journals(args.journal):
        seg = load_segments(p)[-1]          # crash-restart: final run only
        if not seg.n_records:
            continue
        dec = decompose(seg)
        bad = dec["residual_max"] > args.tol or dec["n_open"] > 0
        failures += bad
        if args.json:
            for c in dec["slots"].values():
                c.pop("pieces", None)
            print(json.dumps({"journal": os.path.basename(p), **dec},
                             sort_keys=True))
            continue
        t = dec["totals"]
        w0, w1 = dec["window"]
        print(f"{os.path.basename(p)}: window {w1 - w0:.6g}s "
              f"x {len(dec['slots'])} slots [{dec['clock']}]"
              + ("  ** FAIL **" if bad else ""))
        print(f"  exec {t['t_exec']:.6g}  data {t['t_data']:.6g}  "
              f"sched {t['t_sched']:.6g}  block {t['t_block']:.6g}  "
              f"idle {t['t_idle']:.6g}  (lost {t['t_exec_lost']:.6g})")
        print(f"  attempts {t['n_attempts']}  preempted "
              f"{t['n_preempted']}  pod_lost {t['n_pod_lost']}  "
              f"residual_max {dec['residual_max']:.3g}  "
              f"open_spans {dec['n_open']}")
    return 1 if failures else 0


def _cmd_critical_path(args) -> int:
    seg = load_segments(args.journal)[-1]
    chains = critical_path(seg, k=args.k)
    if args.json:
        print(json.dumps(chains, sort_keys=True))
        return 0
    for i, ch in enumerate(chains):
        print(f"chain {i}: ttc {ch['ttc']:.6g}  links {ch['n_links']}  "
              f"slack {ch['total_slack']:.6g}")
        for ln in ch["links"]:
            slack = (f"  slack {ln['slack']:.6g}" if "slack" in ln else "")
            print(f"  {ln['task']}  [{ln['t0']:.6g}, {ln['t1']:.6g}]"
                  f"{slack}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("trace", help="export Chrome trace_event JSON")
    p.add_argument("journal")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("decompose", help="per-slot TTC decomposition")
    p.add_argument("journal")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_decompose)

    p = sub.add_parser("critical-path", help="top-k critical chains")
    p.add_argument("journal")
    p.add_argument("-k", type=int, default=3)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_critical_path)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the tier-1 run's and ``chip_smoke.py``'s time goes.

* ``python tests/_timings.py junit RUN.xml``: the seconds of each test
  file (the sum of its cases' times in a junit report, fixtures included)
  and the slowest cases.  ``junit RUN.xml FILE`` lists FILE's cases in the
  order they ran, each with its seconds and the running sum: a bound on
  the seconds since its module fixtures started their processes.
* ``python tests/_timings.py phases SMOKE.out [OTHER.out]``:
  ``chip_smoke.py``'s total and its longest phases, each phase the step of
  ``script_s`` from the row before it; given a second run's output, each
  phase in both and their difference, the largest first.  Then each run's
  seconds per group (each ``kernel <name>`` phase, their sum, ``build``,
  ``train``, ``train_4k``, ``long``, ``serve``, ``serve_ensemble``,
  ``mesh`` with ``mesh tp``, and the rest) and its host gauge: the plain
  ``linear_scan`` serve case's ``plain_ms``, which says how slow the
  run's host was.
* ``python tests/_timings.py sample OUT.json [ARGS...]`` (from the
  repository's root, on the card): ``chip_smoke.py`` with its main
  thread's stack sampled every 0.1 s; OUT.json gets the samples per
  phase and the functions with the most, inclusive and on top of the
  stack (a sample is 0.1 s).  No frame is held between samples, so no
  tensor lives longer than it would.
"""
from __future__ import annotations

import collections
import json
import sys
import threading
import xml.etree.ElementTree as ET
from pathlib import Path


def junit(path, file=None, top=10):
    files, cases = {}, []
    for tc in ET.parse(path).getroot().iter("testcase"):
        f = tc.get("classname", "").replace(".", "/") + ".py"
        t = float(tc.get("time", 0))
        n, s = files.get(f, (0, 0.0))
        files[f] = (n + 1, s + t)
        cases.append((t, f, tc.get("name")))
    if file is not None:
        total = 0.0
        for t, f, name in cases:
            if f.endswith(file):
                total += t
                print(f"  {t:8.1f} {total:8.1f}  {name}")
        return
    print(f"{len(cases)} cases, {sum(s for _, s in files.values()):.1f} "
          "test-seconds")
    for f, (n, s) in sorted(files.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {f:45} {n:4} {s:8.1f}")
    for t, f, name in sorted(cases, reverse=True)[:top]:
        print(f"  {t:8.1f}  {f}::{name}")


def _steps(path):
    """Each row's label (numbered where it repeats) and its step of
    ``script_s``, in order, and the last ``script_s``."""
    steps, last, seen = {}, 0.0, {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("{") and '"script_s"' in line:
            r = json.loads(line)
            label = " ".join(str(r[k]) for k in ("phase", "of", "app",
                                                  "run", "case") if r.get(k))
            seen[label] = seen.get(label, 0) + 1
            if seen[label] > 1:
                label += f" #{seen[label]}"
            steps[label] = r["script_s"] - last
            last = r["script_s"]
    return steps, last


GROUPS = ("build", "train", "train_4k", "long", "serve", "serve_ensemble",
          "mesh")


def groups(path):
    """({group: seconds}, the last ``script_s``, the host gauge): each
    row's step of ``script_s`` summed by its phase's group."""
    out, last, gauge = {}, 0.0, None
    for line in Path(path).read_text().splitlines():
        if not (line.startswith("{") and '"script_s"' in line):
            continue
        r = json.loads(line)
        word = r["phase"].split()[0]
        group = (r["phase"] if word == "kernel"
                 else word if word in GROUPS else "rest")
        out[group] = out.get(group, 0.0) + r["script_s"] - last
        last = r["script_s"]
        if r["phase"] == "kernel linear_scan" and r.get("case") == "serve":
            gauge = r["plain_ms"]
    return out, last, gauge


def _print_groups(paths):
    runs = [groups(p) for p in paths]
    names = sorted({name for by_group, _, _ in runs for name in by_group},
                   key=lambda g: (not g.startswith("kernel"), g))
    for name in names:
        print(f"  {name:34}" + "".join(f" {g.get(name, 0.0):8.2f}"
                                       for g, _, _ in runs))
    print(f"  {'kernel phases':34}" + "".join(
        f" {sum(v for k, v in g.items() if k.startswith('kernel')):8.2f}"
        for g, _, _ in runs))
    print(f"  {'whole script':34}" + "".join(f" {t:8.2f}"
                                             for _, t, _ in runs))
    print(f"  {'gauge (plain linear_scan serve, ms)':34}" + "".join(
        f" {gauge:8.2f}" if gauge is not None else "      n/a"
        for _, _, gauge in runs))


def phases(path, other=None, top=10):
    a, total = _steps(path)
    if other is None:
        print(f"{len(a)} rows, last at {total:.2f} s")
        for label, dt in sorted(a.items(), key=lambda kv: -kv[1])[:top]:
            print(f"  {dt:8.2f}  {label}")
        _print_groups([path])
        return
    b, total_b = _steps(other)
    print(f"last row at {total:.2f} and {total_b:.2f} s "
          f"({total_b - total:+.2f})")
    rows = [(b.get(k, 0.0) - a.get(k, 0.0), k) for k in {**a, **b}]
    for d, label in sorted(rows, key=lambda r: -abs(r[0]))[:top]:
        print(f"  {a.get(label, 0.0):8.2f} {b.get(label, 0.0):8.2f} "
              f"{d:+8.2f}  {label}")
    _print_groups([path, other])


def _where(frame) -> str:
    code = frame.f_code
    name = code.co_filename
    for part in ("site-packages/", "src/", "lib/python3"):
        if part in name:
            name = name.split(part, 1)[1]
            break
    return f"{Path(name).name}:{code.co_firstlineno}:{code.co_name}"


def sample(out, *args, every=0.1):
    sys.path.insert(0, str(Path.cwd()))
    sys.argv = ["chip_smoke.py", *args]
    import chip_smoke
    main, stop = threading.get_ident(), threading.Event()
    top, incl = collections.Counter(), collections.Counter()
    phase_n = collections.Counter()

    def run():
        while not stop.wait(every):
            frame = sys._current_frames().get(main)
            keys = []
            while frame is not None:
                keys.append(_where(frame))
                frame = frame.f_back
            if not keys:
                continue
            phase = next((k.rsplit(":", 1)[1] for k in keys
                          if k.rsplit(":", 1)[1].startswith("phase_")), "-")
            phase_n[phase] += 1
            top[(phase, keys[0])] += 1
            for k in set(keys):
                incl[(phase, k)] += 1

    sampler = threading.Thread(target=run, daemon=True)
    sampler.start()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        Path(out).write_text(json.dumps({
            "every_s": every, "phases": phase_n.most_common(),
            "top": [[*k, n] for k, n in top.most_common(300)],
            "inclusive": [[*k, n] for k, n in incl.most_common(600)]}))
    sys.exit(rc)


if __name__ == "__main__":
    {"junit": junit, "phases": phases, "sample": sample}[sys.argv[1]](
        *sys.argv[2:])

"""CPU rehearsals of ``chip_smoke.py``'s kernel phases through their one
case runner, ``kernel_case``.

Each phase runs at small shapes with the kernels' wrappers standing in as
their plain versions, counted as the launches the kernels count
(``_count_plain_versions`` and the stand-ins here), the CUDA calls made
no-ops and the timers one call each (``_no_cuda_calls``).  Every row must
pass the phase's own checks and carry the common fields; a kernel whose
output is perturbed must make the runner raise, naming the case.  The
``kernel gmm_bwd`` phase's rehearsal is in ``test_torch_moe_backward.py``;
``tests/_timings.py``'s grouping of a run's phases is here too.
"""
import contextlib
import json

import pytest

torch = pytest.importorskip("torch")

from _threads import _one_thread  # noqa: E402,F401
from test_torch_moe_backward import (  # noqa: E402
    ROOT,
    _chip_smoke,
    _count_plain_versions,
    _no_cuda_calls,
)

from repro_torch.kernels import LAUNCHES, count_launch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_fwd_ref,
)
from repro_torch.kernels.mamba import ops as mops  # noqa: E402
from repro_torch.kernels.mamba.ref import (  # noqa: E402
    selective_scan_bwd_ref,
    selective_scan_ref,
)
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.rglru import ops as rops  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    linear_scan_bwd_ref,
    linear_scan_ref,
)

COMMON = {"max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
          "library_ms", "library"}
G2 = dict(H=4, KH=2, D=64, softcap=50.0, scale=0.125)

# small cases of each phase, the features of its card cases among them:
# packed segments, a window shorter than the keys, a query offset,
# non-causal cross attention, head dims 16 and 256, f32, ragged scans,
# a single step, router sizes, empty and ragged groups
CASES = {
    "flash_attention": ("FA_CASES", [
        dict(name="serve", B=2, Sq=32, Sk=32, causal=True, window=0,
             q_offset=0, dtype="bfloat16", tol=3e-2, **G2),
        dict(name="window_lt_seq", B=1, Sq=48, Sk=48, causal=True,
             window=16, q_offset=0, dtype="bfloat16", tol=3e-2, **G2),
        dict(name="q_offset", B=1, Sq=8, Sk=40, causal=True, window=0,
             q_offset=32, dtype="bfloat16", tol=3e-2, **G2),
        dict(name="cross", B=1, Sq=24, Sk=30, H=2, KH=2, D=16, causal=False,
             window=0, softcap=0.0, scale=None, q_offset=0,
             dtype="bfloat16", tol=3e-2),
        dict(name="seg", B=2, Sq=32, Sk=32, causal=True, window=0,
             q_offset=0, dtype="bfloat16", tol=3e-2, seg=3, **G2),
        dict(name="f32", B=1, Sq=16, Sk=16, H=2, KH=1, D=256, causal=True,
             window=0, softcap=0.0, scale=None, q_offset=0,
             dtype="float32", tol=1e-4),
    ]),
    "flash_attention_bwd": ("FA_BWD_CASES", [
        dict(name="gemma2_step", B=2, Sq=32, Sk=32, causal=True, window=0,
             q_offset=0, dtype="bfloat16", seg=1, **G2),
        dict(name="window_lt_seq", B=1, Sq=48, Sk=48, causal=True,
             window=16, q_offset=0, dtype="bfloat16", seg=2, **G2),
        dict(name="d16_non_causal", B=1, Sq=20, Sk=28, H=2, KH=1, D=16,
             causal=False, window=0, softcap=0.0, scale=0.25, q_offset=0,
             dtype="bfloat16", seg=0),
        dict(name="f32", B=1, Sq=16, Sk=16, H=2, KH=2, D=32, causal=True,
             window=0, softcap=30.0, scale=0.2, q_offset=0, dtype="float32",
             seg=0),
    ]),
    "linear_scan": ("LS_CASES", [
        dict(name="serve", B=2, T=40, C=24, dtype="float32"),
        dict(name="single_step", B=2, T=1, C=24, dtype="float32"),
        dict(name="bf16", B=2, T=40, C=24, dtype="bfloat16"),
    ]),
    "selective_scan": ("SS_CASES", [
        dict(name="serve", B=2, T=24, d=16, n=8, dtype="bfloat16"),
        dict(name="ragged", B=1, T=19, d=10, n=6, dtype="bfloat16"),
        dict(name="f32", B=2, T=16, d=8, n=4, dtype="float32"),
    ]),
    "linear_scan_bwd": ("LS_BWD_CASES", [
        dict(name="train", B=2, T=40, C=24, dtype="float32"),
        dict(name="bf16", B=2, T=40, C=24, dtype="bfloat16"),
        dict(name="ragged", B=3, T=17, C=10, dtype="float32"),
    ]),
    "selective_scan_bwd": ("SS_BWD_CASES", [
        dict(name="train", B=2, T=24, d=16, n=8, dtype="bfloat16"),
        dict(name="f32", B=2, T=16, d=8, n=4, dtype="float32"),
        dict(name="ragged", B=1, T=19, d=10, n=6, dtype="bfloat16"),
    ]),
    "gmm": ("GMM_CASES", [
        dict(name="serve", E=8, C=16, D=32, F=24, route=(16, 4),
             dtype="bfloat16"),
        dict(name="train_router", E=8, C=16, D=32, F=24, router="train",
             dtype="bfloat16"),
        dict(name="decode", E=8, C=4, D=32, F=24, route=(2, 2),
             dtype="bfloat16"),
        dict(name="ragged", E=5, C=10, D=20, F=30, sizes=[0, 10, 3, 6, 1],
             dtype="bfloat16"),
        dict(name="empty", E=4, C=8, D=16, F=8, sizes=[0] * 4,
             dtype="bfloat16"),
        dict(name="f32", E=4, C=16, D=16, F=8, route=(16, 2),
             dtype="float32"),
    ]),
}
# the counters each phase's kernels add to, one a launch
COUNTERS = {"flash_attention": "flash_attention", "flash_attention_bwd":
            "flash_attention_bwd", "linear_scan": "linear_scan",
            "selective_scan": "selective_scan", "linear_scan_bwd":
            "linear_scan_bwd", "selective_scan_bwd": "selective_scan_bwd",
            "gmm": "gmm"}
ROUTER = {"train": torch.tensor([16, 0, 3, 9, 16, 1, 7, 12],
                                dtype=torch.int32)}


def _counted(name, fn):
    def run(*a, **kw):
        count_launch(name)
        return fn(*a, **kw)
    return run


def _plain_flash(q, k, v, *, return_lse=False, **kw):
    """``flash_attention_cuda``'s stand-in: the plain forward, counted as
    the launch of its variant."""
    count_launch("flash_attention",
                 f"flash_attention.{fops.variant(q.dtype, q.shape[-1])}")
    o, lse = attention_fwd_ref(q, k, v, **kw)
    return (o, lse) if return_lse else o


def _plain_ss_fwd(x, dt, A, Bm, C, D, h0, *, checkpoints=False):
    """``selective_scan_cuda``'s stand-in: the plain scan, with the states
    every ``CKPT_STEPS`` steps (h0 first) that the backward reads."""
    count_launch("selective_scan")
    y, h = selective_scan_ref(x, dt, A, Bm, C, D, h0)
    if not checkpoints:
        return y, h
    K = mops.CKPT_STEPS
    ckpt = torch.stack([h0] + [
        selective_scan_ref(x[:, :t], dt[:, :t], A, Bm[:, :t], C[:, :t], D,
                           h0)[1] for t in range(K, x.shape[1], K)], 1)
    return y, h, ckpt


def _plain_kernels(monkeypatch, chip_smoke):
    """The wrappers the phases call, as their plain versions counted as
    launches; the long rows, the plan-eviction shapes and the bf16 state
    pass at sizes the CPU takes."""
    _count_plain_versions(monkeypatch)
    monkeypatch.setattr(fops, "flash_attention_cuda", _plain_flash)
    monkeypatch.setattr(fops, "flash_attention_bwd_cuda", lambda q, *a, **kw: (
        count_launch("flash_attention_bwd", "flash_attention_bwd."
                     + fops.bwd_variant(q.dtype, q.shape[-1])),
        attention_bwd_ref(q, *a, **kw))[1])
    monkeypatch.setattr(rops, "linear_scan_ref",
                        _counted("linear_scan", linear_scan_ref))
    monkeypatch.setattr(rops, "linear_scan_cuda",
                        _counted("linear_scan", linear_scan_ref))
    monkeypatch.setattr(rops, "linear_scan_bwd_cuda", lambda x, a, h0, y, dy,
                        dh: _counted("linear_scan_bwd", linear_scan_bwd_ref)(
                            x, a, h0, dy, dh))
    monkeypatch.setattr(mops, "selective_scan_ref",
                        _counted("selective_scan", selective_scan_ref))
    monkeypatch.setattr(mops, "selective_scan_cuda", _plain_ss_fwd)
    monkeypatch.setattr(mops, "selective_scan_bwd_cuda", lambda *a: _counted(
        "selective_scan_bwd", selective_scan_bwd_ref)(*a[:7], *a[8:]))
    monkeypatch.setattr(gops, "kernel_variant", gops.variant)
    monkeypatch.setattr(chip_smoke, "_bwd_states", lambda x, a, h0, *_:
                        linear_scan_ref(x.float(), a.float(), h0)[0])
    monkeypatch.setattr(chip_smoke, "PLAN_SHAPES", 3)
    for name in ("SS_LONG", "SS_BWD_LONG"):
        monkeypatch.setattr(chip_smoke, name, dict(
            name="long_row", B=1, T=48, d=8, n=4, dtype="bfloat16", tail=16))


def _plain_baseline(name):
    """An earlier kernel's stand-in for ``--baseline``: the plain version,
    with the ``patched()`` context of the constants an older source
    needs."""
    def run(*a, **kw):
        if name == "flash_attention":
            return attention_fwd_ref(*a, **kw)[0]
        if name == "linear_scan_bwd":
            return linear_scan_bwd_ref(*a[:3], *a[4:])
        if name == "selective_scan_bwd":
            return selective_scan_bwd_ref(*a[:7], *a[8:])
        return {"flash_attention_bwd": attention_bwd_ref,
                "linear_scan": linear_scan_ref,
                "selective_scan": selective_scan_ref,
                "gmm": gops.gmm_ref}[name](*a, **kw)
    run.patched = contextlib.nullcontext
    return run


# the row field of each phase's baseline check
BASELINE_FIELD = {"flash_attention": "baseline_max_abs_err",
                  "flash_attention_bwd": "baseline_checks",
                  "linear_scan": "baseline_max_abs_err",
                  "selective_scan": "baseline_max_abs_err",
                  "linear_scan_bwd": "baseline_checks",
                  "selective_scan_bwd": "baseline_checks",
                  "gmm": "baseline_max_abs_err"}


def _run_phase(chip_smoke, name, baseline=None):
    phase = getattr(chip_smoke, f"phase_kernel_{name}")
    cpu = torch.device("cpu")
    return (phase(cpu, ROUTER, baseline) if name == "gmm"
            else phase(cpu, baseline))


@pytest.mark.parametrize("name", list(CASES))
def test_chip_smoke_kernel_phase_rehearsal(name, monkeypatch):
    """``chip_smoke.py``'s ``kernel <name>`` phase on the CPU at small
    cases: every row passes the phase's checks (variant rules, launch
    counters, tolerances, bitwise repeats, padding rows, the bf16 state
    pass, the long row's tail and the plan eviction) and every case's row
    carries the common fields the ``kernels`` line reads; with
    ``--baseline`` (the plain version again) each case also carries the
    baseline's time and its check."""
    chip_smoke = _chip_smoke()
    _no_cuda_calls(monkeypatch, chip_smoke)
    _plain_kernels(monkeypatch, chip_smoke)
    attr, cases = CASES[name]
    monkeypatch.setattr(chip_smoke, attr, cases)
    monkeypatch.setattr(chip_smoke, "_baseline",
                        lambda n, path: path and _plain_baseline(n))
    before = LAUNCHES[COUNTERS[name]]
    rows = _run_phase(chip_smoke, name, ROOT / "chip_smoke.py")
    names = [c["name"] for c in cases]
    assert list(rows)[:len(names)] == names
    assert all(r["ok"] for r in rows.values())
    assert LAUNCHES[COUNTERS[name]] > before
    for n in names:
        r = rows[n]
        assert set(r) >= COMMON, COMMON - set(r)
        assert r["phase"] == f"kernel {name}" and r["case"] == n
        assert r["max_abs_err"] == 0.0    # the plain version against itself
        assert r["ms"] == r["host_ms"] == r["plain_ms"] == 0.1
        assert r["bound_by"] in ("bytes", "operations") and r["bound_ms"] > 0
        old = r[BASELINE_FIELD[name]]
        if name == "flash_attention" and r["segments"]:
            assert old is None and r["baseline_ms"] is None  # no seg ids
        else:
            assert old is not None and r["baseline_ms"] == 0.1
    if name.endswith("scan") or name.endswith("scan_bwd"):
        assert all(rows[n]["library_ms"] is None for n in names)
    if name in ("selective_scan", "selective_scan_bwd"):
        assert rows["long_row"]["tail_bitwise_equal"]
    if name == "flash_attention_bwd":
        assert rows["plan_eviction"]["bitwise_after_eviction"]
    if name == "linear_scan_bwd":
        assert rows["bf16"]["states_equal_forward_y"]
    if name == "gmm":
        assert rows["train_router"]["live_rows"] == 64
        assert rows["empty"]["live_rows"] == 0


@pytest.mark.parametrize("name, wrapper", [
    ("linear_scan", (rops, "linear_scan_ref")),
    ("gmm", (gops, "gmm_ref")),
    ("flash_attention_bwd", (fops, "flash_attention_bwd_cuda")),
])
def test_chip_smoke_kernel_case_rejects_a_perturbed_output(name, wrapper,
                                                           monkeypatch):
    """A kernel whose output is off by one bf16 step's worth and more at
    one element fails its case: the runner emits the row and raises,
    naming the phase and the case."""
    chip_smoke = _chip_smoke()
    _no_cuda_calls(monkeypatch, chip_smoke)
    _plain_kernels(monkeypatch, chip_smoke)
    attr, cases = CASES[name]
    monkeypatch.setattr(chip_smoke, attr, cases[:1])
    module, fn_name = wrapper
    fn = getattr(module, fn_name)

    def perturbed(*a, **kw):
        out = fn(*a, **kw)
        first = out[0] if isinstance(out, tuple) else out
        first.view(-1)[-1] += 1.0
        return out
    monkeypatch.setattr(module, fn_name, perturbed)
    emitted = []
    monkeypatch.setattr(chip_smoke, "emit", emitted.append)
    with pytest.raises(AssertionError,
                       match=f"{name} case {cases[0]['name']} failed"):
        _run_phase(chip_smoke, name)
    assert [r["ok"] for r in emitted] == [False]
    assert emitted[0]["max_abs_err"] >= 0.5


def test_kernel_case_checks_counters_and_variants(monkeypatch):
    """The runner fails a case whose variant rules disagree before any
    call, and one whose calls do not count their launches."""
    chip_smoke = _chip_smoke()
    _no_cuda_calls(monkeypatch, chip_smoke)
    x = torch.ones(4)
    kw = dict(plain=lambda: x, check=lambda o, r: {"max_abs_err": 0.0,
                                                   "ok": True},
              cost=(1.0, 1.0, "float32"), iters=1, plain_iters=1)
    with pytest.raises(AssertionError, match="rules disagree: a wgmma, b f32"):
        chip_smoke.kernel_case("kernel k", "c", kernel=lambda: x,
                               variants={"a": "wgmma", "b": "f32"}, **kw)
    with pytest.raises(AssertionError, match="k case c: 2 call"):
        chip_smoke.kernel_case("kernel k", "c", kernel=lambda: x,
                               counters=("gmm",), repeat="same", **kw)
    monkeypatch.setattr(chip_smoke, "emit", lambda row: None)
    row = chip_smoke.kernel_case(
        "kernel k", "c", kernel=lambda: (count_launch("gmm"), x)[1],
        counters=("gmm",), repeat="same", **kw)
    assert row["same"] and row["ok"] and row["plain_ms"] == 0.1


def test_timings_groups(tmp_path, capsys):
    """``tests/_timings.py phases``: each run's seconds per group (each
    kernel phase, long, train_4k, serve, serve_ensemble, mesh, the rest)
    and the host gauge, the plain linear_scan serve case's plain_ms."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_timings", ROOT / "tests" / "_timings.py")
    timings = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timings)
    rows = [("build", None, 40.0), ("kernel flash_attention", "a", 50.0),
            ("kernel flash_attention", "b", 52.5),
            ("kernel linear_scan", "serve", 53.0),
            ("train gemma2-2b", None, 70.0),
            ("train_4k gemma2-2b", None, 90.0),
            ("serve_ensemble", None, 100.0), ("serve gemma2-2b", None, 104.0),
            ("long gemma2-2b", "prefill_32k", 110.0), ("mesh", None, 111.0),
            ("mesh tp", None, 115.0), ("examples", "train", 116.0)]
    out = tmp_path / "smoke.out"
    out.write_text("\n".join(json.dumps(
        {"phase": p, **({"case": c} if c else {}), "script_s": s,
         **({"plain_ms": 33.5} if c == "serve" else {})})
        for p, c, s in rows) + "\n")
    groups, total, gauge = timings.groups(out)
    assert total == 116.0 and gauge == 33.5
    assert groups == {"build": 40.0, "kernel flash_attention": 12.5,
                      "kernel linear_scan": 0.5, "train": 17.0,
                      "train_4k": 20.0, "serve_ensemble": 10.0,
                      "serve": 4.0, "long": 6.0, "mesh": 5.0, "rest": 1.0}
    timings.phases(str(out), str(out))
    text = capsys.readouterr().out
    assert "kernel phases" in text and "gauge" in text

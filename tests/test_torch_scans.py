"""The port's RG-LRU and Mamba scans against the JAX package's.

On the CPU the port's ``linear_scan`` and ``selective_scan`` run their plain
PyTorch versions; they are held against the JAX oracle (``impl="ref"``) and
the JAX Pallas kernels in interpret mode, over the sweeps of
``test_pallas_kernels.py`` (block-aligned, as the Pallas kernels need), and
against the oracle alone on ragged shapes.  Inputs come from one numpy
generator and go to both packages.  Tolerances: 1e-4 for float32 (the
summation order of the state update and of ``C . h``), 5e-2 for bfloat16
inputs and outputs (one rounding of an O(1) output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba.ops import selective_scan as jax_selective_scan  # noqa: E402
from repro.kernels.mamba.ops import selective_step as jax_selective_step  # noqa: E402
from repro.kernels.rglru.ops import linear_scan as jax_linear_scan  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build  # noqa: E402
from repro_torch.kernels.mamba import selective_scan, selective_step  # noqa: E402
from repro_torch.kernels.mamba.ops import check_inputs as mamba_check  # noqa: E402
from repro_torch.kernels.mamba.ops import selective_scan_cuda  # noqa: E402
from repro_torch.kernels.mamba.ops import variant as mamba_variant  # noqa: E402
from repro_torch.kernels.rglru import linear_scan  # noqa: E402
from repro_torch.kernels.rglru.ops import check_inputs as rglru_check  # noqa: E402
from repro_torch.kernels.rglru.ops import linear_scan_cuda  # noqa: E402

DTYPES = [("float32", 1e-4), ("bfloat16", 5e-2)]
JAX_IMPLS = ["ref", "pallas_interpret"]


def _both(arr, dtype):
    return (jnp.asarray(arr, getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(arr)).to(
                getattr(torch, dtype)))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


# ---------------------------------------------------------------- RG-LRU

def _rglru_inputs(seed, B, T, C):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, C)), rng.uniform(0.5, 0.99, (B, T, C)),
            rng.standard_normal((B, C)).astype(np.float32))


def _check_linear_scan(B, T, C, dtype, atol, jax_impl):
    x, a, h0 = _rglru_inputs(42, B, T, C)
    (jx, tx), (ja, ta) = _both(x, dtype), _both(a, dtype)
    jh0, th0 = _both(h0, "float32")
    yr, hr = jax_linear_scan(jx, ja, jh0, impl=jax_impl)
    y, h = linear_scan(tx, ta, th0)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert h.dtype == torch.float32 and h.shape == th0.shape
    _close(y, yr, atol)
    _close(h, hr, atol)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("B,T,C", [(2, 64, 256), (1, 128, 128), (3, 32, 512)])
def test_linear_scan_matches_jax(B, T, C, dtype, atol, jax_impl):
    _check_linear_scan(B, T, C, dtype, atol, jax_impl)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("B,T,C", [(2, 37, 100), (1, 1, 2560)])
def test_linear_scan_ragged_and_single_step(B, T, C, dtype, atol):
    """Any C (the Pallas kernel needs C % 256 == 0) and T=1, as decode
    would use the scan: against the JAX oracle."""
    _check_linear_scan(B, T, C, dtype, atol, "ref")


def test_linear_scan_rejects_what_the_kernel_does_not_take():
    x, a, h0 = torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), torch.zeros(2, 16)
    rglru_check(x, a, h0)
    bad = [(x, a.to(torch.bfloat16), h0),                     # mixed dtypes
           (x.half(), a.half(), h0),                          # float16
           (x, a, h0.to(torch.bfloat16)),                     # h0 not f32
           (x, a[:, :4], h0),                                 # shapes differ
           (x, a, torch.zeros(2, 8)),                         # h0 shape
           (torch.zeros(2, 16, 8).transpose(1, 2), a, h0)]    # layout
    for args in bad:
        with pytest.raises(ValueError):
            rglru_check(*args)


# ---------------------------------------------------------------- Mamba

def _mamba_inputs(seed, B, T, d, n):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((B, T, d)),
                dt=rng.uniform(1e-3, 0.1, (B, T, d)),
                A=-rng.uniform(0.5, 2.0, (d, n)),
                Bm=rng.standard_normal((B, T, n)),
                C=rng.standard_normal((B, T, n)),
                D=rng.standard_normal((d,)),
                h0=rng.standard_normal((B, d, n)))


def _check_selective_scan(shape, io_dtype, atol, jax_impl):
    """x, Bm, C in ``io_dtype`` (the serving path has them in bf16); dt, A,
    D and h0 float32."""
    arrs = _mamba_inputs(7, *shape)
    j, t = {}, {}
    for k, v in arrs.items():
        j[k], t[k] = _both(v, io_dtype if k in ("x", "Bm", "C")
                           else "float32")
    names = ("x", "dt", "A", "Bm", "C", "D", "h0")
    yr, hr = jax_selective_scan(*(j[k] for k in names), impl=jax_impl)
    y, h = selective_scan(*(t[k] for k in names))
    assert y.dtype == t["x"].dtype and h.dtype == torch.float32
    _close(y, yr, atol)
    _close(h, hr, 1e-4 if io_dtype == "float32" else atol)


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("io_dtype,atol", DTYPES)
@pytest.mark.parametrize("B,T,d,n", [(2, 32, 256, 8), (1, 64, 128, 16),
                                     (2, 16, 512, 4)])
def test_selective_scan_matches_jax(B, T, d, n, io_dtype, atol, jax_impl):
    _check_selective_scan((B, T, d, n), io_dtype, atol, jax_impl)


@pytest.mark.parametrize("B,T,d,n", [(2, 37, 100, 12), (3, 1, 256, 16)])
def test_selective_scan_ragged_and_single_step(B, T, d, n):
    _check_selective_scan((B, T, d, n), "float32", 1e-4, "ref")


def test_selective_scan_takes_column_slices():
    """Bm and C as the model passes them: column slices of one x_proj
    output, not contiguous."""
    arrs = _mamba_inputs(3, 2, 24, 64, 8)
    t = {k: torch.from_numpy(v).float() for k, v in arrs.items()}
    xdbc = torch.cat([torch.zeros(2, 24, 5), t["Bm"], t["C"]], dim=-1)
    Bm, Cc = xdbc[..., 5:13], xdbc[..., 13:]
    assert not Bm.is_contiguous() and not Cc.is_contiguous()
    mamba_check(t["x"], t["dt"], t["A"], Bm, Cc, t["D"], t["h0"])
    y, h = selective_scan(t["x"], t["dt"], t["A"], Bm, Cc, t["D"], t["h0"])
    y0, h0 = selective_scan(t["x"], t["dt"], t["A"], t["Bm"], t["C"],
                            t["D"], t["h0"])
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)


def _emulate_kernel_scan(x, dt, A, Bm, C, D, h0):
    """The CUDA kernel's arithmetic in float32 on the CPU: exp(dt A) as
    exp2(dt * (A log2 e)) with A prescaled once; n padded to NP = 4, 8 or
    16 states (A = B = C = 0 past n); C . h summed in state order; then
    D x added.  (The kernel's FMAs round once where this rounds twice.)"""
    n = A.shape[1]
    pad = (0, int(mamba_variant(n)[2:]) - n)
    f = torch.nn.functional
    A2 = f.pad(A * np.float32(np.log2(np.e)), pad)
    Bp, Cp, h = f.pad(Bm, pad), f.pad(C, pad), f.pad(h0, pad)
    ys = []
    for t in range(x.shape[1]):
        dtt, xt = dt[:, t], x[:, t]
        da = torch.exp2(dtt[..., None] * A2)
        h = da * h + (dtt * xt)[..., None] * Bp[:, t, None, :]
        prod = h * Cp[:, t, None, :]
        acc = prod[..., 0]
        for i in range(1, prod.shape[-1]):
            acc = acc + prod[..., i]
        ys.append(D * xt + acc)
    return torch.stack(ys, 1), h[..., :n]


@pytest.mark.parametrize("B,T,d,n", [(2, 32, 256, 8), (1, 64, 128, 16),
                                     (2, 16, 512, 4), (2, 37, 100, 12),
                                     (3, 1, 256, 16)])
def test_selective_scan_kernel_arithmetic_matches_jax(B, T, d, n):
    """The ex2 arithmetic of ``csrc/selective_scan.cu`` holds the JAX
    oracle at the float32 tolerance on the shapes above."""
    arrs = _mamba_inputs(7, B, T, d, n)
    names = ("x", "dt", "A", "Bm", "C", "D", "h0")
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).float() for k, v in arrs.items()}
    yr, hr = jax_selective_scan(*(j[k] for k in names), impl="ref")
    y, h = _emulate_kernel_scan(*(t[k] for k in names))
    _close(y, yr, 1e-4)
    _close(h, hr, 1e-4)


@pytest.mark.parametrize("n,padded", [(1, 4), (4, 4), (5, 8), (12, 16),
                                      (16, 16)])
def test_selective_scan_variant(n, padded):
    assert mamba_variant(n) == f"np{padded}"
    with pytest.raises(ValueError):
        mamba_variant(17)


@pytest.mark.parametrize("B,d,n", [(2, 256, 16), (3, 100, 4)])
def test_selective_step_matches_jax(B, d, n):
    arrs = _mamba_inputs(11, B, 1, d, n)
    arrs = {k: (v[:, 0] if k in ("x", "dt", "Bm", "C") else v)
            for k, v in arrs.items()}
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).float() for k, v in arrs.items()}
    names = ("x", "dt", "A", "Bm", "C", "D", "h0")
    yr, hr = jax_selective_step(*(j[k] for k in names))
    y, h = selective_step(*(t[k] for k in names))
    _close(y, yr, 1e-5)
    _close(h, hr, 1e-5)


@pytest.mark.parametrize("bad", ["state", "dt_dtype", "bc_stride", "shape",
                                 "layout", "bc_dtypes"])
def test_selective_scan_rejects_what_the_kernel_does_not_take(bad):
    B, T, d, n = 2, 8, 32, 16
    a = dict(x=torch.zeros(B, T, d), dt=torch.zeros(B, T, d),
             A=torch.zeros(d, n), Bm=torch.zeros(B, T, n),
             C=torch.zeros(B, T, n), D=torch.zeros(d), h0=torch.zeros(B, d, n))
    mamba_check(**a)
    if bad == "state":
        a.update(A=torch.zeros(d, 32), Bm=torch.zeros(B, T, 32),
                 C=torch.zeros(B, T, 32), h0=torch.zeros(B, d, 32))
    elif bad == "dt_dtype":
        a["dt"] = a["dt"].to(torch.bfloat16)
    elif bad == "bc_stride":
        a["Bm"] = torch.zeros(B, n, T).transpose(1, 2)
    elif bad == "shape":
        a["C"] = torch.zeros(B, T - 1, n)
    elif bad == "layout":
        a["x"] = torch.zeros(B, d, T).transpose(1, 2)
    else:
        a["C"] = a["C"].to(torch.bfloat16)
    with pytest.raises(ValueError):
        mamba_check(**a)


@pytest.mark.parametrize("T", [2 ** 31 // 8192, 2 ** 31 // 8192 + 256])
def test_selective_scan_takes_rows_of_2_31_elements_and_more(T):
    """A batch row of T * d >= 2^31 elements (falcon-mamba's d = 8192; the
    kernel takes its offsets in 64 bits there): the wrapper's checks pass,
    on meta tensors, with Bm and C column slices of one x_proj output."""
    d, n = 8192, 16
    meta = dict(device="meta")
    xdbc = torch.empty(1, T, 256 + 2 * n, dtype=torch.bfloat16, **meta)
    mamba_check(x=torch.empty(1, T, d, dtype=torch.bfloat16, **meta),
                dt=torch.empty(1, T, d, **meta), A=torch.empty(d, n, **meta),
                Bm=xdbc[..., 256:256 + n], C=xdbc[..., 256 + n:],
                D=torch.empty(d, **meta), h0=torch.empty(1, d, n, **meta))


# ---------------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_versions():
    before = dict(LAUNCHES)
    x, a, h0 = (torch.rand(1, 4, 8), torch.rand(1, 4, 8), torch.zeros(1, 8))
    linear_scan(x, a, h0)
    m = {k: torch.from_numpy(v).float()
         for k, v in _mamba_inputs(0, 1, 4, 8, 4).items()}
    selective_scan(**m)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA"):
        linear_scan_cuda(x, a, h0)
    with pytest.raises(ValueError, match="needs CUDA"):
        selective_scan_cuda(**m)
    with pytest.raises(ValueError):
        linear_scan(x, a, h0, impl="pallas")
    with pytest.raises(ValueError):
        selective_scan(**m, impl="xla")


@pytest.mark.parametrize("name", ["linear_scan", "selective_scan"])
def test_scan_builds_are_registered(name):
    assert name in LAUNCHES
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR and name in path.name
    assert (_build._KERNELS_DIR / _build.SOURCES[name]).is_file()

"""The port's chirp-z transform, zoom FFT and fast Hankel transform against
tpufft's and scipy's, and the carry-over of tpufft's filter and CZT plans.

The same seeded inputs go through tpufft (interpret mode where it runs
Pallas) and the port on the CPU (``device="cpu"``). Tolerances, normalized
by the result's magnitude:

* f64 against scipy: 1e-9 for the CZT (as tpufft's own tests; the chirp's
  ``w**(k^2/2)`` loses a few digits at large k), 1e-10 elsewhere;
* f32 against tpufft: 2e-5 (both compute in f32, tpufft's bf16x3
  products against the port's f32 FMA); where tpufft's own f32 result
  strays further from the f64 result of the same input (its fht), the
  port is held to that f64 result at 2e-5 and to tpufft within tpufft's
  own distance from it;
* f32 against scipy's f64: 2e-4 for the CZT, whose chirp multiplies and
  two length-L transforms each round in f32.
"""

import dataclasses

import numpy as np
import pytest
import scipy.fft as sfft
import scipy.signal as sps
import torch

import jax.numpy as jnp
import tpufft
from tpufft import PlanConfig as TPPlanConfig

import tpufft_torch
from tpufft_torch import CZT, PlanConfig, SplitComplex, ZoomFFT
from tpufft_torch.convert import czt_plan_from_fields, filter_plan_from_fields
from tpufft_torch.kernels import minor_fft, real_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas")
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))
CPU = "cpu"


def _err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _c128(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _czt(x, *a, **k):
    return tpufft_torch.czt(x, *a, **k, device=CPU)


# ----------------------------------------------------------------------------
# czt / zoom_fft
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 16, 50, 128, 365])
def test_czt_default_is_fft(n):
    x = _c128(n, n)
    got = _czt(x)
    assert got.dtype == np.complex128 and _err(got, np.fft.fft(x)) < 1e-10


@pytest.mark.parametrize("n,m", [(16, 16), (16, 8), (16, 37), (50, 50),
                                 (31, 64), (1, 5)])
@pytest.mark.parametrize("w,a", [
    (None, 1 + 0j),
    (np.exp(-2j * np.pi * 0.123), 1 + 0j),
    (np.exp(-2j * np.pi / 20), np.exp(0.7j)),
])
def test_czt_matches_scipy_f64(n, m, w, a):
    x = _c128(n, n + m)
    want = sps.czt(x, m, w, a)
    assert _err(_czt(x, m, w, a), want) < 1e-9
    assert _err(_czt(x, m, w, a), tpufft.czt(x, m, w, a)) < 1e-9


def test_czt_off_circle_real_and_batched_axes():
    w, a = 0.98 * np.exp(-0.4j), 1.5 + 0j
    x = _c128(12, 1)
    assert _err(_czt(x, 12, w, a), sps.czt(x, 12, w, a)) < 1e-8
    r = np.random.default_rng(2).standard_normal(48)
    assert _err(_czt(r, 30, np.exp(-0.11j)),
                sps.czt(r, 30, np.exp(-0.11j))) < 1e-9
    x = _c128((3, 24, 4), 3)
    for axis in (0, 1, -1):
        n = x.shape[axis]
        assert _err(_czt(x, n + 5, axis=axis),
                    sps.czt(x, n + 5, axis=axis)) < 1e-9


@pytest.mark.parametrize("shape,m,w", [((4, 63), 40, None),
                                       ((3, 96), 64, np.exp(-0.2j)),
                                       ((2, 100), 1024, np.exp(-0.001j))])
def test_czt_f32_matches_tpufft(shape, m, w, monkeypatch):
    """f32 input runs the device pipeline: the forward transform zero-pads
    inside K9 (its plain version here), the inverse runs K1."""
    padded, minor = [], []
    for name, log in (("fft_minor_padded", padded), ("fft_minor", minor)):
        real = getattr(minor_fft, name)

        def spy(xr, xi, _real=real, _log=log, **kw):
            _log.append(tuple(xr.shape))
            return _real(xr, xi, **kw)

        monkeypatch.setattr(minor_fft, name, spy)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    got = tpufft_torch.czt(x, m, w, config=CFG, device=CPU)
    assert got.dtype == np.complex64
    tp = tpufft.czt(jnp.asarray(x), m, w, config=TP_CFG)
    assert _err(got, tp) < 2e-5
    assert _err(got, sps.czt(x.astype(np.float64), m, w)) < 2e-4
    L = tpufft_torch.next_fast_len(shape[-1] + m - 1, aligned=True)
    assert padded == [(shape[0], shape[-1])] and minor == [(shape[0], L)]


def test_czt_forms_and_plan_reuse():
    xr = np.random.default_rng(5).standard_normal((2, 32)).astype(np.float32)
    xi = np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32)
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    plan = CZT(32, 32, config=CFG)
    out = plan(SplitComplex(torch.from_numpy(xr), torch.from_numpy(xi)))
    assert isinstance(out, SplitComplex) and _err(out.numpy(), want) < 2e-4
    out = tpufft_torch.czt(SplitComplex(torch.from_numpy(xr),
                                        torch.from_numpy(xi)), config=CFG)
    assert isinstance(out, SplitComplex) and _err(out.numpy(), want) < 2e-4
    t = plan(torch.from_numpy(xr + 1j * xi))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.complex64
    assert _err(t.numpy(), want) < 2e-4
    # float64 runs the same pipeline in f64 (the Stockham: backend "auto")
    t64 = CZT(32, 32)(torch.from_numpy(xr.astype(np.float64) + 1j * xi))
    assert t64.dtype == torch.complex128 and _err(t64.numpy(), want) < 1e-10
    plan = CZT(20, 15, np.exp(-0.3j), np.exp(0.2j), device=CPU)
    np.testing.assert_allclose(
        plan.points(), sps.CZT(20, 15, np.exp(-0.3j), np.exp(0.2j)).points(),
        rtol=1e-12)
    for seed in (7, 8):
        x = _c128(20, seed)
        assert _err(plan(x), sps.czt(x, 15, np.exp(-0.3j),
                                     np.exp(0.2j))) < 1e-9


def test_czt_errors():
    with pytest.raises(ValueError, match="length"):
        CZT(16)(np.zeros(17, np.complex128))
    for kw in (dict(n=0), dict(n=8, m=0), dict(n=8, w=0)):
        with pytest.raises(ValueError):
            CZT(**kw)
        with pytest.raises(ValueError):
            tpufft.CZT(**kw)


@pytest.mark.parametrize("m", [1, 7, 16])
@pytest.mark.parametrize("w,a", [(None, 1 + 0j),
                                 (np.exp(-0.37j), 0.5 + 0.1j)])
def test_czt_points(m, w, a):
    np.testing.assert_allclose(tpufft_torch.czt_points(m, w, a),
                               sps.czt_points(m, w, a), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("fn", [0.6, (0.1, 0.4)])
@pytest.mark.parametrize("m", [None, 25])
@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft(fn, m, endpoint):
    x = _c128(40, 9)
    want = sps.zoom_fft(x, fn, m=m, endpoint=endpoint)
    got = tpufft_torch.zoom_fft(x, fn, m=m, endpoint=endpoint, device=CPU)
    assert _err(got, want) < 1e-9
    x32 = x.astype(np.complex64)
    got = tpufft_torch.zoom_fft(x32, fn, m=m, endpoint=endpoint, config=CFG,
                                device=CPU)
    tp = tpufft.zoom_fft(x32, fn, m=m, endpoint=endpoint, config=TP_CFG)
    assert _err(got, tp) < 2e-5


def test_zoom_fft_fs_full_band_and_class():
    x = np.random.default_rng(10).standard_normal(64)
    assert _err(tpufft_torch.zoom_fft(x, (10.0, 40.0), m=33, fs=100.0,
                                      device=CPU),
                sps.zoom_fft(x, (10.0, 40.0), m=33, fs=100.0)) < 1e-9
    z = _c128(50, 11)
    assert _err(tpufft_torch.zoom_fft(z, 2, device=CPU), np.fft.fft(z)) < 1e-9
    plan = ZoomFFT(30, (0.2, 0.8), m=12, device=CPU)
    x = np.random.default_rng(12).standard_normal((5, 30))
    assert _err(plan(x), sps.zoom_fft(x, (0.2, 0.8), m=12)) < 1e-9


def test_czt_grad():
    """gradcheck in f64 on the device pipeline (f64 tables, the Stockham
    transforms), and the f32 gradient against tpufft's jax.grad."""
    plan = CZT(8, 5, np.exp(-0.15j))
    xr = torch.randn(2, 8, dtype=torch.float64, requires_grad=True)
    xi = torch.randn(2, 8, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: tuple(plan(SplitComplex(a, b))), (xr, xi))
    import jax
    x = np.random.default_rng(13).standard_normal((3, 32)).astype(np.float32)
    tp_plan = tpufft.CZT(32, 20, np.exp(-0.15j), config=TP_CFG)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(jnp.real(tp_plan(v)) ** 2))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    plan = CZT(32, 20, np.exp(-0.15j), config=CFG)
    torch.sum(plan(xt).real ** 2).backward()
    assert np.max(np.abs(xt.grad.numpy() - ref)) / np.max(np.abs(ref)) < 2e-5


# ----------------------------------------------------------------------------
# fht / ifht / fhtoffset
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mu", [0.0, 0.5, 2.0, -0.5])
@pytest.mark.parametrize("bias", [0.0, 0.3, -0.2])
def test_fht_matches_scipy(mu, bias):
    r = np.logspace(-4, 4, 64)
    dln = np.log(r[1] / r[0])
    off = tpufft_torch.fhtoffset(dln, mu, initial=0.1, bias=bias)
    assert off == pytest.approx(sfft.fhtoffset(dln, mu, initial=0.1,
                                               bias=bias), abs=1e-12)
    assert off == tpufft.fhtoffset(dln, mu, initial=0.1, bias=bias)
    a = np.random.default_rng(14).standard_normal((3, 64))
    got = tpufft_torch.fht(a, dln, mu, offset=off, bias=bias, device=CPU)
    ref = sfft.fht(a, dln, mu, offset=off, bias=bias)
    assert got.dtype == np.float64 and _err(got, ref) < 1e-10
    a32 = a.astype(np.float32)
    got = tpufft_torch.fht(a32, dln, mu, offset=off, bias=bias, config=CFG,
                           device=CPU)
    tp = tpufft.fht(jnp.asarray(a32), dln, mu, offset=off, bias=bias,
                    config=TP_CFG)
    # tpufft's f32 result strays up to 2.6e-5 from the f64 transform of the
    # same f32 input; the port is held to that f64 result, and to tpufft
    # within tpufft's own distance from it
    truth = sfft.fht(a32.astype(np.float64), dln, mu, offset=off, bias=bias)
    assert got.dtype == np.float32 and _err(got, truth) < 2e-5
    assert _err(got, tp) < 2e-5 + _err(tp, truth)


@pytest.mark.parametrize("n", [63, 64, 101])
def test_ifht_roundtrip(n):
    dln = 0.08
    a = np.random.default_rng(n).standard_normal((2, n))
    A = tpufft_torch.fht(a, dln, mu=1.0, offset=0.2, device=CPU)
    back = tpufft_torch.ifht(A, dln, mu=1.0, offset=0.2, device=CPU)
    assert _err(back, a) < 1e-10
    ref = sfft.ifht(sfft.fht(a, dln, 1.0, offset=0.2), dln, 1.0, offset=0.2)
    assert _err(back, ref) < 1e-10
    back = tpufft_torch.ifht(A, dln, mu=1.0, offset=0.2, bias=0.1,
                             device=CPU)
    assert _err(back, sfft.ifht(A, dln, 1.0, offset=0.2, bias=0.1)) < 1e-10


def test_fht_analytical():
    """r^{mu+1} e^{-r^2/2} is self-reciprocal under the Hankel transform
    (Hamilton 2000); the discrete result matches scipy's everywhere."""
    mu = 0.0
    r = np.logspace(-7, 1, 128)
    dln = np.log(r[1] / r[0])
    offset = tpufft_torch.fhtoffset(dln, mu, initial=-6 * np.log(10))
    k = np.exp(offset) / r[::-1]
    a_r = r ** (mu + 1) * np.exp(-r ** 2 / 2)
    A = tpufft_torch.fht(a_r, dln, mu=mu, offset=offset, device=CPU)
    a_k = k ** (mu + 1) * np.exp(-k ** 2 / 2)
    sel = a_k > 0.05 * a_k.max()
    np.testing.assert_allclose(A[sel], a_k[sel], rtol=1e-3)
    assert _err(A, sfft.fht(a_r, dln, mu=mu, offset=offset)) < 1e-12


def test_fht_tensor_kernel_path_and_grad(monkeypatch):
    """A real f32 tensor stays a tensor and runs K7 then K8 (their plain
    versions here); the transform is differentiable."""
    calls = []
    for name in ("rfft_minor", "irfft_minor"):
        real = getattr(real_fft, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(real_fft, name, spy)
    a = np.random.default_rng(15).standard_normal((4, 96)).astype(np.float32)
    got = tpufft_torch.fht(torch.from_numpy(a), 0.05, mu=0.5, config=CFG)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    ref = sfft.fht(a.astype(np.float64), 0.05, mu=0.5)
    assert _err(got.numpy(), ref) < 1e-4
    assert calls == ["rfft_minor", "irfft_minor"]
    x = torch.randn(2, 16, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda v: tpufft_torch.fht(v, 0.1, mu=0.5, bias=0.2), (x,))


def test_fht_singular_warns_and_rejects_complex():
    with pytest.warns(UserWarning, match="singular transform"):
        tpufft_torch.fht(np.ones(16), 0.1, mu=0.0, bias=-3.0, device=CPU)
    with pytest.raises(TypeError):
        tpufft_torch.fht(np.ones(16, np.complex64), 0.1, mu=0.0, device=CPU)


# ----------------------------------------------------------------------------
# carrying tpufft's plans across, and the exported names
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,impulse_kind,axis", [(64, "real", -1),
                                                 (93, "complex", 1),
                                                 (1024, "complex", -1)])
def test_filter_plan_from_fields(n, impulse_kind, axis):
    rng = np.random.default_rng(n)
    h = rng.standard_normal(n)
    if impulse_kind == "complex":
        h = h + 1j * rng.standard_normal(n)
    tp_cfg = TPPlanConfig(interpret=True)
    tp_plan = tpufft.plan_filter(n, impulse=h, axis=axis, config=tp_cfg)
    plan = filter_plan_from_fields(tp_plan.n, tp_plan._c, tp_plan.axis,
                                   dataclasses.asdict(tp_plan.config),
                                   device=CPU)
    assert plan.n == n and plan.axis == axis
    assert plan.config == PlanConfig(**dataclasses.asdict(tp_cfg))
    assert plan._real_matrix == tp_plan._real_matrix
    shape = (3, n, 4) if axis == 1 else (3, n)
    x = rng.standard_normal(shape).astype(np.float32)
    assert _err(plan(x), tp_plan(x)) < 2e-5


@pytest.mark.parametrize("make", [
    lambda m: m.CZT(24, 16),
    lambda m: m.CZT(24, 40, np.exp(-0.2j), np.exp(0.3j)),
    lambda m: m.ZoomFFT(24, (0.1, 0.5), m=20),
], ids=["default-spiral", "spiral", "zoom"])
def test_czt_plan_from_fields(make):
    tp_plan = make(tpufft)
    plan = czt_plan_from_fields(tp_plan.n, tp_plan.m, tp_plan.w, tp_plan.a,
                                dataclasses.asdict(tp_plan.config),
                                device=CPU)
    assert (plan.n, plan.m) == (tp_plan.n, tp_plan.m)
    np.testing.assert_allclose(plan.points(), tp_plan.points(), rtol=1e-12)
    x = _c128((2, 24), 16)
    assert _err(plan(x), tp_plan(x)) < 1e-9
    x32 = x.astype(np.complex64)
    assert _err(plan(x32), tp_plan(x32)) < 2e-5


NEW_NAMES = ("plan_filter", "FilterPlan", "fftconvolve", "oaconvolve",
             "correlate", "hilbert", "hilbert2", "resample", "envelope",
             "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
             "CZT", "ZoomFFT", "czt", "zoom_fft", "czt_points",
             "fht", "ifht", "fhtoffset")


def test_new_names_exported():
    assert len(NEW_NAMES) == 25
    for name in NEW_NAMES:
        assert name in tpufft_torch.__all__ and hasattr(tpufft_torch, name)
        assert hasattr(tpufft, name)

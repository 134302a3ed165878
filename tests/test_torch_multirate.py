"""The port's multirate layer (upfirdn, resample_poly, decimate) against
tpufft.multirate and scipy.signal.

The same seeded numpy inputs go through tpufft on the CPU (float64 under
the x64 test config; jax.Array float32 for its device path) and through
the port with ``device="cpu"`` (the FFT convolution on the kernels' plain
versions for float32 tensors). Tolerances: float64 to 1e-9, float32
tensors to rtol 2e-4 / atol 2e-5 against scipy in float64 (5e-4 / 5e-5
for the IIR decimate, tpufft's own)."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp
import tpufft
from tpufft import multirate as tp

import tpufft_torch
from tpufft_torch import multirate, signal
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

CPU = "cpu"
F64 = dict(atol=1e-9, rtol=0)
F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _both(got, tp_out, ref, **tol):
    tp_out = np.asarray(tp_out)
    assert got.shape == tp_out.shape == ref.shape
    np.testing.assert_allclose(got, tp_out, **tol)
    np.testing.assert_allclose(got, ref, **tol)


def test_exports():
    for name in multirate.__all__:
        assert name in tpufft.__all__ and name in tpufft_torch.__all__


# ----------------------------------------------------------------------------
# upfirdn


@pytest.mark.parametrize("up,down", [(1, 1), (3, 1), (1, 4), (2, 3),
                                     (5, 2)])
def test_upfirdn_matches(rng, up, down):
    x = rng.standard_normal((3, 500))
    h = rng.standard_normal(33)
    _both(multirate.upfirdn(h, x, up, down, device=CPU),
          tp.upfirdn(h, x, up, down), sps.upfirdn(h, x, up, down), **F64)


@pytest.mark.parametrize("mode", ["constant", "wrap", "edge", "smooth",
                                  "symmetric", "reflect", "antisymmetric",
                                  "antireflect", "line"])
def test_upfirdn_boundary_modes(rng, mode):
    x = rng.standard_normal((2, 300))
    h = rng.standard_normal(21)
    cval = 0.5 if mode == "constant" else 0
    _both(multirate.upfirdn(h, x, 2, 3, mode=mode, cval=cval, device=CPU),
          tp.upfirdn(h, x, 2, 3, mode=mode, cval=cval),
          sps.upfirdn(h, x, 2, 3, mode=mode, cval=cval), **F64)


def test_upfirdn_axis_and_int_input(rng):
    x = rng.integers(-5, 5, size=(40, 3))
    h = [1.0, 2.0, 1.0]
    _both(multirate.upfirdn(h, x, 2, 1, axis=0, device=CPU),
          tp.upfirdn(h, x, 2, 1, axis=0), sps.upfirdn(h, x, 2, 1, axis=0),
          atol=1e-12)


def test_upfirdn_complex(rng):
    x = rng.standard_normal((2, 120)) + 1j * rng.standard_normal((2, 120))
    h = rng.standard_normal(9)
    _both(multirate.upfirdn(h, x, 3, 2, device=CPU), tp.upfirdn(h, x, 3, 2),
          sps.upfirdn(h, x, 3, 2), **F64)
    hc = h + 1j * rng.standard_normal(9)
    _both(multirate.upfirdn(hc, x.real, 3, 2, device=CPU),
          tp.upfirdn(hc, x.real, 3, 2), sps.upfirdn(hc, x.real, 3, 2),
          **F64)


def test_upfirdn_docstring_identities():
    np.testing.assert_allclose(
        multirate.upfirdn([1, 1, 1], [1., 1, 1], device=CPU),
        [1, 2, 3, 2, 1], atol=1e-12)
    np.testing.assert_allclose(
        multirate.upfirdn([1], [1., 2, 3], 3, device=CPU),
        [1, 0, 0, 2, 0, 0, 3], atol=1e-12)
    np.testing.assert_allclose(
        multirate.upfirdn([1], np.arange(10.), 1, 3, device=CPU),
        [0, 3, 6, 9], atol=1e-12)


def test_upfirdn_errors(rng):
    x = rng.standard_normal(32)
    with pytest.raises(ValueError, match="mode"):
        multirate.upfirdn([1.0, 1.0], x, mode="bogus", device=CPU)
    with pytest.raises(ValueError, match="up and down"):
        multirate.upfirdn([1.0], x, up=0, device=CPU)
    with pytest.raises(ValueError, match="1-D"):
        multirate.upfirdn(np.ones((2, 2)), x, device=CPU)
    with pytest.raises(ValueError, match="longer"):
        multirate.upfirdn(np.ones(64), x[:8], mode="symmetric", device=CPU)


def test_upfirdn_f32_tensor_one_fftconvolve(rng, monkeypatch):
    x = rng.standard_normal((3, 400)).astype(np.float32)
    h = rng.standard_normal(17)
    calls = []
    real = signal.fftconvolve

    def spy(*args, **kw):
        calls.append(kw.get("axes"))
        return real(*args, **kw)

    monkeypatch.setattr(multirate, "fftconvolve", spy)
    y = multirate.upfirdn(h, torch.from_numpy(x), 2, 3)
    assert calls == [(1,)]
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    ref = sps.upfirdn(h, x.astype(np.float64), 2, 3)
    np.testing.assert_allclose(y.numpy(), ref, **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(tp.upfirdn(h, jnp.asarray(x), 2, 3)), **F32)


# ----------------------------------------------------------------------------
# resample_poly


@pytest.mark.parametrize("up,down", [(3, 2), (2, 5), (7, 3), (160, 441)])
def test_resample_poly_matches(rng, up, down):
    x = rng.standard_normal((3, 600))
    _both(multirate.resample_poly(x, up, down, axis=-1, device=CPU),
          tp.resample_poly(x, up, down, axis=-1),
          sps.resample_poly(x, up, down, axis=-1), **F64)


@pytest.mark.parametrize("padtype", ["constant", "mean", "median", "line",
                                     "maximum", "minimum"])
@pytest.mark.parametrize("n", [400, 401])
def test_resample_poly_padtypes(rng, padtype, n):
    x = rng.standard_normal(n) + 3.0
    _both(multirate.resample_poly(x, 2, 3, padtype=padtype, device=CPU),
          tp.resample_poly(x, 2, 3, padtype=padtype),
          sps.resample_poly(x, 2, 3, padtype=padtype), **F64)


def test_resample_poly_window_array_and_axis(rng):
    x = rng.standard_normal((200, 4))
    w = sps.firwin(31, 0.4)
    _both(multirate.resample_poly(x, 2, 1, axis=0, window=w, device=CPU),
          tp.resample_poly(x, 2, 1, axis=0, window=w),
          sps.resample_poly(x, 2, 1, axis=0, window=w), **F64)


def test_resample_poly_errors(rng):
    x = rng.standard_normal(64)
    with pytest.raises(ValueError, match=">= 1"):
        multirate.resample_poly(x, 0, 2, device=CPU)
    with pytest.raises(ValueError, match="cval"):
        multirate.resample_poly(x, 2, 3, padtype="mean", cval=1.0,
                                device=CPU)
    with pytest.raises(ValueError, match="padtype"):
        multirate.resample_poly(x, 2, 3, padtype="bogus", device=CPU)
    same = multirate.resample_poly(x, 3, 3, device=CPU)
    np.testing.assert_array_equal(same, x)


def test_resample_poly_f32_tensor(rng):
    x = rng.standard_normal((2, 300)).astype(np.float32)
    y = multirate.resample_poly(torch.from_numpy(x), 3, 2, axis=-1)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    ref = sps.resample_poly(x.astype(np.float64), 3, 2, axis=-1)
    np.testing.assert_allclose(y.numpy(), ref, **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(tp.resample_poly(jnp.asarray(x), 3, 2,
                                               axis=-1)), **F32)


# ----------------------------------------------------------------------------
# decimate


@pytest.mark.parametrize("ftype", ["fir", "iir"])
@pytest.mark.parametrize("zero_phase", [True, False])
@pytest.mark.parametrize("q", [2, 4, 13])
def test_decimate_matches(rng, ftype, zero_phase, q):
    x = rng.standard_normal((2, 800))
    _both(multirate.decimate(x, q, ftype=ftype, zero_phase=zero_phase,
                             device=CPU),
          tp.decimate(x, q, ftype=ftype, zero_phase=zero_phase),
          sps.decimate(x, q, ftype=ftype, zero_phase=zero_phase), **F64)


def test_decimate_axis_and_order(rng):
    x = rng.standard_normal((600, 3))
    _both(multirate.decimate(x, 3, axis=0, device=CPU),
          tp.decimate(x, 3, axis=0), sps.decimate(x, 3, axis=0), **F64)
    _both(multirate.decimate(x, 3, n=4, axis=0, device=CPU),
          tp.decimate(x, 3, n=4, axis=0), sps.decimate(x, 3, n=4, axis=0),
          **F64)
    _both(multirate.decimate(x, 3, n=30, ftype="fir", axis=0, device=CPU),
          tp.decimate(x, 3, n=30, ftype="fir", axis=0),
          sps.decimate(x, 3, n=30, ftype="fir", axis=0), **F64)


def test_decimate_errors(rng):
    x = rng.standard_normal(64)
    with pytest.raises(ValueError, match="ftype"):
        multirate.decimate(x, 2, ftype="bogus", device=CPU)
    with pytest.raises(ValueError, match="positive"):
        multirate.decimate(x, 0, device=CPU)


@pytest.mark.parametrize("ftype", ["iir", "fir"])
def test_decimate_f32_tensor(rng, ftype):
    x = rng.standard_normal((2, 600)).astype(np.float32)
    y = multirate.decimate(torch.from_numpy(x), 4, ftype=ftype)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    ref = sps.decimate(x.astype(np.float64), 4, ftype=ftype)
    np.testing.assert_allclose(y.numpy(), ref, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(tp.decimate(jnp.asarray(x), 4, ftype=ftype)),
        rtol=5e-4, atol=5e-5)


def test_numpy_input_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multirate.decimate(np.ones(256), 2)

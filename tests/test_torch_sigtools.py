"""The port's scipy.signal utility surface against tpufft.sigtools and
scipy.signal.

The same seeded numpy inputs go through tpufft on the CPU (float64 under
the x64 test config; jax.Array float32 for its device paths) and through
the port with ``device="cpu"``; tensors on the CPU take the torch paths
(the kernels' plain versions inside ``fftconvolve``, ``unfold`` windows
for direct convolution and the rank filters). Tolerances: float64 to
1e-9 (exact for integers, bool and the rank filters), float32 tensors to
rtol 2e-4 / atol 2e-5 against scipy in float64.

Where tpufft is known wrong the test pins scipy: tpufft's direct
convolution builds the whole outputs x kernel array
(``tpufft/sigtools.py:377``); the port's stays within its block budget."""

import tracemalloc

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp
import tpufft
from tpufft import sigtools as tp

import tpufft_torch
from tpufft_torch import sigtools
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

CPU = "cpu"
F64 = dict(atol=1e-9, rtol=0)
F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def rng():
    return np.random.default_rng(99)


def _both(got, tp_out, ref, **tol):
    tp_out = np.asarray(tp_out)
    assert np.shape(got) == tp_out.shape == np.shape(ref)
    np.testing.assert_allclose(got, tp_out, **tol)
    np.testing.assert_allclose(got, ref, **tol)


def test_exports():
    assert len(sigtools.__all__) == 14
    for name in sigtools.__all__:
        assert name in tpufft.__all__ and name in tpufft_torch.__all__


# ----------------------------------------------------------------------------
# detrend, wiener, deconvolve


@pytest.mark.parametrize("typ", ["constant", "linear"])
def test_detrend_matches(rng, typ):
    x = rng.standard_normal((3, 400)) + np.linspace(0, 5, 400)
    _both(sigtools.detrend(x, type=typ), tp.detrend(x, type=typ),
          sps.detrend(x, type=typ), atol=1e-12)


def test_detrend_breakpoints_and_axis(rng):
    x = rng.standard_normal((3, 400)) + np.linspace(0, 5, 400)
    _both(sigtools.detrend(x, bp=[100, 250]), tp.detrend(x, bp=[100, 250]),
          sps.detrend(x, bp=[100, 250]), atol=1e-12)
    _both(sigtools.detrend(x.T, axis=0), tp.detrend(x.T, axis=0),
          sps.detrend(x.T, axis=0), atol=1e-12)
    with pytest.raises(ValueError, match="Trend type"):
        sigtools.detrend(x, type="bogus")
    with pytest.raises(ValueError, match="Breakpoints"):
        sigtools.detrend(x, bp=[500])


@pytest.mark.parametrize("bp", [0, [100, 250]])
@pytest.mark.parametrize("axis", [-1, 0])
def test_detrend_tensor(rng, bp, axis):
    x = (rng.standard_normal((2, 300))
         + np.linspace(0, 3, 300)).astype(np.float32)
    x = x if axis == -1 else np.ascontiguousarray(x.T)
    y = sigtools.detrend(torch.from_numpy(x), axis=axis, bp=bp)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    ref = sps.detrend(x.astype(np.float64), axis=axis, bp=bp)
    np.testing.assert_allclose(y.numpy(), ref, **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(tp.detrend(jnp.asarray(x), axis=axis, bp=bp)),
        **F32)
    y64 = sigtools.detrend(torch.from_numpy(x.astype(np.float64)),
                           axis=axis, bp=bp)
    np.testing.assert_allclose(y64.numpy(), ref, atol=1e-12)


def test_wiener_matches(rng):
    im = rng.standard_normal((40, 40)) + 2
    _both(sigtools.wiener(im, device=CPU), tp.wiener(im), sps.wiener(im),
          **F64)
    _both(sigtools.wiener(im, mysize=5, noise=0.5, device=CPU),
          tp.wiener(im, mysize=5, noise=0.5),
          sps.wiener(im, mysize=5, noise=0.5), **F64)
    x1 = rng.standard_normal(200)
    _both(sigtools.wiener(x1, mysize=7, device=CPU), tp.wiener(x1, mysize=7),
          sps.wiener(x1, mysize=7), **F64)
    with pytest.raises(NotImplementedError, match="complex wiener"):
        sigtools.wiener(im + 0j, device=CPU)


def test_wiener_f32_tensor(rng):
    im = (rng.standard_normal((24, 24)) + 2).astype(np.float32)
    out = sigtools.wiener(torch.from_numpy(im))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    ref = sps.wiener(im.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(tp.wiener(jnp.asarray(im))),
                               rtol=1e-3, atol=1e-3)


def test_deconvolve_matches(rng):
    div = rng.standard_normal(7)
    div[0] = 2.0
    sig = np.convolve(div, rng.standard_normal(60))
    q1, r1 = sigtools.deconvolve(sig, div)
    q2, r2 = tp.deconvolve(sig, div)
    q0, r0 = sps.deconvolve(sig, div)
    _both(q1, q2, q0, atol=1e-10)
    _both(r1, r2, r0, atol=1e-10)
    np.testing.assert_allclose(np.convolve(div, q1) + r1, sig, atol=1e-9)
    q1, r1 = sigtools.deconvolve(sig[:3], div)
    assert q1.size == 0 and np.allclose(r1, sig[:3])
    with pytest.raises(ValueError, match="non-empty"):
        sigtools.deconvolve(np.zeros((2, 2)), div)


# ----------------------------------------------------------------------------
# correlation_lags, choose_conv_method


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("l1,l2", [(10, 7), (7, 10), (8, 8), (9, 4)])
def test_correlation_lags_matches(mode, l1, l2):
    got = sigtools.correlation_lags(l1, l2, mode)
    np.testing.assert_array_equal(got, tp.correlation_lags(l1, l2, mode))
    np.testing.assert_array_equal(got, sps.correlation_lags(l1, l2, mode))


def test_correlation_lags_pins_correlate(rng):
    a = rng.standard_normal(40)
    b = np.roll(a, 5)[:30]  # b[n] = a[n-5] -> peak at lag -5
    corr = tpufft_torch.correlate(a, b, mode="full", device=CPU)
    lags = sigtools.correlation_lags(len(a), len(b), "full")
    assert lags[np.argmax(corr)] == -5


def test_choose_conv_method_contract(rng):
    a, b = rng.standard_normal(5000), rng.standard_normal(500)
    for x, y in ((a, b), (np.arange(10), np.arange(5)),
                 (np.arange(1000), np.arange(600)),
                 (np.full(1000, 2 ** 40), np.full(600, 2 ** 20))):
        want = tp.choose_conv_method(x, y)
        assert sigtools.choose_conv_method(x, y) == want
        assert sigtools.choose_conv_method(torch.from_numpy(x),
                                           torch.from_numpy(y)) == want
    assert sigtools.choose_conv_method(a, b) == "fft"
    assert sigtools.choose_conv_method(np.arange(10),
                                       np.arange(5)) == "direct"
    c, times = sigtools.choose_conv_method(a[:1000], b[:100], measure=True,
                                           device=CPU)
    assert c in ("fft", "direct") and set(times) == {"fft", "direct"}
    with pytest.raises(ValueError, match="mode"):
        sigtools.correlation_lags(5, 5, "bogus")


# ----------------------------------------------------------------------------
# savgol


@pytest.mark.parametrize("mode", ["interp", "mirror", "constant",
                                  "nearest", "wrap"])
@pytest.mark.parametrize("wl,po,d", [(11, 3, 0), (21, 4, 1), (31, 5, 2)])
def test_savgol_matches(rng, mode, wl, po, d):
    x = rng.standard_normal((3, 300))
    kw = dict(mode=mode, deriv=d, delta=0.7)
    if mode == "constant":
        kw["cval"] = 1.5
    _both(sigtools.savgol_filter(x, wl, po, device=CPU, **kw),
          tp.savgol_filter(x, wl, po, **kw),
          sps.savgol_filter(x, wl, po, **kw), **F64)


def test_savgol_short_signal_modes(rng):
    """Pads longer than the signal (numpy's repeated reflection)."""
    x = rng.standard_normal((2, 9))
    for mode in ("mirror", "nearest", "wrap", "constant"):
        _both(sigtools.savgol_filter(x, 15, 2, mode=mode, device=CPU),
              tp.savgol_filter(x, 15, 2, mode=mode),
              sps.savgol_filter(x, 15, 2, mode=mode), **F64)


def test_savgol_axis_tensor_errors(rng):
    x = rng.standard_normal((200, 3))
    _both(sigtools.savgol_filter(x, 11, 3, axis=0, device=CPU),
          tp.savgol_filter(x, 11, 3, axis=0),
          sps.savgol_filter(x, 11, 3, axis=0), **F64)
    x32 = x.astype(np.float32)
    y = sigtools.savgol_filter(torch.from_numpy(x32), 11, 3, axis=0)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), sps.savgol_filter(x, 11, 3, axis=0),
                               **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(tp.savgol_filter(jnp.asarray(x32), 11, 3,
                                               axis=0)), **F32)
    with pytest.raises(ValueError, match="mode"):
        sigtools.savgol_filter(x, 11, 3, mode="bogus", device=CPU)
    with pytest.raises(ValueError, match="window_length"):
        sigtools.savgol_filter(x[:8], 11, 3, axis=0, device=CPU)


@pytest.mark.parametrize("args,kw", [
    ((31, 4), {}), ((31, 4), {"deriv": 2, "delta": 0.5}),
    ((11, 3), {"pos": 2}), ((10, 3), {}), ((9, 2), {"use": "dot"}),
    ((7, 2), {"deriv": 3})])
def test_savgol_coeffs(args, kw):
    got = sigtools.savgol_coeffs(*args, **kw)
    _both(got, tp.savgol_coeffs(*args, **kw), sps.savgol_coeffs(*args, **kw),
          atol=1e-12)


# ----------------------------------------------------------------------------
# convolve / convolve2d / correlate2d


class TestConvolve:
    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    @pytest.mark.parametrize("method", ["auto", "direct", "fft"])
    def test_int_exact(self, rng, mode, method):
        a = rng.integers(-9, 9, 40)
        b = rng.integers(-9, 9, 7)
        out = sigtools.convolve(a, b, mode, method, device=CPU)
        ref = sps.convolve(a, b, mode, method)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, tp.convolve(a, b, mode, method))
        t = sigtools.convolve(torch.from_numpy(a), torch.from_numpy(b), mode,
                              method)
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), ref)

    @pytest.mark.parametrize("shp1,shp2", [((20, 15), (4, 5)),
                                           ((6, 7, 8), (3, 2, 4)),
                                           ((5,), (12,))])
    @pytest.mark.parametrize("mode", ["full", "same"])
    @pytest.mark.parametrize("method", ["direct", "fft"])
    def test_float_nd(self, rng, shp1, shp2, mode, method):
        x = rng.standard_normal(shp1)
        h = rng.standard_normal(shp2)
        _both(sigtools.convolve(x, h, mode, method, device=CPU),
              tp.convolve(x, h, mode, method),
              sps.convolve(x, h, mode, method), **F64)
        t = sigtools.convolve(torch.from_numpy(x), torch.from_numpy(h), mode,
                              method)
        np.testing.assert_allclose(t.numpy(), sps.convolve(x, h, mode),
                                   **F64)

    def test_valid_swap_and_error(self, rng):
        x = rng.standard_normal((4, 5))
        h = rng.standard_normal((9, 9))
        _both(sigtools.convolve(x, h, "valid", device=CPU),
              tp.convolve(x, h, "valid"), sps.convolve(x, h, "valid"),
              **F64)
        with pytest.raises(ValueError):
            sigtools.convolve(rng.standard_normal((4, 9)),
                              rng.standard_normal((6, 3)), "valid")
        with pytest.raises(ValueError):
            sigtools.convolve(np.ones(4), np.ones((4, 4)))
        with pytest.raises(ValueError):
            sigtools.convolve(np.ones(4), np.ones(4), mode="bogus")
        with pytest.raises(ValueError):
            sigtools.convolve(np.ones(4), np.ones(4), method="bogus")

    @pytest.mark.parametrize("method", ["auto", "direct", "fft"])
    def test_bool_or_semantics(self, rng, method):
        # the OR-convolution (scipy's direct result) for every method
        a = rng.integers(0, 2, 30).astype(bool)
        b = rng.integers(0, 2, 5).astype(bool)
        out = sigtools.convolve(a, b, "full", method, device=CPU)
        ref = sps.convolve(a, b, "full", "direct")
        assert out.dtype == np.bool_
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, tp.convolve(a, b, "full", method))
        t = sigtools.convolve(torch.from_numpy(a), torch.from_numpy(b),
                              "full", method)
        assert t.dtype == torch.bool
        np.testing.assert_array_equal(t.numpy(), ref)

    @pytest.mark.parametrize("method", ["direct", "fft"])
    def test_complex(self, rng, method):
        a = rng.standard_normal(20) + 1j * rng.standard_normal(20)
        b = rng.standard_normal(6) + 1j * rng.standard_normal(6)
        out = sigtools.convolve(a, b, "full", method, device=CPU)
        ref = sps.convolve(a, b, "full", method)
        assert out.dtype == ref.dtype
        _both(out, tp.convolve(a, b, "full", method), ref, **F64)

    def test_f32_tensor(self, rng):
        x = rng.standard_normal(64).astype(np.float32)
        h = rng.standard_normal(9).astype(np.float32)
        out = sigtools.convolve(torch.from_numpy(x), torch.from_numpy(h),
                                "same")
        assert isinstance(out, torch.Tensor)
        ref = sps.convolve(x.astype(np.float64), h.astype(np.float64),
                           "same")
        np.testing.assert_allclose(out.numpy(), ref, **F32)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(tp.convolve(jnp.asarray(x),
                                                jnp.asarray(h), "same")),
            **F32)

    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    def test_direct_blocks_pin_scipy(self, rng, mode, monkeypatch):
        """Direct convolution in blocks over the leading axis: exact
        against scipy with blocks of one row, and its transient near the
        block budget (tpufft builds outputs x kernel at once: here
        ~40 MB, ~12x the budget)."""
        monkeypatch.setattr(sigtools, "_CHUNK_BYTES", 1 << 12)
        x = rng.standard_normal((30, 20))
        h = rng.standard_normal((5, 3))
        np.testing.assert_allclose(
            sigtools.convolve(x, h, mode, "direct"),
            sps.convolve(x, h, mode, "direct"), **F64)
        t = sigtools.convolve(torch.from_numpy(x), torch.from_numpy(h),
                              mode, "direct")
        np.testing.assert_allclose(t.numpy(), sps.convolve(x, h, mode),
                                   **F64)
        budget = 2 << 20
        monkeypatch.setattr(sigtools, "_CHUNK_BYTES", budget)
        img = rng.integers(-50, 50, (200, 200))
        ker = rng.integers(-50, 50, (21, 21))
        tracemalloc.start()
        try:
            got = sigtools.convolve(img, ker, mode, "direct")
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        np.testing.assert_array_equal(got, sps.convolve(img, ker, mode,
                                                        "direct"))
        outputs = got.nbytes + 240 ** 2 * 8   # the result and padded input
        assert peak < outputs + 3 * budget, peak


class TestConvolve2d:
    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    @pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
    def test_float_and_int(self, rng, mode, boundary):
        x = rng.standard_normal((12, 10))
        h = rng.standard_normal((4, 3))
        _both(sigtools.convolve2d(x, h, mode, boundary, device=CPU),
              tp.convolve2d(x, h, mode, boundary),
              sps.convolve2d(x, h, mode, boundary), atol=1e-8)
        t = sigtools.convolve2d(torch.from_numpy(x), torch.from_numpy(h),
                                mode, boundary)
        np.testing.assert_allclose(t.numpy(),
                                   sps.convolve2d(x, h, mode, boundary),
                                   atol=1e-8)
        xi = rng.integers(-5, 5, (12, 10))
        hi = rng.integers(-5, 5, (4, 3))
        ref = sps.convolve2d(xi, hi, mode, boundary)
        np.testing.assert_array_equal(
            sigtools.convolve2d(xi, hi, mode, boundary, device=CPU), ref)
        np.testing.assert_array_equal(tp.convolve2d(xi, hi, mode, boundary),
                                      ref)

    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    @pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
    def test_correlate2d(self, rng, mode, boundary):
        x = rng.standard_normal((12, 10))
        h = rng.standard_normal((4, 3))
        _both(sigtools.correlate2d(x, h, mode, boundary, device=CPU),
              tp.correlate2d(x, h, mode, boundary),
              sps.correlate2d(x, h, mode, boundary), atol=1e-8)
        t = sigtools.correlate2d(torch.from_numpy(x), torch.from_numpy(h),
                                 mode, boundary)
        np.testing.assert_allclose(t.numpy(),
                                   sps.correlate2d(x, h, mode, boundary),
                                   atol=1e-8)

    def test_even_kernel_same_centering(self, rng):
        x = rng.standard_normal((12, 10))
        h = rng.standard_normal((4, 4))
        for fn in ("convolve2d", "correlate2d"):
            for boundary in ("fill", "wrap"):
                _both(getattr(sigtools, fn)(x, h, "same", boundary,
                                            device=CPU),
                      getattr(tp, fn)(x, h, "same", boundary),
                      getattr(sps, fn)(x, h, "same", boundary), atol=1e-8)

    def test_fillvalue_and_complex(self, rng):
        x = rng.standard_normal((12, 10))
        h = rng.standard_normal((4, 3))
        _both(sigtools.convolve2d(x, h, "full", "fill", 2.5, device=CPU),
              tp.convolve2d(x, h, "full", "fill", 2.5),
              sps.convolve2d(x, h, "full", "fill", 2.5), atol=1e-8)
        t = sigtools.convolve2d(torch.from_numpy(x), torch.from_numpy(h),
                                "full", "fill", 2.5)
        np.testing.assert_allclose(t.numpy(),
                                   sps.convolve2d(x, h, "full", "fill", 2.5),
                                   atol=1e-8)
        xc = x + 1j * rng.standard_normal((12, 10))
        hc = h + 1j * rng.standard_normal((4, 3))
        _both(sigtools.correlate2d(xc, hc, "full", device=CPU),
              tp.correlate2d(xc, hc, "full"),
              sps.correlate2d(xc, hc, "full"), atol=1e-8)
        t = sigtools.correlate2d(torch.from_numpy(xc), torch.from_numpy(hc),
                                 "full")
        np.testing.assert_allclose(t.numpy(), sps.correlate2d(xc, hc, "full"),
                                   atol=1e-8)

    def test_errors(self):
        with pytest.raises(ValueError):
            sigtools.convolve2d(np.ones(5), np.ones((2, 2)))
        with pytest.raises(ValueError):
            sigtools.convolve2d(np.ones((5, 5)), np.ones((2, 2)),
                                boundary="bogus")
        with pytest.raises(ValueError):
            sigtools.convolve2d(np.ones((3, 3)), np.ones((5, 5)),
                                "full", "wrap")


# ----------------------------------------------------------------------------
# rank filters and vectorstrength


class TestRankFilters:
    @pytest.mark.parametrize("rank", [0, 5, 12])
    def test_order_filter(self, rng, rank):
        a = rng.standard_normal((12, 11))
        dom = np.ones((3, 5))
        dom[0, 0] = 0
        dom[2, 4] = 0
        ref = sps.order_filter(a, dom, rank)
        _both(sigtools.order_filter(a, dom, rank),
              tp.order_filter(a, dom, rank), ref, atol=0)
        t = sigtools.order_filter(torch.from_numpy(a), dom, rank)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), ref)

    def test_order_filter_errors(self, rng):
        a = rng.standard_normal((12, 11))
        with pytest.raises(ValueError):
            sigtools.order_filter(a, np.ones((2, 3)), 1)   # even domain
        with pytest.raises(ValueError):
            sigtools.order_filter(a, np.ones((3, 5)), 15)  # rank too big

    @pytest.mark.parametrize("ks", [3, (3, 5), (5, 3)])
    def test_medfilt_2d(self, rng, ks):
        a = rng.standard_normal((12, 11))
        ref = sps.medfilt(a, ks)
        _both(sigtools.medfilt(a, ks), tp.medfilt(a, ks), ref, atol=0)
        np.testing.assert_array_equal(
            sigtools.medfilt(torch.from_numpy(a), ks).numpy(), ref)

    def test_medfilt_other_ranks(self, rng):
        v = rng.standard_normal(300)
        _both(sigtools.medfilt(v, 7), tp.medfilt(v, 7), sps.medfilt(v, 7),
              atol=0)
        v3 = rng.standard_normal((6, 7, 8))
        ref = sps.medfilt(v3, (3, 3, 5))
        _both(sigtools.medfilt(v3, (3, 3, 5)), tp.medfilt(v3, (3, 3, 5)),
              ref, atol=0)
        np.testing.assert_array_equal(
            sigtools.medfilt(torch.from_numpy(v3), (3, 3, 5)).numpy(), ref)
        a = rng.standard_normal((12, 11))
        _both(sigtools.medfilt2d(a, 5), tp.medfilt2d(a, 5),
              sps.medfilt2d(a, 5), atol=0)
        a32 = a.astype(np.float32)
        t = sigtools.medfilt2d(torch.from_numpy(a32), 5)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), sps.medfilt2d(a32, 5))
        with pytest.raises(ValueError):
            sigtools.medfilt(v, 4)                          # even kernel
        with pytest.raises(ValueError):
            sigtools.medfilt2d(v, 3)                        # not 2-D

    def test_rank_filter_chunked_path(self, rng, monkeypatch):
        monkeypatch.setattr(sigtools, "_CHUNK_BYTES", 1 << 12)
        a = rng.standard_normal((64, 50))
        ref = sps.medfilt(a, (5, 3))
        np.testing.assert_array_equal(sigtools.medfilt(a, (5, 3)), ref)
        np.testing.assert_array_equal(
            sigtools.medfilt(torch.from_numpy(a), (5, 3)).numpy(), ref)


def test_vectorstrength(rng):
    ev = rng.uniform(0, 100, 200)
    for period in (3.7, [1.0, 2.5, 7.7]):
        got = sigtools.vectorstrength(ev, period)
        _both(got[0], tp.vectorstrength(ev, period)[0],
              sps.vectorstrength(ev, period)[0], atol=1e-12)
        _both(got[1], tp.vectorstrength(ev, period)[1],
              sps.vectorstrength(ev, period)[1], atol=1e-12)
    with pytest.raises(ValueError):
        sigtools.vectorstrength(ev, -1.0)
    with pytest.raises(ValueError):
        sigtools.vectorstrength(np.ones((2, 2)), 1.0)


def test_numpy_input_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sigtools.wiener(np.ones((8, 8)))

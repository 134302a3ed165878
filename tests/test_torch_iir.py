"""The port's IIR layer (sosfilt, sosfiltfilt, lfilter, filtfilt) against
tpufft.iir and scipy.signal.

The same seeded numpy inputs go through tpufft on the CPU (float64 under
the x64 test config; jax.Array float32 for the device path) and through
the port with ``device="cpu"``. Tolerances: float64 to 1e-9 (the scan
reassociates the recurrence: ~1e-14 in practice), float32 tensors to
rtol 2e-4 / atol 2e-5 against scipy in float64 (tpufft's own card-side
contract, tests/test_multirate.py), the gradient by
``torch.autograd.gradcheck`` in float64."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp
import tpufft
from tpufft import design as tp_design
from tpufft import iir as tp

import tpufft_torch
from tpufft_torch import iir
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

CPU = "cpu"
F64 = dict(atol=1e-9, rtol=0)
F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _both(got, tp_out, ref, **tol):
    np.testing.assert_allclose(got, np.asarray(tp_out), **tol)
    np.testing.assert_allclose(got, ref, **tol)


def test_exports():
    for name in iir.__all__:
        assert name in tpufft.__all__ and name in tpufft_torch.__all__


# ----------------------------------------------------------------------------
# the scan


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 255, 256, 257, 4099])
@pytest.mark.parametrize("S", [1, 2, 5])
def test_affine_scan_matches_the_recurrence(n, S):
    """z[k] = M z[k-1] + u[k] against a sequential loop, on every block
    edge (BLOCK = 16) and two carry levels."""
    g = np.random.default_rng(n * 10 + S)
    M = g.standard_normal((S, S))
    M *= 0.95 / max(abs(np.linalg.eigvals(M)))   # a stable recurrence
    u = g.standard_normal((S, 3, n))
    zi = g.standard_normal((S, 3))
    z = iir._affine_scan([torch.from_numpy(p) for p in u],
                         [torch.from_numpy(p) for p in zi], M)
    ref = np.empty((S, 3, n))
    state = zi
    for k in range(n):
        state = np.einsum("ij,jb->ib", M, state) + u[:, :, k]
        ref[:, :, k] = state
    np.testing.assert_allclose(torch.stack(z).numpy(), ref, atol=1e-12,
                               rtol=1e-12)


# ----------------------------------------------------------------------------
# sosfilt / sosfiltfilt


def test_sosfilt_matches(rng):
    sos = sps.cheby1(8, 0.05, 0.3, output="sos")
    x = rng.standard_normal((3, 700))
    _both(iir.sosfilt(sos, x, device=CPU), tp.sosfilt(sos, x),
          sps.sosfilt(sos, x), **F64)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 257, 4099])
def test_sosfilt_block_edges(n):
    """Lengths on and beside the block edges (BLOCK = 16) and the carry
    levels, with the final state."""
    sos = sps.ellip(6, 0.5, 50, 0.2, output="sos")
    x = np.random.default_rng(n).standard_normal((3, n))
    zi = np.random.default_rng(n + 1).standard_normal((3, 3, 2))
    y1, zf1 = iir.sosfilt(sos, x, zi=zi, device=CPU)
    y0, zf0 = sps.sosfilt(sos, x, zi=zi)
    np.testing.assert_allclose(y1, y0, **F64)
    np.testing.assert_allclose(zf1, zf0, **F64)


def test_sosfilt_zi_and_zf(rng):
    sos = sps.butter(4, 0.2, output="sos")
    x = rng.standard_normal((2, 300))
    zi = np.tile(sps.sosfilt_zi(sos)[:, None, :], (1, 2, 1))
    y1, zf1 = iir.sosfilt(sos, x, zi=zi, device=CPU)
    y2, zf2 = tp.sosfilt(sos, x, zi=zi)
    y0, zf0 = sps.sosfilt(sos, x, zi=zi)
    _both(y1, y2, y0, atol=1e-12)
    _both(zf1, zf2, zf0, atol=1e-12)
    # streaming: two chunks with carried state == one call
    ya, zfa = iir.sosfilt(sos, x[:, :100], zi=np.zeros_like(zi), device=CPU)
    yb, _ = iir.sosfilt(sos, x[:, 100:], zi=zfa, device=CPU)
    np.testing.assert_allclose(np.concatenate([ya, yb], -1),
                               sps.sosfilt(sos, x), atol=1e-12)


def test_sosfilt_axis0(rng):
    sos = sps.butter(6, 0.3, output="sos")
    x = rng.standard_normal((250, 3))
    _both(iir.sosfilt(sos, x, axis=0, device=CPU),
          tp.sosfilt(sos, x, axis=0), sps.sosfilt(sos, x, axis=0), **F64)


def test_sosfilt_errors(rng):
    with pytest.raises(ValueError, match="n_sections"):
        iir.sosfilt(np.ones((2, 5)), np.ones(16), device=CPU)
    with pytest.raises(ValueError, match="zi"):
        iir.sosfilt(sps.butter(2, 0.5, output="sos"), np.ones(16),
                    zi=np.ones((1, 3)), device=CPU)
    with pytest.raises(NotImplementedError, match="complex sosfilt"):
        iir.sosfilt(sps.butter(2, 0.5, output="sos"), np.ones(16) + 0j,
                    device=CPU)
    with pytest.raises(NotImplementedError, match="complex sosfilt"):
        tp.sosfilt(sps.butter(2, 0.5, output="sos"), np.ones(16) + 0j)


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_sosfiltfilt_matches(rng, padtype):
    sos = sps.cheby1(6, 0.1, 0.25, output="sos")
    x = rng.standard_normal((2, 500))
    _both(iir.sosfiltfilt(sos, x, padtype=padtype, device=CPU),
          tp.sosfiltfilt(sos, x, padtype=padtype),
          sps.sosfiltfilt(sos, x, padtype=padtype), **F64)


def test_sosfiltfilt_padlen_and_errors(rng):
    sos = sps.butter(4, 0.2, output="sos")
    x = rng.standard_normal(200)
    _both(iir.sosfiltfilt(sos, x, padlen=50, device=CPU),
          tp.sosfiltfilt(sos, x, padlen=50),
          sps.sosfiltfilt(sos, x, padlen=50), **F64)
    with pytest.raises(ValueError, match="padlen"):
        iir.sosfiltfilt(sos, x[:10], device=CPU)
    with pytest.raises(ValueError, match="padtype"):
        iir.sosfiltfilt(sos, x, padtype="bogus", device=CPU)


def test_sosfilt_f32_tensor_and_grad(rng):
    sos = sps.butter(4, 0.25, output="sos")
    x = rng.standard_normal((2, 300)).astype(np.float32)
    y = iir.sosfilt(sos, torch.from_numpy(x))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    ref = sps.sosfilt(sos, x.astype(np.float64))
    np.testing.assert_allclose(y.numpy(), ref, **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(tp.sosfilt(sos, jnp.asarray(x))), **F32)
    xt = torch.from_numpy(x).requires_grad_()
    (iir.sosfilt(sos, xt) ** 2).sum().backward()
    assert torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("fn", ["sosfilt", "lfilter"])
def test_gradcheck_f64(fn):
    """The scan's gradient with respect to the signal and the initial
    state, against finite differences (n = 37: three blocks and a carry
    level)."""
    g = np.random.default_rng(5)
    x = torch.tensor(g.standard_normal((2, 37)), requires_grad=True)
    if fn == "sosfilt":
        sos = sps.butter(4, 0.3, output="sos")
        zi = torch.tensor(g.standard_normal((2, 2, 2)), requires_grad=True)
        f = lambda x, zi: iir.sosfilt(sos, x, zi=zi)  # noqa: E731
    else:
        b, a = sps.butter(2, 0.2)
        zi = torch.tensor(g.standard_normal((2, 2)), requires_grad=True)
        f = lambda x, zi: iir.lfilter(b, a, x, zi=zi)  # noqa: E731
    assert torch.autograd.gradcheck(f, (x, zi))


# ----------------------------------------------------------------------------
# lfilter / filtfilt


def test_lfilter_iir_matches(rng):
    b, a = sps.butter(5, 0.25)
    x = rng.standard_normal((3, 600))
    _both(iir.lfilter(b, a, x, device=CPU), tp.lfilter(b, a, x),
          sps.lfilter(b, a, x), **F64)
    zi = np.tile(sps.lfilter_zi(b, a), (3, 1))
    y1, zf1 = iir.lfilter(b, a, x, zi=zi, device=CPU)
    y2, zf2 = tp.lfilter(b, a, x, zi=zi)
    y0, zf0 = sps.lfilter(b, a, x, zi=zi)
    _both(y1, y2, y0, **F64)
    _both(zf1, zf2, zf0, **F64)


def test_lfilter_fir_paths(rng, monkeypatch):
    bf = sps.firwin(101, 0.3)  # order 100 > the scan's cap: one FFT conv
    x = rng.standard_normal((2, 400))
    from tpufft_torch import signal
    calls = []
    real = signal.fftconvolve

    def spy(*args, **kw):
        calls.append(tuple(args[1].shape))
        return real(*args, **kw)

    monkeypatch.setattr(signal, "fftconvolve", spy)
    _both(iir.lfilter(bf, [1.0], x, device=CPU), tp.lfilter(bf, [1.0], x),
          sps.lfilter(bf, [1.0], x), **F64)
    assert calls == [(1, 101)]
    zi = rng.standard_normal((2, 100))
    for xs in (x, x[:, :50]):  # the second shorter than the filter
        y1, zf1 = iir.lfilter(bf, [1.0], xs, zi=zi, device=CPU)
        y2, zf2 = tp.lfilter(bf, [1.0], xs, zi=zi)
        y0, zf0 = sps.lfilter(bf, [1.0], xs, zi=zi)
        _both(y1, y2, y0, **F64)
        _both(zf1, zf2, zf0, **F64)


def test_lfilter_long_b_arma_and_errors(rng):
    x = rng.standard_normal((2, 300))
    blong = sps.firwin(64, 0.4)
    a2 = [1.0, -0.5, 0.25]
    _both(iir.lfilter(blong, a2, x, device=CPU), tp.lfilter(blong, a2, x),
          sps.lfilter(blong, a2, x), **F64)
    with pytest.raises(ValueError, match="second-order sections"):
        iir.lfilter(blong, np.r_[1.0, np.ones(30)], x,
                    zi=np.zeros((2, 63)), device=CPU)
    with pytest.raises(ValueError, match="nonzero"):
        iir.lfilter([1.0], [0.0, 1.0], x, device=CPU)
    with pytest.raises(ValueError, match="zi"):
        iir.lfilter([1.0, 0.5], [1.0, -0.3], x, zi=np.zeros((2, 7)),
                    device=CPU)
    with pytest.raises(NotImplementedError, match="complex lfilter"):
        iir.lfilter([1.0, 0.5], [1.0, -0.3], x + 0j, device=CPU)


def test_lfilter_high_order_takes_sos(rng, monkeypatch):
    """A zero-state IIR of order 3 and up runs tf2sos -> the cascade."""
    b, a = sps.butter(6, 0.3)
    x = rng.standard_normal((2, 500))
    seen = []
    real = iir._sosfilt

    def spy(sos, *args):
        seen.append(sos.shape)
        return real(sos, *args)

    monkeypatch.setattr(iir, "_sosfilt", spy)
    _both(iir.lfilter(b, a, x, device=CPU), tp.lfilter(b, a, x),
          sps.lfilter(b, a, x), **F64)
    assert seen == [(3, 6)]


def test_lfilter_f32_tensor(rng):
    b, a = sps.butter(2, 0.3)
    x = rng.standard_normal((2, 500)).astype(np.float32)
    zi = np.tile(sps.lfilter_zi(b, a), (2, 1)).astype(np.float32)
    y, zf = iir.lfilter(b, a, torch.from_numpy(x), zi=torch.from_numpy(zi))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    y0, zf0 = sps.lfilter(b, a, x.astype(np.float64), zi=zi)
    np.testing.assert_allclose(y.numpy(), y0, **F32)
    np.testing.assert_allclose(zf.numpy(), zf0, **F32)
    y2, _ = tp.lfilter(b, a, jnp.asarray(x), zi=jnp.asarray(zi))
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), **F32)


@pytest.mark.parametrize("padtype", ["odd", "even", "constant", None])
def test_filtfilt_matches(rng, padtype):
    b, a = sps.butter(2, 0.2)
    x = rng.standard_normal((2, 400))
    _both(iir.filtfilt(b, a, x, padtype=padtype, device=CPU),
          tp.filtfilt(b, a, x, padtype=padtype),
          sps.filtfilt(b, a, x, padtype=padtype), **F64)
    b4, a4 = sps.butter(4, 0.2)  # order 4: the SOS route
    _both(iir.filtfilt(b4, a4, x, padtype=padtype, device=CPU),
          tp.filtfilt(b4, a4, x, padtype=padtype),
          sps.filtfilt(b4, a4, x, padtype=padtype), **F64)


def test_filtfilt_padlen_and_gust(rng):
    b, a = sps.butter(3, 0.3)
    x = rng.standard_normal(300)
    _both(iir.filtfilt(b, a, x, padlen=33, device=CPU),
          tp.filtfilt(b, a, x, padlen=33),
          sps.filtfilt(b, a, x, padlen=33), **F64)
    with pytest.raises(NotImplementedError, match="gust|pad"):
        iir.filtfilt(b, a, x, method="gust", device=CPU)
    with pytest.raises(NotImplementedError, match="irlen"):
        iir.filtfilt(b, a, x, irlen=10, device=CPU)
    with pytest.raises(ValueError, match="padlen"):
        iir.filtfilt(b, a, x[:5], device=CPU)


def test_gammatone_through_lfilter_and_filtfilt():
    """An order-8 gammatone (4 repeated pole pairs at radius ~0.98) through
    the SOS route of lfilter and filtfilt, and a longer numerator through
    FIR o AR + SOS (tpufft's own regression cases)."""
    fs = 16000.0
    t = np.arange(2048) / fs
    x = np.sin(2 * np.pi * 300 * t) + np.sin(2 * np.pi * 2000 * t)
    b, a = tp_design.gammatone(300.0, "iir", fs=fs)
    y = iir.lfilter(b, a, x, device=CPU)
    np.testing.assert_allclose(y, sps.lfilter(b, a, x), atol=1e-5)
    np.testing.assert_allclose(y, np.asarray(tp.lfilter(b, a, x)), **F64)
    y = iir.filtfilt(b, a, x, device=CPU)
    np.testing.assert_allclose(y, sps.filtfilt(b, a, x), atol=2e-4)
    np.testing.assert_allclose(y, np.asarray(tp.filtfilt(b, a, x)), **F64)
    bb = np.convolve(b, [1.0, 0.5, 0.25, 0.1, 0.05, 0.02])
    y = iir.lfilter(bb, a, x, device=CPU)
    np.testing.assert_allclose(y, sps.lfilter(bb, a, x), atol=1e-4)
    np.testing.assert_allclose(y, np.asarray(tp.lfilter(bb, a, x)), **F64)


def test_numpy_input_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        iir.sosfilt(sps.butter(2, 0.3, output="sos"), np.ones(64))

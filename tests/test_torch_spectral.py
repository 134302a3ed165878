"""The port's spectral layer against tpufft and scipy.signal.

Seeded numpy signals go through tpufft (jax f32 arrays; its fused kernels
in interpret mode with ``PlanConfig(interpret=True)``, which they serve at
hop 128 only, or its host float64 tier for numpy) and through the port on
the CPU (f32 tensors take the kernels' plain versions wherever the port's
gate admits them, hop 64 included; float64 numpy with ``device="cpu"``
takes the composed route in float64). Tolerances, normalized by the
result's magnitude:

* f32 against tpufft: ``assert_spectrum_close`` (1e-3 for c64), the
  repo's contract;
* f32 against scipy in float64: 1e-5, as tpufft's own spectral tests hold
  its f32 device paths (4e-5 for coherence, a ratio of three estimates);
* float64 against scipy and tpufft's host tier: 1e-10.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import tpufft
from tpufft import PlanConfig as TPConfig

import tpufft_torch as tt
from tpufft_torch import PlanConfig, SplitComplex
from tpufft_torch.kernels import stft_mm

from conftest import assert_spectrum_close
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPConfig(interpret=True)
F32_SCIPY = 1e-5
F64 = 1e-10

# (nperseg, noverlap, nfft, detrend): hop 128 (tpufft's kernel too), hop 64
# (the port's kernel only), K = 4, nfft > nperseg, the linear detrend, and
# a hop that does not divide nperseg (the composed route in both)
STFT_CASES = [(256, None, None, False), (128, 64, None, False),
              (512, 384, None, "constant"), (256, 128, 384, "linear"),
              (128, 96, 200, "constant"), (100, 25, None, False)]


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        1.0, float(np.max(np.abs(want))))


def _np(a):
    if isinstance(a, SplitComplex):
        return a.re.numpy() + 1j * a.im.numpy()
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _x(shape=(3, 2048), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _count_plain(monkeypatch):
    """Count the kernels' plain-version calls (the CPU route of K13-K15)."""
    calls = {"stft": 0, "istft": 0, "welch": 0}
    for name, fn in (("stft", "stft_frames_reference"),
                     ("istft", "istft_ola_reference"),
                     ("welch", "welch_accum_reference")):
        orig = getattr(stft_mm, fn)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(stft_mm, fn, wrapped)
    return calls


# ----------------------------------------------------------------------------
# stft / istft
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("nperseg,noverlap,nfft,detrend", STFT_CASES)
def test_stft_f32_matches_tpufft_and_scipy(nperseg, noverlap, nfft, detrend,
                                           monkeypatch):
    x = _x()
    kw = dict(fs=2.0, nperseg=nperseg, noverlap=noverlap, nfft=nfft,
              detrend=detrend)
    calls = _count_plain(monkeypatch)
    f, t, Z = tt.stft(torch.from_numpy(x), **kw)
    hop = nperseg - (nperseg // 2 if noverlap is None else noverlap)
    assert calls["stft"] == int(nperseg % hop == 0)
    assert Z.dtype == torch.complex64
    f1, t1, Z1 = tpufft.stft(jnp.asarray(x), config=TP_CFG, **kw)
    np.testing.assert_allclose(f, f1)
    np.testing.assert_allclose(t, t1)
    assert_spectrum_close(_np(Z), np.asarray(Z1), np.complex64)
    _, _, Z2 = sps.stft(x.astype(np.float64), **kw)
    assert _err(_np(Z), Z2) < F32_SCIPY


@pytest.mark.parametrize("nperseg,noverlap,nfft,detrend", STFT_CASES)
def test_stft_f64_matches_tpufft_and_scipy(nperseg, noverlap, nfft, detrend,
                                           monkeypatch):
    x = _x(dtype=np.float64)
    kw = dict(nperseg=nperseg, noverlap=noverlap, nfft=nfft,
              detrend=detrend)
    calls = _count_plain(monkeypatch)
    _, _, Z = tt.stft(x, device="cpu", **kw)
    assert calls["stft"] == 0          # float64 takes the composed route
    assert isinstance(Z, np.ndarray) and Z.dtype == np.complex128
    assert _err(Z, sps.stft(x, **kw)[2]) < F64
    assert _err(Z, tpufft.stft(x, **kw)[2]) < F64


@pytest.mark.parametrize("boundary", ["zeros", "even", "odd", "constant",
                                      None])
@pytest.mark.parametrize("padded", [True, False])
def test_stft_boundary_padded(boundary, padded):
    x = _x((2, 1000), seed=1)
    kw = dict(nperseg=128, noverlap=64, boundary=boundary, padded=padded)
    _, t, Z = tt.stft(torch.from_numpy(x), **kw)
    _, t2, Z2 = sps.stft(x.astype(np.float64), **kw)
    np.testing.assert_allclose(t, t2)
    assert _err(_np(Z), Z2) < F32_SCIPY
    assert_spectrum_close(_np(Z), np.asarray(
        tpufft.stft(jnp.asarray(x), config=TP_CFG, **kw)[2]), np.complex64)


@pytest.mark.parametrize("scaling", ["spectrum", "psd"])
@pytest.mark.parametrize("nperseg,noverlap", [(256, 128), (128, 64),
                                              (512, 384), (100, 25)])
def test_istft_roundtrip_and_scipy(nperseg, noverlap, scaling, monkeypatch):
    x = _x((3, 3000), seed=2)
    kw = dict(nperseg=nperseg, noverlap=noverlap, scaling=scaling)
    _, _, Z = tt.stft(torch.from_numpy(x), **kw)
    calls = _count_plain(monkeypatch)
    t, xr = tt.istft(Z, **kw)
    assert calls["istft"] == int(nperseg % (nperseg - noverlap) == 0)
    assert xr.dtype == torch.float32
    assert _err(_np(xr)[:, :3000], x) < F32_SCIPY
    _, _, Z2 = sps.stft(x.astype(np.float64), **kw)
    _, x2 = sps.istft(Z2, **kw)
    assert _err(_np(xr), x2) < F32_SCIPY
    t1, x1 = tpufft.istft(jnp.asarray(_np(Z)), config=TP_CFG, **kw)
    np.testing.assert_allclose(t, t1)
    # two f32 pipelines, each within 1e-5 of scipy: within 2e-5 of another
    assert _err(_np(xr), np.asarray(x1)) < 2 * F32_SCIPY


def test_istft_f64_complex_and_axes():
    rng = np.random.default_rng(3)
    xc = rng.standard_normal((2, 600)) + 1j * rng.standard_normal((2, 600))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, _, Z = tt.stft(xc, nperseg=64, device="cpu")
        _, _, Z2 = sps.stft(xc, nperseg=64)
    assert _err(Z, Z2) < F64
    _, back = tt.istft(Z, nperseg=64, input_onesided=False, device="cpu")
    assert np.iscomplexobj(back) and _err(back[:, :600], xc) < F64
    x = rng.standard_normal((3, 4, 500))
    kw = dict(nperseg=64, axis=1)
    _, _, Z = tt.stft(x.transpose(0, 2, 1).copy(), device="cpu", **kw)
    _, _, Z2 = sps.stft(x.transpose(0, 2, 1), **kw)
    assert _err(Z, Z2) < F64
    _, xr = tt.istft(Z, nperseg=64, time_axis=-1, freq_axis=1,
                     device="cpu")
    _, x2 = sps.istft(Z2, nperseg=64, time_axis=-1, freq_axis=1)
    assert _err(xr, x2) < F64


def test_istft_nola_warns_and_checks():
    with pytest.warns(UserWarning, match="NOLA"):
        tt.istft(np.ones((33, 10), np.complex128), window=np.zeros(64),
                 nperseg=64, device="cpu")
    for win, n, o in [("hann", 256, 128), ("boxcar", 64, 0),
                      (("tukey", 0.5), 100, 30), (np.zeros(32), 32, 8)]:
        assert tt.check_NOLA(win, n, o) == sps.check_NOLA(win, n, o)
        assert tt.check_COLA(win, n, o) == sps.check_COLA(win, n, o)
        assert tt.check_NOLA(win, n, o) == tpufft.check_NOLA(win, n, o)


# ----------------------------------------------------------------------------
# welch / csd / periodogram / coherence / spectrogram
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("detrend", ["constant", "linear", False])
@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("nperseg,noverlap", [(256, None), (128, 64),
                                              (512, 384), (100, 25)])
def test_welch_matches_tpufft_and_scipy(nperseg, noverlap, scaling, detrend,
                                        monkeypatch):
    x = _x((3, 3000), seed=4)
    kw = dict(fs=10.0, nperseg=nperseg, noverlap=noverlap, scaling=scaling,
              detrend=detrend)
    calls = _count_plain(monkeypatch)
    f, P = tt.welch(torch.from_numpy(x), **kw)
    hop = nperseg - (nperseg // 2 if noverlap is None else noverlap)
    assert calls["welch"] == int(nperseg % hop == 0)
    assert P.dtype == torch.float32
    f2, P2 = sps.welch(x.astype(np.float64), **kw)
    np.testing.assert_allclose(f, f2)
    assert _err(_np(P), P2) < F32_SCIPY
    assert_spectrum_close(_np(P), np.asarray(tpufft.welch(
        jnp.asarray(x), config=TP_CFG, **kw)[1]), np.complex64)


@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize("nperseg,noverlap", [(256, None), (128, 64)])
def test_csd_matches_tpufft_and_scipy(nperseg, noverlap, average,
                                      monkeypatch):
    x, y = _x((2, 2500), 5), _x((2, 2300), 6)   # y zero-padded to x's
    kw = dict(nperseg=nperseg, noverlap=noverlap, average=average)
    calls = _count_plain(monkeypatch)
    _, P = tt.csd(torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert calls["welch"] == int(average == "mean")
    assert calls["stft"] == 2 * int(average == "median")
    assert P.dtype == torch.complex64
    _, P2 = sps.csd(x.astype(np.float64), y.astype(np.float64), **kw)
    assert _err(_np(P), P2) < F32_SCIPY
    assert_spectrum_close(_np(P), np.asarray(tpufft.csd(
        jnp.asarray(x), jnp.asarray(y), config=TP_CFG, **kw)[1]),
        np.complex64)


@pytest.mark.parametrize("fn", ["csd", "coherence"])
@pytest.mark.parametrize("xs,ys", [((1, 3000), (3, 3000)),
                                   ((2, 1, 3000), (1, 3, 3000)),
                                   ((3, 3000), (1, 3000))])
def test_csd_and_coherence_broadcast_leading_dims(fn, xs, ys, monkeypatch):
    """x's and y's leading dims broadcast on the K15 route. tpufft's fused
    Welch route (interpret mode) refuses these shapes too, so the parity
    is with its default route, which serves them."""
    x = _x(xs, 20)
    y = (0.5 * x + _x(ys, 21)).astype(np.float32)
    kw = dict(nperseg=256, average="mean") if fn == "csd" else dict(
        nperseg=256)
    calls = _count_plain(monkeypatch)
    _, P = getattr(tt, fn)(torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert calls["welch"] == (1 if fn == "csd" else 3)
    _, P2 = getattr(sps, fn)(x.astype(np.float64), y.astype(np.float64),
                             **kw)
    assert _err(_np(P), P2) < 1e-4
    _, P3 = getattr(tpufft, fn)(jnp.asarray(x), jnp.asarray(y), **kw)
    assert _err(_np(P), np.asarray(P3)) < 1e-4


def test_coherence_matches_scipy():
    x = _x((2, 4000), 7)
    y = (0.5 * x + _x((2, 4000), 8)).astype(np.float32)
    _, C = tt.coherence(torch.from_numpy(x), torch.from_numpy(y),
                        nperseg=128, noverlap=64)
    _, C2 = sps.coherence(x.astype(np.float64), y.astype(np.float64),
                          nperseg=128, noverlap=64)
    assert _err(_np(C), C2) < 4e-5
    _, C64 = tt.coherence(x.astype(np.float64), y.astype(np.float64),
                          nperseg=128, noverlap=64, device="cpu")
    assert _err(C64, C2) < F64


@pytest.mark.parametrize("nfft", [None, 2048, 1500, 4096])
@pytest.mark.parametrize("window", ["boxcar", "hann"])
def test_periodogram_matches_scipy(nfft, window):
    x = _x((2, 2000), 9, np.float64)
    kw = dict(nfft=nfft, window=window, fs=3.0)
    _, P = tt.periodogram(x, device="cpu", **kw)
    _, P2 = sps.periodogram(x, **kw)
    assert _err(P, P2) < F64
    assert _err(P, tpufft.periodogram(x, **kw)[1]) < F64
    _, P32 = tt.periodogram(torch.from_numpy(x.astype(np.float32)), **kw)
    assert _err(_np(P32), P2) < F32_SCIPY


@pytest.mark.parametrize("mode", ["psd", "complex", "magnitude", "angle",
                                  "phase"])
@pytest.mark.parametrize("nperseg,noverlap", [(256, 128), (128, 64),
                                              (128, None)])
def test_spectrogram_matches_tpufft_and_scipy(nperseg, noverlap, mode):
    x = _x((2, 3000), 10)
    kw = dict(nperseg=nperseg, noverlap=noverlap, mode=mode)
    _, t, S = tt.spectrogram(torch.from_numpy(x), **kw)
    _, t1, S1 = tpufft.spectrogram(jnp.asarray(x), config=TP_CFG, **kw)
    np.testing.assert_allclose(t, t1)
    if mode in ("angle", "phase"):
        # the phase of a bin whose imaginary part is +-0 (DC, Nyquist) is
        # +-pi by the sign of that zero: compare the unit phasors
        d = np.exp(1j * _np(S)) - np.exp(1j * np.asarray(S1))
        assert np.max(np.abs(d)) < 1e-3
        return
    assert_spectrum_close(_np(S), np.asarray(S1), np.complex64)
    _, _, S2 = sps.spectrogram(x.astype(np.float64), **kw)
    assert _err(_np(S), S2) < F32_SCIPY


def test_spectrogram_f64_angle_and_phase():
    x = _x((2, 3000), 11, np.float64)
    for mode in ("angle", "phase"):
        _, _, S = tt.spectrogram(x, nperseg=128, mode=mode, device="cpu")
        _, _, S1 = tpufft.spectrogram(x, nperseg=128, mode=mode)
        assert _err(np.exp(1j * S), np.exp(1j * S1)) < F64


def test_input_forms():
    """numpy in -> numpy out; SplitComplex in -> SplitComplex out for a
    complex result; tensor in -> tensor on its device; integer numpy runs
    in float64."""
    x = _x((2, 1024), 12)
    xt = torch.from_numpy(x)
    _, _, Z = tt.stft(x, nperseg=128, device="cpu")
    assert isinstance(Z, np.ndarray) and Z.dtype == np.complex64
    assert _err(Z, _np(tt.stft(xt, nperseg=128)[2])) == 0.0
    z = SplitComplex(xt, torch.from_numpy(_x((2, 1024), 13)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, _, Zs = tt.stft(z, nperseg=128)
        _, Ps = tt.welch(z, nperseg=128)
        _, P2 = sps.welch(_np(z).astype(np.complex128), nperseg=128)
    assert isinstance(Zs, SplitComplex)
    assert _err(_np(Ps), P2) < F32_SCIPY
    xi = np.arange(600) % 7
    _, P = tt.welch(xi, nperseg=64, device="cpu")
    assert P.dtype == np.float64 and _err(P, sps.welch(xi, nperseg=64)[1]) < F64


def test_bf16_signal_takes_the_kernel_route(monkeypatch):
    x = torch.from_numpy(_x((2, 4096), 14)).to(torch.bfloat16)
    calls = _count_plain(monkeypatch)
    _, _, Z = tt.stft(x, nperseg=256)
    _, P = tt.welch(x, nperseg=256)
    assert calls["stft"] == 1 and calls["welch"] == 1
    assert Z.dtype == torch.complex64 and P.dtype == torch.float32
    xf = x.float().numpy().astype(np.float64)
    assert _err(_np(Z), sps.stft(xf, nperseg=256)[2]) < F32_SCIPY
    assert _err(_np(P), sps.welch(xf, nperseg=256)[1]) < F32_SCIPY


def test_xla_backend_takes_the_composed_route(monkeypatch):
    x = torch.from_numpy(_x((2, 2048), 15))
    cfg = PlanConfig(backend="xla")
    calls = _count_plain(monkeypatch)
    _, _, Z = tt.stft(x, nperseg=128, config=cfg)
    _, back = tt.istft(Z, nperseg=128, config=cfg)
    _, P = tt.welch(x, nperseg=128, config=cfg)
    assert calls == {"stft": 0, "istft": 0, "welch": 0}
    assert _err(_np(Z), _np(tt.stft(x, nperseg=128)[2])) < 1e-5
    assert _err(_np(P), _np(tt.welch(x, nperseg=128)[1])) < 1e-5
    assert _err(_np(back)[:, :2048], x.numpy()) < 1e-5


def test_gradients_match_the_composed_route():
    """The fused routes' backward passes (adjoint product and overlap-add,
    the framing gather, K15's recompute) against autograd through the
    composed route."""
    x0 = torch.from_numpy(_x((2, 2048), 16))
    y0 = torch.from_numpy(_x((2, 2048), 17))

    def loss(x, y, cfg):
        _, _, Z = tt.stft(x, nperseg=128, detrend="linear", config=cfg)
        _, back = tt.istft(Z * 0.5, nperseg=128, config=cfg)
        _, Pxy = tt.csd(x, y, nperseg=256, config=cfg)
        _, Pxx = tt.welch(x, nperseg=128, noverlap=96, config=cfg)
        return ((back * y[:, :back.shape[-1]]).sum() + Pxy.real.sum()
                + 3 * Pxy.imag.sum() + Pxx.sum() + (Z.abs() ** 2).sum())

    grads = []
    for cfg in (None, PlanConfig(backend="xla")):
        x = x0.clone().requires_grad_(True)
        y = y0.clone().requires_grad_(True)
        loss(x, y, cfg).backward()
        grads.append((x.grad, y.grad))
    for g, r in zip(grads[0], grads[1]):
        assert _err(g.numpy(), r.numpy()) < 1e-5


def test_numpy_input_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy runs there")
    with pytest.raises(RuntimeError, match="device"):
        tt.welch(_x((1, 512), 18))


def test_errors():
    x = _x((1, 600), 19, np.float64)
    with pytest.raises(ValueError, match="noverlap"):
        tt.stft(x, nperseg=64, noverlap=64, device="cpu")
    with pytest.raises(ValueError, match="nfft"):
        tt.welch(x, nperseg=64, nfft=32, device="cpu")
    with pytest.raises(ValueError, match="scaling"):
        tt.stft(x, scaling="bad", device="cpu")
    with pytest.raises(ValueError, match="boundary"):
        tt.stft(x, boundary="bad", device="cpu")
    with pytest.raises(ValueError, match="average"):
        tt.csd(x, x, average="bad", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tt.spectrogram(x, mode="bad", device="cpu")
    with pytest.raises(ValueError, match="2d"):
        tt.istft(np.ones(10, np.complex128), device="cpu")


def test_get_window_and_exports():
    for spec, n in [("hann", 64), (("tukey", 0.3), 50), (("kaiser", 8), 33),
                    (("chebwin", 60), 40), (("dpss", 3), 64)]:
        np.testing.assert_array_equal(tt.get_window(spec, n),
                                      tpufft.get_window(spec, n))
        np.testing.assert_allclose(tt.get_window(spec, n),
                                   sps.get_window(spec, n), atol=1e-12)
    for name in ("stft", "istft", "spectrogram", "welch", "csd",
                 "coherence", "periodogram", "lombscargle", "check_NOLA",
                 "check_COLA", "get_window", "ShortTimeFFT",
                 "closest_STFT_dual_window", "windows"):
        assert name in tt.__all__ and hasattr(tt, name), name


# ----------------------------------------------------------------------------
# lombscargle
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True, "amplitude"])
@pytest.mark.parametrize("floating_mean", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_lombscargle_matches_tpufft_and_scipy(normalize, floating_mean,
                                              weighted):
    rng = np.random.default_rng(20)
    x = np.sort(rng.uniform(0, 20, 300))
    y = np.sin(1.3 * x) + 0.2 * rng.standard_normal(300)
    freqs = np.linspace(0.1, 4, 120)
    w = rng.uniform(0.5, 2, 300) if weighted else None
    kw = dict(normalize=normalize, floating_mean=floating_mean, weights=w)
    got = tt.lombscargle(x, y, freqs, device="cpu", **kw)
    assert isinstance(got, np.ndarray)
    assert _err(got, sps.lombscargle(x, y, freqs, **kw)) < F64
    assert _err(got, tpufft.lombscargle(x, y, freqs, **kw)) < F64
    got32 = tt.lombscargle(torch.from_numpy(x.astype(np.float32)),
                           torch.from_numpy(y.astype(np.float32)),
                           torch.from_numpy(freqs.astype(np.float32)), **kw)
    assert isinstance(got32, torch.Tensor)
    assert _err(_np(got32), np.asarray(tpufft.lombscargle(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(freqs, jnp.float32), **kw))) < 1e-3


def test_lombscargle_validation_and_deprecation():
    x = np.arange(10.0)
    with pytest.raises(ValueError, match="weights"):
        tt.lombscargle(x, x, x, weights=-np.ones(10), device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tt.lombscargle(x, x[:5], x, device="cpu")
    with pytest.raises(ValueError, match="normalize"):
        tt.lombscargle(x, x, x, normalize="bad", device="cpu")
    with pytest.warns(DeprecationWarning):
        a = tt.lombscargle(x, np.sin(x) + 1, x[1:] / 3, precenter=True,
                           device="cpu")
    b = tt.lombscargle(x, np.sin(x) + 1 - np.mean(np.sin(x) + 1), x[1:] / 3,
                       device="cpu")
    assert _err(a, b) < F64

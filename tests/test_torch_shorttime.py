"""The port's ShortTimeFFT against tpufft's and scipy.signal's.

float64 numpy input runs on the CPU (``device="cpu"``) in the composed
route and is held to scipy and tpufft at 1e-10, as tpufft's own tests hold
its host tier. f32 tensors take the kernel route (K13, K14 through their
plain versions on the CPU) where the port's gate admits the geometry,
hop 64 included, which tpufft's TPU gate refuses; they are held to scipy
in float64 at 1e-5 (normalized), as tpufft's tests hold its f32 device
paths, and to tpufft's jax f32 path with ``assert_spectrum_close`` (1e-3
for c64). The host-side surface (index bookkeeping, windows, dual windows,
constructors) must match exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import tpufft
from tpufft import PlanConfig as TPConfig

import tpufft_torch as tt
from tpufft_torch import PlanConfig, ShortTimeFFT
from tpufft_torch.convert import short_time_fft_from_fields
from tpufft_torch.kernels import stft_mm

from conftest import assert_spectrum_close
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

F64 = 1e-10
F32 = 1e-5


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / max(
        1.0, float(np.max(np.abs(want))))


def _sig(n=100, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if complex_:
        x = x + 1j * rng.standard_normal(n)
    return x


def _trio(fft_mode="onesided", win=None, hop=4, fs=8.0, **kw):
    """(port, tpufft, scipy) instances of the same short-time FFT."""
    win = sps.get_window("hann", 16) if win is None else win
    return (ShortTimeFFT(win, hop, fs, fft_mode=fft_mode, device="cpu",
                         **kw),
            tpufft.ShortTimeFFT(win, hop, fs, fft_mode=fft_mode, **kw),
            sps.ShortTimeFFT(win, hop, fs, fft_mode=fft_mode, **kw))


def _count_plain(monkeypatch):
    calls = {"stft": 0, "istft": 0}
    for name, fn in (("stft", "stft_frames_reference"),
                     ("istft", "istft_ola_reference")):
        orig = getattr(stft_mm, fn)

        def wrapped(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(stft_mm, fn, wrapped)
    return calls


# ----------------------------------------------------------------------------
# float64: the composed route, against scipy and tpufft
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("phase_shift", [None, 0, 2, -5])
@pytest.mark.parametrize("mfft_pad", [0, 5])
@pytest.mark.parametrize("fft_mode", ["twosided", "centered", "onesided",
                                      "onesided2X"])
def test_stft_istft_modes(fft_mode, mfft_pad, phase_shift):
    scale = "magnitude" if fft_mode == "onesided2X" else None
    ours, tp, sp = _trio(fft_mode, mfft=16 + mfft_pad,
                         phase_shift=phase_shift, scale_to=scale)
    x = _sig(120)
    S = ours.stft(x)
    assert isinstance(S, np.ndarray) and S.dtype == np.complex128
    assert _err(S, sp.stft(x)) < F64
    assert _err(S, np.asarray(tp.stft(x))) < F64
    back = ours.istft(S, k1=120)
    assert _err(back, sp.istft(sp.stft(x), k1=120)) < F64
    assert _err(back, x) < 1e-9


@pytest.mark.parametrize("fft_mode", ["twosided", "centered"])
def test_complex_input_and_window(fft_mode):
    ours, _, sp = _trio(fft_mode)
    x = _sig(90, seed=5, complex_=True)
    assert _err(ours.stft(x), sp.stft(x)) < F64
    win = sps.get_window("hann", 16) * np.exp(1j * np.linspace(0, 1, 16))
    ours, _, sp = _trio(fft_mode, win=win, fs=2.0)
    assert _err(ours.stft(x), sp.stft(x)) < F64
    assert _err(ours.istft(ours.stft(x), k1=90), x) < 1e-9


@pytest.mark.parametrize("padding", ["zeros", "edge", "even", "odd"])
def test_padding_slices_and_offsets(padding):
    ours, _, sp = _trio()
    x = _sig(60, seed=11)
    assert _err(ours.stft(x, padding=padding),
                sp.stft(x, padding=padding)) < F64
    x = _sig(100, seed=13)
    assert _err(ours.stft(x, p0=2, p1=12, k_offset=3, padding=padding),
                sp.stft(x, p0=2, p1=12, k_offset=3, padding=padding)) < F64


def test_axis_batch_detrend_and_spectrogram():
    ours, tp, sp = _trio()
    x = _sig(270, seed=17).reshape(3, 90)
    assert _err(ours.stft(x), sp.stft(x)) < F64
    assert _err(ours.stft(x.T.copy(), axis=0), sp.stft(x.T, axis=0)) < F64
    y = x + np.linspace(0, 4, 90)
    for detr in ("constant", "linear"):
        assert _err(ours.stft_detrend(y, detr), sp.stft_detrend(y, detr)) \
            < F64

    def f(fr):       # a callable detrend sees the frames as a tensor
        return fr - fr.mean(-1, keepdim=True)
    assert _err(ours.stft_detrend(y, f), sp.stft_detrend(
        y, lambda fr: fr - fr.mean(-1, keepdims=True))) < F64
    assert _err(ours.spectrogram(x), sp.spectrogram(x)) < F64
    assert _err(ours.spectrogram(x, y), sp.spectrogram(x, y)) < F64
    assert _err(ours.spectrogram(x, detr="linear"),
                np.asarray(tp.spectrogram(x, detr="linear"))) < F64


def test_istft_windows_and_axes():
    ours, _, sp = _trio()
    x = _sig(100, seed=31)
    assert _err(ours.istft(ours.stft(x), k0=8, k1=72),
                sp.istft(sp.stft(x), k0=8, k1=72)) < F64
    x = _sig(180, seed=37).reshape(2, 90)
    S_o = np.moveaxis(ours.stft(x), (-2, -1), (0, 1))
    S_t = np.moveaxis(sp.stft(x), (-2, -1), (0, 1))
    assert _err(ours.istft(S_o, k1=90, f_axis=0, t_axis=1),
                sp.istft(S_t, k1=90, f_axis=0, t_axis=1)) < F64


# ----------------------------------------------------------------------------
# the host surface: constructors, scaling, indices
# ----------------------------------------------------------------------------

def test_constructors_match_scipy():
    for sym in (False, True):
        o = ShortTimeFFT.from_window("hamming", 8.0, 20, 15,
                                     symmetric_win=sym)
        s = sps.ShortTimeFFT.from_window("hamming", 8.0, 20, 15,
                                         symmetric_win=sym)
        np.testing.assert_allclose(o.win, s.win, atol=1e-12)
        assert o.hop == s.hop and o.fs == s.fs
    dual = sps.get_window("hann", 16) + 0.1
    o = ShortTimeFFT.from_dual(dual, 4, 2.0, device="cpu")
    s = sps.ShortTimeFFT.from_dual(dual, 4, 2.0)
    np.testing.assert_allclose(o.win, s.win, atol=1e-12)
    np.testing.assert_allclose(o.dual_win, s.dual_win, atol=1e-12)
    x = _sig(80, seed=47)
    assert _err(o.istft(o.stft(x), k1=80), x) < 1e-9
    for scale_to in (None, "magnitude", "psd", "unitary"):
        o = ShortTimeFFT.from_win_equals_dual(np.hanning(16) + 0.2, 4, 1.0,
                                              scale_to=scale_to)
        s = sps.ShortTimeFFT.from_win_equals_dual(np.hanning(16) + 0.2, 4,
                                                  1.0, scale_to=scale_to)
        np.testing.assert_allclose(o.win, s.win, atol=1e-12)
        np.testing.assert_allclose(o.dual_win, s.dual_win, atol=1e-12)
        assert o.scaling == s.scaling


@pytest.mark.parametrize("win_len,hop,mfft", [(16, 4, None), (17, 5, 23),
                                              (128, 64, 256), (9, 9, 9)])
def test_index_surface(win_len, hop, mfft):
    o, tp, s = _trio(win=sps.get_window("hann", win_len), hop=hop,
                     mfft=mfft)
    for n in (win_len, 100, 1001):
        for name in ("p_max", "k_max", "p_num", "upper_border_begin"):
            assert getattr(o, name)(n) == getattr(s, name)(n), (name, n)
        np.testing.assert_allclose(o.t(n), s.t(n))
        assert o.extent(n) == tp.extent(n)
    for name in ("p_min", "k_min", "lower_border_end", "f_pts", "m_num_mid",
                 "delta_t", "delta_f", "invertible"):
        assert getattr(o, name) == getattr(s, name), name
    for name in ("fac_magnitude", "fac_psd"):   # summed in another order
        assert getattr(o, name) == getattr(tp, name), name
        assert np.isclose(getattr(o, name), getattr(s, name), rtol=1e-14)
    np.testing.assert_allclose(o.f, s.f)
    if s.invertible:
        np.testing.assert_allclose(o.dual_win, s.dual_win, atol=1e-12)


def test_scale_to_and_closest_dual():
    o, _, s = _trio()
    for sc in ("magnitude", "psd"):
        o.scale_to(sc)
        s.scale_to(sc)
        np.testing.assert_allclose(o.win, s.win, atol=1e-12)
        np.testing.assert_allclose(o.dual_win, s.dual_win, atol=1e-12)
    for m, hop, scaled in [(16, 4, True), (16, 4, False), (33, 8, True)]:
        win = sps.get_window("hann", m)
        d, a = tt.closest_STFT_dual_window(win, hop, scaled=scaled)
        d2, a2 = tpufft.closest_STFT_dual_window(win, hop, scaled=scaled)
        np.testing.assert_array_equal(d, d2)
        assert a == a2
        d3, a3 = sps.closest_STFT_dual_window(win, hop, scaled=scaled)
        np.testing.assert_allclose(d, d3, atol=1e-12)


def test_errors_match_scipy():
    win = np.hanning(16)
    for kw in (dict(hop=0), dict(fs=0.0), dict(mfft=8),
               dict(fft_mode="bad"), dict(phase_shift=40),
               dict(dual_win=np.ones(3)), dict(fft_mode="onesided2X")):
        args = dict(hop=4, fs=1.0)
        args.update(kw)
        with pytest.raises(ValueError):
            ShortTimeFFT(win, **args)
        with pytest.raises(ValueError):
            sps.ShortTimeFFT(win, **args)
    o = ShortTimeFFT(win, 4, 1.0, device="cpu")
    with pytest.raises(ValueError, match="complex input"):
        o.stft(_sig(50, complex_=True))
    with pytest.raises(ValueError, match="f_pts"):
        o.istft(np.ones((5, 30), np.complex128))
    with pytest.raises(ValueError, match="padding"):
        o.stft(_sig(50), padding="bad")
    with pytest.raises(ValueError, match="detr"):
        o.stft_detrend(_sig(50), "bad")


# ----------------------------------------------------------------------------
# f32 tensors: the kernel route
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("phase_shift", [0, 3, None])
@pytest.mark.parametrize("fft_mode,scale", [("onesided", None),
                                            ("onesided2X", "psd"),
                                            ("onesided", "magnitude")])
@pytest.mark.parametrize("m,hop,mfft", [(128, 64, None), (256, 128, 300),
                                        (512, 128, None), (128, 32, 128)])
def test_kernel_route_matches_scipy_and_tpufft(m, hop, mfft, fft_mode,
                                               scale, phase_shift,
                                               monkeypatch):
    win = sps.get_window("hann", m)
    kw = dict(fft_mode=fft_mode, mfft=mfft, scale_to=scale,
              phase_shift=phase_shift)
    ours = ShortTimeFFT(win, hop, 48000.0, **kw)
    sp = sps.ShortTimeFFT(win, hop, 48000.0, **kw)
    tp = tpufft.ShortTimeFFT(win, hop, 48000.0, config=TPConfig(
        interpret=True), **kw)
    x = np.random.default_rng(m + hop).standard_normal((2, 3000)).astype(
        np.float32)
    calls = _count_plain(monkeypatch)
    S = ours.stft(torch.from_numpy(x))
    back = ours.istft(S, k1=3000)
    assert calls == {"stft": 1, "istft": 1}
    assert S.dtype == torch.complex64 and back.dtype == torch.float32
    S2 = sp.stft(x.astype(np.float64))
    assert _err(S.numpy(), S2) < F32
    assert_spectrum_close(S.numpy(), np.asarray(tp.stft(jnp.asarray(x))),
                          np.complex64)
    assert _err(back.numpy(), x) < F32
    assert _err(back.numpy(), sp.istft(S2, k1=3000)) < F32


@pytest.mark.parametrize("detr", ["constant", "linear"])
def test_kernel_route_detrend_and_bf16(detr, monkeypatch):
    win = sps.get_window("hann", 128)
    ours = ShortTimeFFT(win, 64, 1.0)
    sp = sps.ShortTimeFFT(win, 64, 1.0)
    x = torch.from_numpy(_sig(2000, seed=3).astype(np.float32))
    calls = _count_plain(monkeypatch)
    S = ours.stft_detrend(x, detr)
    Sb = ours.stft_detrend(x.to(torch.bfloat16), detr)
    assert calls["stft"] == 2
    assert _err(S.numpy(), sp.stft_detrend(x.double().numpy(), detr)) < F32
    xb = x.to(torch.bfloat16).double().numpy()
    assert _err(Sb.numpy(), sp.stft_detrend(xb, detr)) < F32


def test_composed_routes_for_what_the_gate_refuses(monkeypatch):
    """f64 tensors, complex windows, twosided modes, callable detrends and
    backend="xla" compose the port's FFTs; f32 results match the kernel
    route."""
    win = sps.get_window("hann", 128)
    x = torch.from_numpy(_sig(3000, seed=9).astype(np.float32))
    calls = _count_plain(monkeypatch)
    S_x = ShortTimeFFT(win, 64, 1.0, config=PlanConfig(
        backend="xla")).stft(x)
    S_d = ShortTimeFFT(win, 64, 1.0).stft(x.double())
    ShortTimeFFT(win, 64, 1.0, fft_mode="centered").stft(x)
    ShortTimeFFT(win, 64, 1.0).stft_detrend(x, lambda f: f)
    assert calls == {"stft": 0, "istft": 0}
    S = ShortTimeFFT(win, 64, 1.0).stft(x)
    assert _err(S_x.numpy(), S.numpy()) < F32
    assert _err(S_d.numpy(), S.numpy()) < F32


def test_gradients_match_the_composed_route():
    win = sps.get_window("hann", 128)
    x0 = torch.from_numpy(_sig(2000, seed=12).astype(np.float32))
    grads = []
    for cfg in (None, PlanConfig(backend="xla")):
        sft = ShortTimeFFT(win, 64, 1.0, config=cfg)
        x = x0.clone().requires_grad_(True)
        S = sft.stft_detrend(x, "linear")
        back = sft.istft(S * 0.7, k1=2000)
        ((back * x0).sum() + (S.abs() ** 2).sum()).backward()
        grads.append(x.grad)
    assert _err(grads[0].numpy(), grads[1].numpy()) < F32


# ----------------------------------------------------------------------------
# carrying a tpufft ShortTimeFFT across
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(fft_mode="onesided"),
    dict(fft_mode="onesided2X", scale_to="psd", phase_shift=3),
    dict(fft_mode="centered", mfft=20, scale_to="magnitude"),
    dict(fft_mode="twosided", phase_shift=None),
])
def test_short_time_fft_from_fields(kw):
    ts = tpufft.ShortTimeFFT(sps.get_window("hann", 16), 4, 8.0,
                             config=TPConfig(), **kw)
    o = short_time_fft_from_fields(
        ts.win, ts.hop, ts.fs, ts.fft_mode, ts.mfft, ts.dual_win,
        ts.scaling, ts.phase_shift, dataclasses.asdict(ts._config),
        device="cpu")
    for name in ("hop", "fs", "fft_mode", "mfft", "scaling", "phase_shift",
                 "p_min", "k_min", "f_pts"):
        assert getattr(o, name) == getattr(ts, name), name
    np.testing.assert_array_equal(o.win, ts.win)
    np.testing.assert_array_equal(o.dual_win, ts.dual_win)
    x = _sig(120, seed=21)
    assert _err(o.stft(x), np.asarray(ts.stft(x))) < F64
    assert _err(o.istft(o.stft(x), k1=120),
                np.asarray(ts.istft(ts.stft(x), k1=120))) < F64
    assert o.extent(120) == ts.extent(120) if kw["fft_mode"] != \
        "twosided" else True

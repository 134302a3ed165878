"""The port's filter-design surface beyond the core (frequency responses,
converters, tf transforms, order selection, IIR and FIR design, residues)
against tpufft.design and scipy.signal.

Both packages design on the host in float64 numpy from the same code, so
host results agree to 1e-12 of their size; that holds for the iterative
``remez`` too (the same exchange on the same grid). ``firwin2`` and the
host FFT path of ``freqz`` run each package's own FFT in float64, so they
agree to rounding. ``freqz`` on tensors is held against tpufft's ``jnp``
path: float64 to 1e-12, float32 to 1e-5 of the response's size (both are
float32 FFTs of a different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

import tpufft
from tpufft import design as tp

import tpufft_torch
from tpufft_torch import design as d
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TOL = 1e-12
F32_TOL = 1e-5

MISSING: set[str] = set()   # the port has every name of tpufft


def _same(got, ref, tol=TOL):
    """Port against tpufft: every array of a (nested) result within tol of
    the larger of 1 and its size."""
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.size:
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(got - ref)) <= tol * scale


def resp_err(ba1, ba2, n=512):
    _, h1 = ss.freqz(*ba1, worN=n)
    _, h2 = ss.freqz(*ba2, worN=n)
    return np.max(np.abs(h1 - h2)) / max(1e-30, np.max(np.abs(h2)))


def test_port_exports_exactly_tpuffts_names():
    """The port exports tpufft's 209 names, no more and no fewer, with
    tpufft's version."""
    missing = {n for n in tpufft.__all__ if n not in tpufft_torch.__all__}
    assert missing == MISSING
    assert sorted(tpufft_torch.__all__) == sorted(tpufft.__all__)
    assert len(tpufft_torch.__all__) == len(set(tpufft_torch.__all__)) == 209
    assert tpufft_torch.__version__ == tpufft.__version__


@pytest.mark.parametrize("module", ["design", "ltisys", "waveforms",
                                    "peaks", "bsplines", "backend",
                                    "native", "parallel"])
def test_module_exports_match_tpufft(module):
    """Each module exports tpufft's names, and the package re-exports
    those that tpufft's package takes from that module."""
    import importlib
    mine = importlib.import_module(f"tpufft_torch.{module}")
    ref = importlib.import_module(f"tpufft.{module}")
    assert sorted(mine.__all__) == sorted(ref.__all__)
    for name in mine.__all__:
        if getattr(tpufft, name, None) is getattr(ref, name):
            assert getattr(tpufft_torch, name) is getattr(mine, name), name


# ---------------------------------------------------------------------------
# Frequency responses


BA = [ss.butter(4, 0.3), ss.cheby1(5, 1.0, [0.2, 0.45], btype="band"),
      (ss.firwin(63, 0.4), np.array([1.0])), (np.array([2.0, -1.0]), 3.0)]
FREQZ_KW = [{"worN": 256}, {"worN": 256, "whole": True},
            {"worN": 100, "include_nyquist": True}, {"worN": 8},
            {"worN": np.linspace(0, np.pi, 64)},
            {"worN": 128, "fs": 1000.0},
            {"worN": np.linspace(0, 400, 33), "fs": 1000.0}]


@pytest.mark.parametrize("ba", range(len(BA)))
@pytest.mark.parametrize("kw", range(len(FREQZ_KW)))
def test_freqz_host(ba, kw):
    b, a = BA[ba]
    got = d.freqz(b, a, **FREQZ_KW[kw])
    ref = tp.freqz(b, a, **FREQZ_KW[kw])
    assert isinstance(got[1], np.ndarray) and got[1].dtype == np.complex128
    _same(got, ref)
    w2, h2 = ss.freqz(b, a, **FREQZ_KW[kw])
    assert np.allclose(got[0], w2) and np.allclose(got[1], h2)


@pytest.mark.parametrize("n", [1, 2, 7, 2 ** 20])
@pytest.mark.parametrize("endpoint", [False, True])
def test_uniform_grid_is_linspace(n, endpoint):
    """freqz's one-pass grid is np.linspace's to rounding."""
    got = d._uniform_grid(n, 3.0, endpoint)
    ref = np.linspace(0.0, 3.0, n, endpoint=endpoint)
    assert got.dtype == np.float64 and got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 4 * np.finfo(np.float64).eps * 3.0


@pytest.mark.parametrize("shape", [(63,), (17, 5)])
@pytest.mark.parametrize("worN", [32, 256, 100])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_freqz_tensor_fft_path(shape, worN, dtype, monkeypatch):
    """A tensor numerator with a scalar denominator runs the port's fft
    along axis 0 (a 1-D row or a (taps, filters) bank) and stays a tensor;
    held against tpufft's jnp path."""
    b = np.random.default_rng(sum(shape) + worN).standard_normal(
        shape).astype(dtype)
    calls = []
    real_fft = d.fft

    def spy(x, *args, **kw):
        calls.append((tuple(x.shape), kw.get("n"), kw.get("axis")))
        return real_fft(x, *args, **kw)

    monkeypatch.setattr(d, "fft", spy)
    w, h = d.freqz(torch.from_numpy(b), 2.0, worN=worN)
    assert calls == [(shape, 2 * worN, 0)]
    assert isinstance(h, torch.Tensor) and h.device.type == "cpu"
    assert h.dtype == (torch.complex128 if dtype == np.float64
                       else torch.complex64)
    wr, hr = tp.freqz(jnp.asarray(b), 2.0, worN=worN)
    _same(w, wr)
    _same(h, np.asarray(hr), TOL if dtype == np.float64 else F32_TOL)
    _same(h.to(torch.complex128), tp.freqz(b.astype(np.float64), 2.0,
                                           worN=worN)[1],
          TOL if dtype == np.float64 else F32_TOL)


@pytest.mark.parametrize("shape,worN,route", [
    ((101,), 2048, [("fft_minor_padded", (1, 101))]),
    ((129, 16), 1024, [("fft_inner", (1, 2048, 16))]),
    ((65537,), 2 ** 20, [("fft_inner_nd", (1024, 2048, 1)),
                         ("fft_inner", (1, 2048, 1024))])])
def test_freqz_tensor_routes(shape, worN, route, monkeypatch):
    """The kernels a tensor numerator reaches, at the chip smoke's routes:
    a 1-D row pads in K9's load, a (taps, filters) bank pads axis 0 with a
    copy and runs K2, a long row pads to 2**21 and runs the two-pass split
    (K3 with its twiddle and the swapped store, then K2). On the CPU each
    wrapper runs its plain version; the spies see the calls."""
    from tpufft_torch.kernels import inner_fft, minor_fft
    calls = []
    for mod, name in ((minor_fft, "fft_minor"), (minor_fft,
                                                 "fft_minor_padded"),
                      (inner_fft, "fft_inner"), (inner_fft, "fft_inner_nd")):
        def spy(*args, _real=getattr(mod, name), _name=name, **kw):
            calls.append((_name, tuple(args[0].shape)))
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))
    w, h = d.freqz(b, worN=worN)
    assert calls == route
    assert h.shape == (worN,) + shape[1:] and h.dtype == torch.complex64
    ref = tp.freqz(b.double().numpy(), worN=worN)[1]
    _same(h.to(torch.complex128), ref, F32_TOL * 10)


@pytest.mark.parametrize("case", ["a", "array", "short", "bank_a"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_freqz_tensor_horner_stays_on_device(case, dtype, monkeypatch):
    """Every other tensor case is Horner's rule in torch ops where the
    tensor lies: a non-scalar denominator, an array worN, or n_fft below
    the numerator's length. The response is a tensor, held against
    tpufft's host Horner in float64."""
    rng = np.random.default_rng(7)
    b = rng.standard_normal((9, 3) if case == "bank_a" else 40)
    a, worN = 1.0, 64
    if case in ("a", "bank_a"):
        b, a = ss.butter(4, 0.3)
        if case == "bank_a":
            b = np.stack([b, 2 * b, -b], 1)
    elif case == "array":
        worN = np.linspace(0.1, 3.0, 50)
    else:
        worN = 8          # n_fft 16 < 40 taps
    monkeypatch.setattr(d, "fft", None)   # the FFT route must not run
    bt = torch.as_tensor(b, dtype=dtype)
    w, h = d.freqz(bt, a, worN=worN)
    assert isinstance(h, torch.Tensor) and h.device == bt.device
    assert h.dtype == (torch.complex128 if dtype == torch.float64
                       else torch.complex64)
    tol = TOL if dtype == torch.float64 else F32_TOL
    if case == "bank_a":
        for j in range(3):
            _same(h[:, j], tp.freqz(b[:, j], a, worN=worN)[1], tol)
        return
    ref = tp.freqz(b, a, worN=worN)
    _same(w, ref[0])
    _same(h, ref[1], tol)


def test_freqz_zpk_sos_group_delay():
    z, p, k = ss.butter(4, 0.3, output="zpk")
    for kw in ({"worN": 128}, {"worN": 64, "whole": True},
               {"worN": np.linspace(0, 100, 20), "fs": 400.0}):
        _same(d.freqz_zpk(z, p, k, **kw), tp.freqz_zpk(z, p, k, **kw))
    sos = ss.butter(6, [0.2, 0.5], btype="band", output="sos")
    for kw in ({"worN": 128}, {"worN": 512, "whole": True},
               {"worN": np.linspace(0, np.pi, 40)}):
        _same(d.sosfreqz(sos, **kw), tp.sosfreqz(sos, **kw))
        _same(d.freqz_sos(sos, **kw), tp.freqz_sos(sos, **kw))
        assert np.allclose(d.sosfreqz(sos, **kw)[1], ss.sosfreqz(sos, **kw)[1])
    b, a = ss.butter(4, 0.3)
    for kw in ({"w": 128}, {"w": 64, "whole": True},
               {"w": np.linspace(1, 200, 30), "fs": 1000.0}):
        _same(d.group_delay((b, a), **kw), tp.group_delay((b, a), **kw))
    with pytest.warns(UserWarning):
        d.group_delay(([1.0, 1.0], [1.0]), w=np.array([np.pi]))


def test_freqs_family():
    b, a = ss.butter(4, 1.0, analog=True)
    w = np.logspace(-1, 2, 50)
    _same(d.freqs(b, a, worN=w), tp.freqs(b, a, worN=w))
    _same(d.freqs(b, a, worN=25), tp.freqs(b, a, worN=25))
    _same(d.freqs(b, a, worN=None), tp.freqs(b, a, worN=None))
    z, p, k = ss.butter(3, 1.5, analog=True, output="zpk")
    _same(d.freqs_zpk(z, p, k, worN=w), tp.freqs_zpk(z, p, k, worN=w))
    _same(d.freqs_zpk(z, p, k, worN=30), tp.freqs_zpk(z, p, k, worN=30))
    _same(d.findfreqs(b, a, 15), tp.findfreqs(b, a, 15))
    _same(d.findfreqs(z, p, 15, kind="zp"), tp.findfreqs(z, p, 15, kind="zp"))
    assert np.allclose(d.findfreqs(b, a, 15), ss.findfreqs(b, a, 15))
    seen = []
    d.freqs(b, a, worN=w, plot=lambda w_, h_: seen.append(h_))
    assert len(seen) == 1
    with pytest.raises(ValueError):
        d.findfreqs(b, a, 15, kind="bogus")


# ---------------------------------------------------------------------------
# Converters and transforms


@pytest.mark.parametrize("sos", [ss.butter(6, 0.3, output="sos"),
                                 ss.ellip(5, 1, 40, [0.2, 0.4],
                                          btype="band", output="sos")])
def test_sos2tf_sos2zpk(sos):
    _same(d.sos2tf(sos), tp.sos2tf(sos))
    _same(d.sos2zpk(sos), tp.sos2zpk(sos))
    b, a = d.sos2tf(sos)
    assert resp_err((b, a), ss.sos2tf(sos)) < 1e-9
    with pytest.raises(ValueError):
        d.sos2tf(sos[:, :5])


@pytest.mark.parametrize("ba,fs", [(([1.0], [1.0, 1.0]), 2.0),
                                   (ss.butter(3, 2.0, analog=True), 10.0),
                                   (([1.0, 0.5], [1.0, 2.0, 5.0]), 1.0)])
def test_bilinear(ba, fs):
    _same(d.bilinear(*ba, fs=fs), tp.bilinear(*ba, fs=fs))
    b1, a1 = d.bilinear(*ba, fs=fs)
    b2, a2 = ss.bilinear(*ba, fs=fs)
    assert np.allclose(b1, b2) and np.allclose(a1, a2)


@pytest.mark.parametrize("proto", [
    ss.butter(4, 1.0, analog=True),
    ss.cheby1(3, 1.0, 1.0, analog=True),
    (np.array([1.0, 2.0]), np.array([1.0, 2.0, 3.0, 1.0])),
])
@pytest.mark.parametrize("fn,args", [("lp2lp", (2.5,)), ("lp2lp", (0.3,)),
                                     ("lp2hp", (2.5,)),
                                     ("lp2bp", (2.0, 0.7)),
                                     ("lp2bs", (2.0, 0.7))])
def test_lp2_tf_transforms(proto, fn, args):
    got = getattr(d, fn)(*proto, *args)
    _same(got, getattr(tp, fn)(*proto, *args))
    ref = getattr(ss, fn)(*proto, *args)
    assert np.allclose(got[0], ref[0], rtol=1e-10, atol=1e-12)
    assert np.allclose(got[1], ref[1], rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# Order selection and IIR design


ORD_FNS = ["buttord", "cheb1ord", "cheb2ord", "ellipord"]


@pytest.mark.parametrize("fn", ORD_FNS)
@pytest.mark.parametrize("wp,ws,kw", [
    (0.2, 0.3, {}), (0.4, 0.25, {}), ([0.2, 0.5], [0.1, 0.6], {}),
    ([0.1, 0.6], [0.2, 0.5], {}), (200.0, 300.0, {"fs": 2000.0}),
    (2.0, 3.0, {"analog": True})])
def test_ord_selection(fn, wp, ws, kw):
    got = getattr(d, fn)(wp, ws, 3, 60, **kw)
    _same(got, getattr(tp, fn)(wp, ws, 3, 60, **kw))
    ref = getattr(ss, fn)(wp, ws, 3, 60, **kw)
    assert got[0] == ref[0]
    assert np.allclose(np.sort(np.atleast_1d(got[1])),
                       np.sort(np.atleast_1d(ref[1])), atol=1e-6)


@pytest.mark.parametrize("fn", ORD_FNS)
def test_ord_bandstop_sweep(fn):
    rng = np.random.default_rng(42)
    for _ in range(8):
        lo = rng.uniform(0.05, 0.4)
        hi = rng.uniform(lo + 0.15, 0.95)
        gap_lo = rng.uniform(lo + 0.01, lo + (hi - lo) * 0.4)
        gap_hi = rng.uniform(gap_lo + 0.02, hi - 0.01)
        gpass, gstop = rng.uniform(0.1, 3.0), rng.uniform(20.0, 80.0)
        args = ([lo, hi], [gap_lo, gap_hi], gpass, gstop)
        _same(getattr(d, fn)(*args), getattr(tp, fn)(*args))


@pytest.mark.parametrize("kind", ["butter", "cheby", "ellip"])
@pytest.mark.parametrize("wp", [0.15, 0.12])
def test_band_stop_obj(kind, wp):
    passb, stopb = np.array([0.1, 0.6]), np.array([0.2, 0.5])
    got = d.band_stop_obj(wp, 0, passb, stopb, 2, 30, kind)
    _same(got, tp.band_stop_obj(wp, 0, passb, stopb, 2, 30, kind))
    assert np.allclose(got, ss.band_stop_obj(wp, 0, passb, stopb, 2, 30,
                                             kind))
    with pytest.raises(ValueError):
        d.band_stop_obj(wp, 0, passb, stopb, 2, 30, "bessel")


@pytest.mark.parametrize("w0,Q,fs", [(0.3, 30, 2.0), (60, 35, 200.0),
                                     (1000, 12, 8000.0)])
@pytest.mark.parametrize("fn", ["iirnotch", "iirpeak"])
def test_iirnotch_iirpeak(w0, Q, fs, fn):
    got = getattr(d, fn)(w0, Q, fs=fs)
    _same(got, getattr(tp, fn)(w0, Q, fs=fs))
    ref = getattr(ss, fn)(w0, Q, fs=fs)
    assert np.allclose(got[0], ref[0], rtol=1e-12)
    assert np.allclose(got[1], ref[1], rtol=1e-12)


@pytest.mark.parametrize("ftype", ["notch", "peak"])
@pytest.mark.parametrize("pass_zero", [False, True])
def test_iircomb(ftype, pass_zero):
    for w0, Q, fs in [(50, 30, 200.0), (25, 18, 200.0), (1000, 35, 8000.0)]:
        got = d.iircomb(w0, Q, ftype=ftype, fs=fs, pass_zero=pass_zero)
        _same(got, tp.iircomb(w0, Q, ftype=ftype, fs=fs,
                              pass_zero=pass_zero))
    with pytest.raises(ValueError):
        d.iircomb(33.3, 30, fs=200.0)


@pytest.mark.parametrize("wp,ws,gp,gs,ftype,kw", [
    (0.2, 0.3, 1, 40, "ellip", {}),
    (0.3, 0.2, 1, 40, "butter", {}),
    ([0.2, 0.5], [0.1, 0.6], 2, 30, "cheby1", {}),
    ([0.1, 0.6], [0.2, 0.5], 2, 30, "cheby2", {}),
    (200, 300, 1, 40, "butter", {"fs": 2000}),
    (0.2, 0.3, 1, 40, "ellip", {"output": "sos"}),
    (0.2, 0.3, 1, 40, "cheby1", {"output": "zpk"}),
])
def test_iirdesign(wp, ws, gp, gs, ftype, kw):
    got = d.iirdesign(wp, ws, gp, gs, ftype=ftype, **kw)
    _same(got, tp.iirdesign(wp, ws, gp, gs, ftype=ftype, **kw))
    if "output" not in kw:
        assert resp_err(got, ss.iirdesign(wp, ws, gp, gs, ftype=ftype,
                                          **kw)) < 1e-7


def test_iirdesign_errors():
    with pytest.raises(ValueError):
        d.iirdesign(0.2, 0.3, 1, 40, ftype="bessel")
    with pytest.raises(ValueError):
        d.iirdesign([0.1, 0.6], [0.05, 0.5], 1, 40)


# ---------------------------------------------------------------------------
# FIR design


@pytest.mark.parametrize("ripple,width", [(60, 0.1), (30, 0.02), (90, 0.3)])
def test_kaiserord(ripple, width):
    got = d.kaiserord(ripple, width)
    _same(got, tp.kaiserord(ripple, width))
    ref = ss.kaiserord(ripple, width)
    assert got[0] == ref[0] and abs(got[1] - ref[1]) < 1e-12


@pytest.mark.parametrize("args,kw", [
    ((65, [0, 0.3, 0.7, 1], [1, 1, 0, 0]), {}),
    ((64, [0, 0.5, 1], [0, 1, 1]), {"antisymmetric": True}),
    ((65, [0, 0.5, 1], [0, 1, 0]), {"antisymmetric": True}),
    ((33, [0, 0.2, 0.2, 1], [1, 1, 0, 0]), {}),
    ((51, [0, 0.3, 1], [1, 1, 0]), {"window": "blackman"}),
    ((40, [0, 100, 250, 500], [1, 1, 0, 0]), {"fs": 1000.0}),
    ((31, [0, 0.4, 1], [1, 0.5, 0]), {"nfreqs": 513}),
])
def test_firwin2(args, kw):
    got = d.firwin2(*args, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    _same(got, tp.firwin2(*args, **kw))
    assert np.max(np.abs(got - ss.firwin2(*args, **kw))) < 1e-10


def test_firwin2_errors():
    with pytest.raises(ValueError):
        d.firwin2(64, [0, 0.5, 1], [1, 1, 1])       # type II, Nyquist gain
    with pytest.raises(ValueError):
        d.firwin2(31, [0, 0.5, 0.9], [1, 1, 0])     # does not end at 1
    with pytest.raises(ValueError):
        d.firwin2(31, [0, 0.5, 1], [1, 1, 0], nfreqs=16)


REMEZ_CASES = [
    (72, [0, 0.1, 0.2, 0.5], [1, 0], None, "bandpass"),
    (55, [0, 0.12, 0.17, 0.33, 0.38, 0.5], [0, 1, 0], [1, 2, 1], "bandpass"),
    (24, [0, 0.08, 0.16, 0.5], [1, 0], None, "bandpass"),
    (64, [0.05, 0.45], [1], None, "hilbert"),
    (65, [0.05, 0.45], [1], None, "hilbert"),
    (31, [0.02, 0.48], [1], None, "differentiator"),
    (32, [0.02, 0.48], [1], None, "differentiator"),
]


@pytest.mark.parametrize("numtaps,bands,des,weight,ftype", REMEZ_CASES)
def test_remez(numtaps, bands, des, weight, ftype):
    got = d.remez(numtaps, bands, des, weight=weight, type=ftype, fs=1.0)
    _same(got, tp.remez(numtaps, bands, des, weight=weight, type=ftype,
                        fs=1.0))
    ref = ss.remez(numtaps, bands, des, weight=weight, type=ftype, fs=1.0)
    assert np.max(np.abs(got - ref)) <= 2e-3 * np.max(np.abs(ref))


def test_remez_options_and_errors():
    _same(d.remez(41, [0, 1000, 1500, 4000], [1, 0], fs=8000),
          tp.remez(41, [0, 1000, 1500, 4000], [1, 0], fs=8000))
    _same(d.remez(33, [0, 0.2, 0.3, 0.5], [1, 0], maxiter=2),
          tp.remez(33, [0, 0.2, 0.3, 0.5], [1, 0], maxiter=2))
    _same(d.remez(33, [0, 0.2, 0.3, 0.5], [1, 0], grid_density=32),
          tp.remez(33, [0, 0.2, 0.3, 0.5], [1, 0], grid_density=32))
    with pytest.raises(ValueError):
        d.remez(2, [0, 0.1, 0.2, 0.5], [1, 0])
    with pytest.raises(ValueError):
        d.remez(31, [0, 0.1, 0.2, 0.5], [1, 0], type="nope")


@pytest.mark.parametrize("numtaps", [13, 151, 152])
@pytest.mark.parametrize("method,half", [("homomorphic", True),
                                         ("homomorphic", False),
                                         ("hilbert", True)])
def test_minimum_phase(numtaps, method, half):
    hlin = ss.firwin(numtaps, 0.3)
    got = d.minimum_phase(hlin, method=method, half=half)
    _same(got, tp.minimum_phase(hlin, method=method, half=half))
    if method == "homomorphic":
        np.testing.assert_allclose(
            got, ss.minimum_phase(hlin, method=method, half=half),
            atol=1e-9)


FIRLS_CASES = [
    (31, [0, 0.2, 0.3, 1.0], [1, 1, 0, 0], None, None),
    (51, [0, 0.1, 0.15, 0.4, 0.45, 1.0], [0, 0, 1, 1, 0, 0],
     [1, 2, 0.5], None),
    (71, [0, 200, 300, 500], [1, 0.8, 0, 0], None, 1000),
    (11, [0, 0.5, 0.6, 1.0], [1, 1, 0, 0], [1, 3], None),
]


@pytest.mark.parametrize("numtaps,bands,des,weight,fs", FIRLS_CASES)
def test_firls(numtaps, bands, des, weight, fs):
    kw = {} if fs is None else {"fs": fs}
    got = d.firls(numtaps, bands, des, weight=weight, **kw)
    _same(got, tp.firls(numtaps, bands, des, weight=weight, **kw))
    np.testing.assert_allclose(
        got, ss.firls(numtaps, bands, des, weight=weight, **kw), atol=1e-7)


@pytest.mark.parametrize("freq,fs", [(440, 16000), (1000, 8000), (0.3, 2.0),
                                     (440, 44100)])
@pytest.mark.parametrize("ftype", ["iir", "fir"])
def test_gammatone(freq, fs, ftype):
    got = d.gammatone(freq, ftype, fs=fs)
    _same(got, tp.gammatone(freq, ftype, fs=fs))
    bm, am = got
    br, ar = ss.gammatone(freq, ftype, fs=fs)
    np.testing.assert_allclose(bm, br, rtol=1e-9,
                               atol=1e-12 * np.abs(br).max())
    np.testing.assert_allclose(am, ar, rtol=1e-9)


def test_gammatone_options():
    _same(d.gammatone(300, "fir", order=2, numtaps=64, fs=4000),
          tp.gammatone(300, "fir", order=2, numtaps=64, fs=4000))
    with pytest.raises(ValueError):
        d.gammatone(100, "bogus", fs=2000)


@pytest.mark.parametrize("hsize,window,fc,kw", [
    ((5, 5), (("kaiser", 5.0), ("kaiser", 5.0)), 0.1, {}),
    ((8, 6), ("hamming", "hann"), 0.3, {}),
    ((7, 5), ("hamming", "hann"), 100.0, {"fs": 1000.0}),
    ((9, 9), ("blackman", "blackman"), 0.25, {"pass_zero": False}),
    ((33, 33), "hamming", 0.3, {"circular": True}),
    ((9, 9), "hann", 0.3, {"circular": True, "pass_zero": False}),
    ((10, 10), "hann", 0.3, {"circular": True, "pass_zero": False}),
    ((9, 9), "hann", 0.3, {"circular": True, "scale": False}),
])
def test_firwin_2d(hsize, window, fc, kw):
    got = d.firwin_2d(hsize, window, fc=fc, **kw)
    _same(got, tp.firwin_2d(hsize, window, fc=fc, **kw))
    if not kw:
        np.testing.assert_allclose(
            got, ss.firwin_2d(hsize, window, fc=fc), atol=1e-14)


def test_firwin_2d_errors():
    with pytest.raises(ValueError):
        d.firwin_2d((5, 5), "hamming", fc=0.3)
    with pytest.raises(ValueError):
        d.firwin_2d((5, 7), "hamming", fc=0.3, circular=True)
    with pytest.raises(ValueError):
        d.firwin_2d((9, 9), "hamming", fc=[0.2, 0.4], circular=True)


# ---------------------------------------------------------------------------
# Residues


PFE_S_CASES = [
    ([1.0, 2.0], [1.0, 5.0, 6.0]),
    ([3.0], [1.0, 2.0, 1.0]),
    ([1.0, 0.0, 1.0], [1.0, 0.0, 0.0, -1.0]),
    ([1.0, 2.0, 3.0, 4.0], [1.0, 3.0, 3.0, 1.0]),
    ([2.0, 1.0], [1.0, -1.0, 0.25]),
]
PFE_Z_CASES = [
    ([1.0, -1.0], [1.0, -1.5, 0.56]),
    ([1.0], [1.0, -1.0, 0.25]),
    ([2.0, 1.0, 0.5, 0.1], [1.0, -0.9]),
    ([1.0, 0.3], [1.0, 0.0, 0.64]),
]


@pytest.mark.parametrize("b,a", PFE_S_CASES)
@pytest.mark.parametrize("rtype", ["avg", "min", "max"])
def test_residue_invres(b, a, rtype):
    b, a = np.asarray(b), np.asarray(a)
    r, p, k = d.residue(b, a, rtype=rtype)
    _same((r, p, k), tp.residue(b, a, rtype=rtype))
    _same(d.invres(r, p, k, rtype=rtype), tp.invres(r, p, k, rtype=rtype))


@pytest.mark.parametrize("b,a", PFE_Z_CASES)
@pytest.mark.parametrize("rtype", ["avg", "min", "max"])
def test_residuez_invresz(b, a, rtype):
    b, a = np.asarray(b), np.asarray(a)
    r, p, k = d.residuez(b, a, rtype=rtype)
    _same((r, p, k), tp.residuez(b, a, rtype=rtype))
    _same(d.invresz(r, p, k, rtype=rtype), tp.invresz(r, p, k, rtype=rtype))
    rr, pr, kr = ss.residuez(b, a)
    _same(d.invresz(rr, pr, kr if np.size(kr) else np.array([0.0])),
          tp.invresz(rr, pr, kr if np.size(kr) else np.array([0.0])))


@pytest.mark.parametrize("rtype", ["min", "max", "avg"])
def test_unique_roots(rtype):
    p = np.array([1.0, 1.0005, 2.0, 2.0, 3.0, 1 + 1j, 1 + 1.0001j])
    _same(d.unique_roots(p, tol=1e-2, rtype=rtype),
          tp.unique_roots(p, tol=1e-2, rtype=rtype))
    with pytest.raises(ValueError):
        d.unique_roots(p, rtype="bogus")


def test_lfiltic():
    rng = np.random.default_rng(3)
    y, x = rng.standard_normal(5), rng.standard_normal(5)
    cases = [ss.butter(3, 0.3),
             (np.array([1.0, 0.5, 0.2]), np.array([1.0])),
             (np.array([0.2]), np.array([1.0, -0.7, 0.1, 0.05])),
             (np.array([2.0, 1.0]), np.array([2.0, -1.0, 0.3]))]
    for b, a in cases:
        for xx in (None, x, x[:1]):
            got = d.lfiltic(b, a, y, xx)
            _same(got, tp.lfiltic(b, a, y, xx))
            np.testing.assert_allclose(got, ss.lfiltic(b, a, y, xx),
                                       atol=1e-12)
        _same(d.lfiltic(b, a, y[:1]), tp.lfiltic(b, a, y[:1]))

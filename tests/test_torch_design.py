"""The port's filter-design core against tpufft.design and scipy.signal.

Both packages design on the host in float64 numpy and the port keeps its
own copy of the code, so the two agree to 1e-12 (relative to the
coefficients' size). Against scipy the tolerances are tpufft's own
(tests/test_design.py): sos arrays compare by response (factorizations
are not unique), prototypes by root set."""

import numpy as np
import pytest
import scipy.signal as ss

import tpufft
from tpufft import design as tp

import tpufft_torch
from tpufft_torch import design as d
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TOL = 1e-12


def _same(got, ref, tol=TOL):
    """Port against tpufft: every array of a (nested) result within tol of
    the larger of 1 and its size."""
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, tol)
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.size:
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(got - ref)) <= tol * scale


def rootset_err(a, b):
    a = np.atleast_1d(np.asarray(a, complex))
    b = np.atleast_1d(np.asarray(b, complex))
    if a.shape != b.shape:
        return np.inf
    used = np.zeros(b.size, bool)
    tot = 0.0
    for x in a:
        i = np.argmin(np.where(used, np.inf, np.abs(b - x)))
        used[i] = True
        tot = max(tot, abs(b[i] - x) / max(1.0, abs(x)))
    return tot


def resp_err(ba1, ba2, n=512):
    _, h1 = ss.freqz(*ba1, worN=n)
    _, h2 = ss.freqz(*ba2, worN=n)
    return np.max(np.abs(h1 - h2)) / max(1e-30, np.max(np.abs(h2)))


def test_exports_are_tpufft_names():
    names = [n for n in d.__all__]
    assert len(names) == 64
    for name in names:
        assert name in tpufft.__all__, name
        assert name in tpufft_torch.__all__, name
        assert getattr(tpufft_torch, name) is getattr(d, name)


@pytest.mark.parametrize("N", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("proto,args", [
    ("buttap", ()), ("cheb1ap", (1.0,)), ("cheb1ap", (0.05,)),
    ("cheb2ap", (40.0,)), ("cheb2ap", (80.0,))])
def test_buttap_cheb_prototypes(N, proto, args):
    z1, p1, k1 = getattr(d, proto)(N, *args)
    _same((z1, p1, k1), getattr(tp, proto)(N, *args))
    z2, p2, k2 = getattr(ss, proto)(N, *args)
    assert rootset_err(p1, p2) < 1e-10
    assert rootset_err(z1, z2) < 1e-10
    assert abs(k1 - k2) / abs(k2) < 1e-10


@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 7, 8])
@pytest.mark.parametrize("rp,rs", [(1.0, 40.0), (0.1, 80.0), (3.0, 30.0),
                                   (0.01, 100.0)])
def test_ellipap(N, rp, rs):
    z1, p1, k1 = d.ellipap(N, rp, rs)
    _same((z1, p1, k1), tp.ellipap(N, rp, rs))
    z2, p2, k2 = ss.ellipap(N, rp, rs)
    assert rootset_err(p1, p2) < 1e-8
    assert rootset_err(z1, z2) < 1e-8
    assert abs(k1 - k2) / abs(k2) < 1e-8


@pytest.mark.parametrize("N", [1, 2, 4, 6, 9, 12])
@pytest.mark.parametrize("norm", ["phase", "delay", "mag"])
def test_besselap(N, norm):
    z1, p1, k1 = d.besselap(N, norm=norm)
    _same((z1, p1, k1), tp.besselap(N, norm=norm))
    z2, p2, k2 = ss.besselap(N, norm=norm)
    assert rootset_err(p1, p2) < 1e-9
    assert abs(k1 - k2) / abs(k2) < 1e-9


@pytest.mark.parametrize("kind,args", [
    ("butter", (4, 0.3)), ("butter", (5, [0.2, 0.5])),
    ("cheby1", (4, 1, 0.3)), ("cheby1", (7, 0.5, [0.1, 0.7])),
    ("cheby2", (6, 40, 0.4)), ("cheby2", (5, 60, [0.3, 0.6])),
    ("ellip", (5, 1, 40, 0.3)), ("ellip", (4, 0.5, 60, [0.2, 0.6])),
    ("bessel", (4, 0.25)), ("bessel", (7, [0.1, 0.4])),
])
def test_full_designs_response(kind, args):
    f1, f0, fs = getattr(d, kind), getattr(tp, kind), getattr(ss, kind)
    btypes = (["low", "high"] if np.ndim(args[-1]) == 0
              else ["bandpass", "bandstop"])
    for btype in btypes:
        for output in ("ba", "zpk", "sos"):
            _same(f1(*args, btype=btype, output=output),
                  f0(*args, btype=btype, output=output))
        assert resp_err(f1(*args, btype=btype),
                        fs(*args, btype=btype)) < 1e-7


def test_analog_and_fs_forms():
    _same(d.butter(4, 100, fs=1000), tp.butter(4, 100, fs=1000))
    assert resp_err(d.butter(4, 100, fs=1000), ss.butter(4, 100, fs=1000)) \
        < 1e-9
    b1, a1 = d.butter(4, 100, analog=True, btype="low")
    _same((b1, a1), tp.butter(4, 100, analog=True, btype="low"))
    b2, a2 = ss.butter(4, 100, analog=True, btype="low")
    assert np.allclose(b1, b2) and np.allclose(a1, a2)


@pytest.mark.parametrize("zpk", [
    ss.ellip(6, 1, 40, [0.2, 0.6], btype="bandpass", output="zpk"),
    ss.butter(7, [0.1, 0.3], btype="bandstop", output="zpk"),
    ss.cheby2(5, 50, 0.4, output="zpk")], ids=["ellip", "butter", "cheby2"])
def test_sos_output_response_equivalent(zpk):
    sos = d.zpk2sos(*zpk)
    _same(sos, tp.zpk2sos(*zpk))
    b, a = ss.zpk2tf(*zpk)
    _, h1 = ss.sosfreqz(sos, worN=512)
    _, h2 = ss.freqz(b, a, worN=512)
    assert np.max(np.abs(h1 - h2)) / np.max(np.abs(h2)) < 1e-6
    # highest-Q poles in the LAST section (round-off ordering)
    dist = [abs(1 - np.abs(np.roots(row[3:])).max(initial=0.0))
            for row in sos]
    assert dist[-1] == min(dist)


def test_converters_roundtrip():
    b, a = ss.butter(4, 0.3)
    z, p, k = d.tf2zpk(b, a)
    _same((z, p, k), tp.tf2zpk(b, a))
    bb, aa = d.zpk2tf(z, p, k)
    _same((bb, aa), tp.zpk2tf(z, p, k))
    assert np.allclose(bb, b) and np.allclose(aa, a)
    assert not np.iscomplexobj(bb)
    sos = d.tf2sos(b, a)
    _same(sos, tp.tf2sos(b, a))
    assert resp_err(ss.sos2tf(sos), (b, a)) < 1e-10


def test_normalize_and_bad_coefficients():
    _same(d.normalize([2.0, 4.0], [2.0, 1.0]),
          tp.normalize([2.0, 4.0], [2.0, 1.0]))
    with pytest.warns(d.BadCoefficients):
        b, a = d.normalize([0.0, 0.0, 1.0, 2.0], [1.0, 0.5])
    with pytest.warns(ss.BadCoefficients):
        ref = ss.normalize([0.0, 0.0, 1.0, 2.0], [1.0, 0.5])
    _same((b, a), ref)
    with pytest.raises(ValueError):
        d.normalize([1.0], [0.0, 1.0])


@pytest.mark.parametrize("fn", ["lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk",
                                "lp2bs_zpk", "bilinear_zpk"])
def test_zpk_transforms(fn):
    z, p, k = ss.cheb2ap(5, 40.0)
    args = {"lp2lp_zpk": (2.5,), "lp2hp_zpk": (2.5,),
            "lp2bp_zpk": (2.0, 0.7), "lp2bs_zpk": (2.0, 0.7),
            "bilinear_zpk": (10.0,)}[fn]
    got = getattr(d, fn)(z, p, k, *args)
    _same(got, getattr(tp, fn)(z, p, k, *args))
    ref = getattr(ss, fn)(z, p, k, *args)
    assert rootset_err(got[0], ref[0]) < 1e-10
    assert rootset_err(got[1], ref[1]) < 1e-10
    assert abs(got[2] - ref[2]) <= 1e-10 * abs(ref[2])


@pytest.mark.parametrize("args,kw", [
    ((31, 0.4), {}), ((30, 0.3), {"window": "blackman"}),
    ((65, [0.2, 0.5]), {"pass_zero": False}),
    ((33, [0.1, 0.3, 0.6]), {}),
    ((64, 0.4), {"width": 0.05}),
    ((21, 0.3), {"pass_zero": "highpass"}),
    ((129, [0.1, 0.9]), {"pass_zero": "bandstop", "scale": False}),
    ((31, 100.0), {"fs": 1000.0}),
    ((61, 1.0 / 3), {"window": ("kaiser", 5.0)}),
])
def test_firwin(args, kw):
    h = d.firwin(*args, **kw)
    _same(h, tp.firwin(*args, **kw))
    assert np.max(np.abs(h - ss.firwin(*args, **kw))) < 1e-12


def test_firwin_errors():
    with pytest.raises(ValueError):
        d.firwin(30, 0.5, pass_zero="highpass")  # even taps, nyq pass
    with pytest.raises(ValueError):
        d.firwin(31, [0.5, 0.2])
    with pytest.raises(ValueError):
        d.firwin(31, 1.5)


@pytest.mark.parametrize("atten", [10.0, 30.0, 60.0])
def test_kaiser_helpers(atten):
    assert d.kaiser_beta(atten) == tp.kaiser_beta(atten)
    assert abs(d.kaiser_beta(atten) - ss.kaiser_beta(atten)) < 1e-12
    assert abs(d.kaiser_atten(101, 0.05) - ss.kaiser_atten(101, 0.05)) \
        < 1e-12


def test_zi_constants():
    b, a = ss.butter(5, 0.25)
    _same(d.lfilter_zi(b, a), tp.lfilter_zi(b, a))
    assert np.allclose(d.lfilter_zi(b, a), ss.lfilter_zi(b, a))
    sos = ss.ellip(7, 1, 40, 0.3, output="sos")
    _same(d.sosfilt_zi(sos), tp.sosfilt_zi(sos))
    assert np.allclose(d.sosfilt_zi(sos), ss.sosfilt_zi(sos))


def test_iirfilter_validation():
    with pytest.raises(ValueError):
        d.iirfilter(4, 1.5, btype="low")
    with pytest.raises(ValueError):
        d.iirfilter(4, [0.5, 0.2], btype="bandpass")
    with pytest.raises(ValueError):
        d.iirfilter(4, 0.3, btype="low", ftype="cheby1")  # rp missing
    with pytest.raises(ValueError):
        d.butter(4, 0.3, output="bogus")


def test_native_pipeline_end_to_end():
    """decimate/filtfilt on the port's own designs, with no scipy design
    call, match scipy's pipeline and tpufft's."""
    x = np.random.default_rng(0).normal(size=(3, 500))
    for ftype in ("iir", "fir"):
        got = tpufft_torch.decimate(x, 4, ftype=ftype, device="cpu")
        np.testing.assert_allclose(got, ss.decimate(x, 4, ftype=ftype),
                                   atol=1e-10)
        np.testing.assert_allclose(
            got, np.asarray(tpufft.decimate(x, 4, ftype=ftype)), atol=1e-9)
    b, a = tpufft_torch.butter(4, 0.2)
    np.testing.assert_allclose(tpufft_torch.filtfilt(b, a, x, device="cpu"),
                               ss.filtfilt(b, a, x), atol=1e-10)

"""The port's peak finding against tpufft.peaks and scipy.signal.

Every case of ``tests/test_peaks.py`` runs here, for three input forms:
numpy with ``device="cpu"``, a float64 CPU tensor and a float32 CPU tensor
(decided in float64 after the cast, so held against tpufft on the float32
values). Tolerances: indices and bases are exact; every float property is
within 1e-12 of the larger of 1 and its size. Against scipy the limits are
tpufft's own tests' (exact indices, ``assert_allclose`` for widths).

Beyond tpufft's cases: the rounds of the ``distance`` thinning on a ramp
of peaks closer than the distance, plateaus at both ends, ``wlen`` windows
clipped at both ends, ties in the base minima, equal heights within the
distance (scipy orders them by numpy's argsort, which is not stable), and
a provenance guard: no function of the port's module shares more than 0.3
of its token 6-grams with scipy's ``_peak_finding.py``."""

import ast
import inspect
import io
import tokenize
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

import tpufft
from tpufft import peaks as tp

import tpufft_torch
from tpufft_torch import peaks as pk
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TOL = 1e-12
FORMS = ["numpy", "f64", "f32"]


def _signals():
    rng = np.random.default_rng(0)
    return {
        "noise": rng.standard_normal(500),
        "walk": np.cumsum(rng.standard_normal(1000)),
        "sine": np.sin(np.linspace(0, 40, 800))
        + 0.3 * rng.standard_normal(800),
        "plateau": np.repeat(rng.integers(0, 8, 120),
                             rng.integers(1, 5, 120)).astype(float),
        "edges": np.array([5.0, 1, 2, 1, 3, 3, 3, 1, 4, 4, 1, 6.0]),
    }


SIGNALS = _signals()
NAMES = list(SIGNALS)


def _form(x: np.ndarray, form: str):
    """(the port's input, the float64 values tpufft is held on)."""
    if form == "numpy":
        return x, x
    if form == "f64":
        return torch.from_numpy(x), x
    x32 = x.astype(np.float32)
    return torch.from_numpy(x32), x32.astype(np.float64)


def _kw(form: str) -> dict:
    return {"device": "cpu"} if form == "numpy" else {}


def _np(v, form: str):
    """A result as numpy, checking that tensors came back for tensors."""
    if form == "numpy":
        assert isinstance(v, np.ndarray)
        return v
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    return v.numpy()


def _same(got, ref, exact=False):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if exact or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref)
    elif ref.size:
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(got - ref)) <= TOL * scale


def _same_peaks(got, ref, form):
    (p_got, props_got), (p_ref, props_ref) = got, ref
    _same(_np(p_got, form), p_ref, exact=True)
    assert list(props_got) == list(props_ref)
    for key in props_ref:
        _same(_np(props_got[key], form), props_ref[key])


# ---------------------------------------------------------------------------
# tpufft's cases


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", NAMES)
def test_local_maxima_and_plateaus(name, form):
    x, ref_x = _form(SIGNALS[name], form)
    got = _np(tpufft_torch.find_peaks(x, **_kw(form))[0], form)
    _same(got, tp.find_peaks(ref_x)[0], exact=True)
    _same(got, sps.find_peaks(ref_x)[0], exact=True)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("wlen", [None, 31, 10])
@pytest.mark.parametrize("name", NAMES)
def test_peak_prominences(name, wlen, form):
    x, ref_x = _form(SIGNALS[name], form)
    peaks, _ = sps.find_peaks(ref_x)
    got = pk.peak_prominences(x, peaks, wlen, **_kw(form))
    for g, r, s in zip(got, tp.peak_prominences(ref_x, peaks, wlen),
                       sps.peak_prominences(ref_x, peaks, wlen)):
        _same(_np(g, form), r)
        _same(_np(g, form), s)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("rel_height", [0.5, 0.75, 1.0])
@pytest.mark.parametrize("name", NAMES)
def test_peak_widths(name, rel_height, form):
    x, ref_x = _form(SIGNALS[name], form)
    peaks, _ = sps.find_peaks(ref_x)
    got = pk.peak_widths(x, peaks, rel_height, **_kw(form))
    for g, r, s in zip(got, tp.peak_widths(ref_x, peaks, rel_height),
                       sps.peak_widths(ref_x, peaks, rel_height)):
        _same(_np(g, form), r)
        np.testing.assert_allclose(_np(g, form), s)


FILTERS = [
    dict(height=0.5), dict(height=(0.1, 2.0)), dict(threshold=0.2),
    dict(distance=7), dict(distance=1.5), dict(prominence=0.8),
    dict(width=3), dict(width=(2, 9), rel_height=0.7),
    dict(plateau_size=2), dict(plateau_size=(1, 3)),
    dict(height=0.2, distance=5, prominence=0.5, width=2),
    dict(prominence=0.5, wlen=25),
    dict(height=(None, 1.0), threshold=(None, 0.5), plateau_size=(None, 2),
         prominence=(0.1, None), width=(None, 30.0), wlen=40.5),
]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kw", range(len(FILTERS)))
@pytest.mark.parametrize("name", NAMES)
def test_find_peaks_filters(name, kw, form):
    x, ref_x = _form(SIGNALS[name], form)
    kw = FILTERS[kw]
    got = tpufft_torch.find_peaks(x, **kw, **_kw(form))
    _same_peaks(got, tp.find_peaks(ref_x, **kw), form)
    p_ref, props_ref = sps.find_peaks(ref_x, **kw)
    _same(_np(got[0], form), p_ref, exact=True)
    assert set(got[1]) == set(props_ref)


@pytest.mark.parametrize("bounds", ["numpy", "tensor"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", NAMES)
def test_find_peaks_array_conditions(name, form, bounds):
    """Array bounds as long as x, read at each peak: numpy arrays, and
    tensors (for any input form)."""
    x, ref_x = _form(SIGNALS[name], form)
    h = np.full(ref_x.shape, 0.3)
    h[:len(h) // 2] = 1.2
    t = np.linspace(0.0, 0.4, ref_x.size)
    arg = (lambda a: a) if bounds == "numpy" else torch.from_numpy
    kw = dict(height=arg(h), threshold=(None, arg(t + 1.0)),
              prominence=(arg(t), None))
    ref_kw = dict(height=h, threshold=(None, t + 1.0), prominence=(t, None))
    got = tpufft_torch.find_peaks(x, **kw, **_kw(form))
    _same_peaks(got, tp.find_peaks(ref_x, **ref_kw), form)
    _same(_np(got[0], form), sps.find_peaks(ref_x, **ref_kw)[0], exact=True)


_SINE = np.sin(np.linspace(0, 10, 100))
ERRORS = [
    ("distance", lambda m, x: m.find_peaks(x, distance=0.5), ValueError),
    ("2d", lambda m, x: m.find_peaks(np.ones((3, 3))), ValueError),
    ("wlen", lambda m, x: m.find_peaks(x, prominence=1, wlen=1), ValueError),
    ("range", lambda m, x: m.peak_prominences(x, np.array([1000])),
     ValueError),
    ("float_peaks", lambda m, x: m.peak_prominences(x, np.array([1.5])),
     TypeError),
    ("peaks_2d", lambda m, x: m.peak_prominences(x, np.ones((2, 2), int)),
     ValueError),
    ("rel_height", lambda m, x: m.peak_widths(x, np.array([5]), -1.0),
     ValueError),
    ("prominence_shape", lambda m, x: m.peak_widths(
        x, np.array([5, 20]), 0.5, (np.ones(2), np.zeros(2, int),
                                    np.full(3, 30))), ValueError),
    ("prominence_bases", lambda m, x: m.peak_widths(
        x, np.array([5, 20]), 0.5, (np.ones(2), np.array([0, 21]),
                                    np.array([9, 30]))), ValueError),
    ("lower_array", lambda m, x: m.find_peaks(x, height=np.ones(7)),
     ValueError),
    ("upper_array", lambda m, x: m.find_peaks(x, width=(1, np.ones(7))),
     ValueError),
    ("order", lambda m, x: m.argrelmax(x, order=0), ValueError),
    ("cwt_distances", lambda m, x: m.find_peaks_cwt(
        x, np.arange(1, 6), max_distances=[1.0, 1.0]), ValueError),
]


class _Port:
    """The port's functions with ``device="cpu"`` for numpy input."""

    def __getattr__(self, name):
        fn = getattr(pk, name)
        return lambda *a, **k: fn(*a, device="cpu", **k)


@pytest.mark.parametrize("case", ERRORS, ids=[e[0] for e in ERRORS])
def test_find_peaks_errors(case):
    """The same error, with tpufft's message, from both packages."""
    _, call, kind = case
    with pytest.raises(kind) as ref:
        call(tp, _SINE)
    with pytest.raises(kind, match=str(ref.value).replace(
            "(", r"\(").replace(")", r"\)")):
        call(_Port(), _SINE)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("name", NAMES)
def test_argrel_family(name, order, mode, form):
    """argrel* compare in the input's dtype: a float32 tensor is held to
    tpufft on the float32 array."""
    x = SIGNALS[name]
    x, ref_x = (x.astype(np.float32),) * 2 if form == "f32" else (x, x)
    arg = torch.from_numpy(x) if form != "numpy" else x
    for fn in ("argrelmax", "argrelmin"):
        got = getattr(pk, fn)(arg, order=order, mode=mode, **_kw(form))
        assert isinstance(got, tuple) and len(got) == 1
        _same(_np(got[0], form), getattr(tp, fn)(
            ref_x, order=order, mode=mode)[0], exact=True)
        _same(_np(got[0], form), getattr(sps, fn)(
            ref_x, order=order, mode=mode)[0], exact=True)


@pytest.mark.parametrize("form", ["numpy", "f64"])
@pytest.mark.parametrize("comparator", [np.greater, np.less_equal,
                                        lambda a, b: a > b + 0.5])
@pytest.mark.parametrize("axis", [0, 1])
def test_argrelextrema_2d(axis, comparator, form):
    x2 = np.random.default_rng(1).standard_normal((40, 30))
    arg = torch.from_numpy(x2) if form == "f64" else x2
    got = pk.argrelextrema(arg, comparator, axis=axis, order=2, **_kw(form))
    ref = tp.argrelextrema(x2, comparator, axis=axis, order=2)
    assert len(got) == 2
    for g, r, s in zip(got, ref, sps.argrelextrema(x2, comparator,
                                                   axis=axis, order=2)):
        _same(_np(g, form), r, exact=True)
        _same(_np(g, form), s, exact=True)
    with pytest.raises(ValueError):
        pk.argrelmax(arg, order=0, **_kw(form))


@pytest.mark.parametrize("form", FORMS)
def test_wlen_between_one_and_two(form):
    """scipy's rule: any wlen above 1 rounds up to 2; only <= 1 raises."""
    x, ref_x = _form(np.sin(np.linspace(0, 30, 400)), form)
    got = tpufft_torch.find_peaks(x, prominence=0.5, wlen=1.9, **_kw(form))
    _same_peaks(got, tp.find_peaks(ref_x, prominence=0.5, wlen=1.9), form)
    _same(_np(got[0], form), sps.find_peaks(ref_x, prominence=0.5,
                                            wlen=1.9)[0], exact=True)
    with pytest.raises(ValueError):
        tpufft_torch.find_peaks(x, prominence=0.5, wlen=1, **_kw(form))


# ---------------------------------------------------------------------------
# find_peaks_cwt


def _cwt_signals():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 500)
    return {
        "gausses": (np.exp(-((t - 2) / 0.3) ** 2)
                    + 0.7 * np.exp(-((t - 6) / 0.5) ** 2)
                    + 0.03 * rng.standard_normal(500)),
        "sine": np.sin(np.linspace(0, 30, 600))
        + 0.1 * rng.standard_normal(600),
        "noise": rng.standard_normal(400),
        "walk": np.cumsum(rng.standard_normal(700)),
    }


CWT_SIGNALS = _cwt_signals()
CWT_WIDTHS = [np.arange(1, 20), np.arange(3, 40, 2), [5, 10, 15]]


def _cwt_same(got, ref, form):
    got = _np(got, form)
    assert got.dtype == np.int64
    _same(got, np.asarray(ref, np.int64), exact=True)


@pytest.mark.parametrize("form", ["numpy", "f64"])
@pytest.mark.parametrize("widths", range(len(CWT_WIDTHS)))
@pytest.mark.parametrize("name", list(CWT_SIGNALS))
def test_cwt_default_parity(name, widths, form):
    x, ref_x = _form(CWT_SIGNALS[name], form)
    w = CWT_WIDTHS[widths]
    got = tpufft_torch.find_peaks_cwt(x, w, **_kw(form))
    _cwt_same(got, tp.find_peaks_cwt(ref_x, w), form)
    _cwt_same(got, sps.find_peaks_cwt(ref_x, w), form)


CWT_KW = [dict(min_snr=2), dict(noise_perc=20), dict(min_length=6),
          dict(gap_thresh=1), dict(window_size=41),
          dict(max_distances=np.full(19, 3.0))]


@pytest.mark.parametrize("form", ["numpy", "f64"])
@pytest.mark.parametrize("kw", range(len(CWT_KW)))
def test_cwt_kwargs_parity(kw, form):
    x, ref_x = _form(CWT_SIGNALS["gausses"], form)
    kw = CWT_KW[kw]
    got = tpufft_torch.find_peaks_cwt(x, np.arange(1, 20), **kw, **_kw(form))
    _cwt_same(got, tp.find_peaks_cwt(ref_x, np.arange(1, 20), **kw), form)
    _cwt_same(got, sps.find_peaks_cwt(ref_x, np.arange(1, 20), **kw), form)


def _gauss_wav(points, a):
    tt = np.arange(points) - (points - 1) / 2
    return np.exp(-(tt / a) ** 2)


def _asym(n, a):
    tt = np.arange(n) - (np.asarray(n) - 1) / 2
    return np.exp(-(tt / a) ** 2) * (1 + 0.5 * np.tanh(tt / a))


def _cplx(n, a):
    tt = np.arange(n) - (np.asarray(n) - 1) / 2
    return np.exp(1j * tt / a) * np.exp(-(tt / a) ** 2)


CWT_CASES = [
    ("gauss_wavelet", np.arange(2, 15), {"wavelet": _gauss_wav}),
    ("asymmetric", [3, 5, 8], {"wavelet": _asym}),
    ("complex", [3, 5], {"wavelet": _cplx}),
    ("fractional", [2.55, 3.7, 5.1, 7.77], {}),
]


@pytest.mark.parametrize("form", ["numpy", "f64", "f32"])
@pytest.mark.parametrize("case", CWT_CASES, ids=[c[0] for c in CWT_CASES])
def test_cwt_custom_wavelets(case, form):
    """Conj-reversed kernels (asymmetric wavelets), the raw float window
    (fractional widths) and the real part of complex rows."""
    _, widths, kw = case
    x, ref_x = _form(CWT_SIGNALS["gausses"], form)
    got = tpufft_torch.find_peaks_cwt(x, widths, **kw, **_kw(form))
    _cwt_same(got, tp.find_peaks_cwt(ref_x, widths, **kw), form)
    _cwt_same(got, sps.find_peaks_cwt(ref_x, widths, **kw), form)


@pytest.mark.parametrize("form", ["numpy", "f64"])
def test_cwt_edge_cases(form):
    """The zero signal has no ridge; the two bumps are found."""
    zeros, _ = _form(np.zeros(100), form)
    got = _np(tpufft_torch.find_peaks_cwt(zeros, np.arange(1, 10),
                                          **_kw(form)), form)
    assert got.size == 0
    np.testing.assert_array_equal(
        got, sps.find_peaks_cwt(np.zeros(100), np.arange(1, 10)))
    x, _ = _form(CWT_SIGNALS["gausses"], form)
    locs = _np(tpufft_torch.find_peaks_cwt(x, np.arange(3, 20),
                                           **_kw(form)), form)
    assert any(abs(v - 100) < 6 for v in locs)    # t = 2 -> index ~100
    assert any(abs(v - 300) < 6 for v in locs)    # t = 6 -> index ~300


def test_complex_vector_cwt():
    """A complex signal's rows keep the real part of the product."""
    rng = np.random.default_rng(3)
    z = CWT_SIGNALS["sine"] + 1j * rng.standard_normal(600) * 0.2
    got = pk.find_peaks_cwt(torch.from_numpy(z), np.arange(1, 12))
    _cwt_same(got, tp.find_peaks_cwt(z, np.arange(1, 12)), "f64")


# ---------------------------------------------------------------------------
# The port's own hard cases


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("spacing,distance", [(3, 10), (1 + 1, 7.5),
                                              (4, 4.5)])
def test_distance_ramp_takes_a_round_per_kept_peak(spacing, distance, form):
    """Peaks on a rising ramp closer than ``distance``: the highest (the
    last) drops its neighbours, then the highest left, and so on; each
    round keeps exactly one peak."""
    n = 400
    x = np.zeros(n)
    x[1:-1:spacing] = np.linspace(1, 2, len(x[1:-1:spacing]))
    x, ref_x = _form(x, form)
    got = tpufft_torch.find_peaks(x, distance=distance, **_kw(form))
    ref = tp.find_peaks(ref_x, distance=distance)
    _same_peaks(got, ref, form)
    assert pk.distance_rounds == len(ref[0])
    _same(_np(got[0], form), sps.find_peaks(ref_x, distance=distance)[0],
          exact=True)


@pytest.mark.parametrize("form", FORMS)
def test_equal_heights_within_distance(form):
    """Equal heights within the distance are ordered as scipy orders them
    (numpy's argsort, which is not stable for these inputs)."""
    x = np.zeros(601)
    x[1::2] = np.random.default_rng(5).integers(1, 4, 300)
    xin, ref_x = _form(x, form)
    for d in (2, 3, 5, 9):
        got = tpufft_torch.find_peaks(xin, distance=d, **_kw(form))
        _same_peaks(got, tp.find_peaks(ref_x, distance=d), form)
        _same(_np(got[0], form), sps.find_peaks(ref_x, distance=d)[0],
              exact=True)


EDGE_SIGNALS = {
    "plateaus_at_both_ends": np.array([3.0, 3, 3, 1, 2, 2, 1, 4, 4, 4]),
    "rising_edges": np.array([1.0, 1, 2, 3, 3, 2, 5, 5]),
    "base_ties": np.array([2.0, 0, 0, 5, 1, 0, 1, 0, 6, 0, 0, 0, 3, 0]),
    "all_equal": np.ones(9),
    "short": np.array([0.0, 1.0]),
    "three": np.array([0.0, 1.0, 0.0]),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("wlen", [None, 3, 4, 7, 100])
@pytest.mark.parametrize("name", list(EDGE_SIGNALS))
def test_edge_signals(name, wlen, form):
    """Plateaus at both ends (no peak), ties in the base minima (left base
    the rightmost, right base the leftmost) and windows clipped at both
    ends."""
    x, ref_x = _form(EDGE_SIGNALS[name], form)
    kw = dict(prominence=0, width=0, plateau_size=1, wlen=wlen,
              rel_height=1.0)
    got = tpufft_torch.find_peaks(x, **kw, **_kw(form))
    _same_peaks(got, tp.find_peaks(ref_x, **kw), form)
    p_ref, props_ref = sps.find_peaks(ref_x, **kw)
    _same(_np(got[0], form), p_ref, exact=True)
    for key in ("left_bases", "right_bases"):
        _same(_np(got[1][key], form), props_ref[key], exact=True)


@pytest.mark.parametrize("wlen", [5, 51, 400])
def test_windows_clipped_at_both_ends(wlen):
    """Peaks near both ends of a long walk, with windows wider than the
    room left on either side."""
    x = np.cumsum(np.random.default_rng(7).standard_normal(300))
    peaks = np.array([1, 2, 5, 150, 290, 297, 298])
    got = pk.peak_prominences(torch.from_numpy(x), torch.from_numpy(peaks),
                              wlen)
    for g, r in zip(got, sps.peak_prominences(x, peaks, wlen)):
        _same(g.numpy(), r)
    widths = pk.peak_widths(x, peaks, 0.9, None, wlen, device="cpu")
    for g, r in zip(widths, tp.peak_widths(x, peaks, 0.9, None, wlen)):
        _same(g, r)


def test_results_stay_tensors():
    """Tensor input: tensors on its device, indices int64, properties
    float64 (int64 for edges and bases), float32 decided in float64."""
    x = torch.from_numpy(SIGNALS["walk"].astype(np.float32))
    peaks, props = tpufft_torch.find_peaks(x, height=-100, width=1,
                                           plateau_size=1, threshold=-1)
    assert peaks.dtype == torch.int64
    for key in ("plateau_sizes", "left_edges", "right_edges", "left_bases",
                "right_bases"):
        assert props[key].dtype == torch.int64, key
    for key in ("peak_heights", "left_thresholds", "prominences", "widths",
                "left_ips"):
        assert props[key].dtype == torch.float64, key
    rows = tpufft_torch.argrelmax(x[None].expand(3, -1), axis=1)
    assert len(rows) == 2 and rows[0].dtype == torch.int64


def test_numpy_input_needs_a_device_or_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpufft_torch.find_peaks(SIGNALS["noise"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpufft_torch.argrelmax(SIGNALS["noise"])


# ---------------------------------------------------------------------------
# Provenance


def _function_tokens(source: str) -> dict:
    """Each function's tokens, docstrings and comments stripped."""
    out = {}
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)) and body \
                    and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                sub.body = body[1:] or [ast.Pass()]
        skip = {tokenize.NEWLINE, tokenize.NL, tokenize.INDENT,
                tokenize.DEDENT, tokenize.ENDMARKER, tokenize.COMMENT}
        code = ast.unparse(node)
        out[node.name] = [t.string for t in tokenize.generate_tokens(
            io.StringIO(code).readline) if t.type not in skip]
    return out


def _grams(tokens, n=6):
    return [tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def test_no_function_shares_over_0_3_of_its_6_grams_with_scipy():
    scipy_src = Path(inspect.getsourcefile(sps.find_peaks)).read_text()
    pool = {g for t in _function_tokens(scipy_src).values()
            for g in _grams(t)}
    shares = {}
    for name, tokens in _function_tokens(
            Path(inspect.getsourcefile(pk)).read_text()).items():
        grams = _grams(tokens)
        if grams:
            shares[name] = sum(g in pool for g in grams) / len(grams)
    worst = max(shares, key=shares.get)
    print(f"largest 6-gram share with scipy: {shares[worst]:.3f} "
          f"({worst}, of {len(shares)} functions)")
    assert shares[worst] <= 0.3, shares


def test_exports():
    assert tpufft_torch.find_peaks is pk.find_peaks
    assert tpufft_torch.argrelextrema is pk.argrelextrema
    assert sorted(pk.__all__) == sorted(tp.__all__)
    assert set(pk.__all__) <= set(tpufft.__all__)

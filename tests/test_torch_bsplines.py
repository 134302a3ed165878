"""The port's B-spline filters against tpufft.bsplines and scipy.signal.

Every case of ``tests/test_bsplines.py`` runs here, for numpy input with
``device="cpu"``, float64 CPU tensors and float32 CPU tensors.
Tolerances against tpufft (float64, of the larger of 1 and the output's
size): the banded solves 1e-10 (the same factors; the port's interior scan
and head and tail products round in another order); ``gauss_spline``, the
evaluations and ``sepfir2d`` 1e-12. A float32 tensor keeps float32 and is
held to tpufft on its float32 values to 1e-5. Against scipy the limits are
tpufft's tests' own (1e-10 for the interpolating prefilters, 1e-4 in the
smoothing spline's interior, 1e-9 / 1e-3 for the symmetric IIRs, 1e-5 in
2-D, 1e-12 for the evaluations and sepfir2d).

Beyond tpufft's cases: B > 1 columns in the 2-D solves on non-square
images, lengths from 1 sample up and above the factor cache's limit
(65536: the port reads a long system's factors from a short one), complex
``symiirorder1``, and the defining equations everywhere."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import tpufft
from tpufft import bsplines as tb

import tpufft_torch
from tpufft_torch import bsplines as bs
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

SOLVE_TOL = 1e-10
EXACT_TOL = 1e-12
F32_TOL = 1e-5
FORMS = ["numpy", "f64", "f32"]


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


def _np(v, form: str) -> np.ndarray:
    """A result as numpy; tensors must come back for tensors, float32 for
    float32."""
    if form == "numpy":
        assert isinstance(v, np.ndarray)
        return v
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    if form == "f32":
        assert v.dtype in (torch.float32, torch.complex64)
    return v.numpy()


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, err / scale


def _tol(form: str, tol: float) -> float:
    return F32_TOL if form == "f32" else tol


def _fold_apply(c, taps):
    """The folded taps applied to c: what the solve must invert."""
    N = len(c)
    out = np.zeros(N, np.result_type(c, *taps.values()))
    for n in range(N):
        for d, v in taps.items():
            j = n + d
            while j < 0 or j > N - 1:
                j = -j - 1 if j < 0 else 2 * N - 1 - j
            out[n] += v * c[j]
    return out


@pytest.fixture
def x():
    return np.random.default_rng(0).standard_normal(60)


# ---------------------------------------------------------------------------
# tpufft's cases


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [1, 3, 5])
def test_gauss_spline(n, form):
    g, ref_g = _form(np.linspace(-3, 3, 50), form)
    got = _np(bs.gauss_spline(g, n, **_kw(form)), form)
    _close(got, tb.gauss_spline(ref_g, n), _tol(form, EXACT_TOL))
    if form != "f32":
        np.testing.assert_allclose(got, sps.gauss_spline(ref_g, n),
                                   atol=1e-14)


@pytest.mark.parametrize("form", FORMS)
def test_cspline_qspline_1d(x, form):
    xin, ref_x = _form(x, form)
    c = _np(bs.cspline1d(xin, **_kw(form)), form)
    q = _np(bs.qspline1d(xin, **_kw(form)), form)
    _close(c, tb.cspline1d(ref_x), _tol(form, SOLVE_TOL))
    _close(q, tb.qspline1d(ref_x), _tol(form, SOLVE_TOL))
    if form != "f32":
        np.testing.assert_allclose(c, sps.cspline1d(ref_x), atol=1e-10)
        np.testing.assert_allclose(q, sps.qspline1d(ref_x), atol=1e-10)
        # the interpolation property itself: B3 * c == x
        np.testing.assert_allclose(
            _fold_apply(c, bs._spline_taps("cubic", 0.0)), ref_x,
            atol=1e-12)
    with pytest.raises(ValueError, match="lamb must be 0"):
        bs.qspline1d(xin, lamb=1.0, **_kw(form))


@pytest.mark.parametrize("form", FORMS)
def test_cspline_smoothing(x, form):
    xin, ref_x = _form(x, form)
    mine = _np(bs.cspline1d(xin, 2.5, **_kw(form)), form)
    _close(mine, tb.cspline1d(ref_x, 2.5), _tol(form, SOLVE_TOL))
    # the interior agrees with scipy; the edges differ by its startup
    np.testing.assert_allclose(mine[8:-8], sps.cspline1d(ref_x, 2.5)[8:-8],
                               atol=1e-4)
    np.testing.assert_allclose(
        _fold_apply(mine.astype(np.float64), bs._spline_taps("cubic", 2.5)),
        ref_x, atol=_tol(form, 1e-12))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c0,z1", [(1.5, 0.4), (6.0, np.sqrt(3) - 2),
                                   (2.0, -0.6)])
def test_symiirorder1(x, c0, z1, form):
    xin, ref_x = _form(x, form)
    got = _np(bs.symiirorder1(xin, c0, z1, **_kw(form)), form)
    _close(got, tb.symiirorder1(ref_x, c0, z1), _tol(form, SOLVE_TOL))
    np.testing.assert_allclose(got, sps.symiirorder1(ref_x, c0, z1),
                               atol=_tol(form, 1e-9))
    with pytest.raises(ValueError, match="less than 1.0"):
        bs.symiirorder1(xin, 1.0, 1.5, **_kw(form))


def _order2_taps(r, w):
    cs = 1 - 2 * r * np.cos(w) + r * r
    a = np.array([1.0, -2 * r * np.cos(w), r * r])
    taps = {}
    for i, ai in enumerate(a):
        for j, aj in enumerate(a):
            taps[i - j] = taps.get(i - j, 0.0) + ai * aj / (cs * cs)
    return taps


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("r,w", [(0.5, 0.8), (0.3, 1.7), (0.95, 0.2)])
def test_symiirorder2(x, r, w, form):
    """scipy agrees to its startup truncation (1e-3); near-unit poles,
    where scipy's sums may not converge, are held to the residual."""
    xin, ref_x = _form(x, form)
    got = _np(bs.symiirorder2(xin, r, w, **_kw(form)), form)
    _close(got, tb.symiirorder2(ref_x, r, w), _tol(form, SOLVE_TOL))
    if r < 0.9:
        np.testing.assert_allclose(got, sps.symiirorder2(ref_x, r, w),
                                   atol=1e-3)
    if form != "f32":
        np.testing.assert_allclose(_fold_apply(got, _order2_taps(r, w)),
                                   ref_x, atol=1e-9)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        bs.symiirorder2(xin, 1.2, 0.5, **_kw(form))


EVALS = [("cubic", {}), ("quad", {}), ("cubic", dict(dx=0.5, x0=-2)),
         ("quad", dict(dx=2.0, x0=3.0))]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", range(len(EVALS)))
def test_spline_eval(x, case, form):
    kind, kw = EVALS[case]
    cj = (sps.cspline1d if kind == "cubic" else sps.qspline1d)(x)
    newx = np.linspace(-5, 70, 300)    # covers mirrored out-of-range
    cin, ref_c = _form(cj, form)
    name = "cspline1d_eval" if kind == "cubic" else "qspline1d_eval"
    got = _np(getattr(bs, name)(cin, newx, **kw, **_kw(form)), form)
    _close(got, getattr(tb, name)(ref_c, newx, **kw),
           _tol(form, EXACT_TOL))
    np.testing.assert_allclose(got, getattr(sps, name)(ref_c, newx, **kw),
                               atol=_tol(form, 1e-12))


@pytest.mark.parametrize("form", ["numpy", "f64"])
def test_spline_eval_interpolates(x, form):
    cin, _ = _form(sps.cspline1d(x), form)
    knots = np.arange(len(x), dtype=float)
    got = bs.cspline1d_eval(cin, torch.from_numpy(knots) if form == "f64"
                            else knots, **_kw(form))
    np.testing.assert_allclose(_np(got, form), x, atol=1e-9)


@pytest.mark.parametrize("form", FORMS)
def test_2d_and_sepfir(form):
    rng = np.random.default_rng(1)
    im, ref_im = _form(rng.standard_normal((24, 31)), form)
    kw = _kw(form)
    c2 = _np(bs.cspline2d(im, **kw), form)
    q2 = _np(bs.qspline2d(im, **kw), form)
    _close(c2, tb.cspline2d(ref_im), _tol(form, SOLVE_TOL))
    _close(q2, tb.qspline2d(ref_im), _tol(form, SOLVE_TOL))
    # scipy's 2-D recursion truncates its startup sums at ~1e-6
    np.testing.assert_allclose(c2, sps.cspline2d(ref_im), atol=1e-5)
    np.testing.assert_allclose(q2, sps.qspline2d(ref_im), atol=1e-5)
    hr = np.array([1.0, 2.0, -1.0])
    hc = np.array([0.5, 3.0, 1.0, -0.2, 0.1])
    sep = _np(bs.sepfir2d(im, hr, hc, **kw), form)
    _close(sep, tb.sepfir2d(ref_im, hr, hc), _tol(form, EXACT_TOL))
    if form == "f32":
        _close(sep, sps.sepfir2d(ref_im, hr, hc), F32_TOL)
    else:
        np.testing.assert_allclose(sep, sps.sepfir2d(ref_im, hr, hc),
                                   atol=1e-12)
    with pytest.raises(ValueError, match="odd length"):
        bs.sepfir2d(im, np.ones(2), hc, **kw)
    out = _np(bs.spline_filter(im, 3.0, **kw), form)
    _close(out, tb.spline_filter(ref_im, 3.0), _tol(form, SOLVE_TOL))
    ref = sps.spline_filter(ref_im, 3.0)
    np.testing.assert_allclose(out, ref, atol=1e-2)
    np.testing.assert_allclose(out[4:-4, 4:-4], ref[4:-4, 4:-4], atol=1e-3)
    # at lmbda = 5 scipy's recursion raises; the exact solve delivers
    with pytest.raises(ValueError):
        sps.spline_filter(ref_im, 5.0)
    five = _np(bs.spline_filter(im, 5.0, **kw), form)
    assert np.all(np.isfinite(five))
    _close(five, tb.spline_filter(ref_im, 5.0), _tol(form, SOLVE_TOL))


def test_exports():
    assert tpufft_torch.cspline1d is bs.cspline1d
    assert tpufft_torch.symiirorder2 is bs.symiirorder2
    assert sorted(bs.__all__) == sorted(tb.__all__)
    assert set(bs.__all__) <= set(tpufft.__all__)


# ---------------------------------------------------------------------------
# The port's own hard cases


def _prefilters():
    return {
        "cspline": (lambda v, **k: bs.cspline1d(v, **k), tb.cspline1d),
        "qspline": (lambda v, **k: bs.qspline1d(v, **k), tb.qspline1d),
        "smoothing": (lambda v, **k: bs.cspline1d(v, 2.5, **k),
                      lambda v: tb.cspline1d(v, 2.5)),
        "order1": (lambda v, **k: bs.symiirorder1(v, 1.0, np.sqrt(3) - 2,
                                                  **k),
                   lambda v: tb.symiirorder1(v, 1.0, np.sqrt(3) - 2)),
        "order2": (lambda v, **k: bs.symiirorder2(v, 0.5, np.pi / 4, **k),
                   lambda v: tb.symiirorder2(v, 0.5, np.pi / 4)),
        "order2_slow": (lambda v, **k: bs.symiirorder2(v, 0.97, 0.1, **k),
                        lambda v: tb.symiirorder2(v, 0.97, 0.1)),
    }


PREFILTERS = _prefilters()
LENGTHS = [1, 2, 3, 4, 7, 16, 33, 100, 511, 700, 70000]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(PREFILTERS))
def test_prefilters_at_every_length(name, n, form):
    """From one sample (every row folded into the diagonal) through systems
    shorter than the factors' convergence (no steady interior) to 70000
    samples, above the factor cache's 65536 (factors read from a short
    system)."""
    x = np.random.default_rng(n).standard_normal(n)
    xin, ref_x = _form(x, form)
    port, ref = PREFILTERS[name]
    got = _np(port(xin, **_kw(form)), form)
    _close(got, ref(ref_x), _tol(form, SOLVE_TOL))


@pytest.mark.parametrize("n", [1, 5, 60, 3000])
@pytest.mark.parametrize("case", ["complex_z1", "complex_signal",
                                  "complex_c0"])
@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_symiirorder1_complex(case, n, form):
    """Complex z1, c0 or signal: a complex result (complex128 for numpy and
    float64 tensors), the same as tpufft's."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    c0, z1 = 1.5, 0.4
    if case == "complex_z1":
        z1 = 0.3 + 0.4j
    elif case == "complex_c0":
        c0 = 2.0 - 1.0j
    else:
        x = x + 1j * rng.standard_normal(n)
    arg = torch.from_numpy(x) if form == "tensor" else x
    kw = {} if form == "tensor" else {"device": "cpu"}
    got = bs.symiirorder1(arg, c0, z1, **kw)
    got = got.numpy() if form == "tensor" else got
    assert np.iscomplexobj(got)
    _close(got, tb.symiirorder1(x, c0, z1), SOLVE_TOL)


@pytest.mark.parametrize("shape", [(1, 7), (5, 1), (3, 64), (130, 9),
                                   (600, 40)])
@pytest.mark.parametrize("name", ["cspline2d", "qspline2d",
                                  "spline_filter"])
@pytest.mark.parametrize("form", FORMS)
def test_2d_solves_batch_columns(shape, name, form):
    """Each 2-D solve batches the columns along axis 0, then the rows along
    axis 1; non-square images, single rows and columns, and one axis above
    the short system's 512 rows."""
    im = np.random.default_rng(sum(shape)).standard_normal(shape)
    imin, ref_im = _form(im, form)
    got = _np(getattr(bs, name)(imin, **_kw(form)), form)
    _close(got, getattr(tb, name)(ref_im), _tol(form, SOLVE_TOL))


SEPFIR = [([1.0], [1.0]), ([1.0, 2.0, -1.0], [2.0]),
          ([0.25] * 7, [0.5, 3.0, 1.0, -0.2, 0.1]),
          ([1.0] * 41, [1.0, 2.0, 3.0])]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("taps", range(len(SEPFIR)))
@pytest.mark.parametrize("shape", [(24, 31), (2, 3), (1, 9)])
def test_sepfir2d_kernels(shape, taps, form):
    """One-tap kernels, short ones, and kernels longer than the image
    (the mirror folds more than once)."""
    im = np.random.default_rng(4).standard_normal(shape)
    hr, hc = (np.asarray(h) for h in SEPFIR[taps])
    imin, ref_im = _form(im, form)
    got = _np(bs.sepfir2d(imin, hr, hc, **_kw(form)), form)
    _close(got, tb.sepfir2d(ref_im, hr, hc), _tol(form, EXACT_TOL))


@pytest.mark.parametrize("n", [1, 2, 9])
@pytest.mark.parametrize("name", ["cspline1d_eval", "qspline1d_eval"])
def test_eval_short_coefficients(name, n):
    """One coefficient (every point folds to 0) and a few, with points far
    outside the knots (more than one fold)."""
    cj = np.random.default_rng(n).standard_normal(n)
    newx = np.linspace(-40, 55, 211)
    got = getattr(bs, name)(torch.from_numpy(cj), torch.from_numpy(newx))
    _close(got.numpy(), getattr(tb, name)(cj, newx), EXACT_TOL)


def test_shape_errors():
    """The errors of tpufft, for numpy and tensors alike."""
    for arg in (np.ones((3, 3)), torch.ones((3, 3), dtype=torch.float64)):
        kw = {} if isinstance(arg, torch.Tensor) else {"device": "cpu"}
        for fn in (bs.cspline1d, bs.qspline1d):
            with pytest.raises(ValueError, match="signal must be 1-D"):
                fn(arg, **kw)
        with pytest.raises(ValueError, match="signal must be 1-D"):
            bs.symiirorder1(arg, 1.0, 0.5, **kw)
        with pytest.raises(ValueError, match="input must be 1-D"):
            bs.symiirorder2(arg, 0.5, 0.5, **kw)
        for fn in (bs.cspline2d, bs.qspline2d, bs.spline_filter):
            with pytest.raises(ValueError, match="input must be 2-D"):
                fn(arg[0], **kw)
        with pytest.raises(ValueError, match="lamb must be 0"):
            bs.qspline2d(arg, 1.0, **kw)
    with pytest.raises(ValueError):
        tb.cspline1d(np.zeros(0))
    with pytest.raises(ValueError):
        bs.cspline1d(np.zeros(0), device="cpu")


def test_folded_band_stays_in_the_band():
    """The mirror fold of a tap at most p away lands at most p away, at
    every length: the band check (tpufft's ValueError) cannot fire for the
    taps these filters build."""
    for taps in (bs._spline_taps("cubic", 2.5), _order2_taps(0.5, 0.7)):
        for n in range(1, 12):
            A, p = bs._folded_band(taps, n, np.float64)
            assert p == 2 and A.shape == (n, 5)
            np.testing.assert_allclose(A.sum(1), sum(taps.values()))


@pytest.mark.parametrize("taps", ["cubic", "smoothing", "slow_pole"])
def test_long_factors_match_the_full_factorization(taps):
    """The head rows read from a short system are the long system's own
    factor rows; its interior rows and tail rows are within the steady
    tolerance of the steady row and the short system's tail. A pole near
    the unit circle never settles exactly (the rows jitter in their last
    bits), so the steady rows are found to a tolerance."""
    taps = {"cubic": bs._spline_taps("cubic", 0.0),
            "smoothing": bs._spline_taps("cubic", 2.5),
            "slow_pole": _order2_taps(0.97, 0.1)}[taps]
    items = tuple(sorted(taps.items()))
    N = 5000
    f = bs._factors(items, N, False)
    A, L, p = bs._band_lu.__wrapped__(items, N, False)
    H, T = f.lower.head.shape[0], f.lower.tail.shape[0]
    assert H + T < 1500
    np.testing.assert_array_equal(f.diag[0], A[:H, p])
    rtol = bs._STEADY_RTOL
    np.testing.assert_allclose(f.diag[2], A[N - T:, p], rtol=rtol)
    np.testing.assert_allclose(L[H:N - T], np.broadcast_to(
        f.lower.steady, (N - H - T, p)), rtol=rtol)
    np.testing.assert_allclose(A[H:N - T, p], f.diag[1], rtol=rtol)

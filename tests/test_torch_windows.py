"""The port's windows against tpufft.windows and scipy.signal.windows.

Both packages build windows on the host in float64 numpy; the port keeps
its own copy of the module, so the two must agree bit for bit (dpss to
1e-12: an eigensolver's output), and both with scipy to 1e-12."""

import numpy as np
import pytest
import scipy.signal.windows as sw

from tpufft import windows as tp_windows

from tpufft_torch import windows
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

# every function of the module, with the parameters it needs
WINDOWS = [
    ("boxcar", ()), ("triang", ()), ("bartlett", ()), ("hann", ()),
    ("hamming", ()), ("blackman", ()), ("blackmanharris", ()),
    ("nuttall", ()), ("flattop", ()), ("barthann", ()), ("cosine", ()),
    ("bohman", ()), ("parzen", ()), ("lanczos", ()), ("kaiser", (8.6,)),
    ("gaussian", (7.0,)), ("general_gaussian", (1.5, 7.0)),
    ("general_hamming", (0.6,)), ("general_cosine", ([0.5, 0.3, 0.2],)),
    ("tukey", (0.3,)), ("exponential", (None, 3.0)), ("chebwin", (80,)),
    ("taylor", (4, 35)), ("kaiser_bessel_derived", (5.0,)),
    ("dpss", (2.5,)),
]


def test_module_exports_every_window():
    assert sorted(windows.__all__) == sorted(tp_windows.__all__)
    assert len(windows.__all__) == 26
    assert sorted([n for n, _ in WINDOWS] + ["get_window"]) == sorted(
        windows.__all__)


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "periodic"])
@pytest.mark.parametrize("M", [1, 16, 51, 256])
@pytest.mark.parametrize("name,args", WINDOWS, ids=[n for n, _ in WINDOWS])
def test_window_matches_tpufft_and_scipy(name, args, M, sym):
    if name == "kaiser_bessel_derived" and (not sym or M % 2):
        with pytest.raises(ValueError):
            getattr(windows, name)(M, *args, sym=sym)
        return
    if name == "exponential" and sym:
        args = ()
    got = getattr(windows, name)(M, *args, sym=sym)
    ref = getattr(tp_windows, name)(M, *args, sym=sym)
    assert got.dtype == np.float64 and got.shape == (M,)
    if name == "dpss":
        np.testing.assert_allclose(got, ref, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, getattr(sw, name)(M, *args, sym=sym),
                               atol=1e-12)


@pytest.mark.parametrize("spec", ["hann", "hamming", ("kaiser", 4.0), 6.5,
                                  ("tukey", 0.25), ("general gaussian", 1, 3),
                                  ("exponential", None, 2.0), "cosine",
                                  ("dpss", 3.0), ("chebwin", 50),
                                  "boxcar"])
@pytest.mark.parametrize("fftbins", [True, False])
def test_get_window_matches_tpufft(spec, fftbins):
    if fftbins is False and spec == ("exponential", None, 2.0):
        spec = "exponential"
    got = windows.get_window(spec, 64, fftbins=fftbins)
    np.testing.assert_allclose(
        got, tp_windows.get_window(spec, 64, fftbins=fftbins), atol=1e-12)


def test_get_window_errors_match_tpufft():
    for spec in [(), (3,), ("hann", 2), ("kaiser",), [1, 2]]:
        with pytest.raises(ValueError):
            tp_windows.get_window(spec, 8)
        with pytest.raises(ValueError):
            windows.get_window(spec, 8)

"""The port's host helpers against tpufft's: ``fftfreq``, ``rfftfreq``,
``fftshift``, ``ifftshift``, ``planner.digit_reverse`` and
``PrecisionDowngradeWarning``, on the same inputs.

The frequency grids are exact up to float rounding (1e-12 in float64,
1e-7 in float32); the shifts and the digit reversal are permutations and
must agree exactly.
"""

import warnings

import numpy as np
import pytest
import torch

import tpufft
from tpufft.planner import digit_reverse as tp_digit_reverse

import tpufft_torch
from tpufft_torch import SplitComplex
from _tpufft_caches import cold_tpufft_caches  # noqa: F401


@pytest.mark.parametrize("n", [1, 2, 7, 8, 93, 128])
@pytest.mark.parametrize("d", [1.0, 0.5, 2.0])
def test_fftfreq_matches_tpufft(n, d):
    for dtype, tol in ((np.float64, 1e-12), (None, 1e-7)):
        ref = np.asarray(tpufft.fftfreq(n, d=d, dtype=dtype))
        got = tpufft_torch.fftfreq(n, d=d, dtype=dtype, device="cpu")
        assert got.dtype == (torch.float64 if dtype else torch.float32)
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
        ref = np.asarray(tpufft.rfftfreq(n, d=d, dtype=dtype))
        got = tpufft_torch.rfftfreq(n, d=d, dtype=dtype, device="cpu")
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("axes", [None, 0, 1, (0, 2), (-1,)])
def test_shifts_match_tpufft(axes):
    x = np.arange(5 * 6 * 7).reshape(5, 6, 7).astype(np.float32)
    for fn in ("fftshift", "ifftshift"):
        ref = np.asarray(getattr(tpufft, fn)(x, axes=axes))
        got_np = getattr(tpufft_torch, fn)(x, axes=axes)
        assert isinstance(got_np, np.ndarray)
        np.testing.assert_array_equal(got_np, ref)
        got_t = getattr(tpufft_torch, fn)(torch.from_numpy(x), axes=axes)
        assert isinstance(got_t, torch.Tensor)
        np.testing.assert_array_equal(got_t.numpy(), ref)
        sc = getattr(tpufft_torch, fn)(
            SplitComplex(torch.from_numpy(x), torch.from_numpy(-x)),
            axes=axes)
        np.testing.assert_array_equal(sc.re.numpy(), ref)
        np.testing.assert_array_equal(sc.im.numpy(), -ref)


def test_shift_round_trip():
    x = torch.arange(9 * 4).reshape(9, 4)
    assert torch.equal(tpufft_torch.ifftshift(tpufft_torch.fftshift(x)), x)


@pytest.mark.parametrize("bases", [(2, 2, 2), (2, 3, 4), (5, 3), (4, 8, 2),
                                   (7,)])
def test_digit_reverse_matches_tpufft(bases):
    n = int(np.prod(bases))
    got = [tpufft_torch.digit_reverse(i, bases) for i in range(n)]
    assert got == [tp_digit_reverse(i, bases) for i in range(n)]
    assert sorted(got) == list(range(n))
    assert [tpufft_torch.digit_reverse(g, bases[::-1]) for g in got] == \
        list(range(n))


def test_precision_downgrade_warning_is_never_needed():
    """Both packages export the warning class; with float64 available (JAX
    x64 on here, PyTorch always) neither warns, and c128 stays c128."""
    assert issubclass(tpufft_torch.PrecisionDowngradeWarning, UserWarning)
    assert tpufft_torch.PrecisionDowngradeWarning.__name__ == \
        tpufft.PrecisionDowngradeWarning.__name__
    x = (np.arange(16) + 1j * np.arange(16)[::-1]).astype(np.complex128)
    with warnings.catch_warnings():
        warnings.simplefilter("error", tpufft_torch.PrecisionDowngradeWarning)
        warnings.simplefilter("error", tpufft.PrecisionDowngradeWarning)
        got = tpufft_torch.fft(x, device="cpu")
        ref = np.asarray(tpufft.fft(x))
    assert got.dtype == np.complex128
    assert np.max(np.abs(got - ref)) < 1e-10

"""The port's Fourier-domain image filters against tpufft.ndimage and
scipy.ndimage, on every input form: numpy (host float64, to 1e-12),
tensors (float64 to 1e-12, complex64 to 1e-5) and ``SplitComplex``
float32 planes (1e-5), and an end-to-end pipeline through the port's own
transforms on the CPU."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp
import tpufft
from tpufft import ndimage as tnd
from tpufft.core import SplitComplex as TPSplit

import tpufft_torch
from tpufft_torch import SplitComplex, ndimage
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

RNG = np.random.default_rng(7)
CPU = "cpu"
EXACT = dict(rtol=1e-12, atol=1e-12)

CASES = [
    ("gaussian", "fourier_gaussian", 2.0),
    ("gaussian_seq", "fourier_gaussian", (1.0, 3.0)),
    ("uniform", "fourier_uniform", 3),
    ("uniform_seq", "fourier_uniform", (2, 5)),
    ("ellipsoid", "fourier_ellipsoid", 3),
    ("shift", "fourier_shift", 1.5),
    ("shift_seq", "fourier_shift", (0.5, -2.25)),
]
IDS = [c[0] for c in CASES]


def _cplx(shape):
    return RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)


def test_module_exported():
    assert tpufft_torch.ndimage is ndimage
    assert "ndimage" in tpufft.__all__ and "ndimage" in tpufft_torch.__all__
    assert sorted(ndimage.__all__) == sorted(tnd.__all__)


@pytest.mark.parametrize("name,fn,param", CASES, ids=IDS)
def test_numpy_complex(name, fn, param):
    x = _cplx((9, 12))
    got = getattr(ndimage, fn)(x, param)
    np.testing.assert_allclose(got, getattr(tnd, fn)(x, param), **EXACT)
    np.testing.assert_allclose(got, getattr(ndi, fn)(x, param), **EXACT)


@pytest.mark.parametrize("name,fn,param", CASES, ids=IDS)
def test_numpy_real(name, fn, param):
    x = RNG.standard_normal((8, 10))
    got, want = getattr(ndimage, fn)(x, param), getattr(ndi, fn)(x, param)
    assert got.dtype == want.dtype == getattr(tnd, fn)(x, param).dtype
    np.testing.assert_allclose(got, want, **EXACT)


@pytest.mark.parametrize("name,fn,param", CASES, ids=IDS)
def test_split_complex(name, fn, param):
    x = _cplx((9, 12))
    sx = SplitComplex(torch.from_numpy(x.real.astype(np.float32)),
                      torch.from_numpy(x.imag.astype(np.float32)))
    got = getattr(ndimage, fn)(sx, param)
    assert isinstance(got, SplitComplex) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), getattr(ndi, fn)(x, param),
                               rtol=1e-5, atol=1e-5)
    tp_out = getattr(tnd, fn)(TPSplit(jnp.asarray(sx.re.numpy()),
                                      jnp.asarray(sx.im.numpy())), param)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(tp_out.re) + 1j * np.asarray(tp_out.im),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,fn,param", CASES, ids=IDS)
@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 1e-5)],
                         ids=["c128", "c64"])
def test_tensor(name, fn, param, dtype, tol):
    x = _cplx((9, 12))
    got = getattr(ndimage, fn)(torch.from_numpy(x).to(dtype), param)
    assert isinstance(got, torch.Tensor) and got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), getattr(ndi, fn)(x, param),
                               rtol=tol, atol=tol)


def test_rfft_axis_convention():
    x = RNG.standard_normal((8, 10))
    X = np.fft.rfftn(x)
    for fn, p in [("fourier_gaussian", 1.3), ("fourier_uniform", 4),
                  ("fourier_shift", 2.5), ("fourier_ellipsoid", 3)]:
        got = getattr(ndimage, fn)(X, p, n=10, axis=-1)
        np.testing.assert_allclose(got, getattr(ndi, fn)(X, p, n=10, axis=-1),
                                   **EXACT)
        np.testing.assert_allclose(
            getattr(ndimage, fn)(torch.from_numpy(X), p, n=10,
                                 axis=-1).numpy(), got, **EXACT)


def test_rank3_ellipsoid_and_rank_limit():
    x = _cplx((6, 6, 6))
    got = ndimage.fourier_ellipsoid(x, 2.5)
    np.testing.assert_allclose(got, ndi.fourier_ellipsoid(x, 2.5), **EXACT)
    np.testing.assert_allclose(got, tnd.fourier_ellipsoid(x, 2.5), **EXACT)
    with pytest.raises(NotImplementedError):
        ndimage.fourier_ellipsoid(np.zeros((2, 2, 2, 2), complex), 1.0)


def test_sequence_length_mismatch():
    with pytest.raises(RuntimeError):
        ndimage.fourier_gaussian(np.zeros((4, 4), complex), (1.0, 2.0, 3.0))


def test_real_tensor_shift_gives_complex():
    x = RNG.standard_normal((6, 8)).astype(np.float32)
    got = ndimage.fourier_shift(torch.from_numpy(x), 1.0)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(
        got.numpy(), ndi.fourier_shift(x.astype(np.float64), 1.0),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(tnd.fourier_shift(jnp.asarray(x), 1.0)),
        rtol=1e-6, atol=1e-6)


def test_end_to_end_gaussian_blur_pipeline():
    """rfftn -> fourier_gaussian -> irfftn through the port's transforms on
    the CPU matches the all-scipy pipeline."""
    x = RNG.standard_normal((16, 24))
    X = tpufft_torch.rfftn(x, device=CPU)
    y = tpufft_torch.irfftn(ndimage.fourier_gaussian(X, 2.0, n=24),
                            s=x.shape, device=CPU)
    want = np.fft.irfftn(ndi.fourier_gaussian(np.fft.rfftn(x), 2.0, n=24),
                         s=x.shape, axes=(0, 1))
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-9, atol=1e-9)
    xt = torch.from_numpy(x.astype(np.float32))
    yt = tpufft_torch.irfftn(ndimage.fourier_gaussian(
        tpufft_torch.rfftn(xt), 2.0, n=24), s=x.shape)
    np.testing.assert_allclose(yt.numpy(), want, rtol=1e-5, atol=1e-5)


def test_end_to_end_shift_matches_roll():
    """An integer fourier_shift is exactly np.roll."""
    x = RNG.standard_normal((12, 15))
    y = tpufft_torch.ifftn(ndimage.fourier_shift(
        tpufft_torch.fftn(x, device=CPU), (3, -2)), device=CPU)
    np.testing.assert_allclose(np.asarray(y).real,
                               np.roll(x, (3, -2), axis=(0, 1)),
                               rtol=1e-9, atol=1e-9)


def test_output_param_numpy():
    x = _cplx((5, 7))
    out = np.empty_like(x)
    got = ndimage.fourier_uniform(x, 3, output=out)
    assert got is out
    np.testing.assert_allclose(out, ndi.fourier_uniform(x, 3), **EXACT)

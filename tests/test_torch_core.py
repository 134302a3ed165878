"""The torch-op Stockham against tpufft.core on the same planes.

c64: normalized error 1e-5 (both compute in f32 with different summation
order). c128: 1e-10 (both compute in float64; conftest enables x64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import core as tp_core

from tpufft_torch import core
from tpufft_torch.planner import default_bases
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

CASES = [(16, (16,)), (93, None), (128, (8, 16)), (360, None),
         (1024, None), (1, (1,))]


def _err(got, ref):
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-10)],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,bases", CASES)
def test_stockham_matches_tpufft(n, bases, inverse, dtype, tol, rng):
    bases = bases or default_bases(n)
    re = rng.standard_normal((6, n)).astype(dtype)
    im = rng.standard_normal((6, n)).astype(dtype)
    scale = 1.0 / n if inverse else 1.0
    tr, ti = tp_core.stockham_split_last_axis(
        jnp.asarray(re), jnp.asarray(im), bases, inverse=inverse, scale=scale)
    pr, pi = core.stockham_split_last_axis(
        torch.from_numpy(re), torch.from_numpy(im), bases, inverse=inverse,
        scale=scale)
    assert pr.dtype == torch.from_numpy(re).dtype
    ref = np.asarray(tr) + 1j * np.asarray(ti)
    got = pr.numpy() + 1j * pi.numpy()
    assert _err(got, ref) < tol


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-10)],
                         ids=["c64", "c128"])
def test_real_input_along_axis(dtype, tol, rng):
    x = rng.standard_normal((12, 5, 7)).astype(dtype)
    tr, ti = tp_core.fft_along_axis(jnp.asarray(x), None, 0,
                                    default_bases(12))
    pr, pi = core.fft_along_axis(torch.from_numpy(x), None, 0,
                                 default_bases(12))
    ref = np.asarray(tr) + 1j * np.asarray(ti)
    assert _err(pr.numpy() + 1j * pi.numpy(), ref) < tol
    assert _err(pr.numpy() + 1j * pi.numpy(), np.fft.fft(x, axis=0)) < tol


def test_split_complex_helpers():
    sc = core.SplitComplex(torch.ones(2, 3), torch.full((2, 3), 2.0))
    assert sc.shape == (2, 3) and sc.dtype == torch.float32
    assert np.array_equal(sc.numpy(), np.full((2, 3), 1 + 2j, np.complex64))
    assert torch.equal(sc.conj().im, -sc.im)
    assert core.real_dtype_for(torch.complex128) == torch.float64
    assert core.real_dtype_for("complex64") == torch.float32
    assert core.real_dtype_for(np.int64) == torch.float32
    assert core.dtype_name(torch.complex64) == "complex64"

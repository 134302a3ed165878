"""The strided-axis kernel's plain versions against tpufft's ``_build_inner``
(K2) and ``_build_inner_nd`` (K3, with and without ``with_tw``).

tpufft's Pallas kernels run in interpret mode on the CPU with
``precision="highest"``; the port runs ``inner_fft.fft_inner_reference`` /
``fft_inner_nd_reference`` (what ``fft_inner`` / ``fft_inner_nd`` run for
CPU tensors), on the same planes made from a numpy seed. Tolerances,
normalized by the spectrum's magnitude:

* 1e-5 for f32 storage: both sides compute in f32 with the same
  factorization and tables, and differ only in summation order;
* 8e-3 for bf16 storage, the ``profile="fast"`` bound in README.md: both
  sides round their f32 result to bf16 at the store.

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import inner_fft

NS = [8, 93, 128, 256, 1024]
TOL = {"f32": 1e-5, "bf16": 8e-3}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _np(zr, zi):
    if isinstance(zr, torch.Tensor):
        return zr.float().numpy() + 1j * zi.float().numpy()
    return (np.asarray(zr.astype(jnp.float32))
            + 1j * np.asarray(zi.astype(jnp.float32)))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_inner_matches_build_inner(n, inverse, unit_scale, storage):
    """K2: the middle axis of a rank-3 (pre, n, L) array with L >= 32, the
    layout on which tpufft's ``fft_axis_pallas`` runs ``_build_inner``."""
    re, im = _planes((3, n, 40), seed=n)
    scale = 1.0 if unit_scale else 1.0 / n
    jdt, tdt = DTYPES[storage]
    ref = tp_mxu.fft_axis_pallas(
        jnp.asarray(re, jdt), jnp.asarray(im, jdt), 1, (), inverse=inverse,
        scale=scale, config=TP_CFG)
    got = inner_fft.fft_inner(torch.from_numpy(re).to(tdt),
                              torch.from_numpy(im).to(tdt),
                              inverse=inverse, scale=scale)
    assert got[0].dtype == tdt and ref[0].dtype == jdt
    assert _err(_np(*got), _np(*ref)) < TOL[storage]


def _two_pass_like_twiddle(n, M):
    """An (n, M) unit-modulus twiddle as the two-pass split makes it."""
    k = np.outer(np.arange(n), np.arange(M)).astype(np.float64)
    th = -2.0 * np.pi * k / (n * M)
    return np.cos(th), np.sin(th)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("with_tw", [False, True], ids=["plain", "with_tw"])
@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_inner_nd_matches_build_inner_nd(n, inverse, unit_scale, with_tw,
                                         storage):
    """K3 on (pre*n, M, L) with a ragged M (5) and L (9)."""
    pre, M, L = 2, 5, 9
    re, im = _planes((pre * n, M, L), seed=n + 1)
    scale = 1.0 if unit_scale else 1.0 / n
    jdt, tdt = DTYPES[storage]
    run = tp_mxu._plan_inner_nd(n, inverse, scale, M, L, TP_CFG, True,
                                with_tw=with_tw, storage=storage)
    twc, tws = _two_pass_like_twiddle(n, M)
    if with_tw:
        ref = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt),
                  jnp.asarray(twc, jnp.float32), jnp.asarray(tws, jnp.float32))
        twiddle = torch.from_numpy(
            np.stack([twc, tws], -1).astype(np.float32))
    else:
        ref = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt))
        twiddle = None
    got = inner_fft.fft_inner_nd(torch.from_numpy(re).to(tdt),
                                 torch.from_numpy(im).to(tdt), n=n,
                                 inverse=inverse, scale=scale,
                                 twiddle=twiddle)
    assert got[0].dtype == tdt and got[0].shape == (pre * n, M, L)
    assert _err(_np(*got), _np(*ref)) < TOL[storage]


def test_wrappers_cpu_run_plain_versions():
    re, im = _planes((2, 93, 33), seed=0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    inner_fft.reset_counts()
    got = inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0)
    ref = inner_fft.fft_inner_reference(xr, xi, inverse=False, scale=1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = inner_fft.fft_inner_nd(xr.reshape(186, 3, 11),
                                 xi.reshape(186, 3, 11), n=93,
                                 inverse=True, scale=0.5)
    ref = inner_fft.fft_inner_nd_reference(xr.reshape(186, 3, 11),
                                           xi.reshape(186, 3, 11), n=93,
                                           inverse=True, scale=0.5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert inner_fft.launches == {"inner": 0, "inner_nd": 0}
    assert inner_fft.reference_cuda_calls == 0


@pytest.mark.parametrize("call", [
    lambda x: inner_fft.fft_inner(x, x, inverse=False, scale=1.0),
    lambda x: inner_fft.fft_inner_nd(x, x, n=4, inverse=False, scale=1.0),
], ids=["inner", "inner_nd"])
def test_wrappers_refuse_non_cuda_devices(call):
    """A tensor that is not on the CPU launches the kernel or raises; it
    never runs the plain version."""
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.empty(2, 4, 8, device="meta"))

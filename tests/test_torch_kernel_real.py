"""The real-transform kernels' plain versions (K7 rfft, K8 irfft) against
tpufft's ``_build_minor_r2c`` and ``_build_minor_c2r``.

tpufft's Pallas kernels run in interpret mode on the CPU (as
``tests/test_kernels.py`` runs them) with ``precision="highest"``; the port
runs ``real_fft.rfft_minor_reference`` / ``irfft_minor_reference`` (what
the wrappers run for CPU tensors) on the same planes made from a numpy
seed. tpufft's kernels stop at n = 1024; above it the plain versions are
held against ``np.fft``. Tolerances, normalized by the magnitude of the
result:

* 1e-5 for f32 storage: both sides compute in f32 and differ in summation
  order (a dense matmul against the port's FFT);
* 8e-3 for bf16 storage, the ``profile="fast"`` bound in README.md: both
  round their f32 result to bf16 at the store;
* 1e-5 against ``np.fft`` in float64 above 1024.

The CUDA kernels themselves need the card: ``test_torch_cuda.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft import api as tp_api
from tpufft.kernels import mxu_fft as tp_mxu
from tpufft.planner import factorize as tp_factorize

from tpufft_torch import api
from tpufft_torch.kernels import real_fft

NS = [2, 3, 8, 93, 127, 128, 131, 1024]
TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")
BATCH = 5


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _dtypes(storage):
    return ((jnp.float32, torch.float32) if storage == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _rfft_both(x, scale, storage):
    jdt, tdt = _dtypes(storage)
    n = x.shape[1]
    run = tp_mxu._build_minor_r2c(n, float(scale),
                                  tp_mxu.choose_lane_block(n, TP_CFG),
                                  "highest", True, storage)
    zr, zi = run(jnp.asarray(x, jdt))
    ref = (np.asarray(zr.astype(jnp.float32))
           + 1j * np.asarray(zi.astype(jnp.float32)))
    gr, gi = real_fft.rfft_minor_reference(torch.from_numpy(x).to(tdt),
                                           scale=scale)
    assert gr.dtype == gi.dtype == tdt
    return gr.float().numpy() + 1j * gi.float().numpy(), ref


def _irfft_both(xr, xi, n, scale, storage):
    jdt, tdt = _dtypes(storage)
    run = tp_mxu._build_minor_c2r(n, float(scale),
                                  tp_mxu.choose_lane_block(n, TP_CFG),
                                  "highest", True, storage)
    ref = np.asarray(run(jnp.asarray(xr, jdt),
                         jnp.asarray(xi, jdt)).astype(jnp.float32))
    got = real_fft.irfft_minor_reference(
        torch.from_numpy(xr).to(tdt), torch.from_numpy(xi).to(tdt), n=n,
        scale=scale)
    assert got.dtype == tdt and got.shape == (xr.shape[0], n)
    return got.float().numpy(), ref


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", NS)
def test_rfft_reference_matches_build_minor_r2c(n, unit_scale):
    scale = 1.0 if unit_scale else 1.0 / n
    got, ref = _rfft_both(_real((BATCH, n), n), scale, "f32")
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", NS)
def test_irfft_reference_matches_build_minor_c2r(n, unit_scale):
    """Random planes: the imaginary parts at DC and (even n) Nyquist are
    not zero, and both sides must ignore them."""
    scale = 1.0 if unit_scale else 1.0 / n
    m1 = n // 2 + 1
    got, ref = _irfft_both(_real((BATCH, m1), n), _real((BATCH, m1), n + 1),
                           n, scale, "f32")
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("n", NS)
def test_real_references_bf16_storage(n):
    got, ref = _rfft_both(_real((BATCH, n), n), 1.0, "bf16")
    assert _err(got, ref) < 8e-3
    m1 = n // 2 + 1
    got, ref = _irfft_both(_real((BATCH, m1), n), _real((BATCH, m1), 2 * n),
                           n, 1.0 / n, "bf16")
    assert _err(got, ref) < 8e-3


@pytest.mark.parametrize("n", [2048, 4095, 16383, 32768])
def test_real_references_above_1024_match_numpy(n):
    x = _real((2, n), n)
    zr, zi = real_fft.rfft_minor_reference(torch.from_numpy(x), scale=0.5)
    spec = np.fft.rfft(x.astype(np.float64)) * 0.5
    assert _err(zr.numpy() + 1j * zi.numpy(), spec) < 1e-5
    y = real_fft.irfft_minor_reference(zr, zi, n=n, scale=2.0 / n)
    assert _err(y.numpy(), x) < 1e-5


def test_half_twiddle_matches_tpufft():
    """The host tables of the packed paths: api's f64 planes are tpufft's
    ``_half_twiddle``; the kernels' f32 table is the same values with
    exact quarter points."""
    for m, n in ((4, 8), (512, 1024), (46, 93)):
        for ours, theirs in zip(api._half_twiddle(m, n),
                                tp_api._half_twiddle(m, n)):
            np.testing.assert_array_equal(ours, theirs)
    for n in (2, 8, 1024, 32768):
        table = real_fft._device_half_twiddle(n, torch.device("cpu"))
        wr, wi = tp_api._half_twiddle(n // 2, n)
        assert table.shape == (n // 2 + 1, 2)
        assert np.max(np.abs(table[:, 0].numpy() - wr)) < 1e-7
        assert np.max(np.abs(table[:, 1].numpy() - wi)) < 1e-7


def test_envelope():
    """Even n with n/2 inside K1's envelope (up to 32768), odd n inside
    K1's; every n <= 1024 that tpufft's K7/K8 take except the lengths with
    a prime factor above 127."""
    for n in (2, 3, 8, 93, 127, 128, 254, 1024, 16383, 32768):
        assert real_fft.supported(n, torch.float32), n
        assert real_fft.supported(n, torch.bfloat16), n
    for n in (1, 131, 262, 1021, 32769, 65536):
        assert not real_fft.supported(n, torch.float32), n
    assert not real_fft.supported(128, torch.float64)
    for n in range(2, 1025):
        stage = n // 2 if n % 2 == 0 else n
        big = stage > 1 and max(tp_factorize(stage)) > 127
        assert real_fft.supported(n, torch.float32) == (not big), n


def test_wrappers_cpu_run_plain_versions():
    x = torch.from_numpy(_real((3, 96), 0))
    real_fft.reset_counts()
    got = real_fft.rfft_minor(x, scale=0.5)
    ref = real_fft.rfft_minor_reference(x, scale=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    back = real_fft.irfft_minor(*got, n=96, scale=2.0 / 96)
    assert torch.equal(back, real_fft.irfft_minor_reference(*got, n=96,
                                                            scale=2.0 / 96))
    assert _err(back.numpy(), x.numpy()) < 1e-5
    assert real_fft.launches == {"r2c": 0, "c2r": 0}
    assert real_fft.reference_cuda_calls == 0


def test_wrappers_refuse_non_cuda_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        real_fft.rfft_minor(x, scale=1.0)
    h = torch.empty(2, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        real_fft.irfft_minor(h, h, n=8, scale=1.0)

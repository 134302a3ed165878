"""The minor-axis kernel's plain version against tpufft's ``_build_minor``.

tpufft's Pallas kernel runs in interpret mode on the CPU (as
``tests/test_kernels.py`` runs it), the port's plain version in torch ops,
on the same planes made from a numpy seed. Tolerances (normalized by the
spectrum's magnitude):

* 1e-5 against ``precision="highest"``: both sides compute in f32 with the
  same factorization and tables, and differ only in summation order;
* 1e-3 against the default bf16x3 (``assert_spectrum_close``'s c64 bound):
  tpufft emulates f32 with three bf16 passes;
* 8e-3 for bf16 storage, the ``profile="fast"`` error bound in README.md:
  both sides round their f32 result to bf16 at the store.

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import minor_fft
from tpufft_torch.planner import factorize, kernel_factors

BATCH = 130  # not a multiple of tpufft's 128-row lane block
NS = [8, 93, 128, 256, 960, 1024, 1792]


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _planes(n, rng, batch=BATCH):
    re = rng.standard_normal((batch, n)).astype(np.float32)
    im = rng.standard_normal((batch, n)).astype(np.float32)
    return re, im


def _tpufft(re, im, inverse, scale, precision, storage="f32"):
    n = re.shape[1]
    dt = jnp.float32 if storage == "f32" else jnp.bfloat16
    run = tp_mxu._build_minor(n, inverse, float(scale), 128, precision, True,
                              storage)
    zr, zi = run(jnp.asarray(re, dt), jnp.asarray(im, dt))
    return (np.asarray(zr.astype(jnp.float32))
            + 1j * np.asarray(zi.astype(jnp.float32)))


def _port(re, im, inverse, scale, dtype=torch.float32):
    zr, zi = minor_fft.fft_minor_reference(
        torch.from_numpy(re).to(dtype), torch.from_numpy(im).to(dtype),
        inverse=inverse, scale=scale)
    assert zr.dtype == zi.dtype == dtype
    return zr.float().numpy() + 1j * zi.float().numpy()


@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_reference_matches_build_minor_highest(n, inverse, unit_scale, rng):
    re, im = _planes(n, rng)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = _tpufft(re, im, inverse, scale, "highest")
    assert _err(_port(re, im, inverse, scale), ref) < 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_reference_matches_build_minor_bf16x3(n, inverse, rng):
    re, im = _planes(n, rng)
    scale = 1.0 / n if inverse else 1.0
    ref = _tpufft(re, im, inverse, scale, "bf16x3")
    assert _err(_port(re, im, inverse, scale), ref) < 1e-3


@pytest.mark.parametrize("n", NS)
def test_reference_matches_build_minor_bf16_storage(n, rng):
    re, im = _planes(n, rng)
    ref = _tpufft(re, im, False, 1.0, "highest", storage="bf16")
    got = _port(re, im, False, 1.0, dtype=torch.bfloat16)
    assert _err(got, ref) < 8e-3


@pytest.mark.parametrize("n", [1, 127 * 129])
def test_reference_outside_tpufft_factorization(n, rng):
    """Lengths the CUDA kernel takes but tpufft's single pass does not:
    the plain version runs the torch-op Stockham in f32."""
    assert kernel_factors(n) is None and minor_fft.supported(n, torch.float32)
    re, im = _planes(n, rng, batch=3)
    got = _port(re, im, False, 1.0)
    assert _err(got, np.fft.fft(re + 1j * im.astype(np.float64))) < 1e-5


def test_envelope_covers_tpufft_single_pass():
    """Every length tpufft's minor kernel takes is inside the CUDA kernel's
    envelope, and the kernel's radices multiply to n."""
    for n in range(1, minor_fft.MAX_N + 1):
        if kernel_factors(n) is not None:
            assert minor_fft.supported(n, torch.float32), n
        if minor_fft.supported(n, torch.bfloat16):
            rad = minor_fft.radices(n)
            assert int(np.prod(rad, dtype=np.int64)) == n, n
            assert all(2 <= r <= minor_fft.MAX_PRIME for r in rad), n
            # the C entry point takes 2, 4, 8 or an odd radix
            assert all(r in (2, 4, 8) or r % 2 for r in rad), n
    assert not minor_fft.supported(131, torch.float32)      # prime > 127
    assert not minor_fft.supported(minor_fft.MAX_N + 1, torch.float32)
    assert not minor_fft.supported(1024, torch.float64)
    assert not minor_fft.supported(0, torch.float32)
    assert minor_fft.radices(1024) == (8, 8, 8, 2)
    assert minor_fft.radices(93) == (3, 31)
    assert factorize(127 * 129) == [3, 43, 127]
    assert minor_fft.supported(127 * 129, torch.float32)


def test_wrapper_cpu_runs_plain_version(rng):
    re, im = _planes(93, rng, batch=4)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    minor_fft.reset_counts()
    got = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
    ref = minor_fft.fft_minor_reference(xr, xi, inverse=False, scale=1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert minor_fft.launches == 0
    assert minor_fft.reference_cuda_calls == 0


@pytest.mark.parametrize("xr,xi,match", [
    (torch.empty(4, 8, device="meta"), torch.empty(4, 8, device="meta"),
     "CUDA device"),
    (torch.empty(4, 8), torch.empty(4, 8, device="meta"), "CUDA device"),
])
def test_wrapper_refuses_non_cuda_devices(xr, xi, match):
    """A tensor that is not on the CPU launches the kernel or raises; it
    never runs the plain version."""
    with pytest.raises(ValueError, match=match):
        minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)

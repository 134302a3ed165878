"""The pair kernel's plain version against tpufft's ``_build_2d`` (K4),
reached through ``mxu_fft.fft_pair_pallas``.

tpufft's Pallas kernel runs in interpret mode on the CPU with
``precision="highest"``; the port runs ``pair_fft.fft_pair_reference``
(what ``fft_pair`` runs for CPU tensors), on the same planes made from a
numpy seed. Tolerances, normalized by the spectrum's magnitude: 1e-5 for
f32 storage (both sides compute in f32 and differ in summation order),
8e-3 for bf16 storage (both round to bf16 at the store).

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import pair_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

PAIRS = [(8, 93), (64, 64), (64, 128), (16, 48)]
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


def _run_both(re, im, inverse, scale, jdt, tdt):
    ref = tp_mxu.fft_pair_pallas(jnp.asarray(re, jdt), jnp.asarray(im, jdt),
                                 inverse=inverse, scale=scale,
                                 config=TP_CFG)
    got = pair_fft.fft_pair(torch.from_numpy(re).to(tdt),
                            torch.from_numpy(im).to(tdt), inverse=inverse,
                            scale=scale)
    assert got[0].dtype == tdt and got[0].shape == re.shape
    ref = (np.asarray(ref[0].astype(jnp.float32))
           + 1j * np.asarray(ref[1].astype(jnp.float32)))
    return got[0].float().numpy() + 1j * got[1].float().numpy(), ref


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("pre", [1, 3])
@pytest.mark.parametrize("n1,n2", PAIRS)
def test_pair_matches_build_2d(n1, n2, pre, inverse):
    re, im = _planes((pre, n1, n2), seed=n1 * n2 + pre)
    scale = 1.0 / (n1 * n2) if inverse else 1.0
    got, ref = _run_both(re, im, inverse, scale, jnp.float32, torch.float32)
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("n1,n2,pre", [(16, 64, 5), (32, 64, 7),
                                       (16, 128, 3), (32, 32, 11)])
def test_pair_column_lengths_of_16_and_32_match_build_2d(n1, n2, pre):
    """n1 = 16 and 32 (column lines whose tile stride is a multiple of 16
    elements, where the card's column pass must not collide on banks) and
    a pre that leaves the last block of packed slices ragged."""
    re, im = _planes((pre, n1, n2), seed=n1 + n2 + pre)
    for inverse in (False, True):
        got, ref = _run_both(re, im, inverse, 1.0 / n1 if inverse else 1.0,
                             jnp.float32, torch.float32)
        assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("n1,n2", PAIRS)
def test_pair_matches_build_2d_bf16_storage(n1, n2):
    re, im = _planes((3, n1, n2), seed=n1 + n2)
    got, ref = _run_both(re, im, False, 1.0, jnp.bfloat16, torch.bfloat16)
    assert _err(got, ref) < 8e-3


def test_envelope():
    """Both lengths inside the minor-axis kernel's radix envelope, each at
    least 2, and one f32 complex slice in 16384 elements."""
    for n1, n2 in PAIRS + [(128, 128), (160, 48), (2, 2), (127, 129)]:
        assert pair_fft.supported(n1, n2, torch.float32), (n1, n2)
        assert pair_fft.supported(n1, n2, torch.bfloat16), (n1, n2)
    assert not pair_fft.supported(128, 256, torch.float32)   # 32768 elements
    assert not pair_fft.supported(1, 64, torch.float32)
    assert not pair_fft.supported(64, 131, torch.float32)    # prime > 127
    assert not pair_fft.supported(64, 64, torch.float64)


def test_wrapper_cpu_runs_plain_version():
    re, im = _planes((2, 8, 93), seed=0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    pair_fft.reset_counts()
    got = pair_fft.fft_pair(xr, xi, inverse=True, scale=0.5)
    ref = pair_fft.fft_pair_reference(xr, xi, inverse=True, scale=0.5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert pair_fft.launches == 0 and pair_fft.reference_cuda_calls == 0
    want = np.fft.ifft2(re + 1j * im.astype(np.float64)) * (8 * 93 * 0.5)
    assert _err(got[0].numpy() + 1j * got[1].numpy(), want) < 1e-5


def test_wrapper_refuses_non_cuda_devices():
    x = torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pair_fft.fft_pair(x, x, inverse=False, scale=1.0)

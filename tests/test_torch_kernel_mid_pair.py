"""The mid-pair kernel's plain version against tpufft's ``_build_mid_pair``
(K6), reached through ``mxu_fft.fft_mid_pair_pallas``.

tpufft's Pallas kernel runs in interpret mode on the CPU with
``precision="highest"``; the port runs ``mid_pair_fft.fft_mid_pair_reference``
(what ``fft_mid_pair`` runs for CPU tensors), on the same (pre, n1, n2, L)
planes made from a numpy seed. Tolerances, normalized by the spectrum's
magnitude: 1e-5 for f32 storage (both sides compute in f32 and differ in
summation order), 8e-3 for bf16 storage (both round to bf16 at the store).

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import mid_pair_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

# tpufft's own mid-pair shape (tests/test_nd.py) and its gradient shape
SHAPES = [(3, 40, 64, 256), (2, 8, 16, 128)]
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
    ref = tp_mxu.fft_mid_pair_pallas(
        jnp.asarray(re, jdt), jnp.asarray(im, jdt), inverse=inverse,
        scale=scale, config=TP_CFG)
    got = mid_pair_fft.fft_mid_pair(torch.from_numpy(re).to(tdt),
                                    torch.from_numpy(im).to(tdt),
                                    inverse=inverse, scale=scale)
    assert got[0].dtype == tdt and got[0].shape == re.shape
    ref = (np.asarray(ref[0].astype(jnp.float32))
           + 1j * np.asarray(ref[1].astype(jnp.float32)))
    return got[0].float().numpy() + 1j * got[1].float().numpy(), ref


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mid_pair_matches_build_mid_pair(shape, inverse):
    re, im = _planes(shape, seed=sum(shape))
    n = shape[1] * shape[2]
    scale = 1.0 / n if inverse else 1.0
    got, ref = _run_both(re, im, inverse, scale, jnp.float32, torch.float32)
    assert _err(got, ref) < 1e-5
    want = (np.fft.ifftn if inverse else np.fft.fftn)(
        re + 1j * im.astype(np.float64), axes=(1, 2))
    want = want * (n * scale if inverse else 1.0)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_mid_pair_matches_build_mid_pair_bf16_storage(shape):
    re, im = _planes(shape, seed=len(shape))
    got, ref = _run_both(re, im, False, 1.0, jnp.bfloat16, torch.bfloat16)
    assert _err(got, ref) < 8e-3


def test_envelope():
    """Each length inside the minor-axis kernel's radix envelope and at
    least 2, and a cluster of 1 to 16 blocks of at most 16384 elements that
    splits n1 evenly (the smallest with at most 2048 elements a block, else
    the largest), at 8 lanes of L on the line form and 4 on the stage
    form; any L."""
    sizes = {(8, 16): (1, 8), (16, 64): (4, 8), (32, 64): (8, 8),
             (40, 64): (8, 4), (64, 128): (16, 8), (128, 128): (16, 8),
             (128, 512): (16, 4)}
    for (n1, n2), (c, lanes) in sizes.items():
        assert mid_pair_fft.cluster_size(n1, n2) == c, (n1, n2)
        assert mid_pair_fft.lanes(n1, n2) == lanes, (n1, n2)
        for L in (1, 37, 128):
            assert mid_pair_fft.supported(n1, n2, L, torch.float32)
            assert mid_pair_fft.supported(n1, n2, L, torch.bfloat16)
    assert not mid_pair_fft.supported(256, 512, 8, torch.float32)  # 2^19
    assert not mid_pair_fft.supported(27, 200, 8, torch.float32)   # 27 odd
    assert not mid_pair_fft.supported(1, 64, 8, torch.float32)
    assert not mid_pair_fft.supported(16, 131, 8, torch.float32)   # prime
    assert not mid_pair_fft.supported(16, 16, 8, torch.float64)


def test_wrapper_cpu_runs_plain_version():
    re, im = _planes((2, 6, 10, 5), seed=0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    mid_pair_fft.reset_counts()
    got = mid_pair_fft.fft_mid_pair(xr, xi, inverse=True, scale=0.5)
    ref = mid_pair_fft.fft_mid_pair_reference(xr, xi, inverse=True,
                                              scale=0.5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert mid_pair_fft.launches == 0
    assert mid_pair_fft.reference_cuda_calls == 0
    want = np.fft.ifftn(re + 1j * im.astype(np.float64), axes=(1, 2))
    assert _err(got[0].numpy() + 1j * got[1].numpy(),
                want * (6 * 10 * 0.5)) < 1e-5


def test_wrapper_refuses_non_cuda_devices():
    x = torch.empty(2, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        mid_pair_fft.fft_mid_pair(x, x, inverse=False, scale=1.0)


# every pair chip_smoke.py holds K6 to (MID_PAIRS), and MID_SHAPE's
@pytest.mark.parametrize("n1,n2,L,want", [
    (8, 16, 128, "lines"), (16, 64, 24, "lines"), (32, 64, 16, "lines"),
    (64, 128, 8, "lines"), (64, 128, 37, "lines"), (40, 64, 256, "stages"),
    (128, 128, 9, "lines"), (128, 512, 3, "stages"), (64, 128, 128, "lines"),
    (2, 2, 1, "lines"), (128, 2, 5, "lines"), (160, 160, 48, "stages"),
    (256, 512, 8, None), (16, 131, 8, None)])
def test_form_names_the_kernel_of_each_pair(n1, n2, L, want):
    """Powers of two from 2 to 128 take the line form (8 lanes of L, an
    even number of n1-columns a block); odd radices and axes above 128 the
    stage form; None outside the envelope. ``form`` mirrors ``line_mid`` in
    ``csrc/cluster_fft.cu``."""
    assert mid_pair_fft.form(n1, n2, L) == want
    if want == "lines":
        c = mid_pair_fft.cluster_size(n1, n2)
        assert mid_pair_fft.lanes(n1, n2) == mid_pair_fft.LINE_LANES
        assert n1 // c * n2 * 8 <= 16384 and n2 * 8 // c % 2 == 0


def test_line_form_tile_model():
    """A model of the line form's index math in numpy (the tile's swizzle,
    the load, the n2 lines of ``line_fft.cuh``'s ``Line<N>`` layout in
    place, the n1 columns read across the cluster in pairs): the 2-D DFT
    of a (1, 16, 128, 11) tile over a cluster of 2, with a ragged L."""
    rng = np.random.default_rng(3)
    n1, n2, L, C, lanes = 16, 128, 11, 2, 8
    x = rng.standard_normal((n1, n2, L)) + 1j * rng.standard_normal(
        (n1, n2, L))
    slab = n2 * lanes + 8

    def at(j, k2, l):
        return j * slab + (k2 >> 1) * 16 + (
            (((k2 & 1) << 3) | l) ^ (((k2 >> 1) & 3) << 2))

    S = n1 // C
    idx = {at(j, k2, l) for j in range(S) for k2 in range(n2)
           for l in range(lanes)}
    assert len(idx) == S * n2 * lanes   # the swizzle is one-to-one
    y = np.zeros_like(x)
    for l0 in range(0, L, lanes):
        tiles = []
        for rank in range(C):
            t = np.zeros(S * slab, complex)
            for j in range(S):
                for k2 in range(n2):
                    for l in range(min(lanes, L - l0)):
                        t[at(j, k2, l)] = x[rank * S + j, k2, l0 + l]
            for j in range(S):   # the n2 lines, in place
                for l in range(lanes):
                    pos = [at(j, k2, l) for k2 in range(n2)]
                    t[pos] = np.fft.fft(t[pos])
            tiles.append(t)
        cols = n2 * lanes // C
        for rank in range(C):
            for q in range(0, cols, 2):   # adjacent lanes of L: one read
                col = rank * cols + q
                k2, l = col // lanes, col % lanes
                pair = np.array([tiles[k1 // S][at(k1 % S, k2, l):
                                                at(k1 % S, k2, l) + 2]
                                 for k1 in range(n1)])
                for d in range(2):
                    if l0 + l + d < L:
                        y[:, k2, l0 + l + d] = np.fft.fft(pair[:, d])
    want = np.fft.fft2(x, axes=(0, 1))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-12

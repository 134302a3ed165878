"""The cube kernel's plain version against tpufft's ``_build_3d`` (K5),
reached through ``mxu_fft.fft_cube_pallas``.

tpufft's Pallas kernel runs in interpret mode on the CPU with
``precision="highest"``; the port runs ``cube_fft.fft_cube_reference``
(what ``fft_cube`` runs for CPU tensors), on the same planes made from a
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

from tpufft_torch.kernels import cube_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

# tpufft's own cube tests (tests/test_kernels.py): the dispatch cube and
# the ragged-grid canary
SHAPES = [(3, 16, 32, 64), (5, 16, 16, 64)]
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
    ref = tp_mxu.fft_cube_pallas(jnp.asarray(re, jdt), jnp.asarray(im, jdt),
                                 inverse=inverse, scale=scale, config=TP_CFG)
    got = cube_fft.fft_cube(torch.from_numpy(re).to(tdt),
                            torch.from_numpy(im).to(tdt), inverse=inverse,
                            scale=scale)
    assert got[0].dtype == tdt and got[0].shape == re.shape
    ref = (np.asarray(ref[0].astype(jnp.float32))
           + 1j * np.asarray(ref[1].astype(jnp.float32)))
    return got[0].float().numpy() + 1j * got[1].float().numpy(), ref


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cube_matches_build_3d(shape, inverse):
    re, im = _planes(shape, seed=sum(shape))
    scale = 1.0 / np.prod(shape[1:]) if inverse else 1.0
    got, ref = _run_both(re, im, inverse, scale, jnp.float32, torch.float32)
    assert _err(got, ref) < 1e-5
    want = (np.fft.ifftn if inverse else np.fft.fftn)(
        re + 1j * im.astype(np.float64), axes=(1, 2, 3))
    want = want * (np.prod(shape[1:]) * scale if inverse else 1.0)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_cube_matches_build_3d_bf16_storage(shape):
    re, im = _planes(shape, seed=len(shape))
    got, ref = _run_both(re, im, False, 1.0, jnp.bfloat16, torch.bfloat16)
    assert _err(got, ref) < 8e-3


def test_envelope():
    """Each length inside the minor-axis kernel's radix envelope and at
    least 2, and a cluster of 1 to 16 blocks of at most 16384 elements that
    splits n1 and n2*n3 evenly: the smallest with at most 2048 elements a
    block, else the largest."""
    sizes = {(8, 8, 8): 1, (8, 16, 32): 2, (16, 16, 32): 4,
             (16, 32, 32): 8, (16, 32, 64): 16, (32, 64, 64): 16,
             (64, 64, 64): 16, (24, 40, 56): 8, (3, 16, 24): 1}
    for cube, c in sizes.items():
        assert cube_fft.cluster_size(*cube) == c, cube
        assert cube_fft.supported(*cube, torch.float32), cube
        assert cube_fft.supported(*cube, torch.bfloat16), cube
    assert not cube_fft.supported(128, 128, 64, torch.float32)  # 2^20
    assert not cube_fft.supported(3, 128, 128, torch.float32)   # 3 ∤ 16
    assert not cube_fft.supported(1, 16, 64, torch.float32)
    assert not cube_fft.supported(8, 16, 131, torch.float32)    # prime 131
    assert not cube_fft.supported(8, 8, 8, torch.float64)


def test_wrapper_cpu_runs_plain_version():
    re, im = _planes((2, 6, 10, 12), seed=0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    cube_fft.reset_counts()
    got = cube_fft.fft_cube(xr, xi, inverse=True, scale=0.5)
    ref = cube_fft.fft_cube_reference(xr, xi, inverse=True, scale=0.5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert cube_fft.launches == 0 and cube_fft.reference_cuda_calls == 0
    want = np.fft.ifftn(re + 1j * im.astype(np.float64), axes=(1, 2, 3))
    assert _err(got[0].numpy() + 1j * got[1].numpy(),
                want * (6 * 10 * 12 * 0.5)) < 1e-5


def test_wrapper_refuses_non_cuda_devices():
    x = torch.empty(2, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cube_fft.fft_cube(x, x, inverse=False, scale=1.0)


# The envelope over a grid of cubes, as the kernel's stage-form-only
# release answered it: for each n1 of AXES, one group per n2 of AXES and in
# it one character per n3 of AXES: the cluster size (1, 2, 4, 8, g = 16) of
# a supported cube, "." for a cube outside the envelope (no cluster size).
# The line form must not narrow it.
AXES = (2, 4, 8, 16, 32, 64, 24, 40, 56, 93, 1024)
ENVELOPE = {
    2: "11111111112 11111111112 11111111112 11111111122 1111121222. "
       "1111222222. 1111121122. 1111221222. 1111222222. 111222222.. "
       "2222.......",
    4: "11111111114 11111111114 11111111124 11111212244 1111242444. "
       "1112444444. 1111242244. 1112442444. 1112444444. 112444444.. "
       "4444.......",
    8: "11111111118 11111111128 11111212248 11112424488 1112484888. "
       "1124888888. 1112484488. 1124884888. 1124888888. 124888888.. "
       "8888.......",
    16: "1111111112g 1111121224g 1111242448g 111248488gg 11248g8ggg. "
        "1248gggggg. 11248g88g8. 1248gg8gg8. 1248ggggg8. 248ggg888.. "
        "gggg.......",
    32: "1111121222g 1111242444g 1112484888g 11248g8ggg. 1248gggggg. "
        "248ggggggg. 1248ggggg8. 248gggggg8. 248gggggg.. 248ggg88... "
        "ggg........",
    64: "1111242442g 1112484884g 11248g8gg8. 1248gggggg. 248ggggggg. "
        "48ggggggg.. 248gggggg.. 48ggggggg.. 48ggggggg.. 248gg...... "
        "gg.........",
    24: "11111211228 11112422448 1112484488. 1124888888. 1248888888. "
        "248888888.. 1248888888. 1248888888. 2488888888. 24888.888.. "
        "88.........",
    40: "11112412428 1112482484. 1124884888. 1248888888. 2488888888. "
        "48888.88... 1248888888. 248888888.. 48888.888.. 24888.8.... "
        "8..........",
    56: "11112424428 1112484884. 1124888888. 1248888888. 248888888.. "
        "48888.8.... 2488888888. 48888.888.. 48888.88... 2488..8.... "
        "8..........",
    93: "111111111.. 11111.11... 1111....... 111........ 11......... "
        "1.......... 11......... 11......... 1.......... ........... "
        "...........",
    1024: "248gggggg.. 48ggggggg.. 8gggg.g.... gggg....... ggg........ "
          "gg......... ggg........ gg......... gg......... ........... "
          "...........",
}
_CLUSTER = {"1": 1, "2": 2, "4": 4, "8": 8, "g": 16, ".": None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1", AXES)
def test_envelope_and_cluster_size_over_the_grid(n1, dtype):
    groups = ENVELOPE[n1].split()
    for n2, group in zip(AXES, groups, strict=True):
        for n3, ch in zip(AXES, group, strict=True):
            want = _CLUSTER[ch]
            cube = (n1, n2, n3)
            assert cube_fft.cluster_size(*cube) == want, cube
            assert cube_fft.supported(*cube, dtype) == (want is not None), cube


@pytest.mark.parametrize("cube,want", [
    ((64, 64, 64), "lines"), ((32, 32, 32), "lines"), ((8, 8, 8), "lines"),
    ((8, 16, 32), "lines"), ((16, 16, 32), "lines"), ((16, 32, 32), "lines"),
    ((16, 32, 64), "lines"), ((32, 64, 64), "lines"), ((2, 2, 2), "lines"),
    ((2, 64, 2), "lines"), ((24, 40, 56), "stages"), ((3, 16, 24), "stages"),
    ((128, 2, 2), "stages"), ((64, 64, 24), "stages"),
    ((128, 128, 64), None),
])
def test_form(cube, want):
    """Cubes of power-of-two axes up to 64 take the line form, the rest of
    the envelope the stage form; outside it there is no form."""
    assert cube_fft.form(*cube) == want


def test_form_over_the_grid():
    """Over the envelope grid: the line form exactly where every axis is a
    power of two up to 64 (a block's n1-columns are then always even)."""
    for n1 in AXES:
        for n2 in AXES:
            for n3 in AXES:
                got = cube_fft.form(n1, n2, n3)
                if cube_fft.cluster_size(n1, n2, n3) is None:
                    assert got is None
                    continue
                pow2 = all(n in cube_fft.LINE_LENGTHS for n in (n1, n2, n3))
                assert got == ("lines" if pow2 else "stages"), (n1, n2, n3)

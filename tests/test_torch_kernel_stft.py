"""The short-time Fourier kernels' plain versions against tpufft's Pallas
kernels.

K13 (``mxu_fft.build_stft_overlap``), K14 (``build_istft_ola``) and K15
(``build_welch_accum``, welch and csd) run in interpret mode on the CPU
with tpufft's default bf16x3 precision, at hop 128 (tpufft's kernels tile
the hop in 128 lanes) and K = nperseg / hop of 1, 2 and 4; the port's
wrappers, given CPU tensors, run their plain versions (``unfold`` and
``torch.matmul`` in f32, an ``index_add_`` overlap-add). Both get the same
seeded numpy signals and the same host matrices. Tolerance 2e-5,
normalized by the result's magnitude: bf16x3 keeps about 2^-24 of each
product and the plain versions round in f32, so the two differ by a few
1e-6 at nperseg = 512 (the kernels on the card are held to their plain
versions in ``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from tpufft import spectral as tp_spectral
from tpufft.kernels import mxu_fft

from tpufft_torch import spectral
from tpufft_torch.kernels import stft_mm

TOL = 2e-5
HOP = 128
# (batch, nperseg, nfft, nseg): K = 1, 2, 4; nfft > nperseg; a batch of 1
SHAPES = [(3, 128, 128, 6), (3, 256, 256, 7), (1, 256, 384, 5),
          (2, 512, 512, 4)]
DETRENDS = [False, "constant", "linear"]


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _signal(batch, n, seed):
    return np.random.default_rng(seed).standard_normal((batch, n)).astype(
        np.float32)


def _stft_planes(nperseg, nfft, detrend):
    M = spectral._stft_matrix(np.hanning(nperseg), nperseg, nfft, detrend)
    assert np.array_equal(M, tp_spectral._stft_matrix(
        np.hanning(nperseg), nperseg, nfft, detrend))
    return (np.ascontiguousarray(M.real, np.float32),
            np.ascontiguousarray(M.imag, np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("batch,nperseg,nfft,nseg", SHAPES)
def test_stft_frames_matches_tpufft(batch, nperseg, nfft, nseg, detrend):
    mr, mi = _stft_planes(nperseg, nfft, detrend)
    x = _signal(batch, (nseg - 1) * HOP + nperseg, nperseg + nseg)
    ref = mxu_fft.build_stft_overlap(mr, mi, HOP, nseg, 8, "bf16x3",
                                     True)(x)
    yr, yi = stft_mm.stft_frames(*_t(x, mr, mi), HOP)
    assert yr.dtype == torch.float32 and yr.shape == (batch, nseg,
                                                      nfft // 2 + 1)
    got = yr.numpy() + 1j * yi.numpy()
    assert _err(got, np.asarray(ref[0]) + 1j * np.asarray(ref[1])) < TOL
    frames = np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), nperseg, axis=-1)[:, ::HOP]
    assert _err(got, frames @ (mr.astype(np.float64) + 1j * mi)) < TOL


@pytest.mark.parametrize("batch,nperseg,nfft,nseg", SHAPES)
def test_istft_ola_matches_tpufft(batch, nperseg, nfft, nseg):
    A = spectral._istft_matrix(np.hanning(nperseg), nperseg, nfft, 3.0)
    ar = np.ascontiguousarray(A.real, np.float32)
    ai = np.ascontiguousarray(A.imag, np.float32)
    m1 = nfft // 2 + 1
    zr = _signal(batch * nseg, m1, 1).reshape(batch, nseg, m1)
    zi = _signal(batch * nseg, m1, 2).reshape(batch, nseg, m1)
    ref = mxu_fft.build_istft_ola(ar, ai, HOP, nseg, 8, "bf16x3", True)(
        zr.transpose(1, 0, 2).copy(), zi.transpose(1, 0, 2).copy())
    out = stft_mm.istft_ola(*_t(zr, zi, ar, ai), HOP)
    assert out.shape == (batch, (nseg - 1) * HOP + nperseg)
    assert _err(out.numpy(), ref) < TOL
    seg = zr.astype(np.float64) @ ar + zi.astype(np.float64) @ ai
    exact = np.zeros(out.shape)
    for s in range(nseg):
        exact[:, s * HOP:s * HOP + nperseg] += seg[:, s]
    assert _err(out.numpy(), exact) < TOL


@pytest.mark.parametrize("cross", [False, True], ids=["welch", "csd"])
@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("batch,nperseg,nfft,nseg", SHAPES)
def test_welch_accum_matches_tpufft(batch, nperseg, nfft, nseg, detrend,
                                    cross):
    mr, mi = _stft_planes(nperseg, nfft, detrend)
    n = (nseg - 1) * HOP + nperseg
    xs = [_signal(batch, n, 7)] + ([_signal(batch, n, 8)] if cross else [])
    ref = mxu_fft.build_welch_accum(mr, mi, HOP, nseg, 8, "bf16x3", True,
                                    cross)(*xs)
    t = _t(*xs, mr, mi)
    if cross:
        got = stft_mm.welch_accum(t[0], t[2], t[3], HOP, t[1])
        got = got[0].numpy() + 1j * got[1].numpy()
        ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    else:
        got = stft_mm.welch_accum(t[0], t[1], t[2], HOP).numpy()
    assert got.shape == (batch, nfft // 2 + 1)
    assert _err(got, ref) < TOL


@pytest.mark.parametrize("hop", [1, 3, 64])
def test_plain_versions_take_any_hop(hop):
    """The port's kernels take any hop (tpufft's need hop % 128 == 0):
    the plain versions against an explicit float64 framing."""
    nperseg, nfft, nseg = 192, 256, 9
    mr, mi = _stft_planes(nperseg, nfft, "constant")
    x = _signal(2, (nseg - 1) * hop + nperseg + hop - 1, hop)
    frames = np.stack([x[:, s * hop:s * hop + nperseg]
                       for s in range(nseg)], 1).astype(np.float64)
    spec = frames @ (mr.astype(np.float64) + 1j * mi)
    yr, yi = stft_mm.stft_frames(*_t(x, mr, mi), hop)
    assert _err(yr.numpy() + 1j * yi.numpy(), spec) < TOL
    assert _err(stft_mm.welch_accum(*_t(x, mr, mi), hop).numpy(),
                (np.abs(spec) ** 2).sum(1)) < TOL


def test_cpu_tensors_run_the_plain_versions():
    """CPU tensors never reach the CUDA library, launch nothing and count
    nothing."""
    stft_mm.reset_counts()
    x, m = torch.ones(2, 10), torch.ones(4, 3)
    yr, yi = stft_mm.stft_frames(x, m, m, 2)
    assert torch.equal(yr, torch.full((2, 4, 3), 4.0))
    assert torch.equal(stft_mm.welch_accum(x, m, m, 2),
                       torch.full((2, 3), 128.0))
    out = stft_mm.istft_ola(yr, yi, m.T.contiguous(), m.T.contiguous(), 2)
    assert out.shape == (2, 10)
    assert stft_mm.launches == {"stft": 0, "istft": 0, "welch": 0, "csd": 0}
    assert stft_mm.reference_cuda_calls == 0

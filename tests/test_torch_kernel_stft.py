"""The short-time Fourier kernels' plain versions against tpufft's Pallas
kernels.

K13 (``mxu_fft.build_stft_overlap``), K14 (``build_istft_ola``) and K15
(``build_welch_accum``, welch and csd) run in interpret mode on the CPU
with tpufft's default bf16x3 precision, at hop 128 (tpufft's kernels tile
the hop in 128 lanes) and K = nperseg / hop of 1, 2 and 4; the port's
wrappers, given CPU tensors, run their plain versions (``unfold`` and
``torch.matmul`` in f32, an ``index_add_`` overlap-add). tpufft's K13
takes its callers' host matrix (``spectral._stft_matrix``,
``ShortTimeFFT._fused_stft_matrix``), and so does its K15; the port's K13
takes the window, the per-bin factor c, nfft and the detrend kind, its K15
the same without c, and their plain versions build the same matrix from
them (``stft_mm.frame_matrix``). Both get the same seeded numpy
signals. Tolerance 2e-5, normalized by the result's
magnitude: bf16x3 keeps about 2^-24 of each product and the plain versions
round in f32, so the two differ by a few 1e-6 at nperseg = 512 (the
kernels on the card are held to their plain versions in
``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import scipy.signal as sps

import tpufft
from tpufft import spectral as tp_spectral
from tpufft.kernels import mxu_fft

import tpufft_torch
from tpufft_torch import spectral
from tpufft_torch.kernels import minor_fft, stft_mm
from test_torch_kernel_minor import _line_out
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

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


def _frame_args(nperseg, nfft, fold=1.0):
    """K13's operands for tpufft's spectral matrix: the window and c =
    fold on every bin."""
    m1 = nfft // 2 + 1
    return _t(np.hanning(nperseg).astype(np.float32),
              np.full(m1, fold, np.float32), np.zeros(m1, np.float32))


def _stft_ref(x, M, nseg):
    """tpufft's K13 in interpret mode on the f32 planes of M."""
    ref = mxu_fft.build_stft_overlap(
        np.ascontiguousarray(M.real, np.float32),
        np.ascontiguousarray(M.imag, np.float32), HOP, nseg, 8, "bf16x3",
        True)(x)
    return np.asarray(ref[0]) + 1j * np.asarray(ref[1])


def _frames64(x, nperseg, hop, nseg):
    return np.lib.stride_tricks.sliding_window_view(
        x.astype(np.float64), nperseg, axis=-1)[:, ::hop][:, :nseg]


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("batch,nperseg,nfft,nseg", SHAPES)
def test_stft_frames_matches_tpufft(batch, nperseg, nfft, nseg, detrend):
    mr, mi = _stft_planes(nperseg, nfft, detrend)
    x = _signal(batch, (nseg - 1) * HOP + nperseg, nperseg + nseg)
    ref = _stft_ref(x, mr + 1j * mi, nseg)
    yr, yi = stft_mm.stft_frames(torch.from_numpy(x),
                                 *_frame_args(nperseg, nfft), nfft, detrend,
                                 HOP, nseg)
    assert yr.dtype == torch.float32 and yr.shape == (batch, nseg,
                                                      nfft // 2 + 1)
    got = yr.numpy() + 1j * yi.numpy()
    assert _err(got, ref) < TOL
    frames = _frames64(x, nperseg, HOP, nseg)
    assert _err(got, frames @ (mr.astype(np.float64) + 1j * mi)) < TOL


@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("batch,nperseg,nfft,nseg", [(2, 128, 255, 5),
                                                     (1, 256, 257, 3),
                                                     (3, 128, 200, 4)])
def test_frame_matrix_matches_tpufft_stft_matrix(batch, nperseg, nfft, nseg,
                                                 detrend):
    """The structured plain version (window, c, nfft, detrend) against
    tpufft's K13 fed with ``tpufft.spectral._stft_matrix`` times a scale:
    odd nfft and nfft > nperseg, the three detrends."""
    fold = 0.37
    M = tp_spectral._stft_matrix(np.hanning(nperseg), nperseg, nfft,
                                 detrend or None) * fold
    mine = stft_mm.frame_matrix(np.hanning(nperseg),
                                np.full(nfft // 2 + 1, fold), nfft, detrend)
    assert np.max(np.abs(mine - M)) < 1e-12
    x = _signal(batch, (nseg - 1) * HOP + nperseg + 7, nfft)
    yr, yi = stft_mm.stft_frames(torch.from_numpy(x),
                                 *_frame_args(nperseg, nfft, fold), nfft,
                                 detrend, HOP, nseg)
    got = yr.numpy() + 1j * yi.numpy()
    assert _err(got, _stft_ref(x[:, :(nseg - 1) * HOP + nperseg], M,
                               nseg)) < TOL
    assert _err(got, _frames64(x, nperseg, HOP, nseg) @ M) < TOL


@pytest.mark.parametrize("detrend", [None, "constant", "linear"])
@pytest.mark.parametrize("mfft,phase_shift,scale_to", [
    (256, 3, "psd"), (301, -40, "magnitude"), (256, None, "magnitude")])
def test_frame_factor_matches_tpufft_short_time_matrix(mfft, phase_shift,
                                                       scale_to, detrend):
    """K13's operands from ``ShortTimeFFT`` (its real window and c, the
    phase roll times the onesided2X doubling) against tpufft's K13 fed
    with tpufft's ``ShortTimeFFT._fused_stft_matrix``."""
    win = sps.get_window("hann", 256)
    kw = dict(fft_mode="onesided2X", mfft=mfft, phase_shift=phase_shift,
              scale_to=scale_to)
    tp = tpufft.ShortTimeFFT(win, HOP, 8.0, **kw)
    ours = tpufft_torch.ShortTimeFFT(win, HOP, 8.0, device="cpu", **kw)
    M = tp._fused_stft_matrix(detrend)
    c = ours._frame_factor()
    assert np.max(np.abs(stft_mm.frame_matrix(np.real(ours._win), c, mfft,
                                              detrend) - M)) < 1e-12
    nseg = 6
    x = _signal(2, (nseg - 1) * HOP + 256, mfft)
    yr, yi = stft_mm.stft_frames(
        *_t(x, np.real(ours._win).astype(np.float32),
            c.real.astype(np.float32), c.imag.astype(np.float32)),
        mfft, detrend, HOP, nseg)
    assert _err(yr.numpy() + 1j * yi.numpy(), _stft_ref(x, M, nseg)) < TOL


@pytest.mark.parametrize("nfft, inside", [(1024, True), (1023, True),
                                          (1025, False), (6561, False)])
def test_frame_fft_envelope_ends_at_1024(nfft, inside):
    """K13's envelope ends at the callers' nfft cap of 1024: 1025 = 5^2 x 41
    and 6561 = 3^8 have small prime factors but lie above it, so
    frames_supported is false and stft_frames refuses them on the card."""
    assert stft_mm.MAX_FRAME_NFFT == 1024
    assert stft_mm.frames_supported(nfft) == inside


def test_nfft_outside_the_frame_fft_takes_the_composed_route(monkeypatch):
    """An nfft whose half has a prime factor above 127 (262 = 2 x 131, and
    the prime 131) is outside K13's FFT: stft and ShortTimeFFT take the
    composed route (no K13 call, plain or kernel) and still match scipy;
    256 and 255 stay on K13."""
    assert not stft_mm.frames_supported(262)
    assert not stft_mm.frames_supported(131)
    assert stft_mm.frames_supported(256) and stft_mm.frames_supported(255)
    calls = []
    orig = stft_mm.stft_frames_reference
    monkeypatch.setattr(stft_mm, "stft_frames_reference",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x = _signal(2, 3000, 9)
    for nfft, on_k13 in ((262, False), (131, False), (256, True)):
        calls.clear()
        _, _, Z = tpufft_torch.stft(torch.from_numpy(x), nperseg=128,
                                    nfft=nfft)
        assert len(calls) == int(on_k13), nfft
        want = sps.stft(x.astype(np.float64), nperseg=128, nfft=nfft)[2]
        assert _err(Z.numpy(), want) < 1e-5
        calls.clear()
        win = sps.get_window("hann", 128)
        S = tpufft_torch.ShortTimeFFT(win, 64, 1.0, mfft=nfft,
                                      device="cpu").stft(torch.from_numpy(x))
        assert len(calls) == int(on_k13), nfft
        want = sps.ShortTimeFFT(win, 64, 1.0, mfft=nfft).stft(
            x.astype(np.float64))
        assert _err(S.numpy(), want) < 1e-5


def _istft_ref(zr, zi, A, hop, nseg):
    """tpufft's K14 in interpret mode on the f32 planes of A."""
    return np.asarray(mxu_fft.build_istft_ola(
        np.ascontiguousarray(A.real, np.float32),
        np.ascontiguousarray(A.imag, np.float32), hop, nseg, 8, "bf16x3",
        True)(zr.transpose(1, 0, 2).copy(), zi.transpose(1, 0, 2).copy()))


def _istft_exact(zr, zi, A, hop):
    """The overlap-add of every segment's Zr A.real + Zi A.imag in f64."""
    seg = zr.astype(np.float64) @ A.real + zi.astype(np.float64) @ A.imag
    batch, nseg, nperseg = seg.shape
    exact = np.zeros((batch, (nseg - 1) * hop + nperseg))
    for s in range(nseg):
        exact[:, s * hop:s * hop + nperseg] += seg[:, s]
    return exact


def _spectra(batch, nseg, m1):
    zr = _signal(batch * nseg, m1, 1).reshape(batch, nseg, m1)
    zi = _signal(batch * nseg, m1, 2).reshape(batch, nseg, m1)
    return zr, zi


@pytest.mark.parametrize("batch,nperseg,nfft,nseg", SHAPES)
def test_istft_ola_matches_tpufft(batch, nperseg, nfft, nseg):
    """K14 takes the synthesis window, the per-bin factor c (here the stft
    unscale 3.0 on every bin) and nfft; tpufft's takes the matrix of the
    same function, ``tpufft.spectral._istft_matrix``."""
    A = tp_spectral._istft_matrix(np.hanning(nperseg), nperseg, nfft, 3.0)
    zr, zi = _spectra(batch, nseg, nfft // 2 + 1)
    ref = _istft_ref(zr, zi, A, HOP, nseg)
    out = stft_mm.istft_frames(*_t(zr, zi), *_frame_args(nperseg, nfft, 3.0),
                               nfft, HOP)
    assert out.shape == (batch, (nseg - 1) * HOP + nperseg)
    assert out.dtype == torch.float32
    assert _err(out.numpy(), ref) < TOL
    assert _err(out.numpy(), _istft_exact(zr, zi, A, HOP)) < TOL


# (batch, nperseg, hop, nfft, nseg): hops 64 and 32 (K = 2 to 8), nfft >
# nperseg, odd nfft
ISTFT_MORE = [(2, 256, 64, 256, 9), (3, 128, 32, 128, 12),
              (1, 192, 64, 512, 7), (2, 200, 100, 255, 6),
              (2, 128, 64, 301, 5), (1, 256, 32, 384, 8)]


@pytest.mark.parametrize("batch,nperseg,hop,nfft,nseg", ISTFT_MORE)
def test_istft_frames_matches_tpufft_at_other_hops(batch, nperseg, hop, nfft,
                                                   nseg):
    """K14's plain version beyond hop 128, nfft = nperseg and even nfft:
    against tpufft's K14 in interpret mode fed ``_istft_matrix`` of the
    same window and unscale, and against the f64 overlap-add."""
    A = tp_spectral._istft_matrix(np.hanning(nperseg), nperseg, nfft, 0.7)
    zr, zi = _spectra(batch, nseg, nfft // 2 + 1)
    out = stft_mm.istft_frames(*_t(zr, zi), *_frame_args(nperseg, nfft, 0.7),
                               nfft, hop)
    assert out.shape == (batch, (nseg - 1) * hop + nperseg)
    assert _err(out.numpy(), _istft_ref(zr, zi, A, hop, nseg)) < TOL
    assert _err(out.numpy(), _istft_exact(zr, zi, A, hop)) < TOL


@pytest.mark.parametrize("nperseg,nfft,unscale", [
    (256, 256, 1.0), (200, 255, 3.0), (128, 301, 0.25), (192, 512, 7.5),
    (2, 2, 1.0)])
def test_synthesis_matrix_matches_tpufft_istft_matrix(nperseg, nfft,
                                                     unscale):
    """The (win, c) matrix with c = unscale on every bin is tpufft's
    ``spectral._istft_matrix`` to 1e-12, and the port's ``_istft_matrix``
    is that matrix."""
    win = sps.get_window("hann", nperseg)
    mine = stft_mm.synthesis_matrix(win, np.full(nfft // 2 + 1, unscale),
                                    nfft)
    theirs = tp_spectral._istft_matrix(win, nperseg, nfft, unscale)
    assert mine.shape == (nfft // 2 + 1, nperseg)
    assert np.max(np.abs(mine - theirs)) < 1e-12
    assert np.array_equal(spectral._istft_matrix(win, nperseg, nfft,
                                                 unscale), mine)


@pytest.mark.parametrize("mfft,phase_shift,scale_to,fft_mode", [
    (256, 3, "psd", "onesided2X"), (301, -40, "magnitude", "onesided2X"),
    (256, None, "magnitude", "onesided2X"), (384, 17, None, "onesided")])
def test_synthesis_factor_matches_tpufft_short_time_matrix(
        mfft, phase_shift, scale_to, fft_mode):
    """K14's operands from ``ShortTimeFFT`` (its real dual window and c,
    the phase roll times the onesided2X unscale) give tpufft's
    ``ShortTimeFFT._fused_istft_matrix`` to 1e-12, and the plain version on
    them matches tpufft's K14 fed with that matrix."""
    win = sps.get_window("hann", 256)
    kw = dict(fft_mode=fft_mode, mfft=mfft, phase_shift=phase_shift,
              scale_to=scale_to)
    tp = tpufft.ShortTimeFFT(win, HOP, 8.0, **kw)
    ours = tpufft_torch.ShortTimeFFT(win, HOP, 8.0, device="cpu", **kw)
    M = tp._fused_istft_matrix()
    c = ours._synthesis_factor()
    dual = np.real(ours.dual_win)
    assert np.max(np.abs(stft_mm.synthesis_matrix(dual, c, mfft) - M)) \
        < 1e-12
    assert np.max(np.abs(ours._fused_istft_matrix() - M)) < 1e-12
    nseg = 6
    zr, zi = _spectra(2, nseg, mfft // 2 + 1)
    out = stft_mm.istft_frames(
        *_t(zr, zi, dual.astype(np.float32), c.real.astype(np.float32),
            c.imag.astype(np.float32)), mfft, HOP)
    assert _err(out.numpy(), _istft_ref(zr, zi, M, HOP, nseg)) < TOL


def test_istft_form_across_nfft():
    """``istft_form``: the line form at nfft = 256, 512 and 1024, whose half
    runs K1's four-step on one-warp teams of a 128-thread block (the
    geometry the line kernel is instantiated on: (N1, N2) = (8, 16),
    (16, 16), (32, 16)); the dense body at every other nfft up to 1024,
    odd, non-power-of-two and the powers of two below 256."""
    for nfft in range(2, stft_mm.MAX_FRAME_NFFT + 1):
        form = stft_mm.istft_form(nfft)
        if nfft in (256, 512, 1024):
            assert form == "lines", nfft
            geo = minor_fft.line_geometry(nfft // 2)
            assert (geo["team_warps"], geo["threads"]) == (1, 128)
            assert (geo["n1"], geo["n2"]) == {256: (8, 16), 512: (16, 16),
                                              1024: (32, 16)}[nfft]
        else:
            assert form == "dense", nfft


# ----------------------------------------------------------------------------
# K14's line form as a model: the block split, the waves, the carry
# ----------------------------------------------------------------------------

HALO_SHARE = 33   # k14::kHaloShare


def _split(nseg, taps, wave):
    """k14::split: the chunks a block writes (run) and the blocks a row."""
    need = HALO_SHARE * (taps - 1)
    waves = -(-need // wave) if need > wave else 1
    run = waves * wave - (taps - 1)
    return run, -(-(nseg + taps - 1) // run)


def _ola_model(seg, hop, wave):
    """``istft_lane_kernel``'s overlap-add over segments seg (nseg,
    nperseg): blocks of `run` chunks, each taking its segments (halo
    included) in waves of `wave`; thread-owned positions u < (nw + K - 1)
    hop of a wave sum the carry (c < K - 1) and the wave's segments in
    order; complete chunks are stored where the block owns them, the rest
    carried. Returns the output, how often each sample was written, the
    first and last segment summed into each, and the most carry floats a
    wave held."""
    nseg, nperseg = seg.shape
    taps = nperseg // hop
    run, runs = _split(nseg, taps, wave)
    n_out = (nseg - 1) * hop + nperseg
    out = np.full(n_out, np.nan)
    writes = np.zeros(n_out, int)
    first = np.full(n_out, -1)
    last_seg = np.full(n_out, -1)
    most_carry = 0
    for j in range(runs):
        c0 = j * run
        c1 = min(c0 + run, nseg + taps - 1)
        s_lo, s_hi = max(0, c0 - taps + 1), min(c1 - 1, nseg - 1)
        old = np.zeros(nperseg)
        old_lo = np.full(nperseg, -1)
        old_hi = np.full(nperseg, -1)
        for sa in range(s_lo, s_hi + 1, wave):
            nw = min(wave, s_hi - sa + 1)
            last = sa + wave > s_hi
            u = np.arange((nw + taps - 1) * hop)
            c = u // hop
            held = c < taps - 1
            acc = np.where(held, old[np.minimum(u, nperseg - 1)], 0.0)
            lo = np.where(held, old_lo[np.minimum(u, nperseg - 1)], -1)
            hi = np.where(held, old_hi[np.minimum(u, nperseg - 1)], -1)
            for q in range(nw):
                on = (q >= c - taps + 1) & (q <= c)
                s = sa + q
                assert np.all(hi[on] == np.where(lo[on] < 0, -1, s - 1))
                acc[on] += seg[s, (u - q * hop)[on]]
                lo[on] = np.where(lo[on] < 0, s, lo[on])
                hi[on] = s
            done = (c < nw) | last
            mine = done & (sa + c >= c0) & (sa + c < c1)
            at = sa * hop + u[mine]
            out[at] = acc[mine]
            writes[at] += 1
            first[at], last_seg[at] = lo[mine], hi[mine]
            keep = ~done
            most_carry = max(most_carry, int(keep.sum()))
            old = np.zeros(nperseg)
            old_lo = np.full(nperseg, -1)
            old_hi = np.full(nperseg, -1)
            old[u[keep] - nw * hop] = acc[keep]
            old_lo[u[keep] - nw * hop] = lo[keep]
            old_hi[u[keep] - nw * hop] = hi[keep]
    return out, writes, first, last_seg, most_carry, run, runs


@pytest.mark.parametrize("wave", [32, 16, 8], ids=["m128", "m256", "m512"])
@pytest.mark.parametrize("nperseg,hop,nseg", [
    (256, 256, 100), (256, 128, 200), (256, 64, 300), (256, 1, 9000),
    (256, 128, 1), (240, 6, 50)], ids=["K1", "K2", "K4", "K256", "nseg1",
                                      "K40"])
def test_istft_line_form_overlap_add_model(nperseg, hop, nseg, wave):
    """The line form's split and wave-wise overlap-add against a direct
    overlap-add: every output sample is written once, by one block, as
    the sum of the segments that cover it (s = max(0, c - K + 1) ..
    min(c, nseg - 1) for chunk c) taken in segment order; the halo (K - 1
    segments a block) is at most 1/33 of a block's segments; the carry
    between waves stays below nperseg floats, whatever K."""
    g = np.random.default_rng(nseg + hop)
    seg = g.standard_normal((nseg, nperseg))
    out, writes, first, last, carry, run, runs = _ola_model(seg, hop, wave)
    taps = nperseg // hop
    exact = np.zeros_like(out)
    for s in range(nseg):
        exact[s * hop:s * hop + nperseg] += seg[s]
    assert np.all(writes == 1)
    assert np.max(np.abs(out - exact)) < 1e-9
    c = np.arange(out.shape[0]) // hop
    assert np.array_equal(first, np.maximum(0, c - taps + 1))
    assert np.array_equal(last, np.minimum(c, nseg - 1))
    assert carry < nperseg
    assert (taps - 1) * HALO_SHARE <= run + taps - 1 or runs == 1
    if nseg > 2 * run:
        assert runs > 2   # the halo is exercised


def _staging_accesses(m):
    """The line form's staging of the windowed pairs (pass 2's registers,
    written at r m + (j ^ ((N1 r) mod 16)) of the team's tile, as K7
    writes Z back) and the overlap-add's float offsets of sample tt of
    wave segment q: 2 (q m + ((tt / 2) ^ ((N1 (q mod R)) mod 16))) + tt
    mod 2."""
    geo = minor_fft.line_geometry(m)
    n1, n2, rows = geo["n1"], geo["n2"], geo["rows"]

    def at(q, tt):
        return 2 * (q * m + ((tt >> 1) ^ ((n1 * (q % rows)) & 15))) + (tt & 1)

    writes = []
    for s in range(32 // n2):
        for q in range(n2):
            acc = []
            for t in range(32):
                row, k1 = divmod(t + 32 * s, n1)
                j = k1 + n1 * _line_out(n2, 0, q)
                acc.append(row * m + (j ^ ((n1 * row) & 15)))
            writes.append(acc)
    return geo, writes, at


@pytest.mark.parametrize("m", [128, 256, 512])
def test_istft_line_form_staging_mapping(m):
    """Each half warp of the staging writes touches 16 distinct bank pairs;
    the overlap-add's offsets of a wave's segments are a bijection onto its
    tiles, and four consecutive samples from a multiple of 4 are one
    16-byte-aligned float4 (the quads of hop % 4 == 0)."""
    geo, writes, at = _staging_accesses(m)
    for acc in writes:
        for half in (acc[:16], acc[16:]):
            assert len({p % 16 for p in half}) == 16, (m, half)
    wave = 4 * geo["rows"]
    offs = [at(q, tt) for q in range(wave) for tt in range(2 * m)]
    assert sorted(offs) == list(range(wave * 2 * m))
    for q in range(wave):
        for tt in range(0, 2 * m, 4):
            base = at(q, tt)
            assert base % 4 == 0
            assert [at(q, tt + i) for i in range(4)] == list(
                range(base, base + 4))


@pytest.mark.parametrize("cross", [False, True], ids=["welch", "csd"])
@pytest.mark.parametrize("detrend", DETRENDS)
@pytest.mark.parametrize("batch,nperseg,nfft,nseg", SHAPES)
def test_welch_accum_matches_tpufft(batch, nperseg, nfft, nseg, detrend,
                                    cross):
    """K15 takes K13's window, nfft and detrend kind (c = 1); tpufft's
    takes the matrix of the same function."""
    mr, mi = _stft_planes(nperseg, nfft, detrend)
    n = (nseg - 1) * HOP + nperseg
    xs = [_signal(batch, n, 7)] + ([_signal(batch, n, 8)] if cross else [])
    ref = mxu_fft.build_welch_accum(mr, mi, HOP, nseg, 8, "bf16x3", True,
                                    cross)(*xs)
    t = _t(*xs)
    win = _frame_args(nperseg, nfft)[0]
    if cross:
        got = stft_mm.welch_accum(t[0], win, nfft, detrend, HOP, t[1])
        got = got[0].numpy() + 1j * got[1].numpy()
        ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    else:
        got = stft_mm.welch_accum(t[0], win, nfft, detrend, HOP).numpy()
    assert got.shape == (batch, nfft // 2 + 1)
    assert _err(got, ref) < TOL


def test_welch_nfft_outside_the_frame_fft_takes_the_composed_route(
        monkeypatch):
    """K15 shares K13's envelope: welch and csd at an nfft whose half has a
    prime factor above 127 (262 = 2 x 131, and the prime 131) take the
    composed route (no K15 call, plain or kernel) and still match scipy;
    256 and 255 stay on K15."""
    calls = []
    orig = stft_mm.welch_accum_reference
    monkeypatch.setattr(stft_mm, "welch_accum_reference",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, y = _signal(2, 3000, 10), _signal(2, 3000, 11)
    xd, yd = x.astype(np.float64), y.astype(np.float64)
    for nfft, on_k15 in ((262, False), (131, False), (256, True),
                         (255, True)):
        calls.clear()
        _, P = tpufft_torch.welch(torch.from_numpy(x), nperseg=128,
                                  nfft=nfft)
        assert len(calls) == int(on_k15), nfft
        assert _err(P.numpy(), sps.welch(xd, nperseg=128, nfft=nfft)[1]) \
            < 1e-5
        calls.clear()
        _, C = tpufft_torch.csd(torch.from_numpy(x), torch.from_numpy(y),
                                nperseg=128, nfft=nfft)
        assert len(calls) == int(on_k15), nfft
        assert _err(C.numpy(), sps.csd(xd, yd, nperseg=128, nfft=nfft)[1]) \
            < 1e-5


@pytest.mark.parametrize("detrend", DETRENDS)
def test_welch_backward_through_k15_matches_the_composed_route(detrend,
                                                              monkeypatch):
    """welch and csd on K15 (``spectral._WelchFused``, whose backward
    builds the host matrix on first use) give the gradients of the
    composed route (framing, detrend, window and rfft in differentiable
    torch ops, ``backend="xla"``), which never reaches K15."""
    calls = []
    orig = stft_mm.welch_accum_reference
    monkeypatch.setattr(stft_mm, "welch_accum_reference",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, y = _signal(3, 2048, 12), _signal(3, 2048, 13)
    weights = torch.from_numpy(
        np.random.default_rng(14).standard_normal(129).astype(np.float32))
    kw = dict(nperseg=256, noverlap=128, detrend=detrend)

    def grads(config):
        xs = torch.from_numpy(x).requires_grad_(True)
        ys = torch.from_numpy(y).requires_grad_(True)
        _, P = tpufft_torch.welch(xs, config=config, **kw)
        _, C = tpufft_torch.csd(xs, ys, config=config, **kw)
        loss = (P * weights).sum() + (C.real * weights).sum() \
            - (C.imag * weights.flip(0)).sum()
        loss.backward()
        return xs.grad.numpy(), ys.grad.numpy()

    fused = grads(None)
    assert len(calls) == 2
    calls.clear()
    composed = grads(tpufft_torch.PlanConfig(backend="xla"))
    assert not calls
    for got, want in zip(fused, composed):
        assert _err(got, want) < 1e-5


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
    yr, yi = stft_mm.stft_frames(torch.from_numpy(x),
                                 *_frame_args(nperseg, nfft), nfft,
                                 "constant", hop, nseg)
    assert _err(yr.numpy() + 1j * yi.numpy(), spec) < TOL
    assert _err(stft_mm.welch_accum(torch.from_numpy(x),
                                    _frame_args(nperseg, nfft)[0], nfft,
                                    "constant", hop).numpy(),
                (np.abs(spec) ** 2).sum(1)) < TOL


def test_cpu_tensors_run_the_plain_versions():
    """CPU tensors never reach the CUDA library, launch nothing and count
    nothing."""
    stft_mm.reset_counts()
    x, m = torch.ones(2, 10), torch.ones(4, 3)
    yr, yi = stft_mm.stft_frames(x, torch.ones(4), torch.ones(3),
                                 torch.zeros(3), 4, False, 2, 4)
    dc = torch.zeros(2, 4, 3)
    dc[..., 0] = 4.0   # a constant frame of ones: all in the DC bin
    assert torch.allclose(yr, dc, atol=1e-6)
    assert torch.allclose(yi, torch.zeros_like(yi), atol=1e-6)
    # four frames a row, each all in the DC bin: 4 x 4^2
    assert torch.allclose(stft_mm.welch_accum(x, torch.ones(4), 4, False, 2),
                          torch.tensor([[64.0, 0.0, 0.0]] * 2), atol=1e-6)
    out = stft_mm.istft_ola(yr, yi, m.T.contiguous(), m.T.contiguous(), 2)
    assert out.shape == (2, 10)
    out = stft_mm.istft_frames(yr, yi, torch.ones(4), torch.ones(3),
                               torch.zeros(3), 4, 2)
    # each segment is all in the DC bin: irfft gives 4 / 4 = 1 a sample,
    # summed twice where two segments overlap
    want = torch.ones(2, 10)
    want[:, 2:8] = 2.0
    assert torch.allclose(out, want, atol=1e-6)
    assert stft_mm.launches == {"stft": 0, "istft": 0, "welch": 0, "csd": 0}
    assert stft_mm.reference_cuda_calls == 0

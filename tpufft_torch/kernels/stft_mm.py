"""The short-time Fourier kernels: the CUDA kernels, their wrappers, and
their plain PyTorch versions.

Counterparts of three Pallas TPU kernels of ``tpufft/kernels/mxu_fft.py``:

* ``build_stft_overlap`` (K13): real signal (batch, n_sig) -> spectrum
  planes (batch, nseg, m1), frame s = x[:, s hop : s hop + nperseg]
  detrended (none, constant or linear), windowed, zero-padded to nfft,
  real-DFT'd and multiplied by a per-bin complex factor c (the scale, a
  phase shift, the onesided2X doubling): :func:`stft_frames`. tpufft folds
  all of it into one (nperseg, m1) host matrix; the port's kernel is an
  FFT of each frame, in shared memory, and takes the window, c, nfft and
  the detrend kind instead (the matrix stays with the callers' backward
  and with the plain version, :func:`frame_matrix`);
* ``build_istft_ola`` (K14): spectrum planes (batch, nseg, m1) ->
  (batch, (nseg + K - 1) hop), K = nperseg / hop, the overlap-add of each
  segment's Zr Ar + Zi Ai with A (m1, nperseg), unnormalised:
  :func:`istft_ola`;
* ``build_welch_accum`` (K15): the sum over segments of |F_s M|^2, or of
  conj(F_s M) (G_s M) as two planes for two signals, M K13's function with
  c = 1: :func:`welch_accum`. tpufft takes M; the port's kernel takes the
  window, nfft and the detrend kind, as K13's.

One CUDA source (``csrc/stft_mm.cu``) serves all three. K13 and K15 run
one frame core, K7's stages (``csrc/fft_stages.cuh``, ``real_fft.cuh``) on
frames copied once a block into shared memory; K13 stores the bins, K15
sums |X|^2 (or conj(X) Y) over a block's frames and writes one partial a
(row, block, bin), which a second pass sums in a fixed order. Their
envelope is :func:`frames_supported` (an nfft whose stage length, nfft/2 or
odd nfft, has prime factors <= 127). K14 is a product with a host-built
matrix on the tile loop of ``csrc/tile_mm.cuh`` that K10 shares, with f32
FMA (no TF32). Frames are never materialised on the kernel path. Signals and spectra may be f32
or bf16 (computed in f32); tables and results are f32. The TPU kernels'
segment-major (nseg, batch, m1) layout and segment groups exist for
Mosaic's block rule and the MXU's 128 rows, and have no counterpart here:
the kernels read and write the layouts their callers use.

A CPU tensor runs the plain version (``unfold`` and two ``torch.matmul``
with the f64-built matrix; per-segment matmuls and an ``index_add_``
overlap-add; the first with c = 1 then the square and sum); a CUDA tensor
launches the kernel or raises, never falls back.
``launches["stft"|"istft"|"welch"|"csd"]`` count launches;
``reference_cuda_calls`` counts runs of the plain versions on CUDA
tensors, which the main path never makes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import minor_fft, real_fft

__all__ = [
    "DETRENDS",
    "frame_matrix",
    "frames_supported",
    "istft_ola",
    "istft_ola_reference",
    "launches",
    "reference_cuda_calls",
    "reset_counts",
    "stft_frames",
    "stft_frames_reference",
    "welch_accum",
    "welch_accum_reference",
]

launches = {"stft": 0, "istft": 0, "welch": 0, "csd": 0}
reference_cuda_calls = 0

_STORAGE = (torch.float32, torch.bfloat16)
# K13's detrend kinds, as the kernel numbers them
DETRENDS = {False: 0, None: 0, "constant": 1, "linear": 2}
MAX_FRAME_NFFT = 1024   # the callers' cap (spectral.STFT_KERNEL_MAX_NFFT)


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global reference_cuda_calls
    for k in launches:
        launches[k] = 0
    reference_cuda_calls = 0


def _nseg(n_sig: int, nperseg: int, hop: int) -> int:
    if n_sig < nperseg:
        raise ValueError(f"signal length {n_sig} < nperseg {nperseg}")
    return 1 + (n_sig - nperseg) // hop


def _check_rows(name: str, what: str, t: torch.Tensor, device,
                ndim: int) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: {what} must lie on one CUDA device, got "
                         f"{t.device}")
    if t.dtype not in _STORAGE:
        raise ValueError(f"{name}: {what} must be float32 or bfloat16, got "
                         f"{t.dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous {ndim}-D "
                         f"tensor, got shape {tuple(t.shape)}")


def _check_table(name: str, t: torch.Tensor, device, shape) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: tables must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: table of shape {tuple(t.shape)} where "
                         f"{tuple(shape)} is needed (contiguous)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def frames_supported(nfft: int) -> bool:
    """Is nfft inside K13's and K15's envelope: 2 <= nfft <= 1024 with a stage
    length (nfft/2, or odd nfft) whose prime factors are <= 127, as for K7
    (``real_fft.supported``)? The primes 131 to 1021, and 262 = 2 x 131,
    are not."""
    nfft = int(nfft)
    return (2 <= nfft <= MAX_FRAME_NFFT
            and real_fft.supported(nfft, torch.float32))


def _detrend_kind(detrend) -> int:
    if callable(detrend) or detrend not in DETRENDS:
        raise ValueError(f"stft_frames: detrend must be False, None, "
                         f"'constant' or 'linear', got {detrend!r}")
    return DETRENDS[detrend]


def _check_frames(x: torch.Tensor, nperseg: int, nfft: int, hop: int,
                  nseg: int, name: str = "stft_frames") -> None:
    if not 1 <= nperseg <= nfft:
        raise ValueError(f"{name}: nperseg {nperseg} must be in "
                         f"[1, nfft = {nfft}]")
    if hop < 1 or nseg < 1 or (nseg - 1) * hop + nperseg > x.shape[-1]:
        raise ValueError(
            f"{name}: {nseg} frames of {nperseg} at hop {hop} do not "
            f"fit a signal of {x.shape[-1]}")


def _check_envelope(name: str, nfft: int) -> None:
    if not frames_supported(nfft):
        raise ValueError(
            f"{name}: nfft {nfft} is outside the kernel's envelope (2 <= "
            f"nfft <= {MAX_FRAME_NFFT}, stage length nfft/2 or odd nfft "
            f"with prime factors <= {minor_fft.MAX_PRIME})")


def _frame_launch_args(nfft: int, device):
    """The stage and half-length twiddle tables and the radices of K13's
    and K15's stage length (nfft/2, or odd nfft)."""
    tw, half, _, _ = real_fft._launch_args(nfft, False, device)
    rad = minor_fft.radices(nfft // 2 if nfft % 2 == 0 else nfft)
    return tw, half, (ctypes.c_int * max(len(rad), 1))(*rad), len(rad)


def stft_frames(x: torch.Tensor, win: torch.Tensor, cr: torch.Tensor,
                ci: torch.Tensor, nfft: int, detrend, hop: int,
                nseg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The spectra of frames s = 0..nseg-1 of the rows of ``x`` (batch,
    n_sig), frame s = x[:, s hop : s hop + nperseg]: detrended (``detrend``
    False/None, "constant" or "linear"), times the real window ``win``
    (nperseg), zero-padded to ``nfft``, the real DFT's nfft/2 + 1 bins,
    each times ``cr + i ci``: the (batch, nseg, nfft/2 + 1) f32 planes
    (K13).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream and raise on anything it does not take."""
    nfft, hop, nseg = int(nfft), int(hop), int(nseg)
    kind = _detrend_kind(detrend)
    if all(t.device.type == "cpu" for t in (x, win, cr, ci)):
        return stft_frames_reference(x, win, cr, ci, nfft, detrend, hop,
                                     nseg)
    name = "stft_frames"
    _check_rows(name, "the signal", x, x.device, 2)
    nperseg, m1 = win.shape[0], nfft // 2 + 1
    _check_table(name, win, x.device, (nperseg,))
    for t in (cr, ci):
        _check_table(name, t, x.device, (m1,))
    _check_frames(x, nperseg, nfft, hop, nseg)
    _check_envelope(name, nfft)
    batch, n_sig = x.shape
    yr = x.new_empty((batch, nseg, m1), dtype=torch.float32)
    yi = torch.empty_like(yr)
    if batch == 0:
        return yr, yi
    lib = _build.load()
    with torch.cuda.device(x.device):
        tw, half, rad_arr, nstages = _frame_launch_args(nfft, x.device)
        err = lib.tpufft_stft_frames(
            x.data_ptr(), win.data_ptr(), cr.data_ptr(), ci.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), tw.data_ptr(), half.data_ptr(),
            batch, n_sig, hop, nseg, nperseg, nfft, kind, rad_arr, nstages,
            int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches["stft"] += 1
    return yr, yi


def istft_ola(zr: torch.Tensor, zi: torch.Tensor, ar: torch.Tensor,
              ai: torch.Tensor, hop: int) -> torch.Tensor:
    """The overlap-add of every segment's ``zr @ ar + zi @ ai``: spectrum
    planes (batch, nseg, m1) and an (m1, nperseg) table with nperseg a
    multiple of ``hop`` -> (batch, (nseg - 1) hop + nperseg) f32,
    unnormalised (K14).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if all(t.device.type == "cpu" for t in (zr, zi, ar, ai)):
        return istft_ola_reference(zr, zi, ar, ai, hop)
    name = "istft_ola"
    for t in (zr, zi):
        _check_rows(name, "the spectrum planes", t, zr.device, 3)
    if zi.shape != zr.shape or zi.dtype != zr.dtype:
        raise ValueError(f"{name}: planes of different shapes or dtypes")
    batch, nseg, m1 = zr.shape
    nperseg = ar.shape[1]
    for t in (ar, ai):
        _check_table(name, t, zr.device, (m1, nperseg))
    if hop < 1 or nperseg % hop:
        raise ValueError(f"{name}: nperseg {nperseg} is not a multiple of "
                         f"hop {hop}")
    out = zr.new_empty((batch, (nseg - 1) * hop + nperseg),
                       dtype=torch.float32)
    if batch == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(zr.device):
        err = lib.tpufft_istft_ola(
            zr.data_ptr(), zi.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            out.data_ptr(), batch, nseg, hop, nperseg, m1,
            int(zr.dtype == torch.bfloat16), _stream(zr))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches["istft"] += 1
    return out


def welch_accum(x: torch.Tensor, win: torch.Tensor, nfft: int, detrend,
                hop: int, y: torch.Tensor | None = None):
    """The sum over the frames s of ``x`` (batch, n_sig), frame s = x[:,
    s hop : s hop + nperseg], of |X_s|^2, X_s the frame detrended
    (``detrend`` False/None, "constant" or "linear"), times the real window
    ``win`` (nperseg), zero-padded to ``nfft`` and real-DFT'd (K13's
    spectrum with c = 1): (batch, nfft/2 + 1) f32 (welch). With ``y`` (the
    same shape and dtype), the sum of conj(X_s) Y_s as its (re, im) planes
    (csd). The per-frame spectra never reach device memory (K15).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream and raise on anything it does not take."""
    nfft, hop = int(nfft), int(hop)
    kind = _detrend_kind(detrend)
    ts = (x, win) if y is None else (x, y, win)
    if all(t.device.type == "cpu" for t in ts):
        return welch_accum_reference(x, win, nfft, detrend, hop, y)
    name = "welch_accum"
    _check_rows(name, "the signal", x, x.device, 2)
    if y is not None:
        _check_rows(name, "the second signal", y, x.device, 2)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"{name}: signals of different shapes or "
                             "dtypes")
    nperseg, m1 = win.shape[0], nfft // 2 + 1
    _check_table(name, win, x.device, (nperseg,))
    batch, n_sig = x.shape
    nseg = _nseg(n_sig, nperseg, hop)
    _check_frames(x, nperseg, nfft, hop, nseg, name)
    _check_envelope(name, nfft)
    cross = y is not None
    outr = x.new_empty((batch, m1), dtype=torch.float32)
    outi = torch.empty_like(outr) if cross else None
    if batch == 0:
        return (outr, outi) if cross else outr
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load()
    with torch.cuda.device(x.device):
        floats = lib.tpufft_welch_partial_floats(batch, hop, nseg, nperseg,
                                                 nfft, int(cross), bf16)
        if floats < 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {-floats}")
        part = x.new_empty(floats, dtype=torch.float32)
        tw, half, rad_arr, nstages = _frame_launch_args(nfft, x.device)
        err = lib.tpufft_welch_frames(
            x.data_ptr(), y.data_ptr() if cross else None, win.data_ptr(),
            part.data_ptr(), outr.data_ptr(),
            outi.data_ptr() if cross else None, tw.data_ptr(),
            half.data_ptr(), batch, n_sig, hop, nseg, nperseg, nfft, kind,
            rad_arr, nstages, int(cross), bf16, _stream(x))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches["csd" if cross else "welch"] += 1
    return (outr, outi) if cross else outr


# ----------------------------------------------------------------------------
# Plain versions: torch ops in f32 (on a GPU this assumes
# torch.backends.cuda.matmul.allow_tf32 is False, PyTorch's default)
# ----------------------------------------------------------------------------

def _count(t: torch.Tensor) -> None:
    global reference_cuda_calls
    if t.is_cuda:
        reference_cuda_calls += 1


def _frames(x: torch.Tensor, nperseg: int, hop: int) -> torch.Tensor:
    """(batch, nseg, nperseg) f32 view of the frames of x's rows."""
    nseg = _nseg(x.shape[-1], nperseg, hop)
    return x.float().unfold(-1, nperseg, hop)[:, :nseg]


def frame_matrix(win, c, nfft: int, detrend) -> np.ndarray:
    """K13's function as one (nperseg, nfft/2 + 1) complex f64 matrix,
    M = D diag(win) V diag(c): D the detrend projector (I, I - 11^T/n or
    I - A pinv(A) with A = [1, j - (n-1)/2]), V the DFT's first nperseg
    rows and nfft/2 + 1 columns (host f64 trig). The callers' tables
    (``spectral._stft_matrix`` times the scale, ``ShortTimeFFT.
    _fused_stft_matrix``) are this matrix for their window and c."""
    win = np.asarray(win, np.float64)
    c = np.asarray(c, np.complex128)
    nperseg = win.shape[0]
    j = np.arange(nperseg, dtype=np.float64)
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    M = win[:, None] * np.exp((-2j * np.pi / nfft) * np.outer(j, k))
    kind = _detrend_kind(detrend)
    if kind == 1:
        M = M - M.mean(axis=0)[None, :]
    elif kind == 2:
        A = np.stack([np.ones(nperseg), j - (nperseg - 1) / 2.0], axis=1)
        M = M - A @ (np.linalg.pinv(A) @ M)
    return M * c[None, :]


def stft_frames_reference(x, win, cr, ci, nfft: int, detrend, hop: int,
                          nseg: int):
    """Plain PyTorch version of :func:`stft_frames`: :func:`frame_matrix`
    built on the host in f64 from the same arguments, then ``unfold`` and
    two f32 matmuls; any device. It shares no code with the kernel's FFT."""
    _count(x)
    nfft, hop, nseg = int(nfft), int(hop), int(nseg)
    nperseg = win.shape[0]
    _check_frames(x, nperseg, nfft, hop, nseg)

    def host(t):
        return t.detach().double().cpu().numpy()

    M = frame_matrix(host(win), host(cr) + 1j * host(ci), nfft, detrend)
    f = x.float().unfold(-1, nperseg, hop)[:, :nseg]
    mr = torch.as_tensor(M.real, dtype=torch.float32, device=x.device)
    mi = torch.as_tensor(M.imag, dtype=torch.float32, device=x.device)
    return f @ mr, f @ mi


def istft_ola_reference(zr, zi, ar, ai, hop: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`istft_ola`: per-segment matmuls,
    then an ``index_add_`` overlap-add; any device."""
    _count(zr)
    batch, nseg, _ = zr.shape
    nperseg = ar.shape[1]
    if nperseg % hop:
        raise ValueError(f"nperseg {nperseg} is not a multiple of hop {hop}")
    seg = zr.float() @ ar + zi.float() @ ai          # (batch, nseg, nperseg)
    idx = (torch.arange(nperseg, device=zr.device)[None, :]
           + hop * torch.arange(nseg, device=zr.device)[:, None]).reshape(-1)
    out = seg.new_zeros((batch, (nseg - 1) * hop + nperseg))
    return out.index_add_(1, idx, seg.reshape(batch, -1))


def welch_accum_reference(x, win, nfft: int, detrend, hop: int, y=None):
    """Plain PyTorch version of :func:`welch_accum`: :func:`frame_matrix`
    with c = 1, built on the host in f64 from the same arguments, then
    ``unfold``, two f32 matmuls, and the square (or conjugate product)
    summed over frames; any device. It shares no code with the kernel's
    FFT."""
    _count(x)
    nfft, hop = int(nfft), int(hop)
    nperseg = win.shape[0]
    M = frame_matrix(win.detach().double().cpu().numpy(),
                     np.ones(nfft // 2 + 1), nfft, detrend)
    mr = torch.as_tensor(M.real, dtype=torch.float32, device=x.device)
    mi = torch.as_tensor(M.imag, dtype=torch.float32, device=x.device)
    fx = _frames(x, nperseg, hop)
    xr, xi = fx @ mr, fx @ mi
    if y is None:
        return (xr * xr + xi * xi).sum(1)
    fy = _frames(y, nperseg, hop)
    yr, yi = fy @ mr, fy @ mi
    return (xr * yr + xi * yi).sum(1), (xr * yi - xi * yr).sum(1)

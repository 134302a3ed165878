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
  segment's Zr Ar + Zi Ai with A (m1, nperseg), unnormalised. tpufft's A
  is the inverse onesided DFT of c Z (a per-bin complex factor c)
  truncated to nperseg times a real window; the port's kernel takes the
  window, c and nfft (:func:`istft_frames`; the matrix, built by
  :func:`synthesis_matrix`, stays with the callers' backward, the plain
  version and the dense body, :func:`istft_ola`);
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
odd nfft, has prime factors <= 127). All three are bound by device-memory
bytes on the H100. K14 has two forms (:func:`istft_form`): at nfft = 256,
512 and 1024 the line form, the inverse-real line core of
``csrc/real_fft.cuh`` (K8's: the tangle of a segment's bins times c,
K1's inverse four-step at nfft/2 in registers) with the window applied to
pass 2's pairs and the overlap-add in the block (a block takes a run of
output chunks and the segments that touch them, in waves; each output
sample is owned by one thread, which sums its segments in order and
writes it once); at every other nfft the dense body, the product with
:func:`synthesis_matrix` on the FMA tile loop of ``csrc/tile_mm.cuh``
that K10's FMA body shares, which the FP32 peak bounds. Frames are never
materialised on the kernel path. Signals and spectra may be f32
or bf16 (computed in f32); tables and results are f32. The TPU kernels'
segment-major (nseg, batch, m1) layout and segment groups exist for
Mosaic's block rule and the MXU's 128 rows, and have no counterpart here:
the kernels read and write the layouts their callers use.

A CPU tensor runs the plain version (``unfold`` and two ``torch.matmul``
with the f64-built matrix; per-segment matmuls with the f64-built
synthesis matrix and an ``index_add_`` overlap-add; the first with c = 1
then the square and sum); a CUDA tensor
launches the kernel or raises, never falls back.
``launches["stft"|"istft"|"welch"|"csd"]`` count launches;
``reference_cuda_calls`` counts runs of the plain versions on CUDA
tensors, which the main path never makes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np
import torch

from .. import _build
from . import dense_mm, minor_fft, real_fft

__all__ = [
    "DETRENDS",
    "frame_matrix",
    "frames_supported",
    "istft_form",
    "istft_frames",
    "istft_frames_reference",
    "istft_ola",
    "istft_ola_reference",
    "launches",
    "reference_cuda_calls",
    "reset_counts",
    "stft_frames",
    "stft_frames_reference",
    "synthesis_matrix",
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


def istft_form(nfft: int) -> str:
    """Which body of K14 runs at nfft: ``"lines"`` (the line form, an
    inverse real FFT of each segment in registers and the overlap-add in
    the block) for nfft = 256, 512 and 1024, ``"dense"`` (the product with
    the host-built :func:`synthesis_matrix` on the f32 FMA tile loop) for
    every other nfft. Mirrors ``tpufft_istft_line_form`` in
    ``csrc/stft_mm.cu``, which makes the choice at the launch."""
    nfft = int(nfft)
    return "lines" if nfft in (256, 512, 1024) else "dense"


def _synthesis_tables(win, cr, ci, nfft: int):
    """The dense body's operands for (win, c, nfft): the f32 planes of
    :func:`synthesis_matrix` on win's device, built on the host in f64
    from the operands' values (a device-to-host copy) and uploaded once per
    value and device. The callers pass theirs (``matrix``) instead."""
    ops = torch.cat([win, cr, ci]).detach().double().cpu().numpy()
    key = ("synthesis", hashlib.sha1(ops.tobytes()).hexdigest(), nfft)
    nperseg, m1 = win.shape[0], nfft // 2 + 1

    @functools.cache
    def host():
        return synthesis_matrix(ops[:nperseg], ops[nperseg:nperseg + m1]
                                + 1j * ops[nperseg + m1:], nfft)

    return tuple(dense_mm.device_table(key + (part,),
                                       lambda p=part: getattr(host(), p),
                                       win.device)
                 for part in ("real", "imag"))


def istft_frames(zr: torch.Tensor, zi: torch.Tensor, win: torch.Tensor,
                 cr: torch.Tensor, ci: torch.Tensor, nfft: int, hop: int,
                 matrix=None) -> torch.Tensor:
    """The overlap-add of every segment's inverse: spectrum planes (batch,
    nseg, nfft/2 + 1), each segment's bins times ``cr + i ci``, inverse
    real-FFT'd at ``nfft`` (numpy's ``irfft``: 1/nfft, the imaginary parts
    at DC and Nyquist ignored), its first nperseg samples times the real
    window ``win`` (nperseg, a multiple of ``hop``), added at s hop ->
    (batch, (nseg - 1) hop + nperseg) f32, unnormalised (K14).

    CPU tensors run the plain version; CUDA tensors launch the body of
    :func:`istft_form` on the current stream or raise. The dense body takes
    ``matrix()``, the f32 planes (ar, ai) of :func:`synthesis_matrix` on
    the device, where the caller gives it (the callers' backward shares
    it), else builds them from the operands."""
    nfft, hop = int(nfft), int(hop)
    if all(t.device.type == "cpu" for t in (zr, zi, win, cr, ci)):
        return istft_frames_reference(zr, zi, win, cr, ci, nfft, hop)
    name = "istft_frames"
    for t in (zr, zi):
        _check_rows(name, "the spectrum planes", t, zr.device, 3)
    if zi.shape != zr.shape or zi.dtype != zr.dtype:
        raise ValueError(f"{name}: planes of different shapes or dtypes")
    batch, nseg, m1 = zr.shape
    nperseg = win.shape[0]
    if m1 != nfft // 2 + 1:
        raise ValueError(f"{name}: planes of {m1} bins for nfft {nfft}")
    _check_table(name, win, zr.device, (nperseg,))
    for t in (cr, ci):
        _check_table(name, t, zr.device, (m1,))
    if not 2 <= nfft <= MAX_FRAME_NFFT or not 1 <= nperseg <= nfft:
        raise ValueError(f"{name}: nfft {nfft} and nperseg {nperseg} must "
                         f"satisfy nperseg <= nfft <= {MAX_FRAME_NFFT}")
    if hop < 1 or nperseg % hop:
        raise ValueError(f"{name}: nperseg {nperseg} is not a multiple of "
                         f"hop {hop}")
    out = zr.new_empty((batch, (nseg - 1) * hop + nperseg),
                       dtype=torch.float32)
    if batch == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(zr.device):
        if istft_form(nfft) == "dense":
            ar, ai = (matrix() if matrix is not None
                      else _synthesis_tables(win, cr, ci, nfft))
            for t in (ar, ai):
                _check_table(name, t, zr.device, (m1, nperseg))
            tables = (None, None, ar.data_ptr(), ai.data_ptr())
        else:
            tw = minor_fft._device_twiddles(nfft // 2, True, zr.device)
            half = real_fft._device_half_twiddle(nfft, zr.device)
            tables = (tw.data_ptr(), half.data_ptr(), None, None)
        err = lib.tpufft_istft_frames(
            zr.data_ptr(), zi.data_ptr(), win.data_ptr(), cr.data_ptr(),
            ci.data_ptr(), *tables, out.data_ptr(), batch, nseg, hop,
            nperseg, nfft, int(zr.dtype == torch.bfloat16), _stream(zr))
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


def synthesis_matrix(win, c, nfft: int) -> np.ndarray:
    """K14's function as one (nfft/2 + 1, nperseg) complex f64 matrix A
    with segment = Zr @ A.real + Zi @ A.imag: A[k, t] = (d_k / nfft)
    conj(c_k) win[t] exp(-2 pi i k t / nfft), d the Hermitian doubling (1
    at DC and, even nfft, Nyquist; 2 elsewhere) (host f64 trig). Its
    segment is win[t] times numpy's irfft of c Z at t < nperseg. The
    callers' tables (``spectral._istft_matrix``, ``ShortTimeFFT.
    _fused_istft_matrix``) are this matrix for their window and c."""
    win = np.asarray(win, np.float64)
    c = np.asarray(c, np.complex128)
    m1 = nfft // 2 + 1
    d = np.full(m1, 2.0)
    d[0] = 1.0
    if nfft % 2 == 0:
        d[-1] = 1.0
    k = np.arange(m1, dtype=np.float64)
    t = np.arange(win.shape[0], dtype=np.float64)
    theta = (2.0 * np.pi / nfft) * np.outer(k, t)
    scale = ((d / nfft) * np.conj(c))[:, None] * win[None, :]
    return scale * np.exp(-1j * theta)


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


def istft_frames_reference(zr, zi, win, cr, ci, nfft: int, hop: int):
    """Plain PyTorch version of :func:`istft_frames`:
    :func:`synthesis_matrix` built on the host in f64 from the same
    arguments, then :func:`istft_ola_reference`'s per-segment matmuls and
    ``index_add_`` overlap-add; any device. It shares no code with the
    kernel's FFT."""
    def host(t):
        return t.detach().double().cpu().numpy()

    A = synthesis_matrix(host(win), host(cr) + 1j * host(ci), int(nfft))
    ar = torch.as_tensor(A.real, dtype=torch.float32, device=zr.device)
    ai = torch.as_tensor(A.imag, dtype=torch.float32, device=zr.device)
    return istft_ola_reference(zr, zi, ar, ai, hop)


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

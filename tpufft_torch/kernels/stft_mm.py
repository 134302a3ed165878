"""The short-time Fourier kernels: the CUDA kernels, their wrappers, and
their plain PyTorch versions.

Counterparts of three Pallas TPU kernels of ``tpufft/kernels/mxu_fft.py``,
each a product of a signal's overlapping frames with one matrix built on
the host (``spectral._stft_matrix``, ``_istft_matrix`` and the
``ShortTimeFFT`` matrices fold detrend, window, zero-pad, DFT and scale):

* ``build_stft_overlap`` (K13): real signal (batch, n_sig) -> spectrum
  planes (batch, nseg, m1), frame s = x[:, s hop : s hop + nperseg] times
  the complex (nperseg, m1) matrix: :func:`stft_frames`;
* ``build_istft_ola`` (K14): spectrum planes (batch, nseg, m1) ->
  (batch, (nseg + K - 1) hop), K = nperseg / hop, the overlap-add of each
  segment's Zr Ar + Zi Ai with A (m1, nperseg), unnormalised:
  :func:`istft_ola`;
* ``build_welch_accum`` (K15): the sum over segments of |F_s M|^2, or of
  conj(F_s M) (G_s M) as two planes for two signals: :func:`welch_accum`.

One CUDA source (``csrc/stft_mm.cu``, on the tile loop of
``csrc/tile_mm.cuh`` that K10-K12 share) serves all three with f32 FMA (no
TF32). Frames are never materialised on the kernel path. Signals and
spectra may be f32 or bf16 (computed in f32); matrices and results are f32.
The TPU kernels' segment-major (nseg, batch, m1) layout and segment groups
exist for Mosaic's block rule and the MXU's 128 rows, and have no
counterpart here: the kernels read and write the layouts their callers use.

A CPU tensor runs the plain version (``unfold`` and two ``torch.matmul``;
per-segment matmuls and an ``index_add_`` overlap-add; the first then the
square and sum); a CUDA tensor launches the kernel or raises, never falls
back. ``launches["stft"|"istft"|"welch"|"csd"]`` count launches;
``reference_cuda_calls`` counts runs of the plain versions on CUDA
tensors, which the main path never makes.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = [
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


def stft_frames(x: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor,
                hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Frames of the rows of ``x`` (batch, n_sig) times ``mr + i mi``
    (nperseg, m1): the (batch, nseg, m1) f32 spectrum planes, nseg =
    1 + (n_sig - nperseg) // hop (K13).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream and raise on anything it does not take."""
    if all(t.device.type == "cpu" for t in (x, mr, mi)):
        return stft_frames_reference(x, mr, mi, hop)
    name = "stft_frames"
    _check_rows(name, "the signal", x, x.device, 2)
    nperseg, m1 = mr.shape
    for t in (mr, mi):
        _check_table(name, t, x.device, (nperseg, m1))
    batch, n_sig = x.shape
    nseg = _nseg(n_sig, nperseg, hop)
    yr = x.new_empty((batch, nseg, m1), dtype=torch.float32)
    yi = torch.empty_like(yr)
    if batch == 0:
        return yr, yi
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tpufft_stft_frames(
            x.data_ptr(), mr.data_ptr(), mi.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), batch, n_sig, hop, nseg, nperseg, m1,
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


def welch_accum(x: torch.Tensor, mr: torch.Tensor, mi: torch.Tensor,
                hop: int, y: torch.Tensor | None = None):
    """The sum over the frames of ``x`` (batch, n_sig) of |F M|^2, M =
    ``mr + i mi`` (nperseg, m1): (batch, m1) f32 (welch). With ``y`` (the
    same shape and dtype), the sum of conj(F_x M) (F_y M) as its (re, im)
    planes (csd). The per-segment spectra never reach device memory
    (K15).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    ts = (x, mr, mi) if y is None else (x, y, mr, mi)
    if all(t.device.type == "cpu" for t in ts):
        return welch_accum_reference(x, mr, mi, hop, y)
    name = "welch_accum"
    _check_rows(name, "the signal", x, x.device, 2)
    if y is not None:
        _check_rows(name, "the second signal", y, x.device, 2)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"{name}: signals of different shapes or "
                             "dtypes")
    nperseg, m1 = mr.shape
    for t in (mr, mi):
        _check_table(name, t, x.device, (nperseg, m1))
    batch, n_sig = x.shape
    nseg = _nseg(n_sig, nperseg, hop)
    cross = y is not None
    outr = x.new_empty((batch, m1), dtype=torch.float32)
    outi = torch.empty_like(outr) if cross else None
    if batch == 0:
        return (outr, outi) if cross else outr
    lib = _build.load()
    part = x.new_empty(lib.tpufft_welch_partial_floats(batch, nseg, m1,
                                                        int(cross)),
                       dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.tpufft_welch_accum(
            x.data_ptr(), y.data_ptr() if cross else None, mr.data_ptr(),
            mi.data_ptr(), part.data_ptr(), outr.data_ptr(),
            outi.data_ptr() if cross else None, batch, n_sig, hop, nseg,
            nperseg, m1, int(cross), int(x.dtype == torch.bfloat16),
            _stream(x))
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


def stft_frames_reference(x, mr, mi, hop: int):
    """Plain PyTorch version of :func:`stft_frames`: ``unfold`` and two
    matmuls; any device."""
    _count(x)
    f = _frames(x, mr.shape[0], hop)
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


def welch_accum_reference(x, mr, mi, hop: int, y=None):
    """Plain PyTorch version of :func:`welch_accum`: the plain STFT, then
    the square (or conjugate product) summed over segments; any device."""
    _count(x)
    fx = _frames(x, mr.shape[0], hop)
    xr, xi = fx @ mr, fx @ mi
    if y is None:
        return (xr * xr + xi * xi).sum(1)
    fy = _frames(y, mr.shape[0], hop)
    yr, yi = fy @ mr, fy @ mi
    return (xr * yr + xi * yi).sum(1), (xr * yi - xi * yr).sum(1)

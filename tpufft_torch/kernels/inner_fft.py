"""Batched C2C FFT along a strided (non-minor) axis: the CUDA kernel, its
two wrappers, and their plain PyTorch versions.

Counterpart of two Pallas TPU kernels of ``tpufft/kernels/mxu_fft.py``:

* ``_build_inner`` (K2), the middle axis of (pre, n, L) planes with L
  contiguous: :func:`fft_inner`;
* ``_build_inner_nd`` (K3), dim 0 of (pre*n, M, L) planes in groups of n,
  optionally multiplied by an (n, M) complex twiddle before the store
  (``with_tw``, pass 1 of the two-pass split): :func:`fft_inner_nd`; with
  the twiddle and ``swap=True`` it stores the (pre, M, n, L) order instead,
  the digit swap of the two-pass split folded into its store (tpufft swaps
  the digits in a copy after pass 2).

Without the TPU's lane tiling both views are the same memory, (pre, n,
post) with post = M*L contiguous, so one CUDA kernel
(``csrc/strided_fft.cu``) serves both; each wrapper counts its own
launches. The contract is the minor-axis kernel's: f32 or bf16 storage,
f32 arithmetic, a forward/inverse flag, one real scale applied once at the
store, the same length envelope (``minor_fft.supported``) and the same
host-f64 twiddle table.

The kernel has three forms; :func:`form` names the line forms
``"lines"``. The line form (``csrc/strided_line.cuh``) takes n = r 2^a
for r in {1, 3, 5} from 8 to 2048 and r = 15 from 30 to 1920, and 25, 93
and 1080, when post holds at least 8 f32 (16 bf16) columns and the block
stays within the launch bound (bf16 up to n = 1024): blocks of at least C
n / 32 lanes keep each column's line in registers, lanes on consecutive
columns, through one shared-memory tile between the two passes of a
four-step n = N1 N2 (one line a lane without a tile for n <= 32). The
cluster line form (``csrc/strided_long.cuh``) takes the longer lengths of
its lists, f32 2160, 2560, 3072, 3840 and 4096 to 16384 (K1's
three-factor lengths) and bf16 those and 1080 to 2048, on at least 8 f32
(16 bf16) columns: a three-factor four-step n = N1 N2 N3 whose tile of
a unit of 16 columns is spread over a thread-block cluster of Q blocks,
pass 1 writing into the owners' tiles through distributed shared memory
(:func:`line_geometry` gives either form's geometry). The lines of both
run the shared generic-radix DFT of ``csrc/lane_dft.cuh``. Every other
launch (a prime factor above 31, a length on no list such as 2880 or
4100) runs the stage form, the Stockham stages in shared memory;
``stages=True`` forces it at every length, kept to compare the forms.

The swapped store (``fft_inner_nd(..., twiddle=tw, swap=True)``, pass 1
of the two-pass split) runs the same forms with their kSwap
instantiations. Where L divides C, the line form restages a unit's
outputs through its tile where pass 2 of its four-step takes one round
(n = 480, 960, 1024, 1280, 1536, 1920, 2048), and the cluster form over
its cluster where pass 3 holds all its lines at once (1920, 2048, 3840,
4096, 7680, 8192, 15360, 16384), so that consecutive lanes store each
column's run; elsewhere, and in the stage form, outputs are stored
straight from registers (a swapped launch at n <= 32 runs the stage
form).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises, never falls back. ``launches`` counts kernel launches per wrapper;
``reference_cuda_calls`` counts runs of the plain versions on CUDA
tensors, which the main path never makes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import minor_fft

__all__ = [
    "fft_inner",
    "fft_inner_nd",
    "fft_inner_nd_reference",
    "fft_inner_reference",
    "form",
    "launches",
    "line_geometry",
    "reference_cuda_calls",
    "reset_counts",
]

launches = {"inner": 0, "inner_nd": 0}
reference_cuda_calls = 0


@functools.lru_cache(maxsize=None)
def _line_geometry(n: int, post: int, bf16: bool) -> dict | None:
    lib = _build.load()
    out = (ctypes.c_int * 7)()
    kind = lib.tpufft_strided_line_geometry(n, post, int(bf16), out)
    if kind == 0:
        return None
    n1, n2, cols, threads, smem, n3, q = out
    if kind == 2:
        return {"n1": n1, "n2": n2, "n3": n3, "q": q, "cols": cols,
                "threads": threads, "smem": smem}
    return {"n1": n1, "n2": n2, "cols": cols, "threads": threads,
            "pair": n2 > 32, "smem": smem}


def line_geometry(n: int, post: int, dtype) -> dict | None:
    """The line forms' geometry for (pre, n, post) planes in ``dtype``
    storage, as the launch computes it (``line_geometry`` in
    ``csrc/strided_line.cuh``, then ``cluster_geometry`` in
    ``csrc/strided_long.cuh``, read through the library, so it needs the
    CUDA toolkit). The line form: ``n1``, ``n2`` (the four-step; n2 = 1:
    one line a lane, no tile), ``cols`` (C, columns a unit: the widest of
    32, 16 and 8 whose block stays within the launch bound and whose
    columns within post), ``threads`` (a block), ``pair`` (pass 2's lines
    of 36 to 64 on lane pairs) and ``smem`` (bytes: the padded n-table and
    the tile of C n complex f32 values). The cluster form: ``n1``, ``n2``,
    ``n3`` (n = N1 N2 N3), ``q`` (blocks a cluster, each owning N1 / Q
    rows k1 of the unit's tile), ``cols`` (C = 16), ``threads`` and
    ``smem`` (bytes a block: the twiddle tables and its N1 / Q rows of N2
    N3 C tile values). None where the launch runs the stage form."""
    if not minor_fft.supported(n, dtype):
        return None
    geo = _line_geometry(int(n), int(post), dtype == torch.bfloat16)
    return None if geo is None else dict(geo)


def form(n: int, post: int, dtype) -> str | None:
    """Which form of the kernel transforms axis 1 of (pre, n, post) planes
    in ``dtype`` storage, as the launch picks it (``launch_sized`` in
    ``csrc/strided_fft.cu``, read through the library): ``"lines"`` for
    either line form (n = r 2^a, r in {1, 3, 5}, 8 <= n <= 2048, or r =
    15, 30 <= n <= 1920; 25, 93, 1080; bf16 up to n = 1024; and the
    cluster form's lists: f32 2160, 2560, 3072, 3840, 4096 to 16384 at
    K1's three-factor lengths, bf16 those and 1080 to 2048; post >= 8 f32
    or 16 bf16 columns), ``"stages"`` for the rest of the envelope, None
    outside it."""
    if not minor_fft.supported(n, dtype):
        return None
    return "stages" if line_geometry(n, post, dtype) is None else "lines"


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global reference_cuda_calls
    for k in launches:
        launches[k] = 0
    reference_cuda_calls = 0


def _launch(xr, xi, pre: int, n: int, post: int, inverse: bool,
            scale: float, twiddle=None, tw_l: int = 0, stages: bool = False,
            swap: bool = False):
    """The strided kernel on the (pre, n, post) view of contiguous planes,
    in the form :func:`form` names (the stage form with ``stages``); with
    ``swap`` (and a twiddle) the output planes are (pre, M, n, L)."""
    shape = (pre, post // tw_l, n, tw_l) if swap else xr.shape
    yr = xr.new_empty(shape)
    yi = xi.new_empty(shape)
    if xr.numel() == 0:
        return yr, yi, False
    lib = _build.load()
    rad = minor_fft.radices(n)
    rad_arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    tw_m = 0 if twiddle is None else twiddle.shape[1]
    with torch.cuda.device(xr.device):
        tw = minor_fft._device_twiddles(n, bool(inverse), xr.device)
        args = (
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw.data_ptr(), pre, n, post, rad_arr, len(rad),
            None if twiddle is None else twiddle.data_ptr(), tw_m, tw_l,
            int(bool(inverse)), float(scale),
            int(xr.dtype == torch.bfloat16))
        stream = torch.cuda.current_stream().cuda_stream
        if swap:
            err = lib.tpufft_strided_fft_swapped(*args, int(stages), stream)
        elif stages:
            err = lib.tpufft_strided_fft_stages(*args, stream)
        else:
            err = lib.tpufft_strided_fft(*args, stream)
    if err != 0:
        raise RuntimeError(f"strided_fft launch failed: CUDA error {err}")
    return yr, yi, True


def fft_inner(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
              scale: float, stages: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the middle axis of (pre, n, L) planes (K2).

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    :func:`form` on the current stream (``stages``: the stage form at every
    length, kept to compare the forms) and raise on anything it does not
    take."""
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_inner_reference(xr, xi, inverse=inverse, scale=scale)
    minor_fft.check_planes("fft_inner", xr, xi, 3)
    pre, n, post = xr.shape
    minor_fft.check_length("fft_inner", n)
    yr, yi, launched = _launch(xr, xi, pre, n, post, inverse, scale,
                               stages=stages)
    launches["inner"] += launched
    return yr, yi


def _check_twiddle(twiddle, n: int, M: int, xr) -> None:
    if (twiddle.shape != (n, M, 2) or twiddle.dtype != torch.float32
            or twiddle.device != xr.device or not twiddle.is_contiguous()):
        raise ValueError(
            f"fft_inner_nd: twiddle must be a contiguous float32 (n, M, 2) "
            f"= ({n}, {M}, 2) tensor on {xr.device}, got "
            f"{tuple(twiddle.shape)} {twiddle.dtype} on {twiddle.device}")


def _check_swap(swap: bool, twiddle) -> None:
    if swap and twiddle is None:
        raise ValueError("fft_inner_nd: swap=True needs the twiddle (it is "
                         "pass 1 of the two-pass split)")


def fft_inner_nd(xr: torch.Tensor, xi: torch.Tensor, *, n: int,
                 inverse: bool, scale: float,
                 twiddle: torch.Tensor | None = None, swap: bool = False,
                 stages: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform dim 0 of (pre*n, M, L) planes in groups of n (K3).

    ``twiddle``: None, or a float32 (n, M, 2) tensor of complex values
    (re, im) on the planes' device; output (k, m, l) of each group is
    multiplied by ``twiddle[k, m]`` before the scale. ``swap`` (with the
    twiddle): output (p, k, m, l) is stored at (p, m, k, l) of
    (pre, M, n, L) planes, the digit swap of the two-pass split. CPU tensors
    run the plain version; CUDA tensors launch the kernel of :func:`form`
    (``stages``: the stage form, kept to compare the forms) or raise."""
    _check_swap(swap, twiddle)
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_inner_nd_reference(xr, xi, n=n, inverse=inverse,
                                      scale=scale, twiddle=twiddle,
                                      swap=swap)
    minor_fft.check_planes("fft_inner_nd", xr, xi, 3)
    minor_fft.check_length("fft_inner_nd", n)
    pn, M, L = xr.shape
    if n < 1 or pn % n:
        raise ValueError(
            f"fft_inner_nd: dim 0 ({pn}) is not a multiple of n = {n}")
    if twiddle is not None:
        _check_twiddle(twiddle, n, M, xr)
    yr, yi, launched = _launch(xr, xi, pn // n, n, M * L, inverse, scale,
                               twiddle, L, stages=stages, swap=swap)
    launches["inner_nd"] += launched
    return yr, yi


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------

def _reference(xr, xi, n: int, inverse: bool, scale: float, twiddle=None):
    """(pre, n, post) planes in any storage dtype: the minor-axis plain
    version on the moved axis, f32 throughout, the twiddle (n, M, 2)
    broadcast over post = M*L, one rounding to the storage dtype."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    store = xr.dtype
    pre, _, post = xr.shape
    ar = xr.float().transpose(1, 2).reshape(-1, n)
    ai = xi.float().transpose(1, 2).reshape(-1, n)
    zr, zi = minor_fft.fft_minor_reference(
        ar, ai, inverse=inverse, scale=1.0 if twiddle is not None else scale)
    zr = zr.reshape(pre, post, n).transpose(1, 2)
    zi = zi.reshape(pre, post, n).transpose(1, 2)
    if twiddle is not None:
        reps = post // twiddle.shape[1]
        twr = twiddle[..., 0].repeat_interleave(reps, dim=1)
        twi = twiddle[..., 1].repeat_interleave(reps, dim=1)
        zr, zi = ((zr * twr - zi * twi) * scale,
                  (zr * twi + zi * twr) * scale)
    return zr.contiguous().to(store), zi.contiguous().to(store)


def fft_inner_reference(xr: torch.Tensor, xi: torch.Tensor, *,
                        inverse: bool, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fft_inner`: same contract, any
    device."""
    return _reference(xr, xi, xr.shape[1], inverse, scale)


def fft_inner_nd_reference(xr: torch.Tensor, xi: torch.Tensor, *, n: int,
                           inverse: bool, scale: float,
                           twiddle: torch.Tensor | None = None,
                           swap: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fft_inner_nd`: same contract, any
    device; ``swap`` permutes the natural result."""
    _check_swap(swap, twiddle)
    pn, M, L = xr.shape
    view = (pn // n, n, M * L)
    zr, zi = _reference(xr.reshape(view), xi.reshape(view), n, inverse,
                        scale, twiddle)
    if not swap:
        return zr.reshape(pn, M, L), zi.reshape(pn, M, L)
    split = (pn // n, n, M, L)
    return (zr.reshape(split).transpose(1, 2).contiguous(),
            zi.reshape(split).transpose(1, 2).contiguous())

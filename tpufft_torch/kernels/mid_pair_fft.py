"""Batched 2-D C2C FFT over the two middle axes of (pre, n1, n2, L) planes
(K6): the CUDA kernel, its wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_mid_pair``, the Pallas
TPU kernel that runs two adjacent middle axes in one pass; L is the
contiguous batch, as in ``fftn(axes=(1, 2))`` of a channels-last
(B, H, W, C) array. The contract is the pair kernel's: f32 or bf16
storage, f32 arithmetic, a forward/inverse flag and one real scale applied
once at the store.

The CUDA kernel (``csrc/cluster_fft.cu``) reads and writes the planes once
where two strided-axis passes would do it twice. A tile (n1, n2, lanes)
of contiguous elements of L is split along n1 over a thread-block cluster
of C blocks that exchange its n1-columns through distributed shared
memory; C, one of 1, 2, 4, 8, 16, divides n1 and leaves at most 16384
elements a block, and at most 2048 where it can (:func:`cluster_size`).
The ragged end of L is masked, never padded. It has three forms
(:func:`form` mirrors the launch's choice):

* ``"lines"``, ``mid_pair_line_kernel``, where n1 and n2 are powers of two
  from 2 to 128: tiles of ``LINE_LANES`` = 8 lanes of L (an f32 row is one
  32-byte sector), loaded into the block's tile; each n2 line (slab, lane)
  transformed in the registers of n2/V lanes of a warp that swap values by
  shuffles (``csrc/line_fft.cuh``) and written back in place; after the
  cluster barrier each lane group reads its n1-columns from the cluster's
  tiles, transforms them in registers and stores them from there. At
  (64, 128) a cluster of 16 blocks of 4096 elements (32 KB).
* ``"mixed"``, ``mid_mixed_kernel`` (``csrc/mid_line.cuh``), the same
  three steps on the same tile for every other pair of ``MIXED_LENGTHS``
  (r 2^a for r in 1, 3, 5, 7, 15 up to 240, and 256) whose tile fits a
  cluster at ``LINE_LANES``: a line of n = R P lies on P/V lanes of a warp,
  R V values a lane (at most 32); the R-point DFT runs first in registers
  over stride P, then the twiddle W_n^(p q) and the P-point sub-lines on
  the shuffle exchange (radix-2 stages across the lanes where a lane holds
  fewer values than the sub-line has lanes), every twiddle from the
  n-tables staged in shared memory. At (160, 160) a cluster of 16 blocks
  of 12800 elements (100 KB), two blocks an SM.
* ``"stages"``, ``mid_pair_fft_kernel``, every other pair (primes 11 to
  31, factors 9 and 25, an axis above 256, a tile that needs more than 16
  blocks at ``LINE_LANES`` such as (224, 224)): tiles of ``LANES`` = 4
  lanes, the shared Stockham stages
  over the block; a tile reads half of each 32-byte sector of a row (the
  tile beside it, run at the same time, reads the other half from L2). On
  the H100, 4 lanes ran faster than 8 and 2 on this form (PERF.md,
  tools/cluster_phases.py).

The envelope (:func:`supported`): n1, n2 >= 2, each inside the minor-axis
kernel's radix envelope, n1*n2 <= 65536 with such a C, any L >= 1.

``fft_mid_pair`` is the wrapper: a CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises. ``launches`` counts its
launches, ``reference_cuda_calls`` runs of the plain version on CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import minor_fft
from .cube_fft import MAX_SHARE, pick_cluster, stages_fit

__all__ = [
    "LANES",
    "LINE_LANES",
    "LINE_LENGTHS",
    "MIXED_LENGTHS",
    "active_clusters",
    "cluster_size",
    "fft_mid_pair",
    "fft_mid_pair_reference",
    "form",
    "lanes",
    "launches",
    "reference_cuda_calls",
    "reset_counts",
    "supported",
]

LANES = 4  # elements of L a stage-form tile takes: 16 bytes of f32
LINE_LANES = 8  # elements of L a line-form tile takes: 32 bytes of f32
LINE_LENGTHS = (2, 4, 8, 16, 32, 64, 128)  # axes of the line form
# axes of the generic-radix line form (TPUFFT_MID_* in csrc/mid_line.cuh)
MIXED_LENGTHS = tuple(sorted(
    {r << a for r in (1, 3, 5, 7, 15) for a in range(8) if r << a <= 240}
    - {1} | {256}))

launches = 0
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global launches, reference_cuda_calls
    launches = 0
    reference_cuda_calls = 0


def _geometry(n1: int, n2: int) -> tuple[str, int, int] | None:
    """(form, lanes of L a tile, cluster size) of the pair, or None without
    a cluster. Mirrors ``line_mid`` in ``csrc/cluster_fft.cu`` and
    ``mixed_pair`` in ``csrc/mid_line.cuh``: the line form where both axes
    are in ``LINE_LENGTHS`` and its cluster at ``LINE_LANES`` leaves an even
    number of n1-columns a block (they go in pairs); else the mixed form
    where both are in ``MIXED_LENGTHS`` and a cluster at ``LINE_LANES``
    fits; else the stage form at ``LANES``."""
    n1, n2 = int(n1), int(n2)
    if n1 in LINE_LENGTHS and n2 in LINE_LENGTHS:
        c = pick_cluster(n1, n2 * LINE_LANES)
        if c is not None and n2 * LINE_LANES // c % 2 == 0:
            return "lines", LINE_LANES, c
    elif n1 in MIXED_LENGTHS and n2 in MIXED_LENGTHS:
        c = pick_cluster(n1, n2 * LINE_LANES)
        if c is not None:
            return "mixed", LINE_LANES, c
    c = pick_cluster(n1, n2 * LANES)
    return None if c is None else ("stages", LANES, c)


def cluster_size(n1: int, n2: int) -> int | None:
    """Blocks a tile's cluster takes (``cube_fft.pick_cluster`` of n1 and
    n2 times the form's lanes); None outside the envelope."""
    g = _geometry(n1, n2)
    return None if g is None else g[2]


def lanes(n1: int, n2: int) -> int | None:
    """Elements of L a tile takes: ``LINE_LANES`` on the line forms,
    ``LANES`` on the stage form; None outside the envelope."""
    g = _geometry(n1, n2)
    return None if g is None else g[1]


def form(n1: int, n2: int, L: int) -> str | None:
    """Which form of the kernel transforms axes (1, 2) of (pre, n1, n2, L)
    planes: ``"lines"``, ``"mixed"`` or ``"stages"`` (see the module
    docstring); None outside the envelope (:func:`supported`). The launch
    makes the same choice (``line_mid`` in ``csrc/cluster_fft.cu``,
    ``mixed_pair`` in ``csrc/mid_line.cuh``); L sets neither the form nor
    the tile."""
    if not supported(n1, n2, L, torch.float32):
        return None
    return _geometry(n1, n2)[0]


def supported(n1: int, n2: int, L: int, dtype) -> bool:
    """Are the middle axes (n1, n2) of (pre, n1, n2, L) planes in storage
    ``dtype`` inside the kernel's envelope (n1*n2 <= 65536 with a cluster
    that splits n1 evenly)?"""
    n1, n2 = int(n1), int(n2)
    if not (n1 >= 2 and n2 >= 2 and int(L) >= 1
            and minor_fft.supported(n1, dtype)
            and minor_fft.supported(n2, dtype)):
        return False
    g = _geometry(n1, n2)
    if g is None:
        return False
    kind, lanes_, c = g
    if kind != "stages":
        return True
    share = n1 // c * n2 * lanes_
    return (stages_fit(n2, n1 // c * lanes_, share)
            and stages_fit(n1, share // n1, share))


@functools.lru_cache(maxsize=None)
def active_clusters(n1: int, n2: int, bf16: bool, device_index: int) -> int:
    """How many clusters of the kernel at this pair the card holds at once
    (``cudaOccupancyMaxActiveClusters``; needs the card)."""
    lib = _build.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.tpufft_mid_pair_active_clusters(
            n1, n2, lanes(n1, n2), cluster_size(n1, n2), int(bf16),
            ctypes.byref(out))
    if err != 0:
        raise RuntimeError(
            f"mid_pair_fft: cudaOccupancyMaxActiveClusters failed: CUDA "
            f"error {err}")
    return out.value


def _launch(xr, xi, inverse: bool, scale: float):
    pre, n1, n2, L = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if pre == 0 or L == 0:
        return yr, yi, False
    lib = _build.load()
    bf16 = xr.dtype == torch.bfloat16
    c = cluster_size(n1, n2)
    if active_clusters(n1, n2, bf16, xr.device.index or 0) == 0:
        raise RuntimeError(
            f"mid_pair_fft: cudaOccupancyMaxActiveClusters reports 0 "
            f"clusters of {c} blocks for the pair {(n1, n2)}: the card "
            "cannot hold one")
    rad1, rad2 = minor_fft.radices(n1), minor_fft.radices(n2)
    arr1 = (ctypes.c_int * len(rad1))(*rad1)
    arr2 = (ctypes.c_int * len(rad2))(*rad2)
    with torch.cuda.device(xr.device):
        tw1 = minor_fft._device_twiddles(n1, bool(inverse), xr.device)
        tw2 = minor_fft._device_twiddles(n2, bool(inverse), xr.device)
        err = lib.tpufft_mid_pair_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw1.data_ptr(), tw2.data_ptr(), pre, n1, n2, L, lanes(n1, n2),
            c, arr1, len(rad1), arr2, len(rad2), int(bool(inverse)),
            float(scale), int(bf16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mid_pair_fft launch failed: CUDA error {err}")
    return yr, yi, True


def fft_mid_pair(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
                 scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform axes 1 and 2 of the (pre, n1, n2, L) planes.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_mid_pair_reference(xr, xi, inverse=inverse, scale=scale)
    minor_fft.check_planes("mid_pair_fft", xr, xi, 4)
    _, n1, n2, L = xr.shape
    if not supported(n1, n2, max(int(L), 1), xr.dtype):
        raise ValueError(
            f"mid_pair_fft: pair {(n1, n2)} is outside the kernel's "
            f"envelope (n1, n2 >= 2, a cluster of at most 16 blocks of "
            f"<= {MAX_SHARE} elements, prime factors <= "
            f"{minor_fft.MAX_PRIME})")
    yr, yi, launched = _launch(xr, xi, inverse, scale)
    launches += launched
    return yr, yi


def fft_mid_pair_reference(xr: torch.Tensor, xi: torch.Tensor, *,
                           inverse: bool, scale: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the minor-axis plain version
    along n2, then n1, in f32, with one rounding to the storage dtype; any
    device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    return minor_fft.fft_axes_reference(xr, xi, (2, 1), inverse=inverse,
                                        scale=scale)

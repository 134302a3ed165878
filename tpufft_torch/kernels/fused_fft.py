"""The FFT kernels on fused storage (K16-K20): wrappers, counts, gates and
plain PyTorch versions.

Fused storage is the array of tpufft's ``layout="lane-fused"`` plans: ONE
real array whose last dim 2h holds ``[re(0..h-1) | im(0..h-1)]`` of a
logical complex row of length h. Counterparts of five Pallas TPU kernels of
``tpufft/kernels/mxu_fft.py``, which tpufft reaches only through such plans:

* ``_build_3d_fused`` (K16): the last three logical axes of
  (pre, n1, n2, 2*n3), :func:`fft_cube_fused`;
* ``_build_pair_fused`` (K17): the last two of (B, n2, 2*n3),
  :func:`fft_pair_fused`;
* ``_build_inner_fused`` (K18) and ``_build_inner_fused_m1`` (K19): axis 1
  of (pre, n, M, 2L), M > 1 and M == 1, :func:`fft_inner_fused`;
* ``_build_minor_fused`` (K20): the minor logical axis of (B, 2n),
  :func:`fft_minor_fused`.

On the H100 none of them is a new algorithm: each is one of the port's
Stockham kernels reading and writing fused storage through its two plane
pointers (``csrc/fft_stages.cuh``, ``fused_index``), with nothing else
changed: K16 is the cube kernel K5 (``csrc/cluster_fft.cu``), K17 the pair
kernel K4 (``csrc/pair_fft.cu``), K18 and K19 the strided kernel K2/K3
(``csrc/strided_fft.cu``, h = L) and K20 the minor-axis kernel K1
(``csrc/minor_fft.cuh``), in K1's form for the length (:func:`minor_form`:
the register line form at K1's line-form lengths, the Stockham stages
elsewhere); K18/K19 likewise run the strided kernel's form
(:func:`inner_form`: the column line forms at n = r 2^a, r in {1, 3, 5},
from 8 to 2048, and the cluster form's lengths above). The contract is
theirs: f32 or bf16 storage, f32 arithmetic, a forward/inverse flag, one
real scale applied once at the store. Each is bound by device-memory bandwidth like its sibling: it moves
the same bytes, in runs of h values a plane instead of whole rows.

The gates are the port's own envelopes, applied to the logical lengths:
``cube_fft.supported``, ``pair_fft.supported`` and ``minor_fft.supported``
(the strided kernel's is the minor one's). tpufft's TPU rules (dense-W
lengths <= 128, ``l2 % 128``, ``n3 % 64``, ``n2 % 8`` and the VMEM fits,
``mxu_fft.py:2270-2287``, ``:2350-2363``, ``:2392-2403``) do not apply.

A CPU tensor runs the plain version: the two halves through the
split-plane plain version of the sibling kernel, then concatenated. A CUDA
tensor launches the kernel or raises, never falls back. ``launches``
counts launches per kernel (``"cube"``, ``"pair"``, ``"inner"``,
``"inner_m1"``, ``"minor"``); ``reference_cuda_calls`` counts runs of the
plain versions on CUDA tensors, which the main path never makes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import cube_fft, inner_fft, minor_fft, pair_fft

__all__ = [
    "cube_supported",
    "fft_cube_fused",
    "fft_cube_fused_reference",
    "fft_inner_fused",
    "fft_inner_fused_reference",
    "fft_minor_fused",
    "fft_minor_fused_reference",
    "fft_pair_fused",
    "fft_pair_fused_reference",
    "inner_form",
    "inner_supported",
    "launches",
    "minor_form",
    "minor_supported",
    "pair_supported",
    "reference_cuda_calls",
    "reset_counts",
]

launches = {"cube": 0, "pair": 0, "inner": 0, "inner_m1": 0, "minor": 0}
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global reference_cuda_calls
    for k in launches:
        launches[k] = 0
    reference_cuda_calls = 0


# ----------------------------------------------------------------------------
# Gates: the port's envelopes on the logical lengths
# ----------------------------------------------------------------------------

def cube_supported(n1: int, n2: int, n3: int, dtype) -> bool:
    """Can K16 transform the logical (n1, n2, n3) cube? K5's envelope
    (``cube_fft.supported``: a cluster of at most 16 blocks of 16384
    elements, so at most 64^3); tpufft's VMEM rule does not apply."""
    return cube_fft.supported(n1, n2, n3, dtype)


def pair_supported(n2: int, n3: int, dtype) -> bool:
    """Can K17 transform the logical (n2, n3) pair? K4's envelope
    (``pair_fft.supported``: n2 * n3 <= 16384); tpufft's ``n2 % 8``,
    ``n3 % 64``, dense-W and VMEM rules do not apply."""
    return pair_fft.supported(n2, n3, dtype)


def inner_supported(n: int, dtype) -> bool:
    """Can K18/K19 transform a leading logical axis of length n? The
    strided kernel's envelope (``minor_fft.supported``), for any M and L;
    tpufft's dense-W and ``l2 % 128`` rules do not apply."""
    return minor_fft.supported(n, dtype)


def inner_form(n: int, M: int, L: int, dtype) -> str | None:
    """Which form of the strided kernel K18/K19 runs on axis 1 of the
    (pre, n, M, 2L) fused array: ``inner_fft.form`` of its M * L logical
    columns (``"lines"`` for either line form, n = r 2^a, r in {1, 3, 5},
    from 8 to 2048 and the cluster form's lengths above it, on at least 8
    f32 or 16 bf16 columns, ``"stages"`` for the rest of the envelope,
    None outside it)."""
    return inner_fft.form(n, M * L, dtype)


def minor_supported(n: int, dtype) -> bool:
    """Can K20 transform the minor logical axis of length n? K1's envelope
    (``minor_fft.supported``); tpufft's dense-W and ``n % 64`` rules do not
    apply."""
    return minor_fft.supported(n, dtype)


def minor_form(n: int) -> str | None:
    """Which form of K1's kernel K20 runs on a minor logical axis of length
    n: ``minor_fft.form`` (``"lines"`` for power-of-two n from 2 to 4096,
    K1's mixed-radix lengths and its three-factor lengths above 4096,
    ``"stages"`` for the rest of the envelope, None outside it)."""
    return minor_fft.form(n)


def _check(name: str, st: torch.Tensor, ranks: tuple[int, ...]) -> None:
    """Raise ValueError unless st is a contiguous float32 or bfloat16 array
    of one of ``ranks`` on a CUDA device, with an even last dim >= 2."""
    if st.device.type != "cuda":
        raise ValueError(f"{name}: the array must lie on a CUDA device, got "
                         f"{st.device}")
    if st.dtype not in minor_fft.STORAGE_DTYPES:
        raise ValueError(f"{name}: the array must be float32 or bfloat16, "
                         f"got {st.dtype}")
    if st.ndim not in ranks or st.shape[-1] < 2 or st.shape[-1] % 2:
        raise ValueError(
            f"{name}: the array must be rank {' or '.join(map(str, ranks))} "
            f"with an even last dim [re | im], got {tuple(st.shape)}")
    if not st.is_contiguous():
        raise ValueError(f"{name}: the array must be contiguous")


def _envelope(name: str, what, ok: bool) -> None:
    if not ok:
        raise ValueError(
            f"{name}: {what} is outside the kernel's envelope (prime factors "
            f"<= {minor_fft.MAX_PRIME}; see fused_fft's gates)")


def _radix_array(n: int):
    rad = minor_fft.radices(n)
    return (ctypes.c_int * max(len(rad), 1))(*rad), len(rad)


def _done(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ----------------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------------

def fft_cube_fused(st: torch.Tensor, *, inverse: bool,
                   scale: float) -> torch.Tensor:
    """Transform the last three logical axes of the (pre, n1, n2, 2*n3)
    fused array (K16).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    if st.device.type == "cpu":
        return fft_cube_fused_reference(st, inverse=inverse, scale=scale)
    name = "cube_fft_fused"
    _check(name, st, (4,))
    pre, n1, n2, l2 = st.shape
    n3 = l2 // 2
    _envelope(name, f"cube {(n1, n2, n3)}",
              cube_supported(n1, n2, n3, st.dtype))
    out = torch.empty_like(st)
    if pre == 0:
        return out
    bf16 = st.dtype == torch.bfloat16
    c = cube_fft.cluster_size(n1, n2, n3)
    if cube_fft.active_clusters(n1, n2, n3, bf16, st.device.index or 0,
                                fused=True) == 0:
        raise RuntimeError(
            f"{name}: cudaOccupancyMaxActiveClusters reports 0 clusters of "
            f"{c} blocks for the cube {(n1, n2, n3)}: the card cannot hold "
            "one")
    lib = _build.load()
    arrs = [_radix_array(n) for n in (n1, n2, n3)]
    with torch.cuda.device(st.device):
        tws = [minor_fft._device_twiddles(n, bool(inverse), st.device)
               for n in (n1, n2, n3)]
        err = lib.tpufft_cube_fft_fused(
            st.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tws), pre,
            n1, n2, n3, c, *(v for a in arrs for v in a),
            int(bool(inverse)), float(scale), int(bf16),
            torch.cuda.current_stream().cuda_stream)
    _done(name, err)
    launches["cube"] += 1
    return out


def fft_pair_fused(st: torch.Tensor, *, inverse: bool,
                   scale: float) -> torch.Tensor:
    """Transform the last two logical axes of the (B, n2, 2*n3) fused array
    (K17).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    if st.device.type == "cpu":
        return fft_pair_fused_reference(st, inverse=inverse, scale=scale)
    name = "pair_fft_fused"
    _check(name, st, (3,))
    B, n2, l2 = st.shape
    n3 = l2 // 2
    _envelope(name, f"pair {(n2, n3)}", pair_supported(n2, n3, st.dtype))
    out = torch.empty_like(st)
    if B == 0:
        return out
    lib = _build.load()
    (arr2, k2), (arr3, k3) = _radix_array(n2), _radix_array(n3)
    with torch.cuda.device(st.device):
        tw2 = minor_fft._device_twiddles(n2, bool(inverse), st.device)
        tw3 = minor_fft._device_twiddles(n3, bool(inverse), st.device)
        err = lib.tpufft_pair_fft_fused(
            st.data_ptr(), out.data_ptr(), tw2.data_ptr(), tw3.data_ptr(), B,
            n2, n3, arr2, k2, arr3, k3, int(bool(inverse)), float(scale),
            int(st.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _done(name, err)
    launches["pair"] += 1
    return out


def fft_inner_fused(st: torch.Tensor, *, inverse: bool,
                    scale: float) -> torch.Tensor:
    """Transform axis 1 of the (pre, n, M, 2L) fused array (K18; counted
    ``"inner_m1"`` as K19 when M == 1), or of a (pre, n, 2L) one (M = 1).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    if st.device.type == "cpu":
        return fft_inner_fused_reference(st, inverse=inverse, scale=scale)
    name = "inner_fft_fused"
    _check(name, st, (3, 4))
    pre, n = st.shape[:2]
    M = st.shape[2] if st.ndim == 4 else 1
    L = st.shape[-1] // 2
    _envelope(name, f"length {n}", inner_supported(n, st.dtype))
    if M * L > 2**31 - 1:
        raise ValueError(f"{name}: M * L = {M * L} columns exceed 2^31 - 1")
    out = torch.empty_like(st)
    if st.numel() == 0:
        return out
    lib = _build.load()
    arr, k = _radix_array(n)
    with torch.cuda.device(st.device):
        tw = minor_fft._device_twiddles(n, bool(inverse), st.device)
        err = lib.tpufft_strided_fft_fused(
            st.data_ptr(), out.data_ptr(), tw.data_ptr(), pre, n, M, L, arr,
            k, int(bool(inverse)), float(scale),
            int(st.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _done(name, err)
    launches["inner" if M > 1 else "inner_m1"] += 1
    return out


def fft_minor_fused(st: torch.Tensor, *, inverse: bool,
                    scale: float) -> torch.Tensor:
    """Transform the minor logical axis of the (B, 2n) fused array (K20).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    if st.device.type == "cpu":
        return fft_minor_fused_reference(st, inverse=inverse, scale=scale)
    name = "minor_fft_fused"
    _check(name, st, (2,))
    B, l2 = st.shape
    n = l2 // 2
    _envelope(name, f"length {n}", minor_supported(n, st.dtype))
    out = torch.empty_like(st)
    if B == 0:
        return out
    lib = _build.load()
    arr, k = _radix_array(n)
    with torch.cuda.device(st.device):
        tw = minor_fft._device_twiddles(n, bool(inverse), st.device)
        err = lib.tpufft_minor_fft_fused(
            st.data_ptr(), out.data_ptr(), tw.data_ptr(), B, n, arr, k,
            int(bool(inverse)), float(scale),
            int(st.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _done(name, err)
    launches["minor"] += 1
    return out


# ----------------------------------------------------------------------------
# Plain versions: the halves through the split-plane plain versions
# ----------------------------------------------------------------------------

def _halves(st: torch.Tensor):
    """The re and im halves of the fused array, contiguous; counts a run on
    a CUDA tensor."""
    global reference_cuda_calls
    if st.is_cuda:
        reference_cuda_calls += 1
    h = st.shape[-1] // 2
    return st[..., :h].contiguous(), st[..., h:].contiguous()


def fft_cube_fused_reference(st: torch.Tensor, *, inverse: bool,
                             scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_cube_fused`
    (``cube_fft.fft_cube_reference`` on the halves); any device."""
    re, im = _halves(st)
    return torch.cat(cube_fft.fft_cube_reference(re, im, inverse=inverse,
                                                 scale=scale), dim=-1)


def fft_pair_fused_reference(st: torch.Tensor, *, inverse: bool,
                             scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_pair_fused`
    (``pair_fft.fft_pair_reference`` on the halves); any device."""
    re, im = _halves(st)
    return torch.cat(pair_fft.fft_pair_reference(re, im, inverse=inverse,
                                                 scale=scale), dim=-1)


def fft_inner_fused_reference(st: torch.Tensor, *, inverse: bool,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_inner_fused`
    (``inner_fft.fft_inner_reference`` on the halves as (pre, n, M*L));
    any device."""
    re, im = _halves(st)
    view = tuple(re.shape[:2]) + (-1,)
    yr, yi = inner_fft.fft_inner_reference(re.reshape(view),
                                           im.reshape(view), inverse=inverse,
                                           scale=scale)
    return torch.cat([yr.reshape(re.shape), yi.reshape(im.shape)], dim=-1)


def fft_minor_fused_reference(st: torch.Tensor, *, inverse: bool,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_minor_fused`
    (``minor_fft.fft_minor_reference`` on the halves); any device."""
    re, im = _halves(st)
    return torch.cat(minor_fft.fft_minor_reference(re, im, inverse=inverse,
                                                   scale=scale), dim=-1)

"""Batched C2C FFT along the contiguous minor axis: the CUDA kernel, its
wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_minor``, the Pallas TPU
kernel that carries every contiguous minor-axis transform. The contract is
the same: (batch, n) re/im planes stored in f32 or bf16 in, the (batch, n)
DFT in natural order out in the same storage dtype, f32 arithmetic, a
forward/inverse flag and one real scale.

The CUDA kernel (``csrc/minor_fft.cu``, design notes in
``csrc/minor_fft.cuh``) is bound by device-memory bandwidth on an H100
(~3 flop/byte at n = 1024) and reads and writes each row once, coalesced,
in one of two forms (:func:`form`): power-of-two n from 2 to 4096 run the
line form, each row in registers (n <= 64: the lanes of one warp; above:
a four-step n = N1 N2, :func:`line_split`, through one shared-memory tile
a team of warps), K9 at those n too; every other length runs the stage
form, every mixed-radix Stockham stage in shared memory. Twiddles come
from a host float64 table cast to f32, uploaded once per (n, direction,
device).

``fft_minor`` is the wrapper. A CPU tensor runs ``fft_minor_reference``;
a CUDA tensor launches the kernel or raises, never falls back. Its launch
count is ``launches``; ``reference_cuda_calls`` counts runs of the plain
version on CUDA tensors, which the main path never makes.

``fft_minor_padded`` is K9, the counterpart of ``_build_minor_rect`` in its
zero-pad direction (m_in < m_out = den): the same kernel, in the same form
as K1 at the padded length n, with the pad in its load: it reads (batch,
n_in) rows at their own stride n_in and loads the columns n_in..n-1 as
zeros, so the pad never touches device memory. ``stages=True`` forces the
stage form at every length, kept to compare the forms. It counts
``padded_launches``; its plain version is ``fft_minor_padded_reference``
(``F.pad``, then ``fft_minor_reference``).

``fft_minor_reference`` is the plain version. It follows tpufft's own
factorization (``_compute``, ``_butterfly`` and the ``_tables`` ported
below: a dense DFT for n <= 128, radix-{2,4,8} butterflies times
twiddle-folded length-A DFTs for n = B*A, a Kronecker four-step for other
n = A*B with A, B <= 128) in f32 torch matmuls, with the same bf16 storage
rounding, so a CPU test against the Pallas kernel checks the table port as
well. Lengths the CUDA envelope admits beyond that factorization (n = 1,
or e.g. 127*129) run the torch-op Stockham in f32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..core import stockham_split_last_axis
from ..planner import default_bases, factorize, kernel_factors
from ..twiddle import exact_quarter_cleanup

__all__ = [
    "MAX_N",
    "MAX_PRIME",
    "check_length",
    "check_planes",
    "fft_axes_reference",
    "fft_minor",
    "fft_minor_padded",
    "fft_minor_padded_reference",
    "fft_minor_reference",
    "form",
    "launches",
    "line_geometry",
    "line_split",
    "padded_launches",
    "radices",
    "reference_cuda_calls",
    "reset_counts",
    "supported",
]

MAX_N = 16384     # one row must fit the 227 KB of shared memory in f32
MAX_PRIME = 127   # largest radix of the kernel's direct-sum stage
LINE_MAX_N = 4096  # longest row of the line form
STORAGE_DTYPES = (torch.float32, torch.bfloat16)

# The line form's four-step at n = 128 .. 4096 (csrc/minor_fft.cu,
# launch_line_form): N1, N2, warps a team, threads a block.
_FOUR_STEP = {128: (8, 16, 1, 128), 256: (16, 16, 1, 128),
              512: (32, 16, 1, 128), 1024: (32, 32, 1, 128),
              2048: (32, 64, 2, 128), 4096: (64, 64, 4, 256)}

launches = 0
padded_launches = 0
reference_cuda_calls = 0


def reset_counts() -> None:
    """Zero ``launches``, ``padded_launches`` and ``reference_cuda_calls``."""
    global launches, padded_launches, reference_cuda_calls
    launches = 0
    padded_launches = 0
    reference_cuda_calls = 0


@functools.lru_cache(maxsize=None)
def _length_ok(n: int) -> bool:
    return 1 <= n <= MAX_N and (n == 1 or max(factorize(n)) <= MAX_PRIME)


def supported(n: int, dtype) -> bool:
    """Is (n, dtype) inside the CUDA kernel's envelope? Every length tpufft's
    single-pass kernel takes (``kernel_factors(n) is not None``: n <= 128,
    or A*B with A, B <= 128) is inside, and n = 1."""
    return dtype in STORAGE_DTYPES and _length_ok(int(n))


def form(n: int, n_in: int | None = None) -> str | None:
    """Which form of the kernel transforms rows of length n (read from
    ``n_in`` values zero-padded to n, K9, when ``n_in`` < n): ``"lines"``
    for power-of-two n from 2 to ``LINE_MAX_N``, with or without a pad,
    ``"stages"`` for every other length in the envelope, None outside it
    (or for an ``n_in`` outside [1, n]). Mirrors ``launch_sized`` in
    ``csrc/minor_fft.cu``, which makes the choice at the launch."""
    n = int(n)
    if not _length_ok(n):
        return None
    if n_in is not None and not 1 <= int(n_in) <= n:
        return None
    return "lines" if 2 <= n <= LINE_MAX_N and n & (n - 1) == 0 else "stages"


def line_split(n: int) -> tuple[int, int] | None:
    """(N1, N2) of the line form at length n: the four-step n = N1 N2 for n
    > 64 (pass 1 runs the N1-long columns, pass 2 the N2-long rows of the
    (N1, N2) view); (n, 1) for n <= 64, one line a row; None where n does
    not run the line form."""
    n = int(n)
    if form(n) != "lines":
        return None
    return _FOUR_STEP[n][:2] if n in _FOUR_STEP else (n, 1)


def line_geometry(n: int) -> dict | None:
    """The four-step geometry of the line form at n (128 to 4096), as
    ``LaneStep`` in ``csrc/minor_fft.cuh`` has it: ``n1``, ``n2``,
    ``team_warps``, ``threads`` (a block) and ``rows`` (a team, 32 values
    a lane). A line of 8 to 32 lies in one lane, a line of 64 on a lane
    pair. None where n does not run the four-step."""
    n = int(n)
    if n not in _FOUR_STEP or form(n) != "lines":
        return None
    n1, n2, team_warps, threads = _FOUR_STEP[n]
    return {"n1": n1, "n2": n2, "team_warps": team_warps,
            "threads": threads, "rows": 1024 * team_warps // n}


@functools.lru_cache(maxsize=None)
def radices(n: int) -> tuple[int, ...]:
    """The kernel's stage radices for n: 8s, then a 4 or a 2, then the odd
    primes in ascending order; () for n = 1."""
    out = []
    m = n
    while m % 8 == 0:
        out.append(8)
        m //= 8
    for r in (4, 2):
        if m % r == 0:
            out.append(r)
            m //= r
    return tuple(out) + tuple(factorize(m) if m > 1 else ())


@functools.lru_cache(maxsize=64)
def _device_twiddles(n: int, inverse: bool, device: torch.device):
    """w^k = exp(-+2 pi i k / n), k < n, as (n, 2) f32 on ``device``: host
    float64 trig with exact quarter points, uploaded once."""
    k = np.arange(n, dtype=np.float64)
    sign = 1.0 if inverse else -1.0
    theta = (sign * 2.0 * np.pi / n) * k
    w = exact_quarter_cleanup(np.cos(theta) + 1j * np.sin(theta), k, float(n))
    table = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def check_planes(name: str, xr: torch.Tensor, xi: torch.Tensor,
                 ndim: int) -> None:
    """Raise ValueError unless xr and xi are contiguous float32 or bfloat16
    planes of one shape and rank ``ndim`` on one CUDA device (what every
    kernel of the port takes)."""
    if xr.device.type != "cuda" or xi.device != xr.device:
        raise ValueError(
            f"{name}: planes must lie on one CUDA device, got "
            f"{xr.device} and {xi.device}")
    if xr.dtype not in STORAGE_DTYPES or xi.dtype != xr.dtype:
        raise ValueError(
            f"{name}: planes must both be float32 or bfloat16, got "
            f"{xr.dtype} and {xi.dtype}")
    if xr.ndim != ndim or xi.shape != xr.shape:
        raise ValueError(
            f"{name}: planes must be rank {ndim} of one shape, got "
            f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError(f"{name}: planes must be contiguous")


def check_length(name: str, n: int) -> None:
    """Raise ValueError unless length n is inside the kernels' envelope."""
    if not _length_ok(n):
        raise ValueError(
            f"{name}: length {n} is outside the kernel's envelope "
            f"(n <= {MAX_N}, prime factors <= {MAX_PRIME})")


def _launch(xr, xi, n: int, inverse: bool, scale: float,
            stages: bool = False):
    """K1 (n == n_in) or K9 (n_in < n) on the (batch, n_in) planes; K9 on
    the stage form with ``stages``."""
    batch, n_in = xr.shape
    yr = xr.new_empty((batch, n))
    yi = torch.empty_like(yr)
    if batch == 0:
        return yr, yi, False
    lib = _build.load()
    rad = radices(n)
    rad_arr = (ctypes.c_int * max(len(rad), 1))(*rad)
    with torch.cuda.device(xr.device):
        tw = _device_twiddles(n, bool(inverse), xr.device)
        entry = (lib.tpufft_minor_fft_padded_stages if stages
                 else lib.tpufft_minor_fft)
        err = entry(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw.data_ptr(), batch, n, n_in, rad_arr, len(rad),
            int(bool(inverse)), float(scale), int(xr.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"minor_fft launch failed: CUDA error {err}")
    return yr, yi, True


def fft_minor(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the (batch, n) planes along their minor axis.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_minor_reference(xr, xi, inverse=inverse, scale=scale)
    check_planes("minor_fft", xr, xi, 2)
    n = xr.shape[1]
    check_length("minor_fft", n)
    yr, yi, launched = _launch(xr, xi, n, inverse, scale)
    launches += launched
    return yr, yi


def fft_minor_padded(xr: torch.Tensor, xi: torch.Tensor, *, n: int,
                     inverse: bool, scale: float,
                     stages: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the (batch, n_in) planes to length n > n_in along their
    minor axis and transform them, in one pass (K9): (batch, n) out.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    :func:`form` on the current stream (``stages``: the stage form at every
    length, kept to compare the forms) and raise on anything it does not
    take."""
    global padded_launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_minor_padded_reference(xr, xi, n=n, inverse=inverse,
                                          scale=scale)
    check_planes("minor_fft_padded", xr, xi, 2)
    n = int(n)
    check_length("minor_fft_padded", n)
    if not 1 <= xr.shape[1] < n:
        raise ValueError(f"minor_fft_padded: input length {xr.shape[1]} "
                         f"must be in [1, {n})")
    yr, yi, launched = _launch(xr, xi, n, inverse, scale, stages)
    padded_launches += launched
    return yr, yi


# ----------------------------------------------------------------------------
# Plain version: tpufft's factorization in torch ops
# ----------------------------------------------------------------------------

def _cis_outer(i: int, j: int, den: float, inverse: bool):
    sign = 1.0 if inverse else -1.0
    k = np.outer(np.arange(i, dtype=np.float64), np.arange(j, dtype=np.float64))
    theta = (sign * 2.0 * np.pi / den) * k
    return np.cos(theta), np.sin(theta)


@functools.lru_cache(maxsize=None)
def _tables(n: int, inverse: bool, scale: float):
    """Host f32 table planes for ``kernel_factors(n)``, float64 trig then
    cast, scale folded into the last matrix (tpufft's ``_tables``)."""
    kind = kernel_factors(n)
    if kind is None:
        raise ValueError(f"no single-pass factorization for n={n}")
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    if kind[0] == "small":
        wr, wi = _cis_outer(n, n, float(n), inverse)
        return (f32(wr * scale), f32(wi * scale))
    if kind[0] == "four_step_bf":
        # M_t[m, r] = w^{rt} W_A[m, r] for t < B, scale folded in
        _, A, B = kind
        sign = 1.0 if inverse else -1.0
        r = np.arange(A, dtype=np.float64)
        wa_r, wa_i = _cis_outer(A, A, float(A), inverse)
        out = []
        for t in range(B):
            theta = (sign * 2.0 * np.pi / n) * r * t
            tr, ti = np.cos(theta), np.sin(theta)
            mr = wa_r * tr[None, :] - wa_i * ti[None, :]
            mi = wa_r * ti[None, :] + wa_i * tr[None, :]
            out.extend([f32(mr * scale), f32(mi * scale)])
        return tuple(out)
    _, A, B, f = kind
    w1r, w1i = _cis_outer(A, A, float(A), inverse)
    twr, twi = _cis_outer(A, B, float(n), inverse)
    w2r, w2i = _cis_outer(B, B, float(B), inverse)
    eye = np.eye(f)
    w2r_k = np.kron(w2r * scale, eye)
    w2i_k = np.kron(w2i * scale, eye)
    return (f32(w1r), f32(w1i), f32(twr), f32(twi), f32(w2r_k), f32(w2i_k))


def _butterfly(xs, B: int, inverse: bool):
    """Exact-constant radix-B DFT over B (re, im) block pairs, B in 2/4/8
    (tpufft's ``_butterfly``)."""
    h = float(1.0 / np.sqrt(2.0))

    def add(a, b):
        return (a[0] + b[0], a[1] + b[1])

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1])

    def m_i(a):  # * -i (forward) / * +i (inverse)
        return (a[1], -a[0]) if not inverse else (-a[1], a[0])

    if B == 2:
        return [add(xs[0], xs[1]), sub(xs[0], xs[1])]
    if B == 4:
        t0, t1 = add(xs[0], xs[2]), sub(xs[0], xs[2])
        t2, t3 = add(xs[1], xs[3]), sub(xs[1], xs[3])
        it3 = m_i(t3)
        return [add(t0, t2), add(t1, it3), sub(t0, t2), sub(t1, it3)]

    def m_w8(a):   # * e^{-+i pi/4}
        if not inverse:
            return (h * (a[0] + a[1]), h * (a[1] - a[0]))
        return (h * (a[0] - a[1]), h * (a[1] + a[0]))

    def m_w83(a):  # * e^{-+i 3pi/4}
        if not inverse:
            return (h * (a[1] - a[0]), h * (-a[0] - a[1]))
        return (h * (-a[0] - a[1]), h * (a[0] - a[1]))

    x0, x1, x2, x3, x4, x5, x6, x7 = xs
    a0, a1 = add(x0, x4), sub(x0, x4)
    a2, a3 = add(x2, x6), sub(x2, x6)
    a4, a5 = add(x1, x5), sub(x1, x5)
    a6, a7 = add(x3, x7), sub(x3, x7)
    b0, b1 = add(a0, a2), sub(a0, a2)
    b2, b3 = add(a4, a6), sub(a4, a6)
    y0, y4 = add(b0, b2), sub(b0, b2)
    ib3 = m_i(b3)
    y2, y6 = add(b1, ib3), sub(b1, ib3)
    ia3 = m_i(a3)
    c1, c2 = add(a1, ia3), sub(a1, ia3)
    ia7 = m_i(a7)
    d1, d2 = add(a5, ia7), sub(a5, ia7)
    e1, e2 = m_w8(d1), m_w83(d2)
    y1, y5 = add(c1, e1), sub(c1, e1)
    y3, y7 = add(c2, e2), sub(c2, e2)
    return [y0, y1, y2, y3, y4, y5, y6, y7]


def _cmm(w, xr, xi):
    """Complex (wr + i wi) @ (xr + i xi) as four real f32 matmuls."""
    wr, wi = w
    return wr @ xr - wi @ xi, wr @ xi + wi @ xr


def _compute(n: int, kind, tables, xr, xi, inverse: bool):
    """(n, lanes) -> (n, lanes) in natural order (tpufft's ``_compute`` for
    the four-step kinds)."""
    lanes = xr.shape[1]
    if kind[0] == "four_step_bf":
        # rows n = q*A + r: radix-B butterflies over the B row blocks, one
        # twiddle-folded matmul per output digit t, then the (t, m) -> (m, t)
        # digit interleave
        _, A, B = kind
        xs = [(xr[q * A:(q + 1) * A], xi[q * A:(q + 1) * A])
              for q in range(B)]
        ys = _butterfly(xs, B, inverse)
        zs = [_cmm(tables[2 * t:2 * t + 2], *ys[t]) for t in range(B)]
        zr = torch.cat([z[0] for z in zs], dim=0)
        zi = torch.cat([z[1] for z in zs], dim=0)
        zr = zr.reshape(B, A, lanes).transpose(0, 1).reshape(n, lanes)
        zi = zi.reshape(B, A, lanes).transpose(0, 1).reshape(n, lanes)
        return zr, zi
    _, A, B, f = kind
    w1, (twr, twi), w2 = tables[0:2], tables[2:4], tables[4:6]
    yr, yi = _cmm(w1, xr.reshape(A, B * lanes), xi.reshape(A, B * lanes))
    yr = yr.reshape(A, B, lanes)
    yi = yi.reshape(A, B, lanes)
    tr, ti = twr[:, :, None], twi[:, :, None]
    yr, yi = yr * tr - yi * ti, yr * ti + yi * tr
    yr = yr.transpose(0, 1).reshape(B * f, (A // f) * lanes)
    yi = yi.transpose(0, 1).reshape(B * f, (A // f) * lanes)
    zr, zi = _cmm(w2, yr, yi)
    return zr.reshape(n, lanes), zi.reshape(n, lanes)


def fft_minor_padded_reference(xr: torch.Tensor, xi: torch.Tensor, *,
                               n: int, inverse: bool, scale: float
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fft_minor_padded`: ``F.pad`` to
    length n, then :func:`fft_minor_reference`; any device."""
    pad = (0, int(n) - xr.shape[-1])
    return fft_minor_reference(F.pad(xr, pad), F.pad(xi, pad),
                               inverse=inverse, scale=scale)


def fft_minor_reference(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same contract, any device.

    f32 matmuls throughout (on a GPU this assumes
    ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default).
    """
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    store = xr.dtype
    n = xr.shape[-1]
    ar, ai = xr.float(), xi.float()
    kind = kernel_factors(n)
    if kind is None:
        zr, zi = stockham_split_last_axis(ar, ai, default_bases(n),
                                          inverse=inverse, scale=scale)
        return zr.to(store), zi.to(store)
    tables = [torch.from_numpy(t).to(xr.device)
              for t in _tables(n, bool(inverse), float(scale))]
    if kind[0] == "small":
        # right-multiply form x @ W (W symmetric): no transposes
        wr, wi = tables
        zr, zi = ar @ wr - ai @ wi, ai @ wr + ar @ wi
    else:
        zr, zi = _compute(n, kind, tables, ar.T, ai.T, bool(inverse))
        zr, zi = zr.T, zi.T
    return zr.contiguous().to(store), zi.contiguous().to(store)


def fft_axes_reference(xr: torch.Tensor, xi: torch.Tensor,
                       dims: tuple[int, ...], *, inverse: bool,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The minor-axis plain version along each of ``dims`` in turn, in f32,
    the scale on the last, with one rounding to the storage dtype; any
    device. Each axis is swapped minor with ``transpose`` and back."""
    store = xr.dtype
    zr, zi = xr.float(), xi.float()
    for k, d in enumerate(dims):
        zr, zi = zr.transpose(d, -1), zi.transpose(d, -1)
        shape = zr.shape
        zr, zi = fft_minor_reference(
            zr.reshape(-1, shape[-1]), zi.reshape(-1, shape[-1]),
            inverse=inverse, scale=scale if k == len(dims) - 1 else 1.0)
        zr = zr.reshape(shape).transpose(d, -1)
        zi = zi.reshape(shape).transpose(d, -1)
    return zr.contiguous().to(store), zi.contiguous().to(store)

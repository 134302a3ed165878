"""Batched C2C FFT along the contiguous minor axis: the CUDA kernel, its
wrapper, and its plain PyTorch version.

Counterpart of ``tpufft/kernels/mxu_fft.py:_build_minor``, the Pallas TPU
kernel that carries every contiguous minor-axis transform. The contract is
the same: (batch, n) re/im planes stored in f32 or bf16 in, the (batch, n)
DFT in natural order out in the same storage dtype, f32 arithmetic, a
forward/inverse flag and one real scale.

The CUDA kernel (``csrc/minor_fft.cu``, design notes in
``csrc/minor_fft.cuh``) is bound by device-memory bandwidth on an H100
(~3 flop/byte at n = 1024) and reads and writes each row once, in one of
two forms (:func:`form`). The line form keeps each row in registers,
its lines on the shared generic-radix in-register DFT of
``csrc/lane_dft.cuh`` (radices 2, 4, 8, 3, 5 and the odd primes 7 to
31): power-of-two n <= 64 on the lanes of one warp; the other powers of
two up to 2048 and the mixed-radix lengths of ``_FOUR_STEP`` (3, 5 and
15 times a power of two up to 3072, 2560 and 3840; 93, 1000, 1080, 2160;
each family instantiated by its own source,
``csrc/minor_line_{r3,r5,r15,odd}.cu``) as a four-step n = N1 N2
(:func:`line_split`, :func:`line_geometry`) through one shared-memory
tile a team of warps; the lengths of ``_LONG_STEP`` from 4096 (4096,
4320, 5120, 6144, 7680, 8192, 8320, 10240, 12288, 15360, 16384;
``csrc/minor_line_long.cu``) as a three-factor form n = N1 N2 N3, one
row a block, through the tile twice. K9 and K20 take the same forms.
Every other length (a prime factor above 31, a length no list holds)
runs the stage form, every Stockham stage in shared memory. Twiddles come
from a host float64 table cast to f32, uploaded once per (n, direction,
device).

``fft_minor`` is the wrapper. A CPU tensor runs ``fft_minor_reference``;
a CUDA tensor launches the kernel or raises, never falls back
(``stages=True`` forces the stage form at every length, kept to compare
the forms). Its launch count is ``launches``; ``reference_cuda_calls``
counts runs of the plain version on CUDA tensors, which the main path
never makes. :func:`launched_geometry` reads the launch's own choice of
form from the library, for a card test that holds :func:`form` to it.

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
    "launched_geometry",
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
LINE_MAX_N = 4096  # longest power-of-two row of the line form, K7/K8's cap
STORAGE_DTYPES = (torch.float32, torch.bfloat16)

# The line form's four-step (csrc/minor_fft.cuh, LaneStep): n -> (N1, N2,
# warps a team, threads a block, rows a team, Q1, Q2, P2, RS): the lists of
# minor_fft.cuh, TPUFFT_MINOR_POW2 (32 values a lane in the XOR tile, P2 =
# RS = 0) and the mixed-radix families TPUFFT_MINOR_{R3,R5,R15,ODD}, each
# instantiated by its own source (a CPU test holds this table equal to
# those lists, a card test to the library's tpufft_minor_line_geometry).
# 4096 runs the three-factor form (_LONG_STEP); LINE_MAX_N = 4096 stays the
# cap of the power-of-two halves K7 and K8 share (real_fft.form).
_POW2_STEP = {128: (8, 16, 1, 128), 256: (16, 16, 1, 128),
              512: (32, 16, 1, 128), 1024: (32, 32, 1, 128),
              2048: (32, 64, 2, 128)}
_MIXED_STEP = {
    # 3 2^a
    12: (4, 3, 1, 64, 3, 4, 4, 19), 24: (8, 3, 1, 32, 3, 8, 6, 51),
    48: (3, 16, 4, 85, 16, 3, 17, 51), 96: (6, 16, 1, 10, 16, 6, 17, 102),
    192: (8, 24, 1, 4, 24, 8, 25, 200), 384: (8, 48, 1, 2, 48, 8, 49, 392),
    768: (12, 64, 1, 1, 64, 12, 65, 780),
    1536: (24, 64, 2, 1, 64, 24, 65, 1560),
    3072: (48, 64, 4, 1, 64, 48, 65, 3120),
    # 5 2^a
    20: (4, 5, 1, 56, 5, 4, 12, 53), 40: (8, 5, 1, 19, 5, 8, 6, 53),
    80: (5, 16, 1, 12, 16, 5, 17, 85), 160: (5, 32, 1, 6, 32, 5, 33, 165),
    320: (5, 64, 1, 3, 64, 5, 65, 325), 640: (10, 64, 2, 3, 64, 10, 65, 650),
    1280: (20, 64, 2, 1, 64, 20, 65, 1300),
    2560: (40, 64, 4, 1, 64, 40, 65, 2600),
    # 15 2^a
    30: (2, 15, 1, 32, 16, 2, 15, 30), 60: (4, 15, 1, 16, 16, 4, 15, 60),
    120: (8, 15, 1, 8, 16, 8, 15, 120), 240: (8, 30, 1, 4, 32, 8, 30, 241),
    480: (8, 60, 1, 2, 64, 8, 61, 488), 960: (15, 64, 1, 1, 64, 15, 65, 975),
    1920: (30, 64, 2, 1, 64, 30, 65, 1950),
    3840: (60, 64, 4, 1, 64, 60, 65, 3900),
    # the odd list
    93: (31, 3, 1, 10, 3, 32, 3, 99), 1000: (25, 40, 2, 1, 40, 25, 41, 1025),
    1080: (30, 36, 4, 3, 36, 32, 37, 1124),
    2160: (36, 60, 4, 1, 60, 36, 61, 2196),
}
_FOUR_STEP = {
    **{n: (n1, n2, w, th, 1024 * w // n, n2, n1, 0, 0)
       for n, (n1, n2, w, th) in _POW2_STEP.items()},
    **{n: (g[0], g[1], g[2], 128, *g[3:]) for n, g in _MIXED_STEP.items()},
}
# The three-factor form from 4096 (csrc/minor_fft.cuh, LongStep; the list
# TPUFFT_MINOR_LONG, instantiated by csrc/minor_line_long.cu): n -> (N1,
# N2, N3, threads a block, P1, P2); the tile holds (k1, c2, j3) at k1 P1 +
# c2 P2 + j3.
_LONG_STEP = {
    4096: (16, 16, 16, 256, 257, 16),
    4320: (15, 9, 32, 256, 303, 33), 5120: (16, 10, 32, 256, 321, 32),
    6144: (16, 12, 32, 256, 385, 32), 7680: (16, 15, 32, 256, 481, 32),
    8192: (16, 16, 32, 256, 513, 32), 8320: (13, 20, 32, 256, 661, 33),
    10240: (16, 20, 32, 256, 641, 32), 12288: (16, 24, 32, 256, 769, 32),
    15360: (16, 30, 32, 512, 961, 32), 16384: (16, 32, 32, 512, 1025, 32),
}
_FOUR_STEP_KEYS = ("n1", "n2", "team_warps", "threads", "rows", "q1", "q2",
                   "p2", "rs")
_LONG_KEYS = ("n1", "n2", "n3", "threads", "p1", "p2")

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
    for power-of-two n from 2 to ``LINE_MAX_N``, the mixed-radix lengths
    of ``_FOUR_STEP`` and the three-factor lengths of ``_LONG_STEP``, with
    or without a pad, ``"stages"`` for every other length in the envelope,
    None outside it (or for an ``n_in`` outside [1, n]). Mirrors
    ``launch_sized`` in ``csrc/minor_fft.cu``, which makes the choice at
    the launch (``tpufft_minor_line_geometry`` reports it)."""
    n = int(n)
    if not _length_ok(n):
        return None
    if n_in is not None and not 1 <= int(n_in) <= n:
        return None
    pow2 = 2 <= n <= LINE_MAX_N and n & (n - 1) == 0
    lines = pow2 or n in _FOUR_STEP or n in _LONG_STEP
    return "lines" if lines else "stages"


def line_split(n: int) -> tuple[int, ...] | None:
    """The factors of the line form at length n: (N1, N2) of the
    four-step n = N1 N2 (pass 1 runs the N1-long columns, pass 2 the
    N2-long rows of the (N1, N2) view); (N1, N2, N3) of the three-factor
    form (passes of N1-, N2- and N3-long lines); (n, 1) for power-of-two n
    <= 64, one line a row; None where n does not run the line form."""
    n = int(n)
    if form(n) != "lines":
        return None
    if n in _LONG_STEP:
        return _LONG_STEP[n][:3]
    return _FOUR_STEP[n][:2] if n in _FOUR_STEP else (n, 1)


def line_geometry(n: int) -> dict | None:
    """The geometry of the line form at n. The four-step's, as ``LaneStep``
    in ``csrc/minor_fft.cuh`` has it: ``n1``, ``n2``, ``team_warps``,
    ``threads`` (a block), ``rows`` (a team), ``q1`` and ``q2`` (line slots
    a row in passes 1 and 2, those at j2 >= N2 or k1 >= N1 idle), ``p2``
    and ``rs`` (the tile holds (k1, j2) of row r at r rs + k1 p2 + j2; 0 for
    the power-of-two XOR tile r n + k1 N2 + (j2 ^ ((k1 + N1 r) mod 16))).
    A line of up to 32 lies in one lane, an even one of 34 to 64 on a lane
    pair. The three-factor form's, as ``LongStep`` has it: ``n1``, ``n2``,
    ``n3``, ``threads`` (a block, one row at a time), ``p1`` and ``p2``
    (the tile holds (k1, c2, j3) at k1 p1 + c2 p2 + j3). None where n runs
    neither."""
    n = int(n)
    if form(n) != "lines":
        return None
    if n in _LONG_STEP:
        return dict(zip(_LONG_KEYS, _LONG_STEP[n]))
    if n in _FOUR_STEP:
        return dict(zip(_FOUR_STEP_KEYS, _FOUR_STEP[n]))
    return None


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


def launched_geometry(n: int) -> dict | None:
    """The form the library launches at length n, read from
    ``tpufft_minor_line_geometry`` (``launch_sized``'s own test; needs the
    CUDA toolkit): ``{"form": "stages"}``, ``{"form": "lines"}`` for the
    warp-shuffle rows (power-of-two n <= 64), or the four-step's or the
    three-factor form's geometry with the keys of :func:`line_geometry` and
    ``"form": "lines"``. A card test holds it equal to :func:`form` and
    :func:`line_geometry`."""
    lib = _build.load()
    out = (ctypes.c_int * 9)()
    kind = lib.tpufft_minor_line_geometry(int(n), out)
    if kind == 0:
        return {"form": "stages"}
    if kind == 1:
        return {"form": "lines"}
    keys = _LONG_KEYS if kind == 3 else _FOUR_STEP_KEYS
    return {"form": "lines", **dict(zip(keys, out))}


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
    """K1 (n == n_in) or K9 (n_in < n) on the (batch, n_in) planes; on the
    stage form with ``stages``."""
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
        entry = (lib.tpufft_minor_fft_stages if stages
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
              scale: float, stages: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform the (batch, n) planes along their minor axis.

    CPU tensors run the plain version; CUDA tensors launch the kernel of
    :func:`form` on the current stream (``stages``: the stage form at every
    length, kept to compare the forms) and raise on anything it does not
    take."""
    global launches
    if xr.device.type == "cpu" and xi.device.type == "cpu":
        return fft_minor_reference(xr, xi, inverse=inverse, scale=scale)
    check_planes("minor_fft", xr, xi, 2)
    n = xr.shape[1]
    check_length("minor_fft", n)
    yr, yi, launched = _launch(xr, xi, n, inverse, scale, stages)
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

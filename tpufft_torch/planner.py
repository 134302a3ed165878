"""Radix-decomposition planner (counterpart of ``tpufft/planner.py``).

Host-side Python only: prime factorization, the default Stockham stage
schedule, and the public fast-length helpers. The schedule math is the
same as tpufft's, so a plan's ``bases`` mean the same thing in both
packages.

Stage model (Stockham autosort, ``core.py``): stage t with radix r and
cumulative product s views the length-N state as (r, m, s), m = N/(r*s),
and computes

    out[p, j, q] = tw[j, p] * sum_b W_r[j, b] * in[b, p, q]

with tw[j, p] = exp(-2*pi*i*j*p/(r*m)); after the last stage the state
holds the DFT in natural order.

``kernel_factors`` and ``_divisors`` are a port-local copy of tpufft's TPU
factor rule (``tpufft/kernels/mxu_fft.py``). They define which lengths
``next_fast_len``/``prev_fast_len`` call fast, which is public behaviour
and stays identical to tpufft, and the factorization that the CUDA
kernel's plain version follows. The CUDA kernel's own envelope is a
separate predicate (``kernels/minor_fft.py:supported``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

__all__ = [
    "Stage",
    "digit_reverse",
    "factorize",
    "default_bases",
    "kernel_factors",
    "next_fast_len",
    "prev_fast_len",
    "stage_schedule",
    "validate_bases",
]

DEFAULT_MAX_RADIX = 16
_MAX_DEPTH = 128  # largest factor of tpufft's four-step factorization


@dataclasses.dataclass(frozen=True)
class Stage:
    """One Stockham butterfly stage.

    Attributes:
      radix: r, the small-DFT size of this stage.
      m: number of twiddle groups, N / (radix * s).
      s: cumulative product of radices of all previous stages.
      n: full transform length (constant across stages).
    """

    radix: int
    m: int
    s: int
    n: int


def factorize(n: int) -> list[int]:
    """Prime factorization of ``n`` in ascending order."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    factors: list[int] = []
    rem = n
    d = 2
    while d * d <= rem:
        while rem % d == 0:
            factors.append(d)
            rem //= d
        d += 1 if d == 2 else 2
    if rem > 1:
        factors.append(rem)
    return factors


@functools.lru_cache(maxsize=None)
def default_bases(n: int, max_radix: int = DEFAULT_MAX_RADIX) -> tuple[int, ...]:
    """Radix decomposition of ``n``: merge the two smallest prime factors
    while their product stays <= ``max_radix``; largest radix first."""
    if n == 1:
        return (1,)
    factors = sorted(factorize(n))
    while len(factors) >= 2 and factors[0] * factors[1] <= max_radix:
        merged = factors[0] * factors[1]
        factors = sorted(factors[2:] + [merged])
    return tuple(sorted(factors, reverse=True))


def validate_bases(n: int, bases: Sequence[int]) -> tuple[int, ...]:
    """Check that ``bases`` is a valid decomposition of ``n``."""
    bases = tuple(int(b) for b in bases)
    if any(b < 1 for b in bases):
        raise ValueError(f"radices must be positive, got {bases}")
    if math.prod(bases) != n:
        raise ValueError(
            f"product of bases {bases} is {math.prod(bases)}, expected {n}"
        )
    return bases


def digit_reverse(index: int, bases: Sequence[int]) -> int:
    """Mixed-radix digit reversal of ``index`` over the ordered base list
    (tpufft's ``planner.digit_reverse``): with index = sum_i d_i *
    prod(bases[i+1:]), returns sum_i d_i * prod(bases[:i]). The
    input-reordering permutation a decimation-in-time formulation needs;
    the port's transforms are all autosort and never permute, so it serves
    interop with DIT-ordered data."""
    bases = tuple(int(b) for b in bases)
    digits = []
    rem = int(index)
    for b in reversed(bases):
        digits.append(rem % b)
        rem //= b
    out = 0
    for b, d in zip(reversed(bases), digits):
        out = out * b + d
    return out


@functools.lru_cache(maxsize=None)
def stage_schedule(n: int, bases: tuple[int, ...]) -> tuple[Stage, ...]:
    """Ordered Stockham stage list for length ``n``."""
    bases = validate_bases(n, bases)
    if n == 1:
        return ()
    stages = []
    s = 1
    for r in bases:
        if r == 1:
            continue
        m = n // (r * s)
        stages.append(Stage(radix=r, m=m, s=s, n=n))
        s *= r
    return tuple(stages)


@functools.lru_cache(maxsize=None)
def _divisors(n: int) -> tuple[int, ...]:
    out = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            if d != n // d:
                out.append(n // d)
        d += 1
    return tuple(sorted(out))


@functools.lru_cache(maxsize=None)
def kernel_factors(n: int):
    """tpufft's single-pass factorization of length n.

    ("small", n) for n <= 128; ("four_step_bf", A, B) for n = B * A with
    B in {2, 4, 8}, A <= 128 and A % 8 == 0; ("four_step", A, B, f) for
    another n = A * B with A, B <= 128 (f: the Kronecker padding factor);
    None otherwise.
    """
    if n < 2:
        return None
    if n <= _MAX_DEPTH:
        return ("small", n)
    for B in (2, 4, 8):
        if n % B == 0:
            A = n // B
            if A <= _MAX_DEPTH and A % 8 == 0:
                return ("four_step_bf", A, B)
    divs = _divisors(n)
    cands = [d for d in divs if d <= _MAX_DEPTH and n // d <= _MAX_DEPTH]
    if not cands:
        return None
    A = max(cands)
    B = n // A
    f = max(d for d in _divisors(A) if B * d <= _MAX_DEPTH)
    return ("four_step", A, B, f)


def _fast(m: int) -> bool:
    """tpufft's "fast length" predicate: a single-pass factorization, or
    a two-pass split m = a * b of such lengths."""
    if kernel_factors(m) is not None:
        return True
    return any(
        kernel_factors(d) is not None and kernel_factors(m // d) is not None
        for d in _divisors(m) if 1 < d * d <= m
    )


def next_fast_len(n: int, *, aligned: bool = False) -> int:
    """Smallest length >= n that tpufft calls fast; with ``aligned=True``
    also a multiple of 128 (the same answers as ``tpufft.next_fast_len``)."""
    if n <= 1:
        return max(n, 1)
    step = 128 if aligned else 1
    m = ((n + step - 1) // step) * step
    while not _fast(m):
        m += step
    return m


def prev_fast_len(n: int, *, aligned: bool = False) -> int:
    """Largest length <= n that tpufft calls fast (see
    :func:`next_fast_len`)."""
    if n <= 1:
        return max(n, 1)
    step = 128 if aligned else 1
    m = (n // step) * step
    while m >= step and not _fast(m):
        m -= step
    return max(m, 1)

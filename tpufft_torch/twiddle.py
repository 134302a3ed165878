"""Twiddle-factor tables and radix DFT matrices (counterpart of
``tpufft/twiddle.py``).

All tables are host numpy float64, exactly as in tpufft, so both packages
start from bit-identical tables; callers cast them to the compute dtype
and device. Entries at multiples of a quarter turn are snapped to exact
+-1 / +-i.
"""

from __future__ import annotations

import functools

import numpy as np

from .planner import Stage, stage_schedule

__all__ = [
    "dft_matrix",
    "stage_twiddle",
    "stage_tables",
    "exact_quarter_cleanup",
]


def _cis(num: np.ndarray, den: float, inverse: bool) -> np.ndarray:
    """exp(sign * 2*pi*i * num / den) in float64, with exact quarter points."""
    sign = 1.0 if inverse else -1.0
    theta = (sign * 2.0 * np.pi / den) * num
    table = np.cos(theta) + 1j * np.sin(theta)
    return exact_quarter_cleanup(table, num, den)


def exact_quarter_cleanup(
    table: np.ndarray, num: np.ndarray, den: float
) -> np.ndarray:
    """Snap entries at multiples of a quarter turn to exact +-1 / +-i,
    picking the sign of the imaginary part that the computed value has."""
    frac = np.mod(np.asarray(num, np.float64) / den, 1.0)
    quarter = np.round(frac * 4.0)
    is_quarter = np.abs(frac * 4.0 - quarter) < 1e-12
    exact = np.choose(
        (quarter.astype(np.int64) % 4),
        [1.0 + 0.0j, -1.0j, -1.0 + 0.0j, 1.0j],
    )
    exact_conj = np.conj(exact)
    use_conj = np.abs(table - exact_conj) < np.abs(table - exact)
    snapped = np.where(use_conj, exact_conj, exact)
    return np.where(is_quarter, snapped, table)


@functools.lru_cache(maxsize=None)
def dft_matrix(r: int, inverse: bool = False) -> np.ndarray:
    """Dense radix-r DFT matrix W[j, b] = exp(-+2*pi*i*j*b/r), complex128."""
    jb = np.outer(np.arange(r), np.arange(r))
    return _cis(jb, float(r), inverse)


@functools.lru_cache(maxsize=None)
def stage_twiddle(stage: Stage, inverse: bool = False) -> np.ndarray:
    """Per-stage twiddle table tw[j, p] = exp(-+2*pi*i*j*p/(r*m)), (r, m)."""
    jp = np.outer(np.arange(stage.radix), np.arange(stage.m))
    return _cis(jp, float(stage.radix * stage.m), inverse)


@functools.lru_cache(maxsize=None)
def stage_tables(
    n: int,
    bases: tuple[int, ...],
    inverse: bool = False,
    scale: float = 1.0,
) -> tuple[tuple[Stage, np.ndarray, np.ndarray], ...]:
    """(stage, W_r, twiddle) triples for every stage of a length-n transform.

    ``scale`` is folded into the last stage's twiddle table; for n == 1
    there are no stages and the caller applies the scale.
    """
    stages = stage_schedule(n, bases)
    out = []
    for i, st in enumerate(stages):
        tw = stage_twiddle(st, inverse)
        if scale != 1.0 and i == len(stages) - 1:
            tw = tw * scale
        out.append((st, dft_matrix(st.radix, inverse), tw))
    return tuple(out)

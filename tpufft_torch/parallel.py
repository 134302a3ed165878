"""Multi-GPU execution: sharded batches and distributed transforms
(counterpart of ``tpufft/parallel.py``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, the counterpart of ``jax.sharding.Mesh``:
``axis_name`` and ``batch_axis_name`` name its dimensions, the exchanges
of a transform run on ``mesh.get_group(axis_name)``, and d is the size of
that dimension. The caller starts (and ends) the process group, as a JAX
caller builds its mesh; this module never does.

**Local blocks, SPMD.** Every rank calls the function with its own block
and gets its own block back. One rule holds for every sharded axis: of a
global axis of length m over d ranks, rank r holds the global indices
[r*c, min((r+1)*c, m)), c = ceil(m/d) -- ``torch.chunk``'s rule, so
``torch.cat`` of the blocks in rank order is the global array and
``DTensor.from_local`` can wrap a block. A C2C axis needs d | n, so every
block holds n/d. With ``batch_axis_name`` the batch axis (axis 0, or 1
when the transform axis is 0) is blocked by the same rule over that mesh
dimension; the exchanges stay within one group of ``axis_name``. numpy
planes go to the mesh's device type; results are tensors where the block
lies.

* **Batch sharding** (``fft_batch_sharded``, the DP analog): each rank
  runs the ordinary local plan on its batch block; no collective.
* **Distributed transform axis** (the SP analog): a 1D FFT along an axis
  block-sharded over ``axis_name``, via the four-step factorization
  N = A * B with the flat index n = a*B + b (a slow) and k = kb*A + ka:

      X[kb*A + ka] = sum_b e^{-2pi i b kb/B}
                       ( e^{-2pi i b ka/N}
                         sum_a e^{-2pi i a ka/A} x[a*B + b] )

  realized as: exchange (rows -> columns), local length-A FFTs along a
  strided axis (``execute.fft_axis``: K2 on the card), the rank's slice of
  the twiddle, exchange (columns -> rows), local length-B FFTs along the
  minor axis (K1), and -- only for natural output order -- a third
  exchange. ``permuted_out=True`` skips it and returns the spectrum in
  (ka, kb)-major order; ``permuted_in=True`` consumes that order.

**Collectives per call.** Every exchange is one ``all_to_all_single``
over contiguous (d, ...) chunks, both planes stacked in it, made by the
module-level :func:`_a2a` (tpufft moves each plane on its own and counts
twice as many). Calls of ``_a2a`` per call of:

* ``fft_distributed``: 3 in natural order, 2 with ``permuted_out``, 2
  with ``permuted_in``; the all-gather fallback none (one
  :func:`_all_gather` of the axis instead); d = 1 none;
* ``filter_distributed``: 4 on a four-step length (permuted out, then
  permuted in); 0 and 2 all-gathers on a fallback length;
* ``rfft_distributed``: the C2C's 3, plus 1 that moves the n//2+1 bins
  from the natural blocks to the block rule (4; with the fallback 1 and
  1 all-gather);
* ``irfft_distributed``: 1 that gathers each rank's direct and mirrored
  bins, plus the C2C's 3 (4; with the fallback 1 and 1 all-gather);
* ``fftn_distributed``: those of ``fft_distributed`` on ``dist_axis``.

At d > 1 each call also all-gathers the ranks' block lengths (one integer
a rank) once, before any exchange, so that blocks that break the rule
raise the same error on every rank instead of hanging a collective.
"""

from __future__ import annotations

import functools
import logging
import math

import numpy as np
import torch
import torch.distributed as dist

from . import api as _api
from .config import PlanConfig
from .core import SplitComplex
from .execute import _two_pass_twiddle, fft_axis
from .planner import default_bases, factorize

__all__ = [
    "split_n",
    "fft_distributed",
    "fftn_distributed",
    "rfft_distributed",
    "irfft_distributed",
    "fft_batch_sharded",
    "filter_distributed",
]


def split_n(n: int, d: int) -> tuple[int, int]:
    """Factor n = A * B with d | A and d | B, A as close to sqrt(n) as the
    factorization allows.

    The four-step decomposition needs the slow factor divisible by the
    device count (row-block sharding of a) and the fast factor divisible too
    (the all_to_all splits b into d blocks). Lengths with d | n but
    d^2 ∤ n cannot use this exchange pattern; ``fft_distributed`` falls
    back to the all_gather body for those (see ``_body_gather``).
    """
    if n % (d * d) != 0:
        raise ValueError(
            f"distributed FFT needs d^2 | n (n={n}, d={d}); pad the axis or "
            "use batch sharding instead"
        )
    a = d
    for f in sorted(factorize(n // (d * d)), reverse=True):
        if a * f <= math.isqrt(n):
            a *= f
    b = n // a
    assert a % d == 0 and b % d == 0
    return a, b


# ----------------------------------------------------------------------------
# The mesh and the collectives
# ----------------------------------------------------------------------------

def _mesh_dim(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"the mesh has no dimension {name!r} (its "
                         f"dimensions are {names})")
    return names.index(name)


def _axis_group(mesh, name: str):
    """(group, d, this rank's index) of mesh dimension ``name``."""
    i = _mesh_dim(mesh, name)
    return mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i)


def _a2a(x: torch.Tensor, group, in_splits=None, out_splits=None):
    """One exchange: ``x``'s leading chunks (d equal ones, or
    ``in_splits``) go to the group's ranks in order; returns what the
    ranks sent here, concatenated in rank order along dim 0."""
    x = x.contiguous()
    if out_splits is None:
        out = torch.empty_like(x)
    else:
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=group)
    return out


def _all_gather(x: torch.Tensor, group, d: int) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order: (d,) + x.shape."""
    parts = [torch.empty_like(x) for _ in range(d)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _block_lengths(length: int, group, d: int, device) -> list[int]:
    """Every rank's block length along the sharded axis, in rank order."""
    t = torch.tensor([length], dtype=torch.int64, device=device)
    return [int(v) for v in _all_gather(t, group, d).flatten().tolist()]


def _global_length(length: int, group, d: int, device) -> int:
    """n of a C2C axis whose blocks must each hold n/d."""
    if d == 1:
        return length
    lengths = _block_lengths(length, group, d, device)
    n = sum(lengths)
    if n % d != 0:
        raise ValueError(
            f"distributed FFT needs d | n for even shards (n={n}, d={d})")
    if any(v != n // d for v in lengths):
        raise ValueError(
            f"distributed FFT blocks must each hold n/d = {n // d} points "
            f"(n={n}, d={d}); got {lengths}")
    return n


def _local_planes(x, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's planes: ``SplitComplex`` planes and tensors where they
    lie, numpy on the mesh's device type."""
    sc = _api._as_split(x, mesh.device_type)
    return sc.re, sc.im


@functools.lru_cache(maxsize=16)
def _device_twiddle(a: int, b: int, inverse: bool, d: int, r: int,
                    by_rows: bool, dtype: torch.dtype, device: torch.device):
    """Rank r's slice of the inter-factor twiddle T[ka, b] (the host f64
    table of the two-pass split), ka-sharded (``by_rows``) or b-sharded,
    in the plane dtype on ``device``: f64 planes keep the f64 tier."""
    c, s = _two_pass_twiddle(a, b, inverse)
    if by_rows:
        sl = (slice(r * a // d, (r + 1) * a // d), slice(None))
    else:
        sl = (slice(None), slice(r * b // d, (r + 1) * b // d))
    return tuple(torch.from_numpy(np.ascontiguousarray(t[sl])).to(
        device, dtype) for t in (c, s))


def _twiddle_mul(ar, ai, twr, twi):
    return ar * twr - ai * twi, ar * twi + ai * twr


# ----------------------------------------------------------------------------
# The four-step bodies on (P, n/d) blocks
# ----------------------------------------------------------------------------

def _rows_to_cols(ar, ai, d: int, group) -> torch.Tensor:
    """(P, rows, d*bloc) -> (2, P, d, rows, bloc): send column block j to
    rank j; entry [., ., i, r, c] is global row i*rows + r, column
    me*bloc + c."""
    p, rows, cols = ar.shape
    x = torch.stack((ar.reshape(p, rows, d, cols // d),
                     ai.reshape(p, rows, d, cols // d)))
    y = _a2a(x.permute(3, 0, 1, 2, 4), group)
    return y.permute(1, 2, 0, 3, 4)


def _cols_to_rows(ar, ai, d: int, group) -> torch.Tensor:
    """(P, d*rows, bloc) -> (2, P, rows, d*bloc): send row block j to rank
    j; entry [., ., r, i*bloc + c] is global row me*rows + r, column
    i*bloc + c."""
    p, n_rows, bloc = ar.shape
    rows = n_rows // d
    x = torch.stack((ar.reshape(p, d, rows, bloc),
                     ai.reshape(p, d, rows, bloc)))
    y = _a2a(x.permute(2, 0, 1, 3, 4), group)
    return y.permute(1, 2, 3, 0, 4).reshape(2, p, rows, d * bloc)


def _body_natural_in(ar, ai, tw, *, A, B, d, group, inverse, scale,
                     natural_out, config):
    """Block-natural input (P, N/d): rows a of this rank's block, all b."""
    p = ar.shape[0]
    rows, bloc = A // d, B // d
    y = _rows_to_cols(ar.reshape(p, rows, B), ai.reshape(p, rows, B), d,
                      group).reshape(2, p, A, bloc)
    # FFT over a (length A, strided axis) for every local b column
    ar, ai = fft_axis(y[0], y[1], 1, default_bases(A), inverse=inverse,
                      scale=1.0, config=config)
    ar, ai = _twiddle_mul(ar, ai, *tw)   # T[ka, b], b-sharded slice
    y = _cols_to_rows(ar, ai, d, group)
    # FFT over b (length B, minor axis) for every local ka row; the norm
    # scale is folded in here
    ar, ai = fft_axis(y[0], y[1], 2, default_bases(B), inverse=inverse,
                      scale=scale, config=config)
    if not natural_out:
        return ar.reshape(p, rows * B), ai.reshape(p, rows * B)
    # rows ka, columns kb -> this rank's kb block, k_local = c*A + ka
    y = _rows_to_cols(ar, ai, d, group).permute(0, 1, 4, 2, 3)
    y = y.reshape(2, p, bloc * A)
    return y[0], y[1]


def _body_permuted_in(ar, ai, tw, *, A, B, d, group, inverse, scale,
                      config):
    """(ka, kb)-major input (P, N/d): rows ka of this rank's block, all kb;
    the mirror of ``_body_natural_in`` without its last exchange. Output
    is block-natural."""
    p = ar.shape[0]
    rows, bloc = A // d, B // d
    ar, ai = fft_axis(ar.reshape(p, rows, B), ai.reshape(p, rows, B), 2,
                      default_bases(B), inverse=inverse, scale=1.0,
                      config=config)
    ar, ai = _twiddle_mul(ar, ai, *tw)   # T[ka, b], ka-sharded slice
    y = _rows_to_cols(ar, ai, d, group).reshape(2, p, A, bloc)
    ar, ai = fft_axis(y[0], y[1], 1, default_bases(A), inverse=inverse,
                      scale=scale, config=config)
    y = _cols_to_rows(ar, ai, d, group).reshape(2, p, rows * B)
    return y[0], y[1]


def _body_gather(ar, ai, *, n, d, me, group, inverse, scale, config):
    """Fallback for lengths with d | n but d^2 ∤ n (no four-step exchange
    pattern exists): all-gather the axis, transform locally, keep this
    rank's output block.

    Communication is (d-1)/d of the axis per rank (vs ~2/d for the
    four-step) and every rank computes the full transform -- correct for
    any d | n, at a bandwidth/compute premium. Natural order in and out."""
    p, n_loc = ar.shape
    full = _all_gather(torch.stack((ar, ai)), group, d)   # (d, 2, P, n/d)
    full = full.permute(1, 2, 0, 3).reshape(2, p, n)
    ar, ai = fft_axis(full[0], full[1], 1, default_bases(n),
                      inverse=inverse, scale=scale, config=config)
    keep = slice(me * n_loc, (me + 1) * n_loc)
    return ar[:, keep], ai[:, keep]


def _distributed(xr, xi, mesh, *, axis_name, axis, n, inverse, norm,
                 batch_axis_name, permuted_in, permuted_out, config):
    """The C2C four-step on this rank's block of an axis of global length
    n (None: from the ranks' block lengths); returns the output block."""
    if permuted_in and permuted_out:
        raise ValueError("permuted_in and permuted_out are mutually exclusive")
    config = config or PlanConfig()
    group, d, me = _axis_group(mesh, axis_name)
    ndim = xr.ndim
    axis %= ndim
    if n is None:
        n = _global_length(xr.shape[axis], group, d, xr.device)
    gather_fallback = d > 1 and n % (d * d) != 0   # d | n holds here
    if gather_fallback:
        if permuted_in or permuted_out:
            raise ValueError(
                "permuted order requires the four-step exchange pattern "
                f"(d^2 | n); n={n}, d={d} uses the all_gather fallback"
            )
        logging.getLogger("tpufft_torch").info(
            "distributed FFT n=%d d=%d: d^2 does not divide n — using the "
            "all_gather fallback ((d-1)/d of the axis exchanged, full "
            "transform per device). A length with d^2 | n runs the "
            "four-step exchange instead.", n, d)
    if batch_axis_name is not None:
        _mesh_dim(mesh, batch_axis_name)
        if ndim < 2:
            raise ValueError(
                "batch_axis_name requires a batch dimension: the input is "
                f"{ndim}-dimensional and the transform axis is the only one")
    scale = _api._norm_scale(norm, n, inverse)
    if d == 1:
        return fft_axis(xr, xi, axis, default_bases(n), inverse=inverse,
                        scale=scale, config=config)
    mr, mi = xr.movedim(axis, -1), xi.movedim(axis, -1)
    pre = tuple(mr.shape[:-1])
    ar, ai = mr.reshape(-1, n // d), mi.reshape(-1, n // d)
    if gather_fallback:
        outr, outi = _body_gather(ar, ai, n=n, d=d, me=me, group=group,
                                  inverse=inverse, scale=scale, config=config)
    else:
        A, B = split_n(n, d)
        # T[ka, b]: the natural-in body takes it b-sharded, the permuted-in
        # body ka-sharded
        tw = _device_twiddle(A, B, bool(inverse), d, me, permuted_in,
                             ar.dtype, ar.device)
        if permuted_in:
            outr, outi = _body_permuted_in(
                ar, ai, tw, A=A, B=B, d=d, group=group, inverse=inverse,
                scale=scale, config=config)
        else:
            outr, outi = _body_natural_in(
                ar, ai, tw, A=A, B=B, d=d, group=group, inverse=inverse,
                scale=scale, natural_out=not permuted_out, config=config)
    out_shape = pre + (outr.shape[-1],)
    return (outr.reshape(out_shape).movedim(-1, axis),
            outi.reshape(out_shape).movedim(-1, axis))


def fft_distributed(
    x,
    mesh,
    *,
    axis_name: str,
    axis: int = -1,
    inverse: bool = False,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    permuted_in: bool = False,
    permuted_out: bool = False,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """1D FFT along ``axis`` block-sharded over mesh dimension
    ``axis_name``.

    ``x`` is this rank's block (``SplitComplex`` planes); the result is its
    output block, sharded the same way. ``permuted_out`` returns the
    spectrum in (ka, kb)-major order, saving one exchange; feed it back
    through ``permuted_in=True`` (e.g. for the inverse of an
    fft->filter->ifft pipeline). With ``batch_axis_name`` the batch axis is
    also blocked over that dimension (DP x SP over one 2D mesh).
    """
    xr, xi = _local_planes(x, mesh)
    return SplitComplex(*_distributed(
        xr, xi, mesh, axis_name=axis_name, axis=axis, n=None,
        inverse=inverse, norm=norm, batch_axis_name=batch_axis_name,
        permuted_in=permuted_in, permuted_out=permuted_out, config=config))


def fftn_distributed(
    x,
    mesh,
    *,
    axis_name: str,
    axes=None,
    dist_axis: int = -1,
    inverse: bool = False,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """ND FFT where ``dist_axis`` is block-sharded over ``axis_name`` and
    the remaining transformed axes are local to each rank.

    The local axes run as the port's ordinary plan on the block, with no
    collective, and the sharded axis runs the four-step distributed
    transform. Norms compose multiplicatively, so ``norm`` is simply passed
    to both steps.
    """
    xr, xi = _local_planes(x, mesh)
    ndim = xr.ndim
    axes_c = _api._canon_axes(ndim, axes)
    dist_axis = dist_axis % ndim
    if dist_axis not in axes_c:
        raise ValueError(f"dist_axis {dist_axis} not in axes {axes_c}")
    local_axes = tuple(a for a in axes_c if a != dist_axis)
    if local_axes:
        plan = _api.plan_fft(
            tuple(xr.shape), _complex_dtype(xr), axes=local_axes,
            inverse=inverse, norm=norm, config=config)
        xr, xi = plan(SplitComplex(xr, xi))
    return SplitComplex(*_distributed(
        xr, xi, mesh, axis_name=axis_name, axis=dist_axis, n=None,
        inverse=inverse, norm=norm, batch_axis_name=batch_axis_name,
        permuted_in=False, permuted_out=False, config=config))


def _complex_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.complex128 if t.dtype == torch.float64 else torch.complex64


# ----------------------------------------------------------------------------
# Real input and output: the Hermitian half follows the block rule
# ----------------------------------------------------------------------------

def _block(r: int, m: int, d: int) -> tuple[int, int]:
    """[start, stop) of rank r's block of a length-m axis over d ranks."""
    c = -(-m // d)
    return min(r * c, m), min((r + 1) * c, m)


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return lo, max(lo, hi)


def _bins_first(ar, ai, axis):
    """(2, P, L) planes of the axis moved minor, stacked; the shape of the
    other dims."""
    mr, mi = ar.movedim(axis, -1), ai.movedim(axis, -1)
    pre = tuple(mr.shape[:-1])
    flat = (math.prod(pre), mr.shape[-1])
    return torch.stack((mr.reshape(flat), mi.reshape(flat))), pre


def _move_bins(buf, sends, recv_sizes, group, d):
    """Send, to each rank j in order, the bins ``buf[..., lo:hi]`` of the
    ranges ``sends[j]`` ((2, P, L) planes), in one exchange (none at
    d = 1); returns the bins received, (2, P, sum(recv_sizes)), in rank
    order."""
    pieces = [buf[..., lo:hi] for ranges in sends for lo, hi in ranges]
    x = torch.cat(pieces, dim=-1) if pieces else buf[..., :0]
    if d == 1:
        return x
    send_sizes = [sum(hi - lo for lo, hi in ranges) for ranges in sends]
    y = _a2a(x.permute(2, 0, 1), group, send_sizes, list(recv_sizes))
    return y.permute(1, 2, 0)


@functools.lru_cache(maxsize=64)
def _half_plan(n: int, d: int, me: int):
    """rfft's bin move: natural block k in [me*n/d, ...) -> the block rule
    over the m = n//2+1 bins. (the local ranges sent to each rank, the
    bins received from each)."""
    m, L = n // 2 + 1, n // d
    mine = (me * L, (me + 1) * L)
    sends, recv_sizes = [], []
    for j in range(d):
        lo, hi = _overlap(mine, _block(j, m, d))
        sends.append([(lo - me * L, hi - me * L)] if hi > lo else [])
        lo, hi = _overlap((j * L, (j + 1) * L), _block(me, m, d))
        recv_sizes.append(hi - lo)
    return sends, recv_sizes


@functools.lru_cache(maxsize=64)
def _mirror_plan(n: int, m: int, d: int, me: int):
    """irfft's bin gather: rank j's natural block of the full spectrum,
    k in [j*L, (j+1)*L), needs the bins q = k for k <= n//2 and the
    mirrored bins q = n - k (conjugated) above, of the half spectrum's m
    bins held by the block rule (bins q >= m are zero). Each rank sends
    rank j its direct bins, then its mirrored ones, each an ascending
    range. Returns (the local ranges sent to each rank, for each source
    the (direct, mirrored) counts received, where the direct bins start in
    this rank's block, where the flipped mirrored bins start)."""
    m1, L = n // 2 + 1, n // d
    lo_mirror = n - m1        # bins 1 .. lo_mirror are mirrored

    def wants(j):
        direct = _overlap((j * L, (j + 1) * L), (0, min(m1, m)))
        mirror = _overlap((n - (j + 1) * L + 1, n - j * L + 1),
                          (1, min(lo_mirror, m - 1) + 1))
        return direct, mirror

    mine = _block(me, m, d)
    sends = []
    for j in range(d):
        ranges = [_overlap(r, mine) for r in wants(j)]
        sends.append([(lo - mine[0], hi - mine[0]) for lo, hi in ranges
                      if hi > lo])
    direct, mirror = wants(me)
    counts = []
    for i in range(d):
        src = _block(i, m, d)
        (dlo, dhi), (mlo, mhi) = _overlap(direct, src), _overlap(mirror, src)
        counts.append((dhi - dlo, mhi - mlo))
    # the mirrored bins q in [mirror) land at k = n - q, descending
    return (sends, counts, direct[0] - me * L,
            n - (mirror[1] - 1) - me * L)


def rfft_distributed(
    x,
    mesh,
    *,
    axis_name: str,
    axis: int = -1,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """Real-input FFT along a block-sharded ``axis``: returns this rank's
    block of the n//2+1 non-redundant bins as ``SplitComplex``, by the
    block rule (the last ranks' blocks are shorter, or empty).

    Runs the C2C four-step with a zero imaginary plane, then one exchange
    moves the Hermitian half from the natural blocks to the block rule.
    The half-length packing trick would halve the four-step's payload;
    tpufft keeps the C2C because the packing's stride-2 deinterleave costs
    on the TPU, and the port keeps its method."""
    xr, _ = _api.compute_tensor(x, mesh.device_type)
    if xr.is_complex():
        raise TypeError("rfft_distributed takes real input")
    ax = axis % xr.ndim
    yr, yi = _distributed(
        xr, torch.zeros_like(xr), mesh, axis_name=axis_name, axis=ax,
        n=None, inverse=False, norm=norm, batch_axis_name=batch_axis_name,
        permuted_in=False, permuted_out=False, config=config)
    group, d, me = _axis_group(mesh, axis_name)
    n = yr.shape[ax] * d
    buf, pre = _bins_first(yr, yi, ax)
    sends, recv_sizes = _half_plan(n, d, me)
    out = _move_bins(buf, sends, recv_sizes, group, d)
    shape = pre + (out.shape[-1],)
    return SplitComplex(out[0].reshape(shape).movedim(-1, ax),
                        out[1].reshape(shape).movedim(-1, ax))


def irfft_distributed(
    x,
    mesh,
    *,
    n: int | None = None,
    axis_name: str,
    axis: int = -1,
    norm: str | None = None,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
):
    """Inverse of ``rfft_distributed``: this rank's block of a Hermitian
    half spectrum (m bins along ``axis``, by the block rule) -> its block of
    the real output of length ``n`` (default 2*(m-1)), n/d points.

    One exchange gives each rank the bins of its natural block of the full
    spectrum: X[k] for k <= n//2 and conj(X[n-k]) above (bins beyond the m
    given are zero, numpy's zero-pad when n > 2*(m-1)); then the
    distributed C2C inverse, whose real plane is the result."""
    xr, xi = _local_planes(x, mesh)
    ax = axis % xr.ndim
    group, d, me = _axis_group(mesh, axis_name)
    length = xr.shape[ax]
    lengths = ([length] if d == 1
               else _block_lengths(length, group, d, xr.device))
    m = sum(lengths)
    if lengths != [_block(r, m, d)[1] - _block(r, m, d)[0]
                   for r in range(d)]:
        raise ValueError(
            f"half-spectrum blocks must follow the block rule over m={m} "
            f"bins and d={d} ranks; got {lengths}")
    if n is None:
        n = 2 * (m - 1)
    if n % d != 0:
        raise ValueError(
            f"distributed FFT needs d | n for even shards (n={n}, d={d})")
    buf, pre = _bins_first(xr, xi, ax)
    sends, counts, at_direct, at_mirror = _mirror_plan(n, m, d, me)
    got = _move_bins(buf, sends, [a + b for a, b in counts], group, d)
    direct, mirror, off = [], [], 0
    for n_direct, n_mirror in counts:
        direct.append(got[..., off:off + n_direct])
        mirror.append(got[..., off + n_direct:off + n_direct + n_mirror])
        off += n_direct + n_mirror
    direct = torch.cat(direct, dim=-1)
    mirror = torch.cat(mirror, dim=-1).flip(-1)
    full = got.new_zeros(got.shape[:2] + (n // d,))
    full[..., at_direct:at_direct + direct.shape[-1]] = direct
    k = slice(at_mirror, at_mirror + mirror.shape[-1])
    full[0, :, k] = mirror[0]
    full[1, :, k] = -mirror[1]   # conj(X[n - k])
    shape = pre + (n // d,)
    fr = full[0].reshape(shape).movedim(-1, ax)
    fi = full[1].reshape(shape).movedim(-1, ax)
    outr, _ = _distributed(
        fr, fi, mesh, axis_name=axis_name, axis=ax, n=n, inverse=True,
        norm=norm, batch_axis_name=batch_axis_name, permuted_in=False,
        permuted_out=False, config=config)
    return outr


def fft_batch_sharded(
    x,
    mesh,
    *,
    batch_axis_name: str,
    axes=None,
    inverse: bool = False,
    norm: str | None = None,
    batch_dim: int = 0,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """ND FFT with the batch dimension sharded across the mesh (DP analog).

    Each rank runs the port's ordinary local plan on its batch block; no
    collective. The transform axes must not include ``batch_dim``.
    """
    xr, xi = _local_planes(x, mesh)
    _mesh_dim(mesh, batch_axis_name)
    ndim = xr.ndim
    if not -ndim <= batch_dim < ndim:
        raise ValueError(f"batch_dim {batch_dim} out of range for "
                         f"{ndim}-dim input")
    batch_dim %= ndim
    axes_c = _api._canon_axes(ndim, axes) if axes is not None else tuple(
        a for a in range(ndim) if a != batch_dim
    )
    if batch_dim in axes_c:
        raise ValueError("batch_dim cannot be a transformed axis")
    plan = _api.plan_fft(tuple(xr.shape), _complex_dtype(xr), axes=axes_c,
                         inverse=inverse, norm=norm, config=config)
    return plan(SplitComplex(xr, xi))


def _response_block(H: np.ndarray, A, B, d: int, me: int,
                    dtype: torch.dtype, device) -> torch.Tensor:
    """This rank's block of H (complex128, host) in the order of its
    spectrum block -- natural, or (ka, kb)-major when A and B are given,
    where position (ka, kb) holds frequency kb*A + ka -- as (2, n/d)
    planes in ``dtype`` on ``device``. Only the block is converted on the
    host and uploaded."""
    if A is None:
        n_loc = H.size // d
        blk = H[me * n_loc:(me + 1) * n_loc].reshape(1, n_loc)
    else:
        rows = A // d
        blk = H.reshape(B, A)[:, me * rows:(me + 1) * rows]   # [kb, ka]
    host = np.float64 if dtype == torch.float64 else np.float32
    pairs = np.ascontiguousarray(blk.view(np.float64), host)
    t = torch.from_numpy(pairs).to(device).view(*blk.shape, 2)
    if A is not None:
        t = t.transpose(0, 1)   # [ka, kb]
    return t.permute(2, 0, 1).reshape(2, -1).to(dtype)


def filter_distributed(
    x,
    mesh,
    *,
    axis_name: str,
    response=None,
    impulse=None,
    axis: int = -1,
    batch_axis_name: str | None = None,
    config: PlanConfig | None = None,
) -> SplitComplex:
    """Sharded circular filter ``ifft(fft(x) * H)`` along a distributed
    axis — the fft->pointwise->ifft spectral pipeline in FOUR exchanges
    instead of six.

    The forward runs ``permuted_out`` (the spectrum stays in (ka, kb)-major
    four-step order, skipping the reorder exchange), H is applied
    pre-permuted to match, and the inverse consumes the permuted order
    directly (``permuted_in``). H is built on the host in complex128
    (``response``, or the FFT of ``impulse``) and only this rank's slice is
    uploaded, in the plane dtype. Lengths whose factorization cannot use
    the exchange pattern (d^2 not dividing n) and d = 1 run the
    natural-order pipeline.
    """
    if (response is None) == (impulse is None):
        raise ValueError("give exactly one of response= or impulse=")
    xr, xi = _local_planes(x, mesh)
    ax = axis % xr.ndim
    group, d, me = _axis_group(mesh, axis_name)
    n = _global_length(xr.shape[ax], group, d, xr.device)
    if impulse is not None:
        H = np.fft.fft(np.asarray(impulse, np.complex128))
    else:
        H = np.asarray(response, np.complex128)
    if H.shape != (n,):
        raise ValueError(f"response/impulse must have shape ({n},)")
    # d == 1 runs the plain local transform (natural order, no exchange
    # pattern): a permuted H there would be applied to natural-order data
    permuted = False
    if d > 1:
        try:
            A, B = split_n(n, d)
            permuted = True
        except ValueError:
            pass
    common = dict(axis_name=axis_name, axis=ax, n=n, norm=None,
                  batch_axis_name=batch_axis_name, config=config)
    sr, si = _distributed(xr, xi, mesh, inverse=False, permuted_in=False,
                          permuted_out=permuted, **common)
    shape = [1] * xr.ndim
    shape[ax] = n // d
    hr, hi = (h.reshape(shape) for h in _response_block(
        H, A if permuted else None, B if permuted else None, d, me,
        sr.dtype, sr.device))
    yr = sr * hr - si * hi
    yi = sr * hi + si * hr
    common["norm"] = "backward"
    return SplitComplex(*_distributed(
        yr, yi, mesh, inverse=True, permuted_in=permuted, permuted_out=False,
        **common))

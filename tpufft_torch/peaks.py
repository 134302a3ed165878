"""Peak finding (counterpart of ``tpufft/peaks.py``): ``find_peaks``,
``peak_prominences``, ``peak_widths``, ``argrelextrema``, ``argrelmax``,
``argrelmin`` and ``find_peaks_cwt``.

What is defined by scipy.signal (``_peak_finding.py``): the semantics, the
tie rules and the error messages that the parity tests pin. The
implementation is this module's own, in tensor operations on the device
where the signal lies:

* local maxima are the runs of equal samples (a change mask) whose left
  and right neighbours are both lower; a plateau touching either end is
  no peak, a plateau's peak is its midpoint rounded down;
* prominences and widths are range searches over sparse tables of the
  signal's maxima and minima on windows of 2^k samples (``_Ranges``):
  each walk of scipy's scalar loop becomes one descent over the levels
  for every peak at once;
* ``distance`` keeps the greedy keep-highest-first set, computed in
  rounds: in each round every undecided peak that outranks all undecided
  peaks within range is kept and its neighbours are dropped;
* ``find_peaks_cwt``'s transform is one float64 sliding product of the
  signal with every width's kernel, and its ridge lines are built on the
  host from the coordinates of the rows' maxima (the one copy to the
  host), a row of attachments at a time.

The peak functions decide in float64, as scipy does: a float32 tensor is
cast to float64 on its device first, so indices equal scipy's and the
properties agree to rounding. ``argrel*`` compare in the input's dtype.

Input forms: a tensor runs where it lies and the results are tensors there
(indices int64, properties float64); numpy input runs on ``device`` (None:
the CUDA device, ``api.numpy_device``) and comes back as numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .api import numpy_device

__all__ = ["find_peaks", "find_peaks_cwt", "peak_prominences",
           "peak_widths", "argrelmin", "argrelmax", "argrelextrema"]

# rounds the last ``distance`` thinning took (read by chip_smoke)
distance_rounds = 0

_TORCH_COMPARE = {np.greater: torch.gt, np.less: torch.lt,
                  np.greater_equal: torch.ge, np.less_equal: torch.le,
                  np.equal: torch.eq, np.not_equal: torch.ne}

# elements a block of sliding windows holds at once (the CWT's product,
# the noise percentiles)
_BLOCK_ELEMENTS = 1 << 24


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensor(x, device, dtype=None):
    """(x as a tensor, whether it came as numpy); numpy goes to
    ``numpy_device(device)``, a tensor stays where it lies."""
    if isinstance(x, torch.Tensor):
        return (x if dtype is None else x.to(dtype)), False
    xn = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(xn).to(numpy_device(device))
    return (t if dtype is None else t.to(dtype)), True


def _line(x, device) -> tuple[torch.Tensor, bool]:
    """A 1-D signal in float64 on its device."""
    t, as_numpy = _tensor(x, device, torch.float64)
    if t.ndim != 1:
        raise ValueError("x must be a 1-D array")
    return t, as_numpy


def _out(value, as_numpy: bool):
    if isinstance(value, dict):
        return {k: _out(v, as_numpy) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_out(v, as_numpy) for v in value)
    return _host(value) if as_numpy else value


# ---------------------------------------------------------------------------
# Relative extrema


def _extrema_mask(data: torch.Tensor, compare, axis: int, order: int,
                  mode: str) -> torch.Tensor:
    """True where ``compare(data, neighbour)`` holds for every neighbour
    up to ``order`` samples away along ``axis``; past the ends the index
    clips ('clip') or wraps ('wrap')."""
    if int(order) != order or order < 1:
        raise ValueError("Order must be an int >= 1")
    if mode not in ("clip", "wrap"):
        raise ValueError(f"mode must be 'clip' or 'wrap', got {mode!r}")
    n = data.shape[axis]
    pos = torch.arange(n, device=data.device)
    hit = torch.ones(data.shape, dtype=torch.bool, device=data.device)
    for shift in range(1, int(order) + 1):
        for step in (shift, -shift):
            idx = pos + step
            idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
            hit &= compare(data, data.index_select(axis, idx))
    return hit


def argrelextrema(data, comparator, axis: int = 0, order: int = 1,
                  mode: str = "clip", *, device=None):
    """Indices of relative extrema under ``comparator``
    (scipy.signal.argrelextrema-compatible): the points that compare true
    against every neighbour within ``order`` samples on both sides, the
    ends handled by ``mode`` ('clip' or 'wrap'). numpy's comparison ufuncs
    map to torch's; another comparator is called on tensors. Returns one
    index array per dimension."""
    t, as_numpy = _tensor(data, device)
    hit = _extrema_mask(t, _TORCH_COMPARE.get(comparator, comparator),
                        axis, order, mode)
    return _out(torch.nonzero(hit, as_tuple=True), as_numpy)


def argrelmax(data, axis: int = 0, order: int = 1, mode: str = "clip", *,
              device=None):
    """Indices of relative maxima (scipy.signal.argrelmax-compatible:
    strictly above every neighbour in range, so a plateau's samples are
    no maxima; ``find_peaks`` handles plateaus)."""
    t, as_numpy = _tensor(data, device)
    hit = _extrema_mask(t, torch.gt, axis, order, mode)
    return _out(torch.nonzero(hit, as_tuple=True), as_numpy)


def argrelmin(data, axis: int = 0, order: int = 1, mode: str = "clip", *,
              device=None):
    """Indices of relative minima (scipy.signal.argrelmin-compatible)."""
    t, as_numpy = _tensor(data, device)
    hit = _extrema_mask(t, torch.lt, axis, order, mode)
    return _out(torch.nonzero(hit, as_tuple=True), as_numpy)


# ---------------------------------------------------------------------------
# Range searches


def _levels(span: int) -> int:
    """The top level a search over ``span`` samples needs: floor(log2)."""
    return max(int(span), 1).bit_length() - 1


class _Ranges:
    """Sparse tables of x's running maxima and minima: row k of a table
    holds the extreme of x[i : i + 2^k] at i (past the end, of what is
    left). Each search below is a descent from the top level to level 0,
    one gathered comparison per level for every query at once."""

    def __init__(self, x: torch.Tensor, levels: int):
        self.x = x
        self.levels = levels
        self._tables = {}

    def table(self, op) -> torch.Tensor:
        if op not in self._tables:
            n = self.x.shape[0]
            tab = torch.empty((self.levels + 1, n), dtype=self.x.dtype,
                              device=self.x.device)
            tab[0] = self.x
            for k in range(1, self.levels + 1):
                h = 1 << (k - 1)
                tab[k, :n - h] = op(tab[k - 1, :n - h], tab[k - 1, h:])
                tab[k, n - h:] = tab[k - 1, n - h:]
            self._tables[op] = tab
        return self._tables[op]

    def extend_left(self, op, end, floor, keep):
        """The least s >= floor with ``keep(table(op)[k, s])`` true for the
        blocks that tile [s, end): every sample of [s, end) passes."""
        tab = self.table(op)
        cur = end.clone()
        for k in range(self.levels, -1, -1):
            cand = cur - (1 << k)
            vals = tab[k].gather(0, cand.clamp(min=0))
            cur = torch.where((cand >= floor) & keep(vals), cand, cur)
        return cur

    def extend_right(self, op, start, ceil, keep):
        """The greatest e <= ceil with every sample of [start, e) passing
        ``keep``."""
        tab = self.table(op)
        n = self.x.shape[0]
        cur = start.clone()
        for k in range(self.levels, -1, -1):
            cand = cur + (1 << k)
            vals = tab[k].gather(0, cur.clamp(max=n - 1))
            cur = torch.where((cand <= ceil) & keep(vals), cand, cur)
        return cur

    def extreme(self, op, lo, hi):
        """op over x[lo .. hi] (inclusive, lo <= hi): two overlapping
        blocks of the largest power of two that fits."""
        tab = self.table(op)
        k = torch.frexp((hi - lo + 1).to(torch.float64)).exponent - 1
        return op(tab[k, lo], tab[k, hi - (1 << k) + 1])


def _window(wlen) -> int | None:
    if wlen is None:
        return None
    if wlen <= 1:
        raise ValueError("wlen must be larger than 1")
    return int(math.ceil(wlen))   # scipy: any value above 1 rounds up


def _prominences(ranges: _Ranges, peaks: torch.Tensor, wlen):
    """(prominences, left bases, right bases). Each side's stretch runs
    from the peak to the nearest higher sample, or to the edge of the
    window of wlen // 2 samples each side; its base is the stretch's
    minimum, the rightmost one on the left and the leftmost on the right
    (scipy's walks move only on a strictly lower sample)."""
    x = ranges.x
    n = x.shape[0]
    top = x[peaks]
    lo_edge = torch.zeros_like(peaks)
    hi_edge = torch.full_like(peaks, n - 1)
    if wlen is not None:
        lo_edge = (peaks - wlen // 2).clamp(min=0)
        hi_edge = (peaks + wlen // 2).clamp(max=n - 1)

    def below(v):
        return v <= top

    left = ranges.extend_left(torch.maximum, peaks, lo_edge, below)
    right = ranges.extend_right(torch.maximum, peaks + 1, hi_edge + 1,
                                below) - 1
    left_min = ranges.extreme(torch.minimum, left, peaks)
    right_min = ranges.extreme(torch.minimum, peaks, right)
    left_base = ranges.extend_left(torch.minimum, peaks + 1, left,
                                   lambda v: v > left_min) - 1
    right_base = ranges.extend_right(torch.minimum, peaks, right + 1,
                                     lambda v: v > right_min)
    return top - torch.maximum(left_min, right_min), left_base, right_base


def _as_peaks(peaks, x: torch.Tensor) -> torch.Tensor:
    p = peaks.to(x.device) if isinstance(peaks, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(np.asarray(peaks))).to(x.device)
    if p.numel() and (p.is_floating_point() or p.is_complex()
                      or p.dtype == torch.bool):
        raise TypeError("peaks must be integer indices")
    p = p.long()
    if p.ndim != 1:
        raise ValueError("peaks must be a 1-D array")
    if p.numel() and bool(((p < 0) | (p >= x.shape[0])).any()):
        raise ValueError("a peak index is out of range for x")
    return p


def peak_prominences(x, peaks, wlen=None, *, device=None):
    """Prominence of each peak (scipy.signal.peak_prominences-compatible):
    its height above the higher of its two bases. Returns (prominences,
    left_bases, right_bases)."""
    xt, as_numpy = _line(x, device)
    p = _as_peaks(peaks, xt)
    wlen = _window(wlen)
    n = xt.shape[0]
    ranges = _Ranges(xt, _levels(n if wlen is None else min(n, wlen)))
    return _out(_prominences(ranges, p, wlen), as_numpy)


def _widths(ranges: _Ranges, peaks, rel_height, prominence, left_base,
            right_base):
    """(widths, width_heights, left_ips, right_ips): on each side the
    nearest sample at or below the line at ``rel_height`` of the
    prominence, searched from the peak and bounded by the base, then the
    crossing interpolated linearly."""
    x = ranges.x
    height = x[peaks] - prominence * rel_height

    def above(v):
        return v > height

    i = ranges.extend_left(torch.minimum, peaks + 1, left_base + 1,
                           above) - 1
    xi = x[i]
    left_ip = i.to(torch.float64)
    step = (height - xi) / (x[(i + 1).clamp(max=x.shape[0] - 1)] - xi)
    left_ip = torch.where(xi < height, left_ip + step, left_ip)
    j = ranges.extend_right(torch.minimum, peaks, right_base, above)
    xj = x[j]
    right_ip = j.to(torch.float64)
    step = (height - xj) / (x[(j - 1).clamp(min=0)] - xj)
    right_ip = torch.where(xj < height, right_ip - step, right_ip)
    return right_ip - left_ip, height, left_ip, right_ip


def peak_widths(x, peaks, rel_height: float = 0.5, prominence_data=None,
                wlen=None, *, device=None):
    """Width of each peak at a relative height
    (scipy.signal.peak_widths-compatible): where the line at
    ``peak - prominence * rel_height`` crosses the signal, interpolated,
    bounded by the prominence bases. Returns (widths, width_heights,
    left_ips, right_ips)."""
    xt, as_numpy = _line(x, device)
    p = _as_peaks(peaks, xt)
    if rel_height < 0:
        raise ValueError("rel_height must be >= 0")
    n = xt.shape[0]
    wlen = _window(wlen)
    if prominence_data is None:
        ranges = _Ranges(xt, _levels(n if wlen is None else min(n, wlen)))
        prominence_data = _prominences(ranges, p, wlen)
    else:
        # bases given by the caller may lie anywhere in x
        ranges = _Ranges(xt, _levels(n))
    prom, lb, rb = (v.to(xt.device) if isinstance(v, torch.Tensor) else
                    torch.as_tensor(np.asarray(v), device=xt.device)
                    for v in prominence_data)
    if not (prom.shape == lb.shape == rb.shape == p.shape):
        raise ValueError("prominence_data is invalid for peaks")
    prom, lb, rb = prom.to(torch.float64), lb.long(), rb.long()
    bad = ~((0 <= lb) & (lb <= p) & (p <= rb) & (rb < n))
    if bool(bad.any()):
        first = int(p[torch.nonzero(bad)[0, 0]])
        raise ValueError(f"prominence data is invalid for peak {first}")
    return _out(_widths(ranges, p, rel_height, prom, lb, rb), as_numpy)


# ---------------------------------------------------------------------------
# find_peaks


def _plateau_maxima(x: torch.Tensor):
    """(midpoints, left edges, right edges) of the local maxima: runs of
    equal samples whose outer neighbours are both lower."""
    n = x.shape[0]
    if n < 3:
        none = torch.zeros(0, dtype=torch.int64, device=x.device)
        return none, none, none
    fresh = torch.ones(n, dtype=torch.bool, device=x.device)
    fresh[1:] = x[1:] != x[:-1]
    left = torch.nonzero(fresh)[:, 0]
    right = torch.cat([left[1:] - 1, left.new_full((1,), n - 1)])
    inner = (left >= 1) & (right <= n - 2)
    rises = x[(left - 1).clamp(min=0)] < x[left]
    falls = x[(right + 1).clamp(max=n - 1)] < x[right]
    top = inner & rises & falls
    left, right = left[top], right[top]
    return (left + right) // 2, left, right


def _bound(value, n: int, side: str, dev):
    """One side of a condition: None, a number, or an array as long as x
    (returned as a float64 tensor on ``dev``)."""
    if not isinstance(value, (np.ndarray, torch.Tensor)) or value.ndim == 0:
        return value
    size = value.numel() if isinstance(value, torch.Tensor) else value.size
    if size != n:
        raise ValueError(f"array size of {side} interval border must "
                         "match x")
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.asarray(value, np.float64))
    return value.to(dev, torch.float64).reshape(-1)


def _condition(cond, n: int, dev):
    """(lower, upper) of a find_peaks condition: anything of length two
    bounds both sides (None leaves one open), anything else bounds
    below."""
    try:
        pair = len(cond) == 2
    except TypeError:
        pair = False
    lower, upper = cond if pair else (cond, None)
    return _bound(lower, n, "lower", dev), _bound(upper, n, "upper", dev)


def _inside(value, lower, upper, peaks):
    """Which values lie in [lower, upper]; array bounds are read at the
    peaks."""
    def at(bound):
        return bound[peaks] if isinstance(bound, torch.Tensor) \
            and bound.ndim else bound

    keep = torch.ones(value.shape, dtype=torch.bool, device=value.device)
    if lower is not None:
        keep &= at(lower) <= value
    if upper is not None:
        keep &= value <= at(upper)
    return keep


def _rank(peaks: torch.Tensor, heights: torch.Tensor, reach: int):
    """Each peak's priority rank for the thinning: by height, ties in the
    order scipy's own ``np.argsort`` gives them, which is not stable. The
    order matters only where equal heights lie within reach of each
    other; elsewhere the device's stable sort decides alike."""
    order = torch.sort(heights, stable=True).indices
    h, p = heights[order], peaks[order]
    if bool(((h[1:] == h[:-1]) & (p[1:] - p[:-1] < reach)).any()):
        order = torch.from_numpy(np.argsort(_host(heights))).to(
            heights.device)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


def _thin(peaks: torch.Tensor, heights: torch.Tensor, distance) -> \
        torch.Tensor:
    """The peaks that the greedy keep-highest-first pass keeps when no two
    kept peaks may lie closer than ``ceil(distance)``, in rounds: an
    undecided peak that outranks every undecided peak within reach is
    kept, and the undecided peaks within its reach are dropped."""
    global distance_rounds
    reach = math.ceil(distance)
    m = peaks.numel()
    keep = torch.zeros(m, dtype=torch.bool, device=peaks.device)
    distance_rounds = 0
    if m == 0:
        return keep
    rank = _rank(peaks, heights, reach)
    first = torch.searchsorted(peaks, peaks - (reach - 1))
    last = torch.searchsorted(peaks, peaks + (reach - 1), right=True) - 1
    undecided = torch.ones_like(keep)
    while True:
        distance_rounds += 1
        live = torch.where(undecided, rank, -1)
        best = _Ranges(live, _levels(min(m, 2 * reach - 1))).extreme(
            torch.maximum, first, last)
        chosen = undecided & (live == best)
        keep |= chosen
        cover = torch.zeros(m + 1, dtype=torch.int32, device=peaks.device)
        cover.index_add_(0, first, chosen.int())
        cover.index_add_(0, last + 1, -chosen.int())
        undecided &= torch.cumsum(cover[:m], 0) == 0
        if not bool(undecided.any()):
            return keep


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen=None,
               rel_height: float = 0.5, plateau_size=None, *, device=None):
    """Local maxima subject to property conditions
    (scipy.signal.find_peaks-compatible): plateau-aware maxima, filtered
    in scipy's documented order (plateau_size, height, threshold,
    distance, prominence, width), with every property evaluated on the
    way in the returned dict. A condition is a number (lower bound), a
    (lower, upper) pair with None for an open side, or an array as long as
    x read at each peak."""
    xt, as_numpy = _line(x, device)
    if distance is not None and distance < 1:
        raise ValueError("distance must be greater or equal to 1")
    n = xt.shape[0]
    wlen = _window(wlen)
    peaks, left_edges, right_edges = _plateau_maxima(xt)
    props: dict = {}

    def narrow(keep):
        nonlocal peaks
        peaks = peaks[keep]
        for key in props:
            props[key] = props[key][keep]

    def bounds(cond):
        return _condition(cond, n, xt.device)

    if plateau_size is not None:
        sizes = right_edges - left_edges + 1
        keep = _inside(sizes, *bounds(plateau_size), peaks)
        props.update(plateau_sizes=sizes, left_edges=left_edges,
                     right_edges=right_edges)
        narrow(keep)
    if height is not None:
        props["peak_heights"] = xt[peaks]
        narrow(_inside(props["peak_heights"], *bounds(height), peaks))
    if threshold is not None:
        top = xt[peaks]
        steps = torch.stack([top - xt[peaks - 1], top - xt[peaks + 1]])
        lower, upper = bounds(threshold)
        keep = _inside(steps.amin(0), lower, None, peaks) & \
            _inside(steps.amax(0), None, upper, peaks)
        props.update(left_thresholds=steps[0], right_thresholds=steps[1])
        narrow(keep)
    if distance is not None:
        narrow(_thin(peaks, xt[peaks], distance))
    if prominence is not None or width is not None:
        ranges = _Ranges(xt, _levels(n if wlen is None else min(n, wlen)))
        props.update(zip(("prominences", "left_bases", "right_bases"),
                         _prominences(ranges, peaks, wlen)))
    if prominence is not None:
        narrow(_inside(props["prominences"], *bounds(prominence), peaks))
    if width is not None:
        props.update(zip(("widths", "width_heights", "left_ips",
                          "right_ips"),
                         _widths(ranges, peaks, rel_height,
                                 props["prominences"], props["left_bases"],
                                 props["right_bases"])))
        narrow(_inside(props["widths"], *bounds(width), peaks))
    return _out(peaks, as_numpy), _out(props, as_numpy)


# ---------------------------------------------------------------------------
# find_peaks_cwt


def _ricker(points, a: float) -> np.ndarray:
    """The Ricker (Mexican hat) wavelet on ``points`` samples:
    2 / (sqrt(3 a) pi^(1/4)) (1 - (t / a)^2) exp(-t^2 / (2 a^2))."""
    t = np.arange(0, points) - (points - 1.0) / 2
    scale = 2 / (math.sqrt(3 * a) * math.pi ** 0.25)
    return scale * (1 - (t / a) ** 2) * np.exp(-t * t / (2 * a * a))


def _cwt(signal: torch.Tensor, wavelet, widths) -> torch.Tensor:
    """(widths, N) float64: row w is np.convolve(signal, k_w, "same") with
    k_w = conj(wavelet(min(10 w, N), w))[::-1], real part kept. Every row
    is one sliding product out[i] = sum_t signal[i + t] g_w[t] over a
    common tap range, in blocks of samples."""
    N = signal.shape[0]
    kernels = []
    for w in widths:
        k = np.conj(np.asarray(wavelet(np.min([10 * w, N]), w))[::-1])
        if k.size > N:
            raise ValueError("the wavelet is longer than the signal")
        kernels.append(k)
    # tap t of row w multiplies signal[i + t]: t from c - K + 1 to c, with
    # c = (K - 1) // 2 the 'same' mode's centre
    lo = min((k.size - 1) // 2 - k.size + 1 for k in kernels)
    hi = max((k.size - 1) // 2 for k in kernels)
    G = np.zeros((len(kernels), hi - lo + 1), np.complex128)
    for r, k in enumerate(kernels):
        c = (k.size - 1) // 2
        G[r, c - k.size + 1 - lo:c + 1 - lo] = k[::-1]
    dev = signal.device
    planes = [(signal.real if signal.is_complex() else signal, G.real)]
    if signal.is_complex():
        planes.append((signal.imag, -G.imag))
    out = torch.zeros((len(kernels), N), dtype=torch.float64, device=dev)
    span = G.shape[1]
    step = max(1, _BLOCK_ELEMENTS // span)
    for plane, taps in planes:
        padded = torch.nn.functional.pad(plane, (-lo, hi))
        g = torch.as_tensor(taps.T, dtype=torch.float64, device=dev)
        for s in range(0, N, step):
            e = min(N, s + step)
            out[:, s:e] += (padded[s:e + span - 1].unfold(0, span, 1)
                            @ g).T
    return out


class _Ridges:
    """Ridge lines of the CWT maxima, walked from the largest width down
    (Du, Kibbe and Lin 2006). Alive lines are arrays in creation order:
    the last column each took, its row, how many maxima it holds and how
    many rows it has gone without one. Only what the filter reads is
    kept: a line's length and its last maximum, which is the one at its
    smallest row (the line's first point once sorted by row)."""

    def __init__(self, cols: np.ndarray, row: int):
        self.col = cols.copy()
        self.row = np.full(cols.size, row)
        self.size = np.ones(cols.size, np.int64)
        self.gap = np.zeros(cols.size, np.int64)
        self.ended: list = []

    def _nearest(self, cols: np.ndarray) -> np.ndarray:
        """For each column, the alive line whose last column is closest;
        of equal distances the line created first."""
        order = np.lexsort((np.arange(self.col.size), self.col))
        ends = self.col[order]
        at = np.searchsorted(ends, cols)
        right = np.minimum(at, ends.size - 1)
        left_val = ends[np.maximum(at - 1, 0)]
        left = np.searchsorted(ends, left_val)      # first of its group
        d_right = np.where(at < ends.size, ends[right] - cols, np.inf)
        d_left = np.where(at > 0, cols - left_val, np.inf)
        pick_right = (d_right < d_left) | (
            (d_right == d_left) & (order[right] < order[left]))
        return np.where(pick_right, order[right], order[left])

    def step(self, row: int, cols: np.ndarray, reach: float,
             gap_limit: float) -> None:
        """One row's maxima (ascending): each joins its nearest line when
        within ``reach`` (several may join one line), the rest start
        lines; lines gone more than ``gap_limit`` rows end."""
        self.gap += 1
        if cols.size and self.col.size:
            target = self._nearest(cols)
            joins = np.abs(cols - self.col[target]) <= reach
            t, c = target[joins], cols[joins]
            np.add.at(self.size, t, 1)
            last = np.full(self.col.size, -1)
            np.maximum.at(last, t, c)
            took = last >= 0
            self.col[took] = last[took]
            self.row[took] = row
            self.gap[took] = 0
            cols = cols[~joins]
        if cols.size:
            self.col = np.concatenate([self.col, cols])
            self.row = np.concatenate([self.row, np.full(cols.size, row)])
            self.size = np.concatenate([self.size,
                                        np.ones(cols.size, np.int64)])
            self.gap = np.concatenate([self.gap,
                                       np.zeros(cols.size, np.int64)])
        done = self.gap > gap_limit
        if done.any():
            self.ended.append((self.size[done], self.row[done],
                               self.col[done]))
            alive = ~done
            self.col, self.row = self.col[alive], self.row[alive]
            self.size, self.gap = self.size[alive], self.gap[alive]

    def lines(self):
        """(length, row, col of the last maximum) of every line."""
        parts = self.ended + [(self.size, self.row, self.col)]
        return tuple(np.concatenate(v) for v in zip(*parts))


def _ridge_lines(maxima: np.ndarray, rows: int, reach, gap_limit):
    """(length, row, col of the last maximum) of each ridge line through
    the maxima (K, 2), their (row, col) in row-major order."""
    row_of, col_of = maxima[:, 0], maxima[:, 1]
    bounds = np.searchsorted(row_of, np.arange(rows + 1))
    top = int(row_of[-1])
    walk = _Ridges(col_of[bounds[top]:bounds[top + 1]], top)
    for r in range(top - 1, -1, -1):
        walk.step(r, col_of[bounds[r]:bounds[r + 1]], reach[r], gap_limit)
    return walk.lines()


def _noise_floor(row: torch.Tensor, cols: torch.Tensor, window: int,
                 perc: float) -> torch.Tensor:
    """np.percentile(row[max(c - h, 0):min(c + h + odd, N)], perc) (linear
    interpolation, as numpy computes it) at each column c, with
    h, odd = divmod(window, 2)."""
    N = row.shape[0]
    half, odd = divmod(window, 2)
    start = (cols - half).clamp(min=0)
    count = (cols + half + odd).clamp(max=N) - start
    q = perc / 100
    out = torch.empty(cols.shape, dtype=torch.float64, device=row.device)
    step = max(1, _BLOCK_ELEMENTS // max(window, 1))
    span = torch.arange(max(window, 1), device=row.device)
    for s in range(0, cols.numel(), step):
        st, ct = start[s:s + step], count[s:s + step]
        idx = st[:, None] + span
        vals = torch.where(span < ct[:, None], row[idx.clamp(max=N - 1)],
                           torch.inf).sort(1).values
        virtual = (ct - 1).to(torch.float64) * q
        below = torch.floor(virtual)
        top = virtual >= ct - 1
        i0 = torch.where(top, ct - 1, below.long().clamp(min=0))
        i1 = torch.where(top, ct - 1, (i0 + 1).clamp(max=ct - 1))
        a = vals.gather(1, i0[:, None])[:, 0]
        b = vals.gather(1, i1[:, None])[:, 0]
        gamma = virtual - below
        diff = b - a
        out[s:s + step] = torch.where(gamma >= 0.5, b - diff * (1 - gamma),
                                      a + diff * gamma)
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1,
                   noise_perc: float = 10, window_size=None, *,
                   device=None):
    """Wavelet-ridge peak detection (scipy.signal.find_peaks_cwt-
    compatible): the CWT with Ricker wavelets (or ``wavelet``, called on
    the host) over ``widths``, the rows' maxima joined into ridge lines
    from the largest width down, and the lines that are long enough and
    whose smallest-width SNR reaches ``min_snr``. Returns their columns,
    sorted."""
    widths = np.atleast_1d(np.asarray(widths))
    gap_limit = np.ceil(widths[0]) if gap_thresh is None else gap_thresh
    reach = widths / 4.0 if max_distances is None else max_distances
    sig, as_numpy = _tensor(vector, device)
    sig = sig.to(torch.complex128 if sig.is_complex() else torch.float64)
    cwt = _cwt(sig, _ricker if wavelet is None else wavelet, widths)
    rows, N = cwt.shape
    if len(reach) < rows:
        raise ValueError("max_distances must have at least as many "
                         "rows as matr")
    found = torch.zeros(0, dtype=torch.int64, device=sig.device)
    maxima = _host(torch.nonzero(_extrema_mask(cwt, torch.gt, 1, 1,
                                               "clip")))
    if maxima.size:
        length, first_row, first_col = _ridge_lines(maxima, rows, reach,
                                                    gap_limit)
        need = np.ceil(rows / 4) if min_length is None else min_length
        long_enough = length >= need
        r0 = torch.as_tensor(first_row[long_enough], device=sig.device)
        c0 = torch.as_tensor(first_col[long_enough], device=sig.device)
        window = int(np.ceil(N / 20) if window_size is None
                     else window_size)
        noise = _noise_floor(cwt[0], c0, window, noise_perc)
        snr = (cwt[r0, c0] / noise).abs()
        found = torch.sort(c0[snr >= min_snr]).values
    return _out(found, as_numpy)

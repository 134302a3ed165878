"""IIR filtering (counterpart of ``tpufft/iir.py``; scipy.signal semantics):
``sosfilt``, ``sosfiltfilt``, ``lfilter`` and ``filtfilt``.

A filter in direct form II transposed is an affine recurrence on its
state,

    z[k] = M z[k-1] + v x[k],   y[k] = b0 x[k] + z0[k-1],

with a constant state matrix M: ``[[-a1, 1], [-a2, 0]]`` for a biquad
section, the S x S companion matrix (M[i, 0] = -a[i+1], M[i, i+1] = 1)
for an order-S transfer function. ``_section`` runs it in torch ops, on
whatever device the signal lies:

* the signal is laid out as ``BLOCK`` rows, row p holding sample p of
  every block of ``BLOCK`` samples (``_blocked``); each block's prefix
  from a zero state runs sequentially over the rows,
  f[p] = M f[p-1] + v x[p], each step a whole row of blocks;
* the states carried into the blocks are the same recurrence on the
  block ends with M^BLOCK, scanned in log depth (``_affine_scan``:
  doubling within blocks, f[p] += M^o f[p - o] for o = 1, 2, 4, 8, and
  recursively on the ends, log_BLOCK(n) levels of 1/BLOCK the size);
* one pass over the rows adds M^p times the carried state to the output.

A cascade of sections stays in the blocked layout from its first section
to its last.

Every power of M is a host float64 constant, and the S x S algebra is
written out as elementwise sums (S <= 16), never a matmul: a lower-
precision product (TF32 on the tensor cores) would wreck the recurrence,
and these sums give the same result whatever
``torch.backends.cuda.matmul.allow_tf32`` says. The scan is
differentiable through torch's autograd.

tpufft's routing stays: an FIR ``lfilter`` is one ``fftconvolve``; a
zero-state IIR of order 3 and up runs ``tf2sos`` -> ``sosfilt`` (the
full-order companion product is unstable for repeated poles near the
unit circle; each biquad is well conditioned); a numerator longer than
the order cap splits into FIR o AR. ``filtfilt``/``sosfiltfilt`` keep
scipy's padlen, odd/even/constant extension and ``*_zi``-scaled initial
states.

Input forms: a tensor runs where it lies (float32 and float64 keep their
dtype, other real dtypes compute in float32); numpy input runs on
``device`` (None: the CUDA device, ``api.numpy_device``) in float32 when
it is float32, else float64, and comes back as numpy. Complex input
raises NotImplementedError, as in tpufft.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .api import compute_tensor
from .design import lfilter_zi, sosfilt_zi, tf2sos

__all__ = ["sosfilt", "sosfiltfilt", "lfilter", "filtfilt"]

# samples a block: a section's sequential steps over whole rows, and the
# factor by which each level of the carries' scan shrinks
BLOCK = 16

_LFILTER_MAX_ORDER = 16


def _scalar(v):
    """A host matrix entry as the Python number torch takes as ``alpha``."""
    return complex(v) if np.iscomplexobj(v) else float(v)


def _affine_scan(u: list, zi: list, M: np.ndarray) -> list:
    """z[k] = M z[k-1] + u[k] for k < n with z[-1] = zi.

    ``u``: S planes (B, n); ``zi``: S planes (B,); ``M``: (S, S) float64
    (complex128 for complex planes) on the host. Returns the S planes of z,
    (B, n)."""
    S = len(u)
    B, n = u[0].shape
    if n == 0:
        return list(u)
    nb = -(-n // BLOCK)
    f = [F.pad(ui, (0, nb * BLOCK - n)).reshape(B, nb, BLOCK) for ui in u]
    o = 1
    while o < BLOCK:
        Mo = np.linalg.matrix_power(M, o)
        g = []
        for i in range(S):
            gi = f[i].clone()
            for j in range(S):
                if Mo[i, j] != 0.0:
                    gi[..., o:].add_(f[j][..., :-o], alpha=_scalar(Mo[i, j]))
            g.append(gi)
        f = g
        o *= 2
    # f[b, p] now holds block b's prefix with a zero state carried in; the
    # state carried into block b is the end state of block b - 1
    if nb == 1:
        carried = [z[:, None] for z in zi]
    else:
        ends = _affine_scan([fi[..., -1] for fi in f], zi,
                            np.linalg.matrix_power(M, BLOCK))
        carried = [torch.cat([z[:, None], e[:, :-1]], -1)
                   for z, e in zip(zi, ends)]
    powers = np.stack([np.linalg.matrix_power(M, p + 1)
                       for p in range(BLOCK)])        # (BLOCK, S, S)
    pw = torch.as_tensor(powers, dtype=f[0].dtype, device=f[0].device)
    out = []
    for i in range(S):
        zi_ = f[i]
        for j in range(S):
            if np.any(powers[:, i, j] != 0.0):
                zi_ = torch.addcmul(zi_, carried[j][..., None], pw[:, i, j])
        out.append(zi_.reshape(B, nb * BLOCK)[:, :n])
    return out


def _blocked(x: torch.Tensor, nb: int) -> list:
    """Rows x (B, n) as BLOCK rows (B, nb), row p holding sample p of every
    block (zero-padded to nb blocks)."""
    B, n = x.shape
    return list(F.pad(x, (0, nb * BLOCK - n)).reshape(B, nb, BLOCK)
                .permute(2, 0, 1).contiguous().unbind(0))


def _unblocked(rows: list, n: int) -> torch.Tensor:
    """The inverse of ``_blocked``: (B, n)."""
    y = torch.stack(rows).permute(1, 2, 0)
    return y.reshape(y.shape[0], -1)[:, :n]


def _section(xr: list, zi: torch.Tensor, b0: float, v: np.ndarray,
             M: np.ndarray, n: int):
    """One direct-form-II-transposed filter on blocked rows (``_blocked``)
    of n samples from the state zi (B, S): returns its output as blocked
    rows and its state after sample n - 1, (B, S).

    Each block's prefix from a zero state, f[p] = M f[p-1] + v x[p], runs
    sequentially over the BLOCK rows (each a whole row of blocks); the
    states carried into the blocks are the log-depth scan of the block
    ends (``_affine_scan`` with M^BLOCK); then
    y[p] = b0 x[p] + f0[p-1] + (M^p C)_0 with C the carried state."""
    S = len(v)
    f = [[] for _ in range(S)]
    for p, xp in enumerate(xr):
        for i in range(S):
            r = xp * float(v[i])
            if p:
                for j in range(S):
                    if M[i, j] != 0.0:
                        r = torch.add(r, f[j][p - 1], alpha=float(M[i, j]))
            f[i].append(r)
    if xr[0].shape[1] == 1:
        C = [zi[:, j:j + 1] for j in range(S)]
    else:
        ends = _affine_scan([fi[-1] for fi in f],
                            [zi[:, j] for j in range(S)],
                            np.linalg.matrix_power(M, BLOCK))
        C = [torch.cat([zi[:, j:j + 1], e[:, :-1]], -1)
             for j, e in enumerate(ends)]
    y = []
    Mp = np.eye(S)
    for p, xp in enumerate(xr):
        r = torch.add(f[0][p - 1], xp, alpha=float(b0)) if p \
            else xp * float(b0)
        for j in range(S):
            if Mp[0, j] != 0.0:
                r = torch.add(r, C[j], alpha=float(Mp[0, j]))
        y.append(r)
        Mp = M @ Mp
    q, p = divmod(n - 1, BLOCK)
    Mq = np.linalg.matrix_power(M, p + 1)
    zf = torch.stack([sum((float(Mq[i, j]) * C[j][:, q] for j in range(S)),
                          f[i][p][:, q]) for i in range(S)], -1)
    return y, zf


_COMPLEX = {
    "sosfilt": "complex sosfilt is not supported (split the planes: the "
               "filter is real, so filter re and im independently)",
    "lfilter": "complex lfilter is not supported (the filter is real: "
               "filter re and im planes independently)"}


def _signal(x, device, what: str):
    """(x as a real tensor to compute on, whether it came as numpy)."""
    if (x.is_complex() if isinstance(x, torch.Tensor)
            else np.iscomplexobj(x)):
        raise NotImplementedError(_COMPLEX[what])
    return compute_tensor(x, device)


def _state(zi, like: torch.Tensor) -> torch.Tensor:
    if isinstance(zi, torch.Tensor):
        return zi.to(like.device, like.dtype)
    return torch.as_tensor(np.asarray(zi), dtype=like.dtype,
                           device=like.device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _validate_sos(sos) -> np.ndarray:
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    if not np.all(sos[:, 3] != 0):
        raise ValueError("sos[:, 3] (a0) must be nonzero")
    return sos / sos[:, 3:4]


def _sosfilt(sos: np.ndarray, x: torch.Tensor, axis: int, zi):
    """The cascade on a tensor; zi is None or (ns, ..., 2 at axis, ...)."""
    ns = sos.shape[0]
    if x.ndim == 0:
        raise ValueError("x must be at least 1-D")
    axis = axis % x.ndim
    n = x.shape[axis]
    zi_shape = (ns,) + tuple(2 if a == axis else d
                             for a, d in enumerate(x.shape))
    if zi is not None:
        zi = _state(zi, x)
        if tuple(zi.shape) != zi_shape:
            raise ValueError(
                f"Invalid zi shape {tuple(zi.shape)}; expected {zi_shape}")
    xm = x.movedim(axis, -1)
    lead = tuple(xm.shape[:-1])
    rows = xm.reshape(-1, n)
    B = rows.shape[0]
    if zi is None:
        z2 = rows.new_zeros((ns, B, 2))
    else:
        z2 = zi.movedim(axis + 1, -1).reshape(ns, B, 2)
    xr = _blocked(rows, -(-n // BLOCK))
    zf = []
    for s in range(ns):
        b0, b1, b2, _, a1, a2 = sos[s]
        M = np.array([[-a1, 1.0], [-a2, 0.0]])
        v = np.array([b1 - a1 * b0, b2 - a2 * b0])
        xr, zs = _section(xr, z2[s], b0, v, M, n)
        zf.append(zs)
    y = _unblocked(xr, n).reshape(lead + (n,)).movedim(-1, axis)
    zf = torch.stack(zf).reshape((ns,) + lead + (2,)).movedim(-1, axis + 1)
    return y, zf


def sosfilt(sos, x, axis: int = -1, zi=None, *, device=None):
    """Cascaded second-order-section filtering
    (scipy.signal.sosfilt-compatible, including the ``zi``/``zf`` state
    contract). Each section runs the log-depth scan of the module
    docstring."""
    sos = _validate_sos(sos)
    x, is_np = _signal(x, device, "sosfilt")
    y, zf = _sosfilt(sos, x, axis, zi)
    if is_np:
        y, zf = _numpy(y), _numpy(zf)
    return y if zi is None else (y, zf)


def _lfilter_fir(b: np.ndarray, x: torch.Tensor, axis: int, zi, S: int,
                 return_zf: bool):
    """FIR branch of lfilter: ONE batched FFT convolution. y is the causal
    truncation of conv(b, x); the zi transient adds to the first S
    outputs; zf is the full-convolution tail (plus any unshifted zi when
    the signal is shorter than the filter)."""
    from .signal import fftconvolve

    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    shape = [1] * xm.ndim
    shape[-1] = b.size
    bb = torch.as_tensor(b, dtype=x.dtype, device=x.device).reshape(shape)
    yc = fftconvolve(xm, bb, mode="full", axes=(-1,))
    y = yc[..., :n]
    zim = None if zi is None else zi.movedim(axis, -1)
    if zim is not None and S > 0:
        k = min(S, n)
        y = torch.cat([y[..., :k] + zim[..., :k], y[..., k:]], -1)
    y_out = y.movedim(-1, axis)
    if not return_zf:
        return y_out
    zf = yc[..., n:n + S]
    if zim is not None and S > n:
        # initial states not yet shifted out: zf_i += zi_{i+n}
        zf = zf + F.pad(zim[..., n:], (0, n))
    return y_out, zf.movedim(-1, axis)


def _lfilter(b: np.ndarray, a: np.ndarray, x: torch.Tensor, axis: int, zi):
    """lfilter on a tensor, after b and a are validated as 1-D float64."""
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    D = max(b.size, a.size)
    S = D - 1
    if x.ndim == 0:
        raise ValueError("x must be at least 1-D")
    axis = axis % x.ndim
    n = x.shape[axis]
    zi_shape = tuple(S if ax == axis else d for ax, d in enumerate(x.shape))
    return_zf = zi is not None
    if zi is not None:
        zi = _state(zi, x)
        if tuple(zi.shape) != zi_shape:
            raise ValueError(
                f"Invalid zi shape {tuple(zi.shape)}; expected {zi_shape}")

    if S == 0:
        y = x * float(b[0])
        return y if zi is None else (y, y.new_zeros(zi_shape))
    if a.size == 1:
        return _lfilter_fir(b, x, axis, zi, S, return_zf)
    if D > _LFILTER_MAX_ORDER + 1:
        if zi is None and a.size <= _LFILTER_MAX_ORDER + 1:
            # long-b ARMA: exact cascade of the FIR stage (one FFT
            # convolution) and the low-order AR stage (transfer functions
            # commute with zero initial state)
            y = _lfilter_fir(b, x, axis, None, b.size - 1, False) \
                if b.size > 1 else x * float(b[0])
            return _lfilter(np.ones(1), a, y, axis, None)
        raise ValueError(
            f"filter order {D - 1} > {_LFILTER_MAX_ORDER}: factor into "
            "second-order sections (scipy.signal.tf2sos) and use sosfilt "
            "— high-order direct forms are numerically unstable")
    if S > 2 and zi is None:
        # high-order zero-state IIR: the cascade of second-order sections
        # has the same response and stays stable where the full-order
        # companion product does not (repeated poles near the unit
        # circle); a longer numerator first splits into FIR o AR
        if b.size > a.size:
            y = _lfilter_fir(b, x, axis, None, b.size - 1, False)
            return _lfilter(np.ones(1), a, y, axis, None)
        return _sosfilt(tf2sos(b, a), x, axis, None)[0]

    b = np.concatenate([b, np.zeros(D - b.size)])
    a = np.concatenate([a, np.zeros(D - a.size)])
    M = np.zeros((S, S))
    M[:, 0] = -a[1:]
    M[np.arange(S - 1), np.arange(1, S)] = 1.0
    v = b[1:] - a[1:] * b[0]

    xm = x.movedim(axis, -1)
    lead = tuple(xm.shape[:-1])
    rows = xm.reshape(-1, n)
    z2 = rows.new_zeros((rows.shape[0], S)) if zi is None \
        else zi.movedim(axis, -1).reshape(-1, S)
    yr, zf2 = _section(_blocked(rows, -(-n // BLOCK)), z2, b[0], v, M, n)
    y = _unblocked(yr, n).reshape(lead + (n,)).movedim(-1, axis)
    if not return_zf:
        return y
    return y, zf2.reshape(lead + (S,)).movedim(-1, axis)


def lfilter(b, a, x, axis: int = -1, zi=None, *, device=None):
    """IIR/FIR filtering with a rational transfer function
    (scipy.signal.lfilter-compatible, direct form II transposed, including
    the ``zi``/``zf`` contract).

    An FIR (len(a) == 1) runs as ONE batched FFT convolution; an IIR runs
    the companion recurrence on the log-depth scan (order <= 16). Zero-
    state IIRs of order 3 and up run the second-order-section cascade
    instead (the same response, numerically stable). Orders above 16 with
    a ``zi`` state must be factored to ``sosfilt`` by the caller."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1 or b.size == 0 or a.size == 0:
        raise ValueError("b and a must be non-empty 1-D")
    x, is_np = _signal(x, device, "lfilter")
    out = _lfilter(b, a, x, axis, zi)
    if not is_np:
        return out
    return _numpy(out) if zi is None else tuple(_numpy(t) for t in out)


def _ext(x: torch.Tensor, edge: int, axis: int, padtype):
    """scipy._arraytools odd/even/const extension by ``edge`` samples."""
    if padtype is None or edge == 0:
        return x
    n = x.shape[axis]
    if padtype == "const":
        first = x.narrow(axis, 0, 1)
        last = x.narrow(axis, n - 1, 1)
        reps = [1] * x.ndim
        reps[axis] = edge
        return torch.cat([first.repeat(reps), x, last.repeat(reps)], axis)
    left = x.narrow(axis, 1, edge).flip(axis)
    right = x.narrow(axis, n - edge - 1, edge).flip(axis)
    if padtype == "even":
        return torch.cat([left, x, right], axis)
    # odd: 180-degree rotation about the end points
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    return torch.cat([2 * first - left, x, 2 * last - right], axis)


def _check_padtype(padtype) -> None:
    if padtype not in ("even", "odd", "constant", None):
        raise ValueError(
            f"Unknown value '{padtype}' given to padtype. padtype must "
            "be 'even', 'odd', 'constant', or None.")


def _extended(x: torch.Tensor, axis: int, padtype, edge: int):
    if x.shape[axis] <= edge:
        raise ValueError(
            "The length of the input vector x must be greater than "
            f"padlen, which is {edge}.")
    return _ext(x, edge, axis, {"constant": "const"}.get(padtype, padtype))


def _crop(y: torch.Tensor, axis: int, edge: int) -> torch.Tensor:
    return y.narrow(axis, edge, y.shape[axis] - 2 * edge) if edge else y


def _sosfiltfilt(sos: np.ndarray, x: torch.Tensor, axis: int, padtype,
                 padlen):
    ns = sos.shape[0]
    axis = axis % x.ndim
    ntaps = 2 * ns + 1
    ntaps -= int(min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum()))
    if padtype is None:
        edge = 0
    elif padlen is None:
        edge = ntaps * 3
    else:
        edge = int(padlen)
    ext = _extended(x, axis, padtype, edge)
    shape = [ns] + [1] * x.ndim
    shape[axis + 1] = 2
    zi = torch.as_tensor(sosfilt_zi(sos), dtype=x.dtype,
                         device=x.device).reshape(shape)
    n = ext.shape[axis]
    y, _ = _sosfilt(sos, ext, axis, zi * ext.narrow(axis, 0, 1))
    y, _ = _sosfilt(sos, y.flip(axis), axis, zi * y.narrow(axis, n - 1, 1))
    return _crop(y.flip(axis), axis, edge)


def sosfiltfilt(sos, x, axis: int = -1, padtype: str = "odd",
                padlen: int | None = None, *, device=None):
    """Zero-phase forward-backward SOS filtering
    (scipy.signal.sosfiltfilt-compatible: same default padlen, odd
    boundary extension, and sosfilt_zi-scaled initial conditions)."""
    sos = _validate_sos(sos)
    _check_padtype(padtype)
    x, is_np = _signal(x, device, "sosfilt")
    y = _sosfiltfilt(sos, x, axis, padtype, padlen)
    return _numpy(y) if is_np else y


def filtfilt(b, a, x, axis: int = -1, padtype: str = "odd",
             padlen: int | None = None, method: str = "pad",
             irlen: int | None = None, *, device=None):
    """Zero-phase forward-backward (b, a) filtering
    (scipy.signal.filtfilt-compatible for method='pad': same default
    padlen = 3*max(len(a), len(b)), boundary extensions, and
    lfilter_zi-scaled initial conditions). method='gust' (Gustafsson) is
    not implemented — use method='pad' (the default)."""
    if method != "pad":
        raise NotImplementedError(
            "only method='pad' is implemented (Gustafsson edges are "
            "not); scipy.signal.filtfilt covers method='gust'")
    if irlen is not None:
        raise NotImplementedError("irlen only applies to method='gust'")
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    _check_padtype(padtype)
    x, is_np = _signal(x, device, "lfilter")
    if len(a) > 3 and len(b) <= len(a):
        # high-order IIR: the zero-phase pass runs on the SOS cascade (the
        # full-order companion scan with zi overflows for repeated poles
        # near the unit circle), keeping filtfilt's default padlen
        eff_padlen = padlen if padtype is None or padlen is not None \
            else 3 * max(len(a), len(b))
        y = _sosfiltfilt(_validate_sos(tf2sos(b, a)), x, axis, padtype,
                         eff_padlen)
        return _numpy(y) if is_np else y
    axis = axis % x.ndim
    if padtype is None:
        edge = 0
    elif padlen is None:
        edge = 3 * max(len(a), len(b))
    else:
        edge = int(padlen)
    ext = _extended(x, axis, padtype, edge)
    zi = np.asarray(lfilter_zi(b, a), np.float64)
    shape = [1] * x.ndim
    shape[axis] = zi.size
    ziv = torch.as_tensor(zi, dtype=x.dtype, device=x.device).reshape(shape)
    n = ext.shape[axis]
    y, _ = _lfilter(b, a, ext, axis, ziv * ext.narrow(axis, 0, 1))
    y, _ = _lfilter(b, a, y.flip(axis), axis, ziv * y.narrow(axis, n - 1, 1))
    y = _crop(y.flip(axis), axis, edge)
    return _numpy(y) if is_np else y

"""Short-time and averaged spectral analysis (counterpart of
``tpufft/spectral.py``; the scipy.signal surface: stft, istft,
spectrogram, periodogram, welch, csd, coherence, get_window, check_NOLA,
check_COLA, lombscargle).

Every per-segment step (detrend, window, zero-pad to nfft, DFT, scale) is
a linear map, so tpufft folds the whole pipeline into one host matrix. The
port runs it on three hand-written CUDA kernels (``kernels/stft_mm``):

* K13: stft, spectrogram and the unreduced psd modes read overlapped
  frames straight from the signal and detrend, window, zero-pad and
  real-FFT each one in shared memory, times the scale; no frame tensor is
  built, and the matrix (``_stft_matrix``) serves only the backward;
* K14: istft runs the inverse real FFT of each segment (times c = the
  stft unscale), the synthesis window and the overlap-add in one kernel
  (the line form at nfft 256, 512 and 1024; elsewhere a product with the
  (m1, nperseg) matrix, ``_istft_matrix``, which also serves the
  backward); the window-sum normalisation stays outside;
* K15: welch, csd (and coherence, periodogram through them) run K13's
  frame FFT and accumulate |X|^2 or conj(X) Y over segments inside the
  kernel: the per-segment spectra never reach device memory, and the
  matrix serves only the backward.

The kernels serve real f32 or bf16 signals with a onesided spectrum,
detrend False, "constant" or "linear", and 2 <= nfft <= 1024,
nperseg <= nfft, nperseg % hop == 0 (tpufft's gate without its
``hop % 128 == 0``, which comes from TPU lane tiling); K13 and K15 also
need an nfft inside their FFT's envelope (``stft_mm.frames_supported``: no
prime factor of nfft/2, or of odd nfft, above 127), and stft, welch and
csd take the composed route for the others (262, the primes 131 to
1021). A CPU tensor takes
the same route through the kernels' plain versions; float64 and complex
input, other detrends, ``boundary``/``padded`` on welch, and
``backend="xla"`` take tpufft's composed route: framing, detrend, window
and the port's rfft/fft/irfft (K7, K8, K1, K9 on the card). The fused
routes are differentiable: their backward passes are plain torch ops
(the adjoint product and an overlap-add, or the framing gather), as
tpufft's custom VJPs are XLA.

Input and output forms follow the port's API: a tensor in gives tensors
out on its device (complex where tpufft returns complex), ``SplitComplex``
in gives ``SplitComplex`` out where the result is complex, and numpy in
gives numpy out, computed on ``device`` (the CUDA device unless the caller
names another). Frequency and time vectors are always numpy.
"""

from __future__ import annotations

import functools
import hashlib
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from . import api
from .api import numpy_device
from .config import PlanConfig
from .core import SplitComplex
from .kernels import dense_mm, stft_mm

__all__ = ["get_window", "stft", "istft", "spectrogram", "periodogram",
           "welch", "csd", "coherence", "check_NOLA", "check_COLA",
           "lombscargle"]

# Longest nfft the kernels take (tpufft's R2C_MAX_N).
STFT_KERNEL_MAX_NFFT = 1024


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Window vector by name or tuple (scipy.signal.get_window-compatible;
    host float64, see ``windows.py``)."""
    from .windows import get_window as _gw

    return _gw(window, Nx, fftbins=fftbins)


def _overlap_checks(nperseg, noverlap) -> tuple[int, int]:
    nperseg = int(nperseg)
    noverlap = int(noverlap)
    if nperseg < 1:
        raise ValueError("nperseg must be a positive integer")
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    if noverlap < 0:
        raise ValueError("noverlap must be a nonnegative integer")
    return nperseg, noverlap


def _bin_sums(w: np.ndarray, nperseg: int, step: int) -> np.ndarray:
    sums = np.sum([w[ii * step:(ii + 1) * step]
                   for ii in range(nperseg // step)], axis=0)
    if nperseg % step != 0:
        sums[:nperseg % step] += w[-(nperseg % step):]
    return sums


def check_NOLA(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Nonzero-overlap-add check (scipy.signal.check_NOLA-compatible):
    istft can invert an stft iff the squared-window OLA never vanishes."""
    nperseg, noverlap = _overlap_checks(nperseg, noverlap)
    win = _resolve_window(window, nperseg)
    binsums = _bin_sums(win ** 2, nperseg, nperseg - noverlap)
    return bool(np.min(binsums) > tol * np.median(binsums))


def check_COLA(window, nperseg: int, noverlap: int, tol: float = 1e-10):
    """Constant-overlap-add check (scipy.signal.check_COLA-compatible)."""
    nperseg, noverlap = _overlap_checks(nperseg, noverlap)
    win = _resolve_window(window, nperseg)
    binsums = _bin_sums(win, nperseg, nperseg - noverlap)
    deviation = binsums - np.median(binsums)
    return bool(np.max(np.abs(deviation)) < tol)


# ----------------------------------------------------------------------------
# plumbing: windows, input forms, framing
# ----------------------------------------------------------------------------

def _resolve_window(window, nperseg: int) -> np.ndarray:
    if isinstance(window, (str, tuple)):
        return get_window(window, int(nperseg))
    win = np.asarray(window, np.float64)
    if win.ndim != 1:
        raise ValueError("window must be 1-D")
    if win.shape[0] != nperseg:
        raise ValueError("window length does not match nperseg")
    return win


def _triage_segments(window, nperseg, input_length: int):
    """scipy._spectral_py._triage_segments semantics: window arrays pin
    nperseg; over-long nperseg shrinks to the input with a warning."""
    if isinstance(window, (str, tuple)):
        nperseg = 256 if nperseg is None else int(nperseg)
        if nperseg > input_length:
            warnings.warn(
                f"nperseg = {nperseg} is greater than input length "
                f"= {input_length}, using nperseg = {input_length}")
            nperseg = input_length
        win = get_window(window, nperseg)
    else:
        win = np.asarray(window, np.float64)
        if win.ndim != 1:
            raise ValueError("window must be 1-D")
        if input_length < win.shape[0]:
            raise ValueError("window is longer than input signal")
        if nperseg is None:
            nperseg = win.shape[0]
        elif int(nperseg) != win.shape[0]:
            raise ValueError("value specified for nperseg is different"
                             " from length of window")
        nperseg = win.shape[0]
    return win, nperseg


def _is_device(x) -> bool:
    return isinstance(x, (torch.Tensor, SplitComplex))


def _shape(x) -> tuple:
    return tuple(x.shape) if _is_device(x) else np.shape(x)


def _form(*xs) -> str:
    """The output form: "split" for SplitComplex, "tensor" for a tensor,
    "numpy" when no input is on a device."""
    for x in xs:
        if isinstance(x, SplitComplex):
            return "split"
        if isinstance(x, torch.Tensor):
            return "tensor"
    return "numpy"


def _device(xs, device) -> torch.device:
    """Where the call runs: the first device input's device, else
    ``device`` (``api.numpy_device``)."""
    for x in xs:
        if isinstance(x, SplitComplex):
            return x.re.device
        if isinstance(x, torch.Tensor):
            return x.device
    return numpy_device(device)


def _split(x, dev):
    """-> (re, im|None) tensors from a tensor, SplitComplex or numpy input;
    integer input becomes float (float64 from numpy, as numpy promotes)."""
    if isinstance(x, SplitComplex):
        return x.re, x.im
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return x.real, x.imag
        if not x.is_floating_point():
            x = x.float()
        return x, None
    a = np.asarray(x)

    def host(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    if np.iscomplexobj(a):
        return host(a.real), host(a.imag)
    if not np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float64)
    return host(a), None


def _widen(t):
    """bf16 and f16 planes as f32 (the composed route computes in f32)."""
    if t is not None and t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


def _pack_complex(re, im, form: str):
    """Planes -> the caller-facing complex form."""
    re, im = _widen(re), _widen(im)
    if form == "split":
        return SplitComplex(re, im)
    out = torch.complex(re, im)
    return out.cpu().numpy() if form == "numpy" else out


def _real_out(t, form: str):
    return t.cpu().numpy() if form == "numpy" else t


_EXT_KINDS = ("even", "odd", "constant", "zeros", None)


def _extend(re, im, n_ext: int, boundary):
    """Boundary extension by n_ext samples on both ends of the last axis
    (scipy's even/odd/constant/zero extensions)."""
    if boundary is None or n_ext == 0:
        return re, im

    def ext(a):
        if boundary == "zeros":
            return F.pad(a, (n_ext, n_ext))
        if boundary == "constant":
            shape = a.shape[:-1] + (n_ext,)
            return torch.cat([a[..., :1].expand(shape), a,
                              a[..., -1:].expand(shape)], -1)
        head = a[..., 1:n_ext + 1].flip(-1)
        tail = a[..., -(n_ext + 1):-1].flip(-1)
        if boundary == "even":
            return torch.cat([head, a, tail], -1)
        # odd: point-reflect about the edge samples
        return torch.cat([2 * a[..., :1] - head, a, 2 * a[..., -1:] - tail],
                         -1)

    return ext(re), None if im is None else ext(im)


def _frame(a, nperseg: int, step: int):
    """(..., n) -> (..., n_seg, nperseg): a strided view, no copy."""
    return a.unfold(-1, nperseg, step)


def _detrend_seg(re, im, detrend):
    """Per-segment detrend along the last axis (linear ops -> applied to
    each plane independently)."""
    if detrend is False or detrend is None:
        return re, im
    if callable(detrend):
        return detrend(re), None if im is None else detrend(im)
    if detrend == "constant":
        def f(a):
            return a - a.mean(-1, keepdim=True)
    elif detrend == "linear":
        n = re.shape[-1]
        t = (torch.arange(n, dtype=re.dtype, device=re.device)
             - (n - 1) / 2.0)

        def f(a):
            mean = a.mean(-1, keepdim=True)
            slope = (a * t).sum(-1, keepdim=True) / (t * t).sum()
            return a - mean - slope * t
    else:
        raise ValueError(f"unknown detrend {detrend!r}")
    return f(re), None if im is None else f(im)


def _ola_index(nperseg: int, step: int, nseg: int, device) -> torch.Tensor:
    """Signal index of every (segment, sample), flattened."""
    return (torch.arange(nperseg, device=device)[None, :]
            + step * torch.arange(nseg, device=device)[:, None]).reshape(-1)


def _overlap_add(seg, step: int, n_out: int):
    """(..., nseg, nperseg) -> (..., n_out): the segments summed at their
    offsets s * step (one ``index_add_``)."""
    lead, (nseg, nperseg) = seg.shape[:-2], seg.shape[-2:]
    flat = seg.reshape(-1, nseg * nperseg)
    out = flat.new_zeros((flat.shape[0], n_out))
    out.index_add_(1, _ola_index(nperseg, step, nseg, seg.device), flat)
    return out.reshape(lead + (n_out,))


# ----------------------------------------------------------------------------
# The kernel routes (K13, K14, K15)
# ----------------------------------------------------------------------------

def _stft_matrix(win: np.ndarray, nperseg: int, nfft: int,
                 detrend) -> np.ndarray:
    """The whole per-segment pipeline as ONE (nperseg, m1) complex matrix:
    detrend, window, zero-pad to nfft and DFT are all linear maps, so
    M = P_detrend @ diag(win) @ V_nfft[:nperseg, :m1] (f64 host trig; K13's
    function with c = 1, ``stft_mm.frame_matrix``)."""
    return stft_mm.frame_matrix(win, np.ones(nfft // 2 + 1), nfft,
                                detrend)


def _istft_matrix(win: np.ndarray, nperseg: int, nfft: int,
                  unscale: float) -> np.ndarray:
    """The whole per-segment synthesis pipeline as ONE (m1, nperseg)
    complex matrix A with x_seg = Zr @ A.real + Zi @ A.imag: the inverse
    onesided DFT (with the Hermitian doubling coefficients), the truncation
    to nperseg, the synthesis window and the stft unscale (f64 host trig;
    K14's function with c = unscale, ``stft_mm.synthesis_matrix``)."""
    return stft_mm.synthesis_matrix(win, np.full(nfft // 2 + 1, unscale),
                                    nfft)


@functools.lru_cache(maxsize=16)
def _host_matrix(kind: str, win_bytes: bytes, nperseg: int, nfft: int,
                 arg) -> np.ndarray:
    win = np.frombuffer(win_bytes, np.float64)
    if kind == "stft":
        detrend, fold = arg
        return _stft_matrix(win, nperseg, nfft, detrend) * fold
    return _istft_matrix(win, nperseg, nfft, arg)


def _tables(kind: str, win: np.ndarray, nperseg: int, nfft: int, arg,
            device) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 planes of a host matrix on ``device``, uploaded once (the
    device cache is keyed by the window's digest)."""
    wb = np.ascontiguousarray(win, np.float64).tobytes()
    key = (kind, hashlib.sha1(wb).hexdigest(), nperseg, nfft, arg)

    def plane(part):
        return lambda: getattr(_host_matrix(kind, wb, nperseg, nfft, arg),
                               part)

    return (dense_mm.device_table(key + ("re",), plane("real"), device),
            dense_mm.device_table(key + ("im",), plane("imag"), device))


def _frame_tables(win: np.ndarray, nfft: int, fold: float, device):
    """K13's operands for a real scale ``fold``: the window and c = fold
    (every bin) as f32 tensors on ``device``, uploaded once."""
    wb = np.ascontiguousarray(win, np.float64).tobytes()
    key = ("frames", hashlib.sha1(wb).hexdigest(), nfft, fold)
    m1 = nfft // 2 + 1
    return (dense_mm.device_table(key + ("win",),
                                  lambda: np.frombuffer(wb).copy(), device),
            dense_mm.device_table(key + ("cr",),
                                  lambda: np.full(m1, fold), device),
            dense_mm.device_table(key + ("ci",), lambda: np.zeros(m1),
                                  device))


class _STFTFused(torch.autograd.Function):
    """The frames of x through K13: detrend, window, zero-pad, real DFT
    and the per-bin factor c in one kernel. The backward is the adjoint
    product with the same function as a host matrix (``matrix()`` gives
    its f32 planes, built and uploaded on first use) followed by an
    overlap-add (plain torch ops, as tpufft's VJP is XLA)."""

    @staticmethod
    def forward(ctx, x, win, cr, ci, nfft, detrend, hop, nseg, matrix):
        ctx.matrix = matrix
        ctx.hop, ctx.n_sig, ctx.dtype = hop, x.shape[1], x.dtype
        return stft_mm.stft_frames(x, win, cr, ci, nfft, detrend, hop, nseg)

    @staticmethod
    def backward(ctx, gr, gi):
        mr, mi = ctx.matrix()
        gseg = gr @ mr.T + gi @ mi.T              # (batch, nseg, nperseg)
        batch, nseg, nperseg = gseg.shape
        acc = gseg.new_zeros((batch, ctx.n_sig))
        acc.index_add_(1, _ola_index(nperseg, ctx.hop, nseg, gseg.device),
                       gseg.reshape(batch, -1))
        return (acc.to(ctx.dtype),) + (None,) * 8


def _welch_composed(x, y, mr, mi, hop: int):
    """K15's function in differentiable torch ops (its backward)."""
    def spec(v):
        f = v.unfold(-1, mr.shape[0], hop)
        return f @ mr, f @ mi

    xr, xi = spec(x)
    if y is None:
        return (xr * xr + xi * xi).sum(1)
    yr, yi = spec(y)
    return (xr * yr + xi * yi).sum(1), (xr * yi - xi * yr).sum(1)


class _WelchFused(torch.autograd.Function):
    """The sum over segments of |X|^2 (or conj(X) Y) on K15: the window,
    nfft and detrend go to the kernel's frame FFT. The backward recomputes
    through the composed torch ops, as tpufft's VJP does, with the same
    function as a host matrix (``matrix()`` gives its f32 planes, built and
    uploaded on first use)."""

    @staticmethod
    def forward(ctx, x, y, win, nfft, detrend, hop, matrix):
        ctx.save_for_backward(x, y)
        ctx.hop, ctx.matrix = hop, matrix
        return stft_mm.welch_accum(x, win, nfft, detrend, hop, y)

    @staticmethod
    def backward(ctx, *g):
        x, y = ctx.saved_tensors
        mr, mi = ctx.matrix()
        with torch.enable_grad():
            xs = x.detach().float().requires_grad_()
            ys = None if y is None else y.detach().float().requires_grad_()
            out = _welch_composed(xs, ys, mr, mi, ctx.hop)
            outs = (out,) if y is None else out
            ins = (xs,) if y is None else (xs, ys)
            grads = torch.autograd.grad(outs, ins, g[:len(outs)])
        gx = grads[0].to(x.dtype)
        gy = None if y is None else grads[1].to(y.dtype)
        return gx, gy, None, None, None, None, None


class _ISTFTFused(torch.autograd.Function):
    """Inverse transform, synthesis window and overlap-add on K14: the
    window, the per-bin factor c and nfft go to the kernel. The backward is
    the framing gather times the adjoint, with the same function as a host
    matrix (``matrix()`` gives its f32 planes, built and uploaded on first
    use; the dense body reads them too), plain torch ops."""

    @staticmethod
    def forward(ctx, zr, zi, win, cr, ci, nfft, hop, matrix):
        ctx.matrix = matrix
        ctx.hop, ctx.nseg, ctx.dtype = hop, zr.shape[1], zr.dtype
        return stft_mm.istft_frames(zr, zi, win, cr, ci, nfft, hop, matrix)

    @staticmethod
    def backward(ctx, g):
        ar, ai = ctx.matrix()
        frames = g.unfold(-1, ar.shape[1], ctx.hop)[:, :ctx.nseg]
        return ((frames @ ar.T).to(ctx.dtype), (frames @ ai.T).to(ctx.dtype),
                None, None, None, None, None, None)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_DETRENDS = (False, None, "constant", "linear")


def _geometry_ok(nperseg: int, step: int, nfft: int) -> bool:
    """The kernels' envelope: tpufft's stft_overlap_supported /
    istft_ola_supported without the TPU's hop % 128 == 0."""
    return (2 <= nfft <= STFT_KERNEL_MAX_NFFT and nperseg <= nfft
            and step >= 1 and nperseg % step == 0)


def _detrend_ok(detrend) -> bool:
    return not callable(detrend) and detrend in _KERNEL_DETRENDS


def _stft_fused_ok(im, onesided, detrend, dtype, nperseg: int, step: int,
                   nfft: int, cfg: PlanConfig | None) -> bool:
    cfg = cfg or PlanConfig()
    if im is not None or not onesided or not _detrend_ok(detrend):
        return False
    if dtype not in _KERNEL_DTYPES or cfg.backend == "xla":
        return False
    return _geometry_ok(nperseg, step, nfft) and stft_mm.frames_supported(
        nfft)


def _welch_fused_ok(xim, yim, onesided, detrend, dtypes, nperseg: int,
                    step: int, nfft: int, boundary, padded,
                    cfg: PlanConfig | None) -> bool:
    cfg = cfg or PlanConfig()
    if xim is not None or yim is not None or not onesided:
        return False
    if boundary is not None or padded or not _detrend_ok(detrend):
        return False
    if any(d not in _KERNEL_DTYPES for d in dtypes) or cfg.backend == "xla":
        return False
    return _geometry_ok(nperseg, step, nfft) and stft_mm.frames_supported(
        nfft)


def _istft_fused_ok(onesided, n_freq: int, dtype, nperseg: int, step: int,
                    nfft: int, cfg: PlanConfig | None) -> bool:
    cfg = cfg or PlanConfig()
    if not onesided or n_freq != nfft // 2 + 1 or cfg.backend == "xla":
        return False
    if dtype not in _KERNEL_DTYPES:
        return False
    return _geometry_ok(nperseg, step, nfft)


def _transform_segments(re, im, nfft: int, onesided: bool,
                        config: PlanConfig | None):
    """Batched per-segment DFT of the last axis -> spectrum planes (one
    rfft or fft call over every segment of every row)."""
    if onesided:
        X = api.rfft(re, n=nfft, axis=-1, config=config)
    else:
        x = re if im is None else torch.complex(re, im)
        X = api.fft(x, n=nfft, axis=-1, config=config)
    return X.real, X.imag


def _spectral_helper(x, y, fs, window, nperseg, noverlap, nfft, detrend,
                     return_onesided, scaling, axis, mode, boundary,
                     padded, config, device, reduce_mean=False):
    """The shared stft/psd engine (scipy._spectral_helper semantics,
    split-plane execution). Returns (freqs, t, (re, im|None), form,
    onesided).

    ``reduce_mean`` (psd mode): the caller will mean over segments; when
    K15 serves the shape, the sum happens in the kernel and the result
    comes back with a single-segment time axis."""
    if boundary not in _EXT_KINDS:
        raise ValueError(
            f"Unknown boundary option '{boundary}', must be one of "
            f"{list(_EXT_KINDS)}")
    same_data = y is x
    axis = int(axis)
    form = _form(x) if same_data else _form(x, y)
    dev = _device((x,) if same_data else (x, y), device)

    xre, xim = _split(x, dev)
    if not same_data:
        yre, yim = _split(y, dev)
        # scipy zero-pads the shorter signal along axis
        ax = axis % max(xre.ndim, yre.ndim)
        nx, ny = xre.shape[ax], yre.shape[ax]
        if nx != ny:
            def padto(a, n_to):
                if a is None:
                    return None
                return F.pad(a.movedim(ax, -1),
                             (0, n_to - a.shape[ax])).movedim(-1, ax)
            if nx < ny:
                xre, xim = padto(xre, ny), padto(xim, ny)
            else:
                yre, yim = padto(yre, nx), padto(yim, nx)
    else:
        yre = yim = None

    complex_in = xim is not None or (not same_data and yim is not None)
    onesided = bool(return_onesided)
    if onesided and complex_in:
        warnings.warn("Input data is complex, switching to "
                      "return_onesided=False")
        onesided = False

    ndim = xre.ndim
    axis = axis % ndim
    moved = axis != ndim - 1
    if moved:
        xre = xre.movedim(axis, -1)
        xim = None if xim is None else xim.movedim(axis, -1)
        if not same_data:
            yre = yre.movedim(axis, -1)
            yim = None if yim is None else yim.movedim(axis, -1)

    n_in = xre.shape[-1]
    win, nperseg = _triage_segments(window, nperseg, n_in)
    if noverlap is None:
        noverlap = nperseg // 2
    else:
        noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be greater than or equal to nperseg.")
    step = nperseg - noverlap

    if scaling == "density":
        scale = 1.0 / (fs * (win * win).sum())
    elif scaling == "spectrum":
        scale = 1.0 / win.sum() ** 2
    else:
        raise ValueError(f"Unknown scaling: {scaling!r}")
    if mode == "stft":
        scale = math.sqrt(scale)
    # the fused route folds the scale into its matrix: the spectrum's
    # (stft) or, for the products of psd mode, its square root
    fold = float(scale if mode == "stft" else math.sqrt(scale))
    dkey = detrend if isinstance(detrend, str) else None

    def rows(a, dtype=None):
        """(..., n) -> contiguous (rows, n)."""
        a = a.reshape(-1, a.shape[-1])
        return (a if dtype is None else a.to(dtype)).contiguous()

    def run(re, im):
        """Spectrum planes (..., nseg, m1) and whether the scale is in."""
        re, im = _extend(re, im, nperseg // 2, boundary)
        n_ext = re.shape[-1]
        if padded:
            nadd = (-(n_ext - nperseg) % step) % nperseg
            if nadd:
                re = F.pad(re, (0, nadd))
                im = None if im is None else F.pad(im, (0, nadd))
        if _stft_fused_ok(im, onesided, detrend, re.dtype, nperseg, step,
                          nfft, config):
            # K13: frames stream straight from the signal through the
            # detrend, window, pad, real FFT and scale of one kernel
            wt, cr, ci = _frame_tables(win, nfft, fold, dev)
            Xr, Xi = _STFTFused.apply(
                rows(re), wt, cr, ci, nfft, dkey, step,
                1 + (re.shape[-1] - nperseg) // step,
                lambda: _tables("stft", win, nperseg, nfft, (dkey, fold),
                                dev))
            shape = re.shape[:-1] + Xr.shape[1:]
            return Xr.reshape(shape), Xi.reshape(shape), True
        re, im = _widen(re), _widen(im)
        re = _frame(re, nperseg, step)
        im = None if im is None else _frame(im, nperseg, step)
        re, im = _detrend_seg(re, im, detrend)
        w = torch.as_tensor(win, dtype=re.dtype, device=re.device)
        re = re * w
        im = None if im is None else im * w
        Xr, Xi = _transform_segments(re, im, nfft, onesided and im is None,
                                     config)
        return Xr, Xi, False

    if (mode == "psd" and reduce_mean
            and _welch_fused_ok(xim, yim, onesided, detrend,
                                (xre.dtype,) if same_data
                                else (xre.dtype, yre.dtype),
                                nperseg, step, nfft, boundary, padded,
                                config)
            and xre.shape[-1] >= nperseg):
        # K15: per-segment spectra never reach device memory; the mean and
        # scale are scalar passes on the (rows, m1) result
        nseg_f = 1 + (xre.shape[-1] - nperseg) // step
        wt = _frame_tables(win, nfft, 1.0, dev)[0]
        lead = xre.shape[:-1]
        if not same_data:
            # one row of x beside one row of y: broadcast the leading dims
            # (scipy's and the composed route's matmuls broadcast them)
            lead = torch.broadcast_shapes(lead, yre.shape[:-1])
            xre = xre.expand(lead + xre.shape[-1:])
            yre = yre.expand(lead + yre.shape[-1:])
        args = (wt, nfft, dkey, step, lambda: _tables(
            "stft", win, nperseg, nfft, (dkey, 1.0), dev))
        if same_data:
            Pr, Pi = _WelchFused.apply(rows(xre), None, *args), None
        else:
            dt = (xre.dtype if xre.dtype == yre.dtype else torch.float32)
            Pr, Pi = _WelchFused.apply(rows(xre, dt), rows(yre, dt), *args)
        k = float(scale) / nseg_f
        m1 = Pr.shape[-1]
        Rr = (Pr * k).reshape(lead + (1, m1))
        Ri = None if Pi is None else (Pi * k).reshape(lead + (1, m1))
    else:
        Xr, Xi, scaled = run(xre, xim)
        if same_data:
            Yr, Yi = Xr, Xi
        else:
            Yr, Yi, _ = run(yre, yim)
        s = 1.0 if scaled else scale
        if mode == "stft":
            Rr, Ri = Xr * s, (None if Xi is None else Xi * s)
            if Ri is None:
                Ri = torch.zeros_like(Rr)
        else:  # psd: conj(X) * Y
            if Xi is None:
                Xi = torch.zeros_like(Xr)
            if Yi is None:
                Yi = torch.zeros_like(Yr)
            Rr = (Xr * Yr + Xi * Yi) * s
            Ri = None if same_data else (Xr * Yi - Xi * Yr) * s
    if mode != "stft" and onesided:
        # double the interior bins (the energy of the dropped conjugate
        # half); DC and (even-nfft) Nyquist stay single
        hi = Rr.shape[-1] - (1 if nfft % 2 == 0 else 0)

        def dbl(a):
            return torch.cat([a[..., :1], a[..., 1:hi] * 2, a[..., hi:]], -1)
        Rr = dbl(Rr)
        Ri = None if Ri is None else dbl(Ri)

    nseg = Rr.shape[-2]
    if onesided:
        freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    else:
        freqs = np.fft.fftfreq(nfft, 1.0 / fs)
    t = (np.arange(nseg) * step + nperseg / 2.0) / fs
    if boundary is not None:
        t -= (nperseg / 2.0) / fs

    # (..., nseg, nfreq) -> freq back on the data axis, time trailing
    def place(a):
        a = a.transpose(-1, -2)
        if moved:
            a = a.movedim(-2, axis)
        return a

    Rr = place(Rr)
    Ri = None if Ri is None else place(Ri)
    return freqs, t, (Rr, Ri), form, onesided


# ----------------------------------------------------------------------------
# public surface
# ----------------------------------------------------------------------------

def stft(x, fs: float = 1.0, window="hann", nperseg: int | None = 256,
         noverlap: int | None = None, nfft: int | None = None,
         detrend=False, return_onesided: bool = True, boundary="zeros",
         padded: bool = True, axis: int = -1, scaling: str = "spectrum",
         *, config: PlanConfig | None = None, device=None):
    """Short-time Fourier transform (scipy.signal.stft-compatible):
    returns (f, t, Zxx) with the frequency axis at ``axis`` and segment
    times trailing. A real f32/bf16 signal inside the kernel's envelope
    is one K13 launch."""
    if scaling == "psd":
        sc = "density"
    elif scaling == "spectrum":
        sc = "spectrum"
    else:
        raise ValueError(f"Parameter scaling={scaling!r} not in "
                         "['spectrum', 'psd']")
    freqs, t, (Rr, Ri), form, _ = _spectral_helper(
        x, x, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, sc, axis, "stft", boundary, padded, config, device)
    return freqs, t, _pack_complex(Rr, Ri, form)


def istft(Zxx, fs: float = 1.0, window="hann", nperseg: int | None = None,
          noverlap: int | None = None, nfft: int | None = None,
          input_onesided: bool = True, boundary: bool = True,
          time_axis: int = -1, freq_axis: int = -2,
          scaling: str = "spectrum", *,
          config: PlanConfig | None = None, device=None):
    """Inverse STFT via windowed overlap-add
    (scipy.signal.istft-compatible): returns (t, x). Inside the kernel's
    envelope the inverse transform, window and overlap-add are one K14
    launch; the window-sum normalisation is an elementwise pass."""
    form = _form(Zxx)
    Zr, Zi = _split(Zxx, _device((Zxx,), device))
    if Zi is None:
        Zi = torch.zeros_like(Zr)
    if Zr.ndim < 2:
        raise ValueError("Input stft must be at least 2d!")
    ndim = Zr.ndim
    time_axis = time_axis % ndim
    freq_axis = freq_axis % ndim
    if time_axis == freq_axis:
        raise ValueError("Must specify differing time and frequency axes!")

    n_freq = Zr.shape[freq_axis]
    n_default = 2 * (n_freq - 1) if input_onesided else n_freq
    if nperseg is None:
        nperseg = n_default
    else:
        nperseg = int(nperseg)
        if nperseg < 1:
            raise ValueError("nperseg must be a positive integer")
    if nfft is None:
        if input_onesided and nperseg == n_default + 1:
            nfft = nperseg  # odd nperseg, onesided
        else:
            nfft = n_default
    elif int(nfft) < nperseg:
        raise ValueError("nfft must be greater than or equal to nperseg.")
    else:
        nfft = int(nfft)
    if noverlap is None:
        noverlap = nperseg // 2
    else:
        noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg.")
    step = nperseg - noverlap

    win = _resolve_window(window, nperseg)
    if not check_NOLA(win, nperseg, noverlap):
        # scipy >= 1.15 warns (it used to raise): the division below
        # substitutes 1 for the vanished OLA bins
        warnings.warn("NOLA condition failed, STFT may not be invertible")

    if scaling == "spectrum":
        unscale = win.sum()
    elif scaling == "psd":
        unscale = math.sqrt(fs * (win * win).sum())
    else:
        raise ValueError(f"Parameter scaling={scaling!r} not in "
                         "['spectrum', 'psd']")

    # -> (..., nseg, nfreq)
    Zr = Zr.movedim((freq_axis, time_axis), (-1, -2))
    Zi = Zi.movedim((freq_axis, time_axis), (-1, -2))
    nseg = Zr.shape[-2]
    n_out = nperseg + (nseg - 1) * step
    lead = Zr.shape[:-2]
    xout_i = None
    if _istft_fused_ok(input_onesided, n_freq, Zr.dtype, nperseg, step,
                       nfft, config):
        # K14: inverse transform, window and overlap-add in one pass, no
        # scatter-add; the time-varying window-sum division stays below
        zr = Zr.reshape(-1, nseg, n_freq).contiguous()
        zi = Zi.reshape(-1, nseg, n_freq).to(zr.dtype).contiguous()
        xout = _ISTFTFused.apply(
            zr, zi, *_frame_tables(win, nfft, float(unscale), Zr.device),
            nfft, step, lambda: _tables("istft", win, nperseg, nfft,
                                        float(unscale), Zr.device)
        ).reshape(lead + (n_out,))
    else:
        Zc = torch.complex(_widen(Zr), _widen(Zi))
        if input_onesided:
            xsub, xsub_i = api.irfft(Zc, n=nfft, axis=-1, config=config), None
        else:
            z = api.ifft(Zc, n=nfft, axis=-1, config=config)
            xsub, xsub_i = z.real, z.imag
        w = torch.as_tensor(win * unscale, dtype=xsub.dtype,
                            device=xsub.device)
        xout = _overlap_add(xsub[..., :nperseg] * w, step, n_out)
        if xsub_i is not None:
            xout_i = _overlap_add(xsub_i[..., :nperseg] * w, step, n_out)
    # the window-sum normalisation, overlap-added in float64 on the device
    # (a host np.add.at over nseg * nperseg entries stalls the card for
    # milliseconds a call at a million samples)
    w2 = torch.as_tensor(win ** 2, dtype=torch.float64, device=xout.device)
    normw = _overlap_add(w2.expand(nseg, nperseg), step, n_out)
    norm = torch.where(normw > 1e-10, normw, 1.0).to(xout.dtype)
    xout = xout / norm
    if xout_i is not None:
        xout_i = xout_i / norm

    if boundary:
        half = nperseg // 2
        xout = xout[..., half:n_out - half]
        if xout_i is not None:
            xout_i = xout_i[..., half:n_out - half]

    t = np.arange(xout.shape[-1]) / fs
    # put the reconstructed axis back at the (freq-axis-consumed-adjusted)
    # time-axis position: the scipy.istft axis contract
    if xout.ndim > 0 and ndim - 2 > 0 and time_axis != ndim - 1:
        ta = time_axis - 1 if freq_axis < time_axis else time_axis
        xout = xout.movedim(-1, ta)
        if xout_i is not None:
            xout_i = xout_i.movedim(-1, ta)
    if xout_i is not None:
        return t, _pack_complex(xout, xout_i, form)
    return t, _real_out(xout, form)


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """numpy.unwrap along the last axis (period 2 pi)."""
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0),
                        torch.full_like(ddmod, math.pi), ddmod)
    correct = torch.where(dd.abs() < math.pi, torch.zeros_like(dd),
                          ddmod - dd)
    out = p.clone()
    out[..., 1:] = p[..., 1:] + torch.cumsum(correct, -1)
    return out


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: int | None = None, noverlap: int | None = None,
                nfft: int | None = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, mode: str = "psd", *,
                config: PlanConfig | None = None, device=None):
    """Spectrogram (scipy.signal.spectrogram-compatible): returns
    (f, t, Sxx) with segment times on the last axis (K13 inside the
    kernel's envelope)."""
    modelist = ["psd", "complex", "magnitude", "angle", "phase"]
    if mode not in modelist:
        raise ValueError(f"unknown value for mode {mode}, must be one of "
                         f"{modelist}")
    helper_mode = "psd" if mode == "psd" else "stft"
    # scipy: nperseg defaults via triage, noverlap = nperseg // 8
    if noverlap is None:
        _, nperseg_r = _triage_segments(window, nperseg, _shape(x)[axis])
        noverlap = nperseg_r // 8
    freqs, t, (Rr, Ri), form, _ = _spectral_helper(
        x, x, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, helper_mode, None, False, config,
        device)
    if mode == "psd":
        return freqs, t, _real_out(Rr, form)
    if mode == "complex":
        return freqs, t, _pack_complex(Rr, Ri, form)
    if mode == "magnitude":
        return freqs, t, _real_out(torch.sqrt(Rr * Rr + Ri * Ri), form)
    ang = torch.atan2(Ri, Rr)
    if mode == "phase":
        ang = _unwrap(ang)       # along the time (last) axis
    return freqs, t, _real_out(ang, form)


def _median_bias(n: int) -> float:
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def _median(a: torch.Tensor) -> torch.Tensor:
    """numpy.median along the last axis (the mean of the two middle values
    for an even count)."""
    s = a.sort(-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) / 2


def csd(x, y, fs: float = 1.0, window="hann", nperseg: int | None = None,
        noverlap: int | None = None, nfft: int | None = None,
        detrend="constant", return_onesided: bool = True,
        scaling: str = "density", axis: int = -1, average: str = "mean",
        *, config: PlanConfig | None = None, device=None):
    """Cross power spectral density Pxy by Welch's method
    (scipy.signal.csd-compatible); the mean over segments runs in K15."""
    if average not in ("mean", "median"):
        raise ValueError(f"average must be 'mean' or 'median', got "
                         f"{average!r}")
    same = y is x
    freqs, _, (Rr, Ri), form, _ = _spectral_helper(
        x, y, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided, scaling, axis, "psd", None, False, config, device,
        reduce_mean=(average == "mean"))
    # average over the trailing (segment-time) axis
    if Rr.ndim >= 2 and Rr.shape[-1] > 1:
        if average == "median":
            bias = _median_bias(Rr.shape[-1])
            Rr = _median(Rr) / bias
            Ri = None if Ri is None else _median(Ri) / bias
        else:
            Rr = Rr.mean(-1)
            Ri = None if Ri is None else Ri.mean(-1)
    else:
        Rr = Rr.reshape(Rr.shape[:-1])
        Ri = None if Ri is None else Ri.reshape(Ri.shape[:-1])
    if same and Ri is None:
        return freqs, _real_out(Rr, form)
    if Ri is None:
        Ri = torch.zeros_like(Rr)
    return freqs, _pack_complex(Rr, Ri, form)


def _real_part(P):
    if isinstance(P, SplitComplex):
        return P.re
    if isinstance(P, torch.Tensor):
        return P.real if P.is_complex() else P
    return np.real(P) if np.iscomplexobj(P) else P


def welch(x, fs: float = 1.0, window="hann", nperseg: int | None = None,
          noverlap: int | None = None, nfft: int | None = None,
          detrend="constant", return_onesided: bool = True,
          scaling: str = "density", axis: int = -1,
          average: str = "mean", *, config: PlanConfig | None = None,
          device=None):
    """Power spectral density by Welch's method
    (scipy.signal.welch-compatible): returns (f, Pxx)."""
    freqs, Pxx = csd(x, x, fs=fs, window=window, nperseg=nperseg,
                     noverlap=noverlap, nfft=nfft, detrend=detrend,
                     return_onesided=return_onesided, scaling=scaling,
                     axis=axis, average=average, config=config, device=device)
    return freqs, _real_part(Pxx)


def periodogram(x, fs: float = 1.0, window="boxcar",
                nfft: int | None = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                axis: int = -1, *, config: PlanConfig | None = None,
                device=None):
    """Periodogram PSD estimate (scipy.signal.periodogram-compatible):
    one full-length segment through welch."""
    if window is None:
        window = "boxcar"
    n = _shape(x)[axis]
    if nfft is None:
        nperseg = n
    elif nfft == n:
        nperseg = nfft
    elif nfft > n:
        nperseg = n
    else:  # nfft < n: crop (scipy semantics)
        sl = [slice(None)] * len(_shape(x))
        sl[axis % len(sl)] = slice(0, nfft)
        if isinstance(x, SplitComplex):
            x = SplitComplex(x.re[tuple(sl)], x.im[tuple(sl)])
        else:
            x = x[tuple(sl)]
        nperseg = nfft
        nfft = None
    return welch(x, fs=fs, window=window, nperseg=nperseg, noverlap=0,
                 nfft=nfft, detrend=detrend,
                 return_onesided=return_onesided, scaling=scaling,
                 axis=axis, config=config, device=device)


def coherence(x, y, fs: float = 1.0, window="hann",
              nperseg: int | None = None, noverlap: int | None = None,
              nfft: int | None = None, detrend="constant", axis: int = -1,
              *, config: PlanConfig | None = None, device=None):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy)
    (scipy.signal.coherence-compatible): two K15 welch launches and one
    csd launch inside the kernel's envelope."""
    kw = dict(fs=fs, window=window, nperseg=nperseg, noverlap=noverlap,
              nfft=nfft, detrend=detrend, axis=axis, config=config,
              device=device)
    freqs, Pxx = welch(x, **kw)
    _, Pyy = welch(y, **kw)
    _, Pxy = csd(x, y, **kw)
    if isinstance(Pxy, SplitComplex):
        mag2 = Pxy.re * Pxy.re + Pxy.im * Pxy.im
    else:
        mag2 = abs(Pxy) ** 2
    return freqs, mag2 / Pxx / Pyy


# ---------------------------------------------------------------------------
# Lomb-Scargle periodogram (unevenly sampled data)
# ---------------------------------------------------------------------------

_NOVALUE = object()


def _ls_core(xv, yv, wv, freqs, floating_mean: bool):
    """Generalized Lomb-Scargle (Zechmeister & Kuerster 2009) sums: one
    (N, F) trig tile and weighted matvecs in torch ops; the tau rotation
    reuses the first trig tile (cos(t - tau) by the angle-difference
    identity). Returns (a, b, tau, power, YY)."""
    w = wv / wv.sum()
    wy = w * yv
    theta = xv[:, None] * freqs[None, :]          # (N, F)
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    CC = w @ (cos * cos)
    CS = w @ (cos * sin)
    SS = 1.0 - CC
    Y = wy.sum()
    if floating_mean:
        C = w @ cos
        S = w @ sin
        CC = CC - C * C
        SS = SS - S * S
        CS = CS - C * S
    tau = 0.5 * torch.atan2(2.0 * CS, CC - SS)
    ct, st = torch.cos(tau), torch.sin(tau)
    cos_t = cos * ct[None, :] + sin * st[None, :]  # cos(theta - tau)
    sin_t = sin * ct[None, :] - cos * st[None, :]
    YC = wy @ cos_t
    YS = wy @ sin_t
    CC = w @ (cos_t * cos_t)
    SS = 1.0 - CC
    if floating_mean:
        C = w @ cos_t
        S = w @ sin_t
        YC = YC - Y * C
        YS = YS - Y * S
        CC = CC - C * C
        SS = SS - S * S
    np_dtype = np.float64 if yv.dtype == torch.float64 else np.float32
    eps = float(np.finfo(np_dtype).epsneg)
    CC = CC.clamp_min(eps)
    SS = SS.clamp_min(eps)
    a = YC / CC
    b = YS / SS
    power = 2.0 * (a * YC + b * YS)
    YY = (wy * yv).sum()
    if floating_mean:
        YY = YY - Y * Y
    return a, b, tau, power, YY


def lombscargle(x, y, freqs, *, precenter=_NOVALUE, normalize=False,
                weights=None, floating_mean: bool = False, device=None):
    """Lomb-Scargle periodogram for unevenly sampled data
    (scipy.signal.lombscargle-compatible, with the generalized
    floating-mean / weighted form and the 'power'/'normalize'/'amplitude'
    output modes). Tensor input runs on its device in its float dtype;
    numpy input runs in float64 on ``device`` and returns numpy. The
    O(N F) trig tile and its weighted reductions are torch ops; there is
    no kernel here."""
    form = _form(x, y, freqs)
    if isinstance(normalize, bool):
        mode = "normalize" if normalize else "power"
    else:
        mode = normalize
    if mode not in ("power", "normalize", "amplitude"):
        raise ValueError("normalize must be False ('power'), True "
                         "('normalize'), or 'amplitude'")
    dev = _device((x, y, freqs, weights), device)
    dtype = torch.float64
    for v in (x, y, freqs):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            dtype = v.dtype
            break
    if weights is None:
        weights = np.ones(_shape(y), np.float64)
    elif not isinstance(weights, torch.Tensor):
        weights = np.asarray(weights, np.float64)
        # host weights are value-checked even beside device x/y; tensor
        # weights cannot be without a sync and remain the caller's contract
        if not (np.all(weights >= 0) and np.sum(weights) > 0):
            raise ValueError("weights must be non-negative and sum to a "
                             "positive value")

    def dev_t(v):
        return torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v, device=dev).to(dtype)

    xv, yv, fv, wv = (dev_t(v) for v in (x, y, freqs, weights))
    if not (xv.ndim == 1 and xv.numel() > 0
            and xv.shape == yv.shape == wv.shape):
        raise ValueError("x, y, weights must be 1-D arrays of equal "
                         "non-zero length")
    if not (fv.ndim == 1 and fv.numel() > 0):
        raise ValueError("freqs must be a 1-D array of non-zero length")
    if precenter is not _NOVALUE:
        warnings.warn("'precenter' is deprecated (scipy 1.17): pass "
                      "y - y.mean() or use floating_mean=True",
                      DeprecationWarning, stacklevel=2)
        if precenter:
            yv = yv - yv.mean()

    a, b, tau, power, YY = _ls_core(xv, yv, wv, fv, bool(floating_mean))
    if mode == "power":
        return _real_out(power * (xv.shape[0] / 4.0), form)
    if mode == "normalize":
        return _real_out(power * (0.5 / YY), form)
    ct, st = torch.cos(tau), torch.sin(tau)
    return _pack_complex(a * ct - b * st, a * st + b * ct, form)

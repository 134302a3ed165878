"""ShortTimeFFT: the class-based STFT interface (counterpart of
``tpufft/shorttime.py``; scipy.signal.ShortTimeFFT semantics).

A window/hop/fs object with the sliding-window FFT (``stft``,
``stft_detrend``), the overlap-add inverse (``istft``) through the
canonical dual window, ``spectrogram``, the full index bookkeeping
(p_min/p_max/k_min/k_max, border markers, extent), the four fft_modes and
'magnitude'/'psd' scaling; and ``closest_STFT_dual_window``.

* Index conventions match scipy exactly: the p-th slice covers samples
  ``p*hop - m_num_mid + [0, m_num)``; ``phase_shift`` is a circular roll
  of the mfft-padded windowed slice by ``(phase_shift + m_num_mid) %
  m_num`` before the FFT. The bookkeeping, the windows and the dual
  windows are host float64 numpy, as in tpufft.
* Kernel routes: a real f32 or bf16 signal in a onesided mode with a
  real window, a foldable detrend and the kernels' geometry (2 <= mfft
  <= 1024, m_num <= mfft, m_num % hop == 0) runs ``stft`` on K13 and
  ``istft`` on K14 (``kernels/stft_mm``). K13 (where mfft is inside its
  FFT's envelope, ``stft_mm.frames_supported``) detrends, windows,
  zero-pads and real-FFTs each frame in shared memory and multiplies bin
  k by c[k], the phase roll and the mode scaling (``_frame_factor``); the
  same steps as one host matrix serve its backward. K14 takes the real
  dual window and c[k], the inverse phase roll and mode unscale
  (``_synthesis_factor``), and inverse-real-FFTs each slice (the line
  form at mfft 256, 512 and 1024; elsewhere its dense body, a product
  with the same steps as one host matrix, which also serves the
  backward). No frame tensor is built and the overlap-add has no
  scatter. A CPU
  tensor takes the same route
  through the kernels' plain versions. Everything else composes the
  port's own transforms on the frames (rfft/irfft/fft: K7, K8, K1 on the
  card) and overlap-adds with one ``index_add_``.
* Input and output forms: a tensor in gives a (complex) tensor out on its
  device; numpy in gives numpy out, computed on the instance's ``device``
  (the CUDA device unless the constructor names another).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import api
from .api import numpy_device
from .config import PlanConfig
from .core import SplitComplex
from .kernels import stft_mm
from .spectral import _detrend_seg

__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_KIND = ("zeros", "edge", "even", "odd")


def _reflect(x, pad_l: int, pad_r: int, odd: bool):
    """numpy.pad's "reflect" (reflect_type "odd" when ``odd``) of the last
    axis: chunks of at most n - 1 samples mirrored about the current edge,
    repeated until the pad is filled."""
    period = x.shape[-1] - 1
    while pad_l > 0 or pad_r > 0:
        if pad_l > 0:
            c = min(period, pad_l)
            chunk = x[..., 1:c + 1].flip(-1)
            if odd:
                chunk = 2 * x[..., :1] - chunk
            x = torch.cat([chunk, x], -1)
            pad_l -= c
        if pad_r > 0:
            c = min(period, pad_r)
            chunk = x[..., -c - 1:-1].flip(-1)
            if odd:
                chunk = 2 * x[..., -1:] - chunk
            x = torch.cat([x, chunk], -1)
            pad_r -= c
    return x


def _pad(x, pad_l: int, pad_r: int, padding: str):
    """x padded on the last axis as numpy.pad pads it for scipy's
    ShortTimeFFT padding kinds."""
    if pad_l == 0 and pad_r == 0:
        return x
    if padding == "zeros":
        return F.pad(x, (pad_l, pad_r))
    if padding == "edge" or x.shape[-1] == 1:   # reflect needs 2 samples
        shape = x.shape[:-1]
        return torch.cat([x[..., :1].expand(shape + (pad_l,)), x,
                          x[..., -1:].expand(shape + (pad_r,))], -1)
    return _reflect(x, pad_l, pad_r, padding == "odd")


def _canonical_dual(win: np.ndarray, hop: int) -> np.ndarray:
    """d = win / DD, DD[k] = sum_j |win[k - j*hop]|^2 (all in-range j).

    Derivation: the frame operator of a hop-shifted window system is
    diagonal in sample space with entries DD[k]; the canonical dual is
    its inverse applied to the window (Groechenig, "Foundations of
    Time-Frequency Analysis", ch. 5). The invertibility guard below
    (a relative-resolution threshold on DD) intentionally matches
    scipy.signal._short_time_fft._calc_dual_canonical_window so that
    the invertible/ValueError boundary is bit-identical to the scipy
    class this module is parity-tested against.
    """
    w2 = (win.real ** 2 + win.imag ** 2).astype(np.float64)
    DD = w2.copy()
    for j in range(hop, len(win), hop):
        DD[j:] += w2[:-j]
        DD[:-j] += w2[j:]
    relative_resolution = np.finfo(w2.dtype).resolution * DD.max()
    if not np.all(DD >= relative_resolution):
        raise ValueError("short-time FFT is not invertible: the window "
                         "overlap-add has (near-)zeros")
    return win / DD


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """Dual window of ``alpha*win`` closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window-compatible; scipy
    _short_time_fft.py is the parity target).

    Derivation (independent of scipy's implementation): a window system
    shifted by ``hop`` has a diagonal frame operator, so "d is a dual of
    w" decouples into one linear constraint per residue class
    ``r = k mod hop``: ``<w_r, d_r> = 1``. The closest d to a desired u
    under one inner-product constraint per class is the affine
    projection ``d_r = u_r + (1 - c_r) / n_r * w_r`` with
    ``c_r = <w_r, u_r>`` and ``n_r = ||w_r||^2``. With ``scaled=True``
    the target is ``alpha*u`` with alpha free; the residual is then
    exactly ``sum_r |1 - alpha*c_r|^2 / n_r`` (the mismatch lives
    entirely along w within each class), minimized by
    ``alpha = (sum conj(c_r)/n_r) / (sum |c_r|^2/n_r)``.
    """
    win = np.atleast_1d(np.asarray(win))
    if win.ndim != 1 or win.size == 0:
        raise ValueError("win must be a non-empty 1-D array")
    if not (np.issubdtype(win.dtype, np.floating)
            or np.issubdtype(win.dtype, np.complexfloating)):
        win = win.astype(np.float64)
    m = win.shape[0]
    hop = int(hop)
    if not 1 <= hop <= m:
        raise ValueError(f"hop={hop} must be in [1, len(win)={m}]")
    if desired_dual is None:
        u = np.ones(m, dtype=win.dtype)
    else:
        u = np.atleast_1d(np.asarray(desired_dual))
        if u.shape != win.shape:
            raise ValueError("desired_dual must be 1-D of the same "
                             "length as win")
    cdtype = np.result_type(win.dtype, u.dtype, np.float64)
    w = win.astype(cdtype)
    u = u.astype(cdtype)

    cls = np.arange(m) % hop
    n_r = np.zeros(hop, np.float64)           # ||w_r||^2 per class
    np.add.at(n_r, cls, (w.real ** 2 + w.imag ** 2)
              if np.iscomplexobj(w) else w ** 2)
    c_r = np.zeros(hop, cdtype)               # <w_r, u_r> per class
    np.add.at(c_r, cls, np.conj(w) * u)

    # a residue class with zero window energy admits no dual at all
    if not np.all(n_r > np.finfo(np.float64).tiny):
        raise ValueError("closest dual window is undefined: the window "
                         "has a hop-residue class with zero energy")
    if scaled:
        denom = np.sum((c_r.real ** 2 + c_r.imag ** 2) / n_r)
        if denom < np.finfo(np.float64).tiny:
            raise ValueError("closest dual window is undefined: "
                             "desired_dual is orthogonal to the window "
                             "in every hop-residue class")
        alpha = np.sum(np.conj(c_r) / n_r) / denom
    else:
        alpha = 1.0
    d = alpha * u + ((1.0 - alpha * c_r) / n_r)[cls] * w
    if not np.iscomplexobj(win) and not np.iscomplexobj(u):
        alpha = float(np.real(alpha))
        d = np.real(d) if np.iscomplexobj(d) else d
    return d, alpha


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT-compatible short-time FFT object.

    ``config`` is the ``PlanConfig`` of its transforms (``backend="xla"``
    takes the composed route); ``device`` is where numpy input runs (None:
    the CUDA device)."""

    def __init__(self, win, hop: int, fs: float, *, fft_mode="onesided",
                 mfft=None, dual_win=None, phase_shift=0, scale_to=None,
                 config=None, device=None):
        win = np.asarray(win)
        if win.ndim != 1 or win.size == 0:
            raise ValueError("win must be a non-empty 1-D array")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must be finite")
        self._win = win.astype(np.complex128 if np.iscomplexobj(win)
                               else np.float64)
        hop = int(hop)
        if hop < 1:
            raise ValueError("hop must be a positive integer")
        self._hop = hop
        if not fs > 0:
            raise ValueError("fs must be positive")
        self._fs = float(fs)
        self._mfft = int(mfft) if mfft is not None else win.size
        if self._mfft < win.size:
            raise ValueError("mfft must be at least len(win)")
        if fft_mode not in _FFT_MODES:
            raise ValueError(f"fft_mode must be one of {_FFT_MODES}")
        self._fft_mode = fft_mode
        if phase_shift is not None:
            phase_shift = int(phase_shift)
            if not -self._mfft < phase_shift < self._mfft:
                raise ValueError("phase_shift must be None or an int in "
                                 "(-mfft, mfft)")
        self._phase_shift = phase_shift
        if dual_win is not None:
            dual_win = np.asarray(dual_win)
            dual_win = dual_win.astype(np.complex128
                                       if np.iscomplexobj(dual_win)
                                       else np.float64)
            if dual_win.shape != win.shape:
                raise ValueError("dual_win must have the same shape as win")
        self._dual_win = dual_win
        self._scaling = None
        self._config = config          # PlanConfig of the transforms
        self._device = device          # where numpy input runs (None: CUDA)
        self._win_version = 0          # bumped by scale_to (matrix cache)
        self._mat_cache: dict = {}
        if scale_to is not None:
            self.scale_to(scale_to)
        if fft_mode == "onesided2X" and self._scaling is None:
            raise ValueError("fft_mode='onesided2X' requires scaling "
                             "('magnitude' or 'psd'); pass scale_to=")

    # -- constructors ------------------------------------------------
    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int,
                    noverlap: int, *, symmetric_win: bool = False,
                    fft_mode="onesided", mfft=None, phase_shift=0,
                    scale_to=None, config=None, device=None):
        from .spectral import get_window
        win = get_window(win_param, int(nperseg),
                         fftbins=not symmetric_win)
        return cls(win, hop=int(nperseg) - int(noverlap), fs=fs,
                   fft_mode=fft_mode, mfft=mfft, phase_shift=phase_shift,
                   scale_to=scale_to, config=config, device=device)

    @classmethod
    def from_dual(cls, dual_win, hop: int, fs: float, **kwargs):
        win = _canonical_dual(np.asarray(dual_win, np.float64), int(hop))
        return cls(win, hop=hop, fs=fs,
                   dual_win=np.asarray(dual_win, np.float64), **kwargs)

    @classmethod
    def from_win_equals_dual(cls, desired_win, hop: int, fs: float, *,
                             scale_to=None, **kwargs):
        """Window equal to its own dual (scipy-exact, incl. the
        'unitary' scaling only this constructor can set: win /= sqrt(
        mfft), dual *= sqrt(mfft)). Normalizing each hop-residue class
        of the window to unit norm is the closed form: the OLA diagonal
        DD[k] is constant on each class and equals that class's squared
        norm."""
        desired_win = np.asarray(desired_win)
        if desired_win.ndim != 1 or desired_win.size == 0:
            raise ValueError("desired_win must be a non-empty 1-D array")
        if np.issubdtype(desired_win.dtype, np.integer):
            raise ValueError("desired_win cannot be of integer type — "
                             "cast to float or complex")
        if not np.all(np.isfinite(desired_win)):
            raise ValueError("desired_win must have finite entries")
        hop = int(hop)
        if not 1 <= hop <= desired_win.size:
            raise ValueError(f"hop={hop} is not an integer in "
                             f"[1, {desired_win.size}]")
        if scale_to not in ("magnitude", "psd", "unitary", None):
            raise ValueError(f"scale_to={scale_to!r} not in "
                             "('magnitude', 'psd', 'unitary', None)")
        win = desired_win.astype(np.complex128
                                 if np.iscomplexobj(desired_win)
                                 else np.float64)
        mfft = kwargs.get("mfft") or win.size
        s_fac = math.sqrt(mfft) if scale_to == "unitary" else 1.0
        relative_resolution = (np.finfo(win.real.dtype).resolution
                               * np.max(np.abs(win)))
        for m in range(hop):
            a = np.linalg.norm(win[m::hop])
            if not a > relative_resolution:
                raise ValueError("desired_win cannot be normalized to "
                                 "equal its dual (a hop-residue class "
                                 "of the overlap-add is zero)")
            win[m::hop] /= a
        sft = cls(win / s_fac, hop=hop, fs=fs, dual_win=win * s_fac,
                  scale_to=None if scale_to == "unitary" else scale_to,
                  **kwargs)
        if scale_to == "unitary":
            sft._scaling = "unitary"
        return sft

    # -- basic properties ---------------------------------------------
    win = property(lambda self: self._win)
    hop = property(lambda self: self._hop)
    fs = property(lambda self: self._fs)
    T = property(lambda self: 1.0 / self._fs)
    mfft = property(lambda self: self._mfft)
    fft_mode = property(lambda self: self._fft_mode)
    phase_shift = property(lambda self: self._phase_shift)
    scaling = property(lambda self: self._scaling)
    m_num = property(lambda self: self._win.size)
    m_num_mid = property(lambda self: self._win.size // 2)
    delta_t = property(lambda self: self._hop / self._fs)
    delta_f = property(lambda self: self._fs / self._mfft)
    onesided_fft = property(
        lambda self: self._fft_mode in ("onesided", "onesided2X"))

    @property
    def f_pts(self) -> int:
        return (self._mfft // 2 + 1 if self.onesided_fft else self._mfft)

    @property
    def f(self) -> np.ndarray:
        if self.onesided_fft:
            return np.fft.rfftfreq(self._mfft, self.T)
        fr = np.fft.fftfreq(self._mfft, self.T)
        return np.fft.fftshift(fr) if self._fft_mode == "centered" else fr

    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _canonical_dual(self._win.real
                                             if not np.iscomplexobj(self._win)
                                             else self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            self.dual_win
        except ValueError:
            return False
        return True

    @property
    def fac_magnitude(self) -> float:
        return 1.0 / abs(self._win.sum())

    @property
    def fac_psd(self) -> float:
        return 1.0 / math.sqrt(
            self._fs * float(np.sum(np.abs(self._win) ** 2)))

    def scale_to(self, scaling: str):
        """Scale win (and dual) for 'magnitude' or 'psd' calibration."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError("scaling must be 'magnitude' or 'psd'")
        if self._scaling == scaling:
            return
        s = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * s
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s
        self._scaling = scaling
        self._win_version += 1
        self._mat_cache.clear()

    # -- index bookkeeping (scipy-exact, see module docstring) ---------
    # The border loops below are zero-aware: a window with zero head or
    # tail coefficients (periodic hann starts at 0) contributes nothing
    # there, and scipy's slice accounting skips such non-contributing
    # placements. The loop bounds and slice conventions intentionally
    # mirror scipy.signal._short_time_fft so the integer surface is
    # bit-identical to the class this module is parity-tested against;
    # each loop runs at most O(m_num/hop) iterations.
    @property
    def _w2(self) -> np.ndarray:
        w = self._win
        return (w.real ** 2 + w.imag ** 2)

    @functools.cached_property
    def _border_min(self) -> tuple:
        """(k_min, p_min): leftmost nonzero sample / slice index.

        Slide slice 0 (window start at -m_num_mid) left by hop until the
        next placement would keep no nonzero coefficient over t >= 0
        (scipy's slice convention: the tail ``w2[k_next:]``)."""
        w2 = self._w2
        k, p = -self.m_num_mid, 0
        while True:
            k_next = k - self._hop
            if k_next + self.m_num <= 0 or not w2[k_next:].any():
                return k, -p
            k, p = k_next, p + 1

    @property
    def p_min(self) -> int:
        return self._border_min[1]

    @property
    def k_min(self) -> int:
        return self._border_min[0]

    def _border_max(self, n: int) -> tuple:
        """(k_max, p_max) for an n-sample signal: slide the window right
        from the last slice centered inside the signal until the next
        placement keeps no nonzero coefficient over t < n (the head
        ``w2[:n - k_next]`` in scipy's convention)."""
        m2p = self.m_num - self.m_num_mid
        if not n >= m2p:
            raise ValueError(f"n must be >= ceil(m_num/2) = {m2p}")
        w2 = self._w2
        q = n // self._hop
        k = q * self._hop - self.m_num_mid
        while True:
            k_next = k + self._hop
            if k_next >= n or not w2[:n - k_next].any():
                return k + self.m_num, q + 1
            k, q = k_next, q + 1

    def p_max(self, n: int) -> int:
        return self._border_max(n)[1]

    def k_max(self, n: int) -> int:
        return self._border_max(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @property
    def lower_border_end(self) -> tuple:
        """(sample, slice) of the first point unaffected by left padding.

        Tracks the first NONZERO window coefficient (m0): placements
        whose nonzero support starts at or after t=0 are unaffected."""
        w2 = self._w2
        m0 = int(np.flatnonzero(w2)[0])
        k, q = -self.m_num_mid + m0, 0
        while k <= self._hop:
            if k + self._hop >= 0:
                return (k + self.m_num, q + 1)
            k, q = k + self._hop, q + 1
        return (0, max(self.p_min, 0))

    def upper_border_begin(self, n: int) -> tuple:
        """(sample, slice) of the first slice affected by right padding.

        Walk slices right-to-left from the first slice past the signal
        end until one fits (or only its zero tail sticks out)."""
        m2p = self.m_num - self.m_num_mid
        if not n >= m2p:
            raise ValueError(f"n must be >= ceil(m_num/2) = {m2p}")
        w2 = self._w2
        q2 = n // self._hop + 1
        q1 = max((n - self.m_num) // self._hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self._hop + m2p
            if k_ <= n or not w2[n - k_:].any():
                return ((q_ + 1) * self._hop - self.m_num_mid, q_ + 1)
        return (0, 0)

    def p_range(self, n: int, p0=None, p1=None) -> tuple:
        p_max = self.p_max(n)
        p0 = self.p_min if p0 is None else int(p0)
        p1 = p_max if p1 is None else int(p1)
        if not (self.p_min <= p0 < p1 <= p_max):
            raise ValueError(f"need p_min={self.p_min} <= p0 < p1 <= "
                             f"p_max={p_max}, got p0={p0}, p1={p1}")
        return p0, p1

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        p = k // self._hop if left else -(-k // self._hop)
        return p * self._hop

    def t(self, n: int, p0=None, p1=None, k_offset: int = 0) -> np.ndarray:
        if not (isinstance(n, (int, np.integer)) and n > 0):
            raise ValueError(f"n={n} is not a positive integer")
        p0, p1 = self.p_range(n, p0, p1)
        return (np.arange(p0, p1) * self._hop + k_offset) * self.T

    def extent(self, n: int, axes_seq: str = "tf",
               center_bins: bool = False) -> tuple:
        if axes_seq not in ("tf", "ft"):
            raise ValueError("axes_seq must be 'tf' or 'ft'")
        if self._fft_mode in ("onesided", "onesided2X"):
            q0, q1 = 0, self.f_pts
        elif self._fft_mode == "centered":
            q0 = -(self._mfft // 2)
            q1 = q0 + self._mfft
        else:
            raise ValueError("extent requires fft_mode in ('centered', "
                             "'onesided', 'onesided2X') — a twosided "
                             "frequency axis has no contiguous extent")
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t0, t1 = self.delta_t * (p0 - 0.5), self.delta_t * (p1 - 0.5)
            f0, f1 = self.delta_f * (q0 - 0.5), self.delta_f * (q1 - 0.5)
        else:
            t0, t1 = self.delta_t * p0, self.delta_t * p1
            f0, f1 = self.delta_f * q0, self.delta_f * q1
        return (t0, t1, f0, f1) if axes_seq == "tf" else (f0, f1, t0, t1)

    # -- transforms ----------------------------------------------------
    def _padded(self, x, p0: int, p1: int, k_offset: int, padding: str):
        """(padded signal copy, index of slice p0's first sample)."""
        if padding not in _PAD_KIND:
            raise ValueError(f"padding must be one of {tuple(_PAD_KIND)}")
        n = x.shape[-1]
        k_lo = p0 * self._hop - self.m_num_mid + k_offset
        k_hi = (p1 - 1) * self._hop - self.m_num_mid + self.m_num \
            + k_offset
        pad_l, pad_r = max(0, -k_lo), max(0, k_hi - n)
        return _pad(x, pad_l, pad_r, padding), k_lo + pad_l

    def _frames(self, x, p0: int, p1: int, k_offset: int, padding: str):
        """(..., p1-p0, m_num) slice view over a padded signal copy."""
        xpad, start = self._padded(x, p0, p1, k_offset, padding)
        n_sig = (p1 - p0 - 1) * self._hop + self.m_num
        return xpad[..., start:start + n_sig].unfold(-1, self.m_num,
                                                      self._hop)

    # -- the kernel routes (K13, K14) ----------------------------------
    def _fused_stft_ok(self, x, detr) -> bool:
        """Gate of the overlapped-frame kernel (K13): a real f32 or bf16
        tensor, a onesided mode, a real window, a foldable detrend and the
        kernels' geometry (tpufft's gate without hop % 128 == 0)."""
        from .spectral import _KERNEL_DTYPES, _geometry_ok

        cfg = self._config or PlanConfig()
        if x.is_complex() or x.dtype not in _KERNEL_DTYPES:
            return False
        if not self.onesided_fft or np.iscomplexobj(self._win):
            return False
        if detr is not None and detr not in ("constant", "linear"):
            return False
        if cfg.backend == "xla":
            return False
        return (_geometry_ok(self.m_num, self._hop, self._mfft)
                and stft_mm.frames_supported(self._mfft))

    def _phase_shift_p(self) -> int:
        """p_s: the shift of the DFT's sample index by the phase shift."""
        if self._phase_shift is None:
            return 0
        return (self._phase_shift + self.m_num_mid) % self.m_num

    def _frame_factor(self) -> np.ndarray:
        """K13's per-bin factor c: the phase roll exp(+2 pi i p_s k /
        mfft) times the onesided2X doubling (f64 host trig);
        ``_fused_stft_matrix`` is ``stft_mm.frame_matrix`` of the real
        window and this c."""
        k = np.arange(self._mfft // 2 + 1, dtype=np.float64)
        c = np.exp((2j * np.pi * self._phase_shift_p() / self._mfft) * k)
        if self._fft_mode == "onesided2X":
            fac = math.sqrt(2) if self._scaling == "psd" else 2.0
            c[1:-1 if self._mfft % 2 == 0 else None] *= fac
        return c

    def _f32_tables(self, key, arrays, device):
        """The host arrays ``arrays()`` as f32 tensors on ``device``,
        cached with the instance (dropped by scale_to)."""
        full = (key, self._win_version, str(device))
        tables = self._mat_cache.get(full)
        if tables is None:
            tables = tuple(
                torch.as_tensor(np.ascontiguousarray(p), dtype=torch.float32,
                                device=device) for p in arrays())
            self._mat_cache[full] = tables
        return tables

    def _frame_tables(self, device):
        """K13's operands: the real window and c as f32 tensors on
        ``device`` (``_f32_tables``)."""
        def arrays():
            c = self._frame_factor()
            return np.real(self._win), c.real, c.imag

        return self._f32_tables("frame tables", arrays, device)

    def _fused_stft_matrix(self, detr) -> np.ndarray:
        """The whole _fft_func as ONE (m_num, m1) complex matrix: detrend
        projector (acting on the RAW frame), window, zero-pad, phase roll
        and onesided2X scaling (``_frame_factor``) and the onesided rDFT
        are all linear maps (f64 host trig, ``stft_mm.frame_matrix``)."""
        key = ("stft", detr, self._win_version)
        M = self._mat_cache.get(key)
        if M is None:
            M = stft_mm.frame_matrix(np.real(self._win), self._frame_factor(),
                                     self._mfft, detr)
            self._mat_cache[key] = M
        return M

    def _device_tables(self, key, build, device):
        """The f32 planes of the host matrix ``build()`` on ``device``
        (``_f32_tables``)."""
        def arrays():
            M = build()
            return M.real, M.imag

        return self._f32_tables(("tables", key), arrays, device)

    def _fused_stft(self, x, detr, p0: int, p1: int, k_offset: int,
                    padding: str):
        """(..., p, f) planes on K13: frames stream straight from the
        (padded) signal, no frame tensor is built; the matrix serves the
        backward only."""
        from .spectral import _STFTFused

        xpad, start = self._padded(x, p0, p1, k_offset, padding)
        nseg = p1 - p0
        n_sig = (nseg - 1) * self._hop + self.m_num
        xs = xpad[..., start:start + n_sig]
        lead = xs.shape[:-1]
        win, cr, ci = self._frame_tables(x.device)
        Xr, Xi = _STFTFused.apply(
            xs.reshape(-1, n_sig).contiguous(), win, cr, ci, self._mfft,
            detr, self._hop, nseg,
            lambda: self._device_tables(
                ("stft", detr), lambda: self._fused_stft_matrix(detr),
                x.device))
        m1 = Xr.shape[-1]
        return Xr.reshape(lead + (nseg, m1)), Xi.reshape(lead + (nseg, m1))

    def _fused_istft_ok(self, zr) -> bool:
        from .spectral import _KERNEL_DTYPES, _geometry_ok

        cfg = self._config or PlanConfig()
        if zr.dtype not in _KERNEL_DTYPES:
            return False
        if not self.onesided_fft or np.iscomplexobj(self._win) \
                or np.iscomplexobj(self.dual_win):
            return False
        if cfg.backend == "xla":
            return False
        return _geometry_ok(self.m_num, self._hop, self._mfft)

    def _synthesis_factor(self) -> np.ndarray:
        """K14's per-bin factor c: the phase roll exp(-2 pi i p_s k /
        mfft) times the onesided2X unscale (f64 host trig);
        ``_fused_istft_matrix`` is ``stft_mm.synthesis_matrix`` of the real
        dual window and this c."""
        k = np.arange(self._mfft // 2 + 1, dtype=np.float64)
        c = np.exp((-2j * np.pi * self._phase_shift_p() / self._mfft) * k)
        if self._fft_mode == "onesided2X":
            fac, sl = self._fac_slice()
            c[sl] /= fac
        return c

    def _synthesis_tables(self, device):
        """K14's operands: the real dual window and c as f32 tensors on
        ``device`` (``_f32_tables``)."""
        def arrays():
            c = self._synthesis_factor()
            return np.real(self.dual_win), c.real, c.imag

        return self._f32_tables("synthesis tables", arrays, device)

    def _fused_istft_matrix(self) -> np.ndarray:
        """The whole _ifft_func + dual-window synthesis as ONE (m1, m_num)
        complex matrix A with the kernel contract x = Zr @ A.real + Zi @
        A.imag (the real part of the Hermitian inverse): the onesided2X
        unscale and the phase roll fold into c (``_synthesis_factor``,
        ``stft_mm.synthesis_matrix``)."""
        key = ("istft", self._win_version)
        A = self._mat_cache.get(key)
        if A is None:
            A = stft_mm.synthesis_matrix(np.real(self.dual_win),
                                         self._synthesis_factor(), self._mfft)
            self._mat_cache[key] = A
        return A

    def _fused_istft(self, zr, zi, k0: int, k1: int):
        """Overlap-add inverse on K14: zr/zi are (..., p, f) planes;
        returns the [k0, k1) signal window, time last."""
        from .spectral import _ISTFTFused

        lead = zr.shape[:-2]
        q_num, m1 = zr.shape[-2:]
        zr = zr.reshape(-1, q_num, m1).contiguous()
        zi = zi.reshape(-1, q_num, m1).to(zr.dtype).contiguous()
        out = _ISTFTFused.apply(
            zr, zi, *self._synthesis_tables(zr.device), self._mfft,
            self._hop, lambda: self._device_tables(
                ("istft",), self._fused_istft_matrix, zr.device))
        # kernel output sample i is signal sample k_min + i
        out = out[..., k0 - self.k_min:k1 - self.k_min]
        return out.reshape(lead + (k1 - k0,))

    # -- the composed route (the port's FFTs: K7, K8, K1) ----------------
    def _win_mod(self) -> np.ndarray:
        """conj(win), zero-padded to mfft and phase-rolled (host f64).

        Elementwise products commute with a shared permutation, so
        (pad+roll frame) * _win_mod equals scipy's window-then-pad-then-
        roll order."""
        w = np.conj(self._win)
        wp = np.zeros(self._mfft, dtype=w.dtype)
        wp[:self.m_num] = w
        if self._phase_shift is not None:
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            if p_s:
                wp = np.roll(wp, -p_s)
        return wp

    def _fac_slice(self):
        """The onesided2X factor and the bins it scales."""
        fac = math.sqrt(2) if self._scaling == "psd" else 2.0
        return fac, slice(1, -1 if self._mfft % 2 == 0 else None)

    def _fft_frames(self, fr):
        """_fft_func: conj window, phase roll, mode-specific FFT; frames
        (..., p, m_num) -> a complex tensor (..., p, f)."""
        pad = self._mfft - self.m_num
        if pad:
            fr = F.pad(fr, (0, pad))
        if self._phase_shift is not None:
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            if p_s:
                fr = torch.roll(fr, -p_s, dims=-1)
        wm = self._win_mod()
        if fr.is_complex() or np.iscomplexobj(wm):
            cdt = (torch.complex128 if fr.dtype in (torch.float64,
                                                    torch.complex128)
                   else torch.complex64)
            fr = fr.to(cdt) * torch.as_tensor(wm, device=fr.device).to(cdt)
        else:
            fr = fr * torch.as_tensor(wm, dtype=fr.dtype, device=fr.device)
        if self.onesided_fft:
            X = api.rfft(fr, self._mfft, config=self._config)
            if self._fft_mode == "onesided2X":
                fac, sl = self._fac_slice()
                X[..., sl] *= fac
            return X
        X = api.fft(fr, self._mfft, config=self._config)
        if self._fft_mode == "centered":
            X = torch.roll(X, self._mfft // 2, dims=-1)
        return X

    def _ifft_frames(self, X):
        """Inverse of _fft_frames, returning m_num samples per slice."""
        if self.onesided_fft:
            if self._fft_mode == "onesided2X":
                fac, sl = self._fac_slice()
                X = X.clone()
                X[..., sl] /= fac
            fr = api.irfft(X, self._mfft, config=self._config)
        else:
            if self._fft_mode == "centered":
                X = torch.roll(X, -(self._mfft // 2), dims=-1)
            fr = api.ifft(X, self._mfft, config=self._config)
        if self._phase_shift is not None:
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            fr = torch.roll(fr, p_s, dims=-1)
        return fr[..., :self.m_num]

    def _tensor(self, x):
        """(tensor, numpy in?) for an input: numpy runs on the instance's
        ``device`` (None: the CUDA device)."""
        if isinstance(x, SplitComplex):
            raise ValueError("complex input: pass a complex tensor with "
                             "fft_mode='twosided' or 'centered', not "
                             "SplitComplex planes")
        if isinstance(x, torch.Tensor):
            return x, False
        a = np.asarray(x)
        if not (np.issubdtype(a.dtype, np.floating)
                or np.iscomplexobj(a)):
            a = a.astype(np.float64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            numpy_device(self._device)), True

    def stft(self, x, p0=None, p1=None, *, k_offset: int = 0,
             padding: str = "zeros", axis: int = -1):
        """Short-time FFT: (..., f_pts, p1-p0) with the f/t axes last."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset,
                                 padding=padding, axis=axis)

    def stft_detrend(self, x, detr, p0=None, p1=None, *,
                     k_offset: int = 0, padding: str = "zeros",
                     axis: int = -1):
        """Short-time FFT with each slice detrended ('constant', 'linear'
        or a callable on the (..., p, m_num) frames)."""
        x, is_np = self._tensor(x)
        if x.is_complex() and self.onesided_fft:
            raise ValueError("complex input requires fft_mode 'twosided' "
                             "or 'centered'")
        if not (x.is_floating_point() or x.is_complex()):
            x = x.float()
        if x.shape[axis] < self.m_num - self.m_num_mid:
            raise ValueError(f"axis length {x.shape[axis]} is shorter "
                             f"than a single window placement "
                             f"({self.m_num - self.m_num_mid})")
        if axis not in (-1, x.ndim - 1):
            x = x.movedim(axis, -1)
        if detr is not None and not callable(detr) \
                and detr not in ("linear", "constant"):
            raise ValueError("detr must be 'linear', 'constant', or "
                             "a callable")
        p0, p1 = self.p_range(x.shape[-1], p0, p1)
        if not callable(detr) and self._fused_stft_ok(x, detr):
            X = torch.complex(*self._fused_stft(x, detr, p0, p1, k_offset,
                                                padding))
        else:
            if x.dtype in (torch.bfloat16, torch.float16):
                x = x.float()
            fr = self._frames(x, p0, p1, k_offset, padding)
            if detr is not None:
                if callable(detr):
                    fr = detr(fr)
                elif fr.is_complex():
                    fr = torch.complex(*_detrend_seg(fr.real, fr.imag,
                                                     detr))
                else:
                    fr = _detrend_seg(fr, None, detr)[0]
            X = self._fft_frames(fr)

        # (..., p, f) -> (..., f, p); then the frequency axis replaces the
        # data axis (scipy: time slices always trail)
        X = X.transpose(-1, -2)
        if x.ndim > 1:
            X = X.movedim(-2, axis if axis >= 0 else axis - 1)
        return X.cpu().numpy() if is_np else X

    def spectrogram(self, x, y=None, detr=None, *, p0=None, p1=None,
                    k_offset: int = 0, padding: str = "zeros",
                    axis: int = -1):
        """Sx * conj(Sy) (or |Sx|^2 when y is None)."""
        kw = dict(k_offset=k_offset, padding=padding, axis=axis)
        Sx = self.stft_detrend(x, detr, p0, p1, **kw)
        is_np = isinstance(Sx, np.ndarray)
        Sx = torch.as_tensor(Sx)
        if y is None:
            out = Sx.real ** 2 + Sx.imag ** 2
        else:
            out = Sx * torch.as_tensor(
                self.stft_detrend(y, detr, p0, p1, **kw)).conj()
        return out.numpy() if is_np else out

    def istft(self, S, k0: int = 0, k1=None, *, f_axis: int = -2,
              t_axis: int = -1):
        """Inverse short-time FFT by dual-window overlap-add."""
        if isinstance(S, SplitComplex):
            S = S.complex()
        S, is_np = self._tensor(S)
        ndim = S.ndim
        fa = f_axis % ndim
        ta = t_axis % ndim
        if fa == ta:
            raise ValueError("f_axis and t_axis must differ")
        if S.shape[fa] != self.f_pts:
            raise ValueError(f"S.shape[f_axis]={S.shape[fa]} != "
                             f"f_pts={self.f_pts}")
        if (fa, ta) != (ndim - 2, ndim - 1):
            S = S.movedim((fa, ta), (-2, -1))
        q_num = S.shape[-1]
        n_min = self.m_num - self.m_num_mid
        if q_num < self.p_num(n_min):
            raise ValueError(f"S needs at least {self.p_num(n_min)} "
                             f"slices, got {q_num}")
        k_max = (self.p_min + q_num - 1) * self._hop - self.m_num_mid \
            + self.m_num
        k1 = k_max if k1 is None else int(k1)
        if not (self.k_min <= k0 < k1 <= k_max):
            raise ValueError(f"need k_min={self.k_min} <= k0 < k1 <= "
                             f"{k_max}, got k0={k0}, k1={k1}")
        if k1 - k0 < n_min:
            raise ValueError(f"k1 - k0 = {k1 - k0} must be at least half "
                             f"the window length ({n_min})")
        if not S.is_complex():
            S = S.to(torch.complex128 if S.dtype == torch.float64
                     else torch.complex64)
        Sp = S.transpose(-1, -2)                  # (..., p, f)
        zr, zi = Sp.real, Sp.imag
        if self._fused_istft_ok(zr):
            out = self._fused_istft(zr, zi, k0, k1)
        else:
            fr = self._ifft_frames(Sp)
            dual = torch.as_tensor(self.dual_win, device=fr.device)
            contrib = fr * dual.to(fr.dtype if fr.is_complex() or
                                   not dual.is_complex() else
                                   torch.complex128)
            # scatter-add all slices at once, dropping samples outside
            # [k0, k1)
            k_slice = (self.p_min + np.arange(q_num)) * self._hop \
                - self.m_num_mid
            idx = k_slice[:, None] + np.arange(self.m_num)[None, :] - k0
            L = k1 - k0
            valid = (idx >= 0) & (idx < L)
            lead = contrib.shape[:-2]
            flat = contrib.reshape((-1, q_num * self.m_num))
            keep = np.flatnonzero(valid)
            out = flat.new_zeros((flat.shape[0], L))
            out.index_add_(1, torch.as_tensor(idx.reshape(-1)[keep],
                                              device=fr.device),
                           flat[:, torch.as_tensor(keep, device=fr.device)])
            out = out.reshape(lead + (L,))
            if out.is_complex() and self.onesided_fft:
                out = out.real
        # scipy axis contract: for batched S the reconstructed time axis
        # lands where the frequency axis was (or the time axis if f was
        # last); 1-D output stays 1-D
        out_ndim = ndim - 1
        if out_ndim > 1:
            out = out.movedim(-1, fa if fa < out_ndim else ta)
        return out.cpu().numpy() if is_np else out

"""tpufft_torch — the PyTorch and CUDA port of tpufft.

Batched complex and real FFTs on torch tensors, with tpufft's plans,
arguments, split-plane layout and results, and the layers above them:
filtering and FFT convolution (``signal``), DCT/DST (``realtrans``), the
chirp-z transform (``czt``), the fast Hankel transform (``fhtlog``),
short-time and averaged spectral analysis (``spectral``, ``shorttime``,
``windows``), multirate resampling (``multirate``), IIR filtering on a
log-depth scan (``iir``), filter design and frequency responses
(``design``), linear time-invariant systems (``ltisys``), waveforms
(``waveforms``), the scipy.signal utilities (``sigtools``), Fourier
image filters (``ndimage``), peak finding (``peaks``), the B-spline
filters (``bsplines``) and scipy.fft interop (``backend``: worker control
and a ``scipy.fft.set_backend`` target). Two submodules are imported by
name, as in tpufft: ``native``, the ctypes binding of the native C++ host
engine, and ``parallel``, batch-sharded and distributed transforms over a
``torch.distributed`` device mesh. A
transform whose lengths are inside the kernels' envelopes runs
hand-written CUDA kernels on an NVIDIA Hopper GPU (``kernels/``) and their
plain PyTorch versions on the CPU; everything else runs a torch-op
Stockham FFT (``core.py``). Numpy input runs on the CUDA device unless the
caller names another (``device="cpu"``). CUDA sources are compiled at
first use, never at import.
"""

from .config import PlanConfig
from .core import SplitComplex
from .planner import (default_bases, digit_reverse, factorize,
                      next_fast_len, prev_fast_len, stage_schedule)
from .api import (Plan, PrecisionDowngradeWarning, plan_fft, fft, ifft,
                  fft2, ifft2, fftn, ifftn, rfft, irfft, rfft2, irfft2,
                  rfftn, irfftn, hfft, ihfft, hfft2, ihfft2, hfftn, ihfftn,
                  fftfreq, rfftfreq, fftshift, ifftshift)
from .signal import (FilterPlan, plan_filter, fftconvolve, oaconvolve,
                     correlate, hilbert, hilbert2, resample, envelope)
from .realtrans import dct, idct, dst, idst, dctn, idctn, dstn, idstn
from .czt import CZT, ZoomFFT, czt, zoom_fft, czt_points
from .fhtlog import fht, ifht, fhtoffset
from .backend import set_workers, get_workers, scipy_backend
from .spectral import (get_window, stft, istft, spectrogram, periodogram,
                       welch, csd, coherence, check_NOLA, check_COLA,
                       lombscargle)
from .shorttime import ShortTimeFFT, closest_STFT_dual_window
from .design import (BadCoefficients, buttap, cheb1ap, cheb2ap, ellipap,
                     besselap, lp2lp_zpk, lp2hp_zpk, lp2bp_zpk, lp2bs_zpk,
                     bilinear_zpk, iirfilter, butter, cheby1, cheby2, ellip,
                     bessel, zpk2tf, normalize, tf2zpk, zpk2sos, tf2sos,
                     kaiser_beta, kaiser_atten, firwin, lfilter_zi,
                     sosfilt_zi,
                     firwin2, firwin_2d, firls, remez, minimum_phase,
                     gammatone, kaiserord, lp2lp, lp2hp, lp2bp, lp2bs,
                     bilinear, iirnotch, iirpeak, iircomb, iirdesign,
                     buttord, cheb1ord, cheb2ord, ellipord, band_stop_obj,
                     sos2tf, sos2zpk, freqz, freqz_zpk, sosfreqz, freqz_sos,
                     group_delay, freqs, freqs_zpk, findfreqs, residue,
                     residuez, invres, invresz, unique_roots, lfiltic)
from .ltisys import (lti, dlti, TransferFunction, ZerosPolesGain, StateSpace,
                     tf2ss, ss2tf, zpk2ss, ss2zpk, abcd_normalize,
                     cont2discrete, lsim, impulse, step, freqresp, bode,
                     dlsim, dimpulse, dstep, dfreqresp, dbode, place_poles)
from .waveforms import (chirp, sweep_poly, gausspulse, square, sawtooth,
                        unit_impulse, max_len_seq)
from .iir import sosfilt, sosfiltfilt, lfilter, filtfilt
from .multirate import upfirdn, resample_poly, decimate
from .sigtools import (detrend, deconvolve, wiener, correlation_lags,
                       choose_conv_method, savgol_filter, savgol_coeffs,
                       convolve, convolve2d, correlate2d, order_filter,
                       medfilt, medfilt2d, vectorstrength)
from .peaks import (find_peaks, find_peaks_cwt, peak_prominences,
                    peak_widths, argrelmin, argrelmax, argrelextrema)
from .bsplines import (gauss_spline, cspline1d, qspline1d, cspline1d_eval,
                       qspline1d_eval, cspline2d, qspline2d, spline_filter,
                       sepfir2d, symiirorder1, symiirorder2)
from . import ndimage, windows

__version__ = "0.4.0"

__all__ = [
    "PlanConfig", "SplitComplex", "Plan", "PrecisionDowngradeWarning",
    "plan_fft",
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
    "default_bases", "digit_reverse", "factorize", "next_fast_len",
    "prev_fast_len", "stage_schedule",
    "plan_filter", "FilterPlan", "fftconvolve", "oaconvolve", "correlate",
    "hilbert", "hilbert2", "resample", "envelope",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "CZT", "ZoomFFT", "czt", "zoom_fft", "czt_points",
    "fht", "ifht", "fhtoffset",
    "get_window", "stft", "istft", "spectrogram", "periodogram", "welch",
    "csd", "coherence", "check_NOLA", "check_COLA", "lombscargle",
    "ShortTimeFFT", "closest_STFT_dual_window", "windows",
    "BadCoefficients", "buttap", "cheb1ap", "cheb2ap", "ellipap",
    "besselap", "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk",
    "bilinear_zpk", "iirfilter", "butter", "cheby1", "cheby2", "ellip",
    "bessel", "zpk2tf", "normalize", "tf2zpk", "zpk2sos", "tf2sos",
    "kaiser_beta", "kaiser_atten", "firwin", "lfilter_zi", "sosfilt_zi",
    "firwin2", "firwin_2d", "firls", "remez", "minimum_phase", "gammatone",
    "kaiserord", "lp2lp", "lp2hp", "lp2bp", "lp2bs", "bilinear",
    "iirnotch", "iirpeak", "iircomb", "iirdesign", "buttord", "cheb1ord",
    "cheb2ord", "ellipord", "band_stop_obj", "sos2tf", "sos2zpk",
    "freqz", "freqz_zpk", "sosfreqz", "freqz_sos", "group_delay",
    "freqs", "freqs_zpk", "findfreqs", "residue", "residuez", "invres",
    "invresz", "unique_roots", "lfiltic",
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace",
    "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize",
    "cont2discrete", "lsim", "impulse", "step", "freqresp", "bode",
    "dlsim", "dimpulse", "dstep", "dfreqresp", "dbode", "place_poles",
    "chirp", "sweep_poly", "gausspulse", "square", "sawtooth",
    "unit_impulse", "max_len_seq",
    "sosfilt", "sosfiltfilt", "lfilter", "filtfilt",
    "upfirdn", "resample_poly", "decimate",
    "detrend", "deconvolve", "wiener", "correlation_lags",
    "choose_conv_method", "savgol_filter", "savgol_coeffs", "convolve",
    "convolve2d", "correlate2d", "order_filter", "medfilt", "medfilt2d",
    "vectorstrength", "ndimage",
    "find_peaks", "find_peaks_cwt", "peak_prominences", "peak_widths",
    "argrelmin", "argrelmax", "argrelextrema",
    "gauss_spline", "cspline1d", "qspline1d", "cspline1d_eval",
    "qspline1d_eval", "cspline2d", "qspline2d", "spline_filter",
    "sepfir2d", "symiirorder1", "symiirorder2",
    "set_workers", "get_workers", "scipy_backend", "__version__",
]

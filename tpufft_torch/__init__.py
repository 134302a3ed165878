"""tpufft_torch — the PyTorch and CUDA port of tpufft.

Batched complex and real FFTs on torch tensors, with tpufft's plans,
arguments, split-plane layout and results, and the layers above them:
filtering and FFT convolution (``signal``), DCT/DST (``realtrans``), the
chirp-z transform (``czt``), the fast Hankel transform (``fhtlog``), and
short-time and averaged spectral analysis (``spectral``, ``shorttime``,
``windows``). A
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
from .spectral import (get_window, stft, istft, spectrogram, periodogram,
                       welch, csd, coherence, check_NOLA, check_COLA,
                       lombscargle)
from .shorttime import ShortTimeFFT, closest_STFT_dual_window
from . import windows

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
]

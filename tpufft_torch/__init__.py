"""tpufft_torch — the PyTorch and CUDA port of tpufft.

Batched complex and real FFTs on torch tensors, with tpufft's plans,
arguments, split-plane layout and results. A transform whose lengths are
inside the kernels' envelopes runs hand-written CUDA kernels on an NVIDIA
Hopper GPU (``kernels/``) and their plain PyTorch versions on the CPU;
everything else runs a torch-op Stockham FFT (``core.py``). CUDA sources
are compiled at first use, never at import.
"""

from .config import PlanConfig
from .core import SplitComplex
from .planner import (default_bases, factorize, next_fast_len,
                      prev_fast_len, stage_schedule)
from .api import (Plan, plan_fft, fft, ifft, fft2, ifft2, fftn, ifftn,
                  rfft, irfft, rfft2, irfft2, rfftn, irfftn, hfft, ihfft,
                  hfft2, ihfft2, hfftn, ihfftn)

__all__ = [
    "PlanConfig", "SplitComplex", "Plan", "plan_fft",
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "default_bases", "factorize", "next_fast_len", "prev_fast_len",
    "stage_schedule",
]

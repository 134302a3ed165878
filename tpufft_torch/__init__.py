"""tpufft_torch — the PyTorch and CUDA port of tpufft.

Batched complex FFTs on torch tensors, with tpufft's plans, arguments,
split-plane layout and results. A transform along a contiguous axis whose
length is inside the kernel's envelope runs a hand-written CUDA kernel on
an NVIDIA Hopper GPU (``kernels/minor_fft.py``) and its plain PyTorch
version on the CPU; everything else runs a torch-op Stockham FFT
(``core.py``). CUDA sources are compiled at first use, never at import.
"""

from .config import PlanConfig
from .core import SplitComplex
from .planner import (default_bases, factorize, next_fast_len,
                      prev_fast_len, stage_schedule)
from .api import Plan, plan_fft, fft, ifft, fft2, ifft2, fftn, ifftn

__all__ = [
    "PlanConfig", "SplitComplex", "Plan", "plan_fft",
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "default_bases", "factorize", "next_fast_len", "prev_fast_len",
    "stage_schedule",
]

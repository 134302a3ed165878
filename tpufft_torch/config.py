"""Plan configuration (counterpart of ``tpufft/config.py``).

``PlanConfig`` keeps tpufft's fields, defaults, profile resolution and
errors, so a configuration carries across unchanged (see ``convert.py``).
What each field means on the GPU:

* ``backend``: "pallas" runs the hand-written CUDA kernel or raises
  (the name is kept for parity with tpufft); "xla" runs the torch-op
  Stockham of ``core.py``; "auto" runs the kernel where the length and
  dtype are inside its envelope and the Stockham elsewhere.
* ``lane_block`` and ``vmem_budget_bytes`` are accepted and validated as
  in tpufft but unused: they size TPU VMEM blocks, and the CUDA kernel
  sizes its own thread blocks from the transform length.
* ``interpret`` is accepted and unused: a CPU tensor always runs the
  kernel's plain PyTorch version.
* ``precision`` is accepted. The CUDA kernel computes in f32 FMA under
  every precision, which is at least as accurate as the bf16x3 MXU
  emulation tpufft defaults to.
* ``plane_dtype`` / ``profile``: bf16 planes halve device-memory traffic;
  the kernel loads bf16, computes in f32 and rounds the result to bf16.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PlanConfig", "BACKENDS"]

BACKENDS = ("auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Tuning knobs for an FFT plan.

    Attributes:
      max_radix: largest radix the default planner synthesizes (the
        Stockham stage schedule; the CUDA kernel picks its own radices).
      backend: "pallas" (hand-written kernel or raise), "xla" (torch-op
        Stockham), or "auto".
      lane_block: accepted for parity with tpufft; unused on the GPU.
      interpret: accepted for parity with tpufft; unused on the GPU.
      vmem_budget_bytes: accepted for parity with tpufft; unused on the GPU.
      precision: "bf16x3", "highest" or "default". The CUDA kernel computes
        in f32 under all three.
      plane_dtype: storage dtype of the split planes, "float32" or
        "bfloat16"; f64 plans ignore it.
      profile: "accurate" (f32 planes) or "fast" (bf16 planes and
        precision "default"); it fills only knobs left unset.
    """

    max_radix: int = 16
    backend: str = "auto"
    lane_block: int | None = None
    interpret: bool = False
    vmem_budget_bytes: int = 12 * 1024 * 1024
    precision: str | None = None     # resolved from profile when unset
    plane_dtype: str | None = None   # resolved from profile when unset
    profile: str = "accurate"

    def __post_init__(self):
        if self.profile not in ("accurate", "fast"):
            raise ValueError(
                f"profile must be accurate|fast, got {self.profile!r}"
            )
        fast = self.profile == "fast"
        if self.precision is None:
            object.__setattr__(self, "precision",
                               "default" if fast else "bf16x3")
        if self.plane_dtype is None:
            object.__setattr__(self, "plane_dtype",
                               "bfloat16" if fast else "float32")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )
        if self.precision not in ("bf16x3", "highest", "default"):
            raise ValueError(
                f"precision must be bf16x3|highest|default, got "
                f"{self.precision!r}"
            )
        if self.plane_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"plane_dtype must be float32|bfloat16, got "
                f"{self.plane_dtype!r}"
            )

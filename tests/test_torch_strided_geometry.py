"""A model of the strided kernel's form choice and line-form geometry
(``line_split`` and ``line_geometry`` in
``tpufft_torch/csrc/strided_line.cuh``), with the table of forms expected
at each (n, post, dtype).

The port reads the geometry from the CUDA library
(``inner_fft.line_geometry``), which needs the toolkit. The CPU tests use
this model instead: ``test_torch_kernel_inner.py`` walks the tile mapping of
every geometry and runs the model FFT on its four-step, and the ``form``
tests there and in ``test_torch_kernel_fused.py`` run the wrappers' Python
side over it. ``test_torch_cuda.py`` holds the library's answers to the
model on the card. This module imports neither jax nor tpufft, so the card
tests can import it.
"""

import pytest
import torch

from tpufft_torch.kernels import minor_fft

# The four-step n = N1 N2 of each length of the line form; N2 = 1 for
# n <= 32, one line a lane; an N2 of 34 to 64 lies on lane pairs.
SPLITS = {8: (8, 1), 10: (10, 1), 12: (12, 1), 16: (16, 1), 20: (20, 1),
          24: (24, 1), 25: (25, 1), 30: (30, 1), 32: (32, 1), 40: (10, 4),
          48: (12, 4), 60: (15, 4), 64: (8, 8), 80: (10, 8), 93: (3, 31),
          96: (12, 8), 120: (15, 8), 128: (16, 8), 160: (20, 8),
          192: (24, 8), 240: (15, 16), 256: (16, 16), 320: (20, 16),
          384: (24, 16), 480: (15, 32), 512: (32, 16), 640: (32, 20),
          768: (32, 24), 960: (15, 64), 1024: (32, 32), 1080: (30, 36),
          1280: (20, 64), 1536: (24, 64), 1920: (30, 64), 2048: (32, 64)}
# n = r 2^a, r in {1, 3, 5}, 8 to 2048; 15 2^a, 30 to 1920; 25, 93, 1080
LINE_NS = sorted(SPLITS)
NEW_LINE_NS = [n for n in LINE_NS if n % 15 == 0 or n in (25, 93)]
LINES_THREADS = 128           # a block of the n <= 32 kernel
SMEM_MAX = 232448             # bytes of shared memory a block may take


def lane_threads(n: int, bf16: bool) -> int:
    """The four-step kernel's launch bound: 320 lanes a block, or 512
    where the narrowest unit (8 f32 or 16 bf16 columns) takes more."""
    return 512 if n * (16 if bf16 else 8) // 32 > 320 else 320


def model_geometry(n: int, post: int, bf16: bool,
                   cols: int = 0) -> dict | None:
    """The line form's geometry at n and post, as the launch's
    ``line_geometry`` computes it (keys of ``inner_fft.line_geometry``),
    or None for the stage form. ``cols`` = 8, 16 or 32 takes that C
    instead of the launch's widest fitting one, so that the tile tests
    walk every C a block can hold."""
    if n not in SPLITS:
        return None
    n1, n2 = SPLITS[n]
    min_cols = 16 if bf16 else 8
    if cols == 0:
        if post < min_cols:
            return None
        cols = 32
        while cols > min_cols and (cols > post or (
                n2 > 1 and cols * n // 32 > lane_threads(n, bf16))):
            cols //= 2
    if cols < min_cols:
        return None
    threads = (LINES_THREADS if n2 == 1
               else (-(-cols * n // 32) + 31) // 32 * 32)
    smem = 8 * (n + n // 16 + (0 if n2 == 1 else cols * n))
    if threads > lane_threads(n, bf16) or smem > SMEM_MAX:
        return None
    return {"n1": n1, "n2": n2, "cols": cols, "threads": threads,
            "pair": n2 > 32, "smem": smem}


def model_form(n: int, post: int, dtype) -> str | None:
    """``inner_fft.form`` by the model."""
    if not minor_fft.supported(n, dtype):
        return None
    geo = model_geometry(n, post, dtype == torch.bfloat16)
    return "stages" if geo is None else "lines"


def use_model(monkeypatch) -> None:
    """Answer ``inner_fft``'s geometry query from the model instead of the
    library."""
    from tpufft_torch.kernels import inner_fft
    monkeypatch.setattr(inner_fft, "_line_geometry", model_geometry)


# (n, post, dtype, the form the launch runs)
FORM_CASES = (
    [(n, 480, torch.float32, "lines") for n in LINE_NS]
    + [(n, 8, torch.float32, "lines") for n in (8, 40, 640, 2048)]
    + [(n, 7, torch.float32, "stages") for n in (8, 128, 2048)]
    + [(n, 1, torch.float32, "stages") for n in (8, 640)]
    + [(n, 16, torch.bfloat16, "lines") for n in (8, 96, 640, 1024)]
    + [(n, 15, torch.bfloat16, "stages") for n in (8, 128, 1024)]
    + [(n, 480, torch.bfloat16, "stages") for n in (1280, 1536, 2048)]
    + [(n, 480, torch.bfloat16, "stages") for n in (1080, 1920)]
    + [(n, 480, torch.bfloat16, "lines") for n in (25, 93, 480, 960)]
    + [(n, 480, torch.float32, "stages")
       for n in (2, 4, 5, 6, 127, 2560, 4096, 16384, 37, 3 * 37, 62)]
    + [(131, 480, torch.float32, None), (16385, 480, torch.float32, None),
       (128, 480, torch.float64, None)])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", LINE_NS)
def test_model_geometry(n, bf16):
    """At every length and post, the model's geometry is a four-step of n
    whose block is a whole number of warps holding C n / 32 lanes (n > 32)
    within the launch bound and the shared memory, with C the widest of
    32, 16 and 8 that fits, never wider than post, and no narrower than 8
    f32 or 16 bf16 columns."""
    min_cols = 16 if bf16 else 8
    for post in (1, min_cols - 1, min_cols, 9, 17, 31, 32, 33, 241, 4096):
        geo = model_geometry(n, post, bf16)
        if post < min_cols:
            assert geo is None
            continue
        if geo is None:
            assert bf16 and n > 1024
            continue
        assert geo["n1"] * geo["n2"] == n and geo["n1"] <= 32
        assert min_cols <= geo["cols"] <= max(post, min_cols)
        assert geo["threads"] % 32 == 0
        assert geo["threads"] <= lane_threads(n, bf16)
        assert geo["smem"] <= SMEM_MAX
        if geo["n2"] > 1:
            assert geo["threads"] >= geo["cols"] * n // 32
        wider = 2 * geo["cols"]
        assert (wider > 32 or wider > post or (
            geo["n2"] > 1 and wider * n // 32 > lane_threads(n, bf16)))

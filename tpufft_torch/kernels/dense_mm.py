"""Batched dense matrix product along the contiguous minor axis: the CUDA
kernels, their wrappers, and their plain PyTorch versions.

Counterpart of three Pallas TPU kernels with one contract, (batch, m_in)
rows times one (m_in, m_out) matrix built on the host:

* ``tpufft/kernels/mxu_fft.py:build_minor_dense`` (K10), complex planes
  times a complex matrix (the fused circulant of ``plan_filter``):
  :func:`dense_mm_complex`;
* ``mxu_fft.py:build_minor_dense_real`` (K11), real rows times a real
  matrix (a Hermitian-response filter on real input): :func:`dense_mm_real`;
* ``tpufft/realtrans.py:_build_minor_r2r`` (K12), real rows times the
  DCT/DST matrix: :func:`r2r_minor`, the real kernel with that table.

One CUDA source (``csrc/dense_mm.cu``) serves all three. Each product
has two bodies, :func:`form`: a 3xTF32 tensor-core GEMM
(``csrc/tf32x3_mm.cuh``: each f32 operand split into a TF32 big and small
part, three ``mma.sync`` products summed in f32) where both lengths are
multiples of 4, else a shared-memory SGEMM with f32 FMA. The complex
product (K10) runs on the tensor cores as one real product of the planes
side by side, [Yr | Yi] = [Xr | Xi] times the block table
[[Wr, Wi], [-Wi, Wr]] (:func:`block_table`); its FMA body accumulates both
output planes from one read of X. Rows, tables and results are f32 and
contiguous. Tables are built in float64 on the host by the caller, cast to
f32 and uploaded once per (key, device) by :func:`device_table`.

A CPU tensor runs the plain version (one ``torch.matmul``, four for the
complex form); a CUDA tensor launches the kernel or raises, never falls
back. ``launches["complex"|"real"|"r2r"]`` count launches;
``reference_cuda_calls`` counts runs of the plain versions on CUDA
tensors, which the main path never makes.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .. import _build

__all__ = [
    "block_table",
    "dense_mm_complex",
    "dense_mm_complex_reference",
    "dense_mm_real",
    "dense_mm_real_reference",
    "device_table",
    "form",
    "launches",
    "r2r_minor",
    "r2r_minor_reference",
    "reference_cuda_calls",
    "reset_counts",
]

launches = {"complex": 0, "real": 0, "r2r": 0}
reference_cuda_calls = 0

_FORMS = {"fma": 0, "tf32x3": 1}
_MAX_TABLES = 64
_tables: collections.OrderedDict = collections.OrderedDict()


def reset_counts() -> None:
    """Zero ``launches`` and ``reference_cuda_calls``."""
    global reference_cuda_calls
    for k in launches:
        launches[k] = 0
    reference_cuda_calls = 0


def device_table(key, build, device, dtype=torch.float32) -> torch.Tensor:
    """The host table ``build()`` (a float64 numpy array) as a contiguous
    ``dtype`` tensor on ``device``: built and uploaded once per (key,
    device, dtype), the most recent 64 kept."""
    k = (key, torch.device(device), dtype)
    table = _tables.get(k)
    if table is None:
        table = torch.as_tensor(build()).to(device=k[1],
                                            dtype=dtype).contiguous()
        _tables[k] = table
        if len(_tables) > _MAX_TABLES:
            _tables.popitem(last=False)
    else:
        _tables.move_to_end(k)
    return table


def _check(name: str, what: str, t: torch.Tensor, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: {what} must lie on the rows' CUDA "
                         f"device, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous matrix, got "
                         f"shape {tuple(t.shape)}")


def _check_operands(name: str, xs, ws) -> tuple[int, int, int]:
    """Raise ValueError unless the rows ``xs`` (batch, m_in) and the tables
    ``ws`` (m_in, m_out) are contiguous f32 matrices on one CUDA device;
    returns (batch, m_in, m_out)."""
    device = xs[0].device
    for x in xs:
        _check(name, "rows", x, device)
    for w in ws:
        _check(name, "the table", w, device)
    batch, m_in = xs[0].shape
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: planes of different shapes")
    if any(w.shape != ws[0].shape for w in ws) or ws[0].shape[0] != m_in:
        raise ValueError(
            f"{name}: table {tuple(ws[0].shape)} does not take rows of "
            f"length {m_in}")
    return batch, m_in, ws[0].shape[1]


def block_table(wr, wi):
    """The (2 m_in, 2 m_out) real table [[wr, wi], [-wi, wr]] of the complex
    product (numpy or torch planes): [xr | xi] @ it is [yr | yi], the
    operand of the complex kernel's tensor-core body."""
    if isinstance(wr, torch.Tensor):
        return torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)])
    return np.block([[wr, wi], [-wi, wr]])


def dense_mm_complex(xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor, wb: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xr + i xi) @ (wr + i wi) for (batch, m_in) planes and an
    (m_in, m_out) table: the (batch, m_out) re/im planes (K10).

    ``wb`` is ``block_table(wr, wi)`` on the rows' device, which the
    tensor-core body multiplies by; callers that run often upload it once
    (:func:`device_table`), else it is built here on each call.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and raise on anything it does not take."""
    if all(t.device.type == "cpu" for t in (xr, xi, wr, wi)):
        return dense_mm_complex_reference(xr, xi, wr, wi)
    batch, m_in, m_out = _check_operands("dense_mm_complex", (xr, xi),
                                         (wr, wi))
    yr = xr.new_empty((batch, m_out))
    yi = torch.empty_like(yr)
    if batch == 0:
        return yr, yi
    body = form(m_in, m_out, (xr.data_ptr() | xi.data_ptr()) % 16 == 0)
    if body == "tf32x3":
        if wb is None:
            wb = block_table(wr, wi).contiguous()
        _check("dense_mm_complex", "the block table", wb, xr.device)
        if wb.shape != (2 * m_in, 2 * m_out) or wb.data_ptr() % 16:
            raise ValueError(
                f"dense_mm_complex: block table {tuple(wb.shape)} is not an "
                f"aligned ({2 * m_in}, {2 * m_out}) matrix")
    lib = _build.load()
    with torch.cuda.device(xr.device):
        err = lib.tpufft_dense_mm_complex(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            0 if wb is None else wb.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            batch, m_in, m_out, _FORMS[body],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_mm_complex launch failed: CUDA error {err}")
    launches["complex"] += 1
    return yr, yi


def form(m_in: int, m_out: int, aligned: bool = True) -> str:
    """Which body of the kernels (K10, K11, K12) multiplies (batch, m_in)
    rows by an (m_in, m_out) table: ``"tf32x3"``, the 3xTF32 tensor-core
    GEMM, where m_in and m_out are multiples of 4 (its 16-byte copies; for
    K10 each copy and each stored pair then lies in one plane) and the
    operands start on 16-byte boundaries (``aligned``: a view with an odd
    storage offset does not), else ``"fma"``, the f32 FMA tile loop. The
    wrappers pass the choice to ``tpufft_dense_mm_real`` and
    ``tpufft_dense_mm_complex``."""
    fits = m_in % 4 == 0 and m_out % 4 == 0 and aligned
    return "tf32x3" if fits else "fma"


def _real(name: str, counter: str, x: torch.Tensor,
          w: torch.Tensor) -> torch.Tensor:
    batch, m_in, m_out = _check_operands(name, (x,), (w,))
    y = x.new_empty((batch, m_out))
    if batch == 0:
        return y
    body = form(m_in, m_out, (x.data_ptr() | w.data_ptr()) % 16 == 0)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tpufft_dense_mm_real(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), batch, m_in, m_out,
            _FORMS[body], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[counter] += 1
    return y


def dense_mm_real(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for real (batch, m_in) rows and a real (m_in, m_out) table
    (K11). CPU tensors run the plain version; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return dense_mm_real_reference(x, w)
    return _real("dense_mm_real", "real", x, w)


def r2r_minor(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for real (batch, n) rows and a DCT/DST table (K12): the real
    kernel, counted apart. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return r2r_minor_reference(x, w)
    return _real("r2r_minor", "r2r", x, w)


# ----------------------------------------------------------------------------
# Plain versions: torch.matmul in f32 (on a GPU this assumes
# torch.backends.cuda.matmul.allow_tf32 is False, PyTorch's default)
# ----------------------------------------------------------------------------

def dense_mm_complex_reference(xr: torch.Tensor, xi: torch.Tensor,
                               wr: torch.Tensor, wi: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dense_mm_complex`: four real
    matmuls; any device."""
    global reference_cuda_calls
    if xr.is_cuda:
        reference_cuda_calls += 1
    return xr @ wr - xi @ wi, xr @ wi + xi @ wr


def dense_mm_real_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dense_mm_real`: one matmul; any
    device."""
    global reference_cuda_calls
    if x.is_cuda:
        reference_cuda_calls += 1
    return x @ w


def r2r_minor_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`r2r_minor`: one matmul; any
    device."""
    return dense_mm_real_reference(x, w)

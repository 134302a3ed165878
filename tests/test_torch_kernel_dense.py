"""The dense-matrix kernels' plain versions against tpufft's Pallas kernels.

K10 (``mxu_fft.build_minor_dense``), K11 (``build_minor_dense_real``) and
K12 (``realtrans._build_minor_r2r``) run in interpret mode on the CPU with
tpufft's default bf16x3 precision; the port's wrappers, given CPU tensors,
run their plain versions (``torch.matmul`` in f32). Both get the same
seeded numpy rows and tables. Tolerance 2e-5, normalized by the result's
magnitude: bf16x3 keeps about 2^-24 of each product and the plain version
rounds in f32, so the two differ by a few 1e-6 at m_in = 512 (the
kernels on the card are held to their plain versions in
``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from tpufft import realtrans as tp_realtrans
from tpufft.kernels import mxu_fft

from tpufft_torch import realtrans
from tpufft_torch.kernels import dense_mm

TOL = 2e-5
# (batch, m_in, m_out): squares, rectangles both ways, ragged batches
SHAPES = [(37, 2, 2), (37, 7, 7), (257, 93, 93), (257, 93, 128),
          (257, 128, 93), (100, 512, 512)]


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("batch,m_in,m_out", SHAPES)
def test_complex_matches_tpufft(batch, m_in, m_out):
    xr, xi = _f32((batch, m_in), 1), _f32((batch, m_in), 2)
    wr, wi = _f32((m_in, m_out), 3), _f32((m_in, m_out), 4)
    ref = mxu_fft.build_minor_dense(wr, wi, 512, "bf16x3", True)(xr, xi)
    yr, yi = dense_mm.dense_mm_complex(*(torch.from_numpy(a)
                                         for a in (xr, xi, wr, wi)))
    assert yr.dtype == torch.float32 and yr.shape == (batch, m_out)
    got = yr.numpy() + 1j * yi.numpy()
    assert _err(got, np.asarray(ref[0]) + 1j * np.asarray(ref[1])) < TOL
    exact = (xr.astype(np.float64) + 1j * xi) @ (wr.astype(np.float64)
                                                 + 1j * wi)
    assert _err(got, exact) < TOL


@pytest.mark.parametrize("batch,m_in,m_out", SHAPES)
def test_real_matches_tpufft(batch, m_in, m_out):
    x, w = _f32((batch, m_in), 5), _f32((m_in, m_out), 6)
    ref = mxu_fft.build_minor_dense_real(w, 512, "bf16x3", True)(x)
    y = dense_mm.dense_mm_real(torch.from_numpy(x), torch.from_numpy(w))
    assert y.dtype == torch.float32 and y.shape == (batch, m_out)
    assert _err(y.numpy(), ref) < TOL
    assert _err(y.numpy(), x.astype(np.float64) @ w) < TOL


@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("n,norm,inverse", [(2, "backward", False),
                                            (93, "ortho", True),
                                            (128, "forward", False),
                                            (1000, "ortho", False)])
def test_r2r_matches_tpufft(kind, type_, n, norm, inverse):
    """K12 with the table of every (kind, type), at the edge lengths."""
    x = _f32((37, n), n)
    ref = tp_realtrans._build_minor_r2r(kind, type_, n, norm, inverse, 512,
                                        "bf16x3", True)(x)
    table = realtrans._table((kind, type_, n, norm, inverse), "cpu")
    y = dense_mm.r2r_minor(torch.from_numpy(x), table)
    assert _err(y.numpy(), ref) < TOL
    mat = realtrans._mat(kind, type_, n, norm, inverse)
    assert np.array_equal(mat, tp_realtrans._mat(kind, type_, n, norm,
                                                 inverse))
    assert _err(y.numpy(), x.astype(np.float64) @ mat) < TOL


def test_cpu_tensors_run_the_plain_versions():
    """CPU tensors never reach the CUDA library, launch nothing and count
    nothing."""
    dense_mm.reset_counts()
    x, w = torch.ones(3, 4), torch.ones(4, 5)
    assert torch.equal(dense_mm.dense_mm_real(x, w), torch.full((3, 5), 4.0))
    assert torch.equal(dense_mm.r2r_minor(x, w), torch.full((3, 5), 4.0))
    yr, yi = dense_mm.dense_mm_complex(x, x, w, w)
    assert torch.equal(yr, torch.zeros(3, 5))
    assert torch.equal(yi, torch.full((3, 5), 8.0))
    assert dense_mm.launches == {"complex": 0, "real": 0, "r2r": 0}
    assert dense_mm.reference_cuda_calls == 0


def test_device_table_uploads_once():
    builds = []

    def build():
        builds.append(1)
        return np.eye(3)

    a = dense_mm.device_table(("test-eye", 3), build, "cpu")
    b = dense_mm.device_table(("test-eye", 3), build, "cpu")
    assert a is b and len(builds) == 1
    assert a.dtype == torch.float32 and a.is_contiguous()
    c = dense_mm.device_table(("test-eye", 3), build, "cpu", torch.float64)
    assert c.dtype == torch.float64 and len(builds) == 2

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

The real kernel's tensor-core body (``csrc/tf32x3_mm.cuh``) cannot run
here; a numpy model of its arithmetic stands in for it: the split of each
f32 operand into a TF32 big part (low 13 mantissa bits cleared; 0 for Inf
and NaN) and a small part (the rest, truncated to TF32 too), and three
products accumulated in f32, small ones first. It is held
to float64 at the plain version's 1e-5, and one TF32 product is shown to
miss it.
"""

import numpy as np
import pytest
import torch

from tpufft import realtrans as tp_realtrans
from tpufft.kernels import mxu_fft

from tpufft_torch import realtrans, signal
from tpufft_torch.kernels import dense_mm
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

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


# ----------------------------------------------------------------------------
# The tensor-core body's arithmetic (3xTF32), modelled in numpy
# ----------------------------------------------------------------------------

F32_TOL = 1e-5   # the kernel against its plain version on the card
_MASK = np.uint32(0xFFFFE000)   # TF32 keeps the top 19 bits of an f32


def _tf32_split(v):
    """The kernel's split (``tf32x3::split``): v -> (big, small), both
    TF32 values held in f32."""
    v = np.ascontiguousarray(v, np.float32)
    u = v.view(np.uint32)
    keep = np.where(np.abs(v) <= np.finfo(np.float32).max, _MASK,
                    np.uint32(0))
    big = (u & keep).view(np.float32)
    with np.errstate(invalid="ignore"):
        small = ((v - big).view(np.uint32) & _MASK).view(np.float32)
    return big, small


def _tf32_round(v):
    """One TF32 rounding to nearest, ties away (cvt.rna.tf32.f32)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & _MASK).view(np.float32)


def _tf32x3(x, w):
    """x @ w as the kernel forms it: three products of the TF32 parts,
    accumulated in f32, the two small ones first."""
    xb, xs = _tf32_split(x)
    wb, ws = _tf32_split(w)
    with np.errstate(invalid="ignore", over="ignore"):
        acc = xs @ wb
        acc += xb @ ws
        acc += xb @ wb
    return acc


def _table(name, n):
    """The tables the real kernel multiplies by on the paths: the DCT-II
    matrix (``dct``, K12) and the circulant of a low-pass filter (bins
    |k| <= n/8, a real impulse: ``plan_filter`` on real rows, K11)."""
    if name == "dct2":
        return realtrans._mat("dct", 2, n, "backward", False)
    k = np.minimum(np.arange(n), n - np.arange(n))
    impulse = np.fft.ifft((k <= n // 8).astype(np.float64)).real
    return signal._circulant(impulse)


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / max(1.0, np.max(np.abs(ref))))


@pytest.mark.parametrize("table", ["dct2", "lowpass"])
@pytest.mark.parametrize("n", [93, 512, 1024])
def test_tf32x3_model_meets_the_f32_tolerance(n, table):
    """3xTF32 stays within 1e-5 of float64 on (257, n) rows; one TF32
    product (what ``allow_tf32`` gives) does not."""
    x = _f32((257, n), n)
    w64 = _table(table, n)
    w = w64.astype(np.float32)
    exact = x.astype(np.float64) @ w64
    err3 = _norm_err(_tf32x3(x, w).astype(np.float64), exact)
    err1 = _norm_err((_tf32_round(x) @ _tf32_round(w)).astype(np.float64),
                     exact)
    plain = _norm_err((x @ w).astype(np.float64), exact)
    assert err3 < F32_TOL and err3 < 10 * max(plain, 1e-7), (err3, plain)
    assert err1 > F32_TOL, err1


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan, 3.4e38,
                                   np.finfo(np.float32).max, 1e-20, 1e18])
def test_tf32x3_split_keeps_edge_values(value):
    """big + small gives v back to within 2^-20, never rounds a finite v
    up to Inf (|big + small| <= |v|), and carries Inf and NaN whole in the
    small part."""
    v = np.array([value, -value], np.float32)
    big, small = _tf32_split(v)
    if np.isfinite(value):
        assert np.all(np.isfinite(big)) and np.all(np.isfinite(small))
        total = big.astype(np.float64) + small
        assert np.all(np.abs(total) <= np.abs(v.astype(np.float64)))
        assert np.all(np.abs(total - v) / np.abs(v) <= 2.0 ** -20)
    else:
        assert np.all(big == 0)
        assert np.array_equal(np.isnan(small), np.isnan(v))
        assert np.array_equal(small[np.isinf(v)], v[np.isinf(v)])


@pytest.mark.parametrize("table", ["dct2", "lowpass"])
@pytest.mark.parametrize("n", [93, 512])
def test_tf32x3_model_keeps_the_plain_inf_and_nan_pattern(n, table):
    """Rows with +-Inf, NaN, a value near FLT_MAX and rows scaled by 1e-20
    and 1e18: the model's Inf and NaN fall where the f32 product's do, and
    the finite entries agree within 1e-5 (scaled rows relative to their
    own magnitude)."""
    x = _f32((16, n), n + 1)
    x[0, 5] = np.inf
    x[1, 7] = -np.inf
    x[2, 3] = np.nan
    x[3, 9] = 3.4e38
    x[4, 11] = np.finfo(np.float32).max
    x[5] *= np.float32(1e-20)
    x[6] *= np.float32(1e18)
    w = _table(table, n).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        ref = x @ w
    got = _tf32x3(x, w)
    for test in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(test(got), test(ref)), test.__name__
    assert np.all(~np.isfinite(ref[:3]).all(axis=1))
    for row in range(x.shape[0]):
        fin = np.isfinite(ref[row])
        scale = max(float(np.max(np.abs(ref[row][fin]), initial=0.0)),
                    1e-30)
        assert np.max(np.abs(got[row][fin] - ref[row][fin]),
                      initial=0.0) / scale < F32_TOL, row


# every shape chip_smoke.py holds K11/K12 to (DENSE_SHAPES, R2R_NS)
@pytest.mark.parametrize("m_in,m_out,body", [
    (2, 2, "fma"), (7, 7, "fma"), (64, 64, "tf32x3"), (93, 93, "fma"),
    (128, 128, "tf32x3"), (512, 512, "tf32x3"), (93, 128, "fma"),
    (128, 93, "fma"), (3, 3, "fma"), (1000, 1000, "tf32x3"),
    (1024, 1024, "tf32x3")])
def test_form_names_the_body_of_each_shape(m_in, m_out, body):
    assert dense_mm.form(m_in, m_out) == body
    assert dense_mm.form(m_in, m_out, aligned=False) == "fma"


# ----------------------------------------------------------------------------
# K10's tensor-core body: the complex product as one real block product
# ----------------------------------------------------------------------------

def _lowpass_complex(n):
    """The circulant of a complex impulse (a one-sided band, |k| <= n/8 for
    k >= 0 only): ``plan_filter`` on complex rows, K10's table."""
    impulse = np.fft.ifft((np.arange(n) <= n // 8).astype(np.float64))
    return signal._circulant(impulse)


def test_block_table_is_the_complex_product_as_one_real_product():
    """block_table(wr, wi) is [[wr, wi], [-wi, wr]], on numpy and torch
    planes alike, and [xr | xi] times it is [yr | yi]."""
    wr, wi = _f32((5, 3), 30), _f32((5, 3), 31)
    b = dense_mm.block_table(wr, wi)
    assert b.shape == (10, 6)
    np.testing.assert_array_equal(b[:5, :3], wr)
    np.testing.assert_array_equal(b[:5, 3:], wi)
    np.testing.assert_array_equal(b[5:, :3], -wi)
    np.testing.assert_array_equal(b[5:, 3:], wr)
    bt = dense_mm.block_table(torch.from_numpy(wr), torch.from_numpy(wi))
    np.testing.assert_array_equal(bt.numpy(), b)
    xr, xi = _f32((4, 5), 32), _f32((4, 5), 33)
    y = np.concatenate([xr, xi], 1).astype(np.float64) @ b
    want = (xr + 1j * xi).astype(np.complex128) @ (wr + 1j * wi)
    np.testing.assert_allclose(y[:, :3] + 1j * y[:, 3:], want, atol=1e-12)


@pytest.mark.parametrize("n", [93, 512])
def test_tf32x3_model_of_the_complex_block_product(n):
    """The 3xTF32 model of [xr | xi] @ block_table(cr, ci) (K10 at depth
    and width 2 n) stays within 1e-5 of the float64 complex product on
    (257, n) rows, and within 10x of the plain f32 version's error."""
    xr, xi = _f32((257, n), 2 * n), _f32((257, n), 2 * n + 1)
    c64 = _lowpass_complex(n)
    cr, ci = c64.real.astype(np.float32), c64.imag.astype(np.float32)
    exact = (xr + 1j * xi).astype(np.complex128) @ c64
    y = _tf32x3(np.concatenate([xr, xi], 1),
                dense_mm.block_table(cr, ci)).astype(np.float64)
    got = y[:, :n] + 1j * y[:, n:]
    pr, pi = dense_mm.dense_mm_complex_reference(
        *(torch.from_numpy(a) for a in (xr, xi, cr, ci)))
    plain = pr.numpy().astype(np.float64) + 1j * pi.numpy()
    err3, err_plain = _norm_err(got, exact), _norm_err(plain, exact)
    assert err3 < F32_TOL and err3 < 10 * max(err_plain, 1e-7), (
        err3, err_plain)


# every shape chip_smoke.py holds K10 to (DENSE_SHAPES)
@pytest.mark.parametrize("m_in,m_out,body", [
    (2, 2, "fma"), (7, 7, "fma"), (93, 93, "fma"), (93, 128, "fma"),
    (128, 93, "fma"), (64, 64, "tf32x3"), (100, 100, "tf32x3"),
    (512, 512, "tf32x3")])
def test_form_names_the_complex_body_of_each_shape(m_in, m_out, body):
    """K10 takes the tensor-core body where both lengths are multiples of
    4 (each 16-byte copy in one plane of [xr | xi], each stored pair in
    one of [yr | yi]) and every plane is aligned."""
    assert dense_mm.form(m_in, m_out) == body
    assert dense_mm.form(m_in, m_out, aligned=False) == "fma"

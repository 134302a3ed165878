"""The port on the card: each CUDA kernel against its plain version, and the
main paths through them.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports neither jax nor tpufft, so it also runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances (normalized by the spectrum's magnitude): 1e-5 for f32 storage,
where both sides compute in f32; 8e-3 for bf16 storage, where both round
their result to bf16 at the store.
"""

import numpy as np
import pytest
import torch

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex, realtrans
from tpufft_torch.kernels import (cube_fft, dense_mm, inner_fft,
                                  mid_pair_fft, minor_fft, pair_fft, real_fft,
                                  stft_mm)

from test_torch_strided_geometry import CLUSTER, CLUSTER_NS, FORM_CASES
from test_torch_strided_geometry import LINE_NS as STRIDED_LINE_NS
from test_torch_strided_geometry import model_form, model_geometry

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _err(got, ref):
    g = got[0].float().cpu().numpy() + 1j * got[1].float().cpu().numpy()
    r = ref[0].float().cpu().numpy() + 1j * ref[1].float().cpu().numpy()
    return np.max(np.abs(g - r)) / max(1.0, float(np.max(np.abs(r))))


def _planes(shape, device, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    re = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return re.to(device, dtype), im.to(device, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8, 93, 127, 128, 960, 1024, 1792, 4096,
                               8192, 16383, 16384, 12, 60, 480, 1000, 1080,
                               2160, 3840])
def test_kernel_matches_plain_version(n, dtype, tol, cuda_device):
    xr, xi = _planes((257, n), cuda_device, dtype, seed=n)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / n):
            before = minor_fft.launches
            got = minor_fft.fft_minor(xr, xi, inverse=inverse, scale=scale)
            assert minor_fft.launches == before + 1
            ref = minor_fft.fft_minor_reference(xr, xi, inverse=inverse,
                                                scale=scale)
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and got[0].shape == (257, n)
            assert _err(got, ref) < tol


# the line form: powers of two 2 .. 4096, the mixed-radix lengths and the
# three-factor lengths (4096 among them; LONG_ABOVE those above it)
LONG_NS = sorted(minor_fft._LONG_STEP)
LONG_ABOVE = [n for n in LONG_NS if n > 4096]
LINE_NS = ([2 ** k for k in range(1, 13)] + sorted(minor_fft._MIXED_STEP)
           + LONG_ABOVE)
LINE_BATCHES = [1, 3, 127, 129, 257]        # ragged last blocks and groups


def _fused_minor(xr, xi):
    """The (B, 2n) fused array [re | im] of the planes."""
    return torch.cat([xr, xi], -1).contiguous()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", LINE_BATCHES)
@pytest.mark.parametrize("n", LINE_NS)
def test_line_form_matches_plain_version(n, batch, dtype, tol, cuda_device):
    """K1 and K20 on the line form (power-of-two n up to 4096, the
    mixed-radix lengths and the three-factor lengths above 4096) against
    their plain versions: both directions, scale 1 and 1/n, one launch a
    call."""
    from tpufft_torch.kernels import fused_fft
    assert minor_fft.form(n) == "lines" == fused_fft.minor_form(n)
    xr, xi = _planes((batch, n), cuda_device, dtype, seed=n + batch)
    st = _fused_minor(xr, xi)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / n):
            kw = dict(inverse=inverse, scale=scale)
            before = minor_fft.launches
            got = minor_fft.fft_minor(xr, xi, **kw)
            assert minor_fft.launches == before + 1
            ref = minor_fft.fft_minor_reference(xr, xi, **kw)
            before = fused_fft.launches["minor"]
            out = fused_fft.fft_minor_fused(st, **kw)
            assert fused_fft.launches["minor"] == before + 1
            plain = fused_fft.fft_minor_fused_reference(st, **kw)
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and got[0].shape == (batch, n)
            assert out.dtype == dtype and out.shape == (batch, 2 * n)
            assert _err(got, ref) < tol
            assert _err((out[:, :n], out[:, n:]),
                        (plain[:, :n], plain[:, n:])) < tol


def _fft_edge_rows(xr, xi):
    """+Inf, -Inf and NaN in the re plane of rows 0-2, 3.4e38 in row 3,
    and rows 5 and 6 (both planes) scaled by 1e-20 and 1e18."""
    xr, xi = xr.clone(), xi.clone()
    n = xr.shape[1]
    xr[0, 5 % n] = float("inf")
    xr[1, 7 % n] = float("-inf")
    xr[2, 3 % n] = float("nan")
    xr[3, 9 % n] = 3.4e38
    for x in (xr, xi):
        x[5] *= 1e-20
        x[6] *= 1e18
    return xr, xi


def _complex_row_err(got, ref):
    """max |got - ref| over the finite entries of each complex row, relative
    to the row's largest finite |ref| (the 1e-20 row held to its scale)."""
    fin = torch.isfinite(ref[0]) & torch.isfinite(ref[1])
    mag = torch.where(fin, torch.hypot(ref[0], ref[1]), 0)
    diff = torch.where(fin, torch.hypot(got[0] - ref[0], got[1] - ref[1]), 0)
    return (diff / mag.amax(1, keepdim=True).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K20"])
@pytest.mark.parametrize("n", [2, 8, 64, 128, 256, 1024, 2048, 4096, 12, 93,
                               480, 1000, 1080, 2160, 3840] + LONG_ABOVE)
def test_line_form_edge_values(n, fused, cuda_device):
    """Edge-value rows through the line form: the rows holding Inf or NaN
    come out non-finite in the kernel and in the plain version alike, and
    no row without such an input does, except that the 3.4e38 row may
    overflow in a butterfly's sum (the pattern stays inside its row); the
    other rows, 1e-20 and 1e18 among them, are within 1e-5 of the plain
    version relative to their own magnitude, and so is the 3.4e38 row
    where it stays finite."""
    from tpufft_torch.kernels import fused_fft
    xr, xi = _fft_edge_rows(*_planes((257, n), cuda_device, seed=n))
    if fused:
        st = _fused_minor(xr, xi)
        out = fused_fft.fft_minor_fused(st, inverse=False, scale=1.0)
        ref = fused_fft.fft_minor_fused_reference(st, inverse=False,
                                                  scale=1.0)
        got = (out[:, :n], out[:, n:])
        ref = (ref[:, :n], ref[:, n:])
    else:
        got = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
        ref = minor_fft.fft_minor_reference(xr, xi, inverse=False, scale=1.0)
    torch.cuda.synchronize()
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[:3].all() and not bad[4:].any()
    assert _complex_row_err((got[0][4:], got[1][4:]),
                            (ref[0][4:], ref[1][4:])) < 1e-5
    if torch.isfinite(got[0][3]).all() and torch.isfinite(got[1][3]).all():
        assert _complex_row_err((got[0][3:4], got[1][3:4]),
                                (ref[0][3:4], ref[1][3:4])) < 1e-5


def test_line_form_misaligned_view(cuda_device):
    """A contiguous view 4 bytes into its storage runs the line form (its
    loads and stores are 4-byte accesses) and matches its plain version."""
    flat = torch.randn(1 + 2 * 33 * 1024, device=cuda_device)
    xr = flat[1:1 + 33 * 1024].view(33, 1024)
    xi = flat[1 + 33 * 1024:].view(33, 1024)
    assert xr.is_contiguous() and xr.data_ptr() % 16 == 4
    got = minor_fft.fft_minor(xr, xi, inverse=True, scale=1.0 / 1024)
    ref = minor_fft.fft_minor_reference(xr, xi, inverse=True,
                                        scale=1.0 / 1024)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("n", [93, 480, 1000, 2160, 4320, 8320, 16384])
def test_mixed_line_form_misaligned_view(n, cuda_device):
    """The mixed-radix and three-factor line forms on a contiguous view 4
    bytes into its storage (rows at any 4-byte offset, as every odd n has
    them): K1 and K9 (n_in = n - 1) against their plain versions."""
    flat = torch.randn(1 + 2 * 33 * n, device=cuda_device)
    xr = flat[1:1 + 33 * n].view(33, n)
    xi = flat[1 + 33 * n:].view(33, n)
    assert xr.is_contiguous() and xr.data_ptr() % 16 == 4
    assert minor_fft.form(n) == "lines"
    got = minor_fft.fft_minor(xr, xi, inverse=True, scale=1.0 / n)
    ref = minor_fft.fft_minor_reference(xr, xi, inverse=True, scale=1.0 / n)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5
    pr = flat[1:1 + 33 * (n - 1)].view(33, n - 1)
    pi = flat[2 + 33 * (n - 1):2 + 66 * (n - 1)].view(33, n - 1)
    got = minor_fft.fft_minor_padded(pr, pi, n=n, inverse=False, scale=1.0)
    ref = minor_fft.fft_minor_padded_reference(pr, pi, n=n, inverse=False,
                                               scale=1.0)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


def test_form_is_what_the_library_launches(cuda_device):
    """The wrappers' forms cannot drift from the launch's: at every length
    of chip_smoke's KERNEL_NS, ``minor_fft.form`` and ``line_geometry``
    equal what the library's ``launch_sized`` test reports
    (``launched_geometry``), and the launch itself agrees: the default
    launch and the stage-form entry (``stages=True``) give the same bits
    exactly where the form is the stage form (n >= 128, where the two
    forms factor n differently, so their sums differ). The strided kernel
    alike at every length of its line form and at stage-form lengths (its
    ``form`` is the library's own answer; here the A/B launch holds it)."""
    import chip_smoke
    for n in chip_smoke.KERNEL_NS:
        got = minor_fft.launched_geometry(n)
        want = minor_fft.form(n)
        assert got["form"] == want, n
        geo = minor_fft.line_geometry(n)
        if geo is not None:
            assert got == {"form": "lines", **geo}, n
        if n < 128:
            continue
        xr, xi = _planes((37, n), cuda_device, seed=n)
        a = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
        b = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0,
                                stages=True)
        torch.cuda.synchronize()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert same == (want == "stages"), n
        assert _err(a, b) < 1e-5
    for n in list(chip_smoke.STRIDED_LINE_NS) + [127, 4096]:
        want = inner_fft.form(n, 241, torch.float32)
        assert want == ("lines" if n in chip_smoke.STRIDED_LINE_NS
                        else "stages"), n
        if n < 128:
            continue
        xr, xi = _planes((2, n, 241), cuda_device, seed=n)
        a = inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0)
        b = inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0,
                                stages=True)
        torch.cuda.synchronize()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert same == (want == "stages"), n
        assert _err(a, b) < 1e-5


def test_three_factor_form_is_what_the_library_launches(cuda_device):
    """Above 4096 the library launches the three-factor form exactly at the
    lengths of ``_LONG_STEP``, with the wrapper's geometry, and the stage
    form at every other length of the envelope: every n of (4096, 16384]
    with a stride of 7, and every listed length."""
    for n in sorted(set(range(4097, 16385, 7)) | set(LONG_NS)):
        want = minor_fft.form(n)
        if want is None:
            continue
        got = minor_fft.launched_geometry(n)
        assert got["form"] == want, n
        assert (want == "lines") == (n in LONG_NS), n
        if want == "lines":
            assert got == {"form": "lines", **minor_fft.line_geometry(n)}, n


def test_kernel_empty_batch(cuda_device):
    xr, xi = _planes((0, 64), cuda_device)
    before = minor_fft.launches
    yr, yi = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
    assert yr.shape == (0, 64) and minor_fft.launches == before


def test_wrapper_checks(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        minor_fft.fft_minor(x.double(), x.double(), inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        minor_fft.fft_minor(x.T, x.T, inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        minor_fft.fft_minor(x, x.cpu(), inverse=False, scale=1.0)
    y = torch.zeros(4, 131, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        minor_fft.fft_minor(y, y, inverse=False, scale=1.0)


def _reset():
    for m in (minor_fft, inner_fft, pair_fft, real_fft, cube_fft,
              mid_pair_fft):
        m.reset_counts()


def _counts():
    """Launches per kernel, and plain-version runs on CUDA tensors."""
    return ({"minor": minor_fft.launches, **inner_fft.launches,
             "pair": pair_fft.launches, "cube": cube_fft.launches,
             "mid_pair": mid_pair_fft.launches},
            minor_fft.reference_cuda_calls + inner_fft.reference_cuda_calls
            + pair_fft.reference_cuda_calls + cube_fft.reference_cuda_calls
            + mid_pair_fft.reference_cuda_calls)


NONE = {"minor": 0, "inner": 0, "inner_nd": 0, "pair": 0, "cube": 0,
        "mid_pair": 0}


# launches of one fftn: (70, 93) axis 0 is strided with one trailing dim
# (K2); (3, 128, 128) runs axis 0 strided with two trailing dims (K3) and
# the trailing pair in one pass (K4); (5, 16, 24) fits the cube kernel
# (K5), (2, 8, 16, 128) axes (1, 2) the mid-pair kernel (K6), as do axes
# (0, 1) of (6, 40, 600) before the minor axis (K1)
@pytest.mark.parametrize("shape,axes,per_call", [
    ((300, 1024), (-1,), {"minor": 1}),
    ((70, 93), (0,), {"inner": 1}),
    ((3, 128, 128), None, {"inner_nd": 1, "pair": 1}),
    ((5, 16, 24), None, {"cube": 1}),
    ((6, 40, 600), (0, 1, 2), {"mid_pair": 1, "minor": 1}),
    ((2, 3, 16, 32, 64), (1, 2, 3, 4), {"inner_nd": 1, "cube": 1}),
    ((2, 8, 16, 128), (1, 2), {"mid_pair": 1}),
    ((2, 40, 64, 37), (1, 2), {"mid_pair": 1}),
])
def test_main_path_runs_the_kernel(shape, axes, per_call, cuda_device):
    xr, xi = _planes(shape, cuda_device)
    x = SplitComplex(xr, xi)
    _reset()
    y = tpufft_torch.fftn(x, axes=axes)
    back = tpufft_torch.ifftn(y, axes=axes)
    torch.cuda.synchronize()
    launches, plain = _counts()
    want = {k: 2 * per_call.get(k, 0) for k in launches}
    assert launches == want
    assert plain == 0
    ref = np.fft.fftn(xr.cpu().numpy().astype(np.float64)
                      + 1j * xi.cpu().numpy(), axes=axes)
    got = y.numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
    assert _err(back, x) < 1e-5


def test_main_path_autograd(cuda_device):
    xr, xi = _planes((8, 1024), cuda_device)
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    minor_fft.reset_counts()
    out = tpufft_torch.fft(SplitComplex(xr, xi))
    (out.re.square().sum() + 2.0 * out.im.square().sum()).backward()
    assert minor_fft.launches == 2 and minor_fft.reference_cuda_calls == 0
    # d/dx of |F x|^2-type losses: the backward is the opposite-sign
    # transform with the same scale, so the CPU run must agree
    cr = xr.detach().cpu().requires_grad_(True)
    ci = xi.detach().cpu().requires_grad_(True)
    ref = tpufft_torch.fft(SplitComplex(cr, ci))
    (ref.re.square().sum() + 2.0 * ref.im.square().sum()).backward()
    assert _err((xr.grad, xi.grad), (cr.grad, ci.grad)) < 1e-5


def test_input_forms_on_the_card(cuda_device):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((40, 960))
         + 1j * rng.standard_normal((40, 960))).astype(np.complex64)
    ref = np.fft.fft(x.astype(np.complex128))
    minor_fft.reset_counts()
    out_t = tpufft_torch.fft(torch.from_numpy(x).to(cuda_device))
    out_np = tpufft_torch.fft(x, device=cuda_device)
    fast = PlanConfig(profile="fast")
    out_bf = tpufft_torch.fft(SplitComplex(*_planes((40, 960), cuda_device)),
                              config=fast)
    torch.cuda.synchronize()
    assert minor_fft.launches == 3 and minor_fft.reference_cuda_calls == 0
    assert out_t.is_cuda and out_t.dtype == torch.complex64
    assert isinstance(out_np, np.ndarray)
    for got in (out_t.cpu().numpy(), out_np):
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5
    assert out_bf.dtype == torch.bfloat16 and out_bf.re.is_cuda


def test_backend_pallas_raises_outside_envelope(cuda_device):
    """131 is prime, outside the kernels' envelope: backend="pallas" serves
    it by Bluestein on the minor-axis kernel; f64 planes, which no kernel
    takes, still raise."""
    xr, xi = _planes((4, 131), cuda_device)
    _reset()
    y = tpufft_torch.fft(SplitComplex(xr, xi),
                         config=PlanConfig(backend="pallas"))
    torch.cuda.synchronize()
    assert _counts() == (dict(NONE, minor=2), 0)
    ref = np.fft.fft(xr.cpu().numpy().astype(np.float64)
                     + 1j * xi.cpu().numpy())
    assert np.max(np.abs(y.numpy() - ref)) / np.max(np.abs(ref)) < 1e-4
    with pytest.raises(ValueError, match="not supported by the fused"):
        tpufft_torch.fft(SplitComplex(xr.double(), xi.double()),
                         config=PlanConfig(backend="pallas"))
    _reset()
    y = tpufft_torch.fft(SplitComplex(xr, xi))  # auto: the Stockham
    assert _counts()[0]["minor"] == 0 and y.re.is_cuda


STRIDED_NS = [8, 93, 127, 128, 960, 1024, 4096, 16384]


def _twiddle(n, m, device, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, (n, m))
    return torch.from_numpy(np.stack([np.cos(th), np.sin(th)], -1)
                            .astype(np.float32)).to(device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", STRIDED_NS)
def test_strided_kernel_matches_plain_version(n, dtype, tol, cuda_device):
    """K2 on (pre, n, L) and K3 on (pre*n, M, L), with and without the
    (n, M) twiddle, on ragged pre and post edges."""
    for pre, M, L in ((11, 37, 1), (2, 12, 25)):
        xr, xi = _planes((pre, n, M * L), cuda_device, dtype, seed=n + M)
        tw = _twiddle(n, M, cuda_device, seed=n)
        for inverse in (False, True):
            for scale in (1.0, 1.0 / n):
                before = dict(inner_fft.launches)
                got = inner_fft.fft_inner(xr, xi, inverse=inverse,
                                          scale=scale)
                ref = inner_fft.fft_inner_reference(xr, xi, inverse=inverse,
                                                    scale=scale)
                assert got[0].dtype == dtype and _err(got, ref) < tol
                v = (pre * n, M, L)
                for twiddle in (None, tw):
                    got = inner_fft.fft_inner_nd(
                        xr.reshape(v), xi.reshape(v), n=n, inverse=inverse,
                        scale=scale, twiddle=twiddle)
                    ref = inner_fft.fft_inner_nd_reference(
                        xr.reshape(v), xi.reshape(v), n=n, inverse=inverse,
                        scale=scale, twiddle=twiddle)
                    torch.cuda.synchronize()
                    assert got[0].shape == v and _err(got, ref) < tol
                assert inner_fft.launches == {
                    "inner": before["inner"] + 1,
                    "inner_nd": before["inner_nd"] + 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_strided_geometry_matches_model(dtype, cuda_device):
    """The form and geometry the launch takes, read from the library
    (``inner_fft.form``, ``line_geometry``), are the model's that the CPU
    tests walk (``test_torch_strided_geometry.py``) at every length of the
    line form and at stage-form lengths, on posts around each C, and give
    the forms of ``FORM_CASES``."""
    bf16 = dtype == torch.bfloat16
    for n in (STRIDED_LINE_NS + [2, 6, 93, 127, 480, 960, 2880, 4100]
              + sorted(CLUSTER)):
        for post in (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 241, 480, 4096,
                     1000000):
            want = model_geometry(n, post, bf16)
            assert inner_fft.line_geometry(n, post, dtype) == want, (n, post)
            assert inner_fft.form(n, post, dtype) == model_form(
                n, post, dtype), (n, post)
    for n, post, dt, expected in FORM_CASES:
        if dt == dtype:
            assert inner_fft.form(n, post, dt) == expected, (n, post)


def _line_posts(n, dtype):
    """post of 1-3 columns (the stage form), 8, C - 1, C, C + 1 around the
    default columns a unit, 241 and 480."""
    c = inner_fft.line_geometry(n, 4096, dtype)["cols"] if (
        inner_fft.form(n, 4096, dtype) == "lines") else 16
    return sorted({1, 2, 3, 8, c - 1, c, c + 1, 241, 480})


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", STRIDED_LINE_NS)
def test_strided_line_form_matches_plain_version(n, dtype, tol, cuda_device):
    """K2 and K3 (with and without the (n, M) twiddle) at every length of
    the line form against their plain versions, on a ragged pre (3) and
    posts that run each form (``inner_fft.form``), both directions, scale
    1 and 1/n: each call launches the kernel once and never its plain
    version."""
    min_cols = 16 if dtype == torch.bfloat16 else 8
    for post in _line_posts(n, dtype):
        want = "lines" if post >= min_cols else "stages"
        assert inner_fft.form(n, post, dtype) == want
        xr, xi = _planes((3, n, post), cuda_device, dtype, seed=n + post)
        M = next(m for m in (5, 3, 2, 1) if post % m == 0)
        tw = _twiddle(n, M, cuda_device, seed=post)
        v = (3 * n, M, post // M)
        for inverse in (False, True):
            for scale in (1.0, 1.0 / n):
                kw = dict(inverse=inverse, scale=scale)
                for twiddle in (None, tw):
                    before = dict(inner_fft.launches)
                    plain = inner_fft.reference_cuda_calls
                    if twiddle is None:
                        got = inner_fft.fft_inner(xr, xi, **kw)
                        key = "inner"
                    else:
                        got = inner_fft.fft_inner_nd(
                            xr.reshape(v), xi.reshape(v), n=n,
                            twiddle=twiddle, **kw)
                        key = "inner_nd"
                    assert inner_fft.launches[key] == before[key] + 1
                    assert inner_fft.reference_cuda_calls == plain
                    if twiddle is None:
                        ref = inner_fft.fft_inner_reference(xr, xi, **kw)
                    else:
                        ref = inner_fft.fft_inner_nd_reference(
                            xr.reshape(v), xi.reshape(v), n=n,
                            twiddle=twiddle, **kw)
                    torch.cuda.synchronize()
                    assert got[0].dtype == dtype
                    assert _err(got, ref) < tol, (post, inverse, scale,
                                                  twiddle is not None)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", STRIDED_LINE_NS)
def test_strided_line_form_fused_matches_plain_version(n, dtype, tol,
                                                       cuda_device):
    """K18 (M = 3) and K19 (M = 1) on fused (3, n, M, 2L) arrays at halves
    L = 2, 8, 64 and 256 (a unit's columns spanning several m, and the re
    and im halves interleaving by L), both directions, scale 1 and 1/n."""
    from tpufft_torch.kernels import fused_fft
    for L in (2, 8, 64, 256):
        for M in (1, 3):
            st = _fused_array((3, n, M, L), cuda_device, dtype, seed=n + L)
            key = "inner" if M > 1 else "inner_m1"
            assert fused_fft.inner_form(n, M, L, dtype) == inner_fft.form(
                n, M * L, dtype)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / n):
                    kw = dict(inverse=inverse, scale=scale)
                    before = fused_fft.launches[key]
                    plain = fused_fft.reference_cuda_calls
                    got = fused_fft.fft_inner_fused(st, **kw)
                    assert fused_fft.launches[key] == before + 1
                    assert fused_fft.reference_cuda_calls == plain
                    ref = fused_fft.fft_inner_fused_reference(st, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype
                    assert _fused_err(got, ref) < tol, (L, M, inverse, scale)


# the cluster form: every length of its lists, f32 and bf16
CLUSTER_CASES = ([(n, torch.float32, 1e-5) for n in CLUSTER_NS]
                 + [(n, torch.bfloat16, 8e-3) for n in sorted(CLUSTER)])
CLUSTER_IDS = [f"{n}-{'f32' if d == torch.float32 else 'bf16'}"
               for n, d, _ in CLUSTER_CASES]


@pytest.mark.parametrize("n,dtype,tol", CLUSTER_CASES, ids=CLUSTER_IDS)
def test_strided_cluster_form_matches_plain_version(n, dtype, tol,
                                                    cuda_device):
    """K2 and K3 (with and without the (n, M) twiddle) at every length of
    the cluster form against their plain versions: pre 2 on a post of 8
    f32 (16 bf16) columns (one unit a slice, half idle in f32), 17 (a
    ragged unit of one column) and 241, and pre 1 on 1000 columns (more
    units than the card holds clusters), both directions, scale 1 and 1/n;
    the launch's geometry is the cluster form's, each call launches the
    kernel once and never its plain version."""
    cols = 16 if dtype == torch.bfloat16 else 8
    for pre, post in ((2, cols), (2, 17), (2, 241), (1, 1000)):
        geo = inner_fft.line_geometry(n, post, dtype)
        assert inner_fft.form(n, post, dtype) == "lines"
        assert geo == model_geometry(n, post, dtype == torch.bfloat16)
        assert geo["q"] >= 2 and geo["cols"] == 16
        xr, xi = _planes((pre, n, post), cuda_device, dtype, seed=n + post)
        M = next(m for m in (5, 3, 2, 1) if post % m == 0)
        tw = _twiddle(n, M, cuda_device, seed=post)
        v = (pre * n, M, post // M)
        for inverse in (False, True):
            for scale in (1.0, 1.0 / n):
                kw = dict(inverse=inverse, scale=scale)
                for twiddle in (None, tw):
                    before = dict(inner_fft.launches)
                    plain = inner_fft.reference_cuda_calls
                    if twiddle is None:
                        got = inner_fft.fft_inner(xr, xi, **kw)
                        key = "inner"
                    else:
                        got = inner_fft.fft_inner_nd(
                            xr.reshape(v), xi.reshape(v), n=n,
                            twiddle=twiddle, **kw)
                        key = "inner_nd"
                    assert inner_fft.launches[key] == before[key] + 1
                    assert inner_fft.reference_cuda_calls == plain
                    if twiddle is None:
                        ref = inner_fft.fft_inner_reference(xr, xi, **kw)
                    else:
                        ref = inner_fft.fft_inner_nd_reference(
                            xr.reshape(v), xi.reshape(v), n=n,
                            twiddle=twiddle, **kw)
                    torch.cuda.synchronize()
                    assert got[0].dtype == dtype
                    assert _err(got, ref) < tol, (pre, post, inverse, scale,
                                                  twiddle is not None)


@pytest.mark.parametrize("n,dtype,tol", CLUSTER_CASES, ids=CLUSTER_IDS)
def test_strided_cluster_form_fused_matches_plain_version(n, dtype, tol,
                                                          cuda_device):
    """K18 (M = 3) and K19 (M = 1) on the cluster form: fused (2, n, M,
    2L) arrays at halves L = 8 and 40 (a unit's columns spanning several
    m, the re and im halves interleaving by L), both directions, scale 1
    and 1/n."""
    from tpufft_torch.kernels import fused_fft
    for L in (8, 40):
        for M in (1, 3):
            if M * L < (16 if dtype == torch.bfloat16 else 8):
                continue
            st = _fused_array((2, n, M, L), cuda_device, dtype, seed=n + L)
            key = "inner" if M > 1 else "inner_m1"
            assert fused_fft.inner_form(n, M, L, dtype) == "lines"
            for inverse in (False, True):
                for scale in (1.0, 1.0 / n):
                    kw = dict(inverse=inverse, scale=scale)
                    before = fused_fft.launches[key]
                    plain = fused_fft.reference_cuda_calls
                    got = fused_fft.fft_inner_fused(st, **kw)
                    assert fused_fft.launches[key] == before + 1
                    assert fused_fft.reference_cuda_calls == plain
                    ref = fused_fft.fft_inner_fused_reference(st, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype
                    assert _fused_err(got, ref) < tol, (L, M, inverse, scale)


def _column_edges(xr, xi):
    """+Inf, -Inf and NaN in the re plane of columns 0-2, 3.4e38 in column
    3, and columns 5 and 6 (both planes) scaled by 1e-20 and 1e18."""
    xr, xi = xr.clone(), xi.clone()
    n = xr.shape[1]
    xr[0, 5 % n, 0] = float("inf")
    xr[1, 7 % n, 1] = float("-inf")
    xr[2, 3 % n, 2] = float("nan")
    xr[0, 9 % n, 3] = 3.4e38
    for x in (xr, xi):
        x[:, :, 5] *= 1e-20
        x[:, :, 6] *= 1e18
    return xr, xi


@pytest.mark.parametrize("fused", [False, True], ids=["K2", "K18"])
@pytest.mark.parametrize("n", [8, 12, 20, 40, 64, 128, 640, 1024, 2048, 25,
                               93, 480, 960, 1080, 2160, 3840, 4096, 8320,
                               12288, 16384])
def test_strided_line_form_edge_values(n, fused, cuda_device):
    """Edge-value columns through the line forms (the cluster form from
    2160), as K1's rows: the lines
    holding Inf or NaN come out non-finite in the kernel and in the plain
    version alike and no line without such an input does, except that the
    3.4e38 line may overflow in a butterfly's sum; the other lines, the
    1e-20 and 1e18 columns among them, are within 1e-5 of the plain
    version relative to their own magnitude, and so is the 3.4e38 line
    where it stays finite."""
    from tpufft_torch.kernels import fused_fft
    post = 40
    xr, xi = _column_edges(*_planes((3, n, post), cuda_device, seed=n))
    assert inner_fft.form(n, post, torch.float32) == "lines"
    if fused:
        st = torch.cat([xr, xi], -1).reshape(3, n, 1, 2 * post).contiguous()
        out = fused_fft.fft_inner_fused(st, inverse=False, scale=1.0)
        ref = fused_fft.fft_inner_fused_reference(st, inverse=False,
                                                  scale=1.0)
        got = (out[..., 0, :post], out[..., 0, post:])
        ref = (ref[..., 0, :post], ref[..., 0, post:])
    else:
        got = inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0)
        ref = inner_fft.fft_inner_reference(xr, xi, inverse=False, scale=1.0)
    torch.cuda.synchronize()
    # one line a (slice, column): rows of (3 * post, n)
    got = tuple(t.transpose(1, 2).reshape(-1, n) for t in got)
    ref = tuple(t.transpose(1, 2).reshape(-1, n) for t in ref)
    lines = {"inf": 0 * post + 0, "-inf": 1 * post + 1, "nan": 2 * post + 2,
             "big": 0 * post + 3}
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[[lines["inf"], lines["-inf"], lines["nan"]]].all()
        others = torch.ones_like(bad)
        others[list(lines.values())] = False
        assert not bad[others].any()
    keep = torch.ones(got[0].shape[0], dtype=torch.bool, device=cuda_device)
    keep[list(lines.values())] = False
    assert _complex_row_err((got[0][keep], got[1][keep]),
                            (ref[0][keep], ref[1][keep])) < 1e-5
    b = lines["big"]
    if torch.isfinite(got[0][b]).all() and torch.isfinite(got[1][b]).all():
        assert _complex_row_err((got[0][b:b + 1], got[1][b:b + 1]),
                                (ref[0][b:b + 1], ref[1][b:b + 1])) < 1e-5


# K3's swapped store (pass 1 of the two-pass split) at each form it runs:
# the line form restaging the unit through the tile (1024, 2048, 960,
# 1920, 480 at L dividing C) and storing straight (256 and 512, whose pass
# 2 takes two rounds; 93, which emits; any L = 3), the cluster form (4096;
# bf16 from 1080) and the stage form (2880, on no list; 16, where the
# lines kernel has no swapped store). (M, L): the minor axis (L = 1),
# L = 2 and 8 (dividing C) and L = 3.
SWAP_NS = [256, 512, 1024, 2048, 960, 1920, 480, 93, 4096, 2880, 16]
SWAP_POSTS = [(37, 1), (20, 2), (5, 8), (9, 3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", SWAP_NS)
def test_swapped_store_matches_plain_version(n, dtype, tol, cuda_device):
    """K3 with the twiddle and ``swap=True`` on (3 n, M, L) planes against
    its plain version (the natural result permuted to (3, M, n, L)), both
    directions, one launch a call, no plain version on the card."""
    for M, L in SWAP_POSTS:
        xr, xi = _planes((3 * n, M, L), cuda_device, dtype, seed=n + M)
        tw = _twiddle(n, M, cuda_device, seed=n + L)
        for inverse, scale in ((False, 1.0), (True, 1.0 / n)):
            kw = dict(n=n, inverse=inverse, scale=scale, twiddle=tw,
                      swap=True)
            _reset()
            got = inner_fft.fft_inner_nd(xr, xi, **kw)
            assert _counts() == (dict(NONE, inner_nd=1), 0)
            ref = inner_fft.fft_inner_nd_reference(xr, xi, **kw)
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and got[0].shape == (3, M, n, L)
            assert _err(got, ref) < tol, (M, L, inverse)


def test_swapped_store_needs_the_twiddle(cuda_device):
    y = torch.zeros(2 * 64, 8, 1, device=cuda_device)
    with pytest.raises(ValueError, match="swap=True needs the twiddle"):
        inner_fft.fft_inner_nd(y, y, n=64, inverse=False, scale=1.0,
                               swap=True)


@pytest.mark.parametrize("swap", [False, True], ids=["natural", "swapped"])
@pytest.mark.parametrize("n", [512, 1024, 4096, 2880])
def test_two_pass_twiddle_edge_values(n, swap, cuda_device):
    """Edge-value columns (``_column_edges``) through K3 with the two-pass
    twiddle, natural and swapped, at the line form (512 stored straight,
    1024 restaged), the cluster form (4096) and the stage form (2880): the
    lines holding Inf or NaN come out non-finite in the kernel and in the
    plain version alike and no other line does, but the 3.4e38 line, which
    may overflow; the rest, the 1e-20 and 1e18 columns among them, are
    within 1e-5 of the plain version relative to their own magnitude, and
    so is the 3.4e38 line where it stays finite."""
    from tpufft_torch import execute
    post = 40
    xr, xi = _column_edges(*_planes((3, n, post), cuda_device, seed=n))
    tw = execute._device_two_pass_twiddle(n, post, False, xr.device)
    v = (3 * n, post, 1)
    kw = dict(n=n, inverse=False, scale=1.0, twiddle=tw, swap=swap)
    got = inner_fft.fft_inner_nd(xr.reshape(v), xi.reshape(v), **kw)
    ref = inner_fft.fft_inner_nd_reference(xr.reshape(v), xi.reshape(v),
                                           **kw)
    torch.cuda.synchronize()

    def lines(t):  # one line a (slice, column): rows of (3 * post, n)
        t = t.reshape(3, post, n) if swap else t.reshape(3, n, post
                                                         ).transpose(1, 2)
        return t.reshape(-1, n)

    got = tuple(lines(t) for t in got)
    ref = tuple(lines(t) for t in ref)
    edge = {"inf": 0 * post + 0, "-inf": 1 * post + 1, "nan": 2 * post + 2,
            "big": 0 * post + 3}
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[[edge["inf"], edge["-inf"], edge["nan"]]].all()
        others = torch.ones_like(bad)
        others[list(edge.values())] = False
        assert not bad[others].any()
    keep = torch.ones(got[0].shape[0], dtype=torch.bool, device=cuda_device)
    keep[list(edge.values())] = False
    assert _complex_row_err((got[0][keep], got[1][keep]),
                            (ref[0][keep], ref[1][keep])) < 1e-5
    b = edge["big"]
    if torch.isfinite(got[0][b]).all() and torch.isfinite(got[1][b]).all():
        assert _complex_row_err((got[0][b:b + 1], got[1][b:b + 1]),
                                (ref[0][b:b + 1], ref[1][b:b + 1])) < 1e-5


@pytest.mark.parametrize("shape", [(3, 32768), (2, 1 << 20)])
def test_two_pass_runs_two_kernels(shape, cuda_device):
    """One two-pass ``fft`` runs exactly two CUDA kernels, K3 with the
    swapped store and K2, and no copy (torch.profiler, after a warm call
    that uploads the twiddle table)."""
    from torch.profiler import ProfilerActivity, profile
    xr, xi = _planes(shape, cuda_device)
    x = SplitComplex(xr, xi)
    tpufft_torch.fft(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tpufft_torch.fft(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    assert all("strided" in name for name in names), names


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1,n2", [(8, 93), (64, 64), (128, 128), (160, 48),
                                   (2, 2), (127, 3)])
def test_pair_kernel_matches_plain_version(n1, n2, dtype, tol, cuda_device):
    xr, xi = _planes((13, n1, n2), cuda_device, dtype, seed=n1 * n2)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / (n1 * n2)):
            before = pair_fft.launches
            got = pair_fft.fft_pair(xr, xi, inverse=inverse, scale=scale)
            ref = pair_fft.fft_pair_reference(xr, xi, inverse=inverse,
                                              scale=scale)
            torch.cuda.synchronize()
            assert pair_fft.launches == before + 1
            assert got[0].dtype == dtype and _err(got, ref) < tol


# the pair core's forms at the shapes of the main paths and around them:
# (pre, n1, n2) with 16384 elements a slice (one block an SM), n1 = 16 and
# 32 (multiples of 16 on the column pass), a 64 x 128 slice zero-padded
# from 93 (the fft2(s=) path), packed small slices (several a block) and
# an odd first radix on the row pass; the last four hold more runs of
# slices than the persistent grid has blocks, so each block loops
PAIR_CORE_CASES = [("pair", (37, 128, 128), None), ("pair", (9, 16, 128), None),
                   ("pair", (11, 32, 64), None), ("pair", (301, 8, 93), None),
                   ("pair", (5, 3, 2048), None), ("pair", (7, 64, 75), None),
                   ("padded", (23, 64, 93), 128), ("padded", (41, 32, 33), 64),
                   ("fused", (37, 128, 128), None), ("fused", (301, 8, 93), None),
                   ("fused", (9, 16, 128), None),
                   ("pair", (401, 128, 128), None),
                   ("fused", (301, 128, 128), None),
                   ("padded", (1999, 64, 93), 128),
                   ("pair", (20011, 8, 93), None)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form,shape,n2", PAIR_CORE_CASES)
def test_pair_core_matches_plain_versions(form, shape, n2, dtype, tol,
                                          cuda_device):
    """K4 (split planes, and with n2_in) and K17 (fused storage) on the
    register-and-team pass core against their plain versions."""
    from tpufft_torch.kernels import fused_fft
    for inverse in (False, True):
        kw = dict(inverse=inverse, scale=0.5 if inverse else 1.0)
        if form == "fused":
            st = _fused_array(shape, cuda_device, dtype, seed=sum(shape))
            got = fused_fft.fft_pair_fused(st, **kw)
            ref = fused_fft.fft_pair_fused_reference(st, **kw)
            torch.cuda.synchronize()
            assert got.dtype == dtype and _fused_err(got, ref) < tol
            continue
        xr, xi = _planes(shape, cuda_device, dtype, seed=sum(shape))
        if form == "padded":
            got = pair_fft.fft_pair_padded(xr, xi, n2=n2, **kw)
            ref = pair_fft.fft_pair_padded_reference(xr, xi, n2=n2, **kw)
        else:
            got = pair_fft.fft_pair(xr, xi, **kw)
            ref = pair_fft.fft_pair_reference(xr, xi, **kw)
        torch.cuda.synchronize()
        assert got[0].dtype == dtype and _err(got, ref) < tol


def test_new_wrappers_raise_outside_the_envelope(cuda_device):
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    _reset()
    y = torch.zeros(2, 131, 40, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        inner_fft.fft_inner(y, y, inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="envelope"):
        inner_fft.fft_inner_nd(y.reshape(262, 4, 10), y.reshape(262, 4, 10),
                               n=131, inverse=False, scale=1.0)
    z = torch.zeros(2, 128, 256, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        pair_fft.fft_pair(z, z, inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pair_fft.fft_pair(z[:, :64].double(), z[:, :64].double(),
                          inverse=False, scale=1.0)
    assert _counts() == (NONE, 0)


@pytest.mark.parametrize("n,kernels", [
    (32768, {"inner_nd": 1, "inner": 1}),      # two-pass 1024 * 32
    (49152, {"inner_nd": 1, "inner": 1}),      # two-pass 1024 * 48
    (4099, {"minor": 2}),                      # Bluestein, m = 8320
])
def test_long_and_prime_paths(n, kernels, cuda_device):
    xr, xi = _planes((3, n), cuda_device)
    _reset()
    y = tpufft_torch.fft(SplitComplex(xr, xi))
    back = tpufft_torch.ifft(y)
    torch.cuda.synchronize()
    launches, plain = _counts()
    assert launches == {k: 2 * kernels.get(k, 0) for k in launches}
    assert plain == 0
    ref = np.fft.fft(xr.cpu().numpy().astype(np.float64)
                     + 1j * xi.cpu().numpy())
    assert np.max(np.abs(y.numpy() - ref)) / np.max(np.abs(ref)) < 1e-4
    assert _err(back, (xr, xi)) < 1e-4


def test_pair_autograd_on_the_card(cuda_device):
    xr, xi = _planes((3, 64, 48), cuda_device)
    xr.requires_grad_(True)
    xi.requires_grad_(True)
    _reset()
    out = tpufft_torch.fft2(SplitComplex(xr, xi), norm="ortho")
    (out.re.square().sum() + 2.0 * out.im.square().sum()).backward()
    assert _counts() == (dict(NONE, pair=2), 0)
    cr = xr.detach().cpu().requires_grad_(True)
    ci = xi.detach().cpu().requires_grad_(True)
    ref = tpufft_torch.fft2(SplitComplex(cr, ci), norm="ortho")
    (ref.re.square().sum() + 2.0 * ref.im.square().sum()).backward()
    assert _err((xr.grad, xi.grad), (cr.grad, ci.grad)) < 1e-5


# ----------------------------------------------------------------------------
# The real transforms (K7, K8) and the fused zero-pad (K9, K4 with n2_in)
# ----------------------------------------------------------------------------

def _all_counts():
    """Launches of every kernel, padded ones apart, and plain-version runs
    on CUDA tensors."""
    launches, plain = _counts()
    launches.update(real_fft.launches, minor_padded=minor_fft.padded_launches,
                    pair_padded=pair_fft.padded_launches)
    return launches, plain + real_fft.reference_cuda_calls


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 3, 8, 93, 127, 128, 256, 1024, 4096,
                               16383, 32768])
def test_real_kernels_match_plain_versions(n, dtype, tol, cuda_device):
    """K7 and K8 on a ragged batch of 257 rows, both scales; the planes
    into K8 have nonzero imaginary parts at DC and Nyquist."""
    x, _ = _planes((257, n), cuda_device, dtype, seed=n)
    hr, hi = _planes((257, n // 2 + 1), cuda_device, dtype, seed=n + 1)
    for scale in (1.0, 1.0 / n):
        before = dict(real_fft.launches)
        got = real_fft.rfft_minor(x, scale=scale)
        ref = real_fft.rfft_minor_reference(x, scale=scale)
        assert got[0].dtype == dtype and got[0].shape == (257, n // 2 + 1)
        assert _err(got, ref) < tol
        got = real_fft.irfft_minor(hr, hi, n=n, scale=scale)
        ref = real_fft.irfft_minor_reference(hr, hi, n=n, scale=scale)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (257, n)
        assert _err((got, torch.zeros_like(got)),
                    (ref, torch.zeros_like(ref))) < tol
        assert real_fft.launches == {"r2c": before["r2c"] + 1,
                                     "c2r": before["c2r"] + 1}


def test_real_kernel_misaligned_input(cuda_device):
    """An even-n row read as float2 pairs from a pointer that is not 8-byte
    aligned: the wrapper copies it, the result is unchanged."""
    flat = torch.randn(4 * 128 + 1, device=cuda_device)
    x = flat[1:].view(4, 128)
    assert x.data_ptr() % 8 != 0
    got = real_fft.rfft_minor(x, scale=1.0)
    ref = real_fft.rfft_minor_reference(x, scale=1.0)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


REAL_LINE_NS = [2 ** k for k in range(8, 14)]   # K7's line form: 256 .. 8192


def _past_one_grid(n):
    """A batch of K7's line form at n that spans twice as many row groups
    as its grid can have blocks (the card's SMs times five 128-thread or
    two 256-thread blocks), plus a ragged group."""
    geo = real_fft.line_geometry(n)
    per_group = geo["threads"] // (32 * geo["team_warps"]) * geo["rows"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * (5 if geo["threads"] == 128 else 2)
    return 2 * blocks * per_group + 3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", LINE_BATCHES + ["past_grid"])
@pytest.mark.parametrize("n", REAL_LINE_NS)
def test_real_line_form_matches_plain_version(n, batch, dtype, tol,
                                              cuda_device):
    """K7's line form against its plain version on ragged batches and on
    one that makes each block loop over several row groups, scale 1 and
    1/n: one launch a call, and no run of a plain version inside it."""
    assert real_fft.form(n) == "lines"
    if batch == "past_grid":
        batch = _past_one_grid(n)
    x, _ = _planes((batch, n), cuda_device, dtype, seed=n + batch)
    for scale in (1.0, 1.0 / n):
        before = real_fft.launches["r2c"]
        plain = real_fft.reference_cuda_calls
        got = real_fft.rfft_minor(x, scale=scale)
        assert real_fft.launches["r2c"] == before + 1
        assert real_fft.reference_cuda_calls == plain
        ref = real_fft.rfft_minor_reference(x, scale=scale)
        torch.cuda.synchronize()
        assert got[0].dtype == dtype and got[0].shape == (batch, n // 2 + 1)
        assert _err(got, ref) < tol


@pytest.mark.parametrize("n", REAL_LINE_NS)
def test_real_line_form_edge_values(n, cuda_device):
    """Edge-value rows through K7's line form, held as
    ``test_line_form_edge_values`` holds K1's: the rows holding Inf or NaN
    come out non-finite in the kernel and in the plain version alike, no
    row without such an input does but the 3.4e38 row (whose packed pair
    may overflow in the untangle's sum), and the other rows, 1e-20 and
    1e18 among them, are within 1e-5 of the plain version relative to
    their own magnitude, as is the 3.4e38 row where it stays finite."""
    x, _ = _planes((257, n), cuda_device, seed=n)
    x, _ = _fft_edge_rows(x, torch.zeros_like(x))
    got = real_fft.rfft_minor(x, scale=1.0)
    ref = real_fft.rfft_minor_reference(x, scale=1.0)
    torch.cuda.synchronize()
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[:3].all() and not bad[4:].any()
    assert _complex_row_err((got[0][4:], got[1][4:]),
                            (ref[0][4:], ref[1][4:])) < 1e-5
    if torch.isfinite(got[0][3]).all() and torch.isfinite(got[1][3]).all():
        assert _complex_row_err((got[0][3:4], got[1][3:4]),
                                (ref[0][3:4], ref[1][3:4])) < 1e-5


def test_real_line_form_misaligned_views(cuda_device):
    """K7's line form on views that do not start on a 16-byte boundary: 8
    bytes in, it reads the view in place; 4 bytes in, the wrapper copies
    it first (its pair loads need 8 bytes). Both match the plain version."""
    flat = torch.randn(2 + 33 * 1024, device=cuda_device)
    for off in (2, 1):
        x = flat[off:off + 33 * 1024].view(33, 1024)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4 * off
        before = real_fft.launches["r2c"]
        got = real_fft.rfft_minor(x, scale=1.0 / 1024)
        assert real_fft.launches["r2c"] == before + 1
        ref = real_fft.rfft_minor_reference(x, scale=1.0 / 1024)
        torch.cuda.synchronize()
        assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", LINE_BATCHES + ["past_grid"])
@pytest.mark.parametrize("n", REAL_LINE_NS)
def test_irfft_line_form_matches_plain_version(n, batch, dtype, tol,
                                               cuda_device):
    """K8's line form against its plain version on ragged batches and on
    one that makes each block loop over several row groups, scale 1 and
    1/n, planes with nonzero imaginary parts at DC and Nyquist: one launch
    a call, no run of a plain version inside it; and the stage form, kept
    in the library, gives the same result."""
    assert real_fft.form(n) == "lines"
    if batch == "past_grid":
        batch = _past_one_grid(n)
    hr, hi = _planes((batch, n // 2 + 1), cuda_device, dtype, seed=n + batch)
    zero = torch.zeros(batch, n, device=cuda_device)
    for scale in (1.0, 1.0 / n):
        before = real_fft.launches["c2r"]
        plain = real_fft.reference_cuda_calls
        got = real_fft.irfft_minor(hr, hi, n=n, scale=scale)
        assert real_fft.launches["c2r"] == before + 1
        assert real_fft.reference_cuda_calls == plain
        ref = real_fft.irfft_minor_reference(hr, hi, n=n, scale=scale)
        stages = real_fft.irfft_minor(hr, hi, n=n, scale=scale, stages=True)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (batch, n)
        assert _err((got, zero), (ref, zero)) < tol
        assert _err((got, zero), (stages, zero)) < tol


@pytest.mark.parametrize("n", REAL_LINE_NS)
def test_irfft_line_form_edge_values(n, cuda_device):
    """Edge-value rows through K8's line form (``_fft_edge_rows`` on the
    half-spectrum planes): the rows holding Inf or NaN come out non-finite
    in the kernel and in the plain version alike, no row without such an
    input does but the 3.4e38 row (which may overflow in the tangle's
    sums), and the other rows, 1e-20 and 1e18 among them, are within 1e-5
    of the plain version relative to their own magnitude, as is the
    3.4e38 row where it stays finite."""
    hr, hi = _fft_edge_rows(*_planes((257, n // 2 + 1), cuda_device, seed=n))
    got = real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n)
    ref = real_fft.irfft_minor_reference(hr, hi, n=n, scale=1.0 / n)
    torch.cuda.synchronize()
    for out in (got, ref):
        bad = (~torch.isfinite(out)).any(1)
        assert bad[:3].all() and not bad[4:].any()
    zero = torch.zeros_like(got)
    assert _complex_row_err((got[4:], zero[4:]), (ref[4:], zero[4:])) < 1e-5
    if torch.isfinite(got[3]).all():
        assert _complex_row_err((got[3:4], zero[3:4]),
                                (ref[3:4], zero[3:4])) < 1e-5


def test_irfft_line_form_views(cuda_device):
    """K8's line form reads each bin as a 4-byte value: contiguous planes
    that start 4 and 8 bytes past a 16-byte boundary run in place and
    match the plain version; a strided view of the planes (rows of a wider
    array) is refused, not copied."""
    n, m1 = 1024, 513
    flat = torch.randn(2, 2 + 33 * m1, device=cuda_device)
    for off in (1, 2):
        hr, hi = (f[off:off + 33 * m1].view(33, m1) for f in flat)
        assert hr.is_contiguous() and hr.data_ptr() % 16 == 4 * off
        before = real_fft.launches["c2r"]
        got = real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n)
        assert real_fft.launches["c2r"] == before + 1
        ref = real_fft.irfft_minor_reference(hr, hi, n=n, scale=1.0 / n)
        torch.cuda.synchronize()
        zero = torch.zeros_like(got)
        assert _err((got, zero), (ref, zero)) < 1e-5
    wide = torch.randn(33, m1 + 7, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        real_fft.irfft_minor(wide[:, :m1], wide[:, 7:], n=n, scale=1.0)


# K7's and K8's mixed-radix line form: the 29 even n whose half is on K1's
# family lists (real_fft._REAL_STEP) and the odd n = 93
MIXED_REAL_NS = (sorted(2 * m for m in real_fft._REAL_STEP)
                 + list(real_fft._ODD_LINES))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", LINE_BATCHES + ["past_grid"])
@pytest.mark.parametrize("n", MIXED_REAL_NS)
def test_mixed_real_line_form_matches_plain_version(n, batch, dtype, tol,
                                                    cuda_device):
    """K7 and K8 on their mixed-radix line form against their plain
    versions on ragged batches and on one that makes each block loop over
    several row groups, scale 1 and 1/n, K8's planes with nonzero
    imaginary parts at DC and Nyquist: one launch a call, no run of a plain
    version inside it; the stage form (``stages=True``) agrees."""
    assert real_fft.form(n) == "lines"
    if batch == "past_grid":
        batch = _past_one_grid(n)
    x, _ = _planes((batch, n), cuda_device, dtype, seed=n + batch)
    hr, hi = _planes((batch, n // 2 + 1), cuda_device, dtype,
                     seed=n + batch + 1)
    zero = torch.zeros(batch, n, device=cuda_device)
    for scale in (1.0, 1.0 / n):
        before = dict(real_fft.launches)
        plain = real_fft.reference_cuda_calls
        got = real_fft.rfft_minor(x, scale=scale)
        back = real_fft.irfft_minor(hr, hi, n=n, scale=scale)
        assert real_fft.launches == {"r2c": before["r2c"] + 1,
                                     "c2r": before["c2r"] + 1}
        assert real_fft.reference_cuda_calls == plain
        ref = real_fft.rfft_minor_reference(x, scale=scale)
        ref_back = real_fft.irfft_minor_reference(hr, hi, n=n, scale=scale)
        stages = real_fft.rfft_minor(x, scale=scale, stages=True)
        stages_back = real_fft.irfft_minor(hr, hi, n=n, scale=scale,
                                           stages=True)
        torch.cuda.synchronize()
        assert got[0].dtype == dtype and got[0].shape == (batch, n // 2 + 1)
        assert back.dtype == dtype and back.shape == (batch, n)
        assert _err(got, ref) < tol and _err(got, stages) < tol
        assert _err((back, zero), (ref_back, zero)) < tol
        assert _err((back, zero), (stages_back, zero)) < tol


@pytest.mark.parametrize("n", sorted(set(MIXED_REAL_NS + REAL_LINE_NS
                                         + [1000, 127, 8640, 128, 95])))
def test_real_line_geometry_matches_the_library(n, cuda_device):
    """``real_fft.line_geometry`` (the wrapper's table) is the geometry the
    library launches (``tpufft_real_line_geometry``), and the stage form
    is reported where ``real_fft.form`` says so."""
    got = real_fft.launched_geometry(n)
    if real_fft.form(n) == "lines":
        assert got == {"form": "lines", **real_fft.line_geometry(n)}
    else:
        assert got == {"form": "stages"}


@pytest.mark.parametrize("n", MIXED_REAL_NS)
def test_mixed_real_line_form_edge_values(n, cuda_device):
    """Edge-value rows through K7's and K8's mixed-radix line form, held as
    ``test_real_line_form_edge_values`` and
    ``test_irfft_line_form_edge_values`` hold the power-of-two halves: rows
    with Inf or NaN come out non-finite in the kernel and the plain version
    alike, no other row does but the 3.4e38 row, and the other rows (1e-20
    and 1e18 among them) are within 1e-5 of the plain version relative to
    their own magnitude, as is the 3.4e38 row where it stays finite."""
    x, _ = _planes((257, n), cuda_device, seed=n)
    x, _ = _fft_edge_rows(x, torch.zeros_like(x))
    got = real_fft.rfft_minor(x, scale=1.0)
    ref = real_fft.rfft_minor_reference(x, scale=1.0)
    hr, hi = _fft_edge_rows(*_planes((257, n // 2 + 1), cuda_device,
                                     seed=n + 1))
    back = real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n)
    ref_back = real_fft.irfft_minor_reference(hr, hi, n=n, scale=1.0 / n)
    torch.cuda.synchronize()
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[:3].all() and not bad[4:].any()
    assert _complex_row_err((got[0][4:], got[1][4:]),
                            (ref[0][4:], ref[1][4:])) < 1e-5
    if torch.isfinite(got[0][3]).all() and torch.isfinite(got[1][3]).all():
        assert _complex_row_err((got[0][3:4], got[1][3:4]),
                                (ref[0][3:4], ref[1][3:4])) < 1e-5
    for out in (back, ref_back):
        bad = (~torch.isfinite(out)).any(1)
        assert bad[:3].all() and not bad[4:].any()
    zero = torch.zeros_like(back)
    assert _complex_row_err((back[4:], zero[4:]),
                            (ref_back[4:], zero[4:])) < 1e-5
    if torch.isfinite(back[3]).all():
        assert _complex_row_err((back[3:4], zero[3:4]),
                                (ref_back[3:4], zero[3:4])) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
def test_odd_real_line_form_misaligned_views(dtype, tol, cuda_device):
    """K7 and K8 at odd n = 93 read and write 4-byte (bf16: 2-byte) values:
    contiguous views that start 1, 2 and 3 elements past a 16-byte
    boundary run in place (no copy) on the line form and match the plain
    versions."""
    n, m1, rows = 93, 47, 131
    assert real_fft.form(n) == "lines"
    flat = torch.randn(3, 3 + rows * n, device=cuda_device).to(dtype)
    for off in (1, 2, 3):
        x = flat[0, off:off + rows * n].view(rows, n)
        hr = flat[1, off:off + rows * m1].view(rows, m1)
        hi = flat[2, off:off + rows * m1].view(rows, m1)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        before = dict(real_fft.launches)
        got = real_fft.rfft_minor(x, scale=1.0 / n)
        back = real_fft.irfft_minor(hr, hi, n=n, scale=1.0)
        assert real_fft.launches == {"r2c": before["r2c"] + 1,
                                     "c2r": before["c2r"] + 1}
        ref = real_fft.rfft_minor_reference(x, scale=1.0 / n)
        ref_back = real_fft.irfft_minor_reference(hr, hi, n=n, scale=1.0)
        torch.cuda.synchronize()
        zero = torch.zeros_like(back)
        assert _err(got, ref) < tol
        assert _err((back, zero), (ref_back, zero)) < tol


def _pad_ins(n):
    """K9's input lengths at padded length n: 1, n/2, n/2 + 1 and n - 1,
    those below n."""
    return sorted({1, n // 2, n // 2 + 1, n - 1} & set(range(1, n)))


# K9 at every line-form length (n_in = 1, n/2, n/2 + 1, n - 1; the
# three-factor lengths among them), and on the stage form above 4096
PADS = ([(n_in, n) for n in LINE_NS for n_in in _pad_ins(n)]
        + [(93, 128), (1000, 1024), (2047, 4096), (300, 384), (5000, 8192),
           (8191, 16384), (3000, 4100), (4099, 8320)])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 127, 257])
@pytest.mark.parametrize("n_in,n", PADS)
def test_padded_kernel_matches_plain_version(n_in, n, batch, dtype, tol,
                                             cuda_device):
    """K9 against its plain version on ragged batches, both directions,
    scale 1 and 1/n: the line form at its lengths (power-of-two n up to
    4096, the mixed-radix and three-factor lengths), the stage form
    elsewhere (``form``), one launch a call."""
    assert minor_fft.form(n, n_in) == (
        "lines" if n in LINE_NS else "stages")
    xr, xi = _planes((batch, n_in), cuda_device, dtype, seed=n_in + batch)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / n):
            before = minor_fft.padded_launches
            kw = dict(n=n, inverse=inverse, scale=scale)
            got = minor_fft.fft_minor_padded(xr, xi, **kw)
            ref = minor_fft.fft_minor_padded_reference(xr, xi, **kw)
            torch.cuda.synchronize()
            assert minor_fft.padded_launches == before + 1
            assert got[0].dtype == dtype and got[0].shape == (batch, n)
            assert _err(got, ref) < tol


@pytest.mark.parametrize("n_in,n", [(1, 2), (33, 64), (93, 128),
                                    (1000, 1024), (1024, 2048), (2047, 4096),
                                    (300, 384), (5000, 8192), (4099, 8320)])
def test_padded_kernel_edge_values(n_in, n, cuda_device):
    """Edge-value rows through K9 (``_fft_edge_rows`` on the (257, n_in)
    planes), held as ``test_line_form_edge_values`` holds K1: the rows
    holding Inf or NaN come out non-finite in the kernel and in the plain
    version alike, no row without such an input does but the 3.4e38 row
    (which may overflow in a butterfly's sum), and the other rows, 1e-20
    and 1e18 among them, are within 1e-5 of the plain version relative to
    their own magnitude, as is the 3.4e38 row where it stays finite."""
    xr, xi = _fft_edge_rows(*_planes((257, n_in), cuda_device, seed=n))
    got = minor_fft.fft_minor_padded(xr, xi, n=n, inverse=False, scale=1.0)
    ref = minor_fft.fft_minor_padded_reference(xr, xi, n=n, inverse=False,
                                               scale=1.0)
    torch.cuda.synchronize()
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[:3].all() and not bad[4:].any()
    fin = [torch.isfinite(o[0]) & torch.isfinite(o[1]) for o in (got, ref)]
    for rows in (slice(0, 3), slice(4, None)):   # where Inf and NaN fall
        assert torch.equal(fin[0][rows], fin[1][rows])
    assert _complex_row_err((got[0][4:], got[1][4:]),
                            (ref[0][4:], ref[1][4:])) < 1e-5
    if torch.isfinite(got[0][3]).all() and torch.isfinite(got[1][3]).all():
        assert _complex_row_err((got[0][3:4], got[1][3:4]),
                                (ref[0][3:4], ref[1][3:4])) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_in,n", [(1, 2), (33, 64), (93, 128),
                                    (1024, 2048), (2047, 4096), (300, 384)])
def test_padded_stage_form_matches_line_form(n_in, n, dtype, tol,
                                             cuda_device):
    """K9's stage form, kept in the library (``stages=True``), gives the
    result of the form ``form`` picks, on a ragged batch, both directions."""
    xr, xi = _planes((257, n_in), cuda_device, dtype, seed=n_in)
    for inverse in (False, True):
        kw = dict(n=n, inverse=inverse, scale=1.0 / n if inverse else 1.0)
        before = minor_fft.padded_launches
        got = minor_fft.fft_minor_padded(xr, xi, **kw)
        stages = minor_fft.fft_minor_padded(xr, xi, stages=True, **kw)
        torch.cuda.synchronize()
        assert minor_fft.padded_launches == before + 2
        assert _err(got, stages) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1,n2_in,n2", [(64, 93, 128), (120, 100, 128),
                                         (8, 1, 16), (2, 3, 4)])
def test_pair_padded_kernel_matches_plain_version(n1, n2_in, n2, dtype, tol,
                                                  cuda_device):
    xr, xi = _planes((13, n1, n2_in), cuda_device, dtype, seed=n1 + n2_in)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / (n1 * n2)):
            before = pair_fft.padded_launches
            kw = dict(n2=n2, inverse=inverse, scale=scale)
            got = pair_fft.fft_pair_padded(xr, xi, **kw)
            ref = pair_fft.fft_pair_padded_reference(xr, xi, **kw)
            torch.cuda.synchronize()
            assert pair_fft.padded_launches == before + 1
            assert got[0].dtype == dtype and got[0].shape == (13, n1, n2)
            assert _err(got, ref) < tol


def test_real_and_padded_wrappers_raise_outside_the_envelope(cuda_device):
    _reset()
    y = torch.zeros(2, 131, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        real_fft.rfft_minor(y, scale=1.0)
    h = torch.zeros(2, 66, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        real_fft.irfft_minor(h, h, n=131, scale=1.0)
    with pytest.raises(ValueError, match="bins"):
        real_fft.irfft_minor(h, h, n=128, scale=1.0)
    with pytest.raises(ValueError, match="envelope"):
        minor_fft.fft_minor_padded(y, y, n=262, inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="must be in"):
        minor_fft.fft_minor_padded(y, y, n=128, inverse=False, scale=1.0)
    z = torch.zeros(2, 64, 93, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        pair_fft.fft_pair_padded(z, z, n2=512, inverse=False, scale=1.0)
    launches, plain = _all_counts()
    assert not any(launches.values()) and plain == 0


# one call of each: the kernels it launches
@pytest.mark.parametrize("name,shape,call,per_call", [
    ("rfft", (300, 1024), lambda x: tpufft_torch.rfft(x), {"r2c": 1}),
    ("rfft odd", (300, 93), lambda x: tpufft_torch.rfft(x), {"r2c": 1}),
    ("rfft axis 0", (1024, 30), lambda x: tpufft_torch.rfft(x, axis=0),
     {"r2c": 1}),
    ("rfft2", (5, 40, 48), lambda x: tpufft_torch.rfft2(x),
     {"r2c": 1, "inner": 1}),
    ("rfft2 even pair", (5, 64, 130), lambda x: tpufft_torch.rfftn(
        x, axes=(0, 1, 2)), {"r2c": 1, "inner": 1, "inner_nd": 1}),
    ("irfft", (300, 513), lambda x: tpufft_torch.irfft(x), {"c2r": 1}),
    ("irfft odd", (300, 47), lambda x: tpufft_torch.irfft(x, n=93),
     {"c2r": 1}),
    ("irfft2", (5, 40, 25), lambda x: tpufft_torch.irfft2(x),
     {"inner": 1, "c2r": 1}),
    ("fft fast-aligned", (70, 93),
     lambda x: tpufft_torch.fft(x, n="fast-aligned"), {"minor_padded": 1}),
    ("fft2 pair pad", (5, 64, 93),
     lambda x: tpufft_torch.fft2(x, s=(64, 128)), {"pair_padded": 1}),
    ("fftn pad then strided", (16, 5, 93),
     lambda x: tpufft_torch.fftn(x, s=(16, 128), axes=(0, 2)),
     {"minor_padded": 1, "inner_nd": 1}),
])
def test_real_and_padded_paths_run_their_kernels(name, shape, call, per_call,
                                                 cuda_device):
    real_in = name.startswith("rfft")
    xr, xi = _planes(shape, cuda_device)
    x = xr if real_in else SplitComplex(xr, xi)
    _reset()
    y = call(x)
    torch.cuda.synchronize()
    launches, plain = _all_counts()
    assert launches == {k: per_call.get(k, 0) for k in launches}, name
    assert plain == 0
    # the same call on the CPU runs the plain versions
    cpu = call(xr.cpu() if real_in else SplitComplex(xr.cpu(), xi.cpu()))
    got = y if isinstance(y, SplitComplex) else (
        (y.real, y.imag) if y.is_complex() else (y, torch.zeros_like(y)))
    ref = cpu if isinstance(cpu, SplitComplex) else (
        (cpu.real, cpu.imag) if cpu.is_complex() else
        (cpu, torch.zeros_like(cpu)))
    assert _err(got, ref) < 1e-5


def test_real_autograd_on_the_card(cuda_device):
    """rfft's backward runs K9 (the gradient zero-padded to n bins); irfft's
    runs K7; the gradients agree with the CPU's."""
    x, _ = _planes((8, 1024), cuda_device)
    x.requires_grad_(True)
    _reset()
    out = tpufft_torch.rfft(x, norm="ortho")
    (out.real.square().sum() + 2.0 * out.imag.square().sum()).backward()
    launches, plain = _all_counts()
    assert launches["r2c"] == 1 and launches["minor_padded"] == 1
    assert plain == 0
    xc = x.detach().cpu().requires_grad_(True)
    ref = tpufft_torch.rfft(xc, norm="ortho")
    (ref.real.square().sum() + 2.0 * ref.imag.square().sum()).backward()
    assert _err((x.grad, torch.zeros_like(x.grad)),
                (xc.grad, torch.zeros_like(xc.grad))) < 1e-5
    hr, hi = _planes((8, 513), cuda_device)
    hr.requires_grad_(True)
    hi.requires_grad_(True)
    _reset()
    y = tpufft_torch.irfft(SplitComplex(hr, hi), n=1024)
    y.re.square().sum().backward()
    launches, plain = _all_counts()
    assert launches["c2r"] == 1 and launches["r2c"] == 1 and plain == 0
    cr = hr.detach().cpu().requires_grad_(True)
    ci = hi.detach().cpu().requires_grad_(True)
    tpufft_torch.irfft(SplitComplex(cr, ci), n=1024).re.square().sum() \
        .backward()
    assert _err((hr.grad, hi.grad), (cr.grad, ci.grad)) < 1e-5


# ----------------------------------------------------------------------------
# The dense-matrix kernels (K10, K11, K12) and the paths above them
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m_in,m_out", [(2, 2), (7, 7), (64, 64), (93, 93),
                                        (128, 128), (512, 512), (93, 128),
                                        (128, 93), (1000, 1000)])
def test_dense_kernels_match_plain_versions(m_in, m_out, cuda_device):
    """K10 and K11 on a ragged batch of 257 rows, squares and rectangles;
    the plain versions are f32 matmuls (TF32 off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    xr, xi = _planes((257, m_in), cuda_device, seed=m_in)
    wr, wi = _planes((m_in, m_out), cuda_device, seed=m_out + 1)
    dense_mm.reset_counts()
    got = dense_mm.dense_mm_complex(xr, xi, wr, wi)
    real = dense_mm.dense_mm_real(xr, wr)
    assert dense_mm.launches == {"complex": 1, "real": 1, "r2r": 0}
    ref = dense_mm.dense_mm_complex_reference(xr, xi, wr, wi)
    ref_real = dense_mm.dense_mm_real_reference(xr, wr)
    torch.cuda.synchronize()
    assert got[0].shape == (257, m_out) and got[0].dtype == torch.float32
    assert _err(got, ref) < 1e-5
    assert _err((real, torch.zeros_like(real)),
                (ref_real, torch.zeros_like(ref_real))) < 1e-5


@pytest.mark.parametrize("n", [2, 3, 93, 128, 1000, 1024])
def test_r2r_kernel_matches_plain_version(n, cuda_device):
    """K12 with the table of every (kind, type) and norm."""
    from tpufft_torch import realtrans

    x, _ = _planes((257, n), cuda_device, seed=n)
    for kind in ("dct", "dst"):
        for type_ in (1, 2, 3, 4):
            for norm in ("backward", "ortho", "forward"):
                w = realtrans._table((kind, type_, n, norm, False),
                                     cuda_device)
                got = dense_mm.r2r_minor(x, w)
                ref = dense_mm.r2r_minor_reference(x, w)
                torch.cuda.synchronize()
                assert _err((got, torch.zeros_like(got)),
                            (ref, torch.zeros_like(ref))) < 1e-5


def _edge_rows(x):
    """+-Inf, NaN, 3.4e38 and FLT_MAX at one place each, and rows scaled
    by 1e-20 and 1e18."""
    x = x.clone()
    n = x.shape[1]
    x[0, 5 % n] = float("inf")
    x[1, 7 % n] = float("-inf")
    x[2, 3 % n] = float("nan")
    x[3, 9 % n] = 3.4e38
    x[4, 11 % n] = torch.finfo(torch.float32).max
    x[5] *= 1e-20
    x[6] *= 1e18
    return x


def _same_nonfinite(got, ref):
    return all(torch.equal(f(got), f(ref))
               for f in (torch.isnan, torch.isposinf, torch.isneginf))


def _row_err(got, ref):
    """Finite entries, each row relative to its own magnitude."""
    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0).amax(1, keepdim=True).clamp_min(
        1e-30)
    return (torch.where(fin, (got - ref).abs(), 0) / scale).max().item()


# both bodies of the real kernel: the 3xTF32 tensor-core GEMM (lengths
# that are multiples of 4) and the FMA loop
REAL_BODIES = [(64, 64, "tf32x3"), (512, 512, "tf32x3"),
               (1000, 1000, "tf32x3"), (96, 132, "tf32x3"),
               (93, 93, "fma"), (93, 128, "fma"), (7, 7, "fma"),
               (2, 2, "fma")]


@pytest.mark.parametrize("batch", [1, 127, 129, 257])
@pytest.mark.parametrize("m_in,m_out,body", REAL_BODIES)
def test_real_kernel_bodies_match_plain_version(m_in, m_out, body, batch,
                                                cuda_device):
    """K11 on batches that end mid-tile; one call, one launch."""
    assert dense_mm.form(m_in, m_out) == body
    x, _ = _planes((batch, m_in), cuda_device, seed=batch)
    w, _ = _planes((m_in, m_out), cuda_device, seed=m_out + 3)
    dense_mm.reset_counts()
    got = dense_mm.dense_mm_real(x, w)
    assert dense_mm.launches == {"complex": 0, "real": 1, "r2r": 0}
    ref = dense_mm.dense_mm_real_reference(x, w)
    torch.cuda.synchronize()
    assert got.shape == (batch, m_out) and got.dtype == torch.float32
    assert _err((got, torch.zeros_like(got)),
                (ref, torch.zeros_like(ref))) < 1e-5


@pytest.mark.parametrize("table", [("dct", 2, "backward"),
                                   ("dst", 4, "ortho"),
                                   ("dct", 1, "forward")])
@pytest.mark.parametrize("n", [93, 128, 1024])
def test_real_kernel_edge_values(n, table, cuda_device):
    """K11/K12 on edge-value rows: Inf and NaN where the plain version has
    them, finite entries within 1e-5 of it."""
    kind, type_, norm = table
    x = _edge_rows(_planes((257, n), cuda_device, seed=n)[0])
    w = realtrans._table((kind, type_, n, norm, False), cuda_device)
    for kernel, plain in ((dense_mm.r2r_minor, dense_mm.r2r_minor_reference),
                          (dense_mm.dense_mm_real,
                           dense_mm.dense_mm_real_reference)):
        got, ref = kernel(x, w), plain(x, w)
        torch.cuda.synchronize()
        assert _same_nonfinite(got, ref)
        assert not torch.isfinite(ref[:3]).all()
        assert _row_err(got, ref) < 1e-5


def test_real_kernel_misaligned_view_runs_the_fma_body(cuda_device):
    """Rows that start 4 bytes into their storage cannot take 16-byte
    copies: the wrapper runs the FMA body, with the same result."""
    base, _ = _planes((257 * 128 + 1,), cuda_device, seed=5)
    x = base[1:].view(257, 128)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w, _ = _planes((128, 128), cuda_device, seed=6)
    assert dense_mm.form(128, 128, aligned=False) == "fma"
    got = dense_mm.dense_mm_real(x, w)
    ref = dense_mm.dense_mm_real_reference(x, w)
    torch.cuda.synchronize()
    assert _err((got, torch.zeros_like(got)),
                (ref, torch.zeros_like(ref))) < 1e-5


def test_real_kernel_rows_past_one_launch(cuda_device):
    """A batch longer than 65535 row tiles runs in two launches of the
    tensor-core body (the C loop), counted as one call."""
    batch = 65535 * 128 + 300
    x = torch.randn(batch, 4, device=cuda_device)
    w = torch.randn(4, 8, device=cuda_device)
    assert dense_mm.form(4, 8) == "tf32x3"
    got = dense_mm.dense_mm_real(x, w)
    ref = dense_mm.dense_mm_real_reference(x, w)
    torch.cuda.synchronize()
    assert _err((got, torch.zeros_like(got)),
                (ref, torch.zeros_like(ref))) < 1e-5


# both bodies of the complex kernel (K10): the 3xTF32 block product
# [xr | xi] @ [[wr, wi], [-wi, wr]] (lengths that are multiples of 4; 100
# and 36 put a plane's end inside a 32-deep stage) and the FMA loop
COMPLEX_BODIES = [(64, 64, "tf32x3"), (512, 512, "tf32x3"),
                  (100, 100, "tf32x3"), (36, 100, "tf32x3"),
                  (96, 132, "tf32x3"), (93, 93, "fma"), (93, 128, "fma"),
                  (7, 7, "fma"), (2, 2, "fma")]


@pytest.mark.parametrize("batch", [1, 127, 129, 257])
@pytest.mark.parametrize("m_in,m_out,body", COMPLEX_BODIES)
def test_complex_kernel_bodies_match_plain_version(m_in, m_out, body, batch,
                                                   cuda_device):
    """K10 on batches that end mid-tile, with the block table given and
    built by the wrapper; one launch a call, no plain-version CUDA call."""
    assert dense_mm.form(m_in, m_out) == body
    xr, xi = _planes((batch, m_in), cuda_device, seed=batch)
    wr, wi = _planes((m_in, m_out), cuda_device, seed=m_out + 5)
    wb = dense_mm.block_table(wr, wi).contiguous()
    dense_mm.reset_counts()
    got = dense_mm.dense_mm_complex(xr, xi, wr, wi, wb)
    again = dense_mm.dense_mm_complex(xr, xi, wr, wi)
    assert dense_mm.launches == {"complex": 2, "real": 0, "r2r": 0}
    assert dense_mm.reference_cuda_calls == 0
    ref = dense_mm.dense_mm_complex_reference(xr, xi, wr, wi)
    torch.cuda.synchronize()
    assert got[0].shape == (batch, m_out) and got[1].dtype == torch.float32
    assert _err(got, ref) < 1e-5
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_complex_kernel_at_the_path_shape(cuda_device):
    """K10 at (100000, 512) x (512, 512), hilbert's circulant: the
    tensor-core body, one launch."""
    from tpufft_torch import signal

    assert dense_mm.form(512, 512) == "tf32x3"
    xr, xi = _planes((100_000, 512), cuda_device, seed=12)
    plan = signal._hilbert_plan(512, 1, None)
    wr, wi = plan._table("cr", cuda_device), plan._table("ci", cuda_device)
    wb = plan._table("block", cuda_device)
    torch.testing.assert_close(wb, dense_mm.block_table(wr, wi), rtol=0,
                               atol=0)
    dense_mm.reset_counts()
    got = dense_mm.dense_mm_complex(xr, xi, wr, wi, wb)
    assert dense_mm.launches["complex"] == 1
    assert dense_mm.reference_cuda_calls == 0
    ref = dense_mm.dense_mm_complex_reference(xr, xi, wr, wi)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("n", [93, 128, 512])
def test_complex_kernel_edge_values(n, cuda_device):
    """K10 with edge values in xr: Inf and NaN where the plain version has
    them, finite entries within 1e-5 of it, on either body."""
    xr, xi = _planes((257, n), cuda_device, seed=n + 2)
    xr = _edge_rows(xr)
    wr, wi = _planes((n, n), cuda_device, seed=n + 3)
    got = dense_mm.dense_mm_complex(xr, xi, wr, wi)
    ref = dense_mm.dense_mm_complex_reference(xr, xi, wr, wi)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _same_nonfinite(g, r)
        assert not torch.isfinite(r[:3]).all()
        assert _row_err(g, r) < 1e-5


def test_complex_kernel_misaligned_view_runs_the_fma_body(cuda_device):
    """Planes that start 4 bytes into their storage run the FMA body."""
    base, _ = _planes((2 * 257 * 128 + 1,), cuda_device, seed=7)
    xr = base[1:257 * 128 + 1].view(257, 128)
    xi = base[257 * 128 + 1:].view(257, 128)
    assert xr.data_ptr() % 16 != 0
    wr, wi = _planes((128, 128), cuda_device, seed=8)
    got = dense_mm.dense_mm_complex(xr, xi, wr, wi)
    ref = dense_mm.dense_mm_complex_reference(xr, xi, wr, wi)
    torch.cuda.synchronize()
    assert _err(got, ref) < 1e-5


def test_complex_kernel_checks_its_block_table(cuda_device):
    xr = torch.zeros(4, 8, device=cuda_device)
    w = torch.zeros(8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="block table"):
        dense_mm.dense_mm_complex(xr, xr, w, w, torch.zeros(
            8, 16, device=cuda_device))
    with pytest.raises(ValueError, match="block table"):
        dense_mm.dense_mm_complex(xr, xr, w, w, torch.zeros(
            16, 16, device=cuda_device, dtype=torch.float64))


def test_r2r_backward_on_the_tensor_core_body(cuda_device):
    """K12's backward (``_R2R.backward``, the transposed table) on the
    tensor-core body at n = 1024."""
    assert dense_mm.form(1024, 1024) == "tf32x3"
    x, _ = _planes((300, 1024), cuda_device, seed=11)
    x.requires_grad_(True)
    dense_mm.reset_counts()
    tpufft_torch.dct(x, type=2).square().sum().backward()
    assert dense_mm.launches == {"complex": 0, "real": 0, "r2r": 2}
    xc = x.detach().cpu().requires_grad_(True)
    tpufft_torch.dct(xc, type=2).square().sum().backward()
    assert _err((x.grad, torch.zeros_like(x.grad)),
                (xc.grad, torch.zeros_like(xc.grad))) < 1e-5


def test_dense_wrappers_check_their_operands(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    w = torch.zeros(8, 5, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        dense_mm.dense_mm_real(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        dense_mm.dense_mm_real(x.T, w)
    with pytest.raises(ValueError, match="CUDA device"):
        dense_mm.dense_mm_real(x, w.cpu())
    with pytest.raises(ValueError, match="does not take"):
        dense_mm.dense_mm_complex(x, x, w.T.contiguous(), w.T.contiguous())
    empty = dense_mm.r2r_minor(torch.zeros(0, 8, device=cuda_device), w)
    assert empty.shape == (0, 5)


# one call of each path: the dense kernel it launches
@pytest.mark.parametrize("name,call,per_call", [
    ("hilbert", lambda x: tpufft_torch.hilbert(x), {"complex": 1}),
    ("filter real", lambda x: tpufft_torch.plan_filter(
        512, impulse=np.hanning(512))(x), {"real": 1}),
    ("filter complex", lambda x: tpufft_torch.plan_filter(
        512, impulse=np.hanning(512))(x.to(torch.complex64)),
     {"complex": 1}),
    ("dct", lambda x: tpufft_torch.dct(x), {"r2r": 1}),
    ("idct type 3 axis 0", lambda x: tpufft_torch.idct(x, type=3, axis=0),
     {"r2r": 1}),
])
def test_dense_paths_run_their_kernels(name, call, per_call, cuda_device):
    x, _ = _planes((300, 512), cuda_device, seed=3)
    dense_mm.reset_counts()
    y = call(x)
    torch.cuda.synchronize()
    assert dense_mm.launches == {k: per_call.get(k, 0)
                                 for k in dense_mm.launches}, name
    assert dense_mm.reference_cuda_calls == 0
    cpu = call(x.cpu())
    assert y.is_cuda and y.dtype == cpu.dtype
    got = (y.real, y.imag) if y.is_complex() else (y, torch.zeros_like(y))
    ref = (cpu.real, cpu.imag) if cpu.is_complex() else (
        cpu, torch.zeros_like(cpu))
    assert _err(got, ref) < 1e-5


def test_dense_autograd_on_the_card(cuda_device):
    """The dense backward runs the same kernel with the adjoint table."""
    x, _ = _planes((8, 128), cuda_device)
    x.requires_grad_(True)
    dense_mm.reset_counts()
    tpufft_torch.dct(x, norm="ortho").square().sum().backward()
    assert dense_mm.launches["r2r"] == 2
    xc = x.detach().cpu().requires_grad_(True)
    tpufft_torch.dct(xc, norm="ortho").square().sum().backward()
    assert _err((x.grad, torch.zeros_like(x.grad)),
                (xc.grad, torch.zeros_like(xc.grad))) < 1e-5


def test_numpy_input_runs_on_the_card_by_default(cuda_device):
    """numpy in with no device: the work runs on the card (its kernels
    launch) and numpy comes back."""
    x = np.random.default_rng(0).standard_normal((40, 128)).astype(
        np.float32)
    for m in (minor_fft, dense_mm):
        m.reset_counts()
    spec = tpufft_torch.fft(x)
    analytic = tpufft_torch.hilbert(x)
    torch.cuda.synchronize()
    assert isinstance(spec, np.ndarray) and spec.dtype == np.complex64
    assert isinstance(analytic, np.ndarray)
    assert minor_fft.launches > 0 and dense_mm.launches["complex"] > 0
    assert np.max(np.abs(spec - np.fft.fft(x))) < 1e-3


# ----------------------------------------------------------------------------
# The short-time Fourier kernels K13, K14, K15
# ----------------------------------------------------------------------------

def _stft_tables(nperseg, m1, device, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (nperseg, m1)).astype(np.float32)).to(device) for _ in range(2))


def _rel(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).abs().max() / max(1.0, ref.abs().max())).item()


# (batch, nperseg, hop, m1, nseg): hops 128, 64 and 1, nperseg 128 to 1024,
# nfft > nperseg (m1 wider than nperseg / 2 + 1), a batch of 1, ragged
# segment and column edges
STFT_SHAPES = [(3, 256, 128, 129, 300), (1, 128, 64, 65, 1000),
               (5, 1024, 256, 513, 37), (2, 200, 100, 151, 129),
               (7, 16, 1, 9, 1), (70, 64, 16, 33, 131)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-5)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,nperseg,hop,m1,nseg", STFT_SHAPES)
def test_stft_kernels_match_plain_versions(batch, nperseg, hop, m1, nseg,
                                           dtype, tol, cuda_device):
    """K13, K14 and K15 (welch and csd) against their plain versions on the
    same (bf16: the same rounded) inputs; both compute in f32."""
    n_sig = (nseg - 1) * hop + nperseg + hop - 1   # a ragged tail
    x, y = _planes((batch, n_sig), cuda_device, dtype, seed=nperseg)
    # K13 and K15 on nfft = 2 (m1 - 1): a random window and per-bin factor,
    # the detrend kinds in turn
    win, c_r = (t[:, 0].contiguous() for t in _stft_tables(
        max(nperseg, m1), 2, cuda_device, seed=batch))
    detrend = (False, "constant", "linear")[nseg % 3]
    frame_args = (win[:nperseg].contiguous(), c_r[:m1].contiguous(),
                  c_r.flip(0)[:m1].contiguous(), 2 * (m1 - 1), detrend, hop,
                  nseg)
    stft_mm.reset_counts()
    got = stft_mm.stft_frames(x, *frame_args)
    ref = stft_mm.stft_frames_reference(x, *frame_args)
    assert got[0].shape == (batch, nseg, m1) and got[0].dtype == torch.float32
    assert max(_rel(g, r) for g, r in zip(got, ref)) < tol
    welch_args = (frame_args[0], 2 * (m1 - 1), detrend, hop)
    w = stft_mm.welch_accum(x, *welch_args)
    assert _rel(w, stft_mm.welch_accum_reference(x, *welch_args)) < tol
    c = stft_mm.welch_accum(x, *welch_args, y)
    cref = stft_mm.welch_accum_reference(x, *welch_args, y)
    assert max(_rel(g, r) for g, r in zip(c, cref)) < tol
    if nperseg % hop == 0:
        zr, zi = _planes((batch, nseg, m1), cuda_device, dtype, seed=nseg)
        ar, ai = (t.T.contiguous() for t in _stft_tables(nperseg, m1,
                                                          cuda_device, 5))
        o = stft_mm.istft_ola(zr, zi, ar, ai, hop)
        assert o.shape == (batch, (nseg - 1) * hop + nperseg)
        assert _rel(o, stft_mm.istft_ola_reference(zr, zi, ar, ai, hop)) < tol
    torch.cuda.synchronize()
    assert stft_mm.launches == {"stft": 1, "welch": 1, "csd": 1,
                                "istft": int(nperseg % hop == 0)}


def test_stft_wrappers_check_their_operands(cuda_device):
    x = torch.zeros(2, 512, device=cuda_device)
    mr = torch.zeros(128, 65, device=cuda_device)
    win = torch.ones(128, device=cuda_device)
    frame_args = (torch.ones(128, device=cuda_device),
                  torch.ones(65, device=cuda_device),
                  torch.zeros(65, device=cuda_device), 128, False, 64, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stft_mm.stft_frames(x.double(), *frame_args)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mm.stft_frames(x[:, ::2], *frame_args)
    with pytest.raises(ValueError, match="CUDA device"):
        stft_mm.welch_accum(x.cpu(), win, 128, False, 64)
    with pytest.raises(ValueError, match="tables must be float32 on"):
        stft_mm.welch_accum(x, win.cpu(), 128, False, 64)
    with pytest.raises(ValueError, match="outside the kernel's envelope"):
        stft_mm.welch_accum(x, win, 262, False, 64)
    z = torch.zeros(2, 7, 65, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of hop"):
        stft_mm.istft_ola(z, z, mr.T.contiguous(), mr.T.contiguous(), 48)


# K14 (batch, nperseg, hop, nfft, nseg): chip_smoke.py's STFT_KERNEL_CASES
# (hops 128, 64, 32, nperseg 128 to 1024, nfft > nperseg, nfft 200 on the
# dense body), one segment, fewer segments than one block's run, hop 1 at
# nperseg 256 (K = 256, several blocks a row), and a hop that is not a
# multiple of 4 (the line form's scalar overlap-add)
ISTFT_CASES = [(3, 256, 128, 256, 300), (1, 128, 64, 128, 1000),
               (70, 128, 64, 200, 131), (3, 1024, 256, 1024, 37),
               (5, 256, 128, 512, 129), (2, 128, 32, 128, 500),
               (4, 256, 128, 256, 1), (3, 256, 64, 512, 20),
               (1, 256, 1, 256, 9000), (2, 252, 6, 256, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,nperseg,hop,nfft,nseg", ISTFT_CASES)
def test_istft_frames_match_plain_version(batch, nperseg, hop, nfft, nseg,
                                          dtype, cuda_device):
    """K14 on its form (``istft_form``: the line form at nfft 256 to 1024,
    the dense body elsewhere) and on the dense body with the same function
    as a matrix (``istft_ola``), each against the plain version to 1e-5
    (both compute in f32 from the same, bf16: the same rounded, planes): a
    random window and complex per-bin factor, one launch a call, no plain
    version inside it, and two runs give the same bits."""
    m1 = nfft // 2 + 1
    zr, zi = _planes((batch, nseg, m1), cuda_device, dtype, seed=nseg)
    g = np.random.default_rng(nperseg + nfft)
    win = torch.from_numpy(g.uniform(0.1, 1.0, nperseg).astype(
        np.float32)).to(cuda_device)
    c = np.exp(2j * np.pi * g.uniform(size=m1)) * g.uniform(0.5, 2.0, m1)
    cr, ci = (torch.from_numpy(p.astype(np.float32)).to(cuda_device)
              for p in (c.real, c.imag))
    args = (win, cr, ci, nfft, hop)
    stft_mm.reset_counts()
    got = stft_mm.istft_frames(zr, zi, *args)
    again = stft_mm.istft_frames(zr, zi, *args)
    assert stft_mm.launches["istft"] == 2
    assert stft_mm.reference_cuda_calls == 0
    ref = stft_mm.istft_frames_reference(zr, zi, *args)
    A = stft_mm.synthesis_matrix(win.double().cpu().numpy(),
                                 cr.double().cpu().numpy()
                                 + 1j * ci.double().cpu().numpy(), nfft)
    ar, ai = (torch.as_tensor(p, dtype=torch.float32, device=cuda_device)
              for p in (A.real, A.imag))
    dense = stft_mm.istft_ola(zr, zi, ar, ai, hop)
    torch.cuda.synchronize()
    assert got.shape == (batch, (nseg - 1) * hop + nperseg)
    assert got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel(got, ref) < 1e-5
    assert _rel(dense, ref) < 1e-5


def test_istft_form_matches_the_library(cuda_device):
    """``istft_form`` mirrors the form the library picks at each nfft."""
    from tpufft_torch import _build
    lib = _build.load()
    for nfft in range(2, stft_mm.MAX_FRAME_NFFT + 1):
        assert bool(lib.tpufft_istft_line_form(nfft)) == (
            stft_mm.istft_form(nfft) == "lines"), nfft


def test_istft_frames_check_their_operands(cuda_device):
    z = torch.zeros(2, 7, 129, device=cuda_device)
    win, c = (torch.ones(k, device=cuda_device) for k in (256, 129))
    with pytest.raises(ValueError, match="multiple of hop"):
        stft_mm.istft_frames(z, z, win, c, c, 256, 48)
    with pytest.raises(ValueError, match="bins for nfft"):
        stft_mm.istft_frames(z, z, win, c, c, 512, 128)
    with pytest.raises(ValueError, match="tables must be float32 on"):
        stft_mm.istft_frames(z, z, win.cpu(), c, c, 256, 128)
    with pytest.raises(ValueError, match="contiguous"):
        stft_mm.istft_frames(z[:, ::2], z[:, ::2], win, c, c, 256, 128)


# (batch, nperseg, hop, nfft, nseg, offset): the stft path's hop 128 and
# ShortTimeFFT's hop 64, odd nfft (255, 93), nfft > nperseg, a ragged last
# run of frames (nseg not a multiple of a block's frames), hop 1, a hop
# longer than a frame, and signals that start off a 16-byte boundary
# (offset > 0: the span's copy starts and ends element by element)
K13_CASES = [(3, 256, 128, 256, 300, 0), (2, 128, 64, 128, 1001, 1),
             (5, 128, 32, 255, 77, 3), (2, 93, 31, 93, 40, 2),
             (3, 200, 100, 300, 33, 0), (2, 16, 1, 17, 500, 5),
             (4, 64, 100, 64, 9, 1), (1, 1024, 256, 1024, 37, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
@pytest.mark.parametrize("batch,nperseg,hop,nfft,nseg,offset", K13_CASES)
def test_stft_frame_fft_matches_plain_version(batch, nperseg, hop, nfft,
                                              nseg, offset, detrend, dtype,
                                              cuda_device):
    """K13's frame FFT against its plain version (the f64-built matrix):
    f32 and bf16 signals (both sides read the same values and compute in
    f32), every detrend, a complex per-bin factor."""
    n_sig = (nseg - 1) * hop + nperseg + 7
    flat, _ = _planes((batch * n_sig + offset,), cuda_device, dtype,
                      seed=nfft + nseg)
    x = flat[offset:].view(batch, n_sig)
    m1 = nfft // 2 + 1
    rng = np.random.default_rng(nseg)
    win, c_r, c_i = (torch.from_numpy(rng.standard_normal(k).astype(
        np.float32)).to(cuda_device) for k in (nperseg, m1, m1))
    args = (win, c_r, c_i, nfft, detrend, hop, nseg)
    before = stft_mm.launches["stft"]
    got = stft_mm.stft_frames(x, *args)
    ref = stft_mm.stft_frames_reference(x, *args)
    torch.cuda.synchronize()
    assert stft_mm.launches["stft"] == before + 1
    assert got[0].shape == (batch, nseg, m1) and got[0].dtype == torch.float32
    assert max(_rel(g, r) for g, r in zip(got, ref)) < 1e-5


@pytest.mark.parametrize("cross", [False, True], ids=["welch", "csd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
@pytest.mark.parametrize("batch,nperseg,hop,nfft,nseg,offset", K13_CASES)
def test_welch_frame_fft_matches_plain_version(batch, nperseg, hop, nfft,
                                               nseg, offset, detrend, dtype,
                                               cross, cuda_device):
    """K15's frame FFT (welch, and csd of two signals) against its plain
    version (the f64-built matrix) on K13's cases: odd nfft, ragged last
    runs, signals off a 16-byte boundary; two runs give the same bits."""
    n_sig = (nseg - 1) * hop + nperseg + 7
    flat, flat_y = _planes((batch * n_sig + offset,), cuda_device, dtype,
                           seed=nfft + nseg)
    x = flat[offset:].view(batch, n_sig)
    y = flat_y[offset:].view(batch, n_sig) if cross else None
    win = torch.from_numpy(np.random.default_rng(nseg).standard_normal(
        nperseg).astype(np.float32)).to(cuda_device)
    args = (win, nfft, detrend, hop)
    key = "csd" if cross else "welch"
    before = stft_mm.launches[key]
    got = stft_mm.welch_accum(x, *args, y=y)
    again = stft_mm.welch_accum(x, *args, y=y)
    ref = stft_mm.welch_accum_reference(x, *args, y=y)
    torch.cuda.synchronize()
    assert stft_mm.launches[key] == before + 2
    got, again, ref = ((t,) if not cross else t for t in (got, again, ref))
    assert all(g.shape == (batch, nfft // 2 + 1) and g.dtype == torch.float32
               for g in got)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert max(_rel(g, r) for g, r in zip(got, ref)) < 1e-5


def test_stft_frame_fft_raises_outside_its_envelope(cuda_device):
    """An nfft whose stage length has a prime factor above 127, or above
    the envelope's 1024 (1025 = 5^2 x 41), raises on a CUDA tensor (the
    callers route it to the composed stft)."""
    x = torch.zeros(2, 1000, device=cuda_device)
    ones = torch.ones(132, device=cuda_device)
    with pytest.raises(ValueError, match="outside the kernel's envelope"):
        stft_mm.stft_frames(x, ones[:128], ones, ones, 262, False, 64, 10)
    big = torch.ones(513, device=cuda_device)
    with pytest.raises(ValueError, match="outside the kernel's envelope"):
        stft_mm.stft_frames(x, ones[:128], big, big, 1025, False, 64, 10)
    with pytest.raises(ValueError, match="do not fit"):
        stft_mm.stft_frames(x, ones[:128], ones[:65], ones[:65], 128,
                            False, 64, 20)


# one call of each spectral path: the kernels it launches
@pytest.mark.parametrize("name,call,per_call", [
    ("stft", lambda x: tpufft_torch.stft(x, nperseg=256)[2], {"stft": 1}),
    ("stft hop 64", lambda x: tpufft_torch.stft(x, nperseg=128)[2],
     {"stft": 1}),
    ("welch", lambda x: tpufft_torch.welch(x)[1], {"welch": 1}),
    ("csd", lambda x: tpufft_torch.csd(x, x.flip(-1))[1], {"csd": 1}),
    ("coherence", lambda x: tpufft_torch.coherence(x, x.flip(-1))[1],
     {"welch": 2, "csd": 1}),
    ("spectrogram", lambda x: tpufft_torch.spectrogram(
        x, nperseg=256, noverlap=128)[2], {"stft": 1}),
    ("istft", lambda x: tpufft_torch.istft(
        tpufft_torch.stft(x, nperseg=256, detrend="linear")[2])[1],
     {"stft": 1, "istft": 1}),
    ("ShortTimeFFT", lambda x: tpufft_torch.ShortTimeFFT(
        np.hanning(128), 64, 48000.0).istft(tpufft_torch.ShortTimeFFT(
            np.hanning(128), 64, 48000.0).stft(x), k1=x.shape[-1]),
     {"stft": 1, "istft": 1}),
])
def test_spectral_paths_run_their_kernels(name, call, per_call, cuda_device):
    x, _ = _planes((6, 20000), cuda_device, seed=4)
    stft_mm.reset_counts()
    y = call(x)
    torch.cuda.synchronize()
    assert stft_mm.launches == {k: per_call.get(k, 0)
                                for k in stft_mm.launches}, name
    assert stft_mm.reference_cuda_calls == 0
    cpu = call(x.cpu())
    assert y.is_cuda and y.dtype == cpu.dtype and y.shape == cpu.shape
    got = (y.real, y.imag) if y.is_complex() else (y, torch.zeros_like(y))
    ref = (cpu.real, cpu.imag) if cpu.is_complex() else (
        cpu, torch.zeros_like(cpu))
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("fn", ["csd", "coherence"])
@pytest.mark.parametrize("xs,ys", [((1, 3000), (3, 3000)),
                                   ((2, 1, 3000), (1, 3, 3000)),
                                   ((3, 3000), (1, 3000))])
def test_csd_broadcast_shapes_on_the_welch_kernel(fn, xs, ys, cuda_device):
    """csd and coherence broadcast x's and y's leading dims on K15's route:
    one csd launch a call, and the CPU's result."""
    x, _ = _planes(xs, cuda_device, seed=20)
    y, _ = _planes(ys, cuda_device, seed=21)
    stft_mm.reset_counts()
    _, got = getattr(tpufft_torch, fn)(x, y, nperseg=256)
    torch.cuda.synchronize()
    assert stft_mm.launches["csd"] == 1
    assert stft_mm.reference_cuda_calls == 0
    _, ref = getattr(tpufft_torch, fn)(x.cpu(), y.cpu(), nperseg=256)
    assert got.shape == ref.shape == torch.broadcast_shapes(xs, ys)[:-1] + (
        129,)
    g = (got.real, got.imag) if got.is_complex() else (
        got, torch.zeros_like(got))
    r = (ref.real, ref.imag) if ref.is_complex() else (
        ref, torch.zeros_like(ref))
    assert _err(g, r) < 1e-4


def test_spectral_autograd_on_the_card(cuda_device):
    """The fused routes' backward passes (plain torch ops) on the card
    agree with the CPU's."""
    x, _ = _planes((4, 4096), cuda_device, seed=6)

    def loss(v):
        _, _, Z = tpufft_torch.stft(v, nperseg=128)
        _, back = tpufft_torch.istft(Z * 1.5, nperseg=128)
        _, P = tpufft_torch.welch(v, nperseg=128)
        return back.square().sum() + P.sum() + Z.abs().sum()

    xg = x.clone().requires_grad_(True)
    loss(xg).backward()
    xc = x.cpu().requires_grad_(True)
    loss(xc).backward()
    assert _rel(xg.grad, xc.grad) < 1e-5


# ----------------------------------------------------------------------------
# The trailing cube (K5) and the middle pair (K6) on thread-block clusters
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cube", [(8, 8, 8), (8, 16, 32), (16, 16, 32),
                                  (16, 32, 32), (16, 32, 64), (32, 64, 64),
                                  (64, 64, 64), (24, 40, 56), (32, 32, 32)])
def test_cube_kernel_matches_plain_version(cube, dtype, tol, cuda_device):
    """Clusters of 1, 2, 4, 8, 16, 16, 16, 8 and 16 blocks; the line form
    for every cube but (24, 40, 56), which runs the stage form (blocks of
    8192 elements, and of 16384 in two register passes). On a ragged pre of
    3, on pre = 1, and on a pre that is not a multiple of the clusters the
    card holds at once."""
    active = cube_fft.active_clusters(*cube, dtype == torch.bfloat16, 0)
    assert active > 0
    assert cube_fft.form(*cube) == ("stages" if cube == (24, 40, 56)
                                    else "lines")
    for pre in (3, 1, 2 * active + 1):
        xr, xi = _planes((pre,) + cube, cuda_device, dtype,
                         seed=sum(cube) + pre)
        for inverse in (False, True):
            for scale in (1.0, 1.0 / np.prod(cube)):
                before = cube_fft.launches
                got = cube_fft.fft_cube(xr, xi, inverse=inverse, scale=scale)
                ref = cube_fft.fft_cube_reference(xr, xi, inverse=inverse,
                                                  scale=scale)
                torch.cuda.synchronize()
                assert cube_fft.launches == before + 1
                assert got[0].dtype == dtype and _err(got, ref) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cube", [(32, 32, 32), (64, 64, 64)])
def test_cube_fused_matches_cube_after_pack(cube, dtype, tol, cuda_device):
    """K16 on the lane-fused array of Plan.pack gives K5's result on the
    planes: one kernel body, two loads and stores (f32: to 1e-6, the two
    instantiations may contract their arithmetic differently; bf16: to the
    storage's rounding)."""
    from tpufft_torch.kernels import fused_fft
    shape = (3,) + cube
    xr, xi = _planes(shape, cuda_device, dtype, seed=len(cube))
    plan = tpufft_torch.plan_fft(shape, axes=(1, 2, 3), layout="lane-fused")
    st = plan.pack(SplitComplex(xr, xi))
    assert st.dtype == dtype and st.shape == shape[:3] + (2 * cube[2],)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / np.prod(cube)):
            got = fused_fft.fft_cube_fused(st, inverse=inverse, scale=scale)
            want = cube_fft.fft_cube(xr, xi, inverse=inverse, scale=scale)
            torch.cuda.synchronize()
            h = cube[2]
            assert _err((got[..., :h], got[..., h:]), want) < tol


@pytest.mark.parametrize("route", ["cube_last", "P1"])
@pytest.mark.parametrize("cube", [(32, 32, 32), (64, 64, 64)])
def test_cube_backward_through_the_line_form(cube, route, cuda_device):
    """The backward of the cube_last rule (K5) and of the lane-fused cube
    tier (P1, K16) at the line form's cubes: the kernel twice a loss, and
    the gradient against the CPU's."""
    from tpufft_torch.kernels import fused_fft
    shape = (2,) + cube
    weight = torch.arange(cube[2], device=cuda_device, dtype=torch.float32)
    if route == "cube_last":
        xr, xi = _planes(shape, cuda_device, seed=5)
        xr.requires_grad_(True)
        xi.requires_grad_(True)
        _reset()
        out = tpufft_torch.fftn(SplitComplex(xr, xi), axes=(1, 2, 3))
        (out.re.square() * weight + out.im).sum().backward()
        assert _counts() == (dict(NONE, cube=2), 0)
        cr = xr.detach().cpu().requires_grad_(True)
        ci = xi.detach().cpu().requires_grad_(True)
        ref = tpufft_torch.fftn(SplitComplex(cr, ci), axes=(1, 2, 3))
        (ref.re.square() * weight.cpu() + ref.im).sum().backward()
        assert _err((xr.grad, xi.grad), (cr.grad, ci.grad)) < 1e-5
    else:
        p = tpufft_torch.plan_fft(shape, axes=(1, 2, 3), layout="lane-fused",
                                  norm="ortho")
        st = _fused_array(shape, cuda_device, seed=5).requires_grad_(True)
        fused_fft.reset_counts()
        (p(st).square() * torch.cat([weight, weight])).sum().backward()
        assert fused_fft.launches["cube"] == 2
        pc = tpufft_torch.plan_fft(shape, axes=(1, 2, 3),
                                   layout="lane-fused", norm="ortho",
                                   device="cpu")
        sc = st.detach().cpu().requires_grad_(True)
        (pc(sc).square() * torch.cat([weight, weight]).cpu()).sum().backward()
        assert _fused_err(st.grad, sc.grad) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1,n2,L", [(8, 16, 128), (16, 64, 24),
                                     (32, 64, 16), (64, 128, 8),
                                     (64, 128, 37), (40, 64, 256),
                                     (128, 128, 9), (128, 512, 3),
                                     (36, 64, 20)])
def test_mid_pair_kernel_matches_plain_version(n1, n2, L, dtype, tol,
                                               cuda_device):
    """The line form on the powers of two (clusters of 1, 4, 8, 16, 16
    and 16 blocks at 8 lanes of L), the generic-radix form on (40, 64)
    (a cluster of 8 at 8 lanes), the stage form on (128, 512) and
    (36, 64) (clusters of 16 and 4 at 4 lanes, the first of 16384
    elements in two register passes), a ragged L (37, 9, 3) and pre of
    3."""
    assert mid_pair_fft.active_clusters(n1, n2, dtype == torch.bfloat16,
                                        0) > 0
    xr, xi = _planes((3, n1, n2, L), cuda_device, dtype, seed=n1 + L)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / (n1 * n2)):
            before = mid_pair_fft.launches
            got = mid_pair_fft.fft_mid_pair(xr, xi, inverse=inverse,
                                            scale=scale)
            ref = mid_pair_fft.fft_mid_pair_reference(
                xr, xi, inverse=inverse, scale=scale)
            torch.cuda.synchronize()
            assert mid_pair_fft.launches == before + 1
            assert got[0].dtype == dtype and _err(got, ref) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 128, 12), (1, 2, 2, 1),
                                   (3, 128, 2, 5), (2, 16, 16, 6),
                                   (1, 128, 64, 2), (5, 4, 32, 40),
                                   (2, 32, 128, 1)])
def test_mid_pair_line_form_edges(shape, dtype, tol, cuda_device):
    """The line form at the ends of its envelope (axes of 2 and 128), on
    an even L whose last tile is ragged (12, 6: paired stores masked), odd
    L (5: single stores), L of 1 and 2, forward and inverse, one launch a
    call."""
    _, n1, n2, L = shape
    assert mid_pair_fft.form(n1, n2, L) == "lines"
    xr, xi = _planes(shape, cuda_device, dtype, seed=sum(shape))
    for inverse in (False, True):
        _reset()
        got = mid_pair_fft.fft_mid_pair(xr, xi, inverse=inverse,
                                        scale=0.5)
        assert mid_pair_fft.launches == 1
        ref = mid_pair_fft.fft_mid_pair_reference(xr, xi, inverse=inverse,
                                                  scale=0.5)
        torch.cuda.synchronize()
        assert got[0].dtype == dtype and _err(got, ref) < tol


# the generic-radix form (csrc/mid_line.cuh): every family on each axis,
# the 56- and 60-value lines (224, 120, 240) and 256 on both, the timed
# pairs, T2's (48, 160), ragged L
MIXED_PAIRS = [(160, 160, 12), (48, 160, 37), (56, 56, 9), (256, 128, 5),
               (240, 120, 3), (224, 128, 16), (128, 240, 7), (112, 224, 2),
               (12, 15, 5), (14, 28, 8), (40, 7, 3), (16, 160, 2),
               (7, 3, 1), (30, 60, 10), (96, 192, 4), (128, 256, 6),
               (3, 224, 8), (120, 5, 11), (20, 24, 9), (80, 112, 1)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1,n2,L", MIXED_PAIRS)
def test_mid_pair_mixed_form_matches_plain_version(n1, n2, L, dtype, tol,
                                                   cuda_device):
    """The generic-radix line form against its plain version: forward and
    inverse, scale 1 and 1/(n1 n2), pre 3, one launch a call and no plain
    version on the card."""
    assert mid_pair_fft.form(n1, n2, L) == "mixed"
    assert mid_pair_fft.active_clusters(n1, n2, dtype == torch.bfloat16,
                                        0) > 0
    xr, xi = _planes((3, n1, n2, L), cuda_device, dtype, seed=n1 * n2 + L)
    for inverse in (False, True):
        for scale in (1.0, 1.0 / (n1 * n2)):
            _reset()
            got = mid_pair_fft.fft_mid_pair(xr, xi, inverse=inverse,
                                            scale=scale)
            assert _counts() == (dict(NONE, mid_pair=1), 0)
            ref = mid_pair_fft.fft_mid_pair_reference(
                xr, xi, inverse=inverse, scale=scale)
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and _err(got, ref) < tol, (
                inverse, scale)


@pytest.mark.parametrize("n1,n2", [(160, 160), (48, 160), (56, 56),
                                   (256, 128), (240, 120), (12, 15)])
def test_mid_pair_mixed_form_edge_values(n1, n2, cuda_device):
    """Edge values through the generic-radix form, one (pre, l) plane each
    (each plane is its own 2-D transform): +Inf, -Inf and NaN in the re
    plane of planes l = 0-2 of pre 0, 3.4e38 in plane 3, planes 5 and 6
    (both planes of storage) scaled by 1e-20 and 1e18, over L = 9 (a
    ragged second tile). The planes holding Inf or NaN come out
    non-finite in the kernel and in the plain version alike and no other
    plane does, except that the 3.4e38 plane may overflow in a
    butterfly's sum; the others, 1e-20 and 1e18 among them, are within
    1e-5 of the plain version relative to their own magnitude, and so is
    the 3.4e38 plane where it stays finite."""
    L = 9
    xr, xi = _planes((2, n1, n2, L), cuda_device, seed=n1 + n2)
    xr[0, 5 % n1, 7 % n2, 0] = float("inf")
    xr[0, 7 % n1, 3 % n2, 1] = float("-inf")
    xr[0, 3 % n1, 5 % n2, 2] = float("nan")
    xr[0, 9 % n1, 1 % n2, 3] = 3.4e38
    for x in (xr, xi):
        x[:, :, :, 5] *= 1e-20
        x[:, :, :, 6] *= 1e18
    assert mid_pair_fft.form(n1, n2, L) == "mixed"
    got = mid_pair_fft.fft_mid_pair(xr, xi, inverse=False, scale=1.0)
    ref = mid_pair_fft.fft_mid_pair_reference(xr, xi, inverse=False,
                                              scale=1.0)
    torch.cuda.synchronize()
    # one row a (pre, l) plane: (2 L, n1 n2)
    got = tuple(t.permute(0, 3, 1, 2).reshape(2 * L, -1) for t in got)
    ref = tuple(t.permute(0, 3, 1, 2).reshape(2 * L, -1) for t in ref)
    for out in (got, ref):
        bad = (~torch.isfinite(out[0]) | ~torch.isfinite(out[1])).any(1)
        assert bad[:3].all()
        assert not bad[4:].any()
    assert _complex_row_err((got[0][4:], got[1][4:]),
                            (ref[0][4:], ref[1][4:])) < 1e-5
    if torch.isfinite(got[0][3]).all() and torch.isfinite(got[1][3]).all():
        assert _complex_row_err((got[0][3:4], got[1][3:4]),
                                (ref[0][3:4], ref[1][3:4])) < 1e-5


def test_mid_pair_mixed_form_on_the_t2_path(cuda_device):
    """T2 at a tenth of its planes, (1, 25, 160, 160, 48) -> (1, 3, 160,
    160, 48) transform-major over axes 1-4: K3, then K6 once at (48, 160)
    on the generic-radix form, then K1; no plain version on the card."""
    shape = (1, 3, 160, 160, 48)
    xr, xi = _planes(shape, cuda_device, seed=25)
    plan = tpufft_torch.plan_fft(shape, layout="transform-major",
                                 axes=(1, 2, 3, 4))
    packed = plan.pack(SplitComplex(xr, xi))
    _reset()
    y = plan(packed)
    torch.cuda.synchronize()
    assert _counts() == (dict(NONE, inner_nd=1, mid_pair=1, minor=1), 0)
    assert mid_pair_fft.form(48, 160, 160) == "mixed"
    out = plan.unpack(y)
    want = np.fft.fftn(xr[0].double().cpu().numpy()
                       + 1j * xi[0].double().cpu().numpy())
    got = out.re[0].double().cpu().numpy() + 1j * out.im[0].double().cpu(
        ).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_mid_pair_line_form_at_the_path_shape(cuda_device):
    """K6 at (32, 64, 128, 128) c64, the fftn(axes=(1, 2)) path's shape:
    the line form, one launch, no plain-version CUDA call."""
    assert mid_pair_fft.form(64, 128, 128) == "lines"
    xr, xi = _planes((32, 64, 128, 128), cuda_device, seed=9)
    _reset()
    got = tpufft_torch.fftn(SplitComplex(xr, xi), axes=(1, 2))
    assert _counts() == (dict(NONE, mid_pair=1), 0)
    ref = mid_pair_fft.fft_mid_pair_reference(xr, xi, inverse=False,
                                              scale=1.0)
    torch.cuda.synchronize()
    assert _err((got.re, got.im), ref) < 1e-5


def test_cluster_wrappers_raise_outside_the_envelope(cuda_device):
    """A CUDA tensor the cluster kernels do not take raises; nothing falls
    back."""
    _reset()
    big = torch.zeros(1, 128, 128, 64, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        cube_fft.fft_cube(big, big, inverse=False, scale=1.0)
    odd = torch.zeros(1, 27, 200, 8, device=cuda_device)
    with pytest.raises(ValueError, match="envelope"):
        mid_pair_fft.fft_mid_pair(odd, odd, inverse=False, scale=1.0)
    x = torch.zeros(2, 8, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cube_fft.fft_cube(x.double(), x.double(), inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        mid_pair_fft.fft_mid_pair(x.transpose(1, 2), x.transpose(1, 2),
                                  inverse=False, scale=1.0)
    assert _counts() == (NONE, 0)


def test_cube_and_mid_pair_autograd_on_the_card(cuda_device):
    """The backward of each is the same kernel of the opposite sign: two
    launches a loss; the gradients agree with the CPU's."""
    for shape, axes, key in (((2, 16, 32, 64), (1, 2, 3), "cube"),
                             ((2, 8, 16, 128), (1, 2), "mid_pair")):
        xr, xi = _planes(shape, cuda_device, seed=len(key))
        xr.requires_grad_(True)
        xi.requires_grad_(True)
        _reset()
        out = tpufft_torch.fftn(SplitComplex(xr, xi), axes=axes,
                                norm="ortho")
        (out.re.square().sum() + 2.0 * out.im.square().sum()).backward()
        assert _counts() == (dict(NONE, **{key: 2}), 0)
        cr = xr.detach().cpu().requires_grad_(True)
        ci = xi.detach().cpu().requires_grad_(True)
        ref = tpufft_torch.fftn(SplitComplex(cr, ci), axes=axes,
                                norm="ortho")
        (ref.re.square().sum() + 2.0 * ref.im.square().sum()).backward()
        assert _err((xr.grad, xi.grad), (cr.grad, ci.grad)) < 1e-5


# ----------------------------------------------------------------------------
# The fused-storage kernels (K16-K20) and the layouts
# ----------------------------------------------------------------------------

def _fused_array(shape, device, dtype=torch.float32, seed=0):
    """A fused (..., 2 * shape[-1]) array, rows [re | im]."""
    re, im = _planes(shape, device, torch.float32, seed)
    return torch.cat([re, im], -1).to(dtype)


def _fused_err(got, ref):
    h = got.shape[-1] // 2
    return _err((got[..., :h], got[..., h:]), (ref[..., :h], ref[..., h:]))


# kernel, logical shape: ragged pre/B/M, halves 8 to 16384 (93 among them),
# M > 1 (K18) and M == 1 (K19), pairs up to 16384 elements
FUSED_CASES = [
    ("minor", (257, 8)), ("minor", (37, 93)), ("minor", (5, 1024)),
    ("minor", (3, 16384)), ("minor", (5, 16384)), ("minor", (4, 8320)),
    ("inner", (3, 64, 37, 93)), ("inner", (2, 16, 5, 64)),
    ("inner", (11, 128, 3, 256)), ("inner", (1, 2048, 3, 8)),
    ("inner_m1", (5, 128, 93)), ("inner_m1", (3, 8, 16384)),
    ("pair", (13, 64, 64)), ("pair", (3, 8, 93)), ("pair", (5, 128, 128)),
    ("cube", (3, 8, 8, 8)), ("cube", (3, 16, 32, 64)),
    ("cube", (2, 64, 64, 64)), ("cube", (3, 24, 40, 56)),
    ("cube", (3, 32, 32, 32)), ("cube", (1, 64, 64, 64)),
]


def _fused_call(kernel):
    from tpufft_torch.kernels import fused_fft
    return {"minor": (fused_fft.fft_minor_fused,
                      fused_fft.fft_minor_fused_reference),
            "inner": (fused_fft.fft_inner_fused,
                      fused_fft.fft_inner_fused_reference),
            "inner_m1": (fused_fft.fft_inner_fused,
                         fused_fft.fft_inner_fused_reference),
            "pair": (fused_fft.fft_pair_fused,
                     fused_fft.fft_pair_fused_reference),
            "cube": (fused_fft.fft_cube_fused,
                     fused_fft.fft_cube_fused_reference)}[kernel]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel,shape", FUSED_CASES)
def test_fused_kernel_matches_plain_version(kernel, shape, dtype, tol,
                                            cuda_device):
    from tpufft_torch.kernels import fused_fft
    kern, plain = _fused_call(kernel)
    st = _fused_array(shape, cuda_device, dtype, seed=sum(shape))
    if kernel == "inner_m1":
        st = st.reshape(shape[0], shape[1], 1, -1)
    n_total = np.prod(shape[1:] if kernel in ("cube", "pair") else shape[1])
    for inverse in (False, True):
        for scale in (1.0, 1.0 / n_total):
            before = fused_fft.launches[kernel]
            got = kern(st, inverse=inverse, scale=scale)
            ref = plain(st, inverse=inverse, scale=scale)
            torch.cuda.synchronize()
            assert fused_fft.launches[kernel] == before + 1
            assert got.dtype == dtype and got.shape == st.shape
            assert _fused_err(got, ref) < tol


def test_fused_wrappers_raise_outside_the_envelope(cuda_device):
    """A CUDA array the fused kernels do not take raises; nothing falls
    back."""
    from tpufft_torch.kernels import fused_fft
    fused_fft.reset_counts()
    with pytest.raises(ValueError, match="envelope"):
        fused_fft.fft_cube_fused(torch.zeros(1, 128, 128, 128,
                                             device=cuda_device),
                                 inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="envelope"):
        fused_fft.fft_pair_fused(torch.zeros(2, 128, 512, device=cuda_device),
                                 inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="envelope"):
        fused_fft.fft_minor_fused(torch.zeros(2, 262, device=cuda_device),
                                  inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_fft.fft_inner_fused(torch.zeros(2, 8, 4, 16, device=cuda_device,
                                              dtype=torch.float64),
                                  inverse=False, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_fft.fft_minor_fused(torch.zeros(16, 8, device=cuda_device).T,
                                  inverse=False, scale=1.0)
    assert fused_fft.launches == dict.fromkeys(fused_fft.launches, 0)
    assert fused_fft.reference_cuda_calls == 0


# lane-fused plans on the card: logical shape, axes, fused launches of ONE
# call (the cube, pair and minor tiers with their leading axes)
@pytest.mark.parametrize("shape,axes,per_call", [
    ((3, 16, 32, 64), (1, 2, 3), {"cube": 1}),
    ((2, 4, 8, 16, 32), (1, 2, 3, 4), {"inner": 1, "cube": 1}),
    ((2, 128, 128, 128), (1, 2, 3), {"inner": 1, "pair": 1}),
    ((2, 8, 128, 256), (1, 2, 3), {"inner": 1, "inner_m1": 1, "minor": 1}),
])
def test_lane_fused_plans_run_the_fused_kernels(shape, axes, per_call,
                                                cuda_device):
    from tpufft_torch.kernels import fused_fft
    x = _planes(shape, cuda_device, seed=len(shape))
    xc = torch.complex(*x)
    fwd = tpufft_torch.plan_fft(shape, axes=axes, layout="lane-fused")
    inv = tpufft_torch.plan_fft(shape, axes=axes, layout="lane-fused",
                                inverse=True)
    st = fwd.pack(xc)
    _reset()
    fused_fft.reset_counts()
    y = fwd(st)
    torch.cuda.synchronize()
    assert fused_fft.launches == dict(dict.fromkeys(fused_fft.launches, 0),
                                      **per_call)
    assert _counts() == (NONE, 0) and fused_fft.reference_cuda_calls == 0
    got = fwd.unpack(y)
    want = torch.fft.fftn(xc.cpu().to(torch.complex128), dim=axes)
    assert _err((got.re, got.im), (want.real, want.imag)) < 1e-5
    back = inv.unpack(inv(y))
    assert _err((back.re, back.im), x) < 1e-5


def test_lane_fused_autograd_on_the_card(cuda_device):
    """The backward of the cube tier is K16 of the opposite sign: two
    launches a loss; the gradient agrees with the CPU's."""
    from tpufft_torch.kernels import fused_fft
    shape = (2, 16, 32, 64)
    p = tpufft_torch.plan_fft(shape, axes=(1, 2, 3), layout="lane-fused",
                              norm="ortho")
    st = _fused_array(shape, cuda_device, seed=3).requires_grad_(True)
    fused_fft.reset_counts()
    (p(st).square() * torch.arange(2 * shape[-1], device=cuda_device)
     ).sum().backward()
    assert fused_fft.launches["cube"] == 2
    pc = tpufft_torch.plan_fft(shape, axes=(1, 2, 3), layout="lane-fused",
                               norm="ortho", device="cpu")
    sc = st.detach().cpu().requires_grad_(True)
    (pc(sc).square() * torch.arange(2 * shape[-1])).sum().backward()
    assert _fused_err(st.grad, sc.grad) < 1e-5


def test_transform_major_plans_on_the_card(cuda_device):
    """(20000, 93) along its minor axis runs K2 on the physical
    (93, 20000) planes; the ND plan of (1, 5, 40, 40, 24) runs the natural
    rules on (1, 5, 24, 40, 40)."""
    for shape, axes, want in (((20000, 93), (-1,), {"inner": 1}),
                              ((1, 5, 40, 40, 24), (1, 2, 3, 4), None)):
        x = torch.complex(*_planes(shape, cuda_device, seed=len(shape)))
        p = tpufft_torch.plan_fft(shape, axes=axes, layout="transform-major")
        sc = p.pack(x)
        _reset()
        y = p(sc)
        torch.cuda.synchronize()
        by_kernel, plain = _counts()
        assert plain == 0 and sum(by_kernel.values()) > 0
        if want is not None:
            assert by_kernel == dict(NONE, **want)
        got = p.unpack(y)
        ref = torch.fft.fftn(x.cpu().to(torch.complex128), dim=axes)
        assert _err((got.re, got.im), (ref.real, ref.imag)) < 1e-5


# ----------------------------------------------------------------------------
# The multirate, IIR, sigtools and ndimage layers
# ----------------------------------------------------------------------------

def _layer_counts():
    """(kernel launches of every module, plain-version runs on CUDA
    tensors) since the last reset."""
    from tpufft_torch.kernels import fused_fft
    mods = (minor_fft, inner_fft, pair_fft, real_fft, dense_mm, stft_mm,
            cube_fft, mid_pair_fft, fused_fft)
    launches = minor_fft.padded_launches + pair_fft.padded_launches
    for m in mods:
        launches += m.launches if isinstance(m.launches, int) \
            else sum(m.launches.values())
    return launches, sum(m.reference_cuda_calls for m in mods)


def _layer_reset():
    from tpufft_torch.kernels import fused_fft
    for m in (minor_fft, inner_fft, pair_fft, real_fft, dense_mm, stft_mm,
              cube_fft, mid_pair_fft, fused_fft):
        m.reset_counts()


def _rel(got, ref):
    got = got.detach().double().cpu().numpy()
    ref = ref.detach().double().cpu().numpy()
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


_BUTTER2 = tpufft_torch.butter(2, 0.2)
_FIR101 = tpufft_torch.firwin(101, 0.2)
_SOS8 = tpufft_torch.cheby1(8, 0.05, 0.2, output="sos")

# name, call on a (4, 5000) signal, whether it runs an FFT convolution
LAYER_PATHS = [
    ("decimate_iir", lambda x: tpufft_torch.decimate(x, 4), False),
    ("decimate_iir_causal",
     lambda x: tpufft_torch.decimate(x, 3, zero_phase=False), False),
    ("decimate_fir", lambda x: tpufft_torch.decimate(x, 4, ftype="fir"),
     True),
    ("resample_poly", lambda x: tpufft_torch.resample_poly(x, 3, 2, axis=-1),
     True),
    ("upfirdn_reflect", lambda x: tpufft_torch.upfirdn(
        _FIR101, x, 2, 3, mode="reflect"), True),
    ("lfilter_companion_zi", lambda x: tpufft_torch.lfilter(
        *_BUTTER2, x, zi=x[:, :2] * 0.5)[0], False),
    ("lfilter_fir", lambda x: tpufft_torch.lfilter(_FIR101, 1.0, x), True),
    ("sosfilt", lambda x: tpufft_torch.sosfilt(_SOS8, x), False),
    ("sosfiltfilt", lambda x: tpufft_torch.sosfiltfilt(_SOS8, x), False),
    ("filtfilt", lambda x: tpufft_torch.filtfilt(*_BUTTER2, x), False),
    ("savgol_interp", lambda x: tpufft_torch.savgol_filter(x, 101, 3), True),
    ("savgol_mirror", lambda x: tpufft_torch.savgol_filter(
        x, 31, 2, deriv=1, mode="mirror"), True),
    ("detrend", lambda x: tpufft_torch.detrend(x, bp=[1000, 3000]), False),
]


@pytest.mark.parametrize("name,fn,convolves", LAYER_PATHS,
                         ids=[p[0] for p in LAYER_PATHS])
def test_layer_paths_on_the_card(name, fn, convolves, cuda_device):
    """A CUDA tensor in gives a CUDA tensor out; the FFT convolutions launch
    kernels, the scans none; no plain version runs; the result is the CPU
    float64 run's within the f32 contract (rtol 2e-4 / atol 2e-5)."""
    x = _planes((4, 5000), cuda_device, seed=7)[0]
    _layer_reset()
    y = fn(x)
    torch.cuda.synchronize()
    launches, plain = _layer_counts()
    assert y.is_cuda and y.dtype == torch.float32
    assert plain == 0
    assert (launches > 0) == convolves, launches
    ref = fn(x.cpu().double())
    np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_rank_filters_on_the_card(cuda_device, monkeypatch):
    """medfilt2d, medfilt and order_filter filter a CUDA tensor on the card
    (unfold and kthvalue, in blocks), exactly as on the CPU."""
    from tpufft_torch import sigtools
    monkeypatch.setattr(sigtools, "_CHUNK_BYTES", 1 << 16)
    a = _planes((300, 257), cuda_device, seed=8)[0]
    cpu = a.cpu()
    for fn in (lambda t: tpufft_torch.medfilt2d(t),
               lambda t: tpufft_torch.medfilt2d(t, 5),
               lambda t: tpufft_torch.order_filter(
                   t, np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]), 3)):
        got = fn(a)
        assert got.is_cuda
        assert torch.equal(got.cpu(), fn(cpu))
    v = _planes((6, 40, 33), cuda_device, seed=9)[0]
    got = tpufft_torch.medfilt(v, (3, 5, 3))
    assert got.is_cuda
    assert torch.equal(got.cpu(), tpufft_torch.medfilt(v.cpu(), (3, 5, 3)))


def test_wiener_and_convolve_on_the_card(cuda_device):
    img = _planes((200, 300), cuda_device, seed=10)[0]
    _layer_reset()
    w = tpufft_torch.wiener(img)
    torch.cuda.synchronize()
    assert w.is_cuda and _layer_counts()[0] > 0 and _layer_counts()[1] == 0
    assert _rel(w, tpufft_torch.wiener(img.cpu().double())) < 1e-4
    k = _planes((5, 7), cuda_device, seed=11)[0]
    for method in ("fft", "direct"):
        got = tpufft_torch.convolve(img, k, "same", method)
        assert got.is_cuda
        assert _rel(got, tpufft_torch.convolve(img.cpu().double(),
                                               k.cpu().double(), "same",
                                               method)) < 1e-5
    ai = torch.randint(-9, 9, (60, 50), device=cuda_device)
    bi = torch.randint(-9, 9, (4, 3), device=cuda_device)
    for method in ("fft", "direct"):
        got = tpufft_torch.convolve(ai, bi, "full", method)
        assert got.is_cuda and got.dtype == torch.int64
        assert torch.equal(got.cpu(), tpufft_torch.convolve(
            ai.cpu(), bi.cpu(), "full", "direct"))
    got = tpufft_torch.convolve2d(img, k, "same", "wrap")
    assert got.is_cuda
    assert _rel(got, tpufft_torch.convolve2d(img.cpu().double(),
                                             k.cpu().double(), "same",
                                             "wrap")) < 1e-5


def test_fourier_filters_on_the_card(cuda_device):
    from tpufft_torch import ndimage
    x = torch.complex(*_planes((12, 40, 33), cuda_device, seed=12))
    sx = SplitComplex(x.real.contiguous(), x.imag.contiguous())
    for fn, p in ((ndimage.fourier_gaussian, 2.0),
                  (ndimage.fourier_uniform, 3.0),
                  (ndimage.fourier_ellipsoid, 2.5),
                  (ndimage.fourier_shift, (1.0, 2.5, -3.0))):
        got = fn(x, p)
        assert got.is_cuda and got.dtype == torch.complex64
        assert _rel(torch.view_as_real(got), torch.view_as_real(
            fn(x.cpu().to(torch.complex128), p))) < 1e-5
        gs = fn(sx, p)
        assert isinstance(gs, SplitComplex) and gs.re.is_cuda
        assert _rel(torch.view_as_real(gs.complex()),
                    torch.view_as_real(got)) < 1e-6


def test_numpy_input_runs_layers_on_the_card(cuda_device, monkeypatch):
    """numpy in with no device: the work runs on the card and numpy comes
    back (the FFT convolution launches kernels; the scan's planes lie on
    the card)."""
    from tpufft_torch import iir
    x = np.random.default_rng(0).standard_normal((3, 4000)).astype(
        np.float32)
    _layer_reset()
    y = tpufft_torch.decimate(x, 4, ftype="fir")
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    assert _layer_counts()[0] > 0
    devices = []
    real = iir._affine_scan

    def spy(u, zi, M):
        devices.append(u[0].device.type)
        return real(u, zi, M)

    monkeypatch.setattr(iir, "_affine_scan", spy)
    y = tpufft_torch.sosfilt(_SOS8, x)
    assert isinstance(y, np.ndarray) and set(devices) == {"cuda"}
    np.testing.assert_allclose(
        y, tpufft_torch.sosfilt(_SOS8, x.astype(np.float64), device="cpu"),
        rtol=2e-4, atol=2e-5)


def test_tf32_flag_leaves_the_fp32_product_sites_alone(cuda_device):
    """The lfilter companion scan, savgol_filter's edge projector and
    detrend's fit stay within the f32 contract, bit for bit where they are
    elementwise, with TF32 matmuls allowed."""
    x = _planes((4, 6000), cuda_device, seed=13)[0] + torch.linspace(
        0, 30, 6000, device=cuda_device)
    sites = (lambda t: tpufft_torch.lfilter(*_BUTTER2, t,
                                            zi=t[:, :2] * 0.5)[0],
             lambda t: tpufft_torch.savgol_filter(t, 101, 3),
             lambda t: tpufft_torch.detrend(t, bp=[2000]))
    off = [fn(x) for fn in sites]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        on = [fn(x) for fn in sites]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    for i, fn in enumerate(sites):
        np.testing.assert_allclose(on[i].cpu().numpy(),
                                   fn(x.cpu().double()).numpy(),
                                   rtol=2e-4, atol=2e-5)
    assert torch.equal(on[0], off[0]) and torch.equal(on[2], off[2])


def test_scan_autograd_on_the_card(cuda_device):
    x = _planes((3, 700), cuda_device, seed=14)[0].requires_grad_(True)
    (tpufft_torch.sosfilt(_SOS8, x) ** 2).sum().backward()
    xc = x.detach().cpu().requires_grad_(True)
    (tpufft_torch.sosfilt(_SOS8, xc) ** 2).sum().backward()
    assert _rel(x.grad, xc.grad) < 1e-4


# ----------------------------------------------------------------------------
# The design, LTI and waveform layers
# ----------------------------------------------------------------------------

# name, numerator shape, worN, the kernels that must launch
FREQZ_ROUTES = [
    ("row_k9", (101,), 2048, {"minor_padded"}),
    ("bank_k2", (129, 96), 1024, {"inner"}),
    ("long_k3_k2", (65537,), 2 ** 20, {"inner_nd", "inner"}),
]


def _by_kernel():
    from tpufft_torch.kernels import fused_fft
    return ({"minor": minor_fft.launches,
             "minor_padded": minor_fft.padded_launches, **inner_fft.launches,
             "pair": pair_fft.launches,
             "pair_padded": pair_fft.padded_launches, **real_fft.launches,
             **dense_mm.launches, **stft_mm.launches,
             "cube": cube_fft.launches, "mid_pair": mid_pair_fft.launches,
             **{f"fused_{k}": v for k, v in fused_fft.launches.items()}})


@pytest.mark.parametrize("name,shape,worN,kernels", FREQZ_ROUTES,
                         ids=[r[0] for r in FREQZ_ROUTES])
def test_freqz_routes_on_the_card(name, shape, worN, kernels, cuda_device):
    """freqz of a CUDA numerator with a scalar denominator is the port's FFT
    on the card: the route's kernels launch, no plain version runs, and the
    response is a complex64 tensor there, within 1e-5 of the float64 host
    evaluation."""
    b = _planes(shape, cuda_device, seed=sum(shape))[0]
    _layer_reset()
    w, h = tpufft_torch.freqz(b, 2.0, worN=worN)
    torch.cuda.synchronize()
    launched = {k for k, v in _by_kernel().items() if v}
    assert _layer_counts()[1] == 0
    assert launched == kernels, launched
    assert h.is_cuda and h.dtype == torch.complex64
    assert h.shape == (worN,) + shape[1:]
    bh = b.double().cpu().numpy()
    rows = bh if bh.ndim == 1 else bh[:, :4]
    wr, hr = tpufft_torch.freqz(rows, 2.0, worN=worN)
    np.testing.assert_array_equal(w, wr)
    got = h.cpu().numpy() if h.ndim == 1 else h[:, :4].cpu().numpy()
    assert np.max(np.abs(got - hr)) / np.max(np.abs(hr)) < 1e-5


def test_freqz_horner_stays_on_the_card(cuda_device):
    """A non-scalar denominator and an array worN run Horner's rule on the
    card: no kernel, no host copy, a CUDA tensor out."""
    b, a = tpufft_torch.butter(4, 0.3)
    bt = torch.as_tensor(b, dtype=torch.float32, device=cuda_device)
    _layer_reset()
    for kw in ({"a": a, "worN": 512}, {"a": 1.0,
                                        "worN": np.linspace(0, 3, 100)}):
        w, h = tpufft_torch.freqz(bt, **kw)
        assert h.is_cuda and h.dtype == torch.complex64
        ref = tpufft_torch.freqz(b, kw["a"], worN=kw["worN"])[1]
        assert np.max(np.abs(h.cpu().numpy() - ref)) < 1e-5
    assert _layer_counts() == (0, 0)


def _dlsim_system(nst=8, nin=4, nout=2, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nst, nst))
    A -= (np.max(np.real(np.linalg.eigvals(A))) + 0.5) * np.eye(nst)
    return tpufft_torch.cont2discrete(
        (A, rng.standard_normal((nst, nin)), rng.standard_normal((nout, nst)),
         rng.standard_normal((nout, nin))), 0.05)


def test_dlsim_on_the_card_with_tf32_on(cuda_device):
    """dlsim of a CUDA input runs the scan on the card with TF32 matmuls
    allowed and matches the CPU tensor run (no kernel launches)."""
    system = _dlsim_system()
    u = _planes((20000, 4), cuda_device, seed=15)[0]
    x0 = np.linspace(-1, 1, 8)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        _layer_reset()
        t, y, x = tpufft_torch.dlsim(system, u, x0=x0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert _layer_counts() == (0, 0)
    assert y.is_cuda and x.is_cuda and y.dtype == torch.float32
    _, yc, xc = tpufft_torch.dlsim(system, u.cpu(), x0=x0)
    assert _rel(y, yc) < 1e-5 and _rel(x, xc) < 1e-5
    _, yd, _ = tpufft_torch.dlsim(system, u.cpu().double().numpy(), x0=x0)
    assert _rel(y, torch.from_numpy(yd)) < 1e-4
    tt = np.linspace(0, 0.05 * 19999, 20000) * 0.999
    _, yt, _ = tpufft_torch.dlsim(system, u, t=tt, x0=x0)
    assert yt.is_cuda
    assert _rel(yt, tpufft_torch.dlsim(system, u.cpu(), t=tt, x0=x0)[1]) \
        < 1e-5


WAVEFORMS = [
    ("chirp_linear", lambda t: tpufft_torch.chirp(t, 5.0, 1.0, 50.0)),
    ("chirp_log", lambda t: tpufft_torch.chirp(t, 5.0, 1.0, 50.0,
                                               "logarithmic", phi=30)),
    ("chirp_complex", lambda t: tpufft_torch.chirp(t, 5.0, 1.0, 50.0,
                                                   complex=True)),
    ("sweep_poly", lambda t: tpufft_torch.sweep_poly(t, [2.0, -1.0, 10.0])),
    ("gausspulse", lambda t: torch.stack(tpufft_torch.gausspulse(
        t - 0.5, fc=40.0, retquad=True, retenv=True))),
    ("sawtooth", lambda t: tpufft_torch.sawtooth(20 * t, 0.3)),
    ("square", lambda t: tpufft_torch.square(20 * t, 0.2)),
]


# every test this process has run, in order (the autouse fixture below):
# a failure of a test that depends on no earlier one reports them
_RUN_SO_FAR = []


@pytest.fixture(autouse=True)
def _run_order(request):
    _RUN_SO_FAR.append(request.node.nodeid.rsplit("::", 1)[-1])


def _waveform_report(name, t, y, ref, truth, err):
    """Why the card's sampler and the CPU's differ: the 5 worst samples
    (index, t, the card's value, the CPU's, float64's), each side's worst
    distance from float64, the CPU's ATen capability and threads, and the
    last 40 tests this process ran before this one."""
    y, ref, truth = (v.detach().double().cpu().reshape(len(t), -1)
                     for v in (y, ref, truth))
    diff = (y - ref).abs().amax(1)
    worst = torch.argsort(diff, descending=True)[:5].tolist()
    rows = "; ".join(
        f"[{i}] t={t[i].item():.9g} card={y[i].tolist()} cpu={ref[i].tolist()}"
        f" f64={truth[i].tolist()}" for i in worst)
    before = _RUN_SO_FAR[:-1][-40:]
    return (f"{name}: card vs CPU {err:.3e}; card vs f64 "
            f"{(y - truth).abs().max().item():.3e}, CPU vs f64 "
            f"{(ref - truth).abs().max().item():.3e}; CPU "
            f"{torch.backends.cpu.get_cpu_capability()} x "
            f"{torch.get_num_threads()} threads; worst samples {rows}; "
            f"{len(_RUN_SO_FAR) - 1} tests ran before it in this process, "
            f"the last {len(before)}: {before}")


@pytest.mark.parametrize("name,fn", WAVEFORMS, ids=[w[0] for w in WAVEFORMS])
def test_waveforms_on_the_card(name, fn, cuda_device):
    """The samplers run where the time grid lies and keep float32; they
    match the CPU tensor path bit for bit up to float32 rounding of the
    phase (|phase| <= 2 pi 30 here). A mismatch reports the samples, each
    side against the float64 sampler on the same grid, and the tests this
    process ran before (``_waveform_report``)."""
    t = torch.linspace(0, 1, 100000, device=cuda_device)
    _layer_reset()
    y = fn(t)
    assert y.is_cuda and y.dtype in (torch.float32, torch.complex64)
    assert _layer_counts() == (0, 0)
    ref = fn(t.cpu())
    if y.is_complex():
        y, ref = torch.view_as_real(y), torch.view_as_real(ref)
    if name == "square":
        assert (y.cpu() != ref).float().mean() < 1e-4
    else:
        err = _rel(y, ref)
        if not err < 8 * 6e-8 * 2 * np.pi * 30 + 1e-6:   # NaN fails too
            truth = fn(t.cpu().double())
            if truth.is_complex():
                truth = torch.view_as_real(truth)
            pytest.fail(_waveform_report(name, t.cpu(), y, ref, truth, err))


# ----------------------------------------------------------------------------
# Peak finding and the B-spline filters
# ----------------------------------------------------------------------------


def _line_spectrum(n=65536, seed=9, quantum=2.0 ** -10):
    """Gaussian lines of widths 3-30 on a slow baseline with noise, rounded
    to multiples of ``quantum`` (plateaus, equal heights)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = 0.3 + 0.2 * np.sin(6 * np.pi * k / n) + 0.01 * rng.standard_normal(n)
    for pos, h, sd in zip(rng.uniform(0, n, n // 800),
                          rng.uniform(0.05, 1.0, n // 800),
                          rng.uniform(3, 30, n // 800)):
        x += h * np.exp(-0.5 * ((k - pos) / sd) ** 2)
    return np.round(x / quantum) * quantum


def _same_result(got, ref, tol):
    """Tensors on the card against the CPU run: integer tensors equal,
    float ones within tol of their size; nested tuples and dicts too."""
    if isinstance(ref, dict):
        assert list(got) == list(ref)
        for key in ref:
            _same_result(got[key], ref[key], tol)
        return
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same_result(g, r, tol)
        return
    assert got.is_cuda and got.dtype == ref.dtype and got.shape == ref.shape
    if not (ref.is_floating_point() or ref.is_complex()):
        assert torch.equal(got.cpu(), ref)
    elif ref.numel():
        g, r = got.cpu(), ref
        if r.is_complex():
            g, r = torch.view_as_real(g), torch.view_as_real(r)
        assert _rel(g, r) <= tol


PEAK_CALLS = [
    ("all_conditions", lambda x: tpufft_torch.find_peaks(
        x, height=(0.2, 1.5), threshold=(0.0, 0.05), distance=25,
        prominence=(0.02, None), width=(2.0, 200.0), wlen=1001,
        plateau_size=(1, 4))),
    ("prominence", lambda x: tpufft_torch.find_peaks(x, prominence=0.02)),
    ("distance_ties", lambda x: tpufft_torch.find_peaks(x, distance=7)),
    ("array_bounds", lambda x: tpufft_torch.find_peaks(
        x, height=torch.linspace(0.3, 0.6, x.numel(), device=x.device),
        width=(1.0, None), rel_height=0.7)),
    ("prominences_wlen", lambda x: tpufft_torch.peak_prominences(
        x, tpufft_torch.find_peaks(x)[0], 101)),
    ("widths", lambda x: tpufft_torch.peak_widths(
        x, tpufft_torch.find_peaks(x)[0], 0.8)),
    ("argrelmax_2d", lambda x: tpufft_torch.argrelmax(
        x.reshape(8, -1), axis=1, order=3)),
    ("argrelmin_wrap", lambda x: tpufft_torch.argrelmin(
        x, order=5, mode="wrap")),
    ("argrelextrema_ge", lambda x: tpufft_torch.argrelextrema(
        x.reshape(256, -1), np.greater_equal, axis=0, order=2)),
    ("cwt", lambda x: tpufft_torch.find_peaks_cwt(x[:8192],
                                                  np.arange(1, 17))),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name,fn", PEAK_CALLS, ids=[p[0] for p in PEAK_CALLS])
def test_peaks_on_the_card(name, fn, dtype, cuda_device):
    """The peak functions on a CUDA tensor: no kernel, no plain version,
    every result a tensor on the card, equal to the CPU tensor's run
    (indices exactly; the float64 properties to 1e-12 of their size,
    float32 input being decided in float64 on both devices)."""
    x = torch.from_numpy(_line_spectrum()).to(dtype)
    _layer_reset()
    got = fn(x.to(cuda_device))
    torch.cuda.synchronize()
    assert _layer_counts() == (0, 0)
    _same_result(got, fn(x), 1e-12)


def test_peaks_numpy_input_runs_on_the_card(cuda_device):
    x = _line_spectrum()
    peaks, props = tpufft_torch.find_peaks(x, prominence=0.05, width=2)
    ref, ref_props = tpufft_torch.find_peaks(x, prominence=0.05, width=2,
                                             device="cpu")
    assert isinstance(peaks, np.ndarray)
    np.testing.assert_array_equal(peaks, ref)
    for key in ref_props:
        np.testing.assert_allclose(props[key], ref_props[key], rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(
                                       ref_props[key]).max()))


_FIR7 = np.array([-0.05, 0.1, 0.25, 0.4, 0.25, 0.1, -0.05])
_FIR5 = np.array([0.1, 0.2, 0.4, 0.2, 0.1])

SPLINE_CALLS = [
    ("gauss_spline", lambda x: tpufft_torch.gauss_spline(x, 3)),
    ("cspline1d", tpufft_torch.cspline1d),
    ("qspline1d", tpufft_torch.qspline1d),
    ("cspline1d_smooth", lambda x: tpufft_torch.cspline1d(x, 2.5)),
    ("symiirorder1", lambda x: tpufft_torch.symiirorder1(
        x, 1.0, -2 + 3 ** 0.5)),
    ("symiirorder1_complex", lambda x: tpufft_torch.symiirorder1(
        x, 1.5, 0.3 + 0.4j)),
    ("symiirorder2", lambda x: tpufft_torch.symiirorder2(x, 0.5, np.pi / 4)),
    ("symiirorder2_slow", lambda x: tpufft_torch.symiirorder2(x, 0.97, 0.1)),
    ("cspline1d_eval", lambda x: tpufft_torch.cspline1d_eval(
        x, torch.linspace(-3e4, 1.1e5, 50000, device=x.device,
                          dtype=torch.float64))),
    ("qspline1d_eval", lambda x: tpufft_torch.qspline1d_eval(
        x, torch.linspace(-3e4, 1.1e5, 50000, device=x.device,
                          dtype=torch.float64), 0.5, 3.0)),
    ("cspline2d", lambda x: tpufft_torch.cspline2d(x[:65536].reshape(
        256, 256))),
    ("qspline2d", lambda x: tpufft_torch.qspline2d(x[:65536].reshape(
        128, 512))),
    ("sepfir2d", lambda x: tpufft_torch.sepfir2d(x[:65536].reshape(
        512, 128), _FIR7, _FIR5)),
    ("spline_filter", lambda x: tpufft_torch.spline_filter(
        x[:65536].reshape(256, 256), 5.0)),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name,fn", SPLINE_CALLS,
                         ids=[s[0] for s in SPLINE_CALLS])
def test_bsplines_on_the_card_with_tf32_on(name, fn, dtype, tol,
                                           cuda_device):
    """The B-spline filters on a CUDA tensor of 70000 samples (above the
    factor cache's limit) keep its dtype, launch no kernel and match the
    CPU tensor's run, with TF32 matmuls allowed: no product of a solve
    runs in TF32."""
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        70000)).to(dtype)
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        _layer_reset()
        got = fn(x.to(cuda_device))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert _layer_counts() == (0, 0)
    _same_result(got, fn(x), tol)


def test_bsplines_numpy_input_runs_on_the_card(cuda_device):
    x = np.random.default_rng(12).standard_normal(5000)
    got = tpufft_torch.cspline1d(x, 2.5)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    ref = tpufft_torch.cspline1d(x, 2.5, device="cpu")
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# backend, native and parallel on the card


def test_scipy_backend_on_cuda_tensors(cuda_device):
    """scipy.fft calls on CUDA tensors run the port's kernels (K1, K7,
    K12) and their results stay on the card, equal to the CPU tensors'
    runs (the plain versions)."""
    import scipy.fft as sfft

    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.standard_normal((64, 1024))
                          + 1j * rng.standard_normal((64, 1024))).astype(
                              np.complex64))
    xr = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    calls = ((lambda a: sfft.fft(a, workers=2), x, "minor"),
             (sfft.rfft, xr, "r2c"),
             (lambda a: sfft.dct(a, type=2), xr, "r2r"))
    for fn, arg, kernel in calls:
        with sfft.set_backend(tpufft_torch.scipy_backend()):
            _layer_reset()
            got = fn(arg.to(cuda_device))
            torch.cuda.synchronize()
            launches, plain = _layer_counts()
            ref = fn(arg)
        by_kernel = {"minor": minor_fft.launches, **real_fft.launches,
                     **dense_mm.launches}
        assert plain == 0 and by_kernel[kernel] >= 1 and launches >= 1
        assert isinstance(got, torch.Tensor) and got.is_cuda
        assert _rel(torch.view_as_real(got) if got.is_complex() else got,
                    torch.view_as_real(ref) if ref.is_complex() else ref) \
            < 1e-5


def test_scipy_backend_numpy_runs_on_the_card(cuda_device):
    import scipy.fft as sfft

    x = np.random.default_rng(22).standard_normal((16, 256))
    with sfft.set_backend(tpufft_torch.scipy_backend()):
        _layer_reset()
        got = sfft.rfft(x.astype(np.float32))
        assert _layer_counts()[0] >= 1
    with sfft.set_backend(tpufft_torch.scipy_backend(device="cpu")):
        ref = sfft.rfft(x.astype(np.float32))
    assert isinstance(got, np.ndarray)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_native_refuses_a_cuda_tensor(cuda_device):
    from tpufft_torch import native

    if not native.available():
        pytest.skip("native engine unavailable (no g++)")
    x = torch.zeros((4, 64), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="host engine: got a tensor on cuda"):
        native.fft(x)
    with pytest.raises(ValueError, match="host engine"):
        native.fftn(x.reshape(4, 8, 8))


def test_fft_distributed_d1_on_nccl(cuda_device, tmp_path):
    """A one-process NCCL group: fft_distributed, filter_distributed and
    rfft/irfft_distributed at d = 1 run the local transform on the card
    (K1 at n = 4096), with no exchange, and leave their results there."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from tpufft_torch import parallel

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
        rng = np.random.default_rng(23)
        x = rng.standard_normal((8, 4096)) + 1j * rng.standard_normal(
            (8, 4096))
        sc = SplitComplex(torch.tensor(x.real, dtype=torch.float32,
                                       device=cuda_device),
                          torch.tensor(x.imag, dtype=torch.float32,
                                       device=cuda_device))
        H = rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
        _layer_reset()
        out = parallel.fft_distributed(sc, mesh, axis_name="sp")
        filt = parallel.filter_distributed(sc, mesh, axis_name="sp",
                                           response=H)
        half = parallel.rfft_distributed(sc.re, mesh, axis_name="sp")
        back = parallel.irfft_distributed(half, mesh, axis_name="sp",
                                          n=4096)
        torch.cuda.synchronize()
        launches, plain = _layer_counts()
        assert plain == 0 and minor_fft.launches >= 4 and launches >= 4
        for t in (out.re, out.im, filt.re, half.re, back):
            assert t.is_cuda
        ref = np.fft.fft(x)
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(out.numpy() - ref)) / scale < 1e-5
        want = np.fft.ifft(ref * H)
        assert np.max(np.abs(filt.numpy() - want)) / max(
            1.0, np.max(np.abs(want))) < 1e-5
        assert np.max(np.abs(half.numpy() - np.fft.rfft(x.real))) / scale \
            < 1e-5
        assert np.max(np.abs(back.cpu().numpy() - x.real)) < 1e-4
    finally:
        dist.destroy_process_group()

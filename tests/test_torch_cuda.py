"""The port on the card: the CUDA kernel against its plain version, and the
main path through it.

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
from tpufft_torch import PlanConfig, SplitComplex
from tpufft_torch.kernels import minor_fft

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
                               8192, 16383, 16384])
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


@pytest.mark.parametrize("shape,axes", [((300, 1024), (-1,)),
                                        ((70, 93), (0,)),
                                        ((5, 16, 24), None)])
def test_main_path_runs_the_kernel(shape, axes, cuda_device):
    xr, xi = _planes(shape, cuda_device)
    x = SplitComplex(xr, xi)
    minor_fft.reset_counts()
    y = tpufft_torch.fftn(x, axes=axes)
    back = tpufft_torch.ifftn(y, axes=axes)
    torch.cuda.synchronize()
    n_axes = len(shape) if axes is None else len(axes)
    assert minor_fft.launches == 2 * n_axes
    assert minor_fft.reference_cuda_calls == 0
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
    xr, xi = _planes((4, 131), cuda_device)
    with pytest.raises(ValueError, match="not factorable"):
        tpufft_torch.fft(SplitComplex(xr, xi),
                         config=PlanConfig(backend="pallas"))
    minor_fft.reset_counts()
    y = tpufft_torch.fft(SplitComplex(xr, xi))  # auto: the Stockham
    assert minor_fft.launches == 0 and y.re.is_cuda

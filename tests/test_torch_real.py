"""The port's real transforms (rfft, irfft, rfftn, irfftn, rfft2, irfft2,
r2c/c2r plans) and the Hermitian family against tpufft's, on the same
inputs.

Both packages get the same numpy arrays made from a seed. tpufft runs its
Pallas kernels in interpret mode on the CPU with ``precision="highest"``;
the port runs its kernels' plain versions (CPU tensors). Tolerances,
normalized by the magnitude of the result:

* f32 paths: 1e-5 where both sides compute in f32 and differ in summation
  order; 1e-4 where either side runs Bluestein (the chirp's f32 rounding);
* bf16 planes: 8e-3, the README's fast-profile bound;
* f64 (the Hermitian family on float64 numpy input): 1e-10 against tpufft's
  x64 path and ``assert_spectrum_close``'s 1e-6 against scipy;
* gradients: 1e-5 of the gradient's magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpufft
from tpufft import PlanConfig as TPPlanConfig
from tpufft import SplitComplex as TPSplit

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex
from tpufft_torch.kernels import minor_fft, real_fft

from conftest import assert_spectrum_close
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))
NS = [2, 3, 8, 93, 128, 131, 1024, 2048, 4099]
NORMS = [None, "backward", "ortho", "forward"]


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _real(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _complex(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _tol(n):
    """1e-4 where a side runs Bluestein (a prime factor above 127 reaches
    it under backend="pallas"), 1e-5 otherwise."""
    return 1e-4 if n in (131, 4099) else 1e-5


@pytest.fixture
def kernel_calls(monkeypatch):
    """The wrapper of each real or padded kernel the port called."""
    calls = []
    for module, name in ((real_fft, "rfft_minor"), (real_fft, "irfft_minor"),
                         (minor_fft, "fft_minor_padded")):
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("n", NS)
def test_rfft_irfft_match_tpufft(n, norm, kernel_calls):
    x = _real((3, n), n)
    ref = tpufft.rfft(x, norm=norm, config=TP_CFG)
    got = tpufft_torch.rfft(x, norm=norm, config=CFG, device="cpu")
    assert got.dtype == np.complex64 and got.shape == (3, n // 2 + 1)
    assert _err(got, ref) < _tol(n)
    assert _err(got, np.fft.rfft(x.astype(np.float64), norm=norm)) < _tol(n)
    back_ref = tpufft.irfft(ref, n=n, norm=norm, config=TP_CFG)
    back = tpufft_torch.irfft(got, n=n, norm=norm, config=CFG, device="cpu")
    assert back.dtype == np.float32 and back.shape == (3, n)
    assert _err(back, back_ref) < _tol(n)
    assert _err(back, x) < _tol(n)
    kernel = real_fft.supported(n, torch.float32)
    assert kernel_calls == (["rfft_minor", "irfft_minor"] if kernel else [])


@pytest.mark.parametrize("n", [64, 101, 128, 200])
def test_rfft_crop_pad(n):
    x = _real((4, 100), 5)
    ref = tpufft.rfft(x, n=n, config=TP_CFG)
    assert _err(tpufft_torch.rfft(x, n=n, config=CFG,
                                  device="cpu"), ref) < _tol(n)


@pytest.mark.parametrize("n", [None, 64, 99, 130, 200])
def test_irfft_crop_pad(n):
    """Spectra of 51 bins to lengths below, at and above 2 (m - 1)."""
    y = _complex((4, 51), 6)
    ref = tpufft.irfft(y, n=n, config=TP_CFG)
    got = tpufft_torch.irfft(y, n=n, config=CFG, device="cpu")
    assert got.shape == ref.shape and _err(got, ref) < 1e-5


# (input shape, axes, s): odd last lengths, s pad and crop, a non-minor
# last transformed axis (moved minor for K7/K8), after tests/test_nd.py
ND_CASES = [
    ((4, 16, 24), None, None),
    ((4, 16, 25), None, None),
    ((4, 16, 24), (0, 2), None),
    ((4, 16, 24), (2, 1), None),
    ((4, 16, 24), (0, 1), None),
    ((4, 16, 24), (1, 2), (20, 30)),
    ((4, 16, 24), (1, 2), (8, 17)),
    ((3, 6, 8, 10), (1, 2, 3), (6, 9, 12)),
]


@pytest.mark.parametrize("shape,axes,s", ND_CASES)
def test_rfftn_irfftn_match_tpufft(shape, axes, s):
    x = _real(shape, sum(shape))
    ref = tpufft.rfftn(x, s=s, axes=axes, config=TP_CFG)
    got = tpufft_torch.rfftn(x, s=s, axes=axes, config=CFG, device="cpu")
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.rfftn(x.astype(np.float64), s=s,
                                  axes=axes)) < 1e-5
    back_ref = tpufft.irfftn(ref, s=s, axes=axes, config=TP_CFG)
    back = tpufft_torch.irfftn(got, s=s, axes=axes, config=CFG, device="cpu")
    assert back.shape == back_ref.shape and _err(back, back_ref) < 1e-5


@pytest.mark.parametrize("fn", ["rfft2", "irfft2"])
def test_rfft2_irfft2(fn):
    x = _real((3, 12, 20), 1) if fn == "rfft2" else _complex((3, 12, 11), 1)
    ref = getattr(tpufft, fn)(x, config=TP_CFG)
    got = getattr(tpufft_torch, fn)(x, config=CFG, device="cpu")
    assert got.shape == ref.shape and _err(got, ref) < 1e-5


def test_irfftn_odd_last_length_hermitian_extend():
    """An odd last length outside K8's envelope (131) takes the Hermitian
    extension over every axis, index-negated along the other axes."""
    y = _complex((3, 5, 66), 2)
    ref = tpufft.irfftn(y, s=(5, 131), axes=(1, 2), config=TP_CFG)
    got = tpufft_torch.irfftn(y, s=(5, 131), axes=(1, 2), config=CFG,
                              device="cpu")
    assert _err(got, ref) < 1e-4
    assert _err(got, np.fft.irfftn(y.astype(np.complex128), s=(5, 131),
                                   axes=(1, 2))) < 1e-4


def test_hfft_ihfft():
    """After tests/test_api.py: float64 numpy input runs the f64 path."""
    x = _real(20, 0, np.float64)
    got = tpufft_torch.ihfft(x, device="cpu")
    assert _err(got, tpufft.ihfft(x)) < 1e-10
    assert_spectrum_close(got, np.fft.ihfft(x), np.complex128)
    spec = np.fft.ihfft(x).astype(np.complex128)
    got = tpufft_torch.hfft(spec, n=20, device="cpu")
    assert _err(got, tpufft.hfft(spec, n=20)) < 1e-10
    assert_spectrum_close(got, np.fft.hfft(spec, n=20), np.complex128)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfftn_ihfftn_match_scipy(norm):
    sfft = pytest.importorskip("scipy.fft")
    x = _complex((3, 6, 5), 3, np.complex128)
    for fn, kw in (("hfftn", {"axes": (1, 2)}), ("hfft2", {})):
        got = getattr(tpufft_torch, fn)(x, norm=norm, **kw, device="cpu")
        assert _err(got, getattr(tpufft, fn)(x, norm=norm, **kw)) < 1e-10
        assert_spectrum_close(got, getattr(sfft, fn)(x, norm=norm, **kw),
                              np.complex128)
    r = _real((3, 6, 8), 4, np.float64)
    for fn, kw in (("ihfftn", {"axes": (1, 2)}), ("ihfft2", {})):
        got = getattr(tpufft_torch, fn)(r, norm=norm, **kw, device="cpu")
        assert _err(got, getattr(tpufft, fn)(r, norm=norm, **kw)) < 1e-10
        assert_spectrum_close(got, getattr(sfft, fn)(r, norm=norm, **kw),
                              np.complex128)


def test_hermitian_family_f32_and_forms():
    """c64 input on the f32 kernels' plain versions; SplitComplex and tensor
    forms keep their form; ihfftn resolves a "fast" length spec."""
    x = _complex((4, 33), 5)
    ref = tpufft.hfft(x, norm="ortho", config=TP_CFG)
    assert _err(tpufft_torch.hfft(x, norm="ortho", config=CFG,
                                  device="cpu"), ref) < 1e-5
    split = tpufft_torch.hfft(SplitComplex(torch.from_numpy(x.real.copy()),
                                           torch.from_numpy(x.imag.copy())),
                              norm="ortho", config=CFG)
    assert isinstance(split, SplitComplex)
    assert _err(split.numpy(), ref) < 1e-5
    r = _real((6, 12), 6)
    got = tpufft_torch.ihfft(torch.from_numpy(r), config=CFG)
    assert isinstance(got, torch.Tensor) and got.is_complex()
    assert _err(got.numpy(), tpufft.ihfft(r, config=TP_CFG)) < 1e-5
    got = tpufft_torch.ihfftn(r, s="fast", norm="ortho", config=CFG,
                              device="cpu")
    assert _err(got, tpufft.ihfftn(r, s="fast", norm="ortho",
                                   config=TP_CFG)) < 1e-5


def test_input_and_output_forms():
    x = _real((3, 16), 7)
    spec = np.fft.rfft(x.astype(np.float64))
    out_np = tpufft_torch.rfft(x, device="cpu")
    out_t = tpufft_torch.rfft(torch.from_numpy(x))
    assert isinstance(out_np, np.ndarray) and out_np.dtype == np.complex64
    assert out_t.is_complex() and out_t.dtype == torch.complex64
    for got in (out_np, out_t.numpy()):
        assert _err(got, spec) < 1e-5
    # c2r: the real plane as real numpy, a real tensor, or SplitComplex
    # (out, zeros) (after tests/test_split.py)
    back_np = tpufft_torch.irfft(spec.astype(np.complex64), n=16, device="cpu")
    back_t = tpufft_torch.irfft(out_t, n=16)
    back_s = tpufft_torch.irfft(
        SplitComplex(out_t.real.contiguous(), out_t.imag.contiguous()), n=16)
    assert isinstance(back_np, np.ndarray) and back_np.dtype == np.float32
    assert isinstance(back_t, torch.Tensor) and not back_t.is_complex()
    assert isinstance(back_s, SplitComplex)
    assert torch.equal(back_s.im, torch.zeros_like(back_s.re))
    for got in (back_np, back_t.numpy(), back_s.re.numpy()):
        assert _err(got, x) < 1e-5
    plan = tpufft_torch.plan_fft((3, 16), torch.float32, kind="r2c",
                                 axes=(-1,), device="cpu")
    assert plan.out_shape == (3, 9)
    assert _err(plan(x), spec) < 1e-5


@pytest.mark.parametrize("call", [
    lambda m, x: m.rfft(x.astype(np.complex64)),
    lambda m, x: m.rfftn(x.astype(np.complex128), axes=(0, 1)),
    lambda m, x: m.ihfft(x.astype(np.complex64)),
], ids=["rfft-complex", "rfftn-complex128", "ihfft-complex"])
def test_r2c_rejects_complex_input(call):
    x = _real((2, 8), 8)
    with pytest.raises(TypeError):
        call(tpufft, x)
    with pytest.raises(TypeError):
        call(tpufft_torch, x)


def test_r2c_rejects_split_and_complex_tensors():
    """After tests/test_split.py: SplitComplex and complex tensors are not
    real input."""
    x = _real((2, 8), 9)
    with pytest.raises(TypeError):
        tpufft.rfft(TPSplit(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x))))
    with pytest.raises(TypeError, match="real input"):
        tpufft_torch.rfft(SplitComplex(torch.from_numpy(x),
                                       torch.zeros(2, 8)))
    with pytest.raises(TypeError, match="real input"):
        tpufft_torch.rfft(torch.from_numpy(x).to(torch.complex64))


def test_bf16_planes():
    tp_cfg = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                          profile="fast")
    cfg = PlanConfig(**dataclasses.asdict(tp_cfg))
    x = _real((6, 1024), 10)
    ref = tpufft.rfft(x, config=tp_cfg)
    got = tpufft_torch.rfft(torch.from_numpy(x), config=cfg)
    assert _err(got.numpy(), ref) < 8e-3
    split = tpufft_torch.irfft(
        SplitComplex(got.real.contiguous(), got.imag.contiguous()), n=1024,
        config=cfg)
    assert split.dtype == torch.bfloat16
    assert _err(split.re.float().numpy(), x) < 8e-3
    back = tpufft_torch.irfft(got, n=1024, config=cfg, device="cpu")
    assert back.dtype == torch.float32
    assert _err(back.numpy(), tpufft.irfft(ref, n=1024, config=tp_cfg)) \
        < 8e-3


@pytest.mark.parametrize("n", [131, 1021])
def test_pallas_backend_serves_primes(n, kernel_calls):
    """Primes above K7/K8's envelope: the odd-n paths (a full C2C and the
    Hermitian extension) on Bluestein, under backend="pallas", without
    raising."""
    x = _real((2, n), n)
    got = tpufft_torch.rfft(x, config=CFG, device="cpu")
    assert _err(got, tpufft.rfft(x, config=TP_CFG)) < 1e-4
    back = tpufft_torch.irfft(got, n=n, config=CFG, device="cpu")
    assert _err(back, x) < 1e-4
    assert kernel_calls == []


def test_pallas_backend_serves_every_length_up_to_1024():
    """Every length tpufft's K7/K8 take (2 <= n <= 1024) reaches a kernel
    path under backend="pallas": K7/K8, or the packed and odd paths on the
    C2C ladder with Bluestein. Held against np.fft."""
    cfg = PlanConfig(backend="pallas")
    for n in range(2, 1025):
        x = _real((1, n), n)
        got = tpufft_torch.rfft(x, config=cfg, device="cpu")
        assert _err(got, np.fft.rfft(x.astype(np.float64))) < 1e-4, n
        assert _err(tpufft_torch.irfft(got, n=n, config=cfg,
                                       device="cpu"), x) < 1e-4, n


def test_xla_backend_runs_no_kernel(kernel_calls):
    x = _real((3, 128), 11)
    cfg = PlanConfig(backend="xla")
    got = tpufft_torch.rfft(x, config=cfg, device="cpu")
    assert _err(got, np.fft.rfft(x.astype(np.float64))) < 1e-5
    assert _err(tpufft_torch.irfft(got, n=128, config=cfg,
                                   device="cpu"), x) < 1e-5
    got = tpufft_torch.rfft(x[:, :93], config=cfg, device="cpu")        # odd n
    assert _err(got, np.fft.rfft(x[:, :93].astype(np.float64))) < 1e-5
    assert kernel_calls == []


def _loss(out):
    return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)


@pytest.mark.parametrize("shape,axes,n,norm", [
    ((4, 64), (-1,), 64, None),           # K7, even
    ((3, 93), (-1,), 93, "ortho"),        # K7, odd
    ((3, 40), (-1,), 50, "forward"),      # a padded rfft
    ((2, 6, 16), (1, 2), None, None),     # rfftn: K7, then the C2C
    ((2, 16, 6), (2, 1), None, "ortho"),  # rfftn, the last axis moved
])
def test_rfft_grad_matches_jax(shape, axes, n, norm):
    x = _real(shape, 12)
    s = None if n is None else (n,)
    tp_plan = tpufft.plan_fft(shape, jnp.float32, axes=axes, s=s, norm=norm,
                              kind="r2c", config=TP_CFG)
    ref = np.asarray(jax.grad(lambda v: _loss(tp_plan(v)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    plan = tpufft_torch.plan_fft(shape, torch.float32, axes=axes, s=s,
                                 norm=norm, kind="r2c", config=CFG,
                                 device="cpu")
    out = plan(xt)
    (torch.sum(out.real ** 2) + 2.0 * torch.sum(out.imag ** 2)).backward()
    assert np.max(np.abs(xt.grad.numpy() - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("shape,axes,s,norm", [
    ((4, 33), (-1,), (64,), None),            # K8, even
    ((3, 47), (-1,), (93,), "ortho"),         # K8, odd
    ((2, 6, 9), (1, 2), (6, 16), "forward"),  # the inverse C2C, then K8
])
def test_irfft_grad_matches_jax(shape, axes, s, norm):
    re, im = _real(shape, 13), _real(shape, 14)
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes, s=s,
                              inverse=True, norm=norm, kind="c2r",
                              config=TP_CFG)

    def loss(a, b):
        return jnp.sum(tp_plan(TPSplit(a, b)).re ** 2)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    xr = torch.tensor(re, requires_grad=True)
    xi = torch.tensor(im, requires_grad=True)
    plan = tpufft_torch.plan_fft(shape, torch.complex64, axes=axes, s=s,
                                 inverse=True, norm=norm, kind="c2r",
                                 config=CFG, device="cpu")
    torch.sum(plan(SplitComplex(xr, xi)).re ** 2).backward()
    for got, want in ((xr.grad, ref[0]), (xi.grad, ref[1])):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) \
            < 1e-5

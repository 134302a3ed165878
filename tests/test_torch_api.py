"""The port's complex FFT surface against tpufft's, on the same inputs.

Both packages get the same numpy planes (made from a seed) and the same
plan, carried across with ``tpufft_torch.convert``. tpufft runs its Pallas
kernels in interpret mode on the CPU with ``precision="highest"``; the port
runs its minor-axis kernel's plain version (c64) or its torch-op Stockham
(c128, lengths outside the kernel's envelope). Tolerances, normalized by
the spectrum's magnitude:

* c64: 1e-5, both sides compute in f32 and differ in summation order;
* c128: 1e-10, both sides compute in float64 (conftest turns x64 on);
* bf16 planes (``profile="fast"``): 8e-3, the README's fast-profile bound;
* gradients: 1e-5 of the gradient's magnitude.
"""

import dataclasses
import functools

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
from tpufft_torch.convert import plan_from_fields, split_from_numpy
from tpufft_torch.kernels import cube_fft, minor_fft, pair_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")
TP_AUTO = TPPlanConfig(interpret=True, backend="auto", lane_block=128,
                       precision="highest")
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))
AUTO = PlanConfig(**dataclasses.asdict(TP_AUTO))
SHAPES_1D = [(64, 1024), (130, 93)]


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _complex(shape, rng, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _port_plan(tp_plan, device="cpu"):
    return plan_from_fields(
        tp_plan.shape, tp_plan.dtype, tp_plan.axes, tp_plan.lengths,
        tp_plan.bases, tp_plan.inverse, tp_plan.norm, tp_plan.kind,
        dataclasses.asdict(tp_plan.config), device=device)


@pytest.fixture
def minor_calls(monkeypatch):
    """Shapes of the planes each call of the minor-axis kernel wrapper got."""
    calls = []
    real = minor_fft.fft_minor

    def spy(xr, xi, **kw):
        calls.append(tuple(xr.shape))
        return real(xr, xi, **kw)

    monkeypatch.setattr(minor_fft, "fft_minor", spy)
    return calls


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_plan_carried_across(shape, inverse, rng, minor_calls):
    x = _complex(shape, rng)
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=(-1,),
                              inverse=inverse, config=TP_CFG)
    plan = _port_plan(tp_plan)
    assert plan == tpufft_torch.plan_fft(shape, torch.complex64, axes=(-1,),
                                         inverse=inverse, config=CFG,
                                         device="cpu")
    assert plan.out_shape == tp_plan.out_shape
    ref = tp_plan(TPSplit(jnp.asarray(x.real), jnp.asarray(x.imag)))
    out = plan(split_from_numpy(x.real, x.imag, device="cpu"))
    assert isinstance(out, SplitComplex) and out.dtype == torch.float32
    assert _err(out.numpy(), np.asarray(ref.re) + 1j * np.asarray(ref.im)) < 1e-5
    assert minor_calls == [shape]


@pytest.mark.parametrize("fn", ["fft", "ifft"])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_fft_ifft_c64(fn, shape, rng):
    x = _complex(shape, rng)
    ref = getattr(tpufft, fn)(x, config=TP_CFG)
    got = getattr(tpufft_torch, fn)(x, config=CFG, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("fn", ["fft", "ifft"])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_fft_ifft_c128_stockham(fn, shape, rng, minor_calls):
    x = _complex(shape, rng, np.complex128)
    ref = getattr(tpufft, fn)(x, config=TP_AUTO)
    got = getattr(tpufft_torch, fn)(x, config=AUTO, device="cpu")
    assert got.dtype == np.complex128
    assert _err(got, ref) < 1e-10
    assert minor_calls == []  # f64 never reaches the f32/bf16 kernel


@pytest.mark.parametrize("fn", ["fftn", "ifftn", "fft2", "ifft2"])
def test_fftn_fft2(fn, rng, minor_calls, monkeypatch):
    calls = []

    def spy(name, real):
        def wrapped(xr, xi, **kw):
            calls.append((name, tuple(xr.shape)))
            return real(xr, xi, **kw)
        return wrapped

    monkeypatch.setattr(pair_fft, "fft_pair", spy("pair", pair_fft.fft_pair))
    monkeypatch.setattr(cube_fft, "fft_cube", spy("cube", cube_fft.fft_cube))
    x = _complex((4, 16, 24), rng)
    ref = getattr(tpufft, fn)(x, config=TP_CFG)
    got = getattr(tpufft_torch, fn)(x, config=CFG, device="cpu")
    assert _err(got, ref) < 1e-5
    # fftn's three axes run in one pass of the cube kernel, fft2's trailing
    # pair in one pass of the pair kernel: the minor-axis kernel is not
    # called
    want = (("cube", (1, 4, 16, 24)) if fn.endswith("fftn")
            else ("pair", (4, 16, 24)))
    assert calls == [want]
    assert minor_calls == []


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_norms(norm, inverse, rng):
    x = _complex((130, 93), rng)
    fn = "ifft" if inverse else "fft"
    ref = getattr(tpufft, fn)(x, norm=norm, config=TP_CFG)
    got = getattr(tpufft_torch, fn)(x, norm=norm, config=CFG, device="cpu")
    assert _err(got, ref) < 1e-5
    np_ref = getattr(np.fft, fn)(x.astype(np.complex128), norm=norm)
    assert _err(got, np_ref) < 1e-5


@pytest.mark.parametrize("fn", ["fft", "ifft"])
@pytest.mark.parametrize("n", [64, 128, 200, "fast", "fast-aligned"])
def test_crop_pad(n, fn, rng):
    x = _complex((130, 93), rng)
    ref = getattr(tpufft, fn)(x, n=n, config=TP_CFG)
    got = getattr(tpufft_torch, fn)(x, n=n, config=CFG, device="cpu")
    assert _err(got, ref) < 1e-5
    tp_plan = tpufft.plan_fft(x.shape, axes=(-1,), s=(n,))
    assert (_port_plan(tp_plan).out_shape == tp_plan.out_shape
            == tpufft_torch.plan_fft(x.shape, axes=(-1,), s=(n,),
                                     device="cpu").out_shape)


@pytest.mark.parametrize("axis", [0, -2])
def test_axis0(axis, rng, minor_calls):
    x = _complex((130, 24), rng)
    ref = tpufft.fft(x, axis=axis, config=TP_CFG)
    got = tpufft_torch.fft(x, axis=axis, config=CFG, device="cpu")
    assert _err(got, ref) < 1e-5
    assert minor_calls == []  # the strided kernel reads axis 0 in place


def test_input_forms(rng):
    x = _complex((130, 93), rng)
    ref = np.asarray(tpufft.fft(x, config=TP_CFG))
    out_np = tpufft_torch.fft(x, config=CFG, device="cpu")
    out_t = tpufft_torch.fft(torch.from_numpy(x), config=CFG)
    out_s = tpufft_torch.fft(SplitComplex(torch.from_numpy(x.real.copy()),
                                          torch.from_numpy(x.imag.copy())),
                             config=CFG)
    assert isinstance(out_np, np.ndarray)
    assert isinstance(out_t, torch.Tensor) and out_t.dtype == torch.complex64
    assert isinstance(out_s, SplitComplex)
    for got in (out_np, out_t.numpy(), out_s.numpy()):
        assert _err(got, ref) < 1e-5
    xr = x.real.copy()
    out_r = tpufft_torch.fft(torch.from_numpy(xr), config=CFG)
    assert out_r.is_complex()
    assert _err(out_r.numpy(), tpufft.fft(xr, config=TP_CFG)) < 1e-5


def test_bf16_planes(rng):
    x = _complex((130, 1024), rng)
    tp_cfg = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                          profile="fast")
    cfg = PlanConfig(**dataclasses.asdict(tp_cfg))
    ref = tpufft.fft(x, config=tp_cfg)
    out = tpufft_torch.fft(SplitComplex(torch.from_numpy(x.real.copy()),
                                        torch.from_numpy(x.imag.copy())),
                           config=cfg)
    assert out.dtype == torch.bfloat16
    assert _err(out.numpy(), ref) < 8e-3
    assert _err(tpufft_torch.fft(x, config=cfg, device="cpu"), ref) < 8e-3


class _OnCPU:
    """tpufft_torch with ``device="cpu"`` passed to every call, so that
    numpy input runs on the CPU."""

    def __getattr__(self, name):
        return functools.partial(getattr(tpufft_torch, name), device="cpu")


@pytest.mark.parametrize("call", [
    lambda m, x: m.plan_fft((4, 8), axes=(-1,), config=None)(x),  # shape
    lambda m, x: m.fft(x, norm="bogus"),
    lambda m, x: m.plan_fft((4, 12), bases=(5,)),
    lambda m, x: m.plan_fft((4, 12), bases=[(2, 2), (3,)]),
    lambda m, x: m.fft(x, axis=2),
    lambda m, x: m.fftn(x, axes=(1, -1)),
    lambda m, x: m.fftn(x, s=(4, 4, 4), axes=(0, 1)),
    lambda m, x: m.fft(x, n="quick"),
    lambda m, x: m.plan_fft((4, 9))((x.real, x.imag)),  # bare tuple
], ids=["shape", "norm", "bases", "bases-count", "axis", "repeated-axes",
        "s-length", "length-spec", "bare-tuple"])
def test_errors_match(call, rng):
    x = _complex((4, 9), rng)
    with pytest.raises(Exception) as theirs:
        call(tpufft, x)
    with pytest.raises(Exception) as ours:
        call(_OnCPU(), x)
    assert type(ours.value) is type(theirs.value)
    assert type(ours.value) in (ValueError, TypeError)


def test_bogus_layout_raises():
    """A layout neither package knows is a ValueError (the layouts
    themselves: tests/test_torch_layouts.py)."""
    with pytest.raises(ValueError):
        tpufft_torch.plan_fft((4, 8), layout="bogus", device="cpu")


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_real_plan_fields_match_tpufft(kind):
    """plan_fft and plan_from_fields build r2c/c2r plans with tpufft's
    lengths and out_shape (c2r's default last length is 2 (m - 1))."""
    for shape, axes, s in (((4, 8, 8, 8), None, None),
                           ((4, 9, 10), (0, 2), None),
                           ((6, 93), (-1,), (200,)),
                           ((5, 12, 7), (2, 1), (16, 9))):
        tp_plan = tpufft.plan_fft(shape, axes=axes, s=s, kind=kind,
                                  config=TP_CFG)
        plan = tpufft_torch.plan_fft(shape, axes=axes, s=s, kind=kind,
                                     config=CFG, device="cpu")
        carried = _port_plan(tp_plan)
        for p in (plan, carried):
            assert p.kind == kind
            assert p.lengths == tp_plan.lengths
            assert p.out_shape == tp_plan.out_shape
        assert carried == plan


def test_backend_dispatch(rng, minor_calls):
    x = _complex((6, 131), rng)        # 131: prime, outside the envelope
    np_ref = np.fft.fft(x.astype(np.complex128))
    # auto: the Stockham
    assert _err(tpufft_torch.fft(x, device="cpu"), np_ref) < 1e-5
    assert minor_calls == []
    # backend="pallas": Bluestein, both length-384 transforms on the kernel
    got = tpufft_torch.fft(x, config=PlanConfig(backend="pallas"),
                           device="cpu")
    assert _err(got, np_ref) < 1e-4
    assert minor_calls == [(6, 384), (6, 384)]
    minor_calls.clear()
    with pytest.raises(ValueError, match="not supported by the fused kernel"):
        tpufft_torch.fft(x[:, :128].astype(np.complex128),
                         config=PlanConfig(backend="pallas"), device="cpu")
    assert minor_calls == []
    y = _complex((6, 128), rng)
    got = tpufft_torch.fft(y, config=PlanConfig(backend="xla"), device="cpu")
    assert minor_calls == []
    assert _err(got, np.fft.fft(y.astype(np.complex128))) < 1e-5
    tpufft_torch.fft(y, device="cpu")
    assert minor_calls == [(6, 128)]


def _tp_loss(plan):
    def loss(re, im):
        out = plan(TPSplit(re, im))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)
    return loss


def _grad_err(got, ref):
    ref = np.asarray(ref)
    return np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("shape,axes,inverse,norm", [
    ((4, 64), (-1,), False, None),
    ((2, 32), (-1,), True, "ortho"),
    ((2, 16, 24), (1, 2), False, "forward"),
    ((6, 20), (0,), True, None),
])
def test_grad_matches_jax(shape, axes, inverse, norm, rng):
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes,
                              inverse=inverse, norm=norm, config=TP_CFG)
    ref = jax.grad(_tp_loss(tp_plan), argnums=(0, 1))(jnp.asarray(re),
                                                       jnp.asarray(im))
    xr = torch.tensor(re, requires_grad=True)
    xi = torch.tensor(im, requires_grad=True)
    out = _port_plan(tp_plan)(SplitComplex(xr, xi))
    (torch.sum(out.re ** 2) + 2.0 * torch.sum(out.im ** 2)).backward()
    assert _grad_err(xr.grad, ref[0]) < 1e-5
    assert _grad_err(xi.grad, ref[1]) < 1e-5


def test_grad_real_input(rng):
    x = rng.standard_normal((3, 64)).astype(np.float32)

    def tp_loss(v):
        out = tpufft.fft(v, config=TP_CFG)
        return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)

    ref = jax.grad(tp_loss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tpufft_torch.fft(xt, config=CFG)
    (torch.sum(out.real ** 2) + 2.0 * torch.sum(out.imag ** 2)).backward()
    assert _grad_err(xt.grad, ref) < 1e-5


def test_split_from_numpy():
    re = np.arange(6, dtype=np.float32).reshape(2, 3)
    sc = split_from_numpy(re, -re, device="cpu")
    assert isinstance(sc, SplitComplex) and sc.device.type == "cpu"
    assert sc.dtype == torch.float32 and sc.shape == (2, 3)
    assert np.array_equal(sc.numpy(), re - 1j * re)


@pytest.mark.parametrize("call", [
    lambda x: tpufft_torch.fft(x),
    lambda x: tpufft_torch.rfft(x.real),
    lambda x: tpufft_torch.fftn(x),
    lambda x: tpufft_torch.plan_fft(x.shape, x.dtype, axes=(-1,))(x),
    lambda x: split_from_numpy(x.real, x.imag),
    lambda x: tpufft_torch.dct(x.real),
    lambda x: tpufft_torch.plan_filter(9, response=np.ones(9))(x),
    lambda x: tpufft_torch.fftconvolve(x, x),
    lambda x: tpufft_torch.hilbert(x.real),
    lambda x: tpufft_torch.czt(x),
    lambda x: tpufft_torch.fht(x.real, 0.1, 0.5),
], ids=["fft", "rfft", "fftn", "plan", "split_from_numpy", "dct", "filter",
        "fftconvolve", "hilbert", "czt", "fht"])
def test_numpy_input_without_a_device_needs_the_card(call, monkeypatch):
    """numpy input runs on the CUDA device unless the caller names
    another: with no card, a call that names none raises RuntimeError and
    never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _complex((4, 9), np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(x)

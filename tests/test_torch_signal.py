"""The port's filtering and convolution layer against tpufft's and scipy's.

The same seeded numpy inputs go through ``tpufft.signal`` (Pallas kernels
in interpret mode, ``PlanConfig(interpret=True)``) and
``tpufft_torch.signal`` on the CPU (``device="cpu"``: the kernels' plain
versions). Tolerances, normalized by the result's magnitude:

* f32 against tpufft: 2e-5. Both compute in f32; tpufft's bf16x3 products
  and the port's f32 FMA differ by a few 1e-6;
* f32 against scipy's f64: 1e-4 (the f32 rounding of a length-n sum);
* f64 against scipy or the numpy pipeline: 1e-10 (both compute in f64);
* gradients against ``jax.grad`` of tpufft: 2e-5 of the gradient's size.

The spies record which dense wrapper each call reached: K10
(``dense_mm_complex``) or K11 (``dense_mm_real``).
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp
import tpufft
from tpufft import PlanConfig as TPPlanConfig
from tpufft import SplitComplex as TPSplit

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex, signal
from tpufft_torch.kernels import dense_mm, minor_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True)
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))
TP_XLA = TPPlanConfig(backend="xla")
XLA = PlanConfig(backend="xla")
CPU = "cpu"


def _err(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    got, ref = got.astype(np.complex128), ref.astype(np.complex128)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def dense_calls(monkeypatch):
    """The wrapper ("complex" for K10, "real" for K11) and the rows' shape
    of every dense call."""
    calls = []
    for kind in ("complex", "real"):
        name = f"dense_mm_{kind}"
        real = getattr(dense_mm, name)

        def spy(*args, _real=real, _kind=kind):
            calls.append((_kind, tuple(args[0].shape)))
            return _real(*args)

        monkeypatch.setattr(dense_mm, name, spy)
    return calls


# ----------------------------------------------------------------------------
# plan_filter
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 16, 93, 128, 480, 512])
def test_filter_by_response_matches_tpufft(n, dense_calls):
    x = _c64((7, n), n)
    H = _c64((n,), n + 1).astype(np.complex128)
    ref = tpufft.plan_filter(n, response=H, config=TP_CFG)(x)
    got = signal.plan_filter(n, response=H, config=CFG, device=CPU)(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    assert _err(got, ref) < 2e-5
    pipe = np.fft.ifft(np.fft.fft(x.astype(np.complex128)) * H)
    assert _err(got, pipe) < 1e-4
    assert dense_calls == [("complex", (7, n))]


def test_filter_impulse_equals_response(dense_calls):
    n = 64
    h = _f32((n,), 1).astype(np.float64) + 0.5j
    x = _c64((5, n), 2)
    a = signal.plan_filter(n, impulse=h, config=CFG, device=CPU)(x)
    b = signal.plan_filter(n, response=np.fft.fft(h), config=CFG,
                           device=CPU)(x)
    assert _err(a, b) < 1e-5


@pytest.mark.parametrize("cfg,route", [(CFG, [("real", (6, 128))]),
                                       (XLA, [])], ids=["kernel", "xla"])
def test_filter_real_hermitian_returns_real(cfg, route, dense_calls):
    """A real impulse on real input runs one real product (K11) and
    returns real; backend="xla" runs the same product as a matmul."""
    n = 128
    h = _f32((n,), 3).astype(np.float64)
    x = _f32((6, n), 4)
    ref = tpufft.plan_filter(n, impulse=h, config=TP_CFG)(x)
    got = signal.plan_filter(n, impulse=h, config=cfg, device=CPU)(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert _err(got, ref) < 2e-5
    assert dense_calls == route
    # complex input through the same real-impulse plan takes K10
    dense_calls.clear()
    xc = _c64((6, n), 5)
    got = signal.plan_filter(n, impulse=h, config=cfg, device=CPU)(xc)
    assert _err(got, tpufft.plan_filter(n, impulse=h, config=TP_CFG)(xc)) \
        < 2e-5
    assert dense_calls == ([("complex", (6, n))] if route else [])


def test_filter_middle_axis_and_tensor_forms(dense_calls):
    n = 32
    H = _c64((n,), 6).astype(np.complex128)
    x = _c64((4, n, 9), 7)
    tp_plan = tpufft.plan_filter(n, response=H, axis=1, config=TP_CFG)
    ref = np.asarray(tp_plan(x))
    plan = signal.plan_filter(n, response=H, axis=1, config=CFG, device=CPU)
    got = plan(x)
    assert _err(got, ref) < 2e-5
    out_t = plan(torch.from_numpy(x))
    assert isinstance(out_t, torch.Tensor) and out_t.dtype == torch.complex64
    assert _err(out_t.numpy(), ref) < 2e-5
    sc = plan(SplitComplex(torch.from_numpy(x.real.copy()),
                           torch.from_numpy(x.imag.copy())))
    assert isinstance(sc, SplitComplex) and sc.dtype == torch.float32
    assert _err(sc.numpy(), ref) < 2e-5
    assert dense_calls == [("complex", (36, n))] * 3


def test_filter_f64_tier():
    """complex128 and float64 numpy input run the host f64 pipeline."""
    n = 64
    H = _c64((n,), 8).astype(np.complex128)
    x = _c64((5, n), 9).astype(np.complex128)
    pipe = np.fft.ifft(np.fft.fft(x) * H)
    plan = signal.plan_filter(n, response=H, config=CFG, device=CPU)
    got = plan(x)
    assert got.dtype == np.complex128 and _err(got, pipe) < 1e-10
    assert _err(got, tpufft.plan_filter(n, response=H, config=TP_XLA)(x)) \
        < 1e-10
    h = _f32((n,), 10).astype(np.float64)
    xr = _f32((4, n), 11).astype(np.float64)
    got = signal.plan_filter(n, impulse=h, config=CFG, device=CPU)(xr)
    ref = np.fft.ifft(np.fft.fft(xr) * np.fft.fft(h)).real
    assert got.dtype == np.float64 and _err(got, ref) < 1e-10
    # a float64 tensor stays float64, on the composed path
    got_t = signal.plan_filter(n, impulse=h, config=CFG)(torch.from_numpy(xr))
    assert got_t.dtype == torch.float64 and _err(got_t.numpy(), ref) < 1e-10


@pytest.mark.parametrize("cfg", [CFG, XLA], ids=["kernel", "xla"])
def test_filter_composed_path_above_512(cfg, dense_calls, monkeypatch):
    """n > FILTER_DENSE_MAX_N composes fft -> H -> ifft: no circulant is
    built and no dense kernel runs; the transforms run on K1 (its plain
    version here) unless backend="xla"."""
    minor = []
    real_minor = minor_fft.fft_minor

    def spy(xr, xi, **kw):
        minor.append(tuple(xr.shape))
        return real_minor(xr, xi, **kw)

    monkeypatch.setattr(minor_fft, "fft_minor", spy)
    n = 1024
    assert n > signal.FILTER_DENSE_MAX_N
    H = _c64((n,), 12).astype(np.complex128)
    x = _c64((5, n), 13)
    plan = signal.plan_filter(n, response=H, config=cfg, device=CPU)
    assert plan._cr is None and plan._ci is None
    got = plan(x)
    ref = tpufft.plan_filter(n, response=H, config=TP_CFG)(x)
    assert _err(got, ref) < 2e-5
    assert dense_calls == []
    assert minor == ([(5, n), (5, n)] if cfg is CFG else [])


def _loss_grads(plan, re, im):
    xr = torch.tensor(re, requires_grad=True)
    xi = torch.tensor(im, requires_grad=True)
    out = plan(SplitComplex(xr, xi))
    (torch.sum(out.re ** 2) + 2.0 * torch.sum(out.im ** 2)).backward()
    return xr.grad.numpy(), xi.grad.numpy()


@pytest.mark.parametrize("n", [32, 1024], ids=["dense", "composed"])
def test_filter_grad_matches_jax(n):
    H = _c64((n,), 14).astype(np.complex128)
    re, im = _f32((3, n), 15), _f32((3, n), 16)
    tp_plan = tpufft.plan_filter(n, response=H, config=TP_CFG)

    def loss(a, b):
        out = tp_plan(TPSplit(a, b))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    got = _loss_grads(signal.plan_filter(n, response=H, config=CFG), re, im)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.max(np.abs(g - r)) / np.max(np.abs(r)) < 2e-5


def test_filter_real_kernel_grad_matches_jax():
    n = 64
    h = _f32((n,), 17).astype(np.float64)
    x = _f32((3, n), 18)
    tp_plan = tpufft.plan_filter(n, impulse=h, config=TP_CFG)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(tp_plan(v) ** 2))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(signal.plan_filter(n, impulse=h, config=CFG)(xt) ** 2
              ).backward()
    assert np.max(np.abs(xt.grad.numpy() - ref)) / np.max(np.abs(ref)) < 2e-5


def test_dense_functions_gradcheck():
    """The dense autograd Functions in f64 on the CPU: backward is the
    product with the adjoint table."""
    n = 6
    plan = signal.plan_filter(n, response=_c64((n,), 19), config=CFG)
    xr = torch.randn(2, n, dtype=torch.float64, requires_grad=True)
    xi = torch.randn(2, n, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: signal._DenseComplex.apply(a, b, plan), (xr, xi))
    real_plan = signal.plan_filter(n, impulse=np.arange(n, dtype=float),
                                   config=CFG)
    assert torch.autograd.gradcheck(
        lambda a: signal._DenseReal.apply(a, real_plan), (xr,))


@pytest.mark.parametrize("call", [
    lambda m: m.plan_filter(8),
    lambda m: m.plan_filter(8, response=np.ones(8), impulse=np.ones(8)),
    lambda m: m.plan_filter(8, response=np.ones(7)),
    lambda m: m.plan_filter(8, impulse=np.ones(9)),
    lambda m: m.plan_filter(0, response=np.ones(0)),
], ids=["neither", "both", "response-length", "impulse-length", "n"])
def test_filter_errors_match(call):
    with pytest.raises(Exception) as theirs:
        call(tpufft)
    with pytest.raises(Exception) as ours:
        call(tpufft_torch)
    assert type(ours.value) is type(theirs.value) is ValueError


def test_filter_axis_length_mismatch():
    plan = signal.plan_filter(8, response=np.ones(8), config=CFG, device=CPU)
    with pytest.raises(ValueError, match="filter length"):
        plan(np.ones((3, 9), np.complex64))
    with pytest.raises(ValueError, match="filter length"):
        plan(torch.ones(3, 9))


# ----------------------------------------------------------------------------
# fftconvolve / correlate / oaconvolve
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("sa,sb,axes", [((57,), (12,), None),
                                        ((23, 17), (5, 4), None),
                                        ((3, 50), (3, 7), [1]),
                                        ((3, 50), (1, 7), [1]),
                                        ((6, 30, 20), (1, 5, 5), (1, 2))])
def test_fftconvolve(mode, sa, sb, axes):
    a64, b64 = _f32(sa, 20).astype(np.float64), _f32(sb, 21).astype(
        np.float64)
    ref = ss.fftconvolve(a64, b64, mode=mode, axes=axes)
    got = tpufft_torch.fftconvolve(a64, b64, mode=mode, axes=axes,
                                   device=CPU)
    assert got.dtype == np.float64 and _err(got, ref) < 1e-10
    a, b = a64.astype(np.float32), b64.astype(np.float32)
    got = tpufft_torch.fftconvolve(a, b, mode=mode, axes=axes, config=CFG,
                                   device=CPU)
    tp = tpufft.fftconvolve(a, b, mode=mode, axes=axes, config=TP_CFG)
    assert got.dtype == np.float32 and _err(got, tp) < 2e-5
    assert _err(got, ref) < 1e-4


def test_fftconvolve_complex_swapped_and_forms():
    a, b = _c64((40,), 22).astype(np.complex128), _c64((9,), 23)
    b = b.astype(np.complex128)
    assert _err(tpufft_torch.fftconvolve(a, b, device=CPU),
                ss.fftconvolve(a, b)) < 1e-10
    # valid with in2 larger than in1: scipy swaps
    s, t = _f32((6,), 24), _f32((20,), 25)
    got = tpufft_torch.fftconvolve(s, t, mode="valid", config=CFG,
                                   device=CPU)
    assert _err(got, ss.fftconvolve(s, t, mode="valid")) < 1e-5
    # tensors stay tensors; same crops broadcast axes to in1's shape
    a1, b1 = _f32((1, 20), 26), _f32((5, 4), 27)
    got = tpufft_torch.fftconvolve(torch.from_numpy(a1), torch.from_numpy(b1),
                                   mode="same", axes=[1], config=CFG)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (1, 20)
    assert _err(got.numpy(), ss.fftconvolve(a1, b1, mode="same",
                                            axes=[1])) < 1e-5


def test_fftconvolve_edges_and_errors():
    out = tpufft_torch.fftconvolve(np.array([]), np.array([1.0]), device=CPU)
    assert out.shape == (0,)
    for args, kw in (((np.ones((3, 3)), np.ones(3)), {}),
                     ((np.ones(4), np.ones(4)), {"mode": "bogus"}),
                     ((np.ones((3, 5)), np.ones((2, 5))), {"axes": [1]}),
                     ((np.ones(3), np.ones(3)), {"axes": ()})):
        with pytest.raises(ValueError):
            tpufft.fftconvolve(*args, **kw)
        with pytest.raises(ValueError):
            tpufft_torch.fftconvolve(*args, **kw, device=CPU)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate(mode):
    a, b = _f32((50,), 28).astype(np.float64), _f32((11,), 29).astype(
        np.float64)
    ref = ss.correlate(a, b, mode=mode, method="fft")
    assert _err(tpufft_torch.correlate(a, b, mode=mode, device=CPU), ref) \
        < 1e-10
    got = tpufft_torch.correlate(a.astype(np.float32), b.astype(np.float32),
                                 mode=mode, config=CFG, device=CPU)
    tp = tpufft.correlate(a.astype(np.float32), b.astype(np.float32),
                          mode=mode, config=TP_CFG)
    assert _err(got, tp) < 2e-5


def test_correlate_complex_2d_and_batched_axes():
    a = _c64((20, 14), 30).astype(np.complex128)
    b = _c64((4, 5), 31).astype(np.complex128)
    assert _err(tpufft_torch.correlate(a, b, device=CPU),
                ss.correlate(a, b, method="fft")) < 1e-10
    a, b = _f32((3, 50), 32), _f32((3, 6), 33)
    got = tpufft_torch.correlate(a, b, axes=[1], config=CFG, device=CPU)
    for i in range(3):   # row i pairs with row i
        assert _err(got[i], ss.correlate(a[i], b[i], method="fft")) < 1e-5


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(1000, 17), (999, 16), (64, 1000)])
def test_oaconvolve(mode, n1, n2):
    a, b = _f32((n1,), n1), _f32((n2,), n2)
    ref = ss.oaconvolve(a.astype(np.float64), b.astype(np.float64),
                        mode=mode)
    got = tpufft_torch.oaconvolve(a, b, mode=mode, config=CFG, device=CPU)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _err(got, tpufft.oaconvolve(a, b, mode=mode, config=TP_CFG)) \
        < 2e-5
    assert _err(got, ref) < 1e-4
    got = tpufft_torch.oaconvolve(a.astype(np.float64), b.astype(np.float64),
                                  mode=mode, device=CPU)
    assert _err(got, ref) < 1e-10


def test_oaconvolve_batched_complex_and_delegation(monkeypatch):
    a, b = _f32((3, 2000), 34), _f32((3, 21), 35)
    got = tpufft_torch.oaconvolve(a, b, mode="same", axes=[1], config=CFG,
                                  device=CPU)
    assert _err(got, ss.oaconvolve(a, b, mode="same", axes=[1])) < 1e-5
    z1, z2 = _c64((1500,), 36), _c64((12,), 37)
    got = tpufft_torch.oaconvolve(z1, z2, config=CFG, device=CPU)
    assert _err(got, tpufft.oaconvolve(z1, z2, config=TP_CFG)) < 2e-5
    # comparable lengths, or more than one axis: delegates to fftconvolve
    seen = []
    real = signal.fftconvolve
    monkeypatch.setattr(signal, "fftconvolve",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    s, t = _f32((50,), 38), _f32((40,), 39)
    got = tpufft_torch.oaconvolve(s, t, config=CFG, device=CPU)
    assert _err(got, ss.oaconvolve(s, t)) < 1e-5 and seen == [1]
    got = tpufft_torch.oaconvolve(a, b, config=CFG, device=CPU)
    assert _err(got, ss.oaconvolve(a, b)) < 1e-5 and seen == [1, 1]


# ----------------------------------------------------------------------------
# hilbert / hilbert2 / resample / envelope
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 93, 128, 255, 512])
def test_hilbert(n, dense_calls):
    x = _f32((4, n), n)
    got = tpufft_torch.hilbert(x, config=CFG, device=CPU)
    assert got.dtype == np.complex64
    assert _err(got, tpufft.hilbert(x, config=TP_CFG)) < 2e-5
    ref = ss.hilbert(x.astype(np.float64))
    assert _err(got, ref) < 1e-4
    # the one-sided mask is not Hermitian: its circulant is complex (K10)
    assert dense_calls == [("complex", (4, n))]
    got = tpufft_torch.hilbert(x.astype(np.float64), device=CPU)
    assert got.dtype == np.complex128 and _err(got, ref) < 1e-10


def test_hilbert_padded_axis_and_errors():
    x = _f32((3, 100), 40)
    got = tpufft_torch.hilbert(x, N=128, config=CFG, device=CPU)
    assert _err(got, ss.hilbert(x, N=128)) < 1e-5
    got = tpufft_torch.hilbert(torch.from_numpy(x.T.copy()), N=64, axis=0,
                               config=CFG)
    assert isinstance(got, torch.Tensor)
    assert _err(got.numpy(), ss.hilbert(x.T, N=64, axis=0)) < 1e-5
    with pytest.raises(ValueError):
        tpufft_torch.hilbert(x.astype(np.complex64), device=CPU)
    with pytest.raises(ValueError):
        tpufft_torch.hilbert(x, N=0, device=CPU)


def test_hilbert_long_axis_builds_no_matrix():
    x = np.random.default_rng(0).standard_normal(100_000)
    got = tpufft_torch.hilbert(x.astype(np.float32), config=CFG, device=CPU)
    assert _err(got, ss.hilbert(x)) < 1e-4
    plan = signal._hilbert_plan(100_000, 0, CFG)
    assert plan._cr is None and plan._ci is None


@pytest.mark.parametrize("shape,N,axes", [((20, 14), None, (-2, -1)),
                                          ((3, 16, 9), 12, (-2, -1)),
                                          ((12, 3, 10), (8, 16), (0, 2))])
def test_hilbert2(shape, N, axes):
    x = _f32(shape, 41).astype(np.float64)
    ref = ss.hilbert2(x, N=N) if axes == (-2, -1) and x.ndim == 2 else None
    got = tpufft_torch.hilbert2(x, N=N, axes=axes, device=CPU)
    tp = tpufft.hilbert2(x, N=N, axes=axes)
    assert _err(got, tp) < 1e-10
    if ref is not None:
        assert _err(got, ref) < 1e-10
    got = tpufft_torch.hilbert2(x.astype(np.float32), N=N, axes=axes,
                                config=CFG, device=CPU)
    assert _err(got, tpufft.hilbert2(x.astype(np.float32), N=N, axes=axes,
                                     config=TP_CFG)) < 2e-5
    with pytest.raises(ValueError):
        tpufft_torch.hilbert2(x, axes=(1, 1), device=CPU)


@pytest.mark.parametrize("n,num", [(100, 50), (100, 75), (100, 200),
                                   (101, 50), (101, 64), (100, 101),
                                   (64, 64), (101, 202)])
def test_resample(n, num):
    x = _f32((3, n), n + num)
    ref = ss.resample(x.astype(np.float64), num, axis=-1)
    got = tpufft_torch.resample(x.astype(np.float64), num, axis=-1,
                                device=CPU)
    assert got.dtype == np.float64 and _err(got, ref) < 1e-10
    got = tpufft_torch.resample(x, num, axis=-1, config=CFG, device=CPU)
    assert got.dtype == np.float32
    assert _err(got, tpufft.resample(x, num, axis=-1, config=TP_CFG)) < 2e-5


def test_resample_complex_axis_and_tensor():
    x = _c64((40, 5), 42).astype(np.complex128)
    ref = ss.resample(x, 64, axis=0)
    assert _err(tpufft_torch.resample(x, 64, axis=0, device=CPU), ref) \
        < 1e-10
    got = tpufft_torch.resample(torch.from_numpy(x.astype(np.complex64)), 64,
                                axis=0, config=CFG)
    assert isinstance(got, torch.Tensor) and got.is_complex()
    assert _err(got.numpy(), ref) < 1e-5
    with pytest.raises(ValueError):
        tpufft_torch.resample(x, 0, device=CPU)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(bp_in=(5, 40)), dict(bp_in=(None, 30)),
    dict(bp_in=(-20, 30)), dict(n_out=150), dict(n_out=450),
    dict(n_out=151), dict(squared=True), dict(residual="all"),
    dict(residual=None), dict(bp_in=(5, 40), n_out=100, residual="all"),
    dict(bp_in=(-30, -5)), dict(bp_in=(0, 50)),
])
def test_envelope(kwargs):
    x = np.random.default_rng(43).standard_normal(300)
    z = x + 1j * np.random.default_rng(44).standard_normal(300)
    for sig in (x, z):
        want = ss.envelope(sig, **kwargs)
        got = tpufft_torch.envelope(sig, **kwargs, device=CPU)
        assert got.shape == want.shape and _err(got, want) < 1e-10
        s32 = sig.astype(np.complex64 if np.iscomplexobj(sig) else
                         np.float32)
        got = tpufft_torch.envelope(s32, **kwargs, config=CFG, device=CPU)
        tp = tpufft.envelope(s32, **kwargs, config=TP_CFG)
        # tpufft's complex resample of length 300 strays up to 2.2e-5 from
        # the f64 result in f32; the port is held to the f64 result, and to
        # tpufft within tpufft's own distance from it
        assert _err(got, want) < 2e-5
        assert _err(got, tp) < 2e-5 + _err(tp, want)


def test_envelope_axis_tensor_and_errors():
    X = np.random.default_rng(45).standard_normal((4, 201, 3))
    got = tpufft_torch.envelope(X, axis=1, device=CPU)
    assert _err(got, ss.envelope(X, axis=1)) < 1e-10
    xt = torch.from_numpy(X[0, :, 0].astype(np.float32))
    got = tpufft_torch.envelope(xt, bp_in=(3, 50), config=CFG)
    assert isinstance(got, torch.Tensor)
    assert _err(got.numpy(), ss.envelope(X[0, :, 0], bp_in=(3, 50))) < 1e-5
    x = X[0, :64, 0]
    for kw, match in ((dict(bp_in=(1.5, None)), "bp_in"),
                      (dict(bp_in=(40, 10)), "does not hold"),
                      (dict(n_out=-3), "n_out"),
                      (dict(residual="bogus"), "residual")):
        with pytest.raises(ValueError, match=match):
            tpufft_torch.envelope(x, **kw, device=CPU)

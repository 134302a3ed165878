"""The port's DCT/DST against tpufft's and scipy.fft's.

The same seeded inputs go through ``tpufft.realtrans`` (``backend="pallas"``,
its K12 kernel in interpret mode) and ``tpufft_torch.realtrans`` on the CPU
(``device="cpu"``: K12's plain version). Tolerances, normalized by the
result's magnitude: 2e-5 for f32 against tpufft (both compute in f32;
tpufft's bf16x3 products and the port's f32 FMA differ by a few 1e-6),
1e-4 for f32 against scipy's f64, and 1e-10 for f64 against scipy (both
compute in f64; the port's f64 runs a plain matmul with the f64 table).
"""

import dataclasses

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax
import jax.numpy as jnp
import tpufft
from tpufft import PlanConfig as TPPlanConfig

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex, realtrans
from tpufft_torch.kernels import dense_mm
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas")
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))
CPU = "cpu"
NORMS = ["backward", "ortho", "forward"]


def _err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _f64(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.fixture
def r2r_calls(monkeypatch):
    """The rows' shape of every K12 call."""
    calls = []
    real = dense_mm.r2r_minor

    def spy(x, w):
        calls.append(tuple(x.shape))
        return real(x, w)

    monkeypatch.setattr(dense_mm, "r2r_minor", spy)
    return calls


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("fn", ["dct", "idct", "dst", "idst"])
def test_1d_matches_tpufft_and_scipy(fn, type_, norm, r2r_calls):
    x = _f64((5, 31), type_)
    ref = getattr(sfft, fn)(x, type=type_, norm=norm)
    got = getattr(tpufft_torch, fn)(x, type=type_, norm=norm, device=CPU)
    assert got.dtype == np.float64 and _err(got, ref) < 1e-10
    assert r2r_calls == []   # f64 runs the plain matmul, not K12
    x32 = x.astype(np.float32)
    got = getattr(tpufft_torch, fn)(x32, type=type_, norm=norm, config=CFG,
                                    device=CPU)
    assert got.dtype == np.float32
    tp = getattr(tpufft, fn)(x32, type=type_, norm=norm, config=TP_CFG)
    assert _err(got, tp) < 2e-5
    assert _err(got, ref) < 1e-4
    assert r2r_calls == [(5, 31)]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("fn", ["dctn", "idctn", "dstn", "idstn"])
def test_nd_matches_scipy(fn, type_, norm):
    x = _f64((3, 8, 9), type_)
    ref = getattr(sfft, fn)(x, type=type_, norm=norm)
    got = getattr(tpufft_torch, fn)(x, type=type_, norm=norm, device=CPU)
    assert _err(got, ref) < 1e-10
    got = getattr(tpufft_torch, fn)(x.astype(np.float32), type=type_,
                                    norm=norm, axes=(1, 2), config=CFG,
                                    device=CPU)
    assert _err(got, getattr(sfft, fn)(x, type=type_, norm=norm,
                                       axes=(1, 2))) < 1e-4


@pytest.mark.parametrize("type_", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["dct", "dst"])
def test_roundtrip(kind, type_):
    x = _f64((3, 24), 7)
    fwd, inv = (getattr(tpufft_torch, kind),
                getattr(tpufft_torch, "i" + kind))
    for norm in (None, "ortho", "forward"):
        back = inv(fwd(x, type=type_, norm=norm, device=CPU), type=type_,
                   norm=norm, device=CPU)
        assert _err(back, x) < 1e-10
        t = torch.from_numpy(x.astype(np.float32))
        back = inv(fwd(t, type=type_, norm=norm, config=CFG), type=type_,
                   norm=norm, config=CFG)
        assert isinstance(back, torch.Tensor) and _err(back.numpy(), x) < 1e-5


@pytest.mark.parametrize("fn,kw", [
    ("dct", dict(axis=1)), ("dct", dict(n=16)), ("dct", dict(n=6)),
    ("dctn", dict(type=3, norm="ortho")),
    ("idstn", dict(s=(8, 12), axes=(1, 2))),
    ("dstn", dict(s=(8, 12))),   # s without axes: the last len(s) axes
])
def test_axis_n_and_nd(fn, kw):
    x = _f64((4, 6, 10), 8)
    got = getattr(tpufft_torch, fn)(x, **kw, device=CPU)
    assert _err(got, getattr(sfft, fn)(x, **kw)) < 1e-10
    assert _err(got, np.asarray(getattr(tpufft, fn)(x, **kw))) < 1e-10


def test_above_1024_runs_the_matmul(r2r_calls):
    """n > R2R_KERNEL_MAX_N runs a plain matmul (tpufft leaves it to XLA),
    and backend="xla" takes no kernel at any length."""
    x = _f64((3, 1100), 9).astype(np.float32)
    got = tpufft_torch.dct(x, config=CFG, device=CPU)
    assert _err(got, sfft.dct(x.astype(np.float64))) < 1e-4
    assert r2r_calls == []
    got = tpufft_torch.dst(x[:, :64], type=4, config=PlanConfig(backend="xla"),
                           device=CPU)
    assert _err(got, sfft.dst(x[:, :64].astype(np.float64), type=4)) < 1e-5
    assert r2r_calls == []
    tpufft_torch.dst(x[:, :2], config=CFG, device=CPU)
    assert r2r_calls == [(3, 2)]


def test_input_forms_and_complex_input():
    x = _f64((4, 12), 10)
    z = x + 1j * _f64((4, 12), 11)
    assert _err(tpufft_torch.dct(z, norm="ortho", device=CPU),
                sfft.dct(z, norm="ortho")) < 1e-10
    assert _err(tpufft_torch.idst(z, type=3, device=CPU),
                sfft.idst(z, type=3)) < 1e-10
    zt = torch.from_numpy(z.astype(np.complex64))
    got = tpufft_torch.dct(zt, config=CFG)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    assert _err(got.numpy(), sfft.dct(z)) < 1e-5
    sc = tpufft_torch.dst(SplitComplex(zt.real.contiguous(),
                                       zt.imag.contiguous()), type=2,
                          config=CFG)
    assert isinstance(sc, SplitComplex)
    assert _err(sc.numpy(), sfft.dst(z, type=2)) < 1e-5
    one = _f64((3, 1), 12)   # DST-I is defined at n=1
    assert _err(tpufft_torch.dst(one, type=1, device=CPU),
                sfft.dst(one, type=1)) < 1e-12


def test_grad_matches_jax_and_gradcheck():
    x = _f64((6, 32), 13).astype(np.float32)
    g = jax.grad(lambda v: jnp.sum(tpufft.dct(v, config=TP_CFG) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(tpufft_torch.dct(xt, config=CFG) ** 2).backward()
    g = np.asarray(g)
    assert np.max(np.abs(xt.grad.numpy() - g)) / np.max(np.abs(g)) < 2e-5
    # the autograd Function in f64: backward is g @ M^T
    key = ("dst", 3, 7, "ortho", True)
    x64 = torch.randn(3, 7, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda v: realtrans._R2R.apply(v, key),
                                    (x64,))


@pytest.mark.parametrize("fn,shape,kw,match", [
    ("dct", (4, 8), dict(type=5), "type"),
    ("dct", (4, 8), dict(norm="bogus"), "norm"),
    ("dct", (2, 1), dict(type=1), "n > 1"),
    ("dctn", (4, 8), dict(axes=(1, 1)), "unique"),
    ("dstn", (4, 8), dict(s=(4, 4), axes=(1,)), "len"),
], ids=["type", "norm", "dct1-n", "axes", "s-length"])
def test_errors_match(fn, shape, kw, match):
    x = np.zeros(shape)
    with pytest.raises(ValueError, match=match):
        getattr(tpufft, fn)(x, **kw)
    with pytest.raises(ValueError, match=match):
        getattr(tpufft_torch, fn)(x, **kw, device=CPU)

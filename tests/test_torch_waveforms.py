"""The port's waveforms against tpufft.waveforms and scipy.signal.

Numpy input computes on the host in float64 from the same code in both
packages: 1e-12 of the result's size. A float32 tensor is held against
tpufft's ``jnp`` path in float32: a phase of size |phase| radians is known
to about |phase| * 6e-8 in float32, and the two packages round the phase
polynomial in different orders, so the tolerance is 8 float32 epsilons of
the largest phase (plus 1e-6). A float64 tensor computes in float64 (tpufft
casts jax input to float32) and is held to 1e-12 against tpufft's numpy
path. ``unit_impulse`` with a scalar idx on an N-D shape and the complex
chirp pin scipy."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpufft import waveforms as twf

import tpufft_torch
from tpufft_torch import waveforms as wf
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TOL = 1e-12
EPS32 = float(np.finfo(np.float32).eps)


def _same(got, ref, tol=TOL):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, ref = got[~nan], ref[~nan]
    if ref.size:
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(got - ref)) <= tol * scale


def _phase_tol(max_phase: float) -> float:
    return 8 * EPS32 * max_phase + 1e-6


@pytest.fixture
def t():
    return np.linspace(0, 3, 500)


def _on_tensors(fn, tt, *args, phase, **kw):
    """fn on numpy (vs tpufft numpy, 1e-12), on a float64 tensor (vs tpufft
    numpy, 1e-12) and on a float32 tensor (vs tpufft's jnp, phase tol)."""
    got = getattr(wf, fn)(tt, *args, **kw)
    ref = getattr(twf, fn)(tt, *args, **kw)
    _same(got, ref)
    g64 = getattr(wf, fn)(torch.from_numpy(tt), *args, **kw)
    for g in (g64 if isinstance(g64, tuple) else (g64,)):
        assert isinstance(g, torch.Tensor)
        assert g.dtype in (torch.float64, torch.complex128)
    _same(g64, ref)
    t32 = tt.astype(np.float32)
    g32 = getattr(wf, fn)(torch.from_numpy(t32), *args, **kw)
    r32 = getattr(twf, fn)(jnp.asarray(t32), *args, **kw)
    for g in (g32 if isinstance(g32, tuple) else (g32,)):
        assert g.dtype in (torch.float32, torch.complex64)
    _same(g32, [np.asarray(r) for r in r32] if isinstance(r32, tuple)
          else np.asarray(r32), _phase_tol(phase))
    return got


@pytest.mark.parametrize("width", [1.0, 0.5, 0.0, 0.3, 1.5])
def test_sawtooth(t, width):
    got = _on_tensors("sawtooth", t * 5, width, phase=15.0)
    if width <= 1:
        np.testing.assert_allclose(got, sps.sawtooth(t * 5, width),
                                   atol=1e-12)
    else:
        assert np.isnan(got).all()


def test_sawtooth_array_width(t):
    width = np.linspace(0, 1, t.size)
    _same(wf.sawtooth(t * 5, width), twf.sawtooth(t * 5, width))
    _same(wf.sawtooth(torch.from_numpy(t * 5), width),
          twf.sawtooth(t * 5, width))


@pytest.mark.parametrize("duty", [0.5, 0.2, 0.9, -0.1])
def test_square(t, duty):
    got = _on_tensors("square", t * 5, duty, phase=15.0)
    if 0 <= duty <= 1:
        np.testing.assert_allclose(got, sps.square(t * 5, duty), atol=1e-12)


@pytest.mark.parametrize("method", ["linear", "quadratic", "logarithmic",
                                    "hyperbolic"])
@pytest.mark.parametrize("f0,f1,phi", [(10, 40, 0), (40, 10, 37)])
def test_chirp(t, method, f0, f1, phi):
    got = _on_tensors("chirp", t, f0, 3, f1, method, phi=phi,
                      phase=2 * np.pi * 40 * 3)
    np.testing.assert_allclose(got, sps.chirp(t, f0, 3, f1, method, phi=phi),
                               atol=1e-9)


def test_chirp_variants(t):
    _on_tensors("chirp", t, 10, 3, 40, "quadratic", vertex_zero=False,
                phase=2 * np.pi * 40 * 3)
    _on_tensors("chirp", t, 10, 3, 10, "logarithmic",
                phase=2 * np.pi * 30)
    with pytest.raises(ValueError):
        wf.chirp(torch.from_numpy(t), 10, 3, 40, "bogus")
    with pytest.raises(ValueError):
        wf.chirp(t, -10, 3, 40, "logarithmic")
    with pytest.raises(ValueError):
        wf.chirp(t, 0, 3, 40, "hyperbolic")


@pytest.mark.parametrize("method", ["linear", "logarithmic"])
@pytest.mark.parametrize("phi", [0, 30])
def test_chirp_complex_pins_scipy(t, method, phi):
    ref = sps.chirp(t, 10, 3, 40, method, phi=phi, complex=True)
    got = wf.chirp(t, 10, 3, 40, method, phi=phi, complex=True)
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, ref, atol=1e-9)
    g64 = wf.chirp(torch.from_numpy(t), 10, 3, 40, method, phi=phi,
                   complex=True)
    assert g64.dtype == torch.complex128
    np.testing.assert_allclose(g64.numpy(), ref, atol=1e-9)
    g32 = wf.chirp(torch.from_numpy(t.astype(np.float32)), 10, 3, 40,
                   method, phi=phi, complex=True)
    assert g32.dtype == torch.complex64
    np.testing.assert_allclose(g32.numpy(), ref,
                               atol=_phase_tol(2 * np.pi * 75) + 1e-5)
    r32 = twf.chirp(jnp.asarray(t.astype(np.float32)), 10, 3, 40, method,
                    phi=phi, complex=True)
    _same(g32, np.asarray(r32), _phase_tol(2 * np.pi * 75))


@pytest.mark.parametrize("poly,phi", [
    (np.poly1d([0.05, -0.75, 2.0, 5.0]), 0), ([1.0, 2.0], 10), ([3.0], 0)])
def test_sweep_poly(t, poly, phi):
    got = _on_tensors("sweep_poly", t, poly, phi=phi,
                      phase=2 * np.pi * 30)
    np.testing.assert_allclose(got, sps.sweep_poly(t, poly, phi=phi),
                               atol=1e-9)


@pytest.mark.parametrize("kw", [{}, {"fc": 2000, "bw": 0.3, "retquad": True,
                                     "retenv": True},
                                {"retenv": True}, {"retquad": True},
                                {"fc": 500, "bwr": -3}])
def test_gausspulse(kw):
    tt = np.linspace(-0.01, 0.01, 400)
    got = _on_tensors("gausspulse", tt, phase=2 * np.pi * 20, **kw)
    ref = sps.gausspulse(tt, **kw)
    _same(got, ref, 1e-12)


def test_gausspulse_cutoff_and_errors():
    assert wf.gausspulse("cutoff") == twf.gausspulse("cutoff")
    assert abs(wf.gausspulse("cutoff", fc=3000, tpr=-40)
               - sps.gausspulse("cutoff", fc=3000, tpr=-40)) < 1e-15
    for kw in ({"fc": -1}, {"bw": 0}, {"bwr": 1}):
        with pytest.raises(ValueError):
            wf.gausspulse(np.zeros(3), **kw)
    with pytest.raises(ValueError):
        wf.gausspulse("bogus")


@pytest.mark.parametrize("shape,idx", [(10, None), (10, 3), (11, "mid"),
                                       ((3, 4), (1, 2)), ((5, 5), "mid"),
                                       ((3, 3), 2), ((2, 3, 4), 1)])
def test_unit_impulse_pins_scipy(shape, idx):
    got = wf.unit_impulse(shape, idx)
    ref = sps.unit_impulse(shape, idx)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(wf.unit_impulse(shape, idx, dtype=int),
                                  sps.unit_impulse(shape, idx, dtype=int))


@pytest.mark.parametrize("nbits", [2, 3, 5, 8, 10, 12])
def test_max_len_seq(nbits):
    seq, state = wf.max_len_seq(nbits)
    rseq, rstate = sps.max_len_seq(nbits)
    np.testing.assert_array_equal(seq, rseq)
    np.testing.assert_array_equal(state, rstate)
    _same(wf.max_len_seq(nbits, length=7, state=np.arange(nbits) % 2 + (
        np.arange(nbits) == 0)), twf.max_len_seq(
            nbits, length=7, state=np.arange(nbits) % 2 + (
                np.arange(nbits) == 0)))


def test_max_len_seq_errors():
    with pytest.raises(ValueError):
        wf.max_len_seq(40)
    with pytest.raises(ValueError):
        wf.max_len_seq(4, state=np.zeros(4))
    with pytest.raises(ValueError):
        wf.max_len_seq(4, length=-1)


def test_top_level_names_are_the_modules():
    for name in wf.__all__:
        assert getattr(tpufft_torch, name) is getattr(wf, name)

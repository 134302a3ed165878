"""tpufft_torch.backend (worker control and the scipy.fft uarray backend)
against scipy.fft and tpufft's backend: every case of the backend tests of
``tests/test_fhtlog.py``, each scipy.fft function the backend serves,
placement, and the rules for ``workers``, ``overwrite_x``, ``plan`` and
``orthogonalize``.

numpy input runs on the CPU through ``scipy_backend(device="cpu")`` and on
the CUDA device through ``scipy_backend()``, which raises here (no card)
rather than letting scipy serve the call; CPU tensors run where they lie.
Tolerance: float64 results within 1e-10 of the reference's size (scipy,
and tpufft's backend under jax's x64), complex64 tensors within 1e-5.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import tpufft
import tpufft_torch
from tpufft_torch import backend
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TOL = 1e-10
F32_TOL = 1e-5
CPU = tpufft_torch.scipy_backend(device="cpu")


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.max(np.abs(got - ref)) <= tol * max(1.0, np.max(np.abs(ref)))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_workers_context():
    assert tpufft_torch.get_workers() == 0
    with tpufft_torch.set_workers(3):
        assert tpufft_torch.get_workers() == 3
        with tpufft_torch.set_workers(-1):  # scipy's "all cores"
            assert tpufft_torch.get_workers() == 0
        assert tpufft_torch.get_workers() == 3
    assert tpufft_torch.get_workers() == 0


def test_workers_are_per_thread():
    import threading
    seen = []
    with tpufft_torch.set_workers(5):
        t = threading.Thread(target=lambda: seen.append(
            tpufft_torch.get_workers()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert tpufft_torch.get_workers() == 5
    assert seen == [0]


def test_scipy_set_backend(rng):
    """The calls of tpufft's test, numpy on the CPU, against scipy and
    tpufft's backend."""
    x = rng.standard_normal((4, 93)) + 1j * rng.standard_normal((4, 93))
    xr = rng.standard_normal((4, 50))

    def calls():
        return (sfft.fft(x, workers=2), sfft.rfft(xr, n=64),
                sfft.dct(xr, type=3, norm="ortho"), sfft.fht(xr, 0.1, mu=1.0))

    with sfft.set_backend(CPU):
        got = calls()
    with sfft.set_backend(tpufft.scipy_backend()):
        ref_tpufft = calls()
    ref = (np.fft.fft(x), np.fft.rfft(xr, n=64),
           sfft.dct(xr, type=3, norm="ortho"), sfft.fht(xr, 0.1, mu=1.0))
    for g, t, r in zip(got, ref_tpufft, ref):
        assert isinstance(g, np.ndarray)
        _close(g, r)
        _close(g, t)


def test_scipy_backend_falls_back(rng):
    """orthogonalize is semantics-changing: scipy serves it."""
    x = rng.standard_normal(32)
    with sfft.set_backend(CPU):
        y = sfft.dct(x, type=1, norm="ortho", orthogonalize=False)
    _close(y, sfft.dct(x, type=1, norm="ortho", orthogonalize=False), 1e-12)


def _c(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# every function of scipy.fft's uarray domain, with an input of its kind
SERVED = [
    ("fft", "c", ()), ("ifft", "c", ()), ("fft2", "c", ()),
    ("ifft2", "c", ()), ("fftn", "c", ()), ("ifftn", "c", ()),
    ("rfft", "r", ()), ("irfft", "c", ()), ("rfft2", "r", ()),
    ("irfft2", "c", ()), ("rfftn", "r", ()), ("irfftn", "c", ()),
    ("hfft", "c", ()), ("ihfft", "r", ()), ("hfft2", "c", ()),
    ("ihfft2", "r", ()), ("hfftn", "c", ()), ("ihfftn", "r", ()),
    ("dct", "r", ()), ("idct", "r", ()), ("dst", "r", ()),
    ("idst", "r", ()), ("dctn", "r", ()), ("idctn", "r", ()),
    ("dstn", "r", ()), ("idstn", "r", ()),
    ("fht", "r", (0.1, 0.5)), ("ifht", "r", (0.1, 0.5)),
]


@pytest.mark.parametrize("name,kind,args", SERVED, ids=[s[0] for s in SERVED])
def test_backend_serves_every_scipy_function(name, kind, args, rng):
    """numpy on the CPU through the backend equals scipy's own result and
    tpufft's backend, and is served by the port's entry point."""
    x = _c(rng, (4, 6, 16)) if kind == "c" else rng.standard_normal(
        (4, 6, 16))
    fn = getattr(sfft, name)
    with sfft.set_backend(CPU):
        got = fn(x, *args)
    with sfft.set_backend(tpufft.scipy_backend()):
        ref_tpufft = np.asarray(fn(x, *args))
    assert isinstance(got, np.ndarray)
    _close(got, fn(x, *args))
    _close(got, ref_tpufft)


def test_backend_dispatches_to_the_port(monkeypatch, rng):
    """The port's entry point of the method's name runs, with ``workers``
    as the set_workers context, ``overwrite_x`` dropped and numpy input
    placed on the backend's device."""
    seen = {}

    def spy(x, n=None, axis=-1, norm=None, **kw):
        seen.update(kw, workers=tpufft_torch.get_workers(), x=x)
        return "served"

    monkeypatch.setattr(tpufft_torch, "fft", spy)
    x = rng.standard_normal(8)
    with sfft.set_backend(CPU):
        assert sfft.fft(x, workers=3, overwrite_x=True) == "served"
    assert seen["workers"] == 3 and seen["device"] == "cpu"
    assert "overwrite_x" not in seen and seen["x"] is x
    assert tpufft_torch.get_workers() == 0
    with sfft.set_backend(tpufft_torch.scipy_backend()):
        sfft.fft(x)
    assert seen["device"] is None and seen["workers"] == 0


def test_backend_returns_not_implemented_where_tpufft_does():
    class Method:
        __name__ = "no_such_transform"

    ua = tpufft_torch.scipy_backend().__ua_function__
    assert ua(Method, (np.ones(4),), {}) is NotImplemented
    Method.__name__ = "fft"
    assert ua(Method, (np.ones(4),), {"plan": object()}) is NotImplemented
    Method.__name__ = "dct"
    assert ua(Method, (np.ones(4),), {"orthogonalize": True}) \
        is NotImplemented
    # tpufft's backend answers the same three the same way
    tua = tpufft.scipy_backend().__ua_function__
    Method.__name__ = "no_such_transform"
    assert tua(Method, (np.ones(4),), {}) is NotImplemented


def test_numpy_without_a_card_raises():
    """scipy_backend() runs numpy on the CUDA device; with none it raises
    numpy_device's error, never NotImplemented (scipy would then serve the
    call on the host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with sfft.set_backend(tpufft_torch.scipy_backend()):
        with pytest.raises(RuntimeError, match="numpy input runs on the CUDA"):
            sfft.fft(np.ones(8))
        with pytest.raises(RuntimeError, match="numpy input runs on the CUDA"):
            sfft.dct(np.ones(8))


@pytest.mark.parametrize("backend_of", [lambda: tpufft_torch.scipy_backend(),
                                        lambda: CPU], ids=["default", "cpu"])
def test_cpu_tensors_run_where_they_lie(backend_of, rng):
    """A tensor is handed over as it is and runs on its device, under
    either backend; the result is a tensor on that device."""
    x = torch.from_numpy(_c(rng, (3, 64)).astype(np.complex64))
    xr = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    with sfft.set_backend(backend_of()):
        y = sfft.fft(x, workers=2)
        yr = sfft.rfft(xr)
        yd = sfft.dct(xr, type=2)
    for got, ref in ((y, np.fft.fft(x.numpy())), (yr, np.fft.rfft(xr.numpy())),
                     (yd, sfft.dct(xr.numpy().astype(np.float64), type=2))):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        _close(got.numpy(), ref, F32_TOL)


def test_scipy_backend_objects():
    assert tpufft_torch.scipy_backend() is backend.ScipyBackend
    cpu = tpufft_torch.scipy_backend(device="cpu")
    assert cpu is tpufft_torch.scipy_backend(device=torch.device("cpu"))
    assert issubclass(cpu, backend.ScipyBackend) and cpu.device == "cpu"
    assert cpu.__ua_domain__ == "numpy.scipy.fft"


def test_exports_match_tpufft():
    from tpufft import backend as ref
    assert sorted(backend.__all__) == sorted(ref.__all__)
    assert tpufft_torch.__version__ == tpufft.__version__ == "0.4.0"

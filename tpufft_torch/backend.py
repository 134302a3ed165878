"""scipy.fft interop: worker control and the uarray backend object
(counterpart of ``tpufft/backend.py``).

- ``set_workers``/``get_workers``: scipy's thread-count context manager.
  It sets the OpenMP team of the native C++ host engine (``native``) and
  nothing else: the CUDA kernels are not host-thread-scaled. Default 0 =
  the engine's own default (all cores); a negative count means all cores,
  scipy's -1.

- ``ScipyBackend``: a ``scipy.fft.set_backend`` target. With

      import scipy.fft, tpufft_torch
      with scipy.fft.set_backend(tpufft_torch.scipy_backend()):
          scipy.fft.fft(x)            # runs through tpufft_torch

  every scipy.fft call whose name the port implements (the fft family,
  the real transforms, DCT/DST, fht) is served by the port's entry point
  of that name; unknown names return NotImplemented so that uarray falls
  back to scipy's own implementation, and so do calls with ``plan`` or
  ``orthogonalize``. ``workers`` maps to :func:`set_workers` for the call
  and ``overwrite_x`` is dropped (the port never writes in place).

Placement: uarray hands a tensor over as it is, and it runs where it lies.
numpy input runs on ``api.numpy_device(device)`` and comes back as numpy:
``scipy_backend()`` runs it on the CUDA device (and raises RuntimeError
when there is none; it is never handed back to scipy for that),
``scipy_backend(device="cpu")`` on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import threading

__all__ = ["set_workers", "get_workers", "scipy_backend", "ScipyBackend"]

_state = threading.local()


def get_workers() -> int:
    """Current worker-thread count for the native CPU engine (0 = engine
    default: one OpenMP thread per core)."""
    return getattr(_state, "workers", 0)


@contextlib.contextmanager
def set_workers(workers: int):
    """scipy.fft.set_workers analog: pin the native CPU engine's OpenMP
    team size within the context. Negative counts mean "all cores"
    (scipy's -1 convention); 0 restores the engine default."""
    workers = int(workers)
    if workers < 0:
        workers = 0  # engine default = all cores, scipy's -1 semantics
    prev = get_workers()
    _state.workers = workers
    try:
        yield
    finally:
        _state.workers = prev


class ScipyBackend:
    """uarray backend serving scipy.fft calls with tpufft_torch's entry
    points; numpy input runs on ``device`` (None: the CUDA device)."""

    __ua_domain__ = "numpy.scipy.fft"
    device = None

    @classmethod
    def __ua_function__(cls, method, args, kwargs):
        import tpufft_torch

        fn = getattr(tpufft_torch, method.__name__, None)
        if fn is None:
            return NotImplemented
        kwargs = dict(kwargs)
        workers = kwargs.pop("workers", None)
        kwargs.pop("overwrite_x", None)  # the port never writes in place
        if kwargs.pop("plan", None) is not None:
            return NotImplemented  # precomputed plans are plan_fft's job
        if kwargs.pop("orthogonalize", None) is not None:
            return NotImplemented  # semantics-changing: let scipy serve it
        with contextlib.ExitStack() as stack:
            if workers is not None:
                stack.enter_context(set_workers(workers))
            return fn(*args, device=cls.device, **kwargs)


@functools.lru_cache(maxsize=None)
def _placed_backend(device: str) -> type[ScipyBackend]:
    return type("ScipyBackend", (ScipyBackend,), {"device": device})


def scipy_backend(*, device=None) -> type[ScipyBackend]:
    """The backend object to hand to ``scipy.fft.set_backend``. numpy input
    runs on ``device``: the CUDA device when it is None."""
    if device is None:
        return ScipyBackend
    return _placed_backend(str(device))

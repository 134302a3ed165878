"""ctypes bindings for the native C++ host engine (counterpart of
``tpufft/native.py``).

The engine is ``native/tpufft_cpu.cpp``, the repository's single copy of a
host-side mixed-radix Stockham FFT with OpenMP threads and AVX-512 lane
batches. The port binds the same source and does not port it: it is a
host engine by design, the baseline that the card's kernels are held
beside. It is compiled at first use with g++ (the flags below) into
``build/tpufft_torch/``, under a name keyed by the source, the flags and
the host CPU, so that a changed source or another host never loads a
stale library; it is never written into ``tpufft/_native/``. With no
toolchain ``available()`` is False and every entry point raises
RuntimeError.

Input: a numpy array gives numpy out; a CPU tensor runs on a zero-copy
numpy view of it (conjugate and negative bits resolved, made contiguous)
and gives a CPU tensor out. A tensor on any other device raises
ValueError: the engine reads host memory, and it never copies a device
tensor to the host itself.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np
import torch

__all__ = ["available", "fft", "ifft", "fftn", "ifftn", "num_threads"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG_DIR)
_SRC_CANDIDATES = (
    # repo checkout layout
    os.path.join(_ROOT, "native", "tpufft_cpu.cpp"),
    # installed-package layout (source shipped as package data)
    os.path.join(_PKG_DIR, "native_src", "tpufft_cpu.cpp"),
)
_SRC = next((p for p in _SRC_CANDIDATES if os.path.exists(p)),
            _SRC_CANDIDATES[0])
_BUILD_DIR = os.path.join(_ROOT, "build", "tpufft_torch")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")


def _host_cpu() -> bytes:
    """The CPU's model and feature flags, which ``-march=native`` compiles
    for (empty where /proc/cpuinfo is not readable)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = (b"model name", b"flags")
    return b"\n".join(next((ln for ln in lines if ln.startswith(k)), b"")
                      for k in keep)


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(_host_cpu())
    return os.path.join(_BUILD_DIR, f"libtpufft_cpu_{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    """Compile the engine unless a library for this source, these flags and
    this CPU exists; its path, or None without a source or a toolchain."""
    if not os.path.exists(_SRC):
        return None
    out = _lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)  # atomic: a concurrent build never sees a half file
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64, i32, dbl = ctypes.c_int64, ctypes.c_int, ctypes.c_double
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, ptr in (("tpufft_fft_strided_f32", f32p),
                      ("tpufft_fft_strided_f64", f64p)):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i32, dbl,
                       i32]
    for name, ptr in (("tpufft_fft_nd_f32", f32p),
                      ("tpufft_fft_nd_f64", f64p)):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, i64p, i32, i32, dbl, i32]
    for name, ptr in (("tpufft_split_c2p_f32", f32p),
                      ("tpufft_split_c2p_f64", f64p),
                      ("tpufft_combine_p2c_f32", f32p),
                      ("tpufft_combine_p2c_f64", f64p)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = i32
            fn.argtypes = [ptr, ptr, ptr, i64, i32]
    for name, ptr in (("tpufft_fft_c64", f32p),
                      ("tpufft_fft_c128", f64p)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = i32
            fn.argtypes = [ptr, ptr, i64, i64, i64, i64, i32, dbl, i32]
    for name, ptr in (("tpufft_fft_c2p_f32", f32p),
                      ("tpufft_fft_c2p_f64", f64p)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = i32
            fn.argtypes = [ptr, ptr, ptr, i64, i64, i32, dbl, i32]
    for name, ptr in (("tpufft_fft_nd_skipminor_f32", f32p),
                      ("tpufft_fft_nd_skipminor_f64", f64p)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = i32
            fn.argtypes = [ptr, ptr, i64p, i32, i32, dbl, i32]
    lib.tpufft_num_threads.restype = i32
    lib.tpufft_num_threads.argtypes = []
    return lib


def available() -> bool:
    return _lib() is not None


def num_threads() -> int:
    lib = _lib()
    return int(lib.tpufft_num_threads()) if lib else 0


def _host(x):
    """``x`` as a host numpy array, and whether it came as a tensor. A CPU
    tensor becomes a zero-copy view where it is contiguous with no
    conjugate or negative bit; a tensor on another device raises."""
    if not isinstance(x, torch.Tensor):
        return x, False
    if x.device.type != "cpu":
        raise ValueError(
            f"the native engine is a host engine: got a tensor on "
            f"{x.device}; it does not copy device tensors to the host (move "
            "the tensor to the CPU, or run the device transform)")
    x = x.detach().resolve_conj().resolve_neg()
    if x.dtype == torch.bfloat16:
        x = x.float()  # numpy has no bfloat16
    return x.contiguous().numpy(), True


def _out(a: np.ndarray, as_tensor: bool):
    return torch.from_numpy(a) if as_tensor else a


_POOL: dict[tuple, list[np.ndarray]] = {}
_POOL_CAP_BYTES = 4 << 30


def _scratch(shape, dtype) -> np.ndarray:
    """Reusable intermediate plane (input/output re/im). Fresh 400MB-class
    np.empty buffers cost ~150 ms of first-touch page faults PER BUFFER on
    every call (glibc munmaps them on free); recycling them across calls
    keeps the pages warm. Only internal planes use the pool — arrays
    returned to the caller are always freshly allocated."""
    key = (tuple(shape), np.dtype(dtype).str)
    lst = _POOL.get(key)
    if lst:
        return lst.pop()
    return np.empty(shape, dtype)


def _recycle(*arrays: np.ndarray) -> None:
    total = sum(sum(a.nbytes for a in lst) for lst in _POOL.values())
    for a in arrays:
        if total + a.nbytes > _POOL_CAP_BYTES:
            continue
        _POOL.setdefault((a.shape, a.dtype.str), []).append(a)
        total += a.nbytes


def _planes(x: np.ndarray, dtype, nthreads: int = 0):
    x = np.asarray(x)
    dtype = np.dtype(dtype)
    if np.issubdtype(x.dtype, np.complexfloating):
        # Same-width contiguous complex: ONE fused C pass (the numpy
        # .real/.imag route is two strided passes).
        lib = _lib()
        want = np.complex64 if dtype == np.float32 else np.complex128
        f32 = dtype == np.float32
        fn = getattr(lib, "tpufft_split_c2p_f32" if f32
                     else "tpufft_split_c2p_f64", None) \
            if lib is not None else None
        if (fn is not None and x.dtype == want and x.size
                and x.flags["C_CONTIGUOUS"]):
            re = _scratch(x.shape, dtype)
            im = _scratch(x.shape, dtype)
            cptr = ctypes.POINTER(ctypes.c_float if f32
                                  else ctypes.c_double)
            fn(x.ctypes.data_as(cptr), re.ctypes.data_as(cptr),
               im.ctypes.data_as(cptr), x.size, _threads(nthreads))
            return re, im, True
        return (np.ascontiguousarray(x.real, dtype),
                np.ascontiguousarray(x.imag, dtype), False)
    return (np.ascontiguousarray(x, dtype), np.zeros(x.shape, dtype), False)


def _combine(re: np.ndarray, im: np.ndarray,
             nthreads: int = 0) -> np.ndarray:
    f32 = re.dtype == np.float32
    out = np.empty(re.shape, np.complex64 if f32 else np.complex128)
    lib = _lib()
    fn = getattr(lib, "tpufft_combine_p2c_f32" if f32
                 else "tpufft_combine_p2c_f64", None) \
        if lib is not None else None
    if fn is not None and re.size and re.flags["C_CONTIGUOUS"] \
            and im.flags["C_CONTIGUOUS"]:
        cptr = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
        fn(re.ctypes.data_as(cptr), im.ctypes.data_as(cptr),
           out.ctypes.data_as(cptr), re.size, _threads(nthreads))
        return out
    out.real, out.imag = re, im
    return out


def _norm_scale(norm, n_total, inverse):
    from .api import _norm_scale as _ns
    return _ns(norm, n_total, inverse)


def _threads(nthreads: int) -> int:
    """Explicit nthreads wins; otherwise the set_workers() context value
    (0 = OpenMP runtime default, all cores)."""
    if nthreads:
        return int(nthreads)
    from .backend import get_workers
    return get_workers()


def fft(x, *, inverse: bool = False, norm=None, dtype=np.float32,
        nthreads: int = 0):
    """Batched 1D C2C along the last axis (native CPU engine)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native engine unavailable (no g++?)")
    x, as_tensor = _host(x)
    dtype = np.dtype(dtype)
    # Interleaved fast path: numpy complex in/out straight through the
    # engine's lane-batch gather/scatter — no plane conversion passes.
    want = np.complex64 if dtype == np.float32 else np.complex128
    xa = np.asarray(x)
    if xa.ndim >= 1 and (xa.size == 0 or 0 in xa.shape):
        raise ValueError(f"zero-length axis in shape {xa.shape}")
    if (xa.dtype == want and xa.flags["C_CONTIGUOUS"] and xa.ndim >= 1
            and xa.shape[-1] >= 1):
        n = xa.shape[-1]
        count = xa.size // n
        f32 = dtype == np.float32
        cfn = getattr(lib, "tpufft_fft_c64" if f32 else "tpufft_fft_c128",
                      None)
        if cfn is not None:
            out = np.empty(xa.shape, want)
            cptr = ctypes.POINTER(ctypes.c_float if f32
                                  else ctypes.c_double)
            scale = _norm_scale(norm, n, inverse)
            rc = cfn(xa.ctypes.data_as(cptr), out.ctypes.data_as(cptr),
                     count, n, n, n, int(inverse), float(scale),
                     _threads(nthreads))
            if rc == 0:
                return _out(out, as_tensor)
            if rc != 2:  # 2 = shape not lane-batch eligible: fall back
                raise RuntimeError(f"native fft failed (rc={rc})")
    re, im, pooled = _planes(x, dtype, nthreads)
    n = re.shape[-1]
    count = re.size // n
    out_re = _scratch(re.shape, dtype)
    out_im = _scratch(im.shape, dtype)
    fn = (lib.tpufft_fft_strided_f32 if dtype == np.float32
          else lib.tpufft_fft_strided_f64)
    cptr = ctypes.POINTER(ctypes.c_float if dtype == np.float32
                          else ctypes.c_double)
    scale = _norm_scale(norm, n, inverse)
    rc = fn(re.ctypes.data_as(cptr), im.ctypes.data_as(cptr),
            out_re.ctypes.data_as(cptr), out_im.ctypes.data_as(cptr),
            count, n, 1, n, n, int(inverse), float(scale), _threads(nthreads))
    if rc:
        raise RuntimeError(f"native fft failed (rc={rc})")
    out = _combine(out_re, out_im, nthreads)
    _recycle(out_re, out_im, *((re, im) if pooled else ()))
    return _out(out, as_tensor)


def ifft(x, **kw):
    kw.setdefault("norm", "backward")
    return fft(x, inverse=True, **kw)


def fftn(x, *, inverse: bool = False, norm=None, dtype=np.float32,
         nthreads: int = 0):
    """ND C2C over all axes except axis 0 (the batch axis)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native engine unavailable (no g++?)")
    x, as_tensor = _host(x)
    dtype = np.dtype(dtype)
    f32 = dtype == np.float32
    cptr = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    xa = np.asarray(x)
    want = np.complex64 if f32 else np.complex128
    n_total = int(np.prod(xa.shape[1:]))
    scale = _norm_scale(norm, n_total, inverse)
    # Interleaved fast path: the minor-axis pass reads the complex input
    # directly (deinterleave fused into the gather), the remaining axes
    # run in place on pooled planes — saves the split pass AND the
    # nd-entry's initial plane copy.
    if xa.size == 0 or 0 in xa.shape:
        raise ValueError(f"zero-length axis in shape {xa.shape}")
    if (xa.dtype == want and xa.flags["C_CONTIGUOUS"] and xa.ndim >= 3):
        c2p = getattr(lib, "tpufft_fft_c2p_f32" if f32
                      else "tpufft_fft_c2p_f64", None)
        ndsm = getattr(lib, "tpufft_fft_nd_skipminor_f32" if f32
                       else "tpufft_fft_nd_skipminor_f64", None)
        if c2p is not None and ndsm is not None:
            n = xa.shape[-1]
            re = _scratch(xa.shape, dtype)
            im = _scratch(xa.shape, dtype)
            rc = c2p(xa.ctypes.data_as(cptr), re.ctypes.data_as(cptr),
                     im.ctypes.data_as(cptr), xa.size // n, n,
                     int(inverse), 1.0, _threads(nthreads))
            if rc == 2:
                # not lane-batch eligible: hand the planes back to the
                # pool before the general path re-allocates them
                _recycle(re, im)
            elif rc == 0:
                dims = np.asarray(xa.shape, np.int64)
                rc = ndsm(re.ctypes.data_as(cptr), im.ctypes.data_as(cptr),
                          dims.ctypes.data_as(i64p), len(dims),
                          int(inverse), float(scale), _threads(nthreads))
                if rc:
                    raise RuntimeError(f"native fftn failed (rc={rc})")
                out = _combine(re, im, nthreads)
                _recycle(re, im)
                return _out(out, as_tensor)
            else:
                raise RuntimeError(f"native fftn failed (rc={rc})")
    re, im, pooled = _planes(x, dtype, nthreads)
    dims = np.asarray(re.shape, np.int64)
    fn = lib.tpufft_fft_nd_f32 if f32 else lib.tpufft_fft_nd_f64
    if pooled:
        # planes are disposable scratch: transform in place (the nd entry
        # skips its initial copy when in == out)
        out_re, out_im = re, im
    else:
        out_re = _scratch(re.shape, dtype)
        out_im = _scratch(im.shape, dtype)
    rc = fn(re.ctypes.data_as(cptr), im.ctypes.data_as(cptr),
            out_re.ctypes.data_as(cptr), out_im.ctypes.data_as(cptr),
            dims.ctypes.data_as(i64p),
            len(dims), int(inverse), float(scale), _threads(nthreads))
    if rc:
        raise RuntimeError(f"native fftn failed (rc={rc})")
    out = _combine(out_re, out_im, nthreads)
    _recycle(out_re, out_im)
    return _out(out, as_tensor)


def ifftn(x, **kw):
    kw.setdefault("norm", "backward")
    return fftn(x, inverse=True, **kw)


def _canon_planes(re, im):
    """Normalize a plane pair for the C ABI: matching shapes, contiguous,
    and exactly float32 or float64 (anything else — f16, ints — would be
    reinterpreted byte-wise by the wrong-width engine entry point)."""
    re = np.asarray(re)
    if re.dtype not in (np.float32, np.float64):
        re = re.astype(np.float64)
    re = np.ascontiguousarray(re)
    im = np.ascontiguousarray(np.asarray(im), re.dtype)
    if im.shape != re.shape:
        raise ValueError(
            f"re/im plane shapes differ: {re.shape} vs {im.shape}")
    return re, im


def fft_planes(re, im, *, inverse: bool = False, norm=None,
               nthreads: int = 0):
    """Batched 1D C2C on pre-split contiguous planes (the engine's native
    data model — no complex<->planes conversion passes). Returns (re, im),
    tensors when ``re`` is a tensor."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native engine unavailable (no g++?)")
    (re, as_tensor), (im, _) = _host(re), _host(im)
    re, im = _canon_planes(re, im)
    n = re.shape[-1]
    count = re.size // n
    out_re = np.empty_like(re)
    out_im = np.empty_like(im)
    f32 = re.dtype == np.float32
    fn = lib.tpufft_fft_strided_f32 if f32 else lib.tpufft_fft_strided_f64
    cptr = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    scale = _norm_scale(norm, n, inverse)
    rc = fn(re.ctypes.data_as(cptr), im.ctypes.data_as(cptr),
            out_re.ctypes.data_as(cptr), out_im.ctypes.data_as(cptr),
            count, n, 1, n, n, int(inverse), float(scale), _threads(nthreads))
    if rc:
        raise RuntimeError(f"native fft failed (rc={rc})")
    return _out(out_re, as_tensor), _out(out_im, as_tensor)


def fftn_planes(re, im, *, inverse: bool = False, norm=None,
                nthreads: int = 0):
    """ND C2C over all axes except axis 0, on pre-split planes."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native engine unavailable (no g++?)")
    (re, as_tensor), (im, _) = _host(re), _host(im)
    re, im = _canon_planes(re, im)
    dims = np.asarray(re.shape, np.int64)
    out_re = np.empty_like(re)
    out_im = np.empty_like(im)
    f32 = re.dtype == np.float32
    fn = lib.tpufft_fft_nd_f32 if f32 else lib.tpufft_fft_nd_f64
    cptr = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    n_total = int(np.prod(dims[1:]))
    scale = _norm_scale(norm, n_total, inverse)
    rc = fn(re.ctypes.data_as(cptr), im.ctypes.data_as(cptr),
            out_re.ctypes.data_as(cptr), out_im.ctypes.data_as(cptr),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(dims), int(inverse), float(scale), _threads(nthreads))
    if rc:
        raise RuntimeError(f"native fftn failed (rc={rc})")
    return _out(out_re, as_tensor), _out(out_im, as_tensor)

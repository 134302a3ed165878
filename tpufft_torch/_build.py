"""Build and load the port's CUDA sources.

Each ``tpufft_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library goes
to ``build/tpufft_torch/`` beside the package, named by a hash of the
sources and flags, so an unchanged checkout builds once and a changed
source never loads a stale library. Nothing here runs at import: the first
CUDA launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load"]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpufft_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)


def _nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda/bin."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of tpufft_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for this exact source hash
    exists; returns the library's path. nvcc's output (ptxas's resource
    report) is kept beside it, with the suffix ``.log``."""
    out = _BUILD_DIR / f"libtpufft_torch_{_digest()}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    for src in sorted(_SRC_DIR.glob("*.cu")):
        obj = tmp.with_name(f"{src.stem}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        sink = open(obj.with_suffix(".out"), "w+")
        jobs.append((cmd, obj, sink, subprocess.Popen(
            cmd, stdout=sink, stderr=subprocess.STDOUT, text=True)))
    # each source's time to its object, polled (the outputs go to files,
    # so a long ptxas report never blocks its process)
    took = {}
    while len(took) < len(jobs):
        for cmd, obj, _, proc in jobs:
            if obj not in took and proc.poll() is not None:
                took[obj] = time.perf_counter() - t0
        time.sleep(0.05)
    log = []
    for cmd, obj, sink, proc in jobs:
        sink.seek(0)
        text = sink.read()
        sink.close()
        os.remove(sink.name)
        log.append(text)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    log.extend(f"nvcc {obj.stem.rsplit('.', 1)[0]}.cu: {took[obj]:.1f} s\n"
               for _, obj, _, _ in jobs)
    objs = [str(obj) for _, obj, _, _ in jobs]
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text("".join(log) + proc.stdout
                                       + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a half file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tpufft_minor_fft.argtypes = [
        vp, vp, vp, vp, vp,          # xr, xi, yr, yi, twiddle table
        ctypes.c_longlong, i32, i32,  # batch, n, n_in
        ctypes.POINTER(i32), i32,    # radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_minor_fft.restype = i32
    lib.tpufft_minor_fft_stages.argtypes = lib.tpufft_minor_fft.argtypes
    lib.tpufft_minor_fft_stages.restype = i32
    lib.tpufft_minor_line_geometry.argtypes = [
        i32, ctypes.POINTER(i32),    # n; out: the four-step's 9 parameters
    ]
    lib.tpufft_minor_line_geometry.restype = i32
    lib.tpufft_strided_fft.argtypes = [
        vp, vp, vp, vp, vp,          # xr, xi, yr, yi, twiddle table
        ctypes.c_longlong, i32,      # pre, n
        ctypes.c_longlong,           # post
        ctypes.POINTER(i32), i32,    # radices, number of stages
        vp, i32, ctypes.c_longlong,  # (n, M) twiddle or None, M, L
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_strided_fft.restype = i32
    lib.tpufft_strided_fft_stages.argtypes = lib.tpufft_strided_fft.argtypes
    lib.tpufft_strided_fft_stages.restype = i32
    lib.tpufft_strided_fft_swapped.argtypes = [
        *lib.tpufft_strided_fft.argtypes[:-1],
        i32, vp,                     # stages, cudaStream_t
    ]
    lib.tpufft_strided_fft_swapped.restype = i32
    lib.tpufft_pair_fft.argtypes = [
        vp, vp, vp, vp, vp, vp,      # xr, xi, yr, yi, n1 and n2 tables
        ctypes.c_longlong, i32, i32, i32,  # pre, n1, n2, n2_in
        ctypes.POINTER(i32), i32,    # n1's radices, number of stages
        ctypes.POINTER(i32), i32,    # n2's radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_pair_fft.restype = i32
    lib.tpufft_cube_fft.argtypes = [
        vp, vp, vp, vp,              # xr, xi, yr, yi
        vp, vp, vp,                  # n1, n2 and n3 tables
        ctypes.c_longlong, i32, i32, i32, i32,  # pre, n1, n2, n3, cluster
        ctypes.POINTER(i32), i32,    # n1's radices, number of stages
        ctypes.POINTER(i32), i32,    # n2's radices, number of stages
        ctypes.POINTER(i32), i32,    # n3's radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_cube_fft.restype = i32
    lib.tpufft_cube_active_clusters.argtypes = [
        i32, i32, i32, i32, i32,     # n1, n2, n3, cluster, bf16 storage
        ctypes.POINTER(i32),         # out: clusters the card holds at once
    ]
    lib.tpufft_cube_active_clusters.restype = i32
    # the fused-storage forms (K16-K20): one input and one output array
    # whose rows of the minor logical axis hold [re | im]
    lib.tpufft_minor_fft_fused.argtypes = [
        vp, vp, vp,                  # st, out, twiddle table
        ctypes.c_longlong, i32,      # batch, n
        ctypes.POINTER(i32), i32,    # radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_minor_fft_fused.restype = i32
    lib.tpufft_strided_fft_fused.argtypes = [
        vp, vp, vp,                  # st, out, twiddle table
        ctypes.c_longlong, i32,      # pre, n
        ctypes.c_longlong, ctypes.c_longlong,  # M, L (the half)
        ctypes.POINTER(i32), i32,    # radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_strided_fft_fused.restype = i32
    lib.tpufft_strided_line_geometry.argtypes = [
        i32, ctypes.c_longlong, i32,  # n, post, bf16 storage
        ctypes.POINTER(i32),         # out: N1, N2, C, threads, smem bytes
    ]                                # (cluster form: N3, Q too)
    lib.tpufft_strided_line_geometry.restype = i32
    lib.tpufft_pair_fft_fused.argtypes = [
        vp, vp, vp, vp,              # st, out, n1 and n2 tables
        ctypes.c_longlong, i32, i32,  # pre, n1, n2
        ctypes.POINTER(i32), i32,    # n1's radices, number of stages
        ctypes.POINTER(i32), i32,    # n2's radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_pair_fft_fused.restype = i32
    lib.tpufft_cube_fft_fused.argtypes = [
        vp, vp,                      # st, out
        vp, vp, vp,                  # n1, n2 and n3 tables
        ctypes.c_longlong, i32, i32, i32, i32,  # pre, n1, n2, n3, cluster
        ctypes.POINTER(i32), i32,    # n1's radices, number of stages
        ctypes.POINTER(i32), i32,    # n2's radices, number of stages
        ctypes.POINTER(i32), i32,    # n3's radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_cube_fft_fused.restype = i32
    lib.tpufft_cube_fused_active_clusters.argtypes = [
        i32, i32, i32, i32, i32,     # n1, n2, n3, cluster, bf16 storage
        ctypes.POINTER(i32),         # out: clusters the card holds at once
    ]
    lib.tpufft_cube_fused_active_clusters.restype = i32
    lib.tpufft_mid_pair_fft.argtypes = [
        vp, vp, vp, vp, vp, vp,      # xr, xi, yr, yi, n1 and n2 tables
        ctypes.c_longlong, i32, i32,  # pre, n1, n2
        ctypes.c_longlong, i32, i32,  # L, lanes a tile, cluster
        ctypes.POINTER(i32), i32,    # n1's radices, number of stages
        ctypes.POINTER(i32), i32,    # n2's radices, number of stages
        i32, ctypes.c_float, i32,    # inverse, scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_mid_pair_fft.restype = i32
    lib.tpufft_mid_pair_active_clusters.argtypes = [
        i32, i32, i32, i32, i32,     # n1, n2, lanes, cluster, bf16 storage
        ctypes.POINTER(i32),         # out: clusters the card holds at once
    ]
    lib.tpufft_mid_pair_active_clusters.restype = i32
    lib.tpufft_rfft.argtypes = [
        vp, vp, vp,                  # x, yr, yi
        vp, vp,                      # stage and half-length twiddle tables
        ctypes.c_longlong, i32,      # batch, n
        ctypes.POINTER(i32), i32,    # radices, number of stages
        ctypes.c_float, i32,         # scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_rfft.restype = i32
    lib.tpufft_rfft_stages.argtypes = lib.tpufft_rfft.argtypes
    lib.tpufft_rfft_stages.restype = i32
    lib.tpufft_real_line_geometry.argtypes = [
        i32, ctypes.POINTER(i32),    # n; out: the four-step's 9 or 13
    ]
    lib.tpufft_real_line_geometry.restype = i32
    lib.tpufft_irfft.argtypes = [
        vp, vp, vp,                  # xr, xi, y
        vp, vp,                      # stage and half-length twiddle tables
        ctypes.c_longlong, i32,      # batch, n
        ctypes.POINTER(i32), i32,    # radices, number of stages
        ctypes.c_float, i32,         # scale, bf16 storage
        vp,                          # cudaStream_t
    ]
    lib.tpufft_irfft.restype = i32
    lib.tpufft_irfft_stages.argtypes = lib.tpufft_irfft.argtypes
    lib.tpufft_irfft_stages.restype = i32
    lib.tpufft_dense_mm_complex.argtypes = [
        vp, vp, vp, vp, vp,          # xr, xi, wr, wi, block table wb
        vp, vp,                      # yr, yi
        ctypes.c_longlong, i32, i32,  # batch, m_in, m_out
        i32,                         # form: 1 tf32x3 (wb), 0 fma (wr, wi)
        vp,                          # cudaStream_t
    ]
    lib.tpufft_dense_mm_complex.restype = i32
    lib.tpufft_dense_mm_real.argtypes = [
        vp, vp, vp,                  # x, w, y
        ctypes.c_longlong, i32, i32,  # batch, m_in, m_out
        i32,                         # form: 1 tf32x3, 0 fma
        vp,                          # cudaStream_t
    ]
    lib.tpufft_dense_mm_real.restype = i32
    i64 = ctypes.c_longlong
    lib.tpufft_stft_frames.argtypes = [
        vp, vp, vp, vp, vp, vp,      # x, window, cr, ci, yr, yi
        vp, vp,                      # stage and half-length twiddle tables
        i64, i64, i32, i32, i32,     # batch, n_sig, hop, nseg, nperseg
        i32, i32,                    # nfft, detrend (0, 1 constant, 2 linear)
        ctypes.POINTER(i32), i32,    # radices, number of stages
        i32, vp,                     # bf16 storage, cudaStream_t
    ]
    lib.tpufft_stft_frames.restype = i32
    lib.tpufft_istft_ola.argtypes = [
        vp, vp, vp, vp, vp,          # zr, zi, ar, ai, out
        i64, i32, i32, i32, i32,     # batch, nseg, hop, nperseg, m1
        i32, vp,                     # bf16 storage, cudaStream_t
    ]
    lib.tpufft_istft_ola.restype = i32
    lib.tpufft_istft_frames.argtypes = [
        vp, vp, vp, vp, vp,          # zr, zi, window, cr, ci
        vp, vp,                      # inverse w_m and half-length tables
        vp, vp, vp,                  # ar, ai (the dense body's; or None), out
        i64, i32, i32, i32, i32,     # batch, nseg, hop, nperseg, nfft
        i32, vp,                     # bf16 storage, cudaStream_t
    ]
    lib.tpufft_istft_frames.restype = i32
    lib.tpufft_istft_line_form.argtypes = [i32]   # nfft
    lib.tpufft_istft_line_form.restype = i32
    lib.tpufft_welch_partial_floats.argtypes = [
        i64, i32, i32, i32, i32,     # batch, hop, nseg, nperseg, nfft
        i32, i32,                    # cross, bf16 storage
    ]
    lib.tpufft_welch_partial_floats.restype = i64
    lib.tpufft_welch_frames.argtypes = [
        vp, vp, vp, vp, vp, vp,      # x, y, window, partials, outr, outi
        vp, vp,                      # stage and half-length twiddle tables
        i64, i64, i32, i32, i32,     # batch, n_sig, hop, nseg, nperseg
        i32, i32,                    # nfft, detrend (0, 1 constant, 2 linear)
        ctypes.POINTER(i32), i32,    # radices, number of stages
        i32, i32, vp,                # cross, bf16 storage, cudaStream_t
    ]
    lib.tpufft_welch_frames.restype = i32
    return lib

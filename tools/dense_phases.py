"""Where the time of the dense kernels' tensor-core bodies goes (K11,
K12: ``dense_mm_tf32x3_kernel``; K10: ``dense_mm_complex_tf32x3_kernel``),
on the card.

Run from the repository root on a machine with the GPU:

    python3 tools/dense_phases.py

It compiles patched copies of ``tpufft_torch/csrc/dense_mm.cu`` and
``tf32x3_mm.cuh`` into ``build/dense_phases/`` (one ``nvcc`` each, in
parallel, each a library of the dense source alone), and times
``tpufft_dense_mm_real`` with the tensor-core body on K11's shape,
(100000, 512) x (512, 512), and K12's, (100000, 1024) x (1024, 1024), f32
(CUDA events, median of 20; the results of the patched copies are wrong
by design), and ``tpufft_dense_mm_complex`` with the tensor-core body on
K10's shape, (100000, 512) x (512, 512) c64 planes (the block product
(100000, 1024) x (1024, 1024)), beside its FMA body:

- ``full``: the kernel as it is;
- ``no_split``: the operands stored as they are (big = v, small = 0): the
  split's integer and float work gone, everything else kept;
- ``copies_only``: no products and no split (only each stage's first
  fragment loads stay): the cp.async ring, its barriers and the zero
  stores;
- ``no_flush``: the products accumulated straight into the tile's sums
  instead of a partial sum added once a stage (and its error against
  SGEMM: the tensor cores' truncating accumulation);
- ``stages3``: a ring of three stages instead of four.

Then ``torch.matmul`` (SGEMM, TF32 off; CGEMM for K10) on the same
operands. Every line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from tpufft_torch import _build  # noqa: E402

CSRC = "tpufft_torch/csrc"
OUT = "build/dense_phases"
SPLIT = ("  big = u & keep;\n"
         "  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;\n")
KLOOP = "    for (int k = 0; k < kBK; k += 8) {\n      uint32_t a_big"
STAGES = "constexpr int kTcStages = 4;\n"
FLUSH = "        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];\n"


def variants() -> dict:
    """name -> {file name: patched text}."""
    core = open(f"{CSRC}/tf32x3_mm.cuh").read()
    dense = open(f"{CSRC}/dense_mm.cu").read()
    for text, mark in ((core, SPLIT), (core, KLOOP), (core, FLUSH),
                       (dense, STAGES)):
        assert text.count(mark) == 1, f"marker not unique: {mark!r}"
    no_split = core.replace(SPLIT, "  big = u;\n  small = 0u;\n  (void)keep;\n")
    copies = core.replace(KLOOP, KLOOP.replace("k < kBK", "k < 0"))
    no_flush = core.replace("mma(part[i][j],", "mma(acc[i][j],").replace(
        FLUSH, "        for (int q = 0; q < 4; ++q) {}\n")
    return {
        "full": {},
        "no_split": {"tf32x3_mm.cuh": no_split},
        "copies_only": {"tf32x3_mm.cuh": copies},
        "no_flush": {"tf32x3_mm.cuh": no_flush},
        "stages3": {"dense_mm.cu": dense.replace(
            STAGES, STAGES.replace("4", "3"))},
    }


def build_all(vs: dict) -> dict:
    """One nvcc per variant, all started together; name -> library path."""
    nvcc = _build._nvcc()
    jobs = {}
    for name, patch in vs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f in ("dense_mm.cu", "tf32x3_mm.cuh", "tile_mm.cuh"):
            if f in patch:
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(patch[f])
            else:
                shutil.copy(os.path.join(CSRC, f), d)
        lib = os.path.join(d, "libdense.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib,
               os.path.join(d, "dense_mm.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: ptxas (dense kernels in source order): "
              + " | ".join(regs))
        libs[name] = lib
    return libs


def median_ms(fn, reps: int = 20) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tools/dense_phases.py needs the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    libs = build_all(variants())
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for n in (512, 1024):
        x = torch.randn(100000, n, generator=g, device="cuda")
        w = torch.randn(n, n, generator=g, device="cuda")
        y = torch.empty(100000, n, device="cuda")
        ref = x @ w
        times = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(os.path.abspath(path))
            fn = lib.tpufft_dense_mm_real
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i32, i32, i32, vp]
            fn.restype = i32
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                         x.shape[0], n, n, 1, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            times[name] = median_ms(run)
            if name in ("full", "no_flush", "stages3"):
                e = ((y - ref).abs().max() / ref.abs().max()).item()
                times[name + " err"] = e
        times["torch.matmul"] = median_ms(lambda: x @ w)
        print(f"({x.shape[0]}, {n}) x ({n}, {n}) f32 on {card}, median of 20 "
              "ms: " + ", ".join(f"{k} {v:.4g}" for k, v in times.items()))
        del x, w, y, ref
    # K10: the complex planes on the block table, each variant's tensor-core
    # body and the full library's FMA body
    n = 512
    xr, xi, wr, wi = (torch.randn(*shape, generator=g, device="cuda")
                      for shape in ((100000, n), (100000, n), (n, n), (n, n)))
    wb = torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)])
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    xc, wc = torch.complex(xr, xi), torch.complex(wr, wi)
    ref = xc @ wc
    times = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(os.path.abspath(path))
        fn = lib.tpufft_dense_mm_complex
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ctypes.c_longlong, i32, i32, i32, vp]
        fn.restype = i32
        stream = torch.cuda.current_stream().cuda_stream
        for form in ((1, 0) if name == "full" else (1,)):
            def run():
                err = fn(xr.data_ptr(), xi.data_ptr(), wr.data_ptr(),
                         wi.data_ptr(), wb.data_ptr(), yr.data_ptr(),
                         yi.data_ptr(), xr.shape[0], n, n, form, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            key = name if form == 1 else "fma_body"
            times[key] = median_ms(run)
            if key in ("full", "fma_body", "no_flush", "stages3"):
                e = (torch.complex(yr, yi) - ref).abs().max() / \
                    ref.abs().max()
                times[key + " err"] = e.item()
    times["torch.matmul"] = median_ms(lambda: xc @ wc)
    print(f"K10 ({xr.shape[0]}, {n}) x ({n}, {n}) c64 on {card}, median of "
          "20 ms: " + ", ".join(f"{k} {v:.4g}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

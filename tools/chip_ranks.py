"""One rank of chip_smoke.py's phase 27: ``tpufft_torch.parallel`` on the
card, in a world of processes that all drive cuda:0.

    python3 tools/chip_ranks.py RANK WORLD BACKEND STORE_FILE OUT_DIR

WORLD 1 with BACKEND nccl runs the d = 1 paths (``fft_distributed``,
``filter_distributed``, ``rfft_distributed`` + ``irfft_distributed`` on a
(4, 2**24) input); WORLD 4 with BACKEND gloo runs those at d = 4 plus
``permuted_out`` -> ``permuted_in``, the all-gather fallback at
n = 4 * 3**12, ``fftn_distributed(axes=(1, 2), dist_axis=2)`` on
(8, 1024, 4096) and ``fft_batch_sharded`` on (128, 640, 480) blocked on
the batch. The card has one GPU and NCCL refuses two ranks on one GPU, so
the d = 4 world uses gloo, whose collectives take CUDA tensors by staging
them through the host; if gloo refuses a CUDA tensor here, the rank
records the error and runs its blocks on the CPU instead (the route is
written to the output).

Each rank makes the global inputs on its device from seeds
(:func:`global_inputs`, the same numbers in the parent), takes its block
by the block rule, and for each path: one counted call (every kernel
counter set to 0 just before and read just after, its calls of
``parallel._a2a`` and ``parallel._all_gather``, its peak device memory
above what was allocated before it), the median of 5 CUDA-event times
after that call, and one instrumented call whose local FFTs
(``parallel.fft_axis`` and the local plans) and collectives are each
synchronized and timed on the host clock. It writes its output blocks (on
the host, for the parent's check) and those numbers to
``OUT_DIR/rank<RANK>.pt``. Imports only torch, numpy and tpufft_torch.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

N = 1 << 24
ROWS = 4
GATHER_N = 4 * 3 ** 12          # 4 | n, 16 does not: the all-gather body
FFTN_SHAPE = (8, 1024, 4096)    # dist_axis 2
BATCH_SHAPE = (128, 640, 480)   # blocked on axis 0
REPS = 5


def global_inputs(device) -> dict:
    """The global inputs, made on ``device`` from seeds: c64 planes
    (x: (4, 2**24), gather: (4, 4*3**12), fftn: (8, 1024, 4096), batch:
    (128, 640, 480))."""
    out = {}
    for seed, (name, shape) in enumerate((
            ("x", (ROWS, N)), ("gather", (ROWS, GATHER_N)),
            ("fftn", FFTN_SHAPE), ("batch", BATCH_SHAPE))):
        g = torch.Generator(device=device).manual_seed(2700 + seed)
        out[name] = tuple(torch.randn(shape, generator=g, device=device)
                          for _ in range(2))
    return out


def response() -> np.ndarray:
    """filter_distributed's H: a seeded complex128 response of length N."""
    rng = np.random.default_rng(2710)
    return rng.standard_normal(N) + 1j * rng.standard_normal(N)


def block(t: torch.Tensor, axis: int, d: int, r: int) -> torch.Tensor:
    m = t.shape[axis]
    c = -(-m // d)
    return t.narrow(axis, min(r * c, m), min((r + 1) * c, m) - min(r * c, m))


def _kernels():
    from tpufft_torch.kernels import (cube_fft, dense_mm, fused_fft,
                                      inner_fft, mid_pair_fft, minor_fft,
                                      pair_fft, real_fft, stft_mm)
    return (minor_fft, inner_fft, pair_fft, real_fft, dense_mm, stft_mm,
            cube_fft, mid_pair_fft, fused_fft)


def counts() -> tuple[dict, int]:
    """Launches per kernel (chip_smoke's names) and plain-version runs on
    CUDA tensors."""
    (minor_fft, inner_fft, pair_fft, real_fft, dense_mm, stft_mm, cube_fft,
     mid_pair_fft, fused_fft) = mods = _kernels()
    launched = {"minor": minor_fft.launches, **inner_fft.launches,
                "pair": pair_fft.launches, **real_fft.launches,
                "minor_padded": minor_fft.padded_launches,
                "pair_padded": pair_fft.padded_launches, **dense_mm.launches,
                **stft_mm.launches, "cube": cube_fft.launches,
                "mid_pair": mid_pair_fft.launches,
                **{f"fused_{k}": v for k, v in fused_fft.launches.items()}}
    return launched, sum(m.reference_cuda_calls for m in mods)


def reset_counts() -> None:
    for m in _kernels():
        m.reset_counts()


class Timers:
    """Counts parallel's collectives; when ``on``, synchronizes and times
    each collective and each local FFT on the host clock."""

    def __init__(self, parallel, device):
        self.device = device
        self.on = False
        self.calls = {"a2a": 0, "gather": 0}
        self.ms = {"fft": 0.0, "exchange": 0.0}
        for name, key, kind in (("_a2a", "a2a", "exchange"),
                                ("_all_gather", "gather", "exchange"),
                                ("fft_axis", None, "fft")):
            setattr(parallel, name, self._wrap(getattr(parallel, name), key,
                                               kind))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _wrap(self, fn, key, kind):
        def run(*a, **k):
            if key is not None:
                self.calls[key] += 1
            if not self.on:
                return fn(*a, **k)
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self._sync()
            self.ms[kind] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def timed_local(self, fn):
        """A local plan's call, timed as an FFT when on."""
        return self._wrap(fn, None, "fft")

    def reset(self):
        self.calls.update(a2a=0, gather=0)
        self.ms.update(fft=0.0, exchange=0.0)


def _event_ms(fn, device) -> float:
    times = []
    for _ in range(REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _host(out):
    from tpufft_torch import SplitComplex
    if isinstance(out, SplitComplex):
        return torch.complex(out.re, out.im).cpu()
    return out.cpu()


def run_path(name, fn, timers, device, results) -> object:
    """One path: the counted call, its times, the instrumented call."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timers.reset()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    else:
        peak = float("nan")
    launched, plain = counts()
    calls = dict(timers.calls)
    on_card = all(t.is_cuda for t in (out if isinstance(out, tuple)
                                      else (out,)))
    ms = _event_ms(fn, device)
    timers.reset()
    timers.on = True
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    timers.on = False
    results[name] = {
        "out": _host(out), "launches": {k: v for k, v in launched.items()
                                        if v},
        "plain": plain, "a2a": calls["a2a"], "gather": calls["gather"],
        "on_card": on_card, "ms": ms, "peak_gb": peak,
        "fft_ms": timers.ms["fft"], "exchange_ms": timers.ms["exchange"],
        "instrumented_ms": wall}
    return out


def _probe_gloo_cuda(group) -> str | None:
    """None if gloo takes CUDA tensors for all_to_all_single here, else
    the error it raised."""
    import torch.distributed as dist
    x = torch.arange(4 * dist.get_world_size(group), dtype=torch.float32,
                     device="cuda")
    try:
        dist.all_to_all_single(torch.empty_like(x), x, group=group)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return f"{type(e).__name__}: {e}"
    return None


def main(argv) -> int:
    rank, world, backend, store_file, out_dir = (
        int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5])
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import tpufft_torch
    from tpufft_torch import SplitComplex
    from tpufft_torch import parallel as par

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    results: dict = {}
    route = {"backend": backend, "world": world}
    try:
        refused = _probe_gloo_cuda(None) if backend == "gloo" else None
        device = torch.device("cpu" if refused else "cuda")
        route.update(device=device.type, refused=refused)
        mesh = DeviceMesh(device.type, torch.arange(world),
                          mesh_dim_names=("sp",))
        timers = Timers(par, device)
        g = global_inputs(device)
        H = response()
        d = world

        def blk(name, axis=-1):
            return SplitComplex(*(block(p, axis, d, rank).contiguous()
                                  for p in g[name]))

        x = blk("x")
        run_path("fft_distributed", lambda: par.fft_distributed(
            x, mesh, axis_name="sp"), timers, device, results)
        run_path("filter_distributed", lambda: par.filter_distributed(
            x, mesh, axis_name="sp", response=H), timers, device, results)
        half = run_path("rfft_distributed", lambda: par.rfft_distributed(
            x.re, mesh, axis_name="sp"), timers, device, results)
        run_path("irfft_distributed", lambda: par.irfft_distributed(
            half, mesh, axis_name="sp", n=N), timers, device, results)
        del half
        if world > 1:
            spec = run_path("permuted_out", lambda: par.fft_distributed(
                x, mesh, axis_name="sp", permuted_out=True), timers, device,
                results)
            run_path("permuted_in", lambda: par.fft_distributed(
                spec, mesh, axis_name="sp", inverse=True, norm="backward",
                permuted_in=True), timers, device, results)
            del spec
            xg = blk("gather")
            run_path("gather_fallback", lambda: par.fft_distributed(
                xg, mesh, axis_name="sp"), timers, device, results)
            del xg
            xf = blk("fftn", axis=2)
            run_path("fftn_distributed", lambda: par.fftn_distributed(
                xf, mesh, axis_name="sp", axes=(1, 2), dist_axis=2), timers,
                device, results)
            del xf
            xb = blk("batch", axis=0)
            # fft_batch_sharded runs the port's local plan: time it as FFT
            plan_call = timers.timed_local(par.fft_batch_sharded)
            run_path("fft_batch_sharded", lambda: plan_call(
                xb, mesh, batch_axis_name="sp", axes=(1, 2)), timers, device,
                results)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(out_dir, f"rank{rank}.pt")
    torch.save({"results": results, "route": route,
                "version": tpufft_torch.__version__}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

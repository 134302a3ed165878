"""One rank of a gloo world on the CPU that runs every case of
``tpufft_torch.parallel`` for ``tests/test_torch_parallel.py``.

Run one process per rank, all with the same store and output paths:

    python tests/_torch_dist_ranks.py RANK WORLD STORE_FILE OUT_DIR

WORLD is 8 (the cases of ``tests/test_parallel.py`` on meshes (8,),
(2, 4) and (8, 1), as tpufft's 8 virtual devices) or 1 (a d = 1 world).
Each rank makes the global inputs from seeds (:func:`inputs`), takes its
block by the block rule (:func:`block`), runs each call and writes, to
``OUT_DIR/rank<RANK>.pkl``, every call's output block (numpy), its calls
of ``parallel._a2a`` and ``parallel._all_gather``, or the error it raised,
and the INFO lines of the ``tpufft_torch`` logger. This module imports
neither jax nor tpufft: the test holds the assembled blocks against them.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys

import numpy as np

F8, F4 = ("sp",), ("dp", "sp")


def inputs() -> dict:
    """Every case's global input, made from seeds."""
    rng = np.random.default_rng(1234)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    return {
        "natural_256": cplx(3, 256), "natural_1024": cplx(3, 1024),
        "natural_576": cplx(3, 576), "roundtrip": cplx(2, 256),
        "permuted": cplx(2, 256), "dp_sp": cplx(8, 1024),
        "ortho": cplx(2, 64), "batch_fftn": cplx(8, 12, 16),
        "fftn": cplx(3, 8, 64), "kernel": cplx(2, 256),
        "fftn_kernel": cplx(2, 16, 256), "bf16": cplx(2, 256),
        "gather": cplx(2, 1000), "n8000": cplx(1, 8000),
        "counts": cplx(2, 256), "rfft": rng.standard_normal((2, 1024)),
        "irfft_gather": np.fft.rfft(rng.standard_normal((2, 1000)), axis=-1),
        "irfft_pad": cplx(2, 5), "filter": cplx(2, 256),
        "filter_H": cplx(256),
        "filter_gather": cplx(3, 200), "filter_gather_H": cplx(200),
        "filter_single": cplx(2, 16), "filter_single_H": cplx(16),
        "batch_neg": cplx(64, 8), "f64": cplx(2, 256),
        "rfft_16": rng.standard_normal((3, 16)),
        "axis0": cplx(64, 3), "irfft_odd": np.fft.rfft(
            rng.standard_normal((2, 24)), axis=-1),
    }


def block(x: np.ndarray, axis: int, d: int, r: int) -> np.ndarray:
    """Rank r's block of ``x`` along ``axis``: [r*c, min((r+1)*c, m)),
    c = ceil(m/d)."""
    m = x.shape[axis]
    c = -(-m // d)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(min(r * c, m), min((r + 1) * c, m))
    return x[tuple(idx)]


class Recorder:
    """Runs calls with parallel's collectives counted."""

    def __init__(self, parallel):
        self.results: dict[str, dict] = {}
        self.counts = {"a2a": 0, "gather": 0}
        for name, key in (("_a2a", "a2a"), ("_all_gather", "gather")):
            orig = getattr(parallel, name)

            def counted(*a, _orig=orig, _key=key, **k):
                self.counts[_key] += 1
                return _orig(*a, **k)

            setattr(parallel, name, counted)

    def call(self, key: str, fn):
        import torch

        from tpufft_torch import SplitComplex

        self.counts.update(a2a=0, gather=0)
        try:
            out = fn()
        except (ValueError, TypeError) as e:
            self.results[key] = {"error": (type(e).__name__, str(e))}
            return None
        if isinstance(out, SplitComplex):
            arr = out.numpy()
        else:
            arr = out.detach().float().numpy() if out.dtype == torch.bfloat16 \
                else out.detach().numpy()
        self.results[key] = {"out": arr, **self.counts}
        return out


def run_world8(rank: int, rec: Recorder) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from tpufft_torch import PlanConfig, SplitComplex
    from tpufft_torch import parallel as par

    g = inputs()
    m8 = init_device_mesh("cpu", (8,), mesh_dim_names=F8)
    m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=F4)
    m81 = init_device_mesh("cpu", (8, 1), mesh_dim_names=F4)
    dp, sp4 = rank // 4, rank % 4

    def split(x, dtype=torch.float32):
        x = np.asarray(x)
        return SplitComplex(torch.tensor(x.real, dtype=dtype),
                            torch.tensor(x.imag, dtype=dtype))

    def on8(name, dtype=torch.float32, axis=-1):
        return split(block(g[name], axis, 8, rank), dtype)

    def on4(name, dtype=torch.float32, axis=-1):
        return split(block(g[name], axis, 4, sp4), dtype)

    for n in (256, 1024, 576):
        rec.call(f"natural_{n}", lambda: par.fft_distributed(
            on8(f"natural_{n}"), m8, axis_name="sp"))
    out = rec.call("roundtrip_fwd", lambda: par.fft_distributed(
        on8("roundtrip"), m8, axis_name="sp"))
    rec.call("roundtrip_back", lambda: par.fft_distributed(
        out, m8, axis_name="sp", inverse=True, norm="backward"))
    spec = rec.call("permuted_out", lambda: par.fft_distributed(
        on8("permuted"), m8, axis_name="sp", permuted_out=True))
    rec.call("permuted_in", lambda: par.fft_distributed(
        SplitComplex(spec.re * 0.5, spec.im * 0.5), m8, axis_name="sp",
        inverse=True, norm="backward", permuted_in=True))
    rec.call("dp_sp", lambda: par.fft_distributed(
        split(block(block(g["dp_sp"], 0, 2, dp), 1, 4, sp4)), m24,
        axis_name="sp", batch_axis_name="dp"))
    rec.call("ortho", lambda: par.fft_distributed(
        on4("ortho"), m24, axis_name="sp", norm="ortho"))
    rec.call("batch_fftn", lambda: par.fft_batch_sharded(
        split(block(g["batch_fftn"], 0, 8, rank)), m81,
        batch_axis_name="dp", axes=(1, 2)))
    rec.call("batch_rejects_batch_axis", lambda: par.fft_batch_sharded(
        split(np.zeros((1, 16))), m81, batch_axis_name="dp", axes=(0, 1)))
    out = rec.call("fftn_fwd", lambda: par.fftn_distributed(
        on4("fftn"), m24, axis_name="sp", axes=(1, 2), dist_axis=2))
    rec.call("fftn_back", lambda: par.fftn_distributed(
        out, m24, axis_name="sp", axes=(1, 2), dist_axis=2, inverse=True,
        norm="backward"))
    cfg = PlanConfig(backend="pallas", interpret=True)
    out = rec.call("kernel_fwd", lambda: par.fft_distributed(
        on4("kernel"), m24, axis_name="sp", config=cfg))
    rec.call("kernel_back", lambda: par.fft_distributed(
        out, m24, axis_name="sp", inverse=True, norm="backward", config=cfg))
    rec.call("fftn_kernel", lambda: par.fftn_distributed(
        on4("fftn_kernel"), m24, axis_name="sp", axes=(1, 2), dist_axis=2,
        config=cfg))
    rec.call("bf16", lambda: par.fft_distributed(
        on4("bf16", torch.bfloat16), m24, axis_name="sp",
        config=PlanConfig(backend="pallas", interpret=True,
                          plane_dtype="bfloat16")))
    # the fallback's INFO line, captured in the rank
    out = rec.call("gather_fwd", lambda: par.fft_distributed(
        on8("gather"), m8, axis_name="sp"))
    rec.call("gather_back", lambda: par.fft_distributed(
        out, m8, axis_name="sp", inverse=True, norm="backward"))
    rec.call("gather_permuted", lambda: par.fft_distributed(
        on8("gather"), m8, axis_name="sp", permuted_out=True))
    rec.call("gather_uneven", lambda: par.fft_distributed(
        split(block(g["gather"][:, :999], -1, 8, rank)), m8, axis_name="sp"))
    rec.call("n8000", lambda: par.fft_distributed(
        on8("n8000"), m8, axis_name="sp"))
    for key, kw in (("natural", {}), ("permuted_out", {"permuted_out": True}),
                    ("permuted_in", {"permuted_in": True})):
        rec.call(f"counts_{key}", lambda kw=kw: par.fft_distributed(
            on8("counts"), m8, axis_name="sp", **kw))
    # real input and the uneven half-spectrum blocks
    x = torch.tensor(block(g["rfft"], -1, 8, rank), dtype=torch.float32)
    out = rec.call("rfft", lambda: par.rfft_distributed(
        x, m8, axis_name="sp"))
    rec.call("irfft", lambda: par.irfft_distributed(
        out, m8, axis_name="sp", n=1024))
    rec.call("irfft_gather", lambda: par.irfft_distributed(
        on8("irfft_gather"), m8, axis_name="sp", n=1000))
    rec.call("irfft_pad", lambda: par.irfft_distributed(
        on8("irfft_pad"), m8, axis_name="sp", n=16))
    rec.call("irfft_odd", lambda: par.irfft_distributed(
        on4("irfft_odd"), m24, axis_name="sp", n=24))
    rec.call("rfft_16", lambda: par.rfft_distributed(
        torch.tensor(block(g["rfft_16"], -1, 8, rank)), m8,
        axis_name="sp"))
    rec.call("rfft_numpy", lambda: par.rfft_distributed(
        block(g["rfft_16"], -1, 8, rank), m8, axis_name="sp"))
    rec.call("rfft_complex", lambda: par.rfft_distributed(
        torch.zeros(2, 2, dtype=torch.complex64), m8, axis_name="sp"))
    # the sharded filter
    rec.call("filter_response", lambda: par.filter_distributed(
        on8("filter"), m8, axis_name="sp", response=g["filter_H"]))
    rec.call("filter_impulse", lambda: par.filter_distributed(
        on8("filter"), m8, axis_name="sp",
        impulse=np.fft.ifft(g["filter_H"])))
    rec.call("filter_gather", lambda: par.filter_distributed(
        on8("filter_gather"), m8, axis_name="sp",
        response=g["filter_gather_H"]))
    rec.call("filter_single", lambda: par.filter_distributed(
        split(g["filter_single"]), m81, axis_name="sp",
        response=g["filter_single_H"]))
    rec.call("batch_neg", lambda: par.fft_batch_sharded(
        split(block(g["batch_neg"], 1, 8, rank)), m81, batch_axis_name="dp",
        batch_dim=-1))
    rec.call("batch_dim_out_of_range", lambda: par.fft_batch_sharded(
        split(g["batch_neg"]), m81, batch_axis_name="dp", batch_dim=5))
    rec.call("f64", lambda: par.fft_distributed(
        on8("f64", torch.float64), m8, axis_name="sp"))
    rec.call("axis0", lambda: par.fft_distributed(
        on8("axis0", axis=0), m8, axis_name="sp", axis=0,
        batch_axis_name=None))
    # error paths
    x = on8("counts")
    rec.call("err_both_permuted", lambda: par.fft_distributed(
        x, m8, axis_name="sp", permuted_in=True, permuted_out=True))
    rec.call("err_batch_1d", lambda: par.fft_distributed(
        SplitComplex(x.re[0], x.im[0]), m24, axis_name="sp",
        batch_axis_name="dp"))
    rec.call("err_dist_axis", lambda: par.fftn_distributed(
        on4("fftn"), m24, axis_name="sp", axes=(0, 1), dist_axis=2))
    rec.call("err_filter_both", lambda: par.filter_distributed(
        x, m8, axis_name="sp", response=g["filter_H"], impulse=[1.0]))
    rec.call("err_filter_shape", lambda: par.filter_distributed(
        x, m8, axis_name="sp", response=np.ones(100)))
    rec.call("err_no_mesh_dim", lambda: par.fft_distributed(
        x, m8, axis_name="tp"))


def run_world1(rank: int, rec: Recorder) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from tpufft_torch import SplitComplex
    from tpufft_torch import parallel as par

    g = inputs()
    m1 = init_device_mesh("cpu", (1,), mesh_dim_names=F8)

    def split(x):
        return SplitComplex(torch.tensor(x.real, dtype=torch.float32),
                            torch.tensor(x.imag, dtype=torch.float32))

    rec.call("natural_256", lambda: par.fft_distributed(
        split(g["natural_256"]), m1, axis_name="sp"))
    rec.call("filter_single", lambda: par.filter_distributed(
        split(g["filter_single"]), m1, axis_name="sp",
        response=g["filter_single_H"]))
    out = rec.call("rfft", lambda: par.rfft_distributed(
        torch.tensor(g["rfft"], dtype=torch.float32), m1, axis_name="sp"))
    rec.call("irfft", lambda: par.irfft_distributed(
        out, m1, axis_name="sp", n=1024))
    rec.call("fftn_fwd", lambda: par.fftn_distributed(
        split(g["fftn"]), m1, axis_name="sp", axes=(1, 2), dist_axis=2))


def main(argv) -> int:
    rank, world, store_file, out_dir = (int(argv[1]), int(argv[2]), argv[3],
                                        argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tpufft_torch import parallel

    lines: list[str] = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("tpufft_torch")
    log.setLevel(logging.INFO)
    log.addHandler(Lines())
    rec = Recorder(parallel)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        (run_world8 if world == 8 else run_world1)(rank, rec)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl.tmp"), "wb") as f:
        pickle.dump({"results": rec.results, "log": lines}, f)
    os.replace(os.path.join(out_dir, f"rank{rank}.pkl.tmp"),
               os.path.join(out_dir, f"rank{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

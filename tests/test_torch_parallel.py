"""tpufft_torch.parallel in a gloo world of 8 CPU ranks against
tpufft.parallel on the 8-device CPU mesh and np.fft.

One world per module (``tests/_torch_dist_ranks.py``, 8 processes, and a
d = 1 world of one) runs every case once; each rank passes its block by
the block rule and writes its output block, its calls of ``_a2a`` and
``_all_gather``, its errors and its INFO lines. A test assembles the
blocks (``np.concatenate`` in rank order) and holds them against
tpufft's result on the same global input and mesh shape, and against
np.fft. Tolerances: ``assert_spectrum_close``'s normalized 1e-3 for
complex64 planes (both against tpufft and np.fft), 1e-12 for float64
planes, tpufft's 3e-2 for bf16 planes, and for the real outputs of
irfft tpufft's atol/rtol 2e-3 (2e-6 for the zero-padded spectrum).
Cases on the (2, 4) mesh without ``batch_axis_name`` run the same global
input in both "dp" rows; both rows must give the same blocks.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tpufft
from tpufft import parallel as tp
from tpufft_torch import parallel as par
from conftest import assert_spectrum_close
from _torch_dist_ranks import inputs
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "_torch_dist_ranks.py")
WORLD_TIMEOUT = 300
F64_TOL = 1e-12
BF16_TOL = 3e-2


def _run_world(world: int, tmp) -> list[dict]:
    """Start ``world`` rank processes of the helper and wait for them; a
    rank's failure fails the tests with its stderr."""
    out = tmp / f"world{world}"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [out / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, HELPER, str(r), str(world),
                 str(out / "store"), str(out)], cwd=ROOT, env=env,
                stdout=subprocess.DEVNULL, stderr=f))
    errors = []
    deadline = time.monotonic() + WORLD_TIMEOUT
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail(f"rank {r} of the {world}-rank world timed out")
        if p.returncode != 0:
            errors.append(f"rank {r} exited {p.returncode}:\n"
                          f"{logs[r].read_text()[-4000:]}")
    if errors:
        pytest.fail("\n".join(errors))
    ranks = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dist")
    return {8: _run_world(8, tmp), 1: _run_world(1, tmp)}


@pytest.fixture(scope="module")
def g():
    return inputs()


def _res(worlds, key, rank=0, world=8) -> dict:
    res = worlds[world][rank]["results"][key]
    assert "error" not in res, res.get("error")
    return res


def _cat(worlds, key, ranks=range(8), axis=-1, world=8) -> np.ndarray:
    return np.concatenate([_res(worlds, key, r, world)["out"]
                           for r in ranks], axis=axis)


def _cat4(worlds, key, axis=-1) -> np.ndarray:
    """A (2, 4) mesh case: the blocks of "dp" row 0, which row 1 repeats."""
    a = _cat(worlds, key, range(4), axis)
    np.testing.assert_array_equal(_cat(worlds, key, range(4, 8), axis), a)
    return a


def _mesh(shape, names):
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _split(x, dtype=jnp.float32):
    x = np.asarray(x)
    return tpufft.SplitComplex(jnp.asarray(x.real, dtype),
                               jnp.asarray(x.imag, dtype))


def _both(got, ref_tpufft, ref_np, dtype=np.complex64):
    assert got.shape == np.shape(ref_np)
    assert_spectrum_close(got, ref_tpufft, dtype)
    assert_spectrum_close(got, ref_np, dtype)


def _error(worlds, key, world=8) -> tuple[str, str]:
    errs = {worlds[world][r]["results"][key].get("error")
            for r in range(world)}
    assert len(errs) == 1 and None not in errs, errs
    return errs.pop()


def test_split_n():
    assert par.split_n(256, 8) == tp.split_n(256, 8) == (16, 16)
    for n, d in ((1024, 8), (576, 8), (8000, 8), (2 ** 24, 4),
                 (4 * 3 ** 12 * 4, 4)):
        a, b = par.split_n(n, d)
        assert (a, b) == tp.split_n(n, d)
        assert a * b == n and a % d == 0 and b % d == 0
    with pytest.raises(ValueError) as got:
        par.split_n(100, 8)
    with pytest.raises(ValueError) as ref:
        tp.split_n(100, 8)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("n", [256, 1024, 576])
def test_distributed_fft_natural(worlds, g, n):
    x = g[f"natural_{n}"]
    ref = tp.fft_distributed(_split(x), _mesh((8,), ("sp",)),
                             axis_name="sp").numpy()
    _both(_cat(worlds, f"natural_{n}"), ref, np.fft.fft(x))


def test_distributed_ifft_roundtrip(worlds, g):
    x = g["roundtrip"]
    assert_spectrum_close(_cat(worlds, "roundtrip_fwd"), np.fft.fft(x),
                          np.complex64)
    mesh = _mesh((8,), ("sp",))
    ref = tp.fft_distributed(tp.fft_distributed(_split(x), mesh,
                                                axis_name="sp"),
                             mesh, axis_name="sp", inverse=True,
                             norm="backward").numpy()
    _both(_cat(worlds, "roundtrip_back"), ref, x)


def test_distributed_permuted_pipeline(worlds, g):
    x = g["permuted"]
    mesh = _mesh((8,), ("sp",))
    A, B = par.split_n(256, 8)
    spec = tp.fft_distributed(_split(x), mesh, axis_name="sp",
                              permuted_out=True)
    perm = np.fft.fft(x).reshape(2, B, A).swapaxes(1, 2).reshape(2, 256)
    _both(_cat(worlds, "permuted_out"), spec.numpy(), perm)
    half = tpufft.SplitComplex(spec.re * 0.5, spec.im * 0.5)
    back = tp.fft_distributed(half, mesh, axis_name="sp", inverse=True,
                              norm="backward", permuted_in=True).numpy()
    _both(_cat(worlds, "permuted_in"), back, 0.5 * x)


def test_distributed_dp_sp_mesh(worlds, g):
    """(2, 4) mesh: the batch blocked over dp, the axis over sp."""
    x = g["dp_sp"]
    got = np.concatenate([_cat(worlds, "dp_sp", range(4)),
                          _cat(worlds, "dp_sp", range(4, 8))], axis=0)
    ref = tp.fft_distributed(_split(x), _mesh((2, 4), ("dp", "sp")),
                             axis_name="sp", batch_axis_name="dp").numpy()
    _both(got, ref, np.fft.fft(x))


def test_distributed_norm_ortho(worlds, g):
    x = g["ortho"]
    ref = tp.fft_distributed(_split(x), _mesh((4,), ("sp",)),
                             axis_name="sp", norm="ortho").numpy()
    _both(_cat4(worlds, "ortho"), ref, np.fft.fft(x, norm="ortho"))


def test_batch_sharded_fftn(worlds, g):
    x = g["batch_fftn"]
    ref = tp.fft_batch_sharded(_split(x), _mesh((8,), ("dp",)),
                               batch_axis_name="dp", axes=(1, 2)).numpy()
    got = _cat(worlds, "batch_fftn", axis=0)
    _both(got, ref, np.fft.fftn(x, axes=(1, 2)))
    assert all(_res(worlds, "batch_fftn", r)["gather"] == 0
               and _res(worlds, "batch_fftn", r)["a2a"] == 0
               for r in range(8))


def test_batch_sharded_rejects_batch_axis(worlds):
    with pytest.raises(ValueError) as ref:
        tp.fft_batch_sharded(_split(np.zeros((8, 16))), _mesh((8,), ("dp",)),
                             batch_axis_name="dp", axes=(0, 1))
    assert _error(worlds, "batch_rejects_batch_axis") == (
        "ValueError", str(ref.value))


def test_fftn_distributed(worlds, g):
    x = g["fftn"]
    mesh = _mesh((4,), ("sp",))
    out = tp.fftn_distributed(_split(x), mesh, axis_name="sp", axes=(1, 2),
                              dist_axis=2)
    _both(_cat4(worlds, "fftn_fwd"), out.numpy(),
          np.fft.fftn(x, axes=(1, 2)))
    back = tp.fftn_distributed(out, mesh, axis_name="sp", axes=(1, 2),
                               dist_axis=2, inverse=True, norm="backward")
    _both(_cat4(worlds, "fftn_back"), back.numpy(), x)


def test_distributed_through_kernel_config(worlds, g):
    """backend="pallas": the local transforms of every rank go through
    execute.fft_axis (the kernels' plain versions on CPU tensors; it
    raises if a length had no kernel)."""
    x = g["kernel"]
    cfg = tpufft.PlanConfig(backend="pallas", interpret=True)
    mesh = _mesh((4,), ("sp",))
    out = tp.fft_distributed(_split(x), mesh, axis_name="sp", config=cfg)
    _both(_cat4(worlds, "kernel_fwd"), out.numpy(), np.fft.fft(x))
    back = tp.fft_distributed(out, mesh, axis_name="sp", inverse=True,
                              norm="backward", config=cfg).numpy()
    _both(_cat4(worlds, "kernel_back"), back, x)


def test_fftn_distributed_kernel_config(worlds, g):
    x = g["fftn_kernel"]
    cfg = tpufft.PlanConfig(backend="pallas", interpret=True)
    ref = tp.fftn_distributed(_split(x), _mesh((4,), ("sp",)),
                              axis_name="sp", axes=(1, 2), dist_axis=2,
                              config=cfg).numpy()
    _both(_cat4(worlds, "fftn_kernel"), ref, np.fft.fft2(x, axes=(1, 2)))


def test_distributed_bf16_planes(worlds, g):
    """bf16 planes stay bf16 through the exchanges (tpufft's 3e-2)."""
    x = g["bf16"]
    cfg = tpufft.PlanConfig(backend="pallas", interpret=True,
                            plane_dtype="bfloat16")
    got = _cat4(worlds, "bf16")
    for ref in (tp.fft_distributed(_split(x, jnp.bfloat16),
                                   _mesh((4,), ("sp",)), axis_name="sp",
                                   config=cfg).numpy(), np.fft.fft(x)):
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(got - ref)) / scale < BF16_TOL


def test_distributed_gather_fallback(worlds, g):
    """d^2 does not divide n (1000, d=8): the all-gather body, logged; the
    permuted orders and uneven blocks raise tpufft's errors."""
    x = g["gather"]
    mesh = _mesh((8,), ("sp",))
    out = tp.fft_distributed(_split(x), mesh, axis_name="sp")
    _both(_cat(worlds, "gather_fwd"), out.numpy(), np.fft.fft(x))
    back = tp.fft_distributed(out, mesh, axis_name="sp", inverse=True,
                              norm="backward").numpy()
    _both(_cat(worlds, "gather_back"), back, x)
    for r in range(8):
        res = _res(worlds, "gather_fwd", r)
        assert (res["a2a"], res["gather"]) == (0, 2)   # lengths, the axis
        assert any("n=1000 d=8: d^2 does not divide n" in line
                   and "all_gather fallback" in line
                   for line in worlds[8][r]["log"])
    with pytest.raises(ValueError, match="four-step") as ref:
        tp.fft_distributed(_split(x), mesh, axis_name="sp",
                           permuted_out=True)
    assert _error(worlds, "gather_permuted") == ("ValueError", str(ref.value))
    with pytest.raises(ValueError, match="d \\| n") as ref:
        tp.fft_distributed(_split(x[:, :999]), mesh, axis_name="sp")
    assert _error(worlds, "gather_uneven") == ("ValueError", str(ref.value))


def test_distributed_n8000(worlds, g):
    x = g["n8000"]
    ref = tp.fft_distributed(_split(x), _mesh((8,), ("sp",)),
                             axis_name="sp").numpy()
    _both(_cat(worlds, "n8000"), ref, np.fft.fft(x))


@pytest.mark.parametrize("key,a2a", [("natural", 3), ("permuted_out", 2),
                                     ("permuted_in", 2)])
def test_distributed_exchange_counts(worlds, key, a2a):
    """One stacked exchange per step, in every rank: 3 in natural order, 2
    with permuted_out or permuted_in (tpufft counts 6/4/4, a plane each),
    and one all-gather of the block lengths."""
    for r in range(8):
        res = _res(worlds, f"counts_{key}", r)
        assert (res["a2a"], res["gather"]) == (a2a, 1)


@pytest.mark.parametrize("key,a2a,gather", [
    ("filter_response", 4, 1), ("filter_impulse", 4, 1),
    ("filter_gather", 0, 3), ("rfft", 4, 1), ("irfft", 4, 1),
    ("irfft_gather", 1, 2), ("natural_256", 3, 1), ("batch_fftn", 0, 0),
    ("filter_single", 0, 0)])
def test_collective_counts(worlds, key, a2a, gather):
    """The counts the module docstring states, in every rank (the gathers
    include one of the block lengths at d > 1)."""
    for r in range(8):
        res = _res(worlds, key, r)
        assert (res["a2a"], res["gather"]) == (a2a, gather)


def test_distributed_rfft_irfft(worlds, g):
    x = g["rfft"]
    mesh = _mesh((8,), ("sp",))
    out = tp.rfft_distributed(jnp.asarray(x, jnp.float32), mesh,
                              axis_name="sp")
    got = _cat(worlds, "rfft")
    ref = np.fft.rfft(x, axis=-1)
    assert got.shape == out.re.shape == ref.shape
    _both(got, out.numpy(), ref)
    # the block rule over 513 bins: seven blocks of 65 and one of 58
    assert [_res(worlds, "rfft", r)["out"].shape[-1] for r in range(8)] == \
        [65] * 7 + [58]
    back = _cat(worlds, "irfft")
    np.testing.assert_allclose(back, x, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(
        back, np.asarray(tp.irfft_distributed(out, mesh, axis_name="sp",
                                              n=1024)), atol=2e-3, rtol=2e-3)
    sp = g["irfft_gather"]   # n = 1000: the C2C's gather fallback
    x3 = np.fft.irfft(sp, n=1000, axis=-1)
    got3 = _cat(worlds, "irfft_gather")
    np.testing.assert_allclose(got3, x3, atol=2e-3, rtol=2e-3)
    ref3 = tp.irfft_distributed(_split(sp), mesh, axis_name="sp", n=1000)
    np.testing.assert_allclose(got3, np.asarray(ref3), atol=2e-3, rtol=2e-3)


def test_distributed_irfft_padded_spectrum(worlds, g):
    """n larger than 2*(m-1): the spectrum is zero-padded to n//2+1 bins
    (numpy); m = 5 bins over 8 ranks leaves three blocks empty."""
    sp = g["irfft_pad"].copy()
    got = _cat(worlds, "irfft_pad")
    ref = np.fft.irfft(sp, n=16, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-6)
    tref = tp.irfft_distributed(_split(sp), _mesh((8,), ("sp",)),
                                axis_name="sp", n=16)
    np.testing.assert_allclose(got, np.asarray(tref), atol=2e-6)


def test_uneven_half_spectrum_blocks(worlds, g):
    """rfft of n = 16 on 8 ranks: 9 bins as blocks 2, 2, 2, 2, 1, 0, 0, 0
    (numpy input goes to the mesh's device); irfft of 13 bins on 4 ranks
    (blocks 4, 4, 4, 1), n = 24, odd and even mirrored bins."""
    x = g["rfft_16"]
    for key in ("rfft_16", "rfft_numpy"):
        sizes = [_res(worlds, key, r)["out"].shape[-1] for r in range(8)]
        assert sizes == [2, 2, 2, 2, 1, 0, 0, 0]
        ref = tp.rfft_distributed(jnp.asarray(x), _mesh((8,), ("sp",)),
                                  axis_name="sp").numpy()
        _both(_cat(worlds, key), ref, np.fft.rfft(x, axis=-1),
              np.complex128)
    sp = g["irfft_odd"]
    np.testing.assert_allclose(_cat4(worlds, "irfft_odd"),
                               np.fft.irfft(sp, n=24, axis=-1), atol=2e-6)


def test_rfft_distributed_refuses_complex(worlds):
    assert _error(worlds, "rfft_complex") == (
        "TypeError", "rfft_distributed takes real input")


def test_filter_distributed(worlds, g):
    x, H = g["filter"], g["filter_H"]
    mesh = _mesh((8,), ("sp",))
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    t_ref = tp.filter_distributed(_split(x), mesh, axis_name="sp",
                                  response=H).numpy()
    _both(_cat(worlds, "filter_response"), t_ref, ref)
    _both(_cat(worlds, "filter_impulse"), t_ref, ref)


def test_filter_distributed_gather_fallback(worlds, g):
    x, H = g["filter_gather"], g["filter_gather_H"]
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    t_ref = tp.filter_distributed(_split(x), _mesh((8,), ("sp",)),
                                  axis_name="sp", response=H).numpy()
    _both(_cat(worlds, "filter_gather"), t_ref, ref)


@pytest.mark.parametrize("world", [8, 1])
def test_filter_distributed_single_device_mesh(worlds, g, world):
    """d == 1 (an (8, 1) mesh's "sp", and a world of one) runs the plain
    transform in natural order, with no exchange."""
    x, H = g["filter_single"], g["filter_single_H"]
    ref = np.fft.ifft(np.fft.fft(x, axis=-1) * H, axis=-1)
    t_ref = tp.filter_distributed(_split(x), _mesh((1,), ("sp",)),
                                  axis_name="sp", response=H).numpy()
    for r in range(world):
        res = _res(worlds, "filter_single", r, world)
        assert (res["a2a"], res["gather"]) == (0, 0)
        _both(res["out"], t_ref, ref)


def test_d1_world(worlds, g):
    """A world of one rank: every path is the local transform."""
    x = g["natural_256"]
    _both(_res(worlds, "natural_256", world=1)["out"],
          tp.fft_distributed(_split(x), _mesh((1,), ("sp",)),
                             axis_name="sp").numpy(), np.fft.fft(x))
    xr = g["rfft"]
    assert_spectrum_close(_res(worlds, "rfft", world=1)["out"],
                          np.fft.rfft(xr, axis=-1), np.complex64)
    np.testing.assert_allclose(_res(worlds, "irfft", world=1)["out"], xr,
                               atol=2e-3, rtol=2e-3)
    assert_spectrum_close(_res(worlds, "fftn_fwd", world=1)["out"],
                          np.fft.fftn(g["fftn"], axes=(1, 2)), np.complex64)
    for key in ("natural_256", "rfft", "irfft", "fftn_fwd"):
        res = _res(worlds, key, world=1)
        assert (res["a2a"], res["gather"]) == (0, 0)


def test_batch_sharded_negative_batch_dim(worlds, g):
    x = g["batch_neg"]
    mesh = _mesh((8,), ("dp",))
    ref = tp.fft_batch_sharded(_split(x), mesh, batch_axis_name="dp",
                               batch_dim=-1).numpy()
    _both(_cat(worlds, "batch_neg", axis=1), ref, np.fft.fft(x, axis=0))
    with pytest.raises(ValueError) as t_err:
        tp.fft_batch_sharded(_split(x), mesh, batch_axis_name="dp",
                             batch_dim=5)
    assert _error(worlds, "batch_dim_out_of_range") == (
        "ValueError", str(t_err.value))


def test_distributed_f64_keeps_f64_tier(worlds, g):
    x = g["f64"]
    got = _cat(worlds, "f64")
    ref = np.fft.fft(x)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < F64_TOL
    t_ref = tp.fft_distributed(_split(x, jnp.float64), _mesh((8,), ("sp",)),
                               axis_name="sp").numpy()
    assert np.max(np.abs(got - t_ref)) / np.max(np.abs(ref)) < F64_TOL


def test_distributed_axis0(worlds, g):
    """The transform axis first: blocks along axis 0."""
    x = g["axis0"]
    ref = tp.fft_distributed(_split(x), _mesh((8,), ("sp",)), axis_name="sp",
                             axis=0).numpy()
    _both(_cat(worlds, "axis0", axis=0), ref, np.fft.fft(x, axis=0))


def test_error_paths(worlds, g):
    """Each error with tpufft's message (the missing mesh dimension has
    none in tpufft: jax raises its own)."""
    mesh8, mesh24 = _mesh((8,), ("sp",)), _mesh((2, 4), ("dp", "sp"))
    x = _split(g["counts"])
    cases = {
        "err_both_permuted": lambda: tp.fft_distributed(
            x, mesh8, axis_name="sp", permuted_in=True, permuted_out=True),
        "err_batch_1d": lambda: tp.fft_distributed(
            tpufft.SplitComplex(x.re[0], x.im[0]), mesh24, axis_name="sp",
            batch_axis_name="dp"),
        "err_dist_axis": lambda: tp.fftn_distributed(
            _split(g["fftn"]), _mesh((4,), ("sp",)), axis_name="sp",
            axes=(0, 1), dist_axis=2),
        "err_filter_both": lambda: tp.filter_distributed(
            x, mesh8, axis_name="sp", response=g["filter_H"],
            impulse=[1.0]),
        "err_filter_shape": lambda: tp.filter_distributed(
            x, mesh8, axis_name="sp", response=np.ones(100)),
    }
    for key, call in cases.items():
        with pytest.raises(ValueError) as ref:
            call()
        assert _error(worlds, key) == ("ValueError", str(ref.value)), key
    kind, msg = _error(worlds, "err_no_mesh_dim")
    assert kind == "ValueError" and "'tp'" in msg


def test_exports_match_tpufft():
    assert sorted(par.__all__) == sorted(tp.__all__)

"""tpufft_torch.native (the ctypes binding of native/tpufft_cpu.cpp)
against tpufft.native and np.fft: every case of ``tests/test_native.py``,
plus the port's own rules: the library builds into ``build/tpufft_torch/``
and never into ``tpufft/_native/``, a CPU tensor in gives a CPU tensor out,
and a tensor on another device is refused.

Tolerances: against tpufft.native on the same input (the same engine),
1e-6 (complex64) and 1e-12 (complex128) of the output's size; against
np.fft, the tolerance ``tests/test_native.py`` states for the case.
Skipped when no C++ toolchain is available.
"""

import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpufft import native as ref_native
from tpufft_torch import native
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable (no g++)"
)


def _same(got, ref):
    """Port against tpufft.native: 1e-6 (c64) / 1e-12 (c128) of the size."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    tol = 1e-12 if ref.dtype in (np.complex128, np.float64) else 1e-6
    assert np.max(np.abs(got - ref)) <= tol * max(1.0, np.max(np.abs(ref)))


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def test_1d_batched_f32(rng):
    x = (rng.standard_normal((50, 96))
         + 1j * rng.standard_normal((50, 96))).astype(np.complex64)
    got = native.fft(x)
    assert _rel(got, np.fft.fft(x)) < 1e-3
    _same(got, ref_native.fft(x))


def test_1d_prime_f64(rng):
    x = (rng.standard_normal((10, 93))
         + 1j * rng.standard_normal((10, 93)))
    got = native.fft(x, dtype=np.float64)
    assert _rel(got, np.fft.fft(x)) < 1e-12
    _same(got, ref_native.fft(x, dtype=np.float64))


def test_roundtrip(rng):
    x = (rng.standard_normal((20, 60))
         + 1j * rng.standard_normal((20, 60))).astype(np.complex64)
    back = native.ifft(native.fft(x))
    assert np.max(np.abs(back - x)) < 1e-4
    _same(back, ref_native.ifft(ref_native.fft(x)))


def test_nd(rng):
    x = (rng.standard_normal((3, 6, 8, 10))
         + 1j * rng.standard_normal((3, 6, 8, 10)))
    got = native.fftn(x, dtype=np.float64)
    assert _rel(got, np.fft.fftn(x, axes=(1, 2, 3))) < 1e-12
    _same(got, ref_native.fftn(x, dtype=np.float64))


def test_nd_inverse_norm(rng):
    x = (rng.standard_normal((2, 8, 12))
         + 1j * rng.standard_normal((2, 8, 12))).astype(np.complex64)
    back = native.ifftn(native.fftn(x))
    assert np.max(np.abs(back - x)) < 1e-4
    _same(back, ref_native.ifftn(ref_native.fftn(x)))


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("inverse", [False, True])
def test_norms(rng, norm, inverse):
    x = (rng.standard_normal((70, 64))
         + 1j * rng.standard_normal((70, 64))).astype(np.complex64)
    got = native.fft(x, inverse=inverse, norm=norm)
    ref = (np.fft.ifft if inverse else np.fft.fft)(x, norm=norm)
    assert _rel(got, ref) < 2e-6
    _same(got, ref_native.fft(x, inverse=inverse, norm=norm))
    xn = x.reshape(70, 8, 8)
    got = native.fftn(xn, inverse=inverse, norm=norm)
    ref = (np.fft.ifftn if inverse else np.fft.fftn)(xn, axes=(1, 2),
                                                     norm=norm)
    assert _rel(got, ref) < 2e-6
    _same(got, ref_native.fftn(xn, inverse=inverse, norm=norm))


def test_matches_the_port_device_path(rng):
    """The native engine and the port's own transform (a CPU tensor, the
    kernels' plain versions) agree."""
    import tpufft_torch
    x = (rng.standard_normal((4, 48))
         + 1j * rng.standard_normal((4, 48))).astype(np.complex64)
    a = native.fft(x)
    b = tpufft_torch.fft(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))) < 1e-3


def test_packaged_source_in_sync():
    """The package-data copy under tpufft_torch/native_src/ is made at
    build time by setup.py's build_py hook from native/tpufft_cpu.cpp; a
    working-tree copy, if any, must equal the source."""
    src = open(os.path.join(ROOT, "native", "tpufft_cpu.cpp")).read()
    copy = os.path.join(ROOT, "tpufft_torch", "native_src", "tpufft_cpu.cpp")
    if os.path.exists(copy):
        assert open(copy).read() == src, \
            "stale build copy: rm tpufft_torch/native_src/tpufft_cpu.cpp"
    hook = open(os.path.join(ROOT, "setup.py")).read()
    assert "native_src" in hook and "build_py" in hook
    assert "tpufft_torch" in hook
    assert '"native_src/*.cpp"' in open(
        os.path.join(ROOT, "pyproject.toml")).read().split(
            "tpufft_torch = ")[1].splitlines()[0]
    assert "tpufft_torch/native_src/" in open(
        os.path.join(ROOT, ".gitignore")).read().split()


def test_n1_scale_through_c_abi():
    """n==1 identity transform must still apply scale in the batch-vector
    path (count >= 64)."""
    lib = native._lib()
    re = np.arange(128, dtype=np.float32)
    im = -np.arange(128, dtype=np.float32)
    out_re = np.full(128, np.nan, np.float32)
    out_im = np.full(128, np.nan, np.float32)
    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa
    rc = lib.tpufft_fft_strided_f32(p(re), p(im), p(out_re), p(out_im),
                                    128, 1, 1, 1, 1, 0, 2.5, 1)
    assert rc == 0
    np.testing.assert_allclose(out_re, 2.5 * re)
    np.testing.assert_allclose(out_im, 2.5 * im)


def test_planes_api(rng):
    re = rng.standard_normal((40, 96)).astype(np.float32)
    im = rng.standard_normal((40, 96)).astype(np.float32)
    o_re, o_im = native.fft_planes(re, im)
    assert _rel(o_re + 1j * o_im, np.fft.fft(re + 1j * im)) < 1e-3
    r_re, r_im = ref_native.fft_planes(re, im)
    _same(o_re + 1j * o_im, r_re + 1j * r_im)
    a = rng.standard_normal((2, 6, 8)).astype(np.float32)
    o_re, o_im = native.fftn_planes(a, np.zeros((2, 6, 8), np.float32))
    assert (o_re + 1j * o_im).shape == (2, 6, 8)
    assert _rel(o_re + 1j * o_im, np.fft.fftn(a, axes=(1, 2))) < 1e-5
    r_re, r_im = ref_native.fftn_planes(a, np.zeros((2, 6, 8), np.float32))
    _same(o_re + 1j * o_im, r_re + 1j * r_im)


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256, 512, 1024, 2048])
def test_pow2_butterfly_radices(rng, n):
    """Radix-8/4/2 butterfly stages across pow2 n."""
    x = (rng.standard_normal((80, n))
         + 1j * rng.standard_normal((80, n))).astype(np.complex64)
    got = native.fft(x)
    assert _rel(got, np.fft.fft(x)) < 1e-3, n
    _same(got, ref_native.fft(x))
    back = native.ifft(got)
    assert np.max(np.abs(back - x)) < 1e-3, n


def test_planes_api_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="shapes differ"):
        native.fft_planes(np.zeros((2, 8), np.float32),
                          np.zeros((3, 8), np.float32))


def test_planes_api_normalizes_odd_dtypes():
    """f16/int inputs are widened, never reinterpreted byte-wise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16))
    re16 = x.astype(np.float16)
    outr, outi = native.fft_planes(re16, np.zeros_like(re16))
    assert np.max(np.abs((outr + 1j * outi)
                         - np.fft.fft(re16.astype(np.float64)))) < 1e-2
    ri = np.arange(32, dtype=np.int64).reshape(4, 8)
    outr, outi = native.fft_planes(ri, np.zeros_like(ri))
    assert np.max(np.abs((outr + 1j * outi)
                         - np.fft.fft(ri.astype(np.float64)))) < 1e-9
    r_re, r_im = ref_native.fft_planes(ri, np.zeros_like(ri))
    _same(outr + 1j * outi, r_re + 1j * r_im)


@pytest.mark.parametrize("n", [4096, 6144, 16384, 3000])
def test_native_fourstep_lengths(rng, n):
    """2048 < n <= 16384 runs the vectorized four-step lane-batch path;
    even/odd batch counts, both directions."""
    x = (rng.standard_normal((67, n))
         + 1j * rng.standard_normal((67, n))).astype(np.complex64)
    got = native.fft(x)
    ref = np.fft.fft(x, axis=1)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 3e-6, n
    _same(got, ref_native.fft(x))
    back = native.ifft(got)
    assert np.max(np.abs(back - x)) < 3e-6, n


def test_native_fourstep_f64(rng):
    xd = (rng.standard_normal((66, 4096))
          + 1j * rng.standard_normal((66, 4096)))
    got = native.fft(xd, dtype=np.float64)
    assert np.max(np.abs(got - np.fft.fft(xd, axis=1))) < 1e-9
    _same(got, ref_native.fft(xd, dtype=np.float64))


@pytest.mark.parametrize("n", [16, 256, 1024, 2048])
def test_native_radix16_plans(rng, n):
    """Vectorized plans with radix-16 stages (big batch) and the scalar
    path (small batch) both agree with numpy."""
    x = (rng.standard_normal((80, n))
         + 1j * rng.standard_normal((80, n))).astype(np.complex64)
    got = native.fft(x)
    ref = np.fft.fft(x, axis=1)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-6, n
    gots = native.fft(x[:5])
    assert np.max(np.abs(gots - ref[:5])) / np.max(np.abs(ref)) < 2e-6, n
    _same(gots, ref_native.fft(x[:5]))


def test_native_streaming_scatter_alignment(rng):
    n = 1024
    x = (rng.standard_normal((65, n))
         + 1j * rng.standard_normal((65, n))).astype(np.complex64)
    ref = np.fft.fft(x, axis=1)
    got_all = native.fft(x)
    got_off = native.fft(x[1:])
    assert np.max(np.abs(got_all - ref)) / np.max(np.abs(ref)) < 2e-6
    assert np.max(np.abs(got_off - ref[1:])) / np.max(np.abs(ref)) < 2e-6
    _same(got_off, ref_native.fft(x[1:]))


def test_native_lines_fourstep_long_n(rng):
    x = (rng.standard_normal((1, 4096, 32))
         + 1j * rng.standard_normal((1, 4096, 32))).astype(np.complex64)
    got = native.fftn(x)
    assert _rel(got, np.fft.fftn(x, axes=(1, 2))) < 1e-3
    _same(got, ref_native.fftn(x))
    y = (rng.standard_normal((1, 3840, 18))
         + 1j * rng.standard_normal((1, 3840, 18))).astype(np.complex64)
    got = native.ifftn(y)
    assert _rel(got, np.fft.ifftn(y, axes=(1, 2))) < 1e-3
    _same(got, ref_native.ifftn(y))


@pytest.mark.parametrize("n,cnt", [(93, 67), (256, 80), (1024, 70),
                                   (4096, 65)])
def test_native_interleaved_fast_path(rng, n, cnt):
    """Contiguous complex input takes the interleaved engine entry;
    strided input falls back to the split-plane path; same answers."""
    x = (rng.standard_normal((cnt, n))
         + 1j * rng.standard_normal((cnt, n)))
    ref = np.fft.fft(x)
    got = native.fft(x.astype(np.complex64))
    g64 = native.fft(x, dtype=np.float64)
    gv = native.fft(x[::2].astype(np.complex64))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 2e-6, n
    assert np.max(np.abs(g64 - ref)) / scale < 1e-12, n
    assert np.max(np.abs(gv - ref[::2])) / scale < 2e-6, n
    _same(g64, ref_native.fft(x, dtype=np.float64))
    _same(gv, ref_native.fft(x[::2].astype(np.complex64)))


def test_native_below_lane_batch_gate(rng):
    xs = (rng.standard_normal((8, 128))
          + 1j * rng.standard_normal((8, 128))).astype(np.complex64)
    got = native.fft(xs)
    assert np.max(np.abs(got - np.fft.fft(xs))) < 1e-3
    _same(got, ref_native.fft(xs))


@pytest.mark.parametrize("total", [1, 7, 15, 16, 17, 1000, 9999])
def test_native_split_combine_roundtrip(rng, total):
    """The C split/combine conversion entries are exact for any length."""
    x = (rng.standard_normal(total)
         + 1j * rng.standard_normal(total)).astype(np.complex64)
    re, im, pooled = native._planes(x, np.float32)
    assert pooled
    assert np.array_equal(re, x.real) and np.array_equal(im, x.imag)
    assert np.array_equal(native._combine(re, im), x)
    x64 = x.astype(np.complex128)
    re, im, _ = native._planes(x64, np.float64)
    assert np.array_equal(re, x64.real) and np.array_equal(im, x64.imag)
    assert np.array_equal(native._combine(re, im), x64)


def test_native_scratch_pool_reuse(rng):
    """Pooled scratch planes never leak stale data into results."""
    x = (rng.standard_normal((70, 93))
         + 1j * rng.standard_normal((70, 93))).astype(np.complex64)
    first = native.fftn(x[:, None, :])
    again = native.fftn(x[:, None, :])
    assert np.array_equal(first, again)
    ref = np.fft.fft(x)[:, None, :]
    assert np.max(np.abs(first - ref)) / np.max(np.abs(ref)) < 2e-6


@pytest.mark.parametrize("total,nt", [(10, 16), (1283, 8), (16, 3),
                                      (4097, 16), (33, 2)])
def test_native_split_combine_forced_multithread(rng, total, nt):
    """The OpenMP range partition covers [0, n) for any thread count."""
    lib = native._lib()
    cptr = ctypes.POINTER(ctypes.c_float)
    x = (rng.standard_normal(total)
         + 1j * rng.standard_normal(total)).astype(np.complex64)
    re = np.full(total, np.nan, np.float32)
    im = np.full(total, np.nan, np.float32)
    lib.tpufft_split_c2p_f32(x.ctypes.data_as(cptr), re.ctypes.data_as(cptr),
                             im.ctypes.data_as(cptr), total, nt)
    assert np.array_equal(re, x.real) and np.array_equal(im, x.imag)
    out = np.full(total, np.nan, np.complex64)
    lib.tpufft_combine_p2c_f32(re.ctypes.data_as(cptr),
                               im.ctypes.data_as(cptr),
                               out.ctypes.data_as(cptr), total, nt)
    assert np.array_equal(out, x)


def test_native_interleaved_gather_no_overread(rng):
    """The interleaved gather does not read past the input buffer: the
    input ends at a page boundary before an unmapped guard page."""
    import mmap
    count, n = 64, 256
    nbytes = count * n * 8
    pagesz = mmap.PAGESIZE
    total = (nbytes + pagesz - 1) // pagesz * pagesz
    buf = mmap.mmap(-1, total + pagesz)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    libc = ctypes.CDLL(None, use_errno=True)
    assert libc.mprotect(ctypes.c_void_p(addr + total), pagesz, 0) == 0
    x = np.frombuffer(buf, np.complex64, count=count * n,
                      offset=total - nbytes).reshape(count, n)
    x[:] = (rng.standard_normal((count, n))
            + 1j * rng.standard_normal((count, n)))
    got = native.fft(x)
    assert _rel(got, np.fft.fft(x)) < 2e-6
    got_t = native.fft(torch.from_numpy(x))   # the tensor's zero-copy view
    assert np.array_equal(got_t.numpy(), got)
    del x, got_t
    assert libc.mprotect(ctypes.c_void_p(addr + total), pagesz, 3) == 0
    buf.close()


def test_native_empty_input_raises():
    with pytest.raises(ValueError):
        native.fft(np.zeros((3, 0), np.complex64))
    with pytest.raises(ValueError):
        native.fftn(np.zeros((2, 3, 0), np.complex64))
    with pytest.raises(ValueError):
        native.fft(torch.zeros((3, 0), dtype=torch.complex64))


# ---------------------------------------------------------------------------
# The port's own rules


def test_library_builds_under_build_tpufft_torch():
    """The library lies under build/tpufft_torch/ and loading it (in a
    fresh interpreter, tpufft never imported) leaves tpufft/_native/ as it
    was."""
    lib_dir = os.path.join(ROOT, "build", "tpufft_torch")
    path = native._lib_path()
    assert os.path.dirname(path) == lib_dir
    assert os.path.basename(path).startswith("libtpufft_cpu_")
    ref_dir = os.path.join(ROOT, "tpufft", "_native")

    def snapshot():
        if not os.path.isdir(ref_dir):
            return None
        return sorted((e.name, e.stat().st_mtime_ns, e.stat().st_size)
                      for e in os.scandir(ref_dir))

    before = snapshot()
    code = textwrap.dedent("""
        import sys
        from tpufft_torch import native
        assert native.available()
        assert "tpufft" not in sys.modules and "jax" not in sys.modules
        print(native._lib_path())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == path and os.path.isfile(path)
    assert snapshot() == before


@pytest.mark.parametrize("fn,shape", [(native.fft, (70, 96)),
                                      (native.ifft, (70, 96)),
                                      (native.fftn, (3, 8, 16)),
                                      (native.ifftn, (3, 8, 16))])
def test_cpu_tensor_in_cpu_tensor_out(rng, fn, shape):
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    t = torch.from_numpy(x)
    got = fn(t)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.complex64
    assert np.array_equal(got.numpy(), fn(x))
    # conjugate views and non-contiguous tensors are resolved first
    assert np.array_equal(fn(t.conj()).numpy(), fn(np.conj(x)))
    assert np.array_equal(fn(t.transpose(0, -1)).numpy(),
                          fn(np.ascontiguousarray(x.swapaxes(0, -1))))


def test_cpu_tensor_planes(rng):
    re = torch.from_numpy(rng.standard_normal((40, 96)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((40, 96)).astype(np.float32))
    o_re, o_im = native.fft_planes(re, im)
    assert isinstance(o_re, torch.Tensor) and isinstance(o_im, torch.Tensor)
    r_re, r_im = native.fft_planes(re.numpy(), im.numpy())
    assert np.array_equal(o_re.numpy(), r_re)
    assert np.array_equal(o_im.numpy(), r_im)


@pytest.mark.parametrize("fn", [native.fft, native.ifft, native.fftn,
                                native.ifftn])
def test_device_tensor_is_refused(fn):
    """A tensor off the host raises ValueError naming its device; a meta
    tensor stands in for a CUDA one, which the CPU cannot make."""
    x = torch.empty((3, 8, 16), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="host engine: got a tensor on meta"):
        fn(x)
    with pytest.raises(ValueError, match="host engine"):
        native.fft_planes(x.real, x.imag)


def test_exports_match_tpufft():
    assert sorted(native.__all__) == sorted(ref_native.__all__)

"""The minor-axis kernel's plain version against tpufft's ``_build_minor``.

tpufft's Pallas kernel runs in interpret mode on the CPU (as
``tests/test_kernels.py`` runs it), the port's plain version in torch ops,
on the same planes made from a numpy seed. Tolerances (normalized by the
spectrum's magnitude):

* 1e-5 against ``precision="highest"``: both sides compute in f32 with the
  same factorization and tables, and differ only in summation order;
* 1e-3 against the default bf16x3 (``assert_spectrum_close``'s c64 bound):
  tpufft emulates f32 with three bf16 passes;
* 8e-3 for bf16 storage, the ``profile="fast"`` error bound in README.md:
  both sides round their f32 result to bf16 at the store.

The kernel's forms (``minor_fft.form``) and its line form's four-step are
checked here too: the split ``line_split`` with the table exponents
(k1 j2) mod n, run in torch ops against ``_build_minor``
(``assert_spectrum_close``, c64), and a model of the tile's indexing
(every element written and read back once, no bank conflict).

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import minor_fft
from tpufft_torch.planner import factorize, kernel_factors
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

BATCH = 130  # not a multiple of tpufft's 128-row lane block
NS = [8, 93, 128, 256, 960, 1024, 1792]


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _planes(n, rng, batch=BATCH):
    re = rng.standard_normal((batch, n)).astype(np.float32)
    im = rng.standard_normal((batch, n)).astype(np.float32)
    return re, im


def _tpufft(re, im, inverse, scale, precision, storage="f32"):
    n = re.shape[1]
    dt = jnp.float32 if storage == "f32" else jnp.bfloat16
    run = tp_mxu._build_minor(n, inverse, float(scale), 128, precision, True,
                              storage)
    zr, zi = run(jnp.asarray(re, dt), jnp.asarray(im, dt))
    return (np.asarray(zr.astype(jnp.float32))
            + 1j * np.asarray(zi.astype(jnp.float32)))


def _port(re, im, inverse, scale, dtype=torch.float32):
    zr, zi = minor_fft.fft_minor_reference(
        torch.from_numpy(re).to(dtype), torch.from_numpy(im).to(dtype),
        inverse=inverse, scale=scale)
    assert zr.dtype == zi.dtype == dtype
    return zr.float().numpy() + 1j * zi.float().numpy()


@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_reference_matches_build_minor_highest(n, inverse, unit_scale, rng):
    re, im = _planes(n, rng)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = _tpufft(re, im, inverse, scale, "highest")
    assert _err(_port(re, im, inverse, scale), ref) < 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_reference_matches_build_minor_bf16x3(n, inverse, rng):
    re, im = _planes(n, rng)
    scale = 1.0 / n if inverse else 1.0
    ref = _tpufft(re, im, inverse, scale, "bf16x3")
    assert _err(_port(re, im, inverse, scale), ref) < 1e-3


@pytest.mark.parametrize("n", NS)
def test_reference_matches_build_minor_bf16_storage(n, rng):
    re, im = _planes(n, rng)
    ref = _tpufft(re, im, False, 1.0, "highest", storage="bf16")
    got = _port(re, im, False, 1.0, dtype=torch.bfloat16)
    assert _err(got, ref) < 8e-3


@pytest.mark.parametrize("n", [1, 127 * 129])
def test_reference_outside_tpufft_factorization(n, rng):
    """Lengths the CUDA kernel takes but tpufft's single pass does not:
    the plain version runs the torch-op Stockham in f32."""
    assert kernel_factors(n) is None and minor_fft.supported(n, torch.float32)
    re, im = _planes(n, rng, batch=3)
    got = _port(re, im, False, 1.0)
    assert _err(got, np.fft.fft(re + 1j * im.astype(np.float64))) < 1e-5


def test_envelope_covers_tpufft_single_pass():
    """Every length tpufft's minor kernel takes is inside the CUDA kernel's
    envelope, and the kernel's radices multiply to n."""
    for n in range(1, minor_fft.MAX_N + 1):
        if kernel_factors(n) is not None:
            assert minor_fft.supported(n, torch.float32), n
        if minor_fft.supported(n, torch.bfloat16):
            rad = minor_fft.radices(n)
            assert int(np.prod(rad, dtype=np.int64)) == n, n
            assert all(2 <= r <= minor_fft.MAX_PRIME for r in rad), n
            # the C entry point takes 2, 4, 8 or an odd radix
            assert all(r in (2, 4, 8) or r % 2 for r in rad), n
    assert not minor_fft.supported(131, torch.float32)      # prime > 127
    assert not minor_fft.supported(minor_fft.MAX_N + 1, torch.float32)
    assert not minor_fft.supported(1024, torch.float64)
    assert not minor_fft.supported(0, torch.float32)
    assert minor_fft.radices(1024) == (8, 8, 8, 2)
    assert minor_fft.radices(93) == (3, 31)
    assert factorize(127 * 129) == [3, 43, 127]
    assert minor_fft.supported(127 * 129, torch.float32)


def test_wrapper_cpu_runs_plain_version(rng):
    re, im = _planes(93, rng, batch=4)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    minor_fft.reset_counts()
    got = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
    ref = minor_fft.fft_minor_reference(xr, xi, inverse=False, scale=1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert minor_fft.launches == 0
    assert minor_fft.reference_cuda_calls == 0


@pytest.mark.parametrize("xr,xi,match", [
    (torch.empty(4, 8, device="meta"), torch.empty(4, 8, device="meta"),
     "CUDA device"),
    (torch.empty(4, 8), torch.empty(4, 8, device="meta"), "CUDA device"),
])
def test_wrapper_refuses_non_cuda_devices(xr, xi, match):
    """A tensor that is not on the CPU launches the kernel or raises; it
    never runs the plain version."""
    with pytest.raises(ValueError, match=match):
        minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)


# ----------------------------------------------------------------------------
# The kernel's two forms, and the line form's four-step split
# ----------------------------------------------------------------------------

POW2 = [2 ** k for k in range(1, 13)]   # 2 .. 4096: the line form


@pytest.mark.parametrize("n,n_in,expected", (
    [(n, None, "lines") for n in POW2]
    + [(n, None, "stages") for n in (1, 93, 480, 960, 1792, 8192, 16384)]
    + [(128, 93, "stages"),                 # a padded call (K9)
       (1024, 1024, "lines"),
       (131, None, None),                   # prime factor above 127
       (minor_fft.MAX_N + 1, None, None)]))
def test_form(n, n_in, expected):
    """The form each length runs; the envelope (``supported``) is the one
    the stage form alone had: every length in it has a form."""
    assert minor_fft.form(n, n_in) == expected
    assert (expected is not None) == minor_fft.supported(n, torch.float32)
    split = minor_fft.line_split(n)
    if expected == "lines" and n_in in (None, n):
        assert split[0] * split[1] == n and max(split) <= 64
    elif n_in is None:
        assert split is None


def _four_step_model(re, im, inverse, scale):
    """The line form's arithmetic in torch ops: n = N1 N2 from
    ``line_split``; pass 1 the N1-long DFTs of the columns j2 of the (N1,
    N2) view (W_N1^(k1 j1) read from the n-table at stride N2, as
    ``line_fft`` reads it), the twiddle w^(k1 j2) read at (k1 j2) mod n,
    pass 2 the N2-long DFTs of the rows k1 (table stride N1), out
    X[k1 + N1 k2], scaled once."""
    n = re.shape[1]
    n1, n2 = minor_fft.line_split(n)
    tab = minor_fft._device_twiddles(n, inverse, torch.device("cpu"))
    w = torch.complex(tab[:, 0], tab[:, 1])
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    x = x.reshape(-1, n1, n2)                      # [b, j1, j2]
    k1 = torch.arange(n1)
    k2 = torch.arange(n2)
    w1 = w[(k1[:, None] * k1[None, :] * n2) % n]   # [k1, j1]
    y = torch.einsum("kj,bjm->bkm", w1, x)         # [b, k1, j2]
    y = y * w[(k1[:, None] * k2[None, :]) % n]     # w^(k1 j2)
    w2 = w[(k2[:, None] * k2[None, :] * n1) % n]   # [k2, j2]
    z = torch.einsum("qm,bkm->bkq", w2, y)         # [b, k1, k2]
    z = z.transpose(1, 2).reshape(-1, n) * scale   # X[k1 + N1 k2]
    return z.numpy()


@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [128, 256, 1024, 4096])
def test_line_split_model_matches_build_minor(n, inverse, unit_scale, rng):
    """The four-step the line form runs, with ``line_split``'s factors and
    the table exponents (k1 j2) mod n, against tpufft's ``_build_minor``
    in interpret mode."""
    from conftest import assert_spectrum_close
    re, im = _planes(n, rng, batch=5)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = _tpufft(re, im, inverse, scale, "highest")
    got = _four_step_model(re, im, inverse, scale)
    assert_spectrum_close(got, ref, np.complex64)
    assert _err(got, ref) < 1e-5


def _lane_out(n, r):
    """Index in its line of register r after ``lane_fft<n>`` (n = 8, 16,
    32: radix-A then radix-B, A = 8 or 4)."""
    a = 4 if n == 16 else 8
    b = n // a
    return r // b + a * (r % b)


def _line_out(n, p, r):
    """``line_out<n>``: a line in one lane, or a 64-line on a lane pair at
    place p (``pair_out``)."""
    if n == 64:
        return _lane_out(32, r % 16 + 16 * p) + 32 * (r // 16)
    return _lane_out(n, r)


def _tile_accesses(n):
    """Per warp instruction of a team, the lanes' tile positions (float2)
    and the elements of the (N1, N2) views they carry, indexed as
    ``minor_lane_kernel`` indexes them: pass 1's writes (lane t holds the
    column lines t + 32 W s, or for N1 = 64 line (t mod 16) + 16 (t / 32)
    on the pair t, t ^ 16) and pass 2's reads (the lines k1 + N1 r, alike);
    positions r n + k1 N2 + (j2 ^ ((k1 + N1 r) mod 16))."""
    geo = minor_fft.line_geometry(n)
    n1, n2, tw = geo["n1"], geo["n2"], geo["team_warps"]
    lanes = 32 * tw

    def pos(row, k1, j2):
        return row * n + k1 * n2 + (j2 ^ ((k1 + n1 * row) & 15))

    def lines(length, t):
        p = (t >> 4) & 1
        if length == 64:
            return p, [(t & 15) + 16 * (t >> 5)]
        return p, [t + lanes * s for s in range(32 // length)]

    writes, reads = [], []
    for w in range(tw):
        for s in range(1 if n1 == 64 else 32 // n1):
            for q in range(32 if n1 == 64 else n1):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    p, ls = lines(n1, t)
                    row, j2 = divmod(ls[s], n2)
                    k1 = _line_out(n1, p, q)
                    acc.append((pos(row, k1, j2), (row, k1, j2)))
                writes.append(acc)
        for s in range(1 if n2 == 64 else 32 // n2):
            for j in range(32 if n2 == 64 else n2):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    p, ls = lines(n2, t)
                    row, k1 = divmod(ls[s], n1)
                    j2 = p + 2 * j if n2 == 64 else j
                    acc.append((pos(row, k1, j2), (row, k1, j2)))
                reads.append(acc)
    return geo, writes, reads


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
def test_line_tile_mapping(n):
    """The team's tile: pass 1 writes every element of its rows' (N1, N2)
    views once, at a distinct position; pass 2 reads each back from the
    position it was written to; and each half warp of every write and read
    instruction touches 16 distinct bank pairs (8-byte values: position mod
    16), so the tile has no bank conflict."""
    geo, writes, reads = _tile_accesses(n)
    where = {}
    for acc in writes:
        for p, e in acc:
            assert e not in where
            where[e] = p
    assert len(where) == geo["rows"] * n
    assert len(set(where.values())) == len(where)
    assert max(where.values()) < geo["rows"] * n
    seen = set()
    for acc in reads:
        for p, e in acc:
            assert where[e] == p
            seen.add(e)
    assert seen == set(where)
    for acc in writes + reads:
        for half in (acc[:16], acc[16:]):
            assert len({p % 16 for p, _ in half}) == 16, (n, half)

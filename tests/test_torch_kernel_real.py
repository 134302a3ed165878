"""The real-transform kernels' plain versions (K7 rfft, K8 irfft) against
tpufft's ``_build_minor_r2c`` and ``_build_minor_c2r``.

tpufft's Pallas kernels run in interpret mode on the CPU (as
``tests/test_kernels.py`` runs them) with ``precision="highest"``; the port
runs ``real_fft.rfft_minor_reference`` / ``irfft_minor_reference`` (what
the wrappers run for CPU tensors) on the same planes made from a numpy
seed. tpufft's kernels stop at n = 1024; above it the plain versions are
held against ``np.fft``. Tolerances, normalized by the magnitude of the
result:

* 1e-5 for f32 storage: both sides compute in f32 and differ in summation
  order (a dense matmul against the port's FFT);
* 8e-3 for bf16 storage, the ``profile="fast"`` bound in README.md: both
  round their f32 result to bf16 at the store;
* 1e-5 against ``np.fft`` in float64 above 1024.

K7's and K8's line forms (``real_fft.form``: even n from 256 to 8192
with n/2 a power of two; even n whose half is a mixed-radix length of
K1's lists, ``real_fft._REAL_STEP``; odd n = 93) are checked here as
models: their arithmetic in torch ops with the kernels' indexing (1e-5
against ``_build_minor_r2c`` / ``_build_minor_c2r`` up to 1024 and against
``np.fft`` above; 8e-3 in bf16 storage), and the tile's indexing of the
untangle and the tangle (every element written and read back once, no
bank conflict).

The CUDA kernels themselves need the card: ``test_torch_cuda.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpufft
from tpufft import PlanConfig as TPPlanConfig
from tpufft import api as tp_api
from tpufft.kernels import mxu_fft as tp_mxu
from tpufft.planner import factorize as tp_factorize

from test_torch_kernel_minor import _line_out, _slots
import tpufft_torch
from tpufft_torch import PlanConfig, api
from tpufft_torch.kernels import minor_fft, real_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

NS = [2, 3, 8, 93, 127, 128, 131, 1024]
TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")
BATCH = 5


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _dtypes(storage):
    return ((jnp.float32, torch.float32) if storage == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _rfft_both(x, scale, storage):
    jdt, tdt = _dtypes(storage)
    n = x.shape[1]
    run = tp_mxu._build_minor_r2c(n, float(scale),
                                  tp_mxu.choose_lane_block(n, TP_CFG),
                                  "highest", True, storage)
    zr, zi = run(jnp.asarray(x, jdt))
    ref = (np.asarray(zr.astype(jnp.float32))
           + 1j * np.asarray(zi.astype(jnp.float32)))
    gr, gi = real_fft.rfft_minor_reference(torch.from_numpy(x).to(tdt),
                                           scale=scale)
    assert gr.dtype == gi.dtype == tdt
    return gr.float().numpy() + 1j * gi.float().numpy(), ref


def _irfft_both(xr, xi, n, scale, storage):
    jdt, tdt = _dtypes(storage)
    run = tp_mxu._build_minor_c2r(n, float(scale),
                                  tp_mxu.choose_lane_block(n, TP_CFG),
                                  "highest", True, storage)
    ref = np.asarray(run(jnp.asarray(xr, jdt),
                         jnp.asarray(xi, jdt)).astype(jnp.float32))
    got = real_fft.irfft_minor_reference(
        torch.from_numpy(xr).to(tdt), torch.from_numpy(xi).to(tdt), n=n,
        scale=scale)
    assert got.dtype == tdt and got.shape == (xr.shape[0], n)
    return got.float().numpy(), ref


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", NS)
def test_rfft_reference_matches_build_minor_r2c(n, unit_scale):
    scale = 1.0 if unit_scale else 1.0 / n
    got, ref = _rfft_both(_real((BATCH, n), n), scale, "f32")
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", NS)
def test_irfft_reference_matches_build_minor_c2r(n, unit_scale):
    """Random planes: the imaginary parts at DC and (even n) Nyquist are
    not zero, and both sides must ignore them."""
    scale = 1.0 if unit_scale else 1.0 / n
    m1 = n // 2 + 1
    got, ref = _irfft_both(_real((BATCH, m1), n), _real((BATCH, m1), n + 1),
                           n, scale, "f32")
    assert _err(got, ref) < 1e-5


@pytest.mark.parametrize("n", NS)
def test_real_references_bf16_storage(n):
    got, ref = _rfft_both(_real((BATCH, n), n), 1.0, "bf16")
    assert _err(got, ref) < 8e-3
    m1 = n // 2 + 1
    got, ref = _irfft_both(_real((BATCH, m1), n), _real((BATCH, m1), 2 * n),
                           n, 1.0 / n, "bf16")
    assert _err(got, ref) < 8e-3


@pytest.mark.parametrize("n", [2048, 4095, 16383, 32768])
def test_real_references_above_1024_match_numpy(n):
    x = _real((2, n), n)
    zr, zi = real_fft.rfft_minor_reference(torch.from_numpy(x), scale=0.5)
    spec = np.fft.rfft(x.astype(np.float64)) * 0.5
    assert _err(zr.numpy() + 1j * zi.numpy(), spec) < 1e-5
    y = real_fft.irfft_minor_reference(zr, zi, n=n, scale=2.0 / n)
    assert _err(y.numpy(), x) < 1e-5


def test_half_twiddle_matches_tpufft():
    """The host tables of the packed paths: api's f64 planes are tpufft's
    ``_half_twiddle``; the kernels' f32 table is the same values with
    exact quarter points."""
    for m, n in ((4, 8), (512, 1024), (46, 93)):
        for ours, theirs in zip(api._half_twiddle(m, n),
                                tp_api._half_twiddle(m, n)):
            np.testing.assert_array_equal(ours, theirs)
    for n in (2, 8, 1024, 32768):
        table = real_fft._device_half_twiddle(n, torch.device("cpu"))
        wr, wi = tp_api._half_twiddle(n // 2, n)
        assert table.shape == (n // 2 + 1, 2)
        assert np.max(np.abs(table[:, 0].numpy() - wr)) < 1e-7
        assert np.max(np.abs(table[:, 1].numpy() - wi)) < 1e-7


def test_envelope():
    """Even n with n/2 inside K1's envelope (up to 32768), odd n inside
    K1's; every n <= 1024 that tpufft's K7/K8 take except the lengths with
    a prime factor above 127."""
    for n in (2, 3, 8, 93, 127, 128, 254, 1024, 16383, 32768):
        assert real_fft.supported(n, torch.float32), n
        assert real_fft.supported(n, torch.bfloat16), n
    for n in (1, 131, 262, 1021, 32769, 65536):
        assert not real_fft.supported(n, torch.float32), n
    assert not real_fft.supported(128, torch.float64)
    for n in range(2, 1025):
        stage = n // 2 if n % 2 == 0 else n
        big = stage > 1 and max(tp_factorize(stage)) > 127
        assert real_fft.supported(n, torch.float32) == (not big), n


def test_wrappers_cpu_run_plain_versions():
    x = torch.from_numpy(_real((3, 96), 0))
    real_fft.reset_counts()
    got = real_fft.rfft_minor(x, scale=0.5)
    ref = real_fft.rfft_minor_reference(x, scale=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    back = real_fft.irfft_minor(*got, n=96, scale=2.0 / 96)
    assert torch.equal(back, real_fft.irfft_minor_reference(*got, n=96,
                                                            scale=2.0 / 96))
    assert _err(back.numpy(), x.numpy()) < 1e-5
    assert real_fft.launches == {"r2c": 0, "c2r": 0}
    assert real_fft.reference_cuda_calls == 0


def test_wrappers_refuse_non_cuda_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        real_fft.rfft_minor(x, scale=1.0)
    h = torch.empty(2, 5, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        real_fft.irfft_minor(h, h, n=8, scale=1.0)


# ----------------------------------------------------------------------------
# K7's line form (power-of-two n/2 from 128 to 4096)
# ----------------------------------------------------------------------------

LINE_NS = [256, 512, 1024, 2048, 4096, 8192]


def _partner(n1, n2):
    """The line and register of Z[m - k] for Z[k1 + N1 k2] after pass 2:
    line N1 - k1 with k2 mirrored to N2 - 1 - k2, and line k1 = 0 paired
    with itself, k2 -> (N2 - k2) mod N2. Two (N1, N2) index grids."""
    k1 = torch.arange(n1)[:, None].expand(n1, n2)
    k2 = torch.arange(n2)[None, :].expand(n1, n2)
    own = k1 == 0
    return ((n1 - k1) % n1,
            torch.where(own, (n2 - k2) % n2, n2 - 1 - k2))


def _line_form_model(x, scale):
    """K7's line form in torch ops (complex64, f32 arithmetic) with the
    kernel's indexing: z[j] = x[2j] + i x[2j+1] in the (N1, N2) view of
    the packed row (j = N2 j1 + j2, ``line_split(m)``), the N1-long DFTs
    of the columns (table exponents k1 j1 N2 mod m), the twiddle w^(k1 j2)
    at (k1 j2) mod m, the N2-long DFTs of the rows k1 (exponents k2 j2 N1),
    giving Z[k1 + N1 k2]; then the untangle of each pair k < m/2 with its
    partner Z[m - k] gathered from the mirrored line (``_partner``), X[k] =
    (s - u)/2 and X[m-k] = conj(s + u)/2 with s = Z[k] + conj Z[m-k] and u
    = i W^k (Z[k] - conj Z[m-k]), and X[m/2] = conj Z[m/2]; scaled once."""
    n = x.shape[1]
    m, half = n // 2, n // 4
    geo = real_fft.line_geometry(n)
    n1, n2 = geo["n1"], geo["n2"]
    cpu = torch.device("cpu")
    tab = minor_fft._device_twiddles(m, False, cpu)
    w = torch.complex(tab[:, 0], tab[:, 1])
    hw = real_fft._device_half_twiddle(n, cpu)
    big_w = torch.complex(hw[:, 0], hw[:, 1])
    xt = torch.from_numpy(x)
    z = torch.complex(xt[:, 0::2], xt[:, 1::2]).reshape(-1, n1, n2)
    k1 = torch.arange(n1)
    k2 = torch.arange(n2)
    y = torch.einsum("kj,bjm->bkm", w[(k1[:, None] * k1[None, :] * n2) % m],
                     z)                                 # [b, k1, j2]
    y = y * w[(k1[:, None] * k2[None, :]) % m]          # w^(k1 j2)
    zz = torch.einsum("qm,bkm->bkq",
                      w[(k2[:, None] * k2[None, :] * n1) % m], y)
    p1, p2 = _partner(n1, n2)
    k = k1[:, None] + n1 * k2[None, :]                  # Z[k1 + N1 k2]
    assert torch.equal(p1 + n1 * p2, (m - k) % m)
    a = torch.zeros(zz.shape[0], m, dtype=zz.dtype)
    b = torch.zeros_like(a)
    a[:, k.reshape(-1)] = zz.reshape(-1, m)             # Z in natural order
    b[:, k.reshape(-1)] = zz[:, p1, p2].reshape(-1, m)  # its partners
    mid = a[:, half]
    a, b = a[:, :half], b[:, :half]                     # the pairs k < m/2
    s = a + b.conj()
    u = 1j * big_w[:half] * (a - b.conj())
    out = torch.zeros(a.shape[0], m + 1, dtype=zz.dtype)
    ks = torch.arange(half)
    out[:, ks] = 0.5 * (s - u)
    out[:, m - ks] = 0.5 * (s + u).conj()
    out[:, half] = mid.conj()
    return (out * scale).numpy()


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", LINE_NS)
def test_line_form_model_matches_tpufft(n, unit_scale):
    """The line form's arithmetic against tpufft's ``_build_minor_r2c`` in
    interpret mode where tpufft takes n (up to 1024), and against
    ``np.fft.rfft`` in float64 above."""
    assert real_fft.form(n) == "lines"
    scale = 1.0 if unit_scale else 1.0 / n
    x = _real((BATCH, n), n + 7)
    got = _line_form_model(x, scale)
    if n <= 1024:
        jx = jnp.asarray(x, jnp.float32)
        run = tp_mxu._build_minor_r2c(n, float(scale),
                                      tp_mxu.choose_lane_block(n, TP_CFG),
                                      "highest", True, "f32")
        zr, zi = run(jx)
        ref = np.asarray(zr) + 1j * np.asarray(zi)
    else:
        ref = np.fft.rfft(x.astype(np.float64)) * scale
    assert _err(got, ref) < 1e-5


def _untangle_tile_accesses(n):
    """Per warp instruction of a team, the lanes' tile positions (float2)
    and the elements (row, k) of Z they carry, indexed as
    ``rfft_lane_kernel`` indexes them at n = 2m: pass 2's writes of Z (lane
    t holds lines t + 32 W s, or for N2 = 64 line (t mod 16) + 16 (t / 32)
    on the pair t, t ^ 16; register q holds k2 = line_out(p, q)) at r m +
    ((k1 + N1 k2) ^ ((N1 r) mod 16)), and the untangle's two reads of each
    of its 16 instructions, Z[k] and Z[(m - k) mod m] of e = t + lanes i,
    r = e / (m/2), k = e mod (m/2). Also the lone reads of Z[m/2] by the
    lanes of k = 0."""
    m = n // 2
    geo = real_fft.line_geometry(n)
    n1, n2, tw = geo["n1"], geo["n2"], geo["team_warps"]
    lanes, rows, half = 32 * tw, geo["rows"], m // 2

    def pos(row, k):
        return row * m + (k ^ ((n1 * row) & 15))

    writes, reads, lone = [], [], []
    for w in range(tw):
        for s in range(1 if n2 == 64 else 32 // n2):
            for q in range(32 if n2 == 64 else n2):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    p = (t >> 4) & 1
                    line = ((t & 15) + 16 * (t >> 5) if n2 == 64
                            else t + lanes * s)
                    row, k1 = divmod(line, n1)
                    k = k1 + n1 * _line_out(n2, p, q)
                    acc.append((pos(row, k), (row, k)))
                writes.append(acc)
        for i in range(rows * half // lanes):
            acc_a, acc_b = [], []
            for t in range(32 * w, 32 * w + 32):
                row, k = divmod(t + lanes * i, half)
                acc_a.append((pos(row, k), (row, k)))
                kb = (m - k) % m
                acc_b.append((pos(row, kb), (row, kb)))
                if k == 0:
                    lone.append((pos(row, half), (row, half)))
            reads += [acc_a, acc_b]
    return geo, writes, reads, lone


@pytest.mark.parametrize("n", LINE_NS)
def test_untangle_tile_mapping(n):
    """The untangle's round trip through the team's tile: pass 2 writes
    every Z[k] of the team's rows once, at distinct positions inside the
    tile; the untangle reads each back from where it was written, every
    element once but Z[0], which k = 0 reads as both halves of its
    self-paired bin; and each half warp of every write and read
    instruction touches 16 distinct bank pairs (8-byte values: position
    mod 16). Passes 1 and 2 index the tile as the four-step at length m
    (``test_line_tile_mapping``, K1's geometry up to 2048 and K7's and
    K8's own at 4096)."""
    geo, writes, reads, lone = _untangle_tile_accesses(n)
    m = n // 2
    where = {}
    for acc in writes:
        for p, e in acc:
            assert e not in where
            where[e] = p
    assert len(where) == geo["rows"] * m
    assert sorted(where.values()) == list(range(geo["rows"] * m))
    seen = {}
    for acc in reads + [lone]:
        for p, e in acc:
            assert where[e] == p
            seen[e] = seen.get(e, 0) + 1
    assert set(seen) == set(where)
    assert all(c == (2 if k == 0 else 1) for (_, k), c in seen.items())
    for acc in writes + reads:
        for half in (acc[:16], acc[16:]):
            assert len({p % 16 for p, _ in half}) == 16, (n, half)


def test_form_across_the_envelope():
    """``real_fft.form``: the line form for even n whose half is a power of
    two from 128 to 4096 or a mixed-radix length of K1's lists
    (``_REAL_STEP``: n = 24 to 7680), and for odd n = 93; the stage form
    for every other length in the envelope (other odd n, even n with a
    half on no list such as 1000 -> 500, n <= 128 at power-of-two halves,
    n > 8192), None outside it; every line form has a geometry
    (``real_fft.line_geometry``)."""
    mixed = {2 * m for m in real_fft._REAL_STEP}
    assert len(mixed) == 29 and real_fft._ODD_LINES == (93,)
    for n in range(2, 16500):
        f = real_fft.form(n)
        m = n // 2
        if not real_fft.supported(n, torch.float32):
            assert f is None, n
        elif (n % 2 == 0 and 128 <= m <= 4096 and m & (m - 1) == 0
              or n in mixed or n == 93):
            assert f == "lines", n
            assert real_fft.line_geometry(n) is not None, n
        else:
            assert f == "stages", n
            assert real_fft.line_geometry(n) is None, n
    for n in (1, 0, 131, 8194, 32769, 65536):
        assert real_fft.form(n) is None, n
    assert [real_fft.form(n) for n in (128, 254, 256, 480, 8192, 16384,
                                       32768)] == [
        "stages", "stages", "lines", "lines", "lines", "stages", "stages"]
    new = (24, 48, 96, 192, 384, 768, 1536, 3072, 6144, 40, 80, 160, 320,
           640, 1280, 2560, 5120, 60, 120, 240, 480, 960, 1920, 3840, 7680,
           186, 2000, 2160, 4320, 93)
    assert len(new) == 30 and set(new) == mixed | {93}
    assert all(real_fft.form(n) == "lines" for n in new)
    for n in (1000, 127, 8640, 128, 95, 8200, 1022):
        assert real_fft.form(n) == "stages", n


# ----------------------------------------------------------------------------
# K8's line form (the same lengths): the inverse-real line core of
# csrc/real_fft.cuh
# ----------------------------------------------------------------------------

def _inverse_line_model(xr, xi, scale):
    """K8's line form in torch ops (complex64, f32 arithmetic) with the
    kernel's indexing: the tangle of each pair k < m/2, Z'[k] = (X[k] +
    conj X[m-k]) + i conj(W^k) (X[k] - conj X[m-k]) and Z'[m-k] = (X[m-k] +
    conj X[k]) - i W^k (X[m-k] - conj X[k]) with the Nyquist bin as X[m]
    and the imaginary parts of DC and Nyquist dropped, Z'[m/2] = 2 conj
    X[m/2]; the inverse N1-long DFTs of the columns j2 of the (N1, N2) view
    of Z' (table exponents k1 j1 N2), the twiddle w^(k1 j2), the N2-long
    DFTs of the rows k1 (exponents k2 j2 N1), giving z'[k1 + N1 k2] =
    (x[2j], x[2j+1]); scaled once."""
    m1 = xr.shape[1]
    m = m1 - 1
    n, half = 2 * m, m // 2
    geo = real_fft.line_geometry(n)
    n1, n2 = geo["n1"], geo["n2"]
    cpu = torch.device("cpu")
    tab = minor_fft._device_twiddles(m, True, cpu)
    w = torch.complex(tab[:, 0], tab[:, 1])
    hw = real_fft._device_half_twiddle(n, cpu)
    big_w = torch.complex(hw[:, 0], hw[:, 1])
    X = torch.complex(torch.from_numpy(xr), torch.from_numpy(xi))
    X[:, 0] = X[:, 0].real.to(X.dtype)
    X[:, m] = X[:, m].real.to(X.dtype)
    ks = torch.arange(half)
    a, b = X[:, ks], X[:, m - ks]
    wk = big_w[:half]
    zp = torch.zeros(X.shape[0], m, dtype=X.dtype)
    zp[:, ks] = (a + b.conj()) + 1j * wk.conj() * (a - b.conj())
    zp[:, (m - ks[1:])] = ((b + a.conj()) - 1j * wk * (b - a.conj()))[:, 1:]
    zp[:, half] = 2 * X[:, half].conj()
    z = zp.reshape(-1, n1, n2)                          # [b, j1, j2]
    k1 = torch.arange(n1)
    k2 = torch.arange(n2)
    y = torch.einsum("kj,bjm->bkm", w[(k1[:, None] * k1[None, :] * n2) % m],
                     z)                                 # [b, k1, j2]
    y = y * w[(k1[:, None] * k2[None, :]) % m]          # w^(k1 j2)
    zz = torch.einsum("qm,bkm->bkq",
                      w[(k2[:, None] * k2[None, :] * n1) % m], y)
    out = torch.zeros(X.shape[0], m, dtype=X.dtype)
    out[:, (k1[:, None] + n1 * k2[None, :]).reshape(-1)] = zz.reshape(-1, m)
    out = out * scale
    return torch.stack([out.real, out.imag], -1).reshape(-1, n).numpy()


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", LINE_NS)
def test_inverse_line_form_model_matches_tpufft(n, unit_scale):
    """K8's line form's arithmetic against tpufft's ``_build_minor_c2r`` in
    interpret mode where tpufft takes n (up to 1024), and against
    ``np.fft.irfft`` in float64 above; random planes, so that the
    imaginary parts at DC and Nyquist are not zero and must be ignored."""
    assert real_fft.form(n) == "lines"
    scale = 1.0 if unit_scale else 1.0 / n
    m1 = n // 2 + 1
    xr, xi = _real((BATCH, m1), n + 3), _real((BATCH, m1), n + 4)
    got = _inverse_line_model(xr, xi, scale)
    if n <= 1024:
        ref = _irfft_both(xr, xi, n, scale, "f32")[1]
    else:
        ref = np.fft.irfft(xr.astype(np.float64) + 1j * xi, n=n) * n * scale
    assert _err(got, ref) < 1e-5


def _tangle_tile_accesses(n):
    """Per warp instruction of a team, the lanes' tile positions (float2)
    and the elements (row, j) of Z' they carry, indexed as
    ``tpufft_real::tangle`` and ``inverse_passes`` index them at n = 2m:
    the tangle's two writes of each of its instructions (lane t, e = t +
    lanes i, r = e / (m/2), k = e mod (m/2): Z'[k] at r m + k, then Z'[m -
    k] at r m + m - k, or Z'[m/2] at r m + m/2 in the lane of k = 0), and
    pass 1's reads of the columns (lane t holds lines t + 32 W s, or for
    N1 = 64 line (t mod 16) + 16 (t / 32) on the pair t, t ^ 16 with
    register j at j1 = p + 2j): r m + N2 j1 + j2. Also the bins each
    tangle instruction reads from the planes: (row, k) of X."""
    m = n // 2
    geo = real_fft.line_geometry(n)
    n1, n2, tw = geo["n1"], geo["n2"], geo["team_warps"]
    lanes, rows, half = 32 * tw, geo["rows"], m // 2
    writes, reads, loads = [], [], []
    for w in range(tw):
        for i in range(rows * half // lanes):
            first, second, lo, hi = [], [], [], []
            for t in range(32 * w, 32 * w + 32):
                row, k = divmod(t + lanes * i, half)
                first.append((row * m + k, (row, k)))
                j = half if k == 0 else m - k
                second.append((row * m + j, (row, j)))
                lo.append((row, k))
                hi.append((row, m - k))
            writes += [first, second]
            loads += [lo, hi]
        for s in range(1 if n1 == 64 else 32 // n1):
            for j in range(32 if n1 == 64 else n1):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    p = (t >> 4) & 1
                    line = ((t & 15) + 16 * (t >> 5) if n1 == 64
                            else t + lanes * s)
                    row, j2 = divmod(line, n2)
                    j1 = p + 2 * j if n1 == 64 else j
                    acc.append((row * m + n2 * j1 + j2, (row, n2 * j1 + j2)))
                reads.append(acc)
    return geo, writes, reads, loads


@pytest.mark.parametrize("n", LINE_NS)
def test_tangle_tile_mapping(n):
    """The tangle's round trip through the team's tile: every Z'[j] of the
    team's rows is written once, at distinct positions that fill the tile;
    pass 1 reads each back once from where it was written; each half warp
    of every write and read instruction touches 16 distinct bank pairs
    (8-byte values: position mod 16), with Z' in natural order and no
    swizzle; and each load instruction reads 32 consecutive bins of one
    row of a plane, ascending (k) or descending (m - k), the lane of k = 0
    taking the Nyquist bin."""
    geo, writes, reads, loads = _tangle_tile_accesses(n)
    m = n // 2
    where = {}
    for acc in writes:
        for p, e in acc:
            assert e not in where
            where[e] = p
    assert sorted(where.values()) == list(range(geo["rows"] * m))
    seen = {}
    for acc in reads:
        for p, e in acc:
            assert where[e] == p
            seen[e] = seen.get(e, 0) + 1
    assert set(seen) == set(where) and set(seen.values()) == {1}
    for acc in writes + reads:
        for half in (acc[:16], acc[16:]):
            assert len({p % 16 for p, _ in half}) == 16, (n, half)
    for lo, hi in zip(loads[::2], loads[1::2]):
        assert len({r for r, _ in lo + hi}) == 1
        assert [k for _, k in lo] == list(range(lo[0][1], lo[0][1] + 32))
        assert [k for _, k in hi] == list(range(hi[0][1], hi[0][1] - 32, -1))
        assert hi[0][1] <= m


def test_half_step_matches_the_header():
    """``real_fft._HALF_STEP`` is ``with_line_step``'s list in
    ``csrc/real_fft.cuh`` (the LaneStep K7 and K8 launch at each half m),
    and up to m = 2048 K1's own power-of-two four-step at m, which K1 runs
    at those lengths; at m = 4096 K1 takes three factors and K7/K8 keep
    the 64 x 64 four-step."""
    import pathlib
    import re
    csrc = pathlib.Path(real_fft.__file__).resolve().parent.parent / "csrc"
    body = (csrc / "real_fft.cuh").read_text().split(
        "int with_line_step(int n, F&& f) {")[1].split(
        "cudaErrorInvalidValue")[0]
    listed = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        r"case (\d+): return f\(LaneStep<(\d+), (\d+), (\d+), (\d+)>",
        body)}
    assert listed == real_fft._HALF_STEP
    for m in listed:
        geo = real_fft.line_geometry(2 * m)
        if m <= 2048:
            assert geo == minor_fft.line_geometry(m), m
        else:
            assert minor_fft.line_split(m) == (16, 16, 16)
            assert (geo["n1"], geo["n2"], geo["team_warps"]) == (64, 64, 4)



def test_real_step_matches_the_header():
    """``real_fft._REAL_STEP`` and ``_ODD_LINES`` are the lists
    TPUFFT_REAL_{R3,R5,R15,ODD} and TPUFFT_REAL_ODD_N of
    ``csrc/real_fft.cuh``, each family instantiated by its own source
    (``real_line_*.cu``), on the halves of K1's own mixed-radix lists
    (``minor_fft._MIXED_STEP``, one family to one family); the line
    geometry of each is K1's four-step at the half (at n itself for odd
    n) with the (un)tangle's tile rows and pair slots."""
    import pathlib
    import re
    csrc = pathlib.Path(real_fft.__file__).resolve().parent.parent / "csrc"
    cuh = (csrc / "real_fft.cuh").read_text()
    minor = (csrc / "minor_fft.cuh").read_text()
    listed = {}
    for fam in ("R3", "R5", "R15", "ODD"):
        body = cuh.split(f"#define TPUFFT_REAL_{fam}(X)")[1].split(
            "#define")[0]
        rows = [tuple(int(v) for v in m.split(","))
                for m in re.findall(r"X\(([0-9, ]+)\)", body)]
        k1 = minor.split(f"#define TPUFFT_MINOR_{fam}(X)")[1].split(
            "#define")[0].split("\n\n")[0]
        halves = [int(m.split(",")[0])
                  for m in re.findall(r"X\(([0-9, ]+)\)", k1)]
        assert [r[0] for r in rows] == halves, fam
        for r in rows:
            listed[r[0]] = r[1:]
        odd = "TPUFFT_REAL_ODD_N" if fam == "ODD" else "TPUFFT_REAL_NONE"
        src = (csrc / f"real_line_{fam.lower()}.cu").read_text()
        assert (f"TPUFFT_REAL_FAMILY(launch_real_{fam.lower()}, "
                f"TPUFFT_REAL_{fam}, {odd})") in src
    assert listed == real_fft._REAL_STEP
    assert set(listed) == set(minor_fft._MIXED_STEP)
    odd = re.findall(r"#define TPUFFT_REAL_ODD_N\(X\)((?: X\(\d+\))+)", cuh)
    assert tuple(int(v) for v in re.findall(r"\d+", odd[0])) == \
        real_fft._ODD_LINES
    for m, (zs7, zh7, zs8, zh8) in real_fft._REAL_STEP.items():
        geo = real_fft.line_geometry(2 * m)
        assert geo == {**minor_fft.line_geometry(m),
                       "untangle_rs": zs7, "untangle_slots": zh7,
                       "tangle_rs": zs8, "tangle_slots": zh8}
        assert min(zs7, zs8) >= m and min(zh7, zh8) >= (m + 1) // 2
    for n in real_fft._ODD_LINES:
        assert real_fft.line_geometry(n) == minor_fft.line_geometry(n)


# ----------------------------------------------------------------------------
# The mixed-radix line form of K7 and K8 (even n = 2m, m on K1's lists; odd
# n = 93): K1's four-step with the real kernels' loads and hand-overs
# ----------------------------------------------------------------------------

MIXED_REAL = sorted(2 * m for m in real_fft._REAL_STEP)
NEW_REAL = MIXED_REAL + list(real_fft._ODD_LINES)
# tpufft's K7/K8 take n up to 1024: those held against it in interpret mode
TP_REAL = [93, 186, 480, 640, 960]


def _four_step_model(z, L, inverse):
    """K1's four-step at length L on the complex rows z (complex64, f32
    arithmetic) with the kernel's indexing (``minor_fft.line_geometry``:
    the N1-long DFTs of the columns j2 of the (N1, N2) view, table
    exponents k1 j1 N2, the twiddle w^(k1 j2), the N2-long DFTs of the rows
    k1, exponents k2 j2 N1), in natural order: X[k1 + N1 k2]."""
    geo = minor_fft.line_geometry(L)
    n1, n2 = geo["n1"], geo["n2"]
    tab = minor_fft._device_twiddles(L, inverse, torch.device("cpu"))
    w = torch.complex(tab[:, 0], tab[:, 1])
    k1 = torch.arange(n1)
    k2 = torch.arange(n2)
    y = torch.einsum("kj,bjm->bkm", w[(k1[:, None] * k1[None, :] * n2) % L],
                     z.reshape(-1, n1, n2))             # [b, k1, j2]
    y = y * w[(k1[:, None] * k2[None, :]) % L]          # w^(k1 j2)
    zz = torch.einsum("qm,bkm->bkq",
                      w[(k2[:, None] * k2[None, :] * n1) % L], y)
    out = torch.zeros(z.shape[0], L, dtype=z.dtype)
    out[:, (k1[:, None] + n1 * k2[None, :]).reshape(-1)] = zz.reshape(-1, L)
    return out


def _half_twiddle(n):
    hw = real_fft._device_half_twiddle(n, torch.device("cpu"))
    return torch.complex(hw[:, 0], hw[:, 1])


def _rfft_mixed_model(x, scale):
    """K7's mixed-radix line form in torch ops: at even n = 2m the packed
    load z[j] = x[2j] + i x[2j+1], K1's four-step at m, then the untangle
    of each pair (k, m - k), k < ceil(m/2) (k = 0: Z[0] with itself, giving
    X[0] and X[m]; at even m also X[m/2] = conj Z[m/2]), X[k] = (s - u)/2,
    X[m-k] = conj(s + u)/2, s = Z[k] + conj Z[m-k], u = i W^k (Z[k] - conj
    Z[m-k]); at odd n the four-step at n on (x, 0) and the bins k <= n/2
    stored. Every bin is written once (asserted); scaled once."""
    n = x.shape[1]
    xt = torch.from_numpy(x).float()
    if n % 2:
        Z = _four_step_model(torch.complex(xt, torch.zeros_like(xt)), n,
                             False)
        return (Z[:, :n // 2 + 1] * scale).numpy()
    m = n // 2
    Z = _four_step_model(torch.complex(xt[:, 0::2], xt[:, 1::2]), m, False)
    big_w = _half_twiddle(n)
    out = torch.zeros(Z.shape[0], m + 1, dtype=Z.dtype)
    written = torch.zeros(m + 1, dtype=torch.int64)
    ks = torch.arange((m + 1) // 2)
    a, b = Z[:, ks], Z[:, (m - ks) % m]
    s_ = a + b.conj()
    u = 1j * big_w[ks] * (a - b.conj())
    out[:, ks] = 0.5 * (s_ - u)
    out[:, m - ks] = 0.5 * (s_ + u).conj()
    written[ks] += 1
    written[m - ks] += 1
    if m % 2 == 0:
        out[:, m // 2] = Z[:, m // 2].conj()
        written[m // 2] += 1
    assert torch.equal(written, torch.ones_like(written))
    return (out * scale).numpy()


def _irfft_mixed_model(xr, xi, n, scale):
    """K8's mixed-radix line form in torch ops: at even n = 2m the tangle of
    each pair (k, m - k), k < ceil(m/2), Z'[k] = (X[k] + conj X[m-k]) + i
    conj(W^k) (X[k] - conj X[m-k]) and (k > 0) Z'[m-k] = (X[m-k] + conj
    X[k]) - i W^k (X[m-k] - conj X[k]), the lane of k = 0 reading the
    Nyquist bin as X[m] with the imaginary parts of DC and Nyquist dropped,
    and at even m Z'[m/2] = 2 conj X[m/2]; the inverse four-step at m; the
    pairs z'[j] = (y[2j], y[2j+1]). At odd n: the gather X[j] for j <= n/2
    and conj X[n - j] above (the DC bin's imaginary part dropped), the
    inverse four-step at n, its real part. Every Z'[j] is written once
    (asserted); scaled once."""
    X = torch.complex(torch.from_numpy(xr).float(),
                      torch.from_numpy(xi).float())
    X[:, 0] = X[:, 0].real.to(X.dtype)
    if n % 2:
        j = torch.arange(n)
        src = torch.where(j <= n // 2, j, n - j)
        full = torch.where(j <= n // 2, X[:, src], X[:, src].conj())
        return (_four_step_model(full, n, True).real * scale).numpy()
    m = n // 2
    X[:, m] = X[:, m].real.to(X.dtype)
    big_w = _half_twiddle(n)
    ks = torch.arange((m + 1) // 2)
    a, b = X[:, ks], X[:, m - ks]
    wk = big_w[ks]
    zp = torch.zeros(X.shape[0], m, dtype=X.dtype)
    written = torch.zeros(m, dtype=torch.int64)
    zp[:, ks] = (a + b.conj()) + 1j * wk.conj() * (a - b.conj())
    written[ks] += 1
    far = ((b + a.conj()) - 1j * wk * (b - a.conj()))[:, 1:]
    zp[:, m - ks[1:]] = far
    written[m - ks[1:]] += 1
    if m % 2 == 0:
        zp[:, m // 2] = 2 * X[:, m // 2].conj()
        written[m // 2] += 1
    assert torch.equal(written, torch.ones_like(written))
    out = _four_step_model(zp, m, True) * scale
    return torch.stack([out.real, out.imag], -1).reshape(-1, n).numpy()


def _round_bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("unit_scale", [True, False],
                         ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("n", NEW_REAL)
def test_mixed_line_form_models_match_tpufft(n, unit_scale):
    """K7's and K8's mixed-radix line forms' arithmetic against tpufft's
    ``_build_minor_r2c`` / ``_build_minor_c2r`` in interpret mode where
    tpufft takes n and the test runs it (``TP_REAL``), and against
    ``np.fft.rfft`` / ``irfft`` in float64 elsewhere; random half spectra,
    so that the imaginary parts at DC and Nyquist are not zero and must be
    ignored."""
    assert real_fft.form(n) == "lines"
    scale = 1.0 if unit_scale else 1.0 / n
    m1 = n // 2 + 1
    x = _real((BATCH, n), n + 11)
    hr, hi = _real((BATCH, m1), n + 12), _real((BATCH, m1), n + 13)
    got7 = _rfft_mixed_model(x, scale)
    got8 = _irfft_mixed_model(hr, hi, n, scale)
    if n in TP_REAL:
        ref7 = _rfft_both(x, scale, "f32")[1]
        ref8 = _irfft_both(hr, hi, n, scale, "f32")[1]
    else:
        ref7 = np.fft.rfft(x.astype(np.float64)) * scale
        spec = hr.astype(np.float64) + 1j * hi
        spec[:, 0] = spec[:, 0].real
        if n % 2 == 0:
            spec[:, -1] = spec[:, -1].real
        ref8 = np.fft.irfft(spec, n=n) * n * scale
    assert _err(got7, ref7) < 1e-5
    assert _err(got8, ref8) < 1e-5


@pytest.mark.parametrize("n", TP_REAL)
def test_mixed_line_form_models_bf16_storage(n):
    """The models on bf16 planes (input and output rounded to bf16, f32
    arithmetic) against tpufft's kernels with bf16 storage, 8e-3."""
    x = _round_bf16(_real((BATCH, n), n + 21))
    m1 = n // 2 + 1
    hr = _round_bf16(_real((BATCH, m1), n + 22))
    hi = _round_bf16(_real((BATCH, m1), n + 23))
    got7 = _round_bf16(_rfft_mixed_model(x, 1.0).real) + 1j * _round_bf16(
        _rfft_mixed_model(x, 1.0).imag)
    assert _err(got7, _rfft_both(x, 1.0, "bf16")[1]) < 8e-3
    got8 = _round_bf16(_irfft_mixed_model(hr, hi, n, 1.0 / n))
    assert _err(got8, _irfft_both(hr, hi, n, 1.0 / n, "bf16")[1]) < 8e-3


def _pair_accesses(geo, m, zs, zh, inverse):
    """The (un)tangle's instructions of a team, as ``R2cPacked::end`` and
    ``C2rPacked::begin`` in ``csrc/real_fft.cuh`` index them: lane t takes
    slot e = t + lanes i, r = e / ZH, k = e mod ZH, live where r < rows and
    k < ceil(m/2); three instructions a round: Z[k] at r ZS + k, Z[m - k]
    at r ZS + m - k (lanes of k > 0), and at even m Z[m/2] at r ZS + m/2
    (lanes of k = 0). Each access is (position, (row, j)) or None."""
    lanes, rows, half = 32 * geo["team_warps"], geo["rows"], (m + 1) // 2
    iters = -(-rows * zh // lanes)
    out = []
    for w in range(geo["team_warps"]):
        for i in range(iters):
            a, b, c = [], [], []
            for t in range(32 * w, 32 * w + 32):
                r, k = divmod(t + lanes * i, zh)
                live = r < rows and k < half
                a.append((r * zs + k, (r, k)) if live else None)
                b.append((r * zs + m - k, (r, m - k)) if live and k else None)
                c.append((r * zs + m // 2, (r, m // 2))
                         if live and not k and m % 2 == 0 else None)
            out += [a, b, c]
    return out


def _pass_accesses(geo, m, zs, pass1):
    """The four-step's side of the natural-order tile: pass 2's writes of Z
    (K7: slot r Q2 + k1, register q holding k2 = line_out(p, q), Z[k1 + N1
    k2] at r ZS + k1 + N1 k2) or pass 1's reads of Z' (K8: slot r Q1 + j2,
    register j holding j1, Z'[N2 j1 + j2] at r ZS + N2 j1 + j2), lines in
    one lane or on a pair (``_slots``)."""
    n1, n2, rows = geo["n1"], geo["n2"], geo["rows"]
    lanes = 32 * geo["team_warps"]
    length, other, q = (n1, n2, geo["q1"]) if pass1 else (n2, n1, geo["q2"])
    units = lanes // 2 if length > 32 else lanes
    out = []
    for w in range(geo["team_warps"]):
        for s in range(-(-rows * q // units)):
            for v in range(length // 2 if length > 32 else length):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    slot, p = _slots(length, lanes, t, s)
                    r, c = divmod(slot, q)
                    if r >= rows or c >= other:
                        acc.append(None)
                        continue
                    if pass1:
                        j = n2 * (p + 2 * v if length > 32 else v) + c
                    else:
                        j = c + n1 * _line_out(length, p, v)
                    acc.append((r * zs + j, (r, j)))
                out.append(acc)
    return out


@pytest.mark.parametrize("inverse", [False, True], ids=["K7", "K8"])
@pytest.mark.parametrize("n", MIXED_REAL)
def test_mixed_pair_tile_mapping(n, inverse):
    """The natural-order round trip through the team's tile at every
    mixed-radix real length: K7's pass 2 writes every Z[k] of the team's
    rows once and its untangle reads each back from where it was written
    (Z[m/2] by the lone lanes of k = 0 at even m); K8's tangle writes every
    Z'[j] once and its pass 1 reads each back once. Every position lies in
    the team's tile (``rows`` max(RS, ZS)), and the live lanes of each half
    warp of every instruction touch distinct bank pairs (8-byte values:
    position mod 16)."""
    m = n // 2
    geo = real_fft.line_geometry(n)
    zs, zh = ((geo["tangle_rs"], geo["tangle_slots"]) if inverse
              else (geo["untangle_rs"], geo["untangle_slots"]))
    pairs = _pair_accesses(geo, m, zs, zh, inverse)
    passes = _pass_accesses(geo, m, zs, inverse)
    writes, reads = (pairs, passes) if inverse else (passes, pairs)
    where = {}
    for acc in writes:
        for a in acc:
            if a is not None:
                p, e = a
                assert e not in where, (n, e)
                where[e] = p
    assert set(where) == {(r, j) for r in range(geo["rows"])
                          for j in range(m)}
    assert len(set(where.values())) == len(where)
    assert max(where.values()) < geo["rows"] * max(zs, geo["rs"])
    seen = {}
    for acc in reads:
        for a in acc:
            if a is not None:
                p, e = a
                assert where[e] == p
                seen[e] = seen.get(e, 0) + 1
    assert set(seen) == set(where) and set(seen.values()) == {1}
    for acc in writes + reads:
        for half in (acc[:16], acc[16:]):
            live = [a[0] for a in half if a is not None]
            assert len({p % 16 for p in live}) == len(live), (n, half)


@pytest.mark.parametrize("n", TP_REAL)
def test_real_slice_at_the_new_lengths_matches_tpufft(n, monkeypatch):
    """The slice as a whole at the new lengths: ``rfft``/``irfft`` of
    (3, n) and ``rfft2``/``irfft2`` of (2, 6, n) through both packages'
    public entry points (tpufft's Pallas kernels in interpret mode, the
    port's CPU tensors on K7's and K8's plain versions), 1e-5, each port
    call routed through K7's and K8's wrappers."""
    calls = []
    for name in ("rfft_minor", "irfft_minor"):
        real = getattr(real_fft, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(real_fft, name, spy)
    cfg = PlanConfig(interpret=True, backend="pallas", lane_block=128,
                     precision="highest")
    x = _real((3, n), n + 31)
    ref = tpufft.rfft(x, config=TP_CFG)
    got = tpufft_torch.rfft(x, config=cfg, device="cpu")
    assert _err(got, ref) < 1e-5
    back = tpufft_torch.irfft(got, n=n, config=cfg, device="cpu")
    assert _err(back, tpufft.irfft(ref, n=n, config=TP_CFG)) < 1e-5
    assert calls == ["rfft_minor", "irfft_minor"]
    x2 = _real((2, 6, n), n + 32)
    ref2 = tpufft.rfft2(x2, config=TP_CFG)
    got2 = tpufft_torch.rfft2(x2, config=cfg, device="cpu")
    assert _err(got2, ref2) < 1e-5
    back2 = tpufft_torch.irfft2(got2, s=(6, n), config=cfg, device="cpu")
    assert _err(back2, tpufft.irfft2(ref2, s=(6, n), config=TP_CFG)) < 1e-5
    assert _err(back2, x2) < 1e-5
    assert calls == ["rfft_minor", "irfft_minor"] * 2

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
(every element written and read back once, no bank conflict). K9's line
form (the zero-padded minor axis) is checked the same way: a model of its
padded load (every input value read once at its own row stride n_in,
nothing read at or past n_in, the sectors a half warp touches), and the
four-step fed the registers that load fills, against tpufft's
``_build_minor_rect`` in interpret mode (1e-5 f32, 8e-3 bf16 storage).

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import minor_fft, real_fft
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


def _pad_ins(n):
    """The input lengths of K9's tests at padded length n: 1, n/2, n/2 + 1
    and n - 1, those below n."""
    return sorted({1, n // 2, n // 2 + 1, n - 1} & set(range(1, n)))


PADDED_LINES = [(n, n_in) for n in POW2 for n_in in _pad_ins(n)]


MIXED = sorted(minor_fft._MIXED_STEP)   # the mixed-radix line form
FOUR_STEP = sorted(minor_fft._FOUR_STEP)  # every four-step geometry
LONG = sorted(minor_fft._LONG_STEP)       # the three-factor form


@pytest.mark.parametrize("n,n_in,expected", (
    [(n, None, "lines") for n in POW2]
    + [(n, None, "lines") for n in (93, 480, 960)]
    + [(n, None, "stages") for n in (1, 1792, 4100, 12000, 16383, 127, 37,
                                     7200)]
    + [(n, None, "lines") for n in (8192, 16384, 7680)]
    + [(n, None, "lines") for n in MIXED + LONG]
    + [(128, 93, "lines"),                  # a padded call (K9)
       (1024, 1024, "lines"),
       (131, None, None),                   # prime factor above 127
       (minor_fft.MAX_N + 1, None, None)]
    + [(n, n_in, "lines") for n, n_in in PADDED_LINES]
    + [(384, 300, "lines"), (8192, 5000, "lines"), (8320, 4099, "lines"),
       (4100, 3000, "stages")]))
def test_form(n, n_in, expected):
    """The form each length runs, K9's padded calls among them: the line
    form at every power-of-two n up to 4096, at the mixed-radix lengths
    of ``_FOUR_STEP`` (3, 5 and 15 times a power of two, 93, 1000, 1080,
    2160) and at the three-factor lengths of ``_LONG_STEP`` (4320 to
    16384, Bluestein's 8320 among them), whatever n_in; the stage form at
    the rest (a prime above 31 or a length no list holds, above 4096 too).
    The envelope (``supported``) is the one the stage form alone had:
    every length in it has a form."""
    assert minor_fft.form(n, n_in) == expected
    assert (expected is not None) == minor_fft.supported(n, torch.float32)
    split = minor_fft.line_split(n)
    if expected == "lines":
        assert int(np.prod(split)) == n and max(split) <= 64
        assert len(split) == (3 if n in minor_fft._LONG_STEP else 2)
    else:
        assert split is None


def _four_step_model(re, im, inverse, scale, split=None):
    """The line form's arithmetic in torch ops: n = N1 N2 from
    ``line_split`` (or ``split``); pass 1 the N1-long DFTs of the columns
    j2 of the (N1, N2) view (W_N1^(k1 j1) read from the n-table at stride
    N2, as ``line_fft`` reads it), the twiddle w^(k1 j2) read at (k1 j2)
    mod n, pass 2 the N2-long DFTs of the rows k1 (table stride N1), out
    X[k1 + N1 k2], scaled once."""
    n = re.shape[1]
    n1, n2 = split or minor_fft.line_split(n)
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
@pytest.mark.parametrize("n", [128, 256, 1024, 4096] + MIXED)
def test_line_split_model_matches_build_minor(n, inverse, unit_scale, rng):
    """The four-step the line form runs, with ``line_split``'s factors and
    the table exponents (k1 j2) mod n (at 4096 the three-factor form,
    ``_three_factor_model``), against tpufft's ``_build_minor`` in
    interpret mode."""
    from conftest import assert_spectrum_close
    re, im = _planes(n, rng, batch=5)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = _tpufft(re, im, inverse, scale, "highest")
    model = (_three_factor_model if n in minor_fft._LONG_STEP
             else _four_step_model)
    got = model(re, im, inverse, scale)
    assert_spectrum_close(got, ref, np.complex64)
    assert _err(got, ref) < 1e-5


def _first_radix(n):
    """``first_radix`` of csrc/lane_dft.cuh: 8 (4 at 16), 4, 2, then the
    smallest odd prime."""
    return (8 if n % 8 == 0 and n != 16 else 4 if n % 4 == 0
            else 2 if n % 2 == 0
            else next(p for p in range(3, n + 1, 2) if n % p == 0))


def _lane_out(n, r):
    """Index in its line of register r after ``lane_dft<n>``."""
    if n == 1:
        return 0
    a = _first_radix(n)
    b = n // a
    return r // b + a * _lane_out(b, r % b)


def _line_out(n, p, r):
    """``line_out<n>``: a line in one lane, or a line of 34 to 64 on a lane
    pair at place p (``pair_out<n / 2>``)."""
    if n > 32:
        m = n // 2
        return _lane_out(m, r % (m // 2) + (m // 2) * p) + m * (r // (m // 2))
    return _lane_out(n, r)


def _tile_pos(geo, n):
    """``LaneStep::pos``: r n + k1 N2 + (j2 ^ ((k1 + N1 r) mod 16)) for the
    power-of-two XOR tile (p2 = 0), else r rs + k1 p2 + j2."""
    n1, n2, p2, rs = geo["n1"], geo["n2"], geo["p2"], geo["rs"]
    if p2 == 0:
        return lambda r, k1, j2: r * n + k1 * n2 + (j2 ^ ((k1 + n1 * r) & 15))
    return lambda r, k1, j2: r * rs + k1 * p2 + j2


def _slots(length, lanes, t, s):
    """(slot, place in a pair) of team lane t in round s of a pass whose
    lines are ``length`` long: t + lanes s in one lane, (t mod 16) + 16 (t
    / 32) + lanes / 2 s on the pair t, t ^ 16 (length 34 to 64)."""
    if length > 32:
        return (t & 15) + 16 * (t >> 5) + (lanes // 2) * s, (t >> 4) & 1
    return t + lanes * s, 0


def _rounds(geo, q, length):
    lanes = 32 * geo["team_warps"]
    units = lanes // 2 if length > 32 else lanes
    return -(-geo["rows"] * q // units)


def _four_step_geometry(n):
    """The four-step geometry launched at length n: K1's
    (``minor_fft.line_geometry``), or at n = 4096, where K1 takes three
    factors, the 64 x 64 XOR tile that K7 and K8 launch at the half m =
    4096 (``real_fft.line_geometry(8192)``)."""
    if n in minor_fft._FOUR_STEP:
        return minor_fft.line_geometry(n)
    return real_fft.line_geometry(2 * n)


def _tile_accesses(n):
    """Per warp instruction of a team, the live lanes' tile positions
    (float2) and the elements (row, k1, j2) of the (N1, N2) views they
    carry, indexed as ``lane_rows`` indexes them: pass 1's writes (slot u =
    r Q1 + j2 of each round, live where j2 < N2 and r < rows) and pass 2's
    reads (slot r Q2 + k1, live where k1 < N1), each line in one lane or on
    a pair (``_slots``); positions ``_tile_pos``; the geometry
    ``_four_step_geometry``."""
    geo = _four_step_geometry(n)
    n1, n2, tw = geo["n1"], geo["n2"], geo["team_warps"]
    q1, q2, rows = geo["q1"], geo["q2"], geo["rows"]
    lanes = 32 * tw
    pos = _tile_pos(geo, n)
    writes, reads = [], []
    for w in range(tw):
        for s in range(_rounds(geo, q1, n1)):
            for q in range(n1 // 2 if n1 > 32 else n1):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    slot, p = _slots(n1, lanes, t, s)
                    row, j2 = divmod(slot, q1)
                    if row >= rows or j2 >= n2:
                        acc.append(None)
                        continue
                    k1 = _line_out(n1, p, q)
                    acc.append((pos(row, k1, j2), (row, k1, j2)))
                writes.append(acc)
        for s in range(_rounds(geo, q2, n2)):
            for j in range(n2 // 2 if n2 > 32 else n2):
                acc = []
                for t in range(32 * w, 32 * w + 32):
                    slot, p = _slots(n2, lanes, t, s)
                    row, k1 = divmod(slot, q2)
                    if row >= rows or k1 >= n1:
                        acc.append(None)
                        continue
                    j2 = p + 2 * j if n2 > 32 else j
                    acc.append((pos(row, k1, j2), (row, k1, j2)))
                reads.append(acc)
    return geo, writes, reads


@pytest.mark.parametrize("n", FOUR_STEP + [4096])
def test_line_tile_mapping(n):
    """The team's tile at every four-step geometry (K1's, and K7's and
    K8's 64 x 64 at the half 4096): pass 1 writes every element of its
    rows' (N1, N2) views once, at a distinct position inside the team's
    tile; pass 2 reads each back from the position it was written to; and
    the live lanes of each half warp of every write and read instruction
    touch distinct bank pairs (8-byte values: position mod 16), all 16 at
    the power-of-two geometries, so the tile has no bank conflict."""
    geo, writes, reads = _tile_accesses(n)
    size = geo["rows"] * (n if geo["p2"] == 0 else geo["rs"])
    where = {}
    for acc in writes:
        for a in acc:
            if a is None:
                continue
            p, e = a
            assert e not in where
            where[e] = p
    assert len(where) == geo["rows"] * n
    assert len(set(where.values())) == len(where)
    assert max(where.values()) < size
    seen = set()
    for acc in reads:
        for a in acc:
            if a is None:
                continue
            p, e = a
            assert where[e] == p
            seen.add(e)
    assert seen == set(where)
    for acc in writes + reads:
        for half in (acc[:16], acc[16:]):
            live = [p for p, _ in (a for a in half if a is not None)]
            assert len(set(x % 16 for x in live)) == len(live), (n, half)
            if geo["p2"] == 0:
                assert len(live) == 16


def test_tables_match_the_header():
    """``_FOUR_STEP``'s mixed-radix geometries are the family lists of
    ``csrc/minor_fft.cuh`` (TPUFFT_MINOR_{R3,R5,R15,ODD}), each list
    instantiated by its own source, and its power-of-two rows the list
    TPUFFT_MINOR_POW2 that ``launch_line_form`` in ``csrc/minor_fft.cu``
    launches."""
    import pathlib
    import re
    csrc = pathlib.Path(minor_fft.__file__).resolve().parent.parent / "csrc"
    cuh = (csrc / "minor_fft.cuh").read_text()
    listed = {}
    for fam in ("R3", "R5", "R15", "ODD"):
        body = cuh.split(f"#define TPUFFT_MINOR_{fam}(X)")[1].split(
            "#define")[0].split("\n\n")[0]
        rows = [tuple(int(v) for v in m.split(","))
                for m in re.findall(r"X\(([0-9, ]+)\)", body)]
        assert rows, fam
        for r in rows:
            listed[r[0]] = r[1:]
        src = (csrc / f"minor_line_{fam.lower()}.cu").read_text()
        assert (f"TPUFFT_MINOR_FAMILY(launch_mixed_{fam.lower()}, "
                f"TPUFFT_MINOR_{fam})") in src
    assert listed == minor_fft._MIXED_STEP
    body = cuh.split("#define TPUFFT_MINOR_POW2(X)")[1].split("#define")[0]
    lanes = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", body)}
    assert lanes == minor_fft._POW2_STEP
    assert "TPUFFT_MINOR_POW2(TPUFFT_LANE)" in (
        csrc / "minor_fft.cu").read_text()


# ----------------------------------------------------------------------------
# K9's line form: the padded load, and the four-step it feeds
# ----------------------------------------------------------------------------

def _line_params(n):
    """``Line<N>`` of ``line_fft.cuh`` at n <= 64: V values a lane, G
    places a line, K lines a lane (32 values), W lines a warp."""
    v = n if n < 8 else 8
    g = n // v
    return v, g, 32 // v, 32 // g


def _padded_loads(n, n_in, batch):
    """Per warp load instruction of K9's line form at padded length n, the
    lanes' (row, col, address) where a lane issues a request (address =
    row n_in + col, in elements), indexed as ``minor_lines_padded_kernel``
    (n <= 64: lane (l, c) loads x[l + G j] of row row0 + c + W k, 128
    threads a block) and ``minor_lane_padded_kernel`` (pass 1: lane t of a
    team holds the column lines of its slots in each round (``_slots``;
    slot r Q1 + j2, idle at j2 >= N2), on a pair for N1 of 34 to 64,
    register j1 holding x[N2 j1 + j2]; the team's rows from (group teams +
    team) R) index them, and ``minor_long_kernel`` (the three-factor
    lengths: pass 1's register j1 of column u = t + threads s is x[M j1 +
    u], M = N2 N3, one row a block; a warp past M skips the round); every
    row group or block the batch needs. A lane whose row is past the
    batch, whose slot is idle or whose col is at or past n_in issues
    nothing."""
    out = []

    def lane_access(row, col):
        if row >= batch or col >= n_in:
            return None
        return row, col, row * n_in + col

    if n <= 64:
        v, g, k_lines, w_lines = _line_params(n)
        rows_warp = w_lines * k_lines
        for warp in range(-(-batch // rows_warp)):
            row0 = warp * rows_warp
            for k in range(k_lines):
                for j in range(v):
                    out.append([lane_access(row0 + lane % w_lines
                                            + w_lines * k,
                                            lane // w_lines + g * j)
                                for lane in range(32)])
        return out
    if n in minor_fft._LONG_STEP:   # pass 1: lane t, round s: column u
        geo = minor_fft.line_geometry(n)
        m, th = geo["n2"] * geo["n3"], geo["threads"]
        for row in range(batch):
            for s in range(-(-m // th)):
                for j in range(geo["n1"]):
                    for w in range(0, th, 32):
                        us = [u for u in range(s * th + w, s * th + w + 32)]
                        if us[0] < m:
                            out.append([lane_access(row, m * j + u)
                                        if u < m else None for u in us])
        return out
    geo = minor_fft.line_geometry(n)
    n1, n2, tw = geo["n1"], geo["n2"], geo["team_warps"]
    lanes, rows, q1 = 32 * tw, geo["rows"], geo["q1"]
    for team0 in range(0, batch, rows):     # every team of every group
        for w in range(tw):
            for s in range(_rounds(geo, q1, n1)):
                for j in range(n1 // 2 if n1 > 32 else n1):
                    acc = []
                    for t in range(32 * w, 32 * w + 32):
                        slot, p = _slots(n1, lanes, t, s)
                        r, j2 = divmod(slot, q1)
                        if r >= rows or j2 >= n2:
                            acc.append(None)
                            continue
                        j1 = p + 2 * j if n1 > 32 else j
                        acc.append(lane_access(team0 + r, n2 * j1 + j2))
                    out.append(acc)
    return out


@pytest.mark.parametrize("n,n_in", PADDED_LINES + [(128, 93), (1024, 1000)]
                         + [(384, 1), (384, 300), (384, 383), (960, 1),
                            (960, 481), (960, 900)])
def test_padded_load_mapping(n, n_in):
    """K9's padded load reads every input value (row, col < n_in) exactly
    once, at the input's own row stride (address row n_in + col), and
    issues no request at col >= n_in or past the batch; the lanes of a half
    warp read consecutive columns of one row (a 4-byte access each)."""
    if n <= 64:   # rows a warp holds
        _, _, k_lines, w_lines = _line_params(n)
        unit = k_lines * w_lines
    elif n in minor_fft._LONG_STEP:   # one row a block
        unit = 1
    else:         # rows a team holds
        unit = minor_fft.line_geometry(n)["rows"]
    batch = 2 * unit + 3   # a ragged last warp or team
    seen = {}
    for acc in _padded_loads(n, n_in, batch):
        for a in acc:
            if a is None:
                continue
            row, col, addr = a
            assert row < batch and col < n_in
            assert row * n_in <= addr < (row + 1) * n_in
            assert (row, col) not in seen
            seen[row, col] = addr
        if n >= 128:
            for half in (acc[:16], acc[16:]):
                live = [a for a in half if a is not None]
                if live:
                    assert len({r for r, _, _ in live}) == 1
                    cols = sorted(c for _, c, _ in live)
                    assert cols == list(range(cols[0], cols[0] + len(cols)))
    assert len(seen) == batch * n_in


def test_padded_load_sectors_at_93():
    """At (93 -> 128) a row starts at any 4-byte offset: a half warp's 16
    consecutive 4-byte loads touch at most three 32-byte sectors (two where
    the run is 32-byte aligned), and the sectors the warps touch are the
    input's, each read by one instruction or two that share it at a row's
    end."""
    batch = 64
    sectors = []
    touched = {}
    for acc in _padded_loads(128, 93, batch):
        for half in (acc[:16], acc[16:]):
            live = [a[2] for a in half if a is not None]
            if live:
                secs = {4 * addr // 32 for addr in live}
                sectors.append(len(secs))
                for sec in secs:
                    touched[sec] = touched.get(sec, 0) + 1
    assert max(sectors) == 3 and min(sectors) >= 1
    assert 2 in sectors
    assert set(touched) == set(range(-(-4 * batch * 93 // 32)))
    assert max(touched.values()) <= 3


def _padded_registers(re, im, n):
    """The values K9's line form holds after its padded load, as the (B, n)
    rows of the (N1, N2) view it transforms (register j1 of column j2 at
    N2 j1 + j2; at n <= 64 ``Line<N>``'s register j of place l at G j +
    l), with the zero pattern checked: register j1 of column j2 is 0
    exactly where j1 >= ceil((n_in - j2) / N2)."""
    b, n_in = re.shape
    n1, n2 = (_line_params(n)[:2] if n <= 64 else minor_fft.line_split(n))
    x = np.zeros((b, n1, n2), np.complex64)
    j1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    col = n2 * j1 + j2
    live = col < n_in
    assert np.array_equal(~live, j1 >= -(-(n_in - j2) // n2))
    x[:, live] = (re + 1j * im)[:, col[live]]
    return (np.ascontiguousarray(x.real.reshape(b, n)),
            np.ascontiguousarray(x.imag.reshape(b, n)), (n1, n2))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n_in,n", [(93, 128), (1000, 1024), (1024, 2048),
                                    (33, 64), (1, 16), (300, 384),
                                    (900, 960)])
def test_padded_line_model_matches_build_minor_rect(n_in, n, inverse,
                                                    unit_scale, storage, rng):
    """K9's line form in torch ops: the four-step (``Line<N>``'s split at
    n <= 64) fed the registers of the padded load, against tpufft's
    ``_build_minor_rect`` in its zero-pad direction in interpret mode; in
    bf16 storage both sides read bf16 planes and round the result to bf16
    at the store."""
    re, im = _planes(n_in, rng, batch=5)
    scale = 1.0 if unit_scale else 1.0 / n
    jdt = jnp.float32 if storage == "f32" else jnp.bfloat16
    run = tp_mxu._build_minor_rect(n_in, n, n, inverse, scale, 128,
                                   "highest", True, storage)
    zr, zi = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt))
    ref = (np.asarray(zr.astype(jnp.float32))
           + 1j * np.asarray(zi.astype(jnp.float32)))
    if storage == "bf16":
        re, im = _bf16(re), _bf16(im)
    pr, pi, split = _padded_registers(re, im, n)
    got = _four_step_model(pr, pi, inverse, scale, split)
    if storage == "bf16":
        got = _bf16(got.real) + 1j * _bf16(got.imag)
    assert _err(got, ref) < (1e-5 if storage == "f32" else 8e-3)


# ----------------------------------------------------------------------------
# The three-factor form above 4096: the model, its tile and its tables
# ----------------------------------------------------------------------------

def _three_factor_model(re, im, inverse, scale):
    """The three-factor form's arithmetic in torch ops (c64), n = N1 N2 N3
    from ``line_split``, M = N2 N3, u = N3 j2 + j3: pass 1 the N1-long DFTs
    of the columns u of the (N1, M) view (W_N1^(k1 j1) from the n-table at
    (k1 j1 mod N1) n / N1, as the kernel's W_N1 table holds it), times A[k1,
    j2] = w^(k1 j2 N3) and B[k1, j3] = w^(k1 j3); pass 2 the N2-long DFTs
    over j2, times C[k2, j3] = w^(N1 k2 j3); pass 3 the N3-long DFTs over
    j3, out X[k1 + N1 (k2 + N2 k3)], scaled once."""
    n = re.shape[1]
    n1, n2, n3 = minor_fft.line_split(n)
    tab = minor_fft._device_twiddles(n, inverse, torch.device("cpu"))
    w = torch.complex(tab[:, 0], tab[:, 1])
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    x = x.reshape(-1, n1, n2 * n3)                         # [b, j1, u]

    def line_table(m):
        k = torch.arange(m)
        return w[((k[:, None] * k[None, :]) % m) * (n // m)]

    k1, k2, k3 = torch.arange(n1), torch.arange(n2), torch.arange(n3)
    y = torch.einsum("kj,bju->bku", line_table(n1), x)    # [b, k1, u]
    y = y.reshape(-1, n1, n2, n3)                          # [b, k1, j2, j3]
    a = w[k1[:, None] * k2[None, :] * n3]                  # A[k1, j2]
    b = w[k1[:, None] * k3[None, :]]                       # B[k1, j3]
    y = y * (a[:, :, None] * b[:, None, :])
    z = torch.einsum("qj,bkjm->bkqm", line_table(n2), y)  # [b, k1, k2, j3]
    z = z * w[n1 * k2[:, None] * k3[None, :]]              # C[k2, j3]
    o = torch.einsum("rm,bkqm->bkqr", line_table(n3), z)  # [b, k1, k2, k3]
    return (o.permute(0, 3, 2, 1).reshape(-1, n) * scale).numpy()


@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", LONG)
def test_three_factor_model_matches_build_minor(n, inverse, unit_scale, rng):
    """The three-factor form, with ``line_split``'s factors, its table
    exponents and its output order, against tpufft's ``_build_minor`` in
    interpret mode (f32, 1e-5)."""
    re, im = _planes(n, rng, batch=5)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = _tpufft(re, im, inverse, scale, "highest")
    assert _err(_three_factor_model(re, im, inverse, scale), ref) < 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", LONG)
def test_three_factor_model_bf16_storage(n, inverse, rng):
    """bf16 storage: both sides read bf16 planes and round the f32 result
    to bf16 at the store (8e-3)."""
    re, im = _planes(n, rng, batch=3)
    scale = 1.0 / n if inverse else 1.0
    ref = _tpufft(re, im, inverse, scale, "highest", storage="bf16")
    got = _three_factor_model(_bf16(re), _bf16(im), inverse, scale)
    got = _bf16(got.real) + 1j * _bf16(got.imag)
    assert _err(got, ref) < 8e-3


def _long_accesses(n):
    """Per warp instruction of the three-factor kernel at n, the live lanes'
    accesses as ``minor_long_kernel`` makes them (line l of a pass on lane
    l mod threads in round l / threads; a half warp is 16 consecutive l of
    one round): pass 1's loads x[M j1 + u] and tile writes (k1, j2, j3)
    with the twiddle reads A[k1 N2 + j2] and B[k1 N3 + j3]; pass 2's tile
    reads (k1, j2, j3) of line w = j3 + N3 k1 and writes (k1, k2, j3) with
    C[k2 N3 + j3]; pass 3's tile reads (k1, k2, j3) of line l = k1 + N1 k2
    and stores X[l + N1 N2 k3]. Each access is (tile position or table or
    memory index, the element it carries) or None for an idle lane."""
    geo = minor_fft.line_geometry(n)
    n1, n2, n3, th = geo["n1"], geo["n2"], geo["n3"], geo["threads"]
    p1, p2 = geo["p1"], geo["p2"]

    def pos(k1, c2, j3):
        return k1 * p1 + c2 * p2 + j3

    def instructions(lines, regs, access):
        out = []
        for s in range(-(-lines // th)):
            for r in range(regs):
                acc = []
                for t in range(th):
                    line = t + th * s
                    acc.append(access(line, r) if line < lines else None)
                # a warp with no live lane skips the round
                out.extend(acc[w:w + 32] for w in range(0, th, 32)
                           if any(acc[w:w + 32]))
        return out

    m = n2 * n3
    acc = {
        "load": instructions(m, n1, lambda u, j: (m * j + u, (j, u))),
        "write1": instructions(m, n1, lambda u, q: (
            pos(_lane_out(n1, q), u // n3, u % n3),
            (_lane_out(n1, q), u // n3, u % n3))),
        "tw_a": instructions(m, n1, lambda u, q: (
            _lane_out(n1, q) * n2 + u // n3, None)),
        "tw_b": instructions(m, n1, lambda u, q: (
            _lane_out(n1, q) * n3 + u % n3, None)),
        "read2": instructions(n1 * n3, n2, lambda w, j: (
            pos(w // n3, j, w % n3), (w // n3, j, w % n3))),
        "write2": instructions(n1 * n3, n2, lambda w, q: (
            pos(w // n3, _lane_out(n2, q), w % n3),
            (w // n3, _lane_out(n2, q), w % n3))),
        "tw_c": instructions(n1 * n3, n2, lambda w, q: (
            _lane_out(n2, q) * n3 + w % n3, None)),
        "read3": instructions(n1 * n2, n3, lambda l, j: (
            pos(l % n1, l // n1, j), (l % n1, l // n1, j))),
        "store": instructions(n1 * n2, n3, lambda l, q: (
            l + n1 * n2 * _lane_out(n3, q), None)),
    }
    return geo, acc


@pytest.mark.parametrize("n", LONG)
def test_three_factor_tile_mapping(n):
    """The three-factor kernel's tile and tables at every geometry: pass 1
    loads every input element once (consecutive lanes on consecutive
    elements) and writes every (k1, j2, j3) once, at distinct positions
    inside the tile; pass 2 reads each back from where it was written and
    writes each (k1, k2, j3) to the same set of positions; pass 3 reads
    every element once and stores every output once, consecutive lanes on
    consecutive outputs. The live lanes of each half warp of every tile and
    table access touch distinct bank pairs (8-byte values: position mod 16;
    lanes on one table entry share it), so nothing has a bank conflict."""
    geo, acc = _long_accesses(n)
    n1, n2, n3 = geo["n1"], geo["n2"], geo["n3"]
    assert n1 * n2 * n3 == n and max(n1, n2, n3) <= 32
    size = n1 * geo["p1"]

    def live(kind):
        return [a for ins in acc[kind] for a in ins if a is not None]

    loads = live("load")
    assert sorted(a[1][0] * n2 * n3 + a[1][1] for a in loads) == list(
        range(n))
    assert sorted(a[0] for a in loads) == list(range(n))
    where = {}
    for p, e in live("write1"):
        assert e not in where
        where[e] = p
    assert len(where) == n and len(set(where.values())) == n
    assert max(where.values()) < size
    read2 = live("read2")
    assert len(read2) == n and all(where[e] == p for p, e in read2)
    write2 = {e: p for p, e in live("write2")}
    assert set(write2.values()) == set(where.values())
    read3 = live("read3")
    assert len(read3) == n and all(write2[e] == p for p, e in read3)
    assert sorted(a[0] for a in live("store")) == list(range(n))
    for kind in ("load", "store"):
        for ins in acc[kind]:
            got = [a[0] for a in ins if a is not None]
            assert got == list(range(got[0], got[0] + len(got))), kind
    for kind, ins_list in acc.items():
        if kind in ("load", "store"):
            continue
        for ins in ins_list:
            for half in (ins[:16], ins[16:]):
                addrs = {a[0] for a in half if a is not None}
                assert len({x % 16 for x in addrs}) == len(addrs), (
                    n, kind, sorted(addrs))


def test_three_factor_tables_match_the_header():
    """``_LONG_STEP`` is the list TPUFFT_MINOR_LONG of
    ``csrc/minor_fft.cuh``, which ``csrc/minor_line_long.cu`` instantiates
    and ``launch_line_form`` in ``csrc/minor_fft.cu`` launches; every
    length lies from 4096 (where the power-of-two four-step stops) inside
    the envelope, its factors whole in a lane (radices of ``lane_dft``)."""
    import pathlib
    import re
    csrc = pathlib.Path(minor_fft.__file__).resolve().parent.parent / "csrc"
    body = (csrc / "minor_fft.cuh").read_text().split(
        "#define TPUFFT_MINOR_LONG(X)")[1].split("\n\n")[0]
    rows = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", body)}
    assert rows == minor_fft._LONG_STEP
    assert "TPUFFT_MINOR_LONG(TPUFFT_LONG_CASE)" in (
        csrc / "minor_line_long.cu").read_text()
    assert "launch_long<T, kFused, kPadded>(a, n)" in (
        csrc / "minor_fft.cu").read_text()
    for n, (n1, n2, n3, th, p1, p2) in rows.items():
        assert minor_fft.LINE_MAX_N <= n <= minor_fft.MAX_N
        assert n1 * n2 * n3 == n and max(n1, n2, n3) <= 32
        assert max(factorize(n)) <= 31 and th % 32 == 0
        assert p2 >= n3 and p1 >= n2 * p2


def test_real_fft_forms_keep_their_cap():
    """K7 and K8 decide their line form from ``LINE_MAX_N``, which the
    three-factor lengths leave as it was: ``real_fft.form`` gives the line
    form exactly at even n whose half is a power of two from 128 to 4096
    or a mixed-radix length of K1's four-step lists (``_REAL_STEP``, all
    below 4096), for every even n up to 32768 (halves that K1 takes in
    three factors above 4096, 8192 and 16384 among them, stay on K7/K8's
    stage form)."""
    from tpufft_torch.kernels import real_fft
    assert minor_fft.LINE_MAX_N == 4096
    assert set(real_fft._REAL_STEP) == set(minor_fft._MIXED_STEP)
    assert max(real_fft._REAL_STEP) < minor_fft.LINE_MAX_N
    for n in range(2, 32769, 2):
        m = n // 2
        want = ("lines" if (128 <= m <= 4096 and m & (m - 1) == 0
                            or m in real_fft._REAL_STEP)
                else "stages" if real_fft.supported(n, torch.float32)
                else None)
        assert real_fft.form(n) == want, n
    for m in LONG:   # K7/K8 at 8192 keep their 64 x 64 four-step at m
        assert real_fft.form(2 * m) == (
            "lines" if m == 4096
            else "stages" if real_fft.supported(2 * m, torch.float32)
            else None)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n_in,n", [(5000, 8192), (4099, 8320), (1, 4320),
                                    (8191, 16384)])
def test_padded_three_factor_model_matches_build_minor_rect(n_in, n, inverse,
                                                             storage, rng):
    """K9 on the three-factor form: pass 1's register j1 of column u holds
    x[M j1 + u] where M j1 + u < n_in and 0 past it, which is the
    three-factor model on the rows zero-padded to n, against tpufft's
    ``_build_minor_rect`` in its zero-pad direction in interpret mode (1e-5
    f32, 8e-3 bf16 storage)."""
    re, im = _planes(n_in, rng, batch=3)
    scale = 1.0 / n if inverse else 1.0
    jdt = jnp.float32 if storage == "f32" else jnp.bfloat16
    run = tp_mxu._build_minor_rect(n_in, n, n, inverse, scale, 128,
                                   "highest", True, storage)
    zr, zi = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt))
    ref = (np.asarray(zr.astype(jnp.float32))
           + 1j * np.asarray(zi.astype(jnp.float32)))
    if storage == "bf16":
        re, im = _bf16(re), _bf16(im)
    n1, n2, n3 = minor_fft.line_split(n)
    col = np.arange(n).reshape(n1, n2 * n3)   # M j1 + u
    assert np.array_equal(col >= n_in, np.arange(n1)[:, None] >= -(
        -(n_in - np.arange(n2 * n3)[None, :]) // (n2 * n3)))
    pr = np.pad(re, ((0, 0), (0, n - n_in)))
    pi = np.pad(im, ((0, 0), (0, n - n_in)))
    got = _three_factor_model(pr, pi, inverse, scale)
    if storage == "bf16":
        got = _bf16(got.real) + 1j * _bf16(got.imag)
    assert _err(got, ref) < (1e-5 if storage == "f32" else 8e-3)


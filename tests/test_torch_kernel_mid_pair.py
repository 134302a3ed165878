"""The mid-pair kernel's plain version against tpufft's ``_build_mid_pair``
(K6), reached through ``mxu_fft.fft_mid_pair_pallas``.

tpufft's Pallas kernel runs in interpret mode on the CPU with
``precision="highest"``; the port runs ``mid_pair_fft.fft_mid_pair_reference``
(what ``fft_mid_pair`` runs for CPU tensors), on the same (pre, n1, n2, L)
planes made from a numpy seed. Tolerances, normalized by the spectrum's
magnitude: 1e-5 for f32 storage (both sides compute in f32 and differ in
summation order), 8e-3 for bf16 storage (both round to bf16 at the store).

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against this plain version there.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import mid_pair_fft
from tpufft_torch.kernels.cube_fft import pick_cluster
from _tpufft_caches import cold_tpufft_caches  # noqa: F401
from conftest import assert_spectrum_close

# tpufft's own mid-pair shape (tests/test_nd.py) and its gradient shape
SHAPES = [(3, 40, 64, 256), (2, 8, 16, 128)]
TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _run_both(re, im, inverse, scale, jdt, tdt):
    ref = tp_mxu.fft_mid_pair_pallas(
        jnp.asarray(re, jdt), jnp.asarray(im, jdt), inverse=inverse,
        scale=scale, config=TP_CFG)
    got = mid_pair_fft.fft_mid_pair(torch.from_numpy(re).to(tdt),
                                    torch.from_numpy(im).to(tdt),
                                    inverse=inverse, scale=scale)
    assert got[0].dtype == tdt and got[0].shape == re.shape
    ref = (np.asarray(ref[0].astype(jnp.float32))
           + 1j * np.asarray(ref[1].astype(jnp.float32)))
    return got[0].float().numpy() + 1j * got[1].float().numpy(), ref


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mid_pair_matches_build_mid_pair(shape, inverse):
    re, im = _planes(shape, seed=sum(shape))
    n = shape[1] * shape[2]
    scale = 1.0 / n if inverse else 1.0
    got, ref = _run_both(re, im, inverse, scale, jnp.float32, torch.float32)
    assert _err(got, ref) < 1e-5
    want = (np.fft.ifftn if inverse else np.fft.fftn)(
        re + 1j * im.astype(np.float64), axes=(1, 2))
    want = want * (n * scale if inverse else 1.0)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_mid_pair_matches_build_mid_pair_bf16_storage(shape):
    re, im = _planes(shape, seed=len(shape))
    got, ref = _run_both(re, im, False, 1.0, jnp.bfloat16, torch.bfloat16)
    assert _err(got, ref) < 8e-3


def test_envelope():
    """Each length inside the minor-axis kernel's radix envelope and at
    least 2, and a cluster of 1 to 16 blocks of at most 16384 elements that
    splits n1 evenly (the smallest with at most 2048 elements a block, else
    the largest), at 8 lanes of L on the line forms and 4 on the stage
    form; any L."""
    sizes = {(8, 16): (1, 8), (16, 64): (4, 8), (32, 64): (8, 8),
             (40, 64): (8, 8), (64, 128): (16, 8), (128, 128): (16, 8),
             (128, 512): (16, 4), (160, 160): (16, 8), (56, 56): (8, 8),
             (256, 128): (16, 8), (224, 224): (16, 4)}
    for (n1, n2), (c, lanes) in sizes.items():
        assert mid_pair_fft.cluster_size(n1, n2) == c, (n1, n2)
        assert mid_pair_fft.lanes(n1, n2) == lanes, (n1, n2)
        for L in (1, 37, 128):
            assert mid_pair_fft.supported(n1, n2, L, torch.float32)
            assert mid_pair_fft.supported(n1, n2, L, torch.bfloat16)
    assert not mid_pair_fft.supported(256, 512, 8, torch.float32)  # 2^19
    assert not mid_pair_fft.supported(27, 200, 8, torch.float32)   # 27 odd
    assert not mid_pair_fft.supported(1, 64, 8, torch.float32)
    assert not mid_pair_fft.supported(16, 131, 8, torch.float32)   # prime
    assert not mid_pair_fft.supported(16, 16, 8, torch.float64)


def test_wrapper_cpu_runs_plain_version():
    re, im = _planes((2, 6, 10, 5), seed=0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    mid_pair_fft.reset_counts()
    got = mid_pair_fft.fft_mid_pair(xr, xi, inverse=True, scale=0.5)
    ref = mid_pair_fft.fft_mid_pair_reference(xr, xi, inverse=True,
                                              scale=0.5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert mid_pair_fft.launches == 0
    assert mid_pair_fft.reference_cuda_calls == 0
    want = np.fft.ifftn(re + 1j * im.astype(np.float64), axes=(1, 2))
    assert _err(got[0].numpy() + 1j * got[1].numpy(),
                want * (6 * 10 * 0.5)) < 1e-5


def test_wrapper_refuses_non_cuda_devices():
    x = torch.empty(2, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        mid_pair_fft.fft_mid_pair(x, x, inverse=False, scale=1.0)


# every pair chip_smoke.py holds K6 to (MID_PAIRS), and MID_SHAPE's
@pytest.mark.parametrize("n1,n2,L,want", [
    (8, 16, 128, "lines"), (16, 64, 24, "lines"), (32, 64, 16, "lines"),
    (64, 128, 8, "lines"), (64, 128, 37, "lines"), (40, 64, 256, "mixed"),
    (128, 128, 9, "lines"), (128, 512, 3, "stages"), (64, 128, 128, "lines"),
    (2, 2, 1, "lines"), (128, 2, 5, "lines"), (160, 160, 48, "mixed"),
    (256, 512, 8, None), (16, 131, 8, None),
    # the generic-radix form's pairs of chip_smoke.py's MID_PAIRS, T2's
    # (48, 160) and the timed shapes
    (48, 160, 160, "mixed"), (56, 56, 256, "mixed"), (256, 128, 32, "mixed"),
    (12, 15, 5, "mixed"), (14, 28, 8, "mixed"), (240, 120, 9, "mixed"),
    (224, 128, 3, "mixed"), (28, 256, 8, "mixed"), (7, 3, 1, "mixed"),
    # off the lists or the cluster: the stage form
    (224, 224, 8, "stages"), (120, 240, 8, "stages"), (36, 64, 8, "stages"),
    (25, 160, 48, "stages"), (160, 44, 8, "stages")])
def test_form_names_the_kernel_of_each_pair(n1, n2, L, want):
    """Powers of two from 2 to 128 take the line form (8 lanes of L, an
    even number of n1-columns a block); other pairs of ``MIXED_LENGTHS``
    (r 2^a, r in 1, 3, 5, 7, 15, up to 240, and 256) whose tile fits a
    cluster at 8 lanes the generic-radix form; every other pair (primes
    above 7, 9, 11, axes above 256, a tile past 16 blocks) the stage form;
    None outside the envelope. ``form`` mirrors ``line_mid`` in
    ``csrc/cluster_fft.cu`` and ``mixed_pair`` in ``csrc/mid_line.cuh``."""
    assert mid_pair_fft.form(n1, n2, L) == want
    if want in ("lines", "mixed"):
        c = mid_pair_fft.cluster_size(n1, n2)
        assert mid_pair_fft.lanes(n1, n2) == mid_pair_fft.LINE_LANES
        assert n1 // c * n2 * 8 <= 16384
        assert want == "mixed" or n2 * 8 // c % 2 == 0


def test_line_form_tile_model():
    """A model of the line form's index math in numpy (the tile's swizzle,
    the load, the n2 lines of ``line_fft.cuh``'s ``Line<N>`` layout in
    place, the n1 columns read across the cluster in pairs): the 2-D DFT
    of a (1, 16, 128, 11) tile over a cluster of 2, with a ragged L."""
    rng = np.random.default_rng(3)
    n1, n2, L, C, lanes = 16, 128, 11, 2, 8
    x = rng.standard_normal((n1, n2, L)) + 1j * rng.standard_normal(
        (n1, n2, L))
    slab = n2 * lanes + 8

    def at(j, k2, l):
        return j * slab + (k2 >> 1) * 16 + (
            (((k2 & 1) << 3) | l) ^ (((k2 >> 1) & 3) << 2))

    S = n1 // C
    idx = {at(j, k2, l) for j in range(S) for k2 in range(n2)
           for l in range(lanes)}
    assert len(idx) == S * n2 * lanes   # the swizzle is one-to-one
    y = np.zeros_like(x)
    for l0 in range(0, L, lanes):
        tiles = []
        for rank in range(C):
            t = np.zeros(S * slab, complex)
            for j in range(S):
                for k2 in range(n2):
                    for l in range(min(lanes, L - l0)):
                        t[at(j, k2, l)] = x[rank * S + j, k2, l0 + l]
            for j in range(S):   # the n2 lines, in place
                for l in range(lanes):
                    pos = [at(j, k2, l) for k2 in range(n2)]
                    t[pos] = np.fft.fft(t[pos])
            tiles.append(t)
        cols = n2 * lanes // C
        for rank in range(C):
            for q in range(0, cols, 2):   # adjacent lanes of L: one read
                col = rank * cols + q
                k2, l = col // lanes, col % lanes
                pair = np.array([tiles[k1 // S][at(k1 % S, k2, l):
                                                at(k1 % S, k2, l) + 2]
                                 for k1 in range(n1)])
                for d in range(2):
                    if l0 + l + d < L:
                        y[:, k2, l0 + l + d] = np.fft.fft(pair[:, d])
    want = np.fft.fft2(x, axes=(0, 1))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-12


# new pairs of the generic-radix form (csrc/mid_line.cuh), each family of
# n1 and n2 among them; tpufft's builder runs them directly (its
# ``mid_pair_supported`` asks n2 % 8 == 0 of the TPU's layout, which
# interpret mode does not need)
MIXED_SHAPES = [(2, 20, 24, 9), (1, 14, 28, 8), (3, 12, 15, 5),
                (1, 40, 7, 3), (1, 16, 160, 2)]


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape", MIXED_SHAPES)
def test_mixed_pairs_match_build_mid_pair(shape, inverse, scaled, storage):
    """``fft_mid_pair`` on CPU tensors against tpufft's ``_build_mid_pair``
    in interpret mode at pairs of the generic-radix form: f32 storage to
    ``assert_spectrum_close`` (1e-3 for c64) and 1e-5, bf16 storage to 8e-3
    (each side rounds its f32 result to bf16 once, so an element may
    differ by one bf16 step, 2^-8 of its size)."""
    _, n1, n2, L = shape
    assert mid_pair_fft.form(n1, n2, L) == "mixed"
    re, im = _planes(shape, seed=n1 * n2 + L)
    scale = 1.0 / (n1 * n2) if scaled else 1.0
    jdt, tdt = ((jnp.float32, torch.float32) if storage == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    run = tp_mxu._build_mid_pair(n1, n2, inverse, scale, 128, "highest",
                                 True, storage)
    ref = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt))
    ref = (np.asarray(ref[0].astype(jnp.float32))
           + 1j * np.asarray(ref[1].astype(jnp.float32)))
    got = mid_pair_fft.fft_mid_pair(torch.from_numpy(re).to(tdt),
                                    torch.from_numpy(im).to(tdt),
                                    inverse=inverse, scale=scale)
    assert got[0].dtype == tdt and got[0].shape == shape
    got = got[0].float().numpy() + 1j * got[1].float().numpy()
    if storage == "f32":
        assert_spectrum_close(got, ref, np.complex64)
        assert _err(got, ref) < 1e-5
    else:
        assert _err(got, ref) < 8e-3


def _header_lists():
    text = (Path(mid_pair_fft.__file__).parent.parent / "csrc"
            / "mid_line.cuh").read_text()
    out = {}
    for fam in ("POW2", "R3", "R5", "R7", "R15"):
        body = re.search(rf"#define TPUFFT_MID_{fam}\(X\)(.*)", text).group(1)
        out[fam] = tuple(int(v) for v in re.findall(r"X\((\d+)\)", body))
    return out


def test_mixed_lengths_match_the_header():
    """``MIXED_LENGTHS`` is the union of the header's family lists, each
    family's lengths have its odd part, and every pair of them gets the
    form, cluster and envelope that ``mixed_pair`` (csrc/mid_line.cuh)
    and ``line_mid`` (csrc/cluster_fft.cu) give it."""
    lists = _header_lists()
    assert sorted(sum(lists.values(), ())) == list(mid_pair_fft.MIXED_LENGTHS)
    for fam, odd in (("POW2", 1), ("R3", 3), ("R5", 5), ("R7", 7),
                     ("R15", 15)):
        for n in lists[fam]:
            assert n % odd == 0 and (n // odd) & (n // odd - 1) == 0
    assert max(mid_pair_fft.MIXED_LENGTHS) == 256
    counts = {"lines": 0, "mixed": 0, "stages": 0}
    for n1 in mid_pair_fft.MIXED_LENGTHS:
        for n2 in mid_pair_fft.MIXED_LENGTHS:
            form = mid_pair_fft.form(n1, n2, 8)
            counts[form] += 1
            pow2 = n1 in mid_pair_fft.LINE_LENGTHS and (
                n2 in mid_pair_fft.LINE_LENGTHS)
            c8 = pick_cluster(n1, n2 * 8)
            if pow2:
                assert form == "lines"
            elif c8 is None:
                assert form == "stages"
                assert mid_pair_fft.lanes(n1, n2) == mid_pair_fft.LANES
            else:
                assert form == "mixed", (n1, n2)
                c = mid_pair_fft.cluster_size(n1, n2)
                assert c == c8 and c in (1, 2, 4, 8, 16)
                assert n1 % c == 0 and n2 * 8 % c == 0
                assert n1 // c * n2 * 8 <= 16384
                assert mid_pair_fft.lanes(n1, n2) == 8
            for dtype in (torch.float32, torch.bfloat16):
                assert mid_pair_fft.supported(n1, n2, 37, dtype)
    assert counts == {"lines": 49, "mixed": 933, "stages": 42}


def _lane_out(n, r):
    """lane_dft.cuh's lane_out<N>(r): the output a register holds."""
    if n == 1:
        return 0
    a = (8 if n % 8 == 0 and n != 16 else 4 if n % 4 == 0 else
         2 if n % 2 == 0 else next(p for p in range(3, n + 1, 2)
                                   if n % p == 0))
    b = n // a
    return r // b + a * _lane_out(b, r % b)


def _mix_geometry(n):
    """mid_line.cuh's MixLine<n>: R, P, V, G, W, and Q (Line<P, V>'s, 1
    where G > V)."""
    r = n
    while r % 2 == 0:
        r //= 2
    p = n // r
    v = 1
    if p > 1:
        v = p if p < 8 else (16 if p >= 128 else 8)
        while r * v > 32 and v > 1:
            v //= 2
    g = p // v
    return r, p, v, g, 32 // g, v // g if g <= v else 1


def _sub_out(m, r, V, G, Q):
    """line_fft.cuh's Line<P, V>::out(m, r)."""
    if G <= V:
        return m * Q + r % Q + V * (r // Q)
    b = int(format(m, f"0{G.bit_length() - 1}b")[::-1], 2) if G > 1 else 0
    return r + V * b


def _mix_line(x, inverse):
    """One line of MixLine<n> as the lanes of a warp run it: lane l holds
    x[l + G j + P s] in register (s, j); the R-point DFT over s (its output
    order is lane_dft's, or natural for R = 7), the twiddle W_n^(p q), then
    line_fft.cuh's line_core on each sub-line (the radix-V DFT, w_P^(l a),
    then for G <= V log2 G exchanges and radix-G DFTs, for G > V log2 G
    radix-2 stages across the lanes); register (i, r) of place m ends
    holding X[q_i + R out_P(m, r)]. Returns X."""
    n = len(x)
    R, P, V, G, W, Q = _mix_geometry(n)
    sgn = 1 if inverse else -1
    w = np.exp(sgn * 2j * np.pi * np.arange(n) / n)

    def dft(v):
        k = np.arange(len(v))
        return np.exp(sgn * 2j * np.pi * np.outer(k, k) / len(v)) @ v

    q_of = [i if R % 7 == 0 else _lane_out(R, i) for i in range(R)]
    regs = np.array([[[x[l + G * j + P * s] for j in range(V)]
                      for s in range(R)] for l in range(G)], complex)
    for l in range(G):
        for j in range(V):
            y = dft(regs[l, :, j])
            regs[l, :, j] = [y[q] for q in q_of]
            for i in range(R):
                regs[l, i, j] *= w[(l + G * j) * q_of[i]]
    for i in range(R):
        v = regs[:, i, :].copy()           # (place, register)
        for l in range(G):
            v[l] = dft(v[l])
            v[l, 1:] *= w[R * l * np.arange(1, V)]
        if G > V:                          # the lane stages
            h = G // 2
            while h >= 1:
                new = v.copy()
                for l in range(G):
                    other = v[l ^ h]
                    if l & h:
                        wt = np.exp(sgn * 2j * np.pi * (l & (h - 1))
                                    / (2 * h))
                        new[l] = (other - v[l]) * wt
                    else:
                        new[l] = v[l] + other
                v, h = new, h // 2
        else:
            for b in range(int(np.log2(G))):   # the exchanges
                bit = Q << b
                for l in range(G):
                    if (l >> b) & 1:
                        continue
                    for r in range(V):
                        if r & bit:
                            continue
                        h = l | (1 << b)
                        v[l, r | bit], v[h, r] = v[h, r], v[l, r | bit]
            for l in range(G):
                for a in range(Q):
                    v[l, a::Q][:G] = dft(v[l, [b * Q + a for b in range(G)]])
        regs[:, i, :] = v
    out = np.zeros(n, complex)
    for m in range(G):
        for i in range(R):
            for r in range(V):
                out[q_of[i] + R * _sub_out(m, r, V, G, Q)] = regs[m, i, r]
    return out


def _at(j, k2, l, slab):
    return j * slab + (k2 >> 1) * 16 + (
        (((k2 & 1) << 3) | l) ^ (((k2 >> 1) & 3) << 2))


def _degree(addrs):
    """Bank-conflict degree of one warp's 8-byte shared accesses: each half
    warp a request, distinct words on one bank pair serialized."""
    worst = 1
    for half in (addrs[:16], addrs[16:]):
        words = {a for a in half if a is not None}
        per = {}
        for a in words:
            per[a % 16] = per.get(a % 16, 0) + 1
        worst = max([worst, *per.values()])
    return worst


@pytest.mark.parametrize("n", mid_pair_fft.MIXED_LENGTHS)
def test_mixed_line_model(n):
    """The index math of mid_line.cuh's MixLine, in numpy, against the DFT:
    the register layout, the odd DFT's output order, the twiddle, the
    exchanges or lane stages of line_fft.cuh and the output map, both
    directions; a lane holds at most 32 values, a line's lanes lie in one
    warp."""
    x = np.random.default_rng(n).standard_normal(n) + 1j * np.random.default_rng(
        n + 1).standard_normal(n)
    R, P, V, G, W, Q = _mix_geometry(n)
    assert R * V <= 32 and G <= 16
    for inverse in (False, True):
        want = (np.fft.ifft(x) * n) if inverse else np.fft.fft(x)
        got = _mix_line(x, inverse)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-12


@pytest.mark.parametrize("n1,n2,reads2,writes2,reads1", [
    (160, 160, 1, 4, 2), (48, 160, 1, 4, 1), (56, 56, 1, 1, 1),
    (256, 128, 1, 1, 4)])
def test_mixed_tile_model(n1, n2, reads2, writes2, reads1):
    """The generic-radix form's tile (MidTile, shared with the power-of-two
    line form) at its timed pairs: the 2-D DFT of a ragged (n1, n2, 11)
    tile over the pair's cluster through the model line, every position
    of the swizzle one-to-one, and the worst bank-conflict degree of a
    warp's 8-byte accesses in step 2 (the n2 lines' reads and writes, in
    place) and step 3 (the n1 lines' reads, counted on the block read):
    the model's figures, which a change of the layout must update."""
    rng = np.random.default_rng(n1 + n2)
    L, lanes = 11, 8
    C = mid_pair_fft.cluster_size(n1, n2)
    S, slab, cols = n1 // C, n2 * lanes + 8, n2 * lanes // C
    x = rng.standard_normal((n1, n2, L)) + 1j * rng.standard_normal(
        (n1, n2, L))
    assert len({_at(j, k2, l, slab) for j in range(S) for k2 in range(n2)
                for l in range(lanes)}) == S * n2 * lanes

    def warps(n, lines):
        """Each warp's lanes as (place, line), whole warps of W lines."""
        R, P, V, G, W, Q = _mix_geometry(n)
        count = -(-lines // W)
        return [[((t % 32) // W, w * W + (t % 32) % W) for t in range(32)]
                for w in range(count)], (R, P, V, G, W, Q)

    seen = {"r2": 1, "w2": 1, "r1": 1}
    ws, (R, P, V, G, W, Q) = warps(n2, S * lanes)
    for warp in ws:
        for s in range(R):
            for q in range(V):
                seen["r2"] = max(seen["r2"], _degree([
                    _at(line // lanes, l + G * q + P * s, line % lanes, slab)
                    if line < S * lanes else None for l, line in warp]))
        for i in range(R):
            qi = i if R % 7 == 0 else _lane_out(R, i)
            for r in range(V):
                seen["w2"] = max(seen["w2"], _degree([
                    _at(line // lanes, qi + R * _sub_out(l, r, V, G, Q),
                        line % lanes, slab)
                    if line < S * lanes else None for l, line in warp]))
    ws, (R, P, V, G, W, Q) = warps(n1, cols)
    for warp in ws:
        for s in range(R):
            for q in range(V):
                addrs = []
                for l, line in warp:
                    k1 = l + G * q + P * s
                    col = line   # block 0's columns
                    addrs.append(None if line >= cols else
                                 (k1 // S) * 10 ** 6 + _at(
                                     k1 % S, col // lanes, col % lanes, slab))
                seen["r1"] = max(seen["r1"], _degree(addrs))
    assert (seen["r2"], seen["w2"], seen["r1"]) == (reads2, writes2, reads1)
    # the 2-D DFT through the tile, step by step
    y = np.zeros_like(x)
    for l0 in range(0, L, lanes):
        tiles = []
        for rank in range(C):
            t = np.zeros(S * slab, complex)
            for j in range(S):
                for k2 in range(n2):
                    for l in range(min(lanes, L - l0)):
                        t[_at(j, k2, l, slab)] = x[rank * S + j, k2, l0 + l]
            for j in range(S):
                for l in range(lanes):
                    pos = [_at(j, k2, l, slab) for k2 in range(n2)]
                    t[pos] = _mix_line(t[pos], False)
            tiles.append(t)
        for col in range(n2 * lanes):
            k2, l = col // lanes, col % lanes
            if l0 + l < L:
                y[:, k2, l0 + l] = _mix_line(np.array(
                    [tiles[k1 // S][_at(k1 % S, k2, l, slab)]
                     for k1 in range(n1)]), False)
    want = np.fft.fft2(x, axes=(0, 1))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-12

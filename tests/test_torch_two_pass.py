"""The port's two-pass split against tpufft's, and the model of its swapped
store.

A length above the single-pass envelope, n = a * b, runs two strided
passes in the port: K3 over a with the twiddle T[ka, ib] and the digit
swap in its store (``fft_inner_nd(..., swap=True)``, planes (pre, b, a,
post)), then K2 over b, whose store is the natural order. tpufft runs the
same arithmetic with the swap as one copy after pass 2.

Both packages get the same numpy arrays made from a seed. tpufft runs its
Pallas kernels in interpret mode on the CPU (``PlanConfig(interpret=True)``,
as ``tests/test_kernels.py`` runs its two-pass); the port runs its
kernels' plain versions (CPU tensors). Tolerances: ``assert_spectrum_close``
(1e-3 of the spectrum's magnitude for c64) and 8e-3 for bf16 storage. The
swapped plain version is the natural one permuted, bit for bit.

The restage models walk the swapped store where the line form restages a
unit through its tile (``kRestage`` and ``restage_pos`` in
``csrc/strided_line.cuh``) and the cluster form over its cluster's tiles
(``csrc/strided_long.cuh``): every (c, k) of the unit has its own slot,
the writes of pass 2 and the reads of the stores meet no bank conflict,
and output e of the unit lands where the swapped order puts
(row k, column c).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpufft
from tpufft import PlanConfig as TPPlanConfig

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex, execute
from tpufft_torch.kernels import inner_fft, minor_fft
from conftest import assert_spectrum_close
from _tpufft_caches import cold_tpufft_caches  # noqa: F401
from test_torch_strided_geometry import CLUSTER, SPLITS, model_geometry

TP_CFG = TPPlanConfig(interpret=True, backend="auto", precision="highest")
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))
BF16_TOL = 8e-3


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _spied(monkeypatch):
    """The wrappers each call reached, with their planes' shapes."""
    calls = []
    for mod, name in ((minor_fft, "fft_minor"), (inner_fft, "fft_inner"),
                      (inner_fft, "fft_inner_nd")):
        def spy(xr, xi, _real=getattr(mod, name), _name=name, **kw):
            calls.append((_name, tuple(xr.shape), kw.get("swap", False)))
            return _real(xr, xi, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


# length, batch, and the split the rule gives
CASES = [(32768, 3, (1024, 32)), (49152, 2, (1024, 48)),
         (1 << 17, 2, (1024, 128))]


@pytest.mark.parametrize("norm", [None, "ortho"])
@pytest.mark.parametrize("fn", ["fft", "ifft"])
@pytest.mark.parametrize("n,batch,split", CASES,
                         ids=[str(c[0]) for c in CASES])
def test_two_pass_matches_tpufft(n, batch, split, fn, norm, monkeypatch):
    """Forward, inverse and ``norm="ortho"`` through the two strided
    passes (K3 swapped, then K2; no K1) against tpufft's two-pass."""
    x = _complex((batch, n), seed=n + batch)
    ref = getattr(tpufft, fn)(x, norm=norm, config=TP_CFG)
    calls = _spied(monkeypatch)
    got = getattr(tpufft_torch, fn)(x, norm=norm, config=CFG, device="cpu")
    a, b = split
    assert calls == [("fft_inner_nd", (batch * a, b, 1), True),
                     ("fft_inner", (batch, b, a), False)]
    assert got.dtype == np.complex64
    assert_spectrum_close(got, np.asarray(ref), np.complex64)


@pytest.mark.parametrize("fn", ["fft", "ifft"])
def test_two_pass_non_minor_axis_matches_tpufft(fn, monkeypatch):
    """A long axis with a trailing dim, (3, 32768, 4) along axis 1: the
    same two strided passes with L = 4, no transpose copy."""
    x = _complex((3, 32768, 4), seed=5)
    ref = getattr(tpufft, fn)(x, axis=1, config=TP_CFG)
    calls = _spied(monkeypatch)
    got = getattr(tpufft_torch, fn)(x, axis=1, config=CFG, device="cpu")
    assert calls == [("fft_inner_nd", (3 * 1024, 32, 4), True),
                     ("fft_inner", (3, 32, 1024 * 4), False)]
    assert_spectrum_close(got, np.asarray(ref), np.complex64)


@pytest.mark.parametrize("n", [32768, 1 << 17])
def test_two_pass_bf16_storage(n):
    """bf16 planes stay bf16 through both passes (pass 1 rounds its
    output to bf16, as tpufft does), within 8e-3 of
    tpufft's."""
    tp_cfg = dataclasses.replace(TP_CFG, plane_dtype="bfloat16")
    cfg = PlanConfig(**dataclasses.asdict(tp_cfg))
    x = _complex((2, n), seed=n + 7)
    ref = np.asarray(tpufft.fft(x, config=tp_cfg))
    out = tpufft_torch.fft(SplitComplex(
        torch.from_numpy(x.real.copy()).bfloat16(),
        torch.from_numpy(x.imag.copy()).bfloat16()), config=cfg)
    assert out.dtype == torch.bfloat16
    got = out.numpy()
    err = np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))
    assert err < BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pre,n,M,L", [(3, 64, 37, 1), (2, 40, 12, 5),
                                       (1, 93, 8, 3)])
def test_swapped_plain_version_is_the_natural_one_permuted(pre, n, M, L,
                                                           dtype):
    """``swap=True`` stores output (p, k, m, l) of the natural (pre n, M, L)
    result at (p, m, k, l): equal bit for bit, through the wrapper on CPU
    tensors and through the plain version."""
    rng = np.random.default_rng(n + M)
    xr, xi = (torch.from_numpy(rng.standard_normal((pre * n, M, L)).astype(
        np.float32)).to(dtype) for _ in range(2))
    tw = execute._device_two_pass_twiddle(n, M, False, torch.device("cpu"))
    kw = dict(n=n, inverse=False, scale=0.5, twiddle=tw)
    nat = inner_fft.fft_inner_nd_reference(xr, xi, **kw)
    for got in (inner_fft.fft_inner_nd_reference(xr, xi, swap=True, **kw),
                inner_fft.fft_inner_nd(xr, xi, swap=True, **kw)):
        assert got[0].shape == (pre, M, n, L) and got[0].dtype == dtype
        for g, r in zip(got, nat):
            want = r.reshape(pre, n, M, L).transpose(1, 2)
            assert torch.equal(g, want)


def test_swap_needs_the_twiddle():
    x = torch.zeros(2 * 64, 8, 1)
    with pytest.raises(ValueError, match="swap=True needs the twiddle"):
        inner_fft.fft_inner_nd(x, x, n=64, inverse=False, scale=1.0,
                               swap=True)


# the split rule (pass 1 over a, pass 2 over b), from PERF.md's sweep:
# a = 1024 wherever it divides n with b in the envelope, else the next of
# execute._PASS1 (where pass 1 restages its swapped store), else the most
# balanced split
SPLIT_RULE = {32768: (1024, 32), 49152: (1024, 48), 1 << 17: (1024, 128),
              1 << 20: (1024, 1024), 1 << 21: (1024, 2048),
              1 << 24: (1024, 16384), 1 << 25: (2048, 16384),
              15 << 12: (1024, 60), 72000: (960, 75),
              41472: (1536, 27), 1 << 26: (8192, 8192),
              3 ** 10: (243, 243), 1048684: (1118, 938)}


@pytest.mark.parametrize("n", sorted(SPLIT_RULE))
def test_split_rule(n):
    """``execute._split_large`` at the paths' lengths and at the rule's
    fallbacks: both factors inside the kernels' envelope, their product
    n."""
    a, b = execute._split_large(n)
    assert (a, b) == SPLIT_RULE[n] and a * b == n
    assert minor_fft.supported(a, torch.float32)
    assert minor_fft.supported(b, torch.float32)


# ----------------------------------------------------------------------------
# The line form's restaged swapped store
# ----------------------------------------------------------------------------

def _max_prime(n: int) -> int:
    p, m, d = 1, n, 2
    while m > 1:
        while m % d == 0:
            p, m = d, m // d
        d += 1
    return p


def _restaged(n: int) -> bool:
    """``kRestage`` of ``strided_lane_kernel``: pass 2 in one round (N2 of
    32, or 64 on lane pairs), no emitting prime, n a multiple of 16."""
    n1, n2 = SPLITS[n]
    if n2 == 1:
        return False
    rounds = -(-64 // n2) if n2 > 32 else -(-32 // n2)
    return rounds == 1 and _max_prime(n2) < 7 and n % 16 == 0


def restage_pos(c: int, k: int, n: int) -> int:
    """c n + (k ^ the 4-bit reversal of c mod 16)."""
    return c * n + (k ^ int(f"{c & 15:04b}"[::-1], 2))


RESTAGED_NS = [n for n in sorted(SPLITS) if _restaged(n)]


def test_restaged_lengths():
    assert RESTAGED_NS == [480, 960, 1024, 1280, 1536, 1920, 2048]


def _conflicts(positions) -> int:
    """The most distinct 8-byte words of one half warp (one wavefront of
    float2 accesses) on one bank pair."""
    worst = 1
    for h in range(0, len(positions), 16):
        words = {}
        for pos in set(positions[h:h + 16]):
            words.setdefault(pos % 16, set()).add(pos)
        worst = max([worst] + [len(v) for v in words.values()])
    return worst


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", RESTAGED_NS)
def test_restage_model(n, bf16):
    """At every C the block takes and every L dividing it: the (c, k) slots
    are a permutation of the unit's C n tile values; pass 2's writes (lanes
    on consecutive lines c + C k1, each writing row k1 + N1 k2 at a step)
    and the stores' reads (consecutive e) meet no bank conflict; and output
    e of the unit at column c0 lies at c0 n + e of its slab, the swapped
    order's place of (row k, column c0 + c)."""
    if bf16 and n > 1024:
        return
    n1, n2 = SPLITS[n]
    pair = n2 > 32
    for post in (8, 16, 32, 64, 1024):
        geo = model_geometry(n, post, bf16)
        if geo is None or "q" in geo:
            continue
        C = geo["cols"]
        cl = C.bit_length() - 1
        slots = {restage_pos(c, k, n) for c in range(C)
                 for k in range(n)}
        assert slots == set(range(C * n))
        lanes = geo["threads"]
        for q in range(n2 // 2 if pair else n2):
            writes = []
            for t in range(lanes):
                line = (t & 15) + 16 * (t >> 5) if pair else t
                if line >= n1 * C:
                    continue
                c, k1 = line & (C - 1), line >> cl
                k2 = (2 * q + ((t >> 4) & 1)) if pair else q
                writes.append(restage_pos(c, k1 + n1 * k2, n))
            assert _conflicts(writes) == 1, (post, q)
        for L in (1, 2, 4, 8, 16, 32):
            if C % L:
                continue
            c0 = 3 * C
            reads, seen = [], set()
            for e in range(C * n):
                r = e >> (L.bit_length() - 1)
                mm, k = divmod(r, n)
                cc = mm * L + (e & (L - 1))
                reads.append(restage_pos(cc, k, n))
                col = c0 + cc
                # (p, m, k, l) of (pre, M, n, L) at p = 0
                assert (col // L) * n * L + k * L + col % L == c0 * n + e
                seen.add((cc, k))
            assert len(seen) == C * n
            assert _conflicts(reads) == 1, (post, L)


# ----------------------------------------------------------------------------
# The cluster form's restaged swapped store
# ----------------------------------------------------------------------------

def _cluster_restaged(n: int) -> bool:
    """``kRestage`` of ``strided_cluster_kernel``: pass 3 holds all its
    lines at once (S3 = H3) and R = n / Q is a multiple of 16."""
    n1, n2, n3, q, threads = CLUSTER[n]
    s3 = -(-(n1 // q) * n2 * 16 // threads)
    h3 = max(1, min(32 // n3, s3))
    return s3 == h3 and (n // q) % 16 == 0


CLUSTER_RESTAGED = [n for n in sorted(CLUSTER) if _cluster_restaged(n)]


def test_cluster_restaged_lengths():
    assert CLUSTER_RESTAGED == [1920, 2048, 3840, 4096, 7680, 8192, 15360,
                                16384]


@pytest.mark.parametrize("n", CLUSTER_RESTAGED)
def test_cluster_restage_model(n):
    """Pass 3's lines (kk, k2, c) of every block, lanes on consecutive c,
    write each output k into block k / R's slot restage_pos(c, k mod R,
    R): the slots of each block are a permutation of its tile's C R
    values, and no half warp's writes meet a bank conflict; each block's
    stores (consecutive e) read without one, and output e of block b lies
    at c0 n + b R L + ..., the swapped order's place of (row k, column c0
    + c)."""
    n1, n2, n3, q, threads = CLUSTER[n]
    K, C, R = n1 // q, 16, n // q
    slots = [set() for _ in range(q)]
    for b in range(q):
        for w in range(K * n2 * C):
            c, qq = w & (C - 1), w >> 4
            kk, k2 = divmod(qq, n2)
            for k3 in range(n3):
                k = b * K + kk + n1 * k2 + n1 * n2 * k3
                slots[k // R].add(restage_pos(c, k % R, R))
        for k3 in range(n3):  # one half warp: 16 columns of one line
            writes = [restage_pos(c, (b * K + n1 * n2 * k3) % R, R)
                      for c in range(16)]
            assert _conflicts(writes) == 1
    assert all(sl == set(range(C * R)) for sl in slots)
    for L in (1, 2, 4, 8, 16):
        reads = []
        for b in range(q):
            for e in range(R * C):
                r = e >> (L.bit_length() - 1)
                mm, kl = divmod(r, R)
                cc = mm * L + (e & (L - 1))
                reads.append(restage_pos(cc, kl, R))
                k, col = b * R + kl, cc
                addr = mm * n * L + k * L + (e & (L - 1))
                assert addr == (col // L) * n * L + k * L + col % L
        assert _conflicts(reads) == 1, L

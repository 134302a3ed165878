"""A model of the strided kernel's form choice and line-form geometry
(``line_split`` and ``line_geometry`` in
``tpufft_torch/csrc/strided_line.cuh``; the cluster form's lists and
``cluster_geometry`` in ``tpufft_torch/csrc/strided_long.cuh``), with the
table of forms expected at each (n, post, dtype).

The port reads the geometry from the CUDA library
(``inner_fft.line_geometry``), which needs the toolkit. The CPU tests use
this model instead: ``test_torch_kernel_inner.py`` walks the tile mapping of
every geometry and runs the model FFT on its four-step, and the ``form``
tests there and in ``test_torch_kernel_fused.py`` run the wrappers' Python
side over it. ``test_torch_cuda.py`` holds the library's answers to the
model on the card. This module imports neither jax nor tpufft, so the card
tests can import it.
"""

import pytest
import torch

from tpufft_torch.kernels import minor_fft

# The four-step n = N1 N2 of each length of the line form; N2 = 1 for
# n <= 32, one line a lane; an N2 of 34 to 64 lies on lane pairs.
SPLITS = {8: (8, 1), 10: (10, 1), 12: (12, 1), 16: (16, 1), 20: (20, 1),
          24: (24, 1), 25: (25, 1), 30: (30, 1), 32: (32, 1), 40: (10, 4),
          48: (12, 4), 60: (15, 4), 64: (8, 8), 80: (10, 8), 93: (3, 31),
          96: (12, 8), 120: (15, 8), 128: (16, 8), 160: (20, 8),
          192: (24, 8), 240: (15, 16), 256: (16, 16), 320: (20, 16),
          384: (24, 16), 480: (15, 32), 512: (32, 16), 640: (32, 20),
          768: (32, 24), 960: (15, 64), 1024: (32, 32), 1080: (30, 36),
          1280: (20, 64), 1536: (24, 64), 1920: (30, 64), 2048: (32, 64)}
# n = r 2^a, r in {1, 3, 5}, 8 to 2048; 15 2^a, 30 to 1920; 25, 93, 1080
LINE_NS = sorted(SPLITS)
NEW_LINE_NS = [n for n in LINE_NS if n % 15 == 0 or n in (25, 93)]
LINES_THREADS = 128           # a block of the n <= 32 kernel
SMEM_MAX = 232448             # bytes of shared memory a block may take

# The cluster form (csrc/strided_long.cuh, ClusterStep): n -> (N1, N2, N3,
# Q, threads), the lists TPUFFT_STRIDED_LONG_A and _B; f32 takes the lengths
# above 2048, bf16 every one. n = N1 N2 N3, a unit of C = 16 columns, a
# cluster of Q blocks, block b owning the rows k1 in [b N1 / Q, (b + 1) N1 /
# Q); the tile holds (k1 mod N1 / Q, c2, j3, c) at ((kk N2 + c2) N3 + j3) C
# + c.
CLUSTER = {
    1080: (30, 2, 18, 2, 256), 1280: (16, 4, 20, 2, 256),
    1536: (16, 3, 32, 2, 256), 1920: (16, 4, 30, 4, 256),
    2048: (16, 4, 32, 4, 256), 2160: (16, 5, 27, 4, 256),
    2560: (16, 5, 32, 4, 256), 3072: (16, 6, 32, 4, 256),
    3840: (16, 8, 30, 8, 256), 4096: (16, 8, 32, 8, 256),
    4320: (16, 9, 30, 8, 256), 5120: (16, 10, 32, 8, 256),
    6144: (16, 12, 32, 8, 256), 7680: (16, 15, 32, 16, 256),
    8192: (16, 16, 32, 16, 256), 8320: (16, 20, 26, 16, 256),
    10240: (16, 20, 32, 16, 256), 12288: (16, 24, 32, 16, 256),
    15360: (16, 30, 32, 16, 512), 16384: (16, 32, 32, 16, 512)}
LONG_F32_ABOVE = 2048         # f32 runs the four-step line form up to it
CLUSTER_NS = [n for n in sorted(CLUSTER) if n > LONG_F32_ABOVE]  # both
LONG_COLS = 16                # C, columns a unit (kLongCols)
TWO_BLOCKS_SMEM = 115712      # bytes a block, two an SM (228 KB less 1 KB
#                               reserved a block)


def cluster_smem(n1: int, n2: int, n3: int, q: int) -> int:
    """``cluster_smem``: the line tables at pad(m), the A, B and C tables
    and the tile of N1 / Q rows of N2 N3 C values, in bytes."""
    table = sum(m + m // 16 + 1 for m in (n1, n2, n3)) + (
        n1 * n2 + n1 * n3 + n2 * n3)
    return 8 * (table + (n1 // q) * n2 * n3 * LONG_COLS)


def cluster_geometry(n: int, post: int, bf16: bool) -> dict | None:
    """``cluster_geometry``: the cluster form's geometry at n and post, or
    None where n is on no list, f32 n is at most 2048 or post holds fewer
    than 8 f32 (16 bf16) columns."""
    if (n not in CLUSTER or (not bf16 and n <= LONG_F32_ABOVE)
            or post < (16 if bf16 else 8)):
        return None
    n1, n2, n3, q, threads = CLUSTER[n]
    smem = cluster_smem(n1, n2, n3, q)
    if smem > SMEM_MAX:
        return None
    return {"n1": n1, "n2": n2, "n3": n3, "q": q, "cols": LONG_COLS,
            "threads": threads, "smem": smem}


def lane_threads(n: int, bf16: bool) -> int:
    """The four-step kernel's launch bound: 320 lanes a block, or 512
    where the narrowest unit (8 f32 or 16 bf16 columns) takes more."""
    return 512 if n * (16 if bf16 else 8) // 32 > 320 else 320


def model_geometry(n: int, post: int, bf16: bool,
                   cols: int = 0) -> dict | None:
    """The line form's geometry at n and post, as the launch's
    ``line_geometry`` computes it (keys of ``inner_fft.line_geometry``),
    or None for the stage form. ``cols`` = 8, 16 or 32 takes that C
    instead of the launch's widest fitting one, so that the tile tests
    walk every C a block can hold. Where the four-step takes no launch
    (``cols`` = 0), the cluster form's geometry (``cluster_geometry``)
    or None: the launch tries them in that order."""
    geo = four_step_geometry(n, post, bf16, cols)
    if geo is None and cols == 0:
        return cluster_geometry(n, post, bf16)
    return geo


def four_step_geometry(n: int, post: int, bf16: bool,
                       cols: int = 0) -> dict | None:
    """``line_geometry``: the four-step's geometry (``model_geometry``)
    or None."""
    if n not in SPLITS:
        return None
    n1, n2 = SPLITS[n]
    min_cols = 16 if bf16 else 8
    if cols == 0:
        if post < min_cols:
            return None
        cols = 32
        while cols > min_cols and (cols > post or (
                n2 > 1 and cols * n // 32 > lane_threads(n, bf16))):
            cols //= 2
    if cols < min_cols:
        return None
    threads = (LINES_THREADS if n2 == 1
               else (-(-cols * n // 32) + 31) // 32 * 32)
    smem = 8 * (n + n // 16 + (0 if n2 == 1 else cols * n))
    if threads > lane_threads(n, bf16) or smem > SMEM_MAX:
        return None
    return {"n1": n1, "n2": n2, "cols": cols, "threads": threads,
            "pair": n2 > 32, "smem": smem}


def model_form(n: int, post: int, dtype) -> str | None:
    """``inner_fft.form`` by the model."""
    if not minor_fft.supported(n, dtype):
        return None
    geo = model_geometry(n, post, dtype == torch.bfloat16)
    return "stages" if geo is None else "lines"


def use_model(monkeypatch) -> None:
    """Answer ``inner_fft``'s geometry query from the model instead of the
    library."""
    from tpufft_torch.kernels import inner_fft
    monkeypatch.setattr(inner_fft, "_line_geometry", model_geometry)


# (n, post, dtype, the form the launch runs)
FORM_CASES = (
    [(n, 480, torch.float32, "lines") for n in LINE_NS]
    + [(n, 8, torch.float32, "lines") for n in (8, 40, 640, 2048)]
    + [(n, 7, torch.float32, "stages") for n in (8, 128, 2048)]
    + [(n, 1, torch.float32, "stages") for n in (8, 640)]
    + [(n, 16, torch.bfloat16, "lines") for n in (8, 96, 640, 1024)]
    + [(n, 15, torch.bfloat16, "stages") for n in (8, 128, 1024)]
    + [(n, 480, torch.bfloat16, "lines") for n in (1280, 1536, 2048)]
    + [(n, 480, torch.bfloat16, "lines") for n in (1080, 1920)]
    + [(n, 480, torch.bfloat16, "lines") for n in (25, 93, 480, 960)]
    + [(n, 480, torch.float32, "stages")
       for n in (2, 4, 5, 6, 127, 2880, 4100, 16380, 37, 3 * 37, 62)]
    + [(131, 480, torch.float32, None), (16385, 480, torch.float32, None),
       (128, 480, torch.float64, None)]
    # the cluster form: every length of its lists on 8 f32 (16 bf16)
    # columns and more, none under them; lengths on no list stay on the
    # stage form
    + [(n, post, torch.float32, "lines") for n in CLUSTER_NS
       for post in (8, 480)]
    + [(n, post, torch.bfloat16, "lines") for n in sorted(CLUSTER)
       for post in (16, 480)]
    + [(n, 7, torch.float32, "stages") for n in (2160, 4096, 16384)]
    + [(n, 15, torch.bfloat16, "stages") for n in (1080, 2048, 16384)]
    + [(n, 480, dt, "stages") for n in (2880, 4100, 6000, 9216)
       for dt in (torch.float32, torch.bfloat16)])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", LINE_NS)
def test_model_geometry(n, bf16):
    """At every length and post, the model's geometry is a four-step of n
    whose block is a whole number of warps holding C n / 32 lanes (n > 32)
    within the launch bound and the shared memory, with C the widest of
    32, 16 and 8 that fits, never wider than post, and no narrower than 8
    f32 or 16 bf16 columns."""
    min_cols = 16 if bf16 else 8
    for post in (1, min_cols - 1, min_cols, 9, 17, 31, 32, 33, 241, 4096):
        geo = model_geometry(n, post, bf16)
        if post < min_cols:
            assert geo is None
            continue
        if geo is None or "q" in geo:   # bf16 above 1024: the cluster form
            assert bf16 and n > 1024
            assert (geo is None) == (post < min_cols)
            continue
        assert geo["n1"] * geo["n2"] == n and geo["n1"] <= 32
        assert min_cols <= geo["cols"] <= max(post, min_cols)
        assert geo["threads"] % 32 == 0
        assert geo["threads"] <= lane_threads(n, bf16)
        assert geo["smem"] <= SMEM_MAX
        if geo["n2"] > 1:
            assert geo["threads"] >= geo["cols"] * n // 32
        wider = 2 * geo["cols"]
        assert (wider > 32 or wider > post or (
            geo["n2"] > 1 and wider * n // 32 > lane_threads(n, bf16)))


# ----------------------------------------------------------------------------
# The cluster form (csrc/strided_long.cuh)
# ----------------------------------------------------------------------------

CLUSTER_CASES = ([(n, False) for n in CLUSTER_NS]
                 + [(n, True) for n in sorted(CLUSTER)])


def _max_prime(n: int) -> int:
    best, p = 1, 2
    while n > 1:
        while n % p == 0:
            best, n = p, n // p
        p += 1
    return best


def test_cluster_lists_match_the_source():
    """``CLUSTER`` is the lists TPUFFT_STRIDED_LONG_A and _B of
    ``csrc/strided_long.cuh``, each instantiated in f32 and bf16 by a
    source of its own, and C and the f32 threshold are its kLongCols and
    kLongF32Above."""
    import pathlib
    import re
    csrc = pathlib.Path(minor_fft.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "strided_long.cuh").read_text()
    got = {}
    for name in ("A", "B"):
        body = text.split(f"#define TPUFFT_STRIDED_LONG_{name}(X)")[1]
        body = body.split("#define")[0].split("\n\n")[0]
        for m in re.findall(r"X\(([\d, ]+)\)", body):
            row = tuple(int(v) for v in m.split(","))
            got[row[0]] = row[1:]
        for dtype in ("f32", "bf16"):
            src = (csrc / f"strided_long_{name.lower()}_{dtype}.cu"
                   ).read_text()
            assert f"TPUFFT_STRIDED_LONG_{name}," in src
    assert got == CLUSTER
    assert f"constexpr int kLongCols = {LONG_COLS};" in text
    assert f"constexpr int kLongF32Above = {LONG_F32_ABOVE};" in text


@pytest.mark.parametrize("n,bf16", CLUSTER_CASES)
def test_cluster_geometry(n, bf16):
    """The split is three factors of at most 32 whose primes a lane line
    takes (up to 31); Q divides N1 (each block owns N1 / Q rows k1) and the
    cluster's M C pass-1 lines; Q is the smallest of 1, 2, 4, 8, 16 that
    leaves two blocks of 256 threads an SM (shared memory at most
    ``TWO_BLOCKS_SMEM``), else 16 with one block of 512; a block stays
    within the shared memory. The cluster form takes every post of at
    least 8 f32 (16 bf16) columns and never a post under it; f32 at
    most 2048 never (the four-step line form takes it)."""
    geo = cluster_geometry(n, 4096, bf16)
    n1, n2, n3, q = geo["n1"], geo["n2"], geo["n3"], geo["q"]
    assert n1 * n2 * n3 == n and max(n1, n2, n3) <= 32
    assert _max_prime(n1 * n2 * n3) <= 31
    assert n1 % q == 0 and (n2 * n3 * LONG_COLS) % q == 0
    assert geo["cols"] == LONG_COLS and geo["smem"] <= SMEM_MAX
    if geo["threads"] == 256:
        assert geo["smem"] <= TWO_BLOCKS_SMEM
        for c in (1, 2, 4, 8):   # a smaller cluster leaves one block an SM
            if c < q and n1 % c == 0:
                assert cluster_smem(n1, n2, n3, c) > TWO_BLOCKS_SMEM
    else:
        assert geo["threads"] == 512 and q == 16
        assert geo["smem"] > TWO_BLOCKS_SMEM
    min_cols = 16 if bf16 else 8
    for post in (1, min_cols - 1):
        assert model_geometry(n, post, bf16) is None
    for post in (min_cols, min_cols + 1, 241, 1000000):
        assert model_geometry(n, post, bf16) == geo
    if bf16 and n <= LONG_F32_ABOVE:
        assert cluster_geometry(n, 4096, False) is None
        assert model_geometry(n, 4096, False)["n1"] == SPLITS[n][0]


def cluster_walk(geo: dict) -> dict:
    """One unit through ``strided_cluster_kernel`` at geometry ``geo``, as
    its lanes index the tiles: per half warp of each instruction, the
    (block, position) and element (k1, c2, j3, c) of each active lane -
    pass 1's writes (block b's lines i = t + threads s of its run, line l =
    b M C / Q + i: u = l / C, c = l mod C, output k1 to block k1 / K at
    (k1 mod K, j2, j3, c)), pass 2's reads and in-place writes (lines w:
    c = w mod C, kk = (w / C) / N3, j3 = (w / C) mod N3, register j2) and
    pass 3's reads (lines v: kk = (v / C) / N2, k2 = (v / C) mod N2,
    register j3)."""
    n1, n2, n3, q = geo["n1"], geo["n2"], geo["n3"], geo["q"]
    C, TH = geo["cols"], geo["threads"]
    K, M = n1 // q, n2 * n3

    def pos(kk, c2, j3, c):
        return ((kk * n2 + c2) * n3 + j3) * C + c

    def halves(acc):
        out = []
        for h in range(0, TH, 16):
            part = [a for a in acc[h:h + 16] if a is not None]
            if part:
                out.append(part)
        return out

    walk = {"pass1": [], "pass2": [], "pass3": []}
    lines1, lines2, lines3 = M * C // q, K * n3 * C, K * n2 * C
    for b in range(q):
        for s in range(-(-lines1 // TH)):
            for k1 in range(n1):
                acc = []
                for t in range(TH):
                    i = t + TH * s
                    if i >= lines1:
                        acc.append(None)
                        continue
                    u, c = divmod(b * lines1 + i, C)
                    j2, j3 = divmod(u, n3)
                    acc.append(((k1 // K, pos(k1 % K, j2, j3, c)),
                                (k1, j2, j3, c)))
                walk["pass1"] += halves(acc)
        for s in range(-(-lines2 // TH)):
            for j2 in range(n2):
                acc = []
                for t in range(TH):
                    w = t + TH * s
                    if w >= lines2:
                        acc.append(None)
                        continue
                    r, c = divmod(w, C)
                    kk, j3 = divmod(r, n3)
                    acc.append(((b, pos(kk, j2, j3, c)),
                                (b * K + kk, j2, j3, c)))
                walk["pass2"] += halves(acc)
        for s in range(-(-lines3 // TH)):
            for j3 in range(n3):
                acc = []
                for t in range(TH):
                    v = t + TH * s
                    if v >= lines3:
                        acc.append(None)
                        continue
                    r, c = divmod(v, C)
                    kk, k2 = divmod(r, n2)
                    acc.append(((b, pos(kk, k2, j3, c)),
                                (b * K + kk, k2, j3, c)))
                walk["pass3"] += halves(acc)
    return walk


@pytest.mark.parametrize("n", sorted(CLUSTER))
def test_cluster_tile_walk(n):
    """One unit's tiles at every length of the cluster form: pass 1 writes
    every element (k1, j2, j3, c) once, into the tile of its owner k1 / K
    at a distinct position inside the owner's K M C values; pass 2 reads
    each element of its own rows from where it was written, once, and
    writes its output back in place; pass 3 reads every element of the
    block's rows once; every half warp of each pass reaches one block's
    tile (pass 1's remote writes go to one owner an instruction) and 16
    distinct bank pairs (8-byte values: position mod 16) among its active
    lanes, so no access meets a bank conflict."""
    geo = cluster_geometry(n, 4096, True)
    K, C = geo["n1"] // geo["q"], geo["cols"]
    walk = cluster_walk(geo)
    where = {}
    for half in walk["pass1"]:
        for (blk, p), e in half:
            assert e not in where and blk == e[0] // K
            assert 0 <= p < K * geo["n2"] * geo["n3"] * C
            where[e] = (blk, p)
    assert len(where) == n * C
    assert len(set(where.values())) == n * C
    for name in ("pass2", "pass3"):
        seen = set()
        for half in walk[name]:
            for at, e in half:
                assert where[e] == at and e not in seen
                seen.add(e)
        assert seen == set(where)
    for name, halves in walk.items():
        for half in halves:
            assert len({blk for (blk, _), _ in half}) == 1, (name, half)
            banks = {p % 16 for (_, p), _ in half}
            assert len(banks) == len(half), (name, half)

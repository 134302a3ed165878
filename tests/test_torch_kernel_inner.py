"""The strided-axis kernel's plain versions against tpufft's ``_build_inner``
(K2) and ``_build_inner_nd`` (K3, with and without ``with_tw``).

tpufft's Pallas kernels run in interpret mode on the CPU with
``precision="highest"``; the port runs ``inner_fft.fft_inner_reference`` /
``fft_inner_nd_reference`` (what ``fft_inner`` / ``fft_inner_nd`` run for
CPU tensors), on the same planes made from a numpy seed. Tolerances,
normalized by the spectrum's magnitude:

* 1e-5 for f32 storage: both sides compute in f32 with the same
  factorization and tables, and differ only in summation order;
* 8e-3 for bf16 storage, the ``profile="fast"`` bound in README.md: both
  sides round their f32 result to bf16 at the store.

The CUDA kernel itself needs the card: ``test_torch_cuda.py`` holds it
against these plain versions there. Here, a model of the kernel's line
form (``csrc/strided_line.cuh``) in torch, with its four-step split, lane
lines, output orders and table exponents, is held against tpufft in
interpret mode and against ``np.fft`` (1e-5), its tile mapping is checked
for every geometry, and ``inner_fft.form`` across n, post and dtype; a
model of the cluster form (``csrc/strided_long.cuh``), with its units,
block ownership, remote-write map, pass splits and table exponents, is
held against tpufft in interpret mode (1e-5 f32, 8e-3 bf16) and against
``np.fft`` at every length of its lists. The geometry comes from the model
in ``test_torch_strided_geometry.py``, which ``test_torch_cuda.py`` holds
against the library's on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import inner_fft, minor_fft

from test_torch_strided_geometry import (CLUSTER, FORM_CASES, LINE_NS,
                                         NEW_LINE_NS,
                                         SPLITS, cluster_geometry,
                                         model_geometry, use_model)
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

NS = [8, 93, 128, 256, 1024]
TOL = {"f32": 1e-5, "bf16": 8e-3}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
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


def _np(zr, zi):
    if isinstance(zr, torch.Tensor):
        return zr.float().numpy() + 1j * zi.float().numpy()
    return (np.asarray(zr.astype(jnp.float32))
            + 1j * np.asarray(zi.astype(jnp.float32)))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_inner_matches_build_inner(n, inverse, unit_scale, storage):
    """K2: the middle axis of a rank-3 (pre, n, L) array with L >= 32, the
    layout on which tpufft's ``fft_axis_pallas`` runs ``_build_inner``."""
    re, im = _planes((3, n, 40), seed=n)
    scale = 1.0 if unit_scale else 1.0 / n
    jdt, tdt = DTYPES[storage]
    ref = tp_mxu.fft_axis_pallas(
        jnp.asarray(re, jdt), jnp.asarray(im, jdt), 1, (), inverse=inverse,
        scale=scale, config=TP_CFG)
    got = inner_fft.fft_inner(torch.from_numpy(re).to(tdt),
                              torch.from_numpy(im).to(tdt),
                              inverse=inverse, scale=scale)
    assert got[0].dtype == tdt and ref[0].dtype == jdt
    assert _err(_np(*got), _np(*ref)) < TOL[storage]


def _two_pass_like_twiddle(n, M):
    """An (n, M) unit-modulus twiddle as the two-pass split makes it."""
    k = np.outer(np.arange(n), np.arange(M)).astype(np.float64)
    th = -2.0 * np.pi * k / (n * M)
    return np.cos(th), np.sin(th)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("with_tw", [False, True], ids=["plain", "with_tw"])
@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", NS)
def test_inner_nd_matches_build_inner_nd(n, inverse, unit_scale, with_tw,
                                         storage):
    """K3 on (pre*n, M, L) with a ragged M (5) and L (9)."""
    pre, M, L = 2, 5, 9
    re, im = _planes((pre * n, M, L), seed=n + 1)
    scale = 1.0 if unit_scale else 1.0 / n
    jdt, tdt = DTYPES[storage]
    run = tp_mxu._plan_inner_nd(n, inverse, scale, M, L, TP_CFG, True,
                                with_tw=with_tw, storage=storage)
    twc, tws = _two_pass_like_twiddle(n, M)
    if with_tw:
        ref = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt),
                  jnp.asarray(twc, jnp.float32), jnp.asarray(tws, jnp.float32))
        twiddle = torch.from_numpy(
            np.stack([twc, tws], -1).astype(np.float32))
    else:
        ref = run(jnp.asarray(re, jdt), jnp.asarray(im, jdt))
        twiddle = None
    got = inner_fft.fft_inner_nd(torch.from_numpy(re).to(tdt),
                                 torch.from_numpy(im).to(tdt), n=n,
                                 inverse=inverse, scale=scale,
                                 twiddle=twiddle)
    assert got[0].dtype == tdt and got[0].shape == (pre * n, M, L)
    assert _err(_np(*got), _np(*ref)) < TOL[storage]


def test_wrappers_cpu_run_plain_versions():
    re, im = _planes((2, 93, 33), seed=0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    inner_fft.reset_counts()
    got = inner_fft.fft_inner(xr, xi, inverse=False, scale=1.0)
    ref = inner_fft.fft_inner_reference(xr, xi, inverse=False, scale=1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = inner_fft.fft_inner_nd(xr.reshape(186, 3, 11),
                                 xi.reshape(186, 3, 11), n=93,
                                 inverse=True, scale=0.5)
    ref = inner_fft.fft_inner_nd_reference(xr.reshape(186, 3, 11),
                                           xi.reshape(186, 3, 11), n=93,
                                           inverse=True, scale=0.5)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert inner_fft.launches == {"inner": 0, "inner_nd": 0}
    assert inner_fft.reference_cuda_calls == 0


@pytest.mark.parametrize("call", [
    lambda x: inner_fft.fft_inner(x, x, inverse=False, scale=1.0),
    lambda x: inner_fft.fft_inner_nd(x, x, n=4, inverse=False, scale=1.0),
], ids=["inner", "inner_nd"])
def test_wrappers_refuse_non_cuda_devices(call):
    """A tensor that is not on the CPU launches the kernel or raises; it
    never runs the plain version."""
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.empty(2, 4, 8, device="meta"))


# ----------------------------------------------------------------------------
# The line form (csrc/strided_line.cuh): a model with the kernel's indexing
# ----------------------------------------------------------------------------

def _first_radix(n):
    """``first_radix``: 8 (4 at 16), 4, 2, then the smallest odd prime."""
    return (8 if n % 8 == 0 and n != 16 else 4 if n % 4 == 0
            else 2 if n % 2 == 0
            else next(p for p in range(3, n + 1, 2) if n % p == 0))


def _lane_out(n, r):
    """``lane_out<n>(r)``: the index in its line of register r."""
    if n == 1:
        return 0
    a = _first_radix(n)
    b = n // a
    return r // b + a * _lane_out(b, r % b)


def _radix_dft(t, a, inverse, w=None, kstep=0):
    """The radix-a butterfly over the last dim of a complex64 tensor: the
    kernel's radix-3 and radix-5 formulas with its f32 constants, an exact
    DFT matrix for 2, 4 and 8, and for an odd prime from 7 the
    conjugate-pair sum with W_a^k read from the n-table w at k kstep."""
    sg = -1.0 if inverse else 1.0
    if a == 3:
        s = np.float32(0.86602540378443864676) * sg
        x0, x1, x2 = t.unbind(-1)
        tt, d = x1 + x2, x1 - x2
        m = x0 - 0.5 * tt
        isd = torch.complex(s * d.imag, -s * d.real)      # -i s d
        return torch.stack([x0 + tt, m + isd, m - isd], -1)
    if a == 5:
        c1 = np.float32(0.30901699437494742410)
        c2 = np.float32(-0.80901699437494742410)
        s1 = np.float32(0.95105651629515357212) * sg
        s2 = np.float32(0.58778525229247312917) * sg
        x0, x1, x2, x3, x4 = t.unbind(-1)
        a1, d1, a2, d2 = x1 + x4, x1 - x4, x2 + x3, x2 - x3
        m1 = x0 + c1 * a1 + c2 * a2
        m2 = x0 + c2 * a1 + c1 * a2
        e1 = s1 * d1 + s2 * d2
        e2 = s2 * d1 - s1 * d2
        ie1 = torch.complex(e1.imag, -e1.real)            # -i e
        ie2 = torch.complex(e2.imag, -e2.real)
        return torch.stack([x0 + a1 + a2, m1 + ie1, m2 + ie2, m2 - ie2,
                            m1 - ie1], -1)
    if a % 2 and a >= 7:
        h = a // 2
        x0 = t[..., 0]
        sums = [t[..., b] + t[..., a - b] for b in range(1, h + 1)]
        diffs = [t[..., b] - t[..., a - b] for b in range(1, h + 1)]
        y = torch.empty_like(t)
        y[..., 0] = x0 + sum(sums)
        for j in range(1, h + 1):
            c, e = x0, torch.zeros_like(x0)
            for b in range(1, h + 1):
                wb = w[(j * b) % a * kstep]
                c = c + wb.real * sums[b - 1]
                e = e + wb.imag * diffs[b - 1]
            y[..., j], y[..., a - j] = c + 1j * e, c - 1j * e
        return y
    k = np.arange(a)
    m = np.exp((1j if inverse else -1j) * 2 * np.pi * np.outer(k, k) / a)
    m = np.round(m.real, 15) + 1j * np.round(m.imag, 15)
    return t @ torch.from_numpy(m.T.astype(np.complex64))


def _lane_dft(x, n, ktab, w, inverse):
    """``lane_dft<n, ktab>`` on the registers x (last dim, register order):
    radix-A butterflies over registers b + B a, times W_n^(a b) =
    w[a b ktab], then the B-long sub-lines; register q + B a ends holding
    X[lane_out(n, q + B a)]."""
    if n == 1:
        return x
    a = _first_radix(n)
    b = n // a
    y = x.reshape(*x.shape[:-1], a, b)                    # [a, b]
    y = _radix_dft(y.transpose(-1, -2), a, inverse, w,
                   ktab * b).transpose(-1, -2)
    ab = torch.outer(torch.arange(a), torch.arange(b))
    y = y * w[ab * ktab]
    return _lane_dft(y, b, ktab * a, w, inverse).reshape(x.shape)


def _pair_dft(x, ktab, w, inverse):
    """``pair_dft<M, ktab>`` on a line x of 2M = 36 to 64 (last dim,
    natural order): lane p transforms x[p + 2 i], the pair swaps, and
    register r of lane p ends holding X[pair_out(M, p, r)]; returns both
    lanes' registers, (..., 2, M)."""
    m = x.shape[-1] // 2
    h = m // 2
    f = [_lane_dft(x[..., p::2], m, 2 * ktab, w, inverse) for p in (0, 1)]
    lanes = []
    for p in (0, 1):
        regs = torch.arange(h) + h * p
        k = torch.tensor([_lane_out(m, int(r)) for r in regs])
        a, b = f[0][..., regs], f[1][..., regs] * w[k * ktab]
        lanes.append(torch.cat([a + b, a - b], -1))
    return torch.stack(lanes, -2)


def _pair_out(p, r, m=32):
    return _lane_out(m, r % (m // 2) + (m // 2) * p) + m * (r // (m // 2))


def _line_model(x, inverse, scale, twiddle=None):
    """The line form's arithmetic on a complex64 (pre, n, post) tensor,
    indexed as the kernels index it: one line a lane for n <= 32; else
    pass 1 over the N1-long column lines j2 (register j1 = x[N2 j1 + j2]),
    times w^(k1 j2) read at (k1 j2) mod n, pass 2 over the N2-long lines
    k1 (a 64-long one on a lane pair), X[k1 + N1 k2]; then ``twiddle``
    ((n, M) complex: output (k, c) times twiddle[k, c / (post / M)]) and
    the scale."""
    pre, n, post = x.shape
    n1, n2 = SPLITS[n]
    tab = minor_fft._device_twiddles(n, inverse, torch.device("cpu"))
    w = torch.complex(tab[:, 0], tab[:, 1])
    out = torch.empty(pre, post, n, dtype=torch.complex64)
    if n2 == 1:
        v = _lane_dft(x.transpose(1, 2), n, 1, w, inverse)
        out[..., [_lane_out(n, q) for q in range(n)]] = v
    else:
        xv = x.reshape(pre, n1, n2, post).permute(0, 3, 2, 1)  # [c, j2, j1]
        v = _lane_dft(xv, n1, n2, w, inverse)                  # [c, j2, q]
        k1 = torch.tensor([_lane_out(n1, q) for q in range(n1)])
        y = torch.empty(pre, post, n1, n2, dtype=torch.complex64)
        y[:, :, k1, :] = v.transpose(-1, -2)                   # [c, k1, j2]
        y = y * w[(torch.outer(torch.arange(n1), torch.arange(n2))) % n]
        if n2 > 32:
            m = n2 // 2
            v2 = _pair_dft(y, n1, w, inverse)                  # [c, k1, p, r]
            k2 = [[_pair_out(p, r, m) for r in range(m)] for p in (0, 1)]
            for p in (0, 1):
                for r in range(m):
                    out[..., n1 * k2[p][r] + torch.arange(n1)] = v2[..., p, r]
        else:
            v2 = _lane_dft(y, n2, n1, w, inverse)              # [c, k1, q]
            for q in range(n2):
                out[..., n1 * _lane_out(n2, q) + torch.arange(n1)] = \
                    v2[..., q]
    out = out.transpose(1, 2)                                  # (pre, n, post)
    if twiddle is not None:
        tw = torch.complex(twiddle[..., 0], twiddle[..., 1])
        out = out * tw.repeat_interleave(post // tw.shape[1], dim=1)
    return out * scale


@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [64, 96, 128, 640] + NEW_LINE_NS)
def test_line_model_matches_build_inner(n, inverse, unit_scale):
    """The line form's four-step (``SPLITS``), its lane lines (radix 3, 5
    and the conjugate-pair sum of 31 among them; pairs of 36 and 64) with
    their output order and the table exponents (k1 j2) mod n, against
    tpufft's ``_build_inner`` in interpret mode on a (3, n, 40) array, at
    the r = 1, 3, 5 lengths it was written for and at every length of a
    15, 25 or 31 factor."""
    re, im = _planes((3, n, 40), seed=n + 5)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = tp_mxu.fft_axis_pallas(
        jnp.asarray(re), jnp.asarray(im), 1, (), inverse=inverse,
        scale=scale, config=TP_CFG)
    got = _line_model(torch.complex(torch.from_numpy(re),
                                    torch.from_numpy(im)), inverse, scale)
    assert _err(got.numpy(), _np(*ref)) < 1e-5


@pytest.mark.parametrize("with_tw", [False, True], ids=["plain", "with_tw"])
@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_line_model_matches_build_inner_nd(inverse, unit_scale, with_tw):
    """The model with ``tw_nm`` at the store against tpufft's
    ``_build_inner_nd`` (``with_tw``) at n = 128 on (2 * 128, 5, 9)."""
    n, pre, M, L = 128, 2, 5, 9
    re, im = _planes((pre * n, M, L), seed=11)
    scale = 1.0 if unit_scale else 1.0 / n
    run = tp_mxu._plan_inner_nd(n, inverse, scale, M, L, TP_CFG, True,
                                with_tw=with_tw, storage="f32")
    twc, tws = _two_pass_like_twiddle(n, M)
    if with_tw:
        ref = run(jnp.asarray(re), jnp.asarray(im),
                  jnp.asarray(twc, jnp.float32), jnp.asarray(tws, jnp.float32))
        twiddle = torch.from_numpy(np.stack([twc, tws], -1).astype(np.float32))
    else:
        ref = run(jnp.asarray(re), jnp.asarray(im))
        twiddle = None
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    got = _line_model(x.reshape(pre, n, M * L), inverse, scale, twiddle)
    assert _err(got.reshape(pre * n, M, L).numpy(), _np(*ref)) < 1e-5


@pytest.mark.parametrize("unit_scale", [True, False], ids=["scale1", "scale1/n"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 64), (3, 8, 64),
                                   (2, 128, 4, 64), (2, 128, 64)],
                         ids=["inner", "inner_m1", "inner_128",
                              "inner_m1_128"])
def test_line_model_matches_build_inner_fused(shape, unit_scale):
    """The model on fused storage, (pre, n, M, 2L) read as the (pre, n,
    M L) logical planes, against tpufft's ``_build_inner_fused`` (M > 1)
    and ``_build_inner_fused_m1`` (M = 1) in interpret mode."""
    n = shape[1]
    re, im = _planes(shape, seed=sum(shape))
    st = np.concatenate([re, im], -1)
    scale = 1.0 if unit_scale else 1.0 / n
    ref = np.asarray(tp_mxu.fft_axis_fused_pallas(
        jnp.asarray(st), 1, inverse=False, scale=scale,
        config=TPPlanConfig(interpret=True, backend="pallas",
                            precision="highest")))
    h = shape[-1]
    view = (shape[0], n, -1)
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    got = _line_model(x.reshape(view), False, scale).reshape(shape)
    assert _err(got.numpy(), ref[..., :h] + 1j * ref[..., h:]) < 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [1024, 1280, 1536, 2048])
def test_line_model_matches_numpy(n, inverse):
    """The long lengths (lane pairs at 1280, 1536 and 2048) against
    ``np.fft`` in float64 on a (2, n, 9) array."""
    re, im = _planes((2, n, 9), seed=n)
    x = re.astype(np.float64) + 1j * im
    ref = np.fft.ifft(x, axis=1) * n if inverse else np.fft.fft(x, axis=1)
    got = _line_model(torch.complex(torch.from_numpy(re),
                                    torch.from_numpy(im)), inverse, 1.0)
    assert _err(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("n", LINE_NS)
def test_line_model_every_length(n):
    """Every length of the form, forward, against ``np.fft``."""
    re, im = _planes((2, n, 3), seed=n + 1)
    ref = np.fft.fft(re.astype(np.float64) + 1j * im, axis=1)
    got = _line_model(torch.complex(torch.from_numpy(re),
                                    torch.from_numpy(im)), False, 1.0)
    assert _err(got.numpy(), ref) < 1e-5


def _tile_accesses(geo):
    """Per half warp of each instruction of one unit, the tile positions
    (float2) and the elements (c, k1, j2) that the active lanes of
    ``strided_lane_kernel`` write in pass 1 and read in pass 2 (rounds of
    t + blockDim s, or for an N2 of 34 to 64 the pair (t mod 16) + 16 (t /
    32) + blockDim / 2 s), a half warp with no active lane left out; and
    whether every half warp was wholly active or idle. Positions ((k1 N2 +
    (j2 ^ (k1 & 1))) C + c) for an even N2, ((k1 N2 + j2) C + c) for an
    odd one."""
    n1, n2, cols, lanes = geo["n1"], geo["n2"], geo["cols"], geo["threads"]
    whole = True

    def pos(c, k1, j2):
        if n2 % 2:
            return (k1 * n2 + j2) * cols + c
        return (k1 * n2 + (j2 ^ (k1 & 1))) * cols + c

    def halves(acc):
        nonlocal whole
        out = []
        for h in range(0, lanes, 16):
            part = [a for a in acc[h:h + 16] if a is not None]
            whole = whole and len(part) in (0, 16)
            out.append(part or None)
        return out

    writes, reads = [], []
    for s in range(-(-32 // n1)):
        for q in range(n1):
            acc = []
            for t in range(lanes):
                line = t + lanes * s
                if line >= cols * n2:
                    acc.append(None)
                    continue
                c, j2 = line % cols, line // cols
                k1 = _lane_out(n1, q)
                acc.append((pos(c, k1, j2), (c, k1, j2)))
            writes += halves(acc)
    if n2 > 32:
        m = n2 // 2
        for s in range(-(-64 // n2)):
            for i in range(m):
                acc = []
                for t in range(lanes):
                    line = (t & 15) + 16 * (t >> 5) + (lanes // 2) * s
                    p = (t >> 4) & 1
                    if line >= cols * n1:
                        acc.append(None)
                        continue
                    c, k1 = line % cols, line // cols
                    acc.append((pos(c, k1, p + 2 * i), (c, k1, p + 2 * i)))
                reads += halves(acc)
    else:
        for s in range(-(-32 // n2)):
            for j in range(n2):
                acc = []
                for t in range(lanes):
                    line = t + lanes * s
                    if line >= cols * n1:
                        acc.append(None)
                        continue
                    c, k1 = line % cols, line // cols
                    acc.append((pos(c, k1, j), (c, k1, j)))
                reads += halves(acc)
    return ([h for h in writes if h is not None],
            [h for h in reads if h is not None], whole)


LINE_GEOMETRIES = [(n, c) for n in LINE_NS for c in (8, 16, 32)
                   if SPLITS[n][1] > 1 and model_geometry(n, 4096, False, c)]


@pytest.mark.parametrize("n,cols", LINE_GEOMETRIES)
def test_line_tile_mapping(n, cols):
    """One unit's tile: pass 1 writes every element (c, k1, j2) of its C
    columns once, at a distinct position inside the C n tile; pass 2 reads
    each back from the position it was written to; the active lanes of
    each half warp of both passes touch distinct bank pairs (8-byte values:
    position mod 16), 16 of them where the half warp is wholly active, so
    the tile has no bank conflict. Every half warp is wholly active or
    idle at the r = 1, 3, 5 lengths; the lengths of a 15, 25 or 31 factor
    (rounds of C N2 lines that are no multiple of 16 at C = 8) may leave
    one half warp of a round partly active."""
    geo = model_geometry(n, 4096, False, cols)
    assert geo["threads"] % 32 == 0 and geo["threads"] >= cols * n / 32
    writes, reads, whole = _tile_accesses(geo)
    assert whole or n in NEW_LINE_NS
    where = {}
    for half in writes:
        for p, e in half:
            assert e not in where
            where[e] = p
    assert len(where) == cols * n
    assert sorted(where.values()) == list(range(cols * n))
    seen = set()
    for half in reads:
        for p, e in half:
            assert where[e] == p and e not in seen
            seen.add(e)
    assert seen == set(where)
    for half in writes + reads:
        assert len({p % 16 for p, _ in half}) == len(half), (n, cols, half)
        assert len(half) == 16 or not whole


@pytest.mark.parametrize("n,post,dtype,expected", FORM_CASES)
def test_form(n, post, dtype, expected, monkeypatch):
    """The form each launch runs: n = r 2^a, r in {1, 3, 5}, 8 to 2048, on
    at least 8 f32 or 16 bf16 columns (bf16 up to n = 1024, where 16
    columns stay within 512 lanes) runs the line form, and the cluster
    form's lists (f32 from 2160, bf16 from 1080) its cluster form, both
    ``"lines"``; the rest of the envelope the stage form; the line form's
    geometry narrows C to post, the cluster form's units are 16 columns.
    The library's geometry query is answered by the model
    (``use_model``)."""
    use_model(monkeypatch)
    assert inner_fft.form(n, post, dtype) == expected
    geo = inner_fft.line_geometry(n, post, dtype)
    assert (geo is not None) == (expected == "lines")
    if geo:
        assert geo["n1"] * geo["n2"] * geo.get("n3", 1) == n
        assert geo["cols"] >= (16 if dtype == torch.bfloat16 else 8)
        if "q" in geo:   # the cluster form: units of 16 columns
            assert geo["cols"] == 16
        else:
            assert geo["cols"] <= max(
                post, 16 if dtype == torch.bfloat16 else 8)


# ----------------------------------------------------------------------------
# The cluster form (csrc/strided_long.cuh): a model with the kernel's indexing
# ----------------------------------------------------------------------------

def _cluster_model(x, inverse, scale, twiddle=None):
    """The cluster form's arithmetic on a complex64 (pre, n, post) tensor,
    indexed as ``strided_cluster_kernel`` indexes it (one geometry a
    length, f32 and bf16 alike): units of C = 16 columns of one slice
    (zeros past post); block b's pass-1 lines l = b M C / Q + i (u = l / C,
    c = l mod C, u = N3 j2 + j3) load x[M j1 + u, c], run the N1-long lane
    line (table stride n / N1) and write output k1, times A[k1][j2]
    B[k1][j3] = w^(k1 N3 j2) w^(k1 j3), into the tile of block k1 / K at
    ((k1 mod K) N2 + j2) N3 + j3) C + c (the tiles start as NaN, so a read
    of an unwritten slot shows); pass 2 over each block's lines (kk, j3,
    c), in place, times C[k2][j3] = w^(N1 k2 j3); pass 3 over its lines
    (kk, k2, c) to X[b K + kk + N1 (k2 + N2 k3), c]; then ``twiddle`` and
    the scale."""
    pre, n, post = x.shape
    geo = cluster_geometry(n, 1 << 20, True)
    n1, n2, n3, q, C = (geo[k] for k in ("n1", "n2", "n3", "q", "cols"))
    K, M = n1 // q, n2 * n3

    def pos(kk, c2, j3, c):
        return ((kk * n2 + c2) * n3 + j3) * C + c

    tab = minor_fft._device_twiddles(n, inverse, torch.device("cpu"))
    w = torch.complex(tab[:, 0], tab[:, 1])
    groups = -(-post // C)
    xp = torch.zeros(pre, n, groups * C, dtype=torch.complex64)
    xp[..., :post] = x
    xu = xp.reshape(pre, n, groups, C).permute(0, 2, 1, 3).reshape(-1, n, C)
    units = xu.shape[0]
    ta = w[torch.outer(torch.arange(n1), torch.arange(n2)) * n3]
    tb = w[torch.outer(torch.arange(n1), torch.arange(n3))]
    tc = w[torch.outer(torch.arange(n2), torch.arange(n3)) * n1]
    nan = complex(float("nan"), float("nan"))
    tiles = torch.full((units, q, K * M * C), nan, dtype=torch.complex64)
    lines1 = M * C // q
    for b in range(q):                                     # pass 1
        line = b * lines1 + torch.arange(lines1)
        u, c = line // C, line % C
        j2, j3 = u // n3, u % n3
        rows = (M * torch.arange(n1))[None, :] + u[:, None]
        v = _lane_dft(xu[:, rows, c[:, None]], n1, n // n1, w, inverse)
        for r in range(n1):
            k1 = _lane_out(n1, r)
            y = v[..., r] * (ta[k1, j2] * tb[k1, j3]) if k1 else v[..., r]
            tiles[:, k1 // K, pos(k1 % K, j2, j3, c)] = y
    out = torch.empty(units, n, C, dtype=torch.complex64)
    for b in range(q):
        line = torch.arange(K * n3 * C)                    # pass 2
        c, kk, j3 = line % C, line // C // n3, line // C % n3
        at = [pos(kk, j, j3, c) for j in range(n2)]
        v = _lane_dft(torch.stack([tiles[:, b, a] for a in at], -1), n2,
                      n // n2, w, inverse)
        for r in range(n2):
            k2 = _lane_out(n2, r)
            y = v[..., r] * tc[k2, j3] if k2 else v[..., r]
            tiles[:, b, at[k2]] = y
        line = torch.arange(K * n2 * C)                    # pass 3
        c, kk, k2 = line % C, line // C // n2, line // C % n2
        v = torch.stack([tiles[:, b, pos(kk, k2, j, c)] for j in range(n3)],
                        -1)
        v = _lane_dft(v, n3, n // n3, w, inverse)
        for r in range(n3):
            k = b * K + kk + n1 * (k2 + n2 * _lane_out(n3, r))
            out[:, k, c] = v[..., r]
    out = out.reshape(pre, groups, n, C).permute(0, 2, 1, 3)
    out = out.reshape(pre, n, groups * C)[..., :post]
    if twiddle is not None:
        tw = torch.complex(twiddle[..., 0], twiddle[..., 1])
        out = out * tw.repeat_interleave(post // tw.shape[1], dim=1)
    return out * scale


def _stored(z, storage):
    """The model's output rounded to the storage dtype, as the kernel's
    store rounds it."""
    if storage == "f32":
        return z.numpy()
    return (z.real.to(torch.bfloat16).float().numpy()
            + 1j * z.imag.to(torch.bfloat16).float().numpy())


CLUSTER_TP_NS = [3840, 4096, 8320]


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", CLUSTER_TP_NS)
def test_cluster_model_matches_build_inner(n, inverse, storage):
    """K2 on the cluster form: the model (on the planes rounded to the
    storage) against tpufft's ``_build_inner`` in interpret mode on a (1,
    n, 20) array (two units of 16 columns, the second ragged); scale 1
    forward, 1/n inverse."""
    re, im = _planes((1, n, 20), seed=n + 7)
    scale = 1.0 / n if inverse else 1.0
    jdt, tdt = DTYPES[storage]
    ref = tp_mxu.fft_axis_pallas(
        jnp.asarray(re, jdt), jnp.asarray(im, jdt), 1, (), inverse=inverse,
        scale=scale, config=TP_CFG)
    x = torch.complex(torch.from_numpy(re).to(tdt).float(),
                      torch.from_numpy(im).to(tdt).float())
    got = _cluster_model(x, inverse, scale)
    assert _err(_stored(got, storage), _np(*ref)) < TOL[storage]


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("with_tw", [False, True], ids=["plain", "with_tw"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", CLUSTER_TP_NS)
def test_cluster_model_matches_build_inner_nd(n, inverse, with_tw, storage):
    """K3 on the cluster form, with and without ``tw_nm`` at the store, on
    (n, 5, 4) (post 20, the twiddle's (n, 5) columns four wide). tpufft's
    ``_plan_inner_nd`` plans no kernel at these lengths (their only
    factorization is its Kronecker four-step, which its rank-3 tiles
    lack: it returns None, and tpufft's two-pass falls back to its flat
    form), so the reference is what tpufft runs on the same memory: its
    ``_build_inner`` (``fft_axis_pallas``) on the (1, n, 20) view in
    interpret mode at scale 1, then the twiddle and the scale in float64,
    rounded once to the storage dtype."""
    M, L = 5, 4
    re, im = _planes((n, M, L), seed=n + 9)
    scale = 1.0 / n if inverse else 1.0
    jdt, tdt = DTYPES[storage]
    assert tp_mxu._plan_inner_nd(n, inverse, scale, M, L, TP_CFG, True,
                                 with_tw=with_tw, storage=storage) is None
    ref = tp_mxu.fft_axis_pallas(
        jnp.asarray(re.reshape(1, n, M * L), jdt),
        jnp.asarray(im.reshape(1, n, M * L), jdt), 1, (), inverse=inverse,
        scale=1.0, config=TP_CFG)
    ref = _np(*ref).reshape(n, M, L)
    twc, tws = _two_pass_like_twiddle(n, M)
    twiddle = None
    if with_tw:
        twiddle = torch.from_numpy(np.stack([twc, tws], -1).astype(np.float32))
        ref = ref * (twc + 1j * tws)[:, :, None]
    ref = _stored(torch.from_numpy((ref * scale).astype(np.complex64)),
                  storage)
    x = torch.complex(torch.from_numpy(re).to(tdt).float(),
                      torch.from_numpy(im).to(tdt).float())
    got = _cluster_model(x.reshape(1, n, M * L), inverse, scale, twiddle)
    assert _err(_stored(got, storage).reshape(n, M, L), ref) < TOL[storage]


@pytest.mark.parametrize("n", sorted(CLUSTER))
def test_cluster_model_matches_numpy(n):
    """Every length of the cluster form (one geometry a length, f32 and
    bf16 alike), computed in f32 on f32 planes of two units (the second
    ragged), forward and inverse, against ``np.fft`` in float64."""
    re, im = _planes((1, n, 19), seed=n + 3)
    x = re.astype(np.float64) + 1j * im
    xt = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    for inverse, ref in ((False, np.fft.fft(x, axis=1)),
                         (True, np.fft.ifft(x, axis=1) * n)):
        got = _cluster_model(xt, inverse, 1.0)
        assert _err(got.numpy(), ref) < 1e-5

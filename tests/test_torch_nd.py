"""The port's ND, two-pass and Bluestein paths against tpufft's, on the same
inputs.

Both packages get the same numpy arrays made from a seed. tpufft runs its
Pallas kernels in interpret mode on the CPU with ``precision="highest"``;
the port runs its kernels' plain versions (CPU tensors). Tolerances,
normalized by the spectrum's magnitude:

* c64 ND plans: 1e-5, both sides compute in f32 and differ in summation
  order;
* two-pass and Bluestein, c64: 1e-4, for the extra f32 passes and the
  chirp's f32 rounding;
* bf16 planes: 8e-3, the README's fast-profile bound;
* c128: 1e-10, the torch-op Stockham against tpufft's x64 path;
* gradients: 1e-5 of the gradient's magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpufft
from tpufft import PlanConfig as TPPlanConfig
from tpufft import SplitComplex as TPSplit

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex, execute
from tpufft_torch.convert import plan_from_fields
from tpufft_torch.kernels import (cube_fft, inner_fft, mid_pair_fft,
                                  minor_fft, pair_fft)
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")
TP_AUTO = dataclasses.replace(TP_CFG, backend="auto")
CFGS = {"pallas": (TP_CFG, PlanConfig(**dataclasses.asdict(TP_CFG))),
        "auto": (TP_AUTO, PlanConfig(**dataclasses.asdict(TP_AUTO)))}


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _complex(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


ND_CASES = [
    ((4, 16, 24), None, "fftn"),
    ((4, 16, 24), (0, 1), "ifftn"),
    ((4, 16, 24), (0, 2), "fftn"),
    ((4, 16, 24), (2, 1), "ifftn"),
    ((3, 8, 12, 40), (1, 2, 3), "fftn"),
    ((3, 8, 12, 40), (0, 2), "ifftn"),
    ((3, 8, 12, 40), None, "ifftn"),
    ((2, 3, 4, 8, 16), (1, 3, 4), "ifftn"),
    ((2, 3, 4, 8, 16), (0, 1, 2), "fftn"),
    ((2, 3, 4, 8, 16), None, "fftn"),
]


@pytest.mark.parametrize("shape,axes,fn", ND_CASES)
def test_fftn_matches_tpufft(shape, axes, fn):
    x = _complex(shape, seed=sum(shape))
    tp_cfg, cfg = CFGS["pallas"]
    ref = getattr(tpufft, fn)(x, axes=axes, config=tp_cfg)
    got = getattr(tpufft_torch, fn)(x, axes=axes, config=cfg, device="cpu")
    assert _err(got, ref) < 1e-5
    np_ref = getattr(np.fft, fn)(x.astype(np.complex128), axes=axes)
    assert _err(got, np_ref) < 1e-5


@pytest.mark.parametrize("fn", ["fft2", "ifft2"])
@pytest.mark.parametrize("shape", [(5, 64, 64), (2, 3, 8, 93), (160, 48)])
def test_fft2_matches_tpufft(shape, fn):
    x = _complex(shape, seed=7)
    tp_cfg, cfg = CFGS["pallas"]
    assert _err(getattr(tpufft_torch, fn)(x, config=cfg, device="cpu"),
                getattr(tpufft, fn)(x, config=tp_cfg)) < 1e-5


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_nd_norms(norm, inverse):
    x = _complex((3, 20, 24), seed=3)
    fn = "ifftn" if inverse else "fftn"
    tp_cfg, cfg = CFGS["pallas"]
    ref = getattr(tpufft, fn)(x, norm=norm, config=tp_cfg)
    got = getattr(tpufft_torch, fn)(x, norm=norm, config=cfg, device="cpu")
    assert _err(got, ref) < 1e-5
    assert _err(got, getattr(np.fft, fn)(x.astype(np.complex128),
                                         norm=norm)) < 1e-5


@pytest.mark.parametrize("s,axes", [((20, 30), (1, 2)),
                                    ((3, 8, 16), None),
                                    (("fast", "fast-aligned"), (1, 2)),
                                    ((40, 10), (0, 1))])
def test_nd_crop_pad(s, axes):
    x = _complex((4, 16, 24), seed=5)
    tp_cfg, cfg = CFGS["pallas"]
    ref = tpufft.fftn(x, s=s, axes=axes, config=tp_cfg)
    got = tpufft_torch.fftn(x, s=s, axes=axes, config=cfg, device="cpu")
    assert _err(got, ref) < 1e-5


def test_nd_real_input():
    x = np.random.default_rng(9).standard_normal((3, 24, 40)).astype(
        np.float32)
    tp_cfg, cfg = CFGS["pallas"]
    got = tpufft_torch.fftn(torch.from_numpy(x), config=cfg)
    assert got.is_complex()
    assert _err(got.numpy(), tpufft.fftn(x, config=tp_cfg)) < 1e-5


def test_nd_c128_stockham():
    x = _complex((3, 12, 20), seed=2, dtype=np.complex128)
    ref = tpufft.fftn(x, config=TP_AUTO)
    got = tpufft_torch.fftn(x, config=CFGS["auto"][1], device="cpu")
    assert got.dtype == np.complex128 and _err(got, ref) < 1e-10


def test_nd_bf16_planes():
    x = _complex((4, 32, 48), seed=4)
    tp_cfg = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                          profile="fast")
    cfg = PlanConfig(**dataclasses.asdict(tp_cfg))
    ref = tpufft.fftn(x, config=tp_cfg)
    out = tpufft_torch.fftn(
        SplitComplex(torch.from_numpy(x.real.copy()),
                     torch.from_numpy(x.imag.copy())), config=cfg)
    assert out.dtype == torch.bfloat16
    assert _err(out.numpy(), ref) < 8e-3


def _port_plan(tp_plan):
    return plan_from_fields(
        tp_plan.shape, tp_plan.dtype, tp_plan.axes, tp_plan.lengths,
        tp_plan.bases, tp_plan.inverse, tp_plan.norm, tp_plan.kind,
        dataclasses.asdict(tp_plan.config), device="cpu")


@pytest.mark.parametrize("shape,axes,inverse,norm", [
    ((3, 16, 24), (1, 2), False, "ortho"),       # the pair (_FFTPair)
    ((3, 16, 24), None, True, None),             # strided + pair
    ((4, 40, 6), (0, 1), False, "forward"),      # strided, post 6 and 240
])
def test_nd_grad_matches_jax(shape, axes, inverse, norm):
    rng = np.random.default_rng(11)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes,
                              inverse=inverse, norm=norm, config=TP_CFG)

    def loss(a, b):
        out = tp_plan(TPSplit(a, b))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    xr = torch.tensor(re, requires_grad=True)
    xi = torch.tensor(im, requires_grad=True)
    out = _port_plan(tp_plan)(SplitComplex(xr, xi))
    (torch.sum(out.re ** 2) + 2.0 * torch.sum(out.im ** 2)).backward()
    for got, want in ((xr.grad, ref[0]), (xi.grad, ref[1])):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 1e-5


def test_pair_grad_real_input():
    x = np.random.default_rng(12).standard_normal((2, 8, 93)).astype(
        np.float32)

    def loss(v):
        out = tpufft.fft2(v, config=TP_CFG)
        return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = tpufft_torch.fft2(xt, config=CFGS["pallas"][1])
    (torch.sum(out.real ** 2) + 2.0 * torch.sum(out.imag ** 2)).backward()
    assert np.max(np.abs(xt.grad.numpy() - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("fn", ["fft", "ifft"])
@pytest.mark.parametrize("n", [32768, 49152, 131, 1031, 4099])
def test_long_and_prime_lengths(n, fn, backend):
    """Two-pass split (32768, 49152) and Bluestein (131 under "pallas";
    1031 and 4099, prime factors above 1024, under both backends)."""
    x = _complex((2, n), seed=n)
    tp_cfg, cfg = CFGS[backend]
    got = getattr(tpufft_torch, fn)(x, config=cfg, device="cpu")
    assert _err(got, getattr(tpufft, fn)(x, config=tp_cfg)) < 1e-4
    assert _err(got, getattr(np.fft, fn)(x.astype(np.complex128))) < 1e-4


@pytest.mark.parametrize("shape,axis", [((2, 32768, 3), 1),
                                        ((3, 1031, 40), 1),
                                        ((2, 4099, 33), 1)])
def test_long_and_prime_strided_axes(shape, axis):
    x = _complex(shape, seed=1)
    tp_cfg, cfg = CFGS["pallas"]
    got = tpufft_torch.fft(x, axis=axis, config=cfg, device="cpu")
    assert _err(got, tpufft.fft(x, axis=axis, config=tp_cfg)) < 1e-4
    assert _err(got, np.fft.fft(x.astype(np.complex128), axis=axis)) < 1e-4


def test_long_and_prime_bf16_planes():
    """bf16 planes stay bf16 through the two-pass and Bluestein."""
    cfg = PlanConfig(backend="pallas", plane_dtype="bfloat16")
    for n in (32768, 131):
        x = _complex((2, n), seed=n)
        out = tpufft_torch.fft(SplitComplex(
            torch.from_numpy(x.real.copy()).bfloat16(),
            torch.from_numpy(x.imag.copy()).bfloat16()), config=cfg)
        assert out.dtype == torch.bfloat16
        assert _err(out.numpy(), np.fft.fft(x.astype(np.complex128))) < 8e-3


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [32768, 131, 1031])
def test_pallas_backend_long_and_prime_lengths(n, inverse):
    """backend="pallas" serves a length beyond the single-pass envelope
    (two-pass) and prime lengths above 127 (Bluestein), as tpufft does;
    the port used to raise ValueError here."""
    x = _complex((2, n), seed=n + 1)
    tp_cfg = TPPlanConfig(interpret=True, backend="pallas",
                          precision="highest")
    cfg = PlanConfig(**dataclasses.asdict(tp_cfg))
    fn = "ifft" if inverse else "fft"
    ref = getattr(tpufft, fn)(x, config=tp_cfg)
    got = getattr(tpufft_torch, fn)(x, config=cfg, device="cpu")
    assert _err(got, ref) < 1e-4


def test_pallas_backend_still_raises_for_f64():
    x = _complex((2, 131), seed=0, dtype=np.complex128)
    with pytest.raises(ValueError, match="not supported by the fused kernel"):
        tpufft_torch.fft(x, config=PlanConfig(backend="pallas"), device="cpu")


@pytest.fixture
def spies(monkeypatch):
    """Which wrapper each call reached, with the planes' shape, and every
    ``movedim`` (the CPU plain versions of the strided and pair kernels
    use transposes, so only a route's ``movedim`` shows)."""
    calls = []

    def spy(name, fn):
        def wrapped(xr, xi, **kw):
            calls.append((name, tuple(xr.shape)))
            return fn(xr, xi, **kw)
        return wrapped

    for mod, name in ((minor_fft, "fft_minor"), (inner_fft, "fft_inner"),
                      (inner_fft, "fft_inner_nd"), (pair_fft, "fft_pair"),
                      (cube_fft, "fft_cube"),
                      (mid_pair_fft, "fft_mid_pair")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    real_movedim = torch.Tensor.movedim

    def movedim(self, *args):
        calls.append(("movedim", tuple(self.shape)))
        return real_movedim(self, *args)

    monkeypatch.setattr(torch.Tensor, "movedim", movedim)
    real_two_pass = execute._fft_axis_two_pass

    def two_pass(ar, ai, axis, a, b, **kw):
        calls.append(("two_pass", (a, b)))
        return real_two_pass(ar, ai, axis, a, b, **kw)

    monkeypatch.setattr(execute, "_fft_axis_two_pass", two_pass)
    return calls


def test_dispatch_strided_axes(spies):
    """A non-minor axis reaches the strided wrappers on its own layout:
    K2 with one trailing dim, K3 with several; no movedim."""
    tpufft_torch.fft(_complex((3, 40, 50), seed=0), axis=1, device="cpu")
    tpufft_torch.fft(_complex((3, 40, 5, 10), seed=0), axis=1, device="cpu")
    assert spies == [("fft_inner", (3, 40, 50)),
                     ("fft_inner_nd", (120, 5, 10))]


def test_dispatch_short_post_stays_strided(spies):
    """Unlike tpufft (post < 32 moves the axis minor), a short trailing
    product also runs on the strided kernel, in place."""
    tpufft_torch.fft(_complex((3, 40, 2), seed=0), axis=1, device="cpu")
    tpufft_torch.fft(_complex((130, 24), seed=0), axis=0, device="cpu")
    assert spies == [("fft_inner", (3, 40, 2)), ("fft_inner", (1, 130, 24))]


def test_dispatch_pair_last(spies):
    """A fitting trailing pair reaches the pair wrapper; the leading axis
    the strided wrapper; a pair over the envelope runs axis by axis. (A
    3-D ``fftn`` inside the cube kernel's envelope takes the cube instead:
    ``test_dispatch_cube_last``; (3, 128, 128) is outside it.)"""
    tpufft_torch.fftn(_complex((3, 128, 128), seed=0), device="cpu")
    assert spies == [("fft_inner_nd", (3, 128, 128)),
                     ("fft_pair", (3, 128, 128))]
    spies.clear()
    tpufft_torch.fft2(_complex((2, 128, 160), seed=0), device="cpu")
    assert spies == [("fft_inner", (2, 128, 160)),
                     ("fft_minor", (256, 160))]


def test_dispatch_two_pass_and_bluestein(spies):
    """The two-pass split is two strided passes: K3 with the twiddle and
    the swapped store, then K2 on the swapped planes; no K1, no movedim."""
    tpufft_torch.fft(_complex((2, 32768), seed=0), device="cpu")
    assert spies == [("two_pass", (1024, 32)),
                     ("fft_inner_nd", (2048, 32, 1)),
                     ("fft_inner", (2, 32, 1024))]
    spies.clear()
    tpufft_torch.fft(_complex((2, 4099), seed=0), device="cpu")
    # Bluestein moves its axis minor as tpufft does (a no-op here)
    assert [c for c in spies if c[0] != "movedim"] == [
        ("fft_minor", (2, 8320)), ("fft_minor", (2, 8320))]


# ----------------------------------------------------------------------------
# The trailing cube (K5) and the middle pair (K6)
# ----------------------------------------------------------------------------

def test_dispatch_cube_last(spies):
    """A trailing cube inside K5's envelope reaches the cube wrapper once,
    after the leading axis; a length-1 leading axis that takes no scale is
    skipped; a cube inside tpufft's gate but outside K5's envelope (more
    than a cluster's shared memory) keeps the pair and the strided axis."""
    tpufft_torch.fftn(_complex((3, 16, 32, 64), seed=0), axes=(1, 2, 3),
                      device="cpu")
    assert spies == [("fft_cube", (3, 16, 32, 64))]
    spies.clear()
    tpufft_torch.fftn(_complex((1, 2, 16, 32, 64), seed=0), device="cpu")
    assert spies == [("fft_inner_nd", (2, 512, 64)),
                     ("fft_cube", (2, 16, 32, 64))]
    spies.clear()
    assert not cube_fft.supported(128, 128, 64, torch.float32)
    tpufft_torch.fftn(_complex((1, 128, 128, 64), seed=0), axes=(1, 2, 3),
                      device="cpu")
    assert spies == [("fft_inner_nd", (128, 128, 64)),
                     ("fft_pair", (128, 128, 64))]


def test_dispatch_mid_pair(spies):
    """Two adjacent middle axes in front of the minor one reach the
    mid-pair wrapper once on the (pre, n1, n2, L) view; below
    ``MID_PAIR_MIN_L`` (or outside K6's envelope) they run one strided
    pass each."""
    tpufft_torch.fftn(_complex((2, 8, 16, 128), seed=0), axes=(1, 2),
                      device="cpu")
    assert spies == [("fft_mid_pair", (2, 8, 16, 128))]
    spies.clear()
    short = execute.MID_PAIR_MIN_L - 1
    assert short >= 1 and not execute.mid_pair_ok(
        8, 16, short, torch.float32, PlanConfig())
    tpufft_torch.fftn(_complex((2, 8, 16, short), seed=0), axes=(1, 2),
                      device="cpu")
    assert [c[0] for c in spies] == ["fft_inner_nd", "fft_inner"]
    spies.clear()
    # tpufft's pairing: the pair's second axis is the one before the minor
    # axis, so (1, 2) of a 5-D array runs two strided passes and (2, 3)
    # fuses, after the strided axis 0
    tpufft_torch.fftn(_complex((2, 8, 16, 8, 16), seed=0), axes=(1, 2),
                      device="cpu")
    assert [c[0] for c in spies] == ["fft_inner_nd", "fft_inner_nd"]
    spies.clear()
    tpufft_torch.fftn(_complex((2, 8, 16, 8, 16), seed=0), axes=(0, 2, 3),
                      device="cpu")
    assert [c[0] for c in spies] == ["fft_inner_nd", "fft_mid_pair"]
    assert spies[1] == ("fft_mid_pair", (16, 16, 8, 16))


def test_dispatch_mid_pair_t2_like(spies):
    """A transform-major plan shaped like T2 (tpufft's
    ``layout="transform-major"`` of (1, 25, 160, 160, 48) over axes 1-4):
    (1, 3, 160, 160, 12) runs the natural rules on the physical
    (1, 3, 12, 160, 160), whose trailing pair and cube no kernel holds, so
    K3 takes the axis of 3, the mid-pair wrapper the non-power-of-two pair
    (12, 160) at L = 160 once (the generic-radix line form), and K1 the
    minor axis of 160."""
    shape = (1, 3, 160, 160, 12)
    x = _complex(shape, seed=27)
    plan = tpufft_torch.plan_fft(shape, layout="transform-major",
                                 axes=(1, 2, 3, 4))
    packed = plan.pack(SplitComplex(torch.from_numpy(x.real.copy()),
                                    torch.from_numpy(x.imag.copy())))
    spies.clear()
    y = plan(packed)
    kernels = [c for c in spies if c[0] != "movedim"]
    assert [c[0] for c in kernels] == ["fft_inner_nd", "fft_mid_pair",
                                       "fft_minor"]
    assert kernels[1] == ("fft_mid_pair", (3, 12, 160, 160))
    assert mid_pair_fft.form(12, 160, 160) == "mixed"
    out = plan.unpack(y)
    got = out.re.numpy() + 1j * out.im.numpy()
    want = np.fft.fftn(x.astype(np.complex128), axes=(1, 2, 3, 4))
    assert _err(got, want) < 1e-5


def test_mid_route_strided_lines_match_the_model():
    """The route rule's mirror of the strided line form's lengths
    (``execute._strided_line``) is the strided kernel's model list up to
    K6's longest axis, 256."""
    from test_torch_strided_geometry import LINE_NS
    assert ([n for n in range(2, 257) if execute._strided_line(n)]
            == [n for n in LINE_NS if n <= 256])


@pytest.mark.parametrize("pair,L,dtype,route", [
    ((160, 160), 8, torch.float32, "two"),    # 12800 elements a block
    ((256, 128), 8, torch.float32, "two"),    # 16384
    ((128, 96), 8, torch.float32, "two"),     # 6144
    ((48, 160), 8, torch.float32, "k6"),      # T2's pair: 3840
    ((96, 96), 8, torch.float32, "k6"),       # 4608
    ((64, 120), 8, torch.float32, "two"),     # 3840, but 15 2^a
    ((56, 56), 8, torch.float32, "k6"),       # 7 2^a: the strided stage form
    ((112, 112), 8, torch.float32, "k6"),
    ((64, 128), 8, torch.float32, "k6"),      # the power-of-two form: 4096
    ((128, 128), 8, torch.float32, "two"),    # 8192
    ((160, 160), 8, torch.bfloat16, "k6"),    # K2's line form: 16 columns
    ((160, 160), 16, torch.bfloat16, "two"),
])
def test_dispatch_mid_pair_route(spies, pair, L, dtype, route):
    """Where the two strided passes on their line forms beat K6's line
    forms (a block share above ``MID_MIXED_MAX_SHARE``, or an axis of 15
    2^a), the pair runs K3 + K2; elsewhere one mid-pair pass. Both routes
    give np.fft.fftn's result."""
    n1, n2 = pair
    ok = execute.mid_pair_ok(n1, n2, L, dtype, PlanConfig())
    assert ok == (route == "k6")
    if dtype != torch.float32:
        return
    x = _complex((1, n1, n2, L), seed=n1 + L)
    spies.clear()
    y = tpufft_torch.fftn(x, axes=(1, 2), device="cpu")
    want = ([("fft_mid_pair", (1, n1, n2, L))] if ok else
            [("fft_inner_nd", (n1, n2, L)), ("fft_inner", (n1, n2, L))])
    assert [c for c in spies if c[0] != "movedim"] == want
    assert _err(y, np.fft.fftn(x.astype(np.complex128), axes=(1, 2))) < 1e-5


@pytest.mark.parametrize("fn", ["fftn", "ifftn"])
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("shape,axes", [
    ((3, 16, 32, 64), (1, 2, 3)),        # the cube (K5)
    ((2, 8, 16, 16, 64), None),          # leading axes, then the cube
    ((3, 40, 64, 256), (1, 2)),          # the mid pair (K6), scale on it
    ((2, 4, 8, 16, 128), (0, 2, 3)),     # strided axis 0, then the mid pair
])
def test_cube_and_mid_pair_match_tpufft(shape, axes, norm, fn):
    x = _complex(shape, seed=len(shape) + (norm or "").__len__())
    tp_cfg, cfg = CFGS["auto"]
    ref = getattr(tpufft, fn)(x, axes=axes, norm=norm, config=tp_cfg)
    got = getattr(tpufft_torch, fn)(x, axes=axes, norm=norm, config=cfg,
                                    device="cpu")
    assert _err(got, ref) < 1e-5
    np_ref = getattr(np.fft, fn)(x.astype(np.complex128), axes=axes,
                                 norm=norm)
    assert _err(got, np_ref) < 1e-5


def test_cube_and_mid_pair_bf16_planes():
    tp_cfg = TPPlanConfig(interpret=True, backend="auto", lane_block=128,
                          profile="fast")
    cfg = PlanConfig(**dataclasses.asdict(tp_cfg))
    for shape, axes in (((3, 16, 32, 64), (1, 2, 3)),
                        ((3, 40, 64, 256), (1, 2))):
        x = _complex(shape, seed=5)
        ref = tpufft.fftn(x, axes=axes, config=tp_cfg)
        out = tpufft_torch.fftn(
            SplitComplex(torch.from_numpy(x.real.copy()),
                         torch.from_numpy(x.imag.copy())),
            axes=axes, config=cfg)
        assert out.dtype == torch.bfloat16
        assert _err(out.numpy(), ref) < 8e-3


def test_mid_pair_real_input(spies):
    """Real input reaching the mid pair (tpufft's ai=None case,
    tests/test_nd.py::test_mid_pair_real_input)."""
    x = np.random.default_rng(13).standard_normal((16, 16, 256)).astype(
        np.float32)
    got = tpufft_torch.fftn(torch.from_numpy(x), axes=(0, 1),
                            config=CFGS["auto"][1])
    assert spies == [("fft_mid_pair", (1, 16, 16, 256))]
    assert got.is_complex()
    ref = tpufft.fftn(x, axes=(0, 1), config=CFGS["auto"][0])
    assert _err(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("shape,axes,inverse,norm", [
    ((2, 8, 16, 64), (1, 2, 3), False, None),      # the cube
    ((2, 4, 8, 16, 64), None, True, "ortho"),      # strided + the cube
    ((1, 8, 16, 128), (1, 2), False, "forward"),   # the mid pair
])
def test_cube_and_mid_pair_grad_match_jax(shape, axes, inverse, norm):
    rng = np.random.default_rng(17)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes,
                              inverse=inverse, norm=norm, config=TP_AUTO)

    def loss(a, b):
        out = tp_plan(TPSplit(a, b))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    xr = torch.tensor(re, requires_grad=True)
    xi = torch.tensor(im, requires_grad=True)
    out = _port_plan(tp_plan)(SplitComplex(xr, xi))
    (torch.sum(out.re ** 2) + 2.0 * torch.sum(out.im ** 2)).backward()
    for got, want in ((xr.grad, ref[0]), (xi.grad, ref[1])):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) < 1e-5


def test_mid_pair_grad_real_input():
    x = np.random.default_rng(19).standard_normal((8, 16, 128)).astype(
        np.float32)

    def loss(v):
        out = tpufft.fftn(v, axes=(0, 1), config=TP_AUTO)
        return jnp.sum(out.real ** 2) + 2.0 * jnp.sum(out.imag ** 2)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = tpufft_torch.fftn(xt, axes=(0, 1), config=CFGS["auto"][1])
    (torch.sum(out.real ** 2) + 2.0 * torch.sum(out.imag ** 2)).backward()
    assert np.max(np.abs(xt.grad.numpy() - ref)) / np.max(np.abs(ref)) < 1e-5

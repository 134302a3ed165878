"""The port's transform-major and lane-fused layouts against tpufft's.

A counterpart of each test of tpufft's ``TestTransformMajorLayout`` and
``TestLaneFusedLayout`` (``tests/test_api.py``): both packages build the
same plan and run it on the CPU (the port with ``device="cpu"``, where its
fused wrappers run their plain versions; tpufft in Pallas interpret mode
where its own test asks for the kernel path), on the same numpy data. The
plan attributes, the outputs, the tier that ran (spies on the port's
``execute.*_fused``), the gradients and ``convert.plan_from_fields`` are
compared. Tolerances, normalized by the spectrum's magnitude: 1e-5 for
c64 (both sides compute in f32), 1e-10 for c128 (conftest turns x64 on),
8e-3 for bf16 planes (``profile="fast"``), 1e-5 for gradients.
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
from tpufft_torch.kernels import fused_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_INTERP = TPPlanConfig(interpret=True)


def _complex(shape, rng, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _plans(shape, dtype=np.complex64, tp_config=None, **kw):
    """tpufft's plan and the port's (on the CPU), with their public
    attributes and the carried-across plan checked equal."""
    tp = tpufft.plan_fft(shape, dtype, config=tp_config, **kw)
    cfg = None if tp_config is None else PlanConfig(
        **dataclasses.asdict(tp_config))
    ours = tpufft_torch.plan_fft(shape, dtype, config=cfg, device="cpu", **kw)
    for name in ("shape", "axes", "lengths", "layout", "logical_shape",
                 "logical_axis", "logical_perm", "kind", "inverse", "norm"):
        assert getattr(ours, name) == getattr(tp, name), name
    assert _carried(tp) == ours
    return tp, ours


def _carried(tp):
    return plan_from_fields(
        tp.shape, tp.dtype, tp.axes, tp.lengths, tp.bases, tp.inverse,
        tp.norm, tp.kind, dataclasses.asdict(tp.config), device="cpu",
        layout=tp.layout, logical_shape=tp.logical_shape,
        logical_axis=tp.logical_axis, logical_perm=tp.logical_perm)


@pytest.fixture
def tiers(monkeypatch):
    """The fused passes the port's plans ran, in order."""
    calls = []
    for name in ("fft_cube_fused", "fft_pair_fused", "fft_minor_fused",
                 "fft_axis_fused"):
        real = getattr(execute, name)

        def spy(st, *args, _name=name, _real=real, **kw):
            calls.append((_name.removeprefix("fft_").removesuffix("_fused"),
                          tuple(st.shape)) + args)
            return _real(st, *args, **kw)

        monkeypatch.setattr(execute, name, spy)
    return calls


# ----------------------------------------------------------------------------
# transform-major (tpufft's TestTransformMajorLayout)
# ----------------------------------------------------------------------------

def _tm_run(tp, ours, x):
    """unpack(plan(pack(x))) through both packages, as numpy."""
    ref = tp.unpack(tp(tp.pack(x))).numpy()
    got = ours.unpack(ours(ours.pack(x))).numpy()
    return got, ref


def test_tm_minor_axis_matches_natural(rng):
    x = _complex((50, 93), rng)
    tp, p = _plans(x.shape, axes=(-1,), layout="transform-major")
    assert p.shape == (93, 50) and p.axes == (0,)
    sc = p.pack(x)
    assert isinstance(sc, SplitComplex) and sc.shape == (93, 50)
    got, ref = _tm_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.fft(x, axis=-1)) < 1e-5


def test_tm_inverse_norm_nonminor_logical_axis(rng):
    x = _complex((93, 40), rng)
    tp, p = _plans(x.shape, axes=(0,), inverse=True, norm="ortho",
                   layout="transform-major")
    got, ref = _tm_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.ifft(x, axis=0, norm="ortho")) < 1e-5


def test_tm_s_resize(rng):
    x = _complex((40, 93), rng)
    tp, p = _plans(x.shape, axes=(-1,), s=(128,), layout="transform-major")
    got, ref = _tm_run(tp, p, x)
    assert got.shape == (40, 128)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.fft(x, n=128, axis=-1)) < 1e-5


def test_tm_pack_unpack_device_and_host_forms(rng):
    x = _complex((8, 93), rng)
    _, p = _plans(x.shape, axes=(-1,), layout="transform-major")
    sc_from_np = p.pack(x)
    sc_from_sc = p.pack(SplitComplex(torch.from_numpy(x.real.copy()),
                                     torch.from_numpy(x.imag.copy())))
    sc_from_t = p.pack(torch.from_numpy(x))
    for sc in (sc_from_sc, sc_from_t):
        assert torch.equal(sc.re, sc_from_np.re)
        assert torch.equal(sc.im, sc_from_np.im)
    y = p(sc_from_np)
    host = p.unpack(y.numpy())
    assert isinstance(host, np.ndarray) and host.shape == (8, 93)
    dev = p.unpack(y.complex())          # a tensor stays a tensor
    assert isinstance(dev, torch.Tensor) and dev.shape == (8, 93)
    assert _err(dev.numpy(), host) == 0.0
    assert _err(host, np.fft.fft(x, axis=-1)) < 1e-5


@pytest.mark.parametrize("kw", [
    dict(shape=(8, 93), axes=(-1,), kind="r2c"),
    dict(shape=(8, 16, 93), axes=(1, 2), s=(16, 128)),
    dict(shape=(8, 93), axes=(-1,), layout="bogus"),
], ids=["r2c", "nd-resize", "bogus"])
def test_tm_rejects_r2c_nd_resize_and_bogus(kw):
    kw = dict(kw)
    shape = kw.pop("shape")
    kw.setdefault("layout", "transform-major")
    with pytest.raises(ValueError) as theirs:
        tpufft.plan_fft(shape, **kw)
    with pytest.raises(ValueError) as ours:
        tpufft_torch.plan_fft(shape, device="cpu", **kw)
    assert str(ours.value) == str(theirs.value)


def test_tm_nd_perm_puts_best_utilization_minor():
    _, p = _plans((1, 25, 160, 160, 48), axes=(1, 2, 3, 4),
                  layout="transform-major")
    assert p.shape == (1, 25, 48, 160, 160)
    assert p.axes == (1, 2, 3, 4)
    assert p.logical_perm == (0, 1, 4, 2, 3)


def test_tm_nd_matches_natural_all_axes(rng):
    shape = (2, 5, 20, 12, 6)
    x = _complex(shape, rng)
    tp, p = _plans(shape, axes=(1, 2, 3, 4), layout="transform-major")
    got, ref = _tm_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.fftn(x, axes=(1, 2, 3, 4))) < 1e-5
    sc = p.pack(SplitComplex(torch.from_numpy(x.real.copy()),
                             torch.from_numpy(x.imag.copy())))
    assert torch.equal(sc.re, p.pack(x).re)
    ref_sc = tp.pack(TPSplit.from_array(x))
    np.testing.assert_array_equal(sc.re.numpy(), np.asarray(ref_sc.re))


def test_tm_nd_axis_subset_inverse_norm(rng):
    shape = (3, 10, 4, 12)
    x = _complex(shape, rng)
    tp, p = _plans(shape, axes=(1, 2), inverse=True, norm="ortho",
                   layout="transform-major")
    assert p.shape == (3, 12, 4, 10) and p.axes == (2, 3)
    got, ref = _tm_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.ifftn(x, axes=(1, 2), norm="ortho")) < 1e-5


def test_tm_nd_host_numpy_pack_unpack_roundtrip(rng):
    shape = (2, 6, 10, 4)
    x = _complex(shape, rng, np.complex128)
    tp, p = _plans(shape, np.complex128, axes=(1, 2, 3),
                   layout="transform-major")
    sc = p.pack(x)
    assert sc.dtype == torch.float64
    host = p.unpack(p(sc).numpy())
    assert isinstance(host, np.ndarray) and host.shape == shape
    assert np.max(np.abs(host - np.fft.fftn(x, axes=(1, 2, 3)))) < 1e-10
    ref = tp.unpack(tp(tp.pack(x)).numpy())
    assert _err(host, ref) < 1e-10


def test_tm_natural_layout_pack_is_identity(rng):
    x = _complex((8, 16), rng)
    _, p = _plans(x.shape, axes=(-1,))
    sc = p.pack(x)
    assert isinstance(sc, SplitComplex) and sc.shape == (8, 16)
    assert p.unpack(sc) is sc


def test_tm_runs_the_natural_pipeline_on_the_physical_shape(rng,
                                                           monkeypatch):
    """The plan of (1000, 93) along its minor axis is axis 0 of (93, 1000):
    the strided kernel's wrapper (K2) on (1, 93, 1000), not the minor
    one's."""
    from tpufft_torch.kernels import inner_fft, minor_fft
    calls = []
    for mod, name in ((inner_fft, "fft_inner"), (minor_fft, "fft_minor")):
        real = getattr(mod, name)

        def spy(xr, xi, _name=name, _real=real, **kw):
            calls.append((_name, tuple(xr.shape)))
            return _real(xr, xi, **kw)

        monkeypatch.setattr(mod, name, spy)
    x = _complex((1000, 93), rng)
    _, p = _plans(x.shape, axes=(-1,), layout="transform-major")
    got = p.unpack(p(p.pack(x))).numpy()
    assert _err(got, np.fft.fft(x, axis=-1)) < 1e-5
    assert calls == [("fft_inner", (1, 93, 1000))]


# ----------------------------------------------------------------------------
# lane-fused (tpufft's TestLaneFusedLayout)
# ----------------------------------------------------------------------------

def _lf_run(tp, p, x):
    """unpack(plan(pack(x))) through both packages, as numpy."""
    ref = tp.unpack(np.asarray(tp(tp.pack(x))))
    got = p.unpack(p(p.pack(x))).numpy()
    return got, ref


def test_lf_kernel_path_matches_numpy(rng, tiers):
    shape = (4, 16, 16, 64)
    x = _complex(shape, rng)
    tp, p = _plans(shape, axes=(-3, -2, -1), layout="lane-fused",
                   tp_config=TP_INTERP)
    st = p.pack(x)
    assert isinstance(st, torch.Tensor) and st.dtype == torch.float32
    assert tuple(st.shape) == shape[:-1] + (2 * shape[-1],)
    np.testing.assert_array_equal(st.numpy(), np.asarray(tp.pack(x)))
    got, ref = _lf_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.fftn(x, axes=(-3, -2, -1))) < 1e-5
    assert tiers == [("cube", tuple(st.shape))]


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_lf_fallback_path_and_roundtrip(backend, rng, tiers):
    """tpufft's default config on the CPU takes its split-plane fallback;
    the port takes the cube tier under "auto" (its plain versions run on
    the CPU) and the same split-plane fallback under "xla"."""
    shape = (2, 16, 16, 64)
    x = _complex(shape, rng)
    cfg = PlanConfig(backend=backend)
    fwd = tpufft.plan_fft(shape, axes=(-3, -2, -1), layout="lane-fused")
    inv = tpufft.plan_fft(shape, axes=(-3, -2, -1), layout="lane-fused",
                          inverse=True)
    pf = tpufft_torch.plan_fft(shape, axes=(-3, -2, -1), layout="lane-fused",
                               config=cfg, device="cpu")
    pi = tpufft_torch.plan_fft(shape, axes=(-3, -2, -1), layout="lane-fused",
                               inverse=True, config=cfg, device="cpu")
    st = pf.pack(x)
    y = pf(st)
    assert _err(pf.unpack(y).numpy(), fwd.unpack(np.asarray(fwd(fwd.pack(x))))
                ) < 1e-5
    back = pi.unpack(pi(y)).numpy()
    assert np.max(np.abs(back - x)) < 1e-4
    ref_back = inv.unpack(np.asarray(inv(fwd(fwd.pack(x)))))
    assert _err(back, ref_back) < 1e-5
    want = [] if backend == "xla" else [("cube", tuple(st.shape))] * 2
    assert tiers == want


def test_lf_unpack_device_gives_splitcomplex(rng):
    shape = (2, 8, 8, 64)
    x = _complex(shape, rng)
    tp, p = _plans(shape, axes=(-3, -2, -1), layout="lane-fused")
    out = p(p.pack(x))
    sc = p.unpack(out)
    assert isinstance(sc, SplitComplex) and sc.shape == shape
    ref = tp.unpack(tp(tp.pack(x)))
    assert isinstance(ref, TPSplit)
    assert _err(sc.numpy(), ref.numpy()) < 1e-5
    host = p.unpack(out.numpy())
    assert isinstance(host, np.ndarray) and host.shape == shape


@pytest.mark.parametrize("tier", ["cube", "pair", "minor"])
def test_lf_grad_through_fused_kernels(tier, rng, monkeypatch):
    """The gradient of <plan(st), g> against jax.grad through tpufft's
    ``Plan._fn_fused`` (its Pallas kernels in interpret mode); each tier's
    backward runs its passes again, with the opposite sign."""
    passes = []
    for name in ("fft_cube_fused", "fft_pair_fused", "fft_inner_fused",
                 "fft_minor_fused"):
        real = getattr(fused_fft, name)

        def spy(st, *, _name=name, _real=real, **kw):
            passes.append((_name.split("_")[1], kw["inverse"]))
            return _real(st, **kw)

        monkeypatch.setattr(fused_fft, name, spy)
    if tier != "cube":
        monkeypatch.setattr(fused_fft, "cube_supported", lambda *a: False)
    if tier == "minor":
        monkeypatch.setattr(fused_fft, "pair_supported", lambda *a: False)
    shape = (1, 8, 8, 64)
    tp, p = _plans(shape, axes=(-3, -2, -1), layout="lane-fused",
                   tp_config=TP_INTERP)
    st = np.array(tp.pack(_complex(shape, rng)))
    g = rng.standard_normal(st.shape).astype(np.float32)
    ref = jax.grad(lambda s: jnp.sum(tp._fn_fused(s) * g))(jnp.asarray(st))
    ts = torch.from_numpy(st).requires_grad_(True)
    (p(ts) * torch.from_numpy(g)).sum().backward()
    assert ts.grad.shape == ts.shape
    assert np.all(np.isfinite(ts.grad.numpy()))
    assert _err(ts.grad.numpy(), np.asarray(ref)) < 1e-5
    fwd = {"cube": ["cube"], "pair": ["inner", "pair"],
           "minor": ["inner", "inner", "minor"]}[tier]
    assert passes == ([(k, False) for k in fwd]
                      + [(k, True) for k in reversed(fwd)])


def test_lf_unsorted_axes_canonicalized(rng, tiers):
    shape = (6, 8, 8, 64)
    x = _complex(shape, rng)
    tp, p = _plans(shape, axes=(2, 0, 1, 3), layout="lane-fused",
                   tp_config=TP_INTERP)
    assert p.axes == (0, 1, 2, 3)
    got, ref = _lf_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.fftn(x, axes=(0, 1, 2, 3))) < 1e-5
    # the leading axis 0 first (K18 on (1, 6, 64, 128)), then the cube
    fused = (6, 8, 8, 128)
    assert tiers == [("axis", fused, 0), ("cube", fused)]


def test_lf_pack_preserves_f64_for_c128_plans(rng, tiers):
    shape = (2, 8, 8, 64)
    x = _complex(shape, rng, np.complex128)
    tp, p = _plans(shape, np.complex128, axes=(-3, -2, -1),
                   layout="lane-fused")
    st = p.pack(x)
    assert st.dtype == torch.float64
    got = p.unpack(p(st).numpy())
    assert np.max(np.abs(got - np.fft.fftn(x, axes=(-3, -2, -1)))) < 1e-10
    ref = tp.unpack(np.asarray(tp(tp.pack(x))))
    assert _err(got, ref) < 1e-10
    assert tiers == []   # float64 takes the split-plane route


@pytest.mark.parametrize("tier", ["pair", "minor"])
def test_lf_sub_cube_tiers(tier, rng, monkeypatch, tiers):
    """Cube gate closed: the pair tier runs the last two axes in one pass
    after the leading one; with the pair gate also closed, every axis runs
    on its own (K18, K19, K20). tpufft's gates are closed the same way."""
    from tpufft.kernels import mxu_fft
    from tpufft import execute as tp_execute
    monkeypatch.setattr(mxu_fft, "cube_supported", lambda *a, **k: False)
    monkeypatch.setattr(tp_execute, "cube_supported", lambda *a, **k: False)
    monkeypatch.setattr(fused_fft, "cube_supported", lambda *a: False)
    if tier == "minor":
        monkeypatch.setattr(mxu_fft, "pair_fused_supported",
                            lambda *a, **k: False)
        monkeypatch.setattr(fused_fft, "pair_supported", lambda *a: False)
    # shapes apart from tpufft's own test: its plans are lru-cached
    shape = (1, 16, 8, 64) if tier == "pair" else (1, 8, 16, 64)
    x = _complex(shape, rng)
    tp, p = _plans(shape, axes=(-3, -2, -1), layout="lane-fused",
                   tp_config=TP_INTERP)
    got, ref = _lf_run(tp, p, x)
    assert _err(got, ref) < 1e-5
    assert _err(got, np.fft.fftn(x, axes=(-3, -2, -1))) < 1e-5
    fused = shape[:-1] + (128,)
    want = {"pair": [("axis", fused, 1), ("pair", fused)],
            "minor": [("axis", fused, 1), ("axis", fused, 2),
                      ("minor", fused)]}[tier]
    assert tiers == want


@pytest.mark.parametrize("call,match", [
    (lambda m: m.plan_fft((8, 8, 8, 64), axes=(0, 1, 2), layout="lane-fused",
                          **_cpu(m)), "last three"),
    (lambda m: m.plan_fft((8, 8, 64), axes=(0, 1, 2), s=(8, 8, 128),
                          layout="lane-fused", **_cpu(m)), "without"),
    (lambda m: m.plan_fft((8, 8, 8, 64), axes=(-3, -2, -1),
                          layout="lane-fused", **_cpu(m))(
                              np.zeros((8, 8, 8, 64), np.float32)),
     "fused shape"),
    (lambda m: m.plan_fft((8, 8, 64), axes=(0, 1, 2), kind="c2r",
                          layout="lane-fused", **_cpu(m)), "c2c"),
], ids=["last-three", "resize", "fused-shape", "kind"])
def test_lf_rejects_bad_specs(call, match):
    with pytest.raises(ValueError, match=match) as theirs:
        call(tpufft)
    with pytest.raises(ValueError, match=match) as ours:
        call(tpufft_torch)
    assert str(ours.value) == str(theirs.value)


def _cpu(module):
    return {"device": "cpu"} if module is tpufft_torch else {}


def test_lf_bf16_planes(rng, tiers):
    """``profile="fast"`` stores the fused array in bf16 (tpufft's
    plane_dtype rule); the cube tier runs on it."""
    shape = (2, 8, 16, 64)
    x = _complex(shape, rng)
    tp_cfg = TPPlanConfig(interpret=True, profile="fast")
    tp, p = _plans(shape, axes=(-3, -2, -1), layout="lane-fused",
                   tp_config=tp_cfg)
    y = p(p.pack(x))
    assert y.dtype == torch.bfloat16
    ref = tp(tp.pack(x))
    assert _err(p.unpack(y).numpy(), tp.unpack(np.asarray(
        ref.astype(jnp.float32)))) < 8e-3
    assert tiers == [("cube", tuple(y.shape))]


def test_lf_leading_axes_and_norms(rng, tiers):
    """A 4-axis plan: the leading axis on K18, then the cube, the whole
    norm on the cube's pass; every norm, both directions (tpufft on its
    split-plane route, as its default config takes on the CPU)."""
    shape = (3, 4, 8, 8, 16)
    x = _complex(shape, rng)
    for norm in (None, "ortho", "forward"):
        for inverse in (False, True):
            tiers.clear()
            tp, p = _plans(shape, axes=(1, 2, 3, 4), inverse=inverse,
                           norm=norm, layout="lane-fused")
            got, ref = _lf_run(tp, p, x)
            assert _err(got, ref) < 1e-5
            fn = np.fft.ifftn if inverse else np.fft.fftn
            assert _err(got, fn(x, axes=(1, 2, 3, 4), norm=norm)) < 1e-5
            fused = shape[:-1] + (32,)
            assert tiers == [("axis", fused, 1), ("cube", fused)]


@pytest.mark.parametrize("layout,kw", [
    ("transform-major", dict(shape=(6, 20, 12), axes=(1, 2))),
    ("transform-major", dict(shape=(30, 93), axes=(-1,), s=(128,))),
    ("lane-fused", dict(shape=(2, 8, 8, 16), axes=(1, 2, 3))),
])
def test_plan_from_fields_carries_layout_plans(layout, kw, rng):
    """A tpufft layout plan comes across with the same physical shape: data
    packed by tpufft runs on the carried plan with tpufft's results."""
    kw = dict(kw)
    shape = kw.pop("shape")
    tp = tpufft.plan_fft(shape, layout=layout, **kw)
    carried = _carried(tp)
    assert carried == tpufft_torch.plan_fft(shape, layout=layout,
                                            device="cpu", **kw)
    x = _complex(shape, rng)
    packed = tp.pack(x)
    if layout == "lane-fused":
        got = carried(torch.from_numpy(np.array(packed)))
        ref = tp(packed)
        assert _err(carried.unpack(got).numpy(),
                    tp.unpack(np.asarray(ref))) < 1e-5
    else:
        got = carried(SplitComplex(torch.from_numpy(np.array(packed.re)),
                                   torch.from_numpy(np.array(packed.im))))
        ref = tp(packed)
        assert _err(carried.unpack(got).numpy(), tp.unpack(ref).numpy()) < 1e-5

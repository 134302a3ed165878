"""The fused zero-pad against tpufft: K9 (the minor-axis kernel with a bound
on its load) and K4's ``n2_in``, their plain versions against
``_build_minor_rect`` and ``_build_2d`` with ``n2_io``, and the zero-padded
C2C plans (``s="fast-aligned"``, explicit ``s``) that run them.

tpufft's Pallas kernels run in interpret mode on the CPU with
``precision="highest"``; the port runs the plain versions (CPU tensors), on
the same planes made from a numpy seed. Tolerances, normalized by the
magnitude of the result: 1e-5 for f32 storage (both sides compute in f32
and differ in summation order), 8e-3 for bf16 storage (both round to bf16
at the store), 1e-5 of the gradient's magnitude for gradients.
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
from tpufft.kernels import mxu_fft as tp_mxu

import tpufft_torch
from tpufft_torch import PlanConfig, SplitComplex, execute
from tpufft_torch.convert import plan_from_fields
from tpufft_torch.kernels import cube_fft, inner_fft, minor_fft, pair_fft
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas", lane_block=128,
                      precision="highest")
CFG = PlanConfig(**dataclasses.asdict(TP_CFG))


def _err(got, ref):
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _complex(shape, seed):
    re, im = _planes(shape, seed)
    return (re + 1j * im).astype(np.complex64)


def _np(planes):
    return planes[0].float().numpy() + 1j * planes[1].float().numpy()


def _jnp(planes):
    return (np.asarray(planes[0].astype(jnp.float32))
            + 1j * np.asarray(planes[1].astype(jnp.float32)))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n_in,n", [(93, 128), (5, 8), (100, 120),
                                    (1000, 1024)])
def test_padded_reference_matches_build_minor_rect(n_in, n, inverse,
                                                   storage):
    re, im = _planes((6, n_in), n_in)
    scale = 1.0 / n if inverse else 1.0
    jdt, tdt = ((jnp.float32, torch.float32) if storage == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    run = tp_mxu._build_minor_rect(n_in, n, n, inverse, scale,
                                   tp_mxu.choose_lane_block(n, TP_CFG),
                                   "highest", True, storage)
    ref = _jnp(run(jnp.asarray(re, jdt), jnp.asarray(im, jdt)))
    got = minor_fft.fft_minor_padded_reference(
        torch.from_numpy(re).to(tdt), torch.from_numpy(im).to(tdt), n=n,
        inverse=inverse, scale=scale)
    assert got[0].dtype == tdt and got[0].shape == (6, n)
    assert _err(_np(got), ref) < (1e-5 if storage == "f32" else 8e-3)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n1,n2_in,n2", [(8, 93, 128), (16, 48, 64),
                                         (12, 100, 128), (4, 5, 8)])
def test_pair_padded_reference_matches_build_2d_n2_io(n1, n2_in, n2,
                                                      inverse):
    re, im = _planes((3, n1, n2_in), n1 + n2_in)
    scale = 1.0 / (n1 * n2) if inverse else 1.0
    ref = _jnp(tp_mxu.fft_pair_pallas(
        jnp.asarray(re), jnp.asarray(im), inverse=inverse, scale=scale,
        config=TP_CFG, n2_io=(n2_in, n2)))
    got = pair_fft.fft_pair_padded_reference(
        torch.from_numpy(re), torch.from_numpy(im), n2=n2, inverse=inverse,
        scale=scale)
    assert got[0].shape == (3, n1, n2)
    assert _err(_np(got), ref) < 1e-5


@pytest.fixture
def passes(monkeypatch):
    """(kernel, input shape, scale) of every wrapper call, in order."""
    calls = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(xr, xi, **kw):
            calls.append((name, tuple(xr.shape), kw["scale"]))
            return real(xr, xi, **kw)

        monkeypatch.setattr(module, name, wrapped)

    for module, names in ((minor_fft, ("fft_minor", "fft_minor_padded")),
                          (inner_fft, ("fft_inner", "fft_inner_nd")),
                          (pair_fft, ("fft_pair", "fft_pair_padded")),
                          (cube_fft, ("fft_cube",))):
        for name in names:
            spy(module, name)
    return calls


# (input shape, axes, s, norm, the kernels in order, the pass that takes
# the scale: every other pass takes 1)
PLAN_CASES = [
    # 1-D: one K9 pass
    ((6, 93), (-1,), ("fast-aligned",), None,
     ["fft_minor_padded"], 0),
    # the padded minor axis first, then axis 0 on the strided kernel, which
    # takes the scale
    ((16, 5, 93), (0, 2), (16, 128), "forward",
     ["fft_minor_padded", "fft_inner_nd"], 1),
    # the pad fused into the trailing pair, then the leading axis (a cube
    # outside the cube kernel's envelope: 3 * 128 * 128)
    ((3, 128, 93), None, (3, 128, 128), "ortho",
     ["fft_pair_padded", "fft_inner_nd"], 0),
    # "fast-aligned" on both pair axes: axis 1 needs no pad (16 -> 128 is a
    # pad, so it is resized first), the minor axis pads inside K4
    ((3, 16, 93), (1, 2), "fast-aligned", "forward",
     ["fft_pair_padded"], 0),
    # a crop of the minor axis: no pad to fuse
    ((5, 100), (-1,), (64,), None, ["fft_minor"], 0),
    # a padded non-minor axis: resized, then the strided kernel
    ((50, 24), (0,), (64,), "ortho", ["fft_inner"], 0),
    # a cube inside the cube kernel's envelope: the minor axis is resized
    # and the three axes run in one pass, which takes the scale (tpufft's
    # cube_last rule comes before the pair's pad)
    ((4, 16, 93), None, (4, 16, 128), "ortho", ["fft_cube"], 0),
]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape,axes,s,norm,kernels,scaled", PLAN_CASES)
def test_padded_plans_match_tpufft(shape, axes, s, norm, kernels, scaled,
                                   inverse, passes):
    x = _complex(shape, sum(shape))
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes, s=s,
                              inverse=inverse, norm=norm, config=TP_CFG)
    plan = plan_from_fields(
        tp_plan.shape, tp_plan.dtype, tp_plan.axes, tp_plan.lengths,
        tp_plan.bases, tp_plan.inverse, tp_plan.norm, tp_plan.kind,
        dataclasses.asdict(tp_plan.config), device="cpu")
    assert plan == tpufft_torch.plan_fft(shape, torch.complex64, axes=axes,
                                         s=s, inverse=inverse, norm=norm,
                                         config=CFG, device="cpu")
    ref = tp_plan(TPSplit(jnp.asarray(x.real), jnp.asarray(x.imag)))
    got = plan(SplitComplex(torch.from_numpy(x.real.copy()),
                            torch.from_numpy(x.imag.copy())))
    assert got.shape == tp_plan.out_shape
    assert _err(got.numpy(), np.asarray(ref.re) + 1j * np.asarray(ref.im)) \
        < 1e-5
    assert [c[0] for c in passes] == kernels
    n_total = float(np.prod(plan.lengths))
    if norm == "ortho":
        want_scale = 1.0 / np.sqrt(n_total)
    elif (norm == "forward") != inverse:
        want_scale = 1.0 / n_total
    else:
        want_scale = 1.0
    for i, (_, _, scale) in enumerate(passes):
        assert scale == pytest.approx(want_scale if i == scaled else 1.0)


def test_pad_axis_ok():
    f32 = torch.float32
    assert execute.pad_axis_ok(93, 128, f32, CFG)
    assert execute.pad_axis_ok(1, 16384, f32, CFG)
    assert not execute.pad_axis_ok(128, 128, f32, CFG)      # no pad
    assert not execute.pad_axis_ok(100, 131, f32, CFG)      # 131 > envelope
    assert not execute.pad_axis_ok(93, 128, torch.float64, CFG)
    assert not execute.pad_axis_ok(93, 128, f32, PlanConfig(backend="xla"))
    assert execute.pair_pad_ok(64, 93, 128, f32, CFG)
    assert not execute.pair_pad_ok(256, 93, 128, f32, CFG)  # area > 16384
    assert not execute.pair_pad_ok(64, 128, 128, f32, CFG)


def test_xla_backend_pads_with_a_copy(passes):
    x = _complex((4, 93), 3)
    got = tpufft_torch.fft(x, n="fast-aligned",
                           config=PlanConfig(backend="xla"), device="cpu")
    assert passes == []
    assert _err(got, np.fft.fft(x.astype(np.complex128), 128)) < 1e-5


def test_wrappers_cpu_run_plain_versions():
    re, im = _planes((3, 93), 0)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    minor_fft.reset_counts()
    pair_fft.reset_counts()
    got = minor_fft.fft_minor_padded(xr, xi, n=128, inverse=False, scale=1.0)
    assert _err(_np(got), np.fft.fft(re + 1j * im.astype(np.float64),
                                     128)) < 1e-5
    got = pair_fft.fft_pair_padded(xr[None], xi[None], n2=128, inverse=True,
                                   scale=1.0)
    assert _err(_np(got), np.fft.ifft2(re + 1j * im.astype(np.float64),
                                       s=(3, 128))[None] * 3 * 128) < 1e-5
    assert minor_fft.padded_launches == pair_fft.padded_launches == 0
    assert minor_fft.reference_cuda_calls == pair_fft.reference_cuda_calls == 0


def test_padded_wrappers_refuse_non_cuda_devices():
    x = torch.empty(2, 93, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        minor_fft.fft_minor_padded(x, x, n=128, inverse=False, scale=1.0)
    y = x.reshape(1, 2, 93)
    with pytest.raises(ValueError, match="CUDA device"):
        pair_fft.fft_pair_padded(y, y, n2=128, inverse=False, scale=1.0)


def _tp_loss(plan):
    def loss(re, im):
        out = plan(TPSplit(re, im))
        return jnp.sum(out.re ** 2) + 2.0 * jnp.sum(out.im ** 2)
    return loss


@pytest.mark.parametrize("shape,axes,s,inverse,norm", [
    ((4, 93), (-1,), (128,), False, None),          # K9
    ((3, 40), (-1,), (64,), True, "ortho"),         # K9, inverse
    ((2, 8, 45), (1, 2), (8, 64), False, "forward"),  # the pair pad
])
def test_padded_grad_matches_jax(shape, axes, s, inverse, norm):
    """The pad-fused transforms' backward (the opposite-sign transform,
    then the crop) against ``jax.grad`` of tpufft's plan."""
    re, im = _planes(shape, 7)
    tp_plan = tpufft.plan_fft(shape, jnp.complex64, axes=axes, s=s,
                              inverse=inverse, norm=norm, config=TP_CFG)
    ref = jax.grad(_tp_loss(tp_plan), argnums=(0, 1))(jnp.asarray(re),
                                                       jnp.asarray(im))
    xr = torch.tensor(re, requires_grad=True)
    xi = torch.tensor(im, requires_grad=True)
    plan = tpufft_torch.plan_fft(shape, torch.complex64, axes=axes, s=s,
                                 inverse=inverse, norm=norm, config=CFG,
                                 device="cpu")
    out = plan(SplitComplex(xr, xi))
    (torch.sum(out.re ** 2) + 2.0 * torch.sum(out.im ** 2)).backward()
    for got, want in ((xr.grad, ref[0]), (xi.grad, ref[1])):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) \
            < 1e-5

"""The fused-storage kernels' plain versions (K16-K20) against tpufft's
Pallas kernels on fused storage.

tpufft's kernels run in interpret mode on the CPU with
``precision="highest"``, reached through ``mxu_fft.fft_cube_fused_pallas``
(``_build_3d_fused``), ``fft_pair_fused_pallas`` (``_build_pair_fused``),
``fft_minor_fused_pallas`` (``_build_minor_fused``) and
``fft_axis_fused_pallas`` (``_build_inner_fused`` for M > 1,
``_build_inner_fused_m1`` for M == 1). The port runs ``fused_fft``'s
wrappers on CPU tensors, which run their plain versions, on the same fused
arrays made from a numpy seed. Shapes are logical; each fused array is
(..., 2 * minor) with rows [re | im]. Tolerances, normalized by the
spectrum's magnitude: 1e-5 for f32 storage (both sides compute in f32 and
differ in summation order), 8e-3 for bf16 storage (both round to bf16 at
the store).

The CUDA kernels need the card: ``test_torch_cuda.py`` holds them against
these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpufft import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch.kernels import fused_fft

from test_torch_strided_geometry import use_model
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TP_CFG = TPPlanConfig(interpret=True, backend="pallas", precision="highest")

# kernel: (logical shape, tpufft's call, the port's wrapper, transformed
# logical axes)
KERNELS = {
    "cube": ((3, 8, 16, 64), tp_mxu.fft_cube_fused_pallas,
             fused_fft.fft_cube_fused, (1, 2, 3)),
    "pair": ((5, 16, 64), tp_mxu.fft_pair_fused_pallas,
             fused_fft.fft_pair_fused, (1, 2)),
    "minor": ((9, 64), tp_mxu.fft_minor_fused_pallas,
              fused_fft.fft_minor_fused, (1,)),
    "inner": ((2, 16, 8, 64),
              lambda st, **kw: tp_mxu.fft_axis_fused_pallas(st, 1, **kw),
              fused_fft.fft_inner_fused, (1,)),
    "inner_m1": ((3, 8, 64),
                 lambda st, **kw: tp_mxu.fft_axis_fused_pallas(st, 1, **kw),
                 fused_fft.fft_inner_fused, (1,)),
}


def _fused(shape, seed):
    """A fused f32 array (..., 2 * shape[-1]) and its complex value."""
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return np.concatenate([re, im], -1), re + 1j * im.astype(np.float64)


def _unfuse(st):
    h = st.shape[-1] // 2
    return st[..., :h].astype(np.float64) + 1j * st[..., h:]


def _err(got, ref):
    return np.max(np.abs(got - ref)) / max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("scaled", [False, True], ids=["scale1", "scale1/N"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_version_matches_pallas(kernel, dtype, inverse, scaled):
    shape, theirs, ours, axes = KERNELS[kernel]
    st, x = _fused(shape, seed=len(kernel) + 7 * inverse)
    n_total = int(np.prod([shape[a] for a in axes]))
    scale = 1.0 / n_total if scaled else 1.0
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 8e-3))
    ref = theirs(jnp.asarray(st, jdt), inverse=inverse, scale=scale,
                 config=TP_CFG)
    ref = np.asarray(ref.astype(jnp.float32))
    fused_fft.reset_counts()
    got = ours(torch.from_numpy(st).to(tdt), inverse=inverse, scale=scale)
    assert got.dtype == tdt and tuple(got.shape) == st.shape
    assert fused_fft.launches == dict.fromkeys(fused_fft.launches, 0)
    assert fused_fft.reference_cuda_calls == 0
    got = got.float().numpy()
    assert _err(_unfuse(got), _unfuse(ref)) < tol
    if dtype == "f32":
        fn = np.fft.ifftn if inverse else np.fft.fftn
        want = fn(x, axes=axes) * scale * (n_total if inverse else 1)
        assert _err(_unfuse(got), want) < 1e-5


def test_gates_are_the_port_envelopes():
    """The gates take the port's envelopes on the logical lengths, not
    tpufft's TPU rules: lengths above 128, odd halves, n3 % 64 != 0 and
    n2 % 8 != 0 pass; what the split-plane kernels refuse is refused."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert fused_fft.cube_supported(64, 64, 64, f32)
    assert fused_fft.cube_supported(3, 16, 24, bf16)
    assert not fused_fft.cube_supported(128, 128, 128, f32)   # 2^21
    assert not fused_fft.cube_supported(8, 8, 8, torch.float64)
    assert fused_fft.pair_supported(128, 128, f32)
    assert fused_fft.pair_supported(7, 93, f32)        # tpufft: n2 % 8, n3 % 64
    assert not fused_fft.pair_supported(128, 256, f32)  # 32768 > 16384
    for n in (1, 93, 1000, 16384):
        assert fused_fft.minor_supported(n, f32)        # tpufft: n % 64
        assert fused_fft.inner_supported(n, bf16)       # tpufft: n <= 128
    assert not fused_fft.minor_supported(131 * 2, f32)  # prime 131
    assert not fused_fft.inner_supported(16385, f32)


@pytest.mark.parametrize("n,expected", (
    [(2 ** k, "lines") for k in range(1, 13)]
    + [(n, "lines") for n in (93, 480, 960)]
    + [(n, "stages") for n in (1, 1792, 4100, 12000, 127, 37)]
    + [(n, "lines") for n in (8192, 16384, 7680)]
    + [(131, None), (2 * 131, None)]))
def test_minor_form(n, expected):
    """K20 runs K1's form for the length (the line form at powers of two
    up to 4096, at K1's mixed-radix lengths, 93, 480 and 960 among them,
    and at its three-factor lengths above 4096, 7680, 8192 and 16384 among
    them); the gate is unchanged."""
    assert fused_fft.minor_form(n) == expected
    assert (expected is not None) == fused_fft.minor_supported(
        n, torch.float32)


@pytest.mark.parametrize("n,M,L,dtype,expected", [
    (128, 128, 128, torch.float32, "lines"),     # P3's K18
    (128, 1, 256, torch.float32, "lines"),       # P4's K19
    (64, 128, 256, torch.float32, "lines"),      # P4's K18
    (64, 4096, 64, torch.bfloat16, "lines"),     # P2's K18 in bf16
    (640, 5, 2, torch.float32, "lines"),         # 10 columns of 5 halves
    (2048, 1, 8, torch.float32, "lines"),
    (2048, 1, 8, torch.bfloat16, "stages"),      # 16 columns, 1024 lanes
    (8, 1, 7, torch.float32, "stages"),          # under 8 columns
    (96, 2, 7, torch.bfloat16, "stages"),        # under 16 bf16 columns
    (93, 128, 128, torch.float32, "lines"),      # T1's length (3 x 31)
    (4096, 3, 8, torch.float32, "lines"),       # the cluster form
    (131, 3, 8, torch.float32, None),
    (2048, 2, 8, torch.bfloat16, "lines"),      # bf16's cluster form
    (4100, 3, 8, torch.float32, "stages")])     # on no list
def test_inner_form(n, M, L, dtype, expected, monkeypatch):
    """K18/K19 run the strided kernel's form for the (pre, n, M L) logical
    planes: the line form at n = r 2^a, r in {1, 3, 5}, 8 to 2048, and the
    cluster form at its lists' lengths (f32 from 2160, bf16 from 1080), on
    at least 8 f32 (16 bf16) columns, whatever M and L split them into. The
    library's geometry query is answered by the model
    (``test_torch_strided_geometry.use_model``)."""
    use_model(monkeypatch)
    assert fused_fft.inner_form(n, M, L, dtype) == expected
    assert (expected is not None) == fused_fft.inner_supported(n, dtype)


@pytest.mark.parametrize("kernel,shape", [
    ("cube", (2, 3, 16, 24)), ("pair", (3, 7, 93)), ("minor", (5, 93)),
    ("inner", (3, 5, 7, 93)), ("inner_m1", (2, 93, 5))])
def test_wrappers_odd_halves_on_the_cpu(kernel, shape):
    """Halves and lengths outside tpufft's TPU envelopes (odd, not a lane
    multiple) against np.fft, both directions."""
    _, _, ours, axes = KERNELS[kernel]
    st, x = _fused(shape, seed=sum(shape))
    n_total = int(np.prod([shape[a] for a in axes]))
    for inverse in (False, True):
        got = ours(torch.from_numpy(st), inverse=inverse, scale=0.5).numpy()
        fn = np.fft.ifftn if inverse else np.fft.fftn
        want = fn(x, axes=axes) * 0.5 * (n_total if inverse else 1)
        assert _err(_unfuse(got), want) < 1e-5


def test_wrappers_refuse_non_cuda_devices():
    x = torch.empty(2, 8, 8, 16, device="meta")
    for fn, arr in ((fused_fft.fft_cube_fused, x),
                    (fused_fft.fft_pair_fused, x[0]),
                    (fused_fft.fft_inner_fused, x),
                    (fused_fft.fft_minor_fused, x[0, 0])):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(arr, inverse=False, scale=1.0)

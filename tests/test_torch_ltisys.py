"""The port's LTI systems against tpufft.ltisys and scipy.signal.

Host results (representations, conversions, discretization, the host
simulations, frequency responses, pole placement) come from the same
float64 numpy code in both packages and agree to 1e-12 of their size;
that holds for the iterative MIMO ``place_poles`` too (the same
projections in the same order). ``dlsim`` on a tensor runs the port's
log-depth scan on the tensor's device: in float64 it is held to 1e-12 of
the output's size against tpufft's exact host loop and to 1e-5 against
tpufft's jax scan (which computes in float32 whatever the input); in
float32 to 1e-5 against tpufft's jax scan (two float32 scans in a
different order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpufft import ltisys as TL

import tpufft_torch
from tpufft_torch import ltisys as L
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

TOL = 1e-12
F32_TOL = 1e-5


def _same(got, ref, tol=TOL):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if isinstance(ref, jax.Array):
        ref = np.asarray(ref)
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.size:
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.max(np.abs(got - ref)) <= tol * scale


@pytest.fixture(scope="module")
def sysc():
    return sps.butter(3, 2.0, analog=True)


@pytest.fixture(scope="module")
def sysd():
    return sps.cont2discrete(
        sps.tf2ss(*sps.butter(3, 2.0, analog=True)), 0.05)


def _mimo(nst=5, nin=3, nout=2, dt=0.1, seed=0):
    """A seeded stable continuous system, discretized by zoh."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nst, nst))
    A -= (np.max(np.real(np.linalg.eigvals(A))) + 0.5) * np.eye(nst)
    B = rng.standard_normal((nst, nin))
    C = rng.standard_normal((nout, nst))
    D = rng.standard_normal((nout, nin))
    return L.cont2discrete((A, B, C, D), dt)


@pytest.mark.parametrize("n", [1, 3, 6])
@pytest.mark.parametrize("scale", [0.1, 1.0, 40.0])
def test_expm(n, scale):
    A = np.random.default_rng(n * 7 + int(scale * 10)).standard_normal(
        (n, n)) * scale
    _same(L.expm(A), TL.expm(A))
    _same(L.expm(A * (1 + 0.5j)), TL.expm(A * (1 + 0.5j)))


TF_CASES = [
    ([1.0, 3.0, 3.0], [1.0, 2.0, 1.0]),
    ([2.0], [1.0, 2.0, 1.0]),
    ([1.0, 0.0], [2.0, 1.0, 3.0]),
    ([[1.0, 3.0], [2.0, 1.0]], [1.0, 0.4]),
    ([3.0], [2.0]),
]


@pytest.mark.parametrize("num,den", TF_CASES)
def test_tf_ss_roundtrip(num, den):
    m = L.tf2ss(num, den)
    _same(m, TL.tf2ss(num, den))
    if len(den) > 1:      # scipy gives a static gain one zero state
        for a, b in zip(m, sps.tf2ss(num, den)):
            np.testing.assert_allclose(a, b, atol=1e-12)
        _same(L.ss2tf(*m), TL.ss2tf(*m))


def test_zpk_ss_and_abcd():
    z, p, k = sps.butter(3, 0.4, output="zpk")
    m = L.zpk2ss(z, p, k)
    _same(m, TL.zpk2ss(z, p, k))
    _same(L.ss2zpk(*m), TL.ss2zpk(*m))
    A, B, C, D = _mimo()[:4]
    for inp in range(3):
        _same(L.ss2tf(A, B, C, D, input=inp), TL.ss2tf(A, B, C, D, input=inp))
        _same(L.ss2zpk(A, B, C[:1], D[:1], input=inp),
              TL.ss2zpk(A, B, C[:1], D[:1], input=inp))
    _same(L.abcd_normalize(A=A, B=B, C=np.zeros((2, 5))),
          TL.abcd_normalize(A=A, B=B, C=np.zeros((2, 5))))
    _same(L.abcd_normalize(B=B, D=D), TL.abcd_normalize(B=B, D=D))
    with pytest.raises(ValueError):
        L.abcd_normalize(A=A, B=B)
    with pytest.raises(ValueError, match="input"):
        L.ss2tf(A, B, C, D, input=5)


@pytest.mark.parametrize("method,kw", [
    ("zoh", {}), ("foh", {}), ("bilinear", {}), ("euler", {}),
    ("backward_diff", {}), ("gbt", dict(alpha=0.3)), ("impulse", {}),
])
def test_cont2discrete_methods(sysc, method, kw):
    ss = sps.tf2ss(*sysc)
    m = L.cont2discrete(ss, 0.05, method=method, **kw)
    _same(m[:4], TL.cont2discrete(ss, 0.05, method=method, **kw)[:4])
    r = sps.cont2discrete(ss, 0.05, method=method, **kw)
    for a, b in zip(m[:4], r[:4]):
        np.testing.assert_allclose(a, b, atol=1e-10)
    assert m[4] == r[4]


def test_cont2discrete_flavors(sysc):
    _same(L.cont2discrete(sysc, 0.1, "zoh")[:2],
          TL.cont2discrete(sysc, 0.1, "zoh")[:2])
    zpk = sps.butter(2, 3.0, analog=True, output="zpk")
    _same(L.cont2discrete(zpk, 0.1, "bilinear")[:3],
          TL.cont2discrete(zpk, 0.1, "bilinear")[:3])
    with pytest.warns(L.BadCoefficients):
        dm = L.cont2discrete(L.TransferFunction(*sysc), 0.05)
    assert isinstance(dm, L.TransferFunction) and dm.dt == 0.05
    with pytest.warns(TL.BadCoefficients):
        dr = TL.cont2discrete(TL.TransferFunction(*sysc), 0.05)
    _same((dm.num, dm.den), (dr.num, dr.den))
    sz = L.cont2discrete(L.ZerosPolesGain(*zpk), 0.1)
    assert isinstance(sz, L.ZerosPolesGain)
    ss = L.cont2discrete(L.StateSpace(*sps.tf2ss(*sysc)), 0.1)
    assert isinstance(ss, L.StateSpace)
    _same((ss.A, ss.B, ss.C, ss.D),
          TL.cont2discrete(sps.tf2ss(*sysc), 0.1)[:4])
    with pytest.raises(ValueError):
        L.cont2discrete(sysc, 0.1, method="bogus")
    with pytest.raises(ValueError):
        L.cont2discrete(sysc, 0.1, method="gbt")


def test_dlsim_host(sysd):
    rng = np.random.default_rng(1)
    u = rng.standard_normal(60)
    for x0 in (None, rng.standard_normal(3)):
        m = L.dlsim(sysd, u, x0=x0)
        assert isinstance(m[1], np.ndarray)
        _same(m, TL.dlsim(sysd, u, x0=x0))
    bz, az = sps.butter(3, 0.4)
    m = L.dlsim((bz, az, 1.0), u)
    assert len(m) == 2
    _same(m, TL.dlsim((bz, az, 1.0), u))
    t = np.linspace(0, 2.9, 40)
    _same(L.dlsim(sysd, u[:40], t=t), TL.dlsim(sysd, u[:40], t=t))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["siso", "siso_x0", "mimo", "tf", "long"])
def test_dlsim_tensor_scan(sysd, dtype, case):
    """A tensor input runs the port's scan where it lies and stays a
    tensor in its dtype; held against tpufft's jax scan and, in float64,
    against the exact host loop."""
    rng = np.random.default_rng(2)
    n = 3000 if case == "long" else 60
    system, x0 = sysd, None
    if case == "siso_x0":
        x0 = rng.standard_normal(3)
    if case == "mimo":
        system = _mimo()
        x0 = rng.standard_normal(5)
        u = rng.standard_normal((n, 3))
    else:
        u = rng.standard_normal(n)
    if case == "tf":
        system = sps.butter(4, 0.3) + (0.5,)
    u = u.astype(dtype)
    got = L.dlsim(system, torch.from_numpy(u), x0=x0)
    ref = TL.dlsim(system, jnp.asarray(u), x0=x0)
    assert len(got) == len(ref)
    _same(got[0], ref[0])
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for g in got[1:]:
        assert isinstance(g, torch.Tensor) and g.dtype == tdt
    _same(got[1:], ref[1:], F32_TOL)
    if dtype == np.float64:
        _same(got, TL.dlsim(system, u, x0=x0))


def test_dlsim_tensor_with_t_interpolates_on_device(sysd):
    """With ``t`` the tensor input is interpolated onto the dt grid where
    it lies; the values are tpufft's (which interpolates on the host)."""
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 3.0, 50))
    t[0] = 0.0
    u = rng.standard_normal((50, 1))
    got = L.dlsim(sysd, torch.from_numpy(u), t=t)
    assert isinstance(got[1], torch.Tensor)
    _same(got, TL.dlsim(sysd, u, t=t))
    got = L.dlsim(sysd, torch.from_numpy(u.astype(np.float32)), t=t)
    assert got[1].dtype == torch.float32
    _same(got, TL.dlsim(sysd, u.astype(np.float32), t=t), F32_TOL)


def test_dlsim_tensor_edges(sysd):
    """One step, a stateless system and an integer tensor."""
    u = torch.tensor([0.5])
    _same(L.dlsim(sysd, u.double(), x0=[1.0, 2.0, 3.0]),
          TL.dlsim(sysd, np.array([0.5]), x0=[1.0, 2.0, 3.0]))
    stateless = (np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)),
                 np.array([[2.0]]), 1.0)
    got = L.dlsim(stateless, torch.arange(5.0, dtype=torch.float64))
    _same(got, TL.dlsim(stateless, np.arange(5.0)))
    got = L.dlsim(sysd, torch.arange(6))
    assert got[1].dtype == torch.float32
    _same(got[1], TL.dlsim(sysd, np.arange(6.0))[1], F32_TOL)


def test_dimpulse_dstep(sysd):
    bz, az = sps.butter(3, 0.4)
    _same(L.dimpulse((bz, az, 0.5), n=40), TL.dimpulse((bz, az, 0.5), n=40))
    _same(L.dstep(sysd, n=40), TL.dstep(sysd, n=40))
    m = _mimo()
    _same(L.dstep(m, n=30, x0=np.ones(5)), TL.dstep(m, n=30, x0=np.ones(5)))
    _same(L.dimpulse(m, t=np.arange(25) * 0.1),
          TL.dimpulse(m, t=np.arange(25) * 0.1))


@pytest.mark.parametrize("interp", [True, False])
def test_lsim(sysc, interp):
    rng = np.random.default_rng(3)
    T = np.linspace(0, 5, 201)
    U = np.sin(2 * T) + 0.1 * rng.standard_normal(T.size)
    _same(L.lsim(sysc, U, T, interp=interp), TL.lsim(sysc, U, T,
                                                     interp=interp))
    X0 = rng.standard_normal(3)
    ss = sps.tf2ss(*sysc)
    _same(L.lsim(ss, U, T, X0=X0, interp=interp),
          TL.lsim(ss, U, T, X0=X0, interp=interp))
    np.testing.assert_allclose(L.lsim(sysc, U, T, interp=interp)[1],
                               sps.lsim(sysc, U, T, interp=interp)[1],
                               atol=1e-7)
    with pytest.raises(ValueError):
        L.lsim(sysc, U, np.concatenate([T[:10], T[20:30]]))


def test_impulse_step(sysc):
    _same(L.impulse(sysc), TL.impulse(sysc))
    _same(L.impulse(sysc, X0=[1.0, 0.0, 0.0], N=50),
          TL.impulse(sysc, X0=[1.0, 0.0, 0.0], N=50))
    T = np.linspace(0, 5, 201)
    _same(L.step(sysc, T=T), TL.step(sysc, T=T))
    _same(L.step(sysc), TL.step(sysc))


def test_freqresp_bode(sysc):
    w = np.logspace(-1, 2, 60)
    _same(L.freqresp(sysc, w=w), TL.freqresp(sysc, w=w))
    _same(L.freqresp(sysc, n=100), TL.freqresp(sysc, n=100))
    _same(L.bode(sysc, w=w), TL.bode(sysc, w=w))
    zpk = sps.butter(3, 1.5, analog=True, output="zpk")
    _same(L.bode(zpk, n=40), TL.bode(zpk, n=40))
    bz, az = sps.butter(3, 0.4)
    _same(L.dfreqresp((bz, az, 0.5), n=128),
          TL.dfreqresp((bz, az, 0.5), n=128))
    _same(L.dfreqresp((bz, az, 0.5), w=np.linspace(0, 3, 20)),
          TL.dfreqresp((bz, az, 0.5), w=np.linspace(0, 3, 20)))
    _same(L.dbode((bz, az, 0.5)), TL.dbode((bz, az, 0.5)))
    for mine, ref in zip(L.dbode((bz, az, 0.5)), sps.dbode((bz, az, 0.5))):
        np.testing.assert_allclose(mine, ref, atol=1e-9)
    A, B, C, D = sps.tf2ss(*sps.butter(2, 0.3))
    with pytest.raises(ValueError):
        L.freqresp((A, B, np.vstack([C, C]), np.vstack([D, D])), w=np.ones(8))


def test_classes(sysc):
    s1 = L.TransferFunction(*sysc)
    r1 = TL.TransferFunction(*sysc)
    _same((s1.num, s1.den), (r1.num, r1.den))
    _same(np.sort_complex(s1.poles), np.sort_complex(r1.poles))
    _same(s1.to_ss().A, r1.to_ss().A)
    _same(s1.to_zpk().gain, r1.to_zpk().gain)
    T = np.linspace(0, 5, 201)
    _same(s1.step(T=T), r1.step(T=T))
    _same(s1.impulse(T=T), r1.impulse(T=T))
    _same(s1.output(np.ones(201), T), r1.output(np.ones(201), T))
    w = np.logspace(-1, 2, 40)
    _same(s1.bode(w=w), r1.bode(w=w))
    _same(s1.freqresp(w=w), r1.freqresp(w=w))
    assert isinstance(L.lti(*sysc), L.TransferFunction)
    assert isinstance(L.lti(*sps.butter(2, 1.0, analog=True,
                                        output="zpk")), L.ZerosPolesGain)
    assert isinstance(L.lti(*sps.tf2ss(*sysc)), L.StateSpace)
    assert repr(s1).startswith("TransferFunction(")
    bz, az = sps.butter(3, 0.4)
    dsys = L.dlti(bz, az, dt=0.5)
    rsys = TL.dlti(bz, az, dt=0.5)
    _same(dsys.impulse(N=30), rsys.impulse(N=30))
    _same(dsys.step(N=30), rsys.step(N=30))
    _same(dsys.bode(n=30), rsys.bode(n=30))
    _same(dsys.freqresp(n=30), rsys.freqresp(n=30))
    u = np.random.default_rng(0).standard_normal(30)
    _same(dsys.output(u, None), rsys.output(u, None))
    got = dsys.output(torch.from_numpy(u), None)
    assert isinstance(got[1], torch.Tensor)
    _same(got, rsys.output(u, None))
    ss = L.StateSpace(dsys)
    assert ss.dt == 0.5 and isinstance(ss, L.StateSpace)
    _same(np.sort_complex(ss.poles), np.sort_complex(
        TL.StateSpace(rsys).poles))
    zg = L.ZerosPolesGain([1j, -1j], [-1, -2], 2 + 1j)
    assert zg.gain == TL.ZerosPolesGain([1j, -1j], [-1, -2], 2 + 1j).gain
    with pytest.raises(ValueError):
        L.dlsim(L.TransferFunction(*sysc), np.zeros(4))
    with pytest.raises(ValueError):
        L.lsim(dsys, np.zeros(4), np.arange(4.0))
    with pytest.raises(ValueError):
        L.lti(1, 2, 3, 4, 5)


class TestPlacePoles:
    def test_siso(self):
        A = np.array([[0., 1.], [-2., -3.]])
        B = np.array([[0.], [1.]])
        for poles in ([-5., -6.], [-2 + 1j, -2 - 1j]):
            fm = L.place_poles(A, B, poles)
            fr = TL.place_poles(A, B, poles)
            _same((fm.gain_matrix, fm.computed_poles, fm.requested_poles),
                  (fr.gain_matrix, fr.computed_poles, fr.requested_poles))
        np.testing.assert_allclose(
            L.place_poles(A, B, [-5., -6.]).gain_matrix,
            sps.place_poles(A, B, [-5., -6.]).gain_matrix, atol=1e-9)

    @pytest.mark.parametrize("poles", [
        [-1., -2., -3., -4.],
        [-1 + 1j, -1 - 1j, -2., -3.],
        [-2., -2., -3., -4.],
    ])
    @pytest.mark.parametrize("method", ["YT", "KNV0"])
    def test_mimo(self, poles, method):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((4, 4))
        B = rng.standard_normal((4, 2))
        fm = L.place_poles(A, B, poles, method=method)
        fr = TL.place_poles(A, B, poles, method=method)
        _same((fm.gain_matrix, fm.computed_poles, fm.X),
              (fr.gain_matrix, fr.computed_poles, fr.X))
        assert fm.nb_iter == fr.nb_iter
        cp = np.linalg.eigvals(A - B @ fm.gain_matrix)
        np.testing.assert_allclose(
            np.sort_complex(cp), np.sort_complex(np.asarray(poles, complex)),
            atol=1e-5)

    def test_errors_and_warning(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((4, 4))
        B = rng.standard_normal((4, 2))
        with pytest.raises(ValueError):
            L.place_poles(A, B, [-1., -1., -1., -2.])
        with pytest.raises(ValueError):
            L.place_poles(A, B, [-1 + 1j, -2., -3., -4.])
        with pytest.raises(ValueError):
            L.place_poles(A, B, [-1., -2.])
        with pytest.raises(ValueError):
            L.place_poles(A, np.zeros((4, 2)), [-1., -2., -3., -4.])
        with pytest.warns(UserWarning, match="Convergence"):
            L.place_poles(A, B, [-1., -2., -3., -4.], maxiter=1)


def test_top_level_names_are_the_modules():
    for name in L.__all__:
        if hasattr(tpufft_torch, name) and name != "BadCoefficients":
            assert getattr(tpufft_torch, name) is getattr(L, name)
    assert tpufft_torch.BadCoefficients is L.BadCoefficients

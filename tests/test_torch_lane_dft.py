"""A model of the shared generic-radix lane DFT (``csrc/lane_dft.cuh``) in
torch ops, float64, against ``np.fft.fft``.

The model follows the header step by step: ``first_radix`` (8, 4 at 16, 2,
then the smallest odd prime), the first radix over registers b + B a with
the twiddles W_N^(a b) read from an n-table at stride kTab = n / N, the
B-long sub-lines, and the output order ``lane_out`` (register b + B a holds
X[a + A out_B(b)]); ``lane_dft_emit``'s indices (sub-line a's output q is
X[a + A q]); the radices 3 and 5 with the kernels' f32 literal constants,
the exact butterflies 2, 4, 8, and the conjugate-pair sum of an odd prime P
from 7 to 31 (a_b = x_b + x_(P-b), d_b = x_b - x_(P-b); X_j, X_(P-j) = x0 +
sum a_b c_jb +- i sum d_b s_jb with W_P^(j b) read from the table at (j b
mod P) n / P); and ``pair_dft`` (a line of 2M on two lanes). Every radix
and every line length that the minor-axis and strided line forms
instantiate is checked, forward and inverse, to 1e-6 (the f32 literals of
radix 3 and 5 limit it to ~1e-7).
"""

import numpy as np
import pytest
import torch

from tpufft_torch.kernels import minor_fft

from test_torch_strided_geometry import SPLITS

PRIMES = (7, 11, 13, 17, 19, 23, 29, 31)
C3 = float(np.float32(0.86602540378443864676))
C5 = (float(np.float32(0.30901699437494742410)),
      float(np.float32(-0.80901699437494742410)),
      float(np.float32(0.95105651629515357212)),
      float(np.float32(0.58778525229247312917)))


def _odd_prime(n):
    p = 3
    while p * p <= n:
        if n % p == 0:
            return p
        p += 2
    return n


def first_radix(n):
    return (8 if n % 8 == 0 and n != 16 else 4 if n % 4 == 0
            else 2 if n % 2 == 0 else _odd_prime(n))


def max_prime(n):
    best, p = 1, 2
    while n > 1:
        while n % p == 0:
            best, n = p, n // p
        p += 1
    return best


def lane_out(n, r):
    if n == 1:
        return 0
    a = first_radix(n)
    b = n // a
    return r // b + a * lane_out(b, r % b)


def pair_out(m, p, r):
    h = m // 2
    return lane_out(m, r % h + h * p) + m * (r // h)


def table(n, inverse):
    k = np.arange(n)
    return torch.from_numpy(np.exp((1j if inverse else -1j) * 2 * np.pi * k / n))


def prime_emit(t, p, tab, kstep):
    """The conjugate-pair sum on the last dim of t (p values): the outputs
    in the order the kernel emits them, as (index, value) pairs."""
    h = p // 2
    a = [t[..., b] + t[..., p - b] for b in range(1, h + 1)]
    d = [t[..., b] - t[..., p - b] for b in range(1, h + 1)]
    out = [(0, t[..., 0] + sum(a))]
    for j in range(1, h + 1):
        c = t[..., 0].clone()
        e = torch.zeros_like(c)
        for b in range(1, h + 1):
            w = tab[(j * b) % p * kstep]
            c = c + w.real * a[b - 1]
            e = e + w.imag * d[b - 1]
        out += [(j, c + 1j * e), (p - j, c - 1j * e)]
    return out


def radix_dft(t, r, inverse):
    """The radix-r DFT over the last dim, as ``radix_dft<r>`` (r in 2, 3,
    4, 5, 8; an odd prime from 7 runs only in ``lane_dft_emit``)."""
    if r == 3:
        s = -C3 if inverse else C3
        x0, x1, x2 = t.unbind(-1)
        tt, d = x1 + x2, x1 - x2
        m = x0 - 0.5 * tt
        isd = s * (d.imag - 1j * d.real)                 # -i s d
        return torch.stack([x0 + tt, m + isd, m - isd], -1)
    if r == 5:
        c1, c2, s1, s2 = C5
        if inverse:
            s1, s2 = -s1, -s2
        x0, x1, x2, x3, x4 = t.unbind(-1)
        a1, d1, a2, d2 = x1 + x4, x1 - x4, x2 + x3, x2 - x3
        m1, m2 = x0 + c1 * a1 + c2 * a2, x0 + c2 * a1 + c1 * a2
        e1, e2 = s1 * d1 + s2 * d2, s2 * d1 - s1 * d2
        ie1, ie2 = e1.imag - 1j * e1.real, e2.imag - 1j * e2.real
        return torch.stack([x0 + a1 + a2, m1 + ie1, m2 + ie2, m2 - ie2,
                            m1 - ie1], -1)
    assert r in (2, 4, 8), r
    k = np.arange(r)
    w = np.exp((1j if inverse else -1j) * 2 * np.pi * np.outer(k, k) / r)
    return t @ torch.from_numpy(w.T)


def first_stage(x, n, ktab, tab, inverse):
    a = first_radix(n)
    b = n // a
    y = x.reshape(*x.shape[:-1], a, b).transpose(-1, -2)      # [b, a]
    y = radix_dft(y, a, inverse)
    ab = torch.outer(torch.arange(b), torch.arange(a))
    return (y * tab[ab * ktab]).transpose(-1, -2).reshape(x.shape)


def lane_dft(x, n, ktab, tab, inverse):
    """``lane_dft<n, ktab>``: register i ends holding X[lane_out(n, i)]."""
    a = first_radix(n)
    b = n // a
    y = first_stage(x, n, ktab, tab, inverse)
    if b == 1:
        return y
    subs = [lane_dft(y[..., b * i:b * (i + 1)], b, ktab * a, tab, inverse)
            for i in range(a)]
    return torch.cat(subs, -1)


def lane_dft_emit(x, n, ktab, tab, inverse):
    """``lane_dft_emit<n, ktab>``: the (index, value) pairs it hands over."""
    a = first_radix(n)
    b = n // a
    if b == 1:
        if a % 2 and a >= 7:
            return prime_emit(x, a, tab, ktab)
        y = radix_dft(x, a, inverse)
        return [(i, y[..., i]) for i in range(a)]
    y = first_stage(x, n, ktab, tab, inverse)
    out = []
    for i in range(a):
        out += [(i + a * q, v) for q, v in
                lane_dft_emit(y[..., b * i:b * (i + 1)], b, ktab * a, tab,
                              inverse)]
    return out


def pair_dft(x, m, ktab, tab, inverse):
    """``pair_dft<m, ktab>`` on a line of 2m (natural order): lane p
    transforms x[p + 2 i], the pair swaps m / 2 values, register r of lane
    p ends holding X[pair_out(m, p, r)]; both lanes' registers, (..., 2,
    m)."""
    h = m // 2
    f = [lane_dft(x[..., p::2], m, 2 * ktab, tab, inverse) for p in (0, 1)]
    lanes = []
    for p in (0, 1):
        regs = torch.arange(h) + h * p
        k = torch.tensor([lane_out(m, int(r)) for r in regs])
        a, b = f[0][..., regs], f[1][..., regs] * tab[k * ktab]
        lanes.append(torch.cat([a + b, a - b], -1))
    return torch.stack(lanes, -2)


def _lines():
    """Every line length the line forms instantiate: in one lane (<= 32) or
    on a pair (34 to 64, as its half)."""
    lane, pair = set(PRIMES), set()
    splits = ([g[:2] for g in minor_fft._FOUR_STEP.values()]
              + [g[:3] for g in minor_fft._LONG_STEP.values()]
              + list(SPLITS.values()))
    for split in splits:
        for m in split:
            if m > 32:
                pair.add(m)
            elif m > 1:
                lane.add(m)
    return sorted(lane), sorted(pair)


LANE_NS, PAIR_NS = _lines()


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))


def _err(got, ref):
    return float(np.max(np.abs(got - ref)) / max(1.0, np.max(np.abs(ref))))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", LANE_NS)
def test_lane_dft_matches_numpy(n, inverse):
    """A line of n in one lane (each radix and every instantiated length):
    ``lane_dft`` in place, register i holding X[lane_out(n, i)], where n's
    primes are 2, 3 and 5, and ``lane_dft_emit`` handing over each X[k]
    once at every n, on a table of 3 n entries (kTab = 3, as a line of a
    four-step reads the n-table at a stride), against ``np.fft``."""
    x = _x((4, n), n)
    tab = table(3 * n, inverse)
    ref = (np.fft.ifft(x.numpy(), axis=-1) * n if inverse
           else np.fft.fft(x.numpy(), axis=-1))
    if max_prime(n) < 7:
        got = lane_dft(x, n, 3, tab, inverse).numpy()
        order = [lane_out(n, i) for i in range(n)]
        assert sorted(order) == list(range(n))
        assert _err(got, ref[:, order]) < 1e-6
    emitted = lane_dft_emit(x, n, 3, tab, inverse)
    assert sorted(k for k, _ in emitted) == list(range(n))
    out = np.empty_like(ref)
    for k, v in emitted:
        out[:, k] = v.numpy()
    assert _err(out, ref) < 1e-6


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", PAIR_NS)
def test_pair_dft_matches_numpy(n, inverse):
    """A line of n (34 to 64, even) on a lane pair: register r of lane p
    holds X[pair_out(n / 2, p, r)], every output once."""
    m = n // 2
    x = _x((4, n), n + 1)
    tab = table(2 * n, inverse)
    ref = (np.fft.ifft(x.numpy(), axis=-1) * n if inverse
           else np.fft.fft(x.numpy(), axis=-1))
    got = pair_dft(x, m, 2, tab, inverse).numpy()
    order = [[pair_out(m, p, r) for r in range(m)] for p in (0, 1)]
    assert sorted(order[0] + order[1]) == list(range(n))
    for p in (0, 1):
        assert _err(got[:, p], ref[:, order[p]]) < 1e-6


@pytest.mark.parametrize("p", PRIMES)
def test_prime_radix_is_a_conjugate_pair_sum(p):
    """The odd-prime radix alone: X_0 first, then each pair X_j, X_(p-j),
    reading W_p^(j b) at (j b mod p) kStep of the table; the first radix
    of a line of p is p itself and the line's largest prime selects the
    emitting form."""
    assert first_radix(p) == p and max_prime(p) == p
    x = _x((3, p), p)
    for inverse in (False, True):
        tab = table(5 * p, inverse)
        emitted = prime_emit(x, p, tab, 5)
        assert [k for k, _ in emitted] == [0] + [
            k for j in range(1, p // 2 + 1) for k in (j, p - j)]
        ref = (np.fft.ifft(x.numpy(), axis=-1) * p if inverse
               else np.fft.fft(x.numpy(), axis=-1))
        out = np.empty_like(ref)
        for k, v in emitted:
            out[:, k] = v.numpy()
        assert _err(out, ref) < 1e-12

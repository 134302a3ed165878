"""Host tables of the port are bit-identical to tpufft's: the Stockham
stage tables and the minor kernel's factorization tables."""

import numpy as np
import pytest

from tpufft import twiddle as tp_twiddle
from tpufft.kernels import mxu_fft as tp_mxu

from tpufft_torch import twiddle
from tpufft_torch.kernels import minor_fft
from tpufft_torch.planner import default_bases
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

NS = [8, 93, 128, 256, 1024, 1792]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", NS)
def test_stage_tables_equal(n, inverse):
    for scale in (1.0, 1.0 / n):
        ours = twiddle.stage_tables(n, default_bases(n), inverse, scale)
        theirs = tp_twiddle.stage_tables(n, default_bases(n), inverse, scale)
        assert len(ours) == len(theirs)
        for (st, w, tw), (tst, tw_w, tw_tw) in zip(ours, theirs):
            assert (st.radix, st.m, st.s, st.n) == (tst.radix, tst.m,
                                                     tst.s, tst.n)
            assert np.array_equal(w, tw_w)
            assert np.array_equal(tw, tw_tw)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", NS)
def test_minor_kernel_tables_equal(n, inverse):
    for scale in (1.0, 1.0 / n):
        ours = minor_fft._tables(n, inverse, scale)
        theirs = tp_mxu._tables(n, inverse, scale)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b)

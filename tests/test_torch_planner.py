"""tpufft_torch's config and planner against tpufft's, value for value."""

import dataclasses

import pytest

import tpufft
from tpufft import planner as tp_planner
from tpufft.config import PlanConfig as TPPlanConfig
from tpufft.kernels import mxu_fft as tp_mxu

import tpufft_torch
from tpufft_torch import planner
from tpufft_torch.config import PlanConfig
from _tpufft_caches import cold_tpufft_caches  # noqa: F401

LENGTHS = range(1, 2049)


def test_planconfig_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(PlanConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(TPPlanConfig)]
    assert ours == theirs
    assert dataclasses.asdict(PlanConfig()) == dataclasses.asdict(
        TPPlanConfig())


@pytest.mark.parametrize("kw", [
    {}, {"profile": "fast"}, {"profile": "fast", "precision": "highest"},
    {"profile": "fast", "plane_dtype": "float32"}, {"backend": "xla"},
    {"backend": "pallas", "lane_block": 256, "interpret": True},
])
def test_planconfig_profile_resolution(kw):
    assert dataclasses.asdict(PlanConfig(**kw)) == dataclasses.asdict(
        TPPlanConfig(**kw))


@pytest.mark.parametrize("kw", [
    {"profile": "slow"}, {"backend": "cuda"}, {"precision": "fp8"},
    {"plane_dtype": "float16"},
])
def test_planconfig_errors(kw):
    with pytest.raises(ValueError) as theirs:
        TPPlanConfig(**kw)
    with pytest.raises(ValueError) as ours:
        PlanConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_factorize_and_default_bases():
    for n in LENGTHS:
        assert planner.factorize(n) == tp_planner.factorize(n), n
        assert planner.default_bases(n) == tp_planner.default_bases(n), n
    for r in (4, 8, 32):
        for n in (96, 1000, 1024, 4096):
            assert (planner.default_bases(n, r)
                    == tp_planner.default_bases(n, r))


def test_stage_schedule():
    for n in LENGTHS:
        b = tp_planner.default_bases(n)
        ours = [dataclasses.astuple(s) for s in planner.stage_schedule(n, b)]
        theirs = [dataclasses.astuple(s)
                  for s in tp_planner.stage_schedule(n, b)]
        assert ours == theirs, n


@pytest.mark.parametrize("bases", [(2, 3), (0, 12), (5,)])
def test_validate_bases_errors(bases):
    with pytest.raises(ValueError):
        tp_planner.validate_bases(12, bases)
    with pytest.raises(ValueError):
        planner.validate_bases(12, bases)


def test_kernel_factors_copy():
    for n in list(LENGTHS) + [2 * 131, 127 * 127, 127 * 129, 16384, 16385]:
        assert planner.kernel_factors(n) == tp_mxu.kernel_factors(n), n


@pytest.mark.parametrize("aligned", [False, True])
def test_fast_lengths(aligned):
    for n in list(range(0, 700)) + [1000, 4097, 16385, 16500, 100003]:
        assert (tpufft_torch.next_fast_len(n, aligned=aligned)
                == tpufft.next_fast_len(n, aligned=aligned)), n
        assert (tpufft_torch.prev_fast_len(n, aligned=aligned)
                == tpufft.prev_fast_len(n, aligned=aligned)), n

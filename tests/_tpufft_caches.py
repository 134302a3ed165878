"""A fixture that leaves tpufft's module-level caches as cold as a test
module found them.

tpufft caches built kernels and runners with ``functools.lru_cache``
(``spectral._welch_fused``, ``_istft_fused``, ``_istft_fused_mat`` and
many more). Some of its tests assert log lines that are written only when
a kernel is built, so they fail when a test of the port, run earlier in
the same process, has warmed the cache with the same key. Each
``tests/test_torch_*.py`` that calls tpufft imports this fixture::

    from _tpufft_caches import cold_tpufft_caches  # noqa: F401

and at the end of the module every ``functools`` cache in the namespace of
a loaded ``tpufft`` or ``tpufft.*`` module (not ``tpufft_torch``) is
cleared.
"""

import functools
import sys

import pytest


def clear_tpufft_caches() -> int:
    """Clear every module-level ``functools`` cache of the loaded tpufft
    modules; returns how many caches were cleared."""
    seen = set()
    for name, module in list(sys.modules.items()):
        if module is None or not (name == "tpufft"
                                  or name.startswith("tpufft.")):
            continue
        for value in list(vars(module).values()):
            if (isinstance(value, functools._lru_cache_wrapper)
                    and id(value) not in seen):
                seen.add(id(value))
                value.cache_clear()
    return len(seen)


@pytest.fixture(scope="module", autouse=True)
def cold_tpufft_caches():
    yield
    clear_tpufft_caches()

import os
import sys

import pytest

# Make `import repro` work regardless of how pytest is invoked.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device; only launch/dryrun.py forces 512 host devices.

#: Size cap for tests that execute Pallas kernels in ``interpret=True`` mode
#: (the kernel body runs eagerly in Python on CPU — correct but orders of
#: magnitude slower than compiled XLA, so full factorizations through the
#: Pallas backend must stay tiny).  Shared so every test module sizes its
#: pallas-path cases the same way; direct single-kernel validation tests may
#: exceed it per-shape, full DMF sweeps must not.
PALLAS_MAX_N = 32

# CI runs the suite as two lanes — `-m "not pallas"` (fast) and `-m pallas`
# (interpret-mode kernels).  The pallas lane is only tractable because of
# the cap above; treat it as a contract, not a tunable.
assert PALLAS_MAX_N <= 32, "pallas-interpret tests must stay at n <= 32"

#: Modules that are Pallas-kernel validation end to end.
_PALLAS_MODULES = frozenset({"test_kernels", "test_kernels_wkv"})
#: Nodeid fragments that identify a Pallas-executing case anywhere else:
#: the pallas backend, and the la_mb variant (whose lu/cholesky resolution
#: is the fused Pallas kernel; for other DMFs la_mb aliases la, so a few
#: cheap jnp cases ride along — conservative routing, never the reverse).
_PALLAS_TOKENS = ("pallas", "la_mb")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "pallas: exercises Pallas kernels in interpret mode — the slow CI "
        "lane (`-m pallas`); everything else runs in the fast lane")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips inside a fixture without one")


def pytest_collection_modifyitems(config, items):
    for item in items:
        module = getattr(item, "module", None)
        nodeid = item.nodeid.lower()
        if (module is not None and module.__name__ in _PALLAS_MODULES) \
                or any(tok in nodeid for tok in _PALLAS_TOKENS):
            item.add_marker(pytest.mark.pallas)


@pytest.fixture
def pallas_n() -> int:
    """Matrix size for pallas-interpret factorization tests (n ≤ 32)."""
    return PALLAS_MAX_N


@pytest.fixture(autouse=True, scope="module")
def _bounded_compile_cache():
    """Drop XLA executables between test modules.

    A full-suite session accumulates hundreds of compiled executables, and
    on CPU jaxlib eventually SEGFAULTS inside ``backend_compile`` once the
    session has enough live compiled state (reproducibly at the first big
    MoE decode compile after ~270 tests — faulthandler points at
    ``compiler.py:backend_compile``; the same crash hits a pristine
    checkout, so it is an upstream fragility, not a repo bug).  Clearing
    between modules bounds live-executable count; cross-module cache reuse
    is small since each module compiles its own shapes.
    """
    yield
    import jax

    jax.clear_caches()

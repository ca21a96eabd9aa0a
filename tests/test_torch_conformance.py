"""The reference's cross-DMF contract on the port's output, on the CPU.

``tests/conformance.py`` holds the reference's conformance machinery: its
shape classes, its inputs, its per-DMF contract checks (``CHECKS``,
``VARIANT_CHECKS``: reconstruction and structure) and its tolerance rule,
200·max(m,n,8)·eps at the effective compute dtype.  This sweep runs those
checks on the port: every DMF of ``repro_torch.core.lookahead``, every
variant ``list_variants`` names (``la_mb`` only where it is a fused kernel
of its own, LU and Cholesky: elsewhere it is the ``la`` driver; not
``tuned``, which reads machine-local cache state; ``tiled`` QR through
the reference's ``_check_qr_tiled`` on its ``TileQR``), both
backends (``"torch"``, and ``"cuda"``, whose kernels run their plain
versions on the CPU), float32 and float64, and the DMF's shape classes.
The port computes at the input dtype on every path, so the tolerance is
taken at that dtype.  The reference's ``psmall`` and ``fused`` classes
exist for its Pallas interpret mode and do not apply here.

LDLᵀ, Gauss–Jordan and band reduction run every shape class in every
combination.  The six DMFs that have their own files (``test_torch_lu``,
``_cholesky``, ``_qr``, ``_qrcp``, ``_hessenberg``, which run the same
checks) take one class per (variant, backend, dtype), in turn, so each of
their classes is still checked, within the CPU test budget.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import conformance
from repro.core import tiles as ref_tiles
from repro_torch.core import tiles
from repro_torch.core.lookahead import FACTORIZATIONS, get_variant, \
    list_variants, parse_variant

jax.config.update("jax_enable_x64", True)

BACKENDS = ("torch", "cuda")


#: the DMFs this slice added, swept over every shape class
NEW_DMFS = ("ldlt", "gauss_jordan", "band_reduction")

#: variants swept after the others ("tiled"), or not at all ("tuned")
TAIL = ("tiled", "tuned")


def _cases():
    cases = []
    for dmf in FACTORIZATIONS:
        # the DMF's classes without the Pallas-only ones, as the reference
        # gives them to its jnp mtb
        classes = conformance.shape_classes_for(dmf, "mtb", "jnp")
        turn = 0
        # "tuned" reads machine-local cache state, as the reference's sweep
        # says; "tiled" (Cholesky, QR) comes last, so that the other
        # variants keep their shape classes
        variants = [v for v in list_variants(dmf) if v not in TAIL]
        variants += [v for v in TAIL[:1] if v in list_variants(dmf)]
        for variant in variants:
            if parse_variant(variant)[0] == "la_mb" \
                    and dmf not in conformance.FUSED_LA_MB:
                continue
            for backend in BACKENDS:
                for dtype in conformance.DTYPES:
                    if dmf in NEW_DMFS:
                        picked = classes
                    else:
                        picked = (classes[turn % len(classes)],)
                        turn += 1
                    for sc in picked:
                        cases.append(conformance.Case(
                            dmf, variant, backend, np.dtype(dtype).name, sc))
    return cases


CASES = _cases()
assert {c.dmf for c in CASES} == set(FACTORIZATIONS) \
    == set(conformance.CHECKS)
assert all({c.shape_class for c in CASES if c.dmf == dmf}
           == set(conformance.shape_classes_for(dmf, "mtb", "jnp"))
           for dmf in FACTORIZATIONS)


def _with_jitted(module, *names):
    """``module`` with ``names`` compiled once per shape (``jax.jit``, the
    block static): the same functions, without eager dispatch of their
    per-panel loops in every case."""
    return types.SimpleNamespace(**{
        **vars(module),
        **{name: jax.jit(getattr(module, name), static_argnums=2)
           for name in names}})


@pytest.fixture(scope="module", autouse=True)
def _compiled_checks():
    patch = pytest.MonkeyPatch()
    patch.setattr(conformance, "Q", _with_jitted(conformance.Q, "form_q"))
    patch.setattr(conformance, "H", _with_jitted(conformance.H,
                                                 "form_q_hess"))
    yield
    patch.undo()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_port_meets_the_reference_contract(case):
    m, n, b = conformance.SHAPE_CLASSES[case.shape_class]
    a = conformance.make_input(case.dmf, m, n, seed=m * 131 + n,
                               dtype=case.dtype)
    out = get_variant(case.dmf, case.variant)(
        np.asarray(a), b, backend=case.backend, device="cpu")
    if isinstance(out, tiles.TileQR):
        # the reference's TileQR of the port's R and reflectors, which its
        # _check_qr_tiled reconstructs Q from
        out = ref_tiles.TileQR(r=jnp.asarray(out.r.numpy()), factors=tuple(
            ref_tiles.TileReflector(v=jnp.asarray(f.v.numpy()),
                                    t=jnp.asarray(f.t.numpy()), col=f.col,
                                    rows0=f.rows0, rows1=f.rows1)
            for f in out.factors))
    else:
        out = jax.tree.map(lambda t: jnp.asarray(t.numpy()), out)
    base, _ = parse_variant(case.variant)
    check = conformance.VARIANT_CHECKS.get((case.dmf, base),
                                           conformance.CHECKS[case.dmf])
    # the rule at the input dtype: the reference's jnp mtb case
    tol = conformance.tolerance(dataclasses.replace(case, variant="mtb",
                                                    backend="jnp"))
    check(a, out, tol, b, "jnp")

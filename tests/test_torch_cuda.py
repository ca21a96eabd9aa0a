"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Phase 3 of ``chip_smoke.py`` at small shapes: every kernel is built from
``src/repro_torch/kernels/csrc`` and compared with its plain version on the
card.  The kernel and its plain version sum the same terms in the same
order, so they are held to 4·max(k,8)·eps relative, k being the number of
terms summed per element (the panel bitwise); whole solves keep the
reference's 200·max(m,n,8)·eps.  Marked ``cuda``;
each test skips (inside the ``card`` fixture, never at import or
collection) when no GPU is present.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import blis_gemm, ops, panel_lu, trsm
from repro_torch.solve import gesv, lu_factor

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.float64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed=0):
    g = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(g, dtype=dtype, device=device)


def _tol(dtype, m, n):
    return 200.0 * max(m, n, 8) * torch.finfo(dtype).eps


def _kernel_tol(dtype, k):
    return 4.0 * max(k, 8) * torch.finfo(dtype).eps


def _rel(x, ref):
    return float((x.double() - ref.double()).norm()
                 / ref.double().norm().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 16, 90), (300, 128, 257)])
def test_gemm_accum_matches_plain(card, dtype, m, k, n):
    c = _randn((m, n), dtype, card, 1)
    a = _randn((m, k), dtype, card, 2)
    b = _randn((k, n), dtype, card, 3)
    before = blis_gemm.gemm_accum.launches
    got = blis_gemm.gemm_accum(c, a, b)
    assert blis_gemm.gemm_accum.launches == before + 1
    ref = blis_gemm.gemm_accum_plain(c, a, b)
    assert _rel(got, ref) < _kernel_tol(dtype, k)
    assert _rel(blis_gemm.gemm(a, b), a.double() @ b.double()) \
        < _kernel_tol(dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_accum_in_place_on_strided_views(card, dtype):
    big = _randn((64, 96), dtype, card, 4)
    ref = blis_gemm.gemm_accum_plain(big[20:, 40:], big[20:, :16],
                                     big[4:20, 40:])
    blis_gemm.gemm_accum(big[20:, 40:], big[20:, :16], big[4:20, 40:],
                         out=big[20:, 40:])
    assert _rel(big[20:, 40:], ref) < _kernel_tol(dtype, 16)


def test_gemm_is_column_decomposable_bitwise(card):
    c = _randn((200, 150), torch.float64, card, 5)
    a = _randn((200, 32), torch.float64, card, 6)
    b = _randn((32, 150), torch.float64, card, 7)
    whole = blis_gemm.gemm_accum(c, a, b)
    part = blis_gemm.gemm_accum(c[37:, 71:], a[37:], b[:, 71:])
    assert torch.equal(whole[37:, 71:], part)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,w", [(1, 5), (16, 33), (128, 300), (256, 40)])
@pytest.mark.parametrize("lower,unit", [(True, True), (False, False)])
def test_trsm_matches_plain(card, dtype, nb, w, lower, unit):
    t = torch.linalg.lu_factor(_randn((nb, nb), dtype, card, 8)).LU.contiguous()
    rhs = _randn((nb, w), dtype, card, 9)
    ref = trsm.trsm_plain(t, rhs, lower=lower, unit_diagonal=unit)
    before = trsm.trsm.launches
    got = trsm.trsm(t, rhs, lower=lower, unit_diagonal=unit, out=rhs)
    assert trsm.trsm.launches == before + 1
    assert got.data_ptr() == rhs.data_ptr()
    assert _rel(got, ref) < _kernel_tol(dtype, nb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(1, 1), (40, 16), (1000, 128), (3, 8)])
def test_lu_panel_matches_plain_bitwise(card, dtype, m, nb):
    panel = _randn((m, nb), dtype, card, 10)
    ref = panel.clone()
    piv_ref = panel_lu.lu_panel_plain(ref)
    before = panel_lu.lu_panel.launches
    piv = panel_lu.lu_panel(panel)
    assert panel_lu.lu_panel.launches == before + 1
    assert torch.equal(piv, piv_ref)
    assert torch.equal(panel, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nrhs", [(1, 1), (64, 16), (256, 40)])
def test_lu_solve_small_matches_plain(card, dtype, n, nrhs):
    lu = torch.linalg.lu_factor(_randn((n, n), dtype, card, 11)).LU.contiguous()
    rhs = _randn((n, nrhs), dtype, card, 12)
    got = trsm.lu_solve_small(lu, rhs)
    ref = trsm.lu_solve_small_plain(lu, rhs)
    assert _rel(got, ref) < _kernel_tol(dtype, 2 * n)   # two sweeps


def test_wrappers_raise_on_bad_operands(card):
    a = _randn((32, 32), torch.float64, card, 13)
    with pytest.raises(ValueError, match="unit stride"):
        blis_gemm.gemm(a.mT, a)
    with pytest.raises(ValueError, match="dtype"):
        blis_gemm.gemm(a, a.float())
    with pytest.raises(ValueError, match="at most 256"):
        trsm.trsm(torch.eye(300, device=card), torch.ones(300, 2,
                                                          device=card))
    with pytest.raises(ValueError, match="not supported"):
        panel_lu.lu_panel(a.half())


@pytest.mark.parametrize("dtype", DTYPES)
def test_gesv_variants_bitwise_on_the_card(card, dtype):
    n, b = 300, 32
    a = _randn((n, n), dtype, card, 14)
    rhs = _randn((n, 3), dtype, card, 15)
    ops.reset_launches()
    base = lu_factor(a, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la3"):
        fac = lu_factor(a, b, variant=variant)
        assert torch.equal(fac.lu, base.lu), variant
        assert torch.equal(fac.ipiv, base.ipiv), variant
    x = base.solve(rhs)
    assert _rel(a @ x, rhs) < _tol(dtype, n, n)
    x1 = gesv(a[:32, :32], rhs[:32], 32)
    assert _rel(a[:32, :32] @ x1, rhs[:32]) < _tol(dtype, 32, 32)
    assert all(count > 0 for count in ops.launches().values())

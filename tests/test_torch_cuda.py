"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Phase 3 of ``chip_smoke.py`` at small shapes: every kernel is built from
``src/repro_torch/kernels/csrc`` and compared with its plain version on the
card.  The kernel and its plain version sum the same terms in the same
order, so they are held to 4·max(k,8)·eps relative, k being the number of
terms summed per element (the panel bitwise; the fused panel updates
bitwise against the kernels they replace; the TRSMs and the small LU
solve bitwise against their chain contract; the QR panel, whose
reductions group differently from its plain version, within
4·max(m,nb,8)·eps and within 4·k·eps, k its plan's chain, on both routes;
the QRCP and Hessenberg panels within 4·c·eps, c their plan's chain, the
QRCP pivots equal, on both QRCP routes; flash attention and WKV6 within
elementwise bounds of their plain versions run in float64);
whole solves keep the reference's 200·max(m,n,8)·eps, and every schedule
of LU, Cholesky, QR, ``qrcp_local`` and Hessenberg gives bitwise the
factors of ``mtb``, as does every schedule of LDLᵀ, Gauss–Jordan and band
reduction.  Marked ``cuda``;
each test skips (inside the ``card`` fixture, never at import or
collection) when no GPU is present.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import gauss_jordan
from repro_torch.core.blocking import panel_steps
from repro_torch.core.cholesky import cholesky_panel
from repro_torch.core.lookahead import get_variant
from repro_torch.core.qr import unpack_v
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import attention as attn
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.kernels import blis_gemm, ops, panel_hessenberg, \
    panel_lu, panel_qr, panel_qrcp, trsm, wkv6
from repro_torch.kernels import fused_panel_update as fpu
from repro_torch.solve import cholesky_factor, gecon, gehrd, geqp3, gels, \
    gesv, getri, lu_factor, posv, qr_factor

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


def _chain_tol(dtype, plan):
    """4·c·eps, c the longest chain of terms the kernel's plan counts."""
    return 4.0 * plan["chain"] * torch.finfo(dtype).eps


def _scaled_residual(a, x, b):
    """‖A·x − b‖ / (n·eps·‖A‖·‖x‖), the smoke run's check of a solve
    (bound 100)."""
    eps = torch.finfo(x.dtype).eps
    a, x, b = a.double(), x.double(), b.double()
    return float((a @ x - b).norm()
                 / (a.shape[0] * eps * a.norm() * x.norm()))


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


KC = blis_gemm.KC


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(16384, 16), (16384, 128), (16384, 300),
                                 (3 * KC + 37, 300)])
def test_gemm_deep_k_matches_plain(card, dtype, k, n):
    a = _randn((128, k), dtype, card, 20)
    b = _randn((k, n), dtype, card, 21)
    c = _randn((128, n), dtype, card, 22)
    before = blis_gemm.gemm_accum.launches
    got = blis_gemm.gemm_accum(c, a, b)
    assert blis_gemm.gemm_accum.launches == before + 1   # reduction included
    assert _rel(got, blis_gemm.gemm_accum_plain(c, a, b)) \
        < _kernel_tol(dtype, k)
    assert _rel(blis_gemm.gemm(a, b),
                blis_gemm.gemm_accum_plain(None, a, b, alpha=1.0, beta=0.0)) \
        < _kernel_tol(dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_look_ahead_pu_is_bitwise_the_whole_update(card, dtype):
    # gels' first panel: V^T C over the trailing 3968 columns, and under la
    # the same product on the next panel's 128 columns (and V^T B on 16)
    vt = _randn((128, 16384), dtype, card, 23)
    c = _randn((16384, 3968), dtype, card, 24)
    whole = blis_gemm.gemm(vt, c)
    for cols in (128, 16):
        assert torch.equal(whole[:, :cols], blis_gemm.gemm(vt, c[:, :cols]))
    assert blis_gemm.plan(128, 3968, 16384, dtype)["tile"] \
        != blis_gemm.plan(128, 128, 16384, dtype)["tile"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_chunk_mappings_give_the_same_bits(card, dtype):
    # 2048 x 2048 fills the card with large tiles (each block loops over the
    # three chunks); its 128-column and 128-row slices take small tiles with
    # the chunks on separate blocks and a second summing kernel
    k = 2 * KC + 37
    c = _randn((2048, 2048), dtype, card, 25)
    a = _randn((2048, k), dtype, card, 26)
    b = _randn((k, 2048), dtype, card, 27)
    assert blis_gemm.plan(2048, 2048, k, dtype)["kc"] == KC   # the kernel's
    assert blis_gemm.plan(2048, 2048, k, dtype)["mapping"] == "in_block"
    assert blis_gemm.plan(2048, 128, k, dtype)["mapping"] == "across"
    assert blis_gemm.plan(128, 2048, k, dtype)["mapping"] == "across"
    whole = blis_gemm.gemm_accum(c, a, b)
    assert torch.equal(whole[:, 40:168],
                       blis_gemm.gemm_accum(c[:, 40:168], a, b[:, 40:168]))
    assert torch.equal(whole[1000:1128],
                       blis_gemm.gemm_accum(c[1000:1128], a[1000:1128], b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_deep_k_is_deterministic(card, dtype):
    a = _randn((128, 16384), dtype, card, 28)
    b = _randn((16384, 3968), dtype, card, 29)
    assert torch.equal(blis_gemm.gemm(a, b), blis_gemm.gemm(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_deep_k_in_place_on_strided_views(card, dtype):
    k = 3 * KC + 37
    big = _randn((300, 400), dtype, card, 30)
    a = _randn((290, k + 5), dtype, card, 31)[:, 5:]     # ld k + 5, offset 5
    b = _randn((k, 390), dtype, card, 32)[:, 3:]         # offset 3
    c = big[10:, 13:]                                    # ld 400, offset 13
    ref = blis_gemm.gemm_accum_plain(c, a, b)
    got = blis_gemm.gemm_accum(c, a, b, out=c)
    assert got.data_ptr() == c.data_ptr()
    assert _rel(c, ref) < _kernel_tol(dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n,beta", [(100, 16, 90, 1.0), (300, 128, 257, 1.0),
                                        (128, 16384, 16, 0.0),
                                        (128, 3 * KC + 37, 300, 1.0),
                                        (8064, 128, 8064, 1.0),
                                        (2048, 2 * KC + 37, 2048, 0.0)])
@pytest.mark.parametrize("wide", [False, True])
def test_gemm_is_bitwise_its_fma_chain_contract(card, dtype, m, k, n, beta,
                                                wide):
    """The tile kernel (float64: DMMA, mma.sync m16n8k4) against the
    contract run one thread an element with one FMA a term: bitwise, on
    normal data and on data whose exponents spread over ±40 binades, where
    any regrouping of a DMMA step's four terms would show."""
    a = _randn((m, k), dtype, card, 33)
    b = _randn((k, n), dtype, card, 34)
    c = _randn((m, n), dtype, card, 35) if beta else None
    if wide:
        gen = np.random.default_rng(36)
        a = a * torch.tensor(np.exp2(gen.integers(-20, 20, (m, k))),
                             dtype=dtype, device=card)
        b = b * torch.tensor(np.exp2(gen.integers(-20, 20, (k, n))),
                             dtype=dtype, device=card)
    alpha = -1.0 if beta else 1.0
    got = blis_gemm.gemm_accum(c, a, b) if beta else blis_gemm.gemm(a, b)
    want = blis_gemm.gemm_chain(c, a, b, alpha=alpha, beta=beta)
    assert torch.equal(got, want)


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


TRSM_ROWS = (1, 7, 16, 100, 128, 200, 256)
TRSM_RHS = (1, 16, 33, 8064)


def _triangle(nb, dtype, device, seed):
    """A full nb × nb matrix whose triangles are well conditioned: the
    kernels must read only their own triangle, so the other holds data."""
    t = _randn((nb, nb), dtype, device, seed) / max(nb, 1) ** 0.5
    t.diagonal().add_(2.0)
    return t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", TRSM_ROWS)
@pytest.mark.parametrize("lower,unit", [(True, True), (True, False),
                                        (False, True), (False, False)])
def test_trsm_is_bitwise_its_chain_contract(card, dtype, nb, lower, unit):
    """The strip kernel keeps solve_vector's order term for term: bitwise
    the chain kernel, for ragged strips (nb not a multiple of 16) and
    ragged tiles (n not a multiple of NC), aligned (n 16, 8064) and
    unaligned (n 1, 33 in float64) rows of B."""
    t = _triangle(nb, dtype, card, 40)
    for n in TRSM_RHS:
        rhs = _randn((nb, n), dtype, card, 41 + n)
        got = trsm.trsm(t, rhs, lower=lower, unit_diagonal=unit)
        want = trsm.trsm_chain(t, rhs, lower=lower, unit_diagonal=unit)
        assert torch.equal(got, want), (nb, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", TRSM_ROWS)
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_right_is_bitwise_its_chain_contract(card, dtype, nb, unit):
    """X·Lᵀ = B: the rows of B staged transposed run the same strips."""
    l = _triangle(nb, dtype, card, 42)
    for m in TRSM_RHS:
        rhs = _randn((m, nb), dtype, card, 43 + m)
        got = trsm.trsm_right_lower_t(l, rhs, unit_diagonal=unit)
        want = trsm.trsm_chain(l, rhs, lower=True, unit_diagonal=unit,
                               right=True)
        assert torch.equal(got, want), (nb, m)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("nb", [16, 100, 128])
def test_trsm_in_place_on_strided_views_is_bitwise_the_chain(card, dtype, k,
                                                             nb):
    """In place on views of a larger matrix (ld 404 ≠ n), as the LU update
    solves U12 and the Cholesky PF solves L21.  ld 404 keeps every row
    16-byte aligned in both dtypes, so k = 0 takes the 16-byte copies (as
    the LU update at ld = n = 8192 does); k = 1 puts the views' base off
    16-byte alignment (one-element copies)."""
    big = _randn((nb + 300, 404), dtype, card, 44)
    big[k:k + nb, k:k + nb].diagonal().add_(2.0)
    t = big[k:k + nb, k:k + nb]
    for lower, unit in ((True, True), (False, False), (True, False)):
        rhs = big[k:k + nb, k + nb:]
        want = trsm.trsm_chain(t, rhs, lower=lower, unit_diagonal=unit)
        got = trsm.trsm(t, rhs, lower=lower, unit_diagonal=unit, out=rhs)
        assert got.data_ptr() == rhs.data_ptr()
        assert torch.equal(rhs, want), (lower, unit)
    rows = big[k + nb:, k:k + nb]
    want = trsm.trsm_chain(t, rows, lower=True, right=True)
    trsm.trsm_right_lower_t(t, rows, out=rows)
    assert torch.equal(rows, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_trsm_is_column_decomposable_bitwise(card, dtype):
    """The first w right-hand sides alone (another tile width, another
    grid) give bitwise the first w of the whole solve."""
    nb, n, w = 128, 8064, 100
    assert trsm.plan(nb, n, dtype)["nc"] != trsm.plan(nb, w, dtype)["nc"]
    t = _triangle(nb, dtype, card, 45)
    rhs = _randn((nb, n), dtype, card, 46)
    for lower, unit in ((True, True), (False, False)):
        whole = trsm.trsm(t, rhs, lower=lower, unit_diagonal=unit)
        part = trsm.trsm(t, rhs[:, :w], lower=lower, unit_diagonal=unit)
        assert torch.equal(whole[:, :w], part)
    rows = rhs.mT.contiguous()
    whole = trsm.trsm_right_lower_t(t, rows)
    assert torch.equal(whole[:w], trsm.trsm_right_lower_t(t, rows[:w]))


def test_trsm_plan_fits_the_card(card):
    for dtype in DTYPES:
        for right in (False, True):
            for nb, n in ((1, 1), (128, 16), (128, 8064), (256, 8064)):
                p = trsm.plan(nb, n, dtype, right=right)
                assert p["blocks"] * p["nc"] >= n > (p["blocks"] - 1) * p["nc"]
                assert p["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [257, 384, 512, 1000, 2000])
def test_trsm_wide_triangles_are_bitwise_the_chain(card, dtype, nb):
    """Triangles wider than 256 rows: the x tile sized to b, NC narrowed
    where a wide tile would not fit, and past about 600 (f64) or 1100
    (f32) rows the strips staged in segments; every mode bitwise the
    chain contract (which itself solves in device memory where its tile
    would not fit)."""
    p = trsm.plan(nb, 8064, dtype)
    assert p["smem_bytes"] <= 227 * 1024 and p["max_rows"] >= 2000
    if nb == 2000:
        assert p["segment_rows"] < nb   # the segmented walk
    t = _triangle(nb, dtype, card, 64)
    for n in (1, 33, 8064):
        rhs = _randn((nb, n), dtype, card, 65 + n)
        for lower, unit in ((True, True), (False, False)):
            got = trsm.trsm(t, rhs, lower=lower, unit_diagonal=unit)
            want = trsm.trsm_chain(t, rhs, lower=lower, unit_diagonal=unit)
            assert torch.equal(got, want), (nb, n, lower)
        rows = rhs.mT.contiguous()
        got = trsm.trsm_right_lower_t(t, rows)
        assert torch.equal(got, trsm.trsm_chain(t, rows, lower=True,
                                                right=True)), (nb, n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_trsm_refuses_a_triangle_wider_than_the_card_takes(card, dtype):
    widest = trsm.max_rows(dtype)
    assert widest == trsm.plan(16, 16, dtype)["max_rows"]
    t = torch.eye(widest + 1, dtype=dtype, device=card)
    before = trsm.trsm.launches
    with pytest.raises(ValueError, match="at most"):
        trsm.trsm(t, torch.ones(widest + 1, 2, dtype=dtype, device=card))
    assert trsm.trsm.launches == before


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


def _same(x, y):
    """Equal elements, NaN exactly where the other has NaN (torch.equal
    counts NaN unequal to itself)."""
    nan = torch.isnan(x)
    return torch.equal(nan, torch.isnan(y)) and torch.equal(
        torch.where(nan, 0.0, x), torch.where(nan, 0.0, y))


def _panel_bitwise(panel, runs=1):
    """lu_panel on ``panel`` in place against lu_panel_plain on a copy:
    equal pivots, equal elements; ``runs`` kernel runs from the same input
    give the same elements."""
    start = panel.clone()
    ref = panel.clone()
    piv_ref = panel_lu.lu_panel_plain(ref)
    piv = panel_lu.lu_panel(panel)
    assert torch.equal(piv, piv_ref)
    assert _same(panel, ref)
    for _ in range(runs - 1):
        again = start.clone()
        assert torch.equal(panel_lu.lu_panel(again), piv)
        assert _same(again, panel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_lu_panel_bitwise_on_both_routes(card, dtype, route):
    """The main path's 8192 × 128 panel keeps its rows in shared memory; a
    panel too tall for the SMs' shared memory streams them.  Both are
    bitwise the plain version, pivots equal, the same bits over 3 runs."""
    m = 8192 if route == "resident" else (40000 if dtype == torch.float64
                                         else 80000)
    assert panel_lu.plan(m, 128, dtype)["route"] == route
    _panel_bitwise(_randn((m, 128), dtype, card, 60), runs=3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(3000, 1), (3000, 7), (3000, 256),
                                  (3000, 384), (2000, 512), (100, 300),
                                  (31, 33)])
def test_lu_panel_bitwise_at_every_width(card, dtype, m, nb):
    """Widths 1 to 512 (the wide ones on the streamed route), and panels
    with fewer rows than columns."""
    _panel_bitwise(_randn((m, nb), dtype, card, 61))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_ties_zero_and_nan_columns(card, dtype):
    """Repeated rows (ties: the first index wins, as argmax), an exactly
    zero column (pivot row j, a zero pivot) and an all-NaN column (row j
    kept): the kernel's pivots and bits are the plain version's."""
    m, nb = 3000, 64
    panel = _randn((m, nb), dtype, card, 62)
    panel[1500] = panel[200]
    panel[2900] = panel[200]
    panel[:, 5] = 0.0
    _panel_bitwise(panel.clone())
    nan = panel.clone()
    nan[:, 9] = float("nan")
    _panel_bitwise(nan)
    tied = panel.clone()
    tied[:, 0] = 1.0   # every row ties in column 0
    _panel_bitwise(tied)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 1])
def test_lu_panel_in_place_on_strided_views(card, dtype, k):
    """A panel view of a larger matrix (ld 404 > nb, base offsets 0 and 1),
    as the engine passes it; the rest of the matrix is untouched."""
    big = _randn((3000, 404), dtype, card, 63)
    ref = big.clone()
    piv_ref = panel_lu.lu_panel_plain(ref[k:, k:k + 128])
    piv = panel_lu.lu_panel(big[k:, k:k + 128])
    assert torch.equal(piv, piv_ref)
    assert torch.equal(big, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nrhs", [(1, 1), (64, 16), (256, 40)])
def test_lu_solve_small_matches_plain(card, dtype, n, nrhs):
    lu = torch.linalg.lu_factor(_randn((n, n), dtype, card, 11)).LU.contiguous()
    rhs = _randn((n, nrhs), dtype, card, 12)
    got = trsm.lu_solve_small(lu, rhs)
    ref = trsm.lu_solve_small_plain(lu, rhs)
    assert _rel(got, ref) < _kernel_tol(dtype, 2 * n)   # two sweeps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 17, 128, 255, 256])
def test_lu_solve_small_is_bitwise_the_chain_pair(card, dtype, n):
    """Both sweeps on the strip kernel in one launch: bitwise the chain
    contract run twice (unit lower, then upper) and the strip TRSM run
    twice, for ragged strips (n 17, 255) and tiles (nrhs 1, 40, 300)."""
    lu = _triangle(n, dtype, card, 47)
    for nrhs in (1, 16, 40, 300):
        rhs = _randn((n, nrhs), dtype, card, 48 + nrhs)
        before = trsm.lu_solve_small.launches
        got = trsm.lu_solve_small(lu, rhs)
        assert trsm.lu_solve_small.launches == before + 1
        want = trsm.trsm_chain(lu, trsm.trsm_chain(lu, rhs, lower=True,
                                                   unit_diagonal=True),
                               lower=False)
        assert torch.equal(got, want), (n, nrhs)
        y = trsm.trsm(lu, rhs, lower=True, unit_diagonal=True)
        assert torch.equal(got, trsm.trsm(lu, y, lower=False)), (n, nrhs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 1])
def test_lu_solve_small_in_place_on_strided_views(card, dtype, k):
    """In place on views of a larger matrix (ld 404): k = 0 keeps every row
    16-byte aligned (16-byte copies), k = 1 does not (one-element
    copies)."""
    nb = 128
    big = _randn((nb + 300, 404), dtype, card, 49)
    big[k:k + nb, k:k + nb].diagonal().add_(2.0)
    lu = big[k:k + nb, k:k + nb]
    rhs = big[k:k + nb, k + nb:k + nb + 40]
    want = trsm.trsm_chain(lu, trsm.trsm_chain(lu, rhs, lower=True,
                                               unit_diagonal=True),
                           lower=False)
    got = trsm.lu_solve_small(lu, rhs, out=rhs)
    assert got.data_ptr() == rhs.data_ptr()
    assert torch.equal(rhs, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_qr_panel_within_its_chain_bound_on_both_routes(card, dtype, route):
    """16384 rows keep each block's rows in shared memory; 65536 do not fit
    and take the streamed route.  Within 4·k·eps of the plain version, k the
    plan's chain count; deterministic over three runs; T bitwise the LARFT
    entry's on the same V; a zero column gives tau = 0."""
    m, nb = (16384 if route == "resident" else 65536), 128
    plan = panel_qr.plan(m, nb, dtype)
    assert plan["route"] == route
    assert plan["chain"] <= -(-m // plan["grid"]) + plan["grid"] + nb
    a = _randn((m, nb), dtype, card, 50)
    a[:, 5] = 0.0
    ref = a.clone()
    _, tau_ref, t_ref = panel_qr.qr_panel_plain(ref)
    outs = [panel_qr.qr_panel(a.clone()) for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))
    got, tau, t = outs[0]
    tol = 4.0 * plan["chain"] * torch.finfo(dtype).eps
    assert _rel(got, ref) < tol and _rel(tau, tau_ref) < tol
    assert _rel(t, t_ref) < tol
    assert float(tau[5]) == 0.0
    assert torch.equal(panel_qr.larft(unpack_v(got, nb), tau), t)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(5, 8), (100, 128), (700, 33), (3000, 256)])
def test_qr_panel_in_place_on_strided_views_within_its_chain_bound(card, dtype,
                                                                   m, nb):
    """Short and wide panels (m < nb), ragged widths and the widest panel,
    in place on a view of a larger matrix with a zero column."""
    src = _randn((m + 3, nb + 7), dtype, card, 51)
    src[:, 7 + nb // 2] = 0.0
    panel = src[3:, 7:]
    ref = panel.clone()
    _, tau_ref, t_ref = panel_qr.qr_panel_plain(ref)
    got, tau, t = panel_qr.qr_panel(panel)
    assert got.data_ptr() == panel.data_ptr()
    tol = 4.0 * panel_qr.plan(m, nb, dtype)["chain"] * torch.finfo(dtype).eps
    assert _rel(panel, ref) < tol and _rel(tau, tau_ref) < tol
    assert _rel(t, t_ref) < tol
    assert float(tau[nb // 2]) == 0.0 or nb // 2 >= m
    assert torch.equal(panel_qr.larft(unpack_v(panel, nb), tau), t)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb,route", [(3000, 512, "resident"),
                                         (600, 1200, "streamed")])
def test_qr_panel_and_larft_on_wide_panels(card, dtype, m, nb, route):
    """Panels wider than the 256 columns of T a warp holds at once, on both
    routes: within 4·k·eps, T bitwise the LARFT entry's.  A panel wider
    than a block's shared memory allows is refused at the wrapper, before
    any launch."""
    assert panel_qr.plan(m, nb, dtype)["route"] == route
    a = _randn((m, nb), dtype, card, 53)
    ref = a.clone()
    _, tau_ref, t_ref = panel_qr.qr_panel_plain(ref)
    got, tau, t = panel_qr.qr_panel(a)
    tol = 4.0 * panel_qr.plan(m, nb, dtype)["chain"] * torch.finfo(dtype).eps
    assert _rel(got, ref) < tol and _rel(tau, tau_ref) < tol
    assert _rel(t, t_ref) < tol
    v = unpack_v(got, nb)
    assert torch.equal(panel_qr.larft(v, tau), t)
    assert _rel(panel_qr.larft(v, tau), panel_qr.larft_plain(v, tau)) < tol
    before = panel_qr.qr_panel.launches
    with pytest.raises(ValueError, match="at most"):
        panel_qr.qr_panel(_randn((40, 4000), dtype, card, 52))
    assert panel_qr.qr_panel.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_factor_with_a_512_block(card, dtype):
    """The driver with a block wider than 256 columns (the panel, and the
    Qᵀ apply's ``larft`` at width 512): every variant bitwise ``mtb``, and
    within the solves' bound of the same driver on the CPU."""
    m, n, b = 1200, 700, 512
    a = _randn((m, n), dtype, card, 54)
    rhs = _randn((m, 3), dtype, card, 55)
    ops.reset_launches()
    base = qr_factor(a, b, variant="mtb")
    assert ops.launches()["qr_panel"] == 2
    for variant in ("la", "rtm"):
        assert torch.equal(qr_factor(a, b, variant=variant).packed,
                           base.packed), variant
    ref = qr_factor(a.cpu(), b, variant="mtb", device="cpu")
    tol = _tol(dtype, m, n)
    assert _rel(base.packed.cpu(), ref.packed) < tol
    assert _rel(base.apply_qt(rhs).cpu(), ref.apply_qt(rhs.cpu())) < tol


def test_wrappers_raise_on_bad_operands(card):
    a = _randn((32, 32), torch.float64, card, 13)
    with pytest.raises(ValueError, match="unit stride"):
        blis_gemm.gemm(a.mT, a)
    with pytest.raises(ValueError, match="dtype"):
        blis_gemm.gemm(a, a.float())
    # blocks wider than 256 (and a Cholesky diagonal block past shared
    # memory) run: the calls that were refused here before
    ones = torch.ones(300, 2, device=card)
    assert torch.equal(trsm.trsm(torch.eye(300, device=card), ones), ones)
    with pytest.raises(ValueError, match="not supported"):
        panel_lu.lu_panel(a.half())
    assert torch.equal(trsm.trsm_right_lower_t(torch.eye(300, device=card),
                                               ones.mT.contiguous()),
                       ones.mT)
    with pytest.raises(ValueError, match="unit stride"):
        trsm.trsm_right_lower_t(a, a.mT)
    lu_in = _lu_operands(40, 300, 8, a.dtype, card, 13)
    want = _composed_lu(*(t.clone() for t in lu_in))
    got = fpu.fused_lu_panel_update(*(t.clone() for t in lu_in))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    chol_in = _chol_operands(400, 16, 200, a.dtype, card, 13)
    want = _composed_cholesky(*(t.clone() for t in chol_in))
    assert torch.equal(
        fpu.fused_cholesky_panel_update(*(t.clone() for t in chol_in)), want)
    with pytest.raises(ValueError, match="fewer than"):
        fpu.fused_cholesky_panel_update(a[:8, :4], a[:5, :4], a[:5, :8])
    with pytest.raises(ValueError, match="dtype"):
        fpu.fused_cholesky_panel_update(a[:8, :4], a[:, :4].float(), a[:, :8])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gesv_variants_bitwise_on_the_card(card, dtype):
    n, b = 300, 32
    a = _randn((n, n), dtype, card, 14)
    rhs = _randn((n, 3), dtype, card, 15)
    ops.reset_launches()
    base = lu_factor(a, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la3", "la_mb", "la_mb2"):
        fac = lu_factor(a, b, variant=variant)
        assert torch.equal(fac.lu, base.lu), variant
        assert torch.equal(fac.ipiv, base.ipiv), variant
    x = base.solve(rhs)
    assert _rel(a @ x, rhs) < _tol(dtype, n, n)
    x1 = gesv(a[:32, :32], rhs[:32], 32)
    assert _rel(a[:32, :32] @ x1, rhs[:32]) < _tol(dtype, 32, 32)
    counts = ops.launches()
    assert all(counts[k] > 0 for k in ("gemm_accum", "trsm", "lu_panel",
                                       "lu_solve_small",
                                       "fused_lu_panel_update"))


def _spd(n, dtype, device, seed):
    g = _randn((n, n), torch.float64, device, seed)
    return (g @ g.mT / n + torch.eye(n, dtype=torch.float64,
                                     device=device)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_posv_variants_bitwise_on_the_card(card, dtype):
    n, b = 300, 32
    a = _spd(n, dtype, card, 16)
    rhs = _randn((n, 3), dtype, card, 17)
    ops.reset_launches()
    base = cholesky_factor(a, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la3", "la_mb", "la_mb2"):
        fac = cholesky_factor(a, b, variant=variant)
        assert torch.equal(fac.l, base.l), variant
    assert float(torch.triu(base.l, 1).abs().max()) == 0.0
    x = posv(a, rhs, b, variant="la_mb")
    assert _rel(a @ x, rhs) < _tol(dtype, n, n)
    counts = ops.launches()
    assert all(counts[k] > 0 for k in ("gemm_accum", "trsm",
                                       "cholesky_panel",
                                       "fused_cholesky_panel_update"))


def _lu_operands(m, b, bn, dtype, device, seed):
    l11 = torch.linalg.lu_factor(
        _randn((b, b), dtype, device, seed)).LU.contiguous()
    return (l11, _randn((m, b), dtype, device, seed + 1),
            _randn((b, bn), dtype, device, seed + 2),
            _randn((m, bn), dtype, device, seed + 3))


def _chol_operands(m, b, bn, dtype, device, seed):
    """lrow = l21[:bn], and a panel whose updated top block is SPD."""
    l21 = 0.1 * _randn((m, b), dtype, device, seed)
    panel = 0.1 * _randn((m, bn), dtype, device, seed + 1)
    panel[:bn] = l21[:bn] @ l21[:bn].mT + _spd(bn, dtype, device, seed + 2)
    return l21[:bn], l21, panel


def _composed_lu(l11, l21, a1l, a2l):
    """The kernels the fused LU update replaces: TRSM, GEMM-accumulate,
    GETF2."""
    ops.trsm(l11, a1l, lower=True, unit_diagonal=True, out=a1l)
    ops.update(a2l, l21, a1l)
    return a1l, a2l, ops.lu_panel(a2l)


def _composed_cholesky(lrow, l21, panel):
    """The kernels the fused Cholesky update replaces: GEMM-accumulate, then
    the Cholesky panel composed of PyTorch ops on the card and the right
    TRSM kernel (the rounding the reference specifies)."""
    ops.update(panel, l21, lrow.mT.contiguous())
    return cholesky_panel(panel, lrow.shape[0], "cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [8064, 200, 129])
def test_fused_lu_matches_composed_kernels_bitwise_and_plain(card, dtype, m):
    # Bitwise against the kernels it replaces (what keeps la_mb equal to
    # mtb); against the plain version, whose TRSM and GEMM round each product
    # separately where the kernels use FMA, within 4·(b+bn)·eps, pivots equal.
    l11, l21, a1l, a2l = _lu_operands(m, 128, 128, dtype, card, 18)
    composed = _composed_lu(l11, l21, a1l.clone(), a2l.clone())
    plain = fpu.fused_lu_panel_update_plain(l11, l21, a1l.clone(), a2l.clone())
    before = fpu.fused_lu_panel_update.launches
    u12, packed, piv = fpu.fused_lu_panel_update(l11, l21, a1l, a2l)
    assert fpu.fused_lu_panel_update.launches == before + 1
    assert u12.data_ptr() == a1l.data_ptr() and packed.data_ptr() == a2l.data_ptr()
    assert torch.equal(piv, composed[2]) and torch.equal(piv, plain[2])
    assert torch.equal(u12, composed[0]) and torch.equal(packed, composed[1])
    assert _rel(u12, plain[0]) < _kernel_tol(dtype, 128)
    assert _rel(packed, plain[1]) < _kernel_tol(dtype, 256)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,b", [(8064, 128), (200, 128), (129, 128),
                                 (8064, 16), (200, 16), (7808, 384),
                                 (500, 384)])
def test_fused_cholesky_matches_composed_kernels_bitwise_and_plain(
        card, dtype, m, b):
    """b = bn: the update, POTF2 (in registers up to 128 columns, in device
    memory past that) and the solve, bitwise the GEMM kernel, the
    PyTorch-op POTF2 and the right TRSM kernel."""
    lrow, l21, panel = _chol_operands(m, b, b, dtype, card, 19)
    composed = _composed_cholesky(lrow, l21, panel.clone())
    plain = fpu.fused_cholesky_panel_update_plain(lrow, l21, panel.clone())
    before = fpu.fused_cholesky_panel_update.launches
    got = fpu.fused_cholesky_panel_update(lrow, l21, panel)
    assert fpu.fused_cholesky_panel_update.launches == before + 1
    assert got.data_ptr() == panel.data_ptr()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, composed)
    assert _rel(got, plain) < _kernel_tol(dtype, 2 * b)


def test_fused_updates_in_place_on_strided_views(card):
    # the engine's operands: views of one matrix, ragged next panel
    a = _randn((300, 300), torch.float64, card, 20)
    k, bk, bn = 64, 32, 20
    kn = k + bk
    ref = a.clone()
    want = _composed_lu(ref[k:kn, k:kn], ref[kn:, k:kn],
                        ref[k:kn, kn:kn + bn], ref[kn:, kn:kn + bn])
    got = fpu.fused_lu_panel_update(a[k:kn, k:kn], a[kn:, k:kn],
                                    a[k:kn, kn:kn + bn], a[kn:, kn:kn + bn])
    assert torch.equal(got[2], want[2]) and torch.equal(a, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,b", [(8064, 384), (8064, 512), (700, 300),
                                 (2000, 1100)])
def test_fused_lu_wide_blocks_match_composed_kernels_bitwise(card, dtype, m,
                                                             b):
    """b = bn past 256: U12 by the segmented strip walk where L11 is wide,
    the update on the streamed route where the rows do not fit beside it,
    K past KC (1100) in chunks as the GEMM sums it; bitwise the composed
    kernels, pivots equal to the plain version's."""
    l11, l21, a1l, a2l = _lu_operands(m, b, b, dtype, card, 21)
    composed = _composed_lu(l11, l21, a1l.clone(), a2l.clone())
    plain_piv = fpu.fused_lu_panel_update_plain(l11, l21, a1l.clone(),
                                                a2l.clone())[2]
    got = fpu.fused_lu_panel_update(l11, l21, a1l, a2l)
    assert torch.equal(got[2], composed[2])
    assert torch.equal(got[0], composed[0]) and torch.equal(got[1], composed[1])
    if dtype == torch.float64:
        assert torch.equal(got[2], plain_piv)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_lu_routes_and_determinism(card, dtype):
    """The main path's PU keeps its rows resident; 3 runs give the same
    bits; a panel too tall for the SMs' shared memory streams, bitwise the
    composed kernels too."""
    assert fpu.plan(128, 8064, 128, dtype)["route"] == "resident"
    ops_in = _lu_operands(8064, 128, 128, dtype, card, 22)
    first = fpu.fused_lu_panel_update(*(t.clone() for t in ops_in))
    for _ in range(2):
        again = fpu.fused_lu_panel_update(*(t.clone() for t in ops_in))
        assert all(torch.equal(x, y) for x, y in zip(again, first))
    m = 40000 if dtype == torch.float64 else 80000
    assert fpu.plan(128, m, 128, dtype)["route"] == "streamed"
    ops_in = _lu_operands(m, 128, 128, dtype, card, 23)
    want = _composed_lu(*(t.clone() for t in ops_in))
    got = fpu.fused_lu_panel_update(*(t.clone() for t in ops_in))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", [129, 192, 384])
def test_fused_cholesky_wide_diagonal_block_matches_composed(card, dtype, bn):
    """A diagonal block past POTF2's registers (bn > 128): POTF2 in device
    memory, L11 read from there; bitwise the composed kernels."""
    lrow, l21, panel = _chol_operands(3000, 128, bn, dtype, card, 24)
    assert fpu.cholesky_plan(3000, bn, dtype, b=128)["potf2"] == "device"
    want = _composed_cholesky(lrow, l21, panel.clone())
    got = fpu.fused_cholesky_panel_update(lrow, l21, panel)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def _chol_panel(m, nb, dtype, device, seed):
    """An m x nb panel whose top block is SPD."""
    panel = 0.1 * _randn((m, nb), dtype, device, seed)
    panel[:nb] = _spd(nb, dtype, device, seed + 1)
    return panel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(8192, 128), (128, 128), (40, 1), (300, 17),
                                  (8229, 128), (2000, 129), (2000, 169),
                                  (2000, 170), (2000, 240), (2000, 241)])
def test_cholesky_panel_is_bitwise_the_pytorch_op_composition(card, dtype, m,
                                                              nb):
    """The panel entry (the Cholesky kernel with no update terms) against
    cholesky_unblocked as PyTorch ops on the card and the right TRSM
    kernel: bitwise, at m = nb, bn 1 and 17, a panel whose rows do not
    split into whole chunks (8229), POTF2's register limit (128, 129) and
    the old kernel's shared-memory limits (169, 170 f64; 240, 241 f32)."""
    panel = _chol_panel(m, nb, dtype, card, 30)
    want = cholesky_panel(panel.clone(), nb, "cuda")
    before = dict(ops.launches())
    got = ops.PANEL_KERNELS["cholesky"](panel, nb, "cuda")
    counts = ops.launches()
    assert counts["cholesky_panel"] == before["cholesky_panel"] + 1
    assert counts["fused_cholesky_panel_update"] == \
        before["fused_cholesky_panel_update"]
    assert got.data_ptr() == panel.data_ptr()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    plain = fpu.cholesky_panel_plain(_chol_panel(m, nb, dtype, card, 30), nb)
    assert _rel(got, plain) < _kernel_tol(dtype, nb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cholesky_kernels_in_place_on_strided_views(card, dtype):
    """The engine's operands: views of one matrix whose rows are not
    16-byte aligned (n 301), the panel entry and the fused update, bitwise
    the composition on the same views."""
    n, k, bk = 301, 64, 40
    a = _spd(n, dtype, card, 31)
    ref = a.clone()
    cholesky_panel(ref[k:, k:k + bk], bk, "cuda")
    fpu.cholesky_panel(a[k:, k:k + bk], bk)
    assert torch.equal(a, ref)
    kn = k + bk
    _composed_cholesky(ref[kn:kn + 24, k:kn], ref[kn:, k:kn], ref[kn:, kn:kn + 24])
    fpu.fused_cholesky_panel_update(a[kn:kn + 24, k:kn], a[kn:, k:kn],
                                    a[kn:, kn:kn + 24])
    assert torch.equal(a, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cholesky_kernels_are_deterministic(card, dtype):
    """Two launches on the same inputs give the same bits: the panel entry
    at 8192 x 128 and the fused update at its first PU; a panel too tall
    for the SMs' shared memory streams, bitwise the composition too."""
    assert fpu.cholesky_plan(8192, 128, dtype)["route"] == "resident"
    assert fpu.cholesky_plan(8064, 128, dtype, b=128)["route"] == "resident"
    panel = _chol_panel(8192, 128, dtype, card, 32)
    first = fpu.cholesky_panel(panel.clone(), 128)
    assert torch.equal(fpu.cholesky_panel(panel.clone(), 128), first)
    ops_in = _chol_operands(8064, 128, 128, dtype, card, 33)
    first = fpu.fused_cholesky_panel_update(*(t.clone() for t in ops_in))
    again = fpu.fused_cholesky_panel_update(*(t.clone() for t in ops_in))
    assert torch.equal(again, first)
    m = 60000 if dtype == torch.float64 else 120000
    assert fpu.cholesky_plan(m, 128, dtype)["route"] == "streamed"
    panel = _chol_panel(m, 128, dtype, card, 34)
    want = cholesky_panel(panel.clone(), 128, "cuda")
    assert torch.equal(fpu.cholesky_panel(panel, 128), want)


def test_cholesky_plan_refuses_what_cannot_fit_before_any_launch(card):
    for dtype in DTYPES:
        widest = fpu.cholesky_plan(8192, 128, dtype)["max_bn"]
        assert 3000 < widest < 8000
        with pytest.raises(ValueError, match="at most"):
            fpu.cholesky_plan(widest + 1, widest + 1, dtype)
        ops.reset_launches()
        wide = torch.zeros(widest + 1, widest + 1, dtype=dtype, device=card)
        with pytest.raises(ValueError, match="at most"):
            fpu.cholesky_panel(wide, widest + 1)
        lrow = torch.zeros(widest + 1, 4, dtype=dtype, device=card)
        with pytest.raises(ValueError, match="at most"):
            fpu.fused_cholesky_panel_update(lrow, lrow, wide)
        assert not any(ops.launches().values())
    a = _spd(64, torch.float64, card, 35)
    with pytest.raises(ValueError, match="expected"):
        fpu.cholesky_panel(a[:, :16], 8)
    with pytest.raises(ValueError, match="expected"):
        fpu.cholesky_panel(a[:8, :16], 16)
    with pytest.raises(ValueError, match="unit stride"):
        fpu.cholesky_panel(a.mT[:, :16], 16)
    with pytest.raises(ValueError, match="not supported"):
        fpu.cholesky_panel(a[:, :16].half(), 16)


@pytest.mark.parametrize("dtype,bn", [(torch.float64, 2048),
                                      (torch.float64, 3100),
                                      (torch.float32, 4096)])
def test_cholesky_kernel_past_potf2_shared_columns(card, dtype, bn):
    """Diagonal blocks whose POTF2 column array (bn x 17) does not fit in
    shared memory: the array moves to a device-memory workspace, and the
    panel entry and the fused update stay bitwise the composition; a
    second launch on the same stream finds the flags reset."""
    m = bn + 300
    pl = fpu.cholesky_plan(m, bn, dtype)
    assert pl["potf2_cols"] == "device" and pl["workspace_bytes"] > 0
    assert bn <= pl["max_bn"]
    panel = _chol_panel(m, bn, dtype, card, 36)
    want = cholesky_panel(panel.clone(), bn, "cuda")
    got = fpu.cholesky_panel(panel.clone(), bn)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert torch.equal(fpu.cholesky_panel(panel, bn), want)
    lrow, l21, upd = _chol_operands(m, 64, bn, dtype, card, 37)
    assert fpu.cholesky_plan(m, bn, dtype, b=64)["potf2_cols"] == "device"
    want = _composed_cholesky(lrow, l21, upd.clone())
    assert torch.equal(fpu.fused_cholesky_panel_update(lrow, l21, upd), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_posv_at_block_2048(card, dtype):
    """cholesky_factor / posv with a 2048-column block (POTF2's column
    array in device memory in f64): every variant bitwise mtb, residual
    within the drivers' bound."""
    n, b = 4500, 2048
    spd = _spd(n, dtype, card, 38)
    rhs = _randn((n, 3), dtype, card, 39)
    ops.reset_launches()
    base = cholesky_factor(spd, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la_mb"):
        assert torch.equal(cholesky_factor(spd, b, variant=variant).l,
                           base.l), variant
    assert _scaled_residual(spd, posv(spd, rhs, b, variant="la"), rhs) < 100
    counts = ops.launches()
    assert counts["cholesky_panel"] > 0
    assert counts["fused_cholesky_panel_update"] > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [384, 512])
def test_drivers_with_blocks_wider_than_256(card, dtype, b):
    """gesv / lu_factor and posv / cholesky_factor at blocks the card
    refused before: every variant bitwise mtb, residuals within the
    drivers' bound."""
    n = 2000
    a = _randn((n, n), dtype, card, 25)
    rhs = _randn((n, 3), dtype, card, 26)
    ops.reset_launches()
    base = lu_factor(a, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la_mb"):
        fac = lu_factor(a, b, variant=variant)
        assert torch.equal(fac.lu, base.lu), variant
        assert torch.equal(fac.ipiv, base.ipiv), variant
    assert _scaled_residual(a, gesv(a, rhs, b, variant="la_mb"), rhs) < 100
    spd = _spd(n, dtype, card, 27)
    cbase = cholesky_factor(spd, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la_mb"):
        assert torch.equal(cholesky_factor(spd, b, variant=variant).l,
                           cbase.l), variant
    assert _scaled_residual(spd, posv(spd, rhs, b, variant="la_mb"), rhs) < 100
    counts = ops.launches()
    assert all(counts[k] > 0 for k in ("trsm", "lu_panel",
                                       "fused_lu_panel_update",
                                       "cholesky_panel",
                                       "fused_cholesky_panel_update"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,bn", [(8064, 128), (33, 16), (1, 1), (70, 256)])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_right_matches_plain(card, dtype, m, bn, unit):
    l = torch.linalg.cholesky(_spd(bn, dtype, card, 21)).contiguous()
    rhs = _randn((m, bn), dtype, card, 22)
    ref = trsm.trsm_right_lower_t_plain(l, rhs, unit_diagonal=unit)
    before = trsm.trsm_right_lower_t.launches
    got = trsm.trsm_right_lower_t(l, rhs, unit_diagonal=unit, out=rhs)
    assert trsm.trsm_right_lower_t.launches == before + 1
    assert got.data_ptr() == rhs.data_ptr()
    assert _rel(got, ref) < _kernel_tol(dtype, bn)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(1, 1), (40, 16), (2000, 128), (5, 8),
                                  (300, 33)])
def test_qr_panel_and_larft_match_plain(card, dtype, m, nb):
    src = _randn((m + 3, nb + 7), dtype, card, 30)
    if nb > 2:
        src[:, 9] = 0.0          # a zero panel column stays zero: tau = 0
    panel = src[3:, 7:]                    # a strided view, as the engine's
    ref = panel.clone()
    _, tau_ref, t_ref = panel_qr.qr_panel_plain(ref)
    before = panel_qr.qr_panel.launches
    got, tau, t = panel_qr.qr_panel(panel)
    assert panel_qr.qr_panel.launches == before + 1
    assert got.data_ptr() == panel.data_ptr()
    tol = _kernel_tol(dtype, max(m, nb))
    assert _rel(panel, ref) < tol
    assert _rel(tau, tau_ref) < tol and _rel(t, t_ref) < tol
    v = unpack_v(panel, nb)
    before = panel_qr.larft.launches
    t2 = panel_qr.larft(v, tau)
    assert panel_qr.larft.launches == before + 1
    assert torch.equal(t2, t)    # the same device routine on the same V
    assert _rel(t2, panel_qr.larft_plain(v, tau)) < tol
    if nb > 2:
        assert float(tau[2]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_is_deterministic(card, dtype):
    a = _randn((3000, 128), dtype, card, 31)
    outs = [panel_qr.qr_panel(a.clone()) for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,c,steps", [(300, 300, 32), (2000, 128, 128),
                                       (40, 90, 16), (1, 1, 1), (64, 8, 8)])
def test_qrcp_panel_matches_plain(card, dtype, r, c, steps):
    src = _randn((r, c + 5), dtype, card, 32)
    block = src[:, 5:]
    ref = block.clone()
    want = panel_qrcp.qrcp_panel_plain(ref, steps)
    before = panel_qrcp.qrcp_panel.launches
    got = panel_qrcp.qrcp_panel(block, steps)
    assert panel_qrcp.qrcp_panel.launches == before + 1
    assert got[0].data_ptr() == block.data_ptr()
    assert torch.equal(got[4], want[4])                    # pivots
    assert got[2].stride() == (1, c)                       # F stored as Fᵀ
    tol = _chain_tol(dtype, panel_qrcp.plan(r, c, steps, dtype))
    for x, y in zip(got[:4], want[:4]):
        assert _rel(x, y) < tol


def _qrcp_checked(block, steps, runs=1):
    """qrcp_panel on copies of ``block`` ``runs`` times (every run the same
    bits), its plain version once: (kernel outputs, plain outputs, plan)."""
    r, c = block.shape
    plan = panel_qrcp.plan(r, c, steps, block.dtype)
    want = panel_qrcp.qrcp_panel_plain(block.clone(), steps)
    outs = [panel_qrcp.qrcp_panel(block.clone(), steps) for _ in range(runs)]
    for o in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))
    got = outs[0]
    assert torch.equal(got[4], want[4])                    # pivots
    assert got[2].stride() == (1, c)                       # F stored as Fᵀ
    tol = _chain_tol(block.dtype, plan)
    for x, y in zip(got[:4], want[:4]):
        assert _rel(x, y) < tol
    return got, want, plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,c,route", [(16384, 128, "resident"),
                                       (65536, 128, "streamed"),
                                       (4096, 2048, "streamed")])
def test_qrcp_panel_on_both_routes_within_its_chain_bound(card, dtype, r, c,
                                                          route):
    """A qrcp_local window whose rows fit the blocks' shared memory, one too
    tall for it and a wide global-style block, 128 steps: the plan's route,
    at most one block an SM, three runs with the same bits, pivots equal to
    the plain version's, every array within 4·c·eps, c the plan's chain."""
    plan = panel_qrcp.plan(r, c, 128, dtype)
    assert plan["route"] == route
    assert plan["grid"] <= torch.cuda.get_device_properties(card) \
        .multi_processor_count
    _qrcp_checked(_randn((r, c), dtype, card, 60), 128, runs=3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,c,steps", [(16, 40, 16), (300, 32, 32), (1, 7, 1),
                                       (7, 1, 1), (33, 33, 33)])
def test_qrcp_panel_edge_shapes_on_strided_views(card, dtype, r, c, steps):
    """As many steps as rows (r < c), as columns (c < r), one row, one
    column and a square block, each a view with a row stride wider than
    its width, updated in place."""
    src = _randn((r, c + 3), dtype, card, 61)
    block = src[:, 2 : 2 + c]
    ref = block.clone()
    want = panel_qrcp.qrcp_panel_plain(ref, steps)
    got = panel_qrcp.qrcp_panel(block, steps)
    assert got[0].data_ptr() == block.data_ptr()
    assert torch.equal(got[4], want[4])
    tol = _chain_tol(dtype, panel_qrcp.plan(r, c, steps, dtype))
    for x, y in zip(got[:4], want[:4]):
        assert _rel(x, y) < tol
    orig = _randn((r, c + 3), dtype, card, 61)
    assert torch.equal(src[:, :2], orig[:, :2])
    assert torch.equal(src[:, 2 + c :], orig[:, 2 + c :])


@pytest.mark.parametrize("dtype", DTYPES)
def test_qrcp_panel_zero_and_tied_columns(card, dtype):
    """Zero columns tie at norm 0 and go to the first index (tau = 0 for
    them); two equal columns, the largest, tie and the first is taken."""
    a = _randn((64, 8), dtype, card, 62)
    a[:, 4:] = 0.0
    got, _, _ = _qrcp_checked(a, 8)
    assert got[4].tolist() == got[4].tolist()[:4] + [4, 5, 6, 7]
    assert not got[3][4:].any()
    b = _randn((64, 40), dtype, card, 63)
    b[:, 3] *= 10.0
    b[:, 7] = b[:, 3]
    got, _, _ = _qrcp_checked(b, 16)
    assert int(got[4][0]) == 3


def test_qrcp_streamed_window_pivot_differences_are_near_ties(card):
    """The f32 streamed window (65536 x 128, 128 steps) on 20 inputs: where
    the kernel picks another pivot than its plain version, the first such
    step j is a near-tie.  From the plain version's state after j steps the
    two candidates' downdated norms are recomputed in f64 (the squared
    norms of their columns brought current below row j); their gap lies
    within the downdate's f32 rounding bound, chain x eps of the larger
    candidate's first squared norm (chain: the plan's).  A gap past it
    would be a fault of the kernel.  Prints what it found (one JSON
    line)."""
    r, c, steps, dtype = 65536, 128, 128, torch.float32
    plan = panel_qrcp.plan(r, c, steps, dtype)
    assert plan["route"] == "streamed"
    eps = torch.finfo(dtype).eps
    found = []
    for seed in range(200, 220):
        a = _randn((r, c), dtype, card, seed)
        got = panel_qrcp.qrcp_panel(a.clone(), steps)[4]
        want = panel_qrcp.qrcp_panel_plain(a.clone(), steps)[4]
        diff = (got != want).nonzero()
        if not len(diff):
            continue
        j = int(diff[0])
        blk, v, f, _, piv = panel_qrcp.qrcp_panel_plain(a.clone(), j)
        cur = blk[j:, j:].double() \
            - v[j:, :j].double() @ f[j:, :j].double().mT
        vn = (cur * cur).sum(0)
        order = list(range(c))
        for l_ in range(j):
            p_ = int(piv[l_])
            order[l_], order[p_] = order[p_], order[l_]
        picks = (int(got[j]) - j, int(want[j]) - j)
        vn0 = max(float((a[:, order[j + x]].double() ** 2).sum())
                  for x in picks)
        gap = abs(float(vn[picks[0]] - vn[picks[1]]))
        found.append({"seed": seed, "step": j, "kernel": int(got[j]),
                      "plain": int(want[j]), "gap": gap,
                      "bound": plan["chain"] * eps * vn0,
                      "norms": [float(vn[x]) for x in picks]})
    print(json.dumps({"qrcp_streamed_f32_pivot_differences": found,
                      "inputs": 20, "chain": plan["chain"]}))
    assert all(x["gap"] <= x["bound"] for x in found), found


def test_qrcp_plan_refuses_what_cannot_fit_before_any_launch(card):
    """More steps than a block's shared memory holds the vectors of: a
    ValueError from the plan and from the wrapper, and no launch."""
    with pytest.raises(ValueError, match="at most"):
        panel_qrcp.plan(5000, 5000, 5000, torch.float64)
    block = torch.zeros((5000, 5000), dtype=torch.float64, device=card)
    before = panel_qrcp.qrcp_panel.launches
    with pytest.raises(ValueError, match="at most"):
        panel_qrcp.qrcp_panel(block, 5000)
    assert panel_qrcp.qrcp_panel.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_and_qrcp_local_variants_bitwise_on_the_card(card, dtype):
    m, n, b = 300, 200, 32
    a = _randn((m, n), dtype, card, 33)
    base = qr_factor(a, b, variant="mtb")
    for variant in ("rtm", "la", "la2", "la_mb"):
        fac = qr_factor(a, b, variant=variant)
        assert torch.equal(fac.packed, base.packed), variant
        assert torch.equal(fac.taus, base.taus), variant
    wide = _randn((90, 200), dtype, card, 34)
    wbase = qr_factor(wide, b, variant="mtb")
    for variant in ("rtm", "la", "la2"):
        assert torch.equal(qr_factor(wide, b, variant=variant).packed,
                           wbase.packed), variant
    lbase = geqp3(a, b, variant="mtb", local=True)
    for variant in ("la", "la2", "rtm"):
        fac = geqp3(a, b, variant=variant, local=True)
        assert torch.equal(fac.packed, lbase.packed), variant
        assert torch.equal(fac.jpvt, lbase.jpvt), variant
    g = geqp3(a, b)
    assert torch.equal(geqp3(a, b, variant="rtm").packed, g.packed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pivot,local", [(False, False), (True, False),
                                         (True, True)])
def test_gels_on_the_card(card, dtype, pivot, local):
    m, n, b = 400, 150, 32
    a = _randn((m, n), dtype, card, 35)
    rhs = _randn((m, 4), dtype, card, 36)
    ops.reset_launches()
    x = gels(a, rhs, b, pivot=pivot, local=local)
    counts = ops.launches()
    kernel = "qrcp_panel" if pivot else "qr_panel"
    assert counts[kernel] == -(-n // b)
    assert counts["larft"] > 0          # the solve's Qᵀ apply
    ref = torch.linalg.lstsq(a.double().cpu(), rhs.double().cpu()).solution
    assert _rel(x.cpu(), ref) < _tol(dtype, m, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 200, 512 - 128])
@pytest.mark.parametrize("bk", [128, 40])
def test_hessenberg_panel_matches_plain(card, dtype, k, bk):
    n = 512
    src = _randn((n, n + 9), dtype, card, 37)
    a = src[:, 9:]                         # a strided view: ld = n + 9
    orig, ref = a.clone(), a.clone()
    want = panel_hessenberg.hessenberg_panel_plain(ref, k, bk)
    before = panel_hessenberg.hessenberg_panel.launches
    got = panel_hessenberg.hessenberg_panel(a, k, bk)
    assert panel_hessenberg.hessenberg_panel.launches == before + 1
    assert got[0].data_ptr() == a.data_ptr()
    tol = _chain_tol(dtype, panel_hessenberg.plan(n, k, bk, dtype))
    for x, y in zip(got, want):
        assert _rel(x, y) < tol
    if k + bk >= n - 1:                    # the last two columns: tau = 0
        assert float(got[4][n - 2 - k]) == 0.0
    again = panel_hessenberg.hessenberg_panel(orig, k, bk)   # ld = n
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [0, 2048 - 128])
def test_hessenberg_panel_in_l2_is_deterministic(card, dtype, k):
    """n 2048 (the matrix fits L2; every SM busy): three runs give the same
    bits, within 4·c·eps of the plain version, c the plan's chain; the
    last panel's two last columns get tau = 0."""
    n, bk = 2048, 128
    plan = panel_hessenberg.plan(n, k, bk, dtype)
    assert plan["grid"] == min(
        torch.cuda.get_device_properties(card).multi_processor_count, n // 8)
    a0 = _randn((n, n), dtype, card, 64)
    want = panel_hessenberg.hessenberg_panel_plain(a0.clone(), k, bk)
    outs = [panel_hessenberg.hessenberg_panel(a0.clone(), k, bk)
            for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))
    tol = _chain_tol(dtype, plan)
    for x, y in zip(outs[0], want):
        assert _rel(x, y) < tol
    if k + bk >= n - 1:
        assert not outs[0][4][n - 2 - k:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,bk", [(5, 0, 5), (3, 1, 2), (1, 0, 1),
                                    (40, 30, 10), (1024, 0, 384)])
def test_hessenberg_panel_edge_shapes_on_strided_views(card, dtype, n, k, bk):
    """Tiny matrices, panels that reach the last columns (no rows to
    reduce: tau = 0, v = 0) and a panel too wide for T to stay in a
    block's shared memory (1024, 384: T in the blocks' workspace), each on
    a view with a wider row stride, updated in place."""
    src = _randn((n, n + 4), dtype, card, 65)
    a = src[:, 1 : 1 + n]
    ref = a.clone()
    want = panel_hessenberg.hessenberg_panel_plain(ref, k, bk)
    got = panel_hessenberg.hessenberg_panel(a, k, bk)
    assert got[0].data_ptr() == a.data_ptr()
    plan = panel_hessenberg.plan(n, k, bk, dtype)
    assert plan["shared"]["t"] == (bk < 384)
    tol = _chain_tol(dtype, plan)
    for x, y in zip(got, want):
        assert _rel(x, y) < tol
    for kj in range(max(k, n - 2), k + bk):
        assert float(got[4][kj - k]) == 0.0 and not got[1][:, kj - k].any()


def test_hessenberg_plan_refuses_what_cannot_fit_before_any_launch(card):
    """A panel wider than a block's shared memory holds the vectors of: a
    ValueError from the plan and from the wrapper, and no launch."""
    n = 9600
    with pytest.raises(ValueError, match="at most"):
        panel_hessenberg.plan(n, 0, n, torch.float64)
    a = torch.empty((n, n), dtype=torch.float64, device=card)
    before = panel_hessenberg.hessenberg_panel.launches
    with pytest.raises(ValueError, match="at most"):
        panel_hessenberg.hessenberg_panel(a, 0, n)
    assert panel_hessenberg.hessenberg_panel.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_gehrd_schedules_bitwise(card, dtype):
    n, b = 300, 32
    a = _randn((n, n), dtype, card, 38)
    ops.reset_launches()
    base = gehrd(a, b)
    assert ops.launches()["hessenberg_panel"] == -(-n // b)
    for block in (b, [32, 16]):
        ref = gehrd(a, block)
        fac = gehrd(a, block, variant="rtm")
        assert torch.equal(fac.packed, ref.packed)
        assert torch.equal(fac.taus, ref.taus)
    assert not torch.tril(base.h, -2).any()
    q = base.q()
    eps = torch.finfo(dtype).eps
    eye = torch.eye(n, dtype=torch.float64, device=card)
    assert float((q.double().mT @ q.double() - eye).norm()) < 100 * n * eps
    assert _rel(base.reconstruct(), a) < _tol(dtype, n, n)


def test_torch_backend_launches_no_kernel(card):
    a = _randn((200, 200), torch.float64, card, 40)
    ops.reset_launches()
    gehrd(a, 32, backend="torch")
    geqp3(a, 32, backend="torch")
    geqp3(a, 32, local=True, backend="torch")
    spd = _spd(200, torch.float64, card, 41)
    for variant in ("mtb", "rtm", "la", "la2"):
        cholesky_factor(spd, 32, variant=variant, backend="torch")
    assert not any(ops.launches().values())


@pytest.mark.parametrize("dtype", DTYPES)
def test_gecon_and_getri_on_the_card(card, dtype):
    n, b = 300, 32
    a = _randn((n, n), dtype, card, 39)
    a64 = a.double()
    exact = 1.0 / float(a64.abs().sum(0).max()
                        * torch.linalg.inv(a64).abs().sum(0).max())
    ratio = float(gecon(a, b)) / exact
    # Hager's estimate of ‖A⁻¹‖₁ is a lower bound, up to the rounding of the
    # working precision's solves, κ₁·eps
    slack = max(1e-6, torch.finfo(dtype).eps / exact)
    assert 1.0 <= ratio * (1 + slack) and ratio <= 10.0
    x = getri(a, b)
    eye = torch.eye(n, dtype=torch.float64, device=card)
    res = float((a64 @ x.double() - eye).norm()) / (
        n * torch.finfo(dtype).eps * float(a64.norm())
        * float(x.double().norm()))
    assert res < 100.0


def _attn_within(got, want, tol):
    return bool(((got.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 2, 1, 64, 64, 32, True), (2, 4, 2, 100, 100, 64, False),
    (1, 8, 2, 300, 300, 128, True), (2, 4, 4, 130, 257, 128, False),
    (2, 40, 10, 256, 256, 128, True)])
def test_flash_attention_matches_plain(card, dtype, b, h, hkv, sq, sk, d,
                                       causal):
    q = _randn((b, h, sq, d), dtype, card, 50)
    k = _randn((b, hkv, sk, d), dtype, card, 51)
    v = _randn((b, hkv, sk, d), dtype, card, 52)
    before = attn.flash_attention.launches
    got = attn.flash_attention(q, k, v, causal=causal)
    assert attn.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, sq, d)
    want, tol = attn.attn_expect(q, k, v, causal=causal)
    assert _attn_within(got, want, tol)
    # the plain version at the input dtype, as the CPU path runs it
    assert _attn_within(attn.flash_attention_plain(q, k, v, causal=causal),
                        want, tol)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_tolerance_catches_planted_faults(card, dtype):
    # the tolerance must fail a kernel that leaves out one 64-key tile (the
    # one at Sk/2, hidden here through kpos) or that does not write the
    # second half of the rows, at a causal GQA shape
    b, h, hkv, s, d = 1, 8, 2, 1024, 128
    q = _randn((b, h, s, d), dtype, card, 60)
    k = _randn((b, hkv, s, d), dtype, card, 61)
    v = _randn((b, hkv, s, d), dtype, card, 62)
    want, tol = attn.attn_expect(q, k, v)
    got = attn.flash_attention(q, k, v)
    assert _attn_within(got, want, tol)
    for name, wrong in attn.attn_faults(q, k, v, got).items():
        assert not _attn_within(wrong, want, tol), name


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_positions_and_masked_rows(card, dtype):
    # queries at positions -70.. see no key for their first 70 rows (every
    # score -1e30: the mean of v, as the reference computes it), and the
    # strided q view goes through the wrapper's contiguous copy
    b, h, hkv, s, d = 1, 4, 2, 192, 128
    q = _randn((b, s, h, d), dtype, card, 53).transpose(1, 2)
    k = _randn((b, hkv, s, d), dtype, card, 54)
    v = _randn((b, hkv, s, d), dtype, card, 55)
    qpos = torch.arange(s, dtype=torch.int32, device=card) - 70
    kpos = torch.arange(s, dtype=torch.int32, device=card)
    got = attn.flash_attention(q, k, v, qpos=qpos, kpos=kpos)
    want, tol = attn.attn_expect(q, k, v, qpos=qpos, kpos=kpos)
    assert _attn_within(got, want, tol)
    assert _attn_within(attn.flash_attention_plain(
        q, k, v, qpos, kpos, block_q=64, block_k=96), want, tol)
    mean_v = v.double().mean(dim=2)[:, :, None].repeat_interleave(2, dim=1)
    assert _attn_within(got[:, :, :70], mean_v, tol[:, :, :70])


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("d", (32, 64, 128))
@pytest.mark.parametrize("sq,sk,causal", [
    (97, 161, True), (200, 75, False), (129, 129, True),
    *((sq, sk, causal) for sq, sk in ((1, 1), (17, 17), (40, 40), (5, 70))
      for causal in (True, False))])
def test_flash_attention_ragged_tiles(card, dtype, d, sq, sk, causal):
    # Sq and Sk not multiples of the 128-row block or the 64-key tile: the
    # last query block and key tile are short; prompts shorter than one
    # 64-row box of Q, K or V read zeros past the last row and leave the
    # second consumer warpgroup of a bfloat16 block without rows
    b, h, hkv = 2, 4, 2
    q = _randn((b, h, sq, d), dtype, card, 63)
    k = _randn((b, hkv, sk, d), dtype, card, 64)
    v = _randn((b, hkv, sk, d), dtype, card, 65)
    got = attn.flash_attention(q, k, v, causal=causal)
    want, tol = attn.attn_expect(q, k, v, causal=causal)
    assert _attn_within(got, want, tol)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_ragged_tile_reads_nothing_of_the_next_head(card,
                                                                   dtype):
    # the last key tile of KV head 0 is short (Sk 100); the rows after it
    # in memory are KV head 1's, here inf: head 0's queries must not see them
    # (the kernel's tensor maps are 3-D, so a box past Sk reads zeros)
    b, h, hkv, s, d = 1, 4, 2, 100, 128
    q = _randn((b, h, s, d), dtype, card, 66)
    k = _randn((b, hkv, s, d), dtype, card, 67)
    v = _randn((b, hkv, s, d), dtype, card, 68)
    k[:, 1], v[:, 1] = float("inf"), float("inf")
    got = attn.flash_attention(q, k, v)
    assert bool(torch.isfinite(got[:, :2]).all())
    want, tol = attn.attn_expect(q[:, :2], k[:, :1], v[:, :1])
    assert _attn_within(got[:, :2], want, tol)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_hidden_tile_matches_its_mask(card, dtype):
    # keys 512..575 placed past every query through kpos: the kernel skips
    # that tile for rows that have seen a visible key and must equal the
    # attention with those keys masked; rows 0..63 see keys 0..63 only
    b, h, hkv, s, d = 1, 8, 2, 1024, 64
    q = _randn((b, h, s, d), dtype, card, 69)
    k = _randn((b, hkv, s, d), dtype, card, 70)
    v = _randn((b, hkv, s, d), dtype, card, 71)
    kpos = torch.arange(s, dtype=torch.int32, device=card)
    kpos[512:576] = s
    got = attn.flash_attention(q, k, v, kpos=kpos)
    want, tol = attn.attn_expect(q, k, v, kpos=kpos)
    assert _attn_within(got, want, tol)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_flash_attention_is_deterministic(card, dtype):
    # no atomics: two launches on the same inputs agree bit for bit
    b, h, hkv, s, d = 2, 8, 2, 300, 128
    q = _randn((b, h, s, d), dtype, card, 72)
    k = _randn((b, hkv, s, d), dtype, card, 73)
    v = _randn((b, hkv, s, d), dtype, card, 74)
    assert torch.equal(attn.flash_attention(q, k, v),
                       attn.flash_attention(q, k, v))
    if dtype == torch.bfloat16:
        assert attn.kernel_config(d)["route"] == "wgmma"


def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    q = _randn((1, 2, 64, 64), torch.float32, card, 56)
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError, match="dtype"):
        attn.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="backward"):
        attn.flash_attention(q.requires_grad_(), q, q)
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        attn.flash_attention(q, q, q, window=16)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_chunked_attention_launches_the_kernel(card, dtype):
    b, g, hg, s, d = 2, 2, 3, 256, 64
    q = _randn((b, g, hg, s, d), dtype, card, 57)
    k = _randn((b, g, s, d), dtype, card, 58)
    v = _randn((b, g, s, d), dtype, card, 59)
    pos = torch.arange(s, device=card)
    before = attn.flash_attention.launches
    got = L.chunked_attention(q, k, v, pos, pos, chunk_q=64, chunk_k=128)
    assert attn.flash_attention.launches == before + 1
    ref = L.chunked_attention(q.cpu(), k.cpu(), v.cpu(), pos.cpu(),
                              pos.cpu(), chunk_q=64, chunk_k=128)
    want, tol = attn.attn_expect(q.reshape(b, g * hg, s, d), k, v)
    shape = (b, g * hg, s, d)
    assert _attn_within(got.reshape(shape), want, tol)
    assert _attn_within(ref.reshape(shape).to(card), want, tol)


def test_reduced_phi3_on_the_card_matches_the_cpu(card):
    # the serving path on the card (flash kernel, cuBLAS) against the same
    # path on the CPU (plain versions), float32: summation order only, so
    # 1e-4 of the largest |logit| (the two devices' GEMMs sum in other
    # orders; the CPU tests hold the CPU path to the reference at 1e-5)
    cfg = reduced_config(get_config("phi3-medium-14b"))
    params = api.init_params(cfg, 0, device=card)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    cpu_params = to_cpu(params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 128))
    full = api.apply(cfg, params, {"tokens": toks})
    full_cpu = api.apply(cfg, cpu_params, {"tokens": toks})
    tol = 1e-4 * float(full_cpu.abs().max())
    assert float((full.cpu() - full_cpu).abs().max()) <= tol
    ops.reset_launches()
    lg, cache = api.prefill(cfg, params, {"tokens": toks[:, :64]},
                            max_len=128)
    for i in range(3):
        lg, cache = api.decode_step(cfg, params, cache,
                                    toks[:, 64 + i:65 + i], 64 + i)
        assert float((lg[:, 0].cpu() - full_cpu[:, 64 + i]).abs().max()) \
            <= tol
    assert ops.launches()["flash_attention"] == cfg.num_layers


def _wkv_inputs(b, h, s, d, dtype, device, seed):
    """r, k, v ~ N(0, 1) in ``dtype``; decays like the served model's,
    log w = -exp(-0.6 + 0.42 z); u ~ 0.5 N(0, 1); s0 ~ N(0, 1)."""
    g = np.random.default_rng(seed)

    def t(x, dt=torch.float32):
        return torch.tensor(x, dtype=dt, device=device)

    r, k, v = (t(g.standard_normal((b, h, s, d)), dtype) for _ in range(3))
    logw = t(-np.exp(-0.6 + 0.42 * g.standard_normal((b, h, s, d))))
    return r, k, v, logw, t(0.5 * g.standard_normal((h, d))), \
        t(g.standard_normal((b, h, d, d)))


def _wkv_ratio(got, want, tol):
    return float(((got.double() - want).abs() / tol).max())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,h,s,d,chunk,with_s0", [
    (1, 2, 128, 64, 128, False), (2, 3, 1000, 64, 128, True),
    (2, 4, 40, 32, 16, True), (1, 2, 300, 32, 64, False),
    (1, 1, 5, 64, 128, True)])
def test_wkv6_matches_plain(card, dtype, b, h, s, d, chunk, with_s0):
    # the kernel within wkv6_expect's bound of the plain version run in
    # float64 (the cumsum's rounding reaches the exponents; see there), and
    # the plain version at the input dtype, as the CPU path runs it
    r, k, v, logw, u, s0 = _wkv_inputs(b, h, s, d, dtype, card, 70 + s)
    s0 = s0 if with_s0 else None
    before = wkv6.wkv6_fused.launches
    got, st = wkv6.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=chunk)
    assert wkv6.wkv6_fused.launches == before + 1
    assert got.dtype == st.dtype == torch.float32
    want, tol, s_want, s_tol = wkv6.wkv6_expect(r, k, v, logw, u, s0=s0,
                                                chunk=chunk)
    assert _wkv_ratio(got, want, tol) <= 1.0
    assert _wkv_ratio(st, s_want, s_tol) <= 1.0
    plain, plain_st = wkv6.wkv6_fused_plain(r, k, v, logw, u, s0=s0,
                                            chunk=chunk)
    assert _wkv_ratio(plain, want, tol) <= 1.0
    assert _wkv_ratio(plain_st, s_want, s_tol) <= 1.0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_wkv6_bound_catches_planted_faults_and_splits_bitwise(card, dtype):
    # the state dropped at a chunk boundary, the diagonal taken into the
    # score mask and the ragged tail left unwritten each exceed the bound;
    # a run split at a chunk boundary equals the unsplit one bitwise
    b, h, s, d, c = 2, 4, 1000, 64, 128
    r, k, v, logw, u, s0 = _wkv_inputs(b, h, s, d, dtype, card, 80)
    want, tol, _, _ = wkv6.wkv6_expect(r, k, v, logw, u, s0=s0, chunk=c)
    got, st = wkv6.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=c)
    assert _wkv_ratio(got, want, tol) <= 1.0
    head = [x[:, :, :512] for x in (r, k, v, logw)]
    rest = [x[:, :, 512:] for x in (r, k, v, logw)]
    o1, s1 = wkv6.wkv6_fused(*head, u, s0=s0, chunk=c)
    o2, s2 = wkv6.wkv6_fused(*rest, u, s0=s1, chunk=c)
    assert torch.equal(torch.cat([o1, o2], 2), got) and torch.equal(s2, st)
    for name, bad in wkv6.wkv6_faults(r, k, v, logw, u, got, s0=s0, chunk=c,
                                      split_at=512).items():
        assert _wkv_ratio(bad, want, tol) > 1.0, name


def _wkv_checked(r, k, v, logw, u, s0, chunk):
    """One kernel call, its out and final state within wkv6_expect's bound,
    and a second call with the same bits."""
    got, st = wkv6.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=chunk)
    want, tol, s_want, s_tol = wkv6.wkv6_expect(r, k, v, logw, u, s0=s0,
                                                chunk=chunk)
    if got.numel():
        assert _wkv_ratio(got, want, tol) <= 1.0
    assert _wkv_ratio(st, s_want, s_tol) <= 1.0
    again, st2 = wkv6.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=chunk)
    assert torch.equal(again, got) and torch.equal(st2, st)
    return got, st


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("d", (32, 64))
def test_wkv6_splits_at_every_chunk_boundary_bitwise(card, dtype, d):
    # a 6-chunk sequence from a state, split at each chunk boundary and
    # continued from the first part's final state: the same bits
    b, h, c = 2, 3, 64
    r, k, v, logw, u, s0 = _wkv_inputs(b, h, 6 * c, d, dtype, card, 81 + d)
    got, st = _wkv_checked(r, k, v, logw, u, s0, c)
    for cut in range(c, 6 * c, c):
        o1, s1 = wkv6.wkv6_fused(*(x[:, :, :cut] for x in (r, k, v, logw)),
                                 u, s0=s0, chunk=c)
        o2, s2 = wkv6.wkv6_fused(*(x[:, :, cut:] for x in (r, k, v, logw)),
                                 u, s0=s1, chunk=c)
        assert torch.equal(torch.cat([o1, o2], 2), got), cut
        assert torch.equal(s2, st), cut


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,h,s,d,chunk,with_s0", [
    (1, 1, 128, 64, 128, False),    # one chunk a head
    (1, 2, 256, 64, 128, True),     # two
    (1, 2, 2000, 64, 128, True),    # sixteen, a ragged tail from a state
    (8, 64, 200, 64, 128, False),   # 512 heads: more than resident blocks
    (2, 3, 50, 64, 128, True),      # S < c
    (3, 2, 1, 64, 128, True),       # S = 1
    (1, 2, 9, 32, 1, True),         # chunk 1
    (2, 2, 333, 32, 64, True)])     # D 32, a ragged tail from a state
def test_wkv6_tiles_at_the_edges(card, dtype, b, h, s, d, chunk, with_s0):
    # the plan's tiles and grid, then the kernel within its bound, twice
    # with the same bits
    pl = wkv6.plan(b, h, s, d, chunk, dtype)
    assert pl["tiles"] == b * h * -(-s // min(chunk, s))
    assert pl["grid"] == min(pl["tiles"], pl["sms"] * pl["blocks_per_sm"])
    assert pl["blocks_per_sm"] >= 1 and pl["registers"] <= 65536 // (
        pl["threads"] * pl["blocks_per_sm"])
    r, k, v, logw, u, s0 = _wkv_inputs(b, h, s, d, dtype, card, 90 + s + d)
    _wkv_checked(r, k, v, logw, u, s0 if with_s0 else None, chunk)


def test_wkv6_back_to_back_shapes_leave_the_flags_at_zero(card):
    # calls of other shapes in turn on one stream (the ticket and the
    # heads' counts must start from 0 each time), S = 0 (the final state
    # is the start state), then the first call again: the same bits
    shapes = [(2, 4, 300, 64, 128, torch.bfloat16),
              (1, 2, 1000, 32, 64, torch.float32),
              (8, 64, 130, 64, 128, torch.float32),
              (1, 1, 3, 64, 2, torch.bfloat16)]
    first = None
    for b, h, s, d, chunk, dtype in shapes + shapes[:1]:
        r, k, v, logw, u, s0 = _wkv_inputs(b, h, s, d, dtype, card, s + d)
        res = _wkv_checked(r, k, v, logw, u, s0, chunk)
        if first is None:
            first = res
    assert torch.equal(res[0], first[0]) and torch.equal(res[1], first[1])
    r, k, v, logw, u, s0 = _wkv_inputs(1, 2, 0, 64, torch.float32, card, 5)
    out, st = wkv6.wkv6_fused(r, k, v, logw, u, s0=s0)
    assert out.shape == (1, 2, 0, 64) and torch.equal(st, s0)
    torch.cuda.synchronize()
    assert all(not f.any() for f in wkv6._FLAGS.values())


def test_wkv6_refuses_what_the_kernel_does_not_take(card):
    r, k, v, logw, u, _ = _wkv_inputs(1, 2, 64, 64, torch.float32, card, 90)
    with pytest.raises(ValueError, match="head dims"):
        wkv6.wkv6_fused(r[..., :48], k[..., :48], v[..., :48],
                        logw[..., :48], u[:, :48])
    with pytest.raises(ValueError, match="dtypes"):
        wkv6.wkv6_fused(r.double(), k.double(), v.double(), logw, u)
    with pytest.raises(ValueError, match="float32"):
        wkv6.wkv6_fused(r, k, v, logw.double(), u)
    longer = [torch.cat([x, x, x], 2) for x in (r, k, v, logw)]
    with pytest.raises(ValueError, match="exceeds"):
        wkv6.wkv6_fused(*longer, u, chunk=192)


def test_reduced_rwkv_on_the_card_matches_the_cpu(card):
    # the RWKV serving path on the card (WKV kernel, cuBLAS) against the
    # same path on the CPU (plain versions), float32, a ragged prompt:
    # summation order only, so 1e-4 of the largest |logit|
    cfg = reduced_config(get_config("rwkv6-7b"))
    params = api.init_params(cfg, 0, device=card)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    cpu_params = to_cpu(params)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48))
    full_cpu = api.apply(cfg, cpu_params, {"tokens": toks})
    tol = 1e-4 * float(full_cpu.abs().max())
    ops.reset_launches()
    full = api.apply(cfg, params, {"tokens": toks})
    assert float((full.cpu() - full_cpu).abs().max()) <= tol
    lg, cache = api.prefill(cfg, params, {"tokens": toks[:, :40]},
                            max_len=48)
    for i in range(3):
        lg, cache = api.decode_step(cfg, params, cache,
                                    toks[:, 40 + i:41 + i], 40 + i)
        assert float((lg[:, 0].cpu() - full_cpu[:, 40 + i]).abs().max()) \
            <= tol
    assert ops.launches()["wkv6_fused"] == 2 * cfg.num_layers


# ---------------------------------------------------------------------------
# LDLᵀ, Gauss–Jordan inversion and band reduction.
# ---------------------------------------------------------------------------
def _quasi_definite(n, dtype, device, seed):
    """Symmetric, diagonally dominant, indefinite: the reference's recipe."""
    g = _randn((n, n), torch.float64, device, seed)
    signs = torch.where(torch.arange(n, device=device) % 3 == 0, -1.0, 1.0)
    return ((g + g.mT) / 2 + torch.diag(signs * 2.0 * n)).to(dtype)


#: DMF -> (input, the kernels its path must launch, its look-ahead variants)
_NEW_DMFS = {
    "ldlt": (_quasi_definite, ("trsm_right_lower_t", "gemm_accum"),
             ("la", "la2", "la_mb")),
    "gauss_jordan": (_spd, ("gemm_accum",), ("la", "la2", "la_mb")),
    "band_reduction": (_randn, ("qr_panel", "gemm_accum"), ("la", "la_mb")),
}


def _new_dmf_input(dmf, n, dtype, device, seed):
    make = _NEW_DMFS[dmf][0]
    return make((n, n), dtype, device, seed) if make is _randn \
        else make(n, dtype, device, seed)


def _contract(dmf, a, out, b):
    """The reference's contract for each DMF (``tests/conformance.py``), in
    float64 on the card: relative residual (and for band reduction the
    structure) over n·eps of the input dtype."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    a64, out64 = a.double(), out.double()
    if dmf == "ldlt":
        assert float(torch.triu(out, 1).abs().max()) == 0.0
        l = torch.tril(out64, -1) + torch.eye(n, dtype=torch.float64,
                                             device=a.device)
        d = torch.diagonal(out64)
        return _rel((l * d) @ l.mT, a64) / (n * eps)
    if dmf == "gauss_jordan":
        eye = torch.eye(n, dtype=torch.float64, device=a.device)
        return _rel(a64 @ out64, eye) / (n * eps)
    i = torch.arange(n, device=a.device)
    outside = (i[None, :] < i[:, None]) | (i[None, :] > i[:, None] + b)
    assert float(out[outside].abs().max()) == 0.0
    sv = torch.linalg.svdvals(a64)
    return float((torch.linalg.svdvals(out64) - sv).abs().max()
                 / sv.max()) / (n * eps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dmf", list(_NEW_DMFS))
@pytest.mark.parametrize("n,b", [(1024, 128), (1536, 384)])
def test_new_dmfs_variants_bitwise_on_the_card(card, dtype, dmf, n, b):
    """Every look-ahead variant bitwise ``mtb``; the path's kernels
    launched; the reference's contract; within the reference tolerance of
    ``backend="torch"`` (the library ops) on the card."""
    a = _new_dmf_input(dmf, n, dtype, card, 60)
    _, kernels, variants = _NEW_DMFS[dmf]
    ops.reset_launches()
    base = get_variant(dmf, "mtb")(a, b)
    for variant in variants:
        assert torch.equal(get_variant(dmf, variant)(a, b), base), variant
    counts = ops.launches()
    assert all(counts[k] > 0 for k in kernels), counts
    assert _contract(dmf, a, base, b) < 100.0
    lib = get_variant(dmf, "mtb")(a, b, backend="torch")
    assert _rel(base, lib) < _tol(dtype, n, n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gauss_jordan_in_place_update_equals_an_explicit_copy(card, dtype):
    """GJE's update reads the row block ``A[kr, :]`` inside the columns it
    writes, and the GEMM kernel writes in place with no alias check: the
    hooks copy that block first.  The in-place sweep equals, bitwise, one
    that gives every update operand as a copy of its own and writes a new
    matrix."""
    n, b = 1024, 128
    a = _spd(n, dtype, card, 61)
    got = get_variant("gauss_jordan", "mtb")(a, b)
    ref = a.clone()
    for st in panel_steps(n, b):
        k, bk = st.k, st.bk
        dinv = gauss_jordan.gj_inverse_unblocked(
            ref[k : k + bk, k : k + bk].clone())
        p = ref[:, k : k + bk].clone()
        p[k : k + bk].diagonal().sub_(1.0)
        m = ops.gemm(p, dinv)
        new = blis_gemm.gemm_accum(ref.clone(), m,
                                   ref[k : k + bk].clone())
        new[:, k : k + bk] = -m
        new[k : k + bk, k : k + bk].diagonal().add_(1.0)
        ref = new
    assert torch.equal(got, ref)
    # and the look-ahead variant, whose column ranges take the same kernel
    assert torch.equal(get_variant("gauss_jordan", "la2")(a, b), ref)


# ---------------------------------------------------------------------------
# The tile-DAG backend and "tuned" dispatch on the card.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_cholesky_is_the_rtm_factor(card, dtype):
    """Tiled Cholesky's POTRF is the Cholesky panel kernel on a diagonal
    tile, its TRSM the right TRSM kernel a tile at a time, its SYRK and
    GEMM the GEMM kernel a tile at a time: with row-decomposable kernels,
    the bits of ``rtm`` (and ``mtb``) at the same block."""
    n, b = 1024, 128
    a = _spd(n, dtype, card, 71)
    ops.reset_launches()
    tiled = get_variant("cholesky", "tiled")(a, b)
    launched = ops.launches()
    for name in ("cholesky_panel", "trsm_right_lower_t", "gemm_accum"):
        assert launched[name] > 0, name
    assert torch.equal(tiled, get_variant("cholesky", "rtm")(a, b))
    assert torch.equal(tiled, get_variant("cholesky", "mtb")(a, b))
    assert torch.equal(tiled, get_variant("cholesky", "tiled")(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_qr_is_deterministic_and_one_tile_is_geqrf(card, dtype):
    from repro_torch.core import tiles

    m, n, b = 1024, 512, 128
    a = _randn((m, n), dtype, card, seed=72)
    t1, t2 = tiles.qr_tiles(a, b), tiles.qr_tiles(a, b)
    assert torch.equal(t1.r, t2.r)
    for f1, f2 in zip(t1.factors, t2.factors, strict=True):
        assert torch.equal(f1.v, f2.v) and torch.equal(f1.t, f2.t)
    q = tiles.qr_form_q(t1).double()
    assert _rel(q @ t1.r.double(), a) < _tol(dtype, m, n)
    assert float(torch.linalg.matrix_norm(
        q.mT @ q - torch.eye(m, dtype=torch.float64, device=card))) < \
        _tol(dtype, m, n)
    one = _randn((512, 256), dtype, card, seed=73)
    single = tiles.qr_tiles(one, 512)
    packed, _ = get_variant("qr", "mtb")(one, 512)
    assert len(single.factors) == 1
    assert torch.equal(single.r, torch.triu(packed))


def test_tuned_dispatches_a_hand_written_entry(card, tmp_path):
    from repro_torch import tune

    n, dtype = 512, torch.float64
    a = _randn((n, n), dtype, card, seed=74)
    s = _spd(n, dtype, card, 75)
    rhs = _randn((n, 4), dtype, card, seed=76)
    cache = tune.TuneCache(tmp_path / "tune.json")
    old = tune.set_default_cache(cache)
    try:
        cache.put(tune.cache_key("lu", n, dtype, "cuda@cuda"),
                  tune.TuneConfig(dmf="lu", shape=(n, n), dtype="float64",
                                  backend="cuda@cuda", variant="la2",
                                  schedule=(192, 192, 128), seconds=1.0,
                                  baseline_seconds=1.0, depth=2))
        # the winner's factor; the solve at the caller's block (128)
        fac = lu_factor(a, variant="tuned")
        want = lu_factor(a, (192, 192, 128), variant="la2")
        assert torch.equal(fac.lu, want.lu)
        assert torch.equal(fac.ipiv, want.ipiv)
        assert torch.equal(gesv(a, rhs, variant="tuned"), fac.solve(rhs))
        # an entry measured on the CPU is not served on the card: la at
        # the caller's block
        cache.put(tune.cache_key("cholesky", n, dtype, "cuda@cpu"),
                  tune.TuneConfig(dmf="cholesky", shape=(n, n),
                                  dtype="float64", backend="cuda@cpu",
                                  variant="mtb", schedule=(64,), seconds=1.0,
                                  baseline_seconds=1.0))
        assert torch.equal(posv(s, rhs, 96, variant="tuned"),
                           posv(s, rhs, 96, variant="la"))
    finally:
        tune.set_default_cache(old)


# ---------------------------------------------------------------------------
# Batched solves and the bucketed solve server: padded == raw, bitwise.
# ---------------------------------------------------------------------------
#: the reference's server test shapes (block 32) and the larger systems of
#: chip_smoke.py's mix B (block 128): (dmf, m, n, nrhs)
SERVE_SHAPES = {
    32: [("gesv", 48, 48, 3), ("gesv", 33, 33, 1), ("gesv", 64, 64, 4),
         ("posv", 48, 48, 3), ("posv", 33, 33, 1), ("posv", 64, 64, 4),
         ("gels", 56, 30, 2), ("gels", 80, 17, 3), ("gels", 33, 20, 2),
         ("geqp3", 56, 30, 2), ("geqp3", 80, 17, 3), ("geqp3", 33, 20, 2)],
    128: [("gesv", 100, 100, 5), ("gesv", 250, 250, 16), ("gesv", 500, 500, 3),
          ("gesv", 1000, 1000, 9), ("posv", 128, 128, 1),
          ("posv", 384, 384, 7), ("posv", 768, 768, 16),
          ("gels", 1500, 120, 4), ("gels", 3000, 250, 11),
          ("geqp3", 1000, 100, 2),
          # the raw QRCP block resident in shared memory, its bucket's
          # (2048 x 1024) streamed: the routes round alike
          ("geqp3", 700, 600, 3)],
}


def _serve_input(dmf, m, n, nrhs, dtype, device, seed):
    a = _randn((m, n), dtype, device, seed)
    if dmf == "posv":
        a = a @ a.mT + n * torch.eye(n, dtype=dtype, device=device)
    return a, _randn((m, nrhs), dtype, device, seed + 1)


def _unbatched(dmf, a, b, block):
    if dmf == "geqp3":
        return gels(a, b, block, pivot=True)
    return {"gesv": gesv, "posv": posv, "gels": gels}[dmf](a, b, block)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dmf", ["gesv", "posv", "gels", "geqp3"])
def test_padded_bucket_bitwise_the_raw_shape(card, dmf, dtype):
    """Each raw system and its zero/identity-padded bucket give the same
    bits through the drivers, and the server's response is bitwise the
    unbatched driver's, at the reference's shapes (block 32) and at mix
    B's (block 128)."""
    from repro_torch.serve import ServerConfig, SolveServer, bucketing

    for block, shapes in SERVE_SHAPES.items():
        srv = SolveServer(ServerConfig(block=block))
        cases = []
        for i, (d, m, n, nrhs) in enumerate(shapes):
            if d != dmf:
                continue
            a, b = _serve_input(dmf, m, n, nrhs, dtype, card, 70 + 2 * i)
            key = bucketing.shape_class(dmf, m, n, nrhs, dtype)
            ap, bp = bucketing.pad_request(dmf, a, b, key)
            raw = _unbatched(dmf, a, b, block)
            padded = bucketing.extract(_unbatched(dmf, ap, bp, block), n, nrhs)
            assert torch.equal(raw, padded), \
                (dmf, m, n, block, float((raw - padded).abs().max()))
            cases.append((srv.submit(dmf, a, b), raw))
        srv.drain()
        for rid, raw in cases:
            assert torch.equal(srv.take(rid).x, raw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_drivers_bitwise_unbatched_on_card(card, dtype):
    from repro_torch.solve import batched

    a = _randn((5, 96, 96), dtype, card, 80)
    spd = a @ a.mT + 96 * torch.eye(96, dtype=dtype, device=card)
    b = _randn((5, 96, 3), dtype, card, 81)
    ops.reset_launches()
    xg = batched.gesv_batched(a, b)
    xp = batched.posv_batched(spd, b)
    counts = ops.launches()
    assert counts["lu_panel"] > 0 and counts["cholesky_panel"] > 0
    fl = batched.lu_factor_batched(a)
    fc = batched.cholesky_factor_batched(spd)
    for i in range(5):
        assert torch.equal(xg[i], gesv(a[i], b[i], 32))
        assert torch.equal(xp[i], posv(spd[i], b[i], 32))
    assert torch.equal(batched.solve_batched(fl, b), xg)
    assert torch.equal(batched.solve_batched(fc, b), xp)


def _padded_panel(panel, rows, cols, tail_diag):
    """``panel`` embedded as the reference's gels/geqp3 padding does: zero
    rows below, and ``cols`` extra columns that are zero but for a diagonal
    ``tail_diag`` in the rows just below the real ones."""
    m, nb = panel.shape
    out = torch.zeros((rows, nb + cols), dtype=panel.dtype,
                      device=panel.device)
    out[:m, :nb] = panel
    out[m : m + cols, nb:].diagonal()[:] = tail_diag
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb,rows,cols", [
    (56, 30, 96, 2), (80, 17, 128, 15), (1500, 120, 2048, 8),
    (2872, 122, 3968, 6), (4200, 64, 4224, 0), (4324, 100, 8192, 28),
    (20000, 64, 40000, 0)])
def test_qr_panel_padded_bitwise_raw(card, dtype, m, nb, rows, cols):
    """The QR panel's dealt 32-row chunks: a panel padded with zero rows and
    the identity-tail columns factors its real part to the raw panel's bits
    (R, V, tau and T) at every height (past 32 rows an SM too, on both
    routes), within its chain bound of the plain version."""
    raw = _randn((m, nb), dtype, card, 82)
    pad = _padded_panel(raw, rows, cols, 1.0)
    assert panel_qr.plan(m, nb, dtype)["chunk"] == 32
    assert panel_qr.plan(rows, nb + cols, dtype)["chunk"] == 32
    ref = pad.clone()
    _, tau_p, t_p = panel_qr.qr_panel_plain(ref)
    _, tau_r, t_r = panel_qr.qr_panel(raw)
    _, tau, t = panel_qr.qr_panel(pad)
    assert torch.equal(pad[:m, :nb], raw) and torch.equal(tau[:nb], tau_r)
    assert torch.equal(t[:nb, :nb], t_r)
    assert not pad[m:, :nb].any()
    tol = _chain_tol(dtype, panel_qr.plan(rows, nb + cols, dtype))
    assert _rel(pad, ref) < tol and _rel(t, t_p) < tol
    v_raw, v_pad = unpack_v(raw, nb), unpack_v(pad[:, :nb], nb)
    assert torch.equal(panel_qr.larft(v_pad, tau_r)[:nb, :nb],
                       panel_qr.larft(v_raw, tau_r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,c,rows,cols", [
    (80, 17, 128, 15), (56, 30, 96, 2), (1000, 100, 2048, 28),
    (4324, 100, 8192, 28)])
def test_qrcp_panel_padded_bitwise_raw(card, dtype, r, c, rows, cols):
    """The QRCP panel's dealt 32-row chunks and flat column sums: the padded
    block (zero rows, sqrt(tiny)-diagonal columns that lose every pivot
    race) gives the raw block's pivots and bits for its real steps, and the
    plain version's pivots."""
    raw = _randn((r, c), dtype, card, 84)
    tiny = torch.finfo(dtype).tiny ** 0.5
    pad = _padded_panel(raw, rows, cols, tiny)
    plan = panel_qrcp.plan(rows, c + cols, c, dtype)
    want = panel_qrcp.qrcp_panel_plain(pad.clone(), c)
    blk_r, v_r, f_r, tau_r, piv_r = panel_qrcp.qrcp_panel(raw, c)
    blk, v, f, tau, piv = panel_qrcp.qrcp_panel(pad, c)
    assert torch.equal(piv, piv_r) and torch.equal(piv, want[4])
    assert torch.equal(tau, tau_r) and torch.equal(v[:r], v_r)
    assert torch.equal(blk[:r, :c], blk_r) and torch.equal(f[:c], f_r)
    assert _rel(blk, want[0]) < _chain_tol(dtype, plan)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_padded_bitwise_raw(card, dtype):
    """GETF2's pivot search is a max with the first row on ties, whatever
    the grid: zero rows below (and a first column of ±1, all ties)
    change nothing."""
    raw = _randn((1000, 100), dtype, card, 86)
    raw[:, 0] = torch.where(raw[:, 0] > 0, 1.0, -1.0)
    pad = torch.zeros((1024, 128), dtype=dtype, device=card)
    pad[:1000, :100] = raw
    piv_r = panel_lu.lu_panel(raw)
    piv = panel_lu.lu_panel(pad)
    assert torch.equal(piv[:100], piv_r)
    assert torch.equal(pad[:1000, :100], raw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gels_bucket_past_the_fixed_blocks(card, dtype):
    """A gels bucket taller than 32 rows an SM: the QR panel deals its
    32-row chunks round-robin at every height, so the bucket's answer is
    the raw shape's, bitwise (and within the drivers' bound)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    m, n, nrhs = 32 * sms + 100, 100, 4
    from repro_torch.serve import bucketing

    a, b = _serve_input("gels", m, n, nrhs, dtype, card, 88)
    key = bucketing.shape_class("gels", m, n, nrhs, dtype)
    assert panel_qr.plan(key.m, key.n, dtype)["rows"] > 32
    ap, bp = bucketing.pad_request("gels", a, b, key)
    raw = gels(a, b, 128)
    padded = bucketing.extract(gels(ap, bp, 128), n, nrhs)
    print(f"gels {m}x{n} in its {key.m}x{key.n} bucket, {dtype}: "
          f"max |raw - padded| = {float((raw - padded).abs().max())!r}")
    assert torch.equal(padded, raw)
    assert _rel(padded, raw) < _tol(dtype, m, n)


# ---------------------------------------------------------------------------
# The mesh engine on the card.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_trsm_column_decomposable_at_mesh_widths(card, dtype):
    """The mesh engine's local updates: a rank's run of blocks (nd 4 and 2)
    and one block give each column the wide call's bits, GEMM and TRSM
    (lower unit, upper)."""
    n, b = 2048, 128
    a = _randn((n - b, b), dtype, card, 90)
    bm = _randn((b, n), dtype, card, 91)
    c = _randn((n - b, n), dtype, card, 92)
    lo = torch.tril(_randn((b, b), dtype, card, 93)) \
        + b * torch.eye(b, dtype=dtype, device=card)
    up = lo.mT.contiguous()
    wide = blis_gemm.gemm_accum(c, a, bm, alpha=-1.0)
    wide_l = trsm.trsm(lo, bm, lower=True, unit_diagonal=True)
    wide_u = trsm.trsm(up, bm, lower=False)
    for c0, c1 in ((0, n // 4), (n // 4, n // 2), (n // 2, n), (b, 2 * b),
                   (n - b, n)):
        assert torch.equal(blis_gemm.gemm_accum(c[:, c0:c1], a, bm[:, c0:c1],
                                                alpha=-1.0), wide[:, c0:c1])
        assert torch.equal(trsm.trsm(lo, bm[:, c0:c1], lower=True,
                                     unit_diagonal=True), wide_l[:, c0:c1])
        assert torch.equal(trsm.trsm(up, bm[:, c0:c1], lower=False),
                           wide_u[:, c0:c1])


def _two_rank_job(rank, n, b):
    """Both ranks of a same-card world: gesv/posv/gels over a (2,) mesh; rank
    0 holds each against the single-device port, bitwise."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
    out = {"transport": D.transport(mesh, "model", dev).name}
    for dtype in DTYPES:
        for name, fn, fields, shape in (
                ("gesv", lu_factor, ("lu", "ipiv"), (n, n)),
                ("posv", cholesky_factor, ("l",), (n, n)),
                ("gels", qr_factor, ("packed", "taus"), (2 * n, n))):
            a = _randn(shape, dtype, dev, 94)
            if name == "posv":
                a = (a + a.mT) / 2 + n * torch.eye(n, dtype=dtype, device=dev)
            rhs = _randn((shape[0], 3), dtype, dev, 95)
            for variant in ("mtb", "la2"):
                fac = fn(a, b, variant=variant, mesh=mesh)
                x = fac.solve(rhs)
                if rank == 0:
                    one = fn(a, b, variant=variant)
                    out[f"{name}:{dtype}:{variant}"] = all(
                        torch.equal(getattr(fac, f), getattr(one, f))
                        for f in fields) and torch.equal(x, one.solve(rhs))
    return out


def test_mesh_two_ranks_on_one_card_bitwise(card):
    """A 2-rank world on one card (gloo, collectives staged through host
    tensors; NCCL where each rank has a card of its own): gesv, posv and
    gels at n 1024 bitwise the single-device port, factors and pivots
    included."""
    from repro_torch.launch import mesh as M

    got = M.spawn(_two_rank_job, 2, (1024, 128), device_type="cuda",
                  timeout=600)[0]
    want = "gloo+host" if torch.cuda.device_count() < 2 else "nccl"
    assert got.pop("transport") == want
    assert len(got) == 12 and all(got.values()), got


# ---------------------------------------------------------------------------
# Training: the kernels' Functions and one trainer step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_on_the_card(card, dtype):
    """``FlashAttentionFn`` launches the kernel once a forward; its
    gradients are bitwise autograd through ``chunked_attention_plain`` on
    the same inputs and output gradient, and the forward within
    ``attn_expect``'s bound."""
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(2, 8, 256, 64, generator=gen, device=card).to(dtype)
    k = torch.randn(2, 2, 256, 64, generator=gen, device=card).to(dtype)
    v = torch.randn(2, 2, 256, 64, generator=gen, device=card).to(dtype)
    g = torch.randn(2, 8, 256, 64, generator=gen, device=card).to(dtype)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attn.flash_attention.launches = 0
    out = attn.flash_attention_train(*a, chunk_q=128, chunk_k=128)
    assert attn.flash_attention.launches == 1
    out.backward(g)
    assert attn.flash_attention.launches == 1
    attn.chunked_attention_plain(*b, chunk_q=128, chunk_k=128).backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)
    want, tol = attn.attn_expect(q, k, v)
    assert bool(((out.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_fn_on_the_card(card, dtype):
    """``Wkv6Fn`` launches the kernel once a forward; its gradients (r, k,
    v, logw, u, s0) are bitwise autograd through ``wkv6_fused_plain``, the
    forward within ``wkv6_expect``'s bound."""
    gen = torch.Generator(device=card).manual_seed(1)
    shape = (2, 4, 200, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for _ in range(3))
    logw = -torch.exp(-0.6 + 0.42 * torch.randn(shape, generator=gen,
                                                device=card))
    u = 0.5 * torch.randn(4, 64, generator=gen, device=card)
    s0 = 0.1 * torch.randn(2, 4, 64, 64, generator=gen, device=card)
    go = torch.randn(2, 4, 200, 64, generator=gen, device=card)
    gs = torch.randn(2, 4, 64, 64, generator=gen, device=card)
    ins = (r, k, v, logw, u, s0)
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    wkv6.wkv6_fused.launches = 0
    out, s = wkv6.wkv6_train(*a[:5], s0=a[5], chunk=64)
    assert wkv6.wkv6_fused.launches == 1
    torch.autograd.backward((out, s), (go, gs))
    assert wkv6.wkv6_fused.launches == 1
    torch.autograd.backward(wkv6.wkv6_fused_plain(*b[:5], s0=b[5], chunk=64),
                            (go, gs))
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)
    want, tol, s_want, s_tol = wkv6.wkv6_expect(r, k, v, logw, u, s0=s0,
                                                chunk=64)
    assert bool(((out.double() - want).abs() <= tol).all())
    assert bool(((s.double() - s_want).abs() <= s_tol).all())


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "rwkv6-7b"])
def test_trainer_step_on_the_card(card, arch):
    """One trainer step of the reduced model (bfloat16, remat on, 2
    layers, S 64) on the card: the kernel launches twice a layer (forward
    and remat recompute), the loss is finite and within 1e-2 relative of
    the same step on the CPU from the same state, the params move."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticTask
    from repro_torch.models import convert
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="bfloat16", remat=True)
    src = SyntheticTask(vocab_size=cfg.vocab_size, seq_len=64)
    tc = TrainerConfig(per_device_batch=4, peak_lr=1e-3, warmup_steps=1)
    gpu = Trainer(cfg, tc, src, device=card)
    cpu = Trainer(cfg, tc, src, device="cpu")
    cpu.state = convert.train_state_from_numpy(
        cfg, convert.train_state_to_numpy(gpu.state), "cpu")
    kernel = "flash_attention" if arch.startswith("phi3") else "wkv6_fused"
    ops.reset_launches()
    state, m = gpu.train_step(gpu.state, gpu._host_batch(0))
    assert ops.launches()[kernel] == 2 * cfg.num_layers
    _, m_cpu = cpu.train_step(cpu.state, cpu._host_batch(0))
    loss, want = float(m["loss"]), float(m_cpu["loss"])
    assert np.isfinite(loss) and abs(loss - want) <= 1e-2 * want
    assert not torch.equal(state.params["embed"]["tok"],
                           gpu.state.params["embed"]["tok"])

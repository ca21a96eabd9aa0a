"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Phase 3 of ``chip_smoke.py`` at small shapes: every kernel is built from
``src/repro_torch/kernels/csrc`` and compared with its plain version on the
card.  The kernel and its plain version sum the same terms in the same
order, so they are held to 4·max(k,8)·eps relative, k being the number of
terms summed per element (the panel bitwise; the fused panel updates
bitwise against the kernels they replace; the QR and QRCP panels, whose
reductions group differently from their plain versions, within
4·max(m,nb,8)·eps, pivots equal; the Hessenberg panel within 4·c·eps, c
the longest chain of terms it sums for one element; flash attention and
WKV6 within elementwise bounds of their plain versions run in float64);
whole solves keep the reference's 200·max(m,n,8)·eps, and every schedule
of LU, Cholesky, QR, ``qrcp_local`` and Hessenberg gives bitwise the
factors of ``mtb``.  Marked ``cuda``;
each test skips (inside the ``card`` fixture, never at import or
collection) when no GPU is present.  On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cholesky import cholesky_panel
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
    with pytest.raises(ValueError, match="at most 256"):
        trsm.trsm_right_lower_t(torch.eye(300, device=card),
                                torch.ones(2, 300, device=card))
    with pytest.raises(ValueError, match="unit stride"):
        trsm.trsm_right_lower_t(a, a.mT)
    with pytest.raises(ValueError, match="at most 256"):
        fpu.fused_lu_panel_update(torch.eye(300, device=card, dtype=a.dtype),
                                  torch.ones(40, 300, device=card,
                                             dtype=a.dtype),
                                  torch.ones(300, 8, device=card,
                                             dtype=a.dtype),
                                  torch.ones(40, 8, device=card, dtype=a.dtype))
    big = torch.ones(400, 200, device=card, dtype=a.dtype)
    with pytest.raises(ValueError, match="shared memory"):
        fpu.fused_cholesky_panel_update(big[:200, :16], big[:, :16], big)
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
                                       "trsm_right_lower_t",
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
    the Cholesky panel (PyTorch ops on the card and the right TRSM)."""
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
@pytest.mark.parametrize("m", [8064, 200, 129])
def test_fused_cholesky_matches_composed_kernels_bitwise_and_plain(
        card, dtype, m):
    lrow, l21, panel = _chol_operands(m, 128, 128, dtype, card, 19)
    composed = _composed_cholesky(lrow, l21, panel.clone())
    plain = fpu.fused_cholesky_panel_update_plain(lrow, l21, panel.clone())
    before = fpu.fused_cholesky_panel_update.launches
    got = fpu.fused_cholesky_panel_update(lrow, l21, panel)
    assert fpu.fused_cholesky_panel_update.launches == before + 1
    assert got.data_ptr() == panel.data_ptr()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, composed)
    assert _rel(got, plain) < _kernel_tol(dtype, 256)


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
    tol = _kernel_tol(dtype, max(r, c))
    for x, y in zip(got[:4], want[:4]):
        assert _rel(x, y) < tol


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


def _hessenberg_chain(n, k, bk, grid):
    """The longest chain of terms the Hessenberg panel kernel sums for one
    element: a GEMV row (a lane's share of the n − k columns, then five
    shuffle steps) or a cross-block sum (a block's rows, then the G
    partials), followed by the 2·bk terms of the right and left updates."""
    return max(-(-(n - k) // 32) + 5, -(-n // grid) + grid) + 2 * bk


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
    g = panel_hessenberg._grid(
        "f64" if dtype == torch.float64 else "f32", n, bk)
    tol = _kernel_tol(dtype, _hessenberg_chain(n, k, bk, g))
    for x, y in zip(got, want):
        assert _rel(x, y) < tol
    if k + bk >= n - 1:                    # the last two columns: tau = 0
        assert float(got[4][n - 2 - k]) == 0.0
    again = panel_hessenberg.hessenberg_panel(orig, k, bk)   # ld = n
    assert all(torch.equal(x, y) for x, y in zip(again, got))


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

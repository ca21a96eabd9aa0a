"""The GEMM's deterministic split-K, on the CPU.

``csrc/gemm.cu`` cuts K into chunks of ``KC`` terms: chunk 0 starts from
``β·C``, every later chunk from 0, each sums in ascending k, and the chunks
are then added in order.  Its plain version ``gemm_accum_plain`` (what the
wrappers run on CPU tensors) sums the same way; here it meets the
reference's Pallas GEMM (interpret mode on the CPU, float32 accumulation,
so the reference's 200·max(m,n,8)·eps at float32), is held bitwise to
itself on slices (an element's sum depends on K alone, not on the shape of
the call), and, for K ≤ KC, bitwise to the one ascending chain written out
here.  ``tests/test_torch_cuda.py`` holds the kernel to it on the card.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import _build, blis_gemm, ops

jax.config.update("jax_enable_x64", True)

DTYPES = (np.float32, np.float64)
KC = blis_gemm.KC
K_SPLIT = 2 * KC + 37        # three chunks, the last one short


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tol(m, n):
    """Pallas-reference tolerance: the reference kernels compute in f32."""
    return 200.0 * max(m, n, 8) * float(np.finfo(np.float32).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def _chain(c, a, b, alpha, beta):
    """One ascending chain from β·C: the sum before the split, written out."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype) if beta == 0 \
        else c * beta
    for p in range(a.shape[1]):
        acc += (a[:, p : p + 1] * alpha) * b[p : p + 1, :]
    return acc


def test_kc_is_the_kernel_source_constant():
    """The plain version's KC is the kernels' (``csrc/dense.cuh``, which
    the GEMM and the fused LU panel update share; the card tests also read
    it back from the built library through ``plan``)."""
    found = re.findall(r"constexpr int64_t KC = (\d+);",
                       (_build.CSRC / "dense.cuh").read_text())
    assert found == [str(KC)]
    assert KC % 16 == 0   # whole k slices of the kernel's tiles


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", [(12, 11), (1, 1), (5, 12)])
def test_split_gemm_accum_plain_matches_pallas(dtype, m, n):
    c, a, b = _rand((m, n), 1, dtype), _rand((m, K_SPLIT), 2, dtype), \
        _rand((K_SPLIT, n), 3, dtype)
    ref = ref_ops.gemm_accum(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b))
    got = blis_gemm.gemm_accum(torch.from_numpy(c), torch.from_numpy(a),
                               torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(c).dtype
    assert _rel(got, ref) < _tol(m, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", [(12, 11), (7, 3)])
def test_split_gemm_plain_matches_pallas(dtype, m, n):
    a, b = _rand((m, K_SPLIT), 4, dtype), _rand((K_SPLIT, n), 5, dtype)
    ref = ref_ops.gemm(jnp.asarray(a), jnp.asarray(b))
    before = blis_gemm.gemm_accum.launches
    got = ops.gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert blis_gemm.gemm_accum.launches == before   # CPU: the plain version
    assert _rel(got, ref) < _tol(m, n)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("rows,cols", [(slice(3, None), slice(None)),
                                       (slice(None), slice(4, 9)),
                                       (slice(5, 6), slice(10, 11))])
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_split_plain_is_row_and_column_decomposable_bitwise(dtype, rows, cols,
                                                            beta):
    g = torch.Generator().manual_seed(6)
    c = torch.randn(12, 12, generator=g, dtype=dtype)
    a = torch.randn(12, K_SPLIT, generator=g, dtype=dtype)
    b = torch.randn(K_SPLIT, 12, generator=g, dtype=dtype)
    whole = blis_gemm.gemm_accum_plain(c, a, b, beta=beta)
    part = blis_gemm.gemm_accum_plain(c[rows, cols], a[rows], b[:, cols],
                                      beta=beta)
    assert torch.equal(whole[rows, cols], part)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("k", [1, 37, KC])
@pytest.mark.parametrize("alpha,beta", [(-1.0, 1.0), (1.0, 0.0), (0.5, 2.0)])
def test_short_k_is_one_ascending_chain_bitwise(dtype, k, alpha, beta):
    g = torch.Generator().manual_seed(7)
    c = torch.randn(9, 10, generator=g, dtype=dtype)
    a = torch.randn(9, k, generator=g, dtype=dtype)
    b = torch.randn(k, 10, generator=g, dtype=dtype)
    got = blis_gemm.gemm_accum_plain(c, a, b, alpha=alpha, beta=beta)
    assert torch.equal(got, _chain(c, a, b, alpha, beta))


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_split_sums_each_chunk_from_zero_then_adds_in_order(dtype):
    g = torch.Generator().manual_seed(8)
    c = torch.randn(4, 5, generator=g, dtype=dtype)
    a = torch.randn(4, K_SPLIT, generator=g, dtype=dtype)
    b = torch.randn(K_SPLIT, 5, generator=g, dtype=dtype)
    chunks = [slice(0, KC), slice(KC, 2 * KC), slice(2 * KC, K_SPLIT)]
    want = _chain(c, a[:, chunks[0]], b[chunks[0]], -1.0, 1.0)
    for s in chunks[1:]:
        want = want + _chain(None, a[:, s], b[s], -1.0, 0.0)
    got = blis_gemm.gemm_accum(c, a, b)
    assert torch.equal(got, want)
    assert not torch.equal(got, _chain(c, a, b, -1.0, 1.0))


def test_split_keeps_small_terms_a_single_chain_would_lose():
    # float32, K = 2·KC: a leading 1, then 2·KC − 1 terms of 2^-25.  One
    # chain rounds every 1 + 2^-25 back to 1 (a tie, to even); the split
    # sums chunk 1's KC terms to 2^-15 first, and 1 + 2^-15 is exact.
    a = torch.full((1, 2 * KC), 2.0 ** -25)
    a[0, 0] = 1.0
    b = torch.ones(2 * KC, 1)
    assert blis_gemm.gemm(a, b).item() == 1.0 + 2.0 ** -15
    assert _chain(None, a, b, 1.0, 0.0).item() == 1.0

"""The port's attention and layer functions against the reference, on the CPU.

The same NumPy inputs (seeded) go through ``repro`` (JAX; the Pallas flash
kernel in interpret mode) and ``repro_torch`` (the plain PyTorch versions,
which is what a CPU tensor runs).  Everything is float32, and the two
sides differ by summation order only: the flash kernel is held to the
reference test's ``atol 2e-5`` (``tests/test_kernels.py``), the rest to
``1e-5`` of the largest output, at least 1e-6 absolute.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as ref_kernels
from repro.kernels.attention import flash_attention as ref_flash
from repro.models import layers as RL
from repro_torch.kernels import attention as attn
from repro_torch.models import layers as L


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    tol = max(1e-5 * float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The flash kernel's plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------
FLASH_CASES = [((1, 2, 1, 128, 64), True), ((1, 2, 1, 128, 64), False),
               ((2, 4, 2, 256, 64), True), ((2, 4, 2, 256, 64), False)]


@pytest.fixture(scope="module")
def flash_reference():
    """The reference's interpret-mode kernel on each case, once."""
    out = {}
    for (b, h, hkv, s, d), causal in FLASH_CASES:
        q, k, v = (_np((b, h, s, d), 40), _np((b, hkv, s, d), 41),
                   _np((b, hkv, s, d), 42))
        o = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, block_q=128, block_k=128, interpret=True)
        out[(b, h, hkv, s, d), causal] = (q, k, v, np.asarray(o))
    return out


@pytest.mark.parametrize("shape,causal", FLASH_CASES)
def test_plain_flash_matches_reference_kernel(flash_reference, shape,
                                              causal):
    q, k, v, want = flash_reference[shape, causal]
    before = attn.flash_attention.launches
    got = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    assert attn.flash_attention.launches == before   # the CPU never launches
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the kernel's own tile size gives the same result
    tiles = attn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(tiles.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("sq,sk,causal", [(64, 64, True), (48, 80, True),
                                          (100, 37, False)])
def test_oracle_matches_reference_oracle(sq, sk, causal):
    q, k, v = _np((sq, 32), 1), _np((sk, 32), 2), _np((sk, 16), 3)
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal)
    want = ref_kernels.attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    _close(got, want)


@pytest.mark.parametrize("sq,causal", [(100, True), (100, False),
                                       (1, True)])
def test_plain_flash_ragged_blocks_match_the_oracle(sq, causal):
    # Sq = Sk not a multiple of the block: short last blocks
    b, h, hkv, d = 1, 4, 2, 32
    q = torch.from_numpy(_np((b, h, sq, d), 4))
    k = torch.from_numpy(_np((b, hkv, sq, d), 5))
    v = torch.from_numpy(_np((b, hkv, sq, d), 6))
    got = attn.flash_attention_plain(q, k, v, causal=causal, block_q=64,
                                     block_k=48)
    for hi in range(h):
        want = attn.attention(q[0, hi], k[0, hi // 2], v[0, hi // 2],
                              causal=causal)
        _close(got[0, hi], want.numpy())


def _p_rounded_once(q, k, v, block_k=64):
    """The plain version with P·V formed from P rounded once to bfloat16
    (what a kernel that does not split P computes), float32 elsewhere."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, sq, d)
    kf, vf = k.float().unsqueeze(2), v.float().unsqueeze(2)
    pos = torch.arange(max(sq, sk))
    shape = qf.shape[:-1] + (1,)
    m = torch.full(shape, attn.NEG_INF)
    l, acc = torch.zeros(shape), torch.zeros(qf.shape)
    for j in range(0, sk, block_k):
        s = qf @ kf[:, :, :, j:j + block_k].mT * d ** -0.5
        s = torch.where(pos[:sq, None] >= pos[None, j:j + block_k], s,
                        attn.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, :, j:j + block_k]
        m = m_new
    return (acc / l).bfloat16().reshape(b, h, sq, d)


def test_bf16_bound_takes_the_split_p_and_rejects_p_rounded_once():
    # causal GQA in bfloat16 at the bound the card holds the kernel to: the
    # plain version (P·V from P_hi + P_lo, as the kernel forms it) lies
    # within it; P rounded once to bfloat16 does not, nor do the two
    # planted faults
    b, h, hkv, s, d = 1, 8, 2, 256, 128
    q, k, v = (torch.from_numpy(_np(shape, seed)).bfloat16()
               for shape, seed in (((b, h, s, d), 70), ((b, hkv, s, d), 71),
                                   ((b, hkv, s, d), 72)))
    want, tol = attn.attn_expect(q, k, v)

    def ratio(x):
        return float(((x.double() - want).abs() / tol).max())

    got = attn.flash_attention(q, k, v, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16 and ratio(got) <= 1.0
    assert ratio(_p_rounded_once(q, k, v)) > 1.0
    faults = attn.attn_faults(q, k, v, got)
    assert set(faults) == {"tile_skipped", "half_rows_zero"}
    for name, wrong in faults.items():
        assert ratio(wrong) > 1.0, name


def test_flash_wrapper_refuses_grad_and_window_on_every_device():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="backward"):
        attn.flash_attention(q.clone().requires_grad_(), q, q)
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        attn.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="query heads"):
        attn.flash_attention(torch.zeros(1, 3, 8, 32), q, q)


# ---------------------------------------------------------------------------
# chunked_attention and decode_attention against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset", [0, 7])
def test_chunked_attention_matches_reference(causal, offset):
    # reduced phi3's GQA (4 query heads over 1 KV head), S over 4 q chunks
    # and 2 kv chunks
    b, g, hg, s, d = 2, 1, 4, 256, 32
    q, k, v = (_np((b, g, hg, s, d), 10), _np((b, g, s, d), 11),
               _np((b, g, s, d), 12))
    pos = np.arange(s, dtype=np.int32) + offset
    want = RL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                jnp.asarray(pos), causal=causal, chunk_q=64,
                                chunk_k=128)
    got = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(pos),
                              torch.from_numpy(pos), causal=causal,
                              chunk_q=64, chunk_k=128)
    assert got.shape == (b, g, hg, s, d)
    _close(got, want)


def test_chunked_attention_keeps_the_shape_rule_and_refuses_window():
    q, k = torch.zeros(1, 1, 2, 96, 32), torch.zeros(1, 1, 96, 32)
    pos = torch.arange(96)
    with pytest.raises(ValueError, match="multiples"):
        L.chunked_attention(q, k, k, pos, pos, chunk_q=64, chunk_k=64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        L.chunked_attention(q, k, k, pos, pos, window=16, chunk_q=32,
                            chunk_k=32)


@pytest.mark.parametrize("qpos", [[5, 9], [0, 11]])
def test_decode_attention_matches_reference_with_unfilled_slots(qpos):
    b, g, hg, w, d = 2, 2, 3, 12, 32
    q, k, v = (_np((b, g, hg, 1, d), 20), _np((b, g, w, d), 21),
               _np((b, g, w, d), 22))
    kpos = np.tile(np.arange(w, dtype=np.int32), (b, 1))
    kpos[:, 10:] = -1                      # unfilled slots
    qp = np.asarray(qpos, dtype=np.int32)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(kpos), jnp.asarray(qp))
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(kpos),
                             torch.from_numpy(qp))
    _close(got, want)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_attn_mask_matches_reference(causal, window):
    qpos = np.arange(12, dtype=np.int32) + 4
    kpos = np.arange(16, dtype=np.int32)
    want = RL._attn_mask(jnp.asarray(qpos), jnp.asarray(kpos), causal=causal,
                         window=window)
    got = L._attn_mask(torch.from_numpy(qpos), torch.from_numpy(kpos),
                       causal=causal, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Norms, RoPE, MLPs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_reference(plus_one):
    x, w = _np((2, 5, 64), 30), _np((64,), 31)
    want = RL.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                      plus_one=plus_one)
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6,
                     plus_one=plus_one), want)


def test_layernorm_matches_reference():
    x, w, bias = _np((2, 5, 64), 32), _np((64,), 33), _np((64,), 34)
    want = RL.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    _close(L.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(bias)), want)


def test_rope_matches_reference():
    x = _np((2, 3, 4, 40, 32), 35)
    pos = np.tile(np.arange(40, dtype=np.int32) + 1000, (2, 1))
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos)[:, None, None],
                   theta=10000.0)
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos)[:, None, None],
                  theta=10000.0), want)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_block_matches_reference(mlp_type):
    class Cfg:
        pass

    cfg = Cfg()
    cfg.mlp_type = mlp_type
    d, f = 32, 48
    p = {"w_up": _np((d, f), 36) * 0.2, "w_down": _np((f, d), 37) * 0.2}
    if mlp_type != "gelu":
        p["w_gate"] = _np((d, f), 38) * 0.2
    x = _np((2, 5, d), 39)
    want = RL.mlp_block(cfg, {k: jnp.asarray(a) for k, a in p.items()},
                        jnp.asarray(x))
    got = L.mlp_block(cfg, {k: torch.from_numpy(a) for k, a in p.items()},
                      torch.from_numpy(x))
    _close(got, want)

"""The port's training loss and gradients against the reference, on the CPU.

Reduced phi3-medium-14b and rwkv6-7b (``reduced_config``: 2 layers, d 128,
4 heads of 32, vocab 512; remat on, so each layer of the stacked segment
runs under ``torch.utils.checkpoint``) with the reference's seeded
bfloat16 weights carried across by ``params_from_numpy``; the same NumPy
tokens through ``jax.value_and_grad`` of ``repro.models.api.loss_fn`` and
through the port's ``loss_fn`` and ``torch.autograd.grad``, on both of its
branches (fused chunked unembed + xent without a mask, the whole logits
through ``softmax_xent`` with one).

Tolerances.  float32 (the bfloat16 weights upcast): both sides compute
the same float32 formulas and differ by summation order only; the loss is
held to 1e-5 relative and every gradient leaf to 1e-4 of its largest
entry (measured: under 1e-5).  bfloat16: the two sides round activations
at different places, so each gradient leaf is held, in relative Frobenius
norm, to twice the distance between the reference's own bfloat16 and
float32 gradients plus 1e-3 (the rounding witness; measured ratio under
1.4), and the loss to 1e-3 relative.

The attention and WKV6 Functions are held by ``torch.autograd.gradcheck``
in float64 at tiny shapes (an RWKV case with the ±80 clip engaged), their
backward bitwise the plain formulation's autograd, and the kernels' guards
against operands that require a gradient are kept.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro_torch import tree
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import attention as A
from repro_torch.kernels import wkv6 as W
from repro_torch.models import api, convert

ARCHS = ("phi3-medium-14b", "rwkv6-7b")
B, S = 2, 64


def _np32(tree_):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree_)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reference's bfloat16 weights (and their float32 upcast), the
    tokens, and the reference's loss and gradients: float32 without and
    with a mask, bfloat16 without."""
    arch = request.param
    cfg_r = dataclasses.replace(ref_reduced_config(ref_get_config(arch)),
                                dtype="bfloat16", remat=True)
    cfg_r32 = dataclasses.replace(cfg_r, dtype="float32")
    params_r = jax.jit(lambda key: ref_api.init_params(cfg_r, key)[0])(
        jax.random.PRNGKey(0))
    params_r32 = jax.tree.map(lambda x: x.astype(jnp.float32), params_r)
    toks = np.random.default_rng(0).integers(
        0, cfg_r.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (np.random.default_rng(1).random((B, S)) < 0.8).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    masked = dict(batch, mask=mask)

    def ref(cfg_, params, b):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref_api.loss_fn(cfg_, p, jb)))(params)
        return float(loss), tree.leaves(_np32(grads))

    return {"arch": arch, "batch": batch, "masked": masked,
            "params_np": jax.tree.map(np.asarray, params_r),
            "params_np32": jax.tree.map(np.asarray, params_r32),
            "f32": ref(cfg_r32, params_r32, batch),
            "f32_masked": ref(cfg_r32, params_r32, masked),
            "bf16": ref(cfg_r, params_r, batch),
            "bf16_masked": ref(cfg_r, params_r, masked),
            "logits_r": np.asarray(jax.jit(lambda p: ref_api.apply_train(
                cfg_r32, p, {"tokens": jnp.asarray(batch["tokens"])}))(
                    params_r32))}


def _port(arch, dtype, params_np, batch, remat=True):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype,
                              remat=remat)
    params = convert.params_from_numpy(cfg, params_np, device="cpu")
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = api.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.float().numpy() for g in grads]


def _f32_close(got, want):
    loss, grads = got
    loss_r, grads_r = want
    assert abs(loss - loss_r) <= 1e-5 * abs(loss_r), (loss, loss_r)
    assert len(grads) == len(grads_r)
    for g, r in zip(grads, grads_r):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_f32_chunked(case, remat):
    """The fused chunked unembed + xent branch (no mask), with and without
    remat."""
    _f32_close(_port(case["arch"], "float32", case["params_np32"],
                     case["batch"], remat=remat), case["f32"])


def test_loss_and_grads_f32_masked(case):
    """The masked branch: the whole logits through ``softmax_xent``."""
    _f32_close(_port(case["arch"], "float32", case["params_np32"],
                     case["masked"]), case["f32_masked"])


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_bf16(case, masked):
    """Both branches in bfloat16, each leaf against the rounding witness
    of its branch."""
    key = "masked" if masked else "batch"
    loss, grads = _port(case["arch"], "bfloat16", case["params_np"],
                        case[key])
    loss_r, grads_r = case["bf16_masked" if masked else "bf16"]
    _, grads_32 = case["f32_masked" if masked else "f32"]
    assert abs(loss - loss_r) <= 1e-3 * abs(loss_r), (loss, loss_r)
    for g, r, r32 in zip(grads, grads_r, grads_32):
        dev = np.linalg.norm(g - r) / np.linalg.norm(r)
        witness = np.linalg.norm(r - r32) / np.linalg.norm(r32)
        assert dev <= 2.0 * witness + 1e-3, (dev, witness)


def test_apply_train_logits(case):
    """``apply_train``'s logits (float32), differentiable, against the
    reference's to 1e-5 of the largest |logit|."""
    cfg = dataclasses.replace(reduced_config(get_config(case["arch"])),
                              remat=True)
    params = convert.params_from_numpy(cfg, case["params_np32"],
                                       device="cpu")
    for t in tree.leaves(params):
        t.requires_grad_(True)
    logits = api.apply_train(cfg, params, {"tokens": case["batch"]["tokens"]})
    assert logits.requires_grad and logits.dtype == torch.float32
    want = case["logits_r"]
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_chunked_unembed_xent_ragged_falls_back():
    """A sequence that is not a multiple of the 512-token chunk takes the
    whole-logits ``softmax_xent``, as the reference does; a multiple gives
    the same value chunked."""
    from repro_torch.models import layers as L
    cfg = reduced_config(get_config("phi3-medium-14b"))
    gen = torch.Generator().manual_seed(0)
    emb = {"tok": torch.randn(cfg.vocab_size, cfg.d_model, generator=gen),
           "unembed": torch.randn(cfg.d_model, cfg.vocab_size,
                                  generator=gen) * 0.1}
    for s in (600, 1024):
        h = torch.randn(1, s, cfg.d_model, generator=gen)
        y = torch.randint(0, cfg.vocab_size, (1, s), generator=gen)
        whole = L.softmax_xent(L.matmul_f32(h, emb["unembed"]), y)
        got = L.chunked_unembed_xent(cfg, emb, h, y)
        assert abs(float(got) - float(whole)) <= 1e-5 * float(whole)


# ---------------------------------------------------------------------------
# The Functions
# ---------------------------------------------------------------------------
def _f64(*shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, dtype=torch.float64)
            * scale).requires_grad_(True)


@pytest.mark.parametrize("chunks", [(4, 4), (2, 8)])
def test_flash_attention_fn_gradcheck(chunks):
    """``FlashAttentionFn`` in float64 (B 1, 4 query heads over 2 KV heads,
    S 8, D 4, causal), over two chunkings; gradcheck's default
    tolerances (1e-5 absolute, 1e-3 relative) against central
    differences (``fast_mode``: along random directions)."""
    gen = torch.Generator().manual_seed(0)
    q = _f64(1, 4, 8, 4, gen=gen)
    k, v = _f64(1, 2, 8, 4, gen=gen), _f64(1, 2, 8, 4, gen=gen)
    cq, ck = chunks
    fn = lambda q, k, v: A.flash_attention_train(q, k, v, chunk_q=cq,
                                                 chunk_k=ck)
    assert torch.autograd.gradcheck(fn, (q, k, v), fast_mode=True)


def test_flash_attention_fn_bitwise_plain():
    """The Function's gradients are bitwise autograd through
    ``chunked_attention_plain`` on the same inputs and output gradient
    (float32 and bfloat16), and its forward is the kernel's plain
    version."""
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 4, 32, 16, generator=gen).to(dtype)
        k = torch.randn(2, 2, 32, 16, generator=gen).to(dtype)
        v = torch.randn(2, 2, 32, 16, generator=gen).to(dtype)
        g = torch.randn(2, 4, 32, 16, generator=gen).to(dtype)
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        b = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = A.flash_attention_train(*a, chunk_q=16, chunk_k=8)
        assert torch.equal(out, A.flash_attention(q, k, v, block_q=16,
                                                  block_k=8))
        out.backward(g)
        A.chunked_attention_plain(*b, chunk_q=16, chunk_k=8).backward(g)
        for x, y in zip(a, b):
            assert torch.equal(x.grad, y.grad)


def _wkv_inputs(gen, b=1, h=2, s=20, d=4, clip=False):
    r, k, v = (_f64(b, h, s, d, gen=gen) for _ in range(3))
    # log w in (-inf, 0); with ``clip`` about -30 a token, so the
    # cumulative sum passes -80 inside a chunk of 8
    base = torch.rand((b, h, s, d), generator=gen, dtype=torch.float64)
    logw = (-(25.0 + 10 * base) if clip else -torch.exp(-0.6 + base - 0.5))
    u = _f64(h, d, gen=gen, scale=0.5)
    s0 = _f64(b, h, d, d, gen=gen, scale=0.3)
    return r, k, v, logw.requires_grad_(True), u, s0


@pytest.mark.parametrize("clip", [False, True])
def test_wkv6_fn_gradcheck(clip):
    """``Wkv6Fn`` in float64 (B 1, H 2, S 20 in chunks of 8 with a short
    last chunk, D 4, from a state), every operand differentiated, both
    outputs, against central differences (``fast_mode``); with ``clip``
    the exponents pass ±80 and the clipped ones pass no gradient."""
    gen = torch.Generator().manual_seed(2)
    ins = _wkv_inputs(gen, clip=clip)
    if clip:
        cum = torch.cumsum(ins[3].detach()[:, :, :8], 2)
        assert float(cum.min()) < -W.CLIP
    fn = lambda r, k, v, lw, u, s0: W.wkv6_train(r, k, v, lw, u, s0=s0,
                                                 chunk=8)
    assert torch.autograd.gradcheck(fn, ins, fast_mode=True)


def test_wkv6_fn_clip_gradient_matches_reference():
    """Where the clip engages, the gradients of ``logw`` and ``u`` are the
    reference's ``jax.grad`` of its ``wkv6_chunked``, which computes in
    float32 whatever its inputs: float32 on both sides, to 4e-5 of the
    largest entry (measured 8e-6; the exponents' factors reach e^±80, so
    the gradient's entries span many orders)."""
    from repro.models import rwkv6 as ref_rwkv
    gen = torch.Generator().manual_seed(3)
    r, k, v, logw, u, s0 = (t.detach().float()
                            for t in _wkv_inputs(gen, clip=True))

    def ref_loss(lw, u_):
        out, s = ref_rwkv.wkv6_chunked(
            *(jnp.asarray(t.numpy()) for t in (r, k, v)), lw, u_,
            jnp.asarray(s0.numpy()), 8)
        return jnp.sum(out * jnp.cos(out)) + jnp.sum(s)

    want = [np.asarray(g) for g in jax.grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(logw.numpy()), jnp.asarray(u.numpy()))]
    lw, uu = logw.clone().requires_grad_(True), u.clone().requires_grad_(True)
    out, s = W.wkv6_train(r, k, v, lw, uu, s0=s0, chunk=8)
    (torch.sum(out * torch.cos(out)) + torch.sum(s)).backward()
    for got, ref in zip((lw.grad, uu.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=4e-5 * np.abs(ref).max())


def test_wkv6_fn_bitwise_plain():
    """The Function's gradients are bitwise autograd through
    ``wkv6_fused_plain`` (bfloat16 r, k, v; float32 logw, u, s0)."""
    gen = torch.Generator().manual_seed(4)
    ins = [t.detach().float() for t in _wkv_inputs(gen, b=2, s=40, d=8)]
    ins[:3] = [t.to(torch.bfloat16) for t in ins[:3]]
    go = torch.randn(2, 2, 40, 8, generator=gen)
    gs = torch.randn(2, 2, 8, 8, generator=gen)
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    out, s = W.wkv6_train(*a[:5], s0=a[5], chunk=16)
    torch.autograd.backward((out, s), (go, gs))
    out_p, s_p = W.wkv6_fused_plain(*b[:5], s0=b[5], chunk=16)
    torch.autograd.backward((out_p, s_p), (go, gs))
    assert torch.equal(out, out_p) and torch.equal(s, s_p)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


def test_kernel_guards_kept():
    """A direct kernel call with an operand that requires a gradient still
    raises; the Functions are the one route for gradients."""
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    k = torch.randn(1, 2, 8, 8)
    with pytest.raises(ValueError, match="FlashAttentionFn"):
        A.flash_attention(q, k, k)
    r = torch.randn(1, 2, 8, 4, requires_grad=True)
    with pytest.raises(ValueError, match="Wkv6Fn"):
        W.wkv6_fused(r, r.detach(), r.detach(), -torch.ones(1, 2, 8, 4),
                     torch.zeros(2, 4))


def test_serving_takes_no_gradient():
    """``apply`` and ``prefill`` run under ``torch.no_grad``: params that
    require a gradient give logits that do not."""
    cfg = reduced_config(get_config("phi3-medium-14b"))
    params = api.init_params(cfg, 0, "cpu")
    for t in tree.leaves(params):
        t.requires_grad_(True)
    toks = np.zeros((1, 8), np.int32)
    assert not api.apply(cfg, params, {"tokens": toks}).requires_grad
    logits, _ = api.prefill(cfg, params, {"tokens": toks}, max_len=16)
    assert not logits.requires_grad


def test_remat_policy_dots_raises():
    cfg = dataclasses.replace(reduced_config(get_config("phi3-medium-14b")),
                              remat=True, remat_policy="dots")
    params = api.init_params(cfg, 0, "cpu")
    for t in tree.leaves(params):
        t.requires_grad_(True)
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(NotImplementedError, match="item 18"):
        api.loss_fn(cfg, params, {"tokens": toks, "labels": toks})

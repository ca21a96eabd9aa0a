"""The port's WKV6 (plain version, chunked form, token step) against the
reference, on the CPU.

The same NumPy inputs go through the reference (its Pallas kernel in
interpret mode, ``wkv6_chunked``, ``wkv6_step``) and the port.  Both sides
compute in float32 and differ by summation order only (the reference's
jit against PyTorch's eager ops), so outputs and states are held to 1e-5
of their largest entry (measured: under 1e-6 of it); the port's own
chunk-boundary split repeats its unsplit run to 1e-6.  The kernel's
tolerance (``wkv6_expect``) is checked here too: the plain float32 version
lies inside it and the planted faults the card's checks use lie outside.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6_fused as ref_fused
from repro.models import rwkv6 as ref_rwkv
from repro_torch.kernels import wkv6 as W
from repro_torch.models import rwkv6 as R


def _inputs(b, h, s, dk, seed, *, decay="model"):
    """r, k, v ~ N(0, 1); log w like the served model's decays
    (-exp(-0.6 + 0.42 z)) or, for ``"mild"``, the reference test's
    (-(|z|/2 + 0.02)); u ~ N(0, 1); s0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, dk)).astype(np.float32)
               for _ in range(3))
    z = rng.standard_normal((b, h, s, dk))
    logw = (-np.exp(-0.6 + 0.42 * z) if decay == "model"
            else -(np.abs(z) * 0.5 + 0.02)).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    s0 = rng.standard_normal((b, h, dk, dk)).astype(np.float32)
    return r, k, v, logw, u, s0


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(1, 2, 128, 8), (2, 3, 256, 16)])
@pytest.mark.parametrize("chunk", [32, 64])
def test_plain_matches_the_reference_pallas_kernel(shape, chunk):
    # the shapes and decays of tests/test_kernels_wkv.py
    r, k, v, logw, u, _ = _inputs(*shape, shape[0] * shape[2] + chunk,
                                  decay="mild")
    out_r, s_r = ref_fused(*(jnp.asarray(x) for x in (r, k, v, logw, u)),
                           chunk=chunk, interpret=True)
    out, s = W.wkv6_fused(*_t(r, k, v, logw, u), chunk=chunk)
    assert out.dtype == s.dtype == torch.float32
    _close(out, out_r)
    _close(s, s_r)


@pytest.mark.parametrize("s,chunk", [(100, 32), (200, 64), (40, 128)])
def test_plain_matches_wkv6_chunked_from_a_state_on_a_ragged_sequence(
        s, chunk):
    r, k, v, logw, u, s0 = _inputs(2, 3, s, 16, s + chunk)
    out_r, s_r = ref_rwkv.wkv6_chunked(
        *(jnp.asarray(x) for x in (r, k, v, logw, u, s0)), chunk=chunk)
    out, st = R.wkv6_chunked(*_t(r, k, v, logw, u, s0), chunk)
    assert out.shape == (2, 3, s, 16)
    _close(out, out_r)
    _close(st, s_r)


def test_plain_takes_bfloat16_inputs_as_the_reference_does():
    r, k, v, logw, u, s0 = _inputs(1, 2, 96, 32, 7)
    rb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (r, k, v))
    out, st = W.wkv6_fused(rb, kb, vb, *_t(logw, u), s0=_t(s0)[0], chunk=32)
    as_f32 = [x.float().numpy() for x in (rb, kb, vb)]
    out_r, s_r = ref_rwkv.wkv6_chunked(
        *(jnp.asarray(x) for x in (*as_f32, logw, u, s0)), chunk=32)
    assert out.dtype == torch.float32
    _close(out, out_r)
    _close(st, s_r)


def test_split_sequence_continues_the_unsplit_run():
    r, k, v, logw, u, s0 = _inputs(2, 2, 160, 16, 3)
    xs = _t(r, k, v, logw)
    out, st = W.wkv6_fused(*xs, _t(u)[0], s0=_t(s0)[0], chunk=32)
    # at a chunk boundary the two runs take the same chunks
    o1, s1 = W.wkv6_fused(*(x[:, :, :64] for x in xs), _t(u)[0],
                          s0=_t(s0)[0], chunk=32)
    o2, s2 = W.wkv6_fused(*(x[:, :, 64:] for x in xs), _t(u)[0], s0=s1,
                          chunk=32)
    _close(torch.cat([o1, o2], 2), out, 1e-6)
    _close(s2, st, 1e-6)


def test_step_matches_the_reference():
    r, k, v, logw, u, s0 = _inputs(2, 3, 1, 16, 5)
    args = [x[:, :, 0] for x in (r, k, v, logw)] + [u, s0]
    want = ref_rwkv.wkv6_step(*(jnp.asarray(x) for x in args))
    got = R.wkv6_step(*_t(*args))
    for g, w in zip(got, want):
        _close(g, w)


def test_chunked_equals_the_token_recurrence_where_the_clip_is_idle():
    # chunk 16 at these decays: |cum| <= 16·max|log w| stays far above -80
    r, k, v, logw, u, s0 = _inputs(1, 2, 70, 16, 11)
    assert float(np.abs(logw).max()) * 16 < 80
    tr, tk, tv, tl, tu, ts = _t(r, k, v, logw, u, s0)
    out, st = R.wkv6_chunked(tr, tk, tv, tl, tu, ts, 16)
    rows, state = [], ts
    for t in range(70):
        o, state = R.wkv6_step(tr[:, :, t], tk[:, :, t], tv[:, :, t],
                               tl[:, :, t], tu, state)
        rows.append(o)
    _close(torch.stack(rows, 2), out.numpy())
    _close(state, st.numpy())


def test_the_kernel_bound_holds_the_plain_version_and_catches_faults():
    # what the card's checks rely on: float32 arithmetic inside the bound
    # of the float64 run; a state dropped at a chunk boundary, the diagonal
    # in the score mask and an unwritten last chunk outside it
    r, k, v, logw, u, s0 = _t(*_inputs(2, 2, 200, 32, 13))
    c = 64
    want, tol, s_want, s_tol = W.wkv6_expect(r, k, v, logw, u, s0=s0,
                                             chunk=c)
    assert want.dtype == tol.dtype == torch.float64
    got, st = W.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=c)

    def ratio(x, w=want, t=tol):
        return float(((x.double() - w).abs() / t).max())

    assert ratio(got) <= 1.0 and ratio(st, s_want, s_tol) <= 1.0
    faults = W.wkv6_faults(r, k, v, logw, u, got, s0=s0, chunk=c,
                           split_at=128)
    assert set(faults) == {"state_dropped", "diagonal_in_mask",
                           "tail_skipped"}
    for name, bad in faults.items():
        assert ratio(bad) > 1.0, name
    # the dropped state changes only what follows the split; the tail
    # fault zeroes the short last chunk, rows 192..199
    assert torch.equal(faults["state_dropped"][:, :, :128], got[:, :, :128])
    assert torch.equal(faults["tail_skipped"][:, :, :192], got[:, :, :192])
    assert not faults["tail_skipped"][:, :, 192:].any()


def test_wrapper_checks_its_operands():
    r, k, v, logw, u, s0 = _t(*_inputs(1, 2, 32, 8, 17))
    with pytest.raises(ValueError, match="shapes"):
        W.wkv6_fused(r, k[:, :, 1:], v, logw, u)
    with pytest.raises(ValueError, match=r"u must be a \(2, 8\)"):
        W.wkv6_fused(r, k, v, logw, u[:1])
    with pytest.raises(ValueError, match="s0 must be"):
        W.wkv6_fused(r, k, v, logw, u, s0=s0[:, :1])
    with pytest.raises(ValueError, match="no backward"):
        W.wkv6_fused(r.requires_grad_(), k, v, logw, u)
    with pytest.raises(ValueError, match="chunk 0"):
        W.wkv6_fused(r.detach(), k, v, logw, u, chunk=0)
    out, st = W.wkv6_fused(r[:, :, :0].detach(), k[:, :, :0], v[:, :, :0],
                           logw[:, :, :0], u, s0=s0)
    assert out.shape == (1, 2, 0, 8) and torch.equal(st, s0)


@pytest.mark.parametrize("b,h,s,d,chunk,sms,want", [
    # the serving shape: 2048 tiles on a 132-SM card, two state slots a head
    (4, 64, 1024, 64, 128, 132, dict(chunk=128, chunks=8, last_rows=128,
                                     tiles=2048, grid=132,
                                     workspace_bytes=4 * 2 * 256 * 64 * 64,
                                     flag_words=257)),
    # one 32k sequence: 256 chunks a head
    (1, 64, 32768, 64, 128, 132, dict(chunks=256, tiles=16384, grid=132,
                                      workspace_bytes=4 * 2 * 64 * 64 * 64)),
    # a ragged last chunk; fewer tiles than SMs; chunk longer than S
    (4, 64, 1000, 64, 128, 132, dict(chunks=8, last_rows=104, tiles=2048)),
    (1, 2, 300, 32, 64, 132, dict(chunks=5, last_rows=44, tiles=10, grid=10,
                                  workspace_bytes=4 * 2 * 2 * 32 * 32)),
    (2, 3, 50, 64, 128, 132, dict(chunk=50, chunks=1, last_rows=50, tiles=6)),
    # chunk 1, and S = 0 (one block copies the start state)
    (1, 2, 9, 32, 1, 4, dict(chunk=1, chunks=9, last_rows=1, tiles=18,
                             grid=4)),
    (1, 2, 0, 64, 128, 132, dict(chunks=0, tiles=0, grid=1, flag_words=3))])
def test_plan_cuts_the_work_into_head_chunk_tiles(b, h, s, d, chunk, sms,
                                                   want):
    # the kernel's tiles, grid and workspace from the shape alone (the
    # card's SMs and blocks an SM given)
    pl = W.plan(b, h, s, d, chunk, torch.bfloat16, sms=sms, blocks_per_sm=1)
    assert {key: pl[key] for key in want} == want
    assert pl["blocks_per_sm"] == 1

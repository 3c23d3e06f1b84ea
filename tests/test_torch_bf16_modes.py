"""The bf16 modes of PixelSNAIL's flash pairs, of the fused vector
quantization and of the fused attention block, against the JAX package's
kernels and modules at bf16, on the CPU.

The plain versions (what the kernels' bf16 modes compute, and what serves
bf16 CPU tensors) of ``ops/attention_cuda.py`` at (d_k, d_v) = (4, 32) and
(4, 8), of ``ops/vq_cuda.py`` on bf16 rows beside an f32 codebook and of
``ops/attn_block_cuda.py``, and the port's ``VectorQuantizer`` on bf16 rows,
are held to ``attention_pallas``, ``vq_pallas``, ``attn_block_pallas`` and
the JAX ``VectorQuantizer``; the Pallas kernels run in interpret mode, as
the JAX package's own tests run them. Inputs come from numpy seeds and are
rounded to bf16 on both sides alike (nearest even); tensors cross between
the frameworks as float32 numpy arrays, which hold bf16 values exactly.

Tolerances are those of tests/test_torch_bf16.py for the same quantities,
in units of the reference's largest magnitude (max(1, max |want|)): a bf16
output within one bf16 step (2^-8) of it, an f32 statistic within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_generative_tpu import core as jcore
from pytorch_generative_tpu import nn as jnn
from pytorch_generative_tpu.ops import attention_pallas, attn_block_pallas, vq_pallas
from pytorch_generative_tpu.ops import vq as jvq
from pytorch_generative_tpu_torch import convert, core
from pytorch_generative_tpu_torch import nn as tnn
from pytorch_generative_tpu_torch.ops import attention_cuda, attn_block_cuda, vq_cuda
from pytorch_generative_tpu_torch.ops.vq import nearest_codebook

BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative
FLASH_TOL = BF16_STEP  # bf16 outputs (test_torch_bf16.py's FLASH_TOL)
LSE_TOL = 1e-6         # f32 statistics (test_torch_bf16.py's LSE_TOL)
# Scores 2 x.e - |e|^2 summed in f32 in another order on each side: rows
# whose top two scores are closer than this may pick either code; they are
# counted, and only they may differ (tests/test_torch_vq_vae.py's NEAR_TIE).
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX kernels in interpret mode (no TPU here)."""
    for mod in (attention_pallas, attn_block_pallas):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    orig = vq_pallas.vq_quantize_fused
    monkeypatch.setattr(vq_pallas, "vq_quantize_fused",
                        lambda flat_x, codebook, **kw: orig(flat_x, codebook, **kw,
                                                            interpret=True))


def _bf16(a):
    """A float32 numpy array rounded to bf16, as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _np(x):
    """A jax array or torch tensor of any float type as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _assert_scaled(got, want, name, tol):
    """max |got - want| <= tol x max(1, max |want|), infinities equal."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    same_inf = np.isinf(want) & (got == want)
    scale = max(float(np.abs(np.where(np.isinf(want), 0, want)).max()), 1.0)
    with np.errstate(invalid="ignore"):  # -inf - -inf, replaced by 0
        err = float(np.abs(np.where(same_inf, 0, got - want)).max())
    assert err <= tol * scale, f"{name}: max abs error {err:.3e} > {tol:.1e} x {scale:.3f}"


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


# (1) PixelSNAIL's flash pairs --------------------------------------------------

@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("d_k,d_v", [(4, 32), (4, 8)])
def test_flash_bf16_plain_matches_jax_kernel_at_pixel_snail_pairs(d_k, d_v, mask_center):
    """The bf16 plain forward (out bf16, lse f32) and backward (dq, dk, dv
    bf16, from the JAX kernel's own out and lse) at PixelSNAIL's pairs,
    one head, k and v column views of one kv tensor as the layer passes
    them, against attention_pallas's forward and backward on bf16
    operands in interpret mode: B 2, L 200 (the JAX kernel walks two key
    blocks). out, dq, dk, dv within 1 bf16 step x scale, lse within
    1e-6 x scale; under mask_center row 0 gets out 0, lse -inf and dq 0."""
    b, l = 2, 200
    rng = np.random.default_rng(10 * d_v + mask_center)
    q = _bf16(rng.standard_normal((b, l, d_k)))
    kv = _bf16(rng.standard_normal((b, l, d_k + d_v)))
    dout = _bf16(rng.standard_normal((b, l, d_v)))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16)
                       for a in (q, kv[..., :d_k], kv[..., d_k:], dout))
    blocks = (attention_pallas.DEFAULT_BLOCK_Q, attention_pallas.DEFAULT_BLOCK_K)
    jout, jlse = attention_pallas._flash_forward(jq, jk, jv, 1, mask_center, *blocks, True)
    jgrads = attention_pallas._flash_backward(jq, jk, jv, jout, jlse, jdo, 1, mask_center,
                                              *blocks, True)
    jlse = jlse[:, :, :l, 0]
    assert jout.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in jgrads)

    tq, tkv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, kv, dout))
    tk, tv = tkv[..., :d_k], tkv[..., d_k:]  # views: row stride d_k + d_v
    out, lse = attention_cuda.flash_forward(tq, tk, tv, mask_center, 1)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_scaled(out, jout, "out", FLASH_TOL)
    _assert_scaled(lse, jlse, "lse", LSE_TOL)
    tout = torch.from_numpy(_np(jout)).bfloat16()
    grads = attention_cuda.flash_backward(tq, tk, tv, tout, torch.from_numpy(_np(jlse)), tdo,
                                          mask_center, 1)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.bfloat16
        _assert_scaled(got, want, name, FLASH_TOL)
    if mask_center:
        assert bool((out[:, 0] == 0).all()) and bool((grads[0][:, 0] == 0).all())
        assert bool(torch.isneginf(lse[:, :, 0]).all())


def test_flash_bf16_pixel_snail_pairs_autograd_keeps_bf16():
    """Through the attention Function on bf16 CPU tensors at (4, 32):
    out and every gradient come back bf16, shaped as their inputs, the
    wrappers' bf16 counters untouched (CPU tensors never launch)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 50, 4), generator=g).bfloat16().requires_grad_()
    kv = torch.randn((2, 50, 36), generator=g).bfloat16().requires_grad_()
    before = (attention_cuda.bf16_launches, attention_cuda.bf16_bwd_launches)
    out = attention_cuda.causal_attention_packed(q, kv[..., :4], kv[..., 4:], True, 1)
    out.float().square().sum().backward()
    assert out.dtype == torch.bfloat16 and out.shape == (2, 50, 32)
    assert q.grad.dtype == kv.grad.dtype == torch.bfloat16 and kv.grad.shape == kv.shape
    assert (attention_cuda.bf16_launches, attention_cuda.bf16_bwd_launches) == before


# (2) The fused vector quantization ---------------------------------------------

def _gaps(x, cb):
    """The top-two score gap of each row, in float64."""
    s = 2.0 * x.astype(np.float64) @ cb.T.astype(np.float64) - (cb.astype(np.float64) ** 2).sum(1)
    top = np.sort(s, axis=1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("m,k,d", [(300, 32, 16), (600, 512, 64)])
def test_vq_bf16_plain_matches_jax_kernel(interpret, m, k, d):
    """vq_quantize_plain on bf16 rows beside an f32 codebook against the
    JAX Pallas kernel (interpret mode) on the same: quantized rows bf16 on
    both sides and equal where the codes agree; codes equal on every row
    whose top-two score gap exceeds NEAR_TIE (only near-tie rows may
    differ); counts f32 and exact once the near-tie rows' moves are
    accounted for, summing to M; sums f32 within 1e-5 x their largest
    magnitude (tests/test_torch_vq_vae.py's gate for the f32 kernel)."""
    rng = np.random.default_rng(m + d)
    x = _bf16(rng.standard_normal((m, d)))
    cb = rng.standard_normal((k, d)).astype(np.float32)
    jq, jc, js = vq_pallas.vq_quantize_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cb))
    assert jq.dtype == jnp.bfloat16 and jc.dtype == js.dtype == jnp.float32
    tq, tc, ts = vq_cuda.vq_quantize_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(cb))
    assert tq.dtype == torch.bfloat16 and tc.dtype == ts.dtype == torch.float32
    jq, jc, js, tq, tc, ts = (_np(a) for a in (jq, jc, js, tq, tc, ts))
    jidx = np.asarray(jvq.nearest_codebook(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cb)))
    tidx = nearest_codebook(torch.from_numpy(x).bfloat16(), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(jq, _bf16(cb[jidx]))
    differ = jidx != tidx
    assert not (differ & (_gaps(x, cb) > NEAR_TIE)).any()
    np.testing.assert_array_equal(tq[~differ], jq[~differ])
    tc, ts = tc.copy(), ts.copy()
    for r in np.flatnonzero(differ):
        tc[tidx[r]] -= 1
        tc[jidx[r]] += 1
        ts[tidx[r]] -= x[r]
        ts[jidx[r]] += x[r]
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5 * np.abs(js).max())
    assert jc.sum() == tc.sum() == m


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("use_ema,fused", [(True, False), (True, True), (False, False)],
                         ids=["ema", "ema_fused", "no_ema"])
def test_vector_quantizer_bf16_matches_jax(interpret, use_ema, fused, training):
    """VectorQuantizer on bf16 (2, 4, 4, 8) rows, 16 codes, under each
    side's bf16 cast (port: core.cast_floating and functional_call; JAX:
    core.cast_floating, which keeps the EMA buffers f32 on both) against the
    JAX module (its fused route through the Pallas kernel in interpret
    mode): the straight-through output (bf16), the loss, the gradient of
    sum(out w) + loss w.r.t. the bf16 input (and the embedding's without
    EMA) within 1 bf16 step x scale; the updated EMA buffers (f32) within
    1e-6 x scale (training with EMA; untouched otherwise)."""
    jq = jnn.VectorQuantizer(jax.random.PRNGKey(0), 16, 8, use_ema=use_ema, use_fused=fused)
    tq = tnn.VectorQuantizer(16, 8, use_ema=use_ema, use_fused=fused)
    tq.load_state_dict(convert.from_jax_params(_flat(jq)))
    tq.train(training)
    x = _bf16(np.random.default_rng(1).standard_normal((2, 4, 4, 8)))
    w = np.random.default_rng(2).standard_normal((2, 4, 4, 8)).astype(np.float32)

    def jax_objective(params, rest, x):
        q, loss, new = jcore.combine(params, rest)(x, training=training)
        return (jnp.sum(q.astype(jnp.float32) * w) + loss.astype(jnp.float32)), (q, loss, new)

    params, rest = jcore.partition(jcore.cast_floating(jq, jnp.bfloat16))
    (jgp, jgx), (want_q, want_loss, new) = jax.grad(
        jax_objective, argnums=(0, 2), has_aux=True)(params, rest, jnp.asarray(x, jnp.bfloat16))
    assert want_q.dtype == jnp.bfloat16

    before = {k_: v.clone() for k_, v in tq.state_dict().items()}
    launches = (vq_cuda.launches, vq_cuda.bf16_launches)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    got_q, got_loss = torch.func.functional_call(tq, core.cast_floating(tq, torch.bfloat16), (xt,))
    assert got_q.dtype == got_loss.dtype == torch.bfloat16
    (torch.sum(got_q.float() * torch.from_numpy(w)) + got_loss.float()).backward()
    assert (vq_cuda.launches, vq_cuda.bf16_launches) == launches
    _assert_scaled(got_q, want_q, "quantized", BF16_STEP)
    _assert_scaled(got_loss, want_loss, "loss", BF16_STEP)
    _assert_scaled(xt.grad, jgx, "dx", BF16_STEP)
    if use_ema:
        want = convert.from_jax_params(_flat(new))
        for name in ("ema_embedding", "ema_cluster_size", "ema_embedding_avg"):
            got = getattr(tq, name)
            assert got.dtype == torch.float32, name
            _assert_scaled(got, want[name], name, LSE_TOL)
            if not training:
                assert torch.equal(got, before[name]), name
    else:
        _assert_scaled(tq.embedding.grad, jgp.embedding, "dembedding", BF16_STEP)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_vector_quantizer_bf16_counts_above_256_exactly(interpret, fused):
    """601 bf16 rows on one code, decay 0 (so the EMA cluster size is the
    batch's count): the count reads 601.0 on both sides and routes, where a
    bf16 one-hot's sum would round it to 600."""
    jq = jnn.VectorQuantizer(jax.random.PRNGKey(3), 16, 8, ema_decay=0.0, use_fused=fused)
    tq = tnn.VectorQuantizer(16, 8, ema_decay=0.0, use_fused=fused)
    tq.load_state_dict(convert.from_jax_params(_flat(jq)))
    cb = np.asarray(jq.ema_embedding)
    x = np.broadcast_to(_bf16(cb[5] + 1e-3), (1, 601, 1, 8)).copy()
    assert float(torch.ones(601, dtype=torch.bfloat16).sum(dtype=torch.bfloat16)) == 600.0
    params, rest = jcore.partition(jcore.cast_floating(jq, jnp.bfloat16))
    _, _, new = jcore.combine(params, rest)(jnp.asarray(x, jnp.bfloat16), training=True)
    torch.func.functional_call(tq, core.cast_floating(tq, torch.bfloat16),
                               (torch.from_numpy(x).bfloat16(),))
    assert float(new.ema_cluster_size[5]) == float(tq.ema_cluster_size[5]) == 601.0
    assert float(tq.ema_cluster_size.sum()) == 601.0


# (3) The fused attention block --------------------------------------------------

def _block_args(l, seed, c=64):
    rng = np.random.default_rng(seed)
    mk = lambda *s: _bf16(rng.standard_normal(s) * 0.2)
    return [mk(1, l, c), mk(c, c), mk(c), mk(c, 2 * c), mk(2 * c), mk(c, c), mk(c)]


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 50])
def test_block_bf16_plain_matches_jax_kernel(interpret, monkeypatch, l, mask_center):
    """The block's bf16 plain forward (y, attn bf16; lse f32) against
    attn_block_pallas._fwd_block on bf16 operands in interpret mode (B 1,
    C 64, 2 heads of 32; L = 50 ends on a ragged tile): y and attn within
    1 bf16 step x scale, lse within 1e-6 x scale. Then the gradients of
    sum(y g) through _AttentionBlockPacked against jax.vjp of
    attention_block_packed: each within 1 bf16 step x scale.

    Where the port departs from the reference: the JAX backward recomputes
    q, k and v as bf16(x W) + b, a bf16 add after rounding
    (attn_block_pallas.py:235-239), where its forward rounds x W + b once,
    from the f32 sum (:66-78). The port differentiates through its
    forward's own q, k and v (``project``). So the JAX backward here has
    its flash call fed the q, k and v of its own forward's rounding (the
    rest of its backward, the weight products and dx, is the JAX
    package's, unchanged); with its own recompute the two sides differ by
    up to 1.7 bf16 steps on these inputs, and the gate stays the bf16
    one."""
    args = _block_args(l, seed=l + mask_center)
    g = _bf16(np.random.default_rng(l + 1).standard_normal((1, l, 64)))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jy, jattn, jlse = attn_block_pallas._fwd_block(*jargs, 2, mask_center, True)
    jlse = jlse[:, :, :l, 0]
    x, wq, bq, wkv, bkv = jargs[:5]
    project = lambda w, b: (jax.lax.dot_general(x, w, (((2,), (0,)), ((), ())),
                                                preferred_element_type=jnp.float32)
                            + b.astype(jnp.float32)).astype(jnp.bfloat16)
    fq, fkv = project(wq, bq), project(wkv, bkv)
    flash_backward = attn_block_pallas._flash_backward
    monkeypatch.setattr(attn_block_pallas, "_flash_backward",
                        lambda q, k, v, *rest: flash_backward(fq, fkv[..., :64], fkv[..., 64:],
                                                              *rest))
    want, pullback = jax.vjp(
        lambda *a: attn_block_pallas.attention_block_packed(*a, mask_center, 2), *jargs)
    want_grads = pullback(jnp.asarray(g, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16

    targs = [torch.from_numpy(a).bfloat16() for a in args]
    y, attn, lse = attn_block_cuda.attention_block_plain(*targs, mask_center, 2)
    assert y.dtype == attn.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_scaled(y, jy, "y", FLASH_TOL)
    _assert_scaled(attn, jattn, "attn", FLASH_TOL)
    _assert_scaled(lse, jlse, "lse", LSE_TOL)

    leaves = [t.clone().requires_grad_() for t in targs]
    before = (attn_block_cuda.bf16_launches, attn_block_cuda.bf16_project_launches,
              attention_cuda.bf16_bwd_launches)
    got = attn_block_cuda.attention_block_packed(*leaves, mask_center, 2)
    assert got.dtype == torch.bfloat16
    _assert_scaled(got, want, "y (Function)", FLASH_TOL)
    got.backward(torch.from_numpy(g).bfloat16())
    assert (attn_block_cuda.bf16_launches, attn_block_cuda.bf16_project_launches,
            attention_cuda.bf16_bwd_launches) == before  # CPU tensors never launch
    for name, t, w in zip(("dx", "dwq", "dbq", "dwkv", "dbkv", "dwo", "dbo"), leaves,
                          want_grads):
        assert t.grad.dtype == torch.bfloat16, name
        _assert_scaled(t.grad, w, name, FLASH_TOL)
    if mask_center:
        assert bool((attn[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all())


def test_block_bf16_projection_is_the_forwards():
    """The backward's recompute (``project``) gives the forward's own q, k
    and v, bit for bit: bf16(x W + b) from the f32 sum, which the plain
    forward's attention reproduces from them exactly."""
    args = [torch.from_numpy(a).bfloat16() for a in _block_args(50, seed=3)]
    x, wq, bq, wkv, bkv, wo, bo = args
    q, kv = attn_block_cuda.project(x, wq, bq, wkv, bkv)
    assert q.dtype == kv.dtype == torch.bfloat16
    torch.testing.assert_close(q, (x.float() @ wq.float() + bq.float()).bfloat16(), rtol=0, atol=0)
    _, attn, lse = attn_block_cuda.attention_block_plain(*args, True, 2)
    again, lse2 = attention_cuda._flash_forward_bf16_plain(q, kv[..., :64], kv[..., 64:], True, 2,
                                                           q2=False)
    assert torch.equal(attn, again) and torch.equal(lse, lse2)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it is marked ``cuda`` and skips without
one (decided in a fixture, never at import). This file imports no JAX; on the
card run it as

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import hashlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_generative_tpu_torch import optim, trainer  # noqa: E402
from pytorch_generative_tpu_torch.models import (  # noqa: E402
    ImageGPT,
    PixelSNAIL,
    VectorQuantizedVAE,
)
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt  # noqa: E402
from pytorch_generative_tpu_torch.ops import (  # noqa: E402
    attention_cuda,
    attn_block_cuda,
    decode_cuda,
    ln_cuda,
    mlp_cuda,
    sampling,
    snail_decode_cuda,
    vq_cuda,
)
from pytorch_generative_tpu_torch.ops.attention import causal_attention_with_lse  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _rand(shape, seed, dev):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


# Every (d_k, d_v) instance of the flash kernels: ImageGPT's d_k == d_v and
# PixelSNAIL's d_k != d_v.
PAIRS = [pytest.param(dk, dv, id=f"{dk}-{dv}") for dk, dv in attention_cuda.HEAD_DIM_PAIRS]
# Lengths on every edge of the kernels' tiles (64-row query tiles, 32- and
# 64-key or -row tiles): one row (fully masked under mask_center), part of
# a tile, one past a tile, whole tiles, ragged, ImageGPT's 784.
FLASH_LENGTHS = [1, 17, 33, 64, 65, 200, 784]


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", FLASH_LENGTHS)
@pytest.mark.parametrize("d_k,d_v", PAIRS)
def test_flash_kernel_matches_plain(dev, mask_center, l, d_k, d_v):
    """out and lse within 5e-5 of the dense version (f32, another summation
    order); k/v as feature slices of one packed kv tensor."""
    n_heads = 2
    ck = n_heads * d_k
    q = _rand((3, l, ck), l + d_k + d_v, dev)
    kv = _rand((3, l, ck + n_heads * d_v), l + d_k + d_v + 1, dev)
    k, v = kv[..., :ck], kv[..., ck:]
    before = attention_cuda.launches
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    torch.cuda.synchronize()
    assert attention_cuda.launches == before + 1
    ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, n_heads)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=5e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=5e-5)
    if mask_center:
        assert bool((out[:, 0] == 0).all())
        assert bool(torch.isneginf(lse[:, :, 0]).all())


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = _rand((2, 64, 64), 0, dev)
    with pytest.raises(TypeError):
        attention_cuda.flash_forward(q.double(), q.double(), q.double(), False, 2)
    with pytest.raises(ValueError, match="not one of"):
        attention_cuda.flash_forward(q, q, q, False, 8)  # (8, 8) has no instance
    with pytest.raises(ValueError, match="k width"):
        attention_cuda.flash_forward(q, q[..., :32], q, False, 2)
    with pytest.raises(ValueError, match="not one of"):
        attention_cuda.flash_forward(q, q, q[..., :16], False, 2)  # (32, 8)
    with pytest.raises(ValueError):
        attention_cuda.flash_forward(q, q.cpu(), q, False, 2)
    with pytest.raises(ValueError):
        attention_cuda.flash_forward(q, q.transpose(0, 1).contiguous().transpose(0, 1),
                                     q, False, 2)
    wide = _rand((2, 64, 65), 1, dev)
    with pytest.raises(ValueError, match="16-byte"):  # starts 4 bytes past an aligned one
        attention_cuda.flash_forward(q, wide[..., 1:], q, False, 2)


def _flash_operands(b, l, n_heads, d_k, d_v, seed, dev):
    """q, k, v (k and v feature slices of one kv tensor) and dO, as
    tools/torch_flash_times.py makes them."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, l, n_heads * d_k), generator=g).to(dev)
    kv = torch.randn((b, l, n_heads * (d_k + d_v)), generator=g).to(dev)
    dout = torch.randn((b, l, n_heads * d_v), generator=g).to(dev)
    return q, kv[..., :n_heads * d_k], kv[..., n_heads * d_k:], dout


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tensor_core_flash_kernels_give_equal_bits_twice(dev, mask_center, d):
    """The d_k == d_v kernels sum every output element in one thread in a
    fixed order (no atomics): two calls give out, lse, dq, dk and dv bit for
    bit."""
    q, k, v, dout = _flash_operands(3, 200, 2, d, d, d, dev)
    first, second = [], []
    for outs in (first, second):
        out, lse = attention_cuda.flash_forward(q, k, v, mask_center, 2)
        outs += [out, lse, *attention_cuda.flash_backward(q, k, v, out, lse, dout,
                                                          mask_center, 2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# SHA-256 of out and lse of the f32 (4, 32) and (4, 8) forward at
# tools/torch_flash_times.py --dump's inputs (B 4, L 200, H 2), as the SIMT
# pass gave them on an H100 before the f32 backward of those pairs moved to
# the tensor cores and the bf16 forward left the pass: the f32 forward is
# unchanged, bit for bit. (Until then the digests hashed dq, dk and dv too;
# the backward's bits changed by design, and
# test_flash_small_pair_backward_matches_plain holds it to its plain version
# and to equal bits.)
SIMT_DIGESTS = {
    (4, 32, False): "6c93b77735d46aa3ddc99eb77cf6258bdfd700c766ed7a65132f6183ca4bc624",
    (4, 32, True): "bdbc279b3a382feb9a025c4c48d41233fc5d6de50de2da71900dd58b3fe9b34c",
    (4, 8, False): "3f597f2da9af6edc9be2fa86cde35ba674b73f53f6d406dd313c483832ef9549",
    (4, 8, True): "28c4382d0dd8b7b83bf7b39379ed89b1e6e47e8d5b882bceea43076e9632acd8",
}


@pytest.mark.parametrize("d_k,d_v,mask_center", list(SIMT_DIGESTS))
def test_simt_flash_instances_keep_their_bits(dev, d_k, d_v, mask_center):
    q, k, v, _ = _flash_operands(4, 200, 2, d_k, d_v, d_k * 1000 + d_v, dev)
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, 2)
    digest = hashlib.sha256(b"".join(t.cpu().contiguous().numpy().tobytes()
                                     for t in (out, lse))).hexdigest()
    assert digest == SIMT_DIGESTS[(d_k, d_v, mask_center)]


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [784, 200, 1])
@pytest.mark.parametrize("d_k,d_v", [(4, 32), (4, 8)])
def test_flash_small_pair_backward_matches_plain(dev, d_k, d_v, l, mask_center):
    """PixelSNAIL's f32 backward (3xTF32 mma.sync) at B 128 (L 784; and
    ragged L), one head, k and v column views of one (B, L, d_k + d_v) kv
    tensor (v 16 bytes into each row): dq, dk, dv within BWD_TOL of the
    plain backward (chip_smoke.py's gate); two calls give the same bits;
    under mask_center row 0 gets dq 0."""
    b = 128 if l == 784 else 3
    q, k, v, dout = _flash_operands(b, l, 1, d_k, d_v, l + d_v, dev)
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, 1)
    before = attention_cuda.bwd_launches
    got = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, 1)
    again = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, 1)
    torch.cuda.synchronize()
    assert attention_cuda.bwd_launches == before + 2
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    want = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center, 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=BWD_TOL)
    if mask_center:
        assert bool((got[0][:, 0] == 0).all())


@pytest.mark.parametrize("d_k,d_v", [(4, 32), (4, 8)])
def test_flash_small_pair_backward_takes_any_view(dev, d_k, d_v):
    """The f32 (4, 32) / (4, 8) backward stages an operand whose start or
    strides are off 16 bytes 4 bytes a copy, any other 16 bytes a copy: on
    views 4 bytes off every boundary (q, k, v, out and dO column views at
    odd offsets) it gives the bits it gives on contiguous copies of them."""
    b, l = 3, 200
    q = _rand((b, l, d_k + 1), 5, dev)[..., 1:]
    kv = _rand((b, l, d_k + d_v + 1), 6, dev)
    k, v = kv[..., 1:1 + d_k], kv[..., 1 + d_k:]
    dout = _rand((b, l, d_v + 1), 7, dev)[..., 1:]
    dense = [t.contiguous() for t in (q, k, v)]
    out, lse = attention_cuda.flash_forward(*dense, True, 1)
    out_view = torch.cat([out[..., :1], out], -1)[..., 1:]
    got = attention_cuda.flash_backward(q, k, v, out_view, lse, dout, True, 1)
    want = attention_cuda.flash_backward(*dense, out, lse, dout.contiguous(), True, 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    ref = attention_cuda.flash_backward_plain(*dense, out, lse, dout, True, 1)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=BWD_TOL)


def _model(dev, blocks=2, size=8, seed=0):
    model = ImageGPT(in_channels=1, out_channels=1, in_size=size,
                     n_transformer_blocks=blocks, n_attention_heads=2,
                     n_embedding_channels=32,
                     generator=torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape,
                                          generator=torch.Generator().manual_seed(seed + 1)))
    return model.eval()


@pytest.mark.parametrize("inpaint", [False, True])
def test_sampler_kernel_matches_plain(dev, inpaint):
    """Pixel-equal to the plain KV-cache decoder, on uniforms moved 2e-3 off
    the decision boundary of the plain sample's teacher-forced logits."""
    model = _model(dev)
    n, h, w = 4, 8, 8
    cond = -torch.ones((n, h, w, 1), device=dev)
    if inpaint:
        cond[:, :4] = (_rand((n, 4, w, 1), 3, dev) > 0).float()
    u = torch.rand((h * w, n, 1), generator=torch.Generator().manual_seed(4)).to(dev)
    plain = decode_cuda.sample_loop_plain(*sampling.sample_loop_inputs(model, cond, u))
    with torch.no_grad():
        image = sampling.canvas_to_images(plain, h, w)
        p = torch.sigmoid(model(image)).reshape(n, -1).T[..., None]
    d = u - p
    near = d.abs() < 1e-3
    u = torch.where(near, (p + 2e-3 * torch.where(d >= 0, 1.0, -1.0)).clamp(0, 1), u)
    inputs = sampling.sample_loop_inputs(model, cond, u)
    plain = decode_cuda.sample_loop_plain(*inputs)
    before = decode_cuda.launches
    kern = decode_cuda.fused_sample_loop(*inputs)
    torch.cuda.synchronize()
    assert decode_cuda.launches == before + 1
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)


def _nudged_sampler_inputs(model, n, h, w, inpaint, dev, seed=3):
    """fused_sample_loop's inputs for n images, the uniforms moved 2e-3 off
    the plain sample's decision boundary (as in the test above)."""
    gen = torch.Generator().manual_seed(seed)
    cond = -torch.ones((n, h, w, 1), device=dev)
    if inpaint:
        cond[:, : h // 2] = (torch.rand((n, h // 2, w, 1), generator=gen) < 0.5).float().to(dev)
    u = torch.rand((h * w, n, 1), generator=gen).to(dev)
    plain = decode_cuda.sample_loop_plain(*sampling.sample_loop_inputs(model, cond, u))
    with torch.no_grad():
        p = torch.sigmoid(model(sampling.canvas_to_images(plain, h, w))).reshape(n, -1).T[..., None]
    d = u - p
    u = torch.where(d.abs() < 1e-3, (p + 2e-3 * torch.where(d >= 0, 1.0, -1.0)).clamp(0, 1), u)
    return sampling.sample_loop_inputs(model, cond, u)


def _wide_model(dev, blocks=3):
    """C = 128, 4 heads: at 3 blocks its weight slices do not stay in
    shared memory beside a sample's state, so the kernel streams them."""
    model = ImageGPT(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=blocks,
                     n_attention_heads=4, n_embedding_channels=128,
                     generator=torch.Generator().manual_seed(5), device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape,
                                          generator=torch.Generator().manual_seed(6)))
    return model.eval()


@pytest.mark.parametrize("n,inpaint", [(1, False), (5, True), (17, False)])
def test_sampler_kernel_at_any_n(dev, n, inpaint):
    """n = 1, an n the plan's groups do not divide (5 over the card's
    clusters, 17 as groups of 2), one launch a call, pixel-equal."""
    inputs = _nudged_sampler_inputs(_model(dev), n, 8, 8, inpaint, dev)
    plan = decode_cuda.plan_for(*inputs)
    assert plan.groups * plan.samples >= n and plan.clusters <= plan.groups
    before = decode_cuda.launches
    kern = decode_cuda.fused_sample_loop(*inputs)
    torch.cuda.synchronize()
    assert decode_cuda.launches == before + 1
    torch.testing.assert_close(kern, decode_cuda.sample_loop_plain(*inputs), rtol=0, atol=0)


@pytest.mark.parametrize("n,mlp1_chunks", [(3, 1), (256, 3)])
def test_sampler_kernel_streams_wide_weights(dev, n, mlp1_chunks):
    """The wide model streams its weight slices. At n = 3 a ring stage holds
    a whole slice; at n = 256 only a few of its rows, so the products take
    each slice in chunks, MLP 1 in 3 or more: from its third chunk on, the
    wait for a chunk no longer covers LayerNorm 2's prefetch group."""
    inputs = _nudged_sampler_inputs(_wide_model(dev), n, 8, 8, True, dev)
    plan = decode_cuda.plan_for(*inputs)
    _, dims = decode_cuda.check_sample_loop(*inputs)
    c, cols = dims[3], decode_cuda._slices(dims, plan.cluster)[2][1]  # MLP 1's widest slice
    assert not plan.resident
    assert -(-c // min(c, plan.stage // cols)) >= mlp1_chunks
    before = decode_cuda.launches
    kern = decode_cuda.fused_sample_loop(*inputs)
    torch.cuda.synchronize()
    assert decode_cuda.launches == before + 1
    torch.testing.assert_close(kern, decode_cuda.sample_loop_plain(*inputs), rtol=0, atol=0)


@pytest.mark.parametrize("wide", [False, True])
def test_sampler_kernel_gives_equal_bits_twice(dev, wide):
    model = _wide_model(dev) if wide else _model(dev)
    inputs = _nudged_sampler_inputs(model, 4, 8, 8, False, dev)
    first = decode_cuda.fused_sample_loop(*inputs)
    second = decode_cuda.fused_sample_loop(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _misaligned(t):
    """t's values in a contiguous tensor 4 bytes past a 16-byte boundary."""
    return torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("wrapper", ["ln_forward", "ln_backward", "mlp_forward", "mlp_backward",
                                     "attn_block", "sample_loop"])
def test_wrappers_refuse_operands_off_a_16_byte_boundary(dev, wrapper):
    """Fault C.4: each wrapper raises before any launch, and copies nothing."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(64, 128, dev)
    y = torch.zeros((64, 512), device=dev)
    calls = {
        "ln_forward": (ln_cuda, "launches",
                       lambda: ln_cuda.ln_forward(x, _misaligned(gamma), beta, 1e-5)),
        "ln_backward": (ln_cuda, "bwd_launches",
                        lambda: ln_cuda.ln_backward(_misaligned(x), x, gamma, 1e-5)),
        "mlp_forward": (mlp_cuda, "launches",
                        lambda: mlp_cuda.ln_mlp_forward(x, gamma, beta, _misaligned(w1), b1, w2,
                                                        b2, 1e-5)),
        "mlp_backward": (mlp_cuda, "bwd_launches",
                         lambda: mlp_cuda.ln_mlp_backward(x, x, y, gamma, beta, w1, b1,
                                                          _misaligned(w2), 1e-5)),
    }
    if wrapper == "attn_block":
        ops = list(_block_inputs(2, 64, 64, dev))
        ops[3] = _misaligned(ops[3])  # wkv
        calls[wrapper] = (attn_block_cuda, "launches",
                          lambda: attn_block_cuda.attention_block_forward(*ops, False, 2))
    if wrapper == "sample_loop":
        canvas0, pos_pad, u, weights, n_heads, h, w = sampling.sample_loop_inputs(
            _model(dev), -torch.ones((2, 8, 8, 1), device=dev), torch.rand((64, 2, 1), device=dev))
        weights = dict(weights, mlp2_w=_misaligned(weights["mlp2_w"]))
        calls[wrapper] = (decode_cuda, "launches", lambda: decode_cuda.fused_sample_loop(
            canvas0, pos_pad, u, weights, n_heads, h, w))
    module, counter, call = calls[wrapper]
    before = getattr(module, counter)
    with pytest.raises(ValueError, match="16-byte aligned start, got offset 4 bytes"):
        call()
    assert getattr(module, counter) == before


def test_model_on_cuda_runs_the_kernels(dev):
    """forward and sample on CUDA go through both kernels; the forward agrees
    with the plain CPU forward within 1e-4."""
    model = _model(dev, blocks=2, size=12)
    x = (_rand((2, 12, 12, 1), 5, dev) > 0).float()
    attention_cuda.launches = 0
    decode_cuda.launches = decode_cuda.step_launches = 0
    with torch.no_grad():
        logits = model(x)
        samples = model.sample(n_samples=3, generator=torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    # n = 3 takes the step route: one step launch per position, no whole loop.
    assert sampling.sample_route(model, 3) == sampling.STEP_ROUTE
    assert attention_cuda.launches == 2
    assert (decode_cuda.launches, decode_cuda.step_launches) == (0, 12 * 12)
    decode_cuda.launches = 0
    with torch.no_grad():
        model.sample(n_samples=8, generator=torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    assert decode_cuda.launches == 1  # n = 8: the whole-loop route
    assert samples.shape == (3, 12, 12, 1)
    assert bool(((samples == 0) | (samples == 1)).all())
    cpu = ImageGPT(in_channels=1, out_channels=1, in_size=12, n_transformer_blocks=2,
                   n_attention_heads=2, n_embedding_channels=32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        torch.testing.assert_close(logits.cpu(), cpu(x.cpu()), rtol=0, atol=1e-4)


def test_ineligible_model_takes_the_step_kernel_on_cuda(dev):
    """A model the whole loop does not cover (custom sample_fn) samples on
    the card through the step kernel, never the plain decoder, and gives
    the plain step route's pixels on uniforms off the decision boundary."""
    model = _model(dev)
    model.sample_fn = lambda u, logits: (u < torch.sigmoid(logits)).float()
    assert not sampling._whole_loop_eligible(model)
    n, h, w = 4, 8, 8
    cond = -torch.ones((n, h, w, 1), device=dev)
    u = torch.rand((h * w, n, 1), generator=torch.Generator().manual_seed(4)).to(dev)
    plain = sampling._image_gpt_decode_step(model, cond, u, torch.float32,
                                            step=decode_cuda.decode_step_plain)
    with torch.no_grad():
        p = torch.sigmoid(model(plain)).reshape(n, -1).T[..., None]
    d = u - p
    u = torch.where(d.abs() < 1e-3, (p + 2e-3 * torch.where(d >= 0, 1.0, -1.0)).clamp(0, 1), u)
    plain = sampling._image_gpt_decode_step(model, cond, u, torch.float32,
                                            step=decode_cuda.decode_step_plain)
    decode_cuda.launches = decode_cuda.step_launches = 0
    got = model.sample(uniforms=u, conditioned_on=cond)
    torch.cuda.synchronize()
    assert (decode_cuda.launches, decode_cuda.step_launches) == (0, h * w)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


# The step kernel against its plain version: f32 sums over C, 4C and up to
# L terms in another order, as a share of the largest |act|.
STEP_RTOL = 1e-4


def _step_case(dev, config, n, i, cache_dtype, seed=0):
    """Stacked weights of a seeded model, x (n, C) and a cache whose
    positions >= i hold NaN: reading one would poison the result."""
    model = ImageGPT(**config, generator=torch.Generator().manual_seed(seed), device=dev)
    weights = decode_cuda.stack_image_gpt_weights(model)
    attn = model.blocks[0].attn
    h, w, _ = model.in_shape
    x = _rand((n, attn.embed_channels), seed + 1, dev)
    cache = _rand((len(model.blocks), n, h * w, attn.embed_channels + attn.out_channels),
                  seed + 2, dev)
    cache[:, :, i:] = float("nan")
    return x, cache.to(cache_dtype), weights, attn.n_heads


def _assert_step_close(got, want):
    (act, kv), (ref_act, ref_kv) = got, want
    scale = float(ref_act.abs().max())
    assert bool(torch.isfinite(act).all()) and bool(torch.isfinite(kv.float()).all())
    assert float((act - ref_act).abs().max()) <= STEP_RTOL * scale
    # kv_new: the same tolerance plus, in bf16, one unit in the last place
    # where the two f32 sums round to neighbouring bf16 values.
    ulp = 0.0 if kv.dtype == torch.float32 else 2.0 ** -7
    diff = (kv.float() - ref_kv.float()).abs()
    assert bool((diff <= STEP_RTOL * scale + ulp * ref_kv.float().abs()).all())


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i", [0, 1, 37, 63])
def test_decode_step_kernel_matches_plain(dev, i, cache_dtype):
    """Tiny shape (3 blocks, C 32, 2 heads, 8x8), n = 4: act and kv_new
    within STEP_RTOL of the plain version; NaN in cache positions >= i.
    The kernel writes kv_new into its cache at i, and nowhere else."""
    config = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=3,
                  n_attention_heads=2, n_embedding_channels=32)
    x, cache, weights, n_heads = _step_case(dev, config, 4, i, cache_dtype)
    before = decode_cuda.step_launches
    written = cache.clone()
    got = decode_cuda.fused_decode_step(i, x, written, weights, n_heads)
    torch.cuda.synchronize()
    assert decode_cuda.step_launches == before + 1
    assert got[1].dtype == cache_dtype
    assert torch.equal(got[1], written[:, :, i])
    assert torch.equal(written[:, :, :i], cache[:, :, :i])
    assert bool(written[:, :, i + 1:].float().isnan().all())
    _assert_step_close(got, decode_cuda.decode_step_plain(i, x, cache, weights, n_heads))


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_decode_step_kernel_matches_plain_at_large_config(dev, cache_dtype):
    """LARGE_CONFIG (C 512, 8 heads of 64, 8 blocks), n = 16, at i = 0, 391
    and 783; two runs give bit-equal outputs (no atomics)."""
    for i in (0, 391, 783):
        x, cache, weights, n_heads = _step_case(dev, image_gpt.LARGE_CONFIG, 16, i,
                                                cache_dtype)
        # Each call on its own cache: the step writes its k|v there at i.
        got = decode_cuda.fused_decode_step(i, x, cache.clone(), weights, n_heads)
        again = decode_cuda.fused_decode_step(i, x, cache.clone(), weights, n_heads)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        _assert_step_close(got, decode_cuda.decode_step_plain(i, x, cache, weights, n_heads))


def test_decode_step_wrapper_rejects_what_the_kernel_does_not_take(dev):
    config = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=2,
                  n_attention_heads=2, n_embedding_channels=32)
    x, cache, weights, n_heads = _step_case(dev, config, 4, 5, torch.float32)
    step = decode_cuda.fused_decode_step
    with pytest.raises(TypeError):
        step(5, x, cache.half(), weights, n_heads)
    with pytest.raises(TypeError):
        step(5, x.double(), cache, weights, n_heads)
    with pytest.raises(ValueError):
        step(5, x, cache.cpu(), weights, n_heads)
    with pytest.raises(ValueError):
        step(5, x[:, :16].contiguous(), cache, weights, n_heads)
    with pytest.raises(ValueError):
        step(5, x, cache[:, :3].contiguous(), weights, n_heads)
    with pytest.raises(ValueError):
        step(5, x, cache.transpose(2, 3).contiguous().transpose(2, 3), weights, n_heads)
    with pytest.raises(ValueError):
        step(64, x, cache, weights, n_heads)
    with pytest.raises(ValueError):
        step(5, x, cache, dict(weights, qkv_w=weights["qkv_w"].cpu()), n_heads)


# The raster positions the step route's scan reaches at 28x28: the first
# two, the edges of the kernel's first key chunk (64 keys), the middle and
# the last.
SCAN_POSITIONS = (0, 1, 64, 65, 391, 783)
STEP_CONFIGS = [pytest.param(image_gpt.REPRODUCE_CONFIG, id="c64_h2"),
                pytest.param(image_gpt.LARGE_CONFIG, id="c512_h8")]


def _equal_with_nan(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _stale(cache, i):
    """A copy of a case's cache with NaN in its positions >= i."""
    cache = cache.clone()
    cache[:, :, i:] = float("nan")
    return cache


@pytest.mark.parametrize("n", [16, 20, 64])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", STEP_CONFIGS)
def test_decode_step_kernel_at_a_device_position(dev, config, cache_dtype, n):
    """At i = 0, 1, 64, 65, 391 and 783 and n = 16, 20 and 64 (one row
    group of the products, and several): the kernel reading i from a 0-dim
    int32 tensor gives the int i's act and cache bit for bit, and both are
    within STEP_RTOL of the plain version (NaN in the stale positions)."""
    x, full, weights, n_heads = _step_case(dev, config, n, 784, cache_dtype)
    for i in SCAN_POSITIONS:
        cache = _stale(full, i)
        c_int, c_dev = cache.clone(), cache.clone()
        got = decode_cuda.fused_decode_step(i, x, c_int, weights, n_heads)
        pos = torch.tensor(i, dtype=torch.int32, device=dev)
        act, kv = decode_cuda.fused_decode_step(pos, x, c_dev, weights, n_heads)
        torch.cuda.synchronize()
        assert torch.equal(act, got[0]) and torch.equal(kv, got[1])
        assert _equal_with_nan(c_int.float(), c_dev.float())
        _assert_step_close((act, kv), decode_cuda.decode_step_plain(i, x, cache, weights, n_heads))


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", STEP_CONFIGS)
def test_decode_step_kernel_on_rows_far_from_zero_mean(dev, config, cache_dtype):
    """x with a per-row offset of +-30 and +-300 (a trained residual
    stream's rows need not be centred): the LayerNorms folded into the
    products stay within STEP_RTOL of the plain version at i = 1 and 391,
    n = 16."""
    x, full, weights, n_heads = _step_case(dev, config, 16, 784, cache_dtype)
    offset = torch.tensor([30.0, 300.0, -30.0, -300.0], device=dev).repeat(4)[:, None]
    for i in (1, 391):
        cache = _stale(full, i)
        got = decode_cuda.fused_decode_step(i, x + offset, cache.clone(), weights, n_heads)
        torch.cuda.synchronize()
        _assert_step_close(got, decode_cuda.decode_step_plain(i, x + offset, cache, weights,
                                                              n_heads))


@pytest.mark.parametrize("n", [16, 20])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_decode_step_kernel_at_c_1280(dev, cache_dtype, n):
    """C = 1280 (8 heads of 160, 2 blocks): a product rank owns 320 rows of
    K, more than the 256 it holds at once, so it copies its weights in two
    parts, again for each row group at n = 20; within STEP_RTOL of the plain
    version at i = 1, 65 and 783, two runs equal."""
    config = dict(image_gpt.LARGE_CONFIG, n_embedding_channels=1280, n_transformer_blocks=2)
    x, full, weights, n_heads = _step_case(dev, config, n, 784, cache_dtype)
    for i in (1, 65, 783):
        cache = _stale(full, i)
        got = decode_cuda.fused_decode_step(i, x, cache.clone(), weights, n_heads)
        again = decode_cuda.fused_decode_step(i, x, cache.clone(), weights, n_heads)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        _assert_step_close(got, decode_cuda.decode_step_plain(i, x, cache, weights, n_heads))


def test_captured_step_replays_over_positions_like_eager_calls(dev):
    """One step captured into a ``decode_cuda.StepGraph`` with a device
    position, replayed at positions 5, 6, 7 and 300 of one cache, equals the
    eager int calls on a copy of the cache, bit for bit (act and cache).
    The capture counts no step run; each replay counts the one it runs; a
    graph that captured no step counts none."""
    config = dict(image_gpt.REPRODUCE_CONFIG, n_transformer_blocks=2)
    x, cache, weights, n_heads = _step_case(dev, config, 4, 784, torch.float32)
    eager, replayed = cache.clone(), cache.clone()
    pos = torch.tensor(5, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        decode_cuda.fused_decode_step(pos, x, cache.clone(), weights, n_heads)
        graph, empty = decode_cuda.StepGraph(), decode_cuda.StepGraph()
        before = decode_cuda.step_launches
        with graph.capture():
            out, _ = decode_cuda.fused_decode_step(pos, x, replayed, weights, n_heads)
        with empty.capture():
            pos.add_(0)
    torch.cuda.current_stream(dev).wait_stream(side)
    assert decode_cuda.step_launches == before
    assert (graph.steps, empty.steps) == (1, 0)
    for k, i in enumerate((5, 6, 7, 300)):
        pos.fill_(i)
        graph.replay()
        empty.replay()
        assert decode_cuda.step_launches == before + k + 1
        want, _ = decode_cuda.fused_decode_step(i, x, eager, weights, n_heads)
        before += 1
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(replayed, eager)


@pytest.mark.parametrize("inpaint", [False, True])
def test_graph_route_matches_the_eager_plain_step_route(dev, inpaint):
    """The step route as one CUDA graph replayed a position (n = 3, the step
    route) gives the eager plain step route's pixels on uniforms moved off
    its decision boundary, free and inpainted, with H*W step runs and no
    whole loop."""
    model = _model(dev, blocks=2, size=8)
    n, h, w = 3, 8, 8
    cond = -torch.ones((n, h, w, 1), device=dev)
    if inpaint:
        cond[:, : h // 2] = (_rand((n, h // 2, w, 1), 7, dev) > 0).float()
    u = torch.rand((h * w, n, 1), generator=torch.Generator().manual_seed(8)).to(dev)
    with torch.no_grad():
        plain = sampling._image_gpt_decode_step(model, cond, u, torch.float32,
                                                step=decode_cuda.decode_step_plain)
        p = torch.sigmoid(model(plain)).reshape(n, -1).T[..., None]
    d = u - p
    near = (d.abs() < 1e-3) & (cond.reshape(n, -1).T[..., None] < 0)
    u = torch.where(near, (p + 2e-3 * torch.where(d >= 0, 1.0, -1.0)).clamp(0, 1), u)
    with torch.no_grad():
        plain = sampling._image_gpt_decode_step(model, cond, u, torch.float32,
                                                step=decode_cuda.decode_step_plain)
    assert sampling.sample_route(model, n) == sampling.STEP_ROUTE
    decode_cuda.launches = decode_cuda.step_launches = 0
    kw = dict(conditioned_on=cond) if inpaint else dict(n_samples=n)
    got = model.sample(uniforms=u, **kw)
    torch.cuda.synchronize()
    assert (decode_cuda.launches, decode_cuda.step_launches) == (0, h * w)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_host_synchronising_sample_fn_raises(dev):
    """A sample_fn that reads a device value on the host cannot be captured:
    the step route raises and says so before any capture begins, and the
    card and its random generator stay usable."""
    model = _model(dev, blocks=2, size=8)
    model.sample_fn = lambda u, logits: ((u < torch.sigmoid(logits)).float()
                                         if bool((logits > -1e9).all()) else u)
    with pytest.raises(RuntimeError, match="synchronising with the host"):
        model.sample(n_samples=3, generator=torch.Generator().manual_seed(9))
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=dev).sum()) == 2.0
    assert torch.rand(2, device=dev).shape == (2,)  # no capture was left open


# Backward tolerance: f32, each gradient a sum over up to 784 rows or keys
# taken in another order than the dense einsum's.
BWD_TOL = 1e-4


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", FLASH_LENGTHS)
@pytest.mark.parametrize("d_k,d_v", PAIRS)
def test_flash_backward_kernel_matches_plain(dev, mask_center, l, d_k, d_v):
    """dq, dk, dv within BWD_TOL of the plain backward on the same saved out
    and lse; row 0 under mask_center gets an exactly-zero dq."""
    n_heads = 2
    ck = n_heads * d_k
    q = _rand((3, l, ck), l + d_k + d_v, dev)
    kv = _rand((3, l, ck + n_heads * d_v), l + d_k + d_v + 1, dev)
    k, v = kv[..., :ck], kv[..., ck:]
    dout = _rand((3, l, n_heads * d_v), l + d_k + d_v + 2, dev)
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    before = attention_cuda.bwd_launches
    got = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
    torch.cuda.synchronize()
    assert attention_cuda.bwd_launches == before + 1
    want = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center, n_heads)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=BWD_TOL)
    if mask_center:
        assert bool((got[0][:, 0] == 0).all())


def test_attention_function_matches_dense_autograd(dev):
    """The autograd Function on the kernels (f32) against autograd through
    the dense attention, BWD_TOL; the float64 gradcheck of the same Function
    on its plain path runs in tests/test_torch_train.py."""
    n_heads, d, l = 2, 32, 200
    q = _rand((2, l, n_heads * d), 8, dev).requires_grad_()
    kv = _rand((2, l, 2 * n_heads * d), 9, dev).requires_grad_()
    dout = _rand((2, l, n_heads * d), 10, dev)
    k, v = kv[..., : n_heads * d], kv[..., n_heads * d:]
    got = torch.autograd.grad(attention_cuda.causal_attention_packed(q, k, v, False, n_heads),
                              (q, kv), dout)
    dense = causal_attention_with_lse(*(attention_cuda._unpack(t, n_heads) for t in (q, k, v)))[0]
    want = torch.autograd.grad(attention_cuda._pack(dense), (q, kv), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=BWD_TOL)


def test_model_on_cuda_trains_through_the_kernels(dev, tmp_path):
    """One Trainer step on CUDA launches the flash backward once per block;
    its gradients agree with the plain CPU path of the same weights (atol
    1e-4 of grads summed over 144 pixels)."""
    model = _model(dev, blocks=2, size=12)
    cpu = ImageGPT(in_channels=1, out_channels=1, in_size=12, n_transformer_blocks=2,
                   n_attention_heads=2, n_embedding_channels=32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    x = (torch.rand((4, 12, 12, 1), generator=torch.Generator().manual_seed(11)) < 0.3).float()
    image_gpt.reproduce_loss(x, None, cpu(x)).backward()
    t = trainer.Trainer(model, image_gpt.reproduce_loss, optim.adam(1e-3),
                        [], [], log_dir=str(tmp_path), use_tensorboard=False, device=dev)
    attention_cuda.launches = attention_cuda.bwd_launches = 0
    metrics, n = t.train_one_step(x.numpy(), None)
    torch.cuda.synchronize()
    assert (attention_cuda.launches, attention_cuda.bwd_launches, n) == (2, 2, 4)
    assert bool(torch.isfinite(metrics["loss"]))
    for (name, p), (_, pc) in zip(model.named_parameters(), cpu.named_parameters()):
        torch.testing.assert_close(p.grad.cpu(), pc.grad, rtol=0, atol=1e-4, msg=name)


# LayerNorm and MLP kernels: tolerances are shares of each output's largest
# magnitude. f32 throughout; the LayerNorm sums run over C channels and R
# rows, the MLP's over C, F = 4C and R, each in another order than the
# plain version's.
LN_RTOL = 1e-5
MLP_RTOL = 1e-4


def _assert_rel(got, want, rtol, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{name}: max abs err {err:.3e} > {rtol} x {scale:.3e}"


def _ln_inputs(r, c, dev, seed=0):
    x = 2.0 * _rand((r, c), seed, dev) + 0.5
    gamma = 1.0 + 0.1 * _rand((c,), seed + 1, dev)
    beta = 0.1 * _rand((c,), seed + 2, dev)
    return x, gamma, beta


def _mlp_inputs(r, c, dev, seed=0):
    f = 4 * c
    x, gamma, beta = _ln_inputs(r, c, dev, seed)
    w1 = _rand((c, f), seed + 3, dev) / c ** 0.5
    b1 = 0.1 * _rand((f,), seed + 4, dev)
    w2 = _rand((f, c), seed + 5, dev) / f ** 0.5
    b2 = 0.1 * _rand((c,), seed + 6, dev)
    return x, gamma, beta, w1, b1, w2, b2


@pytest.mark.parametrize("r", [1024, 1031])
@pytest.mark.parametrize("c", [128, 512, 640, 1024])
def test_ln_kernels_match_plain(dev, c, r):
    """Forward and (dx, dgamma, dbeta) within LN_RTOL of the plain versions,
    an even and a ragged row count; C = 640 and 1024 take the CTA-per-row
    kernels."""
    x, gamma, beta = _ln_inputs(r, c, dev)
    dy = _rand((r, c), 7, dev)
    before = (ln_cuda.launches, ln_cuda.bwd_launches)
    out = ln_cuda.ln_forward(x, gamma, beta, 1e-5)
    grads = ln_cuda.ln_backward(x, dy, gamma, 1e-5)
    torch.cuda.synchronize()
    assert (ln_cuda.launches, ln_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    _assert_rel(out, ln_cuda.layernorm_forward_plain(x, gamma, beta, 1e-5), LN_RTOL, "y")
    want = ln_cuda.layernorm_backward_plain(x, dy, gamma, 1e-5)
    for name, g, w in zip(("dx", "dgamma", "dbeta"), grads, want):
        _assert_rel(g, w, LN_RTOL, name)


@pytest.mark.parametrize("r", [1024, 1031])
@pytest.mark.parametrize("c", [128, 512, 640, 1024])
def test_mlp_kernels_match_plain(dev, c, r):
    """out and y, then all seven gradients from the same saved y, within
    MLP_RTOL of the plain versions."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(r, c, dev)
    dout = _rand((r, c), 8, dev)
    before = (mlp_cuda.launches, mlp_cuda.bwd_launches)
    out, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
    grads = mlp_cuda.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
    torch.cuda.synchronize()
    assert (mlp_cuda.launches, mlp_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_out, want_y = mlp_cuda.ln_mlp_forward_plain(x, gamma, beta, w1, b1, w2, b2, 1e-5)
    _assert_rel(out, want_out, MLP_RTOL, "out")
    _assert_rel(y, want_y, MLP_RTOL, "y")
    want = mlp_cuda.ln_mlp_backward_plain(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), grads, want):
        _assert_rel(g, w, MLP_RTOL, name)


@pytest.mark.parametrize("r,c", [(4097, 512), (1031, 640), (4097, 1024)])
def test_mlp_backward_routes_give_equal_bits(dev, r, c):
    """The recompute and pipelined backwards give the saved-y route's bits
    (one cut of the rows into slices, partials added in slice order; at
    4,097 rows and C = 512 four slices in two pipelined granules), and two
    calls of the forward and of each backward give the same bits."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(r, c, dev)
    dout = _rand((r, c), 8, dev)
    fwd = [mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5) for _ in range(2)]
    y = fwd[0][1]
    routes = {
        "saved": lambda: mlp_cuda.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, 1e-5),
        "recompute": lambda: mlp_cuda.ln_mlp_backward_recompute(x, dout, gamma, beta, w1, b1,
                                                                w2, 1e-5),
        "pipe": lambda: mlp_cuda.ln_mlp_backward_pipe(x, dout, y, gamma, beta, w1, b1, w2, 1e-5),
    }
    grads = {name: (fn(), fn()) for name, fn in routes.items()}
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    for name, (first, second) in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(first, second)), f"{name} twice"
        assert all(torch.equal(a, b) for a, b in zip(first, grads["saved"][0])), name


def test_ln_and_mlp_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(64, 128, dev)
    with pytest.raises(TypeError):
        ln_cuda.ln_forward(x.double(), gamma.double(), beta.double(), 1e-5)
    with pytest.raises(ValueError):
        ln_cuda.ln_forward(x[:, :126].contiguous(), gamma[:126], beta[:126], 1e-5)
    with pytest.raises(ValueError, match="from 4 to 4096"):
        ln_cuda.ln_forward(torch.cat([x] * 33, dim=1), torch.cat([gamma] * 33),
                           torch.cat([beta] * 33), 1e-5)  # C = 4224 > 4096
    with pytest.raises(ValueError):
        ln_cuda.ln_forward(x, gamma.cpu(), beta, 1e-5)
    with pytest.raises(ValueError):
        ln_cuda.ln_backward(x, x.T.contiguous().T, gamma, 1e-5)
    with pytest.raises(TypeError):
        mlp_cuda.ln_mlp_forward(x, gamma, beta, w1.double(), b1, w2, b2, 1e-5)
    with pytest.raises(ValueError):
        mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2[:, :64], b2, 1e-5)
    with pytest.raises(ValueError):
        mlp_cuda.ln_mlp_forward(x, gamma, beta, w1.cpu(), b1, w2, b2, 1e-5)
    with pytest.raises(ValueError):
        mlp_cuda.ln_mlp_backward(x, x, x, gamma, beta, w1, b1, w2, 1e-5)  # y not (R, F)


def test_large_config_train_step_runs_every_training_kernel(dev, tmp_path):
    """ImageGPT(**LARGE_CONFIG) (C = 512, 8 heads, 8 blocks), one Trainer
    step at batch 2 (1568 rows): per step 9 LayerNorm forwards and
    backwards (8 ln1 + the final one), 8 MLP and 8 flash forwards and
    backwards."""
    model = ImageGPT(**image_gpt.LARGE_CONFIG,
                     generator=torch.Generator().manual_seed(0), device=dev)
    x = (torch.rand((2, 28, 28, 1), generator=torch.Generator().manual_seed(1)) < 0.3).float()
    t = trainer.Trainer(model, image_gpt.reproduce_loss, optim.adam(1e-3),
                        [], [], log_dir=str(tmp_path), use_tensorboard=False, device=dev)
    attention_cuda.launches = attention_cuda.bwd_launches = 0
    ln_cuda.launches = ln_cuda.bwd_launches = mlp_cuda.launches = mlp_cuda.bwd_launches = 0
    metrics, _ = t.train_one_step(x.numpy(), None)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["loss"]))
    assert (ln_cuda.launches, ln_cuda.bwd_launches) == (9, 9)
    assert (mlp_cuda.launches, mlp_cuda.bwd_launches) == (8, 8)
    assert (attention_cuda.launches, attention_cuda.bwd_launches) == (8, 8)


# PixelSNAIL: the whole-loop sampler kernel and the model on the card.
SNAIL_TINY = dict(n_channels=16, n_pixel_snail_blocks=2, n_residual_blocks=2,
                  attention_key_channels=4, attention_value_channels=8, in_shape=(8, 8, 1))


def _snail(dev, seed=0):
    return PixelSNAIL(**SNAIL_TINY, generator=torch.Generator().manual_seed(seed),
                      device=dev).eval()


@pytest.mark.parametrize("inpaint", [False, True])
def test_snail_loop_kernel_matches_plain(dev, inpaint):
    """Pixel-equal to the plain KV-cache decoder (8x8, C 16, 2 blocks, d_k
    4, d_v 8, n 4), on uniforms moved 2e-3 off the decision boundary of the
    plain sample's teacher-forced logits; one launch."""
    model = _snail(dev)
    n, h, w = 4, 8, 8
    cond = -torch.ones((n, h, w, 1), device=dev)
    if inpaint:
        cond[:, :4] = (_rand((n, 4, w, 1), 3, dev) > 0).float()
    u = torch.rand((h * w, n, 1), generator=torch.Generator().manual_seed(4)).to(dev)
    plain = snail_decode_cuda.snail_sample_loop_plain(*sampling.snail_loop_inputs(model, cond, u))
    with torch.no_grad():
        p = torch.sigmoid(model(sampling.canvas_to_images(plain, h, w))).reshape(n, -1).T[..., None]
    d = u - p
    u = torch.where(d.abs() < 1e-3, (p + 2e-3 * torch.where(d >= 0, 1.0, -1.0)).clamp(0, 1), u)
    inputs = sampling.snail_loop_inputs(model, cond, u)
    plain = snail_decode_cuda.snail_sample_loop_plain(*inputs)
    before = snail_decode_cuda.launches
    kern = snail_decode_cuda.fused_snail_sample_loop(*inputs)
    torch.cuda.synchronize()
    assert snail_decode_cuda.launches == before + 1
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)
    if inpaint:
        assert bool((sampling.canvas_to_images(kern, h, w)[:, :4] == cond[:, :4]).all())


def _snail_nudged(dev, cfg, n, inpaint, seed=0):
    """A PixelSNAIL of ``cfg`` and the kernel's inputs for n samples (free,
    or with the top half kept), on uniforms moved 2e-3 off the decision
    boundary of the plain sample's teacher-forced logits."""
    model = PixelSNAIL(**cfg, generator=torch.Generator().manual_seed(seed), device=dev).eval()
    h, w, _ = cfg["in_shape"]
    cond = -torch.ones((n, h, w, 1), device=dev)
    if inpaint:
        cond[:, :h // 2] = (_rand((n, h // 2, w, 1), 3, dev) > 0).float()
    u = torch.rand((h * w, n, 1), generator=torch.Generator().manual_seed(4)).to(dev)
    plain = snail_decode_cuda.snail_sample_loop_plain(*sampling.snail_loop_inputs(model, cond, u))
    with torch.no_grad():
        p = torch.sigmoid(model(sampling.canvas_to_images(plain, h, w))).reshape(n, -1).T[..., None]
    d = u - p
    u = torch.where(d.abs() < 1e-3, (p + 2e-3 * torch.where(d >= 0, 1.0, -1.0)).clamp(0, 1), u)
    return sampling.snail_loop_inputs(model, cond, u), cond


SNAIL_CASES = [pytest.param(SNAIL_TINY, n, inpaint,
                            id=f"tiny-n{n}-{'inpaint' if inpaint else 'free'}")
               for n in (1, 2, 5, 16, 17, 64) for inpaint in (False, True)]
SNAIL_CASES += [
    pytest.param(dict(SNAIL_TINY, n_channels=32), 5, True, id="c32-n5-inpaint"),
    pytest.param(dict(SNAIL_TINY, n_channels=32), 17, False, id="c32-n17-free"),
    pytest.param(dict(SNAIL_TINY, n_channels=128), 3, False, id="c128-n3-free"),
    pytest.param(dict(SNAIL_TINY, n_channels=128), 16, True, id="c128-n16-inpaint"),
    pytest.param(dict(SNAIL_TINY, attention_value_channels=32), 5, False, id="dv32-n5-free"),
    pytest.param(dict(SNAIL_TINY, attention_value_channels=32), 6, True, id="dv32-n6-inpaint"),
    pytest.param(dict(SNAIL_TINY, n_residual_blocks=1), 5, True, id="rb1-n5-inpaint"),
    pytest.param(dict(SNAIL_TINY, in_shape=(7, 5, 1)), 4, True, id="7x5-n4-inpaint"),
]


@pytest.mark.parametrize("cfg,n,inpaint", SNAIL_CASES)
def test_snail_loop_kernel_matches_plain_at_every_plan(dev, cfg, n, inpaint):
    """Pixel-equal to the plain decoder at widths C 16 / 32 / 128, d_v 8 /
    32, one or two residual blocks a block, and at the plans of n = 1-64
    (one group or several a cluster); one launch; two calls give equal
    bits."""
    inputs, cond = _snail_nudged(dev, cfg, n, inpaint)
    h, w = inputs[3], inputs[4]
    plain = snail_decode_cuda.snail_sample_loop_plain(*inputs)
    before = snail_decode_cuda.launches
    kern = snail_decode_cuda.fused_snail_sample_loop(*inputs)
    again = snail_decode_cuda.fused_snail_sample_loop(*inputs)
    torch.cuda.synchronize()
    assert snail_decode_cuda.launches == before + 2
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)
    assert torch.equal(kern, again)
    if inpaint:
        assert bool((sampling.canvas_to_images(kern, h, w)[:, :h // 2] == cond[:, :h // 2]).all())


@pytest.mark.parametrize("inpaint", [False, True])
def test_snail_loop_kernel_matches_plain_at_the_reproduce_config(dev, inpaint):
    """The reproduce() PixelSNAIL (28x28, C 64, 8 blocks, d_k 4, d_v 32) at
    n = 16: pixel-equal to the plain decoder."""
    from pytorch_generative_tpu_torch.models.autoregressive import pixel_snail

    inputs, _ = _snail_nudged(dev, pixel_snail.REPRODUCE_CONFIG, 16, inpaint)
    plain = snail_decode_cuda.snail_sample_loop_plain(*inputs)
    kern = snail_decode_cuda.fused_snail_sample_loop(*inputs)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)


def test_snail_loop_kernel_serves_more_groups_than_clusters_fit(dev):
    """At an n whose groups outnumber the clusters the card holds, each
    cluster serves several groups in turn, and the samples stay
    pixel-equal."""
    model = _snail(dev)
    n = 64
    while True:
        inputs = sampling.snail_loop_inputs(model, -torch.ones((n, 8, 8, 1), device=dev),
                                            torch.rand((64, n, 1), device=dev))
        plan = snail_decode_cuda.plan_for(*inputs)
        if plan.groups > plan.clusters:
            break
        n *= 2
    inputs, _ = _snail_nudged(dev, SNAIL_TINY, n, False)
    assert snail_decode_cuda.plan_for(*inputs) == plan
    plain = snail_decode_cuda.snail_sample_loop_plain(*inputs)
    kern = snail_decode_cuda.fused_snail_sample_loop(*inputs)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 16, 64, 256])
def test_snail_plan_fits_the_card(dev, n):
    """A plan never asks for more clusters than cudaOccupancyMaxActiveClusters
    gives for its instance and shared memory, at SNAIL_TINY and at the
    reproduce() config."""
    from pytorch_generative_tpu_torch.models.autoregressive import pixel_snail

    for cfg in (SNAIL_TINY, pixel_snail.REPRODUCE_CONFIG):
        model = PixelSNAIL(**cfg, generator=torch.Generator().manual_seed(0), device=dev).eval()
        h, w, _ = cfg["in_shape"]
        inputs = sampling.snail_loop_inputs(model, -torch.ones((n, h, w, 1), device=dev),
                                            torch.rand((h * w, n, 1), device=dev))
        plan = snail_decode_cuda.plan_for(*inputs)
        cap, regs = snail_decode_cuda.occupancy(plan.samples, plan.cluster, plan.smem)
        assert 1 <= plan.clusters <= cap and regs > 0
        assert plan.groups == -(-n // plan.samples)


def test_snail_loop_refuses_a_size_without_a_plan(dev):
    """Widths the kernel cannot cut (C // 2 = 10, not a multiple of 4) raise
    a ValueError before any launch; nothing else serves them."""
    model = PixelSNAIL(**dict(SNAIL_TINY, n_channels=20),
                       generator=torch.Generator().manual_seed(0), device=dev).eval()
    inputs = sampling.snail_loop_inputs(model, -torch.ones((2, 8, 8, 1), device=dev),
                                        torch.rand((64, 2, 1), device=dev))
    before = snail_decode_cuda.launches
    with pytest.raises(ValueError, match="multiples of 4"):
        snail_decode_cuda.fused_snail_sample_loop(*inputs)
    with pytest.raises(ValueError, match="multiples of 4"):
        model.sample(n_samples=2)
    assert snail_decode_cuda.launches == before


def test_pixel_snail_on_cuda_runs_the_kernels(dev):
    """forward launches the flash forward once per block and agrees with the
    plain CPU forward within 1e-4; a backward launches the flash backward
    once per block; sample launches snail_loop once at any n, and a custom
    sample_fn takes the incremental sampler (no launch)."""
    model = _snail(dev, seed=1)
    cpu = PixelSNAIL(**SNAIL_TINY, device="cpu").eval()
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    x = (torch.rand((3, 8, 8, 1), generator=torch.Generator().manual_seed(2)) < 0.3).float()
    attention_cuda.launches = attention_cuda.bwd_launches = 0
    with torch.no_grad():
        got = model(x.to(dev))
        want = cpu(x)
    torch.cuda.synchronize()
    assert attention_cuda.launches == 2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    loss = image_gpt.reproduce_loss(x.to(dev), None, model(x.to(dev)))
    loss.backward()
    torch.cuda.synchronize()
    assert attention_cuda.bwd_launches == 2
    snail_decode_cuda.launches = 0
    for n in (1, 5):
        s = model.sample(n_samples=n, generator=torch.Generator().manual_seed(n))
        assert s.shape == (n, 8, 8, 1) and set(s.unique().tolist()) <= {0.0, 1.0}
    torch.cuda.synchronize()
    assert snail_decode_cuda.launches == 2
    model.sample_fn = lambda uu, logits: (uu < torch.sigmoid(logits)).float()
    s = model.sample(n_samples=2, generator=torch.Generator().manual_seed(3))
    torch.cuda.synchronize()
    assert snail_decode_cuda.launches == 2
    assert s.shape == (2, 8, 8, 1) and set(s.unique().tolist()) <= {0.0, 1.0}


def test_snail_loop_wrapper_rejects_what_the_kernel_does_not_take(dev):
    model = _snail(dev)
    cond = -torch.ones((2, 8, 8, 1), device=dev)
    u = torch.rand((64, 2, 1), device=dev)
    canvas0, u, weights, h, w = sampling.snail_loop_inputs(model, cond, u)
    run = snail_decode_cuda.fused_snail_sample_loop
    with pytest.raises(ValueError):
        run(canvas0, u[:10], weights, h, w)
    with pytest.raises(TypeError):
        run(canvas0, u.double(), weights, h, w)
    with pytest.raises(ValueError):
        run(canvas0, u, dict(weights, q_w=weights["q_w"].cpu()), h, w)
    with pytest.raises(ValueError):
        run(canvas0.T.contiguous().T, u, weights, h, w)


# VQ: the fused quantization kernel and the VQ-VAE on the card.
# Scores summed over D terms in another order than the plain version's
# matrix product: rows whose top-two scores are closer than this (relative
# to the largest |score|) may pick either code; they are counted and only
# they may differ.
VQ_NEAR_TIE = 1e-5


def _vq_check(x, cb):
    """Runs the kernel and its plain version: a row's code may differ only
    on a near-tie, and then it holds one of its two best codes."""
    before = vq_cuda.launches
    q, counts, sums = vq_cuda.vq_quantize_fused(x, cb)
    torch.cuda.synchronize()
    assert vq_cuda.launches == before + 1
    pq, pcounts, psums = vq_cuda.vq_quantize_plain(x, cb)
    scores = 2.0 * (x.double() @ cb.double().T) - (cb.double() ** 2).sum(1)
    top2 = torch.cat([scores, torch.full_like(scores[:, :1], -float("inf"))], 1).topk(2, dim=1)
    near = (top2.values[:, 0] - top2.values[:, 1]) <= VQ_NEAR_TIE * float(scores.abs().max())
    differ = (q != pq).any(dim=1)
    assert not bool((differ & ~near).any())
    # A differing row still holds one of its two best codes, exactly.
    best = [cb[top2.indices[differ, j].clamp(max=cb.shape[0] - 1)] for j in (0, 1)]
    assert bool(((q[differ] == best[0]).all(1) | (q[differ] == best[1]).all(1)).all())
    assert float(counts.sum()) == x.shape[0]
    if not bool(differ.any()):
        assert torch.equal(counts, pcounts)
        assert float((sums - psums).abs().max()) <= 1e-5 * float(psums.abs().max())


@pytest.mark.parametrize("m,k,d", [(8192, 512, 64), (8191, 512, 64), (300, 512, 64),
                                   (1000, 37, 12), (77, 2000, 256), (64, 1, 4)])
def test_vq_kernel_matches_plain(dev, m, k, d):
    """quantized exact codebook rows, equal to the plain version's except on
    near-tie rows; counts exact and summing to M (ragged M included); sums
    within 1e-5 of the largest |sum| (row-order sums against a matrix
    product). K = 2000 at D = 256 takes several codebook chunks."""
    x = _rand((m, d), m + k, dev)
    cb = _rand((k, d), d, dev)
    _vq_check(x, cb)


def test_vq_kernel_takes_the_first_index_on_exact_ties(dev):
    """A codebook with rows 7 and 20 equal to row 3, and rows close to it:
    every tie goes to code 3, as in torch.argmax and jnp.argmax."""
    cb = _rand((32, 16), 1, dev)
    cb[[7, 20]] = cb[3].clone()
    x = _rand((500, 16), 2, dev)
    x[:100] = cb[3] + 0.01 * _rand((100, 16), 3, dev)
    _vq_check(x, cb)
    _, counts, _ = vq_cuda.vq_quantize_fused(x, cb)
    assert counts[3] >= 100 and counts[7] == counts[20] == 0


@pytest.mark.parametrize("m,k,d", [(8192, 512, 64), (1001, 2000, 256)])
def test_vq_kernel_gives_equal_bits_in_two_calls(dev, m, k, d):
    """No atomics: two calls on the same inputs give the same quantized
    rows, counts and sums, bit for bit."""
    x, cb = _rand((m, d), m, dev), _rand((k, d), k, dev)
    first = vq_cuda.vq_quantize_fused(x, cb)
    second = vq_cuda.vq_quantize_fused(x, cb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("n_codes", [1, 8])
def test_vq_kernel_on_a_skewed_codebook(dev, n_codes):
    """Every row next to one code (a collapsed codebook) or to one of 8:
    each used code gathers an entry from every block of rows."""
    m, k, d = 8192, 512, 64
    cb = _rand((k, d), 5, dev)
    x = cb[torch.arange(m, device=dev) % n_codes * 61 % k] + 0.01 * _rand((m, d), 6, dev)
    _vq_check(x, cb)
    _, counts, _ = vq_cuda.vq_quantize_fused(x, cb)
    assert int((counts > 0).sum()) == n_codes


def test_vq_kernel_wide_rows_many_codes_ragged_blocks(dev):
    """D = 256 (four 64-wide chunks of D), K = 2000 (a ragged last tile of
    codes) and M = 1001, not a multiple of the kernel's 64-row blocks."""
    _vq_check(_rand((1001, 256), 7, dev), _rand((2000, 256), 8, dev))


def test_vq_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, cb = _rand((64, 16), 0, dev), _rand((8, 16), 1, dev)
    with pytest.raises(TypeError):
        vq_cuda.vq_quantize_fused(x.double(), cb.double())
    with pytest.raises(ValueError, match="from 4 to 256"):
        vq_cuda.vq_quantize_fused(_rand((64, 260), 0, dev), _rand((8, 260), 1, dev))
    with pytest.raises(ValueError, match="from 4 to 256"):
        vq_cuda.vq_quantize_fused(x[:, :14].contiguous(), cb[:, :14].contiguous())
    with pytest.raises(ValueError):
        vq_cuda.vq_quantize_fused(x, cb[:, :8].contiguous())
    with pytest.raises(ValueError):
        vq_cuda.vq_quantize_fused(x, cb.cpu())
    with pytest.raises(ValueError):
        vq_cuda.vq_quantize_fused(x.T.contiguous().T, cb)
    with pytest.raises(ValueError, match="16-byte"):
        vq_cuda.vq_quantize_fused(x.reshape(-1)[1:1 + 63 * 16].reshape(63, 16), cb)


VQ_TINY = dict(in_channels=3, out_channels=3, hidden_channels=32, residual_channels=8,
               n_residual_blocks=1, n_embeddings=32, embedding_dim=16, in_shape=(16, 16, 3))


@pytest.mark.parametrize("use_fused", [True, False])
def test_vq_vae_on_cuda_runs_the_kernel_on_the_fused_route(dev, use_fused):
    """One training forward and backward: the fused route launches the VQ
    kernel once, the unfused route never; both match the CPU model (fused
    there means the kernel's plain version) within 1e-4 (f32 convolutions
    in another order) and move the EMA buffers alike."""
    model = VectorQuantizedVAE(**VQ_TINY, use_fused=use_fused,
                               generator=torch.Generator().manual_seed(0), device=dev)
    cpu = VectorQuantizedVAE(**VQ_TINY, use_fused=use_fused, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    before = vq_cuda.launches
    model.train()
    cpu.train()
    out, loss = model(x.to(dev))
    (out.square().mean() + loss).backward()
    torch.cuda.synchronize()
    assert vq_cuda.launches == before + (1 if use_fused else 0)
    ref, ref_loss = cpu(x)
    (ref.square().mean() + ref_loss).backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=0, atol=1e-4)
    for (name, b), (_, bc) in zip(model.named_buffers(), cpu.named_buffers()):
        torch.testing.assert_close(b.cpu(), bc, rtol=0, atol=1e-4, msg=name)
    for (name, p), (_, pc) in zip(model.named_parameters(), cpu.named_parameters()):
        torch.testing.assert_close(p.grad.cpu(), pc.grad, rtol=1e-3, atol=1e-5, msg=name)


# The MLP backward's recompute (no saved y) and pipelined routes.
@pytest.mark.parametrize("r", [8192, 8185])
@pytest.mark.parametrize("c", [512, 1024])
def test_mlp_backward_routes_match_plain_and_the_saved_y_route(dev, c, r):
    """Both routes within MLP_RTOL of the saved-y route's plain version, and
    bit for bit equal to the saved-y kernel from the forward kernel's y (the
    recompute route rebuilds y by the forward's own launches; the pipelined
    route cuts its sums as the saved-y route does)."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(r, c, dev)
    dout = _rand((r, c), 9, dev)
    _, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
    saved = mlp_cuda.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
    before = (mlp_cuda.recompute_launches, mlp_cuda.pipe_launches)
    routes = {"recompute": mlp_cuda.ln_mlp_backward_recompute(x, dout, gamma, beta, w1, b1,
                                                              w2, 1e-5),
              "pipe": mlp_cuda.ln_mlp_backward_pipe(x, dout, y, gamma, beta, w1, b1, w2,
                                                    1e-5)}
    torch.cuda.synchronize()
    assert (mlp_cuda.recompute_launches, mlp_cuda.pipe_launches) == (before[0] + 1,
                                                                    before[1] + 1)
    want = mlp_cuda.ln_mlp_backward_plain(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for route, grads in routes.items():
        for name, g, w, k in zip(names, grads, want, saved):
            _assert_rel(g, w, MLP_RTOL, f"{route} {name}")
            assert torch.equal(g, k), f"{route} {name} differs from the saved-y kernel"


# The fused attention block.
BLOCK_WIDTHS = [pytest.param(64, 2, id="C64-2heads"), pytest.param(512, 8, id="C512-8heads"),
                pytest.param(512, 4, id="C512-4heads")]
BLOCK_TOL = 1e-4  # y and attn, of each output's largest magnitude
BLOCK_LSE_TOL = 5e-5


def _block_inputs(b, l, c, dev, c_out=None, seed=0):
    c_out = c_out or c
    x = _rand((b, l, c), seed, dev)
    wq = _rand((c, c_out), seed + 1, dev) / c ** 0.5
    bq = 0.1 * _rand((c_out,), seed + 2, dev)
    wkv = _rand((c, 2 * c_out), seed + 3, dev) / c ** 0.5
    bkv = 0.1 * _rand((2 * c_out,), seed + 4, dev)
    wo = _rand((c_out, c_out), seed + 5, dev) / c_out ** 0.5
    bo = 0.1 * _rand((c_out,), seed + 6, dev)
    return x, wq, bq, wkv, bkv, wo, bo


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 200])
@pytest.mark.parametrize("c,n_heads", BLOCK_WIDTHS)
def test_attn_block_kernel_matches_plain(dev, c, n_heads, l, mask_center):
    """y and attn within BLOCK_TOL of each one's largest magnitude, lse
    within BLOCK_LSE_TOL; under mask_center row 0 is exactly 0 with lse
    -inf. L = 200 ends on a ragged tile."""
    ops = _block_inputs(2, l, c, dev)
    before = attn_block_cuda.launches
    got = attn_block_cuda.attention_block_forward(*ops, mask_center, n_heads)
    torch.cuda.synchronize()
    assert attn_block_cuda.launches == before + 1
    want = attn_block_cuda.attention_block_plain(*ops, mask_center, n_heads)
    _assert_rel(got[0], want[0], BLOCK_TOL, "y")
    _assert_rel(got[1], want[1], BLOCK_TOL, "attn")
    finite = torch.isfinite(want[2])
    assert torch.equal(torch.isfinite(got[2]), finite)
    assert float((got[2] - want[2])[finite].abs().max()) <= BLOCK_LSE_TOL
    if mask_center:
        assert bool((got[1][:, 0] == 0).all()) and bool(torch.isneginf(got[2][:, :, 0]).all())


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("c,n_heads", BLOCK_WIDTHS)
def test_attn_block_kernel_gives_equal_bits_twice(dev, c, n_heads, mask_center):
    """The block's products and attention sum each output in one fixed
    order: two calls on the same inputs give y, attn and lse bit for bit
    (L = 200, a ragged tile)."""
    ops = _block_inputs(2, 200, c, dev, seed=5)
    first = attn_block_cuda.attention_block_forward(*ops, mask_center, n_heads)
    second = attn_block_cuda.attention_block_forward(*ops, mask_center, n_heads)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "attn", "lse"), first, second):
        assert torch.equal(a, b), name


# (B, L, C, E) of the projection stage's two products (N = E and 2E, K = C,
# M = B L): M off the 128-row tile, N = 64 (one half tile), N = 68 (not a
# multiple of 8), K = 64 and 512 (under and over the 32-deep k-step), and a
# single row.
GEMM_SHAPES = [pytest.param(3, 61, 64, 64, id="M183-K64-N64"),
               pytest.param(2, 200, 512, 64, id="M400-K512-N64"),
               pytest.param(2, 200, 512, 512, id="M400-K512-N512"),
               pytest.param(3, 61, 64, 68, id="M183-K64-N68"),
               pytest.param(1, 1, 512, 4, id="M1-K512-N4")]


@pytest.mark.parametrize("b,l,c,e", GEMM_SHAPES)
def test_gemm_tf32x3_matches_addmm(dev, b, l, c, e):
    """The 3xTF32 GEMM (through the projection stage, which is two of its
    launches) against torch.addmm in f32 (TF32 off): within 1e-5 of each
    output's largest magnitude (both sum at most 512 products to f32
    accuracy, in other orders; the GEMM's error against float64 is ~3e-7
    of it), and equal bits from two calls."""
    x = _rand((b, l, c), 20, dev)
    wq, wkv = _rand((c, e), 21, dev) / c ** 0.5, _rand((c, 2 * e), 22, dev) / c ** 0.5
    bq, bkv = _rand((e,), 23, dev), _rand((2 * e,), 24, dev)
    before = attn_block_cuda.project_launches
    q, kv = attn_block_cuda.project(x, wq, bq, wkv, bkv)
    q2, kv2 = attn_block_cuda.project(x, wq, bq, wkv, bkv)
    torch.cuda.synchronize()
    assert attn_block_cuda.project_launches == before + 2
    x2 = x.reshape(-1, c)
    _assert_rel(q.reshape(-1, e), torch.addmm(bq, x2, wq), 1e-5, "q")
    _assert_rel(kv.reshape(-1, 2 * e), torch.addmm(bkv, x2, wkv), 1e-5, "kv")
    assert torch.equal(q, q2) and torch.equal(kv, kv2)


def test_attn_block_takes_a_y_width_other_than_x(dev):
    """C' = wo.shape[1] (64 -> 128 here): the output is sized by Wo, not by
    x (the JAX kernel's defect at attn_block_pallas.py:185)."""
    ops = _block_inputs(2, 200, 64, dev, c_out=128)
    got = attn_block_cuda.attention_block_forward(*ops, False, 2)
    want = attn_block_cuda.attention_block_plain(*ops, False, 2)
    assert got[0].shape == (2, 200, 128)
    _assert_rel(got[0], want[0], BLOCK_TOL, "y")


def test_attn_block_function_matches_the_cpu(dev):
    """Gradients through _AttentionBlockPacked on the card (the block
    kernel, its projection stage and the flash backward kernel) against
    the same Function on the CPU (plain versions): within 1e-4 of each
    gradient's largest magnitude."""
    ops = _block_inputs(2, 200, 512, dev)
    gy = _rand((2, 200, 512), 11, dev)
    cpu = [t.cpu().requires_grad_() for t in ops]
    card = [t.clone().requires_grad_() for t in ops]
    before = (attn_block_cuda.project_launches, attention_cuda.bwd_launches)
    for ts in (card, cpu):
        attn_block_cuda.attention_block_packed(*ts, True, 8).backward(
            gy.to(ts[0].device))
    torch.cuda.synchronize()
    assert (attn_block_cuda.project_launches, attention_cuda.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for name, a, b in zip(("x", "wq", "bq", "wkv", "bkv", "wo", "bo"), card, cpu):
        _assert_rel(a.grad.cpu(), b.grad, 1e-4, f"d{name}")


def test_attn_block_and_mlp_route_wrappers_reject_what_the_kernels_do_not_take(dev):
    ops = _block_inputs(2, 64, 64, dev)
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        attn_block_cuda.attention_block_forward(*ops, False, 4)  # d = 16
    x, wq, bq, wkv, bkv, wo, bo = ops
    with pytest.raises(ValueError, match="d_k == d_v"):  # d_k 32, d_v 64
        attn_block_cuda.attention_block_forward(
            x, wq, bq, torch.cat([wkv, wkv[:, 64:]], 1), torch.cat([bkv, bkv[64:]]),
            torch.cat([wo, wo]), bo, False, 2)
    with pytest.raises(TypeError):
        attn_block_cuda.attention_block_forward(x.double(), *ops[1:], False, 2)
    with pytest.raises(ValueError):
        attn_block_cuda.attention_block_forward(x, wq.cpu(), *ops[2:], False, 2)
    x, gamma, beta, w1, b1, w2, b2 = _mlp_inputs(64, 128, dev)
    wide = [torch.cat([t] * 33, dim=0 if t.dim() == 1 else -1) for t in (x, gamma, beta)]
    with pytest.raises(ValueError, match="from 4 to 4096"):  # C = 4224
        mlp_cuda.ln_mlp_backward_recompute(wide[0], wide[0], wide[1], wide[2], w1, b1, w2,
                                           1e-5)
    with pytest.raises(ValueError):
        mlp_cuda.ln_mlp_backward_pipe(x, x, x, gamma, beta, w1, b1, w2, 1e-5)  # y not (R, F)
    with pytest.raises(TypeError):
        mlp_cuda.ln_mlp_backward_recompute(x, x, gamma, beta, w1.double(), b1, w2, 1e-5)


@pytest.mark.parametrize("route", ["saved", "recompute", "pipe"])
def test_imagegpt_with_the_fused_block_trains_through_the_kernels(dev, tmp_path, monkeypatch,
                                                                  route):
    """PGT_FUSED_ATTN=1 at C = 128, 2 heads of 64, 2 blocks: a forward runs
    the block kernel twice and flash_fwd never; a Trainer step also runs
    flash_bwd twice and the chosen MLP backward route twice; the loss
    matches the CPU's plain path within 1e-4 relative."""
    monkeypatch.setenv("PGT_FUSED_ATTN", "1")
    if route == "recompute":
        monkeypatch.setattr(mlp_cuda, "_SAVE_PREACT", False)
    if route == "pipe":
        monkeypatch.setenv("PGT_MLP_BWD", "pipe")
    cfg = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=2,
               n_attention_heads=2, n_embedding_channels=128, in_shape=(8, 8, 1))
    model = ImageGPT(**cfg, generator=torch.Generator().manual_seed(0), device=dev)
    cpu = ImageGPT(**cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = (torch.rand((4, 8, 8, 1), generator=torch.Generator().manual_seed(1)) < 0.3).float()
    counters = (attn_block_cuda, attention_cuda, mlp_cuda)
    for mod in counters:
        mod.launches = 0
    attention_cuda.bwd_launches = mlp_cuda.bwd_launches = 0
    mlp_cuda.recompute_launches = mlp_cuda.pipe_launches = attn_block_cuda.project_launches = 0
    with torch.no_grad():
        got = model(x.to(dev))
    torch.cuda.synchronize()
    assert (attn_block_cuda.launches, attention_cuda.launches) == (2, 0)
    with torch.no_grad():
        _assert_rel(got.cpu(), cpu(x), 1e-4, "logits")
    t = trainer.Trainer(model, image_gpt.reproduce_loss, optim.adam(1e-3), [], [],
                        log_dir=str(tmp_path), use_tensorboard=False, device=dev)
    t_cpu = trainer.Trainer(cpu, image_gpt.reproduce_loss, optim.adam(1e-3), [], [],
                            log_dir=str(tmp_path / "cpu"), use_tensorboard=False,
                            device="cpu")
    metrics, _ = t.train_one_step(x.numpy(), None)
    ref, _ = t_cpu.train_one_step(x.numpy(), None)
    torch.cuda.synchronize()
    assert abs(float(metrics["loss"]) - float(ref["loss"])) <= 1e-4 * abs(float(ref["loss"]))
    assert (attn_block_cuda.launches, attn_block_cuda.project_launches) == (4, 2)
    assert (attention_cuda.launches, attention_cuda.bwd_launches) == (0, 2)
    routes = {"saved": mlp_cuda.bwd_launches, "recompute": mlp_cuda.recompute_launches,
              "pipe": mlp_cuda.pipe_launches}
    assert routes == {k: (2 if k == route else 0) for k in routes}


# ---- The bf16 modes (Trainer(compute_dtype=torch.bfloat16)) ----
#
# Each bf16 kernel against its plain version, which runs in f32 on the card
# and rounds to bf16 where the kernel (and the JAX kernel) does. The two sum
# in other orders, so a bf16 output may land one bf16 step apart: outputs
# are held within 2 steps (2^-7) of the reference's largest magnitude (at
# least 1), which covers one step at any element; f32 statistics and
# gradient sums within
# the bounds each test states (the kernels' largest errors on an H100 were
# under half of them).

BF16_TOL = 2.0 ** -7


def _bf16(t):
    return t.to(torch.bfloat16)


def _assert_bf16(got, want, rtol, name):
    """max |got - want| <= rtol x max(1, max |want|), both as f32: a
    gradient that is 0 in exact arithmetic (dq at L = 1, where dS = dP -
    delta cancels) is held at the scale of 1, not of its rounding."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{name}: max abs err {err:.3e} > {rtol} x {scale:.3e}"


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("d,n_heads", [(32, 2), (64, 8), (128, 4)])
def test_flash_bf16_kernels_match_plain_at_full_width(dev, d, n_heads, mask_center):
    """ImageGPT's widths at B 64, L 784 (C = 64 with 2 heads of 32, C = 512
    with 8 of 64 and 4 of 128), k and v feature slices of one kv tensor:
    out, dq, dk, dv within 2 bf16 steps x scale, lse within 1e-6 x scale of
    the plain versions; a second call gives the same bits."""
    b, l = 64, 784
    c = d * n_heads
    q = _bf16(_rand((b, l, c), d, dev))
    kv = _bf16(_rand((b, l, 2 * c), d + 1, dev))
    dout = _bf16(_rand((b, l, c), d + 2, dev))
    k, v = kv[..., :c], kv[..., c:]
    before = (attention_cuda.bf16_launches, attention_cuda.bf16_bwd_launches,
              attention_cuda.launches, attention_cuda.bwd_launches)
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
    out2, lse2 = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
    grads2 = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
    torch.cuda.synchronize()
    assert (attention_cuda.bf16_launches, attention_cuda.bf16_bwd_launches,
            attention_cuda.launches, attention_cuda.bwd_launches) == (
        before[0] + 2, before[1] + 2, before[2], before[3])
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
    ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, n_heads)
    _assert_bf16(out.float(), ref_out.float(), BF16_TOL, "out")
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    _assert_bf16(lse[finite], ref_lse[finite], 1e-6, "lse")
    ref = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center, n_heads)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        _assert_bf16(g.float(), r.float(), BF16_TOL, name)
    if mask_center:
        assert bool((out[:, 0] == 0).all()) and bool((grads[0][:, 0] == 0).all())


# The bf16 kernels' tile edges besides FLASH_LENGTHS: their 32-row dk/dv
# query tiles, 64-row consumer groups and 64-key tiles, and 128- and
# 192-row CTA tiles (csrc/flash_wgmma_bf16.cuh).
BF16_FLASH_LENGTHS = sorted(set(FLASH_LENGTHS) | {16, 31, 32, 63, 127, 128, 129, 191, 192, 193,
                                                  255, 256, 257})


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", BF16_FLASH_LENGTHS)
@pytest.mark.parametrize("d", attention_cuda.BF16_HEAD_DIMS)
def test_flash_bf16_kernels_match_plain_at_tile_edges(dev, d, l, mask_center):
    """Every bf16 instance (d = 16 to 128) at lengths on the tiles' edges,
    B 3, 2 heads: as at full width."""
    c = 2 * d
    q = _bf16(_rand((3, l, c), l + d, dev))
    kv = _bf16(_rand((3, l, 2 * c), l + d + 1, dev))
    dout = _bf16(_rand((3, l, c), l + d + 2, dev))
    k, v = kv[..., :c], kv[..., c:]
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, 2)
    grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, 2)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, 2)
    _assert_bf16(out.float(), ref_out.float(), BF16_TOL, "out")
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    if finite.any():
        _assert_bf16(lse[finite], ref_lse[finite], 1e-6, "lse")
    ref = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center, 2)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        _assert_bf16(g, r, BF16_TOL, name)


@pytest.mark.parametrize("d", attention_cuda.BF16_HEAD_DIMS)
def test_flash_bf16_plan_mirrors_the_kernels(dev, d):
    """test_torch_flash_plan.smem_bytes, which the CPU plan tests hold to
    the card's limit, is what the kernels ask for."""
    import ctypes

    from test_torch_flash_plan import smem_bytes

    fwd = attention_cuda._build.load(attention_cuda.KERNEL).flash_fwd_bf16_smem
    bwd = attention_cuda._build.load(attention_cuda.BWD_KERNEL).flash_bwd_bf16_smem
    fwd.argtypes, bwd.argtypes = [ctypes.c_int], [ctypes.c_int, ctypes.c_int]
    want = smem_bytes(d)
    assert (fwd(d), bwd(d, 0), bwd(d, 1)) == (want["fwd"], want["dq"], want["dkdv"])


@pytest.mark.parametrize("r,c", [(50176, 512), (1031, 128), (1031, 640), (4097, 1024)])
def test_ln_bf16_kernels_match_plain(dev, r, c):
    """The bf16 LayerNorm forward and backward at R 50,176, C 512 (the
    blocks' rows at batch 64), a ragged count and the CTA-per-row widths:
    out and dx within 2 bf16 steps x scale, the f32 dgamma and dbeta within
    1e-5 x scale; a second call gives the same bits."""
    x, gamma, beta = (_bf16(t) for t in _ln_inputs(r, c, dev))
    dy = _bf16(_rand((r, c), 7, dev))
    before = (ln_cuda.bf16_launches, ln_cuda.bf16_bwd_launches)
    out = ln_cuda.ln_forward(x, gamma, beta, 1e-5)
    grads = ln_cuda.ln_backward(x, dy, gamma, 1e-5)
    again = (ln_cuda.ln_forward(x, gamma, beta, 1e-5), *ln_cuda.ln_backward(x, dy, gamma, 1e-5))
    torch.cuda.synchronize()
    assert (ln_cuda.bf16_launches, ln_cuda.bf16_bwd_launches) == (before[0] + 2, before[1] + 2)
    assert out.dtype == grads[0].dtype == torch.bfloat16 and grads[1].dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip((out, *grads), again))
    _assert_bf16(out.float(), ln_cuda.layernorm_forward_plain(x, gamma, beta, 1e-5).float(),
                BF16_TOL, "y")
    want = ln_cuda.layernorm_backward_plain(x, dy, gamma, 1e-5)
    for name, g, w, tol in zip(("dx", "dgamma", "dbeta"), grads, want,
                               (BF16_TOL, 1e-5, 1e-5)):
        _assert_bf16(g.float(), w.float(), tol, name)


@pytest.mark.parametrize("r,c", [(50176, 512), (1031, 128), (4097, 1024)])
def test_mlp_bf16_kernels_match_plain_and_routes_give_equal_bits(dev, r, c):
    """The bf16 MLP forward and its three backward routes at R 50,176, C 512
    (F 2048), a ragged count and C 1024: out, y and dx within 2 bf16 steps x
    scale of the plain versions, the f32 parameter sums within 5e-4 x scale
    (dy is rounded to bf16 for dW1 and dln, and the two sides' dy may round
    apart); the recompute and pipelined routes give the saved-y route's
    bits, and two calls give the same bits."""
    x, gamma, beta, w1, b1, w2, b2 = (_bf16(t) for t in _mlp_inputs(r, c, dev))
    dout = _bf16(_rand((r, c), 8, dev))
    counts = ("bf16_launches", "bf16_bwd_launches", "bf16_recompute_launches",
              "bf16_pipe_launches", "launches", "bwd_launches")
    before = [getattr(mlp_cuda, n) for n in counts]
    fwd = [mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5) for _ in range(2)]
    out, y = fwd[0]
    routes = {
        "saved": lambda: mlp_cuda.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, 1e-5),
        "recompute": lambda: mlp_cuda.ln_mlp_backward_recompute(x, dout, gamma, beta, w1, b1,
                                                                w2, 1e-5),
        "pipe": lambda: mlp_cuda.ln_mlp_backward_pipe(x, dout, y, gamma, beta, w1, b1, w2, 1e-5),
    }
    grads = {name: (fn(), fn()) for name, fn in routes.items()}
    torch.cuda.synchronize()
    assert [getattr(mlp_cuda, n) - b for n, b in zip(counts, before)] == [2, 2, 2, 2, 0, 0]
    assert out.dtype == y.dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    for name, (first, second) in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(first, second)), f"{name} twice"
        assert all(torch.equal(a, b) for a, b in zip(first, grads["saved"][0])), name
    want_out, want_y = mlp_cuda.ln_mlp_forward_plain(x, gamma, beta, w1, b1, w2, b2, 1e-5)
    _assert_bf16(out.float(), want_out.float(), BF16_TOL, "out")
    _assert_bf16(y.float(), want_y.float(), BF16_TOL, "y")
    want = mlp_cuda.ln_mlp_backward_plain(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, g, w in zip(names, grads["saved"][0], want):
        _assert_bf16(g.float(), w.float(), BF16_TOL if name == "dx" else 5e-4, name)


# The bf16 GEMM alone (csrc/gemm_wgmma_bf16.cuh, through the test entry of
# csrc/wgemm_check.cu): every layout, at ragged M, N and
# K with a short last part, against float64 within the bound of
# tests/test_torch_bf16.py's emulation of its sums (GEMM_RTOL, 1e-6 of the
# largest |product|; measured 1-3e-7 on an H100).
GEMM_RTOL = 1e-6


def _wgemm(a_mk, b_kn, at, bt, parts, k_split):
    """(error code, out (parts, M, N) f32) of the test entry on a (M, K) and
    b (K, N), stored M-contiguous if at and K-contiguous if bt."""
    import ctypes

    lib = mlp_cuda._build.load("wgemm_check")
    fn = mlp_cuda._build.declare(lib.wgemm_check, [ctypes.c_void_p, ctypes.c_int64,
                                                   ctypes.c_void_p, ctypes.c_int64,
                                                   ctypes.c_void_p] + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
    (m, k), n = a_mk.shape, b_kn.shape[1]
    a = (a_mk.t() if at else a_mk).contiguous()
    b = (b_kn.t() if bt else b_kn).contiguous()
    out = torch.full((parts, m, n), float("nan"), device=a.device)
    err = fn(a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1], out.data_ptr(), m, n, k,
             parts, k_split, at, bt, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err, out


@pytest.mark.parametrize("at,bt", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("m,n,k,parts,k_split", [(200, 136, 200, 2, 128), (1032, 264, 520, 3, 192),
                                                 (8, 8, 8, 1, 64), (136, 2048, 512, 1, 512)])
def test_bf16_gemm_layouts_hold_float64_and_give_equal_bits(dev, at, bt, m, n, k, parts,
                                                            k_split):
    """Each part's product within GEMM_RTOL x its largest magnitude of the
    float64 product of the same bf16 values (rows, columns and k past the
    tiles read as zeros; the last part shorter), every output written, two
    calls equal bit for bit."""
    gen = torch.Generator().manual_seed(m + n + k + at + 2 * bt)
    a = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
    b = torch.randn((k, n), generator=gen).to(dev, torch.bfloat16)
    err, out = _wgemm(a, b, at, bt, parts, k_split)
    err2, out2 = _wgemm(a, b, at, bt, parts, k_split)
    assert err == err2 == 0
    assert torch.equal(out, out2)
    for p in range(parts):
        ks = slice(p * k_split, min(k, (p + 1) * k_split))
        ref = a[:, ks].double() @ b[ks].double()
        got = out[p].double()
        assert not got.isnan().any()
        assert float((got - ref).abs().max()) <= GEMM_RTOL * float(ref.abs().max())


def test_bf16_gemm_refuses_what_it_does_not_take(dev):
    """k_split off the k-step, N off 8, or an M-contiguous A with M off 8:
    cudaErrorInvalidValue (1) before any launch, out untouched."""
    a = torch.randn((64, 64), device=dev).to(torch.bfloat16)
    err, out = _wgemm(a, a, 0, 0, 1, 96)  # k_split 96
    assert err == 1 and bool(out.isnan().all())
    err, _ = _wgemm(a, a[:, :60], 0, 0, 1, 64)  # N = 60
    assert err == 1
    err, _ = _wgemm(a[:60], a, 1, 0, 1, 64)  # M-contiguous A, M = 60
    assert err == 1


def test_bf16_gemm_plan_mirrors_the_kernel(dev):
    """test_torch_gemm_plan.SMEM and SMEM_TILE, which the CPU plan tests
    hold to the card's limit, are what the kernel asks for with a functor
    epilogue and with the tile-store one."""
    import ctypes

    from test_torch_gemm_plan import SMEM, SMEM_TILE

    fn = mlp_cuda._build.load("wgemm_check").wgemm_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert (fn(0), fn(1)) == (SMEM, SMEM_TILE)


def _wgemm_bias(a, ws, biases, outs):
    """The tile-store test entry: outs[i] = bf16(a ws[i] + biases[i]) for
    one or two outputs in one launch; returns its error code."""
    import ctypes

    lib = mlp_cuda._build.load("wgemm_check")
    fn = mlp_cuda._build.declare(lib.wgemm_bias_check, [ctypes.c_void_p, ctypes.c_int,
                                                        ctypes.c_int, ctypes.c_int]
                                 + ([ctypes.c_void_p] * 3 + [ctypes.c_int]) * 2
                                 + [ctypes.c_void_p])
    m, k = a.shape
    args = []
    for i in range(2):
        if i < len(ws):
            args += [ws[i].data_ptr(), biases[i].data_ptr(), outs[i].data_ptr(),
                     ws[i].shape[1]]
        else:
            args += [None, None, None, 0]
    err = fn(a.data_ptr(), m, k, len(ws), *args, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err


@pytest.mark.parametrize("m,k,widths", [(400, 512, (64, 128)), (1031, 64, (512, 1024)),
                                        (8, 8, (8,)), (257, 520, (136, 264)),
                                        (6272, 512, (512,))])
def test_bf16_gemm_tile_store_is_the_functor_epilogues_bits(dev, m, k, widths):
    """The tile-store epilogue (bias_products: the attention block's
    products, two outputs walked in one launch) writes bf16(f32 sum +
    bias), bit for bit the functor epilogue's f32 sums of the same product
    plus the bias, rounded once to nearest even; it writes nothing past an
    output's last row (a guard row stays NaN); two calls give the same
    bits."""
    gen = torch.Generator().manual_seed(m + k)
    a = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
    ws = [(torch.randn((k, n), generator=gen) / k ** 0.5).to(dev, torch.bfloat16)
          for n in widths]
    biases = [torch.randn((n,), generator=gen).to(dev, torch.bfloat16) for n in widths]
    guarded = [torch.full((m + 1, n), float("nan"), device=dev, dtype=torch.bfloat16)
               for n in widths]
    assert _wgemm_bias(a, ws, biases, guarded) == 0
    again = [torch.empty((m, n), device=dev, dtype=torch.bfloat16) for n in widths]
    assert _wgemm_bias(a, ws, biases, again) == 0
    k_split = -(-k // 64) * 64
    for w, bias, out, out2 in zip(ws, biases, guarded, again):
        err, sums = _wgemm(a, w, 0, 0, 1, k_split)
        assert err == 0
        want = (sums[0] + bias.float()).to(torch.bfloat16)
        assert torch.equal(out[:m], want) and torch.equal(out2, want)
        assert bool(out[m].isnan().all())


def test_bf16_wrappers_raise_before_launch(dev):
    """bf16 operands that a kernel does not take raise before any launch:
    strides or starts not on 8 values (16 bytes), C or F not a multiple of
    8, mixed types, a flash pair the bf16 mode does not take ((8, 8),
    ROADMAP queue B item 1; PixelSNAIL's (4, 32) is taken), VQ rows whose
    D is not a multiple of 8 and a fused block whose width is not."""
    before = (attention_cuda.bf16_launches, ln_cuda.bf16_launches, mlp_cuda.bf16_launches,
              vq_cuda.bf16_launches, attn_block_cuda.bf16_launches)
    q = _bf16(_rand((2, 64, 132), 0, dev))
    k, v = q[..., :128], q[..., 4:132]  # row stride 132, v 8 bytes past a boundary
    with pytest.raises(ValueError, match="multiples of 8"):
        attention_cuda.flash_forward(k, k, k, False, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_cuda.flash_forward(q[..., :128].contiguous(), k.contiguous(), v, False, 2)
    with pytest.raises(TypeError):
        attention_cuda.flash_forward(k.contiguous(), k.contiguous().float(), k.contiguous(),
                                     False, 2)
    with pytest.raises(TypeError, match="ROADMAP.md queue B item 1"):
        attention_cuda.flash_forward(_bf16(_rand((1, 64, 8), 1, dev)),
                                     _bf16(_rand((1, 64, 8), 2, dev)),
                                     _bf16(_rand((1, 64, 8), 3, dev)), True, 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        vq_cuda.vq_quantize_fused(_bf16(_rand((64, 12), 7, dev)), _rand((16, 12), 8, dev))
    with pytest.raises(ValueError, match="multiples of 8"):
        attn_block_cuda.attention_block_forward(
            *(_bf16(_rand(shape, 9, dev)) for shape in ((1, 64, 36), (36, 32), (32,), (36, 64),
                                                        (64,), (32, 36), (36,))), False, 1)
    x, gamma, beta, w1, b1, w2, b2 = (_bf16(t) for t in _mlp_inputs(64, 128, dev))
    with pytest.raises(ValueError, match="multiple of 8"):
        ln_cuda.ln_forward(_bf16(_rand((64, 132), 4, dev)), _bf16(_rand((132,), 5, dev)),
                           _bf16(_rand((132,), 6, dev)), 1e-5)
    with pytest.raises(TypeError):
        ln_cuda.ln_forward(x, gamma.float(), beta, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        mlp_cuda.ln_mlp_forward(x, gamma, beta, w1[:, :508].contiguous(), b1[:508],
                                w2[:508].contiguous(), b2, 1e-5)
    with pytest.raises(TypeError):
        mlp_cuda.ln_mlp_forward(x, gamma, beta, w1.float(), b1, w2, b2, 1e-5)
    torch.cuda.synchronize()
    assert (attention_cuda.bf16_launches, ln_cuda.bf16_launches, mlp_cuda.bf16_launches,
            vq_cuda.bf16_launches, attn_block_cuda.bf16_launches) == before


def test_large_config_bf16_train_step_runs_only_bf16_kernels(dev, tmp_path):
    """Trainer(compute_dtype=torch.bfloat16) on ImageGPT(**LARGE_CONFIG),
    one step at batch 2: every flash, LayerNorm and MLP launch is a bf16
    one (8 flash and MLP forwards and backwards, 9 LayerNorm), none is
    f32, and the parameters and their gradients stay float32."""
    model = ImageGPT(**image_gpt.LARGE_CONFIG,
                     generator=torch.Generator().manual_seed(0), device=dev)
    x = (torch.rand((2, 28, 28, 1), generator=torch.Generator().manual_seed(1)) < 0.3).float()
    t = trainer.Trainer(model, image_gpt.reproduce_loss, optim.adam(1e-3), [], [],
                        log_dir=str(tmp_path), use_tensorboard=False, device=dev,
                        compute_dtype=torch.bfloat16)
    mods = (attention_cuda, ln_cuda, mlp_cuda)
    for mod in mods:
        for name in dir(mod):
            if name.endswith("launches"):
                setattr(mod, name, 0)
    metrics, _ = t.train_one_step(x.numpy(), None)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["loss"]))
    counts = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
              for mod in mods for name in dir(mod) if name.endswith("launches")}
    want = {"attention_cuda.bf16_launches": 8, "attention_cuda.bf16_bwd_launches": 8,
            "ln_cuda.bf16_launches": 9, "ln_cuda.bf16_bwd_launches": 9,
            "mlp_cuda.bf16_launches": 8, "mlp_cuda.bf16_bwd_launches": 8}
    assert counts == {k: want.get(k, 0) for k in counts}
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


# The bf16 modes of PixelSNAIL's flash pairs (forward and backward on bf16
# mma.sync), of the VQ
# kernel and of the fused attention block.

@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [784, 200, 1])
@pytest.mark.parametrize("d_k,d_v", [(4, 32), (4, 8)])
def test_flash_bf16_simt_pairs_match_plain(dev, d_k, d_v, l, mask_center):
    """PixelSNAIL's pairs at B 128 (L 784; and ragged L), one head, k and v
    column views of one (B, L, d_k + d_v) kv tensor (v 8 bytes into each
    row): out, dq, dk, dv within 2 bf16 steps x scale, lse within 1e-6 x
    scale of the plain versions; two calls give the same bits; under
    mask_center row 0 gets out 0, lse -inf and dq 0."""
    b = 128 if l == 784 else 3
    q = _bf16(_rand((b, l, d_k), l, dev))
    kv = _bf16(_rand((b, l, d_k + d_v), l + 1, dev))
    dout = _bf16(_rand((b, l, d_v), l + 2, dev))
    k, v = kv[..., :d_k], kv[..., d_k:]
    before = (attention_cuda.bf16_launches, attention_cuda.bf16_bwd_launches,
              attention_cuda.launches, attention_cuda.bwd_launches)
    out, lse = attention_cuda.flash_forward(q, k, v, mask_center, 1)
    grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, 1)
    again = (*attention_cuda.flash_forward(q, k, v, mask_center, 1),
             *attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, 1))
    torch.cuda.synchronize()
    assert (attention_cuda.bf16_launches, attention_cuda.bf16_bwd_launches,
            attention_cuda.launches, attention_cuda.bwd_launches) == (
        before[0] + 2, before[1] + 2, before[2], before[3])
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    assert all(torch.equal(a, b_) for a, b_ in zip((out, lse, *grads), again))
    ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, 1)
    _assert_bf16(out, ref_out, BF16_TOL, "out")
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    if finite.any():  # L = 1 under mask_center has no key at all
        _assert_bf16(lse[finite], ref_lse[finite], 1e-6, "lse")
    ref = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center, 1)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        _assert_bf16(g, r, BF16_TOL, name)
    if mask_center:
        assert bool((out[:, 0] == 0).all()) and bool((grads[0][:, 0] == 0).all())
        assert bool(torch.isneginf(lse[:, :, 0]).all())


@pytest.mark.parametrize("m,k,d", [(8192, 512, 64), (8191, 512, 64), (300, 200, 256),
                                   (1001, 2000, 8), (5, 1, 16)])
def test_vq_bf16_kernel_equals_the_f32_kernel_on_widened_rows(dev, m, k, d):
    """bf16 rows beside an f32 codebook: the bf16 entry's codes, counts and
    sums equal, bit for bit, the f32 entry's on the rows widened to f32 (a
    bf16 row's 3xTF32 split is exact), and its quantized rows are that
    entry's rounded to bf16; the plain version agrees on every row."""
    x = _bf16(_rand((m, d), m, dev))
    cb = _rand((k, d), m + 1, dev)
    before = (vq_cuda.launches, vq_cuda.bf16_launches)
    qb, cb_counts, sb = vq_cuda.vq_quantize_fused(x, cb)
    qf, cf, sf = vq_cuda.vq_quantize_fused(x.float(), cb)
    torch.cuda.synchronize()
    assert (vq_cuda.launches, vq_cuda.bf16_launches) == (before[0] + 1, before[1] + 1)
    assert qb.dtype == torch.bfloat16 and cb_counts.dtype == sb.dtype == torch.float32
    assert torch.equal(qb, qf.to(torch.bfloat16))
    assert torch.equal(cb_counts, cf) and torch.equal(sb, sf)
    pq, pc, _ = vq_cuda.vq_quantize_plain(x, cb)
    assert torch.equal(qb, pq) and torch.equal(cb_counts, pc)


@pytest.mark.parametrize("d_k,d_v", [(4, 32), (4, 8)])
def test_flash_bf16_small_pairs_take_any_view(dev, d_k, d_v):
    """The (4, 32) / (4, 8) bf16 forward and backward read an operand whose
    start or strides are off 8 bytes 2 bytes a load, any other 8 bytes a
    load: on views 2 bytes off every boundary (q, k and v column views at
    odd offsets) they give the bits they give on contiguous copies of
    them."""
    b, l = 3, 200
    q = _bf16(_rand((b, l, d_k + 1), 5, dev))[..., 1:]
    kv = _bf16(_rand((b, l, d_k + d_v + 1), 6, dev))
    k, v = kv[..., 1:1 + d_k], kv[..., 1 + d_k:]
    dout = _bf16(_rand((b, l, d_v), 7, dev))
    dense = [t.contiguous() for t in (q, k, v)]
    out, lse = attention_cuda.flash_forward(*dense, True, 1)
    out_view, lse_view = attention_cuda.flash_forward(q, k, v, True, 1)
    got = attention_cuda.flash_backward(q, k, v, out, lse, dout, True, 1)
    want = attention_cuda.flash_backward(*dense, out, lse, dout, True, 1)
    torch.cuda.synchronize()
    assert torch.equal(out_view, out) and torch.equal(lse_view, lse)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    ref_out, _ = attention_cuda.flash_forward_plain(*dense, True, 1)
    _assert_bf16(out, ref_out, BF16_TOL, "out")
    ref = attention_cuda.flash_backward_plain(*dense, out, lse, dout, True, 1)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        _assert_bf16(g, r, BF16_TOL, name)


# The bf16 block's lse against the plain version's, as a share of the
# largest |lse|: the two round q and k to bf16 from f32 sums taken in other
# orders, so an element may land one bf16 step apart and move the scores.
BF16_BLOCK_LSE_RTOL = 1e-3


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [784, 200])
@pytest.mark.parametrize("c,n_heads", BLOCK_WIDTHS)
def test_attn_block_bf16_kernel_matches_plain(dev, c, n_heads, l, mask_center):
    """The block's bf16 entry (B 4): y, attn, q and kv within 2 bf16 steps x
    scale of the plain versions, lse within BF16_BLOCK_LSE_RTOL; the
    projection entry (the backward's recompute, which the forward's C entry
    runs on its own scratch) gives equal bits twice, and the forward's attn
    and lse agree with the plain attention on its q and kv at the flash
    kernels' gates (lse 1e-6); two calls give the same bits; under mask_center row 0
    of attn is 0 with lse -inf."""
    ops = [_bf16(t) for t in _block_inputs(4, l, c, dev, seed=l)]
    before = (attn_block_cuda.bf16_launches, attn_block_cuda.bf16_project_launches,
              attn_block_cuda.launches, attention_cuda.bf16_launches)
    y, attn, lse = attn_block_cuda.attention_block_forward(*ops, mask_center, n_heads)
    again = attn_block_cuda.attention_block_forward(*ops, mask_center, n_heads)
    q, kv = attn_block_cuda.project(*ops[:5])
    q2, kv2 = attn_block_cuda.project(*ops[:5])
    torch.cuda.synchronize()
    assert (attn_block_cuda.bf16_launches, attn_block_cuda.bf16_project_launches,
            attn_block_cuda.launches, attention_cuda.bf16_launches) == (
        before[0] + 2, before[1] + 2, before[2], before[3])
    assert torch.equal(q, q2) and torch.equal(kv, kv2)
    assert all(torch.equal(a, b_) for a, b_ in zip((y, attn, lse), again))
    on_q, on_lse = attention_cuda._flash_forward_bf16_plain(
        q, kv[..., :c], kv[..., c:], mask_center, n_heads, q2=False)
    _assert_bf16(attn, on_q, BF16_TOL, "attn on the recompute's q and kv")
    on_finite = torch.isfinite(on_lse)
    _assert_bf16(lse[on_finite], on_lse[on_finite], 1e-6, "lse on the recompute's q and kv")
    want = attn_block_cuda.attention_block_plain(*ops, mask_center, n_heads)
    _assert_bf16(y, want[0], BF16_TOL, "y")
    _assert_bf16(attn, want[1], BF16_TOL, "attn")
    finite = torch.isfinite(want[2])
    assert torch.equal(torch.isfinite(lse), finite)
    _assert_bf16(lse[finite], want[2][finite], BF16_BLOCK_LSE_RTOL, "lse")
    for name, got, ref in zip(("q", "kv"), (q, kv), attn_block_cuda.project_plain(*ops[:5])):
        _assert_bf16(got, ref, BF16_TOL, name)
    if mask_center:
        assert bool((attn[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all())


# SHA-256 of the bf16 block's outputs and of the fused MLP's bf16 outputs at
# fixed inputs, as the kernels gave them on an H100 before the block's
# products moved to the GEMM's tile-store epilogue and q and [k | v] into
# one launch: each output is still summed by one thread in k order, so
# every bit stays. Block cases (C, heads, mask_center) at B 2, L 200 (400
# rows: a ragged last 128-row tile; C 64's q half an n-tile): y, attn, lse
# and the projection entry's q and kv. MLP at R 4,097, C 512: the
# forward's out and y; the saved-y backward's seven gradients.
BF16_DIGESTS = {
    "block C64 H2 mask_center":
        "44d92ec3aa7122ec1139a8c81a05c060e53655d1f8317ffd1d3652fc4b64a11d",
    "block C512 H8":
        "b755cfd87a012b4a6c6cda85e6a5b8497557e8daf3451c199c23147fb3d90135",
    "block C512 H4 mask_center":
        "42ea6604d61d7a6d54c49f1a67236ce4219a38617ba2e0b2fb78896efe961960",
    "mlp C512 forward":
        "6cf99f526ae3364a2d38d1227afbd2bf6b9f953b02eb33f761f28c460fc9a3d0",
    "mlp C512 backward":
        "b7bb8ae69104a8e75e8d690eab83075747f2a1ff32469440badabf078c9c026c",
}


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


def _bf16_case_outputs(case, dev):
    """The outputs BF16_DIGESTS holds for one case, from inputs made from
    fixed seeds."""
    if case.startswith("block"):
        _, c, h, *mc = case.split()
        c, n_heads = int(c[1:]), int(h[1:])
        ops = [_bf16(t) for t in _block_inputs(2, 200, c, dev, seed=c + n_heads)]
        y, attn, lse = attn_block_cuda.attention_block_forward(*ops, bool(mc), n_heads)
        return (y, attn, lse, *attn_block_cuda.project(*ops[:5]))
    r, c = 4097, 512
    x, gamma, beta, w1, b1, w2, b2 = (_bf16(t) for t in _mlp_inputs(r, c, dev, seed=5))
    out, y = mlp_cuda.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, 1e-5)
    if case.endswith("forward"):
        return out, y
    dout = _bf16(_rand((r, c), 11, dev))
    return mlp_cuda.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, 1e-5)


def _graph_kernels(fn):
    """The kernel launches of one call of fn: the kernel nodes of a CUDA
    graph captured from it."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    rt = ctypes.CDLL("libcudart.so.12")
    graph, count = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(graph, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds.count(0)  # cudaGraphNodeTypeKernel


@pytest.mark.parametrize("c,n_heads", BLOCK_WIDTHS)
def test_bf16_block_is_three_launches_and_its_recompute_one(dev, c, n_heads):
    """The bf16 block's forward launches 3 kernels (q and [k | v] in one
    product, the attention, the output projection) and its projection
    entry, the backward's recompute, 1."""
    ops = [_bf16(t) for t in _block_inputs(2, 200, c, dev)]
    assert _graph_kernels(lambda: attn_block_cuda.attention_block_forward(*ops, False,
                                                                          n_heads)) == 3
    assert _graph_kernels(lambda: attn_block_cuda.project(*ops[:5])) == 1


@pytest.mark.parametrize("case", list(BF16_DIGESTS))
def test_bf16_block_and_mlp_outputs_keep_their_bits(dev, case):
    digest = _digest(*_bf16_case_outputs(case, dev))
    assert digest == BF16_DIGESTS[case], f"{case}: {digest}"


def _zero_counts(*mods):
    for mod in mods:
        for name in dir(mod):
            if name.endswith("launches"):
                setattr(mod, name, 0)


def _counts(*mods):
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
            for mod in mods for name in dir(mod) if name.endswith("launches")}


def test_bf16_steps_run_the_new_modes(dev, tmp_path, monkeypatch):
    """One Trainer(compute_dtype=torch.bfloat16) step at batch 2 of each
    path: PixelSNAIL (reproduce() widths, 2 blocks) through the flash
    kernels' bf16 mode at (4, 32); the VQ-VAE with PGT_FUSED_VQ=1 through
    the bf16 VQ entry (1 a step) and without it through none; ImageGPT
    with PGT_FUSED_ATTN=1 through the bf16 block (1 a block), its
    projection recompute and the bf16 flash backward. No f32 kernel of
    these modules launches; losses are finite; parameters and gradients
    stay float32."""
    mods = (attention_cuda, attn_block_cuda, vq_cuda)
    gen = lambda: torch.Generator().manual_seed(0)
    img = (torch.rand((2, 28, 28, 1), generator=gen()) < 0.3).float().numpy()
    cifar = torch.rand((2, 32, 32, 3), generator=gen()).numpy()

    def step(model, loss_fn, x):
        t = trainer.Trainer(model, loss_fn, optim.adam(1e-3), [], [], log_dir=str(tmp_path),
                            use_tensorboard=False, device=dev, compute_dtype=torch.bfloat16)
        _zero_counts(*mods)
        metrics, _ = t.train_one_step(x, None)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(metrics["loss"]))
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        counts = _counts(*mods)
        return {k_: v_ for k_, v_ in counts.items() if v_}

    from pytorch_generative_tpu_torch.models.autoregressive import pixel_snail
    from pytorch_generative_tpu_torch.models.vae import vq_vae
    snail = PixelSNAIL(**dict(pixel_snail.REPRODUCE_CONFIG, n_pixel_snail_blocks=2),
                       generator=gen(), device=dev)
    assert step(snail, pixel_snail.reproduce_loss, img) == {
        "attention_cuda.bf16_launches": 2, "attention_cuda.bf16_bwd_launches": 2}
    for env, want in (("1", {"vq_cuda.bf16_launches": 1}), ("0", {})):
        monkeypatch.setenv("PGT_FUSED_VQ", env)
        vae = VectorQuantizedVAE(**vq_vae.REPRODUCE_CONFIG, generator=gen(), device=dev)
        assert step(vae, vq_vae.reproduce_loss, cifar) == want
    monkeypatch.setenv("PGT_FUSED_ATTN", "1")
    igpt = ImageGPT(**image_gpt.REPRODUCE_CONFIG, generator=gen(), device=dev)
    n = image_gpt.REPRODUCE_CONFIG["n_transformer_blocks"]
    assert step(igpt, image_gpt.reproduce_loss, img) == {
        "attn_block_cuda.bf16_launches": n, "attn_block_cuda.bf16_project_launches": n,
        "attention_cuda.bf16_bwd_launches": n}

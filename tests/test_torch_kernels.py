"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it is marked ``cuda`` and skips without
one (decided in a fixture, never at import). This file imports no JAX; on the
card run it as

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytorch_generative_tpu_torch import optim, trainer  # noqa: E402
from pytorch_generative_tpu_torch.models import ImageGPT  # noqa: E402
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt  # noqa: E402
from pytorch_generative_tpu_torch.ops import attention_cuda, decode_cuda, sampling  # noqa: E402
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


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 200, 784])
@pytest.mark.parametrize("d", list(attention_cuda.HEAD_DIMS))
def test_flash_kernel_matches_plain(dev, mask_center, l, d):
    """out and lse within 5e-5 of the dense version (f32, another summation
    order); k/v as feature slices of one packed kv tensor."""
    n_heads = 2
    q = _rand((3, l, n_heads * d), l + d, dev)
    kv = _rand((3, l, 2 * n_heads * d), l + d + 1, dev)
    k, v = kv[..., : n_heads * d], kv[..., n_heads * d:]
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
    with pytest.raises(ValueError):
        attention_cuda.flash_forward(q, q, q, False, 8)  # head dim 8
    with pytest.raises(ValueError):
        attention_cuda.flash_forward(q, q.cpu(), q, False, 2)
    with pytest.raises(ValueError):
        attention_cuda.flash_forward(q, q.transpose(0, 1).contiguous().transpose(0, 1),
                                     q, False, 2)


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


def test_model_on_cuda_runs_the_kernels(dev):
    """forward and sample on CUDA go through both kernels; the forward agrees
    with the plain CPU forward within 1e-4."""
    model = _model(dev, blocks=2, size=12)
    x = (_rand((2, 12, 12, 1), 5, dev) > 0).float()
    attention_cuda.launches = 0
    decode_cuda.launches = 0
    with torch.no_grad():
        logits = model(x)
        samples = model.sample(n_samples=3, generator=torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    assert attention_cuda.launches == 2 and decode_cuda.launches == 1
    assert samples.shape == (3, 12, 12, 1)
    assert bool(((samples == 0) | (samples == 1)).all())
    cpu = ImageGPT(in_channels=1, out_channels=1, in_size=12, n_transformer_blocks=2,
                   n_attention_heads=2, n_embedding_channels=32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        torch.testing.assert_close(logits.cpu(), cpu(x.cpu()), rtol=0, atol=1e-4)


def test_ineligible_model_raises_on_cuda(dev):
    """The CUDA sampler does not silently take the plain decoder."""
    model = _model(dev)
    model.sample_fn = lambda u, logits: (u < torch.sigmoid(logits)).float()
    assert not sampling._whole_loop_eligible(model)
    with pytest.raises(NotImplementedError):
        model.sample(n_samples=2)


# Backward tolerance: f32, each gradient a sum over up to 784 rows or keys
# taken in another order than the dense einsum's.
BWD_TOL = 1e-4


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 200, 784])
@pytest.mark.parametrize("d", list(attention_cuda.HEAD_DIMS))
def test_flash_backward_kernel_matches_plain(dev, mask_center, l, d):
    """dq, dk, dv within BWD_TOL of the plain backward on the same saved out
    and lse; row 0 under mask_center gets an exactly-zero dq."""
    n_heads = 2
    q = _rand((3, l, n_heads * d), l + d, dev)
    kv = _rand((3, l, 2 * n_heads * d), l + d + 1, dev)
    k, v = kv[..., : n_heads * d], kv[..., n_heads * d:]
    dout = _rand((3, l, n_heads * d), l + d + 2, dev)
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

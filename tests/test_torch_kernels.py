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

from pytorch_generative_tpu_torch.models import ImageGPT  # noqa: E402
from pytorch_generative_tpu_torch.ops import attention_cuda, decode_cuda, sampling  # noqa: E402

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
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape,
                                          generator=torch.Generator().manual_seed(seed + 1)))
    return model.to(dev).eval()


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
                   n_attention_heads=2, n_embedding_channels=32)
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


def test_flash_backward_is_not_ported(dev):
    q = _rand((1, 64, 64), 7, dev).requires_grad_()
    out = attention_cuda.causal_attention_packed(q, q, q, False, 2)
    with pytest.raises(NotImplementedError, match="_bwd_fused_kernel"):
        out.sum().backward()

"""The JAX package's six route switches in the port: each is honoured or
raises a ValueError before any work (CPU, tiny shapes).

- ``PGT_FUSED_MLP`` ("1" / "0") forces the fused LayerNorm -> MLP kernels
  on or off when a block is built; "1" at a width the kernels do not take
  raises.
- ``PGT_FUSED_LN`` ("1" / "0") does the same for ``ChannelLayerNorm`` at
  every call; its >= 1024-row and C >= 8 terms stay.
- ``PGT_SAMPLE_LOOP=0`` sends ImageGPT to the step route; PixelSNAIL, which
  the JAX package then sends to its XLA scan, raises.
- ``PGT_NO_FLASH=1``, ``PGT_NO_FUSED_DECODE=1`` and
  ``PGT_FLASH_PRECISION=default`` ask for routes the port does not have,
  and raise.
"""

import pytest
import torch

from pytorch_generative_tpu_torch.models import ImageGPT, PixelSNAIL
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
from pytorch_generative_tpu_torch.nn import CausalAttention, ChannelLayerNorm
from pytorch_generative_tpu_torch.ops import (attention_cuda, attn_block_cuda, ln_cuda, mlp_cuda,
                                              sampling)

SWITCHES = ("PGT_FUSED_MLP", "PGT_FUSED_LN", "PGT_SAMPLE_LOOP", "PGT_NO_FLASH",
            "PGT_NO_FUSED_DECODE", "PGT_FLASH_PRECISION")
TINY_GPT = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=1,
                n_attention_heads=2, n_embedding_channels=32, in_shape=(8, 8, 1))
TINY_SNAIL = dict(n_channels=8, n_pixel_snail_blocks=1, n_residual_blocks=1,
                  attention_value_channels=8, in_shape=(4, 4, 1))


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)


def _spy(monkeypatch, module, name):
    """Counts the calls of ``module.name`` (still running it)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _gpt(channels=32, heads=2):
    return ImageGPT(**dict(TINY_GPT, n_embedding_channels=channels, n_attention_heads=heads),
                    generator=torch.Generator().manual_seed(0), device="cpu")


def _qkv(dtype, b=1, l=16, c=32):
    gen = torch.Generator().manual_seed(1)
    return [torch.randn((b, l, c), generator=gen).to(dtype) for _ in range(4)]


def test_no_switch_keeps_the_routes(monkeypatch):
    """With none of the six set, every route is as before."""
    assert not image_gpt._fused_kernels(64) and image_gpt._fused_kernels(128)
    assert sampling.sample_route(_gpt(), 16) == sampling.LOOP_ROUTE
    assert sampling.sample_route(_gpt(), 16, torch.bfloat16) == sampling.STEP_ROUTE
    snail = PixelSNAIL(**TINY_SNAIL, device="cpu")
    assert sampling.pixel_snail_sample_route(snail, 4) == sampling.LOOP_ROUTE
    fused = _spy(monkeypatch, ln_cuda, "channel_layernorm")
    ChannelLayerNorm(8, fused=True)(torch.randn(1024, 8))
    ChannelLayerNorm(8)(torch.randn(1024, 8))
    assert fused == ["channel_layernorm"]
    q, k, v, dout = _qkv(torch.float32)
    out, lse = attention_cuda.flash_forward(q, k, v, False, 2)
    attention_cuda.flash_backward(q, k, v, out, lse, dout, False, 2)


@pytest.mark.parametrize("env,channels,fused", [("1", 32, True), ("0", 128, False),
                                                ("yes", 128, False)])
def test_fused_mlp_switch_forces_the_kernels(monkeypatch, env, channels, fused):
    """PGT_FUSED_MLP=1 fuses a C = 32 block (the plain versions here run the
    kernels' Functions), any other value unfuses a C = 128 one; read when
    the model is built, as the JAX package reads it."""
    monkeypatch.setenv("PGT_FUSED_MLP", env)
    model = _gpt(channels)
    monkeypatch.delenv("PGT_FUSED_MLP")
    calls = _spy(monkeypatch, mlp_cuda, "ln_mlp_residual")
    assert model.blocks[0].use_fused_mlp is fused and model.ln.fused is fused
    assert model.blocks[0].ln1.fused is fused
    model(torch.zeros((2, 8, 8, 1)))
    assert calls == (["ln_mlp_residual"] if fused else [])


@pytest.mark.parametrize("channels", [30, 4100])
def test_fused_mlp_switch_raises_at_widths_the_kernels_do_not_take(monkeypatch, channels):
    monkeypatch.setenv("PGT_FUSED_MLP", "1")
    with pytest.raises(ValueError, match=f"C = {channels}"):
        image_gpt._fused_kernels(channels)


@pytest.mark.parametrize("env,fused,rows,want", [("1", False, 1024, True),
                                                 ("0", True, 1024, False),
                                                 ("1", False, 1023, False)])
def test_fused_ln_switch_forces_the_kernel(monkeypatch, env, fused, rows, want):
    """PGT_FUSED_LN, read at every call, overrides ``fused``; fewer than
    1024 rows stay unfused."""
    calls = _spy(monkeypatch, ln_cuda, "channel_layernorm")
    ln = ChannelLayerNorm(8, fused=fused)
    monkeypatch.setenv("PGT_FUSED_LN", env)
    x = torch.randn(rows, 8)
    torch.testing.assert_close(ln(x), (x - x.mean(-1, keepdim=True))
                               / torch.sqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-5))
    assert calls == (["channel_layernorm"] if want else [])


def test_sample_loop_switch_takes_the_step_route(monkeypatch):
    """PGT_SAMPLE_LOOP=0: ImageGPT's step route (row 3's kernel serves, as in
    the JAX package); PixelSNAIL, which the JAX package then sends to its
    XLA scan, raises before sampling; other values keep the loop."""
    model, snail = _gpt(), PixelSNAIL(**TINY_SNAIL, device="cpu")
    monkeypatch.setenv("PGT_SAMPLE_LOOP", "0")
    assert sampling.sample_route(model, 16) == sampling.STEP_ROUTE
    decodes = _spy(monkeypatch, sampling, "pixel_snail_sample_fast")
    for fn in (lambda: sampling.pixel_snail_sample_route(snail, 4),
               lambda: snail.sample(n_samples=2)):
        with pytest.raises(ValueError, match="A.13"):
            fn()
    assert decodes == []
    monkeypatch.setenv("PGT_SAMPLE_LOOP", "1")
    assert sampling.sample_route(model, 16) == sampling.LOOP_ROUTE
    assert sampling.pixel_snail_sample_route(snail, 4) == sampling.LOOP_ROUTE


def test_no_fused_decode_raises_before_sampling(monkeypatch):
    model, snail = _gpt(), PixelSNAIL(**TINY_SNAIL, device="cpu")
    monkeypatch.setenv("PGT_NO_FUSED_DECODE", "1")
    steps = _spy(monkeypatch, sampling, "_image_gpt_decode_step")
    for fn in (lambda: sampling.sample_route(model, 16),
               lambda: model.sample(n_samples=2),
               lambda: sampling.pixel_snail_sample_route(snail, 4),
               lambda: snail.sample(n_samples=2)):
        with pytest.raises(ValueError, match="A.13"):
            fn()
    assert steps == []


def test_no_flash_raises_when_the_layer_is_built(monkeypatch):
    monkeypatch.setenv("PGT_NO_FLASH", "1")
    with pytest.raises(ValueError, match="A.3"):
        CausalAttention(8, n_heads=2)
    with pytest.raises(ValueError, match="A.3"):
        _gpt()
    monkeypatch.setenv("PGT_NO_FLASH", "0")
    CausalAttention(8, n_heads=2)


@pytest.mark.parametrize("backward", [False, True])
def test_flash_precision_default_raises_for_f32(monkeypatch, backward):
    """PGT_FLASH_PRECISION=default, read at every call: f32 operands raise
    (the bf16-product f32 mode is queue B item 1's), in the fused block
    too; bf16 operands, which the JAX package leaves unchanged, run;
    "highest" runs."""
    q, k, v, dout = _qkv(torch.float32)
    out, lse = attention_cuda.flash_forward(q, k, v, False, 2)
    monkeypatch.setenv("PGT_FLASH_PRECISION", "default")
    plain = _spy(monkeypatch, attention_cuda, "flash_backward_plain" if backward
                 else "flash_forward_plain")
    with pytest.raises(ValueError, match="queue B item 1"):
        if backward:
            attention_cuda.flash_backward(q, k, v, out, lse, dout, False, 2)
        else:
            attention_cuda.flash_forward(q, k, v, False, 2)
    assert plain == []
    if backward:
        # The fused block, whose backward runs the flash backward: it raises
        # before its forward's work when it will be differentiated, and runs
        # when it will not (the JAX block reads the switch in its backward).
        gen = torch.Generator().manual_seed(2)
        x = torch.randn((1, 16, 32), generator=gen, requires_grad=True)
        weights = [torch.randn(shape, generator=gen) * 0.1
                   for shape in ((32, 32), (32,), (32, 64), (64,), (32, 32), (32,))]
        block = _spy(monkeypatch, attn_block_cuda, "attention_block_forward")
        with pytest.raises(ValueError, match="queue B item 1"):
            attn_block_cuda.attention_block_packed(x, *weights, False, 2)
        assert block == []
        with torch.no_grad():
            attn_block_cuda.attention_block_packed(x, *weights, False, 2)
        assert block == ["attention_block_forward"]
    qb, kb, vb, db = _qkv(torch.bfloat16)
    ob, lb = attention_cuda.flash_forward(qb, kb, vb, False, 2)
    attention_cuda.flash_backward(qb, kb, vb, ob, lb, db, False, 2)
    monkeypatch.setenv("PGT_FLASH_PRECISION", "highest")
    attention_cuda.flash_forward(q, k, v, False, 2)

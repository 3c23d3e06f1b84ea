"""The PyTorch port's ops and layers against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages in float32. Where
the JAX side reaches a Pallas kernel it runs in interpret mode, as
tests/test_kernels.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_generative_tpu import nn as jnn
from pytorch_generative_tpu.ops import attention_pallas
from pytorch_generative_tpu.ops import masks as jmasks
from pytorch_generative_tpu_torch import convert
from pytorch_generative_tpu_torch import nn as tnn
from pytorch_generative_tpu_torch.ops import attention_cuda
from pytorch_generative_tpu_torch.ops import masks as tmasks


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(module):
    leaves, _ = jax.tree_util.tree_flatten_with_path(module)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.mark.parametrize("mask_center", [False, True])
def test_masks_match_jax(mask_center):
    """Conv mask (HWIO there, OIHW here) and attention mask: exact."""
    for size in [(3, 3), (5, 5), (3, 5)]:
        jm = np.asarray(jmasks.causal_conv_mask(size, mask_center))
        tm = tmasks.causal_conv_mask(size, mask_center).numpy()
        np.testing.assert_array_equal(tm, jm.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        tmasks.causal_attention_mask(37, mask_center).numpy(),
        jmasks.causal_attention_mask(37, mask_center))


@pytest.mark.parametrize("mask_center", [False, True])
def test_causal_conv2d_matches_jax(mask_center):
    """Type-A/B 3x3 CausalConv2d through the weight bridge: the masked weights
    are equal exactly; outputs within atol 1e-6 (XLA and oneDNN sum the 9
    taps in another order, 1 ulp apart)."""
    jconv = jnn.CausalConv2d(jax.random.PRNGKey(3), mask_center, 1, 8, 3,
                             padding=1)
    tconv = tnn.CausalConv2d(mask_center, 1, 8, 3, padding=1)
    tconv.load_state_dict(convert.from_jax_params(_flat(jconv)))
    x = np.random.default_rng(0).standard_normal((2, 6, 7, 1)).astype(np.float32)
    want = np.asarray(jconv(jnp.asarray(x)))
    with torch.no_grad():
        got = tconv(torch.from_numpy(x)).numpy()
        masked = (tconv.weight * tconv.mask).numpy()
    np.testing.assert_array_equal(
        masked, np.asarray(jconv.weight * jconv.mask).transpose(3, 2, 0, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_layernorm_and_pointwise_conv_match_jax():
    """ChannelLayerNorm and a 1x1 Conv2d (x @ W + b): atol 1e-6 (f32 dot
    order over 16 channels)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jconv = jnn.Conv2d(jax.random.PRNGKey(4), 16, 24, 1)
    tconv = tnn.Conv2d(16, 24, 1)
    tconv.load_state_dict(convert.from_jax_params(_flat(jconv)))
    jln = jnn.ChannelLayerNorm(16).replace(
        scale=jnp.asarray(rng.standard_normal(16), jnp.float32),
        offset=jnp.asarray(rng.standard_normal(16), jnp.float32))
    tln = tnn.ChannelLayerNorm(16)
    tln.load_state_dict(convert.from_jax_params(_flat(jln)))
    with torch.no_grad():
        got_conv = tconv(torch.from_numpy(x)).numpy()
        got_ln = tln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_conv, np.asarray(jconv(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(got_ln, np.asarray(jln(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 200])
def test_flash_plain_matches_jax_kernel(monkeypatch, mask_center, l):
    """The flash kernel's plain version against the JAX Pallas forward in
    interpret mode: out and lse, atol 2e-5 (another summation order)."""
    monkeypatch.setattr(attention_pallas, "_INTERPRET", True)
    n_heads, d = 2, 8
    rng = np.random.default_rng(l)
    q, k, v = (rng.standard_normal((2, l, n_heads * d)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = attention_pallas.causal_attention_packed(jq, jk, jv, mask_center,
                                                    n_heads)
    _, jlse = attention_pallas._flash_forward(
        jq, jk, jv, n_heads, mask_center, attention_pallas.DEFAULT_BLOCK_Q,
        attention_pallas.DEFAULT_BLOCK_K, True)
    jlse = np.asarray(jlse)[:, :, :l, 0]                   # (B, H, L)

    before = attention_cuda.launches
    out, lse = attention_cuda.flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask_center, n_heads)
    assert attention_cuda.launches == before  # CPU tensors never launch
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=2e-5)
    if mask_center:
        np.testing.assert_array_equal(out[:, 0].numpy(), 0.0)
        assert np.all(np.isneginf(lse[:, :, 0].numpy()))


def test_flash_wrapper_takes_sliced_kv_and_rejects_other_devices():
    """k/v may be feature slices of one packed kv tensor (the layer's
    layout); a tensor on a device without a kernel raises."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 9, 8)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    out = attention_cuda.causal_attention_packed(q, kv[..., :8], kv[..., 8:],
                                                 False, 2)
    want = attention_cuda.flash_forward_plain(
        q, kv[..., :8].contiguous(), kv[..., 8:].contiguous(), False, 2)[0]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    meta = torch.empty((2, 9, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention_cuda.flash_forward(meta, meta, meta, False, 2)


@pytest.mark.parametrize("mask_center", [False, True])
def test_causal_attention_layer_matches_jax(mask_center):
    """CausalAttention with extra_x (PixelSNAIL's k/v conditioning) on NHWC
    input, dense JAX path: atol 1e-5."""
    jattn = jnn.CausalAttention(jax.random.PRNGKey(6), 8, n_heads=2,
                                embed_channels=16, out_channels=8,
                                mask_center=mask_center,
                                extra_input_channels=3, use_flash=False)
    tattn = tnn.CausalAttention(8, n_heads=2, embed_channels=16,
                                out_channels=8, mask_center=mask_center,
                                extra_input_channels=3)
    tattn.load_state_dict(convert.from_jax_params(_flat(jattn)))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    extra = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    want = np.asarray(jattn(jnp.asarray(x), jnp.asarray(extra)))
    with torch.no_grad():
        got = tattn(torch.from_numpy(x), torch.from_numpy(extra)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

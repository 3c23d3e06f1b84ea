"""Mixed-precision training (``Trainer(compute_dtype=torch.bfloat16)``) of
the three paths whose bf16 modes this file covers, against the JAX
package's Trainer with ``compute_dtype=jnp.bfloat16``, on the CPU: a tiny
PixelSNAIL (attention d_k 4 / d_v 8, the flash kernels' small pair), a tiny
VQ-VAE (EMA quantizer on its unfused and its fused route, bf16 rows beside
the f32 codebook) and a tiny ImageGPT with the fused attention block
(``PGT_FUSED_ATTN=1`` on both sides).

Weights are drawn by the port from a seed and filled into each JAX model's
tree (built by ``jax.eval_shape``, which runs none of JAX's initialisers);
batches come from numpy seeds; the JAX Pallas kernels run in interpret
mode. The gates are tests/test_torch_bf16_train.py's: 3 Adam steps, losses
within LOSS_RTOL, each parameter tensor's update within UPDATE_RL2 relative
L2 of the JAX update (bf16 activations round at other places in the two
frameworks' plain ops, and Adam turns a small gradient's flipped sign into
a step of about lr the other way), the key bias (an exactly-zero gradient)
within KEY_BIAS_ATOL; the VQ-VAE's f32 EMA buffers, whose updates follow
the same codes and rows, are held to UPDATE_RL2 as well.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_generative_tpu import core as jcore
from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu import optim as joptim
from pytorch_generative_tpu import trainer as jtrainer
from pytorch_generative_tpu.ops import attention_pallas, attn_block_pallas, vq_pallas
from pytorch_generative_tpu_torch import convert, optim, trainer
from pytorch_generative_tpu_torch.models import ImageGPT, PixelSNAIL, VectorQuantizedVAE
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt, pixel_snail
from pytorch_generative_tpu_torch.models.vae import vq_vae
from pytorch_generative_tpu_torch.ops import attn_block_cuda

LR = 5e-3
LOSS_RTOL = 1e-2
UPDATE_RL2 = 0.35
KEY_BIAS_ATOL = 3 * 2 * LR

SNAIL = dict(in_channels=1, out_channels=1, n_channels=16, n_pixel_snail_blocks=2,
             n_residual_blocks=1, attention_key_channels=4, attention_value_channels=8,
             in_shape=(8, 8, 1))
VAE = dict(in_channels=3, out_channels=3, hidden_channels=16, residual_channels=8,
           n_residual_blocks=1, n_embeddings=16, embedding_dim=8, in_shape=(8, 8, 3))
GATED = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=2,
             n_attention_heads=2, n_embedding_channels=64, in_shape=(8, 8, 1))


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


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _models(jctor, tctor, config, seed, **tkw):
    """(JAX model, port model) with the same weights: drawn by the port
    from a seed (a non-zero ImageGPT positional embedding too) and filled
    into the JAX model's tree (OIHW and (in, out, kh, kw) weights reverse
    their axes, 1x1 (in, out) weights gain two unit axes, the zero-size EMA
    placeholder stays empty); the port model under test is loaded from
    that tree through convert.from_jax_params."""
    drawn = tctor(**config, generator=torch.Generator().manual_seed(seed), device="cpu",
                  **tkw).state_dict()
    if "pos" in drawn:
        drawn["pos"] = 0.1 * torch.randn(drawn["pos"].shape,
                                         generator=torch.Generator().manual_seed(seed + 1))
    skeleton = jax.eval_shape(functools.partial(jctor, **config), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(skeleton)
    values = []
    for path, leaf in leaves:
        if 0 in leaf.shape:
            values.append(jnp.zeros(leaf.shape, leaf.dtype))
            continue
        key = convert._key(jax.tree_util.keystr(path))
        t = drawn[key].numpy()
        if key != "pos" and t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
        elif len(leaf.shape) == 4 and t.ndim == 2:
            t = t[None, None]
        assert t.shape == leaf.shape, (path, t.shape, leaf.shape)
        values.append(jnp.asarray(t))
    jm = jax.tree_util.tree_unflatten(treedef, values)
    tm = tctor(**config, device="cpu", **tkw)
    tm.load_state_dict(convert.from_jax_params(_flat(jm)))
    return jm, tm


def _records(log_dir, tag):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag and "train" in rec:
                out[rec["step"]] = rec["train"]
    return out


def _bce(x, _, preds):
    n = x.shape[0]
    return optax.sigmoid_binary_cross_entropy(
        preds.reshape(n, -1), x.reshape(n, -1)).sum(axis=1).mean()


def _vae_loss(x, _, preds):
    preds, vq_loss = preds
    recon = jnp.mean((preds - x) ** 2)
    return {"vq_loss": vq_loss, "reconstruction_loss": recon, "loss": recon + vq_loss}


def _binary(n, shape, seed):
    return (np.random.default_rng(seed).random((n, *shape)) < 0.3).astype(np.float32)


def _trajectories(tmp_path, jm, jloss, tm, tloss, batches):
    """3 steps of each Trainer at bf16 from the same weights and batches:
    (the port's trainer, the JAX trainer, the port's initial tensors)."""
    init = {k: v.detach().double().clone() for k, v in tm.state_dict().items()}
    kw = dict(train_loader=[(b, None) for b in batches], eval_loader=[], sample_epochs=None,
              use_tensorboard=False)
    jt = jtrainer.Trainer(model=jm, loss_fn=jloss, log_dir=str(tmp_path / "jax"),
                          optimizer=joptim.adam_multiplicative(LR, 0.999977),
                          compute_dtype=jnp.bfloat16, **kw)
    jt.interleaved_train_and_eval(1)
    tt = trainer.Trainer(model=tm, loss_fn=tloss, log_dir=str(tmp_path / "torch"),
                         optimizer=optim.adam_multiplicative(LR, 0.999977),
                         compute_dtype=torch.bfloat16, device="cpu", **kw)
    tt.interleaved_train_and_eval(1)
    return tt, jt, init


def _assert_trajectory(tt, jt, init, key_bias=None, buffers=()):
    """Losses within LOSS_RTOL; each parameter's update (and each named
    buffer's change) within UPDATE_RL2 relative L2 of the JAX one; the
    first n entries of every bias named like key_bias[0] within
    KEY_BIAS_ATOL. Master weights, gradients and buffers stay float32."""
    want, got = _records(jt.log_dir, "metrics/loss"), _records(tt.log_dir, "metrics/loss")
    assert sorted(got) == sorted(want) == [0, 1, 2]
    np.testing.assert_allclose([got[s] for s in range(3)], [want[s] for s in range(3)],
                               rtol=LOSS_RTOL)
    want = convert.from_jax_params(_flat(jt.model))
    tensors = {**dict(tt.model.named_parameters()),
               **{n: b for n, b in tt.model.named_buffers() if n in buffers}}
    assert all(n in tensors for n in buffers)
    for name, t in tensors.items():
        assert t.dtype == torch.float32, name
        got_, ref, start = t.detach().double(), want[name].double(), init[name]
        if key_bias and name.endswith(key_bias[0]):
            n = key_bias[1]
            np.testing.assert_allclose(got_[:n], ref[:n], rtol=0, atol=KEY_BIAS_ATOL)
            got_, ref, start = got_[n:], ref[n:], start[n:]
        rl2 = float((got_ - ref).norm() / (ref - start).norm())
        assert rl2 <= UPDATE_RL2, f"{name}: the update's relative L2 error {rl2:.3e}"


def test_bf16_pixel_snail_trajectory_matches_jax(interpret, tmp_path):
    """PixelSNAIL (C 16, 2 blocks of 1 residual block, attention d_k 4 /
    d_v 8 with mask_center, the JAX side on its flash kernels), batch 4 of
    8x8 images: its attention runs the flash kernels' bf16 mode at (4, 8),
    every other layer in bf16 (the positional channels in the residual's
    type), and 3 bf16 steps follow the JAX Trainer's."""
    jm, tm = _models(jmodels.PixelSNAIL, PixelSNAIL, SNAIL, seed=0)
    jm = jm.replace(pixel_snail_blocks=tuple(
        b.replace(attention=b.attention.replace(use_flash=True)) for b in jm.pixel_snail_blocks))
    batches = [_binary(4, (8, 8, 1), seed=30 + i) for i in range(3)]
    tt, jt, init = _trajectories(tmp_path, jm, _bce, tm, pixel_snail.reproduce_loss, batches)
    _assert_trajectory(tt, jt, init, key_bias=("attention.kv_proj.bias", 4))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_vq_vae_trajectory_matches_jax(interpret, tmp_path, fused):
    """VQ-VAE (hidden 16, 16 codes of 8) with its EMA quantizer, batch 4 of
    8x8x3 images, on the unfused route and on the fused one (the port's
    kernel's plain version, the JAX Pallas kernel in interpret mode): bf16
    rows beside the f32 EMA codebook, the batch statistics in f32; 3 bf16
    steps follow the JAX Trainer's, parameters and EMA buffers alike."""
    jm, tm = _models(jmodels.VectorQuantizedVAE, VectorQuantizedVAE, VAE, seed=1,
                     use_fused=fused)
    assert tm.quantizer.vq.fused(torch.zeros(1)) == fused
    jvq = jm.quantizer.vq
    jm = jm.replace(quantizer=jm.quantizer.replace(vq=jvq.replace(use_fused=fused)))
    batches = [np.random.default_rng(40 + i).random((4, 8, 8, 3)).astype(np.float32)
               for i in range(3)]
    tt, jt, init = _trajectories(tmp_path, jm, _vae_loss, tm, vq_vae.reproduce_loss, batches)
    _assert_trajectory(tt, jt, init, buffers=("quantizer.vq.ema_embedding",
                                              "quantizer.vq.ema_cluster_size",
                                              "quantizer.vq.ema_embedding_avg"))


def test_bf16_gated_image_gpt_trajectory_matches_jax(interpret, monkeypatch, tmp_path):
    """ImageGPT (C 64, 2 blocks, 2 heads of 32, 8x8) with PGT_FUSED_ATTN=1
    on both sides, batch 4: every block's attention through the fused
    block's bf16 mode (its plain version here, 2 calls a step), and 3 bf16
    steps follow the JAX Trainer's (whose block backward recomputes q, k
    and v at another rounding than its forward, attn_block_pallas.py:235-239;
    the port differentiates through its forward's own)."""
    monkeypatch.setenv("PGT_FUSED_ATTN", "1")
    jm, tm = _models(jmodels.ImageGPT, ImageGPT, GATED, seed=2)
    jm = jm.replace(blocks=tuple(b.replace(attn=b.attn.replace(use_flash=True))
                                 for b in jm.blocks))
    calls = []
    real = attn_block_cuda.attention_block_packed
    monkeypatch.setattr("pytorch_generative_tpu_torch.nn.attention.attention_block_packed",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    batches = [_binary(4, (8, 8, 1), seed=50 + i) for i in range(3)]
    tt, jt, init = _trajectories(tmp_path, jm, _bce, tm, image_gpt.reproduce_loss, batches)
    assert calls == [torch.bfloat16] * 3 * GATED["n_transformer_blocks"]
    _assert_trajectory(tt, jt, init, key_bias=("attn.kv_proj.bias", GATED["n_embedding_channels"]))

"""The port's mixed-precision training recipe (``Trainer(compute_dtype=
torch.bfloat16)``) against the JAX package's (``compute_dtype=jnp.bfloat16``),
on the CPU.

Both keep float32 master weights and run each step on bf16 copies of the
parameters and constant buffers with a bf16 input, state buffers staying
float32. Tiny ImageGPTs (8x8 images, batch 4): C = 32 with the JAX flash
kernel in interpret mode, and C = 128, whose blocks take the fused MLP
(the JAX ``mlp_pallas`` kernel in interpret mode, forced on as the TPU
gate would). Inputs come from numpy seeds; each case states its tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from pytorch_generative_tpu import core as jcore
from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu import optim as joptim
from pytorch_generative_tpu import trainer as jtrainer
from pytorch_generative_tpu.ops import attention_pallas, mlp_pallas
from pytorch_generative_tpu_torch import convert, core, optim, trainer
from pytorch_generative_tpu_torch.models import ImageGPT
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
from pytorch_generative_tpu_torch.nn import Conv2d, VectorQuantizer
from pytorch_generative_tpu_torch.ops import attention_cuda
from pytorch_generative_tpu_torch.utils import checkpoint as ckpt_utils

TINY = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=2,
            n_attention_heads=2, n_embedding_channels=32, in_shape=(8, 8, 1))
FUSED = dict(TINY, n_transformer_blocks=1, n_embedding_channels=128)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes on shared cores: keep
    torch's CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 1)) < 0.3).astype(np.float32)


def _jax_loss(x, _, preds):
    n = x.shape[0]
    return optax.sigmoid_binary_cross_entropy(
        preds.reshape(n, -1), x.reshape(n, -1)).sum(axis=1).mean()


def _records(log_dir, tag):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag and "train" in rec:
                out[rec["step"]] = rec["train"]
    return out


class _Net(nn.Module):
    """A 1x1 conv, a constant mask buffer and an EMA quantizer."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(4, 4, 1, generator=torch.Generator().manual_seed(0))
        self.vq = VectorQuantizer(8, 4, generator=torch.Generator().manual_seed(1))
        self.register_buffer("mask", torch.ones(4))

    def forward(self, x):
        return self.conv(x) * self.mask


def test_cast_floating_keeps_state_buffers_and_master_weights_float32():
    """cast_floating casts the parameters and the constant mask to bf16 as
    differentiable copies; the quantizer's EMA buffers are its own float32
    tensors (the state_buffers declaration, as the JAX state_field), so
    in-place updates land on them. A backward through the copies leaves
    float32 gradients on the float32 parameters."""
    net = _Net()
    tensors = core.cast_floating(net, torch.bfloat16)
    assert core.state_buffer_names(net) == {
        "vq.ema_embedding", "vq.ema_cluster_size", "vq.ema_embedding_avg"}
    for name in core.state_buffer_names(net):
        assert tensors[name] is dict(net.named_buffers())[name]
        assert tensors[name].dtype == torch.float32
    for name in ("conv.weight", "conv.bias", "mask"):
        assert tensors[name].dtype == torch.bfloat16
    x = torch.randn((2, 3, 3, 4), generator=torch.Generator().manual_seed(2))
    out = torch.func.functional_call(net, tensors, (x.bfloat16(),))
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    for p in net.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert bool(p.grad.abs().sum() > 0)


def _jax_model(config, fused_mlp):
    jm = jmodels.ImageGPT(jax.random.PRNGKey(0), **config)
    jm = jm.replace(pos=jax.random.normal(jax.random.PRNGKey(42), jm.pos.shape) * 0.1)
    return jm.replace(blocks=tuple(
        b.replace(attn=b.attn.replace(use_flash=True), use_fused_mlp=fused_mlp)
        for b in jm.blocks))


# Losses within LOSS_RTOL (measured at most 2.1e-3: bf16 activations
# rounded at other places in the two frameworks' plain ops, and sums in
# another order). Parameters after 3 Adam steps of lr 5e-3: each tensor's
# update held to the JAX update by relative L2, ||got - want|| / ||want -
# init||, within UPDATE_RL2 (measured at most 0.23, on a LayerNorm offset
# whose small gradient bf16 noise flips the sign of here and there). Adam
# turns each flipped sign into a step of about lr the other way (ROADMAP
# "Not faults"); a wrong gradient moves a tensor the wrong way everywhere,
# about 1 to 1.4. The key bias gets an exactly-zero gradient (it shifts
# every score of a row alike): both sides feed Adam rounding noise, so its
# entries are held to 3 steps of 2 lr instead.
LOSS_RTOL = 1e-2
UPDATE_RL2 = 0.35
KEY_BIAS_ATOL = 3 * 2 * 5e-3


@pytest.mark.parametrize("config", [TINY, FUSED], ids=["C32", "C128_fused_mlp"])
def test_bf16_trainer_trajectory_matches_jax(tmp_path, monkeypatch, config):
    """3 steps of Trainer(compute_dtype=torch.bfloat16, device="cpu")
    against jtrainer.Trainer(compute_dtype=jnp.bfloat16), same weights and
    batches, adam_multiplicative(5e-3): losses within LOSS_RTOL, each
    parameter's update within UPDATE_RL2 relative L2 of the JAX one. The
    port's master weights, gradients and checkpoint stay float32."""
    monkeypatch.setattr(attention_pallas, "_INTERPRET", True)
    monkeypatch.setattr(mlp_pallas, "_INTERPRET", True)
    fused = config["n_embedding_channels"] % 128 == 0
    jm = _jax_model(config, fused)
    tm = ImageGPT(**config, device="cpu")
    tm.load_state_dict(convert.from_jax_params(_flat(jm)))
    init = {k: v.detach().double().clone() for k, v in tm.named_parameters()}
    assert all(b.use_fused_mlp == fused for b in tm.blocks)
    batches = [(_images(4, 8, seed=20 + i), None) for i in range(3)]
    kw = dict(train_loader=batches, eval_loader=[], sample_epochs=None, use_tensorboard=False)
    jt = jtrainer.Trainer(model=jm, loss_fn=_jax_loss, log_dir=str(tmp_path / "jax"),
                          optimizer=joptim.adam_multiplicative(5e-3, 0.999977),
                          compute_dtype=jnp.bfloat16, **kw)
    jt.interleaved_train_and_eval(1)
    tt = trainer.Trainer(model=tm, loss_fn=image_gpt.reproduce_loss,
                         log_dir=str(tmp_path / "torch"),
                         optimizer=optim.adam_multiplicative(5e-3, 0.999977),
                         compute_dtype=torch.bfloat16, device="cpu", **kw)
    tt.interleaved_train_and_eval(1)

    want, got = _records(jt.log_dir, "metrics/loss"), _records(tt.log_dir, "metrics/loss")
    assert sorted(got) == sorted(want) == [0, 1, 2]
    np.testing.assert_allclose([got[s] for s in range(3)], [want[s] for s in range(3)],
                               rtol=LOSS_RTOL)
    want = convert.from_jax_params(_flat(jcore.partition(jt.model)[0]))
    c = config["n_embedding_channels"]
    for name, p in tt.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        got, ref, start = p.detach().double(), want[name].double(), init[name]
        if name.endswith("attn.kv_proj.bias"):
            np.testing.assert_allclose(got[:c], ref[:c], rtol=0, atol=KEY_BIAS_ATOL)
            got, ref, start = got[c:], ref[c:], start[c:]
        rl2 = float((got - ref).norm() / (ref - start).norm())
        assert rl2 <= UPDATE_RL2, f"{name}: the update's relative L2 error {rl2:.3e}"
    state, _ = ckpt_utils.restore_checkpoint(ckpt_utils.checkpoint_path(tt.log_dir, 1))
    floats = [t for t in state["model"].values() if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)


def test_bf16_unported_modes_raise_before_any_work(monkeypatch):
    """What bf16 still does not take raises before any work, naming ROADMAP:
    the flash kernels at a (d_k, d_v) pair outside the bf16 mode ((8, 8);
    PixelSNAIL's (4, 32) and (4, 8) are taken), ``PGT_FLASH_PRECISION=
    default`` with f32 operands, and a compute dtype other than bf16
    ("float16"), each before any kernel or plain version runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 8), generator=g).bfloat16() for _ in range(3))
    calls = []
    monkeypatch.setattr(attention_cuda, "causal_attention_with_lse",
                        lambda *a: calls.append(a))
    for fn in (attention_cuda._flash_forward_bf16_plain, attention_cuda._flash_backward_bf16_plain):
        monkeypatch.setattr(attention_cuda, fn.__name__, lambda *a: calls.append(a))
    with pytest.raises(TypeError, match="ROADMAP.md queue B item 1"):
        attention_cuda.causal_attention_packed(q, k, v, True, 1)
    with pytest.raises(TypeError, match="ROADMAP.md queue B item 1"):
        attention_cuda.flash_backward(q, k, v, v, torch.zeros((1, 1, 8)), v, True, 1)
    monkeypatch.setenv("PGT_FLASH_PRECISION", "default")
    with pytest.raises(ValueError, match="ROADMAP.md queue B item 1"):
        attention_cuda.causal_attention_packed(q.float(), k.float(), v.float(), True, 1)
    monkeypatch.delenv("PGT_FLASH_PRECISION")
    assert not calls

    model = ImageGPT(**TINY, device="cpu")
    before = [p.clone() for p in model.parameters()]
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
        trainer.Trainer(model, image_gpt.reproduce_loss, optim.adam(1e-3), [], [],
                        use_tensorboard=False, compute_dtype="float16", device="cpu")
    assert all(p.grad is None for p in model.parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))

"""The port's fused attention block (``PGT_FUSED_ATTN=1``) and the MLP
backward's recompute and pipelined routes against the JAX package, on the
CPU.

The plain versions of ``ops/attn_block_cuda.py`` and ``ops/mlp_cuda.py``
are held to the JAX Pallas kernels (``attn_block_pallas``, ``mlp_pallas``)
run in interpret mode, as tests/test_kernels.py runs them; the module gate
and a 2-block ImageGPT at C = 128 with the gate on are held to the JAX
package's. Inputs come from numpy seeds; each case states its tolerance.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_generative_tpu import core
from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu import nn as jnn
from pytorch_generative_tpu import optim as joptim
from pytorch_generative_tpu import trainer as jtrainer
from pytorch_generative_tpu.ops import attention_pallas, attn_block_pallas, mlp_pallas
from pytorch_generative_tpu_torch import convert, optim, trainer
from pytorch_generative_tpu_torch.models import ImageGPT
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
from pytorch_generative_tpu_torch.nn import CausalAttention
from pytorch_generative_tpu_torch.ops import attention_cuda, attn_block_cuda, mlp_cuda

EPS = 1e-5
# C = 128: the fused LayerNorm and MLP gate (C % 128 == 0) holds too; 2
# heads of 64; 8x8 images.
GATED = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=2,
             n_attention_heads=2, n_embedding_channels=128, in_shape=(8, 8, 1))


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
    """The JAX kernels in interpret mode."""
    for mod in (attention_pallas, attn_block_pallas, mlp_pallas):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _block_args(l, c=32, e=32, o=32, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    return [mk(2, l, c), mk(c, e), mk(e), mk(c, e + o), mk(e + o), mk(o, o), mk(o)]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 50])
def test_block_matches_jax_kernel(interpret, l, mask_center):
    """The block's plain forward against attn_block_pallas.attention_block_packed
    in interpret mode (B 2, C 32, 2 heads; L = 50 ends on a ragged tile): y
    within atol 2e-5 (the JAX package's own block test); the gradients of
    sum(y * g) through _AttentionBlockPacked within atol 5e-5 (the JAX block
    test allows 5e-4; the largest error over the four cases measured
    7.6e-6, y's 2.4e-7)."""
    args = _block_args(l, seed=l)
    g = np.random.default_rng(l + 1).standard_normal((2, l, 32)).astype(np.float32)
    jargs = list(map(jnp.asarray, args))
    want, pullback = jax.vjp(
        lambda *a: attn_block_pallas.attention_block_packed(*a, mask_center, 2), *jargs)
    want_grads = pullback(jnp.asarray(g))

    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    before = (attn_block_cuda.launches, attn_block_cuda.project_launches,
              attention_cuda.bwd_launches)
    got = attn_block_cuda.attention_block_packed(*targs, mask_center, 2)
    got.backward(torch.from_numpy(g))
    # CPU tensors never launch.
    assert (attn_block_cuda.launches, attn_block_cuda.project_launches,
            attention_cuda.bwd_launches) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    for name, t, w in zip(("dx", "dwq", "dbq", "dwkv", "dbkv", "dwo", "dbo"), targs,
                          want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=5e-5,
                                   err_msg=name)
    if mask_center:
        _, attn, lse = attn_block_cuda.attention_block_plain(
            *map(torch.from_numpy, args), mask_center, 2)
        assert bool((attn[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all())


def test_block_takes_wo_width_not_x_width():
    """out_channels (48) != in_channels (32): the gate's output has Wo's
    width and equals the port's unfused path (forward exactly, gradients
    within atol 1e-6). The JAX kernel cannot be compared here: it sizes y
    by x (attn_block_pallas.py:185), a defect the port does not copy."""
    module = CausalAttention(32, n_heads=2, out_channels=48,
                             generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 50, 32))
                         .astype(np.float32)).requires_grad_()
    outs, grads = [], []
    for gate in ("1", "0"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PGT_FUSED_ATTN", gate)
            module.zero_grad()
            x.grad = None
            y = module(x)
            y.square().sum().backward()
        outs.append(y.detach())
        grads.append([p.grad.clone() for p in (x, *module.parameters())])
    assert outs[0].shape == (2, 50, 48)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_module_gate_matches_jax_and_the_ungated_path(interpret, monkeypatch):
    """CausalAttention on a flat (N, L, C) sequence with PGT_FUSED_ATTN=1 (C 64,
    2 heads, mask_center) against the JAX module with the gate on and
    use_flash=True: within atol 2e-5. The gate reads the variable at every
    call: with it off, the same port module takes the unfused path and
    gives the same values."""
    monkeypatch.setenv("PGT_FUSED_ATTN", "1")
    module = CausalAttention(64, n_heads=2, mask_center=True,
                             generator=torch.Generator().manual_seed(1))
    jmodule = jax.eval_shape(functools.partial(jnn.CausalAttention, in_channels=64,
                                               n_heads=2, mask_center=True,
                                               use_flash=True), jax.random.PRNGKey(0))
    fill = {}
    for name in ("q_proj", "kv_proj", "out_proj"):
        conv = getattr(module, name)
        fill[name] = getattr(jmodule, name).replace(
            weight=jnp.asarray(conv.weight.detach().numpy()[None, None]),
            bias=jnp.asarray(conv.bias.detach().numpy()))
    jmodule = jmodule.replace(**fill)
    x = np.random.default_rng(8).standard_normal((2, 50, 64)).astype(np.float32)
    want = np.asarray(jmodule(jnp.asarray(x)))
    calls = []
    real = attn_block_cuda.attention_block_packed
    monkeypatch.setattr("pytorch_generative_tpu_torch.nn.attention.attention_block_packed",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
        monkeypatch.setenv("PGT_FUSED_ATTN", "0")
        ungated = module(torch.from_numpy(x))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got, ungated, rtol=0, atol=1e-6)


def _gated_models(seed):
    """(JAX ImageGPT with use_flash on, port ImageGPT) at GATED with the
    same weights: drawn by the port from a seed and filled into the JAX
    model's tree (built by jax.eval_shape, which runs none of JAX's slow
    initialisers); the port model under test is loaded from that tree
    through convert.from_jax_params, strictly, so the conversion needs
    nothing new for the gate."""
    drawn = ImageGPT(**GATED, generator=torch.Generator().manual_seed(seed),
                     device="cpu").state_dict()
    drawn["pos"] = 0.1 * torch.randn(drawn["pos"].shape,
                                     generator=torch.Generator().manual_seed(seed + 1))
    skeleton = jax.eval_shape(functools.partial(jmodels.ImageGPT, **GATED),
                              jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(skeleton)
    values = []
    for path, leaf in leaves:
        key = convert._key(jax.tree_util.keystr(path))
        t = drawn[key].numpy()
        if key == "pos":
            pass
        elif t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif len(leaf.shape) == 4:
            t = t[None, None]            # 1x1 conv (in, out) -> (1, 1, in, out)
        assert t.shape == leaf.shape, (path, t.shape, leaf.shape)
        values.append(jnp.asarray(t))
    jm = jax.tree_util.tree_unflatten(treedef, values)
    jm = jm.replace(blocks=tuple(b.replace(attn=b.attn.replace(use_flash=True))
                                 for b in jm.blocks))
    tm = ImageGPT(**GATED, device="cpu")
    tm.load_state_dict(convert.from_jax_params(_flat(jm)), strict=True)
    return jm, tm


def _records(log_dir, tag):
    """{step: train value} of one tag in a Trainer's metrics.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag and "train" in rec:
                out[rec["step"]] = rec["train"]
    return out


def test_gated_image_gpt_matches_jax(interpret, monkeypatch, tmp_path):
    """ImageGPT at C = 128 (2 blocks, 2 heads of 64, 8x8), PGT_FUSED_ATTN=1
    on both sides, batch 4 (every block through the block's plain version,
    2 calls a forward): logits within atol 1e-4 of the JAX model's, the
    gradients of the reproduce loss within 2e-5 + 1e-5 relative (as
    tests/test_torch_fused.py holds the same model ungated). Then one
    Trainer step (adam_multiplicative) on each side from the same weights
    and batch: loss and gradient norm within rtol 1e-5; each parameter
    within 1e-5 of its norm (relative L2): Adam divides each gradient by its
    own magnitude, so a weight whose gradient is at rounding level takes
    another fraction of lr on each side (one element of 65,536 here,
    1.3e-5 apart); the key half of each kv_proj.bias, whose exact gradient
    is 0, within 3 steps of lr, as tests/test_torch_train.py bounds it."""
    monkeypatch.setenv("PGT_FUSED_ATTN", "1")
    jm, tm = _gated_models(seed=3)
    x = (np.random.default_rng(9).random((4, 8, 8, 1)) < 0.3).astype(np.float32)
    calls = []
    real = attn_block_cuda.attention_block_packed
    monkeypatch.setattr("pytorch_generative_tpu_torch.nn.attention.attention_block_packed",
                        lambda *a: calls.append(1) or real(*a))

    def jax_loss(x, _, preds):
        n = x.shape[0]
        logits = preds.reshape(n, -1)
        per_pixel = jnp.logaddexp(0.0, logits) - logits * x.reshape(n, -1)
        return per_pixel.sum(axis=1).mean()

    def loss_of_params(p, rest):
        logits = core.combine(p, rest)(jnp.asarray(x))
        return jax_loss(jnp.asarray(x), None, logits), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_of_params, has_aux=True))(
        *core.partition(jm))
    want_grads = convert.from_jax_params(_flat(jgrads))
    xt = torch.from_numpy(x)
    logits = tm(xt)
    assert len(calls) == GATED["n_transformer_blocks"]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    image_gpt.reproduce_loss(xt, None, logits).backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=name)
    tm.zero_grad()

    kw = dict(train_loader=[(x, None)], eval_loader=[], sample_epochs=None,
              use_tensorboard=False)
    jt = jtrainer.Trainer(model=jm, loss_fn=jax_loss, log_dir=str(tmp_path / "jax"),
                          optimizer=joptim.adam_multiplicative(5e-3, 0.999977), **kw)
    jt.interleaved_train_and_eval(1)
    tt = trainer.Trainer(model=tm, loss_fn=image_gpt.reproduce_loss,
                         log_dir=str(tmp_path / "torch"),
                         optimizer=optim.adam_multiplicative(5e-3, 0.999977),
                         device="cpu", **kw)
    tt.interleaved_train_and_eval(1)
    assert len(calls) == 2 * GATED["n_transformer_blocks"]
    for tag in ("metrics/loss", "metrics/grad_norm"):
        np.testing.assert_allclose(_records(tt.log_dir, tag)[0], _records(jt.log_dir, tag)[0],
                                   rtol=1e-5, err_msg=tag)
    want_params = convert.from_jax_params(_flat(core.partition(jt.model)[0]))
    c = GATED["n_embedding_channels"]
    for name, p in tt.model.named_parameters():
        got_p, ref = p.detach().numpy(), want_params[name].numpy()
        if name.endswith("attn.kv_proj.bias"):
            np.testing.assert_allclose(got_p[:c], ref[:c], rtol=0, atol=3 * 5e-3)
            got_p, ref = got_p[c:], ref[c:]
        rel = float(np.linalg.norm(got_p - ref) / np.linalg.norm(ref))
        assert rel <= 1e-5, (f"{name}: relative L2 {rel:.2e}, element-wise max "
                             f"{float(np.abs(got_p - ref).max()):.2e}")


def _mlp_args(r, seed, c=64, f=256):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * s).astype(np.float32)
            for shape, s in (((r, c), 1.0), ((c,), 1.0), ((c,), 1.0), ((c, f), 0.1),
                             ((f,), 1.0), ((f, c), 0.1), ((c,), 1.0))]


@pytest.mark.parametrize("route", ["recompute", "pipe"])
@pytest.mark.parametrize("r", [48, 50])
def test_mlp_backward_routes_match_jax(interpret, monkeypatch, r, route):
    """ln_mlp_residual's gradients with _SAVE_PREACT = False (the recompute
    route) and with PGT_MLP_BWD=pipe, on both packages (C 64, F 256; R = 50
    takes the JAX wrapper's pad path): each gradient within 2e-5 of its
    largest magnitude (tests/test_kernels.py's tolerance for these routes);
    on the port's CPU path the route gives the saved-y route's gradients
    exactly."""
    args = _mlp_args(r, seed=r)
    g = np.random.default_rng(r + 1).standard_normal((r, 64)).astype(np.float32)
    if route == "recompute":
        monkeypatch.setattr(mlp_pallas, "_SAVE_PREACT", False)
        monkeypatch.setattr(mlp_cuda, "_SAVE_PREACT", False)
    else:
        monkeypatch.setenv("PGT_MLP_BWD", "pipe")
    _, pullback = jax.vjp(lambda *a: mlp_pallas.ln_mlp_residual(*a, EPS),
                          *map(jnp.asarray, args))
    want = pullback(jnp.asarray(g))

    def port_grads():
        ts = [torch.from_numpy(a).requires_grad_() for a in args]
        mlp_cuda.ln_mlp_residual(*ts, EPS).backward(torch.from_numpy(g))
        return [t.grad for t in ts]

    calls = {}
    for fn in ("ln_mlp_backward", "ln_mlp_backward_recompute", "ln_mlp_backward_pipe"):
        real = getattr(mlp_cuda, fn)
        monkeypatch.setattr(mlp_cuda, fn, functools.partial(
            lambda real, fn, *a: calls.setdefault(fn, []).append(1) or real(*a), real, fn))
    got = port_grads()
    assert list(calls) == [f"ln_mlp_backward_{route}"]
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, t, w in zip(names, got, want):
        scale = max(float(np.abs(np.asarray(w)).max()), 1.0)
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0, atol=2e-5 * scale,
                                   err_msg=name)
    monkeypatch.setattr(mlp_cuda, "_SAVE_PREACT", True)
    monkeypatch.setenv("PGT_MLP_BWD", "mono")
    for name, a, b in zip(names, got, port_grads()):
        assert torch.equal(a, b), name

"""The PyTorch port's VQ-VAE (convolutions, the vector quantizer and its
fused kernel's plain version, the model, its training with EMA state, the
CIFAR10 loaders) against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages in float32; the
JAX models are built by ``jax.eval_shape`` and filled with seeded port
weights (JAX's own initialisers take seconds a model here), and the port
model under test is loaded back from them through ``convert``. Where the
JAX side reaches the Pallas VQ kernel it runs in interpret mode. Each case
states its tolerance.
"""

import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_generative_tpu import core
from pytorch_generative_tpu import datasets as jdatasets
from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu import nn as jnn
from pytorch_generative_tpu import optim as joptim
from pytorch_generative_tpu import trainer as jtrainer
from pytorch_generative_tpu.ops import vq as jvq
from pytorch_generative_tpu.ops import vq_pallas
from pytorch_generative_tpu_torch import convert, datasets, optim, trainer
from pytorch_generative_tpu_torch import nn as tnn
from pytorch_generative_tpu_torch.models import VectorQuantizedVAE
from pytorch_generative_tpu_torch.models.vae import vq_vae
from pytorch_generative_tpu_torch.ops import vq as tvq
from pytorch_generative_tpu_torch.ops import vq_cuda

TINY = dict(in_channels=3, out_channels=3, hidden_channels=16, residual_channels=8,
            n_residual_blocks=1, n_embeddings=16, embedding_dim=8, in_shape=(8, 8, 3))
# Scores 2 x.e - |e|^2 of f32 rows summed over D = 16 terms of up to ~10 in
# another order: rows whose top two scores are closer than this may pick
# either code on either side; they are counted, and only they may differ.
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
def jax_fused_interpreted(monkeypatch):
    """The JAX fused VQ kernel in interpret mode (no TPU here)."""
    orig = vq_pallas.vq_quantize_fused
    monkeypatch.setattr(vq_pallas, "vq_quantize_fused",
                        lambda flat_x, codebook, **kw: orig(flat_x, codebook, **kw,
                                                            interpret=True))


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _fill_jax(ctor, drawn):
    """The JAX module built by ``ctor(key)`` (shapes only, via eval_shape)
    holding the port's ``drawn`` state_dict: OIHW and (in, out, kh, kw)
    weights both reverse their axes, 1x1 (in, out) weights gain two unit
    axes, the zero-size EMA placeholder stays empty."""
    skeleton = jax.eval_shape(ctor, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(skeleton)
    values = []
    for path, leaf in leaves:
        if 0 in leaf.shape:
            values.append(jnp.zeros(leaf.shape, leaf.dtype))
            continue
        t = drawn[convert._key(jax.tree_util.keystr(path))].numpy()
        if t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
        elif len(leaf.shape) == 4:
            t = t[None, None]
        assert t.shape == leaf.shape, (path, t.shape, leaf.shape)
        values.append(jnp.asarray(t))
    return jax.tree_util.tree_unflatten(treedef, values)


def _vae_models(config, seed):
    """(JAX model, port model) with the same weights, the port model loaded
    from the JAX tree through convert.from_jax_params."""
    drawn = VectorQuantizedVAE(**config, generator=torch.Generator().manual_seed(seed),
                               device="cpu").state_dict()
    jm = _fill_jax(functools.partial(jmodels.VectorQuantizedVAE, **config), drawn)
    tm = VectorQuantizedVAE(**config, device="cpu")
    tm.load_state_dict(convert.from_jax_params(_flat(jm)))
    for name, t in tm.state_dict().items():
        assert torch.equal(t, drawn[name]), name
    return jm, tm


def _images(n, shape, seed):
    return np.random.default_rng(seed).random((n, *shape)).astype(np.float32)


def _records(log_dir, tag, key="train"):
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag and key in rec:
                out[rec["step"]] = rec[key]
    return out


def _jax_loss(x, _, preds):
    preds, vq_loss = preds
    recon = jnp.mean((preds - x) ** 2)
    return {"vq_loss": vq_loss, "reconstruction_loss": recon, "loss": recon + vq_loss}


# (1) Convolutions -------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True], ids=["conv_s2", "conv_transpose"])
def test_strided_and_transposed_convs_match_jax(transposed):
    """Conv2d 4x4 stride 2 pad 1 (the encoder's) and ConvTranspose2d 4x4
    stride 2 pad 1 (the decoder's), weights through convert: within atol
    1e-5 (f32 sums of 4 x 4 x 6 products in another order). The transposed
    conv's JAX (kh, kw, out, in) weight becomes (in, out, kh, kw)."""
    jcls, tcls = ((jnn.ConvTranspose2d, tnn.ConvTranspose2d) if transposed
                  else (jnn.Conv2d, tnn.Conv2d))
    jconv = jcls(jax.random.PRNGKey(3), 6, 5, 4, stride=2, padding=1)
    tconv = tcls(6, 5, 4, stride=2, padding=1)
    tconv.load_state_dict(convert.from_jax_params(_flat(jconv)))
    if transposed:
        assert tuple(tconv.weight.shape) == (6, 5, 4, 4)
    x = np.random.default_rng(0).standard_normal((2, 7, 9, 6)).astype(np.float32)
    want = np.asarray(jconv(jnp.asarray(x)))
    got = tconv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == ((2, 14, 18, 5) if transposed else (2, 3, 4, 5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# (2) The VQ kernel's plain version against the JAX kernel ---------------------

def _assignments(x, cb):
    """(index by argmax in float64, the top-two score gap) of each row."""
    s = 2.0 * x.astype(np.float64) @ cb.T.astype(np.float64) - (cb.astype(np.float64) ** 2).sum(1)
    top = np.sort(s, axis=1)
    return s.argmax(1), top[:, -1] - top[:, -2]


@pytest.mark.parametrize("duplicated", [False, True], ids=["random", "duplicated_rows"])
def test_vq_plain_matches_jax_kernel(duplicated):
    """vq_quantize_plain against the JAX Pallas kernel (interpret mode,
    block_m 128, so M = 300 is ragged) at (300, 16) x (32, 16): indices
    equal on every row whose top-two score gap exceeds NEAR_TIE (near-tie
    rows counted; only they may differ), quantized rows bit-equal where the
    indices agree, counts exact and sums within 1e-5 of the largest |sum|
    once the near-tie rows' moves are accounted for; counts sum to M. With
    a duplicated codebook row both sides pick the first index."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    cb = rng.standard_normal((32, 16)).astype(np.float32)
    if duplicated:
        cb[[7, 20]] = cb[3]  # exact ties with code 3
        x[:40] = cb[3] + 0.01 * rng.standard_normal((40, 16)).astype(np.float32)
    jq, jc, js = (np.asarray(a) for a in vq_pallas.vq_quantize_fused(
        jnp.asarray(x), jnp.asarray(cb), block_m=128, interpret=True))
    tq, tc, ts = (a.numpy() for a in vq_cuda.vq_quantize_plain(
        torch.from_numpy(x), torch.from_numpy(cb)))
    jidx = np.asarray(jvq.nearest_codebook(jnp.asarray(x), jnp.asarray(cb)))
    tidx = tvq.nearest_codebook(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(jq, cb[jidx])  # the JAX kernel's rows are its argmax's
    _, gap = _assignments(x, cb)
    near = gap <= NEAR_TIE
    differ = jidx != tidx
    print(f"near-tie rows {int(near.sum())}, differing rows {int(differ.sum())}")
    assert not (differ & ~near).any()
    np.testing.assert_array_equal(tq[~differ], jq[~differ])
    # Move each differing row from the port's code to JAX's, then compare.
    tc, ts = tc.copy(), ts.copy()
    for m in np.flatnonzero(differ):
        tc[tidx[m]] -= 1
        tc[jidx[m]] += 1
        ts[tidx[m]] -= x[m]
        ts[jidx[m]] += x[m]
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5 * np.abs(js).max())
    assert jc.sum() == tc.sum() == 300
    if duplicated:
        assert tc[3] >= 40 and tc[7] == tc[20] == jc[7] == jc[20] == 0
        assert not np.isin(tidx, [7, 20]).any() and not np.isin(jidx, [7, 20]).any()


# (3) The VectorQuantizer -------------------------------------------------------

@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("use_ema,fused", [(True, False), (True, True), (False, False)],
                         ids=["ema", "ema_fused", "no_ema"])
def test_vector_quantizer_matches_jax(jax_fused_interpreted, use_ema, fused, training):
    """VectorQuantizer on (2, 4, 4, 8) inputs, 16 codes, against the JAX
    module (its fused route through the Pallas kernel in interpret mode):
    straight-through output and loss within atol 1e-6, the updated EMA
    buffers within 1e-6 (EMA training only; untouched otherwise), and the
    gradients of the output and loss w.r.t. the input (and the embedding
    without EMA) within atol 1e-6 (f32, few terms). The port's fused route
    runs the kernel's plain version on the CPU and launches nothing."""
    jq = jnn.VectorQuantizer(jax.random.PRNGKey(0), 16, 8, use_ema=use_ema,
                             use_fused=fused)
    tq = tnn.VectorQuantizer(16, 8, use_ema=use_ema, use_fused=fused)
    tq.load_state_dict(convert.from_jax_params(_flat(jq)))
    assert tq.fused(torch.zeros(1)) == fused
    tq.train(training)
    x = np.random.default_rng(1).standard_normal((2, 4, 4, 8)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((2, 4, 4, 8)).astype(np.float32)

    def jax_objective(params, rest, x):
        q, loss, new = core.combine(params, rest)(x, training=training)
        return jnp.sum(q * w) + loss, (q, loss, new)

    params, rest = core.partition(jq)
    (jgp, jgx), (q, loss, new) = jax.grad(jax_objective, argnums=(0, 2), has_aux=True)(
        params, rest, jnp.asarray(x))
    before = {k: v.clone() for k, v in tq.state_dict().items()}
    launches = vq_cuda.launches
    xt = torch.from_numpy(x).requires_grad_()
    tq_out, tloss = tq(xt)
    (torch.sum(tq_out * torch.from_numpy(w)) + tloss).backward()
    assert vq_cuda.launches == launches
    np.testing.assert_allclose(tq_out.detach().numpy(), np.asarray(q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0, atol=1e-6)
    if use_ema:
        want = convert.from_jax_params(_flat(new))
        for name in ("ema_embedding", "ema_cluster_size", "ema_embedding_avg"):
            got = getattr(tq, name)
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
            if not training:
                assert torch.equal(got, before[name]), name
        if training:
            assert float(tq.ema_cluster_size.sum()) == pytest.approx(0.01 * 32, rel=1e-6)
    else:
        np.testing.assert_allclose(tq.embedding.grad.numpy(), np.asarray(jgp.embedding),
                                   rtol=0, atol=1e-6)


def test_vector_quantizer_rejects_axis_name():
    with pytest.raises(NotImplementedError, match="A.11"):
        tnn.VectorQuantizer(16, 8, axis_name="data")


# (4) The model -----------------------------------------------------------------

def test_forward_matches_jax_at_reproduce_widths():
    """reproduce() widths (32x32x3, hidden 128, 2 residual blocks, 512 x 64
    codebook), batch 2, eval mode: reconstruction within atol 1e-5 and the
    quantizer loss within 1e-6 of the JAX forward (f32 convolutions in
    another order; every latent's top-two score gap above NEAR_TIE, checked,
    so both sides pick the same codes)."""
    jm, tm = _vae_models(vq_vae.REPRODUCE_CONFIG, seed=0)
    tm.eval()
    x = _images(2, (32, 32, 3), seed=0)
    want, want_loss = jax.jit(lambda m, x: m(x))(jm, jnp.asarray(x))
    with torch.no_grad():
        got, loss = tm(torch.from_numpy(x))
        z = tm.quantizer.conv(tm.encoder(torch.from_numpy(x))).reshape(-1, 64).numpy()
    _, gap = _assignments(z, tm.quantizer.vq.ema_embedding.numpy())
    assert (gap > NEAR_TIE).all(), f"{int((gap <= NEAR_TIE).sum())} near-tie latents"
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0, atol=1e-6)
    metrics = vq_vae.reproduce_loss(torch.from_numpy(x), None, (got, loss))
    assert set(metrics) == {"vq_loss", "reconstruction_loss", "loss"}


def test_model_gradients_match_jax():
    """Gradients of reproduce_loss in training mode at a small size, port
    against jax.grad, parameter by parameter through convert: atol 1e-6 +
    rtol 1e-5 (f32 sums in another order); the EMA buffers after the
    forward within 1e-6."""
    jm, tm = _vae_models(TINY, seed=1)
    x = _images(4, (8, 8, 3), seed=3)
    params, rest = core.partition(jm)

    def loss(p):
        preds, new = core.combine(p, rest).forward_with_state(jnp.asarray(x), training=True)
        return _jax_loss(jnp.asarray(x), None, preds)["loss"], new

    jgrads, new = jax.grad(loss, has_aux=True)(params)
    want = convert.from_jax_params(_flat(jgrads))
    tm.train()
    xt = torch.from_numpy(x)
    vq_vae.reproduce_loss(xt, None, tm(xt))["loss"].backward()
    names = dict(tm.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    state = convert.from_jax_params(_flat(new))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), state[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_trainer_trajectory_with_ema_state_matches_jax(tmp_path):
    """4 Trainer steps against the JAX Trainer, same weights and batches,
    adam_multiplicative(2e-4), grad_accumulation=2 (the EMA buffers move
    once per chunk), skip_nonfinite with the third batch holding a NaN:
    that step is skipped on both sides, and the port's buffers come back
    to their values before it exactly; losses of the other steps within
    rtol 1e-5, final parameters within atol 1e-6 and EMA buffers within
    atol 1e-5 (f32; Adam's first steps move each weight by about lr)."""
    jm, tm = _vae_models(TINY, seed=2)
    batches = [(_images(4, (8, 8, 3), seed=20 + i), None) for i in range(4)]
    batches[2][0][1, 3, 3, 0] = np.nan
    kw = dict(train_loader=batches, eval_loader=[], sample_epochs=None,
              use_tensorboard=False, grad_accumulation=2, skip_nonfinite=True)
    jt = jtrainer.Trainer(model=jm, loss_fn=_jax_loss, log_dir=str(tmp_path / "jax"),
                          optimizer=joptim.adam_multiplicative(2e-4, 0.999977), **kw)
    jt.interleaved_train_and_eval(1)

    class Watch(trainer.Trainer):
        """Records the buffers around each step."""

        def train_one_step(self, x, y):
            before = [b.clone() for b in self.model.buffers()]
            out = super().train_one_step(x, y)
            self.buffer_log.append((before, [b.clone() for b in self.model.buffers()]))
            return out

    tt = Watch(model=tm, loss_fn=vq_vae.reproduce_loss, log_dir=str(tmp_path / "torch"),
               optimizer=optim.adam_multiplicative(2e-4, 0.999977), device="cpu", **kw)
    tt.buffer_log = []
    tt.interleaved_train_and_eval(1)

    skipped = _records(tt.log_dir, "metrics/nonfinite_steps")
    assert skipped == _records(jt.log_dir, "metrics/nonfinite_steps") == {
        0: 0.0, 1: 0.0, 2: 1.0, 3: 0.0}
    before, after = tt.buffer_log[2]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not all(torch.equal(a, b) for a, b in zip(*tt.buffer_log[1]))
    for tag in ("metrics/loss", "metrics/vq_loss", "metrics/reconstruction_loss"):
        want, got = _records(jt.log_dir, tag), _records(tt.log_dir, tag)
        np.testing.assert_allclose([got[s] for s in (0, 1, 3)], [want[s] for s in (0, 1, 3)],
                                   rtol=1e-5, err_msg=tag)
    want = convert.from_jax_params(_flat(jt.model))
    for name, t in tt.model.state_dict().items():
        atol = 1e-5 if name.startswith("quantizer.vq.ema") else 1e-6
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_checkpoint_restores_ema_state(tmp_path):
    """A Trainer that resumes from the epoch-1 checkpoint (a model from
    another seed, so only the checkpoint can make it match) ends epoch 2
    with the parameters and EMA buffers of an uninterrupted 2-epoch run,
    exactly; eval forwards leave the buffers untouched."""
    batches = [(_images(4, (8, 8, 3), seed=30 + i), None) for i in range(2)]

    def new_trainer(log_dir, seed):
        model = VectorQuantizedVAE(**TINY, generator=torch.Generator().manual_seed(seed),
                                   device="cpu")
        return trainer.Trainer(model, vq_vae.reproduce_loss,
                               optim.adam_multiplicative(2e-4, 0.999977), batches,
                               batches, log_dir=str(log_dir), sample_epochs=None,
                               use_tensorboard=False, device="cpu")

    straight = new_trainer(tmp_path / "a", 0)
    straight.interleaved_train_and_eval(2)
    first = new_trainer(tmp_path / "b", 0)
    first.interleaved_train_and_eval(1)
    state = {k: v.clone() for k, v in first.model.state_dict().items()}
    first._evaluate()
    assert all(torch.equal(v, state[k]) for k, v in first.model.state_dict().items())
    resumed = new_trainer(tmp_path / "b", 5)
    resumed.interleaved_train_and_eval(2)
    want = straight.model.state_dict()
    for name, t in resumed.model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorQuantizedVAE(**TINY)
    with pytest.raises(NotImplementedError, match="sampling"):
        VectorQuantizedVAE(**TINY, device="cpu").sample(2)


# (5) CIFAR10 loaders --------------------------------------------------------

def test_cifar10_loaders_match_jax(tmp_path, monkeypatch):
    """On six tiny pickled batches (the files' layout) under $PGT_DATA_DIR,
    the port's loaders give the JAX package's batches exactly, raw and
    normalized; without the files they raise FileNotFoundError naming the
    roots searched."""
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)
    monkeypatch.setenv("PGT_DATA_DIR", str(tmp_path))
    for normalize in (False, True):
        want = jdatasets.get_cifar10_loaders(4, normalize=normalize, seed=3)
        got = datasets.get_cifar10_loaders(4, normalize=normalize, seed=3)
        for jl, tl in zip(want, got):
            for _ in range(2):  # two epochs: the shuffle moves
                pairs = list(zip(jl, tl))
                assert len(pairs) == len(jl) == len(tl)
                for (jx, jy), (tx, ty) in pairs:
                    assert tx.shape[1:] == (32, 32, 3)
                    np.testing.assert_array_equal(tx, jx)
                    np.testing.assert_array_equal(ty, jy)
    monkeypatch.setattr(datasets, "_data_roots", lambda: [str(tmp_path / "none")])
    with pytest.raises(FileNotFoundError, match="none"):
        datasets.load_cifar10()


def test_reproduce_trains_on_a_debug_loader(tmp_path):
    """vq_vae.reproduce() on the CPU with a debug loader of two batches at
    its config: finite losses, the three metrics logged, a checkpoint."""
    loader = [(_images(2, (32, 32, 3), seed=40 + i), None) for i in range(2)]
    t = vq_vae.reproduce(n_epochs=1, log_dir=str(tmp_path), debug_loader=loader,
                         device="cpu")
    for tag in ("metrics/loss", "metrics/vq_loss", "metrics/reconstruction_loss"):
        assert np.isfinite(list(_records(t.log_dir, tag).values())).all()
    assert "trainer_state_1.ckpt" in os.listdir(tmp_path)
    assert float(t.model.quantizer.vq.ema_cluster_size.sum()) > 0

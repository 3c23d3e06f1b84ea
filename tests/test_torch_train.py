"""The PyTorch port's training path against the JAX package, on the CPU.

Tiny shapes (ImageGPT with 2 blocks, C 32, 8x8 images, batch <= 4). Inputs
come from numpy seeds and go through both packages in float32; where the
JAX side reaches a Pallas kernel it runs in interpret mode, as
tests/test_kernels.py runs it. Each case states its tolerance.
"""

import gzip
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_generative_tpu import core
from pytorch_generative_tpu import datasets as jdatasets
from pytorch_generative_tpu import models as jmodels
from pytorch_generative_tpu import optim as joptim
from pytorch_generative_tpu import trainer as jtrainer
from pytorch_generative_tpu.ops import attention_pallas
from pytorch_generative_tpu_torch import convert, optim, trainer
from pytorch_generative_tpu_torch import datasets as tdatasets
from pytorch_generative_tpu_torch.models import ImageGPT
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
from pytorch_generative_tpu_torch.ops import attention_cuda
from pytorch_generative_tpu_torch.utils import checkpoint as ckpt_utils

TINY = dict(in_channels=1, out_channels=1, in_size=8, n_transformer_blocks=2,
            n_attention_heads=2, n_embedding_channels=32, in_shape=(8, 8, 1))
# A smaller model still, for the Trainer contract (no JAX side).
MINI = dict(in_channels=1, out_channels=1, in_size=4, n_transformer_blocks=1,
            n_attention_heads=2, n_embedding_channels=8, in_shape=(4, 4, 1))


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


def _jax_model(use_flash=False):
    m = jmodels.ImageGPT(jax.random.PRNGKey(0), **TINY)
    m = m.replace(pos=jax.random.normal(jax.random.PRNGKey(42), m.pos.shape) * 0.1)
    if use_flash:
        m = m.replace(blocks=tuple(
            b.replace(attn=b.attn.replace(use_flash=True)) for b in m.blocks))
    return m


def _port(tree, config=TINY):
    model = ImageGPT(**config, device="cpu")
    model.load_state_dict(convert.from_jax_params(_flat(tree)))
    return model


def _images(n, size, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, size, size, 1)) < 0.3).astype(np.float32)


def _jax_loss(x, _, preds):
    n = x.shape[0]
    return optax.sigmoid_binary_cross_entropy(
        preds.reshape(n, -1), x.reshape(n, -1)).sum(axis=1).mean()


def _records(log_dir, tag, key="train"):
    """{step: value} of one tag in a Trainer's metrics.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag and key in rec:
                out[rec["step"]] = rec[key]
    return out


# (1) The flash backward ----------------------------------------------------

def _flash_backward_failure_report(request, arrays, rerun, exact):
    """What test_flash_backward_plain_matches_jax_kernel records when a
    comparison fails (fault C.2): saves ``arrays`` with np.savez under the
    test's tmp_path and describes ``rerun`` (the port's plain forward and
    backward run again on the same inputs in this process) and this
    process's torch CPU settings."""
    path = request.getfixturevalue("tmp_path") / "flash_backward_failure.npz"
    np.savez(path, **arrays)
    again = all(np.array_equal(arrays[f"port_{name}"], t.numpy())
                for name, t in rerun.items())
    errs = ", ".join(  # equal infinities (lse = -inf) count as no error
        f"{name} {np.abs(np.where(t.numpy() == e.numpy(), 0, t.numpy() - e.numpy())).max():.3e}"
        for (name, t), e in zip(rerun.items(), exact))
    mkldnn = torch.backends.mkldnn
    settings = [f"mkldnn.{attr} {getattr(obj, 'fp32_precision')!r}"
                for attr, obj in (("fp32_precision", mkldnn),
                                  ("matmul.fp32_precision", getattr(mkldnn, "matmul", None)))
                if hasattr(obj, "fp32_precision")]
    return (f"rerun of the port's plain forward and backward in this process gives "
            f"the failing values again: {again}; its largest error against float64: "
            f"{errs}; torch.get_num_threads() {torch.get_num_threads()}, "
            f"get_float32_matmul_precision() {torch.get_float32_matmul_precision()!r}, "
            f"cpu capability {torch.backends.cpu.get_cpu_capability()!r}, "
            + (", ".join(settings) or "no mkldnn fp32 precision setting")
            + f"; inputs and outputs saved to {path}")


@pytest.mark.parametrize("mask_center", [False, True])
@pytest.mark.parametrize("l", [64, 50])
def test_flash_backward_plain_matches_jax_kernel(monkeypatch, request, mask_center, l):
    """The backward's plain version against the JAX Pallas backward in
    interpret mode, each from its own forward's out and lse: dq, dk, dv
    within atol 1e-5 (f32, another summation order); the fully-masked row
    gets an exactly-zero dq. L = 50 is a ragged tile.

    Each side is first held on its own against the same formula evaluated
    in float64 (the plain forward and backward on float64 copies of the
    inputs), at the same 1e-5, so that a failure names the side that
    computed something else. On a failure the test saves its inputs and
    both sides' outputs, reruns the port's side in the same process and
    says what the rerun gave (fault C.2)."""
    monkeypatch.setattr(attention_pallas, "_INTERPRET", True)
    n_heads, d = 2, 8
    rng = np.random.default_rng(l)
    q, k, v, g = (rng.standard_normal((2, l, n_heads * d)).astype(np.float32)
                  for _ in range(4))
    blocks = (attention_pallas.DEFAULT_BLOCK_Q, attention_pallas.DEFAULT_BLOCK_K)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = attention_pallas._flash_forward(jq, jk, jv, n_heads, mask_center,
                                                 *blocks, True)
    want = attention_pallas._flash_backward(jq, jk, jv, jout, jlse, jg, n_heads,
                                            mask_center, *blocks, True)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = attention_cuda.flash_forward(tq, tk, tv, mask_center, n_heads)
    before = attention_cuda.bwd_launches
    got = attention_cuda.flash_backward(tq, tk, tv, out, lse, tg, mask_center, n_heads)
    assert attention_cuda.bwd_launches == before  # CPU tensors never launch

    f64 = [torch.from_numpy(a).double() for a in (q, k, v, g)]
    out64, lse64 = attention_cuda.flash_forward_plain(*f64[:3], mask_center, n_heads)
    exact = attention_cuda.flash_backward_plain(*f64[:3], out64, lse64, f64[3],
                                                mask_center, n_heads)
    try:
        for name, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
            e = e.numpy()
            np.testing.assert_allclose(np.asarray(b), e, rtol=0, atol=1e-5,
                                       err_msg=f"{name}: the JAX kernel against float64")
            np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=1e-5,
                                       err_msg=f"{name}: the port's plain backward "
                                               "against float64")
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    except AssertionError as failure:
        arrays = dict(q=q, k=k, v=v, g=g, port_out=out.numpy(), port_lse=lse.numpy(),
                      f64_out=out64.numpy(), f64_lse=lse64.numpy())
        for name, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
            arrays.update({f"port_{name}": a.numpy(), f"jax_{name}": np.asarray(b),
                           f"f64_{name}": e.numpy()})
        out2, lse2 = attention_cuda.flash_forward(tq, tk, tv, mask_center, n_heads)
        grads2 = attention_cuda.flash_backward(tq, tk, tv, out2, lse2, tg, mask_center,
                                               n_heads)
        rerun = dict(zip(("out", "lse", "dq", "dk", "dv"), (out2, lse2, *grads2)))
        report = _flash_backward_failure_report(request, arrays, rerun,
                                                (out64, lse64, *exact))
        raise AssertionError(f"{failure}\n{report}") from failure
    if mask_center:
        np.testing.assert_array_equal(got[0][:, 0].numpy(), 0.0)


def test_attention_function_gradcheck_float64():
    """torch.autograd.gradcheck of the attention Function on its plain path,
    float64, 2 heads, with and without mask_center (gradcheck's own
    tolerances)."""
    rng = np.random.default_rng(0)
    for mask_center in (False, True):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 7, 4))).requires_grad_()
                   for _ in range(3))
        assert torch.autograd.gradcheck(
            lambda q, k, v: attention_cuda.causal_attention_packed(q, k, v, mask_center, 2),
            (q, k, v))


# (2) Model gradients --------------------------------------------------------

def test_model_gradients_match_jax(monkeypatch):
    """Gradients of the reproduce loss, port (its attention Function on the
    plain path) against jax.grad of the JAX model on its Pallas flash
    kernels (interpret mode), parameter by parameter through the weight
    bridge: atol 2e-5 + rtol 1e-5 (f32, sums over 64 pixels x 2 images in
    another order). The masked taps of the type-A input conv get exactly
    zero gradient on both sides."""
    monkeypatch.setattr(attention_pallas, "_INTERPRET", True)
    jm = _jax_model(use_flash=True)
    tm = _port(jm)
    x = _images(2, 8, seed=1)
    params, rest = core.partition(jm)
    jgrads = jax.jit(jax.grad(lambda p: _jax_loss(x, None, core.combine(p, rest)(jnp.asarray(x)))))(params)
    want = convert.from_jax_params(_flat(jgrads))

    xt = torch.from_numpy(x)
    image_gpt.reproduce_loss(xt, None, tm(xt)).backward()
    names = dict(tm.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=name)
    masked = (tm.input_conv.mask == 0).expand_as(tm.input_conv.weight)
    assert masked.any()
    assert bool((tm.input_conv.weight.grad[masked] == 0).all())
    assert bool((want["input_conv.weight"][masked] == 0).all())


# (3) The Trainer's 3-step trajectory ----------------------------------------

def test_trainer_trajectory_matches_jax(tmp_path):
    """3 steps of the port's Trainer against the JAX Trainer, same weights
    and batches, adam_multiplicative: losses within rtol 1e-5 and final
    parameters within atol 1e-5 (f32 sums in another order; Adam's first
    steps move each weight by about lr whatever the gradient's size)."""
    jm = _jax_model()
    tm = _port(jm)
    batches = [(_images(4, 8, seed=10 + i), None) for i in range(3)]
    kw = dict(train_loader=batches, eval_loader=[], sample_epochs=None,
              use_tensorboard=False)
    jt = jtrainer.Trainer(model=jm, loss_fn=_jax_loss, log_dir=str(tmp_path / "jax"),
                          optimizer=joptim.adam_multiplicative(5e-3, 0.999977), **kw)
    jt.interleaved_train_and_eval(1)
    tt = trainer.Trainer(model=tm, loss_fn=image_gpt.reproduce_loss,
                         log_dir=str(tmp_path / "torch"),
                         optimizer=optim.adam_multiplicative(5e-3, 0.999977),
                         device="cpu", **kw)
    tt.interleaved_train_and_eval(1)

    for tag in ("metrics/loss", "metrics/grad_norm"):
        want, got = _records(jt.log_dir, tag), _records(tt.log_dir, tag)
        assert sorted(got) == sorted(want) == [0, 1, 2]
        np.testing.assert_allclose([got[s] for s in range(3)], [want[s] for s in range(3)],
                                   rtol=1e-5)
    np.testing.assert_allclose(
        list(_records(tt.log_dir, "metrics/lr", "group_0").values()),
        list(_records(jt.log_dir, "metrics/lr", "group_0").values()), rtol=1e-6)
    want = convert.from_jax_params(_flat(core.partition(jt.model)[0]))
    c = TINY["n_embedding_channels"]
    for name, p in tt.model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("attn.kv_proj.bias"):
            # The key bias shifts every score of a row alike, so its exact
            # gradient is 0: both sides feed Adam rounding noise, which it
            # turns into steps of up to lr of either sign.
            np.testing.assert_allclose(got[:c], ref[:c], rtol=0, atol=3 * 2 * 5e-3)
            got, ref = got[c:], ref[c:]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=name)


# (4) Optimizers ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "adam_multiplicative", "adabelief"])
def test_optimizers_match_optax(kind):
    """5 steps against optax / the JAX package's optimizers from the same
    gradients; step 3 is dropped (keep=False, with a NaN gradient) and moves
    nothing, not even the learning rate. Parameters within rtol 1e-6, atol
    1e-7 (f32; 1 ulp from the order of the bias-correction products)."""
    schedule = lambda t: 5e-2 * 0.9 ** t
    if kind == "adam":
        make, _ = optim.adam(1e-2)
        jtx, _ = joptim.adam(1e-2)
    elif kind == "adam_multiplicative":
        make, sched = optim.adam_multiplicative(5e-2, 0.9)
        jtx, _ = joptim.adam_multiplicative(5e-2, 0.9)
        assert sched(3) == pytest.approx(5e-2 * 0.9 ** 3)
    else:
        make, jtx = optim.adabelief(schedule), joptim.adabelief(schedule)
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = make(params)
    jparams = [jnp.asarray(a) for a in init]
    jstate = jtx.init(jparams)
    for step in range(5):
        grads = [rng.standard_normal(a.shape).astype(np.float32) for a in init]
        skip = step == 2
        if skip:
            grads[0][0, 0] = np.nan
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        if skip:
            opt.step(keep=torch.tensor(False))
        else:
            opt.step()
            updates, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert int(opt.count) == 4


# (5) The Trainer contract ---------------------------------------------------

def _mini(seed=0):
    return ImageGPT(**MINI, generator=torch.Generator().manual_seed(seed), device="cpu")


def _mini_trainer(tmp_path, model=None, **kw):
    kw.setdefault("sample_epochs", None)
    return trainer.Trainer(model or _mini(), image_gpt.reproduce_loss,
                           optim.adam_multiplicative(5e-3, 0.999977), kw.pop("train", []),
                           kw.pop("eval", []), log_dir=str(tmp_path), use_tensorboard=False,
                           device="cpu", **kw)


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_clip_grad_norm_scales_to_the_clip(tmp_path):
    """grad_norm is logged before clipping; the gradients the optimizer
    sees have norm min(1, clip / (norm + 1e-6)) * norm (rtol 1e-5)."""
    t = _mini_trainer(tmp_path, clip_grad_norm=0.5)
    metrics, _ = t.train_one_step(_images(4, 4, 0), None)
    norm = float(metrics["grad_norm"])
    assert norm > 0.5
    clipped = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in t.model.parameters()]))
    assert float(clipped) == pytest.approx(0.5 * norm / (norm + 1e-6), rel=1e-5)


@pytest.mark.parametrize("guard", ["skip_grad_norm", "skip_nonfinite"])
def test_skipped_steps_move_nothing(tmp_path, guard):
    """A dropped step leaves the parameters and the optimizer count as they
    were (exactly) and ticks no LR; the next good step is applied."""
    kw = {"skip_grad_norm": 1e-9} if guard == "skip_grad_norm" else {"skip_nonfinite": True}
    t = _mini_trainer(tmp_path, **kw)
    before = _params(t.model)
    bad = _images(4, 4, 1)
    if guard == "skip_nonfinite":
        bad[0, 0, 0, 0] = np.nan
    metrics, _ = t.train_one_step(bad, None)
    for a, b in zip(before, t.model.parameters()):
        assert torch.equal(a, b.detach())
    assert int(t.optimizer.count) == 0
    if guard == "skip_nonfinite":
        assert float(metrics["nonfinite_steps"]) == 1.0
        t.train_one_step(_images(4, 4, 2), None)
        assert int(t.optimizer.count) == 1
    else:
        t.train_loader = [(_images(4, 4, 2), None)] * 2
        t.interleaved_train_and_eval(1)
        lrs = _records(t.log_dir, "metrics/lr", "group_0")
        assert list(lrs.values()) == [5e-3, 5e-3] and int(t.optimizer.count) == 0


def test_grad_accumulation_equals_whole_batch(tmp_path):
    """grad_accumulation=2 steps on the whole batch's gradient (the mean of
    equal-chunk means): the loss within 1e-5 and the gradients the
    optimizer saw within atol 1e-6 + rtol 1e-6 (f32, another summation
    order). A batch
    of 3 is computed whole, exactly as without accumulation, and warns once."""
    x = _images(4, 4, 3)
    for n, grad_tol, loss_atol in ((4, 1e-6, 1e-5), (3, 0.0, 0.0)):
        whole = _mini_trainer(tmp_path / "a")
        acc = _mini_trainer(tmp_path / "b", grad_accumulation=2)
        m_whole, _ = whole.train_one_step(x[:n], None)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m_acc, _ = acc.train_one_step(x[:n], None)
            for a, b in zip(whole.model.parameters(), acc.model.parameters()):
                torch.testing.assert_close(b.grad, a.grad, rtol=grad_tol, atol=grad_tol)
            acc.train_one_step(x[:n], None)
        assert float(m_acc["loss"]) == pytest.approx(float(m_whole["loss"]), abs=loss_atol)
        ragged = [w for w in caught if "not divisible" in str(w.message)]
        assert len(ragged) == (n == 3)


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    """Train 2 epochs straight, or 1 epoch, checkpoint, and resume a fresh
    Trainer (other initial weights) for the second: the second epoch's
    losses agree within 1e-6; metrics logged after the checkpoint are
    purged; keep_checkpoints=1 leaves one file; sample grids are written."""
    data = [(_images(4, 4, 20 + i), None) for i in range(2)]
    evals = [(_images(3, 4, 30), None), (_images(1, 4, 31), None)]
    straight = _mini_trainer(tmp_path / "a", train=data, eval=evals)
    straight.interleaved_train_and_eval(2)
    first = _mini_trainer(tmp_path / "b", train=data, eval=evals, keep_checkpoints=1,
                          sample_epochs=1)
    first.interleaved_train_and_eval(1)
    with open(os.path.join(first.log_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"tag": "metrics/loss", "step": 7, "train": -1.0}) + "\n")
    resumed = _mini_trainer(tmp_path / "b", model=_mini(seed=5), train=data, eval=evals,
                            keep_checkpoints=1, sample_epochs=1)
    resumed.interleaved_train_and_eval(2)
    want, got = _records(straight.log_dir, "metrics/loss"), _records(first.log_dir, "metrics/loss")
    assert sorted(got) == [0, 1, 2, 3]
    np.testing.assert_allclose([got[s] for s in range(4)], [want[s] for s in range(4)],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_records(first.log_dir, "metrics/loss", "eval")[4],
                               _records(straight.log_dir, "metrics/loss", "eval")[4],
                               rtol=0, atol=1e-6)
    files = sorted(os.listdir(first.log_dir))
    assert [f for f in files if f.endswith(".ckpt")] == ["trainer_state_2.ckpt"]
    assert {"sample_2.npy", "sample_4.npy"} <= set(files)
    assert ckpt_utils.find_latest_epoch(first.log_dir) == 2


def test_eval_metrics_are_example_weighted(tmp_path):
    """Eval over batches of 3 and 1 logs the mean over the 4 examples, not
    the mean of the batch means (rtol 1e-6)."""
    xs = [_images(3, 4, 40), _images(1, 4, 41)]
    loss_fn = lambda x, y, preds: {"loss": image_gpt.reproduce_loss(x, y, preds),
                                   "pixels_on": x.mean()}
    t = trainer.Trainer(_mini(), loss_fn, optim.adam(1e-3), [], [(x, None) for x in xs],
                        log_dir=str(tmp_path), sample_epochs=None, use_tensorboard=False,
                        device="cpu")
    t.interleaved_train_and_eval(1)
    got = _records(t.log_dir, "metrics/pixels_on", "eval")[0]
    assert got == pytest.approx(float(np.concatenate(xs).mean()), rel=1e-6)


def test_reproduce_trains_the_reproduce_config(tmp_path):
    """reproduce() on a one-image debug loader: the reproduce() widths, one
    step and one eval with a finite loss, a checkpoint, LR 5e-3 logged."""
    t = image_gpt.reproduce(n_epochs=1, log_dir=str(tmp_path), device="cpu",
                            debug_loader=[(_images(1, 28, 50), None)])
    assert (t._step, t._epoch) == (1, 1)
    assert sum(p.numel() for p in t.model.parameters()) == sum(
        p.numel() for p in ImageGPT(**image_gpt.REPRODUCE_CONFIG, device="cpu").parameters())
    assert np.isfinite(_records(t.log_dir, "metrics/loss", "eval")[1])
    assert _records(t.log_dir, "metrics/lr", "group_0") == {0: 5e-3}
    assert os.path.exists(tmp_path / "trainer_state_1.ckpt")


@pytest.mark.parametrize("kw", [dict(n_devices=2), dict(mesh_shape=(1, 1)), dict(fsdp=True),
                                dict(compute_dtype="float16"), dict(async_checkpoint=True),
                                dict(profile_steps=(0, 1))])
def test_unported_options_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _mini_trainer(tmp_path, **kw)


def test_default_device_is_cuda_and_never_falls_back(tmp_path, monkeypatch):
    """Without CUDA, ImageGPT and Trainer raise unless asked for the CPU;
    set_default_overrides fills only arguments a call site leaves out."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageGPT(**MINI)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.Trainer(_mini(), image_gpt.reproduce_loss, optim.adam(), [], [],
                        log_dir=str(tmp_path))
    monkeypatch.setattr(trainer, "_DEFAULT_OVERRIDES", {})
    trainer.set_default_overrides(grad_accumulation=2, keep_checkpoints=None)
    assert _mini_trainer(tmp_path).grad_accumulation == 2
    assert _mini_trainer(tmp_path, grad_accumulation=1).grad_accumulation == 1
    with pytest.raises(ValueError):
        trainer.set_default_overrides(lr=1.0)


# (6) Datasets -----------------------------------------------------------------

def _write_idx(path, arr):
    header = bytes([0, 0, 8, arr.ndim]) + b"".join(
        int(n).to_bytes(4, "big") for n in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def test_datasets_match_jax(tmp_path, monkeypatch):
    """MNIST from IDX files and the synthetic loaders: the same arrays and,
    over two epochs, the same batches (exactly) as the JAX package's NumPy
    pipeline from the same seed; a missing file raises FileNotFoundError
    that names where it looked."""
    rng = np.random.default_rng(0)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for name, n in (("train", 10), ("t10k", 6)):
        _write_idx(raw / f"{name}-images-idx3-ubyte.gz", rng.integers(0, 256, (n, 28, 28)))
        _write_idx(raw / f"{name}-labels-idx1-ubyte.gz", rng.integers(0, 10, (n,)))
    monkeypatch.setenv("PGT_DATA_DIR", str(tmp_path))
    for a, b in zip(jax.tree_util.tree_leaves(jdatasets.load_mnist()),
                    jax.tree_util.tree_leaves(tdatasets.load_mnist())):
        np.testing.assert_array_equal(a, b)
    pairs = [
        (jdatasets.get_mnist_loaders(4, dynamically_binarize=True, use_native=False),
         tdatasets.get_mnist_loaders(4, dynamically_binarize=True)),
        (jdatasets.get_synthetic_mnist_loaders(4, n_train=10, n_test=6, image_size=8, seed=3),
         tdatasets.get_synthetic_mnist_loaders(4, n_train=10, n_test=6, image_size=8, seed=3)),
    ]
    for jloaders, tloaders in pairs:
        for jl, tl in zip(jloaders, tloaders):
            for _ in range(2):
                for (jx, jy), (tx, ty) in zip(jl, tl, strict=True):
                    np.testing.assert_array_equal(jx, tx)
                    np.testing.assert_array_equal(jy, ty)

    empty = tmp_path / "empty"
    monkeypatch.setattr(tdatasets, "_data_roots", lambda: [str(empty)])
    with pytest.raises(FileNotFoundError, match="empty"):
        tdatasets.load_mnist()

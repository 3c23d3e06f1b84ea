#!/usr/bin/env python3
"""Drives the PyTorch port's ImageGPT serving and training paths once on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or a few: the device (name and power limit
from nvidia-smi, TF32 pinned off); the build of every kernel of the paths
from ``pytorch_generative_tpu_torch/csrc``, one ``nvcc`` per source, all at
once; each kernel against its plain PyTorch version at the paths' shapes;
the serving path (``ImageGPT.forward`` with the reproduce() loss at batch
64, then ``ImageGPT.sample`` of 16 images) and the training path
(``Trainer`` at the reproduce() config: one epoch of 8 steps with eval, a
checkpoint and a sample grid, then a second Trainer that resumes from the
checkpoint and takes one more epoch), each with its kernels' launch counts;
the training gradients and a 3-step trajectory against the plain path on
the CPU; CUDA-event times of each kernel beside its plain version, one
PyTorch call that computes the same function (``library_ms``) and its bound;
the train step's time and a ``torch.profiler`` breakdown of it. The line
before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it fails at once.
"""

import concurrent.futures
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
SEED = 0
N_SAMPLES = 16
BATCH = 64
FLASH_TOL = 5e-5  # f32, another summation order than the dense version
# f32 too, but each gradient sums up to 784 rows or keys of p * dO or
# ds * q/k terms in another order than the dense einsum.
FLASH_BWD_TOL = 1e-4
FORWARD_TOL = 1e-4  # kernel path on the card vs plain path on the CPU
# Gradients, card kernel path vs CPU plain path, as a share of each group's
# largest gradient: f32 through 8 blocks, with the reductions of the
# attention, the GEMMs and the 784-pixel loss in other orders.
GRAD_RTOL = 1e-4
# Losses of 3 Adam steps, card vs CPU, relative: the step-1 gradients differ
# in their last bits (GRAD_RTOL), Adam's first updates are nearly
# sign(gradient) * lr, and the loss sums 784 pixels per image.
TRAJ_RTOL = 1e-4
TRAJ_BATCH = 8
# Bounds: NVIDIA's H100 SXM data sheet, at its 700 W limit.
F32_FLOPS = 67e12   # f32 on the CUDA cores, FMA = 2 operations
HBM_BYTES = 3.35e12  # HBM3 bytes/s


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def max_err(a, b):
    """Max abs difference; equal infinities (lse of fully-masked rows) count 0."""
    same_inf = torch.isinf(a) & (a == b)
    diff = (a - b).abs().masked_fill(same_inf, 0.0)
    return float(diff.max())


def time_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    """(least ms, what binds): operations at the f32 rate vs bytes moved
    once at the HBM rate."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(b, l, n_heads, d, mask_center, n_products):
    """FLOPs of n_products (L x L x d) products over the causal pairs."""
    pairs = l * (l - 1) // 2 if mask_center else l * (l + 1) // 2
    return 2 * n_products * d * pairs * b * n_heads


def sampler_flops(n, h, w, n_blocks, c):
    """Multiply-adds of the raster scan: per position the 4 conv taps and
    the head, per block QKV, out proj and MLP (24 C^2) and attention over
    the i + 1 cached positions (4 C (i + 1))."""
    seq = h * w
    per_block = 24 * c * c * seq + 2 * c * seq * (seq + 1)
    return n * (n_blocks * per_block + seq * 10 * c)


def sampler_latency_floor_ms(h, w, n_blocks):
    """A rough floor from the sampler's dependency chain, not a measurement:
    per position and block 13 dependent phases (two LayerNorms of two
    reductions each, the QKV matvec, the scores, the softmax's max and sum,
    PV, the out proj, two MLP matvecs), each at least one L2 round trip and
    one CTA barrier, taken as 0.3 us at the card's ~1.7 GHz."""
    return h * w * n_blocks * 13 * 0.3e-3


def nudged_uniforms(model, canvas_sample, u, cond):
    """Moves every uniform within 1e-3 of sigmoid(teacher-forced logit) 2e-3
    away from it, on the side it was on, so that float-order differences
    between two samplers cannot flip a pixel."""
    with torch.no_grad():
        p = torch.sigmoid(model(canvas_sample)).reshape(u.shape[1], -1).T[..., None]
    d = u - p
    near = (d.abs() < 1e-3) & (cond.reshape(u.shape[1], -1).T[..., None] < 0)
    side = torch.where(d >= 0, 1.0, -1.0)
    return torch.where(near, (p + 2e-3 * side).clamp(0.0, 1.0), u), int(near.sum())


def read_losses(log_dir):
    """{step: train loss} from a Trainer's metrics.jsonl (last record wins)."""
    losses, counts = {}, {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "metrics/loss" and "train" in rec:
                losses[rec["step"]] = rec["train"]
                counts[rec["step"]] = counts.get(rec["step"], 0) + 1
    return losses, counts


def param_group(name):
    """pos, input_conv, attn, ln (every LayerNorm), mlp or out_conv."""
    parts = name.split(".")
    part = parts[2] if parts[0] == "blocks" else parts[0]
    return {"ln1": "ln", "ln2": "ln", "mlp_conv1": "mlp", "mlp_conv2": "mlp"}.get(part, part)


def main():
    # Phase 1: device.
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from pytorch_generative_tpu_torch import datasets, optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
    from pytorch_generative_tpu_torch.ops import _build, attention_cuda, decode_cuda, sampling

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # Phase 2: build every kernel of the paths from the checkout's sources,
    # one nvcc per source, all started together.
    names = (attention_cuda.KERNEL, attention_cuda.BWD_KERNEL, decode_cuda.KERNEL)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        _build.load(name)
        ptxas = [ln.strip() for ln in paths[name].with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"phase build: {name}; ptxas: {' | '.join(ptxas)}", flush=True)
    print(f"phase build: all kernels {time.perf_counter() - t0:.1f}s", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    cfg = image_gpt.REPRODUCE_CONFIG
    h, w, _ = cfg["in_shape"]
    n_heads = cfg["n_attention_heads"]
    c = cfg["n_embedding_channels"]
    n_blocks = cfg["n_transformer_blocks"]
    d = c // n_heads

    # Phase 3: the flash kernels against their plain versions at the path's
    # shapes: q and k/v as the layer passes them (k, v feature slices of one
    # kv tensor), the backward from the forward's own out and lse.
    flash_err = bwd_err = 0.0
    for l, mask_center in ((h * w, False), (h * w, True), (200, True)):
        q = torch.randn((BATCH, l, c), generator=gen).to(dev)
        kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev)
        dout = torch.randn((BATCH, l, c), generator=gen).to(dev)
        k, v = kv[..., :c], kv[..., c:]
        out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
        ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, n_heads)
        grads = attention_cuda.flash_backward(q, k, v, out, lse, dout, mask_center, n_heads)
        ref_grads = attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, mask_center,
                                                        n_heads)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        e_grads = [max_err(g, r) for g, r in zip(grads, ref_grads)]
        flash_err = max(flash_err, e_out)
        bwd_err = max(bwd_err, *e_grads)
        print(f"phase flash: L={l} mask_center={mask_center} max_abs_err out={e_out:.3e} "
              f"lse={e_lse:.3e} (tol {FLASH_TOL}); backward dq={e_grads[0]:.3e} "
              f"dk={e_grads[1]:.3e} dv={e_grads[2]:.3e} (tol {FLASH_BWD_TOL})", flush=True)
        check(e_out <= FLASH_TOL and e_lse <= FLASH_TOL, "flash forward kernel disagrees")
        check(max(e_grads) <= FLASH_BWD_TOL, "flash backward kernel disagrees")
        if mask_center:
            check(bool((out[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all()),
                  "row 0 under mask_center is not exactly 0 with lse -inf")
            check(bool((grads[0][:, 0] == 0).all()),
                  "row 0 under mask_center has a non-zero dq")

    # The model of the serving path: reproduce() widths, random seeded
    # weights, a non-zero positional embedding.
    model = ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape, generator=gen))
    model.eval()

    # Phase 4: the sampler kernel against its plain version, n = 16, free
    # and inpainted.
    def sampler_inputs(cond, u):
        return sampling.sample_loop_inputs(model, cond, u)

    def to_image(canvas):
        return sampling.canvas_to_images(canvas, h, w)

    free = -torch.ones((N_SAMPLES, h, w, 1), device=dev)
    sample_err = 0.0
    for mode in ("free", "inpaint"):
        cond = free.clone()
        if mode == "inpaint":
            cond[:, : h // 2] = (torch.rand((N_SAMPLES, h // 2, w, 1), generator=gen) < 0.3).float().to(dev)
        u = torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev)
        plain = to_image(decode_cuda.sample_loop_plain(*sampler_inputs(cond, u)))
        u, n_nudged = nudged_uniforms(model, plain, u, cond)
        plain = to_image(decode_cuda.sample_loop_plain(*sampler_inputs(cond, u)))
        kern = to_image(decode_cuda.fused_sample_loop(*sampler_inputs(cond, u)))
        torch.cuda.synchronize()
        mismatched = int((kern != plain).sum())
        sample_err = max(sample_err, float((kern - plain).abs().max()))
        kept = bool((kern[:, : h // 2] == cond[:, : h // 2]).all()) if mode == "inpaint" else True
        print(f"phase sampler: {mode} n={N_SAMPLES} nudged={n_nudged} mismatched_pixels={mismatched} "
              f"kept_pixels_ok={kept}", flush=True)
        check(mismatched == 0 and kept, f"sampler kernel disagrees ({mode})")

    def reset_counts():
        attention_cuda.launches = attention_cuda.bwd_launches = decode_cuda.launches = 0

    def read_counts():
        return {attention_cuda.KERNEL: attention_cuda.launches,
                attention_cuda.BWD_KERNEL: attention_cuda.bwd_launches,
                decode_cuda.KERNEL: decode_cuda.launches}

    # Phase 5: the serving path through the entry points a user calls.
    x = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.3).float().to(dev)
    sample_gen = torch.Generator().manual_seed(SEED + 1)
    reset_counts()
    with torch.no_grad():
        logits = model(x)
        loss = image_gpt.reproduce_loss(x, None, logits)
        samples = model.sample(n_samples=N_SAMPLES, generator=sample_gen)
    torch.cuda.synchronize()
    serve_counts = read_counts()
    nll = float(loss)
    binary = bool(((samples == 0) | (samples == 1)).all())
    print(f"phase serve: forward logits {tuple(logits.shape)} nll={nll:.4f} nats/image; "
          f"samples {tuple(samples.shape)} binary={binary} mean={float(samples.mean()):.4f}; "
          f"launches={serve_counts}", flush=True)
    check(logits.shape == (BATCH, h, w, 1) and bool(torch.isfinite(logits).all()), "bad logits")
    check(torch.isfinite(loss).item(), "non-finite NLL")
    check(samples.shape == (N_SAMPLES, h, w, 1) and binary, "samples are not binary (16, 28, 28, 1)")
    check(serve_counts[attention_cuda.KERNEL] > 0 and serve_counts[decode_cuda.KERNEL] > 0,
          f"a kernel of the serving path never launched: {serve_counts}")
    # The kernel path agrees with the same model's plain path on the CPU.
    cpu_model = ImageGPT(**cfg, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        ref = cpu_model(x[:2].cpu())
    fwd_err = float((logits[:2].cpu() - ref).abs().max())
    print(f"phase serve: forward vs plain CPU forward max_abs_err={fwd_err:.3e} (tol {FORWARD_TOL})",
          flush=True)
    check(fwd_err <= FORWARD_TOL, "forward disagrees with the plain CPU forward")
    check(sampling._whole_loop_eligible(model), "reproduce model not covered by the sampler")

    # Phase 6: the training path through the entry points a user calls:
    # reproduce()'s model, optimizer and loss on seeded synthetic MNIST.
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def new_trainer(seed):
            train_loader, test_loader = datasets.get_synthetic_mnist_loaders(
                BATCH, n_train=8 * BATCH, n_test=2 * BATCH, image_size=h, seed=0)
            net = ImageGPT(**cfg, generator=torch.Generator().manual_seed(seed), device=dev)
            return trainer.Trainer(
                net, image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977),
                train_loader, test_loader, log_dir=log_dir, sample_epochs=1,
                use_tensorboard=False, device=dev)

        first = new_trainer(SEED)
        reset_counts()
        first.interleaved_train_and_eval(1)
        # A fresh model from another seed: only the checkpoint makes it resume.
        second = new_trainer(SEED + 7)
        second.interleaved_train_and_eval(2)
        torch.cuda.synchronize()
        train_counts = read_counts()
        losses, counts = read_losses(log_dir)
        files = sorted(os.listdir(log_dir))
        print(f"phase train: steps {first._step} + {second._step - first._step}, "
              f"losses {[round(losses[s], 3) for s in sorted(losses)]}; files {files}; "
              f"launches={train_counts}", flush=True)
        check(train_counts[attention_cuda.BWD_KERNEL] >= 2 * 8 * n_blocks,
              f"flash_bwd launched {train_counts[attention_cuda.BWD_KERNEL]} < 2 x 8 x "
              f"{n_blocks} times")
        check(all(train_counts[k] > 0 for k in names), f"a kernel never launched: {train_counts}")
        check(sorted(losses) == list(range(16)) and set(counts.values()) == {1},
              "the resumed Trainer did not start at step 8")
        check(all(math.isfinite(v) for v in losses.values()), "non-finite loss")
        check(second._step == 16 and second._epoch == 2, "second epoch not taken")
        for name in ("trainer_state_1.ckpt", "trainer_state_2.ckpt", "sample_8.npy",
                     "sample_16.npy"):
            check(name in files, f"{name} was not written")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # Phase 7: gradients at full width, batch 2, the card's kernel path vs
    # the CPU plain path of the same weights, per parameter group.
    xg = x[:2]
    image_gpt.reproduce_loss(xg, None, model(xg)).backward()
    image_gpt.reproduce_loss(xg.cpu(), None, cpu_model(xg.cpu())).backward()
    grad_errs, grad_scales = {}, {}
    for (name, p), (_, pc) in zip(model.named_parameters(), cpu_model.named_parameters()):
        group = param_group(name)
        grad_errs[group] = max(grad_errs.get(group, 0.0), float((p.grad.cpu() - pc.grad).abs().max()))
        grad_scales[group] = max(grad_scales.get(group, 0.0), float(pc.grad.abs().max()))
    print("phase grads: max_abs_err per group (max |grad|): " + ", ".join(
        f"{g}={grad_errs[g]:.3e} ({grad_scales[g]:.3e})" for g in grad_errs)
        + f" (tol {GRAD_RTOL} x max |grad|)", flush=True)
    check(all(grad_errs[g] <= GRAD_RTOL * grad_scales[g] for g in grad_errs),
          "card gradients disagree with the CPU plain path")

    # Phase 8: 3 Adam steps on the card and on the CPU, same weights and
    # batches; the losses agree.
    batches = [(torch.rand((TRAJ_BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
               for _ in range(3)]
    traj = {}
    for (where, net), key in zip(((dev, model), ("cpu", cpu_model)), ("card", "cpu")):
        t = trainer.Trainer(net, image_gpt.reproduce_loss,
                            optim.adam_multiplicative(5e-3, 0.999977), [], [],
                            log_dir=tempfile.mkdtemp(prefix="chip_smoke_traj_"),
                            use_tensorboard=False, device=where)
        traj[key] = [float(t.train_one_step(xb, None)[0]["loss"]) for xb in batches]
        shutil.rmtree(t.log_dir, ignore_errors=True)
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj["card"], traj["cpu"]))
    print(f"phase trajectory: losses card {traj['card']} cpu {traj['cpu']} "
          f"max rel err {traj_err:.3e} (tol {TRAJ_RTOL})", flush=True)
    check(traj_err <= TRAJ_RTOL, "3-step trajectory disagrees with the CPU")

    # Phase 9: times, CUDA events around warmed-up runs, at the paths' shapes.
    l = h * w
    q = torch.randn((BATCH, l, c), generator=gen).to(dev)
    kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev)
    dout = torch.randn((BATCH, l, c), generator=gen).to(dev)
    k, v = kv[..., :c], kv[..., c:]
    out, lse = attention_cuda.flash_forward(q, k, v, False, n_heads)
    q4, k4, v4 = (attention_cuda._unpack(t, n_heads).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    dout4 = attention_cuda._unpack(dout, n_heads).contiguous()
    fwd = lambda: attention_cuda.flash_forward(q, k, v, False, n_heads)
    fwd_plain = lambda: attention_cuda.flash_forward_plain(q, k, v, False, n_heads)

    def fwd_lib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    bwd = lambda: attention_cuda.flash_backward(q, k, v, out, lse, dout, False, n_heads)
    bwd_plain = lambda: attention_cuda.flash_backward_plain(q, k, v, out, lse, dout, False,
                                                            n_heads)
    bwd_lib = lambda: torch.autograd.grad(sdpa_out, (q4, k4, v4), dout4, retain_graph=True)
    times = {}
    for key, fn, iters in (("fwd_plain", fwd_plain, 10), ("fwd", fwd, 20), ("fwd_lib", fwd_lib, 20),
                           ("bwd_plain", bwd_plain, 5), ("bwd", bwd, 20), ("bwd_lib", bwd_lib, 20),
                           ("fwd2", fwd, 20), ("bwd2", bwd, 20)):
        times[key] = time_ms(fn, iters, 2)
    inputs = sampler_inputs(free, torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev))
    times["sample"] = time_ms(lambda: decode_cuda.fused_sample_loop(*inputs), 3, 1)
    times["sample_plain"] = time_ms(lambda: decode_cuda.sample_loop_plain(*inputs), 1, 1)

    fwd_bound = bound(flash_work(BATCH, l, n_heads, d, False, 2),
                      4 * (4 * BATCH * l * c + BATCH * n_heads * l))
    bwd_bound = bound(flash_work(BATCH, l, n_heads, d, False, 5),
                      4 * (8 * BATCH * l * c + BATCH * n_heads * l))
    weight_bytes = 4 * sum(t.numel() for t in inputs[3].values())
    sample_bound = bound(sampler_flops(N_SAMPLES, h, w, n_blocks, c),
                         weight_bytes + 4 * (2 * inputs[0].numel() + inputs[2].numel()))
    print(f"phase times [{smi}]: flash_fwd (B={BATCH}, L={l}, H={n_heads}, d={d}) "
          f"kernel {times['fwd']:.4f}/{times['fwd2']:.4f} ms, plain {times['fwd_plain']:.4f} ms, "
          f"causal SDPA {times['fwd_lib']:.4f} ms, bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); "
          f"flash_bwd kernel {times['bwd']:.4f}/{times['bwd2']:.4f} ms, "
          f"plain {times['bwd_plain']:.4f} ms, SDPA autograd.grad {times['bwd_lib']:.4f} ms, "
          f"bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]}); "
          f"sample_loop n={N_SAMPLES} kernel {times['sample']:.2f} ms "
          f"({N_SAMPLES * 1000 / times['sample']:.2f} img/s), plain {times['sample_plain']:.2f} ms "
          f"({N_SAMPLES * 1000 / times['sample_plain']:.2f} img/s), bound "
          f"{sample_bound[0]:.4f} ms ({sample_bound[1]}), latency floor estimate "
          f"{sampler_latency_floor_ms(h, w, n_blocks):.1f} ms", flush=True)

    # Phase 10: the train step at batch 64 (Trainer.train_one_step, H2D copy
    # of the batch included), then a profile of 3 steps by kernel.
    step_trainer = trainer.Trainer(
        ImageGPT(**cfg, generator=torch.Generator().manual_seed(SEED), device=dev),
        image_gpt.reproduce_loss, optim.adam_multiplicative(5e-3, 0.999977), [], [],
        log_dir=tempfile.mkdtemp(prefix="chip_smoke_step_"), use_tensorboard=False, device=dev)
    xb = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.13).float().numpy()
    step_ms = time_ms(lambda: step_trainer.train_one_step(xb, None), 10, 3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step_trainer.train_one_step(xb, None)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - wall0) * 1e3
    shutil.rmtree(step_trainer.log_dir, ignore_errors=True)
    # Kernel rows only: user annotations (Optimizer.step) also carry a
    # device range and would count its kernels twice.
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 3
    bwd_ms = sum(r[1] for r in rows if "flash_bwd" in r[0]) / 3
    # The profiler slows the host, so the idle share is taken against the
    # unprofiled step time.
    print(f"phase step [{smi}]: train step batch {BATCH} {step_ms:.3f} ms "
          f"({BATCH * 1000 / step_ms:.1f} samples/s); profiled (3 steps, "
          f"{window_ms / 3:.3f} ms/step under the profiler): kernel time {device_ms:.3f} "
          f"ms/step, device idle {100 * (1 - device_ms / step_ms):.1f}% of the unprofiled "
          f"step; flash_bwd {bwd_ms:.3f} ms/step ({100 * bwd_ms / device_ms:.1f}% of "
          f"kernel time)", flush=True)
    for key, ms, count in rows[:12]:
        print(f"phase step:   {ms / 3:9.4f} ms/step {count // 3:4d} launches/step  {key[:110]}",
              flush=True)

    print(json.dumps({"kernels": [
        {"name": attention_cuda.KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "pytorch_generative_tpu/ops/attention_pallas.py:100",
         "launches": serve_counts[attention_cuda.KERNEL] + train_counts[attention_cuda.KERNEL],
         "max_abs_err": flash_err, "ms": times["fwd"], "plain_ms": times["fwd_plain"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": times["fwd_lib"]},
        {"name": attention_cuda.BWD_KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "pytorch_generative_tpu/ops/attention_pallas.py:205",
         "launches": serve_counts[attention_cuda.BWD_KERNEL] + train_counts[attention_cuda.BWD_KERNEL],
         "max_abs_err": bwd_err, "ms": times["bwd"], "plain_ms": times["bwd_plain"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": times["bwd_lib"]},
        {"name": decode_cuda.KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/sample_loop.cu",
         "replaces": "pytorch_generative_tpu/ops/decode_pallas.py:257",
         "launches": serve_counts[decode_cuda.KERNEL] + train_counts[decode_cuda.KERNEL],
         "max_abs_err": sample_err, "ms": times["sample"], "plain_ms": times["sample_plain"],
         "bound_ms": sample_bound[0], "bound_by": sample_bound[1], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

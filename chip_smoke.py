#!/usr/bin/env python3
"""Drives the PyTorch port's ImageGPT serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line: the device (name and power limit from
nvidia-smi, TF32 pinned off); the build of every kernel of the path from
``pytorch_generative_tpu_torch/csrc``; each kernel against its plain
PyTorch version at the path's shapes; the main path (``ImageGPT.forward``
with the reproduce() loss at batch 64, then ``ImageGPT.sample`` of 16
images) with each kernel's launch count; and CUDA-event times of each kernel
beside its plain version. The line before the last is the per-kernel JSON
summary; the last line is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before that line; without a CUDA device it fails at once.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
SEED = 0
N_SAMPLES = 16
BATCH = 64
FLASH_TOL = 5e-5  # f32, another summation order than the dense version
FORWARD_TOL = 1e-4  # kernel path on the card vs plain path on the CPU


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


def main():
    # Phase 1: device.
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
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

    # Phase 2: build every kernel of the path from the checkout's sources.
    built = {}
    for name in (attention_cuda.KERNEL, decode_cuda.KERNEL):
        t0 = time.perf_counter()
        path = _build.build(name)
        _build.load(name)
        built[name] = time.perf_counter() - t0
        ptxas = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"phase build: {name} {built[name]:.1f}s; ptxas: {' | '.join(ptxas)}", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    cfg = image_gpt.REPRODUCE_CONFIG
    h, w, _ = cfg["in_shape"]
    n_heads = cfg["n_attention_heads"]
    c = cfg["n_embedding_channels"]

    # Phase 3: kernel 1 against its plain version at the path's shapes: q and
    # k/v as the layer passes them (k, v feature slices of one kv tensor).
    flash_err = 0.0
    for l, mask_center in ((h * w, False), (h * w, True), (200, True)):
        q = torch.randn((BATCH, l, c), generator=gen).to(dev)
        kv = torch.randn((BATCH, l, 2 * c), generator=gen).to(dev)
        k, v = kv[..., :c], kv[..., c:]
        out, lse = attention_cuda.flash_forward(q, k, v, mask_center, n_heads)
        ref_out, ref_lse = attention_cuda.flash_forward_plain(q, k, v, mask_center, n_heads)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        flash_err = max(flash_err, e_out)
        print(f"phase flash: L={l} mask_center={mask_center} max_abs_err out={e_out:.3e} "
              f"lse={e_lse:.3e} (tol {FLASH_TOL})", flush=True)
        check(e_out <= FLASH_TOL and e_lse <= FLASH_TOL, "flash kernel disagrees")
        if mask_center:
            check(bool((out[:, 0] == 0).all()) and bool(torch.isneginf(lse[:, :, 0]).all()),
                  "row 0 under mask_center is not exactly 0 with lse -inf")

    # The model of the main path: reproduce() widths, random seeded weights,
    # a non-zero positional embedding.
    model = ImageGPT(**cfg, generator=gen)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape, generator=gen))
    model = model.to(dev).eval()

    # Phase 4: kernel 2 against its plain version, n = 16, free and inpainted.
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

    # Phase 5: the main path through the entry points a user calls.
    x = (torch.rand((BATCH, h, w, 1), generator=gen) < 0.3).float().to(dev)
    sample_gen = torch.Generator().manual_seed(SEED + 1)
    attention_cuda.launches = 0
    decode_cuda.launches = 0
    with torch.no_grad():
        logits = model(x)
        loss = image_gpt.reproduce_loss(x, logits)
        samples = model.sample(n_samples=N_SAMPLES, generator=sample_gen)
    torch.cuda.synchronize()
    counts = {attention_cuda.KERNEL: attention_cuda.launches, decode_cuda.KERNEL: decode_cuda.launches}
    nll = float(loss)
    binary = bool(((samples == 0) | (samples == 1)).all())
    print(f"phase main: forward logits {tuple(logits.shape)} nll={nll:.4f} nats/image; "
          f"samples {tuple(samples.shape)} binary={binary} mean={float(samples.mean()):.4f}; "
          f"launches={counts}", flush=True)
    check(logits.shape == (BATCH, h, w, 1) and bool(torch.isfinite(logits).all()), "bad logits")
    check(torch.isfinite(loss).item(), "non-finite NLL")
    check(samples.shape == (N_SAMPLES, h, w, 1) and binary, "samples are not binary (16, 28, 28, 1)")
    check(all(n > 0 for n in counts.values()), f"a kernel of the path never launched: {counts}")
    # The kernel path agrees with the same model's plain path on the CPU.
    cpu_model = ImageGPT(**cfg)
    cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    with torch.no_grad():
        ref = cpu_model(x[:2].cpu())
    fwd_err = float((logits[:2].cpu() - ref).abs().max())
    print(f"phase main: forward vs plain CPU forward max_abs_err={fwd_err:.3e} (tol {FORWARD_TOL})",
          flush=True)
    check(fwd_err <= FORWARD_TOL, "forward disagrees with the plain CPU forward")
    check(sampling._whole_loop_eligible(model), "reproduce model not covered by the sampler")

    # Phase 6: times, CUDA events around warmed-up runs.
    q = torch.randn((BATCH, h * w, c), generator=gen).to(dev)
    kv = torch.randn((BATCH, h * w, 2 * c), generator=gen).to(dev)
    k, v = kv[..., :c], kv[..., c:]
    flash_plain_ms = time_ms(lambda: attention_cuda.flash_forward_plain(q, k, v, False, n_heads), 10, 2)
    flash_ms = time_ms(lambda: attention_cuda.flash_forward(q, k, v, False, n_heads), 20, 3)
    flash_plain_ms2 = time_ms(lambda: attention_cuda.flash_forward_plain(q, k, v, False, n_heads), 10, 1)
    inputs = sampler_inputs(free, torch.rand((h * w, N_SAMPLES, 1), generator=gen).to(dev))
    sample_ms = time_ms(lambda: decode_cuda.fused_sample_loop(*inputs), 3, 1)
    sample_plain_ms = time_ms(lambda: decode_cuda.sample_loop_plain(*inputs), 1, 1)
    print(f"phase times [{smi}]: flash_fwd (B={BATCH}, L={h * w}, H={n_heads}, d={c // n_heads}) "
          f"kernel {flash_ms:.4f} ms, plain {flash_plain_ms:.4f}/{flash_plain_ms2:.4f} ms; "
          f"sample_loop n={N_SAMPLES} kernel {sample_ms:.2f} ms "
          f"({N_SAMPLES * 1000 / sample_ms:.2f} img/s), plain {sample_plain_ms:.2f} ms "
          f"({N_SAMPLES * 1000 / sample_plain_ms:.2f} img/s)", flush=True)

    print(json.dumps({"kernels": [
        {"name": attention_cuda.KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "pytorch_generative_tpu/ops/attention_pallas.py:100",
         "launches": counts[attention_cuda.KERNEL], "max_abs_err": flash_err,
         "ms": flash_ms, "plain_ms": flash_plain_ms},
        {"name": decode_cuda.KERNEL, "route": "cuda",
         "source": "pytorch_generative_tpu_torch/csrc/sample_loop.cu",
         "replaces": "pytorch_generative_tpu/ops/decode_pallas.py:257",
         "launches": counts[decode_cuda.KERNEL], "max_abs_err": sample_err,
         "ms": sample_ms, "plain_ms": sample_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Times the PyTorch port's flash kernels of one checkout of this repository
on a CUDA card, so that two checkouts can be compared in one run:

    python3 tools/torch_flash_times.py CHECKOUT LABEL [--dump FILE] [--steps]
    python3 tools/torch_flash_times.py --compare FILE_A FILE_B

CHECKOUT is the root of a checkout (its ``pytorch_generative_tpu_torch`` is
imported, and its kernels built there); LABEL names it in the output. Prints
one line of forward and backward ms (CUDA events, 20 calls after 3
warm-ups) at ImageGPT's (B 64, L 784) with (H 2, d 32), (H 8, d 64) and
(H 4, d 128), and at PixelSNAIL's (B 128, L 784, H 1, d_k 4, d_v 32,
mask_center); one line of the fused attention block's forward ms at (B 64,
L 784) for C 64 / 2 heads, C 512 / 8 and C 512 / 4, and of its projection
stage (two products, x (B L, C) by wq (C, C) and wkv (C, 2C)) at C 512;
then the registers and spills of the checkout's flash forward, flash
backward and block kernels (their nvcc -Xptxas -v logs). Run two checkouts
in turns (A, B, B, A) in one process tree on one card. ``--dump`` also
saves the forward's out and lse and the backward's dq, dk and dv for every
(d_k, d_v) the checkout builds, at (B 4, L 200, H 2), and the fused
attention block's y, attn and lse at (B 2, L 200) for C 64 / 2 heads, C
512 / 8 and C 512 / 4, with and without mask_center, with the block's
plain version on the same inputs, from inputs made from one seed;
``--compare`` says, for the entries two dumps share, whether they are
equal bit for bit, and holds each dump's block outputs against its plain
version at ``chip_smoke.py``'s gates (y and attn 1e-4 of the largest
magnitude, lse 5e-5): the block's bits are not kept from one design to
the next, only its gates. ``--steps`` also times the
checkout's ImageGPT train step (``Trainer.train_one_step``, batch 64, 5
steps after 3 warm-ups, CUDA events) at the reproduce() config (C = 64, 2
heads) and at C = 512 with 8 and with 4 heads, TF32 off.
"""

import argparse
import shutil
import sys
import tempfile

# (batch, heads, d_k, d_v, mask_center) of the timed shapes, all at L = 784.
SHAPES = ((64, 2, 32, 32, False), (64, 8, 64, 64, False), (64, 4, 128, 128, False),
          (128, 1, 4, 32, True))
# (C, heads) of the fused attention block; its gates against its plain
# version (chip_smoke.py's BLOCK_RTOL and BLOCK_LSE_TOL).
BLOCK_WIDTHS = ((64, 2), (512, 8), (512, 4))
BLOCK_RTOL, BLOCK_LSE_TOL = 1e-4, 5e-5


def _pairs(ac):
    return getattr(ac, "HEAD_DIM_PAIRS", None) or [(d, d) for d in ac.HEAD_DIMS]


def _ptxas(ac, kernel):
    """'entry: N registers, spills' of each entry function in one kernel
    library's build log."""
    log = ac._build.library_path(kernel).with_suffix(".log").read_text()
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], "spills not reported"
        elif "spill stores" in ln and name:
            spills = ln.split("bytes stack frame,")[-1].strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers, {spills}")
            name = None
    return out


def _operands(b, l, h, d_k, d_v, seed, dev):
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, l, h * d_k), generator=g).to(dev)
    kv = torch.randn((b, l, h * (d_k + d_v)), generator=g).to(dev)
    do = torch.randn((b, l, h * d_v), generator=g).to(dev)
    return q, kv[..., :h * d_k], kv[..., h * d_k:], do


def main(checkout, label, dump=None, steps=False):
    sys.path.insert(0, checkout)
    import torch

    from pytorch_generative_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def time_ms(fn, n=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    out = []
    for b, h, d_k, d_v, mask_center in SHAPES:
        q, k, v, do = _operands(b, 784, h, d_k, d_v, 0, dev)
        o, lse = ac.flash_forward(q, k, v, mask_center, h)
        f = time_ms(lambda: ac.flash_forward(q, k, v, mask_center, h))
        bw = time_ms(lambda: ac.flash_backward(q, k, v, o, lse, do, mask_center, h))
        out.append(f"(B {b}, H {h}, d {d_k}/{d_v}{', mask_center' if mask_center else ''}): "
                   f"fwd {f:.4f} ms bwd {bw:.4f} ms")
    print(f"flash times {label} ({ac.__file__}): " + "; ".join(out), flush=True)
    print(f"block times {label}: " + "; ".join(block_times(dev, time_ms)), flush=True)
    for kernel in (ac.KERNEL, ac.BWD_KERNEL, "attn_block_fwd"):
        print(f"{kernel} ptxas {label}: " + " | ".join(_ptxas(ac, kernel)), flush=True)
    if dump:
        results = {}
        for d_k, d_v in _pairs(ac):
            q, k, v, do = _operands(4, 200, 2, d_k, d_v, d_k * 1000 + d_v, dev)
            for mask_center in (False, True):
                o, lse = ac.flash_forward(q, k, v, mask_center, 2)
                grads = ac.flash_backward(q, k, v, o, lse, do, mask_center, 2)
                results[f"{d_k}x{d_v} mask_center={mask_center}"] = dict(
                    zip(("out", "lse", "dq", "dk", "dv"), (t.cpu() for t in (o, lse, *grads))))
        results.update(_block_outputs(dev))
        torch.save(results, dump)
    if steps:
        print(f"train steps {label}: " + "; ".join(
            f"{name} {ms:.3f} ms" for name, ms in step_times(dev, time_ms)), flush=True)


def _block_operands(b, l, c, seed, dev):
    """x (B, L, C) and the block's seeded weights wq, bq, wkv, bkv, wo, bo."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, l, c), generator=g)
    ws = [torch.randn(shape, generator=g) * s for shape, s in (
        ((c, c), c ** -0.5), ((c,), 0.1), ((c, 2 * c), c ** -0.5), ((2 * c,), 0.1),
        ((c, c), c ** -0.5), ((c,), 0.1))]
    return [t.to(dev) for t in (x, *ws)]


def _block_outputs(dev):
    """{entry: {name: tensor}} of the fused attention block's forward and,
    under "plain " names, of its plain version on the same inputs."""
    from pytorch_generative_tpu_torch.ops import attn_block_cuda

    out = {}
    for c, h in BLOCK_WIDTHS:
        ops = _block_operands(2, 200, c, c + h, dev)
        for mask_center in (False, True):
            got = attn_block_cuda.attention_block_forward(*ops, mask_center, h)
            want = attn_block_cuda.attention_block_plain(*ops, mask_center, h)
            out[f"block C={c} H={h} mask_center={mask_center}"] = {
                **{name: t.cpu() for name, t in zip(("y", "attn", "lse"), got)},
                **{f"plain {name}": t.cpu() for name, t in zip(("y", "attn", "lse"), want)}}
    return out


def block_times(dev, time_ms):
    """'shape: ms' of the block's forward at (B 64, L 784) at each width,
    and of its projection stage at C = 512."""
    from pytorch_generative_tpu_torch.ops import attn_block_cuda

    out = []
    for c, h in BLOCK_WIDTHS:
        ops = _block_operands(64, 784, c, 0, dev)
        ms = time_ms(lambda: attn_block_cuda.attention_block_forward(*ops, False, h), n=10)
        out.append(f"(C {c}, H {h}) {ms:.4f} ms")
        if (c, h) == (512, 8):
            ms = time_ms(lambda: attn_block_cuda.project(*ops[:5]), n=10)
            out.append(f"projection (C {c}) {ms:.4f} ms")
        del ops
    return out


def step_times(dev, time_ms):
    """(config name, ms) of one ImageGPT train step at batch 64 per config."""
    import torch

    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt

    g = torch.Generator().manual_seed(0)
    out = []
    for name, cfg in (("C=64 H=2", image_gpt.REPRODUCE_CONFIG),
                      ("C=512 H=8", image_gpt.LARGE_CONFIG),
                      ("C=512 H=4", dict(image_gpt.LARGE_CONFIG, n_attention_heads=4))):
        model = ImageGPT(**cfg, generator=g, device=dev)
        t = trainer.Trainer(model, image_gpt.reproduce_loss,
                            optim.adam_multiplicative(5e-3, 0.999977), [], [],
                            log_dir=tempfile.mkdtemp(prefix="flash_times_"),
                            use_tensorboard=False, device=dev)
        h, w, _ = cfg["in_shape"]
        xb = (torch.rand((64, h, w, 1), generator=g) < 0.13).float().numpy()
        out.append((name, time_ms(lambda: t.train_one_step(xb, None), n=5)))
        shutil.rmtree(t.log_dir, ignore_errors=True)
        del model, t
    return out


def _within_gates(entry):
    """'y e/m, attn e/m, lse e: ok' of a dump's block outputs against its
    plain version (e the largest error, m the plain's largest magnitude)."""
    import torch

    parts, ok = [], True
    for name in ("y", "attn", "lse"):
        got, want = entry[name], entry[f"plain {name}"]
        finite = torch.isfinite(want)
        ok &= torch.equal(torch.isfinite(got), finite)
        err = float((got - want)[finite].abs().max())
        scale = float(want[finite].abs().max())
        ok &= err <= (BLOCK_LSE_TOL if name == "lse" else BLOCK_RTOL * scale)
        parts.append(f"{name} {err:.3e}" + ("" if name == "lse" else f" of {scale:.3e}"))
    return ", ".join(parts) + (" (within the gates)" if ok else " (OUTSIDE THE GATES)")


def compare(file_a, file_b):
    import torch

    a, b = torch.load(file_a), torch.load(file_b)
    for key in sorted(set(a) & set(b)):
        names = [name for name in a[key] if not name.startswith("plain ")]
        same = [name for name in names if torch.equal(a[key][name], b[key][name])]
        note = "" if len(same) == len(names) else " (DIFFER)"
        if key.startswith("block") and note:
            note = (" (changed by design); against the plain version: A "
                    f"{_within_gates(a[key])}; B {_within_gates(b[key])}")
        print(f"bits {key}: equal {', '.join(same) or 'none'} of {len(names)} outputs{note}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        parser = argparse.ArgumentParser()
        parser.add_argument("checkout")
        parser.add_argument("label")
        parser.add_argument("--dump")
        parser.add_argument("--steps", action="store_true")
        args = parser.parse_args()
        main(args.checkout, args.label, args.dump, args.steps)

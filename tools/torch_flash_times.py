"""Times the PyTorch port's flash, fused attention block and fused MLP
kernels of one checkout of this repository on a CUDA card, so that two
checkouts can be compared in one run:

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
one line of the fused MLP's ms (rows 6a-6d of PERF.md: the forward and the
saved-y, recompute and pipelined backwards, 5 calls after 3) at R 50,176
(ImageGPT's B L at batch 64) for C 512 and 1024 (F = 4C), beside the
composition F.layer_norm -> addmm -> F.gelu -> addmm -> + x and
autograd.grad through it; then the registers and spills of the checkout's
flash forward, flash backward, block and MLP kernels (their nvcc -Xptxas -v
logs). Run two checkouts in turns (A, B, B, A) in one process tree on one
card. ``--dump`` also saves the forward's out and lse and the backward's
dq, dk and dv for every (d_k, d_v) the checkout builds, at (B 4, L 200, H
2); the fused attention block's y, attn and lse at (B 2, L 200) for C 64 /
2 heads, C 512 / 8 and C 512 / 4, with and without mask_center; and the
fused MLP's out and y and each backward route's seven gradients, and the
LayerNorm kernels' outputs, at a ragged R of 4,097 rows for C 512 and
1024; each block and MLP output with its plain version on the same inputs,
all from inputs made from one seed.
``--compare`` says, for the entries two dumps share, whether they are
equal bit for bit, and holds each dump's block and MLP outputs against
their plain versions at ``chip_smoke.py``'s gates (y, attn and every MLP
output 1e-4 of the largest magnitude, lse 5e-5): the bits of the block and
of the MLP are not kept from one design to the next, only their gates.
``--steps`` also times the checkout's ImageGPT train step
(``Trainer.train_one_step``, batch 64, 5 steps after 3 warm-ups, CUDA
events) at the reproduce() config (C = 64, 2 heads), at C = 512 with 8 and
with 4 heads, and at C = 512 / 8 heads with the fused attention block
(PGT_FUSED_ATTN=1) under each MLP backward route, TF32 off.
"""

import argparse
import shutil
import sys
import tempfile

# (batch, heads, d_k, d_v, mask_center) of the timed shapes, all at L = 784.
SHAPES = ((64, 2, 32, 32, False), (64, 8, 64, 64, False), (64, 4, 128, 128, False),
          (128, 1, 4, 32, True))
# (C, heads) of the fused attention block; the gates of the block's and
# the fused MLP's outputs against their plain versions (chip_smoke.py's
# BLOCK_RTOL = MLP_RTOL, a share of the largest magnitude, and
# BLOCK_LSE_TOL).
BLOCK_WIDTHS = ((64, 2), (512, 8), (512, 4))
RTOL, BLOCK_LSE_TOL = 1e-4, 5e-5
# The fused MLP's widths (F = 4C) and the rows it is timed and dumped at.
MLP_WIDTHS = (512, 1024)
MLP_ROWS, MLP_DUMP_ROWS = 50176, 4097
MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


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
    print(f"mlp times {label}: " + "; ".join(mlp_times(dev, time_ms)), flush=True)
    for kernel in (ac.KERNEL, ac.BWD_KERNEL, "attn_block_fwd", "mlp_fwd", "mlp_bwd"):
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
        results.update(_mlp_outputs(dev))
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


def _mlp_operands(r, c, seed, dev):
    """x, gamma, beta, w1, b1, w2, b2 and dout of the fused MLP at (R, C),
    F = 4C, from one seed."""
    import torch

    g = torch.Generator().manual_seed(seed)
    f = 4 * c
    ops = [2.0 * torch.randn((r, c), generator=g) + 0.5,
           1.0 + 0.1 * torch.randn((c,), generator=g), 0.1 * torch.randn((c,), generator=g),
           torch.randn((c, f), generator=g) / c ** 0.5, 0.1 * torch.randn((f,), generator=g),
           torch.randn((f, c), generator=g) / f ** 0.5, 0.1 * torch.randn((c,), generator=g),
           torch.randn((r, c), generator=g)]
    return [t.to(dev) for t in ops]


def _mlp_calls(ops, y):
    """{row: (kernel call, plain call)} of rows 6a-6d on ops, the backward
    routes from the forward's y."""
    from pytorch_generative_tpu_torch.ops import mlp_cuda as mc

    x, gamma, beta, w1, b1, w2, b2, dout = ops
    eps = 1e-5
    return {
        "6a fwd": (lambda: mc.ln_mlp_forward(x, gamma, beta, w1, b1, w2, b2, eps),
                   lambda: mc.ln_mlp_forward_plain(x, gamma, beta, w1, b1, w2, b2, eps)),
        "6b bwd": (lambda: mc.ln_mlp_backward(x, dout, y, gamma, beta, w1, b1, w2, eps),
                   lambda: mc.ln_mlp_backward_plain(x, dout, y, gamma, beta, w1, b1, w2, eps)),
        "6c recompute": (
            lambda: mc.ln_mlp_backward_recompute(x, dout, gamma, beta, w1, b1, w2, eps),
            lambda: mc.ln_mlp_backward_recompute_plain(x, dout, gamma, beta, w1, b1, w2, eps)),
        "6d pipe": (lambda: mc.ln_mlp_backward_pipe(x, dout, y, gamma, beta, w1, b1, w2, eps),
                    lambda: mc.ln_mlp_backward_plain(x, dout, y, gamma, beta, w1, b1, w2, eps)),
    }


def _mlp_outputs(dev):
    """{entry: {name: tensor}} of rows 6a-6d at R = MLP_DUMP_ROWS and, under
    "plain " names, of their plain versions on the same inputs; and of the
    LayerNorm kernels (rows 5a, 5b) on the same x."""
    from pytorch_generative_tpu_torch.ops import ln_cuda, mlp_cuda

    out = {}
    for c in MLP_WIDTHS:
        ops = _mlp_operands(MLP_DUMP_ROWS, c, c, dev)
        x, gamma, beta, dout = ops[0], ops[1], ops[2], ops[7]
        out[f"ln C={c}"] = dict(zip(("y", "dx", "dgamma", "dbeta"), (t.cpu() for t in (
            ln_cuda.ln_forward(x, gamma, beta, 1e-5), *ln_cuda.ln_backward(x, dout, gamma, 1e-5)))))
        _, y = mlp_cuda.ln_mlp_forward(*ops[:7], 1e-5)
        for row, (kern, plain) in _mlp_calls(ops, y).items():
            names = ("out", "y") if row == "6a fwd" else MLP_GRADS
            out[f"mlp C={c} {row}"] = {
                **{name: t.cpu() for name, t in zip(names, kern())},
                **{f"plain {name}": t.cpu() for name, t in zip(names, plain())}}
        del ops, y
    return out


def mlp_times(dev, time_ms):
    """'C: row ms' of rows 6a-6d at R = MLP_ROWS for each width, beside the
    composition's forward and autograd.grad through it."""
    import torch
    import torch.nn.functional as F

    from pytorch_generative_tpu_torch.ops import mlp_cuda

    out = []
    for c in MLP_WIDTHS:
        ops = _mlp_operands(MLP_ROWS, c, 0, dev)
        _, y = mlp_cuda.ln_mlp_forward(*ops[:7], 1e-5)
        res = [f"{row} {time_ms(kern, n=5):.4f}" for row, (kern, _) in _mlp_calls(ops, y).items()]
        leaves = [t.detach().requires_grad_() for t in ops[:7]]
        x, gamma, beta, w1, b1, w2, b2 = leaves

        def composition():
            return torch.addmm(b2, F.gelu(torch.addmm(b1, F.layer_norm(
                x, (c,), gamma, beta, 1e-5), w1)), w2) + x

        with torch.no_grad():
            res.append(f"composition {time_ms(composition, n=5):.4f}")
        graph = composition()
        res.append("autograd.grad through it " + format(time_ms(
            lambda: torch.autograd.grad(graph, leaves, ops[7], retain_graph=True), n=5), ".4f"))
        out.append(f"(R {MLP_ROWS}, C {c}) ms: " + ", ".join(res))
        del ops, y, leaves, graph
    return out


def step_times(dev, time_ms):
    """(config name, ms) of one ImageGPT train step at batch 64 per config
    and, at C = 512 / 8 heads, per MLP backward route with the fused
    attention block."""
    import os

    import torch

    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models import ImageGPT
    from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
    from pytorch_generative_tpu_torch.ops import mlp_cuda

    g = torch.Generator().manual_seed(0)
    out = []
    for name, cfg, routes in (
            ("C=64 H=2", image_gpt.REPRODUCE_CONFIG, (None,)),
            ("C=512 H=8", image_gpt.LARGE_CONFIG, (None,)),
            ("C=512 H=4", dict(image_gpt.LARGE_CONFIG, n_attention_heads=4), (None,)),
            ("C=512 H=8 gated", image_gpt.LARGE_CONFIG, ("saved", "recompute", "pipe"))):
        model = ImageGPT(**cfg, generator=g, device=dev)
        t = trainer.Trainer(model, image_gpt.reproduce_loss,
                            optim.adam_multiplicative(5e-3, 0.999977), [], [],
                            log_dir=tempfile.mkdtemp(prefix="flash_times_"),
                            use_tensorboard=False, device=dev)
        h, w, _ = cfg["in_shape"]
        xb = (torch.rand((64, h, w, 1), generator=g) < 0.13).float().numpy()
        for route in routes:
            if route:  # the user's switches: PGT_FUSED_ATTN, _SAVE_PREACT, PGT_MLP_BWD
                os.environ["PGT_FUSED_ATTN"] = "1"
                mlp_cuda._SAVE_PREACT = route != "recompute"
                os.environ["PGT_MLP_BWD"] = "pipe" if route == "pipe" else "mono"
            out.append((name + (f" {route}" if route else ""),
                        time_ms(lambda: t.train_one_step(xb, None), n=5)))
        for var in ("PGT_FUSED_ATTN", "PGT_MLP_BWD"):
            os.environ.pop(var, None)
        mlp_cuda._SAVE_PREACT = True
        shutil.rmtree(t.log_dir, ignore_errors=True)
        del model, t
    return out


def _within_gates(entry):
    """'name e of m, ...: ok' of a dump's block or MLP outputs against its
    plain version (e the largest error, m the plain's largest magnitude;
    lse by its absolute gate)."""
    import torch

    parts, ok = [], True
    for name in (n for n in entry if not n.startswith("plain ")):
        got, want = entry[name], entry[f"plain {name}"]
        finite = torch.isfinite(want)
        ok &= torch.equal(torch.isfinite(got), finite)
        err = float((got - want)[finite].abs().max())
        scale = float(want[finite].abs().max())
        ok &= err <= (BLOCK_LSE_TOL if name == "lse" else RTOL * scale)
        parts.append(f"{name} {err:.3e}" + ("" if name == "lse" else f" of {scale:.3e}"))
    return ", ".join(parts) + (" (within the gates)" if ok else " (OUTSIDE THE GATES)")


def compare(file_a, file_b):
    import torch

    a, b = torch.load(file_a), torch.load(file_b)
    for key in sorted(set(a) & set(b)):
        names = [name for name in a[key] if not name.startswith("plain ")]
        same = [name for name in names if torch.equal(a[key][name], b[key][name])]
        note = "" if len(same) == len(names) else " (DIFFER)"
        if key.startswith(("block", "mlp")) and note:
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

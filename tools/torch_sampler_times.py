"""Times the PyTorch port's whole-loop ImageGPT sampler kernel
(``csrc/sample_loop.cu`` through ``decode_cuda.fused_sample_loop``) of two
checkouts of this repository in one process on one CUDA card, in turns,
and splits this checkout's kernel time by stage:

    python3 tools/torch_sampler_times.py A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL [--n 16 64 256]
    python3 tools/torch_sampler_times.py --stages [--n 16]

Both checkouts' ``pytorch_generative_tpu_torch`` are imported into the one
process (each in turn, its modules kept by reference) and build their
kernels in their own trees. At every n the two run on the same model and
inputs: the reproduce() ImageGPT (28x28x1, 8 blocks, C = 64, 2 heads) with
seeded random weights and a non-zero positional embedding, free sampling,
uniforms from one seed. Each n is timed A, B, B, A (CUDA events, 2 calls
after 1 warm-up each turn) and a checkout's plan is printed where it has
one (``decode_cuda.sample_plan``). Every line carries the card's name and
power limit from ``nvidia-smi``.

``--stages`` builds this checkout's kernel with ``-DSAMPLE_LOOP_STAMPS``
(``clock64()`` stamps on rank 0 of the first cluster) and prints its time
split into stages at each n: clocks, share, and microseconds a position
(a share of the event-timed call), and for the per-block stages
microseconds a position and block.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import torch

PKG = "pytorch_generative_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent
# The kernel's stamps (csrc/sample_loop.cu, SAMPLE_LOOP_STAMPS).
STAGES = ("QKV sums and stores", "QKV barrier (arrive)", "out sums and stores",
                  "out barrier", "MLP 1 sums", "MLP 1 (no barrier)", "MLP 2 sums and stores",
                  "MLP 2 barrier", "attention merge and stores", "attention barrier",
                  "ranks' combine", "LayerNorm 2", "residual + LayerNorm 1",
                  "head, draw, next input", "products: taking the weight slice",
                  "attention: QKV barrier wait, k|v store", "attention: keys",
                  "attention: CTA barrier")
PER_BLOCK = (*range(0, 13), 14, 15, 16, 17)  # once a block, else a position
SEED = 0


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def load_checkout(root):
    """The sampler's modules of the checkout at ``root``, imported afresh."""
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        from pytorch_generative_tpu_torch.models import ImageGPT
        from pytorch_generative_tpu_torch.models.autoregressive import image_gpt
        from pytorch_generative_tpu_torch.ops import _build, decode_cuda, sampling
    finally:
        sys.path.remove(str(root))
    return SimpleNamespace(ImageGPT=ImageGPT, image_gpt=image_gpt, build=_build,
                           dc=decode_cuda, sampling=sampling)


def sampler_inputs(ck, n, dev):
    """fused_sample_loop's arguments for free sampling of n images."""
    cfg = ck.image_gpt.REPRODUCE_CONFIG
    gen = torch.Generator().manual_seed(SEED)
    model = ck.ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape, generator=gen))
    h, w, _ = cfg["in_shape"]
    free = -torch.ones((n, h, w, 1), device=dev)
    u = torch.rand((h * w, n, 1), generator=gen).to(dev)
    return ck.sampling.sample_loop_inputs(model.eval(), free, u)


def time_ms(fn, iters=2, warmup=1):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(a_root, a_label, b_root, b_label, ns):
    smi, dev = _smi(), torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = [(a_label, load_checkout(a_root)), (b_label, load_checkout(b_root))]
    for label, ck in sides:
        plans = []
        if hasattr(ck.dc, "sample_plan"):
            for n in ns:
                inputs = sampler_inputs(ck, n, dev)
                plans.append(f"n={n}: {ck.dc.plan_for(*inputs)}")
        print(f"[{smi}] {label}: plan {'; '.join(plans) or 'one CTA a sample'}", flush=True)
    for n in ns:
        inputs = sampler_inputs(sides[1][1], n, dev)
        times = {label: [] for label, _ in sides}
        for label, ck in (sides[0], sides[1], sides[1], sides[0]):
            times[label].append(time_ms(lambda: ck.dc.fused_sample_loop(*inputs)))
        outs = [ck.dc.fused_sample_loop(*inputs) for _, ck in sides]
        same = int((outs[0] != outs[1]).sum())
        print(f"[{smi}] sampler n={n}: " + ", ".join(
            f"{label} {' / '.join(f'{t:.3f}' for t in ts)} ms" for label, ts in times.items())
            + f" (A, B, B, A); canvases differ at {same} of {outs[0].numel()} entries "
            "(free draws, not nudged)", flush=True)


def _build_stamped(ck, src):
    out = Path(tempfile.mkdtemp(prefix="sample_loop_stamps_")) / "lib.so"
    proc = subprocess.run([ck.build._nvcc(), *ck.build.NVCC_FLAGS, "-DSAMPLE_LOOP_STAMPS",
                           "-o", str(out), str(src)], capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def _print_split(smi, n, ms, got, h, w, n_blocks):
    total = sum(got)
    print(f"[{smi}] stages of the kernel n={n}: call {ms:.2f} ms, "
          f"{ms * 1e3 / (h * w):.1f} us a position, {total} clocks", flush=True)
    for k, (name, clk) in enumerate(zip(STAGES, got)):
        us_pos = clk / total * ms * 1e3 / (h * w)
        per = f", {us_pos / n_blocks:.3f} us a position and block" if k in PER_BLOCK else ""
        print(f"[{smi}]   {name} {clk} clocks {100 * clk / total:.1f}% {us_pos:.2f} us a "
              f"position{per}", flush=True)


def stages(ns):
    smi, dev = _smi(), torch.device("cuda:0")
    ck = load_checkout(ROOT)
    lib = _build_stamped(ck, ck.build.CSRC / "sample_loop.cu")
    fn = lib.sample_loop_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib.sample_loop_stamps.restype = ctypes.c_int
    lib.sample_loop_stamps.argtypes = [ctypes.c_void_p]
    for n in ns:
        inputs = sampler_inputs(ck, n, dev)
        canvas0, pos_pad, uniforms, weights, n_heads, h, w = inputs
        plan = ck.dc.plan_for(*inputs)
        _, (_, _, n_blocks, c, _, d_k, d_v, m) = ck.dc.check_sample_loop(*inputs)
        canvas = torch.empty_like(canvas0)
        kv = torch.empty((n_blocks, n, plan.cluster, -(-(h * w) // plan.cluster),
                          n_heads * (d_k + d_v)), device=dev)
        clocks = torch.zeros(len(STAGES), dtype=torch.int64)

        def call():
            err = fn(canvas0.data_ptr(), pos_pad.data_ptr(), uniforms.data_ptr(),
                     canvas.data_ptr(), kv.data_ptr(),
                     *[weights[k].data_ptr() for k in ck.dc.WEIGHT_ORDER],
                     n, h, w, n_blocks, c, n_heads, d_k, d_v, m, plan.cluster, plan.clusters,
                     plan.samples, plan.groups, int(plan.resident), plan.stage,
                     torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"sample_loop_f32: cudaError {err}")

        call()
        torch.cuda.synchronize()
        lib.sample_loop_stamps(clocks.data_ptr())  # drop the warm-up's
        ms = time_ms(call, iters=1, warmup=0)
        if lib.sample_loop_stamps(clocks.data_ptr()):
            raise RuntimeError("sample_loop_stamps failed")
        print(f"[{smi}] kernel n={n}: {plan}", flush=True)
        _print_split(smi, n, ms, clocks.tolist(), h, w, n_blocks)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("sides", nargs="*", help="A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL")
    parser.add_argument("--n", type=int, nargs="+", default=[16, 64, 256])
    parser.add_argument("--stages", action="store_true")
    args = parser.parse_args()
    if args.stages:
        stages(args.n)
    else:
        if len(args.sides) != 4:
            parser.error("give A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL, or --stages")
        compare(*args.sides, args.n)

"""Times the PyTorch port's whole-loop ImageGPT sampler kernel
(``csrc/sample_loop.cu`` through ``decode_cuda.fused_sample_loop``) of two
checkouts of this repository in one process on one CUDA card, in turns,
and splits this checkout's kernel time by stage; with ``--step``, the
per-position step route at ``LARGE_CONFIG`` instead:

    python3 tools/torch_sampler_times.py A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL [--n 16 64 256]
    python3 tools/torch_sampler_times.py --stages [--n 16]
    python3 tools/torch_sampler_times.py --step A_CHECKOUT A_LABEL [B_CHECKOUT B_LABEL]
    python3 tools/torch_sampler_times.py --timeline

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

``--step`` times, for one checkout or two in turns (A, B, B, A), the step
kernel (``csrc/decode_step.cu`` through ``decode_cuda.fused_decode_step``)
at i = 391 with an f32 and a bf16 K/V cache, n = 16, and sampling 16
images of ``ImageGPT(**LARGE_CONFIG)`` with each cache, through each
checkout's own ``sampling.image_gpt_sample_fast``; then, for each
checkout, the profiler's split of one step at i = 391 and 783 (kernel time
by kind: products, attention, row passes, and the rest of the event-timed
step, the gaps between launches; where launches overlap, as the redesigned
kernel's do by programmatic dependent launch, a kernel's time includes its
wait for the one before, so the kinds sum to more than the step and the
gaps come out negative: ``--timeline`` splits that kernel instead) and the
host's share of a position (the PyTorch ops around the step with the step
stubbed, the host time to issue one step call, and, where the checkout
runs the step route as a CUDA graph, the host time of one replay and its
device time a position).

``--timeline`` builds a copy of this checkout's ``csrc/decode_step.cu``
with ``%globaltimer`` stamps (thread 0 of every CTA: start, wait for the
previous launch released, A copied, product summed, end; the anchors are
lines of the source, and the mode raises if one is missing), runs one step
at i = 391 and 783, f32 cache, n = 16, LARGE_CONFIG, after warm-up steps,
and prints each launch's critical-path share (its last CTA's end less the
previous launch's) averaged over blocks 2-8, split into the wait for the
previous launch, the A copy, the product and the rest.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
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
STEP_N = 16
STEP_TIMED = 391
STEP_POSITIONS = (391, 783)
# Kernel names by kind, for the step's split (both designs' names).
STEP_KINDS = (("products", ("decode_gemv", "decode_proj")),
              ("attention", ("decode_attn", "decode_combine")),
              ("rows", ("decode_rows", "decode_lnf")))


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


def _sample(ck, model, dtype):
    """The checkout's own sampler (``model.sample`` imports the sampling
    module at call time, which would be the checkout loaded last)."""
    with torch.no_grad():
        return ck.sampling.image_gpt_sample_fast(
            model, STEP_N, generator=torch.Generator().manual_seed(SEED), cache_dtype=dtype)


def _step_setup(ck, dev):
    """A seeded LARGE_CONFIG ImageGPT (non-zero positional embedding), its
    stacked weights, x (16, C) and a cache of seeded values."""
    cfg = ck.image_gpt.LARGE_CONFIG
    gen = torch.Generator().manual_seed(SEED)
    model = ck.ImageGPT(**cfg, generator=gen, device=dev)
    with torch.no_grad():
        model.pos.copy_(0.1 * torch.randn(model.pos.shape, generator=gen))
    model.eval()
    weights = ck.dc.stack_image_gpt_weights(model)
    attn = model.blocks[0].attn
    h, w, _ = cfg["in_shape"]
    x = torch.randn((STEP_N, attn.embed_channels), generator=gen).to(dev)
    cache = torch.randn((len(model.blocks), STEP_N, h * w,
                         attn.embed_channels + attn.out_channels), generator=gen).to(dev)
    return model, weights, x, cache, attn.n_heads


def _step_split(smi, label, ck, dev, i, dname, dtype, x, cache, weights, n_heads, calls=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c = cache.to(dtype)
    step = lambda: ck.dc.fused_decode_step(i, x, c, weights, n_heads)
    ms = time_ms(step, iters=calls, warmup=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count // calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    kinds = {kind: sum(r[1] for r in rows if any(k in r[0] for k in keys))
             for kind, keys in STEP_KINDS}
    launches = {kind: sum(r[2] for r in rows if any(k in r[0] for k in keys))
                for kind, keys in STEP_KINDS}
    total = sum(r[1] for r in rows)
    print(f"[{smi}] step split {label} i={i} {dname} cache: step {ms:.4f} ms (events); "
          + ", ".join(f"{kind} {kinds[kind]:.4f} ms ({launches[kind]} launches, "
                      f"{100 * kinds[kind] / ms:.1f}%)" for kind, _ in STEP_KINDS)
          + f", other kernels {total - sum(kinds.values()):.4f} ms, gaps "
          f"{ms - total:.4f} ms ({100 * (ms - total) / ms:.1f}%)", flush=True)


def _step_host(smi, label, ck, dev, model, x, cache, weights, n_heads):
    """The host's share of a position on the step route."""
    h, w, _ = model.in_shape
    free = -torch.ones((STEP_N, h, w, 1), device=dev)
    u = torch.rand((h * w, STEP_N, 1), generator=torch.Generator().manual_seed(SEED)).to(dev)
    stub = ck.dc.fused_decode_step(STEP_TIMED, x, cache, weights, n_heads)
    ops_ms = time_ms(lambda: ck.sampling._image_gpt_decode_step(
        model, free, u, torch.float32, step=lambda *_: stub)) / (h * w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        ck.dc.fused_decode_step(STEP_TIMED, x, cache, weights, n_heads)
    issue_ms = (time.perf_counter() - t0) * 1e3 / 8
    torch.cuda.synchronize()
    call_ms = time_ms(lambda: _sample(ck, model, torch.float32)) / (h * w)
    line = (f"[{smi}] step host {label}: per position, the PyTorch ops around the step "
            f"{ops_ms:.4f} ms (the step stubbed), issuing one step call {issue_ms:.4f} ms of "
            f"host time, the whole call {call_ms:.4f} ms")
    if hasattr(ck.sampling, "StepRoute"):
        route = ck.sampling.StepRoute(model, free, u, torch.float32)
        graph = route.capture()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(h * w - 2):
            graph.replay()
        replay_host = (time.perf_counter() - t0) * 1e3 / (h * w - 2)
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3 / (h * w - 2)
        line += (f"; one graph replay {replay_host:.4f} ms of host time, "
                 f"{replay_ms:.4f} ms a position to the last replay's end")
    print(line, flush=True)


def step_compare(sides_args):
    smi, dev = _smi(), torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = [(sides_args[k + 1], load_checkout(sides_args[k]))
             for k in range(0, len(sides_args), 2)]
    setups = {label: _step_setup(ck, dev) for label, ck in sides}
    order = sides + sides[::-1] if len(sides) == 2 else sides * 2
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for dname, dtype in dtypes.items():
        times = {label: [] for label, _ in sides}
        calls = {label: [] for label, _ in sides}
        for label, ck in order:
            _, weights, x, cache, n_heads = setups[label]
            c = cache.to(dtype, copy=True)
            c[:, :, STEP_TIMED:] = 0.0
            times[label].append(time_ms(lambda: ck.dc.fused_decode_step(
                STEP_TIMED, x, c, weights, n_heads), iters=20, warmup=3))
        for label, ck in order:
            model = setups[label][0]
            calls[label].append(time_ms(lambda: _sample(ck, model, dtype)))
        print(f"[{smi}] step i={STEP_TIMED} n={STEP_N} {dname} cache: " + ", ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms" for label, ts in times.items())
            + " (turns)", flush=True)
        print(f"[{smi}] LARGE_CONFIG.sample({STEP_N}) {dname} cache: " + ", ".join(
            f"{label} {' / '.join(f'{t:.2f}' for t in ts)} ms" for label, ts in calls.items())
            + " (turns)", flush=True)
    for label, ck in sides:
        model, weights, x, cache, n_heads = setups[label]
        for i in STEP_POSITIONS:
            for dname, dtype in dtypes.items():
                _step_split(smi, label, ck, dev, i, dname, dtype, x, cache, weights, n_heads)
        _step_host(smi, label, ck, dev, model, x, cache, weights, n_heads)


# (anchor, stamp) pairs: the stamp goes after the anchor's first line.
_STAMP = ("if (threadIdx.x == 0) g_stamps[((size_t)(SEQ) * kStampCtas + blockIdx.x) * 5 + K] "
          "= stamp_now();\n")
_TIMELINE_PATCHES = (
    ("namespace {\n", "__device__ unsigned long long g_stamps[64 * 2048 * 5];\n"
     "constexpr int kStampCtas = 2048;\n"
     "__device__ __forceinline__ unsigned long long stamp_now() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "int g_seq_base = 0;\n"),
    ("  int ck;             // kQkv: columns >= ck go to the cache\n", "  int seq;\n"),
    ("  cluster_arrive_relaxed();\n", _STAMP.replace("SEQ", "a.seq").replace("K]", "0]")),
    ("  cluster_wait();  // every rank has started: stores into its shared memory may begin\n",
     _STAMP.replace("SEQ", "a.seq").replace("K]", "1]")),
    ("      __syncthreads();  // the weights and a_s are complete\n",
     _STAMP.replace("SEQ", "a.seq").replace("K]", "2]")),
    ("    cp_async_wait_all();  // a rank without rows of K skipped the product's wait\n",
     _STAMP.replace("SEQ", "a.seq").replace("K]", "3]")),
    ("      if (r < rows && j < a.J) epilogue<kMode, T>(a, r0 + r, j, s, bias_s[c], epi, t, "
     "kPer);\n    }\n  }\n",
     _STAMP.replace("SEQ", "a.seq").replace("K]", "4]")),
    ("  const int tiles = (a.J + kTile - 1) / kTile;\n", ""),
    ("  for (int b = 0; b < d.NB; ++b) {\n", "    g_seq_base = 6 * b;\n"),
)


def _timeline_source(src):
    for anchor, stamp in _TIMELINE_PATCHES:
        if anchor not in src:
            raise RuntimeError(f"--timeline: csrc/decode_step.cu has no line {anchor!r}")
        src = src.replace(anchor, anchor + stamp, 1)
    src = src.replace("  const int tiles = (a.J + kTile - 1) / kTile;\n",
                      "  a.seq = g_seq_base + (kMode == 0 ? 0 : kMode + 2);\n"
                      "  const int tiles = (a.J + kTile - 1) / kTile;\n", 1)
    # The attention and combine kernels: a sequence number argument.
    for kernel, offset in (("decode_attn_kernel", 1), ("decode_combine_kernel", 2)):
        head = src.index(kernel + "(")
        body = src.index("{\n", head) + 2
        src = src[:head] + src[head:body].replace(") {\n", ", int seq) {\n") + src[body:]
        body = src.index("{\n", head) + 2
        src = (src[:body] + _STAMP.replace("SEQ", "seq").replace("K]", "0]") + src[body:])
        wait = src.index("  wait_previous();\n", body) + len("  wait_previous();\n")
        src = src[:wait] + _STAMP.replace("SEQ", "seq").replace("K]", "1]") + src[wait:]
        end = src.index("\n}\n", wait)
        end_stamp = _STAMP.replace("SEQ", "seq").replace("K]", "4]").rstrip("\n")
        src = src[:end] + "\n" + end_stamp + src[end:]
        launch = src.index(f"launch({kernel}")
        close = src.index(");", launch)
        src = src[:close] + f", g_seq_base + {offset}" + src[close:]
    return src + ("\nextern \"C\" int decode_step_stamps(unsigned long long* out) {\n"
                  "  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n")


def timeline():
    import numpy as np

    smi, dev = _smi(), torch.device("cuda:0")
    ck = load_checkout(ROOT)
    src = Path(tempfile.mkdtemp(prefix="decode_step_timeline_")) / "decode_step.cu"
    src.write_text(_timeline_source((ck.build.CSRC / "decode_step.cu").read_text()))
    out = src.with_suffix(".so")
    proc = subprocess.run([ck.build._nvcc(), *ck.build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the stamped step:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ck.build._loaded[ck.dc.DECODE_STEP_KERNEL] = lib
    ck.dc._step_lib()
    lib.decode_step_stamps.argtypes = [ctypes.c_void_p]
    _, weights, x, cache, n_heads = _step_setup(ck, dev)
    kinds = ("QKV", "attention", "combine", "out", "MLP 1", "MLP 2")
    for i in STEP_POSITIONS:
        for _ in range(5):
            ck.dc.fused_decode_step(i, x, cache, weights, n_heads)
        torch.cuda.synchronize()
        stamps = torch.zeros(64 * 2048 * 5, dtype=torch.int64)
        lib.decode_step_stamps(stamps.data_ptr())  # the warm-up's
        ms = time_ms(lambda: ck.dc.fused_decode_step(i, x, cache, weights, n_heads), 1, 0)
        lib.decode_step_stamps(stamps.data_ptr())
        st = stamps.numpy().reshape(64, 2048, 5).astype(np.float64)
        n_blocks = weights["qkv_w"].shape[0]
        live = st[..., 0] > 0
        t0 = st[0][live[0], 0].min()
        last = lambda seq, k: (st[seq][live[seq] & (st[seq][:, k] > 0), k].max() - t0) / 1e3
        share = {kind: [] for kind in kinds}
        parts = {kind: [] for kind in kinds}
        for b in range(1, n_blocks):
            for q, kind in enumerate(kinds):
                seq = 6 * b + q
                prev_end = last(seq - 1, 4)
                share[kind].append(last(seq, 4) - prev_end)
                if q in (0, 3, 4, 5):
                    parts[kind].append((last(seq, 1) - prev_end, last(seq, 2) - last(seq, 1),
                                        last(seq, 3) - last(seq, 2), last(seq, 4) - last(seq, 3)))
                else:
                    parts[kind].append((last(seq, 1) - prev_end, 0.0, 0.0,
                                        last(seq, 4) - last(seq, 1)))
        block_us = np.mean([sum(v[b] for v in share.values()) for b in range(n_blocks - 1)])
        print(f"[{smi}] step timeline i={i} f32 cache n={STEP_N}: step {ms:.4f} ms (events), "
              f"block {block_us:.2f} us"
              " (blocks 2-8); per launch, us of the critical path: share (wait released, A copied, "
              "product summed, the rest)", flush=True)
        for kind in kinds:
            p = np.mean(parts[kind], axis=0)
            print(f"[{smi}]   {kind}: {np.mean(share[kind]):.2f} ({p[0]:.2f}, {p[1]:.2f}, "
                  f"{p[2]:.2f}, {p[3]:.2f})", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("sides", nargs="*", help="A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL")
    parser.add_argument("--n", type=int, nargs="+", default=[16, 64, 256])
    parser.add_argument("--stages", action="store_true")
    parser.add_argument("--step", action="store_true")
    parser.add_argument("--timeline", action="store_true")
    args = parser.parse_args()
    if args.timeline:
        timeline()
    elif args.step:
        if len(args.sides) not in (2, 4):
            parser.error("--step takes A_CHECKOUT A_LABEL [B_CHECKOUT B_LABEL]")
        step_compare(args.sides)
    elif args.stages:
        stages(args.n)
    else:
        if len(args.sides) != 4:
            parser.error("give A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL, or --stages")
        compare(*args.sides, args.n)

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


# ---- PixelSNAIL (row 7, csrc/snail_loop.cu) -------------------------------

SNAIL_WINDOWS = ((96, 104), (388, 396), (776, 784))  # positions near 100, 391, 783
SNAIL_STAMP_N = (16, 64)


def load_snail(root):
    """The PixelSNAIL sampler's modules of the checkout at ``root``; its
    ``modules`` are put back into ``sys.modules`` (``activate``) before it
    runs, since the samplers import modules by name at call time."""
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        from pytorch_generative_tpu_torch.models import PixelSNAIL
        from pytorch_generative_tpu_torch.models.autoregressive import pixel_snail
        from pytorch_generative_tpu_torch.ops import _build, sampling, snail_decode_cuda
    finally:
        sys.path.remove(str(root))
    modules = {m: mod for m, mod in sys.modules.items() if m == PKG or m.startswith(PKG + ".")}
    return SimpleNamespace(PixelSNAIL=PixelSNAIL, cfg=pixel_snail.REPRODUCE_CONFIG, build=_build,
                           sdc=snail_decode_cuda, sampling=sampling, modules=modules)


def activate(ck):
    for name in [m for m in sys.modules if m == PKG or m.startswith(PKG + ".")]:
        del sys.modules[name]
    sys.modules.update(ck.modules)
    return ck


def snail_setup(ck, n, dev):
    """A seeded reproduce() PixelSNAIL and fused_snail_sample_loop's
    arguments for free sampling of n images."""
    gen = torch.Generator().manual_seed(SEED)
    model = ck.PixelSNAIL(**ck.cfg, generator=gen, device=dev).eval()
    h, w, _ = ck.cfg["in_shape"]
    u = torch.rand((h * w, n, 1), generator=gen).to(dev)
    return model, ck.sampling.snail_loop_inputs(model, -torch.ones((n, h, w, 1), device=dev), u)


def _snail_plan(ck, inputs):
    if not hasattr(ck.sdc, "plan_for"):
        return "one CTA a sample"
    plan = ck.sdc.plan_for(*inputs)
    clusters, regs = ck.sdc.occupancy(plan.samples, plan.cluster, plan.smem)
    return f"{plan}, {regs} registers a thread, {clusters} clusters fit at once"


def snail_compare(sides_args, ns, clusters=None, split=True, depths=None):
    """``clusters``, ``depths``: the cluster sizes and ring depths the last
    checkout's plan may take (its ``snail_decode_cuda.CLUSTERS`` and
    ``DEPTHS``), to time another plan."""
    smi, dev = _smi(), torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = [(sides_args[k + 1], load_snail(sides_args[k])) for k in range(0, len(sides_args), 2)]
    if clusters:
        sides[-1][1].sdc.CLUSTERS = tuple(clusters)
    if depths:
        sides[-1][1].sdc.DEPTHS = tuple(depths)
    order = sides + sides[::-1] if len(sides) == 2 else sides * 2
    for n in ns:
        setups = {label: snail_setup(activate(ck), n, dev) for label, ck in sides}
        for label, ck in sides:
            print(f"[{smi}] {label} n={n}: plan {_snail_plan(activate(ck), setups[label][1])}",
                  flush=True)
        kern = {label: [] for label, _ in sides}
        call = {label: [] for label, _ in sides}
        for label, ck in order:
            activate(ck)
            model, inputs = setups[label]
            kern[label].append(time_ms(lambda: ck.sdc.fused_snail_sample_loop(*inputs)))
            call[label].append(time_ms(lambda: ck.sampling.pixel_snail_sample(
                model, n, generator=torch.Generator().manual_seed(SEED))))
        outs = [activate(ck).sdc.fused_snail_sample_loop(*setups[label][1])
                for label, ck in sides]
        diff = int((outs[0] != outs[-1]).sum())
        print(f"[{smi}] snail_loop n={n}: " + ", ".join(
            f"{label} {' / '.join(f'{t:.3f}' for t in ts)} ms" for label, ts in kern.items())
            + " (turns); PixelSNAIL.sample: " + ", ".join(
            f"{label} {' / '.join(f'{t:.3f}' for t in ts)} ms" for label, ts in call.items())
            + f"; canvases differ at {diff} of {outs[0].numel()} entries (free draws, not nudged)",
            flush=True)
    if split:
        label, ck = sides[-1]
        snail_stages(smi, label, activate(ck), dev)


# The stage split: a copy of the kernel whose thread 0 of CTA 0 adds the
# clocks between stamps to the current stage, in shared memory, for every
# position and for the positions of each window. Stamps go before anchor
# lines of the source (the mode raises if one is missing); every
# __syncthreads() charges its wait to "CTA barrier waits", and a wrapped
# call (the new kernel's ring wait and cluster barriers) to its own stage.
_SNAIL_STAMP_HEADER = r"""
#define ST_STAGES 20
__device__ long long g_snail_stamps[4 * ST_STAGES];
__shared__ long long st_acc[4 * ST_STAGES];
__shared__ long long st_last;
__shared__ int st_cur, st_win;
#define ST_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define ST_TICK(k) { if (ST_ON) { const long long t_ = clock64(); \
  st_acc[3 * ST_STAGES + st_cur] += t_ - st_last; \
  if (st_win >= 0) st_acc[st_win * ST_STAGES + st_cur] += t_ - st_last; \
  st_last = t_; st_cur = (k); } }
#define ST_WRAP(k, ...) { const int keep_ = ST_ON ? st_cur : 0; ST_TICK(k) __VA_ARGS__ ST_TICK(keep_) }
#define ST_SYNC() ST_WRAP(ST_STAGES - 1, __syncthreads();)
#define ST_POSITION(i) { ST_TICK(0) if (ST_ON) st_win = ST_WINDOW(i); }
#define ST_INIT() { if (ST_ON) { for (int k_ = 0; k_ < 4 * ST_STAGES; ++k_) st_acc[k_] = 0; \
  st_last = clock64(); st_cur = ST_STAGES - 2; st_win = -1; } }
#define ST_FLUSH() { ST_TICK(ST_STAGES - 2) \
  if (ST_ON) for (int k_ = 0; k_ < 4 * ST_STAGES; ++k_) g_snail_stamps[k_] += st_acc[k_]; }
"""
_SNAIL_STAMP_EXPORT = ("\nextern \"C\" int snail_loop_stamps(long long* out) {\n"
                       "  cudaError_t err = cudaMemcpyFromSymbol(out, g_snail_stamps, "
                       "sizeof(g_snail_stamps));\n"
                       "  long long zero[4 * ST_STAGES] = {};\n"
                       "  return err != cudaSuccess ? err : "
                       "cudaMemcpyToSymbol(g_snail_stamps, zero, sizeof(zero));\n}\n")
_OTHER = "before the loop, after it"


def _tick(k):
    return f"ST_TICK({k})"


# The parent's one-CTA-a-sample kernel: the text between the two markers is
# its kernel body (whose __syncthreads() are stamped); (anchor, stamp).
SNAIL_OLD = dict(
    marker="snail_loop_kernel(const float* __restrict__ canvas0,",
    body=("snail_loop_kernel(const float* __restrict__ canvas0,",
          "// Floats of device scratch the kernel needs per sample"),
    stages=("input conv", "residual block: tap gather (cache reads)",
            "rb conv 1: L2 weight loads", "rb conv 1: sums, mid tap gather",
            "rb conv 2: L2 weight loads", "rb conv 2: sums, gate", "q", "scores and softmax",
            "value pass", "op", "ro/ao", "o", "head and draw", "K/V append"),
    anchors=(
        ("  float* merged = red + kWarps;  // 1\n", None),
        ("    // The masked input conv's 4 live taps; at col == 0 the left-pad entry\n",
         "ST_POSITION(i)"),
        ("        // elu(res) into the elu cache at i and into tap 3; taps 0-2 (earlier\n",
         _tick(1)),
        ("        matvec_partial(ta, wt.rb1_w", _tick(2)),
        ("        // mid = elu(conv) into the mid cache at i and into tap 3.\n", _tick(3)),
        ("        matvec_partial(tb, wt.rb2_w", _tick(4)),
        ("        for (int c = tid; c < C; c += kThreads) {\n          const float* bias = wt.rb2_b",
         _tick(5)),
        ("      // q_in = [pos, res] (kept for the K/V append) and elu(res).\n", _tick(6)),
        ("      // Softmax attention over the cached keys < i.\n", _tick(7)),
        ("      const int gv = groups(1 << 30, DV);", _tick(8)),
        ("      matvec_partial(att, wt.op_w", _tick(9)),
        ("      float* part2 = part + partial_floats(C, C);\n", _tick(10)),
        ("      matvec_partial(u2, wt.o_w", _tick(11)),
        ("    // The head, the draw and the inpainting merge.\n", _tick(12)),
        ("    // Every block's k|v at i from [pos, res_b, merged pixel].\n", _tick(13)),
        ("  for (int p = tid; p < lp; p += kThreads)\n    canvas_out", "ST_FLUSH()"),
    ),
    wraps=(),
)
# The cluster kernel (PR 13): every __syncthreads() of the file after the
# header is stamped; the ring's wait and the cluster barriers are wrapped.
SNAIL_NEW = dict(
    marker="// Hands out the weight chunks in the order the chain uses them. Chunk u",
    body=("// Hands out the weight chunks in the order the chain uses them. Chunk u",
          "using Kernel = void (*)("),
    stages=("position start (canvas row, uniforms)", "input conv",
            "conv 1: product, sums, taps ahead, mid stores", "",
            "conv 2: product, sums, taps ahead, res stores", "", "q | kv: product and sums",
            "attention: this rank's keys", "attention: groups' merge, stores to the ranks",
            "attention: the ranks' combine", "op", "ro", "ao", "o", "head and draw",
            "K/V append", "ring wait (weights not landed)", "cluster barrier waits"),
    anchors=(
        ("  const BlockPrm bp = block_prm(dm, R);\n  float* prm", "ST_INIT()"),
        ("      if (col == 0) {  // padded row row + 1 and this row's uniforms\n",
         "ST_POSITION(i)"),
        ("      // The masked input conv's 4 live taps, alike on every rank.\n", _tick(1)),
        ("          product<SB, false>(feed, rp, kConv1", _tick(2)),
        ("          product<SB, true>(feed, rp, kConv2", _tick(4)),
        ("        // q_in = [pos, res]: q, and kv_proj's part of it (the merged pixel's\n",
         _tick(6)),
        ("        // Attention over this rank's keys < i, then over the ranks.\n", _tick(7)),
        ("  // The groups' partials of each sample, merged in group order by one warp:\n",
         _tick(8)),
        ("        for (int idx = tid; idx < ns * DV; idx += kThreads) {\n"
         "          const int s = idx / DV, d = idx - s * DV;\n          float mx", _tick(9)),
        ("        product<SB, false>(feed, rp, kOp", _tick(10)),
        ("        product<SB, false>(feed, rp, kRo", _tick(11)),
        ("        product<SB, false>(feed, rp, kAo", _tick(12)),
        ("        product<SB, false>(feed, rp, kOut", _tick(13)),
        ("      // The head, the draw and the inpainting merge, alike on every rank.\n",
         _tick(14)),
        ("      // The owner of position i appends every block's k|v at i.\n", _tick(15)),
        ("  cluster.sync();  // no rank leaves while another may still write to it\n",
         "ST_FLUSH()"),
    ),
    wraps=(("  mbar_wait(feed.full + s, rp.phase);\n", 16),
           ("        cluster_barrier(R);\n", 17)),
)


def _snail_stamped_source(src):
    """The kernel's source with the stage stamps and its stage names, or
    (None, None) for a kernel without anchors here; raises if an anchor
    line is missing."""
    spec = next((sp for sp in (SNAIL_NEW, SNAIL_OLD) if sp["marker"] in src), None)
    if spec is None:
        return None, None
    windows = " : ".join(f"(i) >= {a} && (i) < {b} ? {k}" for k, (a, b) in enumerate(SNAIL_WINDOWS))
    header = _SNAIL_STAMP_HEADER + f"#define ST_WINDOW(i) ({windows} : -1)\n"
    for anchor, stamp in spec["anchors"]:
        if anchor not in src:
            raise RuntimeError(f"--snail: csrc/snail_loop.cu has no line {anchor!r}")
        # None: the stamp state's initialisation goes after this line.
        src = (src.replace(anchor, anchor + "ST_INIT()\n", 1) if stamp is None
               else src.replace(anchor, stamp + "\n" + anchor, 1))
    for text, k in spec["wraps"]:
        if text not in src:
            raise RuntimeError(f"--snail: csrc/snail_loop.cu has no line {text!r}")
        src = src.replace(text, f"ST_WRAP({k}, {text.strip()})\n")
    head, rest = src.split(spec["body"][0], 1)
    body, tail = rest.split(spec["body"][1], 1)
    body = body.replace("__syncthreads();", "ST_SYNC();")
    src = head + spec["body"][0] + body + spec["body"][1] + tail
    src = src.replace("namespace {\n", "namespace {\n" + header, 1)
    names = list(spec["stages"]) + [""] * (18 - len(spec["stages"])) + [_OTHER,
                                                                         "CTA barrier waits"]
    return src + _SNAIL_STAMP_EXPORT, names


def snail_stages(smi, label, ck, dev):
    """The kernel's time split by stage at n = 16 and 64 (thread 0 of CTA
    0): microseconds a position, over all positions and near i = 100, 391
    and 783, by the clocks' share of the event-timed call."""
    src, names = _snail_stamped_source((ck.build.CSRC / "snail_loop.cu").read_text())
    if src is None:
        print(f"[{smi}] {label}: no stage stamps for this kernel", flush=True)
        return
    path = Path(tempfile.mkdtemp(prefix="snail_loop_stamps_")) / "snail_loop.cu"
    path.write_text(src)
    out = path.with_suffix(".so")
    proc = subprocess.run([ck.build._nvcc(), *ck.build.NVCC_FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the stamped snail_loop:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.snail_loop_stamps.argtypes = [ctypes.c_void_p]
    ck.build._loaded[ck.sdc.KERNEL] = lib
    stamps = torch.zeros(4 * 20, dtype=torch.int64)
    for n in SNAIL_STAMP_N:
        _, inputs = snail_setup(ck, n, dev)
        h, w = inputs[3], inputs[4]
        ck.sdc.fused_snail_sample_loop(*inputs)
        torch.cuda.synchronize()
        lib.snail_loop_stamps(stamps.data_ptr())  # drop the warm-up's
        ms = time_ms(lambda: ck.sdc.fused_snail_sample_loop(*inputs), iters=1, warmup=0)
        lib.snail_loop_stamps(stamps.data_ptr())
        st = stamps.reshape(4, 20).double()
        us_per_clock = ms * 1e3 / float(st[3].sum())
        print(f"[{smi}] stages {label} n={n}: stamped call {ms:.2f} ms, "
              f"{ms * 1e3 / (h * w):.2f} us a position; us a position, all positions | "
              + " | ".join(f"i {a}-{b - 1}" for a, b in SNAIL_WINDOWS), flush=True)
        for k, name in enumerate(names):
            if not name:
                continue
            per = [float(st[3, k]) * us_per_clock / (h * w)]
            per += [float(st[q, k]) * us_per_clock / (b - a)
                    for q, (a, b) in enumerate(SNAIL_WINDOWS)]
            print(f"[{smi}]   {name}: " + " | ".join(f"{v:.2f}" for v in per), flush=True)
        totals = [float(st[3].sum()) * us_per_clock / (h * w)]
        totals += [float(st[q].sum()) * us_per_clock / (b - a)
                   for q, (a, b) in enumerate(SNAIL_WINDOWS)]
        print(f"[{smi}]   a position: " + " | ".join(f"{v:.2f}" for v in totals), flush=True)
    del ck.build._loaded[ck.sdc.KERNEL]


def stream_rates():
    """Bytes a position one SM (and each rank of a cluster) pulls from L2
    into shared memory by a 16-byte cp.async ring (4 stages of 16 KB), for
    the reproduce() PixelSNAIL's weights; and the cost of a cluster
    barrier, with and without stores into the other ranks' shared memory,
    and of a CTA barrier."""
    smi, dev = _smi(), torch.device("cuda:0")
    path = ROOT / "tools" / "snail_stream.cu"
    out = Path(tempfile.mkdtemp(prefix="snail_stream_")) / "lib.so"
    sys.path.insert(0, str(ROOT))
    from pytorch_generative_tpu_torch.ops import _build
    sys.path.remove(str(ROOT))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.stream_copy.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4
                                + [ctypes.c_void_p] * 2)
    lib.barrier_loop.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    floats = 903_136  # the reproduce() PixelSNAIL's stacked weights (3.61 MB)
    src = torch.randn(floats + 64, device=dev)
    sink = torch.zeros(1024, device=dev)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    passes, stage = 64, 4096
    for ctas, cluster in ((1, 1), (16, 1), (64, 1), (132, 1), (8, 8), (128, 8), (4, 4), (64, 4),
                          (2, 2), (32, 2)):
        def run():
            err = lib.stream_copy(src.data_ptr(), floats, ctas, cluster, passes, stage,
                                  sink.data_ptr(), stream())
            if err:
                raise RuntimeError(f"stream_copy: cudaError {err}")
        ms = time_ms(run, iters=3, warmup=1)
        per_rank = floats // cluster * 4
        us = ms * 1e3 / passes
        print(f"[{smi}] stream {ctas} CTAs, clusters of {cluster}: {per_rank / 1e3:.1f} KB a rank "
              f"a pass, {us:.2f} us a pass, {per_rank / us / 1e3:.1f} GB/s a rank, "
              f"{per_rank * ctas / us / 1e3:.1f} GB/s in all", flush=True)
    iters = 20000
    for ctas, cluster, mode, what in ((8, 8, 0, "cluster barrier"),
                                      (8, 8, 1, "cluster barrier behind DSMEM stores"),
                                      (128, 8, 1, "cluster barrier behind DSMEM stores"),
                                      (4, 4, 1, "cluster barrier behind DSMEM stores"),
                                      (2, 2, 1, "cluster barrier behind DSMEM stores"),
                                      (1, 1, 2, "CTA barrier")):
        def run():
            err = lib.barrier_loop(ctas, cluster, iters, mode, sink.data_ptr(), stream())
            if err:
                raise RuntimeError(f"barrier_loop: cudaError {err}")
        ms = time_ms(run, iters=3, warmup=1)
        print(f"[{smi}] {what}, {ctas} CTAs in clusters of {cluster}: "
              f"{ms * 1e6 / iters:.1f} ns each", flush=True)



if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("sides", nargs="*", help="A_CHECKOUT A_LABEL B_CHECKOUT B_LABEL")
    parser.add_argument("--n", type=int, nargs="+", default=[16, 64, 256])
    parser.add_argument("--stages", action="store_true")
    parser.add_argument("--step", action="store_true")
    parser.add_argument("--timeline", action="store_true")
    parser.add_argument("--snail", action="store_true")
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--no-split", action="store_true",
                        help="with --snail: no stage split")
    parser.add_argument("--clusters", type=int, nargs="+",
                        help="with --snail: the cluster sizes the last checkout's plan may take")
    parser.add_argument("--depths", type=int, nargs="+",
                        help="with --snail: the ring depths the last checkout's plan may take")
    args = parser.parse_args()
    if args.stream:
        stream_rates()
    elif args.snail:
        if len(args.sides) not in (2, 4):
            parser.error("--snail takes A_CHECKOUT A_LABEL [B_CHECKOUT B_LABEL]")
        snail_compare(args.sides, args.n, args.clusters, not args.no_split, args.depths)
    elif args.timeline:
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

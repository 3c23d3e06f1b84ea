"""Times the PyTorch port's flash, fused attention block and fused MLP
kernels of one checkout of this repository on a CUDA card, so that two
checkouts can be compared in one run:

    python3 tools/torch_flash_times.py CHECKOUT LABEL [--dump FILE] [--steps]
    python3 tools/torch_flash_times.py CHECKOUT LABEL --vq [--steps] [--stages]
    python3 tools/torch_flash_times.py CHECKOUT LABEL --bf16 [--dump FILE] [--stages]
    python3 tools/torch_flash_times.py CHECKOUT LABEL --bf16-mlp [--dump FILE]
    python3 tools/torch_flash_times.py CHECKOUT LABEL --bf16-block
    python3 tools/torch_flash_times.py CHECKOUT LABEL --bf16-snail [--snail-variant NAME]
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
``--bf16`` times the flash kernels' bf16 mode instead (rows "1 bf16" and
"2 bf16" of PERF.md) at (B 64, L 784) with (H 2, d 32), (H 8, d 64) and
(H 4, d 128): forward and backward ms (20 calls after 3 warm-ups) beside
bf16 causal SDPA (20 calls) and autograd.grad through it (100 calls: its
time varies from call to call at d 32), the device time a forward and a
backward call spend in each kernel they launch (torch.profiler: at d 32
the calls' times are the wrappers' host work), then the registers and
spills of the checkout's bf16 flash kernels and every ptxas line that
names C7514 (wgmma serialised), or "no C7514", and the wrappers' host
time a call (200 calls at B 1, L 16, where the card's work is a few
microseconds, then one synchronize). ``--dump`` (in either mode)
also saves the bf16 kernels' outputs with their plain versions at (B 4, L
200, H 2) for d 16, 32, 64 and 128 with and without mask_center; ``--compare``
holds those, which change by design, against their plain versions at
``chip_smoke.py``'s bf16 gates (2^-7 of max(1, the largest magnitude), lse
1e-6 of it) and ends with whether every f32 entry (flash rows 1, 2 and 9,
the MLP and the LayerNorm) kept its bits. ``--bf16 --stages`` also builds
a copy of the checkout's ``csrc/flash_fwd.cu`` whose
``flash_wgmma_bf16.cuh`` has clock64() stamps of the forward's first
consumer thread and of its producer thread patched in at text anchors
(raises if an anchor changed) and prints, for the CTAs of the first and of the
last query tile at d 64 and 128, the median SM cycles from the consumer's
start to each event: Q landed, q2 ready, each key tile's stage full, its
scores landed, its softmax done, its P V done, the producer's issue of
each tile.
``--bf16-mlp`` times the fused MLP's bf16 mode instead (rows "6a bf16" to
"6d bf16" of PERF.md: the forward and the saved-y, recompute and pipelined
backwards, 20 calls after 3 warm-ups) at R 50,176 for C 512 and 1024 (F =
4C), beside the bf16 composition F.layer_norm -> addmm -> F.gelu -> addmm
-> + x and autograd.grad through it; the card's time of each kernel a
forward and a saved-y backward call launch (torch.profiler over 20 calls)
with each product's TFLOP/s (every product of those calls is 2 R C F
operations); the wrappers' host time a call (200 calls at R 64, C 512);
then every GEMM instance's registers and spills in the checkout's
mlp_fwd and mlp_bwd builds and every ptxas line that names C7514, or "no
C7514". ``--dump`` there saves what the default mode's ``--dump`` saves
and the bf16 MLP's outputs with their plain versions at R 4,097 for C 512
and 1024, which ``--compare`` holds at ``chip_smoke.py``'s bf16 gates
(2^-7 of max(1, the largest magnitude) for out, y and dx,
BF16_MLP_SUM_RTOL = 5e-4 for the f32 parameter sums), and ends with
whether every f32 entry kept its bits.
``--bf16-block`` times the fused attention block's bf16 mode (row "9
bf16") at (B 64, L 784) for C 64 / 2 heads, C 512 / 8 and C 512 / 4: the
forward and its projection entry (the backward's recompute), 20 calls
after 3 warm-ups, beside the bf16 composition addmm -> causal SDPA ->
addmm; the card's time of each kernel a forward and a projection call
launch (torch.profiler over 20 calls), with the projection GEMM's TFLOP/s
(2 B L C (2E + O) operations) and that of the forward's output
projection (its GEMM time less the projection's, 2 B L E C'); the
wrappers' host time a call; then the registers and spills of the
checkout's bf16 GEMM instances in attn_block_fwd.
``--bf16-snail`` times PixelSNAIL's flash pairs (rows "1 bf16 (4, 32)",
"2 bf16 (4, 32)", 1 and 2 at (4, 32), and (4, 8)) at (B 128, L 784, H 1,
mask_center), k and v column views of one kv tensor, in bf16 and in f32:
forward and backward, 20 calls after 3, beside masked SDPA of the same
type and autograd.grad through it; the card's time of each kernel a
forward and a backward call launch; the registers and spills of the
checkout's (4, 32) / (4, 8) kernels. ``--snail-variant NAME`` runs any
mode on a copy of the checkout's port in a temporary directory with one
of ``SNAIL_VARIANTS`` applied to ``csrc/flash_bwd_mma_small.cuh`` (raises
if an anchor text changed): ``k8`` (S and S^T by m16n8k8, d_k
zero-padded), ``g2`` (2-block sweeps), ``lb3`` (the dk/dv pass capped for
3 CTAs an SM).
``--vq`` times the fused vector-quantization kernel (row 8 of PERF.md,
``ops/vq_cuda.py``) instead, at the VQ-VAE reproduce() shape (M 8192 rows,
K 512 codes, D 64) on three inputs: rows and codebook drawn from N(0, 1)
("spread"), every row next to one code ("one code", a collapsed codebook)
and rows next to 8 codes ("8 codes"): each call's ms from 50 calls after
3 warm-ups ("eager", the wrapper's host work included) and from 10
replays of a CUDA graph of 20 calls ("graph", the card's time alone),
then the device time a call of each kernel the call launches
(torch.profiler over 20 calls), the card's name and power limit and the
kernel's registers and spills; with ``--steps`` also the VQ-VAE train step
(``Trainer.train_one_step``) and eval forward at batch 128 on the fused
route (PGT_FUSED_VQ=1), 10 calls after 3; with ``--stages`` also each
stage's cycles (clock64(), thread 0 of each CTA, min / median / max over
the CTAs) of a copy of the checkout's ``csrc/vq.cu`` with stamps patched in
at text anchors (raises if an anchor line changed): launch 1's first two
items landing, its codebook walk, the merge of the row blocks' bests, the
quantized rows' loads, the statistics and stores; launch 2's wait for
launch 1, its map reads, its sums and its stores.
"""

import argparse
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (batch, heads, d_k, d_v, mask_center) of the timed shapes, all at L = 784.
SHAPES = ((64, 2, 32, 32, False), (64, 8, 64, 64, False), (64, 4, 128, 128, False),
          (128, 1, 4, 32, True))
# (C, heads) of the fused attention block; the gates of the block's and
# the fused MLP's outputs against their plain versions (chip_smoke.py's
# BLOCK_RTOL = MLP_RTOL, a share of the largest magnitude, and
# BLOCK_LSE_TOL).
BLOCK_WIDTHS = ((64, 2), (512, 8), (512, 4))
RTOL, BLOCK_LSE_TOL = 1e-4, 5e-5
# The bf16 flash kernels' timed (heads, d) at (B 64, L 784), their dumped
# widths, and chip_smoke.py's bf16 gates (BF16_TOL, BF16_LSE_RTOL).
BF16_SHAPES = ((2, 32), (8, 64), (4, 128))
BF16_DIMS = (16, 32, 64, 128)
BF16_TOL, BF16_LSE_RTOL = 2.0 ** -7, 1e-6
BF16_MLP_SUM_RTOL = 5e-4
# The fused MLP's widths (F = 4C) and the rows it is timed and dumped at.
MLP_WIDTHS = (512, 1024)
MLP_ROWS, MLP_DUMP_ROWS = 50176, 4097
MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
# The fused VQ's shape on the VQ-VAE reproduce() path (batch 128 of 8 x 8
# latents against a 512 x 64 codebook) and its three inputs: how many codes
# the rows sit next to (None: rows and codebook both N(0, 1)).
VQ_SHAPE = (8192, 512, 64)
VQ_INPUTS = (("spread", None), ("one code", 1), ("8 codes", 8))
VQ_BATCH = 128


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


def bf16_main(ac, label, dev, time_ms):
    """The bf16 flash kernels' times beside bf16 SDPA, the card's time a
    forward and a backward call by kernel, their registers and spills, and
    any C7514 line."""
    import torch
    import torch.nn.functional as F

    out = []
    for h, d in BF16_SHAPES:
        q, k, v, do = (t.to(torch.bfloat16) for t in _operands(64, 784, h, d, d, 0, dev))
        o, lse = ac.flash_forward(q, k, v, False, h)
        f = time_ms(lambda: ac.flash_forward(q, k, v, False, h))
        bw = time_ms(lambda: ac.flash_backward(q, k, v, o, lse, do, False, h))
        q4, k4, v4 = (ac._unpack(t, h).contiguous().requires_grad_() for t in (q, k, v))
        do4 = ac._unpack(do, h).contiguous()

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

        ref = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        lib_f = time_ms(sdpa)
        lib_b = time_ms(lambda: torch.autograd.grad(ref, (q4, k4, v4), do4, retain_graph=True),
                        100)
        split_f = launch_split(lambda: ac.flash_forward(q, k, v, False, h))
        split = launch_split(lambda: ac.flash_backward(q, k, v, o, lse, do, False, h))
        out.append(f"(H {h}, d {d}): fwd {f:.4f} ms bwd {bw:.4f} ms, bf16 SDPA fwd {lib_f:.4f} "
                   f"ms autograd.grad {lib_b:.4f} ms; fwd by kernel: {split_f}; "
                   f"bwd by kernel: {split}")
    print(f"bf16 flash times {label} ({ac.__file__}) [{_card()}]: " + "; ".join(out), flush=True)
    # The wrappers' host work a call: (B 1, L 16), where the card's work is
    # a few microseconds, 200 calls in a row, then one synchronize.
    q, k, v, do = (t.to(torch.bfloat16) for t in _operands(1, 16, 2, 64, 64, 0, dev))
    o, lse = ac.flash_forward(q, k, v, False, 2)
    host = []
    for name, fn in (("fwd", lambda: ac.flash_forward(q, k, v, False, 2)),
                     ("bwd", lambda: ac.flash_backward(q, k, v, o, lse, do, False, 2))):
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        host.append(f"{name} {(time.perf_counter() - start) / 200 * 1e6:.1f} us")
    print(f"bf16 flash host time a call {label} (B 1, L 16, H 2, d 64): " + ", ".join(host),
          flush=True)
    for kernel in (ac.KERNEL, ac.BWD_KERNEL):
        lines = [ln for ln in _ptxas(ac, kernel) if "bf16" in ln or "wgmma" in ln]
        log = ac._build.library_path(kernel).with_suffix(".log").read_text()
        c7514 = [ln.strip() for ln in log.splitlines() if "C7514" in ln]
        print(f"{kernel} bf16 ptxas {label}: " + " | ".join(lines) + " | "
              + (" | ".join(c7514) if c7514 else "no C7514"), flush=True)


# Stamps patched into a copy of csrc/flash_wgmma_bf16.cuh: the forward's
# first consumer thread (slots 0-39: its first 9 key tiles) and its
# producer thread (40-47: its first 8 tiles) write clock64() after each
# anchor, in the first 4096 CTAs.
FWG_STAMP_HEADER = ("namespace fwg {\n", """namespace fwg {
__device__ long long g_stamps[4096][48];
#define FWG_STAMP(slot) { \\
    const unsigned cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\
    if (cta < 4096 && (slot) < 48) g_stamps[cta][slot] = clock64(); }
""")
FWG_STAMP_GETTER = """
extern "C" int flash_fwd_bf16_stamps(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, fwg::g_stamps, sizeof(fwg::g_stamps)));
}
extern "C" int flash_fwd_bf16_stamps_clear() {
  void* stamps = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&stamps, fwg::g_stamps);
  return static_cast<int>(err ? err : cudaMemset(stamps, 0, sizeof(fwg::g_stamps)));
}
"""
FWG_STAMPS = (  # (text put before the anchor, anchor, text put after it)
    ("", "      load_tile<BM, D>(qs, &tq, q_full, h, row0, b);\n"
     "      for (int j = 0; j < n_tiles; ++j) {\n        const int s = j % kStages;\n"
     "        if (j >= kStages) wg::wait(&empty[s], ((j / kStages) & 1) ^ 1);\n",
     "        if (j < 8) FWG_STAMP(40 + j)\n"),
    ("  const bool stamp = threadIdx.x == 128;\n  if (stamp) FWG_STAMP(0)\n",
     "  // q2 = bf16(q * scale * log2 e), the group's rows, in place.\n"
     "  wg::wait(q_full, 0);\n", "  if (stamp) FWG_STAMP(1)\n"),
    ("", "    scale_rows<BM, 64, D>(qs, 64 * grp, scale_log2, threadIdx.x % 128, 128);\n"
     "    wg::fence_async_shared();\n    wg::sync_threads(1 + grp, 128);\n  }\n",
     "  if (stamp) FWG_STAMP(2)\n"),
    ("", "    if (fresh) {  // S = q2 K_j^T\n      const int s = j % kStages;\n",
     "      if (stamp && j < 9) FWG_STAMP(3 + 4 * j)\n"),
    ("", "      if (lane == 0) wg::arrive(&empty[(j - 1) % kStages]);  // this warp has read "
     "the stage\n", "      if (stamp && j < 9) FWG_STAMP(2 + 4 * j)\n"),
    ("", "      // -inf, p = 0.\n      wg::hold(sc);\n",
     "      if (stamp && j < 9) FWG_STAMP(4 + 4 * j)\n"),
    ("", "      to_a<BN>(pa, sc);\n", "      if (stamp && j < 9) FWG_STAMP(5 + 4 * j)\n"),
    ("", "      // full would count toward a later use.\n"
     "      wg::wait(&full[j % kStages], (j / kStages) & 1);\n      __syncwarp();\n"
     "      if (lane == 0) wg::arrive(&empty[j % kStages]);\n    }\n  }\n\n",
     "  if (stamp) FWG_STAMP(39)\n"),
)


def stamped_bf16_forward(csrc):
    """The text of csrc/flash_wgmma_bf16.cuh with FWG_STAMPS patched in."""
    src = (csrc / "flash_wgmma_bf16.cuh").read_text()
    anchors = [FWG_STAMP_HEADER[0]] + [anchor for _, anchor, _ in FWG_STAMPS]
    for anchor in anchors:
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/flash_wgmma_bf16.cuh: stamp anchor {anchor!r} is not "
                             "found once")
    src = src.replace(*FWG_STAMP_HEADER)
    for before, anchor, after in FWG_STAMPS:
        src = src.replace(anchor, before + anchor + after)
    return src


def bf16_stages(ac, dev):
    """The bf16 forward's stamped timeline (``--bf16 --stages``): median SM
    cycles from the first consumer thread's start to each event, for the
    CTAs of the first (one key tile) and of the last query tile."""
    import ctypes

    import numpy as np
    import torch

    build = ac._build
    out = Path(tempfile.mkdtemp(prefix="flash_stages_"))
    (out / "flash_wgmma_bf16.cuh").write_text(stamped_bf16_forward(build.CSRC))
    (out / "flash_fwd.cu").write_text((build.CSRC / "flash_fwd.cu").read_text()
                                      + FWG_STAMP_GETTER)
    so = str(out / "flash_fwd.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", so,
                    str(out / "flash_fwd.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.flash_fwd_bf16_stamps.argtypes = [ctypes.c_void_p]
    saved = build._loaded.get(ac.KERNEL)
    build._loaded[ac.KERNEL] = lib
    names = {0: "start", 1: "Q landed", 2: "q2 ready", 39: "end"}
    for j in range(9):
        names.update({3 + 4 * j: f"t{j} full", 4 + 4 * j: f"t{j} scores", 5 + 4 * j: f"t{j} softmax"})
        if j:
            names[2 + 4 * j] = f"t{j - 1} PV"
    names.update({40 + j: f"issue t{j}" for j in range(8)})
    lines = []
    try:
        for h, d in ((8, 64), (4, 128)):
            q, k, v, _ = (t.to(torch.bfloat16) for t in _operands(64, 784, h, d, d, 0, dev))
            assert lib.flash_fwd_bf16_stamps_clear() == 0  # no stamps of the last width
            for _ in range(3):
                ac.flash_forward(q, k, v, False, h)
            torch.cuda.synchronize()
            st = np.zeros((4096, 48), dtype=np.int64)
            assert lib.flash_fwd_bf16_stamps(st.ctypes.data) == 0
            # Query tiles of 64 rows a consumer group: 3 groups a CTA at
            # d <= 64, 2 at d = 128 (fwg::groups).
            n_qt = -(-784 // (64 * (3 if d <= 64 else 2)))
            cta = np.arange(4096)
            for label, sel in (("first query tile", cta % n_qt == n_qt - 1),
                               ("last query tile", cta % n_qt == 0)):
                part = st[sel]
                part = part[part[:, 0] != 0]
                med = np.median(part - part[:, :1], axis=0)
                events = sorted((m, names[i]) for i, m in enumerate(med)
                                if i in names and (part[:, i] != 0).mean() > 0.9)
                lines.append(f"d {d}, {label} ({len(part)} CTAs): "
                             + ", ".join(f"{n} {m:.0f}" for m, n in events))
    finally:
        build._loaded[ac.KERNEL] = saved
        shutil.rmtree(out, ignore_errors=True)
    return lines


def _host_us(fn, n=200):
    """The host time a call of fn, in microseconds: n calls in a row, then
    one synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / n * 1e6


def _kernel_ms(fn, n=20):
    """{kernel: (ms a call, launches a call)} of each kernel fn launches,
    the card's time from torch.profiler over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0][:90]:
            (e.self_device_time_total / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


def bf16_block_main(label, dev, time_ms):
    """Row "9 bf16": the block's forward and recompute beside the bf16
    composition, by kernel with the GEMMs' TFLOP/s, host time a call and
    the GEMM instances' registers and spills."""
    import torch
    import torch.nn.functional as F

    from pytorch_generative_tpu_torch.ops import _build, attn_block_cuda

    bf = torch.bfloat16
    b, l = 64, 784
    for c, h in BLOCK_WIDTHS:
        ops = [t.to(bf) for t in _block_operands(b, l, c, 0, dev)]
        x, wq, bq, wkv, bkv, wo, bo = ops
        fwd = lambda: attn_block_cuda.attention_block_forward(*ops, False, h)  # noqa: E731
        proj = lambda: attn_block_cuda.project(*ops[:5])  # noqa: E731

        def composition():
            x2 = x.reshape(-1, c)
            q = torch.addmm(bq, x2, wq).view(b, l, h, -1).transpose(1, 2)
            kv = torch.addmm(bkv, x2, wkv).view(b, l, 2, h, -1)
            att = F.scaled_dot_product_attention(q, kv[:, :, 0].transpose(1, 2),
                                                 kv[:, :, 1].transpose(1, 2), is_causal=True)
            return torch.addmm(bo, att.transpose(1, 2).reshape(b * l, c), wo)

        times = {"forward": time_ms(fwd), "recompute": time_ms(proj),
                 "bf16 composition": time_ms(composition)}
        by_fwd, by_proj = _kernel_ms(fwd), _kernel_ms(proj)
        gemm = lambda by: sum(ms for k_, (ms, _) in by.items() if "gemm" in k_)  # noqa: E731
        proj_ms, fwd_gemm_ms = gemm(by_proj), gemm(by_fwd)
        proj_flops, out_flops = 2 * b * l * c * 3 * c, 2 * b * l * c * c
        rates = (f"projection GEMMs {proj_ms:.4f} ms a call, {proj_flops / proj_ms / 1e9:.1f} "
                 f"TFLOP/s; output projection {fwd_gemm_ms - proj_ms:.4f} ms, "
                 f"{out_flops / max(fwd_gemm_ms - proj_ms, 1e-9) / 1e9:.1f} TFLOP/s")
        print(f"bf16 block times {label} (C {c}, H {h}, B {b}, L {l}) [{_card()}] ms: "
              + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in times.items()) + f"; {rates}; "
              "forward by kernel: " + ", ".join(
                  f"{k_} {ms:.4f} ms ({n:g}x)" for k_, (ms, n) in by_fwd.items())
              + "; recompute by kernel: " + ", ".join(
                  f"{k_} {ms:.4f} ms ({n:g}x)" for k_, (ms, n) in by_proj.items()), flush=True)
        del ops
    ops = [t.to(bf) for t in _block_operands(1, 64, 512, 0, dev)]
    print(f"bf16 block host time a call {label} (B 1, L 64, C 512, H 8): forward "
          f"{_host_us(lambda: attn_block_cuda.attention_block_forward(*ops, False, 8)):.1f} "
          f"us, recompute {_host_us(lambda: attn_block_cuda.project(*ops[:5])):.1f} us",
          flush=True)
    lines = [ln for ln in _ptxas(attn_block_cuda, "attn_block_fwd") if "wgemm" in ln]
    log = _build.library_path("attn_block_fwd").with_suffix(".log").read_text()
    c7514 = [ln.strip() for ln in log.splitlines() if "C7514" in ln]
    print(f"attn_block_fwd bf16 GEMM ptxas {label}: " + " | ".join(lines) + " | "
          + (" | ".join(c7514) if c7514 else "no C7514"), flush=True)


# Variants of the f32 (4, 32) / (4, 8) backward (csrc/flash_bwd_mma_small.cuh)
# that --snail-variant builds in a copy of a checkout: each a list of (old,
# new) text replacements, each old text found exactly once. "k8": S and S^T
# by m16n8k8 with d_k zero-padded to 8 in place of m16n8k4; "g2": 2-block
# sweeps in place of 4; "lb3": the dk/dv pass capped at 168 registers so
# that 3 CTAs fit an SM.
SNAIL_VARIANTS = {
    "k8": [(f"  for (int n = 0; n < N; ++n) tf32::mma_k4(acc[n], {a}, {b}[n]);",
            f"  for (int n = 0; n < N; ++n)\n"
            f"    tf32::mma(acc[n], {{{a}[0], {a}[1], 0.f, 0.f}}, {{{b}[n], 0.f}});")
           for a, b in (("a_small", "b_big"), ("a_big", "b_small"), ("a_big", "b_big"))],
    "g2": [("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")],
    "lb3": [("__global__ void __launch_bounds__(kThreads)\ndkdv_kernel(",
             "__global__ void __launch_bounds__(kThreads, 3)\ndkdv_kernel(")],
}


def snail_variant(checkout, name):
    """A copy of checkout's port under a new temporary directory with
    SNAIL_VARIANTS[name] applied to csrc/flash_bwd_mma_small.cuh (raises if
    an anchor text is not there once); returns the copy's root."""
    root = Path(tempfile.mkdtemp(prefix=f"snail_{name}_"))
    pkg = root / "pytorch_generative_tpu_torch"
    shutil.copytree(Path(checkout) / "pytorch_generative_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    header = pkg / "csrc" / "flash_bwd_mma_small.cuh"
    text = header.read_text()
    for old, new in SNAIL_VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: anchor not found once: {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    return str(root)


def snail_main(ac, label, dev, time_ms):
    """PixelSNAIL's flash pairs in bf16 and in f32 beside masked SDPA of the
    same type, each call by kernel, and the flash kernels' registers and
    spills."""
    import torch
    import torch.nn.functional as F

    from pytorch_generative_tpu_torch.ops.masks import causal_attention_mask

    b, l = 128, 784
    mask = causal_attention_mask(l, True, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        for d_k, d_v in ((4, 32), (4, 8)):
            q, k, v, do = (t.to(dt) for t in _operands(b, l, 1, d_k, d_v, 0, dev))
            o, lse = ac.flash_forward(q, k, v, True, 1)
            fwd = lambda: ac.flash_forward(q, k, v, True, 1)  # noqa: E731
            bwd = lambda: ac.flash_backward(q, k, v, o, lse, do, True, 1)  # noqa: E731
            f, bw = time_ms(fwd), time_ms(bwd)
            q4, k4, v4 = (ac._unpack(t, 1).contiguous().requires_grad_() for t in (q, k, v))
            do4 = ac._unpack(do, 1).contiguous()

            def sdpa():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

            ref = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
            lib_f = time_ms(sdpa)
            lib_b = time_ms(lambda: torch.autograd.grad(ref, (q4, k4, v4), do4,
                                                        retain_graph=True))
            by = lambda fn: ", ".join(  # noqa: E731
                f"{k_} {ms:.4f} ms ({n:g}x)" for k_, (ms, n) in _kernel_ms(fn).items())
            name = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"{name} snail flash times {label} (B {b}, L {l}, H 1, d_k {d_k}, d_v {d_v}, "
                  f"mask_center) [{_card()}]: fwd {f:.4f} ms bwd {bw:.4f} ms, {name} masked "
                  f"SDPA fwd {lib_f:.4f} ms autograd.grad {lib_b:.4f} ms; fwd by kernel: "
                  f"{by(fwd)}; bwd by kernel: {by(bwd)}", flush=True)
            del q, k, v, do, o, lse, q4, k4, v4, do4, ref
    for kernel in (ac.KERNEL, ac.BWD_KERNEL):
        print(f"{kernel} ptxas {label}: " + " | ".join(
            ln for ln in _ptxas(ac, kernel) if "fsmall" in ln or "smma" in ln
            or "flash_fwd_kernel" in ln), flush=True)


def _bf16_outputs(ac, dev):
    """The bf16 flash kernels' outputs and their plain versions at (B 4, L
    200, H 2) for BF16_DIMS, with and without mask_center."""
    import torch

    results = {}
    for d in BF16_DIMS:
        q, k, v, do = (t.to(torch.bfloat16)
                       for t in _operands(4, 200, 2, d, d, 7000 + d, dev))
        for mask_center in (False, True):
            o, lse = ac.flash_forward(q, k, v, mask_center, 2)
            grads = ac.flash_backward(q, k, v, o, lse, do, mask_center, 2)
            po, plse = ac.flash_forward_plain(q, k, v, mask_center, 2)
            pgrads = ac.flash_backward_plain(q, k, v, o, lse, do, mask_center, 2)
            entry = {}
            for name, got, want in zip(("out", "lse", "dq", "dk", "dv"), (o, lse, *grads),
                                       (po, plse, *pgrads)):
                entry[name], entry[f"plain {name}"] = got.float().cpu(), want.float().cpu()
            results[f"bf16 {d}x{d} mask_center={mask_center}"] = entry
    return results


def _bf16_mlp_calls(ops, y):
    """_mlp_calls on bf16 operands, under PERF.md's bf16 row names."""
    return {row.split()[0] + " bf16": fns for row, fns in _mlp_calls(ops, y).items()}


def _product_split(fn, flops, n=20):
    """'kernel ms (count x) [TFLOP/s]' of each kernel fn launches, the card's
    time a launch from torch.profiler over n calls; a GEMM launch (a name
    holding gemm_kernel) is also given its rate at `flops` operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        ms = e.self_device_time_total / 1e3 / e.count
        rate = f" {flops / ms / 1e9:.1f} TFLOP/s" if "gemm_kernel" in name else ""
        out.append(f"{name[:90]} {ms:.4f} ms ({e.count / n:g}x){rate}")
    return "; ".join(out)


def bf16_mlp_main(label, dev, time_ms):
    """Rows 6a-6d bf16 beside the bf16 composition and autograd.grad
    through it, the card's time by kernel with the products' TFLOP/s, the
    wrappers' host time a call, and the GEMM instances' registers, spills
    and C7514 lines."""
    import torch
    import torch.nn.functional as F

    from pytorch_generative_tpu_torch.ops import _build, mlp_cuda

    bf = torch.bfloat16
    for c in MLP_WIDTHS:
        ops = [t.to(bf) for t in _mlp_operands(MLP_ROWS, c, 0, dev)]
        _, y = mlp_cuda.ln_mlp_forward(*ops[:7], 1e-5)
        calls = _bf16_mlp_calls(ops, y)
        res = [f"{row} {time_ms(kern):.4f}" for row, (kern, _) in calls.items()]
        leaves = [t.detach().requires_grad_() for t in ops[:7]]
        x, gamma, beta, w1, b1, w2, b2 = leaves

        def composition():
            return torch.addmm(b2, F.gelu(torch.addmm(b1, F.layer_norm(
                x, (c,), gamma, beta, 1e-5), w1)), w2) + x

        with torch.no_grad():
            res.append(f"bf16 composition {time_ms(composition):.4f}")
        graph = composition()
        res.append("autograd.grad through it " + format(time_ms(
            lambda: torch.autograd.grad(graph, leaves, ops[7], retain_graph=True)), ".4f"))
        print(f"bf16 mlp times {label} (R {MLP_ROWS}, C {c}) [{_card()}] ms: " + ", ".join(res),
              flush=True)
        flops = 2 * MLP_ROWS * c * 4 * c
        for row in ("6a bf16", "6b bf16"):
            print(f"bf16 mlp by kernel {label} (R {MLP_ROWS}, C {c}) {row}: "
                  + _product_split(calls[row][0], flops), flush=True)
        del ops, y, leaves, graph, calls
    ops = [t.to(bf) for t in _mlp_operands(64, 512, 0, dev)]
    _, y = mlp_cuda.ln_mlp_forward(*ops[:7], 1e-5)
    host = []
    for row, (fn, _) in _bf16_mlp_calls(ops, y).items():
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        host.append(f"{row} {(time.perf_counter() - start) / 200 * 1e6:.1f} us")
    print(f"bf16 mlp host time a call {label} (R 64, C 512): " + ", ".join(host), flush=True)
    for kernel in ("mlp_fwd", "mlp_bwd"):
        lines = [ln for ln in _ptxas(mlp_cuda, kernel) if "gemm" in ln]
        log = _build.library_path(kernel).with_suffix(".log").read_text()
        c7514 = [ln.strip() for ln in log.splitlines() if "C7514" in ln]
        print(f"{kernel} GEMM ptxas {label}: " + " | ".join(lines) + " | "
              + (" | ".join(c7514) if c7514 else "no C7514"), flush=True)


def _bf16_mlp_outputs(dev):
    """{entry: {name: tensor}} of rows 6a-6d bf16 at R = MLP_DUMP_ROWS and,
    under "plain " names, of their plain versions on the same inputs."""
    import torch

    out = {}
    for c in MLP_WIDTHS:
        ops = [t.to(torch.bfloat16) for t in _mlp_operands(MLP_DUMP_ROWS, c, c + 1, dev)]
        from pytorch_generative_tpu_torch.ops import mlp_cuda

        _, y = mlp_cuda.ln_mlp_forward(*ops[:7], 1e-5)
        for row, (kern, plain) in _bf16_mlp_calls(ops, y).items():
            names = ("out", "y") if row.startswith("6a") else MLP_GRADS
            out[f"bf16 mlp C={c} {row}"] = {
                **{name: t.float().cpu() for name, t in zip(names, kern())},
                **{f"plain {name}": t.float().cpu() for name, t in zip(names, plain())}}
        del ops, y
    return out


def _outputs(ac, dev):
    """What the default mode's --dump saves: the flash kernels' outputs for
    every (d_k, d_v) the checkout builds at (B 4, L 200, H 2), and those of
    _block_outputs, _mlp_outputs and _bf16_outputs."""
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
    results.update(_bf16_outputs(ac, dev))
    return results


def main(checkout, label, dump=None, steps=False, vq=False, stages=False, bf16=False,
         bf16_mlp=False, bf16_block=False, bf16_snail=False, snail_variant_name=None):
    if snail_variant_name:
        checkout = snail_variant(checkout, snail_variant_name)
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

    if vq:
        vq_main(label, dev, time_ms, steps, stages)
        return
    if bf16_block:
        bf16_block_main(label, dev, time_ms)
        return
    if bf16_snail:
        snail_main(ac, label, dev, time_ms)
        return
    if bf16_mlp:
        bf16_mlp_main(label, dev, time_ms)
        if dump:
            torch.save({**_outputs(ac, dev), **_bf16_mlp_outputs(dev)}, dump)
        return
    if bf16:
        bf16_main(ac, label, dev, time_ms)
        if stages:
            for line in bf16_stages(ac, dev):
                print(f"bf16 forward stages {label} (SM cycles from the start): {line}",
                      flush=True)
        if dump:
            torch.save(_bf16_outputs(ac, dev), dump)
        return
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
        torch.save(_outputs(ac, dev), dump)
    if steps:
        print(f"train steps {label}: " + "; ".join(
            f"{name} {ms:.3f} ms" for name, ms in step_times(dev, time_ms)), flush=True)


def _card():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()


def vq_operands(n_codes, dev):
    """x (M, D) and codebook (K, D) at VQ_SHAPE from one seed: with n_codes,
    row m lies 0.01 N(0, 1) away from code (m % n_codes) * 61 % K."""
    import torch

    m, k, d = VQ_SHAPE
    g = torch.Generator().manual_seed(0)
    cb = torch.randn((k, d), generator=g)
    x = torch.randn((m, d), generator=g)
    if n_codes:
        x = cb[torch.arange(m) % n_codes * 61 % k] + 0.01 * x
    return x.to(dev), cb.to(dev)


def graph_ms(fn, calls=20, replays=10):
    """ms a call of fn, from replays of one CUDA graph of `calls` calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / calls


def launch_split(fn, n=20):
    """'kernel ms, ...': device time a call of each kernel that fn
    launches, from torch.profiler over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key.replace("(anonymous namespace)::", "").split("(")[0],
             e.self_device_time_total / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return ", ".join(f"{name} {ms:.4f} ms ({count:g}x)" for name, ms, count in rows)


# Stamps patched into a copy of csrc/vq.cu: thread 0 of each CTA writes
# clock64() after each anchor line (launch 1 into rows 0-5, launch 2 into
# rows 8-12 of each CTA's slot).
VQ_STAMP_HEADER = ("namespace {\n", """namespace {
__device__ long long g_stamps[2][8192][8];
#define STAMP(k, j) if (threadIdx.x == 0) g_stamps[k][blockIdx.x][j] = clock64();
""")
VQ_STAMP_GETTER = ("}  // namespace\n", """}  // namespace
extern "C" int vq_stamps(long long* out) {
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
""")
VQ_STAMPS = (
    ('  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n', (0, 0)),
    ("  transform(0);\n", (0, 1)),
    ("    merge(acc, nrm2, it / n_chunks, chunk == n_chunks - 1);\n  }\n", (0, 2)),
    ("    idx_s[r] = bi < K ? bi : 0;  // code 0 is always scored: never K\n  }\n"
     "  __syncthreads();\n", (0, 3)),
    ("      qv[u] = reinterpret_cast<const float4*>(row)[i % nv4];\n    }\n  }\n", (0, 4)),
    ("    if (i < nv * nv4) reinterpret_cast<float4*>(quant + static_cast<int64_t>(m0) * D)[i] "
     "= qv[u];\n  }\n", (0, 5)),
    ("  int cnt = 0;\n", (1, 0)),
    ('  asm volatile("griddepcontrol.wait;\\n" ::: "memory");  // launch 1 is done\n', (1, 1)),
    ("    __syncthreads();\n    int n = 0;  // entries of code c\n", (1, 2)),
    ("    __syncthreads();  // list_s and part_s are read before the next round writes them\n"
     "  }\n", (1, 3)),
    ("    if (v == 0) counts[k0 + c] = static_cast<float>(cnt);\n  }\n", (1, 4)),
)
VQ_STAGE_NAMES = (("launch 1", ("first items landed", "codebook walk", "merge",
                                "quantized loads", "statistics and stores")),
                  ("launch 2", ("wait for launch 1", "map reads", "sums", "stores")))


def vq_stages(vq_cuda, x, cb):
    """'stage cycles min/median/max, ...' of a stamped copy of the
    checkout's csrc/vq.cu on (x, cb)."""
    import ctypes
    import numpy as np
    import torch

    src = (vq_cuda._build.CSRC / "vq.cu").read_text()
    for anchor, _ in (VQ_STAMP_HEADER, VQ_STAMP_GETTER, *VQ_STAMPS):
        if src.count(anchor) != 1:
            raise ValueError(f"csrc/vq.cu: stamp anchor {anchor!r} is not found once")
    for anchor, stamp in (VQ_STAMP_HEADER, VQ_STAMP_GETTER):
        src = src.replace(anchor, stamp)
    for anchor, (k, j) in VQ_STAMPS:
        src = src.replace(anchor, anchor + f"  STAMP({k}, {j})\n")
    out = tempfile.mkdtemp(prefix="vq_stages_")
    (Path(out) / "vq.cu").write_text(src)
    so = f"{out}/vq.so"
    subprocess.run([vq_cuda._build._nvcc(), *vq_cuda._build.NVCC_FLAGS, "-I",
                    str(vq_cuda._build.CSRC), "-o", so, f"{out}/vq.cu"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.vq_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.vq_stamps.argtypes = [ctypes.c_void_p]
    (m, d), k = x.shape, cb.shape[0]
    quantized, counts = torch.empty_like(x), torch.empty((k,), device=x.device)
    sums = torch.empty((k, d), device=x.device)
    table = torch.empty((vq_cuda.scratch_bytes(m, k, d),), device=x.device, dtype=torch.uint8)
    n_blocks = -(-m // vq_cuda.BLOCK_ROWS)
    t_count = table.data_ptr() + 4 * n_blocks * vq_cuda.BLOCK_ROWS * d
    t_pos = t_count + 4 * n_blocks * vq_cuda.BLOCK_ROWS
    for _ in range(3):
        err = lib.vq_f32(x.data_ptr(), cb.data_ptr(), quantized.data_ptr(), counts.data_ptr(),
                         sums.data_ptr(), t_pos, t_count, table.data_ptr(), m, k, d,
                         torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"vq_f32: cudaError {err}"
    torch.cuda.synchronize()
    stamps = np.zeros((2, 8192, 8), dtype=np.int64)
    assert lib.vq_stamps(stamps.ctypes.data) == 0
    shutil.rmtree(out, ignore_errors=True)
    parts = []
    for kernel, ((launch, names), ctas) in enumerate(zip(VQ_STAGE_NAMES, (n_blocks, -(-k // 4)))):
        st = stamps[kernel, :ctas]
        for j, name in enumerate(names):
            dt = st[:, j + 1] - st[:, j]
            parts.append(f"{launch} {name} {dt.min()}/{int(np.median(dt))}/{dt.max()}")
    return ", ".join(parts)


def vq_main(label, dev, time_ms, steps, stages=False):
    """Row 8's times on VQ_INPUTS, the split by launch, registers and, with
    steps, the VQ-VAE fused-route step and forward."""
    import torch

    from pytorch_generative_tpu_torch.ops import vq_cuda

    m, k, d = VQ_SHAPE
    times, splits = [], []
    for name, n_codes in VQ_INPUTS:
        x, cb = vq_operands(n_codes, dev)
        _, counts, _ = vq_cuda.vq_quantize_fused(x, cb)
        used = int((counts > 0).sum())
        ms = time_ms(lambda: vq_cuda.vq_quantize_fused(x, cb), n=50)
        g_ms = graph_ms(lambda: vq_cuda.vq_quantize_fused(x, cb))
        times.append(f"{name} ({used} codes used) eager {ms:.4f} ms, graph {g_ms:.4f} ms")
        splits.append(f"{name}: " + launch_split(lambda: vq_cuda.vq_quantize_fused(x, cb)))
    print(f"vq times {label} [{_card()}] (M {m}, K {k}, D {d}): " + "; ".join(times),
          flush=True)
    print(f"vq split {label}: " + " | ".join(splits), flush=True)
    print(f"vq ptxas {label}: " + " | ".join(_ptxas(vq_cuda, vq_cuda.KERNEL)), flush=True)
    if stages:
        for name, n_codes in VQ_INPUTS:
            print(f"vq stages {label} {name}: " + vq_stages(vq_cuda, *vq_operands(n_codes, dev)),
                  flush=True)
    if steps:
        print(f"vq-vae steps {label}: " + "; ".join(
            f"{name} {ms:.3f} ms" for name, ms in vq_vae_times(dev, time_ms)), flush=True)


def vq_vae_times(dev, time_ms):
    """(name, ms) of the VQ-VAE reproduce() train step and eval forward at
    batch 128 on the fused route."""
    import os

    import numpy as np
    import torch

    from pytorch_generative_tpu_torch import optim, trainer
    from pytorch_generative_tpu_torch.models import VectorQuantizedVAE
    from pytorch_generative_tpu_torch.models.vae import vq_vae

    os.environ["PGT_FUSED_VQ"] = "1"  # read when the quantizer is built
    cfg = vq_vae.REPRODUCE_CONFIG
    net = VectorQuantizedVAE(**cfg, generator=torch.Generator().manual_seed(0), device=dev)
    os.environ.pop("PGT_FUSED_VQ")
    t = trainer.Trainer(net, vq_vae.reproduce_loss, optim.adam_multiplicative(2e-4, 0.999977),
                        [], [], log_dir=tempfile.mkdtemp(prefix="vq_times_"),
                        use_tensorboard=False, device=dev)
    xb = np.random.default_rng(1).random((VQ_BATCH, *cfg["in_shape"])).astype(np.float32)
    xs = torch.from_numpy(xb).to(dev)

    def forward():
        net.eval()
        with torch.no_grad():
            return net(xs)

    out = [("train step", time_ms(lambda: t.train_one_step(xb, None), n=10)),
           ("forward", time_ms(forward, n=10))]
    shutil.rmtree(t.log_dir, ignore_errors=True)
    return out


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


def _within_bf16_gates(entry):
    """'name e of m, ...: ok' of a dump's bf16 flash or MLP outputs against
    their plain versions at the bf16 gates (e the largest error, m max(1,
    the plain's largest magnitude); lse over its finite entries, -inf on
    the same rows; the MLP's f32 parameter sums at BF16_MLP_SUM_RTOL)."""
    import torch

    parts, ok = [], True
    for name in (n for n in entry if not n.startswith("plain ")):
        got, want = entry[name], entry[f"plain {name}"]
        finite = torch.isfinite(want)
        ok &= torch.equal(torch.isfinite(got), finite)
        err = float((got - want)[finite].abs().max()) if finite.any() else 0.0
        scale = max(1.0, float(want[finite].abs().max()) if finite.any() else 0.0)
        tol = (BF16_LSE_RTOL if name == "lse" else BF16_MLP_SUM_RTOL
               if name in MLP_GRADS and name != "dx" else BF16_TOL)
        ok &= err <= tol * scale
        parts.append(f"{name} {err:.3e} of {scale:.3e}")
    return ", ".join(parts) + (" (within the gates)" if ok else " (OUTSIDE THE GATES)")


def compare(file_a, file_b):
    import torch

    a, b = torch.load(file_a), torch.load(file_b)
    f32_equal = True
    for key in sorted(set(a) & set(b)):
        names = [name for name in a[key] if not name.startswith("plain ")]
        same = [name for name in names if torch.equal(a[key][name], b[key][name])]
        note = "" if len(same) == len(names) else " (DIFFER)"
        if key.startswith("bf16"):
            note = (f"{note}; against the plain version: A {_within_bf16_gates(a[key])}; B "
                    f"{_within_bf16_gates(b[key])}")
        elif note:
            f32_equal = False
            if key.startswith(("block", "mlp")):
                note = (" (changed by design?); against the plain version: A "
                        f"{_within_gates(a[key])}; B {_within_gates(b[key])}")
        print(f"bits {key}: equal {', '.join(same) or 'none'} of {len(names)} outputs{note}",
              flush=True)
    print(f"bits of every f32 entry (flash rows 1, 2 and 9, MLP, LayerNorm): "
          f"{'all equal' if f32_equal else 'SOME DIFFER'}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        parser = argparse.ArgumentParser()
        parser.add_argument("checkout")
        parser.add_argument("label")
        parser.add_argument("--dump")
        parser.add_argument("--steps", action="store_true")
        parser.add_argument("--vq", action="store_true")
        parser.add_argument("--stages", action="store_true")
        parser.add_argument("--bf16", action="store_true")
        parser.add_argument("--bf16-mlp", action="store_true")
        parser.add_argument("--bf16-block", action="store_true")
        parser.add_argument("--bf16-snail", action="store_true")
        parser.add_argument("--snail-variant", choices=sorted(SNAIL_VARIANTS))
        args = parser.parse_args()
        main(args.checkout, args.label, args.dump, args.steps, args.vq, args.stages, args.bf16,
             args.bf16_mlp, args.bf16_block, args.bf16_snail, args.snail_variant)

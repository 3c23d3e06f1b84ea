"""Times the port's 3xTF32 GEMM (``csrc/gemm_tf32x3.cuh``, the products of
the fused attention block and of the fused MLP), its bias product
``gemm3::gemm``, at other tilings and ring depths, and a trial of the same
product on Hopper's warpgroup instruction (``tools/gemm_wgmma_trial.cuh``),
beside ``torch.addmm`` in f32 (TF32 off), on one CUDA card:

    python3 tools/torch_gemm_variants.py

Builds every variant with ``nvcc`` (one process a build, all at once,
under the package's git-ignored ``build/variants/``): the port's header
with its k-step (``kBK``) and ring depth (``kStages``) set to each of (32,
3) (the port's), (32, 2), (32, 4), (16, 3) and (16, 4), each at CTA tiles
128 x 64 (the port's), 128 x 128, 64 x 128 and 64 x 64; and the wgmma trial
with one or two warpgroups a CTA and 64 or 128 columns, waiting for each
k-step or keeping one in flight. Checks every
variant against a float64 product at ragged shapes (the largest error as a
share of the largest magnitude, and equal bits from two calls), then times
them (CUDA events, 20 calls after 3) at M = 50,176 (ImageGPT's B L at batch
64): K = 512 with N = 512, 1024 and 1536 (C = 512: the output projection,
wkv, and q and kv as one), and K = 64 with N = 64 and 128 (C = 64). The
trial's times include its transpose-and-split pass over w. Prints TFLOP/s
as 2 M N K over the time, and each build's registers, spills and ptxas's
performance warnings.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (kBK, kStages) of the port's header, the port's first; CTA tiles (BM, BN).
RINGS = ((32, 3), (32, 2), (32, 4), (16, 3), (16, 4))
TILES = ((128, 64), (128, 128), (64, 128), (64, 64))
# The wgmma trial's (warpgroups, columns, a k-step kept in flight).
TRIALS = ((2, 128, False), (2, 64, False), (1, 128, False), (1, 64, False),
          (2, 128, True), (2, 64, True))
CHECKS = ((400, 512, 512), (183, 64, 68), (400, 2048, 128), (1, 512, 4))
TIMED = ((512, 512), (512, 1024), (512, 1536), (64, 64), (64, 128))
M = 50176


def _entry(calls, wgmma):
    """A .cu source whose C entry `variant(v, ...)` runs calls[v]."""
    args = "a, w, bias, out, wt, M, N, K, s" if wgmma else "a, w, bias, out, M, N, K, s"
    cases = "".join(f"    case {i}: return {c}({args});\n" for i, c in enumerate(calls))
    return (f'#include "{"gemm_wgmma_trial.cuh" if wgmma else "gemm_var.cuh"}"\n'
            'extern "C" int variant(int v, const float* a, const float* w, const float* bias, '
            'float* out, float* wt, int M, int N, int K, void* stream) {\n'
            '  cudaStream_t s = static_cast<cudaStream_t>(stream);\n  (void)wt;\n'
            f'  switch (v) {{\n{cases}  }}\n  return 1;\n}}\n')


def build_all():
    """{name: (ctypes entry, [variant labels])}, building in parallel."""
    from pytorch_generative_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    header = (_build.CSRC / "gemm_tf32x3.cuh").read_text()
    jobs = {}
    for bk, stages in RINGS:
        src = header.replace("constexpr int kBK = 32;", f"constexpr int kBK = {bk};")
        src = src.replace("constexpr int kStages = 3;", f"constexpr int kStages = {stages};")
        assert f"kBK = {bk};" in src and f"kStages = {stages};" in src
        d = out / f"k{bk}s{stages}"
        d.mkdir(exist_ok=True)
        (d / "gemm_var.cuh").write_text(src)
        (d / "v.cu").write_text(_entry([f"gemm3::gemm<{bm}, {bn}>" for bm, bn in TILES], False))
        jobs[f"mma.sync kBK {bk} stages {stages}"] = (
            d, [f"{bm}x{bn}" for bm, bn in TILES])
    d = out / "wgmma"
    d.mkdir(exist_ok=True)
    (d / "v.cu").write_text(_entry(
        [f"wg3::gemm<{w}, {n}, {str(f).lower()}>" for w, n, f in TRIALS], True))
    jobs["wgmma trial"] = (d, [f"{64 * w}x{n}{' in flight' if f else ''}"
                               for w, n, f in TRIALS])
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", f"-I{ROOT / 'tools'}",
         "-o", str(d / "v.so"), str(d / "v.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (d, _) in jobs.items()}
    built = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [ln.split("stack frame,")[1].strip() for ln in log.splitlines()
                  if "spill stores" in ln]
        warnings = sorted({ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
                           if "Performance Loss" in ln})
        print(f"build {name}: registers {regs}; spills {sorted(set(spills))}"
              + "".join(f"; ptxas: {w}" for w in warnings), flush=True)
        fn = ctypes.CDLL(str(jobs[name][0] / "v.so")).variant
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        built[name] = (fn, jobs[name][1])
    return built


def main():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gemm variants [{smi}]: torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    built = build_all()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(0)

    def operands(m, k, n):
        a = torch.randn((m, k), generator=g).to(dev)
        w = (torch.randn((k, n), generator=g) / k ** 0.5).to(dev)
        bias = torch.randn((n,), generator=g).to(dev)
        return a, w, bias, torch.empty((m, n), device=dev), torch.empty((2 * k * n,), device=dev)

    def run(fn, v, a, w, bias, out, wt):
        err = fn(v, a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), wt.data_ptr(),
                 a.shape[0], w.shape[1], a.shape[1], stream)
        if err:
            raise RuntimeError(f"variant {v} failed to launch: cudaError {err}")

    def time_ms(fn, n=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    variants = [(name, fn, v, label) for name, (fn, labels) in built.items()
                for v, label in enumerate(labels)]
    for m, k, n in CHECKS:
        ops = operands(m, k, n)
        want = ops[0].double() @ ops[1].double() + ops[2].double()
        res = []
        for name, fn, v, label in variants:
            run(fn, v, *ops)
            first = ops[3].clone()
            run(fn, v, *ops)
            torch.cuda.synchronize()
            err = float((first.double() - want).abs().max() / want.abs().max())
            same = torch.equal(first, ops[3])
            res.append(f"{name} {label} {err:.2e}{'' if same else ' (BITS DIFFER)'}")
            if err > 1e-5 or not same:
                raise RuntimeError(f"{name} {label} disagrees at M={m} K={k} N={n}: {err:.3e}")
        print(f"check M={m} K={k} N={n} (error / max |float64|): " + "; ".join(res), flush=True)
    for k, n in TIMED:
        ops = operands(M, k, n)
        flops = 2 * M * n * k
        t = time_ms(lambda: torch.addmm(ops[2], ops[0], ops[1]))
        res = [f"torch.addmm f32 {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)"]
        for name, fn, v, label in variants:
            t = time_ms(lambda: run(fn, v, *ops))
            res.append(f"{name} {label} {t:.4f} ms ({flops / t / 1e9:.1f})")
        print(f"time [{smi}] M={M} K={k} N={n}: " + "; ".join(res), flush=True)
        del ops


if __name__ == "__main__":
    main()

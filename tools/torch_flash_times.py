"""Times the PyTorch port's flash kernels of one checkout of this repository
on a CUDA card, so that two checkouts can be compared in one run:

    python3 tools/torch_flash_times.py CHECKOUT LABEL [--dump FILE]
    python3 tools/torch_flash_times.py --compare FILE_A FILE_B

CHECKOUT is the root of a checkout (its ``pytorch_generative_tpu_torch`` is
imported, and its kernels built there); LABEL names it in the output. Prints
one line: the forward and backward ms (CUDA events, 20 calls after 3
warm-ups) at ImageGPT's (B 64, L 784) with (H 2, d 32) and (H 8, d 64); then
the registers and spills of the checkout's forward kernels (its nvcc
-Xptxas -v log). Run two checkouts in turns (A, B, B, A) in one process tree
on one card. ``--dump`` also saves the forward's out and lse for every
(d_k, d_v) the checkout builds, at (B 4, L 200, H 2), with and without
mask_center, from inputs made from one seed; ``--compare`` says, for the
widths two dumps share, whether they are equal bit for bit.
"""

import sys


def _pairs(ac):
    return getattr(ac, "HEAD_DIM_PAIRS", None) or [(d, d) for d in ac.HEAD_DIMS]


def _ptxas(ac):
    """'kernel: N registers, spills' of each entry function in the forward
    library's build log."""
    log = ac._build.library_path(ac.KERNEL).with_suffix(".log").read_text()
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


def main(checkout, label, dump=None):
    sys.path.insert(0, checkout)
    import torch

    from pytorch_generative_tpu_torch.ops import attention_cuda as ac

    dev = torch.device("cuda:0")

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
    for h, d in ((2, 32), (8, 64)):
        g = torch.Generator().manual_seed(0)
        c = h * d
        q = torch.randn((64, 784, c), generator=g).to(dev)
        kv = torch.randn((64, 784, 2 * c), generator=g).to(dev)
        do = torch.randn((64, 784, c), generator=g).to(dev)
        k, v = kv[..., :c], kv[..., c:]
        o, lse = ac.flash_forward(q, k, v, False, h)
        f = time_ms(lambda: ac.flash_forward(q, k, v, False, h))
        b = time_ms(lambda: ac.flash_backward(q, k, v, o, lse, do, False, h))
        out.append(f"d={d}: fwd {f:.4f} ms bwd {b:.4f} ms")
    print(f"flash times {label} ({ac.__file__}): " + "; ".join(out), flush=True)
    print(f"flash_fwd ptxas {label}: " + " | ".join(_ptxas(ac)), flush=True)
    if dump:
        results = {}
        for d_k, d_v in _pairs(ac):
            g = torch.Generator().manual_seed(d_k * 1000 + d_v)
            q = torch.randn((4, 200, 2 * d_k), generator=g).to(dev)
            kv = torch.randn((4, 200, 2 * (d_k + d_v)), generator=g).to(dev)
            k, v = kv[..., :2 * d_k], kv[..., 2 * d_k:]
            for mask_center in (False, True):
                o, lse = ac.flash_forward(q, k, v, mask_center, 2)
                results[f"{d_k}x{d_v} mask_center={mask_center}"] = (o.cpu(), lse.cpu())
        torch.save(results, dump)


def compare(file_a, file_b):
    import torch

    a, b = torch.load(file_a), torch.load(file_b)
    for key in sorted(set(a) & set(b)):
        same = all(torch.equal(x, y) for x, y in zip(a[key], b[key]))
        print(f"flash_fwd bits {key}: out and lse {'equal' if same else 'DIFFER'}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1], sys.argv[2], sys.argv[4] if len(sys.argv) > 4 else None)

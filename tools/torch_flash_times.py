"""Times the PyTorch port's flash kernels of one checkout of this repository
on a CUDA card, so that two checkouts can be compared in one run:

    python3 tools/torch_flash_times.py CHECKOUT LABEL

CHECKOUT is the root of a checkout (its ``pytorch_generative_tpu_torch`` is
imported, and its kernels built there); LABEL names it in the output. Prints
one line: the forward and backward ms (CUDA events, 20 calls after 3
warm-ups) at ImageGPT's (B 64, L 784) with (H 2, d 32) and (H 8, d 64). Run
two checkouts in turns (A, B, B, A) in one process tree on one card.
"""

import sys


def main(checkout, label):
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


if __name__ == "__main__":
    main(*sys.argv[1:3])

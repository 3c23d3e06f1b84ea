"""pytorch_generative_tpu_torch: the PyTorch and CUDA (H100) port of
``pytorch_generative_tpu``.

Module paths mirror the JAX package so each counterpart is found by name.
Public tensors keep the JAX package's layouts: images are NHWC, the
transformer middle is (N, L, C), attention is packed (B, L, H*d) and sampler
uniforms are (L, N, 1).

Every TPU kernel on a ported path has a hand-written Hopper kernel under
``csrc/``. A kernel is compiled with ``nvcc`` on its first CUDA call
(``ops/_build.py``), never at import. On a CPU tensor each kernel wrapper
takes its plain PyTorch version; on a CUDA tensor it launches the kernel or
raises.
"""

from pytorch_generative_tpu_torch import convert, models, nn, ops  # noqa: F401

__version__ = "0.1.0"

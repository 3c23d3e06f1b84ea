"""Model zoo of the port (ImageGPT so far)."""

from pytorch_generative_tpu_torch.models import base  # noqa: F401
from pytorch_generative_tpu_torch.models.autoregressive import image_gpt  # noqa: F401
from pytorch_generative_tpu_torch.models.autoregressive.image_gpt import (  # noqa: F401
    ImageGPT,
)

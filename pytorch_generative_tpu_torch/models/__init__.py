"""Model zoo of the port (ImageGPT and PixelSNAIL so far)."""

from pytorch_generative_tpu_torch.models import base  # noqa: F401
from pytorch_generative_tpu_torch.models.autoregressive import (  # noqa: F401
    image_gpt,
    pixel_snail,
)
from pytorch_generative_tpu_torch.models.autoregressive.image_gpt import (  # noqa: F401
    ImageGPT,
)
from pytorch_generative_tpu_torch.models.autoregressive.pixel_snail import (  # noqa: F401
    PixelSNAIL,
)

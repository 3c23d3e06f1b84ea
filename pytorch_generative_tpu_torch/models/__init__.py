"""Model zoo of the port (ImageGPT, PixelSNAIL and VQ-VAE so far)."""

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
from pytorch_generative_tpu_torch.models import vae  # noqa: F401
from pytorch_generative_tpu_torch.models.vae.vq_vae import (  # noqa: F401
    VectorQuantizedVAE,
)

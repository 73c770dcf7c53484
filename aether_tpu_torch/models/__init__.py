from aether_tpu_torch.models.dit import DiT, init_dit, init_quantized_dit, quantize_dit  # noqa: F401
from aether_tpu_torch.models.vae import VAE, init_vae  # noqa: F401

"""Model / scheduler / pipeline configuration.

The numeric values of the ``aetherv1`` presets mirror the upstream HF checkpoints the
reference loads (THUDM/CogVideoX-5b-I2V + AetherWorldModel/AetherV1); the knobs the
reference reads are listed in SURVEY.md section 2.2 and at
reference ``aether/pipelines/aetherv1_pipeline_cogvideox.py:307-345,535-541``.

Copy of ``aether_tpu/config.py``; the port's tests pin field-by-field equality.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """CogVideoX-style diffusion transformer configuration."""

    num_layers: int = 42
    num_heads: int = 48
    head_dim: int = 64
    in_channels: int = 96  # 56 noisy + 40 condition channels (AetherV1 widening)
    out_channels: int = 56  # 16 rgb + 16 disparity + 24 packed raymap latents
    patch_size: int = 2
    patch_size_t: Optional[int] = None  # None => CogVideoX-1.0 patchify (2D per frame)
    text_embed_dim: int = 4096
    max_text_seq_length: int = 226
    time_embed_dim: int = 512
    sample_height: int = 60  # latent-space base grid for RoPE crop region
    sample_width: int = 90
    sample_frames: int = 49
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    use_rotary_positional_embeddings: bool = True
    ofs_embed_dim: Optional[int] = None
    mlp_ratio: float = 4.0

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def aetherv1() -> "DiTConfig":
        return DiTConfig()

    @staticmethod
    def tiny() -> "DiTConfig":
        """2-block CPU-runnable config for tests (SURVEY.md section 7)."""
        return DiTConfig(
            num_layers=2,
            num_heads=4,
            head_dim=16,
            text_embed_dim=32,
            max_text_seq_length=8,
            time_embed_dim=32,
            sample_height=8,
            sample_width=12,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE (AutoencoderKLCogVideoX equivalent) configuration."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    invert_scale_latents: bool = False

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @property
    def temporal_compress_level(self) -> int:
        level = 0
        r = self.temporal_compression_ratio
        while r > 1:
            r //= 2
            level += 1
        return level

    @staticmethod
    def aetherv1() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(8, 8, 8, 16),
            layers_per_block=1,
            norm_num_groups=4,
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """CogVideoX DPM scheduler configuration (zero-terminal-SNR, v-prediction).

    Mirrors the upstream scheduler config consumed at reference
    ``aetherv1_pipeline_cogvideox.py:780-783,901-915``.
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    steps_offset: int = 0
    set_alpha_to_one: bool = True
    init_noise_sigma: float = 1.0

    @staticmethod
    def aetherv1() -> "SchedulerConfig":
        return SchedulerConfig()


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything the AetherV1 pipeline needs besides raw model params.

    Task defaults follow reference ``aetherv1_pipeline_cogvideox.py:256-272``.
    """

    dit: DiTConfig = dataclasses.field(default_factory=DiTConfig.aetherv1)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig.aetherv1)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig.aetherv1
    )
    base_fps: int = 12
    allowed_num_frames: Tuple[int, ...] = (17, 25, 33, 41)
    allowed_fps: Tuple[int, ...] = (8, 10, 12, 15, 24)
    default_num_inference_steps: Tuple[Tuple[str, int], ...] = (
        ("reconstruction", 4),
        ("prediction", 50),
        ("planning", 50),
    )
    default_guidance_scale: Tuple[Tuple[str, float], ...] = (
        ("reconstruction", 1.0),
        ("prediction", 3.0),
        ("planning", 3.0),
    )
    default_use_dynamic_cfg: Tuple[Tuple[str, bool], ...] = (
        ("reconstruction", False),
        ("prediction", True),
        ("planning", True),
    )

    @property
    def vae_scale_factor_spatial(self) -> int:
        return self.vae.spatial_compression_ratio

    @property
    def vae_scale_factor_temporal(self) -> int:
        return self.vae.temporal_compression_ratio

    @staticmethod
    def aetherv1() -> "PipelineConfig":
        return PipelineConfig()

    @staticmethod
    def tiny() -> "PipelineConfig":
        return PipelineConfig(dit=DiTConfig.tiny(), vae=VAEConfig.tiny())

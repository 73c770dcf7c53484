from aether_tpu_torch.pipeline.aether import (  # noqa: F401
    AetherPipeline,
    AetherPipelineOutput,
    DeferredOutput,
    TorchNoise,
    iter_resolved,
)

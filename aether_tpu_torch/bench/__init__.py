"""Benchmark entry points of the attention kernels.

Counterparts of the JAX package's attention benchmark scripts, each runnable
as a module:

    python -m aether_tpu_torch.bench.flash_variants    # K7, flash_v2 sweep
    python -m aether_tpu_torch.bench.flash_multihead   # K8, flash_mh sweep
    python -m aether_tpu_torch.bench.flash_bisect      # K9, flash_x modes and blocks

``--device`` defaults to cuda (the (1, 48, 15076, 64) bf16 shape); ``--device
cpu`` runs the plain PyTorch versions at a small shape.
"""

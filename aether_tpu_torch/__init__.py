"""aether_tpu_torch: the PyTorch + CUDA port of ``aether_tpu`` for NVIDIA Hopper.

The package mirrors ``aether_tpu``'s layout (``config``, ``models``, ``ops``,
``schedule``, ``pipeline``, ``io``, ``utils``). It imports ``torch`` and never
``jax``. The hand-written Hopper kernels live in ``csrc/`` and are built with
``nvcc`` on first use (``ops/_build.py``); importing any module builds nothing,
so the package imports on a machine without CUDA.
"""

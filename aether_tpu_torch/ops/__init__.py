"""Attention kernels: K1 (``attn_prologue``), K2 and K4 (``flash_attention``),
and the differentiable attention (``chunked_attention``). Their CUDA sources
build on first use, never at import."""

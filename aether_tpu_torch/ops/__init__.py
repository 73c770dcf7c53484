"""Attention kernels: K1 (``attn_prologue``) and K2 (``flash_attention``).
Their CUDA sources build on first use, never at import."""

"""Checkpoint conversion CLI: HF safetensors -> the port's checkpoint layout.

Port of ``aether_tpu/io/convert.py``. Converts the upstream transformer
(AetherV1) and VAE (CogVideoX-5b-I2V) shards once into the directory that
``apps/demo.py --checkpoint`` reads:

    <out>/dit.pt            DiT state dict (quantized: codes + scales)
    <out>/vae.pt            VAE state dict
    <out>/text_embeds.npy   (226, 4096) empty-prompt embedding (zeros here)

``--quantize fp8|int8`` quantizes the DiT's weights at conversion time
(``models.dit.quantize_dit``). The empty-prompt T5 embedding needs the T5
encoder weights and ``transformers``, which the port does not carry:
``--t5`` raises, and without it the embedding is zeros, as in the JAX CLI.

Usage:
    python -m aether_tpu_torch.io.convert \\
        --transformer /path/AetherV1/transformer \\
        --vae /path/CogVideoX-5b-I2V/vae \\
        --out converted [--quantize int8] [--config tiny] [--verify]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.io.weights import (
    convert_dit_state_dict,
    convert_vae_state_dict,
    dit_config_from_state_dict,
    load_hf_safetensors,
    load_state_dicts,
    save_checkpoint,
)
from aether_tpu_torch.models.dit import DiT, dit_from_state_dict, dit_skeleton, quantize_dit

QUANTIZE = {"none": None, "fp8": torch.float8_e4m3fn, "int8": torch.int8}


def _structure_check(dit_sd, cfg: PipelineConfig, quantize: str):
    """The reloaded DiT against the runtime template (``init_quantized_dit``
    / ``init_dit`` built on the meta device): the same names and shapes, and
    the codes in the requested dtype with f32 scales (float tensors may be
    bf16 or f32, as the source checkpoint has them)."""
    template = dit_skeleton(cfg.dit, QUANTIZE[quantize]).state_dict()
    if set(template) != set(dit_sd):
        missing = sorted(set(template) - set(dit_sd))[:5]
        extra = sorted(set(dit_sd) - set(template))[:5]
        return f"names differ: missing {missing}, unexpected {extra}"
    bad = [(k, tuple(t.shape), str(t.dtype), tuple(dit_sd[k].shape), str(dit_sd[k].dtype))
           for k, t in template.items()
           if t.shape != dit_sd[k].shape
           or (k.endswith((".q", ".s")) and t.dtype != dit_sd[k].dtype)]
    return True if not bad else f"tensor mismatches: {bad[:5]}"


def _fused_qkv_check(dit_sd, cfg: PipelineConfig, source_qkv):
    """Block 0's fused qkv against the source checkpoint's to_q, to_k and
    to_v weights: each row block equals its source exactly (no quantization),
    or dequantizes (codes x scales) to within half a quantization step of it
    (int8: s / 2; fp8 e4m3: 2**-4 of |W|, or 2**-10 s among the subnormals),
    with 1e-5 of slack for the f32 division. A concat out of order or scales
    out of step with their rows fail it."""
    pre = "blocks.0.attn.qkv"
    d = cfg.dit.hidden_size
    quantized = f"{pre}.q" in dit_sd
    if quantized:
        q, s = dit_sd[f"{pre}.q"], dit_sd[f"{pre}.s"]
        fused = q.float() * s[:, None]
    else:
        fused = dit_sd[f"{pre}.weight"]
    for j, (name, src) in enumerate(zip("qkv", source_qkv)):
        rows = fused[j * d:(j + 1) * d]
        if not quantized:
            ok = rows.dtype == src.dtype and torch.equal(rows, src)
        else:
            src = src.float()
            step = s[j * d:(j + 1) * d, None]
            if q.dtype == torch.int8:
                tol = step / 2
            else:
                tol = torch.maximum(src.abs() * 2.0 ** -4, step * 2.0 ** -10)
            ok = bool(((rows - src).abs() <= tol * (1 + 1e-5)).all())
        if not ok:
            return f"block 0's fused qkv rows of {name} do not reproduce attn1.to_{name}"
    return True


def verify_conversion(out_dir: str, cfg: PipelineConfig, quantize: str,
                      in_memory_dit=None, in_memory_vae=None, source_qkv=None) -> dict:
    """Replay the JAX converter's checks on a written checkpoint and return a
    manifest (``aether_tpu/io/convert.py:53-167``):

    1. dit.pt, vae.pt and text_embeds.npy load back (``weights_only``);
    2. the DiT matches the runtime template in names, shapes and payload
       dtypes;
    3. given the converted state dicts still in memory, the reload equals
       them bit for bit, dtypes included;
    4. given the source's block-0 to_q / to_k / to_v weights
       (``source_qkv``), the fused qkv reproduces them (``_fused_qkv_check``);
    5. the text embedding has shape (max_text_seq_length, text_embed_dim)
       and is finite.
    """
    checks: dict = {}
    dit, vae, text = load_state_dicts(out_dir)
    checks["reload"] = True
    checks["dit_structure"] = _structure_check(dit, cfg, quantize)

    def bit_equal(a, b):
        return set(a) == set(b) and all(
            a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)) for k in a)

    if in_memory_dit is not None:
        checks["dit_roundtrip_bitexact"] = bit_equal(in_memory_dit, dit)
    if in_memory_vae is not None:
        checks["vae_roundtrip_bitexact"] = bit_equal(in_memory_vae, vae)
    if source_qkv is not None:
        checks["fused_qkv"] = _fused_qkv_check(dit, cfg, source_qkv)
    ok_shape = text.shape == (cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim)
    ok_finite = bool(np.isfinite(text).all())
    checks["text_embeds"] = True if ok_shape and ok_finite else (
        f"shape_ok={ok_shape} finite={ok_finite}")
    return {
        "quantize": quantize,
        "checks": checks,
        "dit_tensors": len(dit),
        "dit_bytes": int(sum(t.numel() * t.element_size() for t in dit.values())),
        "vae_bytes": int(sum(t.numel() * t.element_size() for t in vae.values())),
        "ok": all(v is True for v in checks.values()),
    }


def convert(transformer: str, vae: str, out: str, quantize: str = "none",
            config: str = "aetherv1", verify: bool = False) -> Optional[dict]:
    """Convert, write ``out`` and, with ``verify``, return the manifest that
    is also written to ``<out>/manifest.json``. ``config`` names the
    topology; a CogVideoX-1.5 source's ``patch_size_t`` and ``ofs_embed_dim``
    are read from its tensors (``dit_config_from_state_dict``)."""
    cfg = getattr(PipelineConfig, config)()
    print("converting DiT ...", flush=True)
    hf = load_hf_safetensors(transformer)
    source_qkv = [hf[f"transformer_blocks.0.attn1.to_{n}.weight"] for n in "qkv"]
    dit_sd = convert_dit_state_dict(hf, cfg.dit)
    del hf
    cfg = dataclasses.replace(cfg, dit=dit_config_from_state_dict(dit_sd, cfg.dit))
    if QUANTIZE[quantize] is not None:
        model: DiT = dit_from_state_dict(dit_sd, cfg.dit)
        del dit_sd  # the model holds the only reference: each weight frees once quantized
        dit_sd = quantize_dit(model, QUANTIZE[quantize]).state_dict()
        del model
    print("converting VAE ...", flush=True)
    vae_sd = convert_vae_state_dict(load_hf_safetensors(vae), cfg.vae)
    text = np.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), np.float32)
    save_checkpoint(out, dit_sd, vae_sd, text)
    print(f"wrote {out}/{{dit.pt,vae.pt,text_embeds.npy}}", flush=True)
    if not verify:
        return None
    print("verifying ...", flush=True)
    manifest = verify_conversion(out, cfg, quantize, in_memory_dit=dit_sd,
                                 in_memory_vae=vae_sd, source_qkv=source_qkv)
    manifest["config"] = config
    manifest["patch_size_t"] = cfg.dit.patch_size_t
    manifest["ofs_embed_dim"] = cfg.dit.ofs_embed_dim
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"manifest: {json.dumps(manifest['checks'])}", flush=True)
    return manifest


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="convert HF checkpoints for aether_tpu_torch")
    p.add_argument("--transformer", required=True, help="Dir with the DiT *.safetensors shards.")
    p.add_argument("--vae", required=True, help="Dir with the VAE *.safetensors.")
    p.add_argument("--t5", default=None,
                   help="T5 encoder dir for the empty-prompt embedding (not supported: "
                        "omit it to write zero text embeddings).")
    p.add_argument("--out", required=True)
    p.add_argument("--quantize", choices=sorted(QUANTIZE), default="none",
                   help="Weight quantization of the DiT's linears.")
    p.add_argument("--config", choices=["aetherv1", "tiny"], default="aetherv1",
                   help="Model topology of the source checkpoint.")
    p.add_argument("--verify", action="store_true",
                   help="Reload the written checkpoint, replay the converter checks and "
                        "write <out>/manifest.json.")
    args = p.parse_args(argv)
    if args.t5:
        raise NotImplementedError(
            "--t5 computes the empty-prompt embedding with the T5 encoder, which needs "
            "the T5 weights (CogVideoX-5b-I2V text_encoder + tokenizer) and the "
            "`transformers` package; the port has neither. Omit --t5 to write zero "
            "embeddings.")
    manifest = convert(args.transformer, args.vae, args.out, args.quantize, args.config,
                       args.verify)
    if manifest is not None and not manifest["ok"]:
        raise SystemExit("verification FAILED: see manifest.json")


if __name__ == "__main__":
    main()

"""Checkpoint IO of the PyTorch port against the JAX package (CPU, tiny config).

Synthetic HF-layout shards (``scripts/make_synthetic_checkpoint.py``, the
upstream names, the transformer in two shards) go through the port's
safetensors reader and name maps, which must equal the JAX converter's trees
carried across by ``io.from_jax`` exactly; the reader is held against the
``safetensors`` package; ``python -m aether_tpu_torch.io.convert`` writes a
checkpoint whose manifest passes, and the demo runs a reconstruction from
it and from the quantized random inits.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.config import VAEConfig as JaxVAEConfig
from aether_tpu.io import weights as jax_weights
from aether_tpu_torch.apps import demo
from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.io import convert
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax, vae_state_dict_from_jax
from aether_tpu_torch.io.safetensors import load_hf_safetensors, read_safetensors
from aether_tpu_torch.io.weights import (
    convert_dit_state_dict,
    convert_vae_state_dict,
    load_checkpoint,
)
from aether_tpu_torch.models.dit import QuantLinear, dit_from_state_dict, quantize_dit
from test_torch_demo import _gif

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    sys.path.insert(0, str(_ROOT / "scripts"))
    try:
        from make_synthetic_checkpoint import write_synthetic_checkpoint
    finally:
        sys.path.pop(0)
    return write_synthetic_checkpoint(tmp_path_factory.mktemp("hf"), config="tiny", shards=2)


def _assert_same(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


def test_dit_names_match_jax_converter(synthetic):
    tdir, _ = synthetic
    assert len(list(pathlib.Path(tdir).glob("*.safetensors"))) == 2
    got = convert_dit_state_dict(load_hf_safetensors(tdir), PipelineConfig.tiny().dit)
    want = dit_state_dict_from_jax(jax_weights.convert_dit_state_dict(
        jax_weights.load_hf_safetensors(tdir), JaxDiTConfig.tiny()), PipelineConfig.tiny().dit)
    _assert_same(got, want)


def test_vae_names_match_jax_converter(synthetic):
    _, vdir = synthetic
    got = convert_vae_state_dict(load_hf_safetensors(vdir), PipelineConfig.tiny().vae)
    want = vae_state_dict_from_jax(jax_weights.convert_vae_state_dict(
        jax_weights.load_hf_safetensors(vdir), JaxVAEConfig.tiny()))
    _assert_same(got, want)


def test_bf16_stays_bf16(synthetic):
    """A bf16 checkpoint converts without a detour through f32."""
    tdir, _ = synthetic
    sd = {k: v.to(torch.bfloat16) for k, v in load_hf_safetensors(tdir).items()}
    got = convert_dit_state_dict(sd, PipelineConfig.tiny().dit)
    assert {t.dtype for t in got.values()} == {torch.bfloat16}
    assert torch.equal(got["blocks.1.attn.qkv.weight"][:64],
                       sd["transformer_blocks.1.attn1.to_q.weight"])


def test_reader_matches_safetensors_package(tmp_path, synthetic):
    """Every dtype the reader takes, odd shapes, a scalar, an empty tensor and
    metadata, against ``safetensors.torch.load_file``; the two shards merge
    as the package reads them."""
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
        "f16": torch.randn(7, generator=gen).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=gen),
        "i8": torch.randint(-128, 128, (9, 2), generator=gen, dtype=torch.int8),
        "u8": torch.randint(0, 256, (4,), generator=gen, dtype=torch.uint8),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 3),
    }
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    _assert_same(read_safetensors(str(path)), load_file(str(path)))
    tdir, _ = synthetic
    merged = {}
    for shard in sorted(pathlib.Path(tdir).glob("*.safetensors")):
        merged.update(load_file(str(shard)))
    _assert_same(load_hf_safetensors(tdir), merged)


def test_reader_refuses_other_dtypes_and_empty_dirs(tmp_path):
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "d.safetensors"))
    with pytest.raises(TypeError, match="F64"):
        read_safetensors(str(tmp_path / "d.safetensors"))
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError):
        load_hf_safetensors(str(tmp_path / "none"))


@pytest.mark.parametrize("quantize", ["none", "fp8", "int8"])
def test_convert_cli_writes_a_passing_manifest(tmp_path, synthetic, quantize):
    """``python -m aether_tpu_torch.io.convert ... --verify``; the written DiT
    equals the converted one quantized by ``quantize_dit``."""
    tdir, vdir = synthetic
    out = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "aether_tpu_torch.io.convert", "--transformer", tdir,
         "--vae", vdir, "--out", str(out), "--config", "tiny", "--quantize", quantize,
         "--verify"], cwd=_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["ok"] and manifest["quantize"] == quantize, manifest
    assert set(manifest["checks"]) == {"reload", "dit_structure", "dit_roundtrip_bitexact",
                                       "vae_roundtrip_bitexact", "fused_qkv", "text_embeds"}
    cfg = PipelineConfig.tiny()
    dit, vae, text = load_checkpoint(str(out), cfg)
    want = dit_from_state_dict(convert_dit_state_dict(load_hf_safetensors(tdir), cfg.dit), cfg.dit)
    if quantize != "none":
        quantize_dit(want, convert.QUANTIZE[quantize])
        assert sum(isinstance(m, QuantLinear) for m in dit.modules()) == 6 + 6 * cfg.dit.num_layers
    got_sd, want_sd = dit.state_dict(), want.state_dict()
    assert set(got_sd) == set(want_sd)
    for name, w in want_sd.items():
        assert got_sd[name].dtype == w.dtype, name
        assert torch.equal(got_sd[name].view(torch.uint8), w.view(torch.uint8)), name
    assert text.shape == (cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim)
    assert not np.any(text)


@pytest.mark.parametrize("quantize", ["none", "fp8", "int8"])
def test_verify_catches_a_fused_qkv_out_of_step(tmp_path, synthetic, quantize):
    """The written checkpoint passes the fused-qkv check against the source's
    to_q/to_k/to_v; with the fused rows' scales (or, unquantized, its rows)
    rolled by one it fails it and the manifest."""
    tdir, vdir = synthetic
    out = tmp_path / "ckpt"
    convert.convert(tdir, vdir, str(out), quantize, "tiny")
    hf = load_hf_safetensors(tdir)
    source = [hf[f"transformer_blocks.0.attn1.to_{n}.weight"] for n in "qkv"]
    cfg = PipelineConfig.tiny()
    assert convert.verify_conversion(str(out), cfg, quantize, source_qkv=source)["ok"]
    sd = torch.load(out / "dit.pt", weights_only=True)
    name = "blocks.0.attn.qkv." + ("weight" if quantize == "none" else "s")
    sd[name] = sd[name].roll(1, dims=0)
    torch.save(sd, out / "dit.pt")
    manifest = convert.verify_conversion(str(out), cfg, quantize, source_qkv=source)
    assert not manifest["ok"] and "do not reproduce" in manifest["checks"]["fused_qkv"]


def test_t5_raises(tmp_path, synthetic):
    tdir, vdir = synthetic
    with pytest.raises(NotImplementedError, match="transformers"):
        convert.main(["--transformer", tdir, "--vae", vdir, "--out", str(tmp_path / "o"),
                      "--config", "tiny", "--t5", "/t5"])
    assert not (tmp_path / "o").exists()


TINY_RECON = ["--task", "reconstruction", "--device", "cpu", "--height", "64", "--width",
              "96", "--num_frames", "17", "--num_inference_steps", "1",
              "--pointcloud_save_frame_interval", "8"]


@pytest.mark.parametrize("quantize", ["int8", "fp8"])
def test_demo_runs_a_converted_checkpoint(tmp_path, synthetic, quantize):
    """``apps.demo --checkpoint`` on a converted quantized checkpoint: a tiny
    reconstruction with its outputs, int8 codes with int8 activations."""
    tdir, vdir = synthetic
    ckpt = tmp_path / "ckpt"
    convert.convert(tdir, vdir, str(ckpt), quantize, "tiny")
    video = _gif(tmp_path / "clip.gif", 17)
    argv = TINY_RECON + ["--video", video, "--checkpoint", str(ckpt), "--config", "tiny",
                         "--output_dir", str(tmp_path / "out")]
    pipe, cfg = demo.build_pipeline(demo.parse_args(argv))
    assert pipe.act_quant == (quantize == "int8")
    assert {m.q.dtype for m in pipe.dit.modules() if isinstance(m, QuantLinear)} == {
        convert.QUANTIZE[quantize]}
    written = demo.run(demo.parse_args(argv))
    poses = np.loadtxt(written["poses"])
    assert poses.shape == (17, 16) and np.isfinite(poses).all()


@pytest.mark.parametrize("init,act_quant", [("tiny-int8", True), ("tiny-fp8", False)])
def test_demo_quantized_random_init(tmp_path, init, act_quant):
    video = _gif(tmp_path / "clip.gif", 17)
    argv = TINY_RECON + ["--video", video, "--random-init", init,
                         "--output_dir", str(tmp_path / "out")]
    pipe, _ = demo.build_pipeline(demo.parse_args(argv))
    assert pipe.act_quant is act_quant
    written = demo.run(demo.parse_args(argv))
    assert np.isfinite(np.loadtxt(written["poses"])).all()


def test_trainer_starts_from_a_converted_checkpoint(tmp_path, synthetic, capsys):
    """``train.trainer --init_checkpoint`` fine-tunes the converted weights
    (f32 copies of them); a quantized checkpoint is refused."""
    from aether_tpu_torch.io.weights import load_state_dicts
    from aether_tpu_torch.train.trainer import TrainConfig, Trainer, main

    tdir, vdir = synthetic
    for quantize in ("none", "int8"):
        convert.convert(tdir, vdir, str(tmp_path / quantize), quantize, "tiny")
    sd = load_state_dicts(str(tmp_path / "none"))[0]
    trainer = Trainer(PipelineConfig.tiny().dit, TrainConfig(), device="cpu", init_params=sd)
    for name, p in trainer.state.model.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p.detach(), sd[name].float()), name
    main(["--synthetic", "--tiny", "--device", "cpu", "--steps", "1",
          "--init_checkpoint", str(tmp_path / "none")])
    assert "step 1: loss=" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unquantized"):
        main(["--synthetic", "--tiny", "--device", "cpu", "--steps", "1",
              "--init_checkpoint", str(tmp_path / "int8")])

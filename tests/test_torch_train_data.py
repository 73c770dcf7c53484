"""The port's training data path against the JAX one (CPU, tiny config, f32).

``precompute_latents`` of both packages runs on the same weights (the tiny
pipelines of ``test_torch_batch_reconstruct.py``) over four clips, with the
JAX posterior draws (``fold_in(fold_in(PRNGKey(seed), i), m)``) handed to the
port through its noise source. Every ``clean_latents`` element must lie
within one float16 ulp of the JAX file's (``np.spacing`` of the JAX value in
float16: two f32 implementations of the same convolutions may round to
neighbouring f16 values), every other key must be equal. Below 2**-10 the
f16 grid is finer than the two f32 encodes agree (a few f32 ulps at the
latents' scale of 4-8, about 1e-6), so there the ulp counts as the one at
2**-10, 2**-20. The loader's native
route must give the batches of its ``np.load`` route and of the JAX loader bit
for bit, and the trainer's CLI must train, save and resume at its defaults
(native prefetch) on the port's own files.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.train.data import latent_batches as jax_latent_batches
from aether_tpu.train.data import precompute_latents as jax_precompute_latents
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.train.data import DISPARITY, RGB, LatentNoise, latent_batches
from aether_tpu_torch.train.data import precompute_latents
from aether_tpu_torch.train.trainer import main
from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines

torch.set_num_threads(1)

SEED, F, H, W = 3, 5, 32, 48
KEYS = ("clean_latents", "num_frames", "height", "width", "fps", "text_embeds")


class JaxLatentNoise:
    """The JAX function's posterior draws, for the port's noise source."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def posterior(self, clip, modality, shape):
        key = jax.random.fold_in(jax.random.fold_in(self.key, clip), modality)
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))


def make_clips(f=F, h=H, w=W, text_dims=(8, 16)):
    """Four clips: RGB + disparity + poses; RGB only; poses without
    disparity; RGB with text embeds."""
    rng = np.random.default_rng(11)
    poses = np.broadcast_to(np.eye(4), (f, 4, 4)).copy()
    poses[:, 0, 3] = np.arange(f) * 0.1
    poses[:, 2, 3] = -np.arange(f) * 0.05
    intr = np.broadcast_to(np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float64),
                           (f, 3, 3)).copy()
    rgb = [rng.uniform(0, 1, (f, h, w, 3)) for _ in range(4)]
    return [
        {"name": "full", "rgb": rgb[0], "disparity": rng.uniform(0, 1, (f, h, w)),
         "poses": poses, "intrinsics": intr},
        {"name": "rgb_only", "rgb": rgb[1]},
        {"name": "poses_only", "rgb": rgb[2], "poses": poses, "intrinsics": intr},
        {"name": "text", "rgb": rgb[3],
         "text_embeds": rng.standard_normal(text_dims).astype(np.float32)},
    ]


def assert_files_match(ours: str, ref: str) -> float:
    """The port's file against the JAX one: clean_latents within one f16 ulp
    of the JAX value (no less than 2**-20, the ulp at 2**-10; module
    docstring), every other key equal. Returns the largest difference in
    ulps."""
    with np.load(ours) as za, np.load(ref) as zb:
        a = {key: za[key] for key in za.files}
        b = {key: zb[key] for key in zb.files}
    assert sorted(a) == sorted(b) == sorted(KEYS)
    for key in KEYS:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        if key != "clean_latents":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    got, want = a["clean_latents"], b["clean_latents"]
    assert np.isfinite(want).all()
    ulp = np.maximum(np.spacing(np.abs(want)), np.spacing(np.float16(2**-10)))
    ulp = ulp.astype(np.float32)
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (diff <= ulp).all(), (
        f"{int((diff > ulp).sum())} elements beyond one f16 ulp; worst "
        f"{float((diff / ulp).max()):.1f} ulps")
    return float((diff / ulp).max())


@pytest.fixture(scope="module")
def latent_dirs(tmp_path_factory):
    """The four clips through both packages: (port dir, JAX dir, clips)."""
    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    jax_pipe = jax_pipeline(jcfg, dit_tree, vae_tree, text)
    clips = make_clips()
    root = tmp_path_factory.mktemp("latents")
    ours, ref = str(root / "port"), str(root / "jax")
    written = precompute_latents(port, clips, ours, seed=SEED, noise=JaxLatentNoise(SEED))
    assert written == [os.path.join(ours, f"{c['name']}.npz") for c in clips]
    jax_precompute_latents(jax_pipe, clips, ref, seed=SEED)
    return ours, ref, clips, port


@pytest.mark.parametrize("name", ["full", "rgb_only", "poses_only", "text"])
def test_precompute_latents_matches_jax(latent_dirs, name):
    ours, ref, clips, _ = latent_dirs
    assert_files_match(os.path.join(ours, f"{name}.npz"), os.path.join(ref, f"{name}.npz"))
    clean = np.load(os.path.join(ours, f"{name}.npz"))["clean_latents"]
    assert clean.shape == ((F - 1) // 4 + 1, 56, H // 8, W // 8)
    clip = next(c for c in clips if c["name"] == name)
    # absent modalities are exact zeros: disparity channels 16-31, camera 32-55
    assert (clean[:, 16:32] == 0).all() == (clip.get("disparity") is None)
    assert (clean[:, 32:] == 0).all() == (clip.get("poses") is None)


def test_default_noise_is_seeded_by_clip_and_modality(latent_dirs, tmp_path):
    """The default draws depend on (seed, clip index, modality) only: the same
    seed gives the same file, another seed or clip index other draws."""
    _, _, clips, port = latent_dirs
    noise = LatentNoise(SEED, "cpu")
    shape = (1, 2, 4, 6, 16)
    assert torch.equal(noise.posterior(0, RGB, shape), noise.posterior(0, RGB, shape))
    for other in (noise.posterior(1, RGB, shape), noise.posterior(0, DISPARITY, shape),
                  LatentNoise(SEED + 1, "cpu").posterior(0, RGB, shape)):
        assert not torch.equal(noise.posterior(0, RGB, shape), other)
    a = precompute_latents(port, clips[:1], str(tmp_path / "a"), seed=SEED)[0]
    b = precompute_latents(port, clips[:1], str(tmp_path / "b"), seed=SEED)[0]
    c = precompute_latents(port, clips[:1], str(tmp_path / "c"), seed=SEED + 1)[0]
    np.testing.assert_array_equal(np.load(a)["clean_latents"], np.load(b)["clean_latents"])
    assert not np.array_equal(np.load(a)["clean_latents"][:, :32],
                              np.load(c)["clean_latents"][:, :32])
    # the camera channels take no draw
    np.testing.assert_array_equal(np.load(a)["clean_latents"][:, 32:],
                                  np.load(c)["clean_latents"][:, 32:])


@pytest.mark.parametrize("prefetch_batches", [1, 3])
def test_native_batches_equal_np_load_and_jax(latent_dirs, prefetch_batches):
    """Four batches of two over the port's four files (two epochs): the native
    route, the np.load route and the JAX loader's np.load route, bit for bit."""
    ours, _, _, _ = latent_dirs
    text = np.random.default_rng(5).standard_normal(
        (DiTConfig.tiny().max_text_seq_length, DiTConfig.tiny().text_embed_dim)
    ).astype(np.float32)
    for kw in ({}, {"seed": 9, "text_embeds": text}):
        native = latent_batches(ours, DiTConfig.tiny(), batch_size=2,
                                prefetch_batches=prefetch_batches, **kw)
        plain = latent_batches(ours, DiTConfig.tiny(), batch_size=2,
                               native_prefetch=False, **kw)
        ref = jax_latent_batches(ours, JaxDiTConfig.tiny(), batch_size=2,
                                 native_prefetch=False, process_index=0,
                                 process_count=1, **kw)
        for _ in range(4):
            a, b, c = next(native), next(plain), next(ref)
            assert set(a) == set(b) == set(c)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
                np.testing.assert_array_equal(a[key], np.asarray(c[key]), err_msg=key)
        native.close()  # joins the prefetch threads


def test_cli_trains_on_precomputed_latents_at_defaults(latent_dirs, tmp_path, capsys):
    """Port of ``tests/test_train.py::test_train_cli_on_real_latents``: the
    CLI with ``--latent_dir`` and no ``--no_native_prefetch`` trains on the
    port's own files, checkpoints, and a second invocation resumes."""
    ours, _, _, _ = latent_dirs
    ckpt = str(tmp_path / "ckpt")
    argv = ["--tiny", "--device", "cpu", "--latent_dir", ours, "--steps", "3",
            "--batch_size", "2", "--lr", "1e-3",
            "--checkpoint_dir", ckpt, "--checkpoint_every", "100"]
    main(argv)
    out = capsys.readouterr().out
    assert "loss=" in out
    saves = sorted(p for p in os.listdir(ckpt) if p.startswith("step_"))
    assert saves == ["step_00000003"]

    main(argv + ["--steps", "2"])  # later --steps wins in argparse
    saves = sorted(p for p in os.listdir(ckpt) if p.startswith("step_"))
    assert saves[-1] == "step_00000005"

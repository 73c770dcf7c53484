"""The port's pipeline over a mesh of gloo ranks on the CPU, against the JAX
pipeline on the same mesh of the conftest's 8-device CPU mesh.

Weights are the tiny anchor trees of ``tests/test_torch_pipeline.py``; the
JAX pipeline's draws (its key streams, ``JaxKeyNoise``) are recorded once
and replayed on every rank, so all runs see the same noise. Cases:

- a 2-step prediction (its CFG pair) at dp x tp = 2 x 2 (4 ranks; at tp x
  sp = 2 x 2 in ``test_torch_parallel_sp_pipeline.py``), and a
  ``batch_reconstruct`` of three windows at dp = 2 (2 ranks; the short batch
  is padded to four and the extra outputs dropped);
- every output against the port's own unsharded run at 2e-4 (the JAX tests'
  sharded-vs-unsharded bar, ``tests/test_sharded_inference.py:46-48``), and
  against the JAX pipeline on the same mesh: RGB and raymap at 2e-4, the
  disparity at 5e-3, the bar the port's unsharded pipeline is held to
  against JAX (the disparity squares the decoded value; unsharded the two
  already differ by up to 5e-4 there);
- the CFG pair's rows really split over dp (JAX
  ``test_cfg_pair_physically_shards_over_dp``): every K1 + K2 call of a
  dp = 2 rank sees batch 1 and its tp half of the heads.
"""

import numpy as np
import pytest
import torch

from aether_tpu_torch.parallel.launch import spawn
from test_torch_parallel_dit import ENV, HERE

torch.set_num_threads(1)

F, H, W, STEPS, SEED = 17, 64, 96, 2, 7
FIELDS = ("rgb", "disparity", "raymap")
JAX_ATOL = {"rgb": 2e-4, "disparity": 5e-3, "raymap": 2e-4}


class Replay:
    """A noise source that hands out recorded draws in order (the pipeline
    asks for them in a fixed order), checking each shape."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, shape):
        draw = self.draws.pop(0)
        assert tuple(draw.shape) == tuple(shape), (tuple(draw.shape), tuple(shape))
        return draw

    def posterior(self, shape):
        return self._next(shape)

    goal = initial = posterior

    def sde(self, step, shape):
        return self._next(shape)


def _request():
    rng = np.random.default_rng(0)
    image = (rng.uniform(0, 1, (H, W, 3)) * 255).astype(np.uint8)
    raymap = rng.normal(size=(F, 6, H // 8, W // 8)).astype(np.float32)
    return dict(task="prediction", image=image, raymap=raymap, height=H, width=W,
                num_frames=F, num_inference_steps=STEPS, fps=12)


def _windows():
    video = np.random.default_rng(5).integers(0, 256, (33, H, W, 3), dtype=np.uint8)
    return np.stack([video[s:s + F] for s in (0, 8, 16)])


def _fields(out):
    return {name: getattr(out, name) for name in FIELDS}


def rank_pipelines(states, text, cases):
    """Every case on this rank: {name: outputs (and the K1 + K2 calls'
    (batch, heads) where recorded)}."""
    import aether_tpu_torch.models.dit as dit_module
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models.dit import DiT
    from aether_tpu_torch.models.vae import VAE
    from aether_tpu_torch.parallel import initialize, make_mesh
    from aether_tpu_torch.pipeline import AetherPipeline

    torch.set_num_threads(1)
    initialize(device="cpu")
    cfg = PipelineConfig.tiny()
    calls = []
    real = dit_module.fused_joint_attention

    def recording(xq, *a, num_heads, **kw):
        calls.append((xq.shape[0], num_heads))
        return real(xq, *a, num_heads=num_heads, **kw)

    dit_module.fused_joint_attention = recording
    results = {}
    for case in cases:
        dit, vae = DiT(cfg.dit), VAE(cfg.vae)
        dit.load_state_dict(states["dit"])
        vae.load_state_dict(states["vae"])
        pipe = AetherPipeline(cfg, dit, vae, text, device="cpu", compute_dtype=torch.float32,
                              mesh=make_mesh(**case["mesh"]))
        calls.clear()
        noise = Replay(case["draws"])
        if case["kind"] == "prediction":
            out = [_fields(pipe(noise=noise, **_request()))]
        else:
            out = [_fields(o) for o in pipe.batch_reconstruct(
                _windows(), height=H, width=W, num_frames=F, num_inference_steps=1, fps=12,
                noise=noise)]
        assert not noise.draws, "draws left over"
        results[case["name"]] = dict(outputs=out, calls=list(calls))
    return results


class _Recorder:
    """``JaxKeyNoise`` that keeps its draws."""

    def __init__(self, seed):
        from test_torch_pipeline import JaxKeyNoise

        self.inner, self.draws = JaxKeyNoise(seed), []

    def __getattr__(self, name):
        method = getattr(self.inner, name)

        def draw(*args):
            t = method(*args)
            self.draws.append(t)
            return t

        return draw


# name -> (mesh axes, request); the sp case is in test_torch_parallel_sp_pipeline.py
CASES = {"prediction_dp2_tp2": (dict(dp=2, tp=2), "prediction"),
         "batch_reconstruct_dp2": (dict(dp=2, tp=1), "batch")}


def run_cases(cases):
    """The unsharded port runs (recording the JAX draws) and every case's
    ranks: (JAX trees, unsharded outputs by request, rank results by case)."""
    from test_torch_batch_reconstruct import tiny_pipelines

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    unsharded, draws = {}, {}
    for kind in {kind for _, kind in cases.values()}:
        rec = _Recorder(SEED)
        if kind == "prediction":
            unsharded[kind] = [_fields(port(noise=rec, **_request()))]
        else:
            unsharded[kind] = [_fields(o) for o in port.batch_reconstruct(
                _windows(), height=H, width=W, num_frames=F, num_inference_steps=1, fps=12,
                noise=rec)]
        draws[kind] = rec.draws
    states = {"dit": port.dit.state_dict(), "vae": port.vae.state_dict()}
    by_world = {}
    for name, (axes, kind) in cases.items():
        world = int(np.prod(list(axes.values())))
        by_world.setdefault(world, []).append(
            dict(name=name, mesh=axes, kind=kind, draws=draws[kind]))
    ranks = {}
    for world, cases in by_world.items():
        for rank, res in enumerate(spawn(
                f"{__name__}:rank_pipelines", world,
                dict(states=states, text=text, cases=cases), extra_path=[HERE], env=ENV)):
            for name, got in res.items():
                ranks.setdefault(name, []).append(got)
    return (jcfg, dit_tree, vae_tree, text), unsharded, ranks


@pytest.fixture(scope="module")
def setup():
    return run_cases(CASES)


def _jax_outputs(trees, axes, kind):
    import jax
    import jax.numpy as jnp

    from aether_tpu.parallel.mesh import make_mesh
    from aether_tpu.pipeline import AetherPipeline as JaxPipeline

    jcfg, dit_tree, vae_tree, text = trees
    mesh = make_mesh(**axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    pipe = JaxPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, dit_tree),
                       jax.tree_util.tree_map(jnp.asarray, vae_tree), text,
                       attn_impl="flash_interpret", compute_dtype=jnp.float32, mesh=mesh)
    if kind == "prediction":
        return [_fields(pipe(seed=SEED, **_request()))]
    return [_fields(o) for o in pipe.batch_reconstruct(
        _windows(), height=H, width=W, num_frames=F, num_inference_steps=1, fps=12,
        seed=SEED)]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_pipeline_matches_unsharded_and_jax(setup, name):
    check_case(setup, CASES, name)


def check_case(setup, cases, name):
    """One case's outputs: the same on every rank, against the unsharded
    port run and against the JAX pipeline on the same mesh."""
    trees, unsharded, ranks = setup
    axes, kind = cases[name]
    got = ranks[name][0]["outputs"]
    for other in ranks[name][1:]:  # every rank ends with the whole outputs
        for a, b in zip(other["outputs"], got):
            for field in FIELDS:
                np.testing.assert_array_equal(a[field], b[field])
    ref_jax = _jax_outputs(trees, axes, kind)
    assert len(got) == len(unsharded[kind]) == len(ref_jax) == (1 if kind == "prediction" else 3)
    for i, (out, ref, jref) in enumerate(zip(got, unsharded[kind], ref_jax)):
        for field in FIELDS:
            np.testing.assert_allclose(out[field], ref[field], atol=2e-4,
                                       err_msg=f"{name} window {i} {field} vs unsharded")
            np.testing.assert_allclose(out[field], jref[field], atol=JAX_ATOL[field],
                                       err_msg=f"{name} window {i} {field} vs JAX")


def test_cfg_pair_rows_split_over_dp(setup):
    _, _, ranks = setup
    for rank, got in enumerate(ranks["prediction_dp2_tp2"]):
        calls = got["calls"]
        # 2 layers x 2 steps of K1 + K2, each at batch 1 of the pair, 4 / tp heads
        assert calls == [(1, 2)] * 4, (rank, calls)

"""The port's trainer against the JAX trainer and optax (CPU, tiny config).

The JAX ``Trainer`` runs without a mesh, with ``attn_impl="xla"`` and remat;
the port's ``Trainer`` starts from the same converted parameters, eats the
same ``synthetic_batches`` and draws (t, eps) from the JAX trainer's key
stream through its noise source. Tolerances, all f32: losses 1e-5 relative;
parameters 1e-4 absolute, a tenth of one AdamW step of size lr = 1e-3. The
step is lr * m / (sqrt(v) + 1e-8): it is ~lr * sign(g) wherever |g| >> 1e-8,
but turns the ~1e-9 absolute noise of a gradient element near 1e-8 into a
visible part of a step (up to 6% seen), while a wrong schedule, clip, decay
or bias correction moves whole tensors by a large part of a step. The EMA,
which takes 1/1000 of each parameter, 1e-5. The LR schedule and clipping
1e-6 relative (float32 arithmetic in another library). Resume is checked bit
for bit against an uninterrupted run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.train.data import latent_batches as jax_latent_batches
from aether_tpu.train.trainer import (
    TrainConfig as JaxTrainConfig,
    Trainer as JaxTrainer,
    synthetic_batches as jax_synthetic_batches,
)
from aether_tpu_torch.config import DiTConfig, SchedulerConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.train.data import latent_batches
from aether_tpu_torch.train.step import diffusion_loss, noise_schedule
from aether_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    batch_to_device,
    clip_by_global_norm_,
    lr_schedule,
    main,
    synthetic_batches,
)

torch.set_num_threads(1)

PARAM_ATOL = 1e-4  # a tenth of one AdamW step at lr 1e-3 (module docstring)


class JaxKeyStream:
    """(t, eps) exactly as the JAX Trainer draws them: one split of the
    trainer key per call, then the step key split for t and eps."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, shape):
        self.key, step_key = jax.random.split(self.key)
        key_t, key_eps = jax.random.split(step_key)
        t = jax.random.randint(key_t, (shape[0],), 0, 1000)
        eps = jax.random.normal(key_eps, shape, jnp.float32)
        return (torch.from_numpy(np.asarray(t).astype(np.int64)),
                torch.from_numpy(np.array(eps)))


def _jax_sd(tree):
    return dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   DiTConfig.tiny())


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_lr_schedule_equals_optax(warmup):
    cfg = TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=9)
    ours = lr_schedule(cfg)
    # the schedule the JAX make_optimizer builds from the same config
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=max(9, warmup + 1), end_value=3e-5)
    for count in range(14):
        want = float(sched(jnp.asarray(count, jnp.int32)))
        assert ours(count) == pytest.approx(want, rel=1e-6, abs=0), count
    if warmup:
        assert ours(0) == 0.0  # the first update moves nothing


@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [(scale * rng.standard_normal(s)).astype(np.float32)
             for s in ((5, 7), (11,), (3, 2, 4))]
    tx = optax.clip_by_global_norm(1.0)
    jgrads = [jnp.asarray(g) for g in grads]
    want, _ = tx.update(jgrads, tx.init(None))
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(ours, 1.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(jgrads)), rel=1e-6)
    for o, w in zip(ours, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if scale < 1:  # under the limit: untouched
        for o, g in zip(ours, grads):
            assert np.array_equal(o.numpy(), g)


@pytest.mark.parametrize("accum,warmup", [(1, 1), (2, 0)])
def test_three_fit_steps_match_jax_trainer(accum, warmup):
    """warmup 1: the first update has lr 0 and the next two move; with
    accumulation over 2 calls and warmup 0 the one update at call 2 moves."""
    cfg = JaxDiTConfig.tiny()
    kw = dict(learning_rate=1e-3, warmup_steps=warmup, total_steps=6,
              grad_clip_norm=1.0, grad_accum_steps=accum, remat=True,
              attn_impl="xla", log_every=1)
    jt = JaxTrainer(cfg, JaxTrainConfig(**kw), seed=0)
    init = _jax_sd(jt.state.params)
    tt = Trainer(DiTConfig.tiny(), TrainConfig(**kw), device="cpu",
                 init_params=init, noise=JaxKeyStream(0))
    j_losses = jt.fit(jax_synthetic_batches(cfg, batch_size=1, seed=3), steps=3)
    t_losses = tt.fit(synthetic_batches(DiTConfig.tiny(), batch_size=1, seed=3),
                      steps=3)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert tt.state.step == 3 and tt.state.optimizer.count == 3 // accum
    params = tt.state.model.state_dict()
    moved = max(float((params[n] - init[n]).abs().max()) for n in init)
    assert moved > 1e-4  # the check below is not vacuous
    for name, ref in _jax_sd(jt.state.params).items():
        np.testing.assert_allclose(params[name].numpy(), ref.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    for name, ref in _jax_sd(jt.state.ema_params).items():
        np.testing.assert_allclose(tt.state.ema_params[name].numpy(), ref.numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"ema {name}")


def _tcfg(ckpt, accum):
    return TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6,
                       grad_clip_norm=1.0, grad_accum_steps=accum, log_every=100,
                       checkpoint_dir=ckpt, checkpoint_every=100)


@pytest.mark.parametrize("accum,first", [(1, 2), (2, 1)])
def test_resume_is_exact_continuation(tmp_path, accum, first):
    """``first`` steps, save, a NEW trainer restores, the rest: equal to an
    uninterrupted run bit for bit (accumulation 2 saves mid-accumulation)."""
    cfg = DiTConfig.tiny()
    full = Trainer(cfg, _tcfg(None, accum), device="cpu", seed=0)
    full.fit(synthetic_batches(cfg, seed=3), steps=3)

    ckpt = str(tmp_path / "ckpt")
    part = Trainer(cfg, _tcfg(ckpt, accum), device="cpu", seed=0)
    part.fit(synthetic_batches(cfg, seed=3), steps=first)  # saves at the end
    assert os.listdir(ckpt) == [f"step_{first:08d}"]
    del part
    resumed = Trainer(cfg, _tcfg(ckpt, accum), device="cpu", seed=123)
    assert resumed.state.step == first
    batches = synthetic_batches(cfg, seed=3)
    for _ in range(first):  # replay what the first trainer consumed
        next(batches)
    resumed.fit(batches, steps=3 - first)

    assert resumed.state.step == 3
    a, b = full.state, resumed.state
    for name, p in a.model.state_dict().items():
        assert torch.equal(p, b.model.state_dict()[name]), name
        assert torch.equal(a.ema_params[name], b.ema_params[name]), name
    sa, sb = a.optimizer.adamw.state_dict(), b.optimizer.adamw.state_dict()
    for i, st in sa["state"].items():
        for key, value in st.items():
            assert torch.equal(value, sb["state"][i][key]), (i, key)
    assert (a.optimizer.count, a.optimizer.mini_step) == (b.optimizer.count,
                                                          b.optimizer.mini_step)
    assert torch.equal(full.gen.get_state(), resumed.gen.get_state())


def test_loss_decreases_on_fixed_batch():
    """Overfit check (the JAX trainer's test): a few steps on one repeated
    batch must reduce the loss at a fixed (t, eps)."""
    cfg = DiTConfig.tiny()
    trainer = Trainer(cfg, TrainConfig(learning_rate=3e-3, warmup_steps=1,
                                       total_steps=30, remat=True, log_every=100),
                      device="cpu", seed=0)
    batch = next(synthetic_batches(cfg, batch_size=2, seed=0))
    tb = batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(42)
    t = torch.randint(0, 1000, (2,), generator=gen)
    eps = torch.randn(tb["clean_latents"].shape, generator=gen)
    tables = noise_schedule(SchedulerConfig.aetherv1(), "cpu")

    def loss_now():
        with torch.no_grad():
            return float(diffusion_loss(
                trainer.state.model, *tables, tb["clean_latents"],
                tb["condition_latents"], tb["text_embeds"], tb["rope_cos"],
                tb["rope_sin"], t=t, eps=eps))

    def fixed():
        while True:
            yield batch

    first = loss_now()
    trainer.fit(fixed(), steps=20)
    assert loss_now() < first


def test_latent_batches_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    for i in range(3):
        np.savez_compressed(
            tmp_path / f"clip_{i}.npz",
            clean_latents=rng.standard_normal((3, 56, 4, 6)).astype(np.float16),
            num_frames=np.asarray(9), height=np.asarray(32), width=np.asarray(48),
            fps=np.asarray(12), text_embeds=np.zeros((0,), np.float16))
    cfg_j, cfg_t = JaxDiTConfig.tiny(), DiTConfig.tiny()
    text = rng.standard_normal((cfg_t.max_text_seq_length,
                                cfg_t.text_embed_dim)).astype(np.float32)
    for kw in ({}, {"text_embeds": text, "seed": 5}):
        ref = jax_latent_batches(str(tmp_path), cfg_j, batch_size=2,
                                 native_prefetch=False, process_index=0,
                                 process_count=1, **kw)
        ours = latent_batches(str(tmp_path), cfg_t, batch_size=2,
                              native_prefetch=False, **kw)
        for _ in range(4):  # one batch per epoch: crosses three reshuffles
            a, b = next(ours), next(ref)
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)


def test_cli_runs_on_cpu_and_refuses_unported_flags(capsys):
    """The mesh flags are ported (``test_torch_parallel_train_ckpt.py`` runs
    them over ranks); in one process they take the JAX CLI's paths: no mesh
    for --dp/--tp, the pp mesh's world check, the --fsdp and --pp/--tp
    guards."""
    main(["--synthetic", "--tiny", "--device", "cpu", "--steps", "2"])
    assert "step 2: loss=" in capsys.readouterr().out
    main(["--synthetic", "--tiny", "--device", "cpu", "--steps", "2", "--dp", "2", "--tp", "2"])
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "mesh" not in out
    args = ["--synthetic", "--tiny", "--device", "cpu"]
    with pytest.raises(ValueError, match=r"dp\(1\) \* pp\(2\) != num devices \(1\)"):
        main(args + ["--pp", "2"])
    with pytest.raises(SystemExit, match="--fsdp needs"):
        main(args + ["--fsdp"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(args + ["--pp", "2", "--tp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--synthetic", "--tiny", "--steps", "1"])

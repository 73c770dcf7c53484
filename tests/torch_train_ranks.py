"""Rank-side and reference helpers of the parallel-trainer tests
(``tests/test_torch_parallel_train*.py``).

:func:`rank_trainers` runs on each spawned gloo rank
(``parallel.launch.spawn``): it builds the port's ``Trainer`` over the mesh a
case names, trains it on ``synthetic_batches`` (or one fixed batch) with the
(t, eps) draws the case injects, and returns the losses, the global gradient
norms, the gathered one-card state (rank 0) and what each rank holds. The
pytest process computes the draws from the JAX key stream
(:func:`jax_draws`) and the JAX references.
"""

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch


def spawn_async(*args, **kwargs) -> Future:
    """``parallel.launch.spawn`` in a thread: the ranks run while the
    pytest process computes the JAX references; ``.result()`` joins."""
    from aether_tpu_torch.parallel.launch import spawn

    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(spawn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def jax_draws(seed: int, shape, steps: int):
    """(t, eps) of ``steps`` steps as the JAX Trainer draws them: one split of
    the trainer key a step, the step key split for t and eps."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        key_t, key_eps = jax.random.split(step_key)
        t = jax.random.randint(key_t, (shape[0],), 0, 1000)
        eps = jax.random.normal(key_eps, shape, jnp.float32)
        out.append((np.asarray(t).astype(np.int64), np.array(eps)))
    return out


class ListNoise:
    """A Trainer noise source handing out precomputed (t, eps) in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        t, eps = self.draws.pop(0)
        assert tuple(eps.shape) == tuple(shape), (eps.shape, shape)
        return torch.from_numpy(t), torch.from_numpy(eps)


def jax_state_dict(tree):
    """A JAX tiny-DiT parameter tree as the port's state dict (numpy)."""
    import jax

    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax

    sd = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), DiTConfig.tiny())
    return {k: v.numpy() for k, v in sd.items()}


def build_mesh(spec):
    """None, ("tp", dp, tp) for ``make_mesh`` or ("pp", pp, dp) for
    ``make_pp_mesh``."""
    if spec is None:
        return None
    from aether_tpu_torch.parallel import make_mesh
    from aether_tpu_torch.parallel.pipeline import make_pp_mesh

    kind, a, b = spec
    return make_mesh(dp=a, tp=b) if kind == "tp" else make_pp_mesh(a, b)


def _fractions(trainer):
    """{local parameter name: (local elements / full elements of the param,
    of its exp_avg, exp_avg_sq and EMA)} for the block-0 weights."""
    from aether_tpu_torch.parallel.mesh import local_view

    named = dict(trainer.state.model.named_parameters())
    out = {}
    with torch.device("meta"):
        from aether_tpu_torch.models.dit import DiT

        shapes = {n: p.numel() for n, p in DiT(trainer.dit_cfg).named_parameters()}
    for name, p in named.items():
        if not (name.startswith("blocks.0.") and name.endswith("weight")) or not p.requires_grad:
            continue
        e = trainer.layout.by_local[name]
        st = trainer.state.optimizer.adamw.state[p]
        n = shapes[e.name]
        out[e.name] = tuple(local_view(t).numel() / n for t in
                            (p, st["exp_avg"], st["exp_avg_sq"], trainer.state.ema_params[name]))
    return out


def rank_trainers(cases):
    """Every case on this rank (see the module docstring): {name: result}."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.parallel import initialize, is_main
    from aether_tpu_torch.parallel.mesh import local_view
    from aether_tpu_torch.train.trainer import TrainConfig, Trainer, synthetic_batches

    torch.set_num_threads(1)
    initialize(device="cpu")
    cfg = DiTConfig.tiny()
    results = {}
    for case in cases:
        init = case.get("init")
        trainer = Trainer(
            cfg, TrainConfig(**case["train"]), device="cpu", mesh=build_mesh(case.get("mesh")),
            init_params=None if init is None else {k: torch.from_numpy(v) for k, v in init.items()},
            seed=case.get("seed", 0),
            noise=ListNoise(case["draws"]) if case.get("draws") else None,
            pp_microbatches=case.get("n_micro", 2), fsdp=case.get("fsdp", False))
        res = {"restored_step": trainer.state.step}
        if case.get("restored_state"):
            res["restored"] = trainer.gathered_state()
        if case.get("fixed"):
            batch = next(synthetic_batches(cfg, batch_size=case["batch"], seed=case["data_seed"]))

            def fixed():
                while True:
                    yield dict(batch)

            batches = fixed()
        else:
            batches = synthetic_batches(cfg, batch_size=case["batch"], seed=case["data_seed"])
            for _ in range(case.get("skip", 0)):
                next(batches)
        losses, norms = [], []
        if case["train"].get("checkpoint_dir"):
            losses = trainer.fit(batches, steps=case["steps"])
        else:
            for _ in range(case["steps"]):
                losses += trainer.fit(batches, steps=1)
                norms.append(float(trainer.state.optimizer.grad_norm))
        res.update(losses=losses, norms=norms, step=trainer.state.step,
                   state=trainer.gathered_state() if case.get("state", True) else None,
                   main=is_main())
        if trainer.layout is not None:
            res["fractions"] = _fractions(trainer)
            res["resident"] = sum(local_view(p).numel() * p.element_size()
                                  for p in trainer.state.model.parameters())
        results[case["name"]] = res
    return results

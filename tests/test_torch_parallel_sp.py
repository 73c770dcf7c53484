"""Sequence parallelism in the port (sp over gloo ranks on the CPU), against
the JAX package on the conftest's 8-device CPU mesh.

- The DiT at sp = 2 and 4 and at tp x sp = 2 x 2, K/V gathered (the
  default) and through the ring (``AETHER_SP_RING=1``), with float and int8
  QK^T, against JAX's sharded forward on the same ``make_mesh(dp, tp, sp)``
  (Pallas kernels interpreted) at 2e-4 in f32; the 53-token stream (8 text +
  45 video) divides by neither 2 nor 4, so every case pads the last stripe
  (``kv_valid`` on the gathered path, the ring's exact pad correction).
- ``ring_attention`` on 2 and 4 ranks: against the gathered path (each
  stripe's K3 call over the whole K/V with ``kv_valid``) within 2e-4, against
  plain attention at the JAX ring test's bars (1e-4 float, 2e-2 int8), and
  equal to ``ring_attention_stripes``, the same arithmetic in one process
  without a process group.
"""

import numpy as np
import pytest
import torch

from aether_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    ring_attention_stripes,
)
from aether_tpu_torch.parallel.launch import spawn
from test_torch_parallel_dit import CFG, ENV, HERE, W, _world, jax_forward, make_case

torch.set_num_threads(1)

# name -> (mesh axes, options, AETHER_SP_RING)
CASES = {
    "sp2": (dict(dp=1, tp=1, sp=2), dict(fixed_max=True, qk_int8=False), False),
    "sp2_ring": (dict(dp=1, tp=1, sp=2), dict(fixed_max=True, qk_int8=False), True),
    "sp4": (dict(dp=1, tp=1, sp=4), dict(fixed_max=True, qk_int8=False), False),
    "sp4_ring": (dict(dp=1, tp=1, sp=4), dict(fixed_max=True, qk_int8=False), True),
    "sp4_ring_int8": (dict(dp=1, tp=1, sp=4), dict(fixed_max=True, qk_int8=True), True),
    "sp4_k4": (dict(dp=1, tp=1, sp=4), dict(fixed_max=False), False),
    "tp2_sp2": (dict(dp=1, tp=2, sp=2), dict(fixed_max=True, qk_int8=False), False),
    "tp2_sp2_ring": (dict(dp=1, tp=2, sp=2), dict(fixed_max=True, qk_int8=False), True),
    "dp2_sp2": (dict(dp=2, tp=1, sp=2), dict(fixed_max=True, qk_int8=False), False),
}
SEQ, RING_WORLDS = 501, (2, 4)
H = 6  # latent rows: 3 frames x 3 x 5 patches + 8 text tokens = 53


def rank_ring(q, k, v, n_pad, qk_int8):
    """This rank's stripe of ``ring_attention`` over the whole world."""
    import torch.distributed as dist

    from aether_tpu_torch.ops.flash_attention import ring_attention
    from aether_tpu_torch.parallel import initialize

    torch.set_num_threads(1)
    initialize(device="cpu")
    n, r = dist.get_world_size(), dist.get_rank()
    rows = q.shape[2] // n
    stripe = [t[:, :, r * rows:(r + 1) * rows] for t in (q, k, v)]
    return ring_attention(*stripe, dist.group.WORLD, n_pad=n_pad, qk_int8=qk_int8)


@pytest.fixture(scope="module")
def dit_setup():
    made = make_case(CFG, 2, height=H)
    _, _, state, inputs = made
    cases = {2: [], 4: []}
    for name, (axes, opts, ring) in CASES.items():
        cases[_world(axes)].append(dict(name=name, cfg=CFG, state=state, inputs=inputs,
                                        mesh=axes, opts=opts, ring=ring))
    ranks = {n: spawn("test_torch_parallel_dit:rank_cases", n, dict(cases=c),
                      extra_path=[HERE], env=ENV) for n, c in cases.items()}
    return made, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_sp_forward_matches_jax_sharded(dit_setup, monkeypatch, name):
    (cfg, params, _, inputs), ranks = dit_setup
    axes, opts, ring = CASES[name]
    outs = [r[name] for r in ranks[_world(axes)]]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    monkeypatch.setenv("AETHER_SP_RING", "1" if ring else "0")
    ref = jax_forward(cfg, params, inputs, axes, **opts)
    assert outs[0].shape == ref.shape == inputs[0].shape[:2] + (cfg.out_channels, H, W)
    np.testing.assert_allclose(outs[0], ref, atol=2e-4, err_msg=name)


def _qkv(seq, n):
    """Unit-ish-norm q/k rows (the fixed-max domain, as the JAX ring test
    draws them) and v, zero-padded to an n multiple; returns (q, k, v padded,
    unpadded q, k, v)."""
    rng = np.random.default_rng(3)
    shape = (1, 4, seq, 16)

    def normed():
        x = rng.normal(size=shape)
        return torch.from_numpy((x / np.linalg.norm(x, axis=-1, keepdims=True) * 3.0)
                                .astype(np.float32))

    q, k = normed(), normed()
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    pad = -(-seq // n) * n - seq
    return tuple(torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v)), (q, k, v)


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("world", RING_WORLDS)
def test_ring_attention_over_ranks(world, qk_int8):
    (qp, kp, vp), (q, k, v) = _qkv(SEQ, world)
    n_pad = qp.shape[2] - SEQ
    got = spawn("test_torch_parallel_sp:rank_ring", world,
                dict(q=qp, k=kp, v=vp, n_pad=n_pad, qk_int8=qk_int8),
                extra_path=[HERE], env=ENV)
    ring = torch.cat(got, dim=2)[:, :, :SEQ]
    rows = qp.shape[2] // world
    stripes = [[t[:, :, i * rows:(i + 1) * rows] for i in range(world)] for t in (qp, kp, vp)]
    one_process = torch.cat(ring_attention_stripes(*stripes, n_pad=n_pad, qk_int8=qk_int8),
                            dim=2)[:, :, :SEQ]
    np.testing.assert_allclose(ring.numpy(), one_process.numpy(), atol=1e-6)
    ref = attention_reference(q, k, v)
    np.testing.assert_allclose(ring.numpy(), ref.numpy(), atol=2e-2 if qk_int8 else 1e-4)
    if not qk_int8:
        gathered = torch.cat([flash_attention(qs, kp, vp, fixed_max=True, kv_valid=SEQ)
                              for qs in stripes[0]], dim=2)[:, :, :SEQ]
        np.testing.assert_allclose(ring.numpy(), gathered.numpy(), atol=2e-4)

"""The DiT at head_dim 320 and 512 against JAX (CPU).

Above 256 the card runs K4 through its wide kernels (the width at run time);
the route is the one the JAX ``dit_forward`` takes at every head_dim >= 128
(``aether_tpu/models/dit.py:819-825``): the unfused wrapper with the fixed
max off, K4 "vpu" in every block, never the fused K1 + K2 path. As
``tests/test_torch_dit_head_dims.py`` does at 128-256: the tiny config with
one head of 320 and of 512, the same JAX parameters on both sides
(``PRNGKey(7)``, ``dit_state_dict_from_jax``), one batch-1 3-frame forward
at t = 700 at the default attention settings and at
``AETHER_ATTN_FIXED_MAX=0`` (JAX through the Pallas kernels in interpret
mode), at 2e-3 of the output. The loss and its gradients at these head dims:
``tests/test_torch_dit_train_above_256.py``.
"""

import pytest
import torch

from test_torch_dit_head_dims import _check_route

torch.set_num_threads(1)


@pytest.mark.parametrize("fixed_max_off", [False, True])
@pytest.mark.parametrize("hd", [320, 512])
def test_route_matches_jax_above_256(monkeypatch, hd, fixed_max_off):
    if fixed_max_off:
        monkeypatch.setenv("AETHER_ATTN_FIXED_MAX", "0")
    _check_route(monkeypatch, hd, False)


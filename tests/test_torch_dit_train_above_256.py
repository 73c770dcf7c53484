"""The DiT's training loss and gradients at head_dim 320 and 512 against JAX
(CPU).

Above 256 K4 "vpu" enters the training forward (``flash_train``) through the
card's wide kernels; on the CPU through the plain version. As
``tests/test_torch_dit_head_dims.py`` does at 128 and 256: the tiny config
with one head of 320 and of 512, the same JAX parameters on both sides
(``PRNGKey(7)``), the loss and its gradients against ``jax.value_and_grad``
(``tests/test_torch_dit_train.py``'s bars): the loss to 1e-5 relative, each
gradient to 1e-4 of its largest magnitude.
"""

import pytest
import torch

from test_torch_dit_head_dims import _check_loss_and_gradients

torch.set_num_threads(1)


@pytest.mark.parametrize("hd", [320, 512])
def test_loss_and_gradients_above_256_match_jax(hd):
    _check_loss_and_gradients(hd, 7)

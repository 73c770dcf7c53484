"""Fine-tuning: the v-prediction loss and train step (``step``), the
trainer with its CLI, on one device or over a mesh (``trainer``), and the
latent loader (``data``)."""

from aether_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    create_train_state,
    diffusion_loss,
    make_train_step,
)

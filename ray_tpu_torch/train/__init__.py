"""ray_tpu_torch.train — training (counterpart of ray_tpu/train/).

Layer map:
  spmd.py        the single-device train step, TrainState, next_token_loss
  optim.py       optimizers that follow optax step for step,
                 warmup_cosine
  checkpoint.py  atomic torch.save checkpoints, CheckpointManager

The trainers, elastic gangs, sessions and adapters of the JAX package
wait for later slices.
"""
from .checkpoint import (Checkpoint, CheckpointManager, restore_pytree,
                         save_pytree)
from .optim import make_optimizer, warmup_cosine
from .spmd import TrainState, make_train_step, next_token_loss

__all__ = ["TrainState", "make_train_step", "next_token_loss",
           "make_optimizer", "warmup_cosine", "Checkpoint",
           "CheckpointManager", "save_pytree", "restore_pytree"]

"""Training, as the JAX package's ``training``: synthetic data, AdamW and
the train step (:mod:`.train_loop`), on the card by default."""

from .data import SyntheticLM, make_batch
from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_schedule
from .train_loop import TrainState, cross_entropy, init_train_state, make_train_step

__all__ = [
    "SyntheticLM",
    "make_batch",
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "TrainState",
    "cross_entropy",
    "init_train_state",
    "make_train_step",
]

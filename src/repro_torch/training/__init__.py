"""Training of the port: optimizer, data pipeline, train-step factory."""
from .data import DataConfig, SyntheticLM
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .train_loop import cross_entropy, init_train_state, make_loss_fn, make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "cross_entropy",
           "init_train_state", "make_loss_fn", "make_train_step",
           "DataConfig", "SyntheticLM"]

"""Step functions of the LM stack (port of ``repro.train``): the train and
serve steps, AdamW and checkpoints."""
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .train_step import make_serve_steps, make_train_step, value_and_grad

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state",
           "make_serve_steps", "make_train_step", "value_and_grad"]

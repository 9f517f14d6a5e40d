"""Step functions of the LM stack (port of ``repro.train``): the serve
steps; the training step, optimizer and checkpoints come with training."""
from .train_step import make_serve_steps

__all__ = ["make_serve_steps"]

"""Checkpoints of tensor trees in the reference's npz format.  The port of
``repro.checkpoint``."""
from .ckpt import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]

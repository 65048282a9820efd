"""Functional optimizers of the port (``repro.optim`` counterpart)."""
from .optimizers import SGD, Adam, AdamState

__all__ = ["Adam", "AdamState", "SGD"]

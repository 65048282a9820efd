"""Functional optimizers of the port (``repro.optim`` counterpart)."""
from .optimizers import Adam, AdamState

__all__ = ["Adam", "AdamState"]

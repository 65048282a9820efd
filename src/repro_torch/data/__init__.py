"""Synthetic data, partitions and batching (``repro.data`` counterpart).
``pad_stack`` comes with the stacked executor (ROADMAP.md Queue 1 item
5)."""
from .loader import sample_batch, steps_per_epoch
from .partition import partition_dirichlet, partition_major
from .ragged import client_lengths, pad_compatible
from .synthetic import lm_examples, make_classification_data, make_lm_data

__all__ = [
    "sample_batch",
    "steps_per_epoch",
    "partition_dirichlet",
    "partition_major",
    "client_lengths",
    "pad_compatible",
    "lm_examples",
    "make_classification_data",
    "make_lm_data",
]

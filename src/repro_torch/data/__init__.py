"""Synthetic data, partitions and batching (``repro.data`` counterpart);
``pad_stack`` pads a ragged cohort for the stacked executor."""
from .loader import sample_batch, steps_per_epoch
from .partition import partition_dirichlet, partition_major
from .ragged import client_lengths, pad_compatible, pad_stack
from .synthetic import lm_examples, make_classification_data, make_lm_data

__all__ = [
    "sample_batch",
    "steps_per_epoch",
    "partition_dirichlet",
    "partition_major",
    "client_lengths",
    "pad_compatible",
    "pad_stack",
    "lm_examples",
    "make_classification_data",
    "make_lm_data",
]

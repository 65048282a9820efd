"""Synthetic data, partitions and batching (``repro.data`` counterpart)."""

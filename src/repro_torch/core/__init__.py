"""Federated protocol of the port (``repro.core`` counterpart)."""

"""Neural-network building blocks of the port (``repro.nn`` counterpart)."""

"""Checkpoints of parameter and optimizer trees (`store.py`)."""

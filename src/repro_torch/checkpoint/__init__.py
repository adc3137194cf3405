"""Checkpoints of the port's state trees (JSON manifest + npz leaves)."""

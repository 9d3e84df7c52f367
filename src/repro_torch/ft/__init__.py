"""Fault tolerance: checkpoints (the sandbox snapshots of the platform)."""

"""Crash-safe checkpoints of trees of arrays (the snapshot storage layer)."""

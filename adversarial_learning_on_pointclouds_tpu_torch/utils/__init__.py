"""Checkpoint loading, weight conversion and ``.ply`` I/O."""

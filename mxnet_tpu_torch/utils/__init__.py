"""Utilities shared across the package: sharded checkpoints
(:mod:`.checkpoint`) and program accounting with CUDA-graph capture
(:mod:`.compile`)."""

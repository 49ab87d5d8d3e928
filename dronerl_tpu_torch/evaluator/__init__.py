"""Competition evaluation: fixed-seed round-robin scoring of checkpoints."""

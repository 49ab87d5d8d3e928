"""Env point ops and the fused training-tick kernel with its plain version."""

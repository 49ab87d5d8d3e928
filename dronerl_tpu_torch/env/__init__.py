"""Environment: parameters, state, and the batched reset / step / observe."""

"""The reference's Q-nets, one module a ``network_type``: each gives
``init(key, obs_dim, flags) -> leaves`` (the initial weights drawn from
the key as the program's CLI draws them, on the CPU) and ``forward_t(
leaves, obs_t, matmul, flags) -> q (A, B)`` for feature-major
observations, every product through ``matmul``."""

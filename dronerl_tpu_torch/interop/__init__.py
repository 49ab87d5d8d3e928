"""Carrying state across from the JAX package."""

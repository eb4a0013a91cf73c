"""Checkpoint reading and the weights bridge from the JAX package's trees."""

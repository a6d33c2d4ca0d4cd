"""GCONV IR (copied from the JAX package), operators and the oracle."""

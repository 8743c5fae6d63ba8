"""Corpus arrays and batch indices for training (own copies of the JAX package's numpy code)."""

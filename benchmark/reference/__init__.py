"""The plain reference of the benchmark: the explicit (Blasco-Codina-Huerta)
fractional step in plain PyTorch, assembled from the deck by this package
alone.  It imports neither JAX nor either package of this repository."""

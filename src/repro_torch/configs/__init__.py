"""Architecture configurations the port runs (copies of the JAX package's)."""

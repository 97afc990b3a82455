"""Internal machinery of the port (the JAX package's ``_private`` counterpart)."""

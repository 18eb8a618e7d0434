"""Host-side observability: the port's copies of the JAX package's
jax-free ``obs/`` modules (so far ``flight``, trimmed)."""

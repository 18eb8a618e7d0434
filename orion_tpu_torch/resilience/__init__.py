"""Host-side resilience: the port's copies of the JAX package's jax-free
``resilience/`` modules (so far ``retry``)."""

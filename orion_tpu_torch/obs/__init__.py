"""Host-side observability: the port's copies of the JAX package's
jax-free ``obs/`` modules: ``metrics``, ``trace`` and ``flight`` (slo, http
and cost wait for ROADMAP.md A9)."""

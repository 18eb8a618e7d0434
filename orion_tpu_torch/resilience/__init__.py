"""Host-side resilience: the port's copies of the JAX package's jax-free
``resilience/`` modules: ``retry``, ``preempt``, ``watchdog`` and a trimmed
``inject`` (the breaker waits for the stores, ROADMAP.md A8 step 3)."""

"""Host-side resilience: the port's copies of the JAX package's jax-free
``resilience/`` modules: ``retry``, ``preempt``, ``watchdog``, ``breaker``
(the stores' circuit breakers) and ``inject`` (without the training, data,
executable-store and fleet sites: ROADMAP.md A9, A13)."""

"""Host-side resilience: the port's copies of the JAX package's jax-free
``resilience/`` modules: ``retry`` (jittered backoff for transient I/O),
``preempt`` (SIGTERM / SIGINT -> a graceful stop at the next step boundary,
an emergency checkpoint, a resumable exit), ``watchdog`` (heartbeat stall
detection), ``breaker`` (the stores' circuit breakers) and ``inject`` (the
training, checkpoint, data, serving and fleet fault sites; without the
executable store's: ROADMAP.md A13)."""

"""Training for the port: trainer, data, checkpoints, metrics."""

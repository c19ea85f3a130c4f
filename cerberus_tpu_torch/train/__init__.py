"""Training: losses, steps, the run engine, callbacks and the trainer."""

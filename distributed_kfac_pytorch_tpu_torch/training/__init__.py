"""Training loop, data, optimizers and utilities of the port."""

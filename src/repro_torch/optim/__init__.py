"""Functional optimizers over parameter dictionaries."""

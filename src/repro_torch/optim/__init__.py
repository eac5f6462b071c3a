"""Optimizers of the port (mirrors ``repro/optim``)."""

"""Checkpoints of the port (mirrors ``repro/checkpoint``): the reference's
on-disk layout, so that either side restores the other's."""

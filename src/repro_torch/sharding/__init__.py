"""Logical-axis sharding of the port (mirrors ``repro/sharding``)."""

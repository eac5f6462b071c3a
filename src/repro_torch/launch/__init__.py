"""Meshes of the port (mirrors ``repro/launch``)."""

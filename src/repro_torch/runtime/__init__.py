"""Elastic re-meshing of the port (mirrors ``repro/runtime/elastic.py``)."""

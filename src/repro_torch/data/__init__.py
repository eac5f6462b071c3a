"""The port's data pipeline (mirrors ``repro/data``)."""

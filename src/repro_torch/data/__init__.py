"""Training data pipeline (port of ``repro/data``)."""

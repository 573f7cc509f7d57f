"""Mesh construction (``mesh.py``)."""

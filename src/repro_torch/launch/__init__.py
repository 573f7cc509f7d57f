"""Meshes (``mesh.py``), the dry run of every (architecture x shape) cell
on the meta device (``dryrun.py``) and its per-device cost analysis of an
eager run (``op_analysis.py``)."""

"""Sharding recipes, parameter specs, placement on a mesh and the
cross-shard combines (``sharding.py``), the bounded-staleness (quasi-sync)
trainer and the cluster utilization model (``quasi_sync.py``), the GPipe
pipeline (``pipeline.py``), and the blockwise int8 gradient compression
with error feedback (``compression.py``)."""

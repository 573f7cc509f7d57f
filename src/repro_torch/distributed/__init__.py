"""Mesh serving's parameter partition specs and its cross-shard combines
(``sharding.py``), and the blockwise int8 gradient compression with error
feedback (``compression.py``)."""

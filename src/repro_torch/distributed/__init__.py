"""Mesh serving's parameter partition specs and its cross-shard combines
(``sharding.py``)."""

"""Fault tolerance of the train loop (port of ``repro/runtime``)."""

"""Checkpoints in the reference's on-disk format (port of
``repro/checkpoint``)."""

"""Training: AdamW and the train loop (port of ``repro/train``)."""

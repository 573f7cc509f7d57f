"""Device time of prefill attention per thousand prompt tokens: the
``device_s`` of the ``attention`` spans (CUDA events around the score,
softmax and value part of each layer's attention) under the window's
``prefill`` spans, over those prefills' ``prompt_tokens``.  It is stream
time from a span's first kernel to its last, so where the host launches
more slowly than the device runs it holds the idle between them."""

from perfbench.core.spans import prefill_device_ms_per_ktok

LAYER = "Attention (models/attention.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = {"itl": "itl_p95_ms"}


def read(run, name):
    return prefill_device_ms_per_ktok(run, "attention")

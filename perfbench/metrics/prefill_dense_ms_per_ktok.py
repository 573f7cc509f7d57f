"""Device time of the prefill's dense projections per thousand prompt
tokens: the ``device_s`` of the ``dense`` spans (CUDA events around each
quantized matmul: the activation quantizer, K1 and the dequantizing
epilogue) under the window's ``prefill`` spans, over those prefills'
``prompt_tokens``.  Stream time from a span's first kernel to its last, so
it holds the device's idle between them where the host launches more
slowly than the device runs."""

from perfbench.core.spans import prefill_device_ms_per_ktok

LAYER = "Dense projections (core/bp_matmul.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = {"itl": "itl_p95_ms"}


def read(run, name):
    return prefill_device_ms_per_ktok(run, "dense")

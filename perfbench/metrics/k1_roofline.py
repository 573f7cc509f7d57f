"""K1's share of its roofline in the traced window: the least time of every
dense projection call the window made (the benchmark's own count of each
call's M, K and N from the prefill rows and decode batches it logged, one
int8 contraction each) over the device time of K1's kernels there."""

from perfbench.core.trace import kernel_seconds

LAYER = "Kernel K1 (kernels/bitparticle_matmul)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"itl": "itl_p95_ms", "tput": "output_tokens_per_s"}
#: K1's kernels: the decode GEMV and the prefill tiles
KERNELS = ("bp_gemv", "bp_tile", "bp_wgmma")


def read(run, name):
    tr = run.trace
    if not tr:
        return None
    dev = kernel_seconds(tr["kernels"], KERNELS)
    if dev <= 0:
        return None
    w = run.work
    calls = []
    for _, rows, pad, _ in tr["prefills"]:
        calls += w.k1_calls(rows * pad, rows)
    for _, _, _ in tr["decodes"]:
        calls += w.k1_calls(run.n_slots, run.n_slots)
    return 100.0 * w.k1_bound_s(calls) / dev

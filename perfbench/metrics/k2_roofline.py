"""K2's share of its roofline in the traced window: the least time of every
paged decode attention call (one per layer per decode step, at the step's
cache lengths of every slot) over the device time of K2's kernel."""

from perfbench.core.peaks import attention_bound_s
from perfbench.core.trace import kernel_seconds

LAYER = "Kernel K2 (kernels/paged_attention)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"tput": "output_tokens_per_s"}
KERNELS = ("paged_attention_kernel",)


def read(run, name):
    tr = run.trace
    if not tr:
        return None
    dev = kernel_seconds(tr["kernels"], KERNELS)
    if dev <= 0:
        return None
    w = run.work
    bound = sum(w.L * attention_bound_s(lens, w.H, w.KH, w.hd,
                                        run.block_size, run.blocks_per_seq)
                for _, lens, _ in tr["decodes"])
    return 100.0 * bound / dev

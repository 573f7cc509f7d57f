"""Activation sparsity stats collected at the quantized-matmul call sites
(port of ``repro/core/probe.py``; paper Section IV-B3 measured on live
operands instead of synthetic samples).

The reference taps a thread-local frame while a step is traced.  The port
passes an explicit :class:`StatsCollector` down the model instead: the
serving executor builds one per probed step, the model's layer loop hands
it to every dense call (``models/layers.dense``), which calls
:meth:`StatsCollector.record` with the float activation just before it is
quantized, and the loop drains it once per layer.  :meth:`collect` gives
the executor one small ``(L[+1], N_STATS)`` float32 tensor, the only probe
data that leaves the device.  A forward without a collector records
nothing and runs exactly the operations it ran before.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import quant
from repro_torch.core.sparsity import N_STATS, sm_bit_counts, zero_bit_table


def probe_supported(cfg) -> bool:
    """The probe taps int8 operands at the quantized-matmul boundary: only
    the causal-LM families in a BitParticle int8 mode have them."""
    return (cfg.family in ("dense", "moe", "vlm")
            and cfg.matmul_mode in ("bp_exact", "bp_approx"))


#: float32 1/127: the reference's compiled tap multiplies by it (XLA's
#: simplifier rewrites the division by the constant 127)
_INV_QMAX = torch.tensor(1.0 / quant.QMAX, dtype=torch.float32).item()


def activation_counts(x: torch.Tensor,
                      table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N_STATS,)`` int64 sums of ``x`` as the int8 operand: the per-row
    symmetric quantization recomputed in float32, as the reference's tap
    does, with the scale ``max(|x|, 1e-8) * float32(1/127)`` of its
    compiled program (its op-by-op math divides by 127, and the two part at
    rounding edges).  ``quantized_matmul`` quantizes in the activation's
    own dtype (bf16), so the kernel's operand can differ from this one by
    one at rounding edges too; the stats follow the reference's tap."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    return sm_bit_counts(quant.quantize(xf, torch.clamp_min(amax, 1e-8)
                                        * _INV_QMAX), table)


class StatsCollector:
    """Per-layer sum-form sparsity stats of one forward's int8 activations.

    ``record`` at every quantized-matmul call site, ``absorb_pending``
    before the layer loop, ``drain_layer`` at the end of every layer,
    ``collect`` after the forward (the lm head's rows, when the head is a
    quantized matmul, go into one trailing row).  Rows stay int64 sums on
    the device until ``collect`` rounds them to float32 once."""

    def __init__(self):
        self.pending: List[torch.Tensor] = []   # rows since the last drain
        self.layers: List[torch.Tensor] = []    # one summed row per layer
        self.extra: List[torch.Tensor] = []     # rows before the layer loop
        # the last input and its row: q/k/v (and gate/up) quantize one
        # activation, whose stats are computed once and counted per call
        self._last: Optional[tuple] = None
        self._table: Optional[torch.Tensor] = None   # zero_bit_table

    def record(self, x: torch.Tensor) -> None:
        if self._last is None or self._last[0] is not x:
            if self._table is None:
                self._table = zero_bit_table(x.device)
            self._last = (x, activation_counts(x, self._table))
        self.pending.append(self._last[1])

    def absorb_pending(self) -> None:
        """Move rows recorded before the layer loop into the extra bucket,
        so that the first drained layer does not take them."""
        self.extra.extend(self.pending)
        self.pending = []

    def drain_layer(self) -> None:
        """Close one layer: the sum of the rows recorded since the last
        drain (zeros when the layer recorded nothing)."""
        rows, self.pending = self.pending, []
        if rows:
            self.layers.append(torch.stack(rows).sum(dim=0))
        else:
            self.layers.append(None)

    def collect(self) -> Optional[torch.Tensor]:
        """``(L[+1], N_STATS)`` float32 stats, or None when no layer was
        drained.  The extra bucket and any rows still pending (an untied lm
        head after the loop) sum into one trailing row, present only when
        such rows exist."""
        if not self.layers:
            return None
        ref = next((r for r in self.layers if r is not None), None)
        dev = ref.device if ref is not None else None
        zeros = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
        rows = [zeros if r is None else r for r in self.layers]
        tail = self.extra + self.pending
        self.extra, self.pending, self._last = [], [], None
        if tail:
            rows.append(torch.stack(tail).sum(dim=0))
        return torch.stack(rows).to(torch.float32)

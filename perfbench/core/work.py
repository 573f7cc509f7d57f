"""The benchmark's own count of a Qwen2 decoder's work, from the published
configuration and the tokens processed, whatever kernel does it.

Dense projections count two operations per multiply-add; attention counts
q.k and p.v over the causal prefix each position needs (not the padded or
masked work a kernel may do); the unembedding counts only the rows whose
logits are used.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from perfbench.core import peaks
from perfbench.core.weights import padded_vocab


class Qwen2Work:
    def __init__(self, model: dict):
        self.d = d = model["hidden_size"]
        self.L = model["num_hidden_layers"]
        self.H = H = model["num_attention_heads"]
        self.KH = KH = model["num_key_value_heads"]
        self.hd = hd = model.get("head_dim", d // H)
        self.ff = ff = model["intermediate_size"]
        self.V = padded_vocab(model["vocab_size"])
        self.tied = bool(model["tie_word_embeddings"])
        #: (K, N) of one layer's dense projections: q, k, v, o, gate, up,
        #: down
        self.layer_kn: List[Tuple[int, int]] = [
            (d, H * hd), (d, KH * hd), (d, KH * hd), (H * hd, d),
            (d, ff), (d, ff), (ff, d)]
        self.layer_params = sum(k * n for k, n in self.layer_kn)

    # -- serving --------------------------------------------------------------

    def attention_flops(self, ctx: int) -> float:
        """q.k and p.v of one query row over ``ctx`` positions, all
        layers."""
        return 4.0 * self.H * self.hd * ctx * self.L

    def prefill_least_s(self, lens: Sequence[int]) -> float:
        """Least seconds of a prefill of rows of these lengths: dense int8
        operations at the int8 peak; causal attention and a tied
        unembedding of each row's last position at the bf16 peak (an
        untied head is int8)."""
        tokens = sum(lens)
        int8 = 2.0 * self.layer_params * self.L * tokens
        bf16 = sum(self.attention_flops(s * (s + 1) / 2) for s in lens)
        head = 2.0 * self.d * self.V * len(lens)
        if self.tied:
            bf16 += head
        else:
            int8 += head
        return int8 / peaks.INT8_OPS_PER_S + bf16 / peaks.BF16_OPS_PER_S

    def decode_least_s(self, lens: Sequence[int]) -> float:
        """Least seconds of one decode step of active sequences whose
        caches hold ``lens`` positions (each attends to len + 1)."""
        n = len(lens)
        int8 = 2.0 * self.layer_params * self.L * n
        bf16 = sum(self.attention_flops(s + 1) for s in lens)
        head = 2.0 * self.d * self.V * n
        if self.tied:
            bf16 += head
        else:
            int8 += head
        return int8 / peaks.INT8_OPS_PER_S + bf16 / peaks.BF16_OPS_PER_S

    def k1_calls(self, m: int, head_rows: int) -> List[Tuple[int, int, int]]:
        """(M, K, N) of every K1 call of one forward over ``m`` rows, with
        the head (untied only) over ``head_rows`` rows."""
        calls = [(m, k, n) for k, n in self.layer_kn] * self.L
        if not self.tied and head_rows:
            calls.append((head_rows, self.d, self.V))
        return calls

    def k1_bound_s(self, calls) -> float:
        return sum(peaks.matmul_bound_s(m, k, n) for m, k, n in calls)

    # -- training -------------------------------------------------------------

    def params(self) -> int:
        """Parameters that the forward multiplies by: every layer's dense
        weights and the unembedding (counted once, tied or not)."""
        return self.layer_params * self.L + self.d * self.V

    def train_least_s(self, rows: int, seq: int) -> float:
        """Least seconds of one optimizer step over ``rows`` sequences of
        ``seq`` tokens: 6 x parameters x tokens plus causal attention's
        forward and backward (3 x the forward), at the bf16 peak;
        recomputation not counted."""
        dense = 6.0 * self.params() * rows * seq
        attn = 3.0 * rows * self.attention_flops(seq * (seq + 1) / 2)
        return (dense + attn) / peaks.BF16_OPS_PER_S

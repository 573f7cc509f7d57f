"""The comparison that decides ``correct``.

Serving: once the window has closed and the program is freed, a sample of
the finished requests drawn from the seed, with the one that served the
most tokens in it, is run through the plain reference: each prompt with
its served tokens, once.  The number compared is the widest gap by which
a served token's reference logit lies below the reference's best at its
position (greedy serving, so a sound program serves the reference's best
up to rounding).  The control is the reference itself at the next lower
precision (int4 for the configuration's int8): the gap of the token it
puts first.
"""

from __future__ import annotations

from typing import Dict, List

from perfbench.core import traffic as gen
from perfbench.core.weights import make_flat


def sample(requests: List[dict], seed: int, k: int) -> List[dict]:
    """The finished window requests to check: the one with the most served
    tokens, and ``k - 1`` more drawn from the seed."""
    done = [r for r in requests
            if r["measured"] and r["reason"] == "length" and r["tokens"]]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i]["tokens"]))
    rest = [i for i in range(len(done)) if i != longest]
    rng = gen.rng_for(seed, 7)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[int(i)]] for i in sorted(pick)]


def serve_readings(requests: List[dict], config: dict, seed: int, k: int,
                   device: str, control: bool = False) -> Dict[str, float]:
    """{"max_logit_gap": ..., "checked_tokens": ...[,
    "control_max_logit_gap"]}."""
    from perfbench.reference import qwen2
    model = config["model"]
    picked = sample(requests, seed, k)
    qwen2.no_tf32()
    w = make_flat(model, seed, device)
    worst, ctl_worst, n = 0.0, 0.0, 0
    for r in picked:
        gaps, ctl = qwen2.served_gaps(
            w, model, r["prompt"].tolist(), r["tokens"],
            qmax=int(config["check"]["qmax"]),
            control_qmax=int(config["check"]["control_qmax"]) if control
            else 0)
        worst = max(worst, max(gaps))
        n += len(gaps)
        if ctl is not None:
            ctl_worst = max(ctl_worst, max(ctl))
    out = {"max_logit_gap": worst, "checked_tokens": float(n),
           "checked_requests": float(len(picked))}
    if control:
        out["control_max_logit_gap"] = ctl_worst
    return out

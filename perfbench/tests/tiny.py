"""Tiny copies of the cells' files, for the CPU tests: the same keys and
code paths at sizes a test run holds."""

import copy
import json
import pathlib

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]


def _load(*parts):
    with open(PERFBENCH.joinpath(*parts), encoding="utf-8") as f:
        return json.load(f)


def config(tied: bool = True) -> dict:
    c = _load("configs", "qwen2-1.5b.json" if tied else "qwen2-7b.json")
    c["model"].update(hidden_size=64, intermediate_size=128,
                      num_attention_heads=4, num_key_value_heads=2,
                      num_hidden_layers=2, vocab_size=500)
    c["serving"]["cpu_blocks"] = 96
    # prompts grouped two to a prefill call: the grouped path at this size
    c["serving"]["scheduler"] = dict(c["serving"].get("scheduler", {}),
                                     max_prefill_batch=2)
    return c


def docqa(rate: float = 6.0) -> dict:
    m = copy.deepcopy(_load("traffic", "docqa.json"))
    m.update(rate_per_s=rate, n_slots=4, max_context=192, max_prompt=136,
             document_tokens={"dist": "log_uniform", "low": 32, "high": 128},
             question_tokens={"dist": "log_uniform", "low": 2, "high": 8},
             answer_tokens={"dist": "log_uniform", "low": 6, "high": 16},
             trace={"start_share": 0.2, "seconds": 0.6},
             check={"requests": 3})
    return m


def chat() -> dict:
    m = copy.deepcopy(_load("traffic", "chat.json"))
    m.update(clients=3, n_slots=3, system_tokens=16, max_context=96,
             max_prompt=90,
             user_tokens={"dist": "log_uniform", "low": 4, "high": 16},
             answer_tokens={"dist": "log_uniform", "low": 3, "high": 8},
             trace={"start_share": 0.2, "seconds": 0.6},
             check={"requests": 2})
    return m


def bench() -> dict:
    """``BENCHMARK.json`` with the entries of the cell it leaves out
    (``deferred_cells.json``), as a later PR would add them."""
    b = _load("..", "BENCHMARK.json")
    more = _load("tests", "deferred_cells.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + more[key]
    return b


def qat() -> dict:
    m = copy.deepcopy(_load("traffic", "qat.json"))
    m.update(rows=4, seq_len=32, trace={"start_share": 0.1, "seconds": 0.5})
    return m


#: limits at the tiny size, set as the cells' are on the card: above the
#: program's widest reading over the tiny runs' seeds (serving 0.09;
#: training's first-step loss 0.002, gradient 0.011, change 0.014) and
#: below the control's least (serving 1.02; training's gradient 0.034) or
#: a fault's (the update doubled: change 0.996)
LIMITS = {
    "serve": {"max_logit_gap": {"limit": 0.4}},
    "train": {"loss_gap": {"limit": 0.005}, "grad_gap": {"limit": 0.025},
              "change_gap": {"limit": 0.1}},
}

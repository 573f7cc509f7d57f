"""Share of the prompt blocks admitted in the window that the KV store
found in its prefix trie: the ``block_insert`` spans' ``prefix_hits`` over
``prefix_hits + n_blocks`` (hit blocks and freshly written ones)."""

LAYER = "KV store (serving/block_pool.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = {"tput": "output_tokens_per_s"}


def read(run, name):
    ins = [s["args"] for s in run.spans if s["name"] == "block_insert"]
    hits = sum(a["prefix_hits"] for a in ins)
    total = hits + sum(a["n_blocks"] for a in ins)
    return 100.0 * hits / total if total else None

"""The readers of the program's spans: a tiny traced docqa serve on the CPU
records the model's spans under the loop's, and each reader gives the
right number on a hand-made run and nothing where it finds nothing."""

from perfbench.core import run as R
from perfbench.core.serve import ServeCell
from perfbench.tests import tiny

SEED = 2 ** 31 + 4242
NEW = ("prefill_attn_ms_per_ktok.itl", "prefill_dense_ms_per_ktok.itl",
       "decode_enqueue_ms.itl")


def _inside(s, p):
    return p["t"] <= s["t"] and s["t"] + s["dur"] / 1e6 <= \
        p["t"] + p["dur"] / 1e6 + 1e-9


def test_a_traced_docqa_serve_records_the_model_spans():
    bench = tiny.bench()
    cell = ServeCell("qwen2-1.5b.docqa", tiny.config(True), tiny.docqa(),
                     seed=SEED, seconds=1.0, trace=True, device="cpu",
                     t_start=0.0)
    cell.setup()
    try:
        data = cell.run()
    finally:
        cell.release()
    by_id = {s["span_id"]: s for s in data.spans}
    model = [s for s in data.spans if s["name"] in ("attention", "dense")]
    assert {s["name"] for s in model} == {"attention", "dense"}
    callers = set()
    for s in model:
        chain, p = [], by_id.get(s["parent_id"])
        while p is not None:
            assert _inside(s, p), (s, p)
            chain.append(p["name"])
            p = by_id.get(p["parent_id"])
        assert chain[0] in ("prefill", "decode_forward"), chain
        callers.add(chain[0])
        keys = ({"rows", "q_len", "kv_len"} if s["name"] == "attention"
                else {"m", "k", "n"})
        assert set(s["args"]) == keys          # no device time on the CPU
    assert callers == {"prefill", "decode_forward"}
    for s in data.spans:
        if s["name"] == "decode_forward":
            assert by_id[s["parent_id"]]["name"] == "decode"
        if s["name"] in ("sample", "match_prefix", "register"):
            assert by_id[s["parent_id"]]["name"] == "install"
        if s["name"] == "prefill":
            assert s["args"]["prompt_tokens"] > 0
    got = R.read_metrics(bench, data, True)
    # the device's spans carry no device time on the CPU
    assert NEW[0] not in got and NEW[1] not in got
    assert 0 < got[NEW[2]]["value"] <= got["decode_step_ms.itl"]["value"]


def _span(sid, name, parent=None, dur=100.0, **args):
    return {"span_id": sid, "parent_id": parent, "name": name, "t": 0.0,
            "ts": 0.0, "dur": dur, "args": args}


def test_the_span_readers_on_a_hand_made_run():
    run = R.RunData(cell="c", kind="serve", config={}, mix={}, work=None,
                    t0=0.0, t1=1.0, setup_s=0.0)
    read = {n: R.reader(n) for n in NEW}
    assert all(read[n].read(run, n) is None for n in NEW)
    run.spans = [
        _span(1, "prefill", prompt_tokens=1000),
        _span(2, "attention", 1, device_s=0.010),
        _span(3, "dense", 1, device_s=0.002),
        _span(4, "dense", 1, device_s=0.003),
        _span(5, "prefill", prompt_tokens=1500),
        _span(6, "wrapper", 5),
        _span(7, "attention", 6, device_s=0.005),
        _span(8, "decode"),
        _span(9, "decode_forward", 8, dur=3000.0),
        _span(10, "attention", 9, device_s=0.5),
        _span(11, "dense", 9, device_s=0.5),
        _span(12, "decode"),
        _span(13, "decode_forward", 12, dur=5000.0),
        _span(14, "draft"),
        _span(15, "decode_forward", 14, dur=99000.0),
        {"name": "block_insert", "args": {}},       # no ids: not read
    ]
    assert read[NEW[0]].read(run, NEW[0]) == 1e6 * 0.015 / 2500
    # the dense spans lie under the first prefill alone
    assert read[NEW[1]].read(run, NEW[1]) == 1e6 * 0.005 / 1000
    assert read[NEW[2]].read(run, NEW[2]) == 4.0
    # spans timed on no device
    for s in run.spans:
        s.get("args", {}).pop("device_s", None)
    assert read[NEW[0]].read(run, NEW[0]) is None
    assert read[NEW[1]].read(run, NEW[1]) is None
    # spans that carry no ids (an older program's) read nothing
    for s in run.spans:
        s.pop("span_id", None)
        s.pop("parent_id", None)
    assert all(read[n].read(run, n) is None for n in NEW)

"""The benchmark's yardstick on the CPU: generators, statistics, bounds,
work counts, discovery of files, and what its modules import."""

import ast
import json
import math
import pathlib
import shutil

import numpy as np
import pytest

from perfbench.core import peaks, run as R, stats, traffic as gen
from perfbench.core.work import Qwen2Work
from perfbench.tests import tiny

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12345
OPEN = R.generator("open_loop")
CLOSED = R.generator("closed_loop")
TRAIN = R.generator("train")


# -- generators ---------------------------------------------------------------

def test_open_loop_is_deterministic_and_matches_its_parameters():
    mix = json.loads((PERFBENCH / "traffic" / "docqa.json").read_text())
    a = OPEN.schedule(mix, 151936, SEED, 50.0, 0)
    b = OPEN.schedule(mix, 151936, SEED, 50.0, 0)
    c = OPEN.schedule(mix, 151936, SEED + 1, 50.0, 0)
    assert [x.prompt.tolist() for x in a] == [x.prompt.tolist() for x in b]
    assert [x.due_s for x in a] == [x.due_s for x in b]
    assert len(a) == round(mix["rate_per_s"] * 50.0)
    assert all(0 <= x.due_s < 50.0 and x.measured for x in a)
    assert sorted(x.max_new_tokens for x in a) == \
        sorted(x.max_new_tokens for x in c)      # same sizes, other order
    assert [x.max_new_tokens for x in a] != [x.max_new_tokens for x in c]
    docs, qs = mix["document_tokens"], mix["question_tokens"]
    for x in a:
        assert docs["low"] + qs["low"] <= len(x.prompt) <= mix["max_prompt"]
        assert mix["answer_tokens"]["low"] <= x.max_new_tokens \
            <= mix["answer_tokens"]["high"]
    # each document is asked asks_per_document times
    heads = {}
    for x in a:
        heads.setdefault(tuple(x.prompt[:64].tolist()), []).append(x)
    assert max(len(v) for v in heads.values()) == mix["asks_per_document"]
    later = OPEN.schedule(mix, 151936, SEED, 50.0, 1)
    assert all(50.0 <= x.due_s < 100.0 and not x.measured for x in later)
    # each of the window's segments holds its share of the work
    k = mix["segments"]
    run = [[] for _ in range(k)]
    for x in a:
        run[min(int(x.due_s // (50.0 / k)), k - 1)].append(x)
    work = [sum(len(x.prompt) ** 2 for x in r) for r in run]
    assert max(work) < 1.5 * min(work)
    assert max(len(r) for r in run) - min(len(r) for r in run) <= 2


def test_dealt_gives_each_run_one_of_every_sorted_group():
    rng = np.random.default_rng(0)
    vals = np.arange(20)
    out = gen.dealt(vals, 4, rng)
    assert sorted(out.tolist()) == list(range(20))
    for run in np.array_split(out, 4):
        assert sorted(v // 4 for v in run) == list(range(5))


def test_sessions_share_the_system_prompt_and_keep_the_context():
    mix = json.loads((PERFBENCH / "traffic" / "chat.json").read_text())
    s = CLOSED.Sessions(mix, 152064, SEED)
    t = CLOSED.Sessions(mix, 152064, SEED)
    sys_len = mix["system_tokens"]
    for c in range(mix["clients"]):
        for _ in range(6):
            x, y = s.next_turn(c), t.next_turn(c)
            assert x.prompt.tolist() == y.prompt.tolist()
            assert x.prompt[:sys_len].tolist() == s.system.tolist()
            assert len(x.prompt) + x.max_new_tokens <= mix["max_context"]
            assert len(x.prompt) <= mix["max_prompt"]
            served = list(range(x.max_new_tokens))
            s.answered(c, served)
            t.answered(c, served)
    depths = sorted(len(h) for h in CLOSED.Sessions(mix, 152064, SEED).history)
    assert depths[0] == sys_len and depths[-1] > mix["max_context"] // 2


def test_chat_rounds_get_the_same_work_on_every_seed_in_any_order():
    """The k-th turns of all clients hold the same sizes on every seed,
    and one seed sends the same turns whatever order the clients come
    in."""
    mix = json.loads((PERFBENCH / "traffic" / "chat.json").read_text())
    n = mix["clients"]
    a = CLOSED.Sessions(mix, 152064, SEED)
    b = CLOSED.Sessions(mix, 152064, SEED + 1)
    for k in range(4):
        sa = [a.sizes(c, k) for c in range(n)]
        sb = [b.sizes(c, k) for c in range(n)]
        assert sa != sb
        for i, key in ((0, "user_tokens"), (1, "answer_tokens")):
            got = sorted(x[i] for x in sa)
            assert got == sorted(x[i] for x in sb)
            assert mix[key]["low"] <= got[0] <= got[-1] <= mix[key]["high"]
    assert sorted(len(h) for h in a.history) == \
        sorted(len(h) for h in b.history)

    def play(order):
        s, out = CLOSED.Sessions(mix, 152064, SEED), {}
        for t in range(3):
            for c in order:
                x = s.next_turn(c)
                out[c, t] = (x.prompt.tolist(), x.max_new_tokens)
                s.answered(c, [7] * x.max_new_tokens)
        return out

    assert play(range(n)) == play(list(reversed(range(n))))


def test_zipf_batches_differ_by_step_and_follow_the_pipeline_rule():
    mix = json.loads((PERFBENCH / "traffic" / "qat.json").read_text())
    a = TRAIN.batch(mix, 151936, SEED, 1)
    b = TRAIN.batch(mix, 151936, SEED, 2)
    assert a["tokens"].shape == (mix["rows"], mix["seq_len"])
    assert (a["tokens"][:, 0] == 1).all()
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert np.array_equal(a["tokens"],
                          TRAIN.batch(mix, 151936, SEED, 1)["tokens"])
    body = a["tokens"][:, 1:][a["loss_mask"][:, 1:]]
    assert body.min() >= 2 and body.max() < 151936
    assert (a["tokens"][~a["loss_mask"]] == 0).all()


# -- statistics ---------------------------------------------------------------

def test_percentiles_over_all_samples_with_missing_ones():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 90) == 5.0
    # 10 missing of 100: p90 is the 90th sample, p95 is missing
    ys = list(range(1, 91)) + [None] * 10
    assert stats.percentile(ys, 90) == 90
    assert stats.percentile(ys, 95) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_window_rate_counts_only_the_window_and_a_stall_reads_zero():
    stamps = [0.5, 1.0, 1.5, 2.0, 9.0]
    assert stats.window_rate(stamps, 1.0, 3.0) == 3 / 2.0
    assert stats.window_rate(stamps, 3.0, 8.0) == 0.0      # stalled
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


# -- bounds and work ----------------------------------------------------------

def test_matmul_bound_by_hand():
    # M 1: bytes bound; M 8192: operations bound
    m, k, n = 1, 1536, 8960
    nbytes = m * k + k * n + 4 * m + 4 * n + 4 * m * n
    assert peaks.matmul_bound_s(m, k, n) == nbytes / 3.35e12
    m = 8192
    assert peaks.matmul_bound_s(m, k, n) == 2 * m * k * n / 1979e12


def test_attention_bound_by_hand():
    lens = [0, 99, 4095]
    got = peaks.attention_bound_s(lens, 12, 2, 128, 16, 256)
    tokens = 1 + 100 + 4096
    nbytes = (2 * tokens * 2 * 128 * 2 + 2 * 3 * 12 * 128 * 2
              + 4 * 3 * 256 + 4 * 3)
    assert got == max(nbytes / 3.35e12, 4 * tokens * 12 * 128 / 989e12)


def test_work_counts_by_hand():
    c = json.loads((PERFBENCH / "configs" / "qwen2-1.5b.json").read_text())
    w = Qwen2Work(c["model"])
    d, ff = 1536, 8960
    per_layer = d * d * 2 + 2 * d * 256 + 3 * d * ff
    assert w.layer_params == per_layer
    assert w.V == 152064 and w.tied
    lens = [1000, 24]
    int8 = 2 * per_layer * 28 * 1024
    bf16 = sum(4 * 12 * 128 * 28 * s * (s + 1) / 2 for s in lens)
    bf16 += 2 * d * 152064 * 2
    assert w.prefill_least_s(lens) == pytest.approx(
        int8 / 1979e12 + bf16 / 989e12)
    dec = w.decode_least_s([10, 20])
    assert dec == pytest.approx(
        2 * per_layer * 28 * 2 / 1979e12
        + (4 * 12 * 128 * 28 * 32 + 2 * d * 152064 * 2) / 989e12)
    assert len(w.k1_calls(32, 32)) == 7 * 28        # tied: no K1 head
    c7 = json.loads((PERFBENCH / "configs" / "qwen2-7b.json").read_text())
    w7 = Qwen2Work(c7["model"])
    assert w7.k1_calls(32, 32)[-1] == (32, 3584, 152064)
    tokens = 8 * 1024
    assert w.train_least_s(8, 1024) == pytest.approx(
        (6 * (per_layer * 28 + d * 152064) * tokens
         + 3 * 8 * 4 * 12 * 128 * 28 * 1024 * 1025 / 2) / 989e12)


def test_int8_work_equals_the_programs_op_counter():
    """The benchmark's K1 count for a prefill equals the integer products
    the program's own counter (``launch/op_analysis.py``) sees."""
    import torch
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import api
    from perfbench.core.program import arch_config
    from perfbench.core.weights import make_flat, nest
    from repro_torch.models.layers import quantize_dense_params
    cfg = tiny.config(tied=False)
    arch = arch_config(cfg)
    params = quantize_dense_params(nest(make_flat(cfg["model"], 1, "cpu")))
    toks = torch.randint(0, 500, (2, 24))
    with OpAnalysis() as oa, torch.no_grad():
        api.prefill(params, arch, {"tokens": toks}, 32)
    w = Qwen2Work(cfg["model"])
    want = sum(2 * m * k * n for m, k, n in w.k1_calls(2 * 24, 2))
    assert sum(oa.dot_flops_int.values()) == want


# -- discovery ----------------------------------------------------------------

def test_every_metric_has_a_reader_that_declares_it():
    b = tiny.bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        mod = R.reader(m["name"])
        suffix = m["name"].split(".", 1)[1] if "." in m["name"] else ""
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        if m in b["per_layer"]:
            assert mod.LAYER == m["layer"]
            assert mod.MOVES[suffix] == m["moves"] and m["moves"] in e2e
    for w in b["workloads"]:
        assert R.traffic_file(w["traffic"])["kind"]
        assert R.limits_file(w["name"])
        assert R.config_file(b, w["config"])["name"] == w["config"]
        reported = {m["name"] for m in R.cell_metrics(b, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert R.cell_metrics(b, w["name"], True)


def test_a_metric_added_as_a_file_is_found(tmp_path, monkeypatch):
    root = tmp_path / "perfbench"
    shutil.copytree(PERFBENCH / "metrics", root / "metrics")
    (root / "metrics" / "queue_wait_ms.py").write_text(
        "LAYER = 'Scheduler'\nUNIT = 'ms'\nSOURCE = 'program_span'\n"
        "MOVES = {'ttft': 'ttft_p50_ms'}\n\n"
        "def read(run, name):\n    return 1.5\n")
    (root / "traffic").mkdir()
    (root / "traffic" / "bursty.json").write_text('{"kind": "open_loop"}')
    monkeypatch.setattr(R, "PERFBENCH", root)
    assert R.reader("queue_wait_ms.ttft").read(None, "x") == 1.5
    assert R.traffic_file("bursty") == {"kind": "open_loop"}
    bench = {"end_to_end": [{"name": "ttft_p50_ms", "unit": "ms"}],
             "per_layer": [{"name": "queue_wait_ms.ttft", "unit": "ms",
                            "moves": "ttft_p50_ms"}]}
    assert R.read_metrics(bench, R.RunData(
        cell="c", kind="serve", config={}, mix={}, work=None, t0=0.0,
        t1=1.0, setup_s=1.0), trace=True) == {
            "queue_wait_ms.ttft": {"value": 1.5, "unit": "ms"}}


def test_a_traffic_kind_added_as_a_file_is_found(tmp_path, monkeypatch):
    root = tmp_path / "perfbench"
    (root / "traffic").mkdir(parents=True)
    (root / "traffic" / "on_off.py").write_text(
        "HARNESS = 'serve_open'\n\n"
        "def schedule(mix, vocab, seed, seconds, block):\n    return []\n")
    (root / "traffic" / "bursty.json").write_text('{"kind": "on_off"}')
    monkeypatch.setattr(R, "PERFBENCH", root)
    gen_mod = R.generator(R.traffic_file("bursty")["kind"])
    assert gen_mod.HARNESS == "serve_open"
    assert gen_mod.schedule({}, 10, 1, 1.0, 0) == []
    with pytest.raises(KeyError):
        R.generator("absent")


def test_every_traffic_kind_declares_its_harness():
    for path in sorted((PERFBENCH / "traffic").glob("*.json")):
        mod = R.generator(json.loads(path.read_text())["kind"])
        assert mod.HARNESS in ("serve_open", "serve_closed", "train")


# -- what the benchmark imports -----------------------------------------------

def _top_level_imports(path: pathlib.Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(PERFBENCH).as_posix() for p in PERFBENCH.rglob("*.py")))
def test_no_module_loads_jax_or_the_jax_package(path):
    names = _top_level_imports(PERFBENCH / path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if path.startswith("reference/"):
        assert "repro_torch" not in names


def test_idle_gaps_are_named_by_the_innermost_span():
    from perfbench.core.trace import _in_spans
    gaps = [(5, 10, 15), (4, 30, 34), (2, 100, 102), (3, 21, 24)]
    spans = [(0, 50, "serve"), (8, 20, "decode"), (20, 26, "commit")]
    named, outside = _in_spans(gaps, spans)
    assert named == {"in decode": 5, "in commit": 3, "in serve": 4}
    assert outside == [(2, 100, 102)]

"""Stand up the async front door of the PyTorch port and talk to it over
real TCP.

Starts N engine replicas (shared weights, one engine each, on the GPU by
default) behind the prefix-affinity router and the stdlib asyncio HTTP/SSE
server, then drives it with the blocking client: a health check, a couple
of streaming generations with a shared system prompt (watch the prefix
cache), one request that disconnects mid-stream (watch the cancellation
lifecycle reclaim its blocks), and a final stats dump.

    PYTHONPATH=src python examples_torch/frontdoor_server.py
    PYTHONPATH=src python examples_torch/frontdoor_server.py --replicas 2 \\
        --chunk 16 --policy affinity
    PYTHONPATH=src python examples_torch/frontdoor_server.py --serve-only \\
        --port 8080          # leave it running; curl it from elsewhere
    PYTHONPATH=src python examples_torch/frontdoor_server.py --device cpu

While running with ``--serve-only`` you can hit it by hand:

    curl -s localhost:8080/healthz
    curl -s localhost:8080/v1/stats
    curl -s -X POST localhost:8080/v1/generate \\
        -d '{"prompt": [1,2,3,4], "max_new_tokens": 8}'
    curl -sN -X POST localhost:8080/v1/generate \\
        -d '{"prompt": [1,2,3,4], "max_new_tokens": 8, "stream": true}'

The flags and report are those of ``examples/frontdoor_server.py``.  The
weights come from ``api.init`` with a ``torch.Generator`` seeded 0 and the
prompts from ``numpy.random.default_rng(0)``.  Without CUDA the default
``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch
from repro_torch.models import api
from repro_torch.serving import (FrontDoor, FrontDoorClient, Replica,
                                 SchedulerConfig, ServeConfig, ServingEngine,
                                 SLOClass)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--tokens", type=int, default=8)
    p.add_argument("--chunk", type=int, default=16,
                   help="chunked-prefill bound (tokens per sync)")
    p.add_argument("--policy", default="affinity",
                   choices=("affinity", "least_loaded", "round_robin",
                            "random"))
    p.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port")
    p.add_argument("--serve-only", action="store_true",
                   help="start and block until Ctrl-C instead of driving "
                        "demo traffic")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without it)")
    return p


def build_door(args) -> FrontDoor:
    device = resolve_device(args.device)
    cfg = get_arch("qwen2-1.5b").reduced().replace(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256, head_dim=16)
    params = api.init(cfg, generator=torch.Generator(device=device)
                      .manual_seed(0), device=device)

    sched = SchedulerConfig(
        lead_window=2, policy="slo",
        slo_classes={
            "interactive": SLOClass("interactive", priority=10,
                                    ttft_target_s=0.5, itl_target_s=0.2),
            "default": SLOClass("default", priority=0)})
    replicas = []
    for i in range(args.replicas):
        # one engine per replica (cancellation state is per engine);
        # params are shared, only the KV pools are private
        engine = ServingEngine(cfg, params, ServeConfig(
            max_new_tokens=args.tokens, temperature=0.0,
            cache_backend="paged", block_size=4,
            prefill_chunk=args.chunk), device=device)
        replicas.append(Replica(engine, name=f"r{i}", n_slots=2,
                                cache_T=128, num_blocks=256,
                                sched_cfg=sched))
    return FrontDoor(replicas, policy=args.policy, port=args.port)


def drive(fd: FrontDoor) -> dict:
    """The demo traffic; returns what the client saw."""
    client = FrontDoorClient("127.0.0.1", fd.port)
    print(f"listening on :{fd.port}  healthz={client.healthz()}")
    seen = {"streams": []}

    rng = np.random.default_rng(0)
    system = rng.integers(2, 200, size=16).tolist()   # shared tenant prefix

    def prompt():
        return system + rng.integers(2, 200, size=4).tolist()

    for i in range(3):
        out = client.generate(prompt(), max_new_tokens=8, stream=True,
                              slo_class="interactive")
        seen["streams"].append(out)
        print(f"stream {i} via {out['replica']}: {out['tokens']} "
              f"({out['finish_reason']})")

    # hang up after 2 tokens: the server cancels into the engine and the
    # next sweep frees the slot and its blocks
    out = client.generate(prompt(), max_new_tokens=8, disconnect_after=2)
    seen["disconnected"] = out
    print(f"disconnected after {len(out['tokens'])} tokens "
          f"(request {out['request_id']} on {out['replica']})")

    deadline = time.time() + 30
    while time.time() < deadline:
        stats = client.stats()
        if all(r["queue_depth"] == 0 for r in stats["replicas"]):
            break
        time.sleep(0.05)
    seen["stats"] = client.stats()
    for r in seen["stats"]["replicas"]:
        print(f"  {r['name']}: prefix_hit_blocks={r.get('prefix_hit_blocks')}"
              f" blocks_in_use={r.get('blocks_in_use')}"
              f" cost_hint={r['cost_hint_cycles_per_token']:.3f}")
    return seen


def main(argv=None):
    args = build_parser().parse_args(argv)
    fd = build_door(args).start()
    seen = None
    try:
        if args.serve_only:
            print(f"front door listening on :{fd.port} (Ctrl-C to stop)")
            while True:
                time.sleep(1)
        else:
            seen = drive(fd)
    except KeyboardInterrupt:
        pass
    finally:
        reports = fd.stop()
        for name, rep in sorted(reports.items()):
            print(f"{name}: requests={len(rep.results)} steps={rep.steps} "
                  f"cancelled={rep.n_cancelled} "
                  f"chunk_tokens={rep.chunk_tokens}")
    return seen, reports


if __name__ == "__main__":
    main()

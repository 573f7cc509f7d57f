"""Mesh serving in the PyTorch port: greedy ``serve()`` through a
``MeshExecutor`` over meshes of ``cpu`` shards (one controller, every shard
on one device, as on the card) against the port's single-device serve and
the JAX engine's, on the workload of ``test_sharded_serving.py`` (the tiny
qwen2, four requests, two slots, block size 4).

The table width is 8 blocks (``cache_T`` 32), which 2, 4 and 8 divide, so
every paged decode on a mesh with a "model" axis runs the split-KV path
(K2s's plain version per shard and the state merge), and every quantized
matmul the sharded one.  The reference runs jitted in one subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (``torch_parity.py``);
its own mesh serves need a multi-device JAX, which this suite does not
start, so the port's mesh streams are held against its single-device
streams, which the streams of any mesh must equal.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro_torch import serving
from repro_torch.configs.base import get_arch
from repro_torch.kernels.bitparticle_matmul import ops as bp_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import api
from repro_torch.models.layers import quantize_dense_params

MAX_NEW = [8, 3, 6, 8]
CACHE_T = 32
CONFIGS = {"exact": ("bp_exact", False), "approx-int8kv": ("bp_approx", True)}
RUNS = [("exact", "slab"), ("exact", "paged"), ("approx-int8kv", "paged")]
MESHES = [(2, 4), (1, 8), (8, 1)]


def _cfg(get_arch_fn, mode, int8kv, arch="qwen2-1.5b"):
    return get_arch_fn(arch).reduced().replace(
        **tp.SMALL, matmul_mode=mode, kv_cache_int8=int8kv)


def _requests(serving_mod):
    prompts = tp.tokens(1, (4, 6))
    return [serving_mod.Request(prompt=prompts[i], max_new_tokens=MAX_NEW[i],
                                arrival_time=float(i)) for i in range(4)]


def _loop(serving_mod, engine):
    return engine.make_loop(_requests(serving_mod), n_slots=2,
                            cache_T=CACHE_T,
                            sched_cfg=serving_mod.SchedulerConfig(
                                lead_window=2))


def write_reference(out_dir: str) -> None:
    """Run the single-device serves through the JAX engine (called in the
    subprocess)."""
    import jax
    from repro import serving as jserving
    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import api as japi

    # float weights on both sides: each engine quantizes them itself
    params = japi.init(jax.random.PRNGKey(0),
                       _cfg(jax_get_arch, "bp_exact", False))
    out = {}
    for name, backend in RUNS:
        mode, int8kv = CONFIGS[name]
        eng = jserving.ServingEngine(
            _cfg(jax_get_arch, mode, int8kv), params, jserving.ServeConfig(
                max_new_tokens=8, temperature=0.0, cache_backend=backend,
                block_size=4))
        out[f"{name}-{backend}"] = tp.summary(
            _loop(jserving, eng).run(), ["mesh_shape"])
    tp.save_reference(out_dir, out, params)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference("test_torch_mesh_serving",
                            tmp_path_factory.mktemp("jax_mesh_reference"))


def _mesh(shape):
    return make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _engine(params, cfg, backend, mesh=None, **scfg):
    sc = serving.ServeConfig(max_new_tokens=8, temperature=0.0,
                             cache_backend=backend, block_size=4,
                             mesh_shape=(None if mesh is None
                                         else tuple(mesh.devices.shape)),
                             **scfg)
    draft = ({} if scfg.get("draft") != "model"
             else dict(draft_cfg=cfg, draft_params=params))
    if mesh is None:
        return serving.ServingEngine(cfg, params, sc, device="cpu", **draft)
    with torch.no_grad():
        qp = quantize_dense_params(params)
    return serving.ServingEngine(
        cfg, qp, sc, executor=serving.make_executor(cfg, qp, mesh=mesh),
        **draft)


def _tokens(report):
    """The streams in submission order (request ids count on across
    serves)."""
    return [np.asarray(r.tokens).tolist()
            for r in sorted(report.results, key=lambda r: r.request_id)]


def _ref_tokens(reference, key):
    toks = reference[key]["tokens"]
    return [toks[k] for k in sorted(toks, key=int)]


@pytest.fixture(scope="module")
def singles(reference):
    """The port's single-device streams, each equal to the reference's."""
    out = {}
    for name, backend in RUNS:
        key = f"{name}-{backend}"
        report = _loop(serving, _engine(reference["params"],
                                        _cfg(get_arch, *CONFIGS[name]),
                                        backend)).run()
        assert report.mesh_shape is None
        assert _tokens(report) == _ref_tokens(reference, key), key
        out[key] = _tokens(report)
    return out


@pytest.fixture
def spies(monkeypatch):
    """Counts the sharded matmul's calls and K2s's (state) calls."""
    counts = {"bp_matmul_sharded": 0, "paged_attention_state": 0}
    for mod, name in ((bp_ops, "bp_matmul_sharded"),
                      (pa_ops, "paged_attention_state")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return counts


def _serve_on_mesh(params, cfg, backend, shape, **scfg):
    engine = _engine(params, cfg, backend, _mesh(shape), **scfg)
    assert isinstance(engine.executor, serving.MeshExecutor)
    loop = _loop(serving, engine)
    report = loop.run()
    assert report.mesh_shape == shape
    run = next(r for r in loop.stream if r["kind"] == "run")
    assert run["mesh_shape"] == list(shape)
    return engine, report


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("backend", ["slab", "paged"])
def test_mesh_serve_token_identity(backend, shape, reference, singles,
                                   spies):
    _, report = _serve_on_mesh(reference["params"],
                               _cfg(get_arch, "bp_exact", False), backend,
                               shape)
    key = f"exact-{backend}"
    assert _tokens(report) == singles[key] == _ref_tokens(reference, key)
    assert spies["bp_matmul_sharded"] > 0
    split_kv = backend == "paged" and shape[1] > 1
    assert (spies["paged_attention_state"] > 0) == split_kv


def test_mesh_serve_approx_int8kv(reference, singles, spies):
    # int8 KV scale pages take the plain gather, unsharded
    _, report = _serve_on_mesh(reference["params"],
                               _cfg(get_arch, "bp_approx", True), "paged",
                               (2, 4))
    key = "approx-int8kv-paged"
    assert _tokens(report) == singles[key] == _ref_tokens(reference, key)
    assert spies["bp_matmul_sharded"] > 0
    assert spies["paged_attention_state"] == 0


def test_mesh_model_drafter(reference, singles):
    engine, report = _serve_on_mesh(
        reference["params"], _cfg(get_arch, "bp_exact", False), "slab",
        (2, 4), draft="model", num_draft_tokens=3)
    assert isinstance(engine.draft_executor, serving.MeshExecutor)
    assert engine.draft_executor.mesh is engine.executor.mesh
    assert report.acceptance_rate > 0.0
    # speculation never changes a greedy stream
    assert _tokens(report) == singles["exact-slab"]


def test_mesh_moe_serve():
    cfg = _cfg(get_arch, "bp_exact", False, arch="granite-moe-1b-a400m")
    params = api.init(cfg, seed=0, device="cpu")
    want = _tokens(_loop(serving, _engine(params, cfg, "paged")).run())
    _, report = _serve_on_mesh(params, cfg, "paged", (1, 2))
    assert _tokens(report) == want


@pytest.mark.parametrize("devices", [["cuda:0", "cuda:1"], ["cpu", "cuda:0"]])
def test_mesh_over_distinct_devices_is_refused(devices):
    with pytest.raises(NotImplementedError, match="distinct devices"):
        make_local_mesh(1, 2, devices=devices)


def test_mesh_shape_without_devices_needs_cuda_devices():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = _cfg(get_arch, "bp_exact", False)
    params = api.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 2 CUDA devices, found 0"):
        serving.ServingEngine(cfg, params,
                              serving.ServeConfig(mesh_shape=(1, 2)),
                              device="cpu")


@pytest.mark.parametrize("feature", ["probe", "faults"])
def test_mesh_probe_and_fault_ladder_match_single_device(feature,
                                                         reference):
    """The sparsity probe and the recovery ladder (four step faults
    without retries: three recoveries, the kernel rung, then a failed
    serve's requests) work on the mesh executor as on one device."""
    def scfg():
        if feature == "probe":
            return dict(probe=serving.SparsityProbe(probe_every=1,
                                                    n_mc=2000))
        return dict(faults=serving.FaultInjector(
            schedule=[("step", i) for i in range(4)]),
            kernel_fault_limit=1, max_step_retries=0)

    cfg = _cfg(get_arch, "bp_exact", False)
    params = reference["params"]
    single = _loop(serving, _engine(params, cfg, "paged", **scfg())).run()
    _, meshed = _serve_on_mesh(params, cfg, "paged", (2, 2), **scfg())
    assert _tokens(meshed) == _tokens(single)
    assert ([r.finish_reason for r in meshed.results]
            == [r.finish_reason for r in single.results])
    if feature == "probe":
        assert meshed.hw_measured == single.hw_measured
    else:
        assert (meshed.n_recoveries, meshed.n_degrades) == (
            single.n_recoveries, single.n_degrades) == (3, 1)

"""The PyTorch port's examples (``examples_torch/``) against the JAX
package, on the CPU.

  * ``quickstart``: the particlized-MAC figures of section 1 equal the
    reference's on several operand pairs, Table III's normalized rows
    equal, and ``main`` runs with ``--device cpu`` (the kernel wrapper with
    ``backend="auto"`` runs the plain version on CPU tensors).
  * ``estimate_deployment``: on the reference's weights and activations
    and the reference's pairing order, every row's int8 weight equals the
    reference's bit for bit, its bit and value sparsity equal the exact
    counts of the reference's int8 operands (the reference's own float32
    means sit within 2e-6 of them: float32 sums of up to 131,072 terms),
    and its cycles per MAC (exact and approximate) lie within 1e-6
    relative of the reference's; its ``main`` runs on the CPU for a causal
    LM and for the audio family.
  * ``train_lm``: ``--steps 4 --compress-grads`` resumes to step 6 from its
    checkpoint with finite losses; the fleet estimate's ``SimResult``s equal
    the reference's ``cluster_utilization`` exactly.
  * ``frontdoor_server``: one replica's drive completes on the CPU.
"""

import dataclasses
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import bitparticle as jbp
from repro.core import cost_model as jcm
from repro.core import quant as jquant
from repro.core import sparsity as jsparsity
from repro.distributed import quasi_sync as jqs
from repro.models import api as japi
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as cm

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples_torch"))
import estimate_deployment  # noqa: E402
import frontdoor_server  # noqa: E402
import quickstart  # noqa: E402
import train_lm  # noqa: E402


@pytest.mark.parametrize("a,w", [(-93, 57), (127, -127), (0, 45), (3, 1),
                                 (-64, -86)])
def test_quickstart_particle_figures_equal_reference(a, w):
    prod, pps, cycles = jbp.assemble_partial_products(a, w)
    want = {"particles": np.asarray(jbp.particlize(abs(a))).tolist(),
            "ir_matrix": np.asarray(jbp.ir_matrix(abs(a), abs(w))).tolist(),
            "partial_products": pps, "product": int(prod),
            "cycles": int(cycles),
            "model_cycles": int(jbp.mac_cycles(a, w)),
            "approx_product": int(jbp.multiply_approx(a, w))}
    assert quickstart.particle_figures(a, w) == want


def test_quickstart_runs_on_cpu(capsys):
    assert cm.table3("paper") == jcm.table3("paper")
    out = quickstart.main(["--device", "cpu"])
    assert out["kernel_equal"]
    assert "plain version == plain reference: True" in capsys.readouterr().out


def _exact_rates(q):
    """(bit, value) sparsity of an int8 array from numpy integer counts."""
    mag = np.abs(np.asarray(q).astype(np.int64)).reshape(-1)
    ones = np.array([bin(m).count("1") for m in range(256)])[mag]
    return (7 * mag.size - int(ones.sum())) / (7 * mag.size), \
        int((mag == 0).sum()) / mag.size


def test_estimate_rows_equal_reference():
    from repro_torch.core import quant
    cfg_j = jax_get_arch("qwen2-1.5b").reduced()
    params = japi.init(jax.random.PRNGKey(0), cfg_j)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 128), 0,
                                cfg_j.vocab_size)
    acts, _, _ = japi.module_for(cfg_j).forward(params, cfg_j,
                                                {"tokens": tokens})
    a_q, _ = jquant.quantize_per_tensor(jnp.asarray(acts, jnp.float32))
    _, vs_exact = _exact_rates(a_q)
    assert abs(float(jsparsity.value_sparsity(a_q)) - vs_exact) < 2e-6
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    port_params = params_from_numpy(tree, device="cpu")
    # jitted: one compile per weight shape instead of one per eager op
    ref_quant = jax.jit(lambda x: jquant.quantize_per_tensor(
        x.astype(jnp.float32))[0])
    ref_bs = jax.jit(jsparsity.bit_sparsity_sign_magnitude)
    want = []
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if leaf.ndim < 2 or not name.endswith("w"):
            continue
        w_q = ref_quant(leaf)
        got_q, _ = quant.quantize_per_tensor(
            torch.from_numpy(np.asarray(leaf, np.float32)))
        assert np.array_equal(got_q.numpy(), np.asarray(w_q)), name
        bs_exact, _ = _exact_rates(w_q)
        assert abs(float(ref_bs(w_q)) - bs_exact) < 2e-6
        want.append((name, bs_exact, jcm.avg_cycles_for_tensors(w_q, a_q),
                     jcm.avg_cycles_for_tensors(w_q, a_q, approx=True)))
    # the reference pairs the activations in the order of its permutation
    pairs = jax.random.permutation(jax.random.PRNGKey(0),
                                   jnp.asarray(a_q, jnp.int32).reshape(-1))
    rows = estimate_deployment.price_layers(
        port_params, torch.from_numpy(np.array(a_q)),
        pairs=torch.from_numpy(np.array(pairs)))
    assert [r["name"] for r in rows] == [w[0] for w in want]
    for r, (_, bs, cyc, cyc_a) in zip(rows, want):
        assert r["bit_sparsity"] == bs
        assert r["value_sparsity"] == vs_exact
        assert math.isclose(r["cycles"], cyc, rel_tol=1e-6)
        assert math.isclose(r["cycles_approx"], cyc_a, rel_tol=1e-6)
        assert r["mac_energy_pj"] == jcm.mac_energy_pj("bp_exact", bs)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-medium"])
def test_estimate_main_runs_on_cpu(arch, capsys):
    """The synthetic estimate end to end: a causal LM's hidden states, and
    the audio family's encoder output on seeded frames."""
    assert estimate_deployment.main(["--arch", arch, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mean weight bit sparsity" in out and "bp_approx" in out


def test_train_lm_resumes_and_fleet_estimate_equals_reference(tmp_path,
                                                              capsys):
    ck = str(tmp_path / "ck")
    common = ["--compress-grads", "--device", "cpu", "--ckpt-dir", ck]
    end, hist = train_lm.main(["--steps", "4", "--fresh", *common])
    assert end == 4 and [s for s, _ in hist] == [1, 2, 3, 4]
    end, hist2 = train_lm.main(["--steps", "6", *common])
    assert end == 6 and [s for s, _ in hist2] == [5, 6]
    assert all(math.isfinite(l) for _, l in hist + hist2)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out
    for got, cfg in zip(train_lm.fleet_estimate(),
                        (jqs.ClusterConfig(E=0, Q=0),
                         jqs.ClusterConfig(E=3, Q=2))):
        want = jqs.cluster_utilization(cfg, n_rounds=100)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_frontdoor_drive_completes_on_cpu():
    seen, reports = frontdoor_server.main(["--replicas", "1",
                                           "--device", "cpu"])
    assert [s["finish_reason"] for s in seen["streams"]] == ["length"] * 3
    assert all(len(s["tokens"]) == 8 for s in seen["streams"])
    assert len(seen["disconnected"]["tokens"]) == 2
    rep = reports["r0"]
    assert len(rep.results) == 4 and rep.n_cancelled == 1
    assert seen["stats"]["replicas"][0]["blocks_in_use"] == 0

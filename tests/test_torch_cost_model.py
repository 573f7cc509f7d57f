"""The paper's cost models in the PyTorch port (``repro_torch.core``:
``cost_model``, ``array_sim``, ``dataflow``) against the JAX package's.

  * Closed forms (Table III with the cited cycles, energy interpolation,
    SRAM energy, the efficiency metrics, the dataflow mapper and its traffic
    report) must equal the reference's.
  * The Monte-Carlo models are a seeded generator plus a deterministic
    costing core.  The cores, fed the reference's own operands (drawn by
    ``jax.random`` and passed through numpy), must give the reference's
    numbers exactly; the port's seeded end-to-end numbers must lie within 4
    standard errors of the reference's, the standard error computed from
    both samples' own variances.
  * The array simulator's schedule, run on the reference's cost tensors,
    must give the reference's result field for field, and the costing core
    on the reference's operands the reference's cost tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn_zoo as jcnn
from repro.core import array_sim as jas
from repro.core import cost_model as jcm
from repro.core import dataflow as jdf
from repro.core.sparsity import sample_with_bit_sparsity as jsample
from repro_torch.configs import cnn_zoo
from repro_torch.core import array_sim as tas
from repro_torch.core import cost_model as tcm
from repro_torch.core import dataflow as tdf

N_MC = 20_000
METHODS = ("bp_exact", "bp_approx", "bit_serial", "bitwave")


def test_cited_constants_equal_reference():
    for name in ("CLOCK_HZ", "SPARSITY_LEVELS", "PAPER_AVG_CYCLES",
                 "AREA_UM2", "POWER_UW", "DRAM_PJ_PER_BYTE",
                 "SRAM_MM2_PER_KB"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    for name, cfg in jcm.ACCEL_CONFIGS.items():
        assert dataclasses.asdict(tcm.ACCEL_CONFIGS[name]) == \
            dataclasses.asdict(cfg)


def test_table3_paper_equals_reference():
    assert tcm.table3("paper") == jcm.table3("paper")


@pytest.mark.parametrize("unit", ["adas", "bitwave", "bp_exact",
                                  "bp_approx"])
def test_mac_energy_and_efficiency_equal_reference(unit):
    for bs in np.linspace(0.3, 1.0, 15):
        assert tcm.mac_energy_pj(unit, bs) == jcm.mac_energy_pj(unit, bs)
    for c in (1.0, 1.37, 3.22):
        assert tcm.tops(c, 512) == jcm.tops(c, 512)
        assert tcm.area_efficiency(c, jcm.AREA_UM2[unit]) == \
            jcm.area_efficiency(c, jcm.AREA_UM2[unit])
        assert tcm.energy_efficiency(c, jcm.POWER_UW[unit][2]) == \
            jcm.energy_efficiency(c, jcm.POWER_UW[unit][2])
    for cap in (512, 8192, 64 << 10, 256 << 10):
        assert tcm.sram_pj_per_byte(cap) == jcm.sram_pj_per_byte(cap)


def _ref_operands(bs, seed, w_bs=None, n=N_MC):
    a, w = jcm._mc_operands(bs, n, seed, w_bit_sparsity=w_bs)
    return np.array(a), np.array(w)


MC_POINTS = [(m, bs, None) for m in METHODS for bs in (0.5, 0.8)] + [
    ("bp_exact", 0.9, 0.6), ("bp_approx", 0.35, 0.65)]


@pytest.mark.parametrize("method,bs,w_bs", MC_POINTS)
def test_cycle_core_on_reference_operands_is_exact(method, bs, w_bs):
    a, w = _ref_operands(bs, seed=1, w_bs=w_bs)
    want = jcm._avg_cycles(method, jnp.asarray(a), jnp.asarray(w), N_MC)
    assert tcm.avg_cycles(method, a, w) == want


@pytest.mark.parametrize("method,bs,w_bs", MC_POINTS)
def test_seeded_cycle_models_within_four_standard_errors(method, bs, w_bs):
    if w_bs is None:
        got = tcm.modeled_avg_cycles(method, bs, n=N_MC)
        want = jcm.modeled_avg_cycles(method, bs, n=N_MC)
    else:
        got = tcm.modeled_avg_cycles_dual(method, bs, w_bs, n=N_MC)
        want = jcm.modeled_avg_cycles_dual(method, bs, w_bs, n=N_MC)
    # the two samples' per-MAC (bitwave: per-group) costs, through the
    # port's core, which equals the reference's on the same operands
    samples = [tcm.cycle_samples(method, *tcm.mc_operands(bs, N_MC, 0, w_bs)),
               tcm.cycle_samples(method, *_ref_operands(bs, 0, w_bs))]
    se = np.sqrt(sum(float(s.var()) / s.numel() for s in samples))
    assert abs(got - want) <= 4 * se + 1e-12, (got, want, se)


def test_tensor_pricing_core_and_seeded_estimate():
    rng = np.random.default_rng(5)
    w = rng.integers(-127, 128, (64, 96)).astype(np.int8)
    a = np.where(rng.random((40, 64)) < 0.3, 0,
                 rng.integers(-127, 128, (40, 64))).astype(np.int8)
    for approx in (False, True):
        for zf in (False, True):
            want = jcm.avg_cycles_for_tensors(w, a, approx=approx,
                                              zero_filter=zf)
            flat_a = jnp.asarray(a, jnp.int32).reshape(-1)
            n = min(w.size, a.size)
            perm_a = np.array(jax.random.permutation(
                jax.random.PRNGKey(0), flat_a))[:n]
            got = tcm.pair_cycles(w.reshape(-1)[:n].astype(np.int32), perm_a,
                                  approx=approx, zero_filter=zf)
            assert got == want
            seeded = tcm.avg_cycles_for_tensors(w, a, approx=approx,
                                                zero_filter=zf)
            c = torch.as_tensor(np.asarray(jcm.bp.mac_cycles(
                jnp.asarray(w.reshape(-1)[:n], jnp.int32),
                jnp.asarray(perm_a), approx=approx)), dtype=torch.float32)
            se = float(c.std()) * np.sqrt(2.0 / n)
            assert abs(seeded - want) <= 4 * se


# --- array simulator ------------------------------------------------------

SIM_CONFIGS = {
    "default": jas.ArrayConfig(),
    "strict": jas.ArrayConfig(E=0, Q=0),
    "queued-E1": jas.ArrayConfig(rows=8, cols=16, E=1, Q=1),
    "probe": jas.ArrayConfig(rows=8, cols=16, E=3, Q=2, zero_filter=True),
    "approx": jas.ArrayConfig(rows=4, cols=8, E=2, Q=3, approx=True),
}


def _tcfg(cfg):
    return tas.ArrayConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(SIM_CONFIGS))
def test_simulate_on_reference_costs_equals_reference(name):
    cfg = SIM_CONFIGS[name]
    costs = jas.build_op_costs(jax.random.PRNGKey(3), cfg, 24, 0.7,
                               w_value_sparsity=0.2, a_value_sparsity=0.3,
                               a_bit_sparsity=0.8)
    want = jas.simulate(costs, cfg)
    got = tas.simulate(np.array(costs), _tcfg(cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _tcfg(cfg).weight_buffer_depth == cfg.weight_buffer_depth


@pytest.mark.parametrize("name", list(SIM_CONFIGS))
def test_op_costs_on_reference_operands_equal_reference(name):
    cfg, key, n_steps = SIM_CONFIGS[name], jax.random.PRNGKey(4), 16
    want = jas.build_op_costs(key, cfg, n_steps, 0.6, w_value_sparsity=0.1,
                              a_value_sparsity=0.2, a_bit_sparsity=0.75)
    # the reference's operands, drawn as build_op_costs draws them
    kw, ka = jax.random.split(key)
    w = jsample(kw, (cfg.rows, n_steps), 0.6, 0.1)
    a = jsample(ka, (cfg.cols, n_steps + cfg.rows - 1), 0.75, 0.2)
    got = tas.op_costs(np.array(w), np.array(a), _tcfg(cfg))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_run_experiment_is_seeded_and_bounded():
    cfg = tas.ArrayConfig(rows=8, cols=16, E=3, Q=2, zero_filter=True)
    r1 = tas.run_experiment(0, cfg, 24, 0.6, 0.0, 0.1, 0.9)
    r2 = tas.run_experiment(0, cfg, 24, 0.6, 0.0, 0.1, 0.9)
    assert r1 == r2
    assert 0.0 < r1.pe_utilization <= 1.0
    assert r1.max_observed_divergence <= cfg.E
    assert r1.n_steps == 24 and r1.cycles >= 24
    with pytest.raises(ValueError, match="array"):
        tas.simulate(np.zeros((2, 2, 3), np.int32), cfg)


# --- dataflow mapper ------------------------------------------------------

LAYERS = [layer for net in cnn_zoo.NETWORKS.values() for layer in net()] + [
    tdf.LayerShape("fc-b64", 64, 1000, 4096, 1, 1),
    tdf.LayerShape("odd", 3, 17, 5, 7, 33, 3, 3)]


def _jlayer(layer):
    return jdf.LayerShape(**dataclasses.asdict(layer))


@pytest.mark.parametrize("name", sorted(jcnn.NETWORKS))
def test_cnn_zoo_equals_reference(name):
    """The port's layer tables, field by field, and its sparsity tables."""
    got = [dataclasses.asdict(layer) for layer in cnn_zoo.NETWORKS[name]()]
    want = [dataclasses.asdict(layer) for layer in jcnn.NETWORKS[name]()]
    assert got == want
    assert all(isinstance(layer, tdf.LayerShape)
               for layer in cnn_zoo.NETWORKS[name]())
    assert cnn_zoo.ACT_VALUE_SPARSITY[name] == jcnn.ACT_VALUE_SPARSITY[name]
    assert cnn_zoo.BIT_SPARSITY[name] == jcnn.BIT_SPARSITY[name]
    assert list(cnn_zoo.NETWORKS) == list(jcnn.NETWORKS)


@pytest.mark.parametrize("accel", ["bitparticle", "bitwave", "adas"])
def test_dataflow_mapping_and_traffic_equal_reference(accel):
    for tl in LAYERS:
        layer = _jlayer(tl)
        assert [dataclasses.asdict(m) for m in tdf.enumerate_mappings(tl)] \
            == [dataclasses.asdict(m) for m in jdf.enumerate_mappings(layer)]
        jm = jdf.choose_mapping(layer)
        tm = tdf.choose_mapping(tl)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        jt = jdf.analyze_traffic(layer, jm, accel)
        tt = tdf.analyze_traffic(tl, tm, accel)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        assert tt.cache_energy_pj(accel) == jt.cache_energy_pj(accel)
        assert tt.dram_energy_pj() == jt.dram_energy_pj()
    for name, net in cnn_zoo.NETWORKS.items():
        jrows, jutil = jdf.network_mapping_report(
            [_jlayer(layer) for layer in net()])
        trows, tutil = tdf.network_mapping_report(net())
        assert tutil == jutil, name
        assert [dataclasses.asdict(m) for _, m in trows] == \
            [dataclasses.asdict(m) for _, m in jrows]

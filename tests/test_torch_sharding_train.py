"""The sharding recipes, placement and elastic restore of the PyTorch port
(``repro_torch.distributed.sharding``, ``repro_torch.runtime.elastic``)
against the JAX package's, with meshes of ``cpu`` shards (one controller,
as on the card).

  * ``ACTIVATION_RULES`` equal to the reference's, all three recipes.
  * ``param_specs(..., "train", {"data": 4, "model": 2})`` leaf by leaf
    against the reference's on every architecture's ``reduced()`` params
    and their AdamW state; the serve recipe's specs unchanged.
  * ``logical_pspec`` on seeded random shapes and axis names, every recipe,
    on 2-D and 3-D meshes; ``shard`` returns its input and checks the axis
    count.
  * Placement: every shard holds its slice of the whole, with its own
    storage; ``gather`` gives the whole back bit for bit.
  * Elastic: a checkpoint written by the reference's ``CheckpointManager``
    restored by ``restore_for_mesh`` onto (4, 2), (2, 4) and (1, 1) meshes
    and gathered, bit-equal; ``reshard`` from one mesh to another.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.base import ARCH_IDS, get_arch as jax_get_arch
from repro.distributed import sharding as jshd
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import get_arch
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import api
from repro_torch.runtime.elastic import reshard, restore_for_mesh
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import leaf_paths

TRAIN_AXES = {"data": 4, "model": 2}


def _spec_tuple(spec):
    return tuple(spec)


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_specs(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_activation_rules_equal_reference():
    assert sharding.ACTIVATION_RULES == jshd.ACTIVATION_RULES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_param_specs_equal_reference(arch):
    jcfg = jax_get_arch(arch).reduced()
    jparams = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg))
    jstate = jax.eval_shape(jopt.init_state, jparams)
    params = api.init(get_arch(arch).reduced(), device="meta",
                      generator=torch.Generator())
    state = opt_lib.init_state(params)
    for jt, tt in ((jparams, params), (jstate, state)):
        for recipe in ("train", "decode"):
            want = dict(_flat_specs(jax.tree.map(
                _spec_tuple, jshd.param_specs(jt, recipe, TRAIN_AXES),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
            got = dict(_flat_specs(sharding.param_specs(tt, recipe,
                                                        TRAIN_AXES)))
            assert got == want, arch
    # the serving callers' default is the serve recipe
    assert sharding.param_specs(params, mesh=TRAIN_AXES) == \
        sharding.param_specs(params, "serve", TRAIN_AXES) == \
        api.param_pspecs(params, TRAIN_AXES)


NAMES = (None, "batch", "seq", "tokens_flat", "kv_seq", "experts",
         "cache_seq", "heads", "embed", "ffn")
MESHES = ({"data": 4, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"model": 4})


@pytest.mark.parametrize("recipe", sorted(jshd.ACTIVATION_RULES))
def test_logical_pspec_equals_reference(recipe):
    rng = np.random.default_rng(7)
    for _ in range(300):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 8, 12, 16, 32, 48, 512]))
                      for _ in range(nd))
        axes = tuple(NAMES[int(i)] for i in rng.integers(0, len(NAMES), nd))
        for mesh in MESHES:
            want = tuple(jshd.logical_pspec(shape, axes, recipe, mesh))
            assert sharding.logical_pspec(shape, axes, recipe, mesh) == \
                want, (shape, axes, mesh)


def test_shard_resolves_and_returns_input():
    x = torch.zeros(8, 16, 4)
    assert sharding.shard(x, "batch", "seq", None) is x
    with sharding.recipe("train"), sharding.activate_mesh(TRAIN_AXES):
        assert sharding.shard(x, "batch", "seq", None) is x
        with pytest.raises(ValueError, match="logical axes"):
            sharding.shard(x, "batch", "seq")
    with pytest.raises(ValueError, match="unknown recipe"):
        with sharding.recipe("nope"):
            pass


def _cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, "cpu")


@pytest.mark.parametrize("spec", [(None, None), ("data", None),
                                  (None, "model"), ("data", "model"),
                                  ("model", "data"), (("data", "model"), None),
                                  (("model", "data"), None)])
def test_place_slices_and_gather(spec):
    mesh = _cpu_mesh((2, 4))
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    placed = sharding.place(x, spec, mesh)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    ptrs = set()
    for (i, j), t in placed.shards.items():
        where = {"data": i, "model": j}
        want = x
        for dim, entry in enumerate(spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            pos, n = 0, 1
            for a in names:
                pos, n = pos * sizes[a] + where[a], n * sizes[a]
            want = want.narrow(dim, pos * (x.shape[dim] // n),
                               x.shape[dim] // n)
        assert torch.equal(t, want), ((i, j), spec)
        ptrs.add(t.data_ptr())
    assert len(ptrs) == mesh.size and x.data_ptr() not in ptrs
    assert torch.equal(placed.gather(), x)
    assert sum(placed.shard_nbytes().values()) == (
        x.numel() * 4 * mesh.size // int(np.prod(
            [sizes[a] for a in sharding._used_axes(tuple(spec))] or [1])))
    with pytest.raises(ValueError):
        sharding.place(torch.zeros(3, 8), ("data", None), mesh)


def _jax_state(seed=0):
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((8, 16)).astype(np.float32)
    return {
        "params": {"layers": {"w": jnp.asarray(bf, jnp.bfloat16),
                              "b": jnp.ones((16,), jnp.float32)},
                   "embed": {"table": jnp.asarray(
                       rng.standard_normal((32, 8)), jnp.float32)}},
        "step": jnp.asarray(7, jnp.int32),
    }


def _torch_like(tree):
    return jax.tree.map(
        lambda a: torch.empty(a.shape, dtype={
            jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
            jnp.int32: torch.int32}[a.dtype.type]), tree)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 1)])
def test_elastic_restore_of_reference_checkpoint(tmp_path, shape):
    jtree = _jax_state()
    JaxCkpt(str(tmp_path), async_save=False).save(5, jtree)
    like = _torch_like(jtree)
    mesh = make_local_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    placed = restore_for_mesh(CheckpointManager(str(tmp_path)), 5, like,
                              mesh, "train")
    whole = sharding.gather_tree(placed)
    for (path, got), (_, want) in zip(leaf_paths(whole),
                                      leaf_paths(jax.tree.map(np.asarray,
                                                              jtree))):
        want = np.array(want)
        want_t = (torch.from_numpy(want.view(np.int16)).view(torch.bfloat16)
                  if want.dtype.name == "bfloat16"
                  else torch.from_numpy(want))
        assert got.dtype == want_t.dtype, path
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want_t.reshape(-1).view(torch.uint8)), path
    specs = dict(_flat_specs(sharding.param_specs(like, "train", mesh)))
    for path, leaf in _flat_specs(placed):
        assert leaf.spec == specs[path]
    if shape == (4, 2):
        assert placed["params"]["layers"]["w"].spec == ("data", "model")
        assert placed["params"]["layers"]["w"].shards[(3, 1)].shape == (2, 8)
    # the live reshard onto another mesh and back, bit for bit
    other = make_local_mesh(1, 2, devices=["cpu"] * 2)
    again = sharding.gather_tree(reshard(reshard(placed, other), mesh))
    for (_, a), (_, b) in zip(leaf_paths(again), leaf_paths(whole)):
        assert torch.equal(a, b)


def test_meshes_of_any_rank():
    mesh = make_mesh((2, 3, 4), ("pod", "data", "model"), "cpu")
    assert mesh.shape == {"pod": 2, "data": 3, "model": 4}
    assert mesh.home == torch.device("cpu") and mesh.size == 24
    with pytest.raises(ValueError, match="serving paths"):
        mesh.require_serving()
    pipe = make_mesh((4,), ("model",), "cpu")
    assert pipe.shape == {"model": 4}
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("model",), "cpu")
    from repro_torch.configs.base import get_arch as get
    from repro_torch.serving.executor import MeshExecutor
    with pytest.raises(ValueError, match="serving paths"):
        MeshExecutor(get("qwen2-1.5b").reduced(), None, mesh=mesh)
    x = torch.arange(8 * 6 * 5.0).reshape(8, 6, 5)
    placed = sharding.place(x, (("pod", "model"), "data", None), mesh)
    assert placed.shards[(1, 2, 3)].shape == (1, 2, 5)
    assert torch.equal(placed.gather(), x)
    for idx in itertools.product(range(2), range(3), range(4)):
        assert placed.shards[idx].device == torch.device("cpu")

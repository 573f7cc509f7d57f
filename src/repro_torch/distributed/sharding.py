"""Logical-axis sharding recipes, parameter partition specs, placement of
state on a mesh, and the cross-shard combines (port of
``repro/distributed/sharding.py``).

A spec is a tuple with one entry per dimension: the mesh axis (or tuple of
axes) the dimension is split over, or None where it is whole (the
reference's ``PartitionSpec``).  The recipes map logical axis names onto
mesh axes, as the reference's:

  train / prefill   batch -> ("pod", "data"); sequence -> "model"; params
                    2-D: FSDP over "data" x tensor parallelism over "model".
  decode            batch -> ("pod", "data"); KV-cache sequence -> "model";
                    params over "model" (weight-stationary).
  decode_long       global batch 1: cache sequence -> ("data", "model"),
                    recurrent-state heads -> "model".

:func:`logical_pspec` and :func:`param_spec` resolve a spec against a
recipe and a mesh; the serve recipe (any name but ``"train"``) is the
default of the serving callers.  :func:`shard` resolves the spec of an
activation against the recipe and mesh made active by :func:`recipe` and
:func:`activate_mesh` and returns the activation unchanged: the port keeps
activations whole on the mesh's home device.

:func:`place` cuts a tensor by its spec into per-shard slices, each owning
its storage on its shard's device (:class:`Placed`, the counterpart of the
reference's ``device_put`` onto a ``NamedSharding``); :meth:`Placed.gather`
joins them back on the home device, bit for bit.

The reference combines shards with ``psum``/``pmax`` inside ``shard_map``.
The port's mesh has one controller (``serving/executor.py::MeshExecutor``),
which launches a kernel once per shard and combines the list of per-shard
results on the mesh's home device with :func:`combine_matmul_partials` and
:func:`combine_softmax_state`.  Each such combine, gather and scatter is
the cross-shard traffic that ``launch/op_analysis.py`` counts.
"""

from __future__ import annotations

import contextlib
import functools
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch import op_analysis

Spec = Tuple[object, ...]

#: logical activation axis -> preferred mesh axes (tried in order), by
#: recipe
ACTIVATION_RULES = {
    "train": {
        "batch": ("pod", "data"),
        "seq": ("model",),
        "tokens_flat": ("pod", "data", "model"),
        "kv_seq": (),            # gathered for attention
        "experts": ("model",),
        "cache_seq": ("model",),
        "heads": (),
        "embed": (),
        "ffn": (),
    },
    "decode": {
        "batch": ("pod", "data"),
        "seq": (),
        "tokens_flat": ("pod", "data"),
        "kv_seq": ("model",),
        "experts": ("model",),
        "cache_seq": ("model",),
        "heads": (),
        "embed": (),
        "ffn": ("model",),
    },
    "decode_long": {
        "batch": (),
        "seq": (),
        "tokens_flat": (),
        "kv_seq": ("data", "model"),
        "experts": ("model",),
        "cache_seq": ("data", "model"),
        "heads": ("model",),
        "embed": (),
        "ffn": ("model",),
    },
}

_STATE = threading.local()


@contextlib.contextmanager
def recipe(name: Optional[str]):
    """Activate an activation-sharding recipe ("train" / "decode" / ...)
    for :func:`shard`; None deactivates."""
    prev = getattr(_STATE, "recipe", None)
    if name is not None and name not in ACTIVATION_RULES:
        raise ValueError(f"unknown recipe {name!r}; expected one of "
                         f"{tuple(ACTIVATION_RULES)}")
    _STATE.recipe = name
    try:
        yield
    finally:
        _STATE.recipe = prev


@contextlib.contextmanager
def activate_mesh(mesh):
    """Make ``mesh`` (a ``launch.mesh.Mesh`` or a plain {axis: size} dict)
    the mesh :func:`shard` resolves against."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def mesh_axes_dict(mesh) -> dict:
    """{axis name: size} of a mesh (a ``launch.mesh.Mesh``) or of a plain
    {axis name: size} dict."""
    return dict(mesh) if isinstance(mesh, dict) else mesh.shape


def _resolve_spec(shape, logical_axes, rules, mesh_axes) -> Spec:
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} logical axes for shape "
                         f"{tuple(shape)}")
    spec, used = [], set()
    for dim, name in zip(shape, logical_axes):
        axes = () if name is None else tuple(
            a for a in rules.get(name, ())
            if a in mesh_axes and a not in used)
        prod = int(np.prod([mesh_axes[a] for a in axes])) if axes else 1
        if axes and dim % prod == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return tuple(spec)


def logical_pspec(shape: Sequence[int], logical_axes: Sequence,
                  recipe_name: str, mesh_axes) -> Spec:
    """Spec of one array whose dimensions carry the given logical axis
    names (None: whole), resolved against a recipe and a mesh (or {axis:
    size} dict): a mesh axis is skipped when the mesh lacks it, when an
    earlier dimension took it, or when the dimension does not divide by
    the axes' product."""
    return _resolve_spec(tuple(shape), tuple(logical_axes),
                         ACTIVATION_RULES[recipe_name],
                         mesh_axes_dict(mesh_axes))


def shard(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    the spec is resolved against the active recipe and mesh (a wrong
    number of axes raises) and ``x`` is returned unchanged, whole on the
    home device.  With no recipe or mesh active it does nothing."""
    name = getattr(_STATE, "recipe", None)
    mesh = getattr(_STATE, "mesh", None)
    if name is not None and mesh is not None:
        logical_pspec(x.shape, logical_axes, name, mesh)
    return x


# ---------------------------------------------------------------------------
# Parameter partition rules
# ---------------------------------------------------------------------------

_EXPERT_RE = re.compile(r"experts|expert_")


def _divisible(dim: int, mesh_axes: dict, axis: str) -> bool:
    return axis in mesh_axes and dim % mesh_axes[axis] == 0


def param_spec(path: str, leaf, recipe_name: str = "serve",
               mesh_axes=None) -> Spec:
    """Spec of one parameter at ``path`` ("/"-joined keys).

    train: 2-D, the last dim over "model" and the second-to-last over
    "data" (FSDP x TP).  Any other recipe (serve): the last dim over
    "model" (weight-stationary TP).  An expert tensor (..., E, d_in,
    d_out) splits E over "model" and, in train, d_in over "data".
    Scan-stacked leading layer dims and 1-D params stay whole; a dim that
    does not divide stays whole."""
    axes = mesh_axes_dict(mesh_axes or {})
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec = [None] * ndim
    if ndim < 2:
        return tuple(spec)
    train = recipe_name == "train"
    if _EXPERT_RE.search(path) and ndim >= 3:
        if _divisible(shape[-3], axes, "model"):
            spec[-3] = "model"
        if train and _divisible(shape[-2], axes, "data"):
            spec[-2] = "data"
        return tuple(spec)
    if _divisible(shape[-1], axes, "model"):
        spec[-1] = "model"
    if train and _divisible(shape[-2], axes, "data"):
        spec[-2] = "data"
    return tuple(spec)


def _tree_with_paths(fn, node, path=()):
    if isinstance(node, dict):
        return {k: _tree_with_paths(fn, v, path + (str(k),))
                for k, v in node.items()}
    return fn("/".join(path), node)


def param_specs(params, recipe_name: str = "serve", mesh=None) -> dict:
    """Spec tree matching the nested-dict ``params`` for a recipe
    (``mesh``: a mesh or a plain {axis name: size} dict)."""
    axes = mesh_axes_dict(mesh or {})
    return _tree_with_paths(
        lambda path, leaf: param_spec(path, leaf, recipe_name, axes), params)


# ---------------------------------------------------------------------------
# Placement: a tensor cut into per-shard slices on a mesh
# ---------------------------------------------------------------------------

def _spec_axes(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _shard_slices(shape, spec: Spec, mesh, idx) -> tuple:
    """The slice of each dimension that mesh index ``idx`` holds."""
    axes = mesh.shape
    where = dict(zip(mesh.axis_names, idx))
    out = []
    for dim, entry in zip(shape, spec):
        names = _spec_axes(entry)
        n, pos = 1, 0
        for a in names:               # row-major over the entry's axes
            pos = pos * axes[a] + where[a]
            n *= axes[a]
        size = dim // n
        out.append(slice(pos * size, (pos + 1) * size))
    return tuple(out)


class Placed:
    """A tensor of ``shape`` cut over ``mesh`` by ``spec``: ``shards`` maps
    every mesh index to the slice that shard holds, on its device.  A
    dimension whose entry is None is whole on every shard (replicated)."""

    def __init__(self, mesh, spec: Spec, shape, dtype, shards: dict):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = torch.Size(shape), dtype
        self.shards = shards

    @property
    def is_split(self) -> bool:
        """Does any dimension split over more than one shard?"""
        return _splits(self.spec, self.mesh)

    @property
    def nbytes(self) -> int:
        """Bytes of the whole tensor."""
        return self.shape.numel() * _itemsize(self.dtype)

    def shard_nbytes(self) -> Dict[tuple, int]:
        return {idx: t.numel() * t.element_size()
                for idx, t in self.shards.items()}

    def gather(self, label: str = "") -> torch.Tensor:
        """The whole tensor on the home device (the home shard itself when
        the spec splits nothing): the all-gather."""
        home_idx = (0,) * self.mesh.devices.ndim
        if not self.is_split:
            return self.shards[home_idx]
        out = torch.empty(self.shape, dtype=self.dtype, device=self.mesh.home)
        used = _used_axes(self.spec)
        for idx, t in self.shards.items():
            # one replica of each slice: index 0 on the axes the spec
            # does not split over
            if all(i == 0 for i, a in zip(idx, self.mesh.axis_names)
                   if a not in used):
                out[_shard_slices(self.shape, self.spec, self.mesh, idx)] = \
                    t.to(self.mesh.home)
        op_analysis.collective("all-gather", self.nbytes, label)
        return out

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, {self.mesh!r})")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _used_axes(spec: Spec) -> set:
    return {a for e in spec for a in _spec_axes(e)}


def _splits(spec: Spec, mesh) -> bool:
    return any(mesh.shape[a] > 1 for a in _used_axes(spec))


def place(x: torch.Tensor, spec: Spec, mesh, label: str = "",
          count: Optional[str] = None) -> Placed:
    """Cut ``x`` by ``spec`` into a fresh tensor per shard, on the shard's
    device.  ``count`` names the collective the cut stands for in an
    active ``op_analysis`` (``reduce-scatter`` for gradients), counted at
    the whole tensor's bytes; a spec that splits nothing counts none."""
    spec = tuple(spec)
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} for a {x.ndim}-d tensor")
    for dim, entry in zip(x.shape, spec):
        n = int(np.prod([mesh.shape[a] for a in _spec_axes(entry)] or [1]))
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} "
                             f"({n} shards)")
    shards = {}
    for idx in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[idx]
        with op_analysis.on_shard(idx):
            part = x[_shard_slices(x.shape, spec, mesh, idx)]
            t = torch.empty(part.shape, dtype=x.dtype, device=dev)
            t.copy_(part)
        shards[idx] = t
    if count is not None and _splits(spec, mesh):
        op_analysis.collective(count, x.numel() * x.element_size(), label)
    return Placed(mesh, spec, x.shape, x.dtype, shards)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Placed))


def place_tree(tree, recipe_name: str, mesh, specs=None):
    """Every tensor leaf of ``tree`` placed on ``mesh`` by the recipe's
    :func:`param_specs` (or the given spec tree)."""
    if specs is None:
        specs = param_specs(tree, recipe_name, mesh)
    if isinstance(tree, dict):
        return {k: place_tree(v, recipe_name, mesh, specs[k])
                for k, v in tree.items()}
    return place(tree, specs, mesh)


def gather_tree(tree, prefix: str = ""):
    """Every :class:`Placed` leaf gathered whole on its home device."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return tree.gather(prefix) if isinstance(tree, Placed) else tree


# ---------------------------------------------------------------------------
# Cross-shard combines
# ---------------------------------------------------------------------------

def combine_matmul_partials(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard split-K partial contractions, in their own dtype:
    int32 partials sum exactly, so a split-K matmul stays bit-identical to
    the unsplit contraction (the all-reduce)."""
    op_analysis.collective("all-reduce", _nbytes(parts[0]),
                           "combine_matmul_partials")
    return functools.reduce(torch.add, parts)


def combine_softmax_state(accs: Sequence[torch.Tensor],
                          ms: Sequence[torch.Tensor],
                          ls: Sequence[torch.Tensor], *,
                          eps: float = 1e-37) -> torch.Tensor:
    """Merge per-shard flash-decoding states into the normalized output, in
    float32.  Shard s holds ``acc_s`` (the unnormalized weighted values),
    ``m_s`` (its running max) and ``l_s`` (its denominator), m and l
    broadcastable to acc on the last dimension; a shard that saw only
    masked positions holds the neutral (acc 0, m -0.7 FLT_MAX, l 0).  The
    reference's pmax and two psums: three all-reduces.

        m_g = max_s m_s;   out = sum_s acc_s e^(m_s - m_g)
                                 / max(sum_s l_s e^(m_s - m_g), eps)
    """
    for t in (ms[0], ls[0], accs[0]):
        op_analysis.collective("all-reduce", _nbytes(t),
                               "combine_softmax_state")
    m_g = functools.reduce(torch.maximum, ms)
    corr = [torch.exp(m - m_g) for m in ms]
    l_g = functools.reduce(torch.add, [l * c for l, c in zip(ls, corr)])
    acc = functools.reduce(torch.add, [a * c for a, c in zip(accs, corr)])
    return acc / torch.clamp_min(l_g, eps)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()

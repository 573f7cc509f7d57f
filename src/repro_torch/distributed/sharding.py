"""Parameter partition specs and cross-shard combines of mesh serving
(port of ``repro/distributed/sharding.py``, its serving part).

A spec is a tuple with one entry per dimension: the mesh axis the dimension
is split over, or None where it is whole (the reference's
``PartitionSpec``).  Only the serve recipe is ported: a weight's last
dimension over ``"model"`` where it divides (weight-stationary tensor
parallelism), an expert tensor's expert dimension over ``"model"``, 1-D
parameters whole.  The decode recipe's rules for activations and caches
are the table :data:`DECODE_RULES` that :func:`logical_pspec` resolves
against.

The reference combines shards with ``psum``/``pmax`` inside ``shard_map``.
The port's mesh has one controller (``serving/executor.py::MeshExecutor``),
which launches a kernel once per shard and combines the list of per-shard
results on the mesh's home device with the plain tensor functions
:func:`combine_matmul_partials` and :func:`combine_softmax_state`.
"""

from __future__ import annotations

import functools
import re
from typing import Sequence, Tuple

import torch

Spec = Tuple[object, ...]

#: the decode recipe: logical axis -> mesh axes tried in order
DECODE_RULES = {
    "batch": ("pod", "data"),
    "seq": (),
    "tokens_flat": ("pod", "data"),
    "kv_seq": ("model",),
    "experts": ("model",),
    "cache_seq": ("model",),
    "heads": (),
    "embed": (),
    "ffn": ("model",),
}

_EXPERT_RE = re.compile(r"experts|expert_")


def mesh_axes_dict(mesh) -> dict:
    """{axis name: size} of a mesh (a ``launch.mesh.Mesh``) or of a plain
    {axis name: size} dict."""
    return dict(mesh) if isinstance(mesh, dict) else mesh.shape


def logical_pspec(shape: Sequence[int], logical_axes: Sequence,
                  mesh_axes: dict) -> Spec:
    """Spec of one array whose dimensions carry the given logical axis
    names (None: whole), resolved against :data:`DECODE_RULES`: a mesh axis
    is skipped when the mesh lacks it, when an earlier dimension took it,
    or when the dimension does not divide by the axes' product."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"{len(logical_axes)} logical axes for shape "
                         f"{tuple(shape)}")
    spec, used = [], set()
    for dim, name in zip(shape, logical_axes):
        axes = () if name is None else tuple(
            a for a in DECODE_RULES.get(name, ())
            if a in mesh_axes and a not in used)
        prod = 1
        for a in axes:
            prod *= mesh_axes[a]
        if axes and dim % prod == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            spec.append(None)
    return tuple(spec)


def _divisible(dim: int, mesh_axes: dict, axis: str) -> bool:
    return axis in mesh_axes and dim % mesh_axes[axis] == 0


def param_spec(path: str, leaf, mesh_axes: dict) -> Spec:
    """Serve-recipe spec of one parameter at ``path`` ("/"-joined keys):
    an expert tensor (..., E, d_in, d_out) splits E over "model", any other
    tensor of two or more dimensions its last one, where they divide.
    Scan-stacked leading layer dimensions and 1-D parameters stay whole."""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec = [None] * ndim
    if ndim < 2:
        return tuple(spec)
    if _EXPERT_RE.search(path) and ndim >= 3:
        if _divisible(shape[-3], mesh_axes, "model"):
            spec[-3] = "model"
        return tuple(spec)
    if _divisible(shape[-1], mesh_axes, "model"):
        spec[-1] = "model"
    return tuple(spec)


def param_specs(params, mesh) -> dict:
    """Spec tree matching the nested-dict ``params`` (``mesh``: a mesh or
    a plain {axis name: size} dict)."""
    axes = mesh_axes_dict(mesh)

    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (str(k),)) for k, v in node.items()}
        return param_spec("/".join(path), node, axes)

    return rec(params, ())


def combine_matmul_partials(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard split-K partial contractions, in their own dtype:
    int32 partials sum exactly, so a split-K matmul stays bit-identical to
    the unsplit contraction."""
    return functools.reduce(torch.add, parts)


def combine_softmax_state(accs: Sequence[torch.Tensor],
                          ms: Sequence[torch.Tensor],
                          ls: Sequence[torch.Tensor], *,
                          eps: float = 1e-37) -> torch.Tensor:
    """Merge per-shard flash-decoding states into the normalized output, in
    float32.  Shard s holds ``acc_s`` (the unnormalized weighted values),
    ``m_s`` (its running max) and ``l_s`` (its denominator), m and l
    broadcastable to acc on the last dimension; a shard that saw only
    masked positions holds the neutral (acc 0, m -0.7 FLT_MAX, l 0).

        m_g = max_s m_s;   out = sum_s acc_s e^(m_s - m_g)
                                 / max(sum_s l_s e^(m_s - m_g), eps)
    """
    m_g = functools.reduce(torch.maximum, ms)
    corr = [torch.exp(m - m_g) for m in ms]
    l_g = functools.reduce(torch.add, [l * c for l, c in zip(ls, corr)])
    acc = functools.reduce(torch.add, [a * c for a, c in zip(accs, corr)])
    return acc / torch.clamp_min(l_g, eps)

"""Per-device cost analysis of an eager PyTorch run (the counterpart of
``repro/launch/hlo_analysis.py``, which parses the optimized HLO of a
compiled JAX step; the port emits no HLO).

:class:`OpAnalysis` is a ``TorchDispatchMode``: every ATen op the run
dispatches passes through it, on any device (``meta`` in the dry run, the
CPU in the tests, the card).  It counts, per device of a mesh (a shard
index; every shard of a port mesh lies on one torch device):

  * dot FLOPs, float and int, as ``2 x numel(out) x contracted`` for every
    ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot`` and
    ``convolution``; an integer output counts as int.  The hand-written
    kernels count once at their wrappers (:func:`kernel_call`): K1 (the
    BitParticle matmul) 2·M·N·K int, and approx mode its two correction
    products too (the plain version's three products); K2 and K2s (paged
    attention) 4·B·H·(P·bs)·D float over the table's positions; K3 (WKV6)
    4·R·T·N·(C + N) float (per chunk of C: two C x C x N products and two
    C x N x N ones).  The ops of a plain version inside a wrapper are not
    counted again, so a meta run, a plain run and a CUDA run of one step
    count the same work.
  * the mesh's cross-shard traffic by kind, at the port's combine points
    (:func:`collective`): ``combine_matmul_partials`` and
    ``combine_softmax_state`` as all-reduce (a shard's operand bytes), a
    placed tensor's gather as all-gather (the whole tensor's bytes), a
    gradient's cut back into shards as reduce-scatter (the whole
    tensor's), a pipeline hand-off as collective-permute (its bytes), the
    column-split matmul's joined output as all-gather.
  * a high-water mark of live bytes per device: the arguments' bytes
    (given at entry) plus every storage an op allocates while the mode is
    on, until that storage dies.  Views and in-place results allocate
    nothing.

A shard's work is attributed to it by :func:`on_shard`, which the sharded
kernel wrappers and the placement set around each shard's call; all else
runs on the home shard, index 0 of every axis.  ``while_loops`` is 0: eager
code unrolls every loop, so every op is counted as often as it runs.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the analyses in effect, innermost last
_ACTIVE: list = []
_LOCAL = threading.local()

_aten = torch.ops.aten
_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _dot_flops(func, args, out) -> float:
    """2 x numel(out) x contracted size of a matmul-class op, else 0."""
    pkt = func.overloadpacket
    if pkt in (_aten.mm, _aten.bmm):
        return 2.0 * _numel(out.shape) * args[0].shape[-1]
    if pkt in (_aten.addmm, _aten.baddbmm):
        return 2.0 * _numel(out.shape) * args[1].shape[-1]
    if pkt is _aten.mv:
        return 2.0 * _numel(args[0].shape)
    if pkt is _aten.dot:
        return 2.0 * _numel(args[0].shape)
    if pkt is _aten.convolution:
        w = args[1]
        return 2.0 * _numel(out.shape) * _numel(w.shape[1:])
    return 0.0


def _shard() -> tuple:
    return getattr(_LOCAL, "shard", ())


def _suppressed() -> bool:
    return getattr(_LOCAL, "suppress", 0) > 0


@contextlib.contextmanager
def _noop():
    yield


@contextlib.contextmanager
def _set_shard(idx):
    prev = _shard()
    _LOCAL.shard = tuple(idx)
    try:
        yield
    finally:
        _LOCAL.shard = prev


def on_shard(idx):
    """Attribute the work run inside to mesh index ``idx`` (a no-op
    context when no analysis is active)."""
    return _set_shard(idx) if _ACTIVE else _noop()


@contextlib.contextmanager
def _kernel(name, flops, int_flops):
    for a in _ACTIVE:
        a._count_kernel(name, flops, int_flops)
    _LOCAL.suppress = getattr(_LOCAL, "suppress", 0) + 1
    try:
        yield
    finally:
        _LOCAL.suppress -= 1


def kernel_call(name: str, flops: float = 0.0, int_flops: float = 0.0):
    """Context around one call of a hand-written kernel's wrapper: counts
    its dot FLOPs once, on the current shard, and leaves the ops inside
    (a plain version's) uncounted.  A no-op context when no analysis is
    active."""
    return _kernel(name, flops, int_flops) if _ACTIVE else _noop()


def collective(kind: str, nbytes: int, label: str = "") -> None:
    """Count one cross-shard transfer of ``kind`` (one of
    :data:`COLLECTIVES`) and ``nbytes`` in every active analysis."""
    for a in _ACTIVE:
        a._count_collective(kind, nbytes, label)


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis(mesh, arguments=tree) as oa: ...`` then
    ``oa.result()``.  ``mesh``: a ``launch.mesh.Mesh`` (None: one
    device); ``arguments``: the state the run starts from (tensors on the
    home shard; ``sharding.Placed`` leaves and the mesh executor's
    ``MeshWeight`` on their shards, by their ``shard_nbytes()``), whose
    bytes
    are the memory analysis' argument size and the live bytes' floor."""

    def __init__(self, mesh=None, arguments=None, top_k: int = 12):
        super().__init__()
        self.mesh = mesh
        self.top_k = top_k
        ndim = 0 if mesh is None else mesh.devices.ndim
        self.home = (0,) * ndim
        self.dot_flops: Dict[tuple, float] = defaultdict(float)
        self.dot_flops_int: Dict[tuple, float] = defaultdict(float)
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0.0 for k in COLLECTIVES}
        self._contrib: Dict[str, float] = defaultdict(float)
        self.argument_bytes: Dict[tuple, int] = defaultdict(int)
        if arguments is not None:
            self._add_arguments(arguments)
        self.live: Dict[tuple, int] = defaultdict(int, self.argument_bytes)
        self.peak: Dict[tuple, int] = defaultdict(int, self.argument_bytes)
        self._storages: Dict[int, tuple] = {}
        self.n_ops = 0

    # -- bookkeeping ---------------------------------------------------------
    def _add_arguments(self, tree) -> None:
        if isinstance(tree, dict):
            for v in tree.values():
                self._add_arguments(v)
        elif hasattr(tree, "shard_nbytes"):     # placed leaves, MeshWeight
            for idx, n in tree.shard_nbytes().items():
                self.argument_bytes[idx] += n
        elif isinstance(tree, torch.Tensor):
            self.argument_bytes[self.home] += (tree.numel()
                                               * tree.element_size())

    def _here(self) -> tuple:
        return _shard() or self.home

    def _count_kernel(self, name, flops, int_flops) -> None:
        here = self._here()
        self.dot_flops[here] += flops
        self.dot_flops_int[here] += int_flops
        self.kernel_calls[name] += 1

    def _count_collective(self, kind, nbytes, label) -> None:
        if kind not in self.coll_bytes:
            raise ValueError(f"unknown collective {kind!r}")
        self.coll_bytes[kind] += nbytes
        self.coll_counts[kind] += 1
        self._contrib[f"{kind} | {label}"] += nbytes

    def _release(self, key) -> None:
        here, n = self._storages.pop(key, (None, 0))
        if here is not None:
            self.live[here] -= n

    def _track(self, func, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        rets = func._schema.returns
        here = None
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            if i < len(rets) and rets[i].alias_info is not None:
                continue            # a view or an in-place result
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            here = here or self._here()
            self._storages[key] = (here, n)
            self.live[here] += n
            weakref.finalize(st, self._release, key)
        if here is not None and self.live[here] > self.peak[here]:
            self.peak[here] = self.live[here]

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        if not _suppressed() and isinstance(out, torch.Tensor):
            f = _dot_flops(func, args, out)
            if f:
                if out.dtype in _INT_DTYPES:
                    self.dot_flops_int[self._here()] += f
                else:
                    self.dot_flops[self._here()] += f
        self._track(func, out)
        return out

    # -- results -------------------------------------------------------------
    def per_shard(self) -> Dict[str, dict]:
        """Each mesh index's own figures, keyed ``"i,j"``: dot FLOPs (float
        and int), argument bytes and peak live bytes.  Every index of the
        mesh appears, those that did no work with zeros."""
        shape = () if self.mesh is None else tuple(self.mesh.devices.shape)
        return {",".join(map(str, idx)): {
            "dot_flops": self.dot_flops.get(idx, 0.0),
            "dot_flops_int": self.dot_flops_int.get(idx, 0.0),
            "argument_bytes": self.argument_bytes.get(idx, 0),
            "peak_bytes": self.peak.get(idx, 0)}
            for idx in np.ndindex(*shape)}

    def result(self) -> dict:
        """The keys of the reference's ``analyze()``, per device: the
        busiest device's dot FLOPs (the home shard under one controller)
        beside the total over the mesh, and the memory high-water mark;
        ``per_shard`` holds each mesh index's own figures."""
        devices = set(self.dot_flops) | set(self.dot_flops_int) | {self.home}
        top = sorted(self._contrib.items(), key=lambda kv: -kv[1])
        return {
            "dot_flops_per_device": max(self.dot_flops[d] for d in devices),
            "dot_flops_int_per_device": max(self.dot_flops_int[d]
                                            for d in devices),
            "dot_flops_total": sum(self.dot_flops.values()),
            "dot_flops_int_total": sum(self.dot_flops_int.values()),
            "kernel_calls": dict(self.kernel_calls),
            "collective_bytes": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "top_collectives": [{"op": k, "bytes": v}
                                for k, v in top[:self.top_k]],
            "while_loops": 0,
            "argument_bytes_per_device": max(
                [self.argument_bytes[d] for d in self.argument_bytes]
                or [0]),
            "peak_bytes_per_device": max(self.peak.values() or [0]),
            "n_ops": self.n_ops,
            "per_shard": self.per_shard(),
        }

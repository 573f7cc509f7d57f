"""Elastic re-scaling: restore any checkpoint onto a different mesh (port
of ``repro/runtime/elastic.py``).

Checkpoints are topology-free (one host array per leaf); these functions
pair them with the recipe's specs for the *new* mesh, so a job stopped on
one mesh resumes on another.  A restored or resharded leaf is a
``distributed.sharding.Placed``: one slice per shard, on the shard's
device; ``sharding.gather_tree`` joins them back, bit for bit.
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import (Placed, param_specs, place,
                                              place_tree)


def restore_for_mesh(ckpt: CheckpointManager, step: int, like: Any, mesh,
                     recipe_name: str = "train"):
    """Restore the ``like``-structured state of ``step`` (leaves read to
    host memory by ``CheckpointManager.restore``), placed on ``mesh`` by
    the recipe's parameter specs."""
    host = ckpt.restore(step, like, device="cpu")
    return place_tree(host, recipe_name, mesh)


def reshard(tree: Any, mesh, recipe_name: str = "train"):
    """Live-reshard an in-memory state tree (tensors, or leaves placed on
    another mesh) onto ``mesh``, leaf by leaf: a placed leaf is gathered
    on its old home device and cut for the new mesh."""
    specs = param_specs(tree, recipe_name, mesh)

    def rec(node, spec):
        if isinstance(node, dict):
            return {k: rec(v, spec[k]) for k, v in node.items()}
        whole = node.gather() if isinstance(node, Placed) else node
        return place(whole, spec, mesh)

    return rec(tree, specs)

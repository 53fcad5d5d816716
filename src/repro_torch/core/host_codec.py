"""Host encoding of tensor trees for the port's containers.

Bitstreams (``repro_torch.core.reconfig``) and migration snapshots
(``repro_torch.core.migrate``, ``ServingEngine.snapshot_state``) store
tensor trees as numpy arrays in the ``CYBS`` container.  numpy has no
bfloat16, so a bf16 tensor is stored as its int16 bits under a
``{"__bfloat16_bits__": ...}`` tag and comes back as a bf16 tensor on the
host; it is never upcast.  This is the port's one encoding for that.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

BF16_TAG = "__bfloat16_bits__"


def _to_host(x: Any) -> Any:
    """One leaf of a tree -> numpy (bf16 as tagged int16 bits)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return {BF16_TAG: x.view(torch.int16).numpy()}
    return x.numpy()


def weights_to_host(tree: Any) -> Any:
    return pytree.tree_map(_to_host, tree)


def weights_from_host(tree: Any) -> Any:
    """Inverse of :func:`weights_to_host`: tagged bf16 bits become bf16
    tensors; every other leaf stays the numpy array it was stored as."""
    if isinstance(tree, dict):
        if set(tree) == {BF16_TAG}:
            return torch.from_numpy(np.asarray(tree[BF16_TAG])).view(
                torch.bfloat16)
        return {k: weights_from_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(weights_from_host(v) for v in tree)
    return tree

"""Weight bridge from the JAX reference's parameter tree.

``from_reference`` takes the tree that ``repro.models.transformer.
init_params`` returns, with every leaf already converted to a numpy array
by the caller, and builds the port's tensors under the same keys in the
same ``x @ W`` layout: ``embed.table``, ``final_norm``, the stacked
``layers.{norm1, attn.{wq,wk,wv,wo[,bq,bk,bv]}, norm2,
ffn.{w_gate,w_up,w_down}}`` and ``lm_head`` when the embeddings are
untied.  No transposes are needed: both packages multiply ``x @ W``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_reference(tree: Dict[str, Any], *, dtype=torch.float32,
                   device=None) -> Dict[str, Any]:
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            raise TypeError("from_reference takes uniform attention models "
                            "(hybrid slot tuples wait for the SSM slice)")
        # via float32: numpy has no bfloat16 of its own
        return torch.tensor(np.asarray(x, np.float32)).to(
            device=device, dtype=dtype)

    return conv(tree)

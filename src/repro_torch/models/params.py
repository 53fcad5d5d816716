"""Weight bridge from the JAX reference's parameter tree.

``from_reference`` takes the tree that ``repro.models.transformer.
init_params`` returns, with every leaf already converted to a numpy array
by the caller, and builds the port's tensors under the same keys in the
same ``x @ W`` layout: ``embed.table``, ``final_norm``, the stacked
``layers.{norm1, attn.{wq,wk,wv,wo[,bq,bk,bv]}, norm2, ffn}`` with
``ffn.{w_gate,w_up,w_down}`` or, for a MoE model, ``ffn.{router, w_gate,
w_up, w_down[, shared]}`` (experts stacked on an E axis), or, for a
mamba model, ``layers.{norm, mamba.{wz,wx,wB,wC,wdt,conv_w,conv_b,
dt_bias,A_log,D,norm,wo}}``, and ``lm_head`` when the embeddings are
untied.  A hybrid model's tree has ``slots``, a tuple of mamba trees (one
per non-shared pattern slot, each stacked over the cycles), and
``shared_attn``, one attention-plus-MLP layer; tuples stay tuples.  An
encoder-decoder's decoder layers add ``norm_x`` and ``xattn.{wq,wk,wv,wo}``
and its ``encoder`` holds ``layers`` (stacked like the decoder's, without
the cross-attention) and ``final_norm``.  The walk is generic over nested
dicts and tuples.  No transposes are needed: both packages multiply
``x @ W``.

Every leaf is cast to ``dtype`` except ``ssm.FLOAT32_LEAVES``: the SSM's
``dt_bias``, ``A_log`` and ``D`` and the MoE ``router``, which stay
float32 whatever ``dtype`` is, as the reference draws them: rounding
``A_log`` or ``dt_bias`` to bf16 would move every decay rate of the scan,
and the router's logits are float32 in both packages.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.ssm import FLOAT32_LEAVES


def from_reference(tree: Dict[str, Any], *, dtype=torch.float32,
                   device=None) -> Dict[str, Any]:
    device = resolve_device(device)

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v, name) for v in x)
        # via float32: numpy has no bfloat16 of its own
        t = torch.tensor(np.asarray(x, np.float32))
        return t.to(device=device, dtype=torch.float32
                    if name in FLOAT32_LEAVES else dtype)

    return conv(tree)

"""AdamW with global-norm clipping and a cosine schedule.

Twin of ``repro.optim.adamw``.  Mixed-precision contract: params are
stored float32 (the master copy), the model casts weights to the
activation dtype at use sites, and the moments are float32.  The
reference returns new trees; here ``update`` writes the new params and
moments into the given tensors (no second copy of the model on the card)
and returns the same trees.  Parameter trees are nested dicts and tuples
(a hybrid model's ``slots``); a leaf's path is its keys and indices
joined by "/" (``layers/attn/wq``, ``slots/0/wz``), as the reference's
``tree_flatten_with_path`` spells them, so the ``no_decay`` rule sees the
same strings.  The step count and the bias corrections are float32
tensors on the params' device: an update never waits for the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup -> cosine decay to min_lr_frac*lr (float32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and tuples -> {"a/b/c": leaf}; a tuple's entries are
    keyed by their index ("slots/0/wz"), as the reference's paths."""
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _tuples(node):
    """Dicts keyed "0".."n-1" back into the tuples ``flatten`` read."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return tuple(node[str(i)] for i in range(len(node)))
    return node


def unflatten(flat: Dict[str, Any]):
    """{"a/b/c": leaf} -> nested dicts, and tuples where ``flatten`` found
    them."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _tuples(out)


def init(params) -> Dict[str, Any]:
    leaves = flatten(params)
    zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in leaves.items()}
    device = next(iter(leaves.values())).device
    return {"m": unflatten(zeros),
            "v": unflatten({k: torch.zeros_like(z)
                            for k, z in zeros.items()}),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_specs(param_specs_tree) -> Dict[str, Any]:
    """Optimizer state shards exactly like the parameters."""
    from repro_torch.models.sharding import P
    return {"m": param_specs_tree, "v": param_specs_tree, "step": P()}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten(tree).values()))


def _default_no_decay(path: str) -> bool:
    return "norm" in path or "bias" in path or path.endswith("scale")


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, *,
           no_decay=_default_no_decay, grad_norm=None):
    """One AdamW step, in place.  Returns (params, state, metrics) with
    metrics {"grad_norm" (before clipping), "lr"} as float32 tensors.
    ``grad_norm``: the norm to clip by when ``grads``, ``state`` and
    ``params`` are one rank's shards of the whole trees (the whole
    gradient's norm, the same on every rank); None takes ``grads``'."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)

    flat_g, flat_m, flat_v = (flatten(t) for t in
                              (grads, state["m"], state["v"]))
    for path, p in flatten(params).items():
        g = flat_g[path].float() * scale
        m, v = flat_m[path], flat_v[path]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if not no_decay(path):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

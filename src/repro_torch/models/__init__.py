"""Model layers of the port (twin of ``repro.models``)."""
from repro_torch.models import attention, layers, mlp, moe, ssm, transformer
from repro_torch.models.sharding import MeshRules, constrain, named
from repro_torch.models.transformer import (cache_specs, decode_step, forward,
                                            init_cache, init_params, lm_logits,
                                            loss_fn, param_specs, prefill)

__all__ = [
    "attention", "layers", "mlp", "moe", "ssm", "transformer",
    "MeshRules", "constrain", "named",
    "init_params", "param_specs", "forward", "loss_fn", "lm_logits",
    "init_cache", "cache_specs", "prefill", "decode_step",
]

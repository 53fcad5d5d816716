"""vFPGA applications of the port: the paper's evaluation workloads as
slot-loadable artifacts (AES ECB/CBC, HyperLogLog, NN inference,
vector-add, LM serving); twin of ``repro.apps``."""
from repro_torch.apps.aes import make_aes_artifact
from repro_torch.apps.hll import (hll_count, hll_estimate, hll_merge,
                                  hll_sketch, make_hll_artifact)
from repro_torch.apps.nn_inference import (CoyoteOverlay, MLPConfig,
                                           StagedCopyBaseline)
from repro_torch.apps.vector_add import (make_passthrough_artifact,
                                         make_vector_add_artifact)

__all__ = [
    "make_aes_artifact", "hll_count", "hll_estimate", "hll_sketch",
    "hll_merge", "make_hll_artifact", "CoyoteOverlay", "MLPConfig", "StagedCopyBaseline",
    "make_passthrough_artifact", "make_vector_add_artifact",
]

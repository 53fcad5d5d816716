"""Paged serving datapath of the port (twin of ``repro.serve``).

Exports what the reference's package does, less its JAX retrace guard
(``TRACE_COUNTS``: eager PyTorch does not trace).  The tensor-parallel
twins (``serve/tp.py``, with the front end that lets a ``ServingGateway``
drive a tensor-parallel engine: its backfill decided on model-rank 0 and
replayed on the other ranks) and the prefill/decode hand-off
(``serve/disaggregated.py``) are imported from their modules, as in the
reference."""
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.gateway import ServingGateway, TokenStream
from repro_torch.serve.paged_model import (decode_step_paged, make_pools,
                                           prefill_chunk_paged,
                                           prefill_paged, write_prefill)
from repro_torch.serve.sampler import (SamplerConfig, fold_row_keys, sample,
                                       sample_per_row)
__all__ = ["Request", "ServingEngine", "ServingGateway", "TokenStream",
           "decode_step_paged", "make_pools", "prefill_chunk_paged",
           "prefill_paged", "write_prefill",
           "SamplerConfig", "fold_row_keys", "sample", "sample_per_row"]

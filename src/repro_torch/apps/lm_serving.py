"""LM serving as a vFPGA app: the paper's Fig 1 end-to-end.

Twin of ``repro.apps.lm_serving``.  The engine is the port's
``ServingEngine`` on the slot's device, so on the card every decode step
runs the paged-attention CUDA kernel once per layer.

The serving engine (continuous batching on the MMU's paged KV) mounts in a
shell slot behind the unified interface: cThreads submit prompts through
``invoke``, the engine fills the decode pipeline across concurrent TIDs,
completions raise user interrupts, and CSRs control sampling.

    shell = Shell(ShellConfig.make(services={"mmu": MMUConfig(...)}))
    shell.build()
    shell.load_app(0, make_lm_serving_artifact(cfg, params))
    ct = shell.attach_thread(0, pid)
    out = ct.invoke(Oper.KERNEL, SgEntry(src=prompt_ids, meta={...}))
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.port import PortCapabilities
from repro_torch.core.services.base import ServiceRequirement
from repro_torch.core.vfpga import AppArtifact

CSR_TEMPERATURE_MILLI = 0x10      # temperature * 1000
CSR_MAX_NEW_TOKENS = 0x11
CSR_TOP_K = 0x12                  # 0 = disabled
CSR_TOP_P_MILLI = 0x13            # top_p * 1000; 0 or >=1000 = disabled


class _EngineHolder:
    """Lazily builds one ServingEngine per vFPGA slot, bound to the
    shell's MMU service (the app 'links against' the service)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self._engines: Dict[int, Any] = {}

    def engine(self, vfpga):
        slot = vfpga.slot
        eng = self._engines.get(slot)
        if eng is None:
            from repro_torch.serve.engine import ServingEngine
            mmu = vfpga.shell.services.get("mmu")
            if mmu is None:
                raise RuntimeError("lm_serving requires the mmu service")
            eng = self._engines[slot] = ServingEngine(
                self.cfg, self.params, mmu, max_batch=self.max_batch,
                max_len=self.max_len, shell=vfpga.shell, slot=slot,
                tenant=vfpga.tenant, device=vfpga.static.device)
        elif vfpga.shell.engines.get(slot) is not eng:
            # the slot was hot-swapped away and back: rebind the cached
            # engine (unload() released its registrations).  Guarded so
            # steady-state requests skip the registry write and the
            # pager re-registration (this runs per invocation).
            vfpga.shell.engines[slot] = eng
            eng.mmu.register_pager(eng._pager_gather, eng._pager_scatter,
                                   owner=eng)
        return eng

    def __call__(self, iface, vfpga, prompt) -> List[int]:
        eng = self.engine(vfpga)
        temp = iface.csr.get_csr(CSR_TEMPERATURE_MILLI, 0) / 1000.0
        max_new = iface.csr.get_csr(CSR_MAX_NEW_TOKENS, 8)
        top_k = iface.csr.get_csr(CSR_TOP_K, 0)
        top_p_milli = iface.csr.get_csr(CSR_TOP_P_MILLI, 0)
        top_p = top_p_milli / 1000.0 if 0 < top_p_milli < 1000 else 1.0
        toks = np.asarray(prompt).reshape(-1)
        toks = toks.view(np.int32) if toks.dtype == np.uint8 else toks
        rid = eng.submit([int(t) for t in toks if t > 0],
                         max_new_tokens=int(max_new), temperature=temp,
                         top_k=int(top_k), top_p=top_p)
        while eng.pending():
            eng.step()
            # decode-step checkpoint: a long serve loop on this slot's
            # lane yields here to higher-priority granted work
            vfpga.checkpoint()
        req = next(r for r in eng.completed if r.rid == rid)
        iface.irq.raise_irq(rid)           # completion interrupt
        return req.out_tokens


def make_lm_serving_artifact(cfg: ModelConfig, params, *,
                             max_batch: int = 4,
                             max_len: int = 256) -> AppArtifact:
    holder = _EngineHolder(cfg, params, max_batch=max_batch,
                           max_len=max_len)
    return AppArtifact(
        name="lm_serving",
        fn=holder,
        requires=[ServiceRequirement("mmu", {"min_page_size": 1})],
        config_repr={"arch": cfg.arch_id, "max_batch": max_batch,
                     "max_len": max_len},
        capabilities=PortCapabilities(
            name="lm_serving", kind="app", streams=max_batch,
            csr_map={"temperature_milli": CSR_TEMPERATURE_MILLI,
                     "max_new_tokens": CSR_MAX_NEW_TOKENS,
                     "top_k": CSR_TOP_K,
                     "top_p_milli": CSR_TOP_P_MILLI},
            mem_model="paged", ops=("kernel",)))

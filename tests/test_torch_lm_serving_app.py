"""LM serving through the port's full shell stack (twin of
``tests/test_lm_serving_app.py``): cThread -> vFPGA -> engine -> paged
MMU, with CSR control and completion interrupts, on ``device="cpu"``.

Both packages' shells serve reduced smollm-135m at float32 on the same
weights through the same cThread calls: the greedy tokens must be
identical, and so must the engine's billed decode I/O and every tenant's
byte total in the scheduler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.lm_serving import \
    make_lm_serving_artifact as j_make_lm_serving_artifact
from repro.configs import get_config as jget
from repro.core import (Oper as JOper, SgEntry as JSgEntry,
                        Shell as JShell, ShellConfig as JShellConfig)
from repro.core.services import MMUConfig as JMMUConfig
from repro.models import transformer as JT
from repro_torch.apps.lm_serving import (CSR_MAX_NEW_TOKENS,
                                         CSR_TEMPERATURE_MILLI,
                                         make_lm_serving_artifact)
from repro_torch.configs import get_config
from repro_torch.core import Oper, SgEntry, Shell, ShellConfig
from repro_torch.core.services import MMUConfig
from repro_torch.models.params import from_reference

torch.set_num_threads(1)

PROMPTS = [np.arange(3, 15, dtype=np.int32),
           np.arange(40, 73, dtype=np.int32),
           np.array([7, 300, 21, 5, 9, 480, 2], dtype=np.int32)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("smollm-135m").reduced(), params


def _serve(port, weights, prompts, new_tokens=5):
    """Serve ``prompts`` one cThread call each on slot 0 of a one-slot
    shell bound to tenant "lm"; returns (token lists, engine io_bytes,
    tenant bytes, engine)."""
    jcfg, jparams, cfg, params = weights
    oper, sg = (Oper, SgEntry) if port else (JOper, JSgEntry)
    if port:
        shell = Shell(ShellConfig.make(
            services={"mmu": MMUConfig(page_size=16, n_pages=128)},
            n_vfpgas=1), device="cpu")
        art = make_lm_serving_artifact(cfg, params, max_len=96)
    else:
        shell = JShell(JShellConfig.make(
            services={"mmu": JMMUConfig(page_size=16, n_pages=128)},
            n_vfpgas=1))
        art = j_make_lm_serving_artifact(jcfg, jparams, max_len=96)
    shell.build()
    shell.load_app(0, art)
    ct = shell.attach_thread(0, pid=42, tenant="lm")
    shell.vfpgas[0].tenant = "lm"
    ct.setCSR(new_tokens, CSR_MAX_NEW_TOKENS)
    ct.setCSR(0, CSR_TEMPERATURE_MILLI)
    outs = []
    for prompt in prompts:
        comp = ct.invoke(oper.KERNEL,
                         sg(src=prompt, length=prompt.nbytes),
                         timeout=120.0)
        assert comp.ok, comp.result
        assert ct.poll_interrupt(timeout=1.0) is not None  # completion IRQ
        outs.append([int(t) for t in comp.result])
    eng = shell.engines[0]
    assert eng.flush_io(timeout=30.0)
    shell.drain()
    tenants = {k: v["bytes"]
               for k, v in shell.scheduler.stats()["tenants"].items()}
    shell.close()
    return outs, eng.io_bytes, tenants, eng


def test_lm_app_serves_through_cthread(weights):
    """The reference scenario on the port's shell: 5 tokens through a
    cThread with a completion IRQ; the first greedy token equals the
    reference's dense prefill's argmax."""
    jcfg, jparams, cfg, params = weights
    outs, _, _, _ = _serve(True, weights, PROMPTS[:1])
    assert len(outs[0]) == 5
    logits, _ = JT.prefill(jparams, jcfg, jnp.asarray(PROMPTS[0])[None],
                           max_len=96, cache_dtype=jnp.float32)
    assert outs[0][0] == int(jnp.argmax(logits[0, :jcfg.vocab_size]))


def test_lm_app_requires_mmu(weights):
    _, _, cfg, params = weights
    shell = Shell(ShellConfig.make(services={}, n_vfpgas=1), device="cpu")
    shell.build()
    from repro_torch.core.vfpga import LinkError
    with pytest.raises(LinkError):
        shell.load_app(0, make_lm_serving_artifact(cfg, params))
    shell.close()


def test_lm_app_tokens_and_billing_match_reference(weights):
    """Same weights, same cThread calls: identical greedy tokens, the
    same billed decode I/O, and the same bytes per tenant."""
    ref, ref_io, ref_tenants, _ = _serve(False, weights, PROMPTS)
    got, io, tenants, eng = _serve(True, weights, PROMPTS)
    assert got == ref
    assert io == ref_io > 0
    assert tenants == ref_tenants
    # the engine billed one int32 per live row per decode step, all to
    # the slot's tenant, and nothing failed
    assert io == 4 * sum(len(t) - 1 for t in got)
    assert eng.io_failures == 0
    prompt_bytes = sum(p.nbytes for p in PROMPTS)
    assert tenants["lm"] == prompt_bytes + io

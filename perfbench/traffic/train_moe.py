"""Training of a per-layer hybrid with a mixture of experts after every
mixer (granite-4.0-h-small) through the port's ``Trainer`` step: the
``train`` kind's runner (``traffic/train.py``), with the configuration's
own weight maker (``weights_granite4h.py``) and the MoE layer's counters
of the traced steps in the window's counters.

Set-up first checks that the program can run the configuration: a
program whose ``ModelConfig`` lacks the hybrid's fields would drop them
(``harness.model_config`` passes only the fields it knows) and train
another model, so such a program is refused before anything is built.
"""
from __future__ import annotations

import dataclasses

from perfbench import harness, weights_granite4h

Base = harness.runner_class("train")

# what the configuration gives the port beyond a plain MoE or Mamba-2
NEEDS = {"ModelConfig": ("embedding_multiplier", "residual_multiplier",
                         "logits_scaling", "attention_multiplier"),
         "MoEConfig": ("dropless", "experts_held", "d_ff_shared",
                       "aux_loss_coef")}
COUNTERS = ("moe.pairs", "moe.pairs_held", "moe.pairs_held_max")


def program_runs(config) -> None:
    """Raise unless the program's configuration classes have every field
    this configuration needs and know its layer kinds."""
    harness.use_program()
    from repro_torch.configs import base
    missing = [f"{cls}.{name}" for cls, names in NEEDS.items()
               for name in names
               if name not in {f.name for f in
                               dataclasses.fields(getattr(base, cls))}]
    if missing:
        raise RuntimeError(f"the program cannot run {config['name']}: its "
                           f"configuration has no {', '.join(missing)}")


class Runner(Base):
    def make_weights(self):
        return weights_granite4h.make(self.config, self.seed,
                                      harness.torch_dtype(
                                          self.config["param_dtype"]),
                                      self.device)

    def setup(self) -> None:
        program_runs(self.config)
        super().setup()

    def step(self):
        from repro_torch.telemetry import spans
        if getattr(self, "_tracer", None) is None or not self._tracer.active:
            return super().step()
        before = {k: spans.COUNTS[k] for k in COUNTERS}
        m = super().step()
        for k in COUNTERS:
            self.moe_counts[k] += spans.COUNTS[k] - before[k]
        return m

    def window(self, seconds, tracer) -> harness.Window:
        self._tracer, self.moe_counts = tracer, dict.fromkeys(COUNTERS, 0)
        win = super().window(seconds, tracer)
        self._tracer = None
        win.counters.update(
            {k.replace(".", "_"): v for k, v in self.moe_counts.items()},
            experts_held=weights_granite4h.held(self.config))
        return win

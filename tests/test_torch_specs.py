"""The port's partition-spec trees against the JAX reference's.

For every arch at its full config, under ``MeshRules`` for the single-pod
(data 16, model 16) and the two-pod (pod 2, data 16, model 16) production
meshes, in the ``2d``, ``zero3`` and serving schemes: ``param_specs``,
``cache_specs`` (at each shape's batch and length) and AdamW's
``state_specs`` equal the reference's leaf for leaf, a ``PartitionSpec``
read as a tuple.  Both packages' rules are built from the meshes' sizes
alone, with no mesh.
"""
import pytest
from jax.sharding import PartitionSpec

from repro.configs import ALL_SHAPES
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.sharding import MeshRules as JMeshRules
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import cache_specs, param_specs
from repro_torch.models.sharding import MeshRules, P
from repro_torch.optim import adamw

# (fsdp dims, fsdp size, tp size) of each mesh and scheme, as
# ``MeshRules.from_mesh`` derives them
MESHES = {
    "pod": {"2d": (("data",), 16, 16),
            "zero3": (("data", "model"), 256, 0)},
    "multipod": {"2d": (("pod", "data"), 32, 16),
                 "zero3": (("pod", "data", "model"), 512, 0)},
}
SCHEMES = ["2d", "zero3", "serving"]


def _rules(cls, mesh, scheme):
    axes, fsdp, tp = MESHES[mesh]["2d" if scheme == "serving" else scheme]
    r = cls(fsdp_axes=axes, tp_axis="model", fsdp_size=fsdp, tp_size=tp)
    return r.serving() if scheme == "serving" else r


def _flat(tree, prefix=""):
    """{path: spec as a tuple}; a spec is a leaf in both packages (each
    package's spec type is a tuple subclass)."""
    if isinstance(tree, (P, PartitionSpec)):
        return {prefix: tuple(tree)}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def test_the_packages_have_the_same_archs():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_specs_equal_the_reference(arch, mesh, scheme):
    cfg, jcfg = get_config(arch), jget(arch)
    rules = _rules(MeshRules, mesh, scheme)
    jrules = _rules(JMeshRules, mesh, scheme)
    mine, ref = param_specs(cfg, rules), JT.param_specs(jcfg, jrules)
    assert _flat(mine) == _flat(ref)
    assert _flat(adamw.state_specs(mine)) == _flat(
        jadamw.state_specs(ref))
    for shape in ALL_SHAPES:
        b, s = shape.global_batch, shape.seq_len
        assert _flat(cache_specs(cfg, rules, b, s)) == _flat(
            JT.cache_specs(jcfg, jrules, b, s)), shape.name

"""The port's telemetry against the reference's (twin of
``tests/test_telemetry.py``), on the CPU.

``hlo_cost`` and the text parsers of ``roofline`` are the reference's
code, so every case of the reference's file runs on the port's copies,
with JAX compiling the HLO text they read; the roofline's terms on the
H100 constants; ``roofline.analyze`` on a PyTorch callable; and
``Sniffer.capture_compiled`` of both packages on the same compiled
program."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import normalize_cost_analysis
from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.services.sniffer import TrafficSniffer as JSniffer
from repro.telemetry import roofline as jroofline
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.sniffer import TrafficSniffer as Sniffer
from repro_torch.telemetry import hlo_cost, roofline


def _compile(fn, *avals):
    return jax.jit(fn).lower(*avals).compile()


def test_dot_flops_exact():
    c = _compile(lambda a, b: a @ b,
                 jax.ShapeDtypeStruct((128, 256), jnp.float32),
                 jax.ShapeDtypeStruct((256, 512), jnp.float32))
    t = hlo_cost.analyze_text(c.as_text())
    expect = 2 * 128 * 256 * 512
    assert abs(t.flops - expect) / expect < 0.02


def test_while_trip_count_multiplier():
    def f(x, w):
        def body(c, wi):
            return c @ wi, None
        y, _ = jax.lax.scan(body, x, w)
        return y
    c = _compile(f, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                 jax.ShapeDtypeStruct((9, 64, 64), jnp.float32))
    t = hlo_cost.analyze_text(c.as_text())
    one = 2 * 64 * 64 * 64
    assert abs(t.flops - 9 * one) / (9 * one) < 0.1
    xla = normalize_cost_analysis(c.cost_analysis())["flops"]  # body x1
    assert t.flops > 5 * xla


def test_nested_scan_multipliers():
    def f(x, w):
        def outer(c, wi):
            def inner(ci, _):
                return ci @ wi, None
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        y, _ = jax.lax.scan(outer, x, w)
        return y
    c = _compile(f, jax.ShapeDtypeStruct((32, 32), jnp.float32),
                 jax.ShapeDtypeStruct((4, 32, 32), jnp.float32))
    t = hlo_cost.analyze_text(c.as_text())
    expect = 4 * 3 * 2 * 32 ** 3
    assert abs(t.flops - expect) / expect < 0.15


def test_dus_inplace_bytes_not_full_buffer():
    big = jax.ShapeDtypeStruct((4096, 1024), jnp.float32)
    row = jax.ShapeDtypeStruct((1, 1024), jnp.float32)

    def f(buf, r):
        return jax.lax.dynamic_update_slice(buf, r, (17, 0))
    c = jax.jit(f, donate_argnums=(0,)).lower(big, row).compile()
    t = hlo_cost.analyze_text(c.as_text())
    assert t.bytes < 4096 * 1024 * 4 * 0.5


_COLL = """
HloModule m
ENTRY %main (p: f32[1024,8]) -> f32[1024,8] {
  %p = f32[1024,8]{1,0} parameter(0)
  ROOT %ar = f32[1024,8]{1,0} all-reduce(%p), replica_groups=[2,4]<=[8], to_apply=%add
}
"""


def test_collective_parse_shapes_and_groups():
    t = hlo_cost.analyze_text(_COLL)
    assert t.coll_counts == {"all-reduce": 1.0}
    nbytes = 1024 * 8 * 4
    assert t.coll_bytes_naive["all-reduce"] == nbytes
    assert abs(t.coll_bytes_wire["all-reduce"] - 1.5 * nbytes) < 1
    st = roofline.parse_collectives(_COLL)
    assert st.as_dict() == jroofline.parse_collectives(_COLL).as_dict()
    assert st.counts == {"all-reduce": 1} and st.total_naive == nbytes


def test_tuple_type_with_index_comments_parses():
    txt = """
HloModule m
ENTRY %main (p: s32[]) -> s32[] {
  %p = s32[] parameter(0)
  %w = (s32[], f32[8,8]{1,0}, /*index=2*/f32[30,16]{1,0}) while(%t), body=%b, condition=%c, backend_config={"known_trip_count":{"n":"5"}}
  ROOT %r = s32[] get-tuple-element(%w), index=0
}
%b (a: (s32[], f32[8,8], f32[30,16])) -> (s32[], f32[8,8], f32[30,16]) {
  %a = (s32[], f32[8,8]{1,0}, f32[30,16]{1,0}) parameter(0)
  %x = f32[8,8]{1,0} get-tuple-element(%a), index=1
  %d = f32[8,8]{1,0} dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %t2 = (s32[], f32[8,8]{1,0}, f32[30,16]{1,0}) tuple(%p, %d, %y)
}
"""
    t = hlo_cost.analyze_text(txt)
    assert t.flops >= 5 * 2 * 8 * 8 * 8


def test_roofline_terms_and_dominance():
    """The reference's case on the H100's constants: one second of
    compute, two of memory, a quarter of the peak useful."""
    r = roofline.Roofline(
        flops_per_device=989e12, bytes_per_device=3.35e12 * 2,
        coll=roofline.CollectiveStats(), chips=256,
        model_flops=989e12 * 256 * 0.5)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert r.dominant == "memory"
    assert abs(r.roofline_fraction - 0.25) < 1e-9
    assert set(r.as_dict()) == set(jroofline.Roofline(
        1.0, 1.0, jroofline.CollectiveStats(), 1).as_dict())


def test_roofline_holds_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_F32, roofline.HBM_BW,
            roofline.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)


def test_wire_factor_model():
    assert hlo_cost._wire_factor("all-reduce", 2) == 1.0
    assert hlo_cost._wire_factor("all-gather", 4) == 0.75
    assert hlo_cost._wire_factor("reduce-scatter", 4) == 3.0
    assert hlo_cost._wire_factor("collective-permute", 2) == 1.0
    assert hlo_cost._wire_factor("all-reduce", 1) == 0.0
    for op in roofline.COLLECTIVE_OPS:
        for g in (1, 2, 8):
            assert roofline._wire_factor(op, g) == \
                jroofline._wire_factor(op, g)


def test_analyze_counts_a_matmul_exactly():
    """FLOPs of one (128, 256) x (256, 512) product, exact; bytes its two
    inputs and output once, plus the caller's extra."""
    a, b = torch.ones(128, 256), torch.ones(256, 512)
    r = roofline.analyze(torch.matmul, a, b, extra_bytes_per_device=100)
    assert r.flops_per_device == 2 * 128 * 256 * 512
    assert r.bytes_per_device == 4 * (128 * 256 + 256 * 512 + 128 * 512) + 100
    assert (r.xla_flops, r.xla_bytes, r.coll.total_wire) == (0.0, 0.0, 0.0)
    assert r.dominant == "memory"
    grad = roofline.analyze(
        lambda x: torch.autograd.grad((x @ b).sum(), x)[0],
        a.clone().requires_grad_(True))
    assert grad.flops_per_device == 2 * (2 * 128 * 256 * 512)


@pytest.mark.parametrize("arch,kind", [("smollm-135m", "train"),
                                       ("zamba2-2.7b", "prefill"),
                                       ("whisper-medium", "train"),
                                       ("mamba2-1.3b", "decode"),
                                       ("h2o-danube-3-4b", "decode")])
def test_model_flops_and_boundary_bytes_match_reference(arch, kind):
    cfg, jcfg = get_config(arch), jget(arch)
    shape = ShapeConfig("t", kind, 4096, 8)
    jshape = JShapeConfig("t", kind, 4096, 8)
    assert roofline.model_flops_for(cfg, shape) == \
        jroofline.model_flops_for(jcfg, jshape)
    assert roofline.fused_boundary_bytes(cfg, shape, 4) == \
        jroofline.fused_boundary_bytes(jcfg, jshape, 4)


def test_memory_stats_without_a_card_is_empty():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert roofline.memory_stats() == {}


class _Text:
    """An object whose ``as_text()`` is a compiled module's HLO text."""

    def __init__(self, text):
        self.text = text

    def as_text(self):
        return self.text


def test_capture_compiled_matches_the_reference():
    """Both packages' ``Sniffer.capture_compiled`` on the same compiled
    program and on HLO text with an all-reduce give the same packets."""
    c = _compile(lambda a, b: a @ b,
                 jax.ShapeDtypeStruct((16, 32), jnp.float32),
                 jax.ShapeDtypeStruct((32, 8), jnp.float32))
    assert Sniffer.capture_compiled(c) == JSniffer.capture_compiled(c) == []
    got = Sniffer.capture_compiled(_Text(_COLL))
    assert got == JSniffer.capture_compiled(_Text(_COLL))
    assert got == [{"op": "all-reduce", "count": 1, "bytes": 1024 * 8 * 4,
                    "wire_bytes": int(1.5 * 1024 * 8 * 4)}]

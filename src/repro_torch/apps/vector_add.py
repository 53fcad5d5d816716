"""Vector addition with MULTIPLE host streams (paper Fig 2, Req. 3).

The motivating interface example: prior shells force multiple inputs to be
packed into one stream in software; Coyote v2's parallel streams let each
vector ride its own stream.  This app consumes two input streams and
produces one output stream.  Twin of ``repro.apps.vector_add``: host
logic on numpy, unchanged."""
from __future__ import annotations

import numpy as np

from repro_torch.core.interfaces import Packet
from repro_torch.core.port import PortCapabilities
from repro_torch.core.vfpga import AppArtifact


def vector_add_app(iface, vfpga, a, b=None):
    """Two calling conventions: direct (a, b arrays) or streamed (pop one
    packet from host streams 0 and 1)."""
    if b is None:
        pa = iface.host_in[0].pop(timeout=1.0)
        pb = iface.host_in[1].pop(timeout=1.0)
        if pa is None or pb is None:
            raise RuntimeError("vector_add: missing input stream packet")
        a, b = pa.payload, pb.payload
    out = np.asarray(a, np.float32) + np.asarray(b, np.float32)
    iface.host_out[0].push(Packet(tid=0, seq_no=0, payload=out,
                                  nbytes=out.nbytes, last=True))
    return out


def make_vector_add_artifact() -> AppArtifact:
    return AppArtifact(name="vector_add", fn=vector_add_app,
                       config_repr={"streams": 2},
                       capabilities=PortCapabilities(
                           name="vector_add", kind="app", streams=2,
                           csr_map={}, mem_model="host",
                           ops=("local_transfer", "kernel")))


def passthrough_app(iface, vfpga, x):
    return x


def make_passthrough_artifact() -> AppArtifact:
    return AppArtifact(name="passthrough", fn=passthrough_app,
                       config_repr={},
                       capabilities=PortCapabilities(
                           name="passthrough", kind="app", streams=1,
                           csr_map={}, mem_model="host",
                           ops=("local_transfer", "kernel")))

"""Safe, versioned "partial bitstream" container (no pickle).

Layout of a bitstream blob:

    +--------+---------+------------+-------------------+--------------+
    | b"CYBS"| u16 ver | u32 hlen   | JSON header (hlen)| npz payload  |
    +--------+---------+------------+-------------------+--------------+

The JSON header carries all metadata (kind, artifact version, config,
requirements, ...) plus a JSON-encoded *skeleton* of the weight pytree in
which every array leaf is replaced by ``{"__leaf__": i}``; leaf ``i`` is
stored as entry ``a<i>`` of the trailing npz archive (loaded with
``allow_pickle=False``).  Nothing in the format can execute code on load —
the replacement for the previous pickle-based serialization.

The JSON header also carries an ``integrity`` stanza — a blake2b digest
of the npz payload, written by every encode and verified on decode: a
flipped bit anywhere in the payload (or a truncated container) raises
:class:`BitstreamError` instead of restoring corrupt tenant state, and
an integrity stanza naming an algorithm this reader doesn't know is
refused outright rather than skipped.  ``encode_stream``/
``decode_stream`` are the chunked forms: the payload is materialized
once (npz spool) and shipped/consumed as bounded chunks, so a multi-GB
migration container never exists twice in host memory.

Unknown magic, container version, or ``kind`` raise
:class:`BitstreamError` with a clear message instead of deserializing.
"""
from __future__ import annotations

import hashlib
import io
import json
import struct
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"CYBS"
FORMAT_VERSION = 1
# "migration" blobs carry a quiesced tenant's state (page tables, live KV
# payload, CSR/addr-map) for quiesce-and-migrate — see repro.core.migrate
KNOWN_KINDS = ("shell", "app", "raw", "migration")
# payload-digest algorithms this reader implements; a container naming
# anything else is refused (treating it as "no hash" would let a forger
# strip verification by inventing an algo name)
INTEGRITY_KINDS = ("blake2b",)
_DIGEST_SIZE = 32

_HDR = struct.Struct("<HI")         # (format_version, header_len)


class BitstreamError(ValueError):
    """Malformed, unknown-kind, or unknown-version bitstream."""


# ------------------------------------------------------- pytree skeleton ---
def _encode_tree(x: Any, leaves: List[np.ndarray]) -> Any:
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if hasattr(x, "__array__") or isinstance(x, (np.ndarray, np.generic)):
        leaves.append(np.asarray(x))
        return {"__leaf__": len(leaves) - 1}
    if isinstance(x, dict):
        if any(not isinstance(k, str) for k in x):
            raise BitstreamError(
                "bitstream trees require string dict keys, got "
                f"{sorted(map(repr, x))[:3]}")
        return {"__dict__": {k: _encode_tree(v, leaves)
                             for k, v in x.items()}}
    if isinstance(x, (list, tuple)):
        tag = "__list__" if isinstance(x, list) else "__tuple__"
        return {tag: [_encode_tree(v, leaves) for v in x]}
    raise BitstreamError(
        f"unsupported type in bitstream tree: {type(x).__name__} "
        "(allowed: arrays, dict/list/tuple, JSON scalars)")


def _decode_tree(x: Any, leaves: Dict[str, np.ndarray]) -> Any:
    if isinstance(x, dict):
        if "__leaf__" in x:
            return leaves[f"a{x['__leaf__']}"]
        if "__dict__" in x:
            return {k: _decode_tree(v, leaves)
                    for k, v in x["__dict__"].items()}
        if "__list__" in x:
            return [_decode_tree(v, leaves) for v in x["__list__"]]
        if "__tuple__" in x:
            return tuple(_decode_tree(v, leaves) for v in x["__tuple__"])
        raise BitstreamError(f"malformed tree node: {sorted(x)}")
    return x


# ------------------------------------------------------------- container ---
def _verify_integrity(doc: Dict[str, Any], digest: str) -> None:
    """Check a computed payload hexdigest against the header stanza.
    Containers written before integrity landed have no stanza and stay
    loadable; a stanza with an algorithm we don't implement is refused."""
    integ = doc.get("integrity")
    if integ is None:
        return
    algo = integ.get("algo")
    if algo not in INTEGRITY_KINDS:
        raise BitstreamError(
            f"unsupported bitstream integrity algo {algo!r} (known: "
            f"{INTEGRITY_KINDS}); refusing to load unverifiable payload")
    if digest != integ.get("digest"):
        raise BitstreamError(
            "bitstream payload integrity check failed (blake2b digest "
            "mismatch — truncated or tampered container)")


def _parse_doc(hjson: bytes) -> Dict[str, Any]:
    try:
        return json.loads(hjson.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BitstreamError(f"corrupt bitstream header: {e}")


def _check_kind(doc: Dict[str, Any],
                expect_kind: Optional[str]) -> str:
    kind = doc.get("kind")
    if kind not in KNOWN_KINDS:
        raise BitstreamError(
            f"unknown bitstream kind {kind!r} (known: {KNOWN_KINDS}); "
            "refusing to load")
    if expect_kind is not None and kind != expect_kind:
        raise BitstreamError(
            f"expected a {expect_kind!r} bitstream, got {kind!r}")
    return kind


def encode_stream(kind: str, header: Dict[str, Any], arrays: Any = None,
                  *, chunk_bytes: int = 1 << 20) -> Iterator[bytes]:
    """Serialize one bitstream as a chunk generator.

    The npz payload is spooled exactly once; yielded chunks are bounded
    slices of it, so a caller that forwards chunks to a transport never
    holds a second full copy.  The header's ``integrity`` stanza carries
    the blake2b digest of the spooled payload.
    """
    if kind not in KNOWN_KINDS:
        raise BitstreamError(
            f"unknown bitstream kind {kind!r} (known: {KNOWN_KINDS})")
    leaves: List[np.ndarray] = []
    skeleton = _encode_tree(arrays, leaves)
    bio = io.BytesIO()
    np.savez(bio, **{f"a{i}": leaf for i, leaf in enumerate(leaves)})
    payload = bio.getbuffer()
    doc = {"kind": kind, "header": header, "arrays": skeleton,
           "integrity": {
               "algo": "blake2b",
               "digest": hashlib.blake2b(
                   payload, digest_size=_DIGEST_SIZE).hexdigest()}}
    try:
        hjson = json.dumps(doc, sort_keys=True).encode("utf-8")
    except TypeError as e:
        raise BitstreamError(f"bitstream header is not JSON-safe: {e}")
    yield MAGIC + _HDR.pack(FORMAT_VERSION, len(hjson))
    for i in range(0, len(hjson), chunk_bytes):
        yield hjson[i:i + chunk_bytes]
    for i in range(0, len(payload), chunk_bytes):
        yield bytes(payload[i:i + chunk_bytes])


def encode(kind: str, header: Dict[str, Any],
           arrays: Any = None) -> bytes:
    """Serialize one bitstream.  ``header`` must be JSON-serializable;
    ``arrays`` is an optional pytree of array leaves."""
    return b"".join(encode_stream(kind, header, arrays))


def decode_stream(chunks: Iterable[bytes], *,
                  expect_kind: Optional[str] = None
                  ) -> Tuple[str, Dict[str, Any], Any]:
    """Parse a stream of bitstream chunks -> (kind, header, arrays).

    Chunks may split anywhere (byte boundaries carry no meaning).  The
    payload is spooled into one buffer and blake2b-hashed incrementally
    as chunks arrive — the full container is never assembled.
    """
    it = iter(chunks)
    pre = len(MAGIC) + _HDR.size
    buf = bytearray()
    exhausted = False
    while len(buf) < pre and not exhausted:
        try:
            buf.extend(next(it))
        except StopIteration:
            exhausted = True
    if len(buf) < pre or bytes(buf[:len(MAGIC)]) != MAGIC:
        raise BitstreamError(
            "not a Coyote bitstream (bad magic; refusing to deserialize "
            "legacy pickle blobs)")
    ver, hlen = _HDR.unpack_from(buf, len(MAGIC))
    if ver > FORMAT_VERSION:
        raise BitstreamError(
            f"bitstream container version {ver} is newer than this "
            f"reader (supports <= {FORMAT_VERSION}); refusing to load")
    while len(buf) < pre + hlen and not exhausted:
        try:
            buf.extend(next(it))
        except StopIteration:
            exhausted = True
    if len(buf) < pre + hlen:
        raise BitstreamError("truncated bitstream header")
    doc = _parse_doc(bytes(buf[pre:pre + hlen]))
    kind = _check_kind(doc, expect_kind)
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    payload = io.BytesIO()
    tail = memoryview(buf)[pre + hlen:]
    h.update(tail)
    payload.write(tail)
    for c in it:
        h.update(c)
        payload.write(c)
    _verify_integrity(doc, h.hexdigest())
    arrays = None
    if doc.get("arrays") is not None:
        payload.seek(0)
        npz = np.load(payload, allow_pickle=False)
        arrays = _decode_tree(doc["arrays"], npz)
    return kind, doc.get("header", {}), arrays


def decode(blob: bytes, *, expect_kind: Optional[str] = None
           ) -> Tuple[str, Dict[str, Any], Any]:
    """Parse a bitstream blob -> (kind, header, arrays).

    Rejects bad magic, container versions newer than this reader,
    unknown/unexpected kinds, and (for containers carrying an integrity
    stanza) payload digest mismatches with a :class:`BitstreamError`.
    """
    if len(blob) < len(MAGIC) + _HDR.size or blob[:len(MAGIC)] != MAGIC:
        raise BitstreamError(
            "not a Coyote bitstream (bad magic; refusing to deserialize "
            "legacy pickle blobs)")
    ver, hlen = _HDR.unpack_from(blob, len(MAGIC))
    if ver > FORMAT_VERSION:
        raise BitstreamError(
            f"bitstream container version {ver} is newer than this "
            f"reader (supports <= {FORMAT_VERSION}); refusing to load")
    off = len(MAGIC) + _HDR.size
    doc = _parse_doc(blob[off:off + hlen])
    kind = _check_kind(doc, expect_kind)
    payload = memoryview(blob)[off + hlen:]
    _verify_integrity(doc, hashlib.blake2b(
        payload, digest_size=_DIGEST_SIZE).hexdigest())
    arrays = None
    if doc.get("arrays") is not None:
        npz = np.load(io.BytesIO(payload), allow_pickle=False)
        arrays = _decode_tree(doc["arrays"], npz)
    return kind, doc.get("header", {}), arrays


def jsonable(x: Any) -> Any:
    """Best-effort JSON projection for free-form config metadata
    (``config_repr`` etc.): dataclasses become dicts, unknown objects
    their repr.  Lossy by design — config_repr is cache-key material,
    not executable state."""
    import dataclasses
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: jsonable(v)
                for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return repr(x)

"""TFRecord + tf.train.SequenceExample reader with zero TensorFlow dependency.

The reference's input pipeline is tf.data: TFRecordDataset -> batch ->
tf.parse_example (algorithm/utils.py:18-26).  This framework keeps the
on-disk format (so existing reference-generated datasets drop in unchanged)
but parses it natively:

  * TFRecord framing: [uint64le length][uint32 masked-crc32c(length)]
    [data bytes][uint32 masked-crc32c(data)] per record.  CRCs are optionally
    verified (off by default for speed; the C++ reader in runtime/ verifies).
  * protobuf wire format for SequenceExample / Features / Feature /
    BytesList / FloatList / Int64List, hand-decoded (the schema is tiny and
    fixed — a full protobuf runtime is unnecessary).

A C++ fast path with the same output layout lives in runtime/cc; this module
is the reference implementation and its test oracle.

Own copy of ``recalgorithm_tpu/data/tfrecord.py``: the PyTorch package
imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator


def read_records(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            if len(data) < length:
                return
            f.seek(4, 1)  # skip data crc
            yield data


def write_records(path: str, payloads, append: bool = False) -> None:
    """Write payloads as a TFRecord file (CRCs computed properly)."""
    with open(path, "ab" if append else "wb") as f:
        for data in payloads:
            length_bytes = struct.pack("<Q", len(data))
            f.write(length_bytes)
            f.write(struct.pack("<I", _masked_crc(length_bytes)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# crc32c (software table implementation; used by the writer and for optional
# read verification)
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            _CRC_TABLE.append(crc)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# protobuf wire decoding for SequenceExample
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message buffer.

    wire 0 -> varint int; wire 2 -> bytes payload; wire 5 -> 4-byte chunk.
    """
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            val = buf[pos : pos + size]
            pos += size
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:  # pragma: no cover - groups unused by tf.Example
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    """Feature -> ('bytes'|'float'|'int64', list of values)."""
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # BytesList
            out = [v for f2, _, v in _iter_fields(val) if f2 == 1]
            return "bytes", out
        if field == 2:  # FloatList (packed or repeated)
            floats: list[float] = []
            for f2, w2, v in _iter_fields(val):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed
                    floats.extend(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
                else:  # single fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return "float", floats
        if field == 3:  # Int64List
            ints: list[int] = []
            for f2, w2, v in _iter_fields(val):
                if f2 != 1:
                    continue
                if w2 == 2:  # packed varints
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        ints.append(x)
                else:
                    ints.append(v)
            return "int64", ints
    return "bytes", []


def _parse_map_entry(buf: bytes) -> tuple[str, bytes]:
    key, value = "", b""
    for field, _, val in _iter_fields(buf):
        if field == 1:
            key = val.decode("utf-8")
        elif field == 2:
            value = val
    return key, value


def parse_sequence_example(buf: bytes) -> tuple[dict, dict]:
    """SequenceExample bytes -> (context, feature_lists).

    context: {name: (kind, values)};
    feature_lists: {name: [(kind, values), ...] per step}.
    """
    context: dict = {}
    feature_lists: dict = {}
    for field, _, val in _iter_fields(buf):
        if field == 1:  # context: Features
            for f2, _, entry in _iter_fields(val):
                if f2 == 1:
                    k, fbuf = _parse_map_entry(entry)
                    context[k] = _parse_feature(fbuf)
        elif field == 2:  # feature_lists: FeatureLists
            for f2, _, entry in _iter_fields(val):
                if f2 == 1:
                    k, flbuf = _parse_map_entry(entry)
                    steps = [
                        _parse_feature(v)
                        for f3, _, v in _iter_fields(flbuf)
                        if f3 == 1
                    ]
                    feature_lists[k] = steps
    return context, feature_lists


# ---------------------------------------------------------------------------
# protobuf wire encoding (used by the ETL writer and tests)
# ---------------------------------------------------------------------------

def _enc_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(field: int, wire: int, payload: bytes) -> bytes:
    tag = _enc_varint((field << 3) | wire)
    if wire == 2:
        return tag + _enc_varint(len(payload)) + payload
    return tag + payload


def encode_feature(kind: str, values) -> bytes:
    if kind == "bytes":
        inner = b"".join(
            _enc_field(1, 2, v if isinstance(v, bytes) else v.encode())
            for v in values
        )
        return _enc_field(1, 2, inner)
    if kind == "float":
        packed = struct.pack(f"<{len(values)}f", *values)
        return _enc_field(2, 2, _enc_field(1, 2, packed))
    if kind == "int64":
        packed = b"".join(_enc_varint(int(v)) for v in values)
        return _enc_field(3, 2, _enc_field(1, 2, packed))
    raise ValueError(kind)


def _enc_map_entry(field: int, key: str, value: bytes) -> bytes:
    inner = _enc_field(1, 2, key.encode()) + _enc_field(2, 2, value)
    return _enc_field(field, 2, inner)


def encode_sequence_example(context: dict, feature_lists: dict) -> bytes:
    """Inverse of parse_sequence_example.

    context: {name: (kind, values)};
    feature_lists: {name: (kind, [values_per_step])} where each step holds one
    value (the reference ETL writes one token per step,
    DataGenerator.py:429-436).
    """
    ctx_entries = b"".join(
        _enc_map_entry(1, k, encode_feature(kind, vals))
        for k, (kind, vals) in context.items()
    )
    fl_entries = b""
    for k, (kind, steps) in feature_lists.items():
        flist = b"".join(
            _enc_field(1, 2, encode_feature(kind, [v])) for v in steps
        )
        fl_entries += _enc_map_entry(1, k, flist)
    return _enc_field(1, 2, ctx_entries) + _enc_field(2, 2, fl_entries)


def parse_example(buf: bytes) -> dict:
    """tf.train.Example bytes -> {name: (kind, values)} (context-only form)."""
    context: dict = {}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            for f2, _, entry in _iter_fields(val):
                if f2 == 1:
                    k, fbuf = _parse_map_entry(entry)
                    context[k] = _parse_feature(fbuf)
    return context

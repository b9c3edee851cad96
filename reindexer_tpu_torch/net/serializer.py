"""Port of reindexer_tpu/net/serializer.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

Varint wire serializer.

Semantic equivalent of the reference's hand-rolled serializer
(cpp_src/tools/serializer.h + net/cproto/args.cc: PutVarUInt/PutVString/
typed args array). Values are tagged: int (zigzag varint), string/bytes
(length-prefixed), float (8-byte LE), bool, null, and nested arrays — enough
to carry every RPC verb's arguments.
"""
from __future__ import annotations

import struct
from typing import Any

TAG_NULL = 0
TAG_INT = 1
TAG_DOUBLE = 2
TAG_STR = 3
TAG_BOOL = 4
TAG_BYTES = 5
TAG_ARRAY = 6


def put_varuint(buf: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def get_varuint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def put_value(buf: bytearray, v: Any) -> None:
    if v is None:
        buf.append(TAG_NULL)
    elif isinstance(v, bool):
        buf.append(TAG_BOOL)
        buf.append(1 if v else 0)
    elif isinstance(v, int):
        buf.append(TAG_INT)
        put_varuint(buf, _zigzag(v))
    elif isinstance(v, float):
        buf.append(TAG_DOUBLE)
        buf.extend(struct.pack("<d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        buf.append(TAG_STR)
        put_varuint(buf, len(raw))
        buf.extend(raw)
    elif isinstance(v, (bytes, bytearray)):
        buf.append(TAG_BYTES)
        put_varuint(buf, len(v))
        buf.extend(v)
    elif isinstance(v, (list, tuple)):
        buf.append(TAG_ARRAY)
        put_varuint(buf, len(v))
        for x in v:
            put_value(buf, x)
    else:
        raise TypeError(f"unsupported wire type: {type(v)}")


def get_value(data: bytes, pos: int) -> tuple[Any, int]:
    tag = data[pos]
    pos += 1
    if tag == TAG_NULL:
        return None, pos
    if tag == TAG_BOOL:
        return bool(data[pos]), pos + 1
    if tag == TAG_INT:
        v, pos = get_varuint(data, pos)
        return _unzigzag(v), pos
    if tag == TAG_DOUBLE:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if tag == TAG_STR:
        n, pos = get_varuint(data, pos)
        return data[pos: pos + n].decode("utf-8"), pos + n
    if tag == TAG_BYTES:
        n, pos = get_varuint(data, pos)
        return bytes(data[pos: pos + n]), pos + n
    if tag == TAG_ARRAY:
        n, pos = get_varuint(data, pos)
        out = []
        for _ in range(n):
            v, pos = get_value(data, pos)
            out.append(v)
        return out, pos
    raise ValueError(f"bad wire tag {tag}")


def encode_args(args: list) -> bytes:
    buf = bytearray()
    put_varuint(buf, len(args))
    for a in args:
        put_value(buf, a)
    return bytes(buf)


def decode_args(data: bytes) -> list:
    n, pos = get_varuint(data, 0)
    out = []
    for _ in range(n):
        v, pos = get_value(data, pos)
        out.append(v)
    return out

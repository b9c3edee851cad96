"""Port of reindexer_tpu/core/protobuf.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

Protobuf result encoding + .proto schema generation.

Python-native analog of the reference's protobuf output plane
(cpp_src/core/cjson/protobufbuilder.cc, protobufschemabuilder.cc and the
HTTP `GET /api/v1/db/:db/protobuf_schema` route, httpserver.cc:936,1116):
per-namespace proto3 messages derived from the index schema, a
`QueryResults` envelope with one repeated item field per namespace, and a
hand-rolled proto3 wire encoder (varint/zigzag/length-delimited — the
encoding is fully specified, no codegen needed server-side). Clients
compile the served schema with stock `protoc` and parse responses with any
protobuf runtime (tests do exactly that).

Type mapping mirrors the reference (protobufschemabuilder.cc:43-67):
integer -> sint64 (zigzag), number -> double, boolean -> bool,
string/uuid -> string. Float-vector fields become `repeated float`
(packed). Deviation: non-indexed document fields travel in a trailing
`string _extra` field as JSON (the reference requires a user-set JSON
schema for those; we synthesize a catch-all instead so schemaless
namespaces stay usable over protobuf).
"""
from __future__ import annotations

import json
import struct
from typing import Any, Iterable

from .type_consts import FieldType, IndexType

# proto3 wire types
_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5

# field numbers in the QueryResults envelope not used by namespace item
# fields (those are 1..N by requested-namespace position)
F_TOTAL_ITEMS = 100
F_QUERY_TOTAL_ITEMS = 101
F_CACHE_ENABLED = 102
F_EXPLAIN = 103
F_AGGREGATIONS = 104
_EXTRA_FIELD = "_extra"


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else n << 1


def encode_varint(n: int, out: bytearray) -> None:
    if n < 0:
        n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _tag(field_num: int, wire_type: int, out: bytearray) -> None:
    encode_varint((field_num << 3) | wire_type, out)


def _field_proto_type(idef) -> tuple[str, bool]:
    """(proto3 type name, repeated) for an index definition."""
    if idef.index_type in (IndexType.VEC_BF, IndexType.HNSW, IndexType.IVF):
        return "float", True
    ft = idef.field_type
    rep = bool(getattr(idef.opts, "is_array", False))
    if ft in (FieldType.INT, FieldType.INT64):
        return "sint64", rep
    if ft == FieldType.DOUBLE:
        return "double", rep
    if ft == FieldType.BOOL:
        return "bool", rep
    return "string", rep        # string / uuid / composite keys


def _msg_name(ns_name: str) -> str:
    safe = "".join(c if c.isalnum() else "_" for c in ns_name)
    return safe[:1].upper() + safe[1:]


def _ns_fields(ns) -> list[tuple[int, str, str, bool]]:
    """[(field_number, name, proto_type, repeated)] — numbers are 1-based
    index positions, stable as long as the index set is (the analog of the
    reference's payload-field numbering)."""
    out = []
    num = 1
    for idef in ns.index_defs():
        if getattr(idef, 'is_composite', False):
            continue                      # no storage of its own
        pt, rep = _field_proto_type(idef)
        out.append((num, idef.name, pt, rep))
        num += 1
    out.append((num, _EXTRA_FIELD, "string", False))
    return out


def schema_text(db, ns_names: Iterable[str]) -> str:
    """proto3 schema for the requested namespaces + QueryResults envelope
    (reference: ReindexerImpl::GetProtobufSchema, reindexerimpl.cc:2542)."""
    names = list(ns_names)
    lines = ['syntax = "proto3";', ""]
    for name in names:
        ns = db.get_namespace(name)
        lines.append(f"message {_msg_name(name)} {{")
        for num, fname, ptype, rep in _ns_fields(ns):
            prefix = "repeated " if rep else ""
            lines.append(f"  {prefix}{ptype} {fname} = {num};")
        lines.append("}")
        lines.append("")
    lines.append("message QueryResults {")
    for i, name in enumerate(names, start=1):
        lines.append(f"  repeated {_msg_name(name)} items = {i};")
        break   # one namespace per results stream (joins are inlined)
    lines.append(f"  sint64 total_items = {F_TOTAL_ITEMS};")
    lines.append(f"  sint64 query_total_items = {F_QUERY_TOTAL_ITEMS};")
    lines.append(f"  bool cache_enabled = {F_CACHE_ENABLED};")
    lines.append(f"  string explain = {F_EXPLAIN};")
    lines.append(f"  repeated string aggregations = {F_AGGREGATIONS};")
    lines.append("}")
    lines.append("")
    return "\n".join(lines)


def _encode_scalar(num: int, ptype: str, v: Any, out: bytearray) -> None:
    if v is None:
        return
    if ptype == "sint64":
        _tag(num, _WT_VARINT, out)
        encode_varint(_zigzag(int(v)), out)
    elif ptype == "double":
        _tag(num, _WT_I64, out)
        out += struct.pack("<d", float(v))
    elif ptype == "bool":
        _tag(num, _WT_VARINT, out)
        encode_varint(1 if v else 0, out)
    elif ptype == "float":
        _tag(num, _WT_I32, out)
        out += struct.pack("<f", float(v))
    else:                                  # string
        data = str(v).encode("utf-8")
        _tag(num, _WT_LEN, out)
        encode_varint(len(data), out)
        out += data


def _encode_packed_float(num: int, vals, out: bytearray) -> None:
    _tag(num, _WT_LEN, out)
    encode_varint(4 * len(vals), out)
    for v in vals:
        out += struct.pack("<f", float(v))


def encode_item(ns, doc: dict, fields=None) -> bytes:
    """One document -> proto3 message bytes (schema: _ns_fields; pass
    `fields` to amortize the schema walk across a result page)."""
    out = bytearray()
    if fields is None:
        fields = _ns_fields(ns)
    known = set()
    for num, fname, ptype, rep in fields:
        if fname == _EXTRA_FIELD:
            continue
        known.add(fname)
        v = doc.get(fname)
        if v is None:
            continue
        if ptype == "float":               # vector field: packed floats
            _encode_packed_float(num, list(v), out)
        elif rep and isinstance(v, (list, tuple)):
            if ptype == "sint64":          # packed varints
                body = bytearray()
                for x in v:
                    encode_varint(_zigzag(int(x)), body)
                _tag(num, _WT_LEN, out)
                encode_varint(len(body), out)
                out += body
            elif ptype in ("double",):
                _tag(num, _WT_LEN, out)
                encode_varint(8 * len(v), out)
                for x in v:
                    out += struct.pack("<d", float(x))
            else:                          # repeated string: one tag each
                for x in v:
                    _encode_scalar(num, ptype, x, out)
        else:
            if isinstance(v, (list, tuple)):
                for x in v:
                    _encode_scalar(num, ptype, x, out)
            else:
                _encode_scalar(num, ptype, v, out)
    extra = {k: v for k, v in doc.items() if k not in known}
    if extra:
        _encode_scalar(fields[-1][0], "string",
                       json.dumps(extra, default=str), out)
    return bytes(out)


def _decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def decode_item(ns, data: bytes, fields=None) -> dict:
    """proto3 message bytes -> document dict (inverse of encode_item;
    reference analog: Item::FromProtobuf via the served schema). Unknown
    field numbers are skipped; the trailing `_extra` JSON field is folded
    back into the document."""
    if fields is None:
        fields = _ns_fields(ns)
    by_num = {num: (fname, ptype, rep) for num, fname, ptype, rep in fields}
    doc: dict[str, Any] = {}
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _decode_varint(data, pos)
        num, wt = tag >> 3, tag & 7
        ent = by_num.get(num)
        if wt == _WT_VARINT:
            raw, pos = _decode_varint(data, pos)
            if ent is None:
                continue
            fname, ptype, rep = ent
            v: Any = (bool(raw) if ptype == "bool"
                      else _unzigzag(raw) if ptype == "sint64" else raw)
            _dec_store(doc, fname, v, rep)
        elif wt == _WT_I64:
            if ent is not None:
                _dec_store(doc, ent[0],
                           struct.unpack_from("<d", data, pos)[0], ent[2])
            pos += 8
        elif wt == _WT_I32:
            if ent is not None:
                _dec_store(doc, ent[0],
                           struct.unpack_from("<f", data, pos)[0], ent[2])
            pos += 4
        elif wt == _WT_LEN:
            ln, pos = _decode_varint(data, pos)
            raw = data[pos: pos + ln]
            pos += ln
            if ent is None:
                continue
            fname, ptype, rep = ent
            if fname == _EXTRA_FIELD:
                try:
                    doc.update(json.loads(raw.decode("utf-8")))
                except Exception:
                    pass
            elif ptype == "float":            # packed floats (vector)
                doc[fname] = list(
                    struct.unpack(f"<{ln // 4}f", raw))
            elif ptype == "double":           # packed doubles
                for i in range(0, ln, 8):
                    _dec_store(doc, fname,
                               struct.unpack_from("<d", raw, i)[0], True)
            elif ptype == "sint64":           # packed varints
                p = 0
                while p < ln:
                    x, p = _decode_varint(raw, p)
                    _dec_store(doc, fname, _unzigzag(x), True)
            else:
                _dec_store(doc, fname, raw.decode("utf-8"), rep)
        else:
            raise ValueError(f"bad wire type {wt}")
    return doc


def _dec_store(doc: dict, fname: str, v: Any, rep: bool) -> None:
    if rep:
        doc.setdefault(fname, []).append(v)
    else:
        doc[fname] = v


def encode_query_results(ns, payload: dict) -> bytes:
    """JSON-shaped query-result envelope -> QueryResults message bytes
    (reference: httpserver.cc:1752 queryResultsProtobuf)."""
    out = bytearray()
    fields = _ns_fields(ns)
    for doc in payload.get("items", []):
        body = encode_item(ns, doc, fields)
        _tag(1, _WT_LEN, out)
        encode_varint(len(body), out)
        out += body
    for key, num in (("total_items", F_TOTAL_ITEMS),
                     ("query_total_items", F_QUERY_TOTAL_ITEMS)):
        if key in payload:
            _tag(num, _WT_VARINT, out)
            encode_varint(_zigzag(int(payload[key])), out)
    if "cache_enabled" in payload:
        _tag(F_CACHE_ENABLED, _WT_VARINT, out)
        encode_varint(1 if payload["cache_enabled"] else 0, out)
    if payload.get("explain") is not None:
        _encode_scalar(F_EXPLAIN, "string",
                       json.dumps(payload["explain"], default=str), out)
    for agg in payload.get("aggregations", []) or []:
        _encode_scalar(F_AGGREGATIONS, "string",
                       json.dumps(agg, default=str), out)
    return bytes(out)

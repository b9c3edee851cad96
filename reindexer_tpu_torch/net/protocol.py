"""Port of reindexer_tpu/net/protocol.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

Binary RPC framing + command set.

Semantic equivalent of the reference cproto protocol
(cpp_src/net/cproto/cproto.h command enum; framed header + varint args).
Frame layout (little-endian):

    magic   u32 = 0x52585450 ("RXTP")
    seq     u32   request/response correlation id
    cmd     u16   Cmd value (response echoes the request cmd)
    status  u16   0 = OK; else error code (response only; 0 in requests)
    len     u32   body length
    body    varint-tagged args (net/serializer.py)

Errors carry (code, message) as the response body.
"""
from __future__ import annotations

import enum
import struct

MAGIC = 0x52585450
HEADER = struct.Struct("<IIHHI")
HEADER_SIZE = HEADER.size


class Cmd(enum.IntEnum):
    PING = 0
    LOGIN = 1                  # (user, password, db_name)
    OPEN_NAMESPACE = 16        # (ns_name, indexes_json)
    DROP_NAMESPACE = 17
    TRUNCATE_NAMESPACE = 18
    ENUM_NAMESPACES = 19
    ADD_INDEX = 21             # (ns, index_def_json)
    UPDATE_INDEX = 22
    DROP_INDEX = 23
    MODIFY_ITEM = 33           # (ns, mode, doc_json) modes: 0 upsert 1 insert 2 update 3 delete
    SELECT_SQL = 48            # (sql, fetch_limit) -> (req_id, total, items...)
    SELECT_DSL = 49            # (dsl_json, fetch_limit)
    FETCH_RESULTS = 50         # (req_id, offset, limit)
    CLOSE_RESULTS = 51         # (req_id)
    BEGIN_TX = 64              # (ns) -> tx_id
    TX_MODIFY = 65             # (tx_id, mode, doc_json)
    COMMIT_TX = 66
    ROLLBACK_TX = 67
    PUT_META = 80              # (ns, key, value)
    GET_META = 81
    ENUM_META = 82

    # events on the RPC plane (reference: cproto.h kCmdSubscribeUpdates=90
    # kCmdUpdates=91; rpcserver.cc:1226-1248,1378 — subscribe with a filter
    # config, events PUSHED as unsolicited seq-0 frames on the connection)
    SUBSCRIBE_UPDATES = 90     # (flag, subscription_opts_json)
    UPDATES_PUSH = 91          # server -> client: (event_json, ...)

    GET_SNAPSHOT = 96          # replication verbs (rpcserver.cc:1382-1384)
    GET_UPDATES = 97
    GET_SNAPSHOT_META = 98     # chunked force-sync (namespace/snapshot/):
    GET_SNAPSHOT_CHUNK = 99    # meta first, then (ns, offset, limit) pages

    # RAFT cluster verbs over the wire (reference: rpcserver.cc:1387-1389
    # SuggestLeader/LeadersPing/GetRaftInfo + cluster append stream)
    RAFT_VOTE = 112            # (term, candidate_id, log_len) -> granted
    RAFT_HEARTBEAT = 113       # (term, leader_id, log_len, commit_index)
    RAFT_APPEND = 114          # (record_json, leader_commit) -> accepted
    RAFT_RECORDS_SINCE = 115   # (index) -> records_json
    RAFT_INFO = 116            # () -> info_json
    RAFT_CLIENT_WRITE = 117    # (ns, op, payload_json) proxied write
    RAFT_SET_LEADER = 118      # (server_id) manual leadership transfer


class Status(enum.IntEnum):
    OK = 0
    QUERY_ERROR = 1
    PARAMS_ERROR = 2
    NOT_FOUND = 3
    CONFLICT = 4
    AUTH_ERROR = 5
    INTERNAL = 6
    TIMEOUT = 7


MODIFY_MODES = {0: "upsert", 1: "insert", 2: "update", 3: "delete"}


def pack_frame(seq: int, cmd: int, status: int, body: bytes) -> bytes:
    return HEADER.pack(MAGIC, seq, cmd, status, len(body)) + body


def unpack_header(raw: bytes) -> tuple[int, int, int, int]:
    magic, seq, cmd, status, length = HEADER.unpack(raw)
    if magic != MAGIC:
        raise ValueError("bad frame magic")
    return seq, cmd, status, length

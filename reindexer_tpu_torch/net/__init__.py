"""Port of reindexer_tpu/net/__init__.py: a copy of the reference's package
(host only).

The reference's notes follow.

Binary RPC plane (cproto analog): varint wire serializer, framed
protocol, asyncio server, sync client. Reference: cpp_src/net/cproto/ +
server/rpcserver.cc (SURVEY.md §2.3)."""

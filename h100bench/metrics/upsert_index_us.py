"""Set-up's us a document inside the indexes' upserts: the program's
`ns.upsert_index_ns` over `ns.upserts`, both counted over set-up's
db.upsert calls (from the probes' lookup, before them, to the window's
opening). `upsert_us` less this is the rest of a document's load."""
from h100bench.harness import program

PROBES = ("program.ns.upserts", "program.ns.upsert_index_ns")


def read(r):
    docs = program.setup_count(r, "ns.upserts")
    index_ns = program.setup_count(r, "ns.upsert_index_ns")
    if not docs or index_ns is None:
        return None
    return index_ns / docs / 1e3

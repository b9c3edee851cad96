"""Seconds of the HNSW graph build: the longest commit of set-up (the
first select commits every pending row, which builds the graph)."""

PROBES = ("commit",)


def read(r):
    a, _ = r.window
    commits = [e - s for s, e, _ in r.spans.get("commit", ()) if e <= a]
    if not commits:
        return None
    return max(commits)

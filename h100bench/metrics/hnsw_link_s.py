"""Host seconds of the HNSW build's linking: inside set-up's longest
`hnsw.commit` (the first select's build of every row), its
`hnsw.build.link` span less the `hnsw.build.wait` spans in it (the reads
of each chunk's selected neighbours from the device)."""
from h100bench.harness import program

PROBES = ("program.hnsw.commit", "program.hnsw.build.link",
          "program.hnsw.build.wait")


def read(r):
    a, _ = r.window
    commits = [s for s in program.spans("hnsw.commit") if s[2] <= a]
    if not commits:
        return None
    commit = max(commits, key=lambda s: s[2] - s[1])
    links = [s for s in program.spans("hnsw.build.link")
             if s[5] == commit[4]]
    if not links:
        return None
    ids = {s[4] for s in links}
    waits = [s for s in program.spans("hnsw.build.wait") if s[5] in ids]
    return (sum(s[2] - s[1] for s in links)
            - sum(s[2] - s[1] for s in waits))

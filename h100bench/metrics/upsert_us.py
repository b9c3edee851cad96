"""Set-up's load seconds by the public db.upsert, per document."""

PROBES = ()


def read(r):
    if not r.setup.get("docs"):
        return None
    return 1e6 * r.setup["load_s"] / r.setup["docs"]

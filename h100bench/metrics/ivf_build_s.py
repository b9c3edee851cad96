"""Seconds of the IVF build in set-up: the program's `ivf.train` (k-means
over 39 x nlist sampled rows, then the assignment of every row) and
`ivf.reorder` (the list-contiguous copy of the rows on the device) spans
that end before the window opens.

Probes program.ivf.train and program.ivf.reorder check the spans' names,
but the reader does not require them: a program without them (the port
before it had them) reads nothing here and the metric is left out."""
from h100bench.harness import program

PROBES = ("program",)


def read(r):
    a, _ = r.window
    spans = [s for name in ("ivf.train", "ivf.reorder")
             for s in program.spans(name) if s[2] <= a]
    if not spans:
        return None
    return sum(s[2] - s[1] for s in spans)

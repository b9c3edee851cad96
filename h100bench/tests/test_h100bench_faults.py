"""The comparison that decides `correct`, shown to fail: each cell driven
through a whole run (set-up, warm-up, window, comparison) on the CPU at a
small size, with a fault planted in the engine under the timed path, and
with the control (the TF32 reference in the engine's place). Sound runs
pass. The cuda-marked tests do the same on the card."""
import time

import numpy as np
import pytest
import torch

from h100bench.harness import runner, spec
from reindexer_tpu_torch.query import dynbatch

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
ROWS = {"sift-bf": 1500, "deep-hnsw": 1000}


def overrides(cell: str) -> dict:
    config = spec.cell(cell)["config"]
    return {"config": {"rows": ROWS[config]},
            "traffic": {"query_pool": 256, "warmup_s": 0.2,
                        "checked_requests": 1_000_000}}


def run(cell: str, device: str = "cpu", **kw) -> dict:
    torch.set_num_threads(2)
    return runner.run(cell, 2 ** 31 + 77, 1.0, False, time.perf_counter(),
                      device=device, overrides=overrides(cell), **kw)


def wrap_engine(system, change):
    """Plant `change(queries, answers) -> answers` under the engine's
    drain."""
    orig = system.index.select_batch_async

    def faulty(queries, params):
        drain = orig(queries, params)
        return lambda: change(np.asarray(queries), drain())
    system.index.select_batch_async = faulty


def altered(system):
    """An answer altered where it is produced: each answer's last row
    replaced by the next row, its rank kept."""
    def change(queries, answers):
        for a in answers:
            a.ids = a.ids.copy()
            a.ids[-1] = (a.ids[-1] + 1) % system.docs
        return answers
    wrap_engine(system, change)


def half_batch(system):
    """Half of the batch left out: each odd position answered with its
    even neighbour's answer."""
    wrap_engine(system, lambda q, a: [a[i - i % 2] for i in range(len(a))])


def stale(system):
    """State returned unchanged: every dispatch after the first answers
    with the previous dispatch's answers."""
    last = {}

    def change(queries, answers):
        prev = last.get(len(answers), answers)
        last[len(answers)] = answers
        return prev
    wrap_engine(system, change)


def swapped(system):
    """Answers handed to the wrong queries (a coalesced batch's answers
    reversed)."""
    wrap_engine(system, lambda q, a: a[::-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", [altered, half_batch, stale, swapped],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    # one dynbatch leader in flight, so that the window's concurrent
    # selects coalesce behind it: on the CPU a search runs under the
    # namespace lock for 100 ms or more, eight solo leaders seldom are in
    # flight at once, and a fault of a coalesced batch (half_batch,
    # swapped) then had no batch to show in about one run in two
    monkeypatch.setattr(dynbatch, "MAX_INFLIGHT", 1)
    assert not run(cell, fault=fault)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = run(cell, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_passes_and_control_fails(cell, card):
    assert run(cell, device="cuda")["correct"]
    assert not run(cell, device="cuda", control=True)["correct"]

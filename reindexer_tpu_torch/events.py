"""Port of reindexer_tpu/events.py: a copy of the reference's module (host
only; the same wire format).

The reference's notes follow.

Events subsystem: subscriptions to data-change notifications.

Semantic equivalent of the reference events stack
(cpp_src/events/observer.h UpdatesObservers + listener.cc batched dispatch;
Go side events/eventshandler.go): subscribers register with a filter
(namespaces, event types) and receive batched events through a bounded
queue. Events originate from the namespace WAL hooks — the same stream that
feeds persistence and replication.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable, Optional

# event types mirror the reference's observable WAL records
EVENT_TYPES = ("upsert", "delete", "truncate", "add_index", "drop_index",
               "put_meta", "delete_meta")


@dataclasses.dataclass
class Event:
    namespace: str
    type: str
    lsn: int
    payload: dict
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {"namespace": self.namespace, "type": self.type,
                "lsn": self.lsn, "timestamp": self.timestamp,
                **({"item": self.payload.get("doc")}
                   if "doc" in self.payload else {})}


@dataclasses.dataclass
class EventSubscriberConfig:
    """(reference: EventSubscriberConfig in events/subscriber_config.h)"""

    namespaces: tuple[str, ...] = ()        # empty = all
    event_types: tuple[str, ...] = ()       # empty = all
    max_queue: int = 4096
    with_doc: bool = True


class Subscription:
    def __init__(self, cfg: EventSubscriberConfig):
        self.cfg = cfg
        self._q: "queue.Queue[Event]" = queue.Queue(maxsize=cfg.max_queue)
        self.dropped = 0
        self.closed = False

    def _offer(self, ev: Event) -> None:
        if self.closed:
            return
        try:
            self._q.put_nowait(ev)
        except queue.Full:
            # bounded queue: drop oldest (reference drops on overflow too)
            self.dropped += 1
            try:
                self._q.get_nowait()
                self._q.put_nowait(ev)
            except queue.Empty:
                pass

    def matches(self, ev: Event) -> bool:
        c = self.cfg
        if c.namespaces and ev.namespace not in c.namespaces:
            return False
        if c.event_types and ev.type not in c.event_types:
            return False
        return True

    def poll(self, timeout: Optional[float] = 0.0,
             max_events: int = 256) -> list[Event]:
        """Batched fetch (reference: batched dispatch loop, listener.cc)."""
        out: list[Event] = []
        try:
            first = self._q.get(timeout=timeout) if timeout else \
                self._q.get_nowait()
            out.append(first)
        except queue.Empty:
            return out
        while len(out) < max_events:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return out

    def __iter__(self):
        while not self.closed:
            for ev in self.poll(timeout=0.1):
                yield ev

    def close(self) -> None:
        self.closed = True


class EventsObserver:
    """Fan-out of namespace WAL events to subscribers
    (reference: UpdatesObservers, events/observer.h)."""

    def __init__(self):
        self._subs: list[Subscription] = []
        self._lock = threading.Lock()
        self._lsn = 0

    def attach_db(self, db) -> None:
        """Hook every current and future namespace of a Reindexer."""
        db._events_observer = self
        for name in db.namespace_names():
            self.attach_namespace(db.get_namespace(name))
        orig_open = db.open_namespace

        def open_and_hook(name, indexes=()):
            # hook BEFORE the initial indexes are added so their add_index
            # events reach subscribers
            had = name in db._namespaces
            ns = orig_open(name, ())
            if not had:
                self.attach_namespace(ns)
            for idef in indexes:
                ns.add_index(idef)
            return ns

        db.open_namespace = open_and_hook

    def attach_namespace(self, ns) -> None:
        ns.wal_hooks.append(
            lambda op, payload, _n=ns.name: self.publish(_n, op, payload))

    def publish(self, ns_name: str, op: str, payload: dict) -> None:
        if op not in EVENT_TYPES:
            return
        with self._lock:
            self._lsn += 1
            ev = Event(ns_name, op, self._lsn, payload)
            for sub in self._subs:
                if sub.matches(ev):
                    sub._offer(ev)

    def subscribe(self, cfg: Optional[EventSubscriberConfig] = None,
                  ) -> Subscription:
        sub = Subscription(cfg or EventSubscriberConfig())
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        sub.close()
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

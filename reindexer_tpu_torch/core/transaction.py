"""Transactions.

Semantic equivalent of the reference local transactions
(cpp_src/core/transaction/: LocalTransaction accumulates steps, commit
applies them atomically under a unique namespace lock). The TPU twist
(reference P3, tx_concurrent_inserter.h:160): vector-index mutations buffer
host-side during the tx and flush to device in one batched scatter at
commit — the batched analog of the reference's multithreaded tx vector
insertion.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .errors import LogicError
from ..query.query import Query


@dataclasses.dataclass
class _TxStep:
    op: str                 # upsert | insert | update | delete | update_query | delete_query | put_meta
    doc: Optional[dict] = None
    query: Optional[Query] = None
    meta_kv: Optional[tuple[str, str]] = None
    precepts: Optional[list] = None   # atomic on-update functions


class Transaction:
    def __init__(self, db, ns_name: str):
        self._db = db
        self._ns_name = ns_name
        self._steps: list[_TxStep] = []
        self._finished = False

    def _check(self) -> None:
        if self._finished:
            raise LogicError("transaction already committed or rolled back")

    def upsert(self, doc: dict, precepts: Optional[list[str]] = None
               ) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("upsert", doc=doc, precepts=precepts))
        return self

    def insert(self, doc: dict, precepts: Optional[list[str]] = None
               ) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("insert", doc=doc, precepts=precepts))
        return self

    def update(self, doc: dict, precepts: Optional[list[str]] = None
               ) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("update", doc=doc, precepts=precepts))
        return self

    def delete(self, doc: dict) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("delete", doc=doc))
        return self

    def update_query(self, q: Query) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("update_query", query=q))
        return self

    def delete_query(self, q: Query) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("delete_query", query=q))
        return self

    def put_meta(self, key: str, value: str) -> "Transaction":
        self._check()
        self._steps.append(_TxStep("put_meta", meta_kv=(key, value)))
        return self

    def __len__(self) -> int:
        return len(self._steps)

    def commit(self) -> int:
        """Apply all steps atomically under the namespace lock
        (reference: NamespaceImpl::CommitTransaction)."""
        self._check()
        ns = self._db.get_namespace(self._ns_name)
        sel = self._db._selecter
        applied = 0
        with ns.lock:
            for step in self._steps:
                if step.op in ("upsert", "insert", "update"):
                    ns.upsert(step.doc, mode=step.op,
                              precepts=step.precepts)
                elif step.op == "delete":
                    ns.delete(step.doc)
                elif step.op == "update_query":
                    sel.update(step.query)
                elif step.op == "delete_query":
                    sel.delete(step.query)
                elif step.op == "put_meta":
                    ns.put_meta(*step.meta_kv)
                applied += 1
            # one batched device flush for all vector mutations in the tx
            for index in ns.indexes:
                index.commit()
        self._finished = True
        return applied

    def rollback(self) -> None:
        self._check()
        self._steps.clear()
        self._finished = True

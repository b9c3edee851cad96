"""Port of reindexer_tpu/server/embedders.py: a copy of the reference's
module (host only; the same wire format).

The reference's notes follow.

HTTP connector to an external embedder service.

Reference: core/embedding/ (Embedder/HttpConnector talking to a service
implementing embedders_api.yaml: POST {texts: [...]} -> {embeddings: [[...]]})
with an LRU cache keyed by cache_tag (EmbeddersCache).
"""
from __future__ import annotations

import json
import urllib.request
from collections import OrderedDict
from typing import Sequence


class HttpEmbedder:
    def __init__(self, endpoint: str, cache_size: int = 4096, timeout: float = 10.0):
        self.endpoint = endpoint
        self.timeout = timeout
        self._cache: OrderedDict[str, list[float]] = OrderedDict()
        self._cache_size = cache_size

    def __call__(self, texts: Sequence[str]) -> list[list[float]]:
        out: list = [None] * len(texts)
        missing: list[tuple[int, str]] = []
        for i, t in enumerate(texts):
            hit = self._cache.get(t)
            if hit is not None:
                self._cache.move_to_end(t)
                out[i] = hit
            else:
                missing.append((i, t))
        if missing:
            body = json.dumps({"data": [t for _, t in missing]}).encode()
            req = urllib.request.Request(
                self.endpoint, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
            embeddings = payload.get("products") or payload.get("embeddings") or []
            # embedders_api.yaml returns {products: [{embedding: [...]}]} or a
            # plain embeddings list; accept both
            vecs = []
            for e in embeddings:
                vecs.append(e["embedding"] if isinstance(e, dict) else e)
            for (i, t), vec in zip(missing, vecs):
                out[i] = vec
                self._cache[t] = vec
                if len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        return out

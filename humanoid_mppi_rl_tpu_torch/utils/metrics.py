"""Structured metrics: a JSONL event stream and a wall-clock timer
(utils/metrics.py counterpart)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JSONLWriter:
    """Appends one JSON object per `write` to `path`; with path None it
    writes nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def write(self, **event) -> None:
        event.setdefault("t", time.time())
        if self._f:
            self._f.write(json.dumps(event) + "\n")

    def close(self) -> None:
        if self._f:
            self._f.close()


class Timer:
    """Wall-clock timer; `with Timer() as t: ...; t.seconds`."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False

"""Structured timing spans (port of spittle_tpu/utils/tracing.py without
its device-trace hook): named spans with wall-clock durations, thread-safe
aggregation (count/total/p50/p95) and JSON export."""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


@dataclass
class Span:
    name: str
    start: float
    duration: float
    meta: Dict[str, object] = field(default_factory=dict)


class Tracer:
    def __init__(self, max_spans: int = 10_000):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._max = max_spans

    @contextlib.contextmanager
    def span(self, name: str, **meta) -> Iterator[Dict[str, object]]:
        t0 = time.perf_counter()
        record: Dict[str, object] = dict(meta)
        try:
            yield record
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._spans.append(Span(name, t0, dt, record))
                if len(self._spans) > self._max:
                    del self._spans[: self._max // 2]

    def record(self, name: str, duration: float, **meta) -> None:
        with self._lock:
            self._spans.append(Span(name, time.perf_counter(), duration, meta))

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            if name is None:
                return list(self._spans)
            return [s for s in self._spans if s.name == name]

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            by_name: Dict[str, List[float]] = {}
            for s in self._spans:
                by_name.setdefault(s.name, []).append(s.duration)
        out = {}
        for name, ds in by_name.items():
            ds = sorted(ds)
            n = len(ds)
            out[name] = {
                "count": n,
                "total_s": sum(ds),
                "mean_s": sum(ds) / n,
                "p50_s": ds[n // 2],
                "p95_s": ds[min(n - 1, int(n * 0.95))],
                "max_s": ds[-1],
            }
        return out

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stats(), f, indent=2)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def span(name: str, **meta):
    return _GLOBAL.span(name, **meta)

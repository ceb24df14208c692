"""Per-request span tracing: Chrome-trace / Perfetto-compatible JSONL
(the port's own copy of ``repro.obs.tracing``, which imports no JAX; the
port imports nothing of ``repro``).

One JSON event object per line (the streaming flavor of the Trace Event
Format — ``chrome://tracing`` and Perfetto both ingest it after wrapping in
a ``[...]`` array, which the JAX package's ``repro.launch.obs_report
--to-json`` does; it reads the port's traces as they are). Events use
wall-clock microseconds relative to the writer's creation:

 * ``X`` complete spans — request lifecycle phases (queued / replay /
   decode / request) on tid = request id, and per-step engine phases
   (device vs host time) on the scheduler's tid 0;
 * ``i`` instants — enqueue, admit, shed/evict, tier transitions, index
   swap/restore;
 * ``C`` counters — harvested gauges (queue depth, occupancy, per-tier
   shadow rel-err), drawn as tracks;
 * ``M`` metadata — thread names.

Everything is host-side and append-only. Events buffer as plain dicts in
the serving loop and serialize in batches at ``flush()`` / ``close()`` —
JSON encoding stays off the goodput-critical path, and a crashed run
leaves a readable prefix through the last flush (the buffer also
self-flushes past ``MAX_BUFFERED`` events to bound memory). No external
deps.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional


class TraceWriter:
    PID = 1
    MAX_BUFFERED = 16384

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")
        self._t0 = time.perf_counter()
        self._named_tids: set = set()
        self._buf: List[dict] = []
        self.events_written = 0
        self.name_thread(0, "scheduler")

    def _ts(self, t: Optional[float]) -> float:
        """Wall stamp (time.perf_counter seconds) -> trace µs."""
        return ((time.perf_counter() if t is None else t) - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        self._buf.append(ev)
        self.events_written += 1
        if len(self._buf) >= self.MAX_BUFFERED:
            self.flush()

    def name_thread(self, tid: int, name: str) -> None:
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._emit({"ph": "M", "name": "thread_name", "pid": self.PID,
                    "tid": tid, "args": {"name": name}})

    def span(self, name: str, t_start: float, t_end: float, tid: int = 0,
             cat: str = "serve", args: Optional[dict] = None) -> None:
        ts = self._ts(t_start)
        self._emit({"ph": "X", "name": name, "cat": cat, "pid": self.PID,
                    "tid": tid, "ts": ts,
                    "dur": max(self._ts(t_end) - ts, 0.0),
                    "args": args or {}})

    def instant(self, name: str, t: Optional[float] = None, tid: int = 0,
                cat: str = "serve", args: Optional[dict] = None) -> None:
        self._emit({"ph": "i", "name": name, "cat": cat, "pid": self.PID,
                    "tid": tid, "ts": self._ts(t), "s": "t",
                    "args": args or {}})

    def counter(self, name: str, values: dict,
                t: Optional[float] = None) -> None:
        self._emit({"ph": "C", "name": name, "pid": self.PID, "tid": 0,
                    "ts": self._ts(t),
                    "args": {k: float(v) for k, v in values.items()}})

    def flush(self) -> None:
        if self._buf:
            self._f.write("".join(
                json.dumps(ev, separators=(",", ":")) + "\n"
                for ev in self._buf))
            self._buf.clear()
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

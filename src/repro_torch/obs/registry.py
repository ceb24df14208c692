"""Metrics registry: one host-side map of named metrics with Prometheus
text exposition and JSON snapshots. Stdlib only (the port's own copy of
``repro.obs.registry``; the port imports nothing of ``repro``).

The registry is a sink — ``obs.Observability`` pushes harvested device
counters and server gauges into it; consumers pull either the Prometheus
text format (``GET /metrics`` on the optional HTTP server) or a JSON
snapshot (``GET /snapshot``, or periodic file writes). Values are plain
floats; labeled series are dicts keyed by a single label value (the
estimator tier everywhere in this repo).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

_VALID_TYPES = ("counter", "gauge", "histogram")


class MetricsRegistry:
    def __init__(self, prefix: str = "repro"):
        self.prefix = prefix
        self._lock = threading.Lock()
        # name -> (type, help, {labels_tuple: value})
        self._metrics: Dict[str, Tuple[str, str, dict]] = {}
        self._server: Optional[ThreadingHTTPServer] = None

    def set(self, name: str, value, labels: Optional[dict] = None,
            mtype: str = "gauge", help: str = "") -> None:
        assert mtype in _VALID_TYPES, mtype
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                ent = (mtype, help, {})
                self._metrics[name] = ent
            ent[2][key] = float(value)

    def set_many(self, values: dict, labels: Optional[dict] = None,
                 mtype: str = "gauge") -> None:
        for name, v in values.items():
            self.set(name, v, labels=labels, mtype=mtype)

    def get(self, name: str, labels: Optional[dict] = None):
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            ent = self._metrics.get(name)
            return None if ent is None else ent[2].get(key)

    def snapshot(self) -> dict:
        """JSON-ready view: {name: value} for unlabeled series,
        {name: {label_value: value}} for labeled ones."""
        out: dict = {}
        with self._lock:
            for name, (_, _, series) in sorted(self._metrics.items()):
                if list(series) == [()]:
                    out[name] = series[()]
                else:
                    out[name] = {"/".join(v for _, v in key): val
                                 for key, val in sorted(series.items())}
        return out

    def write_snapshot(self, path: str, extra: Optional[dict] = None) -> None:
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        with self._lock:
            for name, (mtype, help_, series) in sorted(self._metrics.items()):
                full = f"{self.prefix}_{name}"
                if help_:
                    lines.append(f"# HELP {full} {help_}")
                lines.append(f"# TYPE {full} {mtype}")
                for key, val in sorted(series.items()):
                    if key:
                        lbl = ",".join(f'{k}="{v}"' for k, v in key)
                        lines.append(f"{full}{{{lbl}}} {val:g}")
                    else:
                        lines.append(f"{full} {val:g}")
        return "\n".join(lines) + "\n"

    # -- optional HTTP exposition -------------------------------------------

    def serve(self, port: int, host: str = "127.0.0.1") -> int:
        """Start a daemon-threaded exposition server; returns the bound
        port (pass port=0 for an ephemeral one)."""
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.rstrip("/") in ("", "/metrics"):
                    body = registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.rstrip("/") == "/snapshot":
                    body = (json.dumps(registry.snapshot(), sort_keys=True)
                            + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # no stderr chatter per scrape
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self._server.server_address[1]

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

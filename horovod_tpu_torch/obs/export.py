"""Export surfaces: Prometheus text exposition, JSON snapshot, HTTP.

Counterpart of ``horovod_tpu/obs/export.py``.  One registry, three read
paths, one renderer each:

* :func:`json_snapshot` — the machine-readable dict (every family's
  series, rank and world from ``torch.distributed``, the autotune
  decision log).
* :func:`render_prometheus` — text exposition format v0.0.4 for any
  Prometheus-compatible scraper, byte for byte the reference's for the
  same registry contents.  Counters and gauges render as themselves;
  ring-backed histograms render as real Prometheus *histograms*:
  cumulative ``_bucket{le="..."}`` series over the ``BUCKET_BOUNDS``
  ladder plus ``_sum``/``_count``, with ``le="+Inf"`` carrying the exact
  all-time count.  The computed p50/p90/p99 stay in the JSON snapshot.
* :func:`start_http_exporter` — the local scrape port
  (``HVD_TPU_METRICS_PORT``): ``GET /metrics`` (Prometheus) and ``GET
  /metrics.json``.  Daemon-threaded, fail-soft (a taken port warns and
  disables — observability must never kill the job), one per rank
  (``hvd.init`` offsets the port by the rank).

The reference's ``MetricsRequest`` over its authenticated control plane
waits for the port's runner network.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from . import instrument as _instr
from . import metrics as _m

logger = logging.getLogger(__name__)

__all__ = ["json_snapshot", "render_prometheus", "start_http_exporter",
           "stop_http_exporter"]


def json_snapshot(reg: Optional[_m.MetricsRegistry] = None) -> Dict[str, Any]:
    """JSON-ready snapshot: every family's series plus provenance
    (wall-clock stamp, rank/world when initialized) and the bounded
    autotune decision log."""
    reg = reg or _m.registry()
    out: Dict[str, Any] = {
        "ts_unix": time.time(),
        "metrics": reg.snapshot(),
    }
    log = _instr.autotune_log()
    if log:
        out["autotune_log"] = log
    from .. import basics

    if basics.is_initialized():
        import torch.distributed as dist

        out["rank"] = dist.get_rank()
        out["world"] = dist.get_world_size()
        out["slots"] = basics.size()
    return out


# --- Prometheus text exposition ---------------------------------------------

def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: Dict[str, str],
                extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_esc_label(str(v))}"'
                    for k, v in sorted(merged.items()))
    return "{" + body + "}"


def render_prometheus(reg: Optional[_m.MetricsRegistry] = None) -> str:
    """Text exposition format: one ``# HELP``/``# TYPE`` header per
    family (the registry keys families by name, so duplicates cannot
    occur), histograms with cumulative buckets (see module docstring).
    Unset gauges render no sample lines — absent beats fabricated
    zero."""
    reg = reg or _m.registry()
    lines: List[str] = []
    for fam in reg.collect():
        name, kind = fam["name"], fam["kind"]
        prom_type = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}[kind]
        if fam["help"]:
            lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
        lines.append(f"# TYPE {name} {prom_type}")
        for series in fam["series"]:
            labels = series.get("labels", {})
            if kind == "histogram":
                for le, cum in series.get("buckets", []):
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_str(labels, {'le': _fmt_value(le)})}"
                        f" {cum}")
                lines.append(
                    f"{name}_bucket{_labels_str(labels, {'le': '+Inf'})}"
                    f" {series['count']}")
                lines.append(f"{name}_sum{_labels_str(labels)} "
                             f"{_fmt_value(series['sum'])}")
                lines.append(f"{name}_count{_labels_str(labels)} "
                             f"{_fmt_value(series['count'])}")
            else:
                v = series.get("value")
                if v is None:
                    continue
                lines.append(f"{name}{_labels_str(labels)} {_fmt_value(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


# --- local HTTP scrape port --------------------------------------------------

class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib handler contract)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = render_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path in ("/metrics.json", "/json"):
            body = json.dumps(json_snapshot()).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not log lines
        pass


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


_server: Optional[_Server] = None   # guarded-by: _server_lock
_server_lock = threading.Lock()


def start_http_exporter(port: int,
                        host: str = "127.0.0.1") -> Optional[int]:
    """Serve ``/metrics`` + ``/metrics.json`` on ``host:port`` from a
    daemon thread; returns the bound port (0 picks one) or None when the
    bind fails (warn, never raise — see module docstring).  Idempotent:
    a second call returns the live port.

    Loopback by default: this endpoint is unauthenticated (a node-local
    sidecar can proxy it).  Pass ``host`` explicitly to widen on
    purpose."""
    global _server
    with _server_lock:
        if _server is not None:
            return _server.server_address[1]
        try:
            _server = _Server((host, int(port)), _MetricsHandler)
        except OSError as e:
            logger.warning(
                "metrics HTTP exporter disabled: cannot bind %s:%d (%s)",
                host, port, e)
            return None
        threading.Thread(target=_server.serve_forever, daemon=True,
                         name="hvd-tpu-metrics-exporter").start()
        bound = _server.server_address[1]
        logger.info("metrics exporter listening on %s:%d "
                    "(/metrics, /metrics.json)", host, bound)
        return bound


def stop_http_exporter() -> None:
    global _server
    with _server_lock:
        if _server is None:
            return
        _server.shutdown()
        _server.server_close()
        _server = None

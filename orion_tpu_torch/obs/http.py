"""Live exposition: a daemon-thread stdlib HTTP server per process. The
port's copy of ``orion_tpu/obs/http.py``, whole (it imports no jax and no
torch).

The metrics dump is file-shaped (periodic atomic dumps); a balancer,
a Prometheus scraper, or an operator mid-incident needs a LIVE endpoint.
:class:`ObsHTTPServer` is the smallest thing that is one: a
``ThreadingHTTPServer`` on a daemon thread serving four routes, each
backed by a provider callable the owner registers at construction:

- ``/metrics`` — Prometheus text rendered from ONE ``metrics_fn()``
  snapshot (``/metrics.json`` returns the same snapshot as JSON — the
  wire format :func:`~orion_tpu_torch.obs.metrics.aggregate` consumes).
- ``/healthz`` — the health payload from ``health_fn()`` as JSON, with
  the HTTP status code taken from the payload's ``"code"`` key (the
  serving layer maps it from the ``HealthMachine`` state — see
  ``serving/health.py::HTTP_STATUS``); a payload without a code falls
  back to 200 when ``"accepting"`` is truthy, 503 otherwise.
- ``/statusz`` — the human debug page: ``statusz_fn()``'s dict rendered
  as sectioned preformatted text (slots prefilling/decoding, resident
  sessions, ladder counters, error budgets, the flight-ring tail).
- ``/slo`` — ``slo_fn()``'s payload as JSON (burn rates, alerts, error
  budgets — what ``SLOEngine.state()`` returns).
- ``/costz`` — ``costz_fn()``'s dict rendered as sectioned text (the
  program cost ledger, attribution totals, live capacity/
  headroom); ``/costz.json`` returns the raw payload.
- ``/profilez?chunks=K`` — ``profilez_fn({"chunks": K})``: arms an
  on-demand profiler capture for the next K chunk boundaries. The
  provider only SETS host flags (the serving layer starts/stops the
  actual profiler on its scheduler thread); a payload carrying a
  ``"code"`` key sets the HTTP status (409 when disabled/busy).

Contract: this module imports no torch, and every provider callable
registered via the ``*_fn`` keywords reads host state only: a scrape
must never read the card. The liveness half: handler threads and scrape reads must
never block unboundedly on a lock or queue (providers hold their locks
for one snapshot, never across I/O). A provider that raises yields a
500 with the exception name — a broken gauge must never take the
endpoint (or the server) down.

Route NOT found -> 404; provider not registered -> 404 too (a fleet
parent exposes only the aggregated routes it has providers for).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from orion_tpu_torch.obs.metrics import prometheus_from_snapshot


def _render_statusz(doc: dict) -> str:
    """Sectioned plain-text rendering of a nested status dict — the
    smallest thing an operator can read in a terminal via curl."""
    lines = ["orion-tpu /statusz", "=" * 40]
    for key in doc:
        val = doc[key]
        lines.append("")
        lines.append(f"[{key}]")
        if isinstance(val, dict):
            for k in val:
                lines.append(f"  {k}: {json.dumps(val[k], default=repr)}")
        elif isinstance(val, (list, tuple)):
            for item in val:
                lines.append(f"  - {json.dumps(item, default=repr)}")
        else:
            lines.append(f"  {json.dumps(val, default=repr)}")
    return "\n".join(lines) + "\n"


class ObsHTTPServer:
    """One per process (or per Server in tests). ``port=0`` binds an
    ephemeral port — :meth:`start` returns the bound port. All provider
    callables are optional; missing ones 404 their route."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        metrics_fn: Optional[Callable[[], dict]] = None,
        health_fn: Optional[Callable[[], dict]] = None,
        statusz_fn: Optional[Callable[[], dict]] = None,
        slo_fn: Optional[Callable[[], dict]] = None,
        costz_fn: Optional[Callable[[], dict]] = None,
        profilez_fn: Optional[Callable[[dict], dict]] = None,
    ):
        self._want_port = port
        self._host = host
        self._providers = {
            "metrics": metrics_fn,
            "health": health_fn,
            "statusz": statusz_fn,
            "slo": slo_fn,
            "costz": costz_fn,
            "profilez": profilez_fn,
        }
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        """Bind and serve on a daemon thread; returns the bound port."""
        assert self._httpd is None, "already started"
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 - quiet
                pass  # scrapes must not spam the serving process's stderr

            def do_GET(self):
                owner._handle(self)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"obs-http-{self.port}", daemon=True,
        )
        self._thread.start()
        return self.port

    def close(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    # -- request handling (runs on the handler pool's daemon threads) ---------

    def _call(self, handler, name: str):
        """Run one provider; (payload, None) on success, (None, done)
        after an error/404 reply was already sent."""
        fn = self._providers.get(name)
        if fn is None:
            self._reply(handler, 404, "text/plain",
                        f"no {name} provider registered\n")
            return None, True
        try:
            return fn(), False
        except Exception as e:  # a broken gauge must not kill the endpoint
            self._reply(handler, 500, "text/plain",
                        f"{name} provider failed: {type(e).__name__}: {e}\n")
            return None, True

    def _call_with(self, handler, name: str, arg):
        """Like :meth:`_call` but for providers taking one argument
        (the parsed query dict)."""
        fn = self._providers.get(name)
        if fn is None:
            self._reply(handler, 404, "text/plain",
                        f"no {name} provider registered\n")
            return None, True
        try:
            return fn(arg), False
        except Exception as e:
            self._reply(handler, 500, "text/plain",
                        f"{name} provider failed: {type(e).__name__}: {e}\n")
            return None, True

    @staticmethod
    def _query(handler) -> dict:
        parts = handler.path.split("?", 1)
        out = {}
        if len(parts) == 2:
            for kv in parts[1].split("&"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    out[k] = v
        return out

    def _handle(self, handler) -> None:
        path = handler.path.split("?", 1)[0]
        if path == "/metrics":
            snap, done = self._call(handler, "metrics")
            if not done:
                self._reply(handler, 200, "text/plain; version=0.0.4",
                            prometheus_from_snapshot(snap))
        elif path == "/metrics.json":
            snap, done = self._call(handler, "metrics")
            if not done:
                self._reply_json(handler, 200, snap)
        elif path == "/healthz":
            payload, done = self._call(handler, "health")
            if not done:
                code = payload.get("code")
                if code is None:
                    code = 200 if payload.get("accepting") else 503
                self._reply_json(handler, code, payload)
        elif path == "/statusz":
            doc, done = self._call(handler, "statusz")
            if not done:
                self._reply(handler, 200, "text/plain",
                            _render_statusz(doc))
        elif path == "/slo":
            payload, done = self._call(handler, "slo")
            if not done:
                self._reply_json(handler, 200, payload)
        elif path == "/costz":
            doc, done = self._call(handler, "costz")
            if not done:
                self._reply(handler, 200, "text/plain",
                            _render_statusz(doc))
        elif path == "/costz.json":
            doc, done = self._call(handler, "costz")
            if not done:
                self._reply_json(handler, 200, doc)
        elif path == "/profilez":
            payload, done = self._call_with(
                handler, "profilez", self._query(handler)
            )
            if not done:
                code = payload.pop("code", 200) if isinstance(
                    payload, dict
                ) else 200
                self._reply_json(handler, code, payload)
        else:
            self._reply(handler, 404, "text/plain",
                        "routes: /metrics /metrics.json /healthz "
                        "/statusz /slo /costz /profilez?chunks=K\n")

    @staticmethod
    def _reply(handler, code, ctype: str, body: str) -> None:
        data = body.encode("utf-8")
        try:
            # the whole reply is guarded, headers included: a prober
            # that disconnects between connect and reply would raise
            # from send_response's header write, and an unhandled
            # handler exception makes socketserver print a traceback to
            # the serving process's stderr on every aborted probe
            handler.send_response(code)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # the scraper hung up mid-reply; nothing to do

    @classmethod
    def _reply_json(cls, handler, code, payload) -> None:
        cls._reply(handler, code, "application/json",
                   json.dumps(payload, indent=1, default=repr) + "\n")


__all__ = ["ObsHTTPServer"]

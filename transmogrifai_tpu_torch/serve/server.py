"""Stdlib-only JSON scoring endpoint over the micro-batcher.

The port's copy of ``transmogrifai_tpu/serve/server.py`` for the default
tenant.  ``ThreadingHTTPServer`` (a thread a connection) in front of the
bounded admission queue: handler threads only parse JSON, submit to the
batcher and wait on their futures; the scoring runs on the slot workers.
When the queue is full the request is rejected at once with HTTP 429.

Endpoints:

- ``POST /score``: body one record object, a list of records, or
  ``{"records": [...]}``; the response carries the scoring model's version.
  Records that break the input contract fail per row: HTTP 422 with
  ``errors`` entries ``{"index", "reason", ...}`` and ``scores`` still filled
  for the valid rows (a non-list body or a non-object list item is a
  structural 400, also row-indexed).  A named tenant is HTTP 501 (not
  ported, ROADMAP Queue 1 item 3).
- ``POST /models``: hot swap, ``{"path": "<saved model dir>", "version":
  "v2"?}`` loads the model on the registry's card, warms and swaps it.
- ``GET /metrics``: the serve metrics snapshot with the registry, queue,
  SLO and resilience state; ``GET /metrics?format=prometheus`` renders the
  obs registry's snapshot in Prometheus text exposition format.
- ``GET /models``: registry info (active version, history, buckets).
- ``GET /healthz``: 200 once a warmed model is active, else 503.
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from .. import obs
from ..resilience.quarantine import DataFault
from .batcher import MicroBatcher, ShedError
from .metrics import ServeMetrics, prometheus_replica_text
from .registry import DEFAULT_TENANT, ModelRegistry


class ModelServer:
    """Owns the batcher + HTTP front end; start()/stop() or serve_forever()."""

    def __init__(self, registry: ModelRegistry, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 64, max_wait_ms: float = 2.0,
                 queue_size: int = 1024, request_timeout_s: float = 30.0,
                 metrics: Optional[ServeMetrics] = None):
        self.registry = registry
        self.metrics = metrics or registry.metrics or ServeMetrics()
        if registry.metrics is None:
            registry.metrics = self.metrics
        self.batcher = MicroBatcher(registry, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    queue_size=queue_size, metrics=self.metrics)
        self.request_timeout_s = float(request_timeout_s)
        self._host, self._port = host, int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # ---- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    def start(self) -> "ModelServer":
        if self._httpd is not None:
            return self
        self.batcher.start()
        handler = _make_handler(self)
        # stdlib default listen backlog is 5: a fleet-sized burst of
        # concurrent connects gets kernel RSTs before accept() catches up.
        # Shedding is the batcher's job — the listener must keep accepting.
        server_cls = type("_ModelHTTPServer", (ThreadingHTTPServer,),
                          {"request_queue_size": 128})
        self._httpd = server_cls((self._host, self._port), handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._stopped.clear()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None
        self.batcher.stop()
        self._stopped.set()

    def wait(self, duration_s: Optional[float] = None) -> None:
        """Block until ``stop()`` (or for ``duration_s``); Ctrl-C stops cleanly."""
        try:
            self._stopped.wait(duration_s)
        except KeyboardInterrupt:
            pass

    def serve_forever(self, duration_s: Optional[float] = None) -> None:
        self.start()
        try:
            self.wait(duration_s)
        finally:
            self.stop()


def _make_handler(server: "ModelServer"):
    """Handler class closed over the ModelServer (avoids globals)."""

    class ServeHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # ---- plumbing ------------------------------------------------------
        def log_message(self, fmt, *args):  # quiet: metrics are the log
            pass

        def _reply(self, status: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body_json(self) -> Any:
            length = int(self.headers.get("Content-Length") or 0)
            return json.loads(self.rfile.read(length) or b"null")

        def _reply_text(self, status: int, text: str) -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # ---- GET -----------------------------------------------------------
        def do_GET(self):
            url = urlsplit(self.path)
            if url.path == "/metrics":
                fmt = parse_qs(url.query).get("format", [""])[0]
                if fmt == "prometheus":
                    # the obs registry's snapshot, flattened, and the
                    # labelled per-replica series beside it
                    text = obs.prometheus_text(obs.snapshot())
                    text += prometheus_replica_text(server.metrics.snapshot())
                    self._reply_text(200, text)
                    return
                sup = server.batcher.supervisor
                self._reply(200, {"serve": server.metrics.snapshot(),
                                  "registry": server.registry.info(),
                                  "slo": None if sup.slo is None else sup.slo.status(),
                                  "resilience": {
                                      "supervisor": sup.snapshot(),
                                      **obs.registry.scope("resilience").snapshot()}})
            elif self.path == "/models":
                self._reply(200, server.registry.info())
            elif self.path == "/healthz":
                info = server.registry.info()
                ok = info["active"] is not None and info["warmed"]
                self._reply(200 if ok else 503,
                            {"status": "ok" if ok else "no model",
                             "model": info["active"]})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        # ---- POST ----------------------------------------------------------
        def do_POST(self):
            path = urlsplit(self.path).path
            if path == "/score":
                self._score()
            elif path == "/models":
                self._deploy()
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _score(self):
            try:
                body = self._body_json()
            except (ValueError, json.JSONDecodeError):
                self._reply(400, {"error": "invalid JSON body"})
                return
            tenant = parse_qs(urlsplit(self.path).query).get(
                "tenant", [DEFAULT_TENANT])[0] or DEFAULT_TENANT
            if isinstance(body, dict) and "records" in body:
                tenant = body.get("tenant") or tenant
            single = isinstance(body, dict) and "records" not in body
            records = [body] if single else \
                (body["records"] if isinstance(body, dict) else body)
            if not isinstance(records, list):
                self._reply(400, {"error": "expected a record object, a list "
                                           "of records, or {\"records\": [...]}"})
                return
            structural = [
                {"index": i, "reason": "not_an_object",
                 "detail": type(r).__name__}
                for i, r in enumerate(records) if not isinstance(r, dict)]
            if structural:
                # a malformed request STRUCTURE (not record values): reject
                # the body with the offending row indices, never a 500
                self._reply(400, {"error": "expected a record object, a list "
                                           "of records, or {\"records\": [...]}",
                                  "errors": structural})
                return
            futures: list = [None] * len(records)
            row_errors: list = []
            try:
                for i, r in enumerate(records):
                    try:
                        futures[i] = server.batcher.submit(r, tenant=tenant)
                    except DataFault as e:
                        d = e.to_json()
                        d["index"] = i
                        row_errors.append(d)
            except ShedError as e:
                self._reply(429, {"error": str(e), "shed": True})
                return
            except NotImplementedError as e:
                self._reply(501, {"error": str(e)})
                return
            outputs: list = [None] * len(records)
            version = None
            for i, f in enumerate(futures):
                if f is None:
                    continue
                try:
                    s = f.result(server.request_timeout_s)
                    outputs[i] = s.output
                    version = s.version
                except (FutureTimeoutError, TimeoutError):
                    self._reply(503, {"error": "scoring timed out"})
                    return
                except DataFault as e:
                    # a per-row data fault: fail THIS row, keep its batchmates
                    d = e.to_json()
                    d["index"] = i
                    row_errors.append(d)
                except LookupError as e:
                    self._reply(404, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — system errors stay 500
                    self._reply(500, {"error": str(e)})
                    return
            if version is None:
                version = server.registry.active_version()
            if row_errors:
                row_errors.sort(key=lambda d: d["index"])
                payload = {"error": f"{len(row_errors)} of {len(records)} "
                                    "record(s) rejected",
                           "errors": row_errors,
                           "model_version": version}
                if not single:
                    payload["scores"] = outputs
                self._reply(422, payload)
            elif single:
                self._reply(200, {"score": outputs[0],
                                  "model_version": version})
            else:
                self._reply(200, {"scores": outputs,
                                  "model_version": version})

        def _deploy(self):
            try:
                body = self._body_json()
                path = body["path"]
            except Exception:
                self._reply(400, {"error": "expected {\"path\": ..., \"version\"?: ...}"})
                return
            try:
                from ..workflow.model import load_model

                model = load_model(path, server.registry.devices[0])
                entry = server.registry.deploy(model, version=body.get("version"),
                                               tenant=body.get("tenant") or DEFAULT_TENANT)
            except Exception as e:  # noqa: BLE001 — a bad model must not kill serving
                self._reply(400, {"error": f"deploy failed: {e}"})
                return
            self._reply(200, {"active": entry.version,
                              "versions": server.registry.versions()})

    return ServeHandler

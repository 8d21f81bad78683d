"""JSON-RPC 2.0 HTTP server over the stdlib threading HTTPServer.

Parity: jsonrpc/http/JsonRpcHttpServer.scala:30 (akka-http POST + CORS)
+ JsonRpcController dispatch tables. Any public method of the
registered services named like ``eth_...``/``net_...``/``web3_...``
is callable; batch requests supported per the spec.

The port's copy of ``khipu_tpu.jsonrpc.server``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from khipu_tpu_torch.jsonrpc.eth_service import EthService, RpcError

_ALLOWED_PREFIXES = ("eth_", "net_", "web3_", "khipu_", "personal_")


class JsonRpcServer:
    def __init__(self, service: EthService, host: str = "127.0.0.1",
                 port: int = 8546, extra_services: tuple = (),
                 serving=None, max_batch: int = 100,
                 max_body_bytes: int = 2 << 20):
        """``extra_services`` are additional dispatch targets searched
        after the primary service (PersonalService installs here —
        JsonRpcController's per-namespace handler tables).

        ``serving`` is an optional admission/SLO plane
        (serving.ServingPlane): when set, every resolvable method
        passes ``admit``/``finish`` around dispatch — over-limit
        requests come back ``-32005`` instead of queueing in the
        ThreadingHTTPServer without bound. ``max_batch`` /
        ``max_body_bytes`` bound what one POST can ask for (a single
        huge batch is otherwise an amplification lever no concurrency
        limit sees — one socket, thousands of dispatches)."""
        self.service = service
        self.services = (service, *extra_services)
        self.host = host
        self.port = port
        self.serving = serving
        if serving is not None and serving.config is not None:
            max_batch = serving.config.max_batch
            max_body_bytes = serving.config.max_body_bytes
        self.max_batch = max_batch
        self.max_body_bytes = max_body_bytes
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- dispatch

    # methods that sign with (or unlock) keystore keys: a webpage must
    # never reach these through the open-CORS HTTP endpoint — any site
    # could otherwise spend from an unlocked account (the reason geth
    # refuses personal_* over HTTP). Browser requests carry an Origin
    # header; curl/native tooling does not.
    _SIGNING_METHODS = frozenset({"eth_sendTransaction", "eth_sign"})

    @classmethod
    def _is_signing(cls, method: str) -> bool:
        return method.startswith("personal_") or method in cls._SIGNING_METHODS

    def handle(self, request: Any, browser_origin: bool = False) -> Any:
        if isinstance(request, list):  # batch
            if len(request) > self.max_batch:
                return {
                    "jsonrpc": "2.0", "id": None,
                    "error": {
                        "code": -32600,
                        "message": f"batch too large "
                        f"(max {self.max_batch})",
                    },
                }
            return [self._handle_one(r, browser_origin) for r in request]
        return self._handle_one(request, browser_origin)

    def _handle_one(self, req: Any, browser_origin: bool = False) -> Dict:
        if not isinstance(req, dict):
            return {
                "jsonrpc": "2.0", "id": None,
                "error": {"code": -32600, "message": "invalid request"},
            }
        rid = req.get("id")
        method = req.get("method", "")
        params = req.get("params", []) or []
        base = {"jsonrpc": "2.0", "id": rid}
        if not any(method.startswith(p) for p in _ALLOWED_PREFIXES):
            return {**base, "error": {"code": -32601, "message": f"method {method!r} not found"}}
        if browser_origin and self._is_signing(method):
            return {**base, "error": {
                "code": -32601,
                "message": "account methods are not available to "
                "browser origins",
            }}
        fn = next(
            (
                f
                for s in self.services
                for f in (getattr(s, method, None),)
                if callable(f)
            ),
            None,
        )
        if fn is None:
            return {**base, "error": {"code": -32601, "message": f"method {method!r} not found"}}
        # admission gate (serving/admission.py): resolvable methods
        # only — unknown-method noise must not consume slots or skew
        # the per-method SLO families
        ticket = None
        if self.serving is not None:
            try:
                ticket = self.serving.admit(method)
            except RpcError as e:  # ServerBusy, already counted as shed
                return {**base, "error": {"code": e.code, "message": str(e)}}
        error = True
        try:
            out = {**base, "result": fn(*params)}
            error = False
            return out
        except RpcError as e:
            return {**base, "error": {"code": e.code, "message": str(e)}}
        except TypeError as e:
            return {**base, "error": {"code": -32602, "message": f"invalid params: {e}"}}
        except Exception as e:  # internal error — never kill the server
            return {**base, "error": {"code": -32603, "message": f"{type(e).__name__}: {e}"}}
        finally:
            if ticket is not None:
                self.serving.finish(method, ticket, error=error)

    # --------------------------------------------------------- server

    def start(self) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: HTTP/1.1 defaults to persistent connections,
            # so a pooled client (loadgen.HttpTransport, any real SDK)
            # pays the TCP handshake once per worker instead of once
            # per request. The contract that makes this safe is that
            # EVERY response path below sends an exact Content-Length
            # — shed (-32005) and parse errors ride the normal path,
            # and the oversized-body refusal explicitly closes (the
            # unread body makes the stream unresyncable).
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                if length > outer.max_body_bytes:
                    # refuse BEFORE reading: a spec-shaped error goes
                    # back and the connection closes (the body is
                    # unread, so the stream cannot be resynced)
                    payload = json.dumps({
                        "jsonrpc": "2.0", "id": None,
                        "error": {
                            "code": -32600,
                            "message": "request body too large "
                            f"(max {outer.max_body_bytes} bytes)",
                        },
                    }).encode()
                    self.close_connection = True
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/json"
                    )
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                body = self.rfile.read(length)
                t0 = time.perf_counter()
                try:
                    request = json.loads(body)
                    response = outer.handle(
                        request,
                        browser_origin=self.headers.get("Origin")
                        is not None,
                    )
                except json.JSONDecodeError:
                    response = {
                        "jsonrpc": "2.0", "id": None,
                        "error": {"code": -32700, "message": "parse error"},
                    }
                served_ms = (time.perf_counter() - t0) * 1e3
                payload = json.dumps(response).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Length", str(len(payload)))
                # server-side dispatch time, so a pooled client can
                # subtract it from wall time and report the transport
                # overhead as its own number (loadgen.HttpTransport)
                self.send_header(
                    "X-Khipu-Served-Ms", f"{served_ms:.3f}"
                )
                self.end_headers()
                self.wfile.write(payload)

            def do_OPTIONS(self):  # CORS preflight
                self.send_response(204)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Headers", "Content-Type"
                )
                self.send_header("Access-Control-Allow-Methods", "POST")
                self.end_headers()

            def log_message(self, *args):
                pass  # quiet

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port  # resolves port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

"""HTTP serving surface (port of ``train/metrics.py``'s ``MetricsServer``
subset): ``POST /v1/generate`` and ``GET /v1/serving`` in front of a
:class:`~tensorflowonspark_tpu_torch.serving.ServingEngine`.

``POST /v1/generate`` takes the JAX endpoint's body fields (``prompt``,
``max_new_tokens``, ``temperature``, ``top_k``, ``top_p``, ``priority``,
``eos_token``, ``stream``, ``traceparent``) and answers the same way:
NDJSON ``{"token": id, "index": i}`` lines over chunked transfer while the
engine produces them, then a terminal ``{"done": true, ...}`` summary line
with the request's id, trace, state and ``ttft_ms``/``total_ms``; with
``"stream": false`` one JSON document with the summary and the tokens.
"""

import http.server
import json
import logging
import threading
import urllib.parse
import uuid

logger = logging.getLogger(__name__)

_TRACE_CHARS = frozenset("0123456789abcdef")


def _ms(seconds):
    return None if seconds is None else round(seconds * 1e3, 3)


def _parse_traceparent(value):
    """``trace_id`` of a ``"<hex trace>-<span>"`` traceparent, or None for
    anything malformed (a fresh trace is minted instead)."""
    if not isinstance(value, str) or "-" not in value:
        return None
    trace, _, parent = value.rpartition("-")
    if not (4 <= len(trace) <= 32) or not set(trace) <= _TRACE_CHARS:
        return None
    try:
        int(parent)
    except ValueError:
        return None
    return trace


def _handle_summary(handle):
    """Terminal-summary fields of a ``/v1/generate`` response."""
    return {
        "request": handle.id,
        "trace": handle.trace,
        "state": handle.state,
        "ttft_ms": _ms(handle.ttft),
        "total_ms": _ms(handle.e2e),
    }


class _ServingHandler(http.server.BaseHTTPRequestHandler):
    server_version = "tfos-torch-serving"
    # HTTP/1.1 for chunked transfer on the streaming endpoint; every
    # non-streamed response carries Content-Length.
    protocol_version = "HTTP/1.1"
    # Prompts are token-id lists, not documents.
    MAX_BODY = 8 * 1024 * 1024

    def log_message(self, *args, **kwargs):
        pass

    def do_GET(self):
        path = urllib.parse.urlparse(self.path).path
        if path != "/v1/serving":
            self._send(404, "text/plain", b"not found\n")
            return
        engine = self.server.engine
        if engine is None:
            self._send(503, "application/json",
                       b'{"error": "no serving engine attached"}\n')
            return
        self._send(200, "application/json",
                   json.dumps(engine.stats(), default=str).encode("utf-8"))

    def do_POST(self):
        path = urllib.parse.urlparse(self.path).path
        if path != "/v1/generate":
            # Early returns below answer WITHOUT reading the body; on a
            # keep-alive connection the unread bytes would desync the next
            # request's parse, so they close the connection.
            self.close_connection = True
            self._send(404, "text/plain", b"not found\n")
            return
        engine = self.server.engine
        if engine is None:
            self.close_connection = True
            self._send(503, "application/json",
                       b'{"error": "no serving engine attached"}\n')
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self.close_connection = True
            self._send(400, "text/plain", b"missing request body\n")
            return
        if length > self.MAX_BODY:
            self.close_connection = True
            self._send(413, "text/plain", b"request body too large\n")
            return
        from tensorflowonspark_tpu_torch.serving import QueueFull

        trace = None
        try:
            body = json.loads(self.rfile.read(length).decode("utf-8"))
            trace = (_parse_traceparent(body.get("traceparent") or "")
                     or uuid.uuid4().hex[:12])
            prompt = body["prompt"]
            if not (isinstance(prompt, list)
                    and all(isinstance(t, int) for t in prompt)):
                raise ValueError("prompt must be a list of token ids")
            max_new = int(body.get("max_new_tokens", 64))
            temperature = float(body.get("temperature", 0.0))
            top_k = int(body.get("top_k", 0))
            top_p = float(body.get("top_p", 0.0))
            priority = int(body.get("priority", 0))
            eos = body.get("eos_token")
            if eos is not None:
                eos = int(eos)
            stream = bool(body.get("stream", True))
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            self._reject(400, "bad request: {}".format(e), trace)
            return
        try:
            handle = engine.submit(prompt, max_new, temperature=temperature,
                                   eos_token=eos, top_k=top_k, top_p=top_p,
                                   priority=priority, _trace=trace)
        except QueueFull as e:
            self._reject(429, str(e), trace)
            return
        except ValueError as e:
            self._reject(400, str(e), trace)
            return
        if stream:
            self._stream_tokens(handle)
            return
        try:
            tokens = handle.result(timeout=300.0)
        except Exception as e:
            # A timed-out or failed request must not keep holding its
            # decode slot and page reservation.
            handle.cancel()
            self._send(500, "application/json", json.dumps(
                {"error": str(e), "trace": handle.trace}).encode("utf-8"))
            return
        self._send(200, "application/json", json.dumps({
            **_handle_summary(handle), "tokens": tokens,
        }).encode("utf-8"))

    def _reject(self, code, message, trace=None):
        doc = {"error": message}
        if trace:
            doc["trace"] = trace
        self._send(code, "application/json", json.dumps(doc).encode("utf-8"))

    def _stream_tokens(self, handle):
        """NDJSON over chunked transfer: one line per generated token,
        then the terminal summary. An engine failure or stall ends the
        stream with an ``error`` field and a proper chunk terminator, and
        cancels the request."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            error = None
            try:
                for i, token in enumerate(handle.stream(timeout=300.0)):
                    self._chunk(json.dumps(
                        {"token": int(token), "index": i}) + "\n")
            except Exception as e:  # engine failure or stall
                handle.cancel()
                error = "{}: {}".format(type(e).__name__, e)
            tail = {"done": True, **_handle_summary(handle)}
            if error is not None:
                tail["error"] = error
            self._chunk(json.dumps(tail) + "\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            # Client hung up mid-stream: stop paying for its tokens.
            handle.cancel()

    def _chunk(self, text):
        data = text.encode("utf-8")
        self.wfile.write("{:x}\r\n".format(len(data)).encode("ascii"))
        self.wfile.write(data + b"\r\n")
        self.wfile.flush()

    def _send(self, code, ctype, body):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass


class MetricsServer:
    """The serving HTTP plane: ``POST /v1/generate`` and ``GET
    /v1/serving`` over an attached engine (started with
    ``engine.start()``). Binds loopback by default; ``port=0`` picks a
    free port (:attr:`port`). Unlike the JAX server it serves no metrics
    directory, so it takes keyword arguments only."""

    def __init__(self, *, host=None, port=0, engine=None):
        self._httpd = http.server.ThreadingHTTPServer(
            (host if host is not None else "127.0.0.1", port),
            _ServingHandler)
        self._httpd.daemon_threads = True
        self._httpd.engine = engine
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            daemon=True)
        self._thread.start()
        logger.info("serving HTTP plane on port %d", self.port)
        return self.port

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

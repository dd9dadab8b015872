"""Metrics and the HTTP serving surface (port of ``train/metrics.py``).

:class:`MetricsWriter` appends scalar events to ``metrics.jsonl`` (NaN and
inf written as ``null`` with the value kept under ``raw``) and mirrors
them to a tfevents file (:mod:`.tbevents`); :func:`read_events` reads the
JSONL stream back. :class:`AsyncStepMetrics` is ``Trainer.fit``'s buffer:
a step's metrics stay 0-d device tensors until a window is flushed with
one host transfer.

:class:`MetricsServer` is the subset that serves: ``POST /v1/generate``
and ``GET /v1/serving`` in front of a
:class:`~tensorflowonspark_tpu_torch.serving.ServingEngine`, and the
node's telemetry: ``GET /metrics`` (the process's counters, gauges and
histograms in Prometheus text, plus ``tfos_node_*`` gauges from
``stats_fn``) and ``GET /statusz`` (JSON: node stats, metrics, status
entries, recent spans, and whatever ``status_fn`` adds). A cluster's chief
runs one under ``cluster.run(tensorboard=True)``.
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
import math
import threading
import time
import urllib.parse
import uuid

import torch

from tensorflowonspark_tpu_torch import fs as fs_lib
from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.train import tbevents

logger = logging.getLogger(__name__)


class MetricsWriter:
    """Append-only JSONL scalar event log, mirrored to TensorBoard.

    ``directory`` may be any URI. Local writes append line-buffered; object
    stores have no append, so remote writes buffer events and rewrite the
    object when ``flush_every`` events have accumulated or ``flush_secs``
    have passed since the last upload (and on close). Unless
    ``tfevents=False``, every scalar also goes to a tfevents file in the
    same directory, so TensorBoard pointed at ``directory`` shows the
    curves.
    """

    def __init__(self, directory, filename="metrics.jsonl",
                 flush_every=50, flush_secs=10.0, tfevents=True):
        self._local = fs_lib.is_local(directory)
        self.path = fs_lib.join(directory, filename)
        self._events = (
            tbevents.EventsWriter(directory, flush_every=flush_every,
                                  flush_secs=flush_secs)
            if tfevents else None
        )
        self._t0 = time.time()
        if self._local:
            fs_lib.makedirs(directory)
            self._f = open(fs_lib.local_path(self.path), "a", buffering=1)
        else:
            self._f = fs_lib.BufferedObjectWriter(
                self.path, mode="w",
                flush_every=flush_every, flush_secs=flush_secs)

    def write(self, step, **scalars):
        event = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        raw = {}
        floats = {}
        for k, v in scalars.items():
            f = float(v)
            floats[k] = f
            if math.isfinite(f):
                event[k] = f
            else:
                # NaN/inf (a diverging loss) would be written as the
                # non-standard NaN/Infinity tokens, which strict JSON
                # readers refuse: null, with the value kept in "raw".
                event[k] = None
                raw[k] = repr(f)
        if raw:
            event["raw"] = raw
        if self._events is not None:
            # tfevents holds binary floats: NaN/inf go through as they are.
            self._events.write(int(step), floats)
        self._f.write(json.dumps(event, allow_nan=False) + "\n")

    def close(self):
        if self._events is not None:
            self._events.close()
        self._f.close()


class AsyncStepMetrics:
    """Per-step metrics without a per-step host sync.

    Reading a step's loss with ``float(...)`` blocks the host until the
    step's kernels have run; done every step, it serializes the loop.
    ``push`` only keeps the step's 0-d device tensors; every
    ``flush_every`` steps :meth:`flush` stacks the window's values and
    copies them to the host in ONE transfer.

    ``hooks`` are called as ``hook(step, scalars_dict)`` per step at flush
    time, in step order (e.g. ``lambda s, m: writer.write(s, **m)`` for a
    :class:`MetricsWriter`). ``history`` accumulates ``{"step": int,
    **scalars}`` dicts for the whole run.
    """

    def __init__(self, flush_every=16, hooks=()):
        self.flush_every = max(1, int(flush_every))
        self.hooks = list(hooks)
        self.history = []
        self.closed = False
        self._pending = []

    def push(self, step, metrics):
        """Buffer one step's metrics dict; flushes (blocking) only when
        ``flush_every`` steps have accumulated."""
        if self.closed:
            raise RuntimeError(
                "AsyncStepMetrics is closed; its final window was already "
                "flushed")
        self._pending.append((int(step), metrics))
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self):
        """Fetch all buffered metrics in one blocking transfer; run hooks.

        Returns ``history``. Every fetched step lands in ``history`` before
        any hook runs, and a raising hook (a full disk under a
        :class:`MetricsWriter`) is logged and skipped: hooks observe, they
        neither drop the remaining steps nor unwind the training loop.
        """
        if not self._pending:
            return self.history
        pending, self._pending = self._pending, []
        values = [torch.as_tensor(v).detach().reshape(())
                  for _, m in pending for v in m.values()]
        device = next((t.device for t in values if t.device.type != "cpu"),
                      torch.device("cpu"))
        # f64 holds every f32/bf16/int32 value exactly, so one stacked
        # tensor carries the whole window (f64 on the card too).
        fetched = iter(torch.stack(
            [t.to(device=device, dtype=torch.float64) for t in values]
        ).cpu().tolist() if values else ())
        flushed = []
        for step, m in pending:
            scalars = {k: next(fetched) for k in m}
            self.history.append({"step": step, **scalars})
            flushed.append((step, scalars))
        for step, scalars in flushed:
            for hook in self.hooks:
                try:
                    hook(step, scalars)
                except Exception:
                    logger.exception(
                        "metrics hook %r failed at step %d", hook, step)
        return self.history

    def close(self):
        """Flush the final partial window and seal the buffer; returns
        ``history``. ``Trainer.fit`` closes the buffers it creates (a shared
        ``metrics=`` buffer is only flushed: it may span chunked fit
        calls); ``push`` after close raises."""
        history = self.flush()
        self.closed = True
        return history

    @property
    def last(self):
        """Most recent flushed step's scalars (None before any flush)."""
        return self.history[-1] if self.history else None


def read_events(directory, filename="metrics.jsonl"):
    """The events of a :class:`MetricsWriter` run, in write order (rolled
    ``.partN`` objects of a long remote run joined)."""
    path = fs_lib.join(directory, filename)
    events = []
    for part in fs_lib.part_uris(path) or [path]:
        with fs_lib.open(part, "r") as f:
            events.extend(json.loads(line) for line in f if line.strip())
    return events

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


# Recent spans a /statusz answer carries.
STATUSZ_SPANS = 50


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
        if path in ("/metrics", "/statusz"):
            body, ctype = (self._metrics() if path == "/metrics"
                           else self._statusz())
            self._send(200, ctype, body.encode("utf-8"))
            return
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

    def _fn(self, name):
        fn = getattr(self.server, name, None)
        if fn is None:
            return {}
        try:
            return fn() or {}
        except Exception:  # a dead manager must not fail the scrape
            logger.debug("%s failed", name, exc_info=True)
            return {}

    def _metrics(self):
        text = telemetry.prometheus_text()
        # In FEED mode this server runs in the executor while the compute
        # child makes the numbers: stats_fn bridges them (the child
        # publishes node_stats to the manager KV with every heartbeat).
        stats = self._fn("stats_fn")
        for key in sorted(stats):
            value = stats[key]
            if isinstance(value, (int, float)):
                name = "tfos_node_" + telemetry._sanitize(str(key))
                text += "# TYPE {} gauge\n{} {}\n".format(
                    name, name, telemetry._fmt_value(value))
        text += "# TYPE tfos_up gauge\ntfos_up 1\n"
        return text, "text/plain; version=0.0.4"

    def _statusz(self):
        rec = telemetry.get_recorder()
        doc = {"node": None if rec is None else rec.node_id,
               "stats": telemetry.node_stats(),
               "metrics": telemetry.metrics_snapshot(),
               "status": telemetry.get_status(),
               "spans": telemetry.recent_spans(STATUSZ_SPANS)}
        doc.update(self._fn("status_fn"))
        return json.dumps(doc, default=str), "application/json"

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
    ``engine.start()``), and the node telemetry routes ``/metrics`` and
    ``/statusz``. Binds loopback by default; ``port=0`` picks a free port
    (:attr:`port`). Unlike the JAX server it serves no metrics directory,
    so it takes keyword arguments only. ``status_fn`` and ``stats_fn`` are
    zero-argument callables returning dicts (the manager-published state
    and node stats of a FEED-mode compute child)."""

    def __init__(self, *, host=None, port=0, engine=None, status_fn=None,
                 stats_fn=None):
        self._httpd = http.server.ThreadingHTTPServer(
            (host if host is not None else "127.0.0.1", port),
            _ServingHandler)
        self._httpd.daemon_threads = True
        self._httpd.engine = engine
        self._httpd.status_fn = status_fn
        self._httpd.stats_fn = stats_fn
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

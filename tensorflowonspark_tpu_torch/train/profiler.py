"""Profiler trace capture (the port of the JAX package's
``train/profiler.py``), on ``torch.profiler``.

* :func:`trace` — context manager recording a ``torch.profiler`` session
  (CPU activities, and CUDA activities when a card is present) over the
  wrapped steps; it writes a Chrome/Perfetto ``trace_event`` JSON under
  ``log_dir/plugins/profile/<run>/`` (the layout TensorBoard's PyTorch
  profiler plugin reads; ui.perfetto.dev opens the file as is);
* :func:`window` — the same session for a fixed number of seconds, for a
  capture that cannot wrap the code it observes: an incident snapshot
  taken on a node's capture thread while its compute thread trains;
* :func:`start_server` — on-demand capture: registers the
  ``profiler_port`` gauge (every later heartbeat carries it) and serves
  ``GET /trace?secs=S`` on that port, answering with the JSON of a
  :func:`window` of ``S`` seconds recorded inside the node's process.

A process runs one profiler session at a time: :func:`trace` raises while
another runs, and :func:`window` returns None instead (an incident
snapshot must not fail because a trace is being taken).

Usage::

    from tensorflowonspark_tpu_torch.train import profiler

    with profiler.trace(model_dir):
        for _ in range(5):
            state, _ = trainer.train_step(state, batch)
"""

import contextlib
import gzip
import http.server
import json
import logging
import os
import shutil
import socket
import tempfile
import threading
import time
import urllib.parse

logger = logging.getLogger(__name__)

# One profiler session a process: torch.profiler refuses a second one.
_session_lock = threading.Lock()

# Upper bound on the seconds one GET /trace may record.
MAX_SERVER_SECS = 60.0


def _profile():
    """A ``torch.profiler.profile`` over CPU (and, with a card, CUDA)
    activities that records the operators of every thread of the process
    where the installed torch offers that (``profile_all_threads``):
    without it, CPU events come from the thread that started the session
    only, while CUPTI's device activities are process-wide either way."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        cfg = None
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def _run_dir(log_dir):
    from tensorflowonspark_tpu_torch import paths

    run = os.path.join(paths.strip_scheme(log_dir), "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run, exist_ok=True)
    return run


def _export(prof, run_dir, create_perfetto_trace=False):
    path = os.path.join(run_dir, "{}.{}.pt.trace.json".format(
        socket.gethostname(), os.getpid()))
    prof.export_chrome_trace(path)
    if create_perfetto_trace:
        with open(path, "rb") as src, \
                gzip.open(os.path.join(run_dir, "perfetto_trace.json.gz"),
                          "wb") as dst:
            shutil.copyfileobj(src, dst)
    return path


@contextlib.contextmanager
def trace(log_dir, create_perfetto_trace=False):
    """Record a ``torch.profiler`` session of the enclosed block into
    ``log_dir/plugins/profile/<run>/<host>.<pid>.pt.trace.json`` (plus a
    gzipped copy ``perfetto_trace.json.gz`` with
    ``create_perfetto_trace``). Yields the run directory. Raises
    ``RuntimeError`` when another session of this module is running."""
    if not _session_lock.acquire(blocking=False):
        raise RuntimeError("a profiler session is already running in this "
                           "process")
    try:
        run_dir = _run_dir(log_dir)
        with _profile() as prof:
            yield run_dir
        path = _export(prof, run_dir, create_perfetto_trace)
        logger.info("profiler trace written to %s", path)
    finally:
        _session_lock.release()


def window(secs, log_dir=None):
    """Record a ``torch.profiler`` session of ``secs`` seconds on the
    calling thread while the process's other threads run on; returns the
    run directory holding the trace JSON, or None when another session
    is running or the profiler fails. The window holds the device
    kernels the process launched meanwhile (CUPTI records every stream)
    and, where the installed torch records every thread, the other
    threads' operators. ``log_dir`` defaults to a fresh temporary
    directory."""
    if not secs or secs <= 0:
        return None
    if not _session_lock.acquire(blocking=False):
        logger.info("profiler window skipped: a session is already running")
        return None
    try:
        root = log_dir or tempfile.mkdtemp(prefix="tfos-profile-")
        run_dir = _run_dir(root)
        with _profile() as prof:
            time.sleep(float(secs))
        _export(prof, run_dir)
        return run_dir
    except Exception:  # a session outside this module, or no profiler
        logger.debug("profiler window failed", exc_info=True)
        return None
    finally:
        _session_lock.release()


def trace_files(run_dir):
    """The Chrome trace JSON files a :func:`trace`/:func:`window` run
    directory holds."""
    if not run_dir or not os.path.isdir(run_dir):
        return []
    return sorted(os.path.join(run_dir, n) for n in os.listdir(run_dir)
                  if n.endswith(".pt.trace.json"))


def kernel_names(run_dir):
    """Names of the device kernels (``cat == "kernel"``) in a run
    directory's traces, with their counts."""
    counts = {}
    for path in trace_files(run_dir):
        with open(path) as f:
            doc = json.load(f)
        for ev in doc.get("traceEvents", ()):
            if str(ev.get("cat", "")).lower() == "kernel":
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    return counts


class _TraceHandler(http.server.BaseHTTPRequestHandler):
    server_version = "tfos-torch-profiler"

    def log_message(self, *args, **kwargs):
        pass

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path != "/trace":
            self._send(404, b"endpoint: /trace?secs=S\n", "text/plain")
            return
        try:
            secs = float((urllib.parse.parse_qs(parsed.query).get("secs")
                          or ["2"])[0])
        except ValueError:
            self._send(400, b"secs must be a number\n", "text/plain")
            return
        secs = min(max(secs, 0.01), MAX_SERVER_SECS)
        tmp = tempfile.mkdtemp(prefix="tfos-profile-http-")
        try:
            files = trace_files(window(secs, log_dir=tmp))
            if not files:
                self._send(409, b"a profiler session is already running\n",
                           "text/plain")
                return
            with open(files[0], "rb") as f:
                body = f.read()
            self._send(200, body, "application/json")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _send(self, code, body, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass


class ProfileServer:
    """The on-demand capture endpoint :func:`start_server` returns:
    ``GET /trace?secs=S`` on :attr:`port` answers a Chrome trace JSON of
    an ``S``-second :func:`window` (at most :data:`MAX_SERVER_SECS`)."""

    def __init__(self, httpd):
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.5},
            name="profiler-server", daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self._httpd.server_address[1]

    def stop(self):
        from tensorflowonspark_tpu_torch import telemetry

        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)
        if telemetry.get_gauge("profiler_port") == self.port:
            telemetry.clear_gauge("profiler_port")


def start_server(port=9999, ctx=None, tries=16, host=None):
    """Arm on-demand capture; returns a :class:`ProfileServer`.

    The chosen port is published to the telemetry plane (the
    ``profiler_port`` gauge), so every later heartbeat carries it and
    ``cluster_stats()`` / ``/statusz`` report where to pull a trace from.
    Pass the node's ``ctx`` to also push one immediate stats beat to the
    reservation server: the driver then learns the port without waiting
    an interval. When ``port`` is taken, the next ``tries - 1`` ports are
    probed before giving up. Binds loopback unless ``host`` says
    otherwise.

    Incident snapshots take their ``torch.profiler`` window
    (:func:`window`) when a capture request asks for ``profile_secs`` and
    either this server's gauge or the continuous sampler is live
    (``incident._maybe_profile``); the server also starts the sampler
    (unless ``TFOS_PROFILING=0``).
    """
    from tensorflowonspark_tpu_torch import telemetry

    try:
        from tensorflowonspark_tpu_torch.telemetry import profiling

        profiling.maybe_start_from_env()
    except Exception:  # never block the server
        logger.debug("continuous profiler start failed", exc_info=True)

    last = None
    for p in range(int(port), int(port) + max(1, int(tries))):
        try:
            httpd = http.server.ThreadingHTTPServer(
                (host if host is not None else "127.0.0.1", p),
                _TraceHandler)
        except OSError as e:  # port in use (another node on this host)
            last = e
            logger.debug("profiler port %d unavailable: %s", p, e)
            continue
        httpd.daemon_threads = True
        server = ProfileServer(httpd)
        telemetry.set_gauge("profiler_port", server.port)
        if ctx is not None and getattr(ctx, "server_addr", None):
            try:
                from tensorflowonspark_tpu_torch import reservation

                client = reservation.Client(
                    ctx.server_addr, retries=1, deadline=2.0)
                client.heartbeat(ctx.executor_id,
                                 stats=telemetry.node_stats())
                client.close()
            except Exception:
                # The periodic HeartbeatSender carries the gauge on its
                # next beat; failing the server over a slow dial would be
                # backwards.
                logger.warning("profiler-port registration beat failed",
                               exc_info=True)
        logger.info("profiler server listening on port %d", server.port)
        return server
    raise RuntimeError("no free profiler port in [{}, {}): {}".format(
        int(port), int(port) + max(1, int(tries)), last))


def annotate(name):
    """Named range for host-side phases on the trace timeline:
    ``with profiler.annotate("feed-wait"): ...``"""
    import torch

    return torch.profiler.record_function(name)

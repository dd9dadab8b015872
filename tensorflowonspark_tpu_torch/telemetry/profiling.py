"""Continuous sampling profiler: always-on folded stacks + flame diffs
(the port's copy of the JAX package's ``telemetry/profiling.py``).

The observability stack can say which *segment* is slow (the
attribution doctor) and which *node* is slow (the straggler detector);
this module answers which *code* is slow — continuously, not on
demand. A daemon thread walks ``sys._current_frames()`` at a low
configurable rate (default ~67 Hz) and folds every thread's stack into
bounded collapsed-stack counters (``file:func:line`` frames, rooted at
the thread name), cheap enough to run under the telemetry plane's <2%
overhead guard (:meth:`Sampler.duty_cycle` is that overhead; the
``profiling_duty_frac`` gauge publishes it each window).

Windows rotate every ``window_s`` seconds: ``current`` (still
filling), ``previous`` (the last completed window), and ``baseline``
(the FIRST completed window, retained for the life of the sampler) —
the diff target that answers "what grew since this process was
healthy". On top of the windows:

* :func:`folded_text` — flamegraph.pl / speedscope collapsed-stack
  text (``frame;frame;frame count`` lines);
* :func:`digest` — a compact top-N frame summary (self/total sample
  counts) small enough to ride ``node_stats()`` heartbeats into the
  driver's :class:`~tensorflowonspark_tpu_torch.telemetry_store
  .TelemetryStore`;
* :func:`profile_diff` — frames ranked by self-time delta between two
  windows or digests (the straggler trigger diffs the flagged node's
  shipped digest against a healthy peer's);
* :func:`flame_svg` / :func:`render_flame_html` — a self-contained
  inline-SVG flame panel (no scripts) for the dashboard.

Lifecycle: :func:`telemetry.configure` starts the module sampler
(gate: the ``TFOS_PROFILING`` env var, default on) and
:func:`telemetry.disable` stops it, so every node that runs the
telemetry plane profiles itself. Everything here is stdlib-only and
import-cheap; :mod:`telemetry` is imported lazily to avoid a package
cycle.
"""

import os
import sys
import threading
import time

DEFAULT_HZ = 67.0         # deliberately off 50/60/100 Hz beat patterns
DEFAULT_WINDOW_S = 30.0
MAX_STACKS = 2048         # distinct folded stacks kept per window
MAX_DEPTH = 64            # frames kept per stack (deepest dropped)
DIGEST_TOP = 15           # frames per heartbeat digest
FOLDED_EXPORT_LINES = 512  # folded lines shipped in incident snapshots

OVERFLOW_KEY = "(overflow)"


def _sanitize_frame(text):
    """Frame text must not contain the folded grammar's separators."""
    return str(text).replace(";", ",").replace(" ", "_")


def frame_label(frame):
    """One collapsed frame: ``file:func:line`` (basename, def line)."""
    code = frame.f_code
    return _sanitize_frame("{}:{}:{}".format(
        os.path.basename(code.co_filename), code.co_name,
        code.co_firstlineno))


class Sampler:
    """The continuous sampler: one daemon thread, bounded counters.

    Thread-safe: the sampling thread and readers share ``_lock``; every
    public accessor returns plain-dict snapshots safe to mutate/ship.
    """

    def __init__(self, hz=DEFAULT_HZ, window_s=DEFAULT_WINDOW_S,
                 max_stacks=MAX_STACKS, max_depth=MAX_DEPTH):
        self.hz = float(hz)
        self.interval = 1.0 / max(0.1, self.hz)
        self.window_s = float(window_s)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._window_id = 0
        self._current = self._new_window()
        self._previous = None
        self._baseline = None
        # Own-cost accounting: the duty cycle IS the always-on overhead
        # (the sampler holds the GIL while it walks frames), and the
        # profiling_duty_frac gauge publishes it.
        self.samples = 0
        self.cost_s = 0.0
        self.started = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.started = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="tfos-profiling-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=2.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def duty_cycle(self):
        """Fraction of wall-clock the sampler spent walking frames."""
        if self.started is None:
            return 0.0
        elapsed = time.monotonic() - self.started
        return self.cost_s / elapsed if elapsed > 0 else 0.0

    # -- the sampling loop ---------------------------------------------------

    def _new_window(self):
        self._window_id += 1
        return {"id": self._window_id, "t0": time.time(), "t1": None,
                "samples": 0, "dropped": 0, "stacks": {}, "threads": {}}

    def _run(self):
        own = threading.get_ident()
        next_rotate = time.monotonic() + self.window_s
        while not self._stop.wait(self.interval):
            t0 = time.perf_counter()
            try:
                self._sample(own)
            except Exception:  # pragma: no cover - must never die
                pass
            self.cost_s += time.perf_counter() - t0
            self.samples += 1
            if time.monotonic() >= next_rotate:
                next_rotate = time.monotonic() + self.window_s
                self._rotate()

    def _sample(self, own_ident):
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded = []
        for tid, frame in frames.items():
            if tid == own_ident:
                continue
            stack = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                stack.append(frame_label(frame))
                frame = frame.f_back
                depth += 1
            stack.append("thread:" + _sanitize_frame(
                names.get(tid, hex(tid))))
            stack.reverse()  # root (thread) first, leaf last
            folded.append((names.get(tid, hex(tid)), ";".join(stack)))
        del frames
        with self._lock:
            win = self._current
            win["samples"] += 1
            for tname, key in folded:
                win["threads"][tname] = win["threads"].get(tname, 0) + 1
                if key in win["stacks"] or len(
                        win["stacks"]) < self.max_stacks:
                    win["stacks"][key] = win["stacks"].get(key, 0) + 1
                else:
                    # Bounded: past the cap, new stacks pool under one
                    # overflow bucket instead of growing without limit.
                    win["dropped"] += 1
                    win["stacks"][OVERFLOW_KEY] = win["stacks"].get(
                        OVERFLOW_KEY, 0) + 1

    def _rotate(self):
        with self._lock:
            done = self._current
            done["t1"] = time.time()
            self._previous = done
            if self._baseline is None and done["samples"] > 0:
                self._baseline = done
            self._current = self._new_window()
        self._announce(done)

    def _announce(self, done):
        """One rotation's telemetry: a ``profile/window`` event plus the
        duty-cycle gauge — lazy import, and never fatal (the sampler
        must outlive a torn-down telemetry plane)."""
        try:
            from tensorflowonspark_tpu_torch import telemetry

            d = digest(done, top=1)
            top = d["top"][0][0] if d["top"] else None
            telemetry.inc("profiling_samples_total", done["samples"])
            telemetry.set_gauge("profiling_duty_frac",
                                round(self.duty_cycle(), 6))
            telemetry.event("profile/window", window=done["id"],
                            samples=done["samples"],
                            stacks=len(done["stacks"]),
                            duty=round(self.duty_cycle(), 5),
                            top=top)
        except Exception:
            pass

    # -- window access -------------------------------------------------------

    def window(self, which="current"):
        """A snapshot of one window (plain dicts, safe to ship): the
        still-filling ``current``, the last completed ``previous``, or
        the retained first-completed ``baseline``. None when the asked
        window has not formed yet."""
        with self._lock:
            win = {"current": self._current, "previous": self._previous,
                   "baseline": self._baseline}.get(which)
            if win is None:
                return None
            out = dict(win, stacks=dict(win["stacks"]),
                       threads=dict(win["threads"]))
        if out["t1"] is None:
            out = dict(out, t1=time.time())
        return out

    def best_window(self, min_samples=1):
        """The freshest window with at least ``min_samples`` — what a
        heartbeat digest or an incident snapshot should ship (a window
        that just rotated leaves ``current`` nearly empty)."""
        for which in ("current", "previous", "baseline"):
            win = self.window(which)
            if win is not None and win["samples"] >= min_samples:
                return win
        return self.window("current")


# ---------------------------------------------------------------------------
# Module singleton (the telemetry.configure-managed sampler)
# ---------------------------------------------------------------------------

_sampler = None
_sampler_lock = threading.Lock()


def start(hz=None, window_s=None):
    """Start (or return) the process-wide sampler. Idempotent; knobs
    apply on first start (env overrides: ``TFOS_PROFILING_HZ``,
    ``TFOS_PROFILING_WINDOW_S``)."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None and _sampler.running():
            return _sampler
        if hz is None:
            hz = float(os.environ.get("TFOS_PROFILING_HZ", DEFAULT_HZ))
        if window_s is None:
            window_s = float(os.environ.get("TFOS_PROFILING_WINDOW_S",
                                            DEFAULT_WINDOW_S))
        _sampler = Sampler(hz=hz, window_s=window_s).start()
        return _sampler


def stop():
    """Stop and drop the process-wide sampler (windows are discarded —
    ship digests before stopping)."""
    global _sampler
    with _sampler_lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop()


def running():
    s = _sampler
    return s is not None and s.running()


def get_sampler():
    return _sampler


def maybe_start_from_env():
    """The telemetry.configure hook: start the sampler unless the
    ``TFOS_PROFILING`` env var disables it (\"0\"/\"off\"/\"false\")."""
    if os.environ.get("TFOS_PROFILING", "1").lower() in (
            "0", "off", "false", "no"):
        return None
    return start()


# ---------------------------------------------------------------------------
# Folded-stack text (flamegraph.pl / speedscope collapsed format)
# ---------------------------------------------------------------------------


def _stacks_of(doc):
    """The folded-stack counters of a window dict (or a raw counters
    dict passed straight through)."""
    if isinstance(doc, dict) and "stacks" in doc:
        return doc["stacks"] or {}
    return doc or {}


def folded_text(window_or_stacks, limit=None):
    """Collapsed-stack text, heaviest stack first: one
    ``frame;frame;frame count`` line per distinct stack — loadable by
    flamegraph.pl and speedscope as-is. ``limit`` caps the line count
    (incident snapshots ship a bounded export)."""
    stacks = _stacks_of(window_or_stacks)
    lines = ["{} {}".format(key, int(count)) for key, count in
             sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))]
    if limit is not None:
        lines = lines[:int(limit)]
    return "\n".join(lines)


def parse_folded(text):
    """Collapsed-stack text back into a counters dict (inverse of
    :func:`folded_text`; malformed lines are skipped, not fatal)."""
    stacks = {}
    for line in str(text).splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            stacks[stack] = stacks.get(stack, 0) + int(count)
        except ValueError:
            continue
    return stacks


# ---------------------------------------------------------------------------
# Frame accounting: self/total counts, digests, diffs
# ---------------------------------------------------------------------------


def frame_counts(window_or_stacks):
    """Per-frame sample counts from folded stacks: ``(samples,
    {frame: [self, total]})`` where *self* counts stacks the frame was
    the leaf of and *total* counts stacks it appeared anywhere in
    (once per stack — recursion does not double-count)."""
    stacks = _stacks_of(window_or_stacks)
    doc = window_or_stacks if isinstance(window_or_stacks, dict) else {}
    samples = doc.get("samples") if isinstance(
        doc.get("samples"), (int, float)) else None
    counts = {}
    total_weight = 0
    for stack, weight in stacks.items():
        frames = stack.split(";")
        total_weight += weight
        leaf = frames[-1]
        entry = counts.setdefault(leaf, [0, 0])
        entry[0] += weight
        for fr in set(frames):
            counts.setdefault(fr, [0, 0])[1] += weight
    return (int(samples) if samples is not None else total_weight), counts


def digest(window_or_stacks, top=DIGEST_TOP):
    """The compact top-N frame digest that rides heartbeats:
    ``{"id", "t0", "t1", "samples", "top": [[frame, self, total],
    ...]}`` ranked by self samples then total. ~1 KB at the default N —
    cheap enough for every beat. Idempotent: an input that already is a
    digest passes through (re-trimmed to ``top``)."""
    if (isinstance(window_or_stacks, dict)
            and isinstance(window_or_stacks.get("top"), list)
            and "stacks" not in window_or_stacks):
        return dict(window_or_stacks,
                    top=window_or_stacks["top"][:int(top)])
    samples, counts = frame_counts(window_or_stacks)
    ranked = sorted(counts.items(),
                    key=lambda kv: (-kv[1][0], -kv[1][1], kv[0]))
    # Thread roots self-count only when a thread is idle at its root;
    # they stay in the table (an idle-thread profile is a finding too).
    out = {"samples": samples,
           "top": [[fr, int(c[0]), int(c[1])]
                   for fr, c in ranked[:int(top)]]}
    doc = window_or_stacks if isinstance(window_or_stacks, dict) else {}
    for key in ("id", "t0", "t1"):
        if doc.get(key) is not None:
            out[key] = round(doc[key], 3) if key != "id" else doc[key]
    return out


def heartbeat_digest(top=DIGEST_TOP, min_samples=1):
    """The running sampler's freshest digest (None when not running or
    nothing sampled yet) — ``node_stats()`` attaches this under the
    ``profile`` key on every heartbeat."""
    s = _sampler
    if s is None or not s.running():
        return None
    win = s.best_window(min_samples=min_samples)
    if win is None or win["samples"] < min_samples:
        return None
    return digest(win, top=top)


def _fractions(doc):
    """Normalize a window, folded-counters dict, or digest into
    ``(samples, {frame: (self_frac, total_frac)})``."""
    if isinstance(doc, dict) and isinstance(doc.get("top"), list):
        samples = max(1, int(doc.get("samples") or 1))
        return samples, {
            str(row[0]): (float(row[1]) / samples,
                          float(row[2]) / samples)
            for row in doc["top"]
            if isinstance(row, (list, tuple)) and len(row) >= 3}
    samples, counts = frame_counts(doc)
    samples = max(1, samples)
    return samples, {fr: (c[0] / samples, c[1] / samples)
                     for fr, c in counts.items()}


def profile_diff(window_a, window_b, top=10, min_frac=0.005):
    """Differential profile: frames ranked by self-time delta from
    ``window_a`` (the baseline/peer/previous round) to ``window_b``
    (the suspect). Inputs may be windows, folded counters, or compact
    digests — mixing is fine (the straggler trigger diffs two
    heartbeat digests).

    Returns ``{"samples_a", "samples_b", "frames": [{"frame",
    "self_a", "self_b", "delta", "ratio", "total_a", "total_b"},
    ...], "top_frame", "text"}`` — ``frames`` sorted by ``delta``
    (growth first), fractions of each window's samples, ``ratio``
    None for frames absent from the baseline. ``text`` is the one-line
    human verdict naming the biggest growth."""
    samples_a, fa = _fractions(window_a)
    samples_b, fb = _fractions(window_b)
    rows = []
    for fr in set(fa) | set(fb):
        if fr == OVERFLOW_KEY or fr.startswith("thread:"):
            continue
        sa, ta = fa.get(fr, (0.0, 0.0))
        sb, tb = fb.get(fr, (0.0, 0.0))
        if max(sa, sb, ta, tb) < min_frac:
            continue
        rows.append({
            "frame": fr,
            "self_a": round(sa, 4), "self_b": round(sb, 4),
            "total_a": round(ta, 4), "total_b": round(tb, 4),
            "delta": round(sb - sa, 4),
            "ratio": round(sb / sa, 2) if sa > 0 else (
                None if sb == 0 else float("inf")),
        })
    rows.sort(key=lambda r: (-r["delta"], r["frame"]))
    out = {"samples_a": samples_a, "samples_b": samples_b,
           "frames": rows[:int(top)] if top else rows}
    grown = [r for r in rows if r["delta"] > 0]
    if grown:
        r = grown[0]
        ratio = ("{:.1f}x".format(r["ratio"])
                 if isinstance(r["ratio"], (int, float))
                 and r["ratio"] != float("inf") else "new")
        out["top_frame"] = r["frame"]
        out["text"] = ("hot: {} self {:.1%} -> {:.1%} ({})".format(
            r["frame"], r["self_a"], r["self_b"], ratio))
    else:
        out["top_frame"] = None
        out["text"] = "no frame grew between the two windows"
    return out


def window_export(limit=FOLDED_EXPORT_LINES):
    """The running sampler's evidence for an incident snapshot:
    ``{"folded": <collapsed text of the freshest window>, "digest":
    ..., "baseline": <baseline digest or None>, "duty": ...}`` —
    bounded (``limit`` folded lines), None when not running."""
    s = _sampler
    if s is None or not s.running():
        return None
    win = s.best_window()
    if win is None:
        return None
    base = s.window("baseline")
    return {
        "folded": folded_text(win, limit=limit),
        "digest": digest(win),
        "baseline": digest(base) if base is not None
        and base["id"] != win["id"] else None,
        "duty": round(s.duty_cycle(), 5),
        "hz": s.hz,
    }


# ---------------------------------------------------------------------------
# Flame rendering (self-contained inline SVG; zero deps, no scripts)
# ---------------------------------------------------------------------------

_ROW_H = 16
_MIN_W = 1.5   # px below which a box is elided
_FLAME_CSS = ("svg.flame{background:#1a1a1a;border:1px solid #333;"
              "font-family:ui-monospace,monospace}"
              "svg.flame text{font-size:10px;fill:#111}")


def _esc(text):
    return (str(text).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _trie(stacks):
    root = {"children": {}, "count": 0}
    for stack, weight in stacks.items():
        root["count"] += weight
        node = root
        for fr in stack.split(";"):
            node = node["children"].setdefault(
                fr, {"children": {}, "count": 0})
            node["count"] += weight
    return root


def _color(frame):
    h = 0
    for ch in frame:
        h = (h * 31 + ord(ch)) & 0xFFFFFF
    return "hsl({},{}%,{}%)".format(h % 360, 55 + (h >> 8) % 25,
                                    55 + (h >> 16) % 15)


def flame_svg(window_or_stacks, width=900, max_depth=24):
    """One flame graph as an inline ``<svg>`` (no scripts: hover
    tooltips via ``<title>``): box width = total samples, rooted at
    thread names, leaves on top. Empty stacks give an empty string."""
    stacks = _stacks_of(window_or_stacks)
    if not stacks:
        return ""
    root = _trie(stacks)
    total = root["count"] or 1
    boxes = []

    def walk(node, x, depth):
        if depth >= max_depth:
            return
        for fr, child in sorted(node["children"].items(),
                                key=lambda kv: (-kv[1]["count"], kv[0])):
            w = child["count"] / total * width
            if w >= _MIN_W:
                boxes.append((x, depth, w, fr, child["count"]))
                walk(child, x, depth + 1)
            x += w

    walk(root, 0.0, 0)
    if not boxes:
        return ""
    depth_max = max(d for _, d, _, _, _ in boxes) + 1
    height = depth_max * _ROW_H + 2
    parts = ['<svg class="flame" width="{}" height="{}">'.format(
        int(width), height)]
    for x, depth, w, fr, count in boxes:
        y = height - (depth + 1) * _ROW_H - 1
        label = fr if w > 7 * len(fr) else (
            fr[:max(0, int(w / 7) - 1)] + "…"
            if w > 21 else "")
        parts.append(
            '<g><rect x="{:.1f}" y="{}" width="{:.1f}" height="{}" '
            'fill="{}" stroke="#1a1a1a"><title>{} ({} samples, '
            '{:.1%})</title></rect>'.format(
                x, y, w, _ROW_H - 1, _color(fr), _esc(fr), count,
                count / total))
        if label:
            parts.append('<text x="{:.1f}" y="{}">{}</text>'.format(
                x + 2, y + _ROW_H - 5, _esc(label)))
        parts.append("</g>")
    parts.append("</svg>")
    return "".join(parts)


def render_flame_html(window_or_stacks, title="tfos profile",
                      diff=None, width=900):
    """A full self-contained flame page (the dashboard links): the flame
    SVG plus, when ``diff`` (a :func:`profile_diff` result) is given, the
    ranked delta table."""
    parts = ["<!doctype html><html><head><meta charset='utf-8'>",
             "<title>{}</title><style>{}"
             "body{{font-family:ui-monospace,monospace;background:#111;"
             "color:#ddd;margin:1.2em}}"
             "table{{border-collapse:collapse;font-size:0.85em}}"
             "td,th{{border:1px solid #333;padding:2px 8px;"
             "text-align:left}}</style></head><body>".format(
                 _esc(title), _FLAME_CSS),
             "<h1>{}</h1>".format(_esc(title))]
    svg = flame_svg(window_or_stacks, width=width)
    parts.append(svg or "<p>(no samples)</p>")
    if diff:
        parts.append("<h2>flame diff (self-time delta)</h2>"
                     "<table><tr><th>frame</th><th>self A</th>"
                     "<th>self B</th><th>delta</th><th>ratio</th></tr>")
        for r in diff.get("frames", ()):
            parts.append(
                "<tr><td>{}</td><td>{:.1%}</td><td>{:.1%}</td>"
                "<td>{:+.1%}</td><td>{}</td></tr>".format(
                    _esc(r["frame"]), r["self_a"], r["self_b"],
                    r["delta"],
                    "{:.2f}x".format(r["ratio"])
                    if isinstance(r["ratio"], (int, float))
                    and r["ratio"] != float("inf")
                    else "-" if r["ratio"] is None else "new"))
        parts.append("</table><p>{}</p>".format(_esc(diff.get("text",
                                                              ""))))
    parts.append("</body></html>")
    return "\n".join(parts)


def _reset_for_tests():
    """Test isolation: stop and drop the module sampler."""
    stop()

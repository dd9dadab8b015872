"""Render an incident bundle (the cluster black box) human-readable, with
the PyTorch port's telemetry (nothing of the JAX package is imported).

An incident directory is written by
``tensorflowonspark_tpu_torch.incident.IncidentRecorder`` (or the JAX
package's, whose bundle layout it shares) when a detector fires
(straggler flag, hung/crashed node, supervised-attempt failure, SLO
breach) or on demand (``cluster.capture_incident()``). This CLI turns one
bundle — or the newest bundle under an incidents root — into a report::

    python scripts/torch_incident_report.py /path/to/incidents   # newest
    python scripts/torch_incident_report.py /path/to/incidents/incident-...-crash
    python scripts/torch_incident_report.py /path/to/incidents --json
    python scripts/torch_incident_report.py /path/to/incidents --stacks

Sections: the manifest (what fired, when, which nodes answered), the
cluster evidence (liveness, per-node stats, stragglers, restart history),
the merged flight-recorder timeline — the per-node ring dumps are
re-merged with the telemetry plane's clock-alignment helpers
(``telemetry.load_spans`` / ``estimate_clock_offsets`` / ``summarize``),
and a Perfetto ``trace.json`` is written beside them — the profile
evidence (each node's folded-stack window and ``torch.profiler`` trace
directory) and (with ``--stacks``) every captured all-thread stack dump. The
report text is also written to ``<bundle>/report.txt`` so the rendering
survives next to the evidence.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def resolve_bundle(path):
    """``path`` is a bundle (has manifest.json) or an incidents root
    (pick the newest bundle under it). Returns None when neither."""
    path = os.path.abspath(path)
    if os.path.isfile(os.path.join(path, "manifest.json")):
        return path
    if not os.path.isdir(path):
        return None
    bundles = sorted(
        d for d in os.listdir(path)
        if os.path.isfile(os.path.join(path, d, "manifest.json")))
    return os.path.join(path, bundles[-1]) if bundles else None


def render(bundle, with_stacks=False):
    """The report text for one bundle (also merges the ring timeline and
    writes ``rings/trace.json``)."""
    from tensorflowonspark_tpu_torch import telemetry

    manifest = _load_json(os.path.join(bundle, "manifest.json")) or {}
    cluster = _load_json(os.path.join(bundle, "cluster.json")) or {}
    lines = ["incident: {}".format(os.path.basename(bundle)),
             "reason:   {}".format(manifest.get("reason")),
             "time:     {}".format(manifest.get("iso"))]
    if manifest.get("attrs"):
        lines.append("attrs:    {}".format(json.dumps(manifest["attrs"])))
    lines.append("captured: {}   missing: {}".format(
        ", ".join(manifest.get("nodes_captured") or ()) or "(driver only)",
        ", ".join(manifest.get("nodes_missing") or ()) or "none"))

    stats = cluster.get("cluster_stats") or {}
    if stats:
        lines += ["", "cluster stats at capture:"]
        for eid in sorted(stats, key=str):
            entry = stats[eid]
            detail = ", ".join(
                "{}={}".format(k, entry[k]) for k in
                ("status", "state", "step", "steps_per_sec",
                 "data_wait_frac", "step_ms_p99", "last_checkpoint_step")
                if entry.get(k) is not None)
            flag = "  ** STRAGGLER" if entry.get("straggler") else ""
            lines.append("  node {:<6} {}{}".format(eid, detail, flag))
    if cluster.get("stragglers"):
        lines += ["", "straggler evidence: {}".format(
            json.dumps(cluster["stragglers"]))]
    history = (cluster.get("status") or {}).get("restart_history")
    if history:
        lines += ["", "restart history:"]
        for rec in history:
            lines.append("  attempt {}: {} at committed step {} — {}".format(
                rec.get("attempt"), rec.get("kind"),
                rec.get("committed_step"), rec.get("error")))

    rings_dir = os.path.join(bundle, "rings")
    if os.path.isdir(rings_dir):
        spans = telemetry.load_spans(rings_dir)
        if spans:
            offsets = telemetry.estimate_clock_offsets(spans)
            telemetry.write_trace(
                spans, os.path.join(rings_dir, "trace.json"),
                offsets=offsets)
            lines += ["", "flight-recorder timeline (merged rings):",
                      telemetry.summarize(spans, offsets=offsets)]
    # The full-export merged timeline, when the recorder embedded one.
    timeline = os.path.join(bundle, "timeline.txt")
    if os.path.isfile(timeline):
        with open(timeline) as f:
            lines += ["", "cluster timeline (full span export):", f.read()]

    nodes_dir = os.path.join(bundle, "nodes")
    profiles = []
    for name in sorted(os.listdir(nodes_dir)) if os.path.isdir(
            nodes_dir) else ():
        doc = _load_json(os.path.join(nodes_dir, name)) or {}
        prof = doc.get("profile") or {}
        top = ((prof.get("digest") or {}).get("top") or [[None]])[0][0]
        if prof or doc.get("profile_dir"):
            profiles.append("  {:<10} samples {} duty {} top {}{}".format(
                name[:-5], (prof.get("digest") or {}).get("samples"),
                prof.get("duty"), top,
                "  trace " + doc["profile_dir"]
                if doc.get("profile_dir") else ""))
    if profiles:
        lines += ["", "profile evidence (profiles/<node>.folded):"] + profiles

    stacks_dir = os.path.join(bundle, "stacks")
    if os.path.isdir(stacks_dir):
        names = sorted(os.listdir(stacks_dir))
        lines += ["", "stack dumps captured: {}".format(
            ", ".join(n[:-4] for n in names if n.endswith(".txt")))]
        if with_stacks:
            for name in names:
                with open(os.path.join(stacks_dir, name)) as f:
                    lines += ["", "--- {} ---".format(name), f.read()]
    text = "\n".join(lines) + "\n"
    try:  # the rendering lives next to the evidence
        with open(os.path.join(bundle, "report.txt"), "w") as f:
            f.write(text)
    except OSError:  # read-only archive copy: printing still works
        pass
    return text


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="incident bundle, or an incidents root "
                                "(newest bundle is picked)")
    p.add_argument("--json", action="store_true",
                   help="print the bundle's manifest + cluster evidence "
                        "as JSON instead of the text report")
    p.add_argument("--stacks", action="store_true",
                   help="include the full all-thread stack dumps")
    args = p.parse_args(argv)

    bundle = resolve_bundle(args.path)
    if bundle is None:
        print("no incident bundle under {}".format(args.path),
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({
            "bundle": bundle,
            "manifest": _load_json(os.path.join(bundle, "manifest.json")),
            "cluster": _load_json(os.path.join(bundle, "cluster.json")),
            "nodes": sorted(
                n[:-5] for n in os.listdir(os.path.join(bundle, "nodes"))
                if n.endswith(".json")
            ) if os.path.isdir(os.path.join(bundle, "nodes")) else [],
        }, default=str))
        return 0
    print(render(bundle, with_stacks=args.stacks))
    return 0


if __name__ == "__main__":
    sys.exit(main())

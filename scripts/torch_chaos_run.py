"""Chaos drill CLI of the PyTorch port: run a supervised training job with
an injected fault and print the recovery report (the port's counterpart of
``scripts/chaos_run.py``, with its flags and report keys plus
``--device``; nothing of the JAX package is imported).

Drives the full supervision stack end-to-end on local executors — armed
fault, heartbeat liveness, automatic relaunch, resume from the latest
committed checkpoint, an incident bundle written before each teardown —
and emits one JSON report line::

    python scripts/torch_chaos_run.py --fault crash --step 3
    python scripts/torch_chaos_run.py --fault hang --step 2 --max-restarts 2
    python scripts/torch_chaos_run.py --fault corrupt --step 4
    python scripts/torch_chaos_run.py --fault crash --step 3 --times 10
    python scripts/torch_chaos_run.py --fault none                # baseline
    python scripts/torch_chaos_run.py --preempt-drill 1 --nodes 3 # elastic
    python scripts/torch_chaos_run.py --fault crash --step 3 --device cpu

Models and engines run on ``--device`` (``cuda``, the default, or
``cpu``).

Exit code 0 = the job survived (or was a clean baseline); 2 = permanent
failure (the expected outcome when --times exceeds the restart budget) or
a failed elastic drill assertion.

``--preempt-drill N`` switches to the ELASTIC membership drill: an
N-of-``--nodes`` spot preemption (SIGTERM with notice) against an elastic
cluster. The drill asserts training continued DEGRADED in place (zero
supervised restarts), survivors hit the resize barrier (``cluster/
reshape`` markers on the merged timeline), replacements rejoined, and the
cluster re-expanded to full size before shutdown.

The report embeds the merged telemetry timeline (per-phase breakdown +
restart markers), the goodput series from the heartbeat history store
(the injected crash reads as a dip, the relaunch as the recovery) and a
store spill (``TelemetryStore.export``); with ``--workdir`` the
Perfetto-loadable trace survives at
``<workdir>/model/telemetry/trace.json`` and each incident bundle gets
its ``report.txt`` (``scripts/torch_incident_report.py``).
``--slo-drill`` additionally injects a synthetic TTFT stream that
breaches an SLO and verifies the burn-rate alert produced an incident
bundle with the breach marker on its merged timeline.

``--autoscale-drill`` closes the SLO-driven autoscaling loop in process:
a ``ServingFleet`` behind an ``Autoscaler`` under a ~10x traffic ramp
(``testing/load.py``), one abrupt replica preemption, and an elastic
reservation server whose join/leave directives every replica's
heartbeat observes.

``--disagg-drill`` is the DISAGGREGATED serving drill: the
driver runs a prefill-role engine, ``--nodes - 1`` child processes each
run a MetricsServer with a decode-role engine, and one ServingFleet
streams finished-prefill KV pages to the least-loaded decode node over
``POST /v1/migrate`` — load and prefix-digest heartbeats arrive by
polling each child's ``/statusz`` into the history store. Phase 1
asserts the remote hops produce bitwise solo-equal greedy streams and
that the children's index digests score remote prefix affinity; phase
2 kills the whole decode pool mid-handoff (pages already extracted,
wire hop in flight) and asserts every stream replays colocated,
still bitwise-equal, with the prefill ledger balanced and its pages
drained.
"""

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile

# Absolute, not ".": executor processes chdir into their own workdirs and
# compute children inherit sys.path — a relative entry would make the
# framework unimportable inside the spawned child.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _slo_drill(telemetry_store, incident_dir, telemetry_dir):
    """Injected TTFT SLO breach: feed a synthetic serving node whose
    p95 TTFT sits 4.5x over the objective into the history store, let
    the burn-rate monitor fire, and verify the firing produced an
    incident bundle carrying the ``cluster/slo_breach`` marker on its
    merged timeline (the acceptance drill for the SLO->incident wiring;
    the in-process test is tests/test_torch_incident.py)."""
    import time as time_mod

    from tensorflowonspark_tpu_torch.incident import IncidentRecorder

    store = telemetry_store.get_store()
    recorder = IncidentRecorder(incident_dir, telemetry_dir=telemetry_dir,
                                min_interval=0.0)
    monitor = store.set_slos(["serve_ttft_ms_p95 < 100"],
                             recorder=recorder)
    now = time_mod.time()
    # ~6 minutes of 5s heartbeats (fast-forwarded timestamps) so both
    # burn-rate windows (60s fast, 300s slow) hold breaching samples.
    for i in range(75):
        store.ingest("serve0", {"serve_ttft_ms_p95": 450.0},
                     ts=now - 370.0 + i * 5.0)
    monitor.evaluate(now=now)
    fired = any(s["firing"] for s in monitor.status())
    # trigger() captures on its own thread: wait for it, not a clock.
    bundles = [os.path.basename(b) for b in recorder.join(timeout=60.0)
               if "slo_breach" in os.path.basename(b)]
    bundle = bundles[-1] if bundles else None
    marker_on_timeline = False
    if bundle is not None:
        trace_path = os.path.join(incident_dir, bundle, "trace.json")
        try:
            with open(trace_path) as f:
                marker_on_timeline = "cluster/slo_breach" in f.read()
        except OSError:
            pass
    return {"fired": bool(fired), "bundle": bundle,
            "breach_marker_on_timeline": marker_on_timeline}


def _toy_lm(device):
    """The drills' tiny fp32 transformer, its weights from seed 0: every
    process that builds it holds the same weights, so handed-off KV pages
    continue the exact greedy stream."""
    import torch

    from tensorflowonspark_tpu_torch.models import factory

    if device == "cpu":
        torch.set_num_threads(1)
    return factory.get_model(
        "transformer", vocab_size=64, num_layers=2, num_heads=4,
        embed_dim=32, mlp_dim=64, max_seq_len=128, remat=False,
        dtype=torch.float32, device=device, seed=0)


def _autoscale_drill(args, workdir, store):
    """Closed-loop autoscaling drill, in-process with REAL
    serving engines: a ServingFleet behind an SLO-watching Autoscaler,
    a ~10x closed-loop traffic ramp (scripts/load_gen.py), an abrupt
    replica preemption mid-burst, and an elastic reservation Server
    whose epoched join/leave directives every replica's heartbeat
    observes. The outcome dict carries everything the drill verdict in
    ``main`` asserts: scale-up latency vs. the burn window, the drain
    audits (every accepted request finished or migrated), the load
    generator's zero-drop bookkeeping, and the membership counters."""
    import threading
    import time as time_mod

    from tensorflowonspark_tpu_torch import reservation, serving, telemetry
    from tensorflowonspark_tpu_torch.testing import load as load_gen

    clock = time_mod.monotonic
    model = _toy_lm(args.device)

    def mk_engine():
        return serving.ServingEngine(
            model, None, max_slots=4, page_size=16, num_pages=64,
            decode_horizon=4, device=args.device).start()

    # The membership plane: a real elastic reservation server; each
    # replica is an in-process "node" with a rendezvous Client whose
    # heartbeats observe the join/leave resize directives.
    server = reservation.Server(count=1, elastic=True,
                                heartbeat_interval=0.5,
                                heartbeat_start_grace=600.0)
    addr = server.start()
    clients, acked, eid_of = {}, {}, {}
    directives = []
    engines_by_name = {}
    spawn_t0, first_token = {}, {}
    next_eid = [0]

    def register(name):
        eid = next_eid[0]
        next_eid[0] += 1
        c = reservation.Client(addr)
        c.register({"executor_id": eid, "job_name": "worker",
                    "role": "serving", "node": name})
        clients[eid] = c
        acked[eid] = 0
        eid_of[name] = eid
        return eid

    def spawn(name):
        spawn_t0[name] = clock()
        eng = mk_engine()
        register(name)
        engines_by_name[name] = eng
        return eng

    def deregister(name, reason):
        eid = eid_of.pop(name, None)
        if eid is not None:
            clients.pop(eid, None)
            server.depart(eid, reason=reason)

    e0 = spawn("serve0")
    fleet = serving.ServingFleet(
        [serving.LocalEngine(e0, name="serve0")])
    policy = serving.AutoscalePolicy(
        metric="serve_ttft_ms_p95", queue_high=2.5, busy_load=0.5,
        min_replicas=1, max_replicas=3, cooldown_up_s=4.0,
        cooldown_down_s=10.0, stable_down_s=5.0, drain_grace_s=1.5)
    scaler = serving.Autoscaler(
        fleet, store, policy, spawn_fn=spawn,
        retire_fn=lambda client: deregister(client.name, "scale_down"))
    monitor = store.set_slos(
        [{"metric": "serve_ttft_ms_p95", "op": "<",
          "threshold": float(args.slo_ttft_ms), "node": "cluster",
          "windows": [[15.0, 0.5], [60.0, 0.1]], "min_points": 4}],
        interval=0.5)
    scaler.attach(monitor)
    slo_fired = [False]
    monitor.add_policy_callback(
        lambda st: st["firing"] and slo_fired.__setitem__(0, True))

    # Stats pump: the heartbeat path minus the sockets for telemetry
    # (node_stats -> store.ingest drives the SLO monitor), PLUS the
    # real sockets for membership (each replica's Client heartbeats;
    # resize directives ride the replies).
    stop_pump = threading.Event()

    def pump():
        while not stop_pump.wait(0.3):
            try:
                store.ingest("serve", telemetry.node_stats())
            except Exception:
                logging.getLogger(__name__).debug(
                    "stats ingest failed", exc_info=True)
            for eid, c in list(clients.items()):
                try:
                    reply = c.heartbeat(eid, state="running",
                                        epoch=acked.get(eid))
                    d = reply.get("resize")
                    if d:
                        directives.append(d)
                        acked[eid] = d["epoch"]
                except Exception:
                    pass

    pump_thread = threading.Thread(target=pump, name="drill-pump",
                                   daemon=True)
    pump_thread.start()

    gen = load_gen.RampLoad(
        fleet.submit, duration=float(args.duration),
        base_rate=float(args.base_rate),
        peak_factor=float(args.peak_factor),
        ramp_start=0.2, ramp_end=0.65, max_new_tokens=8,
        prompt_fn=load_gen.default_prompt_fn(vocab=64),
        priority_fn=lambda i: (0, 0, 1)[i % 3],
        result_timeout=180.0, retries=2)

    drain_audits = []
    preempted = {"name": None}
    scale_up_seconds = []
    peak_replicas = 1

    def audit(drains):
        for d in drains:
            eng = d.engine
            balance = (eng.requests_accepted + eng.migrated_in
                       == eng.requests_finished + eng.requests_cancelled
                       + eng.requests_failed + eng.migrated_out)
            drain_audits.append({
                "replica": d.client.name,
                "accepted": eng.requests_accepted,
                "finished": eng.requests_finished,
                "migrated_out": eng.migrated_out,
                "migrated_in": eng.migrated_in,
                "cancelled": eng.requests_cancelled,
                "failed": eng.requests_failed,
                "ok": bool(balance and eng.requests_failed == 0
                           and eng.requests_cancelled == 0),
            })

    gen.start()
    try:
        t_deadline = clock() + float(args.duration) + 60.0
        while clock() < t_deadline:
            scaler.evaluate()
            audit(scaler.poll_drains())
            for name, eng in list(engines_by_name.items()):
                if name != "serve0" and name not in first_token \
                        and eng.tokens_generated > 0:
                    first_token[name] = clock()
                    scale_up_seconds.append(
                        round(first_token[name] - spawn_t0[name], 3))
            peak_replicas = max(peak_replicas, len(scaler.replicas()))
            # One ABRUPT preemption mid-burst, once a spawned replica
            # exists: the original node dies with its in-flight work
            # (clients retry through the fleet), membership departs it,
            # and the autoscaler replaces the lost capacity.
            if preempted["name"] is None \
                    and clock() - gen.t_start > gen.duration * 0.5:
                draining = {d.client.name for d in scaler.drains}
                live = [c for c in scaler.replicas()
                        if c.name not in draining]
                if len(live) >= 2:
                    victim = next((c for c in live
                                   if c.name == "serve0"), live[0])
                    telemetry.event(
                        "fault/preempt", node=victim.name,
                        executor_id=eid_of.get(victim.name),
                        mode="autoscale_drill")
                    fleet.remove_engine(victim)
                    victim.engine.close(timeout=0.5)
                    engines_by_name.pop(victim.name, None)
                    deregister(victim.name, "preempted")
                    preempted["name"] = victim.name
            gen_done = (gen._driver is not None
                        and not gen._driver.is_alive())
            if gen_done and scaler.scale_downs >= 1 \
                    and not scaler.drains \
                    and len(scaler.replicas()) < peak_replicas:
                break
            time_mod.sleep(0.25)
        gen.stop()
        gen.join(timeout=120.0)
        deadline = clock() + 30.0
        while scaler.drains and clock() < deadline:
            audit(scaler.poll_drains())
            time_mod.sleep(0.25)
    finally:
        stop_pump.set()
        pump_thread.join(timeout=2.0)
        membership = server.membership()
        try:
            fleet.close()
        finally:
            server.stop()
    return {
        "scale_ups": scaler.scale_ups,
        "scale_downs": scaler.scale_downs,
        "scale_up_seconds": scale_up_seconds,
        "slo_fired": bool(slo_fired[0]),
        "preempted": preempted["name"],
        "peak_replicas": peak_replicas,
        "final_replicas": len(scaler.replicas()),
        "drains_pending": len(scaler.drains),
        "drain_audits": drain_audits,
        "membership": membership,
        "directives_seen": len(directives),
        "load": gen.stats(),
        "policy": policy.to_dict(),
    }


def _disagg_child(name, workdir, device, port_q, stop_ev):
    """Decode-pool node for ``--disagg-drill``: a decode-role engine
    behind a real MetricsServer in its OWN process. The seeded init makes
    its weights bit-identical to the driver's, so handed-off KV pages
    continue the exact greedy stream. Reports its serving port through
    ``port_q`` and serves until ``stop_ev`` (or until the drill kills
    it)."""
    from tensorflowonspark_tpu_torch import serving, telemetry
    from tensorflowonspark_tpu_torch.train import metrics

    telemetry.configure(node_id=name,
                        export_dir=os.path.join(workdir, "telemetry"))
    eng = serving.ServingEngine(
        _toy_lm(device), None, max_slots=4, page_size=16, num_pages=64,
        decode_horizon=4, role="decode", device=device).start()
    server = metrics.MetricsServer(engine=eng)
    port_q.put((name, server.start()))
    stop_ev.wait()
    server.stop()
    eng.close(timeout=2.0)


def _disagg_drill(args, workdir, store):
    """Disaggregated prefill/decode drill across REAL
    process boundaries: the driver runs a prefill-role engine; N decode
    children each run a MetricsServer + decode-role engine; one
    ServingFleet routes prompts to the prefill engine and streams the
    finished KV pages to the least-loaded decode node over POST
    /v1/migrate, with the children's load/prefix-digest heartbeats
    arriving via /statusz polls ingested into the history store
    (``heartbeat_stats_fn(store=...)``). Phase 1 asserts the remote
    hops stay bitwise solo-equal; phase 2 kills the whole decode pool
    MID-HANDOFF (inside the wire hop, pages already extracted) and
    asserts the prefill engine replays every stream colocated, still
    bitwise-equal, with its ledger balanced and pages drained."""
    import multiprocessing
    import threading
    import time as time_mod
    import urllib.request

    import numpy as np

    from tensorflowonspark_tpu_torch import serving, telemetry
    from tensorflowonspark_tpu_torch.models import decoding

    model = _toy_lm(args.device)

    def solo(prompt, n_new):
        out = decoding.generate(model, None, np.asarray(prompt)[None],
                                max_new_tokens=n_new, auto_cache=True)
        return out[0, len(prompt):].tolist()

    rng = np.random.RandomState(11)
    cases = [(rng.randint(1, 64, size=n).astype(np.int32), m)
             for n, m in ((29, 8), (41, 6), (23, 10), (35, 8))]

    ctx = multiprocessing.get_context("spawn")
    port_q = ctx.Queue()
    stop_ev = ctx.Event()
    n_decode = max(1, int(args.nodes) - 1)
    procs = {}
    for i in range(n_decode):
        name = "decode{}".format(i)
        proc = ctx.Process(target=_disagg_child,
                           args=(name, workdir, args.device, port_q,
                                 stop_ev),
                           daemon=True)
        proc.start()
        procs[name] = proc
    ports = {}
    deadline = time_mod.monotonic() + 180.0
    while len(ports) < n_decode and time_mod.monotonic() < deadline:
        try:
            name, port = port_q.get(timeout=5.0)
            ports[name] = port
        except Exception:
            if any(not p.is_alive() for p in procs.values()):
                break
    if len(ports) < n_decode:
        stop_ev.set()
        for p in procs.values():
            p.kill()
        raise RuntimeError("decode children failed to start")

    # The heartbeat path over real sockets: poll each child's /statusz
    # (its node_stats carry the serve_* gauges AND the prefix-index
    # digest extra) into the history store the RemoteEngine stats_fn
    # reads load + affinity from.
    stop_pump = threading.Event()

    def pump():
        while not stop_pump.wait(0.3):
            for name, port in list(ports.items()):
                try:
                    with urllib.request.urlopen(
                            "http://127.0.0.1:{}/statusz".format(port),
                            timeout=2.0) as resp:
                        doc = json.loads(resp.read().decode("utf-8"))
                    stats = doc.get("stats") or {}
                    if stats:
                        store.ingest(name, stats)
                except Exception:
                    pass

    pump_thread = threading.Thread(target=pump, name="disagg-pump",
                                   daemon=True)
    pump_thread.start()

    prefill = serving.ServingEngine(
        model, None, max_slots=4, page_size=16, num_pages=64,
        decode_horizon=4, role="prefill", device=args.device)
    remotes = [serving.RemoteEngine(
        "http://127.0.0.1:{}".format(port), name=name, role="decode",
        stats_fn=serving.heartbeat_stats_fn(store=store, node=name))
        for name, port in sorted(ports.items())]
    fleet = serving.ServingFleet(
        [serving.LocalEngine(prefill, name="prefill0")] + remotes).start()

    killed = []
    arm_kill = threading.Event()
    orig_handoff = prefill.handoff_fn

    def gated_handoff(req, payload):
        if arm_kill.is_set():
            # Phase 2: the decode pool dies while THIS transfer is in
            # flight — pages already extracted, wire hop about to go
            # out. Every submit_handoff must fail and the source engine
            # must replay the request colocated.
            for name, proc in procs.items():
                if proc.is_alive():
                    proc.kill()
                    killed.append(name)
            for proc in procs.values():
                proc.join(timeout=10.0)
        return orig_handoff(req, payload)

    prefill.handoff_fn = gated_handoff

    outcome = {"decode_nodes": n_decode, "killed": killed}
    try:
        phase1 = {"total": 0, "matches": 0}
        for p, n_new in cases:
            h = fleet.submit(p, n_new)
            toks = list(h.stream(timeout=240))
            phase1["total"] += 1
            phase1["matches"] += int(toks == solo(p, n_new))
        outcome["phase1"] = phase1
        outcome["handoffs_remote"] = prefill.stats()["handoffs_out"]

        # Remote prefix affinity through the real heartbeat path: the
        # children's index digests (now warm with phase-1 prefixes)
        # arrive via the /statusz pump and score match_tokens > 0.
        warm = 0
        deadline = time_mod.monotonic() + 30.0
        while warm == 0 and time_mod.monotonic() < deadline:
            warm = max(r.match_tokens(cases[0][0]) for r in remotes)
            if warm == 0:
                time_mod.sleep(0.5)
        outcome["affinity_warm_tokens"] = int(warm)

        child_stats = {}
        for name, port in sorted(ports.items()):
            try:
                with urllib.request.urlopen(
                        "http://127.0.0.1:{}/v1/serving".format(port),
                        timeout=5.0) as resp:
                    s = json.loads(resp.read().decode("utf-8"))
                child_stats[name] = {k: s.get(k) for k in
                                     ("role", "accepted", "finished",
                                      "migrated_in", "handoffs_in")}
            except Exception:
                child_stats[name] = None
        outcome["child_stats"] = child_stats

        arm_kill.set()
        phase2 = {"total": 0, "matches": 0}
        for p, n_new in cases[:2]:
            h = fleet.submit(p, n_new)
            toks = list(h.stream(timeout=240))
            phase2["total"] += 1
            phase2["matches"] += int(toks == solo(p, n_new))
        outcome["phase2"] = phase2
        outcome["handoff_fallbacks"] = prefill.stats()["handoff_fallbacks"]

        deadline = time_mod.monotonic() + 15.0
        while prefill.pool.pages_in_use and \
                time_mod.monotonic() < deadline:
            time_mod.sleep(0.05)
        outcome["prefill_pages_in_use"] = int(prefill.pool.pages_in_use)
        s = prefill.stats()
        outcome["prefill_ledger_balanced"] = bool(
            s["accepted"] + s["migrated_in"]
            == s["finished"] + s["cancelled"] + s["failed"]
            + s["migrated_out"])
        qs = telemetry.hist_quantiles("serve_kv_transfer_seconds",
                                      (0.5, 0.95))
        outcome["kv_transfer_ms"] = None if not qs else \
            [round(v * 1e3, 3) for v in qs]
    finally:
        stop_pump.set()
        pump_thread.join(timeout=2.0)
        try:
            fleet.close()
        finally:
            # Graceful stop only while the pool is intact: setting a
            # multiprocessing Event notifies its sleepers, and
            # mp.Condition.notify blocks until woken processes
            # acknowledge — children SIGKILLed mid-``stop_ev.wait()``
            # (the phase-2 kill) never do, deadlocking set() forever.
            if not killed:
                stop_ev.set()
            for proc in procs.values():
                proc.join(timeout=5.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
    return outcome


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fault", default="crash",
                   choices=["crash", "hang", "corrupt", "none"])
    p.add_argument("--step", type=int, default=3,
                   help="step the fault fires at (default 3)")
    p.add_argument("--times", type=int, default=1,
                   help="how many launches fault (default 1: only the first)")
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--workdir", default=None,
                   help="keep state here instead of a throwaway tempdir")
    p.add_argument("--preempt-drill", type=int, default=0, metavar="N",
                   help="elastic drill: spot-preempt N nodes of an "
                        "elastic --nodes cluster and assert "
                        "continue-degraded + re-expand (see module doc)")
    p.add_argument("--nodes", type=int, default=3,
                   help="cluster size for --preempt-drill (default 3)")
    p.add_argument("--slo-drill", action="store_true",
                   help="after the training drill, inject a synthetic "
                        "TTFT stream that breaches an SLO and verify "
                        "the burn-rate alert produces an incident "
                        "bundle with the breach marker on its timeline")
    p.add_argument("--autoscale-drill", action="store_true",
                   help="SLO-driven autoscaling drill: ramp serving "
                        "traffic ~--peak-factor with a replica "
                        "preemption injected and assert scale-up beat "
                        "the burn window, scale-down after the ramp, "
                        "and zero dropped requests across the drain "
                        "(see module doc)")
    p.add_argument("--disagg-drill", action="store_true",
                   help="disaggregated prefill/decode drill: a real "
                        "N-process decode pool (MetricsServer per "
                        "child) behind one ServingFleet, KV pages "
                        "streamed over /v1/migrate, load + prefix-"
                        "digest heartbeats via /statusz ingestion; "
                        "then the decode pool is killed MID-HANDOFF "
                        "and every stream must replay colocated, "
                        "bitwise solo-equal (see module doc)")
    p.add_argument("--duration", type=float, default=30.0,
                   help="--autoscale-drill load duration in seconds")
    p.add_argument("--base-rate", type=float, default=2.0,
                   help="--autoscale-drill baseline request rate (req/s)")
    p.add_argument("--peak-factor", type=float, default=10.0,
                   help="--autoscale-drill burst multiplier over baseline")
    p.add_argument("--slo-ttft-ms", type=float, default=100.0,
                   help="--autoscale-drill TTFT p95 objective (ms)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the drills' models train and serve "
                        "(default cuda)")
    args = p.parse_args(argv)
    if args.autoscale_drill and args.preempt_drill:
        p.error("--autoscale-drill and --preempt-drill are separate drills")
    if args.disagg_drill and (args.autoscale_drill or args.preempt_drill):
        p.error("--disagg-drill is a separate drill")
    serve_only = args.autoscale_drill or args.disagg_drill

    import numpy as np

    from tensorflowonspark_tpu_torch import (backend, cluster, telemetry,
                                             telemetry_store)
    from tensorflowonspark_tpu_torch.supervisor import (PermanentFailure,
                                                        RestartPolicy)
    from tensorflowonspark_tpu_torch.testing.faults import FaultPlan
    from tensorflowonspark_tpu_torch.testing.programs import (
        elastic_linreg_fun, supervised_linreg_fun)
    from tensorflowonspark_tpu_torch.tools import setup_logging

    setup_logging(logging.INFO)
    workdir = os.path.abspath(args.workdir or
                              tempfile.mkdtemp(prefix="tfos-chaos-"))
    model_dir = workdir + "/model"
    # Driver-side spans (rendezvous wait, supervisor teardown/relaunch)
    # land next to the nodes' so the report merges one cluster timeline.
    telemetry_dir = os.path.join(model_dir, "telemetry")
    incident_dir = os.path.join(workdir, "incidents")
    telemetry.configure(node_id="driver", export_dir=telemetry_dir)
    # History plane: heartbeat stats are retained across the whole drill
    # (the supervised relaunch reuses this store), so the report carries
    # the goodput series — the restart dip and recovery on one curve.
    store = telemetry_store.configure()
    plan = FaultPlan(workdir + "/faults")
    if args.preempt_drill:
        if args.preempt_drill >= args.nodes:
            p.error("--preempt-drill must kill fewer than --nodes nodes")
        plan.preempt_node(args.step, times=args.preempt_drill, grace=0.6)
    elif args.fault == "crash":
        plan.crash_at_step(args.step, times=args.times)
    elif args.fault == "hang":
        plan.hang_at_step(args.step, times=args.times)
        plan.drop_heartbeats_after(args.step, times=args.times)
    elif args.fault == "corrupt":
        plan.corrupt_latest_checkpoint(args.step, times=args.times)

    drill = int(args.preempt_drill)
    rng = np.random.RandomState(7)
    n_items = 768 if drill else 256
    x = rng.rand(n_items, 2).astype(np.float32)
    y = (x @ np.asarray([1.5, -2.0]) + 0.25).astype(np.float32)
    data = backend.Partitioned.from_items(
        [(x[i].tolist(), float(y[i])) for i in range(len(x))],
        12 if drill else 2)

    num_exec = args.nodes if drill else 1
    pool = None if serve_only else \
        backend.LocalBackend(num_exec, base_dir=workdir + "/exec")
    outcome = {"fault": "autoscale" if args.autoscale_drill
               else "disagg" if args.disagg_drill
               else "preempt" if drill else args.fault,
               "step": args.step, "times": drill or args.times,
               "workdir": workdir}
    rc = 0
    try:
        if args.autoscale_drill:
            # No training cluster at all: the serving fleet + elastic
            # membership + telemetry planes close the loop in-process.
            outcome["autoscale"] = _autoscale_drill(args, workdir, store)
        elif args.disagg_drill:
            # Prefill engine in the driver, decode pool across real
            # child processes; no training cluster.
            outcome["disagg"] = _disagg_drill(args, workdir, store)
        elif drill:
            # The elastic path: per-node checkpoint subtrees + audit
            # logs, membership survives the preemptions in place.
            log_dir = os.path.join(workdir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            sup = cluster.run(
                pool, elastic_linreg_fun,
                {"model_dir": model_dir, "plan_dir": plan.plan_dir,
                 "log_dir": log_dir, "step_sleep": 0.05,
                 "device": args.device},
                num_executors=num_exec, input_mode=cluster.InputMode.FEED,
                restart_policy=RestartPolicy(max_restarts=args.max_restarts),
                checkpoint_dir=model_dir,
                elastic=dict(min_nodes=args.nodes - drill,
                             rejoin_delay=1.0),
                heartbeat_interval=0.3, heartbeat_miss_budget=10,
                telemetry_dir=telemetry_dir,
                incident_dir=incident_dir,
            )
        else:
            sup = cluster.run(
                pool, supervised_linreg_fun,
                {"model_dir": model_dir, "plan_dir": plan.plan_dir,
                 "device": args.device},
                num_executors=1, input_mode=cluster.InputMode.FEED,
                restart_policy=RestartPolicy(max_restarts=args.max_restarts),
                checkpoint_dir=model_dir,
                heartbeat_interval=0.5, heartbeat_miss_budget=8,
                telemetry_dir=telemetry_dir,
                incident_dir=incident_dir,
            )
        if not serve_only:
            try:
                report = sup.train(data, num_epochs=args.epochs,
                                   timeout=600)
                outcome.update(report, survived=True)
            except PermanentFailure as e:
                rc = 2
                outcome.update(sup.report() or {}, survived=False,
                               permanent_failure=str(e).splitlines()[0])
    finally:
        if pool is not None:
            pool.stop()
        # Goodput accounting over the drill: the per-interval series
        # (dips to zero across the injected failure, recovers after the
        # relaunch) plus the cumulative breakdown — and a store spill
        # (telemetry_store.load_export reads it back).
        outcome["goodput"] = {
            "summary": store.goodput.summary(),
            "series": [[round(t, 3), round(v, 4)] for t, v in
                       store.points("goodput", node="cluster",
                                    window=3600.0)],
        }
        try:
            outcome["history_export"] = store.export(
                os.path.join(model_dir, "history.jsonl"))
        except OSError:
            pass
        if args.slo_drill:
            outcome["slo_drill"] = _slo_drill(
                telemetry_store, incident_dir, telemetry_dir)
        # Merge the per-node span logs into one Perfetto-loadable
        # timeline and embed the restart markers in the report — the
        # crash, the supervisor relaunch, and the resume-from-committed
        # step must all be visible without re-running the drill.
        telemetry.disable()  # flush/close the driver's span file
        try:
            spans = (telemetry.load_spans(telemetry_dir)
                     if os.path.isdir(telemetry_dir) else [])
        except OSError:
            spans = []
        if spans:
            offsets = telemetry.estimate_clock_offsets(spans)
            trace = telemetry.write_trace(
                spans, os.path.join(telemetry_dir, "trace.json"),
                offsets=offsets)
            outcome["timeline"] = {
                "trace": trace,
                "spans": len(spans),
                "nodes": sorted({str(d.get("node", "?")) for d in spans}),
                "phases": telemetry.phase_breakdown(spans),
                "restart_timeline": telemetry.restart_markers(
                    spans, offsets=offsets),
            }
        # Incident bundles written by the supervision layer's
        # capture-before-teardown (and any straggler triggers): the
        # drill's report embeds each bundle's manifest summary (it must
        # survive an ephemeral workdir), and with --workdir the full
        # report.txt is rendered into each surviving bundle via
        # scripts/torch_incident_report.py.
        if os.path.isdir(incident_dir):
            bundles = sorted(
                d for d in os.listdir(incident_dir)
                if os.path.isfile(
                    os.path.join(incident_dir, d, "manifest.json")))
            outcome["incidents"] = []
            for name in bundles:
                try:
                    with open(os.path.join(incident_dir, name,
                                           "manifest.json")) as f:
                        man = json.load(f)
                except (OSError, ValueError):
                    man = {}
                prof_dir = os.path.join(incident_dir, name, "profiles")
                profiles = sorted(
                    f[:-len(".folded")] for f in os.listdir(prof_dir)
                    if f.endswith(".folded")) if os.path.isdir(
                        prof_dir) else []
                outcome["incidents"].append({
                    "name": name,
                    **{k: man.get(k) for k in
                       ("reason", "iso", "nodes_captured", "nodes_missing")},
                    "profiles": profiles,
                })
            if args.workdir is not None and bundles:
                sys.path.insert(
                    0, os.path.dirname(os.path.abspath(__file__)))
                import torch_incident_report

                for name in bundles:
                    try:
                        torch_incident_report.render(
                            os.path.join(incident_dir, name))
                    except Exception:
                        logging.getLogger(__name__).warning(
                            "incident report rendering failed for %s",
                            name, exc_info=True)
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
            outcome.pop("workdir")
            outcome.pop("history_export", None)  # went with the tempdir
            if "timeline" in outcome:  # file went with the tempdir
                outcome["timeline"].pop("trace")
    if args.autoscale_drill:
        # The drill verdict: the loop closed — the burn
        # rate/queue pressure scaled the fleet up inside the burn
        # window, the fleet rode out an abrupt preemption, scaled back
        # down through a graceful drain that dropped NOTHING, and every
        # policy decision is a marker on the merged timeline.
        au = outcome.get("autoscale") or {}
        load = au.get("load") or {}
        audits = au.get("drain_audits") or []
        markers = [m["name"] for m in
                   (outcome.get("timeline") or {}).get("restart_timeline",
                                                       [])]
        checks = {
            "scaled_up": au.get("scale_ups", 0) >= 1,
            "scale_up_within_burn_window":
                bool(au.get("scale_up_seconds"))
                and min(au["scale_up_seconds"]) < 60.0,
            "slo_fired": bool(au.get("slo_fired")),
            "preempt_injected": au.get("preempted") is not None,
            "scaled_down_after_ramp": au.get("scale_downs", 0) >= 1,
            "drains_completed": au.get("drains_pending", 1) == 0
                and len(audits) >= 1,
            "drain_zero_drop": bool(audits)
                and all(a["ok"] for a in audits),
            "zero_dropped_requests": load.get("accepted", 0) > 0
                and load.get("dropped", 1) == 0,
            "replicas_scaled_back":
                au.get("final_replicas", 99) < au.get("peak_replicas", 0),
            "scale_up_marker_on_timeline": any(
                m.startswith("cluster/scale_up") for m in markers),
            "drain_markers_on_timeline": any(
                m.startswith("cluster/drain") for m in markers)
                and any(m.startswith("cluster/drain_done")
                        for m in markers),
            "preempt_marker_on_timeline": any(
                m.startswith("fault/preempt") for m in markers),
        }
        outcome["autoscale_drill"] = dict(checks, ok=all(checks.values()))
        if not all(checks.values()) and rc == 0:
            rc = 2
    if args.disagg_drill:
        # The drill verdict: KV pages crossed REAL process
        # boundaries and the streams stayed bitwise solo-equal, the
        # children's heartbeat digests scored remote prefix affinity,
        # and killing the decode pool mid-handoff lost NOTHING — every
        # in-flight request replayed colocated, byte-identical, with
        # the prefill ledger balanced and its pages drained.
        dz = outcome.get("disagg") or {}
        p1, p2 = dz.get("phase1") or {}, dz.get("phase2") or {}
        checks = {
            "decode_pool_spawned": dz.get("decode_nodes", 0) >= 1,
            "remote_handoffs": dz.get("handoffs_remote", 0) >= 1,
            "phase1_bitwise_solo_equal": p1.get("total", 0) >= 1
                and p1.get("matches") == p1.get("total"),
            "affinity_digest_scored": dz.get("affinity_warm_tokens",
                                             0) > 0,
            "decode_pool_killed_mid_handoff": bool(dz.get("killed")),
            "fallback_colocated_replay":
                dz.get("handoff_fallbacks", 0) >= 1,
            "phase2_bitwise_solo_equal": p2.get("total", 0) >= 1
                and p2.get("matches") == p2.get("total"),
            "prefill_ledger_balanced":
                bool(dz.get("prefill_ledger_balanced")),
            "prefill_pages_drained":
                dz.get("prefill_pages_in_use", 1) == 0,
            "kv_transfer_observed": bool(dz.get("kv_transfer_ms")),
        }
        outcome["disagg_drill"] = dict(checks, ok=all(checks.values()))
        if not all(checks.values()) and rc == 0:
            rc = 2
    if drill:
        # The drill verdict: degraded-continue IN PLACE (no supervised
        # relaunch), every preempted slot departed and rejoined, the
        # cluster re-expanded, and the resize barrier is visible on the
        # merged timeline.
        membership = outcome.get("membership") or {}
        markers = [m["name"] for m in
                   (outcome.get("timeline") or {}).get("restart_timeline",
                                                       [])]
        checks = {
            "zero_restarts": outcome.get("restarts") == 0,
            "departed": membership.get("departures", 0) >= drill,
            "rejoined": membership.get("rejoins", 0) >= 1,
            "re_expanded": membership.get("world_size") == args.nodes,
            "reshape_marker_on_timeline": any(
                m.startswith("cluster/reshape") for m in markers),
        }
        outcome["elastic_drill"] = dict(checks, ok=all(checks.values()),
                                        nodes=args.nodes, preempted=drill)
        if not all(checks.values()) and rc == 0:
            rc = 2
    print(json.dumps(outcome))
    return rc


if __name__ == "__main__":
    sys.exit(main())

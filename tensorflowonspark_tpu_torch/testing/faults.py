"""Deterministic fault injection for the supervision layer (the port's
copy of the JAX package's ``testing/faults.py``).

A :class:`FaultPlan` is a directory of filesystem flags. The driver (or a
test) *arms* faults by writing spec files; node programs *poll* them at
well-defined points (``on_step``, ``on_feed_item``). Each armed fault
fires at most ``times`` times across all launches — firing atomically
claims a ``<kind>.fired.<n>`` marker with ``O_CREAT|O_EXCL`` — so "crash
the first launch at step 3, let the relaunch run clean" is one flag file,
with no coordination code in the node program. The harness is
stdlib-only and safe to import anywhere. The on-disk plan is the JAX
package's, file for file: a plan armed by either package fires in the
other, and the two share its budget.

Faults:

* ``crash_at_step(k)``        — raise :class:`InjectedFault` at step >= k
  (the preempted-host / poisoned-batch class);
* ``hang_at_step(k)``         — sleep "forever" at step >= k (the wedged
  native-collective class; pair with ``drop_heartbeats_after`` to model
  a GIL-holding wedge that silences the liveness beacon);
* ``drop_heartbeats_after(k)``— from step k, the process-local heartbeat
  sender skips its beats (the network-partition / silent-death class);
* ``corrupt_latest_checkpoint(k)`` — at step k, truncate the files of the
  newest checkpoint step and crash (the crash-mid-checkpoint-write
  class; restore must fall back to the prior committed step);
* ``kill_feed_queue(n)``      — raise after the consumer has taken n feed
  items, while the feeder is still putting (the
  consumer-died-mid-partition class);
* ``kill_decode_worker(n)``   — SIGKILL one live decode-pool worker after
  n decoded batches (the recovery drill of ``data/decode_pool``);
* ``preempt_node(k, grace=...)`` — spot/preemptible-VM preemption: at
  step >= k the process gets a termination NOTICE (a ``fault/preempt``
  marker + a SIGTERM handler armed to raise :class:`Preempted`), then
  SIGTERM after ``grace`` seconds — the scheduler's
  notice-then-terminate contract, vs ``crash_at_step``'s instant death.
  The grace window is exactly what lets the node commit its current
  step before dying, so an elastic survivor reshapes from that step.
  Python runs the handler only between bytecodes: a SIGTERM that lands
  while the main thread waits on the card (a stream synchronisation, a
  ``torch.save``) raises once that wait ends, so on the card the grace
  must cover a step and a commit.
"""

import json
import logging
import os
import signal
import threading
import time

logger = logging.getLogger(__name__)

CRASH = "crash_at_step"
HANG = "hang_at_step"
DROP_HEARTBEATS = "drop_heartbeats_after"
CORRUPT = "corrupt_latest_checkpoint"
KILL_FEED = "kill_feed_queue"
KILL_DECODE_WORKER = "kill_decode_worker"
PREEMPT = "preempt_node"


class InjectedFault(RuntimeError):
    """An armed fault firing (deliberately not a framework error type)."""


class Preempted(InjectedFault):
    """The injected SIGTERM of a spot preemption landing (raised from the
    signal handler on the preempted process's main thread, so the node
    program's normal error path — traceback to the error queue, manager
    state ``error``, final ``error`` heartbeat — reports it like any
    other death, just with notice)."""


# Process-local heartbeat kill switch. DROP_HEARTBEATS *arms* on the
# filesystem but *fires* into this flag: the drop must die with the
# faulted process — a filesystem flag would keep suppressing beats in the
# relaunched process and make every recovery look hung.
_heartbeats_dropped = False


def heartbeats_dropped():
    """Polled by ``node.HeartbeatSender`` before every beat."""
    return _heartbeats_dropped


def _set_heartbeats_dropped():
    global _heartbeats_dropped
    _heartbeats_dropped = True


def _fire_preemption(step, grace):
    """Deliver the preemption notice: arm a SIGTERM handler that raises
    :class:`Preempted`, emit the timeline marker, and schedule the kill.
    Runs on the node program's main thread (``on_step`` is called from
    the training loop), which is the only thread allowed to install
    signal handlers."""

    def _on_sigterm(signum, frame):
        raise Preempted(
            "injected spot preemption: SIGTERM after {:.2f}s notice "
            "(fired at step {})".format(grace, step)
        )

    signal.signal(signal.SIGTERM, _on_sigterm)
    logger.warning("injected preemption NOTICE at step %d: SIGTERM in "
                   "%.2fs", step, grace)
    try:
        from tensorflowonspark_tpu_torch import telemetry

        telemetry.event("fault/preempt", step=step, grace=grace)
    except Exception:  # pragma: no cover - telemetry is optional here
        pass
    timer = threading.Timer(grace, os.kill, (os.getpid(), signal.SIGTERM))
    timer.daemon = True
    timer.start()


def corrupt_step(checkpoint_dir, step=None, mode="truncate"):
    """Damage a checkpoint step in place (default: the newest step dir).

    ``truncate`` halves every file (a torn write); ``delete`` removes
    every other file (a partially-uploaded step). On the port's layout
    (``<dir>/<step>/default/{model_state,opt_state,params}.pt``) ``delete``
    removes ``model_state.pt`` and ``params.pt``. The commit marker
    outside the step dir is left alone — the point is that marker
    *validation* must catch the damage. Returns the damaged step, or
    None when the directory holds no step.
    """
    from tensorflowonspark_tpu_torch import fs as fs_lib

    root = os.path.abspath(fs_lib.local_path(os.fspath(checkpoint_dir)))
    if step is None:
        steps = sorted(
            (int(n) for n in os.listdir(root) if n.isdigit()), reverse=True
        ) if os.path.isdir(root) else []
        if not steps:
            return None
        step = steps[0]
    step_dir = os.path.join(root, str(step))
    damaged = 0
    for sub, _, names in os.walk(step_dir):
        for i, name in enumerate(sorted(names)):
            path = os.path.join(sub, name)
            if mode == "delete":
                if i % 2 == 0:
                    os.unlink(path)
                    damaged += 1
                continue
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(size // 2)
            damaged += 1
    logger.warning("fault injection damaged %d file(s) under step %s of %s",
                   damaged, step, root)
    return step


class FaultPlan:
    """One directory of armed faults + fired markers (see module doc)."""

    def __init__(self, plan_dir):
        self.plan_dir = os.fspath(plan_dir)
        os.makedirs(self.plan_dir, exist_ok=True)

    # -- arming (driver / test / CLI side) ----------------------------------

    def arm(self, kind, times=1, **spec):
        spec = dict(spec, times=int(times))
        path = os.path.join(self.plan_dir, kind + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(spec, f)
        os.replace(tmp, path)
        return self

    def crash_at_step(self, step, times=1):
        return self.arm(CRASH, times, step=int(step))

    def hang_at_step(self, step, times=1, duration=3600.0):
        return self.arm(HANG, times, step=int(step), duration=float(duration))

    def drop_heartbeats_after(self, step, times=1):
        return self.arm(DROP_HEARTBEATS, times, step=int(step))

    def corrupt_latest_checkpoint(self, step, times=1, mode="truncate"):
        return self.arm(CORRUPT, times, step=int(step), mode=mode)

    def kill_feed_queue(self, after_items, times=1):
        return self.arm(KILL_FEED, times, after_items=int(after_items))

    def kill_decode_worker(self, after_batches, times=1):
        return self.arm(KILL_DECODE_WORKER, times,
                        after_batches=int(after_batches))

    def preempt_node(self, after_step, grace=0.5, times=1):
        """SIGTERM-with-notice spot preemption at step >= ``after_step``
        (see module doc); ``grace`` seconds between notice and SIGTERM."""
        return self.arm(PREEMPT, times, step=int(after_step),
                        grace=float(grace))

    def fired(self, kind):
        """How many times ``kind`` has fired (across all launches)."""
        return len([
            n for n in os.listdir(self.plan_dir)
            if n.startswith(kind + ".fired.")
        ])

    def reset(self):
        """Disarm everything and forget all firings."""
        for name in os.listdir(self.plan_dir):
            try:
                os.unlink(os.path.join(self.plan_dir, name))
            except OSError:  # pragma: no cover - concurrent reset
                pass

    # -- node side ----------------------------------------------------------

    def on_step(self, step, checkpoint_dir=None):
        """Call once per completed optimizer step. Fires any armed step
        faults whose threshold is reached, in severity order: heartbeat
        drop (silent — training continues), checkpoint corruption
        (+ crash), hang, crash."""
        step = int(step)
        spec = self._armed(DROP_HEARTBEATS, step)
        if spec and self._claim(DROP_HEARTBEATS, spec):
            logger.warning("injected heartbeat drop from step %d", step)
            _set_heartbeats_dropped()
        spec = self._armed(PREEMPT, step)
        if spec and self._claim(PREEMPT, spec):
            # Notice now, death after the grace window: training continues
            # (and may commit the in-flight step) until the timer's
            # SIGTERM raises Preempted on the main thread.
            _fire_preemption(step, float(spec.get("grace", 0.5)))
        spec = self._armed(CORRUPT, step)
        if spec and self._claim(CORRUPT, spec):
            damaged = None
            if checkpoint_dir is not None:
                damaged = corrupt_step(checkpoint_dir,
                                       mode=spec.get("mode", "truncate"))
            raise InjectedFault(
                "injected checkpoint corruption at step {} "
                "(damaged step {})".format(step, damaged)
            )
        spec = self._armed(HANG, step)
        if spec and self._claim(HANG, spec):
            duration = float(spec.get("duration", 3600.0))
            logger.warning("injected hang at step %d for %.0fs", step, duration)
            time.sleep(duration)
            raise InjectedFault("injected hang at step {} elapsed".format(step))
        spec = self._armed(CRASH, step)
        if spec and self._claim(CRASH, spec):
            raise InjectedFault("injected failure at step {}".format(step))

    def on_pool_batch(self, count, pool):
        """Call per batch yielded by a :class:`~tensorflowonspark_tpu_torch
        .data.decode_pool.DecodePool` stream; fires ``kill_decode_worker``
        by SIGKILLing one live worker of ``pool`` (picked
        deterministically: the lowest pid, so a repeated drill is
        reproducible). Returns the killed pid, or None when nothing
        fired."""
        spec = self._read(KILL_DECODE_WORKER)
        if not (spec and int(count) >= spec.get("after_batches", 0)):
            return None
        # Liveness BEFORE the claim: an empty pool (workers mid-respawn/
        # close) must not consume the bounded fire — the drill would
        # then never kill anything and pass vacuously.
        pids = sorted(pool.worker_pids())
        if not pids or not self._claim(KILL_DECODE_WORKER, spec):
            return None
        logger.warning("fault injection SIGKILLs decode worker pid=%d "
                       "after %d batch(es)", pids[0], count)
        os.kill(pids[0], signal.SIGKILL)
        return pids[0]

    def on_feed_item(self, count):
        """Call per consumed feed item; fires ``kill_feed_queue``."""
        spec = self._read(KILL_FEED)
        if spec and int(count) >= spec.get("after_items", 0) and \
                self._claim(KILL_FEED, spec):
            raise InjectedFault(
                "injected feed-consumer death after {} item(s)".format(count)
            )

    # -- internals ----------------------------------------------------------

    def _read(self, kind):
        try:
            with open(os.path.join(self.plan_dir, kind + ".json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _armed(self, kind, step):
        spec = self._read(kind)
        if spec is not None and step >= spec.get("step", 0):
            return spec
        return None

    def _claim(self, kind, spec):
        """Atomically claim one firing slot; False once ``times`` spent."""
        for i in range(max(1, spec.get("times", 1))):
            path = os.path.join(
                self.plan_dir, "{}.fired.{}".format(kind, i)
            )
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            os.write(fd, "pid={} time={}\n".format(
                os.getpid(), time.time()).encode())
            os.close(fd)
            return True
        return False

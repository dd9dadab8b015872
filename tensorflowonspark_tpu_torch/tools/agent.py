"""Per-host executor agent CLI (the port of the JAX package's
``tools/agent.py``).

Run one per host to form a cross-host executor pool for a driver's
:class:`~tensorflowonspark_tpu_torch.backend_remote.RemoteBackend` — the
role Spark executors played for the reference. The authkey
authenticates the connection (HMAC challenge); pass it hex-encoded via
``--authkey`` or the ``TPU_FRAMEWORK_AGENT_KEY`` environment variable.

Usage::

    python -m tensorflowonspark_tpu_torch.tools.agent \
        --driver driver-host:7077 --authkey <hex> [--base_dir /scratch]
"""

import argparse
import logging
import os

from tensorflowonspark_tpu_torch import backend_remote
from tensorflowonspark_tpu_torch.tools import setup_logging


def build_parser():
    p = argparse.ArgumentParser(description="Join a driver's executor pool")
    p.add_argument("--driver", required=True, help="driver host:port")
    p.add_argument("--authkey", default=None,
                   help="hex authkey (or env TPU_FRAMEWORK_AGENT_KEY)")
    p.add_argument("--base_dir", default=None,
                   help="working-directory root for this agent")
    p.add_argument("--task_timeout", type=float, default=None,
                   help="hard per-task deadline (seconds): a wedged task "
                        "exits the agent process (os._exit) so the "
                        "supervisor loop can restart it")
    p.add_argument("--restart", action="store_true",
                   help="supervise: rerun the agent (fresh process, "
                        "backoff) after an abnormal exit — paired with "
                        "--task_timeout this self-heals wedged agents; "
                        "the driver reclaims the slot on reconnect")
    return p


def _serve(driver, key_hex, base_dir, task_timeout):
    host, _, port = driver.rpartition(":")
    idx, clean = backend_remote.agent_main(
        (host, int(port)), bytes.fromhex(key_hex), base_dir=base_dir,
        task_timeout=task_timeout,
    )
    print("agent {} done ({})".format(
        idx, "stopped" if clean else "connection lost"))
    if not clean:
        # Distinct exit so a --restart supervisor reconnects: only the
        # driver's explicit stop frame ends supervision (EOF exiting 0
        # would make one network blip permanent).
        raise SystemExit(112)


def main(argv=None):
    import multiprocessing
    import time

    setup_logging(logging.INFO)
    args = build_parser().parse_args(argv)
    key_hex = args.authkey or os.environ.get("TPU_FRAMEWORK_AGENT_KEY")
    if not key_hex:
        raise SystemExit("need --authkey or TPU_FRAMEWORK_AGENT_KEY")
    if not args.restart:
        _serve(args.driver, key_hex, args.base_dir, args.task_timeout)
        return
    # Supervisor shape: the serving loop runs in a CHILD process (the
    # watchdog's os._exit must not kill the supervisor), restarted with
    # backoff after any abnormal exit; a clean stop ends supervision.
    ctx = multiprocessing.get_context("spawn")
    backoff = 1.0
    quick_failures = 0
    while True:
        p = ctx.Process(target=_serve,
                        args=(args.driver, key_hex, args.base_dir,
                              args.task_timeout),
                        name="agent-serve")
        t0 = time.monotonic()
        p.start()
        p.join()
        if p.exitcode == 0:
            return
        # A child that dies within seconds WITHOUT having served never
        # reached the driver (stop() can close connections without a
        # stop frame, and reconnects are then refused). Bounded retries
        # stop the supervisor from spinning against a dead address
        # forever. Exit 114 (task watchdog) proves the child connected
        # and served — never counted, however fast (a sub-2s
        # task_timeout must not end supervision).
        if time.monotonic() - t0 < 2.0 and p.exitcode != 114:
            quick_failures += 1
            if quick_failures >= 5:
                raise SystemExit(
                    "driver unreachable after {} quick failures; ending "
                    "supervision".format(quick_failures))
        else:
            quick_failures = 0
            backoff = 1.0  # isolated failures must not ratchet forever
        logging.getLogger(__name__).warning(
            "agent exited with code %s; restarting in %.1fs",
            p.exitcode, backoff)
        time.sleep(backoff)
        backoff = min(backoff * 2, 30.0)


if __name__ == "__main__":
    main()

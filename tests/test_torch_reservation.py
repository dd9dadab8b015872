"""The port's reservation server and client against the JAX package's.

The wire format is the JAX package's frame for frame (a 4-byte big-endian
length, then UTF-8 JSON), so each side's ``Client`` registers with the
other's ``Server``: cluster info, heartbeats, STOP, and malformed frames
behave the same in both directions. Everything runs over real sockets on
ephemeral ports.
"""

import socket
import threading

import pytest

from tensorflowonspark_tpu import reservation as jax_res
from tensorflowonspark_tpu_torch import reservation as port_res

pytestmark = pytest.mark.watchdog_timeout(120)

PAIRS = {
    "port_client_jax_server": (jax_res, port_res),
    "jax_client_port_server": (port_res, jax_res),
    "port_client_port_server": (port_res, port_res),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_register_info_heartbeat_and_stop_across_packages(pair):
    server_mod, client_mod = PAIRS[pair]
    server = server_mod.Server(2, heartbeat_interval=0.2)
    addr = server.start()
    a, b = client_mod.Client(addr), client_mod.Client(addr)
    try:
        assert a.get_reservations() == []
        metas = [{"executor_id": i, "host": "127.0.0.1", "port": 2000 + i,
                  "job_name": "worker", "task_index": i} for i in range(2)]
        a.register(metas[0])
        a.register(metas[0])  # a retried REG replaces, never double-counts
        assert not server.reservations.done()
        b.register(metas[1])
        assert sorted(a.await_reservations(timeout=10, poll=0.05),
                      key=lambda m: m["executor_id"]) == metas
        assert sorted(server.await_reservations(timeout=10),
                      key=lambda m: m["executor_id"]) == metas
        reply = a.heartbeat(0, state="running", stats={"step": 3.0})
        assert reply["ok"] is True and reply["done"] is False
        assert server.liveness.classify(0) == "alive"
        assert server.liveness.cluster_stats()[0]["step"] == 3.0
        b.request_stop()
        assert server.done.wait(timeout=5)
        assert a.heartbeat(1, state="finished")["done"] is True
    finally:
        a.close()
        b.close()
        server.stop()


def _garbage_replies(server_mod, client_mod):
    """Replies of ``server_mod``'s server to malformed input, framed by
    ``client_mod``: a non-dict payload, a REG without meta, an unknown
    type, then raw garbage bytes on a second connection; afterwards a
    proper client must still register."""
    server = server_mod.Server(1)
    addr = server.start()
    replies = []
    try:
        s = socket.create_connection(addr, timeout=10)
        for msg in ("not-a-dict", {"type": "REG"}, {"type": "NOPE"}):
            client_mod.MessageSocket.send_msg(s, msg)
            replies.append(client_mod.MessageSocket.recv_msg(s))
        s.close()
        raw = socket.create_connection(addr, timeout=10)
        raw.sendall(b"\x00\x00\x00\x05{{{{{" + b"\xff" * 64)
        raw.settimeout(5)
        try:
            got = raw.recv(1024)
        except (ConnectionError, socket.timeout):
            got = b""
        replies.append("closed" if got == b"" else "answered")
        raw.close()
        c = client_mod.Client(addr)
        c.register({"executor_id": 0})
        assert server.reservations.done()
        c.close()
    finally:
        server.stop()
    return replies


def test_malformed_frames_and_garbage_bytes_behave_alike():
    want = _garbage_replies(jax_res, jax_res)
    assert want[3] == "closed"
    assert _garbage_replies(port_res, port_res) == want
    assert _garbage_replies(port_res, jax_res) == want
    assert _garbage_replies(jax_res, port_res) == want


@pytest.mark.parametrize("msg", [
    {"type": "REG", "meta": {"executor_id": 3, "host": "h"}, "reg_id": "x"},
    {"type": "HB", "executor_id": 1, "state": "running",
     "stats": {"step": 2.0, "rss_mb": 10.5}, "epoch": None},
    {"type": "QINFO"}, "text", [1, 2.5, None],
])
def test_frames_are_byte_for_byte_equal(msg):
    frames = []
    for mod in (jax_res, port_res):
        left, right = socket.socketpair()
        try:
            mod.MessageSocket.send_msg(left, msg)
            left.shutdown(socket.SHUT_WR)
            data = b""
            while True:
                chunk = right.recv(4096)
                if not chunk:
                    break
                data += chunk
            frames.append(data)
            # And each package reads the other's frame back.
            a, b = socket.socketpair()
            a.sendall(data)
            other = port_res if mod is jax_res else jax_res
            assert other.MessageSocket.recv_msg(b) == msg
            a.close()
            b.close()
        finally:
            left.close()
            right.close()
    assert frames[0] == frames[1]


def test_concurrent_registration_and_relaunch_replace():
    n = 6
    server = port_res.Server(n)
    addr = server.start()
    try:
        def register(i):
            c = port_res.Client(addr)
            c.register({"executor_id": i, "port": 1000 + i})
            c.await_reservations(timeout=30, poll=0.05)
            c.close()

        threads = [threading.Thread(target=register, args=(i,))
                   for i in range(n - 1)]
        for t in threads:
            t.start()
        relaunched = port_res.Client(addr)
        relaunched.register({"executor_id": 0, "port": 9999})
        relaunched.register({"executor_id": n - 1, "port": 1000 + n - 1})
        for t in threads:
            t.join(timeout=30)
        info = server.await_reservations(timeout=10)
        assert sorted(m["executor_id"] for m in info) == list(range(n))
        ports = {m["executor_id"]: m["port"] for m in info}
        assert len(ports) == n
        relaunched.close()
    finally:
        server.stop()


def test_server_await_times_out_and_aborts_on_error():
    server = port_res.Server(2)
    server.start()
    try:
        with pytest.raises(TimeoutError):
            server.await_reservations(timeout=0.3)
        with pytest.raises(RuntimeError):
            server.await_reservations(status={"error": "launch failed"},
                                      timeout=30)
    finally:
        server.stop()

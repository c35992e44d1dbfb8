"""Network front door: a stdlib-only TCP endpoint over the batcher (the
port's copy of ``parallel_cnn_tpu/serve/net.py``: the same protocol, byte
for byte, and the same decisions).

The serve stack below this module (engine → batcher → admission →
autoscaler) is in-process; this is the tier that puts a real socket —
and therefore real failure modes — in front of it, without leaving the
standard library (``socketserver`` + ``json``):

- **Protocol**: newline-delimited JSON over a persistent TCP
  connection. Request: ``{"id": N, "x": [...], "deadline_ms": MS?,
  "priority": "guaranteed"|"best-effort"?}``; response:
  ``{"id": N, "ok": true, "y": [...]}`` or ``{"id": N, "ok": false,
  "error": "Overloaded"|"DeadlineExceeded"|"Failed"|"BadRequest",
  "message": ...}``. One handler thread per connection; requests on a
  connection are served in order, concurrency comes from connections
  (exactly how the threaded loadgen clients drive it). A float32 sample
  survives ``tolist()`` → JSON → ``np.asarray(..., float32)`` bit for
  bit (JSON carries the exact double of each float32).
- **Host only**: handler threads decode JSON into numpy and call
  ``batcher.submit``; they never touch the card. The forward stays on
  the batcher's runner threads.
- **Deadline mapping**: a request that carries ``deadline_ms`` is
  latency-bound — it enters ``submit()`` with that budget in the
  ``guaranteed`` class. A request without one inherits the
  per-connection deadline as its budget and rides ``best-effort`` (the
  class the degradation ladder drops first). An explicit ``priority``
  field overrides the inference.
- **Read/write deadlines**: a connection gets ``conn_deadline_ms`` to
  finish delivering each request line; a socket that stalls mid-body
  past it is *reaped* — counted ``expired`` at the wire tier (journal
  ``conn_expired``), connection closed, handler thread freed. The
  slow-loris defense: a dripping client costs one bounded thread for
  one bounded deadline, never a hang. Blocked response writes are
  abandoned the same way. An *idle* connection (no partial request
  buffered) times out and closes quietly — keep-alive gaps between
  requests are not an attack.
- **Conservation over the wire**: every request observed on the socket
  resolves exactly once in :class:`~parallel_cnn_tpu_torch.serve.
  telemetry.WireStats` — ``submitted == completed + shed + expired +
  failed`` — with the wire lifecycle journaled as ``net_submit`` /
  ``net_complete`` / ``net_shed`` / ``net_expired`` / ``net_failed``
  (``obs.conservation(counts, prefix="net_")`` checks the law over the
  journal). The batcher's own law keeps holding one tier down.
- **Chaos**: ``kill-endpoint@SEQ`` (resilience/chaos.py) kills the
  endpoint the moment it has accepted wire request SEQ: in-flight wire
  requests are journaled ``net_failed`` — never silently lost — and
  every connection drops. The supervisor (serve/supervisor.py) is the
  recovery path; without it the gate trips, which is the point.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.serve.batcher import DeadlineExceeded, Overloaded
from parallel_cnn_tpu_torch.serve.telemetry import WireStats

#: Cap on one request line; a line that exceeds it is a BadRequest, not
#: an unbounded buffer (the memory twin of the read deadline).
MAX_LINE_BYTES = 8 * 1024 * 1024


def encode_request(rid: int, x, deadline_ms: Optional[float] = None,
                   priority: Optional[str] = None) -> bytes:
    """The client-side wire encoding (loadgen's socket transport and the
    tests share it, so the protocol lives in exactly one place)."""
    req: Dict[str, Any] = {"id": rid, "x": np.asarray(x).tolist()}
    if deadline_ms is not None:
        req["deadline_ms"] = deadline_ms
    if priority is not None:
        req["priority"] = priority
    return json.dumps(req).encode() + b"\n"


class _TcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    # Respawn-on-the-same-port is the supervisor contract; without
    # SO_REUSEADDR the TIME_WAIT from the killed endpoint would block
    # the rebind for minutes.
    allow_reuse_address = True
    # listen()'s backlog (socketserver's default is 5, JAX's too). When
    # the accepting thread waits on the interpreter lock, a burst of
    # clients connecting at once overflows 5 and the kernel drops their
    # handshakes: each such client waits out a 1 s SYN retransmit.
    request_queue_size = 128


class NetServer:
    """The endpoint: a threaded TCP listener resolving wire requests
    through a DynamicBatcher.

    ``wire`` (a WireStats) is shared across supervisor respawns so the
    conservation law spans restarts; ``chaos`` arms ``kill-endpoint@``.
    ``port=0`` binds an ephemeral port, reported on ``self.port``.
    """

    def __init__(
        self,
        batcher,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        conn_deadline_ms: float = 2000.0,
        wire: Optional[WireStats] = None,
        chaos=None,
        obs: Optional["obs_lib.Obs"] = None,
        seq_start: int = 0,
    ):
        if conn_deadline_ms <= 0:
            raise ValueError(
                f"conn_deadline_ms must be > 0, got {conn_deadline_ms}"
            )
        self.batcher = batcher
        self.wire = wire if wire is not None else WireStats()
        self.chaos = chaos
        self.obs = obs if obs is not None else obs_lib.NOOP
        self.conn_deadline_s = conn_deadline_ms / 1e3
        self._lock = threading.Lock()
        # Wire-request sequence — the chaos schedule's clock. Starts at
        # ``seq_start`` so a respawned endpoint continues the killed
        # one's numbering instead of replaying its chaos window.
        self._seq = seq_start
        # seq -> claimed flag for wire requests submitted to the batcher
        # whose reply has not been written. kill() claims them (journals
        # net_failed); a handler whose entry was claimed stays silent —
        # exactly one terminal outcome per wire request.
        self._inflight: Dict[int, bool] = {}
        self._conns: set = set()
        self._killed = False
        self._closed = False
        server = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: D102 — protocol loop below
                server._handle_conn(self.request)

        self._tcp = _TcpServer((host, port), _Handler)
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, kwargs={"poll_interval": 0.01},
            name=f"serve-net-{self.port}", daemon=True,
        )

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "NetServer":
        self._thread.start()
        return self

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    @property
    def alive(self) -> bool:
        with self._lock:
            return not (self._killed or self._closed)

    @property
    def killed(self) -> bool:
        with self._lock:
            return self._killed

    def next_seq(self) -> int:
        """Current wire-sequence watermark (a respawn's ``seq_start``)."""
        with self._lock:
            return self._seq

    def kill(self, reason: str = "chaos") -> None:
        """Abrupt endpoint death (the ``kill-endpoint@`` injection
        point): journal every in-flight wire request as ``net_failed``
        — the reconciliation that makes them lost loudly, not silently
        — then drop the listener and every connection."""
        with self._lock:
            if self._killed or self._closed:
                return
            self._killed = True
            inflight = [s for s, claimed in self._inflight.items()
                        if not claimed]
            for s in inflight:
                self._inflight[s] = True
            conns = list(self._conns)
        self.wire.on_failed(len(inflight))
        self.wire.on_endpoint_death()
        if self.obs.enabled:
            for s in inflight:
                self.obs.event("net_failed", seq=s, reason="endpoint died")
            self.obs.event(
                "endpoint_killed", port=self.port, reason=reason,
                inflight_failed=len(inflight),
            )
        self._teardown(conns)

    def close(self) -> None:
        """Graceful stop (test teardown / process exit): no in-flight
        reconciliation drama, just stop serving."""
        with self._lock:
            if self._killed or self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        self._teardown(conns)

    def _teardown(self, conns) -> None:
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def __enter__(self) -> "NetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- wire accounting helpers ----------------------------------------

    def _serving(self) -> bool:
        with self._lock:
            return not (self._killed or self._closed)

    def _next_seq(self) -> int:
        with self._lock:
            s = self._seq
            self._seq += 1
            return s

    def _accept(self) -> int:
        """The next wire sequence number, in flight from this moment: a
        kill() from here on claims it, whatever the handler is doing."""
        with self._lock:
            s = self._seq
            self._seq += 1
            self._inflight[s] = False
            return s

    def _untrack(self, seq: int) -> bool:
        """Remove a wire request from the in-flight set; True when
        kill() already claimed (and accounted) it."""
        with self._lock:
            return self._inflight.pop(seq, False)

    # -- the per-connection protocol loop -------------------------------

    def _handle_conn(self, sock) -> None:
        with self._lock:
            if self._killed or self._closed:
                return
            self._conns.add(sock)
        self.wire.on_conn_open()
        if self.obs.enabled:
            self.obs.event("conn_open", port=self.port)
        try:
            self._conn_loop(sock)
        finally:
            with self._lock:
                self._conns.discard(sock)
            self.wire.on_conn_close()
            try:
                sock.close()
            except OSError:
                pass

    def _read_line(self, sock, buf: bytearray) -> Optional[bytes]:
        """One request line within the read deadline. The budget runs
        from the first byte of THIS request — a drip-feeding client
        cannot reset it per byte. Returns None to close the connection
        (idle timeout, EOF, reap, or shutdown); a reaped partial has
        already been accounted."""
        line_deadline = (
            time.monotonic() + self.conn_deadline_s if buf else None
        )
        while True:
            nl = buf.find(b"\n")
            if nl >= 0:
                line = bytes(buf[:nl])
                del buf[:nl + 1]
                return line
            if len(buf) > MAX_LINE_BYTES:
                self._reap(sock, len(buf), "request line too long")
                return None
            now = time.monotonic()
            if line_deadline is None:
                timeout = self.conn_deadline_s
            else:
                timeout = line_deadline - now
                if timeout <= 0:
                    self._reap(sock, len(buf), "read deadline")
                    return None
            try:
                sock.settimeout(timeout)
                chunk = sock.recv(65536)
            except socket.timeout:
                if buf:
                    self._reap(sock, len(buf), "read deadline")
                return None
            except OSError:
                if buf and self._serving():
                    self._reap(sock, len(buf), "connection lost mid-body")
                return None
            if not chunk:
                if buf and self._serving():
                    self._reap(sock, len(buf), "EOF mid-body")
                return None
            if not buf:
                line_deadline = time.monotonic() + self.conn_deadline_s
            buf.extend(chunk)

    def _reap(self, sock, n_bytes: int, why: str) -> None:
        """A request that never finished arriving is still a wire
        request: submitted and expired in the same breath, so the
        conservation law sees it instead of a silent drop."""
        seq = self._next_seq()
        self.wire.on_submit()
        self.wire.on_expired(1, reaped=True)
        if self.obs.enabled:
            self.obs.event("net_submit", seq=seq, partial=True)
            self.obs.event("net_expired", seq=seq, reaped=True)
            self.obs.event(
                "conn_expired", seq=seq, buffered=n_bytes, reason=why,
            )

    def _conn_loop(self, sock) -> None:
        buf = bytearray()
        while self._serving():
            line = self._read_line(sock, buf)
            if line is None:
                return
            if not line.strip():
                continue
            if not self._one_request(sock, line):
                return

    def _one_request(self, sock, line: bytes) -> bool:
        """Resolve one complete wire request; False closes the conn.

        The request is in flight from its acceptance on, before it is
        parsed or reaches the batcher (JAX tracks it only once the
        batcher holds it, so a kill in between left it to the handler,
        which could find its answer ready, fail the write and count it
        expired): every outcome below first asks ``_untrack`` whether a
        kill() already claimed it."""
        seq = self._accept()
        self.wire.on_submit()
        if self.obs.enabled:
            self.obs.event("net_submit", seq=seq)
        if self.chaos is not None and self.chaos.kill_endpoint_at(seq):
            # Chaos: the endpoint dies having accepted this request —
            # kill() below claims it (and every other in-flight one) as
            # net_failed; the client sees a dropped connection.
            self.kill(reason=f"chaos kill-endpoint@{seq}")
            return False
        try:
            req = json.loads(line)
            rid = req["id"]
            x = np.asarray(req["x"], dtype=np.float32)
            deadline_ms = req.get("deadline_ms")
            # The deadline → admission-class mapping (module docstring):
            # an explicit budget marks the request latency-bound.
            priority = req.get("priority") or (
                "guaranteed" if deadline_ms is not None else "best-effort"
            )
            budget = (
                float(deadline_ms) if deadline_ms is not None
                else self.conn_deadline_s * 1e3
            )
        except (ValueError, KeyError, TypeError) as e:
            if self._untrack(seq):
                return False
            self.wire.on_failed()
            if self.obs.enabled:
                self.obs.event("net_failed", seq=seq, reason="bad request")
            return self._write(sock, {
                "id": None, "ok": False, "error": "BadRequest",
                "message": str(e),
            })
        try:
            fut = self.batcher.submit(x, deadline_ms=budget,
                                      priority=priority)
        except Overloaded as e:
            if self._untrack(seq):
                return False
            self.wire.on_shed()
            if self.obs.enabled:
                self.obs.event("net_shed", seq=seq)
            return self._write(sock, {
                "id": rid, "ok": False, "error": "Overloaded",
                "message": str(e),
            })
        except (ValueError, RuntimeError) as e:
            if self._untrack(seq):
                return False
            self.wire.on_failed()
            if self.obs.enabled:
                self.obs.event("net_failed", seq=seq, reason=str(e))
            return self._write(sock, {
                "id": rid, "ok": False, "error": "BadRequest",
                "message": str(e),
            })
        outcome, payload = self._await(fut, rid, budget)
        if self._untrack(seq):
            # kill() already journaled this one as net_failed; the
            # connection is gone — stay silent, account nothing twice.
            return False
        wrote = self._write(sock, payload)
        if not wrote and outcome == "complete":
            # The answer existed but the write deadline blew: at the
            # wire tier the client never got it — expired, not served.
            outcome = "expired"
            payload = None
        if outcome == "complete":
            self.wire.on_complete()
        elif outcome == "expired":
            self.wire.on_expired()
        else:
            self.wire.on_failed()
        if self.obs.enabled:
            self.obs.event(f"net_{outcome}", seq=seq)
        return wrote

    def _await(self, fut, rid, budget_ms: float):
        """Wait out one batcher future, polling so an endpoint kill
        unblocks the handler promptly. The wait is bounded: the request
        budget plus headroom for dispatch — a wedged future resolves as
        Failed rather than pinning the thread."""
        deadline = time.monotonic() + budget_ms / 1e3 + 30.0
        while True:
            try:
                y = fut.result(timeout=0.05)
                return "complete", {"id": rid, "ok": True, "y": y.tolist()}
            except TimeoutError:
                if not self._serving() or time.monotonic() > deadline:
                    return "failed", {
                        "id": rid, "ok": False, "error": "Failed",
                        "message": "endpoint shutting down",
                    }
            except DeadlineExceeded as e:
                return "expired", {
                    "id": rid, "ok": False, "error": "DeadlineExceeded",
                    "message": str(e),
                }
            except BaseException as e:  # noqa: BLE001 — typed to client
                return "failed", {
                    "id": rid, "ok": False, "error": "Failed",
                    "message": f"{type(e).__name__}: {e}",
                }

    def _write(self, sock, payload: Optional[Dict[str, Any]]) -> bool:
        if payload is None:
            return False
        try:
            sock.settimeout(self.conn_deadline_s)
            sock.sendall(json.dumps(payload).encode() + b"\n")
            return True
        except (OSError, socket.timeout):
            return False

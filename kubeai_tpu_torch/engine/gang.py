"""Lockstep dispatch fan-out for tensor-parallel serving (port of
kubeai_tpu/engine/gang.py; the wire is byte-identical).

Every rank of a tp gang holds its shard of the weights and of the KV
pool (parallel/sharding.py) and runs the SAME forward calls in the same
order; the collectives inside them (parallel/group.py: an all-reduce
after the row-parallel products, an all-gather of the vocab-sharded
logits) line up because each rank issues them in that order. Rank 0
owns the scheduler (queues, paging, admission: host state); before
every device dispatch it publishes the op's name and its host arguments
to the followers, which replay the call on their own shards. Payloads
are a few KB (token ids, block tables, per-slot sampling rows).

Wire format (one TCP stream per follower, order = dispatch order):
    4-byte big-endian header length | header JSON | raw array bytes
    header = {"op": str, "scalars": {...},
              "arrays": [[name, dtype, shape], ...]}
Arrays ride as raw C-order bytes in header order. No pickle.

Every connection passes an HMAC challenge-response on the shared secret
(``KUBEAI_GANG_SECRET``) with nonces from both sides before it counts as
a member. A broken follower connection fails the work in flight; the
publisher drops the rank (at publish, or through the EOF monitor), keeps
accepting, and when the follower reconnects (with backoff) the gang
re-forms: rank 0 broadcasts "reset" and every rank rebuilds its device
state. Only a gang that does not re-form in time ends the rank.
"""

from __future__ import annotations

import hmac
import hashlib
import json
import os
import select
import socket
import struct
import threading
import time

import numpy as np

from kubeai_tpu_torch.obs.logs import get_logger

log = get_logger("kubeai_tpu_torch.engine.gang")

DEFAULT_GANG_PORT = 8477

# Handshake domain-separation tags (follower proof vs publisher proof —
# without distinct tags a MITM could reflect one side's MAC back at it).
_TAG_FOLLOWER = b"kubeai-gang-v1:follower"
_TAG_PUBLISHER = b"kubeai-gang-v1:publisher"
_CHALLENGE_LEN = 16
_MAC_LEN = 32  # HMAC-SHA256


def _mac(secret: bytes, tag: bytes, challenge: bytes, rank: int) -> bytes:
    return hmac.new(
        secret, tag + challenge + struct.pack(">I", rank), hashlib.sha256
    ).digest()


class GangAuthError(ConnectionError):
    """A peer failed the shared-secret handshake."""


class GangLostRanks(ConnectionError):
    """publish() found follower rank(s) dead or the gang incomplete.
    A ConnectionError so the engine's _bcast wraps it into GangLost
    exactly like any other dead-peer failure."""


def _encode(op: str, scalars: dict | None, arrays: dict[str, np.ndarray] | None) -> bytes:
    names, meta, blobs = [], [], []
    for name, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        names.append(name)
        meta.append([name, a.dtype.str, list(a.shape)])
        blobs.append(a.tobytes())
    header = json.dumps(
        {"op": op, "scalars": scalars or {}, "arrays": meta}
    ).encode()
    return b"".join([struct.pack(">I", len(header)), header] + blobs)


def _read_exact_sock(sock: socket.socket, n: int, deadline: float | None = None) -> bytes:
    """Read exactly n bytes from a raw socket. With *deadline* (monotonic
    time), the TOTAL read is bounded — a per-recv timeout alone lets a
    peer drip-feed one byte per interval and stall forever."""
    buf = b""
    while len(buf) < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("handshake deadline exceeded")
            sock.settimeout(remaining)
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gang stream closed during handshake")
        buf += chunk
    return buf


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise ConnectionError("gang stream closed")
        buf += chunk
    return buf


def _decode(f) -> tuple[str, dict, dict[str, np.ndarray]]:
    (hlen,) = struct.unpack(">I", _read_exact(f, 4))
    header = json.loads(_read_exact(f, hlen))
    arrays: dict[str, np.ndarray] = {}
    for name, dtype, shape in header["arrays"]:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        arrays[name] = np.frombuffer(_read_exact(f, n), dt).reshape(shape).copy()
    return header["op"], header["scalars"], arrays


class GangPublisher:
    """Rank 0's side: authenticate one connection per follower rank, then
    fan every dispatch out in order. publish() is called from the engine
    scheduler thread (and, rarely, adapter RPC threads) — serialized by a
    lock.

    Every connection must pass a shared-secret challenge-response before
    it counts as a gang member: the dispatch stream carries all prompt
    token ids, sampling params and adapter paths, and an unauthenticated
    accept would both leak that stream to any reachable peer AND let it
    displace a real follower so the gang never assembles. The secret is
    provisioned by the controller per slice gang (KUBEAI_GANG_SECRET).

    Mutual freshness: the publisher picks the challenge AND the follower
    contributes its own nonce, and both are bound into both MACs — with
    only a publisher challenge, an on-path attacker who captured one
    prior handshake could replay the (challenge, publisher-proof) pair
    to impersonate rank 0 (advisor r4). The stream itself is plaintext
    TCP: confidentiality relies on slice-local network policy, the
    handshake only authenticates the endpoints."""

    _HANDSHAKE_BUDGET = 10.0  # total seconds per connection attempt

    def __init__(self, n_followers: int, port: int = DEFAULT_GANG_PORT, host: str = "0.0.0.0", *, secret: str | bytes):
        if not secret:
            raise ValueError("gang secret must be non-empty (set KUBEAI_GANG_SECRET)")
        self.n_followers = n_followers
        self._secret = secret.encode() if isinstance(secret, str) else secret
        self._lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._ranks: dict[int, socket.socket] = {}
        # Ranks whose counter-proof send SUCCEEDED. Assembly counts this
        # set, not _ranks: a registered rank whose proof send fails is
        # rolled back, and counting it would let a concurrent
        # registration declare the gang assembled with a member that is
        # about to vanish — permanently locking that rank's reconnect
        # out behind the assembled check (advisor r5).
        self._proven: set[int] = set()
        self._assembled = threading.Event()
        self._closed = False
        # Set whenever a rank is dropped: even if the rank silently
        # rejoins between publishes (rank 0 never saw a send fail), ops
        # published into the dead socket were LOST — the gang's device
        # state may have diverged, so every op except "reset" is
        # refused until a reset broadcast resynchronizes the ranks.
        self._needs_reset = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(max(n_followers, 4))
        self.port = self._srv.getsockname()[1]
        if n_followers == 0:
            self._assembled.set()
        # Handshakes run on a background acceptor from construction, NOT
        # inside accept_all: rank 0 builds its engine (minutes for a real
        # checkpoint, and possibly containing global-mesh programs that
        # need every rank participating) BEFORE it calls accept_all, and
        # followers block in their own handshake until the challenge
        # arrives — challenging only from accept_all would stall every
        # follower behind rank 0's build (or deadlock the slice).
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="gang-accept", daemon=True
        )
        self._acceptor.start()
        # Dead-follower detection on IDLE gangs: the dispatch stream is
        # one-way, so a follower that dies between publishes would only
        # be discovered at the next sendall — and its restarted pod's
        # reconnect would be rejected as a duplicate rank until then.
        # The monitor watches registered connections for EOF (followers
        # never send after the handshake) and drops dead ranks promptly.
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="gang-monitor", daemon=True
        )
        self._monitor.start()

    def _handshake(self, conn: socket.socket, addr) -> tuple[int, bytes]:
        """Challenge-response on a fresh connection; returns the proven
        follower rank and the session transcript (challenge + follower
        nonce) the counter-proof must cover. Raises GangAuthError on any
        mismatch. The WHOLE exchange shares one deadline — per-recv
        timeouts would let a peer drip-feed bytes and stall gang
        assembly indefinitely. The counter-proof is NOT sent here: it
        goes out only after registration succeeds under the lock
        (_handshake_and_register), so a follower that loses the
        duplicate-rank race sees EOF during its handshake instead of a
        false success followed by a late GangLost (advisor r4)."""
        deadline = time.monotonic() + self._HANDSHAKE_BUDGET
        challenge = os.urandom(_CHALLENGE_LEN)
        conn.sendall(challenge)
        try:
            buf = _read_exact_sock(conn, 4 + _CHALLENGE_LEN + _MAC_LEN, deadline=deadline)
        except (ConnectionError, socket.timeout) as e:
            raise GangAuthError(f"{addr}: {e}") from e
        (rank,) = struct.unpack(">I", buf[:4])
        nonce = buf[4 : 4 + _CHALLENGE_LEN]
        transcript = challenge + nonce
        want = _mac(self._secret, _TAG_FOLLOWER, transcript, rank)
        if not hmac.compare_digest(buf[4 + _CHALLENGE_LEN :], want):
            raise GangAuthError(f"{addr}: bad handshake MAC")
        if not (1 <= rank <= self.n_followers):
            raise GangAuthError(f"{addr}: rank {rank} out of range")
        if rank in self._ranks:
            raise GangAuthError(f"{addr}: duplicate rank {rank}")
        return rank, transcript

    def _accept_loop(self) -> None:
        """Accept for the publisher's whole lifetime (reconnecting
        followers re-form a degraded gang — the acceptor must outlive
        the initial assembly). Each handshake runs on its own bounded
        thread — done serially, one slow/malicious peer reconnecting in
        a loop would hold the acceptor for _HANDSHAKE_BUDGET per attempt
        and starve the real followers out of the assembly window."""
        while not self._closed:
            try:
                self._srv.settimeout(None)
                conn, addr = self._srv.accept()
            except OSError:
                return  # close() shut the server socket
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._handshake_and_register,
                args=(conn, addr),
                name="gang-handshake",
                daemon=True,
            ).start()

    def _handshake_and_register(self, conn: socket.socket, addr) -> None:
        try:
            rank, transcript = self._handshake(conn, addr)
            conn.settimeout(None)
        except (GangAuthError, OSError) as e:
            log.warning("rejecting gang connection from %s: %s", addr, e)
            try:
                conn.close()
            except OSError:
                pass
            return
        # Membership under the publish lock: concurrent handshakes for
        # the same rank must not both register, and publish() must not
        # iterate _conns mid-append. A rank currently absent (never
        # joined, or dropped after its connection died) may register
        # even after a prior assembly — that is the re-form path.
        with self._lock:
            if rank in self._ranks:
                log.warning(
                    "rejecting gang connection from %s: duplicate rank %d", addr, rank
                )
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._ranks[rank] = conn
            self._conns.append(conn)
            n = len(self._ranks)
        # Registration won the race — NOW prove the publisher knows the
        # secret (mutual: a follower must not replay its dispatch stream
        # for an impostor rank 0). A rejected racer above saw EOF instead.
        try:
            self._send_counter_proof(conn, transcript, rank)
        except OSError as e:
            log.warning("gang follower rank %d from %s died mid-handshake: %s",
                        rank, addr, e)
            with self._lock:  # roll back so the rank can reconnect
                if self._ranks.get(rank) is conn:
                    del self._ranks[rank]
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass
            return
        log.info(
            "gang follower rank %d (%d/%d) authenticated from %s",
            rank, n, self.n_followers, addr,
        )
        # Assembly counts only PROVEN ranks (see _proven): this rank's
        # proof send just succeeded, so it is live from the follower's
        # point of view too — a registered-but-unproven member that gets
        # rolled back must never have been counted toward assembly.
        with self._lock:
            if self._ranks.get(rank) is conn:
                self._proven.add(rank)
                if len(self._proven) >= self.n_followers:
                    self._assembled.set()

    def _send_counter_proof(self, conn: socket.socket, transcript: bytes, rank: int) -> None:
        """Seam for the proof send (tests stub it to fail: TCP buffering
        makes a real send-to-dead-peer nondeterministic)."""
        conn.sendall(_mac(self._secret, _TAG_PUBLISHER, transcript, rank))

    def accept_all(self, timeout: float = 300.0) -> None:
        """Block until every follower rank has connected AND passed the
        handshake (gang assembly)."""
        if not self._assembled.wait(timeout):
            raise TimeoutError(
                f"gang assembly timed out: {len(self._ranks)}/"
                f"{self.n_followers} followers authenticated within {timeout}s"
            )

    # -- supervision -------------------------------------------------------

    def _drop_rank_locked(self, rank: int, reason: str) -> None:
        """Remove *rank* from the gang (lock held): its connection is
        closed, assembly flips incomplete, and a reconnect for the rank
        becomes acceptable again."""
        conn = self._ranks.pop(rank, None)
        if conn is None:
            return
        if conn in self._conns:
            self._conns.remove(conn)
        self._proven.discard(rank)
        self._needs_reset = True
        if len(self._proven) < self.n_followers:
            self._assembled.clear()
        try:
            conn.close()
        except OSError:
            pass
        log.warning("gang follower rank %d dropped: %s", rank, reason)

    def _monitor_loop(self) -> None:
        """Watch registered follower connections for EOF. The dispatch
        stream is publisher->follower only, so the only thing a
        registered socket can ever become readable with is its death
        (EOF/RST) — recv() it and drop the rank so an idle gang notices
        follower loss without waiting for the next publish."""
        while not self._closed:
            with self._lock:
                conns = {conn: rank for rank, conn in self._ranks.items()}
            if not conns:
                time.sleep(0.05)
                continue
            try:
                readable, _, _ = select.select(list(conns), [], [], 0.2)
            except (OSError, ValueError):
                continue  # a conn closed mid-select; next pass re-snapshots
            for conn in readable:
                dead = False
                try:
                    # MSG_DONTWAIT, not setblocking(): flipping the
                    # socket's blocking mode here would race a publish()
                    # mid-sendall on the same socket.
                    data = conn.recv(1, socket.MSG_DONTWAIT)
                    dead = data == b""
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    dead = True
                if dead:
                    with self._lock:
                        rank = conns.get(conn)
                        if rank is not None and self._ranks.get(rank) is conn:
                            self._drop_rank_locked(rank, "connection EOF")

    def missing_ranks(self) -> set[int]:
        with self._lock:
            return set(range(1, self.n_followers + 1)) - set(self._ranks)

    def is_complete(self) -> bool:
        """Every follower rank connected and proven."""
        return self._assembled.is_set()

    def wait_complete(self, timeout: float) -> bool:
        """Block up to *timeout* for the gang to (re-)complete."""
        return self._assembled.wait(timeout)

    def publish(self, op: str, scalars: dict | None = None, arrays: dict[str, np.ndarray] | None = None) -> None:
        # Failpoint: chaos tests sever/stall the gang dispatch stream
        # here; a FaultError is a ConnectionError, so it exercises the
        # real GangLost recovery path in the engine.
        from kubeai_tpu_torch.faults import fault

        fault("gang.publish")
        payload = _encode(op, scalars, arrays)
        with self._lock:
            if self.n_followers and len(self._proven) < self.n_followers:
                missing = set(range(1, self.n_followers + 1)) - set(self._ranks)
                raise GangLostRanks(
                    f"gang incomplete: missing rank(s) {sorted(missing)}"
                )
            if self._needs_reset:
                if op != "reset":
                    # A rank dropped (and possibly silently rejoined):
                    # ops it missed are unrecoverable — only a reset
                    # rebroadcast may pass, resynchronizing every rank.
                    raise GangLostRanks(
                        "gang member was lost since the last reset; "
                        "reset required before dispatch"
                    )
                self._needs_reset = False
            dead: list[int] = []
            for rank, conn in list(self._ranks.items()):
                try:
                    conn.sendall(payload)
                except OSError as e:
                    log.warning(
                        "gang follower rank %d send failed: %s", rank, e
                    )
                    dead.append(rank)
            for rank in dead:
                self._drop_rank_locked(rank, "publish send failed")
            if dead:
                raise GangLostRanks(
                    f"gang follower rank(s) {sorted(dead)} lost during publish"
                )

    def close(self) -> None:
        self._closed = True
        # Best-effort "stop": if the scheduler thread is wedged inside
        # publish() (follower stopped reading, TCP window full) it holds
        # _lock — blocking here would deadlock shutdown. Skip the
        # farewell; closing the sockets below unblocks the wedged sendall
        # and the followers see EOF.
        if self._lock.acquire(timeout=2.0):
            try:
                payload = _encode("stop", None, None)
                for conn in self._conns:
                    try:
                        conn.sendall(payload)
                    except OSError:
                        pass
            finally:
                self._lock.release()
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._srv.close()


class GangFollower:
    """Rank >0's side: connect to rank 0, prove the shared secret and this
    process's rank, verify rank 0's counter-proof, then yield ops in
    order."""

    def __init__(self, host: str, port: int = DEFAULT_GANG_PORT, timeout: float = 300.0, *, secret: str | bytes, rank: int):
        if not secret:
            raise ValueError("gang secret must be non-empty (set KUBEAI_GANG_SECRET)")
        if rank < 1:
            raise ValueError(f"follower rank must be >= 1, got {rank}")
        self._host = host
        self._port = port
        self._rank = rank
        self._secret = secret.encode() if isinstance(secret, str) else secret
        self._establish(timeout, base=0.5, cap=0.5)

    def reconnect(self, timeout: float = 60.0) -> None:
        """Re-join after the dispatch stream dropped (rank 0 restarted,
        or a network blip): exponential backoff between attempts —
        rank 0 rejects our rank as a duplicate until it has noticed the
        old connection's death, so immediate hammering just burns its
        acceptor. Raises TimeoutError when the publisher never comes
        back inside *timeout* (the pod then exits for the controller)."""
        self.close()
        self._establish(timeout, base=0.5, cap=5.0)

    def _establish(self, timeout: float, base: float, cap: float) -> None:
        sec = self._secret
        host, port, rank = self._host, self._port, self._rank
        deadline = time.monotonic() + timeout
        last_err: Exception | None = None
        delay = base
        while True:
            try:
                self._sock = socket.create_connection((host, port), timeout=10)
                self._sock.settimeout(10)
                challenge = _read_exact_sock(self._sock, _CHALLENGE_LEN)
                # Contribute our own nonce so the publisher's counter-
                # proof is fresh per-connection (replay of a captured
                # (challenge, proof) pair can't impersonate rank 0).
                nonce = os.urandom(_CHALLENGE_LEN)
                transcript = challenge + nonce
                self._sock.sendall(
                    struct.pack(">I", rank)
                    + nonce
                    + _mac(sec, _TAG_FOLLOWER, transcript, rank)
                )
                proof = _read_exact_sock(self._sock, _MAC_LEN)
                if not hmac.compare_digest(
                    proof, _mac(sec, _TAG_PUBLISHER, transcript, rank)
                ):
                    raise GangAuthError(
                        f"publisher {host}:{port} failed counter-proof "
                        "(wrong secret or impostor)"
                    )
                break
            except GangAuthError:
                # A live publisher with the wrong secret will never
                # change its mind mid-assembly — fail fast, don't retry.
                try:
                    self._sock.close()
                except OSError:
                    pass
                raise
            except OSError as e:  # rank 0 not listening yet, or it
                # rejected us (duplicate rank during a reconnect race):
                # retry until the deadline.
                last_err = e
                sock = getattr(self, "_sock", None)
                if sock is not None:  # don't leak the failed attempt
                    try:
                        sock.close()
                    except OSError:
                        pass
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not reach gang publisher {host}:{port}: {last_err}"
                    ) from last_err
                time.sleep(delay)
                delay = min(delay * 2, cap)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Blocking reads: the dispatch stream is idle whenever rank 0 has
        # no requests (the connect timeout must not apply to recv).
        self._sock.settimeout(None)
        self._file = self._sock.makefile("rb")
        log.info("connected to gang publisher %s:%d as rank %d", host, port, rank)

    def recv(self) -> tuple[str, dict, dict[str, np.ndarray]]:
        # Failpoint "follower-drop": chaos tests sever the stream from
        # the follower's side (FaultError is a ConnectionError, so it
        # takes the real reconnect-with-backoff path in run_follower).
        from kubeai_tpu_torch.faults import fault

        fault("gang.follower")
        return _decode(self._file)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

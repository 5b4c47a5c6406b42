"""Multi-host serving at the wire: one gRPC front, N processes scoring.

Counterpart of ``igaming_platform_tpu/serve/multihost.py``. The FRONT
process runs the full risk server (batcher, feature store, health,
metrics, every RPC) while each of its row steps is scored by every
process of a gloo rendezvous (``parallel/distributed.py``); FOLLOWER
processes mirror every step.

Data plane: only the front holds the request, so a WORK CHANNEL
(length-prefixed frames over TCP, the JAX package's protocol) forwards each
padded batch to the followers. Every process then scores its own rows
(``process_batch_slice``: process i the i-th contiguous block) on its own
device, copies its packed [5, b] block to the host and joins ONE gloo
``all_gather``; the front answers the RPC from the gathered [5, B]. That
all-gather is the step's only collective: a hidden barrier or size check
would interleave differently on front and follower and hang the mesh.

Failure discipline, as in the JAX package: followers ACK every step with
one byte; the front refuses to run more than ``ack_window`` steps ahead;
a dead (EOF) or wedged (timeout) follower fails the next broadcast with a
``MultihostChannelError`` instead of a hang. With ``reconnect`` (default,
``MULTIHOST_RECONNECT``) the front then serves SINGLE-HOST DEGRADED: every
step runs its local step on the whole batch (same params, same program,
same answers) while a supervised loop redials the follower, replays the
model-fingerprint handshake and the current params. A gloo group whose
member died cannot be used again, so each incarnation gets a new group: the
front sends a GROUP frame with the next epoch to every follower, in order
with the work frames, and all form ``multihost/<epoch>`` on the
coordinator's store before the next global step. A failed all-gather marks
the followers dead (the group cannot tell which member left), and that
batch is scored locally. The ``multihost`` breaker of a supervisor follows
the transitions, and each rejoin counts ``follower_resurrections_total``.

``mesh=None`` is LOOPBACK mode: the full channel discipline over a
local-only step. The front's engine refuses the index path
(``_cache_supported``): its table cannot ride the work channel.
``stub_follower_serve`` speaks the protocol without scoring (the chaos
harness's follower).

Only this module and ``parallel/distributed.py`` use ``torch.distributed``.
"""

from __future__ import annotations

import hashlib
import logging
import os as _os
import random as _random
import socket
import struct
import threading
from time import monotonic as _monotonic, sleep as _sleep

import numpy as np
import torch

MAGIC_WORK = b"W"
MAGIC_PARAMS = b"P"
MAGIC_HELLO = b"H"
MAGIC_NACK = b"N"
MAGIC_STOP = b"S"
MAGIC_GROUP = b"G"
# Post-handshake, the only follower->front traffic is one raw ACK byte per
# completed work step (not a frame): the front counts them to bound how far
# ahead of a wedged follower it can run, and a missing/late ACK (or EOF from
# a dead follower) turns the next broadcast into a loud MultihostChannelError.
ACK_BYTE = b"A"

logger = logging.getLogger(__name__)


class MultihostChannelError(RuntimeError):
    """The work channel to a follower is dead or unresponsive: the front
    must fail the RPC loudly, or serve degraded, rather than enter a
    collective the dead follower can never join."""


# -- work channel -----------------------------------------------------------


def _send_frame(sock: socket.socket, magic: bytes, *arrays: np.ndarray) -> None:
    parts = []
    for a in arrays:
        b = np.ascontiguousarray(a).tobytes()
        header = f"{a.dtype.str}|{','.join(map(str, a.shape))}".encode()
        parts.append(struct.pack(">I", len(header)) + header
                     + struct.pack(">I", len(b)) + b)
    payload = b"".join(parts)
    sock.sendall(magic + struct.pack(">II", len(arrays), len(payload)) + payload)


class _Reader:
    """Buffered exact-read over a socket (recv returns arbitrary chunk
    sizes; framing must keep the remainder)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("work channel closed")
            self._buf += chunk  # analysis: single-writer — per-connection read cursor; each _Reader lives on one worker thread
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def _recv_frame(reader: "_Reader"):
    head = reader.exact(9)
    magic = head[:1]
    n_arrays, total = struct.unpack(">II", head[1:])
    payload = reader.exact(total)
    arrays = []
    pos = 0
    for _ in range(n_arrays):
        (hlen,) = struct.unpack_from(">I", payload, pos)
        pos += 4
        dtype_s, shape_s = payload[pos:pos + hlen].decode().rsplit("|", 1)  # dtype.str itself may contain "|" (e.g. bool "|b1")
        pos += hlen
        (blen,) = struct.unpack_from(">I", payload, pos)
        pos += 4
        shape = tuple(int(d) for d in shape_s.split(",") if d)
        arrays.append(np.frombuffer(
            payload[pos:pos + blen], dtype=np.dtype(dtype_s)).reshape(shape))
        pos += blen
    return magic, arrays


def _dial_follower(port: int, dial_timeout_s: float,
                   io_timeout_s: float) -> socket.socket:
    deadline = _monotonic() + dial_timeout_s
    while True:
        # The follower may still be building its mesh/params when the
        # front dials — retry refused connections until the deadline
        # instead of dying on boot-order jitter.
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            break
        except OSError:
            if _monotonic() > deadline:
                raise
            # Jittered dial retry (CC05): K fronts booting against one
            # follower host must not re-dial in lockstep.
            _sleep(_random.uniform(0.1, 0.3))
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.settimeout(io_timeout_s)
    return s


class _FollowerLink:
    """One follower's socket + ACK accounting. Every socket operation —
    including the non-blocking/blocking mode transitions in the ACK reap
    — happens under the link's own lock, so a resurrection thread
    swapping the socket in can never race a broadcast caller mid-
    transition (the `_reap_acks` mode-restore race)."""

    __slots__ = ("index", "port", "sock", "reader", "outstanding", "lock",
                 "dead", "resurrecting")

    def __init__(self, index: int, port: int, sock: socket.socket):
        self.index = index
        self.port = port
        self.sock = sock
        self.reader = _Reader(sock)
        self.outstanding = 0
        self.lock = threading.Lock()
        self.dead: str | None = None
        self.resurrecting = False


class WorkChannel:
    """Front side: fan each padded batch out to the follower(s).

    Failure discipline: every socket op carries
    ``io_timeout_s`` (MULTIHOST_IO_TIMEOUT_S, default 20), the follower
    ACKs each completed work step with one byte, and the front refuses to
    run more than ``ack_window`` un-ACKed steps ahead. A follower that
    dies (EOF on the ACK drain) or wedges (ACK/send timeout) is detected
    BEFORE the front enters the next lockstep collective, so the serving
    front degrades to loud per-RPC errors instead of wedging on a dead
    collective.

    Resurrection (``reconnect=True``): a dead link no longer poisons the
    channel forever — a supervised reconnect loop redials the follower
    with exponential backoff + jitter, replays the hello/fingerprint
    handshake, re-syncs params through ``set_params_provider``'s leaves
    (the ``broadcast_params`` path), and only then marks the link alive.
    While a link is down, ``broadcast`` keeps raising the typed error so
    the engine serves in single-host degraded mode; ``on_follower_state``
    tells the supervisor when to open/close the multihost breaker.
    Without ``reconnect`` the old discipline holds: once dead, every
    later call fails fast until the mesh is rebuilt."""

    def __init__(self, ports: list[int], dial_timeout_s: float = 60.0,
                 io_timeout_s: float | None = None, ack_window: int = 8,
                 reconnect: bool = False,
                 reconnect_backoff_s: tuple[float, float] = (0.2, 5.0)):
        if io_timeout_s is None:
            io_timeout_s = float(_os.environ.get("MULTIHOST_IO_TIMEOUT_S", "20"))
        self._io_timeout_s = io_timeout_s
        self._ack_window = max(1, ack_window)
        self._dial_timeout_s = dial_timeout_s
        self._reconnect = reconnect
        self._backoff = reconnect_backoff_s
        self._closed = threading.Event()
        self._fingerprint: np.ndarray | None = None
        self._params_provider = None  # () -> list[np.ndarray] | None
        self.on_follower_state = None  # callable(index, "dead"|"alive", why)
        self.resurrections = 0
        # Set when a follower rejoins: the next step re-forms the process
        # group (broadcast_group) before it broadcasts work again.
        self.regroup_pending = False
        self._links = [
            _FollowerLink(i, port, _dial_follower(port, dial_timeout_s,
                                                  io_timeout_s))
            for i, port in enumerate(ports)
        ]
        self._lock = threading.Lock()

    # -- state ----------------------------------------------------------------

    @property
    def alive(self) -> bool:
        """Every link up and no process group owed: a resurrected follower
        only counts once ``broadcast_group`` has re-formed the group."""
        return not self.regroup_pending and all(link.dead is None for link in self._links)

    def dead_reason(self) -> str | None:
        for link in self._links:
            if link.dead is not None:
                return link.dead
        return None

    def set_params_provider(self, provider) -> None:
        """``provider() -> list[np.ndarray]`` returning the CURRENT host
        param leaves — replayed to a resurrected follower before it
        rejoins, so a param hot-swap during its outage is never lost."""
        self._params_provider = provider

    def _notify(self, link: _FollowerLink, state: str, why: str = "") -> None:
        cb = self.on_follower_state
        if cb is None:
            return
        try:
            cb(link.index, state, why)
        except Exception:  # noqa: BLE001 — supervisor hooks must not fail the channel
            pass

    def _mark_dead(self, link: _FollowerLink, why: str) -> MultihostChannelError:
        link.dead = f"multihost follower {link.index}: {why}"
        self._notify(link, "dead", why)
        if self._reconnect:
            self._start_resurrection(link)
            return MultihostChannelError(
                f"{link.dead} — front serves single-host degraded mode "
                "while the follower is resurrected")
        return MultihostChannelError(
            f"{link.dead} — front degrades loudly; scoring RPCs fail "
            "until the mesh is rebuilt")

    def _ensure_alive(self) -> None:
        for link in self._links:
            if link.dead is not None:
                raise MultihostChannelError(link.dead)

    # -- resurrection ----------------------------------------------------------

    def _start_resurrection(self, link: _FollowerLink) -> None:
        # Caller (every _mark_dead site) already holds link.lock.
        if link.resurrecting or self._closed.is_set():
            return
        link.resurrecting = True
        try:
            link.sock.close()
        except OSError:  # noqa: CC04 — socket already dead; nothing to record
            pass
        threading.Thread(
            target=self._resurrect_loop, args=(link,),
            name=f"follower-resurrect-{link.index}", daemon=True).start()

    def _resurrect_loop(self, link: _FollowerLink) -> None:
        base, cap = self._backoff
        rng = __import__("random").Random(f"resurrect-{link.index}")
        attempt = 0
        while not self._closed.is_set():
            # Exponential backoff with full jitter: the restarted
            # follower needs boot time, and N fronts re-dialing a shared
            # host must not synchronize their retries.
            delay = min(cap, base * (2 ** min(attempt, 10))) * (
                0.5 + rng.random() / 2)
            if self._closed.wait(delay):
                return
            attempt += 1
            try:
                sock = socket.create_connection(
                    ("127.0.0.1", link.port), timeout=2)
            except OSError:  # noqa: CC04 — resurrection dial retry; backoff loop is the handling
                continue  # follower not back yet; next backoff step
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(self._io_timeout_s)
                reader = _Reader(sock)
                # Replay the boot handshake: the resurrected follower must
                # prove the SAME model fingerprint before any work frame.
                if self._fingerprint is not None:
                    _send_frame(sock, MAGIC_HELLO, self._fingerprint)
                    magic, arrays = _recv_frame(reader)
                    if magic == MAGIC_NACK:
                        msg = (bytes(np.asarray(arrays[0])).decode(errors="replace")
                               if arrays else "handshake NACK")
                        # A model mismatch will not heal by retrying —
                        # stop resurrecting and stay loudly degraded.
                        link.dead = (f"multihost follower {link.index}: "
                                     f"resurrection NACK: {msg}")
                        self._notify(link, "dead", link.dead)
                        with link.lock:
                            link.resurrecting = False
                        sock.close()
                        return
                    if magic != MAGIC_HELLO:
                        raise ConnectionError(f"bad handshake reply {magic!r}")
                # Param re-sync: the follower rejoins with the CURRENT
                # params (hot-swaps during its outage included).
                provider = self._params_provider
                if provider is not None:
                    leaves = provider()
                    if leaves:
                        _send_frame(sock, MAGIC_PARAMS, *leaves)
            except (OSError, ConnectionError):  # noqa: CC04 — resurrection handshake retry; backoff loop is the handling
                try:
                    sock.close()
                except OSError:  # noqa: CC04 — already failing; retry covers it
                    pass
                continue
            with link.lock:
                link.sock = sock
                link.reader = reader
                link.outstanding = 0
                self.regroup_pending = True
                link.dead = None
                link.resurrecting = False
            self.resurrections += 1
            self._notify(link, "alive", f"resurrected after {attempt} attempts")
            return

    # -- ACK reaping -----------------------------------------------------------

    def _reap_acks(self, link: _FollowerLink, need_room: bool) -> None:
        """Drain ACK bytes from a follower; non-blocking normally,
        blocking (with the io timeout) when the un-ACKed window is full.
        EOF here is the earliest dead-follower signal — the kernel closes
        the socket the instant the process dies. Caller holds
        ``link.lock`` (socket mode transitions are atomic per-socket)."""
        s = link.sock
        while True:
            blocking = need_room and link.outstanding >= self._ack_window
            try:
                if blocking:
                    data = s.recv(4096)  # io_timeout_s applies
                else:
                    s.setblocking(False)
                    try:
                        data = s.recv(4096)
                    finally:
                        s.settimeout(self._io_timeout_s)
            except BlockingIOError:
                return
            except socket.timeout as exc:
                raise self._mark_dead(
                    link, f"no step ACK within {self._io_timeout_s}s "
                    "(wedged or overloaded)") from exc
            except OSError as exc:
                raise self._mark_dead(link, f"work channel error: {exc}") from exc
            if data == b"":
                raise self._mark_dead(link, "closed the work channel (died?)")
            link.outstanding = max(0, link.outstanding - len(data))
            if not blocking or link.outstanding < self._ack_window:
                return

    def broadcast(self, xp: np.ndarray, blp: np.ndarray, thr: np.ndarray,
                  trace: np.ndarray | None = None) -> None:
        """Fan one work step out to every follower. ``trace`` is an
        optional uint8-encoded W3C traceparent header: when present it
        rides the frame as a 4th array, so the follower's device-step span
        joins the SAME trace as the front's rpc.* span (and, transitively,
        the client's). Followers accept 3- and 4-array frames alike."""
        from igaming_platform_tpu_torch.serve import chaos

        arrays = (xp, blp, thr) if trace is None else (xp, blp, thr, trace)
        with self._lock:
            self._ensure_alive()
            for link in self._links:
                with link.lock:
                    if link.dead is not None:
                        raise MultihostChannelError(link.dead)
                    self._reap_acks(link, need_room=True)
                    try:
                        if chaos.fire("workchannel.send") == "drop":
                            # Injected frame loss: the follower never sees
                            # this step, so its missing ACK must surface
                            # through the window discipline, not hide.
                            link.outstanding += 1
                            continue
                        _send_frame(link.sock, MAGIC_WORK, *arrays)
                    except socket.timeout as exc:
                        raise self._mark_dead(
                            link, f"send timed out after {self._io_timeout_s}s",
                        ) from exc
                    except OSError as exc:
                        raise self._mark_dead(link, f"send failed: {exc}") from exc
                    link.outstanding += 1

    def broadcast_params(self, leaves: list[np.ndarray]) -> None:
        with self._lock:
            self._ensure_alive()
            for link in self._links:
                with link.lock:
                    try:
                        _send_frame(link.sock, MAGIC_PARAMS, *leaves)
                    except OSError as exc:  # includes socket.timeout
                        raise self._mark_dead(
                            link, f"params send failed: {exc}") from exc

    def broadcast_group(self, epoch: int) -> None:
        """Tell every follower to form process group ``epoch`` (the frame
        rides in order with the work frames, so each follower switches
        between the same two steps as the front); clears
        ``regroup_pending``. The caller then forms the group itself."""
        with self._lock:
            for link in self._links:
                with link.lock:
                    if link.dead is not None:
                        raise MultihostChannelError(link.dead)
                    try:
                        _send_frame(link.sock, MAGIC_GROUP, np.asarray([epoch], np.int64))
                    except OSError as exc:
                        raise self._mark_dead(link, f"group send failed: {exc}") from exc
            self.regroup_pending = False

    def mark_dead(self, why: str) -> MultihostChannelError:
        """Declare the channel's followers dead (a failed collective: the
        group cannot tell which member left); resurrection, when on, redials
        each. Returns the error to raise."""
        err = None
        with self._lock:
            for link in self._links:
                with link.lock:
                    if link.dead is None:
                        err = self._mark_dead(link, why)
        return err or MultihostChannelError(self.dead_reason() or why)

    def broadcast_hello(self, fingerprint: np.ndarray) -> None:
        """Handshake is BIDIRECTIONAL: send the fingerprint, then wait
        for every follower's ACK before any work frame — a mismatched
        follower NACKs and dies, and without the read the front's first
        collective would wedge waiting for a dead participant. The
        fingerprint is kept for resurrection handshakes."""
        self._fingerprint = np.asarray(fingerprint, dtype=np.uint8).copy()
        with self._lock:
            for link in self._links:
                with link.lock:
                    _send_frame(link.sock, MAGIC_HELLO, fingerprint)
            for link in self._links:
                with link.lock:
                    try:
                        magic, arrays = _recv_frame(link.reader)
                    except ConnectionError as exc:
                        raise RuntimeError(
                            f"multihost follower {link.index} closed the "
                            "channel during the model handshake (likely a "
                            "model mismatch — check its logs)") from exc
                if magic == MAGIC_NACK:
                    msg = bytes(np.asarray(arrays[0])).decode(errors="replace") \
                        if arrays else "follower rejected the handshake"
                    raise RuntimeError(
                        f"multihost follower {link.index} NACK: {msg}")
                if magic != MAGIC_HELLO:
                    raise RuntimeError(
                        f"multihost follower {link.index}: bad handshake "
                        f"reply {magic!r}")

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            for link in self._links:
                with link.lock:
                    try:
                        _send_frame(link.sock, MAGIC_STOP)
                        link.sock.close()
                    except OSError:  # noqa: CC04 — shutdown path; link may already be dead
                        pass
            self._links = []



# -- params on the wire -------------------------------------------------------


def _param_items(params):
    """(name, tensor) of every param leaf, in a fixed order (sorted keys,
    each module's state_dict order): the order fingerprints and params
    frames share."""
    for key in sorted(params or {}):
        value = params[key]
        if value is None:
            continue
        if isinstance(value, torch.Tensor):
            yield key, value
            continue
        tensors = value.state_dict() if hasattr(value, "state_dict") else value
        for name, t in tensors.items():
            yield f"{key}.{name}", t


def param_leaves(params) -> list[np.ndarray]:
    """Every param leaf as a host array, in ``_param_items`` order."""
    return [t.detach().cpu().numpy() for _, t in _param_items(params)]


def load_param_leaves(params, leaves: list[np.ndarray]):
    """A copy of ``params`` holding ``leaves`` (``param_leaves``' order, the
    same structure): how a follower applies a params frame."""
    from igaming_platform_tpu_torch.convert import params_to

    out = params_to(params, "cpu")
    items = list(_param_items(out))
    if len(items) != len(leaves):
        raise ValueError(f"params frame has {len(leaves)} leaves, the model {len(items)}")
    with torch.no_grad():
        for (_, t), leaf in zip(items, leaves):
            t.copy_(torch.from_numpy(np.array(leaf)))
    return out


def model_fingerprint(ml_backend: str, params) -> np.ndarray:
    """Digest of (backend, every param leaf's dtype, shape and bytes) as a
    uint8 vector. Front and follower score one program in lockstep: a host
    whose checkpoint degraded to another backend or params would answer
    its rows differently. The boot handshake compares this."""
    h = hashlib.sha256(ml_backend.encode())
    for _, t in _param_items(params):
        arr = t.detach().cpu().numpy()
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


# -- the global step ------------------------------------------------------------


def group_tag(epoch: int) -> str:
    return f"multihost/{epoch}"


def local_rows(mesh, batch: int) -> tuple[int, int]:
    """(rows, offset) of this process's block of a padded batch."""
    if batch % mesh.process_count:
        raise ValueError(f"batch {batch} not divisible by {mesh.process_count} processes")
    per = batch // mesh.process_count
    return per, per * mesh.process_index


def gather_step(group, local_packed: torch.Tensor) -> torch.Tensor:
    """The step's one collective: every process's packed [5, b] block (a
    host int32 tensor) all-gathered over gloo, concatenated in process
    order into [5, B]."""
    from igaming_platform_tpu_torch.parallel import distributed

    return torch.cat(distributed.all_gather(group, local_packed), dim=1)


def _score_block(engine, xp: np.ndarray, blp: np.ndarray, thr: np.ndarray, params):
    """One process's share of a global step on ``engine`` (its packed step
    on its own rows, on its stream), back on the host as int32 [5, b]."""
    from igaming_platform_tpu_torch.serve.scorer import (
        _device_dispatch,
        _stack_packed,
        decode_wire,
    )

    mark = _device_dispatch("multihost_step", xp.shape, xp.dtype, engine.device)
    with engine._on_stream(), torch.inference_mode(), mark:
        xd = torch.from_numpy(np.require(xp, requirements=["C", "W"])).to(engine.device)
        bd = torch.from_numpy(np.require(blp, requirements=["C", "W"])).to(engine.device)
        td = torch.from_numpy(np.asarray(thr, np.int32)).to(engine.device)
        host = _stack_packed(engine._score_fn(params, decode_wire(xd), bd, td)).cpu()
    engine._count_step()
    return host


def follower_serve(port: int, cfg, ml_backend: str, params, mesh, *, device: str = "cuda",
                   batcher_config=None) -> None:
    """Follower process main loop: accept the front's channel, check its
    model fingerprint, then mirror every work frame with its share of the
    global step (``mesh``: ``parallel/distributed.global_mesh``). Exits on
    the STOP frame or a closed channel."""
    from igaming_platform_tpu_torch.parallel import distributed
    from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

    dev = mesh.device if mesh is not None else device
    engine = TorchScoringEngine(cfg, ml_backend=ml_backend, params=params, device=dev,
                                batcher_config=batcher_config, warmup=False)
    served = engine.get_params()
    group = None
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", port))
    listener.listen(1)
    conn = None
    try:
        conn, _ = listener.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        reader = _Reader(conn)
        # Boot handshake: the front's model fingerprint must match ours
        # before any lockstep step.
        magic, arrays = _recv_frame(reader)
        if magic != MAGIC_HELLO:
            raise RuntimeError(f"expected HELLO handshake, got {magic!r}")
        mine = model_fingerprint(ml_backend, served)
        if not np.array_equal(np.asarray(arrays[0]), mine):
            msg = ("multihost model mismatch: this follower resolved a different "
                   f"({ml_backend!r}) backend/params than the front — check "
                   "FRAUD_MODEL_PATH/ML_BACKEND on every host")
            _send_frame(conn, MAGIC_NACK, np.frombuffer(msg.encode(), dtype=np.uint8))
            raise RuntimeError(msg)
        _send_frame(conn, MAGIC_HELLO)  # ACK: the front may start
        while True:
            magic, arrays = _recv_frame(reader)
            if magic == MAGIC_PARAMS:
                engine.swap_params(load_param_leaves(served, arrays))
                served = engine.get_params()
                continue
            if magic == MAGIC_GROUP:
                group = distributed.new_group(group_tag(int(arrays[0][0])))
                continue
            if magic != MAGIC_WORK:
                return
            xp, blp, thr = arrays[:3]
            traceparent = None
            if len(arrays) > 3:
                traceparent = bytes(np.asarray(arrays[3], np.uint8)).decode("ascii", "replace")
            from igaming_platform_tpu_torch.obs.tracing import span as _span

            with _span("follower.device_step", traceparent=traceparent,
                       rows=int(np.asarray(xp).shape[0])):
                if group is not None:
                    per, off = local_rows(mesh, xp.shape[0])
                    gather_step(group, _score_block(engine, xp[off:off + per],
                                                    blp[off:off + per], thr, served))
            # Step ACK: one byte per completed work frame.
            conn.sendall(ACK_BYTE)
    except ConnectionError:  # noqa: CC04 — front closed the channel: follower exits
        return
    finally:
        engine.close()
        if conn is not None:
            try:
                conn.close()
            except OSError:  # noqa: CC04 — follower teardown is best-effort
                pass
        listener.close()


def multihost_engine(mesh, follower_ports: list[int], *, batcher_config=None,
                     ml_backend: str = "multitask", params=None, feature_store=None,
                     config=None, reconnect: bool | None = None, supervisor=None,
                     channel_kwargs: dict | None = None, device: str = "cuda",
                     warmup: bool = True):
    """The front's engine: a ``TorchScoringEngine`` whose row steps run over
    the global ``mesh`` (``parallel/distributed.global_mesh``; None =
    loopback) with a work channel to the followers at ``follower_ports``.
    ``params`` must equal every follower's (the handshake checks it).

    ``reconnect`` (default ``MULTIHOST_RECONNECT``, on) serves single-host
    degraded while a follower is down and resurrects it; without it a dead
    follower fails every step loudly. ``supervisor`` gets the ``multihost``
    breaker opened and closed on those transitions."""
    from igaming_platform_tpu_torch.core.config import ScoringConfig
    from igaming_platform_tpu_torch.core.features import NUM_FEATURES
    from igaming_platform_tpu_torch.parallel import distributed
    from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

    cfg = config or ScoringConfig()
    if reconnect is None:
        reconnect = _os.environ.get("MULTIHOST_RECONNECT", "1") != "0"
    loopback = mesh is None
    divisor = 1 if loopback else distributed.global_data_size(mesh)

    class _Engine(TorchScoringEngine):
        def __init__(self):
            self._chan = WorkChannel(follower_ports, reconnect=reconnect,
                                     **(channel_kwargs or {}))
            self.supervisor = supervisor
            self._chan.on_follower_state = self._on_follower_state
            self._degraded_steps = 0
            self._group = None
            self._epoch = -1
            # The broadcast and the front's step are one critical section:
            # otherwise concurrent launchers could pair a follower's frame
            # k with the front's step k+1.
            self._step_lock = threading.Lock()
            super().__init__(config=cfg, batcher_config=batcher_config, ml_backend=ml_backend,
                             params=params, feature_store=feature_store,
                             device=mesh.device if mesh is not None else device,
                             warmup=False)
            self._cache_supported = False
            if self.batch_size % divisor != 0:
                raise ValueError(f"batch {self.batch_size} not divisible by the global mesh "
                                 f"data axis ({divisor})")
            self._shapes = [s for s in self._shapes if s == self.batch_size or s % divisor == 0]
            self._chan.set_params_provider(lambda: param_leaves(self.get_params()))
            self._chan.broadcast_hello(model_fingerprint(ml_backend, self.get_params()))
            with self._step_lock:
                self._regroup()
            if warmup:
                self._warmup_global()

        # -- supervisor wiring ------------------------------------------------

        def _on_follower_state(self, index: int, state: str, why: str) -> None:
            sup = self.supervisor
            if sup is None:
                return
            br = sup.breaker("multihost")
            if state == "dead":
                br.force_open(f"follower {index} dead: {why}")
            else:
                # The resurrection handshake and param re-sync already
                # validated the follower: the breaker closes outright.
                br.reset()
                if sup.metrics is not None:
                    sup.metrics.follower_resurrections_total.inc()

        @property
        def degraded(self) -> bool:
            """True while any follower is down and steps run single-host."""
            return not self._chan.alive

        @property
        def degraded_steps(self) -> int:
            return self._degraded_steps

        @property
        def group_epoch(self) -> int:
            return self._epoch

        # -- lockstep helpers -------------------------------------------------

        def _regroup(self) -> None:
            """Form the next process group with every follower (the caller
            holds the step lock): a GROUP frame, then the rendezvous."""
            if loopback:
                self._chan.regroup_pending = False
                return
            self._epoch += 1
            self._chan.broadcast_group(self._epoch)
            self._group = distributed.new_group(group_tag(self._epoch))

        def _warmup_global(self) -> None:
            """Every ladder shape once through the global step (in lockstep
            with the followers) and once through the local step, the
            single-host degraded step, before the batcher starts."""
            thr = self._thresholds
            for shape in self._shapes:
                xz = np.zeros((shape, NUM_FEATURES), np.float32)
                blz = np.zeros((shape,), bool)
                self._readback(self._launch_padded(xz, blz, shape, self.get_params(), thr=thr))
                self._readback(TorchScoringEngine._launch_padded(
                    self, xz, blz, shape, self.get_params(), thr=thr))

        def _launch_padded(self, xp, blp, n, params, hold=None, thr=None):
            """The row step: broadcast the padded batch, score this process's
            rows, all-gather the packed result (host int32 [5, B]). When a
            follower is down (and resurrection is on) the local step scores
            the whole batch instead."""
            from igaming_platform_tpu_torch.obs.tracing import current_traceparent

            thr_t = self._thresholds if thr is None else thr
            tp = current_traceparent()
            trace = np.frombuffer(tp.encode("ascii"), dtype=np.uint8) if tp else None
            with self._step_lock:
                if self._chan.regroup_pending and all(
                        link.dead is None for link in self._chan._links):
                    try:
                        self._regroup()
                    except (MultihostChannelError, RuntimeError) as exc:
                        if not reconnect:
                            raise
                        logger.warning("multihost regroup failed: %s", exc)
                thr_np = thr_t.detach().cpu().numpy().astype(np.int32)
                if self._chan.alive:
                    try:
                        self._chan.broadcast(xp, blp, thr_np, trace=trace)
                        mesh_up = True
                    except MultihostChannelError:
                        if not reconnect:
                            raise
                        mesh_up = False
                elif reconnect:
                    mesh_up = False
                else:
                    raise MultihostChannelError(self._chan.dead_reason() or "work channel dead")
                if not loopback and mesh_up:
                    per, off = local_rows(mesh, xp.shape[0])
                    block = _score_block(self, xp[off:off + per], blp[off:off + per],
                                         thr_np, params)
                    try:
                        return gather_step(self._group, block), None, n
                    except RuntimeError as exc:
                        # A member left mid-collective: this batch is
                        # scored locally and the followers redialled.
                        err = self._chan.mark_dead(f"all_gather failed: {exc}")
                        if not reconnect:
                            raise err from exc
                    mesh_up = False
                if not mesh_up:
                    self._degraded_steps += 1
                return super()._launch_padded(xp, blp, n, params, hold=hold, thr=thr)

        def swap_params(self, new_params) -> None:
            """Hot-swap both halves: the followers (a params frame, applied
            before any later work frame) and the front. A follower that is
            down gets the new leaves when it rejoins."""
            with self._step_lock:
                super().swap_params(new_params)
                try:
                    self._chan.broadcast_params(param_leaves(self.get_params()))
                except MultihostChannelError:
                    if not reconnect:
                        raise

        def close(self) -> None:
            try:
                self._chan.close()
            finally:
                super().close()

    return _Engine()


# -- chaos/test stub follower ------------------------------------------------


def stub_follower_serve(port: int, mode: str = "ack",
                        wedge_after: int = 0) -> int:
    """A follower speaking the REAL work-channel protocol (handshake,
    per-step ACK, params frames, STOP) without a process group —
    the harness the chaos soak and the supervisor tests SIGKILL and
    restart to exercise resurrection on backends where multi-process SPMD
    is unavailable. Modes: ``ack`` (normal), ``wedge`` (stop ACKing after
    ``wedge_after`` work frames — the wedged-follower shape). Returns the
    number of work frames served; accepts ONE front connection per call,
    so a restarted stub process is a fresh accept on the same port."""
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", port))
    listener.listen(1)
    print("READY", flush=True)
    conn, _ = listener.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    reader = _Reader(conn)
    n = 0
    try:
        magic, _arrays = _recv_frame(reader)
        if magic != MAGIC_HELLO:
            return 0
        _send_frame(conn, MAGIC_HELLO)
        while True:
            magic, _arrays = _recv_frame(reader)
            if magic in (MAGIC_PARAMS, MAGIC_GROUP):
                continue
            if magic != MAGIC_WORK:
                return n
            n += 1
            if mode == "wedge" and n > wedge_after:
                _sleep(3600)
            conn.sendall(ACK_BYTE)
    except ConnectionError:  # noqa: CC04 — front closed the channel: stub exits
        return n
    finally:
        try:
            conn.close()
        except OSError:  # noqa: CC04 — stub teardown; nothing to record
            pass
        listener.close()
        print(f"SERVED={n}", flush=True)


def _stub_main() -> None:
    """``python -m igaming_platform_tpu_torch.serve.multihost --stub-follower
    --port N [--mode ack|wedge] [--wedge-after K]``"""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--stub-follower", action="store_true", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--mode", default="ack", choices=("ack", "wedge"))
    parser.add_argument("--wedge-after", type=int, default=0)
    args = parser.parse_args()
    stub_follower_serve(args.port, mode=args.mode, wedge_after=args.wedge_after)


if __name__ == "__main__":
    _stub_main()

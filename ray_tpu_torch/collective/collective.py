"""Process-group collectives over a pluggable fabric, in PyTorch.

The port's counterpart of the group layer of
ray_tpu/collective/collective.py: :class:`CollectiveAbortError` and
:class:`CollectiveTimeoutError`, a mailbox, :class:`Group`, ``allreduce``,
``reducescatter`` and ``allgather`` with transport ``ring`` (the default:
``ring.py``) or ``star`` (rank 0 reduces and sends the result back, the
fallback), the rooted ``reduce`` and ``broadcast``, and ``barrier``.

JAX's ``Group`` sends over its runtime's RPC and finds its peers through
the control plane's KV. The port's takes a fabric instead, which moves
frames between the ranks of one group incarnation:

- :class:`LocalFabric`: the ranks are threads of this process (the train
  gang, ``InProcessRuntime``); a send is a put into the receiver's
  mailbox, and a ``check`` of the caller's runs at every wait;
- :class:`SocketFabric`: the ranks are processes (``ProcessRuntime``, the
  process train gang); each listens on an ``AF_UNIX`` socket and is
  linked to its ring neighbours and to rank 0, one reader thread a link
  feeding the process's mailbox. Every frame carries its epoch. EOF on a
  link is the peer's death: the incarnation aborts, and the abort is
  sent on over the other links.

A fabric has ``send(src, dst, key, obj)``, ``take(rank, key, timeout,
abort)``, ``abort_record(rank)`` (None, or ``{"reason", "origin"}`` once
the incarnation is aborted; it may also raise for the caller itself) and
``POLL_S``, the longest a wait goes without looking at the abort.

Group epochs, for the ranks that are processes: a process keeps JAX's
registry of its live groups by name (``_groups``), the times it has
joined each name (``_inc_counts``) and the lowest epoch whose frames it
still takes (``_min_epochs``). :func:`init_collective_group`,
:func:`reform_group` (which must bump past the live epoch, and drops the
old incarnation's error-feedback residuals), :func:`destroy_collective_group`
(which purges the group's frames and raises the floor, so a straggler of
an older epoch is dropped at ingress), :func:`abort_all_local`,
:func:`get_rank` and :func:`get_collective_group_size` are JAX's. The
port has no control-plane KV: where JAX's ranks find each other under
epoch-namespaced keys (``{group}@{epoch}/{rank}``) and agree on the
epoch through its channel, the driver picks the epoch (the highest of
the members' live epochs, plus one) and hands out fresh ``AF_UNIX``
addresses for each epoch under its runtime's store directory. JAX's peer
probe becomes an abortable join: :meth:`SocketFabric.connect` waits with
its abort polled, so a driver that sees a member die during a join
aborts the others' joins (:func:`abort_join`, from a second call thread
of each member), which raise :class:`CollectiveAbortError` at once. One rank of a group a process: the mailbox is the process's.

Not ported: ``send`` / ``recv`` / ``paced_*`` (ROADMAP).
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import threading
import time
from multiprocessing import connection as mp_connection
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.collective import compression, ring
from ray_tpu_torch.collective.compression import as_tensor

logger = logging.getLogger(__name__)


class CollectiveAbortError(RuntimeError):
    """A collective op was aborted because the group lost a member (or is
    being quiesced). Raised by every surviving rank blocked in, or
    entering, a collective of the aborted incarnation; names the group,
    the rank, the epoch and the op."""

    def __init__(self, group: str, rank: int, epoch: int, op: str | None,
                 reason: str, origin_rank: int | None = None):
        self.group = group
        self.rank = rank
        self.epoch = epoch
        self.op = op
        self.reason = reason
        self.origin_rank = origin_rank
        origin = "" if origin_rank is None else f" (from rank {origin_rank})"
        super().__init__(
            f"collective group '{group}' rank {rank} epoch {epoch}: "
            f"op '{op or '?'}' aborted{origin}: {reason}")

    def __reduce__(self):
        return (type(self), (self.group, self.rank, self.epoch, self.op,
                             self.reason, self.origin_rank))


class CollectiveTimeoutError(TimeoutError):
    """A collective op rode out its deadline waiting for a peer's frame."""


class _Aborted(Exception):
    """Mailbox wake-up signal; surfaces as CollectiveAbortError."""

    def __init__(self, info: dict):
        self.info = info


def _transport(override: str | None = None) -> str:
    t = override or compression.TRANSPORT
    if t not in ("ring", "star"):
        raise ValueError(f"collective transport must be 'ring' or 'star', "
                         f"got {t!r}")
    return t


class Mailbox:
    """An inbox of frames: one rank's for one incarnation of a
    ``LocalFabric``, keyed (seq, src, tag); a process's for its socket
    groups, keyed (group, epoch, seq, src, tag)."""

    def __init__(self):
        self.msgs: dict[tuple, Any] = {}
        self.cond = threading.Condition()

    def put(self, key: tuple, value) -> None:
        with self.cond:
            self.msgs[key] = value
            self.cond.notify_all()

    def wake(self) -> None:
        with self.cond:
            self.cond.notify_all()

    def take(self, key: tuple, timeout: float, abort, poll: float):
        """Wait for a frame. ``abort`` returns the incarnation's abort
        record (or None); it is looked at on every wake, and at least
        every ``poll`` seconds."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while key not in self.msgs:
                info = abort()
                if info is not None:
                    raise _Aborted(info)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"collective wait timed out on {key}")
                self.cond.wait(timeout=min(remaining, poll))
            return self.msgs.pop(key)


class Group:
    """One rank's view of a collective group incarnation over a fabric."""

    def __init__(self, name: str, world_size: int, rank: int, fabric,
                 epoch: int = 1):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.fabric = fabric
        self.epoch = epoch
        # lockstep counter: every rank runs collectives in the same order
        self.seq = 0

    def _next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def _abort_error(self, info: dict, op: str | None) -> CollectiveAbortError:
        return CollectiveAbortError(self.name, self.rank, self.epoch,
                                    op or info.get("op"), info["reason"],
                                    origin_rank=info.get("origin"))

    def _poll_abort(self, op: str | None = None) -> None:
        """Raise if this incarnation was aborted (the ring calls this at
        every step; receives look inside their wait)."""
        info = self.fabric.abort_record(self.rank)
        if info is not None:
            raise self._abort_error(info, op)

    def _send_obj(self, dst_rank: int, seq: int, tag: str, obj) -> None:
        """Ship a frame to a peer's mailbox (a buffered send, as JAX's
        ``fire``: every fabric here buffers)."""
        self._poll_abort(op=tag)
        self.fabric.send(self.rank, dst_rank, (seq, self.rank, tag), obj)

    def _recv_obj(self, src_rank: int, seq: int, tag: str,
                  timeout: float | None = None, op: str | None = None):
        timeout = compression.TIMEOUT_S if timeout is None else timeout
        try:
            return self.fabric.take(
                self.rank, (seq, src_rank, tag), timeout,
                abort=lambda: self.fabric.abort_record(self.rank))
        except _Aborted as a:
            raise self._abort_error(a.info, op or tag) from None
        except TimeoutError:
            raise CollectiveTimeoutError(
                f"collective group '{self.name}' rank {self.rank}: op "
                f"'{op or tag}' timed out after {timeout}s waiting for rank "
                f"{src_rank} (seq {seq}, tag {tag!r})") from None


# ---------------------------------------------------------------------------
# fabrics
# ---------------------------------------------------------------------------


class LocalFabric:
    """The ranks of one incarnation as threads of this process: a mailbox
    a rank. ``check(rank)`` runs at every wait of that rank: it returns
    an abort record for a peer's loss (or None), or raises for the caller
    itself; the first record stays. A wait looks every ``POLL_S``: a
    kill or an abort in this process sets a flag, not the mailbox."""

    POLL_S = 0.05

    def __init__(self, world_size: int, check=None):
        self.boxes = [Mailbox() for _ in range(world_size)]
        self.check = check
        self._abort: dict | None = None

    def send(self, src: int, dst: int, key: tuple, obj) -> None:
        self.boxes[dst].put(key, obj)

    def take(self, rank: int, key: tuple, timeout: float, abort):
        return self.boxes[rank].take(key, timeout, abort, self.POLL_S)

    def abort_record(self, rank: int) -> dict | None:
        if self._abort is None and self.check is not None:
            info = self.check(rank)
            if info is not None:
                self._abort = info
        return self._abort


# ---------------------------------------------------------------------------
# a process's groups: the mailbox, the registry, the ingress floor
# ---------------------------------------------------------------------------

_groups: dict[str, Group] = {}
# times THIS process has joined each group name (JAX publishes it at
# rendezvous; here the driver reads it to pick a first epoch)
_inc_counts: dict[str, int] = {}
# the lowest live epoch a name: frames below it are stragglers of a
# destroyed incarnation, dropped at ingress (nothing would take them)
_min_epochs: dict[str, int] = {}
# the fabrics of joins in progress, by name: abort_all_local ends them
_joins: dict[str, "SocketFabric"] = {}
# (name, epoch) -> reason: joins a driver aborted before they started
_join_aborts: dict[tuple, str] = {}
_box: Mailbox | None = None
_lock = threading.Lock()


def _mailbox() -> Mailbox:
    """This process's inbox for socket groups, keyed (group, epoch, seq,
    src, tag) as JAX's."""
    global _box
    with _lock:
        if _box is None:
            _box = Mailbox()
        return _box


def _ingress(group: str, epoch: int, key: tuple, obj) -> bool:
    """A frame arriving for ``group`` at ``epoch`` (JAX's
    ``_rpc_coll_msg``): False, and dropped, below the group's floor."""
    if epoch < _min_epochs.get(group, 0):
        return False
    _mailbox().put((group, epoch) + tuple(key), obj)
    return True


def _links(world: int) -> set[tuple[int, int]]:
    """The (low, high) rank pairs a socket group links: ring neighbours,
    and rank 0 with every rank (the star)."""
    pairs = set()
    for r in range(world):
        for peer in ((r + 1) % world, 0):
            if peer != r:
                pairs.add((min(r, peer), max(r, peer)))
    return pairs


def _shut(conn) -> None:
    """Close a link so that the threads reading either end see EOF."""
    try:
        s = socket.socket(fileno=os.dup(conn.fileno()))
    except OSError:
        return
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.close()
    try:
        conn.close()
    except OSError:
        pass


class SocketFabric:
    """One member's side of an incarnation of a group of processes (module
    docstring). It listens on ``addresses[rank]``; for each linked pair
    the higher rank connects to the lower, says its rank, and both ends
    read frames off the link on a thread of their own. A frame is a
    pickled ``("msg", epoch, key, obj)`` or ``("abort", epoch,
    record)``: a message goes to the process's mailbox through the
    ingress floor, an abort of another epoch is ignored."""

    POLL_S = compression.ABORT_POLL_S

    def __init__(self, name: str, rank: int, addresses: list, authkey: bytes,
                 epoch: int = 1):
        self.name = name
        self.rank = rank
        self.addresses = addresses
        self.authkey = authkey
        self.epoch = epoch
        self.cond = threading.Condition()
        self.conns: dict[int, Any] = {}
        self.send_locks: dict[int, threading.Lock] = {}
        self.peers = {lo if hi == rank else hi
                      for lo, hi in _links(len(addresses)) if rank in (lo, hi)}
        self._abort: dict | None = None
        self._aborted = threading.Event()
        self._closed = False
        self.listener = mp_connection.Listener(addresses[rank], "AF_UNIX",
                                               authkey=authkey)
        threading.Thread(target=self._accept, name=f"{name}.accept",
                         daemon=True).start()

    def _accept(self) -> None:
        expected = sum(1 for p in self.peers if p > self.rank)
        for _ in range(expected):
            try:
                conn = self.listener.accept()
                peer = pickle.loads(conn.recv_bytes())
            except (OSError, EOFError, mp_connection.AuthenticationError):
                return
            self._adopt(peer, conn)

    def _adopt(self, peer: int, conn) -> None:
        with self.cond:
            if self._closed:
                _shut(conn)
                return
            self.conns[peer] = conn
            self.send_locks[peer] = threading.Lock()
            self.cond.notify_all()
        threading.Thread(target=self._read, args=(peer, conn),
                         name=f"{self.name}.link{peer}", daemon=True).start()

    def _join_error(self) -> CollectiveAbortError:
        a = self._abort or {"reason": "the incarnation was closed"}
        return CollectiveAbortError(self.name, self.rank, self.epoch, "join",
                                    a["reason"], origin_rank=a.get("origin"))

    def _dial(self, peer: int, deadline: float, timeout: float):
        """A link to a lower rank, retried until its listener is up. The
        dial runs on a thread of its own, so that an abort ends the wait
        even where the peer listens and never answers."""
        out: dict = {}
        done = threading.Event()

        def go():
            while True:
                try:
                    conn = mp_connection.Client(self.addresses[peer], "AF_UNIX",
                                                authkey=self.authkey)
                except (OSError, EOFError, mp_connection.AuthenticationError):
                    if self._aborted.is_set() or time.monotonic() > deadline:
                        break
                    time.sleep(0.01)
                    continue
                if self._aborted.is_set():
                    _shut(conn)  # the join was abandoned meanwhile
                else:
                    out["conn"] = conn
                break
            done.set()

        threading.Thread(target=go, name=f"{self.name}.dial{peer}",
                         daemon=True).start()
        while not done.is_set():
            if self._aborted.wait(min(self.POLL_S, max(
                    0.0, deadline - time.monotonic()) + 0.01)):
                raise self._join_error()
            if time.monotonic() > deadline + 1.0:
                break
        if "conn" not in out:
            if self._abort is not None:
                raise self._join_error()
            raise CollectiveTimeoutError(
                f"collective group '{self.name}' rank {self.rank} epoch "
                f"{self.epoch}: rank {peer} did not listen within {timeout}s")
        return out["conn"]

    def connect(self, timeout: float) -> None:
        """Open the links to the lower ranks (retrying until their
        listeners are up) and wait for the higher ranks' links. Raises
        :class:`CollectiveAbortError` once the incarnation is aborted
        (a linked peer's EOF, or :meth:`abort` from another thread: a
        driver ending the join), :class:`CollectiveTimeoutError` past
        ``timeout``."""
        deadline = time.monotonic() + timeout
        for peer in sorted(p for p in self.peers if p < self.rank):
            if peer in self.conns:
                continue
            conn = self._dial(peer, deadline, timeout)
            try:
                conn.send_bytes(pickle.dumps(self.rank))
            except OSError:
                self.abort(f"lost the link to rank {peer} while joining",
                           origin=peer)
                raise self._join_error() from None
            self._adopt(peer, conn)
        with self.cond:
            while not self.peers <= set(self.conns):
                if self._abort is not None:
                    raise self._join_error()
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CollectiveTimeoutError(
                        f"collective group '{self.name}' rank {self.rank} "
                        f"epoch {self.epoch}: ranks "
                        f"{sorted(self.peers - set(self.conns))} did not "
                        f"link within {timeout}s")
                self.cond.wait(min(left, self.POLL_S))
            if self._abort is not None:
                raise self._join_error()

    def _read(self, peer: int, conn) -> None:
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                if not self._closed:
                    self.abort(f"lost the link to rank {peer}", origin=peer)
                return
            self._deliver(msg)

    def _deliver(self, msg) -> None:
        """A frame off a link: a message through the ingress floor, an
        abort of this epoch applied (one of another epoch is stale)."""
        if msg[0] == "msg":
            _ingress(self.name, msg[1], msg[2], msg[3])
        elif msg[1] == self.epoch:
            self.abort(msg[2]["reason"], origin=msg[2].get("origin"))

    def take(self, rank: int, key: tuple, timeout: float, abort):
        return _mailbox().take((self.name, self.epoch) + tuple(key), timeout,
                               abort, self.POLL_S)

    def _write(self, peer: int, data: bytes) -> None:
        with self.send_locks[peer]:
            self.conns[peer].send_bytes(data)

    def send(self, src: int, dst: int, key: tuple, obj) -> None:
        if dst not in self.conns:
            raise ValueError(f"collective group '{self.name}' rank {src} has "
                             f"no link to rank {dst}")
        try:
            self._write(dst, pickle.dumps(("msg", self.epoch, key, obj),
                                          protocol=5))
        except OSError:
            self.abort(f"cannot reach rank {dst}", origin=dst)

    def abort(self, reason: str, origin: int | None = None, *,
              forward: bool = True) -> bool:
        """Abort this incarnation here and, with ``forward``, send the
        abort on over every other link. The first abort stays: a second
        returns False."""
        with self.cond:
            if self._abort is not None:
                return False
            self._abort = {"reason": reason, "origin": origin}
            self._aborted.set()
            self.cond.notify_all()
            peers = [p for p in self.conns if p != origin] if forward else []
        _mailbox().wake()
        logger.warning("collective group '%s' rank %d epoch %d aborted: %s",
                       self.name, self.rank, self.epoch, reason)
        if peers:
            data = pickle.dumps(("abort", self.epoch, self._abort))

            def fan_out():
                for p in peers:
                    try:
                        self._write(p, data)
                    except OSError:
                        pass

            threading.Thread(target=fan_out, name=f"{self.name}.abort",
                             daemon=True).start()
        return True

    def abort_record(self, rank: int) -> dict | None:
        return self._abort

    def close(self) -> None:
        """Close the listener (its socket file goes with it) and every
        link; the peers see EOF."""
        with self.cond:
            self._closed = True
            conns = list(self.conns.values())
            self.cond.notify_all()
        self._aborted.set()  # a dial in flight gives up
        try:
            sock = getattr(getattr(self.listener, "_listener", None),
                           "_socket", None)
            if sock is not None:
                sock.shutdown(socket.SHUT_RDWR)  # wakes the accept thread
        except OSError:
            pass
        try:
            self.listener.close()
        except OSError:
            pass
        for conn in conns:
            _shut(conn)


# ---------------------------------------------------------------------------
# joining, reforming and leaving a socket group (JAX's group lifecycle)
# ---------------------------------------------------------------------------


def _join(name: str, world_size: int, rank: int, addresses: list,
          authkey: bytes, epoch: int, timeout: float) -> Group:
    """Listen, link and wait for every link of incarnation ``epoch``;
    :func:`abort_all_local` and :func:`abort_join` end the wait."""
    with _lock:
        reason = _join_aborts.pop((name, epoch), None)
        if reason is None:
            fabric = SocketFabric(name, rank, list(addresses), authkey,
                                  epoch=epoch)
            _joins[name] = fabric
    if reason is not None:
        raise CollectiveAbortError(name, rank, epoch, "join", reason)
    try:
        fabric.connect(timeout)
    except BaseException:
        fabric.close()
        raise
    finally:
        with _lock:
            if _joins.get(name) is fabric:
                del _joins[name]
    return Group(name, world_size, rank, fabric, epoch=epoch)


def _adopt_group(g: Group) -> Group:
    _min_epochs[g.name] = max(_min_epochs.get(g.name, 0), g.epoch)
    _inc_counts[g.name] = g.epoch
    _groups[g.name] = g
    return g


def init_collective_group(world_size: int, rank: int, backend: str = "cpu",
                          group_name: str = "default", timeout: float = 120.0,
                          *, addresses: list, authkey: bytes,
                          epoch: int | None = None) -> Group:
    """Join a socket group at ``addresses`` (one a rank) and register it
    under ``group_name``. JAX's epoch is the highest of the ranks' join
    counts plus one, agreed over its KV; a driver gives it as ``epoch``
    (None: this process's own count plus one). A live group of that name
    is torn down first."""
    if backend != "cpu":
        raise ValueError(f"the host collective's backend is 'cpu', not "
                         f"{backend!r}")
    if group_name in _groups:
        destroy_collective_group(group_name)
    if epoch is None:
        epoch = _inc_counts.get(group_name, 0) + 1
    return _adopt_group(_join(group_name, world_size, rank, addresses,
                              authkey, epoch, timeout))


def reform_group(world_size: int, rank: int, group_name: str = "default", *,
                 addresses: list, authkey: bytes, epoch: int | None = None,
                 timeout: float | None = None) -> Group:
    """Rebuild a group over survivors and new members under a bumped
    epoch. ``epoch`` must bump past this process's live incarnation
    (ValueError otherwise, as JAX's: its frames would fall under the
    floor that tearing the old one down raises); None bumps it by one,
    and a process with no live group must be given it (there is no
    epoch channel to follow). The old incarnation is destroyed first:
    its frames purged, its error-feedback residuals dropped (membership
    changes the ring's segments, so an old residual would fold into the
    wrong elements), its floor raised."""
    timeout = compression.TIMEOUT_S if timeout is None else timeout
    old = _groups.get(group_name)
    old_epoch = old.epoch if old is not None else None
    if epoch is not None and old_epoch is not None and epoch <= old_epoch:
        raise ValueError(
            f"reform_group('{group_name}'): epoch {epoch} does not bump "
            f"past the live incarnation's epoch {old_epoch}")
    if epoch is None:
        if old_epoch is None:
            raise ValueError(f"reform_group('{group_name}'): no live "
                             "incarnation here, so the epoch must be given")
        epoch = old_epoch + 1
    if old is not None:
        destroy_collective_group(group_name)
    g = _adopt_group(_join(group_name, world_size, rank, addresses, authkey,
                           epoch, timeout))
    logger.info("collective group '%s' rank %d reformed at epoch %d (world "
                "%d)", group_name, rank, epoch, world_size)
    return g


def destroy_collective_group(group_name: str = "default") -> None:
    """Tear down this rank's view of a group: its pending frames purged,
    its residuals and stats dropped, the ingress floor raised past its
    epoch, its links and listener closed."""
    with _lock:
        g = _groups.pop(group_name, None)
    box = _box
    if box is not None:
        with box.cond:
            for k in [k for k in box.msgs if k[0] == group_name]:
                del box.msgs[k]
    ring.purge_group(group_name)
    if g is not None:
        _min_epochs[group_name] = max(_min_epochs.get(group_name, 0),
                                      g.epoch + 1)
        close = getattr(g.fabric, "close", None)
        if close is not None:
            close()


def abort_all_local(reason: str) -> int:
    """Abort every live incarnation and every join in progress in THIS
    process, sending no frame to the peers (JAX's in-place-resume quiesce
    hook; a driver's abort of a join). Returns how many were newly
    aborted."""
    with _lock:
        fabrics = [g.fabric for g in _groups.values()] + list(_joins.values())
    n = 0
    for f in fabrics:
        abort = getattr(f, "abort", None)
        if abort is not None and abort(reason, forward=False):
            n += 1
    return n


def abort_join(group_name: str, epoch: int, reason: str) -> None:
    """End this process's join of ``group_name`` at ``epoch``: the join in
    progress raises :class:`CollectiveAbortError` at once, one that has
    not started yet raises as it starts, and an incarnation that has
    already formed aborts. A driver calls this (from a second call
    thread) when another member dies during the join."""
    with _lock:
        f = _joins.get(group_name)
        g = _groups.get(group_name)
        if f is not None and f.epoch == epoch:
            target = f
        elif g is not None and g.epoch == epoch:
            target = g.fabric
        else:
            target = None
            _join_aborts[(group_name, epoch)] = reason
    if target is not None:
        target.abort(reason, forward=False)


def collective_epoch(group_name: str) -> int:
    """This process's live epoch of the group, 0 without one (JAX's
    ``__ray_tpu_collective_epoch__``)."""
    g = _groups.get(group_name)
    return 0 if g is None else g.epoch


def join_count(group_name: str) -> int:
    """How many times this process has joined the group name."""
    return _inc_counts.get(group_name, 0)


def get_rank(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return -1 if g is None else g.rank


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return -1 if g is None else g.world_size


def get_group(group_name: str = "default") -> Group:
    """The live group of that name in this process."""
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(f"collective group '{group_name}' not initialized "
                           "in this process")
    return g


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def allreduce(g: Group, tensor, op: str = "sum", *, codec=None,
              transport: str | None = None, timeout: float | None = None,
              ef_tag: str | None = None, out: torch.Tensor | None = None):
    """Allreduce of a host payload (numpy array or CPU tensor; the result
    is of the same kind) over the group.

    ``transport`` ``ring`` (default: ``ring.py``, 2·(N−1)/N bytes a rank)
    or ``star`` (rank 0 reduces, full precision). ``codec`` is a ring
    wire codec (``none`` / ``bf16`` / ``int8``). ``ef_tag`` names a
    stable tensor across calls (a gradient bucket): error feedback
    engages only when it is set. ``out``: a contiguous CPU tensor of the
    payload's shape and dtype (the payload itself allowed) that receives
    the result and is returned, where the result keeps that dtype (all
    but the mean of integers, and the star's widened integer sums);
    otherwise the result is new and ``tensor`` is not written to."""
    if _transport(transport) == "ring":
        return ring.ring_allreduce(g, tensor, op=op, codec=codec,
                                   timeout=timeout, ef_tag=ef_tag, out=out)
    return _star_allreduce(g, tensor, op, timeout, out)


def _star_sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """numpy's accumulator for ``np.sum`` / ``np.prod``: small integers
    and bool widen to int64."""
    if dtype.is_floating_point or dtype.is_complex or dtype == torch.int64:
        return dtype
    return torch.int64


def _star_reduce(op: str, parts: list[torch.Tensor]) -> torch.Tensor:
    """JAX's ``_REDUCE[op](np.stack(parts))`` over axis 0, in rank order
    (numpy folds the outer axis one row after another)."""
    dtype = parts[0].dtype
    if op in ("sum", "prod"):
        acc = parts[0].to(_star_sum_dtype(dtype), copy=True)
        for p in parts[1:]:
            acc.add_(p) if op == "sum" else acc.mul_(p)
        return acc
    if op in ("max", "min"):
        fn = torch.maximum if op == "max" else torch.minimum
        acc = parts[0].clone()
        for p in parts[1:]:
            fn(acc, p, out=acc)
        return acc
    if op == "mean":
        # np.mean: integers in float64, float16 in float32 (then back)
        if not dtype.is_floating_point:
            acc_dtype = torch.float64
        elif dtype == torch.float16:
            acc_dtype = torch.float32
        else:
            acc_dtype = dtype
        acc = parts[0].to(acc_dtype, copy=True)
        for p in parts[1:]:
            acc.add_(p)
        acc = acc / len(parts)
        return acc.to(dtype) if dtype == torch.float16 else acc
    raise ValueError(f"unknown reduce op {op!r}")


def _star_allreduce(g: Group, arr, op: str, timeout: float | None = None,
                    out: torch.Tensor | None = None):
    """Tree allreduce through rank 0 (reference collective.py:258)."""
    t = as_tensor(arr)
    seq = g._next_seq()
    st = ring.OpStats("allreduce", "star", "none", g.world_size,
                      tensor_bytes=t.numel() * t.element_size())
    if g.world_size == 1:
        ring.record_stats(g, st)
        return _into(out, t if out is not None else t.clone(), arr)
    t0 = time.perf_counter()
    if g.rank == 0:
        parts = [t] + [as_tensor(g._recv_obj(r, seq, "ar-up", timeout,
                                             op="allreduce"))
                       for r in range(1, g.world_size)]
        st.bytes_recv += sum(p.numel() * p.element_size() for p in parts[1:])
        res = _star_reduce(op, parts)
        for r in range(1, g.world_size):
            g._send_obj(r, seq, "ar-down", res.clone())
        st.bytes_sent += res.numel() * res.element_size() * (g.world_size - 1)
        st.chunks = 2 * (g.world_size - 1)
    else:
        g._send_obj(0, seq, "ar-up", t.clone())
        res = as_tensor(g._recv_obj(0, seq, "ar-down", timeout,
                                    op="allreduce"))
        st.bytes_sent += t.numel() * t.element_size()
        st.bytes_recv += res.numel() * res.element_size()
        st.chunks = 2
    st.seconds = time.perf_counter() - t0
    ring.record_stats(g, st)
    return _into(out, res, arr)


def _into(out: torch.Tensor | None, res: torch.Tensor, arr):
    """The star's result ``res``, copied into ``out`` where it has
    ``out``'s dtype, as the caller's kind."""
    if out is None or out.dtype != res.dtype:
        return ring._like(res, arr)
    if out.data_ptr() != res.data_ptr():
        out.copy_(res.reshape(out.shape))
    return ring._like(out, arr)


def allgather(g: Group, tensor, *, codec=None, transport: str | None = None,
              timeout: float | None = None) -> list:
    """Every rank's payload (one shape on every rank), in rank order."""
    if _transport(transport) == "ring":
        return ring.ring_allgather(g, tensor, codec=codec, timeout=timeout)
    t = as_tensor(tensor)
    seq = g._next_seq()
    if g.world_size == 1:
        return [tensor]
    if g.rank == 0:
        parts = [t] + [as_tensor(g._recv_obj(r, seq, "ag-up", timeout,
                                             op="allgather"))
                       for r in range(1, g.world_size)]
        stacked = torch.stack(parts)
        for r in range(1, g.world_size):
            g._send_obj(r, seq, "ag-down", stacked.clone())
        return [ring._like(p, tensor) for p in parts]
    g._send_obj(0, seq, "ag-up", t.clone())
    stacked = as_tensor(g._recv_obj(0, seq, "ag-down", timeout, op="allgather"))
    return [ring._like(p, tensor) for p in stacked.unbind(0)]


def reducescatter(g: Group, tensor, op: str = "sum", *, codec=None,
                  transport: str | None = None, timeout: float | None = None,
                  ef_tag: str | None = None):
    """This rank's reduced axis-0 shard (np.array_split's bounds). The
    ring moves (N−1)/N of the tensor a rank; the star is an allreduce,
    then a slice."""
    if _transport(transport) == "ring":
        return ring.ring_reducescatter(g, tensor, op=op, codec=codec,
                                       timeout=timeout, ef_tag=ef_tag)
    out = as_tensor(_star_allreduce(g, tensor, op, timeout))
    shard = torch.tensor_split(out, g.world_size, dim=0)[g.rank]
    return ring._like(shard, tensor)


def reduce(g: Group, tensor, dst_rank: int = 0, op: str = "sum", *,
           timeout: float | None = None):
    """JAX's ``reduce``: ``dst_rank`` gets the reduction of every rank's
    payload (its own first, then the others in rank order, as JAX
    stacks them) and the others get their own payload back."""
    t = as_tensor(tensor)
    seq = g._next_seq()
    if g.rank == dst_rank:
        parts = [t] + [as_tensor(g._recv_obj(r, seq, "red", timeout,
                                             op="reduce"))
                       for r in range(g.world_size) if r != dst_rank]
        return ring._like(_star_reduce(op, parts), tensor)
    g._send_obj(dst_rank, seq, "red", t.clone())
    return tensor


def broadcast(g: Group, tensor, src_rank: int = 0, *,
              timeout: float | None = None):
    """JAX's ``broadcast``: every rank gets ``src_rank``'s payload (the
    others' ``tensor`` only gives the kind of their result)."""
    seq = g._next_seq()
    if g.rank == src_rank:
        t = as_tensor(tensor)
        for r in range(g.world_size):
            if r != src_rank:
                g._send_obj(r, seq, "bc", t.clone())
        return tensor
    return ring._like(as_tensor(g._recv_obj(src_rank, seq, "bc", timeout,
                                            op="broadcast")), tensor)


def barrier(g: Group) -> None:
    """Returns once every rank has entered it (JAX's: an allreduce of one
    zero)."""
    allreduce(g, np.zeros(1))


# ---------------------------------------------------------------------------
# the learner groups' callables
# ---------------------------------------------------------------------------


class Allreducer:
    """Rank ``group.rank``'s sum of a host f32 vector over the ring (as
    JAX's learner groups call it): a fresh array. ``stats()`` is the
    rank's last :class:`ring.OpStats`."""

    def __init__(self, group: Group):
        self.group = group

    def __call__(self, vector, timeout: float = compression.TIMEOUT_S):
        return allreduce(self.group, np.asarray(vector, np.float32), "sum",
                         timeout=timeout)

    def stats(self) -> ring.OpStats | None:
        return ring.last_op_stats(self.group.name, self.group.rank)


_member_groups: dict[str, Group] = {}  # in a member process, by address
_member_lock = threading.Lock()


class MemberAllreducer(Allreducer):
    """A process member's allreduce over a :class:`SocketFabric`:
    picklable, it resolves in the member to the member's own ``Group``.
    Unpickling it joins the group: the member listens, links to its
    peers and waits for theirs, so every member of the group must
    receive its callable at the same time (the learner groups hand them
    out in one ``join_group`` call each). From then on a member's death
    is EOF on its links, whether or not a collective has run."""

    def __init__(self, name: str, world: int, rank: int, addresses: list,
                 authkey: bytes):
        self.spec = (name, world, rank, list(addresses), authkey)
        self.group = None  # built in the member

    def __getstate__(self):
        return {"spec": self.spec}

    def __setstate__(self, state):
        self.spec = state["spec"]
        name, world, rank, addresses, authkey = self.spec
        with _member_lock:  # one group an address, however often it comes
            g = _member_groups.get(addresses[rank])
            if g is None:
                fabric = SocketFabric(name, rank, addresses, authkey)
                g = _member_groups[addresses[rank]] = Group(name, world, rank,
                                                            fabric)
        self.group = g
        try:
            g.fabric.connect(compression.TIMEOUT_S)
        except CollectiveAbortError:
            pass  # the abort stays: the group's first collective raises it


def socket_addresses(root: str, token: str, world: int) -> list[str]:
    """One ``AF_UNIX`` address a rank: a file under ``root``, or, where
    that path is too long for a socket, a name in Linux's abstract
    namespace."""
    out = []
    for r in range(world):
        path = os.path.join(root, f"c{token}-{r}")
        out.append(path if len(path.encode()) < 100
                   else f"\0ray_tpu_torch-{token}-{os.getpid()}-{r}")
    return out

"""Process-group collectives over a pluggable fabric, in PyTorch.

The port's counterpart of the group layer of
ray_tpu/collective/collective.py: :class:`CollectiveAbortError` and
:class:`CollectiveTimeoutError`, a mailbox, :class:`Group`, and
``allreduce``, ``reducescatter`` and ``allgather`` with transport
``ring`` (the default: ``ring.py``) or ``star`` (rank 0 reduces and sends
the result back, the fallback).

JAX's ``Group`` sends over its runtime's RPC and finds its peers through
the control plane's KV. The port's takes a fabric instead, which moves
frames between the ranks of one group incarnation:

- :class:`LocalFabric`: the ranks are threads of this process (the train
  gang, ``InProcessRuntime``); a send is a put into the receiver's
  mailbox, and a ``check`` of the caller's runs at every wait;
- :class:`SocketFabric`: the ranks are processes (``ProcessRuntime``);
  each listens on an ``AF_UNIX`` socket and is linked to its ring
  neighbours and to rank 0, one reader thread a link feeding its mailbox.
  EOF on a link is the peer's death: the group aborts, and the abort is
  sent on over the other links.

A fabric has ``mailbox(rank)``, ``send(src, dst, key, obj)``,
``abort_record(rank)`` (None, or ``{"reason", "origin"}`` once the
incarnation is aborted; it may also raise for the caller itself) and
``POLL_S``, the longest a wait goes without looking at the abort.

Not ported: the KV rendezvous, epoch publishing and peer probes, and
``send`` / ``recv`` / ``paced_*`` (ROADMAP).
"""

from __future__ import annotations

import logging
import os
import pickle
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
    """One rank's inbox for one group incarnation, keyed (seq, src, tag)."""

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
            return self.fabric.mailbox(self.rank).take(
                (seq, src_rank, tag), timeout,
                abort=lambda: self.fabric.abort_record(self.rank),
                poll=self.fabric.POLL_S)
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

    def mailbox(self, rank: int) -> Mailbox:
        return self.boxes[rank]

    def send(self, src: int, dst: int, key: tuple, obj) -> None:
        self.boxes[dst].put(key, obj)

    def abort_record(self, rank: int) -> dict | None:
        if self._abort is None and self.check is not None:
            info = self.check(rank)
            if info is not None:
                self._abort = info
        return self._abort


def _links(world: int) -> set[tuple[int, int]]:
    """The (low, high) rank pairs a socket group links: ring neighbours,
    and rank 0 with every rank (the star)."""
    pairs = set()
    for r in range(world):
        for peer in ((r + 1) % world, 0):
            if peer != r:
                pairs.add((min(r, peer), max(r, peer)))
    return pairs


class SocketFabric:
    """One member's side of a group of processes (module docstring). It
    listens on ``addresses[rank]``; for each linked pair the higher rank
    connects to the lower, says its rank, and both ends read frames off
    the link on a thread of their own. A frame is a pickled ``("msg",
    key, obj)`` or ``("abort", record)``."""

    POLL_S = compression.ABORT_POLL_S

    def __init__(self, name: str, rank: int, addresses: list, authkey: bytes):
        self.name = name
        self.rank = rank
        self.addresses = addresses
        self.authkey = authkey
        self.box = Mailbox()
        self.cond = threading.Condition()
        self.conns: dict[int, Any] = {}
        self.send_locks: dict[int, threading.Lock] = {}
        self.peers = {lo if hi == rank else hi
                      for lo, hi in _links(len(addresses)) if rank in (lo, hi)}
        self._abort: dict | None = None
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
            self.conns[peer] = conn
            self.send_locks[peer] = threading.Lock()
            self.cond.notify_all()
        threading.Thread(target=self._read, args=(peer, conn),
                         name=f"{self.name}.link{peer}", daemon=True).start()

    def connect(self, timeout: float) -> None:
        """Open the links to the lower ranks (retrying until their
        listeners are up) and wait for the higher ranks' links."""
        deadline = time.monotonic() + timeout
        for peer in sorted(p for p in self.peers if p < self.rank):
            if peer in self.conns:
                continue
            while True:
                try:
                    conn = mp_connection.Client(self.addresses[peer], "AF_UNIX",
                                                authkey=self.authkey)
                    break
                except (FileNotFoundError, ConnectionRefusedError):
                    if time.monotonic() > deadline:
                        raise CollectiveTimeoutError(
                            f"collective group '{self.name}' rank {self.rank}:"
                            f" rank {peer} did not listen within {timeout}s"
                        ) from None
                    time.sleep(0.01)
            conn.send_bytes(pickle.dumps(self.rank))
            self._adopt(peer, conn)
        with self.cond:
            while not self.peers <= set(self.conns):
                if self._abort is not None:
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CollectiveTimeoutError(
                        f"collective group '{self.name}' rank {self.rank}: "
                        f"ranks {sorted(self.peers - set(self.conns))} did "
                        f"not link within {timeout}s")
                self.cond.wait(min(left, self.POLL_S))

    def _read(self, peer: int, conn) -> None:
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                self.abort(f"lost the link to rank {peer}", origin=peer)
                return
            if msg[0] == "msg":
                self.box.put(msg[1], msg[2])
            else:
                self.abort(msg[1]["reason"], origin=msg[1].get("origin"))

    def mailbox(self, rank: int) -> Mailbox:
        return self.box

    def _write(self, peer: int, data: bytes) -> None:
        with self.send_locks[peer]:
            self.conns[peer].send_bytes(data)

    def send(self, src: int, dst: int, key: tuple, obj) -> None:
        if dst not in self.conns:
            raise ValueError(f"collective group '{self.name}' rank {src} has "
                             f"no link to rank {dst}")
        try:
            self._write(dst, pickle.dumps(("msg", key, obj), protocol=5))
        except OSError:
            self.abort(f"cannot reach rank {dst}", origin=dst)

    def abort(self, reason: str, origin: int | None = None) -> None:
        """Abort this incarnation here and send the abort on over every
        other link (once: a second abort is dropped)."""
        with self.cond:
            if self._abort is not None:
                return
            self._abort = {"reason": reason, "origin": origin}
            self.cond.notify_all()
            peers = [p for p in self.conns if p != origin]
        self.box.wake()
        logger.warning("collective group '%s' rank %d aborted: %s",
                       self.name, self.rank, reason)
        data = pickle.dumps(("abort", self._abort))

        def fan_out():
            for p in peers:
                try:
                    self._write(p, data)
                except OSError:
                    pass

        threading.Thread(target=fan_out, name=f"{self.name}.abort",
                         daemon=True).start()

    def abort_record(self, rank: int) -> dict | None:
        return self._abort


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
        g.fabric.connect(compression.TIMEOUT_S)


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

"""Chunked, pipelined ring collectives on the host, in PyTorch.

The port's counterpart of ray_tpu/collective/ring.py. A ring makes each
rank's traffic constant in world size: reduce-scatter moves (N-1)/N of
the tensor a rank, all-gather the same again, 2·(N-1)/N in all, every
link loaded alike (GADGET, arXiv:2202.01158).

- The transport is a group's ``_send_obj`` / ``_recv_obj``
  (``collective.py``'s ``Group`` over a fabric). Every chunk of a step is
  sent before the first receive, so a slow link overlaps the encoding.
- Segments are split into ``CHUNK_BYTES`` chunks (the last may be
  ragged). Chunking never changes the order of accumulation, so every
  chunk size gives the same bits.
- Codecs (``compression.py``) compress each reduce-scatter hop. When the
  caller names a stable tensor (``ef_tag``) and the op is additive, the
  quantization error is carried in residuals keyed (group, rank, tag,
  segment, chunk) into the next call. The all-gather forwards each
  rank's encoded frame unchanged, so it adds no further error.
- Each op records an :class:`OpStats` (wire and logical bytes, chunks,
  seconds), read by :func:`last_op_stats`.

The fold order of a segment is a rotation of rank order, as in JAX; a
lossless payload accumulates in its own dtype (bf16 in bf16), a lossy
codec's in f32. A payload is a numpy array or a CPU tensor, and the
result is of the same kind (the mean of integers is float64, as numpy's).

Not ported: the Prometheus metrics, the byte accounting and QoS pacing
of each chunk, and the flight recorder's span (ROADMAP).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.collective import compression
from ray_tpu_torch.collective.compression import as_tensor


def _send_chunk(g, right: int, seq: int, key: str, frame, st) -> None:
    t0 = time.perf_counter()
    g._send_obj(right, seq, key, frame)
    st.send_s += time.perf_counter() - t0
    st.bytes_sent += compression.wire_bytes(frame)
    st.chunks += 1


def _recv_chunk(g, left: int, seq: int, key: str, *, timeout: float, op: str,
                st):
    t0 = time.perf_counter()
    frame = g._recv_obj(left, seq, key, timeout=timeout, op=op)
    dt = time.perf_counter() - t0
    # the first wait of an op is mostly the slowest peer entering it
    if st.recvs == 0:
        st.rendezvous_s += dt
    else:
        st.recv_wait_s += dt
    st.recvs += 1
    st.bytes_recv += compression.wire_bytes(frame)
    return frame


def _reduce_into(op: str, dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst = op(dst, src)`` elementwise (``mean`` adds, then divides at
    the end)."""
    if op in ("sum", "mean"):
        dst.add_(src)
    elif op == "prod":
        dst.mul_(src)
    elif op == "max":
        torch.maximum(dst, src, out=dst)
    elif op == "min":
        torch.minimum(dst, src, out=dst)
    else:
        raise ValueError(f"unknown reduce op {op!r}")


@dataclass
class OpStats:
    """Per-op wire accounting, one record per collective call per rank."""

    op: str
    transport: str
    codec: str
    world_size: int
    tensor_bytes: int = 0      # logical (pre-codec) payload size
    bytes_sent: int = 0        # codec-encoded bytes this rank put on wire
    bytes_recv: int = 0
    chunks: int = 0
    seconds: float = 0.0
    # span breakdown (perf_counter deltas): the first blocking receive
    # (waiting for the slowest peer to enter the op), later chunk waits,
    # send time, and encode / decode / reduce compute
    t_start: float = field(default_factory=time.monotonic)
    rendezvous_s: float = 0.0
    recv_wait_s: float = 0.0
    send_s: float = 0.0
    compute_s: float = 0.0
    recvs: int = 0

    @property
    def compression_ratio(self) -> float:
        """Uncompressed-ring-bytes / actual-wire-bytes of this op (1.0: no
        compression; >1: codec savings)."""
        n = max(self.world_size, 1)
        moved = max(self.bytes_sent, 1)
        if self.op == "reducescatter":
            ideal = self.tensor_bytes * (n - 1) / n
        elif self.op == "allgather":
            # tensor_bytes is the per-rank shard; each rank forwards N-1
            # shard-sized frames around the ring
            ideal = self.tensor_bytes * (n - 1)
        else:  # allreduce = reduce-scatter + all-gather
            ideal = self.tensor_bytes * 2 * (n - 1) / n
        return ideal / moved if ideal else 1.0


_stats_lock = threading.Lock()
_last_stats: dict = {}

# error-feedback residuals: (group, rank, tag, segment, chunk) -> f32 tensor
_ef_lock = threading.Lock()
_ef_store: dict[tuple, torch.Tensor] = {}


def record_stats(g, st: OpStats) -> None:
    """Keep ``st`` as the group's last op, and as its rank's (the ranks of
    an in-process group share this process)."""
    with _stats_lock:
        _last_stats[g.name] = st
        _last_stats[(g.name, g.rank)] = st


def last_op_stats(group_name: str = "default",
                  rank: int | None = None) -> OpStats | None:
    """The most recent collective's wire accounting in this process for
    the group (of ``rank``, when given)."""
    with _stats_lock:
        return _last_stats.get(group_name if rank is None
                               else (group_name, rank))


def purge_group(group_name: str) -> None:
    """Drop the residuals and stats of a destroyed group."""
    with _ef_lock:
        for k in [k for k in _ef_store if k[0] == group_name]:
            _ef_store.pop(k, None)
    with _stats_lock:
        for k in [k for k in _last_stats
                  if k == group_name or (isinstance(k, tuple)
                                         and k[0] == group_name)]:
            _last_stats.pop(k, None)


def _ef_get(key: tuple):
    with _ef_lock:
        return _ef_store.get(key)


def _ef_put(key: tuple, residual) -> None:
    with _ef_lock:
        if residual is None:
            _ef_store.pop(key, None)
        else:
            _ef_store[key] = residual


# ---------------------------------------------------------------------------
# segment / chunk geometry
# ---------------------------------------------------------------------------


def _split_bounds(n: int, parts: int) -> list[int]:
    """np.array_split boundary offsets: parts of size ceil then floor."""
    base, extra = divmod(n, parts)
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


def _chunk_bounds(lo: int, hi: int, chunk_elems: int) -> list[tuple[int, int]]:
    out = []
    pos = lo
    while pos < hi:
        nxt = min(pos + chunk_elems, hi)
        out.append((pos, nxt))
        pos = nxt
    return out or [(lo, lo)]  # an empty segment still syncs one empty chunk


def _chunk_elems(itemsize: int, chunk_bytes: int | None) -> int:
    return max(1, int(chunk_bytes or compression.CHUNK_BYTES) // max(1, itemsize))


# ---------------------------------------------------------------------------
# core ring phases
# ---------------------------------------------------------------------------


def _ring_reduce_scatter_flat(g, flat: torch.Tensor, bounds: list[int], *,
                              op: str, codec, timeout: float, seq: int,
                              tag: str, ef: bool, chunk_bytes: int | None,
                              st: OpStats, out: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Ring reduce-scatter over a copy of ``flat`` with segment
    ``bounds``. After N-1 steps this rank's segment ``bounds[rank]:
    bounds[rank+1]`` holds the full reduction; the others hold partials.
    Returns the working copy: f32 for a lossy codec's float payload (the
    group's scratch buffer when ``out`` is given), else ``out``, flat,
    when given."""
    n = g.world_size
    rank = g.rank
    right = (rank + 1) % n
    left = (rank - 1) % n
    if not codec.lossless and flat.is_floating_point():
        if out is None:
            work = flat.to(torch.float32, copy=True)
        else:
            work = _scratch(g, flat.numel())
            work.copy_(flat)
    elif out is not None:
        work = out.view(-1)
        if work.data_ptr() != flat.data_ptr():
            work.copy_(flat)
    else:
        work = flat.clone()
    celems = _chunk_elems(work.element_size(), chunk_bytes)
    # error feedback cancels only under additive reduction, and only for
    # a caller-named tensor (ef=True: an explicit ef_tag)
    use_ef = ef and op in ("sum", "mean")

    # rank r sends segment (r - step - 1) and receives (r - step - 2), so
    # the fully reduced segment lands on `rank` itself
    for step in range(n - 1):
        send_seg = (rank - step - 1) % n
        recv_seg = (rank - step - 2) % n
        s_lo, s_hi = bounds[send_seg], bounds[send_seg + 1]
        r_lo, r_hi = bounds[recv_seg], bounds[recv_seg + 1]
        t0 = time.perf_counter()
        g._poll_abort(op=f"{tag}:rs{step}")
        for ci, (lo, hi) in enumerate(_chunk_bounds(s_lo, s_hi, celems)):
            tc = time.perf_counter()
            if use_ef:
                # rank in the key: ranks may share a process
                ef_key = (g.name, g.rank, tag, send_seg, ci)
                frame, residual = compression.encode_with_ef(
                    codec, work[lo:hi], _ef_get(ef_key))
                _ef_put(ef_key, residual)
            else:
                frame = codec.encode(work[lo:hi])
            st.compute_s += time.perf_counter() - tc
            _send_chunk(g, right, seq, f"{tag}:rs{step}:{ci}", frame, st)
        for ci, (lo, hi) in enumerate(_chunk_bounds(r_lo, r_hi, celems)):
            frame = _recv_chunk(g, left, seq, f"{tag}:rs{step}:{ci}",
                                timeout=timeout, op=f"{tag}:rs{step}", st=st)
            tc = time.perf_counter()
            if hi > lo:
                incoming = codec.decode(frame).reshape(-1).to(work.dtype)
                _reduce_into(op, work[lo:hi], incoming)
            st.compute_s += time.perf_counter() - tc
        st.seconds += time.perf_counter() - t0
    return work


def _ring_all_gather_flat(g, work: torch.Tensor, bounds: list[int], *,
                          codec, timeout: float, seq: int, tag: str,
                          chunk_bytes: int | None, st: OpStats) -> torch.Tensor:
    """Ring all-gather of each rank's owned segment into ``work``, in
    place. Each rank encodes its own segment once; later hops forward the
    frames verbatim. A lossy codec also overwrites the owner's copy with
    the decode of its own frame, so every rank ends with the same bits."""
    n = g.world_size
    rank = g.rank
    right = (rank + 1) % n
    left = (rank - 1) % n
    celems = _chunk_elems(work.element_size(), chunk_bytes)

    frames = []
    for clo, chi in _chunk_bounds(bounds[rank], bounds[rank + 1], celems):
        frame = codec.encode(work[clo:chi])
        frames.append(frame)
        if not codec.lossless and chi > clo:
            work[clo:chi] = codec.decode(frame).reshape(-1).to(work.dtype)

    for step in range(n - 1):
        recv_seg = (rank - step - 1) % n
        r_lo, r_hi = bounds[recv_seg], bounds[recv_seg + 1]
        t0 = time.perf_counter()
        g._poll_abort(op=f"{tag}:ag{step}")
        for ci, frame in enumerate(frames):
            _send_chunk(g, right, seq, f"{tag}:ag{step}:{ci}", frame, st)
        frames = []
        for ci, (clo, chi) in enumerate(_chunk_bounds(r_lo, r_hi, celems)):
            frame = _recv_chunk(g, left, seq, f"{tag}:ag{step}:{ci}",
                                timeout=timeout, op=f"{tag}:ag{step}", st=st)
            frames.append(frame)  # forwarded verbatim next step
            tc = time.perf_counter()
            if chi > clo:
                work[clo:chi] = codec.decode(frame).reshape(-1).to(work.dtype)
            st.compute_s += time.perf_counter() - tc
        st.seconds += time.perf_counter() - t0
    return work


# ---------------------------------------------------------------------------
# public ops (collective.py routes to them)
# ---------------------------------------------------------------------------


def _mean(work: torch.Tensor, n: int) -> torch.Tensor:
    """``work / n`` as numpy divides: integers in float64; a float
    working copy in place (the same bits)."""
    if not work.is_floating_point():
        return work.to(torch.float64) / n
    return work.div_(n)


def _restore_dtype(work: torch.Tensor, t: torch.Tensor, op: str) -> torch.Tensor:
    if op == "mean" and not t.is_floating_point():
        return work  # star parity: the mean of integers is float
    return work if work.dtype == t.dtype else work.to(t.dtype)


def _like(out: torch.Tensor, arr):
    """``out`` as the caller's kind: a numpy array for a numpy input."""
    return out.numpy() if isinstance(arr, np.ndarray) else out


def _scratch(g, n: int) -> torch.Tensor:
    """An f32 working buffer of ``n`` elements kept on the group object
    from call to call (a rank runs one op at a time): a bucket's working
    copy costs no fresh pages."""
    buf = getattr(g, "_f32_scratch", None)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32)
        g._f32_scratch = buf
    return buf[:n]


def ring_allreduce(g, arr, *, op: str = "sum", codec=None,
                   timeout: float | None = None,
                   chunk_bytes: int | None = None,
                   ef_tag: str | None = None,
                   out: torch.Tensor | None = None):
    """Reduce-scatter + all-gather; every rank returns the full reduction.
    ``out`` (the port's addition): a contiguous CPU tensor of ``arr``'s
    shape and dtype, ``arr`` itself allowed, that is reduced in place and
    returned, so a lossless payload needs no working copy. The mean of
    integers is float64 (numpy's): it comes back in a tensor of its own,
    and ``out`` is not written."""
    codec = compression.get_codec(codec)
    timeout = compression.TIMEOUT_S if timeout is None else timeout
    t = as_tensor(arr)
    if op == "mean" and not t.is_floating_point():
        out = None
    st = OpStats("allreduce", "ring", codec.name, g.world_size,
                 tensor_bytes=t.numel() * t.element_size())
    if g.world_size == 1:
        record_stats(g, st)
        if out is None:
            return _like(t.clone(), arr)
        if out.data_ptr() != t.data_ptr():
            out.copy_(t)
        return _like(out, arr)
    seq = g._next_seq()
    tag = ef_tag or "ar"
    flat = t.reshape(-1)
    bounds = _split_bounds(flat.numel(), g.world_size)
    work = _ring_reduce_scatter_flat(
        g, flat, bounds, op=op, codec=codec, timeout=timeout, seq=seq,
        tag=tag, ef=ef_tag is not None, chunk_bytes=chunk_bytes, st=st,
        out=out)
    work = _ring_all_gather_flat(
        g, work, bounds, codec=codec, timeout=timeout, seq=seq, tag=tag,
        chunk_bytes=chunk_bytes, st=st)
    if op == "mean":
        work = _mean(work, g.world_size)
    record_stats(g, st)
    if out is not None:
        if work.data_ptr() != out.data_ptr():
            out.view(-1).copy_(work)  # a cast as .to's: the same bits
        return _like(out, arr)
    return _like(_restore_dtype(work, t, op).reshape(t.shape), arr)


def ring_reducescatter(g, arr, *, op: str = "sum", codec=None,
                       timeout: float | None = None,
                       chunk_bytes: int | None = None,
                       ef_tag: str | None = None):
    """Each rank gets only its own reduced axis-0 shard (np.array_split's
    bounds): (N-1)/N of the tensor crosses each link."""
    codec = compression.get_codec(codec)
    timeout = compression.TIMEOUT_S if timeout is None else timeout
    t = as_tensor(arr)
    st = OpStats("reducescatter", "ring", codec.name, g.world_size,
                 tensor_bytes=t.numel() * t.element_size())
    row_elems = int(np.prod(t.shape[1:], dtype=np.int64)) if t.dim() else 1
    row_bounds = _split_bounds(t.shape[0] if t.dim() else 1, g.world_size)
    bounds = [b * row_elems for b in row_bounds]
    shard_shape = (row_bounds[g.rank + 1] - row_bounds[g.rank],) + \
        tuple(t.shape[1:])
    if g.world_size == 1:
        record_stats(g, st)
        return _like(t.clone(), arr)
    seq = g._next_seq()
    tag = ef_tag or "rs"
    work = _ring_reduce_scatter_flat(
        g, t.reshape(-1), bounds, op=op, codec=codec, timeout=timeout,
        seq=seq, tag=tag, ef=ef_tag is not None, chunk_bytes=chunk_bytes,
        st=st)
    out = work[bounds[g.rank]:bounds[g.rank + 1]]
    if op == "mean":
        out = _mean(out, g.world_size)
    record_stats(g, st)
    return _like(_restore_dtype(out, t, op).reshape(shard_shape).clone(), arr)


def ring_allgather(g, arr, *, codec=None, timeout: float | None = None,
                   chunk_bytes: int | None = None) -> list:
    """All-gather of per-rank tensors of one shape (the star path's
    np.stack contract)."""
    codec = compression.get_codec(codec)
    timeout = compression.TIMEOUT_S if timeout is None else timeout
    t = as_tensor(arr)
    st = OpStats("allgather", "ring", codec.name, g.world_size,
                 tensor_bytes=t.numel() * t.element_size())
    if g.world_size == 1:
        record_stats(g, st)
        return [_like(t.clone(), arr)]
    seq = g._next_seq()
    n = g.world_size
    flat = t.reshape(-1)
    seg = flat.numel()
    work = torch.empty(seg * n, dtype=flat.dtype)
    work[g.rank * seg:(g.rank + 1) * seg] = flat
    bounds = [i * seg for i in range(n + 1)]
    work = _ring_all_gather_flat(
        g, work, bounds, codec=codec, timeout=timeout, seq=seq, tag="ag",
        chunk_bytes=chunk_bytes, st=st)
    record_stats(g, st)
    return [_like(work[i * seg:(i + 1) * seg].reshape(t.shape), arr)
            for i in range(n)]

"""Versioned experience buffer: the actor->learner half of the Podracer
loop (arXiv:2104.06272), in the port.

The port's own copy of ray_tpu/rl/experience.py: the class is plain
Python and unchanged; what differs is how it is deployed. JAX makes it a
ray_tpu actor and rollout actors add trajectories as ObjectRefs nested
in the item; here the actor-learner loop spawns it through its runtime
(``serve.runtime``: ``spawn`` with one call at a time, so every method
runs alone, no locks) and the trajectory travels as the runtime's
``put`` of it (a ref, or the tree itself in-process), nested in the item
so the buffer never touches trajectory bytes. The buffer holds every
trajectory until its claim is finalized (:meth:`finalize_through`) or
the staleness window evicts it.

Exactness contract ("no lost or duplicated trajectories"):

- Every accepted trajectory gets a monotonically increasing ``seq`` and
  is delivered FIFO through :meth:`claim`.
- A claim is tagged ``(claimant, iteration, incarnation)``: the gang
  iteration whose parameter update will consume it, and the learner
  incarnation (``session.get_resume_seq()``) making the claim.
- After an elastic resume, rank 0 calls :meth:`rollback` with the
  iteration its restored checkpoint carries. Claims from OLDER
  incarnations split exactly two ways: ``iteration <= restored`` means
  the update that consumed them is INSIDE the checkpoint (they stay
  consumed: re-delivering would double-train them); ``iteration >
  restored`` means their update was lost with the failure (their seqs
  return to the FRONT of the queue in order). Claims by the CURRENT
  incarnation are never touched, so a fast-resuming peer racing
  rollback cannot have its fresh work re-opened.
- Duplicate adds (a rollout actor retrying an ambiguous add) are
  dropped by ``key``.

Staleness: :meth:`set_version` records the latest published weight
version; queued trajectories generated more than ``max_version_lag``
versions ago are evicted (counted in ``dropped_stale``): the bounded
off-policy window the V-trace correction is sized for.
"""

from __future__ import annotations

import collections


class ExperienceBuffer:
    """Deploy through a runtime's ``spawn`` with one call at a time (the
    serial execution is the concurrency control: every method runs
    alone, no locks)."""

    def __init__(self, max_version_lag: int | None = None):
        self.max_version_lag = max_version_lag
        self._queue: collections.deque[int] = collections.deque()
        self._items: dict[int, dict] = {}   # seq -> item (pins the ref)
        self._seen_keys: dict = {}          # dedup key -> seq
        self._claims: dict[str, dict] = {}  # open or consumed claims
        self._next_seq = 0
        self._next_claim = 0
        self._version = 0
        self._added = 0
        self._dups = 0
        self._dropped_stale = 0   # accepted, then evicted by staleness
        self._rejected_stale = 0  # refused at add (never counted added)
        self._reopened = 0
        self._unrecoverable = 0   # wanted back after finalize freed them

    # ---------- producer side ----------

    def add(self, item: dict) -> dict:
        """``item``: {"key": hashable dedup id, "version": generating
        weight version, "traj": payload — normally a dict with a nested
        runtime ref}. Returns {"seq", "accepted"}."""
        key = item.get("key")
        if key is not None:
            key = tuple(key) if isinstance(key, list) else key
            if key in self._seen_keys:
                self._dups += 1
                return {"seq": self._seen_keys[key], "accepted": False}
        version = int(item.get("version") or 0)
        if self._stale(version):
            self._rejected_stale += 1
            return {"seq": -1, "accepted": False}
        seq = self._next_seq
        self._next_seq += 1
        self._items[seq] = {"seq": seq, "version": version,
                            "traj": item.get("traj"), "key": key}
        if key is not None:
            self._seen_keys[key] = seq
        self._queue.append(seq)
        self._added += 1
        return {"seq": seq, "accepted": True}

    def _stale(self, version: int) -> bool:
        return (self.max_version_lag is not None
                and version < self._version - self.max_version_lag)

    def set_version(self, version: int) -> dict:
        """Record the newest published weight version and evict queued
        trajectories outside the staleness window."""
        self._version = max(self._version, int(version))
        dropped = 0
        if self.max_version_lag is not None:
            keep = collections.deque()
            for seq in self._queue:
                it = self._items[seq]
                if self._stale(it["version"]):
                    self._evict(seq)
                    dropped += 1
                else:
                    keep.append(seq)
            self._queue = keep
        self._dropped_stale += dropped
        return {"version": self._version, "dropped": dropped}

    def _evict(self, seq: int) -> None:
        it = self._items.pop(seq, None)
        if it is not None and it.get("key") is not None:
            self._seen_keys.pop(it["key"], None)

    # ---------- learner side ----------

    def claim(self, claimant: str, n: int, iteration: int,
              incarnation: int = 0) -> dict:
        """Pop up to ``n`` queued trajectories FIFO for ``claimant``'s
        update at ``iteration``. Returns {"claim_id", "entries": [...]}
        — entries carry seq/version/traj (the nested ref resolves
        learner-side through the runtime's ``get``). An empty poll
        returns no claim_id."""
        seqs = []
        while self._queue and len(seqs) < int(n):
            seqs.append(self._queue.popleft())
        if not seqs:
            return {"claim_id": None, "entries": []}
        self._next_claim += 1
        cid = f"c{self._next_claim}"
        self._claims[cid] = {"claimant": str(claimant),
                             "iteration": int(iteration),
                             "incarnation": int(incarnation),
                             "seqs": seqs}
        return {"claim_id": cid,
                "entries": [dict(self._items[s]) for s in seqs]}

    def rollback(self, restored_iteration: int,
                 incarnation: int) -> dict:
        """Resume-time exactness sweep (rank 0, once per incarnation):
        claims from incarnations OLDER than ``incarnation`` whose
        iteration is PAST the restored checkpoint re-enter the queue
        front in seq order; the rest are final. A claim already freed
        by :meth:`finalize_through` cannot be re-delivered — counted in
        ``unrecoverable`` (only reachable when the checkpoint chain
        falls back further than the finalize horizon)."""
        reopened: list[int] = []
        unrecoverable = 0
        for cid, c in list(self._claims.items()):
            if c["incarnation"] >= int(incarnation):
                continue
            if c["iteration"] > int(restored_iteration):
                if c.get("finalized"):
                    unrecoverable += len(c["seqs"])
                    continue
                reopened.extend(c["seqs"])
                del self._claims[cid]
        for seq in sorted(reopened, reverse=True):
            if seq in self._items:  # still pinned — re-deliverable
                self._queue.appendleft(seq)
        self._reopened += len(reopened)
        self._unrecoverable += unrecoverable
        return {"reopened": len(reopened),
                "unrecoverable": unrecoverable}

    def finalize_through(self, iteration: int) -> dict:
        """Release the payloads of claims whose update is durably past
        the resume horizon (the caller keeps ``iteration`` a couple of
        checkpoints behind the newest, so a corrupt-checkpoint fallback
        never needs them back). Frees the pinned trajectory refs and
        the dedup keys; the claim record (seq ints) stays for the
        conservation accounting."""
        freed = 0
        for c in self._claims.values():
            if c.get("finalized") or c["iteration"] > int(iteration):
                continue
            for seq in c["seqs"]:
                self._evict(seq)
                freed += 1
            c["finalized"] = True
        return {"freed": freed}

    # ---------- introspection ----------

    def size(self) -> int:
        return len(self._queue)

    def version(self) -> int:
        return self._version

    def stats(self) -> dict:
        """Conservation invariant (asserted by the chaos tests):
        ``added == queued + consumed + dropped_stale`` with every
        consumed seq appearing in exactly one claim."""
        consumed = sorted(
            s for c in self._claims.values() for s in c["seqs"])
        return {
            "added": self._added,
            "dups": self._dups,
            "dropped_stale": self._dropped_stale,
            "rejected_stale": self._rejected_stale,
            "queued": len(self._queue),
            "consumed": len(consumed),
            "consumed_seqs": consumed,
            "reopened": self._reopened,
            "unrecoverable": self._unrecoverable,
            "claims": len(self._claims),
            "pinned": len(self._items),
            "version": self._version,
        }

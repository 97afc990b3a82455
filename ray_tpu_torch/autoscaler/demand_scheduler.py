"""A serving pool's desired decode-replica count.

The port's copy of ``serve_replica_demand`` from
ray_tpu/autoscaler/demand_scheduler.py: it turns an LLM pool's pressure
signals (admission-queue depth, in-flight load, TTFT p99 against its
target) into the replica count the pool's autoscale loop reconciles to.
"""

from __future__ import annotations

import math


def serve_replica_demand(
    *,
    queue_depth: int,
    inflight: int,
    n_replicas: int,
    min_replicas: int,
    max_replicas: int,
    target_queue_per_replica: float = 4.0,
    ttft_p99_s: float | None = None,
    target_ttft_s: float | None = None,
    slo_headroom: float = 0.5,
) -> int:
    """Desired decode-replica count for a serving pool.

    Two pressure signals, the stronger wins:

    - **load**: ceil((queue_depth + inflight) / target_queue_per_replica);
    - **SLO**: an observed TTFT p99 above `target_ttft_s` asks for one
      replica MORE than current even when raw load says otherwise
      (queue depth undercounts when requests are long, TTFT does not).

    Scale-DOWN is hysteretic: only when load supports fewer replicas AND
    the TTFT p99 sits under `slo_headroom * target_ttft_s` (or no SLO is
    set). The result is clamped to [min_replicas, max_replicas].
    """
    min_replicas = max(1, min_replicas)
    max_replicas = max(min_replicas, max_replicas)
    load = max(0, queue_depth) + max(0, inflight)
    desired = math.ceil(load / max(target_queue_per_replica, 1e-9))
    slo_breached = (target_ttft_s is not None and ttft_p99_s is not None
                    and ttft_p99_s > target_ttft_s)
    if slo_breached:
        desired = max(desired, n_replicas + 1)
    if desired < n_replicas:
        slo_near = (target_ttft_s is not None and ttft_p99_s is not None
                    and ttft_p99_s > slo_headroom * target_ttft_s)
        if slo_near:
            desired = n_replicas  # hold: shrinking would risk the SLO
    return max(min_replicas, min(max_replicas, desired))

"""Model multiplexing: an LRU of resident models keyed by model id.

The port's copy of ``multiplexed`` from ray_tpu/serve/multiplex.py. The
serving pool wraps its "make this model resident" callable with it: at
most ``max_num_models_per_replica`` models stay resident, and loading
one more evicts the least recently used. The model id is the wrapped
call's last positional argument (the pool always passes it); the
runtime's request-scoped id reaches the pool through
``serve.hooks.Hooks.model_id`` instead.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a model-load callable whose last positional argument
    is the model id: the result is cached per id, LRU-bounded."""

    def deco(load_fn: Callable):
        cache: OrderedDict = OrderedDict()
        lock = threading.Lock()

        def wrapper(*args):
            mid = args[-1]
            with lock:
                if mid in cache:
                    cache.move_to_end(mid)
                    return cache[mid]
            model = load_fn(*args)
            with lock:
                cache[mid] = model
                cache.move_to_end(mid)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
            return model

        wrapper.__wrapped__ = load_fn
        wrapper._cache = cache  # resident ids, least recent first
        return wrapper

    return deco

"""Connector pipelines: composable obs/action transforms shared by all
algorithms.

Reference: rllib/connectors/connector.py:1 (Connector / ConnectorPipeline)
+ connectors/env_to_module/ (observation preprocessing) and
module_to_env/ (action postprocessing). Redesigned small: a connector is
a stateful callable over numpy arrays running HOST-side in the sampling
actors (the jitted policy stays pure); pipelines compose them and carry
state_dict()/load_state_dict() so runner-side statistics survive
checkpoints and can be merged by the algorithms.

The port's own copy of ray_tpu/rl/connectors.py. Only the factory
shipping differs: JAX serializes a pipeline factory with the runtime's
cloudpickle (``ray_tpu._private.serialization``), which the port does
not have. Here a factory goes to in-process runners as the object
itself, and :func:`pack_factory` makes a ``pickle`` blob where one is
needed (a factory importable by name).
"""

from __future__ import annotations

import pickle

import numpy as np


class Connector:
    """One transform. __call__ maps an array to an array; stateful
    connectors (e.g. running normalizers) update on every call unless
    frozen."""

    frozen = False

    def __call__(self, x: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def reset(self):
        """Episode boundary (frame stacks clear; normalizers persist)."""

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict):
        pass


class ObsNormalizer(Connector):
    """Running mean/variance observation normalization (Welford update),
    the env_to_module MeanStdFilter analog. Normalizes with CURRENT
    stats, then folds the raw obs in — identical order to the
    reference's filter so early-training behavior matches."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self.count = 0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.zeros_like(x)
        if self.count > 1:
            std = np.sqrt(self.m2 / (self.count - 1) + self.eps)
            out = np.clip((x - self.mean) / std, -self.clip, self.clip)
        else:
            out = x
        if not self.frozen:
            self.count += 1
            delta = x - self.mean
            self.mean = self.mean + delta / self.count
            self.m2 = self.m2 + delta * (x - self.mean)
        return out.astype(np.float32)

    def state_dict(self) -> dict:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def load_state_dict(self, state: dict):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class FrameStack(Connector):
    """Concatenate the last k observations along the feature axis
    (env_to_module FrameStacking analog). Before k frames exist, the
    oldest is repeated — output shape is constant from the first call."""

    def __init__(self, k: int = 4):
        assert k >= 1
        self.k = k
        self.frames: list[np.ndarray] = []

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if not self.frames:
            self.frames = [x] * self.k
        else:
            self.frames = self.frames[1:] + [x]
        return np.concatenate(self.frames, axis=-1)

    def reset(self):
        self.frames = []

    def state_dict(self) -> dict:
        return {"frames": list(self.frames)}

    def load_state_dict(self, state: dict):
        self.frames = list(state["frames"])


class ClipAction(Connector):
    """module_to_env clip: keep sampled continuous actions inside the
    env's bounds (a squashed policy stays inside on its own; the clip
    protects the env against numeric spill)."""

    def __init__(self, low: float, high: float):
        self.low = low
        self.high = high

    def __call__(self, a: np.ndarray) -> np.ndarray:
        return np.clip(a, self.low, self.high)


def pack_factory(factory) -> bytes | None:
    """Serialize a pipeline factory for shipping to sampling actors
    (None passes through): a ``pickle`` blob, so the factory must be
    importable by name where it is unpacked."""
    if factory is None:
        return None
    return pickle.dumps(factory)


def pipeline_from_blob(blob) -> "Connector":
    """Actor-side counterpart: materialize the pipeline from a factory
    object or a :func:`pack_factory` blob (identity when the algorithm
    configured none)."""
    if blob is None:
        return Pipeline()
    factory = pickle.loads(blob) if isinstance(blob, bytes) else blob
    return factory()


class Pipeline(Connector):
    """Ordered connector composition (ConnectorPipeline analog)."""

    def __init__(self, *connectors: Connector):
        self.connectors = list(connectors)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            x = c(x)
        return x

    def reset(self):
        for c in self.connectors:
            c.reset()

    def state_dict(self) -> dict:
        return {str(i): c.state_dict()
                for i, c in enumerate(self.connectors)}

    def load_state_dict(self, state: dict):
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.load_state_dict(state[str(i)])

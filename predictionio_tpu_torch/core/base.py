"""DASE component protocols and the engine context.

The same four stages as the JAX package (controller/Engine.scala:82):

  DataSource.read_training(ctx) -> TD
  Preparator.prepare(ctx, td) -> PD
  Algorithm.train(ctx, pd) -> M ; .predict(m, q) -> P
  Serving.supplement(q) / .serve(q, [P]) -> P

Where the JAX context carries a device mesh and a PRNG key, this one carries
a ``torch.device`` and hands out seeded ``torch.Generator``s.  There is no
mesh: the port serves on one device.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Generic, Sequence, TypeVar

import torch

from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.device import resolve_device

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
PD = TypeVar("PD")  # prepared data
Q = TypeVar("Q")  # query
PR = TypeVar("PR")  # predicted result
A = TypeVar("A")  # actual result
M = TypeVar("M")  # model

#: Algorithm flavors, named for parity with the reference's
#: PAlgorithm/P2LAlgorithm/LAlgorithm.
P, P2L, L = "P", "P2L", "L"  # noqa: E741


class SanityCheckError(AssertionError):
    """A data stage failed its sanity check (controller/SanityCheck.scala:27)."""


@dataclass
class EngineContext:
    """Storage runtime, device, base seed and mode, passed to every DASE
    stage.  ``device=None`` means CUDA and raises on a host without a card;
    pass ``device="cpu"`` to run on the CPU."""

    storage: StorageRuntime | None = None
    seed: int = 0
    mode: str = "train"  # train | eval | serving | batchpredict
    device: torch.device | str | None = field(default=None)
    #: previous generation's persisted per-algorithm models (set by
    #: ``run_train(warm_start_from=...)``); algorithms that understand the
    #: shape seed their init from it, everything else trains cold
    warm_start: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def storage_runtime(self) -> StorageRuntime:
        return self.storage or get_storage()

    @property
    def p_event_store(self) -> PEventStore:
        return PEventStore(self.storage_runtime)

    @property
    def l_event_store(self) -> LEventStore:
        return LEventStore(self.storage_runtime)

    def generator(self, salt: int = 0) -> torch.Generator:
        """A generator on ``device`` seeded from ``seed`` and ``salt``, with
        the JAX context's seed mixing (``core/base.py`` ``rng``)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 0x9E3779B1 + salt) & 0xFFFFFFFF)
        return g


def run_sanity_check(obj: Any) -> None:
    """Invoke obj.sanity_check() when present (train pipeline hook)."""
    check = getattr(obj, "sanity_check", None)
    if callable(check):
        check()


class DataSource(abc.ABC, Generic[TD, EI, Q, A]):
    """Reads training and evaluation data (core/BaseDataSource.scala:34)."""

    @abc.abstractmethod
    def read_training(self, ctx: EngineContext) -> TD: ...

    def read_eval(
        self, ctx: EngineContext
    ) -> list[tuple[TD, EI, list[tuple[Q, A]]]]:
        """Per-fold (trainingData, evalInfo, [(query, actual)]) sets."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unavailable for this engine"
        )


class Preparator(abc.ABC, Generic[TD, PD]):
    """Transforms training data for the algorithms (core/BasePreparator.scala:33)."""

    @abc.abstractmethod
    def prepare(self, ctx: EngineContext, td: TD) -> PD: ...


class IdentityPreparator(Preparator):
    """Pass-through (controller/IdentityPreparator.scala:32)."""

    def __init__(self, params: Any = None):
        pass

    def prepare(self, ctx: EngineContext, td):
        return td


class Algorithm(abc.ABC, Generic[PD, M, Q, PR]):
    """Train a model and answer queries (core/BaseAlgorithm.scala:58)."""

    flavor: str = P2L

    @abc.abstractmethod
    def train(self, ctx: EngineContext, pd: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> PR: ...

    def batch_predict(
        self, model: M, queries: Sequence[tuple[int, Q]]
    ) -> list[tuple[int, PR]]:
        """Bulk predict: [(index, query)] -> [(index, prediction)]."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def make_persistent_model(self, ctx: EngineContext, model: M) -> Any:
        """Convert the trained model into its checkpointable form."""
        return model

    def load_persistent_model(self, ctx: EngineContext, data: Any) -> M:
        """Inverse of make_persistent_model at deploy time."""
        return data


class Serving(abc.ABC, Generic[Q, PR]):
    """Combine per-algorithm predictions into one result (core/BaseServing.scala)."""

    def supplement(self, query: Q) -> Q:
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[PR]) -> PR: ...


class FirstServing(Serving):
    """Serve the first algorithm's prediction (controller/LFirstServing.scala:28)."""

    def __init__(self, params: Any = None):
        pass

    def serve(self, query, predictions):
        return predictions[0]

"""Reusable algorithms: categorical Naive Bayes, Markov chain, vectorizer.

The port of the JAX package's ``e2/engine.py`` (the e2 library,
e2/src/main/scala/org/apache/predictionio/e2/):

  - CategoricalNaiveBayes (engine/CategoricalNaiveBayes.scala:23): string
    features, per-label per-position value likelihoods; the count collapse
    is one integer ``bincount`` over vocab-mapped (label, value) ids on the
    device, exact and the same on every run.
  - MarkovChain (engine/MarkovChain.scala:25): top-N row-normalized
    transition model; prediction is a sparse row·matrix product, summed
    per target state by a stable sort and a segmented sum (no float
    atomics, so the same bits every run).
  - BinaryVectorizer (engine/BinaryVectorizer.scala:28): (property, value)
    one-hot encoder producing dense float32 arrays.

``train`` takes ``device=None``, meaning CUDA (raises without a card
unless ``device="cpu"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class LabeledPoint:
    """A string-labeled point with categorical string features
    (e2/engine/LabeledPoint analog)."""

    label: str
    features: tuple[str, ...]


@dataclass
class CategoricalNaiveBayesModel:
    """priors: log P(label); likelihoods[label][position][value] = log P."""

    priors: dict[str, float]
    likelihoods: dict[str, list[dict[str, float]]]

    @property
    def feature_count(self) -> int:
        return len(next(iter(self.likelihoods.values())))

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood=lambda values: float("-inf"),
    ) -> float | None:
        """Log joint score of (features, label); None for unknown labels.
        Unseen feature values fall back to ``default_likelihood`` over the
        seen values' likelihoods (CategoricalNaiveBayes.scala logScore)."""
        if point.label not in self.priors:
            return None
        prior = self.priors[point.label]
        per_position = self.likelihoods[point.label]
        total = prior
        for value, table in zip(point.features, per_position):
            total += table.get(value, default_likelihood(list(table.values())))
        return total

    def predict(self, features: Sequence[str]) -> str:
        """Highest-scoring label; ties/-inf resolve to the first label (a
        label is always returned, like the reference's maxBy)."""
        best_label, best_score = None, float("-inf")
        for label in sorted(self.priors):
            s = self.log_score(LabeledPoint(label, tuple(features)))
            if s is not None and (best_label is None or s > best_score):
                best_label, best_score = label, s
        return best_label


class CategoricalNaiveBayes:
    @staticmethod
    def train(
        points: Sequence[LabeledPoint], device=None
    ) -> CategoricalNaiveBayesModel:
        """One count per (label, position, value) triple.

        Features and labels are vocab-mapped to ints, the counts are one
        integer ``bincount`` per position on ``device``, and the log tables
        come back to host dicts (they are small: labels x positions x
        seen-values)."""
        device = resolve_device(device)
        if not points:
            raise ValueError("cannot train on an empty dataset")
        n_pos = len(points[0].features)
        labels = sorted({p.label for p in points})
        label_idx = {l: i for i, l in enumerate(labels)}
        value_vocabs: list[dict[str, int]] = []
        for pos in range(n_pos):
            vals = sorted({p.features[pos] for p in points})
            value_vocabs.append({v: i for i, v in enumerate(vals)})

        label_counts = np.zeros(len(labels), np.int64)
        for p in points:
            label_counts[label_idx[p.label]] += 1

        likelihoods: dict[str, list[dict[str, float]]] = {
            l: [] for l in labels
        }
        for pos in range(n_pos):
            vocab = value_vocabs[pos]
            flat = np.fromiter(
                (
                    label_idx[p.label] * len(vocab) + vocab[p.features[pos]]
                    for p in points
                ),
                np.int64,
                len(points),
            )
            counts = (
                torch.bincount(
                    torch.from_numpy(flat).to(device),
                    minlength=len(labels) * len(vocab),
                )
                .cpu()
                .numpy()
                .astype(np.float32)
                .reshape(len(labels), len(vocab))
            )
            for l, li in label_idx.items():
                table = {
                    v: math.log(counts[li, vi] / label_counts[li])
                    for v, vi in vocab.items()
                    if counts[li, vi] > 0
                }
                likelihoods[l].append(table)

        total = label_counts.sum()
        priors = {
            l: math.log(label_counts[li] / total) for l, li in label_idx.items()
        }
        return CategoricalNaiveBayesModel(priors=priors, likelihoods=likelihoods)


@dataclass
class MarkovChainModel:
    """Row-sparse top-N transition probabilities as dense tensors.

    ``indices[s]``/``probs[s]`` hold state s's top-N next states (padded with
    -1 / 0.0), on the device the chain was trained on.
    """

    indices: Any  # [n_states, top_n] int32
    probs: Any  # [n_states, top_n] float32
    top_n: int

    def predict(self, current_state: Sequence[float]) -> list[float]:
        """Next-state distribution: current · P.  The ``-1`` padding sums
        into an extra bucket ``n_states``, sliced off at the end."""
        probs = torch.as_tensor(self.probs)
        indices = torch.as_tensor(self.indices, device=probs.device)
        cur = torch.as_tensor(
            current_state, dtype=torch.float32, device=probs.device
        )
        n_states = len(current_state)
        weighted = (probs * cur[:, None]).reshape(-1)
        flat_idx = torch.where(
            indices >= 0, indices, n_states
        ).reshape(-1).to(torch.int64)
        order = torch.argsort(flat_idx, stable=True)
        lengths = torch.bincount(flat_idx, minlength=n_states + 1)
        out = torch.segment_reduce(weighted[order], "sum", lengths=lengths)
        return list(out[:n_states].cpu().numpy().astype(np.float64))


class MarkovChain:
    @staticmethod
    def train(
        rows: np.ndarray,
        cols: np.ndarray,
        counts: np.ndarray,
        n_states: int,
        top_n: int,
        device=None,
    ) -> MarkovChainModel:
        """Build the top-N row-normalized transition model from COO counts
        (MarkovChain.scala:32: groupByKey -> normalize -> take topN)."""
        device = resolve_device(device)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        counts = np.asarray(counts, np.float64)
        indices = np.full((n_states, top_n), -1, np.int32)
        probs = np.zeros((n_states, top_n), np.float32)
        order = np.lexsort((cols, rows))
        rows_s, cols_s, counts_s = rows[order], cols[order], counts[order]
        start = 0
        while start < len(rows_s):
            end = start
            while end < len(rows_s) and rows_s[end] == rows_s[start]:
                end += 1
            r = int(rows_s[start])
            total = counts_s[start:end].sum()
            top = np.argsort(-counts_s[start:end], kind="stable")[:top_n]
            # reference sorts the kept entries by column index
            kept = sorted(top, key=lambda t: cols_s[start + t])
            for slot, t in enumerate(kept):
                indices[r, slot] = cols_s[start + t]
                probs[r, slot] = counts_s[start + t] / total
            start = end
        return MarkovChainModel(
            indices=torch.from_numpy(indices).to(device),
            probs=torch.from_numpy(probs).to(device),
            top_n=top_n,
        )


class BinaryVectorizer:
    """(property, value) -> one-hot index encoder
    (e2/engine/BinaryVectorizer.scala:28)."""

    def __init__(self, property_map: Mapping[tuple[str, str], int]):
        self.property_map = dict(property_map)
        self.num_features = len(self.property_map)

    @classmethod
    def fit(
        cls,
        maps: Iterable[Mapping[str, str]],
        properties: set[str],
    ) -> "BinaryVectorizer":
        """Index every distinct (property, value) pair seen, filtered to
        ``properties`` (BinaryVectorizer.apply)."""
        seen: dict[tuple[str, str], int] = {}
        for m in maps:
            for k, v in m.items():
                if k in properties and (k, v) not in seen:
                    seen[(k, v)] = len(seen)
        return cls(seen)

    @classmethod
    def from_pairs(cls, pairs: Sequence[tuple[str, str]]) -> "BinaryVectorizer":
        return cls({p: i for i, p in enumerate(pairs)})

    def to_binary(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        vec = np.zeros(self.num_features, np.float32)
        for p in pairs:
            idx = self.property_map.get(p)
            if idx is not None:
                vec[idx] = 1.0
        return vec

    def transform(
        self, maps: Sequence[Mapping[str, str]]
    ) -> np.ndarray:
        """Batch encode into a dense [n, num_features] float32 array."""
        out = np.zeros((len(maps), self.num_features), np.float32)
        for i, m in enumerate(maps):
            for k, v in m.items():
                idx = self.property_map.get((k, v))
                if idx is not None:
                    out[i, idx] = 1.0
        return out

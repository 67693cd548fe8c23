"""Ridge regression on log10-time — closed-form numpy solve, JSON on disk.

The model is deliberately tiny: eight analytic features, one linear
solve, no iterative fitting, no new dependencies. What it buys the census
is not accuracy on exotic workloads but *calibrated confidence*: the
training residual sigma is exactly the per-algorithm spread the features
cannot see (machine efficiency factors, cache effects), and that sigma is
what :mod:`repro_torch.predict.active` turns into rank-flip probabilities.

Serialization contract: the JSON payload embeds the feature schema
(:data:`~repro_torch.predict.features.FEATURE_NAMES` + version), the machine
label it was trained against, a SHA-256 digest of the training keys, and
a CRC of the payload itself. :meth:`RidgeModel.load` re-derives all of
them and raises :class:`ModelDrift` on any mismatch — a stale or
tampered model fails loudly instead of silently mis-gating a census.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .features import FEATURE_NAMES, FEATURE_VERSION, census_machine, training_rows

#: residual sigma floor (log10 units): a perfectly-fit training set must
#: not produce zero flip probabilities everywhere
MIN_SIGMA = 1e-6


class ModelDrift(RuntimeError):
    """A serialized model does not match this code's feature extraction
    (schema/version), its own integrity checksum, or the census it is
    being applied to. Retrain instead of predicting garbage."""


def train_set_digest(keys: Sequence[Tuple[str, str]]) -> str:
    """SHA-256 over the sorted ``uid|alg`` training keys — identifies WHAT
    the model was fitted on, independent of row order."""
    h = hashlib.sha256()
    for uid, alg in sorted(keys):
        h.update(f"{uid}|{alg}\n".encode("utf-8"))
    return h.hexdigest()


def fit_ridge(
    X: Sequence[Sequence[float]],
    y: Sequence[float],
    alpha: float = 1e-3,
) -> Tuple[List[float], float, float]:
    """Closed-form ridge: center features and target, solve the
    regularized normal equations, return ``(coef, intercept,
    residual_sigma)``. The intercept is unpenalized (centering does that
    for free); ``residual_sigma`` is the RMS training residual in log10
    units, floored at :data:`MIN_SIGMA`."""
    Xa = np.asarray(X, dtype=float)
    ya = np.asarray(y, dtype=float)
    if Xa.ndim != 2 or len(Xa) != len(ya) or len(Xa) == 0:
        raise ValueError("fit_ridge needs a non-empty (n, d) X and matching y")
    x_mean = Xa.mean(axis=0)
    y_mean = float(ya.mean())
    Xc = Xa - x_mean
    yc = ya - y_mean
    d = Xa.shape[1]
    coef = np.linalg.solve(
        Xc.T @ Xc + float(alpha) * np.eye(d), Xc.T @ yc
    )
    intercept = y_mean - float(x_mean @ coef)
    resid = ya - (Xa @ coef + intercept)
    sigma = max(float(np.sqrt(np.mean(resid ** 2))), MIN_SIGMA)
    return [float(c) for c in coef], float(intercept), sigma


@dataclass
class RidgeModel:
    """A trained predictor plus everything needed to refuse a bad load."""

    coef: List[float]
    intercept: float
    residual_sigma: float
    alpha: float
    n_train: int
    machine: str                                   #: machine label trained against
    train_digest: str = ""                         #: train_set_digest(keys)
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    feature_version: int = FEATURE_VERSION
    n_skipped: int = 0                             #: wall-clock rows dropped at train time

    def __post_init__(self) -> None:
        self.feature_names = tuple(self.feature_names)
        if len(self.coef) != len(self.feature_names):
            raise ModelDrift(
                f"coefficient count {len(self.coef)} != feature count "
                f"{len(self.feature_names)}"
            )

    # ------------------------------------------------------- prediction ---

    def predict_one(self, vec: Sequence[float]) -> float:
        """Predicted log10 seconds for one feature vector."""
        if len(vec) != len(self.coef):
            raise ModelDrift(
                f"feature vector length {len(vec)} != model width "
                f"{len(self.coef)}"
            )
        return self.intercept + float(
            sum(c * float(v) for c, v in zip(self.coef, vec))
        )

    def predict_times(self, vecs: Mapping[str, Sequence[float]]) -> Dict[str, float]:
        """Predicted seconds per algorithm (de-logged)."""
        return {
            alg: 10.0 ** self.predict_one(vec)
            for alg, vec in sorted(vecs.items())
        }

    # ----------------------------------------------------- serialization ---

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["feature_names"] = list(self.feature_names)
        d["version"] = 1
        body = json.dumps(d, sort_keys=True, separators=(",", ":"))
        d["_crc"] = format(zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF, "08x")
        return d

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RidgeModel":
        body = {k: v for k, v in d.items() if k not in ("_crc",)}
        crc = format(
            zlib.crc32(
                json.dumps(body, sort_keys=True, separators=(",", ":"))
                .encode("utf-8")
            ) & 0xFFFFFFFF,
            "08x",
        )
        if d.get("_crc") != crc:
            raise ModelDrift(
                "model payload fails its own checksum — the file was "
                "edited or corrupted; retrain"
            )
        if int(d.get("feature_version", -1)) != FEATURE_VERSION:
            raise ModelDrift(
                f"model feature_version {d.get('feature_version')} != "
                f"this code's {FEATURE_VERSION}; retrain"
            )
        if tuple(d.get("feature_names", ())) != FEATURE_NAMES:
            raise ModelDrift(
                "model feature schema does not match this code's "
                f"FEATURE_NAMES; retrain ({d.get('feature_names')})"
            )
        kwargs = {
            f.name: d[f.name]
            for f in dataclasses.fields(cls)
            if f.name in d
        }
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str) -> "RidgeModel":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def train_model(
    spec: Any,
    records: Sequence[Mapping[str, Any]],
    machine: str = "",
    alpha: float = 1e-3,
) -> RidgeModel:
    """Fit a :class:`RidgeModel` from a merged census: features + targets
    via :func:`repro_torch.predict.features.training_rows`, machine label via
    the serving oracle's resolution rule."""
    name, _ = census_machine(spec, machine)
    X, y, keys, n_skipped = training_rows(spec, records, machine)
    if not X:
        raise ValueError(
            "no trainable rows: the census holds only wall-clock records "
            "(no stored per-algorithm times) — train from a "
            "cost_model/simulated census"
        )
    coef, intercept, sigma = fit_ridge(X, y, alpha)
    return RidgeModel(
        coef=coef,
        intercept=intercept,
        residual_sigma=sigma,
        alpha=float(alpha),
        n_train=len(X),
        machine=name,
        train_digest=train_set_digest(keys),
        n_skipped=n_skipped,
    )

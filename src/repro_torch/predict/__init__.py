"""Learned cost model: predict per-algorithm times and ranks from the
census's own analytic metadata, so the census can go *active* — measure
only the instances whose predicted ranking is uncertain.

Every census record carries exact FLOPs, per-kernel shapes/bytes
(:mod:`repro_torch.explain.decompose`), roofline terms
(:mod:`repro_torch.roofline.terms`), and — on the deterministic backends — a
reconstructible measured outcome. That is a complete training set:

* :mod:`repro_torch.predict.features` — feature vectors per
  (instance, algorithm) and training rows from merged census stores.
* :mod:`repro_torch.predict.model` — ridge regression on log10-time with a
  closed-form numpy solve; JSON serialization carries the feature schema
  and a train-set digest so a drifted load fails loudly.
* :mod:`repro_torch.predict.active` — per-instance rank prediction with a
  flip-probability estimate, the ``predicted``-provenance census records
  for confidently predicted instances, and the campaign gate
  ``census_gate`` that :func:`repro_torch.core.sweep.run_shard` consults when
  ``SweepSpec.predictor_model`` is set.

A copy of the reference's ``repro.predict``: host code on numpy that
touches no device, so a model file, a feature vector and a predicted
census record are the reference's byte for byte.
"""

from .active import ActivePredictor, PredictedRanking, census_gate, prediction_errors
from .features import (
    FEATURE_NAMES,
    FEATURE_VERSION,
    census_machine,
    instance_features,
    kernel_features,
    record_features,
    training_rows,
)
from .model import ModelDrift, RidgeModel, fit_ridge, train_model

__all__ = [
    "FEATURE_NAMES", "FEATURE_VERSION", "kernel_features",
    "instance_features", "record_features", "training_rows",
    "census_machine", "ModelDrift", "RidgeModel", "fit_ridge",
    "train_model", "ActivePredictor", "PredictedRanking", "census_gate",
    "prediction_errors",
]

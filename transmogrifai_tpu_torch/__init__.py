"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

It grows beside the JAX package, slice by slice, and imports neither JAX,
pandas nor any module of ``transmogrifai_tpu``.  It trains and serves:

- ``OpWorkflow().set_result_features(pred).set_input_dataset(cols)
  .train(device=None)`` fits a workflow (the vectorizer, bucketizer and
  sanity-checker fits, the boosted model selector's cross-validated sweep,
  the refit of the winner) and ``OpWorkflowModel.save`` writes it in the
  JAX package's format;
- ``load_model(path, device=None)`` loads a model either package saved, and
  ``OpWorkflowModel.score``, ``BatchScoreFunction`` and ``ScoreFunction``
  score it.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); there is no silent fallback.  The device programs of the
path are hand-written kernels (``ops/trees.py``, ``ops/vectorize.py``).
"""
from . import dsl, types
from .columns import Column, Dataset, NumericColumn, ObjectColumn, PredictionColumn, VectorColumn
from .features.builder import FeatureBuilder
from .features.feature import Feature
from .local.scoring import (BatchScoreFunction, ScoreFunction, batch_score_function,
                            load_model_local, score_function)
from .utils.device import resolve_device
from .workflow.model import OpWorkflowModel, load_model
from .workflow.workflow import OpWorkflow

__all__ = [n for n in dir() if not n.startswith("_")]

"""local — per-record and batched scoring of a loaded model
(reference local/ module, OpWorkflowModelLocal.scala:42-80)."""
from .scoring import (BatchScoreFunction, ScoreFunction, batch_score_function,
                      load_model_local, score_function)

__all__ = ["BatchScoreFunction", "ScoreFunction", "batch_score_function",
           "load_model_local", "score_function"]

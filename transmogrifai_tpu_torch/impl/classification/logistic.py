"""OpLogisticRegression on the scoring path.

The prediction half of ``transmogrifai_tpu/impl/classification/logistic.py``
(reference: OpLogisticRegression.scala): a float32 product on the device
(``ops/linear.py``).  The solvers are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ...ops import linear as L
from ..selector.predictor import PredictorEstimator


class OpLogisticRegression(PredictorEstimator):
    is_classifier = True

    @classmethod
    def device_params(cls, params: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
        return {"coef": torch.tensor(np.asarray(params["coef"], np.float32), device=device),
                "intercept": torch.tensor(np.asarray(params["intercept"], np.float32),
                                          device=device),
                "multinomial": bool(params.get("multinomial"))}

    @classmethod
    def predict_tensors(cls, dparams: Dict[str, Any], X: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        predict = L.predict_softmax if dparams["multinomial"] else L.predict_binary_logistic
        raw, prob, pred = predict(X, dparams["coef"], dparams["intercept"])
        return pred.cpu().numpy(), raw.cpu().numpy(), prob.cpu().numpy()

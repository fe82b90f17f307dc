"""Multiclass softmax objectives (the JAX package's
``objective/multiclass.py``; reference ``src/objective/multiclass_obj.cu``).

Margins are [n, K] with K = ``num_class``. The gradient of class k is
``p_k - [y == k]`` with ``h = max(2 p_k (1 - p_k), 1e-16)``, p the
softmax of the row's margins. The softmax subtracts the row's largest
margin, exponentiates and divides by the sum, which is taken in class
order, so a row's probabilities do not depend on the rows beside it (a
served batch gives the bits of ``Booster.predict``). The two packages'
``exp`` differ by an ulp (ROADMAP C), so gradients agree to about that.
The base margin is K zeros; there is no stump.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Objective, register


def softmax(margin: torch.Tensor) -> torch.Tensor:
    """Row softmax of [n, K] margins, the sum taken in class order."""
    e = torch.exp(margin - margin.max(dim=1, keepdim=True).values)
    total = e[:, 0]
    for k in range(1, e.shape[1]):
        total = total + e[:, k]
    return e / total[:, None]


class _SoftmaxBase(Objective):
    default_metric = "mlogloss"

    def n_targets(self, info=None) -> int:
        nc = int(self.params.get("num_class", 0) or 0)
        if nc < 2:
            raise ValueError("num_class must be set (>=2) for "
                             "multi:softmax/softprob")
        return nc

    def gradient(self, preds, labels, iteration=0):
        # preds [n, K] margins; labels [n, 1] class ids
        K = preds.shape[1]
        p = softmax(preds)
        y = labels[:, 0].to(torch.int32)
        onehot = y[:, None] == torch.arange(K, dtype=torch.int32,
                                            device=preds.device)[None, :]
        g = p - onehot.to(torch.float32)
        h = torch.clamp(2.0 * p * (1.0 - p), min=1e-16)
        return torch.stack([g, h], dim=-1)

    def init_estimation(self, labels, weights=None, **inputs) -> np.ndarray:
        return np.zeros(self.n_targets(), dtype=np.float32)


@register("multi:softprob")
class SoftProb(_SoftmaxBase):
    name = "multi:softprob"

    def pred_transform(self, margin):
        return softmax(margin)


@register("multi:softmax")
class SoftMax(_SoftmaxBase):
    name = "multi:softmax"
    default_metric = "merror"

    def pred_transform(self, margin):
        return torch.argmax(margin, dim=1).to(torch.float32)

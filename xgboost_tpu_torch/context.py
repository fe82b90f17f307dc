"""Execution context: which device the port runs on.

The PyTorch counterpart of ``xgboost::Context`` (reference
``include/xgboost/context.h:84``). ``device`` accepts ``"cuda"`` (the
default; ``"auto"`` means the same), ``"cuda:<n>"`` and ``"cpu"``, as
XGBoost 2.0 spells them. Every entry point of the port runs on the card
unless the caller asks for the CPU: when no CUDA device is present,
:func:`resolve_device` raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """``"cuda"`` / ``"auto"`` / ``"cuda:<n>"`` / ``"cpu"`` -> ``torch.device``.

    Raises ``RuntimeError`` naming the device when CUDA is asked for (or
    left as the default) and no CUDA device is present."""
    spec = str(device).strip().lower()
    if spec == "auto":
        spec = "cuda"
    if spec == "cpu":
        return torch.device("cpu")
    if spec != "cuda" and not (spec.startswith("cuda:")
                               and spec[5:].isdigit()):
        raise ValueError(f"unknown device {device!r}; use 'cuda', "
                         "'cuda:<n>', 'auto' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs CUDA, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    dev = torch.device(spec)
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device!r} does not exist: "
            f"{torch.cuda.device_count()} CUDA device(s) present")
    return dev


@dataclass
class Context:
    """Runtime context of a Booster (reference ``Context``; ``cuda`` here
    plays the role ``tpu`` plays in the JAX package)."""

    device: str = "cuda"

    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

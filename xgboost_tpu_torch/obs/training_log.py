"""The training log's import path: :class:`TrainingLog` lives in
``obs/insight.py`` (one class, as in the JAX package), and this module
re-exports it."""

from .insight import TrainingLog

__all__ = ["TrainingLog"]

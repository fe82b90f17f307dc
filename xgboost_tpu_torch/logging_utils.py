"""The package's logger (the JAX package's ``logging_utils.logger``;
reference console logger, ``include/xgboost/logging.h``): warnings of
the training loop and the serving stack's periodic metrics line."""

from __future__ import annotations

import logging

logger = logging.getLogger("xgboost_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s] %(message)s",
                                      "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

from .obs.monitor import Monitor  # noqa: E402,F401  (its older home)

"""Global (thread-local) configuration: ``verbosity``.

The port's copy of the JAX package's ``config.py`` (reference
``GlobalConfiguration`` and the Python ``config_context`` /
``set_config`` / ``get_config`` API). ``verbosity`` 0 silences the
training loop's evaluation lines.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator

_state = threading.local()

_DEFAULTS: Dict[str, Any] = {
    "verbosity": 1,
}


def _cfg() -> Dict[str, Any]:
    if not hasattr(_state, "cfg"):
        _state.cfg = dict(_DEFAULTS)
    return _state.cfg


def set_config(**kwargs: Any) -> None:
    cfg = _cfg()
    for k, v in kwargs.items():
        if k not in _DEFAULTS:
            raise ValueError(f"Unknown global config key: {k}")
        cfg[k] = v


def get_config() -> Dict[str, Any]:
    return dict(_cfg())


@contextlib.contextmanager
def config_context(**kwargs: Any) -> Iterator[None]:
    saved = get_config()
    try:
        set_config(**kwargs)
        yield
    finally:
        _cfg().clear()
        _cfg().update(saved)

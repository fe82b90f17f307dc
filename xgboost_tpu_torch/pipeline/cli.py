"""CLI for the continuous pipeline (``python -m xgboost_tpu_torch
pipeline``; the port of the JAX package's ``pipeline/cli.py``).

Key=value arguments only, matching the serve subcommand convention::

    python -m xgboost_tpu_torch pipeline workdir=DIR data=train.libsvm \
        holdout=valid.libsvm gate=auc:0.01 page_rows=10000 \
        objective=binary:logistic max_depth=6

ingests ``data`` in pages of ``page_rows`` rows and drives the loop to
a decision per page (run it again with new data to keep going — the
workdir carries all state). ``command=status`` prints the workdir's
manifest/page-log telemetry as JSON without training anything.

CLI keys: ``workdir`` (required), ``command`` (run|status), ``data``,
``holdout``, ``page_rows``, ``gate`` (repeatable,
``metric[:max_regression[:min_value[:max_value]]]``),
``rounds_per_epoch``, ``model_name``, ``canary_metric``,
``canary_max_regression``, ``checkpoint_every``, ``checkpoint_keep``,
``keep_epoch_snapshots``, ``silent``. Everything else passes through
as booster parameters; training runs on the card unless they say
``device=cpu``.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

_PIPELINE_KEYS = {
    "workdir", "command", "data", "holdout", "page_rows", "gate",
    "rounds_per_epoch", "model_name", "canary_metric",
    "canary_max_regression", "checkpoint_every", "checkpoint_keep",
    "keep_epoch_snapshots", "silent",
}


def _parse_args(argv: List[str]) -> Tuple[Dict[str, str], List[str],
                                          Dict[str, str]]:
    cfg: Dict[str, str] = {}
    gates: List[str] = []
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value argument, got {arg!r}")
        k, v = arg.split("=", 1)
        if k == "gate":
            gates.append(v)
        elif k in _PIPELINE_KEYS:
            cfg[k] = v
        else:
            params[k] = v
    return cfg, gates, params


def _status(workdir: str) -> Dict[str, object]:
    from .manifest import PromotionManifest
    from .pagelog import PageLog

    import os

    log = PageLog(os.path.join(workdir, "pages"))
    manifest = PromotionManifest.load(workdir)
    active = manifest.active
    return {
        "pages": log.count(),
        "decided_epoch": manifest.decided_epoch,
        "active_version": active["version"] if active else None,
        "active_rounds": active["rounds"] if active else 0,
        "promotions": len(manifest.history()),
        "rolled_back": list(manifest.state.get("rolled_back", [])),
        "events": manifest.events()[-10:],
    }


def pipeline_main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cfg, gate_specs, params = _parse_args(argv)
    if "workdir" not in cfg:
        raise ValueError("pipeline needs workdir=DIR")
    silent = cfg.get("silent", "0") in ("1", "true")
    if cfg.get("command", "run") == "status":
        print(json.dumps(_status(cfg["workdir"]), indent=1))
        return 0

    import numpy as np

    from ..data.dmatrix import DMatrix
    from .driver import Pipeline, PipelineConfig
    from .gates import parse_gate

    if "data" not in cfg:
        raise ValueError("pipeline run needs data=URI (fresh labeled rows)")
    dm = DMatrix(cfg["data"])
    if dm.X is None or dm.info.labels is None:
        raise ValueError("pipeline data must provide features and labels")
    holdout = None
    if "holdout" in cfg:
        holdout = DMatrix(cfg["holdout"])

    pcfg = PipelineConfig(
        workdir=cfg["workdir"], params=dict(params),
        rounds_per_epoch=int(cfg.get("rounds_per_epoch", "10")),
        model_name=cfg.get("model_name", "model"),
        gates=tuple(parse_gate(s) for s in gate_specs),
        canary_metric=cfg.get("canary_metric"),
        canary_max_regression=(
            float(cfg["canary_max_regression"])
            if "canary_max_regression" in cfg else None),
        checkpoint_every=int(cfg.get("checkpoint_every", "5")),
        checkpoint_keep=int(cfg.get("checkpoint_keep", "3")),
        keep_epoch_snapshots=int(cfg.get("keep_epoch_snapshots", "2")))
    pipe = Pipeline(pcfg, holdout=holdout)

    n = dm.num_row()
    page_rows = int(cfg.get("page_rows", str(n)))
    w = dm.info.weights
    for lo in range(0, n, page_rows):
        hi = min(lo + page_rows, n)
        report = pipe.step(dm.X[lo:hi], dm.info.labels[lo:hi],
                           None if w is None else w[lo:hi])
        if not silent:
            for entry in report:
                out = {k: v for k, v in entry.items() if k != "error"}
                if "canary" in out and out["canary"]:
                    out["canary"] = {k: v for k, v in out["canary"].items()
                                     if k != "error"}
                print(json.dumps(out, default=float))
    if not silent:
        print(json.dumps({"status": pipe.status()}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(pipeline_main())

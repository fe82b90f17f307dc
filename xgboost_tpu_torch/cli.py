"""Command line: train / dump / pred from a key=value config file.

The port of the JAX package's ``cli.py`` (reference
``src/cli_main.cc``, its ``ConfigParser`` in ``src/common/config.h``):

    python -m xgboost_tpu_torch <config> [key=value ...]

Keys the CLI takes itself (every other key is a booster parameter):
``task`` (train | dump | pred), ``data``, ``test:data``, ``eval[NAME]``,
``num_round``, ``model_in``, ``model_out``, ``model_dir``,
``save_period``, ``name_dump``, ``name_pred``, ``dump_format``,
``dump_stats``, ``fmap``, ``pred_margin``, ``iteration_begin``,
``iteration_end``, ``silent``. Training runs on the card unless the
config says ``device = cpu``.

``python -m xgboost_tpu_torch serve model=PATH [http_port=8080]
[--fleet N] [key=value ...]`` serves models (no config file; the keys
are ``serve/frontend.py``'s): the jsonl loop on stdin / stdout, or the
HTTP front end with ``http_port``.

Training snapshots: ``checkpoint_dir`` (a snapshot every
``checkpoint_every`` rounds, default 10, the newest ``checkpoint_keep``
kept, default 3; ``resume``, default ``auto``, takes the newest valid one
up; ``utils/checkpoint.py``). The JAX package's ``pipeline`` mode is not
in the port yet: it raises naming ROADMAP A.10.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Optional, Tuple

_CLI_KEYS = {
    "task", "data", "test:data", "num_round", "model_in", "model_out",
    "model_dir", "save_period", "name_dump", "name_pred", "dump_format",
    "dump_stats", "fmap", "pred_margin", "iteration_begin", "iteration_end",
    "silent",
    "checkpoint_dir", "checkpoint_every", "checkpoint_keep", "resume",
}


def parse_config_file(path: str) -> List[Tuple[str, str]]:
    """``key = value`` lines, ``#`` comments, values optionally quoted
    (reference ``ConfigParser``); the pairs in order (``eval[x]`` may
    repeat)."""
    pairs: List[Tuple[str, str]] = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r'^([^=\s]+)\s*=\s*(?:"([^"]*)"|(\S+))\s*$', line)
            if not m:
                raise ValueError(f"cannot parse config line: {line!r}")
            pairs.append((m.group(1), m.group(2) if m.group(2) is not None
                          else m.group(3)))
    return pairs


def _silent(cfg: Dict[str, str]) -> bool:
    return cfg.get("silent", "0") in ("1", "true")


def _train(cfg: Dict[str, str], evals: List[Tuple[str, str]],
           params: Dict[str, str]) -> None:
    from . import core
    from .data.dmatrix import DMatrix

    dtrain = DMatrix(cfg["data"])
    watch = [(dtrain, "train")] + [(DMatrix(uri), name)
                                   for name, uri in evals]
    num_round = int(cfg.get("num_round", "10"))
    model_in = cfg.get("model_in")
    xgb_model = None
    if model_in and model_in.lower() != "null":
        xgb_model = core.Booster(params=params, model_file=model_in)
    save_period = int(cfg.get("save_period", "0"))
    model_dir = cfg.get("model_dir", "")
    callbacks = []
    if save_period > 0:
        from .callback import TrainingCheckPoint

        callbacks.append(TrainingCheckPoint(
            directory=model_dir or ".", name="model", interval=save_period))
    checkpoint = None
    ck_dir = cfg.get("checkpoint_dir")
    if ck_dir and ck_dir.lower() != "null":
        from .utils.checkpoint import CheckpointConfig

        checkpoint = CheckpointConfig(
            directory=ck_dir,
            every_n_rounds=int(cfg.get("checkpoint_every", "10")),
            keep=int(cfg.get("checkpoint_keep", "3")),
            resume=(cfg.get("resume", "auto").lower()
                    not in ("0", "false", "none")) and "auto")
    bst = core.train(params, dtrain, num_round, evals=watch,
                     xgb_model=xgb_model, verbose_eval=not _silent(cfg),
                     callbacks=callbacks, checkpoint=checkpoint)
    model_out = cfg.get("model_out", "")
    if not model_out or model_out.lower() == "null":
        model_out = os.path.join(model_dir or ".", f"{num_round:04d}.model")
    bst.save_model(model_out)
    if not _silent(cfg):
        print(f"saved model to {model_out}")


def _dump(cfg: Dict[str, str], params: Dict[str, str]) -> None:
    from . import core

    bst = core.Booster(params=params, model_file=cfg["model_in"])
    fmap = cfg.get("fmap", "")
    if fmap and os.path.exists(fmap):
        names: Dict[int, str] = {}
        with open(fmap) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    names[int(parts[0])] = parts[1]
        if names:
            bst.feature_names = [names.get(i, f"f{i}")
                                 for i in range(max(names) + 1)]
    fmt = cfg.get("dump_format", "text")
    dumps = bst.get_dump(with_stats=cfg.get("dump_stats", "0")
                         in ("1", "true"), dump_format=fmt)
    out_path = cfg.get("name_dump", "dump.txt")
    with open(out_path, "w") as fh:
        if fmt == "json":
            fh.write("[\n" + ",\n".join(dumps) + "\n]\n")
        else:
            for i, d in enumerate(dumps):
                fh.write(f"booster[{i}]:\n{d}")
    if not _silent(cfg):
        print(f"dumped {len(dumps)} trees to {out_path}")


def _pred(cfg: Dict[str, str], params: Dict[str, str]) -> None:
    import numpy as np

    from . import core
    from .data.dmatrix import DMatrix

    bst = core.Booster(params=params, model_file=cfg["model_in"])
    dtest = DMatrix(cfg["test:data"])
    begin = int(cfg.get("iteration_begin", "0"))
    end = int(cfg.get("iteration_end", "0"))
    arr = np.asarray(bst.predict(
        dtest, output_margin=cfg.get("pred_margin", "0") in ("1", "true"),
        iteration_range=(begin, end) if (begin or end) else None))
    out_path = cfg.get("name_pred", "pred.txt")
    with open(out_path, "w") as fh:
        for row in arr:
            if arr.ndim == 1:
                fh.write(f"{row:.9g}\n")
            else:
                fh.write(",".join(f"{v:.9g}" for v in row) + "\n")
    if not _silent(cfg):
        print(f"wrote {len(arr)} predictions to {out_path}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    if argv[0] == "serve":
        from .serve.frontend import serve_main

        return serve_main(argv[1:])
    if argv[0] == "pipeline":
        raise NotImplementedError(
            "the CLI's pipeline mode is not in the PyTorch port yet "
            "(ROADMAP A.10)")
    pairs = parse_config_file(argv[0])
    for extra in argv[1:]:      # key=value arguments, the last one wins
        if "=" not in extra:
            raise ValueError(f"expected key=value argument, got {extra!r}")
        pairs.append(tuple(extra.split("=", 1)))

    cfg: Dict[str, str] = {}
    evals: List[Tuple[str, str]] = []
    params: Dict[str, str] = {}
    for k, v in pairs:
        m = re.match(r"^eval\[(.+)\]$", k)
        if m:
            evals.append((m.group(1), v))
        elif k in _CLI_KEYS:
            cfg[k] = v
        else:
            params[k] = v

    task = cfg.get("task", "train")
    if task == "train":
        _train(cfg, evals, params)
    elif task == "dump":
        _dump(cfg, params)
    elif task == "pred":
        _pred(cfg, params)
    else:
        raise ValueError(f"unknown task: {task} (use train|dump|pred)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

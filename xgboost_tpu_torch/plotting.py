"""Plotting helpers (reference ``python-package/xgboost/plotting.py``; the
JAX package's ``plotting.py``): ``plot_importance``, ``plot_tree`` and
``to_graphviz``, over ``dump.py``'s importances and dot dump. matplotlib
and graphviz are optional, as in the reference."""

from __future__ import annotations

from typing import Any, Optional

from .dump import dump_dot


def _booster(booster):
    """A Booster, or the Booster of a scikit-learn wrapper."""
    return booster.get_booster() if hasattr(booster, "get_booster") \
        else booster


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None, title: str = "Feature importance",
                    xlabel: str = "Importance score",
                    ylabel: str = "Features",
                    importance_type: str = "weight",
                    max_num_features: Optional[int] = None,
                    grid: bool = True, show_values: bool = True,
                    values_format: str = "{v}", **kwargs: Any):
    """A horizontal bar chart of ``Booster.get_score(importance_type)``,
    smallest at the bottom -> the matplotlib axes."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plot_importance requires matplotlib") from e

    importance = _booster(booster).get_score(importance_type=importance_type)
    if not importance:
        raise ValueError("Booster is empty")
    tuples = sorted(importance.items(), key=lambda kv: kv[1])
    if max_num_features is not None:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    if ax is None:
        _, ax = plt.subplots(1, 1)
    ylocs = range(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    if show_values:
        for x, y in zip(values, ylocs):
            ax.text(x + 1, y, values_format.format(v=round(x, 2)),
                    va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def to_graphviz(booster, num_trees: int = 0, rankdir: Optional[str] = None,
                **kwargs: Any):
    """Tree ``num_trees`` as a ``graphviz.Source``, or as its dot text when
    the graphviz package is not installed."""
    booster = _booster(booster)
    trees = booster.gbm.trees
    if num_trees >= len(trees):
        raise ValueError(f"tree index {num_trees} out of range")
    dot = dump_dot(trees[num_trees], booster.feature_names)
    if rankdir:
        dot = dot.replace("rankdir=TB", f"rankdir={rankdir}")
    try:
        from graphviz import Source

        return Source(dot)
    except ImportError:
        return dot


def plot_tree(booster, num_trees: int = 0, ax=None,
              rankdir: Optional[str] = None, **kwargs: Any):
    """Tree ``num_trees`` drawn by graphviz into matplotlib axes (needs
    both packages and the ``dot`` program)."""
    try:
        import matplotlib.image as mimage
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plot_tree requires matplotlib") from e
    import io

    source = to_graphviz(booster, num_trees=num_trees, rankdir=rankdir,
                         **kwargs)
    if isinstance(source, str):
        raise ImportError("plot_tree requires the graphviz package")
    s = source.pipe(format="png")
    if ax is None:
        _, ax = plt.subplots(1, 1)
    ax.imshow(mimage.imread(io.BytesIO(s)))
    ax.axis("off")
    return ax

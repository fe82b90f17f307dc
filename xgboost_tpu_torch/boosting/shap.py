"""Feature contributions on the host: exact TreeSHAP, Saabas and
interactions, in plain Python and numpy.

The port of the JAX package's ``boosting/shap.py`` (reference
``Predictor::PredictContribution`` / ``PredictInteractionContributions``,
``src/predictor/cpu_treeshap.cc``): Lundberg's recursion with its
``extend`` / ``unwind`` / ``unwound_sum`` path steps
(:func:`_tree_shap_py`), the cover-weighted walk of the approximate
contributions (:func:`approx_contribs`) and the interactions from
conditional passes (:func:`shap_interactions`). This is the plain
version of ``ops/shap.py``, which ``Booster.predict`` runs on the
booster's device: the tests hold that path against it, and no predict
path calls it. The recursion runs in float64 throughout (the JAX
package's native library runs it in float32 and sums in float64).

Output convention (the reference's): [n, G, F + 1], the last column the
bias (the cover-weighted expected output plus the base score), so each
row sums to its margin; interactions [n, G, F + 1, F + 1].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..tree.tree import TreeModel


def forest_arrays(trees: Sequence[TreeModel]) -> Dict[str, np.ndarray]:
    """The trees' compact arrays padded to M nodes: [T, M] (padding slots
    are leaves of value 0), ``cat_words`` [T, M, W]."""
    T = len(trees)
    M = max(t.num_nodes() for t in trees)
    W = max(t.cat_words.shape[1] for t in trees)

    def pad(name, fill, dtype):
        out = np.full((T, M), fill, dtype)
        for i, t in enumerate(trees):
            out[i, :t.num_nodes()] = getattr(t, name)
        return out

    cw = np.zeros((T, M, W), np.uint32)
    for i, t in enumerate(trees):
        cw[i, :t.num_nodes(), :t.cat_words.shape[1]] = t.cat_words
    has_cat = any(t.is_cat_split.any() for t in trees)
    return {
        "left_child": pad("left_child", -1, np.int64),
        "right_child": pad("right_child", -1, np.int64),
        "parent": pad("parent", -1, np.int64),
        "split_feature": pad("split_feature", -1, np.int64),
        "split_value": pad("split_value", 0.0, np.float32),
        "default_left": pad("default_left", False, bool),
        "is_leaf": pad("is_leaf", True, bool),
        "leaf_value": pad("leaf_value", 0.0, np.float32),
        "sum_hess": pad("sum_hess", 0.0, np.float32),
        "is_cat_split": pad("is_cat_split", False, bool),
        "cat_words": cw if has_cat else cw[..., :1],
    }


def node_means(arr: Dict[str, np.ndarray]) -> np.ndarray:
    """[T, M] f64 cover-weighted mean leaf value under each node (the
    reference's ``mean_value``): one reverse sweep, children having
    larger ids than their parents."""
    lf, lc, rc = arr["is_leaf"], arr["left_child"], arr["right_child"]
    sh = arr["sum_hess"].astype(np.float64)
    T, M = lf.shape
    rows = np.arange(T)
    mean = np.where(lf, arr["leaf_value"].astype(np.float64), 0.0)
    for nid in range(M - 1, -1, -1):
        inner = ~lf[:, nid]
        if not inner.any():
            continue
        li, ri = np.maximum(lc[:, nid], 0), np.maximum(rc[:, nid], 0)
        hl, hr = sh[rows, li], sh[rows, ri]
        h = hl + hr
        with np.errstate(invalid="ignore", divide="ignore"):
            m = np.where(h > 0, (hl * mean[rows, li] + hr * mean[rows, ri])
                         / np.where(h > 0, h, 1.0), 0.0)
        mean[:, nid] = np.where(inner, m, mean[:, nid])
    return mean


def goes_left(arr: Dict[str, np.ndarray], t: int, nid: int,
              x: float) -> bool:
    """One row's direction at node ``nid`` of tree ``t``: NaN the default
    way; at a categorical split the left set's bit, a code out of range
    the default way; else ``not (x > split)``."""
    if np.isnan(x):
        return bool(arr["default_left"][t, nid])
    if arr["is_cat_split"][t, nid]:
        code = int(x)
        W = arr["cat_words"].shape[-1]
        if code < 0 or code >= W * 32:
            return bool(arr["default_left"][t, nid])
        return bool((int(arr["cat_words"][t, nid, code // 32])
                     >> (code % 32)) & 1)
    return not (x > arr["split_value"][t, nid])


def _extend(m: List[list], pz: float, po: float, fi: int) -> None:
    d = len(m)
    m.append([fi, pz, po, 1.0 if d == 0 else 0.0])
    for i in range(d - 1, -1, -1):
        m[i + 1][3] += po * m[i][3] * (i + 1) / (d + 1)
        m[i][3] = pz * m[i][3] * (d - i) / (d + 1)


def _unwind(m: List[list], idx: int) -> List[list]:
    d = len(m) - 1
    one, zero = m[idx][2], m[idx][1]
    out = [row[:] for row in m]
    nxt = out[d][3]
    if one != 0.0:
        for i in range(d - 1, -1, -1):
            tmp = out[i][3]
            out[i][3] = nxt * (d + 1) / ((i + 1) * one)
            nxt = tmp - out[i][3] * zero * (d - i) / (d + 1)
    else:
        for i in range(d - 1, -1, -1):
            out[i][3] = out[i][3] * (d + 1) / (zero * (d - i))
    for i in range(idx, d):
        out[i][0], out[i][1], out[i][2] = out[i + 1][0], out[i + 1][1], \
            out[i + 1][2]
    return out[:-1]


def _unwound_sum(m: List[list], idx: int) -> float:
    d = len(m) - 1
    one, zero = m[idx][2], m[idx][1]
    nxt, total = m[d][3], 0.0
    if one != 0.0:
        for i in range(d - 1, -1, -1):
            t = nxt / ((i + 1) * one)
            total += t
            nxt = m[i][3] - t * zero * (d - i)
    else:
        for i in range(d - 1, -1, -1):
            total += m[i][3] / (zero * (d - i))
    return total * (d + 1)


def _tree_shap_py(X: np.ndarray, arr: Dict[str, np.ndarray],
                  tree_info: np.ndarray, tree_weights: np.ndarray,
                  n_groups: int, base_score: np.ndarray, condition: int,
                  condition_feature: int) -> np.ndarray:
    """Lundberg's recursion over every row and tree (the JAX package's
    ``_tree_shap_py``), ``condition`` +1 / -1 on ``condition_feature``
    for the interactions' conditional passes (no bias term then)."""
    n, F = X.shape
    out = np.zeros((n, n_groups, F + 1), np.float64)
    lc, rc = arr["left_child"], arr["right_child"]
    sf, lf = arr["split_feature"], arr["is_leaf"]
    lv = arr["leaf_value"].astype(np.float64)
    sh = arr["sum_hess"].astype(np.float64)
    means = node_means(arr)[:, 0]
    T = lf.shape[0]

    def recurse(t, x, phi, nid, m, cond_frac, scale):
        if lf[t, nid]:
            for i in range(1, len(m)):
                w = _unwound_sum(m, i)
                phi[m[i][0]] += w * (m[i][2] - m[i][1]) * lv[t, nid] \
                    * cond_frac * scale
            return
        fid = int(sf[t, nid])
        left, right = int(lc[t, nid]), int(rc[t, nid])
        hot, cold = (left, right) if goes_left(arr, t, nid, x[fid]) \
            else (right, left)
        cover = sh[t, nid]
        hz = sh[t, hot] / cover if cover > 0 else 0.0
        cz = sh[t, cold] / cover if cover > 0 else 0.0
        iz = io = 1.0
        mm = m
        for i in range(1, len(m)):
            if m[i][0] == fid:
                iz, io = m[i][1], m[i][2]
                mm = _unwind(m, i)
                break
        if condition != 0 and fid == condition_feature:
            if condition > 0:
                recurse(t, x, phi, hot, mm, cond_frac, scale)
            else:
                recurse(t, x, phi, hot, mm, cond_frac * hz, scale)
                recurse(t, x, phi, cold, mm, cond_frac * cz, scale)
            return
        mh = [row[:] for row in mm]
        _extend(mh, iz * hz, io, fid)
        recurse(t, x, phi, hot, mh, cond_frac, scale)
        mc = [row[:] for row in mm]
        _extend(mc, iz * cz, 0.0, fid)
        recurse(t, x, phi, cold, mc, cond_frac, scale)

    tw = np.asarray(tree_weights, np.float64)
    tg = np.asarray(tree_info, np.int64)
    bs = np.asarray(base_score, np.float64)
    for r in range(n):
        x = X[r]
        for t in range(T):
            phi = out[r, tg[t]]
            m: List[list] = []
            _extend(m, 1.0, 1.0, -1)
            recurse(t, x, phi, 0, m, 1.0, float(tw[t]))
            if condition == 0:
                out[r, tg[t], F] += means[t] * tw[t]
        if condition == 0:
            out[r, :, F] += bs
    return out


def _weights(trees, tree_weights) -> np.ndarray:
    return (np.ones(len(trees), np.float32) if tree_weights is None
            else np.asarray(tree_weights, np.float32))


def tree_shap(X: np.ndarray, trees: Sequence[TreeModel],
              tree_info: np.ndarray, n_groups: int, base_score: np.ndarray,
              tree_weights: Optional[np.ndarray] = None, condition: int = 0,
              condition_feature: int = 0, _arrays=None) -> np.ndarray:
    """-> [n, n_groups, F + 1] float64 exact contributions."""
    X = np.ascontiguousarray(X, np.float32)
    n, F = X.shape
    if not trees:
        out = np.zeros((n, n_groups, F + 1), np.float64)
        if condition == 0:
            out[:, :, F] = np.asarray(base_score, np.float64)[None, :]
        return out
    arr = forest_arrays(trees) if _arrays is None else _arrays
    return _tree_shap_py(X, arr, tree_info, _weights(trees, tree_weights),
                         n_groups, base_score, condition, condition_feature)


def approx_contribs(X: np.ndarray, trees: Sequence[TreeModel],
                    tree_info: np.ndarray, n_groups: int,
                    base_score: np.ndarray,
                    tree_weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Saabas contributions (reference ``approximate=True``): each row's
    path walked level by level, ``mean(child) - mean(node)`` credited to
    the node's split feature."""
    X = np.ascontiguousarray(X, np.float32)
    n, F = X.shape
    out = np.zeros((n, n_groups, F + 1), np.float64)
    out[:, :, F] = np.asarray(base_score, np.float64)[None, :]
    if not trees:
        return out
    arr = forest_arrays(trees)
    mean = node_means(arr)
    tw = _weights(trees, tree_weights)
    tg = np.asarray(tree_info, np.int64)
    rows = np.arange(n)
    max_depth = max(t.max_depth() for t in trees)
    for t in range(len(trees)):
        pos = np.zeros(n, np.int64)
        out[:, tg[t], F] += mean[t, 0] * tw[t]
        for _ in range(max_depth):
            act = ~arr["is_leaf"][t, pos]
            if not act.any():
                break
            fid = arr["split_feature"][t, pos]
            left = np.asarray([goes_left(arr, t, p, X[r, max(f, 0)])
                               for r, p, f in zip(rows, pos, fid)], bool)
            child = np.where(left, arr["left_child"][t, pos],
                             arr["right_child"][t, pos])
            delta = (mean[t, np.maximum(child, 0)] - mean[t, pos]) * tw[t]
            live = rows[act]
            np.add.at(out, (live, tg[t], fid[live]), delta[live])
            pos = np.where(act, child, pos)
    return out


def shap_interactions(X: np.ndarray, trees: Sequence[TreeModel],
                      tree_info: np.ndarray, n_groups: int,
                      base_score: np.ndarray,
                      tree_weights: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """-> [n, n_groups, F + 1, F + 1] interaction values (reference
    ``PredictInteractionContributions``): row j off its diagonal is half
    the difference of the passes conditioned on j present and absent,
    the diagonal what is left of j's contribution, the bias row what is
    left of each column's."""
    X = np.ascontiguousarray(X, np.float32)
    n, F = X.shape
    arr = forest_arrays(trees) if trees else None
    contribs = tree_shap(X, trees, tree_info, n_groups, base_score,
                         tree_weights, _arrays=arr)
    out = np.zeros((n, n_groups, F + 1, F + 1), np.float64)
    used = sorted({int(f) for t in trees
                   for f in np.unique(t.split_feature) if f >= 0})
    for j in used:
        on = tree_shap(X, trees, tree_info, n_groups, base_score,
                       tree_weights, condition=1, condition_feature=j,
                       _arrays=arr)
        off = tree_shap(X, trees, tree_info, n_groups, base_score,
                        tree_weights, condition=-1, condition_feature=j,
                        _arrays=arr)
        inter = (on - off) / 2.0
        inter[:, :, j] = 0.0
        out[:, :, j, :] = inter
        out[:, :, j, j] = contribs[:, :, j] - inter.sum(axis=2)
    out[:, :, F, :F] = contribs[:, :, :F] - out[:, :, :F, :F].sum(axis=2)
    out[:, :, F, F] = contribs[:, :, F]
    return out

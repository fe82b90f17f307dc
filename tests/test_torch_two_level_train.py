"""The two-level schedules as a whole, on the CPU: the port's
``hist_method`` ``coarse``, ``fused`` and ``scan`` against each other and
the port's ``fused`` against the JAX package's.

The three schedules sum the same integers in every histogram (the direct
coarse build, K5's coarse build and K4's fold; the direct refine build
and the slice of the fine histogram), so they must grow the same model:
their ``save_raw`` bytes are compared once each booster records the same
``hist_method``. The launches of each kernel's plain version per round
are counted as ``chip_smoke.py`` counts the kernels' on the card.

Against the JAX package the comparison is the training slice's
certification (``tests/test_torch_train.py check_slice_against_jax``):
trees node by node, near ties certified, leaves and predictions at rtol
1e-5 plus 1e-4. The JAX package's CPU ``fused`` builds its coarse and refine
histograms with the f32 ``segment`` build; the port builds them in
int8x2, as the TPU does. Two things follow, and the test handles each:

- int8x2 rounds each gradient to a grid of ``max|g| / 32512``. After
  round 0 a round's gradients take at most 2^depth values, so the
  rounding errors of a node's rows do not cancel: measured, a node's
  hessian sum moves by up to 4e-3, past the certificate. So both
  packages train on gradients already on the int8x2 grid (the same
  float64 logistic gradient, rounded to f32 and then to the grid, a
  custom objective on the JAX side and the same function in the port's
  objective), and the two histograms add the same values;
- f32 sums of large nodes still round: along the rightmost path of the
  depth-6 trees the JAX package's hessian sums drift from the exact
  sums, at node 62 of round 1 by 1.3e-3 (the port's by 2.3e-4, one
  rounding at the root's scale), and the node's gain moves by 8.5e-4 of
  its scale (ROADMAP C), which ``test_jax_fused_depth6_drift_is_in_its_
  f32_sums`` pins. The certificate is held at depth 8, where the
  measured gaps stay within it.
"""

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
import xgboost_tpu_torch.ops.histogram as H
from test_torch_train import _higgs_like, check_slice_against_jax
from xgboost_tpu_torch.objective.base import Objective

ROUNDS = 10


@pytest.fixture(scope="module")
def higgs():
    return _higgs_like()


def _grid_gradient(margin, y):
    """The logistic gradient in float64, rounded to f32 and then to the
    int8x2 grid ``q * inv`` -> [n, 2] f32."""
    p = 1.0 / (1.0 + np.exp(-np.asarray(margin, np.float64).reshape(-1)))
    g = np.stack([p - y, np.maximum(p * (1.0 - p), 1e-16)], 1).astype(
        np.float32)
    q, inv = H.quantise_int8x2(torch.from_numpy(g))
    return (q.to(torch.float32) * inv).numpy()


def _jax_grid_objective(margin, dtrain):
    g = _grid_gradient(margin, dtrain.get_label())
    return g[:, 0], g[:, 1]


def _port_grid_gradient(self, preds, labels, weights=None, iteration=0):
    g = _grid_gradient(preds.cpu().numpy(), labels.cpu().numpy().reshape(-1))
    return torch.from_numpy(g)[:, None, :].to(preds.device)


# (depth, trees equal in full end to end, rounds with no near tie round
# by round), the last two as measured on the CPU
JAX_CASES = [(8, 3, 10)]


@pytest.mark.parametrize("depth,full_min,clean_min", JAX_CASES)
def test_fused_matches_jax_fused(higgs, depth, full_min, clean_min,
                                 monkeypatch):
    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    monkeypatch.setattr(Objective, "get_gradient", _port_grid_gradient)
    X, y, _ = higgs
    check_slice_against_jax(X, y, "binary:logistic", depth, "fused",
                            "fused", full_min, clean_min,
                            jax_obj=_jax_grid_objective)


def test_jax_fused_depth6_drift_is_in_its_f32_sums(higgs, monkeypatch):
    """Why the certificate is held at depth 8 only: at depth 6 the JAX
    package's ``fused`` drifts from the exact sums, not the port. Round 0
    is certified with no near tie. In round 1 (both grown from the JAX
    model's margin) the two trees split alike along the rightmost path
    down to node 62, whose 25 rows' exact hessian sum (float64 over the
    on-grid gradients) the port's node keeps to the f32 rounding of the
    root's scale (its ``parent - left`` subtractions), while the JAX
    package's f32 ``segment`` sums miss it by 1.3e-3 and move the node's
    gain past the certificate (ROADMAP C)."""
    from test_torch_train import GAIN_RTOL, _parent_term, compare_tree

    monkeypatch.setenv("XTPU_BATCH_ROUNDS", "1")
    monkeypatch.setattr(Objective, "get_gradient", _port_grid_gradient)
    X, y, _ = higgs
    params = {"objective": "binary:logistic", "max_depth": 6, "eta": 0.3,
              "base_score": 0.5}
    jb = xgb.train(dict(params, hist_method="fused"),
                   xgb.DMatrix(X, label=y), 2, verbose_eval=False,
                   obj=_jax_grid_objective)
    port = dict(params, hist_method="fused", device="cpu")
    t0 = xt.train(port, xt.DMatrix(X, label=y), 1, verbose_eval=False)
    assert compare_tree(jb.gbm.trees[0], t0.gbm.trees[0], 0.3)[0] == []

    jmodel = xt.Booster({"device": "cpu"}, model_file=jb.save_raw("json"))
    margin = jmodel.predict(xt.DMatrix(X), output_margin=True,
                            iteration_range=(0, 1))
    t1 = xt.train(port, xt.DMatrix(X, label=y, base_margin=margin), 1,
                  verbose_eval=False).gbm.trees[0]
    a = jb.gbm.trees[1]
    bm = xt.DMatrix(X).binned(256, torch.device("cpu"))
    bins = bm.bins.numpy().astype(np.int64)
    at = np.ones(X.shape[0], bool)
    i = j = 0
    for _ in range(5):                  # heap nodes 0, 2, 6, 14, 30
        assert (a.split_feature[i], a.split_bin[i], a.default_left[i]) == \
            (t1.split_feature[j], t1.split_bin[j], t1.default_left[j])
        b = bins[:, a.split_feature[i]]
        at &= np.where(b == bm.missing_bin, not a.default_left[i],
                       b > a.split_bin[i])
        i, j = a.right_child[i], t1.right_child[j]
    exact = _grid_gradient(margin, y)[at, 1].astype(np.float64).sum()
    root_ulp = float(np.spacing(np.float32(t1.sum_hess[0])))
    port_err = abs(float(t1.sum_hess[j]) - exact)
    jax_err = abs(float(a.sum_hess[i]) - exact)
    print(f"node 62: {int(at.sum())} rows, exact hessian {exact:.7f}, port "
          f"{t1.sum_hess[j]} ({port_err:.2e}), JAX {a.sum_hess[i]} "
          f"({jax_err:.2e})")
    assert int(at.sum()) == 25
    assert port_err <= 2 * root_ulp
    assert 1e-3 <= jax_err <= 2e-3
    scale = _parent_term(a, i, 0.3, 1.0) + abs(float(a.gain[i]))
    assert abs(float(a.gain[i]) - float(t1.gain[j])) > GAIN_RTOL * scale


def _count_plain_kernels(monkeypatch):
    """Counts of the plain K5 (``fused_advance_coarse_reference``), K4
    (``scan_acc_reference``) and int8x2 builds, K2
    (``build_hist_int8x2_reference``, which the plain K5 also calls)."""
    calls = {"K5": 0, "K4": 0, "K2": 0}
    for key, name in (("K5", "fused_advance_coarse_reference"),
                      ("K4", "scan_acc_reference"),
                      ("K2", "build_hist_int8x2_reference")):
        def counted(*a, _key=key, _fn=getattr(H, name)):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(H, name, counted)
    return calls


@pytest.mark.parametrize("depth", [6, 8])
def test_schedules_grow_the_same_model(higgs, depth, monkeypatch):
    """``coarse``, ``fused`` and ``scan`` save the same bytes, and each
    runs the kernels ``chip_smoke.py`` asserts on the card, a round:
    ``fused`` K5 at levels 1 to depth - 1 and K2 for the root's coarse
    histogram and every level's refine; ``scan`` K4 at every level;
    ``coarse`` K2 twice a level."""
    X, y, _ = higgs
    want = {"coarse": {"K5": 0, "K4": 0, "K2": 2 * depth},
            "fused": {"K5": depth - 1, "K4": 0, "K2": depth + 1},
            "scan": {"K5": 0, "K4": depth, "K2": 0}}
    raws = {}
    for method in ("coarse", "fused", "scan"):
        calls = _count_plain_kernels(monkeypatch)
        bst = xt.train({"objective": "binary:logistic", "max_depth": depth,
                        "device": "cpu", "hist_method": method},
                       xt.DMatrix(X, label=y), ROUNDS, verbose_eval=False)
        monkeypatch.undo()
        calls["K2"] -= calls["K5"]              # the plain K5 runs K2's
        assert calls == {k: v * ROUNDS for k, v in want[method].items()}, \
            method
        assert max(t.max_depth() for t in bst.gbm.trees) == depth
        bst.set_param({"hist_method": "scan"})
        raws[method] = bytes(bst.save_raw("ubj"))
    assert raws["coarse"] == raws["fused"] == raws["scan"]


@pytest.mark.parametrize("params,match", [
    ({"hist_method": "mega", "max_bin": 512}, "max_bin <= 256"),
    ({"hist_method": "fused+sub", "max_bin": 300}, "max_bin <= 256"),
    ({"hist_method": "fused", "max_bin": 512}, "max_bin <= 256"),
    ({"hist_method": "scan", "max_bin": 300}, "max_bin <= 256"),
])
def test_two_level_refusals(params, match):
    rng = np.random.RandomState(4)
    X = rng.randn(2000, 3).astype(np.float32)
    dm = xt.DMatrix(X, label=(X[:, 0] > 0).astype(np.float32))
    with pytest.raises(NotImplementedError, match=match):
        xt.train(dict({"objective": "binary:logistic", "device": "cpu"},
                      **params), dm, 1)


def test_two_level_refuses_categorical_features():
    rng = np.random.RandomState(5)
    X = rng.randn(500, 3).astype(np.float32)
    X[:, 1] = rng.randint(0, 5, 500)
    dm = xt.DMatrix(X, label=(X[:, 0] > 0).astype(np.float32))
    dm.info.feature_types = ["q", "c", "q"]
    with pytest.raises(NotImplementedError, match="categorical"):
        xt.train({"objective": "binary:logistic", "device": "cpu",
                  "hist_method": "fused"}, dm, 1)

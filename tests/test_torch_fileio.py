"""``DMatrix(path)`` in the port (``xgboost_tpu_torch/data/fileio.py``)
against the JAX package, on the CPU: libsvm (``qid:`` tokens, the
``.group`` / ``.weight`` / ``.base_margin`` side files), CSV and TSV
(``label_column``, a trailing empty field), the ``#cache`` suffix, and
the ``save_binary`` npz in both directions between the packages. Every
matrix is held bit for bit (NaN positions and values) with its meta
info; the DMatrix surface (``get_label`` ... ``slice``) is held to the
JAX package's on the same file.

The agaricus shape (one-hot attributes, every present value 1.0,
column 0 never present) gives a single cut a feature and two bin slots;
cuts and bins are held to the JAX package's bit for bit there.
"""

import os

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from test_torch_adapters import assert_same_matrix
from xgboost_tpu.data.binned import BinnedMatrix as JaxBinned
from xgboost_tpu.data.quantile import sketch_matrix as jax_sketch
from xgboost_tpu_torch.data.binned import BinnedMatrix
from xgboost_tpu_torch.data.fileio import parse_uri
from xgboost_tpu_torch.data.quantile import sketch_matrix
from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm


def assert_same_dmatrix(td, jd):
    assert_same_matrix(td.X, jd.X)
    for field in ("label", "weight", "base_margin", "label_lower_bound",
                  "label_upper_bound"):
        np.testing.assert_array_equal(td.get_float_info(field),
                                      jd.get_float_info(field))
    np.testing.assert_array_equal(td.get_group(), jd.get_group())
    assert (td.feature_names, td.feature_types) == \
        (jd.feature_names, jd.feature_types)


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _files(tmp, case):
    """(uri, expected shape) of one case's file(s) under ``tmp``."""
    if case == "agaricus":
        y, idx = agaricus_rows(300, seed=1)
        p = os.path.join(tmp, "agaricus.txt.train")
        write_libsvm(p, y, idx)
        return p + "?format=libsvm", (300, 127)
    if case == "libsvm_qid":
        p = _write(os.path.join(tmp, "rank.txt"),
                   "2 qid:1 1:0.5 3:-1.25\n0 qid:1 2:3\n1 qid:2 1:1e-3 "
                   "4:7 # a comment\n\n0 qid:2 0:2.5\n")
        return p, (4, 5)
    if case == "libsvm_sides":
        p = _write(os.path.join(tmp, "side.libsvm"),
                   "1 1:0.1 2:0.2\n0 2:0.3\n1 0:1.5\n0 1:-0.7 2:9\n")
        _write(p + ".group", "3\n1\n")
        _write(p + ".weight", "0.5\n1\n2\n1.5\n")
        _write(p + ".base_margin", "0.1\n-0.2\n0.3\n0\n")
        return p + "#cache_prefix", (4, 3)
    if case == "csv_label_2":
        p = _write(os.path.join(tmp, "data.csv"),
                   "1.5,2,0\n,3.25,1\n-4,,1\n0.125,7,0\n")
        return p + "?format=csv&label_column=2", (4, 2)
    if case == "csv_label_0":
        p = _write(os.path.join(tmp, "plain.txt"),
                   "0,1.5,2\n1, 3.25 ,\n1,-4,8\n")
        return p + "?format=csv", (3, 2)
    if case == "tsv_trailing_tab":
        p = _write(os.path.join(tmp, "data.tsv"),
                   "1\t0.5\t2\t\n0\t1.5\t\t3\n1\t\t4\t5\n")
        return p, (3, 3)
    raise ValueError(case)


FILE_CASES = ["agaricus", "libsvm_qid", "libsvm_sides", "csv_label_2",
              "csv_label_0", "tsv_trailing_tab"]


@pytest.mark.parametrize("case", FILE_CASES)
def test_file_matches_jax(tmp_path, case):
    uri, shape = _files(str(tmp_path), case)
    jd, td = xgb.DMatrix(uri), xt.DMatrix(uri)
    assert td.shape == jd.shape == shape
    assert_same_dmatrix(td, jd)
    assert td.num_nonmissing() == jd.num_nonmissing()
    if case == "agaricus":
        assert np.isnan(td.X[:, 0]).all() and td.num_nonmissing() == 300 * 22
    if case == "libsvm_qid":
        np.testing.assert_array_equal(td.get_group(), [2, 2])
    if case == "libsvm_sides":
        np.testing.assert_array_equal(td.get_group(), [3, 1])
        np.testing.assert_array_equal(td.get_weight(), [0.5, 1, 2, 1.5])
    if case == "tsv_trailing_tab":
        assert np.isnan(td.X[0, 2]) and td.get_label().tolist() == [1, 0, 1]


def test_parse_uri():
    assert parse_uri("a/b.csv#c") == ("a/b.csv", "csv", 0)
    assert parse_uri("x.txt?format=csv&label_column=3") == ("x.txt", "csv", 3)
    assert parse_uri("x.tsv?format=libsvm") == ("x.tsv", "libsvm", 0)
    assert parse_uri("x.TSV") == ("x.TSV", "csv", 0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_binary_loads_into_both(tmp_path, writer):
    """The npz container: written by either package, read by both, the
    label bounds, query groups, names and types included."""
    rng = np.random.RandomState(2)
    X = rng.randn(12, 4).astype(np.float32)
    X[rng.rand(12, 4) < 0.25] = np.nan
    X[:, 3] = rng.randint(0, 3, 12)
    kw = dict(label=rng.rand(12), weight=rng.rand(12) + 0.5,
              base_margin=rng.randn(12), group=[5, 7],
              label_lower_bound=rng.rand(12),
              label_upper_bound=rng.rand(12) + 1,
              feature_names=["a", "b", "c", "d"],
              feature_types=["float", "float", "int", "c"],
              enable_categorical=True)
    src = (xt if writer == "port" else xgb).DMatrix(X, **kw)
    path = str(tmp_path / "m.buffer")
    src.save_binary(path)
    jd, td = xgb.DMatrix(path), xt.DMatrix(path)
    assert_same_dmatrix(td, jd)
    assert_same_dmatrix(td, src)
    assert td.feature_types[3] == "c"


def test_dmatrix_surface_matches_jax(tmp_path):
    """``get_label`` ... ``slice`` on the same file."""
    uri, _ = _files(str(tmp_path), "libsvm_sides")
    jd, td = xgb.DMatrix(uri), xt.DMatrix(uri)
    jc, tc = jd.get_quantile_cut(), td.get_quantile_cut()
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    jcsr, tcsr = jd.get_data(), td.get_data()
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tcsr, attr),
                                      getattr(jcsr, attr))
    rows = np.asarray([3, 0, 2])
    assert_same_matrix(td.slice(rows).X, jd.slice(rows).X)
    np.testing.assert_array_equal(td.slice(rows).get_label(),
                                  jd.slice(rows).get_label())
    np.testing.assert_array_equal(td.slice(rows).get_weight(),
                                  jd.slice(rows).get_weight())
    for dm in (jd, td):
        dm.set_label([0, 1, 0, 1])
        dm.set_weight([1, 2, 3, 4])
        dm.set_base_margin([0.5, 0.5, 0, 0])
        dm.set_float_info("label_lower_bound", np.ones(4, np.float32))
    assert_same_dmatrix(td, jd)
    with pytest.raises(ValueError):
        td.get_float_info("nonsense")


def test_agaricus_cuts_and_bins_bit_for_bit():
    """One value (1.0) a feature and column 0 never present: the same
    cuts, the same two bin slots (the value and the missing slot)."""
    y, idx = agaricus_rows(500, seed=4)
    X = np.full((500, 127), np.nan, np.float32)
    X[np.arange(500)[:, None], idx] = 1.0
    cj, cp = jax_sketch(X, 256), sketch_matrix(X, 256)
    np.testing.assert_array_equal(cp.values, cj.values)
    np.testing.assert_array_equal(cp.ptrs, cj.ptrs)
    np.testing.assert_array_equal(cp.min_vals, cj.min_vals)
    bj = JaxBinned.from_dense(X, cj)
    bp = BinnedMatrix.from_dense(X, cp, torch.device("cpu"))
    assert (bp.max_nbins, bp.missing_bin) == (bj.max_nbins, bj.missing_bin) \
        == (2, 1)
    np.testing.assert_array_equal(bp.bins.numpy(), np.asarray(bj.bins))

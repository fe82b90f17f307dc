"""The port's input adapters (``xgboost_tpu_torch/data/adapters.py``)
against the JAX package's ``to_dense``, on the CPU: the same matrix (NaN
positions and values bit for bit), feature names and feature types from
numpy, lists, scipy CSR/CSC, pandas and pyarrow, through ``DMatrix`` and
through a ``DataIter``.

ROADMAP C.2's input: a DataFrame with a ``category`` column trains with
its column names and with the column's codes, and is refused without
``enable_categorical``, as in the JAX package.
"""

import numpy as np
import pytest
import scipy.sparse

import xgboost_tpu as xgb
import xgboost_tpu_torch as xt
from xgboost_tpu.data.adapters import to_dense as jax_to_dense
from xgboost_tpu_torch.data.adapters import to_dense


def assert_same_matrix(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got, nan=0.0),
                                  np.nan_to_num(want, nan=0.0))


def _c2_frame():
    pd = pytest.importorskip("pandas")
    return pd.DataFrame({"x": np.arange(6, dtype=np.float32),
                         "c": pd.Categorical([10, 20, 30, 10, 20, 30])})


def test_c2_dataframe_names_types_and_codes():
    """ROADMAP C.2: names, types ['float', 'c'] and the codes 0, 1, 2."""
    df = _c2_frame()
    jd = xgb.DMatrix(df, enable_categorical=True)
    td = xt.DMatrix(df, enable_categorical=True)
    assert td.feature_names == jd.feature_names == ["x", "c"]
    assert td.feature_types == jd.feature_types == ["float", "c"]
    assert_same_matrix(td.X, jd.X)
    np.testing.assert_array_equal(td.X[:, 1], [0, 1, 2, 0, 1, 2])


def test_c2_dataframe_refused_without_enable_categorical():
    df = _c2_frame()
    with pytest.raises(ValueError, match="enable_categorical"):
        xgb.DMatrix(df)
    with pytest.raises(ValueError, match="enable_categorical"):
        xt.DMatrix(df)


def test_c2_dataframe_trains_with_its_names():
    """The saved model carries the columns, and a frame with other
    columns is refused by ``validate_features``."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(0)
    df = pd.DataFrame({"a": rng.randn(200).astype(np.float32),
                       "b": rng.randint(0, 5, 200),
                       "c": pd.Categorical(rng.randint(0, 3, 200))})
    y = (df["a"] > 0).astype(np.float32)
    b = xt.train({"objective": "binary:logistic", "max_depth": 2,
                  "device": "cpu"},
                 xt.DMatrix(df, label=y, enable_categorical=True), 2)
    assert b.feature_names == ["a", "b", "c"]
    assert b.feature_types == ["float", "int", "c"]
    jb = xgb.Booster(model_file=b.save_raw("json"))
    assert jb.feature_names == ["a", "b", "c"]
    other = df.rename(columns={"a": "z"})
    with pytest.raises(ValueError, match="feature_names mismatch"):
        b.predict(xt.DMatrix(other, enable_categorical=True))


def _inputs(case):
    rng = np.random.RandomState(3)
    X = rng.randn(40, 6).astype(np.float32)
    X[rng.rand(40, 6) < 0.3] = 0.0
    if case in ("csr", "csc", "csr_missing_0"):
        S = scipy.sparse.random(40, 6, density=0.4, random_state=4,
                                format="csr", dtype=np.float64)
        S.data[::5] = 0.0                  # stored zeros stay values
        return (S if case != "csc" else S.tocsc()), {}
    if case == "numpy_missing":
        X[::3, 2] = -999.0
        return X, {"missing": -999.0}
    if case == "list":
        return X[:5].tolist(), {}
    if case == "vector":
        return X[:, 0], {}
    if case == "pandas":
        pd = pytest.importorskip("pandas")
        df = pd.DataFrame(X, columns=[f"col{i}" for i in range(6)])
        df["k"] = rng.randint(0, 9, 40)
        df["cat"] = pd.Categorical(
            rng.choice(["a", "b", None], 40), categories=["a", "b"])
        return df, {"missing": 0.0}
    if case == "arrow":
        pa = pytest.importorskip("pyarrow")
        codes = pa.array(rng.choice(["u", "v", "w", None], 40)) \
            .dictionary_encode()
        return pa.table({"f": pa.array(X[:, 0]),
                         "i": pa.array(rng.randint(0, 4, 40)),
                         "d": codes}), {}
    raise ValueError(case)


@pytest.mark.parametrize("case", ["csr", "csc", "csr_missing_0",
                                  "numpy_missing", "list", "vector",
                                  "pandas", "arrow"])
def test_to_dense_matches_jax(case):
    data, kw = _inputs(case)
    if case == "csr_missing_0":
        kw = {"missing": 0.0}
    got = to_dense(data, **kw)
    want = jax_to_dense(data, **kw)
    assert_same_matrix(got[0], want[0])
    assert got[1:] == want[1:]
    if case.startswith("csr"):
        # absent entries are NaN; stored zeros stay 0 even at missing=0
        dense = data.toarray().astype(np.float32)
        stored = np.zeros(data.shape, bool)
        stored[np.repeat(np.arange(40), np.diff(data.indptr)),
               data.indices] = True
        assert np.isnan(got[0][~stored]).all()
        np.testing.assert_array_equal(got[0][stored], dense[stored])
        assert (got[0][stored] == 0).any()
    jd = xgb.DMatrix(data, enable_categorical=True, **kw)
    td = xt.DMatrix(data, enable_categorical=True, **kw)
    assert_same_matrix(td.X, jd.X)
    assert (td.feature_names, td.feature_types) == \
        (jd.feature_names, jd.feature_types)


def test_iterator_batches_of_frames_carry_their_names():
    """A DataIter's DataFrame batches go through the adapter too."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(5)
    frames = [pd.DataFrame(rng.randn(100, 3).astype(np.float32),
                           columns=["p", "q", "r"]) for _ in range(2)]

    class It(xt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def next(self, input_data):
            if self.i == len(frames):
                return 0
            input_data(data=frames[self.i],
                       label=np.zeros(100, np.float32))
            self.i += 1
            return 1

        def reset(self):
            self.i = 0

    dm = xt.QuantileDMatrix(It(), max_bin=16)
    assert dm.feature_names == ["p", "q", "r"]
    assert dm.num_row() == 200

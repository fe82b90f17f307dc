"""Input adapters: every supported input to one dense float32 matrix
with NaN for missing (the JAX package's ``data/adapters.py``; reference
``src/data/adapter.h``).

- pyarrow tables and record batches: a dictionary column becomes its
  codes with feature type ``"c"``, nulls NaN;
- pandas DataFrames: the columns are the feature names, a ``category``
  column becomes its codes (type ``"c"``, code -1 NaN), an integer
  column type ``"int"``, any other ``"float"``;
- scipy sparse matrices (CSR, CSC, ...): absent entries are missing,
  stored entries keep their values (a stored 0 stays 0), and ``missing``
  is not applied to them;
- numpy arrays and lists: ``missing`` mapped to NaN.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np


def to_dense(data: Any, missing: float = np.nan,
             feature_names: Optional[List[str]] = None,
             feature_types: Optional[List[str]] = None,
             ) -> Tuple[np.ndarray, Optional[List[str]], Optional[List[str]]]:
    """-> (X [n, F] f32 with NaN missing, feature_names, feature_types);
    the names and types given win over those the input carries."""
    if hasattr(data, "schema") and hasattr(data, "column_names"):
        return _from_arrow(data, missing, feature_names, feature_types)
    if hasattr(data, "dtypes") and hasattr(data, "columns"):
        return _from_pandas(data, missing, feature_names, feature_types)
    if hasattr(data, "tocsr") and hasattr(data, "nnz"):
        csr = data.tocsr()
        X = np.full(csr.shape, np.nan, dtype=np.float32)
        rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
        X[rows, csr.indices] = csr.data.astype(np.float32)
        return X, feature_names, feature_types
    X = np.asarray(data, dtype=np.float32)
    if X.ndim == 1:
        X = X[:, None]
    return _mask_missing(X, missing), feature_names, feature_types


def _from_arrow(data, missing, feature_names, feature_types):
    import pyarrow as pa

    names = [str(c) for c in data.column_names]
    types: List[str] = []
    cols = []
    for i in range(len(names)):
        col = data.column(i)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if pa.types.is_dictionary(col.type):
            codes = col.indices.to_numpy(zero_copy_only=False).astype(
                np.float32)
            if col.null_count:
                codes[col.is_null().to_numpy(zero_copy_only=False)] = np.nan
            cols.append(codes)
            types.append("c")
        else:
            cols.append(col.to_numpy(zero_copy_only=False).astype(
                np.float32))
            types.append("int" if pa.types.is_integer(col.type)
                         else "float")
    X = np.stack(cols, axis=1) if cols else np.empty((0, 0), np.float32)
    return (_mask_missing(X, missing), feature_names or names,
            feature_types or types)


def _from_pandas(data, missing, feature_names, feature_types):
    import pandas as pd

    names = [str(c) for c in data.columns]
    types: List[str] = []
    cols = []
    for c in data.columns:
        col = data[c]
        if isinstance(col.dtype, pd.CategoricalDtype):
            codes = col.cat.codes.to_numpy().astype(np.float32)
            codes[codes < 0] = np.nan
            cols.append(codes)
            types.append("c")
        else:
            cols.append(col.to_numpy().astype(np.float32))
            types.append("int" if np.issubdtype(col.dtype, np.integer)
                         else "float")
    X = np.stack(cols, axis=1)
    return (_mask_missing(X, missing), feature_names or names,
            feature_types or types)


def _mask_missing(X: np.ndarray, missing: float) -> np.ndarray:
    if missing is not None and not np.isnan(missing):
        X = X.copy()
        X[X == missing] = np.nan
    return X

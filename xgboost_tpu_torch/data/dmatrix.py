"""Data matrices: a dense in-memory matrix (reference ``SimpleDMatrix``),
and matrices built from a :class:`DataIter` (reference
``IterativeDMatrix`` / ``SparsePageDMatrix``).

A :class:`DMatrix` made from numpy keeps its raw values (``missing``
mapped to NaN), labels, sample weights, feature names and a per-row
base margin, and its quantized form for training, built once per
``(max_bin, device)`` and cached. One made from a :class:`DataIter`
(the JAX package's ``DMatrix._init_from_iter``) never holds the raw
matrix whole: pass 1 sketches each batch (sampled to a quarter of
``SKETCH_SAMPLE_ROWS`` when unweighted) and merges the summaries (under
a multi-rank communicator across the ranks too, with the missing slot
and the categorical codes' range agreed); pass 2 bins each batch into
a preallocated host array, or, under the iterator's ``cache_prefix``,
a memmap at ``<cache_prefix>.bins`` that trains as a
:class:`~.binned.PagedBinnedMatrix` (external memory) in pages of
``XTPU_PAGE_ROWS`` rows (default 1,000,000). Such a matrix is
quantized once, at ``max_bin``; training asks for the same ``max_bin``.

``feature_types`` marks categorical features with ``"c"`` (their values
are category codes, NaN missing), which a matrix takes only with
``enable_categorical=True``, as the JAX package's; an iterator's
batches announce them with ``feature_types`` (on any batch: the cuts
cover every batch's largest code).

:meth:`DMatrix.append` adds rows in place, binned against the frozen
cuts when the matrix is quantized (a paged matrix's memmap grows), and
chains a CRC over each append that ``utils/checkpoint.py
dmatrix_fingerprint`` reads.

Query groups (ranking): ``group=`` (the size of each query, in row
order) or ``qid=`` (each row's query id, sorted) set
``MetaInfo.group_ptr``, the [G + 1] offsets of the queries' rows; so do
``set_group`` / ``set_info(group=)`` / ``set_uint_info("group_ptr")`` and
an iterator's ``qid`` or ``group`` batches. A ranking matrix may carry
one weight a query (length G) instead of one a row.

Inputs go through ``data/adapters.py to_dense`` (numpy, lists, scipy
sparse, pandas, pyarrow); a path or URI through ``data/fileio.py
load_uri`` (libsvm, CSV/TSV, or a ``save_binary`` container, whose npz
the JAX package reads and writes too). ``label_lower_bound`` /
``label_upper_bound`` (``survival:aft``'s intervals) come through the
constructor, a file, ``set_info`` / ``set_float_info``, an iterator's
batches, ``slice`` and ``save_binary``.
"""

from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..logging_utils import logger
from .adapters import to_dense
from .binned import (BinnedMatrix, PagedBinnedMatrix, np_dtype_for,
                     search_bin, values_of_bins)
from .quantile import (FeatureSummary, HistogramCuts, cuts_from_summaries,
                       sketch_matrix)
from . import quantile


@dataclass
class MetaInfo:
    labels: Optional[np.ndarray] = None        # [n] or [n, n_targets] f32
    weights: Optional[np.ndarray] = None       # [n], or [G] a query, f32
    base_margin: Optional[np.ndarray] = None   # [n] or [n, n_groups]
    group_ptr: Optional[np.ndarray] = None     # [G + 1] int64 query offsets
    label_lower_bound: Optional[np.ndarray] = None  # [n] f32 (survival)
    label_upper_bound: Optional[np.ndarray] = None
    # "row": each rank holds its rows, whose metric sums add across ranks
    # (``metric/base.py global_mean``); "col": every rank holds every row
    data_split_mode: str = "row"
    feature_names: Optional[List[str]] = None
    feature_types: Optional[List[str]] = None

    def set_group(self, sizes: Any) -> None:
        """Query offsets from the size of each query, in row order."""
        self.group_ptr = np.concatenate(
            [[0], np.cumsum(np.asarray(sizes, dtype=np.int64))]).astype(
                np.int64)

    def set_qid(self, qid: Any) -> None:
        """Query offsets from each row's query id (sorted ascending)."""
        qid = np.asarray(qid)
        if np.any(qid[1:] < qid[:-1]):
            raise ValueError("qid must be sorted")
        self.set_group(np.unique(qid, return_counts=True)[1])

    def row_weights(self) -> Optional[np.ndarray]:
        """The weights one a row: a query's weight repeated over its rows
        when there is one weight a query."""
        w = self.weights
        ptr = self.group_ptr
        if w is None or ptr is None or len(w) == int(ptr[-1]) \
                or len(w) != len(ptr) - 1:
            return w
        return np.repeat(w, np.diff(ptr))

    def validate(self, n: int) -> None:
        for name in ("label_lower_bound", "label_upper_bound"):
            v = getattr(self, name)
            if v is not None and v.shape[0] != n:
                raise ValueError(f"{name} has {v.shape[0]} entries, "
                                 f"expected {n}")
        if self.group_ptr is None:
            if self.weights is not None and len(self.weights) != n:
                raise ValueError(f"weight has {len(self.weights)} entries, "
                                 f"expected {n}")
            return
        ptr = self.group_ptr
        if ptr[0] != 0 or int(ptr[-1]) != n or np.any(np.diff(ptr) < 0):
            raise ValueError(f"the query groups must cover all {n} rows in "
                             f"order (group_ptr ends at {int(ptr[-1])})")
        if self.weights is not None and \
                len(self.weights) not in (n, len(ptr) - 1):
            raise ValueError(
                f"weight has {len(self.weights)} entries, expected {n} (one "
                f"a row) or {len(ptr) - 1} (one a query)")


def _rows(name: str, value: Any, n: int) -> np.ndarray:
    arr = np.array(value, dtype=np.float32)     # owned, writable
    if arr.shape[0] != n:
        raise ValueError(f"{name} has {arr.shape[0]} entries, expected {n}")
    return arr


def _dense(data: Any, missing: float, feature_names=None,
           feature_types=None):
    """``to_dense``: (X [n, F] f32 with NaN missing, feature_names,
    feature_types)."""
    X, names, types = to_dense(data, missing, feature_names, feature_types)
    if X.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {X.shape}")
    return X, names, types


def _load_path(path: str, kw: Dict[str, Any]) -> np.ndarray:
    """``DMatrix(path)``: the file's matrix; the keywords the caller left
    None take what the file (or its side files) gives."""
    from .fileio import load_uri

    loaded = load_uri(path)
    for key in ("label", "weight", "base_margin", "label_lower_bound",
                "label_upper_bound", "feature_names"):
        if kw[key] is None:
            kw[key] = loaded.get(key)
    if kw["group"] is None and kw["qid"] is None:
        kw["group"] = loaded.get("group")
        if kw["group"] is None:
            kw["qid"] = loaded.get("qid")
    if kw["feature_types"] is None:
        kw["feature_types"] = loaded.get("feature_types")
        if kw["feature_types"] is not None and "c" in kw["feature_types"]:
            kw["enable_categorical"] = True
    return loaded["X"]


class DataIter:
    """External-memory data iterator (reference ``DataIter``): a subclass
    implements ``next(input_data)``, which calls ``input_data(data=...,
    label=..., weight=..., base_margin=...)`` for one batch and returns
    1, or returns 0 at the end, and ``reset()``. ``cache_prefix`` asks
    for the external-memory tier: the bins in a memmap at
    ``<cache_prefix>.bins``, streamed to the device in pages."""

    def __init__(self, cache_prefix: Optional[str] = None) -> None:
        self.cache_prefix = cache_prefix

    def next(self, input_data) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def collect(self) -> Iterator[dict]:
        """Drive the callback protocol from a reset, yielding each batch's
        keyword dict; resets again at the end. A ``next()`` that raises
        (a transient read failure of the batch source) is retried with
        backoff before the error propagates (:func:`_retry_io`, the JAX
        package's); each retry calls ``next`` with a fresh collector, so
        a partly delivered batch is dropped, not duplicated."""
        self.reset()
        while True:
            batches: List[dict] = []

            def step() -> int:
                batches.clear()
                return self.next(lambda **kw: batches.append(kw))

            if not _retry_io(step, "data iterator next()"):
                break
            yield from batches
        self.reset()


def _retry_io(fn, what: str, attempts: Optional[int] = None,
              base_delay_s: float = 0.05):
    """Bounded retry with exponential backoff (the JAX package's
    ``_retry_io``): ``XTPU_IO_RETRIES`` (2) retries, each logged; the
    last failure re-raises the original error."""
    if attempts is None:
        attempts = int(os.environ.get("XTPU_IO_RETRIES", "2"))
    for a in range(attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - re-raised on exhaustion
            if a >= attempts:
                raise
            delay = base_delay_s * (2.0 ** a)
            logger.warning("%s failed (%s); retry %d/%d in %.0f ms",
                           what, e, a + 1, attempts, delay * 1e3)
            time.sleep(delay)


# get_float_info / set_float_info fields -> MetaInfo attributes
_FLOAT_FIELDS = {"label": "labels", "weight": "weights",
                 "base_margin": "base_margin",
                 "label_lower_bound": "label_lower_bound",
                 "label_upper_bound": "label_upper_bound"}


class DMatrix:
    """Dense float32 feature matrix with NaN for missing entries, or a
    matrix built from a :class:`DataIter` (module docstring). ``data``
    may be a path or URI (``data/fileio.py``). ``data_split_mode``:
    ``"row"``, or ``"col"`` for a vertical party's block of features of
    every row (its ``MetaInfo`` flag keeps the metrics' and the
    iterator's reductions off the ranks, whose rows are the same)."""

    _data_split_mode = "row"    # subclasses with their own __init__ too

    def __init__(self, data: Any, label: Any = None, *, weight: Any = None,
                 base_margin: Any = None, missing: float = np.nan,
                 feature_names: Optional[List[str]] = None,
                 feature_types: Optional[List[str]] = None,
                 group: Any = None, qid: Any = None,
                 label_lower_bound: Any = None,
                 label_upper_bound: Any = None,
                 enable_categorical: bool = False,
                 max_bin: int = 256, data_split_mode: str = "row") -> None:
        if data_split_mode not in ("row", "col"):
            raise ValueError(f"unknown data_split_mode: {data_split_mode}")
        self._data_split_mode = data_split_mode
        self._binned: Dict[tuple, BinnedMatrix] = {}
        self._cuts: Dict[int, HistogramCuts] = {}
        # iterator-built: the host bins (array, or paged) and their max_bin
        self._quantized = None
        self._max_bin: Optional[int] = None
        if isinstance(data, DataIter):
            self._init_from_iter(data, max_bin, None, missing,
                                 data.cache_prefix)
            return
        if isinstance(data, (str, os.PathLike)):
            kw = dict(label=label, weight=weight, base_margin=base_margin,
                      group=group, qid=qid,
                      label_lower_bound=label_lower_bound,
                      label_upper_bound=label_upper_bound,
                      feature_names=feature_names,
                      feature_types=feature_types,
                      enable_categorical=enable_categorical)
            data = _load_path(str(data), kw)
            (label, weight, base_margin, group, qid, label_lower_bound,
             label_upper_bound, feature_names, feature_types,
             enable_categorical) = kw.values()
        self.X, feature_names, feature_types = _dense(
            data, missing, feature_names, feature_types)
        self._n_rows = self.X.shape[0]
        self.info = MetaInfo(data_split_mode=self._data_split_mode)
        self.feature_names = feature_names
        self.feature_types = feature_types
        if not enable_categorical and feature_types is not None \
                and "c" in self.feature_types:
            raise ValueError(
                "categorical features present; pass enable_categorical=True")
        n = self.num_row()
        if label is not None:
            self.info.labels = self._labels(label, n)
        if weight is not None:
            self.info.weights = np.array(weight, dtype=np.float32)
        if base_margin is not None:
            self.info.base_margin = _rows("base_margin", base_margin, n)
        for key, v in (("label_lower_bound", label_lower_bound),
                       ("label_upper_bound", label_upper_bound)):
            if v is not None:
                setattr(self.info, key, np.asarray(v, np.float32))
        if group is not None:
            self.info.set_group(group)
        elif qid is not None:
            self.info.set_qid(qid)
        self.info.validate(n)

    @staticmethod
    def _labels(label: Any, n: int) -> np.ndarray:
        """[n] labels, or [n, K] for K targets (a one-column matrix
        stays [n])."""
        lab = _rows("label", label, n)
        if lab.ndim == 2 and lab.shape[1] == 1:
            lab = lab[:, 0]
        if lab.ndim not in (1, 2):
            raise ValueError(f"label must be [n] or [n, n_targets], got "
                             f"shape {lab.shape}")
        return lab

    def num_row(self) -> int:
        return self._n_rows

    def num_col(self) -> int:
        if self.X is not None:
            return self.X.shape[1]
        return self._quantized.shape[1]

    @property
    def feature_names(self) -> Optional[List[str]]:
        return self.info.feature_names

    @feature_names.setter
    def feature_names(self, names: Optional[List[str]]) -> None:
        if names is not None:
            names = [str(n) for n in names]
            if len(names) != self.num_col():
                raise ValueError(
                    f"feature_names has {len(names)} entries, "
                    f"expected {self.num_col()}")
            if len(set(names)) != len(names):
                raise ValueError("feature_names must be unique")
        self.info.feature_names = names

    @property
    def feature_types(self) -> Optional[List[str]]:
        return self.info.feature_types

    @feature_types.setter
    def feature_types(self, types: Optional[List[str]]) -> None:
        """One type a feature (``"c"`` categorical; a single string is
        every feature's)."""
        if types is not None:
            if isinstance(types, str):
                types = [types] * self.num_col()
            types = list(types)
            if len(types) != self.num_col():
                raise ValueError(
                    f"feature_types has {len(types)} entries, "
                    f"expected {self.num_col()}")
        self.info.feature_types = types

    def num_nonmissing(self) -> int:
        """Present (non-NaN) entries; for an iterator-built matrix, the
        bins other than the missing bin."""
        if self.X is not None:
            return int(np.count_nonzero(~np.isnan(self.X)))
        if not self._has_missing:
            return self.num_row() * self.num_col()
        bins = (self._quantized.bins_host if self.is_paged
                else self._quantized)
        return int(np.count_nonzero(bins != self._max_nbins - 1))

    @property
    def shape(self):
        return (self.num_row(), self.num_col())

    # -- meta information (the JAX package's set_info / get_group / ...)
    def set_info(self, **kwargs: Any) -> None:
        """Set ``label``, ``weight``, ``base_margin``, ``group``,
        ``label_lower_bound`` or ``label_upper_bound``."""
        n = self.num_row()
        for k, v in kwargs.items():
            if k == "group":
                self.info.set_group(v)
            elif k == "label":
                self.info.labels = self._labels(v, n)
            elif k == "weight":
                self.info.weights = np.array(v, dtype=np.float32)
            elif k == "base_margin":
                self.info.base_margin = _rows("base_margin", v, n)
            elif k in ("label_lower_bound", "label_upper_bound"):
                setattr(self.info, k, np.array(v, dtype=np.float32))
            else:
                raise ValueError(f"unknown meta field: {k}")
        self.info.validate(n)

    def get_float_info(self, field: str) -> np.ndarray:
        """A float field; an unset one as an empty array."""
        if field not in _FLOAT_FIELDS:
            raise ValueError(f"unknown float field: {field}")
        v = getattr(self.info, _FLOAT_FIELDS[field])
        return (np.empty(0, np.float32) if v is None
                else np.asarray(v, np.float32))

    def set_float_info(self, field: str, data: Any) -> None:
        if field not in _FLOAT_FIELDS:
            raise ValueError(f"unknown float field: {field}")
        self.set_info(**{field: data})

    def get_label(self) -> Optional[np.ndarray]:
        return self.info.labels

    def get_weight(self) -> np.ndarray:
        return self.get_float_info("weight")

    def get_base_margin(self) -> np.ndarray:
        return self.get_float_info("base_margin")

    def set_label(self, label: Any) -> None:
        self.set_info(label=label)

    def set_weight(self, weight: Any) -> None:
        self.set_info(weight=weight)

    def set_base_margin(self, margin: Any) -> None:
        self.set_info(base_margin=margin)

    def set_group(self, group: Any) -> None:
        self.set_info(group=group)

    def get_group(self) -> np.ndarray:
        """The size of each query (inverse of ``set_group``)."""
        ptr = self.info.group_ptr
        return (np.empty(0, np.int64) if ptr is None
                else np.diff(np.asarray(ptr, np.int64)))

    def get_uint_info(self, field: str) -> np.ndarray:
        if field != "group_ptr":
            raise ValueError(f"unknown uint field: {field}")
        v = self.info.group_ptr
        return np.empty(0, np.uint32) if v is None else np.asarray(
            v, np.uint32)

    def set_uint_info(self, field: str, data: Any) -> None:
        if field != "group_ptr":
            raise ValueError(f"unknown uint field: {field}")
        self.info.group_ptr = np.asarray(data, np.int64)
        self.info.validate(self.num_row())

    def _require_raw(self, what: str) -> None:
        if self.X is None:
            raise ValueError(f"{what} needs raw data; a matrix built from an "
                             "iterator holds only its bins")

    def get_data(self):
        """The features as a scipy CSR matrix, missing entries absent."""
        import scipy.sparse

        self._require_raw("get_data")
        present = ~np.isnan(self.X)
        indptr = np.concatenate(
            [[0], np.cumsum(present.sum(axis=1))]).astype(np.int64)
        indices = np.nonzero(present)[1].astype(np.int32)
        return scipy.sparse.csr_matrix(
            (self.X[present], indices, indptr), shape=self.X.shape)

    def save_binary(self, fname: str, silent: bool = True) -> None:
        """Write this matrix for ``DMatrix(fname)``: the JAX package's npz
        container (``X`` and the meta fields under their MetaInfo
        names)."""
        self._require_raw("save_binary")
        payload = {"X": self.X}
        for attr in ("labels", "weights", "base_margin", "group_ptr",
                     "label_lower_bound", "label_upper_bound"):
            v = getattr(self.info, attr)
            if v is not None:
                payload[attr] = v
        for attr in ("feature_names", "feature_types"):
            v = getattr(self.info, attr)
            if v is not None:
                payload[attr] = np.asarray(v)
        with open(fname, "wb") as fh:
            np.savez(fh, **payload)

    def get_quantile_cut(self, max_bin: int = 256):
        """-> (ptrs [F + 1] int64, values f32): the cuts this matrix was
        last binned with (those the trained trees' split bins index);
        sketched at ``max_bin`` when it has none yet."""
        if self._cuts:
            cuts = list(self._cuts.values())[-1]
        else:
            cuts = self.cuts(max_bin)
        return (np.asarray(cuts.ptrs, np.int64),
                np.asarray(cuts.values, np.float32))

    def append(self, data: Any, label: Any = None, *, weight: Any = None,
               missing: float = np.nan) -> int:
        """Append rows in place (the JAX package's ``append``): a quantized
        form already made grows against its cuts, which stay frozen so
        that the trees' split bins keep their meaning (a paged matrix's
        memmap grows, ``PagedBinnedMatrix.append_rows``); labels and
        weights are replaced by new arrays; the append chain, a CRC over
        each append's features and labels chained over the appends, moves
        (``utils/checkpoint.py dmatrix_fingerprint``). Returns the new row
        count."""
        X = np.ascontiguousarray(to_dense(data, missing, None, None)[0],
                                 np.float32)
        if X.shape[1] != self.num_col():
            raise ValueError(
                f"append expects {self.num_col()} features, got {X.shape[1]}")
        info = self.info
        for name in ("base_margin", "group_ptr", "label_lower_bound",
                     "label_upper_bound"):
            if getattr(info, name) is not None:
                raise ValueError(
                    f"append does not support matrices carrying {name}")
        n_new = X.shape[0]
        y = w = None
        if label is not None:
            y = np.asarray(label, np.float32)
            if y.shape[0] != n_new:
                raise ValueError(
                    f"label has {y.shape[0]} entries, expected {n_new}")
        elif info.labels is not None:
            raise ValueError(
                "matrix has labels; append needs label= for the new rows")
        if weight is not None:
            w = np.asarray(weight, np.float32)
        elif info.weights is not None:
            raise ValueError(
                "matrix has weights; append needs weight= for the new rows")
        # the quantized form first: it may refuse the rows (NaN into a
        # layout without a missing slot) before anything has changed
        if self.is_paged:
            self._quantized.append_rows(X)
        elif self._quantized is not None:
            self._quantized = np.concatenate(
                [self._quantized, self._bin_rows(
                    X, self._cuts[self._max_bin], self._max_nbins,
                    self._has_missing, self._quantized.dtype)])
            self._binned.clear()
        else:
            for key, bm in list(self._binned.items()):
                self._binned[key] = BinnedMatrix(
                    bins=torch.cat([bm.bins, torch.from_numpy(self._bin_rows(
                        X, bm.cuts, bm.max_nbins, bm.has_missing,
                        np_dtype_for(max(bm.max_nbins - 1, 0)))).to(
                            bm.bins.device)]),
                    cuts=bm.cuts, max_nbins=bm.max_nbins,
                    has_missing=bm.has_missing)
        if self.X is not None:
            self.X = np.concatenate([self.X, X], axis=0)
        self._n_rows += n_new
        if y is not None:
            info.labels = (self._labels(y, n_new) if info.labels is None
                           else np.concatenate([info.labels, y], axis=0))
        if w is not None:
            info.weights = (np.array(w) if info.weights is None
                            else np.concatenate([info.weights, w]))
        crc = zlib.crc32(X.tobytes(), getattr(self, "_append_chain", 0))
        if y is not None:
            crc = zlib.crc32(np.ascontiguousarray(y).tobytes(), crc)
        self._append_chain = crc
        self._n_appends = getattr(self, "_n_appends", 0) + 1
        info.validate(self.num_row())
        return self.num_row()

    @staticmethod
    def _bin_rows(X: np.ndarray, cuts: HistogramCuts, max_nbins: int,
                  has_missing: bool, dtype) -> np.ndarray:
        """Host bin ids of new rows against frozen cuts."""
        if not has_missing and np.isnan(X).any():
            raise ValueError(
                "appended rows contain missing values but the quantized "
                "matrix has no missing slot; rebuild from data that "
                "includes missing values")
        return search_bin(torch.from_numpy(X), cuts,
                          max_nbins - 1).numpy().astype(dtype)

    def slice(self, rindex: Any) -> "DMatrix":
        """The rows ``rindex`` with their labels, weights, base margins
        and bounds (query groups are not carried)."""
        self._require_raw("slice")
        rindex = np.asarray(rindex)
        out = DMatrix(self.X[rindex])
        info = self.info

        def rows(v):
            return None if v is None else v[rindex]

        out.info = MetaInfo(
            labels=rows(info.labels), weights=rows(info.weights),
            base_margin=rows(info.base_margin),
            label_lower_bound=rows(info.label_lower_bound),
            label_upper_bound=rows(info.label_upper_bound),
            feature_names=info.feature_names,
            feature_types=info.feature_types,
            data_split_mode=info.data_split_mode)
        return out

    @property
    def paged(self) -> Optional[PagedBinnedMatrix]:
        """The host bins of an external-memory matrix, else None."""
        return self._quantized if self.is_paged else None

    @property
    def is_paged(self) -> bool:
        """Built from an iterator with a ``cache_prefix``: the bins stay in
        host memory and stream to the device in pages."""
        return isinstance(self._quantized, PagedBinnedMatrix)

    def values(self) -> np.ndarray:
        """The raw [n, F] float32 features, NaN where missing; for an
        iterator-built matrix, which keeps no raw values, each bin's
        representative value (its upper cut), page by page on the host."""
        if self.X is not None:
            return self.X
        if self.is_paged:
            return self._quantized.to_values_host()
        return values_of_bins(self._quantized, self._cuts[self._max_bin])

    def cuts(self, max_bin: int) -> HistogramCuts:
        """The cuts this matrix bins with at ``max_bin`` (sketched once)."""
        if self._quantized is not None:
            self._require_max_bin(max_bin)
        elif max_bin not in self._cuts:
            self._cuts[max_bin] = sketch_matrix(
                self.X, max_bin, self.info.row_weights(),
                self.info.feature_types)
        return self._cuts[max_bin]

    def _require_max_bin(self, max_bin: int) -> None:
        if max_bin != self._max_bin:
            raise ValueError(
                f"this matrix was quantized from an iterator at max_bin="
                f"{self._max_bin}; train it with max_bin={self._max_bin}, "
                f"or rebuild it at max_bin={max_bin}")

    def binned(self, max_bin: int, device: torch.device):
        """The quantized matrix for training on ``device``: a
        :class:`~.binned.PagedBinnedMatrix` (host memory) when paged, else
        a :class:`~.binned.BinnedMatrix` on ``device``, built once and
        cached."""
        if self.is_paged:
            self._require_max_bin(max_bin)
            return self._quantized
        key = (max_bin, str(device))
        bm = self._binned.get(key)
        if bm is None:
            if self._quantized is not None:
                self._require_max_bin(max_bin)
                q = self._quantized
                bm = BinnedMatrix.from_local_bins(
                    q, self._cuts[max_bin], self._max_nbins,
                    self._has_missing, device)
            else:
                bm = BinnedMatrix.from_dense(self.X, self.cuts(max_bin),
                                             device)
            self._binned[key] = bm
        return bm

    def _init_from_iter(self, it: DataIter, max_bin: int,
                        ref: Optional["DMatrix"], missing: float,
                        cache_prefix: Optional[str]) -> None:
        """The two passes over ``it`` (module docstring); ``ref``: take its
        cuts at ``max_bin`` instead of sketching."""
        labels, weights, margins, qids, groups = [], [], [], [], []
        lbound, ubound = [], []
        summaries: Optional[List[FeatureSummary]] = None
        n_rows = n_feat = 0
        has_missing = False
        feature_names = feature_types = None
        cat_max: Optional[np.ndarray] = None    # each feature's largest code
        cap = quantile.SKETCH_SAMPLE_ROWS // 4
        for batch in it.collect():
            X, names, types = _dense(batch["data"], missing,
                                     batch.get("feature_names"),
                                     batch.get("feature_types"))
            n_rows += X.shape[0]
            n_feat = X.shape[1]
            has_missing = has_missing or bool(np.isnan(X).any())
            if names is not None:
                feature_names = list(names)
            if types is not None:
                feature_types = list(types)
            if ref is None:
                # the codes of every batch, the ones before the types were
                # announced too (the sketch's sample may skip the largest)
                top = np.fmax.reduce(X, axis=0, initial=-np.inf)
                cat_max = top if cat_max is None else np.fmax(cat_max, top)
            for key, dest in (("label", labels), ("weight", weights),
                              ("base_margin", margins),
                              ("label_lower_bound", lbound),
                              ("label_upper_bound", ubound)):
                if batch.get(key) is not None:
                    dest.append(np.asarray(batch[key], dtype=np.float32))
            if batch.get("qid") is not None:
                qids.append(np.asarray(batch["qid"]))
            if batch.get("group") is not None:
                groups.append(np.asarray(batch["group"], np.int64))
            if ref is None:
                bw = batch.get("weight")
                ws = None if bw is None else np.asarray(bw, np.float64)
                Xs = X
                if bw is None and cap and X.shape[0] > cap:
                    Xs = X[::-(-X.shape[0] // cap)]
                part = [FeatureSummary.from_data(Xs[:, f], ws)
                        for f in range(Xs.shape[1])]
                summaries = part if summaries is None else [
                    a.merge(b).prune(max_bin * 8)
                    for a, b in zip(summaries, part)]
        self.X = None
        self._n_rows = n_rows
        self.info = MetaInfo(data_split_mode=self._data_split_mode)
        if labels:
            self.info.labels = self._labels(np.concatenate(labels), n_rows)
        if weights:
            self.info.weights = _rows("weight", np.concatenate(weights),
                                      n_rows)
        if margins:
            self.info.base_margin = _rows(
                "base_margin", np.concatenate(margins), n_rows)
        for key, parts in (("label_lower_bound", lbound),
                           ("label_upper_bound", ubound)):
            if parts:
                setattr(self.info, key, np.concatenate(parts))
        if qids and groups:
            raise ValueError("the iterator gave both qid and group batches")
        if qids:
            self.info.set_qid(np.concatenate(qids))
        elif groups:
            self.info.set_group(np.concatenate(groups))
        self.info.validate(n_rows)
        from ..parallel import collective

        row_split = self._data_split_mode == "row"
        if collective.is_distributed() and row_split:
            # multi-process external memory: every process streams ITS
            # rows; the cuts come from the summary merge across the ranks
            # and the missing slot must agree everywhere (reference: the
            # sketch sync inside QuantileDMatrix under rabit,
            # src/common/quantile.cc:147-276). Every rank must give at
            # least one batch (the collectives are symmetric).
            if ref is None:
                summaries = collective.merge_summaries(summaries or [],
                                                       max_bin)
            has_missing = bool(int(collective.allreduce(
                np.asarray([int(has_missing)], np.int64), op="max")[0]))
        if ref is not None:
            cuts = ref.cuts(max_bin)
        else:
            if feature_types is not None and summaries is not None:
                if collective.is_distributed() and row_split:
                    cat_max = collective.allreduce(
                        np.asarray(cat_max, np.float32), op="max")
                # a categorical feature's cuts read only its largest code
                for f, t in enumerate(feature_types):
                    if t == "c" and f < len(summaries):
                        summaries[f] = FeatureSummary.from_data(np.asarray(
                            [0.0, max(float(cat_max[f]), 0.0)], np.float32))
            cuts = cuts_from_summaries(summaries or [], max_bin,
                                       feature_types)

        # pass 2: bin each batch into one preallocated host matrix
        max_nbins = int(cuts.n_real_bins().max(initial=0)) + int(has_missing)
        dtype = np_dtype_for(max(max_nbins - 1, 0))
        if cache_prefix:
            local = np.memmap(f"{cache_prefix}.bins", mode="w+",
                              dtype=dtype, shape=(n_rows, n_feat))
        else:
            local = np.empty((n_rows, n_feat), dtype)
        row = 0
        for batch in it.collect():
            X = _dense(batch["data"], missing)[0]
            local[row:row + X.shape[0]] = search_bin(
                torch.from_numpy(np.ascontiguousarray(X)), cuts,
                max_nbins - 1).numpy()
            row += X.shape[0]
        if row != n_rows:
            raise ValueError(f"the iterator gave {row} rows in its second "
                             f"pass, {n_rows} in its first")
        self._cuts[max_bin] = cuts
        self._max_bin = max_bin
        self._max_nbins = max_nbins
        self._has_missing = has_missing
        if cache_prefix:
            self._quantized = PagedBinnedMatrix(
                bins_host=local, cuts=cuts, max_nbins=max_nbins,
                has_missing=has_missing,
                page_rows=max(int(os.environ.get("XTPU_PAGE_ROWS",
                                                 1_000_000)), 1))
        else:
            self._quantized = local
        self.feature_names = feature_names
        self.feature_types = feature_types


class QuantileDMatrix(DMatrix):
    """A matrix quantized at ``max_bin`` when it is made (reference
    ``QuantileDMatrix``): from a :class:`DataIter` (two passes, the raw
    values not kept) or from an array; ``ref``: another matrix whose cuts
    it bins with (a validation set shares the training set's cuts)."""

    def __init__(self, data: Any, label: Any = None, *, max_bin: int = 256,
                 ref: Optional[DMatrix] = None, missing: float = np.nan,
                 weight: Any = None, base_margin: Any = None,
                 feature_names: Optional[List[str]] = None,
                 feature_types: Optional[List[str]] = None,
                 group: Any = None, qid: Any = None,
                 enable_categorical: bool = False,
                 data_split_mode: str = "row") -> None:
        self.max_bin = max_bin
        self._data_split_mode = data_split_mode
        if isinstance(data, DataIter):
            self._binned, self._cuts = {}, {}
            self._quantized, self._max_bin = None, None
            self._init_from_iter(data, max_bin, ref, missing,
                                 data.cache_prefix)
            return
        super().__init__(data, label, weight=weight, base_margin=base_margin,
                         missing=missing, feature_names=feature_names,
                         feature_types=feature_types, group=group, qid=qid,
                         enable_categorical=enable_categorical,
                         data_split_mode=data_split_mode)
        if ref is not None:
            self._cuts[max_bin] = ref.cuts(max_bin)

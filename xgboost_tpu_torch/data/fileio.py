"""File loading for ``DMatrix(path)``: libsvm and CSV/TSV text, and the
``save_binary`` container (the JAX package's ``data/fileio.py``;
reference ``DMatrix::Load``, ``src/data/data.cc``).

A URI is ``path[?format=libsvm|csv[&label_column=k]][#cache]``; without
``format`` a ``.csv`` / ``.tsv`` path is CSV and anything else libsvm,
and the ``#cache`` suffix is accepted and dropped. Entries absent from a
libsvm line are missing (NaN), as the reference's sparse semantics
have it; a ``qid:`` token sets the row's query. The side files
``<path>.group``, ``<path>.weight`` and ``<path>.base_margin`` attach
query sizes, weights and base margins. A file that begins with the zip
magic ``PK`` is a ``save_binary`` npz and loads as such, whatever its
name.

Text is parsed by the port's copy of the JAX package's multi-threaded
C++ parser (``csrc/text_parser.cc``, built for the host with ``g++`` at
first use, :func:`_parse_native`); a failed build raises with the
compiler's log. :func:`_parse_python` is its plain version, which the
tests hold it against.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, Tuple
from urllib.parse import parse_qs

import numpy as np


def parse_uri(uri: str) -> Tuple[str, str, int]:
    """-> (path, format, label_column)."""
    rest = uri.split("#", 1)[0]
    fmt = "auto"
    label_column = 0
    if "?" in rest:
        rest, query = rest.split("?", 1)
        q = parse_qs(query)
        fmt = q.get("format", ["auto"])[0]
        label_column = int(q.get("label_column", ["0"])[0])
    if fmt == "auto":
        ext = os.path.splitext(rest)[1].lower()
        fmt = "csv" if ext in (".csv", ".tsv") else "libsvm"
    return rest, fmt, label_column


_C_ARRAYS = (np.int64, np.int32, np.float32, np.float32, np.float32)


def _parse_native(path: str, csv: bool, sep: str):
    """:func:`_parse_python`'s result from ``csrc/text_parser.cc``: the
    file split at newlines into one chunk a thread (one thread below
    1 MiB), each chunk's CSR pieces stitched in file order."""
    from ..ops.cuda.build import load_host

    lib = load_host("text_parser")
    lib.xtpu_parse_text.restype = ctypes.c_void_p
    lib.xtpu_parse_text.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_char, ctypes.c_int]
    h = lib.xtpu_parse_text(os.fsencode(path), int(csv), sep.encode(), 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        for fn, res in ((lib.xtpu_parsed_rows, ctypes.c_int64),
                        (lib.xtpu_parsed_nnz, ctypes.c_int64),
                        (lib.xtpu_parsed_cols, ctypes.c_int32),
                        (lib.xtpu_parsed_has_qid, ctypes.c_int32)):
            fn.restype = res
            fn.argtypes = [ctypes.c_void_p]
        rows = lib.xtpu_parsed_rows(h)
        nnz = lib.xtpu_parsed_nnz(h)
        cols = lib.xtpu_parsed_cols(h)
        has_qid = bool(lib.xtpu_parsed_has_qid(h))
        out = [np.empty(n, d) for n, d in zip(
            (rows + 1, nnz, nnz, rows, rows), _C_ARRAYS)]
        lib.xtpu_parsed_fill.restype = None
        lib.xtpu_parsed_fill.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(dtype=d, flags="C_CONTIGUOUS")
            for d in _C_ARRAYS]
        lib.xtpu_parsed_fill(h, *out)
    finally:
        lib.xtpu_parsed_free.restype = None
        lib.xtpu_parsed_free.argtypes = [ctypes.c_void_p]
        lib.xtpu_parsed_free(h)
    indptr, indices, values, labels, qids = out
    return (indptr, indices, values, labels, qids if has_qid else None,
            int(cols))


def _parse_python(path: str, csv: bool, sep: str):
    """-> (indptr, indices, values, labels, qids or None, columns). A CSV
    field left empty is NaN; in CSV mode a line is stripped of newlines
    and spaces only, so a TSV line keeps its trailing empty field."""
    indptr = [0]
    indices: list = []
    values: list = []
    labels: list = []
    qids: list = []
    has_qid = False
    cols = 0
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0]
            line = line.strip("\n\r ") if csv else line.strip()
            if not line:
                continue
            if csv:
                parts = line.split(sep)
                for j, tok in enumerate(parts):
                    tok = tok.strip()
                    indices.append(j)
                    values.append(float(tok) if tok else np.nan)
                cols = max(cols, len(parts))
                labels.append(0.0)
                qids.append(0.0)
            else:
                toks = line.split()
                labels.append(float(toks[0]))
                qid = 0.0
                for tok in toks[1:]:
                    k, v = tok.split(":", 1)
                    if k == "qid":
                        qid = float(v)
                        has_qid = True
                        continue
                    idx = int(k)
                    indices.append(idx)
                    values.append(float(v))
                    cols = max(cols, idx + 1)
                qids.append(qid)
            indptr.append(len(values))
    return (np.asarray(indptr, np.int64), np.asarray(indices, np.int32),
            np.asarray(values, np.float32), np.asarray(labels, np.float32),
            np.asarray(qids, np.float32) if has_qid else None, cols)


# save_binary's npz keys -> the DMatrix keyword each loads into
BINARY_FIELDS = (("labels", "label"), ("weights", "weight"),
                 ("base_margin", "base_margin"),
                 ("label_lower_bound", "label_lower_bound"),
                 ("label_upper_bound", "label_upper_bound"))


def _load_binary(path: str) -> Dict[str, Any]:
    """A ``DMatrix.save_binary`` npz container."""
    with np.load(path, allow_pickle=False) as z:
        out: Dict[str, Any] = {"X": z["X"].astype(np.float32, copy=False)}
        for key, field in BINARY_FIELDS:
            if key in z.files:
                out[field] = z[key]
        if "group_ptr" in z.files:
            out["group"] = np.diff(z["group_ptr"].astype(np.int64))
        for key in ("feature_names", "feature_types"):
            if key in z.files:
                out[key] = [str(s) for s in z[key]]
    return out


def load_uri(uri: str) -> Dict[str, Any]:
    """-> {"X": [n, F] f32 with NaN missing, "label", "qid" (None without
    ``qid:`` tokens), and "group" / "weight" / "base_margin" where a side
    file gives them}; a binary container gives what it holds."""
    path, fmt, label_column = parse_uri(uri)
    if os.path.exists(path):
        with open(path, "rb") as fh:
            if fh.read(2) == b"PK":
                return _load_binary(path)
    if fmt not in ("csv", "libsvm"):
        raise ValueError(f"unsupported data format: {fmt}")
    csv = fmt == "csv"
    sep = "\t" if path.endswith(".tsv") else ","
    indptr, indices, values, labels, qids, cols = _parse_native(path, csv,
                                                                sep)
    n = len(indptr) - 1
    X = np.full((n, cols), np.nan, np.float32)
    X[np.repeat(np.arange(n), np.diff(indptr)), indices] = values
    if csv:
        # a dense file carries its label as column ``label_column``
        labels = X[:, label_column].copy()
        X = np.delete(X, label_column, axis=1)
    out: Dict[str, Any] = {"X": X, "label": labels, "qid": qids}
    for key in ("group", "weight", "base_margin"):
        side = f"{path}.{key}"
        if os.path.exists(side):
            out[key] = np.loadtxt(side, ndmin=1)
    return out

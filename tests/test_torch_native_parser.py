"""The port's native text parser (``csrc/text_parser.cc``, built for the
host under ``build/torch_kernels/``) against its plain version
(``data/fileio.py _parse_python``) and the JAX package's
``_parse_native``, on libsvm, CSV and TSV with ``qid:`` columns, missing
cells, CRLF endings, comments, a blank last line and a row of only a
label; one file above 1 MiB parses in several threads' chunks. Every
array must be equal (NaN where a cell is missing)."""

import os

import numpy as np
import pytest

import xgboost_tpu_torch as xt
from xgboost_tpu.data import fileio as jax_fileio
from xgboost_tpu_torch.data import fileio
from xgboost_tpu_torch.ops.cuda import build

LIBSVM = ("1 qid:3 0:1.5 3:2\r\n"
          "0 qid:3 2:-1e3 4:7.25e-2\r\n"
          "1\n"
          "\n"
          "# a comment line\n"
          "0 qid:4 1:0.25 # a trailing comment\n"
          "2 qid:4 0:-0 5:3.5\n"
          "\n")
CSV = ("1,0.5,,3\r\n"
       "0,,2.5,-1\r\n"
       "\n"
       "1,1e-3,4,\n"
       "# comment\n"
       "0, 2 , 3 ,4\n"
       "\n")
TSV = CSV.replace(",", "\t")
# a matrix's qid must be sorted, which the label-only row's 0 is not
UNGROUPED = LIBSVM.replace("qid:3 ", "").replace("qid:4 ", "")


def _write(tmp_path, name, text):
    path = os.path.join(tmp_path, name)
    with open(path, "w", newline="") as fh:
        fh.write(text)
    return path


def _big_libsvm(tmp_path, rows=30_000, seed=0):
    """Above 1 MiB, so the parser splits it at newlines into chunks."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        cols = np.flatnonzero(rng.rand(12) < 0.6)
        toks = [f"{c}:{rng.randn():.6g}" for c in cols]
        if i % 7 == 0:
            toks.insert(0, f"qid:{i // 50}")
        end = "\r\n" if i % 5 == 0 else "\n"
        lines.append(" ".join([str(i % 3)] + toks) + end)
    path = os.path.join(tmp_path, "big.libsvm")
    with open(path, "w", newline="") as fh:
        fh.write("".join(lines) + "\n")
    assert os.path.getsize(path) > (1 << 20)
    return path


def _same(a, b):
    assert len(a) == len(b) == 6
    for x, y in zip(a[:5], b[:5]):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert int(a[5]) == int(b[5])


@pytest.mark.parametrize("name,text,csv,sep", [
    ("a.libsvm", LIBSVM, False, ","),
    ("a.csv", CSV, True, ","),
    ("a.tsv", TSV, True, "\t"),
], ids=["libsvm", "csv", "tsv"])
def test_native_equals_python_and_jax(tmp_path, name, text, csv, sep):
    path = _write(tmp_path, name, text)
    got = fileio._parse_native(path, csv, sep)
    _same(got, fileio._parse_python(path, csv, sep))
    _same(got, jax_fileio._parse_native(path, csv, sep))
    if not csv:
        assert got[4].tolist() == [3, 3, 0, 4, 4]     # qid
        assert got[3].tolist() == [1, 0, 1, 0, 2]     # the label-only row
        assert np.diff(got[0]).tolist() == [2, 2, 0, 1, 2]


def test_chunked_parse_of_a_large_file(tmp_path):
    path = _big_libsvm(tmp_path)
    got = fileio._parse_native(path, False, ",")
    _same(got, fileio._parse_python(path, False, ","))
    _same(got, jax_fileio._parse_native(path, False, ","))
    assert len(got[0]) - 1 == 30_000


@pytest.mark.parametrize("uri,text", [
    ("a.libsvm?format=libsvm", UNGROUPED),
    ("a.csv?format=csv&label_column=0", CSV),
    ("a.tsv", TSV),
], ids=["libsvm", "csv", "tsv"])
def test_dmatrix_from_path_equals_the_jax_package(tmp_path, uri, text):
    import xgboost_tpu as xgb

    path = _write(tmp_path, uri.split("?")[0], text)
    full = os.path.join(tmp_path, uri)
    tm, jm = xt.DMatrix(full), xgb.DMatrix(full)
    np.testing.assert_array_equal(tm.values(), jm.values())
    np.testing.assert_array_equal(tm.get_label(), jm.get_label())
    assert os.path.exists(path)


def test_built_under_build_torch_kernels():
    lib = build.load_host("text_parser")
    target = build._host_target("text_parser")
    assert target.exists() and target.parent == build.BUILD_DIR
    assert target.parent.parts[-2:] == ("build", "torch_kernels")
    assert lib._name == str(target)
    assert build.build_host("text_parser") == ""   # cached: no rebuild


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for "
                       "csrc/broken.cc") as e:
        build.build_host("broken")
    # every flag set's command and compiler output
    assert str(e.value).count("$ ") == len(build.GXX_EXTRAS)
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*.so"))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        fileio._parse_native(os.path.join(tmp_path, "nope.libsvm"),
                             False, ",")

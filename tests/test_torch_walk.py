"""The port's packed forest and walk against the JAX package.

The same boosters (trained by the JAX package, as tests/test_packed.py
trains them) are packed by both packages, and the same numpy inputs go
through JAX ``ops/walk.py walk_packed``, the JAX Pallas walk in
interpret mode, and the port's plain walk ``walk_packed_reference``.
"""

import json

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
from xgboost_tpu.ops.pallas.walk import walk_packed_pallas
from xgboost_tpu.ops.walk import walk_packed as jax_walk_packed
from xgboost_tpu.serve.packed import PackedForest as JaxPackedForest
from xgboost_tpu_torch.boosting.gbtree import GBTree
from xgboost_tpu_torch.ops.walk import walk_packed_reference
from xgboost_tpu_torch.serve.buckets import BucketLadder
from xgboost_tpu_torch.serve.packed import PackedForest, tree_step
from xgboost_tpu_torch.testing import make_forest
from xgboost_tpu_torch.tree.tree import TreeModel

# f32 sums taken in another order (torch's CPU matmul against XLA's dot)
RTOL = ATOL = 1e-6

CAT_TYPES = ["c", "c", "q", "q", "q"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(11)
    X = rng.randn(400, 9).astype(np.float32)
    X[rng.rand(400, 9) < 0.12] = np.nan  # exercise default directions
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 2]) > 0
         ).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def boosters(data):
    """name -> (JAX booster, X it predicts on)."""
    X, y = data
    out = {"binary": (xgb.train(
        {"objective": "binary:logistic", "max_depth": 5, "eta": 0.3},
        xgb.DMatrix(X, label=y), 10, verbose_eval=False), X)}
    y3 = np.random.RandomState(12).randint(0, 3, size=X.shape[0])
    out["multi"] = (xgb.train(
        {"objective": "multi:softprob", "num_class": 3, "max_depth": 4,
         "eta": 0.3}, xgb.DMatrix(X, label=y3), 5, verbose_eval=False), X)
    rng = np.random.RandomState(13)
    Xc = rng.randint(0, 8, size=(300, 2)).astype(np.float32)
    Xn = rng.randn(300, 3).astype(np.float32)
    Xcat = np.concatenate([Xc, Xn], axis=1)
    yc = ((Xc[:, 0] % 3 == 0) ^ (Xn[:, 0] > 0)).astype(np.float32)
    out["cat"] = (xgb.train(
        {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3},
        xgb.DMatrix(Xcat, label=yc, enable_categorical=True,
                    feature_types=CAT_TYPES), 6, verbose_eval=False), Xcat)
    return out


def _port_pack(bst):
    """The port's pack of a JAX booster, read from its saved JSON."""
    gb = json.loads(bytes(bst.save_raw("json")))["learner"][
        "gradient_booster"]
    gbm = GBTree(int(bst.n_groups))
    gbm.from_json(gb)
    trees, info, w = gbm.forest_slice()
    return PackedForest.from_trees(trees, info, int(bst.n_groups), w)


def _port_margin(pf, X, base):
    return pf.margin(torch.from_numpy(np.ascontiguousarray(X)),
                     torch.from_numpy(np.array(base, np.float32))).numpy()


@pytest.mark.parametrize("name", ["binary", "multi", "cat"])
def test_pack_arrays_byte_equal(boosters, name):
    """Both packers, fed the same saved model, write the same bytes. (The
    JAX booster is reloaded from its JSON first: a freshly trained tree
    keeps a cat bitset as wide as its training bins, a loaded one only as
    wide as its largest category, and the packer copies that width.)"""
    bst, _ = boosters[name]
    ref = JaxPackedForest.from_booster(
        xgb.Booster(model_file=bst.save_raw("json")))
    pf = _port_pack(bst)
    for attr in PackedForest.ARRAYS:
        a, b = getattr(ref, attr), getattr(pf, attr)
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        assert a.tobytes() == b.tobytes(), f"{attr} differs"
    assert (pf.max_depth, pf.n_trees, pf.has_cat) == \
        (ref.max_depth, ref.n_trees, ref.has_cat)
    assert pf.has_cat == (name == "cat")


@pytest.mark.parametrize("name", ["binary", "multi", "cat"])
def test_reference_walk_matches_jax_walk_packed(boosters, name):
    """Margins agree with JAX walk_packed, NaN rows, all-NaN rows and
    bucket-padded batches included."""
    bst, X = boosters[name]
    base = bst._base_np()
    ref = JaxPackedForest.from_booster(bst)
    pf = _port_pack(bst)
    Xall = np.concatenate([X, np.full((3, X.shape[1]), np.nan, np.float32)])
    ladder = BucketLadder.pow2(64)
    for n in (1, 17, 64, Xall.shape[0]):
        Xb = Xall[-n:]
        if n <= 64:
            Xb = ladder.pad(Xb, ladder.bucket_for(n))
        want = np.asarray(ref.margin(Xb, base))
        got = _port_margin(pf, Xb, base)
        assert got.shape == want.shape == (Xb.shape[0], bst.n_groups)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["binary", "multi"])
def test_reference_walk_matches_pallas_interpret(boosters, name):
    """The port's walk against the TPU kernel K1 itself, run in interpret
    mode as tests/test_packed.py runs it (numeric packs only: the TPU
    kernel refuses categorical ones)."""
    bst, X = boosters[name]
    base = bst._base_np()
    want = np.asarray(walk_packed_pallas(
        JaxPackedForest.from_booster(bst), X[:200], base, interpret=True))
    got = _port_margin(_port_pack(bst), X[:200], base)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["binary", "multi", "cat"])
def test_from_numpy_gives_the_same_margin(boosters, name):
    bst, X = boosters[name]
    base = bst._base_np()
    ref = JaxPackedForest.from_booster(bst)
    arrays = {k: getattr(ref, k) for k in PackedForest.ARRAYS}
    arrays.update(max_depth=ref.max_depth, n_trees=ref.n_trees,
                  has_cat=ref.has_cat)
    pf = PackedForest.from_numpy(arrays)
    np.testing.assert_array_equal(_port_margin(pf, X, base),
                                  _port_margin(_port_pack(bst), X, base))
    np.testing.assert_allclose(_port_margin(pf, X, base),
                               np.asarray(ref.margin(X, base)),
                               rtol=RTOL, atol=ATOL)


def _cat_stump(default_left: bool) -> PackedForest:
    """One tree: a categorical root on feature 0 whose left set is
    {0, 3, 40}, leaves -1 (left) and +1 (right)."""
    words = np.zeros((3, 2), np.uint32)
    for c in (0, 3, 40):
        words[0, c // 32] |= np.uint32(1 << (c % 32))
    tree = TreeModel(
        left_child=np.asarray([1, -1, -1], np.int32),
        right_child=np.asarray([2, -1, -1], np.int32),
        parent=np.asarray([-1, 0, 0], np.int32),
        split_feature=np.asarray([0, -1, -1], np.int32),
        split_bin=np.zeros(3, np.int32),
        split_value=np.zeros(3, np.float32),
        default_left=np.asarray([default_left, False, False]),
        is_leaf=np.asarray([False, True, True]),
        leaf_value=np.asarray([0.0, -1.0, 1.0], np.float32),
        sum_hess=np.ones(3, np.float32), gain=np.zeros(3, np.float32),
        is_cat_split=np.asarray([True, False, False]), cat_words=words)
    return PackedForest.from_trees([tree], [0], 1)


@pytest.mark.parametrize("default_left", [True, False])
def test_categorical_edge_codes(default_left):
    """code = trunc(x): -0.5 is code 0 (in the left set); 3.9 is code 3;
    codes past the bitset (64, 1e10), below zero (-1, -1e10) and NaN at a
    categorical node count as missing and take the default way."""
    pf = _cat_stump(default_left)
    xs = np.asarray([-0.5, 0.0, 3.9, 40.0, 1.0, 63.0, 64.0, 1e10, -1.0,
                     -1e10, np.nan], np.float32)
    d = -1.0 if default_left else 1.0
    want = np.asarray([-1, -1, -1, -1, 1, 1, d, d, d, d, d], np.float32)
    X = np.stack([xs, np.zeros_like(xs)], axis=1)
    got, leaves = pf.margin(torch.from_numpy(X), torch.zeros(1),
                            leaf_index=True)
    np.testing.assert_array_equal(got.numpy()[:, 0], want)
    assert leaves.dtype == torch.int32 and leaves.shape == (len(xs), 1)
    np.testing.assert_array_equal(leaves.numpy()[:, 0],
                                  np.where(want < 0, 1, 2))
    # the JAX walk routes the same codes the same way
    import jax.numpy as jnp

    jm = jax_walk_packed(
        jnp.asarray(pf.words), jnp.asarray(pf.values),
        jnp.asarray(pf.tree_offsets), jnp.asarray(pf.tree_weight),
        jnp.asarray(pf.group_onehot), jnp.asarray(X),
        jnp.zeros(1, jnp.float32), jnp.asarray(pf.cat_words),
        max_depth=pf.max_depth, tree_chunk=tree_step(len(xs)))
    np.testing.assert_array_equal(np.asarray(jm)[:, 0], want)


def test_random_categorical_forest_matches_jax():
    """A generated forest with categorical splits on two features, fed
    in-range codes, edge codes and NaN, through both walks."""
    import jax.numpy as jnp

    trees, info = make_forest(24, 6, 5, n_groups=3, cat_features=(0, 3),
                              seed=3)
    pf = PackedForest.from_trees(trees, info, 3)
    assert pf.has_cat
    rng = np.random.RandomState(4)
    X = rng.randn(256, 5).astype(np.float32)
    X[:, 0] = rng.randint(-2, 20, 256)
    X[:, 3] = rng.choice([-0.5, 1e10, np.nan, 5.0, 15.7, 16.0], 256)
    X[rng.rand(256, 5) < 0.1] = np.nan
    base = np.asarray([0.1, -0.2, 0.3], np.float32)
    got = _port_margin(pf, X, base)
    want = jax_walk_packed(
        jnp.asarray(pf.words), jnp.asarray(pf.values),
        jnp.asarray(pf.tree_offsets), jnp.asarray(pf.tree_weight),
        jnp.asarray(pf.group_onehot), jnp.asarray(X), jnp.asarray(base),
        jnp.asarray(pf.cat_words), max_depth=pf.max_depth,
        tree_chunk=tree_step(X.shape[0]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_leaf_index_lands_on_leaves_and_sums_to_margin():
    trees, info = make_forest(40, 7, 6, seed=5)
    pf = PackedForest.from_trees(trees, info, 1)
    X = np.random.RandomState(6).randn(50, 6).astype(np.float32)
    m, leaves = pf.margin(torch.from_numpy(X), torch.zeros(1),
                          leaf_index=True)
    li = leaves.numpy()
    assert li.shape == (50, pf.tree_offsets.shape[0])
    assert ((pf.words[li] >> np.uint32(31)) == 1).all()
    sums = (pf.values[li] * pf.tree_weight[None, :]).astype(np.float64)
    np.testing.assert_allclose(m.numpy()[:, 0], sums.sum(axis=1),
                               rtol=1e-5, atol=1e-6)


def test_walk_packed_reference_is_the_cpu_path():
    """walk_packed picks by the device of X: a CPU tensor runs the plain
    version; the CUDA wrapper refuses CPU tensors."""
    from xgboost_tpu_torch.ops.cuda.walk import walk_packed_cuda
    from xgboost_tpu_torch.ops.walk import walk_packed

    trees, info = make_forest(8, 4, 3, seed=7)
    pf = PackedForest.from_trees(trees, info, 1)
    d = pf.device_arrays(torch.device("cpu"))
    X = torch.from_numpy(np.random.RandomState(8).randn(9, 3)
                         .astype(np.float32))
    args = (d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], X, torch.zeros(1))
    a = walk_packed(*args, max_depth=pf.max_depth, tree_chunk=64,
                    tree_group=d["tree_group"], max_feature=pf.max_feature)
    b = walk_packed_reference(*args, max_depth=pf.max_depth, tree_chunk=64)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        walk_packed_cuda(d["words"], d["values"], d["tree_offsets"],
                         d["tree_weight"], d["tree_group"], X,
                         torch.zeros(1), max_depth=pf.max_depth,
                         max_feature=pf.max_feature)

"""The Hopper walk kernel against its plain version, on the card.

Marked ``cuda``: skips where ``torch.cuda.is_available()`` is False. It
imports no JAX, so it also runs on a GPU machine without it:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from xgboost_tpu_torch.ops.walk import walk_packed_reference
from xgboost_tpu_torch.serve.packed import PackedForest, tree_step
from xgboost_tpu_torch.testing import make_forest


@pytest.mark.cuda
def test_cuda_kernel_matches_reference_on_the_card():
    """The Hopper kernel against its plain version on the card: equal
    leaf indices, margins within the f32 reassociation bound of a
    64-tree sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for n_groups, cats in ((1, ()), (3, ()), (2, (1,))):
        trees, info = make_forest(64, 6, 7, n_groups=n_groups,
                                  cat_features=cats, seed=9)
        pf = PackedForest.from_trees(trees, info, n_groups)
        X = np.random.RandomState(10).randn(333, 7).astype(np.float32)
        X[:, 1] = np.floor(X[:, 1] * 8)
        X[::7, 2] = np.nan
        Xd = torch.from_numpy(X).to(dev)
        base = torch.linspace(-0.5, 0.5, n_groups, device=dev)
        got, gl = pf.margin(Xd, base, leaf_index=True)
        d = pf.device_arrays(dev)
        want, wl = walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], Xd, base, d.get("cat_words"),
            max_depth=pf.max_depth, tree_chunk=tree_step(333),
            leaf_index=True)
        torch.cuda.synchronize()
        assert torch.equal(gl, wl)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

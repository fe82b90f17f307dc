#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xgboost_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --levels-of DIR
    python3 chip_smoke.py --rounds-of DIR

Builds the CUDA kernels from ``xgboost_tpu_torch/csrc/`` with nvcc (one
nvcc per source, all at once) and holds each kernel against its plain
PyTorch version on the card. K1 (the forest walk): leaf indices equal to
the plain walk's, margins within its reassociation bound and equal bit
for bit to the kernel-order fold of its leaves
(``walk_fold_kernel_order``), on the HIGGS-shape forest at every server
bucket (1, 2, ..., 512 rows), 100,000 and 1,000,000 rows, on both
schedules at 512 and 100,000 rows (one row's margin the same bits in all
of them), a 3-group and a categorical forest on both schedules, the
one-tree eval walk at 100,000 rows, a forest of 1,100 features, a
depth-15 forest that the plan sends to the spread schedule, and the
trained 7-group Covertype forest on both schedules. K2 (int8x2
histogram), K3 (f32 histogram, exact int64 fixed point; and its bf16 and
bf16x2 precisions, each row rounded to bfloat16 first), K2's and K3's
``packed_u4`` bodies over u4-packed pages (against their plain versions
and the same kernels on the unpacked ids, at a 1M-row page), K4 (K2's
function over the sorted build, with its coarse fold taken in the
kernel) and K5 (the level advance fused with the next level's coarse
histogram) bit for bit and twice each, at the shapes the training runs
below give them: K2, K3 and K4 over 256/257 bin slots,
also at skewed levels (one node with 55% of the rows, three empty), and
over the two-level schedules' 20-slot coarse ids and 36-slot refine ids
(a window of 32 fine bins chosen per node and feature, the rest on slot
35); K4's fold and K5 at one-group and sorted levels, skewed ones
included. Then it drives the port's main paths, each with the launch
counts set to 0 just before and read just after:

- serving at the HIGGS shape (500 trees of depth 8 over 28 features,
  ``binary:logistic``, made from a seed): ``Booster.predict`` on 100,000
  rows (K1's staged schedule) and a ``Server`` answering 200 requests of
  1/8/64/512 rows from 4 threads (the spread schedule), every answer
  equal to ``Booster.predict`` bit for bit;
- training at the HIGGS shape: ``xgboost_tpu_torch.train`` on 1,000,000 x
  28 N(0, 1) features with labels from a fixed linear rule plus noise
  (seed 0), ``max_depth`` 8, 20 rounds, evaluated on the training rows
  and 100,000 held-out rows. Every level's histogram goes through K4, as
  the TPU's ``auto`` takes its sorted kernel at this size; logloss must
  fall, held-out AUC pass 0.6, and a ``save_raw`` round trip predict the
  same bits;
- training at ``max_depth`` 10 on 200,000 rows for 3 rounds, so that the
  levels of 256 and 512 nodes run K3 through ``hist_method="auto"``, and
  K3's share of the device time of such rounds;
- training at ``max_depth`` 8 on 50,000 rows for 5 rounds, below the
  sorted kernel's 65,536 rows, so that every level runs K2;
- the two-level schedules on the HIGGS-shape training: ``hist_method``
  ``coarse``, ``fused`` and ``scan``, 10 rounds each, whose models must be
  the same bytes (K2 twice a level; K5 at every level boundary and K2 for
  the coarse root and the refines; K4 with its fold at every level);
- ``fused`` and ``scan`` at ``max_depth`` 10 on 200,000 rows for 2 rounds,
  where the levels of 256 and 512 nodes take the plain advance and K3;
- multiclass at the Covertype shape (``covtype_like``: 581,012 x 54 with
  covtype's 7 class counts, 100,000 held-out rows, made from a seed):
  ``multi:softprob``, depth 8, ``subsample`` / ``colsample_bytree`` /
  ``colsample_bynode`` 0.8, up to 30 rounds with early stopping after 5
  on the held-out mlogloss, twice: K4 at every level of every class tree
  (56 launches a round), K1 staged for the held-out walk (once a round),
  the two runs' model bytes the same sha256, every round's sampled masks
  and row draws drawn on the card equal to the same draws on the CPU,
  held-out mlogloss and merror falling; then seconds a round and three
  profiled rounds, ``Booster.predict`` on the held-out rows, a 7-group
  ``Server`` answering 1/8/64/512-row requests (each answer equal to
  ``Booster.predict``), one ``num_parallel_tree`` 4 round, a
  ``gradient_based`` run with ``subsample`` 0.5, and one round each
  through ``hist_method`` ``pallas:bf16x2`` and ``pallas:bf16`` (K3's
  rounded precisions at every level);
- BASELINE config #4 in full (``covertype_categorical_dart``): the same
  Covertype draws with the wilderness area (4 categories) and the soil
  type (40) as category codes beside the 10 continuous columns (581,012
  x 12, ``enable_categorical``), ``booster="dart"`` (``rate_drop`` 0.1,
  ``skip_drop`` 0.5, uniform, tree), up to 30 rounds with early stopping
  twice: K2 at every level of every class tree (56 launches a round), K4
  never, K1 for the held-out walk once a round, the two runs' model
  bytes the same sha256, both split kinds in the forest (one-hot on the
  area, sorted partition on the soil), the drops and ``weight_drop``
  range a round, held-out mlogloss falling beside the one-hot gbtree
  run's, a save/load round trip and a ``Server`` predicting the same
  bits, K1 on the trained weighted forest on both schedules, seconds a
  round and three profiled rounds, K2 over the codes against its plain
  version (and timed), and one round at depth 10 on 200,000 rows (K3 at
  256 and 512 nodes over the codes, against its plain version);
- external memory at the HIGGS-11M shape (``external_memory``): a
  ``QuantileDMatrix`` from a ``DataIter`` of 11 batches of 1,000,000 x
  28 rows (``higgs_batch``, made from a seed batch by batch) with a
  ``cache_prefix``, its bins a memmap streamed in 11 pages of 1,000,000
  rows with 4 in the page cache (``XTPU_PAGE_CACHE_BYTES``,
  ``XTPU_PAGED_COLLAPSE=0``): 10 rounds at depth 8 with 100,000 held-out
  rows (K4 on every page and level, 88 launches a round; held-out
  logloss falling every round), seconds, ring uploads, H2D bytes and
  overlap a round, three profiled rounds, the same model bytes under
  budgets of 0, 4 and 11 pages and in two runs; the u4 run (``max_bin``
  16, pages packed two ids a byte: K2-u4 on every page and level) equal
  in bytes to the same with ``XTPU_PAGE_PACK=0``, 2 rounds at depth 10
  on the first 2,000,000 rows (K3-u4 at 256 and 512 nodes) and a round
  each through ``pallas:bf16x2`` / ``pallas:bf16`` on packed pages;
  ``Booster.predict`` on the paged matrix against the walk over its
  bins; and the default budget, which collapses the matrix to the
  resident tier;
- the external-memory tier's other paths (``paged_left_outs``), on the
  same matrix with 4 pages cached: ``coarse``, ``fused``, ``scan`` and
  ``mega`` on pages, 3 rounds each, and ``coarse`` under budgets of 0
  and 11 pages, one set of model bytes (every round under every budget:
  K2 for each page's coarse build and K4 for its fine partial, every
  level; each uploaded page read ``depth + 1`` times); a two-level
  pass's device memory under budget 0 the same at 4 pages and at 11 (one
  fine accumulator, not one a page);
  on the first 4 pages, 2 of them cached (the ring uploads the others on
  every pass), lossguide at ``max_leaves`` 255 and ``max_depth`` 0, 2
  rounds, and again with all 4 cached (one sha256; K4 on each page a
  pair) and depthwise under
  ``lossguide_constraints``' monotone and interaction constraints (every
  path in one set, the sweep monotone);
  ``tree_method="approx"`` 3 rounds on the first 2 pages (the host
  re-sketch's seconds a round; held-out logloss falling); Covertype's
  codes (BASELINE config #4, 581,012 x 12) from a ``DataIter`` in pages
  of 100,000 rows, 3 rounds, both split kinds and one sha256 under
  budgets of 0 and all pages; vector leaves at MediaMill's shape in
  pages of 8,192 rows, depthwise and lossguide, 2 rounds each (K2 a
  target, page and level or pair); ``gblinear`` ``shotgun`` over the 11
  pages, 5 rounds; 10 rounds straight against 5 and a resume of 5 from a
  training snapshot, resident and paged (2 of 4 pages cached), the same
  bytes; the append of a 12th page followed by a round; and each paged
  grower on the card against the CPU port on the same pages, one round
  on two pages, one cached (``coarse`` and lossguide at 63 leaves on
  200,000 HIGGS rows, Covertype's codes on 100,000 rows, depthwise
  vector leaves at depth 3 on 4,096 MediaMill rows), under the near-tie
  certificate;
- leaf-wise growth and the constraints (``lossguide_constraints``), on
  the HIGGS-shape draws: ``grow_policy="lossguide"`` with
  ``max_leaves`` 255 and ``max_depth`` 0 (XGBoost's LightGBM-style
  setting), 10 rounds twice (one sha256; K4 once a pair of children
  evaluated, K2 / K3 never, and no plain build: the plain versions raise
  while it trains; held-out logloss falling every round and AUC beside
  the depthwise run's at 10 rounds; each tree's leaves and depth); a
  ``save_raw`` round trip and a ``Server`` predicting
  ``Booster.predict``'s bits; K1 on the lossguide forest on both
  schedules against its fold replica, and timed; seconds a round and
  three profiled rounds; ``coarse`` / ``fused`` / ``scan`` lossguide, 3
  rounds each, one set of bytes (K2 twice a pair, K2 twice, K4 once);
  depthwise ``auto`` at depth 8 for 10 rounds and lossguide for 3 under
  ``monotone_constraints`` (the sign of the rule's weight on its 8
  largest, 0 elsewhere) and ``interaction_constraints`` (the tutorial's
  ``[[0, 2], [1, 3, 4], [5, 6]]``): every path in one set, predictions
  swept over 64 values of each constrained feature on 1,000 held-out
  rows never moving against its sign, held-out AUC past 0.6; depthwise
  ``max_leaves`` 64 at depth 8 and at depth 10 on 200,000 rows (K3 at
  256 and 512 nodes); lossguide dart on the categorical Covertype matrix
  (``max_leaves`` 63, 3 rounds: both split kinds, the drops); and K2 and
  K4 at the pair shape (1,000,000 x 28, N = 2, 256 and 257 slots, 50%
  and 2% of the rows in the pair) against their plain versions and
  timed;
- multi-target training at the MediaMill shape (``multi_target``):
  ``mediamill_like`` (30,993 training and 12,914 held-out rows of 120
  N(0, 1) features, a 101-column 0/1 label matrix with 4.376 positives
  a row and label rates falling off as 1 / (k + 2), each label from a
  sparse rule over a shared pool of features plus noise, made from a
  seed), ``binary:logistic``, depth 6, ``eta`` 0.3:
  ``one_output_per_tree`` (101 trees a round) and ``multi_output_tree``
  (one vector-leaf tree a round) 10 rounds each and lossguide vector
  leaves (``max_leaves`` 64) 2 rounds, each twice (one sha256; K2 at
  every level of every tree or once a label and pair, K1 once a round
  for the first's held-out walk, no plain build), with seconds a round,
  three profiled rounds, held-out logloss falling, mean per-label AUC
  past 0.6 and ``max_memory_allocated``; ``save_raw`` and
  reference-schema round trips of all three predicting the same bits
  (with each row's base margin: the schema's scalar ``base_score``
  keeps target 0's intercept); ``Booster.predict`` through K1 for the
  101-group forest; one vector-leaf round at depths 8 and 10 (K2 at
  levels of up to 128 nodes, K3 above; the peak memory); a 3-target
  regression with vector leaves at the HIGGS shape (1,000,000 x 28,
  depth 8, 5 rounds; K4 once a target and level,
  held-out rmse falling); K2 at 30,993 x 120 (N = 1 and 32, 256 and
  257 slots) and K1 on the 101-group forest at 12,914 rows (both
  schedules) against their plain versions, and timed;
- the rest of the objectives, in three phases. ``quantile_regression``
  (XGBoost 2.0's quantile regression demo at the HIGGS shape: the
  1,000,000 + 100,000 HIGGS-shape rows with a linear signal under a
  noise whose spread grows with two features; ``reg:quantileerror`` at
  alphas 0.05 / 0.5 / 0.95, ``learning_rate`` 0.04, depth 5, up to 32
  rounds with early stopping after 2 on the held-out rows), twice (one
  sha256; K4 at every level of the three trees a round, K1 once a
  round): held-out pinball loss per alpha falling, the coverage of
  [q0.05, q0.95], seconds a round and three profiled rounds, the leaf
  refresh's device time on 1,000,000 rows, ``reg:absoluteerror`` for 10
  rounds (held-out MAE falling), and ``reg:pseudohubererror``,
  ``reg:squaredlogerror`` and ``binary:hinge`` 3 rounds each.
  ``survival`` (XGBoost's AFT demo settings: ``normal``, scale 1.2,
  ``learning_rate`` 0.05, depth 6, ``lambda`` 0.01, ``alpha`` 0.02, on
  the HIGGS-shape rows with log-normal times, half uncensored and the
  rest right-, left- and interval-censored): AFT 10 rounds twice with
  held-out ``aft-nloglik`` and ``interval-regression-accuracy``,
  ``logistic`` and ``extreme`` 2 rounds each, ``survival:cox`` 10 rounds
  twice on the same times (a negative label for a right-censored one)
  with held-out ``cox-nloglik``. ``insurance_claims`` (the freMTPL2freq
  shape of scikit-learn's Poisson and Tweedie examples, ``fremtpl2_like``:
  678,013 policies x 9 features with VehBrand, Area and Region as
  category codes, Exposure as the weight, about 5% claiming; 10% held
  out): ``count:poisson`` on the claim frequency and ``reg:tweedie``
  (power 1.5) on the pure premium, 10 rounds twice each, and
  ``reg:gamma`` on the claiming policies' mean claim (weight: the claim
  count) with ``gamma-deviance`` (K2 at every level, K1 once a round,
  K4 never). In every phase the card's trees are held node for node
  against the CPU port's on the first 20,000 rows (``card_against_cpu``)
  and each cell prints seconds a round and three profiled rounds;
- ``tree_method="approx"`` (``approx_higgs``) on the HIGGS-shape draws
  (depth 8, ``max_bin`` 256, ``eta`` 0.1): ``hist`` 10 rounds, then
  ``approx`` 10 rounds twice (one sha256; K4 8 and K1 1 a round, no
  plain build), every round re-sketched on the card with the hessian as
  the weights (``WeightedSketch``) and re-binned there, each timed with
  CUDA events; the device cuts of rounds 1 and 10 equal to the host
  sketch's on the same hessian bit for bit (the first difference's
  feature and rank printed otherwise); round 1's tree equal to
  ``hist``'s (uniform hessians give ``hist``'s cuts); held-out AUC and
  logloss at 10 rounds and the peak memory of both; seconds a round and
  three profiled rounds of each, with no sort kernel in a steady
  ``approx`` round; and ``approx`` binary and with 3 classes at depth 6
  against the CPU port at 20,000 rows;
- XGBoost's ``demo/kaggle-higgs/speedtest.py`` (``kaggle_higgs_speedtest``):
  ``kaggle_higgs_like`` (the Higgs challenge's 250,000 training events x
  30 features, ``-999.0`` where a quantity is undefined, read with
  ``missing=-999.0``; 50,000 held-out events; made from a seed), the
  weights rescaled as the demo rescales them and ``scale_pos_weight =
  sum_wneg / sum_wpos``, ``binary:logitraw``, ``eta`` 0.1, depth 6, 10
  rounds with held-out ``auc`` and ``ams@0.15``: ``hist`` and ``approx``
  (K4 6 a round) and ``exact`` (no histogram kernel; K1 1 a round), each
  with its peak memory, seconds a round and three profiled rounds;
  ``exact``'s time a level, and ``exact`` against the CPU port at
  20,000 rows;
- BASELINE config #3 in full (``mslr_ranking``): ``rank:ndcg``
  LambdaMART at the MSLR-WEB30K Fold1 shape (``mslr_like``: 136 N(0, 1)
  features, 18,919 training queries of log-normal sizes with MSLR's
  mean, the longest 1,251 documents, 6,306 held-out queries; labels
  0-4 from a hidden score's rank within the query, made from a seed):
  ``lambdarank_pair_method`` ``mean`` with one rival a document,
  exponential gains, depth 6, ``eta`` 0.3, ``max_bin`` 256, held-out
  ``ndcg@10`` and ``map@10``, 30 rounds twice: K4 at every level (6
  launches a round), K1 once a round, one sha256 in both runs,
  held-out ``ndcg@10`` rising, ``Booster.predict`` agreeing with the
  eval line; seconds a round, three profiled rounds, the LambdaRank
  gradient's own device time and its padded layout's pad share; K2,
  K3 and K4 over the training bins at 136 features against their plain
  versions (1 to 32 nodes, uniform and skewed) and timed at 1 and 32
  nodes; K1 on the ranking forest against its fold replica; and at
  bench.py's 200,000 x 136 in 800 queries of 250, two rounds each of
  ``topk`` (0 and 8 anchors), unbiased ``mean`` and ``topk`` (ti+ /
  tj- printed), ``rank:pairwise`` and ``rank:map`` on binary labels,
  and a save/load round trip of the unbiased model;
- BASELINE config #1 as XGBoost's agaricus demos run it
  (``agaricus_walkthrough``): ``agaricus_like`` writes
  ``agaricus.txt.train`` / ``.test`` (6,513 and 1,611 rows of 22 one-hot
  attributes, 127 columns, column 0 never present) as libsvm, read back
  through ``DMatrix(path)`` (timed, and the parse rate on a 200,000-row
  file); K2 over their bins (F = 127, B = 2, N = 1 and 2) against its
  plain version and timed; ``binary:logistic`` with ``error`` and
  ``reg:squarederror`` with ``rmse`` (depth 2, ``eta`` 1, 2 rounds, both
  eval sets) twice each (one sha256; K2 twice and K1 once a round); then
  save/load, ``dump_model``, ``save_binary``, CSR / CSC / numpy input,
  boost from prediction, ``iteration_range``, ``pred_leaf`` (against the
  CPU), the demo's custom objective and metric, ``process_type=update``
  (against the CPU) and the reference-schema writer; seconds a round,
  three profiled rounds, and K1 on the trained forest at the 1,611 test
  rows against its plain version and timed;
- the linear booster (``gblinear_higgs``): XGBoost's
  ``demo/guide-python/generalized_linear_model.py`` settings (``alpha``
  0.0001, ``lambda`` 1) on the HIGGS-shape draws, ``shotgun`` and
  ``coord_descent`` 20 rounds each, twice (one sha256; no kernel of K1
  to K5: the round is two products and an update), held-out AUC and
  logloss, seconds a round and three profiled rounds, the card's
  weights against the CPU's at 20,000 rows, the reference schema written
  and read back, ``pred_contribs`` summing to the margin; then the
  demo's 4 rounds on ``agaricus_like``'s files;
- SHAP on the card (``shap_higgs``): a 100-tree depth-8 forest trained
  at the HIGGS shape (K4), its contributions on 10,000 held-out rows,
  interactions on 1,000 and Saabas contributions on 100,000, each timed
  (host clock and CUDA events) with its peak memory, its rows summed
  against K1's margins (interactions against the contributions), and
  the card's float64 values on the first rows against the host
  recursion; the same at 1,000 rows for the Covertype categorical dart
  forest (7 groups);
- the wrappers, ``cv`` and the CLI (``sklearn_cv_cli``, with no
  scikit-learn installed on the card's machine): ``XGBClassifier`` on
  the Covertype shape with an eval set and early stopping, one sha256
  with ``xt.train`` from the parameters it maps; ``XGBRegressor(booster=
  "gblinear")``'s ``coef_`` / ``intercept_``; ``xt.cv`` 5 folds at the
  HIGGS shape, 10 rounds; the CLI with the mushroom demo's config
  (``demo/CLI/binary_classification/mushroom.conf``) on the agaricus
  files: train in this process and as ``python -m xgboost_tpu_torch``
  (the two models and ``xt.train``'s one set of bytes), dump and pred;
- the serving stack (``serving_stack``) on the serving forest above: the
  HTTP front end over a 2-replica ``FleetRouter`` on the card answering
  200 ``POST /v1/predict`` of 1/8/64/512 rows from 4 client processes
  (K1 on the spread schedule; every answer ``Booster.predict``'s bits;
  client latency p50 / p99 a size), the same load through one ``Server``
  behind the same front end in turn with the fleet (req/s and latency of
  both), ``POST /v1/model/higgs/contribs`` on 1,000
  rows against ``Booster.predict(pred_contribs=True)`` (1e-12, rows
  summing to the margin within 1e-5, rows/s of both), a swap to a
  second forest, a rollback and a drained ``remove_replica`` under load
  from 4 threads (no request failing, each answer its version's bits),
  ``/healthz``, ``/v1/metrics``, ``/metrics`` and ``/v1/models`` parsed
  and their counters against the requests sent, the jsonl loop as
  ``python -m xgboost_tpu_torch serve`` over 50 lines (each equal to its
  HTTP twin); ``XTPU_NAN_POLICY`` at the HIGGS shape with 1% NaN labels
  (``raise`` names the rows with no tree committed, ``zero`` trains 3
  rounds with finite predictions, ``off`` trains unchecked);
  ``update_batch`` of 8 rounds against 8 ``update`` calls (one set of
  bytes); and the native text parser against the Python one on a
  1,000,000-row libsvm file of the agaricus widths (the same arrays,
  rows/s of both);
- row-split distributed training (``distributed``) at the HIGGS shape
  (1,000,000 x 28 of ``higgs_like``, ``max_bin`` 256, depth 8,
  ``binary:logistic``): first K4, K2, K5 and K3 (at 256 and 512 nodes)
  at one level of one 250,000-row shard of the mesh, through the
  wrappers with the quantiser scale reduced over the 4 shards
  (``RowShards.scale``), bit for bit against their plain versions and
  timed (``mesh_shard_kernels``); then on a data mesh of 4 shards of this
  card (``context.Mesh``; each shard's histograms on its 250,000 rows, the
  partials summed in shard order) ``auto`` (K4 a shard and level),
  ``pallas`` (K2), ``fused`` (K5 + K2) and depth 10 (K4, and K3 above
  128 nodes), 3 rounds each, every launch count 4 times one device's,
  each model held against one device's under ``certified_trees`` and
  predictions within rtol 1e-5 + atol 1e-5, two mesh runs one sha256;
  lossguide at 255 leaves (2 rounds); vector leaves at the MediaMill
  shape (101 labels, 2 rounds) on 2 shards; ``approx`` on 4 shards
  (held-out logloss falling); ``parallel.launch.train_per_host`` in two
  OS processes on this card over ``gloo``, each with half the rows (one
  sha256, held against the in-process 2-shard mesh over the ranks'
  merged cuts; seconds a round and the collective's host time); and two
  ``InMemoryCommunicator`` thread ranks, each training 2 of the first 4
  pages of ``higgs_batches`` (one sha256, held against one rank over all
  4 pages). Every run prints its seconds a round beside one device's;
- column-split training (``column_split``) at the same shape: first K2
  and K4 (128 nodes) and K3 (256 and 512) at one level of one feature
  shard (1,000,000 x 7, the shard's own scale) against their plain
  versions and timed (``col_shard_kernels``); then on a column mesh of 4
  feature shards of this card (``data_split_mode="col"``: every row, 7
  columns a shard, the best-split exchange and the decision OR)
  ``auto`` (K2 a shard), ``scan`` (K4), ``coarse`` and ``fused`` (K2 on
  the coarse ids; K5 never launched), depth 10 (K3 above 128 nodes), 3
  rounds each, lossguide at 255 leaves (2 rounds), vector leaves at the
  MediaMill shape on 2 shards (2 rounds) and ``approx`` (3 rounds), each
  held node by node against the ``distributed`` phase's one-device model
  of the same parameters (the trees' sha256 compared, predictions
  within rtol 1e-5 + atol 1e-5), launches shards x one device's, two
  ``auto`` runs one sha256; and 4 vertical federated parties on
  ``InMemoryCommunicator`` threads (a block of 7 columns each, labels on
  rank 0) training depthwise 3 rounds and lossguide at 255 leaves 2
  rounds (one sha256 on every party, one device's trees, K2 4 x one
  device's builds), the held-out 100,000 rows predicted by the
  decision-bit protocol against K1's predictions; seconds a round and
  the communicator's host seconds beside one device's;
- external memory over a data mesh (``paged_mesh``) at the HIGGS shape:
  4,000,000 x 28 rows of ``higgs_batch`` in 4 pages of 1,000,000 (28
  features, ``max_bin`` 256, depth 8) on a mesh of 4 shards of this card,
  each shard streaming its own 250,000 rows of each page through the
  ring and the mesh page cache: first K4, K2 and K3 at one shard's block
  of a page (250,000 x 28, N = 128, and K3 at 512) with the block's own
  quantiser scale, through ``build_hist``, against their plain versions
  and timed (``paged_shard_kernels``); one device's paged round beside
  it (2 of 4 pages cached); ``auto`` 3 rounds at 0, 2 and 4 mesh pages
  cached (one sha256; K4 shards x pages x levels a round, K5 never; the
  ring's uploads), ``scan`` (K2 for each block's coarse build beside
  K4), depth 10 (K3 at the levels of 256 and 512) and lossguide at 64
  leaves (2 rounds), each held round by round against the resident
  4-shard mesh of the same rows under ``certified_trees``; one traced
  round (``obs.trace`` with sync armed, exported as Perfetto JSON: the
  seconds a level in the page passes, the shards' reduction, the split
  search and the advance; ``obs.memory``'s peak of the round; the
  untraced model's bytes); MediaMill vector leaves on 2 shards in pages
  of 8,192 rows (K2 a target, block and level); and the card against the
  CPU port's paged mesh on 262,144 HIGGS rows (2 shards, K4's rows a
  block), one round under the certificate;
- the continuous train -> serve loop (``continuous_pipeline``) at the
  HIGGS width: 4 pages of 250,000 x 28 rows of ``higgs_batch`` (seed 22)
  and 100,000 held-out rows through ``pipeline.Pipeline`` (depth 8,
  ``eta`` 0.1, 10 rounds an epoch, 40 and 1,000,000 rows at the end,
  a snapshot every 5 rounds, gates ``auc`` and ``logloss`` at 0.01), each
  promotion hot-swapped into a ``Server`` that 3 client threads load
  with 1- and 512-row requests (none may fail; every sampled answer its
  version's artifact's ``Booster.predict`` bit for bit; K4 exactly 8 a
  round, K2 / K3 / K5 never, K1 from the gates, the walks and the
  server; held-out logloss falling each epoch); a second workdir killed
  mid-epoch (epoch 1, round 5, the newest snapshot torn) and after the
  manifest commit (epoch 2), then finished by a fresh pipeline: every
  artifact run 1's sha256, both black-box bundles verified and rendered
  by ``python -m xgboost_tpu_torch.obs postmortem`` with the CUDA
  allocator's peak on this card, and the page log's replay of the last
  epoch its artifact's bytes; one canary rollback (``Server`` back at v1
  bit for bit, v2 listed as rolled back); insight armed with the in-carry
  eval over 10 rounds on the main path's 1M-row matrix (the disarmed
  run's sha256; every record with the fused tier's scalars; in-carry
  scores the host path's within rtol 1e-6; device busy over 3 profiled
  rounds armed and not); 4 ``InMemoryCommunicator`` thread ranks each
  reducing a 250,000-row K4 histogram through ``RowShards.reduce`` in
  flight-recorder spans, then ``sync_clocks``, their rings merged by
  ``python -m xgboost_tpu_torch.obs merge`` (one track a rank, every
  offset within its uncertainty); and the CLI's ``pipeline`` mode as a
  subprocess on 2 libsvm pages of 50,000 rows (exit 0, ``command=status``
  2 promotions). It logs seconds an epoch by stage (the pipeline's
  spans), the promotion latency and insight's cost.

Every phase logs its seconds (``phase <name>: N s``), and the run ends
with a ``phase seconds:`` JSON line before the kernels' line.

It times each kernel, its plain version, one PyTorch library call for
the same function where there is one, and the kernel's bound, at the
main paths' shapes: K2 and K4 at the lossguide pair (N = 2, 50% and 2%
of 1,000,000 rows active), K1 on the lossguide forest at 100,000 rows;
K2 at the MediaMill levels and K1 on the 101-group forest;
K2 at the categorical run's levels of 128 nodes and
at the agaricus bins (6,513 x 127, two slots, N = 2); K1 on the agaricus
forest at its 1,611 test rows; K1
at 1, 512, 100,000 and 1,000,000 rows and the
one-tree walk at 100,000, and both of its schedules from 1 to 100,000
rows; K1 on the Covertype forest (7 groups) at 1, 512 and 100,000 rows
and its one-round eval walk; K4 at every level width of the HIGGS run (N = 1, 2,
..., 128 on 1,000,000 rows) and K5 at every level boundary (N = 2, ...,
128), each split into its phases (sort or advance, tiles, combine and
fold) with CUDA events; seconds per boosting round on the host clock;
and the device's idle share of the same rounds under ``torch.profiler``.

``--levels-of DIR`` times only K4's and K5's levels (and K2 beside them)
and K1's main-path shapes with the ``xgboost_tpu_torch`` package found in
DIR, through the calls every version of the port has, so that two trees
compare in one run; it prints them as a JSON line and exits.
``--rounds-of DIR`` does the same for seconds a round: one device's
HIGGS runs (``auto``, ``coarse``, ``fused``, ``scan``) and the
external-memory runs (11 pages of 1,000,000 rows, 4 cached, and the u4
run), to compare the seconds a round of two trees in one run.

Prints the card (``nvidia-smi`` name and power limit) and a JSON line
of kernel numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 and prints no result.
"""

import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
U = 2.0 ** -24                 # f32 unit roundoff
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2


_T0 = time.perf_counter()


def log(*args):
    """A line of the run's log, after the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *args, flush=True)


_PHASE_T0 = [_T0]
PHASE_SECONDS = {}


def phase_line(name):
    """The seconds since the previous phase line (the first: since the
    start), logged and kept in ``PHASE_SECONDS`` under ``name``."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = now - _PHASE_T0[0]
    _PHASE_T0[0] = now
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sum_bound(pf, leaves, base, tree_chunk):
    """Per-(row, group) bound on |kernel - plain| from reassociating the
    f32 leaf sum: (adds on the longer path of both) * u * sum |terms|.
    The plain walk folds chunks of ``tree_chunk`` (any order inside a
    chunk); the kernel sums 32 lane partials of Tp/32 trees and reduces
    them in 5 shuffle steps (one group), or folds every tree of a group
    in tree order (several groups)."""
    d = pf.device_arrays(leaves.device)
    Tp = pf.tree_offsets.shape[0]
    terms = (d["values"][leaves.long()] * d["tree_weight"][None, :]).abs()
    mag = terms @ d["group_onehot"] + base.abs()[None, :]
    k_plain = tree_chunk + math.ceil(Tp / tree_chunk) + 1
    k_kernel = (math.ceil(Tp / 32) + 6) if pf.n_groups == 1 else Tp + 1
    return (k_plain + k_kernel) * U * mag


PLAIN_ROWS = 100_000           # rows of one plain-walk call in a check


def check_kernel(name, pf, X, base, schedule=None):
    """K1 (on ``schedule``, else the plan's) against the plain walk on the
    same device tensors: leaf indices equal, margins within the
    reassociation bound, and equal bit for bit to the kernel-order fold of
    the plain walk's leaves (``walk_fold_kernel_order``). The plain walk
    runs on 100,000 rows at a time (its rows are independent). Returns
    (max |kernel - plain|, the kernel's margins, the schedule launched)."""
    from xgboost_tpu_torch.ops.cuda import walk as W
    from xgboost_tpu_torch.ops.walk import (walk_fold_kernel_order,
                                            walk_packed_reference)
    from xgboost_tpu_torch.serve.packed import tree_step

    d = pf.device_arrays(X.device)
    before = dict(W.SCHEDULE_LAUNCHES)
    got, got_leaf = pf.margin(X, base, leaf_index=True, schedule=schedule)
    took = [k for k, v in W.SCHEDULE_LAUNCHES.items() if v != before[k]]
    if len(took) != 1 or (schedule is not None and took != [schedule]):
        raise AssertionError(f"{name}: launched {took}, asked {schedule}")
    err = ratio = 0.0
    for lo in range(0, X.shape[0], PLAIN_ROWS):
        hi = min(lo + PLAIN_ROWS, X.shape[0])
        tc = tree_step(hi - lo)
        want, want_leaf = walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], X[lo:hi], base, d.get("cat_words"),
            max_depth=pf.max_depth, tree_chunk=tc, leaf_index=True)
        replica = walk_fold_kernel_order(
            d["values"][want_leaf.long()], d["tree_weight"],
            d["tree_group"], base)
        torch.cuda.synchronize()
        if not torch.equal(got_leaf[lo:hi], want_leaf):
            bad = int((got_leaf[lo:hi] != want_leaf).sum())
            raise AssertionError(f"{name}: {bad} leaf indices differ")
        if not torch.equal(got[lo:hi], replica):
            bad = int((got[lo:hi] != replica).sum())
            raise AssertionError(f"{name}: {bad} margins differ from the "
                                 "kernel-order fold")
        e = (got[lo:hi] - want).abs()
        bound = sum_bound(pf, want_leaf, base, tc)
        if not bool(torch.isfinite(got[lo:hi]).all()) or \
                bool((e > bound).any()):
            raise AssertionError(
                f"{name}: margin off by {float(e.max())} "
                f"(bound {float(bound.min())}..{float(bound.max())})")
        err = max(err, float(e.max()))
        ratio = max(ratio, float((e / bound).max()))
    log(f"check {name}: rows={X.shape[0]} trees={pf.n_trees} "
        f"groups={pf.n_groups} cat={pf.has_cat} features={X.shape[1]} "
        f"schedule={took[0]}: leaf_index equal, margins equal the "
        f"kernel-order fold bit for bit, max_abs_err={err} "
        f"max_err/bound={ratio}")
    return err, got, took[0]


def event_ms(fn, reps, flush=None):
    """Mean device time of ``fn`` over ``reps`` calls, one CUDA event pair
    around each (the L2 flushed before each call when ``flush`` is
    given), after three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def node_depths(pf):
    """Depth of every flat node of the pack (root 0)."""
    depth = np.zeros(pf.words.shape[0], np.int64)
    leaf = (pf.words >> np.uint32(31)) == 1
    delta = (pf.words & np.uint32(0xFFFF)).astype(np.int64)
    for t in range(pf.n_trees):          # BFS order: parents come first
        lo = int(pf.tree_offsets[t])
        for i in range(lo, lo + int(pf.n_nodes[t])):
            if not leaf[i]:
                depth[i + delta[i]] = depth[i + delta[i] + 1] = depth[i] + 1
    return depth


def walk_bound_ms(pf, n, n_features, visits):
    """(ms, "bytes"|"operations"): the least time for the walk of n rows.
    Bytes: the pool once (word + value per node), X once, the output
    once. Operations: one f32 comparison per internal node visited
    (counted from this run's leaf indices), one multiply and one add per
    (row, tree)."""
    nbytes = (pf.words.shape[0] * 8 + n * n_features * 4
              + n * pf.n_groups * 4)
    ops = visits + 2 * n * pf.tree_offsets.shape[0]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def auc(y: np.ndarray, p: np.ndarray) -> float:
    """Area under the ROC curve (ties share their average rank)."""
    _, inv, counts = np.unique(p, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


# (rows, nodes, bin slots, skewed): the levels the training runs below
# give the kernels, and the missing-slot layout (257 slots, u16). K3 runs
# at every case, K2 and K4 at the cases of at most 128 nodes. Skewed: one
# node holds 55% of the rows and three are empty, as in real trees, so
# that K2 and K3 split a node's run over several blocks.
HIST_CASES = ((1_000_000, 1, 256, False), (1_000_000, 4, 256, False),
              (1_000_000, 16, 256, False), (1_000_000, 128, 256, False),
              (1_000_000, 64, 257, False), (200_000, 256, 256, False),
              (200_000, 512, 256, False), (50_000, 1, 256, False),
              (50_000, 128, 256, False), (1_000_000, 128, 256, True),
              (200_000, 512, 256, True))


# (rows, nodes, id slots): the builds of the two-level schedules that go
# through ``build_hist``: coarse ids (20 slots) and refine ids (36 slots),
# K2 at the HIGGS run's root and deepest level, K3 at the depth-10 runs'
# levels of 256 and 512 nodes
TWO_LEVEL_CASES = ((1_000_000, 1, 20), (1_000_000, 1, 36),
                   (1_000_000, 128, 36), (200_000, 256, 20),
                   (200_000, 256, 36), (200_000, 512, 20),
                   (200_000, 512, 36))


def hist_inputs(n, F, B, N, dev, seed, skew=False):
    """bins [n, F] (uint8, or uint16 with a missing slot at B-1 for
    B = 257), gpair [n, 2] f32 and rel [n] int32 with 10% inactive rows,
    made on the card from ``seed``. ``skew``: node 1 holds 55% of the
    rows and nodes 0, 2 and 5 none."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if B > 256:
        bins = torch.randint(0, B - 1, (n, F), generator=g, device=dev,
                             dtype=torch.int32)
        miss = torch.rand((n, F), generator=g, device=dev) < 0.05
        bins = torch.where(miss, torch.full_like(bins, B - 1), bins)
        bins = bins.to(torch.uint16)
    else:
        bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)
    gpair = torch.stack([torch.randn(n, generator=g, device=dev),
                         torch.rand(n, generator=g, device=dev)], dim=1)
    rel = torch.randint(0, N, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if skew:
        rel = torch.where((rel == 0) | (rel == 2) | (rel == 5),
                          torch.full_like(rel, 3 % N), rel)
        rel = torch.where(torch.rand(n, generator=g, device=dev) < 0.55,
                          torch.full_like(rel, 1 % N), rel)
    rel = torch.where(torch.rand(n, generator=g, device=dev) < 0.1,
                      torch.full_like(rel, N), rel)
    return bins.contiguous(), gpair.contiguous(), rel.contiguous()


def two_level_inputs(n, F, N, B, dev, seed):
    """``hist_inputs``' u8 bins (256 slots, no missing slot) as the
    two-level schedules hand them to ``build_hist``: their coarse ids for
    B = 20; for B = 36 their refine ids, each row's window that of its
    node and feature, chosen from the level's coarse histogram as
    ``tree/grow.py`` chooses it (rows outside the level take window 0)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.split import (COARSE_B, WINDOW,
                                             choose_refine_window,
                                             coarse_bin_ids, refine_bin_ids)
    from xgboost_tpu_torch.tree.param import TrainParam

    bins, gpair, rel = hist_inputs(n, F, 256, N, dev, seed)
    cb = coarse_bin_ids(bins, 256)
    if B == COARSE_B:
        return cb, gpair, rel
    if B != WINDOW + 4:
        raise ValueError(f"no two-level build has {B} slots")
    q, inv = H.quantise_int8x2(gpair)
    hist_c = H.build_hist_int8x2_reference(cb, q, rel, inv, N, COARSE_B)
    span = choose_refine_window(
        hist_c, hist_c[:, 0].sum(dim=1),
        torch.full((F,), 256, dtype=torch.int64, device=dev), TrainParam(),
        False)
    span_row = torch.cat([span, torch.zeros_like(span[:1])]).to(
        torch.int32)[rel.long()]
    return refine_bin_ids(bins, span_row, 256).contiguous(), gpair, rel


def hist_totals_ok(name, out, gpair, rel, N, quantum):
    """Every feature's bins add up to its node's gradient sums: within
    half a quantum per row (0.51: K2's dequant factor is itself rounded)
    plus one f32 rounding per bin."""
    act = rel < N
    exact = torch.zeros((N, 2), dtype=torch.float64, device=out.device)
    exact.index_add_(0, rel[act].long(), gpair[act].double())
    count = torch.bincount(rel[act].long(), minlength=N).double()
    o = out.double()                                   # [N, F, B, 2]
    tot = o.sum(dim=2)                                  # [N, F, 2]
    ulp = torch.abs(out).double() * 2.0 ** -24
    bound = (count[:, None, None] * 0.51 * quantum.double()[None, None, :]
             + ulp.sum(dim=2) + exact.abs()[:, None, :] * 2.0 ** -22)
    err = (tot - exact[:, None, :]).abs()
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: totals off by {float(err.max())}")
    # an empty node's bound is 0 and so is its error
    return float(torch.where(bound > 0, err / bound, err).max())


def k3_precisions():
    """K3's kernels -> their precisions (``ops/cuda/hist.py K3_KERNELS``)."""
    from xgboost_tpu_torch.ops.cuda.hist import K3_KERNELS
    return {name: prec for prec, name in K3_KERNELS.items()}


def hist_kernels(N, scale=None):
    """The kernels that run at a level of N nodes, with their plain
    versions: (name, kernel(args), plain(args), maker of the args). K3
    in its three precisions at every level (``pallas:bf16x2`` /
    ``pallas:bf16`` build every level with it). ``scale``: a mesh's
    quantiser keywords (``tree/shards.py RowShards.scale``) for the
    args, as the growers pass them to the wrappers."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    scale = scale or {}

    def int8x2_args(bins, gpair, rel):
        q, inv = H.quantise_int8x2(gpair, scale.get("max_abs"))
        return bins, q, rel, inv

    def f32_args(bins, gpair, rel):
        qs, inv = H.fixed_point_scale(gpair, scale.get("max_abs"),
                                      scale.get("total_rows"))
        return bins, gpair, rel, qs, inv

    def k3(prec):
        return (lambda *a: K.hist_f32_cuda(*a, precision=prec),
                lambda *a: H.build_hist_f32_reference(*a, precision=prec))

    out = [(name, *k3(prec), f32_args)
           for name, prec in k3_precisions().items()]
    if N <= 128:
        out += [("hist_int8x2", K.hist_int8x2_cuda,
                 H.build_hist_int8x2_reference, int8x2_args),
                ("hist_scan", K.hist_scan_cuda, H.build_hist_scan_reference,
                 int8x2_args)]
    return out


def check_hist(bins, gpair, rel, N, B, label, only=None, scale=None):
    """Each kernel (of ``only``, when given) against its plain version on
    the same card tensors: equal bit for bit on two launches; totals
    against the row sums. ``scale``: a mesh's quantiser keywords
    (:func:`hist_kernels`). Returns {kernel: max |kernel - plain|}."""
    from xgboost_tpu_torch.ops.histogram import bf16_parts

    errs = {}
    ratios = []
    for name, kernel, plain, make in hist_kernels(N, scale):
        if only is not None and name not in only:
            continue
        args = make(bins, gpair, rel)
        runs = [kernel(*args, N, B) for _ in range(2)]
        want = plain(*args, N, B)
        torch.cuda.synchronize()
        errs[name] = max(float((r - want).abs().max()) for r in runs)
        if not all(torch.equal(r, want) for r in runs):
            raise AssertionError(f"{name} {label}: a launch differs from the "
                                 f"plain version (max {errs[name]})")
        # the totals of what the rows add: K3's rounded precisions add
        # each row's bfloat16 parts, each rounded to the fixed point
        parts = bf16_parts(gpair, k3_precisions().get(name, "f32"))
        ratios.append(hist_totals_ok(f"{name} {label}", runs[0],
                                     sum(p.double() for p in parts), rel, N,
                                     args[-1] * len(parts)))
    log(f"check hist {label}: rows={bins.shape[0]} features={bins.shape[1]} "
        f"nodes={N} bins={B} ({bins.dtype}): {sorted(errs)} equal their "
        f"plain versions bit for bit on two launches; totals at "
        f"{max(ratios):.3f} of their bound at most")
    return errs


def hist_bound_ms(bins, N, B, n_active, planes, coarse=False, F=None):
    """(ms, "bytes"|"operations", ops): bins, the gradients (q or gpair,
    8 B a row) and rel read once, the [N, F, B, 2] f32 histogram (and
    with ``coarse`` the [N, F, 20, 2] coarse one) written once, over
    3.35 TB/s; against one integer add per (active row, feature, plane)
    over the f32 lane rate (the table has no scalar integer rate). ``F``:
    the features of a u4-packed page (``bins`` [n, ceil(F/2)] bytes)."""
    n, W = bins.shape
    F = F or W
    nbytes = (n * W * bins.element_size() + n * 8 + n * 4
              + N * F * (B + (20 if coarse else 0)) * 8)
    ops = n_active * F * planes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", ops
    return t_ops, "operations", ops


def time_hist(bins, gpair, rel, N, B, flush, only=None, scale=None):
    """{kernel: (ms, plain_ms, library_ms)} for the kernels of a level of
    N nodes (of ``only``, when given): CUDA-event times of each kernel
    (L2 flushed), its plain version, and the nearest single PyTorch call,
    one ``index_add_`` of the four int32 planes (K2, K4) or of the f32
    (g, h) pairs (K3), with the (row, feature) cells and values prepared
    beforehand. Also the active row count. ``scale``: a mesh's quantiser
    keywords (:func:`hist_kernels`)."""
    from xgboost_tpu_torch.ops import histogram as H

    F = bins.shape[1]
    seg, active = H._segments(bins, rel, N, B)
    q, _ = H.quantise_int8x2(gpair)
    vals = H.int8x2_planes(q)[active][:, None, :].expand(-1, F, 4).reshape(
        -1, 4)
    acc = torch.zeros((N * F * B, 4), dtype=torch.int32, device=bins.device)
    lib_int = event_ms(lambda: acc.index_add_(0, seg, vals), reps=10,
                       flush=flush)
    del vals, acc
    gv = gpair[active][:, None, :].expand(-1, F, 2).reshape(-1, 2)
    accf = torch.zeros((N * F * B, 2), dtype=torch.float32,
                       device=bins.device)
    lib_f32 = event_ms(lambda: accf.index_add_(0, seg, gv), reps=10,
                       flush=flush)
    del seg, gv, accf
    out = {}
    for name, kernel, plain, make in hist_kernels(N, scale):
        if only is not None and name not in only:
            continue
        args = make(bins, gpair, rel)
        out[name] = (
            event_ms(lambda: kernel(*args, N, B), reps=20, flush=flush),
            event_ms(lambda: plain(*args, N, B), reps=5),
            lib_f32 if name in k3_precisions() else lib_int)
    return out, int(active.sum())


# (rows, nodes of the new level, bin slots, skewed): K5 at the level
# boundaries the fused runs give it (read in row order up to 16 nodes, in
# two feature tiles at 16; sorted above), with the missing-slot layout,
# and below skewed levels
K5_CASES = ((1_000_000, 2, 256, False), (1_000_000, 8, 256, False),
            (1_000_000, 16, 256, False), (1_000_000, 32, 256, False),
            (1_000_000, 128, 256, False), (1_000_000, 64, 257, False),
            (1_000_000, 8, 257, True), (1_000_000, 16, 257, True),
            (1_000_000, 128, 256, True))


def level_inputs(n, F, B, N, dev, seed, skew=False):
    """A level boundary made on the card from ``seed``: ``hist_inputs``'s
    bins and gradients; int64 positions at the previous level of N / 2
    nodes, 10% of them strays above it; that level's splits, 20% of its
    nodes not splitting. ``skew``: every node splits, 55% of the rows sit
    at its node 1 and its nodes 0 and 2 hold none."""
    bins, gpair, _ = hist_inputs(n, F, B, 1, dev, seed)
    return (bins, gpair) + level_state(bins, B, N, dev, seed + 1, skew)


def level_state(bins, B, N, dev, seed, skew=False):
    """:func:`level_inputs`' positions and splits over ``bins`` [n, F]
    (B bin slots), made from ``seed`` -> (positions, prev)."""
    from xgboost_tpu_torch.ops.partition import LevelSplits

    n, F = bins.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    n_prev = N // 2
    lo_prev = n_prev - 1
    pos = lo_prev + torch.randint(0, n_prev, (n,), generator=g, device=dev)
    stray = torch.randint(0, max(lo_prev, 1), (n,), generator=g, device=dev)
    pos = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, stray,
                      pos)
    cs = torch.rand(n_prev, generator=g, device=dev) < 0.8
    if skew:
        big = lo_prev + 1 % n_prev
        pos = torch.where((pos == lo_prev) | (pos == lo_prev + 2),
                          torch.full_like(pos, big), pos)
        pos = torch.where(torch.rand(n, generator=g, device=dev) < 0.55,
                          torch.full_like(pos, big), pos)
        cs = torch.ones_like(cs)
    feat = torch.randint(0, F, (n_prev,), generator=g, device=dev)
    thr = torch.randint(0, B - 1, (n_prev,), generator=g, device=dev)
    dleft = torch.rand(n_prev, generator=g, device=dev) < 0.5
    prev = LevelSplits(lo_prev, torch.where(cs, feat, -1),
                       torch.where(cs, thr, 0), cs & dleft, cs)
    return pos.contiguous(), prev


def check_fused(n_rows, N, B, skew, dev, seed):
    """K5 against its plain version on the same card tensors: positions
    and coarse histogram equal bit for bit on two launches, and the
    histogram equal to K2 over the coarse ids of the advanced rows.
    Returns max |kernel - plain| of the histogram."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, pos, prev = level_inputs(n_rows, 28, B, N, dev, seed, skew)
    missing = B - 1 if B > 256 else B
    lo = 2 * prev.lo + 1
    q, inv = H.quantise_int8x2(gpair)
    runs = [K.fused_advance_coarse_cuda(bins, q, inv, pos, prev, lo, N,
                                        missing) for _ in range(2)]
    want_pos, want = H.fused_advance_coarse_reference(bins, q, inv, pos,
                                                      prev, lo, N, missing)
    k2 = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q,
                            level_rel(want_pos, lo, N), inv, N, COARSE_B)
    torch.cuda.synchronize()
    err = max(float((h - want).abs().max()) for _, h in runs)
    for p, h in runs:
        if not (torch.equal(p, want_pos) and torch.equal(h, want)):
            raise AssertionError(f"fused_advance_coarse n={n_rows} N={N} "
                                 f"B={B} skew={skew}: a launch differs from "
                                 f"the plain version (max {err})")
    if not torch.equal(k2, want):
        raise AssertionError("K5's coarse histogram differs from K2's")
    moved = int((want_pos != pos).sum())
    log(f"check fused_advance_coarse n={n_rows} F=28 N={N} B={B}"
        f"{' skewed' if skew else ''} ({bins.dtype}): positions ({moved} "
        f"rows moved) and the coarse "
        f"histogram equal the plain version bit for bit on two launches, "
        f"and K2 over the coarse ids")
    return err


# (rows, nodes, bin slots, skewed): K4's fold at the scan schedule's
# levels: the root (one item a node's tile split over the card), one node
# a group (16, 128), the missing-slot layout, and a skewed level
FOLD_CASES = ((1_000_000, 1, 256, False), (1_000_000, 16, 256, False),
              (1_000_000, 128, 256, False), (1_000_000, 64, 257, False),
              (1_000_000, 128, 256, True), (10_000, 16, 257, True))


def check_fold(n_rows, N, B, skew, dev, seed):
    """K4 with its fold against the plain versions on the same card
    tensors, bit for bit on two launches: the fine histogram against
    ``build_hist_scan_reference``, the coarse one against the plain fold
    of the plain accumulators and against K2's direct build over the
    coarse ids. Returns max |kernel - plain| of the coarse histogram."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    bins, gpair, rel = hist_inputs(n_rows, 28, B, N, dev, seed, skew)
    missing = B - 1 if B > 256 else B
    q, inv = H.quantise_int8x2(gpair)
    runs = [K.hist_scan_cuda(bins, q, rel, inv, N, B, with_coarse=True,
                             missing_bin=missing) for _ in range(2)]
    acc = H.scan_acc_reference(bins, q, rel, N, B)
    want_fine = H.dequant_int8x2(acc, inv)
    want = H.dequant_int8x2(H.coarse_fold(acc, missing), inv)
    direct = K.hist_int8x2_cuda(coarse_bin_ids(bins, missing), q, rel, inv,
                                N, COARSE_B)
    torch.cuda.synchronize()
    err = max(float((c - want).abs().max()) for _, c in runs)
    label = f"n={n_rows} N={N} B={B}{' skewed' if skew else ''}"
    for fine, coarse in runs:
        if not (torch.equal(fine, want_fine) and torch.equal(coarse, want)):
            raise AssertionError(f"K4 with its fold {label}: a launch "
                                 f"differs from the plain version (max "
                                 f"{err})")
    if not torch.equal(want, direct):
        raise AssertionError("K4's folded coarse histogram differs from "
                             "K2's direct build")
    log(f"check coarse fold {label}: K4's fine and folded coarse "
        f"histograms equal the plain versions bit for bit on two launches, "
        f"and K2's direct coarse build")
    return err


def fused_bound_ms(bins, N, n_active):
    """(ms, "bytes"|"operations", ops) of K5: bins, q (8 B a row) and the
    int64 positions read once, the positions written once and the
    [N, F, 20, 2] f32 histogram written once, over 3.35 TB/s; against one
    integer add per (row in the new level, feature, plane) over the f32
    lane rate."""
    n, F = bins.shape
    nbytes = n * F * bins.element_size() + n * 8 + 2 * n * 8 + N * F * 20 * 8
    ops = n_active * F * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", ops
    return t_ops, "operations", ops


QUEUE_CYCLES = 2_000_000     # ~1 ms of device sleep ahead of each call


def queued_ms(fn, reps, flush):
    """Mean device time of ``fn`` with no host gap inside it: before each
    call the L2 is flushed (unless ``flush`` is None) and the device sleeps
    ~1 ms, so that the host has queued the whole call before its start
    event runs. ``event_ms`` instead lets a wrapper's host work show where
    the device waits."""
    return phase_ms(lambda ev: fn(), reps, flush, phases=False)[0]


def phase_ms(fn, reps, flush, phases=True):
    """Mean device time of each phase of ``fn(events)`` (a kernel wrapper
    taking ``phase_events``): start -> sort, -> tiles, -> combine and
    fold, over ``reps`` calls queued as in :func:`queued_ms`, after three
    warm-up calls (the events made and recorded once beforehand). With
    ``phases`` False: [start -> end]."""
    for _ in range(3):
        fn(None)
    k = 4 if phases else 2
    runs = [[torch.cuda.Event(enable_timing=True) for _ in range(k)]
            for _ in range(reps)]
    for ev in runs:
        for e in ev:
            e.record()
    torch.cuda.synchronize()
    for ev in runs:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(QUEUE_CYCLES)
        ev[0].record()
        if phases:
            fn(ev[1:])
        else:
            fn(None)
            ev[1].record()
    torch.cuda.synchronize()
    return [sum(ev[i].elapsed_time(ev[i + 1]) for ev in runs) / reps
            for i in range(k - 1)]


# the level widths of the HIGGS run (depth 8): K4 at each, K5 at each
# boundary
LEVEL_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)


def time_levels(dev, flush, current=True):
    """K4 at every level width (1M x 28, 256 slots) and K5 at every level
    boundary, through the calls every version of the port has: K4 as
    ``auto`` calls it (``hist_scan_cuda``) and as ``scan`` does
    (``scan_level_hists``: K4 and its coarse fold), K5
    (``fused_advance_coarse_cuda``), and K2 on K4's inputs. ``current``:
    also K4 with its fold alone, the plain versions, one ``index_add_``,
    the bounds and the phase split of this tree's kernels. Returns
    {name: {N: {...}}} and logs each level."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel
    from xgboost_tpu_torch.ops.split import COARSE_B, coarse_bin_ids

    F = 28
    out = {"hist_scan": {}, "fused_advance_coarse": {}}
    for i, N in enumerate(LEVEL_WIDTHS):
        bins, gpair, rel = hist_inputs(1_000_000, F, 256, N, dev,
                                       seed=200 + i)
        q, inv = H.quantise_int8x2(gpair)
        k4 = lambda: K.hist_scan_cuda(bins, q, rel, inv, N, 256)
        scan = lambda: H.scan_level_hists(bins, gpair, rel, N, 256, 256)
        k2 = lambda: K.hist_int8x2_cuda(bins, q, rel, inv, N, 256)
        r = {"ms": event_ms(k4, reps=20, flush=flush),
             "queued_ms": queued_ms(k4, 20, flush),
             "scan_level_queued_ms": queued_ms(scan, 20, flush),
             "k2_queued_ms": queued_ms(k2, 20, flush)}
        if current:
            seg, active = H._segments(bins, rel, N, 256)
            vals = H.int8x2_planes(q)[active][:, None, :].expand(
                -1, F, 4).reshape(-1, 4)
            acc = torch.zeros((N * F * 256, 4), dtype=torch.int32,
                              device=dev)
            r["library_ms"] = event_ms(lambda: acc.index_add_(0, seg, vals),
                                       reps=10, flush=flush)
            n_active = int(active.sum())
            del seg, vals, acc
            r["coarse_queued_ms"] = queued_ms(lambda: K.hist_scan_cuda(
                bins, q, rel, inv, N, 256, with_coarse=True, missing_bin=256),
                20, flush)
            r["plain_ms"] = event_ms(lambda: H.build_hist_scan_reference(
                bins, q, rel, inv, N, 256), reps=5)
            r["plain_coarse_ms"] = event_ms(lambda: H.dequant_int8x2(
                H.coarse_fold(H.scan_acc_reference(bins, q, rel, N, 256),
                              256), inv), reps=5)
            r["bound"] = hist_bound_ms(bins, N, 256, n_active, 4)
            r["coarse_bound"] = hist_bound_ms(bins, N, 256, n_active, 4,
                                              coarse=True)
            r["phases"] = phase_ms(lambda ev: K.hist_scan_cuda(
                bins, q, rel, inv, N, 256, phase_events=ev), 20, flush)
            r["coarse_phases"] = phase_ms(lambda ev: K.hist_scan_cuda(
                bins, q, rel, inv, N, 256, with_coarse=True, missing_bin=256,
                phase_events=ev), 20, flush)
        out["hist_scan"][N] = r
        log(f"level K4 n=1000000 N={N} x {F} u8 256 slots (L2 flushed): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()))
        del bins, gpair, rel, q, inv
    for i, N in enumerate(LEVEL_WIDTHS[1:]):
        bins, gpair, pos, prev = level_inputs(1_000_000, F, 256, N, dev,
                                              seed=220 + i)
        lo = 2 * prev.lo + 1
        q, inv = H.quantise_int8x2(gpair)
        k5 = lambda: K.fused_advance_coarse_cuda(bins, q, inv, pos, prev, lo,
                                                 N, 256)
        r = {"ms": event_ms(k5, reps=20, flush=flush),
             "queued_ms": queued_ms(k5, 20, flush)}
        if current:
            new_pos, _ = H.fused_advance_coarse_reference(
                bins, q, inv, pos, prev, lo, N, 256)
            cb = coarse_bin_ids(bins, 256)
            seg, active = H._segments(cb, level_rel(new_pos, lo, N), N,
                                      COARSE_B)
            vals = H.int8x2_planes(q)[active][:, None, :].expand(
                -1, F, 4).reshape(-1, 4)
            acc = torch.zeros((N * F * COARSE_B, 4), dtype=torch.int32,
                              device=dev)
            r["library_ms"] = event_ms(lambda: acc.index_add_(0, seg, vals),
                                       reps=10, flush=flush)
            n_active = int(active.sum())
            del seg, vals, acc, cb, new_pos
            r["plain_ms"] = event_ms(lambda: H.fused_advance_coarse_reference(
                bins, q, inv, pos, prev, lo, N, 256), reps=5)
            r["bound"] = fused_bound_ms(bins, N, n_active)
            r["phases"] = phase_ms(lambda ev: K.fused_advance_coarse_cuda(
                bins, q, inv, pos, prev, lo, N, 256, phase_events=ev), 20,
                flush)
        out["fused_advance_coarse"][N] = r
        log(f"level K5 n=1000000 N={N} x {F} u8 (L2 flushed): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()))
        del bins, gpair, pos, prev, q, inv
    return out


# K1's main-path shapes, timed through ``PackedForest.margin`` (the call
# every version of the port has): the HIGGS-shape forest at 1 and 512 rows
# (L2 warm: a server bucket), 100,000 and 1,000,000 rows (L2 flushed: a
# batch predict), and a one-tree forest at 100,000 rows (the eval walk of
# a training round, L2 flushed)
WALK_SHAPES = (("1", 1), ("512", 512), ("100000", 100_000),
               ("1000000", 1_000_000), ("Tp=1 100000", 100_000))
# both schedules, device-only, across the crossover: the server's buckets,
# 2k, 8k and 32k rows, 100,000 rows
CROSSOVER_ROWS = (1, 8, 64, 512, 2048, 8192, 32768, 100_000)


def walk_forests(dev):
    """(booster, its packed forest, its base margin, one-tree forest,
    X [1M, 28] on the card): ``make_forest_model(500, 8, 28)`` through
    ``Booster``, and ``make_forest(1, 8, 28)``, with the calls every
    version has."""
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.serve.packed import PackedForest
    from xgboost_tpu_torch.testing import make_forest, make_forest_model

    b = xt.Booster(model_file=make_forest_model(500, 8, 28, seed=0))
    trees, info = make_forest(1, 8, 28, seed=3)
    g = torch.Generator(device=dev).manual_seed(300)
    X = torch.randn(1_000_000, 28, generator=g, device=dev)
    return (b, b.packed_forest(), torch.tensor(b._base_np(), device=dev),
            PackedForest.from_trees(trees, info, 1), X)


def time_walk(dev, flush, current=True):
    """K1 at ``WALK_SHAPES`` through ``PackedForest.margin``: CUDA-event
    time (the wrapper's host work included, as a caller sees it) and
    device-only time (``queued_ms``); at 1 and 512 rows also the host
    clock of the call alone (``host_ms``, until it returns) and of the
    call and a sync (``host_sync_ms``), medians of 500. ``current``: also both schedules at
    ``CROSSOVER_ROWS`` (device-only), the plain walk at 512 and 100,000
    rows, each shape's bound, and at 100,000 and 1,000,000 rows the staged
    walk stopped at the roots (``max_depth`` 0: X staged, every chunk
    copied, every root read, no node visited), the part of its time that
    is not the walk itself. Also ``Booster.predict`` on 100,000 and
    1,000,000 rows (host clock, numpy in and out, median of 5). Returns
    {"shapes": {name: {...}}, "predict": {rows: {...}}, "schedules":
    {schedule: {rows: ms}}}."""
    import xgboost_tpu_torch as xt

    booster, pf, base, one, X = walk_forests(dev)
    zero = torch.zeros(1, device=dev)
    out = {"shapes": {}, "predict": {}}
    for label, n in WALK_SHAPES:
        f, b = (one, zero) if label.startswith("Tp=1") else (pf, base)
        Xn = X[:n].contiguous()
        cold = flush if n >= 100_000 else None
        fn = lambda: f.margin(Xn, b)
        r = {"ms": event_ms(fn, reps=10 if n >= 1_000_000 else
                            20 if cold is not None else 200, flush=cold),
             "queued_ms": queued_ms(fn, 10 if n >= 1_000_000 else 20, cold)}
        if cold is None:
            host, full = [], []
            for _ in range(500):
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append(t1 - t0)
                full.append(time.perf_counter() - t0)
            r["host_ms"] = float(np.median(host)) * 1e3
            r["host_sync_ms"] = float(np.median(full)) * 1e3
        if current:
            _, leaves = f.margin(Xn, b, leaf_index=True)
            depth = torch.from_numpy(node_depths(f)).to(dev)
            r["bound"] = walk_bound_ms(f, n, 28, int(
                depth[leaves.long()].sum()))
            del leaves
        out["shapes"][label] = r
        l2 = "L2 flushed" if cold is not None else "L2 warm"
        log(f"walk {label} rows ({l2}): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()))
    if current:
        from xgboost_tpu_torch.ops.walk import walk_packed_reference
        from xgboost_tpu_torch.serve.packed import tree_step

        from xgboost_tpu_torch.ops.cuda.walk import walk_packed_cuda

        d = pf.device_arrays(dev)
        for n in (100_000, 1_000_000):
            Xn = X[:n].contiguous()
            r = out["shapes"][str(n)]
            r["roots_ms"] = queued_ms(lambda: walk_packed_cuda(
                d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
                d["tree_group"], Xn, base, max_depth=0,
                max_feature=pf.max_feature, nodes=d["nodes"],
                spans=pf.slot_spans(), plans=pf.walk_plans(dev),
                schedule="staged"), 10, flush)
            log(f"walk {n} rows, staged, stopped at the roots (device-only, "
                f"L2 flushed): {r['roots_ms']:.6f} ms of "
                f"{r['queued_ms']:.6f} ms")
        for n in (512, 100_000):
            Xn = X[:n].contiguous()
            out["shapes"][str(n)]["plain_ms"] = event_ms(
                lambda: walk_packed_reference(
                    d["words"], d["values"], d["tree_offsets"],
                    d["tree_weight"], d["group_onehot"], Xn, base,
                    max_depth=pf.max_depth, tree_chunk=tree_step(n)),
                reps=5 if n > 512 else 20)
        out["schedules"] = {}
        for sch in ("spread", "staged"):
            row = {}
            for n in CROSSOVER_ROWS:
                Xn = X[:n].contiguous()
                row[n] = queued_ms(lambda: pf.margin(Xn, base, schedule=sch),
                                   20, flush if n >= 100_000 else None)
            out["schedules"][sch] = row
            log(f"walk schedule {sch} (device-only; L2 flushed from 100000 "
                f"rows): " + ", ".join(f"{n} rows {ms:.6f} ms"
                                       for n, ms in row.items()))
    Xh = X.cpu().numpy()
    for n in (100_000, 1_000_000):
        dm = xt.DMatrix(Xh[:n])
        booster.predict(dm)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            booster.predict(dm)
            ts.append(time.perf_counter() - t0)
        s = float(np.median(ts))
        out["predict"][n] = {"s": s, "rows_per_s": n / s}
        log(f"Booster.predict {n} rows: {s * 1e3:.3f} ms (median of 5, host "
            f"clock, numpy in and out) = {n / s:.1f} rows/s")
    return out


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6f} ms"
    if isinstance(v, tuple) and len(v) == 2:     # K1's bound
        return f"{v[0]:.6f} ms ({v[1]})"
    if isinstance(v, tuple):               # a bound
        return f"{v[0]:.6f} ms ({v[1]}; {v[2]} integer adds)"
    return "[" + ", ".join(f"{x:.6f}" for x in v) + "] ms"


# ---- the Covertype shape (BASELINE.json config #4) ---------------------------

# UCI Covertype (covtype): 581,012 rows of 54 features (10 continuous, a
# one-hot wilderness area of 4 and a one-hot soil type of 40), 7 cover
# types with these row counts; the held-out rows are extra draws
COVTYPE_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                        20_510)
COVTYPE_TEST_ROWS = 100_000
COVTYPE_PARAMS = {"objective": "multi:softprob", "num_class": 7,
                  "max_depth": 8, "eta": 0.1, "max_bin": 256,
                  "subsample": 0.8, "colsample_bytree": 0.8,
                  "colsample_bynode": 0.8, "eval_metric": "mlogloss"}
COVTYPE_ROUNDS = 30
COVTYPE_EARLY_STOP = 5


def covtype_like(seed):
    """(X [581,012 + 100,000, 54] f32, labels) with covtype's structure:
    10 continuous N(0, 1) columns, a one-hot wilderness area (4 columns,
    skewed areas) and a one-hot soil type (40 columns, Zipf-like), made
    from ``seed``. The label comes from a fixed rule plus noise: a score
    linear in the continuous columns plus an effect per area and per soil
    type, cut at covtype's class counts over the first 581,012 rows (the
    cut points then label the held-out rows), the score's 7 bands mapped
    to the classes in a fixed order."""
    rng = np.random.default_rng(seed)
    n = sum(COVTYPE_CLASS_COUNTS) + COVTYPE_TEST_ROWS
    cont = rng.standard_normal((n, 10), dtype=np.float32)
    area = rng.choice(4, n, p=(0.45, 0.05, 0.44, 0.06))
    soil_p = 1.0 / np.arange(1, 41) ** 1.1
    soil = rng.choice(40, n, p=soil_p / soil_p.sum())
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    score = (cont @ rng.standard_normal(10).astype(np.float32)
             + rng.standard_normal(4)[area] + rng.standard_normal(40)[soil]
             + 0.5 * rng.standard_normal(n))
    n_train = sum(COVTYPE_CLASS_COUNTS)
    order = (1, 0, 6, 2, 5, 4, 3)            # class of each score band
    cuts = np.sort(score[:n_train])[np.cumsum(
        [COVTYPE_CLASS_COUNTS[c] for c in order])[:-1]]
    y = np.asarray(order, np.float32)[np.searchsorted(cuts, score,
                                                      side="right")]
    return X, y


def round_masks(params, iterations, base_mask, device):
    """Every feature mask and the first tree's row sample of the Covertype
    rounds ``iterations``, drawn on ``device`` as ``train`` draws them
    (``Booster.update``'s round key, ``GBTree.do_boost``'s tree keys),
    over the features with real bins (``base_mask``) -> sha256 of their
    bytes."""
    from xgboost_tpu_torch.context import Context
    from xgboost_tpu_torch.tree.grow import draw_feature_masks
    from xgboost_tpu_torch.tree.param import TrainParam
    from xgboost_tpu_torch.utils import random as xrandom

    tp = TrainParam()
    tp.update_allow_unknown(dict(params))
    ctx = Context(device="cpu")
    h = hashlib.sha256()
    base = torch.from_numpy(base_mask).to(device)
    K = params["num_class"]
    for it in iterations:
        key = xrandom.fold_in(ctx.make_key(it), it)
        tkeys = [xrandom.fold_in(key, k) for k in range(K)]
        for tree in draw_feature_masks(tkeys, base, tp, tp.max_depth):
            for m in tree:
                h.update(m.cpu().numpy().tobytes())
        rows = xrandom.bernoulli(xrandom.fold_in(tkeys[0], 0x5AB),
                                 tp.subsample, (sum(COVTYPE_CLASS_COUNTS),),
                                 device)
        h.update(rows.cpu().numpy().tobytes())
    return h.hexdigest()


def multi_logloss(p, y):
    return float(-np.mean(np.log(np.clip(p[np.arange(len(y)),
                                           y.astype(np.int64)], 1e-16, 1))))


def merror(p, y):
    return float(np.mean(p.argmax(axis=1) != y))


def saved_bytes(bst):
    """``save_raw`` bytes with the ``hist_method`` the booster records set
    to one value, so that models of different schedules compare."""
    bst.set_param({"hist_method": "scan"})
    return bytes(bst.save_raw("ubj"))


# ---- BASELINE.json config #4 in full: categorical codes and dart ------------

# ``covtype_like``'s draws with the two qualitative attributes as codes;
# XGBoost's DART tutorial settings; the categorical defaults (area: 4
# categories, one-hot; soil: 40, sorted partition)
COVDART_PARAMS = dict(COVTYPE_PARAMS, booster="dart", sample_type="uniform",
                      normalize_type="tree", rate_drop=0.1, skip_drop=0.5,
                      max_cat_to_onehot=4, max_cat_threshold=64,
                      eval_metric=["merror", "mlogloss"])
COVDART_TYPES = ["q"] * 10 + ["c", "c"]
COVDART_DEEP_ROWS = 200_000


def covtype_codes(X):
    """``covtype_like``'s rows with the wilderness area (0-3) and soil
    type (0-39) as the codes they were drawn as, in place of their one-hot
    columns: UCI Covertype's 12 attributes, [n, 12] f32."""
    area = X[:, 10:14].argmax(axis=1)
    soil = X[:, 14:54].argmax(axis=1)
    return np.concatenate([X[:, :10], area[:, None], soil[:, None]],
                          axis=1).astype(np.float32)


def split_kinds(bst):
    """(one-hot, partition) splits in the forest: the categorical splits
    on ``area`` (4 categories) and on ``soil`` (40)."""
    onehot = part = 0
    for t in bst.gbm.trees:
        onehot += int((t.is_cat_split & (t.split_feature == 10)).sum())
        part += int((t.is_cat_split & (t.split_feature == 11)).sum())
    return onehot, part


def covertype_categorical_dart(xt, dev, Xc, yc, gbtree_quality):
    """The ``covertype_categorical_dart`` phase (module docstring):
    returns (the main-path runs' launch counts, {kernel: max |kernel -
    plain|}, K1's errors, K2's times at the categorical levels of 128
    nodes, seconds a round, device busy over three rounds)."""
    from xgboost_tpu_torch.boosting.dart import Dart
    from xgboost_tpu_torch.callback import TrainingCallback
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.serve import Server

    class WeightLog(TrainingCallback):
        """Each round's drop count and weight_drop range."""

        def __init__(self):
            self.rows = []

        def after_iteration(self, model, epoch, evals_log):
            w = model.gbm.weight_drop
            self.rows.append((drops[-1], min(w), max(w)))
            return False

    n_cov = sum(COVTYPE_CLASS_COUNTS)
    Xk = covtype_codes(Xc)
    kw = dict(feature_types=COVDART_TYPES, enable_categorical=True)
    dtr = xt.DMatrix(Xk[:n_cov], label=yc[:n_cov], **kw)
    dte = xt.DMatrix(Xk[n_cov:], label=yc[n_cov:], **kw)
    yte = yc[n_cov:]
    drops = []
    select = Dart._select_drop

    def counted(self):
        out = select(self)
        drops.append(len(out))
        return out

    Dart._select_drop = counted
    runs, raws, logs = [], [], []
    try:
        for run in range(2):
            res = {}
            wl = WeightLog()
            t0 = time.perf_counter()
            bst, c = train_launches(
                f"Covertype categorical dart run {run}",
                lambda r=res, w=wl: xt.train(
                    COVDART_PARAMS, dtr, COVTYPE_ROUNDS,
                    evals=[(dte, "test")], evals_result=r, verbose_eval=10,
                    early_stopping_rounds=COVTYPE_EARLY_STOP,
                    callbacks=[w]))
            t_run = time.perf_counter() - t0
            rounds = bst.num_boosted_rounds()
            want = {k: 0 for k in K.LAUNCHES}
            want["hist_int8x2"] = 56 * rounds
            if {k: c[k] for k in K.LAUNCHES} != want:
                raise AssertionError(f"categorical dart launched {c}, "
                                     f"expected {want}: K2 at every level "
                                     "of every class tree, K4 never")
            if c["walk_packed"] != rounds or c["walk_staged"] != rounds:
                raise AssertionError(f"categorical dart's held-out walks: "
                                     f"{c}, expected K1 once a round")
            runs.append(c)
            raws.append(bytes(bst.save_raw("ubj")))
            logs.append(wl.rows)
            log(f"train Covertype categorical dart run {run}: {rounds} "
                f"rounds in {t_run:.3f} s (host clock, sketch and binning "
                f"included on run 0); launches a round: K2 "
                f"{c['hist_int8x2'] / rounds:g}, K4 {c['hist_scan']}, K1 "
                f"{c['walk_packed'] / rounds:g}")
    finally:
        Dart._select_drop = select
    if logs[0] != logs[1]:
        raise AssertionError("two dart runs drew other drops")
    log("Covertype categorical dart drops and weight_drop range a round: "
        + "; ".join(f"[{i}] {k} dropped, w {lo:.6f}..{hi:.6f}"
                    for i, (k, lo, hi) in enumerate(logs[0])))
    digests = [hashlib.sha256(r).hexdigest() for r in raws]
    if digests[0] != digests[1]:
        raise AssertionError(f"two categorical dart runs saved different "
                             f"models: {digests}")
    log(f"Covertype categorical dart model sha256 (two runs): {digests[0]} "
        f"{digests[1]}")
    onehot, part = split_kinds(bst)
    if not (onehot > 0 and part > 0):
        raise AssertionError(f"one-hot splits {onehot}, partition splits "
                             f"{part}: both kinds must appear")
    # held-out quality, beside the one-hot gbtree phase at the same round
    mll, mer = res["test"]["mlogloss"], res["test"]["merror"]
    p = bst.predict(dte)
    if not (mll[-1] < mll[0] and np.isfinite(p).all()
            and p.shape == (COVTYPE_TEST_ROWS, 7)):
        raise AssertionError(f"categorical dart held-out mlogloss {mll[0]} "
                             f"-> {mll[-1]}")
    if abs(multi_logloss(p, yte) - mll[-1]) > 1e-5:
        raise AssertionError("Booster.predict disagrees with the eval line")
    g_mll, g_me = gbtree_quality
    last = len(mll) - 1
    log(f"Covertype categorical dart held-out: mlogloss {mll[0]} -> "
        f"{mll[-1]}, merror {mer[0]} -> {mer[-1]} (round {last}); the "
        f"one-hot gbtree phase at round {min(last, len(g_mll) - 1)}: "
        f"mlogloss {g_mll[0]} -> {g_mll[min(last, len(g_mll) - 1)]}, "
        f"merror {g_me[0]:.6f} -> {g_me[1]:.6f} (its last round); splits: "
        f"{onehot} one-hot (area), {part} partition (soil)")
    # a save/load round trip, a Server, and K1 against its plain version on
    # the trained forest (weights from 1 down, 8 left-set words)
    again = xt.Booster(model_file=raws[1])
    if not np.array_equal(again.predict(dte), p):
        raise AssertionError("the dart model's round trip predicts other "
                             "bits")
    Xte = Xk[n_cov:]
    reset_counts()
    with Server(models={"covdart": raws[1]}, max_batch=512) as srv:
        srv.warmup()
        for i in range(40):
            n = (1, 8, 64, 512)[i % 4]
            lo = (i * 1237) % (COVTYPE_TEST_ROWS - n)
            if not np.array_equal(np.asarray(srv.predict(Xte[lo:lo + n])),
                                  p[lo:lo + n]):
                raise AssertionError(f"a dart Server answer ({n} rows at "
                                     f"{lo}) differs from Booster.predict")
    serve_counts = read_counts()
    log(f"Covertype categorical dart serve: 40 requests of 1/8/64/512 rows, "
        f"every answer equal to Booster.predict; K1 "
        f"{serve_counts['walk_packed']}; save_raw round trip predicts the "
        f"same bits")
    pf = bst.packed_forest()
    if not (pf.has_cat and pf.cat_words.shape[1] == 8
            and float(pf.tree_weight[:pf.n_trees].min()) < 1.0):
        raise AssertionError("the trained dart forest packs no categorical "
                             "node or no tree weight below 1")
    Xte_dev = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    base = torch.tensor(bst._base_np(), device=dev)
    k1_errs = []
    for n in (512, 100_000):
        for sch in ("spread", "staged"):
            k1_errs.append(check_kernel(f"Covertype dart n={n}", pf,
                                        Xte_dev[:n].contiguous(), base,
                                        sch)[0])
    # seconds a round and three profiled rounds
    timer, per, s_round = seconds_per_round(COVDART_PARAMS, dtr)
    log(f"Covertype categorical dart seconds per round (update + sync, host "
        f"clock): {['%.6f' % t for t in per]}; median of rounds 1-5 "
        f"{s_round:.6f} s")
    busy, _ = profile_rounds("Covertype categorical dart", timer, dtr,
                             top=14)
    del timer
    # K2 over the category-code bins against its plain version, and its
    # time at the levels of 128 nodes
    errs = {}
    bins = dtr.binned(256, dev).bins
    g = torch.Generator(device=dev).manual_seed(140)
    gpair = torch.stack([torch.randn(n_cov, generator=g, device=dev),
                         torch.rand(n_cov, generator=g, device=dev)], dim=1)
    for N in (1, 128):
        rel = torch.randint(0, N + 1, (n_cov,), generator=g, device=dev,
                            dtype=torch.int32)
        for k, e in check_hist(bins, gpair, rel, N, 256,
                               f"category codes n={n_cov} N={N}").items():
            errs[k] = max(errs.get(k, 0.0), e)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    t, n_active = time_hist(bins, gpair, rel, 128, 256, flush)
    k2_ms, k2_plain, k2_lib = t["hist_int8x2"]
    k2_bound = hist_bound_ms(bins, 128, 256, n_active, 4)
    k2 = (k2_ms, k2_plain, k2_lib, k2_bound)
    log(f"hist hist_int8x2 category codes n={n_cov} N=128 B=256 x 12 u8 "
        f"(L2 flushed): {k2_ms:.6f} ms, plain {k2_plain:.6f} ms, "
        f"index_add_ {k2_lib:.6f} ms, bound {k2_bound[0]:.6f} ms "
        f"({k2_bound[1]})")
    del flush, gpair, rel
    # depth 10 on the first 200,000 rows, one round: K3 at the levels of
    # 256 and 512 nodes over the category codes, held to its plain version
    d10 = xt.DMatrix(Xk[:COVDART_DEEP_ROWS], label=yc[:COVDART_DEEP_ROWS],
                     **kw)
    deep, c10 = train_launches("Covertype categorical dart depth 10",
                               lambda: xt.train(dict(COVDART_PARAMS,
                                                     max_depth=10),
                                                d10, 1, verbose_eval=False))
    want = {k: 0 for k in K.LAUNCHES}
    want.update(hist_int8x2=56, hist_f32=14)
    if {k: c10[k] for k in K.LAUNCHES} != want:
        raise AssertionError(f"categorical depth 10 launched {c10}, expected "
                             f"{want}")
    if max(t.max_depth() for t in deep.gbm.trees) != 10:
        raise AssertionError("no categorical tree reached depth 10")
    bins10 = d10.binned(256, dev).bins
    g10 = torch.stack([torch.randn(COVDART_DEEP_ROWS, generator=g,
                                   device=dev),
                       torch.rand(COVDART_DEEP_ROWS, generator=g,
                                  device=dev)], dim=1)
    for N in (256, 512):
        rel = torch.randint(0, N + 1, (COVDART_DEEP_ROWS,), generator=g,
                            device=dev, dtype=torch.int32)
        for k, e in check_hist(bins10, g10, rel, N, 256,
                               f"category codes n={COVDART_DEEP_ROWS} "
                               f"N={N}").items():
            errs[k] = max(errs.get(k, 0.0), e)
    log(f"Covertype categorical dart depth 10 on {COVDART_DEEP_ROWS} rows: "
        f"launches {c10}; {sum(split_kinds(deep))} categorical splits")
    return (runs + [c10], errs, k1_errs, k2, s_round, busy,
            (raws[1], Xk[n_cov:n_cov + SHAP_COV_ROWS]))


# the HIGGS-shape training of the main path (``main`` and ``model_digests``)
# ---- BASELINE.json config #3: rank:ndcg LambdaMART at the MSLR-WEB30K shape --

# MSLR-WEB30K: 3,771,125 documents x 136 features in 31,531 queries (the
# longest 1,251 documents); Fold1 trains on 18,919 queries and holds out
# 6,306 for validation and 6,306 for test. Labels 0-4, most 0 and 1.
MSLR_FEATURES = 136
MSLR_TRAIN_QUERIES = 18_919
MSLR_TEST_QUERIES = 6_306
MSLR_MEAN_DOCS = 3_771_125 / 31_531
MSLR_MAX_DOCS = 1_251
MSLR_LABEL_SHARE = (0.514, 0.325, 0.134, 0.019, 0.008)
# the repo's MSLR-shape settings (bench.py bench_rank_unbiased, BASELINE.md
# row #3) with the reference's pair defaults
MSLR_PARAMS = {"objective": "rank:ndcg", "tree_method": "hist",
               "max_bin": 256, "lambdarank_pair_method": "mean",
               "lambdarank_num_pair_per_sample": 1, "ndcg_exp_gain": True,
               "max_depth": 6, "eta": 0.3,
               "eval_metric": ["ndcg@10", "map@10"]}
MSLR_ROUNDS = 30
MSLR_LEVELS = ((1, False), (2, False), (4, False), (8, False), (16, False),
               (32, False), (16, True), (32, True))
# bench.py's rank shape: 200,000 x 136 in 800 queries of 250
RANK_BENCH_ROWS = 200_000
RANK_BENCH_QUERIES = 800
HIST_KERNEL_NAMES = ("scan_count", "scan_scatter", "level_plan", "hist_tiles",
                     "combine_partials", "fold_partials")


def mslr_like(seed):
    """Features [n, 136] f32 N(0, 1), labels [n] and query sizes of
    18,919 + 6,306 queries (MSLR-WEB30K Fold1's training and test
    queries), made from ``seed``: sizes log-normal with MSLR's mean
    (~119.6), at most 1,251, the longest training query exactly 1,251;
    labels 0-4 in ``MSLR_LABEL_SHARE`` by the rank of a hidden linear
    score plus noise within each query."""
    rng = np.random.default_rng(seed)
    G = MSLR_TRAIN_QUERIES + MSLR_TEST_QUERIES
    sigma = 0.7
    sizes = np.clip(np.rint(rng.lognormal(
        np.log(MSLR_MEAN_DOCS) - sigma * sigma / 2, sigma, G)), 1,
        MSLR_MAX_DOCS).astype(np.int64)
    sizes[int(np.argmax(sizes[:MSLR_TRAIN_QUERIES]))] = MSLR_MAX_DOCS
    n = int(sizes.sum())
    X = rng.standard_normal((n, MSLR_FEATURES), dtype=np.float32)
    w = rng.standard_normal(MSLR_FEATURES).astype(np.float32)
    score = X @ w + 4.0 * rng.standard_normal(n).astype(np.float32)
    qid = np.repeat(np.arange(G), sizes)
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    order = np.lexsort((score, qid))        # by query, score ascending
    frac = (np.arange(n) - ptr[qid] + 0.5) / sizes[qid]
    y = np.empty(n, np.float32)
    y[order] = np.searchsorted(np.cumsum(MSLR_LABEL_SHARE)[:-1], frac)
    return X, y, sizes


def rank_bench_like(seed):
    """bench.py's rank inputs: [200,000, 136] f32 N(0, 1), labels 0-4 at
    the 0.55 / 0.75 / 0.9 / 0.97 quantiles of a linear score, 800 queries
    of 250 rows."""
    rng = np.random.RandomState(seed)
    X = rng.randn(RANK_BENCH_ROWS, MSLR_FEATURES).astype(np.float32)
    score = X @ rng.randn(MSLR_FEATURES).astype(np.float32)
    y = np.digitize(score, np.quantile(score, [0.55, 0.75, 0.9, 0.97]))
    qid = np.repeat(np.arange(RANK_BENCH_QUERIES),
                    RANK_BENCH_ROWS // RANK_BENCH_QUERIES)
    return X, y.astype(np.float32), qid


def mslr_ranking(xt, dev):
    """The ``mslr_ranking`` phase (module docstring): returns (the
    main-path runs' launch counts, {kernel: max |kernel - plain|}, K1's
    errors, the histogram kernels' times at 136 features, a summary)."""
    from xgboost_tpu_torch.metric import get_metric
    from xgboost_tpu_torch.objective.ranking import MEAN_DRAWS
    from xgboost_tpu_torch.serve.packed import PackedForest

    t0 = time.perf_counter()
    X, y, sizes = mslr_like(seed=5)
    sz_tr = sizes[:MSLR_TRAIN_QUERIES]
    n_tr = int(sz_tr.sum())
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr], group=sz_tr)
    dte = xt.DMatrix(X[n_tr:], label=y[n_tr:],
                     group=sizes[MSLR_TRAIN_QUERIES:])
    if int(sz_tr.max()) != MSLR_MAX_DOCS or \
            dtr.get_group().shape != (MSLR_TRAIN_QUERIES,):
        raise AssertionError("the MSLR-shape queries miss Fold1's shape")
    log(f"mslr_ranking: {n_tr} training rows x {MSLR_FEATURES} in "
        f"{MSLR_TRAIN_QUERIES} queries (mean {sz_tr.mean():.2f}, median "
        f"{np.median(sz_tr):.0f}, longest {sz_tr.max()}), {len(y) - n_tr} "
        f"held out in {MSLR_TEST_QUERIES}; label counts "
        f"{np.bincount(y.astype(np.int64)).tolist()}; made in "
        f"{time.perf_counter() - t0:.2f} s (host)")

    # K2, K3 and K4 over the training matrix's bins at 136 features: the
    # levels of 1 to 32 nodes, uniform and skewed, bit for bit
    t0 = time.perf_counter()
    bins = dtr.binned(MSLR_PARAMS["max_bin"], dev).bins
    if bins.shape != (n_tr, MSLR_FEATURES) or bins.dtype != torch.uint8:
        raise AssertionError(f"MSLR bins {bins.shape} {bins.dtype}")
    log(f"MSLR sketch and bins: {time.perf_counter() - t0:.2f} s (host "
        f"clock)")
    hist_errs = {}
    for i, (N, skew) in enumerate(MSLR_LEVELS):
        _, gpair, rel = hist_inputs(n_tr, 1, 256, N, dev, seed=200 + i,
                                    skew=skew)
        label = f"MSLR n={n_tr} N={N} F=136{' skewed' if skew else ''}"
        for k, e in check_hist(bins, gpair, rel, N, 256, label).items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)
        del gpair, rel
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    hist_times = {}
    for N in (1, 32):
        _, gpair, rel = hist_inputs(n_tr, 1, 256, N, dev, seed=220 + N)
        t, n_active = time_hist(bins, gpair, rel, N, 256, flush)
        for name, (ms, plain_ms, lib_ms) in t.items():
            planes = 2 if name in k3_precisions() else 4
            bound = hist_bound_ms(bins, N, 256, n_active, planes)
            hist_times[(name, N)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n={n_tr} N={N} B=256 x 136 u8 (L2 flushed): "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
                f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), "
                f"kernel at {bound[0] / ms * 100:.4f}% of it")
        del gpair, rel
    del bins, flush

    # the main path, twice: 30 rounds with the held-out queries evaluated
    # every round
    runs, raws = [], []
    for run in range(2):
        res = {}
        t0 = time.perf_counter()
        bst, c = train_launches(f"train MSLR run {run}", lambda r=res:
                                xt.train(MSLR_PARAMS, dtr, MSLR_ROUNDS,
                                         evals=[(dte, "test")],
                                         evals_result=r, verbose_eval=10))
        t_run = time.perf_counter() - t0
        depth = MSLR_PARAMS["max_depth"]
        if c["hist_scan"] != depth * MSLR_ROUNDS or c["hist_int8x2"] != 0 \
                or c["hist_f32"] != 0 or c["fused_advance_coarse"] != 0:
            raise AssertionError(f"MSLR training launched {c}, expected K4 "
                                 f"{depth} times a round")
        if c["walk_packed"] != MSLR_ROUNDS or \
                c["walk_staged"] != MSLR_ROUNDS:
            raise AssertionError(f"MSLR's held-out walks launched {c}, "
                                 "expected K1 staged once a round")
        runs.append(c)
        raws.append(saved_bytes(bst))
        log(f"train MSLR run {run}: {MSLR_ROUNDS} rounds in {t_run:.3f} s "
            f"(host clock, sketch and binning included on run 0); launches "
            f"a round: K4 {c['hist_scan'] / MSLR_ROUNDS:g}, K2 "
            f"{c['hist_int8x2'] / MSLR_ROUNDS:g}, K1 "
            f"{c['walk_packed'] / MSLR_ROUNDS:g}")
    digests = [hashlib.sha256(r).hexdigest() for r in raws]
    if digests[0] != digests[1]:
        raise AssertionError(f"two MSLR runs saved different models: "
                             f"{digests}")
    nd, mp = res["test"]["ndcg@10"], res["test"]["map@10"]
    if not nd[-1] > nd[0]:
        raise AssertionError(f"held-out ndcg@10 did not rise: {nd}")
    p_te = bst.predict(dte)
    if p_te.shape != (len(y) - n_tr,) or not np.isfinite(p_te).all() or \
            abs(get_metric("ndcg@10")(p_te, dte.info) - nd[-1]) > 1e-6:
        raise AssertionError("Booster.predict disagrees with the eval line")
    log(f"MSLR held-out: ndcg@10 {nd[0]} (round 1) -> {nd[-1]} (round "
        f"{MSLR_ROUNDS}), map@10 {mp[0]} -> {mp[-1]}; model sha256 (two "
        f"runs) {digests[0]} {digests[1]}")

    # seconds a round, three profiled rounds, and the gradient alone
    timer, per, mslr_s = seconds_per_round(MSLR_PARAMS, dtr)
    log(f"MSLR seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per]}; median of rounds 1-5 {mslr_s:.6f} s")
    busy, rows = profile_rounds("MSLR rank:ndcg", timer, dtr, top=16)
    hist_ms = sum(e.self_device_time_total for e in rows
                  if any(k in e.key for k in HIST_KERNEL_NAMES)) / 1e3
    st = timer._state_of(dtr, is_train=True)
    margin = timer._cached_margin(dtr, is_train=True)

    def gradient(it):
        return timer.obj.get_gradient(margin, st["labels"], st["weights"],
                                      it, group_ptr=dtr.info.group_ptr)

    host = []
    for it in range(9, 15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gradient(it)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in range(15, 18):
            gradient(it)
        torch.cuda.synchronize()
    grad_ms = sum(e.self_device_time_total
                  for e in device_event_rows(prof)) / 3e3
    G, L = MSLR_TRAIN_QUERIES, MSLR_MAX_DOCS
    chunk = max(1, min(G, MEAN_DRAWS // L))
    slots = -(-G // chunk) * chunk * L
    pad = 1.0 - n_tr / slots
    host_ms = float(np.median(host[1:])) * 1e3
    log(f"MSLR LambdaRank gradient: device {grad_ms:.3f} ms a round (3 "
        f"calls under torch.profiler), host {host_ms:.3f} ms a call "
        f"(median of 5, ending in a sync); [{-(-G // chunk)} x "
        f"{chunk} queries, {L}] padded layout, {slots} slots for {n_tr} "
        f"rows: pad share {pad:.4f}; histogram kernels {hist_ms / 3:.3f} ms "
        f"a round; device busy {busy / 3:.3f} ms a round")

    # K1 on the ranking forest, held to its fold replica
    Xte = torch.from_numpy(np.ascontiguousarray(X[n_tr:])).to(dev)
    pf = bst.packed_forest()
    base = torch.tensor(bst._base_np(), device=dev)
    k1_errs = [check_kernel(f"MSLR forest n={n}", pf, Xte[:n].contiguous(),
                            base, sch)[0]
               for n, sch in ((512, "spread"), (100_000, "staged"))]
    del Xte, X, dtr, dte

    # bench.py's rank shape: the other pair methods, unbiased, the other
    # two objectives, two rounds each
    Xb, yb, qid = rank_bench_like(seed=0)
    db = xt.DMatrix(Xb, label=yb, qid=qid)
    dbin = xt.DMatrix(Xb, label=(yb >= 2).astype(np.float32), qid=qid)
    variants = (("topk k=0", {"lambdarank_pair_method": "topk",
                              "lambdarank_num_pair_per_sample": 0}, db),
                ("topk k=8", {"lambdarank_pair_method": "topk",
                              "lambdarank_num_pair_per_sample": 8}, db),
                ("unbiased mean", {"lambdarank_unbiased": True}, db),
                ("unbiased topk k=8", {"lambdarank_pair_method": "topk",
                                       "lambdarank_num_pair_per_sample": 8,
                                       "lambdarank_unbiased": True}, db),
                ("rank:pairwise", {"objective": "rank:pairwise"}, db),
                ("rank:map", {"objective": "rank:map"}, dbin))
    unbiased = None
    for label, extra, dm in variants:
        r = {}
        b, c = train_launches(f"rank {label}", lambda e=extra, d=dm, r=r:
                              xt.train(dict(MSLR_PARAMS, **e), d, 2,
                                       evals=[(d, "train")], evals_result=r,
                                       verbose_eval=False))
        runs.append(c)
        if c["hist_scan"] != 12:
            raise AssertionError(f"rank {label} launched {c}")
        nd2 = r["train"]["ndcg@10"]
        if not (np.isfinite(nd2).all() and nd2[1] >= nd2[0] - 1e-3):
            raise AssertionError(f"rank {label}: ndcg@10 {nd2}")
        msg = f"rank {label} at 200,000 x 136, 800 queries: ndcg@10 {nd2}"
        if extra.get("lambdarank_unbiased"):
            ti, tj = b.obj.ti_plus, b.obj.tj_minus
            if not (np.isfinite(ti).all() and np.isfinite(tj).all()
                    and ti[0] == 1.0 and not np.allclose(ti, 1.0)):
                raise AssertionError(f"rank {label}: ti+ {ti}")
            msg += (f"; after round 2 ti+[:6] {np.round(ti[:6], 6).tolist()}"
                    f" tj-[:6] {np.round(tj[:6], 6).tolist()} ({len(ti)} "
                    f"positions)")
            if unbiased is None:
                unbiased = b
        log(msg)
    again = xt.Booster(model_file=unbiased.save_raw("ubj"))
    if not (np.array_equal(again.predict(db), unbiased.predict(db))
            and np.array_equal(again.obj.ti_plus, unbiased.obj.ti_plus)
            and np.array_equal(again.obj.tj_minus, unbiased.obj.tj_minus)):
        raise AssertionError("the unbiased model's save/load round trip "
                             "differs")
    log("the unbiased model's save_raw round trip predicts the same bits "
        "and keeps ti+ / tj-")
    summary = {"s_round": mslr_s, "busy_ms": busy, "grad_ms": grad_ms,
               "pad": pad, "ndcg": (nd[0], nd[-1]), "hist_ms": hist_ms / 3}
    return runs, hist_errs, k1_errs, hist_times, summary


AGARICUS_TRAIN_ROWS = 6_513
AGARICUS_TEST_ROWS = 1_611
AGARICUS_PARSE_ROWS = 200_000
# the agaricus demos' settings (demo/guide-python basic_walkthrough.py);
# BASELINE config #1 is reg:squarederror with rmse
AGARICUS_PARAMS = {"max_depth": 2, "eta": 1.0}
AGARICUS_RUNS = (("binary:logistic", "error"), ("reg:squarederror", "rmse"))
AGARICUS_ROUNDS = 2


def agaricus_like(seed, directory):
    """Writes ``agaricus.txt.train`` (6,513 rows) and ``agaricus.txt.test``
    (1,611 rows) into ``directory`` as XGBoost's demo files have them: a
    label and 22 sorted ``idx:1`` entries a line, one a UCI Mushroom
    attribute (``testing.MUSHROOM_CARDINALITIES``: 6, 4, 10, 2, 9, 4, 3,
    2, 12, 2, 7, 4, 4, 9, 9, 2, 4, 3, 8, 9, 6, 7, summing to 126), so
    indices run 1-126 and column 0 is never present; labels from a hidden
    rule on the odor and the spore-print color with 2% flipped
    (``testing.agaricus_rows``), made from ``seed``. Returns the two
    paths."""
    from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

    y, idx = agaricus_rows(AGARICUS_TRAIN_ROWS + AGARICUS_TEST_ROWS, seed)
    paths = []
    for name, rows in (("train", slice(0, AGARICUS_TRAIN_ROWS)),
                       ("test", slice(AGARICUS_TRAIN_ROWS, None))):
        path = os.path.join(directory, f"agaricus.txt.{name}")
        write_libsvm(path, y[rows], idx[rows])
        paths.append(path)
    return paths


def same_structure(a, b, label):
    """The tests' ``compare_tree`` rule where no near tie is allowed: the
    same nodes, splits (feature, bin, default direction), leaves within
    rtol 1e-5 plus 1e-4 and gains within 2e-4 of their scale."""
    if a.num_nodes() != b.num_nodes() or not (
            np.array_equal(a.is_leaf, b.is_leaf)
            and np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.split_bin, b.split_bin)
            and np.array_equal(a.default_left[~a.is_leaf],
                               b.default_left[~b.is_leaf])):
        raise AssertionError(f"{label}: the trees split differently")
    if not (np.allclose(a.leaf_value, b.leaf_value, rtol=1e-5, atol=1e-4)
            and np.allclose(a.gain, b.gain, rtol=2e-4, atol=2e-4)):
        raise AssertionError(f"{label}: leaves or gains differ")


def card_cpu_gap(card, cpu, label):
    """The card's trees against the CPU port's from the same inputs: the
    same structure (``same_structure``) and every float field within
    rtol 1e-5 plus 1e-5 (the f32 sums over rows run in another order on
    each device); returns {field: largest |difference|} of the fields
    (and the base margin) that differ."""
    gaps = {}
    pairs = list(zip(card.gbm.trees, cpu.gbm.trees))
    for r, (a, b) in enumerate(pairs):
        same_structure(a, b, f"{label} tree {r}")
    fields = [(f, [(getattr(a, f), getattr(b, f)) for a, b in pairs])
              for f in ("leaf_value", "split_value", "sum_hess", "gain",
                        "base_weight")]
    fields.append(("base_score", [(card._base_np(), cpu._base_np())]))
    for f, arrays in fields:
        if not all(np.allclose(x, y, rtol=1e-5, atol=1e-5)
                   for x, y in arrays):
            raise AssertionError(f"{label}: {f} differs on the card")
        g = max(float(np.max(np.abs(x.astype(np.float64) - y)))
                for x, y in arrays)
        if g > 0:
            gaps[f] = g
    return gaps


def agaricus_walkthrough(xt, dev, tmp):
    """The ``agaricus_walkthrough`` phase (BASELINE config #1 and the
    agaricus demos, module docstring): returns (the main-path runs'
    launch counts, K2's max |kernel - plain|, K1's errors, the K2 and K1
    timings, a summary)."""
    import scipy.sparse

    train_path, test_path = agaricus_like(seed=6, directory=tmp)
    t0 = time.perf_counter()
    dtr = xt.DMatrix(train_path + "?format=libsvm")
    load_s = time.perf_counter() - t0
    dte = xt.DMatrix(test_path + "?format=libsvm")
    if dtr.shape != (AGARICUS_TRAIN_ROWS, 127) or \
            dte.shape != (AGARICUS_TEST_ROWS, 127) or \
            not np.isnan(dtr.X[:, 0]).all() or \
            dtr.num_nonmissing() != 22 * AGARICUS_TRAIN_ROWS:
        raise AssertionError(f"agaricus shape: {dtr.shape} {dte.shape}")
    # the parse rate on a 200,000-row file of the same widths
    from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm

    big = os.path.join(tmp, "agaricus_200k.txt")
    write_libsvm(big, *agaricus_rows(AGARICUS_PARSE_ROWS, seed=7))
    t0 = time.perf_counter()
    dbig = xt.DMatrix(big + "?format=libsvm")
    parse_s = time.perf_counter() - t0
    if dbig.shape != (AGARICUS_PARSE_ROWS, 127):
        raise AssertionError(f"200k-row file: {dbig.shape}")
    del dbig
    log(f"agaricus_walkthrough: DMatrix(path) {load_s:.6f} s for the "
        f"{AGARICUS_TRAIN_ROWS}-row file (host clock); {AGARICUS_PARSE_ROWS}"
        f"-row file of the same widths in {parse_s:.6f} s = "
        f"{AGARICUS_PARSE_ROWS / parse_s:.1f} rows/s; positive share "
        f"{float(dtr.get_label().mean()):.4f} (train), "
        f"{float(dte.get_label().mean()):.4f} (test)")

    # K2 over the training bins at F = 127, B = 2 and the levels N = 1, 2
    bins = dtr.binned(256, dev).bins
    B = dtr.binned(256, dev).max_nbins
    if bins.shape != (AGARICUS_TRAIN_ROWS, 127) or B != 2:
        raise AssertionError(f"agaricus bins {bins.shape}, {B} slots")
    k2_err = 0.0
    for N in (1, 2):
        _, gpair, rel = hist_inputs(AGARICUS_TRAIN_ROWS, 1, B, N, dev,
                                    seed=300 + N)
        errs = check_hist(bins, gpair, rel, N, B, f"agaricus n="
                          f"{AGARICUS_TRAIN_ROWS} N={N} F=127",
                          only=("hist_int8x2",))
        k2_err = max(k2_err, errs["hist_int8x2"])
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    _, gpair, rel = hist_inputs(AGARICUS_TRAIN_ROWS, 1, B, 2, dev, seed=310)
    t, n_active = time_hist(bins, gpair, rel, 2, B, flush,
                            only=("hist_int8x2",))
    ms, plain_ms, lib_ms = t["hist_int8x2"]
    bound = hist_bound_ms(bins, 2, B, n_active, 4)
    k2_time = (ms, plain_ms, lib_ms, bound)
    log(f"hist hist_int8x2 n={AGARICUS_TRAIN_ROWS} N=2 B={B} x 127 u8 (L2 "
        f"flushed): {ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
        f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}), kernel at "
        f"{bound[0] / ms * 100:.4f}% of it")
    del gpair, rel

    # runs 1 and 2, twice each: the demo's settings, both eval sets
    runs, models, results, digests = [], {}, {}, {}
    for objective, metric in AGARICUS_RUNS:
        p = dict(AGARICUS_PARAMS, objective=objective, eval_metric=metric)
        raws = []
        for run in range(2):
            res = {}
            bst, c = train_launches(
                f"train agaricus {objective} run {run}", lambda r=res, p=p:
                xt.train(p, dtr, AGARICUS_ROUNDS,
                         evals=[(dtr, "train"), (dte, "eval")],
                         evals_result=r, verbose_eval=False))
            if c["hist_int8x2"] != 2 * AGARICUS_ROUNDS or \
                    c["hist_scan"] != 0 or c["hist_f32"] != 0 or \
                    c["walk_packed"] != AGARICUS_ROUNDS:
                raise AssertionError(f"agaricus {objective} launched {c}, "
                                     "expected K2 twice and K1 once a round")
            runs.append(c)
            raws.append(saved_bytes(bst))
        digests[objective] = [hashlib.sha256(r).hexdigest() for r in raws]
        if digests[objective][0] != digests[objective][1]:
            raise AssertionError(f"two agaricus {objective} runs saved "
                                 f"different models: {digests[objective]}")
        ev = res["eval"][metric]
        if not (np.isfinite(ev).all() and ev[-1] < ev[0]):
            raise AssertionError(f"agaricus {objective}: held-out {metric} "
                                 f"{ev}")
        models[objective], results[objective] = bst, res
        cpu = xt.train(dict(p, device="cpu"), dtr, AGARICUS_ROUNDS,
                       verbose_eval=False)
        gaps = card_cpu_gap(bst, cpu, f"agaricus {objective}")
        cpu_sha = hashlib.sha256(saved_bytes(cpu)).hexdigest()
        same = "equal" if cpu_sha == digests[objective][0] else "differ"
        log(f"agaricus {objective}: the card's trees are the CPU port's "
            f"node for node; fields that differ (largest |difference|): "
            f"{gaps or 'none'}; CPU model sha256 {cpu_sha} (the card's "
            f"bytes {same})")
        log(f"agaricus {objective}: train-{metric} {res['train'][metric]}, "
            f"eval-{metric} {ev}; model sha256 (two runs) "
            f"{digests[objective][0]} {digests[objective][1]}")
    bst = models["binary:logistic"]

    # 3. predict, save_model and a Booster from the file
    preds = bst.predict(dte)
    model_path = os.path.join(tmp, "0001.model.json")
    bst.save_model(model_path)
    if preds.shape != (AGARICUS_TEST_ROWS,) or \
            not np.isfinite(preds).all() or not np.array_equal(
                xt.Booster(model_file=model_path).predict(dte), preds):
        raise AssertionError("the saved agaricus model predicts otherwise")
    err = float(np.mean((preds > 0.5) != dte.get_label()))
    if abs(err - results["binary:logistic"]["eval"]["error"][-1]) > 1e-6:
        raise AssertionError(f"predict's error {err} is not the eval line's")
    # 4. dump_model, text and json
    bst.dump_model(os.path.join(tmp, "dump.raw.txt"))
    bst.dump_model(os.path.join(tmp, "dump.json"), dump_format="json",
                   with_stats=True)
    with open(os.path.join(tmp, "dump.raw.txt")) as fh:
        text = fh.read()
    with open(os.path.join(tmp, "dump.json")) as fh:
        dumped = json.load(fh)
    if text.count("booster[") != AGARICUS_ROUNDS or \
            len(dumped) != AGARICUS_ROUNDS or "cover" not in dumped[0]:
        raise AssertionError("agaricus dump_model")
    # 5. the test matrix through save_binary
    dte.save_binary(os.path.join(tmp, "dtest.buffer"))
    if not np.array_equal(bst.predict(xt.DMatrix(
            os.path.join(tmp, "dtest.buffer"))), preds):
        raise AssertionError("DMatrix(binary) predicts otherwise")
    # 6. scipy CSR, CSC and numpy
    Xte = dte.X
    csr = scipy.sparse.csr_matrix(np.nan_to_num(Xte))
    csr.eliminate_zeros()
    for label, data in (("CSR", csr), ("CSC", csr.tocsc()),
                        ("numpy", Xte.copy())):
        if not np.array_equal(bst.predict(xt.DMatrix(data)), preds):
            raise AssertionError(f"agaricus from {label} predicts otherwise")
    # 7. boost from prediction: one round from the 2-round margins, against
    # the third round of a 3-round model
    p1 = dict(AGARICUS_PARAMS, objective="binary:logistic",
              eval_metric="error")
    res3 = {}
    xt.train(p1, dtr, 3, evals=[(dtr, "train"), (dte, "eval")],
             evals_result=res3, verbose_eval=False)
    dtr_m = xt.DMatrix(train_path + "?format=libsvm")
    dte_m = xt.DMatrix(test_path + "?format=libsvm")
    dtr_m.set_base_margin(bst.predict(dtr, output_margin=True))
    dte_m.set_base_margin(bst.predict(dte, output_margin=True))
    res1 = {}
    xt.train(p1, dtr_m, 1, evals=[(dtr_m, "train"), (dte_m, "eval")],
             evals_result=res1, verbose_eval=False)
    for data in ("train", "eval"):
        if abs(res1[data]["error"][0] - res3[data]["error"][2]) > 1e-6:
            raise AssertionError(f"boost from prediction: {res1} vs {res3}")
    # 8. the first round alone
    first = bst.predict(dte, iteration_range=(0, 1))
    if not np.array_equal(first, bst[0:1].predict(dte)) or \
            np.array_equal(first, preds):
        raise AssertionError("iteration_range=(0, 1)")
    # 9. leaf indices, against the CPU port on the same model
    leaf = bst.predict(dte, pred_leaf=True)
    cpu_bst = xt.Booster({"device": "cpu"}, model_file=model_path)
    if leaf.shape != (AGARICUS_TEST_ROWS, AGARICUS_ROUNDS) or \
            leaf.dtype != np.int32 or not all(
                bst.gbm.trees[t].is_leaf[leaf[:, t]].all()
                for t in range(AGARICUS_ROUNDS)) or \
            not np.array_equal(leaf, cpu_bst.predict(dte, pred_leaf=True)):
        raise AssertionError("pred_leaf")

    # 10. the demo's custom logistic objective and metric
    def logregobj(margin, dm):
        prob = 1.0 / (1.0 + np.exp(-margin))
        return prob - dm.get_label(), prob * (1.0 - prob)

    def evalerror(margin, dm):
        return "my-error", float(np.mean((margin > 0.0) != dm.get_label()))

    res_c = {}
    custom, c = train_launches(
        "train agaricus custom objective", lambda:
        xt.train(dict(p1), dtr, AGARICUS_ROUNDS, obj=logregobj,
                 custom_metric=evalerror,
                 evals=[(dtr, "train"), (dte, "eval")], evals_result=res_c,
                 verbose_eval=False))
    runs.append(c)
    for r, (a, b) in enumerate(zip(bst.gbm.trees, custom.gbm.trees)):
        same_structure(a, b, f"custom objective round {r}")
    if res_c["eval"]["my-error"] != results["binary:logistic"]["eval"][
            "error"]:
        raise AssertionError(f"custom metric {res_c}")
    # 11. process_type=update: run 1's model refreshed and pruned against
    # the CPU port's (host float64 sums of gradients from margins walked by
    # K1 on the card, by the plain walk on the CPU), run 2's refreshed
    refreshed = {}
    for objective, updater in (("binary:logistic", "refresh,prune"),
                               ("reg:squarederror", "refresh")):
        raw = saved_bytes(models[objective])
        p = dict(AGARICUS_PARAMS, objective=objective,
                 process_type="update", updater=updater)
        out = {}
        for device in ("cuda", "cpu"):
            start = xt.Booster({"device": device}, model_file=raw)
            out[device] = xt.train(dict(p, device=device), dtr,
                                   AGARICUS_ROUNDS, xgb_model=start,
                                   verbose_eval=False)
        a, b = out["cuda"], out["cpu"]
        if a.num_boosted_rounds() != AGARICUS_ROUNDS:
            raise AssertionError(f"update: {a.num_boosted_rounds()} rounds")
        gap = max(float(np.max(np.abs(x.sum_hess - y.sum_hess)
                               / np.maximum(np.abs(y.sum_hess), 1e-30)))
                  for x, y in zip(a.gbm.trees, b.gbm.trees))
        exact = objective == "reg:squarederror"
        if (exact and saved_bytes(a) != saved_bytes(b)) or gap > 1e-6:
            raise AssertionError(f"update {updater} on {objective}: sum_hess "
                                 f"{gap} from the CPU's")
        refreshed[objective] = gap
    # 12. the reference-schema writer and reader
    ref_path = os.path.join(tmp, "agaricus.ubj")
    xt.save_xgboost_model(bst, ref_path)
    if not np.allclose(xt.load_xgboost_model(ref_path).predict(dte), preds,
                       rtol=1e-6, atol=1e-7):
        raise AssertionError("save_xgboost_model / load_xgboost_model")
    log(f"agaricus runs 3-12: save/load, dump_model ({len(text)} bytes of "
        f"text), DMatrix(binary), CSR / CSC / numpy the same predictions; "
        f"boost from prediction eval-error {res1['eval']['error'][0]} = the "
        f"3-round model's {res3['eval']['error'][2]}; iteration_range (0, 1)"
        f"; pred_leaf {leaf.shape} equal to the CPU's; the custom objective's"
        f" trees are run 1's; process_type=update refresh,prune sum_hess "
        f"within {refreshed['binary:logistic']:.3e} of the CPU's, refresh on"
        f" the rmse model the CPU's bytes; the reference-schema file "
        f"predicts the same")

    # seconds a round and three profiled rounds (binary:logistic)
    timer, per, s_round = seconds_per_round(
        dict(AGARICUS_PARAMS, objective="binary:logistic"), dtr)
    log(f"agaricus seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per]}; median of rounds 1-5 {s_round:.6f} s")
    busy, _ = profile_rounds("agaricus binary:logistic", timer, dtr)

    # K1 on the agaricus forest at the 1,611 test rows
    pf = bst.packed_forest()
    base = torch.tensor(bst._base_np(), device=dev)
    Xd = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    k1_err, _, schedule = check_kernel(
        f"agaricus forest n={AGARICUS_TEST_ROWS}", pf, Xd, base)
    from xgboost_tpu_torch.ops.walk import walk_packed_reference
    from xgboost_tpu_torch.serve.packed import tree_step

    d = pf.device_arrays(dev)
    _, leaves = pf.margin(Xd, base, leaf_index=True)
    depth = torch.from_numpy(node_depths(pf)).to(dev)
    k1_time = {
        "ms": event_ms(lambda: pf.margin(Xd, base), reps=200),
        "plain_ms": event_ms(lambda: walk_packed_reference(
            d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
            d["group_onehot"], Xd, base, max_depth=pf.max_depth,
            tree_chunk=tree_step(AGARICUS_TEST_ROWS)), reps=50),
        "bound": walk_bound_ms(pf, AGARICUS_TEST_ROWS, 127, int(
            depth[leaves.long()].sum())),
        "schedule": schedule}
    log(f"K1 agaricus forest {AGARICUS_TEST_ROWS} rows ({schedule}, L2 "
        f"warm): {k1_time['ms']:.6f} ms, plain {k1_time['plain_ms']:.6f} "
        f"ms, bound {k1_time['bound'][0]:.6f} ms ({k1_time['bound'][1]})")
    per_round = {k: runs[0][k] / AGARICUS_ROUNDS
                 for k in ("hist_int8x2", "walk_packed")}
    summary = {"load_s": load_s, "parse_rows_per_s":
               AGARICUS_PARSE_ROWS / parse_s, "s_round": s_round,
               "busy_ms": busy, "error": results["binary:logistic"]["eval"][
                   "error"][-1],
               "rmse": results["reg:squarederror"]["eval"]["rmse"][-1],
               "digests": digests, "per_round": per_round}
    log(f"agaricus_walkthrough: held-out error {summary['error']} and rmse "
        f"{summary['rmse']} at {AGARICUS_ROUNDS} rounds; K2 "
        f"{per_round['hist_int8x2']:g} and K1 {per_round['walk_packed']:g} "
        f"launches a round")
    return runs, k2_err, k1_err, k2_time, k1_time, summary


HIGGS_PARAMS = {"objective": "binary:logistic", "max_depth": 8, "eta": 0.1,
                "max_bin": 256}


def digest(bst) -> str:
    """sha256 of :func:`saved_bytes`."""
    return hashlib.sha256(saved_bytes(bst)).hexdigest()


def model_digests():
    """:func:`digest` of the HIGGS-shape models the main path trains
    (``auto`` 20 rounds, ``scan`` 10 rounds, evaluated on the training and
    100,000 held-out rows), through the calls every version has, so that
    two trees' model bytes compare in one run."""
    import xgboost_tpu_torch as xt

    X, y = higgs_like(1_100_000, 28, seed=0)
    dtr = xt.DMatrix(X[:1_000_000], label=y[:1_000_000])
    dte = xt.DMatrix(X[1_000_000:], label=y[1_000_000:])
    out = {}
    for method, rounds in (("auto", 20), ("scan", 10)):
        p = dict(HIGGS_PARAMS) if method == "auto" else \
            dict(HIGGS_PARAMS, hist_method=method)
        out[method] = digest(xt.train(p, dtr, rounds,
                                      evals=[(dtr, "train"), (dte, "test")],
                                      verbose_eval=False))
    log(f"model digests: {out}")
    return out


def seconds_per_round(params, dtr):
    """Six ``update`` calls between device syncs on a new booster (host
    clock); returns (the booster, all six times, the median of rounds
    1-5)."""
    import xgboost_tpu_torch as xt

    timer = xt.Booster(params)
    per_round = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.update(dtr, i)
        torch.cuda.synchronize()
        per_round.append(time.perf_counter() - t0)
    return timer, per_round, float(np.median(per_round[1:]))


def profile_rounds(label, timer, dtr, top=12):
    """Three more ``update`` rounds of ``timer`` (after its six timed ones)
    under ``torch.profiler``, timed on the host clock: the device's busy
    time summed from the profiler's device events
    (:func:`device_event_rows`), its idle share, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(6, 9):
            timer.update(dtr, i)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    rows = device_event_rows(prof)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if dev_ms <= 0:
        raise AssertionError("torch.profiler saw no device time")
    log(f"profile of 3 {label} rounds: {wall_prof * 1e3:.3f} ms on the host "
        f"clock (profiler on), device busy {dev_ms:.3f} ms, device idle "
        f"{(1 - dev_ms / (wall_prof * 1e3)) * 100:.2f}% of those rounds; "
        f"kernels by device time:")
    for e in rows[:top]:
        log(f"  {e.key[:70]:70s} n={e.count:5d} device "
            f"{e.self_device_time_total / 1e3:.3f} ms")
    return dev_ms, rows


class DeviceRow:
    """One kernel's line of :func:`device_event_rows`: its name, launches
    and device time in microseconds."""

    def __init__(self, key):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_event_rows(prof):
    """The device's events of a profile summed by name, longest first,
    from the profiler's raw events (microseconds). Summing them directly
    takes seconds where ``key_averages`` takes minutes over the hundreds
    of thousands of launches of a multi-target round."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        r = rows.setdefault(e.name(), DeviceRow(e.name()))
        r.count += 1
        r.self_device_time_total += e.duration_ns() / 1e3
    return sorted(rows.values(), key=lambda r: -r.self_device_time_total)


def higgs_like(n, F, seed, rule=False):
    """[n, F] f32 N(0, 1) features and 0/1 labels from a fixed linear rule
    plus noise, made from ``seed``; with ``rule`` also the rule's weights
    [F] (the same draws)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F), dtype=np.float32)
    w = rng.standard_normal(F).astype(np.float32)
    logit = X @ w + rng.standard_normal(n).astype(np.float32) * 1.5
    if rule:
        return X, (logit > 0).astype(np.float32), w
    return X, (logit > 0).astype(np.float32)


# the external-memory phase (``external_memory``): BASELINE.json's
# HIGGS-11M shape streamed from an iterator, 11 batches and pages of
# 1,000,000 rows, four of them in the page cache
EXT_ROWS = 11_000_000
EXT_BATCH_ROWS = 1_000_000
EXT_TEST_ROWS = 100_000
EXT_ROUNDS = 10
EXT_U4_ROUNDS = 5
EXT_DEEP_ROWS = 2_000_000
EXT_DEEP_DEPTH = 10
EXT_CACHED_PAGES = 4
EXT_SEED = 11


# higgs_batch's batches, made once: the external-memory, paged left-out,
# distributed and paged mesh phases stream the same batches of the same
# seed, each QuantileDMatrix in two passes (~1.3 GB of host memory)
_BATCHES = {}


def higgs_batch(seed, i, m, F):
    """Batch ``i`` of ``m`` rows of ``higgs_like``'s rule (N(0, 1)
    features, labels from a fixed linear rule plus noise), the rule's
    weights from ``seed`` and the batch's draws from (seed, i). Made once
    for the run; each call gets its own copy."""
    key = (seed, i, m, F)
    hit = _BATCHES.get(key)
    if hit is None:
        w = np.random.default_rng(seed).standard_normal(F).astype(
            np.float32)
        rng = np.random.default_rng([seed, i])
        X = rng.standard_normal((m, F), dtype=np.float32)
        logit = X @ w + rng.standard_normal(m).astype(np.float32) * 1.5
        hit = _BATCHES[key] = (X, (logit > 0).astype(np.float32))
    return hit[0].copy(), hit[1].copy()


def higgs_batches(xt, n_rows, F, cache_prefix, seed=EXT_SEED):
    """A ``DataIter`` over the first ``n_rows`` rows of ``higgs_batch``'s
    stream, ``EXT_BATCH_ROWS`` a batch, made anew on every pass (the raw
    matrix never exists whole)."""

    class Batches(xt.DataIter):
        def __init__(self):
            super().__init__(cache_prefix)
            self.i = 0

        def next(self, input_data):
            s = self.i * EXT_BATCH_ROWS
            if s >= n_rows:
                return 0
            X, y = higgs_batch(seed, self.i, min(EXT_BATCH_ROWS, n_rows - s),
                               F)
            input_data(data=X, label=y)
            self.i += 1
            return 1

        def reset(self):
            self.i = 0

    return Batches()


def xtpu_env():
    """The ``XTPU_*`` settings in force."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("XTPU_")}


def paged_rounds(xt, params, dm, paged, rounds=6):
    """``rounds`` ``update`` calls of a new booster on the paged matrix
    between device syncs (host clock), each with the ring's statistics
    and the kernels' launches reset before it -> (the booster, [(seconds,
    uploads, H2D bytes, overlap, launches)], the launches of all)."""
    timer = xt.Booster(params)
    per, total = [], {}
    for i in range(rounds):
        paged.reset_ring_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.update(dm, i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = read_counts()
        st = paged.ring_stats
        per.append((dt, st["uploads"], st["bytes"], paged.streaming_overlap(),
                    {k: v for k, v in c.items() if v}))
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return timer, per, total


def pass_peak_bytes(xt, params, dm):
    """One round of ``params`` on the paged matrix ``dm``: the largest
    peak of the card's allocated memory during one pass over the pages
    (``tree/paged.py _PageKernels._drive``), over what was allocated when
    that pass began."""
    from xgboost_tpu_torch.tree import paged as P

    drive, peak = P._PageKernels._drive, [0]

    def measured(*a, **k):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = drive(*a, **k)
        torch.cuda.synchronize()
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated() - start)
        return out

    P._PageKernels._drive = staticmethod(measured)
    try:
        with NoPlainBuilds():
            xt.train(params, dm, 1, verbose_eval=False)
    finally:
        P._PageKernels._drive = staticmethod(drive)
    return peak[0]


def u4_inputs(n, F, N, dev, seed, skew=False):
    """``hist_inputs``' 16-slot ids, u4-packed as the paged tier packs them
    (``PagedBinnedMatrix._pack_host``) -> (packed, ids, gpair, rel)."""
    from xgboost_tpu_torch.data.binned import PagedBinnedMatrix

    bins, gpair, rel = hist_inputs(n, F, 16, N, dev, seed, skew)
    packed = torch.from_numpy(PagedBinnedMatrix._pack_host(
        bins.cpu().numpy())).to(dev)
    return packed, bins, gpair, rel


def u4_kernels(N, F):
    """K2's and K3's ``packed_u4`` bodies at a level of N nodes: (name,
    kernel(packed args), plain version(packed args), the unpacked
    kernel(ids args), maker of the args)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K

    def int8x2_args(bins, gpair, rel):
        q, inv = H.quantise_int8x2(gpair)
        return q, rel, inv

    def f32_args(bins, gpair, rel):
        qs, inv = H.fixed_point_scale(gpair)
        return gpair, rel, qs, inv

    out = [(f"{name}_u4",
            lambda p, *a, N=N, prec=prec: K.hist_f32_cuda(
                p, *a, N, 16, precision=prec, packed_u4=F),
            lambda p, *a, N=N, prec=prec: H.build_hist_f32_u4_reference(
                p, F, *a, N, 16, precision=prec),
            lambda b, *a, N=N, prec=prec: K.hist_f32_cuda(
                b, *a, N, 16, precision=prec), f32_args)
           for name, prec in k3_precisions().items()]
    if N <= 128:
        out.append((
            "hist_int8x2_u4",
            lambda p, *a: K.hist_int8x2_cuda(p, *a, N, 16, packed_u4=F),
            lambda p, *a: H.build_hist_int8x2_u4_reference(p, F, *a, N, 16),
            lambda b, *a: K.hist_int8x2_cuda(b, *a, N, 16), int8x2_args))
    return out


# (rows, features, nodes, skewed): a 1M-row page at the u4 run's levels
U4_CASES = ((1_000_000, 28, 1, False), (1_000_000, 28, 16, True),
            (1_000_000, 28, 128, False), (1_000_000, 28, 128, True),
            (1_000_000, 28, 512, False), (1_000_000, 28, 512, True),
            (1_000_000, 27, 128, True), (1_000_000, 27, 256, False))


def check_u4(n, F, N, skew, dev, seed):
    """K2-u4 and K3-u4 (three precisions) on a packed page: equal bit for
    bit on two launches to their plain versions and to the same kernel on
    the unpacked ids. Returns {kernel: max |kernel - plain|}."""
    packed, bins, gpair, rel = u4_inputs(n, F, N, dev, seed, skew)
    errs = {}
    for name, kernel, plain, flat, make in u4_kernels(N, F):
        args = make(bins, gpair, rel)
        runs = [kernel(packed, *args) for _ in range(2)]
        want = plain(packed, *args)
        unpacked = flat(bins, *args)
        torch.cuda.synchronize()
        errs[name] = max(float((r - want).abs().max()) for r in runs)
        if not all(torch.equal(r, want) for r in runs) or \
                not torch.equal(unpacked, want):
            raise AssertionError(f"{name} n={n} F={F} N={N}: differs from "
                                 f"its plain version or the unpacked kernel")
    log(f"check u4 n={n} F={F} N={N}{' skewed' if skew else ''}: "
        f"{sorted(errs)} equal their plain versions and the unpacked-page "
        f"kernels bit for bit on two launches")
    return errs


def time_u4(n, F, N, dev, flush, seed):
    """{kernel: (ms, plain_ms, library_ms, bound)} of the u4 bodies at a
    page of n rows and N nodes (L2 flushed): the library call is one
    ``unpack_u4`` and one ``index_add_`` over the unpacked ids (the
    cells prepared beforehand), the decode counted."""
    from xgboost_tpu_torch.ops import histogram as H

    packed, bins, gpair, rel = u4_inputs(n, F, N, dev, seed)
    seg, active = H._segments(bins, rel, N, 16)
    q, _ = H.quantise_int8x2(gpair)
    vals = H.int8x2_planes(q)[active][:, None, :].expand(-1, F, 4).reshape(
        -1, 4)
    acc = torch.zeros((N * F * 16, 4), dtype=torch.int32, device=dev)
    lib_int = event_ms(lambda: (H.unpack_u4(packed, F),
                                acc.index_add_(0, seg, vals)), reps=10,
                       flush=flush)
    del vals, acc
    gv = gpair[active][:, None, :].expand(-1, F, 2).reshape(-1, 2)
    accf = torch.zeros((N * F * 16, 2), dtype=torch.float32, device=dev)
    lib_f32 = event_ms(lambda: (H.unpack_u4(packed, F),
                                accf.index_add_(0, seg, gv)), reps=10,
                       flush=flush)
    del seg, gv, accf
    out = {}
    for name, kernel, plain, _, make in u4_kernels(N, F):
        args = make(bins, gpair, rel)
        planes = 4 if name == "hist_int8x2_u4" else 2
        out[name] = (
            event_ms(lambda: kernel(packed, *args), reps=20, flush=flush),
            event_ms(lambda: plain(packed, *args), reps=5),
            lib_int if planes == 4 else lib_f32,
            hist_bound_ms(packed, N, 16, int(active.sum()), planes, F=F))
    return out


def external_memory(xt, dev, F, tmp):
    """The external-memory phase: ``xt.train`` on a ``QuantileDMatrix``
    built from an iterator with a ``cache_prefix`` at the HIGGS-11M shape
    (the bins a memmap under ``tmp``, 11 pages of 1,000,000 rows, four in
    the page cache), 10 rounds at depth 8 with K4 on every page and
    level; its ring, launches, seconds and profile a round; model bytes
    under budgets of 0, 4 and 11 pages and across two runs; the u4 run
    (max_bin 16, packed pages, K2-u4) against the same with
    ``XTPU_PAGE_PACK=0``, depth 10 on 2,000,000 rows (K3-u4 at 256 and
    512 nodes) and a round each through ``pallas:bf16x2`` / ``:bf16``;
    ``Booster.predict`` on a paged matrix; the default budget's collapse
    to the resident tier. Returns (the main-path launch counts of every
    run, the device's busy ms over three profiled rounds, seconds a
    round)."""
    from xgboost_tpu_torch.data.binned import BinnedMatrix

    page = EXT_BATCH_ROWS * F                  # u8 bytes of a page
    os.environ.update({"XTPU_PAGED_COLLAPSE": "0",
                       "XTPU_PAGE_CACHE_BYTES": str(EXT_CACHED_PAGES * page)})
    params = dict(HIGGS_PARAMS)
    depth = params["max_depth"]
    t0 = time.perf_counter()
    dm = xt.QuantileDMatrix(higgs_batches(xt, EXT_ROWS, F, f"{tmp}/b256"),
                            max_bin=256)
    t_build = time.perf_counter() - t0
    paged = dm.binned(256, dev)
    n_pages = -(-EXT_ROWS // EXT_BATCH_ROWS)
    n_streamed = n_pages - EXT_CACHED_PAGES
    if not (dm.is_paged and paged.n_pages() == n_pages and not paged.packed
            and isinstance(paged.bins_host, np.memmap)
            and paged.page_nbytes() == page):
        raise AssertionError("the iterator matrix is not the paged tier")
    Xte, yte = higgs_batch(EXT_SEED, 10_000, EXT_TEST_ROWS, F)
    dte = xt.DMatrix(Xte, label=yte)
    log(f"external memory: iterator matrix of {EXT_ROWS} x {F} built in "
        f"{t_build:.3f} s (sketch of {n_pages} batches, then binning into a "
        f"{paged.bins_host.nbytes} B memmap); {paged.n_pages()} pages of "
        f"{paged.page_nbytes()} B; settings {xtpu_env()}")
    runs = []

    def run(label, p, d, rounds, **kw):
        b, c = train_launches(label, lambda: xt.train(p, d, rounds,
                                                      verbose_eval=False,
                                                      **kw))
        runs.append(c)
        return b, c

    res = {}
    bst, c = run("external memory run 1", params, dm, EXT_ROUNDS,
                 evals=[(dte, "test")], evals_result=res)
    want = {k: 0 for k in c if k.startswith("hist") or k.startswith("fused")}
    want["hist_scan"] = n_pages * depth * EXT_ROUNDS
    if {k: c[k] for k in want} != want or c["walk_packed"] < EXT_ROUNDS:
        raise AssertionError(f"external memory launched {c}, expected K4 "
                             f"{n_pages * depth} times a round (pages x "
                             "levels) and K1 for the held-out evaluation")
    if bst._caches[id(dm)]["binned"] is not paged:
        raise AssertionError("the paged matrix collapsed to the resident tier")
    cached, streamed = paged.cached_split(dev)
    if len(cached) != EXT_CACHED_PAGES or len(streamed) != n_streamed:
        raise AssertionError(f"{len(cached)} pages cached, {len(streamed)} "
                             "streamed")
    ll = res["test"]["logloss"]
    if not (all(b < a for a, b in zip(ll, ll[1:]))):
        raise AssertionError(f"held-out logloss did not fall: {ll}")
    p_te = bst.predict(dte)
    auc_paged = auc(yte, p_te)
    auc_first = auc(yte, bst.predict(dte, iteration_range=(0, 1)))
    log(f"external memory: tier paged (not collapsed), {len(cached)} pages "
        f"cached and {len(streamed)} streamed; held-out logloss {ll[0]} -> "
        f"{ll[-1]}, AUC {auc_first:.6f} -> {auc_paged:.6f} (rounds 1 and "
        f"{EXT_ROUNDS})")
    digests = {"4 pages": digest(bst)}

    # a round: seconds, the ring's uploads and bytes, launches; then three
    # profiled rounds for the device's busy time and idle share
    timer, per, total = paged_rounds(xt, params, dm, paged)
    runs.append(total)
    for i, (dt, ups, nbytes, ov, cnt) in enumerate(per):
        log(f"external memory round {i}: {dt:.6f} s (update + sync, host "
            f"clock), ring uploads {ups}, H2D {nbytes} B, overlap "
            f"{ov if ov is None else round(ov, 6)}, launches {cnt}")
        if ups != (depth + 1) * n_streamed or \
                nbytes != ups * page or \
                cnt.get("hist_scan") != n_pages * depth:
            raise AssertionError(
                f"a warm round did not upload the {n_streamed} streamed pages "
                f"once a pass ({depth + 1} passes) or launch K4 "
                f"{n_pages * depth} times")
    s_round = float(np.median([p[0] for p in per[1:]]))
    ups = (depth + 1) * n_streamed
    log(f"external memory: {s_round:.6f} s a round (median of rounds 1-5); "
        f"{ups} uploads and {ups * page} B of H2D a round")
    reset_counts()
    busy, _ = profile_rounds("external memory", timer, dm, top=12)
    runs.append(read_counts())

    # model bytes under budgets of 0 and 11 pages, and a second run at 4
    for pages in (0, n_pages, EXT_CACHED_PAGES):
        paged.set_cache_budget(pages * page)
        b, _ = run(f"external memory budget {pages} pages", params, dm,
                   EXT_ROUNDS)
        if paged.cached_pages(dev) != pages:
            raise AssertionError(f"budget {pages}: "
                                 f"{paged.cached_pages(dev)} pages cached")
        digests[f"{pages} pages" if pages != EXT_CACHED_PAGES
                else "4 pages, run 2"] = digest(b)
    log(f"external memory model sha256: {digests}")
    if len(set(digests.values())) != 1:
        raise AssertionError("budgets or runs saved different models")

    # the u4 run: max_bin 16, pages packed two ids a byte
    p16 = dict(params, max_bin=16)
    t0 = time.perf_counter()
    dm16 = xt.QuantileDMatrix(higgs_batches(xt, EXT_ROWS, F, f"{tmp}/b16"),
                              max_bin=16)
    t16 = time.perf_counter() - t0
    paged16 = dm16.binned(16, dev)
    if not paged16.packed or paged16.page_nbytes() != page // 2:
        raise AssertionError("the 16-bin pages are not u4-packed")
    paged16.reset_ring_stats()
    b16, c16 = run("external memory u4", p16, dm16, EXT_U4_ROUNDS)
    if c16["hist_int8x2_u4"] != n_pages * depth * EXT_U4_ROUNDS or \
            c16["hist_int8x2"] or c16["hist_scan"]:
        raise AssertionError(f"the u4 run launched {c16}, expected K2-u4 "
                             f"{n_pages * depth} times a round")
    u4_bytes = paged16.ring_stats["bytes"]
    _, per16, tot16 = paged_rounds(xt, p16, dm16, paged16, rounds=4)
    runs.append(tot16)
    for i, (dt, ups, nbytes, ov, cnt) in enumerate(per16):
        log(f"external memory u4 round {i}: {dt:.6f} s (update + sync, "
            f"host clock), ring uploads {ups}, H2D {nbytes} B, overlap "
            f"{ov if ov is None else round(ov, 6)}, launches {cnt}")
    os.environ["XTPU_PAGE_PACK"] = "0"
    dm16u = xt.QuantileDMatrix(higgs_batches(xt, EXT_ROWS, F, f"{tmp}/b16u"),
                               max_bin=16, ref=dm16)
    paged16u = dm16u.binned(16, dev)
    del os.environ["XTPU_PAGE_PACK"]
    paged16u.reset_ring_stats()
    b16u, c16u = run("external memory u4, XTPU_PAGE_PACK=0", p16, dm16u,
                     EXT_U4_ROUNDS)
    if paged16u.packed or \
            c16u["hist_int8x2"] != n_pages * depth * EXT_U4_ROUNDS:
        raise AssertionError(f"the unpacked run launched {c16u}")
    if digest(b16) != digest(b16u):
        raise AssertionError("packed and unpacked transport saved different "
                             "models")
    log(f"external memory u4 (max_bin 16, built in {t16:.3f} s, pages of "
        f"{paged16.page_nbytes()} B, {paged16.cached_pages(dev)} cached): "
        f"model sha256 {digest(b16)} equal with XTPU_PAGE_PACK=0 (pages of "
        f"{paged16u.page_nbytes()} B, {paged16u.cached_pages(dev)} cached); "
        f"H2D {u4_bytes} B packed against {paged16u.ring_stats['bytes']} B "
        f"unpacked over {EXT_U4_ROUNDS} rounds")

    # depth 10 on the first 2,000,000 rows: levels of 256 and 512 nodes
    # through K3-u4, and K3-u4's rounded precisions at every level
    dm2 = xt.QuantileDMatrix(higgs_batches(xt, EXT_DEEP_ROWS, F,
                                           f"{tmp}/b16d"), max_bin=16,
                             ref=dm16)
    dd, d_pages = EXT_DEEP_DEPTH, -(-EXT_DEEP_ROWS // EXT_BATCH_ROWS)
    k2, k3 = d_pages * min(dd, 8), d_pages * max(dd - 8, 0)
    b10, c10 = run(f"external memory u4 depth {dd}", dict(p16, max_depth=dd),
                   dm2, 2)
    if c10["hist_int8x2_u4"] != k2 * 2 or c10["hist_f32_u4"] != k3 * 2 or \
            max(t.max_depth() for t in b10.gbm.trees) != dd:
        raise AssertionError(f"depth {dd} u4 launched {c10}, expected K2-u4 "
                             f"{k2} and K3-u4 {k3} times a round")
    for prec in ("bf16x2", "bf16"):
        name = f"hist_{prec}_u4"
        _, cb = run(f"external memory u4 pallas:{prec}",
                    dict(p16, max_depth=dd, hist_method=f"pallas:{prec}"),
                    dm2, 1)
        if cb[name] != d_pages * dd:
            raise AssertionError(f"pallas:{prec} launched {cb}, expected "
                                 f"{name} {d_pages * dd} times (pages x "
                                 "levels)")
    # Booster.predict on a paged matrix: its representative values through
    # K1, against the margin the cache walked over its bins
    reset_counts()
    pm = b10.predict(dm2, output_margin=True)
    walked = b10.gbm.full_margin_binned(
        dm2.binned(16, dev),
        torch.tensor(b10._base_np(), device=dev)).cpu().numpy()[:, 0]
    runs.append(read_counts())
    if runs[-1]["walk_packed"] != 1 or pm.shape != (EXT_DEEP_ROWS,) or \
            not np.isfinite(pm).all():
        raise AssertionError("predict on the paged matrix did not walk K1")
    err = float(np.abs(pm - walked).max())
    if err > 1e-5:
        raise AssertionError(f"predict on the paged matrix is {err} from the "
                             "walk over its bins")
    log(f"external memory predict on the paged {EXT_DEEP_ROWS}-row matrix: "
        f"K1 over its representative values, {err} from the walk over its "
        f"pages' bins")

    # the default budget (4 GiB) collapses the 308 MB matrix to the
    # resident tier: the same 11M rows trained resident
    del os.environ["XTPU_PAGED_COLLAPSE"]
    del os.environ["XTPU_PAGE_CACHE_BYTES"]
    paged.set_cache_budget()
    res_r = {}
    bres, cres = run("external memory default budget", params, dm,
                     EXT_ROUNDS, evals=[(dte, "test")], evals_result=res_r)
    if not isinstance(bres._caches[id(dm)]["binned"], BinnedMatrix) or \
            paged._resident is None or cres["hist_scan"] != depth * EXT_ROUNDS:
        raise AssertionError(f"the default budget did not collapse ({cres})")
    llr = res_r["test"]["logloss"]
    auc_r0 = auc(yte, bres.predict(dte, iteration_range=(0, 1)))
    log(f"external memory default budget ({paged.cache_budget_bytes} B, "
        f"settings {xtpu_env()}): collapsed to the resident tier, K4 "
        f"{depth} times a round on {EXT_ROWS} rows; held-out logloss "
        f"{llr[0]} -> {llr[-1]}, AUC {auc_r0:.6f} -> "
        f"{auc(yte, bres.predict(dte)):.6f} (paged: {ll[0]} -> {ll[-1]}, "
        f"AUC {auc_first:.6f} -> {auc_paged:.6f})")
    return runs, busy, s_round, dm


# ---- the external-memory tier's left-outs (``paged_left_outs``) -------------

PLO_ROUNDS = 3              # each two-level method, and the categorical run
PLO_LG_PAGES = 4            # lossguide, constraints, approx and resume rows
PLO_LG_ROUNDS = 2
PLO_APPROX_PAGES = 2
PLO_LINEAR_ROUNDS = 5
PLO_COV_PAGE_ROWS = 100_000
PLO_MM_PAGE_ROWS = 8_192
PLO_MM_LG_LEAVES = 16
PLO_RESUME_ROUNDS = 10
PLO_LG_CACHED = 2           # of the 4 pages: the ring uploads the others
# card against the CPU port: (rows, page rows) of HIGGS, Covertype and
# MediaMill; one page of two cached
PLO_GAP_HIGGS = (200_000, 100_000)
PLO_GAP_COV = (100_000, 50_000)
PLO_GAP_MM = (4_096, 2_048)
PLO_GAP_MM_DEPTH = 3        # of MM_PARAMS' 6: the CPU's 101 builds a level
PLO_GAP_LG_LEAVES = 63


def typed_batches(xt, X, y, rows, types, cache_prefix):
    """A ``DataIter`` over the rows of X in batches of ``rows``, each batch
    announcing ``types`` (``feature_types``)."""

    class Batches(xt.DataIter):
        def __init__(self):
            super().__init__(cache_prefix)
            self.i = 0

        def next(self, input_data):
            s = self.i * rows
            if s >= len(X):
                return 0
            input_data(data=X[s:s + rows], label=y[s:s + rows],
                       feature_types=types)
            self.i += 1
            return 1

        def reset(self):
            self.i = 0

    return Batches()


def paged_left_outs(xt, dev, F, tmp, dm, Xk, yk):
    """The ``paged_left_outs`` phase (module docstring), on the external
    memory phase's HIGGS-11M matrix ``dm`` (11 pages of 1,000,000 rows, 4
    in the page cache), with Covertype's codes ``Xk`` (``covtype_codes``
    of its training rows) and their labels ``yk``: returns (the
    main-path launch counts of every run, the figures it logs)."""
    from xgboost_tpu_torch.tree.param import (parse_interaction_constraints,
                                              parse_monotone_constraints)
    from xgboost_tpu_torch.utils.checkpoint import CheckpointConfig

    t_phase = time.perf_counter()
    page = EXT_BATCH_ROWS * F
    os.environ.update({"XTPU_PAGED_COLLAPSE": "0",
                       "XTPU_PAGE_ROWS": str(EXT_BATCH_ROWS),
                       "XTPU_PAGE_CACHE_BYTES": str(EXT_CACHED_PAGES * page)})
    paged = dm.binned(256, dev)
    n_pages = paged.n_pages()
    depth = HIGGS_PARAMS["max_depth"]
    Xte, yte = higgs_batch(EXT_SEED, 10_000, EXT_TEST_ROWS, F)
    dte = xt.DMatrix(Xte, label=yte)
    runs, out = [], {}

    def run(label, fn):
        with NoPlainBuilds():
            b, c = train_launches(label, fn)
        runs.append(c)
        return b, c

    # -- the two-level schedules on pages: four names, three budgets
    digests, rounds_of = {}, {}
    for method, cached in (("coarse", EXT_CACHED_PAGES),
                           ("fused", EXT_CACHED_PAGES),
                           ("scan", EXT_CACHED_PAGES),
                           ("mega", EXT_CACHED_PAGES),
                           ("coarse", 0), ("coarse", n_pages)):
        paged.set_cache_budget(cached * page)
        streamed = n_pages - cached
        with NoPlainBuilds():
            timer, per, total = paged_rounds(
                xt, dict(HIGGS_PARAMS, hist_method=method), dm, paged,
                rounds=PLO_ROUNDS)
        runs.append(total)
        label = f"{method}, {cached} pages cached"
        digests[label] = digest(timer)
        for i, (dt, ups, nbytes, ov, cnt) in enumerate(per):
            log(f"paged two-level {label} round {i}: {dt:.6f} s (update + "
                f"sync, host clock), ring uploads {ups}, H2D {nbytes} B, "
                f"launches {cnt}")
        # every page builds its coarse (K2) and its fine histogram (K4)
        # at every level, cached or uploaded
        want = {"hist_int8x2": depth * n_pages, "hist_scan": depth * n_pages}
        for dt, ups, nbytes, ov, cnt in per[1:]:
            if cnt != want or ups != (depth + 1) * streamed:
                raise AssertionError(
                    f"paged {label}: a warm round launched {cnt} and "
                    f"uploaded {ups} pages, expected {want} and "
                    f"{(depth + 1) * streamed} uploads")
        rounds_of[label] = float(np.median([p[0] for p in per[1:]]))
    if len(set(digests.values())) != 1:
        raise AssertionError(f"the paged two-level runs saved different "
                             f"models: {digests}")
    log(f"paged two-level: one model sha256 {set(digests.values())} over "
        f"{sorted(digests)}; seconds a round (median of rounds 1-"
        f"{PLO_ROUNDS - 1}) {rounds_of}; a warm round uploads each streamed "
        f"page {depth + 1} times (depth + 1 matrix-equivalents of the "
        f"streamed pages, where a refine re-read would make "
        f"{2 * depth + 1})")
    out["two_level_s"] = rounds_of

    # -- the device memory of a two-level pass under budget 0: the same at
    # 4 pages and at 11 (one coarse and one fine accumulator, whatever the
    # number of pages), where a fine partial held a page would add 7
    n4 = PLO_LG_PAGES * EXT_BATCH_ROWS
    dm4 = xt.QuantileDMatrix(higgs_batches(xt, n4, F, f"{tmp}/lo4"),
                             max_bin=256, ref=dm)
    p4 = dm4.binned(256, dev)
    if not (dm4.is_paged and p4.n_pages() == PLO_LG_PAGES):
        raise AssertionError("the 4-page matrix is not paged")
    peaks = {}
    for d, pd in ((dm, paged), (dm4, p4)):
        pd.set_cache_budget(0)
        peaks[pd.n_pages()] = pass_peak_bytes(
            xt, dict(HIGGS_PARAMS, hist_method="coarse"), d)
    fine_acc = 2 ** (depth - 1) * F * 257 * 2 * 4
    log(f"paged two-level pass's device memory under budget 0 (the peak "
        f"over the pass's start, bytes, by pages): {peaks}; a fine "
        f"partial at {2 ** (depth - 1)} nodes: {fine_acc} B")
    if peaks[n_pages] - peaks[PLO_LG_PAGES] > fine_acc:
        raise AssertionError("the paged two-level pass's device memory "
                             "grows with the number of pages")
    out["pass_peak_bytes"] = peaks
    paged.set_cache_budget(EXT_CACHED_PAGES * page)

    # -- the first 4 pages, 2 of them cached: lossguide (and all 4),
    # constraints and resume (the ring uploads the other 2 on every pass)
    def ring_used(label):
        if not (p4.ring_stats["uploads"] and
                p4.cached_pages(dev) == PLO_LG_CACHED):
            raise AssertionError(f"{label}: {p4.ring_stats['uploads']} "
                                 f"uploads, {p4.cached_pages(dev)} pages "
                                 "cached")
        return p4.ring_stats["uploads"]

    lg = dict(HIGGS_PARAMS, grow_policy="lossguide", max_leaves=255,
              max_depth=0)
    # two runs: 2 of the 4 pages cached, then all 4
    lg_digests, lg_s = [], []
    for i, cached in enumerate((PLO_LG_CACHED, PLO_LG_PAGES)):
        p4.set_cache_budget(cached * page)
        p4.reset_ring_stats()
        t0 = time.perf_counter()
        b, c = run(f"paged lossguide run {i + 1}", lambda: xt.train(
            lg, dm4, PLO_LG_ROUNDS, verbose_eval=False))
        lg_s.append(time.perf_counter() - t0)
        if i == 0:
            lg_up = ring_used("paged lossguide")
        pairs = sum(t.num_leaves() for t in b.gbm.trees)
        want = {k: 0 for k in c if k.startswith(("hist", "fused"))}
        want["hist_scan"] = PLO_LG_PAGES * pairs
        if {k: c[k] for k in want} != want:
            raise AssertionError(f"paged lossguide launched {c}, expected K4 "
                                 f"{PLO_LG_PAGES} times a pair")
        lg_digests.append(digest(b))
    if len(set(lg_digests)) != 1:
        raise AssertionError("paged lossguide: the two budgets saved "
                             "different models")
    p4.set_cache_budget(PLO_LG_CACHED * page)
    log(f"paged lossguide (max_leaves 255, max_depth 0, {PLO_LG_ROUNDS} "
        f"rounds on {n4} rows in {PLO_LG_PAGES} pages): leaves "
        f"{[t.num_leaves() for t in b.gbm.trees]}, one sha256 "
        f"{lg_digests[0]} with {PLO_LG_CACHED} pages cached ({lg_up} "
        f"uploads) and with all {PLO_LG_PAGES}; {lg_s[0]:.3f} / "
        f"{lg_s[1]:.3f} s")
    out["lossguide_s"] = lg_s

    # depthwise under the lossguide_constraints phase's constraints
    w = np.random.default_rng(EXT_SEED).standard_normal(F).astype(np.float32)
    top = np.argsort(-np.abs(w))[:LG_MONO_FEATURES]
    signs = [int(np.sign(w[f])) if f in top else 0 for f in range(F)]
    mono = "(" + ",".join(str(v) for v in signs) + ")"
    cons = parse_interaction_constraints(LG_SETS, F)
    if parse_monotone_constraints(mono, F) != signs:
        raise AssertionError("the monotone string does not parse back")
    res = {}
    p4.reset_ring_stats()
    t0 = time.perf_counter()
    bc, cc = run("paged constrained depthwise", lambda: xt.train(
        dict(HIGGS_PARAMS, monotone_constraints=mono,
             interaction_constraints=LG_SETS), dm4, PLO_LG_ROUNDS,
        evals=[(dte, "test")], evals_result=res, verbose_eval=False))
    t_c = time.perf_counter() - t0
    c_up = ring_used("paged constrained depthwise")
    if cc["hist_scan"] != PLO_LG_PAGES * depth * PLO_LG_ROUNDS:
        raise AssertionError(f"paged constrained launched {cc}")
    paths_in_one_set(bc, cons, "paged constrained depthwise")
    checked = monotone_holds(xt, bc, np.ascontiguousarray(
        Xte[:LG_SWEEP_ROWS]), signs, "paged constrained depthwise")
    log(f"paged constrained depthwise ({PLO_LG_ROUNDS} rounds, monotone "
        f"{mono}, sets {LG_SETS}): every path in one set, {checked} sweep "
        f"steps monotone, held-out logloss {res['test']['logloss']}; "
        f"{c_up} uploads; {t_c:.3f} s")

    # -- approx: the host re-sketch of the first 2 pages each round
    n2 = PLO_APPROX_PAGES * EXT_BATCH_ROWS
    dm2 = xt.QuantileDMatrix(higgs_batches(xt, n2, F, f"{tmp}/lo2"),
                             max_bin=256, ref=dm)
    res = {}
    t0 = time.perf_counter()
    ba, ca = run("paged approx", lambda: xt.train(
        dict(HIGGS_PARAMS, tree_method="approx"), dm2, PLO_ROUNDS,
        evals=[(dte, "test")], evals_result=res, verbose_eval=False))
    t_a = time.perf_counter() - t0
    resketch_s = ba._caches[id(dm2)]["source"].seconds
    ll = res["test"]["logloss"]
    if len(resketch_s) != PLO_ROUNDS or not all(
            b < a for a, b in zip(ll, ll[1:])):
        raise AssertionError(f"paged approx: re-sketches {resketch_s}, "
                             f"held-out logloss {ll}")
    if ca["hist_scan"] != PLO_APPROX_PAGES * depth * PLO_ROUNDS:
        raise AssertionError(f"paged approx launched {ca}")
    log(f"paged approx ({PLO_ROUNDS} rounds on {n2} rows): host re-sketch "
        f"{['%.6f' % s for s in resketch_s]} s a round, {t_a:.3f} s in all; "
        f"held-out logloss {ll}")
    out["resketch_s"] = resketch_s

    # -- categorical pages: Covertype's codes in pages of 100,000 rows
    n_cov = len(Xk)
    os.environ["XTPU_PAGE_ROWS"] = str(PLO_COV_PAGE_ROWS)
    cov_digests = {}
    cat_p = dict(COVTYPE_PARAMS, max_cat_to_onehot=4, max_cat_threshold=64)
    for cached in (0, -(-n_cov // PLO_COV_PAGE_ROWS)):
        os.environ["XTPU_PAGE_CACHE_BYTES"] = str(
            cached * PLO_COV_PAGE_ROWS * Xk.shape[1])
        dcat = xt.QuantileDMatrix(typed_batches(
            xt, Xk, yk, PLO_COV_PAGE_ROWS, COVDART_TYPES,
            f"{tmp}/cov{cached}"), max_bin=256)
        pc = dcat.binned(256, dev)
        cov_pages = -(-n_cov // PLO_COV_PAGE_ROWS)
        if not (pc.n_pages() == cov_pages and pc.cuts.is_cat().sum() == 2):
            raise AssertionError("the Covertype pages are not categorical")
        t0 = time.perf_counter()
        bk, ck = run(f"paged categorical, {cached} pages cached",
                     lambda d=dcat: xt.train(cat_p, d, PLO_ROUNDS,
                                             verbose_eval=False))
        t_k = time.perf_counter() - t0
        if ck["hist_scan"] or \
                ck["hist_int8x2"] != 7 * depth * cov_pages * PLO_ROUNDS:
            raise AssertionError(f"paged categorical launched {ck}")
        if pc.cached_pages(dev) != cached:
            raise AssertionError(f"{pc.cached_pages(dev)} Covertype pages "
                                 "cached")
        cov_digests[cached] = digest(bk)
    os.environ["XTPU_PAGE_ROWS"] = str(EXT_BATCH_ROWS)
    onehot, part = split_kinds(bk)
    if not (onehot and part) or len(set(cov_digests.values())) != 1:
        raise AssertionError(f"paged categorical: split kinds {onehot} / "
                             f"{part}, sha256 {cov_digests}")
    log(f"paged categorical ({n_cov} x 12 codes in {cov_pages} pages, "
        f"{PLO_ROUNDS} rounds): {onehot} one-hot and {part} partition "
        f"splits, one sha256 under budgets of 0 and {cov_pages} pages; "
        f"{t_k:.3f} s")

    # -- vector leaves: MediaMill's shape in pages of 8,192 rows
    Xm, Ym = mediamill_like(EXT_SEED)
    Xm, Ym = Xm[:MM_TRAIN_ROWS], Ym[:MM_TRAIN_ROWS]
    os.environ["XTPU_PAGE_ROWS"] = str(PLO_MM_PAGE_ROWS)
    os.environ["XTPU_PAGE_CACHE_BYTES"] = str(2 * PLO_MM_PAGE_ROWS
                                              * MM_FEATURES)
    dmm = xt.QuantileDMatrix(typed_batches(
        xt, Xm, Ym, PLO_MM_PAGE_ROWS, None, f"{tmp}/mm"), max_bin=256)
    os.environ["XTPU_PAGE_ROWS"] = str(EXT_BATCH_ROWS)
    pm = dmm.binned(256, dev)
    mm_pages = pm.n_pages()
    for label, extra in (("depthwise", {}),
                         ("lossguide", {"grow_policy": "lossguide",
                                        "max_leaves": PLO_MM_LG_LEAVES,
                                        "max_depth": 0})):
        t0 = time.perf_counter()
        bm, cm = run(f"paged vector leaves {label}", lambda e=extra: xt.train(
            dict(MM_PARAMS, multi_strategy="multi_output_tree", **e), dmm,
            PLO_LG_ROUNDS, verbose_eval=False))
        t_m = time.perf_counter() - t0
        # K2 a target and page, at each level or pair
        builds = (MM_PARAMS["max_depth"] * PLO_LG_ROUNDS if label ==
                  "depthwise" else sum(t.num_leaves() for t in bm.gbm.trees))
        want_k2 = MM_LABELS * mm_pages * builds
        if cm["hist_int8x2"] != want_k2 or cm["hist_scan"]:
            raise AssertionError(f"paged vector leaves {label} launched {cm}")
        if bm.gbm.trees[0].leaf_value.shape[1] != MM_LABELS:
            raise AssertionError("the paged trees have no vector leaves")
        log(f"paged vector leaves {label} ({MM_TRAIN_ROWS} x {MM_FEATURES}, "
            f"{MM_LABELS} labels, {mm_pages} pages of {PLO_MM_PAGE_ROWS}, 2 "
            f"cached, {PLO_LG_ROUNDS} rounds): K2 {want_k2} in all; "
            f"{t_m:.3f} s")
    os.environ["XTPU_PAGE_CACHE_BYTES"] = str(EXT_CACHED_PAGES * page)

    # -- gblinear shotgun over the 11 pages
    res = {}
    t0 = time.perf_counter()
    bl, cl = run("paged gblinear", lambda: xt.train(
        {"booster": "gblinear", "objective": "binary:logistic",
         "max_bin": 256}, dm, PLO_LINEAR_ROUNDS, evals=[(dte, "test")],
        evals_result=res, verbose_eval=False))
    t_l = time.perf_counter() - t0
    ll = res["test"]["logloss"]
    if not all(b < a for a, b in zip(ll, ll[1:])):
        raise AssertionError(f"paged gblinear: held-out logloss {ll}")
    log(f"paged gblinear shotgun ({PLO_LINEAR_ROUNDS} rounds on "
        f"{EXT_ROWS} rows): {t_l / PLO_LINEAR_ROUNDS:.6f} s a round with "
        f"the held-out eval; held-out logloss {ll}")
    out["gblinear_s"] = t_l / PLO_LINEAR_ROUNDS

    # -- resume: 10 rounds straight against 5, a kill, and a resume of 5
    Xr, yr = higgs_batch(EXT_SEED, 20_000, EXT_BATCH_ROWS, F)
    resumed = {}
    for label, make in (("resident", lambda: xt.DMatrix(Xr, label=yr)),
                        ("paged", lambda: dm4)):
        p = dict(HIGGS_PARAMS, subsample=0.8, colsample_bynode=0.8)
        straight = xt.train(p, make(), PLO_RESUME_ROUNDS, verbose_eval=False)
        ck = CheckpointConfig(directory=f"{tmp}/ck_{label}",
                              every_n_rounds=5)
        xt.train(p, make(), PLO_RESUME_ROUNDS // 2, verbose_eval=False,
                 checkpoint=ck)
        p4.reset_ring_stats()
        b, c = run(f"resume {label}", lambda: xt.train(
            p, make(), PLO_RESUME_ROUNDS, verbose_eval=False, checkpoint=ck))
        if label == "paged":
            ring_used("paged resume")
        if b.num_boosted_rounds() != PLO_RESUME_ROUNDS or \
                digest(b) != digest(straight) or not c["hist_scan"]:
            raise AssertionError(f"resume {label}: the resumed model differs "
                                 "from the straight run")
        resumed[label] = digest(b)
    log(f"resume: 10 rounds straight and 5 + a resume of 5 saved the same "
        f"bytes, resident and paged: {resumed}")
    paged_raw = bytes(b.save_raw("ubj"))     # the paged run's, on dm4's cuts

    # -- append a 12th page to the 11M matrix, then a round
    Xa, ya = higgs_batch(EXT_SEED, n_pages, EXT_BATCH_ROWS, F)
    t0 = time.perf_counter()
    dm.append(Xa, label=ya)
    t_ap = time.perf_counter() - t0
    if paged.n_pages() != n_pages + 1 or dm.num_row() != EXT_ROWS + len(ya):
        raise AssertionError("the append did not grow the paged matrix")
    # (``digest`` recorded ``scan`` in the saved model: ask for ``auto``)
    ba, ca = run("paged round after append", lambda: xt.train(
        dict(HIGGS_PARAMS, hist_method="auto"), dm, 1, verbose_eval=False,
        xgb_model=paged_raw))
    if ca["hist_scan"] != (n_pages + 1) * depth or ca["hist_int8x2"] or \
            ba.num_boosted_rounds() != PLO_RESUME_ROUNDS + 1:
        raise AssertionError(f"the round after the append launched {ca}")
    log(f"append: {len(ya)} rows binned against the frozen cuts in "
        f"{t_ap:.3f} s, {paged.n_pages()} pages; a round on from the "
        f"resumed paged model launched K4 {ca['hist_scan']} times")

    # -- each paged grower on the card against the CPU port
    n_h, rows_h = PLO_GAP_HIGGS
    n_c, rows_c = PLO_GAP_COV
    n_m, rows_m = PLO_GAP_MM
    gaps = {}
    for label, params, make, rows, width in (
            ("coarse", dict(HIGGS_PARAMS, hist_method="coarse"),
             lambda: higgs_batches(xt, n_h, F, f"{tmp}/gap_h"), rows_h, F),
            ("lossguide", dict(lg, max_leaves=PLO_GAP_LG_LEAVES),
             lambda: higgs_batches(xt, n_h, F, f"{tmp}/gap_l"), rows_h, F),
            ("categorical", cat_p,
             lambda: typed_batches(xt, Xk[:n_c], yk[:n_c], rows_c,
                                   COVDART_TYPES, f"{tmp}/gap_c"),
             rows_c, Xk.shape[1]),
            ("vector leaves", dict(MM_PARAMS, max_depth=PLO_GAP_MM_DEPTH,
                                   multi_strategy="multi_output_tree"),
             lambda: typed_batches(xt, Xm[:n_m], Ym[:n_m], rows_m, None,
                                   f"{tmp}/gap_m"),
             rows_m, MM_FEATURES)):
        os.environ.update({"XTPU_PAGE_ROWS": str(rows),
                           "XTPU_PAGE_CACHE_BYTES": str(rows * width)})
        dg = xt.QuantileDMatrix(make(), max_bin=256)
        if dg.binned(256, dev).n_pages() != 2:
            raise AssertionError(f"paged {label}: not two pages")
        gaps[label] = paged_card_against_cpu(
            xt, f"paged {label} card vs CPU", params, dg, dev,
            capped=label == "lossguide")
    os.environ["XTPU_PAGE_ROWS"] = str(EXT_BATCH_ROWS)
    out["card_cpu"] = gaps
    for k in ("XTPU_PAGE_ROWS", "XTPU_PAGED_COLLAPSE",
              "XTPU_PAGE_CACHE_BYTES"):
        del os.environ[k]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"paged_left_outs phase: {out['phase_s']:.1f} s")
    return runs, out


# ---- leaf-wise growth and constraints (``lossguide_constraints``) ----------

LG_PARAMS = dict(HIGGS_PARAMS, grow_policy="lossguide", max_leaves=255,
                 max_depth=0)
LG_ROUNDS = 10
LG_TWO_LEVEL_ROUNDS = 3
# the interaction constraint tutorial's sets; the other features are
# singleton sets
LG_SETS = "[[0, 2], [1, 3, 4], [5, 6]]"
LG_MONO_FEATURES = 8
LG_SWEEP_ROWS = 1_000
LG_DART_LEAVES = 63
# (share of the rows in the pair, bin slots): K2 and K4 at the pair shape
PAIR_CASES = ((0.5, 256), (0.02, 256), (0.5, 257), (0.02, 257))
_PLAIN_BUILDS = ("build_hist_int8x2_reference", "build_hist_scan_reference",
                 "scan_acc_reference", "build_hist_f32_reference",
                 "fused_advance_coarse_reference")


class NoPlainBuilds:
    """Within the block every plain histogram build raises: the card's
    training must launch the kernels and nothing else."""

    def __enter__(self):
        from xgboost_tpu_torch.ops import histogram as H

        self.saved = {n: getattr(H, n) for n in _PLAIN_BUILDS}

        def refuse(*a, **k):
            raise AssertionError("a plain histogram build ran on the card")

        for n in _PLAIN_BUILDS:
            setattr(H, n, refuse)
        return self

    def __exit__(self, *exc):
        from xgboost_tpu_torch.ops import histogram as H

        for n, fn in self.saved.items():
            setattr(H, n, fn)
        return False


def pair_inputs(n, F, B, share, dev, seed):
    """``hist_inputs`` at N = 2 with only ``share`` of the rows in the
    pair (rel 0 or 1), the rest inactive (rel 2), as a lossguide split
    deep in a tree leaves them."""
    bins, gpair, rel = hist_inputs(n, F, B, 2, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    keep = torch.rand(n, generator=g, device=dev) < share
    rel = torch.where(keep, torch.randint(0, 2, (n,), generator=g,
                                          device=dev, dtype=torch.int32),
                      torch.full_like(rel, 2))
    return bins, gpair, rel.contiguous()


def tree_shapes(bst):
    """(leaves, depth) of every tree."""
    return [(t.num_leaves(), t.max_depth()) for t in bst.gbm.trees]


def paths_in_one_set(bst, cons, label):
    """Every root-to-leaf path's features lie in one constraint set."""
    for k, t in enumerate(bst.gbm.trees):
        stack = [(0, frozenset())]
        while stack:
            i, path = stack.pop()
            if t.is_leaf[i]:
                if not any(cons[s, sorted(path)].all()
                           for s in range(cons.shape[0])):
                    raise AssertionError(f"{label}: tree {k} path "
                                         f"{sorted(path)} spans two sets")
                continue
            path = path | {int(t.split_feature[i])}
            stack += [(t.left_child[i], path), (t.right_child[i], path)]


def monotone_holds(xt, bst, X, signs, label):
    """Sweep each constrained feature over 64 values on the rows of X:
    the predictions never move against its sign (exactly: each tree is
    monotone and the fixed-order f32 sum keeps it). Returns the count of
    (row, step) pairs checked."""
    n = X.shape[0]
    checked = 0
    for f, sign in enumerate(signs):
        if not sign:
            continue
        grid = np.repeat(X, 64, axis=0)
        grid[:, f] = np.tile(np.linspace(-3, 3, 64, dtype=np.float32), n)
        p = bst.predict(xt.DMatrix(grid)).reshape(n, 64)
        bad = int((sign * np.diff(p, axis=1) < 0).sum())
        if bad:
            raise AssertionError(f"{label}: feature {f} (sign {sign}) moves "
                                 f"against its sign at {bad} steps")
        checked += n * 63
    return checked


def serve_equal(raw, X, want, label):
    """A ``Server`` answering 40 requests of 1/8/64/512 rows of X, each
    answer equal to ``want`` (``Booster.predict``) bit for bit; returns
    its launch counts."""
    from xgboost_tpu_torch.serve import Server

    sizes = (1, 8, 64, 512)
    reset_counts()
    with Server(models={label: raw}, max_batch=512) as srv:
        srv.warmup()
        for i in range(40):
            n = sizes[i % len(sizes)]
            lo = (i * 1237) % (X.shape[0] - n)
            got = np.asarray(srv.predict(X[lo:lo + n]))
            if not np.array_equal(got, want[lo:lo + n]):
                raise AssertionError(f"{label}: a Server answer ({n} rows at "
                                     f"{lo}) differs from Booster.predict")
    counts = read_counts()
    if counts["walk_packed"] < 1:
        raise AssertionError(f"{label}: the Server launched {counts}")
    return counts


def lossguide_constraints(xt, dev, X, y, w, depthwise10, Xc, yc):
    """The ``lossguide_constraints`` phase (module docstring): returns
    (the main-path runs' launch counts, {kernel: max |kernel - plain|},
    K1's errors, the pair-shape kernel times {(kernel, share, B): (ms,
    plain_ms, library_ms, bound)}, K1's time on the lossguide forest, a
    summary dict)."""
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.serve.packed import PackedForest
    from xgboost_tpu_torch.tree.param import (parse_interaction_constraints,
                                              parse_monotone_constraints)

    F = X.shape[1]
    n_tr = 1_000_000
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr])
    dte = xt.DMatrix(X[n_tr:], label=y[n_tr:])
    yte = y[n_tr:]
    runs, errs, k1_errs, out = [], {}, [], {}

    # -- leaf-wise HIGGS, twice
    raws, results = [], []
    for run in range(2):
        res = {}
        t0 = time.perf_counter()
        with NoPlainBuilds():
            bst, c = train_launches(f"lossguide run {run}", lambda r=res:
                                    xt.train(LG_PARAMS, dtr, LG_ROUNDS,
                                             evals=[(dte, "test")],
                                             evals_result=r,
                                             verbose_eval=False))
        t_run = time.perf_counter() - t0
        pairs = sum(t.num_leaves() for t in bst.gbm.trees)
        if c["hist_scan"] != pairs or c["hist_int8x2"] or c["hist_f32"] \
                or c["fused_advance_coarse"]:
            raise AssertionError(f"lossguide launched {c}, expected K4 once "
                                 f"a pair ({pairs} pairs) and nothing else")
        if c["walk_packed"] != LG_ROUNDS:
            raise AssertionError(f"lossguide's held-out walks: {c}")
        ll = res["test"]["logloss"]
        if not all(b < a for a, b in zip(ll, ll[1:])):
            raise AssertionError(f"held-out logloss did not fall every "
                                 f"round: {ll}")
        runs.append(c)
        raws.append(bytes(bst.save_raw("ubj")))
        results.append(res)
        log(f"lossguide run {run}: {LG_ROUNDS} rounds in {t_run:.3f} s "
            f"(host clock); pairs a round {pairs / LG_ROUNDS:g}, K4 "
            f"{c['hist_scan'] / LG_ROUNDS:g} a round, K1 "
            f"{c['walk_packed'] / LG_ROUNDS:g}")
    digests = [hashlib.sha256(r).hexdigest() for r in raws]
    if digests[0] != digests[1]:
        raise AssertionError(f"two lossguide runs saved different models: "
                             f"{digests}")
    shapes = tree_shapes(bst)
    if max(lv for lv, _ in shapes) > 255:
        raise AssertionError(f"a tree has more than 255 leaves: {shapes}")
    p_te = bst.predict(dte)
    auc_lg = auc(yte, p_te)
    ll = results[0]["test"]["logloss"]
    if not (np.isfinite(p_te).all() and auc_lg > 0.6):
        raise AssertionError(f"lossguide held-out AUC {auc_lg}")
    log(f"lossguide model sha256 (two runs): {digests[0]} {digests[1]}")
    log(f"lossguide trees (leaves, depth): {shapes}")
    log(f"lossguide held-out at {LG_ROUNDS} rounds: logloss {ll[0]} -> "
        f"{ll[-1]}, AUC {auc_lg:.6f}; depthwise depth 8 at {LG_ROUNDS}: "
        f"logloss {depthwise10[0]}, AUC {depthwise10[1]:.6f}")
    again = xt.Booster(model_file=bst.save_raw("ubj"))
    if not np.array_equal(again.predict(dte), p_te):
        raise AssertionError("lossguide: save_raw round trip predicts other "
                             "bits")
    Xte = X[n_tr:]
    serve_counts = serve_equal(raws[0], Xte, p_te, "lossguide")
    log(f"lossguide: save_raw round trip and a Server (K1 launches "
        f"{serve_counts['walk_packed']}) predict Booster.predict's bits")
    # K1 on the lossguide forest, both schedules, and its time
    pf = bst.packed_forest()
    base = torch.tensor(bst._base_np(), device=dev)
    Xd = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    for n, sch in ((512, "spread"), (100_000, "staged"), (4096, "staged"),
                   (100_000, "spread")):
        k1_errs.append(check_kernel(f"lossguide forest n={n}", pf,
                                    Xd[:n].contiguous(), base, sch)[0])
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    _, leaves = pf.margin(Xd, base, leaf_index=True)
    visits = int(torch.from_numpy(node_depths(pf)).to(dev)[
        leaves.long()].sum())
    d = pf.device_arrays(dev)
    from xgboost_tpu_torch.ops.walk import walk_packed_reference
    from xgboost_tpu_torch.serve.packed import tree_step

    k1 = {"ms": event_ms(lambda: pf.margin(Xd, base), reps=20, flush=flush),
          "plain_ms": event_ms(lambda: walk_packed_reference(
              d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
              d["group_onehot"], Xd, base, max_depth=pf.max_depth,
              tree_chunk=tree_step(Xd.shape[0])), reps=3),
          "bound": walk_bound_ms(pf, Xd.shape[0], F, visits),
          "max_depth": pf.max_depth}
    log(f"K1 lossguide forest (max_depth {pf.max_depth}, {pf.n_trees} "
        f"trees) at 100,000 rows: {k1['ms']:.6f} ms, plain "
        f"{k1['plain_ms']:.6f} ms, bound {k1['bound'][0]:.6f} ms "
        f"({k1['bound'][1]})")
    # seconds a round and three profiled rounds
    timer, per, s_lg = seconds_per_round(LG_PARAMS, dtr)
    log(f"lossguide seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per]}; median of rounds 1-5 {s_lg:.6f} s")
    busy_lg, _ = profile_rounds("lossguide", timer, dtr, top=16)
    out.update(s_round=s_lg, busy_ms=busy_lg, digest=digests[0],
               ll=(ll[0], ll[-1]), auc=auc_lg, shapes=shapes,
               pairs=pairs / LG_ROUNDS)

    # -- the two-level schedules, one set of bytes
    per_pair = {"coarse": {"hist_int8x2": 2}, "fused": {"hist_int8x2": 2},
                "scan": {"hist_scan": 1}}
    two_raw = {}
    for method, want in per_pair.items():
        with NoPlainBuilds():
            b2, c2 = train_launches(
                f"lossguide {method}", lambda m=method: xt.train(
                    dict(LG_PARAMS, hist_method=m), dtr,
                    LG_TWO_LEVEL_ROUNDS, verbose_eval=False))
        pairs2 = sum(t.num_leaves() for t in b2.gbm.trees)
        want = {k: want.get(k, 0) * pairs2 for k in K.LAUNCHES}
        if {k: c2[k] for k in K.LAUNCHES} != want:
            raise AssertionError(f"lossguide {method} launched {c2}, "
                                 f"expected {want}")
        runs.append(c2)
        two_raw[method] = saved_bytes(b2)
    if not two_raw["coarse"] == two_raw["fused"] == two_raw["scan"]:
        raise AssertionError("lossguide coarse, fused and scan saved "
                             "different models")
    log(f"lossguide coarse, fused and scan ({LG_TWO_LEVEL_ROUNDS} rounds) "
        f"saved the same model bytes: sha256 "
        f"{hashlib.sha256(two_raw['scan']).hexdigest()}")

    # -- constraints at the HIGGS shape: depthwise auto, then lossguide
    top = np.argsort(-np.abs(w))[:LG_MONO_FEATURES]
    signs = [int(np.sign(w[f])) if f in top else 0 for f in range(F)]
    mono = "(" + ",".join(str(v) for v in signs) + ")"
    cons = parse_interaction_constraints(LG_SETS, F)
    if parse_monotone_constraints(mono, F) != signs:
        raise AssertionError("the monotone string does not parse back")
    sweep = np.ascontiguousarray(Xte[:LG_SWEEP_ROWS])
    constrained = {}
    for label, params, rounds, k4_per_round in (
            ("depthwise", dict(HIGGS_PARAMS), 10, 8),
            ("lossguide", dict(LG_PARAMS), 3, None)):
        params.update(monotone_constraints=mono,
                      interaction_constraints=LG_SETS)
        res = {}
        t0 = time.perf_counter()
        with NoPlainBuilds():
            bc, cc = train_launches(
                f"constrained {label}", lambda p=params, r=res, k=rounds:
                xt.train(p, dtr, k, evals=[(dte, "test")], evals_result=r,
                         verbose_eval=False))
        t_c = time.perf_counter() - t0
        want_k4 = (k4_per_round * rounds if k4_per_round
                   else sum(t.num_leaves() for t in bc.gbm.trees))
        if cc["hist_scan"] != want_k4 or cc["hist_int8x2"] or \
                cc["hist_f32"]:
            raise AssertionError(f"constrained {label} launched {cc}")
        runs.append(cc)
        paths_in_one_set(bc, cons, f"constrained {label}")
        checked = monotone_holds(xt, bc, sweep, signs,
                                 f"constrained {label}")
        auc_c = auc(yte, bc.predict(dte))
        if not auc_c > 0.6:
            raise AssertionError(f"constrained {label}: AUC {auc_c}")
        constrained[label] = (auc_c, res["test"]["logloss"][-1], t_c)
        log(f"constrained {label} ({rounds} rounds, monotone {mono}, sets "
            f"{LG_SETS}): every path in one set, {checked} sweep steps "
            f"monotone, held-out logloss {res['test']['logloss'][-1]}, AUC "
            f"{auc_c:.6f} (unconstrained depthwise at 10 rounds "
            f"{depthwise10[1]:.6f}); {t_c:.3f} s")
    out["constrained"] = constrained
    out["mono"] = mono

    # -- depthwise max_leaves: depth 8 on 1M rows, depth 10 on 200k (K3)
    d200 = xt.DMatrix(X[:200_000], label=y[:200_000])
    for label, dm, depth, want in (
            ("depth 8", dtr, 8, {"hist_scan": 8}),
            ("depth 10", d200, 10, {"hist_scan": 8, "hist_f32": 2})):
        with NoPlainBuilds():
            bm, cm = train_launches(
                f"max_leaves 64 {label}", lambda d=dm, k=depth: xt.train(
                    dict(HIGGS_PARAMS, max_depth=k, max_leaves=64), d, 3,
                    verbose_eval=False))
        want = {k: want.get(k, 0) * 3 for k in K.LAUNCHES}
        if {k: cm[k] for k in K.LAUNCHES} != want:
            raise AssertionError(f"max_leaves {label} launched {cm}, "
                                 f"expected {want}")
        leaves = [t.num_leaves() for t in bm.gbm.trees]
        if max(leaves) > 64:
            raise AssertionError(f"max_leaves 64 {label}: leaves {leaves}")
        runs.append(cm)
        log(f"max_leaves 64 {label}: leaves {leaves}, depths "
            f"{[t.max_depth() for t in bm.gbm.trees]}")

    # -- lossguide with dart on the categorical Covertype matrix
    from xgboost_tpu_torch.boosting.dart import Dart

    n_cov = sum(COVTYPE_CLASS_COUNTS)
    kw = dict(feature_types=COVDART_TYPES, enable_categorical=True)
    Xk = covtype_codes(Xc)
    dcat = xt.DMatrix(Xk[:n_cov], label=yc[:n_cov], **kw)
    dcat_te = xt.DMatrix(Xk[n_cov:], label=yc[n_cov:], **kw)
    drops = []
    select = Dart._select_drop

    def counted(self):
        got = select(self)
        drops.append(len(got))
        return got

    Dart._select_drop = counted
    try:
        res = {}
        with NoPlainBuilds():
            bd, cd = train_launches("lossguide dart", lambda: xt.train(
                dict(COVDART_PARAMS, grow_policy="lossguide",
                     max_leaves=LG_DART_LEAVES, max_depth=0), dcat, 3,
                evals=[(dcat_te, "test")], evals_result=res,
                verbose_eval=False))
    finally:
        Dart._select_drop = select
    pairs_d = sum(t.num_leaves() for t in bd.gbm.trees)
    if cd["hist_int8x2"] != pairs_d or cd["hist_scan"] or cd["hist_f32"]:
        raise AssertionError(f"lossguide dart launched {cd}, expected K2 "
                             f"once a pair ({pairs_d})")
    onehot, part = split_kinds(bd)
    if not (onehot and part):
        raise AssertionError(f"lossguide dart: split kinds {onehot}, {part}")
    if max(t.num_leaves() for t in bd.gbm.trees) > LG_DART_LEAVES:
        raise AssertionError("lossguide dart: a tree past its leaves")
    runs.append(cd)
    log(f"lossguide dart (Covertype codes, 7 classes, max_leaves "
        f"{LG_DART_LEAVES}): drops a round {drops}, weight_drop "
        f"{min(bd.gbm.weight_drop):.6f}..{max(bd.gbm.weight_drop):.6f}, "
        f"one-hot splits {onehot}, partition splits {part}, held-out "
        f"mlogloss {res['test']['mlogloss']}")
    out["dart"] = (drops, onehot, part, res["test"]["mlogloss"])

    # -- K2 and K4 at the pair shape, against their plain versions, timed
    times = {}
    for i, (share, B) in enumerate(PAIR_CASES):
        bins, gpair, rel = pair_inputs(n_tr, F, B, share, dev, seed=150 + i)
        label = f"pair n={n_tr} N=2 B={B} share={share}"
        for k, e in check_hist(bins, gpair, rel, 2, B, label,
                               only=("hist_int8x2", "hist_scan")).items():
            errs[k] = max(errs.get(k, 0.0), e)
        t, n_active = time_hist(bins, gpair, rel, 2, B, flush,
                                only=("hist_int8x2", "hist_scan"))
        for name, (ms, plain_ms, lib_ms) in t.items():
            bound = hist_bound_ms(bins, 2, B, n_active, 4)
            times[(name, share, B)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} {label} ({n_active} active rows; L2 "
                f"flushed): {ms:.6f} ms, plain {plain_ms:.6f} ms, "
                f"index_add_ {lib_ms:.6f} ms, bound {bound[0]:.6f} ms "
                f"({bound[1]}), kernel at {bound[0] / ms * 100:.4f}% of it")
        del bins, gpair, rel
    return runs, errs, k1_errs, times, k1, out


# ---- multi-target training: MediaMill's shape, both strategies ---------------

# the Mulan split of MediaMill (Snoek et al., 2006): 43,907 rows of 120
# features, 30,993 train and 12,914 test, 101 labels, 4.376 a row
MM_TRAIN_ROWS = 30_993
MM_TEST_ROWS = 12_914
MM_FEATURES = 120
MM_LABELS = 101
MM_CARDINALITY = 4.376
MM_RULE_POOL = 24           # features the labels' rules draw from
MM_PARAMS = {"objective": "binary:logistic", "max_depth": 6, "eta": 0.3,
             "max_bin": 256}
MM_ROUNDS = 10
MM_LG_LEAVES = 64
MM_LG_ROUNDS = 2
# one vector-leaf round at each of these depths: the split search's peak
# memory at levels of 128 and 512 nodes (K3 above 128 nodes)
MM_DEEP = (8, 10)
# the vector-leaf path at the main path's rows: three regression targets
MT_HIGGS_TARGETS = 3
MT_HIGGS_DEPTH = 8
MT_HIGGS_ROUNDS = 5
MT_HIGGS_TRAIN = 1_000_000
MT_HIGGS_TEST = 100_000


def mediamill_like(seed):
    """MediaMill's shape made from ``seed``: [43,907, 120] f32 N(0, 1)
    features and a [43,907, 101] 0/1 label matrix. Label k's rate falls
    off as 1 / (k + 2), scaled to 4.376 positives a row; label k is 1
    where a fixed sparse rule (5 features, N(0, 1) weights) plus N(0, 1)
    noise lies in its top rate share. The rules draw their features from
    one pool of 24, so that labels co-occur, as MediaMill's concepts do.
    Rows 0-30,992 train, the rest are held out."""
    rng = np.random.default_rng(seed)
    n = MM_TRAIN_ROWS + MM_TEST_ROWS
    X = rng.standard_normal((n, MM_FEATURES), dtype=np.float32)
    W = np.zeros((MM_FEATURES, MM_LABELS), np.float32)
    pool = rng.choice(MM_FEATURES, MM_RULE_POOL, replace=False)
    for k in range(MM_LABELS):
        W[rng.choice(pool, 5, replace=False), k] = rng.standard_normal(5)
    score = X @ W + rng.standard_normal((n, MM_LABELS), dtype=np.float32)
    rate = 1.0 / (np.arange(MM_LABELS) + 2.0)
    rate *= MM_CARDINALITY / rate.sum()
    cut = np.asarray([np.quantile(score[:, k], 1.0 - rate[k])
                      for k in range(MM_LABELS)], np.float32)
    return X, (score > cut[None, :]).astype(np.float32)


class RoundClock:
    """A training callback that takes the host clock after a device sync
    at the start of every round; ``seconds()``: each round's span."""

    def __init__(self):
        from xgboost_tpu_torch.callback import TrainingCallback

        clock = self

        class _Cb(TrainingCallback):
            def before_iteration(self, model, epoch, evals_log):
                torch.cuda.synchronize()
                clock.stamps.append(time.perf_counter())
                return False

            def after_training(self, model):
                torch.cuda.synchronize()
                clock.stamps.append(time.perf_counter())
                return model

        self.stamps = []
        self.callback = _Cb()

    def seconds(self):
        return [b - a for a, b in zip(self.stamps, self.stamps[1:])]


def mean_label_auc(Y, P):
    """Mean AUC over the labels with both classes in ``Y``, and their
    count."""
    both = [k for k in range(Y.shape[1]) if 0 < Y[:, k].sum() < len(Y)]
    return float(np.mean([auc(Y[:, k], P[:, k]) for k in both])), len(both)


def multi_target(xt, dev):
    """The ``multi_target`` phase (module docstring): returns (the
    main-path runs' launch counts, {kernel: max |kernel - plain|}, K1's
    errors, {entry: (ms, plain_ms, library_ms, bound)}, a summary
    dict)."""
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.walk import walk_packed_reference
    from xgboost_tpu_torch.serve.packed import tree_step

    t_phase = time.perf_counter()

    def at():
        return f"[phase +{time.perf_counter() - t_phase:.1f} s] "

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    X, Y = mediamill_like(13)
    n_tr = MM_TRAIN_ROWS
    dtr = xt.DMatrix(X[:n_tr], label=Y[:n_tr])
    dte = xt.DMatrix(X[n_tr:], label=Y[n_tr:])
    Yte = Y[n_tr:]
    log(f"{at()}mediamill_like: {X.shape[0]} x {X.shape[1]} ({n_tr} train, "
        f"{len(Yte)} held out), {Y.shape[1]} labels, "
        f"{Y.sum(axis=1).mean():.4f} positives a row, label rates "
        f"{Y[:, 0].mean():.4f} .. {Y[:, -1].mean():.4f}")
    runs, errs, k1_errs, times, out = [], {}, [], {}, {}
    nodes = 2 ** MM_PARAMS["max_depth"] - 1

    def train_twice(label, params, rounds, want_k2):
        """Run 0 with the held-out evaluation, run 1 timed by its rounds;
        both under ``NoPlainBuilds``, one sha256. ``want_k2(bst)``: the K2
        launches the run must make."""
        res, clock, digests = {}, RoundClock(), []
        for run in range(2):
            torch.cuda.reset_peak_memory_stats()
            kw = (dict(evals=[(dte, "test")], evals_result=res) if run == 0
                  else dict(callbacks=[clock.callback]))
            with NoPlainBuilds():
                bst, c = train_launches(f"{label} run {run}", lambda k=kw:
                                        xt.train(params, dtr, rounds,
                                                 verbose_eval=False, **k))
            peak = torch.cuda.max_memory_allocated()
            if c["hist_int8x2"] != want_k2(bst) or c["hist_scan"] or \
                    c["hist_f32"] or c["fused_advance_coarse"]:
                raise AssertionError(f"{label} launched {c}, expected K2 "
                                     f"{want_k2(bst)} times and no other "
                                     "histogram kernel")
            runs.append(c)
            digests.append(hashlib.sha256(bytes(bst.save_raw("ubj")))
                           .hexdigest())
            if run == 0:
                counts0, bst0, peak0 = c, bst, peak
        if digests[0] != digests[1]:
            raise AssertionError(f"{label}: two runs saved different models "
                                 f"{digests}")
        ll = res["test"]["logloss"]
        p = bst0.predict(dte)
        mauc, n_auc = mean_label_auc(Yte, p)
        if not (p.shape == Yte.shape and np.isfinite(p).all()
                and ll[-1] < ll[0] and mauc > 0.6):
            raise AssertionError(f"{label}: held-out logloss {ll[0]} -> "
                                 f"{ll[-1]}, mean label AUC {mauc}")
        per = clock.seconds()
        s_round = float(np.median(per[1:]))
        # three more rounds of run 1's booster under the profiler
        busy, _ = profile_rounds(label, bst, dtr, top=10)
        r = dict(s_round=s_round, busy_ms=busy, ll=(ll[0], ll[-1]),
                 mauc=mauc, n_auc=n_auc, digest=digests[0],
                 peak_gb=peak0 / 1e9, counts=counts0)
        log(f"{at()}{label}: {rounds} rounds twice, one model sha256 {digests[0]}; "
            f"launches a round K2 {counts0['hist_int8x2'] / rounds:g}, K4 "
            f"{counts0['hist_scan'] / rounds:g}, K1 "
            f"{counts0['walk_packed'] / rounds:g}; seconds a round "
            f"{['%.6f' % t for t in per]}, median of rounds 1 on "
            f"{s_round:.6f} s; held-out logloss {ll[0]} -> {ll[-1]}, mean "
            f"per-label AUC {mauc:.6f} over {n_auc} labels; "
            f"max_memory_allocated {peak0 / 1e9:.3f} GB")
        return bst0, r

    def round_trips(label, bst):
        """save_raw, and the reference schema with each row's base margin
        given (its scalar base_score keeps one target's intercept),
        predict the model's bits."""
        p = bst.predict(dte)
        if not np.array_equal(
                xt.Booster(model_file=bst.save_raw("ubj")).predict(dte), p):
            raise AssertionError(f"{label}: save_raw round trip predicts "
                                 "other bits")
        with tempfile.TemporaryDirectory(prefix="xtt_mt_") as tmp:
            path = os.path.join(tmp, "ref.json")
            import warnings
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                xt.save_xgboost_model(bst, path)
            ref = xt.load_xgboost_model(path)
        rows = np.broadcast_to(bst._base_np(), Yte.shape).astype(np.float32)
        dm = xt.DMatrix(X[n_tr:], base_margin=rows)
        if not np.array_equal(ref.predict(dm), bst.predict(dm)):
            raise AssertionError(f"{label}: the reference-schema round trip "
                                 "predicts other bits")
        log(f"{at()}{label}: save_raw and reference-schema round trips predict "
            f"the same bits (the schema keeps target 0's intercept; "
            f"{len(caught)} warning(s))")

    # (a) one tree a label and round: K2 at every level of each of the
    # 101 trees, K1 for the held-out walk once a round
    bst_a, out["one_output_per_tree"] = train_twice(
        "mediamill one_output_per_tree", MM_PARAMS, MM_ROUNDS,
        lambda b: MM_PARAMS["max_depth"] * len(b.gbm.trees))
    round_trips("mediamill one_output_per_tree", bst_a)
    reset_counts()
    p_a = bst_a.predict(dte)
    torch.cuda.synchronize()
    pc = read_counts()
    if pc["walk_packed"] != 1:
        raise AssertionError(f"one_output_per_tree predict launched {pc}")
    runs.append(pc)
    if out["one_output_per_tree"]["counts"]["walk_packed"] != MM_ROUNDS:
        raise AssertionError("one_output_per_tree: K1 did not walk the "
                             "held-out rows once a round")

    # (b) one vector-leaf tree a round: K2 once a label and level
    bst_b, out["multi_output_tree"] = train_twice(
        "mediamill multi_output_tree", dict(MM_PARAMS,
                                            multi_strategy="multi_output_tree"),
        MM_ROUNDS, lambda b: MM_PARAMS["max_depth"] * MM_LABELS
        * len(b.gbm.trees))
    round_trips("mediamill multi_output_tree", bst_b)
    if out["multi_output_tree"]["counts"]["walk_packed"]:
        raise AssertionError("vector leaves went through the packed walk")
    leaves_b = [t.num_leaves() for t in bst_b.gbm.trees]

    # (c) leaf-wise vector leaves: K2 once a label and evaluated pair
    bst_c, out["multi_output_lossguide"] = train_twice(
        "mediamill multi_output_tree lossguide",
        dict(MM_PARAMS, multi_strategy="multi_output_tree",
             grow_policy="lossguide", max_leaves=MM_LG_LEAVES, max_depth=0),
        MM_LG_ROUNDS, lambda b: MM_LABELS * sum(t.num_leaves()
                                                for t in b.gbm.trees))
    round_trips("mediamill multi_output_tree lossguide", bst_c)
    leaves_c = [t.num_leaves() for t in bst_c.gbm.trees]
    log(f"{at()}mediamill vector-leaf trees: depthwise leaves {leaves_b}, "
        f"lossguide leaves {leaves_c}; K3 is not reached here (its levels "
        f"hold at most {2 ** (MM_PARAMS['max_depth'] - 1)} nodes and "
        f"{MM_TRAIN_ROWS} rows, inside K2's int8x2 row guard)")

    # deeper vector-leaf trees: one round at each of MM_DEEP, K2 once a
    # label at the levels of up to 128 nodes and K3 above, and the peak
    # memory the level's histogram and the chunked split search hold
    out["deep"] = {}
    for depth in MM_DEEP:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with NoPlainBuilds():
            bd, cd = train_launches(
                f"mediamill multi_output_tree depth {depth}",
                lambda d=depth: xt.train(
                    dict(MM_PARAMS, max_depth=d,
                         multi_strategy="multi_output_tree"),
                    dtr, 1, verbose_eval=False))
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        want_k2 = MM_LABELS * min(depth, 8)
        want_k3 = MM_LABELS * max(0, depth - 8)
        if cd["hist_int8x2"] != want_k2 or cd["hist_f32"] != want_k3 or \
                cd["hist_scan"] or cd["fused_advance_coarse"]:
            raise AssertionError(f"depth {depth} vector leaves launched "
                                 f"{cd}, expected K2 {want_k2} and K3 "
                                 f"{want_k3} times")
        if bd.gbm.trees[0].max_depth() > depth or not np.isfinite(
                bd.predict(dte)).all():
            raise AssertionError(f"depth {depth} vector leaves: bad tree")
        runs.append(cd)
        out["deep"][depth] = dict(peak_gb=peak, s=took)
        log(f"{at()}mediamill multi_output_tree depth {depth}, one round: "
            f"{took:.6f} s (host clock, build and first-call costs "
            f"included), K2 {cd['hist_int8x2']}, K3 {cd['hist_f32']}, "
            f"max_memory_allocated {peak:.3f} GB, tree depth "
            f"{bd.gbm.trees[0].max_depth()}")
        del bd

    # the vector-leaf path at the main path's rows: K4 once a target and
    # level
    Xh, _ = higgs_like(MT_HIGGS_TRAIN + MT_HIGGS_TEST, 28, seed=0)
    rng = np.random.default_rng(7)
    Wh = rng.standard_normal((28, MT_HIGGS_TARGETS)).astype(np.float32)
    Yh = Xh @ Wh + rng.standard_normal(
        (len(Xh), MT_HIGGS_TARGETS)).astype(np.float32)
    dh = xt.DMatrix(Xh[:MT_HIGGS_TRAIN], label=Yh[:MT_HIGGS_TRAIN])
    dh_te = xt.DMatrix(Xh[MT_HIGGS_TRAIN:], label=Yh[MT_HIGGS_TRAIN:])
    res, clock = {}, RoundClock()
    torch.cuda.reset_peak_memory_stats()
    with NoPlainBuilds():
        bh, ch = train_launches("HIGGS-shape multi_output_tree", lambda:
                                xt.train({"objective": "reg:squarederror",
                                          "max_depth": MT_HIGGS_DEPTH,
                                          "eta": 0.3, "max_bin": 256,
                                          "multi_strategy":
                                          "multi_output_tree"},
                                         dh, MT_HIGGS_ROUNDS,
                                         evals=[(dh_te, "test")],
                                         evals_result=res,
                                         callbacks=[clock.callback],
                                         verbose_eval=False))
    want = MT_HIGGS_DEPTH * MT_HIGGS_TARGETS * MT_HIGGS_ROUNDS
    if ch["hist_scan"] != want or ch["hist_int8x2"] or ch["hist_f32"]:
        raise AssertionError(f"HIGGS-shape vector leaves launched {ch}, "
                             f"expected K4 {want} times")
    runs.append(ch)
    rmse = res["test"]["rmse"]
    if not (rmse[-1] < rmse[0] and np.isfinite(rmse).all()):
        raise AssertionError(f"HIGGS-shape vector leaves: rmse {rmse}")
    per_h = clock.seconds()
    out["higgs"] = dict(s_round=float(np.median(per_h[1:])),
                        rmse=(rmse[0], rmse[-1]),
                        digest=hashlib.sha256(bytes(bh.save_raw("ubj")))
                        .hexdigest(),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{at()}HIGGS-shape multi_output_tree ({MT_HIGGS_TRAIN} x 28, "
        f"{MT_HIGGS_TARGETS} targets, depth {MT_HIGGS_DEPTH}): K4 {ch['hist_scan'] / MT_HIGGS_ROUNDS:g} a "
        f"round; seconds a round (round and held-out eval) "
        f"{['%.6f' % t for t in per_h]}, median of rounds 1 on "
        f"{out['higgs']['s_round']:.6f} s; held-out rmse {rmse[0]} -> "
        f"{rmse[-1]}; model sha256 {out['higgs']['digest']}; "
        f"max_memory_allocated {out['higgs']['peak_gb']:.3f} GB")
    del Xh, Yh, dh, dh_te

    # K2 at the MediaMill levels: the training bins (256 slots) with one
    # label's quantised gradient, N = 1 and 32; and 257 slots (5% missing)
    bins = dtr.binned(MM_PARAMS["max_bin"], dev).bins
    yk = torch.from_numpy(Y[:n_tr, 0]).to(dev)
    margin = torch.full_like(yk, float(bst_b._base_np()[0]))
    p0 = torch.sigmoid(margin)
    gpair = torch.stack([p0 - yk, p0 * (1 - p0)], dim=1).contiguous()
    g = torch.Generator(device=dev).manual_seed(21)
    for B, N in ((256, 1), (256, 32), (257, 1), (257, 32)):
        if B == 256:
            b_in, gp = bins, gpair
            rel = torch.randint(0, N, (n_tr,), generator=g, device=dev,
                                dtype=torch.int32)
        else:
            b_in, gp, rel = hist_inputs(n_tr, MM_FEATURES, B, N, dev,
                                        seed=170 + N)
        label = f"mediamill n={n_tr} F={MM_FEATURES} N={N} B={B}"
        for k, e in check_hist(b_in, gp, rel, N, B, label,
                               only=("hist_int8x2",)).items():
            errs[k] = max(errs.get(k, 0.0), e)
        t, n_active = time_hist(b_in, gp, rel, N, B, flush,
                                only=("hist_int8x2",))
        ms, plain_ms, lib_ms = t["hist_int8x2"]
        bound = hist_bound_ms(b_in, N, B, n_active, 4)
        times[("hist_int8x2", N, B)] = (ms, plain_ms, lib_ms, bound)
        log(f"hist hist_int8x2 {label} (L2 flushed): {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, index_add_ {lib_ms:.6f} ms, bound "
            f"{bound[0]:.6f} ms ({bound[1]}), kernel at "
            f"{bound[0] / ms * 100:.4f}% of it")

    # K1 on the 101-group forest at the held-out rows, both schedules
    pf = bst_a.packed_forest()
    base = torch.tensor(bst_a._base_np(), device=dev)
    Xd = torch.from_numpy(np.ascontiguousarray(X[n_tr:])).to(dev)
    plan = None
    for sch in (None, "spread", "staged"):
        e, m, took = check_kernel(f"101-group forest n={MM_TEST_ROWS}", pf,
                                  Xd, base, sch)
        k1_errs.append(e)
        plan = plan or took
    if not np.array_equal(m.cpu().numpy(), bst_a.predict(
            dte, output_margin=True)):
        raise AssertionError("K1's 101-group margins differ from predict")
    _, leaves = pf.margin(Xd, base, leaf_index=True)
    visits = int(torch.from_numpy(node_depths(pf)).to(dev)[
        leaves.long()].sum())
    d = pf.device_arrays(dev)
    k1 = {"ms": event_ms(lambda: pf.margin(Xd, base), reps=20, flush=flush),
          "plain_ms": event_ms(lambda: walk_packed_reference(
              d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
              d["group_onehot"], Xd, base, max_depth=pf.max_depth,
              tree_chunk=tree_step(Xd.shape[0])), reps=3),
          "bound": walk_bound_ms(pf, Xd.shape[0], MM_FEATURES, visits),
          "plan": plan}
    for sch in ("spread", "staged"):
        k1[f"{sch}_ms"] = event_ms(lambda s=sch: pf.margin(Xd, base,
                                                           schedule=s),
                                   reps=10, flush=flush)
    times["walk_packed"] = k1
    log(f"{at()}K1 101-group forest ({pf.n_trees} trees, max_depth "
        f"{pf.max_depth}) at {MM_TEST_ROWS} rows: plan {plan}; "
        f"{k1['ms']:.6f} ms (spread {k1['spread_ms']:.6f}, staged "
        f"{k1['staged_ms']:.6f}), plain {k1['plain_ms']:.6f} ms, bound "
        f"{k1['bound'][0]:.6f} ms ({k1['bound'][1]})")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multi_target phase: {out['phase_s']:.1f} s")
    return runs, errs, k1_errs, times, out


# the objectives phases (``quantile_regression``, ``survival``,
# ``insurance_claims``): XGBoost 2.0's quantile regression demo
# (demo/guide-python/quantile_regression.py) and AFT survival demo
# (demo/aft_survival/aft_survival_demo.py) at the HIGGS shape, and the
# freMTPL2freq shape of scikit-learn's Poisson / Tweedie examples
QR_PARAMS = {"objective": "reg:quantileerror",
             "quantile_alpha": [0.05, 0.5, 0.95], "tree_method": "hist",
             "learning_rate": 0.04, "max_depth": 5, "max_bin": 256}
QR_ROUNDS = 32
QR_EARLY_STOP = 2
MAE_ROUNDS = 10
AFT_PARAMS = {"objective": "survival:aft",
              "eval_metric": ["aft-nloglik", "interval-regression-accuracy"],
              "aft_loss_distribution": "normal",
              "aft_loss_distribution_scale": 1.20, "tree_method": "hist",
              "learning_rate": 0.05, "max_depth": 6, "lambda": 0.01,
              "alpha": 0.02, "max_bin": 256}
SURV_ROUNDS = 10
OTHER_ROUNDS = 2
# uncensored, right-, left- and interval-censored shares of the rows
SURV_CENSORING = (0.5, 0.25, 0.1, 0.15)
HIGGS_TRAIN = 1_000_000
# three objectives the other phases do not reach, at the HIGGS shape
EXTRA_OBJECTIVES = ("reg:pseudohubererror", "reg:squaredlogerror",
                    "binary:hinge")
EXTRA_ROUNDS = 3
# freMTPL2freq: 678,013 policies; 10% held out
MTPL_ROWS = 678_013
MTPL_TEST = 67_801
MTPL_TYPES = ["q", "q", "q", "q", "c", "q", "c", "q", "c"]
MTPL_PARAMS = {"max_depth": 6, "eta": 0.1, "max_bin": 256}
MTPL_ROUNDS = 10
CLAIM_SHARE = 0.05
# rows of the card-against-CPU comparisons
GAP_ROWS = 20_000
GAP_ROUNDS = 2


def quantile_labels(X, seed):
    """A linear signal plus noise whose spread grows with |x1| and |x2|:
    the quantiles fan out across the features."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(X.shape[1]).astype(np.float32) / 4
    spread = 0.5 + np.abs(X[:, 1]) + 0.5 * np.abs(X[:, 2])
    return (X @ w + spread * rng.standard_normal(len(X)).astype(np.float32)
            ).astype(np.float32)


def survival_times(X, seed):
    """(times, lower, upper, cox labels): log-normal times from a linear
    rule, censored in the ``SURV_CENSORING`` mix (right: upper +inf, left:
    lower 0, interval: a window around the time); the Cox label is the
    time, negative when the row is right-censored."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(X.shape[1]).astype(np.float32) / 8
    t = np.exp(2.0 + X @ w + 0.5 * rng.standard_normal(len(X))).astype(
        np.float32)
    kind = rng.choice(4, len(X), p=SURV_CENSORING)
    lo, hi = t.copy(), t.copy()
    hi[kind == 1] = np.inf
    lo[kind == 2] = 0.0
    lo[kind == 3] = t[kind == 3] * rng.uniform(0.5, 0.9, (kind == 3).sum())
    hi[kind == 3] = t[kind == 3] * rng.uniform(1.1, 2.0, (kind == 3).sum())
    cox = np.where(kind == 1, -t, t).astype(np.float32)
    return t, lo.astype(np.float32), hi.astype(np.float32), cox


def fremtpl2_like(seed):
    """The freMTPL2freq shape, made from ``seed``: 678,013 policies x 9
    features (VehPower, VehAge, DrivAge, BonusMalus, VehBrand (11 codes),
    VehGas, Area (6 codes), log Density, Region (22 codes)), Exposure in
    (0, 1], ClaimNb ~ Poisson(Exposure x frequency) with about 5% of the
    policies claiming (0.1 claims a policy-year, as in the published
    table), and ClaimAmount a gamma severity per claim whose mean moves
    with VehGas, DrivAge and VehBrand.
    Returns (X, exposure, claim counts, claim amounts)."""
    rng = np.random.default_rng(seed)
    n = MTPL_ROWS
    veh_power = rng.integers(4, 16, n)
    veh_age = np.minimum(rng.exponential(7.0, n), 100).astype(np.int64)
    drv_age = rng.integers(18, 91, n)
    bonus = np.where(rng.random(n) < 0.6, 50,
                     rng.integers(50, 231, n))
    brand = rng.choice(11, n, p=np.arange(11, 0, -1) / 66)
    gas = rng.integers(0, 2, n)
    area = rng.choice(6, n, p=[0.15, 0.11, 0.28, 0.22, 0.2, 0.04])
    log_density = rng.uniform(0, 10.2, n)
    region = rng.choice(22, n, p=np.arange(22, 0, -1) / 253)
    X = np.stack([veh_power, veh_age, drv_age, bonus, brand, gas, area,
                  log_density, region], axis=1).astype(np.float32)
    exposure = np.where(rng.random(n) < 0.2, 1.0,
                        rng.uniform(0.003, 0.9, n)).astype(np.float32)
    brand_fx = rng.normal(0, 0.2, 11)
    region_fx = rng.normal(0, 0.2, 22)
    freq = 0.045 * np.exp(0.012 * (bonus - 50) - 0.004 * (drv_age - 45)
                          + 0.05 * area + brand_fx[brand]
                          + region_fx[region])
    counts = rng.poisson(exposure * freq).astype(np.float32)
    severity = 1800.0 * np.exp(0.3 * gas - 0.01 * (drv_age - 45)
                               + rng.normal(0, 0.3, 11)[brand])
    amounts = np.where(counts > 0, rng.gamma(1.2 * np.maximum(counts, 1),
                                             severity), 0.0).astype(
        np.float32)
    return X, exposure, counts, amounts


def pinball(y, q, alpha):
    err = y.astype(np.float64) - q
    return float(np.mean(np.where(err >= 0, alpha * err, (alpha - 1) * err)))


def train_model_twice(xt, label, params, dtr, rounds, evals, want,
                      **kw):
    """Two runs of ``train`` on the card with the launch counts set to 0
    before each, every plain histogram build refused; one sha256 in both.
    ``want(bst, counts)`` -> None or the reason the launches are wrong.
    Returns (run 0's booster, its evals_result, its counts, the sha256,
    the two runs' counts)."""
    digests, runs = [], []
    for run in range(2):
        res = {}
        with NoPlainBuilds():
            bst, c = train_launches(f"{label} run {run}", lambda r=res:
                                    xt.train(params, dtr, rounds,
                                             evals=evals, evals_result=r,
                                             verbose_eval=False, **kw))
        bad = want(bst, c)
        if bad:
            raise AssertionError(f"{label}: {bad} ({c})")
        runs.append(c)
        digests.append(hashlib.sha256(bytes(bst.save_raw("ubj")))
                       .hexdigest())
        if run == 0:
            out = (bst, res, c)
    if digests[0] != digests[1]:
        raise AssertionError(f"{label}: two runs saved different models "
                             f"{digests}")
    log(f"{label}: model sha256 {digests[0]} (both runs)")
    return (*out, digests[0], runs)


def launches_per_round(c, rounds):
    return {k: c[k] / rounds for k in ("hist_scan", "hist_int8x2",
                                       "hist_f32", "walk_packed")}


def cell_profile(xt, label, params, dtr):
    """Seconds a round (median of rounds 1-5, host clock) and device busy
    and idle over three profiled rounds (:func:`profile_rounds`)."""
    timer, per, s = seconds_per_round(params, dtr)
    busy, _ = profile_rounds(label, timer, dtr, top=8)
    log(f"{label}: seconds a round {['%.6f' % t for t in per]}, median of "
        f"rounds 1-5 {s:.6f} s")
    return s, busy


# int8x2 quanta of a leaf's sums that may round the other way on the
# card, beside those its rows' gradients move: with both devices at one
# margin a row's gradient differs by a few ulps (``exp`` / ``erf`` /
# the order of float64 scans), which moves its quantised value across a
# rounding boundary with probability below 2^-22 * 32512 (2 ulps of the
# largest gradient over its quantum)
FLIP_QUANTA = 8
FLIP_PER_ROW = 2.0 ** -22 * 32512


def certified_trees(a, b, label, eta, lam, quanta, rows, capped=False):
    """The card's tree ``a`` against the CPU port's ``b``, grown from the
    same margin, with the tests' near-tie certificate
    (``tests/test_torch_train.py compare_tree``): nodes are paired from
    the root; where the trees split differently, or one splits a node the
    other leaves, the two gains must lie within 2e-4 of the node's scale
    (its term G^2 / (H + lambda), or the larger gain; a near tie) and
    the subtrees below are skipped. A leaf may differ by rtol 1e-5 plus what ``k = FLIP_QUANTA
    + FLIP_PER_ROW * rows[leaf]`` of the round's int8x2 quanta
    ``quanta`` = (q_g, q_h) in its sums move it:
    ``eta * k * (q_g + |w| q_h) / (H + lambda)``. Each node also
    carries a gap (dG, dH) in its f32 sums, as in the tests' certificate
    (its root carry): the root's is the two devices' root sums apart
    (each sums the root in its own order); a child's sums come from its
    parent's histogram through the split search's f32 cumulative sum,
    which the card and the CPU take in other orders, so a left child
    carries two ulps of the parent's partial sums, ``4 U (max|g| n, H)``
    over the parent's n rows, and a right child, its parent's sums less
    the left one's, that and its parent's gap (measured on the card: at
    depth 8 on 20,000 HIGGS-shape rows the root's gap doubled at the
    first right step, and a leaf of six rows off that path moved by
    3.9e-4 in H). A node's gain may move by what its gap moves it (the
    gain formula at the corners of the gap's box), and a leaf by
    ``eta * (dG + |w| dH) / (H + lambda)``. A categorical split also
    keeps its left set (``cat_words``). ``capped``: leaf-wise trees that
    ``max_leaves`` bounds, where a node split in one tree only may also
    be a near tie of the greedy order: its gain within 2e-4 of its scale
    (plus the other's) of the smallest gain the other tree popped, both
    loops stopping at the cap (the tests' ``compare_tree``). Returns
    (near-tie nodes, largest leaf gap, largest gap over its bound)."""
    ties, gap, worst = [], 0.0, 0.0
    q_g, q_h = quanta

    def scale(t, n):
        """The node's own term G^2 / (H + lambda), from its weight."""
        h = float(t.sum_hess[n]) + lam
        return (float(t.base_weight[n]) / eta) ** 2 * h

    def sums(t, n):
        """(G, H) of node n in float64, G from its weight."""
        h = float(t.sum_hess[n])
        return -float(t.base_weight[n]) / eta * (h + lam), h

    (ga, ha), (gb, hb) = sums(a, 0), sums(b, 0)
    max_g = q_g * 32512.0
    count = {}

    def n_rows(n):
        """Rows of the CPU tree's node n (its leaves' ``rows``)."""
        if n not in count:
            count[n] = (rows.get(int(n), 0) if b.is_leaf[n] else
                        n_rows(b.left_child[n]) + n_rows(b.right_child[n]))
        return count[n]

    def carry(t, n, d):
        """How far node n's gain moves when its sums move by d = (dG,
        dH)."""
        g, h = sums(t, n)
        gl, hl = sums(t, t.left_child[n])

        def gain(g, h):
            return (gl * gl / (hl + lam) + (g - gl) ** 2 / (h - hl + lam)
                    - g * g / (h + lam))

        return max(abs(gain(g + sg * d[0], h + sh * d[1]) - gain(g, h))
                   for sg in (-1.0, 1.0) for sh in (-1.0, 1.0))

    # (card node, CPU node, the gap its sums carry)
    stack = [(0, 0, (abs(ga - gb), abs(ha - hb)))]
    while stack:
        i, j, d = stack.pop()
        if a.is_leaf[i] != b.is_leaf[j]:
            # one device's best gain rounds to at most 0, the other's
            # above: a near tie with not splitting
            t, n = (b, j) if a.is_leaf[i] else (a, i)
            bound = 2e-4 * scale(t, n) + 1e-6 + carry(t, n, d)
            popped = a if t is b else b
            m = float(popped.gain[~popped.is_leaf].min(initial=np.inf))
            if abs(float(t.gain[n])) > bound and not (
                    capped and abs(float(t.gain[n]) - m)
                    <= bound + 2e-4 * abs(m)):
                raise AssertionError(f"{label}: node {i} is a leaf in one "
                                     f"tree only, its gain {t.gain[n]} not "
                                     "at a near tie with 0")
            ties.append(int(i))
            continue
        if a.is_leaf[i]:
            va, vb = float(a.leaf_value[i]), float(b.leaf_value[j])
            k = FLIP_QUANTA + FLIP_PER_ROW * rows.get(int(j), 0)
            bound = 1e-5 * abs(vb) + 1e-7 + eta * (
                k * (q_g + abs(vb) / eta * q_h)
                + d[0] + abs(vb) / eta * d[1]) / (float(b.sum_hess[j]) + lam)
            if abs(va - vb) > bound:
                raise AssertionError(f"{label}: leaf {i} {va} on the card, "
                                     f"{vb} on the CPU (bound {bound})")
            gap = max(gap, abs(va - vb))
            worst = max(worst, abs(va - vb) / bound)
            continue
        if (a.split_feature[i], a.split_bin[i], a.default_left[i],
                a.is_cat_split[i]) != (b.split_feature[j], b.split_bin[j],
                                       b.default_left[j], b.is_cat_split[j]) \
                or (a.is_cat_split[i] and not np.array_equal(
                    a.cat_words[i], b.cat_words[j])):
            size = max(abs(float(a.gain[i])), abs(float(b.gain[j])),
                       scale(b, j))
            moved = max(carry(a, i, d), carry(b, j, d))
            if abs(float(a.gain[i]) - float(b.gain[j])) > 2e-4 * size \
                    + 1e-6 + moved:
                raise AssertionError(f"{label}: node {i} splits "
                                     "differently, not at a near tie")
            log(f"{label}: node {i} near tie, card (f{a.split_feature[i]}"
                f", bin {a.split_bin[i]}, gain {a.gain[i]}) vs CPU "
                f"(f{b.split_feature[j]}, bin {b.split_bin[j]}, gain "
                f"{b.gain[j]}), certificate {2e-4 * size + 1e-6 + moved:.3e}")
            ties.append(int(i))
            continue
        step = (4 * U * max_g * n_rows(j), 4 * U * float(b.sum_hess[j]))
        stack.append((a.left_child[i], b.left_child[j], step))
        stack.append((a.right_child[i], b.right_child[j],
                      (d[0] + step[0], d[1] + step[1])))
    return ties, gap, worst


def card_against_cpu(xt, name, params, X, rounds=GAP_ROUNDS, **dm_kw):
    """The first ``GAP_ROWS`` rows on the card and on the CPU port, round
    by round: round r grows on both devices from the CPU model's margin
    before it (``base_margin``), so that only the devices' arithmetic
    differs, and its trees are held to :func:`certified_trees` (the
    int8x2 quanta of the CPU's gradient at that margin, each leaf's rows
    from ``pred_leaf``). Returns (trees the same in full, near-tie nodes
    by tree, the largest leaf gap, the largest gap over its bound)."""
    rows = {k: (v[:GAP_ROWS] if isinstance(v, np.ndarray) else v)
            for k, v in dm_kw.items()}
    Xg = X[:GAP_ROWS]
    cpu_p = dict(params, device="cpu")
    ref = xt.train(cpu_p, xt.DMatrix(Xg, **rows), rounds, verbose_eval=False)
    full, ties, gap, worst = 0, {}, 0.0, 0.0
    for r in range(rounds):
        kw = dict(rows)
        if r:
            kw["base_margin"] = ref.predict(
                xt.DMatrix(Xg, **rows), output_margin=True,
                strict_shape=True, iteration_range=(0, r))
        card = xt.train(params, xt.DMatrix(Xg, **kw), 1, verbose_eval=False)
        dm = xt.DMatrix(Xg, **kw)
        cpu = xt.train(cpu_p, dm, 1, verbose_eval=False)
        if r == 0 and not np.allclose(card._base_np(), cpu._base_np(),
                                      rtol=1e-6):
            raise AssertionError(f"{name}: the intercepts differ on the card")
        st = cpu._state_of(dm, True)
        q = (cpu._gradient(st["base"], st, dm, 0, None).abs().amax(dim=0)
             / 32512.0).numpy()
        leaves = cpu.predict(dm, pred_leaf=True)
        tp = cpu.tree_param
        for t, (a, b) in enumerate(zip(card.gbm.trees, cpu.gbm.trees)):
            idx, n = np.unique(leaves[:, t], return_counts=True)
            tie, g, w = certified_trees(
                a, b, f"{name} round {r} tree {t}", tp.eta, tp.reg_lambda,
                tuple(float(v) for v in q[cpu.gbm.tree_info[t]]),
                dict(zip(idx.tolist(), n.tolist())))
            gap, worst = max(gap, g), max(worst, w)
            if tie:
                ties[f"{r}.{t}"] = tie
            else:
                full += 1
    log(f"{name}: card vs CPU at {GAP_ROWS} rows, round by round from one "
        f"margin, {rounds} rounds: {full} of {len(ref.gbm.trees)} trees the "
        f"same in full" + (f", near ties at {ties}" if ties else "")
        + f"; largest leaf gap {gap:.3e} ({worst:.3f} of its bound)")
    if not full:
        raise AssertionError(f"{name}: no tree compared in full")
    return full, ties, gap, worst


def vector_trees_agree(a, b, label, eta, lam):
    """The card's vector-leaf tree ``a`` against the CPU port's ``b``, the
    tests' rule for vector leaves (``tests/test_torch_train.py
    compare_tree``): nodes paired from the root; each target's leaf
    weight within rtol 1e-5 plus 1e-4; a node's gain (summed over the
    targets) within 2e-4 of its scale, the targets' parent terms summed
    (at an even share of the node's hessian, the model keeps no
    per-target sums) plus its gain; a node that splits differently, or in
    one tree only, is a near tie under the same bound and its subtree is
    skipped. Returns (near-tie nodes, largest leaf gap)."""
    ties, gap, stack = [], 0.0, [(0, 0)]
    while stack:
        i, j = stack.pop()
        w = np.asarray(a.base_weight[i], np.float64) / eta
        scale = float(np.sum(w * w) * (float(a.sum_hess[i]) / w.size + lam)
                      + abs(float(a.gain[i])))
        if a.is_leaf[i] and b.is_leaf[j]:
            if not np.allclose(a.leaf_value[i], b.leaf_value[j], rtol=1e-5,
                               atol=1e-4):
                raise AssertionError(f"{label}: leaf {i} differs on the card")
            gap = max(gap, float(np.max(np.abs(
                np.asarray(a.leaf_value[i], np.float64) - b.leaf_value[j]))))
            continue
        if abs(float(a.gain[i]) - float(b.gain[j])) > 2e-4 * scale:
            raise AssertionError(f"{label}: node {i}'s gain {a.gain[i]} on "
                                 f"the card, {b.gain[j]} on the CPU, not at a "
                                 "near tie")
        if a.is_leaf[i] or b.is_leaf[j] or (
                a.split_feature[i], a.split_bin[i], a.default_left[i]) != (
                b.split_feature[j], b.split_bin[j], b.default_left[j]):
            ties.append(int(i))
            continue
        stack += [(a.left_child[i], b.left_child[j]),
                  (a.right_child[i], b.right_child[j])]
    return ties, gap


def paged_card_against_cpu(xt, label, params, dm, dev, capped=False,
                           cpu_extra=None):
    """One round of ``params`` on the paged matrix ``dm`` on the card and
    on the CPU port (``params`` updated by ``cpu_extra`` there: a CPU mesh
    for a mesh of the card), each device streaming the same pages under
    the same page-cache budget (its own cache), from the same intercept.
    Scalar
    trees are held to :func:`certified_trees` (the int8x2 quanta of the
    CPU's gradient over all rows, which bound each page's own; each
    leaf's rows from the CPU's ``pred_leaf``), vector-leaf trees to
    :func:`vector_trees_agree`. Returns {"full": trees the same in full,
    "trees", "ties": near-tie nodes by tree, "leaf_gap", "s": the card's
    and the CPU's seconds}."""
    t0 = time.perf_counter()
    with NoPlainBuilds():
        card = xt.train(params, dm, 1, verbose_eval=False)
    t_card = time.perf_counter() - t0
    cpu_p = dict(params, device="cpu", **(cpu_extra or {}))
    t0 = time.perf_counter()
    cpu = xt.train(cpu_p, dm, 1, verbose_eval=False)
    t_cpu = time.perf_counter() - t0
    if not np.allclose(card._base_np(), cpu._base_np(), rtol=1e-6):
        raise AssertionError(f"{label}: the intercepts differ")
    tp = cpu.tree_param
    full, ties, gap = 0, {}, 0.0
    if cpu.gbm.trees[0].leaf_value.ndim == 2:
        for t, (a, b) in enumerate(zip(card.gbm.trees, cpu.gbm.trees)):
            tie, g = vector_trees_agree(a, b, f"{label} tree {t}", tp.eta,
                                        tp.reg_lambda)
            gap = max(gap, g)
            if tie:
                ties[t] = tie
            else:
                full += 1
    else:
        st = cpu._state_of(dm, True)
        q = (cpu._gradient(st["base"], st, dm, 0, None).abs().amax(dim=0)
             / 32512.0).numpy()
        leaves = cpu.predict(dm, pred_leaf=True)
        for t, (a, b) in enumerate(zip(card.gbm.trees, cpu.gbm.trees)):
            idx, n = np.unique(leaves[:, t], return_counts=True)
            tie, g, _ = certified_trees(
                a, b, f"{label} tree {t}", tp.eta, tp.reg_lambda,
                tuple(float(v) for v in q[cpu.gbm.tree_info[t]]),
                dict(zip(idx.tolist(), n.tolist())), capped=capped)
            gap = max(gap, g)
            if tie:
                ties[t] = tie
            else:
                full += 1
    n_trees = len(cpu.gbm.trees)
    if len(card.gbm.trees) != n_trees or not full:
        raise AssertionError(f"{label}: {full} of {n_trees} trees compared "
                             "in full")
    log(f"{label}: {dm.num_row()} rows in 2 pages, 1 cached, one round: "
        f"{full} of {n_trees} trees the same in full"
        + (f", near ties at {ties}" if ties else "")
        + f"; largest leaf gap {gap:.3e}; card {t_card:.3f} s, CPU "
        f"{t_cpu:.3f} s")
    return {"full": full, "trees": n_trees, "ties": ties, "leaf_gap": gap,
            "s": (t_card, t_cpu)}


def quantile_regression(xt, dev, X):
    """The ``quantile_regression`` phase (module docstring): returns (the
    main-path runs' launch counts, a summary)."""
    from xgboost_tpu_torch.objective.adaptive import segment_quantiles

    t_phase = time.perf_counter()
    n_tr = HIGGS_TRAIN
    y = quantile_labels(X, seed=21)
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr])
    dte = xt.DMatrix(X[n_tr:], label=y[n_tr:])
    yte = y[n_tr:]
    alphas = QR_PARAMS["quantile_alpha"]
    depth = QR_PARAMS["max_depth"]
    runs, out = [], {}

    def want(bst, c):
        r = bst.num_boosted_rounds()
        if c["hist_scan"] != depth * len(alphas) * r or c["hist_int8x2"] \
                or c["hist_f32"]:
            return f"expected K4 {depth * len(alphas)} a round only"
        if c["walk_packed"] != r:
            return "expected K1 once a round (the held-out walk)"
        return None

    bst, res, c, digest_q, rr = train_model_twice(
        xt, "quantile_regression", QR_PARAMS, dtr, QR_ROUNDS,
        [(dte, "test")], want, early_stopping_rounds=QR_EARLY_STOP)
    runs += rr
    r_end = bst.num_boosted_rounds()
    first = bst.predict(dte, iteration_range=(0, 1))
    last = bst.predict(dte)
    if first.shape != (len(yte), 3) or not np.isfinite(last).all():
        raise AssertionError(f"quantile predictions of shape {last.shape}")
    loss0 = [pinball(yte, first[:, k], a) for k, a in enumerate(alphas)]
    loss1 = [pinball(yte, last[:, k], a) for k, a in enumerate(alphas)]
    if not all(b < a for a, b in zip(loss0, loss1)):
        raise AssertionError(f"held-out pinball loss did not fall: {loss0} "
                             f"-> {loss1}")
    cover = float(np.mean((yte >= last[:, 0]) & (yte <= last[:, 2])))
    qm = res["test"]["quantile"]
    out["quantile"] = dict(rounds=r_end, best=bst.best_iteration,
                           loss=(loss0, loss1), cover=cover, digest=digest_q,
                           per_round=launches_per_round(c, r_end))
    log(f"quantile_regression: {r_end} rounds (early stopping at "
        f"{QR_EARLY_STOP}: best_iteration {bst.best_iteration}, held-out "
        f"quantile metric {qm[0]} -> {qm[-1]}); launches a round "
        f"{out['quantile']['per_round']}; held-out pinball loss per alpha "
        f"{dict(zip(alphas, [f'{a:.6f} -> {b:.6f}' for a, b in zip(loss0, loss1)]))}; "
        f"coverage of [q0.05, q0.95] {cover:.6f} (nominal 0.90)")
    out["quantile"]["s_round"], out["quantile"]["busy"] = cell_profile(
        xt, "quantile_regression", QR_PARAMS, dtr)
    # the leaf refresh alone: one tree's quantile over the 1M training
    # rows (device-only: the host queues it behind a device sleep)
    tree = bst.gbm.trees[-1]
    leaves = torch.from_numpy(np.nonzero(tree.is_leaf)[0]).to(dev)
    pos = leaves[torch.randint(0, len(leaves), (n_tr,), device=dev)]
    res64 = torch.randn(n_tr, dtype=torch.float64, device=dev)
    refresh_ms = queued_ms(lambda: segment_quantiles(pos, res64, None,
                                                     leaves, 0.5), 10, None)
    out["quantile"]["refresh_ms"] = refresh_ms
    log(f"quantile_regression: leaf refresh (float64 sort by leaf and "
        f"residual, one gather a leaf) {refresh_ms:.6f} ms a tree on "
        f"{n_tr} rows and {len(leaves)} leaves (device-only), "
        f"{refresh_ms * len(alphas):.6f} ms a round")
    out["quantile"]["gap"] = card_against_cpu(
        xt, "quantile_regression", QR_PARAMS, X, label=y)

    # reg:absoluteerror on the same rows
    res_m = {}
    with NoPlainBuilds():
        bm, cm = train_launches("reg:absoluteerror", lambda: xt.train(
            dict(QR_PARAMS, objective="reg:absoluteerror"), dtr, MAE_ROUNDS,
            evals=[(dte, "test")], evals_result=res_m, verbose_eval=False))
    if cm["hist_scan"] != depth * MAE_ROUNDS or \
            cm["walk_packed"] != MAE_ROUNDS:
        raise AssertionError(f"reg:absoluteerror launched {cm}")
    runs.append(cm)
    mae = res_m["test"]["mae"]
    if not mae[-1] < mae[0]:
        raise AssertionError(f"held-out MAE did not fall: {mae}")
    out["mae"] = dict(mae=(mae[0], mae[-1]),
                      digest=digest(bm))
    log(f"reg:absoluteerror: {MAE_ROUNDS} rounds, held-out MAE {mae[0]} -> "
        f"{mae[-1]}; model sha256 {out['mae']['digest']}")
    card_against_cpu(xt, "reg:absoluteerror",
                     dict(QR_PARAMS, objective="reg:absoluteerror"), X,
                     label=y)

    # three objectives the other phases do not reach, 3 rounds each
    labels = {"reg:pseudohubererror": y,
              "reg:squaredlogerror": np.exp(0.3 * y).astype(np.float32),
              "binary:hinge": (y > np.median(y)).astype(np.float32)}
    out["extra"] = {}
    for obj in EXTRA_OBJECTIVES:
        dtr.set_label(labels[obj][:n_tr])
        dte.set_label(labels[obj][n_tr:])
        r = {}
        with NoPlainBuilds():
            b, ce = train_launches(obj, lambda o=obj, r=r: xt.train(
                dict(QR_PARAMS, objective=o), dtr, EXTRA_ROUNDS,
                evals=[(dte, "test")], evals_result=r, verbose_eval=False))
        if ce["hist_scan"] != depth * EXTRA_ROUNDS:
            raise AssertionError(f"{obj} launched {ce}")
        runs.append(ce)
        metric = list(r["test"])[0]
        m = r["test"][metric]
        p = b.predict(dte)
        if not (np.isfinite(p).all() and m[-1] <= m[0]):
            raise AssertionError(f"{obj}: held-out {metric} {m}")
        if obj == "binary:hinge" and not set(np.unique(p)) <= {0.0, 1.0}:
            raise AssertionError("binary:hinge predicted other than 0/1")
        out["extra"][obj] = (metric, m[0], m[-1])
        log(f"{obj}: {EXTRA_ROUNDS} rounds, held-out {metric} {m[0]} -> "
            f"{m[-1]}; K4 {ce['hist_scan']}; model sha256 {digest(b)}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"quantile_regression phase: {out['phase_s']:.1f} s")
    return runs, out


def survival(xt, dev, X):
    """The ``survival`` phase (module docstring): returns (the main-path
    runs' launch counts, a summary)."""
    t_phase = time.perf_counter()
    n_tr = HIGGS_TRAIN
    t, lo, hi, cox = survival_times(X, seed=31)
    kw_tr = dict(label_lower_bound=lo[:n_tr], label_upper_bound=hi[:n_tr])
    kw_te = dict(label_lower_bound=lo[n_tr:], label_upper_bound=hi[n_tr:])
    dtr = xt.DMatrix(X[:n_tr], label=t[:n_tr], **kw_tr)
    dte = xt.DMatrix(X[n_tr:], label=t[n_tr:], **kw_te)
    depth = AFT_PARAMS["max_depth"]
    runs, out = [], {}

    def want(rounds):
        def check(bst, c):
            if c["hist_scan"] != depth * rounds or c["hist_int8x2"] \
                    or c["hist_f32"]:
                return f"expected K4 {depth} a round only"
            if c["walk_packed"] != rounds:
                return "expected K1 once a round (the held-out walk)"
            return None
        return check

    bst, res, c, d_aft, rr = train_model_twice(
        xt, "survival:aft normal", AFT_PARAMS, dtr, SURV_ROUNDS,
        [(dte, "test")], want(SURV_ROUNDS))
    runs += rr
    nll = res["test"]["aft-nloglik"]
    acc = res["test"]["interval-regression-accuracy"]
    if not (nll[-1] < nll[0] and acc[-1] >= acc[0]
            and np.isfinite(bst.predict(dte)).all()):
        raise AssertionError(f"AFT held-out aft-nloglik {nll}, accuracy "
                             f"{acc}")
    out["aft"] = dict(nll=(nll[0], nll[-1]), acc=(acc[0], acc[-1]),
                      digest=d_aft)
    log(f"survival:aft normal (scale 1.2): {SURV_ROUNDS} rounds, held-out "
        f"aft-nloglik {nll[0]} -> {nll[-1]}, interval-regression-accuracy "
        f"{acc[0]} -> {acc[-1]}; launches a round "
        f"{launches_per_round(c, SURV_ROUNDS)}")
    out["aft"]["s_round"], out["aft"]["busy"] = cell_profile(
        xt, "survival:aft", AFT_PARAMS, dtr)
    out["aft"]["gap"] = card_against_cpu(xt, "survival:aft", AFT_PARAMS, X,
                                         label=t, label_lower_bound=lo,
                                         label_upper_bound=hi)
    for dist in ("logistic", "extreme"):
        p = dict(AFT_PARAMS, aft_loss_distribution=dist)
        r = {}
        with NoPlainBuilds():
            b, cd = train_launches(f"survival:aft {dist}", lambda p=p, r=r:
                                   xt.train(p, dtr, OTHER_ROUNDS,
                                            evals=[(dte, "test")],
                                            evals_result=r,
                                            verbose_eval=False))
        bad = want(OTHER_ROUNDS)(b, cd)
        if bad:
            raise AssertionError(f"survival:aft {dist}: {bad} ({cd})")
        runs.append(cd)
        acc_d = r["test"]["interval-regression-accuracy"]
        out[f"aft_{dist}"] = (acc_d[0], acc_d[-1])
        log(f"survival:aft {dist}: {OTHER_ROUNDS} rounds, held-out "
            f"aft-nloglik {r['test']['aft-nloglik']}, accuracy {acc_d}; "
            f"model sha256 {digest(b)}")
    # Cox on the same rows: a negative label is a right-censored time
    dtr_c = xt.DMatrix(X[:n_tr], label=cox[:n_tr])
    dte_c = xt.DMatrix(X[n_tr:], label=cox[n_tr:])
    cox_p = dict(AFT_PARAMS, objective="survival:cox",
                 eval_metric="cox-nloglik")
    bc, res_c, cc, d_cox, rr = train_model_twice(
        xt, "survival:cox", cox_p, dtr_c, SURV_ROUNDS, [(dte_c, "test")],
        want(SURV_ROUNDS))
    runs += rr
    cn = res_c["test"]["cox-nloglik"]
    if not cn[-1] < cn[0]:
        raise AssertionError(f"held-out cox-nloglik did not fall: {cn}")
    out["cox"] = dict(nll=(cn[0], cn[-1]), digest=d_cox)
    log(f"survival:cox: {SURV_ROUNDS} rounds, held-out cox-nloglik {cn[0]} "
        f"-> {cn[-1]}; launches a round {launches_per_round(cc, SURV_ROUNDS)}")
    out["cox"]["s_round"], out["cox"]["busy"] = cell_profile(
        xt, "survival:cox", cox_p, dtr_c)
    out["cox"]["gap"] = card_against_cpu(xt, "survival:cox", cox_p, X,
                                         label=cox)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"survival phase: {out['phase_s']:.1f} s")
    return runs, out


def insurance_claims(xt, dev):
    """The ``insurance_claims`` phase (module docstring): returns (the
    main-path runs' launch counts, a summary)."""
    t_phase = time.perf_counter()
    X, expo, counts, amounts = fremtpl2_like(seed=41)
    n_tr = MTPL_ROWS - MTPL_TEST
    claimed = counts > 0
    log(f"fremtpl2_like: {MTPL_ROWS} x {X.shape[1]} ({n_tr} train, "
        f"{MTPL_TEST} held out), {claimed.mean() * 100:.3f}% of policies "
        f"with a claim, mean exposure {expo.mean():.4f}, categories "
        f"{[int(X[:, j].max()) + 1 for j in (4, 6, 8)]}")
    cat = dict(feature_types=MTPL_TYPES, enable_categorical=True)
    freq = counts / expo
    pure = amounts / expo
    depth = MTPL_PARAMS["max_depth"]
    runs, out = [], {}

    def want(rounds):
        def check(bst, c):
            if c["hist_int8x2"] != depth * rounds or c["hist_scan"] \
                    or c["hist_f32"]:
                return f"expected K2 {depth} a round only"
            if c["walk_packed"] != rounds:
                return "expected K1 once a round (the held-out walk)"
            return None
        return check

    cells = (("count:poisson", {"objective": "count:poisson",
                                "eval_metric": "poisson-nloglik"},
              freq, expo, None),
             ("reg:tweedie", {"objective": "reg:tweedie",
                              "tweedie_variance_power": 1.5},
              pure, expo, None),
             ("reg:gamma", {"objective": "reg:gamma",
                            "eval_metric": "gamma-deviance"},
              np.where(claimed, amounts / np.maximum(counts, 1), 0),
              counts, claimed))
    for name, extra, label, weight, rows in cells:
        idx = np.arange(MTPL_ROWS) if rows is None else np.nonzero(rows)[0]
        tr, te = idx[idx < n_tr], idx[idx >= n_tr]
        label = label.astype(np.float32)
        dtr = xt.DMatrix(X[tr], label=label[tr], weight=weight[tr], **cat)
        dte = xt.DMatrix(X[te], label=label[te], weight=weight[te], **cat)
        # the intercept starts at the weighted mean of the training labels,
        # as scikit-learn's GLM examples fit it (one Newton step from 0
        # leaves the log link at ~1 against euro amounts in the thousands)
        p = dict(MTPL_PARAMS, base_score=float(np.average(
            label[tr], weights=weight[tr])), **extra)
        b, res, c, d, rr = train_model_twice(
            xt, f"insurance {name}", p, dtr, MTPL_ROUNDS, [(dte, "test")],
            want(MTPL_ROUNDS))
        runs += rr
        metric = list(res["test"])[0]
        m = res["test"][metric]
        pred = b.predict(dte)
        if not (m[-1] < m[0] and np.isfinite(pred).all()
                and (pred > 0).all()):
            raise AssertionError(f"insurance {name}: held-out {metric} {m}")
        s, busy = cell_profile(xt, f"insurance {name}", p, dtr)
        gap = card_against_cpu(xt, f"insurance {name}", p, X[tr],
                               label=label[tr], weight=weight[tr], **cat)
        out[name] = dict(metric=metric, m=(m[0], m[-1]), digest=d,
                         rows=(len(tr), len(te)), s_round=s, busy=busy,
                         gap=gap, per_round=launches_per_round(
                             c, MTPL_ROUNDS))
        log(f"insurance {name}: {len(tr)} + {len(te)} rows, {MTPL_ROUNDS} "
            f"rounds, held-out {metric} {m[0]} -> {m[-1]}, mean prediction "
            f"{float(np.mean(pred)):.6f} (label mean "
            f"{float(np.mean(label[te])):.6f}); launches a round "
            f"{out[name]['per_round']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"insurance_claims phase: {out['phase_s']:.1f} s")
    return runs, out


# the approx_higgs phase: ``tree_method="approx"`` on the main path's HIGGS
# draws (its re-sketch on the card every round), beside ``hist``
APPROX_ROUNDS = 10
APPROX_CHECK_ROUNDS = (1, 10)   # device cuts held against the host sketch
APPROX_GAP_DEPTH = 6            # the card-against-CPU trees' depth
# the kaggle_higgs_speedtest phase: XGBoost's demo/kaggle-higgs/speedtest.py
# (250,000 training events x 30 features, -999.0 missing, binary:logitraw,
# eta 0.1, depth 6, 10 rounds, auc and ams@0.15), the three tree methods
KAGGLE_TRAIN = 250_000
KAGGLE_TEST = 50_000
KAGGLE_TEST_SIZE = 550_000      # the demo's weight rescaling: test events
KAGGLE_PARAMS = {"objective": "binary:logitraw", "eta": 0.1, "max_depth": 6,
                 "eval_metric": ["auc", "ams@0.15"]}
KAGGLE_ROUNDS = 10
# PRI_jet_num's column, and the columns that are -999.0 when it is 0 / <= 1
KAGGLE_JETS = 22
KAGGLE_NO_JET = (4, 5, 6, 12, 23, 24, 25, 26, 27, 28, 29)
KAGGLE_ONE_JET = (4, 5, 6, 12, 26, 27, 28)


class SketchClock:
    """Within the block every ``WeightedSketch.cuts`` and every re-binning
    (``data/binned.py search_bin_t``) of an ``approx`` round is timed with
    CUDA events; the weights of the calls in ``keep`` (0-based) are kept
    with their cuts. :meth:`ms` -> (sketch ms, re-binning ms) a call."""

    def __init__(self, keep=()):
        self.keep, self.kept = set(keep), {}
        self.events = {"sketch": [], "rebin": []}

    def _timed(self, kind, fn):
        def run(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **k)
            e.record()
            self.events[kind].append((s, e))
            return out
        return run

    def __enter__(self):
        from xgboost_tpu_torch.data import binned as B
        from xgboost_tpu_torch.data.quantile import WeightedSketch

        self.saved = (WeightedSketch.cuts, B.search_bin_t)
        cuts = self._timed("sketch", self.saved[0])
        clock = self

        def kept_cuts(sketch, w):
            out = cuts(sketch, w)
            i = len(clock.events["sketch"]) - 1
            if i in clock.keep:
                clock.kept[i] = (w.detach().cpu().numpy(), out[0])
            return out

        WeightedSketch.cuts = kept_cuts
        B.search_bin_t = self._timed("rebin", self.saved[1])
        return self

    def __exit__(self, *exc):
        from xgboost_tpu_torch.data import binned as B
        from xgboost_tpu_torch.data.quantile import WeightedSketch

        WeightedSketch.cuts, B.search_bin_t = self.saved
        return False

    def ms(self):
        torch.cuda.synchronize()
        return tuple([s.elapsed_time(e) for s, e in self.events[k]]
                     for k in ("sketch", "rebin"))


def first_cut_difference(want, got):
    """None, or (feature, rank, host cut, device cut) of the first cut
    where two ``HistogramCuts`` differ."""
    for f in range(want.n_features):
        a = want.values[want.ptrs[f]:want.ptrs[f + 1]]
        b = got.values[got.ptrs[f]:got.ptrs[f + 1]]
        if a.shape != b.shape or not np.array_equal(
                a.view(np.uint32), b.view(np.uint32)) or \
                want.min_vals[f] != got.min_vals[f]:
            r = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                     min(len(a), len(b)))
            return (f, r, a[r] if r < len(a) else None,
                    b[r] if r < len(b) else None)
    return None


def sort_kernels(rows):
    """The profile's rows of sort kernels (cub's and torch's; not
    ``searchsorted``, and the histogram kernels' own count and scatter
    are named otherwise)."""
    return [r for r in rows
            if "sort" in r.key.lower().replace("searchsorted", "")]


def host_sketch(X, max_bin, weights):
    """``data/quantile.py sketch_matrix(X, max_bin, weights)`` with its
    per-feature summaries made on 8 threads (numpy's sorts release the
    interpreter lock): the same function, the same cuts."""
    from concurrent.futures import ThreadPoolExecutor

    from xgboost_tpu_torch.data.quantile import (FeatureSummary,
                                                 cuts_from_summaries)

    with ThreadPoolExecutor(8) as ex:
        summaries = list(ex.map(
            lambda f: FeatureSummary.from_data(X[:, f], weights),
            range(X.shape[1])))
    return cuts_from_summaries(summaries, max_bin)


def method_run(xt, label, params, dtr, dte, rounds, want):
    """One ``train`` of ``rounds`` on the card with held-out evaluation,
    the launch counts set to 0 before and the peak memory reset: returns
    (booster, evals_result, counts, peak GB). ``want(counts)`` -> None or
    the reason the launches are wrong."""
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with NoPlainBuilds():
        bst, c = train_launches(label, lambda: xt.train(
            params, dtr, rounds, evals=[(dte, "test")], evals_result=res,
            verbose_eval=False))
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad = want(c)
    if bad:
        raise AssertionError(f"{label}: {bad} ({c})")
    return bst, res, c, peak


def k4_per_round(depth, rounds):
    def check(c):
        if c["hist_scan"] != depth * rounds or c["hist_int8x2"] \
                or c["hist_f32"]:
            return f"expected K4 {depth} a round only"
        if c["walk_packed"] != rounds:
            return "expected K1 once a round (the held-out walk)"
        return None
    return check


def approx_higgs(xt, dev, X, y, n_tr=1_000_000):
    """The ``approx_higgs`` phase (module docstring) on the first ``n_tr``
    rows, the rest held out: returns (the main-path runs' launch counts,
    a summary)."""
    t_phase = time.perf_counter()
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr])
    dte = xt.DMatrix(X[n_tr:], label=y[n_tr:])
    depth = HIGGS_PARAMS["max_depth"]
    want = k4_per_round(depth, APPROX_ROUNDS)
    out, runs = {}, []
    hist, hres, hc, hpeak = method_run(xt, "approx_higgs hist", HIGGS_PARAMS,
                                       dtr, dte, APPROX_ROUNDS, want)
    runs.append(hc)
    p = dict(HIGGS_PARAMS, tree_method="approx")
    digests = []
    for run in range(2):
        clock = SketchClock(keep=[r - 1 for r in APPROX_CHECK_ROUNDS])
        with clock:
            bst, res, c, peak = method_run(xt, f"approx_higgs approx run "
                                           f"{run}", p, dtr, dte,
                                           APPROX_ROUNDS, want)
        runs.append(c)
        digests.append(digest(bst))
        if run == 0:
            approx, ares, apeak, aclock = bst, res, peak, clock
    if digests[0] != digests[1]:
        raise AssertionError(f"approx_higgs: two runs saved different "
                             f"models {digests}")
    sk_ms, rb_ms = aclock.ms()
    if len(sk_ms) != APPROX_ROUNDS or len(rb_ms) != APPROX_ROUNDS:
        raise AssertionError(f"approx_higgs: {len(sk_ms)} sketches and "
                             f"{len(rb_ms)} re-binnings in "
                             f"{APPROX_ROUNDS} rounds")
    # the device sketch against the host sketch on the same hessian
    for r in APPROX_CHECK_ROUNDS:
        w, got = aclock.kept[r - 1]
        t0 = time.perf_counter()
        host = host_sketch(X[:n_tr], HIGGS_PARAMS["max_bin"],
                           w.astype(np.float64))
        diff = first_cut_difference(host, got)
        if diff is not None:
            raise AssertionError(f"approx_higgs round {r}: the device "
                                 f"sketch differs from the host's at "
                                 f"feature {diff[0]}, rank {diff[1]} "
                                 f"(host {diff[2]}, device {diff[3]})")
        log(f"approx_higgs round {r}: device cuts equal the host sketch's "
            f"({len(got.values)} cuts over {got.n_features} features; host "
            f"sketch {time.perf_counter() - t0:.3f} s)")
    # the first round's weights are uniform (0.25 at base_score 0.5 ...
    # any constant): its cuts are hist's, so its tree is hist's
    if not np.array_equal(saved_tree(hist, 0), saved_tree(approx, 0)):
        raise AssertionError("approx_higgs: round 1's tree (uniform "
                             "hessians) differs from hist's")
    aucs = {}
    for name, b in (("hist", hist), ("approx", approx)):
        aucs[name] = auc(y[n_tr:], b.predict(dte))
    ll = {"hist": hres["test"]["logloss"], "approx": ares["test"]["logloss"]}
    if not ll["approx"][-1] < ll["approx"][0]:
        raise AssertionError(f"approx_higgs: held-out logloss {ll['approx']}")
    if abs(aucs["approx"] - aucs["hist"]) > 0.01:
        raise AssertionError(f"approx_higgs: held-out AUC {aucs}")
    cells = {}
    for name, params in (("hist", HIGGS_PARAMS), ("approx", p)):
        timer, per, s = seconds_per_round(params, dtr)
        busy, rows = profile_rounds(f"approx_higgs {name}", timer, dtr,
                                    top=12)
        cells[name] = {"s_round": s, "busy": busy,
                       "sorts": sum(r.count for r in sort_kernels(rows))}
        log(f"approx_higgs {name}: seconds a round "
            f"{['%.6f' % t for t in per]}, median of rounds 1-5 {s:.6f} s")
    if cells["approx"]["sorts"]:
        raise AssertionError(
            "approx_higgs: sort kernels ran in steady approx rounds: "
            f"{[(r.key, r.count) for r in sort_kernels(rows)]}")
    # card against CPU at depth 6: at depth 8 on 20,000 rows the leaves
    # hold a few rows, and hist's and approx's first trees (the same
    # trees) had near ties in both rounds on the H100
    gaps = {}
    p6 = dict(p, max_depth=APPROX_GAP_DEPTH)
    gaps["approx binary"] = card_against_cpu(xt, "approx binary", p6, X,
                                             label=y)
    y3 = np.digitize(X @ np.linspace(-1.0, 1.0, X.shape[1],
                                     dtype=np.float32),
                     [-1.0, 1.0]).astype(np.float32)
    gaps["approx 3 classes"] = card_against_cpu(
        xt, "approx 3 classes", dict(p6, objective="multi:softprob",
                                     num_class=3), X, label=y3)
    out = dict(
        s_round={k: v["s_round"] for k, v in cells.items()},
        busy={k: v["busy"] for k, v in cells.items()},
        sketch_ms=float(np.median(sk_ms[1:])),
        rebin_ms=float(np.median(rb_ms[1:])),
        first_sketch_ms=sk_ms[0],
        peak_gb={"hist": hpeak, "approx": apeak}, auc=aucs,
        ll={k: (v[0], v[-1]) for k, v in ll.items()},
        digest=digests[0], gaps=gaps,
        per_round=launches_per_round(runs[1], APPROX_ROUNDS))
    log(f"approx_higgs: sketch {['%.6f' % t for t in sk_ms]} ms, "
        f"re-binning {['%.6f' % t for t in rb_ms]} ms a round (CUDA "
        f"events); launches a round {out['per_round']}; peak memory "
        f"{out['peak_gb']} GB; held-out AUC at {APPROX_ROUNDS} {aucs}, "
        f"logloss {out['ll']}; model sha256 {digests[0]} (both runs)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"approx_higgs phase: {out['phase_s']:.1f} s")
    return runs, out


def saved_tree(bst, i):
    """Tree ``i`` of ``bst`` as its saved JSON bytes."""
    return np.frombuffer(json.dumps(bst.gbm.trees[i].to_json()).encode(),
                         np.uint8)


def kaggle_higgs_like(seed):
    """The Kaggle Higgs challenge's training file's shape (250,000 + the
    held-out events x 30 features): ``PRI_jet_num`` (column 22) in 0..3
    with the file's shares, the jet columns -999.0 where the event has
    too few jets and ``DER_mass_MMC`` (column 0) -999.0 in 15% of the
    events; 34% signal; weights as in the file (signal small, background
    large). Returns (X [n, 30] f32, y, raw weights), made from ``seed``."""
    rng = np.random.default_rng(seed)
    n = KAGGLE_TRAIN + KAGGLE_TEST
    X = rng.standard_normal((n, 30), dtype=np.float32)
    X = np.abs(X) * 40 + 20 * rng.standard_normal((1, 30)).astype(np.float32)
    jets = rng.choice(4, n, p=[0.40, 0.31, 0.20, 0.09])
    X[:, KAGGLE_JETS] = jets
    w_rule = rng.standard_normal(30).astype(np.float32)
    z = (X - X.mean(0)) / (X.std(0) + 1e-6)
    logit = z @ w_rule * 0.6 + 0.8 * (jets >= 2) + rng.standard_normal(n)
    y = (logit > np.quantile(logit, 0.66)).astype(np.float32)
    X[np.ix_(jets == 0, KAGGLE_NO_JET)] = -999.0
    X[np.ix_(jets == 1, KAGGLE_ONE_JET)] = -999.0
    X[rng.random(n) < 0.15, 0] = -999.0
    w = np.where(y > 0, rng.uniform(0.001, 0.02, n),
                 rng.uniform(0.5, 5.0, n)).astype(np.float32)
    return X, y, w


def exact_levels(xt, params, dtr):
    """Each level's time on the device's clock (CUDA events between level
    ends) of one ``exact`` tree, grown by one more ``update`` round."""
    from xgboost_tpu_torch.tree import exact as E

    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    advance, grow = E.update_positions, E.grow_exact

    def timed_advance(*a, **k):
        out = advance(*a, **k)
        mark()
        return out

    def timed_grow(*a, **k):
        mark()
        return grow(*a, **k)

    bst = xt.Booster(params)
    E.update_positions, E.grow_exact = timed_advance, timed_grow
    try:
        bst.update(dtr, 0)
    finally:
        E.update_positions, E.grow_exact = advance, grow
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def kaggle_higgs_speedtest(xt, dev):
    """The ``kaggle_higgs_speedtest`` phase (module docstring): returns
    (the main-path runs' launch counts, a summary)."""
    t_phase = time.perf_counter()
    X, y, w_raw = kaggle_higgs_like(seed=53)
    # the demo's rescaling, so the weights sum as over the test events
    w = w_raw * np.float32(KAGGLE_TEST_SIZE / len(y))
    tr = slice(0, KAGGLE_TRAIN)
    te = slice(KAGGLE_TRAIN, None)
    sum_wpos = float(w[tr][y[tr] == 1].sum())
    sum_wneg = float(w[tr][y[tr] == 0].sum())
    log(f"kaggle_higgs_like: {KAGGLE_TRAIN} + {KAGGLE_TEST} x {X.shape[1]}, "
        f"{(X == -999.0).mean() * 100:.2f}% of the values -999.0, signal "
        f"{y.mean() * 100:.2f}%, weight sums s {sum_wpos:.3f} b "
        f"{sum_wneg:.3f}")
    dtr = xt.DMatrix(X[tr], label=y[tr], weight=w[tr], missing=-999.0)
    dte = xt.DMatrix(X[te], label=y[te], weight=w[te], missing=-999.0)
    base = dict(KAGGLE_PARAMS, scale_pos_weight=sum_wneg / sum_wpos)
    depth = base["max_depth"]
    runs, out = [], {}

    def no_hist(c):
        if c["hist_scan"] or c["hist_int8x2"] or c["hist_f32"]:
            return "expected no histogram kernel"
        if c["walk_packed"] != KAGGLE_ROUNDS:
            return "expected K1 once a round (the held-out walk)"
        return None

    for tm, want in (("hist", k4_per_round(depth, KAGGLE_ROUNDS)),
                     ("approx", k4_per_round(depth, KAGGLE_ROUNDS)),
                     ("exact", no_hist)):
        p = dict(base, tree_method=tm)
        bst, res, c, peak = method_run(xt, f"kaggle {tm}", p, dtr, dte,
                                       KAGGLE_ROUNDS, want)
        runs.append(c)
        a, ams = res["test"]["auc"], res["test"]["ams@0.15"]
        if not (a[-1] > 0.6 and np.isfinite(bst.predict(dte)).all()):
            raise AssertionError(f"kaggle {tm}: held-out auc {a}")
        s, busy = cell_profile(xt, f"kaggle {tm}", p, dtr)
        out[tm] = dict(s_round=s, busy=busy, peak_gb=peak, auc=(a[0], a[-1]),
                       ams=(ams[0], ams[-1]), digest=digest(bst),
                       per_round=launches_per_round(c, KAGGLE_ROUNDS))
        log(f"kaggle {tm}: held-out auc {a[0]} -> {a[-1]}, ams@0.15 "
            f"{ams[0]} -> {ams[-1]}, peak memory {peak:.3f} GB, model "
            f"sha256 {out[tm]['digest']}; launches a round "
            f"{out[tm]['per_round']}")
    lv = exact_levels(xt, dict(base, tree_method="exact"), dtr)
    out["exact"]["level_ms"] = lv
    log(f"kaggle exact: level times {['%.3f' % t for t in lv]} ms (CUDA "
        f"events between level ends, one tree)")
    out["gap"] = card_against_cpu(xt, "kaggle exact", dict(
        base, tree_method="exact"), X[tr], label=y[tr], weight=w[tr],
        missing=-999.0)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"kaggle_higgs_speedtest phase: {out['phase_s']:.1f} s")
    return runs, out


# ---- the linear booster, SHAP, the wrappers, cv and the CLI -----------------

# XGBoost's demo/guide-python/generalized_linear_model.py: its settings
# (eta left at its default, as the demo leaves it) and its 4 rounds on the
# agaricus files; 20 rounds of each updater at the HIGGS shape
LINEAR_PARAMS = {"objective": "binary:logistic", "booster": "gblinear",
                 "alpha": 0.0001, "lambda": 1}
LINEAR_ROUNDS = 20
LINEAR_DEMO_ROUNDS = 4
LINEAR_GAP_ROWS = 20_000
LINEAR_TOL = 5e-6              # tests/test_torch_gblinear.py W_TOL
CONTRIB_SUM_ATOL = 1e-4        # a row's f32 contributions against K1
SHAP_HOST_TOL = 1e-9           # the card's float64 values against the host
SHAP_ROUNDS = 100              # the explained forest: HIGGS depth 8
SHAP_ROWS = {"contribs": 10_000, "interactions": 1_000, "approx": 100_000}
# rows (and, for interactions, trees) held against the host recursion,
# as few as keep those checks near 15 s of host time
SHAP_HOST = {"contribs": (3, None), "approx": (500, None),
             "interactions": (1, 4)}
SHAP_COV_ROWS = 1_000
SHAP_COV_HOST = {"contribs": (1, None), "approx": (100, None),
                 "interactions": (1, 7)}
SHAP_FLAGS = {"contribs": {"pred_contribs": True},
              "approx": {"pred_contribs": True, "approx_contribs": True},
              "interactions": {"pred_interactions": True}}
SK_ROUNDS = 10
SK_EARLY_STOP = 3
CV_FOLDS = 5
CV_ROUNDS = 10


def logloss(y, p):
    p = np.clip(p.astype(np.float64), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def gblinear_higgs(xt, dev, X, y, tmp):
    """The ``gblinear_higgs`` phase: each updater 20 rounds at 1M x 28
    twice (one sha256; no histogram or walk kernel: the round is two
    products and an update, the margins X W + b), held-out AUC and
    logloss, seconds a round and three profiled rounds, the card's
    weights against the CPU's at 20,000 rows, a reference-schema round
    trip and ``pred_contribs`` summing to the margin; then the demo's 4
    rounds on ``agaricus_like``'s files. Returns (launch counts, results
    by updater)."""
    card = gpu_line()
    n_tr = 1_000_000
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr])
    dte = xt.DMatrix(X[n_tr:], label=y[n_tr:])
    yte = y[n_tr:]
    runs, out = [], {}
    for upd in ("shotgun", "coord_descent"):
        p = dict(LINEAR_PARAMS, updater=upd)
        raws = []
        for run in range(2):
            res = {}
            bst, c = train_launches(
                f"gblinear {upd} run {run}", lambda r=res: xt.train(
                    p, dtr, LINEAR_ROUNDS, evals=[(dte, "test")],
                    evals_result=r, verbose_eval=False))
            runs.append(c)
            raws.append(bytes(bst.save_raw("ubj")))
        digests = [hashlib.sha256(r).hexdigest() for r in raws]
        if digests[0] != digests[1] or bst.gbm.W.device.type != dev.type:
            raise AssertionError(f"gblinear {upd}: sha256 {digests}, "
                                 f"weights on {bst.gbm.W.device}")
        hist = res["test"]["logloss"]
        pte = bst.predict(dte)
        a, ll = auc(yte, pte), logloss(yte, pte)
        if not (hist[-1] < hist[0] and a > 0.8 and np.isfinite(pte).all()):
            raise AssertionError(f"gblinear {upd}: logloss {hist}, AUC {a}")
        timer, per_round, s_round = seconds_per_round(p, dtr)
        busy, _ = profile_rounds(f"gblinear {upd}", timer, dtr, top=8)
        del timer
        # the card's weights against the CPU's
        Xs, ys = X[:LINEAR_GAP_ROWS], y[:LINEAR_GAP_ROWS]
        g = xt.train(p, xt.DMatrix(Xs, label=ys), LINEAR_ROUNDS,
                     verbose_eval=False)
        cpu = xt.train(dict(p, device="cpu"), xt.DMatrix(Xs, label=ys),
                       LINEAR_ROUNDS, verbose_eval=False)
        Wg = torch.cat([g.gbm.W.cpu(), g.gbm.bias.cpu()[None]]).numpy()
        Wc = torch.cat([cpu.gbm.W, cpu.gbm.bias[None]]).numpy()
        gap = float(np.abs(Wg - Wc).max())
        if (np.abs(Wg - Wc) > LINEAR_TOL * (1 + np.abs(Wc))).any():
            raise AssertionError(f"gblinear {upd}: card and CPU weights "
                                 f"{gap} apart")
        # the reference schema, written and read back
        path = os.path.join(tmp, f"gblinear_{upd}.json")
        xt.save_xgboost_model(bst, path)
        back = xt.load_xgboost_model(path, device=dev.type)
        m0 = bst.predict(dte, output_margin=True)
        ref_err = float(np.abs(back.predict(dte, output_margin=True)
                               - m0).max())
        if ref_err > 1e-5:
            raise AssertionError(f"gblinear {upd}: the reference-schema "
                                 f"round trip moved margins by {ref_err}")
        sub = xt.DMatrix(X[n_tr:n_tr + SHAP_ROWS["contribs"]])
        contribs = bst.predict(sub, pred_contribs=True)
        sum_err = float(np.abs(contribs.sum(-1) - bst.predict(
            sub, output_margin=True)).max())
        if contribs.shape != (SHAP_ROWS["contribs"], 29) or \
                sum_err > CONTRIB_SUM_ATOL:
            raise AssertionError(f"gblinear {upd} contribs: "
                                 f"{contribs.shape}, sum error {sum_err}")
        out[upd] = dict(auc=a, logloss=ll, hist=(hist[0], hist[-1]),
                        s_round=s_round, busy=busy, gap=gap,
                        digest=digests[0], ref_err=ref_err, sum_err=sum_err)
        log(f"gblinear {upd} ({card}): {LINEAR_ROUNDS} rounds twice, one "
            f"sha256 {digests[0]}; held-out AUC {a:.6f}, logloss {ll:.6f} "
            f"(eval {hist[0]} -> {hist[-1]}); {s_round:.6f} s a round "
            f"(rounds {['%.6f' % t for t in per_round]}), device busy "
            f"{busy:.3f} ms over 3 rounds; card - CPU weights at "
            f"{LINEAR_GAP_ROWS} rows {gap:.3e}; reference-schema round "
            f"trip {ref_err:.3e}; contribs sum - margin {sum_err:.3e}")
    # the demo's 4 rounds on the agaricus files
    train, test = agaricus_like(seed=16, directory=tmp)
    dtrain = xt.DMatrix(train + "?format=libsvm")
    dtest = xt.DMatrix(test + "?format=libsvm")
    demo, c = train_launches("gblinear demo", lambda: xt.train(
        LINEAR_PARAMS, dtrain, LINEAR_DEMO_ROUNDS,
        evals=[(dtest, "eval"), (dtrain, "train")], verbose_eval=True))
    runs.append(c)
    err = float(np.mean((demo.predict(dtest) > 0.5) != dtest.get_label()))
    if not err < 0.2:
        raise AssertionError(f"gblinear demo: held-out error {err}")
    out["demo_error"] = err
    log(f"gblinear demo ({card}): {LINEAR_DEMO_ROUNDS} rounds on "
        f"{AGARICUS_TRAIN_ROWS} x 127, held-out error {err:.6f}")
    return runs, out


def shap_forest(xt, label, bst, Xq, rows, host, dm_kw=None):
    """``Booster.predict``'s three kinds of contributions of one forest on
    the card: each timed (host clock around the call, and CUDA events
    around a second run of the float64 computation alone), its peak
    memory, its rows summed against K1's margins (interactions against
    the contributions), and the card's float64 values of its first rows
    held against the host recursion (``boosting/shap.py``) to
    ``SHAP_HOST_TOL``. Returns (K1's launches, results by kind)."""
    from xgboost_tpu_torch.boosting import shap as plain
    from xgboost_tpu_torch.ops import shap as shap_ops

    card = gpu_line()
    t0 = time.perf_counter()
    pack = bst._shap_pack(None)
    pack_s = time.perf_counter() - t0
    log(f"shap {label}: path tables T {pack.T} L {pack.L} D {pack.D} K "
        f"{pack.K}, {pack.nbytes / 1e6:.3f} MB, built in {pack_s:.3f} s "
        f"(host)")
    trees, info, weights = bst.gbm.forest_slice(None)
    base = bst._base_np()
    reset_counts()
    out = {"pack_s": pack_s}
    dm_kw = dm_kw or {}
    for kind, n in rows.items():
        dm = xt.DMatrix(Xq[:n], **dm_kw)
        Xv = np.ascontiguousarray(dm.values(), np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = bst.predict(dm, **SHAP_FLAGS[kind])
        host_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not np.isfinite(got).all():
            raise AssertionError(f"shap {label} {kind}: non-finite values")
        if not any(k.startswith("cuda") for k in pack._dev):
            raise AssertionError(f"shap {label}: no tables on the card "
                                 f"({list(pack._dev)})")
        fn = {"contribs": shap_ops.contribs, "approx": shap_ops.saabas,
              "interactions": shap_ops.interactions}[kind]
        Xd = torch.from_numpy(Xv).to("cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(pack, Xd, base)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if kind == "interactions":
            ref = bst.predict(dm, pred_contribs=True)
        else:
            ref = bst.predict(dm, output_margin=True)
        sum_err = float(np.abs(got.sum(-1) - ref).max())
        if sum_err > CONTRIB_SUM_ATOL:
            raise AssertionError(f"shap {label} {kind}: rows sum "
                                 f"{sum_err} off")
        # the card's float64 values against the host recursion's on the
        # first rows (interactions: of the first trees)
        hn, ht = host[kind]
        lo, hi = bst.gbm._tree_range((0, ht) if ht else None)
        t0 = time.perf_counter()
        want = {"contribs": plain.tree_shap, "approx": plain.approx_contribs,
                "interactions": plain.shap_interactions}[kind](
            Xv[:hn], trees[lo:hi], info[lo:hi], bst.n_groups, base,
            None if weights is None else weights[lo:hi])
        plain_s = time.perf_counter() - t0
        have = fn(bst._shap_pack((0, ht) if ht else None), Xd[:hn],
                  base).cpu().numpy()
        host_err = float(np.abs(have - want).max())
        if not np.allclose(have, want, rtol=SHAP_HOST_TOL,
                           atol=SHAP_HOST_TOL):
            raise AssertionError(f"shap {label} {kind}: card - host "
                                 f"{host_err}")
        out[kind] = dict(rows=n, host_s=host_s, ms=ms, peak_gb=peak,
                         sum_err=sum_err, host_err=host_err,
                         host_rows=hn, plain_s=plain_s)
        log(f"shap {label} {kind} ({card}): {n} rows, shape {got.shape}; "
            f"predict {host_s:.6f} s (host clock), float64 computation "
            f"{ms:.3f} ms (CUDA events), peak {peak:.3f} GB; rows sum "
            f"within {sum_err:.3e} of "
            + ("the contributions" if kind == "interactions" else
               "K1's margins")
            + f"; {hn} row(s) against the host recursion "
            + (f"(first {ht} trees) " if ht else "")
            + f"{host_err:.3e} apart ({plain_s:.2f} s of host)")
    out["k1"] = read_counts()
    return out["k1"], out


def shap_higgs(xt, dev, X, y, cov_raw, cov_rows):
    """The ``shap_higgs`` phase: a 100-tree depth-8 forest trained at the
    HIGGS shape, explained on held-out rows (contributions 10,000,
    interactions 1,000, Saabas 100,000) through ``shap_forest``, then
    the Covertype categorical dart forest (7 groups) at 1,000 rows.
    Returns (launch counts, results)."""
    n_tr = 1_000_000
    dtr = xt.DMatrix(X[:n_tr], label=y[:n_tr])
    bst, c = train_launches("shap forest", lambda: xt.train(
        HIGGS_PARAMS, dtr, SHAP_ROUNDS, verbose_eval=False))
    runs = [c]
    k1, higgs = shap_forest(xt, f"HIGGS {SHAP_ROUNDS} trees depth 8", bst,
                            X[n_tr:], SHAP_ROWS, SHAP_HOST)
    runs.append(k1)
    cov = xt.Booster(model_file=cov_raw)
    rows = {k: SHAP_COV_ROWS for k in SHAP_ROWS}
    k1, covdart = shap_forest(
        xt, f"Covertype dart ({len(cov.gbm.trees)} trees, 7 groups)", cov,
        cov_rows, rows, SHAP_COV_HOST,
        dict(feature_types=COVDART_TYPES, enable_categorical=True))
    runs.append(k1)
    return runs, {"higgs": higgs, "covdart": covdart}


def sklearn_cv_cli(xt, dev, X, y, Xc, yc, tmp):
    """The ``sklearn_cv_cli`` phase: ``XGBClassifier`` on the Covertype
    shape with an eval set and early stopping against ``xt.train`` from
    the parameters it maps (one sha256), ``XGBRegressor(booster=
    "gblinear")``'s ``coef_`` / ``intercept_``, ``xt.cv`` 5 folds at the
    HIGGS shape, and the CLI with the mushroom demo's settings on
    ``agaricus_like``'s files (train in this process and as ``python -m
    xgboost_tpu_torch``, the two models and ``xt.train``'s the same
    bytes; dump; pred). Returns (launch counts, results)."""
    from xgboost_tpu_torch import sklearn as xsk
    from xgboost_tpu_torch.cli import main as cli_main
    from xgboost_tpu_torch.cli import parse_config_file
    from xgboost_tpu_torch.testing import write_mushroom_conf

    card = gpu_line()
    log(f"sklearn_cv_cli ({card}): scikit-learn importable: "
        f"{xsk._SKLEARN}")
    runs, out = [], {}
    n_cov = sum(COVTYPE_CLASS_COUNTS)
    Xtr, ytr = Xc[:n_cov], yc[:n_cov].astype(np.int64)
    Xte, yte = Xc[n_cov:], yc[n_cov:].astype(np.int64)
    params = {k: v for k, v in COVTYPE_PARAMS.items()
              if k not in ("objective", "num_class", "eval_metric")}
    clf = xt.XGBClassifier(n_estimators=SK_ROUNDS,
                           early_stopping_rounds=SK_EARLY_STOP,
                           eval_metric="mlogloss", **params)
    _, c = train_launches("XGBClassifier Covertype", lambda: clf.fit(
        Xtr, ytr, eval_set=[(Xte, yte)], verbose=False))
    runs.append(c)
    mapped = dict(clf.get_xgb_params(), eval_metric="mlogloss")
    dtr = xt.DMatrix(Xtr, label=ytr.astype(np.float32))
    dte = xt.DMatrix(Xte, label=yte.astype(np.float32))
    bst, c = train_launches("xt.train as XGBClassifier maps it", lambda:
                            xt.train(mapped, dtr, SK_ROUNDS,
                                     evals=[(dte, "validation_0")],
                                     early_stopping_rounds=SK_EARLY_STOP,
                                     verbose_eval=False))
    runs.append(c)
    d_clf = hashlib.sha256(bytes(clf.get_booster().save_raw(
        "ubj"))).hexdigest()
    d_train = hashlib.sha256(bytes(bst.save_raw("ubj"))).hexdigest()
    if d_clf != d_train or mapped.get("num_class") != 7:
        raise AssertionError(f"XGBClassifier {d_clf} != xt.train "
                             f"{d_train} ({mapped})")
    acc = clf.score(Xte, yte)
    proba = clf.predict_proba(Xte[:1000])
    if proba.shape != (1000, 7) or not np.allclose(proba.sum(1), 1,
                                                   atol=1e-5):
        raise AssertionError(f"predict_proba {proba.shape}")
    out["classifier"] = dict(digest=d_clf, acc=acc,
                             best=clf.best_iteration)
    log(f"XGBClassifier Covertype ({card}): sha256 {d_clf} equal to "
        f"xt.train's; best iteration {clf.best_iteration}, held-out "
        f"accuracy {acc:.6f}, K4 {c['hist_scan']} in {SK_ROUNDS} rounds")
    # a linear regressor's coefficients
    target = X[:1_000_000] @ np.linspace(-1, 1, 28).astype(np.float32)
    reg = xt.XGBRegressor(booster="gblinear", n_estimators=10,
                          reg_lambda=1.0)
    reg.fit(X[:1_000_000], target)
    coef, icpt = reg.coef_, reg.intercept_
    if coef.shape != (28,) or icpt.shape != (1,) or \
            not np.array_equal(coef, reg.get_booster().gbm.W.cpu().numpy()
                               [:, 0]):
        raise AssertionError(f"XGBRegressor gblinear coef_ {coef.shape}")
    out["regressor"] = dict(coef0=float(coef[0]), coef27=float(coef[-1]),
                            intercept=float(icpt[0]))
    log(f"XGBRegressor(booster='gblinear') ({card}): coef_[0] "
        f"{coef[0]:.6f}, coef_[27] {coef[-1]:.6f} (rule -1 and 1), "
        f"intercept_ {icpt[0]:.6f}")
    # 5-fold cross-validation at the HIGGS shape
    dall = xt.DMatrix(X[:1_000_000], label=y[:1_000_000])
    t0 = time.perf_counter()
    hist, c = train_launches("cv 5 folds", lambda: xt.cv(
        HIGGS_PARAMS, dall, CV_ROUNDS, nfold=CV_FOLDS,
        metrics=["auc", "logloss"], seed=0, as_pandas=False))
    cv_s = time.perf_counter() - t0
    runs.append(c)
    if c["hist_scan"] != 8 * CV_ROUNDS * CV_FOLDS or \
            len(hist["test-auc-mean"]) != CV_ROUNDS or \
            not hist["test-auc-mean"][-1] > 0.8:
        raise AssertionError(f"cv: {c}, {hist.get('test-auc-mean')}")
    out["cv"] = dict(auc=hist["test-auc-mean"][-1],
                     std=hist["test-auc-std"][-1], s=cv_s)
    log(f"cv ({card}): {CV_FOLDS} folds of 1,000,000 rows, "
        f"{CV_ROUNDS} rounds in {cv_s:.3f} s (host clock); test AUC mean "
        f"{hist['test-auc-mean'][-1]:.6f} std {hist['test-auc-std'][-1]:.6f}"
        f", logloss mean {hist['test-logloss-mean'][-1]:.6f}; K4 "
        f"{c['hist_scan']}")
    del dall
    # the CLI with the mushroom demo's settings
    train, test = agaricus_like(seed=16, directory=tmp)
    conf = os.path.join(tmp, "mushroom.conf")
    write_mushroom_conf(conf, train, test)
    model = os.path.join(tmp, "cli.model")
    _, c = train_launches("CLI train", lambda: cli_main(
        [conf, f"model_out={model}"]))
    runs.append(c)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch", conf,
                        f"model_out={model}.sub", "silent=1"],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    sub_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"python -m xgboost_tpu_torch: {r.stderr}")
    params = {k: v for k, v in parse_config_file(conf)
              if k in ("booster", "objective", "eta", "gamma",
                       "min_child_weight", "max_depth")}
    ref = xt.train(params, xt.DMatrix(train + "?format=libsvm"), 2,
                   verbose_eval=False)
    with open(model, "rb") as fh:
        in_proc = fh.read()
    with open(model + ".sub", "rb") as fh:
        sub = fh.read()
    if not in_proc == sub == bytes(ref.save_raw("json")):
        raise AssertionError("the CLI's models differ from xt.train's")
    dump = os.path.join(tmp, "dump.txt")
    pred = os.path.join(tmp, "pred.txt")
    cli_main([conf, "task=dump", f"model_in={model}", f"name_dump={dump}",
              "dump_stats=1"])
    _, c = train_launches("CLI pred", lambda: cli_main(
        [conf, "task=pred", f"model_in={model}", f"name_pred={pred}"]))
    runs.append(c)
    with open(dump) as fh:
        dumped = fh.read()
    preds = np.loadtxt(pred)
    want = ref.predict(xt.DMatrix(test + "?format=libsvm"))
    if dumped.count("booster[") != 2 or preds.shape != want.shape or \
            np.abs(preds - want).max() > 1e-6 or c["walk_packed"] != 1:
        raise AssertionError(f"CLI dump / pred: {dumped[:80]!r}, "
                             f"{preds.shape}, {c}")
    err = float(np.mean((preds > 0.5) != xt.DMatrix(
        test + "?format=libsvm").get_label()))
    out["cli"] = dict(digest=hashlib.sha256(in_proc).hexdigest(),
                      error=err, sub_s=sub_s)
    log(f"CLI ({card}): mushroom.conf settings on {AGARICUS_TRAIN_ROWS} + "
        f"{AGARICUS_TEST_ROWS} rows; train in this process and as python "
        f"-m xgboost_tpu_torch ({sub_s:.2f} s), model sha256 "
        f"{out['cli']['digest']} equal to xt.train's; dump 2 trees; pred "
        f"held-out error {err:.6f} (K1 once)")
    return runs, out


SS_SIZES = (1, 8, 64, 512)      # the serving phase's request sizes
SS_REQUESTS = 200
SS_ALONE = 25            # requests of 1 and of 512 rows from one client
SS_THREADS = 4
SS_CONTRIB_ROWS = 1_000
SS_JSONL_LINES = 50
SS_NAN_SHARE = 0.01
SS_NAN_ROUNDS = 3
SS_BATCH_ROUNDS = 8
SS_PARSE_ROWS = 1_000_000
SS_SHAP_TOL = 1e-12      # tests/test_torch_shap.py F64_TOL
SS_SUM_TOL = 1e-5        # tests/test_torch_shap.py SUM_TOL


def http_call(port, path, obj=None):
    """One call to the HTTP front end on 127.0.0.1 -> (status, the JSON
    or text answer, seconds on the host clock)."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    dt = time.perf_counter() - t0
    try:
        return code, json.loads(body), dt
    except json.JSONDecodeError:
        return code, body, dt


def prometheus_samples(text):
    """{(name, labels): value} of a Prometheus text exposition; raises on
    a line that is neither a comment nor a sample."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)",
                         line)
        if m is None:
            raise AssertionError(f"not a Prometheus sample: {line!r}")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def http_client(port, jobs, start_at):
    """One client process's share of the HTTP requests (its own
    interpreter, so the load does not share the server's GIL): waits for
    ``start_at`` (``time.time()``), then sends ``jobs`` [(id, rows)] in
    order -> ([(id, status, answer, seconds)], the time it finished)."""
    time.sleep(max(0.0, start_at - time.time()))
    out = [(i, *http_call(port, "/v1/predict",
                          {"data": rows, "model": "higgs", "id": i}))
           for i, rows in jobs]
    return out, time.time()


# the serving phase's Python-parser process: writes the agaricus-width
# libsvm file (argv[1], argv[2] rows) and saves what the Python parser
# reads from it, with its seconds, to the npz argv[3]
PY_PARSE = r"""
import sys, time
import numpy as np
from xgboost_tpu_torch.data import fileio
from xgboost_tpu_torch.testing import agaricus_rows, write_libsvm
path, n, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
write_libsvm(path, *agaricus_rows(n, seed=8))
t0 = time.perf_counter()
ref = fileio._parse_python(path, False, ",")
seconds = time.perf_counter() - t0
np.savez(out, seconds=seconds, columns=ref[5],
         none=np.array([a is None for a in ref[:5]]),
         **{f"a{k}": (np.zeros(0) if a is None else np.asarray(a))
            for k, a in enumerate(ref[:5])})
"""


def serving_stack(xt, dev, raw, booster, Xbig, pred, X, y, tmp):
    """The ``serving_stack`` phase: the HTTP front end over a 2-replica
    ``FleetRouter`` on the card (``POST /v1/predict`` from 4 threads, each
    answer equal to ``Booster.predict`` bit for bit; the contribs route
    against ``Booster.predict(pred_contribs=True)``; a swap, a rollback
    and a drained removal under load with no request failing; the GET
    routes parsed and their counters against the requests sent), the
    jsonl loop as ``python -m xgboost_tpu_torch serve`` (each answer equal
    to its HTTP twin), ``XTPU_NAN_POLICY`` at the HIGGS shape,
    ``update_batch`` against sequential ``update`` calls, and the native
    text parser against the Python one on a 1,000,000-row libsvm file.
    Returns (the main-path runs' launch counts, a summary)."""
    from xgboost_tpu_torch.data import fileio
    from xgboost_tpu_torch.ops.cuda import build
    from xgboost_tpu_torch.serve import (FleetConfig, FleetRouter,
                                         ServeConfig, Server)
    from xgboost_tpu_torch.serve.frontend import make_http_server
    from xgboost_tpu_torch.testing import make_forest_model

    card = gpu_line()
    runs, out = [], {}
    n_big = Xbig.shape[0]

    def place(i):
        """Request i's rows: (first row, rows)."""
        n = SS_SIZES[i % len(SS_SIZES)]
        return (i * 977) % (n_big - n), n

    def request(i):
        lo, n = place(i)
        return lo, n, http_call(port, "/v1/predict", {
            "data": Xbig[lo:lo + n].tolist(), "model": "higgs", "id": i})

    def check(answers, oracles, label):
        for k, a in enumerate(answers):
            if a is None:
                raise AssertionError(f"{label}: request {k} got no answer")
            lo, n, (code, body, _) = a
            if code != 200:
                raise AssertionError(f"{label}: request {k} failed with "
                                     f"{code}: {body}")
            want = oracles[body["version"]][lo:lo + n]
            got = np.asarray(body["predictions"], np.float32)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{label}: request {k} ({n} rows at {lo}, version "
                    f"{body['version']}) differs from Booster.predict")

    raw2 = make_forest_model(500, 8, 28, seed=1)
    pred2 = xt.Booster(model_file=raw2).predict(xt.DMatrix(Xbig))
    oracles = {1: pred, 2: pred2}
    fl = FleetRouter(models={"higgs": raw}, device="cuda", config=FleetConfig(
        replicas=2, min_replicas=1, max_replicas=2, replication=2,
        autoscale_interval_s=0, serve=ServeConfig(max_batch=512)))
    fl.warmup()
    httpd = make_http_server(fl, 0)
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever,
                                     daemon=True)
    server_thread.start()
    sent = {"predict": 0, "contribs": 0}
    try:
        # -- 1. POST /v1/predict: 200 requests of 1/8/64/512 rows from 4
        # client processes, then 25 of 1 and of 512 rows from one, in turn
        import multiprocessing

        def jobs(ids):
            return [(i, Xbig[lo:lo + n].tolist())
                    for i, (lo, n) in ((i, place(i)) for i in ids)]

        shares = [jobs(range(t, SS_REQUESTS, SS_THREADS))
                  for t in range(SS_THREADS)]
        alone = jobs([SS_REQUESTS + 4 * k + s for k in range(SS_ALONE)
                      for s in (0, 3)])        # 1 and 512 rows in turn
        def run_load(pool, port_, label):
            """The 200 requests from 4 client processes against the front
            end on ``port_``, each answer checked -> (req/s, {rows: (p50,
            p99) ms})."""
            start = time.time() + 1.0
            done = pool.starmap(http_client, [(port_, share, start)
                                              for share in shares])
            wall = max(t for _, t in done) - start
            answers = [None] * SS_REQUESTS
            for got, _ in done:
                for i, code, body, dt in got:
                    answers[i] = (*place(i), (code, body, dt))
            check(answers, oracles, label)
            lat = {}
            for n in SS_SIZES:
                ts = np.array([a[2][2] for a in answers if a[1] == n]) * 1e3
                lat[n] = (float(np.percentile(ts, 50)),
                          float(np.percentile(ts, 99)))
            return SS_REQUESTS / wall, lat

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(SS_THREADS) as pool:
            pool.starmap(http_client, [(port, [], 0.0)] * SS_THREADS)
            reset_counts()
            rate, lat = run_load(pool, port, "HTTP predict")
            torch.cuda.synchronize()
            c_http = read_counts()
            (lone, _), = pool.starmap(http_client, [(port, alone, 0.0)])
            # the same load through one Server behind the same front end,
            # in turn with the fleet: what the second replica buys
            one = Server(models={"higgs": raw}, device="cuda",
                         config=ServeConfig(max_batch=512))
            one.warmup()
            httpd1 = make_http_server(one, 0)
            thread1 = threading.Thread(target=httpd1.serve_forever,
                                       daemon=True)
            thread1.start()
            versus = {"fleet": [(rate, dict(lat))], "one": []}
            try:
                for who in ("one", "fleet", "one"):
                    p_ = httpd1.server_address[1] if who == "one" else port
                    versus[who].append(run_load(
                        pool, p_, f"HTTP predict ({who})"))
            finally:
                httpd1.shutdown()
                httpd1.server_close()
                thread1.join(timeout=60)
                one.close()
        runs.append(c_http)
        sent["predict"] += 2 * SS_REQUESTS + len(alone)
        if c_http["walk_packed"] < 1 or \
                c_http["walk_spread"] != c_http["walk_packed"] or \
                any(v for k, v in c_http.items() if not k.startswith("walk")):
            raise AssertionError(f"the HTTP front end launched {c_http}, "
                                 "expected K1 on the spread schedule only")
        check([(*place(i), (code, body, dt)) for i, code, body, dt in lone],
              oracles, "HTTP predict, one client")
        for n in (1, 512):
            ts = np.array([dt for i, _, _, dt in lone
                           if place(i)[1] == n]) * 1e3
            lat[f"{n} alone"] = (float(np.percentile(ts, 50)),
                                 float(np.percentile(ts, 99)))
        out["latency_ms"] = lat
        out["http_req_per_s"] = rate
        out["fleet_vs_one"] = versus
        log(f"serving_stack: {SS_REQUESTS} POST /v1/predict of {SS_SIZES} "
            f"rows from {SS_THREADS} client processes through a 2-replica "
            f"fleet at {rate:.1f} req/s, then "
            f"{len(alone)} from one client (1 and 512 rows in turn); K1 "
            f"launches {c_http['walk_packed']} (all spread); every answer "
            f"equal to Booster.predict bit for bit; client latency (host "
            f"clock, HTTP and JSON included) p50 / p99: "
            + ", ".join(f"{n} rows {v[0]:.3f} / {v[1]:.3f} ms"
                        for n, v in lat.items()) + f" [{card}]")
        names = {"fleet": "2-replica fleet", "one": "one Server"}
        log("serving_stack: the same load through a 2-replica fleet and "
            "through one Server behind the same front end, in turn "
            "(fleet, one, fleet, one): " + "; ".join(
                f"{names[who]} run {k + 1}: {r:.1f} req/s, p50 / p99 "
                f"1 row {v[1][0]:.3f} / {v[1][1]:.3f} ms, 512 rows "
                f"{v[512][0]:.3f} / {v[512][1]:.3f} ms"
                for who in ("fleet", "one")
                for k, (r, v) in enumerate(versus[who])) + f" [{card}]")

        # -- 2. POST /v1/model/higgs/contribs on 1,000 rows
        Xc = Xbig[:SS_CONTRIB_ROWS]
        fl.warmup_contribs()               # each replica's path tables
        dmc = xt.DMatrix(Xc)
        booster.predict(xt.DMatrix(Xc[:1]), pred_contribs=True)
        torch.cuda.synchronize()
        code, body, t_route = http_call(port, "/v1/model/higgs/contribs",
                                        {"data": Xc.tolist()})
        sent["contribs"] += 1
        if code != 200:
            raise AssertionError(f"contribs route failed: {code} {body}")
        phi = np.asarray(body["contribs"], np.float32)
        t0 = time.perf_counter()
        want = booster.predict(dmc, pred_contribs=True)
        torch.cuda.synchronize()
        t_pred = time.perf_counter() - t0
        margin = booster.predict(dmc, output_margin=True)
        if phi.shape != want.shape or phi.shape != (SS_CONTRIB_ROWS, 29):
            raise AssertionError(f"contribs shape {phi.shape} / "
                                 f"{want.shape}")
        err = float(np.abs(phi.astype(np.float64) - want).max())
        sum_err = float(np.abs(phi.astype(np.float64).sum(axis=1)
                               - margin).max())
        if err > SS_SHAP_TOL or sum_err > SS_SUM_TOL:
            raise AssertionError(f"contribs route: {err} from "
                                 f"Booster.predict, rows {sum_err} from "
                                 "their margins")
        out["contribs_rows_per_s"] = (SS_CONTRIB_ROWS / t_route,
                                      SS_CONTRIB_ROWS / t_pred)
        log(f"serving_stack: contribs route on {SS_CONTRIB_ROWS} rows in "
            f"{t_route:.4f} s = {SS_CONTRIB_ROWS / t_route:.1f} rows/s "
            f"(HTTP and JSON included) against Booster.predict("
            f"pred_contribs=True) {t_pred:.4f} s = "
            f"{SS_CONTRIB_ROWS / t_pred:.1f} rows/s (host clock); max "
            f"|route - predict| {err}, rows - margin {sum_err} [{card}]")

        # -- 3. swap to version 2, roll back, remove a replica: under load
        load = []
        stop = threading.Event()

        def loader(tid):
            i = 1000 + tid
            while not stop.is_set():
                load.append(request(i))
                i += SS_THREADS

        victim = fl.placement("higgs")[0]
        victim_srv = dict(zip(fl.replica_names(), fl.replicas()))[victim]
        reset_counts()
        threads = [threading.Thread(target=loader, args=(t,))
                   for t in range(SS_THREADS)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        fl.swap_model("higgs", raw2)
        v2 = fl.predict(Xbig[:4], "higgs")
        sent["predict"] += 1
        time.sleep(0.3)
        back = fl.rollback_model("higgs")
        time.sleep(0.3)
        fl.remove_replica(victim, drain=True)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        c_load = read_counts()
        runs.append(c_load)
        sent["predict"] += len(load)
        if v2.version != 2 or not np.array_equal(v2, pred2[:4]) or \
                back.version != 1:
            raise AssertionError("the swap or the rollback did not take")
        check(load, oracles, "under load")
        versions = sorted({a[2][1]["version"] for a in load})
        if fl.n_replicas != 1 or victim in fl.replica_names():
            raise AssertionError("the replica was not removed")
        log(f"serving_stack: {len(load)} requests under a swap to version "
            f"2, a rollback and a drained removal of replica {victim}: none "
            f"failed, versions answered {versions}, each equal to its "
            f"version's Booster.predict bit for bit; K1 launches "
            f"{c_load['walk_packed']}")

        # -- 4. the GET routes and their counters
        code_h, health, _ = http_call(port, "/healthz")
        code_m, snap, _ = http_call(port, "/v1/metrics")
        code_p, text, _ = http_call(port, "/metrics")
        code_l, models, _ = http_call(port, "/v1/models")
        code_r, report, _ = http_call(port, "/v1/model/higgs/report")
        from xgboost_tpu_torch.obs.insight import model_inspect

        live = fl.registry.get("higgs")
        want_report = json.loads(json.dumps(dict(
            model_inspect(live.booster), name="higgs",
            version=live.version)))
        if (code_h, code_m, code_p, code_l, code_r) != \
                (200, 200, 200, 200, 200) or health["status"] != "ok" \
                or health["n_replicas"] != 1 \
                or models != [{"name": "higgs", "version": 1,
                               "n_features": 28, "n_groups": 1,
                               "n_trees": len(booster.gbm.trees)}] \
                or report != want_report:
            raise AssertionError(f"GET routes: {code_h} {health}; {code_m}; "
                                 f"{code_p}; {code_l} {models}; {code_r} "
                                 f"{report}")
        samples = prometheus_samples(text)
        routed = snap["fleet"]["routed"]
        gone = victim_srv.metrics.get_many(("requests",))["requests"]
        served = snap["counters"]["requests"] + gone
        prom_req = sum(v for (k, lab), v in samples.items()
                       if k == "xtpu_serve_requests_total"
                       and 'replica="' in lab)   # the fleet's servers
        prom_routed = samples[("xtpu_fleet_routed_total", "")]
        total = sent["predict"] + sent["contribs"]
        if not (routed == prom_routed == total
                and served == prom_req == sent["predict"]
                and snap["counters"].get("errors", 0) == 0):
            raise AssertionError(
                f"counters: routed {routed} / {prom_routed}, served "
                f"{served} / {prom_req}, sent {sent}, errors "
                f"{snap['counters'].get('errors')}")
        log(f"serving_stack: /healthz, /v1/metrics, /metrics ("
            f"{len(samples)} samples), /v1/models parse; /report 200, the "
            f"served version's model_inspect; routed {routed} = sent "
            f"{total}, serve requests "
            f"{served} = predict requests sent {sent['predict']}")

        # -- 8's Python half, beside sections 5-7: the 1,000,000-row
        # libsvm file written and read by the Python parser in a process
        # of its own
        big = os.path.join(tmp, "agaricus_1m.txt")
        py_parse = spawn_python(tmp, "py_parse", "-c", PY_PARSE, big,
                                str(SS_PARSE_ROWS),
                                os.path.join(tmp, "py_parse.npz"))

        # -- 5. the jsonl loop as python -m xgboost_tpu_torch serve
        path = os.path.join(tmp, "higgs.json")
        with open(path, "wb") as fh:
            fh.write(bytes(raw))
        reqs = [(i, SS_SIZES[i % len(SS_SIZES)], (i * 131) % (n_big - 512))
                for i in range(SS_JSONL_LINES)]
        lines = "".join(json.dumps({"data": Xbig[lo:lo + n].tolist(),
                                    "id": i}) + "\n" for i, n, lo in reqs)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "xgboost_tpu_torch", "serve",
             f"model={path}"], input=lines, capture_output=True, text=True,
            timeout=600, env=env, cwd=repo)
        t_jsonl = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"serve subprocess exit "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        got = [json.loads(x) for x in proc.stdout.splitlines()]
        twins = [http_call(port, "/v1/predict", {
            "data": Xbig[lo:lo + n].tolist(), "id": i}) for i, n, lo in reqs]
        sent["predict"] += len(reqs)
        for (i, n, lo), g, (code, tw, _) in zip(reqs, got, twins):
            if code != 200 or g["id"] != i or g["version"] != tw["version"] \
                    or g["predictions"] != tw["predictions"] \
                    or not np.array_equal(np.asarray(g["predictions"],
                                                     np.float32),
                                          pred[lo:lo + n]):
                raise AssertionError(f"jsonl line {i} differs from its "
                                     "HTTP twin")
        if len(got) != SS_JSONL_LINES:
            raise AssertionError(f"jsonl: {len(got)} answers")
        log(f"serving_stack: python -m xgboost_tpu_torch serve answered "
            f"{SS_JSONL_LINES} jsonl lines in {t_jsonl:.2f} s (process "
            f"start, model load and warmup included), each equal to its "
            f"HTTP twin")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server_thread.join(timeout=60)
        fl.close()

    # -- 6. XTPU_NAN_POLICY at the HIGGS shape, 1% NaN labels
    rng = np.random.RandomState(17)
    y_nan = y[:HIGGS_TRAIN].copy()
    bad = rng.rand(len(y_nan)) < SS_NAN_SHARE
    y_nan[bad] = np.nan
    dnan = xt.DMatrix(X[:HIGGS_TRAIN], label=y_nan)
    p = dict(HIGGS_PARAMS, base_score=0.5)
    kept = os.environ.get("XTPU_NAN_POLICY")
    try:
        os.environ["XTPU_NAN_POLICY"] = "raise"
        bst = xt.Booster(p)
        try:
            bst.update(dnan, 0)
        except xt.NumericalDivergence as e:
            if e.bad_rows != int(bad.sum()) or bst.num_boosted_rounds():
                raise AssertionError(f"raise: {e.bad_rows} rows, "
                                     f"{bst.num_boosted_rounds()} rounds")
            raised = e.bad_rows
        else:
            raise AssertionError("XTPU_NAN_POLICY=raise did not raise")
        res = {}
        for pol in ("zero", "off"):
            os.environ["XTPU_NAN_POLICY"] = pol
            t0 = time.perf_counter()
            b, c = train_launches(f"nan policy {pol}", lambda: xt.train(
                p, dnan, SS_NAN_ROUNDS, verbose_eval=False))
            res[pol] = (time.perf_counter() - t0, b)
            runs.append(c)
            if b.num_boosted_rounds() != SS_NAN_ROUNDS or \
                    c["hist_scan"] != 8 * SS_NAN_ROUNDS:
                raise AssertionError(f"{pol}: {b.num_boosted_rounds()} "
                                     f"rounds, launches {c}")
        zero_pred = res["zero"][1].predict(xt.DMatrix(X[HIGGS_TRAIN:]))
        if not np.isfinite(zero_pred).all():
            raise AssertionError("zero: the model predicts non-finite")
        off_pred = res["off"][1].predict(xt.DMatrix(X[HIGGS_TRAIN:HIGGS_TRAIN + 100]))
    finally:
        if kept is None:
            os.environ.pop("XTPU_NAN_POLICY", None)
        else:
            os.environ["XTPU_NAN_POLICY"] = kept
    out["nan"] = {"raised_rows": raised,
                  "zero_s": res["zero"][0], "off_s": res["off"][0]}
    log(f"serving_stack: XTPU_NAN_POLICY on {HIGGS_TRAIN} x 28 with "
        f"{int(bad.sum())} NaN labels: raise named {raised} rows at round "
        f"0 with no tree committed; zero trained {SS_NAN_ROUNDS} rounds in "
        f"{res['zero'][0]:.3f} s, held-out predictions finite; off trained "
        f"{SS_NAN_ROUNDS} rounds in {res['off'][0]:.3f} s (predictions "
        f"finite: {bool(np.isfinite(off_pred).all())})")

    # -- 7. update_batch against sequential update at the HIGGS shape
    dtr = xt.DMatrix(X[:HIGGS_TRAIN], label=y[:HIGGS_TRAIN])
    a = xt.Booster(dict(HIGGS_PARAMS))
    ok, c_batch = train_launches("update_batch", lambda: a.update_batch(
        dtr, range(SS_BATCH_ROUNDS)))
    b = xt.Booster(dict(HIGGS_PARAMS))
    _, c_seq = train_launches("update x 8", lambda: [
        b.update(dtr, i) for i in range(SS_BATCH_ROUNDS)])
    runs += [c_batch, c_seq]
    if not ok or saved_bytes(a) != saved_bytes(b) or \
            c_batch["hist_scan"] != 8 * SS_BATCH_ROUNDS:
        raise AssertionError(f"update_batch: {ok}, launches {c_batch}, "
                             f"bytes equal {saved_bytes(a) == saved_bytes(b)}")
    log(f"serving_stack: update_batch of {SS_BATCH_ROUNDS} rounds saved "
        f"the bytes of {SS_BATCH_ROUNDS} update calls (sha256 "
        f"{hashlib.sha256(saved_bytes(a)).hexdigest()[:16]}...; K4 "
        f"{c_batch['hist_scan']})")

    # -- 8. the native text parser on a 1,000,000-row libsvm file, against
    # the Python parser's arrays of the same file (from its own process)
    rc, _, err = finish_module(py_parse, timeout=900)
    if rc != 0:
        raise AssertionError(f"the Python parser's process: exit {rc}: "
                             f"{err[-2000:]}")
    with np.load(os.path.join(tmp, "py_parse.npz")) as z:
        ref = tuple(None if z["none"][k] else z[f"a{k}"] for k in range(5)) \
            + (int(z["columns"]),)
        t_py = float(z["seconds"])
    build.load_host("text_parser")
    t0 = time.perf_counter()
    nat = fileio._parse_native(big, False, ",")
    t_nat = time.perf_counter() - t0
    for k, (u, v) in enumerate(zip(nat[:5], ref[:5])):
        if (u is None) != (v is None) or (
                u is not None and not np.array_equal(u, v)):
            raise AssertionError(f"native parse differs in array {k}")
    if nat[5] != ref[5] or len(nat[0]) != SS_PARSE_ROWS + 1:
        raise AssertionError("native parse: columns or rows differ")
    out["parse_rows_per_s"] = (SS_PARSE_ROWS / t_nat, SS_PARSE_ROWS / t_py)
    log(f"serving_stack: {SS_PARSE_ROWS}-row libsvm file "
        f"({os.path.getsize(big) / 1e6:.1f} MB, agaricus widths): native "
        f"parser {t_nat:.4f} s = {SS_PARSE_ROWS / t_nat:.1f} rows/s, "
        f"Python parser {t_py:.4f} s = {SS_PARSE_ROWS / t_py:.1f} rows/s "
        f"(host clock, in its own process beside sections 5-7), the same "
        f"arrays [{card}]")
    os.remove(big)
    return runs, out


# ---- row-split distributed training (ROADMAP A.8, first half) --------------

DIST_ROWS = 1_000_000
DIST_TEST_ROWS = 100_000
DIST_SHARDS = 4
DIST_ROUNDS = 3
DIST_LG_ROUNDS = 2
DIST_MM_SHARDS = 2
DIST_MM_ROUNDS = 2
DIST_PAGES = 4               # the first pages of ``higgs_batches``' stream
DIST_PAGED_ROUNDS = 2
# a logistic gradient's |g| <= 1 and h <= 1/4: the int8x2 quanta (q_g, q_h)
# of any round bound those of the round's own scale
LOGISTIC_QUANTA = (1.0 / 32512.0, 0.25 / 32512.0)

DIST_WORKER = r'''
import hashlib, json, os, sys, time
root, rank, world, init, out = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as c
import xgboost_tpu_torch as xt
from xgboost_tpu_torch.parallel import launch
launch.init_distributed(init, world, rank, backend="gloo")
X, y = c.higgs_like(c.DIST_ROWS + c.DIST_TEST_ROWS, 28, seed=0)
m = c.DIST_ROWS // world
sl = slice(rank * m, (rank + 1) * m)
params = dict(c.HIGGS_PARAMS, base_score=0.5)
from xgboost_tpu_torch.callback import TrainingCallback
marks = []


class Marks(TrainingCallback):
    """The collective's host seconds so far at every round boundary."""

    def before_iteration(self, model, epoch, evals_log):
        marks.append(comm.seconds)
        return False

    def after_training(self, model):
        marks.append(comm.seconds)
        return model


with launch.CommunicatorContext() as comm:
    c.reset_counts()
    clock = c.RoundClock()
    t0 = time.perf_counter()
    bst = launch.train_per_host(params, X[sl], y[sl], c.DIST_ROUNDS,
                                verbose_eval=False,
                                callbacks=[clock.callback, Marks()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = c.read_counts()
    raw = bytes(bst.save_raw("ubj"))
with open(out + ".ubj", "wb") as fh:
    fh.write(raw)
json.dump({"rank": rank, "sha": hashlib.sha256(raw).hexdigest(),
           "s_round": clock.seconds(), "wall": wall,
           "collective_s": comm.seconds, "setup_collective_s": marks[0],
           "round_collective_s": [b - a for a, b in zip(marks, marks[1:])],
           "counts": counts}, open(out, "w"))
torch.distributed.destroy_process_group()
'''


def round_by_round(xt, label, params, mesh_params, one, X, y, rounds,
                   capped=False, vector=False):
    """Each round grown twice from ``one``'s margin before it
    (``base_margin``; round 0 from the intercept): with ``params`` on one
    device and with ``mesh_params`` on the mesh, so that the two trees
    grow from the same gradients and only their histograms' f32 sums
    differ (as :func:`card_against_cpu` holds the card against the CPU);
    held under :func:`certified_trees` (vector leaves:
    :func:`vector_trees_agree`), and each round's predictions from that
    margin at rtol 1e-5 + atol 1e-5 (vector leaves: atol 1e-4, their
    leaves' rule) where no near tie moved rows. Returns
    (trees the same in full, near-tie nodes by tree, largest leaf gap,
    largest prediction gap)."""
    full, ties, gap, pred_gap = 0, {}, 0.0, 0.0
    per = len(one.gbm.trees) // rounds
    tp = one.tree_param
    dm = xt.DMatrix(X, label=y)
    for r in range(rounds):
        if r:
            dm.set_base_margin(one.predict(
                xt.DMatrix(X), output_margin=True, strict_shape=True,
                iteration_range=(0, r)))
        ref = xt.train(params, dm, 1, verbose_eval=False)
        again = xt.train(mesh_params, dm, 1, verbose_eval=False)
        rows = None if vector else leaf_rows(ref, X)
        tied = False
        for k in range(per):
            a, b = again.gbm.trees[k], ref.gbm.trees[k]
            name = f"{label} round {r} tree {k}"
            if vector:
                tie, g = vector_trees_agree(a, b, name, tp.eta,
                                            tp.reg_lambda)
            else:
                tie, g, _ = certified_trees(a, b, name, tp.eta,
                                            tp.reg_lambda, LOGISTIC_QUANTA,
                                            rows[k], capped=capped)
            gap = max(gap, g)
            if tie:
                ties[r * per + k] = tie
                tied = True
            else:
                full += 1
        if not tied:
            # vector leaves: the leaves' own rule, atol 1e-4
            pa, pb = again.predict(dm), ref.predict(dm)
            if not np.allclose(pa, pb, rtol=1e-5,
                               atol=1e-4 if vector else 1e-5):
                raise AssertionError(f"{label} round {r}: predictions from "
                                     f"one margin differ by "
                                     f"{np.abs(pa - pb).max()}")
            pred_gap = max(pred_gap, float(np.abs(pa - pb).max()))
    return full, ties, gap, pred_gap


def leaf_rows(bst, X):
    """Each tree's {leaf: rows} of ``X`` under ``bst`` (``pred_leaf``)."""
    import xgboost_tpu_torch as xt

    leaves = bst.predict(xt.DMatrix(X), pred_leaf=True)
    out = []
    for t in range(leaves.shape[1]):
        idx, n = np.unique(leaves[:, t], return_counts=True)
        out.append(dict(zip(idx.tolist(), n.tolist())))
    return out


def certify_forest(a, b, label, rows, capped=False):
    """Every tree of ``a`` against ``b``'s under :func:`certified_trees`
    (``rows``: :func:`leaf_rows` of ``b``; the logistic quanta bound).
    Returns (trees the same in full, near-tie nodes by tree, largest leaf
    gap)."""
    tp = b.tree_param
    if len(a.gbm.trees) != len(b.gbm.trees):
        raise AssertionError(f"{label}: {len(a.gbm.trees)} trees against "
                             f"{len(b.gbm.trees)}")
    full, ties, gap = 0, {}, 0.0
    for t, (ta, tb) in enumerate(zip(a.gbm.trees, b.gbm.trees)):
        tie, g, _ = certified_trees(ta, tb, f"{label} tree {t}", tp.eta,
                                    tp.reg_lambda, LOGISTIC_QUANTA, rows[t],
                                    capped=capped)
        gap = max(gap, g)
        if tie:
            ties[t] = tie
        else:
            full += 1
    return full, ties, gap


def timed_train(xt, label, params, dtr, rounds, **kw):
    """``train`` under the launch counts (:func:`train_launches`) with a
    :class:`RoundClock`: (booster, counts, seconds of each round)."""
    clock = RoundClock()
    bst, counts = train_launches(label, lambda: xt.train(
        params, dtr, rounds, verbose_eval=False, callbacks=[clock.callback],
        **kw))
    return bst, counts, clock.seconds()


# one level of one shard of the phase's 4-shard mesh for each kernel its
# runs launch: K4 under ``auto`` and ``scan``, K2 under ``pallas``, K5
# under ``fused`` (levels of 128 nodes), K3 at depth 10's 256 and 512
MESH_SHARD_LEVELS = (("hist_scan", 128), ("hist_int8x2", 128),
                     ("fused_advance_coarse", 128), ("hist_f32", 256),
                     ("hist_f32", 512))


def mesh_shard_kernels(dev, dtr, mesh):
    """Each kernel of the ``distributed`` phase at one level of one shard
    of ``mesh``, at its real shape: ``dtr``'s bins cut into the mesh's
    shards as the trainer cuts them (``data/binned.py shard_binned``),
    logistic gradients at a seeded margin, and the quantiser keywords the
    growers hand every shard (``RowShards.scale`` over all the shards'
    gradients: the int8x2 ``max_abs`` and K3's ``total_rows``), on the
    shard whose own max |g| is furthest below the mesh's. Each wrapper is
    called with those keywords as the growers call it (``build_hist``
    under ``auto``, ``pallas`` and at depth 10's levels,
    ``scan_level_hists``, ``fused_advance_coarse``), must launch its
    kernel, and is held bit for bit against the plain version on the same
    card tensors; each kernel also on two launches with the totals
    against the row sums (:func:`check_hist`), then timed at that shape.
    Returns ({kernel: max |kernel - plain|}, {(kernel, N): (ms, plain_ms,
    library_ms, bound)})."""
    from xgboost_tpu_torch.data.binned import shard_binned
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.partition import level_rel

    bm = dtr.binned(HIGGS_PARAMS["max_bin"], dev)
    B, hm = bm.max_nbins, bm.has_missing
    missing = B - 1 if hm else B
    shards = shard_binned(bm, mesh).bins
    y = torch.from_numpy(dtr.get_label()).to(dev)
    if shards.bounds[-1] != y.shape[0]:
        raise AssertionError("the mesh's shards pad rows; pick a row count "
                             "that the shard count divides")
    g = torch.Generator(device=dev).manual_seed(150)
    p = torch.sigmoid(torch.randn(y.shape[0], generator=g, device=dev))
    gps = shards.split(torch.stack([p - y, p * (1 - p)], 1).contiguous())
    scale = shards.scale(gps)
    own = [H.abs_max(gp) for gp in gps]
    d = min(range(len(gps)), key=lambda k: float(own[k][0]))
    b, gp = shards.parts[d], gps[d]
    m = b.shape[0]
    if torch.equal(own[d], scale["max_abs"]) or scale["total_rows"] == m:
        raise AssertionError("the mesh's scale is shard "
                             f"{d}'s own: the check would not tell them "
                             "apart")
    q, inv = H.quantise_int8x2(gp, scale["max_abs"])
    qs, inv3 = H.fixed_point_scale(gp, scale["max_abs"], scale["total_rows"])
    qs_own, _ = H.fixed_point_scale(gp)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def same(label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(
                f"mesh shard {label}: the wrapper with the mesh's scale "
                f"differs from the plain version (max "
                f"{float((got.double() - want.double()).abs().max())})")
        return float((got - want).abs().max())

    def launched(name, call, times=1):
        reset_counts()
        out = call()
        torch.cuda.synchronize()
        if read_counts()[name] != times:
            raise AssertionError(f"mesh shard: the wrapper did not launch "
                                 f"{name}")
        return out

    errs, timed = {}, {}
    for i, (name, N) in enumerate(MESH_SHARD_LEVELS):
        label = f"{name} shard {d} of {mesh.size}, {m} x {b.shape[1]} N={N}"
        gg = torch.Generator(device=dev).manual_seed(160 + i)
        if name == "fused_advance_coarse":
            pos, prev = level_state(b, B, N, dev, 160 + i)
            lo = 2 * prev.lo + 1
            runs = launched(name, lambda: [H.fused_advance_coarse(
                b, gp, pos, prev, lo, N, missing, **scale)
                for _ in range(2)], times=2)
            want_pos, want = H.fused_advance_coarse_reference(
                b, q, inv, pos, prev, lo, N, missing)
            errs[name] = max(max(same(f"{label} positions", rp, want_pos),
                                 same(label, rh, want)) for rp, rh in runs)
            n_active = int((level_rel(want_pos, lo, N) < N).sum())
            timed[(name, N)] = (
                event_ms(lambda: K.fused_advance_coarse_cuda(
                    b, q, inv, pos, prev, lo, N, missing), reps=20,
                    flush=flush),
                event_ms(lambda: H.fused_advance_coarse_reference(
                    b, q, inv, pos, prev, lo, N, missing), reps=5),
                None, fused_bound_ms(b, N, n_active))
            continue
        rel = torch.randint(0, N, (m,), generator=gg, device=dev,
                            dtype=torch.int32)
        rel = torch.where(torch.rand(m, generator=gg, device=dev) < 0.1,
                          torch.full_like(rel, N), rel).contiguous()
        method = "pallas" if name == "hist_int8x2" else "auto"
        got = launched(name, lambda: H.build_hist(
            b, gp, rel, N, B, method=method, has_missing=hm, **scale))
        if name == "hist_f32":
            want = H.build_hist_f32_reference(b, gp, rel, qs, inv3, N, B)
        elif name == "hist_scan":
            want = H.build_hist_scan_reference(b, q, rel, inv, N, B)
        else:
            want = H.build_hist_int8x2_reference(b, q, rel, inv, N, B)
        errs[name] = max(errs.get(name, 0.0), same(label, got, want))
        if name == "hist_scan":
            fine, coarse = launched(name, lambda: H.scan_level_hists(
                b, gp, rel, N, B, missing, **scale))
            acc = H.scan_acc_reference(b, q, rel, N, B)
            same(f"{label} scan fine", fine, H.dequant_int8x2(acc, inv))
            same(f"{label} scan coarse", coarse, H.dequant_int8x2(
                H.coarse_fold(acc, missing), inv))
        errs[name] = max(errs[name], check_hist(
            b, gp, rel, N, B, f"mesh {label}", only=(name,),
            scale=scale)[name])
        t, n_active = time_hist(b, gp, rel, N, B, flush, only=(name,),
                                scale=scale)
        ms, plain_ms, lib_ms = t[name]
        timed[(name, N)] = (ms, plain_ms, lib_ms, hist_bound_ms(
            b, N, B, n_active, 2 if name in k3_precisions() else 4))
    del flush
    log(f"distributed kernels at one level of shard {d} ({m} x "
        f"{b.shape[1]}, {B} slots) with the mesh's scale (max |g|, |h| "
        f"{scale['max_abs'].tolist()} over {mesh.size} shards against the "
        f"shard's own {own[d].tolist()}; K3's fixed point over "
        f"{scale['total_rows']} rows {qs.tolist()} against the shard's own "
        f"{qs_own.tolist()}): every wrapper launched its kernel and equals "
        f"the plain version bit for bit; "
        + "; ".join(f"{k} N={N} {ms:.6f} ms (plain {pm:.6f}, bound "
                    f"{bd[0]:.6f} {bd[1]})"
                    for (k, N), (ms, pm, _, bd) in timed.items()))
    return errs, timed


def distributed(xt, dev, tmp):
    """The ``distributed`` phase (module docstring): returns (the main-path
    runs' launch counts, a summary dict)."""
    from xgboost_tpu_torch.context import Mesh
    from xgboost_tpu_torch.parallel import collective
    from xgboost_tpu_torch.parallel.collective import (
        InMemoryCommunicator, set_thread_local_communicator)

    card = gpu_line()
    t_phase = time.perf_counter()
    # "one": the one-device models, their launches and seconds a round,
    # which the ``column_split`` phase holds its runs against
    runs, summary = [], {"s_round": {}, "one": {}}
    X, y = higgs_like(DIST_ROWS + DIST_TEST_ROWS, 28, seed=0)
    summary["data"] = (X, y)
    Xtr, ytr = X[:DIST_ROWS], y[:DIST_ROWS]
    dtr = xt.DMatrix(Xtr, label=ytr)
    dte = xt.DMatrix(X[DIST_ROWS:], label=y[DIST_ROWS:])
    mesh = Mesh([dev] * DIST_SHARDS)
    summary["shard_kernels"] = mesh_shard_kernels(dev, dtr, mesh)

    def pair(label, params, rounds, levels, kernels, shards=DIST_SHARDS,
             data=dtr, rows_x=Xtr, labels=ytr, capped=False,
             per_level=None):
        """``params`` on one device and on the mesh of ``shards`` shards
        of ``dev``: launches, each round held under the certificate
        (:func:`round_by_round`), predictions at rtol 1e-5 + atol 1e-5,
        seconds a round."""
        m = Mesh([dev] * shards)
        one, c1, s1 = timed_train(xt, f"{label} one device", params, data,
                                  rounds)
        msh, cm, sm = timed_train(xt, f"{label} {shards}-shard mesh",
                                  dict(params, mesh=m), data, rounds)
        runs.extend([c1, cm])
        for k in kernels:
            want = shards * (per_level[k] if per_level else levels) * rounds
            if cm[k] != want or c1[k] * shards != cm[k]:
                raise AssertionError(
                    f"{label}: {k} launched {cm[k]} times on the mesh and "
                    f"{c1[k]} on one device, want {want} = {shards} shards "
                    f"x {per_level[k] if per_level else levels} x {rounds} "
                    "rounds")
        full, ties, gap, pgap = round_by_round(
            xt, label, params, dict(params, mesh=m), one, rows_x, labels,
            rounds, capped)
        # end to end the two runs' margins part by the leaf gaps and feed
        # them to the next round's gradients: reported, with a gross bound
        pa = msh.predict(xt.DMatrix(rows_x))
        pb = one.predict(xt.DMatrix(rows_x))
        if not np.abs(pa - pb).max() < 1e-3:
            raise AssertionError(f"{label}: mesh predictions differ by "
                                 f"{np.abs(pa - pb).max()} end to end")
        summary["s_round"][label] = {"one": s1, "mesh": sm}
        summary["one"][label] = (one, c1, s1)
        log(f"distributed {label}: {shards} shards of {dev}, {full} of "
            f"{len(one.gbm.trees)} trees the same in full"
            + (f", near ties at {ties}" if ties else "")
            + f", largest leaf gap {gap:.3e}, predictions from one margin "
            f"within {pgap:.3e} (end to end {np.abs(pa - pb).max():.3e}); "
            f"seconds a round one device "
            f"{s1}, mesh {sm}; launches mesh "
            f"{ {k: cm[k] for k in kernels} } = {shards} x one device's "
            f"{ {k: c1[k] for k in kernels} } [{card}]")
        return msh, one

    # -- the mesh against one device: auto (K4 a shard), pallas (K2),
    # fused (K5 + K2), depth 10 (K4 and K3 above 128 nodes)
    p = dict(HIGGS_PARAMS)
    msh, one = pair("auto", p, DIST_ROUNDS, 8, ("hist_scan",))
    again, c2, _ = timed_train(xt, "auto mesh again", dict(p, mesh=mesh),
                               dtr, DIST_ROUNDS)
    runs.append(c2)
    if digest(again) != digest(msh):
        raise AssertionError("two runs of the mesh gave two models")
    summary["mesh_sha"] = digest(msh)
    pair("pallas", dict(p, hist_method="pallas"), DIST_ROUNDS, 8,
         ("hist_int8x2",))
    pair("fused", dict(p, hist_method="fused"), DIST_ROUNDS, 8,
         ("fused_advance_coarse", "hist_int8x2"),
         per_level={"fused_advance_coarse": 7, "hist_int8x2": 9})
    pair("depth 10", dict(p, max_depth=10), DIST_ROUNDS, 8,
         ("hist_scan", "hist_f32"),
         per_level={"hist_scan": 8, "hist_f32": 2})

    # -- lossguide at 255 leaves: K4 a shard for each pair
    lg = dict(p, grow_policy="lossguide", max_leaves=255)
    one, c1, s1 = timed_train(xt, "lossguide one device", lg, dtr,
                              DIST_LG_ROUNDS)
    msh, cm, sm = timed_train(xt, "lossguide mesh", dict(lg, mesh=mesh),
                              dtr, DIST_LG_ROUNDS)
    runs.extend([c1, cm])
    full, ties, gap, _ = round_by_round(xt, "lossguide", lg,
                                        dict(lg, mesh=mesh), one, Xtr, ytr,
                                        DIST_LG_ROUNDS, capped=True)
    if cm["hist_scan"] % DIST_SHARDS or not cm["hist_scan"] or (
            not ties and cm["hist_scan"] != DIST_SHARDS * c1["hist_scan"]):
        raise AssertionError(f"lossguide: K4 launched {cm['hist_scan']} "
                             f"times on the mesh, {c1['hist_scan']} on one "
                             "device")
    summary["s_round"]["lossguide"] = {"one": s1, "mesh": sm}
    summary["one"]["lossguide"] = (one, c1, s1)
    log(f"distributed lossguide 255 leaves: {full} of {len(one.gbm.trees)} "
        f"trees the same in full" + (f", near ties at {ties}" if ties
                                     else "")
        + f", largest leaf gap {gap:.3e}; K4 {cm['hist_scan']} on the mesh, "
        f"{c1['hist_scan']} on one device; seconds a round {s1} / {sm} "
        f"[{card}]")

    # -- vector leaves at the MediaMill shape on a 2-shard mesh
    Xm, Ym = mediamill_like(seed=7)
    dmm = xt.DMatrix(Xm[:MM_TRAIN_ROWS], label=Ym[:MM_TRAIN_ROWS])
    mp = dict(MM_PARAMS, multi_strategy="multi_output_tree")
    one, c1, s1 = timed_train(xt, "vector leaves one device", mp, dmm,
                              DIST_MM_ROUNDS)
    m2 = Mesh([dev] * DIST_MM_SHARDS)
    msh, cm, sm = timed_train(xt, "vector leaves mesh", dict(mp, mesh=m2),
                              dmm, DIST_MM_ROUNDS)
    runs.extend([c1, cm])
    want = DIST_MM_SHARDS * MM_LABELS * MM_PARAMS["max_depth"] \
        * DIST_MM_ROUNDS
    if cm["hist_int8x2"] != want:
        raise AssertionError(f"vector leaves: K2 launched "
                             f"{cm['hist_int8x2']} times on the mesh, want "
                             f"{want}")
    _, ties, gap, _ = round_by_round(xt, "vector leaves", mp,
                                  dict(mp, mesh=m2), one, Xm[:MM_TRAIN_ROWS],
                                  Ym[:MM_TRAIN_ROWS], DIST_MM_ROUNDS,
                                  vector=True)
    summary["s_round"]["vector leaves"] = {"one": s1, "mesh": sm}
    summary["one"]["vector leaves"] = (one, c1, s1)
    summary["mediamill"] = (Xm[:MM_TRAIN_ROWS], Ym[:MM_TRAIN_ROWS])
    log(f"distributed vector leaves ({MM_LABELS} labels, "
        f"{DIST_MM_SHARDS} shards): K2 {cm['hist_int8x2']} on the mesh, "
        f"{c1['hist_int8x2']} on one device"
        + (f", near ties at {ties}" if ties else "")
        + f", largest leaf gap {gap:.3e}; seconds a round {s1} / {sm} "
        f"[{card}]")

    # -- approx on the 4-shard mesh: the sketch over every shard's rows
    ap = dict(p, tree_method="approx")
    res = {}
    one, c1, s1 = timed_train(xt, "approx one device", ap, dtr, DIST_ROUNDS)
    msh, cm, sm = timed_train(xt, "approx mesh", dict(ap, mesh=mesh), dtr,
                              DIST_ROUNDS, evals=[(dte, "test")],
                              evals_result=res)
    runs.extend([c1, cm])
    ll = res["test"]["logloss"]
    if not ll[-1] < ll[0]:
        raise AssertionError(f"approx mesh: held-out logloss {ll} did not "
                             "fall")
    full, ties, gap, _ = round_by_round(xt, "approx", ap,
                                        dict(ap, mesh=mesh), one, Xtr, ytr,
                                        DIST_ROUNDS)
    summary["s_round"]["approx"] = {"one": s1, "mesh": sm}
    summary["one"]["approx"] = (one, c1, s1)
    log(f"distributed approx: held-out logloss {ll}; {full} of "
        f"{len(one.gbm.trees)} trees the same in full"
        + (f", near ties at {ties}" if ties else "")
        + f", largest leaf gap {gap:.3e}; seconds a round {s1} / {sm} "
        f"[{card}]")

    # -- two OS processes on this card over gloo, each with half the rows
    world = 2
    rdv = os.path.join(tmp, "rdv")
    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(tmp, "dist_worker.py")
    with open(script, "w") as fh:
        fh.write(DIST_WORKER)
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, root, str(r), str(world),
         "file://" + rdv, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    try:
        logs = [pr.communicate(timeout=600)[0].decode(errors="replace")
                for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    t_procs = time.perf_counter() - t0
    for r, pr in enumerate(procs):
        if pr.returncode != 0:
            raise AssertionError(f"rank {r} failed:\n{logs[r][-4000:]}")
    ranks = [json.load(open(o)) for o in outs]
    if ranks[0]["sha"] != ranks[1]["sha"]:
        raise AssertionError(f"the two processes gave two models: "
                             f"{[r['sha'] for r in ranks]}")
    for r in ranks:
        want = (DIST_ROUNDS * 8, 0)
        got = (r["counts"]["hist_scan"], r["counts"]["hist_int8x2"])
        if got != want:
            raise AssertionError(f"rank {r['rank']} launched K4/K2 {got}, "
                                 f"want {want}")
        runs.append(r["counts"])
    # the in-process 2-shard mesh with the two ranks' merged cuts
    merged = [None] * world
    comms = InMemoryCommunicator.make_world(world)
    m = DIST_ROWS // world

    def sketch(r):
        merged[r] = collective.distributed_sketch(
            Xtr[r * m:(r + 1) * m], HIGGS_PARAMS["max_bin"], comm=comms[r])

    threads = [threading.Thread(target=sketch, args=(r,))
               for r in range(world)]
    [t.start() for t in threads]
    [t.join() for t in threads]

    class Cuts:
        def cuts(self, max_bin):
            return merged[0]

    dq = xt.QuantileDMatrix(Xtr, label=ytr, max_bin=HIGGS_PARAMS["max_bin"],
                            ref=Cuts())
    ref2, c_ref, s_ref = timed_train(xt, "2-shard mesh", dict(
        p, base_score=0.5, mesh=Mesh([dev] * world)), dq, DIST_ROUNDS)
    runs.append(c_ref)
    proc_bst = xt.Booster({"device": str(dev)},
                          model_file=open(outs[0] + ".ubj", "rb").read())
    full, ties, gap = certify_forest(proc_bst, ref2, "two processes",
                                     leaf_rows(ref2, Xtr))
    summary.update(procs_s_round=[r["s_round"] for r in ranks],
                   procs_collective_s=[r["collective_s"] for r in ranks],
                   procs_round_collective_s=[r["round_collective_s"]
                                             for r in ranks],
                   procs_setup_collective_s=[r["setup_collective_s"]
                                             for r in ranks],
                   procs_wall=t_procs, mesh2_s_round=s_ref,
                   procs_sha=ranks[0]["sha"])
    same = hashlib.sha256(bytes(ref2.save_raw("ubj"))).hexdigest() \
        == ranks[0]["sha"]
    log(f"distributed two processes (gloo, {dev} each, {m} rows each): one "
        f"sha256 {ranks[0]['sha'][:16]}... ({'the' if same else 'not the'} "
        f"in-process mesh's bytes), against the in-process 2-shard "
        f"mesh on the merged cuts: {full} of {len(ref2.gbm.trees)} trees "
        f"the same in full" + (f", near ties at {ties}" if ties else "")
        + f", largest leaf gap {gap:.3e}; seconds a round "
        f"{[r['s_round'] for r in ranks]} (2-shard mesh {s_ref}); the "
        f"collective's host time a round "
        f"{[r['round_collective_s'] for r in ranks]} s, before the first "
        f"round (the sketch merge) {[r['setup_collective_s'] for r in ranks]}"
        f" s, in all {[r['collective_s'] for r in ranks]} s of "
        f"train_per_host's {[r['wall'] for r in ranks]} s; both processes "
        f"{t_procs:.3f} s with imports [{card}]")

    # -- paged ranks: two thread ranks, each 2 of the first 4 pages
    env_keep = {k: os.environ.get(k) for k in ("XTPU_PAGED_COLLAPSE",
                                               "XTPU_PAGE_ROWS")}
    os.environ.update(XTPU_PAGED_COLLAPSE="0",
                      XTPU_PAGE_ROWS=str(EXT_BATCH_ROWS))
    try:
        n_all = DIST_PAGES * EXT_BATCH_ROWS
        full_dm = xt.QuantileDMatrix(higgs_batches(
            xt, n_all, 28, os.path.join(tmp, "all")), max_bin=256)
        paged_p = dict(HIGGS_PARAMS, base_score=0.5)
        one, c1, s1 = timed_train(xt, "paged one rank", paged_p, full_dm,
                                  DIST_PAGED_ROUNDS)
        runs.append(c1)
        rank_dms = []
        for r in range(world):
            class Half(xt.DataIter):
                def __init__(self, r=r):
                    super().__init__(os.path.join(tmp, f"rank{r}"))
                    self.r, self.i = r, 0

                def next(self, input_data):
                    if self.i == DIST_PAGES // world:
                        return 0
                    X_, y_ = higgs_batch(EXT_SEED, self.r * (DIST_PAGES //
                                         world) + self.i, EXT_BATCH_ROWS, 28)
                    input_data(data=X_, label=y_)
                    self.i += 1
                    return 1

                def reset(self):
                    self.i = 0

            # the one rank's cuts: the ranks' allreduced histograms are
            # then compared with one rank's over the same bins
            rank_dms.append(xt.QuantileDMatrix(Half(), max_bin=256,
                                               ref=full_dm))
        # each rank round: from the one rank's model before it (a
        # continuation walks its trees to the same margins), so that the
        # ranks and the one rank grow from one margin
        shas, c_ranks, out = [], [], [None] * world
        ties, gap = {}, 0.0
        for r in range(DIST_PAGED_ROUNDS):
            before = bytes(one[0:r].save_raw("ubj")) if r else None
            comms = InMemoryCommunicator.make_world(world)
            errs_t = []

            def paged_rank(k, before=before, comms=comms, errs_t=errs_t):
                set_thread_local_communicator(comms[k])
                try:
                    clock = RoundClock()
                    b = xt.train(paged_p, rank_dms[k], 1, xgb_model=before,
                                 verbose_eval=False,
                                 callbacks=[clock.callback])
                    out[k] = (b, clock.seconds())
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errs_t.append(e)
                finally:
                    set_thread_local_communicator(None)

            reset_counts()
            threads = [threading.Thread(target=paged_rank, args=(k,))
                       for k in range(world)]
            [t.start() for t in threads]
            [t.join() for t in threads]
            torch.cuda.synchronize()
            c_ranks.append(read_counts())
            if errs_t:
                raise errs_t[0]
            got = [digest(b) for b, _ in out]
            if got[0] != got[1]:
                raise AssertionError(f"paged ranks gave two models in round "
                                     f"{r}: {got}")
            shas.append(got[0])
            if r == 0:
                Xp = np.concatenate([higgs_batch(EXT_SEED, i, EXT_BATCH_ROWS,
                                                 28)[0]
                                     for i in range(DIST_PAGES)])
                rows = leaf_rows(one, Xp)
                del Xp
            tie, g, _ = certified_trees(
                out[0][0].gbm.trees[r], one.gbm.trees[r],
                f"paged ranks round {r}", one.tree_param.eta,
                one.tree_param.reg_lambda, LOGISTIC_QUANTA, rows[r])
            gap = max(gap, g)
            if tie:
                ties[r] = tie
        runs.extend(c_ranks)
        k4 = sum(c["hist_scan"] for c in c_ranks)
        if k4 != c1["hist_scan"]:
            raise AssertionError(f"paged ranks launched K4 {k4} times, one "
                                 f"rank {c1['hist_scan']}")
        full = sum(1 for r in range(DIST_PAGED_ROUNDS) if r not in ties)
        summary["s_round"]["paged"] = {"one": s1,
                                       "ranks": [s for _, s in out]}
        log(f"distributed paged ranks ({world} thread ranks x "
            f"{DIST_PAGES // world} pages of {EXT_BATCH_ROWS}): one sha256 "
            f"a round {[h[:16] for h in shas]}, against one rank over "
            f"{DIST_PAGES} pages round by round: "
            f"{full} of {len(one.gbm.trees)} trees the same in full"
            + (f", near ties at {ties}" if ties else "")
            + f", largest leaf gap {gap:.3e}; K4 {k4} "
            f"across the ranks, {c1['hist_scan']} one rank; seconds a round "
            f"one rank {s1}, ranks {[s for _, s in out]} [{card}]")
    finally:
        for k, v in env_keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    summary["phase_s"] = time.perf_counter() - t_phase
    return runs, summary


COL_SHARDS = 4               # feature shards of 7 of the 28 columns each
COL_ROUNDS = 3
COL_MM_SHARDS = 2
COL_PARTIES = 4              # vertical parties, a block of 7 columns each
# (one device's histogram builds a round, kernel -> the kernel each
# feature shard runs in its place, builds a round): ``auto`` takes K2
# where one device takes K4 (``auto_selects_scan(col_split=True)``), and
# under column split ``fused`` advances first and builds its coarse
# histogram with K2, never launching K5
K2_K4 = ("hist_scan", "hist_int8x2")
COL_RUNS = (
    ("auto", {}, "auto", {"hist_int8x2": K2_K4}),
    ("scan", {"hist_method": "scan"}, "fused", {"hist_scan": ("hist_scan",)}),
    ("coarse", {"hist_method": "coarse"}, "fused",
     {"hist_int8x2": ("hist_int8x2", "fused_advance_coarse")}),
    ("fused", {"hist_method": "fused"}, "fused",
     {"hist_int8x2": ("hist_int8x2", "fused_advance_coarse")}),
    ("depth 10", {"max_depth": 10}, "depth 10",
     {"hist_int8x2": K2_K4, "hist_f32": ("hist_f32",)}),
)
# a kernel's launches one device makes a level where the ``distributed``
# phase kept no model of the same parameters (``scan`` and ``coarse`` grow
# ``fused``'s trees; one device launches K4 8 and K2 16 a round at depth
# 8)
COL_ONE_DEVICE = {"scan": {"hist_scan": 1}, "coarse": {"hist_int8x2": 2}}
COL_SHARD_LEVELS = (("hist_int8x2", 128), ("hist_scan", 128),
                    ("hist_f32", 256), ("hist_f32", 512))


class TimedComm:
    """A communicator whose collectives add their host seconds to
    ``seconds`` (the vertical parties' exchange time)."""

    def __init__(self, inner):
        self.inner, self.seconds = inner, 0.0

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in ("allreduce", "allgather_objects", "broadcast"):
            return attr

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return attr(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        return timed


def tree_digest(bst) -> str:
    """sha256 of the model's trees (a column-split model's learner
    parameters name its split mode)."""
    return hashlib.sha256(json.dumps(
        [t.to_json() for t in bst.gbm.trees]).encode()).hexdigest()


def col_same_trees(one, col, label):
    """``col``'s trees against one device's node by node: children,
    features, bins, default directions and categorical words exactly,
    leaves and thresholds within rtol 1e-5 + atol 1e-5. Returns whether
    the trees' bytes are one device's."""
    if len(one.gbm.trees) != len(col.gbm.trees):
        raise AssertionError(f"{label}: {len(col.gbm.trees)} trees against "
                             f"{len(one.gbm.trees)}")
    for t, (a, b) in enumerate(zip(one.gbm.trees, col.gbm.trees)):
        for f in ("left_child", "right_child", "split_feature", "split_bin",
                  "default_left", "is_leaf", "is_cat_split", "cat_words"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{label} tree {t}: {f} differs from "
                                     "one device's")
        for f in ("leaf_value", "split_value"):
            if not np.allclose(getattr(a, f), getattr(b, f), rtol=1e-5,
                               atol=1e-5):
                raise AssertionError(f"{label} tree {t}: {f} differs from "
                                     "one device's")
    return tree_digest(one) == tree_digest(col)


def col_shard_kernels(dev, dtr, mesh):
    """K2, K4 (at 128 nodes) and K3 (at depth 10's 256 and 512) at one
    level of one feature shard at its real shape: ``dtr``'s bins laid out
    as the column mesh lays them out (``data/binned.py
    pad_features_for_mesh``: every row, 7 of the 28 features), logistic
    gradients at a seeded margin with the shard's own scale (every shard
    holds every row). Each wrapper (``build_hist`` under ``pallas``,
    ``scan`` and ``auto`` above 128 nodes, as the column growers call it)
    must launch its kernel and equal its plain version bit for bit, on
    two launches with the totals against the row sums
    (:func:`check_hist`), then is timed. Returns ({kernel: max
    |kernel - plain|}, {(kernel, N): (ms, plain_ms, library_ms,
    bound)})."""
    from xgboost_tpu_torch.data.binned import pad_features_for_mesh
    from xgboost_tpu_torch.ops import histogram as H

    bm = dtr.binned(HIGGS_PARAMS["max_bin"], dev)
    B, hm = bm.max_nbins, bm.has_missing
    cols = pad_features_for_mesh(bm, mesh).bins
    b = cols.parts[1]
    if b.shape != (bm.shape[0], 28 // mesh.size) or cols.pad:
        raise AssertionError(f"a feature shard is {tuple(b.shape)}")
    if not torch.equal(b, bm.bins[:, cols.offsets[1]:cols.offsets[2]]):
        raise AssertionError("the feature shard is not its block of columns")
    y = torch.from_numpy(dtr.get_label()).to(dev)
    g = torch.Generator(device=dev).manual_seed(170)
    p = torch.sigmoid(torch.randn(y.shape[0], generator=g, device=dev))
    gp = torch.stack([p - y, p * (1 - p)], 1).contiguous()
    m = b.shape[0]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    errs, timed = {}, {}
    for i, (name, N) in enumerate(COL_SHARD_LEVELS):
        label = f"col shard {name} {m} x {b.shape[1]} N={N}"
        gg = torch.Generator(device=dev).manual_seed(180 + i)
        rel = torch.randint(0, N, (m,), generator=gg, device=dev,
                            dtype=torch.int32)
        rel = torch.where(torch.rand(m, generator=gg, device=dev) < 0.1,
                          torch.full_like(rel, N), rel).contiguous()
        method = {"hist_int8x2": "pallas", "hist_scan": "scan"}.get(name,
                                                                    "auto")
        reset_counts()
        got = H.build_hist(b, gp, rel, N, B, method=method, has_missing=hm,
                           col_split=True)
        torch.cuda.synchronize()
        if read_counts()[name] != 1:
            raise AssertionError(f"{label}: the wrapper did not launch "
                                 f"{name}")
        if name == "hist_f32":
            qs, inv3 = H.fixed_point_scale(gp)
            want = H.build_hist_f32_reference(b, gp, rel, qs, inv3, N, B)
        else:
            q, inv = H.quantise_int8x2(gp)
            plain = (H.build_hist_scan_reference if name == "hist_scan"
                     else H.build_hist_int8x2_reference)
            want = plain(b, q, rel, inv, N, B)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the wrapper differs from the "
                                 "plain version")
        errs[name] = max(errs.get(name, 0.0), check_hist(
            b, gp, rel, N, B, label, only=(name,))[name])
        t, n_active = time_hist(b, gp, rel, N, B, flush, only=(name,))
        ms, plain_ms, lib_ms = t[name]
        timed[(name, N)] = (ms, plain_ms, lib_ms, hist_bound_ms(
            b, N, B, n_active, 2 if name in k3_precisions() else 4))
    del flush
    log(f"column_split kernels at one level of feature shard 1 ({m} x "
        f"{b.shape[1]}, {B} slots, its own scale): every wrapper launched "
        f"its kernel and equals the plain version bit for bit; "
        + "; ".join(f"{k} N={N} {ms:.6f} ms (plain {pm:.6f}, library "
                    f"{lm:.6f}, bound {bd[0]:.6f} {bd[1]})"
                    for (k, N), (ms, pm, lm, bd) in timed.items()))
    return errs, timed


def vertical_parties(xt, dev, params, X, y, rounds, Xte=None):
    """``params`` trained by ``COL_PARTIES`` vertical parties on
    ``InMemoryCommunicator`` threads, each with a block of the columns of
    every row, only rank 0 with labels; with ``Xte`` every party also
    predicts its block of those rows (``federated_vertical_margin``).
    Returns (each rank's booster, predictions, seconds a round and
    communicator host seconds, and the launches of all the ranks)."""
    from xgboost_tpu_torch.parallel.collective import (
        InMemoryCommunicator, set_thread_local_communicator)

    comms = [TimedComm(c) for c in
             InMemoryCommunicator.make_world(COL_PARTIES)]
    w = X.shape[1] // COL_PARTIES
    out, errs = [None] * COL_PARTIES, []

    def party(r):
        set_thread_local_communicator(comms[r])
        try:
            blk = slice(r * w, (r + 1) * w)
            dm = xt.DMatrix(X[:, blk], label=y if r == 0 else None,
                            data_split_mode="col")
            clock = RoundClock()
            b = xt.train(dict(params, data_split_mode="col"), dm, rounds,
                         verbose_eval=False, callbacks=[clock.callback])
            train_s = comms[r].seconds
            pred = (None if Xte is None else
                    b.predict(xt.DMatrix(Xte[:, blk], data_split_mode="col")))
            out[r] = (b, pred, clock.seconds(), train_s,
                      comms[r].seconds - train_s)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
        finally:
            set_thread_local_communicator(None)

    reset_counts()
    threads = [threading.Thread(target=party, args=(r,))
               for r in range(COL_PARTIES)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    torch.cuda.synchronize()
    counts = read_counts()
    if errs:
        raise errs[0]
    return out, counts


def column_split(xt, dev, dist):
    """The ``column_split`` phase (module docstring): returns (the
    main-path runs' launch counts, a summary dict)."""
    from xgboost_tpu_torch.context import Mesh

    card = gpu_line()
    t_phase = time.perf_counter()
    X, y = dist["data"]
    Xtr, ytr = X[:DIST_ROWS], y[:DIST_ROWS]
    dtr = xt.DMatrix(Xtr, label=ytr)
    mesh = Mesh([dev] * COL_SHARDS)
    runs, summary = [], {"s_round": {}, "same_bytes": {}}
    summary["shard_kernels"] = col_shard_kernels(dev, dtr, mesh)
    hist_names = ("hist_int8x2", "hist_scan", "hist_f32",
                  "fused_advance_coarse")

    def against(label, one, c1, s1, params, data, rounds, launches,
                shards=COL_SHARDS, per_round=None):
        """``params`` on a column mesh of ``shards`` shards of ``dev``
        against one device's ``one`` (its launches ``c1``, or one
        device's per round ``per_round``): the trees node by node,
        predictions at rtol 1e-5 + atol 1e-5, every kernel of
        ``launches`` ({kernel the shards run: one device's kernels in its
        place}) launched shards x one device's, K5 never."""
        m = Mesh([dev] * shards)
        col, cm, sm = timed_train(xt, f"column {label}", dict(
            params, mesh=m, data_split_mode="col"), data, rounds)
        runs.append(cm)
        same = col_same_trees(one, col, f"column {label}")
        pa = col.predict(data)
        pb = one.predict(data)
        if not np.allclose(pa, pb, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"column {label}: predictions differ by "
                                 f"{np.abs(pa - pb).max()}")
        for k, theirs in launches.items():
            n1 = (sum(c1[t] for t in theirs) if c1 is not None
                  else per_round[k] * rounds)
            if cm[k] != shards * n1 or cm[k] == 0:
                raise AssertionError(
                    f"column {label}: {k} launched {cm[k]} times, want "
                    f"{shards} shards x one device's {n1}")
        if cm["fused_advance_coarse"]:
            raise AssertionError(f"column {label}: K5 launched "
                                 f"{cm['fused_advance_coarse']} times")
        summary["s_round"][label] = {"one": s1, "column": sm}
        summary["same_bytes"][label] = same
        log(f"column_split {label}: {shards} feature shards of {dev}, every "
            f"tree node by node one device's, trees' sha256 "
            f"{'==' if same else '!='} one device's; launches "
            f"{ {k: cm[k] for k in hist_names if cm[k]} } = {shards} x one "
            f"device's; predictions within "
            f"{float(np.abs(pa - pb).max()):.3e}; seconds a round one "
            f"device {s1}, column mesh {sm} [{card}]")
        return col, cm

    # -- the column mesh against one device: auto (K2 a shard), scan (K4),
    # coarse and fused (K2 on the coarse ids, K5 never), depth 10 (K3)
    for label, extra, ref, launches in COL_RUNS:
        one, c1, s1 = dist["one"][ref]
        params = dict(HIGGS_PARAMS, **extra)
        if label in COL_ONE_DEVICE:
            col, _ = against(label, one, None, s1, params, dtr, COL_ROUNDS,
                             launches, per_round={
                                 k: v * params["max_depth"] for k, v in
                                 COL_ONE_DEVICE[label].items()})
        else:
            col, _ = against(label, one, c1, s1, params, dtr, COL_ROUNDS,
                             launches)
        if label == "auto":
            again, c2, _ = timed_train(xt, "column auto again", dict(
                params, mesh=mesh, data_split_mode="col"), dtr, COL_ROUNDS)
            runs.append(c2)
            if tree_digest(again) != tree_digest(col):
                raise AssertionError("two runs of the column mesh gave two "
                                     "models")
            summary["col_sha"] = tree_digest(col)

    # -- lossguide at 255 leaves, vector leaves at the MediaMill shape on 2
    # shards, approx: each against the distributed phase's one device
    one, c1, s1 = dist["one"]["lossguide"]
    against("lossguide", one, c1, s1, dict(
        HIGGS_PARAMS, grow_policy="lossguide", max_leaves=255), dtr,
        DIST_LG_ROUNDS, {"hist_int8x2": K2_K4})
    one, c1, s1 = dist["one"]["vector leaves"]
    Xm, Ym = dist["mediamill"]
    against("vector leaves", one, c1, s1,
            dict(MM_PARAMS, multi_strategy="multi_output_tree"),
            xt.DMatrix(Xm, label=Ym), DIST_MM_ROUNDS,
            {"hist_int8x2": ("hist_int8x2",)}, shards=COL_MM_SHARDS)
    one, c1, s1 = dist["one"]["approx"]
    against("approx", one, c1, s1, dict(HIGGS_PARAMS, tree_method="approx"),
            dtr, DIST_ROUNDS, {"hist_int8x2": K2_K4})

    # -- vertical federated parties: 4 threads of 7 columns, labels on
    # rank 0; depthwise 3 rounds with the held-out rows predicted by the
    # decision-bit protocol, lossguide 255 leaves 2 rounds
    Xte = X[DIST_ROWS:]
    for label, ref, params, rounds, test in (
            ("vertical depthwise", "auto", dict(HIGGS_PARAMS), COL_ROUNDS,
             Xte),
            ("vertical lossguide", "lossguide", dict(
                HIGGS_PARAMS, grow_policy="lossguide", max_leaves=255),
             DIST_LG_ROUNDS, None)):
        one, c1, s1 = dist["one"][ref]
        out, cv = vertical_parties(xt, dev, params, Xtr, ytr, rounds, test)
        runs.append(cv)
        shas = {tree_digest(b) for b, *_ in out}
        if len(shas) != 1:
            raise AssertionError(f"{label}: the parties hold "
                                 f"{len(shas)} models")
        same = col_same_trees(one, out[0][0], label)
        builds = sum(c1[k] for k in K2_K4)
        if cv["hist_int8x2"] != COL_PARTIES * builds:
            raise AssertionError(f"{label}: K2 launched {cv['hist_int8x2']}"
                                 f" times, want {COL_PARTIES} parties x one "
                                 f"device's {builds}")
        pred_gap = None
        if test is not None:
            want = one.predict(xt.DMatrix(test))
            pred_gap = max(float(np.abs(p - want).max())
                           for _, p, *_ in out)
            if not all(np.allclose(p, want, rtol=1e-5, atol=1e-5)
                       for _, p, *_ in out):
                raise AssertionError(f"{label}: the parties' predictions "
                                     f"differ from K1's by {pred_gap}")
        s_round = [o[2] for o in out]
        comm_s = [o[3] for o in out]
        summary["s_round"][label] = {"one": s1, "parties": s_round,
                                     "comm_s": comm_s,
                                     "predict_comm_s": [o[4] for o in out]}
        summary["same_bytes"][label] = same
        log(f"column_split {label}: {COL_PARTIES} parties on threads of "
            f"{dev}, one sha256 {shas.pop()[:16]}... "
            f"({'==' if same else '!='} one device's trees), K2 "
            f"{cv['hist_int8x2']} = {COL_PARTIES} x one device's {builds}"
            + ("" if pred_gap is None else
               f"; {len(Xte)} held-out rows by the decision-bit protocol "
               f"within {pred_gap:.3e} of K1's (the protocol's host time "
               f"{[round(o[4], 6) for o in out]} s)")
            + f"; seconds a round one device {s1}, parties {s_round[0]}; "
            f"communicator host seconds in training {comm_s} [{card}]")
    summary["phase_s"] = time.perf_counter() - t_phase
    return runs, summary


PM_ROWS = 4_000_000           # 4 pages of ``EXT_BATCH_ROWS`` (the HIGGS rule)
PM_SHARDS = 4                 # p_loc = 250,000 rows a shard and page
PM_ROUNDS = 3
PM_BUDGETS = (0, 2, 4)        # mesh pages cached
PM_DEEP_DEPTH = 10            # one round: K3 at the levels of 256 and 512
PM_LG_LEAVES = 64
PM_LG_ROUNDS = 2
PM_MM_SHARDS = 2
PM_MM_ROUNDS = 2
PM_GAP_ROWS = 262_144         # card against CPU: 2 pages of 131,072 rows
PM_GAP_SHARDS = 2             # on 2 shards: 65,536 rows a block, K4's rows
# one shard's block of a page, at a level of N nodes, through the method
# whose kernel the main path runs there: K4 (``auto``), K2 (``scan``'s
# coarse builds; ``pallas`` here), K3 (depth 10's levels, and at 128)
PM_SHARD_LEVELS = (("hist_scan", 128, "auto"), ("hist_int8x2", 128, "pallas"),
                   ("hist_f32", 128, "pallas:f32"), ("hist_f32", 512, "auto"))


def paged_shard_kernels(dev, paged, labels, world):
    """Each kernel of the ``paged_mesh`` phase at one shard's block of one
    page (``PagedBinnedMatrix._mesh_block``: p_loc rows of the shard, the
    bins the ring uploads), logistic gradients at a seeded margin with the
    block's own quantiser scale (each (shard, page) block quantises alone,
    as the JAX package's paged mesh does), through ``build_hist`` as the
    page kernels call it: it must launch its kernel and equal the plain
    version bit for bit (and on two launches, :func:`check_hist`), then
    timed at that shape. Returns ({kernel: max |kernel - plain|},
    {(kernel, N): (ms, plain_ms, library_ms, bound)})."""
    from xgboost_tpu_torch.ops import histogram as H

    _, n_loc, p_loc = paged.mesh_layout(world)
    d = 1
    b = torch.from_numpy(paged._mesh_block(0, d, n_loc, p_loc)).to(dev)
    B, hm = paged.max_nbins, paged.has_missing
    y = torch.from_numpy(labels[d * n_loc:d * n_loc + p_loc]).to(dev)
    g = torch.Generator(device=dev).manual_seed(210)
    p = torch.sigmoid(torch.randn(p_loc, generator=g, device=dev))
    gp = torch.stack([p - y, p * (1 - p)], 1).contiguous()
    q, inv = H.quantise_int8x2(gp)
    qs, inv3 = H.fixed_point_scale(gp)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    errs, timed = {}, {}
    for i, (name, N, method) in enumerate(PM_SHARD_LEVELS):
        label = (f"{name} block of shard {d} of {world}, {p_loc} x "
                 f"{b.shape[1]} N={N}")
        gg = torch.Generator(device=dev).manual_seed(220 + i)
        rel = torch.randint(0, N, (p_loc,), generator=gg, device=dev,
                            dtype=torch.int32)
        rel = torch.where(torch.rand(p_loc, generator=gg, device=dev) < 0.1,
                          torch.full_like(rel, N), rel).contiguous()
        reset_counts()
        got = H.build_hist(b, gp, rel, N, B, method=method, has_missing=hm)
        torch.cuda.synchronize()
        if read_counts()[name] != 1:
            raise AssertionError(f"paged shard: build_hist({method!r}) did "
                                 f"not launch {name}: {read_counts()}")
        if name == "hist_f32":
            want = H.build_hist_f32_reference(b, gp, rel, qs, inv3, N, B)
        elif name == "hist_scan":
            want = H.build_hist_scan_reference(b, q, rel, inv, N, B)
        else:
            want = H.build_hist_int8x2_reference(b, q, rel, inv, N, B)
        if not torch.equal(got, want):
            raise AssertionError(f"paged shard {label}: the kernel differs "
                                 f"from the plain version by "
                                 f"{float((got - want).abs().max())}")
        errs[name] = max(errs.get(name, 0.0), check_hist(
            b, gp, rel, N, B, f"paged {label}", only=(name,))[name])
        t, n_active = time_hist(b, gp, rel, N, B, flush, only=(name,))
        ms, plain_ms, lib_ms = t[name]
        timed[(name, N)] = (ms, plain_ms, lib_ms, hist_bound_ms(
            b, N, B, n_active, 2 if name in k3_precisions() else 4))
    del flush
    log("paged mesh kernels at one shard's block of a page ("
        f"{p_loc} x {b.shape[1]}, {B} slots, the block's own scale): every "
        "wrapper launched its kernel and equals the plain version bit for "
        "bit; " + "; ".join(
            f"{k} N={N} {ms:.6f} ms (plain {pm:.6f}, index_add_ {lm:.6f}, "
            f"bound {bd[0]:.6f} {bd[1]})"
            for (k, N), (ms, pm, lm, bd) in timed.items()))
    return errs, timed


def rows_of_leaves(bst, dm):
    """Each tree's {leaf: rows} of ``dm`` under ``bst`` (``pred_leaf``)."""
    leaves = bst.predict(dm, pred_leaf=True)
    out = []
    for t in range(leaves.shape[1]):
        idx, n = np.unique(leaves[:, t], return_counts=True)
        out.append(dict(zip(idx.tolist(), n.tolist())))
    return out


def paged_mesh(xt, dev, tmp):
    """The ``paged_mesh`` phase (module docstring): returns (the main-path
    runs' launch counts, a summary dict)."""
    from xgboost_tpu_torch.context import Mesh
    from xgboost_tpu_torch.obs import memory as obs_memory
    from xgboost_tpu_torch.obs import trace as obs_trace

    card = gpu_line()
    t_phase = time.perf_counter()
    env_keep = {k: os.environ.get(k) for k in (
        "XTPU_PAGED_COLLAPSE", "XTPU_PAGE_ROWS", "XTPU_PAGE_CACHE_BYTES")}
    os.environ.update(XTPU_PAGED_COLLAPSE="0",
                      XTPU_PAGE_ROWS=str(EXT_BATCH_ROWS),
                      XTPU_PAGE_CACHE_BYTES="0")
    runs, out = [], {"s_round": {}}
    try:
        t0 = time.perf_counter()
        dm = xt.QuantileDMatrix(higgs_batches(
            xt, PM_ROWS, 28, os.path.join(tmp, "pm")), max_bin=256)
        dres = xt.QuantileDMatrix(higgs_batches(xt, PM_ROWS, 28, None),
                                  max_bin=256, ref=dm)
        paged = dm.binned(256, dev)
        labels = dm.get_label()
        if not paged.is_paged or dres.is_paged:
            raise AssertionError("paged_mesh: the matrices' tiers")
        mesh = Mesh([dev] * PM_SHARDS)
        n_pad, n_loc, p_loc = paged.mesh_layout(PM_SHARDS)
        n_mesh = n_loc // p_loc
        unit = paged.mesh_page_nbytes(PM_SHARDS)
        log(f"paged_mesh: {PM_ROWS} x 28 in {paged.n_pages()} pages of "
            f"{paged.page_rows} (and resident) in "
            f"{time.perf_counter() - t0:.3f} s; {PM_SHARDS} shards of "
            f"{n_loc} rows, {n_mesh} mesh pages of {p_loc} rows a shard, "
            f"{unit} B each")
        out["shard_kernels"] = paged_shard_kernels(dev, paged, labels,
                                                   PM_SHARDS)
        p = dict(HIGGS_PARAMS)
        depth = p["max_depth"]

        def counted(label, params, data, rounds, want, **kw):
            """A run under the launch counts and a round clock; ``want``:
            {kernel: launches}; K5 never."""
            with NoPlainBuilds():
                bst, c, s = timed_train(xt, label, params, data, rounds,
                                        **kw)
            runs.append(c)
            for k, v in dict(want, fused_advance_coarse=0).items():
                if c[k] != v:
                    raise AssertionError(f"paged_mesh {label}: {k} launched "
                                         f"{c[k]} times, want {v}")
            out["s_round"][label] = s
            return bst, c, s

        def by_round(label, params, rounds, capped=False):
            """The paged mesh round by round from the resident mesh's
            model before it (a continuation walks its trees over the pages
            to the same margins) against the resident mesh's trees, under
            :func:`certified_trees` (the quantiser scales differ by
            design: a page's block against the shard's rows)."""
            res, cr, sr = timed_train(xt, f"{label} resident mesh",
                                      dict(params, mesh=mesh), dres, rounds)
            runs.append(cr)
            rows = rows_of_leaves(res, dres)
            per = len(res.gbm.trees) // rounds
            full, ties, gap = 0, {}, 0.0
            tp = res.tree_param
            for r in range(rounds):
                before = bytes(res[0:r].save_raw("ubj")) if r else None
                with NoPlainBuilds():
                    bst, c = train_launches(
                        f"{label} paged mesh round {r}", lambda: xt.train(
                            dict(params, mesh=mesh), dm, 1,
                            verbose_eval=False, xgb_model=before))
                runs.append(c)
                for k in range(per):
                    t = r * per + k
                    tie, g, _ = certified_trees(
                        bst.gbm.trees[t], res.gbm.trees[t],
                        f"paged mesh {label} tree {t}", tp.eta,
                        tp.reg_lambda, LOGISTIC_QUANTA, rows[t],
                        capped=capped)
                    gap = max(gap, g)
                    if tie:
                        ties[t] = tie
                    else:
                        full += 1
            if not full:
                raise AssertionError(f"paged mesh {label}: no tree the "
                                     "resident mesh's in full")
            log(f"paged_mesh {label} against the resident {PM_SHARDS}-shard "
                f"mesh, round by round: {full} of {len(res.gbm.trees)} "
                f"trees the same in full" + (f", near ties at {ties}"
                                             if ties else "")
                + f", largest leaf gap {gap:.3e}; resident mesh seconds a "
                f"round {sr} [{card}]")
            return {"full": full, "trees": len(res.gbm.trees), "ties": ties,
                    "gap": gap}

        # -- one device's paged round, 2 of 4 pages cached (the reference)
        paged.set_cache_budget(2 * paged.page_nbytes())
        one, c1, s1 = counted("one device 2 cached", p, dm, PM_ROUNDS,
                              {"hist_scan": paged.n_pages() * depth
                               * PM_ROUNDS, "hist_int8x2": 0})
        # -- auto on the mesh at 0, 2 and 4 mesh pages cached: one model
        digests, uploads = {}, {}
        k4 = PM_SHARDS * n_mesh * depth * PM_ROUNDS
        for k in PM_BUDGETS:
            paged.set_cache_budget(k * unit)
            paged.reset_ring_stats()
            bst, c, s = counted(f"auto mesh {k} cached", dict(p, mesh=mesh),
                                dm, PM_ROUNDS, {"hist_scan": k4,
                                                "hist_int8x2": 0,
                                                "hist_f32": 0})
            digests[k] = digest(bst)
            uploads[k] = paged.ring_stats["uploads"]
            want = PM_ROUNDS * (depth + 1) * (n_mesh - k) + k
            if uploads[k] != want or paged.cached_mesh_pages() != k:
                raise AssertionError(f"paged_mesh at {k} cached: {uploads[k]}"
                                     f" uploads, want {want}; "
                                     f"{paged.cached_mesh_pages()} cached")
        if len(set(digests.values())) != 1:
            raise AssertionError(f"paged_mesh: the budgets gave models "
                                 f"{digests}")
        out["sha"] = digests[0]
        log(f"paged_mesh auto ({PM_SHARDS} shards x {n_mesh} mesh pages, "
            f"{PM_ROUNDS} rounds): one sha256 {digests[0][:16]}... at "
            f"{PM_BUDGETS} mesh pages cached; K4 {k4} a run = shards x "
            f"pages x levels x rounds, K5 0; uploads {uploads}; seconds a "
            f"round " + ", ".join(f"{k} cached {out['s_round'][f'auto mesh {k} cached']}"
                                  for k in PM_BUDGETS)
            + f"; one device (2 of 4 cached) {s1} [{card}]")
        out["certified"] = {"auto": by_round("auto", p, PM_ROUNDS)}
        # -- scan at 2 cached: K2 for each block's coarse build, K4 fine
        paged.set_cache_budget(2 * unit)
        sc, _, _ = counted("scan mesh 2 cached", dict(
            p, mesh=mesh, hist_method="scan"), dm, PM_ROUNDS,
            {"hist_scan": k4, "hist_int8x2": k4, "hist_f32": 0})
        out["certified"]["scan"] = by_round("scan", dict(
            p, hist_method="scan"), 1)
        # -- depth 10, every page cached: K3 at the levels of 256 and 512
        paged.set_cache_budget(n_mesh * unit)
        blocks = PM_SHARDS * n_mesh
        counted("depth 10 mesh", dict(p, mesh=mesh, max_depth=PM_DEEP_DEPTH),
                dm, 1, {"hist_scan": blocks * 8, "hist_f32": blocks * 2})
        out["certified"]["depth 10"] = by_round(
            "depth 10", dict(p, max_depth=PM_DEEP_DEPTH), 1)
        # -- lossguide at 64 leaves, 2 of 4 cached: K4 a block and pair
        paged.set_cache_budget(2 * unit)
        lg = dict(p, grow_policy="lossguide", max_leaves=PM_LG_LEAVES,
                  max_depth=0)
        out["certified"]["lossguide"] = by_round("lossguide", lg,
                                                  PM_LG_ROUNDS, capped=True)
        lg_k4 = sum(c["hist_scan"] for c in runs[-PM_LG_ROUNDS:])
        if lg_k4 % blocks or not lg_k4:
            raise AssertionError(f"paged_mesh lossguide: K4 {lg_k4}, not "
                                 f"{blocks} a pair")
        log(f"paged_mesh lossguide {PM_LG_LEAVES} leaves: K4 {lg_k4} = "
            f"{blocks} blocks x {lg_k4 // blocks} pair builds in "
            f"{PM_LG_ROUNDS} rounds")
        # -- the traced round: spans a level, the memory peak, same model
        paged.set_cache_budget(2 * unit)
        untraced, _ = train_launches("traced round, untraced twin",
                                     lambda: xt.train(dict(p, mesh=mesh),
                                                      dm, 1,
                                                      verbose_eval=False))
        obs_trace.enable()
        obs_trace.set_sync(True)
        mon = obs_memory.enable()
        try:
            traced, c = train_launches("traced round", lambda: xt.train(
                dict(p, mesh=mesh), dm, 1, verbose_eval=False))
            path = os.path.join(tmp, "paged_mesh_trace.json")
            n_spans = obs_trace.export(path)
            spans = obs_trace.tracer().spans()
            peaks = mon.round_peaks()
        finally:
            obs_trace.set_sync(False)
            obs_trace.disable()
            obs_memory.disable()
        runs.append(c)
        if digest(traced) != digest(untraced):
            raise AssertionError("paged_mesh: the traced round's model "
                                 "differs from the untraced one")
        doc = json.load(open(path))
        if len([e for e in doc["traceEvents"] if e["ph"] == "X"]) != n_spans:
            raise AssertionError("paged_mesh: the Perfetto export lost spans")
        level = {}
        for s in spans:
            level[s.name] = level.get(s.name, 0.0) + s.dur
        hist = [s.args["depth"] for s in spans if s.name == "paged/hist"]
        if hist != list(range(depth)):
            raise AssertionError(f"paged_mesh trace: paged/hist at depths "
                                 f"{hist}")
        out["trace"] = {k: v / depth for k, v in sorted(level.items())
                        if k.startswith(("paged/", "ring/"))}
        out["trace_round"] = {k: level[k] for k in sorted(level)
                              if k.startswith("Booster.")}
        out["peak_round"] = peaks
        log(f"paged_mesh traced round ({n_spans} spans, Perfetto JSON "
            f"{os.path.getsize(path)} B; sync armed; the untraced model's "
            f"bytes): seconds a level "
            + ", ".join(f"{k} {v:.6f}" for k, v in out["trace"].items())
            + "; the round's sections " + ", ".join(
                f"{k} {v:.6f} s" for k, v in out["trace_round"].items())
            + f"; device memory peak of the round {peaks} B (the "
            f"allocator's, over {PM_SHARDS} shards of one card) [{card}]")
        # -- MediaMill vector leaves on 2 shards, pages of 8,192 rows
        Xm, Ym = mediamill_like(EXT_SEED)
        Xm, Ym = Xm[:MM_TRAIN_ROWS], Ym[:MM_TRAIN_ROWS]
        os.environ["XTPU_PAGE_ROWS"] = str(PLO_MM_PAGE_ROWS)
        dmm = xt.QuantileDMatrix(typed_batches(
            xt, Xm, Ym, PLO_MM_PAGE_ROWS, None, f"{tmp}/pm_mm"), max_bin=256)
        pmm = dmm.binned(256, dev)
        m2 = Mesh([dev] * PM_MM_SHARDS)
        _, mm_loc, mm_p = pmm.mesh_layout(PM_MM_SHARDS)
        pmm.set_cache_budget(2 * pmm.mesh_page_nbytes(PM_MM_SHARDS))
        mm_blocks = PM_MM_SHARDS * (mm_loc // mm_p)
        bmm, _, smm = counted("vector leaves mesh", dict(
            MM_PARAMS, multi_strategy="multi_output_tree", mesh=m2), dmm,
            PM_MM_ROUNDS, {"hist_int8x2": mm_blocks * MM_LABELS
                           * MM_PARAMS["max_depth"] * PM_MM_ROUNDS,
                           "hist_scan": 0})
        if bmm.gbm.trees[0].leaf_value.shape[1] != MM_LABELS:
            raise AssertionError("paged_mesh: no vector leaves")
        log(f"paged_mesh vector leaves ({MM_TRAIN_ROWS} x {MM_FEATURES}, "
            f"{MM_LABELS} labels, {PM_MM_SHARDS} shards x {mm_loc // mm_p} "
            f"mesh pages of {mm_p} rows, 2 cached): seconds a round {smm}")
        # -- the card against the CPU port on the same pages and mesh
        gaps = {}
        os.environ["XTPU_PAGE_ROWS"] = str(PM_GAP_ROWS // 2)
        dg = xt.QuantileDMatrix(higgs_batches(
            xt, PM_GAP_ROWS, 28, f"{tmp}/pm_gap"), max_bin=256)
        pg = dg.binned(256, dev)
        pg.set_cache_budget(pg.mesh_page_nbytes(PM_GAP_SHARDS))
        gaps["HIGGS"] = paged_card_against_cpu(
            xt, "paged mesh card vs CPU", dict(
                p, mesh=Mesh([dev] * PM_GAP_SHARDS)), dg, dev,
            cpu_extra={"mesh": Mesh(["cpu"] * PM_GAP_SHARDS)})
        out["card_cpu"] = gaps
    finally:
        for k, v in env_keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["phase_s"] = time.perf_counter() - t_phase
    return runs, out


# the continuous_pipeline phase (``continuous_pipeline``): the train ->
# serve loop at the HIGGS width, 4 pages of 250,000 rows of the HIGGS
# rule (its own seed) and 100,000 held-out rows
CP_SEED = 22
CP_PAGES = 4
CP_PAGE_ROWS = 250_000
CP_HOLDOUT = 100_000
CP_ROUNDS = 10                 # rounds an epoch: 40 rounds in all
CP_CHECKPOINT = 5
CP_CLIENTS = 3
CP_SIZES = (1, 512)
CP_CLI_ROWS = 100_000          # 2 CLI pages of 50,000 rows
CP_CLI_PAGE = 50_000
CP_INSIGHT_ROUNDS = 10
CP_FLIGHT_ROWS = 250_000
CP_WORLD = 4
CP_STAGES = ("ingest", "train", "gates", "artifact", "swap", "canary")


def write_libsvm_rows(path, X, y):
    """Dense rows as ``label 0:v 1:v ...`` lines."""
    cols = [f"{j}:" for j in range(X.shape[1])]
    with open(path, "w") as fh:
        for lab, row in zip(y.tolist(), X.tolist()):
            fh.write(f"{int(lab)} " + " ".join(
                c + repr(v) for c, v in zip(cols, row)) + "\n")


def pipeline_stage_seconds(spans):
    """Each ``pipeline/<stage>`` span's seconds, summed (a step's spans)."""
    out = {s: 0.0 for s in CP_STAGES}
    for s in spans:
        if s.name.startswith("pipeline/") and s.name[9:] in out:
            out[s.name[9:]] += s.t1 - s.t0
    return out


_CHILDREN = []


def spawn_python(tmp, tag, *args):
    """``python args`` (``-m module ...`` or ``-c code ...``) started in
    the background from the root of the checkout, its output to files
    under ``tmp`` -> a handle for :func:`finish_module`
    (:func:`stop_children` ends any left running)."""
    out = open(os.path.join(tmp, f"{tag}.out"), "w+")
    err = open(os.path.join(tmp, f"{tag}.err"), "w+")
    proc = subprocess.Popen([sys.executable, *args], stdout=out, stderr=err,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    _CHILDREN.append(proc)
    return proc, out, err


def stop_children():
    """Kill every :func:`spawn_python` process still running."""
    while _CHILDREN:
        proc = _CHILDREN.pop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_module(handle, timeout=600):
    """Wait for a :func:`spawn_python` process -> (exit code, its stdout,
    its stderr); a process past ``timeout`` is killed and raises."""
    proc, out, err = handle
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    texts = []
    for fh in (out, err):
        fh.seek(0)
        texts.append(fh.read())
        fh.close()
    return rc, texts[0], texts[1]


def continuous_pipeline(xt, dev, tmp, dtr, dte):
    """The ``continuous_pipeline`` phase (module docstring): returns (the
    main-path runs' launch counts, a summary dict)."""
    from xgboost_tpu_torch.context import Mesh
    from xgboost_tpu_torch.obs import insight as obs_insight
    from xgboost_tpu_torch.obs import trace as obs_trace
    from xgboost_tpu_torch.obs.flight import FlightRecorder, verify_bundle
    from xgboost_tpu_torch.ops import histogram as H
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.parallel.collective import InMemoryCommunicator
    from xgboost_tpu_torch.pipeline import (GateRule, KilledByChaos,
                                            Pipeline, PipelineConfig,
                                            PipelineFaultPlan)
    from xgboost_tpu_torch.serve import Server
    from xgboost_tpu_torch.tree.shards import RowShards

    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    runs, out = [], {}
    pages = [higgs_batch(CP_SEED, i, CP_PAGE_ROWS, 28)
             for i in range(CP_PAGES)]
    Xh, yh = higgs_batch(CP_SEED, 99, CP_HOLDOUT, 28)
    params = dict(HIGGS_PARAMS)

    def config(workdir, **kw):
        return PipelineConfig(
            workdir=os.path.join(tmp, workdir), params=params,
            rounds_per_epoch=CP_ROUNDS, checkpoint_every=CP_CHECKPOINT,
            gates=(GateRule("auc", max_regression=0.01),
                   GateRule("logloss", max_regression=0.01)), **kw)

    def artifacts(workdir):
        d = os.path.join(tmp, workdir, "models")
        return {fn: hashlib.sha256(open(os.path.join(d, fn), "rb").read())
                .hexdigest() for fn in sorted(os.listdir(d))
                if fn.endswith(".ubj")}

    # -- 1. the uninterrupted run, served while it promotes
    srv = Server(max_batch=512)
    pipe = Pipeline(config("run"), server=srv, holdout=(Xh, yh))
    answers, failures, seen, stop = [], [], set(), threading.Event()

    def client(tid):
        i = tid
        while not stop.is_set():
            n = CP_SIZES[i % len(CP_SIZES)]
            lo = (i * 7919) % (CP_HOLDOUT - n)
            try:
                got = srv.predict(Xh[lo:lo + n])
                seen.add(got.version)
                if i % 5 == 0:
                    answers.append((got.version, lo, n, np.asarray(got)))
            except Exception as err:  # noqa: BLE001 - the check's target
                failures.append(repr(err))
            i += CP_CLIENTS
            time.sleep(0.005)

    obs_trace.enable(capacity=1 << 16)
    epochs = []
    threads = []
    reset_counts()
    t_run = time.perf_counter()
    try:
        with NoPlainBuilds():
            for e in range(CP_PAGES):
                obs_trace.reset()
                t0 = time.perf_counter()
                rep = pipe.step(*pages[e])
                secs = time.perf_counter() - t0
                if not threads:
                    threads = [threading.Thread(target=client, args=(t,))
                               for t in range(CP_CLIENTS)]
                    for t in threads:
                        t.start()
                epochs.append((secs, pipeline_stage_seconds(
                    obs_trace.tracer().spans()), rep))
        # the clients go on until the last promotion has answered
        t0 = time.perf_counter()
        while CP_PAGES not in seen and time.perf_counter() - t0 < 10:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join()
        obs_trace.disable()
    t_run = time.perf_counter() - t_run
    torch.cuda.synchronize()
    c_run = read_counts()
    runs.append(c_run)
    srv.close()
    actions = [r["action"] for _, _, rep in epochs for r in rep]
    if actions != ["promoted"] * CP_PAGES or \
            pipe.status()["promotions"] != CP_PAGES:
        raise AssertionError(f"continuous_pipeline: decisions {actions}")
    if failures:
        raise AssertionError(f"continuous_pipeline: {len(failures)} "
                             f"requests failed: {failures[:3]}")
    want = {k: 0 for k in K.LAUNCHES}
    want["hist_scan"] = HIGGS_PARAMS["max_depth"] * CP_PAGES * CP_ROUNDS
    if {k: c_run[k] for k in K.LAUNCHES} != want or \
            c_run["walk_packed"] < 1:
        raise AssertionError(f"continuous_pipeline launched {c_run}, want "
                             f"{want} and K1")
    versions = sorted({v for v, _, _, _ in answers})
    if sorted(seen) != list(range(1, CP_PAGES + 1)):
        raise AssertionError(f"continuous_pipeline: the clients were "
                             f"answered by versions {sorted(seen)}")
    preds = {}
    for v in versions:
        path = os.path.join(tmp, "run", "models", f"v{v:06d}.ubj")
        preds[v] = xt.Booster({"device": str(dev)}, model_file=open(
            path, "rb").read()).predict(xt.DMatrix(Xh))
    for v, lo, n, got in answers:
        if not np.array_equal(got, preds[v][lo:lo + n]):
            raise AssertionError(f"continuous_pipeline: an answer of "
                                 f"version {v} ({n} rows at {lo}) differs "
                                 "from its artifact's Booster.predict")
    ll = [rep[0]["scores"]["logloss"] for _, _, rep in epochs]
    aucs = [rep[0]["scores"]["auc"] for _, _, rep in epochs]
    if not all(b < a for a, b in zip(ll, ll[1:])):
        raise AssertionError(f"continuous_pipeline: holdout logloss {ll}")
    promo_ms = [rep[0]["promotion_ms"] for _, _, rep in epochs]
    ref = artifacts("run")
    out.update(run_s=t_run, epochs=[(s, st) for s, st, _ in epochs],
               promotion_ms=promo_ms, logloss=ll, auc=aucs,
               requests=len(answers) * 5, versions=versions)
    log(f"continuous_pipeline: {CP_PAGES} epochs of {CP_PAGE_ROWS} x 28 "
        f"rows ({CP_ROUNDS} rounds each, {CP_PAGES * CP_PAGE_ROWS} rows at "
        f"the end) in "
        f"{t_run:.3f} s; decisions {actions}; holdout logloss {ll}, AUC "
        f"{aucs}; ~{len(answers) * 5} requests from {CP_CLIENTS} clients "
        f"answered by versions {sorted(seen)}, none failed, the sampled "
        f"{len(answers)} equal to their artifact's Booster.predict bit for "
        f"bit; launches K4 {c_run['hist_scan']} "
        f"({c_run['hist_scan'] // (CP_PAGES * CP_ROUNDS)} a round), K1 "
        f"{c_run['walk_packed']}, K2 / K3 / K5 0 [{card}]")
    for e, (secs, st, _) in enumerate(epochs):
        log(f"continuous_pipeline epoch {e}: {secs:.3f} s; "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
            + f" s; promotion latency (manifest commit to serving) "
            f"{promo_ms[e]:.3f} ms [{card}]")

    # -- 6 (started here, checked after the canary). The CLI's pipeline
    # mode as a subprocess, beside the recovery and canary runs
    t_cli = time.perf_counter()
    Xc, yc = higgs_batch(CP_SEED, 50, CP_CLI_ROWS, 28)
    Xch, ych = higgs_batch(CP_SEED, 51, 20_000, 28)
    data, hold = os.path.join(tmp, "cli.libsvm"), \
        os.path.join(tmp, "cli_holdout.libsvm")
    write_libsvm_rows(data, Xc, yc)
    write_libsvm_rows(hold, Xch, ych)
    wd = os.path.join(tmp, "cli")
    cli = spawn_python(tmp, "cli", "-m", "xgboost_tpu_torch", "pipeline",
                       f"workdir={wd}", f"data={data}", f"holdout={hold}",
                       "gate=auc:0.01", f"page_rows={CP_CLI_PAGE}",
                       "objective=binary:logistic", "max_depth=8",
                       "eta=0.1", "max_bin=256", f"device={dev.type}")

    # -- 2. crash recovery: two kills, then a clean finish, in a new workdir
    t0 = time.perf_counter()
    bundles = []
    reset_counts()
    with NoPlainBuilds():
        plan = PipelineFaultPlan(kill_stage="mid_epoch", kill_epoch=1,
                                 kill_round=CP_ROUNDS + CP_ROUNDS // 2,
                                 corrupt_newest_snapshot=True)
        p1 = Pipeline(config("crash"), holdout=(Xh, yh), chaos=plan)
        try:
            for e in range(2):
                p1.step(*pages[e])
            raise AssertionError("continuous_pipeline: no mid_epoch kill")
        except KilledByChaos as err:
            bundles.append(err.bundle)
        plan = PipelineFaultPlan(kill_stage="post_manifest", kill_epoch=2)
        p2 = Pipeline(config("crash"), holdout=(Xh, yh), chaos=plan)
        try:
            p2.run_pending()
            p2.step(*pages[2])
            raise AssertionError("continuous_pipeline: no post_manifest "
                                 "kill")
        except KilledByChaos as err:
            bundles.append(err.bundle)
        # both bundles rendered by the CLI beside the clean finish
        render = spawn_python(tmp, "postmortem", "-m",
                              "xgboost_tpu_torch.obs", "postmortem",
                              *bundles)
        p3 = Pipeline(config("crash"), holdout=(Xh, yh))
        p3.run_pending()
        p3.step(*pages[3])
        got = artifacts("crash")
        if got != ref:
            raise AssertionError(f"continuous_pipeline: recovered artifacts "
                                 f"{got} against {ref}")
        replay = p3._replay_model(CP_PAGES - 1)
        last = open(os.path.join(tmp, "run", "models",
                                 f"v{CP_PAGES:06d}.ubj"), "rb").read()
        if bytes(replay.save_raw("ubj")) != last:
            raise AssertionError("continuous_pipeline: the page log's "
                                 "replay differs from the last artifact")
    torch.cuda.synchronize()
    runs.append(read_counts())
    peaks = []
    for b in bundles:
        doc = verify_bundle(b)
        devs = (doc.get("memory") or {}).get("devices") or []
        if not devs or devs[0]["name"] != name or \
                devs[0]["peak_bytes"] <= 0:
            raise AssertionError(f"continuous_pipeline: bundle {b} memory "
                                 f"{doc.get('memory')}")
        peaks.append(devs[0]["peak_bytes"])
    out["recovery_s"] = time.perf_counter() - t0

    # -- 3. one canary rollback
    t0 = time.perf_counter()
    reset_counts()
    srv = Server(max_batch=512)
    with NoPlainBuilds():
        pc = Pipeline(config("canary", canary_max_regression=-0.9),
                      server=srv, holdout=(Xh, yh))
        pc.step(*pages[0])
        oracle = np.asarray(srv.predict(Xh[:512]))
        rep = pc.step(*pages[1])
    torch.cuda.synchronize()
    runs.append(read_counts())
    again = np.asarray(srv.predict(Xh[:512]))
    if rep[0]["action"] != "rolled_back" or \
            srv.registry.get("model").version != 1 or \
            not np.array_equal(again, oracle) or \
            pc.manifest.state["rolled_back"] != [2] or \
            pc.manifest.active["version"] != 1:
        raise AssertionError(f"continuous_pipeline canary: {rep}")
    srv.close()
    canary = rep[0]["canary"]
    log(f"continuous_pipeline canary: {canary['metric']} "
        f"{canary['candidate']:.6f} against {canary['baseline']:.6f} "
        f"(allowed -0.9): rolled back to v1, the Server's answers v1's bit "
        f"for bit, the manifest lists v2 rolled back; "
        f"{time.perf_counter() - t0:.3f} s [{card}]")

    rc, _, err = finish_module(cli)
    if rc != 0:
        raise AssertionError(f"continuous_pipeline CLI: exit {rc}: "
                             f"{err[-3000:]}")
    from xgboost_tpu_torch.pipeline.cli import _status

    st = _status(wd)
    if st["promotions"] != 2 or st["pages"] != 2:
        raise AssertionError(f"continuous_pipeline CLI status: {st}")
    log(f"continuous_pipeline CLI: python -m xgboost_tpu_torch pipeline on "
        f"{CP_CLI_ROWS} libsvm rows in pages of {CP_CLI_PAGE} (beside the "
        f"recovery and canary runs): exit 0, command=status "
        f"{st['promotions']} promotions, active version "
        f"{st['active_version']}; {time.perf_counter() - t_cli:.3f} s from "
        f"its start [{card}]")

    rc, text, err = finish_module(render)
    if rc != 0 or text.count("postmortem: chaos-kill") != 2 or \
            name not in text:
        raise AssertionError(f"continuous_pipeline: postmortem exit {rc}: "
                             f"{text[-2000:]} {err[-2000:]}")
    log(f"continuous_pipeline recovery: killed mid_epoch (epoch 1, round "
        f"{CP_ROUNDS // 2}, newest snapshot torn) and post_manifest (epoch "
        f"2), then "
        f"finished: {len(got)} artifacts with run 1's sha256; the page "
        f"log's replay of epoch {CP_PAGES - 1} the last artifact's bytes; "
        f"2 bundles verified and rendered by python -m "
        f"xgboost_tpu_torch.obs postmortem (exit 0), CUDA allocator peaks "
        f"{peaks} B on {name}; {out['recovery_s']:.3f} s (the rendering "
        f"beside it) [{card}]")

    # -- 5. the flight recorder over a 4-rank thread world
    t0 = time.perf_counter()
    comms = InMemoryCommunicator.make_world(CP_WORLD)
    inputs = [hist_inputs(CP_FLIGHT_ROWS, 28, 256, 128, dev, seed=300 + r)
              for r in range(CP_WORLD)]
    results, errs = [None] * CP_WORLD, []
    # the launch counters are read-modify-writes: one launch at a time
    launching = threading.Lock()

    def rank(r):
        try:
            rec = FlightRecorder(comm=comms[r], tracer=obs_trace.Tracer(
                4096, annotate_device=False))
            bins, gpair, rel = inputs[r]
            shards = RowShards([bins], Mesh([dev], comm=comms[r]))
            with rec.span("flight/hist", "train"), launching:
                q, inv = H.quantise_int8x2(gpair)
                h = K.hist_scan_cuda(bins, q, rel, inv, 128, 256)
            with rec.span("flight/reduce", "train"):
                total = shards.reduce([h], label="flight/hist")
            clk = rec.sync_clocks(pings=8)
            path = os.path.join(tmp, f"ring_{r}.json")
            rec.export_ring(path)
            results[r] = (path, clk, h, total)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append((r, repr(e)))

    reset_counts()
    ts = [threading.Thread(target=rank, args=(r,)) for r in range(CP_WORLD)]
    with NoPlainBuilds():
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    torch.cuda.synchronize()
    c_fl = read_counts()
    runs.append(c_fl)
    if errs or c_fl["hist_scan"] != CP_WORLD:
        raise AssertionError(f"continuous_pipeline flight: {errs} {c_fl}")
    # each rank's K4 histogram against its plain version, and every
    # rank's reduction against their sum
    want_total = 0
    for r, (bins, gpair, rel) in enumerate(inputs):
        q, inv = H.quantise_int8x2(gpair)
        plain = H.build_hist_scan_reference(bins, q, rel, inv, 128, 256)
        if not torch.equal(results[r][2], plain):
            raise AssertionError(f"continuous_pipeline flight: rank {r}'s "
                                 "K4 histogram differs from its plain "
                                 "version")
        want_total = want_total + plain
    for r in results:
        if not torch.allclose(r[3], want_total, rtol=1e-6, atol=1e-3):
            raise AssertionError("continuous_pipeline flight: a rank's "
                                 "reduced histogram is not the ranks' sum")
    merged = os.path.join(tmp, "merged.json")
    merge = spawn_python(tmp, "merge", "-m", "xgboost_tpu_torch.obs",
                         "merge", *[r[0] for r in results], "-o", merged)
    t_flight = time.perf_counter() - t0

    # -- 4. insight on the main path's 1M-row matrix
    t0 = time.perf_counter()
    p_ins = dict(HIGGS_PARAMS, eval_metric=["logloss", "error"])
    ev = [(dte, "test")]
    res_off, res_on = {}, {}
    with NoPlainBuilds():
        t1 = time.perf_counter()
        off, c_off = train_launches("insight disarmed", lambda: xt.train(
            p_ins, dtr, CP_INSIGHT_ROUNDS, evals=ev, evals_result=res_off,
            verbose_eval=False))
        t_off = time.perf_counter() - t1
        obs_insight.enable(eval=True)
        try:
            t1 = time.perf_counter()
            on, c_on = train_launches("insight armed", lambda: xt.train(
                p_ins, dtr, CP_INSIGHT_ROUNDS, evals=ev, evals_result=res_on,
                verbose_eval=False))
            t_on = time.perf_counter() - t1
            timer_on, _, s_on = seconds_per_round(HIGGS_PARAMS, dtr)
            busy_on, _ = profile_rounds("insight armed", timer_on, dtr,
                                        top=4)
        finally:
            obs_insight.disable()
        timer_off, _, s_off = seconds_per_round(HIGGS_PARAMS, dtr)
        busy_off, _ = profile_rounds("insight disarmed", timer_off, dtr,
                                     top=4)
    runs += [c_off, c_on]
    if digest(on) != digest(off) or on._insight_blocked or \
            timer_on._insight_blocked:
        raise AssertionError("continuous_pipeline insight: the armed model "
                             "differs or the telemetry latch tripped")
    recs = on.training_log.records
    if len(recs) != CP_INSIGHT_ROUNDS or any(
            "grad_norm" not in r or "hess_norm" not in r
            or len(r["gain_per_level"]) != HIGGS_PARAMS["max_depth"]
            for r in recs):
        raise AssertionError(f"continuous_pipeline insight: records "
                             f"{recs[:1]}")
    ins = on._insight_scores
    p_te = on.predict(dte)
    for m in ("logloss", "error"):
        host = float(xt.metric.get_metric(m)(p_te, dte.info))
        carry = ins["scores"][("test", m)]
        if abs(carry - host) > 1e-6 * abs(host):
            raise AssertionError(f"continuous_pipeline insight: in-carry "
                                 f"{m} {carry} against the host's {host}")
        gap = max(abs(a - b) for a, b in zip(res_on["test"][m],
                                             res_off["test"][m]))
        if gap > 1e-6:
            raise AssertionError(f"continuous_pipeline insight: {m} history "
                                 f"{res_on['test'][m]} / "
                                 f"{res_off['test'][m]}")
    out["insight"] = {"s_round": (s_on, s_off), "busy": (busy_on, busy_off),
                      "train_s": (t_on, t_off)}
    log(f"continuous_pipeline insight: {CP_INSIGHT_ROUNDS} rounds on "
        f"1,000,000 x 28 with the in-carry eval of 100,000 rows armed: "
        f"sha256 {digest(on)[:16]} the disarmed run's, every record with "
        f"grad_norm, hess_norm and {HIGGS_PARAMS['max_depth']} "
        f"gain_per_level entries, in-carry scores the host path's within "
        f"rtol 1e-6; train {t_on:.3f} / {t_off:.3f} s armed / not, seconds "
        f"a round {s_on:.6f} / {s_off:.6f}, device busy over 3 profiled "
        f"rounds {busy_on:.3f} / {busy_off:.3f} ms; "
        f"{time.perf_counter() - t0:.3f} s [{card}]")

    rc, _, err = finish_module(merge)
    with open(merged) as fh:
        doc = json.load(fh)
    tracks = {e["pid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "process_name"]
    clocks = [r[1] for r in results]
    if rc != 0 or tracks != set(range(CP_WORLD)) or \
            len(names) != CP_WORLD or \
            any(abs(c.offset_s) > c.err_s for c in clocks):
        raise AssertionError(f"continuous_pipeline flight: merge exit "
                             f"{rc} {err[-1000:]}, "
                             f"tracks {tracks}, clocks "
                             f"{[c.to_dict() for c in clocks]}")
    us = [(round(c.offset_s * 1e6, 1), round(c.err_s * 1e6, 1))
          for c in clocks]
    log(f"continuous_pipeline flight: {CP_WORLD} thread ranks, each one K4 "
        f"histogram of {CP_FLIGHT_ROWS} x 28 reduced through RowShards; "
        f"python -m xgboost_tpu_torch.obs merge: one track a rank; clock "
        f"offsets / uncertainty {us} us; {t_flight:.3f} s, the merge "
        f"beside the insight runs [{card}]")

    out["phase_s"] = time.perf_counter() - t_phase
    per_epoch = [s for s, _ in out["epochs"]]
    log(f"continuous_pipeline: seconds an epoch {per_epoch}, by stage "
        + "; ".join(f"{k} {[round(st[k], 3) for _, st in out['epochs']]}"
                    for k in CP_STAGES)
        + f"; promotion latency {promo_ms} ms; insight seconds a round "
        f"{s_on:.6f} armed / {s_off:.6f} not, device busy {busy_on:.3f} / "
        f"{busy_off:.3f} ms over 3 rounds; phase {out['phase_s']:.1f} s "
        f"[{card}]")
    return runs, out


def train_launches(name, train):
    """Run ``train()`` with every launch count set to 0 just before and
    read just after; returns (its result, the counts)."""
    reset_counts()
    out = train()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{name}: launches {counts}")
    return out, counts


def reset_counts():
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W

    W.LAUNCHES = 0
    for k in W.SCHEDULE_LAUNCHES:
        W.SCHEDULE_LAUNCHES[k] = 0
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def read_counts():
    """Launches of every kernel since ``reset_counts``; K1 in all and per
    schedule (``walk_spread``, ``walk_staged``)."""
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W

    return {"walk_packed": W.LAUNCHES,
            **{f"walk_{k}": v for k, v in W.SCHEDULE_LAUNCHES.items()},
            **dict(K.LAUNCHES)}


def levels_of(root: str) -> int:
    """``--levels-of``: K4's and K5's level times and K1's main-path times
    with the port in ``root`` (:func:`time_levels`, :func:`time_walk`,
    through the calls every version has)."""
    sys.path.insert(0, os.path.abspath(root))
    import xgboost_tpu_torch
    from xgboost_tpu_torch.ops.cuda import build

    if not xgboost_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {xgboost_tpu_torch.__file__}, not "
                             f"the port in {root}")
    card = gpu_line()
    log(f"gpu: {card}; port from {os.path.abspath(root)}")
    build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    levels = time_levels(torch.device("cuda"), flush, current=False)
    walk = time_walk(torch.device("cuda"), flush, current=False)
    models = model_digests()
    print(json.dumps({"levels_of": os.path.abspath(root), "levels": levels,
                      "walk": walk, "models": models}))
    print(card)
    return 0


def rounds_of(root: str) -> int:
    """``--rounds-of``: seconds a round with the port in ``root``, through
    the calls every version has: :func:`seconds_per_round` of ``auto``,
    ``coarse``, ``fused`` and ``scan`` on 1,000,000 x 28 of
    ``higgs_like`` at depth 8 (the main path's runs), and
    :func:`paged_rounds` of the external-memory phase's matrices (11
    pages of 1,000,000 rows, 4 of them cached: ``auto``, 6 rounds; its
    u4 run at ``max_bin`` 16, 4 rounds). Prints one JSON line with every
    round's seconds and the medians after the first."""
    sys.path.insert(0, os.path.abspath(root))
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops.cuda import build

    if not xt.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {xt.__file__}, not the port in "
                             f"{root}")
    card = gpu_line()
    log(f"gpu: {card}; port from {os.path.abspath(root)}")
    build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    dev = torch.device("cuda")
    X, y = higgs_like(1_000_000, 28, seed=0)
    dtr = xt.DMatrix(X, label=y)
    out = {}
    for method in ("auto", "coarse", "fused", "scan"):
        _, per, med = seconds_per_round(dict(HIGGS_PARAMS,
                                             hist_method=method), dtr)
        out[method] = {"rounds": per, "median": med}
        log(f"rounds of {method}: {per}, median of rounds 1-5 {med:.6f} s")
    page = EXT_BATCH_ROWS * 28
    os.environ.update({"XTPU_PAGED_COLLAPSE": "0",
                       "XTPU_PAGE_CACHE_BYTES": str(EXT_CACHED_PAGES * page)})
    with tempfile.TemporaryDirectory(prefix="xtt_rounds_") as tmp:
        for label, max_bin, rounds in (("external memory", 256, 6),
                                       ("external memory u4", 16, 4)):
            dm = xt.QuantileDMatrix(higgs_batches(
                xt, EXT_ROWS, 28, f"{tmp}/b{max_bin}"), max_bin=max_bin)
            paged = dm.binned(max_bin, dev)
            _, per, _ = paged_rounds(xt, dict(HIGGS_PARAMS, max_bin=max_bin),
                                     dm, paged, rounds=rounds)
            secs = [r[0] for r in per]
            out[label] = {"rounds": secs,
                          "median": float(np.median(secs[1:])),
                          "uploads": [r[1] for r in per],
                          "overlap": [r[3] for r in per]}
            log(f"rounds of {label}: {secs}, median after the first "
                f"{out[label]['median']:.6f} s, uploads "
                f"{out[label]['uploads']}, overlap {out[label]['overlap']}")
            del dm, paged
    print(json.dumps({"rounds_of": os.path.abspath(root), "card": card,
                      **out}))
    print(card)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--levels-of":
        return levels_of(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--rounds-of":
        return rounds_of(sys.argv[2])
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--levels-of DIR | --rounds-of DIR]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops.cuda import build
    from xgboost_tpu_torch.ops.cuda import hist as K
    from xgboost_tpu_torch.ops.cuda import walk as W
    from xgboost_tpu_torch.ops.walk import (walk_fold_kernel_order,
                                            walk_packed_reference)
    from xgboost_tpu_torch.serve import Server
    from xgboost_tpu_torch.serve.packed import PackedForest, tree_step
    from xgboost_tpu_torch.testing import make_forest, make_forest_model

    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # the plain version's leaf matmul must run in full f32
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls are not in full precision")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = build.build_all(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phase_line("build")

    # --------------------------------------------- kernel vs plain version
    rng = np.random.RandomState(0)
    raw = make_forest_model(500, 8, 28, seed=0)
    booster = xt.Booster(model_file=raw)
    slice_pf = booster.packed_forest()
    log(f"slice forest: {slice_pf.describe()} Tp="
        f"{slice_pf.tree_offsets.shape[0]}")
    base = torch.tensor(booster._base_np(), device=dev)

    def normal(n, f, nan=0.1):
        X = rng.randn(n, f).astype(np.float32)
        X[rng.rand(n, f) < nan] = np.nan
        return X

    # K1 on the HIGGS-shape forest at every server bucket, 100,000 and
    # 1,000,000 rows on the plan's schedule, and on the other schedule at
    # 512 and 100,000 rows; one row's margin the same bits in all of them
    Xk = torch.from_numpy(normal(1_000_000, 28)).to(dev)
    errs, row0 = [], {}
    for n in (*[1 << k for k in range(10)], 100_000, 1_000_000):
        e, m, sch = check_kernel(f"slice n={n}", slice_pf, Xk[:n], base)
        errs.append(e)
        row0[(n, sch)] = m[0]
    for n, sch in ((512, "staged"), (100_000, "spread")):
        e, m, took = check_kernel(f"slice n={n} forced", slice_pf, Xk[:n],
                                  base, schedule=sch)
        errs.append(e)
        row0[(n, took)] = m[0]
    if not all(torch.equal(v, row0[(1, "spread")]) for v in row0.values()):
        raise AssertionError(f"row 0's margin depends on its batch: "
                             f"{ {k: v.tolist() for k, v in row0.items()} }")
    log(f"row 0's margin has the same bits at {len(row0)} (rows, schedule) "
        f"pairs from 1 to 1,000,000 rows: {sorted(row0)}")
    del Xk
    trees, info = make_forest(300, 8, 28, n_groups=3, seed=1)
    pf3 = PackedForest.from_trees(trees, info, 3)
    if list(pf3.tree_info[:6]) != [0, 1, 2, 0, 1, 2]:
        raise AssertionError("3-group forest does not cycle its groups")
    base3 = torch.tensor([0.1, -0.2, 0.3], device=dev)
    X3 = torch.from_numpy(normal(100_000, 28)).to(dev)
    cats = (0, 5, 11)
    trees, info = make_forest(200, 8, 28, cat_features=cats, seed=2,
                              n_categories=40)
    pfc = PackedForest.from_trees(trees, info, 1)
    Xc = normal(100_000, 28)
    for c in cats:
        Xc[:, c] = rng.randint(-2, 45, 100_000)
        edge = rng.rand(100_000) < 0.1
        Xc[edge, c] = rng.choice([-0.5, 1e10, -1e10, np.nan, 39.9, 40.0],
                                 int(edge.sum()))
    Xc = torch.from_numpy(Xc).to(dev)
    basec = torch.tensor([0.25], device=dev)
    for n in (4096, 100_000):
        for sch in ("spread", "staged"):
            errs.append(check_kernel(f"3-group n={n}", pf3, X3[:n], base3,
                                     sch)[0])
            errs.append(check_kernel(f"categorical n={n}", pfc, Xc[:n],
                                     basec, sch)[0])
    # the eval walk's one tree (Tp = 1) at 100,000 rows; a forest wider
    # than 1,024 features (both schedules read X from global memory); a
    # deep forest whose trees overflow a chunk buffer
    trees, info = make_forest(1, 8, 28, seed=3)
    pf1 = PackedForest.from_trees(trees, info, 1)
    zero = torch.zeros(1, device=dev)
    _, _, took = check_kernel("Tp=1 n=100000", pf1, X3, zero)
    if took != "staged":
        raise AssertionError(f"the one-tree walk of 100,000 rows took {took}")
    trees, info = make_forest(64, 8, 1100, seed=4)
    pfw = PackedForest.from_trees(trees, info, 1)
    Xw = torch.from_numpy(normal(100_000, 1100)).to(dev)
    for n in (512, 100_000):
        errs.append(check_kernel(f"wide n={n}", pfw, Xw[:n], zero)[0])
    del Xw
    trees, info = make_forest(8, 15, 28, seed=5)
    pfd = PackedForest.from_trees(trees, info, 1)
    _, _, took = check_kernel("deep n=100000", pfd, X3, zero)
    biggest = int((pfd.slot_spans()[:, 1] - pfd.slot_spans()[:, 0]).max())
    if took != "spread":
        raise AssertionError(f"the deep forest's walk took {took}")
    log(f"deep forest (depth 15, largest tree {biggest} nodes) planned and "
        f"launched on the spread schedule at 100,000 rows")
    del X3, Xc
    torch.cuda.synchronize()

    phase_line("K1 checks")

    # ------------------------------------------ main path: Booster.predict
    n_big = 100_000
    Xbig = rng.randn(n_big, 28).astype(np.float32)
    dm = xt.DMatrix(Xbig)
    reset_counts()
    t0 = time.perf_counter()
    pred = booster.predict(dm)
    t_predict = time.perf_counter() - t0
    counts_predict = read_counts()
    launches_predict = counts_predict["walk_packed"]
    if launches_predict < 1 or counts_predict["walk_staged"] != \
            launches_predict:
        raise AssertionError(f"Booster.predict launched {counts_predict}, "
                             "expected K1 on the staged schedule")
    if pred.shape != (n_big,) or not np.isfinite(pred).all() \
            or not ((pred > 0) & (pred < 1)).all():
        raise AssertionError("Booster.predict gave no valid probabilities")
    log(f"Booster.predict: {n_big} rows in {t_predict * 1e3:.3f} ms "
        f"(host clock, includes H2D/D2H), kernel launches "
        f"{launches_predict} (spread {counts_predict['walk_spread']}, "
        f"staged {counts_predict['walk_staged']})")
    # the same rows through the plain version on the card
    d = slice_pf.device_arrays(dev)
    Xd = torch.from_numpy(Xbig).to(dev)
    ref_margin, ref_leaf = walk_packed_reference(
        d["words"], d["values"], d["tree_offsets"], d["tree_weight"],
        d["group_onehot"], Xd, base, max_depth=slice_pf.max_depth,
        tree_chunk=tree_step(n_big), leaf_index=True)
    margin = booster.predict(dm, output_margin=True)
    bound = sum_bound(slice_pf, ref_leaf, base, tree_step(n_big))
    err = np.abs(margin - ref_margin[:, 0].cpu().numpy())
    if (err > bound[:, 0].cpu().numpy()).any():
        raise AssertionError(f"slice margins off by {err.max()}")
    replica = walk_fold_kernel_order(d["values"][ref_leaf.long()],
                                     d["tree_weight"], d["tree_group"], base)
    if not np.array_equal(margin, replica[:, 0].cpu().numpy()):
        raise AssertionError("Booster.predict's margins differ from the "
                             "kernel-order fold")
    errs.append(float(err.max()))
    depth = torch.from_numpy(node_depths(slice_pf)).to(dev)
    visits_big = int(depth[ref_leaf.long()].sum())
    del ref_margin, ref_leaf
    log(f"slice vs plain: max_abs_err={err.max()} over {n_big} rows, "
        f"{visits_big} internal-node visits; Booster.predict's margins equal "
        f"the kernel-order fold bit for bit")

    phase_line("Booster.predict")

    # ----------------------------------------------- main path: the Server
    sizes = (1, 8, 64, 512)
    n_req, n_threads = 200, 4
    answers = [None] * n_req
    reset_counts()
    with Server(models={"higgs": raw}, max_batch=512) as srv:
        srv.warmup()

        def client(tid):
            for i in range(tid, n_req, n_threads):
                n = sizes[i % len(sizes)]
                lo = (i * 977) % (n_big - n)
                answers[i] = (lo, n, srv.predict(Xbig[lo:lo + n]))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        snap = srv.metrics_snapshot()
    counts_serve = read_counts()
    launches_serve = counts_serve["walk_packed"]
    if launches_serve < 1 or counts_serve["walk_spread"] != launches_serve:
        raise AssertionError(f"the Server launched {counts_serve}, expected "
                             "K1 on the spread schedule")
    for k, a in enumerate(answers):
        if a is None:
            raise AssertionError(f"request {k} got no answer")
        lo, n, got = a
        if not np.array_equal(np.asarray(got), pred[lo:lo + n]):
            raise AssertionError(
                f"request {k} ({n} rows at {lo}) differs from "
                "Booster.predict")
    e2e = snap["stages"]["e2e"]
    log(f"serve: {n_req} requests of {sizes} rows from {n_threads} threads "
        f"in {wall:.4f} s = {n_req / wall:.1f} req/s, "
        f"{sum(a[1] for a in answers) / wall:.1f} rows/s; "
        f"e2e p50 {e2e['p50_ms']} ms p99 {e2e['p99_ms']} ms; "
        f"batches {snap['counters'].get('batches')}, kernel launches "
        f"{launches_serve} (spread {counts_serve['walk_spread']}, staged "
        f"{counts_serve['walk_staged']}); answers equal Booster.predict "
        f"bit for bit")
    for st in ("queue", "pad", "h2d", "compute", "d2h"):
        s = snap["stages"][st]
        log(f"  stage {st}: p50 {s['p50_ms']} ms p99 {s['p99_ms']} ms")

    phase_line("Server")

    # ------------------------------ K2 / K3 / K4 against their plain versions
    F = 28
    hist_errs = {}
    for i, (n_rows, N, B, skew) in enumerate(HIST_CASES):
        bins, gpair, rel = hist_inputs(n_rows, F, B, N, dev, seed=10 + i,
                                       skew=skew)
        label = f"n={n_rows} N={N} B={B}{' skewed' if skew else ''}"
        for k, e in check_hist(bins, gpair, rel, N, B, label).items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)
        del bins, gpair, rel

    for i, (n_rows, N, B) in enumerate(TWO_LEVEL_CASES):
        ids, gpair, rel = two_level_inputs(n_rows, F, N, B, dev, seed=90 + i)
        kind = "coarse" if B == 20 else "refine"
        for k, e in check_hist(ids, gpair, rel, N, B,
                               f"{kind} ids n={n_rows} N={N} B={B}").items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)
        del ids, gpair, rel

    # -------------------- K5 and K4's coarse fold against their plain versions
    hist_errs["fused_advance_coarse"] = max(
        check_fused(n_rows, N, B, skew, dev, seed=60 + i)
        for i, (n_rows, N, B, skew) in enumerate(K5_CASES))
    hist_errs["hist_scan"] = max(
        [hist_errs["hist_scan"]]
        + [check_fold(n_rows, N, B, skew, dev, seed=70 + i)
           for i, (n_rows, N, B, skew) in enumerate(FOLD_CASES)])
    # ----------- K2's and K3's packed_u4 bodies against their plain versions
    for i, case in enumerate(U4_CASES):
        for k, e in check_u4(*case, dev, seed=120 + i).items():
            hist_errs[k] = max(hist_errs.get(k, 0.0), e)

    phase_line("K2-K5 checks")

    # -------------------------------------- main path: training, depth 8
    X, y, w_rule = higgs_like(1_100_000, F, seed=0, rule=True)
    dtr = xt.DMatrix(X[:1_000_000], label=y[:1_000_000])
    dte = xt.DMatrix(X[1_000_000:], label=y[1_000_000:])
    params = dict(HIGGS_PARAMS)
    rounds = 20
    res = {}
    t0 = time.perf_counter()
    bst, train_counts = train_launches("train depth 8", lambda: xt.train(
        params, dtr, rounds, evals=[(dtr, "train"), (dte, "test")],
        evals_result=res, verbose_eval=5))
    t_train = time.perf_counter() - t0
    if train_counts["hist_scan"] != 8 * rounds or \
            train_counts["hist_int8x2"] != 0 or \
            train_counts["hist_f32"] != 0 or \
            train_counts["fused_advance_coarse"] != 0:
        raise AssertionError(f"training launched {train_counts}, expected "
                             f"K4 8 times a round, K2, K3 and K5 never")
    if train_counts["walk_packed"] < rounds or \
            train_counts["walk_staged"] != train_counts["walk_packed"]:
        raise AssertionError("the held-out evaluation did not walk the "
                             "trees through K1's staged schedule")
    ll = res["train"]["logloss"]
    if not ll[-1] < ll[0]:
        raise AssertionError(f"train logloss did not fall: {ll}")
    p_te = bst.predict(dte)
    auc_te = auc(y[1_000_000:], p_te)
    if not (np.isfinite(p_te).all() and auc_te > 0.6):
        raise AssertionError(f"held-out AUC {auc_te}")
    again = xt.Booster(model_file=bst.save_raw("ubj"))
    if not np.array_equal(again.predict(dte), p_te):
        raise AssertionError("save_raw -> Booster(model_file=) predicts "
                             "other bits")
    log(f"train: {rounds} rounds of depth 8 on 1,000,000 x {F} in "
        f"{t_train:.3f} s (host clock, sketch and binning included); "
        f"train logloss {ll[0]} -> {ll[-1]}, test logloss "
        f"{res['test']['logloss'][-1]}, held-out AUC {auc_te:.6f}; "
        f"save_raw round trip predicts the same bits")

    # seconds per round: update() between two syncs, on the same matrix;
    # then three more rounds under torch.profiler, timed the same way, for
    # the device's busy and idle shares of those rounds
    timer, per_round, auto_s = seconds_per_round(params, dtr)
    log(f"seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per_round]}; median of rounds 1-5 "
        f"{auto_s:.6f} s")
    profile_rounds("auto", timer, dtr, top=16)

    phase_line("train depth 8")

    # ------------------------------------- main path: training, depth 10
    d10 = xt.DMatrix(X[:200_000], label=y[:200_000])
    deep, deep_counts = train_launches("train depth 10", lambda: xt.train(
        dict(params, max_depth=10), d10, 3, verbose_eval=False))
    if deep_counts["hist_scan"] != 8 * 3 or deep_counts["hist_f32"] != 2 * 3 \
            or deep_counts["hist_int8x2"] != 0:
        raise AssertionError(f"depth 10 launched {deep_counts}, expected K4 "
                             "8 and K3 2 times a round")
    if max(t.max_depth() for t in deep.gbm.trees) != 10:
        raise AssertionError("the depth-10 trees did not reach depth 10")
    # K3's share of a depth-10 round: its own kernels (the Fixed64
    # instantiations; the sort kernels it shares with K4 are not counted)
    timer10, _, s10 = seconds_per_round(dict(params, max_depth=10), d10)
    dev10, rows10 = profile_rounds("auto depth 10", timer10, d10, top=8)
    k3_ms = sum(e.self_device_time_total for e in rows10
                if "Fixed64" in e.key) / 1e3
    log(f"depth 10 on 200,000 rows: {s10:.6f} s a round (median of rounds "
        f"1-5, host clock); K3's kernels {k3_ms:.3f} ms of {dev10:.3f} ms "
        f"device busy over 3 rounds ({k3_ms / dev10 * 100:.2f}%)")

    phase_line("train depth 10")

    # ------------------------------- main path: training below 65,536 rows
    d50 = xt.DMatrix(X[:50_000], label=y[:50_000])
    res50 = {}
    _, small_counts = train_launches("train 50,000 rows", lambda: xt.train(
        params, d50, 5, evals=[(d50, "train")], evals_result=res50,
        verbose_eval=False))
    if small_counts["hist_int8x2"] != 8 * 5 or small_counts["hist_scan"] != 0 \
            or small_counts["hist_f32"] != 0:
        raise AssertionError(f"50,000 rows launched {small_counts}, expected "
                             "K2 8 times a round")
    ll50 = res50["train"]["logloss"]
    if not ll50[-1] < ll50[0]:
        raise AssertionError(f"train logloss did not fall: {ll50}")
    log(f"train 50,000 rows: logloss {ll50[0]} -> {ll50[-1]}")

    phase_line("train 50,000 rows")

    # ------------- main path: the two-level schedules at the HIGGS shape
    # launches a round at depth 8: K2 for every coarse and refine build
    # (coarse); K5 at the 7 level boundaries, K2 for the root's coarse
    # histogram and the 8 refines (fused); K4 with its fold at every level
    # (scan)
    two_rounds = 10
    per_round_k = {"coarse": {"hist_int8x2": 16},
                   "fused": {"fused_advance_coarse": 7, "hist_int8x2": 9},
                   "scan": {"hist_scan": 8}}
    auto_ll10 = res["test"]["logloss"][two_rounds - 1]
    auto_auc10 = auc(y[1_000_000:], bst.predict(
        dte, iteration_range=(0, two_rounds)))
    log(f"auto after {two_rounds} rounds: held-out logloss {auto_ll10}, "
        f"AUC {auto_auc10:.6f}; {auto_s:.6f} s a round")
    two_level, two_counts, raws = {}, {}, {}
    for method, want in per_round_k.items():
        p2 = dict(params, hist_method=method)
        r2 = {}
        b2, c2 = train_launches(f"train {method}", lambda p2=p2, r2=r2:
                                xt.train(p2, dtr, two_rounds,
                                         evals=[(dtr, "train"),
                                                (dte, "test")],
                                         evals_result=r2, verbose_eval=False))
        want = {k: want.get(k, 0) * two_rounds for k in K.LAUNCHES}
        if {k: c2[k] for k in K.LAUNCHES} != want:
            raise AssertionError(f"{method} launched {c2}, expected {want}")
        ll2 = r2["train"]["logloss"]
        if not ll2[-1] < ll2[0]:
            raise AssertionError(f"{method}: train logloss did not fall")
        p_te2 = b2.predict(dte)
        auc2 = auc(y[1_000_000:], p_te2)
        if not (np.isfinite(p_te2).all() and auc2 > 0.6):
            raise AssertionError(f"{method}: held-out AUC {auc2}")
        timer2, _, s2 = seconds_per_round(p2, dtr)
        profile_rounds(method, timer2, dtr, top=16)
        two_level[method] = (s2, r2["test"]["logloss"][-1], auc2)
        two_counts[method] = c2
        raws[method] = saved_bytes(b2)
        log(f"train {method}: {two_rounds} rounds of depth 8 on 1,000,000 x "
            f"{F}; train logloss {ll2[0]} -> {ll2[-1]}, held-out logloss "
            f"{two_level[method][1]}, AUC {auc2:.6f}; {s2:.6f} s a round "
            f"(median of rounds 1-5, host clock; auto {auto_s:.6f})")
    if not raws["coarse"] == raws["fused"] == raws["scan"]:
        raise AssertionError("coarse, fused and scan saved different models")
    log("coarse, fused and scan saved the same model bytes")

    phase_line("two-level schedules")

    # ------------------ main path: fused and scan at depth 10 on 200k rows
    deep2 = {}
    for method, want in (("fused", {"fused_advance_coarse": 7,
                                    "hist_int8x2": 9, "hist_f32": 4}),
                         ("scan", {"hist_scan": 8, "hist_f32": 4})):
        b10, c10 = train_launches(f"train {method} depth 10", lambda m=method:
                                  xt.train(dict(params, max_depth=10,
                                                hist_method=m), d10, 2,
                                           verbose_eval=False))
        want = {k: want.get(k, 0) * 2 for k in K.LAUNCHES}
        if {k: c10[k] for k in K.LAUNCHES} != want:
            raise AssertionError(f"{method} depth 10 launched {c10}, "
                                 f"expected {want}")
        if max(t.max_depth() for t in b10.gbm.trees) != 10:
            raise AssertionError(f"{method}: no tree reached depth 10")
        deep2[method] = (c10, saved_bytes(b10))
    if deep2["fused"][1] != deep2["scan"][1]:
        raise AssertionError("fused and scan at depth 10 saved different "
                             "models")
    log("fused and scan at depth 10 saved the same model bytes")

    phase_line("two-level depth 10")

    # ------------------- main path: multiclass at the Covertype shape
    # multi:softprob over 7 classes with row and column sampling and early
    # stopping on the held-out rows: K4 at every level of every class tree
    # (the sorted build, as the TPU's auto at 581,012 rows), K1 for the
    # held-out walks, Booster.predict and a 7-group Server
    Xc, yc = covtype_like(seed=4)
    n_cov = sum(COVTYPE_CLASS_COUNTS)
    if np.bincount(yc[:n_cov].astype(np.int64)).tolist() != \
            list(COVTYPE_CLASS_COUNTS):
        raise AssertionError("the Covertype-shape labels miss covtype's "
                             "class counts")
    dcov = xt.DMatrix(Xc[:n_cov], label=yc[:n_cov])
    dcte = xt.DMatrix(Xc[n_cov:], label=yc[n_cov:])
    yte = yc[n_cov:]
    cov_runs, cov_raw = [], []
    for run in range(2):
        res_c = {}
        t0 = time.perf_counter()
        bc, cc = train_launches(f"train Covertype run {run}", lambda r=res_c:
                                xt.train(COVTYPE_PARAMS, dcov, COVTYPE_ROUNDS,
                                         evals=[(dcte, "test")],
                                         evals_result=r, verbose_eval=10,
                                         early_stopping_rounds=(
                                             COVTYPE_EARLY_STOP)))
        t_cov = time.perf_counter() - t0
        rounds_c = bc.num_boosted_rounds()
        if cc["hist_scan"] != 56 * rounds_c or cc["hist_int8x2"] != 0 or \
                cc["hist_f32"] != 0 or cc["fused_advance_coarse"] != 0:
            raise AssertionError(f"Covertype launched {cc}, expected K4 56 "
                                 f"times a round (8 levels x 7 classes)")
        if cc["walk_packed"] != rounds_c or \
                cc["walk_staged"] != rounds_c:
            raise AssertionError(f"Covertype's held-out walks launched {cc}, "
                                 "expected K1 staged once a round")
        cov_runs.append(cc)
        cov_raw.append(bytes(bc.save_raw("ubj")))
        log(f"train Covertype run {run}: {rounds_c} rounds in {t_cov:.3f} s "
            f"(host clock, sketch and binning included on run 0); launches "
            f"a round: K4 {cc['hist_scan'] / rounds_c:g}, K1 "
            f"{cc['walk_packed'] / rounds_c:g}; best_iteration "
            f"{bc.best_iteration}, best_score {bc.best_score}, "
            f"{'stopped early' if rounds_c < COVTYPE_ROUNDS else 'ran every round'}")
    digests = [hashlib.sha256(r).hexdigest() for r in cov_raw]
    if digests[0] != digests[1]:
        raise AssertionError(f"two Covertype runs saved different models: "
                             f"{digests}")
    log(f"Covertype model sha256 (two runs): {digests[0]} {digests[1]}")
    mll = res_c["test"]["mlogloss"]
    p_first = bc.predict(dcte, iteration_range=(0, 1))
    p_cov = bc.predict(dcte)
    me0, me1 = merror(p_first, yte), merror(p_cov, yte)
    if not (mll[-1] < mll[0] and me1 < me0 and np.isfinite(p_cov).all()
            and p_cov.shape == (COVTYPE_TEST_ROWS, 7)):
        raise AssertionError(f"Covertype held-out mlogloss {mll[0]} -> "
                             f"{mll[-1]}, merror {me0} -> {me1}")
    if abs(multi_logloss(p_cov, yte) - mll[-1]) > 1e-5:
        raise AssertionError("Booster.predict disagrees with the eval line")
    log(f"Covertype held-out: mlogloss {mll[0]} -> {mll[-1]} (round "
        f"{len(mll) - 1}), merror {me0:.6f} -> {me1:.6f}; early-stopping "
        f"round {bc.num_boosted_rounds() - 1}, best_iteration "
        f"{bc.best_iteration}")
    # the sampled masks and row draws of every round of the run: the
    # threefry on the card against the threefry on the CPU
    base_mask = dcov.binned(256, dev).cuts.n_real_bins() > 0
    its = range(bc.num_boosted_rounds())
    mask_card = round_masks(COVTYPE_PARAMS, its, base_mask, dev)
    mask_cpu = round_masks(COVTYPE_PARAMS, its, base_mask,
                           torch.device("cpu"))
    if mask_card != mask_cpu:
        raise AssertionError(f"the sampled masks differ: card {mask_card}, "
                             f"CPU {mask_cpu}")
    log(f"Covertype sampled masks and row draws of {len(its)} rounds: "
        f"sha256 {mask_card} on the card and on the CPU")
    # seconds a round and device busy over three profiled rounds
    timer_c, per_c, cov_s = seconds_per_round(COVTYPE_PARAMS, dcov)
    log(f"Covertype seconds per round (update + sync, host clock): "
        f"{['%.6f' % t for t in per_c]}; median of rounds 1-5 {cov_s:.6f} s")
    cov_busy, _ = profile_rounds("Covertype", timer_c, dcov, top=12)
    # the round's random draws alone (host clock, ending in a sync): the
    # seven trees' feature masks and row samples of one round
    from xgboost_tpu_torch.boosting.gbtree import sample_gradients
    from xgboost_tpu_torch.tree.grow import draw_feature_masks
    from xgboost_tpu_torch.utils import random as xrandom

    gp_c = torch.randn(n_cov, 2, device=dev)
    tp_c = timer_c.tree_param
    base_t = torch.from_numpy(base_mask).to(dev)
    draws = []
    for it in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key = xrandom.fold_in(xrandom.key(0), it)
        tkeys = [xrandom.fold_in(key, k) for k in range(7)]
        draw_feature_masks(tkeys, base_t, tp_c, tp_c.max_depth)
        for tk in tkeys:
            sample_gradients(gp_c, tk, tp_c)
        torch.cuda.synchronize()
        draws.append(time.perf_counter() - t0)
    log(f"Covertype random draws of one round (7 trees' masks and row "
        f"samples; host clock, ending in a sync): median of rounds 1-5 "
        f"{float(np.median(draws[1:])) * 1e3:.3f} ms")
    # Booster.predict on the 100k held-out rows and a 7-group Server
    reset_counts()
    p_again = bc.predict(dcte)
    cov_predict_counts = read_counts()
    if not np.array_equal(p_again, p_cov) or \
            cov_predict_counts["walk_staged"] != 1:
        raise AssertionError(f"Covertype predict: {cov_predict_counts}")
    Xte = Xc[n_cov:]
    answers_c = []
    reset_counts()
    with Server(models={"covtype": cov_raw[0]}, max_batch=512) as srv:
        srv.warmup()
        for i in range(80):
            n = sizes[i % len(sizes)]
            lo = (i * 1237) % (COVTYPE_TEST_ROWS - n)
            answers_c.append((lo, n, np.asarray(srv.predict(Xte[lo:lo + n]))))
        snap_c = srv.metrics_snapshot()
    cov_serve_counts = read_counts()
    for lo, n, got in answers_c:
        if not np.array_equal(got, p_cov[lo:lo + n]):
            raise AssertionError(f"a 7-class Server answer ({n} rows at "
                                 f"{lo}) differs from Booster.predict")
    if cov_serve_counts["walk_spread"] < 1:
        raise AssertionError(f"the 7-class Server launched "
                             f"{cov_serve_counts}")
    log(f"Covertype serve: 80 requests of {sizes} rows, 7 groups, every "
        f"answer equal to Booster.predict bit for bit; e2e p50 "
        f"{snap_c['stages']['e2e']['p50_ms']} ms p99 "
        f"{snap_c['stages']['e2e']['p99_ms']} ms; K1 launches "
        f"{cov_serve_counts['walk_packed']} (spread "
        f"{cov_serve_counts['walk_spread']})")
    # one random-forest round (num_parallel_tree 4) and a gradient-based
    # row sample
    rf, rf_counts = train_launches("Covertype num_parallel_tree 4", lambda:
                                   xt.train(dict(COVTYPE_PARAMS,
                                                 num_parallel_tree=4),
                                            dcov, 1, verbose_eval=False))
    if rf_counts["hist_scan"] != 8 * 7 * 4 or len(rf.gbm.trees) != 28 or \
            rf.gbm.tree_info[:8] != [0, 0, 0, 0, 1, 1, 1, 1]:
        raise AssertionError(f"num_parallel_tree 4: {rf_counts}, "
                             f"{len(rf.gbm.trees)} trees")
    res_g = {}
    gb, gb_counts = train_launches("Covertype gradient_based", lambda:
                                   xt.train(dict(COVTYPE_PARAMS,
                                                 subsample=0.5,
                                                 sampling_method=
                                                 "gradient_based"),
                                            dcov, 3, evals=[(dcte, "test")],
                                            evals_result=res_g,
                                            verbose_eval=False))
    gll = res_g["test"]["mlogloss"]
    if not gll[-1] < gll[0] or gb_counts["hist_scan"] != 56 * 3:
        raise AssertionError(f"gradient_based: {gll}, {gb_counts}")
    log(f"Covertype num_parallel_tree 4: 28 trees in one round, K4 "
        f"{rf_counts['hist_scan']}; gradient_based subsample 0.5: held-out "
        f"mlogloss {gll[0]} -> {gll[-1]} in 3 rounds")
    # one round each through K3's rounded precisions
    bf16_counts = {}
    for prec in ("bf16x2", "bf16"):
        bb, cb16 = train_launches(f"Covertype pallas:{prec}", lambda p=prec:
                                  xt.train(dict(COVTYPE_PARAMS,
                                                hist_method=f"pallas:{p}"),
                                           dcov, 1, verbose_eval=False))
        name = f"hist_{prec}"
        if cb16[name] != 56 or cb16["hist_scan"] != 0:
            raise AssertionError(f"pallas:{prec} launched {cb16}, expected "
                                 f"{name} 56 times a round")
        bf16_counts[name] = cb16
    cov_pf = bc.packed_forest()
    Xte_dev = torch.from_numpy(np.ascontiguousarray(Xte)).to(dev)
    cov_base = torch.tensor(bc._base_np(), device=dev)
    last_pf = PackedForest.from_trees(bc.gbm.trees[-7:],
                                      bc.gbm.tree_info[-7:], 7)
    # K1's 7-group fold against the plain walk on both schedules
    for n, sch in ((512, "spread"), (100_000, "staged")):
        errs.append(check_kernel(f"Covertype 7-group n={n}", cov_pf,
                                 Xte_dev[:n].contiguous(), cov_base, sch)[0])

    phase_line("covertype")

    # ---- main path: BASELINE config #4 in full (categorical codes, dart)
    (covdart_runs, covdart_errs, covdart_k1, covdart_k2, covdart_s,
     covdart_busy, covdart_model) = covertype_categorical_dart(
         xt, dev, Xc, yc, (mll, (me0, me1)))
    errs += covdart_k1
    for k, e in covdart_errs.items():
        hist_errs[k] = max(hist_errs.get(k, 0.0), e)
    log(f"covertype_categorical_dart: {covdart_s:.6f} s a round, device busy "
        f"{covdart_busy:.3f} ms over 3 rounds; Covertype one-hot gbtree "
        f"{cov_s:.6f} s a round, busy {cov_busy:.3f} ms")

    phase_line("covertype_categorical_dart")

    # ---- main path: leaf-wise growth, max_leaves and the constraints
    (lg_runs, lg_errs, lg_k1, lg_pair, lg_k1_time,
     lg) = lossguide_constraints(xt, dev, X, y, w_rule,
                                 (auto_ll10, auto_auc10), Xc, yc)
    errs += lg_k1
    for k, e in lg_errs.items():
        hist_errs[k] = max(hist_errs.get(k, 0.0), e)
    log(f"lossguide_constraints: {lg['s_round']:.6f} s a round, device busy "
        f"{lg['busy_ms']:.3f} ms over 3 rounds, {lg['pairs']:g} pairs a "
        f"round; held-out logloss {lg['ll'][0]} -> {lg['ll'][1]}, AUC "
        f"{lg['auc']:.6f} (depthwise {auto_auc10:.6f}); constrained AUC "
        f"{ {k: round(v[0], 6) for k, v in lg['constrained'].items()} }; "
        f"model sha256 {lg['digest']}")

    phase_line("lossguide_constraints")

    # ---- main path: the linear booster, SHAP on the card, the wrappers,
    # cv and the CLI
    with tempfile.TemporaryDirectory(prefix="xtt_pr16_") as tmp:
        t0 = time.perf_counter()
        gl_runs, gl = gblinear_higgs(xt, dev, X, y, tmp)
        t_gl = time.perf_counter() - t0
        t0 = time.perf_counter()
        sh_runs, sh = shap_higgs(xt, dev, X, y, *covdart_model)
        t_sh = time.perf_counter() - t0
        t0 = time.perf_counter()
        sk_runs, sk = sklearn_cv_cli(xt, dev, X, y, Xc, yc, tmp)
        t_sk = time.perf_counter() - t0
    log(f"gblinear_higgs {t_gl:.1f} s, shap_higgs {t_sh:.1f} s, "
        f"sklearn_cv_cli {t_sk:.1f} s; gblinear shotgun / coord_descent "
        f"{gl['shotgun']['s_round']:.6f} / "
        f"{gl['coord_descent']['s_round']:.6f} s a round, held-out AUC "
        f"{gl['shotgun']['auc']:.6f} / {gl['coord_descent']['auc']:.6f}; "
        f"SHAP contributions of 10,000 rows "
        f"{sh['higgs']['contribs']['ms']:.3f} ms, interactions of 1,000 "
        f"{sh['higgs']['interactions']['ms']:.3f} ms, Saabas of 100,000 "
        f"{sh['higgs']['approx']['ms']:.3f} ms (CUDA events); cv test AUC "
        f"{sk['cv']['auc']:.6f} +- {sk['cv']['std']:.6f}")
    # the paged phase's Covertype codes (the training rows)
    cov_codes = covtype_codes(Xc[:sum(COVTYPE_CLASS_COUNTS)])
    cov_labels = yc[:sum(COVTYPE_CLASS_COUNTS)]
    del Xc, dcov, dcte, covdart_model

    phase_line("gblinear, shap, sklearn_cv_cli")

    # ---- main path: the serving stack (HTTP / jsonl front ends, fleet,
    # contribs route), the NaN policies, update_batch, the native parser
    with tempfile.TemporaryDirectory(prefix="xtt_serving_") as tmp:
        t0 = time.perf_counter()
        try:
            ss_runs, ss = serving_stack(xt, dev, raw, booster, Xbig, pred, X,
                                        y, tmp)
        finally:
            stop_children()
        t_ss = time.perf_counter() - t0
    lat = ss["latency_ms"]
    log(f"serving_stack {t_ss:.1f} s: 1-row p50 / p99 {lat[1][0]:.3f} / "
        f"{lat[1][1]:.3f} ms under 4 clients, {lat['1 alone'][0]:.3f} / "
        f"{lat['1 alone'][1]:.3f} ms from one; 512-row {lat[512][0]:.3f} / "
        f"{lat[512][1]:.3f} ms, {lat['512 alone'][0]:.3f} / "
        f"{lat['512 alone'][1]:.3f} ms; contribs route / "
        f"Booster.predict {ss['contribs_rows_per_s'][0]:.1f} / "
        f"{ss['contribs_rows_per_s'][1]:.1f} rows/s; parser native / "
        f"Python {ss['parse_rows_per_s'][0]:.1f} / "
        f"{ss['parse_rows_per_s'][1]:.1f} rows/s [{card}]")

    phase_line("serving_stack")

    # ---- main path: multi-target training at the MediaMill shape
    mt_runs, mt_errs, mt_k1, mt_times, mt = multi_target(xt, dev)
    errs += mt_k1
    for k, e in mt_errs.items():
        hist_errs[k] = max(hist_errs.get(k, 0.0), e)
    log("multi_target: " + "; ".join(
        f"{k} {v['s_round']:.6f} s a round, busy {v['busy_ms']:.3f} ms over "
        f"3 rounds, held-out logloss {v['ll'][0]} -> {v['ll'][1]}, mean "
        f"label AUC {v['mauc']:.6f}" for k, v in mt.items()
        if isinstance(v, dict) and "ll" in v)
        + f"; HIGGS-shape vector leaves {mt['higgs']['s_round']:.6f} s a "
        f"round, rmse {mt['higgs']['rmse'][0]} -> {mt['higgs']['rmse'][1]}")

    phase_line("multi_target")

    # ---- main path: the rest of the objectives (quantile regression,
    # survival, insurance claims)
    qr_runs, qr = quantile_regression(xt, dev, X)
    q = qr["quantile"]
    log(f"quantile_regression: {q['s_round']:.6f} s a round, device busy "
        f"{q['busy']:.3f} ms over 3 rounds, {q['rounds']} rounds, coverage "
        f"{q['cover']:.6f}, leaf refresh {q['refresh_ms']:.6f} ms a tree; "
        f"MAE {qr['mae']['mae']}")
    surv_runs, surv = survival(xt, dev, X)
    log(f"survival: AFT {surv['aft']['s_round']:.6f} s a round, busy "
        f"{surv['aft']['busy']:.3f} ms over 3 rounds, aft-nloglik "
        f"{surv['aft']['nll']}, accuracy {surv['aft']['acc']}; Cox "
        f"{surv['cox']['s_round']:.6f} s a round, busy "
        f"{surv['cox']['busy']:.3f} ms, cox-nloglik {surv['cox']['nll']}")
    ins_runs, ins = insurance_claims(xt, dev)
    log("insurance_claims: " + "; ".join(
        f"{k} {v['s_round']:.6f} s a round, busy {v['busy']:.3f} ms over 3 "
        f"rounds, held-out {v['metric']} {v['m'][0]} -> {v['m'][1]}"
        for k, v in ins.items() if isinstance(v, dict)))

    phase_line("objectives")

    # ---- main path: tree_method approx at the HIGGS shape, and the three
    # tree methods at XGBoost's Kaggle Higgs speed test
    ax_runs, ax = approx_higgs(xt, dev, X, y)
    log(f"approx_higgs: seconds a round {ax['s_round']}, device busy over 3 "
        f"rounds {ax['busy']} ms; sketch {ax['sketch_ms']:.6f} ms and "
        f"re-binning {ax['rebin_ms']:.6f} ms a round (first sketch "
        f"{ax['first_sketch_ms']:.6f} ms); peak {ax['peak_gb']} GB; "
        f"held-out AUC {ax['auc']}")
    kg_runs, kg = kaggle_higgs_speedtest(xt, dev)
    log("kaggle_higgs_speedtest: " + "; ".join(
        f"{k} {kg[k]['s_round']:.6f} s a round, busy {kg[k]['busy']:.3f} ms "
        f"over 3 rounds, peak {kg[k]['peak_gb']:.3f} GB, held-out auc "
        f"{kg[k]['auc'][1]}, ams@0.15 {kg[k]['ams'][1]}"
        for k in ("hist", "approx", "exact")))

    phase_line("approx_higgs, kaggle_higgs_speedtest")

    # ------- main path: BASELINE config #3 in full (rank:ndcg at MSLR shape)
    mslr_runs, mslr_errs, mslr_k1, mslr_hist, mslr = mslr_ranking(xt, dev)
    errs += mslr_k1
    for k, e in mslr_errs.items():
        hist_errs[k] = max(hist_errs.get(k, 0.0), e)
    log(f"mslr_ranking: {mslr['s_round']:.6f} s a round, device busy "
        f"{mslr['busy_ms'] / 3:.3f} ms a round (histograms "
        f"{mslr['hist_ms']:.3f}, LambdaRank gradient {mslr['grad_ms']:.3f}); "
        f"held-out ndcg@10 {mslr['ndcg'][0]} -> {mslr['ndcg'][1]}")

    phase_line("mslr_ranking")

    # ---- main path: BASELINE config #1, the agaricus demos from libsvm files
    with tempfile.TemporaryDirectory(prefix="xtt_agaricus_") as tmp:
        (ag_runs, ag_k2_err, ag_k1_err, ag_k2_time, ag_k1_time,
         ag) = agaricus_walkthrough(xt, dev, tmp)
    errs.append(ag_k1_err)
    hist_errs["hist_int8x2"] = max(hist_errs.get("hist_int8x2", 0.0),
                                   ag_k2_err)
    log(f"agaricus_walkthrough: DMatrix(path) {ag['load_s']:.6f} s, parse "
        f"{ag['parse_rows_per_s']:.1f} rows/s, {ag['s_round']:.6f} s a round, "
        f"device busy {ag['busy_ms'] / 3:.3f} ms a round; held-out error "
        f"{ag['error']}, rmse {ag['rmse']}; model sha256 {ag['digests']}")

    phase_line("agaricus_walkthrough")

    # --------- main path: external memory at the HIGGS-11M shape (paged)
    with tempfile.TemporaryDirectory(prefix="xtt_ext_") as tmp:
        ext_runs, ext_busy, ext_s, ext_dm = external_memory(xt, dev, F, tmp)
        # ---- main path: the paged tier's left-outs on the same matrix
        plo_runs, plo = paged_left_outs(xt, dev, F, tmp, ext_dm,
                                        cov_codes, cov_labels)
        del ext_dm
    log(f"paged_left_outs: {plo['phase_s']:.1f} s; two-level seconds a "
        f"round {plo['two_level_s']}, lossguide runs {plo['lossguide_s']} s, "
        f"re-sketch {plo['resketch_s']} s a round, gblinear "
        f"{plo['gblinear_s']:.6f} s a round [{card}]")

    phase_line("external_memory, paged_left_outs")

    # ---- main path: row-split distributed training (a data mesh of shards
    # on this card, two gloo processes, paged ranks)
    with tempfile.TemporaryDirectory(prefix="xtt_dist_") as tmp:
        dist_runs, dist = distributed(xt, dev, tmp)
    log(f"distributed: {dist['phase_s']:.1f} s; seconds a round "
        f"{dist['s_round']}; two processes {dist['procs_s_round']} s a "
        f"round, collective host time {dist['procs_collective_s']} s; mesh "
        f"sha256 {dist['mesh_sha']} [{card}]")

    phase_line("distributed")

    # ---- main path: column-split training (feature shards on a column
    # mesh of this card, vertical federated parties on threads)
    col_runs, col = column_split(xt, dev, dist)
    del dist["one"], dist["data"], dist["mediamill"]
    log(f"column_split: {col['phase_s']:.1f} s; seconds a round "
        f"{col['s_round']}; trees' bytes one device's {col['same_bytes']}; "
        f"column mesh sha256 {col['col_sha']} [{card}]")

    phase_line("column_split")

    # ---- main path: external memory over a data mesh (each shard of this
    # card streams its own rows of each page), traced once
    with tempfile.TemporaryDirectory(prefix="xtt_pm_") as tmp:
        pm_runs, pm = paged_mesh(xt, dev, tmp)
    log(f"paged_mesh: {pm['phase_s']:.1f} s; seconds a round "
        f"{pm['s_round']}; sha256 {pm['sha']}; seconds a level "
        f"{pm['trace']}; peak of the traced round {pm['peak_round']} B "
        f"[{card}]")

    phase_line("paged_mesh")

    # ---- main path: the continuous train -> serve pipeline (a served,
    # gated, crash-safe loop), insight, the flight recorder, the CLI
    with tempfile.TemporaryDirectory(prefix="xtt_cp_") as tmp:
        try:
            cp_runs, cp = continuous_pipeline(xt, dev, tmp, dtr, dte)
        finally:
            stop_children()
    phase_line("continuous_pipeline")

    # ------------------------------------------------------- times on card
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    # each kernel at the deepest level its main path gives it, and at the
    # root; K2 also at 1M rows, beside K4 on the same inputs
    # and at the two-level schedules' refine builds (36 slots: K2 at the
    # HIGGS run's root and deepest level, K3 at depth 10's deepest) and the
    # root's coarse build (20 slots)
    hist_times = {}
    for i, (n_rows, N, B) in enumerate((
            (1_000_000, 1, 256), (1_000_000, 128, 256), (200_000, 256, 256),
            (200_000, 512, 256), (50_000, 1, 256), (50_000, 128, 256),
            (1_000_000, 1, 20), (1_000_000, 1, 36), (1_000_000, 128, 36),
            (200_000, 512, 36), (1_000_000, 128, 20))):
        if B == 256:
            bins, gpair, rel = hist_inputs(n_rows, F, B, N, dev,
                                           seed=40 + i)
        else:
            bins, gpair, rel = two_level_inputs(n_rows, F, N, B, dev,
                                                seed=40 + i)
        t, n_active = time_hist(bins, gpair, rel, N, B, flush)
        for name, (ms, plain_ms, lib_ms) in t.items():
            planes = 2 if name in k3_precisions() else 4
            bound = hist_bound_ms(bins, N, B, n_active, planes)
            hist_times[(name, n_rows, N, B)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n={n_rows} N={N} B={B} x {F} u8 (L2 flushed): "
                f"{ms:.6f} ms, plain {plain_ms:.6f} ms, index_add_ "
                f"{lib_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}; "
                f"{bound[2]} integer adds), kernel at "
                f"{bound[0] / ms * 100:.4f}% of it")
        del bins, gpair, rel
    # K2-u4 and K3-u4 at a 1M-row page of the u4 run's deepest levels
    u4_times = {}
    for N in (128, 512):
        for name, (ms, plain_ms, lib_ms, bound) in time_u4(
                1_000_000, F, N, dev, flush, seed=130 + N).items():
            u4_times[(name, N)] = (ms, plain_ms, lib_ms, bound)
            log(f"hist {name} n=1000000 N={N} B=16 x {F} u4-packed (L2 "
                f"flushed): {ms:.6f} ms, plain {plain_ms:.6f} ms, unpack_u4 "
                f"+ index_add_ {lib_ms:.6f} ms, bound {bound[0]:.6f} ms "
                f"({bound[1]}), kernel at {bound[0] / ms * 100:.4f}% of it")
    # K4 at every level width and K5 at every level boundary of the HIGGS
    # run, with their phases
    levels = time_levels(dev, flush)
    for name, label in (("hist_scan", "K4"), ("fused_advance_coarse", "K5")):
        for N, r in levels[name].items():
            sort, tiles, comb = r["phases"]
            log(f"phases {label} N={N}: sort {sort:.6f} ms, tiles "
                f"{tiles:.6f} ms, combine and fold {comb:.6f} ms (sum "
                f"{sort + tiles + comb:.6f}, queued call "
                f"{r['queued_ms']:.6f}, event call {r['ms']:.6f}); queued "
                f"call at {r['bound'][0] / r['queued_ms'] * 100:.4f}% of its "
                f"bound, time - bound {r['queued_ms'] - r['bound'][0]:.6f} "
                f"ms")
    # K1 on the Covertype forest (7 groups, X read from global memory by
    # the staged walk at 54 features): the 100,000 held-out rows through
    # the whole forest (a predict) and through one round's 7 trees (an
    # eval walk), and the server's 1- and 512-row buckets
    cov_walk = {}
    for label, f, n, cold in (("forest 100000", cov_pf, 100_000, flush),
                              ("round 100000", last_pf, 100_000, flush),
                              ("forest 1", cov_pf, 1, None),
                              ("forest 512", cov_pf, 512, None)):
        Xn = Xte_dev[:n].contiguous()
        b7 = cov_base if f is cov_pf else torch.zeros(7, device=dev)
        before = dict(W.SCHEDULE_LAUNCHES)
        _, leaves = f.margin(Xn, b7, leaf_index=True)
        took = [k for k, v in W.SCHEDULE_LAUNCHES.items() if v != before[k]]
        depth7 = torch.from_numpy(node_depths(f)).to(dev)
        r = {"queued_ms": queued_ms(lambda: f.margin(Xn, b7), 20, cold),
             "ms": event_ms(lambda: f.margin(Xn, b7), reps=20, flush=cold),
             "bound": walk_bound_ms(f, n, 54, int(
                 depth7[leaves.long()].sum()))}
        cov_walk[label] = r
        r["schedule"] = took[0]
        log(f"K1 Covertype {label} rows (Tp={f.tree_offsets.shape[0]}, 7 "
            f"groups, {took[0]}): "
            + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items()
                        if k != "schedule"))
    # K1 at its main-path shapes, and both schedules across the crossover
    walk = time_walk(dev, flush)
    for label, r in walk["shapes"].items():
        log(f"K1 {label} rows: device-only {r['queued_ms']:.6f} ms at "
            f"{r['bound'][0] / r['queued_ms'] * 100:.4f}% of its bound "
            f"({r['bound'][1]}), time - bound "
            f"{r['queued_ms'] - r['bound'][0]:.6f} ms")
    torch.cuda.synchronize()

    log(f"model digests: {{'auto': {digest(bst)!r}, 'scan': "
        f"{hashlib.sha256(raws['scan']).hexdigest()!r}}}")

    # launches: every main-path run of the kernel
    runs = [train_counts, deep_counts, small_counts,
            *two_counts.values(), *(c for c, _ in deep2.values()),
            *cov_runs, rf_counts, gb_counts, *bf16_counts.values(),
            *ext_runs, *plo_runs, *covdart_runs, *mslr_runs, *ag_runs,
            *lg_runs, *mt_runs, *qr_runs, *surv_runs, *ins_runs, *ax_runs,
            *kg_runs, *gl_runs, *sh_runs, *sk_runs, *ss_runs, *dist_runs,
            *col_runs, *pm_runs, *cp_runs]
    kernels = [{
        "name": "walk_packed",
        "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "launches": (launches_predict + launches_serve
                     + cov_predict_counts["walk_packed"]
                     + cov_serve_counts["walk_packed"]
                     + sum(c["walk_packed"] for c in runs)),
        "max_abs_err": max(errs),
        "ms": walk["shapes"]["100000"]["ms"],
        "plain_ms": walk["shapes"]["100000"]["plain_ms"],
        "bound_ms": walk["shapes"]["100000"]["bound"][0],
        "bound_by": walk["shapes"]["100000"]["bound"][1],
        "library_ms": None,
    }]
    # times at the shape that takes most of each kernel's launches (K2:
    # the categorical dart runs' levels over 12 features, at 128 nodes)
    hist_times[("hist_int8x2", "codes")] = covdart_k2
    for name, replaces, shape in (
            ("hist_int8x2", ":621", ("codes",)),
            ("hist_f32", ":634", (200_000, 512, 256)),
            ("hist_bf16x2", ":634", (200_000, 512, 256)),
            ("hist_bf16", ":634", (200_000, 512, 256)),
            ("hist_scan", ":478", (1_000_000, 128, 256))):
        ms, plain_ms, lib_ms, bound = hist_times[(name, *shape)]
        launches = sum(c[name] for c in runs)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + replaces,
            "launches": launches, "max_abs_err": hist_errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms})
    # the packed_u4 bodies: K2-u4 at the u4 run's levels of 128 nodes, K3-u4
    # at depth 10's levels of 512
    for name, replaces, N in (("hist_int8x2_u4", ":62", 128),
                              ("hist_f32_u4", ":62", 512),
                              ("hist_bf16x2_u4", ":62", 512),
                              ("hist_bf16_u4", ":62", 512)):
        ms, plain_ms, lib_ms, bound = u4_times[(name, N)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + replaces,
            "launches": sum(c[name] for c in runs),
            "max_abs_err": hist_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms})
    # the agaricus shapes: K2 at 6,513 x 127, B = 2 (N = 2, its deeper
    # level), K1 on the agaricus forest at the 1,611 test rows
    ms, plain_ms, lib_ms, bound = ag_k2_time
    kernels.append({
        "name": "hist_int8x2", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/hist.cu",
        "replaces": "xgboost_tpu/ops/pallas/histogram.py:621",
        "shape": "agaricus 6513 x 127, B=2, N=1/2",
        "launches": sum(c["hist_int8x2"] for c in ag_runs),
        "max_abs_err": ag_k2_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms})
    kernels.append({
        "name": "walk_packed", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "shape": f"agaricus forest, {AGARICUS_TEST_ROWS} rows",
        "launches": sum(c["walk_packed"] for c in ag_runs),
        "max_abs_err": ag_k1_err, "ms": ag_k1_time["ms"],
        "plain_ms": ag_k1_time["plain_ms"],
        "bound_ms": ag_k1_time["bound"][0],
        "bound_by": ag_k1_time["bound"][1], "library_ms": None})
    # the lossguide pair: K2 and K4 at N = 2 over 1M x 28 (the HIGGS run's
    # 256 slots) with 50% and 2% of the rows in the pair; K1 on the
    # lossguide forest at 100,000 rows
    for name, replaces in (("hist_int8x2", ":621"), ("hist_scan", ":478")):
        for share in (0.5, 0.02):
            ms, plain_ms, lib_ms, bound = lg_pair[(name, share, 256)]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "xgboost_tpu_torch/csrc/hist.cu",
                "replaces": "xgboost_tpu/ops/pallas/histogram.py" + replaces,
                "shape": f"lossguide pair 1000000 x 28, B=256, N=2, "
                         f"{share:.0%} of the rows in the pair",
                "launches": sum(c[name] for c in lg_runs),
                "max_abs_err": lg_errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": lib_ms})
    kernels.append({
        "name": "walk_packed", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "shape": f"lossguide forest (max_depth {lg_k1_time['max_depth']}), "
                 "100000 rows",
        "launches": sum(c["walk_packed"] for c in lg_runs),
        "max_abs_err": max(lg_k1), "ms": lg_k1_time["ms"],
        "plain_ms": lg_k1_time["plain_ms"],
        "bound_ms": lg_k1_time["bound"][0],
        "bound_by": lg_k1_time["bound"][1], "library_ms": None})
    # the multi-target shapes: K2 at the MediaMill levels (30,993 x 120,
    # the training bins' 256 slots, N = 32), K1 on the 101-group forest at
    # the 12,914 held-out rows
    ms, plain_ms, lib_ms, bound = mt_times[("hist_int8x2", 32, 256)]
    kernels.append({
        "name": "hist_int8x2", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/hist.cu",
        "replaces": "xgboost_tpu/ops/pallas/histogram.py:621",
        "shape": f"mediamill {MM_TRAIN_ROWS} x {MM_FEATURES}, B=256, N=32, "
                 "one label's gradient",
        "launches": sum(c["hist_int8x2"] for c in mt_runs),
        "max_abs_err": mt_errs["hist_int8x2"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": lib_ms})
    k1 = mt_times["walk_packed"]
    kernels.append({
        "name": "walk_packed", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/walk.cu",
        "replaces": "xgboost_tpu/ops/pallas/walk.py:86",
        "shape": f"101-group forest ({MM_ROUNDS} rounds), {MM_TEST_ROWS} "
                 f"rows, {k1['plan']} plan",
        "launches": sum(c["walk_packed"] for c in mt_runs),
        "max_abs_err": max(mt_k1), "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound"][0],
        "bound_by": k1["bound"][1], "library_ms": None})
    k5 = levels["fused_advance_coarse"][128]
    ms, plain_ms, bound = k5["ms"], k5["plain_ms"], k5["bound"]
    kernels.append({
        "name": "fused_advance_coarse", "route": "cuda",
        "source": "xgboost_tpu_torch/csrc/hist.cu",
        "replaces": "xgboost_tpu/ops/pallas/histogram.py:344",
        "launches": sum(c["fused_advance_coarse"] for c in runs),
        "max_abs_err": hist_errs["fused_advance_coarse"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None})
    # the distributed phase's kernels at one level of one mesh shard, with
    # the scale reduced over the shards (``mesh_shard_kernels``)
    sk_errs, sk_times = dist["shard_kernels"]
    where = {"hist_scan": ":478", "hist_int8x2": ":621", "hist_f32": ":634",
             "fused_advance_coarse": ":344"}
    for (name, N), (ms, plain_ms, lib_ms, bound) in sk_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + where[name],
            "shape": f"mesh shard {DIST_ROWS // DIST_SHARDS} x 28 of "
                     f"{DIST_SHARDS}, scale over the shards, N={N}",
            "launches": sum(c[name] for c in dist_runs),
            "max_abs_err": sk_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms})
    # the column_split phase's kernels at one level of one feature shard
    # (``col_shard_kernels``)
    ck_errs, ck_times = col["shard_kernels"]
    for (name, N), (ms, plain_ms, lib_ms, bound) in ck_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + where[name],
            "shape": f"col shard {DIST_ROWS} x {28 // COL_SHARDS} of "
                     f"{COL_SHARDS}, N={N}",
            "launches": sum(c[name] for c in col_runs),
            "max_abs_err": ck_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms})
    # the paged_mesh phase's kernels at one shard's block of a page, with
    # the block's own scale (``paged_shard_kernels``)
    pk_errs, pk_times = pm["shard_kernels"]
    pm_p = EXT_BATCH_ROWS // PM_SHARDS
    for (name, N), (ms, plain_ms, lib_ms, bound) in pk_times.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "xgboost_tpu_torch/csrc/hist.cu",
            "replaces": "xgboost_tpu/ops/pallas/histogram.py" + where[name],
            "shape": f"paged mesh shard block {pm_p} x 28 of {PM_SHARDS} "
                     f"shards, the block's own scale, N={N}",
            "launches": sum(c[name] for c in pm_runs),
            "max_abs_err": pk_errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms})
    phase_line("times on card")
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

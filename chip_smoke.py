"""Chip smoke test of the PyTorch/CUDA port: serve and train Titanic, train Boston and Iris, stream, on the GPU.

Run from the repository root on a host with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--rows 1048576] [--reps 20] [--train-rows 262144]
                          [--stats-rows 1048576] [--text-rows 131072] [--stream-rows 4194304]
                          [--wide-text-rows 65536]

Phases, each printing its findings on a line of its own:

1. device   -- the card (nvidia-smi's name and power limit), and the build of
               every kernel from ``transmogrifai_tpu_torch/csrc`` and the
               Triton sources, with its seconds;
2. kernels  -- each kernel of the serve path against its plain PyTorch
               version on the inputs the path gives it (a Titanic-schema
               batch of ``--rows`` rows made from ``--seed``): equal bins,
               leaves and vectors, margins within the stated tolerance;
               median time over ``--reps`` runs by CUDA events, beside the
               plain version's, one library call's where one exists, and
               the least time the card could take (``bound_ms``);
3. reference -- the committed fixture (a full-width Titanic XGB model the
               JAX package saved, with its answers for 256 requests) scored
               through ``BatchScoreFunction`` on the card, against those
               answers;
4. serve    -- the main path: request batches of 1, 64 and 1024 records
               through ``BatchScoreFunction`` (p50 latency), a few records
               through ``ScoreFunction``, and the ``--rows`` batch through
               ``OpWorkflowModel.score`` (rows/s).  Every kernel's launch
               count is reset just before and read just after; each must be
               above 0;
5. breakdown -- the ``--rows`` batch again, split into the reader and each
               DAG layer on the host clock, and profiled for the device's
               busy time and idle share;
5b. serve plane -- the serving plane (``serve/``, slice 16) over the
               committed fixtures ``titanic_stock`` (binary logistic head),
               ``letters_stock`` (26-class softmax; fewer than two fusable
               stages, so ``BatchScoreFunction`` on the card),
               ``boston_ridge`` (linear head, captured with the plan) and
               ``titanic_xgb`` (trees): K-AF (``predict_head``) against its
               plain version at each linear head's input at 64 and 1,024
               rows and at p = 1024 (64 and 1,024 rows), timed beside its
               bound and ``torch.addmm``'s product, each shape with its
               ``head_plan``; every bucket graph of max_batch 64
               bit-equal to the eager program, with the capture seconds per
               bucket and the bytes the graphs hold; the main path: each
               fixture's requests through ``MicroBatcher`` and HTTP ``POST
               /score`` against its ``expected.npz`` (rows with an infinite
               value rejected as ``non_finite``, as the JAX package's
               contract rejects them), then 16 clients posting while
               ``titanic_newton`` is deployed over ``titanic_stock`` (no
               failure, no old version after the swap, no degraded or
               row-path batch, no recorded fallback but
               ``aot_unsupported``), with K-AF's launches above 0; p50 and
               p99 in turns (graph, eager, eager, graph) of single-record
               HTTP posts at 1 and 16 clients and of in-process batches of 1,
               64 and 1,024 records through the bucket graphs against
               ``BatchScoreFunction``, beside the card's name and power limit;
6. train reference -- the full-width Titanic XGBoost train (the stock grid:
               200 rounds, depth 10, min_child_weight 1 and 10, 3-fold CV)
               on the 891-row synthetic frame, through
               ``OpWorkflow.train`` with ``model_types=["OpXGBoostClassifier"]``
               (the fused sweep): the winner must be the committed
               fixture's and every fold's AuPR within ``TRAIN_AUPR_TOL`` of
               the fixture's; the share of refit trees equal to the
               fixture's and the saved model's gaps on the fixture's
               requests are printed;
7. sweep reference -- the full-width stock train (LR + RF + XGBoost, 28
               candidates) on the 891-row frame, held to the committed
               fixture ``titanic_stock``: the same winner (LR reg_param
               0.001, elastic_net_param 0.1), the forests' draws equal to
               the fixture's, each family's fold AuPR within its tolerance
               (``FX.LR_AUPR_TOL``, ``FX.RF_AUPR_TOL``, ``TRAIN_AUPR_TOL``),
               and the saved model's probabilities on the fixture's requests
               within ``FX.PROB_ATOL``; every metric of each sweep call is
               printed beside the fixture's;
8. train    -- the main path of training: the stock flow on a Titanic-schema
               frame of ``--train-rows`` rows from ``--seed``; every
               kernel's launch count is reset just before and read just
               after (K-A, K-E ... K-M must be above 0), with the wall time
               and the host-clock breakdown (the sweep split into fista,
               forest, gbt and metrics); a second run is profiled for the
               device's busy time and idle share;
9. train kernels -- K-E ... K-H against their plain versions on the inputs
               of the deepest level of the second boosting round of one
               sweep fold of the ``--train-rows`` data (the first round's
               gradients are dyadic; the second's are checked not to be):
               K-E, K-F and K-G bit-equal (K-E's fixed point on
               integer-valued gradients and its ordered sums on the real
               ones, held against the plain version's CPU run; K-E's root
               sums; K-F and K-G fed one histogram), K-H (the collapse
               kernel at one tree a step) with its margins bit-equal and
               its gradients within the stated gap; timed as in phase 2,
               the fixed point's time on the same inputs printed beside;
10. stats kernels -- K-I and K-J (the sanity checker's correlation matrix
               and contingency counts) against their plain versions on the
               sanity checker's 100k-row sample of the ``--train-rows``
               data: K-J bit-equal, K-I within ``STATS_GRAM_ATOL`` of its
               plain version evaluated in float64 (its gap to the float32
               evaluation logged); timed as in phase 2, K-I's bound its
               triangle's work, its launch plan (``gram_plan``) printed
               first;
11. sweep kernels -- K-K, K-L and K-M against their plain versions on the
               first sweep call of the ``--train-rows`` train (its feature
               matrix, folds and candidates): K-K's gradients at the fitted
               coefficients within ``FISTA_GRAD_RTOL``, K-L on the sweep's
               28 score rows and K-M on its deepest forest group bit-equal;
               timed as in phase 2 (K-L's sort timed apart);
12. boston reference -- the Boston workflow's stock regression train (LinReg
               + RF + GBT, 44 candidates, one fused sweep) on the 506-row
               frame, held to the committed fixture ``boston_stock``: the
               same winner (GBT depth 12, min_info_gain 0.1,
               min_instances_per_node 10), the forests' draws equal, each
               family's fold RMSE within ``FX.BOSTON_RMSE_RTOL``, the
               holdout metrics within ``BOSTON_HOLDOUT_RTOL``, and the
               fixture model's predictions for its 256 requests within
               ``FX.PRED_RTOL``; a second run is profiled for the device's
               busy time and idle share;
13. boston train -- the main path of the regression train: the Boston flow
               on a frame of ``--train-rows`` rows drawn from ``--seed`` by
               ``boston_data``'s formula; every kernel's launch count is
               reset just before and read just after (K-A, K-B, K-E ... K-H,
               K-M, K-N, K-O must be above 0), with the wall time and the
               host-clock breakdown; a second run is profiled for the
               device's busy time and idle share;
14. boston kernels -- K-N, K-O and K-H squared (its margins one fused
               multiply-add, bit-equal) against their plain versions on the
               sweep call of the ``--train-rows`` Boston train (its feature
               matrix, folds and candidates), and K-E's ordered sums at the
               deepest GBT group's deepest level and, with the gradients in
               dollars, past the fixed point's 2^32 range (bit-equal to the
               plain version's CPU run on four trees); timed as in phase 2;
15. iris reference -- the Iris workflow's stock multiclass train (softmax LR
               + RF with class-distribution leaves, 26 candidates, one fused
               sweep, the Error metric) on the 150-row frame, held to the
               committed fixture ``iris_stock``: the same winner (RF depth 3,
               min_info_gain 0.001, min_instances_per_node 10), every fold
               Error bit-equal (nine candidates tie at the best mean), the
               forests' fold F1 / Precision / Recall bit-equal and the
               softmax candidates' within ``FX.IRIS_SOFTMAX_METRIC_TOL``, the
               ``DataCutter`` summary and the holdout metrics equal, the
               forests' draws equal, the sweep's feature matrix against the
               fixture's, the fixture model's and the port-saved model's
               answers for the 256 requests; a second run is profiled;
16. iris train -- the main path of the multiclass train: the Iris flow on a
               frame of ``--train-rows`` rows drawn from ``--seed`` by
               ``iris_data``'s formula; every kernel's launch count is reset
               just before and read just after (K-A, K-B, K-C, K-E, K-F,
               K-G, K-M, K-P, K-Q must be above 0), with the wall time and
               the host-clock breakdown; a second run is profiled;
17. iris kernels -- K-P (the sweep call's first FISTA step, and at the
               fitted coefficients), K-Q (the sweep call's [3, 26, n, 3]
               probabilities) and K-E, K-F, K-M over c = 3 class channels
               (one depth-12 forest's deepest level; the depth-12 group's
               leaves) against their plain versions: K-Q, K-E, K-F and K-M
               bit-equal, K-P within ``SOFTMAX_GRAD_RTOL``; timed as in
               phase 2;
18. iris boost reference -- the Iris flow over the 46-candidate space (the
               stock 26 with ``gbt_grid()`` and ``xgboost_grid()``: one fused
               sweep with a softmax "gbt" fragment over three class margins)
               and over the XGB-only space on the 150-row frame, held to the
               committed fixture ``iris_boost``: every fold Error bit-equal,
               the winners, the XGB-only holdout, and the fixture model's
               and the port-saved softmax model's answers for the 256
               requests (``FX.IRIS_PROB_ATOL``, ``FX.IRIS_BOOST_PROB_ATOL``);
19. titanic newton reference -- the Titanic flow over the five pure-L2
               logistic points (Newton fits, the refit Newton's) and over
               the ten-point Newton + FISTA grid on the 891-row frame, held
               to ``titanic_newton`` by ``FX.check_titanic_newton_train``
               (the reg-0 folds' stated gap included), with the Newton
               refit's probabilities within ``FX.NEWTON_PROB_ATOL``;
20. boston ridge reference -- the Boston flow over the five ridge points on
               the 506-row frame, held to ``boston_ridge`` by
               ``FX.check_boston_ridge_train``, the refit's predictions by
               ``FX.compare_ridge_predictions``;
21-23. iris boost / titanic newton / boston ridge train -- the main paths of
               this slice at ``--train-rows`` rows (the 46-candidate Iris
               space, the Newton + FISTA Titanic grid, the ridge grid): the
               launch counts reset just before and read just after (K-R,
               K-E ... K-G, K-Q and the rest of the Iris path; K-S with K-K
               and K-L; K-S with K-N and K-O must be above 0), the K8
               draws' calls counted in the Iris train, the host-clock
               breakdown (the sweep's ``cv_sweep_gbt`` / ``_newton``), a
               profiled second run;
24. slice6 kernels -- K-R (the second round of the Iris train's XGB group),
               K-S in Newton mode (the Titanic train's Newton fits after
               half their steps) and in ridge mode (the Boston train's
               folds), K-M at 19, 20, 24, 32, 33 and 300 trees over one and
               three channels, against their plain versions (K-R's margins
               and K-M bit-equal, K-R's gradients within
               ``BOOST_GRAD_ATOL``, K-S within ``GRAM_RTOL``), timed as in
               phase 2;
24b. kw kernels -- K-W (``threefry_draws``) in its three modes against its
               plain versions, bit for bit, at the Iris 46-candidate train's
               shapes (the Poisson bootstrap of 50 trees at rate 1, a
               forest's feature masks, the subsample masks of 200 rounds at
               0.8 and at 1) and at a rate-0.632 bootstrap, a ties-heavy mask
               draw (2,048 features) and Glorot-sized uniforms; timed as in
               phase 2, bound by the larger of the bytes written and the
               hash's integer operations over the SMs' dispatch rate.  Every
               forest's and boosting fit's draws run through K-W: the
               reference phases hold its bootstraps and masks to the
               fixtures' (891, 455 and 135 rows) and count its launches, and
               the stock and Iris 46 trains require it;
25. families reference -- the binary selector's other families on the
               891-row Titanic frame (``titanic.families_space``): space A
               (LinearSVC, NaiveBayes, DecisionTree, MLP: the per-family
               sweep) and space B (without NaiveBayes: the fused sweep's
               "svc", "forest" and "mlp" fragments), each held to the
               committed ``titanic_families`` fixture by
               ``FX.check_titanic_families_train``, the JAX-saved and the
               port-saved winners (naive Bayes, the MLP) scoring the
               fixture's requests (``FX.compare_family_answers``); the
               one-MLP Iris space's fold Errors against the fixture's;
26-27. families A / B train -- both routes at ``--train-rows`` rows: the
               launch counts reset just before and read just after (K-T,
               K-U both modes, K-V both modes (A), K-E ... K-G, K-M and K-L
               (B) must be above 0), the host-clock breakdown (each
               family's seconds on the per-family path, ``cv_sweep_svc`` /
               ``_mlp`` / ``_forest`` on the fused one), a profiled second
               run;
28. families kernels -- K-T (the SVC fits after half their steps), K-U in
               gradient mode (the MLP fits after ten Adam steps) and in
               forward mode, K-V in mass and score mode, on the space-B
               train's sweep inputs, against their plain versions (K-T
               within ``SVC_GRAD_RTOL``, K-U within ``MLP_GRAD_RTOL`` and
               ``MLP_PROB_ATOL``, K-V within ``NB_RTOL``), timed as in
               phase 2 beside their bounds and one PyTorch call each;
29. boston glm reference -- the Boston flow over the GLM space
               (``boston.glm_space()``: gaussian / identity, poisson / log,
               gamma / log, tweedie / log, each x reg 0.001 / 0.01 / 0.1;
               the per-family sweep) on the 506-row frame, held to
               ``boston_glm`` by ``FX.check_boston_glm_train`` (the winner
               gaussian / identity at 0.001, every fold RMSE within
               ``FX.GLM_RMSE_RTOL``); the JAX-saved winner's answers through
               ``BatchScoreFunction``, the port's refit's by
               ``FX.compare_glm_predictions``, its save loaded back and
               rescored equal;
30. boston glm train -- the same space at ``--train-rows`` rows: K-S's
               launch count reset just before and read just after (above
               0), the fold RMSE against the JAX package's on the fixture's
               2^18-row seed-0 frame (else finite, with a gaussian /
               identity winner), the host-clock breakdown, a profiled second
               run;
31. glm kernels -- K-S in GLM mode against its plain version for each
               (family, link) pair, one IRLS step from the start of each of
               the scale train's fits (within ``GLM_GRAM_RTOL``), timed as in
               phase 2 beside its bound and one ``einsum`` over the given
               weights;
32. sanity reference -- the port's sanity checker on the 891-row Titanic
               vector (the port's vectorizers) in four settings, {pearson,
               spearman} x {in memory, ``sharded_stats=True``}, each held to
               the committed ``titanic_sanity`` fixture (the JAX package's
               dropped features and reasons, label correlations, correlation
               matrix and column moments) by ``FX.check_titanic_sanity``;
33-34. sanity scale trains -- the Titanic flow over the five Newton points on
               a ``titanic_columns(--stats-rows, --seed)`` frame with
               ``sample_upper_limit`` 2^20: every sanity-checker fit (one a
               workflow-level fold, the final one) streams its sample in
               chunks of 2^18 rows; under Pearson in one pass (K-X Chan mode,
               K-I centered), under Spearman in two (K-X raw mode, K-Y's
               ranks, K-I centered); the launch counts reset just before and
               read just after (those kernels and K-S above 0), the final
               fit's summary held to the fixture's (2^20 rows, seed 0), the
               host-clock breakdown, a profiled second run;
35. stream kernels -- K-X in both modes and K-I centered on the final fit's
               first 2^18-row chunk, K-Y over its whole sample (in float32
               and float64, and into a slice of a wider matrix), each again
               at 2^18 x 512 and K-Y on tie-heavy columns, against their
               plain versions (K-Y and K-X's min / max bit-equal, the float64
               sums within ``STREAM_RTOL``), timed as in phase 2 beside their
               bounds (K-I's its triangle's work, its launch plans printed
               first; K-Y's stage beside its own bound, 16 bytes a float32
               position, and its route), one ``torch.mm`` of the centered
               chunk (K-I), one sort + scatter (K-Y) and ``scatter_`` on the
               stage's operands;
36. layer kernels -- K-Z on the Pearson train's final fit's columns: its
               numeric_op on the family size's add and ``+ 1`` (every
               ``--stats-rows`` row: past 200,000 rows a lone stage runs on
               the device, as the JAX package streams it), its column_gather
               on the VectorsCombiner's concatenation and the sanity
               checker's kept columns, against their plain versions (the
               gathers, the add and the ``+ 1`` bit-equal; other operations
               within ``LAYER_RTOL``), timed beside their bounds and one
               ``torch.cat`` / ``index_select``; the scale trains' K-Z
               launch counts must be above 0;
37. text reference -- the JAX-saved Titanic text model (``fixtures/titanic_text``:
               Word2Vec and LDA over a free-text ``Notes`` column, the stock
               space) scores the fixture's 256 requests within
               ``FX.TEXT_JAX_SAVED_PROB_ATOL``; the tokenizer and the fixture's
               count model give the JAX package's tokens and counts; the port's
               891-row full-width text train (``titanic.text_columns()``,
               ``build_workflow(text_embeddings=True)``) is held to the fixture
               by ``FX.check_titanic_text_train`` (winner, fold AuPR by family,
               vocabularies, the final Word2Vec fit's pairs, negatives and W0
               by digest, the word vectors, the LDA topic-word matrix);
38. text train -- the same flow on ``text_columns(--text-rows, --seed)``
               (2^17 rows: ~26M skip-gram pairs, subsampled to 200,000): the
               launch counts reset just before and read just after (K-AA,
               K-AB's three modes and K-K, here past 64 coefficients, above 0),
               the host-clock breakdown (the tokenizer, the count vectorizer,
               pair building, the Word2Vec epochs and transforms, the LDA fits
               and transforms beside the workflow's phases), a profiled second
               run;
39. text kernels -- K-AA (``sgns_epoch``) on the final Word2Vec fit's pairs
               and negatives after ten epochs, K-AB's beta, estep and sstats
               modes on the final LDA fit's count matrix and topic-word matrix,
               K-K at the text vector's width on the first sweep call, against
               their plain versions (K-AA within ``SGNS_CARD_ATOL``, K-AB within
               ``LDA_BETA_RTOL`` / ``LDA_THETA_ATOL`` / ``LDA_SSTATS_RTOL``, K-K
               within ``FISTA_GRAD_RTOL``), and the small K18 cases against the
               JAX package's outputs in ``k18.npz``; timed beside their bounds,
               ``torch.autograd.grad`` of the plain SGNS loss, the dense matmul
               pairs of the E- and M-steps, ``torch.special.digamma``;
40. text serve -- p50 of a ``BatchScoreFunction`` request for the text model
               (an LDA E-step on the request path) at 1, 64 and 1,024 records.
41. wide reference -- the 891-row text flow (85 coefficients) over the
               default ``OpLogisticRegression()`` Newton points and
               ``linear_svc_grid()`` on the card: K-S's and K-T's wide entries
               (launch counts above 0), the JAX package's winner and fold
               AuPR (``fixtures/titanic_text/wide.npz``,
               ``FX.check_titanic_text_wide_train``); K-P's wide entry through
               ``fit_softmax_grid_folds`` on a 2^17 x 84 three-class frame;
42. wide kernels -- K-S (Newton, ridge, GLM), K-P and K-T at p = 85 (2^17
               rows, the text flow's width) and p = 513 (2^15 rows) against
               their plain versions, timed beside their bounds (float64
               operations over the card's 34 TFLOP/s float64 rate);
43. scale kernels -- K-AC in every mode on a 2^20-row Age column and K-AD at
               2^20 x 24 against their plain versions (bit-equal; log and exp
               within 2 ulps), beside ``torch.where`` / ``torch.bucketize``;
44. stream  -- the JAX package's transform bench pipeline (``bench.py:212-251``:
               a fill, two real vectorizers, a combiner and a vector standard
               scaler fitted on a 50,000-row head) at ``--stream-rows`` (2^22)
               rows through the
               streaming executor and through the layer path: equal outputs,
               both walls, chunks, bytes up and back, the transfer wait, and
               each run's peak device memory beside the layer path's bytes
               (the streamed peak must stay within its chunk window);
45. simple reference -- TransmogrifAI's OpTitanicSimple feature set
               (``build_workflow(reference_features=True)``) over the stock
               space on the 891-row frame, held to ``fixtures/titanic_simple``
               (``FX.check_titanic_simple_train``), and the JAX-saved model's
               256 answers;
46. simple train -- the same flow on ``titanic_data(--train-rows, --seed)``:
               every flush streams; K-AC, K-Z, K-C and K-D launch counts above
               0, the breakdown, the executor's counters and a profiled run;
47. simple score -- the trained model's ``score`` of ``--rows`` rows (one
               streamed run of the scoring DAG; rows/s) and p50 of
               ``BatchScoreFunction`` at 1, 64 and 1,024 records;
48. collapse reference -- round-collapsed boosting on the reference frames
               against the JAX package's fixtures: the Titanic stock space
               under ``TMOG_GBT_ROUND_COLLAPSE=4`` (50 steps of 10 levels for
               the XGB fragment) and the collapsed XGB-only space
               (``trees_per_round=4``, draws at 0.8) against
               ``fixtures/titanic_collapse`` (the JAX package's winner, XGB
               fold AuPR within ``FX.COLLAPSE_XGB_AUPR_TOL``), the JAX-saved
               collapsed model's 256 answers and the port-saved winner's, Iris
               XGB at K = 4 (every fold Error bit-equal) and Boston's stock
               space under K = 4 (fold RMSE within ``FX.BOSTON_RMSE_RTOL``);
49. collapse train -- the Titanic stock space on ``--train-rows`` rows at
               K = 4 and K = 1 in turn (walls, grower levels, idle shares,
               peak device memory), then Iris XGB and Boston's stock space at
               K = 4: each collapse mode's launch count above 0 on its path;
50. collapse kernels -- K-H's collapse mode (logistic, squared) and K-R's on
               a collapsed step of those trains' real inputs against their
               plain versions (margins bit-equal), timed beside their bounds;
51. branches reference -- the Titanic stock space under the multiclass
               selector (a two-class label) and under the binary selector's
               train/validation split, against ``fixtures/titanic_branches``
               (``FX.check_titanic_branches_train``), and the calibration,
               log-loss and forecast evaluators on their scores;
52. logistic sweep -- ``parallel/sweep.sharded_logistic_sweep`` on the
               ``--train-rows`` Titanic vector (3 folds, 8 l2 values) with
               K-AE's launches counted, and K-AE against its plain version,
               timed beside its bound and ``torch.matmul`` of the margins;
53. many reference -- the multiclass selector past 8 classes on a
               Letter-Recognition-shaped flow (``fixtures.letters_data``):
               the 26-class stock train against ``letters_stock``, the
               JAX-saved and port-saved 26-class models' answers, the
               ``many_class`` trains (26 and 64 classes fused, 70
               per-family, 10-class softmax boosting at trees_per_round 1
               and 4 and the full XGBoost grid), a 100-class per-family
               train against the same train on the CPU;
54. many train -- the stock space at 26 classes on 2^16 rows, 64 on 2^15
               and 26 on 2^17 (four fused candidate chunks), each a main
               path: launches, wall, busy time, idle share, peak memory;
55. many kernels -- K-P, K-Q, K-E, K-F and K-M at 26 and 64 classes on those
               trains' sweep calls against their plain versions (the plain
               versions timed over 5 runs);
56. many extra kernels -- off the path: K-R's step and collapse modes at 26
               and 64 classes, K-P's wide entry at 26 classes and p = 85,
               K-B over a 26-class forest;
57. wide reference -- the tiled K-U, K-V, K-AA and K-AB at fixture size:
               the Letter flow over naive Bayes and the MLP at 26 classes
               (600 rows) against ``letters_families`` and the JAX-saved
               winner's answers, the wide text flows ("embed": Word2Vec at
               300 dimensions, LDA at 100 topics, the stock space and the
               MLP (128, 64, 32); "bow": the count vector and LDA, naive
               Bayes and the MLP) on the 891-row frame against
               ``wide_text`` (``FX.fixture_gaps``: candidates, winners,
               widths and answers held, and every fold gap within its
               tolerance but ``FX.WIDE_TEXT_OPEN_GAP``'s, printed beside
               it);
58. letters families train -- that Letter flow at 2^16 rows: launches (K-U
               both modes and K-V both modes above 0), wall, busy time, idle
               share, its winner held to the fixture size's;
59. wide text trains -- the two text flows on ``--wide-text-rows`` rows
               (2^16: half of ``--text-rows``, so that the script stays near
               1,000 s; K-AA,
               K-AB's three modes, K-U both modes, and K-V both modes in
               "bow", above 0), likewise ("embed"'s winner printed beside
               the fixture size's, not held: ``SCALE_WINNER_UNHELD``);
60. wide kernels -- K-U at (32, 128, 64, 26) and at the embedding flow's
               (d, 128, 64, 32, 2) and the bag of words' (d, 10, 2), K-V at
               the bag of words' width and at 26 classes, K-AA at 300
               dimensions and K-AB at 100 topics, each on its train's own
               inputs against its plain version, timed beside its bound and
               a PyTorch call computing the same function.  K-U's entry is
               printed with each shape: the GEMM-shaped one past
               ``MLP_BLOCK_PARAMS`` parameters a fit (the text networks),
               the block one below it.

Since slice 15 the trees' sums follow the reference's float32 order: K-E's
ordered path (real-valued gradients) is held bit for bit against its plain
version in phases 9 (Titanic), 14 (Boston's GBT group) and 17 / 55 (3, 26
and 64 class channels made real), K-F's prefix sums in XLA's blocked order
on those histograms, K-E's root sums in phase 9; the one-tree boosting step
runs on the collapse kernel (phases 9, 14, 19: margins bit-equal for the
logistic, squared and softmax losses); phases 6 and 12 print the refit
trees equal to the fixture's.

The line before the last holds the kernels' JSON record, then the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.  Any
failed build, launch or comparison raises, so the script exits non-zero
without that line.  There is no CPU path.
"""
import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
#: HBM3 bytes/s, and float32 / int32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
#: 32-bit integer operations/s: the SMs' dispatch rate, one warp instruction a
#: scheduler a clock (4 x 32 lanes a SM, 132 SMs, the 1.98 GHz clock of the
#: float32 peak above), which no instruction mix exceeds.  The 64 INT32 lanes
#: a SM are no bound: K-W's uniform mode ran 19e12 hash operations/s on the
#: card (PERF.md, PR 8), the compiler issuing integer adds to the FMA pipe too
PEAK_INT32_OPS_PER_S = 4 * 32 * 132 * 1.98e9
BATCH_SIZES = (1, 64, 1024)
#: largest gap of a fold's AuPR to the committed fixture's (trained by the
#: JAX package's fused sweep, its metrics in float32): the card sums the
#: histograms in fixed point and its exp may differ by an ulp, so near-tied
#: splits can flip.  Measured on the H100: 2.7e-5 and 1.9e-5 in two runs
TRAIN_AUPR_TOL = 2e-4
#: largest gap of K-I's correlation matrix to its plain version evaluated in
#: float64: the kernel's float32 sums within a row tile (float64 across
#: tiles) and its float32 result's rounding
STATS_GRAM_ATOL = 2e-6
#: largest gap of K-K's and K-N's gradients to their plain versions (cuBLAS
#: products), relative to the largest gradient entry: float32 sums of 2^18
#: rows in another order
FISTA_GRAD_RTOL = 1e-5
#: K-O against its plain version: both sum in float64 (in other orders) and
#: round to float32 once, so at most an ulp apart
REG_METRIC_RTOL = 2e-7
#: the Boston refit's holdout metrics against the fixture's, relative
BOSTON_HOLDOUT_RTOL = 1e-5
#: largest gap of K-P's gradients to its plain version (cuBLAS products),
#: relative to the largest gradient entry: float32 sums in another order
SOFTMAX_GRAD_RTOL = 1e-6
#: the dollars of a Boston target in thousands: the rescaled K-E case's
#: gradients, whose sums leave 2^32's fixed-point range
DOLLARS = 1e4


def check(cond, msg="check failed"):
    if not cond:
        raise AssertionError(msg)


#: the script's start, for each phase line's ``t_s``
T0 = time.perf_counter()


def log(phase, **fields):
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0, **fields}), flush=True)


def titanic_columns(n, seed):
    """A Titanic-schema columnar batch of ``n`` rows from ``seed``."""
    rng = np.random.default_rng(seed)
    cols = {
        "PassengerId": np.arange(1, n + 1),
        "Survived": rng.integers(0, 2, n),
        "Pclass": rng.choice([1, 2, 3], n),
        "Name": rng.choice(["p", "q"], n, p=[0.95, 0.05]).astype(object),
        "Sex": rng.choice(["male", "female"], n).astype(object),
        "Age": rng.uniform(1, 80, n),
        "SibSp": rng.integers(0, 4, n),
        "Parch": rng.integers(0, 3, n),
        "Fare": rng.uniform(5, 100, n),
        "Embarked": rng.choice(["S", "C", "Q"], n).astype(object),
    }
    cols["Age"][rng.random(n) < 0.2] = np.nan
    cols["Fare"][rng.random(n) < 0.01] = np.nan
    cols["Embarked"][rng.random(n) < 0.01] = None
    return cols


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median milliseconds of a callable over ``reps`` runs, by CUDA events,
    with the 50 MB L2 flushed before each run (the serve path meets its
    inputs cold).  A spin of the card after the flush holds the start event
    back until the host has queued the call's kernels, so the time is the
    card's and not the host's launch overhead."""

    SPIN_CYCLES = 2_000_000  # ~1.1 ms at the H100's boost clock

    def __init__(self, torch, reps):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn):
        torch = self.torch
        fn()  # warm-up: compiles a Triton kernel on its first call
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def zero_launches(kernels):
    """Set every kernel's launch count to 0 (K-W's counts of each mode too)."""
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode = dict.fromkeys(fn.launches_by_mode, 0)


def bound_ms(n_bytes, n_ops, ops_per_s=PEAK_SCALAR_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hist_bits(Tr, ghw):
    """The scale bits of the K-E path that ``level_hist`` takes for ``ghw``
    (``Tr.hist_exact``): the fixed point's, or None for the ordered sums."""
    return Tr.HIST_SCALE_BITS if Tr.hist_exact(ghw) else None


def hist_against_plain(torch, Tr, e_args, trees, what):
    """K-E's output on ``e_args`` against its plain version run on the CPU
    (on the card ``index_add_`` takes float atomics, so the row order of
    the plain version's sums holds there only), over the first ``trees``
    trees of the batch: bit-equal, or raise naming ``what``."""
    sub = [a[:trees] if isinstance(a, torch.Tensor) and a.ndim >= 2 and i != 0 else a
           for i, a in enumerate(e_args)]
    got = Tr.level_hist(*sub)
    want = Tr.level_hist_plain(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in sub])
    check(torch.equal(got.cpu(), want), f"level_hist differs from plain ({what})")
    check(torch.equal(got, Tr.level_hist(*sub)), f"level_hist does not repeat ({what})")
    return got


def ptxas_summary(log_text):
    """nvcc's ``-Xptxas=-v`` report as one line per kernel: its mangled name
    (the template arguments in it), registers, spills, shared memory."""
    out, name = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "registers" in ln or "spill" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def profiled(torch, fn):
    """Run ``fn`` under the profiler, the card's activity alone: (wall
    seconds, the device's busy seconds or None when it recorded no device
    activity, the idle share, the top 12 (kernel, device seconds, count)).
    The card's events are summed from the profiler's raw results: its
    per-operator tables (``key_averages``) took much of the host time of
    the longest train phases."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy_ns, by_name = 0, {}
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() != DeviceType.CUDA or (annotation is not None and annotation()):
            continue
        d = e.duration_ns()
        if d > 0:
            busy_ns += d
            acc = by_name.setdefault(e.name(), [0, 0])
            acc[0] += d
            acc[1] += 1
    busy_s = busy_ns / 1e9 if busy_ns > 0 else None
    by_kernel = sorted(((k, v[0] / 1e9, v[1]) for k, v in by_name.items()),
                       key=lambda r: -r[1])[:12]
    return wall, busy_s, None if busy_s is None else 1 - busy_s / wall, by_kernel


def walk_steps(tree, leaves, max_depth):
    """Node visits the walk made for these rows: the depth of each (row,
    tree) leaf, from a breadth-first pass over the pools."""
    sf = tree.split_feat.cpu().numpy()
    lt, rt = tree.left.cpu().numpy(), tree.right.cpu().numpy()
    T = sf.shape[0]
    depth = np.zeros(sf.shape, np.int64)
    tt, nn = np.arange(T), np.zeros(T, np.int64)
    for level in range(1, max_depth + 1):
        keep = sf[tt, nn] >= 0
        tt, nn = tt[keep], nn[keep]
        if not tt.size:
            break
        tt, nn = np.concatenate([tt, tt]), np.concatenate([lt[tt, nn], rt[tt, nn]])
        depth[tt, nn] = level
    leaves = leaves.cpu().numpy()
    return int(depth[np.arange(T)[None, :], leaves].sum())


def kernel_phase(torch, model, cols, timer):
    """Each kernel against its plain version on the main path's inputs."""
    from transmogrifai_tpu_torch.ops import trees as Tr
    from transmogrifai_tpu_torch.ops import vectorize as V

    dev = model.device
    full = model.score(cols, keep_intermediate_features=True)
    by_type = {type(s).__name__: s for s in model.stages}
    rv, oh, sel = by_type["RealVectorizerModel"], by_type["OneHotVectorizerModel"], model.stages[-1]

    def upload(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    rv_cols = [full[f.name] for f in rv.inputs]
    values, mask, fills = upload([np.stack([np.asarray(c.values, np.float32) for c in rv_cols]),
                                  np.stack([c.mask for c in rv_cols]),
                                  np.asarray(rv.fills, np.float32)])
    (codes,) = upload(oh.torch_host_prep([full[f.name] for f in oh.inputs]))
    widths = oh._widths()
    X = full[sel.inputs[-1].name].tensor(dev)
    dparams = sel._device_params()
    edges, tree = dparams["edges"], dparams["tree"]
    depth, eta = int(dparams["max_depth"]), float(dparams["eta"])
    Xb = Tr.bin_rows_plain(X, edges)
    track = bool(rv.track_nulls)
    n, d = X.shape
    k, W = values.shape[0], 2 * values.shape[0] if track else values.shape[0]
    T, P, c = tree.leaf_val.shape
    XT = X.T.contiguous()
    records = []

    # K-A bin_rows
    got, want = Tr.bin_rows(X, edges), Tr.bin_rows_plain(X, edges)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
    check(torch.equal(got, want) and got.dtype == want.dtype, "bin_rows differs from plain")
    levels = Tr._search_levels(edges.shape[1])
    b, by = bound_ms(n * d * 4 + edges.numel() * 4 + n * d * got.element_size(),
                     n * d * levels)
    records.append(dict(
        name="bin_rows", route="cuda", source="transmogrifai_tpu_torch/csrc/bin_rows.cu",
        replaces="transmogrifai_tpu/ops/trees.py:84", max_abs_err=float(err),
        ms=timer(lambda: Tr.bin_rows(X, edges)),
        plain_ms=timer(lambda: Tr.bin_rows_plain(X, edges)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.searchsorted(edges, XT, side="left"))))

    # K-B ensemble_walk
    F, leaves = Tr.ensemble_walk(Xb, tree, depth, "sum", eta, 0.0, return_leaves=True)
    F0, leaves0 = Tr.ensemble_walk_plain(Xb, tree, depth, "sum", eta, 0.0, return_leaves=True)
    torch.cuda.synchronize()
    check(torch.equal(leaves, leaves0), "ensemble_walk leaves differ from plain")
    torch.testing.assert_close(F, F0, atol=1e-5, rtol=1e-5)
    steps = walk_steps(tree, leaves, depth)
    pool_bytes = T * P * (4 * 4 + 4 * c)
    b, by = bound_ms(n * d * Xb.element_size() + pool_bytes + n * c * 4,
                     2 * steps + n * T * c)
    records.append(dict(
        name="ensemble_walk", route="cuda",
        source="transmogrifai_tpu_torch/csrc/ensemble_walk.cu",
        replaces="transmogrifai_tpu/ops/trees.py:665", max_abs_err=float((F - F0).abs().max()),
        ms=timer(lambda: Tr.ensemble_walk(Xb, tree, depth, "sum", eta, 0.0)),
        plain_ms=timer(lambda: Tr.ensemble_walk_plain(Xb, tree, depth, "sum", eta, 0.0)),
        bound_ms=b, bound_by=by, library_ms=None, node_steps=steps))
    del F0, leaves0

    # K-C fill_indicator
    got = V.fill_indicator(values, mask, fills, track)
    want = V.fill_indicator_plain(values, mask, fills, track)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "fill_indicator differs from plain")
    b, by = bound_ms(k * n * 5 + k * 4 + n * W * 4, n * W)
    records.append(dict(
        name="fill_indicator", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_vectorize.py",
        replaces="transmogrifai_tpu/impl/feature/vectorizers.py:108",
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: V.fill_indicator(values, mask, fills, track)),
        plain_ms=timer(lambda: V.fill_indicator_plain(values, mask, fills, track)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-D one_hot_codes
    got, want = V.one_hot_codes(codes, widths), V.one_hot_codes_plain(codes, widths)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "one_hot_codes differs from plain")
    Wd = sum(widths)
    b, by = bound_ms(codes.numel() * 4 + 2 * Wd * 4 + n * Wd * 4, n * Wd)
    codes_l = [codes[j].long() for j in range(len(widths))]

    def library_one_hot():
        return torch.cat([torch.nn.functional.one_hot(cj, w)
                          for cj, w in zip(codes_l, widths)], dim=1)

    records.append(dict(
        name="one_hot_codes", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_vectorize.py",
        replaces="transmogrifai_tpu/impl/feature/vectorizers.py:403",
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: V.one_hot_codes(codes, widths)),
        plain_ms=timer(lambda: V.one_hot_codes_plain(codes, widths)),
        bound_ms=b, bound_by=by, library_ms=timer(library_one_hot)))
    log("kernels", rows=n, shapes={"X": [n, d], "edges": list(edges.shape),
                                   "pool": [T, P, c], "fill_values": [k, n],
                                   "one_hot_widths": widths},
        records=records)
    return records


def serve_phase(torch, model, cols, reps, seed, kernels):
    """The main path: request batches through ``BatchScoreFunction``, a few
    records through ``ScoreFunction``, and the big batch through
    ``OpWorkflowModel.score``; returns each kernel's launches in it."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX

    name = model.result_features[0].name
    batch_fn = P.BatchScoreFunction(model)
    row_fn = P.ScoreFunction(model)
    recs = FX.records(titanic_columns(max(BATCH_SIZES), seed + 1))
    rows = len(next(iter(cols.values())))
    zero_launches(kernels)
    p50 = {}
    for size in BATCH_SIZES:
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            out = batch_fn(recs[:size])
            times.append((time.perf_counter() - t) * 1e3)
            check(len(out) == size, f"{len(out)} answers for {size} records")
            _, prob, _ = FX.prediction_arrays(out, name)
            check(np.isfinite(prob).all() and np.allclose(prob.sum(1), 1.0), "bad probabilities")
        p50[size] = statistics.median(times)
    singles = [row_fn(r) for r in recs[:4]]
    t = time.perf_counter()
    scored = model.score(cols)
    wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels}
    pc = scored[name]
    check(pc.probability.shape == (rows, 2) and np.isfinite(pc.probability).all(),
          "bad scores of the big batch")
    check(np.isfinite(pc.raw_prediction).all(), "non-finite margins")
    for a, b in zip(singles, batch_fn(recs[:4])):
        check(abs(a[name]["probability_1"] - b[name]["probability_1"]) <= FX.PROB_ATOL,
              "ScoreFunction and BatchScoreFunction disagree")
    log("serve", p50_ms_by_batch=p50, rows=rows, score_s=wall,
        rows_per_s=rows / wall, launches=launches)
    return launches


def breakdown_phase(torch, model, cols):
    """Where the big batch's time goes, on the route ``score`` takes: the
    reader, the one streamed run of the scoring DAG (its wall and counters
    from ``stream_stats``) and the host stages after it, each timed again
    on the run's output (synchronized), and the device's busy time over one
    whole ``score`` by the profiler (``None`` when it records no device
    activity)."""
    from transmogrifai_tpu_torch.readers.base import CustomReader
    from transmogrifai_tpu_torch.workflow import dag, stream

    steps = {}
    t = time.perf_counter()
    ds = CustomReader(cols).generate_dataset(model.raw_features)
    steps["reader"] = time.perf_counter() - t
    check(len(ds) > dag.STREAM_ROWS, "the breakdown's batch does not stream")
    plan = stream.build_plan(ds, model.dag)
    stream.reset_stream_stats()
    t = time.perf_counter()
    out = dag.apply_transformations_dag(ds, model.dag,
                                        keep=[f.name for f in model.result_features])
    torch.cuda.synchronize()
    steps["dag"] = time.perf_counter() - t
    st = stream.stream_stats()
    check(st["streams"] == 1, "the scoring DAG did not stream as one run")
    steps["streamed_run"] = st["wall_s"]
    for i, layer in enumerate(plan.host_layers):
        for s in layer:
            t = time.perf_counter()
            s.transform_dataset(out)
            torch.cuda.synchronize()
            steps[f"host{i}:{type(s).__name__}"] = time.perf_counter() - t
    wall, busy_s, idle, _ = profiled(torch, lambda: model.score(cols))
    log("breakdown", rows=len(ds), host_clock_s=steps, stream=st,
        stages_streamed=[type(e.stage).__name__ for e in plan.stages],
        profiled_score_s=wall, device_busy_s=busy_s, device_idle_share=idle)


def train_reference_phase(torch, titanic, FX, dev="cuda"):
    """The full-width Titanic XGB train on the 891-row frame, held to the
    committed fixture; returns nothing, raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    t = time.perf_counter()
    model, wf = titanic.train_titanic(device=dev, model_types=["OpXGBoostClassifier"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with open(FX.TITANIC_XGB + "/op_model.json") as fh:
        fx = json.load(fh)["stages"][-1]["state"]
    fsum = fx["summary"]["__jsonable__"]["data"]
    summ = model.stages[-1].summary
    check(summ.best_grid == fsum["bestGrid"] and summ.best_grid["min_child_weight"] == 1.0,
          f"winner {summ.best_grid} differs from the fixture's {fsum['bestGrid']}")
    gaps = []
    for mine, ref in zip(summ.validation_results, fsum["validationResults"]):
        check(mine["grid"] == ref["grid"], "candidate order differs from the fixture's")
        gaps.append(max(abs(a - b) for a, b in zip(mine["foldMetrics"], ref["foldMetrics"])))
    # refit trees node for node equal to the fixture's (printed, not checked)
    same, total = FX.refit_trees_equal(model, FX.TITANIC_XGB)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        req = FX.load_columns(FX.TITANIC_XGB + "/requests.npz")
        pred, prob, raw, Xb, F = FX.port_answers(loaded, req)
    exp = FX.load_expected()
    off = np.abs(np.asarray(exp["F"], np.float64)[:, 0]) >= FX.BOUNDARY
    log("train_reference", rows=891, wall_s=wall, best_grid=summ.best_grid,
        fold_aupr={str(r["grid"]["min_child_weight"]): r["foldMetrics"]
                   for r in summ.validation_results},
        fixture_fold_aupr={str(r["grid"]["min_child_weight"]): r["foldMetrics"]
                           for r in fsum["validationResults"]},
        fold_aupr_max_gap=max(gaps), tolerance=TRAIN_AUPR_TOL,
        refit_trees_equal_to_fixture=f"{same}/{total}",
        requests_vs_expected={
            "prediction_mismatches_off_boundary": int(np.sum(pred[off] != exp["prediction"][off])),
            "probability_max_abs_err": float(np.max(np.abs(prob - exp["probability"]))),
            "margin_max_abs_err": float(np.max(np.abs(F - exp["F"]))),
            "Xb_mismatches": int(np.sum(Xb != exp["Xb"]))},
        timings_s=wf.train_timings)
    check(max(gaps) <= TRAIN_AUPR_TOL,
          f"fold AuPR {max(gaps)} from the fixture's, above {TRAIN_AUPR_TOL}")


class SweepCalls:
    """Records each fused sweep call's plan, folds and metrics while on
    (``SweepPlan.run`` wrapped, restored on exit)."""

    def __init__(self):
        from transmogrifai_tpu_torch.impl import sweep_fragments as SF

        self.SF, self.calls = SF, []

    def __enter__(self):
        run = self.run = self.SF.SweepPlan.run

        def recording_run(plan, train_w, val_mask, timings=None):
            out = run(plan, train_w, val_mask, timings)
            self.calls.append((plan, train_w, val_mask, out))
            return out

        self.SF.SweepPlan.run = recording_run
        return self

    def __exit__(self, *exc):
        self.SF.SweepPlan.run = self.run


def sweep_reference_phase(torch, titanic, FX, dev="cuda"):
    """The full-width stock train on the 891-row frame, held to the
    committed stock fixture; raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import trees as Tr

    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = titanic.train_titanic(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    summ = model.stages[-1].summary
    gaps = FX.check_stock_train(model, xgb_tol=TRAIN_AUPR_TOL)
    ref = FX.load_sweep()
    kb, kf = Tr.rng_keys(42)
    before = Tr.R.threefry_draws.launches
    boot = Tr.bootstrap_weights(kb, 891, 50, device=dev).cpu().numpy()
    masks = Tr.feature_masks(kf, 10, 50, np.sqrt(10) / 10, dev).cpu().numpy()
    check(Tr.R.threefry_draws.launches == before + 2, "the draws did not launch K-W")
    check(np.array_equal(boot, ref["bootstrap"]), "bootstrap draws differ from the fixture's")
    check(np.array_equal(masks, ref["feature_masks"]), "feature masks differ from the fixture's")
    mine = np.stack([out for *_, out in rec.calls])
    check(mine.shape == ref["metrics"].shape, f"sweep metrics {mine.shape}")
    fams = {"lr": slice(0, 8), "rf": slice(8, 26), "xgb": slice(26, 28)}
    metric_gaps = {f: dict(zip(("AuROC", "AuPR", "Error", "Precision", "Recall", "F1"),
                               np.abs(mine[:, :, sl] - ref["metrics"][:, :, sl])
                               .max(axis=(0, 1, 2)).tolist())) for f, sl in fams.items()}
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        req = FX.load_columns(FX.TITANIC_STOCK + "/requests.npz")
        name = loaded.result_features[0].name
        pred, prob, raw = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(req)),
                                               name)
    answers = FX.compare(FX.load_expected(FX.TITANIC_STOCK + "/expected.npz"), pred, prob, raw)
    log("sweep_reference", rows=891, wall_s=wall, best=summ.best_model_name,
        best_grid=summ.best_grid, fold_aupr_max_gap_by_family=gaps,
        tolerances={"lr": FX.LR_AUPR_TOL, "rf": FX.RF_AUPR_TOL, "xgb": TRAIN_AUPR_TOL},
        sweep_calls=len(rec.calls), metric_max_gap_by_family=metric_gaps,
        draws_equal=True, requests_vs_expected=answers, timings_s=wf.train_timings)


def train_phase(torch, titanic, rows, seed, kernels, dev="cuda"):
    """The main path of training at ``rows`` rows: launch counts reset just
    before and read just after; then a profiled second run.  Returns (each
    kernel's launches, the trained model, the first sweep call)."""
    cols = titanic.titanic_data(rows, seed)
    zero_launches(kernels)
    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = titanic.train_titanic(cols, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels}
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 28, "the stock space has 28 candidates")
    check(all(np.isfinite(folds)) and min(folds) > 0.5, f"bad fold metrics {folds}")
    check(summ.holdout_evaluation["AuPR"] > 0.5, "bad holdout AuPR")
    timings = dict(wf.train_timings)
    prof_wall, busy_s, idle, by_kernel = profiled(
        torch, lambda: titanic.train_titanic(cols, device=dev))
    plan = rec.calls[0][0]
    log("train", rows=rows, wall_s=wall, launches=launches, host_clock_s=timings,
        best=summ.best_model_name, best_grid=summ.best_grid,
        fold_aupr_by_family={f: [r["foldMetrics"] for r in summ.validation_results
                                 if r["modelName"] == f]
                             for f in ("OpLogisticRegression", "OpXGBoostClassifier")},
        holdout_aupr=summ.holdout_evaluation["AuPR"], sweep_spec=repr(plan.spec),
        sweep_rows=int(plan.X.shape[0]), sweep_features=int(plan.X.shape[1]),
        profiled_train_s=prof_wall, device_busy_s=busy_s, device_idle_share=idle,
        device_s_by_kernel=by_kernel)
    return launches, model, rec.calls[0][:3]


def grow_levels(torch, Tr, Xb, ghw, fm, params, depth, B, frontier, exact, nodes, leaf):
    """One batch of trees through K-E, K-F and K-G, level by level, into the
    pools ``nodes`` and ``leaf``: the deepest level's arguments of each, its
    histograms, the child block's width and the rows' nodes."""
    T, n = ghw.shape[:2]
    row_slot = torch.zeros((T, n), dtype=torch.int32, device=Xb.device)
    row_node = torch.zeros_like(row_slot)
    n_active = torch.ones((T,), dtype=torch.int32, device=Xb.device)
    ids, hist, pp, pl = row_slot, None, None, None
    for t, (m, sb, nf, nc, cap) in enumerate(Tr.level_schedule(depth, frontier, exact)):
        e_args = (Xb, ghw, ids, m, B) + ((hist, pp, pl) if t else ())
        hist = Tr.level_hist(*e_args)
        f_args = (hist, fm, params, n_active, nodes, leaf, sb, nf, nc, cap, t == 0)
        split, pp, pl, n_active = Tr.split_scan(*f_args)
        g_args = (Xb, row_slot, row_node, split, pl, nf)
        row_slot, row_node, ids = Tr.route_rows(*g_args)
    return e_args, f_args, g_args, hist, nc, row_node


def train_kernel_phase(torch, model, timer, dev="cuda"):
    """K-E ... K-H against their plain versions at the train path's shapes:
    the inputs of the deepest level of the second round of one sweep fold
    (T = 2 trees: min_child_weight 1 and 10) on the trained model's feature
    matrix.  The first round's gradients (margins 0) are two dyadic values,
    which every order sums exactly; the second round's are not."""
    from transmogrifai_tpu_torch.ops import trees as Tr

    dev = torch.device(dev)
    sel = model.stages[-1]
    X = model.train_data[sel.inputs[-1].name].tensor(dev)
    y = torch.from_numpy(model.train_data[sel.inputs[0].name].values.astype(np.float32)).to(dev)
    depth, B, T = 10, 32, 2
    Xb, _ = Tr.quantize(X, B)
    n, d = Xb.shape
    n_tr = 2 * n // 3  # one fold's training rows; the rest only route
    w = torch.zeros((T, n), device=dev)
    w[:, :n_tr] = 1.0
    frontier = Tr.frontier_cap(n, depth, 1.0, h_max=0.25, max_frontier=256,
                               total_weight=float(n_tr))
    exact = Tr.frontier_is_exact(n, depth, 1.0, 0.25, frontier, total_weight=float(n_tr))
    params = torch.tensor([[1.0, 0.8, 1.0, 0.0], [1.0, 0.8, 10.0, 0.0]], device=dev)
    fm = torch.ones((T, d), device=dev)
    eta = torch.full((T,), 0.02, device=dev)
    F = torch.zeros((T, n), device=dev)
    ghw = torch.empty((T, n, 2), device=dev)
    P_ = Tr._pool_size(depth, frontier)
    nodes = torch.empty((T, P_, 4), dtype=torch.int32, device=dev)
    leaf = torch.empty((T, P_), device=dev)

    def grow():
        return grow_levels(torch, Tr, Xb, ghw, fm, params, depth, B, frontier, exact, nodes,
                           leaf)

    Tr.boost_step(F, y, w, eta, ghw=ghw)
    *_, row_node = grow()
    Tr.boost_step(F, y, w, eta, leaf, row_node, ghw)  # the second round's gradients
    scaled = ghw * 1024.0
    non_dyadic = float((scaled != torch.round(scaled)).float().mean())
    check(non_dyadic > 0.25, f"second-round gradients mostly dyadic ({non_dyadic})")
    e_args, f_args, g_args, hist, nc, row_node = grow()
    torch.cuda.synchronize()
    records = []
    m_deep = e_args[3]

    # K-E level_hist: the fixed-point path on integer-valued gradients and
    # the ordered path (the reference's float32 row order) on the second
    # round's real ones, each bit-equal to its plain version and to itself;
    # the root mode's sums in XLA's order bit-equal to plain's
    ghw_int = torch.round(ghw * 64.0)
    int_args = (Xb, ghw_int) + e_args[2:]
    check(hist_bits(Tr, ghw_int) == Tr.HIST_SCALE_BITS and hist_bits(Tr, ghw) is None,
          "level_hist's paths: integer gradients fixed point, real ones ordered")
    hist_against_plain(torch, Tr, int_args, T, "integer-valued gradients")
    got = hist_against_plain(torch, Tr, e_args, T, "the ordered sums")
    err_e = 0.0
    rs = Tr.root_sums(ghw)
    check(torch.equal(rs, Tr.root_sums_plain(ghw)), "root_sums differs from plain")
    b, by = bound_ms(T * n * 2 * 4 + T * 2 * 4, T * n * 2)
    records.append(dict(
        name="root_sums", route="cuda", source="transmogrifai_tpu_torch/csrc/level_hist.cu",
        replaces="transmogrifai_tpu/ops/trees.py:587", max_abs_err=0.0,
        ms=timer(lambda: Tr.root_sums(ghw)), plain_ms=timer(lambda: Tr.root_sums_plain(ghw)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: ghw.sum(1))))
    pairs = m_deep // 2
    idx = (e_args[2].long() * B)[:, None, :] + Xb.long().T[None]
    dead = (e_args[2] < 0)[:, None, :].expand(T, d, n)
    seg_n = pairs * B + 1
    offs = (torch.arange(T * d, device=dev) * seg_n).view(T, d, 1)
    idx = torch.where(dead, pairs * B, idx) + offs
    idx = idx.reshape(-1)
    src = ghw[:, None].expand(T, d, n, 2).reshape(-1, 2).contiguous()
    zeros = torch.zeros((T * d * seg_n, 2), device=dev)
    hist_bytes = T * m_deep * 2 * d * B * 4
    # Xb once, g, h and the pair id per (tree, row), the parent histograms,
    # the pairs' parent and flag, the level's histograms written once
    b, by = bound_ms(n * d + T * n * 12 + e_args[5].numel() * 4 + T * pairs * 8 + hist_bytes,
                     T * n * d * 2)
    records.append(dict(
        name="level_hist", route="cuda", source="transmogrifai_tpu_torch/csrc/level_hist.cu",
        replaces="transmogrifai_tpu/ops/trees.py:327", max_abs_err=err_e,
        ms=timer(lambda: Tr.level_hist_launch(*e_args, scale_bits=None)),
        plain_ms=timer(lambda: Tr.level_hist_plain(*e_args)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.index_add(zeros, 0, idx, src))))
    fixed_ms = timer(lambda: Tr.level_hist_launch(*e_args, scale_bits=Tr.HIST_SCALE_BITS))

    # K-F split_scan: one histogram for both, every output bit-equal
    outs = []
    for fn in (Tr.split_scan, Tr.split_scan_plain):
        nd, lf = f_args[4].clone(), f_args[5].clone()
        outs.append((nd, lf) + tuple(fn(*f_args[:4], nd, lf, *f_args[6:])))
    check(all(torch.equal(a, b) for a, b in zip(*outs)), "split_scan differs from plain")
    # the histograms read once, the slot records and split records written,
    # the child block's records and leaves and the next pairs written; about
    # 14 operations per candidate split (prefix sums, gain, masks, argmax)
    b, by = bound_ms(hist_bytes + T * m_deep * (16 + 16) + T * nc * (16 + 4) + T * nc * 4,
                     T * m_deep * d * B * 14)
    records.append(dict(
        name="split_scan", route="cuda", source="transmogrifai_tpu_torch/csrc/split_scan.cu",
        replaces="transmogrifai_tpu/ops/trees.py:449", max_abs_err=0.0,
        ms=timer(lambda: Tr.split_scan(*f_args)),
        plain_ms=timer(lambda: Tr.split_scan_plain(*f_args[:4], f_args[4].clone(),
                                                   f_args[5].clone(), *f_args[6:])),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-G route_rows: the same records for both, bit-equal
    got, want = Tr.route_rows(*g_args), Tr.route_rows_plain(*g_args)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "route_rows differs from plain")
    # per (tree, row): slot and node read, one bin read, slot, node and pair
    # id written; the split records and pair flags read once
    b, by = bound_ms(T * n * (4 + 4 + 1 + 4 + 4 + 4) + T * m_deep * 16 + T * pairs * 4,
                     T * n * 4)
    records.append(dict(
        name="route_rows", route="cuda", source="transmogrifai_tpu_torch/csrc/route_rows.cu",
        replaces="transmogrifai_tpu/ops/trees.py:524", max_abs_err=0.0,
        ms=timer(lambda: Tr.route_rows(*g_args)),
        plain_ms=timer(lambda: Tr.route_rows_plain(*g_args)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-H boost_step: the next round's step on this round's tree
    F1, F2 = F.clone(), F.clone()
    g1, g2 = torch.empty_like(ghw), torch.empty_like(ghw)
    Tr.boost_step(F1, y, w, eta, leaf, row_node, g1)
    Tr.boost_step_plain(F2, y, w, eta, leaf, row_node, g2)
    check(torch.equal(F1, F2), "boost_step margins differ from plain")
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=2.5e-7)
    err_h = float((g1 - g2).abs().max())
    # per (tree, row): F read and written, w and the row's node read, g and
    # h written; y, eta and the leaf table once (its gathers hit the cache);
    # about 12 operations
    b, by = bound_ms(T * n * (4 + 4 + 4 + 4 + 8) + n * 4 + T * 4 + leaf.numel() * 4,
                     T * n * 12)
    records.append(dict(
        name="boost_step", route="triton", source="transmogrifai_tpu_torch/ops/triton_boost.py",
        replaces="transmogrifai_tpu/ops/trees.py:1117", max_abs_err=err_h,
        ms=timer(lambda: Tr.boost_step(F1, y, w, eta, leaf, row_node, g1)),
        plain_ms=timer(lambda: Tr.boost_step_plain(F2, y, w, eta, leaf, row_node, g2)),
        bound_ms=b, bound_by=by, library_ms=None))
    # the wrapper's path check waits for the card: its time, apart
    check_ms = timer(lambda: Tr.level_hist(*e_args))
    log("train_kernels", rows=n, shapes={"Xb": [n, d], "ghw": [T, n, 2],
                                         "hist": list(hist.shape), "pool": [T, P_],
                                         "frontier": frontier, "exact_cap": exact},
        round=2, non_dyadic_share=non_dyadic, level_hist_with_path_check_ms=check_ms,
        level_hist_fixed_point_ms=fixed_ms, records=records)
    return records


def stats_kernel_phase(torch, model, timer, dev="cuda"):
    """K-I and K-J against their plain versions at the train path's shapes:
    the sanity checker's inputs on the ``--train-rows`` data (its 100k-row
    sample of the combined vector, standardized for K-I; the categorical
    groups' indicator columns and the label classes for K-J)."""
    from transmogrifai_tpu_torch.ops import stats as K

    dev = torch.device(dev)
    sc = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel")
    X = model.train_data[sc.inputs[1].name].tensor(dev)
    meta = model.train_data[sc.inputs[1].name].metadata
    y = np.asarray(model.train_data[sc.inputs[0].name].values, np.float64)
    n_all = X.shape[0]
    idx = np.random.default_rng(42).choice(n_all, size=min(n_all, 100_000), replace=False)
    X = X.index_select(0, torch.as_tensor(idx, device=dev))
    y = y[idx]
    n, d = X.shape
    X64 = X.double()
    Z = ((X64 - X64.mean(0)) / torch.sqrt(torch.clamp(X64.var(0), min=1e-300))).float()
    cols = [i for i, cm in enumerate(meta.columns) if cm.feature_group() is not None]
    Xc = X[:, cols].contiguous()
    classes = np.unique(y)
    cls = torch.from_numpy(np.searchsorted(classes, y).astype(np.int32)).to(dev)
    c, dc = len(classes), len(cols)
    records = []

    # K-I corr_gram (its launch plan first): float32 sums within a row tile,
    # float64 across tiles, held to its plain version evaluated in float64.
    # On this sample a float32 evaluation (cuBLAS) drifts from the float64
    # one by more than the tolerance (7.9e-6, where the kernel reads 1.2e-7:
    # this phase's log, PERF.md PR 19), so it cannot tell the kernel's error
    # from its own; the gap to it is logged beside
    log("stats_plans", corr_gram=K.gram_plan(n, d, "corr")._asdict())
    got, want = K.corr_gram(Z), K.corr_gram_plain(Z.double()).float()
    check(torch.equal(got, K.corr_gram(Z)), "corr_gram does not repeat bit for bit")
    finite = torch.isfinite(want)
    check(torch.equal(finite, torch.isfinite(got)), "corr_gram differs from plain in NaN/inf")
    err_i = float((got - want)[finite].abs().max())
    check(err_i <= STATS_GRAM_ATOL, f"corr_gram {err_i} from plain, above {STATS_GRAM_ATOL}")
    want32 = K.corr_gram_plain(Z)
    gap32 = float((got - want32)[finite].abs().max())
    gap32_exact = float((want32 - want)[finite].abs().max())
    # Z read once, the d x d matrix written once; the triangle's n d (d + 1) / 2
    # multiply-adds (the matrix is symmetric)
    b, by = bound_ms(n * d * 4 + d * d * 4, n * d * (d + 1))
    records.append(dict(
        name="corr_gram", route="cuda", source="transmogrifai_tpu_torch/csrc/col_stats.cu",
        replaces="transmogrifai_tpu/utils/stats.py:47", max_abs_err=err_i,
        ms=timer(lambda: K.corr_gram(Z)), plain_ms=timer(lambda: K.corr_gram_plain(Z)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: torch.mm(Z.T, Z))))

    # K-J contingency_counts: integer counts, bit-equal
    got, want = K.contingency_counts(Xc, cls, c), K.contingency_counts_plain(Xc, cls, c)
    check(torch.equal(got, want), "contingency_counts differs from plain")
    zeros = torch.zeros((c, dc), device=dev)
    cls_l = cls.long()
    # the columns and classes read once, the counts written once; one add
    # per (row, column)
    b, by = bound_ms(n * dc * 4 + n * 4 + dc * c * 4, n * dc)
    records.append(dict(
        name="contingency_counts", route="cuda",
        source="transmogrifai_tpu_torch/csrc/col_stats.cu",
        replaces="transmogrifai_tpu/utils/stats.py:137",
        max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: K.contingency_counts(Xc, cls, c)),
        plain_ms=timer(lambda: K.contingency_counts_plain(Xc, cls, c)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: torch.index_add(zeros, 0, cls_l, Xc))))
    log("stats_kernels", rows=n, shapes={"Z": [n, d], "indicators": [n, dc], "classes": c},
        corr_gram_gap_to_float32_plain=gap32, float32_plain_gap_to_float64=gap32_exact,
        records=records)
    return records


def fista_inputs(torch, plan, tw, fit_fn):
    """The sweep's FISTA fragment fitted by ``fit_fn`` and the gradient
    kernels' arguments at its coefficients: (X1, y, w, fold, z, l2v,
    wsum), the fits' fold weight rows [C, n], and C."""
    X, y, blob = plan.X, plan.y, np.asarray(plan.blob, np.float32)
    dev = X.device
    n, d = X.shape
    F = tw.shape[0]
    _, cis, max_iter, fit_icpt, off_l1, off_l2 = next(f for f in plan.spec[1]
                                                      if f[0] == "fista")
    G = len(cis)
    l1, l2 = blob[off_l1:off_l1 + G], blob[off_l2:off_l2 + G]
    fit = fit_fn(X, y, tw, l1, l2, max_iter=max_iter, fit_intercept=fit_icpt)
    C, p = F * G, d + 1
    z = torch.cat([fit.coef, fit.intercept], -1).reshape(C, p).contiguous()
    X1 = torch.cat([X, torch.ones((n, 1), device=dev)], 1).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    l2v = torch.as_tensor(np.tile(l2, F), device=dev)[:, None].repeat(1, p).contiguous()
    l2v[:, -1] = 0.0
    wsum = torch.clamp_min(tw.sum(1), 1e-12)[fold.long()].contiguous()
    return (X1, y, tw, fold, z, l2v, wsum), tw[fold.long()], C


def sweep_kernel_phase(torch, call, timer):
    """K-K, K-L and K-M against their plain versions on the first sweep call
    of the ``--train-rows`` train: its feature matrix, folds and spec."""
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import sweep as SW
    from transmogrifai_tpu_torch.ops import trees as Tr

    plan, train_w, val_mask = call
    X, y, xbs, blob = plan.X, plan.y, plan.xbs, plan.blob
    dev = X.device
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
    vm = torch.as_tensor(np.asarray(val_mask, np.float32), device=dev)
    n, d = X.shape
    F = tw.shape[0]
    frags = {f[0]: f for f in plan.spec[1]}
    records = []

    # K-K fista_grad: the gradients at the sweep's fitted coefficients
    args, wc, C = fista_inputs(torch, plan, tw, L.fit_logistic_grid_folds_fista)
    X1, z, l2v, wsum = args[0], args[4], args[5], args[6]
    p = d + 1
    got, want = L.fista_grad(*args), L.fista_grad_plain(*args)
    check(torch.equal(got, L.fista_grad(*args)), "fista_grad does not repeat bit for bit")
    scale = float(want.abs().max())
    err_k = float((got - want).abs().max())
    check(err_k <= FISTA_GRAD_RTOL * scale,
          f"fista_grad {err_k} from plain, above {FISTA_GRAD_RTOL} x {scale}")
    # X1, each fold's weights and y read once, z / l2v / wsum read and the
    # gradients written; per (fit, row) the margin and the accumulation
    # (4 p operations) and the sigmoid and residual (about 20)
    b, by = bound_ms((n * p + F * n + n) * 4 + C * (3 * p + 1) * 4, C * n * (4 * p + 20))
    records.append(dict(
        name="fista_grad", route="cuda", source="transmogrifai_tpu_torch/csrc/fista.cu",
        replaces="transmogrifai_tpu/ops/linear.py:105", max_abs_err=err_k,
        ms=timer(lambda: L.fista_grad(*args)), plain_ms=timer(lambda: L.fista_grad_plain(*args)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.matmul(wc * (torch.sigmoid(torch.matmul(X1, z.T)).T - y),
                                              X1) / wsum[:, None] + l2v * z)))

    # K-L binary_metrics: the sweep's 28 score rows, sorted once
    scores = SW._all_scores(plan.spec, X, xbs, y, tw, np.asarray(blob, np.float32))
    R = scores.shape[0] * scores.shape[1]
    ss, order = M.sort_scores(scores, vm)
    strict = torch.as_tensor(plan.spec[2], dtype=torch.int32, device=dev)
    margs = (ss, order, y, vm, strict, scores.shape[1])
    got, want = M.binary_metrics(*margs), M.binary_metrics_plain(*margs)
    check(torch.equal(got, want), "binary_metrics differs from plain")
    # the sorted scores and permutation, y and the masks read once, six
    # floats a row written; about 12 operations an element in two passes
    b, by = bound_ms(R * n * (4 + 8) + n * 4 + F * n * 4 + R * 6 * 4, R * n * 12)
    sort_ms = timer(lambda: M.sort_scores(scores, vm))
    records.append(dict(
        name="binary_metrics", route="cuda",
        source="transmogrifai_tpu_torch/csrc/binary_metrics.cu",
        replaces="transmogrifai_tpu/ops/metrics.py:57", max_abs_err=0.0,
        ms=timer(lambda: M.binary_metrics(*margs)),
        plain_ms=timer(lambda: M.binary_metrics_plain(*margs)),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-M forest_leaf_mean: the deepest forest group's leaves
    group = max(frags["forest"][2], key=lambda g: g[1])
    leaf, row_node = SW.grow_forest_group(group, xbs, y, tw, np.asarray(blob, np.float32))
    leaf = leaf[..., 0]  # one channel: p(class 1)
    Gg, T, P_ = leaf.shape
    got, want = Tr.forest_leaf_mean(leaf, row_node), Tr.forest_leaf_mean_plain(leaf, row_node)
    check(torch.equal(got, want), "forest_leaf_mean differs from plain")
    rn_long = row_node.long()
    # the rows' leaves read once, the pools read once, the means written
    b, by = bound_ms(Gg * T * n * 4 + Gg * T * P_ * 4 + Gg * n * 4, Gg * T * n)
    records.append(dict(
        name="forest_leaf_mean", route="triton", source="transmogrifai_tpu_torch/ops/triton_forest.py",
        replaces="transmogrifai_tpu/ops/sweep.py:253", max_abs_err=0.0,
        ms=timer(lambda: Tr.forest_leaf_mean(leaf, row_node)),
        plain_ms=timer(lambda: Tr.forest_leaf_mean_plain(leaf, row_node)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: leaf.gather(2, rn_long).mean(1))))
    log("sweep_kernels", rows=n, shapes={"X1": [n, p], "fits": C, "score_rows": R,
                                         "forest_group": [Gg, T, P_], "depth": group[1]},
        fista_grad_scale=scale, sort_ms=sort_ms, records=records)
    return records


def boston_reference_phase(torch, boston, FX, dev="cuda"):
    """The stock regression train on the 506-row Boston frame, held to the
    committed fixture; raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import trees as Tr

    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = boston.train_boston(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    summ = model.stages[-1].summary
    gaps = FX.check_boston_train(model)
    ref = FX.load_sweep(FX.BOSTON_STOCK + "/sweep.npz")
    kb, kf = Tr.rng_keys(42)
    before = Tr.R.threefry_draws.launches
    boot = Tr.bootstrap_weights(kb, 455, 50, device=dev).cpu().numpy()
    masks = Tr.feature_masks(kf, 16, 50, 1.0 / 3.0, dev).cpu().numpy()
    check(Tr.R.threefry_draws.launches == before + 2, "the draws did not launch K-W")
    check(np.array_equal(boot, ref["bootstrap"]), "bootstrap draws differ from the fixture's")
    check(np.array_equal(masks, ref["feature_masks"]), "feature masks differ from the fixture's")
    mine = np.stack([out for *_, out in rec.calls])
    check(mine.shape == ref["metrics"].shape, f"sweep metrics {mine.shape}")
    fams = {"linreg": slice(0, 8), "rf": slice(8, 26), "gbt": slice(26, 44)}
    names = ("RootMeanSquaredError", "MeanSquaredError", "R2", "MeanAbsoluteError")
    metric_gaps = {f: dict(zip(names, (np.abs(mine[:, :, sl] - ref["metrics"][:, :, sl])
                                       / np.abs(ref["metrics"][:, :, sl])).max(axis=(0, 1, 2))
                               .tolist())) for f, sl in fams.items()}
    with open(FX.BOSTON_STOCK + "/op_model.json") as fh:
        fsum = FX.stage_summary(json.load(fh))
    holdout = {k: abs(summ.holdout_evaluation[k] / fsum["holdoutEvaluation"][k] - 1.0)
               for k in names}
    check(max(holdout.values()) <= BOSTON_HOLDOUT_RTOL,
          f"holdout metrics {holdout} from the fixture's, above {BOSTON_HOLDOUT_RTOL}")
    req = FX.load_columns(FX.BOSTON_STOCK + "/requests.npz")
    expected = FX.load_expected(FX.BOSTON_STOCK + "/expected.npz")["prediction"]
    fixture_model = P.load_model(FX.BOSTON_STOCK, device=dev)
    name = fixture_model.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(fixture_model)(FX.records(req)), name)
    pred_err = float(np.max(np.abs(pred - expected) / np.maximum(np.abs(expected), 1.0)))
    check(np.allclose(pred, expected, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL),
          f"the fixture model's predictions {pred_err} from the JAX package's")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        mine_pred = FX.regression_predictions(P.BatchScoreFunction(loaded)(FX.records(req)),
                                              loaded.result_features[0].name)
    prof_wall, busy_s, idle, by_kernel = profiled(torch, lambda: boston.train_boston(device=dev))
    same, total = FX.refit_trees_equal(model, FX.BOSTON_STOCK)
    log("boston_reference", rows=506, wall_s=wall, best=summ.best_model_name,
        refit_trees_equal_to_fixture=f"{same}/{total}",
        best_grid=summ.best_grid, fold_rmse_max_rel_gap_by_family=gaps,
        tolerances=FX.BOSTON_RMSE_RTOL, sweep_calls=len(rec.calls),
        metric_max_rel_gap_by_family=metric_gaps, draws_equal=True,
        holdout=summ.holdout_evaluation, holdout_rel_gap=holdout,
        fixture_model_prediction_max_rel_err=pred_err,
        port_model_prediction_rmse_to_fixture=float(np.sqrt(np.mean((mine_pred - expected) ** 2))),
        timings_s=wf.train_timings, profiled_train_s=prof_wall, device_busy_s=busy_s,
        device_idle_share=idle, device_s_by_kernel=by_kernel)


def boston_train_phase(torch, boston, rows, seed, kernels, dev="cuda"):
    """The main path of the regression train at ``rows`` rows: launch counts
    reset just before and read just after; then a profiled second run.
    Returns (each kernel's launches, the sweep call)."""
    cols = boston.boston_data(rows, seed)
    zero_launches(kernels)
    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = boston.train_boston(cols, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels}
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 44, "the stock regression space has 44 candidates")
    check(all(np.isfinite(folds)) and min(folds) > 0, f"bad fold RMSE {folds}")
    check(summ.holdout_evaluation["R2"] > 0.5, "bad holdout R2")
    timings = dict(wf.train_timings)
    prof_wall, busy_s, idle, by_kernel = profiled(
        torch, lambda: boston.train_boston(cols, device=dev))
    plan = rec.calls[0][0]
    log("boston_train", rows=rows, wall_s=wall, launches=launches, host_clock_s=timings,
        best=summ.best_model_name, best_grid=summ.best_grid,
        best_fold_rmse=next(r["foldMetrics"] for r in summ.validation_results
                            if (r["modelName"], r["grid"]) == (summ.best_model_name,
                                                               summ.best_grid)),
        holdout=summ.holdout_evaluation, sweep_spec=repr(plan.spec),
        sweep_rows=int(plan.X.shape[0]), sweep_features=int(plan.X.shape[1]),
        profiled_train_s=prof_wall, device_busy_s=busy_s, device_idle_share=idle,
        device_s_by_kernel=by_kernel)
    return launches, rec.calls[0]


def boston_kernel_phase(torch, call, timer):
    """K-N, K-O and K-H squared against their plain versions on the sweep
    call of the ``--train-rows`` Boston train, and K-E at a scale below
    2^32."""
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import sweep as SW
    from transmogrifai_tpu_torch.ops import trees as Tr

    plan, train_w, val_mask, out = call
    X, y, xbs, blob = plan.X, plan.y, plan.xbs, np.asarray(plan.blob, np.float32)
    dev = X.device
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
    vm = torch.as_tensor(np.asarray(val_mask, np.float32), device=dev).contiguous()
    n, d = X.shape
    F = tw.shape[0]
    frags = {f[0]: f for f in plan.spec[1]}
    records = []

    # K-N linear_fista_grad: the gradients at the sweep's fitted coefficients
    args, wc, C = fista_inputs(torch, plan, tw, L.fit_linear_grid_folds_fista)
    X1, z, l2v, wsum = args[0], args[4], args[5], args[6]
    p = d + 1
    got, want = L.linear_fista_grad(*args), L.linear_fista_grad_plain(*args)
    check(torch.equal(got, L.linear_fista_grad(*args)),
          "linear_fista_grad does not repeat bit for bit")
    scale_n = float(want.abs().max())
    err_n = float((got - want).abs().max())
    check(err_n <= FISTA_GRAD_RTOL * scale_n,
          f"linear_fista_grad {err_n} from plain, above {FISTA_GRAD_RTOL} x {scale_n}")
    # X1, each fold's weights and y read once, z / l2v / wsum read and the
    # gradients written; per (fit, row) the margin and the accumulation
    # (4 p operations) and the residual (3)
    b, by = bound_ms((n * p + F * n + n) * 4 + C * (3 * p + 1) * 4, C * n * (4 * p + 3))
    records.append(dict(
        name="linear_fista_grad", route="cuda", source="transmogrifai_tpu_torch/csrc/fista.cu",
        replaces="transmogrifai_tpu/ops/linear.py:211", max_abs_err=err_n,
        ms=timer(lambda: L.linear_fista_grad(*args)),
        plain_ms=timer(lambda: L.linear_fista_grad_plain(*args)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.matmul(wc * (torch.matmul(X1, z.T).T - y), X1)
                         / wsum[:, None] + l2v * z)))

    # K-O regression_metrics: the sweep's 44 candidates' predictions
    scores = SW._all_scores(plan.spec, X, xbs, y, tw, blob)
    Cs = scores.shape[1]
    R = F * Cs
    preds = scores.reshape(R, n).contiguous()
    got, want = M.regression_metrics(preds, y, vm, Cs), M.regression_metrics_plain(preds, y, vm, Cs)
    check(torch.equal(got, M.regression_metrics(preds, y, vm, Cs)),
          "regression_metrics does not repeat bit for bit")
    # the sweep ran the same fits: its metrics are these (the fits' cuBLAS
    # products aside, bit for bit)
    check(np.allclose(got.reshape(F, Cs, 4).cpu().numpy(), out, rtol=1e-6, atol=0),
          "regression_metrics differs from the sweep's own metrics")
    err_o = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    check(err_o <= REG_METRIC_RTOL, f"regression_metrics {err_o} from plain, above "
          f"{REG_METRIC_RTOL} (relative)")
    # the predictions read once, y and the masks read once, four floats a
    # row written; about 10 operations an element
    b, by = bound_ms(R * n * 4 + n * 4 + F * n * 4 + R * 16, R * n * 10)
    records.append(dict(
        name="regression_metrics", route="cuda",
        source="transmogrifai_tpu_torch/csrc/regression_metrics.cu",
        replaces="transmogrifai_tpu/ops/metrics.py:136", max_abs_err=float((got - want).abs().max()),
        ms=timer(lambda: M.regression_metrics(preds, y, vm, Cs)),
        plain_ms=timer(lambda: M.regression_metrics_plain(preds, y, vm, Cs)),
        bound_ms=b, bound_by=by, library_ms=None))
    del scores, preds

    # K-H squared: the deepest GBT group's second round (T = F x 6 trees)
    group = max(frags["gbt"][3], key=lambda g: g[2])
    (gcis, _, depth, xb_idx, n_bins, _, _, _, frontier, exact_cap, _, _, off_eta, off_lam,
     off_gam, off_mcw, off_mig) = group
    Xb, Gc = xbs[xb_idx], len(gcis)
    T = F * Gc
    w_b = tw.repeat_interleave(Gc, dim=0).contiguous()
    hp = [torch.as_tensor(np.tile(blob[o:o + Gc], F), device=dev)
          for o in (off_eta, off_lam, off_gam, off_mcw, off_mig)]
    eta, params = hp[0], torch.stack([hp[1].clamp_min(1e-6)] + hp[2:], dim=1)
    base = ((y[None] * tw).sum(1) / torch.clamp_min(tw.sum(1), 1e-12)).repeat_interleave(Gc)
    Fm = base[:, None].expand(T, n).contiguous()
    ghw = torch.empty((T, n, 2), device=dev)
    Tr.boost_step(Fm, y, w_b, eta, ghw=ghw, loss="squared")
    _, leaf, row_node = Tr.grow_trees(Xb, ghw, torch.ones((T, d), device=dev), params, depth,
                                      n_bins, frontier, exact_cap)
    F1, F2 = Fm.clone(), Fm.clone()
    g1, g2 = torch.empty_like(ghw), torch.empty_like(ghw)
    Tr.boost_step(F1, y, w_b, eta, leaf, row_node, g1, "squared")
    Tr.boost_step_plain(F2, y, w_b, eta, leaf, row_node, g2, "squared")
    check(torch.equal(F1, F2) and torch.equal(g1, g2), "boost_step (squared) differs from plain")
    # per (tree, row): F read and written, w and the row's node read, g and
    # h written; y, eta and the leaf table once; about 4 operations
    b, by = bound_ms(T * n * (4 + 4 + 4 + 4 + 8) + n * 4 + T * 4 + leaf.numel() * 4,
                     T * n * 4)
    records.append(dict(
        name="boost_step_squared", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_boost.py",
        replaces="transmogrifai_tpu/ops/trees.py:1118", max_abs_err=0.0,
        ms=timer(lambda: Tr.boost_step(F1, y, w_b, eta, leaf, row_node, g1, "squared")),
        plain_ms=timer(lambda: Tr.boost_step_plain(F2, y, w_b, eta, leaf, row_node, g2,
                                                   "squared")),
        bound_ms=b, bound_by=by, library_ms=None))

    # K-E ordered at the group's shapes: its deepest level on the first
    # round's squared-loss gradients (real-valued), bit-equal to plain on
    # four of its trees; and its root level with the gradients in dollars,
    # past the fixed point's 2^32 range, which the ordered sums have not
    check(hist_bits(Tr, ghw) is None, "the squared-loss gradients took the fixed point")
    P_ = Tr._pool_size(depth, frontier)
    e_args, *_ = grow_levels(torch, Tr, Xb, ghw, torch.ones((T, d), device=dev), params, depth,
                             n_bins, frontier, exact_cap,
                             torch.empty((T, P_, 4), dtype=torch.int32, device=dev),
                             torch.empty((T, P_), device=dev))
    hist_against_plain(torch, Tr, e_args, 4, "Boston's GBT group, deepest level")
    m_deep, pairs = e_args[3], e_args[3] // 2
    hist_bytes = T * m_deep * 2 * d * n_bins * 4
    idx = (e_args[2].long() * n_bins)[:, None, :] + Xb.long().T[None]
    dead = (e_args[2] < 0)[:, None, :].expand(T, d, n)
    seg_n = pairs * n_bins + 1
    offs = (torch.arange(T * d, device=dev) * seg_n).view(T, d, 1)
    idx = (torch.where(dead, pairs * n_bins, idx) + offs).reshape(-1)
    src = ghw[:, None].expand(T, d, n, 2).reshape(-1, 2).contiguous()
    zeros = torch.zeros((T * d * seg_n, 2), device=dev)
    b, by = bound_ms(n * d + T * n * 12 + e_args[5].numel() * 4 + T * pairs * 8 + hist_bytes,
                     T * n * d * 2)
    records.append(dict(
        name="level_hist_squared", route="cuda",
        source="transmogrifai_tpu_torch/csrc/level_hist.cu",
        replaces="transmogrifai_tpu/ops/trees.py:327", max_abs_err=0.0,
        ms=timer(lambda: Tr.level_hist_launch(*e_args, scale_bits=None)),
        plain_ms=timer(lambda: Tr.level_hist_plain(*e_args)), bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.index_add(zeros, 0, idx, src))))
    fixed_ms = timer(lambda: Tr.level_hist_launch(*e_args, scale_bits=Tr.HIST_SCALE_BITS))
    del idx, src, zeros
    factor = max(DOLLARS, 2.0 ** 34 / (n * float(g1.abs().amax())))
    big = (g1 * factor).contiguous()
    bits = Tr.hist_scale_bits(n, float(big.abs().amax()))
    check(bits < Tr.HIST_SCALE_BITS, f"the rescaled K-E case kept {bits} bits")
    ids = torch.zeros((T, n), dtype=torch.int32, device=dev)
    hist_against_plain(torch, Tr, (Xb, big, ids, 1, n_bins), 4, "dollar-scaled gradients")
    log("boston_kernels", rows=n, shapes={"X1": [n, p], "fits": C, "score_rows": R,
                                          "gbt_trees": T, "depth": depth},
        linear_fista_grad_scale=scale_n, level_hist_squared_fixed_point_ms=fixed_ms,
        level_hist_rescaled={
            "factor": factor, "fixed_point_scale_bits": bits, "bit_equal_to_plain": True,
            "ms": timer(lambda: Tr.level_hist_launch(Xb, big, ids, 1, n_bins))},
        records=records)
    return records


def iris_reference_phase(torch, iris, FX, dev="cuda"):
    """The stock multiclass train on the 150-row Iris frame, held to the
    committed fixture; raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import trees as Tr

    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = iris.train_iris(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    found = FX.check_iris_train(model)
    ref = FX.load_sweep(FX.IRIS_STOCK + "/sweep.npz")
    check(len(rec.calls) == 1, f"{len(rec.calls)} sweep calls, the fixture has one")
    plan, train_w, val_mask, out = rec.calls[0]
    mine = out[None]
    check(mine.shape == ref["metrics"].shape, f"sweep metrics {mine.shape}")
    lr, rf = slice(0, 8), slice(8, 26)
    check(np.array_equal(mine[..., rf, :], ref["metrics"][..., rf, :]),
          "the forests' fold metrics differ from the fixture's")
    check(np.array_equal(mine[..., 3], ref["metrics"][..., 3]),
          "fold Errors differ from the fixture's")
    lr_gap = float(np.abs(mine[..., lr, :3] - ref["metrics"][..., lr, :3]).max())
    check(lr_gap <= FX.IRIS_SOFTMAX_METRIC_TOL,
          f"softmax candidates' F1/P/R {lr_gap} from the fixture's, above "
          f"{FX.IRIS_SOFTMAX_METRIC_TOL}")
    check(np.array_equal(np.asarray(train_w), ref["train_w"])
          and np.array_equal(np.asarray(val_mask), ref["val_mask"]), "folds differ")
    x_gap = float(np.abs(plan.X.cpu().numpy() - ref["X"]).max())
    check(x_gap == 0.0, f"the sweep's feature matrix {x_gap} from the fixture's")
    kb, kf = Tr.rng_keys(42)
    before = Tr.R.threefry_draws.launches
    boot = Tr.bootstrap_weights(kb, 135, 50, device=dev).cpu().numpy()
    masks = Tr.feature_masks(kf, 8, 50, np.sqrt(8) / 8, dev).cpu().numpy()
    check(Tr.R.threefry_draws.launches == before + 2, "the draws did not launch K-W")
    check(np.array_equal(boot, ref["bootstrap"]), "bootstrap draws differ from the fixture's")
    check(np.array_equal(masks, ref["feature_masks"]), "feature masks differ from the fixture's")
    req = FX.load_columns(FX.IRIS_STOCK + "/requests.npz")
    exp = FX.load_expected(FX.IRIS_STOCK + "/expected.npz")
    answers = {}
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        for who, path in (("fixture_model", FX.IRIS_STOCK), ("port_saved_model", tmp)):
            m = P.load_model(path, device=dev)
            pred, prob, _ = FX.multiclass_predictions(
                P.BatchScoreFunction(m)(FX.records(req)), m.result_features[0].name, 3)
            err = float(np.abs(prob - exp["probability"]).max())
            check(np.array_equal(pred, exp["prediction"]) and err <= FX.IRIS_PROB_ATOL,
                  f"the {who}'s answers differ from the JAX package's (probability {err})")
            answers[who] = {"prediction_mismatches": 0, "probability_max_abs_err": err}
    prof_wall, busy_s, idle, by_kernel = profiled(torch, lambda: iris.train_iris(device=dev))
    summ = model.stages[-1].summary
    log("iris_reference", rows=150, wall_s=wall, best=summ.best_model_name,
        best_grid=summ.best_grid, **{k: v for k, v in found.items() if k != "holdout"},
        softmax_metric_max_gap=lr_gap, tolerance=FX.IRIS_SOFTMAX_METRIC_TOL,
        forest_metrics_bit_equal=True, fold_errors_bit_equal=True, draws_equal=True,
        data_prep=summ.data_prep_results, holdout=summ.holdout_evaluation,
        requests_vs_expected=answers, timings_s=wf.train_timings,
        profiled_train_s=prof_wall, device_busy_s=busy_s, device_idle_share=idle,
        device_s_by_kernel=by_kernel)


def iris_train_phase(torch, iris, rows, seed, kernels, dev="cuda"):
    """The main path of the multiclass train at ``rows`` rows: launch counts
    reset just before and read just after; then a profiled second run.
    Returns (each kernel's launches, the sweep call)."""
    frame = iris.iris_data(rows, seed)
    zero_launches(kernels)
    with SweepCalls() as rec:
        t = time.perf_counter()
        model, wf = iris.train_iris(frame, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in kernels}
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 26, "the stock multiclass space has 26 candidates")
    check(all(np.isfinite(folds)) and 0.0 <= min(folds) and max(folds) < 0.5,
          f"bad fold Errors {folds}")
    check(summ.holdout_evaluation["Error"] < 0.1, "bad holdout Error")
    timings = dict(wf.train_timings)
    prof_wall, busy_s, idle, by_kernel = profiled(
        torch, lambda: iris.train_iris(frame, device=dev))
    plan = rec.calls[0][0]
    log("iris_train", rows=rows, wall_s=wall, launches=launches, host_clock_s=timings,
        best=summ.best_model_name, best_grid=summ.best_grid,
        best_fold_error=next(r["foldMetrics"] for r in summ.validation_results
                             if (r["modelName"], r["grid"]) == (summ.best_model_name,
                                                                summ.best_grid)),
        holdout={k: v for k, v in summ.holdout_evaluation.items() if k != "ThresholdMetrics"},
        data_prep=summ.data_prep_results, sweep_spec=repr(plan.spec),
        sweep_rows=int(plan.X.shape[0]), sweep_features=int(plan.X.shape[1]),
        profiled_train_s=prof_wall, device_busy_s=busy_s, device_idle_share=idle,
        device_s_by_kernel=by_kernel)
    return launches, rec.calls[0]


def iris_kernel_phase(torch, call, timer, names=None, phase="iris_kernels", plain_timer=None,
                      tree_call=None):
    """K-P, K-Q and c = 3 K-E / K-F / K-M against their plain versions on
    the sweep call of the ``--train-rows`` Iris train (any multiclass sweep
    call: ``names`` renames the records, ``plain_timer`` times the plain
    versions, ``tree_call`` gives K-E / K-F / K-M their forests)."""
    names = {**{b: b for b in ("softmax_fista_grad", "multiclass_metrics")},
             **{b: b + "_c3" for b in ("level_hist", "split_scan", "forest_leaf_mean")},
             **(names or {})}
    plain_timer = plain_timer or timer
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import sweep as SW
    from transmogrifai_tpu_torch.ops import trees as Tr

    plan, train_w, val_mask, out = call
    X, y, xbs, blob = plan.X, plan.y, plan.xbs, np.asarray(plan.blob, np.float32)
    dev = X.device
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
    vm = torch.as_tensor(np.asarray(val_mask, np.float32), device=dev).contiguous()
    n, d = X.shape
    F = tw.shape[0]
    k = plan.spec[0][1]
    frags = {f[0]: f for f in plan.spec[1]}
    records = []

    # K-P softmax_fista_grad: the sweep's first FISTA step (all coefficients
    # 0), and the gradients at the fitted coefficients
    _, cis, max_iter, fit_icpt, off_l1, off_l2 = frags["fista"]
    G = len(cis)
    l1, l2 = blob[off_l1:off_l1 + G], blob[off_l2:off_l2 + G]
    C, p = F * G, d + 1
    X1 = torch.cat([X, torch.ones((n, 1), device=dev)], 1).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    l2m = torch.as_tensor(np.tile(l2, F), device=dev)[:, None, None].repeat(1, p, k)
    l2m[:, -1] = 0.0
    l2m = l2m.contiguous()
    wsum = torch.clamp_min(tw.sum(1), 1e-12)[fold.long()].contiguous()
    fit = L.fit_softmax_grid_folds(X, y, tw, l1, l2, num_classes=k, max_iter=max_iter,
                                   fit_intercept=fit_icpt)
    z_fit = torch.cat([fit.coef, fit.intercept[:, :, None]], 2).reshape(C, p, k).contiguous()
    z0 = torch.zeros((C, p, k), device=dev)
    errs, scales, to_f64 = [], [], []
    for z in (z0, z_fit):
        args = (X1, y, tw, fold, z, l2m, wsum)
        got, want = L.softmax_fista_grad(*args), L.softmax_fista_grad_plain(*args)
        check(torch.equal(got, L.softmax_fista_grad(*args)),
              "softmax_fista_grad does not repeat bit for bit")
        exact = L.softmax_fista_grad_plain(*(a.double() if a.is_floating_point() else a
                                             for a in args))
        to_f64.append({"kernel": float((got - exact).abs().max()),
                       "plain": float((want - exact).abs().max())})
        scales.append(float(want.abs().max()))
        errs.append(float((got - want).abs().max()))
        check(errs[-1] <= SOFTMAX_GRAD_RTOL * scales[-1],
              f"softmax_fista_grad {errs[-1]} from plain, above {SOFTMAX_GRAD_RTOL} x "
              f"{scales[-1]}")
    args = (X1, y, tw, fold, z0, l2m, wsum)
    library_grad = softmax_library(torch, *args)

    # X1, each fold's weights and y read once, the coefficients and penalties
    # read and the gradients written; per (fit, row) the margins and the
    # accumulation (4 p k operations) and the softmax and residual (~6 k)
    b, by = bound_ms((n * p + F * n + n) * 4 + C * p * k * 4 * 3 + C * 4,
                     C * n * (4 * p * k + 6 * k))
    records.append(dict(
        name=names["softmax_fista_grad"], route="cuda",
        source="transmogrifai_tpu_torch/csrc/fista.cu",
        replaces="transmogrifai_tpu/ops/linear.py:148", max_abs_err=max(errs),
        ms=timer(lambda: L.softmax_fista_grad(*args)),
        plain_ms=plain_timer(lambda: L.softmax_fista_grad_plain(*args)),
        bound_ms=b, bound_by=by, library_ms=timer(library_grad)))
    check(float((library_grad() - L.softmax_fista_grad(*args)).abs().max())
          <= 1e-5 * scales[0], "the library yardstick computes another function")
    del fit, library_grad

    # K-Q multiclass_metrics: the sweep's [F, 26, n, k] probabilities
    scores = SW._all_scores(plan.spec, X, xbs, y, tw, blob)
    Cs = scores.shape[1]
    R = F * Cs
    probs = scores.reshape(R, n, k)
    got, want = M.multiclass_metrics(probs, y, vm, Cs), M.multiclass_metrics_plain(probs, y, vm, Cs)
    check(torch.equal(got, want), "multiclass_metrics differs from plain")
    check(np.array_equal(got.reshape(F, Cs, 4).cpu().numpy(), out),
          "multiclass_metrics differs from the sweep's own metrics")
    # the probabilities read once, y and the masks read once, four floats a
    # row written; about k + 6 operations an element
    b, by = bound_ms(R * n * k * 4 + n * 4 + F * n * 4 + R * 16, R * n * (k + 6))
    records.append(dict(
        name=names["multiclass_metrics"], route="cuda",
        source="transmogrifai_tpu_torch/csrc/multiclass_metrics.cu",
        replaces="transmogrifai_tpu/ops/metrics.py:162", max_abs_err=0.0,
        ms=timer(lambda: M.multiclass_metrics(probs, y, vm, Cs)),
        plain_ms=plain_timer(lambda: M.multiclass_metrics_plain(probs, y, vm, Cs)),
        bound_ms=b, bound_by=by, library_ms=None))
    del scores, probs

    # K-E / K-F over c = 3 class channels: the deepest level of the depth-12
    # group's first (fold, candidate) forest, 50 trees
    if tree_call is not None:
        plan = tree_call[0]
        X, y, xbs, blob = plan.X, plan.y, plan.xbs, np.asarray(plan.blob, np.float32)
        frags = {f[0]: f for f in plan.spec[1]}
    group = max(frags["forest"][2], key=lambda g: g[1])
    (gcis, depth, n_trees, xb_idx, B, frac, rate, bag, seed, frontier, exact, _,
     off_mcw, off_mig) = group
    Xb = xbs[xb_idx]
    kb, kf = Tr.rng_keys(seed)
    T = n_trees
    w_t = Tr.bootstrap_weights(kb, n, T, bag, rate, dev) * tw[0][None]
    fm = Tr.feature_masks(kf, d, T, frac, dev)
    g = -torch.nn.functional.one_hot(y.long(), k).float()
    ghw = torch.cat([w_t[..., None] * g[None], w_t[..., None]], -1).contiguous()
    params = torch.tensor([[1e-6, 0.0, float(blob[off_mcw]), float(blob[off_mig])]] * T,
                          device=dev)
    P_ = Tr._pool_size(depth, frontier)
    nodes = torch.empty((T, P_, 4), dtype=torch.int32, device=dev)
    e_args, f_args, _, _, nc, _ = grow_levels(torch, Tr, Xb, ghw, fm, params, depth, B,
                                              frontier, exact, nodes,
                                              torch.empty((T, P_, k), device=dev))
    torch.cuda.synchronize()
    check(hist_bits(Tr, ghw) == Tr.HIST_SCALE_BITS, "the forest's gradients left the fixed point")
    got, want = Tr.level_hist(*e_args), Tr.level_hist_plain(*e_args)
    check(torch.equal(got, want) and torch.equal(got, Tr.level_hist(*e_args)),
          "level_hist over class channels differs from plain")
    # the ordered path at the same shapes: the channels made real-valued
    # (each row's times a draw in [1, 2)), bit-equal to plain on two trees,
    # and K-F's prefix sums in XLA's order on the real histograms
    gen = torch.Generator(device=dev).manual_seed(15)
    real = (ghw * (1.0 + torch.rand(ghw.shape[:2] + (1,), generator=gen, device=dev)))
    r_args = (Xb, real.contiguous()) + tuple(e_args[2:])
    check(hist_bits(Tr, real) is None, "the real-valued channels took the fixed point")
    r_hist = hist_against_plain(torch, Tr, r_args, 2, f"{names['level_hist']}, ordered")
    r_f = (r_hist, f_args[1][:2], f_args[2][:2], f_args[3][:2], f_args[4][:2].clone(),
           f_args[5][:2].clone()) + tuple(f_args[6:])
    outs = []
    for fn in (Tr.split_scan, Tr.split_scan_plain):
        nd, lf = r_f[4].clone(), r_f[5].clone()
        outs.append((nd, lf) + tuple(fn(*r_f[:4], nd, lf, *r_f[6:])))
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          f"split_scan over real class channels ({names['split_scan']}) differs from plain")
    ordered = {"trees": T, "ms": timer(lambda: Tr.level_hist_launch(*r_args, scale_bits=None)),
               "plain_ms": plain_timer(lambda: Tr.level_hist_plain(*r_args)),
               "bit_equal_to_plain_on_trees": 2}
    m_deep, pairs, C1 = e_args[3], e_args[3] // 2, k + 1
    hist_bytes = T * m_deep * C1 * d * B * 4
    idx = (e_args[2].long() * B)[:, None, :] + Xb.long().T[None]
    dead = (e_args[2] < 0)[:, None, :].expand(T, d, n)
    seg_n = pairs * B + 1
    offs = (torch.arange(T * d, device=dev) * seg_n).view(T, d, 1)
    idx = (torch.where(dead, pairs * B, idx) + offs).reshape(-1)
    src = ghw[:, None].expand(T, d, n, C1).reshape(-1, C1).contiguous()
    zeros = torch.zeros((T * d * seg_n, C1), device=dev)
    # Xb once, the channels and the pair id per (tree, row), the parent
    # histograms, the pairs' parent and flag, the level's histograms written
    b, by = bound_ms(n * d + T * n * (4 * C1 + 4) + e_args[5].numel() * 4 + T * pairs * 8
                     + hist_bytes, T * n * d * C1)
    records.append(dict(
        name=names["level_hist"], route="cuda",
        source="transmogrifai_tpu_torch/csrc/level_hist.cu",
        replaces="transmogrifai_tpu/ops/trees.py:327", max_abs_err=0.0,
        ms=timer(lambda: Tr.level_hist_launch(*e_args, scale_bits=Tr.HIST_SCALE_BITS)),
        plain_ms=plain_timer(lambda: Tr.level_hist_plain(*e_args)),
        bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.index_add(zeros, 0, idx, src))))
    del idx, src, zeros
    outs = []
    for fn in (Tr.split_scan, Tr.split_scan_plain):
        nd, lf = f_args[4].clone(), f_args[5].clone()
        outs.append((nd, lf) + tuple(fn(*f_args[:4], nd, lf, *f_args[6:])))
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          "split_scan over class channels differs from plain")
    # the histograms read once, the slot records and split records written,
    # the child block's records, leaves (c floats) and pairs written; about
    # 10 + 4 c operations per candidate split
    b, by = bound_ms(hist_bytes + T * m_deep * 32 + T * nc * (16 + 4 * k + 8),
                     T * m_deep * d * B * (10 + 4 * k))
    records.append(dict(
        name=names["split_scan"], route="cuda",
        source="transmogrifai_tpu_torch/csrc/split_scan.cu",
        replaces="transmogrifai_tpu/ops/trees.py:449", max_abs_err=0.0,
        ms=timer(lambda: Tr.split_scan(*f_args)),
        plain_ms=plain_timer(lambda: Tr.split_scan_plain(*f_args[:4], f_args[4].clone(),
                                                         f_args[5].clone(), *f_args[6:])),
        bound_ms=b, bound_by=by, library_ms=None))
    del e_args, f_args, outs, ghw, w_t

    # K-M over c = 3: the depth-12 group's leaves (F x 6 forests of 50 trees)
    leaf, row_node = SW.grow_forest_group(group, xbs, y, tw, blob, out_c=k)
    Gg, Tg, P_, c = leaf.shape
    got, want = Tr.forest_leaf_mean(leaf, row_node), Tr.forest_leaf_mean_plain(leaf, row_node)
    check(torch.equal(got, want), "forest_leaf_mean over class channels differs from plain")
    rn_long = row_node.long()[..., None].expand(-1, -1, -1, c)
    # the rows' leaves read once, the pools read once, the means written
    b, by = bound_ms(Gg * Tg * n * 4 + Gg * Tg * P_ * c * 4 + Gg * n * c * 4, Gg * Tg * n * c)
    records.append(dict(
        name=names["forest_leaf_mean"], route="triton",
        source="transmogrifai_tpu_torch/ops/triton_forest.py",
        replaces="transmogrifai_tpu/ops/sweep.py:253", max_abs_err=0.0,
        ms=timer(lambda: Tr.forest_leaf_mean(leaf, row_node)),
        plain_ms=plain_timer(lambda: Tr.forest_leaf_mean_plain(leaf, row_node)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: leaf.gather(2, rn_long).mean(1))))
    log(phase, rows=n, shapes={"X1": [n, p], "fits": C, "classes": k,
                                        "score_rows": R, "probs": [F, Cs, n, k],
                                        "level_trees": T, "depth": depth,
                                        "hist": [T, m_deep, C1, d, B],
                                        "forest_group": [Gg, Tg, P_, c]},
        softmax_fista_grad_scale={"first_step": scales[0], "fitted": scales[1]},
        softmax_fista_grad_err={"first_step": errs[0], "fitted": errs[1]},
        softmax_fista_grad_err_to_float64={"first_step": to_f64[0], "fitted": to_f64[1]},
        level_hist_ordered=ordered, records=records)
    return records


def spaces():
    """The candidate spaces of the later slices' trains, by name: the Iris
    mixed space (the stock 26 with ``gbt_grid()`` and ``xgboost_grid()``:
    46) and the XGB-only one, the Titanic Newton + FISTA grid and its Newton
    points, the Boston ridge grid; the binary selector's other families with
    and without naive Bayes (spaces A and B) and the one-MLP Iris space."""
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.classification.trees import (
        OpGBTClassifier, OpRandomForestClassifier, OpXGBoostClassifier)
    from transmogrifai_tpu_torch.impl.regression.linear import OpLinearRegression
    from transmogrifai_tpu_torch.impl.selector import defaults as D

    from transmogrifai_tpu_torch.apps import iris, titanic

    regs = [0.0, 0.001, 0.01, 0.1, 0.2]
    return {
        "titanic_families_a": titanic.families_space(naive_bayes=True),
        "titanic_families_b": titanic.families_space(naive_bayes=False),
        "iris_mlp": iris.mlp_space(),
        "iris_mixed": [(OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
                       (OpRandomForestClassifier(), D.random_forest_grid()),
                       (OpGBTClassifier(), D.gbt_grid()),
                       (OpXGBoostClassifier(), D.xgboost_grid())],
        "iris_xgb": [(OpXGBoostClassifier(), D.xgboost_grid())],
        "titanic_mixed": [(OpLogisticRegression(max_iter=50),
                           D.grid(reg_param=regs, elastic_net_param=[0.0, 0.1]))],
        "titanic_newton": [(OpLogisticRegression(max_iter=50),
                            D.grid(reg_param=regs, elastic_net_param=[0.0]))],
        "boston_ridge": [(OpLinearRegression(), D.grid(reg_param=regs, elastic_net_param=[0.0]))],
    }


def timed_train(torch, train):
    """(train()'s result, wall seconds, the fused-sweep calls it made)."""
    with SweepCalls() as rec:
        t = time.perf_counter()
        out = train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return out, wall, rec.calls


def iris_boost_reference_phase(torch, iris, FX, dev="cuda"):
    """The 46-candidate and the XGB-only Iris trains on the 150-row frame,
    held to the committed ``iris_boost`` fixture; raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    sp = spaces()
    (model, wf), wall, calls = timed_train(
        torch, lambda: iris.train_iris(device=dev, models_and_parameters=sp["iris_mixed"]))
    mixed = FX.check_iris_boost_train(model, mixed=True)
    ref = FX.load_sweep(FX.IRIS_BOOST + "/sweep.npz")
    check(len(calls) == 1, f"{len(calls)} sweep calls, the fixture has one")
    mine = calls[0][3][None]
    check(np.array_equal(mine[..., 3], ref["mixed_metrics"][..., 3]),
          "fold Errors differ from the fixture's")
    f1pr_gap = float(np.abs(mine[..., :3] - ref["mixed_metrics"][..., :3]).max())
    spec = calls[0][0].spec
    gbt = [f for f in spec[1] if f[0] == "gbt"]
    check(gbt and all(f[1] == "softmax" and f[2] == 3 for f in gbt),
          f"no softmax gbt fragment over three classes: {spec}")
    (xgb, xwf), xwall, _ = timed_train(
        torch, lambda: iris.train_iris(device=dev, models_and_parameters=sp["iris_xgb"]))
    found = FX.check_iris_boost_train(xgb, mixed=False)
    params = xgb.stages[-1].model_params
    check(params["loss"] == "softmax" and np.asarray(params["leaf_val"]).shape[-1] == 3,
          "the XGB winner's refit is not a softmax model over three classes")
    req = FX.load_columns(FX.IRIS_BOOST + "/requests.npz")
    exp = FX.load_expected(FX.IRIS_BOOST + "/expected.npz")
    answers = {}
    with tempfile.TemporaryDirectory() as tmp:
        xgb.save(tmp)
        for who, path, tol in (("fixture_model", FX.IRIS_BOOST, FX.IRIS_PROB_ATOL),
                               ("port_saved_model", tmp, FX.IRIS_BOOST_PROB_ATOL)):
            m = P.load_model(path, device=dev)
            pred, prob, _ = FX.multiclass_predictions(
                P.BatchScoreFunction(m)(FX.records(req)), m.result_features[0].name, 3)
            err = float(np.abs(prob - exp["probability"]).max())
            check(np.array_equal(pred, exp["prediction"]) and err <= tol,
                  f"the {who}'s answers differ from the JAX package's (probability {err})")
            answers[who] = {"prediction_mismatches": 0, "probability_max_abs_err": err,
                            "tolerance": tol}
    summ = model.stages[-1].summary
    log("iris_boost_reference", rows=150, mixed_wall_s=wall, best=summ.best_model_name,
        best_grid=summ.best_grid, **mixed, fold_errors_bit_equal=True,
        f1_precision_recall_max_gap=f1pr_gap, gbt_fragments=[(f[1], f[2], len(f[3]))
                                                             for f in gbt],
        xgb_wall_s=xwall, xgb_best_grid=xgb.stages[-1].summary.best_grid,
        xgb_fold_errors=found["fold_errors"], xgb_holdout=found["holdout"],
        requests_vs_expected=answers, mixed_timings_s=wf.train_timings,
        xgb_timings_s=xwf.train_timings)


def titanic_newton_reference_phase(torch, titanic, FX, dev="cuda"):
    """The Titanic Newton-only and Newton + FISTA trains on the 891-row frame,
    held to the committed ``titanic_newton`` fixture; raises on a failed
    check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    sp = spaces()
    (model, wf), wall, calls = timed_train(
        torch, lambda: titanic.train_titanic(device=dev, models_and_parameters=sp["titanic_newton"]))
    found = FX.check_titanic_newton_train(model, mixed=False)
    check(all(c[0].spec[1][0][0] == "newton" for c in calls), "no newton fragment")
    params = model.stages[-1].model_params
    req = FX.load_columns(FX.TITANIC_NEWTON + "/requests.npz")
    exp = FX.load_expected(FX.TITANIC_NEWTON + "/expected.npz")
    fixture_model = P.load_model(FX.TITANIC_NEWTON, device=dev)
    name = fixture_model.result_features[0].name
    pred, prob, raw = FX.prediction_arrays(
        P.BatchScoreFunction(fixture_model)(FX.records(req)), name)
    fixture_gaps = FX.compare(exp, pred, prob, raw)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(loaded)(FX.records(req)),
                                             loaded.result_features[0].name)
    refit_err = float(np.abs(prob - exp["probability"]).max())
    check(refit_err <= FX.NEWTON_PROB_ATOL,
          f"the Newton refit's probabilities {refit_err} from the fixture's")
    (mixed, mwf), mwall, mcalls = timed_train(
        torch, lambda: titanic.train_titanic(device=dev, models_and_parameters=sp["titanic_mixed"]))
    mfound = FX.check_titanic_newton_train(mixed, mixed=True)
    check([f[0] for f in mcalls[0][0].spec[1]] == ["newton", "fista"],
          f"mixed grid fragments {mcalls[0][0].spec[1]}")
    log("titanic_newton_reference", rows=891, wall_s=wall, best_grid=found["best_grid"],
        newton_fold_aupr_max_gap=found["max_gap"], tolerance=FX.NEWTON_AUPR_TOL,
        reg0_folds=found["reg0_folds"], refit_coef=np.asarray(params["coef"]).tolist(),
        refit_probability_max_abs_err=refit_err, fixture_model_vs_expected=fixture_gaps,
        mixed_wall_s=mwall, mixed_best_grid=mfound["best_grid"],
        mixed_fold_aupr_max_gap=mfound["max_gap"], mixed_reg0_folds=mfound["reg0_folds"],
        timings_s=wf.train_timings, mixed_timings_s=mwf.train_timings)


def boston_ridge_reference_phase(torch, boston, FX, dev="cuda"):
    """The Boston ridge-grid train on the 506-row frame, held to the
    committed ``boston_ridge`` fixture; raises on a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    (model, wf), wall, calls = timed_train(
        torch, lambda: boston.train_boston(device=dev, models_and_parameters=spaces()["boston_ridge"]))
    found = FX.check_boston_ridge_train(model)
    req = FX.load_columns(FX.BOSTON_RIDGE + "/requests.npz")
    exp = FX.load_expected(FX.BOSTON_RIDGE + "/expected.npz")["prediction"]
    fixture_model = P.load_model(FX.BOSTON_RIDGE, device=dev)
    name = fixture_model.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(fixture_model)(FX.records(req)), name)
    fixture_err = float(np.max(np.abs(pred - exp) / np.maximum(np.abs(exp), 1.0)))
    check(np.allclose(pred, exp, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL),
          f"the fixture model's predictions {fixture_err} from the JAX package's")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        mine = FX.regression_predictions(P.BatchScoreFunction(loaded)(FX.records(req)),
                                         loaded.result_features[0].name)
    refit = FX.compare_ridge_predictions(mine, req, exp)
    log("boston_ridge_reference", rows=506, wall_s=wall,
        best_grid=model.stages[-1].summary.best_grid, **found,
        tolerances={"fold_rmse": FX.RIDGE_RMSE_RTOL, "prediction": FX.RIDGE_PRED_RTOL},
        sweep_fragments=[f[0] for f in calls[0][0].spec[1]],
        refit_coef=np.asarray(model.stages[-1].model_params["coef"]).tolist(),
        refit_intercept=np.asarray(model.stages[-1].model_params["intercept"]).tolist(),
        fixture_model_prediction_max_rel_err=fixture_err, refit_vs_expected=refit,
        timings_s=wf.train_timings)


class CountCalls:
    """Counts the calls of the named functions of ``module`` while on (each
    wrapped, restored on exit)."""

    def __init__(self, module, names):
        self.module, self.names, self.counts, self.saved = module, names, {}, {}

    def __enter__(self):
        for name in self.names:
            fn = self.saved[name] = getattr(self.module, name)
            self.counts[name] = 0

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.counts[_name] += 1
                return _fn(*a, **k)

            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def scale_train_phase(torch, phase, train, kernels, required, check_fn, count_draws=False,
                      sweep=True):
    """A main path of a later slice at scale: every kernel's launch count reset
    just before and read just after the train (the ``required`` ones must
    be above 0), ``check_fn(model)`` on its result, the host-clock
    breakdown, then a profiled second run.  With ``sweep`` False the train
    must take the per-family sweep (no fused call).  Returns (the launches,
    the sweep calls, the K8 draws' call counts or None)."""
    from transmogrifai_tpu_torch.ops import trees as Tr

    zero_launches(kernels)
    draws = CountCalls(Tr, ("rng_keys", "bootstrap_weights", "feature_masks",
                            "subsample_weights")) if count_draws else None
    if draws:
        draws.__enter__()
    try:
        (model, wf), wall, calls = timed_train(torch, train)
    finally:
        if draws:
            draws.__exit__()
    launches = {fn.__name__: fn.launches for fn in kernels}
    for fn in kernels:  # K-W's launches by mode
        launches.update({f"{fn.__name__}_{m}": v
                         for m, v in getattr(fn, "launches_by_mode", {}).items()})
    missing = [k for k in required if launches[k] <= 0]
    check(not missing, f"kernels not launched on the {phase} path: {missing}")
    found = check_fn(model)
    timings = dict(wf.train_timings)
    prof_wall, busy_s, idle, by_kernel = profiled(torch, train)
    check(bool(calls) == sweep, f"{len(calls)} fused sweep calls on the {phase} path")
    plan = calls[0][0] if calls else None
    summ = model.stages[-1].summary
    # the boosting fragments' grower levels: each group grows its trees
    # together, max_depth levels a round
    gbt_levels = {f"{f[1]}:{g[1]}x{g[2]}": g[1] * g[2] for c in calls for f in c[0].spec[1]
                  if f[0] == "gbt" for g in f[3]}
    log(phase, wall_s=wall, launches=launches, host_clock_s=timings,
        best=summ.best_model_name, best_grid=summ.best_grid, **found,
        sweep_calls=len(calls), gbt_levels_by_group=gbt_levels,
        sweep_spec=repr(plan.spec) if plan else None,
        sweep_rows=int(plan.X.shape[0]) if plan else None,
        sweep_features=int(plan.X.shape[1]) if plan else None,
        draw_calls=draws.counts if draws else None,
        profiled_train_s=prof_wall, device_busy_s=busy_s, device_idle_share=idle,
        device_s_by_kernel=by_kernel)
    return launches, calls, draws.counts if draws else None


def iris_boost_check(model):
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 46, "the mixed Iris space has 46 candidates")
    check(all(np.isfinite(folds)) and 0.0 <= min(folds) and max(folds) <= 1.0,
          f"bad fold Errors {folds}")
    check(summ.holdout_evaluation["Error"] < 0.1, "bad holdout Error")
    gbt = [np.mean(r["foldMetrics"]) for r in summ.validation_results
           if r["modelName"] in ("OpGBTClassifier", "OpXGBoostClassifier")]
    return {"boosted_mean_errors": gbt,
            "holdout": {k: v for k, v in summ.holdout_evaluation.items()
                        if k != "ThresholdMetrics"}}


def titanic_newton_check(model):
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 10, "the Newton + FISTA grid has 10 candidates")
    check(all(np.isfinite(folds)), f"non-finite fold AuPR {folds}")
    check(summ.holdout_evaluation["AuPR"] > 0.5, "bad holdout AuPR")
    return {"fold_aupr": {str(r["grid"]): r["foldMetrics"] for r in summ.validation_results},
            "holdout_aupr": summ.holdout_evaluation["AuPR"]}


def boston_ridge_check(model):
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == 5, "the ridge grid has 5 candidates")
    check(all(np.isfinite(folds)) and min(folds) > 0, f"bad fold RMSE {folds}")
    check(summ.holdout_evaluation["R2"] > 0.5, "bad holdout R2")
    return {"fold_rmse": {str(r["grid"]["reg_param"]): r["foldMetrics"]
                          for r in summ.validation_results},
            "holdout": {k: v for k, v in summ.holdout_evaluation.items()
                        if k != "SignedPercentageErrorHistogram"}}


#: K-R's gradients and hessian against its plain version on the card: the
#: same libdevice expf in both, float32 operations in one order; 2 ulp of 1
BOOST_GRAD_ATOL = 2.4e-7
#: K-S's Gram and moments against its plain version (cuBLAS margins there,
#: an FMA dot in the kernel, both sums in float64), relative to the largest
#: entry
GRAM_RTOL = 1e-5
#: K-M's tree counts held against the reference order on the card
MEAN_TREES = (19, 20, 24, 32, 33, 300)


def slice6_kernel_phase(torch, iris_calls, newton_call, ridge_call, timer, dev="cuda"):
    """K-R on the second round of the Iris scale train's XGB group (in
    whichever of its sweep calls holds it: the 46 candidates' scores run as
    several calls at 2^18 rows), K-S in
    Newton mode at a mid-run point of the Titanic scale train's Newton
    fits and in ridge mode on the Boston scale train's folds, K-M at the
    tree counts of ``MEAN_TREES``, each against its plain version on the
    card."""
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import trees as Tr

    records, extra = [], {}

    # K-R softmax_boost_step: the XGB group (200 rounds, depth 10), round 2
    plan, train_w, frag = next((c[0], c[1], f) for c in iris_calls for f in c[0].spec[1]
                               if f[0] == "gbt" and f[3][0][1] == 200)
    y, blob = plan.y, np.asarray(plan.blob, np.float32)
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev)
    (cis, rounds, depth, xb_idx, n_bins, subsample, colsample, seed, frontier, exact, _, _,
     off_eta, off_lam, off_gam, off_mcw, off_mig) = frag[3][0]
    k = frag[2]
    Xb = plan.xbs[xb_idx]
    n, d = Xb.shape
    F, Gc = tw.shape[0], len(cis)
    B = F * Gc
    w_b = tw.repeat_interleave(Gc, dim=0).contiguous()
    hp = lambda off: torch.as_tensor(np.tile(blob[off:off + Gc], F), device=dev)  # noqa: E731
    eta = hp(off_eta)
    params = torch.stack([torch.clamp_min(hp(off_lam), 1e-6), hp(off_gam), hp(off_mcw),
                          hp(off_mig)], 1)
    ks, kf = Tr.rng_keys(seed)
    rw = Tr.subsample_weights(ks, n, rounds, subsample, dev)
    fms = Tr.feature_masks(kf, d, rounds, colsample, dev)
    Fm = torch.zeros((B, n, k), device=dev)
    ghw = torch.empty((B, n, k + 1), device=dev)
    Tr.softmax_boost_step(Fm, y, w_b * rw[0][None], eta, ghw=ghw)
    _, leaf, row_node = Tr.grow_trees(Xb, ghw, fms[0][None].expand(B, -1).contiguous(), params,
                                      depth, n_bins, frontier, exact)
    w1 = (w_b * rw[1][None]).contiguous()
    F1, F2 = Fm.clone(), Fm.clone()
    g1, g2 = torch.empty_like(ghw), torch.empty_like(ghw)
    Tr.softmax_boost_step(F1, y, w1, eta, leaf, row_node, g1)
    Tr.softmax_boost_step_plain(F2, y, w1, eta, leaf, row_node, g2)
    torch.cuda.synchronize()
    check(torch.equal(F1, F2), "softmax_boost_step margins differ from plain")
    err = float((g1 - g2).abs().max())
    check(err <= BOOST_GRAD_ATOL, f"softmax_boost_step gradients {err} from plain, above "
                                  f"{BOOST_GRAD_ATOL}")
    P_ = leaf.shape[1]
    # per (element, row): F read and written (k floats each way), w and the
    # node read, k + 1 gradients written; y once, the leaf pools once; about
    # 30 k operations (exp, the softmax, the gradients, the hessian)
    b, by = bound_ms(B * n * (8 * k + 8 + 4 * (k + 1)) + n * 4 + B * P_ * k * 4,
                     B * n * 30 * k)
    records.append(dict(
        name="softmax_boost_step", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_boost.py",
        replaces="transmogrifai_tpu/ops/trees.py:1123", max_abs_err=err,
        ms=timer(lambda: Tr.softmax_boost_step(F1, y, w1, eta, leaf, row_node, g1)),
        plain_ms=timer(lambda: Tr.softmax_boost_step_plain(F2, y, w1, eta, leaf, row_node,
                                                           g2)),
        bound_ms=b, bound_by=by, library_ms=None))
    extra["softmax_boost_step"] = {"shape": [B, n, k], "pool": P_, "tolerance": BOOST_GRAD_ATOL}
    del Fm, F1, F2, g1, g2, ghw, leaf, row_node, w1

    # K-S weighted_gram, Newton mode: the Titanic sweep's Newton fits after
    # half their steps
    for mode, call in (("newton", newton_call), ("ridge", ridge_call)):
        plan, train_w, _, _ = call
        X, y, blob = plan.X, plan.y, np.asarray(plan.blob, np.float32)
        tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
        F = tw.shape[0]
        n, dd = X.shape
        X1 = torch.cat([X, torch.ones((n, 1), device=dev)], 1).contiguous()
        p = dd + 1
        if mode == "newton":
            _, ncis, max_iter, fit_icpt, off_l2 = plan.spec[1][0]
            G = len(ncis)
            fit = L.fit_logistic_grid_folds_newton(X, y, tw, blob[off_l2:off_l2 + G],
                                                   max_iter=max_iter // 2,
                                                   fit_intercept=fit_icpt)
            beta = torch.cat([fit.coef, fit.intercept], 2).reshape(F * G, p).contiguous()
            fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
        else:
            beta, fold = None, torch.arange(F, dtype=torch.int32, device=dev)
        args = (X1, y, tw, fold, beta)
        (H1, g1), (H2, g2) = L.weighted_gram(*args), L.weighted_gram_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(H1, L.weighted_gram(*args)[0]), "weighted_gram does not repeat")
        errs = {"H": float((H1 - H2).abs().max() / H2.abs().max()),
                "g": float((g1 - g2).abs().max() / g2.abs().max())}
        check(max(errs.values()) <= GRAM_RTOL,
              f"weighted_gram ({mode}) {errs} from plain, above {GRAM_RTOL}")
        C = fold.shape[0]
        v, _ = L._gram_weights(X1, y, tw, fold, beta)
        E = p * (p + 1) // 2 + p
        # X1, each fold's weights and y read once, the coefficients read,
        # the Gram and moments written; per (fit, row) two operations an
        # upper-triangle or moment entry and, in Newton mode, the margin
        b, by = bound_ms((n * p + F * n + n) * 4 + (0 if beta is None else C * p * 4)
                         + C * (p * p + p) * 4,
                         C * n * (2 * E + (2 * p + 20 if beta is not None else 2)))
        records.append(dict(
            name=f"weighted_gram_{mode}", route="cuda",
            source="transmogrifai_tpu_torch/csrc/weighted_gram.cu",
            replaces="transmogrifai_tpu/ops/linear.py:" + ("53" if mode == "newton" else "193"),
            max_abs_err=max(float((H1 - H2).abs().max()), float((g1 - g2).abs().max())),
            ms=timer(lambda: L.weighted_gram(*args)),
            plain_ms=timer(lambda: L.weighted_gram_plain(*args)),
            bound_ms=b, bound_by=by,
            library_ms=timer(lambda: torch.einsum("cn,np,nq->cpq", v, X1, X1))))
        extra[f"weighted_gram_{mode}"] = {"X1": [n, p], "fits": C, "rel_err": errs,
                                          "tolerance": GRAM_RTOL}
        del v

    # K-M forest_leaf_mean at the tree counts where the reference's order
    # changes (32, 1,024) and around them, c = 1 and 3
    G, n, P_ = 6, 1 << 16, 63
    rng = torch.Generator(device=dev).manual_seed(6)
    equal = {}
    for T in MEAN_TREES:
        for c in (1, 3):
            leaf = torch.rand((G, T, P_, c), device=dev, generator=rng)
            node = torch.randint(0, P_, (G, T, n), device=dev, generator=rng, dtype=torch.int32)
            got = Tr.forest_leaf_mean(leaf, node)
            equal[f"{T}x{c}"] = bool(torch.equal(got, Tr.forest_leaf_mean_plain(leaf, node)))
    check(all(equal.values()), f"forest_leaf_mean differs from plain: {equal}")
    leaf = torch.rand((G, 300, P_), device=dev, generator=rng)
    node = torch.randint(0, P_, (G, 300, n), device=dev, generator=rng, dtype=torch.int32)
    rn_long = node.long()
    b, by = bound_ms(G * 300 * n * 4 + G * 300 * P_ * 4 + G * n * 4, G * 300 * n)
    records.append(dict(
        name="forest_leaf_mean_t300", route="triton",
        source="transmogrifai_tpu_torch/ops/triton_forest.py",
        replaces="transmogrifai_tpu/ops/sweep.py:253", max_abs_err=0.0,
        ms=timer(lambda: Tr.forest_leaf_mean(leaf, node)),
        plain_ms=timer(lambda: Tr.forest_leaf_mean_plain(leaf, node)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: leaf.gather(2, rn_long).mean(1))))
    extra["forest_leaf_mean_orders_bit_equal"] = equal
    del leaf, node, rn_long

    log("slice6_kernels", details=extra, records=records)
    return records


def families_reference_phase(torch, titanic, iris, FX, dev="cuda"):
    """The binary selector's other families on the 891-row Titanic frame
    (space A: LinearSVC, NaiveBayes, DecisionTree, MLP through the per-family
    sweep; space B: the same without NaiveBayes through the fused sweep) and
    the one-MLP Iris space on the 150-row frame, held to the committed
    ``titanic_families`` fixture; the JAX-saved and the port-saved winners
    (naive Bayes, the MLP) scored through ``BatchScoreFunction``; raises on
    a failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    sp = spaces()
    req = FX.load_columns(FX.TITANIC_FAMILIES + "/requests.npz")
    exp = FX.load_expected(FX.TITANIC_FAMILIES + "/expected.npz")
    out = {}
    for space in ("a", "b"):
        (model, wf), wall, calls = timed_train(
            torch, lambda: titanic.train_titanic(
                device=dev, models_and_parameters=sp["titanic_families_" + space]))
        found = FX.check_titanic_families_train(model, space)
        if space == "a":
            check(not calls, "space A (naive Bayes) took the fused sweep")
        else:
            check(all([f[0] for f in c[0].spec[1]] == ["svc", "forest", "mlp"] for c in calls),
                  f"space B's fragments {[f[0] for f in calls[0][0].spec[1]]}")
        answers = {}
        with tempfile.TemporaryDirectory() as tmp:
            model.save(tmp)
            for who, path, tol in (
                    ("jax_saved_winner", FX.TITANIC_FAMILIES + "/space_" + space,
                     FX.JAX_SAVED_PROB_ATOL),
                    ("port_saved_winner", tmp, FX.FAMILIES_PROB_ATOL[space])):
                m = P.load_model(path, device=dev)
                pred, prob, _ = FX.prediction_arrays(
                    P.BatchScoreFunction(m)(FX.records(req)), m.result_features[0].name)
                answers[who] = FX.compare_family_answers(exp, space, pred, prob, tol=tol)
                answers[who]["tolerance"] = tol
        out[space] = dict(wall_s=wall, **found, requests_vs_expected=answers,
                          timings_s=wf.train_timings)
    (model, wf), wall, calls = timed_train(
        torch, lambda: iris.train_iris(device=dev, models_and_parameters=sp["iris_mlp"]))
    ref = FX.load_sweep(FX.TITANIC_FAMILIES + "/sweep.npz")["iris_mlp_metrics"]
    mine = np.stack([c[3] for c in calls])
    check(mine.shape == ref.shape and calls[0][0].spec[1][0][0] == "mlp",
          f"the Iris MLP sweep {mine.shape}, {calls[0][0].spec}")
    check(np.array_equal(mine[..., 3], ref[..., 3]), "the Iris MLP's fold Errors differ")
    out["iris_mlp"] = dict(wall_s=wall, fold_errors=mine[..., 3].tolist(),
                           f1_precision_recall_max_gap=float(np.abs(mine[..., :3]
                                                                    - ref[..., :3]).max()),
                           best=model.stages[-1].summary.best_model_name)
    log("families_reference", rows=891, **out)


def families_check(model, space):
    summ = model.stages[-1].summary
    folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
    check(len(summ.validation_results) == (24 if space == "a" else 23),
          f"space {space.upper()} candidates {len(summ.validation_results)}")
    check(all(np.isfinite(folds)) and all(r.get("error") is None
                                          for r in summ.validation_results),
          f"failed candidates or non-finite fold AuPR in space {space.upper()}")
    check(summ.holdout_evaluation["AuPR"] > 0.5, "bad holdout AuPR")
    by_family = {}
    for r in summ.validation_results:
        by_family.setdefault(r["modelName"], []).append(float(np.mean(r["foldMetrics"])))
    return {"best_mean_aupr_by_family": {k: max(v) for k, v in by_family.items()},
            "holdout_aupr": summ.holdout_evaluation["AuPR"]}


#: K-T's gradients against its plain version (cuBLAS-free: both sum in
#: float64, the hinge's float32 margins in other orders), relative to the
#: largest entry
SVC_GRAD_RTOL = 1e-5
#: K-U's gradients against its plain version (float64 weight sums in both;
#: the forward pass's float32 dot products in other orders), relative to
#: the largest entry; its forward mode's probabilities, absolute
MLP_GRAD_RTOL = 1e-4
MLP_PROB_ATOL = 1e-6
#: K-V against its plain version: float64 sums of exact products in two
#: orders, each rounded to float32 once (an ulp at most)
NB_RTOL = 2.4e-7


def families_kernel_phase(torch, b_calls, timer, dev="cuda"):
    """K-T, K-U (both modes) and K-V (both modes) against their plain
    versions on the ``--train-rows`` families train's own arguments: the
    space-B sweep call's feature matrix, labels and fold, its SVC fits
    after half their steps and its MLP fits' initial parameters after ten
    Adam steps; the naive-Bayes fit of space A sees the same feature matrix,
    labels and fold (the workflow's features are deterministic).  Each is
    timed by CUDA events beside its bound, its plain version and one
    PyTorch call computing the same function."""
    from transmogrifai_tpu_torch.ops import linear as L

    plan, train_w, _, _ = b_calls[0]
    X, y, blob = plan.X, plan.y, np.asarray(plan.blob, np.float32)
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
    F = tw.shape[0]
    n, d = X.shape
    records, extra = [], {}

    # K-T svc_grad: the SVC fits after half their steps
    _, cis, max_iter, fit_icpt, off_l2 = next(f for f in plan.spec[1] if f[0] == "svc")
    G = len(cis)
    l2 = blob[off_l2:off_l2 + G]
    fit = L.fit_svc_grid_folds(X, y, tw, l2, max_iter=max_iter // 2, fit_intercept=fit_icpt)
    C, p = F * G, d + 1
    z = torch.cat([fit.coef, fit.intercept], -1).reshape(C, p).contiguous()
    X1 = torch.cat([X, torch.ones((n, 1), device=dev)], 1).contiguous()
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    l2v = torch.as_tensor(np.tile(l2, F), device=dev)[:, None].repeat(1, p).contiguous()
    l2v[:, -1] = 0.0
    wsum = torch.clamp_min(tw.sum(1), 1e-12)[fold.long()].contiguous()
    args = (X1, y, tw, fold, z, l2v, wsum)
    g1, g2 = L.svc_grad(*args), L.svc_grad_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(g1, L.svc_grad(*args)), "svc_grad does not repeat")
    err = float((g1 - g2).abs().max() / g2.abs().max())
    check(err <= SVC_GRAD_RTOL, f"svc_grad {err} from plain, above {SVC_GRAD_RTOL}")
    wf = tw[fold.long()]
    ypm = 2.0 * y - 1.0

    def svc_library():
        r = wf * ((-2.0 * ypm) * torch.clamp_min(1.0 - ypm * (z @ X1.T), 0.0))
        return (r @ X1) / wsum[:, None] + l2v * z

    # X1, y and each fold's weights read once, the points and penalties read,
    # the gradients written; per (fit, row) a p-term margin and a p-term
    # update (2 operations each) and about 6 for the hinge
    b, by = bound_ms((n * p + n + F * n) * 4 + 3 * C * p * 4, C * n * (4 * p + 6))
    records.append(dict(
        name="svc_grad", route="cuda", source="transmogrifai_tpu_torch/csrc/svc.cu",
        replaces="transmogrifai_tpu/ops/linear.py:254", max_abs_err=float((g1 - g2).abs().max()),
        ms=timer(lambda: L.svc_grad(*args)), plain_ms=timer(lambda: L.svc_grad_plain(*args)),
        bound_ms=b, bound_by=by, library_ms=timer(svc_library)))
    extra["svc_grad"] = {"X1": [n, p], "fits": C, "rel_err": err, "tolerance": SVC_GRAD_RTOL}

    # K-U mlp_grad and mlp_forward: the MLP fits after ten Adam steps
    _, mcis, layers, _, off_lr, off_seed = next(f for f in plan.spec[1] if f[0] == "mlp")
    Gm = len(mcis)
    call = ((X, y, tw, blob[off_lr:off_lr + Gm], blob[off_seed:off_seed + Gm].astype(np.int32)),
            {"layers": layers})
    recs, extra["mlp"] = mlp_record(torch, "mlp_grad", call, timer, timer, dev)
    records += recs
    # K-V nb_tables: the masses of the folds, then the scores of their tables
    recs, extra["nb_tables"] = nb_records(torch, "", ((X, y, tw, [1.0], False, 2), {}), timer,
                                          timer)
    records += recs
    log("families_kernels", details=extra, records=records)
    return records


class AllCalls:
    """Keeps the arguments of every call of ``module.name`` while on
    (wrapped, restored on exit): ``calls``, a list of (args, kwargs)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        fn = self.saved = getattr(self.module, self.name)

        def wrapped(*a, **k):
            self.calls.append((a, k))
            return fn(*a, **k)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


#: the threefry hash's 32-bit integer operations a draw: 20 rounds of an add,
#: a rotate and a xor (60), five key injections of two adds (10), the two
#: initial adds, the high count word's shift, the xor of the two words and the
#: uniform's shift and or
HASH_INT_OPS = 76


def kw_kernel_phase(torch, boost_calls, timer, dev="cuda"):
    """K-W (``threefry_draws``) in each mode against its plain version on the
    card, bit for bit, at the Iris 46-candidate scale train's shapes (the
    forests' Poisson bootstrap of 50 trees over the sweep's rows, a forest's
    feature masks, the boosting groups' subsample masks of 200 rounds below
    a rate and at rate 1) and at a rate-0.632 bootstrap, a ties-heavy mask
    draw and a Glorot-sized uniform; timed as in phase 2, with its bound by
    bytes and by operations (the hash's integer operations over the SMs'
    dispatch rate, the larger one taken)."""
    from transmogrifai_tpu_torch.ops import threefry as R
    from transmogrifai_tpu_torch.ops import trees as Tr

    n = int(boost_calls[0][0].X.shape[0])
    kb, kf = Tr.rng_keys(42)
    records, extra = [], {}

    def held(name, fn, plain):
        before = R.threefry_draws.launches
        got = fn()
        torch.cuda.synchronize()
        check(R.threefry_draws.launches == before + 1, f"{name} did not launch K-W")
        want = plain()
        check(torch.equal(got, want), f"{name} differs from its plain version")
        return got

    def both_bounds(n_bytes, n_ops):
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_INT32_OPS_PER_S * 1e3
        return {"bytes_ms": t_bytes, "operations_ms": t_ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    # Poisson bootstraps: 50 trees at rate 1 (the forests' draw) and 0.632;
    # the hashes this data needs are one a live step of a lane, count + 1
    for rate in (1.0, 0.632):
        name = f"bootstrap rate {rate}"
        boot = held(name, lambda: Tr.bootstrap_weights(kb, n, 50, True, rate, dev),
                    lambda: Tr.bootstrap_weights_plain(kb, n, 50, True, rate, dev))
        steps = float(boot.double().sum()) + boot.numel()
        b = both_bounds(boot.numel() * 4, steps * (HASH_INT_OPS + 2))
        ms = timer(lambda: Tr.bootstrap_weights(kb, n, 50, True, rate, dev))
        plain_ms = timer(lambda: Tr.bootstrap_weights_plain(kb, n, 50, True, rate, dev))
        extra[name] = {"shape": [50, n], "hashes": steps, "max_count": float(boot.max()),
                       "ms": ms, "plain_ms": plain_ms, **b}
        if rate == 1.0:
            records.append(dict(
                name="threefry_draws_poisson", route="cuda",
                source="transmogrifai_tpu_torch/csrc/threefry.cu",
                replaces="transmogrifai_tpu/ops/trees.py:1390", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=None))
    # feature masks: a forest's (8 features, k = 3 of them) and a ties-heavy
    # draw (2,048 features: ~0.25 tied pairs a tree), d uniforms a tree each
    # hashed and compared with the tree's others
    for name, T, d, frac in (("masks", 50, 8, np.sqrt(8) / 8),
                             ("masks ties-heavy", 4096, 2048, 0.5)):
        masks = held(name, lambda: Tr.feature_masks(kf, d, T, frac, dev),
                     lambda: Tr.feature_masks_plain(kf, d, T, frac, dev))
        k = max(1, int(round(frac * d)))
        r = Tr.R.uniform_plain(kf, (T, d), dev)
        tied = int((torch.sort(r, 1).values.diff(dim=1) == 0).any(1).sum())
        b = both_bounds(T * d * 4, T * d * (HASH_INT_OPS + 2 * d))
        ms = timer(lambda: Tr.feature_masks(kf, d, T, frac, dev))
        plain_ms = timer(lambda: Tr.feature_masks_plain(kf, d, T, frac, dev))
        extra[name] = {"shape": [T, d], "k": k, "trees_with_ties": tied,
                       "trees_above_k": int((masks.sum(1) > k).sum()), "ms": ms,
                       "plain_ms": plain_ms, **b}
        if name == "masks":
            records.append(dict(
                name="threefry_draws_masks", route="cuda",
                source="transmogrifai_tpu_torch/csrc/threefry.cu",
                replaces="transmogrifai_tpu/ops/trees.py:1400", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=None))
        del r
    # uniform mode: the subsample masks of 200 rounds below 0.8 (rate 1 is
    # ones, no launch) and the Glorot init's uniforms
    held("subsample 0.8", lambda: Tr.subsample_weights(kb, n, 200, 0.8, dev),
         lambda: Tr.subsample_weights_plain(kb, n, 200, 0.8, dev))
    b = both_bounds(200 * n * 4, 200 * n * (HASH_INT_OPS + 1))
    ms = timer(lambda: Tr.subsample_weights(kb, n, 200, 0.8, dev))
    plain_ms = timer(lambda: Tr.subsample_weights_plain(kb, n, 200, 0.8, dev))
    extra["subsample 0.8"] = {"shape": [200, n], "ms": ms, "plain_ms": plain_ms, **b}
    records.append(dict(
        name="threefry_draws_uniform", route="cuda",
        source="transmogrifai_tpu_torch/csrc/threefry.cu",
        replaces="transmogrifai_tpu/ops/trees.py:1411", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=None))
    before = R.threefry_draws.launches
    ones = Tr.subsample_weights(kb, n, 200, 1.0, dev)
    check(R.threefry_draws.launches == before and bool((ones == 1).all()),
          "subsample masks at rate 1 are not ones without a launch")
    extra["subsample 1.0"] = {"ms": timer(lambda: Tr.subsample_weights(kb, n, 200, 1.0, dev))}
    for shape in ((10, 10), (128, 64)):
        held(f"uniform {shape}", lambda: R.uniform(kf, shape, dev),
             lambda: R.uniform_plain(kf, shape, dev))
        held(f"bits {shape}", lambda: R.random_bits(kf, shape, dev),
             lambda: R.random_bits_plain(kf, shape, dev))
        extra[f"uniform {shape}"] = {"ms": timer(lambda: R.uniform(kf, shape, dev)),
                                     "plain_ms": timer(lambda: R.uniform_plain(kf, shape, dev))}
    log("kw_kernels", details=extra, records=records,
        int32_ops_per_s=PEAK_INT32_OPS_PER_S, hash_int_ops=HASH_INT_OPS)
    return records


#: K-S in GLM mode against its plain version (cuBLAS margins there, an FMA
#: dot in the kernel, the same libdevice exp and pow, both sums in float64),
#: relative to the largest entry
GLM_GRAM_RTOL = 1e-5
GLM_PAIRS = (("gaussian", "identity"), ("gaussian", "log"), ("binomial", "logit"),
             ("poisson", "log"), ("poisson", "sqrt"), ("gamma", "inverse"), ("gamma", "log"),
             ("tweedie", "log"))


def glm_kernel_phase(torch, glm_call, timer, dev="cuda"):
    """K-S in GLM mode against its plain version on the card for each
    (family, link) pair of the ops-level tests, at the Boston GLM scale
    train's sweep inputs (X1 [n, 17], three folds x three regs): each pair's
    fits one IRLS step from their start (for binomial, the label above its
    median); timed as in phase 2 beside its bound and one ``einsum`` over
    the given weights.  The record is the tweedie / log pair's (the power
    on top of the exp)."""
    from transmogrifai_tpu_torch.ops import linear as L

    X, y, train_w = glm_call.calls[0][0][:3]
    tw = train_w.to(dev, torch.float32).contiguous()
    F, G = tw.shape[0], 3
    n = X.shape[0]
    X1 = torch.cat([X, torch.ones((n, 1), device=dev)], 1).contiguous()
    p = X1.shape[1]
    C = F * G
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    regs = [0.001, 0.01, 0.1]
    extra, records = {}, []
    for family, link in GLM_PAIRS:
        yd = (y > y.median()).float() if family == "binomial" else y
        yd = yd.contiguous()
        vps = [1.5] * G if family == "tweedie" else [0.0] * G
        fit = L.fit_glm_grid_folds(X, yd, tw, regs, vps, family, link, max_iter=1)
        beta = torch.cat([fit.coef, fit.intercept], 2).reshape(C, p).contiguous()
        check(bool(torch.isfinite(beta).all()), f"{family}/{link}: non-finite IRLS step")
        glm = (family, link, torch.tensor(vps * F, dtype=torch.float32, device=dev))
        args = (X1, yd, tw, fold, beta, glm)
        (H1, g1), (H2, g2) = L.weighted_gram(*args), L.weighted_gram_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(H1, L.weighted_gram(*args)[0]), "weighted_gram does not repeat")
        errs = {"H": float((H1 - H2).abs().max() / H2.abs().max()),
                "g": float((g1 - g2).abs().max() / g2.abs().max())}
        check(max(errs.values()) <= GLM_GRAM_RTOL,
              f"weighted_gram (GLM {family}/{link}) {errs} from plain, above {GLM_GRAM_RTOL}")
        E = p * (p + 1) // 2 + p
        # X1, each fold's weights and y read once, the coefficients and the
        # variance powers read, the Gram and moments written; per (fit, row)
        # the margin (2 p), the link, the variance and the weights (~30) and
        # two operations an upper-triangle or moment entry
        b, by = bound_ms((n * p + F * n + n) * 4 + C * (p + 1) * 4 + C * (p * p + p) * 4,
                         C * n * (2 * E + 2 * p + 30))
        v, _ = L._gram_weights(X1, yd, tw, fold, beta, glm)
        row = {"ms": timer(lambda: L.weighted_gram(*args)),
               "plain_ms": timer(lambda: L.weighted_gram_plain(*args)),
               "library_ms": timer(lambda: torch.einsum("cn,np,nq->cpq", v, X1, X1)),
               "bound_ms": b, "bound_by": by, "rel_err": errs,
               "max_abs_err": max(float((H1 - H2).abs().max()), float((g1 - g2).abs().max()))}
        extra[f"{family}/{link}"] = row
        del v
    row = extra["tweedie/log"]
    records.append(dict(
        name="weighted_gram_glm", route="cuda",
        source="transmogrifai_tpu_torch/csrc/weighted_gram.cu",
        replaces="transmogrifai_tpu/ops/linear.py:326", max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log("glm_kernels", X1=[n, p], fits=C, tolerance=GLM_GRAM_RTOL, details=extra,
        records=records)
    return records


def boston_glm_reference_phase(torch, boston, FX, dev="cuda"):
    """The Boston GLM train (``boston.glm_space()``, 12 candidates, the
    per-family sweep) on the 506-row frame, held to the committed
    ``boston_glm`` fixture by ``FX.check_boston_glm_train``; the JAX-saved
    winner served through ``BatchScoreFunction`` against the fixture's
    answers, the port's save loaded back and rescored equal; raises on a
    failed check."""
    import tempfile

    import transmogrifai_tpu_torch as P

    (model, wf), wall, calls = timed_train(
        torch, lambda: boston.train_boston(device=dev, models_and_parameters=boston.glm_space()))
    check(not calls, "the GLM train made a fused sweep call")
    found = FX.check_boston_glm_train(model)
    req = FX.load_columns(FX.BOSTON_GLM + "/requests.npz")
    exp = FX.load_expected(FX.BOSTON_GLM + "/expected.npz")["prediction"]
    fixture_model = P.load_model(FX.BOSTON_GLM, device=dev)
    name = fixture_model.result_features[0].name
    pred = FX.regression_predictions(P.BatchScoreFunction(fixture_model)(FX.records(req)), name)
    fixture_err = float(np.max(np.abs(pred - exp) / np.maximum(np.abs(exp), 1.0)))
    check(np.allclose(pred, exp, rtol=FX.PRED_RTOL, atol=FX.PRED_ATOL),
          f"the fixture model's predictions {fixture_err} from the JAX package's")
    name = model.result_features[0].name
    mine = FX.regression_predictions(P.BatchScoreFunction(model)(FX.records(req)), name)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = P.load_model(tmp, device=dev)
        again = FX.regression_predictions(P.BatchScoreFunction(loaded)(FX.records(req)),
                                          loaded.result_features[0].name)
    check(np.array_equal(again, mine), "the port-saved GLM model rescores differently")
    refit = FX.compare_glm_predictions(mine, req, exp)
    params = model.stages[-1].model_params
    log("boston_glm_reference", rows=506, wall_s=wall,
        best_grid=model.stages[-1].summary.best_grid, **found,
        tolerances={"fold_rmse": FX.GLM_RMSE_RTOL, "prediction": FX.GLM_PRED_RTOL,
                    "unseen_chas": FX.GLM_UNSEEN_ATOL},
        fold_rmse={str(tuple(r["grid"].values())): r["foldMetrics"]
                   for r in model.stages[-1].summary.validation_results},
        refit_coef=np.asarray(params["coef"]).tolist(),
        refit_intercept=np.asarray(params["intercept"]).tolist(),
        fixture_model_prediction_max_rel_err=fixture_err, refit_vs_expected=refit,
        saved_model_rescores_equal=True, timings_s=wf.train_timings)


def boston_glm_check(FX, rows, seed):
    """The check of the Boston GLM scale train: the JAX package's fold RMSE
    of ``boston_data(rows, seed)`` where the fixture has them (2^18 rows,
    seed 0), else every fold RMSE finite and the winner a gaussian /
    identity candidate (medv is linear in the features with Gaussian noise;
    the log-link families trail it by more than 1.4 RMSE on the fixture's
    frame)."""
    sweep = FX.load_sweep(FX.BOSTON_GLM + "/sweep.npz")

    def check_fn(model):
        summ = model.stages[-1].summary
        check(len(summ.validation_results) == 12, "the GLM space has 12 candidates")
        check(summ.holdout_evaluation["R2"] > 0.5, "bad holdout R2")
        if (rows, seed) == (int(sweep["scale_rows"]), int(sweep["scale_seed"])):
            return {"against": "the JAX package's fold RMSE", **FX.check_boston_glm_train(
                model, scale=True)}
        folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
        check(bool(np.isfinite(folds).all()), f"non-finite fold RMSE {folds}")
        check(summ.best_grid["family"] == "gaussian" and summ.best_grid["link"] == "identity",
              f"winner {summ.best_grid} is not a gaussian / identity candidate")
        return {"against": "finite folds and a gaussian / identity winner"}

    return check_fn


#: the H100 SXM's float64 rate with its tensor cores (67 TFLOP/s; 34 outside
#: them), NVIDIA's data sheet at 700 W: the least time of K-X's and K-I
#: centered's float64 work
PEAK_F64_OPS_PER_S = 67e12
#: K-X's and K-I centered's float64 sums against their plain versions (other
#: orders, float64 throughout), relative to each output row's largest entry
STREAM_RTOL = 1e-12
#: the sanity checker's four settings held on the card to the fixture's 891-row
#: Titanic vector: {pearson, spearman} x {in memory, streamed}
SANITY_REFERENCE = ("pearson", "pearson_streamed", "spearman", "spearman_streamed")


def stream_kernels(K):
    """The sanity checker's kernels: K-X, K-I (both modes), K-Y, K-J."""
    return (K.chunk_moments, K.centered_gram, K.midranks, K.corr_gram, K.contingency_counts)


def sanity_reference_phase(torch, titanic, FX, dev="cuda"):
    """The port's sanity checker on the card on the 891-row Titanic vector
    (the port's vectorizers, from a Newton-space train's final fit) in the
    four settings of ``SANITY_REFERENCE``, each fitted alone and held to the
    committed ``titanic_sanity`` fixture (the JAX package's summaries and
    correlation matrices) by ``FX.check_titanic_sanity``; raises on a failed
    check."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.impl.preparators import sanity_checker as SC
    from transmogrifai_tpu_torch.ops import stats as K

    model, _ = titanic.train_titanic(device=dev, models_and_parameters=spaces()["titanic_newton"])
    sc = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel")
    label, vector = sc.inputs
    ds = P.Dataset({f.name: model.train_data[f.name] for f in sc.inputs})
    width = int(ds[vector.name].values.shape[1])
    check(width == FX.load_sanity()["pearson"]["width"], f"Titanic vector width {width}")
    out = {}
    for setting in SANITY_REFERENCE:
        params = FX.SANITY_SETTINGS[setting][1]
        zero_launches(stream_kernels(K))
        stage = SC.SanityChecker(**params).set_input(label, vector).to(dev)
        with FX.CorrMatrices(SC) as rec:
            fitted = stage.fit(ds)
        torch.cuda.synchronize()
        launches = {f"{fn.__name__}_{m}": v for fn in stream_kernels(K)
                    for m, v in getattr(fn, "launches_by_mode", {}).items()}
        launches.update({fn.__name__: fn.launches for fn in stream_kernels(K)})
        streamed, spearman = params.get("sharded_stats") is True, "spearman" in setting
        want = (["chunk_moments", "centered_gram"] if streamed else ["corr_gram"]) \
            + (["midranks"] if spearman else [])
        check(all(launches[k] > 0 for k in want), f"{setting}: launches {launches}")
        out[setting] = {**FX.check_titanic_sanity(fitted.metadata["sanity_checker_summary"],
                                                  setting, rec.matrices[-1]),
                        "launches": launches}
    log("sanity_reference", rows=891, width=width, settings=out,
        tolerances={"corr": FX.SANITY_CORR_ATOL, "moments": FX.SANITY_MOMENT_RTOL})


def sanity_scale_check(torch, FX, setting, rows, seed, keep):
    """The check of a sanity-checker scale train: its final fit's summary
    (and correlation matrix, from ``keep["matrices"]``) held to the
    fixture's on its 2^20-row seed-0 frame, else every label correlation
    finite or null and the vector as wide as the fixture's; keeps the final fit's
    vector and label in ``keep`` for the kernel phase."""

    def check_fn(model):
        sc = next(s for s in model.stages if type(s).__name__ == "SanityCheckerModel")
        summary = sc.metadata["sanity_checker_summary"]
        vec = model.train_data[sc.inputs[1].name].values
        y = np.asarray(model.train_data[sc.inputs[0].name].values, np.float32)
        keep["X"], keep["y"] = vec, torch.from_numpy(y).to(vec.device)
        if setting == "scale_pearson":
            layer_keep(model, keep)
        found = {"width": int(vec.shape[1]), "sample": summary["sampleSize"],
                 "dropped": sorted(summary["dropped"])}
        check(summary["sampleSize"] == rows, f"sample {summary['sampleSize']}, not {rows}")
        check(summary["correlationType"] == FX.SANITY_SETTINGS[setting][1].get(
            "correlation_type", "pearson"), "correlation type")
        if (rows, seed) == (FX.SANITY_SCALE_ROWS, FX.SANITY_SCALE_SEED):
            return {**found, "against": "the JAX package's final fit",
                    **FX.check_titanic_sanity(summary, setting, keep["matrices"][-1])}
        corr = [c for c in summary["correlationsWLabel"]["values"] if c is not None]
        check(bool(np.isfinite(corr).all()), "non-finite label correlations")
        check(found["width"] == FX.load_sanity()[setting]["width"], "the vector's width")
        return {**found, "against": "finite correlations and the fixture's width"}

    return check_fn


def stream_kernel_phase(torch, X, y, timer, dev="cuda"):
    """K-X (both modes), K-I centered and K-Y against their plain versions on
    the card at the scale train's shapes (its final fit's first 2^18-row
    chunk of X f32[n, d] and y; K-Y over all n rows, in float32 and float64,
    and into a slice of a wider matrix), again at a wide shape (2^18 x 512)
    and on tie-heavy columns (integers in [0, 16)): K-Y and K-X's min and
    max bit-equal, the float64 sums within ``STREAM_RTOL``; timed as in
    phase 2, K-Y's stage (and each of its routes, each also held to the
    plain version) beside ``scatter_`` on the same operands and its own
    bound (the values, the int64 order and the rank once a position)."""
    from transmogrifai_tpu_torch.ops import stats as K

    def row_gap(got, want):
        scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        return float(((got - want).abs() / scale).max())

    def held(name, fn, plain):
        got = fn()
        torch.cuda.synchronize()
        check(torch.equal(got, fn()), f"{name} does not repeat bit for bit")
        want = plain()
        if name.startswith("midranks"):
            check(torch.equal(got, want), f"{name} differs from its plain version")
            return 0.0
        if name.startswith("chunk_moments"):
            check(torch.equal(got[2:], want[2:]), f"{name}: min / max differ")
            got, want = got[:2], want[:2]
        err = row_gap(got, want)
        check(err <= STREAM_RTOL, f"{name} {err} from its plain version, above {STREAM_RTOL}")
        return float((got - want).abs().max())

    def centered(Xc, yc, c):
        return (torch.cat([Xc, yc[:, None]], 1).double() - c).contiguous()

    def ranks_library(Xb):
        ss, order = torch.sort(Xb.T.contiguous(), dim=1)
        ordinal = torch.arange(1, Xb.shape[0] + 1, device=Xb.device, dtype=torch.float32)
        return torch.empty(ss.shape, dtype=torch.float32, device=Xb.device).scatter_(
            1, order, ordinal.expand(ss.shape))

    n, d = X.shape
    rows = min(n, 1 << 18)
    Xc, yc = X[:rows].contiguous(), y[:rows].contiguous()
    rng = np.random.default_rng(0)
    Xw = torch.from_numpy(rng.normal(size=(1 << 18, 512)).astype(np.float32) * 3 + 1).to(dev)
    yw = torch.from_numpy(rng.normal(size=1 << 18).astype(np.float32)).to(dev)
    Xt = torch.from_numpy(rng.integers(0, 16, size=(n, 4)).astype(np.float32)).to(dev)
    records, extra = [], {}
    log("stream_plans", centered_gram={
        label: K.gram_plan(A.shape[0], A.shape[1], "centered")._asdict()
        for label, A in (("train", Xc), ("wide", Xw))})
    for label, (A, b) in (("train", (Xc, yc)), ("wide", (Xw, yw))):
        r, dd = A.shape
        for mode, lab in (("raw", None), ("chan", b)):
            name = f"chunk_moments_{mode}"
            err = held(name, lambda: K.chunk_moments(A, lab, mode),
                       lambda: K.chunk_moments_plain(A, lab, mode))
            dc = dd + (lab is not None)
            # the chunk read once, 4 dc float64 written; per element the sums
            # (raw: add, fma, min, max) or Welford's update (~8 operations)
            bd, by = bound_ms(r * dc * 4 + 4 * dc * 8, r * dc * (4 if mode == "raw" else 8),
                              PEAK_F64_OPS_PER_S)
            row = {"max_abs_err": err, "ms": timer(lambda: K.chunk_moments(A, lab, mode)),
                   "plain_ms": timer(lambda: K.chunk_moments_plain(A, lab, mode)),
                   "bound_ms": bd, "bound_by": by, "library_ms": None, "shape": [r, dc]}
            extra[f"{name} {label}"] = row
            if label == "train":
                records.append(dict(
                    name=name, route="cuda",
                    source="transmogrifai_tpu_torch/csrc/stream_stats.cu",
                    replaces="transmogrifai_tpu/parallel/stats.py:"
                             + ("48" if mode == "raw" else "190"), **{
                                 k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms")}))
        c = K.chunk_moments(A, b, "chan")[0]
        err = held("centered_gram", lambda: K.centered_gram(A, b, c),
                   lambda: K.centered_gram_plain(A, b, c))
        Z = centered(A, b, c)
        # the chunk read once, the (d + 1)^2 Gram written; the triangle's r D (D +
        # 1) float64 operations, D = d + 1 (the Gram is symmetric)
        bd, by = bound_ms(r * (dd + 1) * 4 + (dd + 1) ** 2 * 8, r * (dd + 1) * (dd + 2),
                          PEAK_F64_OPS_PER_S)
        row = {"max_abs_err": err, "ms": timer(lambda: K.centered_gram(A, b, c)),
               "plain_ms": timer(lambda: K.centered_gram_plain(A, b, c)),
               "bound_ms": bd, "bound_by": by,
               "library_ms": timer(lambda: torch.mm(Z.T, Z)), "shape": [r, dd + 1]}
        extra[f"centered_gram {label}"] = row
        del Z
        if label == "train":
            records.append(dict(
                name="centered_gram", route="cuda",
                source="transmogrifai_tpu_torch/csrc/col_stats.cu",
                replaces="transmogrifai_tpu/parallel/stats.py:62", **{
                    k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}))
    for label, A in (("train", X), ("train f64", X.double()), ("wide", Xw), ("tie-heavy", Xt)):
        held("midranks", lambda: K.midranks(A), lambda: K.midranks_plain(A))
        r, dd = A.shape
        if label == "train":  # into a slice of a wider matrix (rank_transform's blocks)
            wider = torch.full((r, dd + 3), -1.0, device=dev)
            K.midranks(A, out=wider[:, 1:dd + 1])
            check(torch.equal(wider[:, 1:dd + 1], K.midranks_plain(A))
                  and bool((wider[:, [0, dd + 1, dd + 2]] == -1.0).all()),
                  "midranks into a slice differs from its plain version")
            del wider
        ss, order = torch.sort(A.T.contiguous(), dim=1)
        out = torch.empty((r, dd), dtype=torch.float32, device=dev)
        ordinal = torch.arange(1, r + 1, device=dev, dtype=torch.float32).expand(dd, r)
        ranked = torch.empty((dd, r), dtype=torch.float32, device=dev)
        # the columns read and the ranks written once; the sort's r log2 r
        # comparisons a column.  The stage's own bound: the sorted values,
        # the int64 order and the rank, each once a position
        bd, by = bound_ms(2 * r * dd * 4, r * dd * float(np.log2(max(r, 2))))
        stage_bd, _ = bound_ms(r * dd * (A.element_size() + 8 + 4), 0)
        routes = {}
        for route in K.MIDRANK_ROUTES:  # each route of the stage on the same operands
            if r <= K.PART_MAX_BUCKETS * K.PART_BUCKET_ROWS:
                K._midrank_launch(ss, order, out, route)
                check(torch.equal(out, K.midranks_plain(A)),
                      f"midranks' {route} route differs from its plain version")
                routes[route] = timer(lambda: K._midrank_launch(ss, order, out, route))
        row = {"max_abs_err": 0.0, "ms": timer(lambda: K.midranks(A)),
               "plain_ms": timer(lambda: K.midranks_plain(A)),
               "kernel_ms": timer(lambda: K._midrank_launch(ss, order, out)),
               "route_ms": routes, "stage_bound_ms": stage_bd,
               "scatter_ms": timer(lambda: ranked.scatter_(1, order, ordinal)),
               "sort_ms": timer(lambda: torch.sort(A.T.contiguous(), dim=1)),
               "bound_ms": bd, "bound_by": by, "library_ms": timer(lambda: ranks_library(A)),
               "plan": K.midrank_plan(r, dd, dd)._asdict(), "shape": [r, dd]}
        extra[f"midranks {label}"] = row
        del ss, order, out, ranked
        if label == "train":
            records.append(dict(
                name="midranks", route="cuda",
                source="transmogrifai_tpu_torch/csrc/stream_stats.cu",
                replaces="transmogrifai_tpu/parallel/stats.py:487", **{
                    k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}))
    log("stream_kernels", rows=n, width=d, tolerance=STREAM_RTOL, details=extra,
        f64_ops_per_s=PEAK_F64_OPS_PER_S, records=records)
    return records


#: K-Z's operations that round more than once in the plain version's torch
#: ops on the card (a scalar divisor as its reciprocal's product, ``s / v``
#: as ``reciprocal(v) * s``) or call another library's log / exp / pow:
#: within 2 float32 ulps of it; the rest bit-equal
LAYER_RTOL = 2.0 ** -22
LAYER_APPROX = ("divide", "rdivide", "log", "exp", "power", "round")


def layer_keep(model, keep):
    """Keep the Titanic train's K-Z inputs in ``keep["layer"]``: the family
    size add's columns (values f32, masks), the VectorsCombiner's input
    vectors and the sanity checker's kept columns."""
    by_type = {}
    for s in model.stages:
        by_type.setdefault(type(s).__name__, s)
    data = model.train_data
    sc = by_type["SanityCheckerModel"]
    add = by_type["AddTransformer"]
    comb = next(s for s in model.stages  # the combiner of the checker's vector
                if s.get_outputs()[0].name == sc.inputs[-1].name)
    cols = [data[f.name] for f in add.inputs]
    keep["layer"] = {
        "add": [np.asarray(c.values, np.float32) for c in cols] + [c.mask for c in cols],
        "scalar": float(by_type["ScalarMathTransformer"].get_param("scalar")),
        "combine": [data[f.name].values for f in comb.inputs],
        "select": np.asarray(sc.indices_to_keep, int),
        "vector": data[sc.inputs[-1].name].values}


def layer_kernel_phase(torch, inputs, timer, dev="cuda"):
    """K-Z (numeric_op, column_gather) against its plain versions on the
    Titanic scale train's columns, timed as in phase 2."""
    from transmogrifai_tpu_torch.ops import layer as LY

    av, bv, am, bm = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in inputs["add"])
    n = av.shape[0]
    records, extra = [], {}

    def held(name, got, want, approx):
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            check(torch.equal(got[1], want[1]), f"{name}: masks differ from the plain version")
            got, want = got[0], want[0]
        if approx:
            gap = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
            check(gap <= LAYER_RTOL, f"{name} {gap} from its plain version, above {LAYER_RTOL}")
        else:
            check(torch.equal(got, want), f"{name} differs from its plain version")
        return float((got - want).abs().max())

    # numeric_op: the add (main record), its + 1, and every scalar operation
    s = inputs["scalar"]
    fam, fam_m = LY.numeric_op("plus", av, am, bv, bm)
    for op in LY.NUMERIC_OPS:
        for binary in (False, True) if op in LY.BINARY_OPS else (False,):
            args = (av, am, bv, bm) if binary else (fam, fam_m)
            kw = {} if binary else {"scalar": s if op == "plus" else 2.5}
            err = held(f"numeric_op {op}", LY.numeric_op(op, *args, **kw),
                       LY.numeric_op_plain(op, *args, **kw), op in LAYER_APPROX)
            # each input value and mask read once, the output's written
            bd, by = bound_ms(len(args) // 2 * n * 5 + n * 5, n * len(args) // 2)
            row = {"max_abs_err": err, "ms": timer(lambda: LY.numeric_op(op, *args, **kw)),
                   "plain_ms": timer(lambda: LY.numeric_op_plain(op, *args, **kw)),
                   "bound_ms": bd, "bound_by": by, "library_ms": None}
            extra[f"numeric_op {op}{' binary' if binary else ''}"] = row
            if op == "plus" and binary:
                # the library yardstick: one torch.add of the values (the
                # kernel also ANDs the masks)
                row["library_ms"] = timer(lambda: torch.add(av, bv))
                records.append(dict(
                    name="numeric_op", route="cuda",
                    source="transmogrifai_tpu_torch/csrc/fused_layer.cu",
                    replaces="transmogrifai_tpu/impl/feature/transformers.py:76", **row))
    # column_gather: the combiner's concatenation (main record), the
    # checker's kept columns
    parts = [torch.as_tensor(t).to(dev, torch.float32).contiguous() for t in inputs["combine"]]
    W = sum(t.shape[1] for t in parts)
    err = held("column_gather concat", LY.concat_columns(parts), torch.cat(parts, 1), False)
    bd, by = bound_ms(2 * n * W * 4, 0)
    row = {"max_abs_err": err, "ms": timer(lambda: LY.concat_columns(parts)),
           "plain_ms": timer(lambda: LY.column_gather_plain(
               parts, [i for i, t in enumerate(parts) for _ in range(t.shape[1])],
               [c for t in parts for c in range(t.shape[1])])),
           "bound_ms": bd, "bound_by": by,
           "library_ms": timer(lambda: torch.cat(parts, 1)), "shape": [n, W]}
    extra["column_gather concat"] = row
    records.append(dict(
        name="column_gather", route="cuda", source="transmogrifai_tpu_torch/csrc/fused_layer.cu",
        replaces="transmogrifai_tpu/impl/feature/vectorizers.py:457",
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}))
    vec = torch.as_tensor(inputs["vector"]).to(dev, torch.float32).contiguous()
    sel = inputs["select"]
    idx = torch.as_tensor(sel, device=dev)
    zeros = [0] * len(sel)
    err = held("column_gather select", LY.column_gather([vec], zeros, sel),
               vec.index_select(1, idx), False)
    bd, by = bound_ms(2 * n * len(sel) * 4, 0)
    extra["column_gather select"] = {
        "max_abs_err": err, "ms": timer(lambda: LY.column_gather([vec], zeros, sel)),
        "plain_ms": timer(lambda: LY.column_gather_plain([vec], zeros, sel)),
        "bound_ms": bd, "bound_by": by,
        "library_ms": timer(lambda: vec.index_select(1, idx)), "shape": [n, len(sel)],
        "replaces": "transmogrifai_tpu/impl/preparators/sanity_checker.py:507"}
    log("layer_kernels", rows=n, tolerance=LAYER_RTOL, approx=LAYER_APPROX, details=extra,
        records=records)
    return records


def sanity_phases(torch, titanic, FX, args, timer, dev="cuda"):
    """Phases 32-36: the reference settings, the Pearson and Spearman scale
    trains at ``--stats-rows`` rows (each sanity-checker fit streams its
    sample; the layers of more than 200,000 rows run K-Z), the kernels on
    the final fit's sample and columns.  Returns (the kernels' records,
    their launches on the scale trains)."""
    from transmogrifai_tpu_torch.impl.preparators import sanity_checker as SC
    from transmogrifai_tpu_torch.ops import layer as LY
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import stats as K

    sanity_reference_phase(torch, titanic, FX, dev)
    launches, keep = {}, {}
    layer = ("numeric_op", "column_gather")
    for setting, required in (("scale_pearson", ("chunk_moments_chan", "centered_gram") + layer),
                              ("scale_spearman", ("chunk_moments_raw", "centered_gram",
                                                  "midranks") + layer)):
        params = FX.SANITY_SETTINGS[setting][1]
        cols = titanic_columns(args.stats_rows, args.seed)
        with FX.CorrMatrices(SC) as rec:
            keep["matrices"] = rec.matrices
            launches[setting], _, _ = scale_train_phase(
                torch, f"sanity_{setting}_train",
                lambda: titanic.train_titanic(cols, device=dev,
                                              models_and_parameters=spaces()["titanic_newton"],
                                              sanity_check_params=params),
                stream_kernels(K) + (L.weighted_gram, M.binary_metrics, LY.numeric_op,
                                     LY.column_gather),
                required + ("weighted_gram",),
                sanity_scale_check(torch, FX, setting, args.stats_rows, args.seed, keep))
        del cols
    records = stream_kernel_phase(torch, keep["X"], keep["y"], timer, dev)
    records += layer_kernel_phase(torch, keep.pop("layer"), timer, dev)
    return records, {
        "chunk_moments_raw": launches["scale_spearman"]["chunk_moments_raw"],
        "chunk_moments_chan": launches["scale_pearson"]["chunk_moments_chan"],
        "centered_gram": launches["scale_pearson"]["centered_gram"],
        "midranks": launches["scale_spearman"]["midranks"],
        "numeric_op": launches["scale_pearson"]["numeric_op"],
        "column_gather": launches["scale_pearson"]["column_gather"]}


#: K-AA against its plain version on the card: float32 sums of a row's
#: gradient in another order (a fixed segment order against index_add_)
SGNS_CARD_ATOL = 1e-6
#: K-AB's beta mode: the same digamma sequence, libdevice's exp / log1p /
#: cos / sin in both, the topic sums in another order
LDA_BETA_RTOL = 2e-5
#: K-AB's estep, as the largest gap of a document's topic mixture (gamma
#: over its sum): the E-step's map is unstable at small topic weights (slope
#: about 2.5 near gamma = 0.25), so a few documents' small gammas carry the
#: products' last-bit order gaps through 30 iterations (up to 2.0e-2 of such a
#: gamma at 2^17 documents against the plain version on the card); the
#: mixture moves by that gap over the document's total
LDA_THETA_ATOL = 1e-3
#: K-AB's sstats: float32 sums over each term's documents in another order
LDA_SSTATS_RTOL = 1e-4
#: scalar operations of one float32 digamma (the Lanczos form: eight steps of
#: an add, a multiply, two divisions and two adds; log1p, the last terms) and
#: of one exp
DIGAMMA_OPS = 60
EXP_OPS = 8


class TimeCalls:
    """Host seconds spent in the named callables of ``owner`` while on (each
    call synchronized with the card before its clock stops)."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.saved = torch, targets, []
        self.seconds, self.last = {}, {}

    def __enter__(self):
        for label, owner, name in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            self.seconds.setdefault(label, 0.0)

            def timed(*a, _fn=fn, _label=label, **k):
                t = time.perf_counter()
                out = _fn(*a, **k)
                self.torch.cuda.synchronize()
                self.seconds[_label] += time.perf_counter() - t
                self.last[_label] = out
                return out

            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def text_timers(torch):
    from transmogrifai_tpu_torch.impl.feature import embeddings as Emb
    from transmogrifai_tpu_torch.impl.feature import text as Tx

    return TimeCalls(torch, [
        ("tokenizer", Tx.TextTokenizer, "transform_columns"),
        ("count_vectorizer_fit", Tx.OpCountVectorizer, "fit_columns"),
        ("count_vectorizer_transform", Tx.OpCountVectorizerModel, "transform_columns"),
        ("w2v_fit", Emb.OpWord2Vec, "fit_columns"),
        ("w2v_token_ids", Emb, "_token_ids"),
        ("w2v_pair_building", Emb, "skipgram_pairs"),
        ("w2v_epochs", Emb.OpWord2Vec, "train"),
        ("w2v_transform", Emb.OpWord2VecModel, "transform_columns"),
        ("lda_fit", Emb.OpLDA, "fit_columns"),
        ("lda_transform", Emb.OpLDAModel, "transform_columns")])


class LastLdaFit:
    """Keeps the count column and the fitted topic-word matrix of the last
    ``OpLDA`` fit while on."""

    def __init__(self):
        from transmogrifai_tpu_torch.impl.feature import embeddings as Emb

        self.cls, self.col, self.topic_word, self.fits = Emb.OpLDA, None, None, 0

    def __enter__(self):
        fit = self.fit = self.cls.fit_columns

        def recording(stage, cols, dataset):
            model = fit(stage, cols, dataset)
            self.col, self.topic_word = cols[0], model.topic_word
            self.fits += 1
            return model

        self.cls.fit_columns = recording
        return self

    def __exit__(self, *exc):
        self.cls.fit_columns = self.fit


def text_reference_phase(torch, titanic, FX, dev="cuda"):
    """Phase 37: the JAX-saved text model scores the fixture's 256 requests
    on the card; the tokenizer and the fixture's count model give the JAX
    package's tokens and counts; the port's 891-row full-width text train
    (stock space) is held to the fixture by ``FX.check_titanic_text_train``
    (winner, fold AuPR by family, vocabularies, skip-gram pairs / negatives /
    W0 by digest, word vectors, LDA topic-word)."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.impl.feature import embeddings as Emb

    model = P.load_model(FX.TITANIC_TEXT, device=dev)
    req = FX.load_columns(FX.TITANIC_TEXT + "/requests.npz")
    name = model.result_features[0].name
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(model)(FX.records(req)), name)
    answers = FX.compare_text_answers(FX.load_expected(FX.TITANIC_TEXT + "/expected.npz"),
                                      pred, prob, FX.TEXT_JAX_SAVED_PROB_ATOL)
    cols = titanic.text_columns()
    tokens = FX.check_text_tokens(model, cols["Notes"])
    with FX.PortW2VArgs(Emb) as rec:
        (trained, wf), wall, calls = timed_train(
            torch, lambda: titanic.train_titanic(cols, device=dev, text_embeddings=True))
    found = FX.check_titanic_text_train(trained, rec.calls[-1])
    log("text_reference", rows=891, jax_saved_requests=answers, tokens=tokens, wall_s=wall,
        word2vec_fits=len(rec.calls), sweep_calls=len(calls),
        sweep_features=int(calls[0][0].X.shape[1]), **found,
        tolerances={"w2v_atol": FX.TEXT_W2V_ATOL, "lda_rtol": FX.TEXT_LDA_RTOL,
                    "lda_atol": FX.TEXT_LDA_ATOL, "lr_aupr": FX.LR_AUPR_TOL,
                    "rf_aupr": FX.RF_AUPR_TOL, "xgb_aupr": TRAIN_AUPR_TOL},
        host_clock_s=wf.train_timings)
    return model


def text_check(rows):
    """The check of the text scale train: 28 candidates with finite fold
    AuPR above 0.5, the holdout AuPR above 0.5, a finite LDA topic-word
    matrix and finite word vectors."""

    def check_fn(model):
        summ = model.stages[-1].summary
        folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
        check(len(summ.validation_results) == 28, "the stock space has 28 candidates")
        check(all(np.isfinite(folds)) and min(folds) > 0.5, f"bad fold metrics {folds}")
        check(summ.holdout_evaluation["AuPR"] > 0.5, "bad holdout AuPR")
        lda = next(s for s in model.stages if type(s).__name__ == "OpLDAModel")
        w2v = next(s for s in model.stages if type(s).__name__ == "OpWord2VecModel")
        check(bool(np.isfinite(lda.topic_word).all()), "non-finite LDA topic-word")
        check(bool(np.isfinite(w2v.vectors).all()), "non-finite word vectors")
        return {"rows": rows, "holdout_aupr": summ.holdout_evaluation["AuPR"],
                "w2v_vocabulary": len(w2v.vocabulary), "final_loss": w2v.metadata.get(
                    "final_loss"), "fold_aupr_min": min(folds), "fold_aupr_max": max(folds)}

    return check_fn


def mixture_gap(gamma, ref):
    """The largest gap of the documents' topic mixtures gamma / sum(gamma)."""
    return float((gamma / gamma.sum(1, keepdim=True) - ref / ref.sum(1, keepdim=True))
                 .abs().max())


def text_kernel_phase(torch, keep, call, timer, FX, dev="cuda"):
    """Phase 39: K-AA on the final Word2Vec fit's inputs, K-AB's three modes
    on the final LDA fit's count matrix and topic-word matrix, K-K at the
    text vector's width, each against its plain version (and the small K18
    cases against the JAX package's outputs in ``k18.npz``), timed beside
    its bound and a PyTorch yardstick."""
    import torch.nn.functional as TF

    from transmogrifai_tpu_torch.ops import embeddings as E
    from transmogrifai_tpu_torch.ops import linear as L

    records, shapes = [], {}
    # K-AA: ten kernel epochs from the final fit's W0, then one epoch held to plain
    W0, pairs_np, negs_np = keep["w2v"]
    W = torch.from_numpy(W0).to(dev)
    C = torch.zeros_like(W)
    pairs = torch.from_numpy(pairs_np).to(dev)
    negs = torch.from_numpy(negs_np).to(dev)
    V, d = W.shape
    P_, K = negs.shape
    lists = E.sgns_lists(pairs, negs, V)
    for _ in range(10):
        W, C, _ = E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists, want_loss=False)
    got = E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists)
    want = E.sgns_epoch_plain(W, C, pairs, negs, 0.2)
    again = E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "sgns_epoch does not repeat")
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
    check(err <= SGNS_CARD_ATOL, f"sgns_epoch {err} from plain, above {SGNS_CARD_ATOL}")
    loss_gap = abs(float(got[2]) - float(want[2]))
    c_, o_, ng_ = pairs[:, 0].long(), pairs[:, 1].long(), negs.long()

    def sgns_library():
        Wr, Cr = W.detach().requires_grad_(), C.detach().requires_grad_()
        wc = Wr[c_]
        pos = (wc * Cr[o_]).sum(1)
        neg = torch.einsum("pd,pkd->pk", wc, Cr[ng_])
        loss = (TF.softplus(-pos) + TF.softplus(neg).sum(1)).mean()
        gW, gC = torch.autograd.grad(loss, (Wr, Cr))
        return W - 0.2 * gW, C - 0.2 * gC

    # W, C read and written once, the pairs and negatives read once; per pair
    # the K + 1 scores and both gradient rows (6 d operations a slot) and
    # about 20 for the sigmoid / softplus of a slot; the update
    b, by = bound_ms(4 * V * d * 4 + P_ * (2 + K) * 4, P_ * (K + 1) * (6 * d + 20) + 4 * V * d)
    records.append(dict(
        name="sgns_epoch", route="cuda", source="transmogrifai_tpu_torch/csrc/sgns.cu",
        replaces="transmogrifai_tpu/impl/feature/embeddings.py:37", max_abs_err=err,
        ms=timer(lambda: E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists, want_loss=False)),
        plain_ms=timer(lambda: E.sgns_epoch_plain(W, C, pairs, negs, 0.2)),
        bound_ms=b, bound_by=by, library_ms=timer(sgns_library)))
    shapes["sgns"] = {"V": V, "d": d, "P": P_, "K": K, "segments": int(lists.seg_row.numel())}
    lists_ms = timer(lambda: E.sgns_lists(pairs, negs, V))

    # K-AB: beta, estep and sstats on the final LDA fit's counts and lambda
    X = torch.clamp_min(keep["lda_col"].tensor(dev), 0.0)
    lam = torch.from_numpy(keep["lda_topic_word"]).to(dev)
    n, v = X.shape
    k = lam.shape[0]
    docs = E.lda_docs(X)
    nnz = int(docs.terms.numel())
    eb = E.lda_beta(lam)
    eb0 = E.lda_beta_plain(lam)
    beta_err = float(((eb - eb0).abs() / eb0.abs().clamp_min(1e-30)).max())
    check(beta_err <= LDA_BETA_RTOL, f"lda_beta {beta_err} from plain")
    g = E.lda_estep(eb0, X, 0.1, 30, docs=docs)
    g0 = E.lda_estep_plain(eb0, X, 0.1, 30)
    check(torch.equal(g, E.lda_estep(eb0, X, 0.1, 30, docs=docs)), "lda_estep does not repeat")
    gamma_err = float(((g - g0).abs() / g0).max())
    theta_err = mixture_gap(g, g0)
    check(theta_err <= LDA_THETA_ATOL, f"lda_estep mixtures {theta_err} from plain")
    lam1 = E.lda_sstats(eb0, X, g0, 0.01, docs=docs)
    lam0 = E.lda_sstats_plain(eb0, X, g0, 0.01)
    sstats_err = float(((lam1 - lam0).abs() / lam0).max())
    check(sstats_err <= LDA_SSTATS_RTOL, f"lda_sstats {sstats_err} from plain")
    et = torch.exp(E.digamma(g0) - E.digamma(g0.sum(1, keepdim=True)))

    def dense_iterations():
        for _ in range(30):
            phi = et @ eb0
            (X / phi) @ eb0.T

    b, by = bound_ms(2 * k * v * 4, k * v * (DIGAMMA_OPS + EXP_OPS + 1) + k * DIGAMMA_OPS)
    records.append(dict(
        name="lda_beta", route="cuda", source="transmogrifai_tpu_torch/csrc/lda.cu",
        replaces="transmogrifai_tpu/impl/feature/embeddings.py:163", max_abs_err=float(
            (eb - eb0).abs().max()), ms=timer(lambda: E.lda_beta(lam)),
        plain_ms=timer(lambda: E.lda_beta_plain(lam)), bound_ms=b, bound_by=by,
        library_ms=timer(lambda: torch.exp(torch.special.digamma(lam) - torch.special.digamma(
            lam.sum(1, keepdim=True))))))
    per_doc = k * (DIGAMMA_OPS + EXP_OPS + 4) + DIGAMMA_OPS + k
    b, by = bound_ms(k * v * 4 + (n + 1) * 4 + nnz * 8 + n * k * 4,
                     30 * (nnz * (4 * k + 1) + n * per_doc))
    records.append(dict(
        name="lda_estep", route="cuda", source="transmogrifai_tpu_torch/csrc/lda.cu",
        replaces="transmogrifai_tpu/impl/feature/embeddings.py:160",
        max_abs_err=float((g - g0).abs().max()),
        ms=timer(lambda: E.lda_estep(eb0, X, 0.1, 30, docs=docs)),
        plain_ms=timer(lambda: E.lda_estep_plain(eb0, X, 0.1, 30)), bound_ms=b, bound_by=by,
        library_ms=timer(dense_iterations)))
    b, by = bound_ms(2 * k * v * 4 + n * k * 4 + (n + 1) * 4 + nnz * 8,
                     n * per_doc + nnz * (4 * k + 1) + 2 * k * v)
    records.append(dict(
        name="lda_sstats", route="cuda", source="transmogrifai_tpu_torch/csrc/lda.cu",
        replaces="transmogrifai_tpu/impl/feature/embeddings.py:211",
        max_abs_err=float((lam1 - lam0).abs().max()),
        ms=timer(lambda: E.lda_sstats(eb0, X, g0, 0.01, docs=docs)),
        plain_ms=timer(lambda: E.lda_sstats_plain(eb0, X, g0, 0.01)), bound_ms=b, bound_by=by,
        library_ms=timer(lambda: et.T @ (X / (et @ eb0)))))
    shapes["lda"] = {"n": n, "v": v, "k": k, "nnz": nnz}
    docs_ms = timer(lambda: E.lda_docs(X))

    # the small cases against the JAX package's outputs
    k18 = FX.load_k18()
    t = {key: torch.from_numpy(np.asarray(k18[key])).to(dev) for key in k18
         if key.startswith(("sgns_", "lda_")) and np.asarray(k18[key]).ndim > 0}
    sW, sC, sl = E.sgns_epoch(t["sgns_W"], t["sgns_C"], t["sgns_pairs"], t["sgns_negs"], 0.2)
    jax_gaps = {"sgns_W": float((sW - t["sgns_W_out"]).abs().max()),
                "sgns_C": float((sC - t["sgns_C_out"]).abs().max()),
                "sgns_loss": abs(float(sl) - float(k18["sgns_loss"]))}
    jeb = E.lda_beta(t["lda_lam"])
    jg = E.lda_estep(jeb, t["lda_X"], 0.1, 30)
    jl = E.lda_sstats(jeb, t["lda_X"], t["lda_gamma"], 0.01)
    rel = lambda a, b_: float(((a - b_).abs() / b_.abs().clamp_min(1e-30)).max())  # noqa: E731
    jax_gaps.update(lda_exp_beta=rel(jeb, t["lda_exp_beta"]), lda_gamma=rel(jg, t["lda_gamma"]),
                    lda_lam=rel(jl, t["lda_lam_out"]))
    check(max(jax_gaps["sgns_W"], jax_gaps["sgns_C"]) <= SGNS_CARD_ATOL, f"K-AA vs JAX {jax_gaps}")
    jax_gaps["lda_theta"] = mixture_gap(jg, t["lda_gamma"])
    check(jax_gaps["lda_exp_beta"] <= LDA_BETA_RTOL and jax_gaps["lda_theta"] <= LDA_THETA_ATOL
          and jax_gaps["lda_lam"] <= LDA_SSTATS_RTOL, f"K-AB vs JAX {jax_gaps}")

    # K-K at the text vector's width: the first sweep call's FISTA fits
    plan, train_w, _ = call
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev).contiguous()
    args, wc, Cf = fista_inputs(torch, plan, tw, L.fit_logistic_grid_folds_fista)
    X1, z, l2v, wsum = args[0], args[4], args[5], args[6]
    nf, p = X1.shape
    check(p > 64, f"the text vector is {p} coefficients wide, not past K-K's narrow limit")
    gotk, wantk = L.fista_grad(*args), L.fista_grad_plain(*args)
    check(torch.equal(gotk, L.fista_grad(*args)), "wide fista_grad does not repeat bit for bit")
    scale = float(wantk.abs().max())
    err_k = float((gotk - wantk).abs().max())
    check(err_k <= FISTA_GRAD_RTOL * scale, f"wide fista_grad {err_k} from plain")
    F = tw.shape[0]
    b, by = bound_ms((nf * p + F * nf + nf) * 4 + Cf * (3 * p + 1) * 4, Cf * nf * (4 * p + 20))
    records.append(dict(
        name="fista_grad_wide", route="cuda", source="transmogrifai_tpu_torch/csrc/fista.cu",
        replaces="transmogrifai_tpu/ops/linear.py:105", max_abs_err=err_k,
        ms=timer(lambda: L.fista_grad(*args)), plain_ms=timer(lambda: L.fista_grad_plain(*args)),
        bound_ms=b, bound_by=by, library_ms=timer(lambda: torch.matmul(
            wc * (torch.sigmoid(torch.matmul(X1, z.T)).T - args[1]), X1) / wsum[:, None]
            + l2v * z)))
    shapes["fista_wide"] = {"X1": [nf, p], "fits": Cf}
    log("text_kernels", shapes=shapes, sgns_loss_gap=loss_gap, lda_beta_rel_err=beta_err,
        lda_gamma_rel_err=gamma_err, lda_theta_err=theta_err, lda_sstats_rel_err=sstats_err,
        vs_jax=jax_gaps,
        sgns_lists_ms=lists_ms, lda_docs_ms=docs_ms, fista_grad_scale=scale, records=records)
    return records


def text_serve_phase(torch, model, FX, reps):
    """Phase 40: p50 of a ``BatchScoreFunction`` request for the text model
    (the LDA E-step lies on the request path) at 1, 64 and 1,024 records."""
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import embeddings as E

    req = FX.records(FX.load_columns(FX.TITANIC_TEXT + "/requests.npz"))
    recs = (req * (-(-max(BATCH_SIZES) // len(req))))[:max(BATCH_SIZES)]
    name = model.result_features[0].name
    fn = P.BatchScoreFunction(model)
    before = E.lda_estep.launches
    p50 = {}
    for size in BATCH_SIZES:
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            out = fn(recs[:size])
            times.append((time.perf_counter() - t) * 1e3)
            _, prob, _ = FX.prediction_arrays(out, name)
            check(len(out) == size and np.isfinite(prob).all(), "bad text-model answers")
        p50[size] = statistics.median(times)
    check(E.lda_estep.launches > before, "the text model's requests did not launch K-AB")
    log("text_serve", p50_ms_by_batch=p50, estep_launches=E.lda_estep.launches - before)


def text_phases(torch, titanic, FX, args, timer, dev="cuda"):
    """Phases 37-40: the text reference, the ``--text-rows`` text train
    (K-AA, K-AB's three modes and K-K's wide form required), the kernels,
    the text model's request latency.  Returns (the kernels' records, their
    launches on the text train)."""
    from transmogrifai_tpu_torch.impl.feature import embeddings as Emb
    from transmogrifai_tpu_torch.ops import embeddings as E
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import stats as K
    from transmogrifai_tpu_torch.ops import threefry as R
    from transmogrifai_tpu_torch.ops import trees as Tr

    fixture_model = text_reference_phase(torch, titanic, FX, dev)
    cols = titanic.text_columns(args.text_rows, args.seed)
    text_kernels = (E.sgns_epoch, E.lda_beta, E.lda_estep, E.lda_sstats, L.fista_grad,
                    M.binary_metrics, Tr.bin_rows, Tr.level_hist, Tr.split_scan, Tr.route_rows,
                    Tr.boost_step, Tr.forest_leaf_mean, K.corr_gram, K.contingency_counts,
                    R.threefry_draws)
    keep = {}

    def train():
        if "clock" in keep:                      # the profiled second run
            return titanic.train_titanic(cols, device=dev, text_embeddings=True)
        with text_timers(torch) as keep["clock"]:
            return titanic.train_titanic(cols, device=dev, text_embeddings=True)

    with FX.PortW2VArgs(Emb) as w2v, LastLdaFit() as lda:
        launches, calls, _ = scale_train_phase(
            torch, "text_train", train, text_kernels,
            ("sgns_epoch", "lda_beta", "lda_estep", "lda_sstats", "fista_grad"),
            text_check(args.text_rows))
    clock = keep["clock"]
    log("text_train_breakdown", rows=args.text_rows, host_clock_s=clock.seconds,
        word2vec_fits_two_runs=len(w2v.calls), lda_fits_two_runs=lda.fits,
        final_pairs=int(w2v.calls[-1][1].shape[0]),
        final_pairs_before_cap=int(clock.last["w2v_pair_building"].shape[0]),
        final_vocabulary=int(w2v.calls[-1][0].shape[0]))
    keep["w2v"] = w2v.calls[-1]
    keep["lda_col"], keep["lda_topic_word"] = lda.col, lda.topic_word
    records = text_kernel_phase(torch, keep, calls[0][:3], timer, FX, dev)
    text_serve_phase(torch, fixture_model, FX, args.reps)
    return records, {"sgns_epoch": launches["sgns_epoch"], "lda_beta": launches["lda_beta"],
                     "lda_estep": launches["lda_estep"], "lda_sstats": launches["lda_sstats"],
                     "fista_grad_wide": launches["fista_grad"]}


# ---------------------------------------------------------------------------
# slice 11: K-S, K-P and K-T past 64 coefficients; the streaming executor and
# the OpTitanicSimple flow (K-AC, K-AD)
# ---------------------------------------------------------------------------
#: the wide entries against their plain versions, relative to the largest
#: entry: float64 sums in both, float32 margins in another order
WIDE_RTOL = 1e-5
#: K-AC's log and exp against torch's (libdevice), 2 float32 ulps
SCALE_APPROX_RTOL = 2.0 ** -22


def wide_reference_phase(torch, titanic, FX, dev="cuda"):
    """Phase 41: the text flow's Newton + SVC train on the card against the
    JAX package's (its launches of K-S and K-T all wide: p = 85), and K-P's
    wide entry through ``fit_softmax_grid_folds``.  Returns the launches."""
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.classification.svc import OpLinearSVC
    from transmogrifai_tpu_torch.impl.selector import defaults as D
    from transmogrifai_tpu_torch.ops import linear as L

    space = [(OpLogisticRegression(), D.grid(reg_param=[0.001, 0.01, 0.1, 0.2],
                                              elastic_net_param=[0.0])),
             (OpLinearSVC(), D.linear_svc_grid())]
    zero_launches((L.weighted_gram, L.svc_grad, L.softmax_fista_grad))
    t = time.perf_counter()
    model, _ = titanic.train_titanic(titanic.text_columns(891, 0), device=dev,
                                     text_embeddings=True, models_and_parameters=space)
    wall = time.perf_counter() - t
    found = FX.check_titanic_text_wide_train(model)
    check(found["width"] > 64, "the text flow's vector is not wide")
    launches = {"weighted_gram_wide": L.weighted_gram.launches,
                "svc_grad_wide": L.svc_grad.launches}
    rng = np.random.default_rng(41)
    n = 1 << 17
    X = torch.from_numpy((rng.random((n, 84)) < 0.15).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 3, n).astype(np.float32)).to(dev)
    tw = torch.from_numpy((rng.random((3, n)) < 0.67).astype(np.float32)).to(dev)
    t2 = time.perf_counter()
    fit = L.fit_softmax_grid_folds(X, y, tw, [0.0, 0.001], [0.01, 0.05], 3, max_iter=20)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(fit.coef).all()), "non-finite wide softmax fit")
    launches["softmax_fista_grad_wide"] = L.softmax_fista_grad.launches
    missing = [k for k, v in launches.items() if v <= 0]
    check(not missing, f"wide entries not launched: {missing}")
    log("wide_reference", wall_s=wall, softmax_wall_s=time.perf_counter() - t2,
        launches=launches, **found)
    return launches


def softmax_library(torch, X1, y, w, fold, z, l2m, wsum):
    """K-P's library yardstick: two [n, p] x [p, C k] products for all fits
    and a ``softmax`` (as ``iris_kernel_phase``'s)."""
    n, p = X1.shape
    C, _, k = z.shape
    zf = z.permute(1, 0, 2).reshape(p, C * k)
    Yk = torch.nn.functional.one_hot(y.long(), k).float().repeat(1, C)
    wk = w[fold.long()].T.repeat_interleave(k, dim=1)

    def library():
        mu = torch.softmax(torch.matmul(X1, zf).view(n, C, k), -1).view(n, C * k)
        g = torch.matmul(X1.T, wk * (mu - Yk)).view(p, C, k).permute(1, 0, 2)
        return g / wsum[:, None, None] + l2m * z

    return library


def svc_library(torch, X1, y, w, fold, z, l2v, wsum):
    """K-T's library yardstick: two [C, n] x [n, p] products and the
    elementwise terms."""
    ypm, wf = 2.0 * y - 1.0, w[fold.long()]

    def library():
        active = torch.clamp_min(1.0 - ypm * (z @ X1.T), 0.0)
        return (wf * ((-2.0 * ypm) * active)) @ X1 / wsum[:, None] + l2v * z

    return library


#: phase 42's folds x grid (K-S, K-T: 12 fits) and K-P's (classes, fits)
WIDE_FOLDS, WIDE_GRID = 3, 4
WIDE_SOFTMAX = ((3, 6), (8, 2))


def wide_inputs(p, n):
    """Phase 42's inputs at p coefficients and n rows, numpy from the seed
    p: X1 (15% ones, six normal columns, the intercept), the 0/1 labels, the
    folds' 0/1 weights, each fit's fold, the fits' coefficients, the GLM's
    Poisson labels, and for each of ``WIDE_SOFTMAX`` the class labels and
    coefficients [fits, p, k]."""
    rng = np.random.default_rng(p)
    X1 = np.concatenate([(rng.random((n, p - 1)) < 0.15) * 1.0, np.ones((n, 1))], 1)
    X1[:, :6] = rng.normal(size=(n, 6))
    C = WIDE_FOLDS * WIDE_GRID
    out = {"X1": X1, "y": rng.random(n) < 0.4, "w": rng.random((WIDE_FOLDS, n)) < 0.67,
           "fold": np.arange(C) % WIDE_FOLDS, "beta": rng.normal(size=(C, p)) * 0.05,
           "y_glm": rng.poisson(1.5, n)}
    for k, Cs in WIDE_SOFTMAX:
        out[f"y{k}"] = rng.integers(0, k, n)
        out[f"z{k}"] = rng.normal(size=(Cs, p, k)) * 0.05
    return out


def library_check(torch, name, library, kernel):
    """A library yardstick computes the kernel's function: within 1e-5 of its
    largest entry (float32 products in another order)."""
    torch.cuda.synchronize()
    gap, scale = float((library - kernel).abs().max()), float(kernel.abs().max())
    check(gap <= 1e-5 * scale, f"{name}: the library yardstick is {gap} from the kernel "
                               f"(scale {scale}): another function")


def wide_kernel_phase(torch, timer, dev="cuda", shapes=((85, 1 << 17), (513, 1 << 15))):
    """Phase 42: the wide entries against their plain versions at p = 85 and
    513.  Returns the three main records (p = 85)."""
    from transmogrifai_tpu_torch.ops import linear as L

    records, extra = [], {}

    def held(name, got, want):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(got, want):
            scale = float(b.abs().max()) + 1e-30
            gap = float((a - b).abs().max())
            check(gap <= WIDE_RTOL * scale, f"{name}: {gap} from its plain version "
                                            f"(scale {scale}), above {WIDE_RTOL}")
            err = max(err, gap)
        return err

    for p, n in shapes:
        inp = wide_inputs(p, n)
        F, C = WIDE_FOLDS, WIDE_FOLDS * WIDE_GRID
        t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        X1t = t(inp.pop("X1"))
        y = t(inp["y"])
        w = t(inp["w"])
        fold = t(inp["fold"], torch.int32)
        beta = t(inp["beta"])
        wsum = w.sum(1)[fold.long()]
        l2v = t(np.full((C, p), 0.01))
        # K-S: Newton, ridge, GLM (poisson / log)
        E = p * (p + 1) // 2 + p
        for mode, args in (("newton", (beta,)), ("ridge", ()),
                           ("glm", (beta, ("poisson", "log", t(np.zeros(C)))))):
            yy = t(inp["y_glm"]) if mode == "glm" else y
            fn = lambda: L.weighted_gram(X1t, yy, w, fold, *args)
            err = held(f"weighted_gram {mode} p{p}", fn(),
                       L.weighted_gram_plain(X1t, yy, w, fold, *args))
            f64 = 2.0 * C * n * E
            f32 = 0.0 if mode == "ridge" else 2.0 * C * n * p
            t_ops = (f64 / PEAK_F64_OPS_PER_S + f32 / PEAK_SCALAR_OPS_PER_S) * 1e3
            t_bytes = (n * p * 4 + F * n * 4 + n * 4 + C * E * 4) / PEAK_BYTES_PER_S * 1e3
            # the library call: one einsum with the weights given (as K9's)
            v = L._gram_weights(X1t, yy, w, fold, *(args or (None,)))[0]
            row = {"max_abs_err": err, "ms": timer(fn),
                   "plain_ms": timer(lambda: L.weighted_gram_plain(X1t, yy, w, fold, *args)),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": timer(lambda: torch.einsum("cn,np,nq->cpq", v, X1t, X1t)),
                   "shape": [n, p, C]}
            extra[f"weighted_gram {mode} p{p}"] = row
            del v
            if p == 85 and mode == "newton":
                records.append(dict(name="weighted_gram_wide", route="cuda",
                                    source="transmogrifai_tpu_torch/csrc/weighted_gram.cu",
                                    replaces="transmogrifai_tpu/ops/linear.py:53", **row))
        # K-T
        fn = lambda: L.svc_grad(X1t, y, w, fold, beta, l2v, wsum)
        err = held(f"svc_grad p{p}", fn(), L.svc_grad_plain(X1t, y, w, fold, beta, l2v, wsum))
        bd, by = bound_ms(n * p * 4 + F * n * 4 + n * 4 + 3 * C * p * 4, 4.0 * C * n * p)
        library = svc_library(torch, X1t, y, w, fold, beta, l2v, wsum)
        library_check(torch, f"svc_grad p{p}", library(), fn())
        row = {"max_abs_err": err, "ms": timer(fn),
               "plain_ms": timer(lambda: L.svc_grad_plain(X1t, y, w, fold, beta, l2v, wsum)),
               "bound_ms": bd, "bound_by": by, "library_ms": timer(library),
               "shape": [n, p, C]}
        del library
        extra[f"svc_grad p{p}"] = row
        if p == 85:
            records.append(dict(name="svc_grad_wide", route="cuda",
                                source="transmogrifai_tpu_torch/csrc/wide_rows.cuh",
                                replaces="transmogrifai_tpu/ops/linear.py:254", **row))
        # K-P, three classes and eight
        for k, Cs in WIDE_SOFTMAX:
            yc = t(inp[f"y{k}"])
            z = t(inp[f"z{k}"])
            l2m = t(np.full((Cs, p, k), 0.01))
            fs = fold[:Cs].contiguous()
            ws = w.sum(1)[fs.long()]
            fn = lambda: L.softmax_fista_grad(X1t, yc, w, fs, z, l2m, ws)
            err = held(f"softmax_fista_grad p{p} k{k}", fn(),
                       L.softmax_fista_grad_plain(X1t, yc, w, fs, z, l2m, ws))
            bd, by = bound_ms(n * p * 4 + F * n * 4 + n * 4 + 3 * Cs * p * k * 4,
                              Cs * n * (4.0 * p * k + 6 * k))
            library = softmax_library(torch, X1t, yc, w, fs, z, l2m, ws)
            library_check(torch, f"softmax_fista_grad p{p} k{k}", library(), fn())
            row = {"max_abs_err": err, "ms": timer(fn),
                   "plain_ms": timer(lambda: L.softmax_fista_grad_plain(X1t, yc, w, fs, z, l2m,
                                                                         ws)),
                   "bound_ms": bd, "bound_by": by, "library_ms": timer(library),
                   "shape": [n, p, k, Cs]}
            del library
            extra[f"softmax_fista_grad p{p} k{k}"] = row
            if p == 85 and k == 3:
                records.append(dict(name="softmax_fista_grad_wide", route="cuda",
                                    source="transmogrifai_tpu_torch/csrc/wide_rows.cuh",
                                    replaces="transmogrifai_tpu/ops/linear.py:148", **row))
        del X1t
    log("wide_kernels", tolerance=WIDE_RTOL, f64_ops_per_s=PEAK_F64_OPS_PER_S, details=extra,
        records=records)
    return records


def scale_kernel_phase(torch, titanic, timer, dev="cuda", rows=1 << 20):
    """Phase 43: K-AC in every mode and K-AD against their plain versions.
    Returns the two main records (K-AC's fill mode, K-AD)."""
    from transmogrifai_tpu_torch.ops import layer as LY

    cols = titanic.titanic_data(rows, 43)
    n = len(cols["Age"])
    age = np.asarray(cols["Age"], np.float32)
    m = np.random.default_rng(43).random(n) > 0.2
    v = torch.from_numpy(np.where(m, age, 0.0).astype(np.float32)).to(dev)
    mt = torch.from_numpy(m).to(dev)
    mean, std = float(age[m].mean()), float(age[m].std())
    splits = torch.from_numpy(np.quantile(age[m], np.linspace(0, 1, 101))[1:-1]
                              .astype(np.float32)).to(dev)
    modes = {"fill": (mean, 1.0, {}), "standardize": (mean, std, {}),
             "scale_linear": (1.37, -0.291, {}), "scale_log": (1.0, 0.0, {}),
             "descale_linear": (1.37, -0.291, {}), "descale_exp": (1.0, 0.0, {}),
             "bucket": (0.0, 0.0, {"splits": splits})}
    library = {"fill": lambda: torch.where(mt, v, mean),
               "bucket": lambda: torch.bucketize(v, splits, right=True)}
    records, extra = [], {}
    for mode, (a, b, kw) in modes.items():
        x = v / 20.0 if mode == "descale_exp" else v
        fn = lambda: LY.numeric_scale(mode, x, mt, a, b, **kw)
        got, want = fn(), LY.numeric_scale_plain(mode, x, mt, a, b, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), f"numeric_scale {mode}: masks differ")
        if mode in ("scale_log", "descale_exp"):
            gap = float(((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)).max())
            check(gap <= SCALE_APPROX_RTOL, f"numeric_scale {mode}: {gap} relative")
        else:
            check(torch.equal(got[0], want[0]), f"numeric_scale {mode} differs from plain")
        ops = n * (11 if mode == "bucket" else 2)      # a binary search: ~log2(99) + 4
        bd, by = bound_ms(n * 5 + n * 5 + (splits.numel() * 4 if mode == "bucket" else 0), ops)
        row = {"max_abs_err": float((got[0] - want[0]).abs().max()), "ms": timer(fn),
               "plain_ms": timer(lambda: LY.numeric_scale_plain(mode, x, mt, a, b, **kw)),
               "bound_ms": bd, "bound_by": by,
               "library_ms": timer(library[mode]) if mode in library else None}
        extra[f"numeric_scale {mode}"] = row
        if mode == "fill":
            records.append(dict(name="numeric_scale", route="cuda",
                                source="transmogrifai_tpu_torch/csrc/fused_layer.cu",
                                replaces="transmogrifai_tpu/impl/feature/transformers.py:310",
                                **row))
    rng = np.random.default_rng(44)
    X = torch.from_numpy((rng.normal(size=(n, 24)) * 10).astype(np.float32)).to(dev)
    shift = torch.from_numpy(rng.normal(size=24).astype(np.float32)).to(dev)
    std24 = rng.uniform(0.5, 5, 24).astype(np.float32)
    rcp = torch.from_numpy((np.float32(1.0) / std24).astype(np.float32)).to(dev)
    std_t = torch.from_numpy(std24).to(dev)
    got = LY.column_affine(X, shift, rcp)
    want = LY.column_affine_plain(X, shift, rcp)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "column_affine differs from its plain version")
    bd, by = bound_ms(2 * n * 24 * 4 + 2 * 24 * 4, 2 * n * 24)
    row = {"max_abs_err": 0.0, "ms": timer(lambda: LY.column_affine(X, shift, rcp)),
           "plain_ms": timer(lambda: LY.column_affine_plain(X, shift, rcp)),
           "bound_ms": bd, "bound_by": by, "library_ms": None,
           "library_two_calls_ms": timer(lambda: (X - shift) / std_t)}
    extra["column_affine"] = row
    records.append(dict(name="column_affine", route="cuda",
                        source="transmogrifai_tpu_torch/csrc/fused_layer.cu",
                        replaces="transmogrifai_tpu/impl/feature/vectorizers.py:541",
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}))
    log("scale_kernels", rows=n, approx_rtol=SCALE_APPROX_RTOL, details=extra, records=records)
    return records


def overlapped_execute(plan, ds):
    """The overlapped design ``stream.execute`` replaced, kept to time
    against it: a prefetch thread slices and pins each chunk, the uploads
    go on a copy stream and the stages on a compute stream, two chunks in
    flight.  Returns the terminal columns as ``stream.execute`` does."""
    import queue
    import threading

    import torch
    from transmogrifai_tpu_torch.impl.feature._util import stage_device
    from transmogrifai_tpu_torch.workflow import stream

    device = stage_device(plan.stages[0].stage)
    n, C = len(ds), stream.CHUNK_ROWS
    los = list(range(0, n, C))
    program, outputs = stream.program_for(plan), stream._Outputs(plan, n, device)
    caller = torch.cuda.current_stream(device)
    copy_s, compute = torch.cuda.Stream(device), torch.cuda.Stream(device)
    copy_s.wait_stream(caller)
    compute.wait_stream(caller)
    ready = queue.Queue(maxsize=2)

    def pin(t):
        return t.pin_memory() if t.device.type == "cpu" else t

    def prefetch():
        try:
            for lo in los:
                args, _ = stream._host_chunk_args(plan, ds, lo, min(lo + C, n))
                ready.put((lo, {k: [pin(t) for t in v] if isinstance(v, list) else pin(v)
                                for k, v in args.items()}))
        except BaseException as e:  # noqa: BLE001 - raised again below
            ready.put((None, e))

    def up(t):
        d = t if t.device == device else t.to(device, non_blocking=True)
        d.record_stream(compute)
        return d

    worker = threading.Thread(target=prefetch, daemon=True)
    worker.start()
    inflight = []
    for _ in los:
        lo, host = ready.get()
        if lo is None:
            raise host
        with torch.cuda.stream(copy_s):
            dev_args = {k: [up(t) for t in v] if isinstance(v, list) else up(v)
                        for k, v in host.items()}
        uploaded = torch.cuda.Event()
        uploaded.record(copy_s)
        with torch.cuda.stream(compute):
            compute.wait_event(uploaded)
            outs = program(dev_args)
            for e in plan.stages:
                if e.terminal:
                    outputs.put(e.out_name, e.out_kind, outs[e.out_name], lo, min(lo + C, n))
            done = torch.cuda.Event()
            done.record(compute)
        inflight.append((done, host))   # the pinned chunk lives until its copies end
        del dev_args, outs
        if len(inflight) > 2:
            inflight.pop(0)[0].synchronize()
    for done, _ in inflight:
        done.synchronize()
    worker.join()
    caller.wait_stream(compute)
    for nm in outputs.on_device:
        outputs.vals[nm].record_stream(caller)
    return outputs.columns()


@contextlib.contextmanager
def executor(route):
    """``stream.execute`` as it is (``executor``) or the overlapped design
    above (``overlap``) for the calls inside."""
    from transmogrifai_tpu_torch.workflow import stream

    real = stream.execute
    if route == "overlap":
        stream.execute = overlapped_execute
    try:
        yield
    finally:
        stream.execute = real


def executor_turns(torch, fn, order=("executor", "overlap", "overlap", "executor")):
    """``fn``'s wall under each executor route, in turns: {route: [s, ...]}."""
    walls = {}
    for route in order:
        with executor(route):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.setdefault(route, []).append(time.perf_counter() - t)
    return walls


def bench_pipeline(rows, seed=0, head=50_000, dev="cuda"):
    """The JAX package's transform bench pipeline (``bench.py:212-251``) built
    from the port's stages on the card: (dataset, layers, the final
    column's name, the bytes one row of every stage's inputs and outputs
    takes on the device)."""
    import transmogrifai_tpu_torch.types as T
    from transmogrifai_tpu_torch import FeatureBuilder
    from transmogrifai_tpu_torch.columns import Dataset, NumericColumn
    from transmogrifai_tpu_torch.impl.feature.transformers import FillMissingWithMean
    from transmogrifai_tpu_torch.impl.feature.vectorizers import (
        RealVectorizer, StandardScalerVectorizer, VectorsCombiner)

    n_feat = 8
    rng = np.random.default_rng(seed)
    cols = {}
    for j in range(n_feat):
        v = rng.normal(size=rows).astype(np.float32)
        m = rng.random(rows) > 0.1
        cols[f"x{j}"] = NumericColumn(T.Real, np.where(m, v, np.float32(0.0)), m)
    ds = Dataset(cols)
    fit = Dataset({k: NumericColumn(c.ftype, c.values[:head], c.mask[:head])
                   for k, c in cols.items()})
    xs = [FeatureBuilder(f"x{j}", T.Real).extract(field=f"x{j}").as_predictor()
          for j in range(n_feat)]
    fm = FillMissingWithMean().set_input(xs[0]).fit(fit).to(dev)
    m1 = RealVectorizer().set_input(*xs[:4]).fit(fit).to(dev)
    m2 = RealVectorizer(fill_with_mean=False, fill_value=-1.0).set_input(*xs[4:]).fit(fit) \
        .to(dev)
    comb = VectorsCombiner().set_input(m1.get_output(), m2.get_output()).to(dev)
    for t in (fm, m1, m2, comb):
        fit = fit.with_column(t.get_output().name, t.transform_dataset(fit))
    sm = StandardScalerVectorizer().set_input(comb.get_output()).fit(fit).to(dev)
    # inputs 8 x (value + mask), the fill, the two vectorizers' stacked
    # inputs and outputs (4 x 2 columns each), the combiner, the scaler
    row_bytes = 8 * 5 + 5 + 2 * (4 * 5 + 8 * 4) + 16 * 4 + 16 * 4
    return ds, [[fm, m1, m2], [comb], [sm]], sm.get_output().name, row_bytes


def stream_phase(torch, args, dev="cuda"):
    """Phase 44: the bench pipeline at 2^22 rows, streamed, through the
    overlapped design (``overlapped_execute``) and on the layer path: a
    first turn of each for the outputs and peak memory, then five timed
    turns.  Returns K-AD's launches in the first streamed run."""
    from transmogrifai_tpu_torch.ops import layer as LY
    from transmogrifai_tpu_torch.workflow import dag, stream

    rows = args.stream_rows
    ds, layers, final, row_bytes = bench_pipeline(rows, args.seed, head=min(50_000, rows),
                                                  dev=dev)
    def run(route):
        if route == "layer":
            res = ds
            for layer in layers:
                res = dag._apply_layer_transforms(res, layer)
        else:
            with executor(route):
                res = stream.apply_streamed(ds, layers)
            check(res is not None, "the bench pipeline did not stream")
        return res[final].values

    # a first turn of each route: its output, peak device memory, counters
    out = {}
    for route in ("stream", "overlap", "layer"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stream.reset_stream_stats()
        zero_launches((LY.column_affine,))
        X = run(route)
        torch.cuda.synchronize()
        out[route] = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
                      "stats": stream.stream_stats(), "launches": LY.column_affine.launches,
                      "X": X.cpu() if X.device.type != "cpu" else X}
        del X
    a, b = out["stream"].pop("X"), out["layer"].pop("X")
    check(torch.equal(a, b), "the streamed and layer-path outputs differ")
    check(torch.equal(out["overlap"].pop("X"), b), "the overlapped design's output differs")
    width = int(a.shape[1])
    del a, b
    # then timed turns, each output dropped so that the next run reuses its
    # pinned host memory
    walls = {}
    for _ in range(5):
        for route in ("stream", "overlap", "layer"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            X = run(route)
            torch.cuda.synchronize()
            walls.setdefault(route, []).append(time.perf_counter() - t)
            del X
    # the chunk being run and the next one's inputs
    window = 2 * stream.CHUNK_ROWS * row_bytes
    layer_bytes = rows * row_bytes
    peak = out["stream"]["peak_bytes"]
    check(peak <= 2 * window, f"streamed peak {peak} B above twice the chunk window {window} B")
    st = out["stream"]["stats"]
    log("stream", rows=rows, width=width, chunk_rows=stream.CHUNK_ROWS,
        walls_s=walls, median_s={r: statistics.median(w) for r, w in walls.items()},
        chunks=st["chunks"], bytes_in=st["bytes_in"],
        bytes_out=st["bytes_out"], transfer_wait_s=st["transfer_wait_s"],
        prep_s=st["prep_s"], stream_peak_bytes=peak,
        overlap_peak_bytes=out["overlap"]["peak_bytes"],
        layer_peak_bytes=out["layer"]["peak_bytes"],
        layer_bytes=layer_bytes, chunk_window_bytes=window, row_bytes=row_bytes,
        column_affine_launches=out["stream"]["launches"])
    check(out["stream"]["launches"] > 0, "the streamed run did not launch K-AD")
    return out["stream"]["launches"]


def simple_phases(torch, titanic, FX, args, timer, dev="cuda"):
    """Phases 45-47: OpTitanicSimple on the card.  Returns K-AC's launches
    on the streamed train."""
    import tempfile

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import layer as LY
    from transmogrifai_tpu_torch.ops import trees as Tr
    from transmogrifai_tpu_torch.ops import vectorize as V
    from transmogrifai_tpu_torch.workflow import stream

    # 45. the fixture's train and the JAX-saved model's answers
    t = time.perf_counter()
    model, _ = titanic.train_titanic(device=dev, reference_features=True)
    wall = time.perf_counter() - t
    found = FX.check_titanic_simple_train(model)
    fixture = P.load_model(FX.TITANIC_SIMPLE, device=dev)
    req = FX.load_columns(FX.TITANIC_SIMPLE + "/requests.npz")
    pred, prob, _ = FX.prediction_arrays(P.BatchScoreFunction(fixture)(FX.records(req)),
                                         fixture.result_features[0].name)
    answers = FX.compare_text_answers(FX.load_expected(FX.TITANIC_SIMPLE + "/expected.npz"),
                                      pred, prob, max(FX.SIMPLE_PROB_ATOL, FX.PROB_ATOL))
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        again = P.load_model(tmp, device=dev).score(titanic.titanic_data(300, 5))
    check(len(again) == 300, "the saved OpTitanicSimple model does not score")
    log("simple_reference", wall_s=wall, **found, fixture_answers=answers)

    # 46. the streamed train at --train-rows
    kernels = (LY.numeric_scale, LY.numeric_op, LY.column_gather, V.fill_indicator,
               V.one_hot_codes, Tr.bin_rows)
    stream.reset_stream_stats()
    launches, _, _ = scale_train_phase(
        torch, "simple_train",
        lambda: titanic.train_titanic(titanic.titanic_data(args.train_rows, args.seed),
                                      device=dev, reference_features=True),
        kernels, ("numeric_scale", "numeric_op", "column_gather", "fill_indicator",
                  "one_hot_codes"),
        lambda m: {"candidates": len(m.stages[-1].summary.validation_results)})
    st = stream.stream_stats()
    check(st["streams"] > 0 and st["chunks"] >= st["streams"], "the train did not stream")
    turns = executor_turns(torch, lambda: titanic.train_titanic(
        titanic.titanic_data(args.train_rows, args.seed), device=dev, reference_features=True),
        order=("overlap", "executor"))
    log("simple_train_stream", **{k: v for k, v in st.items()},
        numeric_scale_by_mode=dict(LY.numeric_scale.launches_by_mode),
        train_s_by_executor=turns)

    # 47. the big score and the request p50
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.selector import defaults as D

    trained, _ = titanic.train_titanic(
        titanic.titanic_data(args.train_rows, args.seed), device=dev, reference_features=True,
        models_and_parameters=[(OpLogisticRegression(),
                                D.grid(reg_param=[0.01], elastic_net_param=[0.1]))])
    cols = titanic.titanic_data(args.rows, args.seed + 1)
    stream.reset_stream_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    scored = trained.score(cols)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t
    pc = scored[trained.result_features[0].name]
    check(pc.probability.shape == (args.rows, 2) and np.isfinite(pc.probability).all(),
          "bad OpTitanicSimple scores")
    st = stream.stream_stats()
    peak = torch.cuda.max_memory_allocated()
    check(st["streams"] == 1, "the scoring DAG did not stream")
    turns = executor_turns(torch, lambda: trained.score(cols))
    recs = FX.records(titanic.titanic_data(max(BATCH_SIZES), args.seed + 2))
    fn = P.BatchScoreFunction(trained)
    p50 = {}
    for size in BATCH_SIZES:
        times = []
        for _ in range(args.reps):
            t = time.perf_counter()
            out = fn(recs[:size])
            times.append((time.perf_counter() - t) * 1e3)
            check(len(out) == size, "missing answers")
        p50[size] = statistics.median(times)
    log("simple_score", rows=args.rows, score_s=score_s, rows_per_s=args.rows / score_s,
        chunks=st["chunks"], bytes_in=st["bytes_in"], bytes_out=st["bytes_out"],
        transfer_wait_s=st["transfer_wait_s"], peak_bytes=peak, p50_ms_by_batch=p50,
        score_s_by_executor=turns)
    return launches["numeric_scale"]


def slice11_phases(torch, titanic, FX, args, timer, dev="cuda"):
    """Phases 41-47.  Returns (the records, their launches on their main
    paths)."""
    wide_launches = wide_reference_phase(torch, titanic, FX, dev)
    records = wide_kernel_phase(torch, timer, dev)
    records += scale_kernel_phase(torch, titanic, timer, dev)
    affine_launches = stream_phase(torch, args, dev)
    scale_launches = simple_phases(torch, titanic, FX, args, timer, dev)
    return records, dict(wide_launches, numeric_scale=scale_launches,
                         column_affine=affine_launches)

# ---------------------------------------------------------------------------
# slice 12: round-collapsed boosting (the collapse modes of K-H and K-R), the
# selectors' branches, the logistic grid sweep (K-AE)
# ---------------------------------------------------------------------------
#: the collapse modes' gradients against their plain versions on the card:
#: the same float32 operations, libdevice's expf in both (logistic: the
#: host's expf in the plain version may differ by an ulp); 2 ulp of 1
COLLAPSE_GRAD_ATOL = 2 * BOOST_GRAD_ATOL
#: the l2 grid of the logistic sweep phase
SWEEP_L2 = (0.0, 0.001, 0.01, 0.05, 0.1, 0.2, 0.5, 1.0)


@contextlib.contextmanager
def round_collapse(k):
    """``TMOG_GBT_ROUND_COLLAPSE`` (the boosted models' default collapse
    factor) set to ``k`` inside the block, unset for None; restored after."""
    import os

    old = os.environ.pop("TMOG_GBT_ROUND_COLLAPSE", None)
    if k is not None:
        os.environ["TMOG_GBT_ROUND_COLLAPSE"] = str(k)
    try:
        yield
    finally:
        os.environ.pop("TMOG_GBT_ROUND_COLLAPSE", None)
        if old is not None:
            os.environ["TMOG_GBT_ROUND_COLLAPSE"] = old


def collapse_spaces():
    """The slice's spaces (fresh estimators each call): the collapsed
    XGB-only Titanic space of ``fixtures/titanic_collapse``, the Iris XGB
    space at K = 4, and the binary selector's stock space."""
    from transmogrifai_tpu_torch.impl.classification.logistic import OpLogisticRegression
    from transmogrifai_tpu_torch.impl.classification.trees import (OpRandomForestClassifier,
                                                                   OpXGBoostClassifier)
    from transmogrifai_tpu_torch.impl.selector import defaults as D

    return {
        "titanic_xgb": [(OpXGBoostClassifier(trees_per_round=4, subsample=0.8,
                                             colsample_bytree=0.8), D.xgboost_grid())],
        "iris_xgb": [(OpXGBoostClassifier(trees_per_round=4), D.xgboost_grid())],
        "stock": [(OpLogisticRegression(max_iter=50), D.logistic_regression_grid()),
                  (OpRandomForestClassifier(), D.random_forest_grid()),
                  (OpXGBoostClassifier(), D.xgboost_grid())],
    }


def collapse_reference_phase(torch, titanic, iris, boston, FX, dev="cuda"):
    """Phase 48: the collapsed trains on the reference frames against the
    fixtures (the Titanic stock space under K = 4, the collapsed XGB-only
    space with draws at 0.8, Iris XGB at K = 4, Boston's stock space under
    K = 4), the JAX-saved collapsed model's 256 answers, and the port-saved
    winner served."""
    import tempfile

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.ops import sweep as S

    out = {}
    with round_collapse(4):
        (stock, wf), wall, calls = timed_train(torch, lambda: titanic.train_titanic(device=dev))
    chain = S.gbt_chain(calls[0][0].spec)
    check(chain == {"steps": 50, "levels": 500}, f"the stock XGB chain at K = 4 is {chain}")
    summ = stock.stages[-1].summary
    out["titanic_stock"] = {"wall_s": wall, "gbt_chain": chain, "best": summ.best_model_name,
                            "best_grid": summ.best_grid,
                            "fold_aupr_max_gap": FX.check_titanic_collapse_train(stock, "stock"),
                            "timings_s": wf.train_timings}
    with round_collapse(None):
        (xgb, xwf), xwall, _ = timed_train(torch, lambda: titanic.train_titanic(
            device=dev, models_and_parameters=collapse_spaces()["titanic_xgb"]))
    gaps = FX.check_titanic_collapse_train(xgb, "xgb")
    params = xgb.stages[-1].model_params
    eta = float(xgb.stages[-1].summary.best_grid.get("eta", 0.3))
    check(abs(float(params["eta"]) - eta / 4) <= 1e-7 * eta,
          f"the collapsed refit stores eta {params['eta']}, not {eta} / 4")
    req = FX.load_columns(FX.TITANIC_COLLAPSE + "/requests.npz")
    exp = FX.load_expected(FX.TITANIC_COLLAPSE + "/expected.npz")
    pred, prob, raw, Xb, F = FX.port_answers(P.load_model(FX.TITANIC_COLLAPSE, device=dev), req)
    fixture_gaps = FX.compare(exp, pred, prob, raw, Xb=Xb, F=F)
    off = np.abs(np.asarray(exp["F"], np.float64)[:, 0]) >= FX.BOUNDARY
    with tempfile.TemporaryDirectory() as tmp:
        xgb.save(tmp)
        pred, prob, raw, Xb, F = FX.port_answers(P.load_model(tmp, device=dev), req)
    out["titanic_xgb"] = {
        "wall_s": xwall, "best_grid": xgb.stages[-1].summary.best_grid, "fold_aupr_max_gap": gaps,
        "stored_eta": float(params["eta"]), "fixture_model_vs_expected": fixture_gaps,
        "port_saved_model_vs_expected": {
            "prediction_mismatches_off_boundary": int(np.sum(pred[off] != exp["prediction"][off])),
            "probability_max_abs_err": float(np.max(np.abs(prob - exp["probability"]))),
            "margin_max_abs_err": float(np.max(np.abs(F - exp["F"])))},
        "timings_s": xwf.train_timings}
    with round_collapse(None):
        (im, iwf), iwall, _ = timed_train(torch, lambda: iris.train_iris(
            device=dev, models_and_parameters=collapse_spaces()["iris_xgb"]))
    out["iris_xgb"] = {"wall_s": iwall, **FX.check_iris_collapse_train(im),
                       "fold_errors_bit_equal": True,
                       "best_grid": im.stages[-1].summary.best_grid}
    with round_collapse(4):
        (bm, bwf), bwall, _ = timed_train(torch, lambda: boston.train_boston(device=dev))
    out["boston_stock"] = {"wall_s": bwall, "fold_rmse_max_rel_gap": FX.check_boston_collapse_train(bm),
                           "best": bm.stages[-1].summary.best_model_name,
                           "best_grid": bm.stages[-1].summary.best_grid}
    log("collapse_reference", **out)


def collapse_train_phase(torch, titanic, iris, boston, args, dev="cuda"):
    """Phase 49: the Titanic stock train on ``--train-rows`` rows at K = 4
    and K = 1 in turn (walls, grower level counts, the device's idle share
    by a profiled second run, peak device memory), then Iris XGB and
    Boston's stock space at K = 4 on ``--train-rows`` rows.  Each collapse
    mode's launch count is reset just before its train and read just after.
    Returns (the collapse modes' launches, each train's first sweep call)."""
    from transmogrifai_tpu_torch.ops import sweep as S
    from transmogrifai_tpu_torch.ops import trees as Tr

    kernels = (Tr.boost_step, Tr.softmax_boost_step, Tr.level_hist, Tr.split_scan,
               Tr.route_rows)

    def reset():
        zero_launches(kernels)
        Tr.boost_step.collapse_launches = Tr.softmax_boost_step.collapse_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    cols = titanic.titanic_data(args.train_rows, args.seed)
    runs, calls = {}, {}
    for k in (4, 1):
        reset()
        with round_collapse(k):
            (model, wf), wall, rec = timed_train(torch, lambda: titanic.train_titanic(
                cols, device=dev))
            peak = torch.cuda.max_memory_allocated()
            launches = {fn.__name__: fn.launches for fn in kernels}
            launches["boost_step_collapse"] = Tr.boost_step.collapse_launches
            prof_wall, busy_s, idle, by_kernel = profiled(
                torch, lambda: titanic.train_titanic(cols, device=dev))
        summ = model.stages[-1].summary
        folds = [m for r in summ.validation_results for m in r["foldMetrics"]]
        check(len(folds) == 84 and all(np.isfinite(folds)) and min(folds) > 0.5,
              f"bad fold AuPR at K = {k}: {folds}")
        runs[f"K{k}"] = {
            "wall_s": wall, "gbt_chain": S.gbt_chain(rec[0][0].spec), "launches": launches,
            "peak_device_bytes": int(peak), "profiled_train_s": prof_wall,
            "device_busy_s": busy_s, "device_idle_share": idle, "device_s_by_kernel": by_kernel,
            "best": summ.best_model_name, "best_grid": summ.best_grid,
            "xgb_fold_aupr": [r["foldMetrics"] for r in summ.validation_results
                              if r["modelName"] == "OpXGBoostClassifier"],
            "host_clock_s": dict(wf.train_timings)}
        if k == 4:
            calls["logistic"] = rec[0]
    check(runs["K4"]["launches"]["boost_step_collapse"] > 0
          and runs["K1"]["launches"]["boost_step_collapse"] == 0,
          "the collapse mode of K-H ran where it should not, or not where it should")
    check(runs["K4"]["gbt_chain"]["levels"] * 4 == runs["K1"]["gbt_chain"]["levels"],
          f"grower levels {runs['K4']['gbt_chain']} against {runs['K1']['gbt_chain']}")
    launches = {"boost_step_collapse": runs["K4"]["launches"]["boost_step_collapse"]}
    reset()
    with round_collapse(None):
        (im, _), iwall, rec = timed_train(torch, lambda: iris.train_iris(
            iris.iris_data(args.train_rows, args.seed), device=dev,
            models_and_parameters=collapse_spaces()["iris_xgb"]))
    launches["softmax_boost_step_collapse"] = Tr.softmax_boost_step.collapse_launches
    calls["softmax"] = rec[0]
    ifolds = [m for r in im.stages[-1].summary.validation_results for m in r["foldMetrics"]]
    check(all(np.isfinite(ifolds)) and max(ifolds) < 0.5, f"bad Iris fold Errors {ifolds}")
    reset()
    with round_collapse(4):
        (bm, _), bwall, rec = timed_train(torch, lambda: boston.train_boston(
            boston.boston_data(args.train_rows, args.seed), device=dev))
    launches["boost_step_collapse_squared"] = Tr.boost_step.collapse_launches
    calls["squared"] = rec[0]
    bfolds = [m for r in bm.stages[-1].summary.validation_results for m in r["foldMetrics"]]
    check(all(np.isfinite(bfolds)) and min(bfolds) > 0, f"bad Boston fold RMSE {bfolds}")
    missing = [k for k, v in launches.items() if v <= 0]
    check(not missing, f"collapse modes not launched on their paths: {missing}")
    log("collapse_train", rows=args.train_rows, titanic_stock=runs, iris_xgb_k4_wall_s=iwall,
        iris_fold_errors=ifolds, boston_stock_k4_wall_s=bwall,
        boston_best=bm.stages[-1].summary.best_model_name, launches=launches)
    return launches, calls


def collapse_step_inputs(torch, call, dev="cuda"):
    """The real inputs of a collapsed step of a sweep call's first collapsed
    gbt group: step 0's gradients (the collapse mode without an update) and
    its B K trees grown, then step 1's subsample rows.  Returns (loss, c,
    F, y, w, eta, leaf, row_node, rw, B, K)."""
    from transmogrifai_tpu_torch.ops import trees as Tr

    plan, train_w = call[0], call[1]
    frag, group = next((f, g) for f in plan.spec[1] if f[0] == "gbt" for g in f[3] if g[11] > 1)
    loss, c = frag[1], frag[2]
    (cis, rounds, depth, xb_idx, n_bins, subsample, colsample, seed, frontier, exact,
     fold_base, K, off_eta, off_lam, off_gam, off_mcw, off_mig) = group
    y, blob = plan.y, np.asarray(plan.blob, np.float32)
    tw = torch.as_tensor(np.asarray(train_w, np.float32), device=dev)
    Xb = plan.xbs[xb_idx]
    n, d = Xb.shape
    F, Gc = tw.shape[0], len(cis)
    B = F * Gc
    w_b = tw.repeat_interleave(Gc, dim=0).contiguous()
    hp = lambda off: torch.as_tensor(np.tile(blob[off:off + Gc], F), device=dev)  # noqa: E731
    eta = hp(off_eta)
    params = torch.stack([torch.clamp_min(hp(off_lam), 1e-6), hp(off_gam), hp(off_mcw),
                          hp(off_mig)], 1).repeat_interleave(K, dim=0)
    ks, kf = Tr.rng_keys(seed)
    rw = Tr.subsample_weights(ks, n, rounds, subsample, dev)
    fms = Tr.feature_masks(kf, d, rounds, colsample, dev)
    base = ((y[None] * tw).sum(1) / torch.clamp_min(tw.sum(1), 1e-12) if fold_base
            else torch.zeros(F, device=dev)).repeat_interleave(Gc)
    Fm = base[:, None].expand(B, n) if loss != "softmax" else base[:, None, None].expand(B, n, c)
    Fm = Fm.contiguous()
    ghw = torch.empty((B * K, n, c + 1), device=dev)
    step = Tr.softmax_boost_step if loss == "softmax" else (
        lambda *a: Tr.boost_step(*a[:7], loss, a[7]))
    step(Fm, y, w_b, eta, None, None, ghw, rw[:K].contiguous())
    fm0 = fms[:K][None].expand(B, -1, -1).reshape(B * K, d).contiguous()
    _, leaf, row_node = Tr.grow_trees(Xb, ghw, fm0, params, depth, n_bins, frontier, exact)
    return loss, c, Fm, y, w_b, eta, leaf, row_node, rw[K:2 * K].contiguous(), B, K


def collapse_kernel_phase(torch, calls, timer, dev="cuda"):
    """Phase 50: the collapse modes of K-H (logistic: the Titanic stock
    train's XGB group at K = 4; squared: the Boston train's GBT group) and
    K-R (the Iris XGB group) against their plain versions on a collapsed
    step of their trains' real inputs, with time, bound and plain time."""
    from transmogrifai_tpu_torch.ops import trees as Tr

    records, extra = [], {}
    for name, key in (("boost_step_collapse", "logistic"),
                      ("boost_step_collapse_squared", "squared"),
                      ("softmax_boost_step_collapse", "softmax")):
        loss, c, Fm, y, w, eta, leaf, row_node, rw, B, K = collapse_step_inputs(
            torch, calls[key], dev)
        n = y.shape[0]
        F1, F2 = Fm.clone(), Fm.clone()
        g1 = torch.empty((B * K, n, c + 1), device=dev)
        g2 = torch.empty_like(g1)
        if loss == "softmax":
            run = lambda: Tr.softmax_boost_step(F1, y, w, eta, leaf, row_node, g1, rw)  # noqa
            plain = lambda: Tr.softmax_boost_step_plain(F2, y, w, eta, leaf, row_node, g2, rw)  # noqa
        else:
            run = lambda: Tr.boost_step(F1, y, w, eta, leaf, row_node, g1, loss, rw)  # noqa
            plain = lambda: Tr.boost_step_plain(F2, y, w, eta, leaf, row_node, g2, loss, rw)  # noqa
        run()
        plain()
        torch.cuda.synchronize()
        check(torch.equal(F1, F2), f"{name}: margins differ from plain")
        err = float((g1 - g2).abs().max())
        check(err <= (0.0 if loss == "squared" else COLLAPSE_GRAD_ATOL),
              f"{name}: gradients {err} from plain")
        P_ = leaf.shape[1]
        # per (element, row): F read and written (c floats each way), w read;
        # per (tree, row): its node read, c + 1 gradients written; y and the
        # K subsample rows once; the leaf pools once (the gathered leaf rows
        # come from them, as in K-R's bound).  Operations: the K-term sums
        # and the update (2 K c), ~30 a channel for the gradients, 2 (c + 1)
        # a tree for the weighting
        b, by = bound_ms(B * n * (8 * c + 4) + B * K * n * (4 + 4 * (c + 1))
                         + n * 4 * (1 + K) + B * K * P_ * c * 4,
                         B * n * (2 * K * c + 30 * c + 2 * K * (c + 1)))
        ms = timer(run)
        plain_ms = timer(plain)
        records.append(dict(
            name=name, route="triton", source="transmogrifai_tpu_torch/ops/triton_boost.py",
            replaces=("transmogrifai_tpu/ops/trees.py:1181" if key != "softmax"
                      else "transmogrifai_tpu/ops/trees.py:1327"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=None))
        extra[name] = {"B": B, "K": K, "n": n, "c": c, "pool": P_}
        del F1, F2, g1, g2, leaf, row_node
    log("collapse_kernels", shapes=extra,
        **{r["name"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "max_abs_err")} for r in records})
    return records


def branches_reference_phase(torch, titanic, FX, dev="cuda"):
    """Phase 51: the Titanic flow over the stock space under the multiclass
    selector (a two-class label) and under the binary selector's
    train/validation split, on the 891-row frame, held to
    ``fixtures/titanic_branches``; the calibration, log-loss and forecast
    evaluators on each train's scores of the frame."""
    from transmogrifai_tpu_torch import evaluators as E
    from transmogrifai_tpu_torch.ops import metrics as M

    out = {}
    cols = titanic.titanic_data()
    y = np.asarray(cols["Survived"], np.float64)
    for sel in ("multiclass", "split"):
        zero_launches((M.multiclass_metrics, M.binary_metrics))
        with round_collapse(None), SweepCalls() as rec:
            t = time.perf_counter()
            model, wf = titanic.train_titanic(device=dev, selector=sel,
                                              models_and_parameters=collapse_spaces()["stock"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        metrics = np.stack([np.asarray(c[3]) for c in rec.calls])
        gaps = FX.check_titanic_branches_train(
            model, sel, metrics, (np.asarray(rec.calls[0][1]), np.asarray(rec.calls[0][2])))
        launches = {"multiclass_metrics": M.multiclass_metrics.launches,
                    "binary_metrics": M.binary_metrics.launches}
        check(launches["multiclass_metrics" if sel == "multiclass" else "binary_metrics"] > 0,
              f"the {sel} train's metrics kernel did not launch")
        scored = model.score(cols)[model.result_features[0].name]
        prob = np.asarray(scored.probability, np.float64)
        evals = {"BrierScore": E.OpBinScoreEvaluator().evaluate_arrays(
                     y, scored.prediction, prob)["BrierScore"],
                 "LogLoss": E.OpLogLoss().evaluate_arrays(y, scored.prediction, prob)["LogLoss"],
                 "SMAPE": E.OpForecastEvaluator().evaluate_arrays(y, prob[:, 1])["SMAPE"]}
        check(all(np.isfinite(v) for v in evals.values()), f"evaluators {evals}")
        summ = model.stages[-1].summary
        out[sel] = {"wall_s": wall, "best": summ.best_model_name, "best_grid": summ.best_grid,
                    "metric": summ.evaluation_metric, "fold_metric_max_gap": gaps,
                    "sweep_calls": len(rec.calls), "launches": launches, "evaluators": evals,
                    "timings_s": wf.train_timings}
    log("branches_reference", **out)


def logistic_sweep_phase(torch, call, timer, dev="cuda"):
    """Phase 52: ``sharded_logistic_sweep`` end to end (3 folds, the 8
    ``SWEEP_L2`` values) on the collapsed Titanic train's checked vector at
    ``--train-rows`` rows, K-AE's launches counted, then K-AE against its
    plain version on the sweep's own fits (rows whose float64 margin lies
    within float32 rounding of 0 may fall either way: counted and allowed),
    with ``torch.matmul`` of the margins alone as the library yardstick."""
    from transmogrifai_tpu_torch.parallel import sweep as PS

    plan = call[0]
    X, y = plan.X.contiguous(), plan.y.contiguous()
    n, d = X.shape
    l2 = np.asarray(SWEEP_L2, np.float32)
    Xn, yn = X.cpu().numpy(), y.cpu().numpy()
    PS.eval_logistic_grid_folds.launches = 0
    t = time.perf_counter()
    mean_err, coef, b = PS.sharded_logistic_sweep(Xn, yn, l2, n_folds=3, device=dev)
    wall = time.perf_counter() - t
    launches = PS.eval_logistic_grid_folds.launches
    check(launches > 0, "K-AE did not launch in sharded_logistic_sweep")
    check(np.all(np.isfinite(mean_err)) and mean_err.min() >= 0 and mean_err.max() < 0.5,
          f"bad mean errors {mean_err}")
    _, val_w = PS.make_fold_weights(n, 3, 42, yn)
    vw = torch.as_tensor(val_w, device=dev)
    cd, bd = torch.as_tensor(coef, device=dev), torch.as_tensor(b, device=dev)
    got = PS.eval_logistic_grid_folds(X, y, vw, cd, bd)
    want = PS.eval_logistic_grid_folds_plain(X, y, vw, cd, bd)
    z = torch.einsum("nd,fgd->fgn", X.double(), cd.double()) + bd.double()
    scale = torch.einsum("nd,fgd->fgn", X.double().abs(), cd.double().abs()) + bd.double().abs()
    near = ((z.abs() <= (d + 2) * 2.0 ** -23 * scale) * vw[:, None].double()).sum(-1)
    allowed = near / torch.clamp_min(vw.double().sum(-1), 1.0)[:, None]
    gap = (got.double() - want.double()).abs()
    check(bool((gap <= allowed + 1e-7).all()), f"K-AE {float(gap.max())} from plain beyond "
                                               f"the near-zero rows' {float(allowed.max())}")
    F_, G = cd.shape[:2]
    c2 = cd.reshape(F_ * G, d)
    b_, by = bound_ms(n * d * 4 + n * 4 + F_ * n * 4 + F_ * G * (d + 2) * 4,
                      2 * n * d * F_ * G)
    rec = dict(name="logistic_grid_error", route="cuda",
               source="transmogrifai_tpu_torch/csrc/logistic_eval.cu",
               replaces="transmogrifai_tpu/parallel/sweep.py:77", launches=launches,
               max_abs_err=float(gap.max()),
               ms=timer(lambda: PS.eval_logistic_grid_folds(X, y, vw, cd, bd)),
               plain_ms=timer(lambda: PS.eval_logistic_grid_folds_plain(X, y, vw, cd, bd)),
               bound_ms=b_, bound_by=by, library_ms=timer(lambda: torch.matmul(X, c2.T)))
    log("logistic_sweep", rows=n, features=d, folds=3, l2=list(SWEEP_L2), wall_s=wall,
        mean_val_error=mean_err.tolist(), launches=launches,
        near_zero_rows=int((z.abs() <= (d + 2) * 2.0 ** -23 * scale).sum()),
        **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "max_abs_err")})
    return rec


def slice12_phases(torch, titanic, iris, boston, FX, args, timer, dev="cuda"):
    """Phases 48-52.  Returns (the records, their launches on their main
    paths)."""
    collapse_reference_phase(torch, titanic, iris, boston, FX, dev)
    launches, calls = collapse_train_phase(torch, titanic, iris, boston, args, dev)
    records = collapse_kernel_phase(torch, calls, timer, dev)
    branches_reference_phase(torch, titanic, FX, dev)
    sweep_record = logistic_sweep_phase(torch, calls["logistic"], timer, dev)
    launches["logistic_grid_error"] = sweep_record.pop("launches")
    return records + [sweep_record], launches


# ---------------------------------------------------------------------------
# slice 13: the multiclass selector past 8 classes
# ---------------------------------------------------------------------------
#: the card-size trains of the Letter flow: (phase, classes, rows).  Each
#: takes the fused sweep: past the 2e9-byte score guard of all 26
#: candidates (26 classes at 2^17 rows), the validator cuts the candidates
#: into chunks whose scores fit ``FUSED_SCORES_BYTES``, each a fused call,
#: as the JAX package's does
MANY_TRAINS = (("letters26_fused_train", 26, 1 << 16),
               ("letters64_fused_train", 64, 1 << 15),
               ("letters26_chunked_train", 26, 1 << 17))
#: rows of the 100-class per-family train, held against the port's own CPU run
LETTERS100_ROWS = 400


def many_reference_phase(torch, FX, dev="cuda"):
    """Phase 53: the Letter flow against the JAX package's fixtures on the
    card: the 26-class stock train at ``FX.LETTERS_ROWS`` rows (winner, fold
    Errors, the fused call's metrics: ``FX.check_letters_train``), the
    JAX-saved 26-class model's 256 answers and the port-saved one's, each of
    ``FX.MANY_RUNS`` (the fused 26 / 64, the per-family 70, the 10-class
    boosting at ``trees_per_round`` 1 and 4 and the full XGBoost grid:
    ``FX.check_many_class_train``), and a 100-class per-family train against
    the same train on the CPU (the same winner and fold Errors)."""
    import tempfile

    import transmogrifai_tpu_torch as P

    out = {}
    wf, _ = FX.letters_workflow()
    (model, wall, calls) = timed_train(
        torch, lambda: wf.set_input_dataset(FX.letters_data(), key="id").train(device=dev))
    metrics = np.stack([np.asarray(c[3]) for c in calls])
    out["letters_stock"] = {"wall_s": wall, **FX.check_letters_train(model, metrics),
                            "best": model.stages[-1].summary.best_model_name,
                            "best_grid": model.stages[-1].summary.best_grid,
                            "timings_s": dict(wf.train_timings)}
    out["letters_fixture_model"] = FX.check_letters_answers(P.load_model(FX.LETTERS_STOCK,
                                                                         device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        cols = FX.load_columns(FX.LETTERS_STOCK + "/requests.npz")
        exp = FX.load_expected(FX.LETTERS_STOCK + "/expected.npz")
        pm = P.load_model(tmp, device=dev)
        name = pm.result_features[0].name
        pred, prob, _ = FX.multiclass_predictions(P.BatchScoreFunction(pm)(FX.records(cols)),
                                                  name, exp["probability"].shape[1])
    out["letters_port_saved_model"] = {
        "prediction_mismatches": int(np.sum(pred != exp["prediction"])),
        "probability_max_abs_err": float(np.max(np.abs(prob - exp["probability"])))}
    for run, (k, rows, space) in FX.MANY_RUNS.items():
        wf, _ = FX.letters_workflow(FX.port_many_run_space(space))
        (m, wall, calls) = timed_train(
            torch, lambda: wf.set_input_dataset(FX.letters_data(rows, k, 1), key="id")
            .train(device=dev))
        out[run] = {"wall_s": wall, **FX.check_many_class_train(m, run, [c[3] for c in calls])}
    runs = {}
    for where in (dev, "cpu"):
        wf, _ = FX.letters_workflow(FX.port_many_run_space("many"))
        t = time.perf_counter()
        m = wf.set_input_dataset(FX.letters_data(LETTERS100_ROWS, 100, 1), key="id") \
            .train(device=where)
        runs[str(where)] = (m.stages[-1].summary, time.perf_counter() - t)
    card, cpu = runs[str(dev)][0], runs["cpu"][0]
    fc = np.array([r["foldMetrics"] for r in card.validation_results])
    fp = np.array([r["foldMetrics"] for r in cpu.validation_results])
    check((card.best_model_name, card.best_grid) == (cpu.best_model_name, cpu.best_grid),
          "the 100-class winner differs between the card and the CPU")
    # the forests bit for bit; the softmax fits (K-P against its plain
    # version within float32 rounding) within FX.MANY_FLIP_ROWS rows of a
    # fold of at least LETTERS100_ROWS / 4 validation rows
    lr = np.array([r["modelName"] == "OpLogisticRegression" for r in card.validation_results])
    check(np.array_equal(fc[~lr], fp[~lr]) and np.all(
        np.abs(fc[lr] - fp[lr]) <= FX.MANY_FLIP_ROWS["OpLogisticRegression"]
        / (LETTERS100_ROWS // 4) + 1e-7),
          f"100-class fold Errors {fc.tolist()} against {fp.tolist()}")
    out["family100"] = {"card_s": runs[str(dev)][1], "cpu_s": runs["cpu"][1],
                        "classes": len(card.data_prep_results["labelsKept"]),
                        "best": card.best_model_name, "best_grid": card.best_grid}
    log("many_reference", **out)


def many_train_phase(torch, FX, kernels, dev="cuda"):
    """Phase 54: runs 1-3 of the Letter flow at the card's sizes (the stock
    space: 26 classes at 2^16 rows, 64 at 2^15, 26 at 2^17 in more candidate
    chunks of the fused sweep): each
    kernel's launches reset just before and read just after the train,
    wall, the profiled second run's busy time and idle share, peak device
    memory.  Returns ({phase: launches}, {phase: the first and the last sweep
    call})."""
    launches, calls = {}, {}
    for phase, k, rows in MANY_TRAINS:
        cols = FX.letters_data(rows, k, 0)

        def train():
            wf, _ = FX.letters_workflow()
            return wf.set_input_dataset(cols, key="id").train(device=dev), wf

        def check_fn(model, k=k):
            summ = model.stages[-1].summary
            folds = np.array([r["foldMetrics"] for r in summ.validation_results])
            check(len(folds) == 26 and np.isfinite(folds).all() and folds.min() >= 0.0
                  and folds.min() < 1.0 - 1.0 / k, f"bad fold Errors {folds.tolist()}")
            check(len(summ.data_prep_results["labelsKept"]) == k, "labels dropped")
            return {"best_mean_error": float(min(r["metricValue"]
                                                 for r in summ.validation_results)),
                    "holdout_error": summ.holdout_evaluation["Error"]}

        required = ["level_hist", "split_scan", "route_rows", "softmax_fista_grad",
                    "threefry_draws", "multiclass_metrics", "forest_leaf_mean"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches[phase], c, _ = scale_train_phase(torch, phase, train, kernels, required,
                                                  check_fn)
        log(phase + "_memory", rows=rows, classes=k, sweep_calls=len(c),
            peak_device_bytes=int(torch.cuda.max_memory_allocated()))
        calls[phase] = (c[0], c[-1])  # the LR chunk; the deepest forests' chunk
    return launches, calls


#: K-R's gradients against plain past 8 classes: libdevice's expf against
#: the host's, as at k <= 8
MANY_BOOST_ROWS = 1 << 16


def many_extra_kernel_phase(torch, timer, plain_timer, dev="cuda"):
    """Phase 56: the changed kernels off the Letter flow's path, against
    their plain versions at the slice's shapes: K-R's step and collapse
    modes at 26 and 64 classes (6 fits, 2^16 rows, 63 leaves, K = 4), K-P's
    wide entry at 26 classes and p = 85 (12 fits, 2^17 rows), K-B's walk
    over a 26-class forest (50 trees of depth 12, 2^16 rows).  Logged, not
    in the ``kernels`` line (no launch on a main path)."""
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import trees as Tr

    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}
    n, B, P_, K = MANY_BOOST_ROWS, 6, 63, 4
    for k in (26, 64):
        F = t((rng.normal(size=(B, n, k)) * 2).astype(np.float32))
        y = t(rng.integers(0, k, n).astype(np.float32))
        w = t(rng.integers(0, 3, (B, n)).astype(np.float32))
        eta = t(rng.random(B).astype(np.float32))
        for mode, KK in (("step", 1), ("collapse", K)):
            leaf = t(rng.normal(size=(B * KK, P_, k)).astype(np.float32))
            node = t(rng.integers(0, P_, (B * KK, n)).astype(np.int32))
            rw = t((rng.random((KK, n)) < 0.8).astype(np.float32)) if KK > 1 else None
            F1, F2 = F.clone(), F.clone()
            g1 = torch.empty((B * KK, n, k + 1), device=dev)
            g2 = torch.empty_like(g1)
            run = lambda: Tr.softmax_boost_step(F1, y, w, eta, leaf, node, g1, rw)  # noqa
            plain = lambda: Tr.softmax_boost_step_plain(F2, y, w, eta, leaf, node, g2, rw)  # noqa
            run()
            plain()
            torch.cuda.synchronize()
            check(torch.equal(F1, F2), f"K-R {mode} at k = {k}: margins differ from plain")
            err = float((g1 - g2).abs().max())
            check(err <= COLLAPSE_GRAD_ATOL, f"K-R {mode} at k = {k}: gradients {err}")
            # F read and written, w and y read, the nodes read, the leaf pools
            # once, the gradient planes written; ~30 operations a channel and
            # 2 K a channel for the update
            b, by = bound_ms(B * n * (8 * k + 4) + B * KK * n * (4 + 4 * (k + 1))
                             + n * 4 * (1 + KK) + B * KK * P_ * k * 4,
                             B * n * (2 * KK * k + 30 * k + 2 * KK * (k + 1)))
            out[f"softmax_boost_step_{mode}_k{k}"] = {
                "ms": timer(run), "plain_ms": plain_timer(plain), "bound_ms": b, "bound_by": by,
                "max_abs_err": err, "shape": [B, KK, n, k]}
            del F1, F2, g1, g2, leaf, node
    # K-P's wide entry at p = 85, 26 classes
    n, p, k, C, Fo = 1 << 17, 85, 26, 12, 3
    X1 = rng.normal(size=(n, p)).astype(np.float32)
    X1[:, -1] = 1.0
    l2m = np.full((C, p, k), 0.01, np.float32)
    l2m[:, -1] = 0.0
    w = rng.integers(0, 3, (Fo, n)).astype(np.float32)
    fold = (np.arange(C) % Fo).astype(np.int32)
    args = [t(a) for a in (X1, rng.integers(0, k, n).astype(np.float32), w, fold,
                            (0.1 * rng.normal(size=(C, p, k))).astype(np.float32), l2m,
                            np.maximum(w.sum(1), 1.0)[fold].astype(np.float32))]
    got, want = L.softmax_fista_grad(*args), L.softmax_fista_grad_plain(*args)
    err = float((got - want).abs().max())
    check(err <= SOFTMAX_GRAD_RTOL * float(want.abs().max()), f"K-P wide at k = 26: {err}")
    b, by = bound_ms((n * p + Fo * n + n) * 4 + C * p * k * 12 + C * 4,
                     C * n * (4 * p * k + 6 * k))
    library = softmax_library(torch, *args)
    check(float((library() - got).abs().max()) <= 1e-5 * float(want.abs().max()),
          "the wide K-P's library yardstick computes another function")
    out["softmax_fista_grad_wide_k26"] = {
        "ms": timer(lambda: L.softmax_fista_grad(*args)),
        "plain_ms": plain_timer(lambda: L.softmax_fista_grad_plain(*args)),
        "library_ms": timer(library),
        "bound_ms": b, "bound_by": by, "max_abs_err": err, "shape": [n, p, k, C]}
    del args, got, want, library
    # K-B over a 26-class forest
    n, d, Bn, T, depth, k = 1 << 16, 32, 32, 50, 12, 26
    Xb = t(rng.integers(0, Bn, (n, d)).astype(np.int8))
    g = t(-np.eye(k, dtype=np.float32)[rng.integers(0, k, n)])
    wt = t(rng.poisson(1.0, (T, n)).astype(np.float32))
    fm = t((rng.random((T, d)) < 0.2).astype(np.float32))
    hp = [np.full(T, v, np.float32) for v in (1e-6, 0.0, 10.0, 0.001)]
    tree = Tr.grow_forest(Xb, g, torch.ones(n, device=dev), wt, fm, depth, Bn, 64, *hp)
    got = Tr.ensemble_walk(Xb, tree, depth, "mean")[0]
    want = Tr.ensemble_walk_plain(Xb, tree, depth, "mean")[0]
    err = float((got - want).abs().max())
    check(err <= 1e-5, f"K-B over 26 classes: {err}")
    b, by = bound_ms(n * d + n * k * 4 + tree.leaf_val.numel() * 4, n * T * depth * 4)
    out["ensemble_walk_c26"] = {
        "ms": timer(lambda: Tr.ensemble_walk(Xb, tree, depth, "mean")),
        "plain_ms": plain_timer(lambda: Tr.ensemble_walk_plain(Xb, tree, depth, "mean")),
        "bound_ms": b, "bound_by": by, "max_abs_err": err, "shape": [n, T, depth, k]}
    log("many_extra_kernels", **out)
    return out


def slice13_phases(torch, FX, timer, dev="cuda"):
    """Phases 53-56.  Returns (the records, their launches on their main
    paths)."""
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import threefry as R
    from transmogrifai_tpu_torch.ops import trees as Tr

    many_reference_phase(torch, FX, dev)
    kernels = (Tr.bin_rows, Tr.level_hist, Tr.split_scan, Tr.route_rows, Tr.forest_leaf_mean,
               L.softmax_fista_grad, M.multiclass_metrics, R.threefry_draws)
    launches, calls = many_train_phase(torch, FX, kernels, dev)
    plain_timer = Timer(torch, 5)
    records, by_name = [], {}
    for phase, k in (("letters26_fused_train", 26), ("letters64_fused_train", 64)):
        names = {"softmax_fista_grad": f"softmax_fista_grad_k{k}",
                 "multiclass_metrics": f"multiclass_metrics_k{k}",
                 "level_hist": f"level_hist_c{k}", "split_scan": f"split_scan_c{k}",
                 "forest_leaf_mean": f"forest_leaf_mean_c{k}"}
        recs = iris_kernel_phase(torch, calls[phase][0], timer, names, f"many_kernels_k{k}",
                                 plain_timer, tree_call=calls[phase][1])
        for base, name in names.items():
            by_name[name] = launches[phase][base]
        records += recs
    many_extra_kernel_phase(torch, timer, plain_timer, dev)
    return records, by_name


# ---------------------------------------------------------------------------
# slice 14: the tiled K-U, K-V, K-AA and K-AB past their old widths
# ---------------------------------------------------------------------------
#: the Letter families train's rows on the card
LETTERS_FAMILIES_ROWS = 1 << 16
#: the card-scale train whose winner is printed, not held to the fixture
#: size's: "embed" picks by mean AuPR among near-tied candidates whose
#: reference metrics move with the reference's own rounding, and no JAX
#: train of that size exists to hold it to (PERF.md section 7)
SCALE_WINNER_UNHELD = ("wide_text_embed",)


def wide_reference_phase14(torch, FX, titanic, dev="cuda"):
    """Phase 57: the three flows at fixture size on the card against the JAX
    package's fixtures: the candidates, the winner, the vector's width, the
    answers of the JAX-saved Letter winner and of the text flows' models on
    the fixture's rows, and every fold metric within its tolerance
    (``FX.LETTERS_FAMILIES_TOL`` / ``FX.WIDE_TEXT_TOL``) but for the one open
    gap ``FX.WIDE_TEXT_OPEN_GAP`` ("embed"'s MLP: the reference's own fold
    metric moves past its tolerance under a one-ulp change of one input, so
    its gap is printed beside the tolerance, not held)."""
    import transmogrifai_tpu_torch as P

    out = {}
    wf, _ = FX.letters_workflow(FX.port_letters_families_space())
    (model, wall, _) = timed_train(
        torch, lambda: wf.set_input_dataset(FX.letters_data(), key="id").train(device=dev))
    out["letters_families"] = {"wall_s": wall, **FX.check_letters_families_train(model)}
    out["letters_families_fixture_model"] = FX.check_letters_families_answers(
        P.load_model(FX.LETTERS_FAMILIES, device=dev))
    held = []
    for kind in FX.WIDE_FLOWS:
        wf, _ = FX.port_wide_text_workflow(kind)
        (model, wall, _) = timed_train(torch, lambda: wf.set_input_dataset(
            titanic.text_columns(), key="PassengerId").train(device=dev))
        found = FX.wide_text_gaps(model, kind)
        found["open"] = [fam for fam in found["beyond"] if (kind, fam) == FX.WIDE_TEXT_OPEN_GAP]
        out[f"wide_text_{kind}"] = {"wall_s": wall, **found}
        held += [f"{kind} {fam} {found['max_gap'][fam]} (tolerance {found['tolerance'][fam]})"
                 for fam in found["beyond"] if fam not in found["open"]]
    log("wide_reference", **out)
    check(not held, "wide_text fold metrics beyond their tolerance: " + ", ".join(held))
    return {k: v["best"] for k, v in out.items() if "best" in v}


def slice14_trains(torch, FX, titanic, args, kernels, fixture_best, dev="cuda"):
    """Phases 58-59: the Letter families flow at ``LETTERS_FAMILIES_ROWS``
    rows and the two wide text flows at ``--wide-text-rows`` rows, each a main
    path (launches, wall, busy time, idle share), the K-U / K-V / K-AA /
    K-AB inputs of each kept for phase 60.  Returns ({train: launches},
    {train: kept inputs})."""
    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB
    from transmogrifai_tpu_torch.impl.feature import embeddings as Emb
    from transmogrifai_tpu_torch.ops import mlp as M

    launches, keep = {}, {}

    def check_fn(name, k):
        def fn(model):
            summ = model.stages[-1].summary
            folds = np.array([r["foldMetrics"] for r in summ.validation_results])
            check(np.isfinite(folds).all(), f"{name}: non-finite fold metrics")
            best = [summ.best_model_name, summ.best_grid]
            same = FX.same_winner(best, fixture_best[name])
            check(same or name in SCALE_WINNER_UNHELD, f"{name}: winner {best}, the fixture-size "
                                                       f"winner is {fixture_best[name]}")
            ranked = sorted(summ.validation_results, key=lambda r: r["metricValue"],
                            reverse=k == 2)   # AuPR larger-better, Error smaller-better
            return {"classes": k, "best_mean_metric": float(ranked[0]["metricValue"]),
                    "runner_up": [ranked[1]["modelName"], ranked[1]["grid"],
                                  float(ranked[1]["metricValue"])],
                    "winner_as_at_fixture_size": same, "fixture_size_winner": fixture_best[name]}
        return fn

    cols = FX.letters_data(LETTERS_FAMILIES_ROWS, 26, 0)

    def letters():
        wf, _ = FX.letters_workflow(FX.port_letters_families_space())
        return wf.set_input_dataset(cols, key="id").train(device=dev), wf

    req = ("mlp_grad", "mlp_forward", "nb_tables_mass", "nb_tables_score")
    with AllCalls(M, "fit_mlp_grid_folds") as mlp, AllCalls(NB, "_nb_grid_z") as nb:
        launches["letters_families"], _, _ = scale_train_phase(
            torch, "letters_families_train", letters, kernels, req,
            check_fn("letters_families", 26), sweep=False)
    keep["letters_families"] = {"mlp": mlp.calls, "nb": nb.calls}
    del cols
    text = titanic.text_columns(args.wide_text_rows, args.seed)
    for kind in FX.WIDE_FLOWS:
        def train(kind=kind):
            wf, _ = FX.port_wide_text_workflow(kind)
            return wf.set_input_dataset(text, key="PassengerId").train(device=dev), wf

        req = ("lda_beta", "lda_estep", "lda_sstats", "mlp_grad", "mlp_forward") + (
            ("sgns_epoch",) if kind == "embed" else ("nb_tables_mass", "nb_tables_score"))
        with AllCalls(M, "fit_mlp_grid_folds") as mlp, AllCalls(NB, "_nb_grid_z") as nb, \
                FX.PortW2VArgs(Emb) as w2v, LastLdaFit() as lda:
            launches[f"wide_text_{kind}"], _, _ = scale_train_phase(
                torch, f"wide_text_{kind}_train", train, kernels, req,
                check_fn(f"wide_text_{kind}", 2), sweep=kind == "embed")
        keep[f"wide_text_{kind}"] = {"mlp": mlp.calls[:1], "nb": nb.calls[:1],
                                     "w2v": w2v.calls[-1] if w2v.calls else None,
                                     "lda": (lda.col, lda.topic_word)}
    return launches, keep


def mlp_record(torch, name, call, timer, plain_timer, dev="cuda"):
    """K-U (gradient mode, and forward mode as ``<name>`` with ``grad``
    replaced) on a ``fit_mlp_grid_folds`` call's inputs after ten Adam
    steps, against plain and ``torch.autograd.grad`` of the plain loss."""
    from transmogrifai_tpu_torch.ops import mlp as M

    (X, y, tw, lrs, seeds), kw = call[0][:5], call[1]
    layers = tuple(kw.get("layers", call[0][5] if len(call[0]) > 5 else None))
    F, n, d = tw.shape[0], X.shape[0], X.shape[1]
    params = M.fit_mlp_grid_folds(X, y, tw, lrs, seeds, layers=layers, max_iter=10)
    G = len(seeds)
    C = F * G
    flat = M.flatten(params).reshape(C, -1).contiguous()
    E = flat.shape[1]
    fold = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(G)
    wsum = torch.clamp_min(tw.sum(1), 1e-12)[fold.long()].contiguous()
    args = (X, y, tw, fold, wsum, flat, layers)
    g1, g2 = M.mlp_grad(*args), M.mlp_grad_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(g1, M.mlp_grad(*args)), f"{name} does not repeat")
    err = float((g1 - g2).abs().max() / g2.abs().max())
    check(err <= MLP_GRAD_RTOL, f"{name} {err} from plain, above {MLP_GRAD_RTOL}")
    k = layers[-1]
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    mw = tw[fold.long()]

    def autograd():
        leaf = flat.detach().requires_grad_(True)
        ll = torch.log_softmax(M.forward(M.unflatten(leaf, layers), X), dim=-1)
        loss = (-(mw[..., None] * Y * ll).sum((1, 2)) / wsum).sum()
        return torch.autograd.grad(loss, leaf)[0]

    macs = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    b, by = bound_ms((n * d + n + F * n) * 4 + 2 * C * E * 4, C * n * 6 * macs)
    grad = dict(name=name, route="cuda", source="transmogrifai_tpu_torch/csrc/mlp.cu",
                replaces="transmogrifai_tpu/ops/mlp.py:56", max_abs_err=float(
                    (g1 - g2).abs().max()), ms=timer(lambda: M.mlp_grad(*args)),
                plain_ms=plain_timer(lambda: M.mlp_grad_plain(*args)), bound_ms=b, bound_by=by,
                library_ms=timer(autograd))
    (z1, p1), (z2, p2) = M.mlp_forward(X, flat, layers), M.mlp_forward_plain(X, flat, layers)
    torch.cuda.synchronize()
    perr = float((p1 - p2).abs().max())
    check(perr <= MLP_PROB_ATOL, f"{name} forward: probabilities {perr} from plain")
    b, by = bound_ms(n * d * 4 + C * E * 4 + 2 * C * n * k * 4, C * n * (2 * macs + 4 * k))
    fwd = dict(name=name.replace("grad", "forward"), route="cuda",
               source="transmogrifai_tpu_torch/csrc/mlp.cu",
               replaces="transmogrifai_tpu/ops/mlp.py:108", max_abs_err=perr,
               ms=timer(lambda: M.mlp_forward(X, flat, layers)),
               plain_ms=plain_timer(lambda: M.mlp_forward_plain(X, flat, layers)),
               bound_ms=b, bound_by=by, library_ms=None)
    shape = {"layers": list(layers), "rows": n, "fits": C, "params": E,
             "entry": "gemm" if M.gemm_entry(layers) else "block", "grad_rel_err": err,
             "logit_max_abs_err": float((z1 - z2).abs().max())}
    return [grad, fwd], shape


def nb_records(torch, suffix, call, timer, plain_timer):
    """K-V (mass and score mode) on a ``_nb_grid_z`` call's inputs against
    plain and ``einsum``: records ``nb_tables_{mass,score}`` with ``_suffix``
    when one is given."""
    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB

    Xd, y, tw, smoothings, bernoulli, k = call[0]
    suffix = f"_{suffix}" if suffix else ""
    n, d = Xd.shape
    F = tw.shape[0]
    c1, f1 = NB.nb_tables_mass(Xd, y, tw, k)
    c2, f2 = NB.nb_tables_mass_plain(Xd, y, tw, k)
    torch.cuda.synchronize()
    check(torch.equal(c1, c2), f"nb_tables_mass{suffix}: class masses differ from plain")
    merr = float(((f1 - f2).abs() / f2.abs().clamp_min(1e-30)).max())
    check(merr <= NB_RTOL, f"nb_tables_mass{suffix} {merr} from plain, above {NB_RTOL}")
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    b, by = bound_ms((n * d + n + F * n) * 4 + F * k * (d + 1) * 4, F * n * 2 * (d + 1))
    mass = dict(name=f"nb_tables_mass{suffix}", route="cuda",
                source="transmogrifai_tpu_torch/csrc/naive_bayes.cu",
                replaces="transmogrifai_tpu/impl/classification/naive_bayes.py:23",
                max_abs_err=float((f1 - f2).abs().max()),
                ms=timer(lambda: NB.nb_tables_mass(Xd, y, tw, k)),
                plain_ms=plain_timer(lambda: NB.nb_tables_mass_plain(Xd, y, tw, k)),
                bound_ms=b, bound_by=by,
                library_ms=timer(lambda: torch.einsum("fn,nk,nd->fkd", tw, Y, Xd)))
    s = torch.as_tensor(np.asarray(smoothings, np.float32), device=Xd.device)
    G = s.shape[0]
    pi, theta, tn = NB._log_tables(c1[:, None], f1[:, None], s[None, :, None], bernoulli)
    pi, theta = pi.reshape(F * G, k).contiguous(), theta.reshape(F * G, k, d).contiguous()
    tn = None if tn is None else tn.reshape(F * G, k, d).contiguous()
    s1, s2 = NB.nb_tables_score(Xd, pi, theta, tn), NB.nb_tables_score_plain(Xd, pi, theta, tn)
    torch.cuda.synchronize()
    serr = float(((s1 - s2).abs() / s2.abs().clamp_min(1.0)).max())
    check(serr <= NB_RTOL, f"nb_tables_score{suffix} {serr} from plain, above {NB_RTOL}")
    Q = F * G
    b, by = bound_ms(n * d * 4 + Q * k * (d + 1) * 4 + Q * n * k * 4, Q * n * k * 2 * d)
    score = dict(name=f"nb_tables_score{suffix}", route="cuda",
                 source="transmogrifai_tpu_torch/csrc/naive_bayes.cu",
                 replaces="transmogrifai_tpu/impl/classification/naive_bayes.py:39",
                 max_abs_err=float((s1 - s2).abs().max()),
                 ms=timer(lambda: NB.nb_tables_score(Xd, pi, theta, tn)),
                 plain_ms=plain_timer(lambda: NB.nb_tables_score_plain(Xd, pi, theta, tn)),
                 bound_ms=b, bound_by=by,
                 library_ms=timer(lambda: torch.einsum("nd,qkd->qnk", Xd, theta)))
    return [mass, score], {"X": [n, d], "classes": k, "folds": F, "table_sets": Q,
                           "mass_rel_err": merr, "score_rel_err": serr}


def sgns_record(torch, w2v, timer, plain_timer, dev="cuda"):
    """K-AA at 300 dimensions: ten kernel epochs from the final fit's W0,
    then one epoch against plain and autograd of the plain loss."""
    import torch.nn.functional as TF

    from transmogrifai_tpu_torch.ops import embeddings as E

    W0, pairs_np, negs_np = w2v
    W = torch.from_numpy(W0).to(dev)
    C = torch.zeros_like(W)
    pairs, negs = torch.from_numpy(pairs_np).to(dev), torch.from_numpy(negs_np).to(dev)
    V, d = W.shape
    P_, K = negs.shape
    lists = E.sgns_lists(pairs, negs, V)
    for _ in range(10):
        W, C, _ = E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists, want_loss=False)
    got = E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists)
    want = E.sgns_epoch_plain(W, C, pairs, negs, 0.2)
    again = E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists)
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "sgns_epoch_d300 does not repeat")
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
    check(err <= SGNS_CARD_ATOL, f"sgns_epoch_d300 {err} from plain, above {SGNS_CARD_ATOL}")
    c_, o_, ng_ = pairs[:, 0].long(), pairs[:, 1].long(), negs.long()

    def library():
        Wr, Cr = W.detach().requires_grad_(), C.detach().requires_grad_()
        wc = Wr[c_]
        pos = (wc * Cr[o_]).sum(1)
        neg = torch.einsum("pd,pkd->pk", wc, Cr[ng_])
        loss = (TF.softplus(-pos) + TF.softplus(neg).sum(1)).mean()
        gW, gC = torch.autograd.grad(loss, (Wr, Cr))
        return W - 0.2 * gW, C - 0.2 * gC

    b, by = bound_ms(4 * V * d * 4 + P_ * (2 + K) * 4, P_ * (K + 1) * (6 * d + 20) + 4 * V * d)
    rec = dict(name="sgns_epoch_d300", route="cuda", source="transmogrifai_tpu_torch/csrc/sgns.cu",
               replaces="transmogrifai_tpu/impl/feature/embeddings.py:37", max_abs_err=err,
               ms=timer(lambda: E.sgns_epoch(W, C, pairs, negs, 0.2, lists=lists,
                                             want_loss=False)),
               plain_ms=plain_timer(lambda: E.sgns_epoch_plain(W, C, pairs, negs, 0.2)),
               bound_ms=b, bound_by=by, library_ms=timer(library))
    return [rec], {"V": V, "d": d, "P": P_, "K": K, "segments": int(lists.seg_row.numel()),
                   "loss_gap": abs(float(got[2]) - float(want[2]))}


def lda_records(torch, lda, timer, plain_timer, dev="cuda"):
    """K-AB's three modes at 100 topics on the final LDA fit's counts and
    topic-word matrix, against plain and the dense products."""
    from transmogrifai_tpu_torch.ops import embeddings as E

    col, topic_word = lda
    X = torch.clamp_min(col.tensor(dev), 0.0)
    lam = torch.from_numpy(topic_word).to(dev)
    n, v = X.shape
    k = lam.shape[0]
    docs = E.lda_docs(X)
    nnz = int(docs.terms.numel())
    eb, eb0 = E.lda_beta(lam), E.lda_beta_plain(lam)
    beta_err = float(((eb - eb0).abs() / eb0.abs().clamp_min(1e-30)).max())
    check(beta_err <= LDA_BETA_RTOL, f"lda_beta_k{k} {beta_err} from plain")
    g = E.lda_estep(eb0, X, 0.1, 30, docs=docs)
    g0 = E.lda_estep_plain(eb0, X, 0.1, 30)
    check(torch.equal(g, E.lda_estep(eb0, X, 0.1, 30, docs=docs)), "lda_estep does not repeat")
    theta_err = mixture_gap(g, g0)
    check(theta_err <= LDA_THETA_ATOL, f"lda_estep_k{k} mixtures {theta_err} from plain")
    lam1, lam0 = E.lda_sstats(eb0, X, g0, 0.01, docs=docs), E.lda_sstats_plain(eb0, X, g0, 0.01)
    check(torch.equal(lam1, E.lda_sstats(eb0, X, g0, 0.01, docs=docs)),
          "lda_sstats does not repeat")
    sstats_err = float(((lam1 - lam0).abs() / lam0).max())
    check(sstats_err <= LDA_SSTATS_RTOL, f"lda_sstats_k{k} {sstats_err} from plain")
    et = torch.exp(E.digamma(g0) - E.digamma(g0.sum(1, keepdim=True)))

    def dense_iterations():
        for _ in range(30):
            phi = et @ eb0
            (X / phi) @ eb0.T

    src, rep = "transmogrifai_tpu_torch/csrc/lda.cu", "transmogrifai_tpu/impl/feature/embeddings.py"
    recs = []
    b, by = bound_ms(2 * k * v * 4, k * v * (DIGAMMA_OPS + EXP_OPS + 1) + k * DIGAMMA_OPS)
    recs.append(dict(name=f"lda_beta_k{k}", route="cuda", source=src, replaces=f"{rep}:163",
                     max_abs_err=float((eb - eb0).abs().max()), ms=timer(lambda: E.lda_beta(lam)),
                     plain_ms=plain_timer(lambda: E.lda_beta_plain(lam)), bound_ms=b,
                     bound_by=by, library_ms=timer(lambda: torch.exp(
                         torch.special.digamma(lam) - torch.special.digamma(
                             lam.sum(1, keepdim=True))))))
    per_doc = k * (DIGAMMA_OPS + EXP_OPS + 4) + DIGAMMA_OPS + k
    b, by = bound_ms(k * v * 4 + (n + 1) * 4 + nnz * 8 + n * k * 4,
                     30 * (nnz * (4 * k + 1) + n * per_doc))
    recs.append(dict(name=f"lda_estep_k{k}", route="cuda", source=src, replaces=f"{rep}:160",
                     max_abs_err=float((g - g0).abs().max()),
                     ms=timer(lambda: E.lda_estep(eb0, X, 0.1, 30, docs=docs)),
                     plain_ms=plain_timer(lambda: E.lda_estep_plain(eb0, X, 0.1, 30)),
                     bound_ms=b, bound_by=by, library_ms=timer(dense_iterations)))
    b, by = bound_ms(2 * k * v * 4 + n * k * 4 + (n + 1) * 4 + nnz * 8,
                     n * per_doc + nnz * (4 * k + 1) + 2 * k * v)
    recs.append(dict(name=f"lda_sstats_k{k}", route="cuda", source=src, replaces=f"{rep}:211",
                     max_abs_err=float((lam1 - lam0).abs().max()),
                     ms=timer(lambda: E.lda_sstats(eb0, X, g0, 0.01, docs=docs)),
                     plain_ms=plain_timer(lambda: E.lda_sstats_plain(eb0, X, g0, 0.01)),
                     bound_ms=b, bound_by=by,
                     library_ms=timer(lambda: et.T @ (X / (et @ eb0)))))
    return recs, {"n": n, "v": v, "k": k, "nnz": nnz, "beta_rel_err": beta_err,
                  "theta_err": theta_err, "sstats_rel_err": sstats_err}


def slice14_phases(torch, FX, titanic, args, timer, dev="cuda"):
    """Phases 57-60.  Returns (the records, their launches on their main
    paths)."""
    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB
    from transmogrifai_tpu_torch.ops import embeddings as E
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import mlp as MLP
    from transmogrifai_tpu_torch.ops import stats as K
    from transmogrifai_tpu_torch.ops import threefry as R
    from transmogrifai_tpu_torch.ops import trees as Tr

    fixture_best = wide_reference_phase14(torch, FX, titanic, dev)
    kernels = (MLP.mlp_grad, MLP.mlp_forward, NB.nb_tables_mass, NB.nb_tables_score,
               E.sgns_epoch, E.lda_beta, E.lda_estep, E.lda_sstats, L.fista_grad,
               M.binary_metrics, M.multiclass_metrics, Tr.bin_rows, Tr.level_hist,
               Tr.split_scan, Tr.route_rows, Tr.boost_step, Tr.forest_leaf_mean, K.corr_gram,
               K.contingency_counts, R.threefry_draws)
    launches, keep = slice14_trains(torch, FX, titanic, args, kernels, fixture_best, dev)
    plain_timer = Timer(torch, 5)
    records, shapes, by_name = [], {}, {}
    letters, embed, bow = (keep["letters_families"], keep["wide_text_embed"],
                           keep["wide_text_bow"])
    big = next(c for c in letters["mlp"] if tuple(c[1]["layers"])[1:-1] == (128, 64))
    for name, train, call in (("mlp_grad_k26", "letters_families", big),
                              ("mlp_grad_wide", "wide_text_embed", embed["mlp"][0]),
                              ("mlp_grad_bow", "wide_text_bow", bow["mlp"][0])):
        recs, shapes[name] = mlp_record(torch, name, call, timer, plain_timer, dev)
        for r in recs:
            by_name[r["name"]] = launches[train][r["name"].split("_")[0] + "_"
                                                 + r["name"].split("_")[1]]
        records += recs
    for suffix, train, call in (("bow", "wide_text_bow", bow["nb"][0]),
                                ("k26", "letters_families", letters["nb"][0])):
        recs, shapes[f"nb_tables_{suffix}"] = nb_records(torch, suffix, call, timer,
                                                         plain_timer)
        for r in recs:
            by_name[r["name"]] = launches[train][r["name"].rsplit("_", 1)[0]]
        records += recs
    recs, shapes["sgns_epoch_d300"] = sgns_record(torch, embed["w2v"], timer, plain_timer, dev)
    by_name["sgns_epoch_d300"] = launches["wide_text_embed"]["sgns_epoch"]
    records += recs
    recs, shapes["lda_k100"] = lda_records(torch, embed["lda"], timer, plain_timer, dev)
    for r in recs:
        by_name[r["name"]] = launches["wide_text_embed"][r["name"].rsplit("_", 1)[0]]
    records += recs
    log("wide_kernels", shapes=shapes, records=records)
    return records, by_name


# ---------------------------------------------------------------------------
# The serving plane (slice 16): K-AF, the bucket graphs, the batcher, HTTP
# ---------------------------------------------------------------------------
#: the committed fixtures the serve-plane phase serves, by head
SERVE_FIXTURES = ("titanic_stock", "letters_stock", "boston_ridge", "titanic_xgb")


def serve_records_of(FX, name):
    """A fixture's request records as a JSON client sends them (NaN as
    null), and the rows holding an infinite value (the input contract
    rejects them: HTTP 422, ``non_finite``)."""
    import math

    recs = FX.records(FX.load_columns(getattr(FX, name.upper()) + "/requests.npz"))
    inf = [any(isinstance(v, float) and math.isinf(v) for v in r.values()) for r in recs]
    return ([{k: (None if isinstance(v, float) and math.isnan(v) else v) for k, v in r.items()}
             for r in recs], np.array(inf))


def expected_gaps(FX, name, outs, keep):
    """Served answers (score dicts of the rows ``keep``) against the
    fixture's ``expected.npz`` (the JAX package's answers); raises on a gap
    out of tolerance: probabilities ``FX.PROB_ATOL``, margins
    ``FX.MARGIN_ATOL`` / ``MARGIN_RTOL``, regression ``FX.PRED_ATOL`` /
    ``PRED_RTOL``, predictions equal off the decision boundary
    (``FX.BOUNDARY``; the top-two margin gap for softmax)."""
    exp = FX.load_expected(getattr(FX, name.upper()) + "/expected.npz")
    res = [o[next(iter(o))] for o in outs]
    pred = np.array([r["prediction"] for r in res])
    want = exp["prediction"][keep]
    if "probability" not in exp:
        err = np.abs(pred - want)
        check(bool((err <= FX.PRED_ATOL + FX.PRED_RTOL * np.abs(want)).all()),
              f"{name}: served predictions off the fixture's by {err.max()}")
        return {"rows": int(len(pred)), "pred_max_abs_err": float(err.max())}
    k = exp["probability"].shape[1]
    prob = np.array([[r[f"probability_{j}"] for j in range(k)] for r in res])
    raw = np.array([[r[f"rawPrediction_{j}"] for j in range(k)] for r in res])
    wprob, wraw = exp["probability"][keep], exp["rawPrediction"][keep]
    perr, rerr = np.abs(prob - wprob), np.abs(raw - wraw)
    top = np.sort(wraw, axis=1)
    near = (top[:, -1] - top[:, -2]) <= (2 if k == 2 else 1) * FX.BOUNDARY
    out = {"rows": int(len(pred)), "prob_max_abs_err": float(perr.max()),
           "raw_max_abs_err": float(rerr.max()),
           "pred_mismatches_off_boundary": int((pred != want)[~near].sum())}
    check(out["prob_max_abs_err"] <= FX.PROB_ATOL, f"{name}: {out}")
    check(bool((rerr <= FX.MARGIN_ATOL + FX.MARGIN_RTOL * np.abs(wraw)).all()), f"{name}: {out}")
    check(out["pred_mismatches_off_boundary"] == 0, f"{name}: {out}")
    return out


def head_inputs(torch, model, cols, rows):
    """The prediction head's input matrix on the card at ``rows`` rows (the
    requests' vectors repeated), its fitted coefficients and K-AF mode."""
    stage = model.stages[-1]
    full = model.score(cols, keep_intermediate_features=True)
    V = full[stage.inputs[-1].name].tensor(model.device)
    V = V.repeat(-(-rows // V.shape[0]), 1)[:rows].contiguous()
    dp = stage._device_params()
    mode = ("linear" if "multinomial" not in dp
            else "softmax" if dp["multinomial"] else "binary")
    return V, dp["coef"], dp["intercept"], mode


def head_record(torch, name, X, coef, b, mode, timer, plain_timer, tol_prob=None):
    """K-AF on (X, coef, b) against its plain version: the gaps held to the
    serve tolerances (or ``tol_prob`` for the probabilities), timed beside
    its bound, the plain version's time and ``torch.addmm``'s product."""
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.ops import linear as L

    pred, raw, prob = L.predict_head(X, coef, b, mode)
    pred0, raw0, prob0 = L.predict_head_plain(X, coef, b, mode)
    torch.cuda.synchronize()
    n, p = X.shape
    k = coef.shape[1] if mode == "softmax" else 1
    width = 2 if mode == "binary" else k
    if mode == "linear":
        err = float((pred - pred0).abs().max())
        check(bool(((pred - pred0).abs() <= FX.PRED_ATOL + FX.PRED_RTOL * pred0.abs()).all()),
              f"{name}: predict_head differs from plain by {err}")
        gaps = {"pred": err}
    else:
        rerr = float((raw - raw0).abs().max())
        perr = float((prob - prob0).abs().max())
        top = torch.topk(raw0, 2, dim=1).values
        near = (top[:, 0] - top[:, 1]) <= (2 if mode == "binary" else 1) * FX.BOUNDARY
        flips = int((pred != pred0)[~near].sum())
        limit = FX.PROB_ATOL if tol_prob is None else tol_prob(rerr)
        gaps = {"raw": rerr, "prob": perr, "prob_limit": limit, "flips_off_boundary": flips}
        check(bool(((raw - raw0).abs() <= FX.MARGIN_ATOL + FX.MARGIN_RTOL * raw0.abs()).all())
              and perr <= limit and flips == 0, f"{name}: predict_head differs: {gaps}")
    out_floats = n * (1 + (2 * width if mode != "linear" else 0))
    bnd, by = bound_ms(4 * (n * p + p * k + k + out_floats), 2 * n * p * k)
    w = coef if mode == "softmax" else coef[:, None]
    bias = b if mode == "softmax" else b[:1]
    rec = dict(name=name, route="cuda", source="transmogrifai_tpu_torch/csrc/predict_head.cu",
               replaces={"binary": "transmogrifai_tpu/ops/linear.py:505",
                         "softmax": "transmogrifai_tpu/ops/linear.py:517",
                         "linear": "transmogrifai_tpu/ops/linear.py:525"}[mode],
               max_abs_err=max(gaps.get("raw", 0.0), gaps.get("prob", 0.0), gaps.get("pred", 0.0)),
               ms=timer(lambda: L.predict_head(X, coef, b, mode)),
               plain_ms=plain_timer(lambda: L.predict_head_plain(X, coef, b, mode)),
               bound_ms=bnd, bound_by=by,
               library_ms=timer(lambda: torch.addmm(bias, X, w)))
    return rec, {"shape": [n, p, k], "mode": mode, **gaps}


def percentiles(ms):
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "n": len(ms)}


def http_latency(srv, rec, threads, posts):
    """Single-record POST /score latencies (ms) from ``threads`` clients,
    ``posts`` each; raises on any status but 200."""
    import threading
    import urllib.request

    body = json.dumps(rec).encode()
    times, errors = [], []
    lock = threading.Lock()

    def client():
        for _ in range(posts):
            req = urllib.request.Request(srv.url + "/score", data=body,
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
                    ok = resp.status == 200
            except Exception as e:  # noqa: BLE001 — reported below
                ok = False
                errors.append(repr(e))
            with lock:
                times.append((time.perf_counter() - t) * 1e3)
                if not ok and not errors:
                    errors.append("status")

    ts = [threading.Thread(target=client) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    check(not errors, f"HTTP posts failed: {errors[:3]}")
    return times


def serve_plane_phase(torch, FX, timer, args, dev="cuda"):
    """Phase 5b, the serving plane on the card: K-AF against its plain
    version at the serve shapes, each fixture's bucket graphs against the
    eager program, the four fixtures' answers through ``MicroBatcher`` and
    HTTP against the JAX package's, latency in turns (graph, eager, eager,
    graph), and a hot swap under load.  Returns (the K-AF records, their
    launches on the serve plane's main path)."""
    import threading
    import urllib.error
    import urllib.request

    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch.obs import registry as obs_registry
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.serve import MicroBatcher, ModelRegistry, ModelServer, aot

    smi = nvidia_smi()
    models = {nm: P.load_model(getattr(FX, nm.upper()), device=dev) for nm in SERVE_FIXTURES}
    #: the user's call on the card: the default devices (one replica a card)
    devices = None if dev == "cuda" else [torch.device(dev)]
    requests = {nm: serve_records_of(FX, nm) for nm in SERVE_FIXTURES}
    plain_timer = Timer(torch, 5)

    # K-AF at the serve shapes: each linear fixture's head at buckets 64 and
    # 1024, and p = 1024 at 1,024 rows
    records, shapes = [], {}
    for nm in ("titanic_stock", "letters_stock", "boston_ridge"):
        cols = FX.load_columns(getattr(FX, nm.upper()) + "/requests.npz")
        finite = ~requests[nm][1]
        cols = {k: v[finite] for k, v in cols.items()}
        for rows in (64, 1024):
            X, coef, b, mode = head_inputs(torch, models[nm], cols, rows)
            rec, shape = head_record(torch, f"predict_head_{nm}_{rows}", X, coef, b, mode,
                                     timer, plain_timer)
            shapes[rec["name"]] = shape
            if rows == 1024:
                records.append(rec)
            else:
                shapes[rec["name"]].update(ms=rec["ms"], plain_ms=rec["plain_ms"],
                                           library_ms=rec["library_ms"],
                                           bound_ms=rec["bound_ms"])
    rng = np.random.default_rng(args.seed)
    Xw = torch.from_numpy(rng.normal(size=(1024, 1024)).astype(np.float32)).to(dev)
    cw = torch.from_numpy((rng.normal(size=1024) / 32).astype(np.float32)).to(dev)
    bw = torch.zeros(1, device=dev)
    rec, shapes["predict_head_p1024"] = head_record(
        torch, "predict_head_p1024", Xw, cw, bw, "binary", timer, plain_timer,
        tol_prob=lambda gap: FX.PROB_ATOL + 0.5 * gap)
    records.append(rec)
    # the 64-row bucket at p = 1,024, where a row takes several warps
    rec64, shape64 = head_record(
        torch, "predict_head_p1024_64", Xw[:64], cw, bw, "binary", timer, plain_timer,
        tol_prob=lambda gap: FX.PROB_ATOL + 0.5 * gap)
    shapes["predict_head_p1024_64"] = dict(shape64, **{
        key: rec64[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms")})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in shapes.values():
        n_, p_, k_ = shape["shape"]
        shape["plan"] = L.head_plan(n_, p_, k_, sms, shape["mode"])._asdict()
    log("serve_plane_kernels", nvidia_smi=smi, shapes=shapes, records=records)

    # the bucket graphs against the eager program, bit for bit, max_batch 64
    graphs = {}
    for nm in SERVE_FIXTURES:
        reg = ModelRegistry(max_batch=64, devices=devices)
        t = time.perf_counter()
        reg.deploy(models[nm], version=f"{nm}-graphs")
        deploy_s = time.perf_counter() - t
        scorer = reg.replica(0).scorer
        if scorer is None:
            graphs[nm] = {"route": "BatchScoreFunction (aot_unsupported)", "deploy_s": deploy_s}
            continue
        recs = [r for r, bad in zip(*requests[nm]) if not bad]
        replay_ms, eager_ms = {}, {}
        for b in reg.buckets:
            got = scorer.device_outputs(recs[:b], b)
            want = scorer.device_outputs(recs[:b], b, eager=True)
            check(got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got),
                  f"{nm}: bucket {b}'s graph replay differs from the eager program")
            # the card's time for the bucket's program: the graph's replay
            # against the same launches made one by one (CUDA events)
            ent = scorer._entries[b]
            if ent.graph is not None:  # (a CPU rehearsal has none)
                replay_ms[str(b)] = timer(ent.graph.replay)
                eager_ms[str(b)] = timer(lambda: scorer._run(ent.static))
        graphs[nm] = {"replay_ms": replay_ms, "eager_ms": eager_ms,
                      "capture_s": {str(b): s for b, s in sorted(scorer.capture_s.items())},
                      "graph_bytes": scorer.graph_bytes(), "deploy_s": deploy_s,
                      "graph_heads": scorer.graph_heads, "buckets_bit_equal": len(reg.buckets)}
        reg.active().release()
    log("serve_plane_graphs", nvidia_smi=smi, fixtures=graphs)

    # the main path: every fixture through MicroBatcher and HTTP, then the hot
    # swap under load; every count set to 0 just before, read just after
    obs_registry.scope("serve").reset()
    aot.reset_warm_stats()
    zero_launches((L.predict_head,))
    answers, batch_stats = {}, {}
    for nm in SERVE_FIXTURES:
        recs, bad = requests[nm]
        reg = ModelRegistry(max_batch=64, devices=devices)
        reg.deploy(models[nm], version="v1")
        srv = ModelServer(reg, port=0, max_batch=64, max_wait_ms=2.0).start()
        try:
            futures = []
            for r in recs:
                try:
                    futures.append(srv.batcher.submit(r))
                except Exception as e:  # noqa: BLE001 — the contract's rejections
                    futures.append(e)
            outs = [f.result(60).output for f, b in zip(futures, bad) if not b]
            rejected = [getattr(f, "reason", repr(f)) for f, b in zip(futures, bad) if b]
            check(all(r == "non_finite" for r in rejected), f"{nm}: {rejected}")
            req = urllib.request.Request(srv.url + "/score",
                                         data=json.dumps({"records": recs}).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, body = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                status, body = e.code, json.loads(e.read())
            check(status == (422 if bad.any() else 200), f"{nm}: HTTP status {status}")
            check([e["index"] for e in body.get("errors", [])] == list(np.flatnonzero(bad)),
                  f"{nm}: HTTP rejected rows {body.get('errors')}")
            http = [s for s, b in zip(body["scores"], bad) if not b]
            answers[nm] = {"batcher": expected_gaps(FX, nm, outs, ~bad),
                           "http": expected_gaps(FX, nm, http, ~bad),
                           "rejected_non_finite": len(rejected),
                           "graphs": reg.replica(0).scorer is not None}
            snap = srv.metrics.snapshot()
            batch_stats[nm] = {k: snap[k] for k in ("batches", "fallback_batches",
                                                    "fallback_records", "degraded_batches",
                                                    "errors")}
        finally:
            srv.stop()
            reg.active().release()

    # hot swap under load: 16 clients for about 5 s, titanic_newton over
    # titanic_stock through POST /models
    reg = ModelRegistry(max_batch=64, devices=devices)
    reg.deploy(models["titanic_stock"], version="v1")
    srv = ModelServer(reg, port=0, max_batch=64, max_wait_ms=2.0, queue_size=4096).start()
    rec = next(r for r, b in zip(*requests["titanic_stock"]) if not b)
    body = json.dumps(rec).encode()
    swapped, stop = threading.Event(), threading.Event()
    seen, failures, stale = [], [], []
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            was = swapped.is_set()
            req = urllib.request.Request(srv.url + "/score", data=body,
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    version = json.loads(resp.read())["model_version"]
            except Exception as e:  # noqa: BLE001 — counted
                with lock:
                    failures.append(repr(e))
                continue
            with lock:
                seen.append(version)
                if was and version != "v2":
                    stale.append(version)

    threads = [threading.Thread(target=client) for _ in range(16)]
    for t in threads:
        t.start()
    try:
        time.sleep(2.0)
        t0 = time.perf_counter()
        req = urllib.request.Request(
            srv.url + "/models",
            data=json.dumps({"path": FX.TITANIC_NEWTON, "version": "v2"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            check(json.loads(resp.read())["active"] == "v2", "the swap did not take")
        swap_s = time.perf_counter() - t0
        swapped.set()
        time.sleep(3.0)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    snap = srv.metrics.snapshot()
    srv.stop()
    reg.active().release()
    launches = {"predict_head": L.predict_head.launches}
    fallbacks = [f["reason"] for f in obs_registry.scope("serve").list("fallbacks")]
    swap = {"requests": len(seen) + len(failures), "failed": len(failures),
            "stale_after_swap": len(stale), "v1": seen.count("v1"), "v2": seen.count("v2"),
            "swap_s": swap_s, "degraded_batches": snap["degraded_batches"],
            "fallback_records": snap["fallback_records"], "fallbacks": fallbacks,
            "request_latency": snap["request_latency"]}
    log("serve_plane", nvidia_smi=smi, answers=answers, batches=batch_stats, hot_swap=swap,
        launches=launches, warm_stats=aot.warm_stats())
    check(not failures and not stale, f"hot swap: {swap}")
    check(snap["degraded_batches"] == 0 and snap["fallback_records"] == 0, f"hot swap: {swap}")
    check(all(s["fallback_batches"] == 0 and s["degraded_batches"] == 0 and s["errors"] == 0
              for s in batch_stats.values()), f"a batch left the bucket path: {batch_stats}")
    check(set(fallbacks) <= {"aot_unsupported"}, f"recorded fallbacks: {fallbacks}")
    check(launches["predict_head"] > 0, "predict_head was not launched on the serve plane")

    # latency in turns: graph, eager, eager, graph
    latency = {}
    recs64 = [r for r, b in zip(*requests["titanic_stock"]) if not b]
    big = [{k: (None if isinstance(v, float) and v != v else v) for k, v in r.items()}
           for r in FX.records(titanic_columns(1024, args.seed + 2))]
    for max_batch, sizes in ((64, (1, 64)), (1024, (1024,))):
        reg = ModelRegistry(max_batch=max_batch, devices=devices)
        entry = reg.deploy(models["titanic_stock"], version=f"latency-{max_batch}")
        rep = reg.replica(0)
        eager = P.BatchScoreFunction(models["titanic_stock"])
        for size in sizes:
            part = (recs64 if size <= 64 else big)[:size]
            turns = []
            for route in ("graph", "eager", "eager", "graph"):
                fn = rep.score if route == "graph" else eager
                ms = []
                for _ in range(args.reps):
                    t = time.perf_counter()
                    out = fn(part)
                    ms.append((time.perf_counter() - t) * 1e3)
                    check(len(out) == size, "short answer")
                turns.append({"route": route, **percentiles(ms)})
            latency[f"batch_{size}"] = turns
        if max_batch == 64:
            srv = ModelServer(reg, port=0, max_batch=64, max_wait_ms=2.0).start()
            try:
                for threads, posts in ((1, 100), (16, 25)):
                    turns = []
                    for route in ("graph", "eager", "eager", "graph"):
                        entry.batch = entry._default_batch if route == "graph" else \
                            (lambda recs: eager(recs))
                        turns.append({"route": route, **percentiles(
                            http_latency(srv, recs64[0], threads, posts))})
                    latency[f"http_{threads}_clients"] = turns
                entry.batch = entry._default_batch
            finally:
                srv.stop()
        reg.active().release()
    log("serve_plane_latency", nvidia_smi=smi, latency=latency)
    return records, {r["name"]: launches["predict_head"] for r in records}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train-rows", type=int, default=1 << 18)
    ap.add_argument("--stats-rows", type=int, default=1 << 20)
    ap.add_argument("--text-rows", type=int, default=1 << 17)
    ap.add_argument("--stream-rows", type=int, default=1 << 22)
    ap.add_argument("--wide-text-rows", type=int, default=1 << 16,
                    help="rows of the two wide text trains (phase 59)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu_torch import fixtures as FX
    from transmogrifai_tpu_torch.ops import cuda_build
    from transmogrifai_tpu_torch.ops import linear as L
    from transmogrifai_tpu_torch.ops import metrics as M
    from transmogrifai_tpu_torch.ops import stats as K
    from transmogrifai_tpu_torch.ops import threefry as R
    from transmogrifai_tpu_torch.ops import trees as Tr
    from transmogrifai_tpu_torch.ops import vectorize as V
    from transmogrifai_tpu_torch.ops import mlp as MLP
    from transmogrifai_tpu_torch.impl.classification import naive_bayes as NB

    from transmogrifai_tpu_torch.apps import boston, iris, titanic

    kernels = (Tr.bin_rows, Tr.ensemble_walk, V.fill_indicator, V.one_hot_codes)
    train_kernels = (Tr.bin_rows, Tr.level_hist, Tr.root_sums, Tr.split_scan, Tr.route_rows,
                     Tr.boost_step, K.corr_gram, K.contingency_counts, L.fista_grad,
                     M.binary_metrics, Tr.forest_leaf_mean, R.threefry_draws)
    boston_kernels = (Tr.bin_rows, Tr.ensemble_walk, Tr.level_hist, Tr.split_scan,
                      Tr.route_rows, Tr.boost_step, Tr.forest_leaf_mean, L.linear_fista_grad,
                      M.regression_metrics, R.threefry_draws)
    iris_kernels = (Tr.bin_rows, Tr.ensemble_walk, V.fill_indicator, Tr.level_hist,
                    Tr.split_scan, Tr.route_rows, Tr.forest_leaf_mean, L.softmax_fista_grad,
                    M.multiclass_metrics, R.threefry_draws)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 1. device + build ------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = cuda_build.build()
    dev = torch.device("cuda")
    one = torch.ones((2, 8), device=dev)
    V.fill_indicator(one, one > 0, torch.ones(2, device=dev), True)
    V.one_hot_codes(torch.zeros((1, 8), dtype=torch.int32, device=dev), [3])
    for loss in ("logistic", "squared"):
        Tr.boost_step(one, one[0], one, one[:, 0], ghw=torch.empty((2, 8, 2), device=dev),
                      loss=loss)
    Tr.softmax_boost_step(torch.zeros((2, 8, 3), device=dev), one[0] * 0, one, one[:, 0],
                          ghw=torch.empty((2, 8, 4), device=dev))
    Tr.forest_leaf_mean(one[None], torch.zeros((1, 2, 8), dtype=torch.int32, device=dev))
    Tr.forest_leaf_mean(one[None, ..., None].repeat(1, 1, 1, 3),
                        torch.zeros((1, 2, 8), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    log("device", nvidia_smi=smi, name=kind, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=time.perf_counter() - t0, nvcc_s=nvcc_s,
        ptxas={k: ptxas_summary(v) for k, v in cuda_build.BUILD_LOG.items()})

    model = P.load_model(FX.TITANIC_XGB)
    cols = titanic_columns(args.rows, args.seed)

    # 2. kernels against their plain versions ---------------------------------
    timer = Timer(torch, args.reps)
    records = kernel_phase(torch, model, cols, timer)

    # 3. reference: the JAX package's answers for the fixture's requests -----
    req = FX.load_columns(FX.TITANIC_XGB + "/requests.npz")
    pred, prob, raw, Xb, F = FX.port_answers(model, req)
    gaps = FX.compare(FX.load_expected(), pred, prob, raw, Xb=Xb, F=F)
    log("reference", rows=len(pred), **gaps)

    # 4. serve: the main path -------------------------------------------------
    launches = serve_phase(torch, model, cols, args.reps, args.seed, kernels)
    missing = [k for k, v in launches.items() if v <= 0]
    check(not missing, f"kernels not launched on the main path: {missing}")
    breakdown_phase(torch, model, cols)
    del cols

    # 5b. the serving plane: K-AF, the bucket graphs, the batcher and HTTP,
    # latency in turns, the hot swap under load
    serve_plane_records, serve_plane_launches = serve_plane_phase(torch, FX, timer, args)

    # 6-11. training: the fixtures' trains, the main path at scale, kernels
    train_reference_phase(torch, titanic, FX)
    sweep_reference_phase(torch, titanic, FX)
    train_launches, trained, call = train_phase(torch, titanic, args.train_rows, args.seed,
                                                train_kernels)
    missing = [k for k, v in train_launches.items() if v <= 0]
    check(not missing, f"kernels not launched on the train path: {missing}")
    train_records = train_kernel_phase(torch, trained, timer)
    train_records += stats_kernel_phase(torch, trained, timer)
    train_records += sweep_kernel_phase(torch, call, timer)
    del trained, call

    # 12-14. the regression train: the fixture's, the main path at scale, kernels
    boston_reference_phase(torch, boston, FX)
    boston_launches, boston_call = boston_train_phase(torch, boston, args.train_rows, args.seed,
                                                      boston_kernels)
    missing = [k for k, v in boston_launches.items() if v <= 0]
    check(not missing, f"kernels not launched on the regression train path: {missing}")
    boston_records = boston_kernel_phase(torch, boston_call, timer)
    del boston_call

    # 15-17. the multiclass train: the fixture's, the main path at scale, kernels
    iris_reference_phase(torch, iris, FX)
    iris_launches, iris_call = iris_train_phase(torch, iris, args.train_rows, args.seed,
                                                iris_kernels)
    missing = [k for k, v in iris_launches.items() if v <= 0]
    check(not missing, f"kernels not launched on the multiclass train path: {missing}")
    iris_records = iris_kernel_phase(torch, iris_call, timer)
    del iris_call

    # 18-24. softmax boosting, the Newton and ridge fits: the fixtures'
    # trains, the main paths at scale, the kernels
    iris_boost_reference_phase(torch, iris, FX)
    titanic_newton_reference_phase(torch, titanic, FX)
    boston_ridge_reference_phase(torch, boston, FX)
    sp = spaces()
    boost_kernels = iris_kernels + (Tr.softmax_boost_step,)
    boost_launches, boost_calls, _ = scale_train_phase(
        torch, "iris_boost_train",
        lambda: iris.train_iris(iris.iris_data(args.train_rows, args.seed), device="cuda",
                                models_and_parameters=sp["iris_mixed"]),
        boost_kernels, [fn.__name__ for fn in boost_kernels], iris_boost_check,
        count_draws=True)
    newton_launches, newton_calls, _ = scale_train_phase(
        torch, "titanic_newton_train",
        lambda: titanic.train_titanic(titanic.titanic_data(args.train_rows, args.seed),
                                      device="cuda", models_and_parameters=sp["titanic_mixed"]),
        (L.weighted_gram, L.fista_grad, M.binary_metrics, K.corr_gram, K.contingency_counts),
        ("weighted_gram", "fista_grad", "binary_metrics"), titanic_newton_check)
    ridge_launches, ridge_calls, _ = scale_train_phase(
        torch, "boston_ridge_train",
        lambda: boston.train_boston(boston.boston_data(args.train_rows, args.seed),
                                    device="cuda", models_and_parameters=sp["boston_ridge"]),
        (L.weighted_gram, L.linear_fista_grad, M.regression_metrics, Tr.ensemble_walk),
        ("weighted_gram", "linear_fista_grad", "regression_metrics"), boston_ridge_check)
    slice6_records = slice6_kernel_phase(torch, boost_calls, newton_calls[0], ridge_calls[0],
                                         timer)
    kw_records = kw_kernel_phase(torch, boost_calls, timer)
    slice6_launches = {"softmax_boost_step": boost_launches["softmax_boost_step"],
                       "weighted_gram_newton": newton_launches["weighted_gram"],
                       "weighted_gram_ridge": ridge_launches["weighted_gram"],
                       "forest_leaf_mean_t300": boost_launches["forest_leaf_mean"]}
    del boost_calls, newton_calls, ridge_calls

    # 25-28. the binary selector's other families: the fixture's trains, both
    # routes at scale, the kernels
    families_reference_phase(torch, titanic, iris, FX)
    tree_kernels = (Tr.bin_rows, Tr.ensemble_walk, Tr.level_hist, Tr.split_scan, Tr.route_rows)
    family_kernels = (L.svc_grad, MLP.mlp_grad, MLP.mlp_forward, R.threefry_draws)

    def families_train(space):
        return lambda: titanic.train_titanic(
            titanic.titanic_data(args.train_rows, args.seed), device="cuda",
            models_and_parameters=sp["titanic_families_" + space])

    a_launches, _, _ = scale_train_phase(
        torch, "families_a_train", families_train("a"),
        family_kernels + tree_kernels + (NB.nb_tables_mass, NB.nb_tables_score),
        ("svc_grad", "mlp_grad", "mlp_forward", "nb_tables_mass", "nb_tables_score",
         "level_hist", "split_scan", "route_rows", "threefry_draws"),
        lambda m: families_check(m, "a"), sweep=False)
    b_launches, b_calls, _ = scale_train_phase(
        torch, "families_b_train", families_train("b"),
        family_kernels + tree_kernels + (Tr.forest_leaf_mean, M.binary_metrics),
        ("svc_grad", "mlp_grad", "mlp_forward", "level_hist", "split_scan", "route_rows",
         "forest_leaf_mean", "binary_metrics", "threefry_draws"),
        lambda m: families_check(m, "b"))
    families_records = families_kernel_phase(torch, b_calls, timer)
    families_launches = {"svc_grad": b_launches["svc_grad"], "mlp_grad": b_launches["mlp_grad"],
                         "mlp_forward": b_launches["mlp_forward"],
                         "nb_tables_mass": a_launches["nb_tables_mass"],
                         "nb_tables_score": a_launches["nb_tables_score"]}
    del b_calls

    # 29-32. the GLM family on K-S's GLM mode: the fixture's train, the main
    # path at scale (its first fit_glm_grid_folds call's inputs kept), the
    # kernel
    boston_glm_reference_phase(torch, boston, FX)
    with AllCalls(L, "fit_glm_grid_folds") as glm_call:
        glm_launches, _, _ = scale_train_phase(
            torch, "boston_glm_train",
            lambda: boston.train_boston(boston.boston_data(args.train_rows, args.seed),
                                        device="cuda", models_and_parameters=boston.glm_space()),
            (L.weighted_gram, R.threefry_draws), ("weighted_gram",),
            boston_glm_check(FX, args.train_rows, args.seed), sweep=False)
    glm_records = glm_kernel_phase(torch, glm_call, timer)
    kw_launches = {"threefry_draws_poisson": boost_launches["threefry_draws_poisson"],
                   "threefry_draws_masks": boost_launches["threefry_draws_masks"],
                   "threefry_draws_uniform": b_launches["threefry_draws_uniform"],
                   "weighted_gram_glm": glm_launches["weighted_gram"]}
    del glm_call

    # 32-36. the sanity checker at scale: the fixture's 891-row vector in four
    # settings, the streamed Pearson and Spearman trains, the kernels
    stream_records, stream_launches = sanity_phases(torch, titanic, FX, args, timer)

    # 37-40. the text embeddings (K18): the fixture's model and 891-row train,
    # the main path at --text-rows, the kernels, the text model's requests
    text_records, text_launches = text_phases(torch, titanic, FX, args, timer)

    # 41-47. K-S, K-P, K-T past 64 coefficients; the streaming executor; the
    # OpTitanicSimple flow (K-AC, K-AD)
    slice11_records, slice11_launches = slice11_phases(torch, titanic, FX, args, timer)

    # 48-52. round-collapsed boosting (the collapse modes of K-H and K-R), the
    # selectors' branches, the logistic grid sweep (K-AE)
    slice12_records, slice12_launches = slice12_phases(torch, titanic, iris, boston, FX, args,
                                                       timer)

    # 53-56. the multiclass selector past 8 classes: the Letter flow against
    # the fixtures, runs 1-3 at the card's sizes, K-E / K-F / K-P / K-Q / K-M
    # at 26 and 64 classes, K-R / the wide K-P / K-B off the path
    slice13_records, slice13_launches = slice13_phases(torch, FX, timer)

    # 57-60. the tiled K-U, K-V, K-AA and K-AB: the three flows at fixture
    # size against the JAX package's fixtures, at the card's sizes, the
    # kernels on their trains' inputs
    slice14_records, slice14_launches = slice14_phases(torch, FX, titanic, args, timer)

    for r in records:
        r["launches"] = launches[r["name"]]
    for r in serve_plane_records:
        r["launches"] = serve_plane_launches[r["name"]]
    for r in train_records:
        r["launches"] = train_launches[r["name"]]
    for r in boston_records:
        r["launches"] = boston_launches[r["name"].replace("_squared", "")]
    for r in iris_records:
        r["launches"] = iris_launches[r["name"].replace("_c3", "")]
    for r in slice6_records:
        r["launches"] = slice6_launches[r["name"]]
    for r in families_records:
        r["launches"] = families_launches[r["name"]]
    for r in kw_records + glm_records:
        r["launches"] = kw_launches[r["name"]]
    for r in stream_records:
        r["launches"] = stream_launches[r["name"]]
    for r in text_records:
        r["launches"] = text_launches[r["name"]]
    for r in slice11_records:
        r["launches"] = slice11_launches[r["name"]]
    for r in slice12_records:
        r["launches"] = slice12_launches[r["name"]]
    for r in slice13_records:
        r["launches"] = slice13_launches[r["name"]]
    for r in slice14_records:
        r["launches"] = slice14_launches[r["name"]]
    records += (serve_plane_records + train_records + boston_records + iris_records + slice6_records
                + families_records + kw_records + glm_records + stream_records + text_records
                + slice11_records + slice12_records + slice13_records + slice14_records)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

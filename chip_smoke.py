#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cycloneml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing lines of its own; any failure exits non-zero without
the final result line:

1. the card: name and power limit (nvidia-smi), torch device name, count;
2. the build of every kernel from ``cycloneml_tpu_torch/csrc`` (one nvcc per
   source, started together), with each kernel instance's registers,
   shared memory and spills from ``-Xptxas -v`` (K3 and K4: the
   tensor-core instances for bf16 and e4m3 X, the FMA ones for f32), and
   a check that no kernel of ``ell_sweep`` spills;
3. K1 (the GLM sweep, logistic link) against its plain PyTorch version run
   in float64 on the card, at the LogisticRegression fit's shape
   (n=2,000,000, d=1280) for f32 and bf16 X with and without centering,
   and at a ragged shape (n=1,000,003, d=1000): |dloss|/|loss| <= 1e-5,
   max|dgrad| <= 1e-4 max|grad|, sum(w) = n exactly, two launches bitwise
   equal; then its time (CUDA events) beside the plain version's, the
   bound, and a yardstick of two cuBLAS gemvs the port never calls, with
   the instance's plan (ring stages, block rows, shared memory, CTAs
   resident on each SM);
4. LogisticRegression: ``LogisticRegression(maxIter=25, regParam=0.01,
   tol=0.0).fit`` on data generated on the card at bench.py's shape (bf16
   tier, seed 0), through K1 (usePallasKernels=auto) and through the plain
   aggregator (false). K1 must be launched exactly ``total_evals`` times;
   each fit runs 25 iterations or stops on an exact float32 stall; the
   models agree within the reference's kernel-vs-plain bound (rtol 5e-3,
   atol 5e-4) and their final objectives to 1e-4; its iterations and
   evaluations are printed beside those of the sweep's per-row order
   (``ROW_ORDER_COUNTS``), as they are for phases 6, 12 and 13;
5. K2 (the GLM sweep, squared link) with K1's checks, at the
   LinearRegression configuration's shape (n=400,000, d=2000) and a ragged
   one (n=1,000,003, d=1000), timed likewise;
6. LinearRegression at the repo's configuration 2 (``generate_regression
   (seed=11, noise=0.1)`` at 400,000 x 2,000, bf16 tier; ``regParam=0.001,
   elasticNetParam=0.5, maxIter=100, tol=1e-7, solver="l-bfgs"``, so
   OWL-QN), a warm and a steady fit through K2 and through the plain
   aggregator: K2 launched exactly once per loss evaluation, final
   objectives to 1e-4, coefficients within rtol 5e-3, atol 5e-4, and the
   count of coordinates whose zero pattern differs;
7. K3 (nearest-center assignment) against its plain version in float64
   (row chunks) at configuration 3's shape (n=10,000,000, d=128, k=1000;
   bf16 and f32) and a ragged one (n=1,000,003, d=100, k=37): where the
   argmins differ, d2_64[best] - d2_64[best64] <= 1e-5 max(d2_64, |x|^2)
   (the count of such rows is printed), |dist - dist64| <= 1e-4 of the
   same scale, two launches bitwise equal, counted under the instance the
   dtype picks (tensor cores for bf16, FMA for f32); the same rule on bf16
   X at the main shape against 500 center pairs c, c + delta (delta ~
   1e-6, so float32 rounding decides which of a pair wins); times beside
   the plain f32 version, the bound (three bf16 tensor-core passes for
   bf16 and e4m3, with the f32 FMA bound beside it), and a yardstick of
   the chunked f32 product x c^T with TF32 off;
8. KMeans at configuration 3 (``RandomDatasets.normal(seed=12)``, 10M x
   128, bf16 tier; ``k=1000, maxIter=10, tol=1e-5, seed=3``) through K3 and
   through the plain assignment: K3 launched exactly Lloyd steps +
   k-means|| passes times, all of them the tensor-core instance, training
   costs to 1e-4 relative; and one Lloyd step from identical initial
   centers, max|dcenter| <= 1e-4 max|center|; a second fit through K3
   gives bitwise-equal centers and cost, and the fit launches only the
   counting instance of the center sums; the center sums of one Lloyd
   step (``center_sums``: a stable sort, then fixed-order sums, no float
   atomics) through the counting instance (a counting sort written for the
   card) against float64 ``index_add_`` sums (1e-6 of the largest sum,
   counts exact), two calls bitwise equal, bitwise equal to the sorted
   instance (``torch.sort`` and the same sums) in the same call, the counting
   order ``torch.sort``'s stable one, launches counted by instance,
   scratch below one copy of X; both instances timed in turns, and the
   counting sort alone, beside the ``index_add_`` update they replaced;
9. K4 (the Gramian) against its plain version in float64 (row chunks) at
   400,000 x 2,000 (bf16 and f32) and at a ragged shape with a third of the
   rows masked by w = 0: |dG_ij| <= 1e-4 sqrt(G_ii G_jj), G == G^T
   bitwise, two launches bitwise equal, counted under the dtype's
   instance; times beside the plain f32 version, the bound, the library
   call (on bf16 X ``torch.mm(x^T, x, out_dtype=torch.float32)``, bf16
   products with a float32 output, unmasked; on f32 and e4m3 X the f32
   x^T x, TF32 off), the f32 x^T x and, as a rate reference that is not
   the same function (its output is bf16), cuBLAS's bf16 x^T x;
10. PCA: ``PCA(k=10).fit`` and ``RowMatrix.compute_svd(k=10)`` on data
   with a known spectrum, X = (Z diag(s)) Q^T at 400,000 x 2,000 (bf16 tier,
   s_j = (j+1)^-1/2, Q orthogonal from a float64 QR), through K4 and
   through the plain Gramian: K4 launched once per Gramian (its
   tensor-core instance), |cos| between
   matched components >= 1 - 1e-6, explained variance and singular values
   to 1e-5 relative; both against Q[:, :10] (min |cos| printed, >= 0.99);
11. the fp8 rung (``cyclone.data.dtype=float8``): K1 and K2 on e4m3 codes
   quantized on the card (``quantize_fp8``) with their per-column
   ``x_scale``, held against their float64 plain versions on the
   dequantized values with phase 3's checks, at the fit shapes and the
   ragged one, and timed (the bound: the bytes of the 1-byte codes);
12. LogisticRegression on the fp8 rung: phase 4's data (generated bf16 on
   the card) quantized on the card, fitted through K1's e4m3 instance and
   through the plain aggregator on identical codes: e4m3 launches equal to
   the evaluations and no bf16/f32 launch, no fp8 fallback, coefficients
   within rtol 5e-3 / atol 5e-4 and objectives to 1e-4 of each other, and
   within the reference's 20% fp8 envelope of the bf16 K1 fit on the same
   rows;
13. LinearRegression at configuration 2 on the fp8 rung through K2's e4m3
   instance, with phase 12's checks;
14. K3 and K4 on e4m3 codes with their x_scale, with phases 7 and 9's
   checks against float64 on the dequantized values, at the same shapes
   (KMeans and PCA are not fp8-capable: no fit launches these instances);
15. K1s (K1's sweep for K models over one X) against its plain version
   in float64 at the fit shape (float32 and bf16 X, bf16 labels beside
   bf16 X) and at the ragged shape with a third of the rows at w=0, for K
   in K1S_MODELS (20 > K_MAX: two launches), with and without centering:
   phase 3's checks per model, one launch per group counted under X's
   dtype and under the instance it picks (tensor cores for bf16 and e4m3,
   FMA for f32), and at K=1 K1s against K1 under the same bounds; times at
   every K beside the plain version, both bounds (the tensor-core one,
   B and the multipliers in three bf16 parts, and the f32-FMA figure) and
   two yardsticks the port never calls (K serial K1 launches, two cuBLAS
   f32 GEMMs);
16. OneVsRest at full width: 8 classes at 2,000,000 x 1280 (bf16;
   ``generate_multiclass``, bench_ovr_stacked's recipe, on the card),
   ``LogisticRegression(maxIter=25, regParam=0.01, tol=0)``,
   parallelism=8 through K1s (warm, steady), through the plain stacked
   aggregator and serially (8 fits through K1): K1s launched exactly once
   per stacked evaluation and K1 never in the stacked fit, coefficients
   within rtol 5e-3 / atol 5e-4 and objectives to 1e-4 of both, the
   predictions agreeing on >= 99.9% of rows; then the same rows quantized
   on the card, stacked through K1s's e4m3 instance;
17. CrossValidator over regParam {0.001, 0.01, 0.1} (3 folds,
   areaUnderROC) on phase 4's data cut to 250,000 rows at full width,
   stacked (K1s, once per evaluation of every fold's fit) and serial: the
   same best regParam, avgMetrics to 1e-4;
18. K1s's e4m3 instance with phase 15's checks on codes with x_scale;
19. LinearRegression through the WLS component (the normal solver) at
   configuration 2's data: a default ``LinearRegression()`` (auto resolves
   to normal, Cholesky) and ``solver="normal", regParam=0.001,
   elasticNetParam=0.5`` (OWL-QN over the moments). The moments against
   float64 moments of the same bf16 rows (|dA_ij| <= 1e-4 sqrt(A_ii A_jj),
   vectors and sums to 1e-5), both fits' coefficients within rtol 5e-3 /
   atol 5e-4 of the float64-moment solve, the elastic-net solution's
   objective, evaluated on the float64 moments, within 1e-4 of phase 6's
   K2 fit's (the objective the fit reports from float32 moments is
   printed beside it), no kernel launched; on the fp8 rung a
   default fit records exactly one precision fallback and launches
   nothing. The moments pass is timed beside its bound (2 n d^2 float32
   operations), with the host solve and the fits;
20. bounded binomial LogisticRegression on phase 4's data
   (``lowerBoundsOnCoefficients = 0``, regParam=0.01, maxIter=25, tol=0;
   L-BFGS-B with host line searches) through K1 and through the plain
   aggregator: K1 launched exactly ``total_evals`` times and no other
   kernel, every coefficient >= 0 exactly (the count at the bound
   printed), models within rtol 5e-3 / atol 5e-4 and objectives to 1e-4;
21. multinomial LogisticRegression on phase 16's data (8 classes,
   maxIter=25, regParam=0.01, tol=0, family auto): one evaluation of the
   plain multinomial aggregator against float64 on the same rows (loss to
   1e-5, gradient to 1e-4 of its largest entry), the fit warm and steady
   (no kernel), the share of its predictions that agree with phase 16's
   OneVsRest model, and the same rows quantized on the card, fitted within
   the 20% fp8 envelope of the bf16 fit;
22. LinearSVC on phase 4's data (regParam=0.01, maxIter=25): one hinge
   evaluation on the standardized copy against float64 (phase 21's
   bounds), the count of rows whose side of the hinge differs, the fit's
   time and peak memory beside X's bytes;
23. GeneralizedLinearRegression (poisson, log link) at 400,000 x 2,000
   bf16 (x from the seeded generator scaled by 1/sqrt(d), y ~ Poisson(
   exp(x.beta)) with beta from numpy): the first IRLS pass's XᵀWX against
   float64 (phase 19's rule), the coefficients within rtol 5e-3 / atol
   5e-4 of a float64 IRLS on the card with as many passes, the pass timed
   beside its bound, the summary's and the fit's times;
24. S1 and S2 (the sparse tier's row and column passes,
   ``csrc/ell_sweep.cu``) against their plain versions in float64 on
   Criteo-class rows drawn on the card (45,840,617 rows, the Criteo
   display-advertising training set's, x 39 slots: 13 integer fields at
   columns 0-12 with log1p(count), 26 categorical fields of zipf(1.1)
   ranks hashed into 2^20 columns; 1.79e9 nonzeros, 14.3 GB of ELL), one
   evaluation per link (logistic with a standardizing scale, squared,
   hinge, Gram) and the moments mode: |dloss| <= 1e-5 |loss|, max|dgrad|
   <= 1e-4 max|grad|, sum(w) exact, two launches bitwise equal; their
   times beside the plain versions, the bounds (bytes, and with one
   32-byte sector a gather) and cuSPARSE CSR SpMV (X beta, and X^T r
   over a copy in plain column order), each kernel and its yardstick in
   turns (kernel, library, library, kernel); the column copy's block
   size, blocks and pieces, and the share of S1's slots its hot-column
   table serves;
25. sparse LogisticRegression on those rows (``maxIter=25,
   regParam=0.01``): the column copy's set-up time and peak memory, a fit
   through S1 and S2 (S1 launched ``total_evals`` times, S2 once more for
   the summary, nothing else), a second one bitwise equal, and the plain
   aggregator's fit: objectives to 1e-4; the two again on the float64
   accumulator tier (``cyclone.compute.dtype=float64``): objectives to
   1e-4, coefficients within rtol 5e-3 / atol 5e-4 (on the float32 tier
   their distance is printed beside that of two plain fits, float32 and
   float64); the split into kernel and host time (``evals_device_s``),
   peak memory against the ELL's bytes, training AUC;
26. BASELINE configuration 5: ``RowMatrix.compute_svd(20, max_gram_dim=
   4096, tol=1e-9, max_iter=300)`` by Lanczos over the NYTimes-shape bag
   of words (300,000 x 102,660, 232 slots, the reference's numpy recipe),
   one Gram matvec (S1 then S2) against float64 and bitwise repeatable,
   S1 and S2 once per Lanczos step, all 20 singular values within 5e-3 of
   scipy's float64 svds on the same CSR (times of both printed); S1's and
   S2's times at this shape, and the SVD's time split into the steps'
   kernel time and the rest;
27. the rest of RowMatrix on phase 10's data: Lanczos
   (``compute_svd(10, max_gram_dim=1024)``) within 1e-4 of the Gramian
   branch, ``multiply`` by a seeded 2,000 x 64 matrix within 1e-5 of
   float64, ``column_similarities`` within 1e-5 of the float64 Gramian's
   cosines (K4 once per Gramian);
28. the wide instances of K1 and K2 (2,048 < d <= 12,288: one read of
   X, a row's slots over a CTA's 512 threads) against their plain versions
   in float64 on the card, with phase 3's limits plus sum(mult) to 1e-4 of
   sum(w), counted as wide: at 1,281,167 x 4,096 (ImageNet-1k's training
   set through VGG-16's 4,096-wide fc7) in bf16 and e4m3 with x_scale, at
   500,000 x 4,096 in f32, and at the ragged 100,003 x 2,049, 100,003 x
   5,000, 250,000 x 8,192 and 100,003 x 12,288 in all three; at 50,003 x
   12,289 in all three the two-pass instance (two passes over X by column
   block), with the same checks, counted as two-pass; times at the
   full-width shapes and at 8,192 and 12,288 columns beside the plain
   version (f32), the bound (one read of X), two cuBLAS gemvs and the wide
   plan, and (but at 8,192) beside the two-pass instance;
29. the wide K1s (a cluster of CTAs over the columns, 16 models a launch;
   the two-pass instance for f32) with phase 15's checks (and sum(mult) to
   1e-4 of sum(w)) at 50,000 x 3,072 with K = 8, 2 and 10 (CIFAR-10's
   OneVsRest) and 250,000 x 8,192 with K = 8 and 16, in bf16, e4m3 and
   f32, timed beside the plain version, the bound, the yardstick X B^T
   plus M^T X and, at K = 8, the two-pass instance (groups of 8); at
   50,000 x 8,193 with K = 10 the two-pass instance in all three dtypes
   (two groups of 8 and 2 on the tensor cores), checked and not timed;
30. binomial LogisticRegression (phase 4's settings) on
   ``generate_classification`` at 1,281,167 x 4,096, bf16 (10.5 GB of X),
   through K1's wide instance and through the plain aggregator, warm and
   steady: the wide K1 launched exactly ``total_evals`` times and no
   narrow one, coefficients within rtol 5e-3 / atol 5e-4, objectives to
   1e-4, a bitwise-equal refit, peak memory;
31. LinearRegression at configuration 2's settings (OWL-QN) on
   ``generate_regression(seed=11, noise=0.1)`` at 1,281,167 x 4,096, bf16,
   through K2's wide instance, phase 6's checks;
32. OneVsRest at CIFAR-10's size (``generate_multiclass`` at 50,000 x
   3,072, 10 classes, bf16, class centers at CIFAR_CENTER_SCALE so that the
   classes overlap as CIFAR-10's do; phase 16's classifier) through the
   wide K1s (one launch of the 10 classes a stacked evaluation), through
   the plain stacked aggregator and serially (10 fits through the wide
   K1), phase 16's checks;
33. the float32 tier's sparse intercept: phase 25's fits (float32 kernel,
   float32 plain, float64 plain) on Criteo-class rows drawn at seed 1 (seed
   2 dropped to make room for phases 55-62), cut to an eighth of the rows, their distances and the iteration
   where their objectives part printed, the objectives held to 1e-4; and
   (in phase 25) one evaluation at the float64 plain fit's solution
   through the kernels against float64, the intercept's gradient to 1e-6
   of sum(w);
34. the ALS normal equations (``csrc/als_normal.cu``, the reference's
   scatter-add of outer products, not a Pallas kernel) at BASELINE
   configuration 4's full shape: benchmarks/als_scale.py's ratings (a copy
   of its ``make_data``: 162,541 users x 62,423 items, 25,000,095 planted
   rank-64 ratings, numpy ``default_rng(7)``; 1M held out by
   ``default_rng(3)``), rank 64, both half-steps, explicit and implicit
   (alpha = 1), on random factors: the float32 kernel (tensor cores,
   3xTF32) and the earlier float32 design (FMAs, ``instance="fma"``)
   against the float64 plain twin (|dA_ij| <= 1e-5 sqrt(A_ii A_jj),
   |db| <= 1e-5 of the row's sum |bw| |v|), the float64 kernel within
   1e-12, counts exact, A == A^T bitwise, two launches bitwise equal; the
   two float32 designs timed in turns, the device time by CUDA events
   around each launch (torch.profiler's beside it), both bounds (the
   tensor cores': bytes or the 3xTF32 products at 495 TFLOP/s, with the
   share against it; the FMA design's: its operations at 67 TFLOP/s), the
   float32 plain twin and a yardstick (torch.bmm of the zero-padded
   gathered rows, f32, TF32 off); ptxas's registers and 0 spills in all
   six ALS kernel instances;
35. explicit ALS as als_scale.py runs it (``ALS(rank=64, regParam=0.02,
   seed=2, maxIter=12)``) through the kernel: the fit's time split (host
   np.unique, the orders, the normal equations, the solves, the rest),
   2 x maxIter launches and no other kernel, a second fit bitwise equal,
   the train and held-out RMSE on the two 1M probes (held-out in [0.30,
   0.36], printed beside the reference's 0.3430), peak memory, and the
   kernel fit within 1e-4 (norm-relative) of the plain fit at maxIter=2;
36. implicit ALS (alpha = 1, maxIter=5) on the same ratings: the split and
   the time per iteration, the launches, a bitwise refit, the kernel fit
   against the plain fit at maxIter=2; then ``nonnegative=True`` at
   maxIter=2: every factor >= 0, the time of a half-step's projected
   Newton solve;
37. data in, the sparse reader (files in a temporary directory on local
   disk, its free space printed first, removed at the end and on
   failure): ``generate_criteo_like(seed=0)`` cut to INGEST_N rows (2^20
   columns, 39 slots) written as a libsvm file (every ELL slot, id + 1
   and the value's shortest float32 text, formatted on the card); the
   native scanner built first (its g++ seconds printed apart from the
   reads); the file read back by ``read_libsvm_sparse`` with 1 and 4
   readers: indices, values,
   labels and weights bitwise equal to the generated rows, every read
   served by the native scanner, the seconds, MB/s and rows/s, the split
   (parse, host work, copies, device assembly, the copies' share hidden
   behind the parse), peak device memory within twice the dataset plus
   one chunk, the host's peak RSS; then phase 25's fit on the read rows
   through S1 and S2 (launches counted), bitwise equal to the fit on the
   generated rows;
38. data in, the dense readers: configuration 2's rows
   (``generate_regression(seed=11, noise=0.1)``) as a float32 .npy file
   with the label last, read by ``read_npy_chunked``: X bitwise equal to
   ``from_numpy`` of the same rows and to the generated X; phase 6's
   LinearRegression on it through K2 (once per evaluation), bitwise equal
   to the fit on ``from_numpy``'s dataset; EPS_N x EPS_D dense rows at
   epsilon's layout (0/1 labels) as a libsvm file, read streamed and
   whole (``read_libsvm``), both bitwise equal to ``from_numpy`` of the
   parsed rows, and phase 4's LogisticRegression settings on them through
   K1 (once per evaluation), bitwise equal to the fit on ``from_numpy``'s;
   a CSV file of CSV_N x CSV_D through ``read_csv_chunked`` and
   ``read_csv``, equal; each reader's seconds and MB/s, peak memory
   within twice the dataset plus one chunk;
39. models out: every model the run fitted (phases 4, 6, 8, 10, 16, 17,
   22, 23 and 35) and a ``Pipeline([PCA(k=PIPE_K), LogisticRegression])``
   fitted on phase 4's data cut to CV_N rows (K4 once, K1 once per
   evaluation) saved and loaded: loaded arrays bitwise equal to the saved
   ones, transform outputs bitwise equal on each model's first PROBE_ROWS
   rows (every model transforms on the host), ALS's held-out RMSE the
   same number; save and load seconds and bytes;
40. out of core, LogisticRegression streamed under ``cyclone.oocore.
   mode=force`` at bench.py's shape (phase 4's data, seed 0, 31 shards of
   65,536 rows on disk, staged through pinned buffers; tol OOC_TOL for
   this and the next four phases): K1 once a shard an evaluation, the
   model at the kernel tolerance of the in-core K1 fit (objective to
   1e-4), a second streamed fit (attached to the cached spill) bitwise
   equal, its peak device memory within (prefetchDepth + 1) shards plus
   the fit's vectors, the epochs' split (host reads, copies, the copies'
   hidden share, the shards' device time);
41. configuration 2's .npy (phase 38's) straight to shards through
   ``iter_npy_chunks`` and ``StreamingDataset.from_chunks`` (no in-core
   dataset), phase 6's OWL-QN LinearRegression streamed through K2: K2
   once a shard an evaluation, the same peak bound, the model at the
   kernel tolerance of phase 38's in-core fit on the read rows;
42. the memory budget guard: ``budgetFraction`` set, ``deviceBytes``
   below the in-core fit's predicted peak, ``cacheBytes`` above the
   spill: phase 40's fit degrades to streaming and is phase 40's model
   bit for bit, a second fit attaches with 0 spill-write bytes, and under
   ``mode=off`` with ``budgetAction=raise`` the fit raises
   MemoryBudgetError;
43. the e4m3 stream (``streamDtype=float8``): phase 40's fit through K1's
   e4m3 instance once a shard, within the fp8 envelope of the in-core
   fp8 fit and of phase 40's streamed bf16 fit, printing which it is
   closer to;
44. streamed stacked OneVsRest: OVR_K classes at d = 1280, rows cut to
   OOC_OVR_N, through K1s once a shard a lockstep evaluation, the first
   OOC_SERIAL models each at the kernel tolerance of its serial streamed
   fit;
45. the BLAS dispatch boundary (``linalg/blas.py``): ``BLAS.gemm`` and
   ``BLAS.gemv`` on ``DenseMatrix`` at the reference's GEMM sizes (1,024,
   2,048 and 4,096 square) against numpy float64 to 1e-5 of |A||B|
   (|A||x|), the routing counts (the card above ``DEVICE_FLOPS_THRESHOLD``,
   the host below: a 1,024 gemv and a 64 x 64 gemm), each call's time with
   the host<->device copies the boundary makes beside ``torch.matmul`` on
   resident float32 tensors; a 4,096 x 4,096 ``BlockMatrix.multiply``
   (one padded tensor on the card) against float64;
46. BisectingKMeans at configuration 3's shape (10,000,000 x 128 bf16, 64
   planted centers placed as a binary tree plus N(0, 1) noise, drawn on
   the card; ``k=64, maxIter=20, seed=3``): the sums of every pass and the
   children's counts and costs of every level through the center sums
   (passes + 2 a level launches, nothing else), two fits bitwise equal, a
   float64 fit on the same rows through the plain ``index_add_`` sums
   giving the same tree with leaf centers within rtol 5e-3, atol 5e-4,
   every planted center within 0.5 of a leaf of its own, and a cosine fit
   on the first 1,000,000 rows;
47. GaussianMixture: 16 planted components (means ~ N(0, 1) a column,
   noise scales in [0.5, 1.5]) at 2,000,000 x 128 bf16, ``k=16,
   maxIter=20, tol=0.01``: the E-step in row chunks on torch products (no
   kernel), the mean log-likelihood within 1e-4 (relative) of a float64
   fit on the same rows, weights and means within rtol 5e-3, atol 5e-4 of
   it, two fits bitwise equal, peak device memory against X plus two
   chunks' intermediates; the planted means within 0.1 of a fitted mean
   are counted and printed (EM from the reference's sampled start does
   not part 16 components in 20 iterations);
48. LDA at the Enron shape of UCI's "Bag of Words" (39,861 documents x
   28,102 terms, ~6.4M tokens) drawn from LDA's generative process with 20
   planted topics (``k=20, maxIter=20``): the default online fit
   (``subsamplingRate=0.05``) twice, bitwise equal; a fit at rate 1.0
   against a float64 fit, ``log_perplexity`` on the first 4,096 documents
   within 1e-4; the largest count (bf16 holds integers exactly up to
   256); the overlap of each planted topic's top 10 terms with the fitted
   topics' printed;
49. PowerIterationClustering at SNAP com-Youtube's shape (1,134,890
   vertices, 2,987,624 edges, two planted communities; ``k=2,
   maxIter=20``): S2 once per power-iteration step over the one-slot ELL
   of the 5,975,248 directed edges, two runs bitwise equal, the embedding
   within 1e-5 (relative to its largest entry) of a float64 ``index_add_``
   power iteration on the card with as many steps, the purity of the
   planted communities printed;
50. model serving (``ModelServer``, maxBatch 64, windowMs 5; each bucket
   one CUDA graph: the copy of the pinned request rows in, the
   ``serving_margins`` kernel of ``csrc/serving_margins.cu``, the copy of
   the margins out): serial lanes for phase 16's class-0 model (d =
   1,280), phase 21's multinomial model (8 x 1,280) and phase 6's
   LinearRegression (2,000); gangs of phase 16's 8 models, f32 and e4m3,
   and of phase 32's 10 CIFAR-10 models (3,072); a float64 lane. 8
   clients send 250 requests each of 1-64 rows (lanes, sizes and rows
   from ``np.random.default_rng(50)``), and one request of 300 rows
   splits into 64-row sub-requests: 7 graphs captured a lane at
   registration and none by the traffic, ``torch.cuda.memory_allocated``
   equal before and after it, one launch (graph replay) a dispatch,
   every served label the model's own predict's but on rows within 1e-6
   (of the margin scale) of a decision boundary, counted apart, the
   regression within 1e-6 of float64; a row's margins equal bits in
   buckets 1, 64 and 3-of-64, the gangs' margins the bits of serial lanes
   of their members, the kernel its plain twin's bits on every lane's
   shape at every bucket, f32 and f64, plain and e4m3, the e4m3 margins
   within 0.06 of the margin scale; a transient fault retried to the right
   answer, a permanent one a 5xx while the lane serves on, a tiny budget
   queueing then shedding with 503. By bucket: a dispatch through the
   graph and through the same three steps launched eagerly (CUDA events,
   host wall time), the kernel alone against its bound, the plain twin,
   ``torch.addmm`` (the library call) and ``torch.matmul`` (the
   yardstick), and the rows whose addmm bits differ between buckets 1 and
   64; request latency p50/p95/p99, rows a second, batches and coalesced
   requests; the span tracer on over the traffic, and the slowest
   requests split by their spans (queue, dispatch, the lane's dispatches
   while queued) beside the garbage collector's pauses; then the kernel
   (the tiled design) against its twin bit for bit at buckets 128-1,024
   on the CIFAR-10 gang, each bucket's tile plan printed;
51. the names the port had lacked in files counted as ported (ROADMAP
   Queue 1 item 14), on the card: phase 4's model ``evaluate``s a seeded
   held-out frame of 100,000 x 1,280 drawn from its training
   distribution, its area under ROC equal to a float64 numpy trapezoid
   over the same probabilities within 1e-12 and above 0.8;
   ``InstanceDataset.persist_host``/``release_device`` then ``persist()``
   bring X, y and w back bitwise and ``torch.cuda.memory_allocated`` back
   to its level, having freed the padded bytes; ``ctx.broadcast(...)
   .device_value`` lives on the card; ``parallelize(...).tree_aggregate``
   and an accumulator inside ``run_job`` (its counters and its ``job``
   span); ``cyclone.compute.matmulPrecision`` 'highest' leaves
   ``torch.backends.cuda.matmul.allow_tf32`` False after a fit, and a
   loss function's aggregations run with it off under 'highest' and on
   under 'default', the caller's value back after each;
52. checkpointed LogisticRegression at the main path's shape (phase 4's
   data and fit, ``checkpointDir`` with ``checkpointInterval=2``: the
   host L-BFGS, K1 once per evaluation): an uninterrupted checkpointed
   fit; a fit that a ``FaultSchedule`` crashes with ``MidSaveCrash`` at
   the second ``checkpoint.commit`` (step 2 committed, no partial step
   visible); its resume from step 2, whose coefficients, iterations and
   objective history are bitwise the uninterrupted fit's; the newest
   ``state.pkl`` truncated, a resume from the step before (bitwise
   again); every step damaged, ``CheckpointCorrupt``; a directory of
   another dataset (250,000 rows, seed 7) refused on its fingerprint; the
   K1 launches of each fit, the seconds in ``checkpoint`` spans against
   the fit's wall-clock, the bytes a save writes;
53. checkpointed ALS at configuration 4 (phase 35's fit, the same
   training ratings, ``checkpointInterval=4``): a crash at the second
   commit (iteration 8), the resume from iteration 4, its factor matrices
   bitwise phase 35's model's, ``als_normal`` launched 2 x (12 - 4) =
   16 times; each save's and commit's seconds and bytes;
54. the storage tiers: two seeded 2M x 1280 bf16 datasets under
   ``cyclone.storage.deviceBudget`` = 1.5 x one's ``padded_bytes()``; the
   hot one cached for phase 4's fit demotes the cold one to HOST
   (``torch.cuda.memory_allocated`` falls by its padded bytes), the fit
   bitwise the same fit with no budget, K1 once per evaluation; touching
   the cold dataset brings it back bitwise at DEVICE (the hot one demoted
   in turn); then the DISK tier's round trip (``persist_disk``, then the
   first access) at 250,000 x 1280 in bf16 and in e4m3 codes with
   ``x_scale``: X, y and w back bitwise, the seconds and bytes (files in
   a temporary directory, removed at the end);
55. trees at HIGGS's shape (UCI HIGGS: 11,000,000 x 28, drawn on the card
   from seed 23, a nonlinear label; bf16 X) through ``tree_hist``
   (``csrc/tree_hist.cu``): the DecisionTreeClassifier at Spark's defaults
   (maxDepth 5, maxBins 32), each fit's seconds split into binning, the
   host counts, the channels, the histogram's device time (CUDA events),
   the host split search, reassign and the rest, ``tree_hist`` launches
   and ms by level; a second fit with every level's table held against
   the plain twin in float64 (counts exactly, sums to rtol 1e-5 of the
   sums of absolute values), bitwise equal to
   the first; the plain route's fit (``usePallasKernels=false``) with the
   same trees; then tree_hist at level 0 timed beside its twin, the
   counting sort alone, ``index_add_`` over the same flat keys, its
   instance (``kernels.tree_hist_plan``) and the bytes bound at 3.35
   TB/s with the bins at their stored width (one byte) and at int32;
   then tree_hist at HIGGS's rows past the fits' widths, at level 0 and
   at a_pad 32: maxBins 256 with 11 channels (the lane-a-bin instance)
   and maxBins 257 on int32 bins (lane a row), each table against the
   twin in float64, each launch counted by its instance, its ms beside
   its bound;
56. the RandomForestClassifier (20 trees, bootstrap, "auto" subsets) with
   phase 55's checks, its level 0 timed (20 trees a launch);
57. the GBTClassifier (maxIter 20, stepSize 0.1) on the first 2,750,000
   rows (a quarter: its host residual loop took 82.6 s at 11M) with phase
   55's checks but the plain route (its regression trees' float32 sums
   follow the summation order), and its host residual loop's seconds;
58. the DecisionTreeRegressor on the label's continuous function, with
   phase 57's checks;
59. the MultilayerPerceptronClassifier at MNIST's shape (60,000 x 784,
   784-300-10, L-BFGS maxIter 100) on the default tiers and the float64
   tier over the same values: the first five objectives within 1e-3, the
   train accuracies within 0.02;
60. multinomial NaiveBayes at 2,000,000 x 1,280 (counts 0-3, 10 classes):
   theta and pi within 1e-9 of the float64 fit's;
61. the FMClassifier (factorSize 8, adamW, stepSize 0.01) at 2,000,000 x
   1,280 (phase 4's generator): the first ten objectives within 1e-4 and
   the last within 1e-2 of the float64 fit's;
62. AFTSurvivalRegression at 1,000,000 x 10 against its float64 fit
   (coefficients within 1e-2, bf16 X) and IsotonicRegression at
   1,000,000 rows held to the isotonic fit's characterization;
63. GraphX's PageRank through ``segment_reduce`` (``csrc/
   segment_reduce.cu``) on an R-MAT graph drawn on the card with Spark's
   rmatGraph quadrant probabilities (0.45, 0.15, 0.15, 0.25): 2^22
   vertices and 68,993,773 distinct edges (SNAP soc-LiveJournal1's edge
   count); the graph's build (both orders and their piece tables), 20
   supersteps with segment_reduce launched once each and once for the
   degrees (counts zeroed just before, read just after), their kernel
   device time by CUDA events beside the messages' gather; the ranks
   within rtol 1e-5 of the float64 plain route's, two runs bitwise equal,
   the personalized form likewise; the kernel at PageRank's messages
   against its float64 plain version (one float rounding), its ms, the
   piece table's, the bytes bound, ``index_add_`` and
   ``torch.segment_reduce`` on the same inputs, and the longest segment
   alone;
64. connected components and shortest paths (4 landmarks) on phase 63's
   graph: labels and distances exactly the plain route's, the supersteps
   and launches (two a CC superstep, one a shortest-paths one);
65. SVD++ at rank 10, 10 iterations, on configuration 4's training
   ratings (users then items as vertices; minVal and maxVal the ratings'
   range): factors and RMSE within 1e-4 of the float64 plain route's, two
   runs bitwise equal, 63 launches, seconds an iteration;
66. triangle counts and SCC at 16,384 vertices on an R-MAT graph of 16
   edges a vertex (triangles against a float64 product, SCC against
   scipy's Tarjan, exactly), label propagation at 4,096 vertices
   (n-wide one-hot rows) exactly the plain route's;
67. Word2Vec at text8's width (vectorSize 100, windowSize 5, negative 5,
   batches of 8,192, minCount 5) on 2,000,000 tokens drawn from a
   Zipf(1) law over 71,290 word types, stepSize 0.0025 (the reference's
   0.025 diverges on such a corpus in both packages): one epoch of
   negative sampling (twice, bitwise) and of hierarchical softmax, three
   and two accumulate launches a step, the host vocabulary and pairs, the
   steps and the kernel's device time; one step against the float64
   plain step (within 1e-6 of the update), the HS loss within 1e-3 of the
   float64 plain fit's; the accumulate form at the negatives' shape
   beside ``index_add_``;
68. a pipeline on 1,000,000 rows of UCI Adult's schema (6 numeric
   columns, 8 categorical with Adult's cardinalities): StringIndexer,
   OneHotEncoder, VectorAssembler, StandardScaler, UnivariateFeatureSelector
   and LogisticRegression on K1 (once an evaluation), each stage's
   seconds, the model within the main path's limits of the plain route's;
69. a ``{"kernels": [...]}`` JSON line with K1-K4, K1s, their e4m3
   instances, the wide instances of K1, K2 and K1s (marked as redesigned
   for one read of X, with the two-pass instance's time from the same
   run), the center sums (marked as redesigned: the counting sort and
   one warp a piece, with the sorted instance's time from the same run)
   and S1/S2 (K3, K4 and K1s marked as redesigned for
   the tensor cores, with their instance, f32 FMA bounds and ptxas lines;
   K2 in both instances and K1's e4m3 instance marked as redesigned around
   a per-lane cp.async ring, and every GLM sweep with its instance, ring
   plan and ptxas lines; K1's entry also carries its launches in phase
   20's bounded fit) and the ALS normal equations (phase 35's launches,
   the users' half-step's times, the items' beside them), with the
   launches of phases 37-39's paths beside the entries they ran (K1, K2,
   K4, S1, S2), of phases 40-44's (K1, K2, K1 e4m3, K1s) and of phases
   46 and 49's (the center sums, S2), the serving margins of phase
   50 (graph replays in the traffic, the instance each lane ran), and
   phases 52-54's K1 launches (the checkpointed, resumed, fallback and
   budgeted fits) and ``als_normal``'s (the resumed ALS fit), and
   ``tree_hist`` with its launches (and by instance) in phases 55-58,
   both bounds and its share, phase 55's wide cases' ms beside their
   bounds, ``segment_reduce`` with its launches in phases 63-67 and by
   instance, the phases' and the
   total wall time; the last line is
   ``{"ok":
   true, "device": {...}}``.

Phases 19-23 begin by asserting that TF32 is off.

Each path's launch counts are set to 0 just before its fit and read just
after. It exits non-zero, printing no result, when no CUDA device is
present or when the port's package is not beside it.
"""

from __future__ import annotations

import ctypes
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

FIT_N, FIT_D = 2_000_000, 1280
RAGGED_N, RAGGED_D = 1_000_003, 1000
LIN_N, LIN_D = 400_000, 2000                  # configuration 2 (epsilon)
KM_N, KM_D, KM_K = 10_000_000, 128, 1000      # configuration 3
KM_RAGGED = (1_000_003, 100, 37)
GRAM_N, GRAM_D = 400_000, 2000                # PCA at the epsilon width
GRAM_RAGGED = (300_007, 777)
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
H100_TF32_FLOPS = 495e12     # TF32 tensor cores, dense
H100_FP8_FLOPS = 1979e12     # fp8 tensor cores, dense
FP8_COEF_NORMREL = 0.20      # the reference's fp8 coefficient envelope
KERNEL_SOURCES = ["glm_sweep", "kmeans_assign", "gramian", "glm_stacked",
                  "center_sums", "ell_sweep", "als_normal", "serving_margins",
                  "tree_hist", "segment_reduce"]
K1S_MODELS = (1, 3, 8, 16, 20)   # 20 > K_MAX: two launches of K1s
OVR_K = 8                        # OneVsRest's classes (bench_ovr_stacked)
CV_N = 250_000                   # CrossValidator's rows (the cut of FIT_N;
                                 # 500,000 rows took 35 s of the run)
CV_REGS = (0.001, 0.01, 0.1)
# (iterations, evaluations) of the sweep's fits at these configurations
# when its lanes summed the gradient with a Kahan step a row (PERF.md §6);
# the block order may move them, and a move past 2 is explained there
ROW_ORDER_COUNTS = {"fit": (9, 10), "linreg_fit": (6, 37),
                    "fp8_fit": (9, 10), "fp8_linreg_fit": (6, 37)}
CRITEO_N = 45_840_617   # rows of the Criteo display-advertising training set
CRITEO_D = 1 << 20      # hashed columns (the reference demo's default width)
NYT_N, NYT_D, NYT_K = 300_000, 102_660, 232   # configuration 5 (NYTimes)
NYT_SV = 20                                   # its singular values
MULTIPLY_COLS = 64
# the wide slice (d > 2048): a linear probe on VGG-16 fc7 features (4,096
# wide) over ImageNet-1k's training set, and CIFAR-10's OneVsRest
WIDE_N, WIDE_D = 1_281_167, 4096
WIDE_F32_N = 500_000             # f32 X at the probe's width (8.2 GB)
# ragged shapes, one of each thread shape of the one-read instance (E = 8,
# 16, 24); 12,289 columns take the two-pass instance
WIDE_RAGGED = ((100_003, 2049), (100_003, 5000), (250_000, 8192),
               (100_003, 12_288), (50_003, 12_289))
CIFAR_N, CIFAR_D, CIFAR_K = 50_000, 3072, 10
# class centers N(0, 0.02^2 I), about 1.6 sigma apart (0.02 sqrt(2 d)), so
# that the classes overlap as CIFAR-10's do for a linear model (the fit's
# training accuracy is printed); the generator's default 3.0 would set
# them ~235 sigma apart at this width, every class separable
CIFAR_CENTER_SCALE = 0.02
# past 8,192 columns (checked, not timed) the two-pass instance, in
# groups of 8 on the tensor cores
K1S_WIDE = ((CIFAR_N, CIFAR_D, (8, 2, 10)), (250_000, 8192, (8, 16)),
            (CIFAR_N, 8193, (10,)))
CRITEO_SEEDS = (1,)              # the intercept inquiry's one more draw
#                                  (seed 2 dropped for the tree phases' time)
CRITEO_SEED_N = CRITEO_N // 8    # ... cut to an eighth of the rows (the
                                 # phase's time; a quarter took 25 s)
# BASELINE configuration 4: ALS at MovieLens-25M's shape, benchmarks/
# als_scale.py's planted rank-64 ratings and split
ALS_USERS, ALS_ITEMS, ALS_NNZ = 162_541, 62_423, 25_000_095
ALS_RANK, ALS_NOISE, ALS_HELD = 64, 0.3, 1_000_000
ALS_REG, ALS_SEED = 0.02, 2      # als_scale.py's ALS(regParam, seed)
ALS_ITERS = 12                   # ... and its default iterations
ALS_IMPLICIT_ITERS = 5
ALS_CHECK_ITERS = 2              # the kernel fit against the plain fit
ALS_HELDOUT_RANGE = (0.30, 0.36)  # the noise floor is 0.3
# the reference's held-out RMSE after 12 iterations (BASELINE.md):
# accuracy, printed beside the port's
ALS_REFERENCE_HELDOUT_RMSE = 0.3430
# data in and models out: the readers and persistence
INGEST_N = 4_000_000             # Criteo-class rows written and read back
INGEST_READERS = (1, 4)          # read_libsvm_sparse's n_readers
EPS_N, EPS_D = 50_000, 2000      # epsilon's layout, rows cut
CSV_N, CSV_D = 50_000, 129       # a label and 128 features
PIPE_K = 32                      # the Pipeline's PCA components
OOC_TOL = 1e-6                   # the streamed phases' LR/OvR tol
OOC_OVR_N = 500_000              # the streamed OneVsRest's rows (cut)
OOC_SERIAL = 3                   # its models held to serial streamed fits
BLAS_SIZES = (1024, 2048, 4096)  # the reference's GEMM sizes (benchmarks/
                                 # run_benchmarks.py:134)
BKM_N, BKM_D, BKM_K = KM_N, KM_D, 64  # BisectingKMeans: configuration 3's
BKM_COSINE_N = 1_000_000              # shape; the cosine fit's rows (cut)
GMM_N, GMM_D, GMM_K = 2_000_000, 128, 16  # GaussianMixture (rows cut)
LDA_DOCS, LDA_VOCAB = 39_861, 28_102  # UCI Bag of Words, Enron
LDA_TOKENS, LDA_TOPICS = 6_400_000, 20
LDA_PROBE = 4096                 # documents log_perplexity is taken on
PIC_VERTICES, PIC_EDGES = 1_134_890, 2_987_624  # SNAP com-Youtube
# model serving (phase 50): the reference's maxBatch and windowMs, 8
# clients of 250 requests of 1-64 rows each, one request of 300 rows
SERVE_BATCH, SERVE_WINDOW_MS = 64, 5.0
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_BIG = 8, 250, 300
SERVE_SEED = 50
SERVE_POOL = 4096                # seeded request rows drawn a width
SERVE_GRAPH_LAUNCHES = 50        # kernel launches a timing graph holds
SERVE_SLOWEST = 3                # slowest requests split by their spans
SERVE_QUANT_ENVELOPE = 0.06      # the reference's e4m3 margin envelope
H100_F64_FLOPS = 34e12           # f64 outside the tensor cores (data sheet)
PROBE_ROWS = 4096                # rows each kept model transforms
TEXT_BLOCK_BYTES = 1 << 28       # token bytes formatted on the card at once
# the models the run fits and the persistence phase saves and loads
PERSISTED = ("LogisticRegression", "LinearRegression", "KMeans", "PCA",
             "OneVsRest", "CrossValidator", "LinearSVC",
             "GeneralizedLinearRegression", "ALS", "Pipeline")
_FITTED = {}                     # name -> (model, probe columns)
_MAIN_MODEL = {}                 # phase 4's LR ("lr") and 35's ALS ("als")
HOLD_N, HOLD_STREAM = 100_000, 1 << 20  # phase 51's held-out rows
# checkpointed training and the storage tiers (phases 52-54)
CK_LR_INTERVAL = 2               # phase 52's checkpointInterval
CK_ALS_INTERVAL = 4              # phase 53's: saves at 4 and 8 of 12
CK_FOREIGN_N = 250_000           # phase 52's other dataset's rows
TIER_BUDGET = 1.5                # phase 54's device budget, in datasets
DISK_N = 250_000                 # phase 54's DISK round trip's rows
SERVE_TWIN_BUCKETS = (128, 256, 512, 1024)  # phase 50's large buckets
DEVICE = "cuda"
ROWS = 1 << 18               # rows generated or checked at a time
ROWS64 = 1 << 16             # rows widened to float64 at a time


def _line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


# seconds of wall time each phase_* function took (a phase that calls
# another includes it), printed by main as the phase_seconds line
_PHASE_SECONDS = {}


def _time_phases() -> None:
    """Wrap every phase_* function of this module so that its calls add
    their wall time to _PHASE_SECONDS."""
    g = globals()
    for name, fn in list(g.items()):
        if name.startswith("phase_") and callable(fn):
            def timed(*args, _fn=fn, _name=name, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    _PHASE_SECONDS[_name] = (_PHASE_SECONDS.get(_name, 0.0)
                                             + time.perf_counter() - t0)
            g[name] = timed


def _time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, reps: int, match: str):
    """The device time per call of the kernels whose name holds ``match``,
    by torch.profiler over ``reps`` calls after two: what CUDA events
    around a call would also count as the host's time where the call's
    host work outlasts its kernels. None when the profiler saw no device
    time for them (a ``profiler_no_match`` line then names what it saw)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    us = sum(getattr(e, "device_time_total", 0.0)
             for e in events if match in e.key)
    if us <= 0:
        seen = sorted(((getattr(e, "device_time_total", 0.0), e.key[:80])
                       for e in events), reverse=True)[:5]
        _line("profiler_no_match", match=match, events=len(events),
              top_device_keys=seen)
    return us / reps / 1000.0 if us > 0 else None


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "not measured (nvidia-smi gave nothing)"
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    kind = torch.cuda.get_device_name(0)
    _line("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0])
    return card, kind


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel instance: its X (or partial)
    dtype and its other template arguments (glm_sweep_kernel: elements
    per lane and the link, 0 logistic, 1 squared; glm_wide_margin_kernel:
    the link; glm_wide_fma_*: models per launch; glm_stacked_kernel:
    columns per thread and models per launch; glm_stacked_tc_kernel:
    k-blocks per warp, models per launch and, for the wide instance, the
    CTAs of its cluster; glm_sweep_wide_kernel: elements per thread and
    the link; center_warp_kernel: w's dtype and X's loads; count_scatter_kernel: the bits of k - 1;
    gramian_tc_kernel: the staging; kmeans_assign_tc_kernel: whether X is
    resident; segment_pieces_kernel and segment_merge_kernel: the rows'
    dtype and the merge)."""
    m = re.search(r"([a-z_]+_kernel)(I(13__nv_bfloat16|13__nv_fp8_e4m3|f|d)?"
                  r"(f|d)?((?:L[ib]\d+E)*))?", mangled)
    if m is None:
        return mangled
    if m.group(2) is None:
        return m.group(1)
    if m.group(1).startswith("ell_"):  # S1's link, S2's mode or width
        arg = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(5))]
        label = {"ell_rows_kernel": ("logistic", "squared", "hinge", "gram"),
                 "ell_cols_piece_kernel": ("gradient", "moments")}.get(
                     m.group(1))
        text = label[arg[0]] if label else f"M={arg[0]}"
        if len(arg) > 1 and arg[1]:
            text += ", scaled"
        return f"{m.group(1)}<{text}>"
    if m.group(1) == "als_tc_kernel":  # up to rank 64, or its tile pairs
        tiled = re.findall(r"Lb(\d)E", m.group(5))[0] == "1"
        return ("als_tc_kernel<64 x 64 tile pairs>" if tiled
                else "als_tc_kernel<rank <= 64>")
    if m.group(1) in ("serving_margins_kernel", "serving_direct_kernel"):
        # its dtype, e4m3 or not, and a staged tile's rows x margins a warp
        dtype = {"f": "f32", "d": "f64"}.get(m.group(3), "?")
        q = re.findall(r"Lb(\d)E", m.group(5) or "")
        tile = re.findall(r"Li(\d+)E", m.group(5) or "")
        return (f"{m.group(1)}<{dtype}"
                f"{', e4m3' if q and q[0] == '1' else ''}"
                f"{', ' + 'x'.join(tile) if tile else ''}>")
    if m.group(1) in ("tree_rows_kernel", "tree_bins_kernel"):
        # the bins' width; channels (lane a row: exactly, or at most) or
        # bins a lane a pass (lane a bin)
        t = re.search(m.group(1) + r"I([hi])Li(\d+)E(?:Lb(\d)E)?", mangled)
        arg = ("NS=" if m.group(1) == "tree_bins_kernel" else
               "C=" if t.group(3) == "1" else "C<=")
        return (f"{m.group(1)}<{dict(h='uint8', i='int32')[t.group(1)]}, "
                f"{arg}{t.group(2)}>")
    if m.group(1) in ("segment_pieces_kernel", "segment_merge_kernel"):
        # the rows' dtype and the merge
        t = re.search(m.group(1) + r"I([ifd])Li(\d)E", mangled)
        dtype = dict(i="i32", f="f32", d="f64")[t.group(1)]
        merge = ("sum", "min", "max")[int(t.group(2))]
        return f"{m.group(1)}<{dtype}, {merge}>"
    if m.group(1) == "count_scatter_kernel":  # the bits of k - 1
        return f"{m.group(1)}<bits={re.findall(r'Li(\d+)E', m.group(5))[0]}>"
    names = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16",
             "13__nv_fp8_e4m3": "e4m3"}
    # the FMA K1s instance takes float32 X only: no type argument
    args = [names[m.group(3)] if m.group(3) else "f32"]
    if m.group(4):  # a second type: the center sums' w
        args.append("w " + names[m.group(4)])
    ints = re.findall(r"Li(\d+)E", m.group(5))
    if m.group(1).startswith("glm_wide_"):  # the wide instances
        if "_fma_" in m.group(1):
            args.append(f"KG={ints[0]}")
        elif ints:
            args.append(("logistic", "squared")[int(ints[0])])
        return f"{m.group(1)}<{', '.join(args)}>"
    if len(ints) == 2 and m.group(1) == "glm_stacked_kernel":
        args += [f"C={ints[0]}", f"KG={ints[1]}"]
    elif m.group(1) == "glm_stacked_tc_kernel":  # and the cluster's CTAs
        args += [f"NB={ints[0]}", f"KG={ints[1]}"]
        if len(ints) == 3 and int(ints[2]) > 1:
            args.append(f"cluster={ints[2]}")
    elif len(ints) == 2:
        args += [f"E={ints[0]}", ("logistic", "squared")[int(ints[1])]]
    if len(ints) == 1:  # the tensor-core Gramian's staging
        args.append(("cp.async", "cp.async codes", "ld.global")[int(ints[0])])
    bools = re.findall(r"Lb(\d)E", m.group(5))
    if bools and m.group(1) == "center_warp_kernel":  # X's alignment
        args.append(("element loads", "8-byte loads")[int(bools[0])])
    elif bools:  # the tensor-core assignment: X resident or staged per block
        args.append(("X per block", "X resident")[int(bools[0])])
    return f"{m.group(1)}<{', '.join(args)}>"


def phase_build():
    """Builds every kernel; returns ptxas's lines (registers, shared
    memory, spills) by kernel instance."""
    from cycloneml_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in KERNEL_SOURCES:
        report = build.ptxas_report(name)
        func = None
        # the report of the build that made the library
        text = report.read_text() if report.exists() else ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                func = _kernel_name(ln.split("'")[1] if "'" in ln else ln)
            elif func and ("registers" in ln or "spill" in ln):
                info = ln.split(':')[-1].strip()
                print(f"ptxas {name} {func}: {info}")
                ptxas.setdefault(func, []).append(info)
    _line("build", sources=KERNEL_SOURCES, seconds=round(secs, 2))
    return ptxas


def _k1_inputs(n, d, seed):
    import torch
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, 1 << 18):
        x[lo:lo + (1 << 18)] = torch.randn(
            (min(1 << 18, n - lo), d), generator=g, device=dev)
    truth = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = (x @ truth + torch.randn(n, generator=g, device=dev) > 0).float()
    w = torch.ones(n, device=dev)
    coef = torch.randn(d + 1, generator=g, device=dev) / d ** 0.5
    inv_std = torch.rand(d, generator=g, device=dev) + 0.5
    mu = torch.randn(d, generator=g, device=dev) * 0.5
    return x, y, w, coef, inv_std, mu


def _fold_truth(x, y, w, inv_std, mu, coef, d, x_scale=None):
    """The scaled sweep in float64 through the plain version (on the
    dequantized values when ``x_scale`` is given)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    c = coef.double()
    beta = inv_std.double() * c[:d]
    off = c[d] - torch.dot(mu.double(), c[:d])
    loss, g, msum, wsum = kernels.glm_sweep_plain(
        x, y, w, beta, off, acc_dtype=torch.float64, x_scale=x_scale)
    grad = torch.cat([inv_std.double() * g - mu.double() * msum,
                      msum.reshape(1)])
    return loss, grad, wsum


def _randn(n, d, g, dtype=None):
    """(n, d) N(0, 1) on the card, drawn ROWS rows at a time."""
    import torch
    x = torch.empty((n, d), dtype=dtype or torch.float32, device=DEVICE)
    for lo in range(0, n, ROWS):
        x[lo:lo + ROWS] = torch.randn((min(ROWS, n - lo), d), generator=g,
                                      device=DEVICE).to(x.dtype)
    return x


def _x_forms(x32, fp8):
    """``(X, x_scale float32, x_scale float64)`` for each form of X a
    kernel phase holds: float32 and bfloat16 X (no scale), or, with
    ``fp8``, the e4m3 codes of x32 quantized on the card
    (``quantize_fp8``) with their per-column scale, float32 for the kernel
    and float64 for the truth."""
    import torch
    if not fp8:
        yield x32, None, None
        yield x32.to(torch.bfloat16), None, None
        return
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    x8, scale, _ = quantize_fp8(x32)
    yield (x8, torch.as_tensor(scale, dtype=torch.float32, device=DEVICE),
           torch.as_tensor(scale, dtype=torch.float64, device=DEVICE))


def _dt(x) -> str:
    return str(x.dtype)[6:]


def _main_dtype(fp8):
    """The dtype whose numbers at the main shape go into the kernels
    line: bfloat16, or e4m3 for the fp8 entries."""
    import torch
    return torch.float8_e4m3fn if fp8 else torch.bfloat16


def _bound(n_bytes, flops, peak_flops=H100_F32_FLOPS):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_b, t_o = n_bytes / H100_BYTES_PER_S, flops / peak_flops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_kernel(fp8=False):
    """K1 against its plain version (on float32 and bf16 X, or with
    ``fp8`` on e4m3 codes with their x_scale); returns the main-shape
    numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, seed in ((FIT_N, FIT_D, 1), (RAGGED_N, RAGGED_D, 2)):
        x32, y, w, coef, inv_std, mu = _k1_inputs(n, d, seed)
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            for centered in (False, True):
                m = mu if centered else torch.zeros_like(mu)
                got = kernels.fused_binary_logistic_scaled(
                    x, y, w, inv_std, m, coef, d, x_scale=s32)
                again = kernels.fused_binary_logistic_scaled(
                    x, y, w, inv_std, m, coef, d, x_scale=s32)
                torch.cuda.synchronize()
                t_loss, t_grad, t_w = _fold_truth(x, y, w, inv_std, m,
                                                  coef, d, s64)
                rel_loss = abs(float(got["loss"]) - float(t_loss)) \
                    / abs(float(t_loss))
                err = float((got["grad"].double() - t_grad).abs().max())
                gmax = float(t_grad.abs().max())
                bitwise = all(torch.equal(got[k], again[k])
                              for k in ("loss", "grad", "count"))
                ok = (rel_loss <= 1e-5 and err <= 1e-4 * gmax
                      and float(got["count"]) == n and float(t_w) == n
                      and bitwise)
                _line("k1_check", n=n, d=d, dtype=_dt(x),
                      x_scale=s32 is not None, centered=centered,
                      rel_loss=rel_loss,
                      max_abs_grad_err=err, max_abs_grad=gmax,
                      count=float(got["count"]), bitwise_equal=bitwise,
                      ok=ok)
                if not ok:
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version at n={n} d={d} {dtype}")
                if n == FIT_N and dtype == main_dt:
                    results["max_abs_err"] = max(
                        results.get("max_abs_err", 0.0), err)
            results.update(_k1_times(x, y, w, coef, inv_std, d, n, s32,
                                     main_dt))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _gemv_yardstick(x, beta, residual):
    """The sweep's two gemvs in cuBLAS at X's dtype (``residual(m)`` maps
    the margins to the multipliers); None for e4m3 codes, which torch.mv
    does not take."""
    import torch
    if x.dtype == torch.float8_e4m3fn:
        return None
    xb = beta.to(x.dtype)
    mult = residual(torch.mv(x, xb).float()).to(x.dtype)
    return _time_ms(lambda: (torch.mv(x, xb), torch.mv(x.t(), mult)), 10, 2)


def _k1_times(x, y, w, coef, inv_std, d, n, x_scale, main_dt):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    beta = inv_std * coef[:d]
    off = coef[d]
    dt = _dt(x)
    k_ms = _time_ms(lambda: kernels.glm_sweep(x, y, w, beta, off,
                                              x_scale=x_scale), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(x, y, w, beta, off,
                                                    x_scale=x_scale), 3, 1)
    yard_ms = _gemv_yardstick(
        x, beta, lambda m: w * (torch.sigmoid(m + off) - y))
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    plan = kernels.glm_sweep_plan(x.dtype, kernels.LOGISTIC, d)
    _line("k1_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6, **plan)
    if n == FIT_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms, "plan": plan}
    return {}


def _fit(ctx, ds, mode):
    import torch
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    ctx.conf.set("cyclone.ml.usePallasKernels", mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LogisticRegression(maxIter=25, regParam=0.01, tol=0.0).fit(ds)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _ran_to_stop(summary) -> bool:
    """maxIter=25 iterations, or an earlier stop that tol=0 allows: the
    objective did not change at all in the last iteration (|df| <= 0),
    which happens once the fit reaches float32 resolution."""
    hist = summary.objective_history
    return summary.total_iterations == 25 or (
        len(hist) >= 2 and hist[-1] == hist[-2])


def _train_accuracy(ds, coef, intercept) -> float:
    """Share of the real rows the model classifies right, on the card."""
    import torch
    c = torch.as_tensor(coef, dtype=torch.float32, device=ds.x.device)
    hits = 0
    for lo in range(0, ds.n_rows, 1 << 18):
        hi = min(lo + (1 << 18), ds.n_rows)
        pred = (ds.x[lo:hi].float() @ c + intercept > 0).float()
        hits += int((pred == ds.y[lo:hi].float()).sum())
    return hits / ds.n_rows


def phase_fit():
    import numpy as np
    import torch
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ops import kernels

    ctx = CycloneContext(CycloneConf().set("cyclone.app.name", "chip_smoke")
                         .set("cyclone.master", DEVICE))
    try:
        t0 = time.perf_counter()
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        k_model, k_warm = _fit(ctx, ds, "auto")
        launches = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "logistic")
        ks = k_model.summary
        k_again, k_steady = _fit(ctx, ds, "auto")
        p_model, p_warm = _fit(ctx, ds, "false")
        p_again, p_steady = _fit(ctx, ds, "false")
        ps = p_model.summary
        peak = torch.cuda.max_memory_allocated()
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        coef_ok = bool(np.allclose(kc, pc, rtol=5e-3, atol=5e-4)) and \
            abs(k_model.intercept - p_model.intercept) <= \
            5e-4 + 5e-3 * abs(p_model.intercept)
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        acc = _train_accuracy(ds, kc, k_model.intercept)
        _line("fit", n=FIT_N, d=FIT_D, data_dtype=str(ds.x.dtype)[6:],
              generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals,
                      "row_order_counts": ROW_ORDER_COUNTS["fit"],
                      "dispatches": ks.total_dispatches,
                      "k1_launches": launches, "warm_s": k_warm,
                      "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1]},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals,
                     "dispatches": ps.total_dispatches, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1]},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              objective_rel_diff=obj_rel, train_accuracy=acc,
              max_memory_allocated=peak)
        checks = {
            "kernel fit ran 25 iterations or stopped on an exact float32 "
            "stall": _ran_to_stop(ks),
            "plain fit ran 25 iterations or stopped on an exact float32 "
            "stall": _ran_to_stop(ps),
            "K1 launched once per evaluation": launches == ks.total_evals,
            "no other kernel launched": others == 0,
            "coefficients agree (rtol 5e-3, atol 5e-4)": coef_ok,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        }
        for what, ok in checks.items():
            print(f"fit check: {what}: {'ok' if ok else 'FAILED'}")
        if not all(checks.values()):
            raise AssertionError("the fit failed a check")
        _keep("LogisticRegression", k_model, ds.x)
        _MAIN_MODEL["lr"] = k_model
        return launches
    finally:
        ctx.stop()


def _other_launches(kernels, *own: str) -> int:
    """Launches of every kernel but those named in ``own`` since the last
    reset."""
    counts = {"logistic": kernels.glm_sweep.launches_by_link["logistic"],
              "squared": kernels.glm_sweep.launches_by_link["squared"],
              "kmeans_assign": kernels.kmeans_assign.launches,
              "gramian": kernels.gramian.launches,
              "glm_stacked": kernels.glm_sweep_stacked.launches,
              "center_sums": kernels.center_sums.launches,
              "ell_rows": kernels.ell_rows.launches,
              "ell_cols": kernels.ell_cols.launches,
              "als_normal": kernels.als_normal.launches,
              "serving_margins": kernels.serving_margins.launches}
    return sum(v for k, v in counts.items() if k not in own)


def _context(name):
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    return CycloneContext(CycloneConf().set("cyclone.app.name", name)
                          .set("cyclone.master", DEVICE))


def _timed(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check(tag: str, checks: dict) -> None:
    for what, ok in checks.items():
        print(f"{tag} check: {what}: {'ok' if ok else 'FAILED'}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} failed a check")


# -- K2 and LinearRegression --------------------------------------------------

def phase_k2(fp8=False):
    """K2 against its plain version in float64 (on float32 and bf16 X, or
    with ``fp8`` on e4m3 codes with their x_scale); returns the main-shape
    numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, seed in ((LIN_N, LIN_D, 3), (RAGGED_N, RAGGED_D, 4)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        y = torch.randn(n, generator=g, device=DEVICE) * 3 + 1
        w = torch.ones(n, device=DEVICE)
        coef = torch.randn(d, generator=g, device=DEVICE) / d ** 0.5
        inv_std = torch.rand(d, generator=g, device=DEVICE) + 0.5
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            for centered in (False, True):
                mu = (torch.randn(d, generator=g, device=DEVICE) * 0.5
                      if centered else torch.zeros(d, device=DEVICE))
                y_pars = torch.tensor([0.4, 0.3 if centered else 0.0],
                                      device=DEVICE)
                got = kernels.fused_least_squares_scaled(
                    x, y, w, inv_std, mu, y_pars, coef, d, x_scale=s32)
                again = kernels.fused_least_squares_scaled(
                    x, y, w, inv_std, mu, y_pars, coef, d, x_scale=s32)
                torch.cuda.synchronize()
                c, s, m, yp = (t.double() for t in (coef, inv_std, mu,
                                                     y_pars))
                t_loss, t_g, t_m, t_w = kernels.glm_sweep_plain(
                    x, y, w, s * c, yp[1] - torch.dot(m, c),
                    acc_dtype=torch.float64, link=kernels.SQUARED, ys=yp[0],
                    x_scale=s64)
                t_grad = s * t_g - m * t_m
                rel_loss = abs(float(got["loss"]) - float(t_loss)) \
                    / abs(float(t_loss))
                err = float((got["grad"].double() - t_grad).abs().max())
                gmax = float(t_grad.abs().max())
                bitwise = all(torch.equal(got[k], again[k])
                              for k in ("loss", "grad", "count"))
                ok = (rel_loss <= 1e-5 and err <= 1e-4 * gmax
                      and float(got["count"]) == n and float(t_w) == n
                      and bitwise)
                _line("k2_check", n=n, d=d, dtype=_dt(x),
                      x_scale=s32 is not None, centered=centered,
                      rel_loss=rel_loss,
                      max_abs_grad_err=err, max_abs_grad=gmax,
                      count=float(got["count"]), bitwise_equal=bitwise,
                      ok=ok)
                if not ok:
                    raise AssertionError(f"K2 disagrees with its plain "
                                         f"version at n={n} d={d} {dtype}")
                if n == LIN_N and dtype == main_dt:
                    results["max_abs_err"] = max(
                        results.get("max_abs_err", 0.0), err)
            results.update(_k2_times(x, y, w, coef, inv_std, n, d, s32,
                                     main_dt))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k2_times(x, y, w, coef, inv_std, n, d, x_scale, main_dt):
    from cycloneml_tpu_torch.ops import kernels
    beta, off, ys = inv_std * coef, 0.1, 0.4
    sq = kernels.SQUARED
    k_ms = _time_ms(lambda: kernels.glm_sweep(x, y, w, beta, off, link=sq,
                                              ys=ys, x_scale=x_scale), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(
        x, y, w, beta, off, link=sq, ys=ys, x_scale=x_scale), 3, 1)
    yard_ms = _gemv_yardstick(x, beta, lambda m: w * (m + off - ys * y))
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    dt = _dt(x)
    plan = kernels.glm_sweep_plan(x.dtype, sq, d)
    _line("k2_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, yardstick_two_gemv_ms=yard_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6, **plan)
    if n == LIN_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms, "plan": plan}
    return {}


def phase_linreg():
    """LinearRegression at configuration 2 through K2 and through the
    plain aggregator; returns K2's launches in the K2 fit, that fit's
    final objective and its model."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_linreg")
    try:
        ds, gen_s = _timed(lambda: generate_regression(
            ctx, LIN_N, LIN_D, seed=11, noise=0.1))

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: LinearRegression(
                regParam=0.001, elasticNetParam=0.5, maxIter=100, tol=1e-7,
                solver="l-bfgs").fit(ds))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = fit("auto")
        launches = kernels.glm_sweep.launches_by_link[kernels.SQUARED]
        others = _other_launches(kernels, "squared")
        k_again, k_steady = fit("auto")
        p_model, p_warm = fit("false")
        _, p_steady = fit("false")
        peak = torch.cuda.max_memory_allocated()
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        zero_diff = int(np.sum((kc == 0) != (pc == 0)))
        _line("linreg_fit", n=LIN_N, d=LIN_D, data_dtype=str(ds.x.dtype)[6:],
              generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals,
                      "row_order_counts": ROW_ORDER_COUNTS["linreg_fit"],
                      "k2_launches": launches,
                      "warm_s": k_warm, "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1],
                      "zero_coefficients": int(np.sum(kc == 0))},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1],
                     "zero_coefficients": int(np.sum(pc == 0))},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              intercepts=[k_model.intercept, p_model.intercept],
              objective_rel_diff=obj_rel,
              zero_pattern_differs_at=zero_diff,
              max_memory_allocated=peak)
        _check("linreg fit", {
            "K2 launched once per loss evaluation":
                launches == ks.total_evals,
            "no other kernel launched": others == 0,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "coefficients agree (rtol 5e-3, atol 5e-4)": bool(np.allclose(
                kc, pc, rtol=5e-3, atol=5e-4)) and abs(
                k_model.intercept - p_model.intercept) <=
                5e-4 + 5e-3 * abs(p_model.intercept),
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        })
        _keep("LinearRegression", k_model, ds.x)
        return launches, ks.objective_history[-1], k_model
    finally:
        ctx.stop()


# -- the fp8 rung: LogisticRegression and LinearRegression on e4m3 codes ------

def _norm_rel(a, b) -> float:
    """max|a - b| / max|b|: the reference's fp8 envelope metric."""
    import numpy as np
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-9))


def _fp8_fit_phase(tag, name, generate, estimator, link):
    """One fp8 path: data generated on the card (bf16, the rung the
    generators store under the fp8 tiers), a bf16 fit through the kernel
    for the envelope, the same rows quantized on the card
    (``InstanceDataset.quantized``), then the fp8 fit through the kernel
    (the main path: counts zeroed just before, read just after) and
    through the plain aggregator on identical codes. Returns the e4m3
    launches of the kernel fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context(name)
    ctx.conf.set("cyclone.data.dtype", "float8")
    f8 = torch.float8_e4m3fn
    try:
        ds16, gen_s = _timed(lambda: generate(ctx))

        def fit(ds, mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: estimator().fit(ds))

        ref16, ref16_s = fit(ds16, "auto")
        ds8, quant_s = _timed(ds16.quantized)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = fit(ds8, "auto")
        by_dtype = dict(kernels.glm_sweep.launches_by_dtype)
        by_link = dict(kernels.glm_sweep.launches_by_link)
        others = (kernels.kmeans_assign.launches + kernels.gramian.launches
                  + sum(v for k, v in by_link.items() if k != link))
        k_again, k_steady = fit(ds8, "auto")
        p_model, p_warm = fit(ds8, "false")
        _, p_steady = fit(ds8, "false")
        peak = torch.cuda.max_memory_allocated()
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        envelope = _norm_rel(kc, ref16.coefficients.values)
        _line(tag, n=ds8.n_rows, d=ds8.n_features,
              data_dtype=_dt(ds8.x), x_bytes=ds8.x.numel(),
              generate_s=gen_s, quantize_s=quant_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals,
                      "row_order_counts": ROW_ORDER_COUNTS[tag],
                      "e4m3_launches": by_dtype[f8], "warm_s": k_warm,
                      "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1]},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1]},
              bf16_kernel_fit={"iterations": ref16.summary.total_iterations,
                               "seconds": ref16_s},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              intercepts=[k_model.intercept, p_model.intercept],
              objective_rel_diff=obj_rel,
              coef_norm_rel_to_bf16_fit=envelope,
              fallbacks=ctx.precision_fallbacks,
              max_memory_allocated=peak)
        _check(tag, {
            "X is e4m3 codes with a float64 x_scale":
                ds8.x.dtype == f8 and ds8.x_scale is not None
                and ds8.x_scale.dtype == np.float64,
            "e4m3 instance launched once per evaluation":
                by_dtype[f8] == ks.total_evals == by_link[link],
            "no bf16 or f32 instance launched":
                by_dtype[torch.bfloat16] == by_dtype[torch.float32] == 0,
            "no other kernel launched": others == 0,
            "no fp8 fallback fired": not ctx.precision_fallbacks,
            "coefficients agree (rtol 5e-3, atol 5e-4)": bool(np.allclose(
                kc, pc, rtol=5e-3, atol=5e-4)) and abs(
                k_model.intercept - p_model.intercept) <=
                5e-4 + 5e-3 * abs(p_model.intercept),
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "within the fp8 envelope (20%) of the bf16 fit":
                envelope < FP8_COEF_NORMREL,
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        })
        return by_dtype[f8]
    finally:
        ctx.stop()


def phase_fp8_fit():
    """LogisticRegression at bench.py's shape on the fp8 rung through K1's
    e4m3 instance and through the plain aggregator."""
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels
    return _fp8_fit_phase(
        "fp8_fit", "chip_smoke_fp8",
        lambda ctx: generate_classification(ctx, FIT_N, FIT_D, seed=0),
        lambda: LogisticRegression(maxIter=25, regParam=0.01, tol=0.0),
        kernels.LOGISTIC)


def phase_fp8_linreg():
    """LinearRegression at configuration 2 on the fp8 rung through K2's
    e4m3 instance and through the plain aggregator."""
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels
    return _fp8_fit_phase(
        "fp8_linreg_fit", "chip_smoke_fp8_linreg",
        lambda ctx: generate_regression(ctx, LIN_N, LIN_D, seed=11,
                                        noise=0.1),
        lambda: LinearRegression(regParam=0.001, elasticNetParam=0.5,
                                 maxIter=100, tol=1e-7, solver="l-bfgs"),
        kernels.SQUARED)


# -- K3 and KMeans ------------------------------------------------------------

def _k3_rule(x, c, best, dist, x_scale64):
    """K3's rule against float64 (row chunks) on the same values: the
    count of rows whose argmin differs, the worst pick excess and distance
    error over max(d2, |x|^2), and the largest absolute distance error."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n = x.shape[0]
    b64, d64 = kernels.kmeans_assign_plain(x, c, torch.float64,
                                           x_scale=x_scale64)
    c64 = c.double()
    differ = worst_pick = worst_dist = max_err = 0.0
    for lo in range(0, n, ROWS):
        xc = x[lo:lo + ROWS].double()
        if x_scale64 is not None:
            xc = xc * x_scale64
        bc, tc = best[lo:lo + ROWS].long(), d64[lo:lo + ROWS]
        scale = torch.maximum(tc, (xc * xc).sum(1))
        picked = ((xc - c64[bc]) ** 2).sum(1)
        differ += int((bc != b64[lo:lo + ROWS]).sum())
        worst_pick = max(worst_pick, float(((picked - tc) / scale).max()))
        e = (dist[lo:lo + ROWS].double() - tc).abs()
        worst_dist = max(worst_dist, float((e / scale).max()))
        max_err = max(max_err, float(e.max()))
    return int(differ), worst_pick, worst_dist, max_err


def phase_k3(fp8=False):
    """K3 against its plain version in float64 (on float32 and bf16 X, or
    with ``fp8`` on e4m3 codes with their x_scale, held on the dequantized
    values), and on bf16 X at the main shape against centers in near-tie
    pairs; returns the main-shape numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, k, seed in ((KM_N, KM_D, KM_K, 5), (*KM_RAGGED, 6)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        c = torch.randn(k, d, generator=g, device=DEVICE)
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            instance = kernels.INSTANCE[dtype]
            before = kernels.kmeans_assign.launches_by_instance[instance]
            best, dist = kernels.kmeans_assign(x, c, x_scale=s32)
            best2, dist2 = kernels.kmeans_assign(x, c, x_scale=s32)
            torch.cuda.synchronize()
            launched = kernels.kmeans_assign.launches_by_instance[
                instance] - before == 2
            bitwise = torch.equal(best, best2) and torch.equal(dist, dist2)
            differ, worst_pick, worst_dist, max_err = _k3_rule(
                x, c, best, dist, s64)
            ok = (worst_pick <= 1e-5 and worst_dist <= 1e-4 and bitwise
                  and launched
                  and int(best.max()) < k and int(best.min()) >= 0)
            _line("k3_check", n=n, d=d, k=k, dtype=_dt(x),
                  x_scale=s32 is not None, instance=instance,
                  argmin_differs_at=differ,
                  worst_pick_excess_rel=worst_pick,
                  worst_dist_err_rel=worst_dist, max_abs_dist_err=max_err,
                  bitwise_equal=bitwise, ok=ok)
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at n={n} d={d} k={k} {dtype}")
            if n == KM_N and dtype == main_dt:
                results["max_abs_err"] = max_err
                if not fp8:
                    _k3_near_ties(x, c, g)
            results.update(_k3_times(x, c, n, d, k, s32, main_dt))
            del x
        del x32
        torch.cuda.empty_cache()
    return results


def _k3_near_ties(x, c, g):
    """K3 on the same rows against centers in pairs c and c + delta, delta
    ~ 1e-6 per feature: float32 rounding decides which of a pair wins, and
    every pick is held by the same rule (excess <= 1e-5)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k, d = c.shape
    half = c[:k // 2]
    pairs = torch.stack([half, half + 1e-6 * torch.randn(
        half.shape, generator=g, device=DEVICE)], 1).reshape(-1, d)
    best, dist = kernels.kmeans_assign(x, pairs)
    best2, dist2 = kernels.kmeans_assign(x, pairs)
    torch.cuda.synchronize()
    bitwise = torch.equal(best, best2) and torch.equal(dist, dist2)
    differ, worst_pick, worst_dist, _ = _k3_rule(x, pairs, best, dist, None)
    # rows whose pick is the other center of its pair than float64's
    _line("k3_near_ties", n=x.shape[0], d=d, k=pairs.shape[0],
          dtype=_dt(x), delta=1e-6, argmin_differs_at=differ,
          worst_pick_excess_rel=worst_pick, worst_dist_err_rel=worst_dist,
          bitwise_equal=bitwise)
    _check("k3 near ties", {
        "picks within 1e-5 of max(d2, |x|^2)": worst_pick <= 1e-5,
        "distances within 1e-4 of it": worst_dist <= 1e-4,
        "two launches bitwise equal": bitwise,
    })


def _k3_times(x, c, n, d, k, x_scale, main_dt):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k_ms = _time_ms(lambda: kernels.kmeans_assign(x, c, x_scale=x_scale),
                    3, 1)
    p_ms = _time_ms(lambda: kernels.kmeans_assign_plain(x, c,
                                                        x_scale=x_scale),
                    2, 1)
    ct = c.t().contiguous()

    def product():  # the distance product alone, f32 with TF32 off
        for lo in range(0, n, ROWS):
            x[lo:lo + ROWS].float() @ ct
    yard_ms = _time_ms(product, 3, 1)
    n_bytes = n * d * x.element_size() + k * d * 4 + k * 4 + n * 8
    f32_bound, _ = _bound(n_bytes, 2.0 * n * k * d)
    if kernels.INSTANCE[x.dtype] == kernels.TENSOR_CORE:
        # float32-accurate products on the tensor cores: three bf16 passes
        flops, rate, rate_name = (3 * 2.0 * n * k * d, H100_BF16_FLOPS,
                                  "bf16 tensor cores, three passes")
    else:
        flops, rate, rate_name = 2.0 * n * k * d, H100_F32_FLOPS, "f32 FMA"
    bound, bound_by = _bound(n_bytes, flops, rate)
    _line("k3_time", n=n, d=d, k=k, dtype=_dt(x), kernel_ms=k_ms,
          plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
          bound_rate=rate_name, f32_fma_bound_ms=f32_bound,
          yardstick_f32_product_ms=yard_ms,
          achieved_tflop_s=flops / k_ms / 1e9,
          share_of_bound=bound / k_ms)
    if n == KM_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": yard_ms,
                "f32_fma_bound_ms": f32_bound}
    return {}


def phase_kmeans():
    """KMeans at configuration 3 through K3 and through the plain
    assignment, twice through K3 (bitwise-equal centers), and the center
    sums of one Lloyd step timed alone; returns K3's and the center sums'
    launches in the K3 fit and the center sums' numbers."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import RandomDatasets
    from cycloneml_tpu_torch.ml.clustering import KMeans
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_kmeans")
    try:
        ds, gen_s = _timed(lambda: RandomDatasets.normal(
            ctx, KM_N, KM_D, seed=12))

        def km(max_iter=10):
            return KMeans(k=KM_K, maxIter=max_iter, tol=1e-5, seed=3)

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: km().fit(ds))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_s = fit("auto")
        launches = kernels.kmeans_assign.launches
        by_instance = dict(kernels.kmeans_assign.launches_by_instance)
        sum_launches = kernels.center_sums.launches
        sums_by_instance = dict(kernels.center_sums.launches_by_instance)
        others = _other_launches(kernels, "kmeans_assign", "center_sums")
        k_again, k_again_s = fit("auto")
        p_model, p_s = fit("false")
        peak = torch.cuda.max_memory_allocated()
        cost_rel = abs(k_model.training_cost - p_model.training_cost) \
            / abs(p_model.training_cost)
        centers = k_model.cluster_centers_matrix().to_array()
        repeat_equal = bool(np.array_equal(
            centers, k_again.cluster_centers_matrix().to_array())) and \
            k_model.training_cost == k_again.training_cost
        # one Lloyd step from identical initial centers
        one = km(max_iter=1)
        init, _ = one._init_centers(ds, KM_K, False)
        step_k, _, _ = one._lloyd(ds, init, True)
        step_p, _, _ = one._lloyd(ds, init, False)
        step_diff = float(np.max(np.abs(step_k - step_p)))
        step_scale = float(np.max(np.abs(step_p)))
        _line("kmeans_fit", n=KM_N, d=KM_D, k=KM_K,
              data_dtype=str(ds.x.dtype)[6:], generate_s=gen_s,
              kernel={"iterations": k_model.num_iterations,
                      "init_passes": k_model.init_distance_passes,
                      "k3_launches": launches,
                      "k3_launches_by_instance": by_instance,
                      "center_sums_launches": sum_launches,
                      "center_sums_launches_by_instance": sums_by_instance,
                      "fit_s": k_s,
                      "repeat_fit_s": k_again_s,
                      "training_cost": k_model.training_cost},
              plain={"iterations": p_model.num_iterations,
                     "init_passes": p_model.init_distance_passes,
                     "fit_s": p_s, "training_cost": p_model.training_cost},
              cost_rel_diff=cost_rel, one_step_max_center_diff=step_diff,
              one_step_max_center=step_scale,
              repeat_fit_bitwise_equal=repeat_equal,
              max_memory_allocated=peak)
        _check("kmeans fit", {
            "K3 launched once per Lloyd step and k-means|| pass":
                launches == k_model.num_iterations
                + k_model.init_distance_passes,
            "center sums launched once per Lloyd step (no attraction pass "
            "at this size)": sum_launches == k_model.num_iterations,
            "only the counting instance of the center sums launched at "
            "k = 1,000": sums_by_instance[kernels.COUNTING] == sum_launches
            and kernels.center_sums_instance(KM_K) == kernels.COUNTING,
            "no other kernel launched": others == 0,
            "bf16 X launched only the tensor-core instance":
                by_instance[kernels.TENSOR_CORE] == launches
                and kernels.INSTANCE[ds.x.dtype] == kernels.TENSOR_CORE,
            "training costs agree to 1e-4": cost_rel <= 1e-4,
            "one Lloyd step agrees (1e-4 of max|center|)":
                step_diff <= 1e-4 * step_scale,
            "two K3 fits give bitwise-equal centers and costs": repeat_equal,
            "finite centers": bool(np.all(np.isfinite(centers))),
        })
        _keep("KMeans", k_model, ds.x)
        return launches, sum_launches, _center_sums_phase(ds, centers)
    finally:
        ctx.stop()


def _index_add_center_sums(x, w, best, k):
    """The center update before PR 6 (``index_add_`` over 2^18-row
    chunks, float atomics on CUDA): the library call the kernel is timed
    against."""
    import torch
    sums = torch.zeros((k, x.shape[1]), dtype=w.dtype, device=x.device)
    for lo in range(0, x.shape[0], 1 << 18):
        sums.index_add_(0, best[lo:lo + (1 << 18)],
                        x[lo:lo + (1 << 18)].to(w.dtype)
                        * w[lo:lo + (1 << 18), None])
    counts = torch.zeros(k, dtype=w.dtype, device=x.device).index_add_(
        0, best, w)
    return sums, counts


def _center_sums_phase(ds, centers):
    """The center sums of one Lloyd step at configuration 3, on the
    assignment to the fit's final centers: the counting instance (the
    main path's) against float64 index_add_ sums, two calls bitwise equal,
    bitwise equal to the sorted instance (torch.sort, then the same sums)
    in the same call, its order torch.sort's stable one, each counted under its
    instance; the time per Lloyd step of both instances and of the
    counting sort alone, beside the index_add_ update they replaced and
    the bound."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    x, w = ds.x, ds.w
    n, d = x.shape
    c = torch.as_tensor(centers, dtype=torch.float32, device=x.device)
    best, _ = kernels.kmeans_assign(x, c)
    before = dict(kernels.center_sums.launches_by_instance)
    sums, counts = kernels.center_sums(x, w, best, KM_K)
    sums2, counts2 = kernels.center_sums(x, w, best, KM_K)
    s_sums, s_counts = (t.to(w.dtype) for t in kernels._sorted_launch(
        x, w, best, KM_K, d))
    torch.cuda.synchronize()
    by_instance = {i: kernels.center_sums.launches_by_instance[i] - before[i]
                   for i in before}
    bitwise = torch.equal(sums, sums2) and torch.equal(counts, counts2)
    sorted_bitwise = torch.equal(sums, s_sums) and torch.equal(counts,
                                                               s_counts)
    co = kernels._center_order(best, KM_K)
    order_equal = torch.equal(co.order.long(),
                              torch.sort(best.long(), stable=True).indices)
    pieces = int(co.piece_start[KM_K])
    del co, s_sums, s_counts
    t_sums, t_counts = kernels.center_sums_plain(x, w, best.long(), KM_K,
                                                 torch.float64)
    err = float((sums.double() - t_sums).abs().max())
    scale = float(t_sums.abs().max())
    counts_exact = torch.equal(counts.double(), t_counts)
    old_a, _ = _index_add_center_sums(x, w, best.long(), KM_K)
    old_b, _ = _index_add_center_sums(x, w, best.long(), KM_K)
    old_bitwise = torch.equal(old_a, old_b)
    del t_sums, old_a, old_b
    calls = {kernels.COUNTING: lambda: kernels.center_sums(x, w, best, KM_K),
             kernels.SORTED: lambda: [t.to(w.dtype) for t in
                                      kernels._sorted_launch(x, w, best,
                                                             KM_K, d)]}
    # in turns: counting, sorted, sorted, counting
    turns = [_time_ms(calls[inst], 5, 1) for inst in (
        kernels.COUNTING, kernels.SORTED, kernels.SORTED, kernels.COUNTING)]
    k_ms = min(turns[0], turns[3])
    sorted_ms = min(turns[1], turns[2])
    order_ms = _time_ms(lambda: kernels._center_order(best, KM_K), 5, 1)
    device_ms = _device_ms(lambda: kernels.center_sums(x, w, best, KM_K), 5,
                           "")
    lib_ms = _time_ms(lambda: _index_add_center_sums(x, w, best.long(),
                                                     KM_K), 5, 1)
    p_ms = _time_ms(lambda: kernels.center_sums_plain(x, w, best.long(),
                                                      KM_K), 3, 1)
    n_bytes = n * d * x.element_size() + n * 4 + n * 4 + KM_K * (d + 1) * 4
    bound, bound_by = _bound(n_bytes, float(n) * (d + 1))

    def scratch(inst):
        """The memory a call takes beyond what is held before it: the
        order, the table or the sort's buffers, the pieces' partials."""
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls[inst]()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - held) / 2**20

    work_mib = scratch(kernels.COUNTING)
    sorted_mib = scratch(kernels.SORTED)
    _line("center_sums", n=n, d=d, k=KM_K, dtype=_dt(x), pieces=pieces,
          instance=kernels.center_sums_instance(KM_K),
          max_abs_err=err, max_abs_sum=scale, counts_exact=counts_exact,
          bitwise_equal=bitwise, sorted_bitwise_equal=sorted_bitwise,
          order_equals_torch_sort=order_equal,
          launches_by_instance=by_instance,
          index_add_bitwise_equal=old_bitwise,
          kernel_ms_per_lloyd_step=k_ms, device_ms=device_ms,
          sorted_ms_per_lloyd_step=sorted_ms,
          turns_counting_sorted_sorted_counting_ms=turns,
          counting_sort_ms=order_ms,
          index_add_ms_per_lloyd_step=lib_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by, working_mem_mib=work_mib,
          sorted_working_mem_mib=sorted_mib,
          x_mib=n * d * x.element_size() / 2**20)
    _check("center sums", {
        "within 1e-6 of max|sum| of the float64 sums": err <= 1e-6 * scale,
        "counts exact": counts_exact,
        "two calls bitwise equal": bitwise,
        "the counting instance bitwise equal to the sorted instance":
            sorted_bitwise,
        "the counting order is torch.sort's stable order": order_equal,
        "two counting and one sorted launch counted by instance":
            by_instance == {kernels.COUNTING: 2, kernels.SORTED: 1},
        "scratch below one copy of X": work_mib * 2**20
        < n * d * x.element_size(),
    })
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "sorted_ms": sorted_ms, "counting_sort_ms": order_ms,
            "device_ms": device_ms, "working_mem_mib": work_mib,
            "sorted_working_mem_mib": sorted_mib}


# -- K4 and PCA ---------------------------------------------------------------

def phase_k4(fp8=False):
    """K4 against its plain version in float64 (on float32 and bf16 X, or
    with ``fp8`` on e4m3 codes with their x_scale, held on the dequantized
    values); returns the main-shape numbers for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, masked, seed in ((GRAM_N, GRAM_D, False, 7),
                               (*GRAM_RAGGED, True, 8)):
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        x32 = _randn(n, d, g)
        w = ((torch.arange(n, device=DEVICE) % 3 != 2).float() if masked
             else torch.ones(n, device=DEVICE))
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            instance = kernels.INSTANCE[dtype]
            before = kernels.gramian.launches_by_instance[instance]
            got = kernels.gramian(x, w, x_scale=s32)
            again = kernels.gramian(x, w, x_scale=s32)
            torch.cuda.synchronize()
            launched = kernels.gramian.launches_by_instance[
                instance] - before == 2
            truth = kernels.gramian_plain(x, w, torch.float64, x_scale=s64)
            diag = truth.diagonal().clamp(min=0)
            scale = torch.sqrt(torch.outer(diag, diag))
            err = (got.double() - truth).abs()
            worst = float((err / scale.clamp(min=1e-300)).max())
            plain = kernels.gramian_plain(x, w, x_scale=s32).double()
            plain_worst = float(((plain - truth).abs()
                                 / scale.clamp(min=1e-300)).max())
            # the trace's relative error: a bias on the diagonal shows here
            tr = float(truth.diagonal().sum())
            trace_rel = [float(got.diagonal().double().sum()) / tr - 1,
                         float(plain.diagonal().sum()) / tr - 1]
            del plain
            bitwise = torch.equal(got, again)
            symmetric = torch.equal(got, got.T)
            ok = worst <= 1e-4 and bitwise and symmetric and launched
            _line("k4_check", n=n, d=d, masked=masked, dtype=_dt(x),
                  x_scale=s32 is not None, instance=instance,
                  worst_err_over_sqrt_gii_gjj=worst,
                  plain_f32_worst_err_over_sqrt_gii_gjj=plain_worst,
                  trace_rel_err_kernel_plain=trace_rel,
                  max_abs_err=float(err.max()), bitwise_equal=bitwise,
                  symmetric=symmetric, ok=ok)
            if not ok:
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"at n={n} d={d} {dtype}")
            if n == GRAM_N and dtype == main_dt:
                results["max_abs_err"] = float(err.max())
            if s32 is not None:
                # the library call's input: the dequantized values in f32
                for lo in range(0, n, ROWS):
                    x32[lo:lo + ROWS] = x[lo:lo + ROWS].float() * s32
            results.update(_k4_times(x, x32, w, n, d, s32, main_dt))
            del x, truth
        del x32
        torch.cuda.empty_cache()
    return results


# bf16 and e4m3 products are exact in f32: the tensor cores' rate for their
# type bounds them; f32 products need the f32 FMA rate
_K4_PEAK = {"bfloat16": H100_BF16_FLOPS, "float8_e4m3fn": H100_FP8_FLOPS}


def _k4_times(x, x32, w, n, d, x_scale, main_dt):
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k_ms = _time_ms(lambda: kernels.gramian(x, w, x_scale=x_scale), 3, 1)
    # the memory one call takes beyond its inputs: the partials' scratch
    # and G
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.gramian(x, w, x_scale=x_scale)
    torch.cuda.synchronize()
    work_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    extra = {}
    if x.dtype == torch.float8_e4m3fn and d % 16 == 0 and \
            x.data_ptr() % 16 == 0:
        # the same codes at a base 8 bytes off 16: the kernel stages them
        # through registers (its ragged path) instead of its cp.async ring
        flat = torch.empty(n * d + 8, dtype=x.dtype, device=x.device)
        xo = flat[8:].view(n, d)
        xo.copy_(x)
        extra["register_staged_ms"] = _time_ms(
            lambda: kernels.gramian(xo, w, x_scale=x_scale), 3, 1)
        extra["register_staged_bitwise_equal"] = torch.equal(
            kernels.gramian(xo, w, x_scale=x_scale),
            kernels.gramian(x, w, x_scale=x_scale))
        del flat, xo
    p_ms = _time_ms(lambda: kernels.gramian_plain(x, w, x_scale=x_scale),
                    3, 1)
    # the f32 product on the same values (TF32 off), unmasked: a rate
    # reference for f32 X
    f32_ms = _time_ms(lambda: x32.T @ x32, 3, 1)
    # a rate reference, not the same function (its output is bf16):
    # cuBLAS's bf16 x^T x on the same values rounded to bf16
    xb = x if x.dtype == torch.bfloat16 else x32.to(torch.bfloat16)
    rate_ms = _time_ms(lambda: xb.T @ xb, 3, 1)
    # the library call for K4's function on bf16 X, unmasked: bf16 x^T x
    # with a float32 output; on f32 X, the f32 product
    lib_ms = _time_ms(lambda: torch.mm(xb.T, xb, out_dtype=torch.float32),
                      3, 1) if x.dtype == torch.bfloat16 else f32_ms
    del xb
    if x.dtype == torch.float8_e4m3fn and x_scale is not None:
        # on e4m3 codes: torch._scaled_mm of the codes' transposed copy
        # (made outside the timing) by itself, the per-column scales as
        # rowwise scales of both sides, unmasked; its output type is the
        # first of float32 and bfloat16 the build takes (None when it
        # takes neither)
        ct = x.T.contiguous()
        s = torch.as_tensor(x_scale).to(device=x.device,
                                        dtype=torch.float32)

        def smm(out_dtype):
            return torch._scaled_mm(ct, ct.t(), scale_a=s.view(-1, 1),
                                    scale_b=s.view(1, -1),
                                    out_dtype=out_dtype)
        refused = {}
        for od in (torch.float32, torch.bfloat16):
            try:
                g_lib = smm(od).float()
            except (RuntimeError, ValueError) as e:  # refused by the build
                refused[str(od)] = str(e).splitlines()[0][:200]
                continue
            extra["library_scaled_mm_out"] = str(od)
            extra["library_scaled_mm_ms"] = _time_ms(lambda: smm(od), 3, 1)
            g_k = kernels.gramian(x, torch.ones_like(w), x_scale=x_scale)
            extra["library_scaled_mm_max_rel"] = float(
                (g_lib - g_k).abs().max() / g_k.abs().max())
            lib_ms = extra["library_scaled_mm_ms"]
            del g_lib, g_k
            break
        extra["library_scaled_mm_refused"] = refused
        del ct
    n_bytes = n * d * x.element_size() + n * 4 + d * d * 4
    dt = _dt(x)
    flops = float(n) * d * (d + 1)
    peak = _K4_PEAK.get(dt, H100_F32_FLOPS)
    bound, bound_by = _bound(n_bytes, flops, peak)
    f32_bound, _ = _bound(n_bytes, flops)
    _line("k4_time", n=n, d=d, dtype=dt, kernel_ms=k_ms, plain_ms=p_ms,
          bound_ms=bound, bound_by=bound_by,
          bound_rate={H100_BF16_FLOPS: "bf16 tensor cores",
                      H100_FP8_FLOPS: "fp8 tensor cores"}.get(peak,
                                                              "f32 FMA"),
          f32_fma_bound_ms=f32_bound, library_ms=lib_ms,
          library_f32_xtx_ms=f32_ms, library_bf16_rate_ms=rate_ms,
          working_mem_mib=work_mib, **extra,
          achieved_tflop_s=flops / k_ms / 1e9, share_of_bound=bound / k_ms)
    if n == GRAM_N and x.dtype == main_dt:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": lib_ms,
                "f32_fma_bound_ms": f32_bound,
                "library_f32_xtx_ms": f32_ms,
                "library_bf16_rate_ms": rate_ms}
    return {}


def _spectrum_dataset(ctx, n, d, seed):
    """X = (Z diag(s)) Q^T with s_j = (j+1)^-1/2 and Q orthogonal from a
    float64 QR, generated on the card in the data tier; returns the
    dataset and Q."""
    import torch
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.dataset.instance import compute_dtype, data_dtype
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=DEVICE,
                                       dtype=torch.float64))
    s = (torch.arange(d, device=DEVICE, dtype=torch.float64) + 1) ** -0.5
    m = (s[:, None] * q.T).float()  # diag(s) Q^T
    x = torch.empty((n, d), dtype=data_dtype(ctx.conf), device=DEVICE)
    for lo in range(0, n, ROWS):
        z = torch.randn((min(ROWS, n - lo), d), generator=g, device=DEVICE)
        x[lo:lo + ROWS] = (z @ m).to(x.dtype)
    cdt = compute_dtype(ctx.conf)
    ds = InstanceDataset(ctx, x, torch.zeros(n, dtype=cdt, device=DEVICE),
                         torch.ones(n, dtype=cdt, device=DEVICE), n, d)
    return ds, q.cpu().numpy()


def phase_pca():
    """PCA(k=10) and compute_svd(k=10) on spectrum data through K4 and
    through the plain Gramian; returns K4's launches in the K4 run."""
    import numpy as np
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.ml.feature import PCA
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_pca")
    try:
        (ds, q), gen_s = _timed(lambda: _spectrum_dataset(
            ctx, GRAM_N, GRAM_D, seed=9))

        def run(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            pca, pca_s = _timed(lambda: PCA(k=10).fit(ds))
            svd, svd_s = _timed(lambda: RowMatrix(ds).compute_svd(10))
            return pca, svd, pca_s, svd_s

        kernels.reset_launch_counts()
        k_pca, k_svd, k_pca_s, k_svd_s = run("auto")
        launches = kernels.gramian.launches
        tc_launches = kernels.gramian.launches_by_instance[
            kernels.TENSOR_CORE]
        others = _other_launches(kernels, "gramian")
        p_pca, p_svd, p_pca_s, p_svd_s = run("false")

        def min_cos(a, b):
            return float(np.min(np.abs(np.sum(a * b, axis=0))))

        pca_cos = min_cos(k_pca.pc, p_pca.pc)
        svd_cos = min_cos(k_svd.V.to_array(), p_svd.V.to_array())
        ev_rel = float(np.max(np.abs(k_pca.explained_variance
                                     - p_pca.explained_variance)
                              / p_pca.explained_variance))
        ks, ps = k_svd.s.to_array(), p_svd.s.to_array()
        s_rel = float(np.max(np.abs(ks - ps) / ps))
        truth_cos = [min_cos(k_pca.pc, q[:, :10]), min_cos(p_pca.pc,
                                                           q[:, :10])]
        _line("pca", n=GRAM_N, d=GRAM_D, data_dtype=str(ds.x.dtype)[6:],
              generate_s=gen_s, k4_launches=launches,
              kernel={"pca_s": k_pca_s, "svd_s": k_svd_s,
                      "explained_variance": k_pca.explained_variance.tolist(),
                      "singular_values": ks.tolist()},
              plain={"pca_s": p_pca_s, "svd_s": p_svd_s},
              min_abs_cos_pc=pca_cos, min_abs_cos_v=svd_cos,
              explained_variance_rel_diff=ev_rel,
              singular_value_rel_diff=s_rel,
              min_abs_cos_to_q=truth_cos)
        _check("pca", {
            "K4 launched once per Gramian": launches == 2,
            "bf16 X launched only the tensor-core instance":
                tc_launches == launches,
            "no other kernel launched": others == 0,
            "principal components agree (|cos| >= 1 - 1e-6)":
                pca_cos >= 1 - 1e-6,
            "right singular vectors agree (|cos| >= 1 - 1e-6)":
                svd_cos >= 1 - 1e-6,
            "explained variance agrees to 1e-5": ev_rel <= 1e-5,
            "singular values agree to 1e-5": s_rel <= 1e-5,
            "both find the spectrum's top components (|cos| >= 0.99)":
                min(truth_cos) >= 0.99,
        })
        _keep("PCA", k_pca, ds.x)
        return launches
    finally:
        ctx.stop()


# -- K1s and the stacked fits (OneVsRest, CrossValidator) ---------------------

def _k1s_inputs(n, d, seed, masked):
    """X (f32), labels for max(K1S_MODELS) models (y_k = 1[x.beta_k +
    eps > 0]), w (a third of the rows at 0 when ``masked``), coefficients
    and standardization vectors, on the card."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    k = max(K1S_MODELS)
    x = _randn(n, d, g)
    truth = torch.randn(d, k, generator=g, device=DEVICE) / d ** 0.5
    y = torch.empty((n, k), device=DEVICE)
    for lo in range(0, n, ROWS):
        m = x[lo:lo + ROWS] @ truth
        y[lo:lo + ROWS] = (m + torch.randn(m.shape, generator=g,
                                           device=DEVICE) > 0).float()
    w = ((torch.arange(n, device=DEVICE) % 3 != 2).float() if masked
         else torch.ones(n, device=DEVICE))
    coef = torch.randn(k, d + 1, generator=g, device=DEVICE) / d ** 0.5
    inv_std = torch.rand(d, generator=g, device=DEVICE) + 0.5
    mu = torch.randn(d, generator=g, device=DEVICE) * 0.5
    return x, y, w, coef, inv_std, mu


def _label_dtype(x):
    """The labels' dtype beside X: the data tier, bf16 under fp8."""
    import torch
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _fold_truth_stacked(x, y, w, inv_std, mu, coef, d, x_scale=None):
    """The scaled stacked sweep in float64 through the plain version."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    c = coef.double()
    b = c[:, :d] * inv_std.double()
    off = c[:, d] - c[:, :d] @ mu.double()
    loss, g, msum, wsum = kernels.glm_sweep_stacked_plain(
        x, y, w, b, off, acc_dtype=torch.float64, x_scale=x_scale)
    grad = torch.cat([g * inv_std.double() - mu.double()[None] * msum[:, None],
                      msum[:, None]], dim=1)
    return loss, grad, wsum


def _k1s_errors(got, t_loss, t_grad):
    """Worst relative loss error and worst grad error over max|grad|,
    across the models."""
    rel_loss = float(((got["loss"].double() - t_loss).abs()
                      / t_loss.abs()).max())
    err = (got["grad"].double() - t_grad).abs().max(dim=1).values
    gmax = t_grad.abs().max(dim=1).values
    return rel_loss, float((err / gmax).max()), float(err.max())


def phase_k1s(fp8=False):
    """K1s against its plain version in float64 (float32 and bf16 X, or
    with ``fp8`` e4m3 codes with their x_scale) at every K of K1S_MODELS,
    with and without centering, at the fit shape and at the ragged shape
    with a third of the rows at w=0; K=1 against K1; returns the
    main-shape numbers at K=OVR_K for the kernels line."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    results = {}
    main_dt = _main_dtype(fp8)
    for n, d, seed, masked in ((FIT_N, FIT_D, 13, False),
                               (RAGGED_N, RAGGED_D, 14, True)):
        x32, y32, w, coef, inv_std, mu = _k1s_inputs(n, d, seed, masked)
        n_w = float(w.sum())
        for x, s32, s64 in _x_forms(x32, fp8):
            dtype = x.dtype
            ys = y32.to(_label_dtype(x))
            instance = kernels.INSTANCE[dtype]
            for k in K1S_MODELS:
                yk = ys[:, :k]
                groups = -(-k // kernels.glm_sweep_stacked_group(dtype, d))
                for centered in (False, True):
                    m = mu if centered else torch.zeros_like(mu)
                    before = kernels.glm_sweep_stacked.launches_by_dtype[
                        dtype]
                    before_i = dict(
                        kernels.glm_sweep_stacked.launches_by_instance)
                    got = kernels.fused_binary_logistic_stacked_scaled(
                        x, yk, w, inv_std, m, coef[:k], d, x_scale=s32)
                    again = kernels.fused_binary_logistic_stacked_scaled(
                        x, yk, w, inv_std, m, coef[:k], d, x_scale=s32)
                    torch.cuda.synchronize()
                    after_i = kernels.glm_sweep_stacked.launches_by_instance
                    launched = (kernels.glm_sweep_stacked.launches_by_dtype[
                        dtype] - before == 2 * groups
                        and after_i[instance] - before_i[instance]
                        == 2 * groups
                        and sum(after_i.values()) - sum(before_i.values())
                        == 2 * groups)
                    t_loss, t_grad, t_w = _fold_truth_stacked(
                        x, yk, w, inv_std, m, coef[:k], d, s64)
                    rel_loss, rel_grad, err = _k1s_errors(got, t_loss,
                                                          t_grad)
                    bitwise = all(torch.equal(got[q], again[q])
                                  for q in ("loss", "grad", "count"))
                    counts = bool((got["count"] == n_w).all())
                    vs_k1 = None
                    if k == 1:
                        # K=1: K1s against K1 under the same bounds
                        one = kernels.fused_binary_logistic_scaled(
                            x, yk[:, 0], w, inv_std, m, coef[0], d,
                            x_scale=s32)
                        torch.cuda.synchronize()
                        vs_k1 = _k1s_errors(
                            got, one["loss"].double().reshape(1),
                            one["grad"].double().reshape(1, -1))[:2]
                    ok = (rel_loss <= 1e-5 and rel_grad <= 1e-4 and counts
                          and float(t_w) == n_w and bitwise and launched
                          and (vs_k1 is None or (vs_k1[0] <= 1e-5
                                                 and vs_k1[1] <= 1e-4)))
                    _line("k1s_check", n=n, d=d, k=k, dtype=_dt(x),
                          instance=instance,
                          label_dtype=_dt(yk), x_scale=s32 is not None,
                          centered=centered, masked_rows=n - int(n_w),
                          rel_loss=rel_loss, grad_err_over_max=rel_grad,
                          max_abs_grad_err=err, count=float(got["count"][0]),
                          launches=2 * groups, bitwise_equal=bitwise,
                          vs_k1=vs_k1, ok=ok)
                    if not ok:
                        raise AssertionError(
                            f"K1s disagrees with its plain version at n={n} "
                            f"d={d} k={k} {dtype}")
                    if n == FIT_N and dtype == main_dt and k == OVR_K:
                        results["max_abs_err"] = max(
                            results.get("max_abs_err", 0.0), err)
                if n == FIT_N:
                    results.update(_k1s_times(x, x32, yk, w, coef[:k],
                                              inv_std, d, n, s32, main_dt))
            del x, ys
        del x32, y32
        torch.cuda.empty_cache()
    return results


def _k1s_times(x, x32, y, w, coef, inv_std, d, n, x_scale, main_dt):
    """K1s's time at K = y.shape[1] beside its plain version, the bound,
    and two yardsticks the port never calls: K serial launches of K1, and
    the two products of the sweep as cuBLAS f32 GEMMs (TF32 off)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    k = y.shape[1]
    b = coef[:, :d] * inv_std
    off = coef[:, d]
    reps = 10 if k <= 8 else 5
    k_ms = _time_ms(lambda: kernels.glm_sweep_stacked(
        x, y, w, b, off, x_scale=x_scale), reps, 2)
    p_ms = _time_ms(lambda: kernels.glm_sweep_stacked_plain(
        x, y, w, b, off, x_scale=x_scale), 2, 1)
    cols = [y[:, j].float().contiguous() for j in range(k)]

    def serial():
        for j in range(k):
            kernels.glm_sweep(x, cols[j], w, b[j], off[j], x_scale=x_scale)
    serial_ms = _time_ms(serial, 3, 1)
    yf = y.float()
    bt = b.t().contiguous()

    def gemms():  # X.B^T, then M^T.X, on the values in f32
        m = x32 @ bt + off
        mult = w[:, None] * (torch.sigmoid(m) - yf)
        return mult.t() @ x32
    gemm_ms = _time_ms(gemms, 3, 1)
    del cols, yf
    n_bytes = (n * d * x.element_size() + n * k * y.element_size() + n * 4
               + k * (d + 1) * 4 + (k * (d + 2) + 1) * 4)
    # the f32-FMA figure: 4 n d K flops at the FMA rate; the tensor-core
    # instance's: B and the multipliers in three bf16 parts, 12 n d K flops
    # at the bf16 tensor-core rate
    fma_bound, fma_by = _bound(n_bytes, 4.0 * n * d * k)
    tc_bound, tc_by = _bound(n_bytes, 12.0 * n * d * k, H100_BF16_FLOPS)
    instance = kernels.INSTANCE[x.dtype]
    if instance == kernels.TENSOR_CORE:
        bound, bound_by, flops = tc_bound, tc_by, 12.0 * n * d * k
    else:
        bound, bound_by, flops = fma_bound, fma_by, 4.0 * n * d * k
    _line("k1s_time", n=n, d=d, k=k, dtype=_dt(x), instance=instance,
          kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
          tensor_core_bound_ms=tc_bound, tensor_core_bound_by=tc_by,
          f32_fma_bound_ms=fma_bound, f32_fma_bound_by=fma_by,
          yardstick_serial_k1_ms=serial_ms,
          yardstick_two_f32_gemm_ms=gemm_ms,
          achieved_gb_s=n_bytes / k_ms / 1e6,
          achieved_tflop_s=flops / k_ms / 1e9,
          share_of_bound=bound / k_ms)
    if x.dtype == main_dt and k == OVR_K:
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": bound_by, "yardstick_ms": serial_ms,
                "yardstick_two_f32_gemm_ms": gemm_ms,
                "f32_fma_bound_ms": fma_bound, "instance": instance}
    return {}


def _ovr_margins(ds, models):
    """The OvR margins' argmax over the real rows, on the card."""
    import numpy as np
    return _argmax_margins(
        ds, np.stack([m.coefficients.values for m in models]),
        [m.intercept for m in models])


def _argmax_margins(ds, coef_matrix, intercepts):
    """argmax over classes of x.W^T + b for the real rows, on the card."""
    import torch
    w_mat = torch.as_tensor(coef_matrix, dtype=torch.float32,
                            device=ds.x.device).t().contiguous()
    b = torch.as_tensor(intercepts, dtype=torch.float32, device=ds.x.device)
    scale = None if ds.x_scale is None else torch.as_tensor(
        ds.x_scale, dtype=torch.float32, device=ds.x.device)
    out = torch.empty(ds.n_rows, dtype=torch.int64, device=ds.x.device)
    for lo in range(0, ds.n_rows, ROWS):
        hi = min(lo + ROWS, ds.n_rows)
        xc = ds.x[lo:hi].float()
        if scale is not None:
            xc = xc * scale
        out[lo:hi] = (xc @ w_mat + b).argmax(1)
    return out


def _ovr_summary(model):
    return {"iterations": [m.summary.total_iterations for m in model.models],
            "evals": [m.summary.total_evals for m in model.models],
            "stacked_evals": model.models[0].summary.stacked_evals,
            "final_objectives": [m.summary.objective_history[-1]
                                 for m in model.models]}


def _same_models(a, b):
    """Coefficients within the kernel-vs-plain bound (rtol 5e-3, atol
    5e-4), and the worst relative difference of the final objectives."""
    import numpy as np
    coef_ok, obj = True, 0.0
    for ma, mb in zip(a.models, b.models):
        coef_ok &= bool(np.allclose(ma.coefficients.values,
                                    mb.coefficients.values, rtol=5e-3,
                                    atol=5e-4)) and abs(
            ma.intercept - mb.intercept) <= 5e-4 + 5e-3 * abs(mb.intercept)
        fa, fb = (m.summary.objective_history[-1] for m in (ma, mb))
        obj = max(obj, abs(fa - fb) / abs(fb))
    return coef_ok, obj


def phase_ovr():
    """OneVsRest at full width: K=OVR_K classes at 2,000,000 x 1280 (bf16
    tier; bench_ovr_stacked's recipe on the card), LogisticRegression(
    maxIter=25, regParam=0.01, tol=0), parallelism=OVR_K through K1s
    (warm and steady), through the plain stacked aggregator, and serially
    (parallelism=1, OVR_K fits through K1); then the same rows quantized
    on the card, stacked through K1s's e4m3 instance. Returns K1s's bf16
    and e4m3 launches in their stacked fits, and the K1s fit's models."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_multiclass
    from cycloneml_tpu_torch.ml.classification import (LogisticRegression,
                                                       OneVsRest)
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_ovr")
    try:
        ds, gen_s = _timed(lambda: generate_multiclass(
            ctx, FIT_N, FIT_D, OVR_K, seed=7))
        labels = torch.as_tensor(ds.y_host()[:ds.n_rows],
                                 device=ds.x.device).long()

        def fit(mode, par, data=ds):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            clf = LogisticRegression(maxIter=25, regParam=0.01, tol=0.0)
            return _timed(lambda: OneVsRest(classifier=clf,
                                            parallelism=par).fit(data))

        torch.cuda.reset_peak_memory_stats()
        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        k_model, k_warm = fit("auto", OVR_K)
        k1s = dict(kernels.glm_sweep_stacked.launches_by_dtype)
        k1s_tc = kernels.glm_sweep_stacked.launches_by_instance[
            kernels.TENSOR_CORE]
        k1 = kernels.glm_sweep.launches
        others = _other_launches(kernels, "glm_stacked")
        k_again, k_steady = fit("auto", OVR_K)
        p_model, p_s = fit("false", OVR_K)
        kernels.reset_launch_counts()
        s_model, s_s = fit("auto", 1)
        serial_k1 = kernels.glm_sweep.launches
        serial_k1s = kernels.glm_sweep_stacked.launches
        peak = torch.cuda.max_memory_allocated()
        pred_k = _ovr_margins(ds, k_model.models)
        agree_s = float((pred_k == _ovr_margins(ds, s_model.models))
                        .double().mean())
        agree_p = float((pred_k == _ovr_margins(ds, p_model.models))
                        .double().mean())
        acc = float((pred_k == labels).double().mean())
        coef_p, obj_p = _same_models(k_model, p_model)
        coef_s, obj_s = _same_models(k_model, s_model)
        stacked_evals = k_model.models[0].summary.stacked_evals
        groups = -(-OVR_K // kernels.glm_sweep_stacked_group(ds.x.dtype,
                                                             FIT_D))
        serial_evals = sum(m.summary.total_evals for m in s_model.models)
        finite = all(np.all(np.isfinite(m.coefficients.values))
                     for m in k_model.models)
        repeat = all(np.array_equal(a.coefficients.values,
                                    b.coefficients.values)
                     for a, b in zip(k_model.models, k_again.models))

        # the fp8 rung: the same rows as e4m3 codes, stacked through K1s
        ctx.conf.set("cyclone.data.dtype", "float8")
        ds8, quant_s = _timed(ds.quantized)
        kernels.reset_launch_counts()
        f_model, f_s = fit("auto", OVR_K, ds8)
        k1s8 = dict(kernels.glm_sweep_stacked.launches_by_dtype)
        k1s8_tc = kernels.glm_sweep_stacked.launches_by_instance[
            kernels.TENSOR_CORE]
        others8 = _other_launches(kernels, "glm_stacked")
        groups8 = -(-OVR_K // kernels.glm_sweep_stacked_group(ds8.x.dtype,
                                                              FIT_D))
        f_evals = f_model.models[0].summary.stacked_evals
        agree_f = float((pred_k == _ovr_margins(ds8, f_model.models))
                        .double().mean())
        envelope = max(_norm_rel(a.coefficients.values, b.coefficients.values)
                       for a, b in zip(f_model.models, k_model.models))
        _line("ovr_fit", n=FIT_N, d=FIT_D, classes=OVR_K,
              data_dtype=_dt(ds.x), generate_s=gen_s,
              stacked_k1s={**_ovr_summary(k_model), "k1s_launches": k1s[
                  ds.x.dtype], "k1_launches": k1, "warm_s": k_warm,
                  "steady_s": k_steady},
              stacked_plain={**_ovr_summary(p_model), "fit_s": p_s},
              serial_k1={**_ovr_summary(s_model), "k1_launches": serial_k1,
                         "k1s_launches": serial_k1s, "fit_s": s_s},
              fp8_stacked_k1s={**_ovr_summary(f_model),
                               "e4m3_launches": k1s8[torch.float8_e4m3fn],
                               "quantize_s": quant_s, "fit_s": f_s,
                               "coef_norm_rel_to_bf16": envelope,
                               "prediction_agreement": agree_f,
                               "fallbacks": ctx.precision_fallbacks},
              objective_rel_diff={"plain": obj_p, "serial": obj_s},
              prediction_agreement={"plain": agree_p, "serial": agree_s},
              train_accuracy=acc, max_memory_allocated=peak)
        _check("ovr fit", {
            "K1s launched once per stacked evaluation (x groups), all on "
            "the tensor cores":
                k1s[ds.x.dtype] == stacked_evals * groups
                and sum(k1s.values()) == k1s[ds.x.dtype]
                and k1s_tc == k1s[ds.x.dtype],
            "K1 launched 0 times in the stacked fit": k1 == 0,
            "no other kernel launched": others == 0,
            "the serial fits launch K1 once per evaluation, K1s never":
                serial_k1 == serial_evals and serial_k1s == 0,
            "coefficients agree with the plain stacked fit (rtol 5e-3, "
            "atol 5e-4)": coef_p,
            "coefficients agree with the serial fits": coef_s,
            "final objectives agree to 1e-4": max(obj_p, obj_s) <= 1e-4,
            "predictions agree on >= 99.9% of rows":
                min(agree_p, agree_s) >= 0.999,
            "repeat fit reproduces the models": repeat,
            "finite models": finite,
            "fp8: e4m3 K1s launched once per stacked evaluation, no other "
            "dtype, all on the tensor cores":
                k1s8[torch.float8_e4m3fn] == f_evals * groups8
                and sum(k1s8.values()) == k1s8[torch.float8_e4m3fn]
                and k1s8_tc == k1s8[torch.float8_e4m3fn] and others8 == 0,
        })
        _keep("OneVsRest", k_model, ds.x)
        return k1s[ds.x.dtype], k1s8[torch.float8_e4m3fn], k_model.models
    finally:
        ctx.stop()


def phase_cv():
    """CrossValidator over regParam in CV_REGS (3 folds, areaUnderROC) on
    phase 4's data cut to CV_N rows (full width), stacked (parallelism=3,
    K1s) and serial (parallelism=1, K1): the same best regParam and
    avgMetrics to 1e-4. Returns K1s's launches in the stacked run."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.evaluation import \
        BinaryClassificationEvaluator
    from cycloneml_tpu_torch.ml.tuning import CrossValidator, \
        ParamGridBuilder
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_cv")
    try:
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        # bf16 values are exact in f32: the frame's bf16 tier gets them back
        frame = MLFrame(ctx, {"features": ds.x[:CV_N].float().cpu().numpy(),
                              "label": ds.y_host()[:CV_N]})
        del ds
        torch.cuda.empty_cache()
        lr = LogisticRegression(maxIter=25, tol=0.0)
        grid = ParamGridBuilder().add_grid(lr.regParam, list(CV_REGS)).build()
        # each stacked fit's lockstep evaluations, recorded on the way
        evals = []
        fit_stacked = LogisticRegression.fit_stacked

        def recording(self, *args, **kwargs):
            models = fit_stacked(self, *args, **kwargs)
            evals.append(models[0].summary.stacked_evals)
            return models

        def cv(par):
            return _timed(lambda: CrossValidator(
                estimator=lr, estimator_param_maps=grid,
                evaluator=BinaryClassificationEvaluator(), numFolds=3,
                parallelism=par).fit(frame))

        LogisticRegression.fit_stacked = recording
        try:
            kernels.reset_launch_counts()
            st, st_s = cv(3)
            st_k1s = kernels.glm_sweep_stacked.launches
            st_k1 = kernels.glm_sweep.launches
        finally:
            LogisticRegression.fit_stacked = fit_stacked
        kernels.reset_launch_counts()
        se, se_s = cv(1)
        se_k1s = kernels.glm_sweep_stacked.launches
        se_k1 = kernels.glm_sweep.launches
        diff = float(np.max(np.abs(np.asarray(st.avg_metrics)
                                   - np.asarray(se.avg_metrics))))
        best = [CV_REGS[int(np.argmax(m.avg_metrics))] for m in (st, se)]
        _line("cv_fit", n=CV_N, d=FIT_D, folds=3, grid=list(CV_REGS),
              reduced={"n": f"{FIT_N} -> {CV_N} rows (phase 4's first "
                            f"{CV_N}), so the run stays in its time limit"},
              stacked={"avg_metrics": st.avg_metrics, "fit_s": st_s,
                       "k1s_launches": st_k1s, "k1_launches": st_k1,
                       "stacked_evals_per_fold": evals,
                       "best_reg": best[0]},
              serial={"avg_metrics": se.avg_metrics, "fit_s": se_s,
                      "k1s_launches": se_k1s, "k1_launches": se_k1,
                      "best_reg": best[1]},
              max_avg_metric_diff=diff)
        _check("cv fit", {
            "K1s launched once per stacked evaluation of every fold":
                st_k1s == sum(evals) and len(evals) == 3,
            "the stacked CV ran K1 only in its final refit":
                st_k1 == st.best_model.summary.total_evals,
            "the serial CV launched no K1s": se_k1s == 0 and se_k1 > 0,
            "both choose the same regParam": best[0] == best[1],
            "avgMetrics agree to 1e-4": diff <= 1e-4,
        })
        _keep("CrossValidator", st, frame["features"])
        return st_k1s
    finally:
        ctx.stop()


# -- the dense linear family: WLS, bounds, multinomial, LinearSVC, GLM --------

def _tf32_off():
    import torch
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 must be off for the float32 products")


def _gram_ok(a, truth) -> bool:
    """Phase 19's rule for a (d, d) matrix of weighted sums:
    |dA_ij| <= 1e-4 sqrt(A_ii A_jj)."""
    import numpy as np
    diag = np.diag(truth)
    return bool(np.all(np.abs(a - truth)
                       <= 1e-4 * np.sqrt(np.outer(diag, diag))))


def _rel_max(a, truth) -> float:
    """max|a - truth| / max|truth|."""
    import numpy as np
    a, truth = np.asarray(a), np.asarray(truth)
    return float(np.max(np.abs(a - truth))
                 / max(float(np.max(np.abs(truth))), 1e-300))


def _close(a, b, a_icpt, b_icpt) -> bool:
    """Models within the kernel-vs-plain bound (rtol 5e-3, atol 5e-4)."""
    import numpy as np
    return bool(np.allclose(a, b, rtol=5e-3, atol=5e-4)) and bool(
        np.allclose(a_icpt, b_icpt, rtol=5e-3, atol=5e-4))


def _wls_objective64(m, coef, icpt, reg, alpha) -> float:
    """The normal solver's objective at an original-space solution, from
    float64 moments: 1/2 E_w[(y - x.coef - icpt)^2] / var_y + the elastic
    net on the standardized coefficients coef_j sigma_j / sigma_y, with
    population sigmas (WLS's convention)."""
    import numpy as np
    ws = float(m["w_sum"])
    ybar, yy = float(m["b_sum"]) / ws, float(m["bb_sum"]) / ws
    abar, ab, aa = m["a_sum"] / ws, m["ab_sum"] / ws, m["aa_sum"] / ws
    var_y = yy - ybar * ybar
    sx = np.sqrt(np.maximum(np.diag(aa) - abar * abar, 0.0))
    mse = (yy - 2.0 * coef @ ab - 2.0 * icpt * ybar + coef @ aa @ coef
           + 2.0 * icpt * (coef @ abar) + icpt * icpt)
    eff = reg / np.sqrt(var_y)
    b = coef * sx / np.sqrt(var_y)
    return float(0.5 * mse / var_y + alpha * eff * np.sum(np.abs(b))
                 + 0.5 * (1.0 - alpha) * eff * np.sum(b * b))


def phase_wls(k2_objective):
    """LinearRegression through the WLS component at configuration 2's
    shape: a default fit (auto resolves to normal, Cholesky) and
    solver='normal' with regParam=0.001, elasticNetParam=0.5 (OWL-QN over
    the moments); the moments against float64 sums of the same bf16 rows,
    the coefficients against the float64-moment solve, the elastic-net
    objective beside phase 6's K2 fit's, no kernel launched, and on the
    fp8 rung one fallback and no launch. ``k2_objective`` is phase 6's
    final objective. Times: the moments pass beside its bound, the host
    solve, the fits."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.optim import wls
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_wls")
    try:
        ds, gen_s = _timed(lambda: generate_regression(
            ctx, LIN_N, LIN_D, seed=11, noise=0.1))
        enet_kw = dict(regParam=0.001, elasticNetParam=0.5, maxIter=100,
                       tol=1e-7, solver="normal")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        default, default_s = _timed(lambda: LinearRegression().fit(ds))
        enet, enet_s = _timed(lambda: LinearRegression(**enet_kw).fit(ds))
        launches = _other_launches(kernels)
        _, steady_s = _timed(lambda: LinearRegression().fit(ds))
        peak = torch.cuda.max_memory_allocated()

        m32 = wls._moments(ds.x, ds.y, ds.w)
        mom_ms = _time_ms(lambda: wls._moment_sums(ds.x, ds.y, ds.w),
                          reps=3, warm=1)
        bound, bound_by = _bound(ds.x.numel() * ds.x.element_size(),
                                 2.0 * LIN_N * LIN_D * LIN_D)
        m64 = wls._moments(ds.x, ds.y.double(), ds.w.double(),
                           acc=torch.float64)
        vec_err = max(_rel_max(m32[k], m64[k]) for k in ("a_sum", "ab_sum"))
        scal_err = max(abs(float(m32[k]) - float(m64[k])) / abs(float(m64[k]))
                       for k in ("w_sum", "b_sum", "bb_sum"))

        def solver(**kw):
            return wls.WeightedLeastSquares(
                fit_intercept=True, standardize_label=True,
                solver_type=wls.AUTO, **kw)

        _, solve_s = _timed(lambda: solver()._solve_from_moments(m32, LIN_D))
        t_def = solver()._solve_from_moments(m64, LIN_D)
        t_enet = solver(reg_param=0.001, elastic_net_param=0.5, max_iter=100,
                        tol=1e-7)._solve_from_moments(m64, LIN_D)
        ok_def = _close(default.coefficients.values, t_def.coefficients,
                        default.intercept, t_def.intercept)
        ok_enet = _close(enet.coefficients.values, t_enet.coefficients,
                         enet.intercept, t_enet.intercept)
        # the objective the fit reports is 0.5 bb - atb.c + 0.5 c.ata.c
        # over float32 moments: ~4e-4 left of terms ~0.5, so it carries
        # the moments' rounding times ~1e3 (1% here); the solution's
        # objective is evaluated again on the float64 moments
        obj = enet.summary.objective_history[-1]
        obj64 = _wls_objective64(m64, enet.coefficients.values,
                                 enet.intercept, 0.001, 0.5)
        k2_obj = k2_objective
        obj_rel = abs(obj64 - k2_obj) / abs(k2_obj)

        # the fp8 rung: the normal solver leaves it, once, visibly
        ctx.conf.set("cyclone.data.dtype", "float8")
        ds8 = ds.quantized()
        kernels.reset_launch_counts()
        before = len(ctx.precision_fallbacks)
        m8, fp8_s = _timed(lambda: LinearRegression().fit(ds8))
        fp8_launches = _other_launches(kernels)
        fallbacks = ctx.precision_fallbacks[before:]
        _line("wls_fit", n=LIN_N, d=LIN_D, data_dtype=_dt(ds.x),
              generate_s=gen_s,
              default={"solver": "normal (cholesky)", "warm_s": default_s,
                       "steady_s": steady_s,
                       "max_abs_coef_diff_to_f64": float(np.max(np.abs(
                           default.coefficients.values - t_def.coefficients)))},
              elastic_net={"solver": "normal (OWL-QN over the moments)",
                           "iterations": enet.summary.total_iterations,
                           "fit_s": enet_s,
                           "final_objective_reported": obj,
                           "reported_rel_diff": abs(obj - k2_obj) / k2_obj,
                           "final_objective_on_f64_moments": obj64,
                           "f64_solve_objective":
                               t_enet.objective_history[-1],
                           "k2_fit_final_objective": k2_obj,
                           "objective_rel_diff": obj_rel,
                           "zero_coefficients": int(np.sum(
                               enet.coefficients.values == 0))},
              moments={"ms": mom_ms, "bound_ms": bound, "bound_by": bound_by,
                       "aa_max_rel_to_diag": float(np.max(
                           np.abs(m32["aa_sum"] - m64["aa_sum"]) / np.sqrt(
                               np.outer(np.diag(m64["aa_sum"]),
                                        np.diag(m64["aa_sum"]))))),
                       "vector_rel_err": vec_err, "scalar_rel_err": scal_err},
              host_solve_s=solve_s, kernel_launches=launches,
              fp8={"fit_s": fp8_s, "fallbacks": fallbacks,
                   "kernel_launches": fp8_launches},
              max_memory_allocated=peak)
        _check("wls fit", {
            "XᵀWX within 1e-4 sqrt(A_ii A_jj) of float64":
                _gram_ok(m32["aa_sum"], m64["aa_sum"]),
            "moment vectors and sums within 1e-5 of float64":
                vec_err <= 1e-5 and scal_err <= 1e-5,
            "default fit within rtol 5e-3, atol 5e-4 of the float64-moment "
            "solve": ok_def,
            "elastic-net fit within rtol 5e-3, atol 5e-4 of the "
            "float64-moment solve": ok_enet,
            "elastic-net solution's objective (float64 moments) within "
            "1e-4 of phase 6's K2 fit": obj_rel <= 1e-4,
            "neither fit launched a kernel (K2 included)": launches == 0,
            "fp8: one precision fallback, no kernel launched":
                len(fallbacks) == 1 and fp8_launches == 0,
            "finite models": bool(np.all(np.isfinite(
                default.coefficients.values))) and bool(np.all(np.isfinite(
                    m8.coefficients.values))),
        })
    finally:
        ctx.stop()


def phase_bounded():
    """Bounded binomial LogisticRegression on phase 4's data
    (lowerBoundsOnCoefficients = 0, regParam=0.01, maxIter=25, tol=0):
    L-BFGS-B through K1 and through the plain aggregator. Returns K1's
    launches in the K1 fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_bounds")
    try:
        ds, gen_s = _timed(lambda: generate_classification(
            ctx, FIT_N, FIT_D, seed=0))

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: LogisticRegression(
                regParam=0.01, maxIter=25, tol=0.0,
                lowerBoundsOnCoefficients=np.zeros((1, FIT_D))).fit(ds))

        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        k_model, k_s = fit("auto")
        launches = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "logistic")
        p_model, p_s = fit("false")
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        _line("bounded_fit", n=FIT_N, d=FIT_D, data_dtype=_dt(ds.x),
              generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals, "k1_launches": launches,
                      "fit_s": k_s,
                      "final_objective": ks.objective_history[-1],
                      "at_the_bound": int(np.sum(kc == 0.0))},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "fit_s": p_s,
                     "final_objective": ps.objective_history[-1],
                     "at_the_bound": int(np.sum(pc == 0.0))},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              objective_rel_diff=obj_rel,
              train_accuracy=_train_accuracy(ds, kc, k_model.intercept))
        _check("bounded fit", {
            "K1 launched once per evaluation": launches == ks.total_evals,
            "no other kernel launched": others == 0,
            "every coefficient >= 0 exactly": bool(np.all(kc >= 0.0))
            and bool(np.all(pc >= 0.0)),
            "coefficients agree (rtol 5e-3, atol 5e-4)": _close(
                kc, pc, k_model.intercept, p_model.intercept),
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "finite model": bool(np.all(np.isfinite(kc))),
        })
        return launches
    finally:
        ctx.stop()


def phase_multinomial(ovr_models):
    """Multinomial LogisticRegression on phase 16's data (8 classes,
    maxIter=25, regParam=0.01, tol=0, family auto): one aggregator
    evaluation against float64 on the same rows, the fit (warm, steady),
    its predictions beside those of phase 16's OneVsRest ``ovr_models``,
    and the same rows quantized on the card within the fp8 envelope of
    the bf16 fit. Returns the bf16 fit's model."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_multiclass
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.loss import inv_std_vector
    from cycloneml_tpu_torch.ml.stat import Summarizer
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_multinomial")
    try:
        ds, gen_s = _timed(lambda: generate_multiclass(
            ctx, FIT_N, FIT_D, OVR_K, seed=7))
        stats = Summarizer.summarize(ds)
        inv = inv_std_vector(stats.std)
        coef = np.random.RandomState(5).randn(FIT_D * OVR_K + OVR_K) * 0.05
        agg = aggregators.multinomial_logistic_scaled(FIT_D, OVR_K, True)
        dev = ds.x.device
        f32, f64 = torch.float32, torch.float64

        def evaluate(dt):
            t = [torch.as_tensor(a, device=dev).to(dt)
                 for a in (inv, stats.mean * inv, coef)]
            return agg(ds.x, ds.y.to(dt), ds.w.to(dt), *t)

        got, truth = evaluate(f32), evaluate(f64)
        loss_rel = abs(float(got["loss"]) - float(truth["loss"])) \
            / abs(float(truth["loss"]))
        grad_err = _rel_max(got["grad"].double().cpu().numpy(),
                            truth["grad"].cpu().numpy())
        agg_ms = _time_ms(lambda: evaluate(f32), reps=3, warm=1)

        def fit(data):
            return _timed(lambda: LogisticRegression(
                maxIter=25, regParam=0.01, tol=0.0).fit(data))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        model, warm_s = fit(ds)
        launches = _other_launches(kernels)
        again, steady_s = fit(ds)
        peak = torch.cuda.max_memory_allocated()
        wm = model.coefficient_matrix.to_array()
        pred = _argmax_margins(ds, wm, model.intercept_vector.values)
        labels = torch.as_tensor(ds.y_host()[:ds.n_rows], device=dev).long()
        acc = float((pred == labels).double().mean())
        agree_ovr = float((pred == _ovr_margins(ds, ovr_models))
                          .double().mean())

        ctx.conf.set("cyclone.data.dtype", "float8")
        ds8, quant_s = _timed(ds.quantized)
        kernels.reset_launch_counts()
        m8, fp8_s = fit(ds8)
        fp8_launches = _other_launches(kernels)
        envelope = _norm_rel(m8.coefficient_matrix.to_array(), wm)
        s = model.summary
        _line("multinomial_fit", n=FIT_N, d=FIT_D, classes=OVR_K,
              data_dtype=_dt(ds.x), generate_s=gen_s,
              aggregator={"loss_rel_err": loss_rel,
                          "grad_err_rel_to_max": grad_err,
                          "ms": agg_ms},
              fit={"iterations": s.total_iterations, "evals": s.total_evals,
                   "dispatches": s.total_dispatches, "warm_s": warm_s,
                   "steady_s": steady_s,
                   "final_objective": s.objective_history[-1],
                   "kernel_launches": launches},
              train_accuracy=acc, prediction_agreement_with_ovr=agree_ovr,
              fp8={"iterations": m8.summary.total_iterations,
                   "quantize_s": quant_s, "fit_s": fp8_s,
                   "coef_norm_rel_to_bf16": envelope,
                   "kernel_launches": fp8_launches,
                   "fallbacks": ctx.precision_fallbacks},
              max_memory_allocated=peak)
        _check("multinomial fit", {
            "one evaluation: loss within 1e-5 of float64": loss_rel <= 1e-5,
            "one evaluation: gradient within 1e-4 of its largest entry":
                grad_err <= 1e-4,
            "no kernel launched (the multinomial aggregator is plain)":
                launches == 0 and fp8_launches == 0,
            "ran 25 iterations or stopped on an exact float32 stall":
                _ran_to_stop(s),
            "repeat fit reproduces the model": bool(np.array_equal(
                again.coefficient_matrix.to_array(), wm)),
            "finite model": bool(np.all(np.isfinite(wm))),
            "fp8: X is e4m3 codes, no fp8 fallback fired":
                ds8.x.dtype == torch.float8_e4m3fn
                and not ctx.precision_fallbacks,
            "fp8: within the fp8 envelope (20%) of the bf16 fit":
                envelope < FP8_COEF_NORMREL,
        })
        return model
    finally:
        ctx.stop()


def _hinge_sides_differ(ds, coef32, coef64) -> int:
    """Rows whose side of the hinge (1 - y m > 0) differs between the
    float32 and the float64 margins of the same rows."""
    import torch
    d = ds.n_features
    dev = ds.x.device
    c32 = torch.as_tensor(coef32, device=dev)
    c64 = torch.as_tensor(coef64, device=dev)
    differ = 0
    for lo in range(0, ds.n_rows, ROWS64):
        hi = min(lo + ROWS64, ds.n_rows)
        ys = 2.0 * ds.y[lo:hi].double() - 1.0
        m32 = ds.x[lo:hi].float() @ c32[:d] + c32[d]
        m64 = ds.x[lo:hi].double() @ c64[:d] + c64[d]
        differ += int(((1.0 - ys * m32.double() > 0)
                       != (1.0 - ys * m64 > 0)).sum())
    return differ


def phase_svc():
    """LinearSVC on phase 4's data (regParam=0.01, maxIter=25): one hinge
    evaluation on the standardized copy against float64, the rows whose
    side of the hinge differs, the fit's time and its peak memory beside
    X's bytes."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LinearSVC
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.loss import standardize_dataset
    from cycloneml_tpu_torch.ml.stat import Summarizer
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_svc")
    try:
        ds, gen_s = _timed(lambda: generate_classification(
            ctx, FIT_N, FIT_D, seed=0))
        x_bytes = ds.x.numel() * ds.x.element_size()
        stats = Summarizer.summarize(ds)
        std_ds, _ = standardize_dataset(ds, stats.std)
        coef = np.random.RandomState(6).randn(FIT_D + 1) * 0.03
        agg = aggregators.hinge(FIT_D, True)
        dev = ds.x.device

        def evaluate(dt):
            return agg(std_ds.x, std_ds.y.to(dt), std_ds.w.to(dt),
                       torch.as_tensor(coef, device=dev).to(dt))

        got, truth = evaluate(torch.float32), evaluate(torch.float64)
        loss_rel = abs(float(got["loss"]) - float(truth["loss"])) \
            / abs(float(truth["loss"]))
        grad_err = _rel_max(got["grad"].double().cpu().numpy(),
                            truth["grad"].cpu().numpy())
        differ = _hinge_sides_differ(std_ds, coef.astype(np.float32), coef)
        agg_ms = _time_ms(lambda: evaluate(torch.float32), reps=3, warm=1)
        del std_ds, got, truth
        torch.cuda.empty_cache()

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        model, fit_s = _timed(lambda: LinearSVC(regParam=0.01,
                                                maxIter=25).fit(ds))
        launches = _other_launches(kernels)
        peak = torch.cuda.max_memory_allocated()
        coefs = model.coefficients.values
        hist = model.objective_history
        acc = _train_accuracy(ds, coefs, model.intercept)
        _line("svc_fit", n=FIT_N, d=FIT_D, data_dtype=_dt(ds.x),
              generate_s=gen_s,
              hinge={"loss_rel_err": loss_rel,
                     "grad_err_rel_to_max": grad_err,
                     "rows_on_other_side": differ, "ms": agg_ms},
              fit={"iterations": model.total_iterations,
                   "evals": model.total_evals, "fit_s": fit_s,
                   "final_objective": hist[-1], "kernel_launches": launches},
              train_accuracy=acc, x_bytes=x_bytes,
              peak_above_start_bytes=peak - base,
              peak_over_x_bytes=(peak - base) / x_bytes)
        _check("svc fit", {
            "one evaluation: loss within 1e-5 of float64": loss_rel <= 1e-5,
            "one evaluation: gradient within 1e-4 of its largest entry":
                grad_err <= 1e-4,
            "no kernel launched (the hinge aggregator is plain)":
                launches == 0,
            "the objective fell": hist[-1] < hist[0],
            "finite model": bool(np.all(np.isfinite(coefs))),
        })
        _keep("LinearSVC", model, ds.x)
    finally:
        ctx.stop()


def _poisson_irls64(ds, n_iter):
    """A float64 IRLS for the Poisson family with the log link over the
    same rows, on the card and independent of the port's GLM: returns
    the first pass's XᵀWX and the coefficients after ``n_iter`` passes."""
    import torch
    f64 = torch.float64
    n, d = ds.n_rows, ds.n_features
    dev = ds.x.device
    y = ds.y[:n].to(f64)
    beta, icpt, first = torch.zeros(d, dtype=f64, device=dev), 0.0, None
    for it in range(n_iter):
        xtx = torch.zeros((d, d), dtype=f64, device=dev)
        xty = torch.zeros(d, dtype=f64, device=dev)
        xsum = torch.zeros(d, dtype=f64, device=dev)
        wsum = zsum = 0.0
        for lo in range(0, n, ROWS64):
            xc = ds.x[lo:lo + ROWS64].to(f64)
            yc = y[lo:lo + ROWS64]
            if it == 0:
                mu = yc.clamp(min=0.1)
                eta = mu.log()
            else:
                eta = xc @ beta + icpt
                mu = eta.exp()
            z = eta + (yc - mu) / mu        # d eta / d mu = 1 / mu
            xw = xc * mu[:, None]           # W = 1 / (g^2 V) = mu
            xtx += xw.T @ xc
            xty += xw.T @ z
            xsum += xw.sum(0)
            wsum += float(mu.sum())
            zsum += float((mu * z).sum())
        if it == 0:
            first = xtx.cpu().numpy()
        a = torch.zeros((d + 1, d + 1), dtype=f64, device=dev)
        a[:d, :d], a[:d, d], a[d, :d], a[d, d] = xtx, xsum, xsum, wsum
        b = torch.cat([xty, torch.tensor([zsum], dtype=f64, device=dev)])
        sol = torch.linalg.solve(a, b)
        beta, icpt = sol[:d], float(sol[d])
    return first, beta.cpu().numpy(), icpt


def phase_glm():
    """GeneralizedLinearRegression(family="poisson", link="log") at
    400,000 x 2,000 bf16: x from the seeded generator scaled by 1/sqrt(d),
    y ~ Poisson(exp(x.beta)) with beta from numpy; the first IRLS pass's
    XᵀWX against float64, the coefficients against a float64 IRLS over the
    same rows with as many passes, the pass's time beside its bound, the
    summary's time and the fit's."""
    import math

    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import glm
    from cycloneml_tpu_torch.ops import kernels

    _tf32_off()
    ctx = _context("chip_smoke_glm")
    try:
        def make():
            base = generate_regression(ctx, LIN_N, LIN_D, seed=13)
            x, dev = base.x, base.x.device
            beta = torch.as_tensor(
                np.random.RandomState(13).randn(LIN_D) * 0.5,
                dtype=torch.float32, device=dev)
            g = torch.Generator(device=dev).manual_seed(13)
            y = torch.zeros_like(base.y)
            for lo in range(0, base.n_rows, ROWS):
                hi = min(lo + ROWS, base.n_rows)
                xs = x[lo:hi].float() / math.sqrt(LIN_D)
                x[lo:hi] = xs.to(x.dtype)
                y[lo:hi] = torch.poisson(torch.exp(x[lo:hi].float() @ beta),
                                         generator=g).to(y.dtype)
            return base.derive(y=y).attach_host_labels(
                y.cpu().double().numpy(), base.w_host())

        ds, gen_s = _timed(make)
        est = glm.GeneralizedLinearRegression(family="poisson", link="log")
        fam, link = glm._family_link(est)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        model, fit_s = _timed(lambda: est.fit(ds))
        launches = _other_launches(kernels)
        peak = torch.cuda.max_memory_allocated()
        n_iter = model.summary.num_iterations
        off = torch.zeros_like(ds.w)

        first32 = glm._irls_pass(ds.x, ds.y, ds.w, off, np.zeros(LIN_D), 0.0,
                                 True, fam, link)["xtx"].double().cpu().numpy()
        first64, beta64, icpt64 = _poisson_irls64(ds, n_iter)
        pass_ms = _time_ms(lambda: glm._irls_pass(
            ds.x, ds.y, ds.w, off, model._coef, model._icpt, False, fam,
            link), reps=3, warm=1)
        bound, bound_by = _bound(ds.x.numel() * ds.x.element_size(),
                                 2.0 * LIN_N * LIN_D * LIN_D)
        _, summary_s = _timed(lambda: est._summarize(
            model, ds, off, False, fam, link, n_iter))
        coefs = model.coefficients.values
        s = model.summary
        _line("glm_fit", n=LIN_N, d=LIN_D, data_dtype=_dt(ds.x),
              family="poisson", link="log", generate_s=gen_s,
              fit={"iterations": n_iter, "fit_s": fit_s,
                   "deviance_history": s.objective_history,
                   "kernel_launches": launches},
              irls_pass={"ms": pass_ms, "bound_ms": bound,
                         "bound_by": bound_by},
              summary_s=summary_s, deviance=s.deviance,
              null_deviance=s.null_deviance, aic=s.aic,
              max_abs_coef_diff_to_f64=float(np.max(np.abs(coefs - beta64))),
              intercepts=[model.intercept, icpt64],
              first_pass_xtwx_max_rel_to_diag=float(np.max(
                  np.abs(first32 - first64) / np.sqrt(np.outer(
                      np.diag(first64), np.diag(first64))))),
              max_memory_allocated=peak)
        _check("glm fit", {
            "first pass XᵀWX within 1e-4 sqrt(A_ii A_jj) of float64":
                _gram_ok(first32, first64),
            "coefficients within rtol 5e-3, atol 5e-4 of the float64 IRLS "
            "with as many passes": _close(coefs, beta64, model.intercept,
                                          icpt64),
            "no kernel launched": launches == 0,
            "the deviance fell below the null deviance":
                s.deviance < s.null_deviance,
            "finite model and standard errors": bool(np.all(np.isfinite(
                coefs))) and bool(np.all(np.isfinite(
                    s.coefficient_standard_errors))),
        })
        _keep("GeneralizedLinearRegression", model, ds.x)
    finally:
        ctx.stop()


# -- the sparse tier: S1 and S2, Criteo-class LR, configuration 5 -------------

def _ell_pair(ds, beta, b0, link, scale, columns=None, plain=False):
    """S1 then S2 on the dataset's rows: ``(mult, loss, sum(mult), sum(w),
    grad)``; the kernels, or with ``plain`` their plain versions at
    beta's dtype (the float64 truth for a float64 beta)."""
    from cycloneml_tpu_torch.ops import kernels
    rows = kernels.ell_rows_plain if plain else kernels.ell_rows
    extra = {} if plain else {"hot": ds.hot_columns()}
    mult, loss, msum, wsum = rows(ds.indices, ds.values, ds.y, ds.w, beta, b0,
                                  link, scale, ds.tail(), **extra)
    if plain:
        grad = kernels.ell_cols_plain(ds.indices, ds.values, mult,
                                      ds.n_features, scale=scale,
                                      tail=ds.tail())
    else:
        grad = kernels.ell_cols(ds.indices, ds.values, mult, ds.n_features,
                                scale=scale, tail=ds.tail(), columns=columns)
    return mult, loss, msum, wsum, grad


def _abs_sums(ds, scale, beta=None, r=None):
    """Float64 sums of the absolute terms of a pass, a chunk of rows at a
    time (with the tail): per row sum |v s beta| (given ``beta``: the
    scale of the row's margin), or per column sum |r v s| (given ``r``:
    the scale of the column's sum); v s is the float32 product the passes
    form."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n = ds.indices.shape[0]
    rows_out = beta is not None
    out = torch.zeros(n if rows_out else ds.n_features, dtype=torch.float64,
                      device=ds.device)
    b = None if beta is None else beta.double().abs()
    rr = None if r is None else r.double().abs()

    def av(v, cols):
        return (v if scale is None else v * scale[cols]).abs().double()

    for lo in range(0, n, ROWS):
        hi = min(lo + ROWS, n)
        c = ds.indices[lo:hi].long()
        v = av(ds.values[lo:hi], c)
        if rows_out:
            out[lo:hi] = torch.sum(v * b[c], 1)
        else:
            out.index_add_(0, c.reshape(-1), (v * rr[lo:hi, None]).reshape(-1))
    tail = ds.tail()
    if tail is not None:
        t_rows, c = kernels.tail_row_ids(tail), tail.cols.long()
        v = av(tail.vals, c)
        if rows_out:
            out.index_add_(0, t_rows, v * b[c])
        else:
            out.index_add_(0, c, v * rr[t_rows])
    return out


# S1 forms each slot's product v s beta in float32 (the truth forms it in
# float64 from the same float32 factors) and sums in double, so a row's
# margin is off by at most 2^-24 M_i, M_i = sum |v s beta|; its mult by at
# most L_i 2^-24 M_i plus float32's rounding of mult, L_i the link's slope
# (w/4 logistic, w squared, [w > 0] Gram). S2 forms r v s in float32 as its
# plain version does and sums in double: a column is off by float32's
# rounding of the result and a double rounding of A_j = sum |r v s|. The
# checks below hold every row and every column to these bounds, at twice
# the unit roundoff.
ELL_ROW_RTOL = 1.2e-7     # ~2 * 2^-24
ELL_COL_RTOL = 1e-7       # float32 rounding of each column's sum
ELL_COL_ATOL = 1e-9       # relative to A_j: the two double sums' orders


def _col_excess(got, truth, scale_a):
    """The largest |got - truth| / (ELL_COL_RTOL |truth| + ELL_COL_ATOL
    A_j) over the columns: at most 1 where every column holds."""
    import torch
    err = (got.double() - truth).abs()
    tol = ELL_COL_RTOL * truth.abs() + ELL_COL_ATOL * scale_a
    return float(torch.max(err / torch.clamp(tol, min=1e-300)))


def phase_ell(ds, columns):
    """S1 and S2 against float64 on the Criteo-class rows: one evaluation
    per link (logistic with the fit's standardizing scale; squared, hinge,
    Gram) and the moments mode. Each row's mult and each column's sum is
    held to its own scale (the bounds above): S1's mult against the
    float64 truth, row by row (a hinge row exact unless its margin lies
    within its bound of the hinge); S2 on S1's own mult against its plain
    version summed in float64, column by column; the loss within the
    bound the rows' margins allow, sum(mult) the double sum of mult,
    sum(w) exact; two launches bitwise equal. Then the times of each
    beside its plain version (float32), its bounds and cuSPARSE CSR SpMV
    (X beta, a yardstick for S1; X^T r, the same function as S2's
    gradient). Returns the kernels line's numbers of S1 and S2."""
    import torch
    from cycloneml_tpu_torch.dataset.sparse import sparse_feature_std
    from cycloneml_tpu_torch.ops import kernels

    dev = ds.device
    n, k = ds.indices.shape
    d = ds.n_features
    g = torch.Generator(device=dev).manual_seed(21)
    beta = torch.randn(d, generator=g, device=dev) * 0.1
    inv = torch.as_tensor(sparse_feature_std(ds), device=dev)
    inv = torch.where(inv > 0, 1.0 / torch.where(inv > 0, inv, 1.0),
                      0.0).float()
    w64 = ds.w.double()
    # the float64 margins (for the hinge's rows near its kink) and the
    # rows' margin scales, unscaled and with the standardizing scale
    margin_t = kernels.ell_rows_plain(
        ds.indices, ds.values, ds.y, torch.ones_like(ds.w), beta.double(),
        -1.0, kernels.GRAM, None, ds.tail())[0]
    m_scale = {None: _abs_sums(ds, None, beta=beta),
               "inv": _abs_sums(ds, inv, beta=beta)}
    slope = {kernels.LOGISTIC: w64 / 4, kernels.SQUARED: w64,
             kernels.HINGE: w64, kernels.GRAM: (w64 > 0).double()}
    errs, checks = {}, {}
    for link, scale in ((kernels.LOGISTIC, inv), (kernels.SQUARED, None),
                        (kernels.HINGE, None), (kernels.GRAM, None)):
        big_m = m_scale["inv" if scale is not None else None]
        a = _ell_pair(ds, beta, -1.0, link, scale, columns)
        b = _ell_pair(ds, beta, -1.0, link, scale, columns)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(a, b))
        del b
        t = _ell_pair(ds, beta.double(), -1.0, link, scale, plain=True)
        # S1, row by row
        dmult = (a[0].double() - t[0]).abs()
        if link == kernels.HINGE:
            near = (1.0 - (2.0 * ds.y.double() - 1.0) * margin_t).abs() \
                <= ELL_ROW_RTOL * big_m
            mult_excess = float(torch.max(torch.where(near, 0.0, dmult)))
            n_near = int(near.sum())
            deriv = w64
        else:
            tol = ELL_ROW_RTOL * (slope[link] * big_m + t[0].abs())
            mult_excess = float(torch.max(dmult / torch.clamp(tol,
                                                              min=1e-300)))
            n_near = 0
            deriv = t[0].abs() if link != kernels.GRAM else 0.0 * w64
        del dmult
        loss_tol = ELL_ROW_RTOL * float(torch.sum(deriv * big_m)) \
            + 1e-12 * abs(float(t[1]))
        loss_err = abs(float(a[1]) - float(t[1]))
        msum_err = abs(float(a[2]) - float(torch.sum(a[0].double())))
        msum_tol = 1e-12 * float(torch.sum(a[0].double().abs()))
        # S2 on S1's own mult, column by column
        g_t = kernels.ell_cols_plain(ds.indices, ds.values, a[0], d,
                                     scale=scale, tail=ds.tail(),
                                     acc_dtype=torch.float64)
        col_excess = _col_excess(a[4], g_t, _abs_sums(ds, scale, r=a[0]))
        del g_t
        errs[link] = {"loss_err": loss_err, "loss_bound": loss_tol,
                      "loss_rel": loss_err / max(abs(float(t[1])), 1e-300),
                      "mult_max_abs_err": float((a[0].double() - t[0])
                                                .abs().max()),
                      "mult_worst_over_row_bound": mult_excess,
                      "hinge_rows_near_kink": n_near,
                      "grad_worst_over_column_bound": col_excess,
                      "max_abs_grad_err_vs_float64_chain": float(
                          (a[4].double() - t[4]).abs().max()),
                      "max_abs_grad": float(t[4].abs().max()),
                      "sum_mult_err": msum_err, "bitwise_equal": bitwise,
                      "sum_w": float(a[3])}
        checks.update({
            f"{link}: |dloss| <= 1e-5 |loss|": errs[link]["loss_rel"] <= 1e-5
            or float(t[1]) == 0.0,
            f"{link}: max|dgrad| <= 1e-4 max|grad| (S1 then S2, float64)":
                errs[link]["max_abs_grad_err_vs_float64_chain"]
                <= 1e-4 * errs[link]["max_abs_grad"],
            f"{link}: every row's mult within its bound"
            + (" (exact off the kink)" if link == kernels.HINGE else ""):
                mult_excess <= 1.0,
            f"{link}: |dloss| within the rows' margin bound":
                loss_err <= loss_tol,
            f"{link}: sum(mult) is the double sum of mult":
                msum_err <= msum_tol,
            f"{link}: S2 on S1's mult, every column within its bound":
                col_excess <= 1.0,
            f"{link}: sum(w) exact": float(a[3]) == float(t[3]),
            f"{link}: two launches bitwise equal": bitwise,
        })
        del a, t
    del margin_t, m_scale
    m1 = kernels.ell_cols(ds.indices, ds.values, ds.w, d, moments=True,
                          columns=columns)
    m2 = kernels.ell_cols(ds.indices, ds.values, ds.w, d, moments=True,
                          columns=columns)
    tm = kernels.ell_cols_plain(ds.indices, ds.values, ds.w, d, moments=True,
                                acc_dtype=torch.float64)
    # sum w v is held to sum |w v|; the other two have no negative term
    a0 = _abs_sums(ds, None, r=ds.w)
    mom_excess = [_col_excess(m1[q], tm[q], a0 if q == 0 else tm[q].abs())
                  for q in range(3)]
    mom_err = [float((m1[q].double() - tm[q]).abs().max()
                     / tm[q].abs().max()) for q in range(3)]
    checks["moments: max|d| <= 1e-4 max|moment|"] = max(mom_err) <= 1e-4
    checks["moments: every column within its bound"] = max(mom_excess) <= 1.0
    checks["moments: two launches bitwise equal"] = torch.equal(m1, m2)
    del m1, m2, tm, a0

    # times at the fit's form: the logistic link with the scale, each
    # kernel beside its cuSPARSE yardstick in turns (kernel, library,
    # library, kernel) over the same buffers: the ELL as CSR rows of k
    # slots (X beta), and a copy of the nonzeros in plain column order (one
    # block over all rows) as CSR rows of X^T (X^T r, as PERF.md §6 has it).
    # S2 also runs over that one-block copy, the column order of the design
    # before the row blocks, in turns with S2 over the blocked copy
    hot = ds.hot_columns()

    def s1():
        return kernels.ell_rows(ds.indices, ds.values, ds.y, ds.w, beta,
                                -1.0, kernels.LOGISTIC, inv, hot=hot)

    mult = s1()[0]
    crow = torch.arange(0, n * k + 1, k, dtype=torch.int32, device=dev)
    x_csr = torch.sparse_csr_tensor(crow, ds.indices.view(-1),
                                    ds.values.view(-1), size=(n, d),
                                    check_invariants=False)
    s1_turns = [_time_ms(f, 5, 1) for f in (
        s1, lambda: torch.mv(x_csr, beta), lambda: torch.mv(x_csr, beta),
        s1)]
    del x_csr, crow
    one = kernels.ell_columns(ds.indices, ds.values, d, ds.tail(),
                              block_rows=1 << max(n - 1, 1).bit_length())
    col_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(kernels.column_counts(one, d), 0)
    xt_csr = torch.sparse_csr_tensor(col_ptr.int(), one.rows, one.vals,
                                     size=(d, n), check_invariants=False)

    def s2():
        return kernels.ell_cols(ds.indices, ds.values, mult, d, scale=inv,
                                columns=columns)

    def s2_one_block():
        return kernels.ell_cols(ds.indices, ds.values, mult, d, scale=inv,
                                columns=one)

    s2_turns = [_time_ms(f, 5, 1) for f in (
        s2, lambda: torch.mv(xt_csr, mult), lambda: torch.mv(xt_csr, mult),
        s2)]
    one_turns = [_time_ms(f, 5, 1) for f in (
        s2_one_block, s2, s2, s2_one_block)]
    one_pieces = one.piece_col.shape[0]
    del xt_csr, col_ptr, one
    s1_ms, spmv_x = (s1_turns[0] + s1_turns[3]) / 2, min(s1_turns[1:3])
    s2_ms, spmv_xt = (s2_turns[0] + s2_turns[3]) / 2, min(s2_turns[1:3])
    one_ms = (one_turns[0] + one_turns[3]) / 2
    mom_ms = _time_ms(lambda: kernels.ell_cols(
        ds.indices, ds.values, ds.w, d, moments=True, columns=columns), 3, 1)
    s1_plain = _time_ms(lambda: kernels.ell_rows_plain(
        ds.indices, ds.values, ds.y, ds.w, beta, -1.0, kernels.LOGISTIC,
        inv), 2, 1)
    s2_plain = _time_ms(lambda: kernels.ell_cols_plain(
        ds.indices, ds.values, mult, d, scale=inv), 2, 1)
    nnz = int(columns.block_ptr[-1])
    n_pieces = columns.piece_col.shape[0]
    s1_bytes = n * k * 8 + n * 12 + d * 8
    # what X^T r must move: the nonzeros, r and the output (the copy's
    # piece metadata is the layout's own, printed apart)
    s2_bytes = nnz * 8 + n * 4 + d * 4
    s1_bound, s1_by = _bound(s1_bytes, 2.0 * n * k)
    s2_bound, s2_by = _bound(s2_bytes, 2.0 * nnz)
    gather = {"s1_with_beta_sector_gathers_ms":
              (s1_bytes + n * k * 32) / H100_BYTES_PER_S * 1e3,
              "s2_with_mult_sector_gathers_ms":
              (s2_bytes + nnz * 32) / H100_BYTES_PER_S * 1e3}
    share = kernels.hot_share(hot, kernels.column_counts(columns, d))
    layout = {"block_rows": columns.block_rows,
              "blocks": columns.block_ptr.shape[0] - 1, "pieces": n_pieces,
              "piece_metadata_bytes": (n_pieces + 1) * 8 + n_pieces * 8
              + (d + 1) * 8, "hot_slots": hot.shape[0],
              "hot_share_of_s1_slots": share}
    _line("ell_check", n=n, k=k, d=d, nnz=nnz, **layout, links=errs,
          moments_rel_err=mom_err, moments_worst_over_column_bound=mom_excess,
          row_rtol=ELL_ROW_RTOL, column_rtol=ELL_COL_RTOL,
          column_atol_of_abs_sum=ELL_COL_ATOL)
    _line("ell_time", s1_ms=s1_ms, s2_ms=s2_ms, s2_moments_ms=mom_ms,
          s1_plain_ms=s1_plain, s2_plain_ms=s2_plain, s1_bound_ms=s1_bound,
          s2_bound_ms=s2_bound, bound_by=[s1_by, s2_by],
          spmv_x_beta_ms=spmv_x, spmv_xt_r_ms=spmv_xt,
          s1_turns_kernel_spmv_spmv_kernel_ms=s1_turns,
          s2_turns_kernel_spmv_spmv_kernel_ms=s2_turns,
          s2_one_block_ms=one_ms, one_block_pieces=one_pieces,
          s2_turns_one_block_blocked_blocked_one_block_ms=one_turns,
          **gather)
    _check("ell", checks)
    s1 = {"max_abs_err": errs[kernels.LOGISTIC]["mult_max_abs_err"],
          "ms": s1_ms, "plain_ms": s1_plain, "bound_ms": s1_bound,
          "bound_by": s1_by, "library_ms": None, "yardstick_ms": spmv_x,
          "turns_ms": s1_turns, "hot_slots": layout["hot_slots"],
          "hot_share": share,
          "bound_with_sector_gathers_ms":
              gather["s1_with_beta_sector_gathers_ms"]}
    s2 = {"max_abs_err":
          errs[kernels.LOGISTIC]["max_abs_grad_err_vs_float64_chain"],
          "ms": s2_ms, "plain_ms": s2_plain, "bound_ms": s2_bound,
          "bound_by": s2_by, "library_ms": spmv_xt, "moments_ms": mom_ms,
          "turns_ms": s2_turns, "block_rows": columns.block_rows,
          "blocks": layout["blocks"], "pieces": n_pieces,
          "piece_metadata_bytes": layout["piece_metadata_bytes"],
          "one_block_ms": one_ms, "one_block_turns_ms": one_turns,
          "bound_with_sector_gathers_ms":
              gather["s2_with_mult_sector_gathers_ms"]}
    return s1, s2


def _sparse_margins(ds, coef, intercept):
    """X coef + intercept of the real rows, float32, on the card."""
    import torch
    c = torch.as_tensor(coef, dtype=torch.float32, device=ds.device)
    out = torch.empty(ds.n_rows, dtype=torch.float32, device=ds.device)
    for lo in range(0, ds.n_rows, ROWS):
        hi = min(lo + ROWS, ds.n_rows)
        out[lo:hi] = torch.sum(ds.values[lo:hi] * c[ds.indices[lo:hi].long()],
                               1) + intercept
    return out


def _auc(scores, labels) -> float:
    """Area under the ROC curve by the rank sum (ties have probability 0
    for continuous scores), on the card in float64."""
    import torch
    n = scores.shape[0]
    ranks = torch.empty(n, dtype=torch.float64, device=scores.device)
    ranks[torch.argsort(scores)] = torch.arange(
        1, n + 1, dtype=torch.float64, device=scores.device)
    pos = labels > 0.5
    p = float(pos.sum())
    return (float(ranks[pos].sum()) - p * (p + 1) / 2) / (p * (n - p))


def _sparse_fit(ctx, ds, mode):
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    ctx.conf.set("cyclone.ml.usePallasKernels", mode)
    return _timed(lambda: LogisticRegression(maxIter=25, regParam=0.01)
                  .fit(ds))


def _split_fit(ctx, ds):
    """One kernel fit, as :func:`_sparse_fit`, with its host time taken
    apart by wrapping the fit's own calls (each wrapper synchronizes the
    card on both sides of what it times, where the fit reads back anyway):

    - ``std_s``: the feature std, the moments launch and its readback;
    - ``setup_other_s``: the rest before the first evaluation (the label
      mask and histogram over the rows, the standardized view, the L2
      term);
    - ``evals_device_s``: every evaluation's S1 and S2 with their sums;
    - ``evals_host_s``: the rest of the loss function's calls (the
      coefficients to the card, the gradient back, the scalar readbacks
      of the line searches, the normalizing and L2 arithmetic);
    - ``optimizer_s``: the host optimizer between its calls (the two-loop
      and the line search's bookkeeping in numpy);
    - ``finish_s``: after the last evaluation (unscaling, the model).

    Returns ``(model, seconds, split)``."""
    import torch
    from cycloneml_tpu_torch.dataset import sparse as sp
    from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction

    clock = time.perf_counter
    split = {"std_s": 0.0, "evals_device_s": 0.0, "loss_calls_s": 0.0,
             "evaluations": 0}
    marks = {"in_std": False, "first": None, "last": None}
    cls = sp.SparseInstanceDataset
    std0, agg0 = sp.sparse_feature_std, cls.tree_aggregate_fn
    call0 = DistributedLossFunction.__call__
    search0 = DistributedLossFunction.device_line_search

    def synced(fn, *args):
        torch.cuda.synchronize()
        t = clock()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, t, clock()

    def std(d):
        marks["in_std"] = True
        out, t, u = synced(std0, d)
        marks["in_std"] = False
        split["std_s"] += u - t
        return out

    def tree_aggregate_fn(self, fn, auto_psum=True):
        inner = agg0(self, fn, auto_psum)

        def call(*extras):
            out, t, u = synced(inner, *extras)
            if not marks["in_std"]:
                split["evals_device_s"] += u - t
                split["evaluations"] += 1
            return out

        call.compiled, call.arrays = inner.compiled, inner.arrays
        return call

    def loss_call(fn):
        def wrapped(self, *args):
            out, t, u = synced(fn, self, *args)
            marks["first"] = t if marks["first"] is None else marks["first"]
            marks["last"] = u
            split["loss_calls_s"] += u - t
            return out
        return wrapped

    sp.sparse_feature_std = std
    cls.tree_aggregate_fn = tree_aggregate_fn
    DistributedLossFunction.__call__ = loss_call(call0)
    DistributedLossFunction.device_line_search = loss_call(search0)
    try:
        torch.cuda.synchronize()
        t0 = clock()
        model, _ = _sparse_fit(ctx, ds, "auto")
        torch.cuda.synchronize()
        end = clock()
    finally:
        sp.sparse_feature_std = std0
        cls.tree_aggregate_fn = agg0
        DistributedLossFunction.__call__ = call0
        DistributedLossFunction.device_line_search = search0
    first, last = marks["first"], marks["last"]
    out = {"std_s": split["std_s"],
           "setup_other_s": first - t0 - split["std_s"],
           "evals_device_s": split["evals_device_s"],
           "evals_host_s": split["loss_calls_s"] - split["evals_device_s"],
           "optimizer_s": last - first - split["loss_calls_s"],
           "finish_s": end - last, "evaluations": split["evaluations"]}
    return model, end - t0, out


def phase_criteo():
    """Criteo-class sparse LogisticRegression at full size: the rows drawn
    on the card, the column copy built, phase_ell's checks on them, then
    ``LogisticRegression(maxIter=25, regParam=0.01).fit`` through S1 and
    S2 (three times: bitwise-equal models, the third with its host time
    taken apart by :func:`_split_fit`) and through the plain aggregator,
    on the card's float32 accumulator tier and again on the float64 tier.
    After 25 iterations short of convergence on these ill-conditioned
    hashed columns, float32 line searches that round differently part by
    ~4e-3 in single coefficients (two plain fits alone, float32 and
    float64 sums, do), so the coefficients are held to rtol 5e-3 / atol
    5e-4 on the float64 tier, and the float32 tier's kernel coefficients
    to 1e-2 absolute of the float64 plain fit's (a deterministic
    reference; the float32 plain fit's index_add_ order changes from run
    to run). The intercept, unregularized and tied to the uncentered
    dense columns, parts further on the float32 tier (1.2e-2): it is
    printed, and held on the float64 tier. The objectives are held on
    both. Returns S1's and S2's numbers and launches."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_criteo")
    try:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ds, gen_s = _timed(lambda: generate_criteo_like(
            ctx, CRITEO_N, seed=0, hash_dim=CRITEO_D))
        ell_bytes = ds.indices.numel() * 8
        columns, sort_s = _timed(ds.columns)
        setup_peak = torch.cuda.max_memory_allocated() - base
        hot, hot_s = _timed(ds.hot_columns)
        _, labels_s = _timed(ds.y_host)
        nnz = int(columns.block_ptr[-1])
        counts = kernels.column_counts(columns, CRITEO_D)
        n_pieces = columns.piece_col.shape[0]
        _line("criteo_data", n=CRITEO_N, k=ds.k_max, d=CRITEO_D, nnz=nnz,
              ell_bytes=ell_bytes, column_copy_bytes=nnz * 8,
              block_rows=columns.block_rows,
              blocks=columns.block_ptr.shape[0] - 1, pieces=n_pieces,
              piece_metadata_bytes=(n_pieces + 1) * 8 + n_pieces * 8
              + (CRITEO_D + 1) * 8,
              largest_column=int(counts.max()),
              empty_columns=int((counts == 0).sum()),
              hot_slots=hot.shape[0],
              hot_share_of_s1_slots=kernels.hot_share(hot, counts),
              positive_share=float(ds.y[:CRITEO_N].mean()),
              generate_s=gen_s, column_copy_s=sort_s, hot_table_s=hot_s,
              label_readback_s=labels_s,
              setup_peak_bytes=setup_peak)
        del counts
        s1, s2 = phase_ell(ds, columns)

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = _sparse_fit(ctx, ds, "auto")
        s1_launches = kernels.ell_rows.launches
        s2_launches = kernels.ell_cols.launches
        others = _other_launches(kernels, "ell_rows", "ell_cols")
        k_again, k_steady = _sparse_fit(ctx, ds, "auto")
        peak = torch.cuda.max_memory_allocated() - base
        k_split, split_s, split = _split_fit(ctx, ds)
        p_model, p_s = _sparse_fit(ctx, ds, "false")
        # the same two fits on the float64 accumulator tier (float64
        # coefficients, line search and plain sums; the kernels as ever)
        ctx.conf.set("cyclone.compute.dtype", "float64")
        k64, k64_s = _sparse_fit(ctx, ds, "auto")
        p64, p64_s = _sparse_fit(ctx, ds, "false")
        # the intercept's gradient at the float64 plain fit's solution: a
        # fault in how S1 and S2 fold the intercept and the scale shows
        # here, where line searches cannot part
        icpt_eval = _intercept_eval(ds, columns, p64)
        _line("criteo_intercept_eval", **icpt_eval,
              objectives_part_at_iteration={
                  "kernel_f32": _history_parts(k_model, p64),
                  "plain_f32": _history_parts(p_model, p64),
                  "kernel_f64": _history_parts(k64, p64)})
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values

        def coef_close(a, b):
            return bool(np.allclose(a.coefficients.values,
                                    b.coefficients.values, rtol=5e-3,
                                    atol=5e-4)) and \
                abs(a.intercept - b.intercept) <= 5e-4 + 5e-3 * abs(
                    b.intercept)

        def max_dcoef(a, b):
            return float(np.max(np.abs(a.coefficients.values
                                       - b.coefficients.values)))

        def obj_rel(a, b):
            fa = a.summary.objective_history[-1]
            fb = b.summary.objective_history[-1]
            return abs(fa - fb) / abs(fb)

        bitwise = all(bool(np.array_equal(kc, m.coefficients.values))
                      and k_model.intercept == m.intercept
                      for m in (k_again, k_split))
        evals = ks.total_evals
        kernel_s = evals * (s1["ms"] + s2["ms"]) / 1e3 + s2["moments_ms"] / 1e3
        margins = _sparse_margins(ds, kc, k_model.intercept)
        auc = _auc(margins, ds.y[:CRITEO_N])
        del margins
        _line("criteo_fit", iterations=ks.total_iterations, evals=evals,
              dispatches=ks.total_dispatches, s1_launches=s1_launches,
              s2_launches=s2_launches, warm_s=k_warm, steady_s=k_steady,
              kernels_s=kernel_s, host_s=k_steady - kernel_s,
              split_fit_s=split_s, split=split,
              final_objective=ks.objective_history[-1],
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "fit_s": p_s,
                     "final_objective": ps.objective_history[-1]},
              float64_tier={"kernel_fit_s": k64_s, "plain_fit_s": p64_s,
                            "kernel_evals": k64.summary.total_evals,
                            "plain_evals": p64.summary.total_evals,
                            "objective_rel_diff": obj_rel(k64, p64),
                            "max_abs_coef_diff": max_dcoef(k64, p64)},
              objective_rel_diff=obj_rel(k_model, p_model),
              max_abs_coef_diff=max_dcoef(k_model, p_model),
              max_abs_coef=float(np.max(np.abs(pc))),
              plain_f32_to_f64_max_abs_coef_diff=max_dcoef(p_model, p64),
              kernel_f32_to_plain_f64_max_abs_coef_diff=max_dcoef(k_model,
                                                                  p64),
              kernel_f32_to_plain_f64_intercept_diff=abs(
                  k_model.intercept - p64.intercept),
              plain_f32_to_f64_intercept_diff=abs(p_model.intercept
                                                  - p64.intercept),
              bitwise_equal_refit=bitwise, train_auc=auc,
              max_memory_allocated=peak, ell_bytes=ell_bytes,
              peak_over_ell=peak / ell_bytes,
              evals_device_s=split["evals_device_s"])
        _check("criteo fit", {
            "S1 launched once per evaluation": s1_launches == evals,
            "S2 launched once per evaluation and once for the summary":
                s2_launches == evals + 1,
            "no other kernel launched": others == 0,
            "final objectives agree to 1e-4 (float32 tier)":
                obj_rel(k_model, p_model) <= 1e-4,
            "final objectives agree to 1e-4 (float64 tier)":
                obj_rel(k64, p64) <= 1e-4,
            "coefficients agree, rtol 5e-3, atol 5e-4 (float64 tier)":
                coef_close(k64, p64),
            "float32-tier kernel fit's coefficients within 1e-2 absolute "
            "of the float64 plain fit's": max_dcoef(k_model, p64) <= 1e-2,
            "the split fit's evaluations are the fit's":
                split["evaluations"] == evals,
            "three kernel fits bitwise equal": bitwise,
            "finite model": bool(np.all(np.isfinite(kc))),
            "training AUC above 0.5": auc > 0.5,
            "at one point, the kernels' intercept gradient within its rows' "
            "bounds of float64": icpt_eval["msum_err"]
                <= icpt_eval["msum_bound"],
        })
        return {"s1": s1, "s2": s2, "s1_launches": s1_launches,
                "s2_launches": s2_launches}
    finally:
        ctx.stop()


def _intercept_eval(ds, columns, model):
    """One evaluation of the fit's pass (S1 with the standardizing scale,
    then S2) at ``model``'s solution, through the kernels and through the
    plain versions in float64: the intercept's gradient sum(mult) against
    the sum of its rows' bounds (phase 24's: 2x float32's unit roundoff of
    w/4 sum|v s beta| + |mult| a row), the loss and the gradient."""
    import torch
    from cycloneml_tpu_torch.dataset.sparse import sparse_feature_std
    from cycloneml_tpu_torch.ops import kernels
    std = torch.as_tensor(sparse_feature_std(ds), device=ds.device)
    inv = torch.where(std > 0, 1.0 / torch.where(std > 0, std, 1.0),
                      0.0).float()
    # the fit's standardized coefficients: coef = beta_std * inv_std
    beta = torch.as_tensor(model.coefficients.values, dtype=torch.float64,
                           device=ds.device) * std
    a = _ell_pair(ds, beta.float(), model.intercept, kernels.LOGISTIC, inv,
                  columns)
    torch.cuda.synchronize()
    t = _ell_pair(ds, beta, model.intercept, kernels.LOGISTIC, inv,
                  plain=True)
    bound = ELL_ROW_RTOL * float(torch.sum(
        ds.w.double() / 4 * _abs_sums(ds, inv, beta=beta.float())
        + t[0].abs()))
    wsum = float(t[3])
    return {"msum_err": abs(float(a[2]) - float(t[2])),
            "msum_bound": bound,
            "msum_err_over_wsum": abs(float(a[2]) - float(t[2])) / wsum,
            "rel_loss": abs(float(a[1]) - float(t[1])) / abs(float(t[1])),
            "grad_err_over_max": float((a[4].double() - t[4]).abs().max())
            / float(t[4].abs().max())}


def phase_config5():
    """BASELINE configuration 5: RowMatrix.compute_svd(20) by Lanczos over
    the NYTimes-shape bag of words (the reference's numpy recipe), the
    matvec S1 (Gram link) then S2; one matvec against float64, then all 20
    singular values against scipy's svds in float64 on the same CSR.
    Returns the launches."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from cycloneml_tpu_torch.dataset.random import nytimes_like
    from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_config5")
    try:
        (idx, val), gen_s = _timed(lambda: nytimes_like(NYT_N, NYT_D, NYT_K))
        ds, ingest_s = _timed(lambda: SparseInstanceDataset.from_ell(
            ctx, idx, val, n_features=NYT_D))
        columns, sort_s = _timed(ds.columns)
        g = torch.Generator(device=ds.device).manual_seed(5)
        q = torch.randn(NYT_D, generator=g, device=ds.device)
        a = _ell_pair(ds, q, 0.0, kernels.GRAM, None, columns)
        b = _ell_pair(ds, q, 0.0, kernels.GRAM, None, columns)
        t = _ell_pair(ds, q.double(), 0.0, kernels.GRAM, None, plain=True)
        mv_err = float((a[4].double() - t[4]).abs().max() / t[4].abs().max())
        mv_bitwise = all(torch.equal(u, v) for u, v in zip(a, b))
        del a, b, t

        kernels.reset_launch_counts()
        res, svd_s = _timed(lambda: RowMatrix(ds).compute_svd(
            NYT_SV, max_gram_dim=4096, tol=1e-9, max_iter=300))
        steps = kernels.ell_rows.launches_by_link[kernels.GRAM]
        s1, s2 = kernels.ell_rows.launches, kernels.ell_cols.launches
        others = _other_launches(kernels, "ell_rows", "ell_cols")
        # the step's two kernels at this shape, as the Lanczos step calls
        # them (the Gram link, the hot table, the column copy)
        hot = ds.hot_columns()
        mult = kernels.ell_rows(ds.indices, ds.values, ds.y, ds.w, q, 0.0,
                                kernels.GRAM, None, hot=hot)[0]
        s1_ms = _time_ms(lambda: kernels.ell_rows(
            ds.indices, ds.values, ds.y, ds.w, q, 0.0, kernels.GRAM, None,
            hot=hot), 20)
        s2_ms = _time_ms(lambda: kernels.ell_cols(
            ds.indices, ds.values, mult, NYT_D, columns=columns), 20)
        del mult
        kernel_s = steps * (s1_ms + s2_ms) / 1e3
        sig = res.s.to_array()
        rows = np.repeat(np.arange(NYT_N), NYT_K)
        csr = sp.csr_matrix((val.reshape(-1).astype(np.float64),
                             (rows, idx.reshape(-1))), shape=(NYT_N, NYT_D))
        t0 = time.perf_counter()
        ref = np.sort(spla.svds(csr, k=NYT_SV,
                                return_singular_vectors=False))[::-1]
        scipy_s = time.perf_counter() - t0
        rel = np.abs(sig[:NYT_SV] - ref) / ref if sig.size == NYT_SV \
            else np.full(NYT_SV, np.inf)
        _line("config5", n=NYT_N, d=NYT_D, k_slots=NYT_K, nnz=NYT_N * NYT_K,
              singular_values=NYT_SV, reduced=None, generate_s=gen_s,
              ingest_s=ingest_s, column_copy_s=sort_s,
              matvec_rel_err=mv_err, matvec_bitwise_equal=mv_bitwise,
              lanczos_steps=steps, s1_launches=s1, s2_launches=s2,
              s1_ms=s1_ms, s2_ms=s2_ms, block_rows=columns.block_rows,
              blocks=columns.block_ptr.shape[0] - 1,
              pieces=columns.piece_col.shape[0], hot_slots=hot.shape[0],
              svd_s=svd_s, svd_kernels_s=kernel_s,
              svd_rest_s=svd_s - kernel_s,
              scipy_s=scipy_s, sigma_top5=sig[:5].tolist(),
              rel_err_by_index=rel.tolist(), max_rel_err=float(rel.max()))
        _check("config5", {
            "one matvec within 1e-4 of float64": mv_err <= 1e-4,
            "two matvecs bitwise equal": mv_bitwise,
            "S1 (Gram link) and S2 launched once per Lanczos step":
                s1 == steps and s2 == steps and steps > 0,
            "no other kernel launched": others == 0,
            "20 singular values within 5e-3 of scipy's": bool(
                rel.max() <= 5e-3),
        })
        return {"s1_launches": s1, "s2_launches": s2}
    finally:
        ctx.stop()


def phase_rowmatrix():
    """The rest of RowMatrix on phase 10's spectrum data: Lanczos
    (compute_svd(10, max_gram_dim=1024)) against the Gramian branch,
    multiply by a seeded 2,000 x 64 matrix against float64, and
    column_similarities against the float64 Gramian's cosines."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    from cycloneml_tpu_torch.linalg.matrices import Matrices
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_rowmatrix")
    try:
        ds, _ = _spectrum_dataset(ctx, GRAM_N, GRAM_D, seed=9)
        rm = RowMatrix(ds)
        kernels.reset_launch_counts()
        gram, gram_s = _timed(lambda: rm.compute_svd(10))
        steps = []
        base_fn = rm._gram_matvec_fn

        def counted():
            matvec, dt = base_fn()

            def mv(q):
                steps.append(1)
                return matvec(q)
            return mv, dt

        rm._gram_matvec_fn = counted
        lan, lan_s = _timed(lambda: rm.compute_svd(10, max_gram_dim=1024))
        s_rel = float(np.max(np.abs(lan.s.to_array() - gram.s.to_array())
                             / gram.s.to_array()))
        b = np.random.RandomState(64).randn(GRAM_D, MULTIPLY_COLS)
        prod, mult_s = _timed(lambda: rm.multiply(Matrices.from_array(b)))
        bt = torch.as_tensor(b, device=ds.x.device)
        err = scale = 0.0
        g64 = torch.zeros((GRAM_D, GRAM_D), dtype=torch.float64,
                          device=ds.x.device)
        for lo in range(0, GRAM_N, ROWS64):
            x64 = ds.x[lo:lo + ROWS64].double()
            t = x64 @ bt
            err = max(err, float((prod.dataset.x[lo:lo + ROWS64].double()
                                  - t).abs().max()))
            scale = max(scale, float(t.abs().max()))
            g64 += x64.T @ x64
        del x64, t
        sims, sim_s = _timed(rm.column_similarities)
        g64 = g64.cpu().numpy()
        norms = np.sqrt(np.diag(g64))
        cos64 = np.triu(g64 / norms[:, None] / norms[None, :], 1)
        sim_err = float(np.max(np.abs(sims.to_array() - cos64)))
        k4 = kernels.gramian.launches
        others = _other_launches(kernels, "gramian")
        _line("rowmatrix", n=GRAM_N, d=GRAM_D, gramian_svd_s=gram_s,
              lanczos_svd_s=lan_s, lanczos_steps=len(steps),
              sigma_rel_diff=s_rel, multiply_s=mult_s,
              multiply_max_abs_err=err, multiply_max_abs=scale,
              column_similarities_s=sim_s, similarity_max_abs_err=sim_err,
              k4_launches=k4)
        _check("rowmatrix", {
            "Lanczos singular values within 1e-4 of the Gramian branch's":
                s_rel <= 1e-4,
            "multiply within 1e-5 of max|X B| of float64":
                err <= 1e-5 * scale,
            "column similarities within 1e-5 of float64": sim_err <= 1e-5,
            "K4 launched once per Gramian (SVD, similarities)": k4 == 2,
            "no other kernel launched": others == 0,
        })
    finally:
        ctx.stop()


# -- the wide slice: K1, K2 and K1s past d = 2,048 ----------------------------

def _wide_x_forms(n, d, seed, forms):
    """X (n, d) drawn on the card in each of ``forms`` ("float32",
    "bfloat16", "e4m3"), one at a time, with its x_scale (float32, float64)
    for the e4m3 codes: the codes of the bf16 draw quantized on the card."""
    import torch
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    for form in forms:
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        if form == "float32":
            yield _randn(n, d, g), None, None
        elif form == "bfloat16":
            yield _randn(n, d, g, torch.bfloat16), None, None
        else:
            xb = _randn(n, d, g, torch.bfloat16)
            x8, scale, _ = quantize_fp8(xb)
            del xb
            yield (x8, torch.as_tensor(scale, dtype=torch.float32,
                                       device=DEVICE),
                   torch.as_tensor(scale, dtype=torch.float64, device=DEVICE))


def _wide_sweep_check(x, y, w, beta, off, link, ys, s32, s64):
    """One sweep of the instance of X's width (one-read wide up to 12,288
    columns, two-pass past it) against the plain version in float64:
    (errors, ok)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    inst = kernels.glm_sweep_instance(x.dtype, x.shape[1])
    before = dict(kernels.glm_sweep.launches_by_width)
    got = kernels.glm_sweep(x, y, w, beta, off, link=link, ys=ys,
                            x_scale=s32)
    again = kernels.glm_sweep(x, y, w, beta, off, link=link, ys=ys,
                              x_scale=s32)
    torch.cuda.synchronize()
    after = kernels.glm_sweep.launches_by_width
    tl, tg, tm, tw = kernels.glm_sweep_plain(
        x, y, w, beta.double(), off, acc_dtype=torch.float64, link=link,
        ys=ys, x_scale=s64)
    n = x.shape[0]
    e = {"rel_loss": abs(float(got[0]) - float(tl)) / abs(float(tl)),
         "grad_err_over_max": float((got[1].double() - tg).abs().max())
         / float(tg.abs().max()),
         "max_abs_grad_err": float((got[1].double() - tg).abs().max()),
         "msum_err_over_wsum": abs(float(got[2]) - float(tm)) / float(tw),
         "count": float(got[3]),
         "bitwise_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
         "width": inst, "launches": after[inst] - before[inst],
         "other_launches": sum(after.values()) - sum(before.values())
         - (after[inst] - before[inst])}
    ok = (e["rel_loss"] <= 1e-5 and e["grad_err_over_max"] <= 1e-4
          and e["msum_err_over_wsum"] <= 1e-4 and e["count"] == n
          and float(tw) == n and e["bitwise_equal"]
          and e["launches"] == 2 and e["other_launches"] == 0)
    return e, ok


def phase_wide_kernel():
    """The wide K1 and K2 against their plain versions in float64 at the
    probe's shape (bf16, e4m3), at WIDE_F32_N rows in f32 and at the
    ragged shapes in all three (the two-pass instance past 12,288
    columns); times at the full-width shapes and at 8,192 and 12,288
    columns, the two-pass instance's beside them except at 8,192. Returns
    {link: the kernels line's numbers (bf16 at WIDE_N), with every
    dtype's time at the main shapes}."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    lg, sq = kernels.LOGISTIC, kernels.SQUARED
    out = {lg: {"by_dtype": {}}, sq: {"by_dtype": {}}}
    cases = [(WIDE_N, WIDE_D, ("bfloat16", "e4m3")),
             (WIDE_F32_N, WIDE_D, ("float32",))] + [
        (n, d, ("float32", "bfloat16", "e4m3")) for n, d in WIDE_RAGGED]
    for n, d, forms in cases:
        g = torch.Generator(device=DEVICE).manual_seed(n + d)
        w = torch.ones(n, device=DEVICE)
        beta = torch.randn(d, generator=g, device=DEVICE) / d ** 0.5
        off = torch.tensor(0.25, device=DEVICE)
        ys = torch.tensor(0.7, device=DEVICE)
        ys_of = {lg: (torch.rand(n, generator=g, device=DEVICE) > 0.5)
                 .float(),
                 sq: torch.randn(n, generator=g, device=DEVICE) * 3 + 1}
        for x, s32, s64 in _wide_x_forms(n, d, 11 * n + d, forms):
            for link in (lg, sq):
                y = ys_of[link]
                e, ok = _wide_sweep_check(x, y, w, beta, off, link, ys, s32,
                                          s64)
                _line("wide_check", n=n, d=d, dtype=_dt(x), link=link,
                      x_scale=s32 is not None, ok=ok, **e)
                if not ok:
                    raise AssertionError(f"the wide {link} sweep disagrees "
                                         f"with its plain version at n={n} "
                                         f"d={d} {x.dtype}")
                main = n in (WIDE_N, WIDE_F32_N)
                if main or d in (8192, 12_288):
                    t = _wide_times(x, y, w, beta, off, link, ys, s32,
                                    two_pass=d != 8192)
                    if main:
                        out[link]["by_dtype"][_dt(x)] = t
                    if n == WIDE_N and x.dtype == torch.bfloat16:
                        out[link].update(t, max_abs_err=e["max_abs_grad_err"])
            del x
            torch.cuda.empty_cache()
    return out


def _wide_times(x, y, w, beta, off, link, ys, x_scale, two_pass=True):
    """The wide sweep's time (one read of X) beside the two-pass instance
    at the same width (where ``two_pass``, else None), its plain version
    (f32), the bound (one read of X, y and w), two cuBLAS gemvs in X's
    dtype (none for e4m3) and the wide plan."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n, d = x.shape
    k_ms = _time_ms(lambda: kernels.glm_sweep(
        x, y, w, beta, off, link=link, ys=ys, x_scale=x_scale), 20, 3)
    two_ms = None
    if two_pass:
        two_ms = _time_ms(lambda: kernels._sweep(
            x, y, w, beta, off, link, ys, x_scale, kernels.TWO_PASS), 20, 3)
    p_ms = _time_ms(lambda: kernels.glm_sweep_plain(
        x, y, w, beta, off, link=link, ys=ys, x_scale=x_scale), 3, 1)
    if link == kernels.LOGISTIC:
        yard = _gemv_yardstick(x, beta,
                               lambda m: w * (torch.sigmoid(m + off) - y))
    else:
        yard = _gemv_yardstick(x, beta, lambda m: w * (m + off - ys * y))
    n_bytes = n * d * x.element_size() + 2 * n * 4 + d * 4 + (d + 3) * 4
    bound, bound_by = _bound(n_bytes, 4.0 * n * d)
    plan = kernels.glm_sweep_plan(x.dtype, link, d)
    _line("wide_time", n=n, d=d, dtype=_dt(x), link=link, kernel_ms=k_ms,
          two_pass_ms=two_ms, plain_ms=p_ms, bound_ms=bound,
          bound_by=bound_by, share_of_bound=bound / k_ms,
          yardstick_two_gemv_ms=yard, achieved_gb_s=n_bytes / k_ms / 1e6,
          **plan)
    return {"ms": k_ms, "two_pass_ms": two_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by, "yardstick_ms": yard,
            "plan": plan, "n": n, "d": d}


def phase_wide_k1s():
    """The wide K1s against its plain version in float64 (phase 15's
    checks and sum(mult) to 1e-4 of sum(w); two launches bitwise equal,
    one launch per group counted under the instance of its width: the
    one-read cluster instance for bf16 and e4m3 up to 8,192 columns, the
    two-pass one for f32 and past 8,192) at K1S_WIDE in bf16, e4m3 and
    f32, centered; times at every shape up to 8,192 columns, the two-pass
    instance's beside them at K = 8. Returns the kernels line's numbers: bf16 at CIFAR-10's shape, K = 8,
    with the other times."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    out = {"times": []}
    for n, d, ks in K1S_WIDE:
        g = torch.Generator(device=DEVICE).manual_seed(3 * n + d)
        kmax = max(ks)
        truth = torch.randn(d, kmax, generator=g, device=DEVICE) / d ** 0.5
        coef = torch.randn(kmax, d + 1, generator=g, device=DEVICE) \
            / d ** 0.5
        inv_std = torch.rand(d, generator=g, device=DEVICE) + 0.5
        mu = torch.randn(d, generator=g, device=DEVICE) * 0.5
        w = torch.ones(n, device=DEVICE)
        y32 = None
        for x, s32, s64 in _wide_x_forms(n, d, 5 * n + d,
                                         ("bfloat16", "e4m3", "float32")):
            if y32 is None:  # labels from the first form's rows
                y32 = torch.empty((n, kmax), device=DEVICE)
                for lo in range(0, n, ROWS):
                    m = x[lo:lo + ROWS].float() @ truth
                    y32[lo:lo + ROWS] = (m + torch.randn(
                        m.shape, generator=g, device=DEVICE) > 0).float()
            ys = y32.to(_label_dtype(x))
            for k in ks:
                yk = ys[:, :k]
                group = kernels.glm_sweep_stacked_group(x.dtype, d)
                groups = -(-k // group)
                inst = kernels.glm_sweep_instance(x.dtype, d, stacked=True)
                before = dict(kernels.glm_sweep_stacked.launches_by_width)
                got = kernels.fused_binary_logistic_stacked_scaled(
                    x, yk, w, inv_std, mu, coef[:k], d, x_scale=s32)
                again = kernels.fused_binary_logistic_stacked_scaled(
                    x, yk, w, inv_std, mu, coef[:k], d, x_scale=s32)
                torch.cuda.synchronize()
                after = kernels.glm_sweep_stacked.launches_by_width
                t_loss, t_grad, t_w = _fold_truth_stacked(
                    x, yk, w, inv_std, mu, coef[:k], d, s64)
                rel_loss, rel_grad, err = _k1s_errors(got, t_loss, t_grad)
                msum = float((got["grad"][:, d].double() - t_grad[:, d])
                             .abs().max()) / float(t_w)
                bitwise = all(torch.equal(got[q], again[q])
                              for q in ("loss", "grad", "count"))
                launched = (after[inst] - before[inst] == 2 * groups
                            and sum(after.values()) - sum(before.values())
                            == 2 * groups)
                ok = (rel_loss <= 1e-5 and rel_grad <= 1e-4
                      and msum <= 1e-4 and bool((got["count"] == n).all())
                      and float(t_w) == n and bitwise and launched)
                _line("wide_k1s_check", n=n, d=d, k=k, dtype=_dt(x),
                      instance=kernels.INSTANCE[x.dtype], width=inst,
                      group=group,
                      x_scale=s32 is not None, rel_loss=rel_loss,
                      grad_err_over_max=rel_grad, max_abs_grad_err=err,
                      msum_err_over_wsum=msum, launches=2 * groups,
                      bitwise_equal=bitwise, ok=ok)
                if not ok:
                    raise AssertionError(f"the wide K1s disagrees with its "
                                         f"plain version at n={n} d={d} "
                                         f"k={k} {x.dtype}")
                if d > kernels.STACKED_WIDE_MAX_D:
                    continue
                t = _wide_k1s_times(x, yk, w, coef[:k], inv_std, s32,
                                    two_pass=k == 8)
                out["times"].append(t)
                if n == CIFAR_N and k == 8 and x.dtype == torch.bfloat16:
                    out.update(t, max_abs_err=err)
            del x, ys
            torch.cuda.empty_cache()
        del y32
    return out


def _wide_k1s_times(x, y, w, coef, inv_std, x_scale, two_pass=True):
    """The wide K1s's time (by CUDA events around the wrapper, and its
    kernels' device time by the profiler) beside the two-pass instance at
    the same width where ``two_pass`` (groups of 8 on the tensor cores;
    none for f32 X, whose wide instance it still is), its plain version
    (f32), the bound (X, the
    labels and w once; the tensor-core instance's 12 n d K operations at
    the bf16 rate, the FMA instance's 4 n d K at the f32 rate) and the
    yardstick X B^T plus M^T X in X's dtype (none for e4m3 codes)."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n, d = x.shape
    k = y.shape[1]
    b = coef[:, :d] * inv_std
    off = coef[:, d]
    k_ms = _time_ms(lambda: kernels.glm_sweep_stacked(
        x, y, w, b, off, x_scale=x_scale), 10, 2)
    dev_ms = _device_ms(lambda: kernels.glm_sweep_stacked(
        x, y, w, b, off, x_scale=x_scale), 10, "glm_")
    instance = kernels.INSTANCE[x.dtype]
    two_ms = None
    if two_pass and instance == kernels.TENSOR_CORE:
        two_ms = _time_ms(lambda: kernels._stacked(
            x, y, w, b, off, x_scale, kernels.TWO_PASS, 8), 10, 2)
    p_ms = _time_ms(lambda: kernels.glm_sweep_stacked_plain(
        x, y, w, b, off, x_scale=x_scale), 2, 1)
    yard = None
    if x.dtype != torch.float8_e4m3fn:
        bt = b.t().contiguous().to(x.dtype)
        mult = (w[:, None] * (torch.sigmoid((x @ bt).float() + off)
                              - y.float())).to(x.dtype)
        yard = _time_ms(lambda: (x @ bt, mult.t() @ x), 5, 1)
        del mult
    n_bytes = (n * d * x.element_size() + n * k * y.element_size() + n * 4
               + k * (d + 1) * 4 + (k * (d + 2) + 1) * 4)
    if instance == kernels.TENSOR_CORE:
        bound, bound_by = _bound(n_bytes, 12.0 * n * d * k, H100_BF16_FLOPS)
    else:
        bound, bound_by = _bound(n_bytes, 4.0 * n * d * k)
    width = kernels.glm_sweep_instance(x.dtype, d, stacked=True)
    parts = None
    if width == kernels.WIDE:  # the clusters resident at once on this card
        c = ctypes.c_int(0)
        kernels._library("glm_stacked").glm_stacked_num_parts(
            kernels._DTYPE_CODE[x.dtype], d,
            min(k, kernels.glm_sweep_stacked_group(x.dtype, d)), n,
            ctypes.byref(c))
        parts = c.value
    _line("wide_k1s_time", n=n, d=d, k=k, dtype=_dt(x), instance=instance,
          width=width, clusters=parts,
          kernel_ms=k_ms, device_ms=dev_ms, two_pass_ms=two_ms,
          plain_ms=p_ms, bound_ms=bound,
          bound_by=bound_by, share_of_bound=bound / k_ms,
          yardstick_xbt_mtx_ms=yard, achieved_gb_s=n_bytes / k_ms / 1e6)
    return {"ms": k_ms, "device_ms": dev_ms, "two_pass_ms": two_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "yardstick_ms": yard, "n": n, "d": d, "k": k, "dtype": _dt(x)}


def _wide_fit_phase(tag, generate, estimator, link):
    """One wide fit on data drawn on the card (bf16): through the kernel
    (usePallasKernels=auto, warm and steady; the main path: counts zeroed
    just before, read just after) and through the plain aggregator (false,
    warm and steady), with phase 4's checks. Returns the wide kernel's
    launches in the first fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ops import kernels

    torch.cuda.empty_cache()
    ctx = _context(f"chip_smoke_{tag}")
    try:
        ds, gen_s = _timed(lambda: generate(ctx))

        def fit(mode):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            return _timed(lambda: estimator().fit(ds))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        k_model, k_warm = fit("auto")
        wide = kernels.glm_sweep.launches_by_width[kernels.WIDE]
        narrow = kernels.glm_sweep.launches_by_width[kernels.NARROW]
        by_link = kernels.glm_sweep.launches_by_link[link]
        others = _other_launches(kernels, link)
        k_again, k_steady = fit("auto")
        p_model, p_warm = fit("false")
        _, p_steady = fit("false")
        peak = torch.cuda.max_memory_allocated()
        ks, ps = k_model.summary, p_model.summary
        kc, pc = k_model.coefficients.values, p_model.coefficients.values
        obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
            / abs(ps.objective_history[-1])
        _line(tag, n=WIDE_N, d=WIDE_D, data_dtype=_dt(ds.x),
              x_bytes=ds.x.numel() * ds.x.element_size(), generate_s=gen_s,
              kernel={"iterations": ks.total_iterations,
                      "evals": ks.total_evals, "wide_launches": wide,
                      "warm_s": k_warm, "steady_s": k_steady,
                      "final_objective": ks.objective_history[-1],
                      "zero_coefficients": int(np.sum(kc == 0))},
              plain={"iterations": ps.total_iterations,
                     "evals": ps.total_evals, "warm_s": p_warm,
                     "steady_s": p_steady,
                     "final_objective": ps.objective_history[-1]},
              max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
              intercepts=[k_model.intercept, p_model.intercept],
              objective_rel_diff=obj_rel, max_memory_allocated=peak)
        _check(tag, {
            "the wide instance launched once per evaluation, the narrow "
            "never": wide == ks.total_evals == by_link and narrow == 0,
            "no other kernel launched": others == 0,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "coefficients agree (rtol 5e-3, atol 5e-4)": bool(np.allclose(
                kc, pc, rtol=5e-3, atol=5e-4)) and abs(
                k_model.intercept - p_model.intercept) <=
                5e-4 + 5e-3 * abs(p_model.intercept),
            "finite model": bool(np.all(np.isfinite(kc))),
            "repeat fit reproduces the model": bool(np.array_equal(
                k_again.coefficients.values, kc)),
        })
        return wide
    finally:
        ctx.stop()


def phase_wide_fit():
    """LogisticRegression(maxIter=25, regParam=0.01, tol=0) at the probe's
    shape through K1's wide instance (:func:`_wide_fit_phase`)."""
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels
    return _wide_fit_phase(
        "wide_fit", lambda ctx: generate_classification(ctx, WIDE_N, WIDE_D,
                                                        seed=0),
        lambda: LogisticRegression(maxIter=25, regParam=0.01, tol=0.0),
        kernels.LOGISTIC)


def phase_wide_linreg():
    """LinearRegression at configuration 2's settings (OWL-QN) at the
    probe's shape through K2's wide instance (:func:`_wide_fit_phase`)."""
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.ops import kernels
    return _wide_fit_phase(
        "wide_linreg_fit", lambda ctx: generate_regression(
            ctx, WIDE_N, WIDE_D, seed=11, noise=0.1),
        lambda: LinearRegression(regParam=0.001, elasticNetParam=0.5,
                                 maxIter=100, tol=1e-7),
        kernels.SQUARED)


def phase_cifar_ovr():
    """OneVsRest at CIFAR-10's size (50,000 x 3,072, 10 classes, bf16)
    through the wide K1s (one group of 16 holds the 10 classes: one launch
    per stacked evaluation), through the plain stacked aggregator and
    serially (10 fits through the wide K1), with phase 16's checks. Returns
    K1s's launches in the stacked fit and the stacked fit's models."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_multiclass
    from cycloneml_tpu_torch.ml.classification import (LogisticRegression,
                                                       OneVsRest)
    from cycloneml_tpu_torch.ops import kernels

    torch.cuda.empty_cache()
    ctx = _context("chip_smoke_cifar")
    try:
        ds, gen_s = _timed(lambda: generate_multiclass(
            ctx, CIFAR_N, CIFAR_D, CIFAR_K, seed=7,
            center_scale=CIFAR_CENTER_SCALE))
        labels = torch.as_tensor(ds.y_host()[:ds.n_rows],
                                 device=ds.x.device).long()

        def fit(mode, par):
            ctx.conf.set("cyclone.ml.usePallasKernels", mode)
            clf = LogisticRegression(maxIter=25, regParam=0.01, tol=0.0)
            return _timed(lambda: OneVsRest(classifier=clf,
                                            parallelism=par).fit(ds))

        kernels.reset_launch_counts()
        k_model, k_warm = fit("auto", CIFAR_K)
        k1s = kernels.glm_sweep_stacked.launches
        k1s_wide = kernels.glm_sweep_stacked.launches_by_width[kernels.WIDE]
        k1s_tc = kernels.glm_sweep_stacked.launches_by_instance[
            kernels.TENSOR_CORE]
        k1 = kernels.glm_sweep.launches
        others = _other_launches(kernels, "glm_stacked")
        k_again, k_steady = fit("auto", CIFAR_K)
        p_model, p_s = fit("false", CIFAR_K)
        kernels.reset_launch_counts()
        s_model, s_s = fit("auto", 1)
        serial_k1 = kernels.glm_sweep.launches_by_width[kernels.WIDE]
        serial_narrow = kernels.glm_sweep.launches_by_width[kernels.NARROW]
        serial_k1s = kernels.glm_sweep_stacked.launches
        pred_k = _ovr_margins(ds, k_model.models)
        agree_s = float((pred_k == _ovr_margins(ds, s_model.models))
                        .double().mean())
        agree_p = float((pred_k == _ovr_margins(ds, p_model.models))
                        .double().mean())
        acc = float((pred_k == labels).double().mean())
        coef_p, obj_p = _same_models(k_model, p_model)
        coef_s, obj_s = _same_models(k_model, s_model)
        stacked_evals = k_model.models[0].summary.stacked_evals
        group = kernels.glm_sweep_stacked_group(ds.x.dtype, CIFAR_D)
        groups = -(-CIFAR_K // group)
        serial_evals = sum(m.summary.total_evals for m in s_model.models)
        _line("cifar_ovr_fit", n=CIFAR_N, d=CIFAR_D, classes=CIFAR_K,
              data_dtype=_dt(ds.x), generate_s=gen_s, group=group,
              stacked_k1s={**_ovr_summary(k_model), "k1s_launches": k1s,
                           "k1_launches": k1, "warm_s": k_warm,
                           "steady_s": k_steady},
              stacked_plain={**_ovr_summary(p_model), "fit_s": p_s},
              serial_k1={**_ovr_summary(s_model), "k1_launches": serial_k1,
                         "k1s_launches": serial_k1s, "fit_s": s_s},
              objective_rel_diff={"plain": obj_p, "serial": obj_s},
              prediction_agreement={"plain": agree_p, "serial": agree_s},
              train_accuracy=acc)
        _check("cifar ovr fit", {
            "the wide K1s launched once per stacked evaluation (one group "
            "of 16 holds the 10 classes), all on the tensor cores":
                k1s == stacked_evals * groups == k1s_wide == k1s_tc
                and groups == 1,
            "K1 launched 0 times in the stacked fit": k1 == 0,
            "no other kernel launched": others == 0,
            "the serial fits launch the wide K1 once per evaluation, K1s "
            "never": serial_k1 == serial_evals and serial_narrow == 0
                and serial_k1s == 0,
            "coefficients agree with the plain stacked fit (rtol 5e-3, "
            "atol 5e-4)": coef_p,
            "coefficients agree with the serial fits": coef_s,
            "final objectives agree to 1e-4": max(obj_p, obj_s) <= 1e-4,
            "predictions agree on >= 99.9% of rows":
                min(agree_p, agree_s) >= 0.999,
            "repeat fit reproduces the models": all(
                np.array_equal(a.coefficients.values, b.coefficients.values)
                for a, b in zip(k_model.models, k_again.models)),
            "finite models": all(np.all(np.isfinite(m.coefficients.values))
                                 for m in k_model.models),
        })
        return k1s, k_model.models
    finally:
        ctx.stop()


def _history_parts(a, b, rtol=1e-6) -> int:
    """The first iteration where two objective histories part by more than
    ``rtol`` relative (-1 when they never do)."""
    import numpy as np
    ha, hb = (np.asarray(m.summary.objective_history) for m in (a, b))
    m = min(len(ha), len(hb))
    apart = np.abs(ha[:m] - hb[:m]) > rtol * np.abs(hb[:m])
    return int(np.argmax(apart)) if apart.any() else -1


def phase_criteo_seeds():
    """The float32 tier's sparse intercept at one more draw: phase 25's
    float32 kernel fit, float32 plain fit and float64 plain fit on
    Criteo-class rows at seeds CRITEO_SEEDS, cut to CRITEO_SEED_N rows;
    the intercept's and coefficients' distances to the float64 plain fit,
    the iteration where the objectives part, the objectives held to 1e-4
    of each other."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like

    for seed in CRITEO_SEEDS:
        torch.cuda.empty_cache()
        ctx = _context("chip_smoke_criteo_seed")
        ds = None
        try:
            ds, gen_s = _timed(lambda: generate_criteo_like(
                ctx, CRITEO_SEED_N, seed=seed, hash_dim=CRITEO_D))
            k32, k_s = _sparse_fit(ctx, ds, "auto")
            p32, p_s = _sparse_fit(ctx, ds, "false")
            ctx.conf.set("cyclone.compute.dtype", "float64")
            p64, p64_s = _sparse_fit(ctx, ds, "false")
            obj = {name: abs(m.summary.objective_history[-1]
                             - p64.summary.objective_history[-1])
                   / abs(p64.summary.objective_history[-1])
                   for name, m in (("kernel_f32", k32), ("plain_f32", p32))}
            _line("criteo_intercept", seed=seed, n=CRITEO_SEED_N,
                  generate_s=gen_s, fit_s=[k_s, p_s, p64_s],
                  intercepts={"kernel_f32": k32.intercept,
                              "plain_f32": p32.intercept,
                              "plain_f64": p64.intercept},
                  intercept_diff_to_f64={
                      "kernel_f32": abs(k32.intercept - p64.intercept),
                      "plain_f32": abs(p32.intercept - p64.intercept)},
                  max_abs_coef_diff_to_f64={
                      name: float(np.max(np.abs(m.coefficients.values
                                                - p64.coefficients.values)))
                      for name, m in (("kernel_f32", k32),
                                      ("plain_f32", p32))},
                  objectives_part_at_iteration={
                      "kernel_f32": _history_parts(k32, p64),
                      "plain_f32": _history_parts(p32, p64)},
                  iterations=[m.summary.total_iterations
                              for m in (k32, p32, p64)],
                  objective_rel_diff_to_f64=obj)
            _check("criteo intercept", {
                f"seed {seed}: final objectives agree to 1e-4":
                    max(obj.values()) <= 1e-4,
                f"seed {seed}: finite models": all(
                    np.all(np.isfinite(m.coefficients.values))
                    for m in (k32, p32, p64)),
            })
        finally:
            ctx.stop()
            del ds


# -- ALS at BASELINE configuration 4 -------------------------------------------

def _als_data():
    """Configuration 4's ratings as benchmarks/als_scale.py makes them (a
    copy of its ``make_data``: numpy ``default_rng(7)``, rank-64 users and
    items, rating = u.v + 0.3 noise, at MovieLens-25M's shape) and its
    held-out split (``default_rng(3)``: ALS_HELD ratings held out, the
    first ALS_HELD of the rest the train probe)."""
    import numpy as np
    import torch
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    users = rng.integers(0, ALS_USERS, ALS_NNZ).astype(np.int64)
    items = rng.integers(0, ALS_ITEMS, ALS_NNZ).astype(np.int64)
    scale = 1.0 / np.sqrt(ALS_RANK)
    u = rng.normal(0, scale, (ALS_USERS, ALS_RANK)).astype(np.float32)
    v = rng.normal(0, scale, (ALS_ITEMS, ALS_RANK)).astype(np.float32)
    ratings = np.empty(ALS_NNZ, dtype=np.float64)
    chunk = 2_000_000
    for lo in range(0, ALS_NNZ, chunk):
        hi = min(lo + chunk, ALS_NNZ)
        ratings[lo:hi] = (np.einsum("ij,ij->i", u[users[lo:hi]],
                                    v[items[lo:hi]])
                          + ALS_NOISE * rng.normal(0, 1, hi - lo))
    perm = np.random.default_rng(3).permutation(ALS_NNZ)
    held, train = perm[:ALS_HELD], perm[ALS_HELD:]
    data = {"users": users, "items": items, "ratings": ratings,
            "train": train, "held": held, "probe": train[:ALS_HELD]}
    _line("als_data", users=ALS_USERS, items=ALS_ITEMS, ratings=ALS_NNZ,
          train=len(train), held_out=len(held), rank=ALS_RANK,
          seconds=time.perf_counter() - t0)
    return data


def _als_a_err(a, truth, rows=1 << 14):
    """(max|dA_ij|, max |dA_ij| / sqrt(A_ii A_jj)) of ``a`` against the
    float64 ``truth``, ``rows`` destinations at a time."""
    import torch
    abs_err = rel_err = 0.0
    for lo in range(0, a.shape[0], rows):
        t = truth[lo:lo + rows]
        d = (a[lo:lo + rows].double() - t).abs()
        diag = torch.diagonal(t, dim1=1, dim2=2).abs()
        scale = torch.sqrt(diag[:, :, None] * diag[:, None, :])
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / scale.clamp(min=1e-300)).max()))
    return abs_err, rel_err


def _als_b_err(b, truth, src64, o64, implicit, rows=1 << 22):
    """max |db| over the row's sum |bw| |v| (bw the b weight of each
    rating, alpha = 1), summed ``rows`` ratings at a time."""
    import torch
    scale = torch.zeros_like(truth)
    for lo in range(0, o64.src.shape[0], rows):
        rc = o64.rating[lo:lo + rows].abs()
        w = 1.0 + rc if implicit else rc
        scale.index_add_(0, o64.dst[lo:lo + rows],
                         w[:, None] * src64[o64.src[lo:lo + rows]].abs())
    return float(((b.double() - truth).abs()
                  / scale.clamp(min=1e-300)).max())


def _als_bmm_yardstick(src, order):
    """The ms of torch.bmm over every destination's zero-padded gathered
    source rows (n_dst, most ratings, r): V^T V, explicit A without the
    solve's terms, in float32 with TF32 off (the gather not counted), and
    the padded block's shape."""
    import torch
    n_dst, r = order.n_dst, src.shape[1]
    counts = order.counts
    width = int(counts.max())
    pos = torch.arange(order.src.shape[0], device=src.device) \
        - order.offsets[order.dst.long()]
    v = torch.zeros((n_dst, width, r), dtype=src.dtype, device=src.device)
    v[order.dst.long(), pos] = src[order.src.long()]
    vt = v.transpose(1, 2)
    ms = _time_ms(lambda: torch.bmm(vt, v), 3, 1)
    del v, vt, pos
    torch.cuda.empty_cache()
    return ms, [n_dst, width, r]


def _als_spills(ptxas):
    """Spill bytes (stores plus loads) and registers of every ALS kernel
    instance in ptxas's lines."""
    out = {}
    for f, lines in ptxas.items():
        if f.startswith("als_"):
            out[f] = {"spill_bytes": sum(int(v) for ln in lines for v in
                                         re.findall(r"(\d+) bytes spill", ln)),
                      "registers": [int(v) for ln in lines for v in
                                    re.findall(r"Used (\d+) registers", ln)]}
    return out


def _device_ms_by_events(fn, reps: int) -> float:
    """The device time of one call of ``fn``: CUDA events recorded around
    each of ``reps`` calls queued back to back after a warm call, so that
    each call's kernels start as the one before ends (the host queues a
    call in far less than its kernels take) and no host time falls
    between an event pair; the least of the reps."""
    import torch
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return min(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


ALS_INSTANCES = 6  # als_tc_kernel (two), als_piece_kernel and
#                    als_reduce_kernel (float32, float64)


def phase_als_normal(data, ptxas):
    """The ALS normal equations at configuration 4's full shape, rank 64,
    both half-steps (users <- items, items <- users) on the training
    ratings' orders, random factors (|normal| / sqrt(64), as the fit's
    first draws), regParam ALS_REG and, implicit (alpha = 1), Y^T Y:
    the float32 kernel (the tensor cores) and the earlier float32 design
    (``instance=FMA``) against the float64 plain twin on the card
    (|dA_ij| <= 1e-5 sqrt(A_ii A_jj), |db| <= 1e-5 of the row's sum
    |bw| |v|), the float64 kernel against it at 1e-12, counts equal to the
    ids' bincount, A == A^T bitwise, two launches bitwise equal; the two
    float32 designs timed in turns (tensor cores, FMA, FMA, tensor cores)
    and the device time by CUDA events around each launch (and
    torch.profiler's, as a cross-check), beside both bounds (the tensor
    cores': bytes, or the 3xTF32 products of the upper entries at the TF32
    rate; the FMA design's: its float32 operations at the FMA rate), the
    float32 plain twin and the yardstick (torch.bmm of the padded gathered
    rows); ptxas's registers and spills. Returns the users' explicit
    numbers for the kernels line, with the items' beside them."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.recommendation import als
    from cycloneml_tpu_torch.ops import kernels
    dev = torch.device(DEVICE)
    tr = data["train"]
    uid, users = als.compact_ids(data["users"][tr])
    iid, items = als.compact_ids(data["items"][tr])
    n_u, n_i, r = len(uid), len(iid), ALS_RANK
    (ord_u, ord_i), orders_s = _timed(lambda: als.build_orders(
        users, items, data["ratings"][tr], n_u, n_i, torch.float32, dev))
    g = torch.Generator(device=dev).manual_seed(5)
    fac = {side: torch.randn(n, r, generator=g, device=dev).abs() / r ** 0.5
           for side, n in (("users", n_u), ("items", n_i))}
    truth_counts = {"users": np.bincount(users, minlength=n_u),
                    "items": np.bincount(items, minlength=n_i)}
    spills = _als_spills(ptxas)
    out = {}
    checks = {f"0 spill bytes in every als_normal kernel ({ALS_INSTANCES})":
              len(spills) == ALS_INSTANCES
              and not any(v["spill_bytes"] for v in spills.values())}
    for side, src_side, order in (("users", "items", ord_u),
                                  ("items", "users", ord_i)):
        src = fac[src_side]
        src64 = src.double()
        o64 = order._replace(rating=order.rating.double())
        nnz = order.src.shape[0]
        for implicit in (False, True):
            mode = "implicit" if implicit else "explicit"
            yty = torch.mm(src.T, src) if implicit else None
            yty64 = None if yty is None else yty.double()

            def call(s=src, o=order, y=yty, inst=None):
                return kernels.als_normal(s, o, implicit, 1.0, ALS_REG, y,
                                          instance=inst)

            def fma(s=src, o=order, y=yty):
                return call(s, o, y, kernels.FMA)

            before = kernels.als_normal.launches
            by_inst = dict(kernels.als_normal.launches_by_instance)
            a, b, n = call()
            a2, b2, _ = call()
            torch.cuda.synchronize()
            launched = kernels.als_normal.launches - before
            tc_launched = (kernels.als_normal.launches_by_instance[
                kernels.TENSOR_CORE] - by_inst[kernels.TENSOR_CORE])
            bitwise = torch.equal(a, a2) and torch.equal(b, b2)
            symmetric = torch.equal(a, a.transpose(1, 2))
            del a2, b2
            t_a, t_b, t_n = kernels.als_normal_plain(src64, o64, implicit,
                                                     1.0, ALS_REG, yty64)
            a_abs, a_rel = _als_a_err(a, t_a)
            b_rel = _als_b_err(b, t_b, src64, o64, implicit)
            counts_exact = bool(np.array_equal(
                n.cpu().numpy(), truth_counts[side].astype(np.float32)))
            del a, b
            a_f, b_f, _ = fma()
            fma_a_rel = _als_a_err(a_f, t_a)[1]
            fma_b_rel = _als_b_err(b_f, t_b, src64, o64, implicit)
            del a_f, b_f
            a64, b64, _ = kernels.als_normal(src64, o64, implicit, 1.0,
                                             ALS_REG, yty64)
            a64_abs, a64_rel = _als_a_err(a64, t_a)
            b64_rel = _als_b_err(b64, t_b, src64, o64, implicit)
            sym64 = torch.equal(a64, a64.transpose(1, 2))
            del a64, b64, t_a, t_b
            torch.cuda.empty_cache()
            # in turns: tensor cores, FMA, FMA, tensor cores
            turns = [_time_ms(fn, 5, 1) for fn in (call, fma, fma, call)]
            k_ms, fma_ms = min(turns[0], turns[3]), min(turns[1], turns[2])
            # the second stage launches only for destinations of two
            # pieces: none at this shape
            dev_ms = {"als_tc_kernel": _device_ms_by_events(call, 5),
                      "als_reduce_kernel": None if order.n_slots == 0
                      else "launched (timed with the first stage)"}
            profiler_ms = _device_ms(call, 3, "als_tc_kernel")
            n_bytes = (order.n_dst * r * (r + 1) * 4 + nnz * 8
                       + src.shape[0] * r * 4 + (order.n_dst + 1) * 16
                       + order.piece_dst.shape[0] * 8)
            # the tensor cores: the upper entries' products, three each
            tc_ops = float(nnz) * r * (r + 1) / 2 * 2 * 3
            bound, bound_by = _bound(n_bytes, tc_ops, H100_TF32_FLOPS)
            # the FMA design: its float32 operations on the FMA pipes
            fma_ops = float(nnz) * (r * (r + 1) + 2 * r
                                    + (r if implicit else 0))
            fma_bound, fma_bound_by = _bound(n_bytes, fma_ops)
            nums = {"side": side, "mode": mode, "n_dst": order.n_dst,
                    "n_src": src.shape[0], "ratings": nnz,
                    "pieces": order.piece_dst.shape[0],
                    "multi_piece_destinations": order.multi.shape[0],
                    "max_ratings": int(order.counts.max()),
                    "max_abs_err": a_abs, "a_rel_err": a_rel,
                    "b_rel_err": b_rel, "fma_a_rel_err": fma_a_rel,
                    "fma_b_rel_err": fma_b_rel, "f64_a_rel_err": a64_rel,
                    "f64_b_rel_err": b64_rel, "ms": k_ms, "fma_ms": fma_ms,
                    "turns_ms": turns, "device_ms": dev_ms,
                    "device_ms_by": "CUDA events around each launch",
                    "profiler_device_ms": profiler_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "share": bound / k_ms, "bytes": n_bytes,
                    "tc_operations": tc_ops,
                    "f32_fma_bound_ms": fma_bound,
                    "f32_fma_bound_by": fma_bound_by,
                    "fma_operations": fma_ops,
                    "fma_share_of_its_bound": fma_bound / fma_ms,
                    "launches_counted": launched,
                    "tensor_core_launches": tc_launched}
            if not implicit:  # the main path's: the plain twin, the bmm
                nums["plain_ms"] = _time_ms(lambda: kernels.als_normal_plain(
                    src, order, False, 1.0, ALS_REG), 1, 1)
                nums["yardstick_ms"], nums["yardstick_shape"] = \
                    _als_bmm_yardstick(src, order)
            _line("als_normal", orders_s=orders_s, **nums)
            tag = f"{side} {mode}"
            checks.update({
                f"{tag}: |dA_ij| <= 1e-5 sqrt(A_ii A_jj)": a_rel <= 1e-5,
                f"{tag}: |db| <= 1e-5 of sum |bw| |v|": b_rel <= 1e-5,
                f"{tag}: the FMA design within 1e-5": max(fma_a_rel,
                                                          fma_b_rel) <= 1e-5,
                f"{tag}: float64 kernel within 1e-12": max(a64_rel, b64_rel)
                <= 1e-12,
                f"{tag}: counts exact": counts_exact,
                f"{tag}: A == A^T bitwise (float32, float64)":
                    symmetric and sym64,
                f"{tag}: two launches bitwise equal": bitwise,
                f"{tag}: one launch a call, on the tensor cores":
                    launched == 2 and tc_launched == 2,
            })
            out[(side, mode)] = nums
    _line("als_ptxas", **spills)
    _check("als normal", checks)
    main = dict(out[("users", "explicit")])
    main["items"] = {k: out[("items", "explicit")][k]
                     for k in ("ms", "fma_ms", "device_ms", "bound_ms",
                               "bound_by", "share", "f32_fma_bound_ms",
                               "plain_ms", "yardstick_ms", "max_abs_err")}
    main["implicit_ms"] = {s: {"ms": out[(s, "implicit")]["ms"],
                               "fma_ms": out[(s, "implicit")]["fma_ms"]}
                           for s in ("users", "items")}
    main["ptxas"] = spills
    return main


def _als_frames(ctx, data):
    """The training frame and the two probes (held out, train) of
    als_scale.py, as the port's frames."""
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    tr, held, probe = data["train"], data["held"], data["probe"]
    frame = MLFrame(ctx, {"user": data["users"][tr],
                          "item": data["items"][tr],
                          "rating": data["ratings"][tr]})
    probes = {name: (MLFrame(ctx, {"user": data["users"][idx],
                                   "item": data["items"][idx]}),
                     data["ratings"][idx])
              for name, idx in (("train", probe), ("heldout", held))}
    return frame, probes


def _als_rmse(model, probe):
    """RMSE on a probe; cold rows (none are expected) predict 0, as
    als_scale.py scores them. Returns (rmse, cold rows)."""
    import numpy as np
    frame, y = probe
    pred = np.asarray(model.transform(frame)["prediction"], dtype=np.float64)
    cold = int(np.isnan(pred).sum())
    pred = np.nan_to_num(pred, nan=0.0)
    return float(np.sqrt(np.mean((pred - y) ** 2))), cold


def _split_als_fit(frame, **kw):
    """One ``ALS(**kw).fit(frame)`` with its time taken apart by wrapping
    the fit's own calls (each synchronizes the card on both sides):
    ``compact_s`` (host np.unique of both id columns), ``orders_s`` (the
    ids and ratings to the card, both orders), ``normal_s`` (every
    half-step's normal equations), ``gram_s`` (Y^T Y, implicit),
    ``solve_s`` (the batched solves, or projected Newton), ``rest_s`` (the
    frame's columns, the initial draws, the readback, the model). Returns
    ``(model, seconds, split)``."""
    import torch
    from cycloneml_tpu_torch.ml.recommendation import ALS, als
    split = {"compact_s": 0.0, "orders_s": 0.0, "normal_s": 0.0,
             "gram_s": 0.0, "solve_s": 0.0}
    saved = {}
    for name, key in (("compact_ids", "compact_s"),
                      ("build_orders", "orders_s"),
                      ("normal_equations", "normal_s"), ("gram", "gram_s"),
                      ("solve", "solve_s")):
        fn = saved[name] = getattr(als, name)

        def timed(*args, _fn=fn, _key=key, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            split[_key] += time.perf_counter() - t
            return res

        setattr(als, name, timed)
    try:
        model, secs = _timed(lambda: ALS(**kw).fit(frame))
    finally:
        for name, fn in saved.items():
            setattr(als, name, fn)
    split["rest_s"] = secs - sum(split.values())
    return model, secs, split


def _als_same(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(a.user_factors, b.user_factors)
                and np.array_equal(a.item_factors, b.item_factors))


def _als_kernel_vs_plain(ctx, frame, kw):
    """The kernel fit and the plain fit (usePallasKernels=false) at
    ALS_CHECK_ITERS: the norm-relative gap of each factor matrix, both
    fits' seconds, and the plain fit's kernel launches (0 expected)."""
    import numpy as np
    from cycloneml_tpu_torch.ml.recommendation import ALS
    from cycloneml_tpu_torch.ops import kernels
    short = dict(kw, maxIter=ALS_CHECK_ITERS)
    k, k_s = _timed(lambda: ALS(**short).fit(frame))
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    before = kernels.als_normal.launches
    try:
        p, p_s = _timed(lambda: ALS(**short).fit(frame))
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    gap = {side: float(np.linalg.norm(getattr(k, side) - getattr(p, side))
                       / np.linalg.norm(getattr(p, side)))
           for side in ("user_factors", "item_factors")}
    return gap, [k_s, p_s], kernels.als_normal.launches - before


def phase_als_fit(data):
    """Explicit ALS as benchmarks/als_scale.py runs it: ``ALS(rank=64,
    regParam=0.02, seed=2, maxIter=12).fit`` on the training ratings,
    through the kernel: the fit's time split (``_split_als_fit``), the
    normal equations launched 2 x maxIter times and nothing else, a second
    fit bitwise equal, the train and held-out RMSE on the two 1M probes
    (held-out within ALS_HELDOUT_RANGE, printed beside the reference's),
    peak memory, and the kernel fit against the plain fit at
    ALS_CHECK_ITERS (1e-4, norm-relative, in both factor matrices).
    Returns the fit's launches."""
    import torch
    from cycloneml_tpu_torch.ml.recommendation import ALS
    from cycloneml_tpu_torch.ops import kernels
    ctx = _context("chip_smoke_als")
    try:
        frame, probes = _als_frames(ctx, data)
        kw = dict(rank=ALS_RANK, regParam=ALS_REG, seed=ALS_SEED,
                  maxIter=ALS_ITERS)
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        model, fit_s, split = _split_als_fit(frame, **kw)
        launches = kernels.als_normal.launches
        other = _other_launches(kernels, "als_normal")
        peak = torch.cuda.max_memory_allocated()
        again, again_s = _timed(lambda: ALS(**kw).fit(frame))
        rmse = {name: _als_rmse(model, p) for name, p in probes.items()}
        gap, check_s, plain_launches = _als_kernel_vs_plain(ctx, frame, kw)
        _line("als_fit", iterations=ALS_ITERS, fit_s=fit_s, again_s=again_s,
              split=split, per_iteration_device_s=(split["normal_s"]
                                                   + split["solve_s"])
              / ALS_ITERS, launches=launches, other_launches=other,
              peak_mem_gib=peak / 2**30, rmse_train=rmse["train"][0],
              rmse_heldout=rmse["heldout"][0],
              cold_rows={k: v[1] for k, v in rmse.items()},
              reference_rmse_heldout=ALS_REFERENCE_HELDOUT_RMSE,
              kernel_vs_plain_gap=gap, check_fit_s=check_s,
              check_iterations=ALS_CHECK_ITERS)
        lo, hi = ALS_HELDOUT_RANGE
        held_frame, held_ratings = probes["heldout"]
        _keep("ALS", model, user=held_frame["user"], item=held_frame["item"],
              rating=held_ratings)
        _MAIN_MODEL["als"] = model
        _check("als fit", {
            "the normal equations launched 2 x maxIter times":
                launches == 2 * ALS_ITERS,
            "no other kernel launched": other == 0,
            "a second fit bitwise equal": _als_same(model, again),
            f"held-out RMSE in [{lo}, {hi}]": lo <= rmse["heldout"][0] <= hi,
            "the plain fit launches no kernel": plain_launches == 0,
            "kernel fit within 1e-4 of the plain fit (norm-relative)":
                max(gap.values()) <= 1e-4,
        })
        return launches
    finally:
        ctx.stop()


def phase_als_implicit(data):
    """Implicit ALS (alpha = 1) on the same training ratings at
    ALS_IMPLICIT_ITERS: the time split and per iteration, 2 x maxIter
    launches, a second fit bitwise equal, the kernel fit against the plain
    fit at ALS_CHECK_ITERS; then ``nonnegative=True`` at ALS_CHECK_ITERS:
    every factor >= 0, the time of each half-step's projected Newton solve
    (one LU factorization, 41 batched solves)."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.recommendation import ALS
    from cycloneml_tpu_torch.ops import kernels
    ctx = _context("chip_smoke_als_implicit")
    try:
        frame, probes = _als_frames(ctx, data)
        kw = dict(rank=ALS_RANK, regParam=ALS_REG, seed=ALS_SEED,
                  maxIter=ALS_IMPLICIT_ITERS, implicitPrefs=True, alpha=1.0)
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        model, fit_s, split = _split_als_fit(frame, **kw)
        launches = kernels.als_normal.launches
        other = _other_launches(kernels, "als_normal")
        again, again_s = _timed(lambda: ALS(**kw).fit(frame))
        gap, check_s, plain_launches = _als_kernel_vs_plain(ctx, frame, kw)
        nn_kw = dict(kw, nonnegative=True, maxIter=ALS_CHECK_ITERS)
        kernels.reset_launch_counts()
        nn, nn_s, nn_split = _split_als_fit(frame, **nn_kw)
        nn_launches = kernels.als_normal.launches
        nn_min = min(float(nn.user_factors.min()),
                     float(nn.item_factors.min()))
        _line("als_implicit", iterations=ALS_IMPLICIT_ITERS, fit_s=fit_s,
              again_s=again_s, split=split,
              per_iteration_s=(split["normal_s"] + split["gram_s"]
                               + split["solve_s"]) / ALS_IMPLICIT_ITERS,
              launches=launches, other_launches=other,
              kernel_vs_plain_gap=gap, check_fit_s=check_s,
              rmse_heldout=_als_rmse(model, probes["heldout"])[0],
              nonnegative_fit_s=nn_s, nonnegative_split=nn_split,
              nonnegative_solve_s_per_half_step=nn_split["solve_s"]
              / (2 * ALS_CHECK_ITERS),
              nonnegative_min_factor=nn_min,
              nonnegative_zero_share=float(np.mean(np.concatenate(
                  [nn.user_factors.ravel(), nn.item_factors.ravel()]) == 0)))
        _check("als implicit", {
            "the normal equations launched 2 x maxIter times":
                launches == 2 * ALS_IMPLICIT_ITERS,
            "no other kernel launched": other == 0,
            "a second fit bitwise equal": _als_same(model, again),
            "finite factors": bool(np.isfinite(model.user_factors).all()
                                   and np.isfinite(model.item_factors).all()),
            "the plain fit launches no kernel": plain_launches == 0,
            "kernel fit within 1e-4 of the plain fit (norm-relative)":
                max(gap.values()) <= 1e-4,
            "nonnegative: every factor >= 0": nn_min >= 0.0,
            "nonnegative: 2 x maxIter launches":
                nn_launches == 2 * ALS_CHECK_ITERS,
        })
        return launches
    finally:
        ctx.stop()


# -- data in and models out: the readers and persistence ----------------------

def _probe_rows(x):
    """The first PROBE_ROWS rows of X (a tensor or an array) as host
    numpy, float32 at least (bf16 values are exact in float32)."""
    import numpy as np
    import torch
    if torch.is_tensor(x):
        x = x[:PROBE_ROWS]
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x[:PROBE_ROWS])


def _keep(name, model, x=None, **cols):
    """Keep a fitted model for the persistence phase, with host columns
    of its data to transform (``x``: its features' first rows)."""
    if x is not None:
        cols["features"] = _probe_rows(x)
    _FITTED[name] = (model, cols)


class _RssPeak:
    """The process's peak resident set size while the block runs, sampled
    every 10 ms from /proc/self/status (read only)."""

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def __enter__(self):
        import threading
        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _token_table(strings):
    """The byte strings of ``strings`` as a zero-padded (T, width) uint8
    table and their lengths, on the card."""
    import numpy as np
    import torch
    enc = [s.encode() for s in strings]
    lens = np.fromiter((len(b) for b in enc), np.int64, len(enc))
    flat = np.frombuffer(b"".join(enc), np.uint8)
    table = np.zeros((len(enc), int(lens.max())), np.uint8)
    starts = np.cumsum(lens) - lens
    rows = np.repeat(np.arange(len(enc)), lens)
    table[rows, np.arange(flat.size) - starts[rows]] = flat
    return (torch.from_numpy(table).to(DEVICE),
            torch.from_numpy(lens).to(DEVICE))


def _float_texts(values, suffix):
    """The distinct float32 values of a tensor (sorted, on its device) and
    each one's shortest text that reads back as the same float32, followed
    by ``suffix``."""
    import numpy as np
    import torch
    uniq = torch.unique(values)
    return uniq, [np.format_float_positional(v, unique=True, trim="-")
                  + suffix for v in uniq.cpu().numpy()]


def _write_text(fh, codes, table, lens) -> int:
    """Append rows of tokens to a binary file, formatted on the card: row
    r is the table's strings at ``codes[r]`` in order, its last byte (a
    separator) replaced by a newline. Returns the bytes written."""
    import torch
    ln = lens[codes]
    keep = torch.arange(table.shape[1], device=codes.device) < ln[..., None]
    text = table[codes][keep]
    text[torch.cumsum(ln.sum(1), 0) - 1] = ord("\n")
    data = text.cpu().numpy()
    fh.write(memoryview(data))
    return data.size


def _write_token_file(path, n_rows, n_tokens, width, codes_of) -> int:
    """Write ``n_rows`` rows of ``n_tokens`` tokens, ``codes_of(lo, hi)``
    giving a block's codes, in blocks of about TEXT_BLOCK_BYTES of text
    (before the padding is dropped)."""
    block = max(1, TEXT_BLOCK_BYTES // (n_tokens * width))
    written = 0
    with open(path, "wb") as fh:
        for lo in range(0, n_rows, block):
            hi = min(lo + block, n_rows)
            written += _write_text(fh, *codes_of(lo, hi))
    return written


def _write_libsvm(path, y, ids, values, n_features) -> int:
    """A libsvm file of rows y[r] ids[r, j] + 1 : values[r, j] (every
    slot, in slot order; the values' shortest float32 texts), formatted on
    the card. ``y`` holds 0/1 labels."""
    import torch
    uniq, texts = _float_texts(values, " ")
    table, lens = _token_table(["0 ", "1 "]
                               + [f"{j + 1}:" for j in range(n_features)]
                               + texts)
    k = values.shape[1]

    def codes_of(lo, hi):
        c = torch.empty((hi - lo, 1 + 2 * k), dtype=torch.long,
                        device=values.device)
        c[:, 0] = y[lo:hi].long()
        c[:, 1::2] = ids[lo:hi].long() + 2
        c[:, 2::2] = torch.searchsorted(uniq, values[lo:hi]) + 2 + n_features
        return c, table, lens
    return _write_token_file(path, values.shape[0], 1 + 2 * k,
                             table.shape[1], codes_of)


def _write_csv(path, y, x) -> int:
    """A CSV file of rows y[r], x[r, 0], ..., x[r, d - 1] (the values'
    shortest float32 texts), formatted on the card."""
    import torch
    uniq, texts = _float_texts(x, ",")
    table, lens = _token_table(["0,", "1,"] + texts)

    def codes_of(lo, hi):
        c = torch.empty((hi - lo, 1 + x.shape[1]), dtype=torch.long,
                        device=x.device)
        c[:, 0] = y[lo:hi].long()
        c[:, 1:] = torch.searchsorted(uniq, x[lo:hi]) + 2
        return c, table, lens
    return _write_token_file(path, x.shape[0], 1 + x.shape[1],
                             table.shape[1], codes_of)


def _dense_rows(n, d, seed):
    """Dense rows on the card: x_ij = round(z 2^16 / sqrt(d)) 2^-16 with z
    ~ N(0, 1) (float32, exact), labels 1[x beta + N(0, 1/4) > 0] with beta
    ~ N(0, I) (float32 0/1)."""
    import math
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    z = torch.randn((n, d), generator=g, device=DEVICE)
    x = torch.round(z * (2.0 ** 16 / math.sqrt(d))) * 2.0 ** -16
    beta = torch.randn(d, generator=g, device=DEVICE)
    noise = torch.randn(n, generator=g, device=DEVICE) * 0.5
    return x, (x @ beta + noise > 0).float()


def _read_numbers(read, ds_of, file_bytes):
    """Run one read (``read()`` gives the result, ``ds_of`` its dataset),
    recording its seconds, rates, peak device memory above what was
    allocated before, the host's peak RSS and the reader's split."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _RssPeak() as rss:
        out, seconds = _timed(read)
    ds = ds_of(out)
    stats = dict(ds.ingest_stats)
    peak = torch.cuda.max_memory_allocated() - base
    limit = 2 * stats["dataset_bytes"] + stats["max_copy_bytes"]
    return out, {"s": seconds, "mb_per_s": file_bytes / seconds / 1e6,
                 "rows_per_s": ds.n_rows / seconds,
                 "peak_device_bytes": peak,
                 "dataset_bytes": stats["dataset_bytes"],
                 "chunk_bytes": stats["max_copy_bytes"],
                 "peak_limit_bytes": limit, "peak_within_limit": peak <= limit,
                 "host_peak_rss_bytes": rss.peak, "split": stats}


def phase_ingest_criteo(tmp):
    """Criteo-class rows written as a libsvm file and read back onto the
    card (``read_libsvm_sparse`` at each reader count of INGEST_READERS):
    bitwise equal to the generated rows and to each other, every read
    served by the native scanner, the reader's split (parse, copies,
    assembly) and peak memory; then phase 25's fit on the read rows
    through S1 and S2, bitwise equal to the fit on the generated rows.
    Returns S1's and S2's launches in that fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like
    from cycloneml_tpu_torch.dataset.sparse import read_libsvm_sparse
    from cycloneml_tpu_torch.native import host
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_ingest_criteo")
    try:
        gen, gen_s = _timed(lambda: generate_criteo_like(
            ctx, INGEST_N, seed=0, hash_dim=CRITEO_D))
        n = gen.n_rows
        path = os.path.join(tmp, "criteo.svm")
        size, write_s = _timed(lambda: _write_libsvm(
            path, gen.y[:n], gen.indices[:n], gen.values[:n], CRITEO_D))
        built, build_s = _timed(host.native_available)  # not in a read
        host.reset_read_counts()
        reads, numbers = {}, {}
        for r in INGEST_READERS:
            reads[r], numbers[r] = _read_numbers(
                lambda: read_libsvm_sparse(ctx, path, n_features=CRITEO_D,
                                           n_readers=r),
                lambda out: out[0], size)
        served = dict(host.READS)
        os.remove(path)

        def same(ds, y):
            return all(torch.equal(getattr(ds, a), getattr(gen, a))
                       for a in ("indices", "values", "y", "w")) and \
                ds.n_rows == n and ds.n_features == CRITEO_D and \
                bool(np.array_equal(y, gen.y[:n].double().cpu().numpy()))

        equal = {r: same(*reads[r]) for r in INGEST_READERS}
        ds = reads[INGEST_READERS[0]][0]
        del reads
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        model, fit_s = _sparse_fit(ctx, ds, "auto")
        s1, s2 = kernels.ell_rows.launches, kernels.ell_cols.launches
        others = _other_launches(kernels, "ell_rows", "ell_cols")
        g_model, g_fit_s = _sparse_fit(ctx, gen, "auto")
        evals = model.summary.total_evals
        bitwise = bool(np.array_equal(model.coefficients.values,
                                      g_model.coefficients.values)) and \
            model.intercept == g_model.intercept
        _line("ingest_criteo", n=n, k=gen.k_max, d=CRITEO_D,
              reduced={"n": f"{CRITEO_N:,} -> {n:,} rows (the text "
                            "file's write and two reads; 39 slots, 2^20 "
                            "columns kept)"},
              generate_s=gen_s, file_bytes=size, write_s=write_s,
              native_build_s=build_s,
              reads={str(r): numbers[r] for r in INGEST_READERS},
              native_reads=served, bitwise_equal_to_generated=equal)
        _line("ingest_criteo_fit", fit_s=fit_s, generated_fit_s=g_fit_s,
              iterations=model.summary.total_iterations, evals=evals,
              s1_launches=s1, s2_launches=s2, other_launches=others,
              bitwise_equal_to_generated_fit=bitwise,
              final_objective=model.summary.objective_history[-1])
        _check("ingest criteo", {
            "the native scanner built": built,
            "every read bitwise equal to the generated rows":
                all(equal.values()),
            "every read served by the native scanner":
                served.get("python", 0) == 0
                and served.get("native", 0) == sum(INGEST_READERS),
            "peak device memory within 2x the dataset plus one chunk":
                all(v["peak_within_limit"] for v in numbers.values()),
            "S1 launched once per evaluation": s1 == evals,
            "S2 launched once per evaluation and once for the summary":
                s2 == evals + 1,
            "no other kernel launched": others == 0,
            "the fit on the read rows bitwise equal to the fit on the "
            "generated rows": bitwise,
        })
        return {"s1": s1, "s2": s2}
    finally:
        ctx.stop()


def phase_ingest_dense(tmp):
    """The dense readers: configuration 2's rows as a float32 .npy file
    (label last) through ``read_npy_chunked`` and phase 6's
    LinearRegression on them through K2; rows of epsilon's layout as a
    dense libsvm file through ``read_libsvm`` streamed and whole and phase
    4's LogisticRegression settings through K1; a CSV file through
    ``read_csv_chunked`` and ``read_csv``. Each read bitwise equal to
    ``from_numpy`` of the same rows (and the two of a kind to each other),
    each fit bitwise equal to the fit on ``from_numpy``'s dataset, every
    libsvm and whole-CSV read served by the native scanner. Returns K2's
    and K1's launches in the fits on read data."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.dataset.io import (read_csv, read_csv_chunked,
                                                read_libsvm,
                                                read_npy_chunked)
    from cycloneml_tpu_torch.dataset.random import generate_regression
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.native import host
    from cycloneml_tpu_torch.ops import kernels

    def same(a, b):
        return all(torch.equal(getattr(a, t), getattr(b, t))
                   for t in ("x", "y", "w")) and a.n_rows == b.n_rows

    def same_fit(a, b):
        return bool(np.array_equal(a.coefficients.values,
                                   b.coefficients.values)) and \
            a.intercept == b.intercept

    ctx = _context("chip_smoke_ingest_dense")
    try:
        host.reset_read_counts()
        # configuration 2 as a .npy file
        gen, gen_s = _timed(lambda: generate_regression(
            ctx, LIN_N, LIN_D, seed=11, noise=0.1))
        rows = np.empty((LIN_N, LIN_D + 1), dtype=np.float32)
        for lo in range(0, LIN_N, ROWS):
            hi = min(lo + ROWS, LIN_N)
            rows[lo:hi, :LIN_D] = gen.x[lo:hi].float().cpu().numpy()
        rows[:, LIN_D] = gen.y[:LIN_N].float().cpu().numpy()
        npy = os.path.join(tmp, "config2.npy")
        _, npy_write_s = _timed(lambda: np.save(npy, rows))
        npy_bytes = os.path.getsize(npy)
        ds_npy, npy_nums = _read_numbers(
            lambda: read_npy_chunked(ctx, npy, label_col=LIN_D),
            lambda out: out, npy_bytes)
        ref = InstanceDataset.from_numpy(ctx, rows[:, :LIN_D],
                                         rows[:, LIN_D])
        del rows
        npy_equal = same(ds_npy, ref) and torch.equal(ds_npy.x, gen.x)
        del gen

        def linreg(ds):
            return _timed(lambda: LinearRegression(
                regParam=0.001, elasticNetParam=0.5, maxIter=100, tol=1e-7,
                solver="l-bfgs").fit(ds))

        kernels.reset_launch_counts()
        lin, lin_s = linreg(ds_npy)
        k2 = kernels.glm_sweep.launches_by_link[kernels.SQUARED]
        k2_others = _other_launches(kernels, "squared")
        lin_ref, _ = linreg(ref)
        del ds_npy, ref
        torch.cuda.empty_cache()

        # epsilon's layout as a dense libsvm file
        x, y = _dense_rows(EPS_N, EPS_D, seed=13)
        svm = os.path.join(tmp, "epsilon.svm")
        svm_bytes, svm_write_s = _timed(lambda: _write_libsvm(
            svm, y, torch.arange(EPS_D, device=x.device).expand(EPS_N, -1),
            x, EPS_D))
        ds_s, svm_stream_nums = _read_numbers(
            lambda: read_libsvm(ctx, svm, n_features=EPS_D, streamed=True),
            lambda out: out, svm_bytes)
        ds_w, svm_whole_s = _timed(lambda: read_libsvm(
            ctx, svm, n_features=EPS_D, streamed=False))
        os.remove(svm)
        ref = InstanceDataset.from_numpy(ctx, x.cpu().numpy(),
                                         y.cpu().numpy())
        svm_equal = same(ds_s, ref) and same(ds_w, ref)
        del ds_w, x, y

        def logistic(ds):
            return _timed(lambda: LogisticRegression(
                maxIter=25, regParam=0.01, tol=0.0).fit(ds))

        kernels.reset_launch_counts()
        lr, lr_s = logistic(ds_s)
        k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        k1_others = _other_launches(kernels, "logistic")
        lr_ref, _ = logistic(ref)
        del ds_s, ref

        # CSV
        cx, cy = _dense_rows(CSV_N, CSV_D - 1, seed=14)
        csv = os.path.join(tmp, "rows.csv")
        csv_bytes, csv_write_s = _timed(lambda: _write_csv(csv, cy, cx))
        ds_cc, csv_chunked_nums = _read_numbers(
            lambda: read_csv_chunked(ctx, csv), lambda out: out, csv_bytes)
        ds_cw, csv_whole_s = _timed(lambda: read_csv(ctx, csv))
        os.remove(csv)
        csv_equal = same(ds_cc, ds_cw) and ds_cc.n_rows == CSV_N and \
            ds_cc.n_features == CSV_D - 1
        served = dict(host.READS)
        _line("ingest_npy", n=LIN_N, d=LIN_D, file_bytes=npy_bytes,
              write_s=npy_write_s, read=npy_nums,
              bitwise_equal_to_from_numpy=npy_equal)
        _line("ingest_npy_fit", fit_s=lin_s, evals=lin.summary.total_evals,
              iterations=lin.summary.total_iterations, k2_launches=k2,
              other_launches=k2_others,
              bitwise_equal_to_from_numpy_fit=same_fit(lin, lin_ref))
        _line("ingest_libsvm_dense", n=EPS_N, d=EPS_D, file_bytes=svm_bytes,
              reduced={"n": f"400,000 -> {EPS_N:,} rows (epsilon's "
                            "training set; the text file's write and "
                            "two reads)"},
              write_s=svm_write_s, streamed=svm_stream_nums,
              whole_s=svm_whole_s, whole_mb_per_s=svm_bytes / svm_whole_s
              / 1e6, bitwise_equal_to_from_numpy=svm_equal)
        _line("ingest_libsvm_fit", fit_s=lr_s, evals=lr.summary.total_evals,
              iterations=lr.summary.total_iterations, k1_launches=k1,
              other_launches=k1_others,
              bitwise_equal_to_from_numpy_fit=same_fit(lr, lr_ref))
        _line("ingest_csv", n=CSV_N, columns=CSV_D, file_bytes=csv_bytes,
              write_s=csv_write_s, chunked=csv_chunked_nums,
              whole_s=csv_whole_s, whole_mb_per_s=csv_bytes / csv_whole_s
              / 1e6, chunked_equal_to_whole=csv_equal)
        _line("ingest_native_reads", **served)
        _check("ingest dense", {
            ".npy read bitwise equal to from_numpy of the same rows":
                npy_equal,
            "libsvm reads (streamed, whole) bitwise equal to from_numpy of "
            "the parsed rows": svm_equal,
            "read_csv_chunked equal to read_csv": csv_equal,
            "peak device memory within 2x the dataset plus one chunk":
                npy_nums["peak_within_limit"]
                and svm_stream_nums["peak_within_limit"]
                and csv_chunked_nums["peak_within_limit"],
            "K2 launched once per evaluation on the .npy rows":
                k2 == lin.summary.total_evals and k2_others == 0,
            "K1 launched once per evaluation on the libsvm rows":
                k1 == lr.summary.total_evals and k1_others == 0,
            "fits on read data bitwise equal to fits on from_numpy's":
                same_fit(lin, lin_ref) and same_fit(lr, lr_ref),
            "every libsvm and whole-CSV read served by the native scanner":
                served.get("python", 0) == 0
                and served.get("native", 0) == 3,
        })
        # the .npy stays for phase 41's streamed fit, which removes it
        return {"k2": k2, "k1": k1, "npy": npy, "linreg": lin}
    finally:
        ctx.stop()


_ARRAYS = ("_coef", "_icpt", "_num_classes", "_is_multinomial", "_centers",
           "training_cost", "pc", "explained_variance", "user_ids",
           "item_ids", "user_factors", "item_factors")


def _model_arrays(model, prefix=""):
    """Every learned array of a model, nested models included, by name."""
    import numpy as np
    out = {}
    for attr, tag in (("stages", "stage"), ("models", "model")):
        for i, s in enumerate(getattr(model, attr, None) or []):
            out.update(_model_arrays(s, f"{prefix}{tag}{i}."))
    if getattr(model, "best_model", None) is not None:
        out.update(_model_arrays(model.best_model, prefix + "best."))
        out[prefix + "avg_metrics"] = np.asarray(model.avg_metrics)
    for name in _ARRAYS:
        v = getattr(model, name, None)
        if v is not None:
            out[prefix + name] = np.asarray(v)
    return out


def _same_state(a, b) -> bool:
    sa, sb = _model_arrays(a), _model_arrays(b)
    return bool(sa) and sorted(sa) == sorted(sb) and all(
        sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape
        and sa[k].tobytes() == sb[k].tobytes() for k in sa)


def _same_outputs(a, b, frame) -> bool:
    import numpy as np
    oa, ob = a.transform(frame), b.transform(frame)
    new = [c for c in oa.columns if c not in frame.columns]
    return bool(new) and sorted(new) == sorted(
        c for c in ob.columns if c not in frame.columns) and all(
        np.asarray(oa[c]).tobytes() == np.asarray(ob[c]).tobytes()
        for c in new)


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_persistence(tmp):
    """Save and load every model the run fitted (kept by the phases), and
    a Pipeline of PCA(k=PIPE_K) and phase 4's LogisticRegression fitted on
    phase 4's data cut to CV_N rows (K4 once, then K1 once per
    evaluation): the loaded arrays bitwise equal to the saved ones, the
    transforms' outputs bitwise equal (every model transforms on the
    host), ALS's held-out RMSE the same number; save and load seconds and
    bytes. Returns K4's and K1's launches in the Pipeline's fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.base import Pipeline
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.feature import PCA
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_persistence")
    try:
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        frame = MLFrame(ctx, {"features": ds.x[:CV_N].float().cpu().numpy(),
                              "label": ds.y_host()[:CV_N]})
        del ds
        torch.cuda.empty_cache()
        pipe = Pipeline([PCA(k=PIPE_K, inputCol="features", outputCol="pca"),
                         LogisticRegression(featuresCol="pca", maxIter=25,
                                            regParam=0.01, tol=0.0)])
        kernels.reset_launch_counts()
        pmodel, pipe_s = _timed(lambda: pipe.fit(frame))
        k4 = kernels.gramian.launches
        k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "gramian", "logistic")
        evals = pmodel.stages[1].summary.total_evals
        _keep("Pipeline", pmodel, frame["features"])
        del frame
        results, checks = {}, {}
        for name, (model, cols) in _FITTED.items():
            path = os.path.join(tmp, name)
            _, save_s = _timed(lambda: model.save(path))
            loaded, load_s = _timed(lambda: type(model).load(path))
            probe = MLFrame(ctx, {k: v for k, v in cols.items()
                                  if k != "rating"})
            ok = _same_state(model, loaded) and \
                _same_outputs(model, loaded, probe)
            results[name] = {"save_s": save_s, "load_s": load_s,
                             "bytes": _dir_bytes(path),
                             "bitwise_equal": ok}
            if "rating" in cols:
                got = [_als_rmse(m, (probe, cols["rating"]))[0]
                       for m in (model, loaded)]
                results[name]["heldout_rmse"] = got
                ok = ok and got[0] == got[1]
            checks[f"{name}: loaded arrays and transform outputs bitwise "
                   "equal"] = ok
        _line("persistence", models=results, pipeline_fit_s=pipe_s,
              pipeline={"pca_k": PIPE_K, "n": CV_N, "d": FIT_D,
                        "k4_launches": k4, "k1_launches": k1,
                        "evals": evals, "other_launches": others},
              transforms="host (numpy) for every model")
        checks.update({
            "every model the run fitted saved and loaded":
                set(_FITTED) >= set(PERSISTED),
            "the Pipeline's PCA launched K4 once": k4 == 1,
            "its LogisticRegression launched K1 once per evaluation":
                k1 == evals,
            "no other kernel launched": others == 0,
        })
        _check("persistence", checks)
        return {"k4": k4, "k1": k1}
    finally:
        _FITTED.clear()
        ctx.stop()



# -- out-of-core streamed fits ------------------------------------------------

def _ooc_context(name, tmp, **conf):
    """A context whose spills go to a directory of their own under
    ``tmp`` (removed by :func:`_ooc_done`)."""
    ctx = _context(name)
    spill = tempfile.mkdtemp(prefix="spill_", dir=tmp)
    ctx.conf.set("cyclone.oocore.dir", spill)
    for k, v in conf.items():
        ctx.conf.set(k, v)
    return ctx, spill


def _ooc_done(ctx, spill):
    """The end of a streamed phase: the shard-set cache emptied, the
    spill directory removed, the context stopped."""
    from cycloneml_tpu_torch.oocore import shard_set_cache
    try:
        shard_set_cache().clear()
        shutil.rmtree(spill, ignore_errors=True)
    finally:
        ctx.stop()


def _shard_rows(ctx) -> int:
    from cycloneml_tpu_torch.conf import OOCORE_SHARD_ROWS
    return int(ctx.conf.get(OOCORE_SHARD_ROWS))


def _lr_stream(tol=OOC_TOL):
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    return LogisticRegression(maxIter=25, regParam=0.01, tol=tol)


def _ooc_split(summary):
    """A streamed fit's epochs split: host reads, the copies' device time,
    the device's waits on copies, host waits, the shards' device time.
    ``copy_hidden_share``: 1 - the epochs' wall time past the host's reads
    (an upper bound on the copies' exposed time) over the copies' time;
    ``copy_device_stall_share``: the share of the copies' time the
    caller's stream sat waiting for them (exposed on the device, not
    necessarily on the wall)."""
    st = dict(summary.stream_stats)
    copy_s = st["copy_s"]
    exposed = min(copy_s, max(0.0, st["wall_s"] - st["read_s"]))
    st["copy_hidden_share"] = 1.0 - exposed / copy_s if copy_s > 0 \
        else None
    st["copy_device_stall_share"] = st["copy_stall_s"] / copy_s \
        if copy_s > 0 else None
    st["read_gb_per_s"] = st["bytes"] / st["read_s"] / 1e9 \
        if st["read_s"] > 0 else None
    return st


def _ooc_peak_limit(sds, n_coef, extras_bytes, depth=2):
    """(depth + 1) staged shards (X, y, w at the slot geometry) plus the
    fit's vectors (``costs.predict_fit_peak`` of no dataset array: the
    sweep's partials, the L-BFGS vectors) and its replicated extras."""
    from cycloneml_tpu_torch.observe import costs
    slot = sds.pad_rows * (sds.n_features * sds.x_dtype.itemsize
                           + 2 * sds.y_dtype.itemsize)
    return (depth + 1) * slot + extras_bytes + costs.predict_fit_peak(
        [], n_coef, sds.n_features, device=DEVICE)


def _measured_fit(fit):
    """(model, seconds, peak device bytes above the memory in use before)
    of one fit."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, seconds = _timed(fit)
    return model, seconds, torch.cuda.max_memory_allocated() - base


def phase_stream_lr(tmp):
    """Streamed LogisticRegression under ``cyclone.oocore.mode=force`` at
    bench.py's shape (phase 4's data, 2M x 1280 bf16, 31 shards of 65,536
    rows): the in-core K1 fit, then two streamed fits (the first spills
    the dataset, the second attaches to the cached spill). K1 once a shard
    an evaluation, the models at the kernel tolerance of the in-core fit,
    the two streamed fits bitwise equal, the peak device memory of a
    streamed fit within its slots and vectors, the epochs' split. Returns
    K1's launches in the first streamed fit and its model."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.oocore import shard_set_cache
    from cycloneml_tpu_torch.ops import kernels

    ctx, spill = _ooc_context("chip_smoke_stream_lr", tmp)
    try:
        ds, gen_s = _timed(lambda: generate_classification(
            ctx, FIT_N, FIT_D, seed=0))
        incore, incore_s = _timed(lambda: _lr_stream().fit(ds))
        ctx.conf.set("cyclone.oocore.mode", "force")
        cache = shard_set_cache()
        st0 = cache.stats()
        # the main path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        m1, s1 = _timed(lambda: _lr_stream().fit(ds))
        k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        k1_bf16 = kernels.glm_sweep.launches_by_dtype[torch.bfloat16]
        others = _other_launches(kernels, "logistic")
        st1 = cache.stats()
        m2, s2, peak = _measured_fit(lambda: _lr_stream().fit(ds))
        st2 = cache.stats()
        sds = next(iter(cache._entries.values())).sds
        n_shards = sds.n_shards
        limit = _ooc_peak_limit(sds, FIT_D + 1, 2 * FIT_D * 4)
        a, b = m1.summary, incore.summary
        coef_ok = _close(m1.coefficients.values, incore.coefficients.values,
                         m1.intercept, incore.intercept)
        obj_rel = abs(a.objective_history[-1] - b.objective_history[-1]) \
            / abs(b.objective_history[-1])
        split = _ooc_split(m2.summary)
        _line("stream_lr", n=FIT_N, d=FIT_D, shards=n_shards,
              pad_rows=sds.pad_rows, stream_dtype=_dt(
                  torch.empty(0, dtype=sds.x_dtype)),
              spill_bytes=st1["spillWriteBytes"] - st0["spillWriteBytes"],
              generate_s=gen_s,
              incore={"iterations": b.total_iterations,
                      "evals": b.total_evals, "s": incore_s,
                      "final_objective": b.objective_history[-1]},
              streamed={"iterations": a.total_iterations,
                        "evals": a.total_evals,
                        "dispatches": a.total_dispatches,
                        "k1_launches": k1, "first_s": s1, "second_s": s2,
                        "final_objective": a.objective_history[-1]},
              objective_rel_diff=obj_rel,
              max_abs_coef_diff=float(np.max(np.abs(
                  m1.coefficients.values - incore.coefficients.values))),
              second_fit_cache_hit=st2["hits"] - st1["hits"],
              peak_device_bytes=peak, peak_limit_bytes=limit,
              split=split)
        _check("stream_lr", {
            "the fit streamed": a.streamed and m2.summary.streamed,
            "shards of cyclone.oocore.shardRows rows (31 at 2M rows)":
                n_shards == -(-FIT_N // _shard_rows(ctx)),
            "K1 launched once a shard an evaluation":
                k1 == a.total_evals * n_shards == a.total_dispatches
                and k1_bf16 == k1,
            "no other kernel launched": others == 0,
            "coefficients at the kernel tolerance of the in-core K1 fit "
            "(rtol 5e-3, atol 5e-4)": coef_ok,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "a second streamed fit is bitwise equal": bool(np.array_equal(
                m2.coefficients.values, m1.coefficients.values))
                and m2.intercept == m1.intercept,
            "the second fit attached to the spill (0 bytes written)":
                st2["hits"] == st1["hits"] + 1
                and st2["spillWriteBytes"] == st1["spillWriteBytes"],
            "peak device memory within (prefetchDepth + 1) shards plus "
            "the fit's vectors": peak <= limit,
            "the copies' hidden share is measured":
                split["copy_hidden_share"] is not None
                and 0.0 <= split["copy_hidden_share"] <= 1.0,
            "finite model": bool(np.all(np.isfinite(
                m1.coefficients.values))),
        })
        return k1, m1
    finally:
        _ooc_done(ctx, spill)


def phase_stream_file(npy, linreg_model, tmp):
    """A file straight to a streamed fit: configuration 2's .npy (phase
    38's, label last) through ``iter_npy_chunks`` into
    ``StreamingDataset.from_chunks`` (no in-core dataset), then phase 6's
    LinearRegression (OWL-QN) streamed through K2: launches = evaluations
    x shards, the peak bound, and the model at the kernel tolerance of
    phase 38's in-core fit on the read rows. Removes the file. Returns
    K2's launches."""
    import numpy as np
    from cycloneml_tpu_torch.dataset.io import iter_npy_chunks
    from cycloneml_tpu_torch.ml.regression import LinearRegression
    from cycloneml_tpu_torch.oocore import StreamingDataset
    from cycloneml_tpu_torch.ops import kernels

    ctx, spill = _ooc_context("chip_smoke_stream_file", tmp)
    try:
        sds, shard_s = _timed(lambda: StreamingDataset.from_chunks(
            ctx, iter_npy_chunks(npy, label_col=LIN_D), LIN_D))
        os.remove(npy)

        def fit():
            return LinearRegression(
                regParam=0.001, elasticNetParam=0.5, maxIter=100, tol=1e-7,
                solver="l-bfgs").fit(sds)

        kernels.reset_launch_counts()
        m, fit_s, peak = _measured_fit(fit)
        k2 = kernels.glm_sweep.launches_by_link[kernels.SQUARED]
        others = _other_launches(kernels, "squared")
        s, r = m.summary, linreg_model.summary
        limit = _ooc_peak_limit(sds, LIN_D, 3 * LIN_D * 4)
        coef_ok = _close(m.coefficients.values,
                         linreg_model.coefficients.values, m.intercept,
                         linreg_model.intercept)
        obj_rel = abs(s.objective_history[-1] - r.objective_history[-1]) \
            / abs(r.objective_history[-1])
        _line("stream_file", n=sds.n_rows, d=LIN_D, shards=sds.n_shards,
              shard_s=shard_s, fit_s=fit_s, iterations=s.total_iterations,
              evals=s.total_evals, k2_launches=k2,
              incore={"iterations": r.total_iterations,
                      "evals": r.total_evals,
                      "final_objective": r.objective_history[-1]},
              final_objective=s.objective_history[-1],
              objective_rel_diff=obj_rel, peak_device_bytes=peak,
              peak_limit_bytes=limit, split=_ooc_split(s))
        _check("stream_file", {
            "the fit streamed from the file's shards": s.streamed
                and sds.n_rows == LIN_N,
            "K2 launched once a shard an evaluation":
                k2 == s.total_evals * sds.n_shards == s.total_dispatches,
            "no other kernel launched": others == 0,
            "coefficients at the kernel tolerance of the in-core fit on "
            "the read rows (rtol 5e-3, atol 5e-4)": coef_ok,
            "final objectives agree to 1e-4": obj_rel <= 1e-4,
            "peak device memory within (prefetchDepth + 1) shards plus "
            "the fit's vectors": peak <= limit,
        })
        sds.close()
        return k2
    finally:
        _ooc_done(ctx, spill)


def phase_stream_degrade(tmp, streamed_model):
    """The budget guard's degradation: ``cyclone.memory.budgetFraction``
    set, ``deviceBytes`` below the in-core fit's predicted peak,
    ``cacheBytes`` above the spill. Phase 40's fit degrades to streaming
    and is bitwise its streamed model (the same shards, the same order);
    a second fit attaches with 0 spill-write bytes; under ``mode=off``
    with ``budgetAction=raise`` the fit raises MemoryBudgetError. Returns
    K1's launches in the degraded fit."""
    import numpy as np
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.observe import costs
    from cycloneml_tpu_torch.oocore import shard_set_cache
    from cycloneml_tpu_torch.ops import kernels

    ctx, spill = _ooc_context("chip_smoke_stream_degrade", tmp)
    try:
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        predicted = costs.predict_fit_peak(
            [ds.x, ds.y, ds.w], FIT_D + 1, FIT_D, device=DEVICE)
        # the card's memory as the guard sees it: below the in-core
        # fit's predicted peak; the cache holds the whole spill
        device_bytes = predicted * 3 // 4
        ctx.conf.set("cyclone.memory.budgetFraction", "0.9")
        ctx.conf.set("cyclone.memory.deviceBytes", str(device_bytes))
        ctx.conf.set("cyclone.oocore.cacheBytes",
                     str(2 * ds.x.numel() * ds.x.element_size()))
        cache = shard_set_cache()
        st0 = cache.stats()
        kernels.reset_launch_counts()
        m1, s1 = _timed(lambda: _lr_stream().fit(ds))
        k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "logistic")
        st1 = cache.stats()
        m2, s2 = _timed(lambda: _lr_stream().fit(ds))
        st2 = cache.stats()
        ctx.conf.set("cyclone.oocore.mode", "off")
        ctx.conf.set("cyclone.memory.budgetAction", "raise")
        try:
            _lr_stream().fit(ds)
            raised = False
        except costs.MemoryBudgetError:
            raised = True
        _line("stream_degrade", predicted_incore_bytes=predicted,
              device_bytes=device_bytes,
              budget_bytes=int(0.9 * device_bytes),
              warnings=len(ctx.memory_warnings),
              first={"s": s1, "evals": m1.summary.total_evals,
                     "k1_launches": k1,
                     "spill_bytes": st1["spillWriteBytes"]
                     - st0["spillWriteBytes"]},
              second={"s": s2, "spill_bytes": st2["spillWriteBytes"]
                      - st1["spillWriteBytes"],
                      "cache_hits": st2["hits"] - st1["hits"]},
              raised_under_off=raised)
        _check("stream_degrade", {
            "the in-core prediction is over the budget":
                predicted > 0.9 * device_bytes,
            "the over-budget fit degraded to streaming":
                m1.summary.streamed and len(ctx.memory_warnings) >= 1,
            "K1 launched once a shard an evaluation":
                k1 == m1.summary.total_dispatches and others == 0,
            "the degraded fit is phase 40's streamed model, bitwise":
                bool(np.array_equal(m1.coefficients.values,
                                    streamed_model.coefficients.values)),
            "the first fit spilled": st1["spillWriteBytes"]
                > st0["spillWriteBytes"],
            "a second fit attached with 0 spill-write bytes":
                m2.summary.streamed and st2["hits"] == st1["hits"] + 1
                and st2["spillWriteBytes"] == st1["spillWriteBytes"],
            "mode=off with budgetAction=raise raises MemoryBudgetError":
                raised,
        })
        return k1
    finally:
        _ooc_done(ctx, spill)


def phase_stream_fp8(tmp, streamed_bf16):
    """The e4m3 stream: phase 40's fit with ``streamDtype=float8`` (the
    spill requantized with one set-level scale), through K1's e4m3
    instance once a shard, held against the in-core fp8 fit on the same
    rows (``InstanceDataset.quantized``) and against phase 40's streamed
    bf16 fit at the fp8 envelope (20%); prints which it agrees with.
    Returns K1's e4m3 launches."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ops import kernels

    f8 = torch.float8_e4m3fn
    ctx, spill = _ooc_context("chip_smoke_stream_fp8", tmp)
    try:
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        ds8 = ds.quantized()
        incore8, incore_s = _timed(lambda: _lr_stream().fit(ds8))
        del ds8
        ctx.conf.set("cyclone.oocore.mode", "force")
        ctx.conf.set("cyclone.oocore.streamDtype", "float8")
        kernels.reset_launch_counts()
        m, fit_s, peak = _measured_fit(lambda: _lr_stream().fit(ds))
        e4m3 = kernels.glm_sweep.launches_by_dtype[f8]
        k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        others = _other_launches(kernels, "logistic")
        c = m.coefficients.values
        to_incore = _norm_rel(c, incore8.coefficients.values)
        to_bf16 = _norm_rel(c, streamed_bf16.coefficients.values)
        agrees = "in-core fp8" if to_incore <= to_bf16 else "streamed bf16"
        _line("stream_fp8", fit_s=fit_s, evals=m.summary.total_evals,
              e4m3_launches=e4m3, incore_fp8_s=incore_s,
              coef_norm_rel_to_incore_fp8=to_incore,
              coef_norm_rel_to_streamed_bf16=to_bf16,
              agrees_with=agrees, peak_device_bytes=peak,
              fallbacks=ctx.precision_fallbacks,
              split=_ooc_split(m.summary))
        _check("stream_fp8", {
            "the fit streamed e4m3 codes": m.summary.streamed
                and e4m3 == k1 > 0,
            "K1 e4m3 launched once a shard an evaluation":
                e4m3 == m.summary.total_dispatches and others == 0,
            "no fp8 fallback fired": not ctx.precision_fallbacks,
            "within the fp8 envelope (20%) of the in-core fp8 fit":
                to_incore < FP8_COEF_NORMREL,
            "within the fp8 envelope (20%) of the streamed bf16 fit":
                to_bf16 < FP8_COEF_NORMREL,
            "finite model": bool(np.all(np.isfinite(c))),
        })
        return e4m3
    finally:
        _ooc_done(ctx, spill)


def phase_stream_ovr(tmp):
    """Streamed stacked OneVsRest: OVR_K classes at d = 1280, rows cut to
    OOC_OVR_N, under force through K1s once a shard a lockstep evaluation
    (every model in one launch), the first OOC_SERIAL models held against
    their serial streamed fits (``fit_stacked`` of one model's labels) at
    the kernel tolerance, as the reference's
    test_streamed_stacked_fit_matches_serial_streamed. Returns K1s's
    launches."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_multiclass
    from cycloneml_tpu_torch.ml.classification import (LogisticRegression,
                                                       OneVsRest)
    from cycloneml_tpu_torch.ops import kernels

    ctx, spill = _ooc_context("chip_smoke_stream_ovr", tmp,
                              **{"cyclone.oocore.mode": "force"})
    try:
        ds = generate_multiclass(ctx, OOC_OVR_N, FIT_D, OVR_K, seed=7)
        y = np.asarray(ds.y_host()[:ds.n_rows])

        def clf():
            return LogisticRegression(maxIter=25, regParam=0.01,
                                      tol=OOC_TOL)

        kernels.reset_launch_counts()
        model, ovr_s = _timed(lambda: OneVsRest(
            classifier=clf(), parallelism=OVR_K).fit(ds))
        k1s = kernels.glm_sweep_stacked.launches
        others = _other_launches(kernels, "glm_stacked")
        s = model.models[0].summary
        n_shards = -(-OOC_OVR_N // _shard_rows(ctx))
        groups = -(-OVR_K // kernels.glm_sweep_stacked_group(ds.x.dtype,
                                                             FIT_D))
        serial, serial_s = [], 0.0
        for c in range(OOC_SERIAL):
            yc = torch.from_numpy((y == c).astype(np.float64))[None, :]
            (one,), t = _timed(lambda: clf().fit_stacked(ds, y_stack=yc))
            serial.append(one)
            serial_s += t
        ok = [_close(model.models[c].coefficients.values,
                     serial[c].coefficients.values,
                     model.models[c].intercept, serial[c].intercept)
              for c in range(OOC_SERIAL)]
        _line("stream_ovr", n=OOC_OVR_N, d=FIT_D, classes=OVR_K,
              shards=n_shards, reduced={
                  "n": f"2,000,000 -> {OOC_OVR_N:,} rows, and the serial "
                       f"streamed fits: {OOC_SERIAL} of {OVR_K} models "
                       "(their epochs)"},
              ovr_s=ovr_s, stacked_evals=s.stacked_evals,
              k1s_launches=k1s, groups=groups,
              evals=[m.summary.total_evals for m in model.models],
              serial_evals=[m.summary.total_evals for m in serial],
              serial_s=serial_s, serial_models=OOC_SERIAL,
              max_abs_coef_diff=[float(np.max(np.abs(
                  model.models[c].coefficients.values
                  - serial[c].coefficients.values)))
                  for c in range(OOC_SERIAL)],
              split=_ooc_split(s))
        _check("stream_ovr", {
            "the stacked fit streamed": s.streamed and s.n_models == OVR_K,
            "K1s launched once a shard a lockstep evaluation":
                k1s == s.stacked_evals * n_shards * groups
                and s.total_dispatches == s.stacked_evals * n_shards,
            "no other kernel launched": others == 0,
            "each model at the kernel tolerance of its serial streamed "
            "fit (rtol 5e-3, atol 5e-4)": all(ok),
            "the epochs are the most any model needs, not their sum":
                s.stacked_evals == max(m.summary.total_evals
                                       for m in model.models),
        })
        return k1s
    finally:
        _ooc_done(ctx, spill)


# -- the BLAS boundary, the distributed matrices and the clustering family ------

def _rel_err(got, truth) -> float:
    import numpy as np
    return float(np.max(np.abs(got - truth)) / max(np.max(np.abs(truth)),
                                                   1e-300))


def _wall_ms(fn, reps: int) -> float:
    """Wall milliseconds per call of ``fn`` (host work and copies
    included), the card synchronized around the calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / reps


def phase_blas():
    """The BLAS dispatch boundary at the reference's GEMM sizes and a
    4,096 x 4,096 BlockMatrix product, against numpy float64."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.linalg import (BLAS, DenseMatrix, DenseVector,
                                            Matrices, blas)
    from cycloneml_tpu_torch.linalg.block import BlockMatrix

    ctx = _context("chip_smoke_blas")
    try:
        rng = np.random.RandomState(45)
        sizes, checks = {}, {}
        largest = None
        for n in BLAS_SIZES:
            a, b, x = rng.randn(n, n), rng.randn(n, n), rng.randn(n)
            am, bm = DenseMatrix.from_array(a), DenseMatrix.from_array(b)
            t0 = time.perf_counter()
            truth = a @ b
            numpy_ms = (time.perf_counter() - t0) * 1000.0
            blas.reset_route_counts()
            c = Matrices.zeros(n, n)
            BLAS.gemm(1.0, am, bm, 0.0, c)
            y = DenseVector(np.zeros(n))
            BLAS.gemv(1.0, am, DenseVector(x), 0.0, y)
            routes = {"gemm": dict(BLAS.device_gemm.routes),
                      "gemv": dict(BLAS.device_gemv.routes)}
            # the largest entry error over the largest entry: a product
            # that drops part of its inner dimension fails this
            gemm_err = _rel_err(c.to_array(), truth)
            gemv_err = _rel_err(y.to_array(), a @ x)
            ta = torch.as_tensor(a, device=ctx.device).float()
            tb = torch.as_tensor(b, device=ctx.device).float()
            tx = torch.as_tensor(x, device=ctx.device).float()
            reps = max(2, 2 ** 31 // n ** 3)
            sizes[n] = {
                "routes": routes, "gemm_err": gemm_err, "gemv_err": gemv_err,
                "flops": 2 * n ** 3,
                "blas_gemm_ms": _wall_ms(
                    lambda: BLAS.gemm(1.0, am, bm, 0.0, c), 3),
                "device_gemm_ms": _wall_ms(
                    lambda: BLAS.device_gemm(a, b), 3),
                "resident_matmul_ms": _time_ms(lambda: ta @ tb, reps),
                "blas_gemv_ms": _wall_ms(
                    lambda: BLAS.gemv(1.0, am, DenseVector(x), 0.0, y), 3),
                "resident_matvec_ms": _time_ms(lambda: ta @ tx, 20),
                "numpy_f64_gemm_ms": numpy_ms}
            gemv_device = n * n >= blas.DEVICE_FLOPS_THRESHOLD
            checks.update({
                f"{n}: BLAS.gemm within 1e-5 of max|AB|": gemm_err <= 1e-5,
                f"{n}: BLAS.gemv within 1e-5 of max|Ax|": gemv_err <= 1e-5,
                f"{n}: gemm routed to the card": routes["gemm"] ==
                    {"device": 1, "host": 0},
                f"{n}: gemv routed by the threshold": routes["gemv"] ==
                    ({"device": 1, "host": 0} if gemv_device
                     else {"device": 0, "host": 1})})
            if n == BLAS_SIZES[-1]:
                largest = (a, b, truth)
            del ta, tb, tx
        # a product below the threshold stays on the host
        blas.reset_route_counts()
        small = rng.randn(64, 64)
        BLAS.device_gemm(small, small)
        checks["64 x 64 stays on the host"] = \
            BLAS.device_gemm.routes == {"device": 0, "host": 1}
        a, b, truth = largest
        (ba, bb), place_s = _timed(lambda: (BlockMatrix.from_numpy(ctx, a),
                                            BlockMatrix.from_numpy(ctx, b)))
        prod = ba.multiply(bb)
        block_err = _rel_err(prod.to_numpy(), truth)
        block_ms = _time_ms(lambda: ba.multiply(bb), 10)
        _line("blas", threshold=blas.DEVICE_FLOPS_THRESHOLD,
              compute_dtype="float32", tf32=torch.backends.cuda.matmul
              .allow_tf32, sizes=sizes,
              block_matrix={"n": a.shape[0], "storage": list(ba._arr.shape),
                            "err": block_err, "multiply_ms": block_ms,
                            "place_s": place_s,
                            "bound_ms": 2 * a.shape[0] ** 3
                            / H100_F32_FLOPS * 1e3})
        checks["BlockMatrix multiply within 1e-5 of max|AB|"] = \
            block_err <= 1e-5
        checks["BlockMatrix on the card"] = ba._arr.device.type == "cuda"
        checks["TF32 off"] = not torch.backends.cuda.matmul.allow_tf32
        _check("blas", checks)
    finally:
        ctx.stop()


def _planted_rows(n, centers, g, scales=None, dtype=None):
    """n rows drawn on the card: a uniform planted center each plus
    N(0, 1) noise (times the center's per-column ``scales`` when given),
    stored in ``dtype`` (bf16 by default); returns (X, labels)."""
    import torch
    dtype = dtype or torch.bfloat16
    dev = centers.device
    k, d = centers.shape
    labels = torch.randint(0, k, (n,), generator=g, device=dev)
    x = torch.empty((n, d), dtype=dtype, device=dev)
    for lo in range(0, n, ROWS):
        lab = labels[lo:lo + ROWS]
        noise = torch.randn((lab.shape[0], d), generator=g, device=dev)
        if scales is not None:
            noise *= scales[lab]
        x[lo:lo + ROWS] = (centers[lab] + noise).to(dtype)
    return x, labels


def _dataset_of(ctx, x, w_dtype=None):
    """An InstanceDataset over the device rows ``x`` (n a multiple of 8:
    no padding), y = 0, w = 1 at ``w_dtype`` (float32 by default)."""
    import torch
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    n = x.shape[0]
    dt = w_dtype or torch.float32
    return InstanceDataset(ctx, x, torch.zeros(n, dtype=dt, device=x.device),
                           torch.ones(n, dtype=dt, device=x.device), n,
                           x.shape[1])


def _bkm_centers(dev):
    """BKM_K planted centers, binary-tree placed: center c is
    sum_b (+-1 by bit b of c) * 6 * 2^(5 - b) on column b, so every level
    of the bisection has one split that keeps whole clusters apart (the
    nearest two centers 12 apart, against N(0, 1) noise)."""
    import torch
    levels = BKM_K.bit_length() - 1
    bits = (torch.arange(BKM_K)[:, None]
            >> torch.arange(levels - 1, -1, -1)[None, :]) & 1
    scale = 6.0 * 2.0 ** torch.arange(levels - 1, -1, -1).float()
    c = torch.zeros((BKM_K, BKM_D))
    c[:, :levels] = (bits.float() * 2 - 1) * scale
    return c.to(dev)


def _same_tree(a, b) -> bool:
    import numpy as np
    return (np.array_equal(a._node_index, b._node_index)
            and a._centers.tobytes() == b._centers.tobytes()
            and sorted(a._tree) == sorted(b._tree)
            and all(a._tree[i].tobytes() == b._tree[i].tobytes()
                    for i in a._tree))


def phase_bisecting():
    """BisectingKMeans at configuration 3's shape through the center sums,
    twice, against a float64 fit through the plain sums, and a cosine fit
    on a cut of the rows; returns the center sums' launches of the first
    fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.clustering import BisectingKMeans
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_bisecting")
    try:
        g = torch.Generator(device=ctx.device).manual_seed(46)
        centers = _bkm_centers(ctx.device)
        (x, _), gen_s = _timed(lambda: _planted_rows(BKM_N, centers, g))
        ds = _dataset_of(ctx, x)

        def fit(data, **kw):
            return _timed(lambda: BisectingKMeans(
                k=BKM_K, maxIter=20, seed=3, **kw).fit(data))

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        a, a_s = fit(ds)
        launches = kernels.center_sums.launches
        by_instance = dict(kernels.center_sums.launches_by_instance)
        others = _other_launches(kernels, "center_sums")
        peak = torch.cuda.max_memory_allocated()
        b, b_s = fit(ds)
        # the float64 fit on the same rows through the plain sums
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        x64 = x.double()
        kernels.reset_launch_counts()
        p, p_s = fit(_dataset_of(ctx, x64, torch.float64))
        plain_launches = kernels.center_sums.launches
        del x64
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
        # the cosine mode on the first BKM_COSINE_N rows
        kernels.reset_launch_counts()
        cos, cos_s = fit(_dataset_of(ctx, x[:BKM_COSINE_N]),
                         distanceMeasure="cosine")
        cos_launches = kernels.center_sums.launches
        # float64 X on the default route, on the same cut: the center sums
        # read it, two fits bitwise equal, the tree of the plain route
        ds64 = _dataset_of(ctx, x[:BKM_COSINE_N].double(), torch.float64)
        kernels.reset_launch_counts()
        f64a, f64_s = fit(ds64)
        f64_launches = kernels.center_sums.launches
        f64_others = _other_launches(kernels, "center_sums")
        f64b, _ = fit(ds64)
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        f64p, f64p_s = fit(ds64)
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
        del ds64
        f64_vs_plain = (float(np.max(np.abs(f64a._centers - f64p._centers)))
                        if np.array_equal(f64a._node_index, f64p._node_index)
                        else None)
        # one pass's child sums at this shape (2m = 64), timed alone
        cidx = torch.randint(0, BKM_K, (BKM_N,), generator=g,
                             device=ctx.device)
        sums_ms = _time_ms(lambda: kernels.center_sums(x, ds.w, cidx, BKM_K),
                           10)
        sums_plain_ms = _time_ms(lambda: kernels.center_sums_plain(
            x, ds.w, cidx, BKM_K), 3)
        sums_numbers = {"ms": sums_ms, "plain_ms": sums_plain_ms,
                        "bound_ms": (x.numel() * 2 + BKM_N * 8
                                     + BKM_K * (BKM_D + 1) * 4)
                        / H100_BYTES_PER_S * 1e3}
        del cidx
        planted = centers.double().cpu().numpy()
        dist = np.sqrt(((planted[:, None, :] - a._centers[None]) ** 2)
                       .sum(-1))
        near = dist.min(1)
        passes = sum(a.level_passes)
        levels = len(a.level_passes)
        _line("bisecting_fit", n=BKM_N, d=BKM_D, k=BKM_K,
              data_dtype="bfloat16", generate_s=gen_s,
              kernel={"fit_s": a_s, "repeat_fit_s": b_s,
                      "level_passes": a.level_passes,
                      "center_sums_launches": launches,
                      "center_sums_launches_by_instance": by_instance,
                      "ms_per_pass": a_s * 1000.0 / max(passes, 1)},
              plain_f64={"fit_s": p_s, "level_passes": p.level_passes,
                         "center_sums_launches": plain_launches},
              cosine={"n": BKM_COSINE_N, "fit_s": cos_s,
                      "level_passes": cos.level_passes,
                      "center_sums_launches": cos_launches},
              f64_center_sums={"n": BKM_COSINE_N, "fit_s": f64_s,
                               "plain_fit_s": f64p_s,
                               "level_passes": f64a.level_passes,
                               "center_sums_launches": f64_launches,
                               "centers_max_abs_diff_to_plain":
                                   f64_vs_plain},
              center_sums_at_k64=sums_numbers,
              leaves=len(a._node_index),
              planted_to_nearest_leaf_max=float(near.max()),
              planted_leaves_distinct=int(len(set(dist.argmin(1)))),
              max_memory_allocated=peak, x_bytes=x.numel() * 2)
        same_as_plain = (np.array_equal(a._node_index, p._node_index)
                         and sorted(a._tree) == sorted(p._tree))
        _check("bisecting fit", {
            "center sums launched once a pass and twice a level "
            "(counts, costs)": launches == passes + 2 * levels,
            "only the counting instance at 2m <= 64":
                by_instance[kernels.COUNTING] == launches,
            "no other kernel launched": others == 0,
            "k leaves": len(a._node_index) == BKM_K,
            "two fits bitwise equal": _same_tree(a, b),
            "the float64 plain fit launched no center sums":
                plain_launches == 0,
            "the float64 plain fit builds the same tree": same_as_plain,
            "leaf centers within rtol 5e-3, atol 5e-4 of the float64 fit":
                same_as_plain and bool(np.allclose(
                    a._centers, p._centers, rtol=5e-3, atol=5e-4)),
            "every planted center within 0.5 of a leaf of its own":
                float(near.max()) < 0.5
                and len(set(dist.argmin(1))) == BKM_K,
            "float64 X on the default route through the center sums":
                f64_launches == sum(f64a.level_passes)
                + 2 * len(f64a.level_passes) and f64_others == 0,
            "two float64 fits bitwise equal": _same_tree(f64a, f64b),
            "the float64 center-sums fit builds the plain float64 tree, "
            "centers within 1e-9": f64_vs_plain is not None
                and f64_vs_plain <= 1e-9,
            "cosine fit through the center sums": cos_launches ==
                sum(cos.level_passes) + 2 * len(cos.level_passes)
                and len(cos._node_index) == BKM_K
                and bool(np.all(np.isfinite(cos._centers))),
        })
        return launches, sums_numbers
    finally:
        ctx.stop()


def phase_gmm():
    """GaussianMixture on GMM_K planted components at GMM_N x GMM_D: two
    float32 fits (bf16 X) and a float64 fit on the same rows."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.clustering import GaussianMixture
    from cycloneml_tpu_torch.ml.clustering import gaussian_mixture as gm
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_gmm")
    try:
        g = torch.Generator(device=ctx.device).manual_seed(47)
        means = torch.randn((GMM_K, GMM_D), generator=g, device=ctx.device)
        scales = torch.rand((GMM_K, GMM_D), generator=g,
                            device=ctx.device) + 0.5
        (x, _), gen_s = _timed(lambda: _planted_rows(GMM_N, means, g,
                                                     scales))
        ds = _dataset_of(ctx, x)

        def fit(data):
            return _timed(lambda: GaussianMixture(
                k=GMM_K, maxIter=20, tol=0.01).fit(data))

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        a, a_s = fit(ds)
        launches = _other_launches(kernels)
        peak = torch.cuda.max_memory_allocated() - base
        b, b_s = fit(ds)
        x64 = x.double()
        p, p_s = fit(_dataset_of(ctx, x64, torch.float64))
        del x64
        chunk_bytes = 4 * GMM_K * gm.ROW_CHUNK * GMM_D * 4
        planted = means.double().cpu().numpy()
        dist = np.sqrt(((planted[:, None, :] - a._means[None]) ** 2).sum(-1))
        recovered = int(np.sum(dist.min(1) < 0.1))
        ll, ll64 = a.log_likelihood / GMM_N, p.log_likelihood / GMM_N
        _line("gmm_fit", n=GMM_N, d=GMM_D, k=GMM_K, data_dtype="bfloat16",
              generate_s=gen_s, row_chunk=gm.ROW_CHUNK,
              kernel_free_launches=launches,
              f32={"fit_s": a_s, "repeat_fit_s": b_s,
                   "iterations": a.num_iterations,
                   "ms_per_iteration": a_s * 1000.0 / a.num_iterations,
                   "mean_loglik": ll},
              f64={"fit_s": p_s, "iterations": p.num_iterations,
                   "mean_loglik": ll64},
              mean_loglik_abs_diff=abs(ll - ll64),
              mean_loglik_rel_diff=abs(ll - ll64) / abs(ll64),
              weights_max_diff=float(np.max(np.abs(a.weights - p.weights))),
              means_max_diff=float(np.max(np.abs(a._means - p._means))),
              planted_means_recovered=recovered,
              planted_to_nearest_mean=np.sort(dist.min(1)).tolist(),
              weights=np.sort(a.weights).tolist(),
              peak_bytes_over_data=peak, x_bytes=x.numel() * 2,
              one_chunk_intermediates_bytes=chunk_bytes)
        _check("gmm fit", {
            "no kernel launched (the reference's E-step is jnp)":
                launches == 0,
            "all iterations run (tol never met)":
                a.num_iterations == p.num_iterations == 20,
            "mean log-likelihood within 1e-4 (relative) of the float64 fit":
                abs(ll - ll64) <= 1e-4 * abs(ll64),
            "weights and means within rtol 5e-3, atol 5e-4 of the float64 "
            "fit": bool(np.allclose(a.weights, p.weights, rtol=5e-3,
                                    atol=5e-4))
                and bool(np.allclose(a._means, p._means, rtol=5e-3,
                                     atol=5e-4)),
            "two fits bitwise equal": a.weights.tobytes() == b.weights
                .tobytes() and a._means.tobytes() == b._means.tobytes()
                and a._covs.tobytes() == b._covs.tobytes()
                and a.log_likelihood == b.log_likelihood,
            "finite parameters, weights summing to 1":
                bool(np.all(np.isfinite(a._covs)))
                and abs(float(a.weights.sum()) - 1.0) < 1e-9,
            "peak device memory above the data within two chunks' "
            "intermediates": peak <= 2 * chunk_bytes,
        })
    finally:
        ctx.stop()


def _lda_corpus(ctx, g):
    """LDA_DOCS documents over LDA_VOCAB terms drawn on the card from
    LDA's generative process: LDA_TOPICS planted topics ~ Dirichlet(0.05)
    over the terms and each document's mixture ~ Dirichlet(0.1), from
    numpy RandomState(48); lengths ~ Poisson(LDA_TOKENS / LDA_DOCS) and
    each token's term ~ theta_d beta by ``torch.multinomial`` on the
    card's generator. Returns (bf16 counts, planted topics (k, V))."""
    import numpy as np
    import torch
    rng = np.random.RandomState(48)
    beta = rng.dirichlet(np.full(LDA_VOCAB, 0.05), size=LDA_TOPICS)
    theta = rng.dirichlet(np.full(LDA_TOPICS, 0.1), size=LDA_DOCS)
    lens = rng.poisson(LDA_TOKENS / LDA_DOCS, size=LDA_DOCS)
    dev = ctx.device
    bt = torch.as_tensor(beta, device=dev).float()
    th = torch.as_tensor(theta, device=dev).float()
    ln = torch.as_tensor(lens, device=dev)
    x = torch.zeros((LDA_DOCS, LDA_VOCAB), dtype=torch.float32, device=dev)
    for lo in range(0, LDA_DOCS, 2048):
        p = th[lo:lo + 2048] @ bt
        most = int(ln[lo:lo + 2048].max())
        idx = torch.multinomial(p, most, replacement=True, generator=g)
        live = torch.arange(most, device=dev)[None, :] < \
            ln[lo:lo + 2048, None]
        x[lo:lo + 2048].scatter_add_(1, idx, live.float())
    return x.to(torch.bfloat16), beta, int(lens.sum())


def phase_lda():
    """LDA at the Enron shape: the default online fit twice, a fit at
    subsamplingRate 1.0 and a float64 fit on the same counts."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.clustering import LDA
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_lda")
    try:
        g = torch.Generator(device=ctx.device).manual_seed(48)
        (x, beta, tokens), gen_s = _timed(lambda: _lda_corpus(ctx, g))
        largest = float(x.float().max())
        ds = _dataset_of(ctx, x)

        def fit(data, **kw):
            return _timed(lambda: LDA(k=LDA_TOPICS, maxIter=20, seed=1,
                                      **kw).fit(data))

        kernels.reset_launch_counts()
        a, a_s = fit(ds)
        launches = _other_launches(kernels)
        b, b_s = fit(ds)
        full, full_s = fit(ds, subsamplingRate=1.0)
        x64 = x.double()
        p, p_s = fit(_dataset_of(ctx, x64, torch.float64),
                     subsamplingRate=1.0)
        del x64
        probe = MLFrame(ctx, {"features": x[:LDA_PROBE].double().cpu()
                              .numpy()})
        (lp, lp64), lp_s = _timed(lambda: (full.log_perplexity(probe),
                                           p.log_perplexity(probe)))
        top = np.argsort(-beta, axis=1)[:, :10]

        def overlaps(model):
            fitted = [set(i.tolist()) for i, _ in model.describe_topics(10)]
            return [max(len(set(t.tolist()) & f) for f in fitted)
                    for t in top]

        ov_online, ov_full = overlaps(a), overlaps(full)
        lam_rel = float(np.max(np.abs(full._lam - p._lam))
                        / np.max(np.abs(p._lam)))
        _line("lda_fit", docs=LDA_DOCS, vocab=LDA_VOCAB, k=LDA_TOPICS,
              tokens=tokens, largest_count=largest,
              bf16_exact_counts=largest <= 256, data_dtype="bfloat16",
              generate_s=gen_s, kernel_free_launches=launches,
              online={"subsampling_rate": 0.05, "fit_s": a_s,
                      "repeat_fit_s": b_s,
                      "planted_top10_overlap": ov_online},
              full={"fit_s": full_s, "planted_top10_overlap": ov_full,
                    "log_perplexity": lp},
              f64={"fit_s": p_s, "log_perplexity": lp64},
              probe_docs=LDA_PROBE, log_perplexity_s=lp_s,
              log_perplexity_rel_diff=abs(lp - lp64) / abs(lp64),
              lambda_max_rel_diff=lam_rel)
        _check("lda fit", {
            "no kernel launched (the reference's E-step is jnp)":
                launches == 0,
            "bf16 holds every count exactly (largest <= 256)":
                largest <= 256,
            "two online fits with one seed bitwise equal":
                a._lam.tobytes() == b._lam.tobytes(),
            "log_perplexity at rate 1.0 within 1e-4 of the float64 fit":
                abs(lp - lp64) <= 1e-4 * abs(lp64),
            "finite topics": bool(np.all(np.isfinite(full._lam)))
                and bool(np.all(np.isfinite(a._lam))),
        })
    finally:
        ctx.stop()


def _pic_graph():
    """PIC_VERTICES vertices and PIC_EDGES undirected edges with two
    planted communities (a third and two thirds of the vertices, 95% of
    each vertex's edges inside its own), numpy RandomState(49): every
    vertex in at least one edge, ids shuffled over a wider range.
    Returns (src ids, dst ids, community of each sorted id)."""
    import numpy as np
    rng = np.random.RandomState(49)
    n, e = PIC_VERTICES, PIC_EDGES
    comm = (np.arange(n) >= n // 3).astype(np.int64)
    members = [np.flatnonzero(comm == c) for c in (0, 1)]
    src = np.concatenate([np.arange(n), rng.randint(0, n, e - n)])
    inside = rng.rand(e) < 0.95
    side = np.where(inside, comm[src], 1 - comm[src])
    dst = np.empty(e, np.int64)
    for c in (0, 1):
        sel = side == c
        dst[sel] = members[c][rng.randint(0, len(members[c]), sel.sum())]
    ids = rng.permutation(4 * n)[:n] + 1000
    return ids[src], ids[dst], comm[np.argsort(ids)]


def phase_pic():
    """PowerIterationClustering at SNAP com-Youtube's shape through S2,
    twice, against a float64 ``index_add_`` power iteration on the card
    with as many steps; returns S2's launches of the first run."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.clustering import PowerIterationClustering
    from cycloneml_tpu_torch.ops import kernels

    ctx = _context("chip_smoke_pic")
    try:
        (src, dst, comm), gen_s = _timed(_pic_graph)
        frame = MLFrame(ctx, {"src": src.astype(np.float64),
                              "dst": dst.astype(np.float64)})
        pic = PowerIterationClustering(k=2, maxIter=20, seed=5)
        kernels.reset_launch_counts()
        emb, emb_s = _timed(lambda: pic._embedding(
            frame, np.random.RandomState(5)))
        launches = kernels.ell_cols.launches
        others = _other_launches(kernels, "ell_cols")
        again = pic._embedding(frame, np.random.RandomState(5))
        out, assign_s = _timed(lambda: pic.assign_clusters(frame))
        # the float64 truth: the same graph, index_add_ on the card
        dev = ctx.device
        ids = np.unique(np.concatenate([src, dst]))
        s2 = np.searchsorted(ids, np.concatenate([src, dst]))
        d2 = np.searchsorted(ids, np.concatenate([dst, src]))
        n = len(ids)
        deg = np.bincount(s2, minlength=n).astype(np.float64)
        st = torch.as_tensor(s2, device=dev)
        dt = torch.as_tensor(d2, device=dev)
        wt = torch.as_tensor(1.0 / deg[s2], device=dev)

        def truth_after(steps):
            v = np.random.RandomState(5).rand(n) / n
            v = torch.as_tensor(v / np.abs(v).sum(), device=dev)
            for _ in range(steps):
                nv = torch.zeros(n, dtype=torch.float64,
                                 device=dev).index_add_(0, st, wt * v[dt])
                v = nv / torch.sum(torch.abs(nv))
            return v

        v = truth_after(emb.iterations)
        truth = v.cpu().numpy()
        # cyclone.compute.dtype=float64: every step through the center
        # sums (S2's values are float32), twice
        ctx.conf.set("cyclone.compute.dtype", "float64")
        kernels.reset_launch_counts()
        emb64, emb64_s = _timed(lambda: pic._embedding(
            frame, np.random.RandomState(5)))
        f64_sums = kernels.center_sums.launches
        f64_others = _other_launches(kernels, "center_sums")
        again64 = pic._embedding(frame, np.random.RandomState(5))
        ctx.conf.set("cyclone.compute.dtype", "float32")
        rel64 = _rel_err(emb64.values,
                         truth_after(emb64.iterations).cpu().numpy())
        rel = _rel_err(emb.values, truth)
        # S2 at this shape alone: the one-slot ELL, its column copy, a step
        idx = torch.as_tensor(s2.astype(np.int32), device=dev)[:, None] \
            .contiguous()
        val = wt.float()[:, None].contiguous()
        r = v.float()[dt].contiguous()
        columns, columns_s = _timed(lambda: kernels.ell_columns(idx, val, n))
        s2_ms = _time_ms(lambda: kernels.ell_cols(idx, val, r, n,
                                                  columns=columns), 20)
        s2_plain_ms = _time_ms(lambda: kernels.ell_cols_plain(idx, val, r, n),
                               5)
        s2_library_ms = _time_ms(lambda: torch.zeros(
            n, dtype=torch.float32, device=dev).index_add_(
                0, st, val[:, 0] * r), 20)
        s2_numbers = {"ms": s2_ms, "plain_ms": s2_plain_ms,
                      "library_index_add_ms": s2_library_ms,
                      "bound_ms": (idx.shape[0] * 12 + n * 4)
                      / H100_BYTES_PER_S * 1e3,
                      "column_copy_s": columns_s,
                      "pieces": int(columns.piece_col.shape[0])}
        labels = out["cluster"].astype(np.int64)
        agree = float(np.mean(labels == comm))
        purity = max(agree, 1.0 - agree)
        _line("pic", vertices=n, edges=PIC_EDGES, directed_edges=2 * PIC_EDGES,
              generate_s=gen_s, iterations=emb.iterations,
              s2_launches=launches, embedding_s=emb_s,
              ms_per_iteration=emb_s * 1000.0 / max(emb.iterations, 1),
              assign_clusters_s=assign_s, embedding_rel_err=rel,
              f64_center_sums={"iterations": emb64.iterations,
                               "center_sums_launches": f64_sums,
                               "embedding_s": emb64_s,
                               "embedding_rel_err": rel64},
              s2=s2_numbers,
              purity=purity, init="random")
        _check("pic", {
            "S2 launched once per iteration": launches == emb.iterations
                and emb.iterations >= 1,
            "no other kernel launched": others == 0,
            "two runs bitwise equal":
                emb.values.tobytes() == again.values.tobytes(),
            "embedding within 1e-5 (relative) of the float64 index_add_ "
            "power iteration": rel <= 1e-5,
            "every vertex labelled": len(labels) == n == PIC_VERTICES,
            "float64: every step through the center sums, none through S2":
                f64_sums == emb64.iterations >= 1 and f64_others == 0,
            "float64: two runs bitwise equal":
                emb64.values.tobytes() == again64.values.tobytes(),
            "float64: embedding within 1e-12 (relative) of the float64 "
            "index_add_ power iteration after as many steps": rel64 <= 1e-12,
        })
        return launches, s2_numbers
    finally:
        ctx.stop()


# -- model serving ------------------------------------------------------------

def _serve_host(servable, x):
    """float64 host margins of a servable or gang: (n, Km) or (K, n, Km)."""
    import numpy as np
    if hasattr(servable, "members"):
        return np.stack([m.host_margins(x) for m in servable.members])
    return servable.host_margins(x)


def _serve_sure(margins, raw_format):
    """Rows whose label float32 rounding cannot move: a binomial margin
    farther than 1e-6 of the margin scale from 0, or a multinomial top-two
    gap wider than that (the scale: max(1, max|margin|))."""
    import numpy as np
    tol = 1e-6 * max(1.0, float(np.abs(margins).max()))
    if raw_format == "pair":
        return np.abs(margins[:, 0]) > tol
    top = np.sort(margins, axis=1)
    return top[:, -1] - top[:, -2] > tol


def _serve_bound(k, km, d, b, itemsize, quantized):
    """(bound ms, bound_by) of one margins call: the parameters, the
    bucket's rows and the margins once at 3.35 TB/s, against 2 K Km B d
    operations at the dtype's peak outside the tensor cores."""
    coef = k * km * d * (1 if quantized else itemsize)
    vecs = k * km * itemsize * (2 if quantized else 1)
    n_bytes = coef + vecs + b * d * itemsize + k * b * km * itemsize
    peak = H100_F32_FLOPS if itemsize == 4 else H100_F64_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, 2.0 * k * km * b * d / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _serve_slowest(spans, t_start, pauses, n=SERVE_SLOWEST):
    """The ``n`` slowest requests of a traced traffic run, each split by
    its spans: the wait in the queue (the window, and the lane's worker
    busy or not running) and the dispatch; when it arrived; its lane's
    dispatches that ran while it waited (their count and summed time) and
    the longest gap between them in that wait, in which the worker ran no
    dispatch; its own dispatch's place in its lane; and the time the
    interpreter's garbage collector held the process in its lifetime
    (``pauses``: (generation, t0, t1) of each collection)."""
    reqs = [s for s in spans if s.kind == "serving" and s.name == "request"]
    by_id = {s.span_id: s for s in spans}
    runs = {}
    for s in spans:
        if s.kind == "serving" and s.name != "request":
            runs.setdefault(s.name, []).append(s)
    for lane_runs in runs.values():
        lane_runs.sort(key=lambda s: s.t0)
    out = []
    for r in sorted(reqs, key=lambda s: s.duration_s, reverse=True)[:n]:
        lane_runs = runs.get(r.attrs["model"], [])
        t_batch = r.t0 + r.attrs["queue_s"]
        during = [s for s in lane_runs if s.t1 > r.t0 and s.t0 < t_batch]
        edges = [r.t0] + [t for s in during for t in (s.t0, s.t1)] + [t_batch]
        gaps = [max(edges[i + 1] - edges[i], 0.0)
                for i in range(0, len(edges) - 1, 2)]
        parent = by_id.get(r.parent_id)
        out.append({
            "lane": r.attrs["model"], "rows": r.attrs["rows"],
            "bucket": r.attrs["bucket"], "latency_ms": r.duration_s * 1e3,
            "queue_ms": r.attrs["queue_s"] * 1e3,
            "dispatch_ms": r.attrs["dispatch_s"] * 1e3,
            "arrived_s": r.t0 - t_start,
            "lane_dispatches_while_queued": len(during),
            "their_ms": sum(s.duration_s for s in during) * 1e3,
            "longest_idle_gap_ms": max(gaps) * 1e3,
            "dispatch_index": (lane_runs.index(parent)
                               if parent in lane_runs else None),
            "dispatch_requests": (parent.attrs.get("n_requests")
                                  if parent else None),
            "gc_ms": sum(max(min(t1, r.t1) - max(t0, r.t0), 0.0)
                         for _, t0, t1 in pauses) * 1e3,
            "gc_generations": sorted({g for g, t0, t1 in pauses
                                      if t1 > r.t0 and t0 < r.t1})})
    return out


def _serve_times(lane, b, rows, reps=200):
    """Per-call times at bucket ``b`` (rows: (b, d) host rows in the
    serving dtype) of the lane's graph replay and of the same three steps
    launched eagerly (CUDA events on the lane's stream, and the host wall
    time of a whole dispatch: write, launch, wait, read), of the kernel
    alone, its plain twin, the library call (torch.addmm of the
    intercepts, the rows and the coefficients, dequantized beforehand for
    e4m3) and the yardstick torch.matmul; at buckets 1 and 64 the kernel's
    device time (a graph of back-to-back launches, by events), and at 64
    the rows whose addmm bits differ between buckets 1 and 64."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    bg = lane._table[b]
    s = bg.stream
    coef, icpt, scale = lane._params
    dt = bg.x_dev.dtype
    flat = coef.to(dt) if scale is None else coef.to(dt) * scale[..., None]
    flat = flat.reshape(-1, coef.shape[-1])
    icpt_flat = icpt.reshape(-1)
    bg([rows])   # the bucket's device rows are these rows from here on

    def events(fn, n=reps):
        with torch.cuda.stream(s):
            for _ in range(3):
                fn()
            s.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(s)
            for _ in range(n):
                fn()
            e1.record(s)
        s.synchronize()
        return e0.elapsed_time(e1) / n

    def wall(fn, n=reps):
        for _ in range(3):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    def eager():
        bg.x_dev.copy_(bg.x_pin, non_blocking=True)
        lane.launch(bg.x_dev, bg.out_dev)
        bg.out_pin.copy_(bg.out_dev, non_blocking=True)

    def eager_dispatch():
        bg.x[:] = rows
        with torch.cuda.stream(s):
            eager()
        s.synchronize()
        return bg.out.copy()

    out = {"graph_ms": events(bg.graph.replay),
           "eager_ms": events(eager),
           "graph_wall_ms": wall(lambda: bg([rows])),
           "eager_wall_ms": wall(eager_dispatch),
           "kernel_ms": events(lambda: lane.launch(bg.x_dev, bg.out_dev)),
           "plain_ms": events(lambda: kernels.serving_margins_plain(
               bg.x_dev, coef, icpt, scale), n=20),
           "library_ms": events(lambda: torch.addmm(icpt_flat, bg.x_dev,
                                                    flat.T)),
           "matmul_ms": events(lambda: torch.matmul(bg.x_dev, flat.T))}
    if b in (1, SERVE_BATCH):
        # the kernel's device time: the events above time back-to-back
        # calls, which the host's launch path paces, so here a graph of
        # SERVE_GRAPH_LAUNCHES launches replays (torch.profiler records no
        # kernel this late in the run, PERF.md section 7)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s):
            g.capture_begin(capture_error_mode="thread_local")
            for _ in range(SERVE_GRAPH_LAUNCHES):
                lane.launch(bg.x_dev, bg.out_dev)
            g.capture_end()
        out["kernel_device_ms"] = events(g.replay, n=20) \
            / SERVE_GRAPH_LAUNCHES
    if b == SERVE_BATCH:
        with torch.cuda.stream(s):
            full = torch.addmm(icpt_flat, bg.x_dev, flat.T)
            singles = torch.cat([torch.addmm(icpt_flat, bg.x_dev[r:r + 1],
                                             flat.T) for r in range(b)])
        s.synchronize()
        out["addmm_rows_differing_1_vs_64"] = int(
            (full != singles).any(dim=1).sum())
    k, km, d = lane.shape
    out["bound_ms"], out["bound_by"] = _serve_bound(
        k, km, d, b, bg.x_dev.element_size(), scale is not None)
    return out


def phase_serving(ovr_models, mn_model, lin_model, cifar_models):
    """Model serving on the card (``ModelServer``, maxBatch 64, windowMs 5):
    serial lanes for phase 16's class-0 model, phase 21's multinomial
    model and phase 6's LinearRegression; gangs of phase 16's 8 models,
    plain and e4m3, and of phase 32's 10 CIFAR-10 models; one float64
    lane. 8 clients send 250 requests each of 1-64 seeded rows, and one
    request of 300 rows splits into 64-row sub-requests. Checks: 7 graphs
    captured a lane at registration and none after the traffic, device
    memory flat over it, labels against each model's own predict (rows
    within 1e-6 of a decision boundary counted apart), regression within
    1e-6, bucket and gang bits, the kernel against its plain twin bit for
    bit, the e4m3 envelope, a retried transient fault, a permanent 5xx,
    and shedding under a tiny budget. Returns the kernels line's numbers
    for ``serving_margins``."""
    import gc
    import threading
    import numpy as np
    import torch
    from cycloneml_tpu_torch import CycloneConf
    from cycloneml_tpu_torch.ops import kernels
    from cycloneml_tpu_torch.parallel.faults import (
        FaultInjector, FaultSchedule, TransientCollectiveError)
    from cycloneml_tpu_torch.observe import tracing
    from cycloneml_tpu_torch.serving import (
        ModelServer, ServingError, ServingOverloaded, bucket_sizes)
    from cycloneml_tpu_torch.serving.batcher import serving_params
    from cycloneml_tpu_torch.util.metrics import MetricsRegistry

    conf = CycloneConf().set("cyclone.master", DEVICE)
    registry = MetricsRegistry()

    def server(**kw):
        return ModelServer(ctx=None, conf=kw.pop("conf", conf),
                           max_batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS,
                           registry=registry, **kw)

    f32, q8, f64 = server(), server(quantize=True), server(dtype="float64")
    probe, probe_q = server(), server(quantize=True)
    servers = [f32, q8, f64, probe, probe_q]
    try:
        t0 = time.perf_counter()
        f32.register("ovr0", ovr_models[0])
        f32.register("multinomial", mn_model)
        f32.register("linreg", lin_model)
        f32.register_gang("ovr8", ovr_models)
        q8.register_gang("ovr8_e4m3", ovr_models)
        f32.register_gang("cifar10", cifar_models)
        f64.register("ovr0_f64", ovr_models[0])
        register_s = time.perf_counter() - t0
        lanes = {n: srv._lane(n) for srv in (f32, q8, f64)
                 for n in srv.models}
        server_of = {n: srv for srv in (f32, q8, f64) for n in srv.models}
        # the serial twins of every gang member, for the gang = serial bits
        t0 = time.perf_counter()
        for i, m in enumerate(ovr_models):
            probe.register(f"ovr{i}", m)
            probe_q.register(f"ovr{i}_e4m3", m)
        for i, m in enumerate(cifar_models):
            probe.register(f"cifar{i}", m)
        probe_s = time.perf_counter() - t0
        n_buckets = len(bucket_sizes(SERVE_BATCH))
        counts = {(id(srv), n): c for srv in servers
                  for n, c in srv.compile_counts().items()}

        # traffic: lane choices, sizes and row offsets drawn up front from
        # one seed, rows from a seeded pool a width
        g = np.random.default_rng(SERVE_SEED)
        names = sorted(lanes)
        pools = {d: g.standard_normal((SERVE_POOL, d), dtype=np.float32)
                 for d in sorted({lane.shape[2] for lane in lanes.values()})}
        plan = []
        for _ in range(SERVE_CLIENTS):
            picks = g.integers(0, len(names), SERVE_REQUESTS)
            sizes = g.integers(1, SERVE_BATCH + 1, SERVE_REQUESTS)
            offs = g.integers(0, SERVE_POOL - SERVE_BATCH, SERVE_REQUESTS)
            plan.append([(names[p], int(o), int(n))
                         for p, o, n in zip(picks, offs, sizes)])
        results = [[] for _ in range(SERVE_CLIENTS)]
        errors = []

        def client(i):
            for name, off, n in plan[i]:
                x = pools[lanes[name].shape[2]][off:off + n]
                try:
                    results[i].append((name, off, n,
                                       server_of[name].predict(name, x)))
                except Exception as e:   # surfaced by the checks
                    errors.append(repr(e))

        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        # the span tracer over the traffic (a serving span a dispatch and
        # a request span a request) and the garbage collector's pauses,
        # for the slowest requests' split
        pauses, gc_start = [], {}

        def on_gc(phase, info):
            if phase == "start":
                gc_start[info["generation"]] = time.perf_counter()
            else:
                pauses.append((info["generation"],
                               gc_start.pop(info["generation"], 0.0),
                               time.perf_counter()))

        tracer = tracing.enable()
        gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        try:
            for t in threads:
                t.start()
            big = f32.predict("ovr8", pools[FIT_D][:SERVE_BIG])
            for t in threads:
                t.join(timeout=600)
        finally:
            gc.callbacks.remove(on_gc)
            tracing.disable()
        traffic_s = time.perf_counter() - t0
        spans = tracer.snapshot()
        slowest = _serve_slowest(spans, t0, pauses)
        # request latency over every request of the traffic, from its
        # spans (the registry's timer keeps only its last 1,024 samples)
        lat_s = np.array([sp.duration_s for sp in spans
                          if sp.kind == "serving" and sp.name == "request"])
        gc_pauses = {g: [sum(1 for p in pauses if p[0] == g),
                         sum(p[2] - p[1] for p in pauses if p[0] == g) * 1e3]
                     for g in (0, 1, 2)}
        launches = kernels.serving_margins.launches
        by_instance = dict(kernels.serving_margins.launches_by_instance)
        others = _other_launches(kernels, "serving_margins")
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        counts_after = {(id(srv), n): c for srv in servers
                        for n, c in srv.compile_counts().items()}
        stats = {n: server_of[n].stats()["models"][n] for n in names}
        batches = sum(st["batches"] for st in stats.values())

        # every served answer against the model's own predict
        done = [r for rs in results for r in rs]
        wrong = {n: 0 for n in names}
        near = {n: 0 for n in names}
        lin_err = 0.0
        for name, off, n, got in done + [("ovr8", 0, SERVE_BIG, big)]:
            lane = lanes[name]
            x = pools[lane.shape[2]][off:off + n].astype(np.float64)
            sv = lane.servable
            if name == "linreg":
                host = sv.host_margins(x)[:, 0]
                lin_err = max(lin_err, float(np.abs(got - host).max())
                              / max(1.0, float(np.abs(host).max())))
                continue
            members = sv.members if hasattr(sv, "members") else [sv]
            outs = got if isinstance(got, list) else [got]
            for k, (m, out) in enumerate(zip(members, outs)):
                if name == "ovr8_e4m3":   # the dequantized model's margins
                    codes, icpt, scale = (t[k].double().cpu().numpy()
                                          for t in lanes[name]._params)
                    host = x @ (codes * scale[:, None]).T + icpt
                    want = m.model._raw_to_prediction(m.margins_to_raw(host))
                else:
                    host = m.host_margins(x)
                    want = m.model._predict_batch(x)
                sure = _serve_sure(host, m.raw_format)
                near[name] += int((~sure).sum())
                wrong[name] += int((out[sure] != want[sure]).sum())

        # bits: buckets 1, 64 and 3-of-64; gangs against serial lanes
        x64 = {d: p[:SERVE_BATCH] for d, p in pools.items()}
        bucket_bits = {}
        for name, lane in lanes.items():
            x = x64[lane.shape[2]]
            m1 = lane.bucket_margins(x[:1], 1)
            mb = lane.bucket_margins(x, SERVE_BATCH)
            mp = lane.bucket_margins(x[:3], SERVE_BATCH)
            if not lane.is_gang:
                m1, mb, mp = m1[None], mb[None], mp[None]
            bucket_bits[name] = bool(np.array_equal(m1[:, 0], mb[:, 0])
                                     and np.array_equal(mp[:, :3], mb[:, :3]))
        gang_bits = {}
        for gang, twin, srv, k in (("ovr8", "ovr{}", probe, len(ovr_models)),
                                   ("ovr8_e4m3", "ovr{}_e4m3", probe_q,
                                    len(ovr_models)),
                                   ("cifar10", "cifar{}", probe,
                                    len(cifar_models))):
            lane = lanes[gang]
            xg = x64[lane.shape[2]]
            gm = lane.bucket_margins(xg, SERVE_BATCH)
            gang_bits[gang] = all(
                np.array_equal(gm[i], srv._lane(twin.format(i))
                               .bucket_margins(xg, SERVE_BATCH))
                for i in range(k))
        qm = lanes["ovr8_e4m3"].bucket_margins(x64[FIT_D], SERVE_BATCH)
        qh = _serve_host(lanes["ovr8_e4m3"].servable,
                         x64[FIT_D].astype(np.float64))
        quant_env = max(float(np.abs(qm[i] - qh[i]).max())
                        / float(np.abs(qh[i]).max()) for i in range(len(qh)))

        # the kernel against its plain twin on every lane's shape at every
        # bucket, f32 and f64, plain and e4m3: the lane's own parameters
        # in its own form, the others built from its servable
        dev = torch.device(DEVICE)
        n_twin, twin_checks, twin_err = 0, 0, 0.0
        for name, lane in lanes.items():
            own = (server_of[name].torch_dtype, server_of[name].quantize)
            d = lane.shape[2]
            for dt in (torch.float32, torch.float64):
                for quant in (False, True):
                    c, ic, sc = (lane._params if (dt, quant) == own else
                                 serving_params(lane.servable, lane.shape,
                                                dt, quant, dev))
                    for b in bucket_sizes(SERVE_BATCH):
                        x = torch.from_numpy(pools[d][:b]).to(dev, dt)
                        got = kernels.serving_margins(x, c, ic, sc)
                        want = kernels.serving_margins_plain(x, c, ic, sc)
                        n_twin += 1
                        twin_checks += int(torch.equal(got, want))
                        twin_err = max(twin_err, float(
                            (got - want).abs().max()))

        # the tiled design's large buckets: the CIFAR-10 gang against its
        # twin bit for bit, with the tile each bucket takes
        cif = lanes["cifar10"]
        large = {}
        for b in SERVE_TWIN_BUCKETS:
            x = torch.from_numpy(pools[CIFAR_D][:b]).to(dev)
            c, ic, sc = cif._params
            got = kernels.serving_margins(x, c, ic, sc)
            want = kernels.serving_margins_plain(x, c, ic, sc)
            large[b] = {"equal": bool(torch.equal(got, want)),
                        "max_abs_err": float((got - want).abs().max()),
                        "plan": kernels.serving_margins_plan(
                            x.dtype, sc is not None, b, len(cifar_models),
                            CIFAR_D)}
            twin_err = max(twin_err, large[b]["max_abs_err"])
        _line("serving_large_buckets", lane="cifar10", buckets=large)

        # chaos: a transient fault retried, a permanent one a 5xx
        xf = pools[FIT_D][:5]
        want0 = ovr_models[0]._predict_batch(xf.astype(np.float64))
        sched = FaultSchedule(seed=0)
        sched.at("serving.dispatch", 1, TransientCollectiveError("injected"))
        with FaultInjector(sched) as inj:
            retried = f32.predict("ovr0", xf, timeout=30)
        transient_ok = (np.array_equal(retried, want0) and inj.log == [
            ("serving.dispatch", 1, "TransientCollectiveError")])
        sched = FaultSchedule(seed=0)
        sched.at("serving.dispatch", 1, TypeError("injected permanent"))
        status = None
        with FaultInjector(sched):
            try:
                f32.predict("ovr0", xf, timeout=30)
            except ServingError as e:
                status = e.status
            served_on = f32.predict("ovr0", xf, timeout=30)
        permanent_ok = (status is not None and 500 <= status < 600
                        and np.array_equal(served_on, want0))
        # admission: a budget of nothing queues, then sheds with a 503
        tiny = server(conf=CycloneConf().set("cyclone.master", DEVICE)
                      .set("cyclone.memory.budgetFraction", 0.5)
                      .set("cyclone.memory.deviceBytes", 1),
                      shed_after_ms=80)
        servers.append(tiny)
        tiny.register("ovr0", ovr_models[0])
        shed_status = None
        try:
            tiny.predict("ovr0", xf, timeout=30)
        except ServingOverloaded as e:
            shed_status = e.status
        tiny_st = tiny.stats()["models"]["ovr0"]

        # numbers by bucket
        timed = ("ovr0", "ovr8", "ovr8_e4m3", "cifar10", "ovr0_f64")
        times = {}
        for name in timed:
            lane = lanes[name]
            pool = pools[lane.shape[2]]
            times[name] = {b: _serve_times(lane, b, pool[:b].astype(
                server_of[name].dtype)) for b in bucket_sizes(SERVE_BATCH)}
        total_rows = sum(st["rows"] for st in stats.values())
        _line("serving", lanes={n: {"instance": lanes[n].instance,
                                    "shape": list(lanes[n].shape),
                                    **{k: stats[n][k] for k in (
                                        "compiles", "requests", "rows",
                                        "batches", "coalesced")}}
                                for n in names},
              register_s=register_s, probe_register_s=probe_s,
              traffic_s=traffic_s, requests=len(done) + 1,
              rows=total_rows, rows_per_s=total_rows / traffic_s,
              batches=batches,
              coalesced=sum(st["coalesced"] for st in stats.values()),
              latency_ms={"mean": float(lat_s.mean()) * 1e3,
                          **{f"p{q}": float(np.percentile(lat_s, q)) * 1e3
                             for q in (50, 95, 99)},
                          "max": float(lat_s.max()) * 1e3},
              latency_count=len(lat_s), launches=launches,
              launches_by_instance=by_instance,
              memory_allocated=[mem_before, mem_after],
              wrong_labels=wrong, near_boundary_rows=near,
              linreg_max_err_rel=lin_err, quantized_envelope=quant_env,
              kernel_vs_twin={"checks": n_twin, "equal": twin_checks,
                              "max_abs_err": twin_err},
              bucket_bits=bucket_bits, gang_bits=gang_bits,
              errors=errors[:5], shed=tiny_st,
              gc_count_ms_by_generation=gc_pauses)
        for row in slowest:
            _line("serving_slowest", **row)
        for name in timed:
            for b, t in times[name].items():
                _line("serving_time", lane=name,
                      instance=lanes[name].instance, bucket=b, **t)
        _check("serving", {
            "every request answered": not errors
                and len(done) == SERVE_CLIENTS * SERVE_REQUESTS,
            f"{n_buckets} graphs captured a lane at registration":
                set(counts.values()) == {n_buckets},
            "no graph captured by the traffic": counts_after == counts,
            "device memory allocated equal before and after the traffic":
                mem_after == mem_before,
            "one launch a dispatch (graph replays), one instance a lane, no "
            "other kernel": launches == batches and others == 0
                and by_instance["f32"] == sum(
                    stats[n]["batches"] for n in names
                    if lanes[n].instance == "f32")
                and by_instance["f32_e4m3"] == stats["ovr8_e4m3"]["batches"]
                and by_instance["f64"] == stats["ovr0_f64"]["batches"],
            "a request span for every request served":
                len(lat_s) == sum(st["requests"] for st in stats.values()),
            "the 300-row request split into 64-row sub-requests":
                stats["ovr8"]["requests"] >= 5 and len(big) == OVR_K
                and all(len(p) == SERVE_BIG for p in big),
            "served labels are the models' own away from the boundary":
                not any(wrong.values()),
            "regression within 1e-6 of the float64 host margins":
                lin_err <= 1e-6,
            "a row's margins have equal bits in buckets 1, 64 and 3-of-64":
                all(bucket_bits.values()),
            "gang margins equal each serial lane's bits":
                all(gang_bits.values()),
            "the kernel equals its plain twin bit for bit on every lane's "
            "shape at every bucket, f32 and f64, plain and e4m3":
                n_twin == len(lanes) * 4 * n_buckets
                and twin_checks == n_twin,
            "the kernel equals its twin bit for bit on the CIFAR-10 gang "
            "at buckets 128-1,024": all(v["equal"] for v in large.values()),
            "e4m3 margins within 0.06 of the margin scale":
                quant_env < SERVE_QUANT_ENVELOPE,
            "a transient fault is retried to the right answer": transient_ok,
            "a permanent fault gives a 5xx and the lane serves on":
                permanent_ok,
            "a tiny budget queues, then sheds with 503":
                shed_status == 503 and tiny_st["requeues"] >= 1
                and tiny_st["batches"] == 0,
        })
        head = times["ovr8"][SERVE_BATCH]
        return {"launches": launches, "launches_by_instance": by_instance,
                "max_abs_err": twin_err, "ms": head["kernel_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "yardstick_ms": head["matmul_ms"],
                "graph_ms": head["graph_ms"], "eager_ms": head["eager_ms"],
                "device_ms": head["kernel_device_ms"],
                "instances": {n: lanes[n].instance for n in names},
                "times": times,
                "plans": {n: {b: kernels.serving_margins_plan(
                    server_of[n].torch_dtype, server_of[n].quantize, b,
                    lanes[n].shape[0] * lanes[n].shape[1], lanes[n].shape[2])
                    for b in bucket_sizes(SERVE_BATCH)} for n in timed},
                "large_buckets": large}
    finally:
        for srv in servers:
            srv.stop()


def phase_holes():
    """Phase 51: the names the port had lacked in files counted as ported,
    on the card (see the module docstring); returns its numbers."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset import random as drandom
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.aggregators import matmul_precision
    from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction
    from cycloneml_tpu_torch.observe import tracing

    ctx = _context("chip_smoke_holes")
    try:
        dev = ctx.device
        f32 = torch.float32
        # a held-out frame from phase 4's training distribution: its beta
        # (the seed's beta stream), rows from a stream no fit drew
        model = _MAIN_MODEL["lr"]
        beta = torch.randn(FIT_D, generator=drandom._generator(
            dev, 0, drandom._BETA_STREAM), device=dev, dtype=f32)
        g = drandom._generator(dev, 0, HOLD_STREAM)
        xh = torch.randn((HOLD_N, FIT_D), generator=g, device=dev, dtype=f32)
        eps = torch.randn(HOLD_N, generator=g, device=dev, dtype=f32)
        yh = ((xh @ beta + eps) > 0).double()
        x_np, y_np = xh.cpu().numpy(), yh.cpu().numpy()
        frame = MLFrame(ctx, {"features": x_np, "label": y_np})
        summary, eval_s = _timed(lambda: model.evaluate(frame))
        # the same area by a float64 trapezoid of its own
        score = 1.0 / (1.0 + np.exp(-(x_np.astype(np.float64)
                                       @ model.coefficients.values
                                       + model.intercept)))
        order = np.argsort(-score, kind="stable")
        last = np.append(score[order][1:] != score[order][:-1], True)
        tps = np.cumsum(y_np[order])[last]
        fps = np.cumsum(1.0 - y_np[order])[last]
        tpr = np.concatenate([[0.0], tps / tps[-1], [1.0]])
        fpr = np.concatenate([[0.0], fps / fps[-1], [1.0]])
        auc = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))
        auc_err = abs(summary.area_under_roc - auc)
        del xh, x_np, frame

        # placement: host copies, release, back on the card bitwise (the
        # earlier phases' garbage collected first, so that no collection
        # inside the window frees their tensors and moves the levels)
        ds = drandom.generate_classification(ctx, HOLD_N, FIT_D, seed=21)
        keep = [t.clone() for t in (ds.x, ds.y, ds.w)]
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        ds.persist_host()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        ds.persist()
        back = all(torch.equal(t, k) for t, k in zip((ds.x, ds.y, ds.w),
                                                     keep))
        after = torch.cuda.memory_allocated()
        # persist() registered it with the storage tiers, whose restore
        # dropped the host copy: release_device needs one again
        ds.persist_host()
        ds.release_device()
        released = torch.cuda.memory_allocated()
        ds.cache()
        back_again = all(torch.equal(t, k) for t, k in zip(
            (ds.x, ds.y, ds.w), keep)) and ds.x.device.type == "cuda"
        again = torch.cuda.memory_allocated()

        # broadcast, parallelize, tree_aggregate and an accumulator in a job
        bc = ctx.broadcast({"coef": model.coefficients.values})
        on_card = bc.device_value["coef"]
        bc_ok = (on_card.device.type == "cuda" and bc.device_value is not None
                 and np.array_equal(on_card.cpu().numpy(),
                                    model.coefficients.values))
        bc.unpersist()
        acc = ctx.accumulator(0.0, "rows")
        tracer = tracing.enable()
        try:
            def job():
                rows = ctx.parallelize(range(1, 100_001), 8)
                rows.foreach(lambda v: acc.add(1))
                return rows.tree_aggregate(0, lambda a, v: a + v,
                                           lambda a, b: a + b, depth=3)
            total, job_s = _timed(lambda: ctx.run_job("tree_aggregate", job))
        finally:
            tracing.disable()
        reg = ctx.metrics_registry
        job_spans = [sp.name for sp in tracer.snapshot() if sp.kind == "job"]

        # matmulPrecision: a 'highest' fit leaves TF32 off; a loss
        # function's own aggregations see the flag its precision sets
        # (off for 'highest' over a caller's leftover True, on for
        # 'default'), and the caller's value is back after each
        small = drandom.generate_classification(ctx, 20_000, 64, seed=5)
        LogisticRegression(maxIter=5).fit(small)
        tf32_highest = torch.backends.cuda.matmul.allow_tf32
        binary = aggregators.binary_logistic(64, True)
        tf32_scoped = {}
        for name, leftover in (("highest", True), ("default", False)):
            ctx.conf.set("cyclone.compute.matmulPrecision", name)
            seen = []

            def spy(x, y, w, coef, seen=seen):
                seen.append(torch.backends.cuda.matmul.allow_tf32)
                return binary(x, y, w, coef)

            torch.backends.cuda.matmul.allow_tf32 = leftover
            loss = DistributedLossFunction(small, spy)
            loss.f_and_g(torch.zeros(65, device=dev, dtype=loss.cdt))
            tf32_scoped[name] = (matmul_precision(), sorted(set(seen)),
                                 torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
        ctx.conf.set("cyclone.compute.matmulPrecision", "highest")
        out = {"held_out_rows": HOLD_N, "evaluate_s": eval_s,
               "area_under_roc": summary.area_under_roc,
               "numpy_area": auc, "area_abs_err": auc_err,
               "accuracy": summary.accuracy,
               "padded_bytes": ds.padded_bytes(), "freed_bytes": freed,
               "memory_allocated": [before, after, released, again],
               "job_total": total, "job_s": job_s,
               "accumulator": acc.value, "job_spans": job_spans,
               "tf32_after_highest_fit": tf32_highest,
               "tf32_scoped": tf32_scoped}
        _line("holes", **out)
        _check("holes", {
            "evaluate's area under ROC equals the float64 trapezoid within "
            "1e-12": auc_err <= 1e-12,
            "the held-out area is above 0.8": summary.area_under_roc > 0.8,
            "persist_host frees the padded bytes (each of X, y and w "
            "rounded up to the allocator's 512-byte blocks)":
                0 <= freed - ds.padded_bytes() < 3 * 512,
            "persist brings X, y and w back bitwise": back,
            "memory_allocated returns to its level": after == before
                and again == before,
            "release_device frees them again": released == before - freed,
            "cache brings them back bitwise on the card": back_again,
            "the broadcast's device value lives on the card": bc_ok,
            "tree_aggregate and the accumulator inside run_job":
                total == 5_000_050_000 and acc.value == 100_000,
            "run_job counted and traced": reg.counter(
                "jobs.succeeded").count == 1 and job_spans == [
                    "tree_aggregate"],
            "matmulPrecision 'highest' leaves TF32 off after a fit":
                tf32_highest is False,
            "a loss function's aggregations run with TF32 off under "
            "'highest' and on under 'default', the caller's flag back "
            "after": tf32_scoped == {"highest": ("highest", [False], True),
                                     "default": ("default", [True], False)},
        })
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        ctx.stop()


def _checkpoint_seconds(spans):
    """Seconds in the ``checkpoint`` spans of a run, by name (``commit``
    is inside ``save``)."""
    out = {"save": 0.0, "commit": 0.0, "restore": 0.0}
    for sp in spans:
        if sp.kind == "checkpoint":
            out[sp.name] += sp.duration_s
    return out


def _step_bytes(directory, step) -> dict:
    """The bytes of a committed step's two files."""
    sdir = os.path.join(directory, f"step_{step:012d}")
    return {f: os.path.getsize(os.path.join(sdir, f))
            for f in ("state.pkl", "METADATA.json")}


def _no_leftovers(directory) -> bool:
    return not [n for n in os.listdir(directory) if ".tmp" in n]


def phase_checkpoint_lr(tmp):
    """Phase 52: checkpointed LogisticRegression at the main path's shape
    (phase 4's data, ``maxIter=25, regParam=0.01, tol=0``,
    ``checkpointInterval=2``; host L-BFGS, K1 once per evaluation): an
    uninterrupted checkpointed fit; a fit crashed by ``MidSaveCrash`` at
    the second ``checkpoint.commit`` (step 2 committed, no partial step
    visible); its resume from step 2, bitwise equal to the uninterrupted
    fit; the newest ``state.pkl`` truncated, a resume from the step before
    (bitwise again), every step damaged raising ``CheckpointCorrupt``; a
    directory of another dataset raising on its fingerprint. Returns the
    K1 launches of the three fits."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.observe import tracing
    from cycloneml_tpu_torch.ops import kernels
    from cycloneml_tpu_torch.parallel.faults import (FaultInjector,
                                                     FaultSchedule,
                                                     MidSaveCrash)
    from cycloneml_tpu_torch.util.checkpoint import (CheckpointCorrupt,
                                                     TrainingCheckpointer)

    ctx = _context("chip_smoke_checkpoint_lr")
    tracer = tracing.enable()
    try:
        ds = generate_classification(ctx, FIT_N, FIT_D, seed=0)

        def fit(directory, data=ds):
            return LogisticRegression(
                maxIter=25, regParam=0.01, tol=0.0, checkpointDir=directory,
                checkpointInterval=CK_LR_INTERVAL).fit(data)

        def run(tag, directory, **kw):
            """One fit with its counts zeroed just before and read just
            after: (model or the exception, seconds, K1 launches, other
            launches, checkpoint seconds)."""
            n0 = len(tracer.snapshot())
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fit(directory, **kw)
            except Exception as e:   # the crash, or the refusals below
                out = e
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
            return (out, secs, k1, _other_launches(kernels, "logistic"),
                    _checkpoint_seconds(tracer.snapshot()[n0:]))

        full_dir = os.path.join(tmp, "lr_full")
        crash_dir = os.path.join(tmp, "lr_crash")
        full, full_s, full_k1, full_other, full_ck = run("full", full_dir)
        sched = FaultSchedule().at("checkpoint.commit", 2,
                                   MidSaveCrash("power cut mid-save"))
        with FaultInjector(sched) as inj:
            crashed, crash_s, crash_k1, _, crash_ck = run("crash", crash_dir)
        crash_steps = TrainingCheckpointer(crash_dir).steps()
        crash_clean = _no_leftovers(crash_dir)
        save_bytes = _step_bytes(crash_dir, crash_steps[0])
        resumed, resume_s, resume_k1, resume_other, resume_ck = run(
            "resume", crash_dir)

        def same(a, b):
            return (np.array_equal(a.coefficients.values,
                                   b.coefficients.values)
                    and a.intercept == b.intercept
                    and a.summary.total_iterations ==
                    b.summary.total_iterations
                    and a.summary.objective_history ==
                    b.summary.objective_history)

        # the newest step damaged after its commit: a resume falls back
        ck = TrainingCheckpointer(full_dir)
        steps = ck.steps()
        newest = steps[-1]
        pkl = os.path.join(full_dir, f"step_{newest:012d}", "state.pkl")
        with open(pkl, "r+b") as fh:
            fh.truncate(os.path.getsize(pkl) // 2)
        fallback = ck.latest_verifiable_step()
        back, back_s, back_k1, _, back_ck = run("fallback", full_dir)
        for s_ in ck.steps():
            with open(os.path.join(full_dir, f"step_{s_:012d}",
                                   "state.pkl"), "wb") as fh:
                fh.write(b"damaged")
        corrupt, _, corrupt_k1, _, _ = run("corrupt", full_dir)
        # a directory of another dataset: refused on its fingerprint
        other = generate_classification(ctx, CK_FOREIGN_N, FIT_D, seed=7)
        foreign, _, foreign_k1, _, _ = run("foreign", crash_dir, data=other)
        del other
        _line("checkpoint_lr", n=FIT_N, d=FIT_D,
              data_dtype=str(ds.x.dtype)[6:], interval=CK_LR_INTERVAL,
              full={"iterations": full.summary.total_iterations,
                    "evals": full.summary.total_evals, "k1_launches":
                    full_k1, "fit_s": full_s, "checkpoint_s": full_ck,
                    "steps_kept": steps},
              crashed={"error": type(crashed).__name__,
                       "faults": inj.log, "k1_launches": crash_k1,
                       "fit_s": crash_s, "checkpoint_s": crash_ck,
                       "steps": crash_steps},
              resumed={"iterations": resumed.summary.total_iterations,
                       "evals": resumed.summary.total_evals,
                       "k1_launches": resume_k1, "fit_s": resume_s,
                       "checkpoint_s": resume_ck},
              fallback={"damaged": newest, "from": fallback,
                        "k1_launches": back_k1, "fit_s": back_s,
                        "checkpoint_s": back_ck},
              save_bytes=save_bytes,
              saves_in_full_fit=full.summary.total_iterations
              // CK_LR_INTERVAL + 1,
              all_damaged=type(corrupt).__name__,
              foreign=str(foreign)[:120])
        _check("checkpoint lr", {
            "K1 launched once per evaluation in the uninterrupted fit":
                full_k1 == full.summary.total_evals and full_other == 0,
            "the crash at the second commit raised MidSaveCrash":
                isinstance(crashed, MidSaveCrash)
                and inj.log == [("checkpoint.commit", 2, "MidSaveCrash")],
            "the crashed directory holds step 2 and no partial step":
                crash_steps == [CK_LR_INTERVAL] and crash_clean,
            "the resumed fit launched K1 once per evaluation":
                resume_k1 == resumed.summary.total_evals
                and resume_other == 0,
            "the resumed fit is bitwise the uninterrupted checkpointed fit "
            "(coefficients, intercept, iterations, objective history)":
                same(resumed, full),
            "a damaged newest step: the resume falls back to the one "
            "before": fallback == steps[-2],
            "... and lands bitwise on the uninterrupted fit":
                not isinstance(back, Exception) and same(back, full),
            "every step damaged raises CheckpointCorrupt":
                isinstance(corrupt, CheckpointCorrupt) and corrupt_k1 == 0,
            "a directory of another dataset raises on its fingerprint":
                isinstance(foreign, ValueError)
                and "DIFFERENT training run" in str(foreign)
                and foreign_k1 == 0,
            "finite model": bool(np.all(np.isfinite(
                full.coefficients.values))),
        })
        return {"full": full_k1, "resumed": resume_k1,
                "fallback": back_k1}
    finally:
        tracing.disable()
        ctx.stop()


def phase_checkpoint_als(data, tmp):
    """Phase 53: checkpointed ALS at configuration 4 (phase 35's
    ``ALS(rank=64, regParam=0.02, seed=2, maxIter=12)`` on the same
    training ratings, ``checkpointInterval=4``): a crash at the second
    commit (iteration 8; step 4 committed), then the resume from iteration
    4, whose factor matrices are bitwise phase 35's model's, with
    ``als_normal`` launched 2 x (12 - 4) times; each save's seconds and
    bytes. Returns the resumed fit's launches."""
    import numpy as np
    from cycloneml_tpu_torch.ml.recommendation import ALS
    from cycloneml_tpu_torch.observe import tracing
    from cycloneml_tpu_torch.ops import kernels
    from cycloneml_tpu_torch.parallel.faults import (FaultInjector,
                                                     FaultSchedule,
                                                     MidSaveCrash)
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer

    ctx = _context("chip_smoke_checkpoint_als")
    tracer = tracing.enable()
    try:
        frame, _ = _als_frames(ctx, data)
        directory = os.path.join(tmp, "als")
        kw = dict(rank=ALS_RANK, regParam=ALS_REG, seed=ALS_SEED,
                  maxIter=ALS_ITERS, checkpointDir=directory,
                  checkpointInterval=CK_ALS_INTERVAL)
        sched = FaultSchedule().at("checkpoint.commit", 2,
                                   MidSaveCrash("power cut mid-save"))
        crashed = None
        with FaultInjector(sched) as inj:
            try:
                _timed(lambda: ALS(**kw).fit(frame))
            except MidSaveCrash as e:
                crashed = e
        crash_spans = [sp for sp in tracer.snapshot()
                       if sp.kind == "checkpoint"]
        steps = TrainingCheckpointer(directory).steps()
        clean = _no_leftovers(directory)
        n0 = len(tracer.snapshot())
        kernels.reset_launch_counts()
        model, resume_s = _timed(lambda: ALS(**kw).fit(frame))
        launches = kernels.als_normal.launches
        other = _other_launches(kernels, "als_normal")
        resume_spans = [sp for sp in tracer.snapshot()[n0:]
                        if sp.kind == "checkpoint"]
        saves = [{"step": sp.attrs["step"], "seconds": sp.duration_s}
                 for sp in crash_spans + resume_spans if sp.name == "save"]
        commits = [sp.duration_s for sp in crash_spans + resume_spans
                   if sp.name == "commit"]
        restore_s = sum(sp.duration_s for sp in resume_spans
                        if sp.name == "restore")
        size = _step_bytes(directory, steps[0])
        reference = _MAIN_MODEL["als"]
        factor_bytes = (reference.user_factors.size
                        + reference.item_factors.size) * 4
        _line("checkpoint_als", iterations=ALS_ITERS,
              interval=CK_ALS_INTERVAL, faults=inj.log, steps=steps,
              resume_s=resume_s, launches=launches, saves=saves,
              commit_s=commits, restore_s=restore_s, save_bytes=size,
              factor_bytes=factor_bytes)
        _check("checkpoint als", {
            "the crash at the second commit (iteration 8) raised":
                crashed is not None
                and inj.log == [("checkpoint.commit", 2, "MidSaveCrash")],
            "the directory holds iteration 4 and no partial step":
                steps == [CK_ALS_INTERVAL] and clean,
            "the resume launched als_normal 2 x (12 - 4) times":
                launches == 2 * (ALS_ITERS - CK_ALS_INTERVAL)
                and other == 0,
            "the resumed factors are bitwise phase 35's model's":
                bool(np.array_equal(model.user_factors,
                                    reference.user_factors)
                     and np.array_equal(model.item_factors,
                                        reference.item_factors)),
            "a save holds both factor matrices in float32":
                size["state.pkl"] >= factor_bytes,
        })
        return launches
    finally:
        tracing.disable()
        ctx.stop()


def phase_storage_tiers(tmp):
    """Phase 54: the storage tiers on the card. Two seeded 2M x 1280 bf16
    datasets under ``cyclone.storage.deviceBudget`` = 1.5 x one's
    ``padded_bytes()``: the cold one cached, the hot one cached for its
    LogisticRegression fit (phase 4's), which demotes the cold one to
    HOST (``torch.cuda.memory_allocated`` falls by its padded bytes); the
    fit bitwise equal to the same fit with no budget; touching the cold
    dataset brings it back bitwise and re-registers it at DEVICE. Then the
    DISK tier's round trip (``persist_disk``, then the first access) at
    250,000 x 1280 in bf16 and in e4m3 codes with ``x_scale``: X, y and w
    back bitwise. Returns the budgeted fit's K1 launches."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels

    # the padded bytes of one dataset: bf16 X, float32 y and w
    n_pad = (FIT_N + 7) // 8 * 8
    one = n_pad * (FIT_D * 2 + 2 * 4)
    budget = int(TIER_BUDGET * one)
    ctx = CycloneContext(CycloneConf()
                         .set("cyclone.app.name", "chip_smoke_tiers")
                         .set("cyclone.master", DEVICE)
                         .set("cyclone.storage.deviceBudget", str(budget)))
    mgr = ctx.storage

    def fit(ds):
        return LogisticRegression(maxIter=25, regParam=0.01,
                                  tol=0.0).fit(ds)

    def bits(t):
        return t.view(torch.uint8) if t.element_size() == 1 else t

    def same(ts, keep):
        return all(torch.equal(bits(t), bits(k)) for t, k in zip(ts, keep))

    try:
        cold = generate_classification(ctx, FIT_N, FIT_D, seed=0)
        hot = generate_classification(ctx, FIT_N, FIT_D, seed=1)
        cold_bytes = cold.padded_bytes()
        # the same fit with no budget, on the same hot rows
        mgr.device_budget = None
        free = fit(hot)
        mgr.device_budget = budget
        keep = [t.clone() for t in (cold.x, cold.y, cold.w)]
        cold.cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        _, demote_s = _timed(hot.cache)   # over budget: cold goes to HOST
        after = torch.cuda.memory_allocated()
        levels_demoted = (mgr.level_of(cold), mgr.level_of(hot))
        usage_demoted = mgr.usage()
        kernels.reset_launch_counts()
        model, fit_s = _timed(lambda: fit(hot))
        k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
        other = _other_launches(kernels, "logistic")
        _, restore_s = _timed(lambda: cold.x)   # touch: back to DEVICE
        back = same((cold.x, cold.y, cold.w), keep)
        levels_touched = (mgr.level_of(cold), mgr.level_of(hot))
        del keep
        mgr.unpersist(cold)
        mgr.unpersist(hot)
        del cold, hot
        torch.cuda.empty_cache()

        # the DISK tier, bf16 X and e4m3 codes with their scales
        disk = {}
        base = generate_classification(ctx, DISK_N, FIT_D, seed=5)
        for name, ds in (("bf16", base), ("e4m3", base.quantized())):
            keep = [t.clone() for t in (ds.x, ds.y, ds.w)]
            scale = None if ds.x_scale is None else ds.x_scale.copy()
            path = os.path.join(tmp, f"disk_{name}.npz")
            _, write_s = _timed(lambda: ds.persist_disk(path))
            released = ds._x is None and ds._host is None
            _, read_s = _timed(lambda: ds.x)
            disk[name] = {
                "write_s": write_s, "read_s": read_s,
                "file_bytes": os.path.getsize(path),
                "x_bytes": keep[0].numel() * keep[0].element_size(),
                "released": released,
                "bitwise": same((ds.x, ds.y, ds.w), keep)
                and (scale is None or np.array_equal(ds.x_scale, scale))}
            del keep
        del base, ds
        _line("storage_tiers", n=FIT_N, d=FIT_D, padded_bytes=one,
              device_budget=budget, memory_drop=before - after,
              levels_after_demotion=levels_demoted,
              usage_after_demotion=usage_demoted,
              demote_s=demote_s, restore_s=restore_s, fit_s=fit_s,
              k1_launches=k1, evals=model.summary.total_evals,
              levels_after_touch=levels_touched, disk_rows=DISK_N,
              disk=disk)
        _check("storage tiers", {
            "the budget is 1.5 x one dataset's padded_bytes()":
                cold_bytes == one and budget == int(TIER_BUDGET * cold_bytes),
            "caching the hot dataset demoted the cold one to HOST":
                levels_demoted == ("HOST", "DEVICE"),
            # a block stays whole when less than 1 MiB of its segment
            # would remain: X, y and w free at most that much more each
            "memory_allocated fell by the demoted padded bytes (each of "
            "X, y and w with at most 1 MiB of the allocator's slack)":
                0 <= (before - after) - one < 3 * (1 << 20),
            "K1 launched once per evaluation of the budgeted fit":
                k1 == model.summary.total_evals and other == 0,
            "the budgeted fit is bitwise the fit with no budget":
                bool(np.array_equal(model.coefficients.values,
                                    free.coefficients.values))
                and model.intercept == free.intercept,
            "touching the cold dataset brings it back bitwise":
                back,
            "... re-registered at DEVICE (the hot one demoted in turn)":
                levels_touched == ("DEVICE", "HOST"),
            "the DISK round trip released X, y and w and brought them "
            "back bitwise (bf16, e4m3 with x_scale)":
                all(v["released"] and v["bitwise"] for v in disk.values()),
        })
        return k1
    finally:
        ctx.stop()


# -- trees at HIGGS's shape, then the rest of MLlib's models ------------------

HIGGS_N, HIGGS_D = 11_000_000, 28   # UCI HIGGS: 11,000,000 rows x 28 features
GBT_N = HIGGS_N // 4                # the GBT phase's rows: its host
#                                     residual loop took 82.6 s at 11M
TREE_SEED = 23
RF_TREES = 20                       # Spark's numTrees default
MNIST_N, MNIST_D = 60_000, 784      # MNIST's training set
MNIST_LAYERS = [784, 300, 10]       # LeCun's "2-layer NN, 300 hidden units"
AFT_N, AFT_D = 1_000_000, 10
ISO_N = 1_000_000
TREE_HIST_RTOL = 1e-5


def _higgs(ctx, n, regression=False, seed=TREE_SEED):
    """A dataset of HIGGS's shape drawn on the card from ``seed``: 21
    "low-level" features (every third a positive, heavy-tailed magnitude
    exp(z / 2), the rest N(0, 1)) and 7 "high-level" ones built from them
    by products, sums and squares; the label a nonlinear function of
    several of them with noise, thresholded at 0 (or, with
    ``regression``, the function itself). X in the context's data tier,
    y and w float32."""
    import torch
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.dataset.instance import data_dtype
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = data_dtype(ctx.conf)
    x = torch.empty((n, HIGGS_D), dtype=dt, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    for lo in range(0, n, ROWS):
        m = min(ROWS, n - lo)
        z = torch.randn((m, 21), generator=g, device=dev)
        z[:, ::3] = torch.exp(0.5 * z[:, ::3])
        hi = torch.stack([z[:, 0] * z[:, 3], z[:, 1] + z[:, 4],
                          (z[:, 2] - z[:, 5]).abs(), z[:, 6] ** 2,
                          torch.sin(z[:, 7]) * z[:, 9], z[:, 10] * z[:, 12],
                          (z[:, 13] + z[:, 15]) ** 2], 1)
        xc = torch.cat([z, hi], 1).to(dt)
        xf = xc.float()
        f = (xf[:, 21] - 1.0 + 0.8 * torch.sin(2.0 * xf[:, 1])
             + 0.5 * xf[:, 2] * xf[:, 8] - 0.3 * xf[:, 24]
             + 0.5 * torch.randn(m, generator=g, device=dev))
        x[lo:lo + m] = xc
        y[lo:lo + m] = f if regression else (f > 0).float()
    w = torch.ones(n, dtype=torch.float32, device=dev)
    ds = InstanceDataset(ctx, x, y, w, n, HIGGS_D)
    return ds.attach_host_labels(y.cpu().numpy(), w.cpu().numpy())


class _TreeProbe:
    """Wraps the tree engine's steps for the fits inside it: the seconds
    of binning, the host counts, the channels, the host split search, the
    reassign gathers and GBT's host residual loop (``predict_raw`` and
    ``_unbin``), each with the card synchronized; ``tree_hist``'s time a
    call by CUDA events around it (its sort, its piece table, its
    launch), by level (a_pad); with ``check``, every level's table held
    against the plain twin on the same inputs in float64 (counts exactly,
    sums to rtol 1e-5 of the sums of absolute values); with ``record``,
    every level's table of ``tree_hist`` or of the plain twin kept on the
    host."""

    def __init__(self, check=False, record=False):
        self.check = check
        self.record = record
        self.tables = []          # every level's table, with ``record``
        self.secs = {}
        self.levels = []          # (a_pad, trees, Event, Event)
        self.twin = {"levels": 0, "counts_exact": True, "max_rel": 0.0}

    def _timed(self, name, fn):
        import torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.secs[name] = (self.secs.get(name, 0.0)
                               + time.perf_counter() - t0)
            return out
        return run

    def _hist(self, fn):
        import torch
        from cycloneml_tpu_torch.ops import kernels

        def run(bins, chans, pos, a_pad, n_bins):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(bins, chans, pos, a_pad, n_bins)
            e1.record()
            self.levels.append((a_pad, chans.shape[1], e0, e1))
            if self.record:
                self.tables.append(out.cpu())
            if self.check:
                # the twin in float64 (the channels upcast exactly): the
                # table's truth; index_add_'s float32 atomics add in run
                # order and drift past 1e-5 on GBT's residual channels
                c64 = chans.to(torch.float64)
                twin = kernels.tree_hist_plain(bins, c64, pos, a_pad,
                                               n_bins)
                scale = (kernels.tree_hist_plain(bins, c64.abs(), pos,
                                                 a_pad, n_bins)
                         if bool((chans < 0).any()) else twin)
                del c64
                self.twin["levels"] += 1
                self.twin["counts_exact"] &= bool(torch.equal(
                    out[..., 0].to(torch.float64), twin[..., 0]))
                rel = float(((out.to(torch.float64) - twin).abs()
                             / scale.clamp(min=1e-30)).max())
                self.twin["max_rel"] = max(self.twin["max_rel"], rel)
                del twin, scale
            return out
        # the wrapper's counts stand in for the wrapped function's while it
        # is patched in (the function counts through its module's name)
        run.launches = fn.launches
        run.launches_by_instance = fn.launches_by_instance
        return run

    def __enter__(self):
        from cycloneml_tpu_torch.ml.classification import trees as ct
        from cycloneml_tpu_torch.ml.tree import impl
        from cycloneml_tpu_torch.ops import kernels
        self._saved = [
            (impl.BinnedDataset, "from_instance_dataset",
             impl.BinnedDataset.__dict__["from_instance_dataset"]),
            (impl, "_bootstrap_counts", impl._bootstrap_counts),
            (impl, "_channels", impl._channels),
            (impl, "_split_level", impl._split_level),
            (impl, "_reassign", impl._reassign),
            (kernels, "tree_hist", kernels.tree_hist),
            (kernels, "tree_hist_plain", kernels.tree_hist_plain),
            (impl.ForestData, "predict_raw", impl.ForestData.predict_raw),
            (ct, "_unbin", ct._unbin)]
        binning = self._timed("binning", impl.BinnedDataset
                              .from_instance_dataset)
        impl.BinnedDataset.from_instance_dataset = classmethod(
            lambda cls, *a, **k: binning(*a, **k))
        impl._bootstrap_counts = self._timed("host_counts",
                                             impl._bootstrap_counts)
        impl._channels = self._timed("channels", impl._channels)
        impl._split_level = self._timed("split_search", impl._split_level)
        impl._reassign = self._timed("reassign", impl._reassign)
        kernels.tree_hist = self._hist(kernels.tree_hist)
        if self.record:  # the plain route's tables too
            plain = kernels.tree_hist_plain
            kernels.tree_hist_plain = lambda *a: self._keep(plain(*a))
        impl.ForestData.predict_raw = self._timed(
            "residual_loop", impl.ForestData.predict_raw)
        ct._unbin = self._timed("residual_loop", ct._unbin)
        return self

    def _keep(self, out):
        self.tables.append(out.cpu())
        return out

    def __exit__(self, *exc):
        from cycloneml_tpu_torch.ops import kernels
        counts = (kernels.tree_hist.launches,
                  kernels.tree_hist.launches_by_instance)
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        (kernels.tree_hist.launches,
         kernels.tree_hist.launches_by_instance) = counts

    def by_level(self):
        """{a_pad: [launches, ms]} over the fits, and the total ms."""
        import torch
        torch.cuda.synchronize()
        out = {}
        for a_pad, _, e0, e1 in self.levels:
            rec = out.setdefault(str(a_pad), [0, 0.0])
            rec[0] += 1
            rec[1] += e0.elapsed_time(e1)
        total = sum(v[1] for v in out.values())
        return ({k: [v[0], v[1] / v[0]] for k, v in out.items()}, total)


def _forest_bits(model):
    """Every array of a tree model's forests, for bitwise comparisons."""
    forests = getattr(model, "_forests", None) or [model._forest]
    return [a.tobytes() for f in forests for a in f.to_arrays().values()]


def _tree_hist_bytes(n, d, trees, c, a_pad, b, active, esize=4,
                     blocks=1):
    """(the bytes the function must move: bins of ``esize`` bytes and
    positions read once, the channels of the ``active`` row-tree pairs
    (pos >= 0; the others are never read) once, the table written once;
    the bytes this design moves: ``active`` row-tree pairs each gathering
    its d bins once and its channels and order entry once a feature block
    of ``blocks``, the keys written and read, the table)."""
    table = trees * a_pad * d * b * c * 4
    least = n * d * esize + n * trees * 4 + active * c * 4 + table
    design = (active * (d * esize + blocks * (c * 4 + 4))
              + n * trees * 4 * 3 + table)
    return least, design


def _tree_level0_numbers(ds, binned, trees, classification):
    """tree_hist at the fit's level 0 (every drawn row at node 0): its time
    by CUDA events over back-to-back calls, the plain twin's, the counting
    sort's alone, ``index_add_``'s over the same flat keys (one tree: the
    library yardstick), the bound at 3.35 TB/s, and the kernel's largest
    difference from the twin."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.tree import impl
    from cycloneml_tpu_torch.ops import kernels
    n, d = binned.bins.shape
    K = 2 if classification else 0
    dev = binned.bins.device
    # the forest's bootstrap counts drawn on the card (Poisson(1) a row and
    # tree): the timing needs their shape, not the reference's host draws
    g = torch.Generator(device=dev).manual_seed(TREE_SEED)
    cnt = (torch.poisson(torch.ones((n, trees), device=dev), generator=g)
           if trees > 1 else torch.ones((n, 1), device=dev))
    y = torch.from_numpy(ds.y_host().astype(np.float64)).to(cnt.device)
    w = torch.from_numpy(ds.w_host().astype(np.float64)).to(cnt.device)
    label = y.to(torch.int64) if classification else None
    chans = impl._channels(cnt, y, w, label, K)
    pos = torch.where(cnt > 0, 0, -1).to(torch.int32)
    active = int((cnt > 0).sum())
    del cnt, y, w, label
    B, C = binned.max_bins, chans.shape[2]
    bins = binned.bins
    plan = kernels.tree_hist_plan(B, C, d, bins.dtype)
    reps = 3 if trees > 1 else 5
    ms = _time_ms(lambda: kernels.tree_hist(bins, chans, pos, 1, B), reps)
    keys = kernels.tree_keys(pos, 0, trees, 1)
    sort_ms = _time_ms(lambda: kernels.tree_order(keys, trees), reps)
    del keys
    got = kernels.tree_hist(bins, chans, pos, 1, B)
    twin = kernels.tree_hist_plain(bins, chans, pos, 1, B)
    err = float((got - twin).abs().max())
    plain_ms = _time_ms(lambda: kernels.tree_hist_plain(bins, chans, pos,
                                                        1, B), 1,
                        warm=1 if trees == 1 else 0)
    library_ms = None
    if trees == 1:
        idx = (torch.arange(d, device=bins.device) * B
               + bins.to(torch.int64)).view(-1)
        vals = chans[:, 0, None, :].expand(n, d, C).reshape(-1, C)
        tbl = torch.zeros((d * B, C), dtype=torch.float32,
                          device=bins.device)
        library_ms = _time_ms(lambda: tbl.zero_().index_add_(0, idx, vals),
                              reps)
        del idx, vals, tbl
    esize = bins.element_size()
    least, design = _tree_hist_bytes(n, d, trees, C, 1, B, active, esize,
                                     plan["feature_blocks"])
    least32, _ = _tree_hist_bytes(n, d, trees, C, 1, B, active)
    del got, twin, chans, pos
    torch.cuda.empty_cache()
    bound_ms = least / H100_BYTES_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "sort_ms": sort_ms, "max_abs_err": err,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_bytes": least, "share": bound_ms / ms,
            "bound_int32_bins_ms": least32 / H100_BYTES_PER_S * 1e3,
            "bound_int32_bins_bytes": least32, "design_bytes": design,
            "design_bound_ms": design / H100_BYTES_PER_S * 1e3,
            "plan": plan, "bins_dtype": str(bins.dtype),
            "shape": {"n": n, "d": d, "trees": trees, "C": C, "B": B,
                      "active_row_trees": active}}


def _tree_hist_wide(ds):
    """tree_hist at HIGGS's rows past the fits' widths, each case at level
    0 and at a deep level (a_pad 32, each row in a node drawn at random
    or out of the tree): maxBins 256 on one-byte bins with a 10-class
    fit's 11 channels (the lane-a-bin instance) and maxBins 257 on int32
    bins with 3 channels (lane a row). Each table against the twin in
    float64 (counts exactly, sums to 1e-5 of the twin's nonnegative
    cells), the launch counted with the counts zeroed just before it and
    read just after, then its time by CUDA events beside its bytes
    bound."""
    import torch
    from cycloneml_tpu_torch.ml.tree import BinnedDataset, impl
    from cycloneml_tpu_torch.ops import kernels
    dev = ds.x.device
    g = torch.Generator(device=dev).manual_seed(TREE_SEED + 1)
    cases = []
    for max_bins, K in ((256, 10), (257, 2)):
        binned = BinnedDataset.from_instance_dataset(ds, max_bins, 17)
        bins, B = binned.bins, binned.max_bins
        n, d = bins.shape
        label = torch.randint(0, K, (n,), generator=g, device=dev)
        one = torch.ones((n, 1), dtype=torch.float64, device=dev)
        chans = impl._channels(one, label.double(), one[:, 0], label, K)
        del one
        C = chans.shape[2]
        plan = kernels.tree_hist_plan(B, C, d, bins.dtype)
        for a_pad in (1, 32):
            pos = (torch.zeros((n, 1), dtype=torch.int32, device=dev)
                   if a_pad == 1 else torch.randint(
                       -1, a_pad, (n, 1), generator=g, device=dev,
                       dtype=torch.int32))
            active = int((pos >= 0).sum())
            kernels.reset_launch_counts()
            got = kernels.tree_hist(bins, chans, pos, a_pad, B)
            launches = kernels.tree_hist.launches
            by_instance = dict(kernels.tree_hist.launches_by_instance)
            twin = kernels.tree_hist_plain(bins, chans.to(torch.float64),
                                           pos, a_pad, B)
            counts_exact = bool(torch.equal(got[..., 0].to(torch.float64),
                                            twin[..., 0]))
            max_rel = float(((got.to(torch.float64) - twin).abs()
                             / twin.clamp(min=1e-30)).max())
            del got, twin
            ms = _time_ms(lambda: kernels.tree_hist(bins, chans, pos, a_pad,
                                                    B), 3)
            least, _ = _tree_hist_bytes(n, d, 1, C, a_pad, B, active,
                                        bins.element_size())
            bound_ms = least / H100_BYTES_PER_S * 1e3
            cases.append({
                "max_bins": max_bins, "B": B, "C": C, "a_pad": a_pad,
                "bins_dtype": str(bins.dtype), "n": n, "d": d,
                "active_rows": active, "instance": plan["instance"],
                "plan": plan, "launches": launches,
                "launches_by_instance": by_instance, "ms": ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "bound_bytes": least, "share": bound_ms / ms,
                "counts_exact": counts_exact, "max_rel": max_rel})
            del pos
        del binned, bins, chans, label
        torch.cuda.empty_cache()
    return cases


def _same_tables(kernel_tables, twin_tables):
    """(every level's kernel table's counts equal to the twin's, the
    largest difference of the sums relative to the twin's magnitudes):
    the twin's channels are nonnegative here (classification)."""
    if len(kernel_tables) != len(twin_tables) or not kernel_tables:
        return False, float("inf")
    counts = all(bool((a[..., 0] == b[..., 0]).all())
                 for a, b in zip(kernel_tables, twin_tables))
    rel = max(float(((a.double() - b.double()).abs()
                     / b.double().abs().clamp(min=1e-30)).max())
              for a, b in zip(kernel_tables, twin_tables))
    return counts, rel


def _tree_phase(tag, est_of, ds, classification, plain_route=True):
    """One tree fit path at full width: a fit whose steps are timed, and a
    second through ``tree_hist``, bitwise equal to it. With
    ``plain_route`` (classification) the plain route's fit
    (``usePallasKernels=false``) follows: its trees must be the kernel
    fit's, so each level's inputs are the same and each level's table of
    the second fit is held against the twin's table of the same level;
    without it every level's table is held against the twin in float64
    inside the second fit. Returns the numbers and the timed fit's
    launches."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ops import kernels
    ctx = ds.ctx
    base = kernels.tree_hist
    kernels.reset_launch_counts()
    with _TreeProbe() as probe:
        model, fit_s = _timed(lambda: est_of().fit(ds))
    launches = base.launches
    by_instance = dict(base.launches_by_instance)
    other = _other_launches(kernels)
    levels, hist_ms = probe.by_level()
    with _TreeProbe(check=not plain_route, record=plain_route) as checked:
        again = est_of().fit(ds)
    bitwise = _forest_bits(model) == _forest_bits(again)
    del again
    plain_same = None
    twin = checked.twin
    if plain_route:
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        try:
            kernels.reset_launch_counts()
            with _TreeProbe(record=True) as plain_probe:
                plain = est_of().fit(ds)
            plain_same = (_forest_bits(model) == _forest_bits(plain)
                          and base.launches == 0)
        finally:
            ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
        exact, rel = _same_tables(checked.tables, plain_probe.tables)
        twin = {"levels": len(checked.tables), "counts_exact": exact,
                "max_rel": rel}
        del plain, plain_probe
    probe_rows = slice(0, 200_000)
    xh = ds.x[probe_rows].float().cpu().numpy().astype(np.float64)
    yh = ds.y_host()[probe_rows]
    pred = model.transform(_probe_frame(xh))["prediction"]
    quality = (float((pred == yh).mean()) if classification else
               float(1 - ((pred - yh) ** 2).sum()
                     / ((yh - yh.mean()) ** 2).sum()))
    forests = getattr(model, "_forests", None) or [model._forest]
    nodes = int(sum(int(f.n_nodes.sum()) for f in forests))
    secs = dict(probe.secs)
    other_s = fit_s - sum(secs.values()) - hist_ms / 1e3
    _line(tag, n=ds.n_rows, d=ds.n_features, fit_s=fit_s,
          hist_device_s=hist_ms / 1e3, other_s=other_s, **secs,
          tree_hist_launches=launches, by_instance=by_instance,
          by_level_launches_ms=levels,
          nodes=nodes, quality_on_200k=quality,
          twin="the plain route's tables, level by level" if plain_route
          else "float64 twin inside the fit",
          twin_levels=twin["levels"], twin_counts_exact=twin["counts_exact"],
          twin_max_rel=twin["max_rel"], refit_bitwise=bitwise,
          plain_route_same=plain_same)
    _check(tag, {
        "tree_hist launched, once a level of the fit":
            launches == len(probe.levels) and launches > 0,
        "no other kernel launched": other == 0,
        "every level's table equal to the twin's: counts exactly":
            twin["counts_exact"] and twin["levels"] == launches,
        "... sums to rtol 1e-5": twin["max_rel"] <= TREE_HIST_RTOL,
        "two kernel fits give bitwise-equal forests": bitwise,
        "the plain route grows the same trees (classification)":
            plain_same is None or plain_same,
        "finite predictions of the expected shape": pred.shape == yh.shape
            and bool(np.isfinite(pred).all()),
    })
    torch.cuda.empty_cache()
    return {"fit_s": fit_s, "launches": launches, "levels": levels,
            "by_instance": by_instance, "model": model}


def _probe_frame(x):
    from cycloneml_tpu_torch import CycloneContext
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    return MLFrame(CycloneContext.get_or_create(), {"features": x})


def phase_trees_dt(ctx, ds):
    """Phase 55: DecisionTreeClassifier at Spark's defaults (maxDepth 5,
    maxBins 32, gini) on HIGGS's shape; tree_hist at its level 0 against
    the twin and index_add_."""
    from cycloneml_tpu_torch.ml.classification import DecisionTreeClassifier
    out = _tree_phase("trees_dt", lambda: DecisionTreeClassifier(), ds,
                      True)
    binned = _binned_of(ds)
    out["level0"] = _tree_level0_numbers(ds, binned, 1, True)
    _line("tree_hist_time", fit="dt", **out["level0"])
    del binned
    out["wide"] = wide = _tree_hist_wide(ds)
    for case in wide:
        _line("tree_hist_wide", **case)
    checks = {}
    for case in wide:
        at = (f"maxBins {case['max_bins']}, C {case['C']}, "
              f"{case['bins_dtype']}, a_pad {case['a_pad']}")
        checks[f"{at}: one launch, counted by its instance"] = (
            case["launches"] == 1
            and case["launches_by_instance"][case["instance"]] == 1)
        checks[f"{at}: counts equal to the twin's exactly"] = (
            case["counts_exact"])
        checks[f"{at}: sums to rtol 1e-5"] = case["max_rel"] <= TREE_HIST_RTOL
    checks["maxBins 256 with 11 channels takes the lane-a-bin instance"] = (
        wide[0]["instance"] == "lane_a_bin")
    checks["int32 bins (maxBins 257) take the lane-a-row instance"] = (
        wide[2]["instance"] == "lane_a_row"
        and wide[2]["bins_dtype"] == "torch.int32")
    _check("tree_hist_wide", checks)
    return out


def _binned_of(ds):
    from cycloneml_tpu_torch.ml.tree import BinnedDataset
    return BinnedDataset.from_instance_dataset(ds, 32, 17)


def phase_trees_rf(ctx, ds):
    """Phase 56: RandomForestClassifier (20 trees, bootstrap, "auto"
    subsets: ceil(sqrt(28)) = 6 features a node) on HIGGS's shape;
    tree_hist at its level 0 (all 20 trees in one launch)."""
    from cycloneml_tpu_torch.ml.classification import RandomForestClassifier
    out = _tree_phase("trees_rf", lambda: RandomForestClassifier(
        numTrees=RF_TREES, seed=TREE_SEED), ds, True)
    out["level0"] = _tree_level0_numbers(ds, _binned_of(ds), RF_TREES, True)
    _line("tree_hist_time", fit="rf", **out["level0"])
    return out


def phase_trees_gbt(ctx, ds):
    """Phase 57: GBTClassifier (maxIter 20, stepSize 0.1, maxDepth 5) on
    HIGGS's shape (rows cut to GBT_N); the residual loop on the host."""
    from cycloneml_tpu_torch.ml.classification import GBTClassifier
    if ds.n_rows > GBT_N:
        ds = ds.derive(x=ds.x[:GBT_N], y=ds.y[:GBT_N], w=ds.w[:GBT_N])
        ds.n_rows = GBT_N
        ds.attach_host_labels(ds.y.cpu().numpy(), ds.w.cpu().numpy())
    return _tree_phase("trees_gbt", lambda: GBTClassifier(seed=TREE_SEED),
                       ds, True, plain_route=False)


def phase_trees_dtr(ctx, ds):
    """Phase 58: DecisionTreeRegressor at the defaults (variance) on
    HIGGS's features with the label's continuous function as target."""
    from cycloneml_tpu_torch.ml.regression import DecisionTreeRegressor
    return _tree_phase("trees_dtr", lambda: DecisionTreeRegressor(), ds,
                       False, plain_route=False)


def _two_tier_fit(name, make_ds, fit, **conf):
    """``fit(ds)`` on the card's default tiers (float32 accumulators) and
    on the float64 tier, on the same values of X: (model32, s, model64,
    s)."""
    import torch
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    out = []
    for dtype in ("float32", "float64"):
        c = (CycloneConf().set("cyclone.app.name", f"chip_smoke_{name}")
             .set("cyclone.master", DEVICE)
             .set("cyclone.compute.dtype", dtype))
        for k, v in conf.items():
            c.set(k, v)
        ctx = CycloneContext(c)
        try:
            ds = make_ds(ctx, dtype)
            model, secs = _timed(lambda: fit(ds))
            out += [model, secs]
            del ds
        finally:
            ctx.stop()
        torch.cuda.empty_cache()
    return tuple(out)


def _dataset(ctx, x, y, dtype):
    """An InstanceDataset over device tensors: X at the float64 tier's
    width, or as it is; y and w at the accumulator width."""
    import torch
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    acc = torch.float64 if dtype == "float64" else torch.float32
    xd = x.to(torch.float64) if dtype == "float64" else x
    yd = y.to(acc)
    w = torch.ones_like(yd)
    ds = InstanceDataset(ctx, xd, yd, w, x.shape[0], x.shape[1])
    return ds.attach_host_labels(yd.cpu().numpy(), w.cpu().numpy())


def phase_mlp():
    """Phase 59: MultilayerPerceptronClassifier at MNIST's shape (60,000 x
    784 pixels in [0, 1], drawn on the card from 10 class prototypes),
    784-300-10, L-BFGS maxIter 100, on the default tiers (bf16 X, float32)
    and on the float64 tier over the same values."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.classification import (
        MultilayerPerceptronClassifier)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(59)
    proto = torch.rand((10, MNIST_D), generator=g, device=dev)
    y = torch.randint(0, 10, (MNIST_N,), generator=g, device=dev)
    x = (proto[y] * 0.6 + 0.4 * torch.rand((MNIST_N, MNIST_D), generator=g,
                                           device=dev)
         ).clamp(0, 1).to(torch.bfloat16)
    fit = lambda ds: MultilayerPerceptronClassifier(  # noqa: E731
        layers=MNIST_LAYERS, maxIter=100, seed=1).fit(ds)
    m32, s32, m64, s64 = _two_tier_fit(
        "mlp", lambda ctx, dt: _dataset(ctx, x, y.float(), dt), fit)
    xh = x.float().cpu().numpy().astype(np.float64)
    yh = y.cpu().numpy()
    acc32 = float((m32._raw_prediction(xh).argmax(1) == yh).mean())
    acc64 = float((m64._raw_prediction(xh).argmax(1) == yh).mean())
    h32, h64 = m32.objective_history, m64.objective_history
    first = min(5, len(h32), len(h64))
    rel5 = max(abs(a - b) / abs(b) for a, b in zip(h32[:first], h64[:first]))
    _line("mlp_fit", n=MNIST_N, layers=MNIST_LAYERS, fit_s=s32,
          fit64_s=s64, iterations=m32.total_iterations,
          iterations64=m64.total_iterations, loss=h32[-1], loss64=h64[-1],
          first_losses_max_rel=rel5, train_accuracy=acc32,
          train_accuracy64=acc64)
    _check("mlp", {
        "finite weights": bool(np.isfinite(m32.weights.to_array()).all()),
        "the first five objectives within 1e-3 of the float64 fit's":
            rel5 <= 1e-3,
        "both fits learned (last objective below half the first)":
            h32[-1] < 0.5 * h32[0] and h64[-1] < 0.5 * h64[0],
        "train accuracy within 0.02 of the float64 fit's":
            abs(acc32 - acc64) <= 0.02,
    })
    return s32


def phase_naive_bayes():
    """Phase 60: multinomial NaiveBayes at the main path's 2,000,000 x
    1,280: counts 0-3 drawn on the card at class-dependent rates (10
    classes), bf16 X; the float32 fit against the float64 fit on the same
    counts (every sum an integer below 2^24: equal to 1e-9)."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.ml.classification import NaiveBayes
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(60)
    rates = torch.rand((10, FIT_D), generator=g, device=dev) * 0.1
    y = torch.randint(0, 10, (FIT_N,), generator=g, device=dev)
    x = torch.empty((FIT_N, FIT_D), dtype=torch.bfloat16, device=dev)
    for lo in range(0, FIT_N, ROWS):
        r = rates[y[lo:lo + ROWS]]
        u = torch.rand(r.shape, generator=g, device=dev)
        x[lo:lo + ROWS] = ((u < r) * (1 + torch.floor(
            3 * u / r.clamp(min=1e-9)).clamp(max=2))).to(torch.bfloat16)
    m32, s32, m64, s64 = _two_tier_fit(
        "nb", lambda ctx, dt: _dataset(ctx, x, y.float(), dt),
        lambda ds: NaiveBayes().fit(ds))
    th32, th64 = m32.theta.to_array(), m64.theta.to_array()
    rel = float(np.max(np.abs(th32 - th64) / np.abs(th64)))
    pi_rel = float(np.max(np.abs(m32.pi - m64.pi) / np.abs(m64.pi)))
    _line("naive_bayes_fit", n=FIT_N, d=FIT_D, classes=10, fit_s=s32,
          fit64_s=s64, theta_max_rel=rel, pi_max_rel=pi_rel)
    _check("naive bayes", {
        "theta and pi within 1e-9 of the float64 fit's":
            rel <= 1e-9 and pi_rel <= 1e-9,
        "finite": bool(np.isfinite(th32).all()),
    })
    return s32


def phase_fm():
    """Phase 61: FMClassifier (factorSize 8, adamW, stepSize 0.01, maxIter
    100) at the main path's 2,000,000 x 1,280 (phase 4's generator, bf16
    X), against the float64 tier on the same values."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import FMClassifier
    holder = {}

    def make(ctx, dt):
        if "x" not in holder:
            base = generate_classification(ctx, FIT_N, FIT_D, seed=0)
            holder["x"], holder["y"] = base.x[:FIT_N], base.y[:FIT_N]
        return _dataset(ctx, holder["x"], holder["y"], dt)

    m32, s32, m64, s64 = _two_tier_fit(
        "fm", make, lambda ds: FMClassifier(factorSize=8, stepSize=0.01,
                                            seed=1).fit(ds))
    h32, h64 = m32.objective_history, m64.objective_history
    first = min(10, len(h32), len(h64))
    rel10 = max(abs(a - b) / abs(b) for a, b in zip(h32[:first], h64[:first]))
    last_rel = abs(h32[-1] - h64[-1]) / abs(h64[-1])
    _line("fm_fit", n=FIT_N, d=FIT_D, factor_size=8, fit_s=s32,
          fit64_s=s64, iterations=len(h32), iterations64=len(h64),
          loss=h32[-1], loss64=h64[-1], first_losses_max_rel=rel10,
          last_loss_rel=last_rel)
    _check("fm", {
        "finite factors": bool(np.isfinite(m32.factors.to_array()).all()),
        "the first ten objectives within 1e-4 of the float64 fit's":
            rel10 <= 1e-4,
        "the last objective within 1e-2 of the float64 fit's":
            last_rel <= 1e-2,
    })
    return s32


def phase_aft_isotonic():
    """Phase 62: AFTSurvivalRegression at 1,000,000 x 10 (the reference
    test's Weibull recipe, drawn on the host from seed 62) on the default
    tiers and the float64 tier; IsotonicRegression at 1,000,000 rows (host
    numpy, as the reference's), its result held to the isotonic fit's
    characterization: each pool's value the weighted mean of its members,
    the pools strictly increasing."""
    import numpy as np
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.regression import (
        AFTSurvivalRegression, IsotonicRegression)
    rng = np.random.RandomState(62)
    x = rng.randn(AFT_N, AFT_D)
    beta = rng.randn(AFT_D) * 0.3
    t = np.exp(x @ beta + 1.0 + 0.7 * np.log(-np.log(1.0 - rng.rand(AFT_N))))
    c = np.exp(1.5 + rng.randn(AFT_N))
    cols = {"features": x, "label": np.minimum(t, c),
            "censor": (t <= c).astype(float)}
    fits = {}
    for dtype in ("float32", "float64"):
        ctx = CycloneContext(CycloneConf().set("cyclone.master", DEVICE)
                             .set("cyclone.compute.dtype", dtype))
        try:
            fits[dtype] = _timed(lambda: AFTSurvivalRegression().fit(
                MLFrame(ctx, cols)))
        finally:
            ctx.stop()
    (a32, s32), (a64, s64) = fits["float32"], fits["float64"]
    c32, c64 = a32.coefficients.to_array(), a64.coefficients.to_array()
    coef_err = float(np.max(np.abs(c32 - c64)))
    ctx = _context("chip_smoke_isotonic")
    try:
        f = rng.uniform(0, 10, ISO_N)
        yv = 0.5 * f + np.sin(f) + rng.randn(ISO_N)
        wv = rng.uniform(0.5, 2.0, ISO_N)
        iso, iso_s = _timed(lambda: IsotonicRegression(weightCol="w").fit(
            MLFrame(ctx, {"features": f, "label": yv, "w": wv})))
    finally:
        ctx.stop()
    uniq, inv = np.unique(f, return_inverse=True)
    wsum = np.bincount(inv, wv)
    yagg = np.bincount(inv, wv * yv) / wsum
    fitted = np.interp(uniq, iso.boundaries, iso.predictions)
    starts = np.flatnonzero(np.r_[True, fitted[1:] != fitted[:-1]])
    ends = np.r_[starts[1:], len(fitted)]
    pool_mean = np.add.reduceat(wsum * yagg, starts) / np.add.reduceat(
        wsum, starts)
    pool_err = float(np.max(np.abs(pool_mean - fitted[starts])))
    _line("aft_fit", n=AFT_N, d=AFT_D, fit_s=s32, fit64_s=s64,
          iterations=len(a32.loss_history),
          iterations64=len(a64.loss_history), coef_max_abs_diff=coef_err,
          scale=a32.scale, scale64=a64.scale)
    _line("isotonic_fit", n=ISO_N, fit_s=iso_s, pools=len(starts),
          boundaries=len(iso.boundaries), pool_mean_max_err=pool_err)
    _check("aft and isotonic", {
        "AFT coefficients within 1e-2 of the float64 fit's (bf16 X)":
            coef_err <= 1e-2 * max(float(np.max(np.abs(c64))), 1.0),
        "AFT scale within 1e-2": abs(a32.scale - a64.scale)
            <= 1e-2 * a64.scale,
        "isotonic pools strictly increasing":
            bool(np.all(np.diff(fitted[starts]) > 0)),
        "each pool's value the weighted mean of its members":
            pool_err <= 1e-9 * max(1.0, float(np.abs(yagg).max())),
    })
    return s32, iso_s


def phase_trees():
    """Phases 55-58 on one context and one HIGGS-shaped dataset (the
    regressor's a second label on the same features); returns what the
    kernels line needs."""
    import torch
    ctx = _context("chip_smoke_trees")
    try:
        (ds, data_s) = _timed(lambda: _higgs(ctx, HIGGS_N))
        _line("higgs_data", n=HIGGS_N, d=HIGGS_D, seconds=data_s,
              dtype=str(ds.x.dtype), positives=float(ds.y_host().mean()))
        dt = phase_trees_dt(ctx, ds)
        rf = phase_trees_rf(ctx, ds)
        gbt = phase_trees_gbt(ctx, ds)
        del ds
        torch.cuda.empty_cache()
        dsr = _higgs(ctx, HIGGS_N, regression=True)
        dtr = phase_trees_dtr(ctx, dsr)
        del dsr
    finally:
        ctx.stop()
    torch.cuda.empty_cache()
    return dt, rf, gbt, dtr



# -- GraphX and the feature transformers (phases 63-68) ----------------------

RMAT_ABCD = (0.45, 0.15, 0.15, 0.25)  # Spark's GraphGenerators.rmatGraph
GRAPH_LOG2 = 22                       # 2^22 vertices
GRAPH_EDGES = 68_993_773              # SNAP soc-LiveJournal1's edge count
GRAPH_SEED = 25
GRAPH_ITERS = 20                      # PageRank's iterations (Spark's run)
GRAPH_LANDMARKS = 4
SVDPP_RANK, SVDPP_ITERS = 10, 10
DENSE_LOG2, DENSE_LP_LOG2, DENSE_DEGREE = 14, 12, 16
W2V_TOKENS, W2V_TYPES = 2_000_000, 71_290   # text8's word types
W2V_DIM, W2V_WINDOW, W2V_NEG, W2V_SENTENCE = 100, 5, 5, 1000
W2V_STEP = 0.0025                     # stepSize (see phase_word2vec)
ADULT_N = 1_000_000                   # UCI Adult's schema at 1M rows
ADULT_CARD = (9, 16, 7, 15, 6, 5, 2, 42)  # its categorical columns' values
ADULT_NUMERIC = 6


class _KernelEvents:
    """CUDA events around every call of ``kernels.segment_reduce`` inside
    the block (the wrapped function keeps counting its launches): the
    calls' device time without a profiler."""

    def __enter__(self):
        import torch
        from cycloneml_tpu_torch.ops import kernels
        self.kernels, self.orig, self.pairs = kernels, \
            kernels.segment_reduce, []
        orig, pairs = self.orig, self.pairs

        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*args, **kw)
            e1.record()
            pairs.append((e0, e1))
            return out
        # the kernel's wrapper counts through its module name
        timed.launches = orig.launches
        timed.launches_by_instance = orig.launches_by_instance
        kernels.segment_reduce = timed
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.kernels.segment_reduce.launches
        self.kernels.segment_reduce = self.orig

    def seconds(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def _rmat_edges(log2_n, m, seed, dev):
    """``m`` distinct directed edges of an R-MAT graph on 2^log2_n vertices
    with Spark's rmatGraph quadrant probabilities (a, b, c, d), drawn on
    the card: each level picks a quadrant from one uniform (b sets the
    source's bit, c the destination's, d both); duplicates drop, the first
    draw of each edge kept in draw order, and more are drawn until m are
    distinct (Spark's rmatGraph fills a set of edges). Returns (src, dst)
    int32."""
    import torch
    a, b, c, _ = RMAT_ABCD
    n = 1 << log2_n
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    while True:
        draw = max(m - keys.shape[0], m // 8) + m // 8
        src = torch.zeros(draw, dtype=torch.int64, device=dev)
        dst = torch.zeros(draw, dtype=torch.int64, device=dev)
        for _ in range(log2_n):
            u = torch.rand(draw, generator=g, device=dev)
            src = src * 2 + ((u >= a) & (u < a + b) | (u >= a + b + c))
            dst = dst * 2 + (u >= a + b)
        keys = torch.cat([keys, src * n + dst])
        srt = torch.sort(keys, stable=True)
        first = torch.ones_like(srt.values, dtype=torch.bool)
        first[1:] = srt.values[1:] != srt.values[:-1]
        keep = torch.zeros_like(first)
        keep[srt.indices[first]] = True
        kept = keys[keep]
        if kept.shape[0] >= m:
            kept = kept[:m]
            return (kept // n).to(torch.int32), (kept % n).to(torch.int32)
        keys = kept


def _segment_numbers(msgs, offsets, tag):
    """segment_reduce at a path's shape, on the offsets' pieces built
    once (as a graph builds them an order; their build timed apart): its
    ms (CUDA events), the plain
    version's (index_add_ in float64) and its largest |difference|, the
    bytes bound (the rows read once, the offsets, the output written
    once), and the yardsticks torch.segment_reduce and index_add_ (float32
    atomics) on the same inputs; then the longest segment alone."""
    import torch
    from cycloneml_tpu_torch.ops import kernels
    n = offsets.shape[0] - 1
    m = msgs.shape[0]
    k = msgs[0].numel() if m else 1
    counts = torch.diff(offsets)
    seg = torch.repeat_interleave(torch.arange(n, device=msgs.device),
                                  counts, output_size=m)
    plan_ms = _time_ms(lambda: kernels.segment_pieces(offsets), 5)
    plan = kernels.segment_pieces(offsets)
    got = kernels.segment_reduce(msgs, plan)
    plain = kernels.segment_reduce_plain(msgs, offsets)
    again = kernels.segment_reduce(msgs, plan)
    ms = _time_ms(lambda: kernels.segment_reduce(msgs, plan), 10)
    plain_ms = _time_ms(lambda: kernels.segment_reduce_plain(msgs, offsets),
                        2, warm=1)
    flat = msgs.reshape(m, -1)
    index_add_ms = _time_ms(lambda: torch.zeros(
        (n, k), dtype=msgs.dtype, device=msgs.device).index_add_(0, seg,
                                                                 flat), 5)
    try:
        seg_ms = _time_ms(lambda: torch.segment_reduce(
            flat, "sum", lengths=counts, axis=0), 5)
        seg_note = None
    except (RuntimeError, NotImplementedError) as e:
        seg_ms, seg_note = None, str(e)[:120]
    n_bytes = m * k * msgs.element_size() + (n + 1) * 8 + \
        n * k * msgs.element_size()
    bound_ms, bound_by = _bound(n_bytes, m * k, H100_F64_FLOPS)
    longest = int(counts.max())
    v = int(torch.argmax(counts))
    lo = int(offsets[v])
    hub = msgs[lo:lo + longest].contiguous()
    hub_off = kernels.segment_pieces(torch.tensor(
        [0, longest], dtype=torch.int64, device=msgs.device))
    hub_ms = _time_ms(lambda: kernels.segment_reduce(hub, hub_off), 20)
    hub_bound, _ = _bound(longest * k * msgs.element_size() + 16, 0)
    out = {"shape": {"rows": m, "k": k, "segments": n},
           "max_abs_err": float((got.double() - plain.double()).abs().max()),
           "bitwise_repeat": bool(torch.equal(got, again)),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": index_add_ms,
           "torch_segment_reduce_ms": seg_ms, "bytes": n_bytes,
           "share": bound_ms / ms, "pieces": plan.n_pieces,
           "pieces_ms": plan_ms, "longest_segment": longest, "longest_segment_ms": hub_ms,
           "longest_segment_bound_ms": hub_bound}
    if seg_note:
        out["torch_segment_reduce_note"] = seg_note
    _line(f"{tag}_segment_reduce", **out)
    return out


def phase_graph_pagerank(ctx):
    """Phase 63: the R-MAT graph's build, 20 PageRank iterations through
    segment_reduce (counts zeroed just before, read just after), split
    into the messages and the kernel by CUDA events, against the float64
    plain route; the personalized form; the kernel at PageRank's shape."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.graph import Graph
    from cycloneml_tpu_torch.graph import lib as glib
    from cycloneml_tpu_torch.ops import kernels
    dev = ctx.device
    (edges, draw_s) = _timed(lambda: _rmat_edges(GRAPH_LOG2, GRAPH_EDGES,
                                                 GRAPH_SEED, dev))
    n = 1 << GRAPH_LOG2
    (g, build_s) = _timed(lambda: Graph(ctx, edges[0], edges[1],
                                        n_vertices=n))
    del edges
    in_deg = torch.diff(g.by_dst.offsets)
    out_deg = torch.diff(g.by_src.offsets)
    kernels.reset_launch_counts()
    with _KernelEvents() as ev:
        (ranks, pr_s) = _timed(lambda: glib.pagerank(g, GRAPH_ITERS))
        kernel_s = ev.seconds()
    launches = kernels.segment_reduce.launches
    by_inst = {k: v for k, v in
               kernels.segment_reduce.launches_by_instance.items() if v}
    again = glib.pagerank(g, GRAPH_ITERS)
    src_v = int(torch.argmax(out_deg))
    kernels.reset_launch_counts()
    (pers, pers_s) = _timed(lambda: glib.pagerank(
        g, GRAPH_ITERS, personalized_src=src_v))
    pers_launches = kernels.segment_reduce.launches
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    try:
        (plain64, plain_s) = _timed(lambda: glib.pagerank(
            g, GRAPH_ITERS, dtype=torch.float64))
        pers64 = glib.pagerank(g, GRAPH_ITERS, personalized_src=src_v,
                               dtype=torch.float64)
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    # one iteration's parts: the messages (a gather of the scaled ranks
    # over the destination-sorted edges) and the kernel
    inv = torch.as_tensor(1.0 / np.maximum(out_deg.cpu().numpy(), 1),
                          dtype=torch.float32, device=dev)
    scaled = torch.ones(n, device=dev) * inv
    msg_ms = _time_ms(lambda: scaled[g.by_dst.src], 10)
    msgs = scaled[g.by_dst.src]
    nums = _segment_numbers(msgs, g.by_dst.offsets, "pagerank")
    rel = np.abs(ranks - plain64) / np.abs(plain64)
    pers_err = np.abs(pers - pers64)
    pers_ok = bool(np.all(pers_err <= 1e-5 * np.abs(pers64)
                          + 1e-6 * np.abs(pers64).max()))
    _line("graph_pagerank", vertices=n, edges=g.n_edges,
          rmat=list(RMAT_ABCD), draw_s=draw_s, build_s=build_s,
          max_in_degree=int(in_deg.max()), max_out_degree=int(out_deg.max()),
          isolated=int(((in_deg == 0) & (out_deg == 0)).sum()),
          iterations=GRAPH_ITERS, seconds=pr_s,
          iteration_ms=pr_s * 1e3 / GRAPH_ITERS,
          segment_reduce_device_s=kernel_s, message_ms=msg_ms,
          launches=launches, launches_by_instance=by_inst,
          personalized_src=src_v, personalized_s=pers_s,
          personalized_launches=pers_launches, plain64_s=plain_s,
          max_rel_vs_float64=float(rel.max()), rank_sum=float(ranks.sum()),
          personalized_max_abs_vs_float64=float(pers_err.max()))
    _check("graph_pagerank", {
        f"segment_reduce launched once a superstep and once for the "
        f"degrees ({GRAPH_ITERS + 1})": launches == GRAPH_ITERS + 1,
        "ranks within rtol 1e-5 of the float64 plain route":
            bool(rel.max() <= 1e-5),
        "two runs bitwise equal": bool(np.array_equal(ranks, again)),
        "personalized ranks within 1e-5 of the float64 plain route":
            pers_ok,
        "personalized launches": pers_launches == GRAPH_ITERS + 1,
        "kernel within one float rounding of the float64 plain sums":
            nums["max_abs_err"] <= 2.0 ** -23 * float(
                kernels.segment_reduce_plain(msgs, g.by_dst.offsets)
                .abs().max()),
        "kernel bitwise on a repeat": nums["bitwise_repeat"],
        "finite ranks": bool(np.all(np.isfinite(ranks)))})
    return g, {**nums, "launches": launches, "by_instance": by_inst,
               "personalized_launches": pers_launches,
               "segment_reduce_device_s": kernel_s, "message_ms": msg_ms}


def phase_graph_cc(ctx, g):
    """Phase 64: connected components and shortest paths (4 landmarks)
    on phase 63's graph through segment_reduce, against the plain route
    exactly."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.graph import lib as glib
    from cycloneml_tpu_torch.ops import kernels
    rng = np.random.RandomState(GRAPH_SEED)
    landmarks = rng.choice(g.n_vertices, GRAPH_LANDMARKS, replace=False)
    kernels.reset_launch_counts()
    ((labels, cc_it), cc_s) = _timed(
        lambda: glib.connected_components_iters(g))
    cc_launches = kernels.segment_reduce.launches
    kernels.reset_launch_counts()
    ((dist, sp_it), sp_s) = _timed(
        lambda: glib.shortest_paths_iters(g, landmarks))
    sp_launches = kernels.segment_reduce.launches
    sp_inst = {k: v for k, v in
               kernels.segment_reduce.launches_by_instance.items() if v}
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    try:
        ((p_labels, p_cc_it), p_cc_s) = _timed(
            lambda: glib.connected_components_iters(g))
        ((p_dist, p_sp_it), p_sp_s) = _timed(
            lambda: glib.shortest_paths_iters(g, landmarks))
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    comps, sizes = np.unique(labels, return_counts=True)
    reach = np.isfinite(dist)
    _line("graph_cc", cc_iterations=cc_it, cc_s=cc_s,
          cc_launches=cc_launches, components=int(len(comps)),
          largest_component=int(sizes.max()), plain_cc_s=p_cc_s,
          sp_landmarks=[int(v) for v in landmarks], sp_iterations=sp_it,
          sp_s=sp_s, sp_launches=sp_launches, sp_instances=sp_inst,
          plain_sp_s=p_sp_s, reached=[int(v) for v in reach.sum(0)],
          max_distance=float(dist[reach].max()) if reach.any() else None)
    _check("graph_cc", {
        "labels equal the plain route's": bool(np.array_equal(labels,
                                                              p_labels)),
        "distances equal the plain route's": bool(np.array_equal(dist,
                                                                 p_dist)),
        "the same iterations": cc_it == p_cc_it and sp_it == p_sp_it,
        "two launches a CC superstep": cc_launches == 2 * cc_it,
        "one launch a shortest-paths superstep": sp_launches == sp_it,
        "every label the least id of its component": bool(
            np.all(labels <= np.arange(g.n_vertices)))})
    return {"cc": cc_launches, "sp": sp_launches}


def phase_graph_svdpp(ctx, data):
    """Phase 65: SVD++ at rank 10, 10 iterations, on configuration 4's
    training ratings (users, then items, as vertices) through
    segment_reduce, twice (bitwise), against the float64 plain route."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.graph import Graph
    from cycloneml_tpu_torch.graph import lib as glib
    from cycloneml_tpu_torch.ops import kernels
    tr = data["train"]
    dev = ctx.device
    src = torch.as_tensor(data["users"][tr], device=dev)
    dst = torch.as_tensor(data["items"][tr] + ALS_USERS, device=dev)
    r = data["ratings"][tr].astype(np.float32)
    (g, build_s) = _timed(lambda: Graph(ctx, src, dst, edge_attr=r,
                                        n_vertices=ALS_USERS + ALS_ITEMS))
    del src, dst
    kw = dict(rank=SVDPP_RANK, max_iter=SVDPP_ITERS, min_val=float(r.min()),
              max_val=float(r.max()), seed=GRAPH_SEED)
    kernels.reset_launch_counts()
    with _KernelEvents() as ev:
        (m, s) = _timed(lambda: glib.svd_plus_plus(g, **kw))
        kernel_s = ev.seconds()
    launches = kernels.segment_reduce.launches
    by_inst = {k: v for k, v in
               kernels.segment_reduce.launches_by_instance.items() if v}
    again = glib.svd_plus_plus(g, **kw)
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    try:
        (m64, s64) = _timed(lambda: glib.svd_plus_plus(
            g, dtype=torch.float64, **kw))
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    rel = {k: _norm_rel(m[k], m64[k]) for k in ("p", "q", "y", "bias")}
    rmse_rel = abs(m["rmse"] - m64["rmse"]) / m64["rmse"]
    _line("graph_svdpp", users=ALS_USERS, items=ALS_ITEMS,
          ratings=g.n_edges, rank=SVDPP_RANK, iterations=SVDPP_ITERS,
          build_s=build_s, seconds=s, seconds_per_iteration=s / SVDPP_ITERS,
          segment_reduce_device_s=kernel_s, launches=launches,
          launches_by_instance=by_inst, rmse=m["rmse"],
          rmse_float64=m64["rmse"], plain64_s=s64, norm_rel=rel,
          rmse_rel=rmse_rel)
    same = all(np.array_equal(m[k], again[k]) for k in ("p", "q", "y",
                                                         "bias"))
    _check("graph_svdpp", {
        "factors within 1e-4 (norm-relative) of the float64 plain route":
            max(rel.values()) <= 1e-4,
        "RMSE within rtol 1e-4 of the float64 plain route": rmse_rel <= 1e-4,
        "two runs bitwise equal": same and m["rmse"] == again["rmse"],
        "launches: 6 a iteration, the degrees, the last sums and errors":
            launches == 6 * SVDPP_ITERS + 3,
        "finite": bool(np.isfinite(m["rmse"]))})
    return launches


def _scipy_scc_min_labels(src, dst, n):
    """Each vertex's strongly connected component labelled by its least
    vertex id, by scipy's Tarjan on the host (an independent oracle)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    a = csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, lab = connected_components(a, directed=True, connection="strong")
    least = np.full(lab.max() + 1, n, dtype=np.int64)
    np.minimum.at(least, lab, np.arange(n))
    return least[lab]


def phase_graph_dense(ctx):
    """Phase 66: triangle counts and SCC at n = 16,384 on an R-MAT graph of
    16 edges a vertex (the reach the reference's adjacency() names), and
    label propagation at n = 4,096 through segment_reduce (n-wide one-hot
    rows): triangles against a float64 product, SCC against scipy, label
    propagation against the plain route, all exactly."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.graph import Graph
    from cycloneml_tpu_torch.graph import lib as glib
    from cycloneml_tpu_torch.ops import kernels
    dev = ctx.device
    n = 1 << DENSE_LOG2
    s, d = _rmat_edges(DENSE_LOG2, n * DENSE_DEGREE, GRAPH_SEED + 1, dev)
    g = Graph(ctx, s, d, n_vertices=n)
    (tri, tri_s) = _timed(lambda: glib.triangle_count(g))
    a = g.adjacency(symmetric=True).double()
    tri64 = (torch.sum((a @ a) * a, dim=1) / 2.0).cpu().numpy()
    del a
    torch.cuda.empty_cache()
    (scc, scc_s) = _timed(lambda: glib.strongly_connected_components(g))
    scc_ref = _scipy_scc_min_labels(g._h_src, g._h_dst, n)
    nl = 1 << DENSE_LP_LOG2
    s2, d2 = _rmat_edges(DENSE_LP_LOG2, nl * DENSE_DEGREE, GRAPH_SEED + 2,
                         dev)
    gl = Graph(ctx, s2, d2, n_vertices=nl)
    kernels.reset_launch_counts()
    (lp, lp_s) = _timed(lambda: glib.label_propagation(gl))
    lp_launches = kernels.segment_reduce.launches
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    try:
        (lp_plain, lp_plain_s) = _timed(lambda: glib.label_propagation(gl))
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    torch.cuda.empty_cache()
    _line("graph_dense", n=n, edges=g.n_edges, triangles=int(tri.sum() // 3),
          max_vertex_triangles=int(tri.max()), triangle_s=tri_s,
          scc_components=int(len(np.unique(scc))), scc_s=scc_s, lp_n=nl,
          lp_edges=gl.n_edges, lp_s=lp_s, lp_plain_s=lp_plain_s,
          lp_launches=lp_launches, lp_labels=int(len(np.unique(lp))))
    _check("graph_dense", {
        "triangles equal the float64 product's": bool(np.array_equal(
            tri, tri64.astype(np.int64))) and bool(np.all(tri64 % 1 == 0)),
        "SCC labels equal scipy's": bool(np.array_equal(scc, scc_ref)),
        "label propagation equals the plain route's": bool(np.array_equal(
            lp, lp_plain)),
        "two launches a label-propagation superstep": lp_launches == 10})
    return lp_launches


def _w2v_corpus():
    """W2V_TOKENS tokens drawn from a Zipf(1) law over text8's 71,290 word
    types (numpy RandomState(25)), cut into sentences of 1,000 (Spark's
    maxSentenceLength), as an object column of token lists."""
    import numpy as np
    rng = np.random.RandomState(GRAPH_SEED)
    p = 1.0 / np.arange(1, W2V_TYPES + 1)
    ranks = rng.choice(W2V_TYPES, W2V_TOKENS, p=p / p.sum())
    words = np.array([f"w{i}" for i in range(W2V_TYPES)], dtype=object)
    toks = words[ranks]
    col = np.empty(W2V_TOKENS // W2V_SENTENCE, dtype=object)
    for i in range(len(col)):
        col[i] = toks[i * W2V_SENTENCE:(i + 1) * W2V_SENTENCE].tolist()
    return col


def phase_word2vec(ctx):
    """Phase 67: Word2Vec at text8's width (vectorSize 100, windowSize 5,
    negative 5, batches of 8,192) on 2,000,000 Zipf tokens, one epoch of
    negative sampling (twice: bitwise) and of hierarchical softmax through
    segment_reduce's accumulate form; one step against the float64 plain
    step; the HS loss against the float64 plain fit."""
    import numpy as np
    import torch
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.feature import Word2Vec
    from cycloneml_tpu_torch.ml.feature import word2vec as w2v
    from cycloneml_tpu_torch.ops import kernels
    (col, corpus_s) = _timed(_w2v_corpus)
    frame = MLFrame(ctx, {"text": col})
    kw = dict(vectorSize=W2V_DIM, windowSize=W2V_WINDOW, negative=W2V_NEG,
              minCount=5, maxIter=1, seed=GRAPH_SEED, stepSize=W2V_STEP,
              inputCol="text")
    t0 = time.perf_counter()
    vocab, counts, centers, contexts = Word2Vec(**kw)._prepare(frame)
    prep_s = time.perf_counter() - t0
    steps = -(-len(centers) // w2v.BATCH)
    out = {}
    for solver in ("ns", "hs"):
        kernels.reset_launch_counts()
        with _KernelEvents() as ev:
            (m, s) = _timed(lambda: Word2Vec(solver=solver, **kw).fit(frame))
            dev_s = ev.seconds()
        out[solver] = {"model": m, "seconds": s, "device_s": dev_s,
                       "launches": kernels.segment_reduce.launches}
    again = Word2Vec(solver="ns", **kw).fit(frame)
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    try:
        est = Word2Vec(solver="hs", **kw)
        est._dtype = torch.float64
        (hs64, hs64_s) = _timed(lambda: est.fit(frame))
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    # one negative-sampling step from a seeded state: the kernel's float32
    # step against the float64 plain step from the same values
    dev = ctx.device
    rng = np.random.RandomState(GRAPH_SEED)
    v = len(vocab)
    w_in = torch.as_tensor(((rng.rand(v, W2V_DIM) - 0.5) / W2V_DIM)
                           .astype(np.float32), device=dev)
    w_out = torch.as_tensor((rng.randn(v, W2V_DIM) * 0.01)
                            .astype(np.float32), device=dev)
    sel = torch.as_tensor(rng.permutation(len(centers))[:w2v.BATCH],
                          device=dev)
    c_idx = torch.as_tensor(centers, device=dev).long()[sel]
    o_idx = torch.as_tensor(contexts, device=dev).long()[sel]
    neg = torch.as_tensor(rng.randint(0, v, (w2v.BATCH, W2V_NEG)),
                          device=dev)
    a_in, a_out = w_in.clone(), w_out.clone()
    b_in, b_out = w_in.double(), w_out.double()
    w2v.ns_step(a_in, a_out, c_idx, o_idx, neg, W2V_STEP)
    w2v.ns_step(b_in, b_out, c_idx, o_idx, neg, W2V_STEP,
                reduce=kernels.segment_reduce_plain)
    upd = max(float((b_in - w_in.double()).abs().max()),
              float((b_out - w_out.double()).abs().max()))
    step_err = max(float((a_in.double() - b_in).abs().max()),
                   float((a_out.double() - b_out).abs().max())) / upd
    # the accumulate form at the negatives' shape: ms, bound, yardsticks
    perm, offsets = kernels.segment_order(neg.reshape(-1), v)
    upd_rows = torch.randn(neg.numel(), W2V_DIM, device=dev)
    w_t = w_out.clone()
    acc_ms = _time_ms(lambda: kernels.segment_reduce(
        upd_rows, offsets, rows=perm, out=w_t), 20)
    idx_ms = _time_ms(lambda: w_t.index_add_(0, neg.reshape(-1), upd_rows),
                      20)
    rows_touched = int((torch.diff(offsets) > 0).sum())
    acc_bound, _ = _bound(upd_rows.numel() * 4 + neg.numel() * 8
                          + (v + 1) * 8 + 2 * rows_touched * W2V_DIM * 4, 0)
    ns, hs = out["ns"], out["hs"]
    loss_rel = abs(hs["model"].training_loss_[0]
                   - hs64.training_loss_[0]) / abs(hs64.training_loss_[0])
    _line("word2vec", tokens=W2V_TOKENS, word_types=W2V_TYPES,
          vocabulary=len(vocab), min_count=5, pairs=len(centers),
          steps=steps, corpus_s=corpus_s, vocab_and_pairs_s=prep_s,
          ns={"seconds": ns["seconds"], "steps_s": ns["seconds"] - prep_s,
              "segment_reduce_device_s": ns["device_s"],
              "launches": ns["launches"]},
          hs={"seconds": hs["seconds"], "steps_s": hs["seconds"] - prep_s,
              "segment_reduce_device_s": hs["device_s"],
              "launches": hs["launches"],
              "loss": hs["model"].training_loss_[0],
              "loss_float64_plain": hs64.training_loss_[0],
              "plain64_s": hs64_s},
          one_step_err_over_update=step_err, step_update_max=upd,
          accumulate={"rows": neg.numel(), "dim": W2V_DIM,
                      "rows_touched": rows_touched, "ms": acc_ms,
                      "bound_ms": acc_bound, "index_add_ms": idx_ms})
    _check("word2vec", {
        "three accumulate launches a negative-sampling step":
            ns["launches"] == 3 * steps,
        "two accumulate launches a hierarchical-softmax step":
            hs["launches"] == 2 * steps,
        "two fits bitwise equal": bool(np.array_equal(
            ns["model"].vectors, again.vectors)),
        "one step within 1e-6 of the float64 plain step (of the update)":
            step_err <= 1e-6,
        "HS loss within 1e-3 of the float64 plain fit": loss_rel <= 1e-3,
        "finite vectors": bool(np.all(np.isfinite(ns["model"].vectors)))})
    return {"ns": ns["launches"], "hs": hs["launches"], "accumulate_ms":
            acc_ms, "accumulate_bound_ms": acc_bound,
            "accumulate_index_add_ms": idx_ms}


def _adult_frame(ctx):
    """ADULT_N rows with UCI Adult's schema: 6 numeric columns (age,
    fnlwgt, education-num, capital-gain, capital-loss, hours-per-week,
    drawn near Adult's ranges) and 8 categorical string columns with
    Adult's cardinalities (workclass 9, education 16, marital-status 7,
    occupation 15, relationship 6, race 5, sex 2, native-country 42),
    values drawn with Zipf-like frequencies; the label from a seeded
    logistic model of both (numpy RandomState(26))."""
    import numpy as np
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    rng = np.random.RandomState(26)
    n = ADULT_N
    num = {"age": rng.randint(17, 91, n).astype(np.float64),
           "fnlwgt": np.exp(rng.normal(12.0, 0.6, n)),
           "education_num": rng.randint(1, 17, n).astype(np.float64),
           "capital_gain": np.where(rng.rand(n) < 0.08,
                                    np.exp(rng.normal(8.0, 1.0, n)), 0.0),
           "capital_loss": np.where(rng.rand(n) < 0.05,
                                    np.exp(rng.normal(7.4, 0.3, n)), 0.0),
           "hours_per_week": np.clip(rng.normal(40, 12, n), 1, 99)}
    margin = (0.04 * (num["age"] - 38) + 0.3 * (num["education_num"] - 10)
              + 0.0003 * num["capital_gain"] + 0.03
              * (num["hours_per_week"] - 40) - 1.2)
    cols = dict(num)
    for j, card in enumerate(ADULT_CARD):
        p = 1.0 / np.arange(1, card + 1)
        codes = rng.choice(card, n, p=p / p.sum())
        effect = rng.normal(0, 0.5, card)
        margin = margin + effect[codes]
        names = np.array([f"c{j}_{v}" for v in range(card)], dtype=object)
        cols[f"cat{j}"] = names[codes]
    cols["label"] = (rng.rand(n) < 1.0 / (1.0 + np.exp(-margin))).astype(
        np.float64)
    return MLFrame(ctx, cols)


def phase_features(ctx):
    """Phase 68: StringIndexer -> OneHotEncoder -> VectorAssembler ->
    StandardScaler -> UnivariateFeatureSelector -> LogisticRegression (on
    K1) on 1,000,000 rows of Adult's schema, each stage's seconds; the
    model against the plain route's within the main path's limits."""
    import numpy as np
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ml.feature import (
        OneHotEncoder, StandardScaler, StringIndexer,
        UnivariateFeatureSelector, VectorAssembler)
    from cycloneml_tpu_torch.ops import kernels
    (frame, data_s) = _timed(lambda: _adult_frame(ctx))
    secs = {}
    t0 = time.perf_counter()
    for j in range(len(ADULT_CARD)):
        frame = StringIndexer(inputCol=f"cat{j}", outputCol=f"idx{j}") \
            .fit(frame).transform(frame)
    secs["string_indexer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = OneHotEncoder(
        input_cols=[f"idx{j}" for j in range(len(ADULT_CARD))],
        output_cols=[f"oh{j}" for j in range(len(ADULT_CARD))]) \
        .fit(frame).transform(frame)
    secs["one_hot_encoder"] = time.perf_counter() - t0
    numeric = ["age", "fnlwgt", "education_num", "capital_gain",
               "capital_loss", "hours_per_week"]
    t0 = time.perf_counter()
    frame = VectorAssembler(
        input_cols=numeric + [f"oh{j}" for j in range(len(ADULT_CARD))],
        output_col="raw").transform(frame)
    secs["vector_assembler"] = time.perf_counter() - t0
    (frame, secs["standard_scaler"]) = _timed(lambda: StandardScaler(
        withMean=True, inputCol="raw", outputCol="scaled").fit(frame)
        .transform(frame))
    (sel, secs["univariate_selector_fit"]) = _timed(
        lambda: UnivariateFeatureSelector(
            featureType="continuous", labelType="categorical",
            numTopFeatures=50, inputCol="scaled", outputCol="features")
        .fit(frame))
    (frame, secs["univariate_selector_transform"]) = _timed(
        lambda: sel.transform(frame))
    kernels.reset_launch_counts()
    lr = dict(maxIter=25, regParam=0.01, tol=0.0)
    (model, secs["logistic_regression"]) = _timed(
        lambda: LogisticRegression(**lr).fit(frame))
    k1 = kernels.glm_sweep.launches_by_link[kernels.LOGISTIC]
    ctx.conf.set("cyclone.ml.usePallasKernels", "false")
    try:
        (plain, plain_s) = _timed(lambda: LogisticRegression(**lr)
                                  .fit(frame))
    finally:
        ctx.conf.set("cyclone.ml.usePallasKernels", "auto")
    ks, ps = model.summary, plain.summary
    kc, pc = model.coefficients.values, plain.coefficients.values
    obj_rel = abs(ks.objective_history[-1] - ps.objective_history[-1]) \
        / abs(ps.objective_history[-1])
    d_raw = frame["raw"].shape[1]
    _line("features", rows=ADULT_N, numeric=ADULT_NUMERIC,
          categorical=list(ADULT_CARD), raw_width=d_raw,
          selected=len(sel.selected_features), data_s=data_s,
          stage_seconds=secs, plain_lr_s=plain_s, k1_launches=k1,
          evals=ks.total_evals, iterations=ks.total_iterations,
          objective_rel_diff=obj_rel,
          max_abs_coef_diff=float(np.max(np.abs(kc - pc))),
          positives=float(frame["label"].mean()))
    _check("features", {
        "one-hot width: 6 numeric + sum(cardinality - 1)":
            d_raw == ADULT_NUMERIC + sum(c - 1 for c in ADULT_CARD),
        "K1 launched once per evaluation": k1 == ks.total_evals,
        "coefficients within rtol 5e-3, atol 5e-4 of the plain route's":
            _close(kc, pc, model.intercept, plain.intercept),
        "final objectives agree to 1e-4": obj_rel <= 1e-4,
        "finite model": bool(np.all(np.isfinite(kc)))})
    return k1


def phase_graphx_and_features(als_data):
    """Phases 63-68 on one context: returns what the kernels line needs."""
    import torch
    ctx = _context("chip_smoke_graphx")
    try:
        g, pr = phase_graph_pagerank(ctx)
        cc = phase_graph_cc(ctx, g)
        del g
        torch.cuda.empty_cache()
        svdpp = phase_graph_svdpp(ctx, als_data)
        torch.cuda.empty_cache()
        lp = phase_graph_dense(ctx)
        w2v = phase_word2vec(ctx)
        torch.cuda.empty_cache()
        k1 = phase_features(ctx)
    finally:
        ctx.stop()
    torch.cuda.empty_cache()
    return {"pagerank": pr, "cc": cc, "svdpp": svdpp, "lp": lp,
            "w2v": w2v, "features_k1": k1}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import cycloneml_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout: the cycloneml_tpu_torch "
              "package is not beside this script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cycloneml_tpu_torch.ops import kernels
    t_start = time.perf_counter()
    _time_phases()
    card, kind = phase_card()
    ptxas = phase_build()
    # spill bytes (stores plus loads) of every kernel of ell_sweep
    ell_spills = {f: sum(int(v) for ln in lines
                         for v in re.findall(r"(\d+) bytes spill", ln))
                  for f, lines in ptxas.items() if "ell_" in f}
    _line("ell_ptxas_spills", **ell_spills)
    _check("ell ptxas", {"0 spill bytes in every ell_sweep kernel":
                         bool(ell_spills) and not any(ell_spills.values())})
    entries = []

    def entry(name, source, replaces, numbers, launches, **extra):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"cycloneml_tpu_torch/csrc/{source}.cu",
            "replaces": replaces if isinstance(replaces, str)
            else f"cycloneml_tpu/ops/kernels.py:{replaces}",
            "launches": launches, "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers.get("library_ms"),
            "yardstick_ms": numbers.get("yardstick_ms"), "card": card,
            **extra})

    def redesigned(numbers, *kernels_run, how="tensor cores, wgmma"):
        """The fields of a kernel redesigned for the tensor cores: the
        redesign, its f32-FMA bound and rate reference, and ptxas's lines
        for the kernels it runs."""
        keep = ("f32_fma_bound_ms", "library_bf16_rate_ms",
                "library_f32_xtx_ms", "instance")
        return {"redesigned": how,
                **{k: numbers[k] for k in keep if k in numbers},
                "ptxas": {f: ptxas.get(f) for f in ptxas
                          if f.startswith(kernels_run)
                          and "cluster=" not in f}}

    def sweep(numbers, dtype, d, link, how=None):
        """The fields of a GLM sweep entry: the main shape's instance, its
        ring plan and ptxas's lines, and the redesign where it was one."""
        inst = f"glm_sweep_kernel<{dtype}, E={8 * -(-d // 256)}, {link}>"
        out = {"instance": inst, **numbers["plan"],
               "ptxas": {f: ptxas.get(f) for f in ptxas if f == inst}}
        return {**out, "redesigned": how} if how else out

    ring = "per-lane cp.async row ring, gradient summed in row blocks"
    k1 = phase_kernel()
    entry("glm_sweep (logistic, K1)", "glm_sweep", 270, k1, phase_fit(),
          **sweep(k1, "bf16", FIT_D, "logistic"))
    k2 = phase_k2()
    k2_launches, k2_objective, lin_model = phase_linreg()
    entry("glm_sweep (squared, K2)", "glm_sweep", 226, k2, k2_launches,
          **sweep(k2, "bf16", LIN_D, "squared", ring))
    k3 = phase_k3()
    km_launches, sum_launches, sums = phase_kmeans()
    entry("kmeans_assign (K3)", "kmeans_assign", 384, k3, km_launches,
          **redesigned(k3, "kmeans_assign_tc_kernel<bf16",
                       "kmeans_redecide_kernel<bf16"))
    k4 = phase_k4()
    entry("gramian (K4)", "gramian", 461, k4, phase_pca(),
          **redesigned(k4, "gramian_tc_kernel<bf16",
                       "gramian_reduce_kernel"))
    # the fp8 rung: e4m3 codes with the x_scale operand (:309, :422, :501)
    k1 = phase_kernel(fp8=True)
    entry("glm_sweep (logistic, K1, e4m3)", "glm_sweep", 309, k1,
          phase_fp8_fit(), **sweep(k1, "e4m3", FIT_D, "logistic", ring))
    k2 = phase_k2(fp8=True)
    entry("glm_sweep (squared, K2, e4m3)", "glm_sweep", 309, k2,
          phase_fp8_linreg(), **sweep(k2, "e4m3", LIN_D, "squared", ring))
    # KMeans and PCA are not fp8-capable (they take the bf16 rung under the
    # fp8 tiers), so no fit launches these two instances: their wrappers
    # are held at the fits' shapes above, and their launches are 0
    no_path = {"main_path": "none: KMeans and RowMatrix/PCA take the bf16 "
               "rung under the fp8 tiers"}
    k3 = phase_k3(fp8=True)
    entry("kmeans_assign (K3, e4m3)", "kmeans_assign", 422, k3, 0,
          **no_path, **redesigned(k3, "kmeans_assign_tc_kernel<e4m3",
                                  "kmeans_redecide_kernel<e4m3"))
    k4 = phase_k4(fp8=True)
    entry("gramian (K4, e4m3)", "gramian", 501, k4, 0, **no_path,
          **redesigned(k4, "gramian_tc_kernel<e4m3",
                       "gramian_reduce_kernel"))
    # the stacked slice: K1s, OneVsRest and CrossValidator through it
    k1s = phase_k1s()
    ovr_launches, ovr8_launches, ovr_models = phase_ovr()
    entry("glm_sweep_stacked (logistic, K models, K1s)", "glm_stacked", 270,
          k1s, ovr_launches, models=OVR_K,
          vmapped_by="cycloneml_tpu/ml/optim/aggregators.py:394",
          cv_fit_launches=phase_cv(),
          yardstick="K serial launches of K1",
          yardstick_two_f32_gemm_ms=k1s["yardstick_two_f32_gemm_ms"],
          **redesigned(k1s, "glm_stacked_tc_kernel<bf16",
                       how="tensor cores, mma.sync"))
    k1s8 = phase_k1s(fp8=True)
    entry("glm_sweep_stacked (K1s, e4m3)", "glm_stacked", 309, k1s8,
          ovr8_launches, models=OVR_K,
          yardstick="K serial launches of K1 (e4m3)",
          yardstick_two_f32_gemm_ms=k1s8["yardstick_two_f32_gemm_ms"],
          **redesigned(k1s8, "glm_stacked_tc_kernel<e4m3",
                       how="tensor cores, mma.sync"))
    entry("center_sums (KMeans center update)", "center_sums",
          "cycloneml_tpu/ml/clustering/kmeans.py:122", sums, sum_launches,
          instance=kernels.center_sums_instance(KM_K),
          redesigned="a stable counting sort written for the card in "
                     "place of torch.sort (int32 order), then one warp a "
                     "piece reading whole rows, 8-byte loads a lane, the "
                     "weights column in the same warp",
          **{f: sums[f] for f in ("sorted_ms", "counting_sort_ms",
                                  "device_ms", "working_mem_mib",
                                  "sorted_working_mem_mib")},
          ptxas={f: v for f, v in ptxas.items()
                 if f.startswith(("center_", "count_"))},
          note="jax.ops.segment_sum of the Lloyd step, not a Pallas "
               "kernel; library_ms is the index_add_ update it replaced; "
               "sorted_ms: the sorted instance (torch.sort, then the "
               "same sums) in the same run")
    # the rest of the dense linear family: no new kernel; K1 carries the
    # bounded fit, the other four paths launch none
    phase_wls(k2_objective)
    entries[0]["bounded_fit_launches"] = phase_bounded()   # K1's entry
    mn_model = phase_multinomial(ovr_models)
    phase_svc()
    phase_glm()
    # the sparse tier: S1 and S2 carry the Criteo-class fit (the main
    # path) and configuration 5's Lanczos matvec
    crit = phase_criteo()
    nyt = phase_config5()
    phase_rowmatrix()
    # the wide slice: K1, K2 and K1s past d = 2,048, their fits, and the
    # sparse intercept's inquiry
    wide = phase_wide_kernel()
    wide_k1s = phase_wide_k1s()
    wide_fit = phase_wide_fit()
    wide_lin = phase_wide_linreg()
    cifar, cifar_models = phase_cifar_ovr()
    phase_criteo_seeds()
    # ALS at configuration 4: the normal equations' kernel, then the
    # explicit, implicit and nonnegative fits through it
    als_data = _als_data()
    als_nums = phase_als_normal(als_data, ptxas)
    als_launches = phase_als_fit(als_data)
    als_implicit_launches = phase_als_implicit(als_data)
    # data in and models out: the readers onto the card, the fits on read
    # data, persistence; files in a temporary directory, always removed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        disk = shutil.disk_usage(tmp)
        _line("ingest_disk", path=tmp, free_bytes=disk.free,
              total_bytes=disk.total)
        ingest_sparse = phase_ingest_criteo(tmp)
        ingest_dense = phase_ingest_dense(tmp)
        persisted = phase_persistence(tmp)
        # out-of-core streamed fits: shards on disk, K1/K2/K1s once a
        # shard; each phase's spill directory removed at its end
        stream_k1, stream_model = phase_stream_lr(tmp)
        stream_k2 = phase_stream_file(ingest_dense.pop("npy"),
                                      ingest_dense.pop("linreg"), tmp)
        degrade_k1 = phase_stream_degrade(tmp, stream_model)
        stream_e4m3 = phase_stream_fp8(tmp, stream_model)
        stream_k1s = phase_stream_ovr(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the BLAS boundary and the distributed matrices, then the rest of the
    # clustering family: BisectingKMeans through the center sums, PIC
    # through S2, GaussianMixture and LDA on torch products
    phase_blas()
    bkm_launches, bkm_sums = phase_bisecting()
    phase_gmm()
    phase_lda()
    pic_launches, pic_s2 = phase_pic()
    # model serving: the fitted models behind ModelServer, each bucket one
    # CUDA graph over the serving-margins kernel; counts zeroed just
    # before the traffic and read just after
    serve = phase_serving(ovr_models, mn_model, lin_model, cifar_models)
    # the holes in files counted as ported: evaluate, placement, the
    # runtime core, the precision key
    holes = phase_holes()
    # checkpointed training and the storage tiers: K1 in a checkpointed,
    # crashed and resumed LR fit, als_normal in a resumed ALS fit, K1 in a
    # fit under a device budget; files in a temporary directory, removed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_checkpoint_")
    try:
        ck_lr = phase_checkpoint_lr(tmp)
        ck_als = phase_checkpoint_als(als_data, tmp)
        tier_k1 = phase_storage_tiers(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # trees at HIGGS's shape through tree_hist, then the rest of MLlib's
    # models (no kernel of their own), each against its float64 fit
    dt, rf, gbt, dtr = phase_trees()
    phase_mlp()
    phase_naive_bayes()
    phase_fm()
    phase_aft_isotonic()
    # GraphX and the feature transformers: segment_reduce carries the graph
    # library's merges and Word2Vec's updates; SVD++ on configuration 4's
    # ratings, then the features' pipeline into K1
    gx = phase_graphx_and_features(als_data)
    del als_data
    how = ("one read of X: a CTA of 512 threads an SM, each "
           "thread's slots of G rows staged once by its own cp.async ring "
           "slots, margins by xor shuffles then the warps in warp order, "
           "the link on one lane a row, the gradient from the same slots; "
           "the two-pass instance past d = 12288")
    for link, line, launches, what in (
            (kernels.LOGISTIC, 270, wide_fit, "K1"),
            (kernels.SQUARED, 226, wide_lin, "K2")):
        nums = wide[link]
        inst = f"glm_sweep_wide_kernel<bf16, E=8, {link}>"
        entry(f"glm_sweep ({link}, {what}, wide: d > 2048)", "glm_sweep",
              line, nums, launches, shape=[WIDE_N, WIDE_D], dtype="bf16",
              plan=nums["plan"], redesigned=how,
              two_pass_ms=nums["two_pass_ms"],
              by_dtype={dt: {k: t[k] for k in ("n", "d", "ms", "two_pass_ms",
                                                "plain_ms", "bound_ms",
                                                "yardstick_ms")}
                        for dt, t in nums["by_dtype"].items()},
              yardstick="two cuBLAS gemvs in X's dtype",
              ptxas={f: v for f, v in ptxas.items()
                     if f.startswith("glm_sweep_wide_kernel")},
              main_instance=inst)
    entry("glm_sweep_stacked (K1s, wide: d > 2048)", "glm_stacked", 270,
          wide_k1s, cifar, models=8, shape=[CIFAR_N, CIFAR_D],
          dtype="bf16", vmapped_by="cycloneml_tpu/ml/optim/aggregators.py:394",
          redesigned="one read of X: the narrow tensor-core kernel on a "
                     "cluster of 4 CTAs (8 past d = 4096), each with a "
                     "column slice of X and of B's three parts, the tile's "
                     "partial margins summed in rank order through "
                     "distributed shared memory; 16 models a launch; the "
                     "two-pass instance for f32 X and past d = 8192",
          two_pass_ms=wide_k1s["two_pass_ms"],
          device_ms=wide_k1s["device_ms"],
          yardstick="X B^T plus M^T X in X's dtype",
          times=wide_k1s["times"],
          ptxas={f: v for f, v in ptxas.items() if "cluster=" in f
                 or f.startswith(("glm_wide_tc", "glm_wide_fma",
                                  "glm_wide_reduce"))})
    sparse = "cycloneml_tpu/ml/optim/sparse_aggregators.py"
    ell_ptxas = {f: ptxas.get(f) for f in ptxas if f.startswith("ell_")}
    keep = ("bound_with_sector_gathers_ms", "turns_ms")
    entry("ell_rows (S1, the sparse row pass)", "ell_sweep",
          f"{sparse}:34", crit["s1"], crit["s1_launches"],
          config5_launches=nyt["s1_launches"], ptxas=ell_ptxas,
          redesigned="flat reads of a warp's 32 rows (16-byte loads, every "
                     "lane busy), 32-warp CTAs sharing a shared-memory "
                     "table of the hot columns' coefficients",
          hot_slots=crit["s1"]["hot_slots"],
          hot_share=crit["s1"]["hot_share"],
          **{f: crit["s1"][f] for f in keep},
          yardstick="cuSPARSE CSR SpMV X beta (the margins alone)",
          note="jnp.take gathers and the link, not a Pallas kernel; "
               "turns_ms: kernel, yardstick, yardstick, kernel")
    entry("ell_cols (S2, the sparse column pass)", "ell_sweep",
          f"{sparse}:40", crit["s2"], crit["s2_launches"],
          config5_launches=nyt["s2_launches"],
          moments_ms=crit["s2"]["moments_ms"],
          redesigned="a copy of the nonzeros in (row block, column, row) "
                     "order: the pieces in flight gather one block's "
                     "slice of mult from L2",
          block_rows=crit["s2"]["block_rows"], blocks=crit["s2"]["blocks"],
          pieces=crit["s2"]["pieces"],
          piece_metadata_bytes=crit["s2"]["piece_metadata_bytes"],
          one_block_ms=crit["s2"]["one_block_ms"],
          one_block_turns_ms=crit["s2"]["one_block_turns_ms"],
          **{f: crit["s2"][f] for f in keep},
          note="jax.ops.segment_sum, not a Pallas kernel; library_ms is "
               "cuSPARSE CSR SpMV X^T r over a copy in plain column "
               "order; turns_ms: kernel, library, library, kernel; "
               "one_block_ms: the same kernel over the copy in plain "
               "column order (one block), in turns with the blocked copy")
    entry("als_normal (ALS normal equations)", "als_normal",
          "cycloneml_tpu/ml/recommendation/als.py:490", als_nums,
          als_launches, implicit_fit_launches=als_implicit_launches,
          shape={"n_dst": als_nums["n_dst"], "n_src": als_nums["n_src"],
                 "ratings": als_nums["ratings"], "rank": ALS_RANK},
          dtype="f32", device_ms=als_nums["device_ms"],
          device_ms_by=als_nums["device_ms_by"],
          redesigned="tensor cores, mma.sync m16n8k8 3xTF32: one CTA of "
                     "3 warps a piece over the whole upper triangle (32 x "
                     "32 warp tiles), each row gathered once by cp.async "
                     "into a 2-stage ring, b as an n8 column, the epilogue "
                     "through shared memory with coalesced 16-byte stores",
          fma_ms=als_nums["fma_ms"], turns_ms=als_nums["turns_ms"],
          share=als_nums["share"],
          f32_fma_bound_ms=als_nums["f32_fma_bound_ms"],
          tc_operations=als_nums["tc_operations"],
          fma_operations=als_nums["fma_operations"], bytes=als_nums["bytes"],
          items=als_nums["items"], implicit_ms=als_nums["implicit_ms"],
          yardstick="torch.bmm of the zero-padded gathered source rows "
                    "(n_dst, most ratings, r), f32, TF32 off, the gather "
                    "not counted", yardstick_shape=als_nums["yardstick_shape"],
          ptxas=als_nums["ptxas"],
          note="the reference's chunked scatter-add of outer products "
               "(jnp, not a Pallas kernel); ms, bound and plain_ms are "
               "the users' half-step, explicit; bound: the tensor cores' "
               "(bytes, or the 3xTF32 products at the TF32 rate), share "
               "against it only; fma_ms: the earlier FMA design (instance="
               "fma) in turns in the same run, beside f32_fma_bound_ms; "
               "launches: 2 a iteration")
    # this slice's paths, each with its counts zeroed just before it: the
    # fits on read data and the Pipeline's
    slice17 = {"glm_sweep (logistic, K1)": {
                   "libsvm_fit_launches": ingest_dense["k1"],
                   "pipeline_fit_launches": persisted["k1"]},
               "glm_sweep (squared, K2)": {
                   "npy_fit_launches": ingest_dense["k2"]},
               "gramian (K4)": {"pipeline_fit_launches": persisted["k4"]},
               "ell_rows (S1, the sparse row pass)": {
                   "ingest_fit_launches": ingest_sparse["s1"]},
               "ell_cols (S2, the sparse column pass)": {
                   "ingest_fit_launches": ingest_sparse["s2"]}}
    # the streamed paths (phases 40-44), each with its counts zeroed just
    # before it: K1, K2, K1 e4m3 and K1s once a shard
    slice18 = {"glm_sweep (logistic, K1)": {
                   "streamed_fit_launches": stream_k1,
                   "degraded_fit_launches": degrade_k1},
               "glm_sweep (squared, K2)": {
                   "streamed_file_fit_launches": stream_k2},
               "glm_sweep (logistic, K1, e4m3)": {
                   "streamed_fit_launches": stream_e4m3},
               "glm_sweep_stacked (logistic, K models, K1s)": {
                   "streamed_ovr_launches": stream_k1s}}
    # this slice's paths (phases 46 and 49), each with its counts zeroed
    # just before it
    slice19 = {"center_sums (KMeans center update)": {
                   "bisecting_fit_launches": bkm_launches,
                   "bisecting_replaces": "cycloneml_tpu/ml/clustering/"
                                         "bisecting_kmeans.py:125-149",
                   "bisecting_k64": bkm_sums},
               "ell_cols (S2, the sparse column pass)": {
                   "pic_launches": pic_launches,
                   "pic_replaces": "cycloneml_tpu/ml/clustering/"
                                   "power_iteration.py:107",
                   "pic_step": pic_s2}}
    entry("serving_margins (model serving, linear margins)",
          "serving_margins", "cycloneml_tpu/serving/servable.py:67", serve,
          serve["launches"], launches_by_instance=serve[
              "launches_by_instance"],
          instances=serve["instances"], shape={
              "models": OVR_K, "margins": 1, "d": FIT_D,
              "bucket": SERVE_BATCH, "dtype": "f32"},
          graph_ms=serve["graph_ms"], eager_ms=serve["eager_ms"],
          device_ms=serve["device_ms"], times=serve["times"],
          yardstick="torch.matmul(x, coef.T), f32, TF32 off",
          redesigned="tiles of request rows by margin rows staged through "
                     "shared memory by cp.async.bulk onto mbarriers (X "
                     "read once a margin tile, the coefficients once a "
                     "row tile), or one warp an output streaming its rows "
                     "where that measured faster (e4m3 codes always); the "
                     "layout and tile picked a launch by a rule "
                     "(kernels.serving_margins_plan)",
          plans=serve["plans"], large_buckets=serve["large_buckets"],
          holes=holes,
          ptxas={f: v for f, v in ptxas.items()
                 if f.startswith(("serving_margins_kernel",
                                  "serving_direct_kernel"))},
          note="the reference's jnp linear_margins family (servable.py:67, "
               ":80, :88, :104), not a Pallas kernel; launches: graph "
               "replays in the traffic, one a dispatch; ms, plain_ms and "
               "library_ms (torch.addmm of the intercepts, the rows and "
               "the coefficients) at the OneVsRest gang's bucket 64, by "
               "CUDA events over back-to-back calls (the host's launch "
               "path paces them); device_ms: the kernel's device time a "
               "launch in a CUDA graph of 50 launches, by events; bound: "
               "launch-bound, the bytes well under a microsecond; "
               "graph_ms and eager_ms: the three steps of a dispatch (copy "
               "in, kernel, copy out) as the captured graph and as eager "
               "launches")
    # this slice's paths (phases 52-54), each with its counts zeroed just
    # before it
    slice22 = {"glm_sweep (logistic, K1)": {
                   "checkpointed_fit_launches": ck_lr["full"],
                   "resumed_fit_launches": ck_lr["resumed"],
                   "fallback_fit_launches": ck_lr["fallback"],
                   "budgeted_fit_launches": tier_k1},
               "als_normal (ALS normal equations)": {
                   "resumed_fit_launches": ck_als}}
    for e in entries:
        e.update(slice17.get(e["name"], {}))
        e.update(slice18.get(e["name"], {}))
        e.update(slice19.get(e["name"], {}))
        e.update(slice22.get(e["name"], {}))
    lv = dt["level0"]
    entry("tree_hist (decision-tree level histogram)", "tree_hist",
          "cycloneml_tpu/ml/tree/impl.py:451", lv, dt["launches"],
          launches_by_phase={"dt": dt["launches"], "rf": rf["launches"],
                             "gbt": gbt["launches"],
                             "dt_regressor": dtr["launches"]},
          launches_by_instance={"dt": dt["by_instance"],
                                "rf": rf["by_instance"],
                                "gbt": gbt["by_instance"],
                                "dt_regressor": dtr["by_instance"]},
          shape=lv["shape"], sort_ms=lv["sort_ms"], share=lv["share"],
          bound_bytes=lv["bound_bytes"],
          bound_int32_bins_ms=lv["bound_int32_bins_ms"],
          bins_dtype=lv["bins_dtype"], plan=lv["plan"],
          design_bytes=lv["design_bytes"],
          design_bound_ms=lv["design_bound_ms"], rf_level0={
              k: rf["level0"][k] for k in (
                  "ms", "plain_ms", "sort_ms", "bound_ms",
                  "bound_int32_bins_ms", "share", "design_bound_ms",
                  "max_abs_err", "plan", "shape")},
          by_level={"dt": dt["levels"], "rf": rf["levels"],
                    "gbt": gbt["levels"], "dt_regressor": dtr["levels"]},
          wide_checks=[{k: c[k] for k in (
              "max_bins", "B", "C", "bins_dtype", "a_pad", "instance",
              "launches_by_instance", "ms", "bound_ms", "share",
              "counts_exact", "max_rel")} for c in dt["wide"]],
          ptxas={f: v for f, v in ptxas.items()
                 if f.startswith("tree_")},
          redesigned="a lane a row: one CTA a (piece, feature block), lane "
                     "l of a half warp adding rows l, l + 16, ... into its "
                     "own shared-memory copy of its feature's table "
                     "([bin][channel][32 slots], no bank conflicts, no "
                     "atomics), 16 lane copies summed in a fixed slot order "
                     "into doubles every 2,048 rows; one-byte bins; the "
                     "keys and the piece table built on the card; the "
                     "lane-a-bin design for widths whose copies do not fit",
          note="the reference's scatter-add of the level histogram "
               "(jnp, not a Pallas kernel); ms, plain_ms, library_ms and "
               "bound at the DecisionTree's level 0 (one tree, every row at "
               "node 0): the function's time (the keys, the counting "
               "sort, the piece table, the pieces and the reduce) by CUDA "
               "events; bound_ms with the bins at their stored width, "
               "bound_int32_bins_ms at int32 (the first design's); "
               "library_ms index_add_ over the same flat keys; by_level: "
               "[launches, ms a call] by a_pad in the timed fit")
    pr = gx["pagerank"]
    entry("segment_reduce (graph messages, Word2Vec updates)",
          "segment_reduce", "cycloneml_tpu/graph/graph.py:143", pr,
          pr["launches"], launches_by_phase={
              "pagerank": pr["launches"],
              "pagerank_personalized": pr["personalized_launches"],
              "connected_components": gx["cc"]["cc"],
              "shortest_paths": gx["cc"]["sp"],
              "svd_plus_plus": gx["svdpp"], "label_propagation": gx["lp"],
              "word2vec_ns": gx["w2v"]["ns"], "word2vec_hs": gx["w2v"]["hs"]},
          launches_by_instance=pr["by_instance"],
          also_replaces=["cycloneml_tpu/ml/feature/word2vec.py:125-127",
                         "cycloneml_tpu/ml/feature/word2vec.py:190-191"],
          shape=pr["shape"], share=pr["share"], bytes=pr["bytes"],
          torch_segment_reduce_ms=pr["torch_segment_reduce_ms"],
          longest_segment=pr["longest_segment"],
          longest_segment_ms=pr["longest_segment_ms"],
          longest_segment_bound_ms=pr["longest_segment_bound_ms"],
          pagerank_device_s=pr["segment_reduce_device_s"],
          pagerank_message_ms=pr["message_ms"],
          word2vec_accumulate={k: gx["w2v"][k] for k in (
              "accumulate_ms", "accumulate_bound_ms",
              "accumulate_index_add_ms")},
          features_k1_launches=gx["features_k1"],
          ptxas={f: v for f, v in ptxas.items()
                 if f.startswith("segment_")},
          note="jax.ops.segment_sum/min/max of the graph's message merge "
               "and Word2Vec's .at[].add scatters, not Pallas kernels; ms, "
               "plain_ms, library_ms (index_add_ in float32, run-dependent "
               "order) and bound at PageRank's messages (one float a "
               "destination-sorted edge); launches: the main path's 20 "
               "supersteps and the degrees")
    print(json.dumps({"kernels": entries}), flush=True)
    _line("phase_seconds", **_PHASE_SECONDS)
    _line("wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        # the phases that ran, for a run that stopped at a failed check
        _line("phase_seconds", **_PHASE_SECONDS)
        raise
    sys.exit(rc)

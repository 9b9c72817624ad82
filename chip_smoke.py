#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pyabc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--log FILE]
    python3 chip_smoke.py --turns k2|lv PARENT_DIR

(``--log FILE`` also appends every line to FILE, for runs whose output is
cut. ``--turns`` times one thing in turns against another tree's (say the
parent commit's), whose ``pyabc_tpu_torch`` lies in PARENT_DIR: ``k2``
K2's register counts and its LV config 2 time, ``lv`` LV config 2's
accepted particles / s, three runs a process. ``--mesh-rank RANK WIDTH RDV OUT
DEVICE LEG...`` is one rank of a mesh leg, started by the script itself.)
Phases, one or more lines each:

1. the card (name and power limit from nvidia-smi), torch and CUDA
   versions, the compute capability (must be 9.0) and the kernel build;
2. every hand-written kernel (K2 with K1, K3-K11) against its plain
   PyTorch version on the card, at the main-path shapes of BASELINE config
   2 (B = 4096 lanes, n_cap = 1024, d = 4, S = 40, the record ring 8192
   rows, a chunk of G = 8 generations) and, for K2 and K7-K11, at a second
   shape (d = 1, n_cap = 64, an odd valid count); K7's normalization and
   quantile epsilon in each of their modes (block, cluster, passes) at n
   64 to 131073; then K20 (SIR), K21a
   (noise kernel + stochastic accept), K21b (pdf norm + temperature) and
   K6's record mode at the shapes of BASELINE config 4 (B = 4096, n_cap =
   1024, d = 2, S = 15, the ring 8192 rows) and at a small odd shape; then
   K20b (the ODE family), K26 (the model step) and the K > 1 modes of K2,
   K3, K5, K6, K8, K10 and K11 at the shapes of BASELINE config 5 (B =
   4096, n_cap = 1024, K = 3, d_max = 2, S = 12, a chunk of G = 8) and at
   a small odd shape (K = 2, d_max = 1, n_cap = 64, 33 kept rows); then
   K19 (tau leaping) at BASELINE config 3's round (B = 131072) for
   birth-death, its midpoint variant and the stochastic LV, every count
   equal to the plain version's, and card against CPU on 8192 lanes; K20b
   network (the network SIR) at B = 65536 and with noise; K22's moment
   fold at config 3's round (B = 65536, S = 20, slots retired at every
   segment, invalid slots, the record window cut inside the round: counts
   and extrema equal, sums within 1e-5 relative, the same from run to run)
   and its finish for all seven moment scales (16384 rows); K18's adaptive
   mode (its nseg bit-equal to the plain version's) at B = 65536; K18's
   K > 1 mode over two birth-death models (bit-exact) and over the
   segmented ODE family at the zoo's round (B = 32768; without noise
   bit-exact, with it within 1e-5 and a few kept slots at the threshold),
   its kept rows bit-equal to the family's range kernel, whose chained
   segments are bit-equal to its full trajectory; and, after
   phase 4's config 3 run, K18 (the segmented round) at config 3's round
   with generation 6's epsilon and at a small odd shape (B = 256, 5
   segments, 37 live slots), its kept slots, statistics, reservoir, ring
   and counters bit-identical to the plain version's, with its device time
   per round on and off beside K19's classic round; each
   with its largest
   absolute error; then K12 (the k-NN covariance field) with top-k at
   n_cap 1024 (k 256), with threshold selection at the scale lane's width
   (n_cap 16384, k_cap 4096, stride 4), at a small odd shape (n_cap 64,
   37 valid rows, d 1) and at stride 1, its neighbours and counts bit-equal
   to the plain version's; K13 (the factorization) over every row and
   incrementally with a tenth of the rows changed and a rank-1 row on the
   jitter ladder, n_changed equal; K2's local mode at B 65536, K14's
   density at 65536 x 16384 (d 4) and K15 (the drift guard and cadence);
   K21a/K21c, the accept kernel of every noise family and scale
   (independent normal, Laplace, binomial, Poisson, negative binomial by
   size and by mean, the full-covariance normal; SCALE_LIN where the
   family has it) at config 3's round (B 65536, S 20) and at B 257, S 7:
   v within rel 1e-5 with its -inf and NaN masks equal, log weights
   within rel 1e-5, flags equal away from log u; and, after phase 4's
   noisy config 3 leg, K18's stochastic mode at the bench's config 3
   round (B 131072, that leg's generation-8 temperature and pdf norm),
   with the Poisson and Laplace bounds at B 65536 and at a small odd
   shape, each followed by K21a/K21c and K6's record mode with its ring
   mask: kept slots, statistics, reservoir, completed ring rows and
   counters bit-identical, its device time beside the p-norm mode's on
   the same round; K16's four entries (the bootstrap draw, the bootstrap
   fits, the density CV, the bisection step) at the LV adaptive leg's full
   shape (n_cap 16384, 10 bootstraps, d 4, the first probe at n = 16384),
   at config 5's (K = 3, d_max 2, n_cap 4096, one model dead) and at a
   small odd shape (n_cap 100, 3 bootstraps, d 1, 37 weighted rows): the
   draw and the bisect step bit-equal, the fit at K8's tolerances, each
   model's CV within 1e-4 relative and the same from run to run, and a
   whole bisection ending in the plain entries' state; K16's repair case
   (the model-weighted case of tests/test_torch_population.py with model
   2's bootstrap of rank 1 at n = 3): each live model's CV and the
   aggregate finite and within 1e-4 of the plain versions'; K16's
   LocalTransition mode (the gather, the bootstrap fits by K12 and K13,
   the local density) at the LV local adaptive leg's shape (n_cap 16384,
   10 bootstraps, d 4, k_cap 4096, threshold at stride 4), at config 5's
   (K 3, k_cap 1024, one model dead) and at small shapes with whole
   bisections: the gather bit-equal, two fits a model at K12's and K13's
   tolerances, the CV within 1e-4 relative, each log-density bit-equal
   to K14's on the same fit; K2's and K14's K > 1 local modes, K15's
   K > 1 mode, K12 and K13 per model and K26 under K15's fitted mask at
   config 5's shapes (n_cap 4096, one model dead); K25's accept
   at the LV aggregated legs' round (B 65536, S 40) for their pair and for
   2 and 4 sub-distances of mixed p (1, 2, inf, 3): distances and the
   values mode within 1e-5 relative, flags equal away from eps, log
   weights equal; K25's refit over the LV adaptive leg's ring (131072 x
   40, 20000 rows unwritten) and reservoir (16384) for span,
   standard_deviation and median_absolute_deviation: scales, W and
   distances within 1e-5, span's and the median's scale bit-equal to the
   plain scale of the kernel's own values; and, after phase 4's
   aggregated config 3 leg, K18's aggregate mode at config 3's round
   (that leg's generation-6 epsilon) and at a small odd shape, kept
   slots, statistics, reservoir, ring and counters bit-identical, its
   device time beside the p-norm mode's on the same round; K2's family
   mode (B 65536): every prior family of the JAX package and
   LowerBoundDecorator as a 1-D prior, its draws within abs 1e-5 + rel
   1e-5 of the plain version's (lanes apart counted, at most 1e-3 of
   them), its log-densities within abs 1e-5 + rel 1e-5 with equal -inf
   masks, the card's draws against scipy's law (KS under its 0.001
   critical value, the pmf within 4 se), the decorator's draws above the
   bound, the transition mode scoring points inside, on and outside each
   support, the LV families leg's 4-D prior in both modes and in the
   local mode at its shapes (a fit of 16384 rows) and the K > 1 mode over
   two models of other families; each family's prior-mode time beside one torch.distributions
   sample + log_prob; K23's fit at the learned-statistics leg's width
   (n_cap 16384, 9731 kept rows of simulated network SIR statistics, S
   128, C' 2), at n 300 with 211 kept (S 6) and at C' 8: W, b, mu, sd
   within 1e-4 relative, the flags equal, the same run to run, a poisoned
   row keeping the old parameters; K23's transform and accept at B 65536,
   S 128 for p 2, 1 and inf: rows and distances within 1e-5 of their
   scale, flags equal away from eps, log weights equal, the values mode
   bit-equal to the accept; K18's transformed operands on the network
   SIR's map and on a map of one row a segment (a null space before the
   end): At bit-equal, null counts equal, projectors within 1e-5; and,
   after phase 4's learned leg, K18's transformed mode at that leg's round
   (B 65536, the transform it ended with, where nothing can retire) and
   at config 3's round under a C' 8 transform (B 131072, 10 segments of 2
   values: the last three segments leave a null space, so slots retire),
   each at the 30 % quantile of its round's transformed distances and
   followed by K23's accept and K6: kept slots, statistics, reservoir,
   ring and counters bit-identical, slots accepted, at config 3's round
   valid slots retired; at the leg's round its device time beside K18's p-norm
   mode and K20b's unsegmented round on the same slots; the GP kernel
   (the host-refit mode's GPPredictor transform) over a round of the GP
   leg (B 65536, S 128) under a GPPredictor() fit on 16384 of its rows
   (cap 512, C' 2) for p 2, 1 and inf, a fit on 300 rows (212 padded
   points) and a fit to 8 targets: rows and distances within 1e-5 of
   their scale (sum |k a| + |ymu|), flags equal away from eps, log
   weights equal, the values mode bit-equal to the accept, the same bits
   run to run; K17 (GridSearchCV's cross-validated scaling) at LV config
   2's shape (n 1000, d 4, 5 scalings, cv 5), at n_cap 16384, on two fold
   tables (1500 rows of 2048; 4 rows, fewer fold ids than cv), K = 3 at
   config 5's shape and a small odd shape: the scores within 1e-4
   relative and the same bits run to run, the winner equal where the two
   best scores differ by more than 1e-4 relative, the params at K8's
   tolerances; K14 over a pop-16384 noisy run's record ring (131072 x
   16384, d 4) within 1e-4 + 1e-5 relative;
   each with its largest
   absolute error, its device time ("ms": back-to-back
   calls replayed from one CUDA graph), its time per call ("call_ms": CUDA
   events around the same calls made from Python, the wrapper's host work
   included), the plain version's time per call (the plain compaction
   syncs on its boolean masks, so no plain version is graph-captured), the
   least time the card could take and, where one PyTorch call computes the
   same function, that call's time. Philox4x32-10 (K1) is held to
   Random123's known-answer vectors on the card;
3. the Gaussian conjugate toy (pop 1000, 6 generations, 32 seeds) on the
   card and the first 16 of them on the CPU, the mean of its posterior
   means against the
   analytic posterior mean and the card's against the CPU's; then the noisy
   Gaussian anchor (x = theta under IndependentNormalKernel(var 0.09),
   Temperature, StochasticAcceptor, pop 1000, 32 seeds) the same way, its
   posterior mean and sd against the exact posterior N(0.7339, 0.2874^2);
   then the model-selection anchor (the tractable pair at x_obs 0.7, pop
   600, 6 generations, 16 seeds on the card, the first 8 on the CPU), the
   seed mean of P(m = 0) against the
   exact 0.5529 and the card's against the CPU's; then the noisy anchor
   under each prior of ANCHOR_FAMILIES (lognorm, expon, gamma, beta,
   laplace, cauchy, t, truncnorm, a norm bounded at 0), 24 seeds on the
   card and the first 12 on the CPU: the temperature trails end at
   exactly 1, the
   card's seed mean of the posterior mean within 4 se of the quadrature
   posterior's and of the CPU's;
4. Lotka-Volterra config 2 (AdaptivePNormDistance(p=2), MedianEpsilon,
   pop 1000, observed_data(seed=0)), 10 generations: throughput, wall time
   and syncs per generation, the epsilon trail and the posterior means.
   The kernels' launch counts are reset just before this run and read just
   after it: each kernel of the path must have launched. A run of the same
   model under a fixed p-norm (6 generations) comes first; its epsilon
   trail must not increase. Then one more config 2 run under
   torch.profiler gives the device's busy share of the run's window and
   the ten device ops that take the most time, and the same seed run on
   the CPU (the same Philox streams) gives its epsilon trail beside the
   card's. Then SIR config 4 (IndependentNormalKernel(var 100 x 15),
   Temperature, StochasticAcceptor, pop 1000, observed_data(seed=11), 8
   generations, a budget of 1024 rounds a generation), counts reset just
   before and read just after: its own throughput, syncs and temperature
   trail, which must end at exactly 1, and posterior means within 3
   posterior sd of the true parameters; once more under torch.profiler;
   and the same seed on the CPU for its first generations' temperatures.
   Then BASELINE config 5 (the ODE family of K = 3 models at its defaults,
   observed_ode_family(seed=0, true_model=1), PNormDistance(p=2),
   MedianEpsilon, pop 1000, 8 generations), counts reset just before and
   read just after: throughput, syncs, the epsilon trail, the model
   probabilities and the per-model posterior means; once more under
   torch.profiler; and the same seed on the CPU, whose first three
   epsilons must equal the card's within 1e-4 relative.
   Then BASELINE config 3 as bench.py's early-reject lane runs it (the
   birth-death model in 10 segments, PNormDistance(p=2), MedianEpsilon,
   12 generations, chunks of 2; pop cut from 131072 to 16384, see
   C3_POP) with early reject on and off,
   counts reset just before: populations bit-identical in every
   generation, lanes retired, the saved simulation share, accepted
   particles/s over the late window (acceptance <= 0.01) in turns (on,
   off, off, on), syncs per generation (on <= off) and the epsilon trail;
   once more under
   torch.profiler; the same seed at pop 1024 on the card and the CPU (the
   first three epsilons within 1e-3 relative); then the scenario zoo's
   stochastic LV and network SIR (pop 16384, 4 generations) on and off,
   bit-identical. Then bench.py's scale lane (Lotka-Volterra,
   AdaptivePNormDistance(p=2), MedianEpsilon, LocalTransition(k_fraction=
   0.25), pop 16384, 12 generations, G 8, seed 101, the refit cadence
   auto), counts reset just before: K12-K15 and K2's local mode launched,
   throughput, wall per generation, syncs (one per round plus one per
   chunk, nothing else), the epsilon trail, the refit events, rows changed
   and drift trail, the posterior means; once more under torch.profiler;
   and the same seed at pop 1024 on the card and the CPU (the first three
   epsilons within 1e-3 relative). Then the scenario lane's adaptive leg
   at config 3's shape (AdaptivePNormDistance(p=2,
   scale_function=standard_deviation), pop 16384, 12 generations, G 2,
   seed 7) with early reject on, off, off, on, counts reset just before:
   K22 and K18's adaptive mode launched, wall, particles/s, syncs (the
   counter reads and chunk fetches only), retired candidates and work
   saved, the weights trail (a refit every generation), the posterior
   means on and off; once more under torch.profiler; the bench's own
   adaptive leg (pop 128, 5 generations, seed 17) on and off against its
   parity rule (gap < 0.5); and the zoo's model-selection leg
   (ode_family(segments=4), pop 8192, 3 generations, G 3, seed 5) on,
   off, off, on, counts reset just before: populations, models, weights
   and the epsilon trail bit-identical, model probabilities summing to 1,
   K18's K > 1 mode and the family's range kernel launched; once more
   under torch.profiler. Then noisy config 3 (the JAX package's noisy
   early-reject test at config 3's shape: IndependentNormalKernel(var=4),
   StochasticAcceptor(ScaledPDFNorm), Temperature(ExpDecayFixedIter,
   T0 = 50), pop 16384, 12 generations, G 2, seed 7) and the same with
   PoissonKernel() on a Poisson-noised observation, each on, off, off,
   on, counts reset just before: populations, weights, distances and the
   temperature trail bit-identical, retired > 0, the trail ending at
   exactly 1, one counter read per round plus one fetch per chunk; the
   first once more under torch.profiler. Then the unsegmented legs of the
   other families (NormalKernel, IndependentLaplaceKernel,
   BinomialKernel on a binomially thinned observation,
   NegativeBinomialKernel by size and by mean, PoissonKernel(SCALE_LIN);
   the birth-death model, Temperature(), StochasticAcceptor(), pop 1000,
   6 generations, seed 3), counts reset before each: the CPU's first two
   temperatures within 1e-3 of the card's, the History reopened from its
   file, and for the unbounded kernels (run on the segmented model under
   "auto") the early-reject fallback recorded with its reason. Then the
   population-size legs, counts reset just before each and each once more
   under torch.profiler: LV config 2 under AdaptivePopulationSize(start
   1000, mean_cv 0.05, max 16384, 10 bootstraps), 10 generations, beside
   it the same run at ConstantPopulationSize(16384) (the same reads a
   generation: its rounds' counters only), the same leg at mean_cv 0.15
   with a floor of 1000 (the target met below max_n, so whole
   bisections run), and config 5 (K = 3) under the first with a cap of
   4096, 8 generations: the n trail within its bounds and equal to the
   stored counts, each n_next the next generation's n, K16 launched in
   every generation but the last, its probes that did work and the CV at
   max_n per generation, its device ms per generation and per probe,
   syncs (one counter read a round, one fetch a chunk), the wall; and the
   Gaussian toy under
   ListPopulationSize((500, 1000, 2000, 1000, 500)) over 32 seeds, the
   stored counts equal to the list and the seed mean within 0.03 of the
   analytic posterior mean. Then LocalTransition under population sizes
   and over several models (K16's LocalTransition mode, K2's and K14's
   K > 1 local modes, K15, K12 and K13 per model), counts reset just
   before each leg and each once more under torch.profiler: the LV local
   adaptive leg (the scale lane's LocalTransition(k_fraction=0.25) under
   the LV adaptive leg's strategy: n_cap 16384, k_cap 4096, threshold at
   stride 4), again at mean_cv 0.15 with a floor of 1000 (whole
   bisections), config 5 with three LocalTransition()s under its adaptive
   strategy (the same checks as the population-size legs, K16's local
   gather, density and bisect once a probe and ten K12 and K13 launches a
   probe, no MVN kernel), both at pop 1024 on the card and the CPU (the
   first two epsilons within 1e-3), the tractable pair with two
   LocalTransitions over 16 seeds (card mean within 0.05 of the exact
   0.5529 and 4 se of the CPU's) and the toy's list under
   LocalTransition(k_fraction=0.3) over 16 seeds (counts equal, the seed
   mean within 0.05). Then the aggregated-distance legs, counts
   reset just before each and each once more under torch.profiler: LV
   config 2 under AdaptiveAggregatedDistance([PNormDistance(p=2) on the
   predators, PNormDistance(p=1) on the prey]), pop 16384, 8
   generations: K25's accept and refit launched, K5 and K9 not, the
   weights refit at the calibration and after every generation, wall,
   syncs (one counter read a round, one fetch a chunk) and the busy
   share; the same at pop 1024 on the card and the CPU, the weights side
   by side (the calibration's within 1e-3); LV under
   tests/test_fused.py:324-345's schedule at LV's labels (float32 fetch,
   the statistics stored): every stored distance recomputed under its
   generation's weights within 2e-3 relative; and config 3 under the
   aggregated pair of tests/test_segment.py:114-121 (weights 0.7, 1.3),
   early reject on, off, off, on: populations bit-identical, slots
   retired, the saved share of segment steps, K18's aggregate mode
   launched. Then this slice's main leg, LV config 2 on the JAX package's
   observation under the family prior (gamma, lognorm, truncnorm, a norm
   bounded at 0), pop 16384, 8 generations, counts reset just before:
   every K2 launch in its family mode, the epsilon trail falling, the
   posterior means, the transition lanes whose redraws all left the
   prior's support, syncs, the wall split (compute, fetch, the loop's
   wait on the History writer, the writer thread's time, the final
   flush), K2's device ms a round under torch.profiler; the same at pop
   1024 on the card and the CPU (the first two epsilons within 1e-3
   relative); the tractable pair with a gamma prior on its second
   model over 8 seeds, card and CPU, against the exact model posterior;
   and config 3 and the LV families leg with the History writer and with
   synchronous appends, in turns (writer, sync, sync, writer), the wall
   and its split each. Then the learned-statistics leg (bench.py:1196-1253:
   the network SIR at 8 patches x 16 observations, S 128 in 4 segments,
   PNormDistance(p=2) through PredictorSumstat(LinearPredictor(alpha=1)),
   MedianEpsilon, seed 11, chunks of 2; pop 16384 where the bench's CPU
   leg takes 256, 8 generations), counts reset just before: every kernel
   of the path launched (K23's fit, transform and accept, K18's
   transformed mode and operands), the boundary refits at each chunk's
   last generation, History rows 128 wide at generation 0 and 2 after,
   one counter read a round and one fetch a chunk; the same with early
   reject off (bit-identical populations, every slot resolved, the
   retired slots and the saved share) and under plain PNormDistance(p=2)
   (fetch bytes a particle at least 2 times the learned run's); once more
   under torch.profiler for K23's and K18's device ms a generation; both
   learned legs at pop 1024 on the card and the CPU (the adaptive leg's
   second epsilon held on a CPU run fed the card's calibration weights
   and distances, the CPU's own with its weights one ulp up and down
   reported); the adaptive form (AdaptivePNormDistance(p=2) through the
   same statistic, the classic kernel, its C'-wide weight trail); and the
   accuracy setting of tests/test_sumstat_device.py:497-540 over 16
   seeds, the seed means of the learned RMSE and of its gap to the
   identity's against the JAX package's over the same seeds. Then this
   slice's main leg, the same network SIR under PNormDistance(p=2)
   through PredictorSumstat(MLPPredictor()) (hidden (64, 64), 400 seed
   steps, 100 a boundary), pop 16384, 8 generations, counts reset just
   before: K23's MLP fit (the seed fit and each boundary) and transform
   launched, the refit generations, History rows 128 then 2 wide, one
   counter read a round, one fetch a chunk and the seed fit's read; early
   reject auto (off, with the JAX package's reason) bit-identical to off;
   fetch bytes a particle at least 2 times fewer than the identity run's;
   once more under torch.profiler for K23's MLP fit and transform device
   ms; and at pop 1024 on the card and the CPU: generation 0's epsilon
   within 1e-3, the seed fits' predictions on held-out rows within 1e-2
   of their sd, generation 1's epsilon within 1e-3 on a CPU run fed the
   card's seed fit. Then this slice's legs, the host-refit mode on the
   same network SIR (pop 16384, 8 generations, early reject auto: off
   with the JAX package's reason): the GP leg (GPPredictor()), counts
   reset just before, every kernel of its path launched, the GP kernel's
   values mode once a boundary, once more under torch.profiler for the GP
   kernel's device ms; the Lasso leg, the model-selection leg
   ([LinearPredictor(alpha=1), GPPredictor()]) and the fit_every 3 linear
   leg: each its boundary fits where the cadence puts them, History rows
   128 wide throughout, telemetry mode host, one counter read a round and
   one fetch a chunk, the refit generations, trail, posterior means, wall
   split and syncs a generation; IdentitySumstat() bit-identical to
   PNormDistance(p=2) fetching float32 (populations, weights, distances,
   the trail and History rows); and the GP leg at pop 1024 on the card and
   the CPU: generation 0's epsilon within 1e-6, the first boundary fit's
   parameters within 1e-6 of their largest value (the kernel system's
   weights within 1e-3), generations 1 and 2 within 1e-3. Then GridSearchCV
   and LocalTransition's last modes, counts reset just before each leg:
   LV config 2 with GridSearchCV(MVN, scalings 0.25-4, cv 5) at the scale
   lane's width (pop 16384, 8 generations; K17 every generation in K8's
   place, the winner trail, syncs, once more under torch.profiler for
   K17's device ms a generation); the toy's list under GridSearchCV over
   16 seeds (counts equal to the list, K17 on each generation's fold
   table); the tractable pair with two GridSearchCVs over 8 seeds (card
   mean within 0.05 of the exact 0.5529 and 4 se of the CPU's); the noisy
   anchor with a LocalTransition over 16 seeds (within 4 se of the exact
   mean and of the CPU's); SIR config 4 with a LocalTransition (the trail
   ending at exactly 1, one K14 ring pass a generation, the first two
   temperatures within 1e-3 of the CPU's); config 3 with a LocalTransition
   on, off, off, on (8 generations) and its K = 2 pair on and off (pop
   4096): bit-identical. Then sharded fused sampling on 8 virtual shards
   (K24a-d), counts reset just before each leg: phase 2's K24a (K6's
   shard mode, plain and feature rows, rounds until every shard is
   finished), K24b (the shard mask), K24c (K10's merge mode over a chunk
   of 8 generations, a constant n and a list) and K24d's fold and finish
   against their plain versions at the LV sharded leg's shapes (B 65536
   on 8 shards, n_cap 16384, S 40); LV with the JAX mesh lane's
   configuration (bench.py:1749-1753, pop 16384, sharded=8, G 8, 9
   generations) beside the same seed unsharded: 16384 rows every
   generation, the refit at generations 0 and 8 only, posterior means
   within 0.2 of the unsharded run's, a read a round and a fetch a chunk,
   once more under torch.profiler; LV under
   AdaptivePNormDistance(standard_deviation) and a listed size, sharded:
   the weights refit every generation, its listed n, card and CPU within
   1e-3 over two generations at pop 1024; the Gaussian toy at pop 300
   (uneven quotas): 300 rows, the mean within 0.25 of the conjugate one;
   the tractable pair sharded over 8 seeds (within 0.05 of the exact
   0.5529, 4 se of the CPU's). Then the device mesh (K24e and the lane
   base of K2 and K4): phase 2's K24e pack and unpack, bit-exact against
   their plain twin at the LV mesh leg's shapes (n_cap 16384 on 8 shards,
   S 40) at widths 2 and 4, and K2, K4's LV and Gaussian kernels over
   each rank's lanes [a, b) of B 65536 with the lane base a, bit-equal to
   rows [a, b) of the whole round's launch; then the mesh legs, each rank
   a process on the one card (``--mesh-rank``, a file:// rendezvous, Gloo,
   every rank with its plain versions set to raise and its counts reset
   just before its run, each joined with a time limit): LV (pop 16384, 8
   generations, sharded=8, G 3, seed 0) at widths 2 and 4, the LV
   adaptive sharded leg's list at width 4 and config 1's Gaussian (pop
   16384, 8 generations) at width 2; every primary's History (epsilons,
   thetas, weights, distances) bit-identical to the same configuration's
   virtual-shard run on the card, every rank's to the primary's, one
   gather a generation; per rank the rounds a generation, gathers, bytes,
   staging and Gloo ms a gather and wall.

The anchors' CPU references (the toy, the noisy anchor with and without a
LocalTransition, the nine prior families, the tractable pair in its four
kinds, SIR config 4 with a LocalTransition, the LV adaptive sharded
trail) run in a process of their
own (``--cpu-refs DIR``, started after the build, half the host's
threads, no card visible), beside the card phases; the comparisons with
them run after the card phases, and a failed or missing reference fails
the run. ``time:`` lines mark each phase.

While the card runs of phases 3 and 4 go, the plain version of every
kernel (K1-K16 with K16's LocalTransition mode, K17, K18 and its modes,
K19, K20, K20b, K21a, K21b, K21c, K22, K23 linear and MLP, the GP
transform, K24a-e, K25, K26 and the K > 1 modes) is replaced by a
function that
raises, so
none can run on the path unseen.

Before the last line it prints one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Any failed check exits
nonzero without that line. Without a CUDA device it exits nonzero at once.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor)
#: FLOP/s, the rates the kernels' bounds are taken against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

B_MAIN, N_CAP_MAIN, POP = 4096, 1024, 1000
#: seeds of the Gaussian toy and of the noisy anchor, card and CPU
TOY_SEEDS = tuple(range(32))
#: round budget of a SIR config 4 generation: at T = 1 with the norm at
#: the kernel's maximum about 5e-4 of the evaluations are accepted, so
#: pop 1000 needs some 2e6 (the JAX sampler's 256 rounds hold 1e6)
SIR_MAX_ROUNDS = 1024
SIR_GENS = 8
#: kernels of the LV path (phase 4) and of the SIR config 4 path
LV_PATH = ("propose", "mvn_mixture_logpdf", "lv_simulate",
           "pnorm_accept_weight", "compact_round", "normalize_quantile",
           "mvn_fit", "scale_reduce", "pack_fetch", "generation_health")
SIR_PATH = ("propose", "mvn_mixture_logpdf", "sir_simulate", "kernel_accept",
            "compact_round", "normalize_quantile", "mvn_fit", "pack_fetch",
            "generation_health", "temperature_update")
NOISY_KERNELS = ("sir_simulate", "kernel_accept", "temperature_update")
#: the kernels config 5 (model selection) brought: K20b and K26
MODEL_KERNELS = ("ode_family_simulate", "model_step")
#: Random123's known-answer vectors for Philox4x32-10
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


#: a file every line also goes to (``--log``), or None
LOG_FILE = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's per-call cost (the wrapper's checks,
    allocation and launch) drops out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def wall_split(abc) -> dict:
    """A run's host seconds: rounds and generation steps (compute_s), the
    packed fetch (fetch_s), the loop's wait on the History (persist_s:
    handing each generation to the writer thread), the writer thread's own
    time on the appends (write_s, beside the loop's time) and the final
    drain in run() (flush_s)."""
    split = {k: sum(g[k] for g in abc.generation_log)
             for k in ("compute_s", "fetch_s", "persist_s", "write_s")}
    split["flush_s"] = abc.flush_s
    return split


def held_s(split: dict) -> float:
    """The seconds of a split that held the calling thread."""
    return sum(split[k] for k in ("compute_s", "fetch_s", "persist_s",
                                  "flush_s"))


# ------------------------------------------------------------ phase 2
def stream_on(dev, tag: int, gen: int = 2, rounds: int = 1, seed: int = 0):
    """A Philox stream of generation ``gen`` at round ``rounds``."""
    import torch

    from pyabc_tpu_torch.kernels.philox import PhiloxStream

    ctr = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr[1] = rounds
    return PhiloxStream(seed, gen, tag, 256, ctr)


def within(a, b, atol: float, rtol: float) -> bool:
    """|a - b| <= atol + rtol |b| where b is finite, NaN where b is NaN."""
    import torch

    if not torch.equal(a.isnan(), b.isnan()):
        return False
    fin = ~b.isnan()
    return bool(((a - b).abs()[fin] <= atol + rtol * b.abs()[fin]).all())


def kernel_checks(dev) -> dict:
    """Every kernel against its plain version on main-path inputs."""
    import torch

    from pyabc_tpu_torch import AdaptivePNormDistance
    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import (compact_round, compact_round_plain,
                                         lv_simulate, lv_simulate_plain,
                                         mvn_mixture_logpdf,
                                         mvn_mixture_logpdf_plain, philox,
                                         pnorm_accept_weight,
                                         pnorm_accept_weight_plain, propose)
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.ops.stats import weighted_quantile
    from pyabc_tpu_torch.transition import (MultivariateNormalTransition,
                                            silverman_rule_of_thumb)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, n, S = B_MAIN, N_CAP_MAIN, 40
    model, prior = lv.make_lv_model(), lv.default_prior()
    prior_arrays = prior.arrays(dev)
    obs = lv.observed_data(seed=0)
    spec = SumStatSpec(obs)
    x0 = torch.as_tensor(spec.flatten_host(obs), dtype=torch.float32,
                         device=dev)
    results = {}
    philox_checks(dev)

    # K4 on prior draws (includes lanes that grow past the 1e6 clip), its
    # noise drawn in the kernel from Philox
    theta = propose(stream_on(dev, philox.PRIOR), B, prior_arrays)[0]
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              y0=lv.Y0, noise_sd=model.noise_sd, log_parameters=False)
    sim = stream_on(dev, philox.SIM_NOISE)
    ss_k = lv_simulate(theta, None, stream=sim, **kw)
    ss_p = lv_simulate_plain(theta, None, stream=sim, **kw)
    torch.cuda.synchronize()
    same_nan = bool((torch.isnan(ss_k) == torch.isnan(ss_p)).all())
    fin = torch.isfinite(ss_p)
    err = (ss_k - ss_p).abs()[fin]
    k4_err = float(err.max())
    rel = float((err / ss_p.abs()[fin].clamp_min(1)).max())
    log(f"K4 lv_simulate: max_abs_err={k4_err:.3e} max_rel_err={rel:.3e}"
        f" nan_lanes={int(torch.isnan(ss_p).any(1).sum())}"
        f" same_nan={same_nan}")
    check(same_nan and bool((err <= 1e-3 + 1e-4 * ss_p.abs()[fin]).all()),
          "K4 outside |err| <= 1e-3 + 1e-4 |x| (FMA contraction over 190 "
          "RK4 steps; Philox normals within 2e-6)")
    steps = (model.n_obs - 1) * model.n_substeps
    k4_bytes = B * 4 * 4 + B * 2 * model.n_obs * 4
    # RK4 steps, and 2 n_obs Philox normals (a block of 10 rounds of ~10
    # integer operations makes 4 of them, Box-Muller ~10 more each)
    k4_flops = B * (steps * 60 + model.n_obs * 2 * (3 + 25 + 10))
    results["lv_simulate"] = dict(
        err=k4_err,
        call_ms=time_ms(lambda: lv_simulate(theta, None, stream=sim, **kw),
                        50),
        ms=graph_ms(lambda: lv_simulate(theta, None, stream=sim, **kw)),
        plain_ms=time_ms(lambda: lv_simulate_plain(theta, None, stream=sim,
                                                   **kw), 3),
        bound=bound(k4_bytes, k4_flops), library_ms=None)

    # K3 on a transition fitted to the first n prior draws
    w = torch.rand(n, generator=gen, device=dev)
    w[n - 24:] = 0.0  # empty reservoir slots carry weight 0
    params = MultivariateNormalTransition.device_fit(
        theta[:n], w / w.sum(), dim=4, scaling=1.0,
        bandwidth_selector=silverman_rule_of_thumb)
    q = MultivariateNormalTransition.device_rvs(
        params, B, stream_on(dev, philox.TRANSITION), prior_arrays)
    lq_k = mvn_mixture_logpdf(q, params)
    lq_p = mvn_mixture_logpdf_plain(q, params)
    torch.cuda.synchronize()
    k3_err = float((lq_k - lq_p).abs().max())
    log(f"K3 mvn_mixture_logpdf: max_abs_err={k3_err:.3e} "
        f"range=[{float(lq_p.min()):.2f}, {float(lq_p.max()):.2f}]")
    check(k3_err <= 1e-3, "K3 outside |err| <= 1e-3 (f32 logsumexp of "
          "1000 terms in another order)")
    n_live = int((params["weights"] > 0).sum())
    k3_bytes = (B * 4 + 16 + 4 + n * 4 + 2 * n + 1 + B) * 4
    k3_flops = B * n_live * (2 * 4 + 8) + B * (2 * 16 + 8)

    def k3_library():
        u = q - params["center"]
        pu = u @ params["prec"].T
        maha = (u * pu).sum(1, keepdim=True) - 2.0 * (pu @ params[
            "thetas_c"].T) + params["quad"]
        lc = -0.5 * (4 * math.log(2 * math.pi) + params["logdet"] + maha)
        return torch.logsumexp(lc + torch.log(params["weights"]), dim=1)

    check(float((k3_library() - lq_p).abs().max()) <= 1e-3,
          "K3 library form disagrees")
    results["mvn_mixture_logpdf"] = dict(
        err=k3_err,
        call_ms=time_ms(lambda: mvn_mixture_logpdf(q, params), 50),
        ms=graph_ms(lambda: mvn_mixture_logpdf(q, params)),
        plain_ms=time_ms(lambda: mvn_mixture_logpdf_plain(q, params), 10),
        bound=bound(k3_bytes, k3_flops),
        library_ms=time_ms(k3_library, 10))

    # K5 on the K4 rows with MAD weights and a median epsilon
    dist = AdaptivePNormDistance(p=2)
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    wts = dist.refit(ss_p, valid, x0, ss_p[:1])[0]
    eps = weighted_quantile(
        torch.where(valid, dist.rows(ss_p, x0, wts),
                    torch.full((B,), math.inf, device=dev)),
        valid.float(), 0.5)
    logpri = prior.logpdf_array(q)
    k5_args = (ss_p, x0, wts, eps, valid)
    k5_kw = dict(p=2.0, logpri=logpri, logq=lq_p)
    d_k, a_k, lw_k = pnorm_accept_weight(*k5_args, **k5_kw)
    d_p, a_p, lw_p = pnorm_accept_weight_plain(*k5_args, **k5_kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(d_p)
    d_err = float(((d_k - d_p).abs() / d_p.abs().clamp_min(1.0))[fin].max())
    far = (d_p - eps).abs() > 1e-5 * eps.abs()
    flags_ok = bool((a_k == a_p)[far].all())
    lw_fin = torch.isfinite(lw_p)
    lw_err = float((lw_k - lw_p).abs()[lw_fin].max())
    k5_err = max(d_err, lw_err)
    log(f"K5 pnorm_accept_weight: max_rel_err(d)={d_err:.3e} "
        f"max_abs_err(logw)={lw_err:.3e} accept_flags_equal={flags_ok} "
        f"accepted={int(a_k.sum())}/{B}")
    check(d_err <= 1e-5 and lw_err <= 1e-5 and flags_ok
          and bool((torch.isfinite(lw_k) == lw_fin).all()),
          "K5 outside rel 1e-5 (sum order, sqrt vs pow) or flags differ")
    k5_bytes = (B * S + 2 * S + 1) * 4 + B + 2 * B * 4 + B * (4 + 1 + 4)
    results["pnorm_accept_weight"] = dict(
        err=k5_err,
        call_ms=time_ms(
            lambda: pnorm_accept_weight(*k5_args, **k5_kw), 100),
        ms=graph_ms(lambda: pnorm_accept_weight(*k5_args, **k5_kw)),
        plain_ms=time_ms(
            lambda: pnorm_accept_weight_plain(*k5_args, **k5_kw), 20),
        bound=bound(k5_bytes, B * S * 4), library_ms=None)

    # K6 on the K5 outputs, starting at n_acc = 0 (a main-path first round)
    rec_cap = 8 * n
    theta_c = q.contiguous()

    def buffers():
        res = {"theta": torch.zeros(n, 4, device=dev),
               "sumstats": torch.zeros(n, S, device=dev),
               "distance": torch.zeros(n, device=dev),
               "log_weight": torch.full((n,), -math.inf, device=dev),
               "slot": torch.full((n,), -1, dtype=torch.int32, device=dev)}
        rec = {"sumstats": torch.zeros(rec_cap, S, device=dev),
               "distance": torch.zeros(rec_cap, device=dev),
               "accepted": torch.zeros(rec_cap, dtype=torch.bool,
                                       device=dev),
               "valid": torch.zeros(rec_cap, dtype=torch.bool, device=dev)}
        return res, rec

    k6_in = (a_k, valid, theta_c, ss_p, d_k, lw_k)
    res_k, rec_k = buffers()
    res_p, rec_p = buffers()
    ctr_k = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr_p = torch.zeros(4, dtype=torch.int32, device=dev)
    compact_round(*k6_in, res_k, rec_k, ctr_k)
    compact_round_plain(*k6_in, res_p, rec_p, ctr_p)
    torch.cuda.synchronize()
    same = bool(torch.equal(ctr_k, ctr_p))
    k6_err = 0.0
    for a, b in [*zip(res_k.values(), res_p.values()),
                 *zip(rec_k.values(), rec_p.values())]:
        same = same and bool(torch.equal(a.isnan(), b.isnan()))
        fin = ~torch.isnan(a.float())
        k6_err = max(k6_err, float((a.float()[fin] - b.float()[fin]).abs()
                                   .nan_to_num(0.0, 0.0, 0.0).max()))
        same = same and bool(torch.equal(a[fin], b[fin]))
    log(f"K6 compact_round: counters={ctr_k.tolist()} exact={same}")
    check(same, "K6 reservoir/ring/counters not bit-identical")
    # bytes the round must move, each once: the flags (accept only where
    # valid), sumstats and distance of every row the reservoir or the ring
    # keeps (in a first round every kept row is also a ring row), theta
    # and log weight of reservoir rows; then the rows written and the
    # counters read and written
    acc = a_k & valid
    rank = torch.cumsum(acc.int(), 0) - acc.int()
    to_res = acc & (rank < n)
    to_ring = valid & (torch.arange(B, device=dev) < rec_cap)
    n_res, n_ring = int(to_res.sum()), int(to_ring.sum())
    n_kept = int((to_res | to_ring).sum())
    k6_bytes = (B + int(valid.sum()) + n_kept * (S + 1) * 4
                + n_res * (4 + 1) * 4
                + n_res * (4 + S + 3) * 4 + n_ring * (S * 4 + 4 + 2)
                + 2 * 3 * 4)
    ctrs = [torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(60)]
    ctr_g = torch.zeros(4, dtype=torch.int32, device=dev)
    it = iter(ctrs)
    results["compact_round"] = dict(
        err=k6_err,
        call_ms=time_ms(
            lambda: compact_round(*k6_in, res_k, rec_k, next(it)), 50,
            warmup=5),
        # the counters are zeroed before each replayed launch (one small
        # memset in the graph) so every launch does a first round's work
        ms=graph_ms(lambda: (ctr_g.zero_(), compact_round(
            *k6_in, res_k, rec_k, ctr_g))),
        plain_ms=time_ms(lambda: compact_round_plain(
            *k6_in, res_p, rec_p, torch.zeros(4, dtype=torch.int32,
                                              device=dev)), 10),
        bound=bound(k6_bytes, 0.0), library_ms=None)

    # K2, K7, K8, K9 at the main-path shapes and at a second, small shape
    ring = torch.cat([ss_p, lv_simulate_plain(
        theta.flip(0), None, stream=stream_on(dev, philox.SIM_NOISE,
                                              rounds=2), **kw)])
    ring_valid = torch.ones(2 * B, dtype=torch.bool, device=dev)
    ring_valid[-1000:] = False  # the ring's tail not yet written
    res_theta, res_ss = theta[:n].contiguous(), ss_p[:n].contiguous()
    k_mask = torch.arange(n, device=dev) < 1000
    logw = torch.where(k_mask, lw_k[:n], torch.full_like(lw_k[:n],
                                                          -math.inf))
    results["propose"] = k2_checks(dev, params, prior_arrays, B)
    results.update(k7_checks(dev, logw, k_mask, d_k[:n]))
    k7_mode_checks(dev)
    results["mvn_fit"] = k8_checks(dev, res_theta, k_mask, logw)
    results["scale_reduce"] = k9_checks(dev, ring, ring_valid, x0, res_ss)
    results["pack_fetch"] = k10_checks(dev, theta, d_k, lw_k, ss_p, n)
    results["generation_health"] = k11_checks(dev, res_theta, k_mask, logw,
                                              d_k[:n])
    small_shape_checks(dev)
    return results


def philox_checks(dev) -> None:
    """K1 on the card: the known-answer vectors, then 16384 random
    counters against the plain twin (words and uniforms bit-exact, normals
    within 2e-6)."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import philox

    for ctr, key, want in PHILOX_KAT:
        words, _u, _z = philox.philox_blocks_cuda(
            torch.tensor([ctr], dtype=torch.int64, device=dev), key)
        check(words[0].tolist() == list(want),
              f"Philox known-answer vector {ctr} {key} failed on the card")
    rng = np.random.default_rng(0)
    ctr = torch.from_numpy(rng.integers(0, 2 ** 32, size=(16384, 4),
                                        dtype=np.int64)).to(dev)
    key = (0x12345678, 0x9ABCDEF0)
    words, uni, nrm = philox.philox_blocks_cuda(ctr, key)
    w = philox.philox4x32_10(*ctr.unbind(1), key)
    u = [philox.uniform_of(x) for x in w]
    z = torch.stack([philox.box_muller(u[0], u[1], False),
                     philox.box_muller(u[0], u[1], True),
                     philox.box_muller(u[2], u[3], False),
                     philox.box_muller(u[2], u[3], True)], dim=1)
    z_err = float((nrm - z).abs().max())
    same = (torch.equal(words, torch.stack(w, dim=1))
            and torch.equal(uni, torch.stack(u, dim=1)))
    log(f"K1 philox: known-answer vectors ok, words and uniforms "
        f"bit-exact={same}, normals max_abs_err={z_err:.3e}")
    check(same and z_err <= 2e-6, "K1 Philox disagrees with its plain twin")


def redraws_taken(stream, B, prior_arrays, params):
    """Per lane, the draws K2 evaluates on these inputs: one, plus one for
    each leading draw without prior mass (at most N_REDRAWS)."""
    import torch

    from pyabc_tpu_torch.kernels import philox
    from pyabc_tpu_torch.kernels.propose import (N_REDRAWS,
                                                 prior_logpdf_plain)

    n, d = params["thetas"].shape
    nb = (d + 3) // 4
    lanes = philox.lanes(stream, B)
    cdf = params["cdf"]
    total = cdf[-1]
    taken = torch.zeros(B, dtype=torch.int64, device=cdf.device)
    done = torch.zeros(B, dtype=torch.bool, device=cdf.device)
    for j in range(N_REDRAWS):
        u = torch.minimum(philox.uniforms(stream, lanes, j * (1 + nb), 0)
                          * total, torch.nextafter(total, 0 * total))
        idx = torch.searchsorted(cdf, u, right=True).clamp(max=n - 1)
        th = params["thetas"][idx] + philox.normals(
            stream, lanes, j * (1 + nb) + 1, d) @ params["chol"].T
        taken += (~done).long()
        done |= torch.isfinite(prior_logpdf_plain(th, prior_arrays))
    return taken


def k2_per_draw(n: int, d: int) -> int:
    """K2's operations a draw over an ``n``-row fit in ``d`` dimensions:
    1 + nb Philox blocks (~100 integer operations each), the uniform and d
    Box-Muller normals, the binary search, theta + L z and the prior
    log-density."""
    nb = (d + 3) // 4
    return (100 * (1 + nb) + 3 + 14 * d + 2 * math.ceil(math.log2(n))
            + d * (2 * d + 1) + 8 * d)


def compare_propose(dev, params, prior_arrays, B, tag):
    """K2 against its plain version: theta, logpri and valid, apart from
    lanes whose draw lies within rounding of a uniform prior bound."""
    from pyabc_tpu_torch.kernels import propose, propose_plain

    st = stream_on(dev, tag)
    th_k, lp_k, v_k = propose(st, B, prior_arrays, params)
    th_p, lp_p, v_p = propose_plain(st, B, prior_arrays, params)
    lo, hi = prior_arrays["loc"], prior_arrays["hi"]
    near = ((((th_p - lo).abs() < 1e-4) | ((th_p - hi).abs() < 1e-4))
            & (prior_arrays["kind"] == 1)).any(dim=1)
    th_err = ((th_k - th_p).abs() - 1e-5 * th_p.abs())
    odd = (v_k != v_p) | (th_err > 1e-5).any(dim=1)
    ok = ~odd & v_p
    lp_err = float((lp_k - lp_p)[ok].abs().max()) if bool(ok.any()) else 0.0
    err = max(float((th_k - th_p)[~odd].abs().max()), lp_err)
    log(f"K2 propose ({'prior' if params is None else 'transition'}, "
        f"B={B}, d={prior_arrays['kind'].shape[0]}): max_abs_err={err:.3e} "
        f"lanes apart={int(odd.sum())} (all within 1e-4 of a bound: "
        f"{bool(near[odd].all())}) valid={int(v_k.sum())}/{B}")
    check(bool(near[odd].all()) and lp_err <= 1e-5 and int(ok.sum()) > 0,
          "K2 outside theta abs 1e-5 + rel 1e-5, logpri abs 1e-5, equal "
          "valid")
    return err


def k2_checks(dev, params, prior_arrays, B) -> dict:
    import torch

    from pyabc_tpu_torch.kernels import philox, propose, propose_plain

    err = max(compare_propose(dev, None, prior_arrays, B, philox.PRIOR),
              compare_propose(dev, params, prior_arrays, B,
                              philox.TRANSITION))
    st = stream_on(dev, philox.TRANSITION)
    n, d = params["thetas"].shape
    draws = float(redraws_taken(st, B, prior_arrays, params).sum())
    per_draw = k2_per_draw(n, d)
    nbytes = (n + n * d + d * d + 5 * d + 1) * 4 + B * (d * 4 + 4 + 1)
    log(f"K2 propose: {draws / B:.3f} draws per lane on these inputs")
    return dict(
        err=err,
        call_ms=time_ms(lambda: propose(st, B, prior_arrays, params), 50),
        ms=graph_ms(lambda: propose(st, B, prior_arrays, params)),
        plain_ms=time_ms(lambda: propose_plain(st, B, prior_arrays, params),
                         5),
        bound=bound(nbytes, draws * per_draw), library_ms=None)


def off_step(points, weights, alpha) -> bool:
    """True when alpha lies clear of float rounding of every step of the
    weighted CDF (float64 on the host)."""
    import numpy as np

    p = points.double().cpu().numpy()
    w = weights.double().cpu().numpy()
    cum = np.cumsum(w[np.argsort(p, kind="stable")])
    if not cum[-1] > 0:
        return True
    return bool(np.abs(cum / cum[-1] - alpha).min() > 1e-6)


def compare_quantile(points, weights, alpha) -> bool:
    from pyabc_tpu_torch.kernels import (normalize_quantile,
                                         weighted_quantile_plain)

    got = float(normalize_quantile.quantile(points, weights, alpha))
    ref = float(weighted_quantile_plain(points, weights, alpha))
    clear = off_step(points, weights, alpha)
    check(got == ref or not clear,
          f"K7 quantile {got} != plain {ref} with alpha clear of a step")
    return got == ref


def k7_checks(dev, logw, k_mask, dist) -> dict:
    """K7's two entries at the main-path shape (n_cap 1024, 1000 kept), as
    the generation step runs them: the normalization, then the weighted
    median epsilon (LV config 2's MedianEpsilon, multiplier 1) on the
    distances and the kept-row mask -> their rows."""
    import torch

    from pyabc_tpu_torch.kernels import (normalize_log_weights_plain,
                                         normalize_quantile,
                                         quantile_epsilon_plain)

    n = logw.shape[0]
    w_k = normalize_quantile.normalize(logw, k_mask)
    w_p = normalize_log_weights_plain(logw, k_mask)
    w_err = float(((w_k - w_p).abs() / w_p.abs().clamp_min(1e-30)).max())
    w_abs = float((w_k - w_p).abs().max())
    pts = torch.where(k_mask, dist, torch.full_like(dist, math.inf))
    same = [compare_quantile(pts, wts, a) for a in (0.5, 0.1, 0.9)
            for wts in (w_p, k_mask.float())]
    eps_same = [compare_epsilon(dist, k_mask, w_p, weighted, a, m)
                for weighted in (True, False) for a in (0.5, 0.9)
                for m in (1.0, 0.8)]
    log(f"K7 normalize_quantile (n={n}): max_rel_err(w)={w_err:.3e} "
        f"max_abs_err(w)={w_abs:.3e} quantile equal={same} epsilon "
        f"equal={eps_same}")
    check(w_err <= 1e-6, "K7 weights outside rel 1e-6")

    def eps():
        return normalize_quantile.quantile_epsilon(dist, k_mask, w_p, True,
                                                   0.5, 1.0)

    # the epsilon row's error, on the arguments it is timed with (NaN
    # against NaN, or inf against inf, is no error)
    e_k = float(eps())
    e_p = float(quantile_epsilon_plain(dist, k_mask, w_p, True, 0.5, 1.0))
    e_err = (0.0 if e_k == e_p or (math.isnan(e_k) and math.isnan(e_p))
             else abs(e_k - e_p) if math.isfinite(e_k - e_p) else math.inf)
    log(f"K7 quantile epsilon (n={n}, weighted median): kernel {e_k!r} "
        f"plain {e_p!r} abs err {e_err!r}")
    masked = torch.where(k_mask, logw, torch.full_like(logw, -math.inf))
    return {
        "normalize_quantile": dict(
            err=w_abs,
            call_ms=time_ms(lambda: normalize_quantile.normalize(
                logw, k_mask), 50),
            ms=graph_ms(lambda: normalize_quantile.normalize(logw, k_mask)),
            plain_ms=time_ms(lambda: normalize_log_weights_plain(
                logw, k_mask), 20),
            # log_w and mask read, w written; a max, an exp, a sum and a
            # divide a row
            bound=bound(n * (4 + 1 + 4), 4 * n),
            # torch.softmax of the masked log weights, timed as the kernel
            # is (CUDA graph replays) and, as before PR 23, eagerly
            library_ms=graph_ms(lambda: torch.softmax(masked, 0)),
            library_eager_ms=time_ms(lambda: torch.softmax(masked, 0), 50)),
        "normalize_quantile:epsilon": dict(
            err=e_err, call_ms=time_ms(eps, 50), ms=graph_ms(eps),
            plain_ms=time_ms(lambda: quantile_epsilon_plain(
                dist, k_mask, w_p, True, 0.5, 1.0), 20),
            # d, mask and w read, epsilon written; four 8-bit passes a row
            bound=bound(n * (4 + 1 + 4) + 4, 4 * n), library_ms=None)}


def compare_epsilon(d, mask, w, weighted, alpha, multiplier) -> bool:
    """K7's quantile epsilon against its plain version: bit-equal (NaN
    where NaN) on counts and, with float weights, wherever alpha is clear
    of a step; the same bits on a second launch."""
    import torch

    from pyabc_tpu_torch.kernels import (normalize_quantile,
                                         quantile_epsilon_plain)

    got = normalize_quantile.quantile_epsilon(d, mask, w, weighted, alpha,
                                              multiplier)
    again = normalize_quantile.quantile_epsilon(d, mask, w, weighted, alpha,
                                                multiplier)
    ref = quantile_epsilon_plain(d, mask, w, weighted, alpha, multiplier)
    pts = torch.where(mask, d, torch.full_like(d, math.inf))
    wts = torch.where(mask, w, torch.zeros_like(w)) if weighted \
        else mask.float()
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"K7 epsilon changed its bits from launch to launch (n "
          f"{d.shape[0]}, alpha {alpha})")
    equal = bool(torch.equal(got.view(torch.int32), ref.view(torch.int32))
                 or (got.isnan() and ref.isnan()))
    # exact on counts; with float weights, wherever alpha is clear of a
    # step of the CDF
    check(equal or (weighted and not off_step(pts, wts, alpha)),
          f"K7 epsilon {float(got)} != plain {float(ref)} (n {d.shape[0]}, "
          f"alpha {alpha}, weighted {weighted})")
    return equal


#: K7's sizes: the block mode's edges, the cluster mode's (16385 and
#: BASELINE config 3's 131072) and the passes mode above
K7_SIZES = (64, 1000, 1024, 5000, 16384, 16385, 131072, 131073)


def k7_mode_checks(dev) -> None:
    """K7's block, cluster and passes modes against their plain versions
    at every size of K7_SIZES: the normalization within rel 1e-6 and the
    same bits launch to launch; the quantile epsilon bit-equal wherever
    alpha is clear of a step (compare_epsilon) with a prefix, K24b's
    shard-blocked and an empty mask, ties and NaN distances, weighted and
    on counts (alpha 1.0 too); no weight at all gives the largest point;
    each launch counts in its size's mode."""
    import torch

    from pyabc_tpu_torch.kernels import (normalize_log_weights_plain,
                                         normalize_quantile,
                                         weighted_quantile_plain)
    from pyabc_tpu_torch.kernels.normalize_quantile import mode_of

    g = torch.Generator(device=dev)
    t0 = time.perf_counter()
    seen = {}
    for n in K7_SIZES:
        g.manual_seed(n)
        before = dict(normalize_quantile.mode_launches)
        lw = torch.randn(n, generator=g, device=dev) * 5 - 40
        idx = torch.arange(n, device=dev)
        cap = -(-n // 8)
        masks = {"prefix": idx < (4 * n) // 5,
                 "shard-blocked": (idx % cap) < (7 * cap) // 10,
                 "empty": torch.zeros(n, dtype=torch.bool, device=dev)}
        d = torch.rand(n, generator=g, device=dev) * 4
        d_nan = d.clone()
        d_nan[::97] = math.nan
        rel, equal, launches = 0.0, 0, 0
        for mask in masks.values():
            w_k = normalize_quantile.normalize(lw, mask)
            w_again = normalize_quantile.normalize(lw, mask)
            w_p = normalize_log_weights_plain(lw, mask)
            launches += 2
            check(torch.equal(w_k, w_again), f"K7 weights changed their "
                  f"bits from launch to launch (n {n})")
            check(within(w_k, w_p, 1e-12, 1e-6),
                  f"K7 weights outside rel 1e-6 (n {n})")
            rel = max(rel, float(((w_k - w_p).abs()
                                  / w_p.abs().clamp_min(1e-30)).max()))
            for dist in (d, d.mul(2).floor(), d_nan):
                for weighted, alpha in ((True, 0.5), (True, 0.9),
                                        (False, 0.1), (False, 1.0)):
                    equal += compare_epsilon(dist, mask, w_p, weighted,
                                             alpha, 0.8)
                    launches += 2
        zero = torch.zeros(n, device=dev)
        got = normalize_quantile.quantile(d, zero, 0.5)
        launches += 1
        check(float(got) == float(weighted_quantile_plain(d, zero, 0.5))
              == float(d.max()), f"K7 with no weight is not the largest "
              f"point (n {n})")
        torch.cuda.synchronize()
        mode = mode_of(n)
        for k in ("block", "cluster", "passes"):
            check(normalize_quantile.mode_launches[k] - before[k]
                  == (launches if k == mode else 0),
                  f"K7 launches at n {n} not all in the {mode} mode")
        seen[n] = (mode, rel, equal)
    log(f"K7 modes (n: mode, weights max rel err, epsilons bit-equal of 36 "
        f"cases): {seen} "
        f"({time.perf_counter() - t0:.1f} s)")


def compare_fit(got, ref) -> tuple[float, float]:
    """K8 against its plain version at the tolerances the tests hold
    against the JAX package -> (largest relative, largest absolute
    error)."""
    tol = {"thetas": 1e-5, "weights": 1e-5, "center": 1e-5, "cdf": 1e-5,
           "chol": 1e-4, "prec": 1e-4, "logdet": 1e-4, "quad": 1e-4}
    err = err_abs = 0.0
    for k, rt in tol.items():
        atol = 1e-7 if rt == 1e-5 else 1e-5
        check(within(got[k], ref[k], atol, rt), f"K8 {k} outside rel {rt}")
        diff = (got[k] - ref[k]).abs().nan_to_num(0.0)
        err = max(err, float((diff / ref[k].abs().clamp_min(1e-6)).max()))
        err_abs = max(err_abs, float(diff.max()))
    scale = 1e-5 * float(ref["center"].abs().max())
    check(within(got["thetas_c"], ref["thetas_c"], scale, 1e-5),
          "K8 centred rows outside the mean's error")
    return err, err_abs


def k8_checks(dev, thetas, k_mask, logw) -> dict:
    import torch

    from pyabc_tpu_torch.kernels import (mvn_fit, mvn_fit_plain,
                                         normalize_log_weights_plain)
    from pyabc_tpu_torch.kernels.mvn_fit import (chol_guarded_cuda,
                                                 device_chol_guarded)
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    n, d = thetas.shape
    w = normalize_log_weights_plain(logw, k_mask)
    kw = dict(dim=d, scaling=1.0, bandwidth_selector=silverman_rule_of_thumb)
    err, err_abs = compare_fit(mvn_fit(thetas, w, **kw),
                               mvn_fit_plain(thetas, w, **kw))
    rungs = []
    for x in (1.0, -1e-11, -1e-9, -1e-6, -1.0):
        cov = torch.diag(torch.tensor([1.0, 2.0, 0.5, x], device=dev))
        cov[0, 1] = cov[1, 0] = 0.3
        chol, used, rung = chol_guarded_cuda(cov)
        ref_chol, ref_used, bad = device_chol_guarded(cov)
        check(torch.equal(used, ref_used) and bool(bad) == (int(rung) == 4)
              and within(chol, ref_chol, 1e-7, 1e-5),
              f"K8 ladder disagrees with the plain version at {x}")
        rungs.append(int(rung))
    log(f"K8 mvn_fit (n={n}, d={d}): max_rel_err={err:.3e} max_abs_err="
        f"{err_abs:.3e}; ladder rungs {rungs} (expected [0, 1, 2, 3, 4])")
    check(rungs == [0, 1, 2, 3, 4], "K8 ladder took the wrong rung")
    nbytes = (n * (d + 1) + 2 * n * d + 3 * n + 2 * d * d + d + 1) * 4
    flops = n * (2 * d + 2 * d * d + 2 * d * d + 2 * d) + 2 * d ** 3
    return dict(err=err_abs,
                call_ms=time_ms(lambda: mvn_fit(thetas, w, **kw), 50),
                ms=graph_ms(lambda: mvn_fit(thetas, w, **kw)),
                plain_ms=time_ms(lambda: mvn_fit_plain(thetas, w, **kw), 20),
                bound=bound(nbytes, flops), library_ms=None)


def compare_scales(samples, valid, x0, rows, name) -> float:
    """K9 against its plain version: medians bit-exact, the rest within
    rel 1e-5; returns the largest absolute error."""
    from pyabc_tpu_torch.kernels import scale_reduce, scale_reduce_plain

    kw = dict(scale_name=name, max_weight_ratio=None, normalize_weights=True,
              rows=rows, p=2.0)
    got = scale_reduce(samples, valid, x0, **kw)
    ref = scale_reduce_plain(samples, valid, x0, **kw)
    if "median" in name:
        check(within(got[0], ref[0], 0.0, 0.0), f"K9 {name} not bit-exact")
    for a, b, what in zip(got, ref, ("scale", "weights", "distances")):
        check(within(a, b, 1e-6, 1e-5), f"K9 {name} {what} outside rel 1e-5")
    return max(float((a - b).abs().nan_to_num(0.0).max())
               for a, b in zip(got, ref))


def k9_checks(dev, ring, valid, x0, rows) -> dict:
    import torch

    from pyabc_tpu_torch.kernels import scale_reduce, scale_reduce_plain
    from pyabc_tpu_torch.kernels.scale_reduce import SCALE_NAMES

    n, S = ring.shape
    name = "median_absolute_deviation"
    err = compare_scales(ring, valid, x0, rows, name)
    others = max(compare_scales(ring, valid, x0, rows, other)
                 for other in SCALE_NAMES)
    log(f"K9 scale_reduce (ring {n}x{S}, {int(valid.sum())} valid, "
        f"{int(ring.isnan().any(1).sum())} NaN rows; {rows.shape[0]} rows): "
        f"MAD max_abs_err={err:.3e}; all 13 scales max_abs_err="
        f"{others:.3e}")
    kw = dict(scale_name=name, max_weight_ratio=None, normalize_weights=True,
              rows=rows, p=2.0)
    nbytes = n * S * 4 + n + S * 4 + rows.numel() * 4 + (2 * S
                                                        + rows.shape[0]) * 4
    masked = torch.where(valid[:, None], ring,
                         torch.full_like(ring, math.nan))
    return dict(
        err=err,
        call_ms=time_ms(lambda: scale_reduce(ring, valid, x0, **kw), 20),
        ms=graph_ms(lambda: scale_reduce(ring, valid, x0, **kw), iters=20),
        plain_ms=time_ms(lambda: scale_reduce_plain(ring, valid, x0, **kw),
                         10),
        bound=bound(nbytes, 8 * n * S),
        library_ms=time_ms(lambda: torch.nanquantile(masked, 0.5, dim=0),
                           10))


#: generations per chunk on the main path (ABCSMC's fused_generations)
G_CHUNK = 8


def compare_pack(theta, dist, logw, ss, n_keep, dtype) -> float:
    """K10 against its plain version: rows and sum stats bit-identical
    (NaN where NaN) -> the largest absolute difference (0)."""
    import torch

    from pyabc_tpu_torch.kernels import (cast_rows_plain, pack_fetch,
                                         pack_rows_plain)

    got = (pack_fetch.rows(theta, dist, logw, n_keep=n_keep, dtype=dtype),
           pack_fetch.sumstats(ss, n_keep=n_keep, dtype=dtype))
    ref = (pack_rows_plain(theta, dist, logw, n_keep=n_keep, dtype=dtype),
           cast_rows_plain(ss, n_keep=n_keep, dtype=dtype))
    err = 0.0
    for a, b in zip(got, ref):
        nan = a.isnan()
        check(a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(nan, b.isnan())
              and torch.equal(a[~nan], b[~nan]),
              f"K10 {dtype} not bit-identical to its plain version")
        err = max(err, float((a[~nan].float() - b[~nan].float()).abs()
                             .nan_to_num(0.0, 0.0, 0.0).max()))
    return err


def k10_checks(dev, theta, dist, logw, ss, n) -> dict:
    """K10 on a chunk of G_CHUNK reservoirs (n_cap rows each, the first
    POP kept), in every fetch dtype; timed in float16, the default."""
    import torch

    from pyabc_tpu_torch.kernels import pack_fetch, pack_rows_plain

    g = torch.Generator(device=dev)
    g.manual_seed(10)
    d = theta.shape[1]
    perm = [torch.randperm(theta.shape[0], generator=g, device=dev)[:n]
            for _ in range(G_CHUNK)]
    th = [theta[p].contiguous() for p in perm]
    di = [dist[p].contiguous() for p in perm]
    lw = [logw[p].contiguous() for p in perm]
    sst = [ss[p].contiguous() for p in perm]
    err = max(compare_pack(th, di, lw, sst, POP, dt)
              for dt in (torch.float16, torch.bfloat16, torch.float32))
    log(f"K10 pack_fetch (G={G_CHUNK}, n_cap={n}, n_keep={POP}, d={d}, "
        f"S={ss.shape[1]}; float16, bfloat16, float32): bit-identical, "
        f"max_abs_err={err:.3e}")
    f16 = torch.float16
    nbytes = G_CHUNK * POP * (d + 2) * (4 + 2)

    def rows():
        return pack_fetch.rows(th, di, lw, n_keep=POP, dtype=f16)

    return dict(
        err=err, call_ms=time_ms(rows, 50), ms=graph_ms(rows),
        plain_ms=time_ms(lambda: pack_rows_plain(th, di, lw, n_keep=POP,
                                                 dtype=f16), 20),
        bound=bound(nbytes, G_CHUNK * POP * 6), library_ms=None)


def health_inputs(dev, thetas, k_mask, logw, d_new, kind="ok") -> dict:
    """generation_health's inputs on a reservoir: the refit of the kept
    rows as both parameter sets, with one fault where ``kind`` says."""
    import torch

    from pyabc_tpu_torch.kernels import mvn_fit, normalize_quantile
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    n, d = thetas.shape
    w = normalize_quantile.normalize(logw, k_mask)
    fit = mvn_fit(thetas, w, dim=d, scaling=1.0,
                  bandwidth_selector=silverman_rule_of_thumb)
    nxt = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in fit.items()}
    n_keep = k_mask.sum(dtype=torch.int32)

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    x = dict(theta=thetas.clone(), k_mask=k_mask, w_norm=w,
             d_new=d_new.clone(), n_acc=n_keep, n_target=POP,
             acc_rate=f(0.3), trans_params=fit, trans_next=nxt,
             fitted=torch.tensor(True, device=dev), fitted_next=n_keep > 0,
             eps_g=f(0.5), eps_next=f(0.4), eps_prev=f(0.5 * (1 + 1e-7)),
             stall_count=torch.tensor(2, dtype=torch.int32, device=dev),
             ess_floor=0.0, acc_floor=0.0, stall_window=16,
             stall_rtol=1e-6)
    if kind == "nan_theta":
        x["theta"][int(n_keep) - 1, d - 1] = math.nan
    elif kind == "psd":
        nxt["chol"][d - 1, 0] = math.nan
    elif kind == "stall":
        x["stall_window"] = 3
    elif kind == "nan_distance":
        x["d_new"][0] = math.inf
    elif kind == "ess_floor":
        x["ess_floor"] = 2.0  # above any ESS of n_cap rows
    elif kind == "acc_collapse":
        x["acc_floor"] = 0.5
    return x


def compare_health(x) -> float:
    """K11 against its plain version: equal words and stall counts, ESS
    within rel 1e-5 -> the ESS's absolute error."""
    from pyabc_tpu_torch.kernels import (generation_health,
                                         generation_health_plain)

    word, ess, _e, stall = generation_health(**x)
    r_word, r_ess, _r, r_stall = generation_health_plain(**x)
    check(int(word) == int(r_word) and int(stall) == int(r_stall)
          and within(ess, r_ess, 0.0, 1e-5),
          f"K11 word {int(word)} stall {int(stall)} ess {float(ess)} "
          f"against plain {int(r_word)} {int(r_stall)} {float(r_ess)}")
    return abs(float(ess) - float(r_ess))


def k11_checks(dev, thetas, k_mask, logw, d_new) -> dict:
    from pyabc_tpu_torch.kernels import (generation_health,
                                         generation_health_plain)

    n, d = thetas.shape
    words, err = {}, 0.0
    for kind in ("ok", "nan_theta", "psd", "stall", "nan_distance",
                 "ess_floor", "acc_collapse"):
        x = health_inputs(dev, thetas, k_mask, logw, d_new, kind)
        err = max(err, compare_health(x))
        words[kind] = int(generation_health(**x)[0])
    log(f"K11 generation_health (n_cap={n}, d={d}): words {words}, "
        f"ess max_abs_err={err:.3e}")
    check(words["ok"] == 0 and all(words[k] for k in words if k != "ok"),
          "K11 missed a fault or flagged a healthy generation")
    x = health_inputs(dev, thetas, k_mask, logw, d_new)
    params = sum(v.numel() for p in (x["trans_params"], x["trans_next"])
                 for v in p.values() if hasattr(v, "numel"))
    nbytes = n * d * 4 + n + 2 * n * 4 + params * 4 + 8 * 4 + 3 * 4
    return dict(
        err=err, call_ms=time_ms(lambda: generation_health(**x), 50),
        ms=graph_ms(lambda: generation_health(**x)),
        plain_ms=time_ms(lambda: generation_health_plain(**x), 20),
        bound=bound(nbytes, n * d + 4 * n + params), library_ms=None)


def small_shape_checks(dev) -> None:
    """K2, K7-K11 at the Gaussian toy's shape: d = 1, n_cap = 64, S = 1, an
    odd valid count (33 of 64 reservoir rows, 301 of 512 ring rows)."""
    import torch

    from pyabc_tpu_torch.kernels import (mvn_fit, mvn_fit_plain,
                                         normalize_log_weights_plain,
                                         normalize_quantile, philox)
    from pyabc_tpu_torch.kernels.scale_reduce import SCALE_NAMES
    from pyabc_tpu_torch.models import gaussian
    from pyabc_tpu_torch.transition import scott_rule_of_thumb

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    n, B = 64, 256
    prior_arrays = gaussian.mean_only_prior().arrays(dev)
    k_mask = torch.arange(n, device=dev) < 33
    thetas = torch.where(k_mask[:, None],
                         torch.randn(n, 1, generator=g, device=dev),
                         torch.zeros(n, 1, device=dev))
    logw = torch.where(k_mask, torch.randn(n, generator=g, device=dev),
                       torch.full((n,), -math.inf, device=dev))
    w_k = normalize_quantile.normalize(logw, k_mask)
    w_p = normalize_log_weights_plain(logw, k_mask)
    check(within(w_k, w_p, 0.0, 1e-6), "K7 weights outside rel 1e-6 (small)")
    dist = torch.rand(n, generator=g, device=dev)
    pts = torch.where(k_mask, dist, torch.full_like(dist, math.inf))
    q_same = [compare_quantile(pts, wts, 0.5)
              for wts in (w_p, k_mask.float())]
    kw = dict(dim=1, scaling=1.0, bandwidth_selector=scott_rule_of_thumb)
    params = mvn_fit(thetas, w_p, **kw)
    fit_err = compare_fit(params, mvn_fit_plain(thetas, w_p, **kw))[0]
    p_err = max(compare_propose(dev, None, prior_arrays, B, philox.PRIOR),
                compare_propose(dev, params, prior_arrays, B,
                                philox.TRANSITION))
    ring = torch.randn(512, 1, generator=g, device=dev)
    ring_valid = torch.arange(512, device=dev) < 301
    x0 = torch.ones(1, device=dev)
    s_err = max(compare_scales(ring, ring_valid, x0, dist[:, None], name)
                for name in SCALE_NAMES)
    pk_err = max(compare_pack(
        [thetas] * 3, [dist] * 3, [logw] * 3, [ring[:n]] * 3, 33, dt)
        for dt in (torch.float16, torch.bfloat16, torch.float32))
    h_err = max(compare_health(dict(
        health_inputs(dev, thetas, k_mask, logw, dist, kind), n_target=33))
        for kind in ("ok", "nan_theta", "psd"))
    log(f"small shape (d=1, n_cap=64, 33 valid rows; ring 512x1, 301 "
        f"valid): K2 max_abs_err={p_err:.3e}, K7 quantile equal={q_same}, "
        f"K8 max_rel_err={fit_err:.3e}, K9 max_abs_err={s_err:.3e}, K10 "
        f"max_abs_err={pk_err:.3e}, K11 ess max_abs_err={h_err:.3e}")


def sir_inputs(dev, B: int, rounds: int = 1):
    """``rounds`` rounds of SIR config 4 prior lanes: theta, the prior's
    log-density (the records' logq), K20's rows and their kernel values."""
    import torch

    from pyabc_tpu_torch.kernels import philox, propose, sir_simulate
    from pyabc_tpu_torch.kernels.kernel_accept import noise_logdensity_rows
    from pyabc_tpu_torch.models import sir

    model = sir.make_sir_model()
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              n_pop=sir.N_POP)
    parts = [propose(stream_on(dev, philox.PRIOR, rounds=r), B,
                     sir.default_prior().arrays(dev))[:2]
             for r in range(1, rounds + 1)]
    theta = torch.cat([p[0] for p in parts]).contiguous()
    logpri = torch.cat([p[1] for p in parts])
    ss = sir_simulate(theta, **kw)
    x0 = torch.as_tensor(sir.observed_data(seed=11)["infected"],
                         dtype=torch.float32, device=dev)
    var = torch.full((model.n_obs,), 100.0, device=dev)
    v = noise_logdensity_rows("independent_normal", ss, x0, var)
    return dict(theta=theta, logpri=logpri, ss=ss, x0=x0, var=var, v=v,
                kw=kw)


def noisy_checks(dev) -> dict:
    """K20, K21a, K6's record mode and K21b against their plain versions
    at config 4's shapes and at a small odd shape."""
    x = sir_inputs(dev, B_MAIN, rounds=2)
    results = {"sir_simulate": k20_checks(dev, x)}
    results["kernel_accept"] = k21a_checks(dev, x)
    results["compact_round_record"] = k6_record_checks(dev, x)
    results["temperature_update"] = k21b_checks(dev, x)
    return results


def k20_checks(dev, x) -> dict:
    import torch

    from pyabc_tpu_torch.kernels import philox, sir_simulate, \
        sir_simulate_plain

    theta, kw = x["theta"][:B_MAIN].contiguous(), x["kw"]
    got = sir_simulate(theta, **kw)
    ref = sir_simulate_plain(theta, **kw)
    small = x["theta"][:77].contiguous()
    noise = dict(noise_sd=10.0, stream=stream_on(dev, philox.SIM_NOISE))
    s_got = sir_simulate(small, **noise, **kw)
    s_ref = sir_simulate_plain(small, **noise, **kw)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1)).max())
    s_err = float((s_got - s_ref).abs().max())
    log(f"K20 sir_simulate (B={B_MAIN}, 15 x 8 substeps): max_abs_err="
        f"{err:.3e} max_rel_err={rel:.3e}; B=77 with Philox noise "
        f"max_abs_err={s_err:.3e}; infected up to {float(ref.max()):.1f}")
    check(bool((got - ref).abs().le(1e-3 + 1e-4 * ref.abs()).all())
          and bool((s_got - s_ref).abs().le(1e-3 + 1e-4 * s_ref.abs())
                   .all()),
          "K20 outside |err| <= 1e-3 + 1e-4 |x| (FMA contraction over 112 "
          "RK4 steps)")
    B = B_MAIN
    steps = 14 * 8
    # per RK4 step 4 right-hand sides (6 ops) + 3 stages and the update
    # of 3 states (about 42 ops)
    return dict(
        err=err, call_ms=time_ms(lambda: sir_simulate(theta, **kw), 50),
        ms=graph_ms(lambda: sir_simulate(theta, **kw)),
        plain_ms=time_ms(lambda: sir_simulate_plain(theta, **kw), 3),
        bound=bound(B * (2 + 15) * 4, B * steps * 66), library_ms=None)


def k21a_checks(dev, x) -> dict:
    import torch

    from pyabc_tpu_torch.kernels import (kernel_accept, kernel_accept_plain,
                                         philox)
    from pyabc_tpu_torch.kernels.kernel_accept import accept_uniforms

    g = torch.Generator(device=dev)
    g.manual_seed(21)
    B, S = B_MAIN, 15
    ss, x0, var = x["ss"][:B].contiguous(), x["x0"], x["var"]
    pdf_max = -0.5 * 15 * (math.log(2 * math.pi) + math.log(100.0))
    temp = torch.tensor(300.0, device=dev)
    pdf_norm = torch.tensor(pdf_max, dtype=torch.float32, device=dev)
    valid = torch.rand(B, generator=g, device=dev) > 0.05
    stream = stream_on(dev, philox.ACCEPT)
    kw = dict(stream=stream, lin=False, apply_iw=True,
              logpri=x["logpri"][:B].contiguous(),
              logq=torch.randn(B, generator=g, device=dev))
    args = (ss, x0, var, temp, pdf_norm, valid)
    err = flips = 0
    for mode in ("transition", "prior", "lin", "small"):
        a_kw = dict(kw)
        a_args = args
        if mode != "transition":
            a_kw.update(logpri=None, logq=None)
        if mode == "lin":
            a_kw["lin"] = True
        if mode == "small":
            a_args = (ss[:77].contiguous(), x0, var, temp, pdf_norm,
                      valid[:77].contiguous())
        v, a, lw = kernel_accept(*a_args, **a_kw)
        v_r, a_r, lw_r = kernel_accept_plain(*a_args, **a_kw)
        check(torch.allclose(v, v_r, rtol=1e-5, atol=1e-4, equal_nan=True)
              and torch.allclose(lw, lw_r, rtol=1e-5, atol=1e-5,
                                 equal_nan=True),
              f"K21a ({mode}) v or log weight outside rel 1e-5")
        ratio = ((torch.log(v_r.clamp_min(1e-30)) if a_kw["lin"] else v_r)
                 - pdf_norm) / temp
        logu = torch.log(accept_uniforms(stream, v.shape[0]))
        clear = (logu - ratio).abs() > 1e-5 * (1 + ratio.abs())
        check(bool(torch.equal(a[clear], a_r[clear])),
              f"K21a ({mode}) accept flags differ away from the boundary")
        flips += int((a != a_r).sum())
        fin = lw_r.isfinite()
        err = max(err, float((lw - lw_r)[fin].abs().max()),
                  float((v - v_r).abs().max()))
    v, a, lw = kernel_accept(*args, **kw)
    log(f"K21a kernel_accept (B={B}, S={S}; transition, prior, SCALE_LIN "
        f"and B=77): max_abs_err={err:.3e} flags apart {flips} (all "
        f"within 1e-5 of log u); accepted {int(a.sum())}/{B} at T=300")
    # read the rows, x0, var, the scalars, flags, logpri and logq once;
    # write v, accept, log weight; per lane S (log + 5 flops) + ~20 and
    # one Philox block (~100 integer operations)
    nbytes = B * S * 4 + 2 * S * 4 + 8 + B + 2 * B * 4 + B * (4 + 1 + 4)
    return dict(
        err=err, call_ms=time_ms(lambda: kernel_accept(*args, **kw), 100),
        ms=graph_ms(lambda: kernel_accept(*args, **kw)),
        plain_ms=time_ms(lambda: kernel_accept_plain(*args, **kw), 20),
        bound=bound(nbytes, B * (S * 6 + 20 + 100)), library_ms=None)


def k6_record_checks(dev, x) -> dict:
    """K6 in record mode (the ring keeps theta and logq) on a config 4
    first round: reservoir, ring and counters bit-identical."""
    import torch

    from pyabc_tpu_torch.kernels import compact_round, compact_round_plain

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    B, n, S, d = B_MAIN, N_CAP_MAIN, 15, 2
    rec_cap = 8 * n
    theta, ss = x["theta"][:B].contiguous(), x["ss"][:B].contiguous()
    dist, logq = x["v"][:B].contiguous(), x["logpri"][:B].contiguous()
    logw = torch.randn(B, generator=g, device=dev)
    accept = torch.rand(B, generator=g, device=dev) < 0.3
    valid = torch.ones(B, dtype=torch.bool, device=dev)

    def buffers(n_, rec_):
        f = dict(device=dev)
        res = {"theta": torch.zeros(n_, d, **f),
               "sumstats": torch.zeros(n_, S, **f),
               "distance": torch.zeros(n_, **f),
               "log_weight": torch.full((n_,), -math.inf, **f),
               "slot": torch.full((n_,), -1, dtype=torch.int32, **f)}
        rec = {"sumstats": torch.zeros(rec_, S, **f),
               "distance": torch.zeros(rec_, **f),
               "accepted": torch.zeros(rec_, dtype=torch.bool, **f),
               "valid": torch.zeros(rec_, dtype=torch.bool, **f),
               "theta": torch.zeros(rec_, d, **f),
               "logq": torch.zeros(rec_, **f)}
        return res, rec

    exact = True
    for B_, n_, rec_ in ((B, n, rec_cap), (77, 64, 100)):
        k_in = (accept[:B_], valid[:B_], theta[:B_], ss[:B_], dist[:B_],
                logw[:B_])
        k_in = tuple(t.contiguous() for t in k_in)
        (rk, ck), (rp, cp) = buffers(n_, rec_), buffers(n_, rec_)
        ctr_k = torch.zeros(4, dtype=torch.int32, device=dev)
        ctr_p = torch.zeros(4, dtype=torch.int32, device=dev)
        for _ in range(2):  # the second round overflows the small ring
            compact_round(*k_in, rk, ck, ctr_k, logq=logq[:B_].contiguous())
            compact_round_plain(*k_in, rp, cp, ctr_p,
                                logq[:B_].contiguous())
        exact = exact and torch.equal(ctr_k, ctr_p) and all(
            torch.equal(a, b) for a, b in [*zip(rk.values(), rp.values()),
                                           *zip(ck.values(), cp.values())])
    log(f"K6 compact_round record mode (B={B}, n_cap={n}, ring {rec_cap} "
        f"with theta and logq; B=77, ring 100, two rounds): exact={exact}")
    check(exact, "K6 record mode not bit-identical")
    res_k, rec_k = buffers(n, rec_cap)
    ctr_g = torch.zeros(4, dtype=torch.int32, device=dev)
    k_in = (accept, valid, theta, ss, dist, logw)
    acc = accept & valid
    n_res = min(int(acc.sum()), n)
    n_ring = min(int(valid.sum()), rec_cap)  # a first round: every row
    # read the flags, each kept row's sumstats, distance and theta once,
    # log weights of reservoir rows and logq of ring rows; write both
    nbytes = (2 * B + n_ring * (S + 1 + d) * 4 + n_res * 4 + n_ring * 4
              + n_res * (d + S + 3) * 4 + n_ring * ((S + 1 + d + 1) * 4 + 2)
              + 2 * 3 * 4)
    return dict(
        err=0.0 if exact else math.inf,
        call_ms=time_ms(lambda: compact_round(
            *k_in, res_k, rec_k, torch.zeros(4, dtype=torch.int32,
                                             device=dev), logq=logq), 50),
        ms=graph_ms(lambda: (ctr_g.zero_(), compact_round(
            *k_in, res_k, rec_k, ctr_g, logq=logq))),
        plain_ms=time_ms(lambda: compact_round_plain(
            *k_in, res_k, rec_k, torch.zeros(4, dtype=torch.int32,
                                             device=dev), logq), 10),
        bound=bound(nbytes, 0.0), library_ms=None)


def k21b_inputs(dev, x, n_cap, rec_cap, n_keep, n_valid):
    """A generation step's K21b inputs from config 4 prior lanes: the ring
    (kernel values, prior logq, theta), the reservoir's first rows and the
    density of the ring under a refit of them (K3)."""
    import torch

    from pyabc_tpu_torch.kernels import mvn_mixture_logpdf, mvn_fit
    from pyabc_tpu_torch.kernels import normalize_quantile
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    k_mask = torch.arange(n_cap, device=dev) < n_keep
    res_v = x["v"][:n_cap].contiguous()
    logw = torch.where(k_mask, -0.01 * res_v.abs(),
                       torch.full_like(res_v, -math.inf))
    w_norm = normalize_quantile.normalize(logw, k_mask)
    fit = mvn_fit(x["theta"][:n_cap].contiguous(), w_norm, dim=2,
                  scaling=1.0, bandwidth_selector=silverman_rule_of_thumb)
    rec = {"distance": x["v"][:rec_cap].contiguous(),
           "valid": torch.arange(rec_cap, device=dev) < n_valid,
           "logq": x["logpri"][:rec_cap].contiguous()}
    logq_new = mvn_mixture_logpdf(x["theta"][:rec_cap].contiguous(), fit)

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return dict(rec=rec, logq_new=logq_new, res_distance=res_v,
                k_mask=k_mask, w_norm=w_norm, pdf_norm=f(-48.32285),
                max_found=f(-60.0), daly_k=f(1500.0), temp=f(2000.0),
                acc_rate=f(0.05))


def k21b_checks(dev, x) -> dict:
    import torch

    from pyabc_tpu_torch.epsilon.temperature import TempConfig
    from pyabc_tpu_torch.kernels import temperature_update
    from pyabc_tpu_torch.kernels.temperature_update import scheme_tables

    default = (("acceptance_rate", 0.3), ("exp_decay_fixed_iter",))
    cases = [default, (("poly_decay_fixed_iter", 3.0),),
             (("exp_decay_fixed_ratio", 0.5, 1e-4, 0.5),),
             (("friel_pettitt",),), (("daly", 0.5, 0.1),), (("ess", 0.8),),
             ()]
    results, err = [], 0.0
    for shape in ((N_CAP_MAIN, 8 * N_CAP_MAIN, POP, 8 * N_CAP_MAIN),
                  (64, 512, 33, 301)):
        inp = k21b_inputs(dev, x, *shape)
        for schemes in cases:
            for scaled in (None, (10.0, 0.5)):
                cfg = TempConfig(schemes=schemes, max_np=SIR_GENS,
                                 pdf_max=None if scaled else -48.32285,
                                 lin=False, pdf_scaled=scaled,
                                 initial=("acceptance_rate", 0.3))
                got = temperature_update.update(
                    **inp, tables=scheme_tables(schemes, dev), t_next=3,
                    config=cfg)
                ref = temperature_update_plain_of(inp, schemes, cfg)
                t0 = temperature_update.initial(
                    res_distance=inp["res_distance"], k_mask=inp["k_mask"],
                    tables=scheme_tables((cfg.initial,), dev), config=cfg)
                t0_ref = temperature_update_plain_of(
                    inp, (cfg.initial,), cfg, calibration=True)
                got = [float(t) for t in got] + [float(t) for t in t0]
                ref = [float(t) for t in ref] + [float(t) for t in t0_ref]
                bis = any(s[0] in ("acceptance_rate", "ess")
                          for s in schemes)
                for i, (a, b) in enumerate(zip(got, ref)):
                    rt = 1e-4 if i in (0, 4) and (bis or i == 4) else 1e-6
                    check(abs(a - b) <= rt * abs(b),
                          f"K21b {schemes} scaled={scaled} output {i}: "
                          f"{a} against plain {b}")
                    err = max(err, abs(a - b))
                results.append(got[0])
    log(f"K21b temperature_update (ring {8 * N_CAP_MAIN}, n_cap "
        f"{N_CAP_MAIN}; ring 512 with 301 valid, n_cap 64 with 33; 7 scheme "
        f"sets x pdf_max / ScaledPDFNorm, and the initial T): "
        f"max_abs_err={err:.3e}; temperatures "
        f"{[round(t, 3) for t in results]}")
    inp = k21b_inputs(dev, x, N_CAP_MAIN, 8 * N_CAP_MAIN, POP,
                      8 * N_CAP_MAIN)
    cfg = TempConfig(schemes=default, max_np=SIR_GENS, pdf_max=-48.32285,
                     lin=False, pdf_scaled=None,
                     initial=("acceptance_rate", 0.3))
    tables = scheme_tables(default, dev)

    def run():
        return temperature_update.update(**inp, tables=tables, t_next=3,
                                         config=cfg)

    R, n = 8 * N_CAP_MAIN, N_CAP_MAIN
    # read the ring's kernel values, flags and both log densities, the
    # reservoir's values, mask and weights once; 61 bisection steps of
    # ~5 operations per record, ~10 per record to prepare
    nbytes = R * (4 + 1 + 4 + 4) + n * (4 + 1 + 4) + 5 * 4 + 16
    return dict(
        err=err, call_ms=time_ms(run, 50), ms=graph_ms(run, iters=20),
        plain_ms=time_ms(lambda: temperature_update_plain_of(inp, default,
                                                             cfg), 3),
        bound=bound(nbytes, R * (10 + 61 * 5)), library_ms=None)


def temperature_update_plain_of(inp, schemes, cfg, calibration=False):
    """K21b's plain version on the kernel's inputs (as ``update`` and
    ``initial`` pass them)."""
    import torch

    from pyabc_tpu_torch.kernels.temperature_update import (
        FALLBACK_T0, temperature_update_plain)

    kw = dict(schemes=schemes, t_next=0 if calibration else 3,
              max_np=cfg.max_np, pdf_max=cfg.pdf_max, lin=cfg.lin,
              pdf_scaled=cfg.pdf_scaled)
    if calibration:
        v, mask = inp["res_distance"], inp["k_mask"]
        inf = torch.tensor(math.inf, device=v.device)
        return temperature_update_plain(
            rec_distance=v, rec_valid=mask, rec_logq=None, logq_new=None,
            res_distance=v, k_mask=mask, w_norm=torch.zeros_like(v),
            pdf_norm=-inf, max_found=-inf, daly_k=inf, temp=inf,
            acc_rate=torch.zeros((), device=v.device), fallback=FALLBACK_T0,
            **kw)[:3]
    rec = inp["rec"]
    return temperature_update_plain(
        rec_distance=rec["distance"], rec_valid=rec["valid"],
        rec_logq=rec["logq"], logq_new=inp["logq_new"],
        res_distance=inp["res_distance"], k_mask=inp["k_mask"],
        w_norm=inp["w_norm"], pdf_norm=inp["pdf_norm"],
        max_found=inp["max_found"], daly_k=inp["daly_k"], temp=inp["temp"],
        acc_rate=inp["acc_rate"], **kw)


# ------------------------------------------------- phase 2, model selection
#: config 5's shapes: K models, d_max, the ODE family's S, a chunk of G
K_MODELS, D_MAX_C5, S_C5 = 3, 2, 12


def model_priors(dev, K: int, d_max: int):
    """Stacked priors: the ODE family's (K 3, d_max 2) or, for the small
    shape, K one-dimensional ones (a uniform and normals)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.core.random_variables import stacked_arrays
    from pyabc_tpu_torch.models import model_selection as msel

    if (K, d_max) == (K_MODELS, D_MAX_C5):
        priors = msel.ode_family()[1]
    else:
        priors = [pt.Distribution(a=pt.RV("uniform", -1.0, 2.0))] + [
            pt.Distribution(a=pt.RV("norm", 0.1 * k, 1.0))
            for k in range(1, K)]
    return stacked_arrays(priors, dev)


def near_step(u, p):
    """Lanes whose uniform lies within float32 rounding of a step of the
    inverse CDF over the rows ``p (B, K)`` (or one row): there the kernel
    and the plain version may take neighbouring models."""
    import torch

    p = p.expand(u.shape[0], -1)
    cum = torch.cumsum(p.double(), dim=1)
    x = u.double()[:, None] * cum[:, -1:]
    return ((cum - x).abs() <= 1e-5 * cum[:, -1:]).any(dim=1)


def compare_propose_models(dev, B, priors, model_p, params=None, mpk=None,
                           lp_rtol: float = 0.0, local: bool = False):
    """K2's K > 1 mode against its plain version: the model of every lane
    equal (but where its uniform lies within rounding of a step), theta
    and logpri as compare_propose (logpri within 1e-5 + ``lp_rtol``
    relative: the families' lgamma terms run to hundreds); ``local``: its
    K > 1 local mode on stacked LocalTransition params."""
    import torch

    from pyabc_tpu_torch.kernels import philox, propose, propose_local
    from pyabc_tpu_torch.kernels.propose import (categorical_plain,
                                                 lane_blocks, model_stream,
                                                 propose_models_plain,
                                                 uniform_of)

    st = stream_on(dev, philox.PRIOR if params is None
                   else philox.TRANSITION)
    got = (propose_local if local else propose).models(st, B, priors,
                                                       model_p, params, mpk)
    ref = propose_models_plain(st, B, priors, model_p, params, mpk,
                               local=local)
    lanes = torch.arange(B, device=dev)
    w = lane_blocks(model_stream(st), lanes,
                    torch.zeros((), dtype=torch.int64, device=dev))
    if params is None:
        near = near_step(uniform_of(w[0]), model_p[None, :])
    else:
        probs = torch.exp(model_p)[None, :]
        near = near_step(uniform_of(w[0]), probs)
        anc = categorical_plain(probs.expand(B, -1), uniform_of(w[0]))
        near |= near_step(uniform_of(w[1]), mpk[anc.long()])
    th_k, lp_k, v_k, m_k = got
    th_p, lp_p, v_p, m_p = ref
    K = priors["loc"].shape[0]
    lo, hi = priors["loc"][m_p.long()], priors["hi"][m_p.long()]
    bound_ = ((((th_p - lo).abs() < 1e-4) | ((th_p - hi).abs() < 1e-4))
              & (priors["kind"][m_p.long()] == 1)).any(dim=1)
    same_m = m_k == m_p
    odd = ~same_m | (v_k != v_p) | (
        (th_k - th_p).abs() - 1e-5 * th_p.abs() > 1e-5).any(dim=1)
    ok = ~odd & v_p
    lp_err = float((lp_k - lp_p)[ok].abs().max()) if bool(ok.any()) else 0.
    lp_out = (float(((lp_k - lp_p).abs() - lp_rtol * lp_p.abs())[ok].max())
              if bool(ok.any()) else 0.0)
    err = max(float((th_k - th_p)[~odd].abs().max()), lp_err)
    padded = torch.arange(th_k.shape[1], device=dev)[None, :] >= \
        priors["dims"][m_k.long()][:, None]
    log(f"K2 propose{' local' if local else ''} K>1 "
        f"({'prior' if params is None else 'transition'}, "
        f"B={B}, K={K}, d_max={th_k.shape[1]}): max_abs_err={err:.3e} "
        f"models apart={int((~same_m).sum())} (all near a step: "
        f"{bool(near[~same_m].all())}), lanes apart={int(odd.sum())} "
        f"model counts {torch.bincount(m_k.long(), minlength=K).tolist()}")
    check(bool(near[~same_m].all()) and bool((bound_ | ~same_m)[odd].all())
          and lp_out <= 1e-5 and bool((th_k[padded] == 0).all()),
          "K2 K>1 outside: models equal away from a step, theta abs 1e-5 + "
          "rel 1e-5, logpri abs 1e-5 (+ rel lp_rtol), padded entries "
          "exactly 0")
    return err, got


def model_round(dev, B, n, K, d_max, S, n_keep, seed):
    """One round of a run over K models and the generation step's inputs
    on its first n rows: K2 (prior mode), K20b (noise on Philox), a
    reservoir with n_keep kept rows and normalized weights."""
    import torch

    from pyabc_tpu_torch.kernels import philox, propose
    from pyabc_tpu_torch.models import model_selection as msel

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    priors = model_priors(dev, K, d_max)
    prior_p = torch.full((K,), 1.0 / K, device=dev)
    theta, logpri, _v, m = propose.models(stream_on(dev, philox.PRIOR), B,
                                          priors, prior_p)
    fam = msel.ode_family(n_obs=S)[0][0].family
    sim_kw = dict(n_obs=S, n_substeps=fam.n_substeps, dt=fam.dt, y0=msel.Y0,
                  noise_sd=fam.noise_sd,
                  stream=stream_on(dev, philox.SIM_NOISE))
    k_mask = torch.arange(n, device=dev) < n_keep
    logw = torch.where(k_mask, torch.randn(n, generator=g, device=dev),
                       torch.full((n,), -math.inf, device=dev))
    w = torch.softmax(logw, 0)
    return dict(priors=priors, prior_p=prior_p, theta=theta, m=m,
                logpri=logpri, sim_kw=sim_kw, k_mask=k_mask, w=w,
                res_theta=theta[:n].contiguous(), res_m=m[:n].contiguous(),
                fitted=torch.ones(K, dtype=torch.bool, device=dev))


def model_checks_at(dev, B, n, K, d_max, S, n_keep, seed, timed):
    """Every K > 1 mode and K20b, K26 against their plain versions on one
    shape; with ``timed`` also their times and bounds -> results."""
    import torch

    from pyabc_tpu_torch.kernels import (compact_round, compact_round_plain,
                                         generation_health, philox,
                                         generation_health_plain, model_step,
                                         model_step_plain, mvn_fit,
                                         mvn_mixture_logpdf,
                                         ode_family_simulate,
                                         ode_family_simulate_plain,
                                         pack_fetch, pnorm_accept_weight,
                                         pnorm_accept_weight_plain, propose)
    from pyabc_tpu_torch.kernels.mvn_fit import mvn_fit_models_plain
    from pyabc_tpu_torch.kernels.mvn_logpdf import (
        mvn_mixture_logpdf_models_plain)
    from pyabc_tpu_torch.kernels.pack_fetch import pack_models_plain
    from pyabc_tpu_torch.kernels.propose import propose_models_plain
    from pyabc_tpu_torch.transition import (ModelPerturbationKernel,
                                            silverman_rule_of_thumb)

    x = model_round(dev, B, n, K, d_max, S, n_keep, seed)
    pri, theta, m = x["priors"], x["theta"], x["m"]
    res = {}
    shape = f"B={B}, n_cap={n}, K={K}, d_max={d_max}, S={S}"

    # K2 prior mode
    p_err, _ = compare_propose_models(dev, B, pri, x["prior_p"])

    # K20b on the round
    ss_k = ode_family_simulate(theta, m, **x["sim_kw"])
    ss_p = ode_family_simulate_plain(theta, m, **x["sim_kw"])
    fin = torch.isfinite(ss_p)
    check(torch.equal(fin, torch.isfinite(ss_k)), "K20b non-finite lanes "
          "differ")
    ode_err = float((ss_k - ss_p).abs()[fin].max())
    check(bool(((ss_k - ss_p).abs()[fin]
                <= 1e-4 + 1e-4 * ss_p.abs()[fin]).all()),
          "K20b outside |err| <= 1e-4 + 1e-4 |x| (the RK4 rounds each "
          "operation once, as the plain version; Philox normals within "
          "2e-6)")
    log(f"K20b ode_family_simulate ({shape}): max_abs_err={ode_err:.3e} "
        f"non-finite lanes={int((~fin).any(1).sum())}")

    # K26 on the reservoir
    mpk = torch.as_tensor(ModelPerturbationKernel(K).device_params(),
                          device=dev)
    step_in = (x["res_m"], x["w"], x["k_mask"], x["fitted"], mpk)
    st_k, st_p = model_step(*step_in), model_step_plain(*step_in)
    check(torch.equal(st_k["counts"], st_p["counts"])
          and torch.equal(st_k["fitted"], st_p["fitted"]),
          "K26 counts or fitted differ")
    step_err = 0.0
    for key in ("model_probs", "log_model_probs", "matrix",
                "log_model_factor"):
        check(within(st_k[key], st_p[key], 1e-7, 1e-5),
              f"K26 {key} outside rel 1e-5")
        step_err = max(step_err, float((st_k[key] - st_p[key]).abs()
                                       .nan_to_num(0.0).max()))
    log(f"K26 model_step ({shape}, {n_keep} kept): counts "
        f"{st_k['counts'].tolist()} max_abs_err={step_err:.3e}")

    # K8 per model, one launch
    dims = [int(v) for v in pri["dims"].tolist()]
    statics = [dict(scaling=1.0, bandwidth_selector=silverman_rule_of_thumb)
               ] * K
    fit_in = (x["res_theta"], x["w"], x["res_m"])
    # the dims as a device tensor built once, as the run does (a copy to
    # the card could not be captured in a CUDA graph)
    fit_kw = dict(dims=dims, statics=statics,
                  dims_tensor=pri["dims"].to(torch.float32))
    fit_k = mvn_fit.models(*fit_in, **fit_kw)
    fit_p = mvn_fit_models_plain(*fit_in, **fit_kw)
    fit_err = 0.0
    for k in range(K):
        one = [{key: v[k] for key, v in f.items() if key != "dims"}
               for f in (fit_k, fit_p)]
        fit_err = max(fit_err, compare_fit(*one)[1])
    log(f"K8 mvn_fit K>1 ({shape}): max_abs_err={fit_err:.3e}")

    # K2 transition mode and K3 on its proposals
    lmp, matrix = st_k["log_model_probs"], st_k["matrix"]
    t_err, (q, _lp, q_valid, qm) = compare_propose_models(
        dev, B, pri, lmp, fit_k, matrix)
    p_err = max(p_err, t_err)
    lq_k = mvn_mixture_logpdf.models(q, qm, fit_k)
    lq_p = mvn_mixture_logpdf_models_plain(q, qm, fit_k)
    lq_err = float((lq_k - lq_p).abs().max())
    log(f"K3 mvn_mixture_logpdf K>1 ({shape}): max_abs_err={lq_err:.3e}")
    check(lq_err <= 1e-3, "K3 K>1 outside |err| <= 1e-3")

    # K5 with the model terms
    logits = torch.log(x["prior_p"])
    lmf = st_k["log_model_factor"]
    qss = ode_family_simulate_plain(q, qm, **x["sim_kw"])
    eps = torch.nanquantile(torch.linalg.vector_norm(qss - qss[0], dim=1),
                            0.3)
    k5_args = (qss, qss[0].contiguous(), torch.ones(S, device=dev), eps,
               q_valid)
    k5_kw = dict(p=2.0, logpri=_lp, logq=lq_p, m=qm, model_logits=logits,
                 log_model_factor=lmf)
    d_k, a_k, lw_k = pnorm_accept_weight(*k5_args, **k5_kw)
    d_p, a_p, lw_p = pnorm_accept_weight_plain(*k5_args, **k5_kw)
    far = (d_p - eps).abs() > 1e-5 * eps.abs()
    fin = torch.isfinite(lw_p)
    d_fin = torch.isfinite(d_p)
    k5_err = max(float(((d_k - d_p).abs() / d_p.abs().clamp_min(1.0))
                       [d_fin].max()),
                 float((lw_k - lw_p).abs()[fin].max()) if bool(fin.any())
                 else 0.0)
    check(k5_err <= 1e-5 and bool((a_k == a_p)[far].all())
          and torch.equal(torch.isfinite(lw_k), fin)
          and torch.equal(torch.isfinite(d_k), d_fin),
          "K5 K>1 outside rel 1e-5 or flags differ")
    log(f"K5 pnorm_accept_weight K>1 ({shape}): max_err={k5_err:.3e} "
        f"accepted={int(a_k.sum())}/{B}")

    # K6 with the model column
    def buffers():
        f32 = torch.float32
        r = {"theta": torch.zeros(n, d_max, device=dev),
             "sumstats": torch.zeros(n, S, device=dev),
             "distance": torch.zeros(n, device=dev),
             "log_weight": torch.full((n,), -math.inf, dtype=f32,
                                      device=dev),
             "slot": torch.full((n,), -1, dtype=torch.int32, device=dev),
             "m": torch.zeros(n, dtype=torch.int32, device=dev)}
        return r, torch.zeros(4, dtype=torch.int32, device=dev)

    k6_in = (a_k, q_valid, q, qss, d_k, lw_k)
    (r_k, c_k), (r_p, c_p) = buffers(), buffers()
    compact_round(*k6_in, r_k, None, c_k, m=qm)
    compact_round_plain(*k6_in, r_p, None, c_p, m=qm)
    check(torch.equal(c_k, c_p) and all(
        torch.equal(r_k[key], r_p[key]) for key in r_k),
        "K6 with the model column not bit-identical")
    log(f"K6 compact_round K>1 ({shape}): counters {c_k.tolist()} exact")

    # K10's model column on a chunk of reservoirs
    ms = [torch.roll(x["res_m"], g).contiguous() for g in range(G_CHUNK)]
    pk_k = pack_fetch.models(ms, n_keep=n_keep)
    pk_p = pack_models_plain(ms, n_keep=n_keep)
    check(torch.equal(pk_k, pk_p), "K10 model column not bit-identical")

    # K11 over the K fits
    def health_x(kind):
        nxt = {key: v.clone() for key, v in fit_k.items()}
        fitted = st_k["fitted"].clone()
        if kind == "psd":
            nxt["chol"][K - 1, 0, 0] = math.nan
        elif kind == "unfitted":
            nxt["chol"][K - 1, 0, 0] = math.nan
            fitted[K - 1] = False
        f = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                   device=dev)
        return dict(theta=x["res_theta"], k_mask=x["k_mask"], w_norm=x["w"],
                    d_new=torch.rand(n, device=dev),
                    n_acc=x["k_mask"].sum(dtype=torch.int32),
                    n_target=n_keep, acc_rate=f(0.3), trans_params=fit_k,
                    trans_next=nxt, fitted=x["fitted"], fitted_next=fitted,
                    eps_g=f(0.5), eps_next=f(0.4), eps_prev=f(1.0),
                    stall_count=torch.tensor(0, dtype=torch.int32,
                                             device=dev),
                    ess_floor=0.0, acc_floor=0.0, stall_window=16,
                    stall_rtol=1e-6)

    words = {}
    h_err = 0.0
    for kind in ("ok", "psd", "unfitted"):
        h_err = max(h_err, compare_health(health_x(kind)))
        words[kind] = int(generation_health(**health_x(kind))[0])
    check(words == {"ok": 0, "psd": 128, "unfitted": 0},
          f"K11 K>1 words {words}, expected ok 0, psd 128, unfitted 0")
    log(f"K10 pack_fetch K>1 ({shape}, G={G_CHUNK}): model column "
        f"bit-identical; K11 generation_health K>1 words {words}")
    if not timed:
        return {}

    # times and bounds at config 5's shapes
    Bf, nf, Kf = float(B), float(n), float(K)
    steps = (S - 1) * x["sim_kw"]["n_substeps"]
    res["ode_family_simulate"] = dict(
        err=ode_err,
        call_ms=time_ms(lambda: ode_family_simulate(theta, m,
                                                    **x["sim_kw"]), 50),
        ms=graph_ms(lambda: ode_family_simulate(theta, m, **x["sim_kw"])),
        plain_ms=time_ms(lambda: ode_family_simulate_plain(
            theta, m, **x["sim_kw"]), 3),
        # 4 right-hand sides (about 5 operations) and the RK4 update (8)
        # per step; S Philox normals (a 10-round block makes four, ~38
        # operations each)
        bound=bound(Bf * (d_max * 4 + 4 + S * 4),
                    Bf * (steps * (4 * 5 + 12) + S * 38)),
        library_ms=None)
    res["model_step"] = dict(
        err=step_err, call_ms=time_ms(lambda: model_step(*step_in), 50),
        ms=graph_ms(lambda: model_step(*step_in)),
        plain_ms=time_ms(lambda: model_step_plain(*step_in), 10),
        bound=bound(nf * 9 + Kf + Kf * Kf * 4 + Kf * 4 * 5 + Kf * Kf * 4,
                    nf * 3 + 6 * Kf * Kf),
        library_ms=None)
    n_live = float((fit_k["weights"] > 0).sum(dim=1).float().mean())
    st_t = stream_on(dev, philox.TRANSITION)
    res["propose_models"] = dict(
        err=p_err,
        call_ms=time_ms(lambda: propose.models(st_t, B, pri, lmp, fit_k,
                                               matrix), 50),
        ms=graph_ms(lambda: propose.models(st_t, B, pri, lmp, fit_k,
                                           matrix)),
        plain_ms=time_ms(lambda: propose_models_plain(st_t, B, pri, lmp,
                                                      fit_k, matrix), 5),
        # the model block and one draw (its blocks, search, L z, prior)
        bound=bound(Kf * (nf * (d_max + 1) + d_max * d_max + 5 * d_max + K
                          + 2) * 4 + Bf * (d_max * 4 + 4 + 1 + 4),
                    Bf * (100 * 3 + 4 * Kf + 3 + 14 * d_max
                          + 2 * math.log2(n) + d_max * (2 * d_max + 9))),
        library_ms=None)
    res["mvn_logpdf_models"] = dict(
        err=lq_err,
        call_ms=time_ms(lambda: mvn_mixture_logpdf.models(q, qm, fit_k), 50),
        ms=graph_ms(lambda: mvn_mixture_logpdf.models(q, qm, fit_k)),
        plain_ms=time_ms(lambda: mvn_mixture_logpdf_models_plain(
            q, qm, fit_k), 5),
        bound=bound((Bf * (d_max + 1) + Kf * (nf * (d_max + 2) + d_max
                                              * d_max + d_max + 2)
                     + Bf) * 4,
                    Bf * n_live * (2 * d_max + 8)),
        library_ms=None)
    res["pnorm_accept_models"] = dict(
        err=k5_err,
        call_ms=time_ms(lambda: pnorm_accept_weight(*k5_args, **k5_kw), 50),
        ms=graph_ms(lambda: pnorm_accept_weight(*k5_args, **k5_kw)),
        plain_ms=time_ms(lambda: pnorm_accept_weight_plain(*k5_args,
                                                           **k5_kw), 20),
        bound=bound((Bf * S + 2 * S + 1 + 2 * Kf) * 4 + Bf * (1 + 3 * 4)
                    + Bf * (4 + 1 + 4), Bf * S * 4),
        library_ms=None)
    ctr_g = torch.zeros(4, dtype=torch.int32, device=dev)
    r_g = buffers()[0]
    kept = int(torch.clamp(c_k[0], max=n))
    res["compact_round_models"] = dict(
        err=0.0,
        call_ms=time_ms(lambda: compact_round(*k6_in, r_g, None,
                                              torch.zeros_like(ctr_g),
                                              m=qm), 50),
        ms=graph_ms(lambda: (ctr_g.zero_(), compact_round(
            *k6_in, r_g, None, ctr_g, m=qm))),
        plain_ms=time_ms(lambda: compact_round_plain(
            *k6_in, buffers()[0], None, torch.zeros_like(ctr_g), m=qm), 10),
        bound=bound(2 * Bf + kept * (d_max + S + 4) * 4 * 2 + 24, 0.0),
        library_ms=None)
    res["mvn_fit_models"] = dict(
        err=fit_err,
        call_ms=time_ms(lambda: mvn_fit.models(*fit_in, **fit_kw), 50),
        ms=graph_ms(lambda: mvn_fit.models(*fit_in, **fit_kw)),
        plain_ms=time_ms(lambda: mvn_fit_models_plain(*fit_in, **fit_kw),
                         10),
        bound=bound(nf * (d_max + 2) * 4 + Kf * (2 * nf * d_max + 3 * nf
                                                  + 2 * d_max * d_max
                                                  + d_max + 1) * 4,
                    Kf * nf * (2 * d_max + 4 * d_max * d_max + 3)),
        library_ms=None)
    res["pack_fetch_models"] = dict(
        err=0.0,
        call_ms=time_ms(lambda: pack_fetch.models(ms, n_keep=n_keep), 50),
        ms=graph_ms(lambda: pack_fetch.models(ms, n_keep=n_keep)),
        plain_ms=time_ms(lambda: pack_models_plain(ms, n_keep=n_keep), 20),
        bound=bound(G_CHUNK * n_keep * 5, 0.0), library_ms=None)
    hx = health_x("ok")
    params = sum(v.numel() for p in (hx["trans_params"], hx["trans_next"])
                 for v in p.values())
    res["generation_health_models"] = dict(
        err=h_err, call_ms=time_ms(lambda: generation_health(**hx), 50),
        ms=graph_ms(lambda: generation_health(**hx)),
        plain_ms=time_ms(lambda: generation_health_plain(**hx), 10),
        bound=bound(nf * d_max * 4 + nf + 2 * nf * 4 + params * 4 + 2 * Kf
                    + 40, nf * d_max + 4 * nf + params),
        library_ms=None)
    return res


#: the K > 1 mode of each kernel, by the name of its row in the results
MODEL_MODES = {"propose": "propose_models",
               "mvn_mixture_logpdf": "mvn_logpdf_models",
               "pnorm_accept_weight": "pnorm_accept_models",
               "compact_round": "compact_round_models",
               "mvn_fit": "mvn_fit_models",
               "pack_fetch": "pack_fetch_models",
               "generation_health": "generation_health_models"}


def model_checks(dev) -> dict:
    """K20b, K26 and the K > 1 modes of K2, K3, K5, K6, K8, K10 and K11 at
    config 5's shapes (timed) and at a small odd shape (K 2, d_max 1, n_cap
    64, 33 kept rows)."""
    res = model_checks_at(dev, B_MAIN, N_CAP_MAIN, K_MODELS, D_MAX_C5, S_C5,
                          POP, seed=5, timed=True)
    model_checks_at(dev, 256, 64, 2, 1, S_C5, 33, seed=6, timed=False)
    return res


# ------------------------------------------------------------ phases 3-4
#: (module, attribute) of the plain version of every kernel, K1-K15,
#: K18, K19, K20, K20b (family, segmented family and network), K21a, K21b,
#: K22, K23, K26, K16 (both modes) and the K > 1 modes
PLAIN_VERSIONS = (
    ("pyabc_tpu_torch.kernels.philox", "philox4x32_10"),
    ("pyabc_tpu_torch.kernels.propose", "propose_plain"),
    ("pyabc_tpu_torch.kernels.mvn_logpdf", "mvn_mixture_logpdf_plain"),
    ("pyabc_tpu_torch.kernels.lv_simulate", "lv_simulate_plain"),
    ("pyabc_tpu_torch.kernels.pnorm_accept", "pnorm_accept_weight_plain"),
    ("pyabc_tpu_torch.kernels.compact", "compact_round_plain"),
    ("pyabc_tpu_torch.kernels.compact", "compact_shards_plain"),
    ("pyabc_tpu_torch.kernels.compact", "dfeat_rows"),
    ("pyabc_tpu_torch.kernels.shard", "shard_mask_plain"),
    ("pyabc_tpu_torch.kernels.pack_fetch", "merged_rows"),
    ("pyabc_tpu_torch.kernels.moments", "moment_fold_shards_plain"),
    ("pyabc_tpu_torch.kernels.moments", "moment_finish_shards_plain"),
    ("pyabc_tpu_torch.kernels.moments", "feature_distances"),
    ("pyabc_tpu_torch.kernels.normalize_quantile",
     "normalize_log_weights_plain"),
    ("pyabc_tpu_torch.kernels.normalize_quantile", "weighted_quantile_plain"),
    ("pyabc_tpu_torch.kernels.normalize_quantile", "quantile_epsilon_plain"),
    ("pyabc_tpu_torch.kernels.mvn_fit", "mvn_fit_plain"),
    ("pyabc_tpu_torch.kernels.mvn_fit", "device_chol_guarded"),
    ("pyabc_tpu_torch.kernels.scale_reduce", "scale_reduce_plain"),
    ("pyabc_tpu_torch.kernels.scale_reduce", "weight_update_plain"),
    ("pyabc_tpu_torch.kernels.pack_fetch", "pack_rows_plain"),
    ("pyabc_tpu_torch.kernels.pack_fetch", "cast_rows_plain"),
    ("pyabc_tpu_torch.kernels.pack_fetch", "cast_monotone_down"),
    ("pyabc_tpu_torch.kernels.generation_health", "generation_health_plain"),
    ("pyabc_tpu_torch.kernels.sir_simulate", "sir_simulate_plain"),
    ("pyabc_tpu_torch.kernels.kernel_accept", "kernel_accept_plain"),
    ("pyabc_tpu_torch.kernels.temperature_update",
     "temperature_update_plain"),
    ("pyabc_tpu_torch.kernels.propose", "propose_models_plain"),
    ("pyabc_tpu_torch.kernels.propose", "draw_models_plain"),
    ("pyabc_tpu_torch.kernels.propose", "categorical_plain"),
    ("pyabc_tpu_torch.kernels.mvn_logpdf",
     "mvn_mixture_logpdf_models_plain"),
    ("pyabc_tpu_torch.kernels.mvn_fit", "mvn_fit_models_plain"),
    ("pyabc_tpu_torch.kernels.pack_fetch", "pack_models_plain"),
    ("pyabc_tpu_torch.kernels.generation_health",
     "params_unhealthy_models"),
    ("pyabc_tpu_torch.kernels.ode_family", "ode_family_simulate_plain"),
    ("pyabc_tpu_torch.kernels.model_step", "model_step_plain"),
    ("pyabc_tpu_torch.kernels.model_step", "next_generation_terms"),
    ("pyabc_tpu_torch.kernels.philox", "poisson_plain"),
    ("pyabc_tpu_torch.kernels.tau_leap", "tau_leap_leaps"),
    ("pyabc_tpu_torch.kernels.tau_leap", "segments_plain"),
    ("pyabc_tpu_torch.kernels.tau_leap", "tau_leap_plain"),
    ("pyabc_tpu_torch.kernels.network_sir", "network_sir_plain"),
    ("pyabc_tpu_torch.kernels.segment_round", "segment_round_plain"),
    ("pyabc_tpu_torch.kernels.local_cov", "local_cov_plain"),
    ("pyabc_tpu_torch.kernels.local_factor", "local_factor_plain"),
    ("pyabc_tpu_torch.kernels.local_factor", "device_chol_guarded_batched"),
    ("pyabc_tpu_torch.kernels.propose", "propose_local_plain"),
    ("pyabc_tpu_torch.kernels.local_logpdf", "local_logpdf_plain"),
    ("pyabc_tpu_torch.kernels.proposal_drift", "proposal_drift_plain"),
    ("pyabc_tpu_torch.kernels.proposal_drift", "device_proposal_drift"),
    ("pyabc_tpu_torch.kernels.moments", "moment_fold_plain"),
    ("pyabc_tpu_torch.kernels.moments", "moment_finish_plain"),
    ("pyabc_tpu_torch.kernels.ode_family", "ode_family_segments_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv", "bootstrap_draw_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv", "bootstrap_fit_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv", "bootstrap_density_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv", "bootstrap_bisect_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv", "bootstrap_local_gather_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv",
     "bootstrap_local_density_plain"),
    ("pyabc_tpu_torch.kernels.bootstrap_cv", "cv_partial_plain"),
    ("pyabc_tpu_torch.kernels.local_logpdf", "local_logpdf_models_plain"),
    ("pyabc_tpu_torch.kernels.proposal_drift",
     "proposal_drift_models_plain"),
    ("pyabc_tpu_torch.transition.util", "device_required_nr"),
    ("pyabc_tpu_torch.kernels.aggregate", "aggregate_accept_weight_plain"),
    ("pyabc_tpu_torch.kernels.aggregate", "sub_distances_plain"),
    ("pyabc_tpu_torch.kernels.aggregate", "aggregate_refit_plain"),
    ("pyabc_tpu_torch.kernels.aggregate", "weight_update_plain"),
    ("pyabc_tpu_torch.kernels.aggregate", "combine_plain"),
    ("pyabc_tpu_torch.kernels.aggregate", "aggregate_finish_shards_plain"),
    ("pyabc_tpu_torch.kernels.segment_round", "agg_total"),
    ("pyabc_tpu_torch.kernels.ridge_fit", "ridge_fit_plain"),
    ("pyabc_tpu_torch.kernels.linear_sumstat", "transform_rows_plain"),
    ("pyabc_tpu_torch.kernels.linear_sumstat", "linear_values_plain"),
    ("pyabc_tpu_torch.kernels.linear_sumstat", "linear_accept_plain"),
    ("pyabc_tpu_torch.kernels.linear_bound", "linear_bound_plain"),
    ("pyabc_tpu_torch.kernels.segment_round", "lin_bound_fold"),
    ("pyabc_tpu_torch.kernels.segment_round", "lin_exceeds"),
    ("pyabc_tpu_torch.kernels.mlp_fit", "mlp_fit_plain"),
    ("pyabc_tpu_torch.kernels.mlp_fit", "mlp_gradient_plain"),
    ("pyabc_tpu_torch.kernels.mlp_sumstat", "transform_rows_plain"),
    ("pyabc_tpu_torch.kernels.mlp_sumstat", "mlp_values_plain"),
    ("pyabc_tpu_torch.kernels.mlp_sumstat", "mlp_accept_plain"),
    ("pyabc_tpu_torch.kernels.gp_sumstat", "transform_rows_plain"),
    ("pyabc_tpu_torch.kernels.gp_sumstat", "gp_values_plain"),
    ("pyabc_tpu_torch.kernels.gp_sumstat", "gp_accept_plain"),
    ("pyabc_tpu_torch.kernels.grid_search", "grid_search_cv_plain"),
    ("pyabc_tpu_torch.kernels.grid_search", "grid_search_cv_models_plain"),
    ("pyabc_tpu_torch.kernels.grid_search", "fold_scores_plain"),
    ("pyabc_tpu_torch.kernels.gaussian_simulate", "gaussian_simulate_plain"),
    ("pyabc_tpu_torch.kernels.gaussian_simulate", "gaussian_noise_plain"),
    ("pyabc_tpu_torch.kernels.gaussian_simulate",
     "mean_only_simulate_plain"),
    ("pyabc_tpu_torch.kernels.gaussian_simulate", "mean_only_noise_plain"),
    ("pyabc_tpu_torch.kernels.mesh_pack", "mesh_pack_plain"),
    ("pyabc_tpu_torch.kernels.mesh_pack", "mesh_unpack_plain"),
)


@contextlib.contextmanager
def plain_versions_raise():
    """Replace the plain version of every kernel with a function that
    raises, so a card run that falls back to one fails loudly."""
    import importlib

    saved = []
    for mod_name, attr in PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))

        def raiser(*_a, _name=f"{mod_name}.{attr}", **_k):
            raise AssertionError(f"plain version {_name} ran on the path")

        setattr(mod, attr, raiser)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# ------------------------------------------ the CPU reference process
#: the share of the host's threads the CPU reference process takes: half
#: of them (the card's process drives the card from one thread and keeps
#: the other half)
REF_THREADS = max(1, (os.cpu_count() or 2) // 2)
#: the CPU references, run in this order by one process of their own
#: (``--cpu-refs DIR``) beside the card's phases: name -> a function of no
#: argument returning a JSON-able result (filled below, as each is defined)
CPU_REF_JOBS: dict = {}
#: the comparisons that read a CPU reference, run after the card's phases
PENDING: list = []
REFS = None


def cpu_ref(fn):
    """Register ``fn`` as a CPU reference job, run in definition order."""
    CPU_REF_JOBS[fn.__name__] = fn
    return fn


class CpuRefs:
    """The CPU reference process: started after the kernel build, on the
    CPU only (no card visible to it) with REF_THREADS threads; each job's
    result lands in its own JSON file, which ``get`` waits for. A failed
    job (its traceback in ``<name>.err``) or a process that ends without a
    result fails the run."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_refs_")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS=str(REF_THREADS),
                   MKL_NUM_THREADS=str(REF_THREADS))
        self.log = open(os.path.join(self.dir, "log.txt"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-refs",
             self.dir], env=env, stdout=self.log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.t0 = time.perf_counter()
        log(f"CPU reference process started (pid {self.proc.pid}, "
            f"{REF_THREADS} of {os.cpu_count()} host threads, jobs "
            f"{list(CPU_REF_JOBS)})")

    def _tail(self) -> str:
        self.log.flush()
        with open(os.path.join(self.dir, "log.txt")) as f:
            return f.read()[-4000:]

    def get(self, name: str):
        path = os.path.join(self.dir, name + ".json")
        err = os.path.join(self.dir, name + ".err")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if os.path.exists(err):
                with open(err) as f:
                    raise AssertionError(f"CPU reference {name} failed:\n"
                                         f"{f.read()[-4000:]}")
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"the CPU reference process ended (code "
                    f"{self.proc.returncode}) without {name}:\n"
                    f"{self._tail()}")
            time.sleep(0.2)
        with open(path) as f:
            out = json.load(f)
        log(f"CPU reference {name}: {out['wall_s']:.1f} s in its process, "
            f"waited {time.perf_counter() - t0:.1f} s for it")
        return out

    def close(self, ok: bool) -> None:
        """Wait for the process (every job read), or stop it on a failed
        run; either way no process stays behind."""
        if ok:
            code = self.proc.wait(timeout=600)
            check(code == 0, f"the CPU reference process exited {code}:\n"
                  f"{self._tail()}")
            log(f"CPU reference process: all {len(CPU_REF_JOBS)} jobs in "
                f"{time.perf_counter() - self.t0:.1f} s")
        elif self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def cpu_refs_main(out_dir: str) -> int:
    """The CPU reference process: every job in order, each result written
    whole (a temporary file renamed), a failure's traceback to
    ``<name>.err``."""
    import traceback

    import torch

    torch.set_num_threads(REF_THREADS)
    for name, fn in CPU_REF_JOBS.items():
        t0 = time.perf_counter()
        try:
            out = fn()
        except BaseException:
            with open(os.path.join(out_dir, name + ".err"), "w") as f:
                f.write(traceback.format_exc())
            return 1
        out["wall_s"] = time.perf_counter() - t0
        tmp = os.path.join(out_dir, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, os.path.join(out_dir, name + ".json"))
        log(f"{name}: {out['wall_s']:.1f} s")
    return 0


def finish_references() -> None:
    """The comparisons with the CPU references, in the order the card's
    phases queued them."""
    while PENDING:
        PENDING.pop(0)()


def toy_stats(where) -> dict:
    """The conjugate toy over TOY_SEEDS on one device -> each seed's
    posterior mean and least ESS, the lowest ESS (value, seed,
    generation), seed 0's epsilon trail and the wall."""
    from pyabc_tpu_torch.models import gaussian

    mu_true, sd_true = gaussian.conjugate_posterior(1.0, noise_sd=0.5)
    mus, ess_min = [], []
    t0 = time.perf_counter()
    lowest, eps0 = run_toy_seeds(where, mus, ess_min, mu_true, sd_true,
                                 where != "cpu")
    return {"mus": mus, "ess_min": ess_min, "lowest": list(lowest),
            "eps0": eps0, "wall": time.perf_counter() - t0}


@cpu_ref
def toy_cpu() -> dict:
    return toy_stats("cpu")


#: the kernels of the conjugate toy's path: K4's mean-only simulator
TOY_KERNELS = ("mean_only_simulate",)
TOY_PATH = ("propose", "mvn_mixture_logpdf", "mean_only_simulate",
            "pnorm_accept_weight", "compact_round", "normalize_quantile",
            "mvn_fit", "pack_fetch", "generation_health")
#: card against CPU on one seed (config 1's rule: pop X1_CMP_POP over
#: X1_CMP_GENS generations): the same Philox streams on both, so the trails
#: and the posterior agree within 1e-3 relative
SEED_REL = 1e-3


def rel_gap(card, cpu) -> float:
    """The largest |card - cpu| / |cpu| over paired values."""
    import numpy as np

    card, cpu = np.asarray(card, float), np.asarray(cpu, float)
    check(card.shape == cpu.shape, f"card {card.shape} and CPU "
          f"{cpu.shape} values differ in shape")
    return float(np.max(np.abs(card - cpu)
                        / np.maximum(np.abs(cpu), 1e-12)))


def gaussian_toy(dev) -> dict:
    """The conjugate toy over TOY_SEEDS seeds on the card and, as the
    reference, on the CPU (plain versions on the same Philox streams, the
    simulator's noise too; in the CPU reference process); seed 0's six
    generations side by side, a reading (one acceptance flipped by an ulp
    of a reduction moves a later generation's posterior mean by a Monte
    Carlo sd: the CPU alone moves it with its thread count; ``toy_cpu_check``
    holds config 1's rule) -> the card's launch counts."""
    import numpy as np

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gaussian

    mu_true, _sd_true = gaussian.conjugate_posterior(1.0, noise_sd=0.5)
    reset_launch_counts()
    with plain_versions_raise():
        card = toy_stats(dev)
    counts = launch_counts() | mode_launch_counts()
    log(f"gaussian toy ({dev}): kernel launches "
        f"{ {k: counts[k] for k in TOY_PATH} }")
    check(all(counts[k] > 0 for k in TOY_PATH),
          "a kernel of the Gaussian toy's path was never launched")

    def summary(where, st):
        mus, ess_min, lowest = st["mus"], st["ess_min"], st["lowest"]
        m = float(np.mean(mus))
        se = float(np.std(mus, ddof=1) / math.sqrt(len(mus)))
        log(f"gaussian toy ({where}, {len(mus)} seeds, {st['wall']:.2f} s): "
            f"mean of posterior means {m:.4f} se {se:.4f} (analytic "
            f"{mu_true:.4f}, {(m - mu_true) / se:+.2f} se); per seed min "
            f"{min(mus):.4f} max {max(mus):.4f}; least ESS over the "
            f"generations, lowest seed {min(ess_min):.1f} median seed "
            f"{float(np.median(ess_min)):.1f}")
        log(f"gaussian toy ({where}): lowest ESS {lowest[0]:.1f} at seed "
            f"{lowest[1]} generation {lowest[2]}")
        return m, se

    m_d, se_d = summary(dev, card)
    # the seed mean's standard error is about 0.008 (sd ~0.045 over 32
    # seeds), so a bias of 0.03 in the device path lies ~4 se out
    check(abs(m_d - mu_true) < 0.03,
          "gaussian toy mean over seeds off the analytic mean by >= 0.03")

    def compare():
        cpu = REFS.get("toy_cpu")
        m_c, se_c = summary("cpu", cpu)
        gap_se = (m_d - m_c) / math.hypot(se_d, se_c)
        log(f"gaussian toy: card - cpu {m_d - m_c:+.4f} ({gap_se:+.2f} se)")
        check(abs(gap_se) < 4.0, "gaussian toy: card and CPU means differ "
              "by >= 4 standard errors")
        card0 = card["eps0"] + [card["mus"][0]]
        cpu0 = cpu["eps0"] + [cpu["mus"][0]]
        log(f"gaussian toy seed 0 (pop {POP}, 6 generations), card against "
            f"CPU, a reading: eps trail and posterior mean card "
            f"{np.round(card0, 6).tolist()} cpu {np.round(cpu0, 6).tolist()},"
            f" largest relative gap {rel_gap(card0, cpu0):.3e}")

    PENDING.append(compare)
    return counts


def toy_cpu_check(dev) -> None:
    """Config 1's rule on the conjugate toy: seed 0 at pop X1_CMP_POP over
    X1_CMP_GENS generations on the card (the plain versions set to raise)
    and on the CPU, the same Philox streams: the epsilon trail and the
    posterior mean within SEED_REL relative."""
    import numpy as np

    def run(where):
        h = toy_abc(where, 0, X1_CMP_POP).run(max_nr_populations=X1_CMP_GENS)
        df, w = h.get_distribution()
        return h.get_all_populations().query("t >= 0")["epsilon"].tolist() + [
            float(np.sum(df["theta"] * w))]

    with plain_versions_raise():
        card = run(dev)
    cpu = run("cpu")
    rel = rel_gap(card, cpu)
    log(f"gaussian toy seed 0 card against CPU at pop {X1_CMP_POP} over "
        f"{X1_CMP_GENS} generations: eps and posterior mean card "
        f"{np.round(card, 6).tolist()} cpu {np.round(cpu, 6).tolist()}, "
        f"largest relative gap {rel:.3e}")
    check(rel <= SEED_REL, f"gaussian toy seed 0: card and CPU apart by "
          f"more than {SEED_REL} relative")


def toy_abc(where, seed, pop=POP):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    abc = pt.ABCSMC(gaussian.make_mean_only_model(noise_sd=TOY_NOISE_SD),
                    gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                    population_size=pop, eps=pt.MedianEpsilon(), seed=seed,
                    device=where)
    abc.new("sqlite://", {"x": 1.0})
    return abc


def toy_run(where, seed):
    return toy_abc(where, seed).run(max_nr_populations=6)


def ess_trail(h) -> list[float]:
    import numpy as np

    ess = []
    for t in range(h.n_populations):
        _df, w_t = h.get_distribution(t=t)
        ess.append(float(1.0 / np.sum(w_t * w_t)))
    return ess


def run_toy_seeds(where, mus, ess_min, mu_true, sd_true, on_card):
    """The conjugate toy over TOY_SEEDS on one device; appends each seed's
    posterior mean and least ESS -> ((lowest ESS, its seed, generation),
    the first seed's epsilon trail)."""
    import numpy as np

    lowest = (math.inf, None, None)
    eps0 = []
    for seed in TOY_SEEDS:
        h = toy_run(where, seed)
        check(h.n_populations == 6,
              f"gaussian toy seed {seed} did not run 6 generations")
        ess = ess_trail(h)
        lowest = min(lowest, (min(ess), seed, int(np.argmin(ess))))
        df, w = h.get_distribution()
        mus.append(float(np.sum(df["theta"] * w)))
        ess_min.append(min(ess))
        if seed == TOY_SEEDS[0]:
            sd = float(np.sqrt(np.sum(w * (df["theta"] - mus[0]) ** 2)))
            eps0 = [float(e) for e in h.get_all_populations().query(
                "t >= 0")["epsilon"]]
            eps = [round(e, 5) for e in eps0]
            log(f"gaussian toy ({where}, seed {seed}): pop={POP} gens=6 "
                f"posterior mean={mus[0]:.4f} sd={sd:.4f} analytic "
                f"mean={mu_true:.4f} sd={sd_true:.4f} eps={eps}")
            if on_card:
                check(abs(mus[0] - mu_true) < 0.1,
                      "gaussian posterior mean off by >= 0.1")
    return lowest, eps0


def lotka_volterra(dev, adaptive: bool, gens: int):
    """LV config 2 (``adaptive``) or the same run under a fixed p-norm ->
    (launch counts, epsilon trail)."""
    import numpy as np
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import lotka_volterra as lv

    label = "LV config 2" if adaptive else "LV fixed p-norm"
    dist = (pt.AdaptivePNormDistance(p=2) if adaptive
            else pt.PNormDistance(p=2))
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(), dist,
                    population_size=POP, eps=pt.MedianEpsilon(), seed=0,
                    device=dev)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {**launch_counts(), **mode_launch_counts()}
    pops = h.get_all_populations()[1:]
    eps = [float(e) for e in pops["epsilon"]]
    n_gen = len(eps)
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in lv.TRUE_PARS}
    log(f"{label}: pop={POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"(rounds {rounds}, {syncs['by_kind']})")
    split = wall_split(abc)
    log(f"{label}: host seconds, rounds + generation steps "
        f"{split['compute_s']:.4f}, packed fetch {split['fetch_s']:.4f}, "
        f"History wait {split['persist_s']:.4f}, writer "
        f"{split['write_s']:.4f}, final flush {split['flush_s']:.4f}, "
        f"other "
        f"{wall - held_s(split):.4f}")
    log(f"{label}: eps trail {[round(e, 4) for e in eps]}")
    log(f"{label}: posterior means {means} true {lv.TRUE_PARS}")
    log(f"{label}: kernel launches {counts}")
    check(n_gen == gens, f"LV ran {n_gen} of {gens} generations")
    if adaptive:
        # under adaptive weights each epsilon is a quantile in a new
        # distance space, so the trail need not fall every generation (the
        # JAX package's own trail rises at generations 2-4 of this config,
        # see tests/test_torch_slice.py); it must fall over the run
        check(eps[-1] < 0.5 * eps[0], "LV epsilon trail did not fall")
    else:
        check(all(b <= a for a, b in zip(eps, eps[1:])),
              "LV epsilons increased under a fixed distance")
    # the fixed p-norm has no adaptive refit (K9); config 2 runs all ten
    path = [k for k in LV_PATH if adaptive or k != "scale_reduce"]
    check(all(counts[k] > 0 for k in path),
          "a kernel of the path was never launched")
    check(all(counts[k] == 0 for k in NOISY_KERNELS),
          "a noisy-ABC kernel ran on the LV path")
    # K7: a normalization and a quantile epsilon a generation (and the
    # calibration's epsilon), all in the block mode at n_cap 1024
    k7_norm = counts["normalize_quantile:normalize"]
    k7_eps = counts["normalize_quantile:epsilon"]
    check(k7_eps == n_gen + 1 and k7_norm == n_gen
          and counts["normalize_quantile:block"]
          == counts["normalize_quantile"],
          f"K7 did not launch twice a generation in its block mode "
          f"({k7_norm} normalizations, {k7_eps} epsilons, "
          f"{counts['normalize_quantile']} launches, {n_gen} generations)")
    check(all(math.isfinite(v) for v in means.values()),
          "non-finite LV posterior mean")
    for t in range(n_gen):
        dmax = float(h.get_weighted_distances(t)["distance"].max())
        check(dmax <= eps[t], f"LV generation {t} stored a distance "
              f"{dmax} above its epsilon {eps[t]}")
    prior_sd = {k: rv.scale / math.sqrt(12.0)
                for k, rv in lv.default_prior().rv_map.items()}
    post_sd = {k: float(np.sqrt(np.sum(w * (df[k] - means[k]) ** 2)))
               for k in means}
    log(f"{label}: posterior sd {post_sd} prior sd {prior_sd}")
    if adaptive:
        check(all(post_sd[k] < prior_sd[k] for k in means),
              "LV posterior did not concentrate (sd >= the prior sd)")
    return counts, eps


def config2(where):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=POP,
                    eps=pt.MedianEpsilon(), seed=0, device=where)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    return abc


def profile_lv(dev) -> None:
    """One more LV config 2 run under torch.profiler: K7 is its block
    kernels alone, a normalization and a quantile epsilon a generation (and
    the calibration's epsilon), and none of its passes mode (select.cuh's
    histogram and scan launches are K9's, one of each a pass)."""
    gens = 10
    by_name = profile_run("LV config 2", config2(dev), gens)
    if by_name is None:
        return

    def launches(part: str) -> int:
        return sum(cnt for name, (_t, cnt) in by_name.items() if part in name)

    # K7 reaches select.cuh only in its passes mode, which launches its
    # masking and multiply kernels around it
    k7 = {part: launches(part) for part in (
        "normalize_block_kernel", "quantile_block_kernel",
        "normalize_cluster_kernel", "quantile_cluster_kernel",
        "normalize_passes_kernel", "masked_points_kernel",
        "multiply_kernel", "select_hist_kernel<true>", "select_hist_kernel",
        "select_scan_kernel")}
    log(f"LV config 2 under torch.profiler: K7's kernels and select.cuh's "
        f"{k7}")
    check(k7["normalize_block_kernel"] == gens
          and k7["quantile_block_kernel"] == gens + 1
          and all(k7[k] == 0 for k in (
              "normalize_cluster_kernel", "quantile_cluster_kernel",
              "normalize_passes_kernel", "masked_points_kernel",
              "multiply_kernel", "select_hist_kernel<true>"))
          and k7["select_scan_kernel"] == k7["select_hist_kernel"],
          "LV config 2's profile: K7 is not two block launches a "
          "generation, or select.cuh ran for it")


def profile_run(label: str, abc, gens: int,
                spans_out: list | None = None) -> dict | None:
    """A run under torch.profiler: the device's busy share of the run's
    window and the ten device ops that take the most device time ->
    {device op name: [total microseconds, count]}, None without device
    activity. ``spans_out`` receives every device op as (start, end, name)
    in microseconds, in order of start."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with plain_versions_raise(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        abc.run(max_nr_populations=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"{label} under torch.profiler: device busy share not "
            f"measured (the profiler recorded no device activity)")
        return
    if spans_out is not None:
        spans_out.extend(spans)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name: dict[str, list] = {}
    for start, end, name in spans:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += end - start
        tot[1] += 1
    busy = (busy + cur_end - cur_start) / 1e6  # microseconds -> s
    active = (spans[-1][1] - spans[0][0]) / 1e6
    log(f"{label} under torch.profiler: wall_s={wall:.4f} device "
        f"busy_s={busy:.5f} busy_share_of_window={busy / wall:.4f} "
        f"(first to last device op {active:.4f} s, "
        f"{len(spans)} device ops)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"{label} top device ops (name, total ms, count): " + "; ".join(
        f"{name[:70]} {tot / 1e3:.4f} {cnt}" for name, (tot, cnt) in top))
    return by_name


def lv_cpu_trail(card_eps: list[float]) -> None:
    """LV config 2 with the same seed on the CPU (the plain versions, the
    same Philox streams): its epsilon trail beside the card's. A finding,
    not a check: an accept that flips near the threshold parts them."""
    t0 = time.perf_counter()
    h = config2("cpu").run(max_nr_populations=len(card_eps))
    wall = time.perf_counter() - t0
    cpu_eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    rel = [abs(a - b) / abs(b) for a, b in zip(card_eps, cpu_eps)]
    parted = next((t for t, r in enumerate(rel) if r > 1e-3), None)
    log(f"LV config 2 on the CPU (seed 0, {wall:.1f} s): eps trail "
        f"{[round(e, 4) for e in cpu_eps]}; |card - cpu| / cpu per "
        f"generation {[float(f'{r:.2e}') for r in rel]}; first generation "
        f"apart by more than 1e-3: {parted}")


def anchor_run(where, seed, rv=None, local: bool = False):
    """The noisy Gaussian anchor: x = theta (a one-line user model),
    prior N(0, 1) (or ``rv``), IndependentNormalKernel(var 0.09), x_obs
    0.8; ``local``: with a LocalTransition()."""
    import pyabc_tpu_torch as pt

    model = pt.TorchModel(lambda theta, gen: {"x": theta[:, 0]}, ["theta"],
                          name="det")
    rv = pt.RV("norm", 0.0, 1.0) if rv is None else rv
    kw = {"transitions": pt.LocalTransition()} if local else {}
    abc = pt.ABCSMC(model, pt.Distribution(theta=rv),
                    pt.IndependentNormalKernel(var=[0.09]),
                    population_size=POP, eps=pt.Temperature(),
                    acceptor=pt.StochasticAcceptor(), seed=seed,
                    device=where, **kw)
    abc.new("sqlite://", {"x": 0.8})
    return abc.run(max_nr_populations=7)


#: the noisy anchor with a LocalTransition: seeds on the card and the CPU
NOISY_LOCAL_SEEDS = tuple(range(16))


def noisy_stats(where, local: bool = False) -> dict:
    """The anchor over TOY_SEEDS (``local``: NOISY_LOCAL_SEEDS with a
    LocalTransition) on one device: every temperature trail falls to
    exactly 1 -> each seed's posterior mean and sd, the trails, the
    wall."""
    import numpy as np

    mus, sds, trails = [], [], []
    t0 = time.perf_counter()
    for seed in (NOISY_LOCAL_SEEDS if local else TOY_SEEDS):
        h = anchor_run(where, seed, local=local)
        temps = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
        check(temps[-1] == 1.0 and all(
            b <= a for a, b in zip(temps, temps[1:])),
            f"noisy anchor seed {seed} ({where}): temperature trail "
            f"{temps} does not fall to exactly 1")
        df, w = h.get_distribution()
        x = np.asarray(df["theta"])
        mu = float(np.sum(w * x))
        mus.append(mu)
        sds.append(float(np.sqrt(np.sum(w * (x - mu) ** 2))))
        trails.append(temps)
    return {"mus": mus, "sds": sds, "trails": trails,
            "wall": time.perf_counter() - t0}


@cpu_ref
def noisy_cpu() -> dict:
    return noisy_stats("cpu")


def noisy_anchor(dev, local: bool = False) -> dict:
    """The anchor over TOY_SEEDS on the card and on the CPU (the CPU
    reference process): the seed means of the posterior mean and sd
    against the exact posterior, and the card's mean against the CPU's.
    ``local``: with a LocalTransition over NOISY_LOCAL_SEEDS (K2's local
    mode, K14 on the rounds and over the record ring, K15, K12, K13), the
    card's mean within 4 se of the exact posterior and of the CPU's ->
    the card's launch and mode counts."""
    import numpy as np

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    var = 1.0 / (1.0 + 1.0 / 0.09)
    mu_true, sd_true = var * 0.8 / 0.09, math.sqrt(var)
    name = "noisy anchor, local" if local else "noisy anchor"
    reset_launch_counts()
    with plain_versions_raise():
        card = noisy_stats(dev, local)
    counts = launch_counts() | mode_launch_counts()
    log(f"{name} ({dev}): kernel launches {counts}")
    path = [k for k in SIR_PATH if k != "sir_simulate"]
    if local:
        path = [k for k in path if k not in ("mvn_mixture_logpdf",
                                             "mvn_fit")] + list(LOCAL_KERNELS)
        check(counts["mvn_fit"] == counts["mvn_mixture_logpdf"] == 0,
              f"{name}: an MVN kernel ran")
    check(all(counts[k] > 0 for k in path),
          f"a kernel of the {name}'s path was never launched")

    def summary(where, st):
        mus = st["mus"]
        m, se = float(np.mean(mus)), float(np.std(mus, ddof=1)
                                           / math.sqrt(len(mus)))
        m_sd = float(np.mean(st["sds"]))
        log(f"{name} ({where}, {len(mus)} seeds, {st['wall']:.2f} s): mean "
            f"of posterior means {m:.4f} se {se:.4f} (exact {mu_true:.4f}, "
            f"{(m - mu_true) / se:+.2f} se); mean posterior sd {m_sd:.4f} "
            f"(exact {sd_true:.4f}); seed 0 temperatures "
            f"{[round(t, 4) for t in st['trails'][0]]}; generations per "
            f"seed {sorted(set(len(t) for t in st['trails']))}")
        return m, se, m_sd

    m_d, se_d, sd_d = summary(dev, card)
    if local:
        check(abs(m_d - mu_true) < 4 * se_d, f"{name}: the card's seed mean "
              f"is 4 se or more off the exact posterior")
    else:
        check(abs(m_d - mu_true) < 0.02 and abs(sd_d - sd_true) < 0.02,
              "noisy anchor: the card's seed mean of the posterior mean or "
              "sd is 0.02 or more off the exact posterior")

    def compare():
        m_c, se_c, _sd = summary(
            "cpu", REFS.get("noisy_local_cpu" if local else "noisy_cpu"))
        gap = (m_d - m_c) / math.hypot(se_d, se_c)
        log(f"{name}: card - cpu {m_d - m_c:+.4f} ({gap:+.2f} se)")
        check(abs(gap) < 4.0, f"{name}: card and CPU means differ by >= 4 "
              "standard errors")

    PENDING.append(compare)
    return counts


def sir_config4(where, seed: int = 0, local: bool = False):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import sir

    kw = {"transitions": pt.LocalTransition()} if local else {}
    abc = pt.ABCSMC(sir.make_sir_model(), sir.default_prior(),
                    pt.IndependentNormalKernel(var=[100.0] * 15),
                    population_size=POP, eps=pt.Temperature(),
                    acceptor=pt.StochasticAcceptor(), seed=seed,
                    device=where, **kw)
    abc.MAX_ROUNDS = SIR_MAX_ROUNDS
    abc.new("sqlite://", sir.observed_data(seed=11), store_sum_stats=False)
    return abc


def sir_run(dev):
    """SIR config 4 on the card, the plain versions set to raise, the
    launch counts reset just before and read just after ->
    (launch counts, temperature trail)."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import sir

    label = "SIR config 4"
    abc = sir_config4(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=SIR_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    temps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    n_gen = len(temps)
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in sir.TRUE_PARS}
    sds = {k: float(np.sqrt(np.sum(w * (df[k] - means[k]) ** 2)))
           for k in means}
    evals = sum(g["n_valid"] for g in abc.generation_log)
    log(f"{label}: pop={POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"evaluations={evals} (rounds {rounds}, {syncs['by_kind']})")
    split = wall_split(abc)
    log(f"{label}: host seconds, rounds + generation steps "
        f"{split['compute_s']:.4f}, packed fetch {split['fetch_s']:.4f}, "
        f"History wait {split['persist_s']:.4f}, writer "
        f"{split['write_s']:.4f}, final flush {split['flush_s']:.4f}, "
        f"other "
        f"{wall - held_s(split):.4f}")
    norms = sorted(set(round(v, 4) for v in abc.acceptor.pdf_norms.values()))
    log(f"{label}: temperature trail {[round(t, 4) for t in temps]}; pdf "
        f"norms {norms}")
    log(f"{label}: posterior means {means} sd {sds} true {sir.TRUE_PARS}")
    log(f"{label}: kernel launches {counts}")
    check(n_gen == SIR_GENS, f"SIR ran {n_gen} of {SIR_GENS} generations")
    check(temps[-1] == 1.0 and all(b <= a for a, b in zip(temps, temps[1:])),
          "SIR temperature trail not non-increasing to exactly 1")
    check(all(counts[k] > 0 for k in SIR_PATH),
          "a kernel of the SIR path was never launched")
    check(counts["pnorm_accept_weight"] == counts["lv_simulate"] ==
          counts["scale_reduce"] == 0, "a p-norm kernel ran on the SIR path")
    # one counter read per round (calibration's too) and one fetch per
    # chunk: nothing else reads the device
    check(syncs["by_kind"].get("chunk_fetch") == 1
          and set(syncs["by_kind"]) == {"round_counters", "chunk_fetch"}
          and syncs["by_kind"]["round_counters"] >= sum(rounds),
          "SIR: a host read besides the round counters and the fetch")
    check(all(abs(means[k] - v) <= 3 * sds[k]
              for k, v in sir.TRUE_PARS.items()),
          "SIR posterior means beyond 3 posterior sd of TRUE_PARS")
    return counts, temps


def sir_cpu_trail(card_temps: list[float]) -> None:
    """SIR config 4 with the same seed on the CPU (plain versions, the
    same Philox streams) for its first generations: its temperatures
    beside the card's. The first two must agree within 1e-3; where the
    two part after that is a finding."""
    t0 = time.perf_counter()
    h = sir_config4("cpu").run(max_nr_populations=SIR_GENS,
                               max_total_nr_simulations=30_000)
    wall = time.perf_counter() - t0
    cpu = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    rel = [abs(a - b) / abs(b) for a, b in zip(card_temps, cpu)]
    parted = next((t for t, r in enumerate(rel) if r > 1e-3), None)
    log(f"SIR config 4 on the CPU (seed 0, {len(cpu)} generations, "
        f"{wall:.1f} s): temperatures {[round(t, 4) for t in cpu]}; |card "
        f"- cpu| / cpu {[float(f'{r:.2e}') for r in rel]}; first generation "
        f"apart by more than 1e-3: {parted}")
    check(len(rel) >= 2 and max(rel[:2]) <= 1e-3,
          "SIR: the CPU's first two temperatures differ from the card's by "
          "more than 1e-3")


#: the tractable pair anchor: x_obs, pop, generations, seeds, exact P(m=0)
PAIR_X, PAIR_POP, PAIR_GENS = 0.7, 600, 6
PAIR_SEEDS = tuple(range(16))
#: config 5: generations, and the kernels of its path
C5_GENS = 8
C5_PATH = ("propose", "mvn_mixture_logpdf", "ode_family_simulate",
           "pnorm_accept_weight", "compact_round", "normalize_quantile",
           "mvn_fit", "model_step", "pack_fetch", "generation_health")
#: K12's and K13's device ops (their names in torch.profiler's trace)
K12_K13_DEVICE_OPS = ("local_prep_kernel", "local_field_kernel",
                      "local_factor_kernel")
#: the tractable pair's path with a LocalTransition for each model
LOCAL_MODELS_PATH = ("propose", "propose_local", "local_logpdf",
                     "pnorm_accept_weight", "compact_round",
                     "normalize_quantile", "proposal_drift", "local_cov",
                     "local_factor", "model_step", "pack_fetch",
                     "generation_health", "propose_local:models",
                     "local_logpdf:models", "proposal_drift:models",
                     "local_cov:models", "local_factor:models")


#: the tractable pair with two GridSearchCVs (the JAX suite's cv 4 and
#: grid): its seeds on the card and the CPU
PAIR_GRID_SEEDS = tuple(range(8))
PAIR_GRID = (0.5, 1.0, 2.0)


def pair_abc(where, seed, kind: str = "mvn"):
    """The tractable pair (two Gaussian user models, sd 0.6 and 1.2) at
    x_obs PAIR_X; ``kind`` "local": each model with a LocalTransition(),
    "grid": with a GridSearchCV over PAIR_GRID, cv 4."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _an = msel.tractable_pair()
    kw = {}
    if kind == "host":
        kw["fused_generations"] = 1
    elif kind == "local":
        kw["transitions"] = [pt.LocalTransition(), pt.LocalTransition()]
    elif kind == "grid":
        kw["transitions"] = [
            pt.GridSearchCV(pt.MultivariateNormalTransition(),
                            {"scaling": list(PAIR_GRID)}, cv=4)
            for _ in range(2)]
    elif kind == "sharded":
        kw["sharded"] = 8
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=PAIR_POP, eps=pt.MedianEpsilon(),
                    seed=seed, device=where, **kw)
    abc.new("sqlite://", {"x": PAIR_X})
    return abc


def pair_stats(where, kind: str = "mvn") -> dict:
    """The pair over its seeds on one device -> each seed's P(m = 0) and
    the wall."""
    p0 = []
    t0 = time.perf_counter()
    for seed in {"grid": PAIR_GRID_SEEDS, "host": HL_PAIR_SEEDS,
                 "sharded": PAIR_SHARDED_SEEDS}.get(kind, PAIR_SEEDS):
        h = pair_abc(where, seed, kind).run(max_nr_populations=PAIR_GENS)
        check(h.n_populations == PAIR_GENS,
              f"tractable pair ({kind}) seed {seed} ({where}) ran "
              f"{h.n_populations} generations")
        p0.append(float(h.get_model_probabilities(h.max_t)["p"]
                        .get(0, 0.0)))
    return {"p0": p0, "wall": time.perf_counter() - t0}


@cpu_ref
def pair_cpu() -> dict:
    return pair_stats("cpu")


@cpu_ref
def pair_local_cpu() -> dict:
    return pair_stats("cpu", "local")


@cpu_ref
def pair_grid_cpu() -> dict:
    return pair_stats("cpu", "grid")


@cpu_ref
def pair_sharded_cpu() -> dict:
    return pair_stats("cpu", "sharded")


#: the K > 1 path of each pair kind (K26 and the K > 1 modes)
PAIR_GRID_PATH = ("propose", "mvn_mixture_logpdf", "pnorm_accept_weight",
                  "compact_round", "normalize_quantile", "grid_search_cv",
                  "model_step", "pack_fetch", "generation_health",
                  "grid_search_cv:models")


def pair_anchor(dev, kind: str = "mvn") -> dict | None:
    """The model-selection anchor over PAIR_SEEDS on the card and on the
    CPU (the CPU reference process): the seed mean of P(m = 0) against the
    exact model posterior (within 0.05), and the card's mean against the
    CPU's (within 4 se); ``kind`` "local": each model with a
    LocalTransition (K2's and K14's K > 1 local modes, the per-model K12,
    K13 and K15), "grid": with a GridSearchCV over PAIR_GRID_SEEDS (K17's
    K > 1 mode) -> the card's launch and mode counts."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import model_selection as msel

    exact = float(msel.tractable_pair()[2](PAIR_X)[0])
    name = {"mvn": "tractable pair", "local": "tractable pair, local",
            "grid": "tractable pair, GridSearchCV",
            "sharded": "tractable pair, 8 shards"}[kind]
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        card = pair_stats(dev, kind)
    counts = launch_counts() | mode_launch_counts()
    log(f"{name} ({dev}): kernel launches {counts}")
    path = {"mvn": [k for k in C5_PATH if k != "ode_family_simulate"],
            "local": list(LOCAL_MODELS_PATH), "grid": list(PAIR_GRID_PATH),
            "sharded": [k for k in C5_PATH if k != "ode_family_simulate"]
            + ["compact_round:shards", "shard_mask",
               "pack_fetch:merge"]}[kind] + ["mean_only_simulate"]
    check(all(counts[k] > 0 for k in path),
          f"a kernel of the {name}'s path was never launched")
    if kind == "local":
        check(counts["mvn_fit"] == counts["mvn_mixture_logpdf"] == 0,
              f"{name}: an MVN kernel ran")
    if kind == "grid":
        check(counts["mvn_fit"] == 0, f"{name}: K8 ran in K17's place")

    def summary(where, st):
        p0 = st["p0"]
        m = float(np.mean(p0))
        se = float(np.std(p0, ddof=1) / math.sqrt(len(p0)))
        log(f"{name} ({where}, {len(p0)} seeds, x_obs {PAIR_X}, pop "
            f"{PAIR_POP}, {PAIR_GENS} generations, {st['wall']:.2f} s): "
            f"mean P(m=0) {m:.4f} se {se:.4f} (exact {exact:.4f}, "
            f"{(m - exact) / se:+.2f} se); per seed min {min(p0):.4f} max "
            f"{max(p0):.4f}")
        return m, se

    m_d, se_d = summary(dev, card)
    check(abs(m_d - exact) < 0.05, f"{name}: the card's seed mean of "
          "P(m=0) is 0.05 or more off the exact posterior")

    def compare():
        cpu = REFS.get(
            {"mvn": "pair_cpu", "local": "pair_local_cpu",
             "grid": "pair_grid_cpu", "sharded": "pair_sharded_cpu"}[kind])
        m_c, se_c = summary("cpu", cpu)
        gap = (m_d - m_c) / math.hypot(se_d, se_c)
        log(f"{name}: card - cpu {m_d - m_c:+.4f} ({gap:+.2f} se)")
        check(abs(gap) < 4.0, f"{name}: card and CPU means differ by >= "
              "4 standard errors")
        if kind == "mvn":
            # the same Philox streams on card and CPU: seed 0 itself
            rel = rel_gap([card["p0"][0]], [cpu["p0"][0]])
            log(f"{name} seed 0, card against CPU: P(m=0) card "
                f"{card['p0'][0]:.6f} cpu {cpu['p0'][0]:.6f}, relative gap "
                f"{rel:.3e}")
            check(rel <= SEED_REL, f"{name} seed 0: card and CPU P(m=0) "
                  f"apart by more than {SEED_REL} relative")

    PENDING.append(compare)
    if kind not in ("mvn", "sharded"):
        abc = pair_abc(dev, 0, kind)
        profile_run(f"{name} (seed 0, profiled)", abc, PAIR_GENS)
        sync_check(abc, name)
        log(f"{name} (seed 0): wall split {wall_split(abc)}")
    return counts


def config5(where, seed: int = 0):
    """BASELINE config 5: the ODE family at its defaults (K = 3, n_obs 12,
    t1 8, 6 substeps, noise sd 0.3), observed_ode_family(seed=0,
    true_model=1), PNormDistance(p=2), MedianEpsilon, pop 1000."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _ts = msel.ode_family()
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=POP, eps=pt.MedianEpsilon(), seed=seed,
                    device=where)
    abc.new("sqlite://", msel.observed_ode_family(seed=0, true_model=1),
            store_sum_stats=False)
    return abc


def config5_run(dev):
    """Config 5 on the card, the plain versions set to raise, the launch
    counts reset just before and read just after -> (counts, eps trail)."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts

    label = "config 5 (ODE family, K = 3)"
    abc = config5(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=C5_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    n_gen = len(eps)
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    evals = sum(g["n_valid"] for g in abc.generation_log)
    log(f"{label}: pop={POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"evaluations={evals} (rounds {rounds}, {syncs['by_kind']})")
    split = wall_split(abc)
    log(f"{label}: host seconds, rounds + generation steps "
        f"{split['compute_s']:.4f}, packed fetch {split['fetch_s']:.4f}, "
        f"History wait {split['persist_s']:.4f}, writer "
        f"{split['write_s']:.4f}, final flush {split['flush_s']:.4f}, "
        f"other "
        f"{wall - held_s(split):.4f}")
    probs = h.get_model_probabilities()
    log(f"{label}: eps trail {[round(e, 5) for e in eps]}")
    log(f"{label}: model probabilities per generation "
        f"{np.round(probs.to_numpy(), 4).tolist()}")
    means = {}
    for m in h.alive_models():
        df, w = h.get_distribution(m)
        means[m] = {k: round(float(np.sum(df[k] * w)), 4)
                    for k in df.columns}
    log(f"{label}: per-model posterior means {means} (true model 1 at "
        f"a 0.4, b 0.5)")
    log(f"{label}: kernel launches {counts}")
    check(n_gen == C5_GENS, f"config 5 ran {n_gen} of {C5_GENS} generations")
    check(all(counts[k] > 0 for k in C5_PATH),
          "a kernel of the config 5 path was never launched")
    check(counts["lv_simulate"] == counts["sir_simulate"] ==
          counts["kernel_accept"] == counts["temperature_update"] ==
          counts["scale_reduce"] == 0,
          "a kernel of another path ran on config 5")
    check(syncs["by_kind"].get("chunk_fetch") == 1
          and set(syncs["by_kind"]) == {"round_counters", "chunk_fetch"}
          and syncs["by_kind"]["round_counters"] >= sum(rounds),
          "config 5: a host read besides the round counters and the fetch")
    p_last = probs.to_numpy()[-1]
    check(abs(float(p_last.sum()) - 1.0) < 1e-9 and p_last[0] < 0.9,
          "config 5: model probabilities do not sum to 1, or the decay "
          "model dominates")
    check(all(b < a for a, b in zip(eps, eps[1:])),
          "config 5 epsilons did not fall under a fixed distance")
    check(all(math.isfinite(v) for mm in means.values()
              for v in mm.values()), "non-finite config 5 posterior mean")
    return counts, eps


def config5_cpu_trail(card_eps: list[float]) -> None:
    """Config 5 with the same seed on the CPU (plain versions, the same
    Philox streams) for its first three generations: the epsilons must
    equal the card's within 1e-4 relative."""
    t0 = time.perf_counter()
    h = config5("cpu").run(max_nr_populations=3)
    wall = time.perf_counter() - t0
    cpu = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    rel = [abs(a - b) / abs(b) for a, b in zip(card_eps, cpu)]
    log(f"config 5 on the CPU (seed 0, {len(cpu)} generations, {wall:.1f} "
        f"s): eps trail {[round(e, 5) for e in cpu]}; |card - cpu| / cpu "
        f"{[float(f'{r:.2e}') for r in rel]}")
    check(len(rel) == 3 and max(rel) <= 1e-4,
          "config 5: the CPU's first three epsilons differ from the card's "
          "by more than 1e-4")



# ------------------------------------- tau leap and early reject (PR 5)
#: BASELINE config 3 as bench.py's gillespie early-reject lane runs it
#: (bench.py:974-1063, pyabc_tpu/utils/bench_defaults.py:161-164): the
#: birth-death model in 10 segments, PNormDistance(p=2), MedianEpsilon,
#: 12 generations, chunks of G = 2, seed 7, cut from pop 131072 to 16384
#: (B 65536): at 131072 generations 10 and 11 need more than the 256
#: rounds of 131072 lanes a generation may take, and K3 over the
#: 131072-row mixture costs tens of ms a round (timed below). The phase-2
#: rounds of K18 and K19 run at the bench's full B = 131072.
C3_POP, C3_GENS, C3_SEGS, C3_G, C3_SEED = 16384, 12, 10, 2, 7
#: the bench's population and lanes a round, where phase 2 checks K18/K19
C3_BENCH_POP = 131072
#: the late window: generations at or below this acceptance (the bench's
#: SCENARIO_LATE_ACC)
C3_LATE_ACC = 0.01
#: the scenario zoo's stochastic LV and network SIR lanes
#: (bench.py:1145-1190): pop 16384, 4 generations, G = 4, seed 5
ZOO_POP, ZOO_GENS, ZOO_SEED = 16384, 4, 5
#: a lower count of a Poisson draw's work: one Philox block (about 80
#: integer operations) and one log (about 20)
OPS_PER_DRAW = 100
#: the kernels of config 3's path, with early reject on (K18) and off (K19)
C3_PATH = ("propose", "mvn_mixture_logpdf", "segment_round", "tau_leap",
           "pnorm_accept_weight", "compact_round", "normalize_quantile",
           "mvn_fit", "pack_fetch", "generation_health")
SEG_KERNELS = ("segment_round", "tau_leap")


def equal_nan(a, b) -> bool:
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def abs_err(a, b) -> float:
    """max |a - b| (0 for no elements), NaN against NaN counted equal and
    NaN against a number infinite."""
    import torch

    a, b = a.double(), b.double()
    if a.numel() == 0:
        return 0.0
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, (a - b).abs())
    return float(torch.nan_to_num(d, nan=math.inf).max())


def seg_inputs(dev, model, prior, obs, B: int, seed: int = 1):
    """A prior round of a segmented model on the card: theta and valid
    (K2), the flat spec, the emission map and x0."""
    import torch

    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import philox, propose

    spec = SumStatSpec(obs)
    theta, _lp, valid = propose(stream_on(dev, philox.PRIOR, seed=seed), B,
                                prior.arrays(dev))
    x0 = torch.as_tensor(spec.flatten_host(obs), dtype=torch.float32,
                         device=dev)
    return dict(theta=theta.contiguous(), valid=valid, spec=spec,
                imap=model.index_map(spec, dev), x0=x0,
                stream=stream_on(dev, philox.SIM_NOISE, seed=seed))


def k19_checks(dev) -> dict:
    """K19 against its plain version at config 3's round (B 131072) for
    birth-death, its midpoint variant and the stochastic LV: every count
    equal. Then card against CPU on 8192 lanes of the birth-death round:
    how many lanes differ (a last-bit logf or lgammaf may flip a count)."""
    from dataclasses import replace

    import torch

    from pyabc_tpu_torch.kernels import tau_leap, tau_leap_plain
    from pyabc_tpu_torch.kernels.philox import PhiloxStream
    from pyabc_tpu_torch.models import gillespie as g

    B = C3_BENCH_POP
    bd = g.make_birth_death_model(segments=C3_SEGS)
    lvm = g.make_stochastic_lv_model(segments=C3_SEGS)
    res = None
    for label, model, prior, obs, mid in (
            ("birth-death", bd, g.birth_death_prior(),
             g.observed_birth_death(segments=C3_SEGS), False),
            ("birth-death midpoint", bd, g.birth_death_prior(),
             g.observed_birth_death(segments=C3_SEGS), True),
            ("stochastic LV", lvm, g.stochastic_lv_prior(),
             g.observed_stochastic_lv(segments=C3_SEGS), False)):
        x = seg_inputs(dev, model, prior, obs, B)
        spec = replace(model.chain.kernel[1], midpoint=mid)
        kw = dict(colmap=x["imap"], width=x["spec"].total_size)

        def run(spec=spec, x=x, kw=kw):
            return tau_leap(spec, x["theta"], x["stream"], **kw)[0]

        got = run()
        t0 = time.perf_counter()
        ref = tau_leap_plain(spec, x["theta"], x["stream"], **kw)[0]
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        lanes = int((~((got == ref) | (torch.isnan(got) & torch.isnan(ref)))
                     ).any(1).sum())
        log(f"K19 tau_leap {label} (B={B}, {spec.n_leaps} leaps x "
            f"{spec.n_rates} channels, {spec.n_seg} segments): lanes "
            f"differing from the plain version on the card {lanes}; counts "
            f"up to {float(ref[torch.isfinite(ref)].max()):.0f}")
        check(lanes == 0, f"K19 {label}: a count differs from the plain "
              f"version on the card")
        if res is not None:
            continue
        # card against CPU, birth-death, 8192 lanes of the same round
        n = 8192
        ctr = x["stream"].counters.cpu()
        st_cpu = PhiloxStream(x["stream"].seed, x["stream"].generation,
                              x["stream"].tag, x["stream"].max_rounds, ctr)
        cpu = tau_leap_plain(spec, x["theta"][:n].cpu(), st_cpu,
                             colmap=x["imap"].cpu(),
                             width=x["spec"].total_size)[0]
        cpu_lanes = int((cpu != got[:n].cpu()).any(1).sum())
        log(f"K19 card against CPU (birth-death, {n} lanes of the round): "
            f"{cpu_lanes} lanes differ")
        draws = B * spec.n_leaps * spec.n_rates
        res = dict(
            err=0.0, call_ms=time_ms(run, 10),
            ms=graph_ms(run, iters=10, replays=3), plain_ms=plain_s * 1e3,
            bound=bound(B * (2 + x["spec"].total_size) * 4,
                        draws * OPS_PER_DRAW), library_ms=None,
            cpu_lanes_differ=cpu_lanes)
    return res


def k20b_network_checks(dev) -> dict:
    """K20b network at B 65536 (pick_batch(16384)), and with Philox noise
    at B 4096, against its plain version: within 1e-4 relative."""
    from dataclasses import replace

    import torch

    from pyabc_tpu_torch.kernels import network_sir, network_sir_plain
    from pyabc_tpu_torch.models import sir
    from pyabc_tpu_torch.utils import pick_batch

    B = pick_batch(ZOO_POP)
    model = sir.make_network_sir_model()
    x = seg_inputs(dev, model, sir.network_sir_prior(),
                   sir.observed_network_sir(), B)
    spec = model.chain.kernel[1]

    def run():
        return network_sir(spec, x["theta"], x["stream"])[0]

    got = run()
    t0 = time.perf_counter()
    ref = network_sir_plain(spec, x["theta"], x["stream"])[0]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    noisy = replace(spec, noise_sd=8.0)
    th = x["theta"][:4096].contiguous()
    n_got = network_sir(noisy, th, x["stream"])[0]
    n_ref = network_sir_plain(noisy, th, x["stream"])[0]
    err = float((got - ref).abs().max())
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1)).max())
    n_rel = float(((n_got - n_ref).abs() / n_ref.abs().clamp_min(1)).max())
    log(f"K20b network_sir (B={B}, 8 patches, 16 obs x 4 substeps, 4 "
        f"segments): max_abs_err={err:.3e} max_rel_err={rel:.3e}; B=4096 "
        f"with noise max_rel_err={n_rel:.3e}")
    check(rel <= 1e-4 and n_rel <= 1e-4,
          "K20b network outside 1e-4 relative of its plain version")
    steps = spec.n_obs * spec.n_substeps
    # per RK4 step 4 right-hand sides of 8 patches (about 12 operations a
    # patch) and the stage and final updates (about 30 a patch)
    return dict(err=err, call_ms=time_ms(run, 20),
                ms=graph_ms(run, iters=20, replays=3),
                plain_ms=plain_s * 1e3,
                bound=bound(B * (2 + 128) * 4, B * steps * 8 * 78),
                library_ms=None)


def k18_case(dev, model, x, eps, ring_cap: int, label: str, w=None,
             agg=None):
    """K18 and its plain version on one round, each followed by K5 (K25
    under an aggregated distance: ``agg`` its p's, ``w`` its flat params)
    and K6 (with a ring of the completed slots) into fresh buffers: the
    kept slots, their statistics, the reservoir, the ring and the counters
    must be bit-identical."""
    import torch

    from pyabc_tpu_torch.kernels import (aggregate_accept_weight,
                                         compact_round, pnorm_accept_weight,
                                         segment_round, segment_round_plain)

    B, S = x["theta"].shape[0], x["spec"].total_size
    if w is None:
        w = torch.ones(S, device=dev)
    kw = dict(imap=x["imap"], x0=x["x0"], w=w, p=2.0, eps=eps, width=S,
              agg=agg)
    outs = []
    for fn in (segment_round, segment_round_plain):
        ctr = torch.zeros(4, dtype=torch.int64, device=dev)
        ss, keep = fn(model.segmented, x["theta"], x["valid"], x["stream"],
                      seg_ctr=ctr, **kw)
        if agg is None:
            d, acc, lw = pnorm_accept_weight(ss, x["x0"], w, eps, keep,
                                             p=2.0)
        else:
            d, acc, lw = aggregate_accept_weight(ss, x["x0"], w, eps, keep,
                                                 ps=agg)
        n_cap = B
        d_th = x["theta"].shape[1]
        res = {"theta": torch.zeros(n_cap, d_th, device=dev),
               "sumstats": torch.zeros(n_cap, S, device=dev),
               "distance": torch.zeros(n_cap, device=dev),
               "log_weight": torch.full((n_cap,), -math.inf, device=dev),
               "slot": torch.full((n_cap,), -1, dtype=torch.int32,
                                  device=dev)}
        rec = {"sumstats": torch.zeros(ring_cap, S, device=dev),
               "distance": torch.zeros(ring_cap, device=dev),
               "accepted": torch.zeros(ring_cap, dtype=torch.bool,
                                       device=dev),
               "valid": torch.zeros(ring_cap, dtype=torch.bool, device=dev)}
        counters = torch.zeros(4, dtype=torch.int32, device=dev)
        compact_round(acc, keep, x["theta"], ss, d, lw, res, rec, counters)
        outs.append((ss, keep, ctr, res, rec, counters))
    (ss, keep, ctr, res, rec, cnt), (ss_r, keep_r, ctr_r, res_r, rec_r,
                                     cnt_r) = outs
    torch.cuda.synchronize()
    same = (torch.equal(keep, keep_r) and torch.equal(ss[keep], ss_r[keep])
            and torch.equal(ctr[:3], ctr_r[:3]) and torch.equal(cnt, cnt_r)
            and all(torch.equal(res[k], res_r[k]) for k in res)
            and all(torch.equal(rec[k], rec_r[k]) for k in rec))
    retired, steps, resolved, slots = (int(v) for v in ctr)
    n_seg = x["imap"].shape[0]
    log(f"K18 segment_round {label} (B={B}, {n_seg} segments, "
        f"{int(x['valid'].sum())} valid slots, eps={float(eps):.4g}): "
        f"retired {retired}, segments stepped {steps} of {B * n_seg}, "
        f"resolved {resolved}, accepted {int(cnt[0])}, occupancy "
        f"{steps / max(slots, 1):.4f}; bit-identical to the plain version "
        f"{same}")
    check(same, f"K18 {label}: kept slots, statistics, reservoir, ring or "
          f"counters differ from the plain version")
    check(retired > 0 and resolved == B and 0 < steps <= slots,
          f"K18 {label}: counters out of range")
    return ctr


def k18_checks(dev, eps_late: float) -> dict:
    """K18 against its plain version at config 3's round (B 131072, 10
    segments) with eps from generation 6 of the config 3 run, then at a
    small odd shape (B 256, 5 segments, 37 live slots); K18's device time
    per round on (that eps) and off (eps = inf, every slot runs every
    segment) beside K19's classic round."""
    import torch

    from pyabc_tpu_torch.kernels import (segment_round, segment_round_plain,
                                         tau_leap)
    from pyabc_tpu_torch.kernels.segment_round import THREADS_PER_SM
    from pyabc_tpu_torch.models import gillespie as g

    B = C3_BENCH_POP
    model = g.make_birth_death_model(segments=C3_SEGS)
    x = seg_inputs(dev, model, g.birth_death_prior(),
                   g.observed_birth_death(segments=C3_SEGS), B, seed=3)
    eps = torch.tensor(eps_late, dtype=torch.float32, device=dev)
    ctr = k18_case(dev, model, x, eps, 8192, "config 3 round")
    small = g.make_birth_death_model(n_leaps=100, n_obs=20, segments=5)
    xs = seg_inputs(dev, small, g.birth_death_prior(),
                    g.observed_birth_death(n_leaps=100, n_obs=20,
                                           segments=5), 256, seed=4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(37)
    live = torch.zeros(256, dtype=torch.bool, device=dev)
    live[torch.randperm(256, generator=gen, device=dev)[:37]] = True
    xs["valid"] = xs["valid"] & live
    full = small.chain.kernel[0](small.chain.kernel[1], xs["theta"],
                                 xs["stream"], colmap=xs["imap"],
                                 width=20)[0]
    d = (full - xs["x0"]).square().sum(1).sqrt()
    k18_case(dev, small, xs, torch.quantile(d[xs["valid"]], 0.5), 256,
             "small odd shape")

    S = x["spec"].total_size
    w = torch.ones(S, device=dev)
    inf = torch.tensor(math.inf, device=dev)
    scratch = torch.zeros(4, dtype=torch.int64, device=dev)

    def on(e=eps):
        return segment_round(model.segmented, x["theta"], x["valid"],
                             x["stream"], imap=x["imap"], x0=x["x0"], w=w,
                             p=2.0, eps=e, width=S, seg_ctr=scratch)

    def classic():
        return tau_leap(model.chain.kernel[1], x["theta"], x["stream"],
                        colmap=x["imap"], width=S)

    ms_on = graph_ms(on, iters=10, replays=3)
    ms_all = graph_ms(lambda: on(inf), iters=10, replays=3)
    ms_k19 = graph_ms(classic, iters=10, replays=3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"K18 device ms per config 3 round (B={B}, {sms} SMs x "
        f"{THREADS_PER_SM} threads = {min(B, sms * THREADS_PER_SM)} "
        f"threads for {B} slots): early reject on {ms_on:.4f} (eps "
        f"{eps_late:.4g}), K18 at eps = inf {ms_all:.4f}, K19 classic "
        f"round {ms_k19:.4f}")
    zoo_round_times(dev)
    t0 = time.perf_counter()
    segment_round_plain(model.segmented, x["theta"], x["valid"],
                        x["stream"], imap=x["imap"], x0=x["x0"], w=w, p=2.0,
                        eps=eps, width=S,
                        seg_ctr=torch.zeros(4, dtype=torch.int64,
                                            device=dev))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    steps = int(ctr[1])
    spec = model.chain.kernel[1]
    return dict(err=0.0, call_ms=time_ms(on, 10), ms=ms_on,
                plain_ms=plain_ms,
                bound=bound(B * (2 + S) * 4, steps * spec.leaps_per_seg
                            * spec.n_rates * OPS_PER_DRAW),
                library_ms=None, ms_eps_inf=ms_all, ms_k19_round=ms_k19)


def zoo_round_times(dev) -> None:
    """K18 at eps = inf (every slot runs every segment) beside the classic
    round (K19 / K20b network) for the zoo's stochastic LV and network SIR
    at their round of B 65536: the cost of the segmented form itself."""
    import torch

    from pyabc_tpu_torch.kernels import segment_round
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.models import sir
    from pyabc_tpu_torch.utils import pick_batch

    B = pick_batch(ZOO_POP)
    inf = torch.tensor(math.inf, device=dev)
    for label, model, prior, obs in (
            ("stochastic LV", g.make_stochastic_lv_model(segments=C3_SEGS),
             g.stochastic_lv_prior(),
             g.observed_stochastic_lv(segments=C3_SEGS)),
            ("network SIR", sir.make_network_sir_model(),
             sir.network_sir_prior(), sir.observed_network_sir())):
        x = seg_inputs(dev, model, prior, obs, B, seed=5)
        S = x["spec"].total_size
        w = torch.ones(S, device=dev)
        ctr = torch.zeros(4, dtype=torch.int64, device=dev)
        kern, spec = model.chain.kernel
        seg_ms = graph_ms(lambda: segment_round(
            model.segmented, x["theta"], x["valid"], x["stream"],
            imap=x["imap"], x0=x["x0"], w=w, p=2.0, eps=inf, width=S,
            seg_ctr=ctr), iters=10, replays=3)
        classic_ms = graph_ms(lambda: kern(spec, x["theta"], x["stream"],
                                           colmap=x["imap"], width=S),
                              iters=10, replays=3)
        log(f"K18 at eps = inf against the classic round, {label} (B={B}, "
            f"{spec.n_seg} segments): K18 {seg_ms:.4f} ms, classic "
            f"{classic_ms:.4f} ms")


def seg_run(abc, gens: int, label: str):
    """One run on the card with the plain versions set to raise -> (History,
    wall seconds, launch counts of the run, the kernels' modes as
    "name:mode")."""
    import torch

    from pyabc_tpu_torch.kernels import launch_counts, mode_launch_counts

    before = launch_counts() | mode_launch_counts()
    torch.cuda.synchronize()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = launch_counts() | mode_launch_counts()
    return h, wall, {k: after[k] - before[k] for k in after}


def populations_identical(h_on, h_off, K: int = 1) -> bool:
    """Every generation's model probabilities, each alive model's
    particles and weights, the distances and the epsilon trail equal."""
    import numpy as np

    if h_on.max_t != h_off.max_t:
        return False
    for t in range(h_on.max_t + 1):
        p_on = h_on.get_model_probabilities(t)["p"]
        if not np.array_equal(p_on.to_numpy(),
                              h_off.get_model_probabilities(t)["p"]
                              .to_numpy()):
            return False
        for m in range(K):
            if float(p_on.get(m, 0.0)) == 0.0:
                continue
            a, wa = h_on.get_distribution(m=m, t=t)
            b, wb = h_off.get_distribution(m=m, t=t)
            if not (np.array_equal(a.to_numpy(), b.to_numpy())
                    and np.array_equal(wa, wb)):
                return False
        if not np.array_equal(
                h_on.get_weighted_distances(t)["distance"].to_numpy(),
                h_off.get_weighted_distances(t)["distance"].to_numpy()):
            return False
    return np.array_equal(h_on.get_all_populations()["epsilon"],
                          h_off.get_all_populations()["epsilon"])


def seg_totals(h) -> dict:
    tel = [h.get_telemetry(t) for t in range(h.max_t + 1)]
    return {k: sum(x.get(k, 0) for x in tel)
            for k in ("retired_early", "seg_steps", "seg_resolved")} | {
        "occupancy": [x.get("segment_occupancy") for x in tel]}


def config3(where, early, pop: int | None = None, local: bool = False,
            pair: bool = False):
    """Config 3 (``local``: with a LocalTransition; ``pair``: beside a
    second birth-death model of initial count 25, each with its own
    transition)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gillespie as g

    models = g.make_birth_death_model(segments=C3_SEGS)
    priors = g.birth_death_prior()
    tr = pt.LocalTransition if local else pt.MultivariateNormalTransition
    kw = {"transitions": tr()} if local else {}
    if pair:
        models = [models, g.make_birth_death_model(segments=C3_SEGS, x0=25.0,
                                                   name="bd25")]
        priors = [priors, g.birth_death_prior()]
        kw = {"transitions": [tr(), tr()]}
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=pop or C3_POP, eps=pt.MedianEpsilon(),
                    seed=C3_SEED,
                    early_reject=early, fused_generations=C3_G, device=where,
                    **kw)
    abc.new("sqlite://", g.observed_birth_death(segments=C3_SEGS),
            store_sum_stats=False)
    return abc


def chunk_window(abc, pop: int, lo: int, hi: int) -> tuple[float, int]:
    """(wall seconds, accepted particles) of the chunks lying wholly inside
    generations lo..hi (bench.py's window)."""
    chunks: dict = {}
    for g in abc.generation_log:
        c = chunks.setdefault(g["chunk_index"], {"ts": [], "s": 0.0})
        c["ts"].append(g["t"])
        c["s"] = g["chunk_s"]
    wall, acc = 0.0, 0
    for c in chunks.values():
        if min(c["ts"]) >= lo and max(c["ts"]) <= hi:
            wall += c["s"]
            acc += pop * len(c["ts"])
    return wall, acc


#: runs of an on / off comparison, in turns: on, off, off, on
TURNS = ("auto", False, False, "auto")


def config3_run(dev):
    """Config 3 on the card with early reject on and off in turns (on,
    off, off, on), the counts reset just before the first and read after
    each: bit-identical populations, retirements, the late window's
    accepted particles/s, syncs per generation and the epsilon trail ->
    (counts of the four runs, eps trail)."""
    from pyabc_tpu_torch.kernels import reset_launch_counts

    label = f"config 3 (birth-death, {C3_SEGS} segments)"
    runs = []
    reset_launch_counts()
    for early in TURNS:
        abc = config3(dev, early)
        h, wall, counts = seg_run(abc, C3_GENS, label)
        runs.append((early, abc, h, wall, counts))
    counts = {k: sum(r[4][k] for r in runs) for k in runs[0][4]}
    (_e, a_on, h_on, _w, c_on), (_e2, a_off, h_off, _w2, c_off) = runs[:2]
    n_gen = h_on.max_t + 1
    eps = [float(e) for e in h_on.get_all_populations()["epsilon"][1:]]
    same = populations_identical(h_on, h_off)
    trails = [[float(e) for e in r[2].get_all_populations()["epsilon"][1:]]
              for r in runs]
    tot = seg_totals(h_on)
    saved = 1.0 - tot["seg_steps"] / max(tot["seg_resolved"] * C3_SEGS, 1)
    acc_off = [g["acceptance_rate"] for g in a_off.generation_log]
    late = next((t for t, a in enumerate(acc_off) if a <= C3_LATE_ACC),
                None)
    pps = {"on": [], "off": [], "late_on": [], "late_off": []}
    for early, abc, h, wall, _c in runs:
        tag = "on" if early == "auto" else "off"
        syncs = abc.sync_ledger.summary()
        rounds = [g["rounds"] for g in abc.generation_log]
        wall_1, acc_1 = chunk_window(abc, C3_POP, 1, n_gen - 1)
        split = wall_split(abc)
        pps[tag].append(acc_1 / max(wall_1, 1e-9))
        log(f"{label} early reject {tag}: pop={C3_POP} gens={h.max_t + 1} "
            f"wall_s={wall:.3f} accepted_particles_per_s="
            f"{C3_POP * (h.max_t + 1) / wall:.1f} (generations 1 on: "
            f"{pps[tag][-1]:.1f}) syncs_per_generation="
            f"{syncs['syncs'] / (h.max_t + 1):.2f} rounds {rounds} "
            f"{syncs['by_kind']}; host seconds, rounds + steps "
            f"{split['compute_s']:.3f}, fetch {split['fetch_s']:.3f}, "
            f"History wait {split['persist_s']:.3f}, writer "
            f"{split['write_s']:.3f}, final flush {split['flush_s']:.3f}")
        if late is not None:
            wl, al = chunk_window(abc, C3_POP, late, n_gen - 1)
            pps["late_" + tag].append(al / max(wl, 1e-9))
            log(f"{label} early reject {tag}: late window (generations "
                f"{late}-{n_gen - 1}, acceptance <= {C3_LATE_ACC}) "
                f"accepted_particles_per_s={pps['late_' + tag][-1]:.1f} "
                f"over {wl:.3f} s")
    mean = {k: sum(v) / len(v) for k, v in pps.items() if v}
    log(f"{label}: mean accepted_particles_per_s over the two runs each, "
        f"generations 1 on: on {mean['on']:.1f} off {mean['off']:.1f}"
        + (f"; late window: on {mean['late_on']:.1f} off "
           f"{mean['late_off']:.1f}" if late is not None else
           f"; the late window (acceptance <= {C3_LATE_ACC}) was not "
           f"reached"))
    log(f"{label}: eps trail {[round(e, 4) for e in eps]}; acceptance "
        f"{[round(a, 5) for a in acc_off]}")
    log(f"{label}: populations bit-identical on and off {same}; "
        f"retired_early {tot['retired_early']}, seg_steps "
        f"{tot['seg_steps']}, seg_resolved {tot['seg_resolved']}, "
        f"sim_work_saved_frac {saved:.4f}, segment_occupancy per "
        f"generation {tot['occupancy']}")
    log(f"{label}: kernel launches on {c_on} off {c_off}")
    s_on = a_on.sync_ledger.count / n_gen
    s_off = a_off.sync_ledger.count / (h_off.max_t + 1)
    check(n_gen == C3_GENS and h_off.max_t + 1 == C3_GENS,
          f"config 3 ran {n_gen} / {h_off.max_t + 1} of {C3_GENS} "
          f"generations")
    check(same and all(t == trails[0] for t in trails),
          "config 3: populations differ with early reject on and off")
    check(tot["retired_early"] > 0, "config 3: no lane retired early")
    check(all(o is not None and 0 < o <= 1 for o in tot["occupancy"]),
          "config 3: segment occupancy outside (0, 1]")
    check(s_on <= s_off, "config 3: more syncs per generation with early "
          "reject on than off")
    check(c_on["segment_round"] > 0 and c_off["tau_leap"] > 0
          and c_off["segment_round"] == 0,
          "config 3: K18 (on) or K19 (off) was never launched")
    check(all(counts[k] > 0 for k in C3_PATH),
          "a kernel of the config 3 path was never launched")
    check(all(b <= a for a, b in zip(eps, eps[1:])),
          "config 3 epsilons increased under a fixed distance")
    return counts, eps


def k3_at_bench_pop(dev) -> None:
    """K3's time for one round at the bench's pop 131072 (B 131072 lanes
    against a 131072-row mixture, d 2) beside config 3's B 65536 x 16384:
    why config 3 runs at pop 16384 here."""
    import torch

    from pyabc_tpu_torch.kernels import mvn_mixture_logpdf
    from pyabc_tpu_torch.transition import MultivariateNormalTransition

    tr = MultivariateNormalTransition()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for B, n in ((65536, C3_POP), (C3_BENCH_POP, C3_BENCH_POP)):
        th = torch.randn(n, 2, generator=g, device=dev)
        params = tr.device_fit(th, torch.full((n,), 1.0 / n, device=dev),
                               dim=2, **tr.fit_statics())
        q = torch.randn(B, 2, generator=g, device=dev)
        ms = time_ms(lambda: mvn_mixture_logpdf(q, params), 3, warmup=1)
        log(f"K3 mvn_mixture_logpdf at B={B} lanes x n={n} components "
            f"(d 2): {ms:.3f} ms a round")


def config3_trail(where) -> list[float]:
    """Config 3 at pop 1024, 3 generations with early reject on -> its
    epsilons."""
    h = config3(where, "auto", pop=1024).run(max_nr_populations=3)
    return [float(e) for e in h.get_all_populations()["epsilon"][1:]]


@cpu_ref
def config3_cpu() -> dict:
    return {"eps": config3_trail("cpu")}


def config3_cpu_trail(dev) -> None:
    """The same seed at pop 1024 on the card and on the CPU (plain
    versions, the same Philox streams, the CPU's in the reference
    process), 3 generations with early reject on: the epsilons must agree
    within 1e-3 relative (a last-bit logf may flip a Poisson count)."""
    card = config3_trail(dev)

    def compare():
        ref = REFS.get("config3_cpu")
        cpu = ref["eps"]
        rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        log(f"config 3 at pop 1024 (3 generations): card eps {card}, CPU "
            f"eps {cpu} ({ref['wall_s']:.1f} s); |card - cpu| / cpu "
            f"{[float(f'{r:.2e}') for r in rel]}")
        check(len(rel) == 3 and max(rel) <= 1e-3,
              "config 3: the CPU's first three epsilons differ from the "
              "card's by more than 1e-3")

    PENDING.append(compare)


def zoo_runs(dev) -> dict:
    """The scenario zoo's stochastic LV (10 segments) and network SIR (4
    segments) lanes, pop 16384, 4 generations, early reject on and off in
    turns: bit-identical populations -> {name: launch counts of the four
    runs}."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import reset_launch_counts
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.models import sir

    out = {}
    for name, mk, prior, obs in (
            ("stochastic_lv",
             lambda: g.make_stochastic_lv_model(segments=C3_SEGS),
             g.stochastic_lv_prior(),
             g.observed_stochastic_lv(segments=C3_SEGS)),
            ("network_sir", sir.make_network_sir_model,
             sir.network_sir_prior(), sir.observed_network_sir())):
        reset_launch_counts()
        hs, walls, cs = [], [], []
        for early in TURNS:
            abc = pt.ABCSMC(mk(), prior, pt.PNormDistance(p=2),
                            population_size=ZOO_POP, eps=pt.MedianEpsilon(),
                            seed=ZOO_SEED, early_reject=early,
                            fused_generations=ZOO_GENS, device=dev)
            abc.new("sqlite://", obs, store_sum_stats=False)
            h, wall, c = seg_run(abc, ZOO_GENS, name)
            hs.append(h)
            walls.append(wall)
            cs.append(c)
        same = populations_identical(hs[0], hs[1])
        tot = seg_totals(hs[0])
        n = hs[0].max_t + 1
        pps = [ZOO_POP * (h.max_t + 1) / w for h, w in zip(hs, walls)]
        log(f"zoo {name}: pop={ZOO_POP} gens={n} accepted_particles_per_s "
            f"on {pps[0]:.1f}, {pps[3]:.1f} off {pps[1]:.1f}, {pps[2]:.1f} "
            f"(in turns: on, off, off, on); bit-identical {same}; "
            f"retired_early {tot['retired_early']}, occupancy "
            f"{tot['occupancy']}; launches on {cs[0]}")
        check(same and n == ZOO_GENS,
              f"zoo {name}: populations differ with early reject on and off")
        check(cs[0]["segment_round"] > 0,
              f"zoo {name}: K18 was never launched")
        out[name] = {k: sum(c[k] for c in cs) for k in cs[0]}
    check(out["network_sir"]["network_sir"] > 0,
          "K20b network was never launched")
    return out


# ------------------------- adaptive early reject and the segmented family
#: the scenario lane's adaptive leg at config 3's full width (bench.py:
#: 1255-1295 with config 3's shape): birth-death in 10 segments,
#: AdaptivePNormDistance(p=2, scale_function=standard_deviation),
#: MedianEpsilon, pop 16384 (B 65536), 12 generations, G 2, seed 7
C3A_GENS = 12
#: the bench's own adaptive leg: pop 128, 5 generations, G 2, seed 17,
#: its parity rule (posterior-mean gap on / off < 0.5)
BA_POP, BA_GENS, BA_G, BA_SEED, BA_PARITY = 128, 5, 2, 17, 0.5
#: the zoo's model-selection leg (bench.py:1189-1194): ode_family(segments
#: =4), observed_ode_family(seed=0, segments=4), pop 8192, 3 generations,
#: G 3, seed 5
ZMS_POP, ZMS_GENS, ZMS_SEED, ZMS_SEGS = 8192, 3, 5, 4
#: the kernels each leg must launch (with early reject on)
ADAPTIVE_PATH = C3_PATH + ("moment_fold", "moment_finish", "scale_reduce")
ZMS_PATH = ("propose", "mvn_mixture_logpdf", "segment_round",
            "ode_family_segments", "pnorm_accept_weight", "compact_round",
            "normalize_quantile", "mvn_fit", "pack_fetch",
            "generation_health", "model_step")
#: the kernels of this slice, reported from these legs' runs
PR7_KERNELS = ("moment_fold", "moment_finish")
ZMS_KERNELS = ("ode_family_segments",)
#: operations of one RK4 step of the family (4 right-hand sides of at most
#: 4 operations, the stage updates and the sum) and of one normal draw
#: (a Philox block, a log, a sqrt and a cos)
OPS_RK4_FAMILY, OPS_NORMAL = 26, 120


def k22_checks(dev) -> dict:
    """K22's fold at config 3's round (B 65536, S 20, birth-death's
    emission map in 10 segments) with slots retired at every segment,
    invalid slots and the record window cut inside the round: counts and
    extrema equal to the plain version's, sums within 1e-5 relative, and
    the same from run to run. The finish for all seven moment scales over
    the block, with 16384 accepted rows: scale within 1e-6 relative,
    weights and distances within 1e-5."""
    import torch

    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import (moment_finish, moment_finish_plain,
                                         moment_fold, moment_fold_plain)
    from pyabc_tpu_torch.kernels.moments import SCALE_NAMES, seg_of_columns
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.ops.scale_reduce import init_moments

    B, n_rows = 65536, C3_POP
    model = g.make_birth_death_model(segments=C3_SEGS)
    spec = SumStatSpec(g.observed_birth_death(segments=C3_SEGS))
    S = spec.total_size
    imap = model.index_map(spec, dev)
    seg_of = torch.as_tensor(seg_of_columns(imap), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    nseg = torch.randint(1, C3_SEGS + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    valid = torch.rand(B, generator=gen, device=dev) > 0.1
    ss = torch.randn(B, S, generator=gen, device=dev) * 12 + 40
    ss[seg_of[None, :] >= nseg[:, None]] = math.nan
    x0 = torch.as_tensor(spec.flatten_host(
        g.observed_birth_death(segments=C3_SEGS)), dtype=torch.float32,
        device=dev)
    ctr = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr[1] = 3
    rec_cap = 3 * B + B // 3  # the window ends inside this round
    kw = dict(rec_cap=rec_cap)
    blocks = []
    for fn in (moment_fold, moment_fold, moment_fold_plain):
        mom = init_moments(S, dev)
        fn(mom, ss, nseg, valid, seg_of, x0, ctr, **kw)
        blocks.append(mom)
    got, again, ref = blocks
    torch.cuda.synchronize()
    err = float((got - ref).abs()[:3].max())
    log(f"K22 moment_fold (B={B}, S={S}, {C3_SEGS} segments, slots "
        f"retired at every segment, {int((~valid).sum())} invalid, the "
        f"window at slot {rec_cap - 3 * B} of the round): counts "
        f"{ref[3].tolist()[:4]}..., max_abs_err={err:.3e}; the same from "
        f"run to run {torch.equal(got, again)}")
    check(sorted(nseg.unique().tolist()) == list(range(1, C3_SEGS + 1)),
          "K22: the fold's slots do not retire at every segment")
    check(torch.equal(got, again), "K22 fold: sums differ run to run")
    check(torch.equal(got[3:], ref[3:]),
          "K22 fold: counts or extrema differ from the plain version")
    check(within(got[:3], ref[:3], 1e-3, 1e-5),
          "K22 fold: sums outside 1e-5 relative of the plain version")
    # the bytes the fold needs at these inputs: valid for the slots in the
    # window, nseg for the valid ones, the cells it takes
    cells = int(ref[3].sum())
    win = min(max(rec_cap - int(ctr[1]) * B, 0), B)
    n_valid_win = int(valid[:win].sum())
    mom = got.clone()

    def fold():
        return moment_fold(mom, ss, nseg, valid, seg_of, x0, ctr, **kw)

    def fold_plain():
        return moment_fold_plain(mom, ss, nseg, valid, seg_of, x0, ctr,
                                 **kw)

    fold_res = dict(
        err=err, call_ms=time_ms(fold, 20), ms=graph_ms(fold, iters=20),
        plain_ms=time_ms(fold_plain, 10),
        bound=bound(win + n_valid_win * 4 + cells * 4 + S * 8
                    + 2 * 6 * S * 4, cells * 8),
        window_slots=win, cells=cells,
        library_ms=None)
    rows = (torch.randn(n_rows, S, generator=gen, device=dev) * 12
            + 40).contiguous()
    fin_err = 0.0
    for name in SCALE_NAMES:
        fkw = dict(scale_name=name, max_weight_ratio=None, rows=rows, p=2.0)
        sc, w, d = moment_finish(got, x0, **fkw)
        sc_r, w_r, d_r = moment_finish_plain(got, x0, **fkw)
        check(within(sc, sc_r, 0.0, 1e-6),
              f"K22 finish {name}: scale outside 1e-6 relative")
        check(within(w, w_r, 0.0, 1e-5) and within(d, d_r, 0.0, 1e-5),
              f"K22 finish {name}: weights or distances outside 1e-5")
        fin_err = max(fin_err, float((d - d_r).abs().max()),
                      float((w - w_r).abs().max()))
    log(f"K22 moment_finish (S={S}, {n_rows} rows, all seven moment "
        f"scales): max_abs_err={fin_err:.3e}")
    fkw = dict(scale_name="standard_deviation", rows=rows, p=2.0)
    finish_res = dict(
        err=fin_err,
        call_ms=time_ms(lambda: moment_finish(got, x0, **fkw), 20),
        ms=graph_ms(lambda: moment_finish(got, x0, **fkw), iters=20),
        plain_ms=time_ms(lambda: moment_finish_plain(got, x0, **fkw), 10),
        bound=bound(7 * S * 4 + n_rows * S * 4 + (2 * S + n_rows) * 4,
                    3 * n_rows * S + 20 * S),
        library_ms=None)
    return {"moment_fold": fold_res, "moment_finish": finish_res}


def family_round(dev, B: int, seed: int = 0):
    """A round of the segmented family: theta (B, 2) with model 0's second
    entry 0, each lane's model, and a valid mask."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    theta = torch.stack([torch.rand(B, generator=gen, device=dev) + 0.05,
                         torch.rand(B, generator=gen, device=dev) * 9 + 1],
                        dim=1)
    m = torch.randint(0, K_MODELS, (B,), generator=gen, device=dev,
                      dtype=torch.int32)
    theta[m == 0, 1] = 0.0
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    return theta.contiguous(), m, valid


def k18_mode_checks(dev) -> dict:
    """K18's adaptive mode (nseg bit-equal to the plain version's) at
    config 3's round (B 65536) under non-uniform weights; its K > 1 mode
    over two birth-death models (bit-exact) and over the segmented family
    at the zoo's round (B 32768): without noise bit-exact, with the
    family's noise (normals differ in the last bits) the same kept slots
    but for a few at the threshold, their statistics within 1e-5, and the
    kept rows bit-equal to the classic range kernel's; the family's range
    kernel: chained segments bit-equal to the full trajectory, and
    against its plain version. Timed against the classic round."""
    from dataclasses import replace

    import torch

    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import (ode_family_segments,
                                         ode_family_segments_plain, philox,
                                         segment_round, segment_round_plain,
                                         tau_leap)
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.models import model_selection as msel
    from pyabc_tpu_torch.ops.segment import spec_protocol
    from pyabc_tpu_torch.utils import pick_batch

    out = {}

    def ctr():
        return torch.zeros(4, dtype=torch.int64, device=dev)

    # adaptive mode, birth-death at config 3's round
    B = pick_batch(C3_POP)
    model = g.make_birth_death_model(segments=C3_SEGS)
    x = seg_inputs(dev, model, g.birth_death_prior(),
                   g.observed_birth_death(segments=C3_SEGS), B, seed=6)
    S = x["spec"].total_size
    w = torch.linspace(0.4, 1.6, S, device=dev)
    full = tau_leap(model.chain.kernel[1], x["theta"], x["stream"],
                    colmap=x["imap"], width=S)[0]
    d = (w * (full - x["x0"])).square().sum(1).sqrt()
    kw = dict(imap=x["imap"], x0=x["x0"], w=w, p=2.0,
              eps=torch.quantile(d[x["valid"]], 0.05), width=S)
    c_got, c_ref = ctr(), ctr()
    ss, keep, nseg = segment_round(model.segmented, x["theta"], x["valid"],
                                   x["stream"], seg_ctr=c_got,
                                   return_nseg=True, **kw)
    t0 = time.perf_counter()
    ss_r, keep_r, nseg_r = segment_round_plain(
        model.segmented, x["theta"], x["valid"], x["stream"], seg_ctr=c_ref,
        return_nseg=True, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hist = torch.bincount(nseg.long(), minlength=C3_SEGS + 1)[1:].tolist()
    same = (torch.equal(nseg, nseg_r) and torch.equal(keep, keep_r)
            and equal_nan(ss[keep], ss_r[keep])
            and torch.equal(c_got[:3], c_ref[:3]))
    kb = keep & keep_r
    ad_err = max(abs_err(ss[kb], ss_r[kb]), abs_err(nseg, nseg_r),
                 abs_err(keep, keep_r))
    ad_flips = int((keep ^ keep_r).sum())
    log(f"K18 adaptive mode (birth-death, B={B}, {C3_SEGS} segments): "
        f"slots by segments simulated {hist}; nseg, kept slots, their "
        f"statistics and counters bit-identical to the plain version {same}"
        f", max_abs_err={ad_err:.3e}")
    check(same, "K18 adaptive mode differs from its plain version")
    sc = ctr()

    def run_ad(ret=True):
        return segment_round(model.segmented, x["theta"], x["valid"],
                             x["stream"], seg_ctr=sc, return_nseg=ret, **kw)

    ms_ad = graph_ms(run_ad, iters=10, replays=3)
    ms_plain_mode = graph_ms(lambda: run_ad(False), iters=10, replays=3)
    spec = model.chain.kernel[1]
    out["segment_round_adaptive"] = dict(
        err=ad_err, keep_flips=ad_flips, call_ms=time_ms(run_ad, 10),
        ms=ms_ad, plain_ms=plain_ms,
        bound=bound(B * (2 * 4 + 1 + S * 4 + 1 + 4),
                    int(c_got[1]) * spec.leaps_per_seg * spec.n_rates
                    * OPS_PER_DRAW),
        library_ms=None, ms_without_nseg=ms_plain_mode)
    log(f"K18 adaptive mode device ms {ms_ad:.4f} (the same round without "
        f"nseg {ms_plain_mode:.4f})")

    # K > 1 mode: two birth-death models (initial counts 40 and 25)
    pair = [model, g.make_birth_death_model(x0=25.0, segments=C3_SEGS)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    m2 = torch.randint(0, 2, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    full2 = torch.where((m2 == 0)[:, None], *[
        tau_leap(mo.chain.kernel[1], x["theta"], x["stream"],
                 colmap=x["imap"], width=S)[0] for mo in pair])
    d2 = (full2 - x["x0"]).square().sum(1).sqrt()
    kw2 = dict(imap=x["imap"], x0=x["x0"], w=torch.ones(S, device=dev),
               p=2.0, eps=torch.quantile(d2[x["valid"]], 0.05), width=S,
               m=m2, dims=[2, 2])
    segs2 = [mo.segmented for mo in pair]
    c2, c2r = ctr(), ctr()
    ss2, keep2 = segment_round(segs2, x["theta"], x["valid"], x["stream"],
                               seg_ctr=c2, **kw2)
    ss2r, keep2r = segment_round_plain(segs2, x["theta"], x["valid"],
                                       x["stream"], seg_ctr=c2r, **kw2)
    same2 = (torch.equal(keep2, keep2r) and equal_nan(ss2[keep2],
                                                      ss2r[keep2])
             and equal_nan(ss2[keep2], full2[keep2])
             and torch.equal(c2[:3], c2r[:3]))
    log(f"K18 K > 1 mode, two birth-death models (B={B}): retired "
        f"{int(c2[0])}, occupancy {int(c2[1]) / max(int(c2[3]), 1):.4f}; "
        f"bit-identical to the plain version and the classic rows {same2}")
    check(same2 and int(c2[0]) > 0,
          "K18 K > 1 mode (birth-death pair) differs from its plain version")
    kb2 = keep2 & keep2r
    # K > 1 mode's error: the largest over the pair and both family passes,
    # over the slots both versions keep; the flips beside it
    kgt1_err = abs_err(ss2[kb2], ss2r[kb2])
    kgt1_flips = int((keep2 ^ keep2r).sum())

    # K > 1 mode: the segmented ODE family at the zoo's round
    Bf = pick_batch(ZMS_POP)
    fam = msel.ode_family(segments=ZMS_SEGS)[0]
    specs = fam[0].family.specs
    theta, m, valid = family_round(dev, Bf)
    st = stream_on(dev, philox.SIM_NOISE)
    imap = fam[0].index_map(SumStatSpec({"y": [0.0] * 12}), dev)
    fam_err, fam_flips = 0.0, 0
    for noise_sd in (0.0, 0.3):
        sp = [replace(s, noise_sd=noise_sd) for s in specs]
        segs = [spec_protocol(s, (("y", s.obs_per_seg),),
                              ode_family_segments) for s in sp]
        full_f, y_end = ode_family_segments(sp, theta, st, m=m,
                                            return_state=True)
        head, y2 = ode_family_segments(sp, theta, st, m=m, seg_to=2,
                                       return_state=True)
        tail, y3 = ode_family_segments(sp, theta, st, m=m, state=y2,
                                       seg_from=2, return_state=True)
        ref_f, _ = ode_family_segments_plain(sp, theta, st, m=m)
        chained = (torch.equal(torch.cat([head, tail], dim=1), full_f)
                   and torch.equal(y3, y_end))
        x0f = full_f[1].clone()
        df = (full_f - x0f).square().sum(1).sqrt()
        kwf = dict(imap=imap, x0=x0f, w=torch.ones(12, device=dev), p=2.0,
                   eps=torch.quantile(df[valid], 0.1), width=12, m=m,
                   dims=[1, 2, 2])
        cf, cfr = ctr(), ctr()
        ssf, keepf = segment_round(segs, theta, valid, st, seg_ctr=cf,
                                   **kwf)
        ssfr, keepfr = segment_round_plain(segs, theta, valid, st,
                                           seg_ctr=cfr, **kwf)
        classic = torch.equal(ssf[keepf], full_f[keepf])
        both = keepf & keepfr
        flips = int((keepf ^ keepfr).sum())
        kgt1_err = max(kgt1_err, abs_err(ssf[both], ssfr[both]))
        kgt1_flips += flips
        if noise_sd == 0.0:
            ok = (torch.equal(full_f, ref_f) and torch.equal(keepf, keepfr)
                  and torch.equal(ssf[keepf], ssfr[keepf])
                  and torch.equal(cf[:3], cfr[:3]))
        else:
            ok = (within(full_f, ref_f, 1e-5, 1e-5) and flips <= 4
                  and within(ssf[both], ssfr[both], 1e-5, 1e-5))
            fam_err = float((full_f - ref_f).abs().max())
            fam_flips = flips
        log(f"K18 K > 1 mode, ODE family (B={Bf}, {ZMS_SEGS} segments, "
            f"noise sd {noise_sd}): retired {int(cf[0])}, occupancy "
            f"{int(cf[1]) / max(int(cf[3]), 1):.4f}, kept {int(keepf.sum())}"
            f", kept slots differing from the plain version {flips}, "
            f"max_abs_err over the slots both keep "
            f"{abs_err(ssf[both], ssfr[both]):.3e}; kept "
            f"rows equal to the classic range kernel's {classic}; range "
            f"kernel chained = full {chained}; against the plain version "
            f"{ok}")
        check(ok and classic and chained and int(cf[0]) > 0,
              f"K18 K > 1 mode or the family's range kernel (noise sd "
              f"{noise_sd}) differs from its plain version")
    sf = ctr()

    def run_fam():
        return segment_round(segs, theta, valid, st, seg_ctr=sf, **kwf)

    def run_range():
        return ode_family_segments(sp, theta, st, m=m)

    steps = int(cf[1])
    per_seg = sp[0].obs_per_seg * (sp[0].n_substeps * OPS_RK4_FAMILY
                                   + OPS_NORMAL)
    ms_fam = graph_ms(run_fam, iters=20, replays=3)
    out["segment_round_models"] = dict(
        err=kgt1_err, keep_flips=kgt1_flips, call_ms=time_ms(run_fam, 20),
        ms=ms_fam,
        plain_ms=time_ms(lambda: segment_round_plain(
            segs, theta, valid, st, seg_ctr=ctr(), **kwf), 3),
        bound=bound(Bf * (2 * 4 + 4 + 1 + 12 * 4 + 1), steps * per_seg),
        library_ms=None, occupancy=int(cf[1]) / max(int(cf[3]), 1))
    ms_range = graph_ms(run_range, iters=20, replays=3)
    out["ode_family_segments"] = dict(
        err=fam_err, call_ms=time_ms(run_range, 20), ms=ms_range,
        plain_ms=time_ms(lambda: ode_family_segments_plain(sp, theta, st,
                                                           m=m), 3),
        bound=bound(Bf * (2 * 4 + 4 + 12 * 4), Bf * ZMS_SEGS * per_seg),
        library_ms=None, noisy_keep_flips=fam_flips)
    log(f"K18 K > 1 device ms per family round (B={Bf}): early reject "
        f"{ms_fam:.4f}, the classic range kernel {ms_range:.4f}")
    return out


def config3_adaptive(where, early, pop: int | None = None,
                     gens_g: int = C3_G, seed: int = C3_SEED):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.distance.scale import standard_deviation
    from pyabc_tpu_torch.models import gillespie as g

    abc = pt.ABCSMC(g.make_birth_death_model(segments=C3_SEGS),
                    g.birth_death_prior(),
                    pt.AdaptivePNormDistance(
                        p=2, scale_function=standard_deviation),
                    population_size=pop or C3_POP, eps=pt.MedianEpsilon(),
                    seed=seed, early_reject=early, fused_generations=gens_g,
                    device=where)
    abc.new("sqlite://", g.observed_birth_death(segments=C3_SEGS),
            store_sum_stats=False)
    return abc


def post_means(h, cols=("log_b", "log_d")) -> list[float]:
    import numpy as np

    df, w = h.get_distribution(m=0, t=h.max_t)
    return [float(np.sum(df[c] * w)) for c in cols]


def sync_check(abc, label: str) -> None:
    """One counter read per proposal round (the calibration's too) and
    one packed fetch per chunk: nothing else read the device."""
    syncs = abc.sync_ledger.summary()
    rounds = sum(g["rounds"] for g in abc.generation_log)
    chunks = len({g["chunk_index"] for g in abc.generation_log})
    by = syncs["by_kind"]
    cal = by.get("round_counters", 0) - rounds
    check(set(by) == {"round_counters", "chunk_fetch"}
          and by["chunk_fetch"] == chunks and 0 <= cal <= 2,
          f"{label}: a host read besides the round counters and the "
          f"chunk fetches ({by}, {rounds} rounds, {chunks} chunks)")


def adaptive_run(dev) -> dict:
    """Config 3's shape under the adaptive distance on the card, early
    reject on, off, off, on, the counts reset just before the first and
    read after each: wall, particles/s, syncs per generation (the counter
    reads and the chunk fetches only), retired candidates and work saved,
    the weights trail (a refit every generation), the posterior means on
    and off -> the launch counts of the four runs."""
    import numpy as np

    from pyabc_tpu_torch.kernels import reset_launch_counts

    label = (f"adaptive config 3 (birth-death, {C3_SEGS} segments, "
             f"AdaptivePNormDistance(standard_deviation))")
    reset_launch_counts()
    runs = []
    for early in TURNS:
        abc = config3_adaptive(dev, early)
        h, wall, counts = seg_run(abc, C3A_GENS, label)
        runs.append((early, abc, h, wall, counts))
    counts = {k: sum(r[4][k] for r in runs) for k in runs[0][4]}
    for early, abc, h, wall, c in runs:
        tag = "on" if early == "auto" else "off"
        n = h.max_t + 1
        syncs = abc.sync_ledger.summary()
        split = wall_split(abc)
        log(f"{label} early reject {tag}: pop={C3_POP} gens={n} wall_s="
            f"{wall:.3f} accepted_particles_per_s={C3_POP * n / wall:.1f} "
            f"syncs_per_generation={syncs['syncs'] / n:.2f} rounds "
            f"{[g['rounds'] for g in abc.generation_log]} "
            f"{syncs['by_kind']}; host seconds, rounds + steps "
            f"{split['compute_s']:.3f}, fetch {split['fetch_s']:.3f}, "
            f"History wait {split['persist_s']:.3f}, writer "
            f"{split['write_s']:.3f}, final flush {split['flush_s']:.3f}; "
            f"posterior means "
            f"(log_b, log_d) {[round(v, 4) for v in post_means(h)]}")
        sync_check(abc, f"{label} ({tag})")
        check(n == C3A_GENS, f"{label} ({tag}) ran {n} of {C3A_GENS} "
              f"generations")
    (_e, a_on, h_on, _w, c_on), (_e2, _a_off, h_off, _w2, _c_off) = runs[:2]
    tot = seg_totals(h_on)
    saved = 1.0 - tot["seg_steps"] / max(tot["seg_resolved"] * C3_SEGS, 1)
    w = a_on.distance_function.weights
    trail = [[round(float(v), 4) for v in w[t][:3]] + [
        round(float(w[t].max() / w[t].min()), 3)] for t in sorted(w)]
    refit = all(not np.allclose(w[t], w[t - 1]) for t in range(1, C3A_GENS))
    eps = [round(float(e), 4) for e in h_on.get_all_populations()[
        "epsilon"][1:]]
    mean_on = np.mean([post_means(r[2]) for r in runs if r[0]], axis=0)
    mean_off = np.mean([post_means(r[2]) for r in runs if not r[0]], axis=0)
    log(f"{label}: retired_early {tot['retired_early']}, seg_steps "
        f"{tot['seg_steps']}, seg_resolved {tot['seg_resolved']}, "
        f"sim_work_saved_frac {saved:.4f}, occupancy {tot['occupancy']}; "
        f"eps trail (on) {eps}")
    log(f"{label}: weights trail (on; w[0:3] and max / min per generation, "
        f"calibration first) {trail}; refit every generation {refit}")
    log(f"{label}: posterior means on {np.round(mean_on, 4).tolist()} off "
        f"{np.round(mean_off, 4).tolist()} (the two runs each); gap "
        f"{float(np.abs(mean_on - mean_off).max()):.4f}")
    log(f"{label}: kernel launches on {c_on}")
    check(tot["retired_early"] > 0, f"{label}: no candidate retired")
    check(refit, f"{label}: a generation kept the last weights")
    check(all(counts[k] > 0 for k in ADAPTIVE_PATH)
          and counts["segment_round:adaptive"] > 0,
          f"{label}: a kernel of the path never launched")
    # the fold (and K18's nseg) only for rounds that start below rec_cap:
    # each generation's first round at least
    check(c_on["segment_round:adaptive"] == c_on["moment_fold"]
          and C3A_GENS <= c_on["moment_fold"] <= c_on["segment_round"]
          and c_on["moment_finish"] == C3A_GENS,
          f"{label}: K18's adaptive mode and the fold launched apart, a "
          f"generation folded no round, or the finish missed one")
    check(all(math.isfinite(v) for v in list(mean_on) + list(mean_off)),
          f"{label}: non-finite posterior means")
    return counts


def bench_adaptive_leg(dev) -> None:
    """bench.py's own adaptive leg (pop 128, 5 generations, G 2, seed 17)
    on and off: the posterior-mean gap against the bench's parity rule."""
    import numpy as np

    means, retired = {}, 0
    for early in ("auto", False):
        abc = config3_adaptive(dev, early, pop=BA_POP, gens_g=BA_G,
                               seed=BA_SEED)
        h, _wall, _c = seg_run(abc, BA_GENS, "bench adaptive leg")
        means[early] = np.asarray(post_means(h))
        if early:
            retired = seg_totals(h)["retired_early"]
    gap = float(np.abs(means["auto"] - means[False]).max())
    log(f"bench adaptive leg (pop {BA_POP}, {BA_GENS} generations, seed "
        f"{BA_SEED}): posterior means on {np.round(means['auto'], 4)} off "
        f"{np.round(means[False], 4)}, gap {gap:.4f} (the bench's "
        f"parity_ok: < {BA_PARITY}: {gap < BA_PARITY}); retired_early "
        f"{retired}")
    check(retired > 0 and math.isfinite(gap),
          "bench adaptive leg: nothing retired or a non-finite mean")


def zoo_model_selection(where, early):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _ts = msel.ode_family(segments=ZMS_SEGS)
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=ZMS_POP, eps=pt.MedianEpsilon(),
                    seed=ZMS_SEED, early_reject=early,
                    fused_generations=ZMS_GENS, device=where)
    abc.new("sqlite://", msel.observed_ode_family(seed=0,
                                                  segments=ZMS_SEGS),
            store_sum_stats=False)
    return abc


def zoo_model_selection_run(dev) -> dict:
    """The zoo's model-selection leg on the card, on, off, off, on, the
    counts reset just before: populations, weights, models and the epsilon
    trail bit-identical on and off, model probabilities summing to 1,
    retired candidates, occupancy, timings -> the launch counts."""
    import numpy as np

    from pyabc_tpu_torch.kernels import reset_launch_counts

    label = f"zoo model selection (ODE family, {ZMS_SEGS} segments)"
    reset_launch_counts()
    hs, walls, cs = [], [], []
    for early in TURNS:
        abc = zoo_model_selection(dev, early)
        h, wall, c = seg_run(abc, ZMS_GENS, label)
        sync_check(abc, label)
        hs.append(h)
        walls.append(wall)
        cs.append(c)
    counts = {k: sum(c[k] for c in cs) for k in cs[0]}
    same = all(populations_identical(hs[0], h, K_MODELS)
               for h in hs[1:])
    tot = seg_totals(hs[0])
    pps = [ZMS_POP * (h.max_t + 1) / w for h, w in zip(hs, walls)]
    probs = hs[0].get_model_probabilities().to_numpy()
    log(f"{label}: pop={ZMS_POP} gens={hs[0].max_t + 1} "
        f"accepted_particles_per_s on {pps[0]:.1f}, {pps[3]:.1f} off "
        f"{pps[1]:.1f}, {pps[2]:.1f} (in turns: on, off, off, on); wall_s "
        f"{[round(w, 3) for w in walls]}; bit-identical {same}; "
        f"retired_early {tot['retired_early']}, occupancy "
        f"{tot['occupancy']}, seg_steps {tot['seg_steps']} of "
        f"{tot['seg_resolved'] * ZMS_SEGS}")
    eps = hs[0].get_all_populations()["epsilon"][1:]
    log(f"{label}: model probabilities per generation "
        f"{np.round(probs, 4).tolist()}; eps trail "
        f"{[round(float(e), 4) for e in eps]}")
    log(f"{label}: kernel launches on {cs[0]}")
    check(same and hs[0].max_t + 1 == ZMS_GENS,
          f"{label}: populations differ with early reject on and off")
    check(tot["retired_early"] > 0, f"{label}: no candidate retired")
    check(abs(float(probs[-1].sum()) - 1.0) < 1e-9,
          f"{label}: model probabilities do not sum to 1")
    check(all(counts[k] > 0 for k in ZMS_PATH)
          and cs[0]["segment_round:k_gt_1"] == cs[0]["segment_round"] > 0
          and cs[1]["segment_round"] == 0
          and counts["ode_family_simulate"] == 0,
          f"{label}: a kernel of the path never launched, or K18 ran "
          f"outside its K > 1 mode")
    return counts


# -------------------------------------------- LocalTransition, the scale lane
#: bench.py's scale lane (bench.py:270-330, pyabc_tpu/utils/
#: bench_defaults.py:37-38): Lotka-Volterra, AdaptivePNormDistance(p=2),
#: MedianEpsilon, LocalTransition(k_fraction=0.25), pop 16384 (n_cap 16384,
#: B 65536, k_cap 4096, threshold selection at stride 4, the refit cadence
#: auto (16, 0.3)), 12 generations, G 8, seed 101, observed_data(seed=123)
SCALE_POP, SCALE_GENS, SCALE_G, SCALE_SEED = 16384, 12, 8, 101
#: the kernels LocalTransition brought, and the scale lane's path
LOCAL_KERNELS = ("local_cov", "local_factor", "propose_local",
                 "local_logpdf", "proposal_drift")
SCALE_PATH = ("propose", "lv_simulate", "pnorm_accept_weight",
              "compact_round", "normalize_quantile", "scale_reduce",
              "pack_fetch", "generation_health") + LOCAL_KERNELS
#: the scale lane's lanes a round
SCALE_B = 65536


def row_err(a, b) -> float:
    """Largest |a - b| of each row over the row's largest |b|."""
    n = a.shape[0]
    scale = b.abs().reshape(n, -1).amax(dim=1).clamp_min(1e-30)
    return float(((a - b).abs().reshape(n, -1).amax(dim=1) / scale).max())


def local_population(dev, n: int, d: int, n_valid: int, seed: int = 0):
    """n LV prior draws (d 4; other d: standard normals) and positive
    weights on the first n_valid rows."""
    import torch

    from pyabc_tpu_torch.models import lotka_volterra as lv

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = (lv.default_prior().rvs_array(n, g, dev) if d == 4
         else torch.randn(n, d, generator=g, device=dev))
    w = torch.rand(n, generator=g, device=dev) + 0.1
    w[n_valid:] = 0.0
    return X.contiguous(), (w / w.sum()).contiguous()


def k12_case(dev, label, n, d, dim, n_valid, kw, timed):
    """K12 against its plain version: neighbours and counts bit-equal,
    covariances within 1e-4 of each row's largest entry."""
    import torch

    from pyabc_tpu_torch.kernels import local_cov, local_cov_plain
    from pyabc_tpu_torch.kernels.local_cov import field_plan
    from pyabc_tpu_torch.transition import LocalTransition

    X, w = local_population(dev, n, d, n_valid, seed=n + d)
    cfg = LocalTransition.field_config(n, dim, scaling=1.0, device=dev, **kw)
    got = local_cov(X, w, want_idx=True, **cfg)
    t0 = time.perf_counter()
    ref = local_cov_plain(X, w, want_idx=True, **cfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = (torch.equal(got["cnt"], ref["cnt"])
            and torch.equal(got["idx"], ref["idx"])
            and torch.equal(got["thetas"], ref["thetas"]))
    err = row_err(got["covs"], ref["covs"])
    err_abs = float((got["covs"] - ref["covs"]).abs().max())
    cnt = ref["cnt"].to(torch.int64)
    mode = "top-k" if cfg["topk"] else f"threshold stride {cfg['stride']}"
    plan = field_plan(n, d, topk=cfg["topk"], stride=cfg["stride"],
                      k_cap=cfg["k_cap"])
    log(f"K12 local_cov {label} (n_cap={n}, d={d}, dim={dim}, {n_valid} "
        f"valid, k_cap={cfg['k_cap']}, {mode}, "
        f"{'diff' if cfg['dense'] else 'norm'} form; {plan_text(plan)}): "
        f"neighbours and counts equal {same}; counts {int(cnt.min())}-"
        f"{int(cnt.max())}; covariance error {err:.3e} of the row scale "
        f"({err_abs:.3e} abs)")
    check(same, f"K12 {label}: the selection differs from the plain "
          f"version")
    check(err <= 1e-4 and within(got["weights"], ref["weights"], 0.0, 1e-6)
          and within(got["cdf"], ref["cdf"], 1e-6, 1e-5),
          f"K12 {label}: covariances, weights or cdf outside tolerance")
    if not timed:
        return None
    sel = float(cnt.sum())
    nbytes = (n * (d + 1) + n * (d + 2 + d * d) + n) * 4 + (n + 1) * 4
    ops, old_ops = k12_ops(n, d, cfg, sel)
    res = dict(err=err_abs, plain_ms=plain_s * 1e3,
               call_ms=time_ms(lambda: local_cov(X, w, **cfg), 5, 1),
               ms=graph_ms(lambda: local_cov(X, w, **cfg), 5, 3),
               bound=bound(nbytes, ops), library_ms=None,
               old_bound=bound(nbytes, old_ops), field=(X, w, cfg))
    log(f"K12 local_cov {label}: ms={res['ms']:.5f} bound_ms="
        f"{res['bound'][0]:.6f} ({res['bound'][1]}; the block-a-row "
        f"design's bound, its 26 or 32 counting passes counted, "
        f"{res['old_bound'][0]:.6f})")
    return res


def k12_ops(n: int, d: int, cfg: dict, sel: float) -> tuple[float, float]:
    """K12's operations on n rows: (the work any implementation does: each
    row's m distances of 3 d operations, one comparison a candidate for
    the selection, 3 d^2 a selected neighbour for the covariance; the
    same with the block-a-row design's 26 or 32 counting passes a
    candidate, the bound of the block-a-row design it replaced)."""
    m = n if cfg["topk"] else -(-n // cfg["stride"])
    passes = 32 if cfg["topk"] else 26
    cov = sel * 3 * d * d
    return (n * m * (3 * d + 1) + cov,
            n * (m * (3 * d + passes + 2)) + cov)


def plan_text(plan: dict) -> str:
    """K12's launch plan as a log reads it."""
    return (f"W={plan['warps']} rows a block, a ring of {plan['tc']}-"
            f"candidate tiles, {plan['smem']} bytes of shared memory")


def k12_checks(dev) -> dict:
    """K12 with top-k at n_cap 1024 (k 256), with threshold at the scale
    lane's width (n_cap 16384, k_cap 4096, stride 4), at a small odd shape
    (n_cap 64, 37 valid rows, d 1) and with threshold at stride 1."""
    k12_case(dev, "top-k", 1024, 4, 4, 1000, dict(k_cap=256), False)
    res = k12_case(dev, "scale lane", SCALE_POP, 4, 4, SCALE_POP,
                   dict(k_cap=4096), True)
    k12_case(dev, "small odd", 64, 1, 1, 37, dict(k_cap=16), False)
    k12_case(dev, "threshold stride 1", 2048, 3, 2, 2000,
             dict(k_cap=512, selection="threshold"), False)
    return res


def k13_checks(dev, field) -> dict:
    """K13 over every row and incrementally with about a tenth of the rows
    changed and one rank-1 row on the jitter ladder: n_changed equal,
    factors within float32 tolerance."""
    import torch

    from pyabc_tpu_torch.kernels import local_cov, local_factor
    from pyabc_tpu_torch.kernels.local_factor import local_factor_plain

    X, w, cfg = field
    n, d = X.shape
    f0 = local_cov(X, w, **cfg)
    prev, _n = local_factor(f0, None, dim=d, incremental=False)
    # a tenth of the rows' covariances move (at k = n / 4 every moved
    # particle is a neighbour of a quarter of the rows, so the field is
    # perturbed directly), one of them to rank 1, on the jitter ladder
    f1 = {**f0, "covs": f0["covs"].clone()}
    f1["covs"][: n // 10] *= 1.01
    v = torch.tensor([1.0, 2.0, -1.0, 0.5], device=dev)
    f1["covs"][7] = v[:, None] * v[None, :]
    out = {}
    for inc in (False, True):
        got, n_got = local_factor(f1, prev, dim=d, incremental=inc)
        t0 = time.perf_counter()
        ref, n_ref = local_factor_plain(f1, prev, dim=d, incremental=inc)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        ok = torch.arange(n, device=dev) != 7
        errs = {k: float((got[k] - ref[k]).abs().nan_to_num(0.0).max())
                for k in ("chols", "logdets", "lconst")}
        prec_err = row_err(got["precs"][ok], ref["precs"][ok])
        log(f"K13 local_factor ({'incremental' if inc else 'every row'}, "
            f"n={n}, d={d}): rows changed {int(n_got)} (plain "
            f"{int(n_ref)}); abs errors {errs}; precision error "
            f"{prec_err:.3e} of the row scale (the rank-1 row apart)")
        check(int(n_got) == int(n_ref) == (n // 10 if inc else n),
              "K13 n_changed differs from the plain version or from the "
              "rows changed")
        check(within(got["chols"], ref["chols"], 1e-5, 1e-4)
              and prec_err <= 1e-3
              and within(got["logdets"], ref["logdets"], 1e-3, 1e-4)
              and bool(torch.isfinite(got["chols"][7]).all()),
              "K13 factors outside tolerance")
        out[inc] = (n_got, plain_s, max(errs.values()))
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    kept, n0 = local_factor(local_cov(X, w, flag=flag, **cfg), prev,
                            dim=d, incremental=True, flag=flag)
    check(int(n0) == 0 and all(torch.equal(kept[k], prev[k]) for k in
                               ("thetas", "chols", "precs", "lconst")),
          "K13 with the flag at 0 did not carry the params forward")
    covs = f0["covs"]

    def full():
        return local_factor(f0, None, dim=d, incremental=False)

    nbytes = n * (d * d + 1 + 2 * d * d + 2) * 4
    return dict(err=out[False][2], plain_ms=out[False][1] * 1e3,
                call_ms=time_ms(full, 20), ms=graph_ms(full, 20, 3),
                bound=bound(nbytes, n * 4 * d ** 3),
                library_ms=time_ms(lambda: torch.linalg.cholesky_ex(covs),
                                   20),
                n_changed_incremental=int(out[True][0]))


def k14_checks(dev, field) -> dict:
    """K2's local mode at B 65536 and K14's density at 65536 x 16384 (d 4)
    against their plain versions, on a fit of the scale lane's width."""
    import torch

    from pyabc_tpu_torch.kernels import (local_logpdf, local_logpdf_plain,
                                         philox, propose_local,
                                         propose_local_plain)
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.transition import LocalTransition

    X, w, cfg = field
    n, d = X.shape
    params = LocalTransition.device_fit(
        X, w, dim=d, **{k: cfg[k] for k in ("scaling", "k_cap")},
        selection="threshold", k_table=cfg["k_table"])
    prior = lv.default_prior().arrays(dev)
    st = stream_on(dev, philox.TRANSITION, gen=3, seed=5)
    th, lp, valid = propose_local(st, SCALE_B, prior, params)
    t0 = time.perf_counter()
    th_r, lp_r, valid_r = propose_local_plain(st, SCALE_B, prior, params)
    torch.cuda.synchronize()
    draw_plain_s = time.perf_counter() - t0
    draw_err = float((th - th_r).abs().max())
    check(torch.equal(valid, valid_r) and within(th, th_r, 1e-5, 1e-5)
          and within(lp[valid], lp_r[valid], 1e-5, 1e-5),
          "K2's local mode differs from its plain version")
    got = local_logpdf(th, params)
    t0 = time.perf_counter()
    ref = local_logpdf_plain(th, params)
    torch.cuda.synchronize()
    dens_plain_s = time.perf_counter() - t0
    dens_err = float((got - ref).abs().nan_to_num(0.0).max())
    log(f"K2 propose_local (B={SCALE_B}, n={n}, d={d}): theta error "
        f"{draw_err:.3e}, valid {int(valid.sum())}/{SCALE_B}; K14 "
        f"local_logpdf ({SCALE_B} x {n}): error {dens_err:.3e}, densities "
        f"{float(ref.min()):.2f} to {float(ref.max()):.2f}")
    check(within(got, ref, 1e-4, 1e-5), "K14 differs from its plain "
          "version beyond 1e-4 + 1e-5 relative")
    B = SCALE_B
    draw = dict(
        err=draw_err, plain_ms=draw_plain_s * 1e3,
        call_ms=time_ms(lambda: propose_local(st, B, prior, params), 20),
        ms=graph_ms(lambda: propose_local(st, B, prior, params), 20, 3),
        bound=bound(n * (1 + d + d * d) * 4 + B * (d + 2) * 4, B * 300),
        library_ms=None)
    thc = th.contiguous()
    dens = dict(
        err=dens_err, plain_ms=dens_plain_s * 1e3,
        call_ms=time_ms(lambda: local_logpdf(thc, params), 3, 1),
        ms=graph_ms(lambda: local_logpdf(thc, params), 3, 2),
        bound=bound((B * d + n * (d * d + d + 2) + B) * 4,
                    B * n * (3 * d + 2 * d * d + 4)),
        library_ms=None)
    return {"propose_local": draw, "local_logpdf": dens}


def k15_checks(dev, field) -> dict:
    """K15 on two populations of the scale lane's width: drift within 1e-4
    relative, the cadence's decisions equal."""
    import torch

    from pyabc_tpu_torch.kernels import proposal_drift, proposal_drift_plain

    X, w, _cfg = field
    n, d = X.shape
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    err, plain_s = 0.0, 0.0
    for scale, fitted, gens in ((1.0, True, 0), (1.2, True, 3),
                                (1.0, False, 0)):
        kw = dict(dim=d, fitted=torch.tensor(fitted, device=dev),
                  gens_since=torch.tensor(gens, dtype=torch.int32,
                                          device=dev),
                  every=16, thr=0.3, min_count=d + 1)
        Xn = (X * scale).contiguous()
        got = proposal_drift(X, w, Xn, w, mask, **kw)
        t0 = time.perf_counter()
        ref = proposal_drift_plain(X, w, Xn, w, mask, **kw)
        torch.cuda.synchronize()
        plain_s = max(plain_s, time.perf_counter() - t0)
        err = max(err, float((got["drift"] - ref["drift"]).abs()))
        check(within(got["drift"], ref["drift"], 1e-5, 1e-4)
              and all(torch.equal(got[k], ref[k]) for k in
                      ("refit", "flag", "gens_since", "fitted")),
              f"K15 differs from its plain version (scale {scale})")
    log(f"K15 proposal_drift (2 x {n} rows, d={d}): drift error {err:.3e}; "
        f"decisions equal")

    def run():
        return proposal_drift(X, w, Xn, w, mask, **kw)

    return dict(err=err, plain_ms=plain_s * 1e3, call_ms=time_ms(run, 50),
                ms=graph_ms(run), bound=bound(2 * n * (d + 1) * 4 + n,
                                              2 * n * (3 * d + 1)),
                library_ms=None)


def local_checks(dev) -> dict:
    """Phase 2 for K12-K15 and K2's local mode."""
    k12 = k12_checks(dev)
    field = k12.pop("field")
    out = {"local_cov": k12, "local_factor": k13_checks(dev, field)}
    out.update(k14_checks(dev, field))
    out["proposal_drift"] = k15_checks(dev, field)
    return out


def scale_lane(where, pop: int = SCALE_POP):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=pop,
                    eps=pt.MedianEpsilon(), seed=SCALE_SEED,
                    transitions=pt.LocalTransition(k_fraction=0.25),
                    fused_generations=SCALE_G, device=where)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    return abc


def scale_lane_run(dev):
    """The scale lane at full width with the plain versions set to raise,
    the counts reset just before and read just after -> (launch counts,
    epsilon trail)."""
    import numpy as np

    from pyabc_tpu_torch.kernels import reset_launch_counts
    from pyabc_tpu_torch.models import lotka_volterra as lv

    label = "scale lane (LV, LocalTransition)"
    abc = scale_lane(dev)
    reset_launch_counts()
    h, wall, counts = seg_run(abc, SCALE_GENS, label)
    n_gen = h.max_t + 1
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    chunks = len({g["chunk_index"] for g in abc.generation_log})
    split = wall_split(abc)
    wall_1, acc_1 = chunk_window(abc, SCALE_POP, 1, n_gen - 1)
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in lv.TRUE_PARS}
    ev = abc.refit_events
    log(f"{label}: pop={SCALE_POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={SCALE_POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} (rounds "
        f"{rounds}, {chunks} chunks, {syncs['by_kind']}); host seconds, "
        f"rounds + steps {split['compute_s']:.3f}, fetch "
        f"{split['fetch_s']:.3f}, History wait {split['persist_s']:.3f}, "
        f"writer {split['write_s']:.3f}, final flush "
        f"{split['flush_s']:.3f}; "
        f"chunks wholly in generations 1 on: {acc_1} accepted in "
        f"{wall_1:.3f} s")
    log(f"{label}: eps trail {[round(e, 4) for e in eps]}; acceptance "
        f"{[round(g['acceptance_rate'], 5) for g in abc.generation_log]}")
    log(f"{label}: refits {[t for t, r, _d, _c in ev if r]} of {len(ev)}; "
        f"rows changed {[c for _t, _r, _d, c in ev]}; drift "
        f"{[round(x, 4) for _t, _r, x, _c in ev]}")
    log(f"{label}: posterior means {means} true {lv.TRUE_PARS}")
    log(f"{label}: kernel launches {counts}")
    # one counter read per proposal round (the calibration's too) and one
    # packed fetch per chunk: the refit cadence adds no host read
    cal_rounds = syncs["by_kind"].get("round_counters", 0) - sum(rounds)
    check(n_gen == SCALE_GENS, f"the scale lane ran {n_gen} of "
          f"{SCALE_GENS} generations")
    check(syncs["syncs"] == sum(rounds) + cal_rounds + chunks
          and syncs["by_kind"].get("chunk_fetch", 0) == chunks,
          "the scale lane read the device outside its rounds and chunks")
    check(all(counts[k] > 0 for k in SCALE_PATH),
          "a kernel of the scale lane was never launched")
    check(all(counts[k] == 0 for k in ("mvn_mixture_logpdf", "mvn_fit")),
          "an MVN kernel ran on the LocalTransition path")
    check(len(ev) == n_gen and ev[0][1] and ev[0][3] == SCALE_POP,
          "the scale lane's first refit is missing or partial")
    check(all(math.isfinite(v) for v in means.values())
          and eps[-1] < 0.5 * eps[0], "the scale lane did not converge")
    return counts, eps


def scale_cpu_trail(dev) -> None:
    """The scale lane's seed at pop 1024 on the card and on the CPU (plain
    versions, the same Philox streams), 3 generations: the epsilons within
    1e-3 relative."""
    trails = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        h = scale_lane(where, pop=1024).run(max_nr_populations=3)
        trails[str(where)] = ([float(e) for e in
                               h.get_all_populations()["epsilon"][1:]],
                              time.perf_counter() - t0)
    card, cpu = trails[str(dev)][0], trails["cpu"][0]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    log(f"scale lane at pop 1024 (3 generations): card eps {card}, CPU eps "
        f"{cpu} ({trails['cpu'][1]:.1f} s); |card - cpu| / cpu "
        f"{[float(f'{r:.2e}') for r in rel]}")
    check(len(rel) == 3 and max(rel) <= 1e-3,
          "scale lane: the CPU's first three epsilons differ from the "
          "card's by more than 1e-3")


# ----------------------------------------- the noise models (K21c, K18)
#: K21c's family checks: (label, kernel factory of S); the independent
#: normal is K21a, checked above at config 4's shapes, and again here
NOISE_CASES = (
    ("independent_normal", lambda pt, S: pt.IndependentNormalKernel(
        var=4.0)),
    ("laplace", lambda pt, S: pt.IndependentLaplaceKernel(scale=2.0)),
    ("binomial", lambda pt, S: pt.BinomialKernel(p=0.9)),
    ("binomial-lin", lambda pt, S: pt.BinomialKernel(
        p=0.9, ret_scale="SCALE_LIN")),
    ("poisson", lambda pt, S: pt.PoissonKernel()),
    ("poisson-lin", lambda pt, S: pt.PoissonKernel(ret_scale="SCALE_LIN")),
    ("negbin_size", lambda pt, S: pt.NegativeBinomialKernel(p=0.5)),
    ("negbin_size-lin", lambda pt, S: pt.NegativeBinomialKernel(
        p=0.5, ret_scale="SCALE_LIN")),
    ("negbin_mean", lambda pt, S: pt.NegativeBinomialKernel(
        p=0.4, parameterization="mean")),
    ("normal", lambda pt, S: pt.NormalKernel(cov=decay_cov(S))),
    ("normal-lin", lambda pt, S: pt.NormalKernel(cov=decay_cov(S),
                                                 ret_scale="SCALE_LIN")),
)
#: config 3's round: B 65536 lanes, S 20 statistics
NOISE_B, NOISE_S = 65536, 20
#: operations an entry of each family takes (lgammaf, logf about 20-30
#: each); the full normal takes 2 S for its quadratic form
NOISE_OPS = {"independent_normal": 25, "laplace": 25, "binomial": 140,
             "poisson": 55, "negbin_size": 138, "negbin_mean": 140}


def decay_cov(S: int):
    import numpy as np

    i = np.arange(S)
    return 4.0 * 0.5 ** np.abs(i[:, None] - i[None, :])


def noise_inputs(dev, B: int, S: int, seed: int) -> dict:
    """Count-like rows around an observation (mostly at or above it, with
    zeros, tiny values, half-integers and a NaN among them)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x0 = torch.round(torch.rand(S, generator=g, device=dev) * 60.0)
    x0[0], x0[1] = 0.0, 2.5
    ss = x0 + (torch.randn(B, S, generator=g, device=dev) * 5.0).abs()
    ss[::97] = 0.0
    ss[1::97] = 1e-12
    ss[2::97, :3] = torch.tensor([0.5, 1.5, 2.5], device=dev)
    ss[3, 4] = math.nan
    return dict(ss=ss.contiguous(), x0=x0.contiguous(),
                valid=torch.rand(B, generator=g, device=dev) > 0.05,
                logpri=torch.randn(B, generator=g, device=dev),
                logq=torch.randn(B, generator=g, device=dev))


def noise_case(dev, label: str, make, x: dict, timed: bool) -> dict:
    """One family and scale: K21a/K21c against its plain version (v within
    rel 1e-5 with its -inf and NaN masks equal, the log weight within rel
    1e-5, the flags equal away from log u)."""
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import (kernel_accept, kernel_accept_plain,
                                         philox)
    from pyabc_tpu_torch.kernels.kernel_accept import accept_uniforms

    B, S = x["ss"].shape
    kern = make(pt, S)
    kern.initialize(SumStatSpec({"x": [0.0] * S}))
    lin = kern.ret_scale == "SCALE_LIN"
    params = kern.device_params(dev)
    args = (x["ss"], x["x0"], params)
    v0 = kernel_accept_plain(*args, torch.tensor(1.0, device=dev),
                             torch.tensor(0.0, device=dev), x["valid"],
                             stream=stream_on(dev, philox.ACCEPT), lin=lin,
                             apply_iw=True, family=kern.family)[0]
    logv = torch.log(v0.clamp_min(1e-30)) if lin else v0
    fin = torch.isfinite(logv)
    pdf_norm = torch.quantile(logv[fin].double(), 0.9).float()
    temp = torch.tensor(5.0, device=dev)
    stream = stream_on(dev, philox.ACCEPT)
    kw = dict(stream=stream, lin=lin, apply_iw=True, logpri=x["logpri"],
              logq=x["logq"], family=kern.family)
    full = (*args, temp, pdf_norm, x["valid"])
    v, a, lw = kernel_accept(*full, **kw)
    v_r, a_r, lw_r = kernel_accept_plain(*full, **kw)
    masks = (torch.equal(v.isnan(), v_r.isnan())
             and torch.equal(v.isneginf(), v_r.isneginf()))
    f = torch.isfinite(v_r)
    close = (torch.equal(f, torch.isfinite(v)) and bool(
        ((v - v_r).abs()[f] <= 1e-5 + 1e-5 * v_r.abs()[f]).all()))
    fw = torch.isfinite(lw_r)
    close_w = (torch.equal(fw, torch.isfinite(lw)) and bool(
        ((lw - lw_r).abs()[fw] <= 1e-5 + 1e-5 * lw_r.abs()[fw]).all()))
    ratio = ((torch.log(v_r.clamp_min(1e-30)) if lin else v_r)
             - pdf_norm) / temp
    logu = torch.log(accept_uniforms(stream, B))
    clear = ~((logu - ratio).abs() <= 1e-5 * (1 + ratio.abs()))
    flags = bool(torch.equal(a[clear], a_r[clear]))
    err = max(abs_err(v[f], v_r[f]), abs_err(lw[fw], lw_r[fw]))
    log(f"K21c kernel_accept {label} (B={B}, S={S}): max_abs_err={err:.3e} "
        f"(rel 1e-5 of v: {close}, -inf/NaN masks equal: {masks}, log "
        f"weights {close_w}, flags equal away from log u: {flags}, "
        f"{int((a != a_r).sum())} apart); finite v {int(f.sum())}/{B}, "
        f"accepted {int(a.sum())}")
    check(masks and close and close_w and flags,
          f"K21c {label}: kernel and plain version disagree")
    if not timed:
        return {}
    fam = kern.family
    # read the rows, x0, params, flags, logpri and logq once; write v,
    # accept and the log weight; per entry the family's operations, per
    # lane one Philox block (~100 integer operations) and ~20 more
    nbytes = (B * S * 4 + S * 4 + params.numel() * 4 + B
              + 2 * B * 4 + B * (4 + 1 + 4))
    per_entry = 2 * S + 2 if fam == "normal" else NOISE_OPS[fam]
    return dict(
        err=err, call_ms=time_ms(lambda: kernel_accept(*full, **kw), 100),
        ms=graph_ms(lambda: kernel_accept(*full, **kw)),
        plain_ms=time_ms(lambda: kernel_accept_plain(*full, **kw), 10),
        bound=bound(nbytes, B * (S * per_entry + 120)), library_ms=None)


def k21c_checks(dev) -> dict:
    """Every noise family and scale against its plain version at config
    3's round (B 65536, S 20) and at a small odd shape (B 257, S 7); the
    log-scale form of each family timed -> results keyed
    "kernel_accept:<family>"."""
    x = noise_inputs(dev, NOISE_B, NOISE_S, seed=81)
    xs = noise_inputs(dev, 257, 7, seed=82)
    results = {}
    for label, make in NOISE_CASES:
        r = noise_case(dev, label, make, x, timed=not label.endswith("-lin"))
        noise_case(dev, label + " (small)", make, xs, timed=False)
        if r:
            results["kernel_accept:" + label] = r
    return results


def noisy_round(dev, kernel, B: int, seed: int, segments: int = 10,
                small: dict | None = None):
    """A prior round of the birth-death model for K18's stochastic mode,
    with the kernel initialized on its observation."""
    from pyabc_tpu_torch.models import gillespie as g

    kw = small or {}
    model = g.make_birth_death_model(segments=segments, **kw)
    obs = g.observed_birth_death(segments=segments, **kw)
    x = seg_inputs(dev, model, g.birth_death_prior(), obs, B, seed=seed)
    kernel.initialize(x["spec"])
    return model, x


def k18_stochastic_case(dev, model, kernel, x, temp, pdf_norm, label: str,
                        ring: dict | None = None):
    """K18's stochastic mode and its plain version on one round, each
    followed by K21a/K21c (valid = keep) and K6's record mode with the
    ring mask into fresh buffers: kept slots, statistics, reservoir, ring
    and counters must be bit-identical -> K18's counters. With ``ring``,
    K6's ring-mask mode on the round is timed into it."""
    import torch

    from pyabc_tpu_torch.kernels import (compact_round, compact_round_plain,
                                         kernel_accept, philox,
                                         segment_round, segment_round_plain)

    B, S = x["theta"].shape[0], x["spec"].total_size
    params = kernel.device_params(dev)
    acc = dataclasses.replace(x["stream"], tag=philox.ACCEPT)
    kw = dict(imap=x["imap"], x0=x["x0"], w=params, p=2.0, eps=temp,
              width=S, noise=kernel.device_bound_fn(), pdf_norm=pdf_norm,
              accept=acc)
    outs = []
    for fn in (segment_round, segment_round_plain):
        ctr = torch.zeros(4, dtype=torch.int64, device=dev)
        ss, keep = fn(model.segmented, x["theta"], x["valid"], x["stream"],
                      seg_ctr=ctr, **kw)
        v, a, lw = kernel_accept(ss, x["x0"], params, temp, pdf_norm, keep,
                                 stream=acc, lin=False, apply_iw=True,
                                 family=kernel.family)
        d_th = x["theta"].shape[1]
        res = {"theta": torch.zeros(B, d_th, device=dev),
               "sumstats": torch.zeros(B, S, device=dev),
               "distance": torch.zeros(B, device=dev),
               "log_weight": torch.full((B,), -math.inf, device=dev),
               "slot": torch.full((B,), -1, dtype=torch.int32, device=dev)}
        rec = {"sumstats": torch.zeros(B, S, device=dev),
               "distance": torch.zeros(B, device=dev),
               "accepted": torch.zeros(B, dtype=torch.bool, device=dev),
               "valid": torch.zeros(B, dtype=torch.bool, device=dev),
               "theta": torch.zeros(B, d_th, device=dev),
               "logq": torch.zeros(B, device=dev)}
        counters = torch.zeros(4, dtype=torch.int32, device=dev)
        k6_args = (a, x["valid"], x["theta"], ss, v, lw, res, rec)
        compact_round(*k6_args, counters, logq=torch.zeros(B, device=dev),
                      ring_valid=keep)
        # the ring's rows of retired slots hold partial statistics: only
        # its completed rows are compared
        outs.append((ss, keep, ctr, res, rec, counters))
        if fn is segment_round:
            k6_card = (k6_args, keep)
    (ss, keep, ctr, res, rec, cnt), (ss_r, keep_r, ctr_r, res_r, rec_r,
                                     cnt_r) = outs
    torch.cuda.synchronize()
    done = rec["valid"]
    same = (torch.equal(keep, keep_r) and torch.equal(ss[keep], ss_r[keep])
            and torch.equal(ctr[:3], ctr_r[:3]) and torch.equal(cnt, cnt_r)
            and all(torch.equal(res[k], res_r[k]) for k in res)
            and torch.equal(done, rec_r["valid"])
            and all(torch.equal(rec[k][done], rec_r[k][done]) for k in rec))
    retired, steps, resolved, slots = (int(c) for c in ctr)
    n_seg = x["imap"].shape[0]
    log(f"K18 segment_round stochastic mode {label} ({kernel.family}, "
        f"B={B}, {n_seg} segments, {int(x['valid'].sum())} valid slots, "
        f"T={float(temp):.4g}, pdf_norm={float(pdf_norm):.4g}): retired "
        f"{retired}, segments stepped {steps} of {B * n_seg}, resolved "
        f"{resolved}, accepted {int(cnt[0])}, ring rows completed "
        f"{int(done.sum())}, occupancy {steps / max(slots, 1):.4f}; "
        f"bit-identical to the plain version {same}")
    check(same, f"K18 stochastic {label}: kept slots, statistics, "
          f"reservoir, ring or counters differ from the plain version")
    check(retired > 0 and resolved == B and 0 < steps <= slots,
          f"K18 stochastic {label}: counters out of range")
    if ring is not None:
        args, keep = k6_card
        logq = torch.zeros(B, device=dev)
        ctr_g = torch.zeros(4, dtype=torch.int32, device=dev)
        a, valid = args[0], args[1]
        n_res = min(int((a & valid).sum()), B)
        n_ring = int(valid.sum())
        d_th = x["theta"].shape[1]
        # the flags and the mask read once, each kept row's statistics,
        # distance, theta and weight, each ring row's logq; both written
        nbytes = (3 * B + n_res * (d_th + S + 3) * 4 * 2
                  + n_ring * ((S + 1 + d_th + 1) * 4 * 2 + 2) + 2 * 3 * 4)
        ring.update(
            ms=graph_ms(lambda: (ctr_g.zero_(), compact_round(
                *args, ctr_g, logq=logq, ring_valid=keep))),
            call_ms=time_ms(lambda: compact_round(
                *args, torch.zeros(4, dtype=torch.int32, device=dev),
                logq=logq, ring_valid=keep), 50),
            plain_ms=time_ms(lambda: compact_round_plain(
                *args, torch.zeros(4, dtype=torch.int32, device=dev),
                logq, ring_valid=keep), 10),
            bound=bound(nbytes, 0.0))
        log(f"K6 compact_round ring mask ({label}, B={B}, S={S}): "
            f"ms={ring['ms']:.5f} call_ms={ring['call_ms']:.5f} plain_ms="
            f"{ring['plain_ms']:.4f} bound_ms={ring['bound'][0]:.6f} "
            f"({ring['bound'][1]})")
    return ctr


def k18_stochastic_checks(dev, temp_late: float, norm_late: float) -> dict:
    """K18's stochastic mode against its plain version at the bench's
    config 3 round (B 131072, 10 segments, the independent normal of the
    noisy config 3 leg at a late generation's T and pdf norm), with the
    Poisson and Laplace bounds at B 65536 and at a small odd shape (B 256,
    5 segments, 37 live slots); its device time beside the p-norm mode's
    on the same round."""
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (kernel_accept, philox,
                                         segment_round, segment_round_plain)

    B = C3_BENCH_POP
    kern = pt.IndependentNormalKernel(var=4.0)
    model, x = noisy_round(dev, kern, B, seed=3)
    temp = torch.tensor(temp_late, dtype=torch.float32, device=dev)
    norm = torch.tensor(norm_late, dtype=torch.float32, device=dev)
    ring = {}
    ctr = k18_stochastic_case(dev, model, kern, x, temp, norm,
                              "noisy config 3 round", ring=ring)
    for label, k in (("poisson", pt.PoissonKernel()),
                     ("laplace", pt.IndependentLaplaceKernel(scale=2.0))):
        m2, x2 = noisy_round(dev, k, 65536, seed=5)
        v = kernel_accept(
            m2.simulate_flat(x2["theta"], None, x2["spec"],
                             stream=x2["stream"]),
            x2["x0"], k.device_params(dev),
            torch.tensor(math.inf, device=dev),
            torch.tensor(0.0, device=dev), x2["valid"],
            stream=dataclasses.replace(x2["stream"], tag=philox.ACCEPT),
            lin=False, apply_iw=True, family=k.family)[0]
        n2 = torch.quantile(v[torch.isfinite(v)].double(), 0.9).float()
        k18_stochastic_case(dev, m2, k, x2, torch.tensor(3.0, device=dev),
                            n2, f"{label} round")
    small = dict(n_leaps=100, n_obs=20)
    ks = pt.IndependentNormalKernel(var=4.0)
    ms_, xs = noisy_round(dev, ks, 256, seed=4, segments=5, small=small)
    gen = torch.Generator(device=dev)
    gen.manual_seed(37)
    live = torch.zeros(256, dtype=torch.bool, device=dev)
    live[torch.randperm(256, generator=gen, device=dev)[:37]] = True
    xs["valid"] = xs["valid"] & live
    k18_stochastic_case(dev, ms_, ks, xs, torch.tensor(2.0, device=dev),
                        torch.tensor(float(ks.pdf_max) - 40.0, device=dev),
                        "small odd shape")

    S = x["spec"].total_size
    params = kern.device_params(dev)
    acc = dataclasses.replace(x["stream"], tag=philox.ACCEPT)
    scratch = torch.zeros(4, dtype=torch.int64, device=dev)
    kw = dict(imap=x["imap"], x0=x["x0"], w=params, p=2.0, eps=temp,
              width=S, seg_ctr=scratch, noise=kern.device_bound_fn(),
              pdf_norm=norm, accept=acc)

    def noisy():
        return segment_round(model.segmented, x["theta"], x["valid"],
                             x["stream"], **kw)

    d = (model.simulate_flat(x["theta"], None, x["spec"], stream=x["stream"])
         - x["x0"]).square().sum(1).sqrt()
    eps_p = torch.quantile(d[x["valid"]], 0.02)
    w1 = torch.ones(S, device=dev)

    def pnorm():
        return segment_round(model.segmented, x["theta"], x["valid"],
                             x["stream"], imap=x["imap"], x0=x["x0"], w=w1,
                             p=2.0, eps=eps_p, width=S, seg_ctr=scratch)

    ms = graph_ms(noisy, iters=10, replays=3)
    ms_p = graph_ms(pnorm, iters=10, replays=3)
    ms_again = graph_ms(noisy, iters=10, replays=3)
    ctr_p = torch.zeros(4, dtype=torch.int64, device=dev)
    segment_round(model.segmented, x["theta"], x["valid"], x["stream"],
                  imap=x["imap"], x0=x["x0"], w=w1, p=2.0, eps=eps_p,
                  width=S, seg_ctr=ctr_p)
    log(f"K18 device ms per noisy config 3 round (B={B}): stochastic mode "
        f"{ms:.4f} / {ms_again:.4f} ({int(ctr[1])} segment steps); p-norm "
        f"mode on the same round {ms_p:.4f} ({int(ctr_p[1])} segment "
        f"steps, eps at the valid slots' 2 % distance quantile)")
    t0 = time.perf_counter()
    segment_round_plain(model.segmented, x["theta"], x["valid"],
                        x["stream"], **{**kw, "seg_ctr": torch.zeros(
                            4, dtype=torch.int64, device=dev)})
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    spec = model.chain.kernel[1]
    return dict(err=0.0, call_ms=time_ms(noisy, 10), ms=ms,
                plain_ms=plain_ms,
                bound=bound(B * (2 + S) * 4, int(ctr[1]) * spec.leaps_per_seg
                            * spec.n_rates * OPS_PER_DRAW),
                library_ms=None, ms_pnorm_mode=ms_p,
                k6_ring_mask={k: v for k, v in ring.items()})


#: the noisy config 3 legs (the JAX package's noisy early-reject test,
#: tests/test_segment.py:358-372, at config 3's shape): pop cut to 16384
#: as config 3's, 12 generations, chunks of 2, seed 7. The norm is
#: ScaledPDFNorm: under the default max-found norm it is the kernel's
#: pdf_max, some 100 log units above any simulation's log-density at S =
#: 20, and T = 1 accepts nothing
NC3_GENS, NC3_T0 = 12, 50.0
#: the kernels of the noisy config 3 path with early reject on (K18's
#: stochastic mode) and off (K19)
NC3_PATH = ("propose", "mvn_mixture_logpdf", "segment_round", "tau_leap",
            "kernel_accept", "compact_round", "normalize_quantile",
            "mvn_fit", "pack_fetch", "generation_health",
            "temperature_update")
#: K21a/K21c's rows: each family and the line of its JAX device_fn
K21C_LINES = (("independent_normal", 176), ("normal", 124),
              ("laplace", 254), ("binomial", 314), ("poisson", 370),
              ("negbin_size", 450), ("negbin_mean", 450))
#: the families of the unsegmented legs: pop 1000, 6 generations
FAM_POP, FAM_GENS, FAM_SEED = 1000, 6, 3


def poisson_observation():
    """The birth-death observation with Poisson noise (numpy, seed 0)."""
    import numpy as np

    from pyabc_tpu_torch.models import gillespie as g

    rng = np.random.default_rng(0)
    return {k: rng.poisson(np.maximum(np.asarray(v), 0.0)).astype(float)
            for k, v in g.observed_birth_death(segments=C3_SEGS).items()}


def noisy_config3(where, early, kind: str, pop: int | None = None):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gillespie as g

    if kind == "poisson":
        kern, obs = pt.PoissonKernel(), poisson_observation()
    else:
        kern = pt.IndependentNormalKernel(var=4.0)
        obs = g.observed_birth_death(segments=C3_SEGS)
    abc = pt.ABCSMC(
        g.make_birth_death_model(segments=C3_SEGS), g.birth_death_prior(),
        kern, population_size=pop or C3_POP,
        eps=pt.Temperature(schemes=[pt.ExpDecayFixedIterScheme()],
                           initial_temperature=NC3_T0),
        acceptor=pt.StochasticAcceptor(pdf_norm_method=pt.ScaledPDFNorm()),
        seed=C3_SEED, early_reject=early, fused_generations=C3_G,
        device=where)
    abc.new("sqlite://", obs, store_sum_stats=False)
    return abc


def noisy_config3_run(dev, kind: str):
    """A noisy config 3 leg on the card with early reject on, off, off,
    on, the counts reset just before the first and read after each:
    populations, weights, distances and the temperature trail
    bit-identical, retired > 0, the trail ending at exactly 1, one counter
    read per round plus one fetch per chunk -> (counts of the four runs,
    modes, the on-run's temperatures and pdf norms)."""
    from pyabc_tpu_torch.kernels import reset_launch_counts

    label = f"noisy config 3 ({kind})"
    runs = []
    reset_launch_counts()
    for early in TURNS:
        abc = noisy_config3(dev, early, kind)
        h, wall, counts = seg_run(abc, NC3_GENS, label)
        runs.append((early, abc, h, wall, counts))
    counts = {k: sum(r[4][k] for r in runs) for k in runs[0][4]}
    (_e, a_on, h_on, _w, c_on), (_e2, a_off, h_off, _w2, c_off) = runs[:2]
    n_gen = h_on.max_t + 1
    temps = [float(e) for e in h_on.get_all_populations()["epsilon"][1:]]
    trails = [[float(e) for e in r[2].get_all_populations()["epsilon"][1:]]
              for r in runs]
    same = all(populations_identical(h_on, r[2]) for r in runs[1:])
    tot = seg_totals(h_on)
    saved = 1.0 - tot["seg_steps"] / max(tot["seg_resolved"] * C3_SEGS, 1)
    for early, abc, h, wall, _c in runs:
        tag = "on" if early == "auto" else "off"
        syncs = abc.sync_ledger.summary()
        split = wall_split(abc)
        log(f"{label} early reject {tag}: pop={C3_POP} gens={h.max_t + 1} "
            f"wall_s={wall:.3f} accepted_particles_per_s="
            f"{C3_POP * (h.max_t + 1) / wall:.1f} syncs_per_generation="
            f"{syncs['syncs'] / (h.max_t + 1):.2f} rounds "
            f"{[g['rounds'] for g in abc.generation_log]} "
            f"{syncs['by_kind']}; host seconds, rounds + steps "
            f"{split['compute_s']:.3f}, fetch {split['fetch_s']:.3f}, "
            f"History wait {split['persist_s']:.3f}, writer "
            f"{split['write_s']:.3f}, final flush {split['flush_s']:.3f}")
        sync_check(abc, f"{label} {tag}")
    norms = [a_on.acceptor.pdf_norms[t] for t in sorted(
        a_on.acceptor.pdf_norms)]
    log(f"{label}: temperature trail {[round(t, 4) for t in temps]}; pdf "
        f"norms {[round(v, 3) for v in norms]}; acceptance "
        f"{[round(g['acceptance_rate'], 5) for g in a_off.generation_log]}")
    log(f"{label}: populations, weights, distances and the temperature "
        f"trail bit-identical on and off in every generation {same}; "
        f"retired_early {tot['retired_early']}, seg_steps "
        f"{tot['seg_steps']}, seg_resolved {tot['seg_resolved']}, "
        f"sim_work_saved_frac {saved:.4f}, segment_occupancy per "
        f"generation {tot['occupancy']}; posterior means on "
        f"{post_means(h_on)} off {post_means(h_off)}")
    log(f"{label}: kernel launches on {c_on} off {c_off}")
    check(n_gen == NC3_GENS and h_off.max_t + 1 == NC3_GENS,
          f"{label} ran {n_gen} / {h_off.max_t + 1} of {NC3_GENS} "
          f"generations")
    check(same and all(t == trails[0] for t in trails),
          f"{label}: populations differ with early reject on and off")
    check(temps[-1] == 1.0 and all(b <= a for a, b in zip(temps,
                                                          temps[1:])),
          f"{label}: temperature trail not non-increasing to exactly 1")
    check(tot["retired_early"] > 0, f"{label}: no lane retired early")
    check(c_on["segment_round:stochastic"] == c_on["segment_round"] > 0
          and c_off["tau_leap"] > 0 and c_off["segment_round"] == 0,
          f"{label}: K18's stochastic mode (on) or K19 (off) never ran")
    fam = a_on.distance_function.family
    check(c_on[f"kernel_accept:{fam}"] == c_on["kernel_accept"] > 0,
          f"{label}: the {fam} accept kernel never ran")
    check(all(counts[k] > 0 for k in NC3_PATH),
          f"a kernel of the {label} path was never launched")
    return counts, temps, norms


def family_leg(where, kind: str, early="auto"):
    """An unsegmented noise-model leg: the birth-death model (K19) under
    the defaults, Temperature() and StochasticAcceptor() (the
    acceptance-rate and exponential-decay schemes, the max-found norm);
    the unbounded kernels run the segmented model under "auto", so that
    the fallback is recorded (K19 serves it all the same)."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gillespie as g

    obs = g.observed_birth_death()
    segments = C3_SEGS if segments_of(kind) else None
    if kind == "normal":
        kern = pt.NormalKernel(cov=decay_cov(20))
    elif kind == "laplace":
        kern = pt.IndependentLaplaceKernel(scale=2.0)
    elif kind == "binomial":
        kern = pt.BinomialKernel(p=0.9)
        rng = np.random.default_rng(0)
        obs = {k: rng.binomial(np.maximum(np.round(np.asarray(v)), 0)
                               .astype(np.int64), 0.9).astype(float)
               for k, v in obs.items()}
    elif kind.startswith("negbin"):
        kern = (pt.NegativeBinomialKernel(p=0.4, parameterization="mean")
                if kind == "negbin-mean" else
                pt.NegativeBinomialKernel(p=0.5))
    else:
        kern = pt.PoissonKernel(ret_scale="SCALE_LIN")
        obs = poisson_observation()
    if segments is not None:
        obs = {k: np.asarray(v) for k, v in obs.items()}
    abc = pt.ABCSMC(
        g.make_birth_death_model(segments=segments), g.birth_death_prior(),
        kern, population_size=FAM_POP, eps=pt.Temperature(),
        acceptor=pt.StochasticAcceptor(), seed=FAM_SEED,
        early_reject=early, device=where)
    return abc, obs


def segments_of(kind: str) -> bool:
    """The unbounded kernels' legs run the segmented model (see
    ``family_leg``)."""
    return kind in ("normal", "negbin", "negbin-mean", "poisson-lin")


FAMILY_LEGS = ("normal", "laplace", "binomial", "negbin", "negbin-mean",
               "poisson-lin")


def family_cpu_temps(kind: str) -> list[float]:
    """A family leg's first two temperatures on the CPU: generation 0 alone
    gives its evaluations n0, then the run stops once it has made more
    than n0 (after generation 1) under the card leg's horizon."""
    first, _obs = family_leg("cpu", kind)
    first.new("sqlite://", _obs)
    first.run(max_nr_populations=FAM_GENS, max_total_nr_simulations=1)
    n0 = first.generation_log[0]["n_valid"]
    cpu, obs = family_leg("cpu", kind)
    cpu.new("sqlite://", obs)
    hc = cpu.run(max_nr_populations=FAM_GENS, max_total_nr_simulations=n0 + 1)
    return [float(e) for e in hc.get_all_populations()["epsilon"][1:]]


@cpu_ref
def families_cpu_temps() -> dict:
    out = {}
    for kind in FAMILY_LEGS:
        t0 = time.perf_counter()
        out[kind] = {"temps": family_cpu_temps(kind),
                     "s": time.perf_counter() - t0}
    return out


def family_runs(dev, tmpdir) -> dict:
    """Each remaining family once on the card (counts reset just before
    and read just after), its History reopened from its sqlite file, the
    same seed on the CPU (in the reference process) for its first two
    temperatures (within 1e-3), and the fallback "auto" records for the
    unbounded kernels -> {leg: launch counts}."""
    import os

    import torch

    from pyabc_tpu_torch import History
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    out = {}
    for kind in FAMILY_LEGS:
        label = f"birth-death, {kind} noise"
        abc, obs = family_leg(dev, kind)
        db = os.path.join(tmpdir, f"{kind}.db")
        abc.new("sqlite:///" + db, obs)
        torch.cuda.synchronize()
        reset_launch_counts()
        with plain_versions_raise():
            t0 = time.perf_counter()
            h = abc.run(max_nr_populations=FAM_GENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = launch_counts() | mode_launch_counts()
        temps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
        reopened = History("sqlite:///" + db)
        df, w = reopened.get_distribution(m=0, t=reopened.max_t)
        fam = abc.distance_function.family
        syncs = abc.sync_ledger.summary()
        log(f"{label} ({fam}): pop={FAM_POP} gens={len(temps)} wall_s="
            f"{wall:.3f} syncs_per_generation="
            f"{syncs['syncs'] / max(len(temps), 1):.2f} rounds "
            f"{[g['rounds'] for g in abc.generation_log]}; temperatures "
            f"{[round(t, 4) for t in temps]}; History reopened: "
            f"{reopened.max_t + 1} generations, {len(df)} particles, "
            f"weights sum {float(w.sum()):.6f}; fallbacks "
            f"{abc.capability_fallbacks}")

        def compare(kind=kind, label=label, temps=temps):
            ref = REFS.get("families_cpu_temps")[kind]
            cpu_temps = ref["temps"]
            log(f"{label}: the CPU's temperatures "
                f"{[round(t, 4) for t in cpu_temps]} ({ref['s']:.1f} s), "
                f"the card's {[round(t, 4) for t in temps[:2]]}")
            check(len(temps) >= 2 and len(cpu_temps) >= 2 and all(
                abs(a - b) <= 1e-3 * abs(b)
                for a, b in zip(temps[:2], cpu_temps[:2])),
                  f"{label}: the CPU's first two temperatures differ from "
                  f"the card's by more than 1e-3")

        PENDING.append(compare)
        check(reopened.max_t == h.max_t and len(df) == FAM_POP
              and abs(float(w.sum()) - 1.0) < 1e-6,
              f"{label}: the History does not reopen whole")
        check(counts[f"kernel_accept:{fam}"] == counts["kernel_accept"] > 0
              and counts["segment_round"] == 0 and counts["tau_leap"] > 0,
              f"{label}: the {fam} accept kernel or K19 never ran")
        if segments_of(kind):
            fb = abc.capability_fallbacks
            check(len(fb) == 1 and fb[0]["gate"] == "early_reject"
                  and "no monotone log-density upper bound" in fb[0]["reason"]
                  and h.get_telemetry(0)["capability_fallbacks"] == fb,
                  f"{label}: the early-reject fallback was not recorded "
                  f"with the JAX package's reason")
        out[kind] = counts
    return out


# ------------------------------------------------------------------ K16
#: the LV adaptive leg: LV config 2 (bench.py:119-127) under pyABC's
#: AdaptivePopulationSize defaults (mean_cv 0.05, 10 bootstraps), capped
#: at the scale lane's 16384, so every generation's first probe runs at
#: n = n_cap = 16384
ADA_START, ADA_MAX, ADA_CV, ADA_BOOT, ADA_GENS = 1000, 16384, 0.05, 10, 10
#: the same leg at a target the LV posterior reaches below max_n, with the
#: start size as the floor, so each generation runs a whole bisection
ADA_CV_REACH, ADA_MIN_REACH = 0.15, 1000
#: config 5 (the ODE family, K = 3) under an adaptive n
C5A_START, C5A_MAX, C5A_GENS = 1000, 4096, 8
#: the toy's list of sizes, one generation each
LIST_SIZES = (500, 1000, 2000, 1000, 500)
#: seeds of the toy's list under LocalTransition
LIST_LOCAL_SEEDS = 16
#: the grid of the toy's list under GridSearchCV (the JAX suite's)
LIST_GRID = (0.25, 1.0, 2.25)
#: the local adaptive legs' paths (the kernels each must launch)
LOCAL_ADA_PATH = ("propose", "propose_local", "local_logpdf", "lv_simulate",
                  "pnorm_accept_weight", "compact_round",
                  "normalize_quantile", "scale_reduce", "pack_fetch",
                  "generation_health", "local_cov", "local_factor",
                  "proposal_drift", "bootstrap_cv")
LOCAL_C5A_PATH = ("propose", "propose_local", "local_logpdf",
                  "ode_family_simulate", "pnorm_accept_weight",
                  "compact_round", "normalize_quantile", "local_cov",
                  "local_factor", "proposal_drift", "model_step",
                  "pack_fetch", "generation_health", "bootstrap_cv")
#: the K > 1 local modes, each a row of the kernels line: (mode key,
#: source, the TPU program it replaces)
LOCAL_MODE_ROWS = (
    ("propose_local:models", "pyabc_tpu_torch/csrc/propose.cu",
     "pyabc_tpu/transition/local_transition.py:432"),
    ("local_logpdf:models", "pyabc_tpu_torch/csrc/local_logpdf.cu",
     "pyabc_tpu/transition/local_transition.py:442"),
    ("proposal_drift:models", "pyabc_tpu_torch/csrc/proposal_drift.cu",
     "pyabc_tpu/inference/util.py:1958"),
    ("local_cov:models", "pyabc_tpu_torch/csrc/local_cov.cu",
     "pyabc_tpu/inference/util.py:1908"),
    ("local_factor:models", "pyabc_tpu_torch/csrc/local_factor.cu",
     "pyabc_tpu/inference/util.py:1908"))
LOCAL_MODES = tuple(name for name, _s, _l in LOCAL_MODE_ROWS)
#: operations of one Philox block (ten rounds: two 32-bit products, two
#: high halves, three XORs and the key schedule) and of one density term
#: beyond its 2 d-operation dot product (the Mahalanobis sum, the scale,
#: the online logsumexp's compare, difference, exp and sum)
OPS_PER_BLOCK = 100
K16_OPS_PER_TERM = 8
#: K16's entries (``BootstrapCV.ENTRIES``): the MVN's, then
#: LocalTransition's (its fit is K12 and K13, counted in their
#: ``bootstrap`` mode)
K16_ENTRIES = ("draw", "fit", "density", "bisect")
K16_LOCAL_ENTRIES = ("local_gather", "local_density")
ADA_PATH = LV_PATH + ("bootstrap_cv",)


def k16_inputs(dev, K: int, n_cap: int, d: int, n_live: int, seed: int):
    """Refit params as the generation step leaves them: K8 over n_cap rows,
    the first n_live weighted. K = 3 takes config 5's dims (1, 2, 2) on
    d_max 2 with model 1 dead (no rows), its model probabilities from the
    weights -> (stacked thetas, weights, cdf; dims; statics; model_p)."""
    import torch

    from pyabc_tpu_torch.kernels import mvn_fit
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = {"scaling": 1.0, "bandwidth_selector": silverman_rule_of_thumb}
    theta = (torch.randn(n_cap, d, generator=gen, device=dev)
             * torch.linspace(0.5, 2.0, d, device=dev) + 1.0)
    w = torch.rand(n_cap, generator=gen, device=dev) + 0.1
    w[n_live:] = 0.0
    w = w / w.sum()
    if K == 1:
        p = mvn_fit(theta, w, dim=d, **st)
        return ({k: p[k][None].contiguous()
                 for k in ("thetas", "weights", "cdf")}, [d], [st], None)
    dims = [1, 2, 2]
    m = (torch.arange(n_cap, device=dev) % K).to(torch.int32)
    m[m == 1] = 2
    theta[m == 0, 1:] = 0.0
    p = mvn_fit.models(theta, w, m, dims=dims, statics=[st] * K)
    model_p = torch.stack([w[m == k].sum() for k in range(K)])
    return ({k: p[k] for k in ("thetas", "weights", "cdf")}, dims,
            [st] * K, model_p)


def required_nr_plain(x, dims, statics, model_p, **kw):
    """``required_nr`` with the plain version of every entry."""
    import torch

    from pyabc_tpu_torch.kernels.bootstrap_cv import (
        MAX_PROBES, bootstrap_bisect_plain, bootstrap_density_plain,
        bootstrap_draw_plain, bootstrap_fit_plain, n_probes)

    idx, state = bootstrap_draw_plain(
        x["cdf"], n_boot=kw["n_bootstrap"], seed=kw["seed"],
        generation=kw["generation"], max_rounds=kw["max_rounds"],
        min_n=kw["min_n"], max_n=kw["max_n"])
    cvs = torch.zeros(MAX_PROBES, dtype=torch.float32,
                      device=x["cdf"].device)
    for _ in range(n_probes(kw["min_n"], kw["max_n"])):
        fit = bootstrap_fit_plain(x["thetas"], idx, state, dims=dims,
                                  statics=statics)
        part = bootstrap_density_plain(x["thetas"], x["weights"], fit, state)
        bootstrap_bisect_plain(part, state, cvs, model_p=model_p,
                               target=kw["target_cv"])
    return state, cvs


def k16_case(dev, label: str, K: int, n_cap: int, d: int, nb: int,
             n_live: int, timed: bool) -> dict:
    """K16's four entries against their plain versions at one shape: the
    draw bit-equal (ancestors and the reset state), the fit at K8's
    tolerances, each model's CV within 1e-4 relative (and the same from
    run to run), the bisect step's state and CV bit-equal, and a whole
    bisection (the kernels against the plain entries) ending at the same
    n with every probe's CV within 1e-4 relative."""
    import torch

    from pyabc_tpu_torch.kernels import bootstrap_cv
    from pyabc_tpu_torch.kernels.bootstrap_cv import (
        MAX_PROBES, PROBE, bootstrap_bisect_plain, bootstrap_density_plain,
        bootstrap_draw_plain, bootstrap_fit_plain, n_blocks, n_probes,
        required_nr)

    x, dims, statics, model_p = k16_inputs(dev, K, n_cap, d, n_live,
                                           seed=16 + K)
    dkw = dict(n_boot=nb, seed=5, generation=3, max_rounds=256, min_n=10,
               max_n=n_cap)
    idx, state = bootstrap_cv.draw(x["cdf"], **dkw)
    idx_p, state_p = bootstrap_draw_plain(x["cdf"], **dkw)
    torch.cuda.synchronize()
    check(torch.equal(idx, idx_p) and torch.equal(state, state_p),
          f"K16 draw ({label}): ancestors or state differ from the plain "
          f"version")
    alive = [k for k in range(K) if model_p is None or float(model_p[k]) > 0]
    drawn_dead = torch.gather(x["weights"] <= 0, 1,
                              idx.reshape(K, -1).long())[alive]
    check(not bool(drawn_dead.any()),
          f"K16 draw ({label}): a zero-weight row of a live model drawn")
    check(int(state[PROBE]) == n_cap, "K16: the first probe is not max_n")
    fit = bootstrap_cv.fit(x["thetas"], idx, state, dims=dims,
                           statics=statics)
    fit_p = bootstrap_fit_plain(x["thetas"], idx, state, dims=dims,
                                statics=statics)
    torch.cuda.synchronize()
    err = rel = 0.0
    for key, (atol, rt) in {"center": (1e-7, 1e-5), "prec": (1e-5, 1e-4),
                            "logdet": (1e-5, 1e-4),
                            "quad": (1e-5, 1e-4)}.items():
        got, ref = fit[key][alive], fit_p[key][alive]
        check(within(got, ref, atol, rt),
              f"K16 fit ({label}): {key} outside rel {rt}")
        diff = (got - ref).abs()
        err = max(err, float(diff.max()))
        # relative to the tensor's scale: entries near 0 (the precision's
        # off-diagonal) carry no relative error of their own
        rel = max(rel, float(diff.max() / ref.abs().max().clamp_min(1e-30)))
    scale = 1e-5 * float(fit_p["center"][alive].abs().max())
    check(within(fit["thetas_c"][alive], fit_p["thetas_c"][alive], scale,
                 1e-5), f"K16 fit ({label}): centred rows outside the "
          f"mean's error")
    part = bootstrap_cv.density(x["thetas"], x["weights"], fit_p, state)
    again = bootstrap_cv.density(x["thetas"], x["weights"], fit_p, state)
    part_p = bootstrap_density_plain(x["thetas"], x["weights"], fit_p,
                                     state)
    torch.cuda.synchronize()
    check(torch.equal(part, again), f"K16 density ({label}): sums differ "
          f"from run to run")

    def cv_of(p):
        return p[..., 0].sum(1) / p[..., 1].sum(1).clamp_min(1e-38)

    cv_k, cv_p = cv_of(part)[alive], cv_of(part_p)[alive]
    check(within(cv_k, cv_p, 0.0, 1e-4),
          f"K16 density ({label}): CV outside 1e-4 relative "
          f"({cv_k.tolist()} vs {cv_p.tolist()})")
    check(within(part[..., 1], part_p[..., 1], 1e-7, 1e-5),
          f"K16 density ({label}): weight sums outside 1e-5 relative")
    cv_err = float((cv_k - cv_p).abs().max())
    cv_rel = float(((cv_k - cv_p).abs() / cv_p.abs().clamp_min(1e-30)).max())
    s_k, s_p = state.clone(), state.clone()
    c_k = torch.zeros(MAX_PROBES, device=dev)
    c_p = torch.zeros(MAX_PROBES, device=dev)
    target = 1.5 * float(cv_of(part_p)[alive].mean())
    bootstrap_cv.bisect(part, s_k, c_k, model_p=model_p, target=target)
    bootstrap_bisect_plain(part, s_p, c_p, model_p=model_p, target=target)
    torch.cuda.synchronize()
    check(torch.equal(s_k, s_p) and torch.equal(c_k, c_p),
          f"K16 bisect ({label}): state or CV differ from the plain version")
    rkw = dict(seed=5, generation=3, max_rounds=256, target_cv=target,
               min_n=10, max_n=n_cap, n_bootstrap=nb)
    res = required_nr(x["thetas"], x["weights"], x["cdf"], dims=dims,
                      statics=statics, model_p=model_p, **rkw)
    st_p, cvs_p = required_nr_plain(x, dims, statics, model_p, **rkw)
    torch.cuda.synchronize()
    probes = int(res["state"][4])
    check(torch.equal(res["state"], st_p),
          f"K16 ({label}): the bisection's state {res['state'].tolist()} "
          f"differs from the plain entries' {st_p.tolist()}")
    check(within(res["cvs"][:probes], cvs_p[:probes], 1e-7, 1e-4),
          f"K16 ({label}): a probe's CV outside 1e-4 relative")
    log(f"K16 bootstrap_cv ({label}: K={K}, n_cap={n_cap}, d={d}, "
        f"{nb} bootstraps, {n_live} weighted rows): draw bit-equal, fit "
        f"max_abs_err={err:.3e} max_rel_err={rel:.3e}, CV {cv_k.tolist()} "
        f"max_rel_err={cv_rel:.3e}, bisect bit-equal; bisection to "
        f"n={int(res['n_next'])} in {probes} of {n_probes(10, n_cap)} "
        f"probes (target {target:.5f}), CV trail "
        f"{[round(v, 5) for v in res['cvs'][:probes].tolist()]}")
    out = {"errors": {"fit": (err, rel), "density": (cv_err, cv_rel)}}
    if not timed:
        return out
    # timed at the first probe (n = n_cap), the most a probe does
    n = n_cap
    live = int((x["weights"] != 0).sum())
    terms = live * nb * n
    s0 = state.clone()
    s_t = state.clone()
    c_t = torch.zeros(MAX_PROBES, device=dev)

    def step():
        s_t.copy_(s0)
        bootstrap_cv.bisect(part, s_t, c_t, model_p=model_p, target=target)

    def step_plain():
        s_t.copy_(s0)
        bootstrap_bisect_plain(part, s_t, c_t, model_p=model_p,
                               target=target)

    calls = {
        "draw": (lambda: bootstrap_cv.draw(x["cdf"], **dkw),
                 lambda: bootstrap_draw_plain(x["cdf"], **dkw),
                 bound((K * n_cap + K * nb * n_cap + 5) * 4,
                       K * nb * n_cap * (OPS_PER_BLOCK
                                         + 3 * math.log2(n_cap)))),
        "fit": (lambda: bootstrap_cv.fit(x["thetas"], idx, state, dims=dims,
                                         statics=statics),
                lambda: bootstrap_fit_plain(x["thetas"], idx, state,
                                            dims=dims, statics=statics),
                bound((K * n_cap * d + K * nb * n + K * nb * n * (d + 1)
                       + K * nb * (d * d + d + 1)) * 4,
                      K * nb * n * (2 * d + 3 * d * d + 2 * d * d + 2 * d))),
        "density": (lambda: bootstrap_cv.density(x["thetas"], x["weights"],
                                                 fit, state),
                    lambda: bootstrap_density_plain(x["thetas"],
                                                    x["weights"], fit, state),
                    bound((K * n_cap * (d + 1) + K * nb * n * (d + 1)
                           + K * nb * (d * d + d + 1)
                           + K * n_blocks(n_cap) * 2) * 4,
                          terms * (2 * d + K16_OPS_PER_TERM)
                          + live * nb * (2 * d * d + 3 * d + 8))),
        "bisect": (step, step_plain,
                   bound((K * n_blocks(n_cap) * 2 + 5 + 2) * 4,
                         2 * K * n_blocks(n_cap) + 4 * K)),
    }
    for entry, (fn, plain, bnd) in calls.items():
        out[entry] = dict(
            call_ms=time_ms(fn, 10), ms=graph_ms(fn, iters=10, replays=3),
            plain_ms=time_ms(plain, 2, warmup=1), bound=bnd,
            library_ms=None)
        log(f"K16 {entry} ({label}): ms={out[entry]['ms']:.5f} call_ms="
            f"{out[entry]['call_ms']:.5f} plain_ms="
            f"{out[entry]['plain_ms']:.4f} bound_ms={bnd[0]:.6f} ({bnd[1]})"
            + (f", {terms} density terms" if entry == "density" else ""))
    return out


def k16_checks(dev) -> dict:
    """K16 at the LV adaptive leg's full shape (n_cap 16384, 10
    bootstraps, d 4; every row weighted: the first probe's n is 16384),
    at config 5's (K 3, d_max 2, n_cap 4096, one model dead) and at a small
    odd shape (n_cap 100, 3 bootstraps, d 1, 37 weighted rows)."""
    full = k16_case(dev, "LV adaptive leg", 1, ADA_MAX, 4, ADA_BOOT,
                    ADA_MAX, timed=True)
    k3 = k16_case(dev, "config 5 adaptive leg", 3, C5A_MAX, 2, ADA_BOOT,
                  C5A_MAX, timed=False)
    small = k16_case(dev, "small odd shape", 1, 100, 1, 3, 37, timed=False)
    out = {}
    for e in K16_ENTRIES:
        # the draw and the bisect step are bit-equal at every shape; the
        # fit's error relative to each tensor's scale, the density's that
        # of the CV, the largest over the three shapes
        errs = [case["errors"].get(e, (0.0, 0.0))
                for case in (full, k3, small)]
        out[f"bootstrap_cv:{e}"] = {**full[e],
                                    "err": max(a for a, _r in errs),
                                    "rel": max(r for _a, r in errs)}
    return out


def adaptive_lv(where, mean_cv: float = ADA_CV, min_n: int = 10,
                population_size=None, local: bool = False,
                start: int = ADA_START, cap: int = ADA_MAX):
    """The LV adaptive leg: LV config 2 (bench.py:119-127) with
    AdaptivePopulationSize(start 1000, mean_cv 0.05, max 16384, 10
    bootstraps); another target and floor, or another strategy
    (``population_size``), for the legs beside it. ``local``: the scale
    lane's LocalTransition(k_fraction=0.25) (the LV local adaptive leg)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    aps = population_size or pt.AdaptivePopulationSize(
        start_nr_particles=start, mean_cv=mean_cv,
        max_population_size=cap, min_population_size=min_n,
        n_bootstrap=ADA_BOOT)
    kw = ({"transitions": pt.LocalTransition(k_fraction=0.25)} if local
          else {})
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=aps,
                    eps=pt.MedianEpsilon(), seed=0, device=where, **kw)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    return abc


def config5_adaptive(where, local: bool = False, start: int = C5A_START,
                     cap: int = C5A_MAX):
    """Config 5 (the ODE family, K = 3) with AdaptivePopulationSize(start
    1000, mean_cv 0.05, max 4096, 10 bootstraps); ``local``: a
    LocalTransition() for each model (the config 5 local adaptive leg)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _ts = msel.ode_family()
    aps = pt.AdaptivePopulationSize(
        start_nr_particles=start, mean_cv=ADA_CV,
        max_population_size=cap, n_bootstrap=ADA_BOOT)
    kw = ({"transitions": [pt.LocalTransition()] * len(models)} if local
          else {})
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=aps, eps=pt.MedianEpsilon(), seed=0,
                    device=where, **kw)
    abc.new("sqlite://", msel.observed_ode_family(seed=0, true_model=1),
            store_sum_stats=False)
    return abc


def population_leg(dev, label: str, make, gens: int, path, *, lo: int,
                   hi: int, bisects: bool = False,
                   local_fits: tuple | None = None) -> tuple:
    """One adaptive population-size leg on the card (``make(where)`` builds
    it), counts reset just before and read just after, then once more
    under torch.profiler -> (counts, mode counts, n trail, the ABCSMC):
    the n trail within [lo, hi] and equal to the stored counts, each
    n_next the next generation's n, K16 launched in every generation but
    the last, its launches, the probes that did work and the CV at max_n
    per generation (telemetry), its device ms per generation and per
    probe that did work, syncs per generation (one counter read a round,
    one fetch a chunk, nothing else), the wall. ``bisects``: some
    generation's CV at max_n met the target, so K16 ran a whole bisection
    there and n fell below max_n. ``local_fits`` (K, n_bootstrap): the
    leg runs LocalTransition, so K16 takes its LocalTransition mode (the
    gather, K12 and K13 per bootstrap, the local density, the bisect)."""
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    abc = make(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, modes = launch_counts(), mode_launch_counts()
    n_gen = h.max_t + 1
    tel = [h.get_telemetry(t) for t in range(n_gen)]
    trail = [int(x["n_target"]) for x in tel]
    nxt = [x.get("n_next") for x in tel]
    probes = [x.get("k16_probes", 0) for x in tel]
    cv_max = [round(x["k16_cv_max"], 5) if "k16_cv_max" in x else None
              for x in tel]
    stored = h.get_nr_particles_per_population()
    stored = [int(stored[t]) for t in range(n_gen)]
    syncs = abc.sync_ledger.summary()
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    k16 = {e: modes[f"bootstrap_cv:{e}"]
           for e in K16_ENTRIES + K16_LOCAL_ENTRIES}
    probe_entries = (("local_gather", "local_density") if local_fits
                     else ("fit", "density"))
    log(f"{label}: gens={n_gen} wall_s={wall:.3f} accepted_particles_per_s="
        f"{sum(trail) / wall:.1f} wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"({syncs['by_kind']}, rounds "
        f"{[g['rounds'] for g in abc.generation_log]})")
    split = wall_split(abc)
    log(f"{label}: host seconds, rounds + generation steps "
        f"{split['compute_s']:.4f}, packed fetch {split['fetch_s']:.4f}, "
        f"History wait {split['persist_s']:.4f}, writer "
        f"{split['write_s']:.4f}, final flush {split['flush_s']:.4f}, "
        f"other "
        f"{wall - held_s(split):.4f}")
    log(f"{label}: n trail {trail}, n_next {nxt}, stored counts {stored}; "
        f"eps trail {[round(e, 5) for e in eps]}")
    log(f"{label}: K16 launches {k16} ({counts['bootstrap_cv']} in all, "
        f"{counts['bootstrap_cv'] / n_gen:.1f} per generation); probes that "
        f"did work per generation {probes}; aggregate CV at max_n per "
        f"generation {cv_max}; kernel launches {counts}")
    check(n_gen == gens, f"{label} ran {n_gen} of {gens} generations")
    check(stored == trail, f"{label}: stored counts {stored} differ from "
          f"the n trail {trail}")
    check(all(lo <= n <= hi for n in trail),
          f"{label}: n outside [{lo}, {hi}]: {trail}")
    check(all(counts[k] > 0 for k in path),
          f"{label}: a kernel of the path was never launched")
    sync_check(abc, label)
    check(all(nxt[t] == trail[t + 1] for t in range(n_gen - 1))
          and nxt[-1] == trail[-1],
          f"{label}: n_next does not become the next generation's n")
    check(k16["draw"] == n_gen - 1 and k16["bisect"] > 0
          and all(k16[e] == k16["bisect"] for e in probe_entries)
          and all(v == 0 for e, v in k16.items()
                  if e not in probe_entries + ("draw", "bisect")),
          f"{label}: K16 did not run its mode once a generation but the "
          f"last ({k16})")
    if local_fits:
        K, nb = local_fits
        boot = modes["local_cov:bootstrap"]
        check(boot == k16["bisect"] * K * nb
              and modes["local_factor:bootstrap"] == boot,
              f"{label}: K16's K12 and K13 launches ({boot}) are not "
              f"{K * nb} a probe")
    check(all(p > 0 for p in probes[:-1]) and probes[-1] == 0,
          f"{label}: K16's probes {probes} (one or more a generation but "
          f"the last)")
    if bisects:
        check(any(p > 1 and n < hi for p, n in zip(probes, nxt)),
              f"{label}: no generation ran a whole bisection (probes "
              f"{probes}, n_next {nxt})")
    spans: list = []
    by_name = profile_run(f"{label} (profiled)", make(dev), gens, spans)
    if by_name:
        k16_ms = sum(v[0] for name, v in by_name.items()
                     if "boot_" in name) / 1e3
        share = ""
        if local_fits:
            # K12 and K13 serve both the refit and K16's bootstrap fits: a
            # probe's fits are the device ops between its gather and its
            # bisect (one stream, launched in order), the refit's lie
            # outside those windows
            fits, other, inside = 0.0, 0.0, False
            for start, end, name in spans:
                if "boot_gather_kernel" in name:
                    inside = True
                if inside and "boot_" not in name:
                    if any(f in name for f in K12_K13_DEVICE_OPS):
                        fits += (end - start) / 1e3
                    else:
                        other += (end - start) / 1e3
                if "boot_bisect_kernel" in name:
                    inside = False
            share = (f"; K16's own kernels {k16_ms:.4f} ms, K12 and K13 of "
                     f"its bootstrap fits {fits:.4f} ms, other device ops "
                     f"inside its probes {other:.4f} ms")
            k16_ms += fits + other
        log(f"{label}: K16 device ms per generation "
            f"{k16_ms / max(n_gen - 1, 1):.4f} ({k16_ms:.4f} ms over "
            f"{n_gen - 1} generations that ran it, {sum(probes)} probes "
            f"that did work: {k16_ms / max(sum(probes), 1):.4f} ms each, "
            f"torch.profiler{share})")
    return counts, modes, trail, abc


def constant_lv_syncs(dev, ada_abc) -> None:
    """LV config 2 at ConstantPopulationSize(ADA_MAX) for ADA_GENS
    generations beside the LV adaptive leg: syncs per generation, and in
    both runs every generation's reads are its rounds' counter reads (the
    n rides them; K16's answer rides the chunk's fetch), one fetch a
    chunk, the calibration's reads alike."""
    import torch

    import pyabc_tpu_torch as pt

    abc = adaptive_lv(dev, population_size=pt.ConstantPopulationSize(
        ADA_MAX))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = abc.run(max_nr_populations=ADA_GENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(h.max_t + 1 == ADA_GENS,
          f"constant-n LV ran {h.max_t + 1} of {ADA_GENS} generations")
    sync_check(abc, "LV config 2 at a constant n")
    per = {}
    for name, run in (("constant n", abc), ("adaptive n", ada_abc)):
        summ, gl = run.sync_ledger.summary(), run.generation_log
        rounds = sum(g["rounds"] for g in gl)
        per[name] = summ["by_kind"]["round_counters"] - rounds
        log(f"syncs, LV config 2 at {name} ({len(gl)} generations): "
            f"{summ['syncs'] / len(gl):.2f} a generation "
            f"({summ['by_kind']}, rounds {[g['rounds'] for g in gl]}, "
            f"reads a generation minus its rounds "
            f"{[g['syncs'] - g['rounds'] for g in gl]})"
            + (f", wall_s={wall:.3f}" if run is abc else ""))
        check(all(g["syncs"] == g["rounds"] for g in gl),
              f"LV config 2 at {name}: a generation read the device "
              f"besides its round counters")
    check(per["constant n"] == per["adaptive n"],
          f"the calibration's reads differ: {per}")


def list_leg(dev, kind: str = "mvn") -> tuple[dict, dict, list]:
    """The Gaussian toy with ListPopulationSize((500, 1000, 2000, 1000,
    500)) over TOY_SEEDS seeds on the card, counts reset just before the
    first: the stored counts equal the list in every seed, the seed mean of
    the posterior means lies within 0.03 of the analytic posterior mean
    (the toy leg's rule; the seeds' sd is about 0.05 at a last n of 500, so
    its se is about 0.009) and every seed within 0.25 (5 sd). ``kind``
    "local": LocalTransition(k_fraction=0.3) over the first 16 seeds, the
    seed mean within 0.05 (the se about 0.013); "grid": GridSearchCV over
    LIST_GRID with cv 5 over the first 16 seeds (K17 on each generation's
    fold table), within 0.05."""
    import numpy as np
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gaussian

    local = kind == "local"
    mu_true, _sd_true = gaussian.conjugate_posterior(1.0)
    mus, counts = [], None
    seeds = TOY_SEEDS[:LIST_LOCAL_SEEDS] if kind != "mvn" else TOY_SEEDS
    kw = ({"transitions": pt.LocalTransition(k_fraction=0.3)} if local
          else {"transitions": pt.GridSearchCV(
              pt.MultivariateNormalTransition(),
              {"scaling": list(LIST_GRID)}, cv=5)} if kind == "grid"
          else {})
    name = {"mvn": "list leg", "local": "list leg, local",
            "grid": "list leg, GridSearchCV"}[kind]
    for seed in seeds:
        abc = pt.ABCSMC(gaussian.make_mean_only_model(),
                        gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                        population_size=pt.ListPopulationSize(LIST_SIZES),
                        eps=pt.MedianEpsilon(), seed=seed, device=dev, **kw)
        abc.new("sqlite://", {"x": 1.0})
        if seed == 0:
            torch.cuda.synchronize()
            reset_launch_counts()
        with plain_versions_raise():
            t0 = time.perf_counter()
            h = abc.run(max_nr_populations=len(LIST_SIZES) + 2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stored = h.get_nr_particles_per_population()
        stored = [int(stored[t]) for t in range(h.max_t + 1)]
        check(stored == list(LIST_SIZES), f"{name} seed {seed}: stored "
              f"counts {stored} differ from {list(LIST_SIZES)}")
        df, w = h.get_distribution()
        mus.append(float(np.sum(df["theta"] * w)))
        if seed == 0:
            counts, modes = launch_counts(), mode_launch_counts()
            syncs = abc.sync_ledger.summary()
            sync_check(abc, name)
            log(f"toy ListPopulationSize{LIST_SIZES}"
                f"{'' if kind == 'mvn' else ', ' + kind}: seed 0 wall_s="
                f"{wall:.3f} syncs_per_generation="
                f"{syncs['syncs'] / (h.max_t + 1):.2f} ({syncs['by_kind']}), "
                f"stored counts {stored}, K16 launches "
                f"{counts['bootstrap_cv']}; kernel launches {counts}")
    mean = float(np.mean(mus))
    se = float(np.std(mus, ddof=1) / math.sqrt(len(mus)))
    log(f"toy {name} ({len(mus)} seeds): seed mean {mean:.4f} se "
        f"{se:.4f} against the analytic {mu_true:.4f} "
        f"({(mean - mu_true) / se:+.2f} se); per seed min {min(mus):.4f} "
        f"max {max(mus):.4f}")
    lim = 0.05 if kind != "mvn" else 0.03
    check(abs(mean - mu_true) < lim,
          f"{name}: the seed mean is off the analytic mean by >= {lim}")
    check(all(abs(m - mu_true) < 0.25 for m in mus),
          f"{name}: a seed's posterior mean is off by >= 0.25")
    check(counts["bootstrap_cv"] == 0, f"{name}: K16 ran on a list")
    if kind == "grid":
        check(counts["grid_search_cv"] == len(LIST_SIZES)
              and counts["mvn_fit"] == 0,
              f"{name}: K17 did not refit every generation in K8's place")
    if local:
        check(all(counts[k] > 0 for k in LOCAL_KERNELS)
              and counts["mvn_fit"] == 0,
              f"{name}: LocalTransition's kernels did not serve the run")
        abc = pt.ABCSMC(gaussian.make_mean_only_model(),
                        gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                        population_size=pt.ListPopulationSize(LIST_SIZES),
                        eps=pt.MedianEpsilon(), seed=0, device=dev, **kw)
        abc.new("sqlite://", {"x": 1.0})
        profile_run(f"toy {name} (seed 0, profiled)", abc,
                    len(LIST_SIZES) + 2)
        log(f"toy {name} (seed 0): wall split {wall_split(abc)}")
    return counts, modes, list(LIST_SIZES)


# ------------------- LocalTransition under population sizes and K > 1
#: the LV local adaptive leg: the scale lane's LocalTransition(k_fraction
#: 0.25) under the LV adaptive leg's AdaptivePopulationSize (start 1000,
#: mean_cv 0.05, max 16384, 10 bootstraps): n_cap 16384, k_cap 4096,
#: threshold selection at stride 4, the refit cadence auto (16, 0.3)
LOCAL_ADA_STATICS = {"scaling": 1.0, "k_cap": 4096, "k_fixed": -1,
                     "k_fraction": 0.25, "k_max": None,
                     "selection": "auto"}
#: config 5's LocalTransition() at its cap of 4096: k_cap 1024 (threshold
#: selection, stride 1)
C5_LOCAL_STATICS = {"scaling": 1.0, "k_cap": 1024, "k_fixed": -1,
                    "k_fraction": 0.25, "k_max": None, "selection": "auto"}
#: bootstrap fits of a probe whose K12 and K13 the phase-2 check holds
#: against their plain versions (the plain K12 takes about 1.5 s at 16384
#: rows)
K16_LOCAL_FITS_CHECKED = 2
#: operations of one local density pair beyond its d subtractions: the
#: d (d + 1) fmas of the Mahalanobis form, the constant's fma, the exp and
#: the online logsumexp's compare, difference and sum
LOCAL_PAIR_OPS = 6
#: the LV and config 5 local adaptive legs' card-against-CPU size
LOCAL_CPU_POP = 1024


def local_refit(dev, K: int, n_cap: int, d: int, n_live: int, seed: int,
                statics: dict):
    """LocalTransition's refit params as the generation step leaves them
    (K12 and K13 over n_cap rows, the first n_live weighted). K = 3 takes
    config 5's dims (1, 2, 2) on d_max 2 with model 1 dead (its never-fitted
    placeholder) -> (stacked params, dims, each model's K12 arguments,
    model_p or None)."""
    import torch

    from pyabc_tpu_torch.transition import LocalTransition

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    theta = (torch.randn(n_cap, d, generator=gen, device=dev)
             * torch.linspace(0.5, 2.0, d, device=dev) + 1.0)
    w = torch.rand(n_cap, generator=gen, device=dev) + 0.1
    w[n_live:] = 0.0
    w = w / w.sum()
    dims = [d] if K == 1 else [1, 2, 2]
    configs = [LocalTransition.field_config(n_cap, dk, device=dev,
                                            **statics) for dk in dims]
    if K == 1:
        p = LocalTransition.device_fit(theta, w, dim=d, **statics,
                                       k_table=configs[0]["k_table"])
        return ({k: p[k][None].contiguous() for k in p if k != "dim"},
                dims, configs, None)
    m = (torch.arange(n_cap, device=dev) % K).to(torch.int32)
    m[m == 1] = 2
    theta[m == 0, 1:] = 0.0
    dims_f = torch.tensor([float(x) for x in dims], device=dev)
    prev = LocalTransition.zero_params_models(K, n_cap, d, dims_f)
    w_models = torch.stack([torch.where(m == k, w, torch.zeros_like(w))
                            for k in range(K)]).contiguous()
    flags = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    params, _rows = LocalTransition.device_fit_models(
        theta, w_models, prev, flags, dims=dims, configs=configs,
        incremental=False)
    model_p = torch.stack([w[m == k].sum() for k in range(K)])
    return params, dims, configs, model_p


def local_fit_plain_of(rows, boot_w, kb: int, dim: int, config: dict):
    """The plain K12 and K13 of bootstrap fit kb (its own field)."""
    from pyabc_tpu_torch.kernels.local_cov import local_cov_plain
    from pyabc_tpu_torch.kernels.local_factor import local_factor_plain

    field = local_cov_plain(rows[kb], boot_w, **config)
    params, _n = local_factor_plain(field, None, dim=dim, incremental=False)
    return {**params, "covs": field["covs"], "cnt": field["cnt"]}


def k16_local_bound(K, nb, n, d, live, configs, cnt_sum):
    """Bounds of a probe's entries at n: the gather (bytes), the K nb K12
    fits (their distance, selection and covariance operations, as the
    phase-2 K12 bound counts them; ``cnt_sum`` the neighbours selected),
    the K nb K13 factorizations (bytes) and the local density (operations:
    live nb n pairs) -> (gather, K12, K13, density, K12 as the block-a-row
    design's bound counted it)."""
    gather = bound((K * nb * n * (1 + 2 * d) + n + 6) * 4, 0)
    ops = old_ops = nbytes = 0.0
    for cfg in configs:
        o, oo = k12_ops(n, d, cfg, 0.0)
        ops += nb * o
        old_ops += nb * oo
        nbytes += nb * (n * (d + 1) + n * (d + 2 + d * d) + 2 * n + 1) * 4
    cov = bound(nbytes, ops + cnt_sum * 3 * d * d)
    cov_old = bound(nbytes, old_ops + cnt_sum * 3 * d * d)
    factor = bound(len(configs) * nb * n * (d * d + 1 + 2 * d * d + 2) * 4,
                   len(configs) * nb * n * 4 * d ** 3)
    dens = bound((K * n * (d + 1) + K * nb * n * (d + d * d + 2)
                  + K * n_blocks_of(n) * 2) * 4,
                 live * nb * n * (d + 2 * d * (d + 1) + LOCAL_PAIR_OPS))
    return gather, cov, factor, dens, cov_old


def fit_parts(rows, boot_w, go, fits, dims, configs, kbs):
    """The K12 and K13 launches of the fits ``kbs`` (model k of fit kb is
    kb // nb), each on its own, into ``fits``' views -> (K12's call, K13's
    call)."""
    from pyabc_tpu_torch.kernels import local_cov, local_factor

    nb = rows.shape[0] // len(dims)
    field_keys = ("thetas", "weights", "cdf", "covs", "cnt")

    def cov():
        for kb in kbs:
            local_cov(rows[kb], boot_w, flag=go, mode="bootstrap",
                      out={key: fits[key][kb] for key in field_keys},
                      **configs[kb // nb])

    def factor():
        for kb in kbs:
            local_factor({key: fits[key][kb] for key in field_keys}, None,
                         dim=int(dims[kb // nb]), incremental=False,
                         flag=go, mode="bootstrap",
                         out={key: fits[key][kb] for key in
                              ("chols", "precs", "logdets", "lconst")})

    return cov, factor


def n_blocks_of(n: int) -> int:
    from pyabc_tpu_torch.kernels.bootstrap_cv import n_blocks

    return n_blocks(n)


def k16_local_case(dev, label: str, K: int, n_cap: int, d: int, nb: int,
                   n_live: int, statics: dict, timed: bool,
                   whole: bool) -> dict:
    """K16's LocalTransition mode against its plain versions at one shape:
    the gather bit-equal, the first K16_LOCAL_FITS_CHECKED bootstrap fits of
    each live model (K12 and K13 in their bootstrap mode) at the phase-2
    K12 and K13 tolerances, the local density's CV within 1e-4 relative
    (the same sums run to run) and each particle's log-density under a
    bootstrap fit bit-equal to K14's on the same mixture; with ``whole`` a
    whole bisection (the kernels against the plain entries) ends at the
    same n with every probe's CV within 1e-4 relative."""
    import torch

    from pyabc_tpu_torch.kernels import bootstrap_cv, local_logpdf
    from pyabc_tpu_torch.kernels.bootstrap_cv import (
        MAX_PROBES, bootstrap_bisect_plain, bootstrap_draw_plain,
        LOCAL_DENSITY_ROWS, bootstrap_local_density_plain,
        bootstrap_local_gather_plain, local_fit, local_fit_buffers, n_probes,
        required_nr)
    from pyabc_tpu_torch.kernels.local_cov import field_plan

    x, dims, configs, model_p = local_refit(dev, K, n_cap, d, n_live,
                                            seed=31 + K, statics=statics)
    alive = [k for k in range(K) if model_p is None or float(model_p[k]) > 0]
    idx, state = bootstrap_cv.draw(x["cdf"], n_boot=nb, seed=5,
                                   generation=3, max_rounds=256, min_n=10,
                                   max_n=n_cap)
    rows, boot_w, go = bootstrap_cv.local_gather(x["thetas"], idx, state)
    rows_p, boot_w_p, go_p = bootstrap_local_gather_plain(x["thetas"], idx,
                                                          state)
    torch.cuda.synchronize()
    check(torch.equal(rows, rows_p) and torch.equal(boot_w, boot_w_p)
          and int(go) == int(go_p) == 1,
          f"K16 local gather ({label}) differs from its plain version")
    fits = local_fit(rows, boot_w, go, state,
                     local_fit_buffers(K, nb, n_cap, d, dev), dims=dims,
                     configs=configs)
    torch.cuda.synchronize()
    fit_err = fit_rel = cov_abs = 0.0
    t0 = time.perf_counter()
    for k in alive:
        for b in range(min(nb, K16_LOCAL_FITS_CHECKED)):
            kb = k * nb + b
            ref = local_fit_plain_of(rows, boot_w, kb, dims[k], configs[k])
            cov_abs = max(cov_abs, float((fits["covs"][kb] - ref["covs"])
                                         .abs().max()))
            got = {key: fits[key][kb] for key in ref if key != "dim"}
            same = (torch.equal(got["cnt"], ref["cnt"])
                    and torch.equal(got["thetas"], ref["thetas"]))
            cov_err = row_err(got["covs"], ref["covs"])
            live = ref["weights"] > 0
            prec_err = row_err(got["precs"][live], ref["precs"][live])
            check(same and cov_err <= 1e-4
                  and within(got["chols"], ref["chols"], 1e-5, 1e-4)
                  and prec_err <= 1e-3
                  and within(got["lconst"][live], ref["lconst"][live], 1e-4,
                             1e-4),
                  f"K16 local fit ({label}, model {k}, bootstrap {b}): "
                  f"selection equal {same}, covariance error {cov_err:.3e} "
                  f"of the row scale, precision {prec_err:.3e}")
            fit_err = max(fit_err, float((got["chols"] - ref["chols"])
                                         .abs().max()))
            fit_rel = max(fit_rel, cov_err, prec_err)
    fit_plain_s = time.perf_counter() - t0
    part, ld = bootstrap_cv.local_density(x["thetas"], x["weights"], fits,
                                          state, want_ld=True)
    again = bootstrap_cv.local_density(x["thetas"], x["weights"], fits,
                                       state)
    part_p = bootstrap_local_density_plain(x["thetas"], x["weights"], fits,
                                           state)
    torch.cuda.synchronize()
    check(torch.equal(part, again), f"K16 local density ({label}): sums "
          f"differ from run to run")

    def cv_of(p):
        return p[..., 0].sum(1) / p[..., 1].sum(1).clamp_min(1e-38)

    cv_k, cv_p = cv_of(part)[alive], cv_of(part_p)[alive]
    check(within(cv_k, cv_p, 0.0, 1e-4)
          and within(part[..., 1], part_p[..., 1], 1e-7, 1e-5),
          f"K16 local density ({label}): CV outside 1e-4 relative "
          f"({cv_k.tolist()} vs {cv_p.tolist()})")
    cv_err = float((cv_k - cv_p).abs().max())
    cv_rel = float(((cv_k - cv_p).abs() / cv_p.abs().clamp_min(1e-30)).max())
    # each live particle's log-density under a bootstrap fit is K14's on
    # that fit, bit for bit (the tile loop of csrc/local_mix.cuh)
    for k in alive:
        live = x["weights"][k] > 0
        for b in range(min(nb, 2)):
            kb = k * nb + b
            k14 = local_logpdf(x["thetas"][k].contiguous(), {
                key: fits[key][kb] for key in ("thetas", "precs", "lconst",
                                               "weights")})
            check(torch.equal(ld[kb][live], k14[live]),
                  f"K16 local density ({label}, model {k}, bootstrap "
                  f"{b}): a log-density differs from K14's on the same "
                  f"mixture")
    out = {"errors": {"local_gather": (0.0, 0.0),
                      "local_density": (cv_err, cv_rel),
                      "local_cov:bootstrap": (cov_abs, fit_rel),
                      "local_factor:bootstrap": (fit_err, fit_rel)}}
    probes_done = None
    if whole:
        target = 1.5 * float(cv_of(part_p)[alive].mean())
        rkw = dict(seed=5, generation=3, max_rounds=256, target_cv=target,
                   min_n=10, max_n=n_cap, n_bootstrap=nb)
        res = required_nr(x["thetas"], x["weights"], x["cdf"], dims=dims,
                          statics=None, model_p=model_p, local=configs,
                          **rkw)
        idx_p, st_p = bootstrap_draw_plain(
            x["cdf"], n_boot=nb, seed=5, generation=3, max_rounds=256,
            min_n=10, max_n=n_cap)
        cvs_p = torch.zeros(MAX_PROBES, device=dev)
        fits_p = local_fit_buffers(K, nb, n_cap, d, dev)
        for _ in range(n_probes(10, n_cap)):
            r_p, w_p, _g = bootstrap_local_gather_plain(x["thetas"], idx_p,
                                                        st_p)
            if not int(st_p[3]):
                for k in range(K):
                    for b in range(nb):
                        f = local_fit_plain_of(r_p, w_p, k * nb + b,
                                               dims[k], configs[k])
                        for key in ("thetas", "precs", "lconst",
                                    "weights"):
                            fits_p[key][k * nb + b].copy_(f[key])
            pp = bootstrap_local_density_plain(x["thetas"], x["weights"],
                                               fits_p, st_p)
            bootstrap_bisect_plain(pp, st_p, cvs_p, model_p=model_p,
                                   target=target)
        torch.cuda.synchronize()
        probes_done = int(res["state"][4])
        check(torch.equal(res["state"], st_p),
              f"K16 local ({label}): the bisection's state "
              f"{res['state'].tolist()} differs from the plain entries' "
              f"{st_p.tolist()}")
        check(within(res["cvs"][:probes_done], cvs_p[:probes_done], 1e-7,
                     1e-4), f"K16 local ({label}): a probe's CV outside "
              f"1e-4 relative")
    log(f"K16 LocalTransition mode ({label}: K={K}, n_cap={n_cap}, d={d}, "
        f"{nb} bootstraps, {n_live} weighted rows, k_cap "
        f"{configs[0]['k_cap']}, "
        f"{'top-k' if configs[0]['topk'] else 'threshold'} stride "
        f"{configs[0]['stride']}): gather bit-equal; fits (K12, K13 of "
        f"{min(nb, K16_LOCAL_FITS_CHECKED)} bootstraps a model) chols "
        f"max_abs_err={fit_err:.3e}, covariance/precision error "
        f"{fit_rel:.3e} of the row scale; CV {cv_k.tolist()} max_rel_err="
        f"{cv_rel:.3e}; log-densities bit-equal to K14's"
        + (f"; whole bisection to n={int(res['n_next'])} in {probes_done} "
           f"probes, state equal to the plain entries'" if whole else ""))
    plan = field_plan(n_cap, d, topk=configs[0]["topk"],
                      stride=configs[0]["stride"], k_cap=configs[0]["k_cap"])
    log(f"K16 LocalTransition mode ({label}): K12 {plan_text(plan)}; local "
        f"density R={LOCAL_DENSITY_ROWS} particles a thread, a block per "
        f"(256-particle tile, bootstrap, model): {n_blocks_of(n_cap)} x "
        f"{nb} x {K} blocks, the CV in each tile's last block (ticket mode)")
    if not timed:
        return out
    live = int((x["weights"] != 0).sum())
    cnt_sum = float(fits["cnt"].to(torch.float64).sum())
    b_g, b_c, b_f, b_d, b_c_old = k16_local_bound(K, nb, n_cap, d, live,
                                                  configs, cnt_sum)
    gather = lambda: bootstrap_cv.local_gather(  # noqa: E731
        x["thetas"], idx, state)
    gather_p = lambda: bootstrap_local_gather_plain(  # noqa: E731
        x["thetas"], idx, state)
    cov, factor = fit_parts(rows, boot_w, go, fits, dims, configs,
                            range(K * nb))
    dens = lambda: bootstrap_cv.local_density(  # noqa: E731
        x["thetas"], x["weights"], fits, state)
    dens_p = lambda: bootstrap_local_density_plain(  # noqa: E731
        x["thetas"], x["weights"], fits, state)
    # the plain fits' time scaled from the fits checked to the probe's
    fit_plain_ms = (fit_plain_s * 1e3 * K * nb
                    / max(len(alive) * min(nb, K16_LOCAL_FITS_CHECKED), 1))
    calls = {
        "local_gather": (gather, time_ms(gather_p, 2, warmup=1), b_g),
        "local_cov:bootstrap": (cov, fit_plain_ms, b_c),
        "local_factor:bootstrap": (factor, None, b_f),
        "local_density": (dens, time_ms(dens_p, 2, warmup=1), b_d)}
    for entry, (fn, plain_ms, bnd) in calls.items():
        out[entry] = dict(call_ms=time_ms(fn, 3, warmup=1),
                          ms=graph_ms(fn, iters=3, replays=2),
                          plain_ms=plain_ms, bound=bnd, library_ms=None)
    # the plain K12 and K13 ran as one: their time splits as the kernels'
    share = out["local_factor:bootstrap"]["ms"] / max(
        out["local_factor:bootstrap"]["ms"]
        + out["local_cov:bootstrap"]["ms"], 1e-9)
    out["local_factor:bootstrap"]["plain_ms"] = fit_plain_ms * share
    out["local_cov:bootstrap"]["plain_ms"] = fit_plain_ms * (1 - share)
    for entry, r in out.items():
        if entry == "errors":
            continue
        log(f"K16 {entry} ({label}): ms={r['ms']:.5f} call_ms="
            f"{r['call_ms']:.5f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})"
            + (f", the block-a-row design's bound {b_c_old[0]:.6f}"
               if entry == "local_cov:bootstrap" else "")
            + (f", {live * nb * n_cap} density pairs"
               if entry == "local_density" else "")
            + (f", {K * nb} launches"
               if entry.endswith(":bootstrap") else ""))
    probe = sum(out[e]["ms"] for e in calls)
    out["probe_ms"] = probe
    log(f"K16 LocalTransition mode ({label}): device ms per probe at n = "
        f"n_cap (gather, fits, density; the bisect step apart) "
        f"{probe:.4f}")
    return out


def k16_local_checks(dev) -> dict:
    """K16's LocalTransition mode at the LV local adaptive leg's full shape
    (n_cap 16384, 10 bootstraps, d 4, k_cap 4096, threshold at stride 4;
    every row weighted: the first probe's n is 16384), at config 5's (K 3,
    d_max 2, n_cap 4096, k_cap 1024, one model dead) and at a small odd
    shape (n_cap 100, 3 bootstraps, d 1, 37 weighted rows, a whole
    bisection), and a whole bisection at n_cap 512 (K 3)."""
    full = k16_local_case(dev, "LV local adaptive leg", 1, ADA_MAX, 4,
                          ADA_BOOT, ADA_MAX, LOCAL_ADA_STATICS, timed=True,
                          whole=False)
    k3 = k16_local_case(dev, "config 5 local adaptive leg", 3, C5A_MAX, 2,
                        ADA_BOOT, C5A_MAX, C5_LOCAL_STATICS, timed=False,
                        whole=False)
    small = k16_local_case(dev, "small odd shape", 1, 100, 1, 3, 37,
                           dict(LOCAL_ADA_STATICS, k_cap=10), timed=False,
                           whole=True)
    k3_small = k16_local_case(dev, "K 3 at n_cap 512", 3, 512, 2, 4, 512,
                              dict(C5_LOCAL_STATICS, k_cap=128),
                              timed=False, whole=True)
    out = {}
    for e in ("local_gather", "local_density", "local_cov:bootstrap",
              "local_factor:bootstrap"):
        errs = [case["errors"][e] for case in (full, k3, small, k3_small)]
        name = e if ":" in e else f"bootstrap_cv:{e}"
        out[name] = {**full[e], "err": max(a for a, _r in errs),
                     "rel": max(r for _a, r in errs),
                     "probe_ms": full["probe_ms"]}
    return out


def local_models_checks(dev) -> dict:
    """LocalTransition over config 5's models at its shapes (K 3, d_max 2,
    n_cap 4096, B of a round at n 4096, model 1 dead): K15's K > 1 mode
    (drift 1e-5 + 1e-4 relative, decisions and masked weights equal), the
    per-model K12 and K13 (selections equal, covariances 1e-4 of the row
    scale, factors as phase 2's, a flagged-off model's params carried
    bit for bit, rows factorized equal), K2's K > 1 local mode (models
    equal away from a CDF step, theta 1e-5 + 1e-5 relative), K14's K > 1
    mode (1e-4 + 1e-5 relative) and K26 with K15's fitted mask, each timed
    -> results keyed "name:models"."""
    import torch

    from pyabc_tpu_torch.kernels import (local_cov, local_factor,
                                         local_logpdf, model_step,
                                         model_step_plain, philox,
                                         proposal_drift, propose_local)
    from pyabc_tpu_torch.kernels.propose import propose_models_plain
    from pyabc_tpu_torch.kernels.bootstrap_cv import local_fit_buffers
    from pyabc_tpu_torch.kernels.local_cov import local_cov_plain
    from pyabc_tpu_torch.kernels.local_factor import local_factor_plain
    from pyabc_tpu_torch.kernels.local_logpdf import (
        local_logpdf_models_plain)
    from pyabc_tpu_torch.kernels.proposal_drift import (
        proposal_drift_models_plain)
    from pyabc_tpu_torch.transition import LocalTransition
    from pyabc_tpu_torch.utils import pick_batch

    K, d, n = K_MODELS, D_MAX_C5, C5A_MAX
    B = pick_batch(n)
    x = model_round(dev, B, n, K, d, S_C5, n_keep=n - 96, seed=41)
    m = x["res_m"].clone()
    m[m == 1] = 2
    theta = x["res_theta"].clone()
    theta[m == 0, 1:] = 0.0
    dims = [1, 2, 2]
    dims_f = torch.tensor([float(v) for v in dims], device=dev)
    configs = [LocalTransition.field_config(n, dk, device=dev,
                                            **C5_LOCAL_STATICS)
               for dk in dims]
    mins = [dk + 1 for dk in dims]
    zero = LocalTransition.zero_params_models(K, n, d, dims_f)
    g0 = torch.zeros((), dtype=torch.int32, device=dev)
    unfit = torch.zeros(K, dtype=torch.bool, device=dev)
    dec0 = proposal_drift.models(zero["thetas"], zero["weights"], theta,
                                 x["w"], x["k_mask"], m, dims=dims,
                                 fitted=unfit, gens_since=g0, every=16,
                                 thr=0.3, min_counts=mins)
    prev, _r = LocalTransition.device_fit_models(
        theta, dec0["w_models"], zero, dec0["flag"], dims=dims,
        configs=configs, incremental=False)
    check(dec0["flag"].tolist() == [1, 0, 1], "K15 K > 1: the first "
          "decision does not refit the live models")
    # the next generation: the population moved, model 1 still dead
    theta1 = (theta * 1.05).contiguous()
    kw = dict(dims=dims, fitted=dec0["fitted"], gens_since=g0, every=16,
              thr=0.3, min_counts=mins)
    args = (prev["thetas"], prev["weights"], theta1, x["w"], x["k_mask"], m)
    dec = proposal_drift.models(*args, **kw)
    dec_p = proposal_drift_models_plain(*args, **kw)
    torch.cuda.synchronize()
    drift_err = float((dec["drift"] - dec_p["drift"]).abs())
    check(within(dec["drift"], dec_p["drift"], 1e-5, 1e-4)
          and all(torch.equal(dec[k], dec_p[k]) for k in
                  ("refit", "flag", "gens_since", "fitted", "w_models")),
          f"K15 K > 1 differs from its plain version (drift "
          f"{float(dec['drift'])} vs {float(dec_p['drift'])})")
    out = {}
    timed = lambda fn: (time_ms(fn, 20), graph_ms(fn, 20, 3))  # noqa: E731
    t0 = time.perf_counter()
    proposal_drift_models_plain(*args, **kw)
    torch.cuda.synchronize()
    call, ms = timed(lambda: proposal_drift.models(*args, **kw))
    out["proposal_drift:models"] = dict(
        err=drift_err, call_ms=call, ms=ms,
        plain_ms=(time.perf_counter() - t0) * 1e3,
        bound=bound((K * n * (d + 1) + n * (d + 2) + 2 * n + K * n) * 4,
                    2 * K * 2 * n * (3 * d + 1)),
        library_ms=None)
    log(f"K15 proposal_drift K>1 (K={K}, n={n}, d_max={d}): drift "
        f"{float(dec['drift']):.5f} error {drift_err:.3e}; refit "
        f"{bool(dec['refit'])}, flags {dec['flag'].tolist()}, fitted "
        f"{dec['fitted'].tolist()}; decisions and masked weights equal")
    # the per-model refit: a refit of every row (flags forced on where the
    # model has rows) and, with the decision's flags, incrementally
    flags = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    errs = {}
    for inc in (False, True):
        got, rows = LocalTransition.device_fit_models(
            theta1, dec["w_models"], prev, flags, dims=dims,
            configs=configs, incremental=inc)
        t0 = time.perf_counter()
        rows_p = 0
        for k in range(K):
            prev_k = {key: prev[key][k].clone() for key in prev
                      if key != "dims"}
            field = local_cov_plain(theta1, dec["w_models"][k], **configs[k])
            ref, nch = local_factor_plain(field, prev_k, dim=dims[k],
                                          incremental=inc, flag=flags[k])
            rows_p += int(nch)
            if k == 1:
                check(all(torch.equal(got[key][1], prev[key][1]) for key in
                          ("thetas", "weights", "cdf", "chols", "precs",
                           "logdets", "lconst")),
                      "K12/K13 K > 1: a flagged-off model's params are not "
                      "carried forward")
                continue
            live = ref["weights"] > 0
            errs[(inc, k)] = (
                float((got["chols"][k] - ref["chols"]).abs().max()),
                row_err(got["precs"][k][live], ref["precs"][live]))
            check(torch.equal(got["thetas"][k], ref["thetas"])
                  and within(got["chols"][k], ref["chols"], 1e-5, 1e-4)
                  and errs[(inc, k)][1] <= 1e-3
                  and within(got["logdets"][k], ref["logdets"], 1e-3, 1e-4),
                  f"K12/K13 K > 1 (model {k}, incremental {inc}) outside "
                  f"tolerance")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(int(rows) == rows_p, f"K13 K > 1: rows factorized {int(rows)} "
              f"differ from the plain versions' {rows_p}")
        log(f"K12/K13 K>1 (incremental {inc}, n={n}, dims {dims}, k_cap "
            f"{configs[0]['k_cap']}): rows factorized {int(rows)}; chols "
            f"and precisions errors {errs}")
    # each model's K12 then K13, on their own (the refit of every row)
    bufs = local_fit_buffers(K, 1, n, d, dev)
    fld = {key: bufs[key] for key in ("thetas", "weights", "cdf", "covs",
                                      "cnt")}
    fac = {key: bufs[key] for key in ("chols", "precs", "logdets",
                                      "lconst")}

    def cov():
        for k in range(K):
            local_cov(theta1, dec["w_models"][k], flag=flags[k],
                      mode="models",
                      out={key: v[k] for key, v in fld.items()},
                      **configs[k])

    def factor():
        for k in range(K):
            local_factor({key: v[k] for key, v in fld.items()},
                         {key: prev[key][k] for key in prev
                          if key != "dims"}, dim=dims[k],
                         incremental=False, flag=flags[k], mode="models",
                         out={key: v[k] for key, v in fac.items()})

    cov()
    cnt = float(fld["cnt"][[0, 2]].to(torch.float64).sum())
    _g, b_cov, b_fac, _d, b_cov_old = k16_local_bound(
        2, 1, n, d, 0, [configs[0], configs[2]], cnt)
    share = {}
    for name, fn, bnd in (("local_cov:models", cov, b_cov),
                          ("local_factor:models", factor, b_fac)):
        call, ms = timed(fn)
        share[name] = ms
        out[name] = dict(err=max(v[0] for v in errs.values()),
                         rel=max(v[1] for v in errs.values()), call_ms=call,
                         ms=ms, bound=bnd, library_ms=None)
    log(f"K12 local_cov:models bound_ms={b_cov[0]:.6f} ({b_cov[1]}; the "
        f"block-a-row design's bound {b_cov_old[0]:.6f})")
    tot = max(sum(share.values()), 1e-9)
    for name in share:
        # the plain K12 and K13 ran as one: their time splits as the
        # kernels'
        out[name]["plain_ms"] = plain_s * 1e3 * share[name] / tot
    # K26 under K15's fitted mask
    mpk = _mpk(dev, K)
    step = model_step(m, x["w"], x["k_mask"], dec0["fitted"], mpk,
                      fitted_next=dec["fitted"])
    step_p = model_step_plain(m, x["w"], x["k_mask"], dec0["fitted"], mpk,
                              fitted_next=dec["fitted"])
    torch.cuda.synchronize()
    check(torch.equal(step["fitted"], dec["fitted"])
          and torch.equal(step["counts"], step_p["counts"])
          and within(step["matrix"], step_p["matrix"], 1e-7, 1e-5)
          and within(step["log_model_factor"].exp(),
                     step_p["log_model_factor"].exp(), 1e-7, 1e-5),
          "K26 with K15's fitted mask differs from its plain version")
    # K2's K > 1 local mode and K14's K > 1 mode on these fits
    log_p = step["log_model_probs"]
    err, got_draw = compare_propose_models(dev, B, x["priors"], log_p,
                                           prev, step["matrix"],
                                           local=True)
    th_k, _lp, _v, m_k = got_draw
    st = stream_on(dev, philox.TRANSITION)
    out["propose_local:models"] = dict(
        err=err, **dict(zip(("call_ms", "ms"), timed(
            lambda: propose_local.models(st, B, x["priors"], log_p, prev,
                                         step["matrix"])))),
        plain_ms=time_ms(lambda: propose_models_plain(
            st, B, x["priors"], log_p, prev, step["matrix"], local=True),
            2, 1),
        bound=bound(K * n * (1 + d + d * d) * 4 + B * (d + 3) * 4,
                    B * 300), library_ms=None)
    q = th_k.contiguous()
    got = local_logpdf.models(q, m_k, prev)
    t0 = time.perf_counter()
    ref = local_logpdf_models_plain(q, m_k, prev)
    torch.cuda.synchronize()
    dens_plain_s = time.perf_counter() - t0
    dens_err = float((got - ref).abs().nan_to_num(0.0).max())
    check(within(got, ref, 1e-4, 1e-5), "K14 K > 1 differs from its plain "
          "version beyond 1e-4 + 1e-5 relative")
    live = (prev["weights"] > 0).sum(1).to(torch.float64)
    pairs = float(live[m_k.long()].sum())
    call, ms = timed(lambda: local_logpdf.models(q, m_k, prev))
    out["local_logpdf:models"] = dict(
        err=dens_err, call_ms=call, ms=ms, plain_ms=dens_plain_s * 1e3,
        bound=bound((B * (d + 1) + K * n * (d * d + d + 2) + B) * 4,
                    pairs * (3 * d + 2 * d * d + 4)), library_ms=None)
    log(f"K14 local_logpdf K>1 ({B} lanes x K={K} fits of {n}): error "
        f"{dens_err:.3e}, {pairs:.0f} live lane-component pairs; K2 local "
        f"K>1 theta error {err:.3e}")
    for name, r in out.items():
        log(f"{name}: ms={r['ms']:.5f} call_ms={r['call_ms']:.5f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound'][0]:.6f} "
            f"({r['bound'][1]})")
    return out


def _mpk(dev, K: int):
    """The ModelPerturbationKernel's matrix of K models (probability 0.7 to
    stay), as the runs use it."""
    import torch

    from pyabc_tpu_torch.transition import ModelPerturbationKernel

    return torch.as_tensor(ModelPerturbationKernel(K, 0.7).device_params(),
                           dtype=torch.float32, device=dev)


def local_adaptive_cpu_trails(dev) -> None:
    """The LV and config 5 local adaptive legs at LOCAL_CPU_POP (start and
    cap) on the card (every plain version raising) and on the CPU (plain
    versions, the same Philox streams), two generations: the first two
    epsilons within 1e-3 relative."""
    for label, make in (
            ("LV local adaptive", lambda where: adaptive_lv(
                where, local=True, start=LOCAL_CPU_POP,
                cap=LOCAL_CPU_POP)),
            ("config 5 local adaptive", lambda where: config5_adaptive(
                where, local=True, start=LOCAL_CPU_POP,
                cap=LOCAL_CPU_POP))):
        trails = {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            abc = make(where)
            with (plain_versions_raise() if where == dev
                  else contextlib.nullcontext()):
                h = abc.run(max_nr_populations=2)
            trails[str(where)] = ([float(e) for e in
                                   h.get_all_populations()["epsilon"][1:]],
                                  time.perf_counter() - t0)
        card, cpu = trails[str(dev)][0], trails["cpu"][0]
        rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        log(f"{label} at pop {LOCAL_CPU_POP} (2 generations): card eps "
            f"{card}, CPU eps {cpu} ({trails['cpu'][1]:.1f} s); |card - "
            f"cpu| / cpu {[float(f'{r:.2e}') for r in rel]}")
        check(len(rel) == 2 and max(rel) <= 1e-3,
              f"{label}: the CPU's first two epsilons differ from the "
              f"card's by more than 1e-3")


# ----------------------------------------- aggregated distances (K25)
#: the LV aggregated legs: LV config 2 (bench.py:119-127) with its distance
#: swapped for an aggregate of a p 2 norm on the predators and a p 1 norm
#: on the prey, MedianEpsilon, pop 16384 (the scale lane's and the LV
#: adaptive leg's, not cut), 8 generations (cut for the script's time
#: limit), seed 0
AGG_POP, AGG_GENS = 16384, 8
#: the card-and-CPU comparison of the adaptive leg's weight trail: the
#: plain K3 over 16384 rows would take minutes on the CPU
AGG_CPU_POP, AGG_CPU_GENS = 1024, 4
#: the LV path under an aggregated distance: K25's accept in K5's place
#: and, adaptive, its refit in K9's
AGG_PATH = ("propose", "mvn_mixture_logpdf", "lv_simulate",
            "aggregate_accept_weight", "compact_round", "normalize_quantile",
            "mvn_fit", "aggregate_refit", "pack_fetch", "generation_health")
#: config 3 under the aggregated pair of tests/test_segment.py:114-121
C3AGG_PATH = ("propose", "mvn_mixture_logpdf", "segment_round", "tau_leap",
              "aggregate_accept_weight", "compact_round",
              "normalize_quantile", "mvn_fit", "pack_fetch",
              "generation_health")
AGG_KERNELS = ("aggregate_accept_weight", "aggregate_refit")
#: K25 accept's checks at the LV leg's round (B 65536, S 40): the LV
#: legs' pair, and 2 and 4 sub-distances of mixed p
AGG_CASES = {"LV legs' pair (p 2, 1)": None,
             "2 sub-distances (p 2, inf)": (2.0, math.inf),
             "4 sub-distances (p 1, 2, inf, 3)": (1.0, 2.0, math.inf, 3.0)}
#: the refit's scales (the default span first: the LV adaptive leg's)
AGG_SCALES = ("span", "standard_deviation", "median_absolute_deviation")


def lv_subs(pt) -> list:
    """The LV legs' sub-distances: p 2 on the predators, p 1 on the prey."""
    return [pt.PNormDistance(p=2, weights={"pred": 1, "prey": 0}),
            pt.PNormDistance(p=1, weights={"pred": 0, "prey": 1})]


def lv_aggregate(where, kind: str, pop: int = AGG_POP,
                 sharded: int | None = None, G: int | None = None,
                 seed: int = 0, refit_every: int | None = None):
    """LV config 2 under ``AdaptiveAggregatedDistance(lv_subs)`` (kind
    "adaptive") or under tests/test_fused.py:324-345's schedule at LV's
    labels (kind "schedule", float32 fetch, the statistics stored);
    ``sharded`` shards, ``G`` generations a chunk (the default else)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    kw = {}
    if kind == "adaptive":
        dist = pt.AdaptiveAggregatedDistance(lv_subs(pt))
    else:
        dist = pt.AggregatedDistance(
            [pt.PNormDistance(p=2, weights={0: {"pred": 1, "prey": 0},
                                            3: {"pred": 2, "prey": 0}}),
             pt.PNormDistance(p=1)], weights={0: [1, 1], 2: [4, 0.1]})
        kw = {"fetch_dtype": "float32"}
    if G is not None:
        kw["fused_generations"] = G
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(), dist,
                    population_size=pop, eps=pt.MedianEpsilon(), seed=seed,
                    sharded=sharded, refit_every=refit_every, device=where,
                    **kw)
    abc.new("sqlite://", lv.observed_data(seed=0),
            store_sum_stats=kind == "schedule")
    return abc


def lv_rows(dev, B: int, seed: int):
    """A prior round of LV config 2 on the card (K2, K4): its (B, 40)
    statistics, the spec and x0."""
    import torch

    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import lv_simulate, philox, propose
    from pyabc_tpu_torch.models import lotka_volterra as lv

    model, prior = lv.make_lv_model(), lv.default_prior()
    theta = propose(stream_on(dev, philox.PRIOR, seed=seed), B,
                    prior.arrays(dev))[0]
    ss = lv_simulate(theta, None, stream=stream_on(dev, philox.SIM_NOISE,
                                                   seed=seed),
                     n_obs=model.n_obs, n_substeps=model.n_substeps,
                     dt=model.dt, y0=lv.Y0, noise_sd=model.noise_sd,
                     log_parameters=False)
    obs = lv.observed_data(seed=0)
    spec = SumStatSpec(obs)
    x0 = torch.as_tensor(spec.flatten_host(obs), dtype=torch.float32,
                         device=dev)
    return ss, spec, x0


def k25_checks(dev) -> dict:
    """K25 against its plain versions. Accept at the LV legs' round (B
    65536, S 40) for the legs' pair and for 2 and 4 sub-distances of mixed
    p (random sub weights): distances within 1e-5 relative, flags equal
    away from eps, log weights equal, the values mode within 1e-5. Refit
    over the LV adaptive leg's ring (131072 rows, the last 20000 not yet
    written) and reservoir (16384 rows) for span, standard_deviation and
    median_absolute_deviation: scales, W and distances within 1e-5 of the
    plain refit, and the scale bit-equal to the plain scale of the
    kernel's own values for span and the median."""
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.distance import scale as scales
    from pyabc_tpu_torch.kernels import (aggregate_accept_weight,
                                         aggregate_accept_weight_plain,
                                         aggregate_refit,
                                         aggregate_refit_plain)
    from pyabc_tpu_torch.kernels.aggregate import sub_distances_plain
    from pyabc_tpu_torch.kernels.scale_reduce import SCALES_PLAIN
    from pyabc_tpu_torch.utils import pick_batch, pow2_bucket

    B = pick_batch(AGG_POP)
    ss, spec, x0 = lv_rows(dev, B, seed=25)
    S = spec.total_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    logpri = torch.randn(B, generator=gen, device=dev) - 3.0
    logq = torch.randn(B, generator=gen, device=dev) - 2.0
    out = {}
    for label, ps in AGG_CASES.items():
        if ps is None:
            dist = pt.AggregatedDistance(lv_subs(pt))
        else:
            subs = [pt.PNormDistance(p=p, weights=torch.rand(
                S, generator=gen, device=dev).cpu().numpy() + 0.2)
                for p in ps]
            dist = pt.AggregatedDistance(
                subs, weights=torch.rand(len(ps), generator=gen,
                                         device=dev).cpu().numpy() + 0.5)
        dist.initialize(spec)
        params = dist.device_params(0, dev)
        d_all = aggregate_accept_weight_plain(
            ss, x0, params, torch.tensor(math.inf, device=dev), valid,
            ps=dist.ps)[0]
        eps = torch.quantile(d_all[torch.isfinite(d_all)], 0.5)
        args = (ss, x0, params, eps, valid)
        kw = dict(ps=dist.ps, logpri=logpri, logq=logq)
        d_k, a_k, lw_k = aggregate_accept_weight(*args, **kw)
        d_p, a_p, lw_p = aggregate_accept_weight_plain(*args, **kw)
        v_k = aggregate_accept_weight.values(ss, x0, params, ps=dist.ps)
        v_p = sub_distances_plain(ss, x0, params, dist.ps)
        torch.cuda.synchronize()
        far = (d_p - eps).abs() > 1e-5 * eps
        flags = bool((a_k == a_p)[far].all())
        err = abs_err(d_k, d_p)
        log(f"K25 aggregate_accept_weight {label} (B={B}, S={S}): "
            f"max_abs_err(d)={err:.3e} values mode {abs_err(v_k, v_p):.3e} "
            f"accepted={int(a_k.sum())} flags equal away from eps {flags}")
        check(within(d_k, d_p, 0.0, 1e-5) and within(v_k, v_p, 0.0, 1e-5)
              and flags and torch.equal(lw_k, lw_p),
              f"K25 accept ({label}): distances or values outside 1e-5 "
              f"relative, flags or log weights differ")
        if ps is not None:
            continue
        n_sub = len(dist.ps)
        nbytes = (B * S + S + n_sub * (S + 1)) * 4 + B * (1 + 4 + 4) + 4 \
            + B * (4 + 1 + 4)
        out["aggregate_accept_weight"] = dict(
            err=err, call_ms=time_ms(lambda: aggregate_accept_weight(
                *args, **kw), 50),
            ms=graph_ms(lambda: aggregate_accept_weight(*args, **kw)),
            plain_ms=time_ms(lambda: aggregate_accept_weight_plain(
                *args, **kw), 10),
            bound=bound(nbytes, B * S * n_sub * 4), library_ms=None)

    # the refit over the LV adaptive leg's ring and reservoir
    rec_cap = pow2_bucket(8 * AGG_POP, 256)
    ring = torch.cat([ss, lv_rows(dev, rec_cap - B, seed=26)[0]])
    ring_valid = torch.ones(rec_cap, dtype=torch.bool, device=dev)
    ring_valid[-20000:] = False
    ring[-20000:] = 1e6  # rows not yet written: the scale must not see them
    rows = lv_rows(dev, B, seed=27)[0][:AGG_POP].contiguous()
    fns = {"span": None, "standard_deviation": scales.standard_deviation,
           "median_absolute_deviation": scales.median_absolute_deviation}
    for name in AGG_SCALES:
        kw = {} if fns[name] is None else {"scale_function": fns[name]}
        dist = pt.AdaptiveAggregatedDistance(lv_subs(pt), **kw)
        dist.initialize(spec)
        params = dist.device_params(0, dev)
        rkw = dict(ps=dist.ps, factors=tuple(dist.factors),
                   scale_name=name, rows=rows)
        sc_k, new_k, d_k = aggregate_refit(ring, ring_valid, x0, params,
                                           **rkw)
        sc_p, new_p, d_p = aggregate_refit_plain(ring, ring_valid, x0,
                                                 params, **rkw)
        vals = aggregate_accept_weight.values(ring, x0, params, ps=dist.ps)
        own = SCALES_PLAIN[name](vals, ring_valid,
                                 torch.zeros(2, device=dev))
        torch.cuda.synchronize()
        err = max(abs_err(sc_k, sc_p), abs_err(new_k, new_p),
                  abs_err(d_k, d_p))
        exact = equal_nan(sc_k, own)
        log(f"K25 aggregate_refit {name} (ring {rec_cap} x {S}, "
            f"{int(ring_valid.sum())} valid, reservoir {AGG_POP}): scale "
            f"{sc_k.tolist()} W {new_k[:2].tolist()} max_abs_err={err:.3e}; "
            f"scale bit-equal to the plain scale of the kernel's values "
            f"{exact}")
        check(within(sc_k, sc_p, 0.0, 1e-5) and within(new_k, new_p, 0.0,
                                                       1e-5)
              and within(d_k, d_p, 0.0, 1e-5),
              f"K25 refit ({name}): scale, W or distances outside 1e-5 "
              f"relative of the plain refit")
        if name != "standard_deviation":
            check(exact, f"K25 refit ({name}): the scale differs from the "
                  f"plain {name} of the kernel's own values")
        if name != "span":
            continue
        P = params.numel()
        nbytes = ((rec_cap * S + AGG_POP * S + S + 2 * P) * 4 + rec_cap
                  + (2 + AGG_POP) * 4)
        out["aggregate_refit"] = dict(
            err=err, call_ms=time_ms(lambda: aggregate_refit(
                ring, ring_valid, x0, params, **rkw), 20),
            ms=graph_ms(lambda: aggregate_refit(ring, ring_valid, x0,
                                                params, **rkw), iters=20),
            plain_ms=time_ms(lambda: aggregate_refit_plain(
                ring, ring_valid, x0, params, **rkw), 5),
            bound=bound(nbytes, (rec_cap + AGG_POP) * S * 2 * 4),
            library_ms=None)
    return out


def k16_repair_inputs(dev):
    """tests/test_torch_population.py's model-weighted case (n_cap 128,
    K 3 with dims 1, 2, 2 on d_max 2, model 1 dead, 5 bootstraps) with
    numpy ancestors, model 2's bootstrap 3 starting at rows 71, 22, 71: at
    n = 3 two distinct rows in two dimensions, a rank-1 covariance that
    only the jitter ladder's last rung factorizes."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import mvn_fit
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    n_cap, K, nb = 128, 3, 5
    rng = np.random.default_rng(21)
    th = (rng.normal(size=(n_cap, 2)) * np.linspace(0.5, 2.0, 2)
          + 1).astype(np.float32)
    w = (rng.random(n_cap) + 0.1).astype(np.float32)
    w = w / w.sum()
    m = (np.arange(n_cap) % K).astype(np.int32)
    m[m == 1] = 2
    th[m == 0, 1] = 0.0
    st = {"scaling": 1.0, "bandwidth_selector": silverman_rule_of_thumb}
    fit = mvn_fit.models(torch.from_numpy(th).to(dev),
                         torch.from_numpy(w).to(dev),
                         torch.from_numpy(m).to(dev), dims=[1, 2, 2],
                         statics=[st] * K)
    draw = np.random.default_rng(5)
    idx = np.zeros((K, nb, n_cap), np.int32)
    for k in (0, 2):
        live = np.flatnonzero(m == k)
        idx[k] = draw.choice(live, size=(nb, n_cap),
                             p=w[live] / w[live].sum())
    idx[2, 3, :3] = (71, 22, 71)
    probs = torch.tensor([w[m == k].sum() for k in range(K)], device=dev)
    return fit, torch.from_numpy(idx).to(dev), [1, 2, 2], [st] * K, probs


def k16_repair_case(dev) -> None:
    """The K16 repair case on the card: each live model's CV at n = 3 from
    the kernels' fit and density and from the plain versions', both
    finite and within 1e-4 relative (the density alone on the plain fit
    too), and the aggregate CV of the bisect step from each."""
    import torch

    from pyabc_tpu_torch.kernels import bootstrap_cv
    from pyabc_tpu_torch.kernels.bootstrap_cv import (
        MAX_PROBES, bootstrap_bisect_plain, bootstrap_density_plain,
        bootstrap_fit_plain)

    fit0, idx, dims, statics, probs = k16_repair_inputs(dev)
    th, w = fit0["thetas"], fit0["weights"]
    state = torch.tensor([10, 128, 3, 0, 0], dtype=torch.int32, device=dev)
    fit_k = bootstrap_cv.fit(th, idx, state, dims=dims, statics=statics)
    fit_p = bootstrap_fit_plain(th, idx, state, dims=dims, statics=statics)
    part_k = bootstrap_cv.density(th, w, fit_k, state)
    part_kp = bootstrap_cv.density(th, w, fit_p, state)
    part_p = bootstrap_density_plain(th, w, fit_p, state)
    cvs = {}
    for tag, part in (("kernels", part_k), ("plain", part_p)):
        c = torch.zeros(MAX_PROBES, device=dev)
        (bootstrap_cv.bisect if tag == "kernels" else
         bootstrap_bisect_plain)(part, state.clone(), c, model_p=probs,
                                 target=1e9)
        cvs[tag] = c[0]
    torch.cuda.synchronize()

    def cv_of(p):
        return p[..., 0].sum(1) / p[..., 1].sum(1).clamp_min(1e-38)

    alive = [0, 2]
    ck, ckp, cp = cv_of(part_k)[alive], cv_of(part_kp)[alive], \
        cv_of(part_p)[alive]
    log(f"K16 repair case (model 2's bootstrap 3 of rank 1 at n = 3): "
        f"logdet kernel {float(fit_k['logdet'][2, 3]):.4f} plain "
        f"{float(fit_p['logdet'][2, 3]):.4f}, precision finite kernel "
        f"{bool(torch.isfinite(fit_k['prec'][2, 3]).all())} plain "
        f"{bool(torch.isfinite(fit_p['prec'][2, 3]).all())}; CVs of "
        f"models 0 and 2: kernels {ck.tolist()}, kernel density on the "
        f"plain fit {ckp.tolist()}, plain {cp.tolist()}; aggregate "
        f"kernels {float(cvs['kernels']):.6f} plain "
        f"{float(cvs['plain']):.6f}")
    check(bool(torch.isfinite(ck).all() and torch.isfinite(cp).all())
          and float(cp[1]) > 0,
          "K16 repair case: a model's CV is not finite (or model 2's 0)")
    check(within(ckp, cp, 0.0, 1e-4) and within(ck, cp, 0.0, 1e-4)
          and within(cvs["kernels"], cvs["plain"], 0.0, 1e-4),
          "K16 repair case: the kernels' CV differs from the plain "
          "version's by more than 1e-4 relative")


def lv_aggregate_leg(dev, kind: str) -> tuple:
    """An LV aggregated leg on the card, counts reset just before and read
    just after, then once more under torch.profiler -> (counts, mode
    counts, the ABCSMC): the path's kernels launched and K5 and K9 not,
    wall, syncs (one counter read a round, one fetch a chunk: the schedule
    table is copied to the card, never read), the epsilon trail and the
    top-level weights per generation. Adaptive: the weights refit at the
    calibration and after every generation, finite and positive.
    Schedule: every stored distance recomputed (numpy, float64) from the
    stored float32 statistics under its generation's weights within 2e-3
    relative (tests/test_fused.py:271's rule)."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    label = f"LV aggregated {kind} leg"
    abc = lv_aggregate(dev, kind)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=AGG_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, modes = launch_counts(), mode_launch_counts()
    n_gen = h.max_t + 1
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    dist = abc.distance_function
    syncs = abc.sync_ledger.summary()
    split = wall_split(abc)
    log(f"{label}: pop={AGG_POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={AGG_POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} syncs_per_generation="
        f"{syncs['syncs'] / n_gen:.2f} ({syncs['by_kind']}, rounds "
        f"{[g['rounds'] for g in abc.generation_log]}); host seconds, "
        f"rounds + generation steps {split['compute_s']:.4f}, packed fetch "
        f"{split['fetch_s']:.4f}, History wait {split['persist_s']:.4f}, "
        f"writer {split['write_s']:.4f}, final flush "
        f"{split['flush_s']:.4f}")
    log(f"{label}: eps trail {[round(e, 6) for e in eps]}")
    if kind == "adaptive":
        trail = {t: [round(float(v), 8) for v in dist.weights[t]]
                 for t in sorted(dist.weights) if t >= 0}
        log(f"{label}: top-level weights by generation {trail}")
        check(sorted(trail) == list(range(n_gen + 1))
              and all(all(math.isfinite(v) and v > 0 for v in w)
                      for w in trail.values()),
              f"{label}: the weights were not refit at the calibration and "
              f"after every generation, or not finite and positive")
    else:
        schedule_recompute_check(abc, h, label)
    log(f"{label}: kernel launches {counts}")
    path = [k for k in AGG_PATH
            if kind == "adaptive" or k != "aggregate_refit"]
    check(n_gen == AGG_GENS, f"{label} ran {n_gen} of {AGG_GENS} "
          f"generations")
    check(all(counts[k] > 0 for k in path)
          and counts["pnorm_accept_weight"] == 0
          and counts["scale_reduce"] == 0
          and (kind == "adaptive" or counts["aggregate_refit"] == 0),
          f"{label}: a kernel of the path was never launched, or K5 / K9 "
          f"ran")
    sync_check(abc, label)
    check(all(g["syncs"] == g["rounds"] for g in abc.generation_log),
          f"{label}: a generation read the device besides its round "
          f"counters")
    for t in range(n_gen):
        dmax = float(h.get_weighted_distances(t)["distance"].max())
        check(dmax <= eps[t], f"{label}: generation {t} stored a distance "
              f"{dmax} above its epsilon {eps[t]}")
    profile_run(f"{label} (profiled)", lv_aggregate(dev, kind), AGG_GENS)
    return counts, modes, abc


def schedule_recompute_check(abc, h, label: str) -> None:
    """Every stored distance of the schedule leg recomputed (numpy,
    float64) from the stored float32 statistics under its generation's
    weights within 2e-3 relative (tests/test_fused.py:271's rule)."""
    import numpy as np

    dist = abc.distance_function
    worst, excess = 0.0, -math.inf
    x0 = np.asarray(abc.spec.flatten_host(abc.x_0), np.float64)
    for t in range(h.max_t + 1):
        stored = np.sort(h.get_weighted_distances(t)["distance"].to_numpy())
        _w, stats = h.get_weighted_sum_stats(t)
        params = dist.device_params(t).numpy().astype(np.float64)
        W, subw = params[:2], params[2:].reshape(2, -1)
        diff = np.abs(stats.astype(np.float64) - x0)
        ref = np.sort(W[0] * np.sqrt(((subw[0] * diff) ** 2).sum(1))
                      + W[1] * (subw[1] * diff).sum(1))
        gap = np.abs(stored - ref)
        worst = max(worst, float((gap / np.abs(ref)).max()))
        excess = max(excess, float(
            (gap - (2e-3 * np.abs(ref) + 1e-5)).max()))
    log(f"{label}: stored distances recomputed under each generation's "
        f"weights, largest relative difference {worst:.3e}")
    check(excess <= 0.0, f"{label}: a stored distance does not recompute "
          f"under its generation's weights (rtol 2e-3, atol 1e-5)")


def lv_aggregate_cpu_trail(dev) -> None:
    """The adaptive leg at pop 1024 on the card and on the CPU (the plain
    versions, the same Philox streams), 4 generations: the top-level
    weights by generation side by side; the calibration's within 1e-3
    relative (the prior round's statistics agree to 1e-4)."""
    trails = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        abc = lv_aggregate(where, "adaptive", pop=AGG_CPU_POP)
        h = abc.run(max_nr_populations=AGG_CPU_GENS)
        w = abc.distance_function.weights
        trails[str(where)] = (
            {t: [float(v) for v in w[t]] for t in sorted(w) if t >= 0},
            [float(e) for e in h.get_all_populations()["epsilon"][1:]],
            time.perf_counter() - t0)
    card, cpu = trails[str(dev)], trails["cpu"]
    rel = [max(abs(a - b) / abs(b) for a, b in zip(card[0][t], cpu[0][t]))
           for t in sorted(cpu[0]) if t in card[0]]
    log(f"LV aggregated adaptive leg at pop {AGG_CPU_POP} "
        f"({AGG_CPU_GENS} generations): card weights {card[0]} eps "
        f"{card[1]}; CPU weights {cpu[0]} eps {cpu[1]} ({cpu[2]:.1f} s); "
        f"largest |card - cpu| / cpu of the weights by generation "
        f"{[float(f'{r:.2e}') for r in rel]}")
    check(rel and rel[0] <= 1e-3, "LV aggregated leg: the calibration's "
          "weights differ between card and CPU by more than 1e-3")


def config3_aggregate(where, early, pop: int | None = None):
    """Config 3 (birth-death in 10 segments) as ``config3`` runs it, under
    the aggregated pair of tests/test_segment.py:114-121."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gillespie as g

    dist = pt.AggregatedDistance([pt.PNormDistance(p=2),
                                  pt.PNormDistance(p=np.inf)],
                                 weights=[0.7, 1.3])
    abc = pt.ABCSMC(g.make_birth_death_model(segments=C3_SEGS),
                    g.birth_death_prior(), dist,
                    population_size=pop or C3_POP, eps=pt.MedianEpsilon(),
                    seed=C3_SEED, early_reject=early, fused_generations=C3_G,
                    device=where)
    abc.new("sqlite://", g.observed_birth_death(segments=C3_SEGS),
            store_sum_stats=False)
    return abc


def config3_aggregate_run(dev) -> tuple:
    """Config 3 under the aggregated pair with early reject on, off, off,
    on, the counts reset just before the first -> (counts, mode counts,
    the eps trail): populations bit-identical in every generation, slots
    retired, the saved share of segment steps, K18's aggregate mode (on)
    and K19 (off) launched, K5 never, syncs per generation."""
    from pyabc_tpu_torch.kernels import reset_launch_counts

    label = "config 3 aggregated (p 2 x 0.7 + p inf x 1.3)"
    runs = []
    reset_launch_counts()
    for early in TURNS:
        abc = config3_aggregate(dev, early)
        h, wall, counts = seg_run(abc, C3_GENS, label)
        runs.append((early, abc, h, wall, counts))
    counts = {k: sum(r[4][k] for r in runs) for k in runs[0][4]}
    (_e, a_on, h_on, _w, c_on), (_e2, a_off, h_off, _w2, c_off) = runs[:2]
    n_gen = h_on.max_t + 1
    eps = [float(e) for e in h_on.get_all_populations()["epsilon"][1:]]
    same = (populations_identical(h_on, h_off)
            and populations_identical(h_on, runs[2][2])
            and populations_identical(h_on, runs[3][2]))
    tot = seg_totals(h_on)
    saved = 1.0 - tot["seg_steps"] / max(tot["seg_resolved"] * C3_SEGS, 1)
    for early, abc, h, wall, _c in runs:
        tag = "on" if early == "auto" else "off"
        syncs = abc.sync_ledger.summary()
        log(f"{label} early reject {tag}: pop={C3_POP} gens={h.max_t + 1} "
            f"wall_s={wall:.3f} accepted_particles_per_s="
            f"{C3_POP * (h.max_t + 1) / wall:.1f} syncs_per_generation="
            f"{syncs['syncs'] / (h.max_t + 1):.2f} rounds "
            f"{[g['rounds'] for g in abc.generation_log]}")
    log(f"{label}: eps trail {[round(e, 4) for e in eps]}; populations "
        f"bit-identical on and off {same}; retired_early "
        f"{tot['retired_early']}, seg_steps {tot['seg_steps']}, "
        f"seg_resolved {tot['seg_resolved']}, sim_work_saved_frac "
        f"{saved:.4f}, segment_occupancy per generation {tot['occupancy']}")
    log(f"{label}: kernel launches on {c_on} off {c_off}")
    check(n_gen == C3_GENS and h_off.max_t + 1 == C3_GENS,
          f"{label} ran {n_gen} / {h_off.max_t + 1} of {C3_GENS} "
          f"generations")
    check(same, f"{label}: populations differ with early reject on and off")
    check(tot["retired_early"] > 0, f"{label}: no slot retired early")
    check(c_on["segment_round:aggregate"] > 0 and c_off["tau_leap"] > 0
          and c_off["segment_round"] == 0
          and counts["pnorm_accept_weight"] == 0,
          f"{label}: K18's aggregate mode (on) or K19 (off) was never "
          f"launched, or K5 ran")
    check(all(counts[k] > 0 for k in C3AGG_PATH),
          f"{label}: a kernel of the path was never launched")
    check(a_on.sync_ledger.count / n_gen
          <= a_off.sync_ledger.count / (h_off.max_t + 1),
          f"{label}: more syncs per generation with early reject on")
    return counts, eps


def k18_aggregate_checks(dev, eps_late: float, eps_pnorm: float) -> dict:
    """K18's aggregate mode against its plain version at config 3's round
    (B 131072, 10 segments, the aggregated leg's generation-6 epsilon) and
    at a small odd shape, each followed by K25 and K6: kept slots,
    statistics, reservoir, ring and counters bit-identical; its device
    time beside the p-norm mode's on the same round (config 3's own
    generation-6 epsilon)."""
    import numpy as np
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import segment_round, segment_round_plain
    from pyabc_tpu_torch.models import gillespie as g

    B = C3_BENCH_POP
    model = g.make_birth_death_model(segments=C3_SEGS)
    x = seg_inputs(dev, model, g.birth_death_prior(),
                   g.observed_birth_death(segments=C3_SEGS), B, seed=3)
    dist = pt.AggregatedDistance([pt.PNormDistance(p=2),
                                  pt.PNormDistance(p=np.inf)],
                                 weights=[0.7, 1.3])
    dist.initialize(x["spec"])
    params = dist.device_params(0, dev)
    eps = torch.tensor(eps_late, dtype=torch.float32, device=dev)
    ctr = k18_case(dev, model, x, eps, 8192, "aggregate mode, config 3 "
                   "round", w=params, agg=dist.ps)
    small = g.make_birth_death_model(n_leaps=100, n_obs=20, segments=5)
    xs = seg_inputs(dev, small, g.birth_death_prior(),
                    g.observed_birth_death(n_leaps=100, n_obs=20,
                                           segments=5), 256, seed=4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(37)
    live = torch.zeros(256, dtype=torch.bool, device=dev)
    live[torch.randperm(256, generator=gen, device=dev)[:37]] = True
    xs["valid"] = xs["valid"] & live
    dist_s = pt.AggregatedDistance([pt.PNormDistance(p=2),
                                    pt.PNormDistance(p=np.inf)],
                                   weights=[0.7, 1.3])
    dist_s.initialize(xs["spec"])
    full = small.chain.kernel[0](small.chain.kernel[1], xs["theta"],
                                 xs["stream"], colmap=xs["imap"],
                                 width=20)[0]
    dd = (0.7 * (full - xs["x0"]).square().sum(1).sqrt()
          + 1.3 * (full - xs["x0"]).abs().amax(1))
    k18_case(dev, small, xs, torch.quantile(dd[xs["valid"]], 0.5), 256,
             "aggregate mode, small odd shape",
             w=dist_s.device_params(0, dev), agg=dist_s.ps)
    S = x["spec"].total_size
    scratch = torch.zeros(4, dtype=torch.int64, device=dev)
    ones = torch.ones(S, device=dev)
    e_pn = torch.tensor(eps_pnorm, dtype=torch.float32, device=dev)
    kw = dict(imap=x["imap"], x0=x["x0"], p=2.0, width=S, seg_ctr=scratch)

    def on():
        return segment_round(model.segmented, x["theta"], x["valid"],
                             x["stream"], w=params, eps=eps, agg=dist.ps,
                             **kw)

    ms_on = graph_ms(on, iters=10, replays=3)
    ms_pn = graph_ms(lambda: segment_round(
        model.segmented, x["theta"], x["valid"], x["stream"], w=ones,
        eps=e_pn, **kw), iters=10, replays=3)
    log(f"K18 aggregate mode device ms per config 3 round (B={B}): "
        f"{ms_on:.4f} (eps {eps_late:.4g}); the p-norm mode on the same "
        f"round {ms_pn:.4f} (config 3's eps {eps_pnorm:.4g})")
    t0 = time.perf_counter()
    segment_round_plain(model.segmented, x["theta"], x["valid"],
                        x["stream"], w=params, eps=eps, agg=dist.ps,
                        **{**kw, "seg_ctr": torch.zeros(
                            4, dtype=torch.int64, device=dev)})
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    spec = model.chain.kernel[1]
    return dict(err=0.0, call_ms=time_ms(on, 10), ms=ms_on,
                plain_ms=plain_ms,
                bound=bound(B * (2 + S) * 4, int(ctr[1])
                            * spec.leaps_per_seg * spec.n_rates
                            * OPS_PER_DRAW),
                library_ms=None, ms_pnorm_mode=ms_pn)


# ------------------------------------------------- phase 2, prior families
#: K2's family mode: B lanes (LV at pop 16384, ``utils.pick_batch``) and
#: the reservoir of its transition mode
FAM_B, FAM_N = 65536, 16384
#: one 1-D prior of every family, and the decorator, as (label, spec):
#: spec is (family, *args) or ("bound", (family, *args), bound)
FAMILY_CASES = (
    ("norm", ("norm", 0.5, 2.0)), ("uniform", ("uniform", -1.0, 3.0)),
    ("lognorm", ("lognorm", 0.5, 0.0, 1.5)), ("expon", ("expon", 0.2, 1.5)),
    ("gamma", ("gamma", 2.0, 0.0, 0.5)), ("gamma a<1", ("gamma", 0.3)),
    ("beta", ("beta", 2.0, 3.0, -1.0, 3.0)),
    ("beta small", ("beta", 0.2, 0.3)),
    ("laplace", ("laplace", 0.0, 1.0)), ("cauchy", ("cauchy", 0.0, 1.0)),
    ("t", ("t", 3.0, 0.0, 1.0)), ("truncnorm", ("truncnorm", -1.0, 2.0,
                                                  0.0, 1.0)),
    ("randint", ("randint", 2, 9)), ("binom", ("binom", 20, 0.3)),
    ("binom btrs", ("binom", 100, 0.7)), ("poisson", ("poisson", 3.0)),
    ("poisson ptrs", ("poisson", 40.0)), ("nbinom", ("nbinom", 5.0, 0.4)),
    ("bound", ("bound", ("norm", 0.1, 0.1), 0.0)))
#: the KS statistic's critical value at level 0.001 is KS_C / sqrt(B)
KS_C = 1.9495


def family_rv(spec):
    import pyabc_tpu_torch as pt

    if spec[0] == "bound":
        return pt.LowerBoundDecorator(pt.RV(*spec[1]), spec[2])
    return pt.RV(*spec)


def scipy_law(spec):
    """The frozen scipy law of a case (a decorated norm: the truncated
    normal above its bound, the redraws' law up to Phi(lo)^9)."""
    import scipy.stats as st

    if spec[0] == "bound":
        _f, loc, scale = spec[1]
        return st.truncnorm((spec[2] - loc) / scale, math.inf, loc, scale)
    return getattr(st, spec[0])(*spec[1:])


def law_check(x, spec) -> tuple[bool, str]:
    """The card's draws against scipy: the KS statistic under its 0.001
    critical value (continuous), the pmf on the support points of mass
    >= 1e-3 within 4 standard errors (discrete)."""
    import numpy as np
    import scipy.stats as st

    law = scipy_law(spec)
    B = x.shape[0]
    if spec[0] in ("randint", "binom", "poisson", "nbinom"):
        ks = np.arange(int(law.ppf(1e-4)), int(law.ppf(1 - 1e-4)) + 1)
        pmf = law.pmf(ks)
        ks, pmf = ks[pmf >= 1e-3], pmf[pmf >= 1e-3]
        emp = np.array([(x == k).mean() for k in ks])
        worst = float(np.max(np.abs(emp - pmf)
                             / np.sqrt(pmf * (1 - pmf) / B)))
        return (worst < 4.0 and bool(np.all(x == np.round(x))),
                f"pmf on {len(ks)} points worst {worst:.2f} se")
    stat = float(st.kstest(x, law.cdf).statistic)
    crit = KS_C / math.sqrt(B)
    return stat < crit, f"KS {stat:.5f} (critical {crit:.5f})"


def family_points(spec):
    """Points for the log-density: inside, each boundary, outside, far
    tails, off-integer points of the discrete families, 0."""
    import numpy as np

    law = scipy_law(spec)
    lo, hi = law.support()
    inner = law.ppf(np.linspace(0.001, 0.999, 61))
    pts = [inner, [lo, hi, 0.0, -1e-3, 1e-3, -50.0, 50.0, -1e4, 1e4, 0.5,
                   2.5, 7.25]]
    for b in (lo, hi):
        if np.isfinite(b):
            pts.append([b - 0.25, b + 0.25, np.nextafter(b, -np.inf),
                        np.nextafter(b, np.inf)])
    p = np.concatenate([np.asarray(v, np.float64) for v in pts])
    return np.unique(p[np.isfinite(p)].astype(np.float32))


def point_fit(dev, pts):
    """A transition fit whose draws are its rows exactly (zero factor):
    K2's transition mode then scores every point of ``pts (n, d)``."""
    import torch

    n, d = pts.shape
    w = torch.full((n,), 1.0 / n, device=dev)
    return {"thetas": pts.contiguous(), "cdf": torch.cumsum(w, 0),
            "chol": torch.zeros(d, d, device=dev)}


def compare_k2_family(label, stream, B, prior, params=None):
    """K2 against its plain version on one prior: lanes whose theta or
    valid differ (continuous: beyond abs 1e-5 + rel 1e-5; discrete: at
    all) and the log-densities of the others within abs 1e-5 + rel 1e-5,
    their -inf masks equal -> (max abs error, lanes apart, card theta)."""
    import torch

    from pyabc_tpu_torch.kernels import propose, propose_plain

    th_k, lp_k, v_k = propose(stream, B, prior, params)
    th_p, lp_p, v_p = propose_plain(stream, B, prior, params)
    torch.cuda.synchronize()
    apart = (v_k != v_p) | ((th_k - th_p).abs() > 1e-5 + 1e-5 * th_p.abs()
                            ).any(dim=1)
    ok = ~apart
    fin = torch.isfinite(lp_p) & ok
    masks_equal = bool(torch.equal(torch.isfinite(lp_k)[ok],
                                   torch.isfinite(lp_p)[ok]))
    rel = ((lp_k - lp_p).abs() - 1e-5 * lp_p.abs())[fin]
    lp_ok = masks_equal and (not bool(fin.any())
                             or float(rel.max()) <= 1e-5)
    err = max(float((th_k - th_p)[ok].abs().max()) if bool(ok.any())
              else 0.0,
              float((lp_k - lp_p)[fin].abs().max()) if bool(fin.any())
              else 0.0)
    n_apart = int(apart.sum())
    log(f"K2 families ({label}, {'prior' if params is None else 'scores'}"
        f", B={B}): max_abs_err={err:.3e} lanes apart={n_apart} "
        f"-inf masks equal={masks_equal} finite logpri "
        f"{int(torch.isfinite(lp_k).sum())}/{B}")
    check(lp_ok and n_apart <= B // 1000,
          f"K2 families ({label}): log-densities outside abs 1e-5 + rel "
          f"1e-5 or -inf masks apart, or over 1e-3 of the lanes apart")
    return err, n_apart, th_k


def library_family(spec, dev, B):
    """One torch.distributions sample((B,)) + log_prob on the card for a
    case, where torch has the family (else None)."""
    import torch
    import torch.distributions as D

    if spec[0] == "bound":
        return None
    f, a = spec[0], [torch.tensor(float(v), device=dev) for v in spec[1:]]
    make = {"norm": lambda: D.Normal(*a), "uniform":
            lambda: D.Uniform(a[0], a[0] + a[1]),
            "lognorm": lambda: D.LogNormal(torch.log(a[2]), a[0]),
            "expon": lambda: D.Exponential(1.0 / a[1]),
            "gamma": lambda: D.Gamma(a[0], 1.0 / (a[2] if len(a) > 2
                                                  else torch.ones_like(a[0]))),
            "beta": lambda: D.Beta(a[0], a[1]), "laplace":
            lambda: D.Laplace(*a), "cauchy": lambda: D.Cauchy(*a),
            "t": lambda: D.StudentT(*a), "binom":
            lambda: D.Binomial(a[0], a[1]), "poisson": lambda: D.Poisson(a[0]),
            "nbinom": lambda: D.NegativeBinomial(a[0], 1.0 - a[1])}
    if f not in make:
        return None
    dist = make[f]()

    def call():
        return dist.log_prob(dist.sample((B,)))
    return time_ms(call, 20)


def k2_family_bound(prior, B, params=None):
    """Least time of a K2 family call: the table and the outputs once
    (bytes), one Philox block (~100 integer operations) per draw sequence
    and ~30 operations per log-density term (operations); the fewest a
    draw could need, so a lower bound."""
    d = prior["kind"].shape[-1]
    nbytes = d * 4 * 11 + B * (d * 4 + 5)
    ops = B * d * 30
    if params is None:
        ops += B * d * 100
    else:
        n = params["thetas"].shape[0]
        nbytes += n * (d + 1) * 4 + d * d * 4
        ops += B * (100 * (1 + (d + 3) // 4) + 2 * math.ceil(math.log2(n))
                    + d * (2 * d + 1))
    return bound(nbytes, ops)


def lv_family_prior():
    """The LV leg's prior over TRUE_PARS (1.0, 0.1, 1.5, 0.075): a gamma,
    a lognorm, a truncnorm and a norm bounded below at 0."""
    import pyabc_tpu_torch as pt

    return pt.Distribution(
        alpha=pt.RV("gamma", 2.0, 0.0, 0.75),
        beta=pt.RV("lognorm", 0.8, 0.0, 0.12),
        gamma=pt.RV("truncnorm", -1.5, 1.5, 1.5, 1.0),
        delta=pt.LowerBoundDecorator(pt.RV("norm", 0.1, 0.1), 0.0))


def family_model_priors(dev):
    """Two models of other families (K2's K > 1 mode): the LV leg's
    gamma and lognorm against a truncnorm, a bounded norm and a poisson."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.core.random_variables import stacked_arrays

    return stacked_arrays([
        pt.Distribution(a=pt.RV("gamma", 2.0, 0.0, 0.75),
                        b=pt.RV("lognorm", 0.8, 0.0, 0.12)),
        pt.Distribution(a=pt.RV("truncnorm", -1.5, 1.5, 1.5, 1.0),
                        b=pt.LowerBoundDecorator(pt.RV("norm", 0.1, 0.1),
                                                 0.0),
                        c=pt.RV("poisson", 3.0))], dev)


def k2_family_checks(dev) -> dict:
    """K2's family mode against its plain version on the card: every
    family (and the decorator) as a 1-D prior in the prior mode (draws,
    their law against scipy, log-densities) and in the transition mode on
    points inside, on and outside the support; the LV leg's 4-D prior in
    both modes and the local mode at the leg's shapes (B 65536, a fit of
    16384 rows); the K > 1 mode over two models of other families; and
    whether a norm prior draws the same bits in kernel and plain version
    (logged)."""
    import torch

    from pyabc_tpu_torch.kernels import mvn_fit, philox, propose, propose_plain
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    B = FAM_B
    errs, apart_total = [], 0
    lib = {}
    for label, spec in FAMILY_CASES:
        prior = pt_prior(spec).arrays(dev)
        err, apart, th = compare_k2_family(
            label, stream_on(dev, philox.PRIOR, seed=11), B, prior)
        errs.append(err)
        apart_total += apart
        case_err = err
        x = th[:, 0].double().cpu().numpy()
        ok, stat = law_check(x, spec)
        above = spec[0] != "bound" or bool((th[:, 0] > spec[2]).all())
        log(f"K2 families ({label}): card draws against scipy: {stat}, "
            f"ok={ok}" + ("" if spec[0] != "bound" else
                          f"; all above the bound {above}"))
        check(ok and above, f"K2 families ({label}): the card's draws fail "
              f"the law check")
        pts = torch.from_numpy(family_points(spec)).to(dev)[:, None]
        err, apart, _ = compare_k2_family(
            label, stream_on(dev, philox.TRANSITION, seed=12), B, prior,
            point_fit(dev, pts))
        errs.append(err)
        apart_total += apart
        st0 = stream_on(dev, philox.PRIOR)
        lib[label] = dict(
            ms=graph_ms(lambda: propose(st0, B, prior)),
            call_ms=time_ms(lambda: propose(st0, B, prior), 20),
            plain_ms=time_ms(lambda: propose_plain(st0, B, prior), 2, 1),
            bound=k2_family_bound(prior, B),
            library_ms=library_family(spec, dev, B),
            err=max(case_err, err))
    log("K2 families, prior mode at B 65536 (device ms, call ms, plain ms, "
        "bound ms, library: one torch.distributions sample + log_prob, "
        "max abs error): " + "; ".join(
            f"{k} {v['ms']:.5f} {v['call_ms']:.5f} {v['plain_ms']:.3f} "
            f"{v['bound'][0]:.6f} ({v['bound'][1]}) {v['library_ms']} "
            f"{v['err']:.2e}" for k, v in lib.items()))
    # the LV leg's prior at its shapes, both modes
    lvp = lv_family_prior()
    prior = lvp.arrays(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    X = lvp.rvs_array(FAM_N, g, dev)
    w = torch.rand(FAM_N, generator=g, device=dev) + 0.1
    params = mvn_fit(X.contiguous(), (w / w.sum()).contiguous(), dim=4,
                     scaling=1.0, bandwidth_selector=silverman_rule_of_thumb)
    st_p = stream_on(dev, philox.PRIOR, seed=13)
    st_t = stream_on(dev, philox.TRANSITION, seed=13)
    for st, p in ((st_p, None), (st_t, params)):
        err, apart, _ = compare_k2_family("LV prior", st, B, prior, p)
        errs.append(err)
        apart_total += apart
    # K2's local mode (LocalTransition's per-row factors) under the prior
    from pyabc_tpu_torch.kernels import propose_local, propose_local_plain

    n = params["thetas"].shape[0]
    local = {"thetas": params["thetas"], "cdf": params["cdf"],
             "chols": params["chol"].expand(n, 4, 4).contiguous()}
    th_k, lp_k, v_k = propose_local(st_t, B, prior, local)
    th_p, lp_p, v_p = propose_local_plain(st_t, B, prior, local)
    apart = (v_k != v_p) | ((th_k - th_p).abs() > 1e-5 + 1e-5 * th_p.abs()
                            ).any(dim=1)
    fin = ~apart & torch.isfinite(lp_p)
    lp_out = float(((lp_k - lp_p).abs() - 1e-5 * lp_p.abs())[fin].max())
    errs.append(float((lp_k - lp_p)[fin].abs().max()))
    apart_total += int(apart.sum())
    log(f"K2 families (LV prior, local mode, B={B}): lanes apart "
        f"{int(apart.sum())}, logpri beyond rel 1e-5 by {lp_out:.3e}")
    check(int(apart.sum()) <= B // 1000 and lp_out <= 1e-5,
          "K2 families: the local mode disagrees with its plain version")
    # K > 1: two models of other families, prior and transition modes
    priors = family_model_priors(dev)
    model_p = torch.tensor([0.4, 0.6], device=dev)
    err, _got = compare_propose_models(dev, B, priors, model_p,
                                       lp_rtol=1e-5)
    errs.append(err)
    K, d = priors["loc"].shape
    Xs = torch.stack([torch.where(
        torch.arange(d, device=dev) < priors["dims"][m],
        torch.cat([lvp.rvs_array(FAM_N, g, dev)[:, :2],
                   torch.rand(FAM_N, 1, generator=g, device=dev) * 3],
                  dim=1), 0.0) for m in range(K)])
    chol = torch.stack([torch.eye(d, device=dev) * 0.1] * K)
    wk = torch.full((K, FAM_N), 1.0 / FAM_N, device=dev)
    mparams = {"thetas": Xs.contiguous(), "cdf": torch.cumsum(wk, 1),
               "chol": chol}
    mpk = torch.tensor([[0.7, 0.3], [0.3, 0.7]], device=dev)
    err, _got = compare_propose_models(
        dev, B, priors, torch.log(model_p), mparams, mpk, lp_rtol=1e-5)
    errs.append(err)
    # norm and uniform draw the same bits in both versions
    legacy = pt_prior(("norm", 0.5, 2.0)).arrays(dev)
    st = stream_on(dev, philox.PRIOR, seed=3)
    same = torch.equal(propose(st, B, legacy)[0],
                       propose_plain(st, B, legacy)[0])
    log(f"K2 families: lanes apart over every comparison {apart_total}; "
        f"a norm prior bit-equal kernel and plain {same}")
    return {"propose:families": dict(
        err=max(errs), lanes_apart=apart_total,
        call_ms=time_ms(lambda: propose(st_t, B, prior, params), 50),
        ms=graph_ms(lambda: propose(st_t, B, prior, params)),
        ms_prior_mode=graph_ms(lambda: propose(st_p, B, prior)),
        plain_ms=time_ms(lambda: propose_plain(st_t, B, prior, params), 3),
        bound=k2_family_bound(prior, B, params), library_ms=None,
        by_family={k: v for k, v in lib.items()}, fit_rows=n)}


def pt_prior(spec):
    import pyabc_tpu_torch as pt

    return pt.Distribution(x=family_rv(spec))


# ------------------------------------------------- phase 3, family anchors
#: the noisy anchor's priors of this slice; the exact posterior is the
#: quadrature of prior x N(0.8; theta, 0.09)
ANCHOR_FAMILIES = (
    ("lognorm", ("lognorm", 0.5, 0.0, 1.0)), ("expon", ("expon", 0.0, 1.0)),
    ("gamma", ("gamma", 2.0, 0.0, 0.5)),
    ("beta", ("beta", 2.0, 2.0, -1.0, 3.0)),
    ("laplace", ("laplace", 0.0, 1.0)), ("cauchy", ("cauchy", 0.0, 1.0)),
    ("t", ("t", 3.0, 0.0, 1.0)),
    ("truncnorm", ("truncnorm", -1.0, 2.0, 0.0, 1.0)),
    ("bound", ("bound", ("norm", 0.0, 1.0), 0.0)))
#: the card runs every seed, the CPU the first 12 (the same Philox
#: streams: its runs repeat the card's seeds)
FAMILY_ANCHOR_SEEDS = tuple(range(24))
FAMILY_ANCHOR_CPU_SEEDS = 12


def anchor_exact(spec) -> tuple[float, float]:
    """The anchor's exact posterior mean and sd under a prior: 1-D
    quadrature of prior x N(0.8; theta, 0.09) with numpy."""
    import numpy as np

    grid = np.linspace(-40.0, 40.0, 800001)
    post = scipy_law(spec).pdf(grid) * np.exp(
        -0.5 * (grid - 0.8) ** 2 / 0.09)
    post /= post.sum()
    mu = float(np.sum(post * grid))
    return mu, float(np.sqrt(np.sum(post * (grid - mu) ** 2)))


def family_stats(where, seeds, families=ANCHOR_FAMILIES) -> dict:
    """The anchor under each prior of ``families`` over ``seeds`` on one
    device, every temperature trail falling to exactly 1 -> each
    family's posterior means and wall."""
    import numpy as np

    out = {}
    for label, spec in families:
        mus = []
        t0 = time.perf_counter()
        for seed in seeds:
            h = anchor_run(where, seed, family_rv(spec))
            temps = [float(x) for x in
                     h.get_all_populations()["epsilon"][1:]]
            check(temps[-1] == 1.0 and all(
                b <= a for a, b in zip(temps, temps[1:])),
                f"family anchor {label} seed {seed} ({where}): "
                f"temperature trail {temps} does not fall to exactly 1")
            df, w = h.get_distribution()
            mus.append(float(np.sum(w * np.asarray(df["theta"]))))
        out[label] = {"mus": mus, "wall": time.perf_counter() - t0}
    return out


@cpu_ref
def families_cpu() -> dict:
    return family_stats("cpu",
                        FAMILY_ANCHOR_SEEDS[:FAMILY_ANCHOR_CPU_SEEDS])


def family_anchor(dev) -> dict:
    """The noisy anchor with each prior of ANCHOR_FAMILIES over
    FAMILY_ANCHOR_SEEDS on the card and the first FAMILY_ANCHOR_CPU_SEEDS
    of them on the CPU (the CPU reference process): every temperature
    trail falls to exactly 1, the card's seed mean of the posterior mean
    lies within 4 se of the exact one and of the CPU's (se not below the
    posterior sd over sqrt(pop x seeds), which no population of POP
    particles beats) -> K2's launches in each prior's card runs."""
    import numpy as np

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    reset_launch_counts()
    per_family, card = {}, {}
    for label, spec in ANCHOR_FAMILIES:
        before = launch_counts()["propose"]
        with plain_versions_raise():
            card.update(family_stats(dev, FAMILY_ANCHOR_SEEDS,
                                     ((label, spec),)))
        per_family[label] = launch_counts()["propose"] - before
    counts = launch_counts()
    modes = mode_launch_counts()
    log(f"family anchors (card): kernel launches {counts}; K2 family mode "
        f"{modes['propose:families']}; K2 launches by prior {per_family}")
    check(modes["propose:families"] > 0,
          "the family anchors did not go through K2's family mode")

    def summary(where, label, st, mu_x, sd_x):
        mus = st["mus"]
        floor = sd_x / math.sqrt(POP * len(mus))
        m = float(np.mean(mus))
        se = max(float(np.std(mus, ddof=1) / math.sqrt(len(mus))), floor)
        log(f"family anchor {label} ({where}, {len(mus)} seeds, "
            f"{st['wall']:.2f} s): mean of posterior means {m:.4f} se "
            f"{se:.4f} (exact {mu_x:.4f} sd {sd_x:.4f}, "
            f"{(m - mu_x) / se:+.2f} se)")
        return m, se

    def compare():
        cpu = REFS.get("families_cpu")
        for label, spec in ANCHOR_FAMILIES:
            mu_x, sd_x = anchor_exact(spec)
            m_d, se_d = summary(dev, label, card[label], mu_x, sd_x)
            m_c, se_c = summary("cpu", label, cpu[label], mu_x, sd_x)
            gap = (m_d - m_c) / math.hypot(se_d, se_c)
            log(f"family anchor {label}: card - cpu {m_d - m_c:+.4f} "
                f"({gap:+.2f} se)")
            check(abs(m_d - mu_x) < 4 * se_d and abs(gap) < 4.0,
                  f"family anchor {label}: the card's seed mean is 4 se or "
                  f"more off the exact posterior or the CPU's")

    PENDING.append(compare)
    return per_family


# ------------------------------------------------- phase 4, LV families
#: pop 16384, 8 generations (cut for the script's time limit), the CPU
#: trail at pop 1024
LVF_POP, LVF_GENS, LVF_CPU_POP = 16384, 8, 1024
#: pyabc_tpu.models.lotka_volterra.observed_data(seed=123) (the JAX
#: package's observation of bench.py's LV config 2), float32
LV_JAX_OBS = {
    "pred": (4.608597278594971, 2.4729645252227783, 3.2468624114990234,
             8.328254699707031, 22.590049743652344, 19.18699836730957,
             9.812862396240234, 4.360836982727051, 3.12898588180542,
             3.569758892059326, 9.00464916229248, 22.214160919189453,
             18.8114013671875, 8.418645858764648, 4.610804557800293,
             3.200216054916382, 4.565954685211182, 9.360992431640625,
             22.76430892944336, 16.70180320739746),
    "prey": (9.754532814025879, 15.66331672668457, 26.728429794311523,
             40.037601470947266, 26.819276809692383, 10.259720802307129,
             7.612084865570068, 10.16415023803711, 16.997831344604492,
             29.602169036865234, 40.77849197387695, 25.188800811767578,
             9.96183967590332, 7.5912041664123535, 11.173686981201172,
             17.612316131591797, 29.83941650390625, 40.5467414855957,
             23.76477813720703, 10.14520263671875)}


def lv_family(where, pop: int | None = None, seed: int = 0):
    """LV config 2 (bench.py:119-127: AdaptivePNormDistance(p=2),
    MedianEpsilon, the JAX package's observation) under lv_family_prior."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv_family_prior(),
                    pt.AdaptivePNormDistance(p=2),
                    population_size=LVF_POP if pop is None else pop,
                    eps=pt.MedianEpsilon(), seed=seed, device=where)
    abc.new("sqlite://", {k: np.asarray(v, np.float32)
                          for k, v in LV_JAX_OBS.items()},
            store_sum_stats=False)
    return abc


def lv_family_leg(dev) -> tuple[dict, dict]:
    """Phase 4's main leg: LV config 2 under the family prior at pop 16384,
    LVF_GENS generations, on the card -> (launch counts, mode launch counts)."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.utils import pick_batch

    label = "LV families leg"
    abc = lv_family(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=LVF_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, modes = launch_counts(), mode_launch_counts()
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    n_gen = len(eps)
    syncs = abc.sync_ledger.summary()
    B = pick_batch(LVF_POP)
    gl = abc.generation_log
    spent = [g["rounds"] * B - g["n_valid"] for g in gl[1:]]
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in lv.TRUE_PARS}
    split = wall_split(abc)
    waited = split["persist_s"] + split["flush_s"]
    log(f"{label}: pop={LVF_POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={LVF_POP * n_gen / wall:.1f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"({syncs['by_kind']}, rounds {[g['rounds'] for g in gl]})")
    log(f"{label}: wall split: compute (rounds + generation steps) "
        f"{split['compute_s']:.4f} s, fetch {split['fetch_s']:.4f} s, "
        f"History wait {split['persist_s']:.4f} s, writer "
        f"{split['write_s']:.4f} s (its own thread), final flush "
        f"{split['flush_s']:.4f} s, other {wall - held_s(split):.4f} s; "
        f"History wait + final flush {waited:.4f} s = {waited / wall:.3f} "
        f"of the wall")
    log(f"{label}: eps trail {[round(e, 4) for e in eps]}")
    log(f"{label}: posterior means {means} true {lv.TRUE_PARS}")
    log(f"{label}: transition lanes whose {4} redraws all fell outside the "
        f"prior, per generation {spent} ({sum(spent)} of "
        f"{sum(g['rounds'] * B for g in gl[1:])})")
    log(f"{label}: kernel launches {counts}; K2 family mode "
        f"{modes['propose:families']}")
    check(n_gen == LVF_GENS, f"{label} ran {n_gen} of {LVF_GENS} "
          f"generations")
    check(eps[-1] < 0.5 * eps[0], f"{label}: the epsilon trail did not "
          f"fall")
    check(all(counts[k] > 0 for k in LV_PATH), f"{label}: a kernel of the "
          f"path was never launched")
    check(modes["propose:families"] == counts["propose"],
          f"{label}: a K2 launch outside its family mode")
    check(all(math.isfinite(v) for v in means.values()),
          f"{label}: non-finite posterior mean")
    for t in range(n_gen):
        dmax = float(h.get_weighted_distances(t)["distance"].max())
        check(dmax <= eps[t], f"{label}: generation {t} stored a distance "
              f"{dmax} above its epsilon {eps[t]}")
    by_name = profile_run(f"{label} (profiled)", lv_family(dev), LVF_GENS)
    if by_name:
        k2 = [v for k, v in by_name.items() if "propose_kernel" in k]
        tot, cnt = sum(v[0] for v in k2), sum(v[1] for v in k2)
        log(f"{label}: K2 device ms a round {tot / 1e3 / max(cnt, 1):.5f} "
            f"({cnt} launches)")
    return counts, modes


def lv_family_cpu_trail(dev) -> None:
    """The LV families leg at pop 1024 on the card and on the CPU (the
    plain versions, the same Philox streams): the first two epsilons within
    1e-3 relative."""
    trails = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        h = lv_family(where, LVF_CPU_POP).run(max_nr_populations=4)
        trails[where] = [float(e) for e in
                         h.get_all_populations()["epsilon"][1:]]
        log(f"LV families leg at pop {LVF_CPU_POP} ({where}, "
            f"{time.perf_counter() - t0:.1f} s): eps trail "
            f"{[round(e, 5) for e in trails[where]]}")
    rel = [abs(a - b) / abs(b) for a, b in zip(trails[dev], trails["cpu"])]
    log(f"LV families leg at pop {LVF_CPU_POP}: |card - cpu| / cpu per "
        f"generation {[float(f'{r:.2e}') for r in rel]}")
    check(max(rel[:2]) <= 1e-3, "LV families leg: the card's first two "
          "epsilons are more than 1e-3 off the CPU's")


@contextlib.contextmanager
def sync_history():
    """Runs inside append each generation synchronously, in the loop (the
    History's writer thread never starts), as before the writer came."""
    from pyabc_tpu_torch.storage.history import History

    saved = History.start_async_writer
    History.start_async_writer = lambda self: None
    try:
        yield
    finally:
        History.start_async_writer = saved


def writer_turns(dev) -> None:
    """The History writer against synchronous appends within one call:
    config 3 (early reject on; compute and persistence of one size) and
    the LV families leg (an idle card), in turns writer, sync, sync,
    writer: the wall and its split for each."""
    import torch

    for label, make, gens in (
            ("config 3", lambda: config3(dev, "auto"), C3_GENS),
            ("LV families leg", lambda: lv_family(dev), LVF_GENS)):
        walls = {"writer": [], "sync": []}
        for mode in ("writer", "sync", "sync", "writer"):
            abc = make()
            torch.cuda.synchronize()
            with (sync_history() if mode == "sync"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                abc.run(max_nr_populations=gens)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            split = wall_split(abc)
            walls[mode].append(wall)
            log(f"History {mode} turn, {label}: wall {wall:.3f} s; compute "
                f"{split['compute_s']:.3f}, fetch {split['fetch_s']:.3f}, "
                f"History wait {split['persist_s']:.3f} (sync: the appends "
                f"themselves), writer {split['write_s']:.3f}, final flush "
                f"{split['flush_s']:.3f}")
        log(f"History writer against sync, {label}: walls writer "
            f"{[round(w, 3) for w in walls['writer']]} sync "
            f"{[round(w, 3) for w in walls['sync']]}")


#: the tractable pair with model 1's prior a gamma (K2's K > 1 family mode)
FAMILY_PAIR_SEEDS = tuple(range(8))


def family_pair_run(where, seed):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _an = msel.tractable_pair()
    priors = [priors[0], pt.Distribution(theta=pt.RV("gamma", 2.0, 0.0,
                                                     0.5))]
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=PAIR_POP, eps=pt.MedianEpsilon(),
                    seed=seed, device=where)
    abc.new("sqlite://", {"x": PAIR_X})
    return abc.run(max_nr_populations=PAIR_GENS)


def family_pair_p0(where) -> list[float]:
    """P(m = 0) of the family pair's last generation, each seed."""
    out = []
    for seed in FAMILY_PAIR_SEEDS:
        h = family_pair_run(where, seed)
        out.append(float(h.get_model_probabilities(h.max_t)["p"]
                         .get(0, 0.0)))
    return out


@cpu_ref
def family_pair_cpu() -> dict:
    return {"p0": family_pair_p0("cpu")}


def family_pair(dev) -> None:
    """K > 1 with two models of different families: the tractable pair's
    N(0, 1) model against a gamma(2, 0, 0.5) one, on the card and the CPU
    (in the reference process); the seed mean of P(m = 0) against the
    exact model posterior (1-D quadrature of each model's evidence at
    PAIR_X)."""
    import numpy as np
    import scipy.stats as st

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    grid = np.linspace(-30.0, 30.0, 600001)
    evid = [float(np.sum(law.pdf(grid) * st.norm(grid, sd).pdf(PAIR_X)))
            for law, sd in ((st.norm(0, 1), 0.6), (st.gamma(2, 0, 0.5),
                                                   1.2))]
    exact = evid[0] / sum(evid)
    t0 = time.perf_counter()
    reset_launch_counts()
    with plain_versions_raise():
        p0_card = family_pair_p0(dev)
    modes = mode_launch_counts()
    log(f"family pair ({dev}): kernel launches {launch_counts()}"
        f"; K2 family mode {modes['propose:families']}")
    check(modes["propose:families"] > 0, "the family pair did not "
          "go through K2's family mode")
    card_s = time.perf_counter() - t0

    def stats(where, p0, secs):
        m = float(np.mean(p0))
        se = float(np.std(p0, ddof=1) / math.sqrt(len(p0)))
        log(f"family pair ({where}, {len(p0)} seeds, {secs:.2f} s): mean "
            f"P(m=0) {m:.4f} se {se:.4f} (exact {exact:.4f})")
        return m, se

    m_d, se_d = stats(dev, p0_card, card_s)

    def compare():
        ref = REFS.get("family_pair_cpu")
        m_c, se_c = stats("cpu", ref["p0"], ref["wall_s"])
        gap = (m_d - m_c) / max(math.hypot(se_d, se_c), 1e-3)
        log(f"family pair: card - cpu {m_d - m_c:+.4f} ({gap:+.2f} se)")
        check(abs(m_d - exact) < 0.05 and abs(gap) < 4.0, "family pair: "
              "the card's P(m=0) is 0.05 or more off the exact model "
              "posterior or 4 se off the CPU's")

    PENDING.append(compare)


# ---------------------------------------------- learned summary statistics
#: the learned-statistics leg (bench.py:1196-1253): the network SIR at 8
#: patches x 16 observations (S 128 raw statistics in 4 segments) under
#: PNormDistance(p=2, sumstat=PredictorSumstat(LinearPredictor(alpha=1))),
#: MedianEpsilon, seed 11, chunks of 2; pop 16384 (B 65536) where the
#: bench's CPU-sized leg takes 256, 8 generations (cut for the script's
#: time limit; the MLP and host-refit legs alike)
LS_SHAPE = {"n_patches": 8, "n_obs": 16}
LS_POP, LS_GENS, LS_SEED, LS_G, LS_ALPHA = 16384, 8, 11, 2, 1.0
LS_CPU_POP = 1024
#: the accuracy check (tests/test_sumstat_device.py:497-540): noise 30 in
#: the model and the observation, pop 256, 8 generations, the JAX test's
#: seed 19 and the 15 after it
LS_ACC_NOISE, LS_ACC_POP, LS_ACC_GENS = 30.0, 256, 8
LS_ACC_SEEDS = tuple(range(19, 35))
#: the JAX package in that setting over LS_ACC_SEEDS on the CPU, from
#: ``python tests/test_torch_sumstat_runs.py``: the seed mean and sd of
#: the learned statistic's RMSE and of its gap to the identity's (learned
#: minus identity), and the seeds
LS_ACC_JAX = {"learned": (0.0679, 0.0420), "gap": (0.0666, 0.0419), "n": 16}
#: K23's and K18's transformed operands: this slice's kernels, and the
#: path of the leg with early reject on (generation 0 and the calibration
#: run K20b and K5 on the raw statistics)
LS_KERNELS = ("ridge_fit", "linear_accept", "linear_bound")
LS_PATH = ("propose", "mvn_mixture_logpdf", "network_sir",
           "pnorm_accept_weight", "segment_round", "compact_round",
           "normalize_quantile", "mvn_fit", "pack_fetch",
           "generation_health") + LS_KERNELS


def ls_rows(dev, B: int, seed: int):
    """A prior round of the leg's network SIR simulated on the card: theta
    (B, 2), the raw statistics (B, 128), the spec, x0 and the emission
    map."""
    from pyabc_tpu_torch.models import sir

    model = sir.make_network_sir_model(**LS_SHAPE)
    x = seg_inputs(dev, model, sir.network_sir_prior(),
                   sir.observed_network_sir(**LS_SHAPE), B, seed=seed)
    x["ss"] = model.simulate_flat(x["theta"], None, x["spec"],
                                  stream=x["stream"]).contiguous()
    x["model"] = model
    return x


def k23_fit_case(dev, label, x, y, w, ctr, old, need, timed) -> dict:
    """K23's fit and its plain version on one problem: W, b, mu, sd
    within 1e-4 relative (atol 1e-5), the flags equal, the same from run
    to run, a poisoned row keeping the old parameters."""
    import torch

    from pyabc_tpu_torch.kernels import ridge_fit, ridge_fit_plain

    kw = dict(alpha=LS_ALPHA, need=need)
    got, flags = ridge_fit(x, y, w, ctr, old, **kw)
    ref, rflags = ridge_fit_plain(x, y, w, ctr, old, **kw)
    again, _f = ridge_fit(x, y, w, ctr, old, **kw)
    bad = x.clone()
    bad[1, 2] = float("nan")
    kept, kflags = ridge_fit(bad, y, w, ctr, old, **kw)
    torch.cuda.synchronize()
    err = max(abs_err(got[k], ref[k]) for k in got)
    ok = (all(within(got[k], ref[k], 1e-5, 1e-4) for k in got)
          and flags.tolist() == rflags.tolist() == [1, 1])
    same = all(torch.equal(got[k], again[k]) for k in got)
    poisoned = (kflags.tolist() == [0, 1]
                and all(torch.equal(kept[k], old[k]) for k in old))
    n_keep = int(min(int(ctr[0]), int(ctr[4])))
    S, C = x.shape[1], y.shape[1]
    log(f"K23 ridge_fit {label} (n_cap {x.shape[0]}, {n_keep} kept, S {S}, "
        f"C' {C}): max_abs_err={err:.3e} (W max "
        f"{float(got['W'].abs().max()):.3e}); "
        f"within rel 1e-4 {ok}; the same run to run {same}; a poisoned row "
        f"keeps the old parameters {poisoned}")
    check(ok and same and poisoned, f"K23 fit {label}: outside 1e-4 of the "
          f"plain fit, not repeatable, or a poisoned row was taken")
    if not timed:
        return {}
    nbytes = (n_keep * (S + C + 1) + 2 * (S * C + C + 2 * S)) * 4 + 20 + 8
    flops = 2 * n_keep * S * (S + C) + 3 * n_keep * S + S ** 3 / 3 \
        + 2 * S * S * C
    return dict(err=err, call_ms=time_ms(lambda: ridge_fit(
        x, y, w, ctr, old, **kw), 20),
        ms=graph_ms(lambda: ridge_fit(x, y, w, ctr, old, **kw), iters=10,
                    replays=3),
        plain_ms=time_ms(lambda: ridge_fit_plain(x, y, w, ctr, old, **kw),
                         5),
        bound=bound(nbytes, flops), library_ms=None)


def k23_checks(dev) -> tuple[dict, dict]:
    """K23 (fit, transform and accept) and K18's transformed operands
    against their plain versions -> (results, the fitted transform of the
    leg's rows). The fit at n_cap 16384, S 128, C' 2 with 9731 kept rows
    of simulated network SIR statistics, at n 300 with 211 kept (S 6, C'
    2) and at S 128 with C' 8; the transform and accept at B 65536, S 128
    (p 2; p 1 and inf once); the projectors on the network SIR's map (4
    segments, C' 2) and on a map of one row a segment (C' 3, a true null
    space before the end)."""
    import torch

    from pyabc_tpu_torch.kernels import (linear_accept, linear_accept_plain,
                                         linear_bound, linear_bound_plain,
                                         pnorm_accept_weight, transform_rows,
                                         transform_rows_plain)
    from pyabc_tpu_torch.ops.fit import N_ACC, N_TARGET
    from pyabc_tpu_torch.utils import pick_batch

    out = {}
    B = pick_batch(LS_POP)
    x = ls_rows(dev, B, seed=41)
    S = x["spec"].total_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)

    def problem(n_cap, n_keep, C, rows=None, theta=None):
        ctr = torch.zeros(5, dtype=torch.int32, device=dev)
        ctr[N_ACC], ctr[N_TARGET] = n_keep + 5, n_keep
        if rows is None:
            rows = x["ss"][:n_cap]
            theta = x["theta"][:n_cap]
        if theta.shape[1] < C:  # more targets: noisy mixes of theta
            mix = torch.randn(theta.shape[1], C, generator=gen, device=dev)
            theta = theta @ mix + 0.01 * torch.randn(
                n_cap, C, generator=gen, device=dev)
        w = torch.rand(n_cap, generator=gen, device=dev) + 0.1
        w[n_keep:] = 0.0
        Sx = rows.shape[1]
        old = {"W": torch.zeros(Sx, C, device=dev),
               "b": torch.zeros(C, device=dev),
               "mu": torch.zeros(Sx, device=dev),
               "sd": torch.ones(Sx, device=dev)}
        return (rows.contiguous(), theta[:, :C].contiguous(), w, ctr, old)

    main = problem(LS_POP, 9731, 2)
    out["ridge_fit"] = k23_fit_case(dev, "main shape", *main, need=S + 2,
                                    timed=True)
    odd_rows = (torch.randn(300, 6, generator=gen, device=dev)
                * torch.arange(1, 7, device=dev) + 40.0)
    odd_theta = odd_rows[:, :2] * 0.05 + 0.1 * torch.randn(
        300, 2, generator=gen, device=dev)
    k23_fit_case(dev, "small odd shape",
                 *problem(300, 211, 2, odd_rows, odd_theta), need=8,
                 timed=False)
    k23_fit_case(dev, "C' 8", *problem(LS_POP, 9731, 8), need=S + 2,
                 timed=False)
    from pyabc_tpu_torch.kernels import ridge_fit

    params, _fl = ridge_fit(*main, alpha=LS_ALPHA, need=S + 2)

    # the transform and the accept over a round of the leg
    ss, x0 = x["ss"], x["x0"]
    w = torch.ones(2, device=dev)
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    logpri = torch.randn(B, generator=gen, device=dev) - 3.0
    logq = torch.randn(B, generator=gen, device=dev) - 2.0
    rows = transform_rows(ss, params)
    rows_r = transform_rows_plain(ss, params)
    scale = float(rows_r.abs().max())
    r_err = abs_err(rows, rows_r)
    check(within(rows, rows_r, 1e-5 * scale, 1e-5),
          "K23 transform outside 1e-5 of the plain version")
    inf = torch.tensor(math.inf, device=dev)
    for p in (2.0, 1.0, math.inf):
        d_all = linear_accept_plain(ss, x0, params, w, inf, valid, p=p)[0]
        eps = torch.quantile(d_all, 0.3)
        args = (ss, x0, params, w, eps, valid)
        kw = dict(p=p, logpri=logpri, logq=logq)
        d_k, a_k, lw_k = linear_accept(*args, **kw)
        d_p, a_p, lw_p = linear_accept_plain(*args, **kw)
        v_k = linear_accept.values(ss, x0, params, w, p=p)
        torch.cuda.synchronize()
        dscale = float(d_p.abs().max())
        far = (d_p - eps).abs() > 1e-5 * dscale
        flags = bool((a_k == a_p)[far].all())
        err = abs_err(d_k, d_p)
        log(f"K23 linear_accept p={p} (B={B}, S={S}, C' 2): "
            f"max_abs_err(d)={err:.3e} (d up to {dscale:.3e}), transformed "
            f"rows {r_err:.3e} (up to {scale:.3e}), accepted "
            f"{int(a_k.sum())}, flags equal away from eps {flags}, values "
            f"mode bit-equal {torch.equal(v_k, d_k)}")
        check(within(d_k, d_p, 1e-5 * dscale, 1e-5) and flags
              and torch.equal(lw_k, lw_p) and torch.equal(v_k, d_k),
              f"K23 accept (p {p}): distances outside 1e-5, flags or log "
              f"weights differ, or the values mode differs")
        if p != 2.0:
            continue
        # ss, x0, the transform, w and eps read; logpri, logq, valid read
        # and d, accept, log weight written a lane
        nbytes = (B * S + S + S * 2 + 2 + 2 * S + 2 + 1) * 4 + B * 18
        out["linear_accept"] = dict(
            err=err, call_ms=time_ms(lambda: linear_accept(*args, **kw), 50),
            ms=graph_ms(lambda: linear_accept(*args, **kw)),
            plain_ms=time_ms(lambda: linear_accept_plain(*args, **kw), 10),
            bound=bound(nbytes, B * S * (2 + 2 * 2) + B * 8),
            library_ms=None,
            transform_ms=graph_ms(lambda: transform_rows(ss, params)),
            transform_err=r_err,
            # K5 on the same raw rows: the accept without the transform
            k5_ms=graph_ms(lambda: pnorm_accept_weight(
                ss, x0, torch.ones(S, device=dev), eps, valid, p=2.0,
                logpri=logpri, logq=logq)))

    # the projectors: the network SIR's map, and one row a segment
    imap = x["imap"]
    bp = linear_bound(w, params, imap)
    bp_r = linear_bound_plain(w, params, imap)
    cases = [("network SIR map", bp, bp_r, imap)]
    W3 = torch.randn(6, 3, generator=gen, device=dev)
    p3 = {"W": W3, "sd": torch.rand(6, generator=gen, device=dev) + 0.5}
    imap3 = torch.arange(6, device=dev, dtype=torch.int32).view(6, 1)
    w3 = torch.rand(3, generator=gen, device=dev) + 0.5
    cases.append(("one row a segment, C' 3", linear_bound(w3, p3, imap3),
                  linear_bound_plain(w3, p3, imap3), imap3))
    for label, got, ref, im in cases:
        torch.cuda.synchronize()
        counts = torch.diagonal(got["proj"], dim1=1, dim2=2).sum(1).round()
        rcounts = torch.diagonal(ref["proj"], dim1=1, dim2=2).sum(1).round()
        err = abs_err(got["proj"], ref["proj"])
        ok = (torch.equal(got["At"], ref["At"])
              and torch.equal(counts, rcounts) and err <= 1e-5)
        log(f"K18 linear_bound {label} ({im.shape[0]} segments): null "
            f"counts {counts.int().tolist()} (plain "
            f"{rcounts.int().tolist()}), projectors max_abs_err={err:.3e}; "
            f"At bit-equal {torch.equal(got['At'], ref['At'])}")
        check(ok, f"K18 transformed operands ({label}) differ from the "
              f"plain version")
        if label == "network SIR map":
            n_seg = im.shape[0]
            suffix = sum((n_seg - j) * im.shape[1] for j in range(n_seg))
            out["linear_bound"] = dict(
                err=err, call_ms=time_ms(lambda: linear_bound(w, params,
                                                              imap), 50),
                ms=graph_ms(lambda: linear_bound(w, params, imap)),
                plain_ms=time_ms(lambda: linear_bound_plain(w, params, imap),
                                 5),
                bound=bound((S * 2 * 2 + S + 2 + S + (n_seg + 1) * 4) * 4,
                            suffix * 4 * 2 + S * 4), library_ms=None)
    return out, params


def learned(where, kind: str = "linear", early="auto",
            pop: int | None = None, seed: int = LS_SEED,
            noise: float = 0.0, fetch_dtype: str = "float16"):
    """The leg's ABCSMC on ``where``: ``kind`` linear (PNormDistance(p=2)
    through the learned statistic), adaptive (AdaptivePNormDistance(p=2)
    through it), mlp (PNormDistance(p=2) through an MLPPredictor at its
    defaults), identity (PNormDistance(p=2) on the raw statistics), or one
    of the host-refit mode's: gp, lasso (the predictor at its defaults),
    model selection (LinearPredictor(alpha=1) and GPPredictor()),
    fit_every 3 (the linear statistic refit every third generation of the
    JAX package's count) and identity statistic (IdentitySumstat())."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import sir

    def lin():
        return pt.PredictorSumstat(pt.LinearPredictor(alpha=LS_ALPHA))

    def learned_by(pred, **kw):
        return pt.PNormDistance(p=2, sumstat=pt.PredictorSumstat(pred, **kw))

    dist = {"linear": lambda: pt.PNormDistance(p=2, sumstat=lin()),
            "adaptive": lambda: pt.AdaptivePNormDistance(p=2, sumstat=lin()),
            "mlp": lambda: learned_by(pt.MLPPredictor()),
            "identity": lambda: pt.PNormDistance(p=2),
            "gp": lambda: learned_by(pt.GPPredictor()),
            "lasso": lambda: learned_by(pt.LassoPredictor()),
            "model selection": lambda: learned_by(pt.ModelSelectionPredictor(
                [pt.LinearPredictor(alpha=LS_ALPHA), pt.GPPredictor()])),
            "fit_every 3": lambda: learned_by(
                pt.LinearPredictor(alpha=LS_ALPHA), fit_every=3),
            "identity statistic": lambda: pt.PNormDistance(
                p=2, sumstat=pt.IdentitySumstat())}[kind]()
    abc = pt.ABCSMC(sir.make_network_sir_model(**LS_SHAPE, noise_sd=noise),
                    sir.network_sir_prior(), dist,
                    population_size=pop or LS_POP, eps=pt.MedianEpsilon(),
                    seed=seed, fused_generations=LS_G, early_reject=early,
                    fetch_dtype=fetch_dtype, device=where)
    abc.new("sqlite://", sir.observed_network_sir(**LS_SHAPE,
                                                  noise_sd=noise or 8.0))
    return abc


def ls_report(label, abc, h, wall) -> dict:
    """The numbers of one leg run: fetch bytes a particle, syncs, the
    trail, the posterior means against TRUE_PARS, the wall split."""
    import numpy as np

    from pyabc_tpu_torch.models import sir

    syncs = abc.sync_ledger.summary()
    n_gen = h.max_t + 1
    pop = abc.population_strategy(0)
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in sir.TRUE_PARS}
    rounds = [g["rounds"] for g in abc.generation_log]
    fetch = syncs["bytes"].get("chunk_fetch", 0) / (pop * n_gen)
    split = wall_split(abc)
    waited = split["persist_s"] + split["flush_s"]
    log(f"{label}: pop={pop} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={pop * n_gen / wall:.1f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"({syncs['by_kind']}, rounds {rounds}); fetch bytes a particle "
        f"{fetch:.2f}")
    log(f"{label}: wall split: compute {split['compute_s']:.4f} s, fetch "
        f"{split['fetch_s']:.4f} s, History wait {split['persist_s']:.4f} "
        f"s, writer {split['write_s']:.4f} s (its own thread), final flush "
        f"{split['flush_s']:.4f} s; History wait + final flush "
        f"{waited / wall:.3f} of the wall")
    log(f"{label}: eps trail {[round(e, 5) for e in eps]}; posterior means "
        f"{ {k: round(v, 4) for k, v in means.items()} } true "
        f"{sir.TRUE_PARS}")
    check(n_gen == LS_GENS, f"{label} ran {n_gen} of {LS_GENS} generations")
    check(all(math.isfinite(v) for v in means.values()),
          f"{label}: non-finite posterior mean")
    return {"fetch": fetch, "eps": eps, "rounds": rounds, "syncs": syncs,
            "means": means}


def learned_leg(dev) -> tuple[dict, dict, dict, float]:
    """Phase 4's learned-statistics leg on the card, the counts reset just
    before its first run -> (launch counts, mode counts, the fitted
    transform the run ended with, the identity run's fetch bytes a
    particle). The learned run (early reject
    on), then the same with early reject off, and the identity run: fetch
    bytes a particle (at least 2 times fewer), the refits that fired,
    syncs (one counter read a round, one fetch a chunk), populations
    bit-identical on and off, every slot resolved, retired slots and the
    saved share; then once more under torch.profiler for K23's and K18's
    device ms a generation."""
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.utils import pick_batch

    label = "learned-statistics leg (network SIR, S 128, linear)"
    abc = learned(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=LS_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, modes = launch_counts(), mode_launch_counts()
    rep = ls_report(label, abc, h, wall)
    fitted = abc.distance_function.sumstat.predictor.device_params(dev)
    tel = [h.get_telemetry(t) for t in range(h.max_t + 1)]
    refits = [t for t, x in enumerate(tel) if x.get("sumstat_refit")]
    fit_ok = [x.get("sumstat_fit_ok") for x in tel if "sumstat_refit" in x]
    widths = [h.get_weighted_sum_stats(t)[1].shape[1] for t in (0, 1)]
    log(f"{label}: boundary refits at generations {refits} (finite "
        f"{fit_ok}), predictor fitted last for t = "
        f"{abc.distance_function.sumstat._last_fit_t}; History rows "
        f"{widths[0]} wide at generation 0, {widths[1]} after; telemetry "
        f"{tel[0].get('sumstat')}")
    log(f"{label}: kernel launches {counts}; K18 transformed mode "
        f"{modes['segment_round:linear']}, K23 transform "
        f"{modes['linear_accept:transform']}, values "
        f"{modes['linear_accept:values']}")
    n_chunks = 1 + -(-(LS_GENS - 1) // LS_G)
    by = rep["syncs"]["by_kind"]
    check(set(by) == {"round_counters", "chunk_fetch"}
          and 1 <= by["round_counters"] - sum(rep["rounds"]) <= 2
          and by["chunk_fetch"] == n_chunks,
          f"{label}: a host read beyond one a round (the calibration's "
          f"too) and one a chunk: {by}")
    check(refits == boundaries(LS_GENS, LS_G) and all(fit_ok),
          f"{label}: the boundary refits were {refits} ({fit_ok})")
    check(widths == [128, 2], f"{label}: History rows {widths} wide")
    check(all(counts[k] > 0 for k in LS_PATH)
          and modes["segment_round:linear"] > 0,
          f"{label}: a kernel of the path was never launched")
    runs = {"on": (h, rep)}
    for kind, early in (("linear", False), ("identity", "auto")):
        a = learned(dev, kind, early)
        with plain_versions_raise():
            t0 = time.perf_counter()
            hh = a.run(max_nr_populations=LS_GENS)
            torch.cuda.synchronize()
            w_ = time.perf_counter() - t0
        tag = "early reject off" if kind == "linear" else "identity"
        runs[tag] = (hh, ls_report(f"{label.replace('linear', kind)} "
                                   f"{tag}", a, hh, w_))
    same = populations_identical(h, runs["early reject off"][0])
    tot = seg_totals(h)
    saved = 1.0 - tot["seg_steps"] / max(tot["seg_resolved"] * 4, 1)
    lanes = sum(rep["rounds"][1:]) * pick_batch(LS_POP)
    ratio = runs["identity"][1]["fetch"] / rep["fetch"]
    log(f"{label}: early reject on and off bit-identical {same}; retired "
        f"{tot['retired_early']}, seg_resolved {tot['seg_resolved']} of "
        f"{lanes} slots, sim_work_saved_frac {saved:.4f}; fetch bytes a "
        f"particle identity {runs['identity'][1]['fetch']:.2f} learned "
        f"{rep['fetch']:.2f}: {ratio:.2f} times fewer")
    check(same, f"{label}: populations differ with early reject on and off")
    check(tot["seg_resolved"] == lanes, f"{label}: {tot['seg_resolved']} of "
          f"{lanes} slots resolved")
    check(ratio >= 2.0, f"{label}: fetch bytes a particle only {ratio:.2f} "
          f"times fewer than the identity run's")
    by_name = profile_run(f"{label} (profiled)", learned(dev), LS_GENS)
    if by_name:
        for name, keys in (("K23 fit", ("ridge_",)),
                           ("K23 transform and accept", ("linear_accept",
                                                         "linear_transform")),
                           ("K18 transformed operands", ("linear_bound",)),
                           ("K18 rounds", ("segment_round",))):
            v = [t for k, t in by_name.items() if any(s in k for s in keys)]
            tot_ms = sum(t[0] for t in v) / 1e3
            log(f"{label}: {name} device ms a generation "
                f"{tot_ms / LS_GENS:.5f} ({sum(t[1] for t in v)} launches)")
    return counts, modes, fitted, runs["identity"][1]["fetch"]


def boundaries(gens: int, G: int) -> list[int]:
    """The chunks' last generations after generation 0's own chunk: where
    K23's fit runs."""
    out, t = [], 1
    while t < gens:
        t += min(G, gens - t)
        out.append(t - 1)
    return out


def learned_adaptive_leg(dev) -> None:
    """The adaptive form at the leg's shape (the classic kernel, as the
    JAX package gates it): the C'-wide weight trail, one counter read a
    round, one fetch a chunk and the seed's read."""
    import torch

    label = "learned-statistics adaptive leg (network SIR, S 128)"
    abc = learned(dev, "adaptive")
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=LS_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep = ls_report(label, abc, h, wall)
    wts = abc.distance_function.weights
    trail = {t: [round(float(v), 4) for v in wts[t]] for t in sorted(wts)}
    log(f"{label}: weights trail {trail}; fallbacks "
        f"{abc.capability_fallbacks}")
    by = rep["syncs"]["by_kind"]
    check(all(len(wts[t]) == 2 for t in range(1, LS_GENS)),
          f"{label}: the weights after generation 0 are not C' wide")
    check(set(by) == {"round_counters", "chunk_fetch", "sumstat_seed"}
          and by["sumstat_seed"] == 1
          and 1 <= by["round_counters"] - sum(rep["rounds"]) <= 2,
          f"{label}: host reads {by}")


def calibration_hook(dist, feed=None, nudge: float = 0.0) -> dict:
    """Wrap an adaptive distance's first refit of a run (the calibration's
    weights and distances) once -> the dict the hook fills with what the
    run then used. ``feed``: (w, d) taken in their place (another run's
    calibration); ``nudge``: the weights moved one ulp towards +inf (1) or
    -inf (-1), the distances kept."""
    import torch

    seen, orig = {}, dist.refit

    def refit(*args, **kwargs):
        del dist.refit  # once: the generations' refits are the method's
        w, d = orig(*args, **kwargs)
        if feed is not None:
            w, d = feed[0].to(w.device), feed[1].to(d.device)
        if nudge:
            w = torch.nextafter(w, torch.full_like(w, nudge * math.inf))
        seen["w"], seen["d"] = w.clone(), d.clone()
        return w, d

    dist.refit = refit
    return seen


def learned_cpu_trail(dev) -> None:
    """Both learned legs at pop 1024 on the card and on the CPU (the plain
    versions, the same Philox streams): the first two epsilons within 1e-3
    relative. The adaptive leg's calibration weights are float32 sums that
    the card and the CPU add in other orders, and they decide which
    candidates at generation 0's threshold are kept, whose rows seed the
    transform. So its generation 0 is held within 1e-3, and its generation
    1 is held on a CPU run fed the card's calibration weights and
    distances; the CPU's own generation 1, and the CPU's with its
    calibration weights one ulp up and one ulp down, are reported beside
    it."""
    def trail(h):
        return [float(e) for e in h.get_all_populations()["epsilon"][1:]]

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    def fmt(r):
        return [float(f"{v:.2e}") for v in r]

    for kind in ("linear", "adaptive"):
        trails, card_cal = {}, None
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            abc = learned(where, kind, pop=LS_CPU_POP)
            if kind == "adaptive" and where == dev:
                card_cal = calibration_hook(abc.distance_function)
            trails[where] = trail(abc.run(max_nr_populations=3))
            log(f"learned-statistics {kind} leg at pop {LS_CPU_POP} "
                f"({where}, {time.perf_counter() - t0:.1f} s): eps trail "
                f"{[round(e, 5) for e in trails[where]]}")
        r = rel(trails[dev], trails["cpu"])
        log(f"learned-statistics {kind} leg at pop {LS_CPU_POP}: |card - "
            f"cpu| / cpu per generation {fmt(r)}")
        held = 2 if kind == "linear" else 1
        check(max(r[:held]) <= 1e-3, f"learned {kind} leg: the card's "
              f"first {held} epsilons are more than 1e-3 off the CPU's")
        if kind == "linear":
            continue
        runs = {}
        for label, kw in (("fed the card's calibration",
                           {"feed": (card_cal["w"], card_cal["d"])}),
                          ("calibration weights +1 ulp", {"nudge": 1.0}),
                          ("calibration weights -1 ulp", {"nudge": -1.0})):
            abc = learned("cpu", kind, pop=LS_CPU_POP)
            calibration_hook(abc.distance_function, **kw)
            runs[label] = trail(abc.run(max_nr_populations=3))
            log(f"learned-statistics adaptive leg at pop {LS_CPU_POP} (cpu, "
                f"{label}): eps trail "
                f"{[round(e, 5) for e in runs[label]]}; against the card "
                f"{fmt(rel(trails[dev], runs[label]))}, against the cpu's "
                f"own {fmt(rel(runs[label], trails['cpu']))}")
        fed = rel(trails[dev], runs["fed the card's calibration"])
        check(max(fed[:2]) <= 1e-3, "learned adaptive leg: the CPU fed the "
              "card's calibration is more than 1e-3 off the card in its "
              "first two epsilons")


def learned_accuracy(dev) -> None:
    """tests/test_sumstat_device.py:497-540's setting on the card (noise 30
    in the model and the observation, pop 256, 8 generations) over
    LS_ACC_SEEDS: each seed's posterior-mean RMSE against TRUE_PARS under
    the identity and under the learned statistic. The JAX suite's rule
    (learned at most the identity's + 0.02) holds at its seed 19 by the
    draw: over these seeds the JAX package meets it on 3 of 16
    (``tests/test_torch_sumstat_runs.py``'s main). The check holds the
    card's seed means of the learned RMSE and of its gap to the identity's
    within 3 standard errors of the JAX package's over the same seeds
    (LS_ACC_JAX; two samples, other random streams), and reports seed 19's
    pair and the rule's verdict seed by seed."""
    import numpy as np

    from pyabc_tpu_torch.models import sir

    t0 = time.perf_counter()
    rmse = {"identity": [], "linear": []}
    for seed in LS_ACC_SEEDS:
        for kind in rmse:
            abc = learned(dev, kind, pop=LS_ACC_POP, seed=seed,
                          noise=LS_ACC_NOISE)
            with plain_versions_raise():
                h = abc.run(max_nr_populations=LS_ACC_GENS)
            df, w = h.get_distribution(0, h.max_t)
            err = [float(np.sum(df[k] * w)) - v for k, v in
                   sir.TRUE_PARS.items()]
            rmse[kind].append(float(np.sqrt(np.mean(np.square(err)))))
    lin, ident = np.array(rmse["linear"]), np.array(rmse["identity"])
    card = {"learned": lin, "gap": lin - ident}
    j_n = LS_ACC_JAX["n"]
    log(f"learned-statistics accuracy (noise {LS_ACC_NOISE}, pop "
        f"{LS_ACC_POP}, {LS_ACC_GENS} generations, seeds "
        f"{LS_ACC_SEEDS[0]}-{LS_ACC_SEEDS[-1]}, "
        f"{time.perf_counter() - t0:.1f} s): identity RMSE per seed "
        f"{[round(float(v), 4) for v in ident]}; learned "
        f"{[round(float(v), 4) for v in lin]}")
    for key, vals in card.items():
        j_mean, j_sd = LS_ACC_JAX[key]
        se = math.sqrt(vals.var(ddof=1) / len(vals) + j_sd ** 2 / j_n)
        z = (vals.mean() - j_mean) / se
        log(f"learned-statistics accuracy, {key} RMSE: card mean "
            f"{vals.mean():.4f} sd {vals.std(ddof=1):.4f} over {len(vals)} "
            f"seeds; the JAX package {j_mean:.4f} sd {j_sd:.4f} over {j_n} "
            f"(CPU); se {se:.4f}, limit +-{3 * se:.4f}, {z:+.2f} se")
        check(abs(z) <= 3.0, f"learned statistics: the card's {key} RMSE "
              f"seed mean is more than 3 se off the JAX package's")
    met = card["gap"] <= 0.02
    log(f"learned-statistics accuracy: seed {LS_ACC_SEEDS[0]}: learned "
        f"{lin[0]:.4f} identity {ident[0]:.4f}; the JAX suite's rule met on "
        f"{int(met.sum())} of {len(lin)} seeds {met.astype(int).tolist()} "
        f"(the JAX package: 3 of 16)")


def lin_round_case(dev, model, x, params: dict, label: str,
                   ring_cap: int) -> tuple:
    """K18's transformed mode and its plain version on one round, at eps
    the 30 % quantile of the round's transformed distances, each followed
    by K23's accept and K6 into fresh buffers: kept slots, statistics,
    reservoir, ring and counters bit-identical, some slots accepted ->
    (the operands, eps, the counters)."""
    import torch

    from pyabc_tpu_torch.kernels import (compact_round, linear_accept,
                                         linear_bound, segment_round,
                                         segment_round_plain)

    B, d_th = x["theta"].shape
    S, C = params["W"].shape
    w = torch.ones(C, device=dev)
    bp = linear_bound(w, params, x["imap"])
    kw = dict(imap=x["imap"], x0=x["x0"], w=w, p=2.0, width=S, lin=bp)
    full, _k = segment_round(
        model.segmented, x["theta"], x["valid"], x["stream"],
        eps=torch.tensor(math.inf, device=dev),
        seg_ctr=torch.zeros(4, dtype=torch.int64, device=dev), **kw)
    d_full = linear_accept.values(full, x["x0"], params, w, p=2.0)
    eps = torch.quantile(d_full[x["valid"]], 0.3)
    outs = []
    for fn in (segment_round, segment_round_plain):
        ctr = torch.zeros(4, dtype=torch.int64, device=dev)
        ss, keep = fn(model.segmented, x["theta"], x["valid"], x["stream"],
                      eps=eps, seg_ctr=ctr, **kw)
        d, acc, lw = linear_accept(ss, x["x0"], params, w, eps, keep, p=2.0)
        res = {"theta": torch.zeros(B, d_th, device=dev),
               "sumstats": torch.zeros(B, S, device=dev),
               "distance": torch.zeros(B, device=dev),
               "log_weight": torch.full((B,), -math.inf, device=dev),
               "slot": torch.full((B,), -1, dtype=torch.int32, device=dev)}
        rec = {"sumstats": torch.zeros(ring_cap, S, device=dev),
               "distance": torch.zeros(ring_cap, device=dev),
               "accepted": torch.zeros(ring_cap, dtype=torch.bool,
                                       device=dev),
               "valid": torch.zeros(ring_cap, dtype=torch.bool, device=dev)}
        counters = torch.zeros(4, dtype=torch.int32, device=dev)
        compact_round(acc, keep, x["theta"], ss, d, lw, res, rec, counters)
        outs.append((ss, keep, ctr, res, rec, counters))
    (ss, keep, ctr, res, rec, cnt), (ss_r, keep_r, ctr_r, res_r, rec_r,
                                     cnt_r) = outs
    torch.cuda.synchronize()
    same = (torch.equal(keep, keep_r) and torch.equal(ss[keep], ss_r[keep])
            and torch.equal(ctr[:3], ctr_r[:3]) and torch.equal(cnt, cnt_r)
            and all(torch.equal(res[k], res_r[k]) for k in res)
            and all(torch.equal(rec[k], rec_r[k]) for k in rec))
    retired, steps, resolved, _slots = (int(v) for v in ctr)
    invalid = int((~x["valid"]).sum())
    n_seg = x["imap"].shape[0]
    null = torch.diagonal(bp["proj"], dim1=1, dim2=2).sum(1).round()
    log(f"K18 segment_round transformed mode, {label} (B={B}, {n_seg} "
        f"segments, S {S}, C' {C}, eps={float(eps):.4g}): retired {retired} "
        f"({invalid} of them invalid draws), segments stepped {steps} of "
        f"{B * n_seg}, resolved {resolved}, accepted {int(cnt[0])}; null "
        f"counts {null.int().tolist()}; bit-identical to the plain version "
        f"{same}")
    check(same and resolved == B and int(cnt[0]) > 0,
          f"K18 transformed mode ({label}): kept slots, statistics, "
          f"reservoir, ring or counters differ from the plain version, or "
          f"nothing was accepted")
    return kw, eps, ctr


def k18_linear_checks(dev, params: dict) -> dict:
    """K18's transformed mode against its plain version: at the learned
    leg's round (B 65536, the fitted transform the leg ended with), where
    every segment's 32 rows span C' = 2 and nothing retires, and at config
    3's birth-death round (B 131072, 10 segments of 2 values) under a C' 8
    transform, so that the last three segments' rows leave a null space
    and slots retire on v^T P_j v; its device time at the leg's round
    beside K18's p-norm mode and K20b's unsegmented round on the same
    slots: what the engine costs when it retires nothing."""
    import torch

    from pyabc_tpu_torch.kernels import (network_sir, segment_round,
                                         segment_round_plain)
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.utils import pick_batch

    B = pick_batch(LS_POP)
    x = ls_rows(dev, B, seed=43)
    model, S = x["model"], x["spec"].total_size
    kw, eps, ctr = lin_round_case(dev, model, x, params, "the leg's round",
                                  8192)
    steps = int(ctr[1])
    bd = g.make_birth_death_model(segments=C3_SEGS)
    xb = seg_inputs(dev, bd, g.birth_death_prior(),
                    g.observed_birth_death(segments=C3_SEGS), C3_BENCH_POP,
                    seed=44)
    Sb, gen = xb["spec"].total_size, torch.Generator(device=dev)
    gen.manual_seed(44)
    pb = {"W": torch.randn(Sb, 8, generator=gen, device=dev),
          "b": torch.zeros(8, device=dev), "mu": xb["x0"].clone(),
          "sd": xb["x0"].abs().clamp(min=1.0)}
    kw_b, eps_b, ctr_b = lin_round_case(dev, bd, xb, pb,
                                        "config 3's round, C' 8", 8192)
    check(int(ctr_b[0]) > int((~xb["valid"]).sum()),
          "K18 transformed mode: no valid slot retired at config 3's round "
          "under C' 8")
    scratch = torch.zeros(4, dtype=torch.int64, device=dev)
    ones = torch.ones(S, device=dev)
    e_inf = torch.tensor(math.inf, device=dev)
    ms_bd = {label: graph_ms(lambda e=e: segment_round(
        bd.segmented, xb["theta"], xb["valid"], xb["stream"], eps=e,
        seg_ctr=scratch, **kw_b), iters=10, replays=3)
        for label, e in (("eps", eps_b), ("inf", e_inf))}
    log(f"K18 transformed mode device ms per config 3 round under C' 8 "
        f"(B={C3_BENCH_POP}): {ms_bd['eps']:.4f} at eps "
        f"{float(eps_b):.4g} ({int(ctr_b[1])} segment steps), "
        f"{ms_bd['inf']:.4f} at eps = inf "
        f"({C3_BENCH_POP * C3_SEGS} steps)")

    def on():
        return segment_round(model.segmented, x["theta"], x["valid"],
                             x["stream"], eps=eps, seg_ctr=scratch, **kw)

    ms_on = graph_ms(on, iters=10, replays=3)
    ms_pn = graph_ms(lambda: segment_round(
        model.segmented, x["theta"], x["valid"], x["stream"], imap=x["imap"],
        x0=x["x0"], w=ones, p=2.0, eps=e_inf, width=S, seg_ctr=scratch),
        iters=10, replays=3)
    spec = model.chain.kernel[1]
    ms_net = graph_ms(lambda: network_sir(spec, x["theta"], x["stream"]),
                      iters=10, replays=3)
    log(f"K18 transformed mode device ms per round (B={B}): {ms_on:.4f}; "
        f"K18's p-norm mode on the same slots (eps inf, nothing retires) "
        f"{ms_pn:.4f}; K20b's unsegmented network round {ms_net:.4f}")
    t0 = time.perf_counter()
    segment_round_plain(model.segmented, x["theta"], x["valid"], x["stream"],
                        eps=eps, seg_ctr=torch.zeros(4, dtype=torch.int64,
                                                     device=dev), **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_steps = spec.n_obs * spec.n_substeps
    return dict(err=0.0, call_ms=time_ms(on, 10), ms=ms_on,
                plain_ms=plain_ms,
                bound=bound(B * (2 + S) * 4, B * n_steps * 8 * 78
                            * steps / (B * 4)),
                library_ms=None, ms_pnorm_mode=ms_pn, ms_k20b_round=ms_net,
                ms_config3_c8=ms_bd["eps"],
                ms_config3_c8_eps_inf=ms_bd["inf"])


#: this slice's leg: the learned leg's network SIR under MLPPredictor() at
#: its defaults (hidden (64, 64), 400 seed steps, lr 1e-3; the device-fit
#: plan's 100 steps a boundary)
MLP_KERNELS = ("mlp_fit", "mlp_accept")
MLP_PATH = ("propose", "mvn_mixture_logpdf", "network_sir",
            "pnorm_accept_weight", "compact_round", "normalize_quantile",
            "mvn_fit", "pack_fetch", "generation_health") + MLP_KERNELS
MLP_HIDDEN, MLP_SEED_STEPS, MLP_STEPS, MLP_LR = (64, 64), 400, 100, 1e-3


def mlp_step_flops(n: int, sizes) -> float:
    """A fit step's operations on n rows: the forward and the weight
    gradient of every layer and the backward of every layer but the first
    (a multiply-add 2), tanh' and the head's gradient."""
    mm = [fi * fo for fi, fo in zip(sizes[:-1], sizes[1:])]
    return 2 * n * (2 * sum(mm) + sum(mm[1:])) + 4 * n * sum(sizes[1:])


def mlp_start(dev, sizes, seed: int) -> dict:
    """An MLP transform to start a fit from: MLPPredictor's seeded He init
    (its layers views of one packed buffer), mu 0, sd 1, ymu 0, ysd 1."""
    import pyabc_tpu_torch as pt

    return pt.MLPPredictor(seed=seed).init_params(sizes, dev)


def k23_mlp_case(dev, label, x, y, w, ctr, old, need, *, seed_fit=False,
                 timed=False) -> dict:
    """K23's MLP fit and its plain version on one problem (a boundary fit
    of MLP_STEPS steps, or with ``seed_fit`` the seed fit's MLP_SEED_STEPS
    on rows already standardized): the gradient at the start within 1e-4
    relative (1e-5 of its scale absolute), the fit's loss within 1e-3
    relative (the seed fit's 400 steps within 1e-2: where a gradient entry
    is near 0, Adam's step is about lr times its sign, which the order of
    a sum can flip, and over 400 steps the parameters part by about lr;
    5.6e-3 on an H100 80GB HBM3), mu, sd, ymu, ysd within 1e-5, the
    flags equal, the same bits run to run, a poisoned row and a fit below
    ``need`` keeping the old parameters."""
    import torch

    from pyabc_tpu_torch.kernels import mlp_fit, mlp_fit_plain
    from pyabc_tpu_torch.kernels.mlp_fit import mlp_gradient_plain
    from pyabc_tpu_torch.ops.fit import (MLP_KEYS, fit_decision,
                                         mlp_fit_rows, mlp_layout,
                                         mlp_loss_grad, mlp_sizes,
                                         param_leaves)

    std = not seed_fit
    steps = MLP_SEED_STEPS if seed_fit else MLP_STEPS
    kw = dict(lr=MLP_LR, n_steps=steps, standardize=std)
    g_k = mlp_fit.gradient(x, y, w, ctr, old, need=need, standardize=std)
    g_p = mlp_gradient_plain(x, y, w, ctr, old, need=need, standardize=std)
    got, flags = mlp_fit(x, y, w, ctr, old, need=need, **kw)
    ref, rflags = mlp_fit_plain(x, y, w, ctr, old, need=need, **kw)
    again, _f = mlp_fit(x, y, w, ctr, old, need=need, **kw)
    bad = x.clone()
    bad[1, 2] = float("nan")
    kept, kflags = mlp_fit(bad, y, w, ctr, old, need=need, **kw)
    n_keep = int(min(int(ctr[0]), int(ctr[4])))
    skip, sflags = mlp_fit(x, y, w, ctr, old, need=n_keep + 1, **kw)
    torch.cuda.synchronize()
    gscale = float(g_p.abs().max())
    g_err = abs_err(g_k, g_p)
    g_ok = within(g_k, g_p, 1e-5 * gscale, 1e-4)
    mask, _fit = fit_decision(ctr, x.shape[0], need)
    rows = mlp_fit_rows(old, x, y, w, mask, std)[:4]
    loss_k = float(mlp_loss_grad(got["layers"], *rows)[0])
    loss_p = float(mlp_loss_grad(ref["layers"], *rows)[0])
    loss0 = float(mlp_loss_grad(old["layers"], *rows)[0])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    stats_ok = all(within(got[k], ref[k], 1e-6, 1e-5) for k in MLP_KEYS)
    err = max(abs_err(a, b) for a, b in zip(param_leaves(got),
                                            param_leaves(ref)))
    same = all(torch.equal(a, b) for a, b in zip(param_leaves(got),
                                                 param_leaves(again)))
    olds = param_leaves(old)
    poisoned = (kflags.tolist() == [0, 1]
                and all(torch.equal(a, b) for a, b in
                        zip(param_leaves(kept), olds)))
    below = (sflags.tolist() == [1, 0]
             and all(torch.equal(a, b) for a, b in
                     zip(param_leaves(skip), olds)))
    flags_ok = flags.tolist() == rflags.tolist() == [1, 1]
    sizes = mlp_sizes(old["layers"])
    loss_tol = 1e-2 if seed_fit else 1e-3
    log(f"K23 mlp_fit {label} (n_cap {x.shape[0]}, {n_keep} kept, sizes "
        f"{sizes}, {steps} steps): gradient max_abs_err={g_err:.3e} (scale "
        f"{gscale:.3e}) within rel 1e-4 {g_ok}; loss {loss0:.6f} -> "
        f"{loss_k:.6f} (plain {loss_p:.6f}, rel {loss_rel:.2e}, held to "
        f"{loss_tol:.0e}); "
        f"parameters max_abs_err={err:.3e}; mu, sd, ymu, ysd within 1e-5 "
        f"{stats_ok}; flags {flags.tolist()} (plain {rflags.tolist()}); the "
        f"same run to run {same}; a poisoned row keeps the old parameters "
        f"{poisoned}; below need {below}")
    check(g_ok and loss_rel <= loss_tol and loss_k < loss0 and stats_ok
          and flags_ok and same and poisoned and below,
          f"K23 MLP fit {label}: the gradient, the loss, the flags, the "
          f"repeat or the guard differ from the plain version's")
    if not timed:
        return {}
    P = mlp_layout(sizes)[1]
    S, C = sizes[0], sizes[-1]
    nbytes = n_keep * (S + C + 1) * 4 + 2 * (P + 2 * S + 2 * C) * 4 + 28
    flops = steps * (mlp_step_flops(n_keep, sizes) + 12 * P)
    out = dict(err=err, gradient_err=g_err, loss_rel=loss_rel,
               bound=bound(nbytes, flops), library_ms=None,
               call_ms=time_ms(lambda: mlp_fit(x, y, w, ctr, old, need=need,
                                               **kw), 3),
               ms=graph_ms(lambda: mlp_fit(x, y, w, ctr, old, need=need,
                                           **kw), iters=2, replays=3),
               plain_ms=time_ms(lambda: mlp_fit_plain(
                   x, y, w, ctr, old, need=need, **kw), 1, warmup=1))
    log(f"K23 mlp_fit {label}: ms={out['ms']:.5f} call_ms="
        f"{out['call_ms']:.5f} plain_ms={out['plain_ms']:.5f} bound_ms="
        f"{out['bound'][0]:.6f} ({out['bound'][1]}; {flops:.4e} "
        f"operations)")
    return out


def k23_mlp_checks(dev) -> dict:
    """K23's MLP fit and transform against their plain versions on the
    card. The fit: a boundary fit at the MLP leg's width (n_cap 16384, 9731
    kept rows of simulated network SIR statistics, S 128, hidden (64, 64),
    C' 2), at a small odd shape (300 rows, 211 kept, S 6, hidden (8, 8))
    and at C' 8 under three hidden layers of odd widths; the seed fit
    (16384 rows, all kept, 400 steps on rows standardized in float64). The
    transform and accept at B 65536, S 128 (p 2, 1 and inf) under the
    boundary fit's transform."""
    import torch

    from pyabc_tpu_torch.kernels import (mlp_accept, mlp_accept_plain,
                                         mlp_fit, mlp_transform_rows,
                                         mlp_transform_rows_plain)
    from pyabc_tpu_torch.ops.fit import N_ACC, N_TARGET
    from pyabc_tpu_torch.utils import pick_batch

    B = pick_batch(LS_POP)
    x = ls_rows(dev, B, seed=43)
    S = x["spec"].total_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)

    def problem(n_cap, n_keep, C, rows=None, theta=None):
        ctr = torch.zeros(5, dtype=torch.int32, device=dev)
        ctr[N_ACC], ctr[N_TARGET] = n_keep + 5, n_keep
        if rows is None:
            rows, theta = x["ss"][:n_cap], x["theta"][:n_cap]
        if theta.shape[1] < C:  # more targets: noisy nonlinear mixes
            mix = torch.randn(theta.shape[1], C, generator=gen, device=dev)
            theta = torch.sin(theta @ mix) + 0.01 * torch.randn(
                n_cap, C, generator=gen, device=dev)
        w = torch.rand(n_cap, generator=gen, device=dev) + 0.1
        w[n_keep:] = 0.0
        return rows.contiguous(), theta[:, :C].contiguous(), w, ctr

    out = {}
    main = problem(LS_POP, 9731, 2)
    start = mlp_start(dev, (S, *MLP_HIDDEN, 2), seed=0)
    out["mlp_fit"] = k23_mlp_case(dev, "boundary fit, main shape", *main,
                                  start, S + 2, timed=True)
    odd_rows = (torch.randn(300, 6, generator=gen, device=dev)
                * torch.arange(1, 7, device=dev) + 40.0)
    odd_theta = torch.tanh(odd_rows[:, :2] * 0.05 - 2.0) + 0.1 * torch.randn(
        300, 2, generator=gen, device=dev)
    k23_mlp_case(dev, "boundary fit, small odd shape",
                 *problem(300, 211, 2, odd_rows, odd_theta),
                 mlp_start(dev, (6, 8, 8, 2), seed=1), 8)
    k23_mlp_case(dev, "boundary fit, C' 8, hidden (40, 24, 12)",
                 *problem(LS_POP, 9731, 8),
                 mlp_start(dev, (S, 40, 24, 12, 8), seed=2), S + 2)
    # the seed fit: all rows, standardized on the host in float64
    xs64 = x["ss"][:LS_POP].double()
    ys64 = x["theta"][:LS_POP].double()
    xs = ((xs64 - xs64.mean(0)) / xs64.std(0, unbiased=False).clamp_min(
        1e-12)).float().contiguous()
    ys = ((ys64 - ys64.mean(0)) / ys64.std(0, unbiased=False)).float()
    ctr = torch.tensor([LS_POP, 0, 0, 0, LS_POP], dtype=torch.int32,
                       device=dev)
    wts = torch.rand(LS_POP, generator=gen, device=dev) + 0.5
    seed = k23_mlp_case(dev, "seed fit", xs, ys.contiguous(), wts, ctr,
                        start, 0, seed_fit=True, timed=True)
    out["mlp_fit"].update(seed_ms=seed["ms"], seed_call_ms=seed["call_ms"],
                          seed_bound_ms=seed["bound"][0],
                          seed_plain_ms=seed["plain_ms"])

    # the transform and the accept over a round of the leg, under the
    # main boundary fit's transform
    params, _fl = mlp_fit(*main, start, lr=MLP_LR, n_steps=MLP_STEPS,
                          need=S + 2)
    ss, x0 = x["ss"], x["x0"]
    w = torch.ones(2, device=dev)
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    logpri = torch.randn(B, generator=gen, device=dev) - 3.0
    logq = torch.randn(B, generator=gen, device=dev) - 2.0
    rows = mlp_transform_rows(ss, params)
    rows_r = mlp_transform_rows_plain(ss, params)
    torch.cuda.synchronize()
    scale = float(rows_r.abs().max())
    r_err = abs_err(rows, rows_r)
    check(within(rows, rows_r, 1e-5 * scale, 1e-5),
          "K23 MLP transform outside 1e-5 of the plain version")
    inf = torch.tensor(math.inf, device=dev)
    sizes = (S, *MLP_HIDDEN, 2)
    mm = sum(fi * fo for fi, fo in zip(sizes[:-1], sizes[1:]))
    P = mm + sum(sizes[1:])
    for p in (2.0, 1.0, math.inf):
        d_all = mlp_accept_plain(ss, x0, params, w, inf, valid, p=p)[0]
        eps = torch.quantile(d_all, 0.3)
        args = (ss, x0, params, w, eps, valid)
        kw = dict(p=p, logpri=logpri, logq=logq)
        d_k, a_k, lw_k = mlp_accept(*args, **kw)
        d_p, a_p, lw_p = mlp_accept_plain(*args, **kw)
        v_k = mlp_accept.values(ss, x0, params, w, p=p)
        torch.cuda.synchronize()
        dscale = float(d_p.abs().max())
        far = (d_p - eps).abs() > 1e-5 * dscale
        flags = bool((a_k == a_p)[far].all())
        err = abs_err(d_k, d_p)
        log(f"K23 mlp_accept p={p} (B={B}, sizes {sizes}): "
            f"max_abs_err(d)={err:.3e} (d up to {dscale:.3e}), transformed "
            f"rows {r_err:.3e} (up to {scale:.3e}), accepted "
            f"{int(a_k.sum())}, flags equal away from eps {flags}, values "
            f"mode bit-equal {torch.equal(v_k, d_k)}")
        check(within(d_k, d_p, 1e-5 * dscale, 1e-5) and flags
              and torch.equal(lw_k, lw_p) and torch.equal(v_k, d_k),
              f"K23 MLP accept (p {p}): distances outside 1e-5, flags or "
              f"log weights differ, or the values mode differs")
        if p != 2.0:
            continue
        # the rows, x0 and the transform read; logpri, logq, valid read
        # and d, accept, log weight written a lane
        nbytes = (B * S + S + P + 2 * S + 4 + 2 + 1) * 4 + B * 18
        out["mlp_accept"] = dict(
            err=err, call_ms=time_ms(lambda: mlp_accept(*args, **kw), 20),
            ms=graph_ms(lambda: mlp_accept(*args, **kw), iters=10),
            plain_ms=time_ms(lambda: mlp_accept_plain(*args, **kw), 5),
            bound=bound(nbytes, 2 * (B + 1) * mm), library_ms=None,
            transform_ms=graph_ms(lambda: mlp_transform_rows(ss, params),
                                  iters=10),
            transform_call_ms=time_ms(
                lambda: mlp_transform_rows(ss, params), 20),
            transform_err=r_err)
        r = out["mlp_accept"]
        log(f"K23 mlp_accept p=2: ms={r['ms']:.5f} call_ms="
            f"{r['call_ms']:.5f} plain_ms={r['plain_ms']:.5f} transform_ms="
            f"{r['transform_ms']:.5f} bound_ms={r['bound'][0]:.6f} "
            f"({r['bound'][1]})")
    return out


def learned_mlp_leg(dev, ident_fetch: float) -> tuple[dict, dict]:
    """Phase 4's MLP leg on the card (this slice's main path), the counts
    reset just before its first run -> (launch counts, mode counts). The
    network SIR of the learned leg under PNormDistance(p=2) through
    PredictorSumstat(MLPPredictor()): every kernel of the path launched
    (K23's MLP fit once for the seed and at each boundary, its transform,
    accept and values entries), the boundary refits, History rows 128 then
    2 wide, one counter read a round, one fetch a chunk and the seed fit's
    read, the seed fit's ms; early reject auto (off with the JAX package's
    reason) against off: bit-identical; fetch bytes a particle at least 2
    times fewer than the identity run's; then once more under
    torch.profiler for K23's MLP fit and transform device ms."""
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    label = "learned-statistics MLP leg (network SIR, S 128, hidden (64, 64))"
    abc = learned(dev, "mlp")
    pred = abc.distance_function.sumstat.predictor
    seed_ms, fit = [], pred.fit

    def timed_fit(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(*args, **kwargs)
        torch.cuda.synchronize()
        seed_ms.append(1e3 * (time.perf_counter() - t0))

    pred.fit = timed_fit
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=LS_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, modes = launch_counts(), mode_launch_counts()
    rep = ls_report(label, abc, h, wall)
    tel = [h.get_telemetry(t) for t in range(h.max_t + 1)]
    refits = [t for t, x in enumerate(tel) if x.get("sumstat_refit")]
    fit_ok = [x.get("sumstat_fit_ok") for x in tel if "sumstat_refit" in x]
    widths = [h.get_weighted_sum_stats(t)[1].shape[1] for t in (0, 1)]
    fallbacks = [f["reason"] for f in abc.capability_fallbacks
                 if f["gate"] == "early_reject"]
    log(f"{label}: seed fit {seed_ms[0]:.3f} ms on the host's clock "
        f"({MLP_SEED_STEPS} steps on generation 0's {LS_POP} rows); "
        f"boundary refits at generations {refits} (finite {fit_ok}), "
        f"predictor fitted last for t = "
        f"{abc.distance_function.sumstat._last_fit_t}; History rows "
        f"{widths[0]} wide at generation 0, {widths[1]} after; telemetry "
        f"{tel[0].get('sumstat')}; early reject: {fallbacks}")
    log(f"{label}: kernel launches {counts}; K23 MLP transform "
        f"{modes['mlp_accept:transform']}, values "
        f"{modes['mlp_accept:values']}")
    n_chunks = 1 + -(-(LS_GENS - 1) // LS_G)
    by = rep["syncs"]["by_kind"]
    check(set(by) == {"round_counters", "chunk_fetch", "sumstat_train_fetch"}
          and by["sumstat_train_fetch"] == 1
          and 1 <= by["round_counters"] - sum(rep["rounds"]) <= 2
          and by["chunk_fetch"] == n_chunks,
          f"{label}: a host read beyond one a round, one a chunk and the "
          f"seed fit's: {by}")
    check(refits == boundaries(LS_GENS, LS_G) and all(fit_ok),
          f"{label}: the boundary refits were {refits} ({fit_ok})")
    check(widths == [128, 2] and tel[0]["sumstat"]["kind"] == "mlp",
          f"{label}: History rows {widths} wide, telemetry "
          f"{tel[0].get('sumstat')}")
    check(all(counts[k] > 0 for k in MLP_PATH)
          and counts["mlp_fit"] == 1 + len(refits)
          and modes["mlp_accept:transform"] > 0
          and modes["mlp_accept:values"] > 0,
          f"{label}: a kernel of the path was never launched")
    check(len(fallbacks) == 1
          and "no monotone prefix bound" in fallbacks[0],
          f"{label}: early reject not refused with the JAX package's "
          f"reason: {fallbacks}")
    off = learned(dev, "mlp", False)
    with plain_versions_raise():
        t0 = time.perf_counter()
        h_off = off.run(max_nr_populations=LS_GENS)
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
    ls_report(f"{label} early reject off", off, h_off, wall_off)
    same = populations_identical(h, h_off)
    ratio = ident_fetch / rep["fetch"]
    log(f"{label}: early reject auto and off bit-identical {same}; fetch "
        f"bytes a particle identity {ident_fetch:.2f} MLP "
        f"{rep['fetch']:.2f}: {ratio:.2f} times fewer")
    check(same, f"{label}: populations differ with early reject auto and "
          f"off")
    check(ratio >= 2.0, f"{label}: fetch bytes a particle only {ratio:.2f} "
          f"times fewer than the identity run's")
    by_name = profile_run(f"{label} (profiled)", learned(dev, "mlp"),
                          LS_GENS)
    if by_name:
        for name, keys in (("K23 MLP fit (seed and boundaries)",
                            ("mlp_step", "mlp_adam", "mlp_init", "mlp_wsum",
                             "mlp_guard", "col_")),
                           ("K23 MLP transform and accept",
                            ("mlp_transform", "mlp_accept")),
                           ("K20b rounds", ("network_sir",))):
            v = [t for k, t in by_name.items() if any(s in k for s in keys)]
            tot_ms = sum(t[0] for t in v) / 1e3
            log(f"{label}: {name} device ms a generation "
                f"{tot_ms / LS_GENS:.5f} ({sum(t[1] for t in v)} launches)")
    return counts, modes


def learned_mlp_cpu_trail(dev) -> None:
    """The MLP leg at pop 1024 on the card and on the CPU (the plain
    versions, the same Philox streams): generation 0's epsilon within
    1e-3 relative; the two seed fits' predictions on 512 held-out prior
    simulations within 1e-2 of their sd, as the root mean square of the
    difference over the rows (400 Adam steps in other summation orders on
    statistics 1e-4 apart; the largest difference of a row is reported
    beside it: it grows with the rows taken, 1.04e-2 at 512 on an H100
    80GB HBM3); and generation 1's epsilon within 1e-3 on a CPU run fed the
    card's seed fit (Adam amplifies an ulp, so the CPU's own seed fit is
    reported beside it, not held)."""
    import numpy as np

    import pyabc_tpu_torch as pt

    def trail(h):
        return [float(e) for e in h.get_all_populations()["epsilon"][1:]]

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    def snapshot(pred, store):
        fit = pred.fit

        def wrapped(*args, **kwargs):
            fit(*args, **kwargs)
            store["_params"] = [{k: v.copy() for k, v in layer.items()}
                                for layer in pred._params]
            for k in ("_mu", "_sd", "_ymu", "_ysd"):
                store[k] = getattr(pred, k).copy()

        pred.fit = wrapped

    trails, seeds = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        abc = learned(where, "mlp", pop=LS_CPU_POP)
        seeds[where] = {}
        snapshot(abc.distance_function.sumstat.predictor, seeds[where])
        trails[where] = trail(abc.run(max_nr_populations=3))
        log(f"learned-statistics MLP leg at pop {LS_CPU_POP} ({where}, "
            f"{time.perf_counter() - t0:.1f} s): eps trail "
            f"{[round(e, 5) for e in trails[where]]}")
    r = rel(trails[dev], trails["cpu"])
    held = ls_rows(dev, 512, seed=77)["ss"].cpu().numpy()
    preds = {}
    for where, snap in seeds.items():
        p = pt.MLPPredictor()
        for k, v in snap.items():
            setattr(p, k, v)
        preds[where] = p.predict(held)
    diff = preds[dev] - preds["cpu"]
    sd = preds["cpu"].std(0)
    gap = (np.sqrt(np.mean(diff ** 2, 0)) / sd).max()
    gap_max = (np.abs(diff).max(0) / sd).max()
    abc = learned("cpu", "mlp", pop=LS_CPU_POP)
    pred = abc.distance_function.sumstat.predictor

    def fed(*_args, **_kwargs):
        for k, v in seeds[dev].items():
            setattr(pred, k, v)

    pred.fit = fed
    fed_trail = trail(abc.run(max_nr_populations=3))
    rf = rel(trails[dev], fed_trail)
    log(f"learned-statistics MLP leg at pop {LS_CPU_POP}: |card - cpu| / "
        f"cpu per generation {[float(f'{v:.2e}') for v in r]}; the seed "
        f"fits' predictions on 512 held-out rows {gap:.3e} of their sd "
        f"(root mean square; the largest row {gap_max:.3e}); a "
        f"CPU run fed the card's seed fit: eps trail "
        f"{[round(e, 5) for e in fed_trail]}, against the card "
        f"{[float(f'{v:.2e}') for v in rf]}")
    check(r[0] <= 1e-3, "learned MLP leg: the card's generation-0 epsilon "
          "is more than 1e-3 off the CPU's")
    check(gap <= 1e-2, "learned MLP leg: the card's and the CPU's seed fits "
          "predict more than 1e-2 of an sd apart on held-out rows")
    check(max(rf[:2]) <= 1e-3, "learned MLP leg: the CPU fed the card's "
          "seed fit is more than 1e-3 off the card in its first two "
          "epsilons")


# ------------------------------------------- the host-refit mode (GP)
#: this slice's kernel, and the path of the GP leg (generation 0 and the
#: calibration run K5 on the raw statistics; early reject off)
GP_KERNELS = ("gp_accept",)
GP_PATH = ("propose", "mvn_mixture_logpdf", "network_sir",
           "pnorm_accept_weight", "compact_round", "normalize_quantile",
           "mvn_fit", "pack_fetch", "generation_health") + GP_KERNELS
#: the host-refit legs: kind -> the generations whose boundary fit ran
#: (chunks of 2 after generation 0's own, LS_GENS 8: a boundary after
#: generations 0, 2, 4, 6, the last chunk none; fit_every 3 counts in the
#: JAX package's t, 1, 3, 5, 7: fits at 1, 5)
HOST_LEGS = {"gp": [0, 2, 4, 6], "lasso": [0, 2, 4, 6],
             "model selection": [0, 2, 4, 6], "fit_every 3": [0, 4],
             "identity statistic": []}
#: the kernel each leg's transform runs (K5 after the identity's none)
HOST_KERNEL = {"gp": "gp_accept", "lasso": "linear_accept",
               "fit_every 3": "linear_accept",
               "identity statistic": "pnorm_accept_weight"}


def gp_fit(x: dict, n: int, C: int, seed: int, dev):
    """A GPPredictor() fitted on the host (the host-refit mode's fit) to n
    rows of a simulated round of the leg's network SIR (C' 2: theta; more:
    noisy nonlinear mixes of it) -> its device parameters."""
    import numpy as np

    import pyabc_tpu_torch as pt

    rows = x["ss"][:n].double().cpu().numpy()
    theta = x["theta"][:n].double().cpu().numpy()
    if C > theta.shape[1]:
        rng = np.random.default_rng(seed)
        theta = np.sin(theta @ rng.normal(size=(theta.shape[1], C))) \
            + 0.01 * rng.normal(size=(n, C))
    gp = pt.GPPredictor(seed=seed)
    gp.fit(rows, theta[:, :C])
    return gp.device_params(dev), gp


def gp_case(dev, label, x, params, gen, ps, timed) -> dict:
    """The GP kernel against its plain version on one transform: the
    transform of the round's rows, then the accept for each p of ``ps``:
    rows and distances within 1e-5 of their scale (sum |k a| + |ymu|, the
    sum cancelling at a small alpha), flags equal away from eps, log
    weights equal, the values mode bit-equal to the accept's, the same
    bits run to run; timed: device ms (a CUDA graph), call ms, the plain
    version's ms, the bound."""
    import torch

    from pyabc_tpu_torch.kernels import (gp_accept, gp_accept_plain,
                                         gp_transform_rows,
                                         gp_transform_rows_plain)
    from pyabc_tpu_torch.kernels.gp_sumstat import (distance_scale,
                                                    transform_scale)

    ss, x0 = x["ss"], x["x0"]
    B, S = ss.shape
    cap, C = params["a"].shape
    n_eff = int((params["a"] != 0).any(1).nonzero().max()) + 1
    w = torch.ones(C, device=dev)
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    logpri = torch.randn(B, generator=gen, device=dev) - 3.0
    logq = torch.randn(B, generator=gen, device=dev) - 2.0
    rows = gp_transform_rows(ss, params)
    rows_r = gp_transform_rows_plain(ss, params)
    scale = transform_scale(ss, params).float()
    torch.cuda.synchronize()
    r_err = abs_err(rows, rows_r)
    r_rel = float(((rows - rows_r).abs() / scale).max())
    check(bool(((rows - rows_r).abs() <= 1e-5 * scale).all()),
          f"GP transform ({label}) outside 1e-5 of its scale")
    inf = torch.tensor(math.inf, device=dev)
    out = None
    for p in ps:
        d_all = gp_accept_plain(ss, x0, params, w, inf, valid, p=p)[0]
        eps = torch.quantile(d_all, 0.3)
        args = (ss, x0, params, w, eps, valid)
        kw = dict(p=p, logpri=logpri, logq=logq)
        d_k, a_k, lw_k = gp_accept(*args, **kw)
        d_p, a_p, lw_p = gp_accept_plain(*args, **kw)
        v_k = gp_accept.values(ss, x0, params, w, p=p)
        again = gp_accept(*args, **kw)
        dscale = distance_scale(ss, x0, params, w).float()
        torch.cuda.synchronize()
        far = (d_p - eps).abs() > 1e-5 * dscale
        flags = bool((a_k == a_p)[far].all())
        err = abs_err(d_k, d_p)
        d_rel = float(((d_k - d_p).abs() / dscale).max())
        repeat = all(torch.equal(a, b) for a, b in zip((d_k, a_k, lw_k),
                                                       again))
        log(f"GP gp_accept {label} p={p} (B={B}, S {S}, cap {cap} with "
            f"{n_eff} points, C' {C}): max_abs_err(d)={err:.3e} ({d_rel:.2e} "
            f"of its scale), transformed rows {r_err:.3e} ({r_rel:.2e} of "
            f"their scale, up to {float(scale.max()):.3e}), accepted "
            f"{int(a_k.sum())}, flags equal away from eps {flags}, values "
            f"mode bit-equal {torch.equal(v_k, d_k)}, the same bits run to "
            f"run {repeat}")
        check(bool(((d_k - d_p).abs() <= 1e-5 * dscale).all()) and flags
              and torch.equal(lw_k, lw_p) and torch.equal(v_k, d_k)
              and repeat,
              f"GP accept ({label}, p {p}): distances outside 1e-5 of their "
              f"scale, flags or log weights differ, the values mode differs "
              f"or a repeat differs")
        if not (timed and p == 2.0):
            continue
        # the rows and x0, the transform (its used points) read; logpri,
        # logq, valid read and d, accept, log weight written a lane; a
        # pair's S differences, S fused square-adds, the exponent's
        # division and exp, C' multiply-adds, over the used points
        nbytes = ((B + 1) * S + n_eff * (S + C) + 2 * S + C + 1 + C) * 4 \
            + B * 18
        flops = (B + 1) * n_eff * (3 * S + 2 + 2 * C)
        out = dict(
            err=err, rel_err=d_rel,
            call_ms=time_ms(lambda: gp_accept(*args, **kw), 20),
            ms=graph_ms(lambda: gp_accept(*args, **kw), iters=10),
            plain_ms=time_ms(lambda: gp_accept_plain(*args, **kw), 3),
            bound=bound(nbytes, flops), library_ms=None,
            transform_ms=graph_ms(lambda: gp_transform_rows(ss, params),
                                  iters=10),
            transform_call_ms=time_ms(lambda: gp_transform_rows(ss, params),
                                      20),
            transform_err=r_err)
        log(f"GP gp_accept {label} p=2: ms={out['ms']:.5f} call_ms="
            f"{out['call_ms']:.5f} plain_ms={out['plain_ms']:.5f} "
            f"transform_ms={out['transform_ms']:.5f} bound_ms="
            f"{out['bound'][0]:.6f} ({out['bound'][1]}; {flops:.4e} "
            f"operations)")
    return out


def gp_checks(dev) -> dict:
    """The GP kernel against its plain version on the card, over a round
    of the GP leg (B 65536 simulated network SIR rows, S 128): a
    GPPredictor() fit on 16384 of them (cap 512, C' 2) for p 2, 1 and inf
    (timed at p 2); a fit on 300 rows (below cap: 212 zero-padded points)
    and a fit to 8 targets (C' 8), each at p 2."""
    import torch

    from pyabc_tpu_torch.utils import pick_batch

    B = pick_batch(LS_POP)
    x = ls_rows(dev, B, seed=47)
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    main, _gp = gp_fit(x, LS_POP, 2, 3, dev)
    out = {"gp_accept": gp_case(dev, "main shape", x, main, gen,
                                (2.0, 1.0, math.inf), timed=True)}
    small, _gp = gp_fit(x, 300, 2, 4, dev)
    gp_case(dev, "below cap", x, small, gen, (2.0,), timed=False)
    wide, _gp = gp_fit(x, LS_POP, 8, 5, dev)
    gp_case(dev, "C' 8", x, wide, gen, (2.0,), timed=False)
    return out


def host_leg(dev, kind: str, label: str):
    """One host-refit leg at the learned leg's width, the counts reset just
    before it -> (launch counts, mode counts, the run, its History, its
    report): every generation, the boundary fits where the cadence puts
    them, History rows 128 wide throughout, telemetry mode host, early
    reject off with the JAX package's reason, one counter read a round
    and one fetch a chunk, the transform's kernel launched; the refit
    generations, the trail, the posterior means, the wall split and the
    syncs a generation logged."""
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    abc = learned(dev, kind)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=LS_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, modes = launch_counts(), mode_launch_counts()
    rep = ls_report(label, abc, h, wall)
    tel = [h.get_telemetry(t) for t in range(h.max_t + 1)]
    refits = [t for t, x in enumerate(tel) if x.get("sumstat_refit")]
    widths = {h.get_weighted_sum_stats(t)[1].shape[1]
              for t in range(h.max_t + 1)}
    gates = {f["gate"]: f["reason"] for f in abc.capability_fallbacks}
    pred = getattr(abc.distance_function.sumstat, "predictor", None)
    chosen = type(getattr(pred, "chosen", None)).__name__
    log(f"{label}: boundary fits at generations {refits}; History rows "
        f"{sorted(widths)} wide; telemetry {tel[0].get('sumstat')}; "
        f"distance_changed at "
        f"{[t for t, x in enumerate(tel) if x.get('distance_changed')]}; "
        f"fallbacks {gates}" + (f"; the winner {chosen}"
                                if kind == "model selection" else ""))
    log(f"{label}: kernel launches {counts}; GP transform "
        f"{modes['gp_accept:transform']}, values {modes['gp_accept:values']}")
    n_chunks = 1 + -(-(LS_GENS - 1) // LS_G)
    by = rep["syncs"]["by_kind"]
    check(set(by) == {"round_counters", "chunk_fetch"}
          and 1 <= by["round_counters"] - sum(rep["rounds"]) <= 2
          and by["chunk_fetch"] == n_chunks,
          f"{label}: a host read beyond one a round and one a chunk: {by}")
    check(refits == HOST_LEGS[kind],
          f"{label}: the boundary fits were at {refits}")
    check(widths == {128} and tel[0]["sumstat"]["mode"] == "host",
          f"{label}: History rows {widths} wide, telemetry "
          f"{tel[0].get('sumstat')}")
    check("sumstat_device" in gates and "early_reject" in gates
          and counts["segment_round"] == 0,
          f"{label}: the host-refit mode or early reject's refusal not "
          f"recorded: {gates}")
    kernel = HOST_KERNEL.get(kind, "gp_accept" if chosen == "GPPredictor"
                             else "linear_accept")
    check(counts[kernel] > 0, f"{label}: {kernel} was never launched")
    return counts, modes, abc, h, rep


def host_refit_legs(dev) -> dict:
    """Phase 4's host-refit legs (this slice's main path): the GP leg, the
    counts reset just before it (its counts are the GP kernel's launches),
    with every kernel of its path launched and its values mode at each
    boundary, once more under torch.profiler; then the Lasso, model
    selection and fit_every 3 legs; then IdentitySumstat() against the
    plain PNormDistance(p=2) fetching float32: populations, weights,
    distances and the trail bit-identical -> the GP leg's launch counts."""
    import numpy as np

    gp_counts, gp_modes, _abc, _h, _rep = host_leg(
        dev, "gp", "host-refit GP leg (network SIR, S 128, cap 512)")
    check(all(gp_counts[k] > 0 for k in GP_PATH)
          and gp_modes["gp_accept:values"] == len(HOST_LEGS["gp"])
          and gp_modes["gp_accept:transform"] == 0,
          "GP leg: a kernel of the path was never launched, or the values "
          "mode ran other than once a boundary")
    by_name = profile_run("host-refit GP leg (profiled)", learned(dev, "gp"),
                          LS_GENS)
    if by_name:
        for name, keys in (("GP transform and accept", ("gp_",)),
                           ("K20b rounds", ("network_sir",))):
            v = [t for k, t in by_name.items() if any(s in k for s in keys)]
            tot_ms = sum(t[0] for t in v) / 1e3
            log(f"host-refit GP leg: {name} device ms a generation "
                f"{tot_ms / LS_GENS:.5f} ({sum(t[1] for t in v)} launches)")
    for kind in ("lasso", "model selection", "fit_every 3"):
        host_leg(dev, kind, f"host-refit {kind} leg (network SIR, S 128)")
    _c, _m, _a, h_id, _r = host_leg(
        dev, "identity statistic",
        "host-refit IdentitySumstat() leg (network SIR, S 128)")
    plain = learned(dev, "identity", fetch_dtype="float32")
    with plain_versions_raise():
        h_plain = plain.run(max_nr_populations=LS_GENS)
    rows = all(np.array_equal(h_id.get_weighted_sum_stats(t)[1],
                              h_plain.get_weighted_sum_stats(t)[1])
               for t in range(LS_GENS))
    same = populations_identical(h_id, h_plain)
    log(f"host-refit IdentitySumstat() leg: populations, weights, distances "
        f"and the trail bit-identical to PNormDistance(p=2) fetching "
        f"float32 {same}, History rows too {rows}")
    check(same and rows, "IdentitySumstat() leg: not bit-identical to the "
          "plain p-norm")
    return gp_counts


def gp_cpu_trail(dev) -> None:
    """The GP leg at pop 1024 on the card and on the CPU (the plain
    versions, the same Philox streams): generation 0's epsilon within 1e-6
    relative; the first boundary fit's parameters (the host's, on each
    run's fetched generation 0) within 1e-6 of their largest value (the
    weights a of the kernel system within 1e-3: the solve's condition
    amplifies a row's last bits) and the subsample's length scale within
    1e-6; generations 1 and 2's epsilons within 1e-3."""
    import numpy as np

    trails, fits = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        abc = learned(where, "gp", pop=LS_CPU_POP)
        pred = abc.distance_function.sumstat.predictor
        fit, snap = pred.fit, {}

        def wrapped(*args, _fit=fit, _pred=pred, _snap=snap, **kwargs):
            _fit(*args, **kwargs)
            if not _snap:
                _snap.update({k: np.copy(getattr(_pred, k)) for k in (
                    "_X", "_alpha_w", "_ls", "_mu", "_sd", "_ymu")})

        pred.fit = wrapped
        h = abc.run(max_nr_populations=3)
        trails[where] = [float(e) for e in
                         h.get_all_populations()["epsilon"][1:]]
        fits[where] = snap
        log(f"host-refit GP leg at pop {LS_CPU_POP} ({where}, "
            f"{time.perf_counter() - t0:.1f} s): eps trail "
            f"{[round(e, 5) for e in trails[where]]}")
    r = [abs(a - b) / abs(b) for a, b in zip(trails[dev], trails["cpu"])]
    gaps = {k: float(np.abs(fits[dev][k] - fits["cpu"][k]).max()
                     / max(np.abs(fits["cpu"][k]).max(), 1e-30))
            for k in fits["cpu"]}
    exact = all(np.array_equal(fits[dev][k], fits["cpu"][k])
                for k in fits["cpu"])
    log(f"host-refit GP leg at pop {LS_CPU_POP}: |card - cpu| / cpu per "
        f"generation {[float(f'{v:.2e}') for v in r]}; the first boundary "
        f"fit's parameters bit-equal {exact}, largest differences of each "
        f"(of its largest value) "
        f"{ {k: float(f'{v:.2e}') for k, v in gaps.items()} }")
    check(r[0] <= 1e-6, "GP leg: the card's generation-0 epsilon is more "
          "than 1e-6 off the CPU's")
    check(all(v <= 1e-6 for k, v in gaps.items() if k != "_alpha_w")
          and gaps["_alpha_w"] <= 1e-3,
          f"GP leg: the card's and the CPU's first boundary fits differ: "
          f"{gaps}")
    check(max(r[1:3]) <= 1e-3, "GP leg: the card's generations 1-2 are "
          "more than 1e-3 off the CPU's")


# ------------------------------------------- K17, and K14 on the ring
#: the LV GridSearchCV leg's grid and fold count
K17_GRID, K17_CV = (0.25, 0.5, 1.0, 2.0, 4.0), 5
#: operations of one (held-out row, component, scaling) term beyond the
#: maha: the scaled exponent, the online log-sum-exp (an exp counted as
#: one)
K17_TERM_OPS = 8


def k17_inputs(dev, n_cap: int, n_live: int, dims, seed: int):
    """Rows (LV prior draws at d 4, else standard normals; K > 1 each row
    zero-padded past its model's dim), positive normalized weights on the
    first ``n_live`` rows, and each row's model (K > 1)."""
    import torch

    from pyabc_tpu_torch.models import lotka_volterra as lv

    d, K = max(dims), len(dims)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = (lv.default_prior().rvs_array(n_cap, g, dev) if d == 4
         else torch.randn(n_cap, d, generator=g, device=dev))
    w = torch.rand(n_cap, generator=g, device=dev) + 0.1
    w[n_live:] = 0.0
    m = None
    if K > 1:
        m = torch.randint(0, K, (n_cap,), generator=g, device=dev,
                          dtype=torch.int32)
        dim_of = torch.tensor(dims, device=dev)[m.long()]
        X = torch.where(torch.arange(d, device=dev)[None, :]
                        < dim_of[:, None], X, torch.zeros_like(X))
    return X.contiguous(), (w / w.sum()).contiguous(), m


def k17_bound(folds, w, m, dims, n_folds: int, C: int):
    """K17's least time: the held-out pairs these inputs need (each test
    row of positive weight against each train row of positive weight of
    its fold and model), d + 2 (d^2 + d) operations a pair and
    K17_TERM_OPS a scaling, beside the fold fits' moments; the bytes read
    and written once."""
    n, d, K = w.shape[0], max(dims), len(dims)
    pairs = 0
    for k in range(K):
        live = w > 0 if m is None else (w > 0) & (m == k)
        total = int(live.sum())
        for f in range(n_folds):
            test = int((live & (folds == f)).sum())
            pairs += test * (total - test)
    ops = (pairs * (d + 2 * (d * d + d) + K17_TERM_OPS * C)
           + K * n_folds * n * (2 * d + 2 * d * d))
    nbytes = (n * d + 3 * n + K * (2 * n * d + 3 * n + 2 * d * d + d + 1)
              + K * C + K) * 4
    return bound(nbytes, ops), pairs


def k17_case(dev, label: str, n_cap: int, n_live: int, dims, scalings,
             cv: int, n_rows: int | None = None, timed: bool = False,
             seed: int = 0):
    """K17 against its plain version: the scores within 1e-4 relative
    (the same bits from run to run), the winner equal wherever the two
    best scores differ by more than 1e-4 relative, the params at K8's
    tolerances. ``n_rows``: a list generation's fold table (that n's fold
    ids, ``cv`` folds), else a constant n's (``min(cv, n_live)``)."""
    import torch

    from pyabc_tpu_torch.kernels import (grid_search_cv,
                                         grid_search_cv_models_plain,
                                         grid_search_cv_plain)
    from pyabc_tpu_torch.kernels.mvn_fit import STACKED_KEYS
    from pyabc_tpu_torch.transition import fold_ids, silverman_rule_of_thumb

    K, d = len(dims), max(dims)
    X, w, m = k17_inputs(dev, n_cap, n_live, dims, seed)
    rows = n_live if n_rows is None else n_rows
    folds = torch.as_tensor(fold_ids(rows, cv, n_cap), device=dev)
    F = cv if n_rows is not None else min(cv, rows)
    sel = silverman_rule_of_thumb
    if K == 1:
        kw = dict(n_folds=F, dim=d, scalings=scalings, bandwidth_selector=sel)

        def run():
            return grid_search_cv(X, w, folds, **kw)

        def plain():
            return grid_search_cv_plain(X, w, folds, **kw)
    else:
        # the stacked params' dims built once, outside any graph capture
        kw = dict(n_folds=F, dims=list(dims), scalings=scalings,
                  selectors=[sel] * K, dims_tensor=torch.tensor(
                      [float(x) for x in dims], device=dev))

        def run():
            return grid_search_cv.models(X, w, m, folds, **kw)

        def plain():
            return grid_search_cv_models_plain(X, w, m, folds, **kw)
    got, scores, best = run()
    _again, scores2, _b = run()
    ref, ref_scores, ref_best = plain()
    check(torch.equal(scores, scores2), f"K17 {label}: the scores changed "
          f"bits from run to run")
    scores, ref_scores = scores.reshape(K, -1), ref_scores.reshape(K, -1)
    best, ref_best = best.reshape(K), ref_best.reshape(K)
    scale = float(ref_scores.abs().max())
    rel = float(((scores - ref_scores).abs() / ref_scores.abs().clamp_min(
        1e-30)).max())
    check(within(scores, ref_scores, 1e-4 * scale, 1e-4),
          f"K17 {label}: scores outside 1e-4 relative ({rel:.3e})")
    err = float((scores - ref_scores).abs().max())
    fit_err = 0.0
    for k in range(K):
        top = torch.sort(ref_scores[k], descending=True).values
        clear = (len(top) < 2
                 or float(top[0] - top[1]) > 1e-4 * float(top[0].abs()))
        if clear:
            check(int(best[k]) == int(ref_best[k]),
                  f"K17 {label}: model {k}'s winner {int(best[k])} against "
                  f"the plain version's {int(ref_best[k])}")
        if int(best[k]) == int(ref_best[k]):
            pick = ((lambda p: p) if K == 1 else
                    (lambda p: {key: p[key][k] for key in STACKED_KEYS}))
            fit_err = max(fit_err, compare_fit(pick(got), pick(ref))[1])
    (bound_ms, bound_by), pairs = k17_bound(folds, w, m, dims, F,
                                            len(scalings))
    log(f"K17 grid_search_cv {label} (n_cap={n_cap}, {n_live} weighted, "
        f"d={d}, K={K}, {len(scalings)} scalings, {F} folds, {pairs} "
        f"held-out pairs): scores rel err {rel:.3e} (abs {err:.3e}), "
        f"winners {best.tolist()} (plain {ref_best.tolist()}), params "
        f"abs err {fit_err:.3e}; the same bits run to run")
    if not timed:
        return None
    return dict(err=max(err, fit_err), rel_err=rel,
                plain_ms=time_ms(plain, 2, 1),
                call_ms=time_ms(run, 5, 1), ms=graph_ms(run, 5, 3),
                bound=(bound_ms, bound_by), library_ms=None)


def k17_checks(dev) -> dict:
    """K17 at LV config 2's shape (n 1000, d 4, 5 scalings, cv 5), at
    n_cap 16384 (the LV GridSearchCV leg), on fold tables (a list
    generation of 1500 rows in 2048, and of 4 rows at d 1: fewer fold ids
    than cv), K = 3 at config 5's shape (d_max 2, dims 1, 2, 2) and a small odd
    shape (n_cap 64, 37 rows, d 1, 3 scalings, cv 3)."""
    out = {"grid_search_cv:config2": k17_case(
        dev, "LV config 2", 1024, 1000, [4], K17_GRID, K17_CV, timed=True)}
    out["grid_search_cv"] = k17_case(dev, "n_cap 16384", 16384, 16384, [4],
                                     K17_GRID, K17_CV, timed=True, seed=1)
    out["grid_search_cv:fold_table"] = k17_case(
        dev, "fold table", 2048, 1500, [4], K17_GRID, K17_CV, n_rows=1500,
        timed=True, seed=2)
    k17_case(dev, "fold table of 4 rows", 2048, 4, [1], K17_GRID, K17_CV,
             n_rows=4, seed=3)
    out["grid_search_cv:models"] = k17_case(
        dev, "K = 3 (config 5)", 1024, 1000, [1, 2, 2], K17_GRID, K17_CV,
        timed=True, seed=4)
    k17_case(dev, "small odd", 64, 37, [1], (0.5, 1.0, 2.0), 3, seed=5)
    return out


#: the record ring of a pop-16384 noisy run: 8 n_cap rows
RING_ROWS = 8 * 16384


def k14_ring_checks(dev) -> dict:
    """K14 over the record ring of a pop-16384 noisy run (131072 rows, 40 %
    of them unwritten zeros) under a LocalTransition fit of 16384 rows
    (d 4), against its plain version within 1e-4 + 1e-5 relative."""
    import torch

    from pyabc_tpu_torch.kernels import local_logpdf, local_logpdf_plain
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.transition import LocalTransition

    n, d, B = 16384, 4, RING_ROWS
    X, w = local_population(dev, n, d, n, seed=16)
    cfg = LocalTransition.field_config(n, d, scaling=1.0, device=dev,
                                       k_cap=4096)
    params = LocalTransition.device_fit(
        X, w, dim=d, **{k: cfg[k] for k in ("scaling", "k_cap")},
        selection="threshold", k_table=cfg["k_table"])
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    ring = lv.default_prior().rvs_array(B, g, dev)
    ring[int(0.6 * B):] = 0.0
    ring = ring.contiguous()
    got = local_logpdf(ring, params)
    t0 = time.perf_counter()
    ref = local_logpdf_plain(ring, params)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = float((got - ref).abs().nan_to_num(0.0).max())
    log(f"K14 local_logpdf over the ring ({B} x {n}, d {d}): error "
        f"{err:.3e}, densities {float(ref.min()):.2f} to "
        f"{float(ref.max()):.2f}")
    check(within(got, ref, 1e-4, 1e-5), "K14 over the ring differs from "
          "its plain version beyond 1e-4 + 1e-5 relative")
    return {"local_logpdf:ring": dict(
        err=err, plain_ms=plain_s * 1e3,
        call_ms=time_ms(lambda: local_logpdf(ring, params), 3, 1),
        ms=graph_ms(lambda: local_logpdf(ring, params), 2, 2),
        bound=bound((B * d + n * (d * d + d + 2) + B) * 4,
                    B * n * (3 * d + 2 * d * d + 4)),
        library_ms=None)}


# ------------------ GridSearchCV legs; LocalTransition, noisy and segmented
#: LV config 2 with GridSearchCV: the scale lane's width (pop 16384, seed
#: 101, the JAX observation of seed 123, chunks of 8), 8 generations
LVG_POP, LVG_GENS = 16384, 8
#: K17's device ops (torch.profiler's names; K8's fit of the full data is
#: mvn_fit_kernel, which no other kernel launches on this leg)
K17_DEVICE_OPS = ("fold_lists_kernel", "fold_fit_kernel", "score_kernel",
                  "fold_sum_kernel", "finish_kernel", "mvn_fit_kernel")
LVG_PATH = ("propose", "mvn_mixture_logpdf", "lv_simulate",
            "pnorm_accept_weight", "compact_round", "normalize_quantile",
            "grid_search_cv", "scale_reduce", "pack_fetch",
            "generation_health")
#: config 3 with LocalTransitions: generations (cut from 12 for the
#: script's time limit) and the K = 2 pair's pop and generations
C3L_GENS, C3P_POP, C3P_GENS = 8, 4096, 6


def lv_grid(where, pop: int = LVG_POP):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=pop,
                    eps=pt.MedianEpsilon(), seed=SCALE_SEED,
                    transitions=pt.GridSearchCV(
                        pt.MultivariateNormalTransition(),
                        {"scaling": list(K17_GRID)}, cv=K17_CV),
                    fused_generations=SCALE_G, device=where)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    return abc


def lv_grid_leg(dev) -> dict:
    """LV config 2 with GridSearchCV(MVN, K17_GRID, cv 5) at the scale
    lane's width, counts reset just before: K17 launched every generation
    in K8's place, the winner trail (each a scaling of the grid), syncs
    (one read a round, one fetch a chunk), the epsilon trail falling, the
    wall; once more under torch.profiler for K17's device ms a generation
    -> the launch counts."""
    import numpy as np

    from pyabc_tpu_torch.kernels import reset_launch_counts
    from pyabc_tpu_torch.models import lotka_volterra as lv

    label = "LV config 2, GridSearchCV"
    abc = lv_grid(dev)
    reset_launch_counts()
    h, wall, counts = seg_run(abc, LVG_GENS, label)
    n_gen = h.max_t + 1
    eps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    trail = [h.get_telemetry(t)["gridsearch_scaling"] for t in range(n_gen)]
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in lv.TRUE_PARS}
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    log(f"{label}: pop={LVG_POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={LVG_POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} (rounds "
        f"{rounds}, {syncs['by_kind']}); wall split {wall_split(abc)}")
    log(f"{label}: winner trail {trail} (grid {list(K17_GRID)}, cv "
        f"{K17_CV}); eps trail {[round(e, 4) for e in eps]}; posterior "
        f"means {means} true {lv.TRUE_PARS}")
    log(f"{label}: kernel launches {counts}")
    check(n_gen == LVG_GENS, f"{label} ran {n_gen} of {LVG_GENS} "
          f"generations")
    check(counts["grid_search_cv"] == n_gen and counts["mvn_fit"] == 0,
          f"{label}: K17 did not refit every generation in K8's place")
    check(all(counts[k] > 0 for k in LVG_PATH),
          f"a kernel of the {label}'s path was never launched")
    check(all(s in K17_GRID for s in trail), f"{label}: a winner outside "
          f"the grid")
    check(eps[-1] < eps[0] and all(math.isfinite(v)
                                   for v in means.values()),
          f"{label}: the epsilon trail did not fall, or a mean is not "
          f"finite")
    sync_check(abc, label)
    by_name = profile_run(f"{label} (profiled)", lv_grid(dev), LVG_GENS)
    if by_name:
        k17 = {k: v for k, v in by_name.items()
               if any(op in k for op in K17_DEVICE_OPS)}
        tot = sum(v[0] for v in k17.values()) / 1e3
        log(f"{label}: K17's device ms a generation {tot / LVG_GENS:.4f} "
            f"({ {k[:40]: round(v[0] / 1e3, 4) for k, v in k17.items()} })")
    return counts


def sir_local_stats(where) -> dict:
    """SIR config 4 with a LocalTransition: the card's run to its eight
    generations, or the CPU's first generations (cut at 30000
    evaluations) -> the temperature trail and the wall."""
    t0 = time.perf_counter()
    kw = ({"max_total_nr_simulations": 30_000} if where == "cpu" else {})
    abc = sir_config4(where, local=True)
    h = abc.run(max_nr_populations=SIR_GENS, **kw)
    return {"temps": [float(e) for e in
                      h.get_all_populations()["epsilon"][1:]],
            "wall": time.perf_counter() - t0}


@cpu_ref
def noisy_local_cpu() -> dict:
    return noisy_stats("cpu", local=True)


@cpu_ref
def sir_local_cpu() -> dict:
    return sir_local_stats("cpu")


def sir_local_run(dev) -> dict:
    """SIR config 4 with a LocalTransition on the card, counts reset just
    before: the trail ends at exactly T = 1, K14's ring passes (K14's
    launches beyond one a transition round) one a generation, and the
    first two temperatures within 1e-3 of the CPU's (the CPU reference
    process) -> the launch counts."""
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    label = "SIR config 4, LocalTransition"
    abc = sir_config4(dev, local=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=SIR_GENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts() | mode_launch_counts()
    temps = [float(e) for e in h.get_all_populations()["epsilon"][1:]]
    rounds = [g["rounds"] for g in abc.generation_log]
    ring = counts["local_logpdf"] - sum(rounds[1:])
    counts["local_logpdf:ring"] = ring
    log(f"{label}: pop={POP} gens={len(temps)} wall_s={wall:.3f} rounds "
        f"{rounds}; temperature trail {[round(t, 4) for t in temps]}; K14 "
        f"ring passes {ring}; wall split {wall_split(abc)}")
    log(f"{label}: kernel launches {counts}")
    check(temps[-1] == 1.0 and all(b <= a for a, b in zip(temps, temps[1:])),
          f"{label}: the temperature trail does not fall to exactly 1")
    check(ring == len(temps), f"{label}: {ring} ring passes for "
          f"{len(temps)} generations")
    check(all(counts[k] > 0 for k in LOCAL_KERNELS + NOISY_KERNELS)
          and counts["mvn_fit"] == counts["mvn_mixture_logpdf"] == 0,
          f"{label}: a kernel of its path never launched, or an MVN one "
          f"did")
    sync_check(abc, label)

    def compare():
        cpu = REFS.get("sir_local_cpu")["temps"]
        rel = [abs(a - b) / abs(b) for a, b in zip(temps, cpu)]
        log(f"{label} on the CPU ({len(cpu)} generations): temperatures "
            f"{[round(t, 4) for t in cpu]}; |card - cpu| / cpu "
            f"{[float(f'{r:.2e}') for r in rel]}")
        check(len(rel) >= 2 and max(rel[:2]) <= 1e-3,
              f"{label}: the CPU's first two temperatures differ from the "
              f"card's by more than 1e-3")

    PENDING.append(compare)
    return counts


def config3_local_run(dev) -> dict:
    """Config 3 with a LocalTransition, early reject on, off, off, on
    (C3L_GENS generations at pop C3_POP), counts reset just before:
    populations, weights, distances and trails bit-identical, slots
    retired, K18 and LocalTransition's kernels launched, no MVN kernel;
    then the K = 2 pair (a second birth-death model of initial count 25,
    pop C3P_POP, C3P_GENS generations) on and off, bit-identical -> the
    launch counts of the four single-model runs."""
    from pyabc_tpu_torch.kernels import reset_launch_counts

    label = "config 3, LocalTransition"
    reset_launch_counts()
    runs = []
    for early in TURNS:
        abc = config3(dev, early, local=True)
        h, wall, c = seg_run(abc, C3L_GENS, label)
        runs.append((h, wall, c))
        log(f"{label} early reject {'on' if early else 'off'}: wall_s="
            f"{wall:.3f} rounds {[g['rounds'] for g in abc.generation_log]}"
            f"; {seg_totals(h)}")
    counts = {k: sum(r[2][k] for r in runs) for k in runs[0][2]}
    same = all(populations_identical(runs[0][0], r[0]) for r in runs[1:])
    tot = seg_totals(runs[0][0])
    log(f"{label}: bit-identical in turns {same}; retired "
        f"{tot['retired_early']}; kernel launches {counts}")
    check(same, f"{label}: populations differ with early reject on and off")
    check(tot["retired_early"] > 0, f"{label}: no slot retired")
    check(all(counts[k] > 0 for k in LOCAL_KERNELS + ("segment_round",
                                                      "tau_leap"))
          and counts["mvn_fit"] == counts["mvn_mixture_logpdf"] == 0,
          f"{label}: a kernel of its path never launched, or an MVN one "
          f"did")
    pair = []
    for early in ("auto", False):
        abc = config3(dev, early, pop=C3P_POP, local=True, pair=True)
        h, wall, c = seg_run(abc, C3P_GENS, label + " (K = 2)")
        pair.append(h)
        log(f"{label} (K = 2) early reject {'on' if early else 'off'}: "
            f"wall_s={wall:.3f}; {seg_totals(h)}; launches {c}")
    same2 = populations_identical(*pair, K=2)
    log(f"{label} (K = 2): bit-identical on and off {same2}")
    check(same2 and seg_totals(pair[0])["retired_early"] > 0,
          f"{label} (K = 2): populations differ on and off, or nothing "
          f"retired")
    return counts


# ------------------------------------------------------- the host loop
#: BASELINE config 1 on the per-generation host loop: the 2-parameter
#: Gaussian (``make_gaussian_model``, 10 draws a lane, K4's Gaussian kernel),
#: its default prior, a p = 2 norm and MedianEpsilon at X1_OBS; pop 16384,
#: 8 generations. Its card-against-CPU check runs pop 1024 over two
#: generations.
X1_OBS = {"mean": 0.4, "std": 1.1}
X1_POP, X1_GENS, X1_SEED = 16384, 8, 3
X1_CMP_POP, X1_CMP_GENS = 1024, 2
#: the Gaussian kernel's phase-2 shape: B lanes of n draws
GAUSS_B, GAUSS_N = 65536, 10
#: LV config 2 through BatchedSampler() on the host loop
HL_LV_POP, HL_LV_GENS = 16384, 8
#: the tractable pair through the host loop (its CPU side in the
#: reference process)
HL_PAIR_SEEDS = tuple(range(8))
#: the kernels of the host loop's rounds (the per-round mode adds K26's
#: round kernel, the fused sampler K6)
X1_PATH = ("propose", "mvn_mixture_logpdf", "gaussian_simulate",
           "pnorm_accept_weight")
HL_LV_PATH = ("propose", "mvn_mixture_logpdf", "lv_simulate",
              "pnorm_accept_weight", "compact_round", "scale_reduce")
HL_KERNELS = ("gaussian_simulate",)
#: the host-loop modes of config 1 (ABCSMC arguments)
X1_MODES = {"pipelined": dict(fused_generations=1),
            "speculative": dict(fused_generations=1),
            "serial": dict(fused_generations=1, pipeline=False),
            "rounds": "BatchedSampler(fused=False)",
            "fused": {}}


def config1(where, seed: int = X1_SEED, pop: int = X1_POP,
            mode: str = "pipelined"):
    """BASELINE config 1 under ``mode``: the pipelined host loop (with a
    speculative round every generation after the second: ``speculative``),
    the serial loop, the per-round mode, or the fused chunk loop."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    kw = X1_MODES[mode]
    if mode == "rounds":
        kw = {"sampler": pt.BatchedSampler(fused=False)}
    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    pt.PNormDistance(p=2), population_size=pop,
                    eps=pt.MedianEpsilon(), seed=seed, device=where, **kw)
    if mode == "speculative":
        # the loop speculates after a strategy update slower than this
        abc.speculation_min_adapt_s = 0.0
    abc.new("sqlite://", X1_OBS, store_sum_stats=False)
    return abc


def gaussian_checks(dev) -> dict:
    """K4's Gaussian kernel against its plain version on the same Philox
    words: prior draws of config 1, B 65536 lanes of 10 draws; within rel
    1e-6 of each lane's scale |mu| + |sigma|."""
    import torch

    from pyabc_tpu_torch.kernels import philox, propose
    from pyabc_tpu_torch.kernels.gaussian_simulate import (
        gaussian_simulate, gaussian_simulate_plain)
    from pyabc_tpu_torch.models import gaussian

    B, n = GAUSS_B, GAUSS_N
    theta = propose(stream_on(dev, philox.PRIOR), B,
                    gaussian.default_prior().arrays(dev))[0]
    sim = stream_on(dev, philox.SIM_NOISE)
    k = gaussian_simulate(theta, n=n, stream=sim)
    p = gaussian_simulate_plain(theta, n=n, stream=sim)
    torch.cuda.synchronize()
    scale = (theta[:, 0].abs() + theta[:, 1].abs())[:, None]
    err = float((k - p).abs().max())
    rel = float(((k - p).abs() / scale).max())
    log(f"K4 gaussian_simulate (B {B}, n {n}): max_abs_err={err:.3e} "
        f"max_rel_err_of_scale={rel:.3e}")
    check(bool(torch.isfinite(k).all()) and rel <= 1e-6,
          "K4 gaussian_simulate outside rel 1e-6 of |mu| + |sigma|")
    # an observation of the mean or the std alone: one column a row
    for columns in ((0, -1), (-1, 0), (1, 0)):
        kc = gaussian_simulate(theta, n=n, stream=sim, columns=columns)
        pc = gaussian_simulate_plain(theta, n=n, stream=sim, columns=columns)
        rc = float(((kc - pc).abs() / scale).max())
        log(f"K4 gaussian_simulate columns {columns}: shape "
            f"{tuple(kc.shape)} max_rel_err_of_scale={rc:.3e}")
        check(kc.shape == pc.shape and rc <= 1e-6, f"K4 gaussian_simulate "
              f"with columns {columns} disagrees with its plain version")
    nb = (n + 3) // 4
    # theta read, the rows written; a Philox block 100 operations, a
    # Box-Muller pair's normal about 25, the two moments 6 a draw
    nbytes = B * 2 * 4 + B * 2 * 4 + 5 * 4
    flops = B * (nb * 100 + n * (25 + 6) + 4)
    return {"gaussian_simulate": dict(
        err=err, rel_err=rel,
        call_ms=time_ms(lambda: gaussian_simulate(theta, n=n, stream=sim),
                        50),
        ms=graph_ms(lambda: gaussian_simulate(theta, n=n, stream=sim)),
        plain_ms=time_ms(lambda: gaussian_simulate_plain(theta, n=n,
                                                         stream=sim), 5),
        bound=bound(nbytes, flops), library_ms=None)}


#: the toy's noise sd (``toy_run``) and the odd shape of the mean-only
#: kernel's check: B lanes of stride 2
TOY_NOISE_SD = 0.5
MEAN_ONLY_ODD = (257, 2)


def mean_only_checks(dev) -> dict:
    """K4's mean-only kernel against its plain version, bit for bit: the
    toy's prior round at B 65536 (stride 1) and the odd shape
    MEAN_ONLY_ODD."""
    import torch

    from pyabc_tpu_torch.kernels import philox, propose
    from pyabc_tpu_torch.kernels.gaussian_simulate import (
        mean_only_simulate, mean_only_simulate_plain)
    from pyabc_tpu_torch.models import gaussian

    B = GAUSS_B
    theta = propose(stream_on(dev, philox.PRIOR), B,
                    gaussian.mean_only_prior().arrays(dev))[0]
    kw = dict(noise_sd=TOY_NOISE_SD, stream=stream_on(dev, philox.SIM_NOISE))
    k = mean_only_simulate(theta, **kw)
    p = mean_only_simulate_plain(theta, **kw)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    Bo, stride = MEAN_ONLY_ODD
    odd = torch.randn(Bo, stride, generator=g, device=dev)
    ko = mean_only_simulate(odd, **kw)
    po = mean_only_simulate_plain(odd, **kw)
    torch.cuda.synchronize()
    err = max(float((k - p).abs().max()), float((ko - po).abs().max()))
    ok = (torch.equal(k, p) and torch.equal(ko, po)
          and bool(torch.isfinite(k).all()) and tuple(k.shape) == (B, 1)
          and tuple(ko.shape) == (Bo, 1))
    log(f"K4 mean_only_simulate: B {B} (stride {theta.shape[1]}) and "
        f"B {Bo} (stride {stride}) bit-equal to the plain version: {ok} "
        f"(max_abs_err={err:.3e})")
    check(ok, "K4 mean_only_simulate differs from its plain version")
    # theta read, x written (each once); one Philox block (about 100
    # operations), one Box-Muller normal (about 25), the product and sum
    return {"mean_only_simulate": dict(
        err=err,
        call_ms=time_ms(lambda: mean_only_simulate(theta, **kw), 50),
        ms=graph_ms(lambda: mean_only_simulate(theta, **kw)),
        plain_ms=time_ms(lambda: mean_only_simulate_plain(theta, **kw), 5),
        bound=bound(B * 4 + B * 4, B * (100 + 25 + 2)), library_ms=None)}


def lane_base_checks(dev) -> dict:
    """The lane base of K4's mean-only kernel, K20, K20b's family
    (unsegmented and its range entry), K19 and K20b network at the shapes
    of their phase-2 checks: a
    launch over the upper half of the round (lanes [B/2, B), the stream's
    lane0 at B/2) bit-equal to those rows of the whole round's launch, with
    noise on each, and held against the plain version over the same half
    at the kernel's phase-2 rule -> each mode's result, timed over the
    half."""
    from dataclasses import replace

    import torch

    from pyabc_tpu_torch.kernels import (mean_only_simulate,
                                         mean_only_simulate_plain,
                                         network_sir, network_sir_plain,
                                         ode_family_segments,
                                         ode_family_segments_plain,
                                         ode_family_simulate,
                                         ode_family_simulate_plain, philox,
                                         sir_simulate, sir_simulate_plain,
                                         tau_leap, tau_leap_plain)
    from pyabc_tpu_torch.models import gillespie as gl
    from pyabc_tpu_torch.models import model_selection as msel
    from pyabc_tpu_torch.models import sir
    from pyabc_tpu_torch.utils import pick_batch

    g = torch.Generator(device=dev)
    g.manual_seed(11)

    def stream(lane0):
        s = stream_on(dev, philox.SIM_NOISE)
        return philox.PhiloxStream(s.seed, s.generation, s.tag,
                                   s.max_rounds, s.counters, lane0=lane0)

    def within(atol, rtol):
        # |kernel - plain| <= atol + rtol |plain| where the plain row is
        # finite, and the same rows non-finite (K20's, K20b's rules)
        def rule(k, p):
            fin = torch.isfinite(p)
            return torch.equal(fin, torch.isfinite(k)) and bool(
                ((k - p).abs()[fin] <= atol + rtol * p.abs()[fin]).all())
        return rule

    def rel(k, p):
        # K20b network's: within 1e-4 of max(|plain|, 1)
        return bool(((k - p).abs() / p.abs().clamp_min(1)).le(1e-4).all())

    #: each kernel's phase-2 rule against its plain version
    rules = {"mean_only_simulate": ("bit-equal", equal_nan),
             "sir_simulate": ("|err| <= 1e-3 + 1e-4 |x|",
                              within(1e-3, 1e-4)),
             "ode_family_simulate": ("|err| <= 1e-4 + 1e-4 |x|",
                                     within(1e-4, 1e-4)),
             "ode_family_segments": ("|err| <= 1e-4 + 1e-4 |x|",
                                     within(1e-4, 1e-4)),
             "tau_leap": ("every count equal", equal_nan),
             "network_sir": ("1e-4 relative", rel)}
    cases = {}
    # K4's mean-only kernel: the toy's round width (B 65536, stride 1)
    cases["mean_only_simulate"] = (
        torch.randn(GAUSS_B, 1, generator=g, device=dev),
        lambda th, st: mean_only_simulate(th, noise_sd=TOY_NOISE_SD,
                                          stream=st),
        lambda th, st: mean_only_simulate_plain(th, noise_sd=TOY_NOISE_SD,
                                                stream=st),
        lambda n: bound(n * 4 + n * 4, n * (100 + 25 + 2)))
    # K20: SIR config 4's round with measurement noise (sd 10)
    x = sir_inputs(dev, B_MAIN)
    skw = dict(x["kw"], noise_sd=10.0)
    cases["sir_simulate"] = (
        x["theta"], lambda th, st: sir_simulate(th, stream=st, **skw),
        lambda th, st: sir_simulate_plain(th, stream=st, **skw),
        lambda n: bound(n * (2 + 15) * 4, n * (14 * 8 * 66 + 15 * 38)))
    # K20b family: config 5's round (K 3, n_obs 12, noise sd 0.3)
    fam = msel.ode_family()[0][0].family
    th5 = torch.rand(B_MAIN, 2, generator=g, device=dev) * torch.tensor(
        [1.0, 9.0], device=dev) + torch.tensor([0.05, 1.0], device=dev)
    m5 = torch.randint(0, 3, (B_MAIN,), generator=g, device=dev,
                       dtype=torch.int32)
    fkw = dict(n_obs=fam.n_obs, n_substeps=fam.n_substeps, dt=fam.dt,
               y0=msel.Y0, noise_sd=fam.noise_sd)
    steps5 = (fam.n_obs - 1) * fam.n_substeps
    cases["ode_family_simulate"] = (
        th5, lambda th, st: ode_family_simulate(
            th, m5[B_MAIN - th.shape[0]:], stream=st, **fkw),
        lambda th, st: ode_family_simulate_plain(
            th, m5[B_MAIN - th.shape[0]:], stream=st, **fkw),
        lambda n: bound(n * (2 * 4 + 4 + fam.n_obs * 4),
                        n * (steps5 * (4 * 5 + 12) + fam.n_obs * 38)))
    # K20b's range entry: the zoo's segmented family round, noise sd 0.3
    Bf = pick_batch(ZMS_POP)
    specs = msel.ode_family(segments=ZMS_SEGS)[0][0].family.specs
    thf, mf, _valid = family_round(dev, Bf)
    per_seg = specs[0].obs_per_seg * (specs[0].n_substeps * OPS_RK4_FAMILY
                                      + OPS_NORMAL)
    cases["ode_family_segments"] = (
        thf, lambda th, st: ode_family_segments(
            specs, th, st, m=mf[Bf - th.shape[0]:])[0],
        lambda th, st: ode_family_segments_plain(
            specs, th, st, m=mf[Bf - th.shape[0]:])[0],
        lambda n: bound(n * (2 * 4 + 4 + 12 * 4), n * ZMS_SEGS * per_seg))
    # K19: config 3's birth-death round (B 131072, 10 segments)
    bd = gl.make_birth_death_model(segments=C3_SEGS)
    xb = seg_inputs(dev, bd, gl.birth_death_prior(),
                    gl.observed_birth_death(segments=C3_SEGS), C3_BENCH_POP)
    bspec = bd.chain.kernel[1]
    bkw = dict(colmap=xb["imap"], width=xb["spec"].total_size)
    cases["tau_leap"] = (
        xb["theta"], lambda th, st: tau_leap(bspec, th, st, **bkw)[0],
        lambda th, st: tau_leap_plain(bspec, th, st, **bkw)[0],
        lambda n: bound(n * (2 + xb["spec"].total_size) * 4,
                        n * bspec.n_leaps * bspec.n_rates * OPS_PER_DRAW))
    # K20b network: the zoo's round (B 65536) with measurement noise (sd 8)
    nm = sir.make_network_sir_model()
    xn = seg_inputs(dev, nm, sir.network_sir_prior(),
                    sir.observed_network_sir(), pick_batch(ZOO_POP))
    nspec = replace(nm.chain.kernel[1], noise_sd=8.0)
    nsteps = nspec.n_obs * nspec.n_substeps
    cases["network_sir"] = (
        xn["theta"], lambda th, st: network_sir(nspec, th, st)[0],
        lambda th, st: network_sir_plain(nspec, th, st)[0],
        lambda n: bound(n * (2 + 128) * 4,
                        n * (nsteps * 8 * 78 + 128 * 38)))

    out = {}
    for name, (theta, fn, plain, bnd) in cases.items():
        B = theta.shape[0]
        half = theta[B // 2:].contiguous()
        full = fn(theta, stream(0))
        st = stream(B // 2)
        part = fn(half, st)
        torch.cuda.synchronize()
        ok = equal_nan(part, full[B // 2:]) and part.shape == \
            full[B // 2:].shape
        log(f"{name}:lane_base (B {B}, lanes [{B // 2}, {B})): bit-equal to "
            f"the upper half of the whole round's rows: {ok}")
        check(ok, f"{name}:lane_base: the upper half differs from the whole "
              f"round's rows")
        t0 = time.perf_counter()
        ref = plain(half, st)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        what, rule = rules[name]
        ok = ref.shape == part.shape and rule(part, ref)
        p_err = abs_err(part, ref)
        log(f"{name}:lane_base (lanes [{B // 2}, {B})) against its plain "
            f"version on the same half ({what}): {ok} (max_abs_err="
            f"{p_err:.3e})")
        check(ok, f"{name}:lane_base: outside its phase-2 rule ({what}) "
              f"against the plain version")
        out[f"{name}:lane_base"] = dict(
            err=p_err, ms=graph_ms(lambda: fn(half, st), iters=10,
                                   replays=3),
            call_ms=time_ms(lambda: fn(half, st), 10),
            plain_ms=plain_ms, bound=bnd(B // 2), library_ms=None)
        r = out[f"{name}:lane_base"]
        log(f"{name}:lane_base ({B // 2} lanes): ms={r['ms']:.5f} call_ms="
            f"{r['call_ms']:.5f} plain_ms={plain_ms:.3f} bound_ms="
            f"{r['bound'][0]:.6f} ({r['bound'][1]})")
    return out


def round_plain(ctx, mode: str, dyn: dict, key, B: int) -> dict:
    """Config 1's round of ``mode`` composed of the plain versions (K2,
    K3, K4's Gaussian, K5) on the card's tensors."""
    import torch

    from pyabc_tpu_torch.core.random import CALIBRATION_GENERATION
    from pyabc_tpu_torch.kernels import philox
    from pyabc_tpu_torch.kernels.gaussian_simulate import (
        gaussian_simulate_plain)
    from pyabc_tpu_torch.kernels.mvn_logpdf import mvn_mixture_logpdf_plain
    from pyabc_tpu_torch.kernels.pnorm_accept import (
        pnorm_accept_weight_plain)
    from pyabc_tpu_torch.kernels.propose import propose_plain

    ctr = torch.zeros(5, dtype=torch.int32, device=ctx.device)
    ctr[1] = key.round

    def st(tag):
        return philox.PhiloxStream(ctx.seed, key.generation, tag,
                                   ctx.stride_rounds, ctr)

    if mode == "transition":
        theta, logpri, valid = propose_plain(st(philox.TRANSITION), B,
                                             ctx.prior_arrays,
                                             dyn["trans_params"])
        logq = mvn_mixture_logpdf_plain(theta, dyn["trans_params"])
    else:
        tag = (philox.CALIBRATION if key.generation == CALIBRATION_GENERATION
               else philox.PRIOR)
        theta, logpri, valid = propose_plain(st(tag), B, ctx.prior_arrays)
        logq = logpri
    ss = gaussian_simulate_plain(theta, n=GAUSS_N, stream=st(
        philox.SIM_NOISE))
    if mode == "calibration":
        zero = torch.zeros(B, dtype=torch.float32, device=ctx.device)
        return {"theta": theta, "sumstats": ss, "distance": zero,
                "accepted": valid, "valid": valid, "log_weight": zero,
                "logq": logq}
    terms = dict(logpri=logpri, logq=logq) if mode == "transition" else {}
    d, acc, lw = pnorm_accept_weight_plain(ss, ctx.x0, dyn["dist_w"],
                                           dyn["eps"], valid, p=2.0,
                                           **terms)
    return {"theta": theta, "sumstats": ss, "distance": d, "accepted": acc,
            "valid": valid, "log_weight": lw, "logq": logq}


#: the lane kernels of one config 1 round of K26's round kernel, by mode
ROUND_LANES = {"prior": ("propose", "gaussian_simulate",
                         "pnorm_accept_weight"),
               "calibration": ("propose", "gaussian_simulate"),
               "transition": ("propose", "mvn_mixture_logpdf",
                              "gaussian_simulate", "pnorm_accept_weight")}


def round_device_ops(ctx, key, B: int, mode: str, dyn: dict) -> None:
    """One round of ``mode`` under torch.profiler: the wrappers' counts
    rise by one for each lane kernel of the mode and by nothing else, and
    the device runs exactly that many kernels (memory copies aside), so
    the round launches no PyTorch kernel. The profiler can drop an event
    of its window (one card run missed a round's first kernel, its launch
    counted): a kernel count below the lanes is taken again, at most
    twice; one above them fails at once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyabc_tpu_torch.kernels import launch_counts

    def profiled() -> list:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ctx.round(key, B, mode, dyn)
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    def kernels_of(names: list) -> list:
        return [n for n in names if not n.startswith(("Memcpy", "Memset"))]

    torch.cuda.synchronize()
    before = launch_counts()
    names = profiled()
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    kernels = kernels_of(names)
    for _ in range(2):
        if not names or len(kernels) >= len(ROUND_LANES[mode]):
            break
        names = profiled()
        kernels = kernels_of(names)
    log(f"K26 round kernel, {mode} mode: lane launches {delta}; device ops "
        f"{len(names)}, kernels {len(kernels)} "
        f"{sorted({n[:40] for n in kernels})}"
        + ("" if names else " (the profiler recorded no device op: the "
           "kernel count not measured)"))
    check(delta == {k: 1 for k in ROUND_LANES[mode]},
          f"K26 round kernel's {mode} round launched {delta}")
    check(not names or len(kernels) == len(ROUND_LANES[mode]),
          f"K26 round kernel's {mode} round ran {len(kernels)} device "
          f"kernels for {len(ROUND_LANES[mode])} lane launches")


def round_checks(dev) -> dict:
    """K26's round kernel in each mode against its plain versions on
    config 1 at the main path's round (pop 16384, B 65536): the prior
    round at the median distance of a first prior round, the calibration
    round, and a transition round from the host fit of that round's 16384
    nearest rows at their median. theta and the rows within 1e-5 + 1e-5
    |x|, distances within 1e-6 + 1e-5 |x|, flags equal away from eps, log
    weights and proposal densities within 1e-4 + 1e-5 |x| (-inf where the
    plain version's is). Each mode's round once more under the profiler:
    its lane kernels and no other device kernel. The round is a composite
    of its lane kernels: its time is theirs, back to back."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.core.random import RoundKey, generation_key

    abc = config1(dev)
    ctx = abc._build_context(X1_POP, 0.0)
    B = abc.sampler._pick_B(X1_POP)
    _m, dyn_inf = ctx.build_dyn_args(t=0, eps_value=math.inf)
    first = ctx.round(RoundKey(0, 0), B, "prior", dyn_inf)
    d0 = first["distance"].cpu().numpy()
    near = np.argsort(d0)[:X1_POP]
    eps0 = float(np.median(d0))
    abc.transitions[0].fit(first["theta"].cpu().numpy()[near],
                           np.full(X1_POP, 1.0 / X1_POP))
    eps1 = float(np.median(d0[near]))
    cases = {
        "prior": (RoundKey(0, 1), ctx.build_dyn_args(t=0, eps_value=eps0)),
        "calibration": (RoundKey(generation_key(-1), 0), ("prior", dyn_inf)),
        "transition": (RoundKey(1, 2), ctx.build_dyn_args(
            t=1, eps_value=eps1, model_probabilities={0: 1.0},
            transitions=abc.transitions))}
    worst = 0.0
    for mode, (key, (_mm, dyn)) in cases.items():
        k = ctx.round(key, B, mode, dyn)
        p = round_plain(ctx, mode, dyn, key, B)
        torch.cuda.synchronize()
        eps = dyn["eps"]
        parts = {"theta": within(k["theta"], p["theta"], 1e-5, 1e-5),
                 "sumstats": within(k["sumstats"], p["sumstats"], 1e-5,
                                    1e-5),
                 "distance": within(k["distance"], p["distance"], 1e-6,
                                    1e-5),
                 "valid": bool(torch.equal(k["valid"], p["valid"]))}
        far = (p["distance"] - eps).abs() > 1e-6 + 1e-5 * eps.abs()
        parts["accepted"] = bool((k["accepted"] == p["accepted"])[far].all())
        for name in ("log_weight", "logq"):
            a, b = k[name], p[name]
            fin = torch.isfinite(b)
            parts[name] = bool(torch.equal(torch.isfinite(a), fin)) and bool(
                ((a - b).abs()[fin] <= 1e-4 + 1e-5 * b.abs()[fin]).all())
        errs = {n: float((k[n] - p[n]).abs()[torch.isfinite(p[n])].max())
                for n in ("theta", "sumstats", "distance", "log_weight",
                          "logq")}
        err = max(errs.values())
        worst = max(worst, err)
        log(f"K26 round kernel, {mode} mode (B {B}): max_abs_err={err:.3e} "
            f"by output { {n: f'{e:.2e}' for n, e in errs.items()} }; "
            f"within tolerance {parts}; accepted "
            f"{int(k['accepted'].sum())} of {B}, "
            f"{int((k['accepted'] != p['accepted']).sum())} flags apart")
        check(all(parts.values()), f"K26 round kernel's {mode} round "
              f"disagrees with its plain versions ({parts})")
        round_device_ops(ctx, key, B, mode, dyn)
    key, (_mm, dyn) = cases["transition"]

    def fn(key, dyn):
        return ctx.round(key, B, "transition", dyn)

    params = dyn["trans_params"]
    n_live = int((params["weights"] > 0).sum())
    # the round's inputs (the fit, the prior, x0, w) read once and its
    # outputs (theta, rows, distance, flags, log weight, logq) written once;
    # K2 a Philox block of the ancestor and one of the normals a lane, K3
    # (2 d + 8) a lane and component, the simulator 3 blocks and 10 normals,
    # K5 4 a statistic
    d, S, n_fit = 2, 2, params["thetas"].shape[0]
    nbytes = (n_fit * (2 * d + 3) * 4 + 2 * d * d * 4 + B * (
        d * 4 + S * 4 + 4 + 1 + 1 + 4 + 4))
    flops = B * (2 * 100 + n_live * (2 * d + 8)
                 + 3 * 100 + GAUSS_N * 31 + 4 * S)
    return {"round_kernel": dict(
        err=worst, call_ms=time_ms(lambda: fn(key, dyn), 20),
        ms=graph_ms(lambda: fn(key, dyn), iters=10),
        plain_ms=time_ms(lambda: round_plain(ctx, "transition", dyn, key,
                                             B), 3),
        bound=bound(nbytes, flops), library_ms=None)}


def host_loop_run(abc, gens: int, label: str, path) -> tuple:
    """One host-loop run on the card, the counts set to 0 just before it
    and read just after, the plain versions set to raise -> (History, wall,
    the launch counts with the run's rounds of K26's round kernel, the
    reads of their outputs)."""
    import torch

    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by = abc.sync_ledger.summary()["by_kind"]
    counts = launch_counts() | {"round_kernel": by.get("round_fetch", 0)
                                + by.get("speculative_fetch", 0)}
    check(h.n_populations == gens,
          f"{label}: {h.n_populations} of {gens} generations")
    missing = [k for k in path if counts[k] == 0]
    check(not missing, f"{label}: {missing} never launched on its path")
    return h, wall, counts


def host_summary(abc, h, wall: float, label: str) -> dict:
    """The leg's wall split, its syncs by kind and a generation, the
    speculative round's accepted lanes and the epsilon trail."""
    log_ = abc.generation_log
    gens = len(log_)
    by = abc.sync_ledger.summary()["by_kind"]
    split = {k: round(sum(g.get(k, 0.0) for g in log_), 4)
             for k in ("sample_s", "adapt_s", "persist_s", "write_s")}
    split["flush_s"] = round(abc.flush_s, 4)
    spec = [g.get("speculative_accepted", 0) for g in log_]
    eps = [round(float(e), 5) for e in
           h.get_all_populations().query("t >= 0")["epsilon"]]
    log(f"{label}: wall {wall:.3f} s for {gens} generations "
        f"({sum(g['n'] for g in log_) / wall:.0f} accepted particles/s); "
        f"split {split}; syncs {abc.sync_ledger.count} "
        f"({abc.sync_ledger.count / gens:.2f} a generation) {by}; rounds "
        f"{[g['rounds'] for g in log_]}; speculative accepts {spec}; eps "
        f"{eps}")
    return {"wall": wall, "by_kind": by, "spec": spec, "eps": eps}


def config1_legs(dev) -> dict:
    """Config 1 at pop 16384 over 8 generations on the card: the pipelined
    host loop as a user gets it (``speculation_min_adapt_s`` 0.25 s, which
    this configuration's strategy updates stay below, so it does not
    speculate), the same with the speculative round forced every
    generation after the second (a non-default setting), the per-round
    mode (K26's round kernel every round) and the fused chunk loop as the
    yardstick, each with the counts reset just before it; then each once
    more under torch.profiler for the card's busy share. The syncs: one
    counter read a round and one collect a generation (a speculative round
    one read more) on the pipelined loop, one read a round in the
    per-round mode, and no other host read -> each mode's launch counts
    (``round_kernel``: the rounds of K26's round kernel, each its lane
    kernels' launches)."""
    out = {}
    for mode, label in (
            ("pipelined", "config 1, pipelined host loop (default)"),
            ("speculative", "config 1, pipelined host loop, speculation "
                            "forced (non-default)"),
            ("rounds", "config 1, per-round host loop"),
            ("fused", "config 1, fused chunk loop")):
        abc = config1(dev, mode=mode)
        path = X1_PATH + (("compact_round",) if mode != "rounds" else ()) \
            + (("round_kernel",) if mode in ("speculative", "rounds")
               else ())
        h, wall, counts = host_loop_run(abc, X1_GENS, label, path)
        log(f"{label} ({dev}): kernel launches {counts}")
        st = host_summary(abc, h, wall, label) if mode != "fused" else None
        by = abc.sync_ledger.summary()["by_kind"]
        rounds = sum(g["rounds"] for g in abc.generation_log)
        if mode == "rounds":
            # the calibration's rounds are K26's too; each round one K2 and
            # one K4 launch
            check(set(by) == {"round_fetch"}
                  and by["round_fetch"] >= rounds,
                  f"{label}: a host read besides one a round ({by})")
            check(counts["propose"] == counts["gaussian_simulate"]
                  == by["round_fetch"],
                  f"{label}: {by['round_fetch']} rounds but K2 "
                  f"{counts['propose']} and K4 {counts['gaussian_simulate']} "
                  f"launches")
        elif mode == "pipelined":
            spec_s = [g.get("speculative_accepted", 0)
                      for g in abc.generation_log]
            check(set(by) <= {"round_counters", "generation_collect",
                              "speculative_fetch"}
                  and by["generation_collect"] == X1_GENS + 1,
                  f"{label}: the reads are not a counter read a round and "
                  f"a collect a generation ({by})")
            log(f"{label}: speculative rounds "
                f"{by.get('speculative_fetch', 0)}, accepts {spec_s}")
        elif mode == "speculative":
            # every generation but the first two speculates
            n_spec = X1_GENS - 2
            check(set(by) <= {"round_counters", "generation_collect",
                              "speculative_fetch"}
                  and by["generation_collect"] == X1_GENS + 1
                  and by.get("speculative_fetch", 0) == n_spec
                  and counts["round_kernel"] == n_spec,
                  f"{label}: the reads are not a counter read a round, a "
                  f"collect a generation and one a speculative round "
                  f"({by})")
            check(sum(st["spec"]) > 0, f"{label}: no speculative lane was "
                  f"accepted")
        else:
            sync_check(abc, label)
            log(f"{label}: wall {wall:.3f} s, split {wall_split(abc)}, "
                f"syncs {abc.sync_ledger.count / X1_GENS:.2f} a generation")
        out[mode] = counts
        profile_run(f"{label} (profiled)", config1(dev, mode=mode), X1_GENS)
    return out


def config1_mean_only(dev) -> None:
    """Config 1's model observed through its mean alone (pop 4096, 3
    generations, the pipelined loop): every round simulates through K4's
    Gaussian kernel, one column a row, with the plain versions set to
    raise."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    pt.PNormDistance(p=2), population_size=4096,
                    eps=pt.MedianEpsilon(), seed=X1_SEED, device=dev,
                    fused_generations=1)
    abc.new("sqlite://", {"mean": X1_OBS["mean"]}, store_sum_stats=False)
    label = "config 1, mean observed alone"
    h, wall, counts = host_loop_run(abc, 3, label, X1_PATH)
    rounds = sum(g["rounds"] for g in abc.generation_log)
    df, w = h.get_distribution(0, h.max_t)
    mu = float(np.sum(df["mu"] * w))
    log(f"{label}: wall {wall:.3f} s, rounds {rounds}, K4 launches "
        f"{counts['gaussian_simulate']}, posterior mean of mu {mu:.4f}")
    check(counts["gaussian_simulate"] >= rounds > 0 and abs(mu - 0.4) < 0.3,
          f"{label}: K4 did not simulate every round, or the posterior "
          f"mean of mu {mu:.4f} is 0.3 or more off the observed mean")


def config1_cpu_check(dev) -> None:
    """Card against CPU at pop 1024 over two generations, the pipelined
    loop and the per-round mode: the same Philox streams, so the epsilon
    trails and the posterior means agree within 1e-3."""
    import numpy as np

    def run(where, mode):
        h = config1(where, pop=X1_CMP_POP, mode=mode).run(
            max_nr_populations=X1_CMP_GENS)
        eps = h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()
        df, w = h.get_distribution(0, h.max_t)
        return np.concatenate([eps, [np.sum(df["mu"] * w),
                                     np.sum(df["sigma"] * w)]])

    for mode in ("pipelined", "rounds"):
        with plain_versions_raise():
            card = run(dev, mode)
        cpu = run("cpu", mode)
        rel = np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-12)
        log(f"config 1 ({mode}) card against CPU at pop {X1_CMP_POP}: eps "
            f"and posterior means card {np.round(card, 5).tolist()} cpu "
            f"{np.round(cpu, 5).tolist()}; rel {np.round(rel, 7).tolist()}")
        check(bool(np.all(rel <= 1e-3)), f"config 1 ({mode}): card and CPU "
              f"apart by more than 1e-3")


def host_lv_leg(dev) -> dict:
    """LV config 2 (AdaptivePNormDistance, MedianEpsilon) through
    ``BatchedSampler()`` on the host loop, pop 16384, 8 generations: each
    generation's record ring reduced on the card (K9 in the collect's
    place of a read), so the reads are a counter read a round and a collect
    a generation -> its launch counts."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=HL_LV_POP,
                    eps=pt.MedianEpsilon(), sampler=pt.BatchedSampler(),
                    fused_generations=1, seed=0, device=dev)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    label = "LV config 2, host loop"
    h, wall, counts = host_loop_run(abc, HL_LV_GENS, label, HL_LV_PATH)
    log(f"{label} ({dev}): kernel launches {counts}")
    host_summary(abc, h, wall, label)
    by = abc.sync_ledger.summary()["by_kind"]
    check(set(by) == {"round_counters", "generation_collect"}
          and counts["scale_reduce"] == HL_LV_GENS,
          f"{label}: the ring was read or not reduced once a generation "
          f"({by}, K9 {counts['scale_reduce']})")
    check(sorted(abc.distance_function.weights) == list(range(
        HL_LV_GENS + 1)), f"{label}: a generation's weights are missing")
    return counts


@cpu_ref
def pair_host_cpu() -> dict:
    return pair_stats("cpu", "host")


def pair_host_loop(dev) -> dict:
    """The tractable pair through the pipelined host loop over
    HL_PAIR_SEEDS on the card (the plain versions set to raise) and on the
    CPU (the reference process): the seed mean of P(m = 0) within 0.05 of
    the exact 0.5529 and within 4 se of the CPU's -> the card's counts."""
    import numpy as np
    import torch

    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import model_selection as msel

    exact = float(msel.tractable_pair()[2](PAIR_X)[0])
    name = "tractable pair, host loop"
    torch.cuda.synchronize()
    reset_launch_counts()
    with plain_versions_raise():
        card = pair_stats(dev, "host")
    counts = launch_counts()
    log(f"{name} ({dev}): kernel launches {counts}")
    path = ("propose", "mvn_mixture_logpdf", "mean_only_simulate",
            "pnorm_accept_weight", "compact_round")
    check(all(counts[k] > 0 for k in path),
          f"a kernel of the {name}'s path was never launched")

    def summary(where, st):
        p0 = st["p0"]
        m = float(np.mean(p0))
        se = float(np.std(p0, ddof=1) / math.sqrt(len(p0)))
        log(f"{name} ({where}, {len(p0)} seeds, pop {PAIR_POP}, {PAIR_GENS} "
            f"generations, {st['wall']:.2f} s): mean P(m=0) {m:.4f} se "
            f"{se:.4f} (exact {exact:.4f}, {(m - exact) / se:+.2f} se)")
        return m, se

    m_d, se_d = summary(dev, card)
    check(abs(m_d - exact) < 0.05, f"{name}: the card's seed mean of "
          "P(m=0) is 0.05 or more off the exact posterior")

    def compare():
        m_c, se_c = summary("cpu", REFS.get("pair_host_cpu"))
        gap = (m_d - m_c) / math.hypot(se_d, se_c)
        log(f"{name}: card - cpu {m_d - m_c:+.4f} ({gap:+.2f} se)")
        check(abs(gap) < 4.0, f"{name}: card and CPU means differ by >= 4 "
              f"standard errors")

    PENDING.append(compare)
    return counts


# ----------------------------------------- sharded fused sampling (K24)
#: the LV sharded legs: the JAX mesh lane's LV configuration
#: (bench.py:1749-1753: make_lv_model, default_prior, PNormDistance(p=2),
#: MedianEpsilon, observed_data(seed=123)) at pop 16384 on 8 virtual shards,
#: G 8, 9 generations, seed 7; beside it the same seed unsharded
SH_N, SH_POP, SH_G, SH_GENS, SH_SEED = 8, 16384, 8, 9, 7
#: the adaptive leg's list (tests/test_sharded.py:355-374's [pop, pop - 28,
#: pop, pop - 60, pop, pop] at pop 128, scaled to the LV width) and the
#: same at pop 1024 for the card against the CPU over two generations
SH_AD_SIZES = [16384, 12800, 16384, 8704, 16384, 16384]
SH_AD_CPU_SIZES = [1024, 800, 1024, 544, 1024, 1024]
#: the mesh lane holds a mesh run bit-equal to the virtual shards; the
#: sharded reduction against the unsharded one is held to
#: tests/test_sharded.py's statistical rule: posterior means within 0.2
SH_POST_RULE = 0.2
SH_TOY_POP, SH_TOY_GENS = 300, 6
PAIR_SHARDED_SEEDS = tuple(range(8))
#: the kernels of the LV sharded leg's path (the host calibration's
#: compaction is K6's unsharded round) and of the adaptive leg's
SH_PATH = ("propose", "mvn_mixture_logpdf", "lv_simulate",
           "pnorm_accept_weight", "compact_round", "compact_round:shards",
           "shard_mask", "normalize_quantile", "mvn_fit", "pack_fetch",
           "pack_fetch:merge", "generation_health")
SH_AD_PATH = SH_PATH + ("moment_fold:shards", "moment_finish:shards")
SHARD_KERNELS = ("shard_mask",)


def shard_checks(dev) -> dict:
    """K24a-d against their plain versions at the LV sharded leg's shapes
    (B 65536 lanes on 8 shards of 8192, n_cap 16384 on 8 blocks of 2048,
    d 4, S 40; the chunk's 8 generations of 16384 rows for K24c) -> their
    results."""
    import torch

    from pyabc_tpu_torch.kernels import (compact_round, moment_finish,
                                         moment_fold, pack_fetch, shard_mask,
                                         shard_mask_plain)
    from pyabc_tpu_torch.kernels.compact import compact_shards_plain
    from pyabc_tpu_torch.kernels.moments import (moment_finish_shards_plain,
                                                 moment_fold_shards_plain)
    from pyabc_tpu_torch.kernels.pack_fetch import (cast_rows_plain,
                                                    pack_models_plain,
                                                    pack_rows_plain)
    from pyabc_tpu_torch.ops.scale_reduce import init_moments
    from pyabc_tpu_torch.ops.shard import merge_index

    n, B, n_cap, d, S = SH_N, 65536, SH_POP, 4, 40
    B_loc, cap_loc = B // n, n_cap // n
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    out = {}

    def lanes(seed):
        g.manual_seed(seed)
        return (torch.rand(B, generator=g, device=dev) < 0.3,
                torch.rand(B, generator=g, device=dev) < 0.99,
                torch.randn(B, d, generator=g, device=dev),
                torch.randn(B, S, generator=g, device=dev) * 30.0 + 50.0,
                torch.rand(B, generator=g, device=dev),
                torch.randn(B, generator=g, device=dev))

    def state(feat):
        res = {"theta": torch.zeros(n_cap, d, device=dev),
               "sumstats": torch.zeros(n_cap, S, device=dev),
               "distance": torch.zeros(n_cap, device=dev),
               "log_weight": torch.full((n_cap,), -math.inf, device=dev),
               "slot": torch.full((n_cap,), -1, dtype=torch.int32,
                                  device=dev)}
        if feat:
            res["dfeat"] = torch.zeros(n_cap, S, device=dev)
        buf = torch.zeros(5 + 4 * n, dtype=torch.int32, device=dev)
        buf[4] = SH_POP
        return res, buf

    x0 = torch.randn(S, generator=g, device=dev) * 30.0 + 50.0
    # K24a: rounds until every shard is finished, in both modes
    err, same = 0.0, True
    for feat in (False, True):
        (res_k, buf_k), (res_p, buf_p) = state(feat), state(feat)
        for r in range(12):
            x = lanes(100 + r)
            for res, buf, fn in ((res_k, buf_k, compact_round.shards),
                                 (res_p, buf_p, compact_shards_plain)):
                fn(*x, res, buf[:5], buf[5:].view(n, 4), n_shards=n,
                   max_rounds=10, x0=x0)
        torch.cuda.synchronize()
        same = same and bool(torch.equal(buf_k, buf_p))
        for k in res_k:
            same = same and bool(torch.equal(res_k[k], res_p[k]))
            fin = torch.isfinite(res_p[k].float())
            err = max(err, float((res_k[k].float() - res_p[k].float())
                                 [fin].abs().max()))
        log(f"K24a compact_round shard mode ({'feature' if feat else 'plain'}"
            f" rows, 12 rounds): table {buf_k[5:].view(n, 4)[:, :3].tolist()}"
            f" bit-exact={same}")
    check(same, "K24a: reservoir, table or counters not bit-identical")
    x = lanes(100)
    acc, valid = x[0] & x[1], x[1]
    written = sum(min(int(acc[s * B_loc:(s + 1) * B_loc].sum()), cap_loc)
                  for s in range(n))
    nbytes = (B + int(valid.sum()) + written * ((d + S + 2) * 4 * 2 + 4)
              + 2 * 16 * n + 2 * 20)
    res_g, buf_g = state(False)
    buf0 = buf_g.clone()
    res_f, buf_f = state(True)

    def k24a(res, buf):
        buf.copy_(buf0)
        compact_round.shards(*x, res, buf[:5], buf[5:].view(n, 4),
                             n_shards=n, max_rounds=10, x0=x0)

    res_t, buf_t = state(False)
    out["compact_round:shards"] = dict(
        err=err, call_ms=time_ms(lambda: k24a(res_g, buf_g), 50),
        # the table is reset before each replayed launch (one 0.2 kB copy
        # in the graph), so every launch compacts a first round
        ms=graph_ms(lambda: k24a(res_g, buf_g)),
        ms_feature_mode=graph_ms(lambda: k24a(res_f, buf_f)),
        plain_ms=time_ms(lambda: (buf_t.copy_(buf0), compact_shards_plain(
            *x, res_t, buf_t[:5], buf_t[5:].view(n, 4), n_shards=n,
            max_rounds=10, x0=x0)), 3),
        bound=bound(nbytes, 0.0), library_ms=None)

    # K24b on the table K24a left
    counters, table = buf_k[:5], buf_k[5:].view(n, 4)
    got = shard_mask(counters, table, n_shards=n, cap_loc=cap_loc)
    ref = shard_mask_plain(counters, table, n_shards=n, cap_loc=cap_loc)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
    log(f"K24b shard_mask: summary {got[2].tolist()} bit-exact={same}")
    check(same, "K24b: quotas, mask or totals differ from the plain version")
    out["shard_mask"] = dict(
        err=0.0,
        call_ms=time_ms(lambda: shard_mask(counters, table, n_shards=n,
                                           cap_loc=cap_loc), 50),
        ms=graph_ms(lambda: shard_mask(counters, table, n_shards=n,
                                       cap_loc=cap_loc)),
        plain_ms=time_ms(lambda: shard_mask_plain(
            counters, table, n_shards=n, cap_loc=cap_loc), 10),
        bound=bound(16 * n + 20 + n_cap + 4 * n + 24, 0.0), library_ms=None)

    # K24c: a chunk of G generations merged (a constant n; a list beside)
    G = 8
    th = [torch.randn(n_cap, d, generator=g, device=dev) for _ in range(G)]
    di = [torch.rand(n_cap, generator=g, device=dev) for _ in range(G)]
    lw = [torch.randn(n_cap, generator=g, device=dev) for _ in range(G)]
    ss = [torch.randn(n_cap, S, generator=g, device=dev) for _ in range(G)]
    ms = [torch.randint(0, 3, (n_cap,), generator=g, device=dev,
                        dtype=torch.int32) for _ in range(G)]
    same = True
    for ns in ([SH_POP] * G, [v for v in SH_AD_SIZES + SH_AD_SIZES[:2]]):
        merge, n_keep = (ns, n, cap_loc), max(ns)
        f16 = torch.float16
        same = same and bool(torch.equal(
            pack_fetch.rows(th, di, lw, n_keep=n_keep, dtype=f16,
                            merge=merge),
            pack_rows_plain(th, di, lw, n_keep=n_keep, dtype=f16,
                            merge=merge)))
        same = same and bool(torch.equal(
            pack_fetch.sumstats(ss[:2], n_keep=n_keep, dtype=f16,
                                merge=(ns[:2], n, cap_loc)),
            cast_rows_plain(ss[:2], n_keep=n_keep, dtype=f16,
                            merge=(ns[:2], n, cap_loc))))
        same = same and bool(torch.equal(
            pack_fetch.models(ms, n_keep=n_keep, merge=merge),
            pack_models_plain(ms, n_keep=n_keep, merge=merge)))
    log(f"K24c pack_fetch merge mode (G {G}, n {SH_POP} and the adaptive "
        f"leg's list, float16): bit-exact={same}")
    check(same, "K24c: the merged fetch differs from the plain gather")
    merge = ([SH_POP] * G, n, cap_loc)
    idx = torch.as_tensor(merge_index(SH_POP, n, cap_loc).astype("int64"),
                          device=dev)
    src = torch.cat([torch.stack(th), torch.stack(di)[..., None],
                     torch.stack(lw)[..., None]], -1)
    out["pack_fetch:merge"] = dict(
        err=0.0,
        call_ms=time_ms(lambda: pack_fetch.rows(
            th, di, lw, n_keep=SH_POP, dtype=torch.float16, merge=merge),
            50),
        ms=graph_ms(lambda: pack_fetch.rows(
            th, di, lw, n_keep=SH_POP, dtype=torch.float16, merge=merge)),
        plain_ms=time_ms(lambda: pack_rows_plain(
            th, di, lw, n_keep=SH_POP, dtype=torch.float16, merge=merge), 5),
        bound=bound(G * SH_POP * (d + 2) * (4 + 2), 0.0),
        # one torch.index_select of the stacked rows (float32, no cast)
        library_ms=graph_ms(lambda: torch.index_select(src, 1, idx)))

    # K24d: the fold of a first round of every shard, then the finish
    x = lanes(300)
    rec_loc = 16384  # the leg's per-shard ring window (8 x 16384 // 8)
    ctr = torch.zeros(5, dtype=torch.int32, device=dev)
    ctr[4] = SH_POP
    tab = torch.zeros(n, 4, dtype=torch.int32, device=dev)
    tab[3, 0] = SH_POP // n  # one shard finished: it folds nothing
    mom0 = init_moments(S, dev).expand(n, -1, -1).contiguous()
    runs = []
    for _ in range(2):
        mom = mom0.clone()
        moment_fold.shards(mom, x[3], x[1], x0, ctr, tab, n_shards=n,
                           rec_cap=rec_loc, max_rounds=10)
        runs.append(mom)
    ref = moment_fold_shards_plain(mom0.clone(), x[3], x[1], x0, ctr, tab,
                                   n_shards=n, rec_cap=rec_loc,
                                   max_rounds=10)
    torch.cuda.synchronize()
    got = runs[0]
    rel = float(((got[:, :3] - ref[:, :3]).abs()
                 / ref[:, :3].abs().clamp_min(1e-30)).max())
    same = (bool(torch.equal(runs[0], runs[1]))
            and bool(torch.equal(got[:, 3:], ref[:, 3:]))
            and bool(torch.equal(got[3], mom0[3])))
    log(f"K24d moment fold shard mode: counts and extrema equal, the same "
        f"bits run to run, a finished shard untouched={same}, sums rel "
        f"{rel:.2e}")
    check(same and rel <= 1e-5, "K24d fold: counts/extrema differ, the "
          "bits change run to run, or sums off by more than 1e-5")
    mom_g = mom0.clone()
    n_take = int(x[1][(torch.arange(B, device=dev) // B_loc) != 3].sum())
    out["moment_fold:shards"] = dict(
        err=float((got - ref)[torch.isfinite(ref)].abs().max()), rel=rel,
        call_ms=time_ms(lambda: moment_fold.shards(
            mom_g, x[3], x[1], x0, ctr, tab, n_shards=n, rec_cap=rec_loc,
            max_rounds=10), 50),
        # the blocks are reset before each replayed launch (one copy)
        ms=graph_ms(lambda: (mom_g.copy_(mom0), moment_fold.shards(
            mom_g, x[3], x[1], x0, ctr, tab, n_shards=n, rec_cap=rec_loc,
            max_rounds=10))),
        plain_ms=time_ms(lambda: moment_fold_shards_plain(
            mom0.clone(), x[3], x[1], x0, ctr, tab, n_shards=n,
            rec_cap=rec_loc, max_rounds=10), 5),
        bound=bound(B + n_take * S * 4 + 2 * mom0.numel() * 4 + S * 4,
                    0.0), library_ms=None)
    feat = (x[3][:n_cap] - x0).abs() ** 2
    got = moment_finish.shards(got, x0, feat, scale_name="standard_deviation")
    ref = moment_finish_shards_plain(ref, x0, feat,
                                     scale_name="standard_deviation")
    rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
              for a, b in zip(got, ref))
    log(f"K24d moment finish shard mode (standard_deviation, {n_cap} rows): "
        f"scale, weights, distances rel {rel:.2e}")
    check(rel <= 1e-5, "K24d finish: scale, weights or distances off by "
          "more than 1e-5 relative")
    out["moment_finish:shards"] = dict(
        err=max(float((a - b).abs().max()) for a, b in zip(got, ref)),
        rel=rel,
        call_ms=time_ms(lambda: moment_finish.shards(
            runs[0], x0, feat, scale_name="standard_deviation"), 50),
        ms=graph_ms(lambda: moment_finish.shards(
            runs[0], x0, feat, scale_name="standard_deviation")),
        plain_ms=time_ms(lambda: moment_finish_shards_plain(
            runs[0], x0, feat, scale_name="standard_deviation"), 10),
        bound=bound(mom0.numel() * 4 + n_cap * S * 4 + n_cap * 4 + 3 * S * 4,
                    2.0 * n_cap * S), library_ms=None)
    return out


def lv_sharded(where, sharded, pop=SH_POP, seed=SH_SEED):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.PNormDistance(p=2), population_size=pop,
                    eps=pt.MedianEpsilon(), seed=seed, sharded=sharded,
                    fused_generations=SH_G, device=where)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    return abc


def sharded_run(dev, abc, gens, label, path, slack: int = 2) -> tuple:
    """``host_loop_run`` with the kernels' mode counts (K24a, K24c and
    K24d are modes of K6, K10 and K22) -> (History, wall, counts); logs
    the throughput, the syncs a generation and holds the sync budget: a
    read a round, a fetch a chunk, the host calibration's round and
    collect (``slack`` reads of O(1); 3 with an adaptive aggregate's
    calibration refit read)."""
    from pyabc_tpu_torch.kernels import mode_launch_counts

    h, wall, counts = host_loop_run(abc, gens, label,
                                    [k for k in path if ":" not in k])
    counts = counts | mode_launch_counts()
    missing = [k for k in path if counts[k] == 0]
    check(not missing, f"{label}: {missing} never launched on its path")
    n = [int(v) for v in h.get_nr_particles_per_population()[1:]]
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    chunks = len({g["chunk_index"] for g in abc.generation_log})
    report = abc.sync_ledger.budget_report(rounds=sum(rounds), chunks=chunks,
                                           slack=slack)
    log(f"{label} ({dev}): gens={len(n)} wall_s={wall:.3f} "
        f"accepted_particles_per_s={sum(n) / wall:.1f} "
        f"syncs_per_generation={syncs['syncs'] / len(n):.2f} (rounds "
        f"{rounds}, {syncs['by_kind']}); wall split {wall_split(abc)}")
    log(f"{label}: kernel launches {counts}")
    check(report["ok"] and syncs["by_kind"].get("chunk_fetch") == chunks,
          f"{label}: a read beyond one a round and one a chunk ({report})")
    return h, wall, counts


def lv_sharded_leg(dev) -> dict:
    """The LV sharded leg and the same seed unsharded: every generation
    16384 rows, the refit at the chunk cadence only (generations 0 and
    8), the posterior means within SH_POST_RULE of the unsharded run's ->
    the sharded run's launch and mode counts."""
    import numpy as np

    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = lv_sharded(dev, SH_N)
    h, _wall, counts = sharded_run(dev, abc, SH_GENS, "LV sharded (8 shards)",
                                   SH_PATH)
    n = [int(v) for v in h.get_nr_particles_per_population()[1:]]
    flags = [e[1] for e in abc.refit_events]
    log(f"LV sharded: rows per generation {n}, refit flags {flags}, K8 "
        f"launches {counts['mvn_fit']}")
    check(n == [SH_POP] * SH_GENS, "LV sharded: a generation without 16384 "
          "rows")
    want = [t % SH_G == 0 for t in range(SH_GENS)]
    check(flags == want and counts["mvn_fit"] == sum(want),
          "LV sharded: the refit off the chunk cadence")
    h_u, _w, _c = sharded_run(dev, lv_sharded(dev, None), SH_GENS,
                              "LV unsharded (the same seed)",
                              [k for k in SH_PATH if ":" not in k
                               and k != "shard_mask"])

    def means(hh):
        df, w = hh.get_distribution(0, hh.max_t)
        return {k: float(np.sum(df[k] * w)) for k in lv.TRUE_PARS}

    m_s, m_u = means(h), means(h_u)
    gap = max(abs(m_s[k] - m_u[k]) for k in m_s)
    log(f"LV sharded: posterior means {m_s}, unsharded {m_u}, largest "
        f"gap {gap:.4f} (rule {SH_POST_RULE})")
    check(gap <= SH_POST_RULE, "LV sharded: posterior means off the "
          "unsharded run's")
    profile_run("LV sharded (8 shards, profiled)", lv_sharded(dev, SH_N),
                SH_GENS)
    return counts


def lv_adaptive_sharded(where, sizes, seed=SH_SEED):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.distance.scale import standard_deviation
    from pyabc_tpu_torch.models import lotka_volterra as lv

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(
                        p=2, scale_function=standard_deviation),
                    population_size=pt.ListPopulationSize(sizes),
                    eps=pt.MedianEpsilon(), seed=seed, sharded=SH_N,
                    fused_generations=3, device=where)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    return abc


def lv_adaptive_sharded_trail(where) -> dict:
    """The adaptive leg at pop 1024 over two generations -> its epsilons
    and weights."""
    abc = lv_adaptive_sharded(where, SH_AD_CPU_SIZES)
    h = abc.run(max_nr_populations=2)
    eps = [float(e) for e in h.get_all_populations().query(
        "t >= 0")["epsilon"]]
    w = {str(t): [float(v) for v in ws]
         for t, ws in abc.distance_function.weights.items()}
    return {"eps": eps, "w": w}


@cpu_ref
def lv_adaptive_sharded_cpu() -> dict:
    return lv_adaptive_sharded_trail("cpu")


def lv_adaptive_sharded_leg(dev) -> dict:
    """The adaptive sharded leg: the weights refit every generation, each
    generation its listed n, K24d's fold and finish on the path; card and
    CPU within 1e-3 over two generations at pop 1024 -> its counts."""
    import numpy as np

    abc = lv_adaptive_sharded(dev, SH_AD_SIZES)
    gens = len(SH_AD_SIZES)
    h, _wall, counts = sharded_run(dev, abc, gens,
                                   "LV adaptive sharded (8 shards, list)",
                                   SH_AD_PATH)
    n = [int(v) for v in h.get_nr_particles_per_population()[1:]]
    w = abc.distance_function.weights
    moved = [not np.array_equal(w[t], w[t - 1]) for t in range(1, gens + 1)]
    log(f"LV adaptive sharded: rows {n}, weights refit {moved}, w[1] "
        f"{np.round(w[1], 4).tolist()[:4]}..., w[2] "
        f"{np.round(w[2], 4).tolist()[:4]}...")
    check(n == SH_AD_SIZES and all(moved),
          "LV adaptive sharded: a generation off its listed n or weights "
          "not refit")
    card = lv_adaptive_sharded_trail(dev)

    def compare():
        cpu = REFS.get("lv_adaptive_sharded_cpu")
        e_rel = max(abs(a - b) / abs(b) for a, b in zip(card["eps"],
                                                         cpu["eps"]))
        w_rel = max(float(np.max(np.abs(np.subtract(card["w"][t],
                                                    cpu["w"][t]))
                                 / np.abs(cpu["w"][t])))
                    for t in cpu["w"])
        log(f"LV adaptive sharded, pop 1024: card eps {card['eps']}, cpu "
            f"{cpu['eps']}; largest relative gaps eps {e_rel:.2e}, weights "
            f"{w_rel:.2e}")
        check(len(card["eps"]) == len(cpu["eps"]) == 2
              and e_rel <= 1e-3 and w_rel <= 1e-3,
              "LV adaptive sharded: card and CPU apart by more than 1e-3")

    PENDING.append(compare)
    return counts


def toy_sharded(dev) -> None:
    """The Gaussian toy at pop 300 (uneven quotas 38 and 37) on 8 shards:
    300 rows every generation, the posterior mean within 0.25 of the
    conjugate answer."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    mu_true = gaussian.conjugate_posterior(1.0, noise_sd=0.5)[0]
    abc = pt.ABCSMC(gaussian.make_mean_only_model(noise_sd=0.5),
                    gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                    population_size=SH_TOY_POP, eps=pt.MedianEpsilon(),
                    seed=31, sharded=SH_N, fused_generations=3, device=dev)
    abc.new("sqlite://", {"x": 1.0})
    h, _wall, _c = sharded_run(
        dev, abc, SH_TOY_GENS, "gaussian toy sharded (pop 300)",
        ("propose", "mean_only_simulate", "compact_round:shards",
         "shard_mask", "pack_fetch:merge"))
    n = [int(v) for v in h.get_nr_particles_per_population()[1:]]
    df, w = h.get_distribution(0, h.max_t)
    mu = float(np.sum(df["theta"] * w))
    log(f"gaussian toy sharded: rows {n}, posterior mean {mu:.4f} "
        f"(conjugate {mu_true:.4f})")
    check(n == [SH_TOY_POP] * SH_TOY_GENS and abs(mu - mu_true) <= 0.25,
          "gaussian toy sharded: rows off 300 or the mean off by > 0.25")


# ----------------------- sharded aggregated distances (K25's sharded twins)
#: the LV aggregated sharded legs: the LV aggregated legs (lv_aggregate:
#: make_lv_model, lv_subs, MedianEpsilon, pop 16384, seed 0, AGG_GENS
#: generations) on 8 virtual shards in chunks of 3; the adaptive one beside
#: the same seed unsharded at the same G
AGG_SH_G = 3
#: the adaptive sharded leg on the card and on the CPU
AGG_SH_CPU_POP, AGG_SH_CPU_GENS = 1024, 2
#: the unsharded seeds beside the adaptive sharded leg. The span weights
#: of LV's sub-distances jump by orders of magnitude from generation to
#: generation (ROADMAP queue C) and follow the records, so they follow the
#: proposal: at the chunk cadence (the MVN refit at generations 0, 3 and
#: 6 only) a sharded run's weights, and so its target, can drift from the
#: unsharded run's, which refits every generation. The leg reports the
#: cadence run's gap to the same seed and to these seeds' envelope, and
#: holds tests/test_sharded.py's rule (posterior means within 0.2 of the
#: same seed unsharded) on the same sharded run with the MVN refit every
#: generation (refit_every=1: the unsharded run's law, the shard quotas
#: the only difference). A seed whose run stops early is reported and left
#: out of the envelope (a record with a non-finite sub-distance makes the
#: span, and so W, 0 in both packages; the epsilon then reaches 0)
AGG_SH_SEEDS = (0, 1, 2, 3)
#: the kernels of the LV aggregated sharded legs (the host calibration's
#: compaction is K6's unsharded round; the adaptive leg's calibration refit
#: is K25's refit)
AGG_SH_PATH = ("propose", "mvn_mixture_logpdf", "lv_simulate",
               "aggregate_accept_weight", "compact_round",
               "compact_round:shards", "shard_mask", "normalize_quantile",
               "mvn_fit", "pack_fetch", "pack_fetch:merge",
               "generation_health")
AGG_SH_AD_PATH = AGG_SH_PATH + (
    "aggregate_refit", "aggregate_accept_weight:value_rows",
    "moment_fold:shards", "compact_round:given_rows",
    "aggregate_finish:shards")
AGG_SH_KERNELS = ("aggregate_finish",)
#: the finish's check: the LV leg's 8 shards and 16384 rows, 4
#: sub-distances of mixed p
AGG_SH_PS = (1.0, 2.0, math.inf, 3.0)


def agg_shard_checks(dev) -> dict:
    """K25's sharded twins at the LV aggregated sharded leg's shapes (B
    65536 lanes on 8 shards, S 40, n_cap 16384 on 8 blocks of 2048): the
    accept's value rows bit-equal to its values mode with the accept
    unchanged (the legs' pair and 4 sub-distances of mixed p), K24a's
    given-rows mode bit-exact against its plain version, K24d's fold on
    the value columns (counts and extrema equal, sums rel 1e-5), K25's
    sharded finish (W and distances rel 1e-5 of the plain version, the
    same bits run to run) -> their results."""
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (aggregate_accept_weight,
                                         aggregate_finish, compact_round,
                                         moment_fold)
    from pyabc_tpu_torch.kernels.aggregate import (
        aggregate_accept_weight_plain, aggregate_finish_shards_plain,
        sub_distances_plain)
    from pyabc_tpu_torch.kernels.compact import compact_shards_plain
    from pyabc_tpu_torch.kernels.moments import moment_fold_shards_plain
    from pyabc_tpu_torch.ops.scale_reduce import init_moments
    from pyabc_tpu_torch.utils import pick_batch

    n, n_cap = SH_N, AGG_POP
    B = pick_batch(AGG_POP)
    B_loc, cap_loc = B // n, n_cap // n
    ss, spec, x0 = lv_rows(dev, B, seed=19)
    S = spec.total_size
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    valid = torch.rand(B, generator=g, device=dev) > 0.05
    logpri = torch.randn(B, generator=g, device=dev) - 3.0
    logq = torch.randn(B, generator=g, device=dev) - 2.0
    out = {}
    cases = {"LV legs' pair (p 2, 1)": None, "4 sub-distances": AGG_SH_PS}
    for label, ps in cases.items():
        if ps is None:
            dist = pt.AdaptiveAggregatedDistance(lv_subs(pt))
        else:
            dist = pt.AdaptiveAggregatedDistance([pt.PNormDistance(
                p=p, weights=torch.rand(S, generator=g, device=dev).cpu()
                .numpy() + 0.2) for p in ps])
        dist.initialize(spec)
        params = dist.device_params(0, dev)
        n_sub = len(dist.ps)
        d_all = sub_distances_plain(ss, x0, params, dist.ps).sum(1)
        eps = torch.quantile(d_all[torch.isfinite(d_all)], 0.5)
        args = (ss, x0, params, eps, valid)
        kw = dict(ps=dist.ps, logpri=logpri, logq=logq)
        d_v, a_v, lw_v, vals = aggregate_accept_weight.value_rows(*args,
                                                                  **kw)
        d_k, a_k, lw_k = aggregate_accept_weight(*args, **kw)
        v_k = aggregate_accept_weight.values(ss, x0, params, ps=dist.ps)
        v_p = sub_distances_plain(ss, x0, params, dist.ps)
        torch.cuda.synchronize()
        same = (torch.equal(vals, v_k) and torch.equal(d_v, d_k)
                and torch.equal(a_v, a_k) and torch.equal(lw_v, lw_k))
        err = abs_err(vals, v_p)
        log(f"K25 value-rows mode {label} (B={B}, S={S}): values bit-equal "
            f"to the values mode and the accept unchanged {same}, "
            f"max_abs_err against the plain values {err:.3e}")
        check(same and within(vals, v_p, 0.0, 1e-5),
              f"K25 value rows ({label}): not the values mode's bits, the "
              f"accept changed, or off the plain values by more than 1e-5")
        if ps is not None:
            continue
        nbytes = ((B * S + S + n_sub * (S + 1)) * 4 + B * (1 + 4 + 4) + 4
                  + B * (4 + 1 + 4) + B * n_sub * 4)
        out["aggregate_accept_weight:value_rows"] = dict(
            err=err, call_ms=time_ms(lambda: aggregate_accept_weight
                                     .value_rows(*args, **kw), 50),
            ms=graph_ms(lambda: aggregate_accept_weight.value_rows(*args,
                                                                   **kw)),
            ms_accept_alone=graph_ms(lambda: aggregate_accept_weight(*args,
                                                                     **kw)),
            plain_ms=time_ms(lambda: (aggregate_accept_weight_plain(
                *args, **kw), sub_distances_plain(ss, x0, params,
                                                  dist.ps)), 10),
            bound=bound(nbytes, B * S * n_sub * 4), library_ms=None)
        lv_vals, lv_dist, lv_params = vals, dist, params

    # K24a's given-rows mode: rounds until every shard is finished
    n_sub = len(lv_dist.ps)

    def lanes(seed):
        g.manual_seed(seed)
        theta = torch.randn(B, 4, generator=g, device=dev)
        sums = lv_rows(dev, B, seed=seed)[0]
        f = sub_distances_plain(sums, x0, lv_params, lv_dist.ps)
        return (torch.rand(B, generator=g, device=dev) < 0.3,
                torch.rand(B, generator=g, device=dev) < 0.99, theta, sums,
                torch.rand(B, generator=g, device=dev),
                torch.randn(B, generator=g, device=dev)), f

    def state():
        res = {"theta": torch.zeros(n_cap, 4, device=dev),
               "sumstats": torch.zeros(n_cap, S, device=dev),
               "distance": torch.zeros(n_cap, device=dev),
               "log_weight": torch.full((n_cap,), -math.inf, device=dev),
               "slot": torch.full((n_cap,), -1, dtype=torch.int32,
                                  device=dev),
               "dfeat": torch.zeros(n_cap, n_sub, device=dev)}
        buf = torch.zeros(5 + 4 * n, dtype=torch.int32, device=dev)
        buf[4] = AGG_POP
        return res, buf

    (res_k, buf_k), (res_p, buf_p) = state(), state()
    for r in range(12):
        x, f = lanes(200 + r)
        for res, buf, fn in ((res_k, buf_k, compact_round.shards),
                             (res_p, buf_p, compact_shards_plain)):
            fn(*x, res, buf[:5], buf[5:].view(n, 4), n_shards=n,
               max_rounds=10, feat_rows=f)
    torch.cuda.synchronize()
    same = torch.equal(buf_k, buf_p) and all(
        torch.equal(res_k[k], res_p[k]) for k in res_k)
    log(f"K24a given-rows mode (F {n_sub}, 12 rounds): table "
        f"{buf_k[5:].view(n, 4)[:, :3].tolist()} bit-exact={same}")
    check(same, "K24a given rows: reservoir, feature rows, table or "
          "counters not bit-identical to the plain version")
    x, f = lanes(200)
    acc = x[0] & x[1]
    written = sum(min(int(acc[s * B_loc:(s + 1) * B_loc].sum()), cap_loc)
                  for s in range(n))
    nbytes = (B + int(x[1].sum()) + written * ((4 + S + 2 + n_sub) * 4 * 2
                                               + 4)
              + 2 * 16 * n + 2 * 20)
    res_g, buf_g = state()
    buf0 = buf_g.clone()

    def k24a(res, buf):
        buf.copy_(buf0)
        compact_round.shards(*x, res, buf[:5], buf[5:].view(n, 4),
                             n_shards=n, max_rounds=10, feat_rows=f)

    res_t, buf_t = state()
    out["compact_round:given_rows"] = dict(
        err=0.0, call_ms=time_ms(lambda: k24a(res_g, buf_g), 50),
        ms=graph_ms(lambda: k24a(res_g, buf_g)),
        plain_ms=time_ms(lambda: (buf_t.copy_(buf0), compact_shards_plain(
            *x, res_t, buf_t[:5], buf_t[5:].view(n, 4), n_shards=n,
            max_rounds=10, feat_rows=f)), 3),
        bound=bound(nbytes, 0.0), library_ms=None)

    # K24d's fold on the value columns of a first round of every shard
    zeros = torch.zeros(n_sub, device=dev)
    rec_loc = 16384  # the leg's per-shard ring window (8 x 16384 // 8)
    ctr = torch.zeros(5, dtype=torch.int32, device=dev)
    ctr[4] = AGG_POP
    tab = torch.zeros(n, 4, dtype=torch.int32, device=dev)
    tab[5, 0] = AGG_POP // n  # one shard finished: it folds nothing
    mom0 = init_moments(n_sub, dev).expand(n, -1, -1).contiguous()
    runs = []
    for _ in range(2):
        mom = mom0.clone()
        moment_fold.shards(mom, lv_vals, valid, zeros, ctr, tab, n_shards=n,
                           rec_cap=rec_loc, max_rounds=10)
        runs.append(mom)
    ref = moment_fold_shards_plain(mom0.clone(), lv_vals, valid, zeros, ctr,
                                   tab, n_shards=n, rec_cap=rec_loc,
                                   max_rounds=10)
    torch.cuda.synchronize()
    got = runs[0]
    rel = float(((got[:, :3] - ref[:, :3]).abs()
                 / ref[:, :3].abs().clamp_min(1e-30)).max())
    same = (torch.equal(runs[0], runs[1])
            and torch.equal(got[:, 3:], ref[:, 3:])
            and torch.equal(got[5], mom0[5]))
    log(f"K24d fold on the value columns (F {n_sub}): counts and extrema "
        f"equal, the same bits run to run, a finished shard untouched="
        f"{same}, sums rel {rel:.2e}")
    check(same and rel <= 1e-5, "K24d fold on the value columns: counts or "
          "extrema differ, the bits change run to run, or sums off by more "
          "than 1e-5")
    mom_g = mom0.clone()
    n_take = int(valid[(torch.arange(B, device=dev) // B_loc) != 5].sum())
    out["moment_fold:value_columns"] = dict(
        err=float((got - ref)[torch.isfinite(ref)].abs().max()), rel=rel,
        call_ms=time_ms(lambda: moment_fold.shards(
            mom_g, lv_vals, valid, zeros, ctr, tab, n_shards=n,
            rec_cap=rec_loc, max_rounds=10), 50),
        ms=graph_ms(lambda: (mom_g.copy_(mom0), moment_fold.shards(
            mom_g, lv_vals, valid, zeros, ctr, tab, n_shards=n,
            rec_cap=rec_loc, max_rounds=10))),
        plain_ms=time_ms(lambda: moment_fold_shards_plain(
            mom0.clone(), lv_vals, valid, zeros, ctr, tab, n_shards=n,
            rec_cap=rec_loc, max_rounds=10), 5),
        bound=bound(B + n_take * n_sub * 4 + 2 * mom0.numel() * 4
                    + n_sub * 4, 0.0), library_ms=None)

    # K25's sharded finish: 8 blocks of 4 mixed-p value columns, 16384 rows
    dist = pt.AdaptiveAggregatedDistance([pt.PNormDistance(p=p)
                                          for p in AGG_SH_PS])
    dist.initialize(spec)
    params = dist.device_params(0, dev)
    n_sub = len(AGG_SH_PS)
    vals = sub_distances_plain(lv_rows(dev, B, seed=23)[0], x0, params,
                               dist.ps)
    mom = init_moments(n_sub, dev).expand(n, -1, -1).contiguous()
    moment_fold_shards_plain(mom, vals, valid, torch.zeros(n_sub, device=dev),
                             ctr, torch.zeros(n, 4, dtype=torch.int32,
                                              device=dev),
                             n_shards=n, rec_cap=rec_loc, max_rounds=10)
    feat = vals[:n_cap].contiguous()
    fac = (1.0, 0.5, 2.0, 1.0)
    for name in ("span", "standard_deviation", "mean"):
        kw = dict(factors=fac, scale_name=name)
        a = aggregate_finish.shards(mom, feat, params, **kw)
        b = aggregate_finish.shards(mom, feat, params, **kw)
        p_ = aggregate_finish_shards_plain(mom, feat, params, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        rel = max(float(((u - v).abs() / v.abs().clamp_min(1e-30)).max())
                  for u, v in zip(a, p_))
        log(f"K25 sharded finish ({name}, {n} shards, {n_cap} rows, "
            f"p {AGG_SH_PS}): scale {a[0].tolist()} W {a[1][:n_sub].tolist()}"
            f" rel {rel:.2e} against the plain version, the same bits run to "
            f"run {same}, sub weights copied "
            f"{torch.equal(a[1][n_sub:], params[n_sub:])}")
        check(same and rel <= 1e-5
              and torch.equal(a[1][n_sub:], params[n_sub:]),
              f"K25 sharded finish ({name}): W or distances off the plain "
              f"version by more than 1e-5, bits that change run to run, or "
              f"sub weights not copied")
        if name != "span":
            continue
        kw_span = kw
        err = max(float((u - v).abs().max()) for u, v in zip(a, p_))
        out["aggregate_finish"] = dict(
            err=err, rel=rel,
            call_ms=time_ms(lambda: aggregate_finish.shards(
                mom, feat, params, **kw_span), 50),
            ms=graph_ms(lambda: aggregate_finish.shards(mom, feat, params,
                                                        **kw_span)),
            plain_ms=time_ms(lambda: aggregate_finish_shards_plain(
                mom, feat, params, **kw_span), 10),
            # the value rows read and the distances written; the blocks
            # and the params are a few kB beside them
            bound=bound(n_cap * n_sub * 4 + n_cap * 4
                        + mom.numel() * 4 + 2 * params.numel() * 4,
                        2.0 * n_cap * n_sub), library_ms=None)
    return out


def lv_aggregate_sharded_leg(dev, kind: str) -> dict:
    """An LV aggregated leg on 8 shards (``sharded_run``: counts set to 0
    just before and read just after, the plain versions set to raise, the
    sync budget held: a read a round, a fetch a chunk, the calibration's
    round, collect and, adaptive, the one read of its K25 refit's W) ->
    its launch and mode counts. Adaptive: the top-level weight trail, a
    refit every generation, the posterior means beside the same seed
    unsharded at the same G and AGG_SH_SEEDS' envelope, and within
    SH_POST_RULE of the same seed with the MVN refit every generation.
    Schedule: the stored distances recomputed under each generation's
    weights."""
    import numpy as np

    from pyabc_tpu_torch.models import lotka_volterra as lv

    label = f"LV aggregated {kind} sharded (8 shards, G {AGG_SH_G})"
    abc = lv_aggregate(dev, kind, sharded=SH_N, G=AGG_SH_G)
    path = AGG_SH_AD_PATH if kind == "adaptive" else AGG_SH_PATH
    h, _wall, counts = sharded_run(dev, abc, AGG_GENS, label, path,
                                   slack=3 if kind == "adaptive" else 2)
    n = [int(v) for v in h.get_nr_particles_per_population()[1:]]
    check(n == [AGG_POP] * AGG_GENS, f"{label}: a generation off {AGG_POP} "
          f"rows")
    check(all(g["syncs"] == g["rounds"] for g in abc.generation_log),
          f"{label}: a generation read the device besides its round "
          f"counters")
    if kind == "schedule":
        schedule_recompute_check(abc, h, label)
        check(counts["aggregate_refit"] == 0
              and counts["aggregate_finish"] == 0
              and counts["moment_fold"] == 0,
              f"{label}: an adaptive kernel ran under a fixed schedule")
        return counts
    w = abc.distance_function.weights
    trail = {t: [round(float(v), 8) for v in w[t]] for t in sorted(w)
             if t >= 0}
    moved = [not np.array_equal(w[t], w[t - 1])
             for t in range(1, AGG_GENS + 1)]
    log(f"{label}: top-level weights by generation {trail}, refit every "
        f"generation {all(moved)} ({counts['aggregate_finish:shards']} "
        f"sharded finishes)")
    check(sorted(trail) == list(range(AGG_GENS + 1)) and all(moved)
          and counts["aggregate_finish:shards"] == AGG_GENS
          and counts["aggregate_refit"] == 1,
          f"{label}: the weights were not refit at the calibration (K25's "
          f"refit) and after every generation (its sharded finish)")

    def means(hh):
        df, ww = hh.get_distribution(0, hh.max_t)
        return {k: float(np.sum(df[k] * ww)) for k in lv.TRUE_PARS}

    def reference_run(seed, refit_every=None, sharded=None):
        abc_u = lv_aggregate(dev, kind, G=AGG_SH_G, seed=seed,
                             sharded=sharded, refit_every=refit_every)
        with plain_versions_raise():
            t0 = time.perf_counter()
            h_u = abc_u.run(max_nr_populations=AGG_GENS)
            wall = time.perf_counter() - t0
        w_u = abc_u.distance_function.weights
        eps_u = [float(e) for e in h_u.get_all_populations()["epsilon"][1:]]
        log(f"LV aggregated {kind} (seed {seed}, sharded {sharded}, "
            f"refit_every {refit_every}, G {AGG_SH_G}): {h_u.n_populations} "
            f"generations, wall_s={wall:.3f}, eps {eps_u}, last weights "
            f"{w_u[max(w_u)].tolist()}")
        return means(h_u) if h_u.n_populations == AGG_GENS else None

    m_u = {seed: reference_run(seed) for seed in AGG_SH_SEEDS}
    m_u = {seed: m for seed, m in m_u.items() if m is not None}
    m_s = means(h)
    m_1 = reference_run(0, refit_every=1, sharded=SH_N)
    check(0 in m_u and m_1 is not None, f"{label}: seed 0 stopped early "
          f"unsharded or sharded with refit_every=1")
    ms = list(m_u.values())

    def gap(m, ref):
        return max(abs(m[k] - ref[k]) for k in m)

    def outside(m):
        return max(max(min(r[k] for r in ms) - m[k],
                       m[k] - max(r[k] for r in ms), 0.0) for k in m)

    log(f"{label}: posterior means {m_s}; with refit_every=1 {m_1}; "
        f"unsharded, by seed: {m_u}; largest gap to the same seed "
        f"{gap(m_s, m_u[0]):.4f} at the chunk cadence, "
        f"{gap(m_1, m_u[0]):.4f} with refit_every=1 "
        f"(tests/test_sharded.py's rule {SH_POST_RULE}, held on the "
        f"latter); largest distance outside the unsharded seeds' envelope "
        f"{outside(m_s):.4f} and {outside(m_1):.4f}")
    check(gap(m_1, m_u[0]) <= SH_POST_RULE, f"{label}: with the MVN refit "
          f"every generation, posterior means off the unsharded run's")
    return counts


def lv_aggregate_sharded_trail(where, raising: bool = False) -> dict:
    """The adaptive sharded leg at pop 1024 over two generations (the run,
    not the observation's simulation, under ``plain_versions_raise`` when
    ``raising``) -> its epsilons and weights."""
    abc = lv_aggregate(where, "adaptive", pop=AGG_SH_CPU_POP, sharded=SH_N,
                       G=AGG_SH_G)
    with plain_versions_raise() if raising else contextlib.nullcontext():
        h = abc.run(max_nr_populations=AGG_SH_CPU_GENS)
    eps = [float(e) for e in h.get_all_populations().query(
        "t >= 0")["epsilon"]]
    w = {str(t): [float(v) for v in ws]
         for t, ws in abc.distance_function.weights.items() if t >= 0}
    return {"eps": eps, "w": w}


@cpu_ref
def lv_aggregate_sharded_cpu() -> dict:
    return lv_aggregate_sharded_trail("cpu")


def lv_aggregate_sharded_card_cpu(dev) -> None:
    """The adaptive sharded leg at pop 1024, two generations, on the card
    (the plain versions set to raise) and on the CPU: weights and epsilons
    within 1e-3 relative."""
    import numpy as np

    card = lv_aggregate_sharded_trail(dev, raising=True)

    def compare():
        cpu = REFS.get("lv_aggregate_sharded_cpu")
        e_rel = max(abs(a - b) / abs(b) for a, b in zip(card["eps"],
                                                         cpu["eps"]))
        w_rel = max(float(np.max(np.abs(np.subtract(card["w"][t],
                                                    cpu["w"][t]))
                                 / np.abs(cpu["w"][t])))
                    for t in cpu["w"])
        log(f"LV aggregated adaptive sharded, pop {AGG_SH_CPU_POP}: card "
            f"eps {card['eps']} weights {card['w']}; cpu eps {cpu['eps']} "
            f"weights {cpu['w']}; largest relative gaps eps {e_rel:.2e}, "
            f"weights {w_rel:.2e}")
        check(len(card["eps"]) == len(cpu["eps"]) == AGG_SH_CPU_GENS
              and sorted(card["w"]) == sorted(cpu["w"])
              and e_rel <= 1e-3 and w_rel <= 1e-3,
              "LV aggregated adaptive sharded: card and CPU apart by more "
              "than 1e-3")

    PENDING.append(compare)


# ------------------------------------------------ the device mesh (K24e)
#: the mesh legs on the one card, each rank a process over Gloo (a file://
#: rendezvous): the LV mesh leg (the LV sharded leg's model, prior,
#: distance and observation at pop 16384, 8 generations, 8 shards, G 3,
#: seed 0) at widths 2 and 4, the LV adaptive sharded leg (its list) at
#: width 4, and at width 2 config 1's Gaussian (K4's Gaussian kernel's lane
#: base), the conjugate toy (K4's mean-only kernel: ``toy_run`` on 8
#: shards), config 5 (K20b's family) and, at MESH_SMALL, SIR under a p-norm
#: with measurement noise in the simulator (K20) and config 3's birth-death
#: unsegmented (K19); each primary's History bit for bit the virtual
#: shards' run of the same configuration on this card
MESH_POP, MESH_GENS, MESH_G, MESH_SEED = 16384, 8, 3, 0
#: config 5, SIR, birth-death and the segmented zoo models (early reject
#: off) on the mesh: pop and generations
MESH_SMALL_POP, MESH_SMALL_GENS = 1024, 4
MESH_GROUPS = {2: ("lv", "gauss", "toy", "config5", "sir", "birth_death",
                   "network_sir", "family_segments"),
               4: ("lv", "lv_adaptive")}
#: seconds a group of ranks may take, its start included
MESH_JOIN_S = 300.0
#: the kernels of the LV mesh leg's path beyond the sharded leg's, and the
#: lane-base modes (the K2 and K4 launches of the ranks past the first)
MESH_KERNELS = ("mesh_pack", "mesh_unpack")
MESH_PATH = SH_PATH + MESH_KERNELS
#: each leg's simulator path beyond K2 (the LV legs' are SH_PATH's)
MESH_LEG_PATH = {"gauss": ("gaussian_simulate",),
                 "toy": ("mean_only_simulate",),
                 "config5": ("ode_family_simulate", "model_step"),
                 "sir": ("sir_simulate",), "birth_death": ("tau_leap",),
                 "network_sir": ("network_sir",),
                 "family_segments": ("ode_family_segments", "model_step")}
#: the lane-base modes: (mode, source, the TPU code it replaces, the width-2
#: mesh leg whose ranks past the first launch it)
LANE_BASE_ROWS = (
    ("propose:lane_base", "pyabc_tpu_torch/csrc/propose.cu",
     "pyabc_tpu/inference/util.py:335", "lv"),
    ("lv_simulate:lane_base", "pyabc_tpu_torch/csrc/lv_rk4.cu",
     "pyabc_tpu/models/ode.py:104", "lv"),
    ("gaussian_simulate:lane_base", "pyabc_tpu_torch/csrc/gaussian.cu",
     "pyabc_tpu/models/gaussian.py:20", "gauss"),
    ("mean_only_simulate:lane_base", "pyabc_tpu_torch/csrc/gaussian.cu",
     "pyabc_tpu/models/gaussian.py:38", "toy"),
    ("ode_family_simulate:lane_base", "pyabc_tpu_torch/csrc/ode_family_rk4.cu",
     "pyabc_tpu/models/model_selection.py:53", "config5"),
    ("sir_simulate:lane_base", "pyabc_tpu_torch/csrc/sir_rk4.cu",
     "pyabc_tpu/models/sir.py:30", "sir"),
    ("tau_leap:lane_base", "pyabc_tpu_torch/csrc/tau_leap.cu",
     "pyabc_tpu/models/gillespie.py:35", "birth_death"),
    ("ode_family_segments:lane_base", "pyabc_tpu_torch/csrc/ode_family_rk4.cu",
     "pyabc_tpu/models/model_selection.py:83", "family_segments"),
    ("network_sir:lane_base", "pyabc_tpu_torch/csrc/network_sir_rk4.cu",
     "pyabc_tpu/models/sir.py:79", "network_sir"))


def history_arrays(h, K: int = 1) -> dict:
    """A History's epsilon trail and every generation's thetas, weights
    and distances (``tests/test_sharded.py::_history_arrays``, each
    model's)."""
    import numpy as np

    pops = h.get_all_populations().query("t >= 0")
    out = {"eps": pops["epsilon"].to_numpy()}
    for t in pops["t"]:
        t = int(t)
        for m in range(K):
            df, w = h.get_distribution(m, t)
            out[f"theta_{m}_{t}"] = df.to_numpy()
            out[f"w_{m}_{t}"] = np.asarray(w)
        out[f"d_{t}"] = h.get_weighted_distances(t)["distance"].to_numpy()
    return out


def mesh_leg_abc(leg: str, where, mesh=None):
    """The mesh legs' configurations (``mesh=None``: the virtual shards)
    -> (ABCSMC, generations)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.distance.scale import standard_deviation
    from pyabc_tpu_torch.models import gaussian
    from pyabc_tpu_torch.models import gillespie as gl
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.models import model_selection as msel
    from pyabc_tpu_torch.models import sir

    small = dict(population_size=MESH_SMALL_POP, eps=pt.MedianEpsilon(),
                 seed=MESH_SEED, mesh=mesh, sharded=SH_N,
                 fused_generations=MESH_G, device=where)
    if leg == "toy":
        abc = pt.ABCSMC(gaussian.make_mean_only_model(noise_sd=TOY_NOISE_SD),
                        gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                        population_size=POP, eps=pt.MedianEpsilon(),
                        seed=TOY_SEEDS[0], mesh=mesh, sharded=SH_N,
                        fused_generations=MESH_G, device=where)
        abc.new("sqlite://", {"x": 1.0})
        return abc, 6
    if leg == "config5":
        models, priors, _ts = msel.ode_family()
        abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2), **small)
        abc.new("sqlite://", msel.observed_ode_family(seed=0, true_model=1),
                store_sum_stats=False)
        return abc, MESH_SMALL_GENS
    if leg == "sir":
        abc = pt.ABCSMC(sir.make_sir_model(noise_sd=10.0), sir.default_prior(),
                        pt.PNormDistance(p=2), **small)
        abc.new("sqlite://", sir.observed_data(seed=0), store_sum_stats=False)
        return abc, MESH_SMALL_GENS
    if leg == "birth_death":
        abc = pt.ABCSMC(gl.make_birth_death_model(), gl.birth_death_prior(),
                        pt.PNormDistance(p=2), **small)
        abc.new("sqlite://", gl.observed_birth_death(seed=0),
                store_sum_stats=False)
        return abc, MESH_SMALL_GENS
    if leg == "network_sir":
        # the zoo's network SIR with simulator noise (sd 8), early reject
        # off: K20b network's range over every segment
        abc = pt.ABCSMC(sir.make_network_sir_model(noise_sd=8.0),
                        sir.network_sir_prior(), pt.PNormDistance(p=2),
                        early_reject=False, **small)
        abc.new("sqlite://", sir.observed_network_sir(seed=0),
                store_sum_stats=False)
        return abc, MESH_SMALL_GENS
    if leg == "family_segments":
        # the zoo's model-selection family (4 segments), early reject off:
        # K20b's range entry over every segment
        models, priors, _ts = msel.ode_family(segments=ZMS_SEGS)
        abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                        early_reject=False, **small)
        abc.new("sqlite://", msel.observed_ode_family(seed=0,
                                                      segments=ZMS_SEGS),
                store_sum_stats=False)
        return abc, MESH_SMALL_GENS
    if leg == "gauss":
        abc = pt.ABCSMC(gaussian.make_gaussian_model(),
                        gaussian.default_prior(), pt.PNormDistance(p=2),
                        population_size=X1_POP, eps=pt.MedianEpsilon(),
                        seed=X1_SEED, mesh=mesh, sharded=SH_N,
                        fused_generations=MESH_G, device=where)
        abc.new("sqlite://", X1_OBS, store_sum_stats=False)
        return abc, MESH_GENS
    adaptive = leg == "lv_adaptive"
    abc = pt.ABCSMC(
        lv.make_lv_model(), lv.default_prior(),
        pt.AdaptivePNormDistance(p=2, scale_function=standard_deviation)
        if adaptive else pt.PNormDistance(p=2),
        population_size=(pt.ListPopulationSize(SH_AD_SIZES) if adaptive
                         else MESH_POP),
        eps=pt.MedianEpsilon(), seed=SH_SEED if adaptive else MESH_SEED,
        mesh=mesh, sharded=SH_N, fused_generations=MESH_G, device=where)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    return abc, len(SH_AD_SIZES) if adaptive else MESH_GENS


def mesh_run(abc, gens: int) -> tuple:
    """One run with the counts set to 0 just before it and read just
    after, the plain versions set to raise -> (History, wall, counts)."""
    import torch

    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    card = abc.device.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    reset_launch_counts()
    with plain_versions_raise() if card else contextlib.nullcontext():
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=gens)
        sync()
        wall = time.perf_counter() - t0
    return h, wall, launch_counts() | mode_launch_counts()


def mesh_rank_main(rank: int, width: int, rdv: str, out: str, where: str,
                   legs: list[str]) -> int:
    """A rank of a mesh leg (``--mesh-rank``): joins the group, runs its
    legs on the parent's device (the card: every plain version set to
    raise) and leaves each leg's History arrays, counts, mesh block,
    ledger and wall in ``out/rank<rank>.pkl``."""
    import pickle

    import torch

    from pyabc_tpu_torch.parallel import distributed as pdist

    dev = torch.device(where)
    pdist.initialize(f"file://{rdv}", num_processes=width, process_id=rank,
                     timeout=MESH_JOIN_S)
    try:
        mesh = pdist.global_mesh(dev.type)
        results = {}
        for leg in legs:
            abc, gens = mesh_leg_abc(leg, dev, mesh)
            h, wall, counts = mesh_run(abc, gens)
            results[leg] = {"arrays": history_arrays(h, abc.K),
                            "counts": counts, "mesh": abc.mesh_snapshot(),
                            "ledger": abc.sync_ledger.summary(),
                            "wall": wall, "gens": len(abc.generation_log)}
        with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def mesh_spawn(dev, width: int, legs, tmp: str) -> tuple[list, Path]:
    """Start the ranks of one width (a fresh file:// rendezvous) -> (their
    processes, their output directory)."""
    out = Path(tmp) / f"w{width}"
    out.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), str(width), str(out / "rendezvous"), str(out), str(dev),
         *legs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(width)]
    return procs, out


def mesh_join(width: int, procs: list, out: Path,
              deadline: float) -> list[dict]:
    """Join the ranks of one width by ``deadline`` (the host's clock): a
    late or failed rank fails the script (the caller kills what is left)
    -> each rank's results."""
    import pickle

    logs = [""] * width
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(deadline - time.perf_counter(), 0.1))[0]
    except subprocess.TimeoutExpired:
        check(False, f"mesh width {width}: a rank is late after "
              f"{MESH_JOIN_S} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            log(f"mesh width {width} rank {r} output:\n{logs[r][-4000:]}")
        check(p.returncode == 0, f"mesh width {width}: rank {r} exited "
              f"{p.returncode}")
    res = []
    for r in range(width):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def mesh_legs(dev) -> dict:
    """The mesh legs: every width's group of ranks started at once, the
    virtual-shard references run on the card while they start, then each
    group joined; every primary's History (epsilons, thetas, weights,
    distances of every generation) bit for bit the reference's, every
    rank's the primary's, K24e and the lane-base modes launched ->
    {(leg, width): the ranks' summed counts}. The groups share the card
    and the host, so their walls and Gloo times are readings of a shared
    machine."""
    import numpy as np

    def same(a, b) -> bool:
        return set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                        for k in a)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        groups = {w: mesh_spawn(dev, w, legs, tmp)
                  for w, legs in MESH_GROUPS.items()}
        try:
            refs = {}
            for leg in sorted({lg for legs in MESH_GROUPS.values()
                               for lg in legs}):
                abc, gens = mesh_leg_abc(leg, dev)
                h, wall, _c = mesh_run(abc, gens)
                refs[leg] = history_arrays(h, abc.K)
                log(f"mesh reference {leg} (8 virtual shards): {gens} "
                    f"generations, wall_s={wall:.3f}")
            deadline = t0 + MESH_JOIN_S
            results = {w: mesh_join(w, procs, path, deadline)
                       for w, (procs, path) in groups.items()}
        finally:
            for procs, _path in groups.values():
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
        log(f"mesh groups {list(MESH_GROUPS)} ran side by side in "
            f"{time.perf_counter() - t0:.1f} s (start included)")
        for width, legs in MESH_GROUPS.items():
            res = results[width]
            for leg in legs:
                prim = res[0][leg]
                for r, rr in enumerate(res):
                    x = rr[leg]
                    m, led = x["mesh"], x["ledger"]
                    gens = x["gens"]
                    log(f"mesh {leg} width {width} rank {r}: wall_s="
                        f"{x['wall']:.3f} rounds a generation "
                        f"{m['rounds_per_generation']} gathers a generation "
                        f"{led['by_kind'].get('mesh_gather', 0) / gens:.2f}"
                        f" bytes a gather {m['bytes_per_gather']:.0f} "
                        f"staging ms a gather {m['stage_ms_per_gather']:.4f}"
                        f" Gloo ms a gather {m['gloo_ms_per_gather']:.4f} "
                        f"syncs {led['by_kind']}")
                    check(m["gathers"] == gens == led["by_kind"].get(
                        "mesh_gather"), f"mesh {leg} width {width} rank {r}:"
                        f" not one gather a generation")
                    check(same(x["arrays"], prim["arrays"]),
                          f"mesh {leg} width {width}: rank {r}'s History is "
                          f"not the primary's")
                ok = same(prim["arrays"], refs[leg])
                log(f"mesh {leg} width {width}: the primary's History "
                    f"bit-identical to the virtual shards': {ok}")
                check(ok, f"mesh {leg} width {width}: the primary's History "
                      f"is not the virtual shards' bit for bit")
                counts = {k: sum(rr[leg]["counts"][k] for rr in res)
                          for k in prim["counts"]}
                path = (MESH_PATH if leg == "lv" else
                        SH_AD_PATH + MESH_KERNELS if leg == "lv_adaptive"
                        else ("propose",) + MESH_LEG_PATH[leg]
                        + MESH_KERNELS)
                path += tuple(n for n, _s, _r, lg in LANE_BASE_ROWS
                              if lg == leg or (leg == "lv_adaptive"
                                               and lg == "lv"))
                missing = [k for k in path if counts[k] == 0]
                check(not missing, f"mesh {leg} width {width}: {missing} "
                      f"never launched on its path")
                log(f"mesh {leg} width {width}: launches (all ranks) "
                    f"{ {k: counts[k] for k in path} }")
                out[leg, width] = counts
    return out


def mesh_checks(dev) -> dict:
    """K24e's pack and unpack against their plain twin at the LV mesh
    leg's shapes (n_cap 16384 on 8 shards, d 4; widths 2 and 4, the
    adaptive leg's feature rows and moment blocks of S 40 too; no leg
    stores its statistics, so none gathers them), bit-exact; K2
    (transition mode, a fit of 16384 rows), K4's LV and Gaussian kernels
    over each rank's lanes [a, b) of B 65536 with the lane base a, bit for
    bit rows [a, b) of the whole round's launch -> their results (timed at
    width 2, the LV leg's non-adaptive pieces)."""
    import torch

    from pyabc_tpu_torch.kernels import (gaussian_simulate, lv_simulate,
                                         mesh_pack, mesh_unpack, philox,
                                         propose)
    from pyabc_tpu_torch.kernels.gaussian_simulate import (
        gaussian_simulate_plain)
    from pyabc_tpu_torch.kernels.lv_simulate import lv_simulate_plain
    from pyabc_tpu_torch.kernels.mesh_pack import (mesh_pack_plain,
                                                   mesh_unpack_plain)
    from pyabc_tpu_torch.kernels.propose import propose_plain
    from pyabc_tpu_torch.models import gaussian
    from pyabc_tpu_torch.models import lotka_volterra as lv

    g = torch.Generator(device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def pieces(w, adaptive, seed):
        g.manual_seed(seed)
        v, R = SH_N // w, MESH_POP // w
        p = [torch.randint(0, 99, (5,), generator=g, **i32),
             torch.randint(0, 2, (1,), generator=g, **i32),
             torch.randint(0, 2048, (v * 4,), generator=g, **i32),
             torch.randint(-1, 1 << 20, (R,), generator=g, **i32),
             torch.randn(R, 4, generator=g, device=dev),
             torch.rand(R, generator=g, device=dev),
             torch.randn(R, generator=g, device=dev)]
        p[-1][:5] = -math.inf
        if adaptive:
            p += [torch.rand(R, 40, generator=g, device=dev),
                  torch.randn(v, 6, 40, generator=g, device=dev)]
        return p

    def dsts(p, w):
        return [None, None] + [torch.empty((w * t.shape[0], *t.shape[1:]),
                                           dtype=t.dtype, device=dev)
                               for t in p[2:]]

    out = {}
    timed = {}
    for w in (2, 4):
        for adaptive in (False, True):
            ranks = [pieces(w, adaptive, 10 * w + r) for r in range(w)]
            bufs = [mesh_pack(p) for p in ranks]
            ok = all(torch.equal(b, mesh_pack_plain(p))
                     for b, p in zip(bufs, ranks))
            buf = torch.stack(bufs)
            lens = [t.numel() for t in ranks[0]]
            got, want = dsts(ranks[0], w), dsts(ranks[0], w)
            mesh_unpack(buf, got, lens)
            mesh_unpack_plain(buf, want, lens)
            torch.cuda.synchronize()
            ok = ok and all(torch.equal(a.view(torch.int32),
                                        b.view(torch.int32))
                            for a, b in zip(got[2:], want[2:]))
            log(f"K24e mesh pack/unpack (width {w}, "
                f"{'adaptive' if adaptive else 'plain'} pieces, "
                f"{sum(lens)} words a rank): bit-exact={ok}")
            check(ok, f"K24e at width {w}: pack or unpack not bit-exact")
            if not adaptive:
                timed[w] = (ranks, buf, lens, got)
    res = {}
    for w, (ranks, buf, lens, got) in timed.items():
        p0, W = ranks[0], sum(lens)
        res[w] = dict(
            pack_ms=graph_ms(lambda: mesh_pack(p0)),
            pack_call_ms=time_ms(lambda: mesh_pack(p0), 50),
            pack_plain_ms=time_ms(lambda: mesh_pack_plain(p0), 20),
            pack_library_ms=time_ms(lambda: torch.cat(
                [t.reshape(-1).view(torch.int32) if t.dtype != torch.int32
                 else t.reshape(-1) for t in p0]), 20),
            unpack_ms=graph_ms(lambda: mesh_unpack(buf, got, lens)),
            unpack_call_ms=time_ms(lambda: mesh_unpack(buf, got, lens), 50),
            unpack_plain_ms=time_ms(lambda: mesh_unpack_plain(buf, got,
                                                              lens), 20),
            # each word read once and written once
            pack_bound=bound(2 * 4 * W, 0.0),
            unpack_bound=bound(2 * 4 * w * (W - 6), 0.0))
        x = res[w]
        log(f"K24e width {w}: pack {x['pack_ms']:.5f} ms (call "
            f"{x['pack_call_ms']:.5f}, plain {x['pack_plain_ms']:.5f}, "
            f"torch.cat {x['pack_library_ms']:.5f}, bound "
            f"{x['pack_bound'][0]:.6f}); unpack {x['unpack_ms']:.5f} ms "
            f"(call {x['unpack_call_ms']:.5f}, plain "
            f"{x['unpack_plain_ms']:.5f}, bound {x['unpack_bound'][0]:.6f})")
    r2, r4 = res[2], res[4]
    out["mesh_pack"] = dict(
        err=0.0, ms=r2["pack_ms"], call_ms=r2["pack_call_ms"],
        plain_ms=r2["pack_plain_ms"], bound=r2["pack_bound"],
        library_ms=r2["pack_library_ms"], ms_width_4=r4["pack_ms"])
    out["mesh_unpack"] = dict(
        err=0.0, ms=r2["unpack_ms"], call_ms=r2["unpack_call_ms"],
        plain_ms=r2["unpack_plain_ms"], bound=r2["unpack_bound"],
        library_ms=None, ms_width_4=r4["unpack_ms"])

    # the lane base: K2's transition mode, K4's LV and Gaussian kernels
    B = 65536
    g.manual_seed(42)
    prior = lv.default_prior().arrays(dev)
    lo, hi = prior["loc"], prior["hi"]
    fit = {"cdf": torch.cumsum(torch.rand(MESH_POP, generator=g,
                                          device=dev), 0),
           "thetas": lo + torch.rand(MESH_POP, 4, generator=g,
                                     device=dev) * (hi - lo),
           "chol": torch.eye(4, device=dev) * 0.1}
    theta = (lo + torch.rand(B, 4, generator=g, device=dev)
             * (hi - lo)).contiguous()
    model = lv.make_lv_model()
    lvkw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
                y0=lv.Y0, noise_sd=model.noise_sd, log_parameters=False)
    gth = torch.rand(B, 2, generator=g, device=dev) + 0.5

    def stream(tag, lane0):
        s = stream_on(dev, tag)
        return philox.PhiloxStream(s.seed, s.generation, s.tag,
                                   s.max_rounds, s.counters, lane0=lane0)

    # K2's draws on the timed block's lanes: one, plus one a leading draw
    # without prior mass
    k2_draws = float(redraws_taken(stream(philox.TRANSITION, B // 2),
                                   B // 2, prior, fit).sum())

    kernels = {
        "propose:lane_base": (
            lambda s, a, n: propose(s, n, prior, fit),
            lambda s, a, n: propose_plain(s, n, prior, fit),
            philox.TRANSITION,
            # the fit read, theta, logpri and valid written; the draws the
            # block's lanes take
            (MESH_POP * (1 + 4) + 16) * 4 + B // 2 * (4 * 4 + 4 + 1),
            k2_draws * k2_per_draw(MESH_POP, 4)),
        "lv_simulate:lane_base": (
            lambda s, a, n: (lv_simulate(theta[a:a + n], None, stream=s,
                                         **lvkw),),
            lambda s, a, n: (lv_simulate_plain(theta[a:a + n], None,
                                               stream=s, **lvkw),),
            philox.SIM_NOISE,
            B // 2 * (4 + 2 * model.n_obs) * 4,
            B // 2 * ((model.n_obs - 1) * model.n_substeps * 4 * 12
                      + 2 * model.n_obs * 30)),
        "gaussian_simulate:lane_base": (
            lambda s, a, n: (gaussian_simulate(gth[a:a + n], n=GAUSS_N,
                                               stream=s),),
            lambda s, a, n: (gaussian_simulate_plain(gth[a:a + n],
                                                     n=GAUSS_N, stream=s),),
            philox.SIM_NOISE, B // 2 * 16,
            B // 2 * (3 * 100 + GAUSS_N * 31 + 4)),
    }
    for name, (fn, plain, tag, nbytes, flops) in kernels.items():
        full = fn(stream(tag, 0), 0, B)
        err, ok = 0.0, True
        for w in (2, 4):
            for r in range(w):
                a, n = r * B // w, B // w
                part = fn(stream(tag, a), a, n)
                for x, y in zip(full, part):
                    ok = ok and bool(torch.equal(x[a:a + n], y))
                    err = max(err, float((x[a:a + n].float() - y.float())
                                         .abs().nan_to_num().max()))
        torch.cuda.synchronize()
        log(f"{name} (B {B}, widths 2 and 4): each rank's block bit-equal "
            f"to the whole round's rows: {ok}")
        check(ok, f"{name}: a rank's block differs from the whole round's "
              f"rows")
        s1 = stream(tag, B // 2)
        out[name] = dict(
            err=err, ms=graph_ms(lambda: fn(s1, B // 2, B // 2)),
            call_ms=time_ms(lambda: fn(s1, B // 2, B // 2), 50),
            plain_ms=time_ms(lambda: plain(s1, B // 2, B // 2), 2,
                             warmup=1),
            bound=bound(nbytes, flops), library_ms=None)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    import pyabc_tpu_torch  # noqa: F401 - fails outside a checkout
    from pyabc_tpu_torch.kernels import KERNELS, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} capability {cap}")
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")
    t0 = time.perf_counter()

    def mark(phase: str) -> None:
        # where the script's time goes: seconds since the build began
        log(f"time: {phase} done at {time.perf_counter() - t0:.1f} s")

    _build.library()
    log(f"kernel build+load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    global REFS
    REFS = CpuRefs()
    # a failed run stops the reference process too
    atexit.register(REFS.close, False)

    results = kernel_checks(dev)
    results.update(noisy_checks(dev))
    results.update(model_checks(dev))
    results["tau_leap"] = k19_checks(dev)
    results["network_sir"] = k20b_network_checks(dev)
    results.update(k22_checks(dev))
    results.update(k18_mode_checks(dev))
    results.update(local_checks(dev))
    mark("phase 2 through K12-K15")
    results.update(k21c_checks(dev))
    results.update(k16_checks(dev))
    results.update(k16_local_checks(dev))
    results.update(local_models_checks(dev))
    mark("phase 2 through K16 and the K > 1 local modes")
    results.update(k25_checks(dev))
    results.update(k2_family_checks(dev))
    mark("phase 2 through K25 and K2's families")
    results.update(k23_checks(dev)[0])
    results.update(k23_mlp_checks(dev))
    results.update(gp_checks(dev))
    k16_repair_case(dev)
    results.update(k17_checks(dev))
    results.update(k14_ring_checks(dev))
    results.update(gaussian_checks(dev))
    results.update(mean_only_checks(dev))
    results.update(round_checks(dev))
    results.update(shard_checks(dev))
    results.update(agg_shard_checks(dev))
    results.update(mesh_checks(dev))
    results.update(lane_base_checks(dev))
    mark("phase 2 (every kernel against its plain version)")
    toy_counts = gaussian_toy(dev)
    toy_cpu_check(dev)
    noisy_anchor(dev)
    fam_launches = family_anchor(dev)
    pair_counts = pair_anchor(dev)
    mark("anchors (toy, noisy, families, pair)")
    lotka_volterra(dev, adaptive=False, gens=6)
    counts, eps = lotka_volterra(dev, adaptive=True, gens=10)
    profile_lv(dev)
    lv_cpu_trail(eps)
    sir_counts, temps = sir_run(dev)
    profile_run("SIR config 4", sir_config4(dev), SIR_GENS)
    sir_cpu_trail(temps)
    c5_counts, c5_eps = config5_run(dev)
    profile_run("config 5", config5(dev), C5_GENS)
    config5_cpu_trail(c5_eps)
    mark("LV config 2, SIR config 4, config 5")
    c3_counts, c3_eps = config3_run(dev)
    profile_run("config 3 (early reject on)", config3(dev, "auto"),
                C3_GENS)
    config3_cpu_trail(dev)
    k3_at_bench_pop(dev)
    zoo = zoo_runs(dev)
    ad_counts = adaptive_run(dev)
    profile_run("adaptive config 3 (early reject on)",
                config3_adaptive(dev, "auto"), C3A_GENS)
    bench_adaptive_leg(dev)
    zms_counts = zoo_model_selection_run(dev)
    profile_run("zoo model selection (early reject on)",
                zoo_model_selection(dev, "auto"), ZMS_GENS)
    scale_counts, _scale_eps = scale_lane_run(dev)
    profile_run("scale lane (LV, LocalTransition)", scale_lane(dev),
                SCALE_GENS)
    scale_cpu_trail(dev)
    mark("config 3, zoo, adaptive config 3, scale lane")
    nc3 = {kind: noisy_config3_run(dev, kind)
           for kind in ("independent_normal", "poisson")}
    profile_run("noisy config 3 (independent normal, early reject on)",
                noisy_config3(dev, "auto", "independent_normal"), NC3_GENS)
    with tempfile.TemporaryDirectory() as tmpdir:
        fam_counts = family_runs(dev, tmpdir)
    mark("noisy legs")
    ada_counts, ada_modes, _ada_trail, ada_abc = population_leg(
        dev, "LV adaptive leg", adaptive_lv, ADA_GENS, ADA_PATH, lo=10,
        hi=ADA_MAX)
    constant_lv_syncs(dev, ada_abc)
    reach_counts, reach_modes, _r, _a = population_leg(
        dev, f"LV adaptive leg at mean_cv {ADA_CV_REACH}",
        lambda where: adaptive_lv(where, ADA_CV_REACH, ADA_MIN_REACH),
        ADA_GENS, ADA_PATH, lo=ADA_MIN_REACH, hi=ADA_MAX, bisects=True)
    c5a_counts, c5a_modes, _c5a_trail, _c5a = population_leg(
        dev, "config 5 adaptive leg (K = 3)", config5_adaptive, C5A_GENS,
        C5_PATH + ("bootstrap_cv",), lo=10, hi=C5A_MAX)
    list_counts, _list_modes, _sizes = list_leg(dev)
    mark("population-size legs")
    # LocalTransition under adaptive and listed sizes and over several
    # models: K16's LocalTransition mode, K2's and K14's K > 1 local modes
    lla_counts, lla_modes, _t, _a = population_leg(
        dev, "LV local adaptive leg",
        lambda where: adaptive_lv(where, local=True), ADA_GENS,
        LOCAL_ADA_PATH, lo=10, hi=ADA_MAX, local_fits=(1, ADA_BOOT))
    llr_counts, llr_modes, _t, _a = population_leg(
        dev, f"LV local adaptive leg at mean_cv {ADA_CV_REACH}",
        lambda where: adaptive_lv(where, ADA_CV_REACH, ADA_MIN_REACH,
                                  local=True),
        ADA_GENS, LOCAL_ADA_PATH, lo=ADA_MIN_REACH, hi=ADA_MAX,
        bisects=True, local_fits=(1, ADA_BOOT))
    c5l_counts, c5l_modes, _t, _a = population_leg(
        dev, "config 5 local adaptive leg (K = 3)",
        lambda where: config5_adaptive(where, local=True), C5A_GENS,
        LOCAL_C5A_PATH, lo=10, hi=C5A_MAX, local_fits=(3, ADA_BOOT))
    for label, runs in (("LV local adaptive leg", lla_counts),
                        ("config 5 local adaptive leg", c5l_counts)):
        check(runs["mvn_fit"] == runs["mvn_mixture_logpdf"] == 0,
              f"{label}: an MVN kernel ran on the LocalTransition path")
    check(all(c5l_modes[k] > 0 for k in LOCAL_MODES),
          f"config 5 local adaptive leg: a K > 1 local mode never "
          f"launched ({ {k: c5l_modes[k] for k in LOCAL_MODES} })")
    local_adaptive_cpu_trails(dev)
    pair_local = pair_anchor(dev, "local")
    list_local, _m, _s = list_leg(dev, "local")
    mark("local legs")
    # GridSearchCV (K17) in its three modes; LocalTransition under a
    # StochasticAcceptor (K14 over the record ring) and under early reject
    lvg_counts = lv_grid_leg(dev)
    list_grid, _m, _s = list_leg(dev, "grid")
    pair_grid = pair_anchor(dev, "grid")
    noisy_local = noisy_anchor(dev, local=True)
    sir_local = sir_local_run(dev)
    c3l_counts = config3_local_run(dev)
    mark("GridSearchCV legs, LocalTransition's noisy and segmented legs")
    # the per-generation host loop: config 1 (K4's Gaussian kernel, K26's
    # round kernel), LV config 2 and the tractable pair
    x1 = config1_legs(dev)
    config1_mean_only(dev)
    config1_cpu_check(dev)
    hl_lv = host_lv_leg(dev)
    hl_pair = pair_host_loop(dev)
    mark("host-loop legs")
    # sharded fused sampling on 8 virtual shards (K24a-d)
    lvs_counts = lv_sharded_leg(dev)
    lvas_counts = lv_adaptive_sharded_leg(dev)
    toy_sharded(dev)
    pair_sh = pair_anchor(dev, "sharded")
    mark("sharded legs")
    # aggregated distances and user schedules on 8 shards (K25's twins)
    agg_sh_counts = lv_aggregate_sharded_leg(dev, "adaptive")
    sched_sh_counts = lv_aggregate_sharded_leg(dev, "schedule")
    lv_aggregate_sharded_card_cpu(dev)
    mark("aggregated sharded legs")
    # the device mesh over Gloo: w rank processes on the one card (K24e,
    # the lane-base modes of K2 and K4)
    mesh = mesh_legs(dev)
    mesh_counts = mesh["lv", 2]
    mark("mesh legs")
    agg_counts, _agg_modes, _agg_abc = lv_aggregate_leg(dev, "adaptive")
    lv_aggregate_cpu_trail(dev)
    sched_counts, _sched_modes, _sched_abc = lv_aggregate_leg(dev,
                                                              "schedule")
    c3agg_counts, c3agg_eps = config3_aggregate_run(dev)
    profile_run("config 3 aggregated (early reject on)",
                config3_aggregate(dev, "auto"), C3_GENS)
    lvf_counts, lvf_modes = lv_family_leg(dev)
    lv_family_cpu_trail(dev)
    family_pair(dev)
    writer_turns(dev)
    mark("aggregated legs, family legs, writer turns")
    ls_counts, ls_modes, ls_params, ident_fetch = learned_leg(dev)
    learned_cpu_trail(dev)
    learned_adaptive_leg(dev)
    learned_accuracy(dev)
    mlp_counts, _mlp_modes = learned_mlp_leg(dev, ident_fetch)
    learned_mlp_cpu_trail(dev)
    gp_counts = host_refit_legs(dev)
    gp_cpu_trail(dev)
    mark("learned-statistics legs")
    # K18's phase-2 check takes its eps from generation 6 of config 3,
    # its stochastic mode T and the pdf norm from generation 8 of the
    # noisy config 3 leg
    results["segment_round"] = k18_checks(dev, c3_eps[6])
    _c, nc3_temps, nc3_norms = nc3["independent_normal"]
    results["segment_round:stochastic"] = k18_stochastic_checks(
        dev, nc3_temps[8], nc3_norms[8])
    # K18's aggregate mode at generation 6 of the aggregated config 3 leg
    results["segment_round:aggregate"] = k18_aggregate_checks(
        dev, c3agg_eps[6], c3_eps[6])
    # K18's transformed mode at the learned leg's round, with the
    # transform that leg ended with, and at config 3's round under C' 8
    results["segment_round:linear"] = k18_linear_checks(dev, ls_params)
    mark("K18's checks")
    finish_references()
    REFS.close(True)
    mark("CPU references compared")
    for name, r in results.items():
        log(f"{name}: ms={r['ms']:.5f} call_ms={r['call_ms']:.5f} "
            f"plain_ms={r['plain_ms']:.5f} "
            f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}) "
            f"library_ms={r['library_ms']}")

    kernels = []
    wrapper_of = {k.name: k for k in KERNELS}
    check(wrapper_of["bootstrap_cv"].ENTRIES
          == K16_ENTRIES + K16_LOCAL_ENTRIES, "K16's entries changed")
    for k in KERNELS:
        if k.name == "bootstrap_cv":
            continue  # K16's four entries follow as rows of their own
        r = results[k.name]
        # each kernel's launches on its slice's main path: LV config 2 for
        # K1-K11, the conjugate toy for K4's mean-only kernel, SIR config 4
        # for K20, K21a and K21b, config 5 for K20b
        # and K26, config 3 for K18 and K19, the scale lane for K12-K15,
        # the LV aggregated adaptive leg for K25, the learned-statistics
        # leg for K23 and K18's transformed operands, the MLP leg for K23's
        # MLP kernels, the host-refit GP leg for the GP transform
        own = (toy_counts if k.name in TOY_KERNELS
               else mesh_counts if k.name in MESH_KERNELS
               else agg_sh_counts if k.name in AGG_SH_KERNELS
               else lvs_counts if k.name in SHARD_KERNELS
               else x1["pipelined"] if k.name in HL_KERNELS
               else lvg_counts if k.name == "grid_search_cv"
               else gp_counts if k.name in GP_KERNELS
               else mlp_counts if k.name in MLP_KERNELS
               else ls_counts if k.name in LS_KERNELS
               else agg_counts if k.name in AGG_KERNELS
               else sir_counts if k.name in NOISY_KERNELS else c5_counts
               if k.name in MODEL_KERNELS else scale_counts
               if k.name in LOCAL_KERNELS else c3_counts
               if k.name in SEG_KERNELS else zoo["network_sir"]
               if k.name == "network_sir" else ad_counts
               if k.name in PR7_KERNELS else zms_counts
               if k.name in ZMS_KERNELS else counts)
        # K7's row is its normalization; the quantile epsilon has its own
        # (its launches_by_path count both entries)
        key = (k.name + ":normalize" if k.name == "normalize_quantile"
               else k.name)
        launches = own[key]
        entry = {
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": launches,
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "launches_by_path": {"gaussian_toy": toy_counts[k.name],
                                 "tractable_pair": pair_counts[k.name],
                                 "lv_config2": counts[k.name],
                                 "sir_config4": sir_counts[k.name],
                                 "ode_config5": c5_counts[k.name],
                                 "tau_leap_config3": c3_counts[k.name],
                                 "zoo_stochastic_lv":
                                     zoo["stochastic_lv"][k.name],
                                 "zoo_network_sir":
                                     zoo["network_sir"][k.name],
                                 "scale_lane": scale_counts[k.name],
                                 "adaptive_config3": ad_counts[k.name],
                                 "zoo_model_selection":
                                     zms_counts[k.name],
                                 "noisy_config3_normal":
                                     nc3["independent_normal"][0][k.name],
                                 "noisy_config3_poisson":
                                     nc3["poisson"][0][k.name],
                                 "lv_adaptive": ada_counts[k.name],
                                 "lv_adaptive_reachable":
                                     reach_counts[k.name],
                                 "config5_adaptive": c5a_counts[k.name],
                                 "toy_list": list_counts[k.name],
                                 "lv_aggregate_adaptive":
                                     agg_counts[k.name],
                                 "lv_aggregate_schedule":
                                     sched_counts[k.name],
                                 "config3_aggregate":
                                     c3agg_counts[k.name],
                                 "lv_families": lvf_counts[k.name],
                                 "learned_network_sir":
                                     ls_counts[k.name],
                                 "learned_mlp_network_sir":
                                     mlp_counts[k.name],
                                 "host_refit_gp_network_sir":
                                     gp_counts[k.name],
                                 "lv_local_adaptive": lla_counts[k.name],
                                 "lv_local_adaptive_reachable":
                                     llr_counts[k.name],
                                 "config5_local_adaptive":
                                     c5l_counts[k.name],
                                 "tractable_pair_local":
                                     pair_local[k.name],
                                 "toy_list_local": list_local[k.name],
                                 "lv_grid": lvg_counts[k.name],
                                 "toy_list_grid": list_grid[k.name],
                                 "tractable_pair_grid": pair_grid[k.name],
                                 "noisy_anchor_local": noisy_local[k.name],
                                 "sir_config4_local": sir_local[k.name],
                                 "config3_local": c3l_counts[k.name],
                                 "config1_host_loop":
                                     x1["pipelined"][k.name],
                                 "config1_speculation_forced":
                                     x1["speculative"][k.name],
                                 "config1_per_round": x1["rounds"][k.name],
                                 "config1_fused": x1["fused"][k.name],
                                 "lv_config2_host_loop": hl_lv[k.name],
                                 "tractable_pair_host_loop":
                                     hl_pair[k.name],
                                 "lv_sharded": lvs_counts[k.name],
                                 "lv_adaptive_sharded": lvas_counts[k.name],
                                 "tractable_pair_sharded":
                                     pair_sh[k.name],
                                 "lv_aggregate_sharded":
                                     agg_sh_counts[k.name],
                                 "lv_schedule_sharded":
                                     sched_sh_counts[k.name],
                                 **{f"{leg}_mesh_w{w}": c[k.name]
                                    for (leg, w), c in mesh.items()}},
        }
        for extra in ("cpu_lanes_differ", "ms_eps_inf", "ms_k19_round",
                      "n_changed_incremental", "noisy_keep_flips",
                      "transform_ms", "transform_err", "k5_ms",
                      "transform_call_ms", "gradient_err", "loss_rel",
                      "seed_ms", "seed_call_ms", "seed_bound_ms",
                      "seed_plain_ms", "launches_seed_fit", "rel_err", "rel",
                      "ms_width_4", "library_eager_ms"):
            if extra in r:
                entry[extra] = r[extra]
        if k.name in MODEL_MODES:
            mode = results[MODEL_MODES[k.name]]
            entry["k_gt_1_mode"] = {
                "launches": c5_counts[k.name], "max_abs_err": mode["err"],
                "ms": mode["ms"], "call_ms": mode["call_ms"],
                "plain_ms": mode["plain_ms"], "bound_ms": mode["bound"][0],
                "bound_by": mode["bound"][1], "library_ms": None}
        if k.name == "segment_round":
            # K18's modes of this slice, their launches from their legs
            for mode, res_key, runs, key in (
                    ("adaptive_mode", "segment_round_adaptive", ad_counts,
                     "segment_round:adaptive"),
                    ("k_gt_1_mode", "segment_round_models", zms_counts,
                     "segment_round:k_gt_1")):
                r = results[res_key]
                entry[mode] = {
                    "launches": runs[key], "max_abs_err": r["err"],
                    "keep_flips": r["keep_flips"],
                    "ms": r["ms"], "call_ms": r["call_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": None}
        if k.name == "grid_search_cv":
            # K17 at LV config 2's shape (n 1000), beside the leg's 16384
            c2 = results["grid_search_cv:config2"]
            entry["lv_config2_shape"] = {
                "max_abs_err": c2["err"], "ms": c2["ms"],
                "call_ms": c2["call_ms"], "plain_ms": c2["plain_ms"],
                "bound_ms": c2["bound"][0], "bound_by": c2["bound"][1]}
        if k.name == "compact_round":
            rec = results["compact_round_record"]
            entry["record_mode"] = {
                "max_abs_err": rec["err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
                "bound_by": rec["bound"][1], "library_ms": None}
        kernels.append(entry)
    # K21a/K21c by family and K18's stochastic mode, their launches from
    # the legs that run them
    nc3_n, nc3_p = nc3["independent_normal"][0], nc3["poisson"][0]
    own = {"independent_normal": nc3_n["kernel_accept:independent_normal"],
           "poisson": (nc3_p["kernel_accept:poisson"]
                       + fam_counts["poisson-lin"]["kernel_accept:poisson"]),
           "laplace": fam_counts["laplace"]["kernel_accept:laplace"],
           "binomial": fam_counts["binomial"]["kernel_accept:binomial"],
           "negbin_size": fam_counts["negbin"]["kernel_accept:negbin_size"],
           "negbin_mean": fam_counts["negbin-mean"][
               "kernel_accept:negbin_mean"],
           "normal": fam_counts["normal"]["kernel_accept:normal"]}
    rows = [(f"kernel_accept:{fam}", "pyabc_tpu_torch/csrc/kernel_accept.cu",
             f"pyabc_tpu/distance/kernel.py:{line}", n)
            for (fam, line), n in zip(K21C_LINES, (own[f] for f, _l in
                                                   K21C_LINES))]
    rows.append(("segment_round:stochastic",
                 "pyabc_tpu_torch/csrc/segment_round.cu",
                 "pyabc_tpu/inference/util.py:1118",
                 nc3_n["segment_round:stochastic"]
                 + nc3_p["segment_round:stochastic"]))
    rows.append(("segment_round:aggregate",
                 "pyabc_tpu_torch/csrc/segment_round.cu",
                 "pyabc_tpu/distance/aggregate.py:85",
                 c3agg_counts["segment_round:aggregate"]))
    rows.append(("segment_round:linear",
                 "pyabc_tpu_torch/csrc/segment_round.cu",
                 "pyabc_tpu/ops/fit.py:240",
                 ls_modes["segment_round:linear"]))
    # K7's quantile epsilon, its launches from LV config 2
    rows.append(("normalize_quantile:epsilon",
                 "pyabc_tpu_torch/csrc/normalize_quantile.cu",
                 "pyabc_tpu/inference/util.py:1866",
                 counts["normalize_quantile:epsilon"]))
    # K24's modes of K6, K10 and K22: K24a and K24c from the LV sharded
    # leg, K24d from the LV adaptive sharded leg (its only path)
    rows += [("compact_round:shards", "pyabc_tpu_torch/csrc/compact_round.cu",
              "pyabc_tpu/inference/util.py:493",
              lvs_counts["compact_round:shards"]),
             ("pack_fetch:merge", "pyabc_tpu_torch/csrc/pack_fetch.cu",
              "pyabc_tpu/ops/pack.py:105",
              lvs_counts["pack_fetch:merge"]),
             ("moment_fold:shards", "pyabc_tpu_torch/csrc/moments.cu",
              "pyabc_tpu/ops/scale_reduce.py:67",
              lvas_counts["moment_fold:shards"]),
             ("moment_finish:shards", "pyabc_tpu_torch/csrc/moments.cu",
              "pyabc_tpu/inference/util.py:2672",
              lvas_counts["moment_finish:shards"])]
    # K25's sharded twins' modes, their launches from the LV aggregated
    # sharded leg (every fold launch of that leg is on the value columns)
    rows += [("aggregate_accept_weight:value_rows",
              "pyabc_tpu_torch/csrc/aggregate.cu",
              "pyabc_tpu/distance/aggregate.py:315",
              agg_sh_counts["aggregate_accept_weight:value_rows"]),
             ("compact_round:given_rows",
              "pyabc_tpu_torch/csrc/compact_round.cu",
              "pyabc_tpu/inference/util.py:590",
              agg_sh_counts["compact_round:given_rows"]),
             ("moment_fold:value_columns", "pyabc_tpu_torch/csrc/moments.cu",
              "pyabc_tpu/ops/scale_reduce.py:67",
              agg_sh_counts["moment_fold:shards"])]
    # the lane-base modes, their launches from the ranks past the first of
    # the width-2 mesh legs (LV, config 1's Gaussian, the toy, config 5,
    # SIR, birth-death, and with early reject off the segmented network
    # SIR and family)
    rows += [(name, source, replaces, mesh[leg, 2][name])
             for name, source, replaces, leg in LANE_BASE_ROWS]
    for name, source, replaces, launches in rows:
        r = results[name]
        check(launches > 0, f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("ms_pnorm_mode", "ms_k20b_round",
                                 "ms_feature_mode", "ms_accept_alone",
                                 "rel", "ms_width_4") if k in r},
            **({"k6_ring_mask": {
                "ms": r["k6_ring_mask"]["ms"],
                "call_ms": r["k6_ring_mask"]["call_ms"],
                "plain_ms": r["k6_ring_mask"]["plain_ms"],
                "bound_ms": r["k6_ring_mask"]["bound"][0],
                "bound_by": r["k6_ring_mask"]["bound"][1]}}
               if "k6_ring_mask" in r else {})})
    # K2's family mode, its launches from the LV families leg (this
    # slice's main path)
    r = results["propose:families"]
    check(lvf_modes["propose:families"] > 0,
          "propose:families was never launched on its path")
    kernels.append({
        "name": "propose:families", "route": "cuda",
        "source": "pyabc_tpu_torch/csrc/propose.cu",
        "replaces": "pyabc_tpu/core/random_variables.py:161",
        "launches": lvf_modes["propose:families"], "max_abs_err": r["err"],
        "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r["library_ms"], "ms_prior_mode": r["ms_prior_mode"],
        "lanes_apart": r["lanes_apart"],
        "by_family": {k: {"ms": v["ms"], "call_ms": v["call_ms"],
                          "plain_ms": v["plain_ms"],
                          "bound_ms": v["bound"][0],
                          "bound_by": v["bound"][1],
                          "library_ms": v["library_ms"],
                          "max_abs_err": v["err"],
                          "launches": fam_launches.get(k)}
                      for k, v in r["by_family"].items()}})
    # K16's entries, their launches from the LV adaptive leg (its main
    # path) and the config 5 adaptive leg beside them
    for e in K16_ENTRIES:
        name = f"bootstrap_cv:{e}"
        r = results[name]
        check(ada_modes[name] > 0 and c5a_modes[name] > 0,
              f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pyabc_tpu_torch/csrc/bootstrap_cv.cu",
            "replaces": wrapper_of["bootstrap_cv"].ENTRY_REPLACES[e],
            "launches": ada_modes[name],
            "max_abs_err": r["err"], "max_rel_err": r["rel"], "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
            "launches_by_path": {"lv_adaptive": ada_modes[name],
                                 "lv_adaptive_reachable": reach_modes[name],
                                 "config5_adaptive": c5a_modes[name]}})
    # K16's LocalTransition mode (its gather and density, and the K12 and
    # K13 launches of its bootstrap fits), launches from the LV local
    # adaptive leg; the K > 1 local modes from the config 5 local adaptive
    # leg
    local_rows = [
        (f"bootstrap_cv:{e}", "pyabc_tpu_torch/csrc/bootstrap_cv.cu",
         wrapper_of["bootstrap_cv"].ENTRY_REPLACES[e], lla_modes, llr_modes,
         c5l_modes) for e in K16_LOCAL_ENTRIES]
    local_rows += [
        ("local_cov:bootstrap", "pyabc_tpu_torch/csrc/local_cov.cu",
         "pyabc_tpu/transition/util.py:173", lla_modes, llr_modes,
         c5l_modes),
        ("local_factor:bootstrap", "pyabc_tpu_torch/csrc/local_factor.cu",
         "pyabc_tpu/transition/util.py:173", lla_modes, llr_modes,
         c5l_modes)]
    for name, src, line in LOCAL_MODE_ROWS:
        local_rows.append((name, src, line, c5l_modes, None, None))
    # K17's fold-table (list) and K > 1 rows, their launches from the toy's
    # list and the tractable pair under GridSearchCV; K14 over the record
    # ring, its ring passes from SIR config 4 with a LocalTransition
    for name, source, replaces, launches in (
            ("grid_search_cv:fold_table",
             "pyabc_tpu_torch/csrc/grid_search_cv.cu",
             "pyabc_tpu/transition/grid_search.py:119",
             list_grid["grid_search_cv"]),
            ("grid_search_cv:models",
             "pyabc_tpu_torch/csrc/grid_search_cv.cu",
             "pyabc_tpu/transition/grid_search.py:119",
             pair_grid["grid_search_cv:models"]),
            ("local_logpdf:ring", "pyabc_tpu_torch/csrc/local_logpdf.cu",
             "pyabc_tpu/transition/local_transition.py:442",
             sir_local["local_logpdf:ring"])):
        r = results[name]
        check(launches > 0, f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    for name, source, replaces, own, reach, c5 in local_rows:
        r = results[name]
        check(own[name] > 0, f"{name} was never launched on its path")
        by_path = {"lv_local_adaptive" if reach is not None
                   else "config5_local_adaptive": own[name]}
        if reach is not None:
            by_path.update(lv_local_adaptive_reachable=reach[name],
                           config5_local_adaptive=c5[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": own[name],
            "max_abs_err": r["err"], "max_rel_err": r.get("rel"),
            "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"probe_ms": r["probe_ms"]} if "probe_ms" in r else {}),
            "launches_by_path": by_path})
    # K26's round kernel: a composite of its lane kernels (K2, K3, K4's
    # Gaussian kernel, K5), which count their own launches in their rows;
    # its "launches" are the rounds of the per-round mode of config 1 (and
    # the forced speculative rounds beside them), read off the sync ledger
    r = results["round_kernel"]
    check(x1["rounds"]["round_kernel"] > 0,
          "round_kernel was never run on its path")
    kernels.append({
        "name": "round_kernel", "route": "cuda",
        "source": "pyabc_tpu_torch/inference/context.py",
        "replaces": "pyabc_tpu/inference/util.py:453",
        "composite": True, "launched_as": list(ROUND_LANES["transition"]),
        "launches": x1["rounds"]["round_kernel"], "max_abs_err": r["err"],
        "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": r["library_ms"],
        "launches_by_path": {
            "config1_per_round": x1["rounds"]["round_kernel"],
            "config1_speculation_forced":
                x1["speculative"]["round_kernel"]}})
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build's "
        f"start, of a 1200 s limit, on {card}")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k2_time(root: str) -> dict:
    """K2's device ms on LV config 2's default prior (norm/uniform) for
    the package under ``root``: transition and prior modes at B 4096 (a
    fit of 1024 rows) and B 65536 (16384 rows), with a hash of the prior
    draws' bits."""
    sys.path.insert(0, root)
    import torch

    from pyabc_tpu_torch.kernels import _build, mvn_fit, philox, propose
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.transition import silverman_rule_of_thumb

    t0 = time.perf_counter()
    _build.library()
    dev = torch.device("cuda", 0)
    out = {"root": root, "build_s": round(time.perf_counter() - t0, 2)}
    prior = lv.default_prior().arrays(dev)
    for B, n in ((4096, 1024), (65536, 16384)):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        X = lv.default_prior().rvs_array(n, g, dev).contiguous()
        w = torch.rand(n, generator=g, device=dev) + 0.1
        params = mvn_fit(X, (w / w.sum()).contiguous(), dim=4, scaling=1.0,
                         bandwidth_selector=silverman_rule_of_thumb)
        st_t = stream_on(dev, philox.TRANSITION, gen=2)
        st_p = stream_on(dev, philox.PRIOR, gen=2)
        th = propose(st_p, B, prior)[0]
        bits = th.view(torch.int32).long()
        out[f"B{B}"] = {
            "transition_ms": graph_ms(lambda: propose(st_t, B, prior,
                                                      params)),
            "prior_ms": graph_ms(lambda: propose(st_p, B, prior)),
            "prior_bits_hash": int((bits * torch.arange(
                1, bits.numel() + 1, device=dev).view_as(bits)).sum())}
    return out


def k2_registers(parent: str) -> None:
    """Each tree's propose.cu register counts (``nvcc -Xptxas -v``)."""
    import re

    for label, root in (("this tree", "."), ("parent", parent)):
        src = os.path.join(root, "pyabc_tpu_torch", "csrc", "propose.cu")
        r = subprocess.run(
            ["/usr/local/cuda/bin/nvcc", *"-gencode arch=compute_90a,"
             "code=sm_90a -O3 -std=c++17 -Xptxas -v -c".split(), src, "-o",
             os.path.join(tempfile.mkdtemp(), "propose.o")],
            capture_output=True, text=True)
        check(r.returncode == 0, f"nvcc {src}: {r.stderr[-2000:]}")
        name = None
        for line in r.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = re.sub(r".*_cu_[0-9a-f]+", "", m.group(1))[:40]
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                log(f"registers ({label}) {name}: {m.group(1)}")
                name = None


def lv_time(root: str) -> dict:
    """LV config 2's accepted particles / s (pop 1000, 10 generations, seed
    0, the kernels built) three times in one process, for the package under
    ``root``."""
    sys.path.insert(0, root)
    import torch

    from pyabc_tpu_torch.kernels import _build

    _build.library()
    dev = torch.device("cuda", 0)
    rates = []
    for _ in range(3):
        abc = config2(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = abc.run(max_nr_populations=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append(POP * (len(h.get_all_populations()) - 1) / wall)
    return {"root": root, "accepted_particles_per_s": rates}


#: what ``--turns`` times, one process a tree
TIMERS = {"k2": k2_time, "lv": lv_time}


def turns(what: str, parent: str) -> int:
    """``TIMERS[what]`` against another tree's on one card, in turns
    (parent, this tree, this tree, parent), each a process of its own
    (``--time WHAT ROOT``); for K2 each tree's register counts first.
    ``parent`` holds the parent's pyabc_tpu_torch."""
    if what == "k2":
        k2_registers(parent)
    for root in (parent, ".", ".", parent):
        r = subprocess.run([sys.executable, __file__, "--time", what, root],
                           capture_output=True, text=True)
        log(r.stdout.strip() or r.stderr[-2000:])
    return 0


if __name__ == "__main__":
    if "--log" in sys.argv:
        LOG_FILE = sys.argv[sys.argv.index("--log") + 1]
    if "--time" in sys.argv:
        i = sys.argv.index("--time")
        print(json.dumps(TIMERS[sys.argv[i + 1]](sys.argv[i + 2])))
        sys.exit(0)
    if "--mesh-rank" in sys.argv:
        i = sys.argv.index("--mesh-rank")
        sys.exit(mesh_rank_main(int(sys.argv[i + 1]), int(sys.argv[i + 2]),
                                sys.argv[i + 3], sys.argv[i + 4],
                                sys.argv[i + 5], sys.argv[i + 6:]))
    if "--cpu-refs" in sys.argv:
        sys.exit(cpu_refs_main(sys.argv[sys.argv.index("--cpu-refs") + 1]))
    if "--turns" in sys.argv:
        i = sys.argv.index("--turns")
        sys.exit(turns(sys.argv[i + 1], sys.argv[i + 2]))
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc``; it imports nothing of JAX or of ``ptmcmcsampler_tpu``.
Phases, in order; any failure exits non-zero:

1. Card and build: print the card's name and power limit, build every
   CUDA kernel from ``ptmcmcsampler_torch/csrc`` with ``nvcc`` for sm_90a,
   one ``nvcc`` per source, all started together, then the chain-row
   formatter (``csrc/chainio.cpp``) with the host compiler.
2. Kernels vs plain, on the card at the main paths' shape (8 x 16384
   chains, D=2), on synthetic inputs around both modes of the curved target:
   * ChEES trajectories, ``nsteps <= 32``: q1 and p1 within rtol = atol =
     1e-4 (SHORT_TOL), equal -inf masks of logp1; ``nsteps <= 256``: the
     distributions of the energy error |dH| agree (two-sample
     Kolmogorov-Smirnov distance below KS_TOL = 0.01, -inf shares within
     1e-3). Long trajectories on the banana's stiff flank are chaotic, so
     pointwise agreement holds only while kernel and plain version round
     identically (the kernels are built with --fmad=false for that); the run
     logs the pointwise error and the lanes that differ at all.
   * The fused ChEES step (``chees_step``, the same kernel with the step's
     per-chain prologue and epilogue) against ``chees_step_plain`` at
     ``max_steps`` 32 and 256: at 32, x1, q0, z1 and r1 within SHORT_TOL,
     qxy and alpha within HMC_QXY_TOL with equal -inf masks; at 256, the
     energy-error KS check above. Then a ragged batch (8 x 16284 chains, not
     a whole number of 256-chain blocks) for both entries, pointwise.
   * HMC trajectories at the path's settings (eps 0.08, nsteps in [2, 50))
     and at eps 5.0, where about half the lanes leave the prior box (qxy
     -inf): q1 within 1e-4, qxy within 1e-3 (HMC_QXY_TOL), equal -inf masks.
   * The fused HMC step (``hmc_step``: whitening, momenta and length drawn
     in the kernel from a Philox key, trajectory, back-mapping) against
     ``hmc_step_plain`` under the same key: at eps 0.08 and 5.0, with 2% of
     starts outside the prior box (their trajectories run their whole
     length), on ragged batches (8 x 16284 and 8 x 16283 chains: the last
     256-chain block of each rung part full) and with nmax = nmin + 1:
     x1 within SHORT_TOL, qxy within HMC_QXY_TOL, equal -inf masks. The
     kernel's draws (``hmc_kernel_draws``) against ``hmc_draws``: nsteps
     equal in every lane, p0 within DRAW_ULP_TOL ulp; and the step's end
     points equal, bit for bit, the trajectory entry's from those draws. The
     run logs the lanes that differ at all and the draws' largest ulp.
   * NUTS trees, the kernel drawing its reservoir uniforms from a Philox key
     against the plain version fed ``nuts_uniforms(key)``, with about 2% of
     lanes at eps <= 0 so the in-kernel step-size search runs, at depth 4 and
     10: the step sizes used equal in every lane (the search against the
     plain ``find_reasonable_epsilon``), q_prop, logp_prop and alpha within
     1e-4, logp0, nalpha and alive equal in every lane. A wrong reservoir
     uniform changes the leaf some lane takes, and so its q_prop and
     logp_prop. The run logs the lanes that differ in any output at all, the
     pointwise error, the KS distance of logp_prop and the tree sizes.
   * The wide ChEES entries (``chees_step`` and ``chees_trajectories`` on
     bench.py's 40-, 50- and 200-D models: functors interval_gaussian,
     hierarchical_gaussian, correlated_gaussian) against their plain
     versions at 8 x 16384 chains (8 x 1024 at 200-D), on synthetic inputs
     around each posterior (1 in 17 of the 200-D model's starts outside its
     box): with a dense factor, at ``max_steps`` 32 no lane may differ in
     any bit; at 256, on a ragged batch and on short trajectories (4 steps
     of 1e-4, which keep the 200-D chains inside the box, so their values
     are compared too) every output within SHORT_TOL with equal -inf masks;
     with a diagonal factor (structure tag "diagonal": the kernels then
     skip its zeros, and so do the plain versions) and a lower triangular
     one (tag "dense"), at ``max_steps`` 32 on the full and a ragged batch
     no lane may differ in any bit. The trajectory entry, from the fused step's own
     q0 and lengths, must end where the step does.
   * The wide NUTS and HMC entries on the same three functors, the kernels
     at 8 x 16384 chains, the plain versions on the first and the last 512
     chains a rung (WIDE_PLAIN_COLUMNS_NUTS): no lane may differ in any bit,
     with a dense, a diagonal and a lower triangular factor (the latter
     two: NUTS at depth 4, HMC at eps 0.08 and ragged). NUTS at depth 4 and 10 with
     about 2% of lanes at eps <= 0 (the
     in-kernel step-size search); the fused HMC step at eps 0.08, 5.0 and
     1e-4, on a ragged batch and with nmax = nmin + 1, against
     ``hmc_step_plain`` fed the kernel's own draws, whose lengths must equal
     ``hmc_draws``' and momenta lie within DRAW_ULP_TOL ulp; the trajectory
     entry against its plain version, and the step's end points against the
     trajectory entry's from those draws.
   * The user functors (``ops/user.py register_functor``): two models
     defined here as a user writes them, ``UserHierarchy`` (the 50-D
     hierarchy, its device function in WideHierarchicalGaussian's operation
     order) and ``UserRefGaussian`` (the reference's test_nuts.py target,
     10-D, no constants), whose libraries build with the others. Every
     entry (both ChEES entries, NUTS at depth 4 and 10, the fused HMC step,
     its draws and its trajectory entry) against its plain version on the
     wide checks' draws at 8 x 16384 chains, with a dense and a diagonal
     factor: no lane may differ in any bit; ``UserHierarchy``'s outputs
     must equal the built-in hierarchical_gaussian entries' bit for bit,
     and each entry is timed against the built-in one (the per-chain
     adapter's cost).
3. Graphs: ``run_block`` replays CUDA graphs of the step on the card (one
   a combination of the step's host-side decisions, ``kernel.step_key``).
   For path 1 and path 2, on the curved model and on the 50-D hierarchy, at
   8 x 16384 chains: GRAPHS_ITERS iterations of the eager ``step`` loop and
   of ``run_block`` from the same seed and kinds, crossing swaps, the end of
   adaptation and DE's wait and factor refreshes (burn and cov_update cut
   to GRAPHS_BURN and GRAPHS_COV_UPDATE, listed as cuts). Every state
   tensor, the host fields and both generators' states must be equal bit
   for bit, and each kernel must launch once per iteration of its kind in
   both, counted through the graphs (a wrapper counts a call when it
   launches; under capture that call records the launch, which each replay
   makes: the launches are the calls, less those under capture, plus each
   graph's recorded calls times its replays). One ``"phase": "graphs"``
   line each, with both timings and the graphs' counts.
   Main path 1 at full width: the bench's headline configuration (8 x 16384
   chains, SCAM/AM/DE/ChEES at 10/10/10/20, tskip=5, cov_update=1000,
   de_size=2000, hmc_stepsize=0.08, 3000 burn-in + 12000 timed iterations
   in blocks of 1000) through ``build_step``/``run_block``'s graphs. The
   fused ChEES step must launch once per ChEES iteration, counted through
   the graphs, and the trajectory entry not at all; at least
   MIN_REPLAYED_SHARE of the timed iterations must replay a graph; the
   bench's moment gate must pass on every 8th cold chain (2048 of 16384).
   Then the eager loop the graphs replaced (``step`` after ``step`` and a
   row each iteration) on the final state: its iterations/s, and both
   under the profiler. Prints one JSON line, with the path's peak device
   memory, the eager loop's (a block of it before any graph exists), the
   graphs' counts and both profiles.
4. Profiles of path 1 (two JSON lines from the main path: 100 iterations
   of the graphs and of the eager loop under ``torch.profiler``, with the
   device-busy share, the device operations an iteration and the largest
   device times); then 100 ChEES iterations alone, replayed
   (``run_block`` with the kinds given, with its row copies), for the
   device operations of a ChEES iteration.
5. Main path 2 at full width: the bench's ``grad_mode=nuts`` cycle
   (bench.py:163-199: SCAM/AM/DE/NUTS/HMC at 10 each, nuts_max_depth=10,
   hmc_stepsize=0.08, hmc_nmaxsteps=50, the same cadences and lengths). The
   NUTS kernel and the fused HMC step must launch once per NUTS and HMC
   iteration, counted through the graphs, and the HMC trajectory entry not
   at all; the moment gate must pass. Prints one JSON line and its
   profiles (as 3 and 4), and a profile of 100 HMC iterations alone,
   replayed, for the device operations of one.
6. Sampler, the user's entry point at full width: ``PTSampler`` with the
   bound methods of ``CurvedLikelihood`` (the kernel route) on path 1's
   workload as a user writes it (8 x 16384 chains, SCAM/AM/DE/ChEES at
   10/10/10/20, 15000 iterations, burn 1500, thin 10, isave 1000), writing
   its chain files and a checkpoint after every block into a temporary
   directory. ``chees_step`` must launch once per ChEES iteration and the
   trajectory entry not at all; the moment gate must pass on every 8th
   cold chain of ``sampler.chains`` past iteration 3000; ``chain_1.0.txt``
   must have 1501 rows of 6 columns, ``chain_all_1.0.bin`` 1501 x 16384 x 2
   float32, ``jumps.txt`` the four jumps and the checkpoint meta iteration
   15000. Then ``resume=True`` on the same directory to 20000 iterations:
   it must resume from the checkpoint at 15000, reach 2001 rows and 20
   lines of each ``<name>_jump.txt``, launch ``chees_step`` once per ChEES
   iteration and end finite. Then the plain route, torch lambdas of the
   same model: with all four callables (gradients included) the
   constructor must refuse the card, naming ``device="cpu"``, since on the
   card a kernel wrapper launches its kernel or raises; with ``logl`` and
   ``logp`` alone, at 8 x 1024 chains, 2000 iterations, the gradient
   weights given and dropped, the route must be plain, only SCAM/AM/DE may
   run, and no kernel may launch (the gate's max z is logged). Each drain
   and checkpoint is timed on the host after the device queue has drained.
   ``sample()`` runs the overlapped loop (block k+1 dispatched before block
   k is drained, from host copies taken behind block k); each drain and
   checkpoint is timed on the host, and whether the card was still running
   the next block when it ended is counted (``drains_hidden``). Then the
   serial loop (reached with a neff too large to stop the run) against the
   overlapped one, SERIAL_ITERS iterations each from one seed: every file
   must hold the same bytes (the checkpoint by its arrays); each loop's
   wall, drains and checkpoints, and the serial loop's neff checks.
   Prints one JSON line: iterations/s of ``sample()``'s wall (drains
   included) beside path 1's ``run_block`` iterations/s, drain ms a block
   and the drains' share of the wall, checkpoint ms a drain, ESS/s over
   that wall, the gate, launches (through the graphs), the graphs' counts,
   peak device memory, and the serial-against-overlapped numbers.
7. Path 1's cycle on bench.py's wide workloads at 8 x 16384 chains, each
   with bench.py's settings (x0 of bench.py:126-142, the block capped so
   a block's history ``[block, T, D, C]`` stays near 1.5 GB: 71, 57 and 50
   iterations; WIDE_ITERS burn-in and timed iterations; the ESS
   and the gate on every 8th, 10th or more cold chain, kept on the card):
   ``gaussian`` (IntervalTransformedGaussian, 40-D), ``hierarchical``
   (HierarchicalGaussian, 50-D) and ``gaussian200`` (CorrelatedGaussian,
   200-D, seed 1). ``chees_step`` must launch once per ChEES iteration
   (through the graphs) and the trajectory entry never; the moment gate
   must pass on the first two, and gaussian200 (no target: its box
   truncates it) must end finite, its split R-hat logged. The eager loop
   against the graphs as in 3 (100 iterations on hierarchical, 20 on the
   others), then ChEES iterations alone, replayed, under the profiler (a
   profile line each) for the device ms of one, and the wide kernel's
   timings on the final state. One JSON line a workload, with any cut of
   its timed iterations.
8. Path 2's cycle (bench.py's ``grad_mode=nuts``: SCAM/AM/DE/NUTS/HMC at
   10 each, nuts_max_depth=10, hmc_stepsize=0.08, hmc_nmaxsteps=50) on the
   same three wide workloads at 8 x 16384 chains, bench.py's x0, block cap
   and ESS stride, WIDE_NUTS_ITERS iterations (cut from bench.py's 3000 +
   12000 to fit the limit; the cuts are in each JSON line). The NUTS kernel
   and ``hmc_step`` must launch once per NUTS and HMC iteration, the HMC
   trajectory entry never; the gate must pass at 40-D and 50-D, gaussian200
   must end finite, its split R-hat logged. Then the trees of one more NUTS
   call at the final state (sizes, depth-cap share, the group lane
   efficiency: leaves run over the group's size times its largest tree),
   a profile of NUTS iterations alone, and the wide NUTS and HMC kernels'
   timings. One JSON line a workload, with the adapted step sizes and the
   acceptance of each jump.
9. ``PTSampler`` with ``HierarchicalGaussian``'s bound methods on the card:
   8 x 1024 chains, SCAM/AM/DE/ChEES/NUTS/HMC, 2000 iterations, files in a
   temporary directory; ``chees_step``, ``nuts_trees`` and ``hmc_step``
   each once per iteration of their kind, every jump run, the chain files'
   rows, ``jumps.txt`` and the jump series, the gate on the rows past
   iteration 1000. Then a 1025-D ``CorrelatedGaussian``
   (beyond the wide layout's 1024) must be refused when ``sample()``
   starts, naming ``device="cpu"``. One JSON line.
9a. The user paths: path 1's and path 2's cycles (as 7 and 8) on
   ``UserHierarchy`` (bench.py's hierarchical workload through the user
   functor) and on ``UserRefGaussian``, at 8 x 16384 chains, cut to
   USER_ITERS and USER_NUTS_ITERS (the cuts in each JSON line): launches
   once per iteration of their kind, the moment gate, iterations/s and
   ESS/s, and the user entries' timings on the final states.
9b. ``PTSampler`` with the user models' bound methods on the card: the
   route line must name ``user_hierarchy``; UserHierarchy as in 9, whose
   chain files are compared byte for byte with the built-in model's from
   the same seed (the result printed); the reference's test_nuts.py
   scenario with UserRefGaussian (SCAM/AM/DE/NUTS/HMC, HMCsteps 20,
   HMCstepsize 0.2, 8 x 1024): launches and the gate against N(0, I); a
   100-D UserRefGaussian, beyond its functor's dims (2, 64), and a 1025-D
   UserHierarchy, beyond its dims (2, 1024) and the layout's, refused when
   ``sample()`` starts, naming ``device="cpu"``. One JSON line
   ``"phase": "user_sampler"``.
9c. Past D = 256 (groups of 8 chains to 512-D, of 4 to 1024-D, two tile
   stages past 788-D): every wide entry (``chees_step``,
   ``chees_trajectories``, ``nuts_trees`` at depth 4, ``hmc_step``, its
   draws, ``hmc_trajectories``) against its plain version, the kernels at T
   x C chains with the identity and a dense factor and at T x (C - 100)
   with the identity, the plain versions on ``wide_columns`` (LARGE_CHECK),
   no lane differing in any bit, for the hierarchy at 270, 512, 513 and
   1024-D,
   the correlated Gaussian at 300-D, and UserHierarchy at 270 and 1024-D
   (also equal to the built-in entries):
   one ``"phase": "large_vs_plain"`` line each. Then paths 1 and 2 (as 7
   and 8) on bench.py's hierarchy with 269 and 1023 groups
   (``hierarchical270``, the whole-array pulsar-timing class, and
   ``hierarchical1024``) at 8 x 16384 chains, cut to LARGE_ITERS and
   LARGE_NUTS_ITERS (the cuts in each line): launches once per iteration
   of their kind, finite states, the gate (it must pass at 270-D; at
   1024-D it is printed), and their kernel items; then 9 on the 270-D
   hierarchy (``"phase": "wide_sampler"``, ``"workload":
   "hierarchical270"``).
9d. BASELINE config 4 (examples/hierarchical_gaussian.py: SCAM/AM/DE at
   20 each, DE after burn-in, a torch-native small-Gaussian custom jump at
   5, the prior draw at 2) plus ChEES at 20 and an auxiliary jump
   (``HierarchyReflection``, which reads ``it``), on bench.py's 50-D
   hierarchy at 8 x 16384 chains, tskip 5, cov_update 1000 (CUSTOM_ITERS:
   3000 + 12000) through ``build_step``/``run_block``: first the graphs
   against the eager step loop as in 3 (bit for bit, ``"phase":
   "graphs"``, ``"path": "custom_jumps"``), then the path as in 7 with the
   gate, ``chees_step`` once per ChEES iteration and no eager iteration
   but the warm-ups (the user's jumps run inside the graphs). One line
   ``"phase": "custom_jumps"`` with each jump's proposals and acceptances,
   the prior draw's acceptance rate, the graphs' counts and eager
   iterations by reason, and peak device memory.
9e. The same cycle through ``PTSampler`` (the jumps registered with
   ``addProposalToCycle``, ``addPriorDrawToCycle``, ``addAuxilaryJump``)
   as in 9, its checks with config 4's weights: launches, protocols, no
   "host jump" iteration, ``jumps.txt`` and the jump series, the gate; then the
   reference protocol's numpy custom jump and numpy prior draw at 8 x 128
   chains, 300 iterations: exactly their own iterations run eagerly
   ("host jump"), the other keys replay. One line ``"phase":
   "custom_sampler"``.
9f. BASELINE config 5 on one card (DEO swaps, the adaptive ladder): path
   1's cycle on bench.py's 50-D hierarchy on LADDER_T x LADDER_C = 64 x
   2048 chains (path 1's 131072), the default geometric ladder, DEO swaps
   and the adaptive ladder at PTSampler's defaults over the first half of
   the burn-in. First the graphs check of 3 on it (``"path":
   "tall_ladder"``, the ladder's burn at LADDER_GRAPHS_BURN of the 300
   iterations): bit for bit, and both DEO parities, with and without the
   ladder's update, captured. Then the path as 7 at LADDER_ITERS (3000 +
   12000, bench.py's block cap and ESS stride): the gate on the cold
   chains, ``chees_step`` once per ChEES iteration, no eager iteration but
   the warm-ups; the ladder must move in its burn, stay strictly
   descending, keep both ends and not move after its burn; each pair's
   acceptance over the burn-in and over the timed iterations, the betas
   before and after. Then the same with the hottest-first sweep, cut to
   1000 + 3000 (``"path": "tall_ladder_sweep"``, its cut listed), with what
   the 63-pair sweep adds to a swap event beside DEO.
9g. The DE pair laws (``"phase": "de_pairs"``): "iid" on path 1's curved
   workload at 8 x 16384 and "rolled" on the 50-D hierarchy (not on the
   curved target: it synchronises mode jumps there), each at 3000 + 12000
   through the graphs as 3 and 7, the gate enforced, DE's cold acceptance
   beside the blocked law's from path 1's line on the same workload.
9h. ``PTSampler`` on the 50-D hierarchy at 64 x 256 with ``swap_mode=
   "deo"`` and ``sample(adaptLadder=True, hotChain=True)``: 2000
   iterations, a resume to 3000 and an unbroken run of 3000 from the same
   seed. The checkpoint's betas are the first run's, the ladder moves
   before and after the resume (it adapts to iteration 2500) and keeps its
   cold end and the beta = 0 hot chain, the resumed run's betas and files
   equal the unbroken run's byte for byte, ``chees_step`` once per ChEES
   iteration in each run; the gate past iteration 1000 is printed. One
   line ``"phase": "ladder_sampler"``.
9i. ``jump_select="per_chain"`` (``phase_per_chain``), each chain its own
   kind every iteration: the graphs checks (run_block against the eager
   step loop over PER_CHAIN_GRAPHS_ITERS iterations that cross DE's
   activation, bit for bit, every kernel once an iteration) for the
   rotation on both paths' cycles on the 50-D hierarchy at T x C and the
   stacked mode on path 2's at T x STACKED_C; both paths at T x C under
   the rotation (PER_CHAIN_ITERS, cut from bench.py's 3000 + 12000): each
   jump's proposals equal to its slices' counts x T x the phases'
   iterations, exactly, each kernel launched once an iteration on its
   slice (a ragged one: 3277 or 6554 chains a rung, no whole group),
   counted through the graphs, the moment gate, the profile; then
   ``PTSampler(jump_select="per_chain")`` at T x WIDE_SAMPLER_C. Lines
   ``"phase": "per_chain"``.
9j. The NUTS kernel's general entry (``phase_nuts_general``): against its
   plain version on T x (C - 1) chains (the plain version on
   GENERAL_PLAIN_COLUMNS chains a rung) for the curved model, the 50-D
   hierarchy and its user functor, at depth GENERAL_DEPTH with every tree
   run to the cap and with each forced length of GENERAL_TRAJLENS, the
   captured lane's buffers too: no lane, no buffer may differ in any bit;
   at depth 6 the general entry equals the default one. The default
   entries' ptxas lines must equal BASE_NUTS_PTXAS. Then path 2
   on the curved target at depth GENERAL_DEPTH with
   ``nuts_force_trajlen=GENERAL_PATH_TRAJLEN`` (every NUTS call through the
   general entry; the trees that leave no box run forced_leaves' 1501), its
   gate and share of trees past 1023 leaves printed, and the
   general entry's ms a call on the path's final state: the NUTS item's
   ``general`` entry of the kernels line.
9k. ``trajectory_sampler``: ``PTSampler`` on the 50-D hierarchy at T x
   WIDE_SAMPLER_C, path 2's cycle, WIDE_SAMPLER_ITERS iterations, with
   ``trajectoryDir`` and ``write_burnin``: three files for each emitted row
   that ran NUTS, every NUTS launch through the general entry; the same
   seeded run without it (the default entry) leaves every file equal.
9l. The sharded phase (``phase_sharded``, ROADMAP A12 and A12b): two
   ranks of this script (``--sharded-worker``) share cuda:0 over ``gloo``,
   each its block; every case against one process of the same seed, every
   element of the final state and every file and checkpoint array equal.
   ``run_block`` eagerly: path 1 on 2 x 1 and path 2 on 1 x 2 on the curved
   target at T x C; on the 50-D hierarchy at T x SHARDED_USER_C with the
   chains split, path 1's and path 2's cycles under ``per_chain``'s rotation
   and BASELINE config 4's cycle with the user's torch-native jumps (each
   line: the ranks' parts of the rotation slices by runs, the kernels'
   launches by rank, the user's callables timed over every point and over
   the block). Then ``PTSampler`` at T x WIDE_SAMPLER_C with the wide
   sampler's cycle and with config 4's, each 1000 iterations resumed to
   1500 (``"phase": "sharded_sampler"``, ``"sharded_config4_sampler"``).
9m. The chain files' native row formatter (``"phase": "chainio"``, after
   the wide sampler): built with the host compiler, byte for byte against
   its plain version on CHAINIO_SPECIAL in every column kind and on one
   drain's rows of the 50-D sampler. The sampler lines of 6 and 9 carry
   ``drain_parts``: each part of a drain and a checkpoint in ms a drain and
   as a share of ``sample()``'s wall (``PTSampler.io_seconds``), and one
   drain's rows formatted natively and by the plain version.
10. Kernels line: each kernel's launches on its path, error against the
   plain version, device time (CUDA events, stream held, inputs from its
   path's final state), the time of a wrapper call, the plain version's time
   and the bound. The ChEES entry adds the fused step's times and bound,
   the lane efficiency of the path's lengths with chain n on thread n and
   grouped by length as the kernel runs them, and capped timings: every
   chain at the largest length, over the whole batch and over one warp
   alone. The NUTS entry adds the time of a NUTS call's draws, the
   time over the deepest tree's leaves, and capped timings: every tree run
   to the depth cap (a tiny step size), over the whole batch and over one
   warp alone, for the per-leaf throughput and the lone per-leaf latency.
   The HMC entry adds the fused step's times and bound, the time of its
   draws alone (the test entry ``hmc_draws_curved``), its launches by
   entry, its layout (one chain a thread, 256 threads a block) and ptxas
   registers, spills and stack frames, the steps its draws take (the break test ends most
   trajectories after one), and full-length timings: every chain started
   outside the prior box so it runs its drawn length, over the whole batch
   and over one warp's chains, in microseconds a step. The ChEES entry's
   ``launches_by_path`` adds its launches in the sampler phase (and the
   hierarchical item's, in 9d to 9h: ``custom_jumps``,
   ``custom_sampler``, ``tall_ladder``, ``tall_ladder_sweep``,
   ``de_rolled``, ``ladder_sampler``; the curved entry's ``de_iid``). Its
   ``wide`` list has one item a wide functor, with every key of a kernel
   entry: the path's factor structure tag (``factor_structure``; the
   identity's "diagonal" on bench.py's paths), the capped microseconds a
   step and their operation rate as a share of the ordered-f32 rate
   (ORDERED_F32_OPS_PER_S), the wide entries'
   times (trajectory entry, fused step, wrapper
   calls, the plain versions), their bounds (the two whitening products at
   the operations the nonzero entries of the path's factor need: D^2 for a
   triangular factor, D for the identity that bench.py's paths keep; the
   model's a leapfrog step; 6 D + 5 floats a chain moved by the step),
   one step's two whitening products as ``torch.matmul`` as ``library_ms``,
   launches by path, lane efficiency in the layout's groups, capped timings
   (every chain at the largest length: the batch, one group alone), ptxas
   registers, spills and shared memory, and the layout (chains a group and
   a block, blocks an SM, waves). The NUTS and HMC entries' ``wide`` lists
   have one item a wide functor with the same keys (the NUTS items the
   capped microseconds a leaf and their share of the ordered-f32 rate):
   the wide NUTS kernel's
   time on path 2's final state, its wrapper call, the plain version's on
   the first 1024 chains a rung, the bound (this call's leaves and
   doublings: an evaluation, the leapfrog, the kinetic energy and one U-turn
   check a leaf), the whitening products as ``library_ms``, tree sizes,
   group lane efficiency, capped timings (every tree at the depth cap, the
   batch and one group), the scratch layout and bytes, ptxas and layout;
   the wide HMC entries' trajectory and fused-step times, plain times,
   bounds, draws, the steps taken, ptxas and layout. Before it, a line of
   what is counted from the code and not measured: the ``__syncthreads``
   a wide ChEES leapfrog step and a wide evaluation take, by functor,
   dimension and structure tag. The user functors' entries are items of
   the same ``wide`` lists (workloads ``user_hierarchical`` and
   ``user_ref_gaussian``), their source the kernel's header that the
   generated unit instantiates, with their timings against the built-in
   entries (``against_builtin``) and the seconds of the parallel build.
11. Last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHORT_TOL = 1e-4
KS_TOL = 0.01
NEGINF_SHARE_TOL = 1e-3
HMC_QXY_TOL = 1e-3
# The kernel's momenta against hmc_draws': logf, sinf and cosf round apart
# between CUDA's and PyTorch's math libraries by up to 2 ulp each.
DRAW_ULP_TOL = 4

T, C, D = 8, 16384, 2
BURN_ITERS, TIMED_ITERS, BLOCK = 3000, 12000, 1000
GATE_STRIDE = 8  # moment gate on cold chains 0, 8, 16, ...: 2048 of 16384
PROFILE_ITERS = 100
# The profile lines' numbers each main path line repeats, graphs and eager.
PROFILE_KEYS = ("wall_ms_per_iter", "device_ms_per_iter", "device_busy_share",
                "device_ops_per_iter")
# The least share of a main path's timed iterations that must replay a
# CUDA graph (the rest: a key's first iterations, eager warm-up and capture).
MIN_REPLAYED_SHARE = 0.99
NUTS_DEPTH, HMC_EPS, HMC_NMIN, HMC_NMAX = 10, 0.08, 2, 50
DEVICE = "cuda:0"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s.
# Integer operations are counted at the f32 rate too (the data sheet gives
# no non-tensor integer rate; the H100 has half as many INT32 lanes as f32
# ones), so the bound stays a lower bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The bounds count at F32_OPS_PER_S, the rate of fused multiply-adds. The
# kernels are built --fmad=false (each product and sum rounded on its own, as
# the plain versions), so a multiply and an add are two instructions: their
# ordered f32 arithmetic tops out at half of it.
ORDERED_F32_OPS_PER_S = F32_OPS_PER_S / 2
# Per leapfrog step of the curved model (csrc/models.cuh): about 70 float
# operations plus 4 transcendental ones, counted as one each.
OPS_PER_STEP = 74
# Per chain of the fused ChEES step besides its trajectory: step size and
# length (6), q0 = chol_inv^T x and x1 = chol^T z1 (6 each), k0 and k1 (4
# each), dH, qxy and alpha (6).
OPS_PER_CHEES_CHAIN = 32
# Per chain of the fused HMC step besides its evaluations: q0 = chol_inv^T x
# and x1 = chol^T q1 (6 each), the two kinetic energies (2 each), one
# Philox4x32-10 call (80 integer operations, as for a NUTS leaf), Box-Muller
# and the length (about 25).
OPS_PER_HMC_CHAIN = 12 + 4 + 80 + 25
# A start outside the prior box (|y| < 10 fails) where the curved target's
# gradient stays moderate, so a whole trajectory from it stays finite.
OUTSIDE_Y = 10.5
# Per NUTS leaf: its leapfrog step, the joint and the slice tests (6), the
# reservoir test (3), the acceptance statistic (4), on average one U-turn
# check against a checkpoint (two D-dots and the difference: 12), and the
# leaf's Philox4x32-10 uniform (10 rounds of two 32 x 32 -> 64-bit
# multiplies, counted as two operations each, two 3-way XORs and two key
# additions; the shift and conversion: 80 integer operations).
OPS_PER_LEAF = OPS_PER_STEP + 25 + 80
# Per NUTS doubling: the whole-trajectory U-turn check and the accept.
OPS_PER_LEVEL = 10
# The capped NUTS timing: a step size small enough that (nearly) every tree
# runs to the depth cap, and the least share of cap-cut trees it must give.
CAPPED_EPS = 1e-5
CAPPED_ALIVE_MIN = 0.99
# The sampler phase: path 1's workload through PTSampler.sample, as a user
# writes it (thin 10, the reference's default, keeps the temperature-1
# sidecar at 1501 x 16384 x 2 x 4 B), then a resume, then the plain route.
SAMPLER_ITERS, SAMPLER_RESUME_ITERS, SAMPLER_GATE_FROM = 15000, 20000, 3000
SAMPLER_KW = dict(burn=1500, Tskip=5, isave=1000, covUpdate=1000, thin=10, SCAMweight=10,
                  AMweight=10, DEweight=10, CHEESweight=20, NUTSweight=0, HMCweight=0,
                  MALAweight=0, HMCstepsize=0.08)
# The plain route runs without gradients: the ChEES and HMC weights are
# given, as a user may, and dropped.
PLAIN_C, PLAIN_ITERS = 1024, 2000
# The serial loop against the overlapped one: this many iterations of the
# sampler phase's workload each, the serial loop reached with a neff too
# large to stop the run (its check, a cross-chain ESS over every cold chain
# each block past 2 burn, is timed and listed apart).
SERIAL_ITERS = 3000  # cut from 6000 for the sharded per_chain and config-4 cases (PR 17)
PLAIN_KW = dict(burn=500, Tskip=5, isave=500, covUpdate=500, thin=10, SCAMweight=10,
                AMweight=10, DEweight=10, CHEESweight=10, HMCweight=10, NUTSweight=0,
                MALAweight=0, HMCstepsize=HMC_EPS, HMCsteps=HMC_NMAX)

# bench.py's three other workloads (bench.py:126-142), run through path 1's
# cycle at 8 x 16384 chains: name -> (burn-in, timed) iterations. bench.py
# runs 3000 and 12000; a smaller number is a cut to fit the script's time
# limit, listed in the workload's JSON line. gaussian200's ChEES step size
# collapses during burn-in (its trajectories leave the box whatever the
# step size), and its trajectories lengthen toward the 256-step cap: after
# 500 burn-in iterations a ChEES iteration takes about 0.13 s on an H100,
# after bench.py's 3000 about 0.46 s, and those 3000 alone take about 560 s
# (tools/torch_wide_workload.py), more than this script's limit leaves
# beside its other phases. So its burn-in is cut as well as its timed
# iterations.
# Cut: the 40-D and 50-D timed iterations to 6000 and gaussian200 to
# 250 + 250, to make room for the per-chain, general-entry and trajectory
# phases; the 40-D and 50-D ones to 4000 for the sharded phase, and to
# 2000 + 3000 for the sharded per_chain and config-4 cases (PR 17).
WIDE_ITERS = {"gaussian": (2000, 3000), "hierarchical": (2000, 3000),
              "gaussian200": (250, 250)}
# The wide kernel-vs-plain checks run the kernels at the main path's 8 x
# 16384 chains and the plain version on the same batch, but for gaussian200
# at 256 steps, where the plain version (its ordered sums are D launches a
# product) runs on this many chains a rung: the first and the last half of
# them, so both waves of blocks and the last block are checked. A chain's
# arithmetic is its own, so the kernel's outputs on those columns must
# equal the plain version's on the same columns.
WIDE_PLAIN_COLUMNS = {"gaussian200": 1024}
# Base step size of the wide checks' rungs (rung t at WIDE_EPS * 1.3**t),
# in coordinates whitened by a factor near the posterior covariance.
WIDE_EPS = 0.05
# Per evaluation of a wide functor besides the two whitening products
# (``product_ops`` each), counted from csrc/models.cuh: the correlated model's
# S (x - mu) and its elementwise terms, the interval model's sigmoid, exp
# and gradient terms (three transcendentals a dimension, counted as one
# each) and its value, the hierarchy's residuals and sums.
WIDE_MODEL_OPS = {
    "correlated_gaussian": lambda d: 2 * d * d + 5 * d,
    "interval_gaussian": lambda d: 25 * d,
    "hierarchical_gaussian": lambda d: 10 * d,
    # The user functors, counted from their sources (one thread a chain
    # evaluates value and gradient): the hierarchy's 13 a dimension past the
    # first and 11 more; the Gaussian's 7 a dimension and 7 more.
    "user_hierarchy": lambda d: 13 * (d - 1) + 11,
    "user_ref_gaussian": lambda d: 7 * d + 7,
}
# Path 2's cycle (bench.py's grad_mode=nuts) on the same three workloads:
# name -> (burn-in, timed) iterations. bench.py runs 3000 and 12000; a
# smaller number is a cut to fit the script's limit, listed in the
# workload's JSON line (tools/torch_wide_workload.py --path nuts runs any
# counts). On an H100 path 2 ran about 309, 115 and 28 iterations/s at 40-,
# 50- and 200-D after 3000, 1500 and 500 burn-in iterations (PERF.md §5), so
# bench.py's counts take about 50 s at 40-D and would take about 130 and
# 460 s at 50-D and 200-D.
# Cut to 1500 + 3000 at 40-D, 1000 + 2000 at 50-D and 150 +
# 150 at 200-D for the same reason; for the sharded per_chain and config-4
# cases (PR 17) to 1000 + 2000, 600 + 1200 and 100 + 100.
WIDE_NUTS_ITERS = {"gaussian": (1000, 2000), "hierarchical": (600, 1200),
                   "gaussian200": (100, 100)}
# The wide NUTS and HMC checks run the plain version on this many chains a
# rung (the first and the last half of them), the kernels on all of them.
WIDE_PLAIN_COLUMNS_NUTS = 1024
# The wide NUTS check's step-size base for the correlated model (its starts
# are clamped to within 0.05 of its box's faces), and the capped timing's
# step size for the wide models: 1023 leaves of it stay inside the box from
# bench.py's start.
WIDE_TREE_EPS_BOX = 1e-3
WIDE_CAPPED_EPS = 1e-6
# The user paths: path 1's and path 2's cycles on the user models at T x C
# chains through build_step/run_block, name -> (burn-in, timed) iterations,
# cut from bench.py's 3000 + 12000 to fit the script's limit (the cuts are
# listed in each JSON line). user_hierarchical is bench.py's hierarchical
# workload through the registered functor; user_ref_gaussian the 10-D
# Gaussian, run for its entries' launches and timings on a path.
# Cut: user_hierarchical's timed iterations to 3000 (path 1) and its
# path 2 to 500 + 1000; for the sharded per_chain and config-4 cases (PR
# 17) to 1000 + 2000 and 300 + 600.
USER_ITERS = {"user_hierarchical": (1000, 2000), "user_ref_gaussian": (500, 1000)}
USER_NUTS_ITERS = {"user_hierarchical": (300, 600), "user_ref_gaussian": (500, 1000)}
# The user sampler phase's reference scenario (the reference's test_nuts.py
# cycle through PTSampler, its HMC settings), at 8 x 1024 chains.
USER_REF_ITERS = 2000
USER_REF_KW = dict(burn=500, Tskip=5, isave=500, covUpdate=500, thin=10, SCAMweight=10,
                   AMweight=10, DEweight=10, CHEESweight=0, NUTSweight=10, HMCweight=10,
                   MALAweight=0, HMCstepsize=0.2, HMCsteps=20)
# The wide sampler phase: HierarchicalGaussian's bound methods through
# PTSampler on the card, 8 x 1024 chains, SCAM/AM/DE/ChEES/NUTS/HMC.
WIDE_SAMPLER_C, WIDE_SAMPLER_ITERS = 1024, 2000
WIDE_SAMPLER_KW = dict(burn=500, Tskip=5, isave=500, covUpdate=500, thin=10, SCAMweight=10,
                       AMweight=10, DEweight=10, CHEESweight=20, NUTSweight=10, HMCweight=10,
                       MALAweight=0, HMCstepsize=HMC_EPS, HMCsteps=HMC_NMAX)


# ---- User models: a model the package does not know, as a user brings it ----

# UserHierarchy's device function (ops/user.py register_functor): the 50-D
# hierarchy's tempered value and gradient of one chain, in the operation
# order of WideHierarchicalGaussian::eval (csrc/models.cuh), so that its
# entries equal the built-in hierarchical_gaussian entries bit for bit.
# prm: 1/s_mu, 1/s_t, 1/s_y, y [D - 1].
USER_HIERARCHY_SOURCE = r"""
__device__ static float value_grad(const float* x, int stride, int D, float beta,
                                   const float* prm, float* g) {
  const float r_mu = prm[0], r_t = prm[1], r_y = prm[2];
  const float mu = x[0];
  const float m = mu * r_mu;
  float acc = 0.0f, sr = 0.0f, su = 0.0f;
  for (int d = 1; d < D; ++d) {
    const float th = x[d * stride];
    const float u = (th - mu) * r_t;
    const float wv = u * r_t;
    const float r = (prm[3 + d - 1] - th) * r_y;
    g[d * stride] = beta * (r * r_y) - wv;
    acc = d > 1 ? acc + wv : wv;
    sr = d > 1 ? sr + r * r : r * r;
    su = d > 1 ? su + u * u : u * u;
  }
  g[0] = -(m * r_mu) + acc;
  const float ll = -0.5f * sr;
  const float lp = -0.5f * (m * m) - 0.5f * su;
  return beta * ll + lp;
}
"""

# UserRefGaussian's device function: the reference's test_nuts.py target,
# -x.x/2 - D/2 log(2 pi) on the open box |x| < 10 (flat prior there), the
# sum over D ordered as its plain value_grad orders it. No constants.
USER_REF_GAUSSIAN_SOURCE = r"""
__device__ static float value_grad(const float* x, int stride, int D, float beta,
                                   const float* prm, float* g) {
  float ss = 0.0f;
  bool inside = true;
  for (int d = 0; d < D; ++d) {
    const float xd = x[d * stride];
    ss = d ? ss + xd * xd : xd * xd;
    inside = inside && fabsf(xd) < 10.0f;
    g[d * stride] = beta * (-xd);
  }
  const float ll = -0.5f * ss - (float)D * 0.9189385f;
  return beta * ll + (inside ? 0.0f : -INFINITY);
}
"""
# 0.5 log(2 pi) in f32, as the device source writes it.
HALF_LOG_2PI_F32 = np.float32(0.9189385)
# The dims each user functor is registered for: the hierarchy at any D the
# wide layout takes (to 1024); the Gaussian up to 64, so that a 100-D one is
# refused.
USER_DIMS = {"hierarchy": (2, 1024), "ref_gaussian": (2, 64)}


class UserHierarchy:
    """``models.HierarchicalGaussian`` as a user brings it to the kernels:
    its per-point methods, its batched plain versions and its constants are
    the built-in model's; its device functor is USER_HIERARCHY_SOURCE,
    registered as ``user_hierarchy``."""

    def __init__(self, **kw):
        from ptmcmcsampler_torch import register_functor
        from ptmcmcsampler_torch.models import HierarchicalGaussian

        self._m = HierarchicalGaussian(**kw)
        self.ndim = self._m.ndim
        self.cuda_functor = register_functor("hierarchy", USER_HIERARCHY_SOURCE,
                                             dims=USER_DIMS["hierarchy"])

    def lnlikefn(self, x):
        return self._m.lnlikefn(x)

    def lnpriorfn(self, x):
        return self._m.lnpriorfn(x)

    def lnlikefn_grad(self, x):
        return self._m.lnlikefn_grad(x)

    def lnpriorfn_grad(self, x):
        return self._m.lnpriorfn_grad(x)

    def lnlike(self, x):
        return self._m.lnlike(x)

    def lnprior(self, x):
        return self._m.lnprior(x)

    def value_grad(self, x, beta):
        return self._m.value_grad(x, beta)

    def cuda_params(self, device):
        return self._m.cuda_params(device)

    def cuda_params_len(self):
        return self._m.cuda_params_len()

    def posterior_moments(self):
        return self._m.posterior_moments()


class UserRefGaussian:
    """The reference's test_nuts.py model (``tests/test_gradient_jumps.py``
    ``TestReferenceNutsScenario``): ll = -x.x/2 - D/2 log(2 pi), a flat
    prior on the open box |x| < 10, 10-D by default. Its device functor is
    USER_REF_GAUSSIAN_SOURCE, registered as ``user_ref_gaussian``; it has
    no constants. ``value_grad`` is the kernels' plain version: the same
    operations in the same order (an ordered sum over D)."""

    def __init__(self, ndim=10):
        from ptmcmcsampler_torch import register_functor

        self.ndim = int(ndim)
        self._c0 = float(np.float32(self.ndim) * HALF_LOG_2PI_F32)
        self.cuda_functor = register_functor("ref_gaussian", USER_REF_GAUSSIAN_SOURCE,
                                             dims=USER_DIMS["ref_gaussian"])

    def lnlikefn(self, x):
        return -0.5 * torch.sum(x * x) - self._c0

    def lnpriorfn(self, x):
        return torch.where(torch.all(torch.abs(x) < 10.0), 0.0, float("-inf"))

    def lnlikefn_grad(self, x):
        return self.lnlikefn(x), -x

    def lnpriorfn_grad(self, x):
        return self.lnpriorfn(x), torch.zeros_like(x)

    def lnlike(self, x):
        """``x [..., D, C] -> [..., C]``."""
        return -0.5 * torch.sum(x * x, dim=-2) - self._c0

    def lnprior(self, x):
        inside = torch.all(torch.abs(x) < 10.0, dim=-2)
        return torch.where(inside, 0.0, float("-inf"))

    def value_grad(self, x, beta):
        """Tempered ``(beta*ll + lp, beta*grad ll)``, ``beta`` broadcasting
        against ``[..., C]``: the device function's operation order."""
        from ptmcmcsampler_torch.ops.common import rsum

        ll = -0.5 * rsum(x * x) - self._c0
        beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
        beta_d = beta.unsqueeze(-2) if beta.dim() else beta
        return beta * ll + self.lnprior(x), beta_d * (-x)

    def cuda_params(self, device):
        return torch.empty(0, dtype=torch.float32, device=device)

    def cuda_params_len(self):
        return 0

    def posterior_moments(self):
        return np.zeros(self.ndim), np.eye(self.ndim)


# ---- BASELINE config 4: the user's jumps (examples/hierarchical_gaussian.py) ----

def small_gauss_jump(rng, x, it, beta):
    """The example's custom jump, torch-native: a small isotropic Gaussian
    step drawn with the sampler's generator (symmetric: log_qxy 0)."""
    return x + 0.05 * torch.randn(x.shape, generator=rng, device=x.device), x.new_zeros(())


def numpy_small_gauss_jump(x, it, beta):
    """The same jump in the reference's numpy protocol (run on the host)."""
    return x + 0.05 * np.random.standard_normal(len(x)), 0.0


def numpy_draw_prior(model):
    """``draw(np_rng)``: the hierarchy's exact prior draw in numpy (host)."""
    def draw(np_rng):
        mu = model.s_mu * np_rng.standard_normal()
        return np.concatenate([[mu], mu + model.s_t * np_rng.standard_normal(model.ngroups)])
    return draw


class HierarchyReflection:
    """An auxiliary jump for ``HierarchicalGaussian`` that leaves the prior
    and every tempered target of the ladder unchanged: on odd iterations
    (it reads ``it``) it reflects the proposal's group effects across the
    hyperplane orthogonal to a unit vector v with v . 1 = v . y = 0, so it
    fixes mu, the prior's ``theta - mu 1`` norm, the data terms and every
    tempered mean. A reflection has |det| = 1: log_qxy = 0. Composed with
    the prior draw or the isotropic small Gaussian, whose laws it keeps,
    the proposal keeps its Hastings term exactly. SCAM and AM step on the
    adapted covariance, DE on differences of the chain history and ChEES on
    the adapted factor: these keep their Hastings terms only as far as those
    are symmetric under the reflection (as the target's covariance is), so
    the composed kernel is approximately reversible, and the moment gate
    holds the result."""

    def __init__(self, model, device):
        g = model.ngroups
        basis, _ = np.linalg.qr(np.stack([np.ones(g), model.y], axis=1))
        v = np.cos(1.3 * np.arange(g))  # any vector outside span(1, y)
        v = v - basis @ (basis.T @ v)
        v = np.concatenate([[0.0], v / np.linalg.norm(v)])
        self.v = torch.tensor(v, dtype=torch.float32, device=device)

    def __call__(self, rng, x, q, it, beta):
        flip = (it % 2).to(q.dtype)
        return q - (2.0 * flip * torch.dot(self.v, q)) * self.v, q.new_zeros(())


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps, hold_stream=False):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events.

    With ``hold_stream`` a spin kernel keeps the stream busy while the host
    enqueues all calls, so the events time the device work back to back and
    not the host's pace between launches.
    """
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold_stream:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """Milliseconds of one call of ``fn()`` by CUDA events (the plain
    versions at 200-D take seconds a call)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def ks_distance(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.max(np.abs(
        np.searchsorted(a, grid, side="right") / len(a)
        - np.searchsorted(b, grid, side="right") / len(b)
    )))


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of the two times at the card's peaks."""
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / F32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def trajectory_inputs(gen, dev, max_nsteps, c=None):
    """Synthetic kernel inputs at the main path's shape (``c`` chains a
    rung): positions around both modes of the curved target, a non-trivial
    mass matrix, per-rung step sizes like the adapted ones, nsteps uniform
    on [1, max_nsteps]."""
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder

    c = C if c is None else c
    mode = torch.where(torch.rand((T, 1, c), generator=gen, device=dev) < 0.5, -1.0, 2.0)
    x = 0.3 * torch.randn((T, D, c), generator=gen, device=dev)
    x[:, 1:] += mode
    chol = torch.linalg.cholesky(torch.tensor([[0.6, 0.15], [0.15, 0.9]], device=dev)).contiguous()
    q0 = (torch.linalg.inv(chol).T @ x).contiguous()
    p0 = torch.randn((T, D, c), generator=gen, device=dev)
    betas = torch.tensor(ladder_betas(temperature_ladder(D, T))[1], dtype=torch.float32, device=dev)
    eps = (0.1 * 1.3 ** torch.arange(T, device=dev, dtype=torch.float32))[:, None].expand(T, c)
    nsteps = torch.randint(1, max_nsteps + 1, (T, c), generator=gen, device=dev, dtype=torch.int32)
    return q0, p0, betas, eps.contiguous(), nsteps, chol


def step_inputs(gen, dev, max_steps, c=None):
    """The fused ChEES step's inputs around ``trajectory_inputs``: the
    positions x = chol^T q0, jitter u, and a step-size state with rung 0 at
    its first call (step size 0, so HMC_EPS is used) and lengths
    ``max_steps`` steps long, so nsteps is near uniform on [1, max_steps].
    Returns the arguments of ``chees_step`` but the model."""
    q0, r0, betas, eps, _, chol = trajectory_inputs(gen, dev, 1, c)
    c = q0.shape[2]
    x = (chol.T @ q0).contiguous()
    u = torch.rand((T, c), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    eps[0] = 0.0
    tlen = torch.where(eps > 0, eps, HMC_EPS) * max_steps
    chol_inv = torch.linalg.inv(chol).contiguous()
    return x, r0, u, betas, eps, tlen, HMC_EPS, max_steps, chol, chol_inv


def lanes_differ(out, ref):
    """Chains whose outputs differ in any bit (NaN equal to NaN)."""
    lanes = torch.zeros(out[-1].shape, dtype=torch.bool, device=out[-1].device)
    for a, b in zip(out, ref):
        ne = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
        lanes |= ne.any(dim=1) if a.dim() == 3 else ne
    return int(lanes.sum())


def energy_error(model, betas, x0, p0, x1, p1, lp1=None):
    """|dH| of trajectories from (x0, p0) to (x1, p1) in the original
    coordinates (the whitening leaves p.p unchanged); ``lp1`` is the end
    point's tempered logp where the kernel gives it."""
    lp0, _ = model.value_grad(x0, betas[:, None])
    if lp1 is None:
        lp1, _ = model.value_grad(x1, betas[:, None])
        lp1 = torch.where(torch.isnan(lp1), float("-inf"), lp1)
    dh = ((lp1 - 0.5 * (p1 * p1).sum(1)) - (lp0 - 0.5 * (p0 * p0).sum(1))).abs()
    return dh.flatten().cpu().numpy()


def check_energy_errors(label, dh_k, dh_p):
    fin_k, fin_p = np.isfinite(dh_k), np.isfinite(dh_p)
    ks = ks_distance(dh_k[fin_k], dh_p[fin_p])
    share = abs(fin_k.mean() - fin_p.mean())
    log(f"{label} |dH|: KS distance {ks:.4f}, finite share kernel {fin_k.mean():.5f} plain "
        f"{fin_p.mean():.5f}, median |dH| kernel {np.median(dh_k[fin_k]):.4e} plain "
        f"{np.median(dh_p[fin_p]):.4e}")
    if ks >= KS_TOL or share > NEGINF_SHARE_TOL:
        raise SystemExit(f"{label}: energy-error distribution differs from the plain version")


def check_pointwise(label, pairs, tol, neginf=()):
    """Max error over ``(name, kernel, plain)`` pairs; raise if any lies
    outside rtol = atol = ``tol`` or, for the names in ``neginf``, if the
    -inf masks differ (the error then counts the finite lanes)."""
    max_err = 0.0
    for name, a, b in pairs:
        if name in neginf:
            if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
                raise SystemExit(f"{label}: {name} -inf mask differs from the plain version")
            fin = torch.isfinite(a) & torch.isfinite(b)
            a, b = a[fin], b[fin]
            if not a.numel():
                log(f"{label} {name}: -inf in every lane of both")
                continue
        err = (a - b).abs()
        max_err = max(max_err, float(err.max()))
        bad = int((err > tol + tol * b.abs()).sum())
        log(f"{label} {name}: max |kernel - plain| = {float(err.max()):.3e}, {bad} of "
            f"{a.numel()} outside rtol=atol={tol}")
        if bad:
            raise SystemExit(f"{label}: {name} disagrees with the plain version")
    return max_err


def phase_chees_vs_plain(model):
    """Both ChEES entries against their plain versions: the trajectory entry
    and the fused step at 32 and 256 steps, then a ragged batch of each."""
    from ptmcmcsampler_torch.ops.chees import (
        chees_step, chees_step_plain, chees_trajectories, chees_trajectories_plain,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    max_err = 0.0
    for max_nsteps in (32, 256):
        args = trajectory_inputs(gen, dev, max_nsteps)
        out = chees_trajectories(*args, model)
        ref = chees_trajectories_plain(*args, model)
        torch.cuda.synchronize()
        if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
            raise SystemExit("kernel returned non-finite positions or momenta")
        label = f"ChEES trajectories nsteps<={max_nsteps}"
        log(f"{label}: {lanes_differ(out, ref)} of {T * C} lanes differ in any output")
        if max_nsteps <= 32:
            max_err = max(max_err, check_pointwise(
                label, zip(("q1", "p1", "logp1"), out, ref), SHORT_TOL, neginf=("logp1",)))
        else:
            q0, p0, betas, chol = args[0], args[1], args[2], args[5]
            x0 = chol.T @ q0
            check_energy_errors(label,
                                energy_error(model, betas, x0, p0, chol.T @ out[0], out[1], out[2]),
                                energy_error(model, betas, x0, p0, chol.T @ ref[0], ref[1], ref[2]))

    names = ("x1", "q0", "z1", "r1", "qxy", "alpha")
    for max_steps in (32, 256):
        args = step_inputs(gen, dev, max_steps)
        out = chees_step(*args, model)
        ref = chees_step_plain(*args, model)
        torch.cuda.synchronize()
        label = f"ChEES step max_steps={max_steps}"
        log(f"{label}: {lanes_differ(out, ref)} of {T * C} lanes differ in any output")
        if max_steps <= 32:
            max_err = max(max_err, check_pointwise(label, zip(names[:4], out[:4], ref[:4]),
                                                   SHORT_TOL))
            max_err = max(max_err, check_pointwise(label, zip(names[4:], out[4:], ref[4:]),
                                                   HMC_QXY_TOL, neginf=("qxy", "alpha")))
        else:
            x, r0, betas = args[0], args[1], args[3]
            check_energy_errors(label, energy_error(model, betas, x, r0, out[0], out[3]),
                                energy_error(model, betas, x, r0, ref[0], ref[3]))

    ragged = C - 100  # at 8 x 16284 chains: 508 whole blocks and one of 224
    args = trajectory_inputs(gen, dev, 32, ragged)
    out, ref = chees_trajectories(*args, model), chees_trajectories_plain(*args, model)
    label = f"ChEES trajectories ragged {T} x {ragged}"
    log(f"{label}: {lanes_differ(out, ref)} of {T * ragged} lanes differ in any output")
    max_err = max(max_err, check_pointwise(
        label, zip(("q1", "p1", "logp1"), out, ref), SHORT_TOL, neginf=("logp1",)))
    args = step_inputs(gen, dev, 32, ragged)
    out, ref = chees_step(*args, model), chees_step_plain(*args, model)
    label = f"ChEES step ragged {T} x {ragged}"
    log(f"{label}: {lanes_differ(out, ref)} of {T * ragged} lanes differ in any output")
    max_err = max(max_err, check_pointwise(label, zip(names[:4], out[:4], ref[:4]), SHORT_TOL))
    max_err = max(max_err, check_pointwise(label, zip(names[4:], out[4:], ref[4:]),
                                           HMC_QXY_TOL, neginf=("qxy", "alpha")))
    return max_err


# Past D = 256 (ROADMAP B7): the wide layout's groups of 8 chains (to 512-D)
# and of 4 (to 1024-D, its limit; two tile stages past 788-D). Both paths run
# bench.py's hierarchy with more groups at 8 x 16384 chains: 269 groups
# (270-D, the whole-array pulsar-timing class: 67 pulsars with a red-noise
# and a DM-noise power law each and a common process, 2 x 67 x 2 + 2
# parameters) and 1023 (1024-D). name -> groups.
LARGE_NGROUPS = {"hierarchical270": 269, "hierarchical1024": 1023}
# name -> (burn-in, timed) iterations of path 1 and of path 2, cut from
# bench.py's 3000 + 12000 to fit the script's limit (the cuts are in each
# workload's JSON line).
# A NUTS call takes about 0.16 s at 270-D and 2.9 s at 1024-D on an H100
# (trees of 33 and 55 leaves on average, groups of 8 and 4 chains run to
# their deepest tree), so path 2 at 1024-D is cut furthest.
# Cut: path 1 at 1024-D to half (from 200 + 300) and path 2 at 270-D
# from 400 + 600, to make room for the per-chain, general-entry and
# trajectory phases; for the sharded phase, the timed iterations at 270-D
# from 2000 to 1000 (path 1) and 450 to 300 (path 2). Path 2 at 1024-D keeps 60 +
# 100: with 50 timed iterations a first use of a key there left 0.96 of
# them replayed, below MIN_REPLAYED_SHARE. For the sharded per_chain and
# config-4 cases (PR 17): path 1 to 600 + 600 at 270-D and 60 + 100 at
# 1024-D, path 2 at 270-D to 200 + 200, and path 2 at 1024-D to a NUTS
# depth cap of 7 (LARGE_NUTS_DEPTH).
LARGE_ITERS = {"hierarchical270": (600, 600), "hierarchical1024": (60, 100)}
LARGE_NUTS_ITERS = {"hierarchical270": (200, 200), "hierarchical1024": (60, 100)}
# Path 2 at 270-D runs at a smaller NUTS depth cap (bench.py's 10), for the
# same room: a group of 8 chains steps as long as its deepest tree. Listed
# in its line's cuts. (At 1024-D a cap of 7 took a call only from 2.16 to
# 1.80 s on an H100, 18 s of the script; PR 17 takes it for the room.)
LARGE_NUTS_DEPTH = {"hierarchical270": 8, "hierarchical1024": 7}
# The plain versions' chains a rung in the large workloads' kernel items
# (their ordered sums over D are D launches a product); the NUTS plain
# version, which runs to the deepest tree of its chains, on (rungs,
# chains a rung) of LARGE_PLAIN_NUTS: about 75 ms a leaf at 1024-D.
LARGE_PLAIN_COLUMNS = {"hierarchical270": 64, "hierarchical1024": 8}
LARGE_PLAIN_NUTS = {"hierarchical270": (T, 16), "hierarchical1024": (1, 2)}
# The workloads whose NUTS item has no capped batch timing (every tree of
# the batch to the depth cap: about a minute at 1024-D); the capped group
# alone is timed.
NO_CAPPED_BATCH = ("hierarchical1024",)
# The workloads whose gate is printed and not enforced: the 1024-D paths'
# cut runs are too short for the gate (launches and finite states are
# still checked).
GATE_PRINTED_ONLY = ("hierarchical1024",)
# The kernel-vs-plain checks past 256 (phase_entries_vs_plain's settings):
# the kernels at T x C chains, the plain versions on wide_columns, with the
# identity and a dense factor, then the identity on a ragged batch; ChEES
# lengths up to 8 steps, NUTS at depth 4, HMC lengths in [HMC_NMIN, 12): the
# plain versions' ordered sums take D launches a product (about 3 s a ChEES
# step's worth of checks at 1024-D), so their lengths are cut, not the
# chains.
LARGE_CHECK = {"factors": ("identity", "dense"), "depths": (4,), "steps": 8, "nmax": 12,
               "ragged": "identity", "time_entries": False}
# The wide sampler phase on the 270-D hierarchy: its burn-in and DE wait
# are bench.py's share of the run, as on the 50-D model.
LARGE_SAMPLER = "hierarchical270"

def wide_workload(name):
    """bench.py's model and start for a wide workload (bench.py:126-142);
    for ``user_hierarchical`` and ``user_ref_gaussian`` the user models'
    (the hierarchy's is bench.py's, the Gaussian's the reference's); for
    ``hierarchical270`` and ``hierarchical1024`` bench.py's hierarchy with
    LARGE_NGROUPS groups, from bench.py's start (zeros)."""
    from ptmcmcsampler_torch.models import (
        CorrelatedGaussian, HierarchicalGaussian, IntervalTransformedGaussian,
    )

    if name == "gaussian":
        return IntervalTransformedGaussian(ndim=40), np.zeros(40)
    if name == "user_hierarchical":
        model = UserHierarchy()
        return model, np.zeros(model.ndim)
    if name == "user_ref_gaussian":
        model = UserRefGaussian()
        return model, np.full(model.ndim, 0.1)
    if name in LARGE_NGROUPS:
        model = HierarchicalGaussian(ngroups=LARGE_NGROUPS[name])
        return model, np.zeros(model.ndim)
    if name == "hierarchical":
        model = HierarchicalGaussian()
        return model, np.zeros(model.ndim)
    model = CorrelatedGaussian(ndim=200, seed=1)
    return model, model.mu.copy()


# The structure tag of each kind of factor wide_inputs makes.
FACTOR_TAGS = {"dense": "dense", "lower": "dense", "diagonal": "diagonal",
               "identity": "diagonal"}


def wide_inputs(gen, dev, model, c, max_steps, eps_base=WIDE_EPS, eps0=HMC_EPS,
                factor="dense"):
    """The fused ChEES step's arguments (but the model) for a wide model at
    ``c`` chains a rung: a factor ``chol`` with ``chol^T chol`` near the
    posterior covariance (the correlated model's own; the others'
    ``posterior_moments``) of the kind ``factor``: "dense" randomly mixed,
    "lower" the lower factor with the same ``chol^T chol`` as the mixed one
    (and its triangular inverse), "diagonal" the marginal scales,
    "identity" the identity, each of
    the structure tag FACTOR_TAGS gives; positions around
    the posterior's centre (the
    correlated model's clamped into its box, but 1 in 17 moved outside it);
    per-rung step sizes
    ``eps_base * 1.3**t``, rung 0 at its first call (``eps0`` used);
    lengths ``max_steps`` steps long, so nsteps is near uniform on [1,
    max_steps]."""
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder

    d = model.ndim
    if hasattr(model, "posterior_moments"):
        centre, cov = model.posterior_moments()
    else:
        centre, cov = model.mu, model.cov
    cov = torch.tensor(cov, dtype=torch.float64, device=dev)
    low = torch.linalg.cholesky(cov)
    z = torch.randn((T, d, c), generator=gen, device=dev).double()
    centre = torch.tensor(centre, dtype=torch.float64, device=dev)[None, :, None]
    x = (centre + 0.5 * torch.matmul(low, z)).float()
    # x = chol^T q with chol = (low R)^T, R = I + 0.1 a / sqrt(D): the
    # whitened Hessian is near -beta R^T R, well conditioned.
    a = torch.randn((d, d), generator=gen, device=dev).double()
    eye = torch.eye(d, dtype=torch.float64, device=dev)
    mix = low @ (eye + 0.1 * a / d**0.5)
    chol = mix.T.float().contiguous()
    chol_inv = torch.linalg.inv(mix.T).float().contiguous()
    if factor == "lower":  # mix mix^T = U U^T, U upper: chol = U^T
        up = torch.linalg.cholesky((mix @ mix.T).flip(0, 1)).flip(0, 1)
        chol = up.T.contiguous()
        chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False).float().contiguous()
        chol = chol.float()
    elif factor == "diagonal":
        scale = torch.sqrt(torch.diagonal(cov))
        chol = torch.diag(scale).float().contiguous()
        chol_inv = torch.diag(1.0 / scale).float().contiguous()
    elif factor == "identity":  # the factor bench.py's paths keep (mass_adapt off)
        chol = torch.eye(d, device=dev)
        chol_inv = torch.eye(d, device=dev)
    from ptmcmcsampler_torch.ops.common import factor_structure

    if factor_structure(chol.cpu(), chol_inv.cpu()) != FACTOR_TAGS[factor]:
        raise SystemExit(f"wide_inputs: the {factor} factor's tag is not {FACTOR_TAGS[factor]}")
    if not hasattr(model, "posterior_moments"):
        x = x.clamp(0.05, 9.95)  # inside the closed box [0, 10] ...
        x[:, 0, ::17] = -0.5  # ... but for these
    r0 = torch.randn((T, d, c), generator=gen, device=dev)
    u = torch.rand((T, c), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    betas = torch.tensor(ladder_betas(temperature_ladder(d, T))[1], dtype=torch.float32,
                         device=dev)
    eps = (eps_base * 1.3 ** torch.arange(T, device=dev, dtype=torch.float32))[:, None]
    eps = eps.expand(T, c).contiguous()
    eps[0] = 0.0
    tlen = torch.where(eps > 0, eps, eps0) * max_steps
    return x.contiguous(), r0, u, betas, eps, tlen, eps0, max_steps, chol, chol_inv


def diagonal_eps(model, factor, eps):
    """The checks' step size for a factor of the kind ``factor``: the correlated
    model whitened by its marginal scales alone (a diagonal factor) has a
    whitened Hessian up to about 4e4, so a leapfrog step above 0.01 is
    unstable there; it takes WIDE_TREE_EPS_BOX."""
    if factor in ("diagonal", "identity") and not hasattr(model, "posterior_moments"):
        return min(eps, WIDE_TREE_EPS_BOX)
    return eps


def step_lengths(u, eps, tlen, eps0, max_steps):
    """``(eps, nsteps)`` the fused step derives for each chain."""
    eps = torch.where(eps > 0, eps, eps0).contiguous()
    nsteps = torch.clamp(torch.ceil(u * torch.maximum(tlen, eps) / eps), 1, max_steps)
    return eps, nsteps.to(torch.int32)


def plain_columns(name, c, max_steps, dev):
    """The columns (chains a rung) of a wide check on which the plain
    version runs: all of them (None) but where WIDE_PLAIN_COLUMNS cuts a
    256-step case to its first and last columns."""
    n = WIDE_PLAIN_COLUMNS.get(name)
    if n is None or max_steps < 256 or n >= c:
        return None
    return torch.cat([torch.arange(n // 2, device=dev), torch.arange(c - n // 2, c, device=dev)])


def take_columns(values, c, cols):
    """``values`` with every tensor of last dimension ``c`` and at least two
    dimensions cut to the columns ``cols`` (None: unchanged)."""
    if cols is None:
        return list(values)
    return [a.index_select(-1, cols).contiguous()
            if torch.is_tensor(a) and a.dim() > 1 and a.shape[-1] == c else a for a in values]


def phase_wide_vs_plain(name, model):
    """Both wide ChEES entries of ``model``'s functor against their plain
    versions, the kernels at the main path's T x C chains (and a ragged
    batch of 100 chains a rung fewer): with a dense factor, max_steps 32 (no
    lane may differ in any bit), 256 and the ragged batch pointwise within
    SHORT_TOL with equal -inf masks, the plain version on the columns of
    ``plain_columns``, then short trajectories (4 steps of 1e-4 and up),
    which keep most of the correlated model's chains inside its box, where
    the longer ones leave it (its marginal sds, about 4, rival the box's
    width of 10) and their values are -inf; with a diagonal and a lower
    triangular factor (tags "diagonal" and "dense"), max_steps 32 on the
    full and the ragged batch, no lane differing in any bit. The
    trajectory entry starts from the fused step's own q0 with the step's
    lengths. Returns the largest error."""
    from ptmcmcsampler_torch.ops.chees import (
        chees_step, chees_step_plain, chees_trajectories, chees_trajectories_plain,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4242)
    names = ("x1", "q0", "z1", "r1", "qxy", "alpha")
    max_err = 0.0
    cases = [("dense", "", C, 32, WIDE_EPS), ("dense", "", C, 256, WIDE_EPS),
             ("dense", "ragged ", C - 100, 32, WIDE_EPS), ("dense", "short ", C, 4, 1e-4)]
    cases += [(f, lab, c, 32, diagonal_eps(model, f, WIDE_EPS)) for f in ("diagonal", "lower")
              for lab, c in (("", C), ("ragged ", C - 100))]
    for factor, label, c, max_steps, eps in cases:
        args = wide_inputs(gen, dev, model, c, max_steps, eps, min(eps, HMC_EPS), factor)
        structure = FACTOR_TAGS[factor]
        cols = plain_columns(name, c, max_steps, dev)
        plain_c = c if cols is None else cols.numel()
        label = (f"wide {name} (D={model.ndim}) {factor} factor ({structure}), {label}max_steps="
                 f"{max_steps} {T} x {c}, plain {T} x {plain_c}")
        t0 = time.time()
        out = chees_step(*args, model, structure)
        ref = chees_step_plain(*take_columns(args, c, cols), model, structure)
        _, r0, u, betas, eps, tlen, eps0, _, chol, _ = args
        eps_tc, nsteps = step_lengths(u, eps, tlen, eps0, max_steps)
        traj = (out[1], r0, betas, eps_tc, nsteps, chol, model, structure)
        tout = chees_trajectories(*traj)
        tref = chees_trajectories_plain(*take_columns(traj, c, cols))
        torch.cuda.synchronize()
        if not (torch.isfinite(out[2]).all() and torch.isfinite(tout[0]).all()):
            raise SystemExit(f"{label}: non-finite end points")
        if not (torch.equal(tout[0], out[2]) and torch.equal(tout[1], out[3])):
            raise SystemExit(f"{label}: the step's end points differ from the trajectory "
                             "entry's")
        out, tout = take_columns(out, c, cols), take_columns(tout, c, cols)
        n_step, n_traj = lanes_differ(out, ref), lanes_differ(tout, tref)
        log(f"{label}: {n_step} (step) and {n_traj} (trajectory) of {T * plain_c} lanes differ "
            f"in any output; -inf qxy share {float(torch.isneginf(out[4]).float().mean()):.4f}, "
            f"-inf logp1 share {float(torch.isneginf(tout[2]).float().mean()):.4f}, mean "
            f"nsteps {float(nsteps.float().mean()):.1f}; {time.time() - t0:.1f}s")
        if max_steps == 32 and (n_step or n_traj):
            raise SystemExit(f"{label}: lanes differ from the plain version")
        max_err = max(max_err, check_pointwise(label, zip(names, out, ref), SHORT_TOL,
                                               neginf=("qxy", "alpha")))
        max_err = max(max_err, check_pointwise(label, zip(("q1", "p1", "logp1"), tout, tref),
                                               SHORT_TOL, neginf=("logp1",)))
        del out, ref, tout, tref, args, traj
    return max_err


def phase_hmc_vs_plain(model):
    """Both HMC entries against their plain versions: the trajectory entry
    at two step sizes, then the fused step in the cases of the docstring."""
    from ptmcmcsampler_torch.ops.hmc import hmc_trajectories, hmc_trajectories_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    max_err = 0.0
    for eps in (HMC_EPS, 5.0):
        q0, p0, betas, _, _, chol = trajectory_inputs(gen, dev, 1)
        nsteps = torch.randint(HMC_NMIN, HMC_NMAX, (T, C), generator=gen, device=dev,
                               dtype=torch.int32)
        q1, qxy = hmc_trajectories(q0, p0, betas, nsteps, chol, eps, model)
        q1p, qxyp = hmc_trajectories_plain(q0, p0, betas, nsteps, chol, eps, model)
        torch.cuda.synchronize()
        err_q = (q1 - q1p).abs()
        bad_q = int((err_q > SHORT_TOL + SHORT_TOL * q1p.abs()).sum())
        same_mask = torch.equal(torch.isneginf(qxy), torch.isneginf(qxyp))
        fin = torch.isfinite(qxyp) & torch.isfinite(qxy)
        err_x = (qxy[fin] - qxyp[fin]).abs()
        bad_x = int((err_x > HMC_QXY_TOL + HMC_QXY_TOL * qxyp[fin].abs()).sum())
        max_err = max(max_err, float(err_q.max()), float(err_x.max()))
        log(f"HMC eps={eps}: max |q1 - plain| {float(err_q.max()):.3e} ({bad_q} outside "
            f"{SHORT_TOL}), max |qxy - plain| {float(err_x.max()):.3e} ({bad_x} outside "
            f"{HMC_QXY_TOL}), -inf masks equal {same_mask}, -inf share "
            f"{float(torch.isneginf(qxy).float().mean()):.4f}, mean nsteps "
            f"{float(nsteps.float().mean()):.2f}")
        if bad_q or bad_x or not same_mask:
            raise SystemExit(f"HMC kernel disagrees with the plain version at eps={eps}")

    for label, eps, c, outside, nmin, nmax in (
        ("eps=0.08", HMC_EPS, C, 0.0, HMC_NMIN, HMC_NMAX),
        ("eps=5.0", 5.0, C, 0.0, HMC_NMIN, HMC_NMAX),
        ("2% outside the box", HMC_EPS, C, 0.02, HMC_NMIN, HMC_NMAX),
        (f"ragged {T} x {C - 100}", HMC_EPS, C - 100, 0.0, HMC_NMIN, HMC_NMAX),
        (f"ragged {T} x {C - 101}", HMC_EPS, C - 101, 0.0, HMC_NMIN, HMC_NMAX),
        ("nmax = nmin + 1", HMC_EPS, C, 0.02, HMC_NMIN, HMC_NMIN + 1),
    ):
        args = hmc_step_inputs(gen, dev, c, outside)
        max_err = max(max_err, check_hmc_step(model, label, *args, eps, nmin, nmax))
    return max_err


def hmc_step_inputs(gen, dev, c=None, outside=0.0):
    """The fused HMC step's inputs at the main path's shape (``c`` chains a
    rung): positions around both modes of the curved target
    (``trajectory_inputs``), a share ``outside`` of them moved outside the
    prior box (to y = OUTSIDE_Y: joint0 = -inf there, so the break test
    never holds and the trajectory runs its whole drawn length), and a
    Philox key. Returns ``(x, betas, key, chol, chol_inv)``."""
    q0, _, betas, _, _, chol = trajectory_inputs(gen, dev, 1, c)
    x = (chol.T @ q0).contiguous()
    moved = torch.rand(x[:, 1].shape, generator=gen, device=dev) < outside
    x[:, 1] = torch.where(moved, OUTSIDE_Y, x[:, 1])
    key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
    return x, betas, key, chol, torch.linalg.inv(chol).contiguous()


def ulps(a, b):
    """Distance of two f32 tensors in units in the last place."""
    def ordered(v):
        i = v.view(torch.int32).to(torch.int64)
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return (ordered(a) - ordered(b)).abs()


def check_hmc_step(model, label, x, betas, key, chol, chol_inv, eps, nmin, nmax):
    """The fused HMC step against its plain version under one key; the
    kernel's draws against ``hmc_draws``; the step's end points against the
    trajectory entry's from the kernel's draws (bit for bit). Returns the
    largest error against the plain version."""
    from ptmcmcsampler_torch.ops import common
    from ptmcmcsampler_torch.ops.hmc import (
        hmc_draws, hmc_kernel_draws, hmc_step, hmc_step_plain, hmc_trajectories,
    )

    t, _, c = x.shape
    args = (x, betas, key, chol, chol_inv, eps, nmin, nmax, model)
    out, ref = hmc_step(*args), hmc_step_plain(*args)
    p0, nsteps = hmc_kernel_draws(key, t, D, c, nmin, nmax, model)
    p0t, nstepst = hmc_draws(key, t, D, c, nmin, nmax)
    torch.cuda.synchronize()
    max_ulp = int(ulps(p0, p0t).max())
    same_nsteps = torch.equal(nsteps, nstepst)
    label = f"HMC step {label}"
    log(f"{label}: {lanes_differ(out, ref)} of {t * c} lanes differ in any output; draws: "
        f"{lanes_differ((p0, nsteps), (p0t, nstepst))} lanes differ, p0 within {max_ulp} ulp, "
        f"nsteps equal {same_nsteps}, in [{int(nsteps.min())}, {int(nsteps.max())}]; "
        f"-inf qxy share "
        f"{float(torch.isneginf(out[1]).float().mean()):.4f}")
    err = check_pointwise(label, [("x1", out[0], ref[0])], SHORT_TOL)
    err = max(err, check_pointwise(label, [("qxy", out[1], ref[1])], HMC_QXY_TOL,
                                   neginf=("qxy",)))
    if not same_nsteps or max_ulp > DRAW_ULP_TOL:
        raise SystemExit(f"{label}: the kernel's draws differ from hmc_draws")
    q1, qxy = hmc_trajectories(common.matvec(chol_inv.T, x), p0, betas, nsteps, chol, eps, model)
    if not (torch.equal(common.matvec(chol.T, q1), out[0]) and torch.equal(qxy, out[1])):
        raise SystemExit(f"{label}: the end points differ from the trajectory entry's on the "
                         "kernel's own draws")
    return err


def tree_stats(nalpha, alive):
    return {"mean_nalpha": float(nalpha.mean()), "max_nalpha": float(nalpha.max()),
            "cap_cut_share": float(alive.mean())}


def phase_nuts_vs_plain(model):
    from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    max_err = 0.0
    for depth in (4, NUTS_DEPTH):
        q0, _, betas, eps, _, chol = trajectory_inputs(gen, dev, 1)
        r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, D, C, depth, dev)
        eps[:, ::97] = 0.0  # lanes that search their step size first
        eps[:, 13::89] = -1.0
        args = (q0, r0, betas, eps, expo, dirs, accu)
        out = nuts_trees(*args, key, chol, model, r_eps=r_eps)
        t0 = time.time()
        ref = nuts_trees_plain(*args, nuts_uniforms(key, depth, T, C), chol, model, r_eps)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        q, l0, lp, alpha, nalpha, alive, eps_used = out
        qp, l0p, lpp, alphap, nalphap, alivep, eps_usedp = ref
        lanes_differ = torch.zeros((T, C), dtype=torch.bool, device=dev)
        for a, b in zip(out, ref):
            ne = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
            lanes_differ |= ne.any(dim=1) if a.dim() == 3 else ne
        n_differ = int(lanes_differ.sum())
        searched = eps <= 0
        eps_differ = int((eps_used != eps_usedp).sum())
        differ = float((nalpha != nalphap).float().mean())
        err_q = float((q - qp).abs().max())
        err_lp = float((lp - lpp).abs().max())
        err_a = float((alpha - alphap).abs().max())
        err_eps = float((eps_used - eps_usedp).abs().max())
        max_err = max(max_err, err_q, err_lp, err_eps)
        ks = ks_distance(lp[torch.isfinite(lp)].cpu().numpy(),
                         lpp[torch.isfinite(lpp)].cpu().numpy())
        log(f"NUTS depth {depth}: {n_differ} of {T * C} lanes differ from the plain version in "
            f"any output; max |q_prop - plain| {err_q:.3e}, |logp_prop - plain| {err_lp:.3e}, "
            f"|alpha - plain| {err_a:.3e}, nalpha differs in {differ:.2e} of lanes, alive equal "
            f"{torch.equal(alive, alivep)}, KS(logp_prop) {ks:.4f}; step-size search in "
            f"{int(searched.sum())} lanes, {eps_differ} differ, found eps in "
            f"[{float(eps_used[searched].min()):.4g}, {float(eps_used[searched].max()):.4g}]; "
            f"trees {tree_stats(nalpha, alive)}, plain took {plain_s:.1f}s")
        ok = (eps_differ == 0 and bool((eps_used > 0).all())
              and torch.allclose(q, qp, rtol=SHORT_TOL, atol=SHORT_TOL)
              and torch.allclose(lp, lpp, rtol=SHORT_TOL, atol=SHORT_TOL, equal_nan=True)
              and torch.allclose(alpha, alphap, rtol=SHORT_TOL, atol=SHORT_TOL, equal_nan=True)
              and torch.equal(l0, l0p) and torch.equal(nalpha, nalphap)
              and torch.equal(alive, alivep))
        if not ok:
            raise SystemExit(f"NUTS kernel disagrees with the plain version at depth {depth}")
    return max_err


def headline_config(burn=BURN_ITERS // 2, cov_update=1000):
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps

    return SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=burn, have_grads=True
        ),
        tskip=5, cov_update=cov_update, burn=burn, thin=1, de_size=2000, hmc_stepsize=0.08,
    )


def nuts_config(burn=BURN_ITERS // 2, cov_update=1000):
    """The bench's ``grad_mode=nuts`` cycle (bench.py:163-199)."""
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps

    return SamplerConfig(
        ndim=D, ntemps=T, nchains=C, groups=(tuple(range(D)),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10, burn=burn,
            have_grads=True,
        ),
        tskip=5, cov_update=cov_update, burn=burn, thin=1, de_size=2000, hmc_stepsize=HMC_EPS,
        hmc_nminsteps=HMC_NMIN, hmc_nmaxsteps=HMC_NMAX, nuts_max_depth=NUTS_DEPTH,
    )


def counted_launches(stats, wrappers):
    """Each wrapper's kernel launches over the span ``stats`` covers, counted
    through the graphs: its calls, less those made under capture, plus each
    graph's recorded calls times its replays (``kernel.BlockStats``)."""
    return {key: stats.kernel_launches(w.__name__, w.launches) for key, w in wrappers.items()}


def eager_block(step, cfg, state, n, kinds):
    """``n`` iterations of the jump ``kinds`` as ``run_block`` ran them
    before its graphs: ``step`` after ``step`` and a thinned row each
    iteration into fresh buffers."""
    from ptmcmcsampler_torch.utils import tempered_lnprob

    t = cfg.ntemps
    x = torch.empty((n,) + tuple(state.x.shape), device=state.x.device)
    rows = torch.empty((5, n, t), device=state.x.device)
    for r, kind in enumerate(kinds):
        state = step(state, kind)
        x[r] = state.x
        rows[0, r] = state.lnlike[:, 0]
        rows[1, r] = tempered_lnprob(state.lnlike[:, 0], state.lnprior[:, 0], state.betas)
        rows[2, r] = state.counters.naccepted[:, 0]
        rows[3, r] = state.counters.swaps_accepted[:, 0]
        rows[4, r] = state.counters.swaps_proposed
    return state


def graph_pool_gb():
    """GB of the allocator's segments that belong to a graph's private pool
    (the memory a graph's replays write, which ``max_memory_allocated`` does
    not see once the capture has ended), or "not measured"."""
    segments = torch.cuda.memory._snapshot()["segments"]
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured"
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) != (0, 0)) / 1e9


def timed_window(fn, state, dev):
    """``(seconds, peak GB allocated, state)`` of ``state = fn(state)``,
    synchronised, the peak reset before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    state = fn(state)
    torch.cuda.synchronize()
    return time.time() - t0, torch.cuda.max_memory_allocated(dev) / 1e9, state


def new_state(cfg, model, x0, dev, seed=7):
    from ptmcmcsampler_torch import init_state
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder

    t, d, c = cfg.ntemps, cfg.ndim, cfg.nchains
    _, betas = ladder_betas(temperature_ladder(d, t))
    x0 = np.asarray(x0, dtype=np.float64)
    xs = torch.tensor(x0, dtype=torch.float32, device=dev)[None, :, None].expand(t, d, c)
    return init_state(cfg, seed, x0, np.eye(d), betas, model.lnlike(xs), model.lnprior(xs),
                      device=dev)


# Each main path's cold-chain acceptance by jump, by path name (read by the
# DE pair laws' lines, beside the blocked law's).
COLD_ACCEPTANCE = {}


def phase_main_path(model, card, path, cfg, wrappers, absent=(), x0=(-0.1, -0.5),
                    burn=BURN_ITERS, timed=TIMED_ITERS, block=BLOCK, stride=GATE_STRIDE,
                    compare_iters=PROFILE_ITERS, on_burned=None):
    """Run ``cfg`` at full width from ``x0``: ``burn`` then ``timed``
    iterations of ``run_block`` (its CUDA graphs) in blocks of ``block``,
    keeping every ``stride``-th cold chain of the timed ones on the card for
    the gate. ``wrappers`` maps each jump kind whose kernel the path must
    launch once per iteration of that kind, counted through the graphs, to
    the kernel's wrapper; the wrappers in ``absent`` must not launch at all.
    At least MIN_REPLAYED_SHARE of the timed iterations must replay a graph.
    A model without ``posterior_moments`` (gaussian200) has no gate: it must
    end finite, and its split R-hat is logged. Then the eager loop the graphs
    replaced against them on the path's final state, on the same jump kinds:
    a block of each (wall and peak memory; the graphs' pool beside it), then
    ``compare_iters`` iterations of each under the profiler. ``on_burned``,
    if given, is called with the state after the burn-in iterations."""
    from ptmcmcsampler_torch import build_step
    from ptmcmcsampler_torch.diagnostics import moment_gate, multichain_ess, split_rhat
    from ptmcmcsampler_torch.proposals.cycle import draw_kinds

    dev = torch.device(DEVICE)
    t, d, c = cfg.ntemps, cfg.ndim, cfg.nchains
    step, run_block = build_step(cfg, model, device=dev)
    state = new_state(cfg, model, x0, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def every(n):  # log about ten blocks of a phase
        return max(1, n // 10)

    stats = run_block.stats
    for w in (*wrappers.values(), *absent):
        w.launches = 0
    stats.reset()
    t0 = time.time()
    for b in range(burn // block):
        state, out = run_block(state, block)
        torch.cuda.synchronize()
        if (b + 1) % every(burn // block) == 0:
            log(f"{path}: burn-in block {b + 1} at {time.time() - t0:.1f}s")
    if on_burned is not None:
        on_burned(state)
    cold = []
    before = (sum(stats.replays.values()), stats.iterations)
    t1 = time.time()
    for b in range(timed // block):
        state, out = run_block(state, block)
        cold.append(out.x[:, 0, :, ::stride].clone())  # [block, D, C / stride]
        torch.cuda.synchronize()
        if (b + 1) % every(timed // block) == 0:
            log(f"{path}: timed block {b + 1} at {time.time() - t1:.1f}s")
    elapsed = time.time() - t1
    del out
    launches = counted_launches(stats, wrappers)
    graphs = stats.summary()
    graphs["timed_replayed_share"] = ((sum(stats.replays.values()) - before[0])
                                      / (stats.iterations - before[1]))
    peak_mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    kinds = [j.kind for j in cfg.jumps]
    kind_iters = {}
    for kind, n in launches.items():
        iters = kind_iters[kind] = int(state.counters.jump_proposed[kinds.index(kind), 0, 0])
        log(f"{path}: {kind} kernel launches {n} (through the graphs), {kind} iterations {iters}")
        if n == 0 or n != iters:
            raise SystemExit(
                f"path {path} did not launch the {kind} kernel once per {kind} iteration")
    jumps = jump_counts(cfg, state)  # over the burn-in and timed iterations
    for w in absent:
        if w.launches:
            raise SystemExit(f"path {path} launched {w.__name__} {w.launches} times")
    log(f"{path}: graphs {graphs}")
    if graphs["timed_replayed_share"] < MIN_REPLAYED_SHARE:
        raise SystemExit(f"path {path}: only {graphs['timed_replayed_share']:.4f} of the timed "
                         "iterations replayed a graph")
    if not (torch.isfinite(state.x).all() and state.x.shape == (t, d, c)):
        raise SystemExit(f"path {path}: state is not finite or has the wrong shape")

    chains = torch.cat(cold).permute(2, 0, 1)  # [C / stride, N, D], on the card
    del cold
    t2 = time.time()
    if hasattr(model, "posterior_moments"):
        target, _ = model.posterior_moments()
        ok, max_z, ess = moment_gate(chains, target)
    else:
        ok, max_z, ess = bool(torch.isfinite(chains).all()), None, multichain_ess(chains)
    rhat_max = float(np.nanmax(split_rhat(chains)))
    diag_sec = time.time() - t2
    used = int(chains.shape[0])
    del chains

    # The eager loop against the graphs, on the final state and one kind
    # sequence: a block of each, then each under the profiler.
    kinds = draw_kinds(cfg, state.it, block, state.host_rng)
    eager_sec, eager_peak_gb, state = timed_window(
        lambda st: eager_block(step, cfg, st, block, kinds), state, dev)
    graph_sec, graph_peak_gb, state = timed_window(
        lambda st: run_block(st, block, kinds=kinds)[0], state, dev)
    kinds = draw_kinds(cfg, state.it, compare_iters, state.host_rng)
    state, graph_prof = phase_profile(state, lambda st, n: run_block(st, n, kinds=kinds)[0],
                                      path, iters=compare_iters, iterations="all, graphs")
    state, eager_prof = phase_profile(state, lambda st, n: eager_block(step, cfg, st, n, kinds),
                                      path, iters=compare_iters, iterations="all, eager")
    eager_ips, window_ips = block / eager_sec, block / graph_sec

    ctr = state.counters
    acc = (ctr.jump_accepted[:, 0].sum(-1).double()
           / ctr.jump_proposed[:, 0].sum(-1).clamp(min=1).double()).tolist()
    COLD_ACCEPTANCE[path] = dict(zip(cfg.jump_names(), acc))
    name, power = [s.strip() for s in card.split(",", 1)]
    result = {
        "phase": "main_path",
        "path": path,
        "chains": [t, c],
        "ndim": d,
        "iters_per_sec": timed / elapsed,
        "ess_per_sec": float(ess.min()) / elapsed,
        "ess_min_dim": float(ess.min()),
        "ess_chains_used": used,
        "moments_ok": ok,
        "moments_max_z": max_z,
        "rhat_max": rhat_max,
        "elapsed_sec": elapsed,
        "burn_sec": t1 - t0,
        "diagnostics_sec": diag_sec,
        "cold_acceptance": COLD_ACCEPTANCE[path],
        "launches": launches,
        "iterations_by_kind": kind_iters,
        "jumps": jumps,
        "graphs": graphs,
        "peak_mem_gb": peak_mem_gb,
        # A block of the graphs and of the eager loop on the same kinds.
        "graph_block": {
            "iters_per_sec": window_ips,
            "peak_mem_gb": graph_peak_gb,
            "pool_gb": graph_pool_gb(),
            "profile": {k: graph_prof[k] for k in PROFILE_KEYS},
            # The profiled device ms an iteration at the unprofiled rate of
            # the timed run (the profiler slows the host).
            "device_busy_share_at_timed_rate":
                graph_prof["device_ms_per_iter"] * timed / elapsed / 1e3
                if isinstance(graph_prof["device_ms_per_iter"], float) else "not measured",
        },
        "eager": {
            # The graphs' chains equal the eager loop's bit for bit (the
            # "graphs" lines): the eager loop's ESS/s is this ESS/s scaled
            # by the two blocks' rates on the same kinds.
            "iters_per_sec": eager_ips,
            "ess_per_sec": float(ess.min()) / elapsed * eager_ips / window_ips,
            "wall_ms_per_iter": 1e3 * eager_sec / block,
            "peak_mem_gb": eager_peak_gb,
            "profile": {k: eager_prof[k] for k in PROFILE_KEYS},
            "device_busy_share_at_block_rate":
                eager_prof["device_ms_per_iter"] * eager_ips / 1e3
                if isinstance(eager_prof["device_ms_per_iter"], float) else "not measured",
        },
        "card": name,
        "power_limit": power,
    }
    return state, (step, run_block), result, ok


# The graphs check: run_block's CUDA graphs against the eager step loop at
# full width over GRAPHS_ITERS iterations that cross swaps (tskip 5), the end
# of adaptation and of DE's wait (burn) and factor refreshes (cov_update):
# burn and cov_update are cut from the paths' 1500 and 1000 to GRAPHS_BURN
# and GRAPHS_COV_UPDATE so that 300 iterations cross them. run_block runs in
# blocks of GRAPHS_BLOCK.
GRAPHS_ITERS, GRAPHS_BURN, GRAPHS_COV_UPDATE, GRAPHS_BLOCK = 300, 100, 100, 50


def phase_graphs(model, card, path, cfg, wrappers, x0):
    """The graphs phase of the docstring: prints its JSON line; fails unless
    the two agree bit for bit and each kernel launched once per iteration
    of its kind in both (through the graphs in ``run_block``)."""
    from ptmcmcsampler_torch import build_step
    from ptmcmcsampler_torch.proposals.cycle import draw_kinds
    from ptmcmcsampler_torch.state import state_tensors

    dev = torch.device(DEVICE)
    step, run_block = build_step(cfg, model, device=dev)
    eager, graph = new_state(cfg, model, x0, dev), new_state(cfg, model, x0, dev)
    kinds = draw_kinds(cfg, 0, GRAPHS_ITERS, eager.host_rng)
    draw_kinds(cfg, 0, GRAPHS_ITERS, graph.host_rng)  # the host generators stay equal
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    for kind in kinds:
        eager = step(eager, kind)
    torch.cuda.synchronize()
    eager_sec = time.time() - t0
    eager_launches = {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    for i in range(0, GRAPHS_ITERS, GRAPHS_BLOCK):
        graph, _ = run_block(graph, GRAPHS_BLOCK, kinds=kinds[i:i + GRAPHS_BLOCK])
    torch.cuda.synchronize()
    graph_sec = time.time() - t0
    stats = run_block.stats
    graph_launches = counted_launches(stats, wrappers)

    def bits(a):
        return a.contiguous().reshape(-1).view(torch.uint8)

    te, tg = state_tensors(eager), state_tensors(graph)
    differ = [p for p in te if not torch.equal(bits(te[p]), bits(tg[p]))]
    if (eager.it, eager.de.filled, eager.adapt.structure) != (
            graph.it, graph.de.filled, graph.adapt.structure):
        differ.append("host fields")
    differ += [g for g in ("rng", "host_rng")
               if not torch.equal(getattr(eager, g).get_state(), getattr(graph, g).get_state())]
    names = [j.kind for j in cfg.jumps]
    iters = {k: int(graph.counters.jump_proposed[names.index(k), 0, 0]) for k in wrappers}
    summary = stats.summary()
    name, power = [v.strip() for v in card.split(",", 1)]
    result = {
        "phase": "graphs", "path": path, "model": type(model).__name__, "ndim": cfg.ndim,
        "chains": [cfg.ntemps, cfg.nchains], "iters": GRAPHS_ITERS, "block": GRAPHS_BLOCK,
        "cuts": {"burn": {"path": BURN_ITERS // 2, "run": cfg.burn},
                 "cov_update": {"path": 1000, "run": cfg.cov_update}},
        "bitwise_equal": not differ, "differ": differ, "tensors_compared": len(te),
        "eager_sec": eager_sec, "graph_sec": graph_sec,
        "eager_ms_per_iter": 1e3 * eager_sec / GRAPHS_ITERS,
        "graph_ms_per_iter": 1e3 * graph_sec / GRAPHS_ITERS,
        "graph_ms_per_iter_without_capture":
            1e3 * (graph_sec - summary["capture_sec"]) / GRAPHS_ITERS,
        **summary, "graph_keys": [list(map(str, k)) for k in stats.recorded],
        "iterations_by_kind": iters, "eager_launches": eager_launches,
        "graph_launches": graph_launches, "card": name, "power_limit": power,
    }
    print(json.dumps(result), flush=True)
    if differ:
        raise SystemExit(f"graphs {path}: the graphs and the eager loop differ in {differ}")
    if any(n != iters[k] or eager_launches[k] != iters[k] or not n
           for k, n in graph_launches.items()):
        raise SystemExit(f"graphs {path}: launches {graph_launches} (graphs), {eager_launches} "
                         f"(eager) for iterations {iters}")
    return result


def print_result(result, ok):
    print(json.dumps(result), flush=True)
    if not ok:
        raise SystemExit(f"moment gate failed on path {result['path']} "
                         f"(max z {result['moments_max_z']})")


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0.0
    )


def phase_profile(state, advance, path, iters=PROFILE_ITERS, iterations="all"):
    """Device-busy share, device operations an iteration and the largest
    device times over ``iters`` more iterations of a path, run by
    ``advance(state, iters)``, with the profiler on. It records the device's
    activity only: the host's operator events would carry the same device
    time again, slow the host further and take seconds a profile to
    aggregate."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        state = advance(state, iters)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    # Device-side events (kernels, copies, fills).
    device = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    device_us = sum(_device_us(e) for e in device)
    top = sorted(device, key=_device_us, reverse=True)[:8]
    result = {
        "phase": "profile",
        "path": path,
        "iterations": iterations,
        "iters": iters,
        "wall_ms_per_iter": wall_us / 1e3 / iters,
        "device_busy_share": device_us / wall_us if device_us else "not measured",
        "device_ms_per_iter": device_us / 1e3 / iters if device_us else "not measured",
        "device_ops_per_iter": sum(e.count for e in device) / iters if device else "not measured",
        "top_device_ms_per_iter": [[e.key, _device_us(e) / 1e3 / iters] for e in top],
    }
    print(json.dumps(result), flush=True)
    return state, result


def advance_kind(run_block, cfg, kind):
    """``iters`` iterations of one jump kind, replayed by ``run_block`` (with
    its row copies, one row an iteration)."""
    index = [j.kind for j in cfg.jumps].index(kind)
    return lambda state, iters: run_block(state, iters, kinds=[index] * iters)[0]


def kernel_entry(name, replaces, launches, max_err, kernel_ms, wrapper_ms, plain_ms, bytes_moved,
                 ops, **extra):
    bound_ms, bound_by = bound(bytes_moved, ops)
    return {
        "name": name,
        "route": "cuda",
        "source": f"ptmcmcsampler_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        **extra,
    }


def chees_kernel_entry(model, state, launches, max_err):
    """Time both ChEES entries and their plain versions on inputs from path
    1's final state: the adapted step sizes and trajectory lengths, fresh
    momenta and jitter, drawn as proposals/chees.py draws them, with the
    trajectory entry's start whitened by a matmul as before the fused step
    existed (so its time compares with earlier runs); then the lane
    efficiency of those lengths and the capped timings. ``launches`` maps
    each entry to its launches on path 1."""
    from ptmcmcsampler_torch.ops.chees import (
        chees_step, chees_step_plain, chees_trajectories, chees_trajectories_plain,
        lane_efficiency,
    )

    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    chol, chol_inv = state.adapt.chol, state.adapt.chol_inv
    structure = state.adapt.structure
    ss = state.stepsize
    eps = ss.chees_eps.contiguous()
    tlen = torch.maximum(ss.chees_tlen, eps)
    u = torch.rand((T, C), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    max_steps = headline_config().chees_max_steps
    nsteps = torch.clamp(torch.ceil(u * tlen / eps), 1, max_steps).to(torch.int32)
    q0 = (chol_inv.T @ state.x).contiguous()
    p0 = torch.randn((T, D, C), generator=gen, device=dev)
    args = (q0, p0, state.betas, eps, nsteps, chol, model)
    fused = (state.x, p0, u, state.betas, eps, ss.chees_tlen.contiguous(), HMC_EPS, max_steps,
             chol, chol_inv, model)

    kernel_ms = cuda_ms(lambda: chees_trajectories(*args), 50, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: chees_trajectories(*args), 50)
    plain_ms = cuda_ms(lambda: chees_trajectories_plain(*args), 5)
    fused_ms = cuda_ms(lambda: chees_step(*fused), 50, hold_stream=True)
    fused_wrapper_ms = cuda_ms(lambda: chees_step(*fused), 50)
    fused_plain_ms = cuda_ms(lambda: chees_step_plain(*fused), 5)
    # The fused step runs these nsteps: its end point is the trajectory
    # entry's from its own q0 (an ordered sum, where q0 above is a matmul).
    out = chees_step(*fused)
    z1, r1, _ = chees_trajectories(out[1], p0, state.betas, eps, nsteps, chol, model, structure)
    if not (torch.equal(out[2], z1) and torch.equal(out[3], r1)):
        raise SystemExit("the fused ChEES step's trajectories differ from the trajectory entry's")
    steps = int(nsteps.sum())
    max_nsteps = int(nsteps.max())
    # Per chain: q0, p0, q1, p1 (4 * D floats), eps, nsteps, logp1.
    bytes_moved = 4 * (4 * D + 3) * T * C + 4 * (T + D * D)
    ops = OPS_PER_STEP * (steps + T * C)  # + the starting gradient
    # Per chain: x, r0, u, eps, tlen in; x1, q0, z1, r1, qxy, alpha out.
    fused_bytes = 4 * (6 * D + 5) * T * C + 4 * (T + 2 * D * D)
    fused_bound_ms, fused_bound_by = bound(fused_bytes, ops + OPS_PER_CHEES_CHAIN * T * C)
    capped = chees_capped_timings(model, q0, p0, state.betas, eps, chol, max_nsteps)
    extra = {
        "launches_by_entry": launches,
        "fused_ms": fused_ms, "fused_wrapper_ms": fused_wrapper_ms,
        "fused_plain_ms": fused_plain_ms, "fused_bound_ms": fused_bound_ms,
        "fused_bound_by": fused_bound_by,
        "lane_efficiency_unsorted": lane_efficiency(nsteps, grouped=False),
        "lane_efficiency_sorted": lane_efficiency(nsteps, grouped=True),
        "mean_nsteps": steps / (T * C), "max_nsteps": max_nsteps, **capped,
    }
    log(f"ChEES kernel {kernel_ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms; fused step {fused_ms:.4f} ms, wrapper call {fused_wrapper_ms:.4f} "
        f"ms, plain {fused_plain_ms:.3f} ms; {extra}")
    return kernel_entry(
        "chees_trajectory", "ptmcmcsampler_tpu/ops/chees_pallas.py:41",
        launches["chees_step"] + launches["chees_trajectories"], max_err,
        kernel_ms, wrapper_ms, plain_ms, bytes_moved, ops, **extra,
    )


def chees_capped_timings(model, q0, p0, betas, eps, chol, nsteps):
    """The trajectory entry with every chain at ``nsteps`` steps: over the
    whole batch, the time a step takes when every lane is busy
    (throughput); over one warp alone (T = 1, C = 32), the time a step
    takes on one thread's dependent chain (latency)."""
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories

    result = {}
    for name, t, c, reps in (("batch", T, C, 20), ("warp", 1, 32, 50)):
        args = (q0[:t, :, :c].contiguous(), p0[:t, :, :c].contiguous(), betas[:t].contiguous(),
                eps[:t, :c].contiguous(),
                torch.full((t, c), nsteps, dtype=torch.int32, device=q0.device), chol, model)
        ms = cuda_ms(lambda: chees_trajectories(*args), reps, hold_stream=True)
        result[f"capped_{name}_ms"] = ms
        result[f"capped_{name}_us_per_step"] = 1e3 * ms / nsteps
    return result


def ptxas_info(text):
    """Registers, spill bytes and stack frame of each kernel in an ``nvcc
    -Xptxas -v`` log, by kernel and template arguments: ``hmc_kernel<1>``
    is the fused step, ``hmc_kernel<0>`` the trajectory entry,
    ``chees_wide_kernel<WideHierarchicalGaussian,1>`` the wide fused step of
    that functor and ``chees_wide_kernel<WidePerChain,user_hierarchy_functor,1>``
    the one of the registered user functor ``user_hierarchy``."""
    info = {}
    for block in text.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        name = re.search(r"\d([a-z_]+_kernel)", mangled)
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        if not (name and regs and frame):
            continue
        args = (re.findall(r"\d(Wide[A-Za-z]+Gaussian)E", mangled)
                + re.findall(r"\d(WidePerChain)I", mangled)
                + re.findall(r"\d([a-z_]+_functor)E", mangled)
                + re.findall(r"L[ib](\d+)E", mangled))
        label = f"{name.group(1)}<{','.join(args)}>"
        info[label] = {"registers": int(regs.group(1)), "stack_bytes": int(frame.group(1)),
                       "spill_store_bytes": int(frame.group(2)),
                       "spill_load_bytes": int(frame.group(3)),
                       "static_smem_bytes": int(smem.group(1)) if smem else 0}
    return info


def hmc_kernel_entry(model, state, launches, max_err, ptxas):
    """Time both HMC entries and their plain versions on path 2's final
    state: the fused step under a fresh key, as proposals/gradient.py
    make_hmc draws it; the trajectory entry on that step's own draws
    (``hmc_kernel_draws``), with its start whitened by a matmul as before
    the fused step existed (so its time compares with earlier runs). Then
    the steps those draws take, and the full-length timings. ``launches``
    maps each entry to its launches on path 2; ``ptxas`` is the kernel
    source's build log, parsed."""
    from ptmcmcsampler_torch.ops import common
    from ptmcmcsampler_torch.ops.hmc import (
        hmc_kernel_draws, hmc_step, hmc_step_plain, hmc_trajectories, hmc_trajectories_plain,
    )

    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(98)
    chol, chol_inv = state.adapt.chol, state.adapt.chol_inv
    key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
    fused = (state.x, state.betas, key, chol, chol_inv, HMC_EPS, HMC_NMIN, HMC_NMAX, model)
    p0, nsteps = hmc_kernel_draws(key, T, D, C, HMC_NMIN, HMC_NMAX, model)
    q0 = (chol_inv.T @ state.x).contiguous()
    args = (q0, p0, state.betas, nsteps, chol, HMC_EPS, model)

    kernel_ms = cuda_ms(lambda: hmc_trajectories(*args), 50, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: hmc_trajectories(*args), 50)
    plain_ms = cuda_ms(lambda: hmc_trajectories_plain(*args), 5)
    fused_ms = cuda_ms(lambda: hmc_step(*fused), 50, hold_stream=True)
    fused_wrapper_ms = cuda_ms(lambda: hmc_step(*fused), 50)
    fused_plain_ms = cuda_ms(lambda: hmc_step_plain(*fused), 5)
    draws_ms = cuda_ms(lambda: hmc_kernel_draws(key, T, D, C, HMC_NMIN, HMC_NMAX, model), 50,
                       hold_stream=True)
    # The steps these draws take. The break test (joint1 - 1000) < joint0,
    # kept from the reference (nutsjump.py:285-287), ends a trajectory after
    # its first step unless that step raised the joint by 1000 or more. A
    # chain whose end point is its one-step point took one step; count its
    # drawn nsteps for any other. The fused step's end points are the
    # trajectory entry's from its own whitening, bit for bit.
    x1, qxy = hmc_step(*fused)
    q0_ordered = common.matvec(chol_inv.T, state.x)
    q1, _ = hmc_trajectories(q0_ordered, p0, state.betas, nsteps, chol, HMC_EPS, model)
    one_step, _ = hmc_trajectories(q0_ordered, p0, state.betas, torch.ones_like(nsteps), chol,
                                   HMC_EPS, model)
    if not torch.equal(common.matvec(chol.T, q1), x1):
        raise SystemExit("the fused HMC step's end points differ from the trajectory entry's")
    stopped = (q1 == one_step).all(dim=1)
    steps = int(torch.where(stopped, 1, nsteps).sum())
    # Trajectory entry, per chain: q0, p0, q1 (3 * D floats), nsteps, qxy.
    bytes_moved = 4 * (3 * D + 2) * T * C + 4 * (T + D * D)
    ops = OPS_PER_STEP * (steps + T * C)
    # Fused step, per chain: x in, x1 and qxy out; beta, chol, chol_inv, key.
    fused_bytes = 4 * (2 * D + 1) * T * C + 4 * (T + 2 * D * D) + 16
    fused_bound_ms, fused_bound_by = bound(fused_bytes, ops + OPS_PER_HMC_CHAIN * T * C)
    full = hmc_full_timings(model, state, gen)
    extra = {
        "launches_by_entry": launches,
        "fused_ms": fused_ms, "fused_wrapper_ms": fused_wrapper_ms,
        "fused_plain_ms": fused_plain_ms, "fused_bound_ms": fused_bound_ms,
        "fused_bound_by": fused_bound_by, "draws_kernel_ms": draws_ms,
        "chains_per_thread": 1, "threads_per_block": 256, "ptxas": ptxas,
        "mean_nsteps_drawn": float(nsteps.float().mean()), "mean_nsteps_taken": steps / (T * C),
        "stopped_after_one_step": float(stopped.float().mean()), **full,
    }
    log(f"HMC trajectory entry {kernel_ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms; fused step {fused_ms:.4f} ms, wrapper call {fused_wrapper_ms:.4f} "
        f"ms, plain {fused_plain_ms:.3f} ms; -inf qxy share "
        f"{float(torch.isneginf(qxy).float().mean()):.5f}; {extra}")
    return kernel_entry(
        "hmc_trajectory", "ptmcmcsampler_tpu/ops/hmc_pallas.py:54",
        launches["hmc_step"] + launches["hmc_trajectories"], max_err,
        kernel_ms, wrapper_ms, plain_ms, bytes_moved, ops, **extra,
    )


def hmc_full_timings(model, state, gen):
    """The fused step with every chain started outside the prior box (y =
    OUTSIDE_Y): joint0 = -inf, so the break test never holds and each chain
    runs its drawn length from [HMC_NMIN, HMC_NMAX), as it would without the
    break test (ROADMAP C). Over the whole batch, and over one warp's chains
    alone (T = 1, 32 threads' chains); microseconds a step over the longest
    drawn length, which sets a warp's time."""
    from ptmcmcsampler_torch.ops.hmc import hmc_kernel_draws, hmc_step

    result = {}
    for name, t, c, reps in (("batch", T, C, 20), ("warp", 1, 32, 50)):
        x = state.x[:t, :, :c].clone()
        x[:, 1] = OUTSIDE_Y
        key = torch.randint(0, 2**32, (2,), generator=gen, device=x.device, dtype=torch.int64)
        args = (x, state.betas[:t].contiguous(), key, state.adapt.chol, state.adapt.chol_inv,
                HMC_EPS, HMC_NMIN, HMC_NMAX, model)
        x1, qxy = hmc_step(*args)
        _, nsteps = hmc_kernel_draws(key, t, D, c, HMC_NMIN, HMC_NMAX, model)
        if not (torch.isfinite(x1).all() and torch.isneginf(qxy).all()):
            raise SystemExit(f"full-length HMC timing ({name}): non-finite end points, or a "
                             "start inside the box")
        longest = int(nsteps.max())
        ms = cuda_ms(lambda: hmc_step(*args), reps, hold_stream=True)
        result[f"full_{name}_ms"] = ms
        result[f"full_{name}_us_per_step"] = 1e3 * ms / longest
        result[f"full_{name}_mean_nsteps"] = float(nsteps.float().mean())
    return result


def nuts_kernel_entry(model, state, launches, max_err):
    """Time the NUTS kernel, a NUTS call's draws and the plain version on
    inputs from path 2's final state (its adapted step sizes), drawn as
    proposals/nuts.py draws them; then the capped timings."""
    from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(97)
    chol = state.adapt.chol
    q0 = (state.adapt.chol_inv.T @ state.x).contiguous()
    eps = state.stepsize.epsilon.contiguous()
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, D, C, NUTS_DEPTH, dev)
    args = (q0, r0, state.betas, eps, expo, dirs, accu, key, chol, model)

    kernel_ms = cuda_ms(lambda: nuts_trees(*args, r_eps=r_eps), 20, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: nuts_trees(*args, r_eps=r_eps), 20)
    draw_ms = cuda_ms(lambda: draw_nuts(gen, T, D, C, NUTS_DEPTH, dev), 20, hold_stream=True)
    resu = nuts_uniforms(key, NUTS_DEPTH, T, C)
    plain_ms = cuda_ms(lambda: nuts_trees_plain(*args[:7], resu, chol, model, r_eps), 2)
    del resu
    _, _, _, _, nalpha, alive, _ = nuts_trees(*args, r_eps=r_eps)
    leaves = float(nalpha.sum())
    levels = float(torch.ceil(torch.log2(nalpha + 1.0)).sum())  # doublings a tree ran
    searched = int((eps <= 0).sum())
    # Per chain: q0, r0, q_prop (3 * D floats), eps, expo, the five
    # statistics and the step size used; per doubling run, dirs and accu;
    # per searching lane, its search momenta; beta, chol and the key. No
    # per-leaf bytes: each leaf's uniform is computed from the key.
    bytes_moved = (4 * ((3 * D + 8) * T * C + 2 * levels + D * searched)
                   + 4 * (T + D * D) + 16)
    ops = OPS_PER_LEAF * leaves + OPS_PER_LEVEL * levels + OPS_PER_STEP * T * C
    stats = tree_stats(nalpha, alive)
    capped = nuts_capped_timings(model, q0, state.betas, chol, gen)
    log(f"NUTS kernel {kernel_ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, draws "
        f"{draw_ms:.4f} ms, plain {plain_ms:.1f} ms, trees {stats}, capped {capped}")
    return kernel_entry(
        "nuts_tree", "ptmcmcsampler_tpu/ops/nuts_pallas.py:74", launches, max_err,
        kernel_ms, wrapper_ms, plain_ms, bytes_moved, ops, draw_ms=draw_ms,
        us_per_leaf_critical=1e3 * kernel_ms / stats["max_nalpha"], **stats, **capped,
    )


def nuts_capped_timings(model, q0, betas, chol, gen):
    """The NUTS kernel with every tree run to the depth cap (step size
    CAPPED_EPS): over the whole batch, the time a leaf level takes when all
    chains are busy (throughput); over one warp alone (T = 1, C = 32), the
    time a leaf takes on one thread's dependent chain (latency)."""
    from ptmcmcsampler_torch.ops.nuts import nuts_trees
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    dev = q0.device
    leaves = (1 << NUTS_DEPTH) - 1
    result = {}
    for name, t, c, reps in (("batch", T, C, 3), ("warp", 1, 32, 10)):
        q = q0[:t, :, :c].contiguous()
        eps = torch.full((t, c), CAPPED_EPS, device=dev)
        r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, t, D, c, NUTS_DEPTH, dev)
        args = (q, r0, betas[:t].contiguous(), eps, expo, dirs, accu, key, chol, model)
        out = nuts_trees(*args, r_eps=r_eps)
        alive_share = float(out[5].mean())
        if alive_share < CAPPED_ALIVE_MIN:
            raise SystemExit(f"capped NUTS timing: only {alive_share:.4f} of trees reached the "
                             f"cap at eps {CAPPED_EPS}")
        ms = cuda_ms(lambda: nuts_trees(*args, r_eps=r_eps), reps, hold_stream=True)
        result[f"capped_{name}_ms"] = ms
        result[f"capped_{name}_us_per_leaf"] = 1e3 * ms / leaves
        result[f"capped_{name}_alive_share"] = alive_share
    result["capped_batch_leaves_per_s"] = T * C * leaves / (result["capped_batch_ms"] / 1e3)
    return result


def nuts_path_extras(model, state):
    """NUTS step sizes per rung, and the tree sizes of one more call at the
    final state (made after the path's launches were read)."""
    from ptmcmcsampler_torch.ops.nuts import nuts_trees
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(96)
    q0 = (state.adapt.chol_inv.T @ state.x).contiguous()
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, D, C, NUTS_DEPTH, dev)
    out = nuts_trees(q0, r0, state.betas, state.stepsize.epsilon.contiguous(), expo, dirs, accu,
                     key, state.adapt.chol, model, r_eps=r_eps)
    return {"nuts_eps": state.stepsize.epsilon.mean(1).tolist(), **tree_stats(out[4], out[5])}


def time_drains(sampler, seconds, sync=False):
    """Record the host seconds of each of ``sampler``'s drains, checkpoints
    and neff checks in ``seconds[name]``. With ``sync`` (the serial loop,
    whose drain reads the card) the device queue is drained first, so that a
    drain's time holds no wait for its block's device work. Without it (the
    overlapped loop, which drains a host copy while the card runs the next
    block) ``seconds["busy_after"]`` records, after each checkpoint, whether
    the card was still running the next block: the drain was hidden."""
    for name in ("_drain_block", "_save_checkpoint", "_neff_value"):
        fn = getattr(sampler, name)

        def timed(*args, _fn=fn, _name=name):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args)
            seconds[_name].append(time.perf_counter() - t0)
            if _name == "_save_checkpoint" and not sync:
                seconds["busy_after"].append(not torch.cuda.current_stream().query())
            return out

        setattr(sampler, name, timed)
        seconds[name] = []
    seconds["busy_after"] = []


#: The parts of a drain and a checkpoint that ``PTSampler.io_seconds`` times.
DRAIN_PARTS = ("to_host", "wait", "format", "write", "sidecar", "cov_jumps",
               "checkpoint_arrays", "checkpoint_savez", "checkpoint_meta")
FORMAT_REPS = 5  # calls a block's formatting time is the mean of


@contextlib.contextmanager
def stash_rows(stash):
    """Keep in ``stash["rows"]`` the arguments of the first chain-file append
    of more than one row (a drain's cold rows), as f64 arrays."""
    from ptmcmcsampler_torch.io.chainfile import ChainWriter

    real = ChainWriter.append

    def append(self, i, params, *cols):
        if "rows" not in stash and len(params) > 1:
            stash["rows"] = tuple(np.array(a, np.float64) for a in (params, *cols))
        return real(self, i, params, *cols)

    ChainWriter.append = append
    try:
        yield stash
    finally:
        ChainWriter.append = real


def format_timings(rows):
    """The native formatter against its plain version on ``rows`` (a
    drain's cold rows): host ms of each, over FORMAT_REPS calls, and whether
    their text is byte for byte equal."""
    from ptmcmcsampler_torch.io import chainfile, native

    out = {}
    for name, fn in (("native", native.format_rows), ("plain", chainfile.format_rows_plain)):
        text = fn(*rows)
        t0 = time.perf_counter()
        for _ in range(FORMAT_REPS):
            fn(*rows)
        out[name] = (text, 1e3 * (time.perf_counter() - t0) / FORMAT_REPS)
    return {"rows": int(rows[0].shape[0]), "columns": int(rows[0].shape[1]) + 4,
            "bytes": len(out["native"][0]), "native_ms": out["native"][1],
            "plain_ms": out["plain"][1], "byte_equal": out["native"][0] == out["plain"][0]}


#: Values where glibc's printf and CPython's %-formatting could part: +-0,
#: +-inf, NaN of either sign, subnormals, 1e+-300 and the largest double,
#: a rounding carry, float32 values upcast.
CHAINIO_SPECIAL = (0.0, -0.0, float("inf"), float("-inf"), float("nan"), -float("nan"), 5e-324,
                   -2.2250738585072e-308, 1e-300, -1e-300, 1e300, -1e300,
                   1.7976931348623157e308, -1.7976931348623157e308, 9.9999999999, 0.5,
                   -123.456789012345678, float(np.float32(0.1)), float(np.float32(-3.4e38)),
                   float(np.float32(1.4e-45)))


def phase_chainio(card, build_sec):
    """The native chain-row formatter (``io/native.py``, the port's copy of
    ``csrc/chainio.cpp`` built with the host compiler) on this machine:
    byte for byte against its plain version on each CHAINIO_SPECIAL value
    in a parameter column and in each of the four trailing columns, and on
    one drain's rows of the 50-D wide sampler (WIDE_ROWS). Prints one line
    ``"phase": "chainio"``; fails on any byte that differs."""
    from ptmcmcsampler_torch.io import chainfile, native

    special = np.array(CHAINIO_SPECIAL)
    rows = (np.stack([special, special[::-1]], 1), *(np.roll(special, k) for k in range(4)))
    text = native.format_rows(*rows)
    special_equal = text == chainfile.format_rows_plain(*rows)
    wide = format_timings(WIDE_ROWS["hierarchical"])
    card_name, power = [v.strip() for v in card.split(",", 1)]
    line = {"phase": "chainio", "library": native.library_path().name,
            "compiler": native.compiler(), "build_sec": build_sec,
            "special_values": len(special), "special_byte_equal": special_equal,
            "minus_nan_written": "-nan" in text, "wide_block": wide,
            "card": card_name, "power_limit": power}
    print(json.dumps(line), flush=True)
    if not special_equal or "-nan" in text or not wide["byte_equal"]:
        raise SystemExit("chainio: the native formatter's text differs from the plain "
                         "version's")


def drain_parts(sampler, wall, drains, stash):
    """The drain and checkpoint of ``sampler``'s last ``sample()`` broken
    down (``io_seconds``): each part's host ms a drain and its share of the
    wall; and one drain's cold rows formatted natively and by the plain
    version, with the plain version's share of the wall had it formatted
    every drain. Fails if the two formatters' text differs."""
    sec = sampler.io_seconds
    parts = {p: sec.get(p, 0.0) for p in DRAIN_PARTS}
    fmt = format_timings(stash["rows"])
    if not fmt["byte_equal"]:
        raise SystemExit("drain: the native formatter's rows differ from the plain version's")
    return {
        "drains": drains,
        "ms_per_drain": {p: 1e3 * v / drains for p, v in parts.items()},
        "share_of_wall": {p: v / wall for p, v in parts.items()},
        "format_one_drain": fmt,
        "plain_format_share_of_wall": fmt["plain_ms"] * drains / 1e3 / wall,
    }


def iterations(sampler, kind):
    """The iterations of jump ``kind`` (0 where the cycle has none)."""
    kinds = [j.kind for j in sampler.config.jumps]
    if kind not in kinds:
        return 0
    return int(sampler.state.counters.jump_proposed[kinds.index(kind), 0, 0])


def jump_counts(cfg, state):
    """Each jump's proposals and acceptances over the cold chains."""
    ctr = state.counters
    prop = ctr.jump_proposed[:, 0].sum(-1).tolist()
    acc = ctr.jump_accepted[:, 0].sum(-1).tolist()
    return {name: {"proposed": p, "accepted": a, "rate": a / p if p else None}
            for name, p, a in zip(cfg.jump_names(), prop, acc)}


def drain_stats(seconds, wall):
    drains, ckpts = seconds["_drain_block"], seconds["_save_checkpoint"]
    out = {
        "drains": len(drains),
        "drain_ms_per_block": 1e3 * float(np.mean(drains)),
        "drain_share": float(np.sum(drains)) / wall,
        "checkpoint_ms_per_drain": 1e3 * float(np.mean(ckpts)),
        "checkpoint_share": float(np.sum(ckpts)) / wall,
        "neff_sec": float(np.sum(seconds["_neff_value"])),
    }
    if seconds["busy_after"]:
        out["drains_hidden"] = int(np.sum(seconds["busy_after"]))
    return out


def same_files(a, b):
    """Whether two output directories hold the same files with the same
    bytes (a checkpoint ``.npz`` by its arrays: the zip stamps its time)."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            with np.load(pa) as x, np.load(pb) as y:
                if x.files != y.files or any(
                        x[k].dtype != y[k].dtype or x[k].shape != y[k].shape
                        or x[k].tobytes() != y[k].tobytes() for k in x.files):
                    return False
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                while True:
                    ca, cb = fa.read(1 << 24), fb.read(1 << 24)
                    if ca != cb:
                        return False
                    if not ca:
                        break
    return True


def curved_sampler(model, outdir, callables="bound", nchains=None, grads=True, **kw):
    """``PTSampler`` on the curved model as a user writes it: its bound
    methods (the kernel route) or torch lambdas of them (the plain route),
    with or without the gradient callables."""
    from ptmcmcsampler_torch import PTSampler

    fns = (model.lnlikefn, model.lnpriorfn, model.lnlikefn_grad, model.lnpriorfn_grad)
    if callables == "lambda":
        fns = tuple((lambda f: lambda x: f(x))(f) for f in fns)
    grad_kw = dict(logl_grad=fns[2], logp_grad=fns[3]) if grads else {}
    return PTSampler(2, fns[0], fns[1], np.eye(2), ntemps=T,
                     nchains=C if nchains is None else nchains, outDir=outdir, **grad_kw, **kw)


def phase_sampler(model, card, path1_iters_per_sec, wrappers):
    """The sampler phase of the docstring. ``wrappers`` maps each kernel
    wrapper's name to it. Returns ``(result, chees_launches)``: the JSON
    line's dict and ``chees_step``'s launches in the full-width run and in
    the resume."""
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.diagnostics import moment_gate, split_rhat

    dev = torch.device(DEVICE)
    root = tempfile.mkdtemp(prefix="chip_smoke_sampler_")
    outdir = os.path.join(root, "chains")
    try:
        # (a) Full width, the kernel route, the overlapped loop.
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        seconds = {}
        with contextlib.redirect_stdout(sys.stderr), stash_rows({}) as stash:
            s = curved_sampler(model, outdir, seed=7)
            time_drains(s, seconds)
            t0 = time.time()
            s.sample([-0.1, -0.5], SAMPLER_ITERS, **SAMPLER_KW)
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = counted_launches(s.block_stats, wrappers)
        peak_mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        chees_iters = iterations(s, KIND_CHEES)
        log(f"sampler: route {s.route}, {chees_iters} ChEES iterations, launches {launches}, "
            f"{SAMPLER_ITERS} iterations in {wall:.1f}s")
        if s.route != "kernel":
            raise SystemExit(f"sampler: route {s.route!r}, expected the kernel route")
        if chees_iters == 0 or launches["chees_step"] != chees_iters or any(
                n for name, n in launches.items() if name != "chees_step"):
            raise SystemExit("sampler: chees_step did not launch once per ChEES iteration, or "
                             f"another kernel launched: {launches}")
        thin = SAMPLER_KW["thin"]
        rows = 1 + SAMPLER_ITERS // thin
        chains = s.chains[::GATE_STRIDE, SAMPLER_GATE_FROM // thin + 1:]  # [Csub, N, D]
        target, _ = model.posterior_moments()
        ok, max_z, ess = moment_gate(chains, target)
        text = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
        sidecar = os.path.getsize(os.path.join(outdir, "chain_all_1.0.bin"))
        with open(os.path.join(outdir, "jumps.txt")) as f:
            listed = tuple(line.split()[0] for line in f)
        with open(os.path.join(outdir, "checkpoint.npz.json")) as f:
            meta = json.load(f)
        checks = {
            "chain text rows x columns": (text.shape, (rows, 2 + 4)),
            "chain_all_1.0.bin bytes": (sidecar, rows * C * D * 4),
            "jumps.txt": (listed, s.config.jump_names()),
            "four jumps": (len(listed), 4),
            "checkpoint iter": (meta["iter"], SAMPLER_ITERS),
            "chains window": (s.chains_row0, 0),
        }
        for what, (got, want) in checks.items():
            if got != want:
                raise SystemExit(f"sampler: {what} is {got}, expected {want}")
        if not torch.isfinite(s.state.x).all():
            raise SystemExit("sampler: state is not finite")
        name, power = [v.strip() for v in card.split(",", 1)]
        result = {
            "phase": "sampler",
            "route": s.route,
            "loop": "overlapped",
            "graphs": s.block_stats.summary(),
            "iters_per_sec": SAMPLER_ITERS / wall,
            "path1_run_block_iters_per_sec": path1_iters_per_sec,
            "wall_sec": wall,
            **drain_stats(seconds, wall),
            "drain_parts": drain_parts(s, wall, SAMPLER_ITERS // SAMPLER_KW["isave"], stash),
            "checkpoint_bytes": os.path.getsize(os.path.join(outdir, "checkpoint.npz")),
            "ess_per_sec": float(ess.min()) / wall,
            "ess_min_dim": float(ess.min()),
            "ess_chains_used": int(chains.shape[0]),
            "ess_rows_used": int(chains.shape[1]),
            "moments_ok": ok,
            "moments_max_z": max_z,
            "rhat_max": float(np.nanmax(split_rhat(chains))),
            "chees_iterations": chees_iters,
            "launches": launches,
            "peak_mem_gb": peak_mem_gb,
            "rows": int(text.shape[0]),
            "sidecar_bytes": sidecar,
            "card": name,
            "power_limit": power,
        }
        del chains, s
        if not ok:
            print(json.dumps(result), flush=True)
            raise SystemExit(f"sampler: moment gate failed (max z {max_z})")

        # (b) Resume to SAMPLER_RESUME_ITERS from the checkpoint.
        for w in wrappers.values():
            w.launches = 0
        with contextlib.redirect_stdout(sys.stderr):
            s = curved_sampler(model, outdir, seed=7, resume=True)
            time_drains(s, seconds)
            t0 = time.time()
            s.sample([-0.1, -0.5], SAMPLER_RESUME_ITERS, **SAMPLER_KW)
            torch.cuda.synchronize()
            wall = time.time() - t0
        resumed_launches = counted_launches(s.block_stats, wrappers)
        resumed_iters = iterations(s, KIND_CHEES) - chees_iters
        rows = 1 + SAMPLER_RESUME_ITERS // thin
        text_rows = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2).shape[0]
        series = {}
        for jump in s.config.jump_names():
            with open(os.path.join(outdir, jump + "_jump.txt")) as f:
                series[jump] = len(f.readlines())
        log(f"sampler resume: from {s._resume_start_iter}, {text_rows} rows, series {series}, "
            f"{resumed_iters} ChEES iterations, launches {resumed_launches}")
        drains = SAMPLER_RESUME_ITERS // SAMPLER_KW["isave"]
        if (s._resume_start_iter != SAMPLER_ITERS or text_rows != rows
                or set(series.values()) != {drains} or resumed_iters == 0
                or resumed_launches["chees_step"] != resumed_iters
                or any(n for k, n in resumed_launches.items() if k != "chees_step")
                or s.state.it != SAMPLER_RESUME_ITERS or not torch.isfinite(s.state.x).all()):
            raise SystemExit("sampler: the resume from the checkpoint failed its checks")
        result["resume"] = {
            "from_iter": s._resume_start_iter, "to_iter": s.state.it, "rows": text_rows,
            "jump_series_lines": drains, "chees_iterations": resumed_iters,
            "launches": resumed_launches,
            "iters_per_sec": (SAMPLER_RESUME_ITERS - SAMPLER_ITERS) / wall, "wall_sec": wall,
            **drain_stats(seconds, wall),
        }
        del s

        # (c) The serial loop (a neff too large to stop the run) against the
        # overlapped one, SERIAL_ITERS iterations each from the same seed:
        # the same bytes in every file, and each loop's wall.
        loops = {}
        for loop, neff in (("overlapped", None), ("serial", 10**12)):
            seconds = {}
            with contextlib.redirect_stdout(sys.stderr), stash_rows({}) as stash:
                s = curved_sampler(model, os.path.join(root, loop), seed=7)
                time_drains(s, seconds, sync=neff is not None)
                t0 = time.time()
                s.sample([-0.1, -0.5], SERIAL_ITERS, neff=neff, **SAMPLER_KW)
                torch.cuda.synchronize()
                wall = time.time() - t0
            stats = drain_stats(seconds, wall)
            loops[loop] = {"iters_per_sec": SERIAL_ITERS / wall, "wall_sec": wall,
                           "iters_per_sec_without_neff": SERIAL_ITERS / (wall - stats["neff_sec"]),
                           "replayed_share": s.block_stats.summary()["replayed_share"], **stats,
                           "drain_parts": drain_parts(
                               s, wall, SERIAL_ITERS // SAMPLER_KW["isave"], stash)}
            del s
        same = same_files(os.path.join(root, "overlapped"), os.path.join(root, "serial"))
        log(f"sampler serial vs overlapped: {loops}, files equal: {same}")
        result["serial_vs_overlapped"] = {"iters": SERIAL_ITERS, "files_equal": same, **loops}
        if not same:
            print(json.dumps(result), flush=True)
            raise SystemExit("sampler: the overlapped and the serial loop wrote different files")

        # (d) The plain route: torch lambdas, no functor. With gradients the
        # card is refused (a kernel wrapper there launches or raises);
        # without, SCAM/AM/DE run on the card and no kernel launches.
        try:
            curved_sampler(model, os.path.join(root, "refused"), callables="lambda",
                           nchains=PLAIN_C, seed=11, verbose=False)
        except NotImplementedError as e:
            refusal = str(e)
        else:
            raise SystemExit("sampler: torch lambdas with gradients were not refused on the "
                             "card")
        if 'device="cpu"' not in refusal:
            raise SystemExit(f"sampler: the refusal does not name the CPU: {refusal}")
        log(f"sampler plain route with gradients refused: {refusal}")
        for w in wrappers.values():
            w.launches = 0
        with contextlib.redirect_stdout(sys.stderr):
            s = curved_sampler(model, os.path.join(root, "plain"), callables="lambda",
                               nchains=PLAIN_C, grads=False, seed=11)
            t0 = time.time()
            s.sample([-0.1, -0.5], PLAIN_ITERS, **PLAIN_KW)
            torch.cuda.synchronize()
            wall = time.time() - t0
        plain_launches = counted_launches(s.block_stats, wrappers)
        jumps = s.config.jump_names()
        post = s.chains[:, PLAIN_KW["burn"] // PLAIN_KW["thin"] + 1:]
        plain_ok, plain_z, _ = moment_gate(post, target)
        log(f"sampler plain route: route {s.route}, jumps {jumps}, launches {plain_launches}, "
            f"gate ok {plain_ok} max z {plain_z:.3f}, {wall:.1f}s")
        if s.route != "plain" or len(jumps) != 3 or any(plain_launches.values()):
            raise SystemExit("sampler: the plain route chose a kernel, kept a gradient jump or "
                             "launched a kernel")
        if not torch.isfinite(s.state.x).all():
            raise SystemExit("sampler: the plain route's state is not finite")
        result["plain"] = {
            "route": s.route, "chains": [T, PLAIN_C], "iters": PLAIN_ITERS,
            "iters_per_sec": PLAIN_ITERS / wall, "jumps": list(jumps),
            "launches": plain_launches, "moments_ok": plain_ok, "moments_max_z": plain_z,
            "with_gradients": "refused", "graphs": s.block_stats.summary(),
        }
        return result, {"sampler": launches["chees_step"],
                        "sampler_resume": resumed_launches["chees_step"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def wide_counts(name, d, iters=None, c=C):
    """``(block, burn, timed, cuts, stride)`` of a wide workload at ``T x C``
    chains or, with ``c``, as many on ``T * C / c`` rungs: bench.py's
    block cap (history ``[block, T, D, C]`` near 1.5 GB, bench.py:158-161;
    at least 50 iterations, as bench.py, up to 256-D, and 10 past it, where
    50 would hold up to 27 GB),
    ``iters`` (WIDE_ITERS by default) rounded to the block as bench.py
    rounds its counts, the cuts
    against bench.py's counts, and bench.py's ESS stride (cold chains kept
    near 4 GB, bench.py:243)."""
    block = max(50 if d <= 256 else 10, min(BLOCK, int(1.5e9 // (T * C * d * 4))))

    def rounded(n):
        return max(block, n // block * block)

    burn, timed = (rounded(n) for n in (iters or WIDE_ITERS)[name])
    cuts = {what: {"bench": rounded(bench), "run": run}
            for what, bench, run in (("burn_iters", BURN_ITERS, burn),
                                     ("timed_iters", TIMED_ITERS, timed))
            if run < rounded(bench)}
    stride = max(1, int(np.ceil(timed * d * c * 4 / 4e9)))
    return block, burn, timed, cuts, stride


def wide_config(d, burn, cov_update=1000):
    """Path 1's cycle on a wide workload, bench.py's settings (adaptation
    over the first half of ``burn``)."""
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps

    return SamplerConfig(
        ndim=d, ntemps=T, nchains=C, groups=(tuple(range(d)),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20, burn=burn // 2,
            have_grads=True,
        ),
        tskip=5, cov_update=cov_update, burn=burn // 2, thin=1, de_size=2000,
        hmc_stepsize=HMC_EPS,
    )


def phase_wide_path(name, card, max_err, chees_ptxas, iters=WIDE_ITERS):
    """Path 1's cycle on the wide workload ``name`` at 8 x 16384 chains
    (``chees_step`` once per ChEES iteration, the trajectory entry never),
    then ChEES iterations alone under the profiler (100 on hierarchical, 20
    on the others) for the device ms of one, then the wide kernel's timings
    on the final state. Prints the workload's JSON line; returns its kernel
    item."""
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories

    model, x0 = wide_workload(name)
    d = model.ndim
    block, burn, timed, cuts, stride = wide_counts(name, d, iters)
    cfg = wide_config(d, burn)
    state, (step, run_block), result, ok = phase_main_path(
        model, card, name, cfg, {KIND_CHEES: chees_step}, absent=(chees_trajectories,), x0=x0,
        burn=burn, timed=timed, block=block, stride=stride,
        compare_iters=PROFILE_ITERS if d <= 64 else (20 if d <= 512 else 10))
    state, prof = phase_profile(state, advance_kind(run_block, cfg, KIND_CHEES), name,
                                iters=PROFILE_ITERS if name == "hierarchical" else 20,
                                iterations=f"{KIND_CHEES} only, graphs")
    del run_block
    result.update(
        workload=name, block=block, burn_iters=burn, timed_iters=timed, gate_stride=stride,
        cuts=cuts,
        chees_device_ms_per_iter=prof["device_ms_per_iter"],
        chees_eps=state.stepsize.chees_eps[:, 0].tolist(),
        chees_tlen=state.stepsize.chees_tlen[:, 0].tolist(),
    )
    launches = result["launches"][KIND_CHEES]
    item = wide_kernel_entry(name, model, state, cfg, launches, max_err, chees_ptxas)
    result["chees_kernel_ms"] = item["fused_ms"]
    result["gate_enforced"] = name not in GATE_PRINTED_ONLY
    del state, step
    torch.cuda.empty_cache()
    print_result(result, ok or not result["gate_enforced"])
    return item


# The wide functors' classes in csrc/models.cuh, as ptxas names them.
# A registered user functor's entries instantiate WidePerChain<its struct>.
WIDE_CLASSES = {"correlated_gaussian": "WideCorrelatedGaussian",
                "interval_gaussian": "WideIntervalGaussian",
                "hierarchical_gaussian": "WideHierarchicalGaussian",
                "user_hierarchy": "WidePerChain,user_hierarchy_functor",
                "user_ref_gaussian": "WidePerChain,user_ref_gaussian_functor"}


def product_ops(m):
    """Operations of one product ``m v`` or ``m^T v`` counting only the
    nonzero entries of ``m``: an output of n terms takes n multiplies and
    n - 1 additions. The path's ``chol`` and ``chol_inv`` are lower
    triangular (a Cholesky factor and its inverse: D^2 each), and with
    ``mass_adapt`` off, as on bench.py's paths, the identity (D each)."""
    return 2 * int(torch.count_nonzero(m)) - m.shape[0]


def matvec_barriers(d, structure):
    """``__syncthreads`` a wide product takes (csrc/models.cuh wide_matvec):
    one a tile and one after the sums, or the diagonal pass's one."""
    return 1 if structure == "diagonal" else -(-d // 16) + 1


def model_barriers(functor, d):
    """A wide functor's eval: the correlated model's S product among three
    passes, the interval model's one pass, the hierarchy's two."""
    return {"correlated_gaussian": matvec_barriers(d, "dense") + 3, "interval_gaussian": 1,
            "hierarchical_gaussian": 2}[functor]


def evaluation_barriers(functor, d, structure):
    """A wide evaluation's barriers (models.cuh wide_evaluate): the two
    whitening products around the model."""
    return 2 * matvec_barriers(d, structure) + model_barriers(functor, d)


def chees_barriers(functor, d, structure):
    """A wide ChEES leapfrog step's barriers (csrc/chees_trajectory.cu): the
    one after the first half step, then with a diagonal factor the model
    alone (its products folded into the half steps), else the evaluation."""
    if structure == "diagonal":
        return 1 + model_barriers(functor, d)
    return 1 + evaluation_barriers(functor, d, structure)


def barriers_counted_from_code():
    """The line of barrier counts: counted from the code, not measured."""
    counts = {}
    for name in WIDE_ITERS:
        model = wide_workload(name)[0]
        functor, d = model.cuda_functor, model.ndim
        counts[name] = {"functor": functor, "ndim": d, **{
            st: {"chees_step": chees_barriers(functor, d, st),
                 "evaluation": evaluation_barriers(functor, d, st)}
            for st in ("diagonal", "dense")}}
    return {"counted_from_code": {"what": "__syncthreads a wide ChEES leapfrog step and a "
                                          "wide evaluation take, by structure tag",
                                  "wide_barriers": counts}}


def wide_kernel_entry(name, model, state, cfg, launches, max_err, chees_ptxas):
    """The wide entries of ``model``'s functor timed on inputs from the
    workload's final state, as ``chees_kernel_entry`` does for the curved
    ones; the plain versions on the first WIDE_PLAIN_COLUMNS chains a rung
    (all of them where it has no entry). Then the
    lane efficiency of the lengths in the wide layout's groups, the capped
    timings (every chain at the largest length: the whole batch, and one
    group alone), one leapfrog step's two whitening products as
    ``torch.matmul`` (TF32 off, PyTorch's default), the layout and the
    ptxas report of the functor's kernels."""
    from ptmcmcsampler_torch.ops.chees import (
        chees_step, chees_step_plain, chees_trajectories, chees_trajectories_plain,
        lane_efficiency,
    )
    from ptmcmcsampler_torch.ops.common import wide_group

    d, functor = model.ndim, model.cuda_functor
    nb = wide_group(d)
    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    chol, chol_inv = state.adapt.chol, state.adapt.chol_inv
    structure = state.adapt.structure
    ss = state.stepsize
    eps = ss.chees_eps.contiguous()
    tlen = torch.maximum(ss.chees_tlen, eps)
    u = torch.rand((T, C), generator=gen, device=dev) * (1.0 - 1e-3) + 1e-3
    max_steps = cfg.chees_max_steps
    nsteps = torch.clamp(torch.ceil(u * tlen / eps), 1, max_steps).to(torch.int32)
    q0 = (chol_inv.T @ state.x).contiguous()
    p0 = torch.randn((T, d, C), generator=gen, device=dev)
    args = (q0, p0, state.betas, eps, nsteps, chol, model, structure)
    fused = (state.x, p0, u, state.betas, eps, ss.chees_tlen.contiguous(), HMC_EPS, max_steps,
             chol, chol_inv, model, structure)
    reps = 20 if d <= 64 else 5
    kernel_ms = cuda_ms(lambda: chees_trajectories(*args), reps, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: chees_trajectories(*args), reps)
    fused_ms = cuda_ms(lambda: chees_step(*fused), reps, hold_stream=True)
    fused_wrapper_ms = cuda_ms(lambda: chees_step(*fused), reps)
    pc = LARGE_PLAIN_COLUMNS.get(name, WIDE_PLAIN_COLUMNS.get(name, C))
    sub = [a[..., :pc].contiguous() if torch.is_tensor(a) and a.dim() > 1 and a.shape[-1] == C
           else a for a in args]
    plain_ms = once_ms(lambda: chees_trajectories_plain(*sub))
    sub = [a[..., :pc].contiguous() if torch.is_tensor(a) and a.dim() > 1 and a.shape[-1] == C
           else a for a in fused]
    fused_plain_ms = once_ms(lambda: chees_step_plain(*sub))
    del sub
    out = chees_step(*fused)
    z1, r1, _ = chees_trajectories(out[1], p0, state.betas, eps, nsteps, chol, model, structure)
    if not (torch.equal(out[2], z1) and torch.equal(out[3], r1)):
        raise SystemExit(f"{name}: the fused ChEES step's trajectories differ from the "
                         "trajectory entry's")
    del out, z1, r1
    library_ms = whitening_library_ms(chol, d, reps)
    steps = int(nsteps.sum())
    max_nsteps = int(nsteps.max())
    nprm = model.cuda_params(dev).numel()
    per_eval = 2 * product_ops(chol) + WIDE_MODEL_OPS[functor](d)
    ops = per_eval * (steps + T * C) + 6 * d * steps  # + the starting evaluation
    bytes_moved = 4 * (4 * d + 3) * T * C + 4 * (T + d * d + nprm)
    bound_ms, bound_by = bound(bytes_moved, ops)
    fused_bytes = 4 * (6 * d + 5) * T * C + 4 * (T + 2 * d * d + nprm)
    fused_ops = ops + T * C * (product_ops(chol_inv) + 4 * d + OPS_PER_CHEES_CHAIN)
    fused_bound_ms, fused_bound_by = bound(fused_bytes, fused_ops)
    step_bound_us = 1e6 * (per_eval + 6 * d) * T * C / F32_OPS_PER_S
    capped = {}
    for label, t, c, n in (("batch", T, C, 3), ("group", 1, nb, 10)):
        a = (q0[:t, :, :c].contiguous(), p0[:t, :, :c].contiguous(), state.betas[:t].contiguous(),
             eps[:t, :c].contiguous(),
             torch.full((t, c), max_nsteps, dtype=torch.int32, device=dev), chol, model,
             structure)
        ms = cuda_ms(lambda: chees_trajectories(*a), n, hold_stream=True)
        capped[f"capped_{label}_ms"] = ms
        capped[f"capped_{label}_us_per_step"] = 1e3 * ms / max_nsteps
    ptxas = {k: v for k, v in chees_ptxas.items() if WIDE_CLASSES[functor] in k}
    layout = wide_layout(d, ptxas, dev, chains_per_block=256)
    step_ops = (per_eval + 6 * d) * T * C  # a capped step over the batch
    extra = {
        "workload": name, "ndim": d, "functor": functor, "factor_structure": structure,
        "capped_us_per_step": capped["capped_batch_us_per_step"],
        "ordered_f32_share": step_ops / (1e-6 * capped["capped_batch_us_per_step"])
        / ORDERED_F32_OPS_PER_S,
        "launches_by_path": {name: launches},
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "plain_chains": [T, pc],
        "fused_ms": fused_ms, "fused_wrapper_ms": fused_wrapper_ms,
        "fused_plain_ms": fused_plain_ms, "fused_bound_ms": fused_bound_ms,
        "fused_bound_by": fused_bound_by,
        "library_what": "one leapfrog step's two whitening products, torch.matmul "
                        "[D, D] x [T, D, C] twice",
        "lane_efficiency_unsorted": lane_efficiency(nsteps, grouped=False, lanes=nb),
        "lane_efficiency_sorted": lane_efficiency(nsteps, grouped=True, lanes=nb),
        "mean_nsteps": steps / (T * C), "max_nsteps": max_nsteps, **capped,
        "step_bound_us": step_bound_us, "whitening_ops_per_product": product_ops(chol),
        "ptxas": ptxas or "not measured (built before)", **layout,
    }
    log(f"wide ChEES {name}: trajectory entry {kernel_ms:.4f} ms, fused step {fused_ms:.4f} ms "
        f"(bound {fused_bound_ms:.4f}, {fused_bound_by}), plain {plain_ms:.1f} / "
        f"{fused_plain_ms:.1f} ms at {T} x {pc}, two matmuls {library_ms:.4f} ms; {extra}")
    return {
        "name": f"chees_trajectory_{functor}",
        "route": "cuda",
        "source": "ptmcmcsampler_torch/csrc/chees_trajectory.cu",
        "replaces": "ptmcmcsampler_tpu/ops/chees_pallas.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        **extra,
    }


#: One drain's cold rows of each wide sampler run, by workload (the first
#: run's), which the chainio phase formats again.
WIDE_ROWS = {}


def phase_wide_sampler(card, wrappers, name="hierarchical", register=None,
                       sample_kw=WIDE_SAMPLER_KW, phase="wide_sampler"):
    """``PTSampler`` with the bound methods of the hierarchy of the wide
    workload ``name`` (bench.py's 50-D one, or LARGE_SAMPLER's 270-D) on the
    card (the kernel route): 8 x 1024 chains, the cycle of ``sample_kw``
    (SCAM/AM/DE/ChEES/NUTS/HMC by default) and the user's jumps that
    ``register(sampler, model)`` adds (config 4's, in 9e), WIDE_SAMPLER_ITERS
    iterations, files in a temporary directory. ``chees_step``,
    ``nuts_trees`` and ``hmc_step`` must each launch once per iteration of
    their kind and the trajectory entries never; every jump must run, the
    user's torch-native and inside the graphs (no "host jump" iteration);
    the chain files must have their rows, ``jumps.txt`` a row a jump and
    each ``<name>_jump.txt`` a value a save; the moment gate must pass on
    the rows past iteration 1000. Then a 1025-D ``CorrelatedGaussian``
    (beyond the wide layout's 1024) must be refused when ``sample()``
    starts, naming ``device="cpu"``, before any iteration or launch.
    Returns ``(result, launches by wrapper)``; the result's ``"phase"`` is
    ``phase``."""
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.config import KIND_CHEES, KIND_HMC, KIND_NUTS
    from ptmcmcsampler_torch.diagnostics import moment_gate
    from ptmcmcsampler_torch.models import CorrelatedGaussian

    dev = torch.device(DEVICE)
    model = wide_workload(name)[0]
    d = model.ndim
    root = tempfile.mkdtemp(prefix="chip_smoke_wide_sampler_")

    def make(m, outdir):
        return PTSampler(m.ndim, m.lnlikefn, m.lnpriorfn, np.eye(m.ndim),
                         logl_grad=m.lnlikefn_grad, logp_grad=m.lnpriorfn_grad,
                         ntemps=T, nchains=WIDE_SAMPLER_C, outDir=outdir, seed=7)

    try:
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        outdir = os.path.join(root, "chains")
        with contextlib.redirect_stdout(sys.stderr), stash_rows({}) as stash:
            s = make(model, outdir)
            if register is not None:
                register(s, model)
            t0 = time.time()
            s.sample(np.zeros(d), WIDE_SAMPLER_ITERS, **sample_kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
        parts = drain_parts(s, wall, WIDE_SAMPLER_ITERS // sample_kw["isave"], stash)
        WIDE_ROWS.setdefault(name, stash["rows"])
        launches = counted_launches(s.block_stats, wrappers)
        iters = {kind: iterations(s, kind) for kind in (KIND_CHEES, KIND_NUTS, KIND_HMC)}
        thin = sample_kw["thin"]
        rows = 1 + WIDE_SAMPLER_ITERS // thin
        text = np.loadtxt(os.path.join(outdir, "chain_1.0.txt"), ndmin=2)
        sidecar = os.path.getsize(os.path.join(outdir, "chain_all_1.0.bin"))
        target, _ = model.posterior_moments()
        ok, max_z, ess = moment_gate(s.chains[:, 1000 // thin + 1:], target)
        names = s.config.jump_names()
        with open(os.path.join(outdir, "jumps.txt")) as f:
            jumps_rows = [line.split()[0] for line in f]
        series = {len(np.loadtxt(os.path.join(outdir, f"{n}_jump.txt"), ndmin=1))
                  for n in names}
        counts = jump_counts(s.config, s.state)
        protocols = {j.name: j.protocol for j in s._custom_jumps + s._aux_jumps}
        graphs = s.block_stats.summary()
        log(f"{phase} {name}: route {s.route}, jumps {counts}, launches {launches}, "
            f"{WIDE_SAMPLER_ITERS} iterations in {wall:.1f}s, gate ok {ok} max z {max_z:.3f}")
        checks = {
            "route": (s.route, "kernel"),
            "chees_step launches": (launches["chees_step"], iters[KIND_CHEES]),
            "nuts_trees launches": (launches["nuts_trees"], iters[KIND_NUTS]),
            "hmc_step launches": (launches["hmc_step"], iters[KIND_HMC]),
            "trajectory entries' launches": (launches["chees_trajectories"]
                                             + launches["hmc_trajectories"], 0),
            "chain text rows x columns": (text.shape, (rows, d + 4)),
            "chain_all_1.0.bin bytes": (sidecar, rows * WIDE_SAMPLER_C * d * 4),
            "finite state": (bool(torch.isfinite(s.state.x).all()), True),
            "moment gate": (ok, True),
            "every jump ran": (all(c["proposed"] for c in counts.values()), True),
            "the user's jumps torch-native": (set(protocols.values()) <= {"torch"}, True),
            "host jump iterations": (graphs["eager"]["host jump"], 0),
            "jumps.txt rows": (jumps_rows, list(names)),
            "jump series": (series, {WIDE_SAMPLER_ITERS // sample_kw["isave"]}),
        }
        for what, (got, want) in checks.items():
            if got != want:
                raise SystemExit(f"{phase}: {what} is {got}, expected {want}")
        del s

        for w in wrappers.values():
            w.launches = 0
        big = CorrelatedGaussian(ndim=1025)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                s = make(big, os.path.join(root, "refused"))
                s.sample(np.clip(big.mu, 0.1, 9.9), 100, **WIDE_SAMPLER_KW)
        except NotImplementedError as e:
            refusal = str(e)
        else:
            raise SystemExit(f"{phase}: the 1025-D model on the card was not refused")
        log(f"{phase}: 1025-D CorrelatedGaussian refused: {refusal}")
        if ("got 1025" not in refusal or 'device="cpu"' not in refusal or s.state is not None
                or any(w.launches for w in wrappers.values())):
            raise SystemExit(f"{phase}: the refusal is not the expected one: {refusal}")
        card_name, power = [v.strip() for v in card.split(",", 1)]
        result = {
            "phase": phase, "model": "HierarchicalGaussian", "workload": name,
            "ndim": d,
            "chains": [T, WIDE_SAMPLER_C], "iters": WIDE_SAMPLER_ITERS,
            "iters_per_sec": WIDE_SAMPLER_ITERS / wall, "wall_sec": wall,
            "iterations_by_kind": iters, "launches": launches, "jumps": counts,
            "protocols": protocols, "moments_ok": ok, "moments_max_z": max_z, "ess_min_dim": float(ess.min()),
            "rows": int(text.shape[0]), "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "graphs": graphs, "drain_parts": parts,
            "refused_1025d": refusal, "card": card_name, "power_limit": power,
        }
        return result, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- Path 2 (NUTS and HMC) on the wide workloads ----

def wide_tree_inputs(gen, dev, model, c, depth, factor="dense"):
    """The wide NUTS kernel's arguments but the model, around ``wide_inputs``'
    positions and factor: NUTS draws as proposals/nuts.py draws them, rung t
    at step size base * 1.3**t, about 2% of lanes at eps <= 0 (they search
    their step size first). The base is WIDE_EPS, but WIDE_TREE_EPS_BOX for
    the correlated model, whose clamped starts lie near its box's faces: at
    WIDE_EPS nearly every first leaf leaves the box and ends the tree."""
    from ptmcmcsampler_torch.ops import common
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    x, _, _, betas, *_, chol, chol_inv = wide_inputs(gen, dev, model, c, 1, factor=factor)
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, model.ndim, c, depth, dev)
    base = WIDE_EPS if hasattr(model, "posterior_moments") else WIDE_TREE_EPS_BOX
    eps = (base * 1.3 ** torch.arange(T, device=dev, dtype=torch.float32))[:, None]
    eps = eps.expand(T, c).contiguous()
    eps[:, ::97] = 0.0
    eps[:, 13::89] = -1.0
    q0 = common.matvec(chol_inv.T, x, FACTOR_TAGS[factor]).contiguous()
    return (q0, r0, betas, eps, expo, dirs, accu, key, chol), r_eps


def wide_columns(c, dev):
    """The columns (chains a rung) on which the wide NUTS and HMC checks run
    the plain version: the first and the last WIDE_PLAIN_COLUMNS_NUTS / 2,
    so both ends of the grid and the last group are checked. A chain's
    arithmetic is its own, so the kernel's outputs there must equal the plain
    version's."""
    n = WIDE_PLAIN_COLUMNS_NUTS
    if n >= c:
        return None
    return torch.cat([torch.arange(n // 2, device=dev), torch.arange(c - n // 2, c, device=dev)])


def phase_wide_nuts_hmc_vs_plain(name, model):
    """The wide NUTS and HMC entries of ``model``'s functor against their
    plain versions, the kernels at T x C chains (and ragged batches), the
    plain versions on ``wide_columns``: no lane may differ in any bit. With
    a dense factor, the cases below; with a diagonal and a lower triangular
    one (tags "diagonal" and "dense"), NUTS at depth 4 and the HMC cases
    eps=0.08 and ragged.
    NUTS at depth 4 and 10 (the reservoir's uniforms from the key against
    ``nuts_uniforms``, the in-kernel step-size search against
    ``find_reasonable_epsilon``); the fused HMC step at eps 0.08 and 5.0, at
    1e-4 (where the correlated model's trajectories stay inside its box), on
    a ragged batch and with nmax = nmin + 1, against ``hmc_step_plain`` fed
    the kernel's own draws (``hmc_kernel_draws``, whose lengths must equal
    ``hmc_draws``' and momenta lie within DRAW_ULP_TOL ulp), the trajectory
    entry against its plain version on those draws, and the step's end
    points against the trajectory entry's, bit for bit. Returns the largest
    error of each kernel (0.0 when every lane equals)."""
    from ptmcmcsampler_torch.ops import common
    from ptmcmcsampler_torch.ops.hmc import (
        hmc_draws, hmc_kernel_draws, hmc_step, hmc_step_plain, hmc_trajectories,
        hmc_trajectories_plain,
    )
    from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5151)
    d = model.ndim
    err = {"nuts": 0.0, "hmc": 0.0}

    def differ(label, out, ref):  # the error of outputs equal in every bit: 0
        n = lanes_differ(out, ref)
        if n:
            raise SystemExit(f"{label}: {n} lanes differ from the plain version")
        return 0.0

    nuts_cases = [("dense", 4), ("dense", NUTS_DEPTH), ("diagonal", 4), ("lower", 4)]
    for factor, depth in nuts_cases:
        args, r_eps = wide_tree_inputs(gen, dev, model, C, depth, factor)
        structure = FACTOR_TAGS[factor]
        t0 = time.time()
        out = nuts_trees(*args, model, r_eps=r_eps, structure=structure)
        torch.cuda.synchronize()
        kernel_s = time.time() - t0
        cols = wide_columns(C, dev)
        sub = take_columns(args, C, cols)
        sub_reps = take_columns([r_eps], C, cols)[0]
        key = args[7]
        resu = nuts_uniforms(key, depth, T, C)
        resu = resu if cols is None else resu.index_select(-1, cols).contiguous()
        t0 = time.time()
        ref = nuts_trees_plain(*sub[:7], resu, sub[8], model, sub_reps, structure)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        got = take_columns(out, C, cols)
        searched = args[3] <= 0
        label = (f"wide NUTS {name} (D={d}) {factor} factor ({structure}), depth {depth}, "
                 f"kernel {T} x {C}, "
                 f"plain {T} x {ref[0].shape[2]}")
        log(f"{label}: {lanes_differ(got, ref)} lanes differ in any output; trees "
            f"{tree_stats(out[4], out[5])}; search in {int(searched.sum())} lanes, found eps in "
            f"[{float(out[6][searched].min()):.4g}, {float(out[6][searched].max()):.4g}]; -inf "
            f"logp0 share {float(torch.isneginf(out[1]).float().mean()):.4f}; kernel "
            f"{kernel_s:.2f}s, plain {plain_s:.1f}s")
        if not bool((out[6] > 0).all()) or not torch.isfinite(out[0]).all():
            raise SystemExit(f"{label}: a step size <= 0 or a non-finite proposal")
        err["nuts"] = max(err["nuts"], differ(label, got, ref))
        del out, ref, got, args, r_eps, sub, resu

    factors = {f: wide_inputs(gen, dev, model, C, 1, factor=f)
               for f in ("dense", "diagonal", "lower")}
    ragged = (f"ragged {T} x {C - 100}", HMC_EPS, C - 100, HMC_NMIN, HMC_NMAX)
    hmc_cases = [("dense", case) for case in (
        ("eps=0.08", HMC_EPS, C, HMC_NMIN, HMC_NMAX), ("eps=5.0", 5.0, C, HMC_NMIN, HMC_NMAX),
        ("eps=1e-4", 1e-4, C, HMC_NMIN, HMC_NMAX), ragged,
        ("nmax = nmin + 1", HMC_EPS, C, HMC_NMIN, HMC_NMIN + 1))]
    for f in ("diagonal", "lower"):
        e = diagonal_eps(model, f, HMC_EPS)
        hmc_cases += [(f, (f"eps={e}", e, C, HMC_NMIN, HMC_NMAX)),
                      (f, (ragged[0], e, C - 100, HMC_NMIN, HMC_NMAX))]
    for factor, (label, eps, c, nmin, nmax) in hmc_cases:
        x, _, _, betas, *_, chol, chol_inv = factors[factor]
        structure = FACTOR_TAGS[factor]
        label = f"{factor} factor ({structure}), {label}"
        xc = x[..., :c].contiguous()
        key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
        args = (xc, betas, key, chol, chol_inv, eps, nmin, nmax, model, structure)
        x1, qxy = hmc_step(*args)
        p0, nsteps = hmc_kernel_draws(key, T, d, c, nmin, nmax, model)
        p0t, nstepst = hmc_draws(key, T, d, c, nmin, nmax)
        max_ulp = int(ulps(p0, p0t).max())
        if not torch.equal(nsteps, nstepst) or max_ulp > DRAW_ULP_TOL:
            raise SystemExit(f"wide HMC {name} {label}: the kernel's draws differ from "
                             f"hmc_draws (p0 within {max_ulp} ulp)")
        q0 = common.matvec(chol_inv.T, xc, structure)
        q1, qxyk = hmc_trajectories(q0, p0, betas, nsteps, chol, eps, model, structure)
        if lanes_differ((common.matvec(chol.T, q1, structure), qxyk), (x1, qxy)):
            raise SystemExit(f"wide HMC {name} {label}: the step's end points differ from the "
                             "trajectory entry's on the kernel's own draws")
        cols = wide_columns(c, dev)
        sub = take_columns((xc, p0, nsteps, q0), c, cols)
        ref = hmc_step_plain(sub[0], betas, (sub[1], sub[2]), chol, chol_inv, eps, nmin, nmax,
                             model, structure)
        tref = hmc_trajectories_plain(sub[3], sub[1], betas, sub[2], chol, eps, model, structure)
        got = take_columns((x1, qxy), c, cols)
        tgot = take_columns((q1, qxyk), c, cols)
        full = f"wide HMC {name} (D={d}) {label}, kernel {T} x {c}, plain {T} x {ref[1].shape[1]}"
        log(f"{full}: {lanes_differ(got, ref)} (step) and {lanes_differ(tgot, tref)} "
            f"(trajectory) lanes differ in any output; draws p0 within {max_ulp} ulp, nsteps "
            f"equal; -inf qxy share {float(torch.isneginf(qxy).float().mean()):.4f}")
        err["hmc"] = max(err["hmc"], differ(full, got, ref), differ(full, tgot, tref))
        del x1, qxy, p0, nsteps, p0t, nstepst, q0, q1, qxyk, ref, tref, got, tgot, sub
    del factors
    return err


def wide_nuts_config(d, burn, cov_update=1000):
    """Path 2's cycle (bench.py's grad_mode=nuts, bench.py:163-199) on a wide
    workload."""
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps

    return SamplerConfig(
        ndim=d, ntemps=T, nchains=C, groups=(tuple(range(d)),),
        jumps=build_default_jumps(
            SCAMweight=10, AMweight=10, DEweight=10, NUTSweight=10, HMCweight=10,
            burn=burn // 2, have_grads=True,
        ),
        tskip=5, cov_update=cov_update, burn=burn // 2, thin=1, de_size=2000,
        hmc_stepsize=HMC_EPS,
        hmc_nminsteps=HMC_NMIN, hmc_nmaxsteps=HMC_NMAX, nuts_max_depth=NUTS_DEPTH,
    )


def group_lane_efficiency(nalpha, nb):
    """Leaves the chains ran over the leaf slots their groups issued: a group
    of ``nb`` consecutive chains (the kernel's block) steps as long as its
    largest tree, so it issues ``nb`` times that tree's leaves."""
    n = nalpha.reshape(-1)
    pad = (-n.numel()) % nb
    groups = torch.cat([n, n.new_zeros(pad)]).view(-1, nb)
    return float(n.sum()) / float(nb * groups.max(dim=1).values.sum())


def phase_wide_nuts_path(name, card, err, ptxas, iters=WIDE_NUTS_ITERS):
    """Path 2's cycle on the wide workload ``name`` at T x C chains through
    ``build_step``/``run_block`` (the NUTS kernel once per NUTS iteration,
    ``hmc_step`` once per HMC iteration, the HMC trajectory entry never), the
    gate at 40-D and 50-D, gaussian200 finite with its split R-hat; the trees
    of one more call at the final state; NUTS iterations alone under the
    profiler; then the NUTS and HMC kernels' items. A workload of
    LARGE_NUTS_DEPTH runs all of it at that depth cap. Prints the
    workload's JSON line; returns ``(nuts_item, hmc_item)``."""
    from ptmcmcsampler_torch.config import KIND_HMC, KIND_NUTS
    from ptmcmcsampler_torch.ops.common import wide_group
    from ptmcmcsampler_torch.ops.hmc import hmc_step, hmc_trajectories
    from ptmcmcsampler_torch.ops.nuts import nuts_trees
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    global NUTS_DEPTH
    if name in LARGE_NUTS_DEPTH and NUTS_DEPTH != LARGE_NUTS_DEPTH[name]:
        saved, NUTS_DEPTH = NUTS_DEPTH, LARGE_NUTS_DEPTH[name]
        try:
            items = phase_wide_nuts_path(name, card, err, ptxas, iters)
        finally:
            NUTS_DEPTH = saved
        return items
    model, x0 = wide_workload(name)
    d = model.ndim
    block, burn, timed, cuts, stride = wide_counts(name, d, iters)
    if name in LARGE_NUTS_DEPTH:
        cuts["nuts_max_depth"] = {"bench": 10, "run": NUTS_DEPTH}
    cfg = wide_nuts_config(d, burn)
    state, (step, run_block), result, ok = phase_main_path(
        model, card, f"nuts/{name}", cfg, {KIND_NUTS: nuts_trees, KIND_HMC: hmc_step},
        absent=(hmc_trajectories,), x0=x0, burn=burn, timed=timed, block=block, stride=stride,
        compare_iters=PROFILE_ITERS if d <= 64 else (20 if d <= 512 else 10))
    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(96)
    q0 = (state.adapt.chol_inv.T @ state.x).contiguous()
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, d, C, NUTS_DEPTH, dev)
    tree_args = (q0, r0, state.betas, state.stepsize.epsilon.contiguous(), expo, dirs, accu, key,
                 state.adapt.chol, model)
    trees = nuts_trees(*tree_args, r_eps=r_eps)
    nalpha, alive = trees[4], trees[5]
    efficiency = group_lane_efficiency(nalpha, wide_group(d))
    del trees
    state, prof = phase_profile(state, advance_kind(run_block, cfg, KIND_NUTS), f"nuts/{name}",
                                iters=20 if d <= 64 else (5 if d <= 512 else 2),
                                iterations=f"{KIND_NUTS} only, graphs")
    del run_block
    result.update(
        workload=name, block=block, burn_iters=burn, timed_iters=timed, gate_stride=stride,
        cuts=cuts, nuts_eps=state.stepsize.epsilon.mean(1).tolist(),
        nuts_device_ms_per_iter=prof["device_ms_per_iter"],
        nuts_busy_share=prof["device_busy_share"], nuts_ops_per_iter=prof["device_ops_per_iter"],
        group_lane_efficiency=efficiency, **tree_stats(nalpha, alive),
    )
    launches = result["launches"]
    nuts_item = wide_nuts_entry(name, model, state, tree_args, r_eps, launches[KIND_NUTS],
                                err["nuts"], ptxas["nuts_tree"], efficiency)
    hmc_item = wide_hmc_entry(name, model, state, launches[KIND_HMC], err["hmc"],
                              ptxas["hmc_trajectory"])
    result["nuts_kernel_ms"] = nuts_item["ms"]
    result["hmc_kernel_ms"] = hmc_item["fused_ms"]
    result["gate_enforced"] = name not in GATE_PRINTED_ONLY
    del state, step, q0, r0, expo, dirs, accu, r_eps, tree_args
    torch.cuda.empty_cache()
    print_result(result, ok or not result["gate_enforced"])
    return nuts_item, hmc_item


def wide_layout(d, ptxas, dev, chains_per_block=None):
    """A wide kernel's layout as the kernels compute it (``kernel_layout``):
    groups of chains in blocks of 256 threads, ``chains_per_block`` chains a
    block (the ChEES kernel's 256; by default one group, as the NUTS and HMC
    kernels run), the tile stages and shared bytes, and from the ptxas
    report the blocks an SM and the waves at T x C chains."""
    layout = kernel_layout(d)
    nb, dyn_smem = layout["group_chains"], layout["dynamic_smem_bytes"]
    per_block = chains_per_block or nb
    layout.update(chains_per_block=per_block, threads_per_block=256)
    if ptxas:
        worst = max(ptxas.values(), key=lambda v: v["registers"])
        regs_warp = -(-worst["registers"] * 32 // 256) * 256
        by_smem = (228 * 1024) // (dyn_smem + worst["static_smem_bytes"] + 1024)
        per_sm = min(8, by_smem, 65536 // (regs_warp * 8))
        blocks = -(-T * C // per_block)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        layout.update(blocks_per_sm=per_sm, waves=-(-blocks // (per_sm * sms)))
    return layout


def whitening_library_ms(chol, d, reps):
    """One leapfrog step's two whitening products as ``torch.matmul`` (TF32
    off, PyTorch's default) over the batch: the wide kernels' yardstick."""
    q = torch.randn((T, d, C), device=chol.device)
    g = torch.randn_like(q)
    return cuda_ms(lambda: (torch.matmul(chol.T, q), torch.matmul(chol, g)), reps,
                   hold_stream=True)


def wide_nuts_entry(name, model, state, tree_args, r_eps, launches, max_err, ptxas, efficiency):
    """The wide NUTS kernel timed on the path's final state (its adapted step
    sizes), the plain version on the first WIDE_PLAIN_COLUMNS_NUTS chains a
    rung (past 256-D on LARGE_PLAIN_NUTS's rungs and chains), one leapfrog
    step's whitening products as ``torch.matmul``; the bound counts this
    call's leaves (each an evaluation, the leapfrog, the kinetic energy, on
    average one U-turn check and a Philox uniform) and doublings; then the
    capped timings: every tree at the depth cap, over the batch and over one
    group alone."""
    from ptmcmcsampler_torch.ops.common import wide_group
    from ptmcmcsampler_torch.ops.nuts import (
        nuts_trees, nuts_trees_plain, nuts_uniforms, wide_scratch_floats,
    )
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    d, functor = model.ndim, model.cuda_functor
    nb = wide_group(d)
    dev = state.x.device
    chol, structure = state.adapt.chol, state.adapt.structure
    reps = 5 if d <= 64 else (2 if d <= 512 else 1)
    kernel_ms = cuda_ms(lambda: nuts_trees(*tree_args, r_eps=r_eps, structure=structure), reps,
                        hold_stream=True)
    wrapper_ms = cuda_ms(lambda: nuts_trees(*tree_args, r_eps=r_eps, structure=structure), reps)
    rt, pc = LARGE_PLAIN_NUTS.get(name, (T, min(C, WIDE_PLAIN_COLUMNS_NUTS)))
    q0, r0, betas, eps, expo, dirs, accu = tree_args[:7]
    sub = [a[:rt, ..., :pc].contiguous() for a in (q0, r0)] + [betas[:rt]] + [
        a[:rt, :pc].contiguous() for a in (eps, expo)] + [
        a[:, :rt, :pc].contiguous() for a in (dirs, accu)]
    resu = nuts_uniforms(tree_args[7], NUTS_DEPTH, T, C)[:, :rt, :pc].contiguous()
    plain_ms = once_ms(lambda: nuts_trees_plain(*sub, resu, chol, model,
                                                r_eps[:rt, :, :pc].contiguous(), structure))
    del sub, resu
    out = nuts_trees(*tree_args, r_eps=r_eps, structure=structure)
    nalpha, alive = out[4], out[5]
    leaves = float(nalpha.sum())
    levels = float(torch.ceil(torch.log2(nalpha + 1.0)).sum())
    del out
    library_ms = whitening_library_ms(chol, d, reps)
    nprm = model.cuda_params(dev).numel()
    per_eval = 2 * product_ops(chol) + WIDE_MODEL_OPS[functor](d)
    # A leaf: an evaluation, the leapfrog (6 D), the kinetic energy (2 D), on
    # average one U-turn check (z - z_ck, times v, two dots: 6 D), the
    # slice, reservoir and acceptance tests (about 20) and a Philox uniform
    # (80 integer operations). A doubling: the whole tree's U-turn (5 D) and
    # the accept (10). A chain: its first evaluation and kinetic energy.
    ops = ((per_eval + 14 * d + 100) * leaves + (5 * d + 10) * levels
           + (per_eval + 2 * d) * T * C)
    # Per chain: q0, r0, q_prop (3 D floats), eps, expo, the six outputs; a
    # doubling run, its dirs and accu; beta, chol, the constants and the key.
    bytes_moved = (4 * ((3 * d + 8) * T * C + 2 * levels) + 4 * (T + d * d + nprm) + 16)
    bound_ms, bound_by = bound(bytes_moved, ops)
    capped = {}
    leaves_cap = (1 << NUTS_DEPTH) - 1
    # From the bench's start x0, well inside the correlated model's box (the
    # path's chains sit at its faces, where a leaf leaves it), with a step
    # size small enough that no tree turns or leaves the box.
    x0 = torch.tensor(wide_workload(name)[1], dtype=torch.float32, device=dev)
    q_start = (state.adapt.chol_inv.T @ x0)[None, :, None]
    for label, t, c in (("batch", T, C), ("group", 1, nb)):
        if label == "batch" and name in NO_CAPPED_BATCH:
            continue
        r0c, expoc, dirsc, accuc, keyc, repsc = draw_nuts(
            torch.Generator(device=dev).manual_seed(95), t, d, c, NUTS_DEPTH, dev)
        a = (q_start.expand(t, d, c).contiguous(), r0c, state.betas[:t].contiguous(),
             torch.full((t, c), WIDE_CAPPED_EPS, device=dev), expoc, dirsc, accuc, keyc, chol,
             model)
        cut = float(nuts_trees(*a, r_eps=repsc, structure=structure)[5].mean())
        if cut < CAPPED_ALIVE_MIN:
            raise SystemExit(f"{name}: capped NUTS timing: only {cut:.4f} of trees reached "
                             "the cap")
        ms = cuda_ms(lambda: nuts_trees(*a, r_eps=repsc, structure=structure),
                     1 if label == "batch" else 3, hold_stream=True)
        capped[f"capped_{label}_ms"] = ms
        capped[f"capped_{label}_us_per_leaf"] = 1e3 * ms / leaves_cap
        capped[f"capped_{label}_alive_share"] = cut
    ptx = {k: v for k, v in ptxas.items() if WIDE_CLASSES[functor] in k} if ptxas else {}
    scratch = wide_scratch_floats(d, NUTS_DEPTH)
    leaf_ops = (per_eval + 14 * d + 100) * T * C
    extra = {
        "workload": name, "ndim": d, "functor": functor, "factor_structure": structure,
        "capped_us_per_leaf": capped.get("capped_batch_us_per_leaf", "not measured"),
        "ordered_f32_share": leaf_ops / (1e-6 * capped["capped_batch_us_per_leaf"])
        / ORDERED_F32_OPS_PER_S if "capped_batch_us_per_leaf" in capped else "not measured",
        "launches_by_path": {name: launches},
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "plain_chains": [rt, pc],
        "library_what": "one leapfrog step's two whitening products, torch.matmul "
                        "[D, D] x [T, D, C] twice",
        **tree_stats(nalpha, alive), "group_lane_efficiency": efficiency,
        "leaves": leaves, "doublings": levels,
        "us_per_leaf_critical": 1e3 * kernel_ms / float(nalpha.max()), **capped,
        "step_bound_us": 1e6 * (per_eval + 14 * d + 100) * T * C / F32_OPS_PER_S,
        "whitening_ops_per_product": product_ops(chol),
        "scratch_layout": "per chain, chain-minor [plane][D][T*C]: 2 frontiers x (z, r, gw), "
                          f"{NUTS_DEPTH} checkpoint rows x (z, r), the subtree's proposal",
        "scratch_bytes": 4 * scratch * T * C,
        "ptxas": ptx or "not measured (built before)", **wide_layout(d, ptx, dev),
    }
    log(f"wide NUTS {name}: kernel {kernel_ms:.3f} ms (bound {bound_ms:.4f}, {bound_by}), "
        f"plain {plain_ms:.1f} ms at {rt} x {pc}, two matmuls {library_ms:.4f} ms; {extra}")
    return {"name": f"nuts_tree_{functor}", "route": "cuda",
            "source": "ptmcmcsampler_torch/csrc/nuts_tree.cu",
            "replaces": "ptmcmcsampler_tpu/ops/nuts_pallas.py:74", "launches": launches,
            "max_abs_err": max_err, "ms": kernel_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


def wide_hmc_entry(name, model, state, launches, max_err, ptxas):
    """Both wide HMC entries timed on the path's final state: the fused step
    under a fresh key, the trajectory entry on that step's own draws; the
    plain versions on the first WIDE_PLAIN_COLUMNS_NUTS chains a rung; the
    draws alone; the steps those draws take (the break test ends most
    trajectories after one) and the bounds of both entries."""
    from ptmcmcsampler_torch.ops import common
    from ptmcmcsampler_torch.ops.hmc import (
        hmc_kernel_draws, hmc_step, hmc_step_plain, hmc_trajectories, hmc_trajectories_plain,
    )

    d, functor = model.ndim, model.cuda_functor
    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(98)
    chol, chol_inv = state.adapt.chol, state.adapt.chol_inv
    structure = state.adapt.structure
    key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
    fused = (state.x, state.betas, key, chol, chol_inv, HMC_EPS, HMC_NMIN, HMC_NMAX, model,
             structure)
    p0, nsteps = hmc_kernel_draws(key, T, d, C, HMC_NMIN, HMC_NMAX, model)
    q0 = common.matvec(chol_inv.T, state.x, structure)
    args = (q0, p0, state.betas, nsteps, chol, HMC_EPS, model, structure)
    reps = 20 if d <= 64 else 5
    kernel_ms = cuda_ms(lambda: hmc_trajectories(*args), reps, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: hmc_trajectories(*args), reps)
    fused_ms = cuda_ms(lambda: hmc_step(*fused), reps, hold_stream=True)
    fused_wrapper_ms = cuda_ms(lambda: hmc_step(*fused), reps)
    draws_ms = cuda_ms(lambda: hmc_kernel_draws(key, T, d, C, HMC_NMIN, HMC_NMAX, model), reps,
                       hold_stream=True)
    pc = min(C, LARGE_PLAIN_COLUMNS.get(name, WIDE_PLAIN_COLUMNS_NUTS))
    cut = [a[..., :pc].contiguous() if torch.is_tensor(a) and a.dim() > 1 and a.shape[-1] == C
           else a for a in args]
    plain_ms = once_ms(lambda: hmc_trajectories_plain(*cut))
    fused_plain_ms = once_ms(lambda: hmc_step_plain(
        state.x[..., :pc].contiguous(), state.betas, (cut[1], cut[3]), chol, chol_inv, HMC_EPS,
        HMC_NMIN, HMC_NMAX, model, structure))
    del cut
    x1, qxy = hmc_step(*fused)
    q1, _ = hmc_trajectories(*args)
    one_step, _ = hmc_trajectories(q0, p0, state.betas, torch.ones_like(nsteps), chol, HMC_EPS,
                                   model, structure)
    if not torch.equal(common.matvec(chol.T, q1, structure), x1):
        raise SystemExit(f"{name}: the fused HMC step's end points differ from the trajectory "
                         "entry's")
    stopped = (q1 == one_step).all(dim=1)
    steps = int(torch.where(stopped, 1, nsteps).sum())
    library_ms = whitening_library_ms(chol, d, reps)
    nprm = model.cuda_params(dev).numel()
    per_eval = 2 * product_ops(chol) + WIDE_MODEL_OPS[functor](d)
    # A step: an evaluation, the leapfrog (6 D) and the joint's kinetic
    # energy (2 D); a chain: its first evaluation and kinetic energy.
    ops = (per_eval + 8 * d) * steps + (per_eval + 2 * d) * T * C
    bytes_moved = 4 * (3 * d + 2) * T * C + 4 * (T + d * d + nprm)
    bound_ms, bound_by = bound(bytes_moved, ops)
    # The fused step adds q0 = chol_inv^T x and its draws: Philox calls (80
    # integer operations each) and Box-Muller (about 25 a pair).
    pairs = (d + 1) // 2
    chain_ops = product_ops(chol_inv) + 80 * ((2 * pairs + 4) // 4) + 25 * pairs
    fused_bytes = 4 * (2 * d + 1) * T * C + 4 * (T + 2 * d * d + nprm) + 16
    fused_bound_ms, fused_bound_by = bound(fused_bytes, ops + chain_ops * T * C)
    ptx = {k: v for k, v in ptxas.items() if WIDE_CLASSES[functor] in k} if ptxas else {}
    extra = {
        "workload": name, "ndim": d, "functor": functor, "factor_structure": structure,
        "launches_by_path": {name: launches},
        "launches_by_entry": {"hmc_step": launches, "hmc_trajectories": 0},
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "plain_chains": [T, pc],
        "fused_ms": fused_ms, "fused_wrapper_ms": fused_wrapper_ms,
        "fused_plain_ms": fused_plain_ms, "fused_bound_ms": fused_bound_ms,
        "fused_bound_by": fused_bound_by, "draws_kernel_ms": draws_ms,
        "library_what": "one leapfrog step's two whitening products, torch.matmul "
                        "[D, D] x [T, D, C] twice",
        "mean_nsteps_drawn": float(nsteps.float().mean()), "mean_nsteps_taken": steps / (T * C),
        "stopped_after_one_step": float(stopped.float().mean()),
        "step_bound_us": 1e6 * (per_eval + 8 * d) * T * C / F32_OPS_PER_S,
        "whitening_ops_per_product": product_ops(chol),
        "ptxas": ptx or "not measured (built before)", **wide_layout(d, ptx, dev),
    }
    log(f"wide HMC {name}: trajectory entry {kernel_ms:.4f} ms (bound {bound_ms:.4f}, "
        f"{bound_by}), fused step {fused_ms:.4f} ms (bound {fused_bound_ms:.4f}), plain "
        f"{plain_ms:.1f} / {fused_plain_ms:.1f} ms at {T} x {pc}; {extra}")
    return {"name": f"hmc_trajectory_{functor}", "route": "cuda",
            "source": "ptmcmcsampler_torch/csrc/hmc_trajectory.cu",
            "replaces": "ptmcmcsampler_tpu/ops/hmc_pallas.py:54", "launches": launches,
            "max_abs_err": max_err, "ms": kernel_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


def max_abs_diff(out, ref):
    """The largest ``|a - b|`` over the elements of outputs ``out`` and
    ``ref`` where both are finite (0.0 where every such element is equal)."""
    worst = 0.0
    for a, b in zip(out, ref):
        both = torch.isfinite(a) & torch.isfinite(b)
        if bool(both.any()):
            worst = max(worst, float((a.double() - b.double()).abs()[both].max()))
    return worst


def kernel_layout(d):
    """The wide layout the kernels compute at dimension ``d`` (models.cuh,
    read through the ChEES library's host entry ``wide_layout``): chains a
    group, tile stages, dynamic shared bytes a block."""
    import ctypes

    from ptmcmcsampler_torch.ops import build

    fn = build.load("chees_trajectory").wide_layout
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_longlong * 3)()
    if fn(d, out) != 0:
        raise SystemExit(f"wide_layout refused D = {d}")
    return {"group_chains": out[0], "tile_stages": out[1], "dynamic_smem_bytes": out[2]}


# ---- Every entry of a wide functor against its plain version ----

def phase_entries_vs_plain(model, builtin=None, factors=("dense", "diagonal"),
                           depths=(4, NUTS_DEPTH), steps=32, nmax=HMC_NMAX, ragged=None,
                           time_entries=True):
    """Every entry of ``model``'s functor (chees_step, chees_trajectories,
    nuts_trees, hmc_step, hmc_trajectories and the HMC draws) against its
    plain version, the model's batched ``value_grad``, on
    ``wide_inputs``/``wide_tree_inputs`` draws: the kernels at the main
    path's T x C chains, the plain versions on ``wide_columns``, with each
    factor of ``factors`` (``wide_inputs``' kinds), ChEES lengths up to
    ``steps`` steps, NUTS at each depth of ``depths``, HMC lengths in
    [HMC_NMIN, ``nmax``); then, with ``ragged`` (a factor), the same at T x
    (C - 100) chains, a ragged last block and group. No lane may differ in
    any bit; the step's end points must equal the trajectory entry's; the
    kernel's draws must equal ``hmc_draws``' lengths and lie within
    DRAW_ULP_TOL ulp of its momenta. With ``builtin`` (the built-in model of
    the same function) every output of every entry must equal the built-in
    entry's on the same inputs, bit for bit, and with ``time_entries`` each
    entry is timed against it in turns (user, built-in, built-in, user; CUDA
    events, stream held): the cost of the per-chain adapter. Returns
    ``(largest |kernel - plain| by kernel, timings)``."""
    from ptmcmcsampler_torch.ops import common
    from ptmcmcsampler_torch.ops.chees import (
        chees_step, chees_step_plain, chees_trajectories, chees_trajectories_plain,
    )
    from ptmcmcsampler_torch.ops.hmc import (
        hmc_draws, hmc_kernel_draws, hmc_step, hmc_step_plain, hmc_trajectories,
        hmc_trajectories_plain,
    )
    from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6161)
    d, functor = model.ndim, model.cuda_functor
    err = {"chees": 0.0, "nuts": 0.0, "hmc": 0.0}
    timings = {}
    cases = [(factor, C) for factor in factors] + ([(ragged, C - 100)] if ragged else [])

    for factor, c in cases:
        structure = FACTOR_TAGS[factor]
        cols = wide_columns(c, dev)
        batch = "" if c == C else f" ragged {T} x {c}"

        def check(label, kernel, out, ref, other=None):
            """0 lanes of ``out`` differ from the plain ``ref`` on the
            columns, nor from the built-in entry's ``other`` anywhere."""
            sub = take_columns(out, c, cols)
            n = lanes_differ(sub, ref)
            m = lanes_differ(out, other) if other is not None else 0
            log(f"entries {functor} (D={d}){batch} {label}: {n} lanes differ from the plain "
                f"version" + (f", {m} from the built-in entry" if other is not None else ""))
            if n or m:
                raise SystemExit(f"entries {functor} (D={d}){batch} {label}: lanes differ")
            err[kernel] = max(err[kernel], max_abs_diff(sub, ref))

        def timed(label, fn, reps):
            """Both models' entry ``fn(m)`` in turns; ms of each."""
            if not time_entries or c != C:
                return
            if builtin is None:
                ms = {"user_ms": cuda_ms(lambda: fn(model), reps, hold_stream=True),
                      "builtin_ms": None}
            else:
                a = cuda_ms(lambda: fn(model), reps, hold_stream=True)
                b = cuda_ms(lambda: fn(builtin), reps, hold_stream=True)
                b2 = cuda_ms(lambda: fn(builtin), reps, hold_stream=True)
                a2 = cuda_ms(lambda: fn(model), reps, hold_stream=True)
                ms = {"user_ms": (a + a2) / 2, "builtin_ms": (b + b2) / 2,
                      "ratio": (a + a2) / (b + b2)}
            timings[label] = ms
            log(f"user {functor} {label}: {ms}")

        args = wide_inputs(gen, dev, model, c, steps, diagonal_eps(model, factor, WIDE_EPS),
                           diagonal_eps(model, factor, HMC_EPS), factor)
        _, r0, u, betas, eps, tlen, eps0, max_steps, chol, chol_inv = args
        out = chees_step(*args, model, structure)
        ref = chees_step_plain(*take_columns(args, c, cols), model, structure)
        other = chees_step(*args, builtin, structure) if builtin else None
        check(f"{factor} chees_step", "chees", out, ref, other)
        eps_tc, nsteps = step_lengths(u, eps, tlen, eps0, max_steps)
        traj = (out[1], r0, betas, eps_tc, nsteps, chol)
        tout = chees_trajectories(*traj, model, structure)
        tref = chees_trajectories_plain(*take_columns(traj, c, cols), model, structure)
        tother = chees_trajectories(*traj, builtin, structure) if builtin else None
        check(f"{factor} chees_trajectories", "chees", tout, tref, tother)
        if not (torch.equal(tout[0], out[2]) and torch.equal(tout[1], out[3])):
            raise SystemExit(f"entries {functor} {factor}: the step's end points differ from "
                             "the trajectory entry's")
        timed(f"{factor} chees_step", lambda m: chees_step(*args, m, structure), 20)
        timed(f"{factor} chees_trajectories",
              lambda m: chees_trajectories(*traj, m, structure), 20)
        del out, ref, other, tout, tref, tother

        for depth in depths:
            targs, r_eps = wide_tree_inputs(gen, dev, model, c, depth, factor)
            out = nuts_trees(*targs, model, r_eps=r_eps, structure=structure)
            resu = nuts_uniforms(targs[7], depth, T, c)
            resu = resu if cols is None else resu.index_select(-1, cols).contiguous()
            sub = take_columns(targs, c, cols)
            ref = nuts_trees_plain(*sub[:7], resu, sub[8], model,
                                   take_columns([r_eps], c, cols)[0], structure)
            other = nuts_trees(*targs, builtin, r_eps=r_eps, structure=structure) \
                if builtin else None
            check(f"{factor} nuts_trees depth {depth}", "nuts", out, ref, other)
            if not bool((out[6] > 0).all()) or not bool(torch.isfinite(out[0]).all()):
                raise SystemExit(f"entries {functor} {factor}: a step size <= 0 or a "
                                 "non-finite proposal")
            timed(f"{factor} nuts_trees depth {depth}",
                  lambda m: nuts_trees(*targs, m, r_eps=r_eps, structure=structure), 3)
            del out, ref, other, sub, resu, targs, r_eps

        x = args[0]
        heps = diagonal_eps(model, factor, HMC_EPS)
        key = torch.randint(0, 2**32, (2,), generator=gen, device=dev, dtype=torch.int64)
        hargs = (x, betas, key, chol, chol_inv, heps, HMC_NMIN, nmax)
        x1, qxy = hmc_step(*hargs, model, structure)
        p0, hsteps = hmc_kernel_draws(key, T, d, c, HMC_NMIN, nmax, model)
        p0t, hstepst = hmc_draws(key, T, d, c, HMC_NMIN, nmax)
        max_ulp = int(ulps(p0, p0t).max())
        if not torch.equal(hsteps, hstepst) or max_ulp > DRAW_ULP_TOL:
            raise SystemExit(f"entries {functor} {factor}: the kernel's draws differ from "
                             f"hmc_draws (p0 within {max_ulp} ulp)")
        sub = take_columns((x, p0, hsteps), c, cols)
        ref = hmc_step_plain(sub[0], betas, (sub[1], sub[2]), chol, chol_inv, heps,
                             HMC_NMIN, nmax, model, structure)
        other = hmc_step(*hargs, builtin, structure) if builtin else None
        check(f"{factor} hmc_step", "hmc", (x1, qxy), ref, other)
        if builtin is not None:  # the same draw code: the built-in's draws, bit for bit
            bp0, bsteps = hmc_kernel_draws(key, T, d, c, HMC_NMIN, nmax, builtin)
            m = lanes_differ((p0, hsteps), (bp0, bsteps))
            log(f"entries {functor} {factor} hmc draws: within {max_ulp} ulp of hmc_draws, "
                f"lengths equal; {m} lanes differ from the built-in entry's")
            if m:
                raise SystemExit(f"entries {functor} {factor}: hmc draws differ from the "
                                 "built-in's")
        q0 = common.matvec(chol_inv.T, x, structure)
        htraj = (q0, p0, betas, hsteps, chol, heps)
        q1, qxyk = hmc_trajectories(*htraj, model, structure)
        tref = hmc_trajectories_plain(*take_columns(htraj, c, cols), model, structure)
        tother = hmc_trajectories(*htraj, builtin, structure) if builtin else None
        check(f"{factor} hmc_trajectories", "hmc", (q1, qxyk), tref, tother)
        if lanes_differ((common.matvec(chol.T, q1, structure), qxyk), (x1, qxy)):
            raise SystemExit(f"entries {functor} {factor}: the HMC step's end points differ "
                             "from the trajectory entry's")
        timed(f"{factor} hmc_step", lambda m: hmc_step(*hargs, m, structure), 20)
        timed(f"{factor} hmc_trajectories",
              lambda m: hmc_trajectories(*htraj, m, structure), 20)
        timed(f"{factor} hmc draws",
              lambda m: hmc_kernel_draws(key, T, d, c, HMC_NMIN, nmax, m), 20)
        del args, x1, qxy, p0, hsteps, p0t, hstepst, ref, other, q0, q1, qxyk, tref, tother, sub
    torch.cuda.empty_cache()
    return err, timings


# ---- User functors (ops/user.py): a user's model in the three kernels ----

def user_item(item, timings):
    """A user functor's kernel item from a path phase: its source is the
    kernel's header the generated unit instantiates, and it carries the
    user-against-built-in timings of its kernel's entries."""
    header = {"chees": "chees_kernels.cuh", "nuts": "nuts_kernels.cuh",
              "hmc": "hmc_kernels.cuh"}[item["name"].split("_", 1)[0]]
    kernel = item["name"].split("_", 1)[0]
    item.update(
        source=f"ptmcmcsampler_torch/csrc/{header}",
        generated_by="ptmcmcsampler_torch/ops/user.py",
        against_builtin={k: v for k, v in timings.items() if k.split()[1].startswith(kernel)},
    )
    return item


def phase_user_sampler(card, wrappers):
    """``PTSampler`` with user models' bound methods on the card, the kernel
    route, its libraries built at construction. UserHierarchy at 8 x
    WIDE_SAMPLER_C chains with every jump, WIDE_SAMPLER_ITERS iterations:
    the route line must name the functor; ChEES, NUTS and HMC must launch
    the user entries once per iteration of their kind; the chain files'
    rows and the gate as the wide sampler phase checks them; then the
    built-in HierarchicalGaussian from the same seed, whose files are
    compared with the user run's byte for byte (the first differing row and
    the largest difference printed where they differ). Then the reference's
    test_nuts.py scenario with UserRefGaussian (SCAM/AM/DE/NUTS/HMC,
    HMCsteps 20, HMCstepsize 0.2) at 8 x WIDE_SAMPLER_C: launches, and the
    cold chains' moments against N(0, I). Then a 100-D UserRefGaussian,
    beyond its functor's dims, must be refused when ``sample()`` starts,
    before any iteration or launch. Returns ``(result, launches)``."""
    import io

    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.config import KIND_CHEES, KIND_HMC, KIND_NUTS
    from ptmcmcsampler_torch.diagnostics import moment_gate
    from ptmcmcsampler_torch.models import HierarchicalGaussian

    dev = torch.device(DEVICE)
    root = tempfile.mkdtemp(prefix="chip_smoke_user_sampler_")

    def run(m, outdir, iters, kw):
        for w in wrappers.values():
            w.launches = 0
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            t0 = time.time()
            s = PTSampler(m.ndim, m.lnlikefn, m.lnpriorfn, np.eye(m.ndim),
                          logl_grad=m.lnlikefn_grad, logp_grad=m.lnpriorfn_grad, ntemps=T,
                          nchains=WIDE_SAMPLER_C, outDir=outdir, seed=7)
            made = time.time() - t0
            t0 = time.time()
            if iters:
                s.sample(np.full(m.ndim, 0.1) if isinstance(m, UserRefGaussian)
                         else np.zeros(m.ndim), iters, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
        sys.stderr.write(said.getvalue())
        return s, said.getvalue(), made, wall

    def check(label, s, kw, kinds):
        launches = counted_launches(s.block_stats, wrappers)
        got = {kind: iterations(s, kind) for kind in kinds}
        target, _ = s._model.posterior_moments()
        thin = kw["thin"]
        ok, max_z, ess = moment_gate(s.chains[:, 1000 // thin + 1:], target)
        checks = {f"{wrappers[name].__name__} launches": (launches[name], got[kind])
                  for kind, name in ((KIND_CHEES, "chees_step"), (KIND_NUTS, "nuts_trees"),
                                     (KIND_HMC, "hmc_step")) if kind in kinds}
        checks.update({
            "trajectory entries' launches": (launches["chees_trajectories"]
                                             + launches["hmc_trajectories"], 0),
            "iterations of each kind > 0": (min(got.values()) > 0, True),
            "finite state": (bool(torch.isfinite(s.state.x).all()), True),
            "moment gate": (ok, True),
        })
        log(f"user sampler {label}: iterations {got}, launches {launches}, gate ok {ok} "
            f"max z {max_z:.3f}")
        for what, (value, want) in checks.items():
            if value != want:
                raise SystemExit(f"user sampler {label}: {what} is {value}, expected {want}")
        return {"iterations_by_kind": got, "launches": launches, "moments_ok": ok,
                "moments_max_z": max_z, "ess_min_dim": float(ess.min())}

    try:
        hier = UserHierarchy()
        d = hier.ndim
        user_dir, builtin_dir = os.path.join(root, "user"), os.path.join(root, "builtin")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        s, said, made, wall = run(hier, user_dir, WIDE_SAMPLER_ITERS, WIDE_SAMPLER_KW)
        route = next((line for line in said.splitlines() if line.startswith("Model route")), "")
        if s.route != "kernel" or "kernel (functor 'user_hierarchy')" not in route:
            raise SystemExit(f"user sampler: the route is {s.route!r}: {route!r}")
        hier_result = check("user_hierarchy", s, WIDE_SAMPLER_KW,
                            (KIND_CHEES, KIND_NUTS, KIND_HMC))
        launches = dict(hier_result["launches"])
        rows = 1 + WIDE_SAMPLER_ITERS // WIDE_SAMPLER_KW["thin"]
        text = np.loadtxt(os.path.join(user_dir, "chain_1.0.txt"), ndmin=2)
        if text.shape != (rows, d + 4):
            raise SystemExit(f"user sampler: chain_1.0.txt is {text.shape}, expected "
                             f"{(rows, d + 4)}")
        hier_result.update(iters_per_sec=WIDE_SAMPLER_ITERS / wall, wall_sec=wall,
                           construct_sec=made, route=route,
                           peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del s
        _, _, _, builtin_wall = run(HierarchicalGaussian(), builtin_dir, WIDE_SAMPLER_ITERS,
                                    WIDE_SAMPLER_KW)
        equal = same_files(user_dir, builtin_dir)
        files = {"equal_to_builtin": equal, "builtin_iters_per_sec":
                 WIDE_SAMPLER_ITERS / builtin_wall}
        if not equal:  # the first differing file; a chain text file's first row
            name = next((n for n in sorted(os.listdir(user_dir))
                         if not filecmp.cmp(os.path.join(user_dir, n),
                                            os.path.join(builtin_dir, n), shallow=False)), "")
            files["first_differing_file"] = name
            if name.startswith("chain_") and name.endswith(".txt"):
                a = np.loadtxt(os.path.join(user_dir, name), ndmin=2)
                b = np.loadtxt(os.path.join(builtin_dir, name), ndmin=2)
                if a.shape == b.shape:
                    files.update(first_differing_row=int(np.argmax((a != b).any(axis=1))),
                                 largest_difference=float(np.abs(a - b).max()))
        log(f"user sampler: files of the user functor's run and the built-in's equal: "
            f"{files}")
        shutil.rmtree(user_dir, ignore_errors=True)
        shutil.rmtree(builtin_dir, ignore_errors=True)

        ref = UserRefGaussian()
        s, said, _, wall = run(ref, os.path.join(root, "ref"), USER_REF_ITERS, USER_REF_KW)
        ref_result = check("user_ref_gaussian", s, USER_REF_KW, (KIND_NUTS, KIND_HMC))
        acc = dict(zip(s.config.jump_names(), (
            s.state.counters.jump_accepted[:, 0].sum(-1).double()
            / s.state.counters.jump_proposed[:, 0].sum(-1).clamp(min=1).double()).tolist()))
        ref_result.update(iters_per_sec=USER_REF_ITERS / wall, cold_acceptance=acc)
        for name in ("nuts_trees", "hmc_step"):
            launches[f"{name} (user_ref_gaussian)"] = ref_result["launches"][name]
        del s

        big = UserRefGaussian(ndim=100)
        s, _, _, _ = run(big, os.path.join(root, "refused"), 0, USER_REF_KW)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                s.sample(np.zeros(100), 100, **USER_REF_KW)
        except NotImplementedError as e:
            refusal = str(e)
        else:
            raise SystemExit("user sampler: the 100-D model was not refused")
        log(f"user sampler: 100-D UserRefGaussian refused: {refusal}")
        if ("got 100" not in refusal or 'device="cpu"' not in refusal or s.state is not None
                or any(w.launches for w in wrappers.values())):
            raise SystemExit(f"user sampler: the refusal is not the expected one: {refusal}")
        big = UserHierarchy(ngroups=1024)  # 1025-D, beyond its dims and the layout's 1024
        s, _, _, _ = run(big, os.path.join(root, "refused1025"), 0, WIDE_SAMPLER_KW)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                s.sample(np.zeros(big.ndim), 100, **WIDE_SAMPLER_KW)
        except NotImplementedError as e:
            refusal_1025 = str(e)
        else:
            raise SystemExit("user sampler: the 1025-D user hierarchy was not refused")
        log(f"user sampler: 1025-D UserHierarchy refused: {refusal_1025}")
        if ("got 1025" not in refusal_1025 or 'device="cpu"' not in refusal_1025
                or s.state is not None or any(w.launches for w in wrappers.values())):
            raise SystemExit(f"user sampler: the refusal is not the expected one: "
                             f"{refusal_1025}")
        name, power = [v.strip() for v in card.split(",", 1)]
        result = {
            "phase": "user_sampler", "chains": [T, WIDE_SAMPLER_C],
            "user_hierarchy": {"iters": WIDE_SAMPLER_ITERS, **hier_result, **files},
            "user_ref_gaussian": {"iters": USER_REF_ITERS, "settings": USER_REF_KW,
                                  **ref_result},
            "refused_100d": refusal, "refused_1025d": refusal_1025, "card": name,
            "power_limit": power,
        }
        return result, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- Past D = 256: groups of 8 and 4 chains (ROADMAP B7) ----

def large_checks():
    """``(label, model, built-in or None)`` of the checks past D = 256: the
    hierarchy at the group boundaries 270, 512, 513 and 1024-D, the
    correlated Gaussian at 300-D (its icov product runs through wide_matvec
    inside the model), and the user hierarchy at 270 and 1024-D against the
    built-in entries. (``tests/test_torch_cuda.py`` holds all three built-in
    functors at 270, 512, 513 and 1024-D.)"""
    from ptmcmcsampler_torch.models import CorrelatedGaussian, HierarchicalGaussian

    checks = [(f"hierarchical{g + 1}", HierarchicalGaussian(ngroups=g), None)
              for g in (269, 511, 512, 1023)]
    checks += [("correlated300", CorrelatedGaussian(ndim=300, seed=1), None)]
    checks += [(f"user_hierarchical{g + 1}", UserHierarchy(ngroups=g),
                HierarchicalGaussian(ngroups=g)) for g in (269, 1023)]
    return checks


def large_check_line(card, label, model, builtin, err, seconds):
    """The JSON line of ``phase_entries_vs_plain`` with LARGE_CHECK on a
    model of ``large_checks``: its layout as the kernels compute it, the
    batches, lengths and factors checked, and the largest |kernel - plain|
    of each kernel."""
    name, power = [v.strip() for v in card.split(",", 1)]
    return {
        "phase": "large_vs_plain", "model": label, "ndim": model.ndim,
        "functor": model.cuda_functor, "against_builtin": builtin is not None,
        **kernel_layout(model.ndim), "chains": [T, C], "ragged_chains": [T, C - 100],
        "plain_columns": WIDE_PLAIN_COLUMNS_NUTS, "factors": LARGE_CHECK["factors"],
        "ragged_factor": LARGE_CHECK["ragged"], "chees_max_steps": LARGE_CHECK["steps"],
        "nuts_depths": LARGE_CHECK["depths"], "hmc_nsteps": [HMC_NMIN, LARGE_CHECK["nmax"]],
        "max_abs_err": err, "seconds": seconds, "card": name, "power_limit": power,
    }


# ---- BASELINE config 4 on the card: the user's jumps beside the ChEES kernel ----

# examples/hierarchical_gaussian.py's cycle (SCAM/AM/DE at 20 each, DE after
# burn-in, a small-Gaussian custom jump at 5, the prior draw at 2) plus ChEES
# at 20 and the auxiliary HierarchyReflection, on bench.py's 50-D hierarchy.
CUSTOM_WEIGHTS = dict(SCAMweight=20, AMweight=20, DEweight=20, CHEESweight=20)
# Cut: the timed iterations to 6000, to make room for the per-chain,
# general-entry and trajectory phases, and to 3000 for the sharded phase;
# to 2000 + 2000 for the sharded per_chain and config-4 cases (PR 17).
CUSTOM_ITERS = {"custom_jumps": (2000, 2000)}
CUSTOM_SAMPLER_KW = dict(burn=500, Tskip=5, isave=500, covUpdate=500, thin=10,
                         NUTSweight=0, HMCweight=0, MALAweight=0, HMCstepsize=HMC_EPS,
                         **CUSTOM_WEIGHTS)
# The reference protocol's numpy jumps through PTSampler, at a small width.
HOST_JUMPS_C, HOST_JUMPS_ITERS = 128, 300


def custom_config(model, burn, cov_update=1000):
    """Path 1's wide configuration with config 4's cycle and the user's jumps
    (torch-native, so each runs inside the step's graphs)."""
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps
    from ptmcmcsampler_torch.config import KIND_CUSTOM, KIND_PRIOR, JumpSpec

    d = model.ndim
    return SamplerConfig(
        ndim=d, ntemps=T, nchains=C, groups=(tuple(range(d)),),
        jumps=build_default_jumps(burn=burn // 2, have_grads=True, **CUSTOM_WEIGHTS) + (
            JumpSpec("SmallGauss", KIND_CUSTOM, 5, fn=small_gauss_jump),
            JumpSpec("DrawFromPrior", KIND_PRIOR, 2, fn=model.draw_prior)),
        aux_jumps=(JumpSpec("Reflect", KIND_CUSTOM, 1,
                            fn=HierarchyReflection(model, torch.device(DEVICE))),),
        tskip=5, cov_update=cov_update, burn=burn // 2, thin=1, de_size=2000,
        hmc_stepsize=HMC_EPS,
    )


def phase_custom_jumps(card):
    """9d. BASELINE config 4 with ChEES on bench.py's 50-D hierarchy at 8 x
    16384 through ``build_step``/``run_block``: first the graphs against the
    eager step loop, bit for bit (as 3); then the path at CUSTOM_ITERS. The
    custom jump, the prior draw and the auxiliary jump run inside the graphs
    (no eager iteration but the warm-ups), ``chees_step`` launches once per
    ChEES iteration, the gate passes. Prints the path's line (``"phase":
    "custom_jumps"``); returns the ChEES launches."""
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories

    model, x0 = wide_workload("hierarchical")
    d = model.ndim
    cut = custom_config(model, 2 * GRAPHS_BURN, cov_update=GRAPHS_COV_UPDATE)
    graphs = phase_graphs(model, card, "custom_jumps", cut, {KIND_CHEES: chees_step}, x0)
    torch.cuda.empty_cache()
    block, burn, timed, cuts, stride = wide_counts("custom_jumps", d, CUSTOM_ITERS)
    cfg = custom_config(model, burn)
    state, (step, run_block), result, ok = phase_main_path(
        model, card, "custom_jumps", cfg, {KIND_CHEES: chees_step},
        absent=(chees_trajectories,), x0=x0, burn=burn, timed=timed, block=block,
        stride=stride, compare_iters=20)
    eager = result["graphs"]["eager"]
    counts = result["jumps"]
    launches = result["launches"][KIND_CHEES]
    result.update(
        phase="custom_jumps", workload="hierarchical", block=block, burn_iters=burn,
        timed_iters=timed, gate_stride=stride, cuts=cuts,
        aux_jumps=[j.name for j in cfg.aux_jumps], chees_launches=launches,
        chees_iterations=result["iterations_by_kind"][KIND_CHEES],
        prior_draw_acceptance=counts["DrawFromPrior"]["rate"],
        graphs_bitwise_equal=graphs["bitwise_equal"],
    )
    del state, step, run_block
    torch.cuda.empty_cache()
    print_result(result, ok)
    if eager["host jump"] or eager["no capture"] or not all(
            c["proposed"] for c in counts.values()):
        raise SystemExit(f"custom_jumps: eager iterations {eager}, jumps {counts}")
    return launches


def register_config4(s, model):
    """Config 4's user jumps, torch-native, on the ``PTSampler`` ``s``."""
    s.addProposalToCycle(small_gauss_jump, 5, name="SmallGauss")
    s.addPriorDrawToCycle(model.draw_prior, 2)
    s.addAuxilaryJump(HierarchyReflection(model, torch.device(DEVICE)), name="Reflect")


def phase_host_jumps():
    """The reference protocol's numpy custom jump and numpy prior draw
    through ``PTSampler`` on the 50-D hierarchy at 8 x HOST_JUMPS_C chains,
    HOST_JUMPS_ITERS iterations: exactly their own iterations run eagerly
    ("host jump"), every other key replays. Returns the run's numbers."""
    from ptmcmcsampler_torch import PTSampler

    model = wide_workload("hierarchical")[0]
    d = model.ndim
    root = tempfile.mkdtemp(prefix="chip_smoke_host_jumps_")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            s = PTSampler(d, model.lnlikefn, model.lnpriorfn, np.eye(d),
                          logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
                          ntemps=T, nchains=HOST_JUMPS_C, outDir=root, seed=7)
            s.addProposalToCycle(numpy_small_gauss_jump, 5, name="SmallGauss")
            s.addPriorDrawToCycle(numpy_draw_prior(model), 2)
            t0 = time.time()
            s.sample(np.zeros(d), HOST_JUMPS_ITERS, **dict(CUSTOM_SAMPLER_KW, burn=100,
                                                          isave=100, covUpdate=100))
            torch.cuda.synchronize()
            wall = time.time() - t0
        graphs = s.block_stats.summary()
        names = s.config.jump_names()
        prop = s.state.counters.jump_proposed[:, 0, 0].tolist()
        own = prop[names.index("SmallGauss")] + prop[names.index("DrawFromPrior")]
        result = {
            "chains": [T, HOST_JUMPS_C], "iters": HOST_JUMPS_ITERS,
            "iters_per_sec": HOST_JUMPS_ITERS / wall,
            "protocols": {j.name: j.protocol for j in s._custom_jumps},
            "host_jump_iterations": own, "jumps": jump_counts(s.config, s.state),
            "graphs": graphs,
        }
        log(f"host protocol: {result}")
        if (result["protocols"] != {"SmallGauss": "host", "DrawFromPrior": "host"}
                or graphs["eager"]["host jump"] != own or not own
                or not graphs["replays"] or not torch.isfinite(s.state.x).all()):
            raise SystemExit(f"custom_sampler: the host protocol's run is not as expected: "
                             f"{result}")
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- BASELINE config 5 on one card: DEO swaps, the adaptive ladder, the DE pair laws ----

# bench.py's 50-D hierarchy on a 64-rung ladder (the default geometric one,
# c = 1 + sqrt(2/50)) of 2048 chains a rung: path 1's 131072 chains.
# Path 1's cycle and cadences, swap_mode="deo" and the adaptive ladder at
# PTSampler's defaults (lag 10000, time 100) over the first half of the
# burn-in, as ChEES adapts. LADDER_ITERS: (burn-in, timed) iterations of
# these paths and of the DE pair laws' (9g), each cut from bench.py's 3000 +
# 12000 to keep the script in its time limit (each line lists its cut): at
# the full counts they took 31, 10, 7 and 16 s on an H100 (PERF.md §5).
LADDER_T, LADDER_C = 64, 2048
# Cut: the timed iterations of tall_ladder, de_iid and de_rolled from
# 6000 to 3000, and of the sweep from 3000 to 1500, to make room for the
# per-chain, general-entry and trajectory phases; the first three to 2000
# for the sharded phase; tall_ladder and de_rolled to 2000 + 1500 for the
# sharded per_chain and config-4 cases (PR 17).
LADDER_ITERS = {"tall_ladder": (2000, 1500), "tall_ladder_sweep": (1000, 1500),
                "de_iid": (3000, 2000), "de_rolled": (2000, 1500)}
# The eager loop against the graphs on these paths' final states: 20
# iterations of each under the profiler, as on the wide paths past 64-D.
LADDER_COMPARE_ITERS = 20
# The graphs check on the ladder: the ladder's burn at 150 of the 300
# iterations, so both ladder keys and both DEO parities are captured.
LADDER_GRAPHS_BURN = 150
# PTSampler on the 64-rung ladder: 2000 iterations, then a resume to 3000,
# against an unbroken run of 3000; the ladder adapts to iteration 2500, so
# the resumed run continues the checkpoint's ladder.
LADDER_SAMPLER_C, LADDER_SAMPLER_ITERS, LADDER_SAMPLER_RESUME = 256, 2000, 3000
LADDER_SAMPLER_KW = dict(burn=2500, Tskip=5, isave=500, covUpdate=500, thin=10,
                         SCAMweight=10, AMweight=10, DEweight=10, CHEESweight=20,
                         NUTSweight=0, HMCweight=0, MALAweight=0, HMCstepsize=HMC_EPS,
                         hotChain=True, adaptLadder=True)


def ladder_config(d, burn, cov_update=1000, **ladder):
    """Path 1's wide cycle (``wide_config``) on LADDER_T x LADDER_C chains
    with the ladder's settings ``ladder`` (``swap_mode``, ``adapt_ladder``,
    ``de_pair``)."""
    return dataclasses.replace(wide_config(d, burn, cov_update), ntemps=LADDER_T,
                               nchains=LADDER_C, **ladder)


def swap_snapshot(state):
    """The ladder and the swap counters, copied."""
    ctr = state.counters
    return {"betas": state.betas.clone(), "proposed": ctr.swaps_proposed.clone(),
            "accepted": ctr.swaps_accepted.clone()}


def pair_acceptance(a, b):
    """Each pair's swap acceptance over the cold-to-hot chains between two
    snapshots (``T - 1`` pairs)."""
    prop = (b["proposed"] - a["proposed"]).double()
    acc = (b["accepted"] - a["accepted"]).double().mean(1)
    return (acc / prop.clamp(min=1))[:-1].tolist()


def ladder_checks(label, b0, burned, final):
    """The ladder moved in burn-in, stays strictly descending, keeps both
    ends, and stayed as it was after its burn. Returns its numbers."""
    moved = torch.log(burned / b0).abs()
    fails = {
        "moved": bool(torch.equal(burned, b0)),
        "descending": not bool(torch.all(burned[1:] < burned[:-1])),
        "ends kept": bool(burned[0] != b0[0] or burned[-1] != b0[-1]),
        "fixed after its burn": not torch.equal(final, burned),
    }
    if any(fails.values()):
        raise SystemExit(f"{label}: the ladder failed {[k for k, v in fails.items() if v]}: "
                         f"from {b0.tolist()} to {burned.tolist()}, then {final.tolist()}")
    return {"betas_initial": b0.tolist(), "betas_adapted": burned.tolist(),
            "max_abs_log_beta_change": float(moved.max()),
            "median_abs_log_beta_change": float(moved.median())}


def swap_event_ms(state, reps=50):
    """Device ms of one swap event on ``state``'s rows: DEO (parity 0) and
    the hottest-first sweep on the same uniforms, each captured in a CUDA
    graph as the step's graphs hold it and replayed (CUDA events, stream
    held)."""
    from ptmcmcsampler_torch import swaps

    t, _, c = state.x.shape
    gen = torch.Generator(device=state.x.device).manual_seed(0)
    args = (torch.rand((t - 1, c), generator=gen, device=state.x.device), state.x,
            state.lnlike, state.lnprior, state.betas)
    out = {}
    for name, fn in (("deo", lambda: swaps.deo_swap_apply(*args, 0)),
                     ("sweep", lambda: swaps.sweep_swap_apply(*args))):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        out[name] = cuda_ms(graph.replay, reps, hold_stream=True)
        del graph
    return out


def phase_tall_ladder(card):
    """9f. BASELINE config 5 on one card (``"phase": "tall_ladder"``): path
    1's cycle on bench.py's 50-D hierarchy at LADDER_T x LADDER_C chains
    with DEO swaps and the adaptive ladder, LADDER_ITERS iterations through
    ``run_block``'s graphs, as ``phase_main_path``: ``chees_step`` once per
    ChEES iteration, the gate on the cold chains, MIN_REPLAYED_SHARE
    replayed. The ladder must move in its burn, stay descending, keep both
    ends, and not move after it; each pair's acceptance over the burn-in
    and over the timed iterations. Then the same with the hottest-first
    sweep, cut (``"path": "tall_ladder_sweep"``), beside DEO's rate, and one
    swap event of each scheme on DEO's final state (``swap_event_ms``).
    Returns the ChEES launches of both."""
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.ladder import ladder_betas, temperature_ladder
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories

    model, x0 = wide_workload("hierarchical")
    d = model.ndim
    launches, rates = {}, {}
    for path, mode in (("tall_ladder", "deo"), ("tall_ladder_sweep", "sweep")):
        block, burn, timed, cuts, stride = wide_counts(path, d, LADDER_ITERS, c=LADDER_C)
        cfg = ladder_config(d, burn, swap_mode=mode, adapt_ladder=True)
        snaps = {}
        state, (step, run_block), result, ok = phase_main_path(
            model, card, path, cfg, {KIND_CHEES: chees_step}, absent=(chees_trajectories,),
            x0=x0, burn=burn, timed=timed, block=block, stride=stride,
            compare_iters=LADDER_COMPARE_ITERS,
            on_burned=lambda st: snaps.update(burned=swap_snapshot(st)))
        b0 = torch.tensor(ladder_betas(temperature_ladder(d, LADDER_T))[1],
                          dtype=torch.float32, device=state.x.device)
        start = {"betas": b0, "proposed": torch.zeros_like(state.counters.swaps_proposed),
                 "accepted": torch.zeros_like(state.counters.swaps_accepted)}
        end = swap_snapshot(state)
        before, after = (pair_acceptance(start, snaps["burned"]),
                         pair_acceptance(snaps["burned"], end))
        ladder = ladder_checks(path, b0, snaps["burned"]["betas"], end["betas"])
        launches[path] = result["launches"][KIND_CHEES]
        rates[mode] = result["iters_per_sec"]
        result.update(
            workload="hierarchical", swap_mode=mode, adapt_ladder=True,
            ladder_adapt=[cfg.ladder_adapt_lag, cfg.ladder_adapt_time], ladder_burn=cfg.burn,
            block=block, burn_iters=burn, timed_iters=timed, gate_stride=stride, cuts=cuts,
            pair_acceptance_burn_in=before, pair_acceptance_timed=after,
            pair_acceptance_timed_min_max_std=[min(after), max(after), float(np.std(after))],
            chees_launches=launches[path],
            chees_iterations=result["iterations_by_kind"][KIND_CHEES],
            chees_eps=state.stepsize.chees_eps[:, 0].tolist(),
            chees_tlen=state.stepsize.chees_tlen[:, 0].tolist(), **ladder)
        if mode == "deo":
            events = swap_event_ms(state)
            result["swap_event_device_ms"] = events
        else:
            # A swap event every tskip iterations: what the 63-pair sweep adds
            # to one beside DEO's, from the two timed rates (at this cut, on
            # other states) and from one event of each on DEO's final state.
            result.update(deo_iters_per_sec=rates["deo"],
                          sweep_extra_ms_per_swap_event=cfg.tskip * 1e3 * (
                              1 / rates["sweep"] - 1 / rates["deo"]),
                          swap_event_device_ms=events)
        eager = result["graphs"]["eager"]
        del state, step, run_block
        torch.cuda.empty_cache()
        print_result(result, ok)
        if eager["host jump"] or eager["no capture"]:
            raise SystemExit(f"{path}: eager iterations {eager}")
    return launches


def phase_tall_ladder_graphs(card):
    """9f (first). The graphs check of 3 on the tall ladder (``"path":
    "tall_ladder"``): the eager step loop against ``run_block`` at LADDER_T
    x LADDER_C, the ladder's burn at LADDER_GRAPHS_BURN, bit for bit; both
    DEO parities, with and without the ladder's update, must have a graph."""
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.ops.chees import chees_step

    model, x0 = wide_workload("hierarchical")
    cfg = ladder_config(model.ndim, 2 * LADDER_GRAPHS_BURN, cov_update=GRAPHS_COV_UPDATE,
                        swap_mode="deo", adapt_ladder=True)
    result = phase_graphs(model, card, "tall_ladder", cfg, {KIND_CHEES: chees_step}, x0)
    torch.cuda.empty_cache()
    events = {key[1] for key in result["graph_keys"]}
    want = {str(e) for e in (("deo", 0, "ladder"), ("deo", 1, "ladder"), ("deo", 0), ("deo", 1))}
    if not want <= events:
        raise SystemExit(f"tall_ladder graphs: swap events {events}, expected {want}")
    return result


def phase_de_pairs(card):
    """9g. The "iid" DE pair law on path 1's curved workload at 8 x 16384
    and the "rolled" one on bench.py's 50-D hierarchy (not on the curved
    target, where rolled synchronises mode jumps), each at LADDER_ITERS
    through the graphs, the gate enforced, with DE's cold acceptance beside
    the blocked law's on the same workload (path 1's lines). One
    ``"phase": "de_pairs"`` line each; returns the ChEES launches."""
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories

    launches = {}
    hier, hier_x0 = wide_workload("hierarchical")
    for path, model, x0, de_pair, blocked in (
            ("de_iid", CurvedLikelihood(), (-0.1, -0.5), "iid", "chees"),
            ("de_rolled", hier, hier_x0, "rolled", "hierarchical")):
        d = model.ndim
        block, burn, timed, cuts, stride = wide_counts(path, d, LADDER_ITERS)
        if d == D:  # path 1's block and gate stride
            block, stride = BLOCK, GATE_STRIDE
        cfg = dataclasses.replace(
            headline_config(burn // 2) if d == D else wide_config(d, burn), de_pair=de_pair)
        state, (step, run_block), result, ok = phase_main_path(
            model, card, path, cfg, {KIND_CHEES: chees_step}, absent=(chees_trajectories,),
            x0=x0, burn=burn, timed=timed, block=block, stride=stride,
            compare_iters=LADDER_COMPARE_ITERS)
        launches[path] = result["launches"][KIND_CHEES]
        result.update(
            phase="de_pairs", de_pair=de_pair, workload=blocked, block=block, burn_iters=burn,
            timed_iters=timed, gate_stride=stride, cuts=cuts,
            de_acceptance=result["cold_acceptance"]["DEJump"],
            blocked_de_acceptance=COLD_ACCEPTANCE.get(blocked, {}).get("DEJump",
                                                                        "not measured"),
            chees_launches=launches[path])
        del state, step, run_block
        torch.cuda.empty_cache()
        print_result(result, ok)
    return launches


def phase_ladder_sampler(card, wrappers):
    """9h. ``PTSampler`` on bench.py's 50-D hierarchy at LADDER_T x
    LADDER_SAMPLER_C chains with ``swap_mode="deo"``, ``sample(adaptLadder=
    True, hotChain=True)`` (LADDER_SAMPLER_KW), LADDER_SAMPLER_ITERS
    iterations, then ``resume=True`` to LADDER_SAMPLER_RESUME, beside an
    unbroken run of LADDER_SAMPLER_RESUME from the same seed. The
    checkpoint's betas must be the first run's, the ladder must move before
    and after the resume (it adapts to iteration 2500), stay descending with
    its cold end and the beta = 0 hot chain, and the resumed run's files,
    checkpoint and betas must equal the unbroken run's byte for byte;
    ``chees_step`` once per ChEES iteration in each run (through the
    graphs), the chain files' rows and sidecar. One JSON line ``"phase":
    "ladder_sampler"``; returns the ChEES launches."""
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.config import KIND_CHEES
    from ptmcmcsampler_torch.diagnostics import moment_gate

    model = wide_workload("hierarchical")[0]
    d = model.ndim
    root = tempfile.mkdtemp(prefix="chip_smoke_ladder_sampler_")
    parts, whole = os.path.join(root, "parts"), os.path.join(root, "whole")

    def run(outdir, niter, resume):
        for w in wrappers.values():
            w.launches = 0
        with contextlib.redirect_stdout(sys.stderr):
            s = PTSampler(d, model.lnlikefn, model.lnpriorfn, np.eye(d),
                          logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
                          ntemps=LADDER_T, nchains=LADDER_SAMPLER_C, outDir=outdir, seed=7,
                          swap_mode="deo", resume=resume)
            t0 = time.time()
            s.sample(np.zeros(d), niter, **LADDER_SAMPLER_KW)
            torch.cuda.synchronize()
            wall = time.time() - t0
        return s, wall, counted_launches(s.block_stats, wrappers)

    try:
        first, wall1, launch1 = run(parts, LADDER_SAMPLER_ITERS, False)
        with np.load(os.path.join(parts, "checkpoint.npz")) as z:
            ckpt_betas = z["betas"].copy()
        with open(os.path.join(parts, "checkpoint.npz.json")) as f:
            ckpt_iter = json.load(f)["iter"]
        mid = first.state.betas.clone()
        iters1 = iterations(first, KIND_CHEES)
        resumed, wall2, launch2 = run(parts, LADDER_SAMPLER_RESUME, True)
        iters2 = iterations(resumed, KIND_CHEES) - iters1
        unbroken, wall3, _ = run(whole, LADDER_SAMPLER_RESUME, False)
        b0 = torch.tensor(1.0 / first.ladder, dtype=torch.float32, device=mid.device)
        end = resumed.state.betas
        cfg = resumed.config
        thin = LADDER_SAMPLER_KW["thin"]
        rows = 1 + LADDER_SAMPLER_RESUME // thin
        text = np.loadtxt(os.path.join(parts, "chain_1.0.txt"), ndmin=2)
        sidecar = os.path.getsize(os.path.join(parts, "chain_all_1.0.bin"))
        target, _ = model.posterior_moments()
        _, max_z, _ = moment_gate(resumed.chains[:, 1000 // thin + 1:], target)
        checks = {
            "settings": ((cfg.swap_mode, cfg.adapt_ladder, cfg.ladder_adapt_skip_top),
                         ("deo", True, True)),
            "checkpoint iteration": (ckpt_iter, LADDER_SAMPLER_ITERS),
            "checkpoint betas are the run's": (
                ckpt_betas.tobytes() == mid.cpu().numpy().tobytes(), True),
            "resumed from": (resumed._resume_start_iter, LADDER_SAMPLER_ITERS),
            "moved before the resume": (bool(torch.equal(mid, b0)), False),
            "moved after the resume": (bool(torch.equal(end, mid)), False),
            "descending": (bool(torch.all(end[1:-1] < end[:-2])), True),
            "cold end and hot chain": ((float(end[0]), float(end[-1])), (1.0, 0.0)),
            "resumed betas = unbroken run's": (torch.equal(end, unbroken.state.betas), True),
            "files = unbroken run's": (same_files(parts, whole), True),
            "first run's launches": (launch1["chees_step"], iters1),
            "resumed run's launches": (launch2["chees_step"], iters2),
            "chain text rows x columns": (text.shape, (rows, d + 4)),
            "chain_all_1.0.bin bytes": (sidecar, rows * LADDER_SAMPLER_C * d * 4),
            "finite state": (bool(torch.isfinite(resumed.state.x).all()), True),
        }
        log(f"ladder_sampler: {checks}")
        for what, (got, want) in checks.items():
            if got != want:
                raise SystemExit(f"ladder_sampler: {what} is {got}, expected {want}")
        name, power = [v.strip() for v in card.split(",", 1)]
        result = {
            "phase": "ladder_sampler", "model": "HierarchicalGaussian", "ndim": d,
            "chains": [LADDER_T, LADDER_SAMPLER_C],
            "iters": [LADDER_SAMPLER_ITERS, LADDER_SAMPLER_RESUME],
            "iters_per_sec": [LADDER_SAMPLER_ITERS / wall1,
                              (LADDER_SAMPLER_RESUME - LADDER_SAMPLER_ITERS) / wall2,
                              LADDER_SAMPLER_RESUME / wall3],
            "ladder_burn": LADDER_SAMPLER_KW["burn"],
            "betas_initial": b0.tolist(), "betas_checkpoint": mid.tolist(),
            "betas_final": end.tolist(),
            "launches": [launch1["chees_step"], launch2["chees_step"]],
            "chees_iterations": [iters1, iters2],
            "moments_max_z_printed": max_z, "rows": int(text.shape[0]),
            "graphs": resumed.block_stats.summary(), "checks": list(checks),
            "card": name, "power_limit": power,
        }
        print(json.dumps(result), flush=True)
        return launch1["chees_step"] + launch2["chees_step"]
    finally:
        shutil.rmtree(root, ignore_errors=True)



# ---- Slice 15: per-chain jump selection, the NUTS kernel's general entry
# and the NUTS trajectory capture (ROADMAP A11's end) ----

# The per_chain phase: both paths' cycles on the 50-D hierarchy at T x C,
# rotation mode, cut from bench.py's 3000 + 12000 to fit the script's limit
# (the timed iterations from 2000 and 1000 for the sharded phase; path 2 to
# 300 + 300 for the sharded per_chain and config-4 cases, PR 17).
PER_CHAIN_ITERS = {"hierarchical": (1000, 1000), "nuts/hierarchical": (300, 300)}
# The graphs check of the per_chain phase: eager loop against run_block over
# PER_CHAIN_GRAPHS_ITERS iterations that cross DE's activation (burn cut to
# GRAPHS_BURN, cov_update to GRAPHS_COV_UPDATE); the stacked mode on path
# 2's cycle at T x STACKED_C.
PER_CHAIN_GRAPHS_ITERS, STACKED_C = 60, 64
# The NUTS kernel's general entry: checks at GENERAL_DEPTH on T x (C - 1)
# chains (no whole group, no whole block) against the plain version on
# GENERAL_PLAIN_COLUMNS chains a rung (the first and the last halves),
# trees at a step size of GENERAL_CAPPED_EPS (every tree to the cap) and
# with each forced length of GENERAL_TRAJLENS, with the capture; then path
# 2 on the curved target at depth GENERAL_DEPTH with a forced length of
# GENERAL_PATH_TRAJLEN (every tree past 1023 leaves), GENERAL_PATH_ITERS.
GENERAL_DEPTH, GENERAL_CAPPED_EPS = 12, 1e-5
GENERAL_TRAJLENS = (1, 37, 1500)
GENERAL_PLAIN_COLUMNS = 64
GENERAL_PATH_TRAJLEN, GENERAL_PATH_ITERS = 1500, (500, 1000)
# The trajectory_sampler phase: PTSampler on the 50-D hierarchy at T x
# WIDE_SAMPLER_C, path 2's cycle, with trajectoryDir and write_burnin.
TRAJ_SAMPLER_KW = dict(WIDE_SAMPLER_KW, CHEESweight=0)
# The ptxas lines of the NUTS kernel's default entries since they take the
# counter arguments n_base and c_total (this script's build log on an H100;
# tools/torch_ptxas_diff.py --other holds them to a build of an earlier
# checkout). At 5902412, before those arguments, nuts_tree_kernel<> had 62
# registers and the wide kernels' spill stores were within 12 B of these
# (PERF.md §6).
BASE_NUTS_PTXAS = {
    "nuts_tree_kernel<>": (63, 0, 0, 0, 26624),
    "nuts_wide_kernel<WideHierarchicalGaussian,0>": (128, 488, 760, 1220, 2304),
    "nuts_wide_kernel<WideHierarchicalGaussian,1>": (128, 496, 772, 1292, 2304),
    "nuts_wide_kernel<WideIntervalGaussian,0>": (128, 400, 574, 872, 2304),
    "nuts_wide_kernel<WideIntervalGaussian,1>": (128, 416, 582, 988, 2304),
    "nuts_wide_kernel<WideCorrelatedGaussian,0>": (128, 480, 904, 1536, 2304),
    "nuts_wide_kernel<WideCorrelatedGaussian,1>": (128, 488, 880, 1532, 2304),
}
PTXAS_FIELDS = ("registers", "stack_bytes", "spill_store_bytes", "spill_load_bytes",
                "static_smem_bytes")


def per_chain_config(cfg, mode="rotation"):
    return dataclasses.replace(cfg, jump_select="per_chain", per_chain_mode=mode)


def per_chain_expected(cfg, iters):
    """Each jump's proposals over the whole batch after ``iters``
    iterations from 0: the partition of each activation phase times T times
    the phase's iterations (the rotation's totals, whatever the draws)."""
    from ptmcmcsampler_torch.proposals.cycle import activation_thresholds, phase_partitions

    ends = [0] + [min(iters, thr) for thr in activation_thresholds(cfg)] + [iters]
    parts = phase_partitions(cfg)
    return sum(parts[p] * (ends[p + 1] - ends[p]) for p in range(len(parts))) * cfg.ntemps


def per_chain_graphs(card, label, cfg, model, x0, wrappers, iters=PER_CHAIN_GRAPHS_ITERS,
                     block=50):
    """The eager step loop against ``run_block``'s graphs from one seed over
    ``iters`` iterations: every state tensor, host field and generator equal
    bit for bit, and each kernel of ``wrappers`` launched once an iteration
    in both (every kernel kind is active in every phase, on its slice or on
    the whole batch). Returns the result (printed by the caller)."""
    from ptmcmcsampler_torch import build_step
    from ptmcmcsampler_torch.state import state_tensors

    dev = torch.device(DEVICE)
    step, run_block = build_step(cfg, model, device=dev)
    eager, graph = new_state(cfg, model, x0, dev), new_state(cfg, model, x0, dev)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        eager = step(eager)
    torch.cuda.synchronize()
    eager_sec = time.time() - t0
    eager_launches = {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    for i in range(0, iters, block):
        graph, _ = run_block(graph, min(block, iters - i))
    torch.cuda.synchronize()
    graph_sec = time.time() - t0
    stats = run_block.stats
    graph_launches = counted_launches(stats, wrappers)

    def bits(a):
        return a.contiguous().reshape(-1).view(torch.uint8)

    te, tg = state_tensors(eager), state_tensors(graph)
    differ = [p for p in te if not torch.equal(bits(te[p]), bits(tg[p]))]
    if (eager.it, eager.de.filled) != (graph.it, graph.de.filled):
        differ.append("host fields")
    differ += [g for g in ("rng", "host_rng")
               if not torch.equal(getattr(eager, g).get_state(), getattr(graph, g).get_state())]
    prop = graph.counters.jump_proposed.sum((1, 2)).cpu().numpy()
    want = per_chain_expected(cfg, iters)
    name, power = [v.strip() for v in card.split(",", 1)]
    result = {
        "phase": "per_chain", "check": "graphs", "path": label, "mode": cfg.per_chain_mode,
        "chains": [cfg.ntemps, cfg.nchains], "iters": iters, "block": block,
        "cuts": {"burn": {"path": BURN_ITERS // 2, "run": cfg.burn},
                 "cov_update": {"path": 1000, "run": cfg.cov_update}},
        "bitwise_equal": not differ, "differ": differ, "tensors_compared": len(te),
        "eager_ms_per_iter": 1e3 * eager_sec / iters, "graph_ms_per_iter": 1e3 * graph_sec / iters,
        **stats.summary(), "graph_keys": [list(map(str, k)) for k in stats.recorded],
        "eager_launches": eager_launches, "graph_launches": graph_launches,
        "proposals": dict(zip(cfg.jump_names(), prop.tolist())),
        "card": name, "power_limit": power,
    }
    print(json.dumps(result), flush=True)
    if differ:
        raise SystemExit(f"per_chain graphs {label}: the graphs and the eager loop differ in "
                         f"{differ}")
    if any(n != iters for n in (*graph_launches.values(), *eager_launches.values())):
        raise SystemExit(f"per_chain graphs {label}: launches {graph_launches} (graphs), "
                         f"{eager_launches} (eager) for {iters} iterations")
    if cfg.per_chain_rotation and not np.array_equal(prop, want):
        raise SystemExit(f"per_chain graphs {label}: proposals {prop}, expected {want}")
    return result


def phase_per_chain_path(card, label, cfg, model, x0, wrappers, burn, timed, block, stride, cuts):
    """One path's cycle under per_chain rotation at T x C through
    ``run_block``: each kind's proposals equal to the partitions' counts x T
    x the phases' iterations, exactly; each kernel of ``wrappers`` launched
    once an iteration on its slice, counted through the graphs; the moment
    gate on every ``stride``-th cold chain; at least MIN_REPLAYED_SHARE of
    the timed iterations replayed; then the iterations under the profiler.
    Prints its JSON line and returns it."""
    from ptmcmcsampler_torch import build_step
    from ptmcmcsampler_torch.diagnostics import moment_gate
    from ptmcmcsampler_torch.proposals.cycle import phase_partitions

    dev = torch.device(DEVICE)
    t, d, c = cfg.ntemps, cfg.ndim, cfg.nchains
    _, run_block = build_step(cfg, model, device=dev)
    state = new_state(cfg, model, x0, dev)
    stats = run_block.stats
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    for _ in range(burn // block):
        state, out = run_block(state, block)
    torch.cuda.synchronize()
    before = (sum(stats.replays.values()), stats.iterations)
    cold = []
    t1 = time.time()
    for _ in range(timed // block):
        state, out = run_block(state, block)
        cold.append(out.x[:, 0, :, ::stride].clone())
    torch.cuda.synchronize()
    elapsed = time.time() - t1
    del out
    log(f"{label}: {burn} + {timed} iterations, timed {elapsed:.1f}s")
    launches = counted_launches(stats, wrappers)
    graphs = stats.summary()
    graphs["timed_replayed_share"] = ((sum(stats.replays.values()) - before[0])
                                      / (stats.iterations - before[1]))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    prop = state.counters.jump_proposed.sum((1, 2)).cpu().numpy()
    want = per_chain_expected(cfg, burn + timed)
    chains = torch.cat(cold).permute(2, 0, 1)
    del cold
    ok, max_z, ess = moment_gate(chains, model.posterior_moments()[0])
    del chains
    state, prof = phase_profile(state, lambda st, n: run_block(st, n)[0], label,
                                iters=PROFILE_ITERS, iterations="all, graphs")
    name, power = [v.strip() for v in card.split(",", 1)]
    result = {
        "phase": "per_chain", "path": label, "mode": cfg.per_chain_mode, "chains": [t, c],
        "ndim": d, "burn_iters": burn, "timed_iters": timed, "block": block, "cuts": cuts,
        "gate_stride": stride, "iters_per_sec": timed / elapsed,
        "ess_per_sec": float(ess.min()) / elapsed, "moments_ok": ok, "moments_max_z": max_z,
        "slices_by_phase": {str(p): dict(zip(cfg.jump_names(), part.tolist()))
                            for p, part in enumerate(phase_partitions(cfg))},
        "proposals": dict(zip(cfg.jump_names(), prop.tolist())),
        "proposals_expected": dict(zip(cfg.jump_names(), want.tolist())),
        "launches": launches, "iterations": burn + timed, "graphs": graphs,
        "peak_mem_gb": peak_gb, "profile": {k: prof[k] for k in PROFILE_KEYS},
        "jumps": jump_counts(cfg, state), "card": name, "power_limit": power,
    }
    print(json.dumps(result), flush=True)
    checks = {
        "proposals": (prop.tolist(), want.tolist()),
        "launches": (launches, {k: burn + timed for k in wrappers}),
        "moment gate": (ok, True),
        "finite state": (bool(torch.isfinite(state.x).all()), True),
    }
    for what, (got, expect) in checks.items():
        if got != expect:
            raise SystemExit(f"per_chain {label}: {what} is {got}, expected {expect}")
    if graphs["timed_replayed_share"] < MIN_REPLAYED_SHARE:
        raise SystemExit(f"per_chain {label}: only {graphs['timed_replayed_share']:.4f} of the "
                         "timed iterations replayed a graph")
    return result


def phase_per_chain_sampler(card, wrappers):
    """PTSampler(jump_select="per_chain") on the 50-D hierarchy's bound
    methods at T x WIDE_SAMPLER_C (rotation), WIDE_SAMPLER_KW's cycle: each
    kernel once an iteration, the cold chains' proposals of each jump equal
    to the partitions' counts, the chain files' rows, the gate past
    iteration 1000."""
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch.diagnostics import moment_gate

    dev = torch.device(DEVICE)
    model = wide_workload("hierarchical")[0]
    d = model.ndim
    root = tempfile.mkdtemp(prefix="chip_smoke_per_chain_")
    try:
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with contextlib.redirect_stdout(sys.stderr):
            s = PTSampler(d, model.lnlikefn, model.lnpriorfn, np.eye(d),
                          logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
                          ntemps=T, nchains=WIDE_SAMPLER_C, outDir=root, seed=7,
                          jump_select="per_chain")
            t0 = time.time()
            s.sample(np.zeros(d), WIDE_SAMPLER_ITERS, **WIDE_SAMPLER_KW)
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = counted_launches(s.block_stats, wrappers)
        cold = s.state.counters.jump_proposed[:, 0].sum(-1).cpu().numpy()
        want = per_chain_expected(s.config, WIDE_SAMPLER_ITERS) // T
        rows = 1 + WIDE_SAMPLER_ITERS // WIDE_SAMPLER_KW["thin"]
        text = np.loadtxt(os.path.join(root, "chain_1.0.txt"), ndmin=2)
        ok, max_z, ess = moment_gate(s.chains[:, 1000 // WIDE_SAMPLER_KW["thin"] + 1:],
                                     model.posterior_moments()[0])
        name, power = [v.strip() for v in card.split(",", 1)]
        result = {
            "phase": "per_chain", "path": "sampler", "mode": "rotation" if
            s.config.per_chain_rotation else "stacked", "chains": [T, WIDE_SAMPLER_C],
            "ndim": d, "iters": WIDE_SAMPLER_ITERS, "iters_per_sec": WIDE_SAMPLER_ITERS / wall,
            "launches": launches, "cold_proposals": dict(zip(s.config.jump_names(), cold.tolist())),
            "moments_ok": ok, "moments_max_z": max_z, "ess_min_dim": float(ess.min()),
            "graphs": s.block_stats.summary(),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "card": name, "power_limit": power,
        }
        print(json.dumps(result), flush=True)
        if not s.config.per_chain_rotation:
            raise SystemExit("per_chain sampler: expected the rotation at "
                             f"{WIDE_SAMPLER_C} chains")
        checks = {
            "cold proposals": (cold.tolist(), want.tolist()),
            "launches": ({k: launches[k] for k in ("chees_step", "nuts_trees", "hmc_step")},
                         {k: WIDE_SAMPLER_ITERS for k in ("chees_step", "nuts_trees", "hmc_step")}),
            "trajectory entries' launches": (launches["chees_trajectories"]
                                             + launches["hmc_trajectories"], 0),
            "chain text rows x columns": (text.shape, (rows, d + 4)),
            "moment gate": (ok, True),
        }
        for what, (got, expect) in checks.items():
            if got != expect:
                raise SystemExit(f"per_chain sampler: {what} is {got}, expected {expect}")
        return {k: launches[k] for k in ("chees_step", "nuts_trees", "hmc_step")}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_per_chain(card, wrappers):
    """The per_chain phase: the graphs checks (rotation on both paths,
    stacked on path 2 at T x STACKED_C), both paths at full width, then
    PTSampler. Returns each kernel's launches by path."""
    from ptmcmcsampler_torch.config import KIND_CHEES, KIND_HMC, KIND_NUTS

    model, x0 = wide_workload("hierarchical")
    d = model.ndim
    path1 = {KIND_CHEES: wrappers["chees_step"]}
    path2 = {KIND_NUTS: wrappers["nuts_trees"], KIND_HMC: wrappers["hmc_step"]}
    cut = dict(cov_update=GRAPHS_COV_UPDATE)
    launches = {}
    for label, cfg, ws in (
            ("hierarchical", per_chain_config(wide_config(d, GRAPHS_BURN, **cut)), path1),
            ("nuts/hierarchical", per_chain_config(wide_nuts_config(d, GRAPHS_BURN, **cut)),
             path2),
            ("nuts/hierarchical stacked", per_chain_config(dataclasses.replace(
                wide_nuts_config(d, GRAPHS_BURN, **cut), nchains=STACKED_C), "stacked"),
             path2)):
        per_chain_graphs(card, label, cfg, model, x0, ws)
        torch.cuda.empty_cache()
    for label, make, ws in (("hierarchical", wide_config, path1),
                            ("nuts/hierarchical", wide_nuts_config, path2)):
        block, burn, timed, cuts, stride = wide_counts("hierarchical", d,
                                                       {"hierarchical": PER_CHAIN_ITERS[label]})
        result = phase_per_chain_path(card, f"per_chain/{label}",
                                      per_chain_config(make(d, burn)), model, x0, ws, burn,
                                      timed, block, stride, cuts)
        for kind, n in result["launches"].items():
            launches.setdefault(ws[kind].__name__, {})[f"per_chain/{label}"] = n
        torch.cuda.empty_cache()
    for k, n in phase_per_chain_sampler(card, wrappers).items():
        launches.setdefault(k, {})["per_chain/sampler"] = n
    return launches


def forced_leaves(trajlen, depth):
    """The leaves a tree runs with a forced length where no leaf diverges:
    doubling j runs 2**j leaves and stops after an odd leaf k where
    2**j + k >= trajlen; the tree stops after a doubling that reaches it."""
    total = 0
    for j in range(depth):
        for k in range(1, 1 << j, 2):
            if (1 << j) + k >= trajlen:
                return total + k + 1
        total += 1 << j
        if total >= trajlen:
            return total
    return total


def general_cases(model):
    """The general entry's checks: (label, depth, step-size scale, forced
    length), each with the capture. The plain version's trees of 4095 and
    1501 leaves take 30 and 11 s at 50-D (its ordered sums are D launches a
    product), so the 50-D hierarchy takes the two short lengths and its
    user functor (the same template) one; the card tests hold the 50-D
    entry to its plain version with every tree at the cap and at 1500
    (``tests/test_torch_cuda.py``)."""
    cases = [("capped", GENERAL_DEPTH, None, None)]
    cases += [(f"trajlen {n}", GENERAL_DEPTH, 1.0, n) for n in GENERAL_TRAJLENS]
    if model.ndim == 2:
        return cases
    if getattr(model, "cuda_functor", "").startswith("user_"):
        return cases[2:3]
    return cases[1:3]


def phase_general_vs_plain(model, label):
    """The general entry on T x (C - 1) chains against its plain version on
    GENERAL_PLAIN_COLUMNS chains a rung, each case of ``general_cases``: no
    lane may differ in any bit, nor the captured lane's buffers; the trees
    must run past 1023 leaves where the case says (the cap: every tree to
    4095 leaves; a forced length L: 2**j - 1 + an even count past L, the
    same in every lane). At depth 6 the general entry must equal the
    default entry in every bit. Returns ``(largest |kernel - plain|,
    {case: trees})``."""
    from ptmcmcsampler_torch import SamplerConfig, build_default_jumps
    from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts
    from ptmcmcsampler_torch.trajectory import empty_capture

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1515)
    d, c = model.ndim, C - 1
    n = GENERAL_PLAIN_COLUMNS // 2
    cols = torch.cat([torch.arange(n, device=dev), torch.arange(c - n, c, device=dev)])
    err, trees = 0.0, {}

    def inputs(depth):
        if d == 2:
            q0, _, betas, eps, _, chol = trajectory_inputs(gen, dev, 1, c)
            r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, D, c, depth, dev)
        else:
            (q0, r0, betas, eps, expo, dirs, accu, key, chol), r_eps = wide_tree_inputs(
                gen, dev, model, c, depth)
        eps = eps.abs().clamp(min=1e-3).contiguous()  # every lane builds a tree
        return [q0, r0, betas, eps, expo, dirs, accu, key, chol], r_eps

    args, r_eps = inputs(6)
    same = lanes_differ(nuts_trees(*args, model, r_eps=r_eps, general=True),
                        nuts_trees(*args, model, r_eps=r_eps))
    log(f"general {label}: depth 6, {same} lanes differ from the default entry")
    if same:
        raise SystemExit(f"general {label}: the general entry differs from the default one")
    for case, depth, scale, trajlen in general_cases(model):
        args, _ = inputs(depth)
        if scale is None:  # every tree to the cap
            args[3] = torch.full_like(args[3], GENERAL_CAPPED_EPS if d == 2 else 1e-4)
        cfg = SamplerConfig(ndim=d, ntemps=1, nchains=1, groups=((0,),),
                            jumps=build_default_jumps(), nuts_max_depth=depth)
        cap, cap_ref = empty_capture(cfg, dev), empty_capture(cfg, dev)
        t0 = time.time()
        out = nuts_trees(*args, model, force_trajlen=trajlen, capture=cap)
        torch.cuda.synchronize()
        kernel_s = time.time() - t0
        sub = take_columns(args, c, cols)
        t0 = time.time()
        # The reservoir's uniforms of the columns' chains (a chain's Philox
        # counter is its index in the whole batch).
        resu = nuts_uniforms(args[7], depth, T, c).index_select(-1, cols)
        ref = nuts_trees_plain(*sub[:7], resu, sub[8], model, force_trajlen=trajlen,
                               capture=cap_ref)
        del resu
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        got = take_columns(out, c, cols)
        differ = lanes_differ(got, ref)
        cap_differ = [f for f, a, b in zip(("plus", "minus", "ind_plus", "ind_minus", "meta"),
                                           cap.tensors(), cap_ref.tensors())
                      if not torch.equal(a, b)]
        nalpha = out[4]
        stats = {"min_nalpha": float(nalpha.min()), **tree_stats(nalpha, out[5]),
                 "capture_lengths": cap.meta.tolist(), "kernel_s": kernel_s,
                 "plain_s": plain_s}
        trees[case] = stats
        log(f"general {label} {case}: {differ} of {T * 2 * n} lanes differ from the plain "
            f"version, capture differs in {cap_differ}, trees {stats}")
        # The cap: nearly every tree at 2**depth - 1 leaves; a forced length:
        # no tree past forced_leaves (a tree that leaves the prior box or
        # diverges stops before it), and some at it.
        most = (1 << depth) - 1 if trajlen is None else forced_leaves(trajlen, depth)
        stats["share_at_most"] = float((nalpha == most).float().mean())
        want_ok = float(nalpha.max()) == most and (
            trajlen is not None or stats["share_at_most"] >= CAPPED_ALIVE_MIN)
        if differ or cap_differ or not want_ok or int(cap.meta[3]) != 1:
            raise SystemExit(f"general {label} {case}: the general entry disagrees with the "
                             f"plain version ({differ} lanes, capture {cap_differ}) or its trees "
                             f"{stats} are not the case's")
        err = max(err, max_abs_diff(got, ref))
    return err, trees


def phase_nuts_general(card, model, logs, builtin_nuts_log):
    """The nuts_general phase: the general entry against its plain version
    (D = 2, the 50-D hierarchy, its user functor), the default entries'
    ptxas lines against BASE_NUTS_PTXAS, then path 2 on the curved target at depth
    GENERAL_DEPTH with a forced length of GENERAL_PATH_TRAJLEN through
    run_block (every NUTS iteration through the general entry), its gate,
    tree sizes and the general entry's ms a call on the path's final state.
    Returns the general entry's item of the kernels line (its launches by
    path filled in later)."""
    from ptmcmcsampler_torch.config import KIND_HMC, KIND_NUTS
    from ptmcmcsampler_torch.kernel import GENERAL_NUTS
    from ptmcmcsampler_torch.ops.hmc import hmc_step, hmc_trajectories
    from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_trees_plain, nuts_uniforms
    from ptmcmcsampler_torch.proposals.nuts import draw_nuts

    err, trees = {}, {}
    for label, m in (("curved", model), ("hierarchical", wide_workload("hierarchical")[0]),
                     ("user_hierarchical", wide_workload("user_hierarchical")[0])):
        err[label], trees[label] = phase_general_vs_plain(m, label)
        torch.cuda.empty_cache()
    ptxas_now = ptxas_info(builtin_nuts_log)
    ptxas_base = {k: dict(zip(PTXAS_FIELDS, v)) for k, v in BASE_NUTS_PTXAS.items()}
    ptxas_equal = {k: ptxas_now.get(k) == v for k, v in ptxas_base.items()}
    general_ptxas = ptxas_info(logs.get("nuts_general", ""))
    log(f"nuts default entries' ptxas against BASE_NUTS_PTXAS: {ptxas_equal}; "
        f"general: {general_ptxas}")
    if not all(ptxas_equal.values()) or set(ptxas_now) != set(ptxas_base):
        raise SystemExit(f"nuts_general: the default entries' ptxas lines {ptxas_now} differ "
                         f"from BASE_NUTS_PTXAS {ptxas_base}")

    burn, timed = GENERAL_PATH_ITERS
    cfg = dataclasses.replace(nuts_config(burn // 2), nuts_max_depth=GENERAL_DEPTH,
                              nuts_force_trajlen=GENERAL_PATH_TRAJLEN)
    nuts_trees.general_launches = 0
    state, (step, run_block), result, ok = phase_main_path(
        model, card, "nuts_general/curved", cfg, {
            KIND_NUTS: nuts_trees, KIND_HMC: hmc_step}, absent=(hmc_trajectories,),
        burn=burn, timed=timed, block=min(500, burn), compare_iters=20)
    general = run_block.stats.kernel_launches(GENERAL_NUTS, nuts_trees.general_launches)
    every = run_block.stats.kernel_launches("nuts_trees", nuts_trees.launches)
    dev = state.x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(98)
    q0 = (state.adapt.chol_inv.T @ state.x).contiguous()
    eps = state.stepsize.epsilon.contiguous()
    r0, expo, dirs, accu, key, r_eps = draw_nuts(gen, T, D, C, GENERAL_DEPTH, dev)
    args = (q0, r0, state.betas, eps, expo, dirs, accu, key, state.adapt.chol, model)
    kw = dict(force_trajlen=GENERAL_PATH_TRAJLEN)
    kernel_ms = cuda_ms(lambda: nuts_trees(*args, **kw), 5, hold_stream=True)
    wrapper_ms = cuda_ms(lambda: nuts_trees(*args, **kw), 5)
    out = nuts_trees(*args, **kw)
    nalpha = out[4]
    cols = torch.arange(64, device=dev)
    sub = take_columns(args[:9], C, cols)
    resu = nuts_uniforms(key, GENERAL_DEPTH, T, C).index_select(-1, cols)
    plain_ms = once_ms(lambda: nuts_trees_plain(*sub[:7], resu, sub[8], model, **kw))
    del resu
    leaves = float(nalpha.sum())
    levels = float(torch.ceil(torch.log2(nalpha + 1.0)).sum())
    bytes_moved = 4 * ((3 * D + 8) * T * C + 2 * levels) + 4 * (T + D * D) + 16
    ops = OPS_PER_LEAF * leaves + OPS_PER_LEVEL * levels + OPS_PER_STEP * T * C
    past = min(1023, GENERAL_PATH_TRAJLEN - 1)  # the default entries' most leaves
    path_trees = {"min_nalpha": float(nalpha.min()), **tree_stats(nalpha, out[5]),
                  "share_past_1023_leaves": float((nalpha > past).float().mean())}
    del out, state, step, run_block
    result.update(depth=GENERAL_DEPTH, force_trajlen=GENERAL_PATH_TRAJLEN,
                  general_launches=general, nuts_launches_all=every, trees=path_trees,
                  general_ms_per_call=kernel_ms, gate_enforced=False,
                  cuts={"burn_iters": {"bench": BURN_ITERS, "run": burn},
                        "timed_iters": {"bench": TIMED_ITERS, "run": timed}})
    print(json.dumps(result), flush=True)
    log(f"nuts_general path: gate ok {ok} (max z {result['moments_max_z']}), general entry "
        f"{general} of {every} NUTS launches, trees {path_trees}, {kernel_ms:.3f} ms a call")
    if general != every or path_trees[
            "max_nalpha"] != forced_leaves(GENERAL_PATH_TRAJLEN, GENERAL_DEPTH):
        raise SystemExit(f"nuts_general path: general launches {general} of {every}, trees "
                         f"{path_trees}")
    torch.cuda.empty_cache()
    name, power = [v.strip() for v in card.split(",", 1)]
    return kernel_entry(
        "nuts_general", "ptmcmcsampler_tpu/ops/nuts_pallas.py:74 (its XLA fallback, "
        "ptmcmcsampler_tpu/proposals/nuts.py:52)", general, max(err.values()), kernel_ms,
        wrapper_ms, plain_ms, bytes_moved, ops, plain_chains=[T, 64], path="nuts_general/curved", depth=GENERAL_DEPTH,
        force_trajlen=GENERAL_PATH_TRAJLEN, trees=path_trees, checks=trees,
        max_abs_err_by_model=err, ptxas=general_ptxas,
        default_ptxas_equal_base=ptxas_equal, card=name, power_limit=power)


def phase_trajectory_sampler(card, wrappers):
    """PTSampler on the 50-D hierarchy at T x WIDE_SAMPLER_C, path 2's
    cycle, WIDE_SAMPLER_ITERS iterations with trajectoryDir and
    write_burnin=True: three files for each emitted row whose iteration ran
    NUTS (the kinds run_block drew, recorded), the NUTS kernel's launches
    all through the general entry; then the same seeded run without
    trajectoryDir (the default entry): every output file equal."""
    from ptmcmcsampler_torch import PTSampler
    from ptmcmcsampler_torch import kernel as t_kernel
    from ptmcmcsampler_torch.config import KIND_NUTS
    from ptmcmcsampler_torch.ops.nuts import nuts_trees

    dev = torch.device(DEVICE)
    model = wide_workload("hierarchical")[0]
    d = model.ndim
    root = tempfile.mkdtemp(prefix="chip_smoke_trajectory_")
    real_draw = t_kernel.draw_kinds
    drawn = []

    def recording(*a, **k):
        kinds = real_draw(*a, **k)
        drawn.extend(kinds)
        return kinds

    try:
        runs = {}
        for which in ("capture", "plain"):
            for w in wrappers.values():
                w.launches = 0
            nuts_trees.general_launches = 0
            drawn.clear()
            t_kernel.draw_kinds = recording
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            outdir = os.path.join(root, which)
            kw = dict(trajectoryDir=os.path.join(root, "traj"), write_burnin=True) \
                if which == "capture" else {}
            with contextlib.redirect_stdout(sys.stderr):
                s = PTSampler(d, model.lnlikefn, model.lnpriorfn, np.eye(d),
                              logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
                              ntemps=T, nchains=WIDE_SAMPLER_C, outDir=outdir, seed=11)
                t0 = time.time()
                s.sample(np.zeros(d), WIDE_SAMPLER_ITERS, **TRAJ_SAMPLER_KW, **kw)
                torch.cuda.synchronize()
                wall = time.time() - t0
            t_kernel.draw_kinds = real_draw
            nuts = [j.kind for j in s.config.jumps].index(KIND_NUTS)
            thin = TRAJ_SAMPLER_KW["thin"]
            runs[which] = {
                "wall_sec": wall, "iters_per_sec": WIDE_SAMPLER_ITERS / wall,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "launches": counted_launches(s.block_stats, wrappers),
                "general_launches": s.block_stats.kernel_launches(
                    t_kernel.GENERAL_NUTS, nuts_trees.general_launches),
                "nuts_iters": int(s.state.counters.jump_proposed[nuts, 0, 0]),
                "nuts_rows": sum(k == nuts for k in drawn[thin - 1::thin]),
                "kinds_drawn": len(drawn),
            }
            del s
        files = os.listdir(os.path.join(root, "traj"))
        cap = runs["capture"]
        rows = WIDE_SAMPLER_ITERS // TRAJ_SAMPLER_KW["thin"]
        capture_row_bytes = (2 * (1 << NUTS_DEPTH) * (d + 1) + 4) * 4
        equal = same_files(os.path.join(root, "capture"), os.path.join(root, "plain"))
        name, power = [v.strip() for v in card.split(",", 1)]
        result = {
            "phase": "trajectory_sampler", "model": "HierarchicalGaussian", "ndim": d,
            "chains": [T, WIDE_SAMPLER_C], "iters": WIDE_SAMPLER_ITERS,
            "thin": TRAJ_SAMPLER_KW["thin"], "isave": TRAJ_SAMPLER_KW["isave"],
            "files": len(files), "burnin_files": sum(f.startswith("burnin-") for f in files),
            "chain_files_equal": equal, "runs": runs,
            "capture_bytes_per_block": capture_row_bytes * TRAJ_SAMPLER_KW["isave"] // TRAJ_SAMPLER_KW["thin"],
            "capture_bytes_all_rows": capture_row_bytes * rows,
            "card": name, "power_limit": power,
        }
        print(json.dumps(result), flush=True)
        checks = {
            "files": (len(files), 3 * cap["nuts_rows"]),
            "kinds drawn": (cap["kinds_drawn"], WIDE_SAMPLER_ITERS),
            "chain files equal": (equal, True),
            "general launches (capture)": (cap["general_launches"], cap["nuts_iters"]),
            "NUTS launches (capture)": (cap["launches"]["nuts_trees"], cap["nuts_iters"]),
            "general launches (no capture)": (runs["plain"]["general_launches"], 0),
        }
        for what, (got, want) in checks.items():
            if got != want or (what == "files" and not got):
                raise SystemExit(f"trajectory_sampler: {what} is {got}, expected {want}")
        return {"capture": cap["general_launches"]}
    finally:
        t_kernel.draw_kinds = real_draw
        shutil.rmtree(root, ignore_errors=True)


# ---- Multi-process runs (ROADMAP A12): two ranks sharing the card ----------

# The run_block cases, (burn, timed) iterations (bench.py's 3000 + 12000 cut
# to fit the phase's minute: the ranks run eagerly, with their collectives
# staged through host memory), each against the one-process eager run of the
# same seed. sharded/curved: path 1 with the rungs split (2 x 1), DEO by the
# neighbour exchange (what PTSampler picks on that mesh for swap_mode=None),
# a factor refresh every SHARDED_COV_UPDATE; sharded/nuts: path 2 with the
# chains split (1 x 2), so the NUTS and HMC kernels draw from n0 = c0 != 0.
# Both cut from 200 + 400 to 100 + 200 for the cases below (PR 17).
# The user's side of a sharded run (ROADMAP A12b), on the 50-D hierarchy at
# T x SHARDED_USER_C with the chains split (1 x 2), so a per_chain rotation
# slice's chains straddle the ranks: sharded/per_chain_chees, path 1's cycle
# under the rotation (ChEES's per-rung update gathers its slice from both
# ranks); sharded/per_chain_nuts, path 2's (the NUTS and HMC counters at a
# slice's positions); sharded/config4, BASELINE config 4's cycle (the torch
# custom jump, the prior draw, the auxiliary reflection), every rank
# evaluating the user's vmapped callables over the unsharded points.
SHARDED_ITERS = {"sharded/curved": (100, 200), "sharded/nuts": (100, 200),
                 "sharded/per_chain_chees": (100, 200), "sharded/per_chain_nuts": (100, 200),
                 "sharded/config4": (100, 200)}
SHARDED_MESH = {"sharded/curved": (2, 1), "sharded/nuts": (1, 2),
                "sharded/per_chain_chees": (1, 2), "sharded/per_chain_nuts": (1, 2),
                "sharded/config4": (1, 2)}
SHARDED_USER_C = 2048
SHARDED_COV_UPDATE = 150
SHARDED_BLOCK = 100
# sharded_sampler: PTSampler on the 50-D hierarchy at 8 x WIDE_SAMPLER_C over
# two ranks (the rungs split by default), then a resume; sharded_config4_sampler
# the same with config 4's cycle and user's jumps (CUSTOM_SAMPLER_KW,
# register_config4).
SHARDED_SAMPLER_ITERS, SHARDED_SAMPLER_RESUME = 1000, 1500
SHARDED_SAMPLERS = {"sharded_sampler": False, "sharded_config4_sampler": True}
SHARDED_RANKS = 2
SHARDED_TIMEOUT = 300  # seconds a launch of the ranks may take
SHARDED_GROUP_TIMEOUT = 60  # torch.distributed's timeout of a collective, seconds
SHARDED_REPS = 20  # calls an exchange's and a gather's time is the mean of
SHARDED_WIDE_D = 50  # the width the gather and the draws are also timed at
# The state's arrays by the group the sharded lines count differing elements in.
SHARDED_GROUPS = {"x": ("x",), "lnlike": ("lnlike",), "lnprior": ("lnprior",),
                  "naccepted": ("counters/naccepted",),
                  "swaps": ("counters/swaps_",), "adapt": ("adapt/",), "betas": ("betas",),
                  "other": ("stepsize/", "de/", "counters/jump_", "it")}


def sharded_config(label):
    """``(config, model, x0)`` of a sharded run_block case."""
    from ptmcmcsampler_torch.models import CurvedLikelihood

    burn = SHARDED_ITERS[label][0]
    if label == "sharded/curved":
        cfg = dataclasses.replace(headline_config(burn, SHARDED_COV_UPDATE), swap_mode="deo")
        return cfg, CurvedLikelihood(), (-0.1, -0.5)
    if label == "sharded/nuts":
        return nuts_config(burn, SHARDED_COV_UPDATE), CurvedLikelihood(), (-0.1, -0.5)
    model, x0 = wide_workload("hierarchical")
    if label == "sharded/per_chain_chees":
        cfg = per_chain_config(wide_config(model.ndim, burn, SHARDED_COV_UPDATE))
    elif label == "sharded/per_chain_nuts":
        cfg = per_chain_config(wide_nuts_config(model.ndim, burn, SHARDED_COV_UPDATE))
    else:
        cfg = custom_config(model, burn, SHARDED_COV_UPDATE)
    return dataclasses.replace(cfg, nchains=SHARDED_USER_C), model, x0


def sharded_wrappers():
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories
    from ptmcmcsampler_torch.ops.hmc import hmc_step, hmc_trajectories
    from ptmcmcsampler_torch.ops.nuts import nuts_trees

    return {w.__name__: w for w in (chees_step, chees_trajectories, hmc_step,
                                    hmc_trajectories, nuts_trees)}


def sharded_state_arrays(state):
    """The whole state as ``{path: array}`` with the generators' states."""
    from ptmcmcsampler_torch.state import state_to_numpy

    out = state_to_numpy(state)
    out["torch/rng"] = state.rng.get_state().numpy()
    out["torch/host_rng"] = state.host_rng.get_state().numpy()
    return out


def sharded_run(label, mesh=None):
    """A case's iterations by ``run_block`` without graphs, on ``mesh`` (None:
    one process). Returns ``(whole state arrays, timed it/s, launches,
    timings)``: each wrapper's launches over the whole run (its count set to
    0 before it), and on a mesh the host ms of one DEO exchange and of one
    gather of the cold rows (SHARDED_REPS calls after the run)."""
    from ptmcmcsampler_torch import build_step, swaps
    from ptmcmcsampler_torch.parallel.mesh import gather, shard_state, unshard_state
    from ptmcmcsampler_torch.utils import Block

    cfg, model, x0 = sharded_config(label)
    burn, timed = SHARDED_ITERS[label]
    dev = torch.device(DEVICE)
    _, run_block = build_step(cfg, model, device=dev, capture=False, mesh=mesh)
    state = new_state(cfg, model, x0, dev)
    if mesh is not None:
        state = shard_state(state, mesh)
    wrappers = sharded_wrappers()
    for w in wrappers.values():
        w.launches = 0
    # The rank's part of each per_chain rotation slice, by its runs of
    # slice positions: none, one, or two (two launches of the slice's kernel).
    runs = {0: 0, 1: 0, 2: 0}
    pieces = Block.slice_pieces

    def counting(blk, start, n):
        out = pieces(blk, start, n)
        if blk.mesh is not None:  # the rank's own block, not gather_slice's others
            runs[len(out)] += 1
        return out

    Block.slice_pieces = counting
    try:
        for _ in range(burn // SHARDED_BLOCK):
            state, _ = run_block(state, SHARDED_BLOCK)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(timed // SHARDED_BLOCK):
            state, _ = run_block(state, SHARDED_BLOCK)
        torch.cuda.synchronize()
        rate = timed / (time.time() - t0)
    finally:
        Block.slice_pieces = pieces
    launches = {name: w.launches for name, w in wrappers.items()}
    block = run_block.block
    timings = dict.fromkeys(("deo_exchange_ms", "cold_gather_ms", "cold_gather_50d_ms",
                             "global_draw_ms", "local_draw_ms"))
    timings["slice_runs"] = runs
    if block.sharded:
        def host_ms(fn):
            fn()
            torch.cuda.synchronize()
            t1 = time.time()
            for _ in range(SHARDED_REPS):
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.time() - t1) / SHARDED_REPS

        if mesh.ntemp > 1:
            deo = swaps.make_sharded_deo(block)
            us = swaps.block_uniforms(torch.rand((cfg.ntemps - 1, cfg.nchains), device=dev),
                                      block)
            timings["deo_exchange_ms"] = host_ms(lambda: deo(
                us, state.x, state.lnlike, state.lnprior, state.betas, 0))
        timings["cold_gather_ms"] = host_ms(lambda: gather(block, state.x[0], (cfg.ndim, "C")))
        # The same at the 50-D hierarchy's width (3.3 MB of cold rows at
        # 16384 chains), and the cost of drawing the unsharded [T, 50, C]
        # normals and keeping the block against drawing the block alone.
        wide = torch.zeros((SHARDED_WIDE_D, block.c1 - block.c0), device=dev)
        timings["cold_gather_50d_ms"] = host_ms(lambda: gather(block, wide, (50, "C")))
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        dims = ("T", SHARDED_WIDE_D, "C")
        timings["global_draw_ms"] = cuda_ms(lambda: block.draw(torch.randn, gen, dims, dev),
                                            SHARDED_REPS)
        local = (block.t1 - block.t0, SHARDED_WIDE_D, block.c1 - block.c0)
        timings["local_draw_ms"] = cuda_ms(
            lambda: torch.randn(local, generator=gen, device=dev), SHARDED_REPS)
        if cfg.aux_jumps:  # the user's vmapped callables: every point, or the block's
            timings.update(user_jump_timings(cfg, block, state, gen, dev))
    return sharded_state_arrays(unshard_state(state, block)), rate, launches, timings


def user_jump_timings(cfg, block, state, gen, dev):
    """Device ms of config 4's torch-native custom and auxiliary jumps, as
    ``vmap`` batches them, over the unsharded points (what a rank runs, to
    keep the one-process draws) and over the rank's block alone (what it
    would run without that)."""
    from ptmcmcsampler_torch.proposals.custom import batch_aux, batch_jump

    it = torch.zeros((), dtype=torch.int64, device=dev)
    whole = block.spread(state.x, ("T", cfg.ndim, "C"))
    betas = block.spread(state.betas, ("T",), 1.0)
    out = {}
    for name, fn in (("custom", batch_jump(small_gauss_jump)),
                     ("aux", batch_aux(cfg.aux_jumps[0].fn))):
        def call(x, b, _fn=fn, _name=name):
            return _fn(gen, x, b, it) if _name == "custom" else _fn(gen, x, x, b, it)

        out[f"user_{name}_unsharded_ms"] = cuda_ms(lambda: call(whole, betas), SHARDED_REPS)
        out[f"user_{name}_block_ms"] = cuda_ms(lambda: call(state.x, state.betas),
                                               SHARDED_REPS)
    return out


def sharded_sampler(outdir, resume=False, swap_mode=None, config4=False):
    """``PTSampler`` on the 50-D hierarchy's bound methods at 8 x
    WIDE_SAMPLER_C with WIDE_SAMPLER_KW's cycle (with ``config4``, config
    4's: CUSTOM_SAMPLER_KW and the user's jumps of ``register_config4``):
    SHARDED_SAMPLER_ITERS iterations, or with ``resume`` a resume to
    SHARDED_SAMPLER_RESUME. Returns ``(sampler, seconds)``."""
    from ptmcmcsampler_torch import PTSampler

    model = wide_workload("hierarchical")[0]
    s = PTSampler(model.ndim, model.lnlikefn, model.lnpriorfn, np.eye(model.ndim),
                  logl_grad=model.lnlikefn_grad, logp_grad=model.lnpriorfn_grad,
                  ntemps=T, nchains=WIDE_SAMPLER_C, outDir=outdir, seed=7, verbose=False,
                  resume=resume, swap_mode=swap_mode)
    if config4:
        register_config4(s, model)
    torch.cuda.synchronize()
    t0 = time.time()
    s.sample(np.zeros(model.ndim), SHARDED_SAMPLER_RESUME if resume else SHARDED_SAMPLER_ITERS,
             **(CUSTOM_SAMPLER_KW if config4 else WIDE_SAMPLER_KW))
    torch.cuda.synchronize()
    return s, time.time() - t0


def sharded_worker(argv):
    """One rank of the sharded cases (``chip_smoke.py --sharded-worker RANK
    WORLD PORT OUTDIR``): joins the ``gloo`` group on this machine, runs on
    its block on ``cuda:0`` (the ranks share the card) every SHARDED_ITERS
    case by ``run_block`` and then each of SHARDED_SAMPLERS (one launch, so
    the ranks start and join their group once), writes
    ``OUTDIR/rank<r>.json`` (its launches, rates and timings) and, on rank 0,
    each case's whole final state (``<case>.npz``); every rank writes its
    samplers' files into ``OUTDIR/<sampler>/chains``. Loads the kernel
    libraries the parent built."""
    from ptmcmcsampler_torch.parallel import initialize_distributed, make_pt_mesh

    rank, world, port, outdir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    initialize_distributed(f"tcp://localhost:{port}", world, rank, backend="gloo",
                           timeout=SHARDED_GROUP_TIMEOUT)
    torch.cuda.set_device(0)
    out = {"rank": rank, "cases": {}, "samplers": {}}
    for case in SHARDED_ITERS:
        arrays, rate, launches, timings = sharded_run(case, make_pt_mesh(*SHARDED_MESH[case]))
        if rank == 0:
            np.savez(os.path.join(outdir, case.replace("/", "_") + ".npz"), **arrays)
        out["cases"][case] = dict(iters_per_sec=rate, launches=launches, **timings)
    for label, config4 in SHARDED_SAMPLERS.items():
        wrappers = sharded_wrappers()
        for w in wrappers.values():
            w.launches = 0
        chains = os.path.join(outdir, label, "chains")
        s, wall = sharded_sampler(chains, config4=config4)
        first = SHARDED_SAMPLER_ITERS / wall
        s, wall = sharded_sampler(chains, resume=True, config4=config4)
        out["samplers"][label] = dict(
            iters_per_sec=first,
            resume_iters_per_sec=(SHARDED_SAMPLER_RESUME - SHARDED_SAMPLER_ITERS) / wall,
            launches={n: w.launches for n, w in wrappers.items()},
            mesh=[s.mesh.ntemp, s.mesh.nchain], swap_mode=s.config.swap_mode,
            owns_cold=bool(s._owns_cold), graphs=s.block_stats.summary()["capture"])
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    # Leave the group together: a process that exits with gloo's threads
    # still up may abort.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def launch_ranks(outdir, world=SHARDED_RANKS):
    """Run ``world`` ranks of the sharded cases (this script,
    ``--sharded-worker``) and wait for them: a rank that exits non-zero, or
    a launch past SHARDED_TIMEOUT, kills the others and fails the phase.
    Returns each rank's ``rank<r>.json``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(world):
        logf = open(os.path.join(outdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-worker", str(r),
             str(world), str(port), outdir], stdout=logf, stderr=subprocess.STDOUT), logf))
    deadline = time.time() + SHARDED_TIMEOUT
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, code in enumerate(codes) if code not in (None, 0)]
            late = time.time() > deadline
            if bad or late:
                for p, _ in procs:
                    if p.poll() is None:
                        p.kill()
                r = bad[0] if bad else 0
                with open(os.path.join(outdir, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                raise SystemExit(f"sharded: rank {r} "
                                 f"{'failed' if bad else 'ran past the time limit'}:\n{tail}")
            if all(code == 0 for code in codes):
                break
            time.sleep(0.1)
    finally:
        for p, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    results = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def differing(got, want):
    """Elements of ``got`` that differ from ``want`` (arrays by path), by
    SHARDED_GROUPS' groups; a path one lacks counts whole."""
    counts = {g: 0 for g in SHARDED_GROUPS}
    for path in sorted(set(got) | set(want)):
        group = next((g for g, prefixes in SHARDED_GROUPS.items()
                      if any(path == p or path.startswith(p) for p in prefixes)), "other")
        a, b = got.get(path), want.get(path)
        if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
            counts[group] += int(np.size(a if a is not None else b))
        elif path.startswith("torch/"):
            counts[group] += int(a.tobytes() != b.tobytes())
        else:
            counts[group] += int(np.sum(a.view(np.uint8).reshape(a.shape + (-1,))
                                        != b.view(np.uint8).reshape(b.shape + (-1,)))
                                 if a.ndim else a.tobytes() != b.tobytes())
    return counts


def files_differing(a, b):
    """The chain and jump files, ``cov.npy`` and the checkpoint's arrays of
    two output directories that differ, and each rung's all-chain rows past
    the seed row (a multi-process run's sidecars start after it, as the JAX
    package's part files do)."""
    from ptmcmcsampler_torch.io.chainfile import ChainWriter

    out = []
    names = sorted(f for f in os.listdir(b) if f.endswith(".txt") or f == "cov.npy")
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if not os.path.isfile(pa) or not filecmp.cmp(pa, pb, shallow=False):
            out.append(name)
    with np.load(os.path.join(a, "checkpoint.npz")) as x, \
            np.load(os.path.join(b, "checkpoint.npz")) as y:
        out += [f"checkpoint.npz:{k}" for k in y.files
                if k not in x.files or x[k].tobytes() != y[k].tobytes()]
    for temp in sorted(n[len("chain_"):-len(".txt")] for n in names if n.startswith("chain_")):
        wa = ChainWriter(a, np.array([float(temp)]), resume=True).load_all(0)
        wb = ChainWriter(b, np.array([float(temp)]), resume=True).load_all(0)
        if wa is None or wb is None or wa.tobytes() != wb[1:].tobytes():
            out.append(f"chain_all_{temp} rows")
    return out


def phase_sharded(card):
    """ROADMAP A12 on the card: SHARDED_RANKS processes share cuda:0 over
    ``gloo`` (NCCL refuses two ranks on one GPU), each its block of the
    batch, the rows they exchange staged through pinned host memory. Each
    case's final state must equal the one-process run of the same seed in
    every element, and each rank must launch its path's kernels; the
    sharded sampler's files must equal a one-process run's and its
    checkpoint load in one process. Prints one line a case. Returns the
    launches by case and wrapper: ``{case: {wrapper: [rank 0, rank 1]}}``."""
    from ptmcmcsampler_torch.config import KIND_CHEES, KIND_HMC, KIND_NUTS
    from ptmcmcsampler_torch.io.checkpoint import load_checkpoint

    card_name, power = [v.strip() for v in card.split(",", 1)]
    kinds = {"chees_step": KIND_CHEES, "nuts_trees": KIND_NUTS, "hmc_step": KIND_HMC}
    launches_by_case = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        outdir = os.path.join(root, "ranks")
        os.makedirs(outdir)
        t0 = time.time()
        all_ranks = launch_ranks(outdir)
        wall_ranks = time.time() - t0
        for label in SHARDED_ITERS:
            ranks = [r["cases"][label] for r in all_ranks]
            with np.load(os.path.join(outdir, label.replace("/", "_") + ".npz")) as f:
                got = {k: f[k] for k in f.files}
            want, rate, launches, _ = sharded_run(label)
            diff = differing(got, want)
            cfg = sharded_config(label)[0]
            path_kernels = [w for w, k in kinds.items() if k in {j.kind for j in cfg.jumps}]
            by_rank = {w: [r["launches"][w] for r in ranks] for w in path_kernels}
            line = {
                "phase": "sharded", "path": label, "mesh": SHARDED_MESH[label],
                "backend": "gloo", "ranks": SHARDED_RANKS, "device": "cuda:0 shared",
                "graphs": False, "ndim": cfg.ndim, "chains": [cfg.ntemps, cfg.nchains],
                "jump_select": cfg.jump_select, "jumps": list(cfg.jump_names()),
                "aux_jumps": [j.name for j in cfg.aux_jumps], "iters": SHARDED_ITERS[label],
                "cuts": {"bench.py": [BURN_ITERS, TIMED_ITERS], "here": SHARDED_ITERS[label],
                         "chains": [T, C] if cfg.nchains != C else None},
                "differing_elements": diff,
                "iters_per_sec_two_ranks": [r["iters_per_sec"] for r in ranks],
                "iters_per_sec_one_process_eager": rate,
                **{k: ranks[0][k] for k in ("deo_exchange_ms", "cold_gather_ms",
                                            "cold_gather_50d_ms", "global_draw_ms",
                                            "local_draw_ms")},
                **{k: v for k, v in ranks[0].items() if k.startswith("user_")},
                # A rank's part of each rotation slice in none, one or two
                # runs of its positions (a launch of the slice's kernel each).
                "slice_runs_by_rank": [r["slice_runs"] for r in ranks],
                "launches_by_rank": by_rank,
                "launches_one_process": {w: launches[w] for w in path_kernels},
                "launch_sec_all_cases": wall_ranks, "card": card_name, "power_limit": power,
            }
            print(json.dumps(line), flush=True)
            if any(diff.values()):
                raise SystemExit(f"{label}: the sharded run differs from one process: {diff}")
            if not path_kernels or any(n == 0 for v in by_rank.values() for n in v):
                raise SystemExit(f"{label}: a rank launched no {by_rank}")
            launches_by_case[label] = by_rank

        for label, config4 in SHARDED_SAMPLERS.items():
            ranks = [r["samplers"][label] for r in all_ranks]
            one = os.path.join(root, label + "_one_process")
            with contextlib.redirect_stdout(sys.stderr):
                s, wall = sharded_sampler(one, swap_mode="deo", config4=config4)
                s, wall_resume = sharded_sampler(one, resume=True, swap_mode="deo",
                                                 config4=config4)
            chains = os.path.join(outdir, label, "chains")
            diff_files = files_differing(chains, one)
            loaded, meta, restored = load_checkpoint(
                os.path.join(chains, "checkpoint.npz"), s.config, torch.device(DEVICE))
            ran = {j.kind for j in s.config.jumps}
            path_kernels = [w for w, k in kinds.items() if k in ran]
            by_rank = {w: [r["launches"][w] for r in ranks] for w in path_kernels}
            line = {
                "phase": label, "model": "HierarchicalGaussian", "ndim": 50,
                "chains": [T, WIDE_SAMPLER_C], "mesh": ranks[0]["mesh"], "backend": "gloo",
                "swap_mode": ranks[0]["swap_mode"], "graphs": ranks[0]["graphs"],
                "jumps": list(s.config.jump_names()),
                "aux_jumps": [j.name for j in s.config.aux_jumps],
                "protocols": {j.name: j.protocol for j in s._custom_jumps + s._aux_jumps},
                "iters": [SHARDED_SAMPLER_ITERS, SHARDED_SAMPLER_RESUME],
                "cuts": {"bench.py": [BURN_ITERS, TIMED_ITERS],
                         "here": [SHARDED_SAMPLER_ITERS, SHARDED_SAMPLER_RESUME]},
                "files_differing": diff_files,
                "owns_cold": [r["owns_cold"] for r in ranks],
                "checkpoint_loads": bool(restored and meta["iter"] == SHARDED_SAMPLER_RESUME
                                         and loaded.it == SHARDED_SAMPLER_RESUME),
                "iters_per_sec_two_ranks": [r["iters_per_sec"] for r in ranks],
                "resume_iters_per_sec_two_ranks": [r["resume_iters_per_sec"] for r in ranks],
                "iters_per_sec_one_process": SHARDED_SAMPLER_ITERS / wall,
                "resume_iters_per_sec_one_process":
                    (SHARDED_SAMPLER_RESUME - SHARDED_SAMPLER_ITERS) / wall_resume,
                "launches_by_rank": by_rank, "launch_sec_all_cases": wall_ranks,
                "card": card_name, "power_limit": power,
            }
            print(json.dumps(line), flush=True)
            if diff_files or not line["checkpoint_loads"] or line["owns_cold"] != [True, False]:
                raise SystemExit(f"{label}: files differ {diff_files}, checkpoint loads "
                                 f"{line['checkpoint_loads']}, owners {line['owns_cold']}")
            if not by_rank or any(n == 0 for v in by_rank.values() for n in v):
                raise SystemExit(f"{label}: a rank launched no {by_rank}")
            launches_by_case[label] = by_rank
        return launches_by_case
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ptmcmcsampler_torch.config import KIND_CHEES, KIND_HMC, KIND_NUTS
    from ptmcmcsampler_torch.io import native
    from ptmcmcsampler_torch.models import CurvedLikelihood
    from ptmcmcsampler_torch.ops import build, user
    from ptmcmcsampler_torch.ops.chees import chees_step, chees_trajectories
    from ptmcmcsampler_torch.ops.hmc import hmc_step, hmc_trajectories
    from ptmcmcsampler_torch.ops.nuts import nuts_trees

    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"nvcc: {nvcc}")
    # The user models register their functors; every library, built-in and
    # generated, is built at once, one nvcc each.
    users = {name: wide_workload(name)[0] for name in USER_ITERS}
    user_libs = tuple(lib for m in users.values() for lib in user.libraries(m.cuda_functor))
    t0 = time.time()
    logs = build.build(build.SOURCES + user_libs)
    build_sec = time.time() - t0
    for name, text in logs.items():
        log(f"built {name} in {build_sec:.1f}s:\n{text.strip()}")
    t0 = time.time()
    log(f"built the native chain-row formatter {native.build().name} with {native.compiler()}")
    chainio_build_sec = time.time() - t0

    def kernel_log(source):  # a kernel's build log and its user units'
        return logs.get(source, "") + "".join(
            logs.get(lib, "") for lib in user_libs if lib.startswith(source + "_"))

    hmc_all = ptxas_info(kernel_log("hmc_trajectory"))
    hmc_ptxas = {k: v for k, v in hmc_all.items() if "Wide" not in k}
    hmc_ptxas = hmc_ptxas or "not measured (built before)"
    chees_ptxas = ptxas_info(kernel_log("chees_trajectory"))
    wide2_ptxas = {"nuts_tree": ptxas_info(kernel_log("nuts_tree")), "hmc_trajectory": hmc_all}

    model = CurvedLikelihood()
    err = {
        "chees": phase_chees_vs_plain(model),
        "hmc": phase_hmc_vs_plain(model),
        "nuts": phase_nuts_vs_plain(model),
    }
    wide_err = {name: phase_wide_vs_plain(name, wide_workload(name)[0])
                for name in WIDE_ITERS}
    wide2_err = {name: phase_wide_nuts_hmc_vs_plain(name, wide_workload(name)[0])
                 for name in WIDE_NUTS_ITERS}
    user_err, user_timings = {}, {}
    for name, m in users.items():
        builtin = wide_workload("hierarchical")[0] if name == "user_hierarchical" else None
        user_err[name], user_timings[name] = phase_entries_vs_plain(m, builtin)

    path1 = {KIND_CHEES: chees_step}
    path2 = {KIND_NUTS: nuts_trees, KIND_HMC: hmc_step}
    hier, hier_x0 = wide_workload("hierarchical")
    cut = dict(cov_update=GRAPHS_COV_UPDATE)
    for path, cfg, m, x0, wrappers in (
            ("chees", headline_config(GRAPHS_BURN, **cut), model, (-0.1, -0.5), path1),
            ("nuts", nuts_config(GRAPHS_BURN, **cut), model, (-0.1, -0.5), path2),
            ("hierarchical", wide_config(hier.ndim, 2 * GRAPHS_BURN, **cut), hier, hier_x0, path1),
            ("nuts/hierarchical", wide_nuts_config(hier.ndim, 2 * GRAPHS_BURN, **cut), hier,
             hier_x0, path2)):
        phase_graphs(m, card, path, cfg, wrappers, x0)
        torch.cuda.empty_cache()

    cfg = headline_config()
    state, (step, run_block), result, ok = phase_main_path(
        model, card, "chees", cfg, path1, absent=(chees_trajectories,))
    result.update(chees_eps=state.stepsize.chees_eps[:, 0].tolist(),
                  chees_tlen=state.stepsize.chees_tlen[:, 0].tolist())
    print_result(result, ok)
    path1_iters_per_sec = result["iters_per_sec"]
    launches = {"chees_step": result["launches"][KIND_CHEES], "chees_trajectories": 0}
    state, _ = phase_profile(state, advance_kind(run_block, cfg, KIND_CHEES), "chees",
                             iterations=f"{KIND_CHEES} only, graphs")
    kernels = [chees_kernel_entry(model, state, launches, err["chees"])]
    del state, step, run_block

    cfg = nuts_config()
    state, (step, run_block), result, ok = phase_main_path(
        model, card, "nuts", cfg, path2, absent=(hmc_trajectories,))
    result.update(nuts_path_extras(model, state))
    print_result(result, ok)
    launches = result["launches"]
    state, _ = phase_profile(state, advance_kind(run_block, cfg, KIND_HMC), "nuts",
                             iterations=f"{KIND_HMC} only, graphs")
    kernels.append(nuts_kernel_entry(model, state, launches[KIND_NUTS], err["nuts"]))
    kernels.append(hmc_kernel_entry(
        model, state, {"hmc_step": launches[KIND_HMC], "hmc_trajectories": 0}, err["hmc"],
        hmc_ptxas))
    del state, step, run_block

    wrappers = {w.__name__: w for w in (chees_step, chees_trajectories, hmc_step,
                                        hmc_trajectories, nuts_trees)}
    result, sampler_launches = phase_sampler(model, card, path1_iters_per_sec, wrappers)
    print(json.dumps(result), flush=True)
    kernels[0]["launches_by_path"] = {"chees": kernels[0]["launches"], **sampler_launches}

    wide = [phase_wide_path(name, card, wide_err[name], chees_ptxas) for name in WIDE_ITERS]
    wide_nuts, wide_hmc = zip(*(phase_wide_nuts_path(name, card, wide2_err[name], wide2_ptxas)
                                for name in WIDE_NUTS_ITERS))
    result, wide_sampler_launches = phase_wide_sampler(card, wrappers)
    print(json.dumps(result), flush=True)
    phase_chainio(card, chainio_build_sec)
    for items, wrapper in ((wide, "chees_step"), (wide_nuts, "nuts_trees"),
                           (wide_hmc, "hmc_step")):
        for item in items:
            if item["workload"] == "hierarchical":
                item["launches_by_path"]["sampler"] = wide_sampler_launches[wrapper]

    # The user models: path 1 and path 2 through their functors' entries,
    # then PTSampler.
    for name in USER_ITERS:
        item = phase_wide_path(name, card, user_err[name]["chees"], chees_ptxas, USER_ITERS)
        wide.append(user_item(item, user_timings[name]))
    for name in USER_NUTS_ITERS:
        items = phase_wide_nuts_path(name, card, user_err[name], wide2_ptxas, USER_NUTS_ITERS)
        wide_nuts += (user_item(items[0], user_timings[name]),)
        wide_hmc += (user_item(items[1], user_timings[name]),)
    result, user_sampler_launches = phase_user_sampler(card, wrappers)
    print(json.dumps(result), flush=True)
    for items, wrapper in ((wide, "chees_step"), (wide_nuts, "nuts_trees"),
                           (wide_hmc, "hmc_step")):
        for item in items:
            if item["workload"] == "user_hierarchical":
                item["launches_by_path"]["sampler"] = user_sampler_launches[wrapper]
            elif item["workload"] == "user_ref_gaussian" and wrapper != "chees_step":
                item["launches_by_path"]["sampler, reference scenario"] = \
                    user_sampler_launches[f"{wrapper} (user_ref_gaussian)"]
            if item["workload"].startswith("user_"):
                item["build_sec_all_libraries"] = build_sec

    # Past D = 256: every entry against its plain version at the group
    # boundaries, both paths on the 270-D and 1024-D hierarchies, then
    # PTSampler on the 270-D one.
    large_err = {}
    for label, m, b in large_checks():
        t0 = time.time()
        large_err[label], _ = phase_entries_vs_plain(m, b, **LARGE_CHECK)
        print(json.dumps(large_check_line(card, label, m, b, large_err[label],
                                          time.time() - t0)), flush=True)
    for name in LARGE_ITERS:
        wide.append(phase_wide_path(name, card, large_err[name]["chees"], chees_ptxas,
                                    LARGE_ITERS))
    for name in LARGE_NUTS_ITERS:
        items = phase_wide_nuts_path(name, card, large_err[name], wide2_ptxas, LARGE_NUTS_ITERS)
        wide_nuts += (items[0],)
        wide_hmc += (items[1],)
    result, large_sampler_launches = phase_wide_sampler(card, wrappers, LARGE_SAMPLER)
    print(json.dumps(result), flush=True)
    for items, wrapper in ((wide, "chees_step"), (wide_nuts, "nuts_trees"),
                           (wide_hmc, "hmc_step")):
        for item in items:
            if item["workload"] == LARGE_SAMPLER:
                item["launches_by_path"]["sampler"] = large_sampler_launches[wrapper]

    # BASELINE config 4: the user's jumps in the graphs beside the ChEES
    # kernel, through run_block and PTSampler.
    custom_launches = {"custom_jumps": phase_custom_jumps(card)}
    result, launches = phase_wide_sampler(card, wrappers, register=register_config4,
                                          sample_kw=CUSTOM_SAMPLER_KW, phase="custom_sampler")
    result["host_protocol"] = phase_host_jumps()
    print(json.dumps(result), flush=True)
    custom_launches["custom_sampler"] = launches["chees_step"]

    # BASELINE config 5 on one card: DEO swaps and the adaptive ladder on 64
    # rungs, the rolled and iid DE pair laws, PTSampler's ladder and resume.
    phase_tall_ladder_graphs(card)
    custom_launches.update(phase_tall_ladder(card))
    de_launches = phase_de_pairs(card)
    custom_launches["de_rolled"] = de_launches["de_rolled"]
    custom_launches["ladder_sampler"] = phase_ladder_sampler(card, wrappers)
    kernels[0]["launches_by_path"]["de_iid"] = de_launches["de_iid"]
    for item in wide:
        if item["workload"] == "hierarchical":
            item["launches_by_path"].update(custom_launches)

    # The end of ROADMAP A11: per-chain jump selection on both paths and
    # through PTSampler, the NUTS kernel's general entry (depth 12, a forced
    # length, the capture), PTSampler's trajectoryDir.
    per_chain_launches = phase_per_chain(card, wrappers)
    for items, wrapper in ((wide, "chees_step"), (wide_nuts, "nuts_trees"),
                           (wide_hmc, "hmc_step")):
        for item in items:
            if item["workload"] == "hierarchical":
                item["launches_by_path"].update(per_chain_launches.get(wrapper, {}))
    general = phase_nuts_general(card, model, logs, logs.get("nuts_tree", ""))
    traj_launches = phase_trajectory_sampler(card, wrappers)
    general["launches_by_path"] = {"nuts_general/curved": general["launches"],
                                   "trajectory_sampler": traj_launches["capture"]}

    # ROADMAP A12 and A12b: two ranks sharing the card, each case against
    # one process.
    sharded = phase_sharded(card)
    kernels[0]["launches_by_path"]["sharded/curved"] = sharded["sharded/curved"]["chees_step"]
    for k, wrapper in ((kernels[1], "nuts_trees"), (kernels[2], "hmc_step")):
        k.setdefault("launches_by_path", {"nuts": k["launches"]})
        k["launches_by_path"]["sharded/nuts"] = sharded["sharded/nuts"][wrapper]
    for items, wrapper in ((wide, "chees_step"), (wide_nuts, "nuts_trees"),
                           (wide_hmc, "hmc_step")):
        for item in items:
            if item["workload"] == "hierarchical":
                item["launches_by_path"].update(
                    {case: by_rank[wrapper] for case, by_rank in sharded.items()
                     if case not in ("sharded/curved", "sharded/nuts") and wrapper in by_rank})
    kernels[1]["general"] = general
    kernels[0]["wide"] = wide
    kernels[1]["wide"] = list(wide_nuts)
    kernels[2]["wide"] = list(wide_hmc)

    print(json.dumps(barriers_counted_from_code()), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(sys.argv[2:]))
    sys.exit(main())

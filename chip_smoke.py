#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (and on four).

    python3 chip_smoke.py            # every phase; the cards phase needs 4 cards
    python3 chip_smoke.py --cards    # the build and the cards phase alone (4 cards)
    python3 chip_smoke.py --cpu-root # the build and the card vs CPU steps by the CPU's root

Drives ``python_fluid_simulation_tpu_torch`` (never JAX) through its
main paths and checks every CUDA kernel of them against its plain
PyTorch version on the card:

* the flagship: the 48x80x48 buckling funnel (``buckling_config()``
  defaults, 89,648 particles, 'apic' viscosity, CFL dt, Jacobi PCG,
  static solids);
* the 128^3 class: ``scaled_buckling_config(128)`` (77x128x77 cells,
  356,256 particles, MG-preconditioned density and pressure solves,
  Jacobi viscosity);
* the coiling column: ``coiling_config(256)`` (64x256x64 cells, 73,644
  particles, mu 5, MG cell solves, the 'auto' viscosity preconditioner:
  Jacobi-PCG or the batched block MG by the carried hysteresis flag);
* the big grid: ``coiling_config(504)`` (126x504x126 = 8.0M cells,
  465,868 particles, Jacobi cell solves through the live-cell Poisson PCG,
  'auto' viscosity: Jacobi-PCG at 24M faces, or the lean two-grid MG);
* the solver options: the reference's unpreconditioned CG
  (``jacobi_precond=False``: generic CG over the 7-point and the
  materialised coupled matvec kernels) on the flagship, the 128^3 step
  and coiling 'auto', and the dt-scaled pressure assembly
  (``pressure_dt_scaled``) on the flagship and at 128^3;
* the largest particle count: ``scaled_buckling_config(256)``
  (154x256x154 = 6.1M cells, 2,903,629 particles, Jacobi cell solves
  through the live-cell Poisson PCG, Jacobi viscosity PCG at 18M faces),
  whose segment reduces take the scan route (the segmented scan, then
  the placement kernel), as every measured reduce does;
* the learned viscosity operator: the flagship in 'unet' (the network's
  Δv in place of the viscosity solve) and 'unet_warm' (the coupled PCG
  started from the network's guess, rescaled by a line search over two
  geometry matvecs), with the full-width UNet (width 64, 68,723,203
  parameters; weights drawn from ``numpy.random.default_rng(0)`` through
  ``convert.random_flax_unet_params``) run by cuDNN in fp32, TF32 off;
* the learned operator's trainer (``models/train.py``): flagship training
  pairs captured by the 'apic' step, full-width Adam steps in fp32 and
  bf16 (cuDNN forward and backward, deterministic), and the capture ->
  train -> eval pipeline (``models/train_unet_prod.py``) at small counts;
* the sharded step (``step_3d(mesh=)``): the flagship on a 1D mesh of 4
  slots and on a (2, 2) (x, z) mesh, and ``coiling_config(504)``,
  ``scaled_buckling_config(128)`` and ``coiling_config(256)`` on 4
  slots, every slot on the one card (the three solves distributed over
  the slots' blocks, every width-1 axis-0 halo through the halo pull
  kernel, one launch an exchange on the caller's stream; the push kernel
  of rings that span cards is called directly in ``halo``);
* the 2D engine (``engine/step2d.py``): the dam break and the droplet at
  ``SimConfig2D()`` (64x64 cells, the CLI's configuration) and the dam
  break at dx 1/256 (256x256 cells, ~55k particles), eager and captured;
  its folds are row 14's kernel as 3D folds with a unit axis, its solves
  the generic CG (no kernel, as the JAX package's 2D runs in XLA);
* bucketed residency on 1D slab meshes (``parallel/particles.py``,
  ``step_3d(mesh=, bucketed=True)``): the flagship on ``make_mesh(4)``
  and ``coiling_config(504)`` on ``make_mesh(2)``;
* the mesh steps as captured programs (``make_step(cfg, mesh=,
  bucketed=)``, ``simulate(mesh=)``): the sharded, bucketed and learned
  mesh configurations replayed as one CUDA graph each.

Phases, each printing one JSON line:

  device      the card (and its ``nvidia-smi`` name / power limit)
  build       one nvcc -c per csrc/*.cu source, all in parallel, then one
              link; with ptxas' register lines, and the registers, shared
              memory and spills of the kernels redesigned for Hopper
              (the segment broadcast, the tiled geometry matvec, the
              coupled PCG, the live-cell Poisson PCG, the live placement,
              the tiled fold, the V-cycle's tail, the tiled serial reduce
              and the halo pull)
  kernels     flagship: the two PCG kernels on the real density /
              pressure / viscosity systems of the third step vs their
              plain versions: errors, iterations, CUDA-event times, the
              bound from bytes and operations (the coupled PCG: its init
              matvec bitwise, ms an iteration beside its streaming floor;
              the Poisson PCG: its live cells Na, ms an iteration beside
              its active floor; the kernel's own live list equal to the
              plain one); the Poisson PCG's edge cases through both
              wrappers vs plain (b != 0 on zero rows, an all-zero b, an
              all-zero system); the Poisson PCG vs
              tests/poisson_list_model.py's model of it, bitwise;
              every segment broadcast of the step bitwise, timed beside
              torch.index_select; the live route (below) on every reduce
              and fold of the step
  main        flagship: 1 warm-up + 10 timed steps with the launch
              counters reset just before; solves converged, particles
              finite, steps 1-3 on the card each vs the same step on the
              CPU from the same state
  kernels_128 128^3: the density / pressure systems and the scatter
              inputs of the third step; the stencil matvec (its device
              ms beside one CSR product's), the V-cycle's tail on the
              pressure hierarchy (the inputs one V-cycle gives it: bitwise
              its plain version and tests/vcycle_tail_model.py at every
              split of the levels between the grid and one block that
              fits the block's shared memory, each split's device ms;
              ms, device ms, plain ms, bound, barriers), one V-cycle, both
              MG-PCG solves, every segment reduce / broadcast of the
              step, and
              the two PCG kernels and the materialised coupled matvec
              (bitwise), each vs its plain version, with times, library
              times and bounds
  main_128    128^3: 1 warm-up + 5 timed steps with the counters reset
              just before; solves converged, particles finite, one tail
              launch a V-cycle, the first step bitwise repeatable, step 3
              on the card vs the CPU
  kernels_coil coiling: the pressure system, the viscosity system and
              the fold inputs of the third step; the tail and one V-cycle
              of the cell solve's hierarchy (as in kernels_128); the
              coupled PCG (its Jacobi branch), the geometry
              matvec (full and same-axis), the tail of the batched
              viscosity hierarchy (B = 3, as the cell one), one batched
              V-cycle, the viscosity MG-PCG solve, each vs its plain
              version, with times, library times and bounds; the live
              route on every reduce and fold of the step:
              the live placement (from the scan kernel's rows) bitwise
              its plain version, tests/live_table_model.py's model, the
              dense placement kernel and the step's own table; each fold
              of a live table bitwise its plain version, the dense route
              (the fold kernel on the dense table) and the model; each
              fold's whole composite (scan, placement, fold) on the
              kernels, the plain versions, the dense route and the
              model, bitwise; S (the nonempty segments), the ms of the
              placement, its plain version, the dense placement and the
              live route beside one torch.segment_reduce, of each fold,
              its plain version and the dense route beside one
              scatter_reduce_, and the bounds of the live and the dense
              bytes
  main_coil   coiling: 'auto' from the scene and viscosity_precond='mg',
              1 warm-up + 5 timed steps each, and 2 steps of 'auto' with
              visc_mg = 2 (its MG branch) from the 'auto' run's state
              after 2 steps, counters reset just before;
              the branch of every step, solves converged, particles
              finite, one tail launch a V-cycle (cell and batched), the
              first MG step bitwise repeatable, step 3 of
              both runs on the card vs the CPU, peak memory
  kernels_504 504: the density / pressure systems, the viscosity system
              and the level set's fold of the third step; the live-cell
              Poisson PCG (also from a random x0) vs plain, iterations
              equal, with the cell-Poisson route on the same systems and a
              report of the kernel's ms an iteration against the cell
              count and Na over 0.5M-8.0M-cell slabs; the geometry
              matvec (full, same-axis) beside one CSR product (360M
              entries), every segment broadcast of the step (bitwise,
              beside torch.index_select), the coupled PCG, one lean
              preconditioner application (with its inner cycle's tail as
              in kernels_128) and the lean MG-PCG solve (both
              bitwise) at 24M faces; the live route on every reduce and
              fold of the step (as in kernels_coil; the level set's dense
              route folds a 4.0 GB table)
  main_504    504: 4 'auto' steps from the scene (Jacobi branch; the
              third counted, see bytes), then 3
              'auto' steps from visc_mg = 2 (the lean branch), counters
              reset before each run; the Poisson PCG and the lean route
              launched, one tail launch a lean V-cycle, solves converged,
              the first lean step bitwise
              repeatable and within STEP_TOL of the same step on the card
              with every kernel swapped for its plain version, peak
              memory; where that step's card and CPU part (ROADMAP
              queue 3 item 2): both its level sets again on the CPU from
              the card's own positions, the port's bitwise the card's
              (every root of the port correctly rounded on both
              devices); the pressure coefficients from the card's level
              set, card vs CPU bitwise; the card's sqrt and the port's
              CPU root against the correctly rounded root on 4M inputs,
              exact, PyTorch's CPU fp32 sqrt counted (seconds)
  mesh_504    504 sharded over 4 slots from the same scene: 1 warm-up + 2
              timed steps with the counters reset just before; the halo
              kernel launched, solves converged, |dx| < 2e-4 and |dv| < 2e-3
              against main_504's 'auto' run after the same 3 steps (the JAX
              package's sharded-vs-unsharded bars); median step, peak
              memory, iterations beside the unsharded ones; the unsharded
              second step's viscosity system solved by the coupled PCG and
              distributed on the 4 slots (iterations within 3, faces within
              rtol 5e-3 / atol 5e-4: tests/test_parallel.py:275-281), each
              with its residual one iteration before its exit; one profiled
              step (`profile_step.py::profile_steps`): launches, idle share,
              the halo kernel's device ms and launches a step
  kernels_options flagship, jacobi_precond=False, the third step: the
              materialised coupled matvec and the prepared pressure and
              density matvecs (bitwise, with library times and bounds;
              the matvecs' and their CSR products' device ms),
              and the unpreconditioned density, pressure and viscosity
              solves over the kernels vs over their plain versions
              (iterations equal, solutions bitwise)
  main_options flagship jacobi_precond=False (1 warm-up + 5 timed steps;
              the matvec kernels launched, no PCG kernel; the first step
              repeated, reported; step 3 vs the CPU, or where that misses
              STEP_TOL, vs the same step on the card with every kernel
              swapped for its plain version), flagship pressure_dt_scaled
              (3 steps, step 3 checked the same way), 128^3
              jacobi_precond=False (3 steps), 128^3 pressure_dt_scaled
              (3 steps: the generic CG with the V-cycle divided by s; the
              blocked matvec, the tail, the coupled PCG and the scatter
              kernels launched, no Poisson PCG kernel; step 1 checked as
              the flagship's step 3) and coiling 'auto'
              jacobi_precond=False (2 steps from the 'auto' run's state
              after 2 steps: the Jacobi branch over the materialised
              matvec); counters reset before each run, solves converged
  kernels_256 256: every segment reduce of the third step: the serial
              kernel, the segmented scan and the scan route (scan + live
              placement), each vs its plain version (bitwise; the serial
              add within SUM_REL) and the scan route expanded vs the
              serial route (bitwise), with CUDA-event times (and the
              serial kernel's device ms), the torch.segment_reduce time
              and bounds; a 320-channel reduce of the step's ids with
              seeded values through the dense segment_reduce (the serial
              kernel's route): add within SUM_REL of torch.segment_reduce,
              min bitwise its plain version, one launch each; the route sweep: both
              routes on every reduce of a step at all five sizes; the live route on every reduce and
              fold of the step (as in kernels_coil); every segment
              broadcast of the step (bitwise, beside torch.index_select);
              and the live-cell
              Poisson PCG (density, pressure) and the
              coupled PCG (18M faces) on the step's systems vs their plain
              versions, with times and bounds
  main_256    256: 1 warm-up + 2 timed steps (+ the counted third, see
              bytes) with the counters reset just
              before; the scan route with the live placement, the
              live-cell Poisson PCG and the coupled PCG launched, the
              serial reduce not, solves converged, particles finite,
              the first step bitwise repeatable, the last step within
              STEP_TOL of the same step on the card with every kernel
              swapped for its plain version, peak memory
  kernels_unet flagship 'unet_warm', the third step: the fp32 UNet on its
              real (1, 11, 112, 176, 112) feature box vs the same module
              and weights on the CPU (UNET_REL), bf16 vs fp32
              (UNET_BF16_ATOL), a repeat bitwise; CUDA-event times of the
              features, the fp32, bf16 and (reported) TF32 forwards, the
              extraction and the whole learned step beside their bounds
              (3.81 TFLOP a forward, counted from the layers), the peak
              memory of a forward; the step's warm start: the two
              line-search geometry matvecs bitwise their plain version
              (timed beside one CSR product),
              the rescaled x0 bitwise the step's, its residual no larger
              than the extrapolated field's, and the coupled PCG from it
              vs its plain version (its init matvec bitwise, iterations
              equal)
  main_unet   flagship 'unet' then 'unet_warm', 1 warm-up + 5 timed steps
              each with the counters reset just before; solves converged,
              particles finite, no coupled PCG in 'unet', the coupled PCG
              and the geometry matvec in 'unet_warm', the first step
              bitwise repeatable, step 3 within STEP_TOL of the same step
              on the card with every kernel swapped for its plain version
              (the UNet on the card in both), step 3 on the CPU (UNet on
              the CPU) reported; median step, the UNet forward's share of
              a step (CUDA events), the 'apic' viscosity iterations from
              the same states (reported), peak memory
  train       the trainer (models/train.py) on the pipeline's config (the
              flagship at a fixed dt): 5 pairs captured by
              generate_training_data at the full box (finite; pairs 1-4
              with nonzero targets); the width-64 trainer from a fixed
              seed, fp32 (1 warm-up + 3 timed steps) and bf16 (1 warm-up +
              10 timed on pair 1, then a timed pass over pairs 1-4): the
              loss falls, ms a step split into forward, backward and
              optimiser by CUDA events beside their bounds (3 x 3.81
              TFLOP over the fp32 / bf16 peak; Adam's bytes), the peak
              memory of a step; the first step of a fresh trainer run
              twice, bitwise in the loss and every parameter (fp32 and
              bf16); a width-8 trainer, 3 steps on the card and on the
              CPU (losses within 1e-5 relative, the first step's gradients
              within 1e-5 of each tensor's largest, parameters within 1e-2
              x lr x steps, and within lr x steps where the first gradient
              is at Adam's eps or at its rounding); the full-width forward
              with both unpool forms
              (fp32 within UNPOOL_REL, bf16 reported), each form's and
              each unpool's ms; models/train_unet_prod.py capture (6
              steps) -> train (1 bf16 epoch over 5 pairs) -> eval (6
              steps of 'apic', 'unet', 'unet_warm'), counters reset just
              before and read just after: the IoU series and the warm
              start's iterations
  halo        row 15 over meshes of 2, 4 and 8 slots of the card, on the
              blocks of the sharded steps' fields (flagship, 128^3 and 504
              cells and x faces, padded to the slots) and a 4-D input: 200
              back-to-back exchanges with changing contents on each route,
              the pull (through halo.halo_exchange, one launch an exchange)
              and the push (halo_exchange_push called directly, one launch
              a slot), each bitwise its plain version; CUDA-event ms of
              both routes (launch to join) and their device ms, the plain
              route and one torch.cat a slot of the pre-moved planes, the
              same-card byte bound and the computed NVLink plane bound
  psum        the cross-card sum of the distributed dots (mesh_psum.cu,
              one launch a slot, each spinning until every slot's
              partials have landed) over 2 and 4 slots of the card, 1, 2
              and 3 dots, 200 calls with changing partials each bitwise
              the plain slot-order sum; event and device ms beside the
              plain version's and the byte bound (and the NVLink bound of
              the same bytes)
  mesh        flagship sharded on a 1D mesh of 4 slots and a (2, 2) mesh,
              128^3 and coiling_config(256) on 4 slots, 3 steps each with
              the counters reset just before: the halo kernel launched and
              no PCG kernel, solves converged, every step bitwise (x, v,
              c) the same steps with the plain halo patched in, and |dx|
              < 2e-4, |dv| < 2e-3 against the unsharded step on the card
              with the Jacobi preconditioners (the distributed solves are
              Jacobi-PCG); iterations of both printed
  graph       the step as one captured program (engine/step.py::
              make_step: a CUDA graph a state's shapes and 'auto' branch,
              the generic CG loops as WHILE nodes): on the flagship 1
              warm-up of each side, then 10 eager steps (step_3d, the
              geometry built inside) and 10 replays from the same state;
              2 of each on the flagship in 'unet', 'unet_warm' (seeded
              weights) and jacobi_precond=False, 128^3, coiling 256 and
              504 'auto' from the state after 2 steps with the carried
              flag forced to 0 and to 2 (both branches), and 256; 5 on the
              moving box (moving_box_config(1/64)): every step's
              particles, t, step_idx, visc_mg (and the moving solid) and
              metrics bitwise equal, no wrapper launch during the replays,
              one replay a step, the replays of every configuration
              without 'auto' under torch.cuda.set_sync_debug_mode("error"),
              one WHILE node a generic CG solve captured; ms a step of
              each side (CUDA events, and host clock), launches a step,
              capture seconds and the graph pools' bytes, the moving
              body's displacement and the geometry rebuild's ms (eager,
              and replayed alone); the WHILE node's test kernel against
              the host loop on edge cases, its ms a launch beside the
              host test's
  bytes       one line a configuration: the bytes of one
              eager step each main run already takes (its third, counted
              by utils/step_bytes.py::step_bytes: every aten op by one
              rule, every hand kernel by its own count, simulate's copies
              around a replay; left out of the run's timed steps) for the
              flagship, 128^3, coiling 'auto', 504 'auto' (Jacobi), 256
              and the flagship 'unet': GB a step, the kernels' share, the
              ten largest per-op entries, step_bytes_model's GB for the
              same iterations, and roofline() of the count over the graph
              phase's replayed ms a step (achieved GB/s, hbm_util <= 1
              asserted, impl_overhead_x); the counted step builds its
              geometry inside, as those replays do; for the flagship and
              128^3 the CPU's count of the same step from the same state
              (card vs CPU step) beside the card's, both iteration lists
              and the per-op entries that differ, the two counts asserted
              equal where the iterations agree
  cli         the port's CLI (run.main, in a temporary directory): the
              flagship, 30 steps in blocks of 15 with --metrics,
              --snapshot-pickle, --export-obj, --export-html and
              --checkpoint-every 15: every artifact written, every solve
              converged, one capture for the run; resumed from the step-15
              checkpoint: the step-30 state bitwise the uninterrupted
              run's, one capture; the same 30 steps as one simulate call
              (bitwise the CLI's), and the same two blocks with the held
              capture kept and cleared before each (the capture seconds a
              block saves); p2g_axis (each axis) and compute_fluid_volume
              on the final particles through the scan, the live placement
              and the fold kernels (4, 4 and 7 launches), bitwise their
              plain versions; coiling 'auto' through the CLI, 6 steps in
              blocks of 3, one capture a branch reached, and four blocks
              of one replayer from the flags 0, 2, 0, 2: two captures; the
              flagship bucketed on 4 slots (--mesh 4 --bucketed), 10 steps
              in blocks of 5: one capture a run, bucket_lost 0, resumed
              from the step-5 checkpoint bitwise the uninterrupted run,
              one capture; the CLI's steps/s, the per-block overhead, the
              marching cubes' g++ seconds and the surface's triangles
  twod        the 2D dam break and droplet at SimConfig2D() and the dam
              break at dx 1/256: 1 warm-up of each side, then 10 eager
              steps (step_2d) and 10 replays of make_step_2d's graph,
              bitwise, no wrapper launch and no host sync in a replay,
              one WHILE node a solve; the eager run launches rows 11, 13
              and 14 and none of rows 1-10; the third step vs the same
              step with every kernel swapped for its plain version
              (STEP_TOL), the CPU from the card's state reported; every
              fold of that step bitwise fold_plain in 2D, then fold_phase
              on the kernel's 3D form (bitwise plain, the dense route and
              the model; ms, plain ms, scatter_reduce_ ms, bound);
              simulate_2d's held capture bitwise the eager steps; ms a
              step of each side, capture seconds; run.main --scene
              dam_break_2d, 3 steps with --metrics, every solve under
              max_iter
  bucketed    the flagship bucketed on make_mesh(4) and on
              make_mesh2d((2, 2)) (slabs 24 x 24; masses made unique), 3
              steps each with the counters reset just before: the halo
              kernel and rows 11-14 launched, bucket_lost 0, solves
              converged, |dx| < 2e-4 and |dv| < 2e-3 against the unsharded
              step on the card (particles matched by mass), every step
              bitwise the same steps with every kernel swapped for its
              plain version; coiling_config(504) on make_mesh(2) (slab
              width 63) and on (2, 2) (63 x 63), 2 steps the same way, the
              first against the unsharded step; ms a step, launches and
              halo launches a step, peak memory; run.main --scene
              buckling --mesh 4 --bucketed, 3 steps with --metrics: every
              solve converged and bucket_lost 0
  mesh_learned
              the flagship (masses unique) in 'unet' and 'unet_warm' with
              the full-width UNet on make_mesh(4) and (2, 2), and
              'unet_warm' bucketed on (2, 2), 3 steps each with the
              counters reset just before: rows 11-15 launched, 'unet_warm'
              rows 7/8 twice a step (its line search) and no PCG kernel,
              solves converged, every step within |dx| < 2e-4 and |dv| <
              2e-3 of the unsharded learned step on the card (by mass) and
              bitwise the same steps with every kernel swapped for its
              plain version; ms a step, the viscosity iterations and the
              line search's alpha beside the unsharded run's
  graph_mesh  the mesh steps captured (make_step(cfg, mesh=, bucketed=):
              one CUDA graph, the three distributed solves as WHILE
              nodes): the flagship sharded and bucketed on make_mesh(4)
              and (2, 2), 'unet' and 'unet_warm' (full-width UNet) on
              both meshes and 'unet_warm' bucketed on (2, 2),
              coiling_config(504) sharded on 4 slots and bucketed on 2 and
              on (2, 2), 128^3 and coiling_config(256) sharded on 4
              slots, and the moving box (moving_box_config(1/32), its
              geometry rebuilt on the mesh every step) sharded on 4
              slots, 2 steps each, as in graph: 1 warm-up of each
              side, eager steps and replays from the same state bitwise
              (particles, t, step_idx, visc_mg, every metric, bucket_lost
              0), the replays under set_sync_debug_mode("error"), one
              WHILE node a distributed solve, the halo launches of a
              replayed step counted from its iterations and equal to the
              eager steps' counted launches; ms a step of each side,
              capture seconds, pool bytes; simulate(mesh=, bucketed=True)
              twice on the bucketed flagship (one capture, the first call
              bitwise the eager steps); the halo push captured over
              make_mesh(2) and replayed three times, each bitwise the
              eager push, its device epochs advancing with every exchange
  cards       on a host of at least four cards (one line saying so on
              fewer): every card's nvidia-smi line; path 1, the
              single-card step with its state on cuda:3 and cuda:0
              current, eagerly and through make_step (the flagship,
              128^3, coiling 'auto' from visc_mg = 2, the flagship with
              jacobi_precond=False, one lean 504 step), each step bitwise
              the same step on cuda:0 and every launch on cuda:3, the
              halo pull and a 320-channel reduce there too (rows 1-15
              off cuda:0); row 15's push across 2 and 4 cards at every
              field of the sharded steps, bitwise the plain route, event
              and device ms beside one card's push and pull and the
              NVLink bound; the cross-card sum over 2 and 4 cards, 1-3
              dots, 200 calls each bitwise the plain sum on every card,
              its ms a call eagerly and replayed (200 calls in one graph
              over the cards); path 2, slot i on cuda:i: the flagship
              sharded and bucketed on 4 slots and (2, 2), 504 and 128^3
              sharded on 4, 'unet_warm' bucketed on (2, 2), the moving box
              (moving_box_config(1/64)) sharded on 4, 3 steps each (504: 2),
              bitwise the same mesh layout on cuda:0 and the plain-kernel
              steps on the cards, within 2e-4 / 2e-3 of the unsharded
              step by mass (128^3: the unsharded step with the Jacobi
              preconditioners), bucket_lost 0, every x ring pushing and no
              pull; eager ms, each card's idle share and the copies of
              one profiled step; then each of them through
              make_step(mesh=<four cards>) (one CUDA graph over the cards,
              launched on cuda:0, each distributed solve one WHILE node a
              card): 3 replays (504: 2) each bitwise the eager four-card
              step, no host sync and no wrapper launch in a replay, every
              card's iteration count of each solve equal after each
              replay (the captured loops' k replicas) and equal to the
              metric; replayed ms, each card's idle share (its eager busy
              over the replayed ms), capture seconds, pool bytes, nodes;
              simulate(mesh=<four cards>, bucketed=True) twice on the
              bucketed flagship ×4 (one capture, bitwise the eager
              steps); run.main --mesh 4 and --mesh 4 --bucketed over the
              cards, 10 steps in blocks of 5, one capture a run, resumed
              from the step-5 checkpoint bitwise; the profiler's
              fault, reproduced without any kernel of the port
              (WHILE_REPRO_CU, each case in a process of its own): a
              graph over 2 cards with one WHILE node a card and a
              trivial body profiles its replay with the right counts in
              a fresh process (asserted), and faults with an illegal
              address where a profiler session ran before the graph was
              made (reported; so are the same without WHILE nodes and
              on one card, which profile), which is why a replay's idle
              share is still inferred from the eager step

The last lines are the ``nvidia-smi`` line, a ``{"kernels": [...]}``
line, and ``{"ok": true, "device": {...}}``; the "done" phase prints the
total seconds (about 460-600 s on one H100 80GB HBM3 at 700 W, the
kernels' build included).  Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before any
result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, each way
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# fp32 operations a cell / a face does per PCG iteration (matvec, two
# dots, three vector updates, the Jacobi divide), counted from the
# kernels' arithmetic
CELL_OPS_PER_ITER = 27
FACE_OPS_PER_ITER = 85
KERNEL_TOL = dict(rtol=2e-3, atol=2e-4)  # solution vs plain version
MATVEC_TOL = dict(rtol=1e-5, atol=1e-6)  # matvecs vs plain version
# serial segment sums vs plain version: max |difference| over max |value|
# (the kernel rounds as the plain version does and is expected bitwise)
SUM_REL = 1e-6
WIDE_CHANNELS = 320  # above the scan route's 256 channels: the dense segment_reduce takes the serial kernel
STENCIL_OPS = 13  # 7 products + 6 sums a cell
RELAX_OPS = 17  # a relaxation: the stencil, b - Ax, * inv, x + (a cell)
# card step vs the port's CPU step from the same state: fp32 rounding of
# differently ordered sums, as between the port and the JAX package on the
# CPU (tests/test_torch_step.py); measured well inside on the H100
STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
CHECKED_STEPS = (0, 1, 2)  # step 0 solves no viscosity; 1 and 2 do
FLAGSHIP = ((48, 80, 48), 89648)  # grid, particles
RES_128 = 128
SHAPE_128 = ((77, 128, 77), 356256)
STEPS_128 = 6  # 1 warm-up + 5 timed (4 where one is counted)
CHECKED_STEP_128 = 2  # the third step, card vs CPU
# bytes: the third step of a main run is counted (utils/step_bytes.py::
# step_bytes: bitwise the same step, seconds slower) and left out of its
# timed steps
COUNTED_STEP = 2
RES_COIL = 256
SHAPE_COIL = ((64, 256, 64), 73644)
STEPS_COIL = 6  # 1 warm-up + 5 timed, per preconditioner
CHECKED_STEP_COIL = 2  # the third step, card vs CPU
RES_504 = 504
SHAPE_504 = ((126, 504, 126), 465868)
STEPS_504 = 3  # 'auto' from visc_mg = 2: 1 warm-up + 2 timed
STEPS_504_AUTO = 4  # 'auto' from the scene: 1 warm-up + 2 timed + the counted step
SWEEP_PLANES = (8, 16, 32, 63, 126)  # x planes of the 504 pressure system: 0.5M-8.0M cells
SWEEP_ITERS = 50
# fp32 operations a face of the geometry-recompute matvec: the diagonal
# (6 products, 6 sums, s_mu * extra, + center, * v: 15) and 4 a coupling
# (sign*factor * s_mu, * vol, * v, +)
GEOM_MV_OPS = {False: 15 + 4 * 14, True: 15 + 4 * 6}
# the materialised coupled matvec: 15 products and 14 sums a face (its
# bytes: ops/cuda_stencils.py::coupled_stencil_bytes)
COUPLED_OPS_PER_FACE = 29
STEPS_NOJAC = 6  # flagship, jacobi_precond=False: 1 warm-up + 5 timed
STEPS_OPTION = 3  # the other runs of the new options
RES_256 = 256
SHAPE_256 = ((154, 256, 154), 2903629)
STEPS_256 = 4  # 1 warm-up + 2 timed + the counted step
# the kernels of the reduce route every step's reduces take: the scan, then
# the live placement (ops/scatter.py::segment_reduce_cf: the live form)
REDUCE_ROUTE = ("seg_scan_sorted", "binned_segment_place_live")
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
UNET_WIDTH = 64  # the reference UNet's width (model_3d.py)
UNET_PARAMS = 68_723_203  # at 11 input and 3 output channels
UNET_BOX = (1, 11, 112, 176, 112)  # the flagship's feature box (dual lattice 97x161x97 padded to 16s)
UNET_REL = 1e-4  # fp32 forward, card vs CPU: max |difference| over max |output|
UNET_BF16_ATOL = 0.05  # bf16 vs fp32 compute (the JAX package's test_unet.py)
# the pooling level of each layer (voxels = the box's / 8^level)
UNET_LEVEL = {"enc1": 0, "enc2": 1, "enc3": 2, "enc4": 3, "enc5": 4, "dec5": 4, "dec4": 3, "dec3": 2, "dec2": 1,
              "dec1": 0, "unpool4": 4, "unpool3": 3, "unpool2": 2, "unpool1": 1, "fc": 0}
STEPS_UNET = 6  # 1 warm-up + 5 timed, per mode
CHECKED_STEP_UNET = 2  # the third step: card vs plain on the card, and vs the CPU (reported)
# the trainer (models/train.py): flagship pairs captured on the pipeline's
# config (step 0 solves no viscosity: its target is zero), full-width steps
TRAIN_PAIRS = 5
TRAIN_SEED = 0
TRAIN_LR = 1e-4  # make_trainer's default
TRAIN_FP32_STEPS = 3  # timed on pair 1, after 1 warm-up
TRAIN_BF16_STEPS = 10  # timed on pair 1, after 1 warm-up; then one pass over pairs 1-4
# card vs CPU: a width-8 trainer, 3 steps on tests/test_train.py's 16^3
# pair (tests/test_torch_train.py's bounds: losses 1e-5 relative,
# parameters 1e-2 * lr * steps, but see TRAIN_EPS_MARGIN)
TRAIN_SMALL_WIDTH = 8
TRAIN_SMALL_STEPS = 3
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_ATOL_PER_LR_STEP = 1e-2
# the first step's gradients, card vs CPU: max |d| over each tensor's max
# |g| (measured 1.6e-6 in a first run of this check)
TRAIN_GRAD_REL = 1e-5
# entries whose first CPU gradient is below this many times the larger of
# Adam's eps (1e-8, optax's) and the gradient's rounding (TRAIN_GRAD_REL of
# its tensor's largest) are held within lr * steps instead (see
# train_card_vs_cpu; a run of this check: 4.8e-6 among those entries,
# 8.2e-8 among the rest, against 3e-6). A gradient gap dg moves the first
# update by lr * dg * eps / (|g| + eps)^2, under the bound 1e-2 * lr *
# steps once |g| is 10 times both
TRAIN_EPS_MARGIN = 10
UNPOOL_REL = 1e-5  # fast_unpool vs the transposed conv, fp32 forward: max |d| / max |out|
# models/train_unet_prod.py at small counts
PIPE_CAPTURE, PIPE_PAIRS, PIPE_EVAL = 6, 5, 6
# the sharded step: slots of a 1D mesh on the one card, and the JAX
# package's sharded-vs-unsharded bars (__graft_entry__.py:158-159,
# tests/test_parallel.py:184-190)
MESH_SLOTS = 4
MESH_DX, MESH_DV = 2e-4, 2e-3
# the distributed coupled solve vs the single-device one on one system
# (tests/test_parallel.py:275-281)
VISC_MESH_TOL, VISC_MESH_ITERS = dict(rtol=5e-3, atol=5e-4), 3
STEPS_MESH = 3  # flagship, 1D and (2, 2): every step bitwise kernel vs plain halo, and vs unsharded
STEPS_MESH_504 = 3  # 1 warm-up + 2 timed
# the halo kernel: slot counts, and the global fields the sharded step
# exchanges (the x extent padded to a multiple of the slots; the coupled
# CG pads every face array's x to the x-face extent nx + 1)
HALO_SLOTS = (2, 4, 8)
HALO_FIELDS = (
    ("flagship_cells", (48, 80, 48)), ("flagship_xfaces", (49, 80, 48)),
    ("128_cells", (77, 128, 77)), ("128_xfaces", (78, 128, 77)),
    ("504_cells", (126, 504, 126)), ("504_xfaces", (127, 504, 126)),
    ("4d", (16, 6, 5, 3)),
)
# the captured step (graph phase): the flagship's eager and replayed steps,
# the other configurations', and the moving box's
GRAPH_STEPS = 10
GRAPH_CHECK_STEPS = 2  # the other configurations (cut from 3 for the one-card time limit)
MOVING_STEPS = 5
MOVING_DX = 1.0 / 64
MOVING_MESH_DX = 1.0 / 32  # graph_mesh: the moving box on make_mesh(4), 32^3 cells (one-card time limit)
MOVING_MESH_STEPS = 2
# the CLI (cli phase): the flagship in blocks, resumed from its middle
# checkpoint, and coiling; the captures a run counted
CLI_STEPS = 30
CLI_BLOCK = 15
CLI_COIL_STEPS = 6
CLI_COIL_BLOCK = 3
CLI_MESH_STEPS = 10  # the bucketed flagship on 4 slots through run.main: 2 blocks, resumed from the first
CLI_MESH_BLOCK = 5
TWOD_STEPS = 10  # each 2D scene: 10 eager steps and 10 replays after one warm-up each
TWOD_FINE = (1.0 / 256, 1.0 / 512)  # the timed 2D dam break: dx, particle_dx (256x256 cells, ~55k particles)
ROWS_1_TO_10 = ("cell_poisson_pcg", "fused_poisson_pcg", "coupled_visc_pcg", "stencil_matvec", "mg_vcycle_tail",
                "mg_vcycle_tail_batched", "binned_segment_reduce", "coupled_matvec_geom", "coupled_stencil_matvec")
BUCKET_SLOTS = 4  # the flagship bucketed on make_mesh(4): slab width 12
BUCKET_STEPS = 3
BUCKET_504_SLOTS = 2  # coiling_config(504): nx = 126 is not a multiple of 4
BUCKET_504_STEPS = 2
BUCKET_2D = (2, 2)  # the (x, z) mesh of the bucketed and learned mesh runs: flagship slabs 24 x 24, 504 63 x 63
GRAPH_MESH_STEPS = 2  # graph_mesh: eager and replayed steps of each flagship mesh configuration (cut from 3)
GRAPH_MESH_UNET_STEPS = 2  # the learned modes under a mesh (cut from 3)
GRAPH_MESH_504_STEPS = 2  # coiling_config(504) under a mesh (cut from 3)
MESH_LEARNED_STEPS = 3
BUCKET_MASS_STEP = 1e-6  # masses m (1 + 1e-6 i): distinct in fp32 (89,648 and 465,868 particles, within 9% / 47% of m)
CLI_2D_STEPS = 3
HALO_REPS = 200  # back-to-back exchanges with changing contents, each compared bitwise with the plain route
HALO_TIMED = 50
# the cards phase (a host of four or more cards): path 1 on the last of
# them, path 2 over four; steps a configuration, the push's exchanges
CARDS = 4
CARDS_STEPS = 3
CARDS_504_STEPS = 2
CARDS_MOVING_DX = 1.0 / 64  # path 2: the moving box sharded over the four cards, 64^3 cells
CARDS_HALO_SLOTS = (2, 4)
CARDS_HALO_REPS = 100
CARDS_CLI_STEPS = 10  # run.main --mesh 4 [--bucketed] over the cards: 2 blocks, resumed from the first
CARDS_CLI_BLOCK = 5
SPIN_KERNELS = ("halo_push_kernel", "mesh_psum_kernel")  # kernels that wait on other cards' launches
PSUM_SLOTS = (2, 4)  # the cross-card sum on one card: slots of cuda:0, one launch a slot
PSUM_REPS = 200  # calls with changing partials, each compared bitwise with the plain version
PSUM_TIMED = 200


def halo_plane_bounds():
    """Row 15's NVLink bound: one width-1 axis-0 plane of a cell field
    (Y * Z float32) pushed to a neighbour over NVLink, at the sizes of
    the step.  Computed, not measured: the card's machine has one card,
    so the slots of a mesh share it and the pushes stay in its memory."""
    out = {}
    for name, ((_, y, z), _) in (("128", SHAPE_128), ("504", SHAPE_504), ("256", SHAPE_256)):
        out[name] = dict(plane=[y, z], bytes=y * z * 4, bound_ms=y * z * 4 / NVLINK_BYTES_PER_S * 1e3)
    return out


# the kernels redesigned for Hopper, whose ptxas resources the build line lists
REDESIGNED = ("coupled_matvec_kernel", "binned_broadcast_kernel", "coupled_visc_pcg_kernel", "poisson_pcg_kernel",
              "binned_place_live_kernel", "fold_kernel", "mg_vcycle_tail_kernel", "binned_reduce_kernel",
              "halo_pull_kernel")


def kernel_resources(log, names=REDESIGNED):
    """Registers, static shared memory, stack and spills of every compiled
    entry whose mangled name holds one of `names`, from nvcc's
    ``-Xptxas -v`` log."""
    import re

    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1) if any(nm in m.group(1) for nm in names) else None
            if entry:
                out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[entry].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                              spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[entry]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[entry]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms of `fn()` over `reps` calls between CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


@functools.lru_cache(maxsize=None)
def spin_cycles_per_us() -> float:
    """Clock cycles of ``torch.cuda._sleep`` a microsecond, timed once."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 10_000_000 / (start.elapsed_time(stop) * 1e3)


def profiled_ms(fn, reps: int) -> float:
    """Mean of the CUDA kernels' intervals of `reps` back-to-back calls of
    `fn()` under torch.profiler (the host's time between launches left
    out), after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("profiled_ms: the profiler saw no device time")
    return us / 1e3 / reps


def device_times(fns, reps: int) -> dict:
    """Mean device time of each `fns[name]()` over `reps` back-to-back
    calls, after one warm-up call: the calls are queued behind a spin
    kernel that holds the caller's stream for twice the host's time to
    queue them, between two CUDA events, so the device runs them with no
    host time between (what is left between its kernels is the device's
    own); once more with a longer spin where the host took more than 0.8
    of it.  Where the host still cannot queue the calls ahead (a host
    sync inside, or more launches than the device's queue holds: the
    plain versions), `profiled_ms`."""
    import torch

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        spin_us = max(2e6 * (time.perf_counter() - t0), 200.0)
        torch.cuda.synchronize()
        out[name] = None
        for _ in range(2):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_us * spin_cycles_per_us()))
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            queued_us = 1e6 * (time.perf_counter() - t0)
            stop.record()
            torch.cuda.synchronize()
            if queued_us < 0.8 * spin_us:
                out[name] = start.elapsed_time(stop) / reps
                break
            spin_us *= 2
        if out[name] is None:
            out[name] = profiled_ms(fn, reps)
    return out


def device_ms(fn, reps: int) -> float:
    """`device_times` of one function."""
    return device_times({"fn": fn}, reps)["fn"]


def capture_systems(step_3d, state, cfg, geom):
    """Run one step with recorders around the two kernel wrappers as the
    solver modules call them; returns the captured solver inputs."""
    from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

    captured = {"cell": [], "coupled": []}
    orig_cell, orig_coupled = pressure.cell_poisson_pcg, viscosity.coupled_visc_pcg

    def rec_cell(*args, **kw):
        captured["cell"].append((args, kw))
        return orig_cell(*args, **kw)

    def rec_coupled(*args, **kw):
        captured["coupled"].append((args, kw))
        return orig_coupled(*args, **kw)

    pressure.cell_poisson_pcg, viscosity.coupled_visc_pcg = rec_cell, rec_coupled
    try:
        step_3d(state, cfg, geom=geom)
    finally:
        pressure.cell_poisson_pcg, viscosity.coupled_visc_pcg = orig_cell, orig_coupled
    return captured


@contextlib.contextmanager
def patched(replacements):
    """Temporarily set ``module.name = value`` for (module, name, value)."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in replacements]
    for m, n, v in replacements:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def capture_128(step_3d, state, cfg, geom):
    """One 128^3 step with recorders around the cell solves, the coupled
    solve and the segment reduce / broadcast as their callers call them;
    each scatter call is labelled with the function that made it."""
    from python_fluid_simulation_tpu_torch.ops import scatter
    from python_fluid_simulation_tpu_torch.solvers import density, pressure, viscosity

    got = {"cell": [], "coupled": [], "broadcast": []}

    def rec(kind, fn, label_depth=None):
        def call(*args, **kw):
            label = sys._getframe(label_depth).f_code.co_name if label_depth else kind
            got[kind].append((label, args, kw))
            return fn(*args, **kw)
        return call

    with recorded_reduces() as reduces, patched([
        (pressure, "solve_cell_poisson", rec("cell", pressure.solve_cell_poisson)),
        (density, "solve_cell_poisson", rec("cell", density.solve_cell_poisson)),
        (viscosity, "coupled_visc_pcg", rec("coupled", viscosity.coupled_visc_pcg)),
        # frame 2: the caller of the scatter entry point
        (scatter, "segment_broadcast", rec("broadcast", scatter.segment_broadcast, 2)),
    ]):
        step_3d(state, cfg, geom=geom)
    got["reduce"] = reduces
    return got


@contextlib.contextmanager
def plain_mg_routes():
    """The MG-PCG route with the plain versions of its kernels (the
    matvec and the V-cycle's tail), for holding it against the kernels."""
    from python_fluid_simulation_tpu_torch.ops import cuda_mg, cuda_stencils
    from python_fluid_simulation_tpu_torch.solvers import multigrid, pressure

    with patched([
        (multigrid, "stencil_matvec", cuda_stencils.stencil_matvec_plain),
        (multigrid, "vcycle_tail", cuda_mg.vcycle_tail_plain),
        (pressure, "stencil_matvec", cuda_stencils.stencil_matvec_plain),
    ]):
        yield


def bound(nbytes, ops):
    """A kernel's least time: its bytes (each read once, each written
    once: the package's own count of the kernel, `utils/step_bytes.py`'s
    `counted_bytes` formulas) over the card's memory rate, its fp32
    operations over the card's fp32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms)


def rel_err(got, ref):
    d = (got - ref).abs().max().item()
    return d, d / max(ref.abs().max().item(), 1e-30)


def max_err(a, b):
    d = (a - b).abs().max().item()
    return d, d / max(b.abs().max().item(), 1e-30)


def check_close(name, got, ref, tol):
    import torch

    if not torch.allclose(got, ref, **tol):
        d, rel = max_err(got, ref)
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs {d}, rel {rel}, tol {tol})")


def cell_kernel_phase(systems):
    """Cell-Poisson PCG on the density and pressure systems."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        cell_poisson_pcg,
        cell_poisson_pcg_plain,
        poisson_io_bytes,
    )

    rows = []
    for label, (args, kw) in zip(("density", "pressure"), systems):
        b, diag, coefs, pd = args
        x_k, it_k, res_k, _, _ = cell_poisson_pcg(*args, **kw)
        repeatable = bool(torch.equal(x_k, cell_poisson_pcg(*args, **kw)[0]))
        x_p, it_p, res_p, _, _ = cell_poisson_pcg_plain(*args, **kw)
        check_close(f"cell_poisson_pcg[{label}]", x_k, x_p, KERNEL_TOL)
        if abs(int(it_k) - int(it_p)) > 2:
            raise AssertionError(f"cell_poisson_pcg[{label}]: iterations {int(it_k)} vs plain {int(it_p)}")
        ms = cuda_time_ms(lambda: cell_poisson_pcg(*args, **kw), 20)
        init_ms = cuda_time_ms(lambda: cell_poisson_pcg(*args, **dict(kw, max_iter=0)), 20)
        plain_ms = cuda_time_ms(lambda: cell_poisson_pcg_plain(*args, **kw), 2)
        live = poisson_live(b, None, diag, coefs, pd, ms, int(it_k), init_ms)
        nbytes = poisson_io_bytes(b.numel(), False)  # b, diag, 6 coefs, pd read once; x written once
        err, rel = max_err(x_k, x_p)
        rows.append(dict(
            system=label, shape=list(b.shape), iters=int(it_k), plain_iters=int(it_p),
            res=float(res_k), plain_res=float(res_p), max_abs_err=err, max_rel_err=rel,
            bitwise_repeatable=repeatable, ms=ms, plain_ms=plain_ms,
            **bound(nbytes, poisson_ops(int(it_k), live["live_cells"], b.numel(), False)), **live,
        ))
    return rows


def poisson_ops(iters, na, n, reads_x0):
    """fp32 operations of a Poisson PCG solve: the init on every cell
    (r = b - A x0 where an x0 is read, the Jacobi divide and the two
    dots: 4, plus the stencil), the iterations on the Na live cells
    only."""
    return iters * CELL_OPS_PER_ITER * na + ((STENCIL_OPS if reads_x0 else 0) + 4) * n


def kernel_live_cells(b, x0, diag, coefs, pd):
    """The live list and Na that ``csrc/poisson_pcg.cu``'s init builds:
    one max_iter=0 launch through the library's C entry (outside the
    wrappers' counters) into a workspace this script keeps, filled with
    -1 first: the list (n), the flag words, the blocks' counts, then Na.
    Asserts the counts sum to Na, nothing past the list or past Na is
    written, and the list equals `poisson_live_cells_plain`'s.  Returns
    (Na, the launch's block count)."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import _PART_CAP, poisson_live_cells_plain

    n, nwords = b.numel(), (b.numel() + 31) // 32
    x, r, d0, d1, q = (torch.empty_like(b) for _ in range(5))
    part = torch.empty(_PART_CAP, dtype=torch.float32, device=b.device)
    live = torch.full((n + nwords + _PART_CAP // 3 + 1,), -1, dtype=torch.int32, device=b.device)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    res, res0 = (torch.empty((), dtype=torch.float32, device=b.device) for _ in range(2))
    with cb.launching("poisson_pcg list", b, x0, diag, pd) as stream:
        cb.check(cb.LIB.get().pfs_poisson_pcg(
            b.data_ptr(), 0 if x0 is None else x0.data_ptr(), diag.data_ptr(), *[c.data_ptr() for _, c in coefs],
            pd.data_ptr(), x.data_ptr(), r.data_ptr(), d0.data_ptr(), d1.data_ptr(), q.data_ptr(),
            part.data_ptr(), _PART_CAP, live.data_ptr(), live.numel(),
            iters.data_ptr(), res.data_ptr(), res0.data_ptr(), *b.shape, 0.0, 0.0, 0, stream,
        ), "poisson_pcg list launch")
    counts = live[n + nwords:].cpu()
    written = counts >= 0
    grid = int(written.sum()) - 1
    na = int(counts[grid]) if grid >= 1 else -1
    act = live[:n].cpu()
    plain = poisson_live_cells_plain(b, x0, diag, coefs).cpu()
    if (grid < 1 or not bool(written[:grid + 1].all()) or int(counts[:grid].sum()) != na
            or na != plain.numel() or not bool((act[na:] == -1).all())
            or not torch.equal(act[:na].long(), plain)):
        raise AssertionError(f"poisson_pcg's live list: grid {grid}, Na {na} vs plain {plain.numel()}, "
                             f"counts sum {int(counts[:max(grid, 0)].sum())}")
    return na, grid


def poisson_live(b, x0, diag, coefs, pd, ms, iters, init_ms):
    """The live cells Na of a Poisson system (the kernel's own list,
    checked against its plain version: `kernel_live_cells`) and the
    kernel's ms an iteration (with and without its init, a max_iter=0
    solve) beside its active floor, POISSON_LIVE_BYTES * Na over the
    card's memory rate."""
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import POISSON_LIVE_BYTES

    na, _ = kernel_live_cells(b, x0, diag, coefs, pd)
    return dict(live_cells=na, live_fraction=na / b.numel(), init_ms=init_ms, ms_per_iter=ms / max(iters, 1),
                ms_per_iter_after_init=(ms - init_ms) / max(iters, 1),
                active_floor_ms_per_iter=POISSON_LIVE_BYTES * na / HBM_BYTES_PER_S * 1e3)


def poisson_edge_phase(system):
    """The Poisson PCG's edge cases through both wrappers (the cell route,
    a null x0; the fused route, x0 = 0 as a field) vs their plain versions:
    b != 0 on a few zero rows (those cells join the live list; b there is
    tol / 100, so the solve still converges), an all-zero b (0 iterations,
    x = 0, every row of the system live) and an all-zero system (Na = 0).
    Iterations equal, x within KERNEL_TOL, a repeat bitwise; the kernel's
    own list (from a null and from a zeros x0) equal to the plain one."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        cell_poisson_pcg,
        cell_poisson_pcg_plain,
        fused_poisson_pcg,
        fused_poisson_pcg_plain,
        poisson_live_cells_plain,
    )

    (b, diag, coefs, pd), kw = system
    row_nz = diag != 0
    for _, c in coefs:
        row_nz = row_nz | (c != 0)
    zero_rows = torch.nonzero(~row_nz.reshape(-1)).reshape(-1)
    picked = zero_rows[::max(zero_rows.numel() // 8, 1)][:8]
    b_zr = b.clone()
    b_zr.view(-1)[picked] = kw["tol"] / 100
    zeros = torch.zeros_like(b)
    cases = {"rhs_on_zero_rows": (b_zr, diag, coefs, pd), "zero_rhs": (zeros, diag, coefs, pd),
             "zero_system": (zeros, zeros, [(off, zeros) for off, _ in coefs], torch.ones_like(pd))}
    rows = []
    for label, (cb, cd, cc, cp) in cases.items():
        live = poisson_live_cells_plain(cb, None, cd, cc)
        na, _ = kernel_live_cells(cb, None, cd, cc, cp)
        if kernel_live_cells(cb, zeros, cd, cc, cp)[0] != na:
            raise AssertionError(f"poisson_pcg edge case {label}: the list from a zeros x0 differs")
        row = dict(case=label, live_cells=na)
        routes = (("cell", lambda: cell_poisson_pcg(cb, cd, cc, cp, **kw),
                   lambda: cell_poisson_pcg_plain(cb, cd, cc, cp, **kw)),
                  ("fused", lambda: fused_poisson_pcg(cb, zeros, cd, cc, cp, **kw),
                   lambda: fused_poisson_pcg_plain(cb, zeros, cd, cc, cp, **kw)))
        for route, kernel, plain in routes:
            x_k, it_k, *_ = kernel()
            x_k2 = kernel()[0]
            x_p, it_p, *_ = plain()
            name = f"poisson_pcg edge case {label} ({route} route)"
            if int(it_k) != int(it_p):
                raise AssertionError(f"{name}: iterations {int(it_k)} vs plain {int(it_p)}")
            check_close(name, x_k, x_p, KERNEL_TOL)
            if not torch.equal(x_k, x_k2):
                raise AssertionError(f"{name}: a repeated solve differs")
            if label != "rhs_on_zero_rows" and (int(it_k) != 0 or x_k.any()):
                raise AssertionError(f"{name}: {int(it_k)} iterations, max |x| {float(x_k.abs().max())}; want 0 and 0")
            row[route] = dict(iters=int(it_k), plain_iters=int(it_p), max_abs_err=max_err(x_k, x_p)[0],
                              bitwise_repeatable=True)
        if label == "rhs_on_zero_rows" and not bool(torch.isin(picked, live).all()):
            raise AssertionError("poisson_pcg edge case: a zero row with b != 0 is not live")
        if (label == "zero_system") != (row["live_cells"] == 0):
            raise AssertionError(f"poisson_pcg edge case {label}: {row['live_cells']} live cells")
        rows.append(row)
    return rows


def list_model_phase(systems):
    """The Poisson PCG kernel (`cell_poisson_pcg`) on cell systems against
    tests/poisson_list_model.py's `list_pcg`, the model of its init, list
    and order of dot partials that the CPU tests hold against the JAX
    package, run on the CPU at the block count the kernel launched with:
    iterations, res, res0 and x bitwise."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import cell_poisson_pcg, squared_tols

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from poisson_list_model import list_pcg

    rows = []
    for label, ((b, diag, coefs, pd), kw) in zip(("density", "pressure"), systems):
        _, grid = kernel_live_cells(b, None, diag, coefs, pd)
        x_k, it_k, res_k, res0_k, _ = cell_poisson_pcg(b, diag, coefs, pd, **kw)
        tol2, rel2 = squared_tols(kw["tol"], kw["rel_tol"])
        x_m, it_m, res_m, res0_m, _ = list_pcg(
            b.cpu(), None, diag.cpu(), [(off, c.cpu()) for off, c in coefs], pd.cpu(),
            tol2=tol2, rel2=rel2, max_iter=kw["max_iter"], nb=grid)
        x_k = x_k.cpu()
        row = dict(system=label, grid=grid, iters=int(it_k), model_iters=int(it_m),
                   res=float(res_k), model_res=float(res_m), res0=float(res0_k), model_res0=float(res0_m),
                   max_abs_err=max_err(x_k, x_m)[0])
        if not (int(it_k) == int(it_m) and torch.equal(res_k.cpu(), res_m) and torch.equal(res0_k.cpu(), res0_m)
                and torch.equal(x_k, x_m)):
            raise AssertionError(f"poisson_pcg vs tests/poisson_list_model.py: not bitwise: {row}")
        rows.append(row)
    return rows


def timed_once(fn):
    """(fn(), its ms between CUDA events): one call, for a plain version
    too slow to repeat."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def coupled_init_matvec(b, x0, pd, sphi_c, vol_c, s_mu, kw):
    """Row 2's init matvec, bitwise its plain version: with b = 0 and
    max_iter = 0 the final residual is -A x0."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_cg import coupled_visc_pcg, coupled_visc_pcg_plain

    zeros = tuple(torch.zeros_like(t) for t in b)
    mv_kw = dict(kw, max_iter=0)
    *_, r_k = coupled_visc_pcg(zeros, x0, pd, sphi_c, vol_c, s_mu, **mv_kw)
    *_, r_p = coupled_visc_pcg_plain(zeros, x0, pd, sphi_c, vol_c, s_mu, **mv_kw)
    check_bitwise("coupled_visc_pcg init matvec", r_k, r_p)


def coupled_floor(b, sphi_c, vol_c):
    """Row 2's streaming floor an iteration: the geometry read once and 12
    passes over the N faces ((G + 12 N) * 4 bytes over the card's memory
    rate), as csrc/coupled_visc_pcg.cu streams them."""
    from python_fluid_simulation_tpu_torch.ops.cuda_cg import coupled_pcg_iter_bytes, geometry_elements

    return coupled_pcg_iter_bytes(geometry_elements(sphi_c, vol_c), sum(t.numel() for t in b)) / HBM_BYTES_PER_S * 1e3


def coupled_kernel_phase(system):
    """Coupled viscosity PCG on the viscosity system: its init matvec
    bitwise its plain version, the solve within KERNEL_TOL and 2
    iterations of it and bitwise repeated; ms an iteration beside the
    streaming floor.  The plain version's time is its checked solve's."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_cg import (
        coupled_pcg_io_bytes,
        coupled_visc_pcg,
        coupled_visc_pcg_plain,
        geometry_elements,
    )

    (b, x0, pd, sphi_c, vol_c, s_mu), kw = system
    coupled_init_matvec(b, x0, pd, sphi_c, vol_c, s_mu, kw)

    x_k, it_k, res_k, *_ = coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw)
    x_k2 = coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw)[0]
    repeatable = all(bool(torch.equal(u, w)) for u, w in zip(x_k, x_k2))
    (x_p, it_p, res_p, *_), plain_ms = timed_once(
        lambda: coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, **kw))
    err = rel = 0.0
    for a in range(3):
        check_close(f"coupled_visc_pcg[{a}]", x_k[a], x_p[a], KERNEL_TOL)
        e, r = max_err(x_k[a], x_p[a])
        err, rel = max(err, e), max(rel, r)
    if abs(int(it_k) - int(it_p)) > 2:
        raise AssertionError(f"coupled_visc_pcg: iterations {int(it_k)} vs plain {int(it_p)}")
    ms = cuda_time_ms(lambda: coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw), 20)
    n = sum(t.numel() for t in b)
    nbytes = coupled_pcg_io_bytes(geometry_elements(sphi_c, vol_c), n)  # b, x0, pd, geometry read; x written
    ops = (int(it_k) * FACE_OPS_PER_ITER + FACE_OPS_PER_ITER) * n
    return dict(
        system="viscosity", shapes=[list(t.shape) for t in b], iters=int(it_k),
        plain_iters=int(it_p), res=float(res_k), plain_res=float(res_p),
        max_abs_err=err, max_rel_err=rel, matvec_bitwise=True,
        bitwise_repeatable=repeatable, ms=ms, ms_per_iter=ms / max(int(it_k), 1),
        floor_ms_per_iter=coupled_floor(b, sphi_c, vol_c), plain_ms=plain_ms, bytes=nbytes, ops=ops,
        bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
    )


def stencil_phase(cell):
    """7-point matvec on the density and pressure systems (p = b)."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        stencil_matvec,
        stencil_matvec_bytes,
        stencil_matvec_plain,
    )

    rows = []
    for label, (b, (diag, coefs, _)) in cell:
        q_k = stencil_matvec(diag, coefs, b)
        q_p = stencil_matvec_plain(diag, coefs, b)
        check_close(f"stencil_matvec[{label}]", q_k, q_p, MATVEC_TOL)
        n = b.numel()
        rows.append(dict(
            system=label, shape=list(b.shape), bitwise=bool(torch.equal(q_k, q_p)),
            max_abs_err=max_err(q_k, q_p)[0],
            ms=cuda_time_ms(lambda: stencil_matvec(diag, coefs, b), 50),
            device_ms=device_ms(lambda: stencil_matvec(diag, coefs, b), 200),
            plain_ms=cuda_time_ms(lambda: stencil_matvec_plain(diag, coefs, b), 20),
            **bound(stencil_matvec_bytes(n), STENCIL_OPS * n),  # 8 fields read, q written
        ))
    return rows


def chain_ops(n, iters, from_zero, resid):
    """Operations of one smoothing chain on n cells: its relaxations, inv,
    and the residual where it emits one."""
    relax = (iters - 1) * RELAX_OPS + 2 if from_zero else iters * RELAX_OPS
    return n * (relax + 1 + (STENCIL_OPS + 1 if resid else 0))


def tail_bound(tail):
    """The tail's least time: x and r read and the output written at level
    0, each level's 7 stencil fields read once (the workspace is the
    function's own); operations: each level's chains, 7 child sums a coarse
    cell, a prolongation's add a fine cell."""
    from python_fluid_simulation_tpu_torch.ops.cuda_mg import tail_bytes

    n0 = math.prod(tail.fine_shape)
    ns = [lv.diag.numel() for lv in tail.levels]
    big_l, n_s = len(ns), tail.n_smooth
    ops = n0
    for k, n in enumerate(ns):
        ops += 7 * n
        if k == big_l - 1:
            ops += chain_ops(n, tail.coarse_iters, True, False)
        else:
            ops += chain_ops(n, n_s, True, True) + n + chain_ops(n, n_s, False, False)
    return bound(tail_bytes(tail), ops)


def tail_model():
    """tests/vcycle_tail_model.py: the model of the tail kernel's index
    logic (torch only, no JAX)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import vcycle_tail_model

    return vcycle_tail_model


@contextlib.contextmanager
def recorded_tails():
    """Record the first V-cycle tail of what runs inside as the V-cycle
    calls it: [(tail, x, r)] (copies of x and r)."""
    from python_fluid_simulation_tpu_torch.solvers import multigrid

    got, orig = [], multigrid.vcycle_tail

    def rec(tail, x, r):
        if not got:
            got.append((tail, x.clone(), r.clone()))
        return orig(tail, x, r)

    with patched([(multigrid, "vcycle_tail", rec)]):
        yield got


@contextlib.contextmanager
def counted_tails():
    """Count the V-cycle applications of what runs inside (each calls the
    tail once): a one-element list."""
    from python_fluid_simulation_tpu_torch.solvers import multigrid

    calls, orig = [0], multigrid.vcycle_tail

    def count(tail, x, r):
        calls[0] += 1
        return orig(tail, x, r)

    with patched([(multigrid, "vcycle_tail", count)]):
        yield calls


def check_one_tail_a_cycle(launches, calls, label):
    got = launches["mg_vcycle_tail"] + launches["mg_vcycle_tail_batched"]
    if got != calls or not calls:
        raise AssertionError(f"{label}: {got} tail launches for {calls} V-cycles")


def tail_phase(label, tail, x, r):
    """The tail kernel on a real hierarchy's tail inputs vs its plain
    version and tests/vcycle_tail_model.py, bitwise, at the wrapper's split
    and at every other that fits the block's shared memory (each timed as
    device ms: the sweep that sets BLOCK_CELLS); ms (CUDA events, host-bound
    for so short a kernel) and device ms of the kernel and the plain
    version."""
    from python_fluid_simulation_tpu_torch.ops.cuda_mg import (
        BLOCK_CELLS,
        TAIL_SMEM_BYTES,
        launch_tail,
        smem_bytes,
        tail_barriers,
        vcycle_tail,
        vcycle_tail_plain,
    )

    out_p = vcycle_tail_plain(tail, x, r)
    check_bitwise(f"vcycle tail[{label}]", [vcycle_tail(tail, x, r)], [out_p])
    check_bitwise(f"vcycle tail model[{label}]", [tail_model().vcycle_tail_model(tail, x, r)], [out_p])
    fits = [s for s in range(1, len(tail.levels) + 2) if smem_bytes(tail.levels, s) <= TAIL_SMEM_BYTES]
    for s in fits:
        check_bitwise(f"vcycle tail[{label}] split {s}", [launch_tail(tail, x, r, s)], [out_p])
    times = device_times({**{s: functools.partial(launch_tail, tail, x, r, s) for s in fits},
                          "tail": lambda: vcycle_tail(tail, x, r)}, 50)
    # None: the block's levels would not fit its shared memory
    split_ms = {s: times.get(s) for s in range(1, len(tail.levels) + 2)}
    grid_b, block_b = tail_barriers(tail)
    return dict(
        system=label, levels=[list(tail.fine_shape)] + [list(lv.diag.shape) for lv in tail.levels],
        block_level=tail.block_level, block_cells=BLOCK_CELLS, grid_barriers=grid_b, block_barriers=block_b,
        smem_bytes=smem_bytes(tail.levels, tail.block_level),
        bitwise=True, max_abs_err=0.0,
        ms=cuda_time_ms(lambda: vcycle_tail(tail, x, r), 50), device_ms=times["tail"],
        plain_ms=cuda_time_ms(lambda: vcycle_tail_plain(tail, x, r), 10),
        plain_device_ms=device_ms(lambda: vcycle_tail_plain(tail, x, r), 5),
        split_device_ms=split_ms, **tail_bound(tail),
    )


def vcycle_phase(b, diag, coefs, mg_kw, label):
    """The V-cycle's tail on the real hierarchy (`tail_phase`), then one
    whole V-cycle, kernels vs plain versions."""
    import torch

    from python_fluid_simulation_tpu_torch.solvers import multigrid

    mg = multigrid.make_mg_preconditioner(diag, coefs, **mg_kw)
    with recorded_tails() as got:
        z_k = mg(b)
    tail_row = tail_phase(label, *got[0])
    with plain_mg_routes():
        mg_p = multigrid.make_mg_preconditioner(diag, coefs, **mg_kw)
        z_p = mg_p(b)
        plain_ms = cuda_time_ms(lambda: mg_p(b), 10)
    check_close("V-cycle", z_k, z_p, KERNEL_TOL)
    vcycle = dict(
        levels=tail_row["levels"], bitwise=bool(torch.equal(z_k, z_p)),
        max_abs_err=max_err(z_k, z_p)[0], ms=cuda_time_ms(lambda: mg(b), 20), plain_ms=plain_ms,
    )
    return tail_row, vcycle


def mg_solve_phase(cell, kw):
    """Each MG-PCG solve with the kernels vs with their plain versions."""
    from python_fluid_simulation_tpu_torch.solvers import pressure

    rows = []
    for label, (b, coefficients) in cell:
        x_k, st_k = pressure.solve_cell_poisson(b, coefficients, **kw)
        with plain_mg_routes():
            x_p, st_p = pressure.solve_cell_poisson(b, coefficients, **kw)
            plain_ms = cuda_time_ms(lambda: pressure.solve_cell_poisson(b, coefficients, **kw), 3)
        it_k, it_p = int(st_k.iters), int(st_p.iters)
        if abs(it_k - it_p) > 1 or not bool(st_k.converged):
            raise AssertionError(f"MG-PCG[{label}]: iterations {it_k} vs plain {it_p}, converged {bool(st_k.converged)}")
        check_close(f"MG-PCG[{label}]", x_k, x_p, KERNEL_TOL)
        rows.append(dict(
            system=label, iters=it_k, plain_iters=it_p, res=float(st_k.residual),
            rel_res=float(st_k.residual / st_k.initial_residual), max_abs_err=max_err(x_k, x_p)[0],
            ms=cuda_time_ms(lambda: pressure.solve_cell_poisson(b, coefficients, **kw), 5), plain_ms=plain_ms,
        ))
    return rows


def binned_phase(reduces, broadcasts):
    """Every segment reduce / broadcast of the step, the serial reduce
    kernel and the broadcast kernel vs plain versions, with the one-call
    PyTorch yardstick."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn

    red_rows = []
    for label, args, kw, _ in reduces:
        vals, ids, m, op, fill = args
        cf = kw.get("channels_first", False)
        out_k, out_p = cbn.serial_reduce(*args, **kw), cbn.segment_reduce_plain(*args, **kw)
        bitwise = bool(torch.equal(out_k, out_p))
        err, rel = rel_err(out_k, out_p)
        if op == "min" and not bitwise:
            raise AssertionError(f"segment_reduce[{label}] min: kernel differs from plain version (max abs {err})")
        if not rel <= SUM_REL:
            raise AssertionError(f"segment_reduce[{label}]: kernel vs plain max rel {rel} > {SUM_REL}")
        offs = cbn._offsets(ids, m)
        live = int(offs[-1] - offs[0])
        k, c = vals.shape
        red = cbn._OPS[op]
        red_rows.append(dict(
            caller=label, op=op, channels_first=cf, K=k, live_rows=live, C=c, M=m, bitwise=bitwise,
            max_abs_err=err, max_rel_err=rel,
            ms=cuda_time_ms(lambda: cbn.serial_reduce(*args, **kw), 20),
            plain_ms=cuda_time_ms(lambda: cbn.segment_reduce_plain(*args, **kw), 5),
            # one torch.segment_reduce call, offsets computed beforehand,
            # (M, C) output whatever the layout asked for
            library_ms=cuda_time_ms(lambda: torch.segment_reduce(
                vals, red, offsets=offs, axis=0, unsafe=True, initial=float(fill)), 5),
            **bound(cbn.reduce_bytes(live, k, c, m), live * c),
        ))
    dev = device_times({i: functools.partial(cbn.serial_reduce, *args, **kw)
                        for i, (_, args, kw, _) in enumerate(reduces)}, 20)
    for i, row in enumerate(red_rows):
        row["device_ms"] = dev[i]
    return red_rows, broadcast_phase(broadcasts)


def broadcast_phase(broadcasts):
    """Every segment broadcast of a step, (caller, (table, ids), kw): the
    kernel bitwise its plain version, with its time, the plain version's,
    one torch.index_select's and the bound."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn

    rows = []
    for label, (table, ids), _ in broadcasts:
        out_k, out_p = cbn.segment_broadcast(table, ids), cbn.segment_broadcast_plain(table, ids)
        if not torch.equal(out_k, out_p):
            raise AssertionError(f"segment_broadcast[{label}]: kernel differs from plain version")
        del out_k, out_p
        m, c = table.shape
        k = ids.shape[0]
        valid = (ids >= 0) & (ids < m)
        used = int(torch.unique_consecutive(ids[valid]).numel())
        clamped = torch.clamp(ids, 0, m - 1)
        rows.append(dict(
            caller=label, K=k, C=c, M=m, table_rows_used=used, bitwise=True, max_abs_err=0.0,
            ms=cuda_time_ms(lambda: cbn.segment_broadcast(table, ids), 20),
            plain_ms=cuda_time_ms(lambda: cbn.segment_broadcast_plain(table, ids), 5),
            # one torch.index_select on ids clamped beforehand (it does
            # not zero the out-of-range rows)
            library_ms=cuda_time_ms(lambda: torch.index_select(table, 0, clamped), 5),
            **bound(cbn.broadcast_bytes(k, used, c), 0),
        ))
    return rows


@contextlib.contextmanager
def recorded_broadcasts():
    """Record every segment broadcast of what runs inside as its caller
    makes it: a list of (caller, (table, ids), kw)."""
    from python_fluid_simulation_tpu_torch.ops import scatter

    got = []
    fn = scatter.segment_broadcast

    def call(*args, **kw):
        got.append((sys._getframe(2).f_code.co_name, args, kw))  # frame 2: the caller of the scatter entry point
        return fn(*args, **kw)

    with patched([(scatter, "segment_broadcast", call)]):
        yield got


@contextlib.contextmanager
def recorded_reduces():
    """Record every segment reduce of what runs inside as its caller makes
    it (the live form, `scan_reduce`): a list of (caller, args, kw, the
    step's own LiveTable), kw the channels-first layout of the dense
    table the live form replaces (for the serial route)."""
    from python_fluid_simulation_tpu_torch.ops import scatter

    got = []
    fn = scatter.scan_reduce

    def call(*args, **kw):
        out = fn(*args, **kw)
        # frame 2: the caller of the scatter entry point
        got.append((sys._getframe(2).f_code.co_name, args, {"channels_first": True}, out))
        return out

    with patched([(scatter, "scan_reduce", call)]):
        yield got


def reduce_bound(vals, ids, m):
    """The reduce's bound: the live rows and the ids read once, the table
    written once; one combine a live value.  Also the live rows and the
    non-empty segments."""
    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn

    k, c = vals.shape
    offs = cbn._offsets(ids, m)
    live = int(offs[-1] - offs[0])
    nonempty = int((offs[1:] > offs[:-1]).sum())
    return dict(live_rows=live, nonempty_segments=nonempty), bound(cbn.reduce_bytes(live, k, c, m), live * c)


def live_route_bound(vals, ids, m, s):
    """The live route's bound (scan + live placement, the function row 11
    computes): the live rows and the ids read once, the S nonempty
    columns and the map written once; one combine a live value."""
    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn

    k, c = vals.shape
    offs = cbn._offsets(ids, m)
    live = int(offs[-1] - offs[0])
    return bound(cbn.live_route_bytes(live, k, s, c, m), live * c)


def route_sweep(size, reduces):
    """Both reduce routes on each captured reduce of a step: the serial
    kernel (row 10, the dense table) and the scan route (row 11, the
    step's live form), CUDA-event ms of each and the dense reduce's
    bound; the serial table and the live form expanded must agree
    bitwise (both add in row order from fill = 0)."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn

    rows = []
    for caller, args, kw, _ in reduces:
        vals, ids, m, op, fill = args
        k, c = vals.shape
        if not torch.equal(cbn.serial_reduce(*args, channels_first=True), cbn.scan_reduce(*args).dense()):
            raise AssertionError(f"{size} {caller}: the scan route differs from the serial route")
        counts, bnd = reduce_bound(vals, ids, m)
        rows.append(dict(
            size=size, caller=caller, op=op, K=k, C=c, M=m, **counts, bitwise=True,
            serial_ms=cuda_time_ms(lambda: cbn.serial_reduce(*args, channels_first=True), 10),
            scan_route_ms=cuda_time_ms(lambda: cbn.scan_reduce(*args), 10), **bnd,
        ))
    return rows


def scan_route_phase(reduces):
    """Every reduce of the step on both routes: the segmented scan and the
    scan route (scan + live placement) each vs its plain version
    (bitwise), the serial kernel vs its plain version (min bitwise, add
    within SUM_REL), the scan route expanded vs the serial route
    (bitwise); with CUDA-event times, one torch.segment_reduce call and
    the bounds (the scan route's: the live form's bytes)."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn
    from python_fluid_simulation_tpu_torch.ops import cuda_scan

    rows = []
    for caller, args, kw, _ in reduces:
        vals, ids, m, op, fill = args
        cf = kw.get("channels_first", False)
        k, c = vals.shape
        same = cbn.segment_same(ids)
        scan = cuda_scan.seg_scan_sorted(vals, same, op)
        check_bitwise(f"seg_scan_sorted[{caller}]", [scan], [cuda_scan.seg_scan_sorted_plain(vals, same, op)])
        route = cbn.scan_reduce(*args)
        s = same_live(f"scan_reduce[{caller}] vs its plain version", route, cbn.scan_reduce_plain(*args))
        check_bitwise(f"scan route vs serial route[{caller}]", [route.dense()], [cbn.serial_reduce(*args, **kw)])
        del route
        serial_k, serial_p = cbn.serial_reduce(*args, **kw), cbn.segment_reduce_plain(*args, **kw)
        serial_bitwise = bool(torch.equal(serial_k, serial_p))
        err, rel = rel_err(serial_k, serial_p)
        if (op == "min" and not serial_bitwise) or not rel <= SUM_REL:
            raise AssertionError(f"serial reduce[{caller}]: kernel vs plain max abs {err}, rel {rel}")
        del serial_k, serial_p
        counts, bnd = reduce_bound(vals, ids, m)
        offs = cbn._offsets(ids, m)
        rows.append(dict(
            caller=caller, op=op, channels_first=cf, K=k, C=c, M=m, **counts,
            # row 13: each value read once and written once, the flags read
            # once; one combine a value
            seg_scan_sorted=dict(
                bitwise=True, max_abs_err=0.0,
                ms=cuda_time_ms(lambda: cuda_scan.seg_scan_sorted(vals, same, op), 10),
                plain_ms=cuda_time_ms(lambda: cuda_scan.seg_scan_sorted_plain(vals, same, op), 2),
                **bound(cuda_scan.scan_bytes(k, c), k * c)),
            # row 11: the scan route as the step calls it (flags, scan, live
            # placement), the live route's bound
            scan_reduce=dict(
                bitwise=True, max_abs_err=0.0, vs_serial_route_bitwise=True, S=s,
                ms=cuda_time_ms(lambda: cbn.scan_reduce(*args), 10),
                plain_ms=cuda_time_ms(lambda: cbn.scan_reduce_plain(*args), 2),
                # one torch.segment_reduce call, offsets computed beforehand,
                # (M, C) output
                library_ms=cuda_time_ms(lambda: torch.segment_reduce(
                    vals, cbn._OPS[op], offsets=offs, axis=0, unsafe=True, initial=float(fill)), 5),
                **live_route_bound(vals, ids, m, s)),
            serial_reduce=dict(
                bitwise=serial_bitwise, max_abs_err=err, max_rel_err=rel,
                ms=cuda_time_ms(lambda: cbn.serial_reduce(*args, **kw), 10),
                plain_ms=cuda_time_ms(lambda: cbn.segment_reduce_plain(*args, **kw), 5), **bnd),
        ))
        del scan, same, offs
        torch.cuda.empty_cache()
    dev = device_times({i: functools.partial(cbn.serial_reduce, *args, **kw)
                        for i, (_, args, kw, _) in enumerate(reduces)}, 10)
    for i, row in enumerate(rows):
        row["serial_reduce"]["device_ms"] = dev[i]
    return rows


def wide_reduce_phase(reduces):
    """A `WIDE_CHANNELS`-channel reduce of the step's first reduce's ids
    with seeded values, through the dense ``segment_reduce`` (channels
    first): the serial kernel's route, one launch a call.  The add within
    SUM_REL of one torch.segment_reduce, the min bitwise its plain
    version; CUDA-event and device ms, the library call's ms, the bound."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn

    caller, (_, ids, m, _, _), _, _ = reduces[0]
    k = ids.shape[0]
    vals = torch.randn((k, WIDE_CHANNELS), generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    offs = cbn._offsets(ids, m)
    rows = {}
    for op in ("add", "min"):
        def run():
            return cbn.segment_reduce(vals, ids, m, op, 0.0, channels_first=True)

        def library():
            return torch.segment_reduce(vals, cbn._OPS[op], offsets=offs, axis=0, unsafe=True, initial=0.0)

        before = cbn.serial_reduce.launches
        got = run()
        if cbn.serial_reduce.launches - before != 1:
            raise AssertionError(f"{WIDE_CHANNELS}-channel {op}: the dense reduce did not launch the serial kernel once")
        if op == "add":
            lib = library()
            err, rel = rel_err(got, lib.t())
            del lib
            if not rel <= SUM_REL:
                raise AssertionError(f"{WIDE_CHANNELS}-channel add vs torch.segment_reduce: max rel {rel} > {SUM_REL}")
        else:
            check_bitwise(f"{WIDE_CHANNELS}-channel min", [got], [cbn.segment_reduce_plain(vals, ids, m, op, 0.0,
                                                                                           channels_first=True)])
            err, rel = 0.0, 0.0
        del got
        torch.cuda.empty_cache()
        counts, bnd = reduce_bound(vals, ids, m)
        rows[op] = dict(caller=caller, K=k, C=WIDE_CHANNELS, M=m, **counts, max_abs_err=err, max_rel_err=rel,
                        ms=cuda_time_ms(run, 5), library_ms=cuda_time_ms(library, 3), **bnd)
        torch.cuda.empty_cache()
    dev = device_times({op: functools.partial(cbn.segment_reduce, vals, ids, m, op, 0.0, channels_first=True)
                        for op in rows}, 5)
    for op, row in rows.items():
        row["device_ms"] = dev[op]
    return rows


def capture_coil(step_3d, state, cfg, geom):
    """One coiling step with recorders around the cell solves, the coupled
    solve and the fold as their callers call them; each fold is labelled
    with the function that made it."""
    from python_fluid_simulation_tpu_torch.ops import scatter
    from python_fluid_simulation_tpu_torch.solvers import density, pressure, viscosity

    got = {"cell": [], "coupled": [], "fold": []}

    def rec(kind, fn, label_depth=None):
        def call(*args, **kw):
            label = sys._getframe(label_depth).f_code.co_name if label_depth else kind
            got[kind].append((label, args, kw))
            return fn(*args, **kw)
        return call

    with patched([
        (pressure, "solve_cell_poisson", rec("cell", pressure.solve_cell_poisson)),
        (density, "solve_cell_poisson", rec("cell", density.solve_cell_poisson)),
        (viscosity, "coupled_visc_pcg", rec("coupled", viscosity.coupled_visc_pcg)),
        # frame 2: the caller of scatter.fold_scattered_sep
        (scatter, "fold", rec("fold", scatter.fold, 2)),
    ]):
        step_3d(state, cfg, geom=geom)
    return got


def plain_geom_mv(sphi_c, vol_c, s_mu, vs, *, same_axis_only=False, geom=None):
    from python_fluid_simulation_tpu_torch.ops.cuda_cg import coupled_matvec_plain

    return coupled_matvec_plain(sphi_c, vol_c, s_mu, vs, same_axis_only)


def plain_coupled_stencil_mv(diags, per_axis, vs, *, packed=None):
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import coupled_stencil_matvec_plain

    return coupled_stencil_matvec_plain(diags, per_axis, vs)


def check_bitwise(name, got, ref):
    import torch

    for a, (g, r) in enumerate(zip(got, ref)):
        if not torch.equal(g, r):
            raise AssertionError(f"{name}[{a}]: kernel differs from its plain version (max abs {max_err(g, r)[0]})")


def geom_matvec_phase(system):
    """The geometry-recompute coupled matvec, full and same-axis, on the
    viscosity system's x0."""
    from python_fluid_simulation_tpu_torch.ops.cuda_cg import (
        coupled_matvec_geom,
        coupled_matvec_plain,
        flat_geometry,
        geom_matvec_bytes,
    )

    (b, x0, pd, sphi_c, vol_c, s_mu), _ = system
    geom = flat_geometry(sphi_c, vol_c)
    n = sum(t.numel() for t in x0)
    rows = []
    for same in (False, True):
        q_k = coupled_matvec_geom(sphi_c, vol_c, s_mu, x0, same_axis_only=same, geom=geom)
        q_p = coupled_matvec_plain(sphi_c, vol_c, s_mu, x0, same)
        check_bitwise(f"coupled_matvec_geom[same_axis={same}]", q_k, q_p)
        rows.append(dict(
            same_axis_only=same, shapes=[list(t.shape) for t in x0], bitwise=True, max_abs_err=0.0,
            ms=cuda_time_ms(lambda: coupled_matvec_geom(sphi_c, vol_c, s_mu, x0, same_axis_only=same, geom=geom), 50),
            plain_ms=cuda_time_ms(lambda: coupled_matvec_plain(sphi_c, vol_c, s_mu, x0, same), 5),
            **bound(geom_matvec_bytes(geom.numel(), n), GEOM_MV_OPS[same] * n),  # geometry, v read; q written
        ))
    return rows


def geom_matvec_library(system):
    """`coupled_library` for the full geometry matvec on the system's x0."""
    from python_fluid_simulation_tpu_torch.ops.cuda_cg import coupled_matvec_geom

    (_, x0, _, sphi_c, vol_c, s_mu), _ = system
    return coupled_library(sphi_c, vol_c, s_mu, x0, coupled_matvec_geom(sphi_c, vol_c, s_mu, x0))


def batched_vcycle_phase(system):
    """The level-0 batched matvec, the tail of the batched viscosity
    hierarchy (B = 3; `tail_phase`) on one cycle's inputs, and one batched
    V-cycle, kernels vs plain versions."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        stencil_matvec,
        stencil_matvec_bytes,
        stencil_matvec_plain,
    )
    from python_fluid_simulation_tpu_torch.solvers import multigrid, viscosity

    (b, _, _, sphi_c, vol_c, s_mu), _ = system
    # the 21 same-axis fields, as the MG route builds them
    diags, same, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, [t.shape for t in b], same_axis_only=True)
    mg = viscosity.make_viscosity_mg_preconditioner(diags, same)
    levels = mg.levels
    bk = torch.stack([multigrid._pad_to(t, tuple(levels[0].diag.shape[1:])) for t in b])
    top = levels[0]
    q_k, q_p = stencil_matvec(top.diag, top.coefs, bk), stencil_matvec_plain(top.diag, top.coefs, bk)
    check_bitwise("batched level-0 stencil_matvec", [q_k], [q_p])
    level0 = dict(
        shape=list(bk.shape), bitwise=True,
        ms=cuda_time_ms(lambda: stencil_matvec(top.diag, top.coefs, bk), 50),
        plain_ms=cuda_time_ms(lambda: stencil_matvec_plain(top.diag, top.coefs, bk), 20),
        **bound(stencil_matvec_bytes(bk.numel()), STENCIL_OPS * bk.numel()),
    )
    with recorded_tails() as got:
        z_k = mg(b)
    tail_row = tail_phase("coiling viscosity (batched)", *got[0])
    with plain_mg_routes():
        mg_p = viscosity.make_viscosity_mg_preconditioner(diags, same)
        z_p = mg_p(b)
        plain_ms = cuda_time_ms(lambda: mg_p(b), 10)
    for a in range(3):
        check_close(f"batched V-cycle[{a}]", z_k[a], z_p[a], KERNEL_TOL)
    vcycle = dict(
        levels=[list(lv.diag.shape) for lv in levels],
        bitwise=all(bool(torch.equal(u, w)) for u, w in zip(z_k, z_p)),
        max_abs_err=max(max_err(u, w)[0] for u, w in zip(z_k, z_p)),
        ms=cuda_time_ms(lambda: mg(b), 20), plain_ms=plain_ms,
    )
    return level0, tail_row, vcycle


def visc_mg_solve_phase(system):
    """The viscosity MG-PCG solve (the MG branch; above 4M face cells the
    lean route) with the kernels vs with their plain versions; iterations
    must be equal.  The plain time is its checked solve's."""
    from python_fluid_simulation_tpu_torch.solvers import viscosity

    (b, x0, pd, sphi_c, vol_c, s_mu), kw = system
    shapes = [tuple(t.shape) for t in b]

    def solve():
        return viscosity._mg_solve(b, x0, s_mu, sphi_c, vol_c, shapes, **kw)

    x_k, st_k = solve()
    with plain_mg_routes(), patched([(viscosity, "coupled_matvec_geom", plain_geom_mv)]):
        (x_p, st_p), plain_ms = timed_once(solve)
    it_k, it_p = int(st_k.iters), int(st_p.iters)
    if it_k != it_p or not bool(st_k.converged):
        raise AssertionError(f"viscosity MG-PCG: iterations {it_k} vs plain {it_p}, converged {bool(st_k.converged)}")
    for a in range(3):
        check_close(f"viscosity MG-PCG[{a}]", x_k[a], x_p[a], KERNEL_TOL)
    return dict(
        iters=it_k, plain_iters=it_p, res=float(st_k.residual), rel_res=float(st_k.residual / st_k.initial_residual),
        bitwise=all(bool((u == w).all()) for u, w in zip(x_k, x_p)),
        max_abs_err=max(max_err(u, w)[0] for u, w in zip(x_k, x_p)),
        ms=cuda_time_ms(solve, 3), plain_ms=plain_ms,
    )


def fold_targets(seg, axis_shifts, out_shape):
    """Flat target index of every (channel, source cell) of a fold, for
    the one-call library yardstick."""
    import itertools

    import torch

    dev = seg.device
    idx = []
    for shifts in itertools.product(*axis_shifts):
        t = None
        for a, s in enumerate(shifts):
            e = torch.arange(seg.shape[1 + a], device=dev)
            ta = torch.clamp(e + s, 0, int(out_shape[a]) - 1)
            shape = [1, 1, 1]
            shape[a] = -1
            ta = ta.reshape(shape)
            t = ta if t is None else t * int(out_shape[a]) + ta
        idx.append(t.expand(*seg.shape[1:]).reshape(-1))
    return torch.cat(idx)


def bits_equal(a, b):
    """Equal shapes and equal bits (-0.0 is not 0.0)."""
    import torch

    return tuple(a.shape) == tuple(b.shape) and torch.equal(a.contiguous().view(torch.int32),
                                                           b.contiguous().view(torch.int32))


def same_live(name, got, ref):
    """Two live tables: the same map and the same written columns,
    bitwise; returns the nonempty count S."""
    import torch

    s = int((got.slot >= 0).sum())
    if not (torch.equal(got.slot, ref.slot) and got.live.shape == ref.live.shape
            and bits_equal(got.live[:, :s], ref.live[:, :s])):
        raise AssertionError(f"{name}: the live tables differ")
    return s


def live_model():
    """tests/live_table_model.py: the model of the live placement's and the
    tiled fold's index logic (torch only, no JAX)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import live_table_model

    return live_table_model


@contextlib.contextmanager
def recorded_folds():
    """Record every fold of what runs inside as its caller makes it: a
    list of (caller, args, kw)."""
    from python_fluid_simulation_tpu_torch.ops import scatter

    got = []
    fn = scatter.fold

    def call(*args, **kw):
        got.append((sys._getframe(2).f_code.co_name, args, kw))  # frame 2: the caller of scatter.fold_scattered_sep
        return fn(*args, **kw)

    with patched([(scatter, "fold", call)]):
        yield got


def fold_phase(folds):
    """Every fold of the step on its live table: the kernel bitwise its
    plain version (the dense expansion folded), the dense route (the
    kernel on the dense expansion) and tests/live_table_model.py's model;
    CUDA-event ms of each, one ``scatter_reduce_`` over the dense values
    and target indices computed beforehand (the library yardstick), S,
    the targets whose window holds a nonempty source, and the bound of
    the live bytes beside the dense table's."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_fold

    model = live_model()
    rows = []
    for label, args, kw in folds:
        table, axis_shifts, out_shape, combine, fill = args
        out_k = cuda_fold.fold(*args, **kw)
        dense = table.dense()
        dargs = (dense,) + tuple(args[1:])
        for name, ref in (("its plain version", cuda_fold.fold_plain(*args, **kw)),
                          ("the dense route", cuda_fold.fold(*dargs, **kw)),
                          ("tests/live_table_model.py", model.fold_live_model(*args, **kw))):
            if not bits_equal(out_k, ref):
                raise AssertionError(f"fold[{label}]: the live kernel differs from {name} (max abs {max_err(out_k, ref)[0]})")
            del ref
        live_targets = int(model.fold_live_targets(table, axis_shifts, out_shape).sum())
        idx = fold_targets(dense, axis_shifts, out_shape)
        vals = dense.reshape(-1)
        red = "sum" if combine == "add" else "amin"

        def library():
            out = torch.full(tuple(out_shape), float(fill), dtype=dense.dtype, device=dense.device)
            return out.view(-1).scatter_reduce_(0, idx, vals, reduce=red, include_self=True)

        c, m, n_out = int(dense.shape[0]), int(table.slot.numel()), out_k.numel()
        s = int((table.slot >= 0).sum())
        rows.append(dict(
            caller=label, combine=combine, C=c, table=list(table.shape[1:]), out=list(out_k.shape), S=s,
            live_targets=live_targets, bitwise=True, max_abs_err=0.0,
            ms=cuda_time_ms(lambda: cuda_fold.fold(*args, **kw), 20),
            plain_ms=cuda_time_ms(lambda: cuda_fold.fold_plain(*args, **kw), 5),
            dense_ms=cuda_time_ms(lambda: cuda_fold.fold(*dargs, **kw), 20),
            library_ms=cuda_time_ms(library, 5),
            # the map and the folded channels' nonempty columns read once, the
            # grid written once; a combine a nonempty entry
            **bound(cuda_fold.fold_bytes(table, out_shape), s * c),
            dense_table_bytes=dense.numel() * 4,
            dense_bound_ms=cuda_fold.fold_bytes(dense, out_shape) / HBM_BYTES_PER_S * 1e3,
        ))
        del idx, vals, dense, dargs, out_k
        torch.cuda.empty_cache()
    return rows


def live_reduce_phase(reduces, folds):
    """Every reduce of the step in live form, from the scan kernel's rows:
    the live placement kernel bitwise its plain version,
    tests/live_table_model.py's model, the dense placement's plain version
    (its table expanded) and the step's own table; then the whole
    composite of each fold the step made from that table (scan,
    placement, fold) on the kernels, on the plain versions, on the dense
    route (the fold kernel on the dense table) and on the model, bitwise.
    CUDA-event ms of the placement, its plain version, the live route
    (scan + placement) and one ``torch.segment_reduce`` call of the whole
    reduce; S, the placement's bound, the live route's, and a dense
    table's."""
    import dataclasses

    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn
    from python_fluid_simulation_tpu_torch.ops import cuda_fold, cuda_scan

    model = live_model()
    rows = []
    for caller, (vals, ids, m, op, fill), _, out in reduces:
        k, c = vals.shape
        same = cbn.segment_same(ids)
        scan = cuda_scan.seg_scan_sorted(vals, same, op)
        live_k = cbn.place_live(scan, ids, m, op, fill)
        s = same_live(f"place_live[{caller}] vs its plain version", live_k, cbn.place_live_plain(scan, ids, m, op, fill))
        same_live(f"place_live[{caller}] vs tests/live_table_model.py", live_k,
                  model.place_live_model(scan, ids, m, op, fill))
        same_live(f"place_live[{caller}] vs the step's table", live_k, out)
        dense_k = cbn.place_segments_plain(scan, ids, m, op, fill, True)
        if not bits_equal(live_k.dense(), dense_k):
            raise AssertionError(f"place_live[{caller}]: its table differs from the dense placement's")
        composites = []
        linked = [f for f in folds if f[1][0].live is out.live]
        if linked:
            live_p = cbn.scan_reduce_plain(vals, ids, m, op, fill)
            live_m = model.place_live_model(cuda_scan.seg_scan_sorted_plain(vals, same, op), ids, m, op, fill)
            for label, (table, *rest), kw in linked:
                def view(t, table=table):
                    return dataclasses.replace(t, grid_shape=table.grid_shape, channels=table.channels)

                got = cuda_fold.fold(view(live_k), *rest, **kw)
                dense_view = dense_k.reshape((c,) + tuple(table.grid_shape))[list(table.channels)]
                for name, ref in (("the plain composite", cuda_fold.fold_plain(view(live_p), *rest, **kw)),
                                  ("the dense route", cuda_fold.fold(dense_view, *rest, **kw)),
                                  ("the model's composite", model.fold_live_model(view(live_m), *rest, **kw))):
                    if not bits_equal(got, ref):
                        raise AssertionError(f"{caller} -> fold[{label}]: the live composite differs from {name}")
                composites.append(label)
                del got, dense_view
            del live_p, live_m
        offs = cbn._offsets(ids, m)
        route_bnd = live_route_bound(vals, ids, m, s)
        rows.append(dict(
            caller=caller, op=op, K=k, C=c, M=m, S=s, live_share=s / max(m, 1), cap=int(live_k.live.shape[1]),
            bitwise=True, max_abs_err=0.0, composites=composites,
            ms=cuda_time_ms(lambda: cbn.place_live(scan, ids, m, op, fill), 10),
            plain_ms=cuda_time_ms(lambda: cbn.place_live_plain(scan, ids, m, op, fill), 3),
            route_ms=cuda_time_ms(lambda: cbn.scan_reduce(vals, ids, m, op, fill), 10),
            # one torch.segment_reduce call of the whole reduce, offsets
            # computed beforehand, (M, C) output
            library_ms=cuda_time_ms(lambda: torch.segment_reduce(
                vals, cbn._OPS[op], offsets=offs, axis=0, unsafe=True, initial=float(fill)), 5),
            # the live placement: the ids and the S last rows read, the S
            # columns and the map written; a combine an entry
            **bound(cbn.place_live_bytes(k, s, c, m), s * c),
            # the live route (scan + placement): `live_route_bound`
            route_bytes_ms=route_bnd["bytes_ms"], route_ops_ms=route_bnd["ops_ms"],
            dense_bound_ms=(s * c * 4 + k * 8 + m * c * 4) / HBM_BYTES_PER_S * 1e3,
        ))
        del scan, same, live_k, dense_k, offs
        torch.cuda.empty_cache()
    return rows


def _pair_slices(row_shape, col_shape, off):
    """Slices of the rows whose neighbour at `off` lies inside the column
    array, and of those neighbours."""
    rs, cs = [], []
    for r, c, o in zip(row_shape, col_shape, off):
        lo, hi = max(0, -o), min(r, c - o)
        rs.append(slice(lo, hi))
        cs.append(slice(lo + o, hi + o))
    return tuple(rs), tuple(cs)


def csr_matrix(blocks, n):
    """A torch.sparse CSR matrix from row blocks [(row offset, row shape,
    diag, [(col offset, col shape, offset, coef)])], every structural
    entry kept (zero coefficients too): the operator a matvec kernel
    applies, assembled beforehand for the one-call library yardstick.
    Built a row block at a time as a (rows, 1 + terms) table of column
    indices and values, sorted within each row, so that the 504 coupled
    operator (360M entries) needs ~12 GB of scratch, not a coalesce of
    all of it at once."""
    import torch

    counts, cols, vals = [], [], []
    for r0, rshape, diag, terms in blocks:
        nr = diag.numel()
        col = torch.full((*rshape, 1 + len(terms)), -1, dtype=torch.int64, device=diag.device)
        val = torch.zeros((*rshape, 1 + len(terms)), dtype=diag.dtype, device=diag.device)
        col[..., 0] = r0 + torch.arange(nr, device=diag.device).view(rshape)
        val[..., 0] = diag
        for j, (c0, cshape, off, coef) in enumerate(terms, start=1):
            rsl, csl = _pair_slices(rshape, cshape, off)
            col[rsl + (j,)] = c0 + torch.arange(math.prod(cshape), device=diag.device).view(cshape)[csl]
            val[rsl + (j,)] = coef[rsl]
        col, order = col.view(nr, -1).sort(dim=1)  # the missing neighbours (-1) first
        val = val.view(nr, -1).gather(1, order)
        del order
        keep = col >= 0
        counts.append(keep.sum(1))
        cols.append(col[keep])
        vals.append(val[keep])
        del col, val, keep
    crow = torch.zeros(n + 1, dtype=torch.int64, device=cols[0].device)
    torch.cumsum(torch.cat(counts), 0, out=crow[1:])
    return torch.sparse_csr_tensor(crow, torch.cat(cols), torch.cat(vals), (n, n))


def stencil_library(diag, coefs, p, q_kernel):
    """One torch.sparse CSR matrix-vector product computing the 7-point
    matvec (matrix assembled beforehand): ms (CUDA events), device ms
    (`device_ms`), nnz and its largest difference from the kernel."""
    shape = tuple(diag.shape)
    a = csr_matrix([(0, shape, diag, [(0, shape, off, c) for off, c in coefs])], diag.numel())
    v = p.reshape(-1)
    q = (a @ v).view(shape)
    return dict(library_ms=cuda_time_ms(lambda: a @ v, 50), library_device_ms=device_ms(lambda: a @ v, 200),
                library_nnz=int(a.values().numel()), library_max_abs_err=max_err(q, q_kernel)[0])


def prepared_matvec_phase(cell):
    """Row 5: the prepared cell matvecs (`prepare_stencil_matvec`, as
    `prepare_pressure_matvec` / `prepare_density_matvec` make them) on the
    step's systems (p = b) vs the plain version: bitwise; with the CSR
    library yardstick; the kernel's and the library's device ms beside
    their event ms."""
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import stencil_matvec_bytes, stencil_matvec_plain
    from python_fluid_simulation_tpu_torch.solvers import pressure

    rows = []
    for label, (b, coefficients) in cell:
        diag, coefs, _ = coefficients
        mv, _ = pressure.prepare_stencil_matvec(coefficients)
        q_k = mv(b)
        check_bitwise(f"prepared {label} matvec", [q_k], [stencil_matvec_plain(diag, coefs, b)])
        n = b.numel()
        rows.append(dict(
            system=label, shape=list(b.shape), bitwise=True, max_abs_err=0.0,
            ms=cuda_time_ms(lambda: mv(b), 50), device_ms=device_ms(lambda: mv(b), 200),
            plain_ms=cuda_time_ms(lambda: stencil_matvec_plain(diag, coefs, b), 20),
            **bound(stencil_matvec_bytes(n), STENCIL_OPS * n), **stencil_library(diag, coefs, b, q_k),
        ))
    return rows

def coupled_library(sphi_c, vol_c, s_mu, vs, q_kernel):
    """One torch.sparse CSR matrix-vector product computing the coupled
    viscosity matvec (the 45 materialised term fields assembled into the
    matrix beforehand), on the face arrays vs: ms, nnz and its largest
    difference from the kernel's q."""
    import torch

    from python_fluid_simulation_tpu_torch.solvers import viscosity

    shapes = [tuple(t.shape) for t in vs]
    offs = [0, vs[0].numel(), vs[0].numel() + vs[1].numel()]
    n = sum(t.numel() for t in vs)
    diags, per_axis, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, shapes)
    blocks = [(offs[a], shapes[a], diags[a], [(offs[f], shapes[f], voff, c) for f, voff, c in per_axis[a]])
              for a in range(3)]
    del diags, per_axis
    a = csr_matrix(blocks, n)
    del blocks
    v = torch.cat([t.reshape(-1) for t in vs])
    q = a @ v
    ref = torch.cat([t.reshape(-1) for t in q_kernel])
    out = dict(library_ms=cuda_time_ms(lambda: a @ v, 20), library_nnz=int(a.values().numel()),
               library_max_abs_err=max_err(q, ref)[0])
    del a, v, q, ref
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the step swapped for its plain version (module
    attributes, as `plain_mg_routes`): the step on the card with no kernel
    of this port."""
    from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_cg, cuda_fold, cuda_stencils, scatter
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

    with plain_mg_routes(), patched([
        (halo_rdma, "halo_exchange_rdma", halo_rdma.halo_exchange_rdma_plain),
        (halo_rdma, "halo_exchange_push", halo_rdma.halo_exchange_rdma_plain),
        (halo_rdma, "mesh_psum", halo_rdma.mesh_psum_plain),
        (pressure, "cell_poisson_pcg", cuda_stencils.cell_poisson_pcg_plain),
        (pressure, "fused_poisson_pcg", cuda_stencils.fused_poisson_pcg_plain),
        (viscosity, "coupled_visc_pcg", cuda_cg.coupled_visc_pcg_plain),
        (viscosity, "coupled_matvec_geom", plain_geom_mv),
        (viscosity, "coupled_stencil_matvec", plain_coupled_stencil_mv),
        (scatter, "scan_reduce", cuda_binned.scan_reduce_plain),
        (scatter, "segment_broadcast", cuda_binned.segment_broadcast_plain),
        (scatter, "fold", cuda_fold.fold_plain),
    ]):
        yield


def capture_504(step_3d, state, cfg, geom):
    """One 504 step with recorders around the cell solves' two PCG
    kernels, the coupled solve and every fold, as their callers call
    them (each fold labelled with the function that made it)."""
    from python_fluid_simulation_tpu_torch.ops import scatter
    from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

    got = {"fused": [], "cell": [], "coupled": [], "fold": []}

    def rec(kind, fn):
        def call(*args, **kw):
            got[kind].append((args, kw))
            return fn(*args, **kw)
        return call

    def rec_fold(*args, **kw):
        # frame 2: the caller of scatter.fold_scattered_sep
        got["fold"].append((sys._getframe(2).f_code.co_name, args, kw))
        return fold(*args, **kw)

    fold = scatter.fold
    with patched([
        (pressure, "fused_poisson_pcg", rec("fused", pressure.fused_poisson_pcg)),
        (pressure, "cell_poisson_pcg", rec("cell", pressure.cell_poisson_pcg)),
        (viscosity, "coupled_visc_pcg", rec("coupled", viscosity.coupled_visc_pcg)),
        (scatter, "fold", rec_fold),
    ]):
        step_3d(state, cfg, geom=geom)
    return got


def fused_kernel_phase(systems):
    """Row 3 (the Jacobi-PCG from x0, `fused_poisson_pcg`) on cell systems
    vs its plain version: iterations equal, x within KERNEL_TOL, a repeat
    bitwise; x0 None (the main path's null x0), a zeros field or a random
    one; from x0 = 0 also the cell route (`cell_poisson_pcg`) on the same
    system, the other side of the gate.  The plain time is its checked
    solve's."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        cell_poisson_pcg,
        fused_poisson_pcg,
        fused_poisson_pcg_plain,
        poisson_io_bytes,
    )

    rows = []
    for label, args, kw in systems:
        b, x0, diag, coefs, pd = args
        x_k, it_k, res_k, _, _ = fused_poisson_pcg(*args, **kw)
        repeatable = bool(torch.equal(x_k, fused_poisson_pcg(*args, **kw)[0]))
        (x_p, it_p, res_p, _, _), plain_ms = timed_once(lambda: fused_poisson_pcg_plain(*args, **kw))
        if int(it_k) != int(it_p):
            raise AssertionError(f"fused_poisson_pcg[{label}]: iterations {int(it_k)} vs plain {int(it_p)}")
        check_close(f"fused_poisson_pcg[{label}]", x_k, x_p, KERNEL_TOL)
        err, rel = max_err(x_k, x_p)
        ms = cuda_time_ms(lambda: fused_poisson_pcg(*args, **kw), 10)
        init_ms = cuda_time_ms(lambda: fused_poisson_pcg(*args, **dict(kw, max_iter=0)), 10)
        live = poisson_live(b, x0, diag, coefs, pd, ms, int(it_k), init_ms)
        # b, (x0,) diag, 6 coefs, pd read once; x written once
        nbytes = poisson_io_bytes(b.numel(), x0 is not None)
        row = dict(
            system=label, shape=list(b.shape), x0=x0 is not None, zero_x0=x0 is None or not bool(x0.any()),
            iters=int(it_k), plain_iters=int(it_p),
            res=float(res_k), plain_res=float(res_p), max_abs_err=err, max_rel_err=rel,
            bitwise_repeatable=repeatable, ms=ms, plain_ms=plain_ms,
            **bound(nbytes, poisson_ops(int(it_k), live["live_cells"], b.numel(), x0 is not None)), **live,
        )
        if row["zero_x0"]:
            _, it_c, *_ = cell_poisson_pcg(b, diag, coefs, pd, **kw)
            row.update(cell_poisson_pcg_iters=int(it_c),
                       cell_poisson_pcg_ms=cuda_time_ms(lambda: cell_poisson_pcg(b, diag, coefs, pd, **kw), 10))
        rows.append(row)
    return rows


def poisson_sweep(b, diag, coefs, pd, planes):
    """The Poisson PCG kernel (`cell_poisson_pcg`: a null x0, as both
    routes of solve_cell_poisson launch it) on the middle `planes` x
    planes of a cell system (a principal submatrix: the same operator on
    fewer cells, the fluid column included), at most SWEEP_ITERS
    iterations (tol 0): ms an iteration against the cell count and the
    kernel's live cells Na, beside the active floor."""
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import POISSON_LIVE_BYTES, cell_poisson_pcg

    fixed = dict(tol=0.0, rel_tol=0.0, max_iter=SWEEP_ITERS)
    rows = []
    for xc in planes:
        x0 = (b.shape[0] - xc) // 2
        sb, sd, sp = b[x0:x0 + xc], diag[x0:x0 + xc], pd[x0:x0 + xc]
        sc = [(off, c[x0:x0 + xc]) for off, c in coefs]
        na, _ = kernel_live_cells(sb, None, sd, sc, sp)
        iters = int(cell_poisson_pcg(sb, sd, sc, sp, **fixed)[1])
        ms = cuda_time_ms(lambda: cell_poisson_pcg(sb, sd, sc, sp, **fixed), 5)
        rows.append(dict(shape=list(sb.shape), cells=sb.numel(), live_cells=na, live_fraction=na / sb.numel(),
                         iters=iters, ms_per_iter=ms / max(iters, 1),
                         active_floor_ms_per_iter=POISSON_LIVE_BYTES * na / HBM_BYTES_PER_S * 1e3))
    return rows


def lean_precond_phase(system):
    """One application of the lean two-grid viscosity preconditioner (the
    > 4M-face-cell route) to the viscosity right-hand side, kernels vs
    plain versions: bitwise; its inner cycle's tail (`tail_phase`)."""
    from python_fluid_simulation_tpu_torch.ops.cuda_cg import flat_geometry
    from python_fluid_simulation_tpu_torch.solvers import viscosity

    (b, _, _, sphi_c, vol_c, s_mu), _ = system
    shapes = [tuple(t.shape) for t in b]
    geom = flat_geometry(sphi_c, vol_c)

    def build():
        return viscosity.make_viscosity_mg_preconditioner_lean(
            s_mu, sphi_c, vol_c, shapes,
            lambda vs: viscosity.coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, same_axis_only=True, geom=geom))

    pre = build()
    with recorded_tails() as got:
        z_k = pre(b)
    tail_row = tail_phase("504 lean inner (batched)", *got[0])
    del got
    with plain_mg_routes(), patched([(viscosity, "coupled_matvec_geom", plain_geom_mv)]):
        pre_p = build()
        z_p, plain_ms = timed_once(lambda: pre_p(b))
    check_bitwise("lean preconditioner", z_k, z_p)
    del pre_p
    return dict(
        levels=[list(lv.diag.shape) for lv in pre.inner.levels], bitwise=True, max_abs_err=0.0,
        ms=cuda_time_ms(lambda: pre(b), 5), plain_ms=plain_ms, setup_ms=cuda_time_ms(build, 2), tail=tail_row,
    )


@contextlib.contextmanager
def recorded_levelsets():
    """Record every `compute_fluid_levelset` call of the step (its
    positions, masses, the borrowed sort and the card's result)."""
    from python_fluid_simulation_tpu_torch.engine import step as step_mod

    calls, real = [], step_mod.compute_fluid_levelset

    def rec(px, res, bound_min, cell_size, gdx, pm=None, sort_info=None):
        out = real(px, res, bound_min, cell_size, gdx, pm=pm, sort_info=sort_info)
        calls.append(dict(px=px, pm=pm, sort_info=sort_info, out=out))
        return out

    step_mod.compute_fluid_levelset = rec
    try:
        yield calls
    finally:
        step_mod.compute_fluid_levelset = real


def levelset_card_vs_cpu(calls, cfg, geom, n_sqrt=1 << 22):
    """The first lean 504 step's card and CPU part (ROADMAP queue 3 item
    2) at the bottom of the falling column, where the pressure diagonal
    takes the level set through the ghost-fluid fraction. Here, from the
    card's own inputs: each recorded level set of the step on the CPU
    bitwise the card's (the port's roots are correctly rounded on both
    devices: `ops/indexing.py::rounded_sqrt`); the pressure system's
    coefficients from the card's second level set on both devices,
    bitwise. Also the root alone on seeded inputs: the card's sqrt and
    the CPU's `rounded_sqrt` exact (asserted), PyTorch's CPU fp32 sqrt
    counted."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import levelset
    from python_fluid_simulation_tpu_torch.ops.indexing import rounded_sqrt
    from python_fluid_simulation_tpu_torch.ops.transfers import SortInfo
    from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_coefficients

    g = cfg.grid
    rows = []
    for i, c in enumerate(calls):
        si = c["sort_info"]
        cpu_si = None if si is None else SortInfo(si.sorted_ids.cpu(), si.order.cpu(), si.ext, si.px_sorted.cpu())
        args = (c["px"].cpu(), g.res, g.bound_min, g.cell_size, g.dx)
        kw = dict(pm=None if c["pm"] is None else c["pm"].cpu(), sort_info=cpu_si)
        t = time.perf_counter()
        port_cpu = levelset.compute_fluid_levelset(*args, **kw)
        cpu_s = time.perf_counter() - t
        card = c["out"].cpu()
        rows.append(dict(call=i, cells=card.numel(), card_vs_port_cpu_differ=int((card != port_cpu).sum()),
                         card_vs_port_cpu_max_abs=float((card - port_cpu).abs().max()), cpu_seconds=cpu_s))
        if rows[-1]["card_vs_port_cpu_differ"]:
            raise AssertionError(f"504 level set {i}: card vs the port's CPU level set differ: {rows[-1]}")
    lphi = calls[-1]["out"]
    coef_card = pressure_coefficients(geom.w_faces, lphi)
    coef_cpu = pressure_coefficients([w.cpu() for w in geom.w_faces], lphi.cpu())
    pairs = [(coef_card[0], coef_cpu[0]), (coef_card[2], coef_cpu[2])]
    pairs += [(a, b) for (_, a), (_, b) in zip(coef_card[1], coef_cpu[1])]
    coef_differ = sum(int((a.cpu() != b).sum()) for a, b in pairs)
    if coef_differ:
        raise AssertionError(f"504 pressure coefficients, card vs CPU from the card's level set: {coef_differ} differ")
    x = torch.rand(n_sqrt, generator=torch.Generator().manual_seed(0), dtype=torch.float32) * 1e-4
    exact = torch.sqrt(x.double()).float()
    sqrt = dict(inputs=n_sqrt, card_off=int((torch.sqrt(x.cuda()).cpu() != exact).sum()),
                rounded_sqrt_cpu_off=int((rounded_sqrt(x) != exact).sum()),
                torch_sqrt_cpu_off=int((torch.sqrt(x) != exact).sum()))
    if sqrt["card_off"] or sqrt["rounded_sqrt_cpu_off"]:
        raise AssertionError(f"fp32 roots against the correctly rounded root: {sqrt}")
    return dict(levelsets=rows, levelsets_bitwise=True, pressure_coefficients_bitwise=True,
                sqrt_vs_float64_root=sqrt)


ROOT_MODULES = ("ops.levelset", "ops.sdf", "engine.step", "parallel.particles")  # the 3D step's roots


def cpu_root_phase():
    """The full-size card-vs-CPU step comparisons (ROADMAP queue 3 items 1,
    2 and 6) with the CPU's roots taken two ways: as the port takes them
    (`ops/indexing.py::rounded_sqrt`, the correctly rounded root) and as
    PyTorch's CPU fp32 ``torch.sqrt`` gives them (patched into every module
    of the 3D step that takes a root).  Each step runs from the card's
    state on the card and on the CPU (the geometry built inside): the
    flagship's third step, the 128^3 third step, and coiling_config(504)'s
    first lean-MG step ('auto' from the state after 2 steps with the flag
    forced to 2, as main_504 takes it).  Per root: max |d| of x, v and
    the APIC rows and the particles whose rows differ by more than
    STEP_TOL; nothing asserted but the CPU steps' finite values."""
    import importlib

    import numpy as np
    import torch

    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d

    modules = [importlib.import_module(f"python_fluid_simulation_tpu_torch.{m}") for m in ROOT_MODULES]
    out = {}
    for label, cfg, scene, warm, flag in (("flagship_step_2", buckling_config(), buckling_scene, 2, None),
                                          ("128_step_2", scaled_buckling_config(RES_128), buckling_scene, 2, None),
                                          ("coil_504_first_lean_step", coiling_config(RES_504), coiling_scene, 2, 2)):
        t0 = time.perf_counter()
        state = scene(cfg, seed=0, device="cuda")
        geom = build_geom_cache(state.solid)
        for _ in range(warm):
            state, _ = step_3d(state, cfg, geom=geom)
        if flag is not None:
            state = dataclasses.replace(state, visc_mg=flag)
        card, _ = step_3d(state, cfg, geom=geom)
        card = state_to_numpy(card)
        start = state_to_numpy(state)
        del state, geom
        torch.cuda.empty_cache()
        row = {}
        for root, patches in (("rounded_sqrt", []), ("torch_sqrt", [(m, "rounded_sqrt", torch.sqrt) for m in modules])):
            tc = time.perf_counter()
            with patched(patches):
                cpu, _ = step_3d(state_from_numpy(start, device="cpu"), cfg)
            cpu = state_to_numpy(cpu)
            if not all(bool(np.isfinite(cpu[k]).all()) for k in STEP_TOL):
                raise AssertionError(f"cpu_root {label} {root}: non-finite particles")
            row[root] = dict(step_diff(card, cpu), cpu_step_seconds=time.perf_counter() - tc)
        row["card_vs_cpu_moved_with_the_root"] = any(row["rounded_sqrt"][k] != row["torch_sqrt"][k]
                                                     for k in (*STEP_TOL, "particles_rows_over_tol"))
        out[label] = dict(row, grid=list(cfg.grid.res), particles=int(start["x"].shape[0]),
                          seconds=time.perf_counter() - t0)
    return out


def card_vs_plain(step_3d, before, after, cfg, geom, label):
    """The step from `before` on the card with every kernel swapped for
    its plain version, against the kernels' step `after`: STEP_TOL, and
    no kernel launched.  Returns (errors, the plain step's state)."""
    from python_fluid_simulation_tpu_torch.convert import state_to_numpy

    read = reset_counters()
    with plain_kernels():
        plain_state, _ = step_3d(before, cfg, geom=geom)
    launched = {k: v for k, v in read().items() if v}
    if launched:
        raise AssertionError(f"{label}: the plain step launched kernels {launched}")
    ref, card = state_to_numpy(plain_state), state_to_numpy(after)
    err = {k: float(abs(card[k] - ref[k]).max()) for k in STEP_TOL}
    for k, tol in STEP_TOL.items():
        if not err[k] <= tol:
            raise AssertionError(f"{label} vs the plain step on the card: max |d{k}| {err[k]} > {tol}")
    return err, plain_state


def step_diff(a, b):
    """Max |difference| of x, v and the APIC rows between two states (numpy
    dicts), and how many particles' rows differ by more than STEP_TOL."""
    import numpy as np

    err = {k: float(np.abs(a[k] - b[k]).max()) for k in STEP_TOL}
    rows = np.abs(a["c"] - b["c"]).reshape(len(a["c"]), -1).max(axis=1)
    err["particles_rows_over_tol"] = int((rows > STEP_TOL["c"]).sum())
    return err


def reset_counters():
    from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_cg, cuda_fold, cuda_mg, cuda_scan, cuda_stencils
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma

    wrappers = {
        "cell_poisson_pcg": cuda_stencils.cell_poisson_pcg,
        "fused_poisson_pcg": cuda_stencils.fused_poisson_pcg,
        "coupled_visc_pcg": cuda_cg.coupled_visc_pcg,
        "stencil_matvec": cuda_stencils.stencil_matvec,
        "mg_vcycle_tail": cuda_mg.vcycle_tail,
        "binned_segment_reduce": cuda_binned.serial_reduce,
        "seg_scan_sorted": cuda_scan.seg_scan_sorted,
        "binned_segment_place_live": cuda_binned.place_live,
        "binned_segment_broadcast": cuda_binned.segment_broadcast,
        "coupled_matvec_geom": cuda_cg.coupled_matvec_geom,
        "fold": cuda_fold.fold,
        "coupled_stencil_matvec": cuda_stencils.coupled_stencil_matvec,
        "halo_exchange_rdma": halo_rdma.halo_exchange_rdma,
        "halo_exchange_push": halo_rdma.halo_exchange_push,
        "mesh_psum": halo_rdma.mesh_psum,
    }
    for w in wrappers.values():
        w.launches = 0
    cuda_mg.vcycle_tail.batched_launches = 0
    cuda_cg.coupled_matvec_geom.same_axis_launches = 0

    def read():
        out = {name: w.launches for name, w in wrappers.items()}
        # the tail wrapper counts both forms: report them apart
        out["mg_vcycle_tail_batched"] = cuda_mg.vcycle_tail.batched_launches
        out["mg_vcycle_tail"] -= out["mg_vcycle_tail_batched"]
        # of the geometry matvecs, the same-axis form (only the lean route's)
        out["coupled_matvec_geom_same_axis"] = cuda_cg.coupled_matvec_geom.same_axis_launches
        return out

    return read


def counted_step(count, state, cfg):
    """The step from `state` under the package's byte counter
    (``step_bytes``, the keywords ``count["kw"]``), with the geometry
    built inside the step as the `graph` phase's replays (``make_step``)
    build it, so the count is the work of the replay its ms are of: its
    bytes, the kernels' bytes and share, the ten largest entries of its
    per-op table, the table and its iterations go to ``count``, with its
    host ms; returns (state, metrics), bitwise the uncounted step's with
    a prebuilt geometry."""
    import torch

    from python_fluid_simulation_tpu_torch.utils.roofline import step_bytes

    torch.cuda.synchronize()
    ts = time.perf_counter()
    got = step_bytes(state, cfg, **count.get("kw", {}))
    torch.cuda.synchronize()
    count.update(ms=(time.perf_counter() - ts) * 1e3, bytes=got.steps[0], kernel_bytes=got.kernel_bytes,
                 kernel_share=got.kernel_share, top_ops=got.top(10), table=got.table,
                 iters={k: int(got.metrics[0][f"{k}_iters"]) for k in ("density", "viscosity", "pressure")})
    return got.state, got.metrics[0]


def run_steps(step_3d, state, cfg, geom, n, keep, count=None):
    """n steps, each timed on the host clock to a synchronize; returns the
    final state, the first `keep` + 1 states, step ms and metrics.  With a
    ``count`` dict step COUNTED_STEP is `counted_step`'s instead, left out
    of the step ms."""
    import torch

    states, step_ms, metrics = [state], [], []
    for i in range(n):
        if count is not None and i == COUNTED_STEP:
            state, m = counted_step(count, state, cfg)
        else:
            ts = time.perf_counter()
            state, m = step_3d(state, cfg, geom=geom)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
        if len(states) <= keep:
            states.append(state)
        metrics.append({k: v.item() for k, v in m.items()})
    return state, states, step_ms, metrics


def run_coil(step_3d, state, cfg, geom, n, keep, count=None):
    """`run_steps` that also records the viscosity branch each step took
    (MG while the carried flag is set, for 'auto'), read before the
    step's clock starts."""
    import torch

    states, step_ms, metrics, branch = [state], [], [], []
    for i in range(n):
        mg = cfg.solver.viscosity_precond == "mg" or int(torch.as_tensor(state.visc_mg)) > 0
        branch.append("mg" if mg else "jacobi")
        if count is not None and i == COUNTED_STEP:
            state, m = counted_step(count, state, cfg)
            count["branch"] = branch[-1]
        else:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            state, m = step_3d(state, cfg, geom=geom)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
        if len(states) <= keep:
            states.append(state)
        metrics.append({k: v.item() for k, v in m.items()})
    return state, states, step_ms, metrics, branch


def check_run(state, metrics, launches, need, label):
    import torch

    for name in need:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the {label} main path")
    for k in ("x", "v", "c"):
        if not torch.isfinite(getattr(state.particles, k)).all():
            raise AssertionError(f"{label}: non-finite particle {k}")
    for i, m in enumerate(metrics):
        for solver in ("density", "viscosity", "pressure"):
            if not m[f"{solver}_converged"]:
                raise AssertionError(f"{label} step {i}: {solver} solve did not converge: {m}")


# bytes: the graph phase's row of each counted configuration ({branch}: the
# counted step's 'auto' branch)
GRAPH_ROW = {"flagship": "flagship", "128": "128", "coiling_256_auto": "coil_256_auto_{branch}",
             "coiling_504_auto": "coil_504_auto_{branch}", "256": "256", "flagship_unet": "flagship_unet"}


def bytes_phase(counts, shapes, graph_rows, kind, smi):
    """One row a counted configuration: the counted step's bytes (the
    package's ``step_bytes``: every aten op and hand kernel of the eager
    step, with simulate's copies around a replay), the kernels' share, its
    ten largest per-op entries, ``step_bytes_model``'s bytes for its
    iterations, and ``roofline`` of the count over the configuration's
    replayed ms a step (the `graph` phase's median): achieved GB/s,
    ``hbm_util`` (asserted <= 1: a count the card could not have moved in
    that time over-counts) and ``impl_overhead_x``.  Where the CPU counted
    the same step from the same state (flagship, 128^3): both counts,
    both iteration lists, and the per-op entries that differ; where the
    iterations agree the counts must be equal (asserted)."""
    from python_fluid_simulation_tpu_torch.utils.roofline import roofline

    rows = []
    for label, count in counts.items():
        graph_label = GRAPH_ROW[label].format(branch=count.get("branch"))
        ms = graph_rows[graph_label]["median_graph_ms"]
        res, particles = shapes[label]
        roof = roofline(res, particles, {f"{k}_iters": v for k, v in count["iters"].items()}, ms, kind,
                        measured_bytes_per_step=count["bytes"])
        if "hbm_util" not in roof or not roof["hbm_util"] <= 1.0:
            raise AssertionError(f"bytes {label}: {count['bytes']} bytes in {ms} ms: {roof}")
        row = dict(phase="bytes", config=label, nvidia_smi=smi, counted_step=COUNTED_STEP,
                   counted_bytes=count["bytes"], counted_gb_per_step=count["bytes"] / 1e9,
                   kernel_bytes=count["kernel_bytes"], kernel_share=count["kernel_share"], top_ops=count["top_ops"],
                   modeled_gb_per_step=roof["modeled_gb_per_step"], replayed_ms=ms,
                   replayed_from=f"graph {graph_label}", iters=count["iters"], roofline=roof,
                   counted_step_ms=count["ms"])
        cpu = count.get("cpu")
        if cpu is not None:
            names = set(count["table"]) | set(cpu["table"])
            diff = {n: [count["table"].get(n), cpu["table"].get(n)] for n in sorted(names)
                    if count["table"].get(n) != cpu["table"].get(n)}
            row["card_vs_cpu"] = dict(card_bytes=count["bytes"], cpu_bytes=cpu["bytes"],
                                      equal=count["bytes"] == cpu["bytes"], card_iters=count["iters"],
                                      cpu_iters=cpu["iters"], iters_equal=count["iters"] == cpu["iters"],
                                      table_differences=diff, cpu_counted_step_ms=cpu["ms"])
            if count["iters"] == cpu["iters"] and count["bytes"] != cpu["bytes"]:
                raise AssertionError(f"bytes {label}: the card counted {count['bytes']}, the CPU {cpu['bytes']} "
                                     f"with the same iterations {count['iters']}; per-op differences {diff}")
        rows.append(row)
    return rows


def card_vs_cpu(step_3d, before, after, cfg, label, count=None):
    """The step from the card's state `before` on the CPU against the
    card's `after`, within STEP_TOL; returns the errors.  With a ``count``
    dict the CPU step is `counted_step`'s, as the card's counted step."""
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy

    start = state_from_numpy(state_to_numpy(before), device="cpu")
    if count is None:
        cpu_state, _ = step_3d(start, cfg)
    else:
        cpu_state, _ = counted_step(count, start, cfg)
    cpu, card = state_to_numpy(cpu_state), state_to_numpy(after)
    err = {k: float(abs(card[k] - cpu[k]).max()) for k in STEP_TOL}
    for k, tol in STEP_TOL.items():
        if not err[k] <= tol:
            raise AssertionError(f"{label} on the card vs CPU: max |d{k}| {err[k]} > {tol}")
    return err


def capture_nojac(step_3d, state, cfg, geom):
    """One step with ``jacobi_precond=False``, with recorders around the
    cell solves, the viscosity solve's preparation of its materialised
    matvec, and its generic CG, as their callers call them."""
    from python_fluid_simulation_tpu_torch.solvers import density, pressure, viscosity

    got = {"cell": [], "visc_fields": [], "visc_cg": []}

    def rec(kind, fn):
        def call(*args, **kw):
            got[kind].append((args, kw))
            return fn(*args, **kw)
        return call

    with patched([
        (pressure, "solve_cell_poisson", rec("cell", pressure.solve_cell_poisson)),
        (density, "solve_cell_poisson", rec("cell", density.solve_cell_poisson)),
        (viscosity, "prepare_viscosity_matvec", rec("visc_fields", viscosity.prepare_viscosity_matvec)),
        (viscosity, "cg", rec("visc_cg", viscosity.cg)),
    ]):
        step_3d(state, cfg, geom=geom)
    return got


def coupled_stencil_phase(system):
    """Rows 7-8: the materialised coupled matvec on the viscosity system's
    x0, its 45 term fields built as the unpreconditioned route builds
    them, kernel vs plain version (bitwise), with the CSR library
    yardstick."""
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        coupled_stencil_bytes,
        coupled_stencil_matvec,
        coupled_stencil_matvec_plain,
        pack_coupled_stencil,
    )
    from python_fluid_simulation_tpu_torch.solvers import viscosity

    (_, x0, _, sphi_c, vol_c, s_mu), _ = system
    shapes = [tuple(t.shape) for t in x0]
    diags, per_axis, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, shapes)
    packed = pack_coupled_stencil(diags, per_axis)  # once a solve, as prepare_viscosity_matvec does
    q_k = coupled_stencil_matvec(diags, per_axis, x0, packed=packed)
    check_bitwise("coupled_stencil_matvec", q_k, coupled_stencil_matvec_plain(diags, per_axis, x0))
    n = sum(t.numel() for t in x0)
    row = dict(
        shapes=[list(s) for s in shapes], fields_bytes=sum(t.numel() * 4 for t in diags) * 15,
        bitwise=True, max_abs_err=0.0,
        ms=cuda_time_ms(lambda: coupled_stencil_matvec(diags, per_axis, x0, packed=packed), 50),
        plain_ms=cuda_time_ms(lambda: coupled_stencil_matvec_plain(diags, per_axis, x0), 5),
        # diag and 14 coefficients a face and v read once, q written once;
        # 15 products and 14 sums a face
        **bound(coupled_stencil_bytes(n), COUPLED_OPS_PER_FACE * n),
    )
    del diags, per_axis
    row.update(coupled_library(sphi_c, vol_c, s_mu, x0, q_k))
    return row


def nojac_solve_phase(got):
    """The unpreconditioned solves of the captured step, over the kernels
    and over their plain versions: iterations equal, solutions bitwise.
    The plain time is its checked solve's."""
    import torch

    from python_fluid_simulation_tpu_torch.ops import cuda_stencils
    from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

    rows = []
    for label, (args, kw) in zip(("density", "pressure"), got["cell"]):
        def solve(args=args, kw=kw):
            return pressure.solve_cell_poisson(*args, **kw)

        x_k, st_k = solve()
        with patched([(pressure, "stencil_matvec", cuda_stencils.stencil_matvec_plain)]):
            (x_p, st_p), plain_ms = timed_once(solve)
        rows.append(dict(system=label, iters=int(st_k.iters), plain_iters=int(st_p.iters),
                         converged=bool(st_k.converged), bitwise=bool(torch.equal(x_k, x_p)),
                         max_abs_err=max_err(x_k, x_p)[0], ms=cuda_time_ms(solve, 3), plain_ms=plain_ms))
    (s_mu, sphi_c, vol_c, shapes), _ = got["visc_fields"][0]
    (_, b, x0), kw = got["visc_cg"][0]
    diags, per_axis, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, shapes)
    packed = cuda_stencils.pack_coupled_stencil(diags, per_axis)

    def visc(matvec):
        return viscosity.cg(lambda vs: matvec(diags, per_axis, vs, packed=packed), b, x0, **kw)

    x_k, st_k, _, _ = visc(cuda_stencils.coupled_stencil_matvec)
    (x_p, st_p, _, _), plain_ms = timed_once(lambda: visc(plain_coupled_stencil_mv))
    rows.append(dict(system="viscosity", iters=int(st_k.iters), plain_iters=int(st_p.iters),
                     converged=bool(st_k.converged), bitwise=all(bool(torch.equal(u, w)) for u, w in zip(x_k, x_p)),
                     max_abs_err=max(max_err(u, w)[0] for u, w in zip(x_k, x_p)),
                     ms=cuda_time_ms(lambda: visc(cuda_stencils.coupled_stencil_matvec), 3), plain_ms=plain_ms))
    for r in rows:
        if r["iters"] != r["plain_iters"] or not r["bitwise"] or not r["converged"]:
            raise AssertionError(f"unpreconditioned {r['system']} solve, kernels vs plain versions: {r}")
    return rows


def step_vs_cpu_or_plain(step_3d, before, after, cfg, geom, label):
    """The step from `before` on the CPU against the card's `after`; where
    that misses STEP_TOL, the step with every kernel swapped for its plain
    version on the card must be within it (the reference the kernels are
    held to).  Returns what was measured; which check held is "held"."""
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy

    tc = time.perf_counter()
    cpu_state, _ = step_3d(state_from_numpy(state_to_numpy(before), device="cpu"), cfg)
    out = {"cpu_step_seconds": time.perf_counter() - tc,
           "card_vs_cpu": step_diff(state_to_numpy(after), state_to_numpy(cpu_state))}
    if all(out["card_vs_cpu"][k] <= tol for k, tol in STEP_TOL.items()):
        out["held"] = "card vs CPU"
        return out
    out["card_vs_plain_on_card"], _ = card_vs_plain(step_3d, before, after, cfg, geom, label)
    out["held"] = "card vs the plain step on the card"
    return out


def dt_scaled_128(step_3d, s128, cfg128, geom128):
    """BASELINE.json's config 3, the dt-scaled pressure at 128^3: its cell
    solves are the generic CG over the blocked matvec with the V-cycle
    divided by s (`solvers/pressure.py::solve_cell_poisson`).
    `STEPS_OPTION` steps from the scene with the counters reset just
    before: the blocked matvec, the V-cycle's tail, the coupled PCG and
    the scatter kernels launched, no Poisson PCG kernel, solves
    converged; the first step against the CPU, or where that misses
    STEP_TOL, against the same step on the card with every kernel swapped
    for its plain version (`step_vs_cpu_or_plain`).  Returns (row,
    launches)."""
    cfg = dataclasses.replace(cfg128, solver=dataclasses.replace(cfg128.solver, pressure_dt_scaled=True))
    read_counts = reset_counters()
    state, states, step_ms, metrics = run_steps(step_3d, s128, cfg, geom128, STEPS_OPTION, 1)
    launches = read_counts()
    check_run(state, metrics, launches, ("stencil_matvec", "mg_vcycle_tail", "coupled_visc_pcg", *REDUCE_ROUTE,
                                         "binned_segment_broadcast", "fold"), "128^3 pressure_dt_scaled")
    for name in ("cell_poisson_pcg", "fused_poisson_pcg"):
        if launches[name]:
            raise AssertionError(f"128^3 pressure_dt_scaled: {name} was launched ({launches[name]} times)")
    timed = step_ms[1:]
    row = dict(warmup_step_ms=step_ms[0], step_ms=timed, median_step_ms=statistics.median(timed),
               iters={k: [m[f"{k}_iters"] for m in metrics] for k in ("density", "viscosity", "pressure")},
               step_0=step_vs_cpu_or_plain(step_3d, states[0], states[1], cfg, geom128,
                                           "128^3 pressure_dt_scaled step 0"))
    return row, launches


def unet_ops(unet, box):
    """Operations of one forward at the (N, C, D, H, W) box, counted from
    the layers: 2 a multiply-add of every conv and transposed conv (k2, s2:
    each input voxel feeds 8 outputs) plus its bias adds; the pools, tanh
    and concats are left out (bytes, not operations)."""
    n, _, d, h, w = box
    s0 = n * d * h * w
    ops = 0
    for key, wt in unet.state_dict().items():
        if not key.endswith(".weight"):
            continue
        name = key.split(".")[0]
        vox = s0 // 8 ** UNET_LEVEL.get(name, UNET_LEVEL.get(name[:4]))
        if name.startswith("unpool"):
            ops += 2 * vox * wt.numel() + 8 * vox * wt.shape[1]
        else:
            ops += 2 * vox * wt.numel() + vox * wt.shape[0]
    return ops


def capture_unet(step_3d, state, cfg, geom):
    """One 'unet_warm' step (``step_3d`` carries the network) with
    recorders around the learned operator, the line search and the
    coupled PCG, as the step calls them."""
    from python_fluid_simulation_tpu_torch.engine import step as step_mod
    from python_fluid_simulation_tpu_torch.solvers import viscosity

    got = {"unet": [], "line": [], "coupled": []}

    def rec(kind, fn):
        def call(*args, **kw):
            got[kind].append((args, kw))
            return fn(*args, **kw)
        return call

    with patched([
        (step_mod, "unet_delta_v", rec("unet", step_mod.unet_delta_v)),
        (viscosity, "rescaled_warm_start", rec("line", viscosity.rescaled_warm_start)),
        (viscosity, "coupled_visc_pcg", rec("coupled", viscosity.coupled_visc_pcg)),
    ]):
        step_3d(state, cfg, geom=geom)
    return got


def unet_forward_phase(unet, unet16, state_dict, feats, cfg):
    """The full-width network on the step's real feature box: fp32 on the
    card vs the same module and weights on the CPU (UNET_REL), bf16 vs fp32
    on the card (UNET_BF16_ATOL), a repeat bitwise; CUDA-event times of
    the features, the fp32 / bf16 / TF32 forwards (TF32 reported only), the
    extraction and the whole learned step, each beside its bound; peak
    memory of one fp32 forward."""
    import torch

    from python_fluid_simulation_tpu_torch.models import features
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    (_, gv, sphi, lvol, _), _ = feats
    dual, shapes = tuple(sphi.shape), [tuple(v.shape) for v in gv]
    cell_vol = cfg.grid.dx**3
    x = features.build_unet_input(gv, sphi, lvol, cell_vol)
    if tuple(x.shape) != UNET_BOX:
        raise AssertionError(f"feature box {tuple(x.shape)}, expected {UNET_BOX}")
    n_params = sum(p.numel() for p in unet.parameters())
    if n_params != UNET_PARAMS:
        raise AssertionError(f"the width-{UNET_WIDTH} UNet has {n_params} parameters, expected {UNET_PARAMS}")
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = unet(x)
        torch.cuda.synchronize()
        forward_peak = torch.cuda.max_memory_allocated() - base
        if tuple(out.shape) != (1, 3) + UNET_BOX[2:] or out.dtype != torch.float32 or not torch.isfinite(out).all():
            raise AssertionError(f"UNet output {tuple(out.shape)} {out.dtype}, finite {bool(torch.isfinite(out).all())}")
        repeatable = bool(torch.equal(unet(x), out))
        if not repeatable:
            raise AssertionError("the fp32 UNet forward run twice differs")
        # the same module and weights on the CPU
        cpu = UNet3D(width=UNET_WIDTH).eval()
        cpu.load_state_dict(state_dict)
        tc = time.perf_counter()
        out_cpu = cpu(x.cpu())
        cpu_seconds = time.perf_counter() - tc
        d_cpu, rel_cpu = max_err(out.cpu(), out_cpu)
        if not rel_cpu <= UNET_REL:
            raise AssertionError(f"UNet fp32 card vs CPU: max |d| / max |out| {rel_cpu} > {UNET_REL}")
        del cpu, out_cpu
        out16 = unet16(x)
        err16 = (out16 - out).abs().max().item()
        if out16.dtype != torch.float32 or not err16 <= UNET_BF16_ATOL:
            raise AssertionError(f"UNet bf16 vs fp32: {out16.dtype}, max |d| {err16} > {UNET_BF16_ATOL}")
        ms32 = cuda_time_ms(lambda: unet(x), 5)
        ms16 = cuda_time_ms(lambda: unet16(x), 5)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=True):
            err_tf32 = (unet.forward_raw(x) - out).abs().max().item()
            ms_tf32 = cuda_time_ms(lambda: unet.forward_raw(x), 5)
        del out16
    features_ms = cuda_time_ms(lambda: features.build_unet_input(gv, sphi, lvol, cell_vol), 10)
    extract_ms = cuda_time_ms(lambda: features.extract_delta_v(out, dual, shapes), 20)
    delta_v_ms = cuda_time_ms(lambda: features.unet_delta_v(unet, gv, sphi, lvol, cfg), 5)
    ops = unet_ops(unet, UNET_BOX)
    nbytes = (x.numel() + n_params + out.numel()) * 4  # features and weights read once; the output written once
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(
        box=list(x.shape), params=n_params, ops=ops, bytes=nbytes, max_abs_out=out.abs().max().item(),
        fp32=dict(ms=ms32, bound_ms=max(bytes_ms, ops / FP32_OPS_PER_S * 1e3), bitwise_repeatable=repeatable),
        bf16=dict(ms=ms16, bound_ms=max(bytes_ms, ops / BF16_OPS_PER_S * 1e3), max_abs_vs_fp32=err16),
        tf32_reported=dict(ms=ms_tf32, bound_ms=max(bytes_ms, ops / TF32_OPS_PER_S * 1e3), max_abs_vs_fp32=err_tf32),
        card_vs_cpu=dict(max_abs=d_cpu, rel=rel_cpu, tol=UNET_REL, cpu_seconds=cpu_seconds),
        forward_peak_bytes=forward_peak, features_ms=features_ms, extract_ms=extract_ms,
        unet_delta_v_ms=delta_v_ms, bytes_ms=bytes_ms, fp32_ops_ms=ops / FP32_OPS_PER_S * 1e3,
    )


def warm_start_phase(line, coupled):
    """The warm start on the step's viscosity system: row 4's two line-
    search matvecs (on p = warm - ext and on ext) bitwise their plain
    version, the rescaled x0 bitwise and equal to the step's, the line
    search's guarantee (the residual at x0 no larger than at ext), and row
    2 from x0 vs its plain version (iterations equal, KERNEL_TOL); row 2
    from ext on the same system (the cold start) reported."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_cg import (
        SPHI_CLASSES,
        VOL_CLASSES,
        coupled_matvec_geom,
        coupled_matvec_plain,
        coupled_pcg_io_bytes,
        coupled_visc_pcg,
        coupled_visc_pcg_plain,
        flat_geometry,
        geom_matvec_bytes,
    )
    from python_fluid_simulation_tpu_torch.solvers.viscosity import rescaled_warm_start

    (_, b, ext, warm), _ = line
    (_, x0_step, pd, sphi_c, vol_c, s_mu), kw = coupled
    geom = flat_geometry(sphi_c, vol_c)

    def mv_k(vs):
        return coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, geom=geom)

    def mv_p(vs):
        return coupled_matvec_plain(sphi_c, vol_c, s_mu, vs)

    p = tuple(w - e for w, e in zip(warm, ext))
    for label, v in (("p", p), ("ext", ext)):
        check_bitwise(f"coupled_matvec_geom[line search, {label}]", mv_k(v), mv_p(v))
    x0, alpha = rescaled_warm_start(mv_k, b, ext, warm)
    x0_p, alpha_p = rescaled_warm_start(mv_p, b, ext, warm)
    check_bitwise("rescaled warm start", x0, x0_p)
    check_bitwise("rescaled warm start vs the step's x0", x0, x0_step)

    def res_norm(x):
        return math.sqrt(sum(float(((bb - q).double() ** 2).sum()) for bb, q in zip(b, mv_k(x))))

    r_x0, r_ext, r_warm = res_norm(x0), res_norm(ext), res_norm(warm)
    if not r_x0 <= r_ext * (1 + 1e-6):
        raise AssertionError(f"line search: |b - A x0| {r_x0} > |b - A ext| {r_ext}")

    coupled_init_matvec(b, x0, pd, sphi_c, vol_c, s_mu, kw)
    x_k, it_k, res_k, *_ = coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw)
    (x_p, it_p, res_p, *_), plain_ms = timed_once(lambda: coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, **kw))
    if int(it_k) != int(it_p):
        raise AssertionError(f"coupled_visc_pcg from the warm start: iterations {int(it_k)} vs plain {int(it_p)}")
    err = 0.0
    for a in range(3):
        check_close(f"coupled_visc_pcg from the warm start[{a}]", x_k[a], x_p[a], KERNEL_TOL)
        err = max(err, max_err(x_k[a], x_p[a])[0])
    _, it_cold, *_ = coupled_visc_pcg(b, ext, pd, sphi_c, vol_c, s_mu, **kw)
    n = sum(t.numel() for t in b)
    n_geom = geom.numel()
    nbytes = coupled_pcg_io_bytes(n_geom, n)  # b, x0, pd and geometry read once; x written once
    ops = (int(it_k) * FACE_OPS_PER_ITER + FACE_OPS_PER_ITER) * n
    pcg_ms = cuda_time_ms(lambda: coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw), 20)
    return dict(
        shapes=[list(t.shape) for t in b], alpha=float(alpha), alpha_plain=float(alpha_p),
        residual_norm=dict(x0=r_x0, ext=r_ext, warm_unscaled=r_warm),
        matvec=dict(bitwise=True, max_abs_err=0.0,
                    ms=cuda_time_ms(lambda: mv_k(p), 50), plain_ms=cuda_time_ms(lambda: mv_p(p), 5),
                    **bound(geom_matvec_bytes(n_geom, n), GEOM_MV_OPS[False] * n),
                    **coupled_library(sphi_c, vol_c, s_mu, p, mv_k(p))),
        line_search_ms=cuda_time_ms(lambda: rescaled_warm_start(mv_k, b, ext, warm), 20),
        coupled_visc_pcg=dict(
            iters=int(it_k), plain_iters=int(it_p), cold_iters=int(it_cold), res=float(res_k),
            plain_res=float(res_p), max_abs_err=err, matvec_bitwise=True, ms=pcg_ms,
            ms_per_iter=pcg_ms / max(int(it_k), 1), floor_ms_per_iter=coupled_floor(b, sphi_c, vol_c),
            plain_ms=plain_ms, **bound(nbytes, ops)),
    )


def unet_forward_events(unet):
    """CUDA events around every forward of `unet` (forward hooks); returns
    (events list, remove)."""
    import torch

    events = []

    def pre(module, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append([ev, None])

    def post(module, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1][1] = ev

    handles = [unet.register_forward_pre_hook(pre), unet.register_forward_hook(post)]

    def remove():
        for h in handles:
            h.remove()

    return events, remove


def halo_phase():
    """Row 15 on the card: every slot count and field of `HALO_FIELDS`,
    `HALO_REPS` exchanges with changing contents on each route, the pull
    (``halo.halo_exchange``, the step's route: one launch an exchange, the
    slots sharing the card) and the push (``halo_exchange_push`` called
    directly: one launch a slot), each bitwise its plain version;
    CUDA-event times (launch to join) and device times of both routes
    (`device_times`: the calls queued ahead of the device), the plain
    route and one ``torch.cat`` a slot of the pre-moved planes, beside the
    same-card byte bound and the computed NVLink plane bound."""
    import torch
    from python_fluid_simulation_tpu_torch.ops import cuda_halo
    from python_fluid_simulation_tpu_torch.parallel import halo, halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.halo import _padded_extent
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(0)
    routes = {
        "pull": (lambda mesh, blocks: halo.halo_exchange(mesh, blocks, "x"), halo_rdma.halo_exchange_rdma, 1),
        "push": (lambda mesh, blocks: halo_rdma.halo_exchange_push(mesh, blocks, "x"), halo_rdma.halo_exchange_push,
                 None),
    }
    rows = []
    for slots in HALO_SLOTS:
        mesh = make_mesh(slots)
        if halo_rdma.halo_route(mesh, "x") != "pull":
            raise AssertionError(f"{mesh}: the slots share the card, the exchange must pull")
        timed = {}  # (field, route) -> the exchange, device-timed after the slot count's fields
        for name, shape in HALO_FIELDS:
            n = _padded_extent(shape[0], slots) // slots
            bshape = (n,) + shape[1:]
            plane = math.prod(bshape[1:])
            blocks = [torch.randn(bshape, generator=gen, device="cuda") for _ in range(slots)]
            row = dict(field=name, global_shape=list(shape), slots=slots, block=list(bshape), exchanges=HALO_REPS,
                       max_abs_err=0.0, **bound(halo_rdma.halo_bytes(slots, n, plane), 0),
                       nvlink_plane_bytes=plane * 4, nvlink_bound_ms=plane * 4 / NVLINK_BYTES_PER_S * 1e3)
            for route, (call, counter, per_exchange) in routes.items():
                before = counter.launches
                mismatched = torch.zeros((), dtype=torch.int64, device="cuda")
                for _ in range(HALO_REPS):
                    for b in blocks:
                        b.add_(1.0)
                    got = call(mesh, blocks)
                    want = halo_rdma.halo_exchange_rdma_plain(mesh, blocks, "x")
                    for g, w in zip(got, want):
                        mismatched += (g != w).sum()
                launched = counter.launches - before
                bad = int(mismatched)
                need = HALO_REPS * (per_exchange or slots)
                if launched != need or bad:
                    raise AssertionError(f"halo {route} {name} over {slots} slots: {launched} launches (not {need}), "
                                         f"{bad} elements differ")
                row[route] = dict(launches_per_exchange=launched / HALO_REPS, mismatched_elements=bad,
                                  ms=cuda_time_ms(lambda: call(mesh, blocks), HALO_TIMED))
                timed[(name, route)] = functools.partial(call, mesh, blocks)
            (_, entries), = halo_rdma.pull_plan(mesh, "x")
            buf = torch.empty((slots, n + 2) + bshape[1:], device="cuda")
            row["pull"]["vector_floats"] = halo_rdma.vector_floats(
                plane, halo_rdma.pull_table(entries, blocks, buf, n, plane))
            del buf
            row["push"]["grid"] = cuda_halo.grid_size(n * plane, slots, torch.device("cuda", 0))
            row["plain_ms"] = cuda_time_ms(lambda: halo_rdma.halo_exchange_rdma_plain(mesh, blocks, "x"), HALO_TIMED)
            frames = halo_rdma.halo_exchange_rdma_plain(mesh, blocks, "x")
            lo, hi = [f[:1].clone() for f in frames], [f[-1:].clone() for f in frames]
            row["library_ms"] = cuda_time_ms(lambda: [torch.cat([a, b, c]) for a, b, c in zip(lo, blocks, hi)],
                                             HALO_TIMED)
            del frames, lo, hi, blocks, got, want
            rows.append(row)
        for (name, route), ms in device_times(timed, HALO_TIMED).items():
            next(r for r in rows if r["slots"] == slots and r["field"] == name)[route]["device_ms"] = ms
        del timed
        torch.cuda.empty_cache()
    return rows


def mesh_phase(step_3d, runs):
    """The sharded step, each of `runs` (label prefix, configuration, start
    state, geometry, the meshes, the unsharded reference's configuration):
    the flagship on a 1D mesh of `MESH_SLOTS` slots and a (2, 2) mesh,
    128^3 and coiling_config(256) on `MESH_SLOTS` slots; `STEPS_MESH`
    steps each with the counters reset just before: the halo kernel
    launched and no PCG kernel (the solves are the distributed ones),
    solves converged; every step bitwise (x, v, c) the same steps with the
    plain halo route patched in, and within MESH_DX / MESH_DV of the
    unsharded step on the card.  The distributed cell solve is Jacobi-PCG
    and the distributed viscosity solve Jacobi-PCG whatever the
    configuration's preconditioners say, so the unsharded reference takes
    the reference configuration (the Jacobi preconditioners)."""
    import torch
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.mesh import shard_state

    out, launches_by = {}, {}
    for prefix, cfg, state0, geom, meshes, ref_cfg in runs:
        n = int(state0.particles.x.shape[0])
        ref = [state0]
        ref_iters = {k: [] for k in ("density", "viscosity", "pressure")}
        for _ in range(STEPS_MESH):
            st, m = step_3d(ref[-1], ref_cfg, geom=geom)
            ref.append(st)
            for k in ref_iters:
                ref_iters[k].append(int(m[f"{k}_iters"]))
        for name, mesh in meshes.items():
            label = f"{prefix}{name}"
            step_m = functools.partial(step_3d, mesh=mesh)
            start = shard_state(state0, mesh)
            read = reset_counters()
            state, states, step_ms, metrics = run_steps(step_m, start, cfg, geom, STEPS_MESH, STEPS_MESH)
            launches = read()
            check_run(state, metrics, launches,
                      ("halo_exchange_rdma", *REDUCE_ROUTE, "binned_segment_broadcast", "fold"), f"mesh {label}")
            pcg = {k: launches[k] for k in ("cell_poisson_pcg", "fused_poisson_pcg", "coupled_visc_pcg") if launches[k]}
            if pcg:
                raise AssertionError(f"mesh {label}: the solves launched {pcg}")
            with patched([(halo_rdma, "halo_exchange_rdma", halo_rdma.halo_exchange_rdma_plain)]):
                read_plain = reset_counters()
                plain = [start]
                for _ in range(STEPS_MESH):
                    plain.append(step_m(plain[-1], cfg, geom=geom)[0])
                if read_plain()["halo_exchange_rdma"]:
                    raise AssertionError(f"mesh {label}: the plain halo run launched the kernel")
            errs = []
            for i in range(1, STEPS_MESH + 1):
                for k in ("x", "v", "c"):
                    if not torch.equal(getattr(states[i].particles, k), getattr(plain[i].particles, k)):
                        raise AssertionError(f"mesh {label} step {i - 1}: kernel vs plain halo differ in {k}")
                dx = float((states[i].particles.x[:n] - ref[i].particles.x).abs().max())
                dv = float((states[i].particles.v[:n] - ref[i].particles.v).abs().max())
                if not (dx < MESH_DX and dv < MESH_DV):
                    raise AssertionError(f"mesh {label} step {i - 1} vs unsharded: |dx| {dx}, |dv| {dv}")
                errs.append({"dx": dx, "dv": dv})
            out[label] = dict(
                grid=list(cfg.grid.res), particles=n, mesh=mesh.shape, step_ms=step_ms,
                halo_launches_per_step=launches["halo_exchange_rdma"] / STEPS_MESH,
                kernel_vs_plain_halo_bitwise=True, vs_unsharded_by_step=errs,
                iters={k: [m[f"{k}_iters"] for m in metrics] for k in ("density", "viscosity", "pressure")},
                unsharded_iters=ref_iters, unsharded_precond=[ref_cfg.solver.precond, ref_cfg.solver.viscosity_precond])
            launches_by[label] = launches
            del state, states, plain, start
        del ref
        torch.cuda.empty_cache()
    return out, launches_by


def mesh_runs(cfg, geom, state0):
    """`mesh_phase`'s runs: the flagship on `make_mesh(MESH_SLOTS)` and
    (2, 2) (labels "1d_4", "2d_2x2"), 128^3 and coiling_config(256) on
    `make_mesh(MESH_SLOTS)`; each with its unsharded reference's
    configuration (the Jacobi preconditioners).  Yields one run at a time,
    so each configuration's states go before the next is made."""
    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_scene,
        coiling_config,
        coiling_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d

    yield "", cfg, state0, geom, {"1d_4": make_mesh(MESH_SLOTS), "2d_2x2": make_mesh2d((2, 2))}, cfg
    for prefix, make_cfg, scene in (("128_", lambda: scaled_buckling_config(RES_128), buckling_scene),
                                    ("coil_256_", lambda: coiling_config(RES_COIL), coiling_scene)):
        c = make_cfg()
        s0 = scene(c, seed=0, device="cuda")
        yield prefix, c, s0, build_geom_cache(s0.solid), {"1d_4": make_mesh(MESH_SLOTS)}, jacobi_solves(c)


def jacobi_solves(cfg):
    """`cfg` with the Jacobi cell and viscosity preconditioners: the
    unsharded step the sharded one (distributed Jacobi-PCG solves) is held
    to."""
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, precond="jacobi",
                                                                 viscosity_precond="jacobi"))


def train_step_events(model, optimizer):
    """CUDA events at the network's forward start and end (module hooks)
    and at the optimiser step's start and end (optimiser hooks), one list
    entry a training step; returns (events, remove)."""
    import torch

    events = []

    def mark(slot):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if slot == 0:
                events.append([ev, None, None, None])
            else:
                events[-1][slot] = ev
        return hook

    handles = [model.register_forward_pre_hook(mark(0)), model.register_forward_hook(mark(1)),
               optimizer.register_step_pre_hook(mark(2)), optimizer.register_step_post_hook(mark(3))]

    def remove():
        for h in handles:
            h.remove()

    return events, remove


def timed_train_steps(model, ts, train_step, pairs):
    """One training step a pair through ``make_trainer``'s ``train_step``,
    split by CUDA events into the forward (the network), the backward (the
    loss and its backward) and the optimiser step; the peak memory of the
    first step.  Returns (ts, losses, rows, peak bytes above the step's
    start)."""
    import torch

    events, remove = train_step_events(model, ts.optimizer)
    starts, losses = [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i, ex in enumerate(pairs):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        ts, loss = train_step(ts, ex)
        starts.append(start)
        losses.append(loss)
        if i == 0:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.synchronize()
    remove()
    rows = [dict(forward_ms=f0.elapsed_time(f1), backward_ms=f1.elapsed_time(b1), optimizer_ms=b1.elapsed_time(o1),
                 step_ms=s.elapsed_time(o1)) for s, (f0, f1, b1, o1) in zip(starts, events)]
    return ts, [float(v) for v in losses], rows, peak


def train_bounds(model, dtype):
    """The training step's bounds: the forward's operations (`unet_ops` at
    the flagship box) over the dtype's peak, the backward twice that, the
    optimiser Adam's bytes (parameter, gradient and two moments read; the
    parameter and the moments written; fp32) over the memory rate."""
    import torch

    rate = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    ops = unet_ops(model, UNET_BOX)
    n = sum(p.numel() for p in model.parameters())
    fwd = ops / rate * 1e3
    opt = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    return dict(forward_ms=fwd, backward_ms=2 * fwd, optimizer_ms=opt, step_ms=3 * fwd + opt, forward_ops=ops,
                rate_ops_per_s=rate)


def summarize_steps(rows):
    keys = ("forward_ms", "backward_ms", "optimizer_ms", "step_ms")
    return {k: statistics.median(r[k] for r in rows) for k in keys} | {"each": rows}


def fresh_trainer(dtype, example_x, seed=TRAIN_SEED, width=UNET_WIDTH, device="cuda", lr=TRAIN_LR):
    import torch

    from python_fluid_simulation_tpu_torch.models.train import make_trainer
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    model = UNet3D(width=width, dtype=dtype).to(device)
    init, train_step = make_trainer(model, lr)
    return model, init(torch.Generator().manual_seed(seed), example_x), train_step


def repeat_first_step(dtype, ex, label):
    """The first training step of a fresh trainer (the same seed, so the
    same parameters and an empty Adam state) on the same pair, twice:
    asserted bitwise in the loss and every parameter."""
    import torch

    runs = []
    for _ in range(2):
        model, ts, train_step = fresh_trainer(dtype, ex.x)
        ts, loss = train_step(ts, ex)
        runs.append((loss.clone(), {k: p.detach().clone() for k, p in model.named_parameters()}))
        del model, ts
    (loss_a, pa), (loss_b, pb) = runs
    if not torch.equal(loss_a, loss_b):
        raise AssertionError(f"{label}: the first training step run twice differs in its loss: {loss_a} vs {loss_b}")
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
    if differ:
        raise AssertionError(f"{label}: the first training step run twice differs in {differ}")
    return dict(bitwise_repeatable=True, loss=float(loss_a), params_compared=len(pa))


def train_card_vs_cpu():
    """A width-TRAIN_SMALL_WIDTH trainer from the same seed on the CPU
    tests' pair (tests/test_train.py::_example: a 16^3 box of seeded
    fields), TRAIN_SMALL_STEPS steps on the card and on this machine's CPU:
    losses within TRAIN_LOSS_REL and parameters within
    TRAIN_PARAM_ATOL_PER_LR_STEP * lr * steps (tests/test_torch_train.py's
    bounds), the first step's gradients within TRAIN_GRAD_REL; the entries
    whose first gradient is at Adam's eps or at its own rounding
    (TRAIN_EPS_MARGIN) are held within lr * steps and counted (those with a
    zero gradient too: a 3x3x3 kernel's outer taps on a 1^3 level)."""
    import numpy as np
    import torch

    from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig
    from python_fluid_simulation_tpu_torch.models.train import EPS, capture_viscosity_pair

    cfg = SimConfig(grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / 6),
                    physics=PhysicsConfig(dt=1.0 / 60.0), particle_dx=1.0 / 12)
    rng = np.random.default_rng(TRAIN_SEED)
    n, dual = cfg.grid.res, cfg.grid.dual_res
    shapes = [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]
    gv0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    sphi = torch.from_numpy(rng.standard_normal(dual).astype(np.float32))
    lvol = torch.from_numpy(rng.random(dual).astype(np.float32) * np.float32(cfg.grid.dx**3))
    out = {}
    for device in ("cuda", "cpu"):
        ex = capture_viscosity_pair(tuple(v.to(device) for v in gv0),
                                    tuple(v.to(device) * np.float32(0.9) for v in gv0), sphi.to(device),
                                    lvol.to(device), cfg)
        model, ts, train_step = fresh_trainer(torch.float32, ex.x, width=TRAIN_SMALL_WIDTH, device=device)
        losses = []
        tc = time.perf_counter()
        for k in range(TRAIN_SMALL_STEPS):
            ts, loss = train_step(ts, ex)
            losses.append(float(loss))
            if k == 0:
                grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        out[device] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                       time.perf_counter() - tc, tuple(ex.x.shape), grads)
    (lk, pk, sk, box, gk), (lc, pc, sc, _, gc) = out["cuda"], out["cpu"]
    grad_rel = max(((gk[n] - gc[n]).abs().max() / gc[n].abs().max().clamp(min=1e-30)).item() for n in gk)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lc))
    atol = TRAIN_PARAM_ATOL_PER_LR_STEP * TRAIN_LR * TRAIN_SMALL_STEPS
    # Adam's first update is lr * g / (|g| + eps): where |g| is near eps or
    # near its own rounding (TRAIN_GRAD_REL of its tensor's largest) it
    # turns that rounding into a move of up to lr, so there the parameters
    # are held within Adam's reach, lr * steps
    gap, gap_eps, n_eps, n_zero = 0.0, 0.0, 0, 0
    for k in pk:
        d = (pk[k] - pc[k]).abs()
        floor = TRAIN_EPS_MARGIN * max(EPS, TRAIN_GRAD_REL * gc[k].abs().max().item())
        near_eps = gc[k].abs() < floor
        n_eps += int(near_eps.sum())
        n_zero += int((gc[k] == 0).sum())
        gap = max(gap, float(d[~near_eps].max()) if (~near_eps).any() else 0.0)
        gap_eps = max(gap_eps, float(d[near_eps].max()) if near_eps.any() else 0.0)
    if not (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL and gap <= atol
            and gap_eps <= TRAIN_LR * TRAIN_SMALL_STEPS):
        raise AssertionError(
            f"width-{TRAIN_SMALL_WIDTH} training, card vs CPU: losses {lk} vs {lc} (rel {loss_rel}, bound "
            f"{TRAIN_LOSS_REL}); first-step gradients rel {grad_rel} (bound {TRAIN_GRAD_REL}); parameters max |d| "
            f"{gap} (bound {atol}), at {n_eps} entries whose gradient is at the rounding floor {gap_eps} "
            f"(bound {TRAIN_LR * TRAIN_SMALL_STEPS})")
    return dict(width=TRAIN_SMALL_WIDTH, box=list(box), steps=TRAIN_SMALL_STEPS, lr=TRAIN_LR, card_losses=lk,
                cpu_losses=lc, loss_rel=loss_rel, loss_tol=TRAIN_LOSS_REL, first_step_grad_max_rel=grad_rel,
                grad_tol=TRAIN_GRAD_REL, param_max_abs=gap, param_atol=atol, near_eps_entries=n_eps,
                zero_grad_entries=n_zero,
                near_eps_param_max_abs=gap_eps, near_eps_atol=TRAIN_LR * TRAIN_SMALL_STEPS,
                params=sum(v.numel() for v in pk.values()), card_seconds=sk, cpu_seconds=sc)


def unpool_phase(state_dict, x):
    """The full-width forward with both unpool forms (the transposed conv,
    `FastUnpool`) on the same weights and box, fp32 and bf16: fp32 max |d| /
    max |out| <= UNPOOL_REL (bf16 reported); each form's forward ms and the
    four unpools' ms on the inputs the fast forward gives them, beside their
    bound."""
    import torch
    import torch.nn.functional as F

    from python_fluid_simulation_tpu_torch.models.unet3d import FastUnpool, UNet3D, fast_unpool, precise_flags

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        nets = {}
        for fast in (False, True):
            net = UNet3D(width=UNET_WIDTH, dtype=dtype, fast_unpool=fast).eval()
            net.load_state_dict(state_dict)
            nets[fast] = net.to("cuda")
        inputs = {}
        hooks = [m.register_forward_pre_hook(lambda m, a, name=name: inputs.__setitem__(name, a[0]))
                 for name, m in nets[True].named_modules() if isinstance(m, FastUnpool)]
        with torch.no_grad():
            ref, got = nets[False](x), nets[True](x)
            for h in hooks:
                h.remove()
            d, rel = max_err(got, ref)
            if dtype == torch.float32 and not rel <= UNPOOL_REL:
                raise AssertionError(f"fast_unpool vs the transposed conv, fp32 forward: max |d| / max |out| {rel} > "
                                     f"{UNPOOL_REL}")
            fwd = {form: cuda_time_ms(lambda: nets[fast](x), 5) for form, fast in (("conv_transpose", False),
                                                                                   ("fast_unpool", True))}
            unpools = {}
            with precise_flags():
                for name, v in inputs.items():
                    m = getattr(nets[False], name)
                    w, b = m.weight.to(dtype), m.bias.to(dtype)
                    nbytes = (v.numel() * 9 + w.numel()) * v.element_size()  # input, weight, 8x output
                    ops = 2 * v.numel() * w.shape[1] * 8 + 8 * v.numel() // v.shape[1] * w.shape[1]
                    rate = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
                    unpools[name] = dict(
                        input=list(v.shape),
                        conv_transpose_ms=cuda_time_ms(lambda: F.conv_transpose3d(v, w, b, stride=2), 20),
                        fast_unpool_ms=cuda_time_ms(lambda: fast_unpool(v, w, b), 20),
                        bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3)
        out["fp32" if dtype == torch.float32 else "bf16"] = dict(
            max_abs=d, rel=rel, tol=UNPOOL_REL if dtype == torch.float32 else None, forward_ms=fwd,
            unpools=unpools, unpools_ms={k: sum(u[f"{k}_ms"] for u in unpools.values())
                                         for k in ("conv_transpose", "fast_unpool", "bound")})
        del nets, ref, got, inputs
        torch.cuda.empty_cache()
    return out


def pipeline_phase():
    """``models/train_unet_prod.py`` at small counts, through its entry
    points, in a scratch directory of the checkout (removed after):
    capture PIPE_CAPTURE flagship steps, one bf16 epoch over the first
    PIPE_PAIRS pairs, eval PIPE_EVAL steps; the counters reset just before
    and read just after."""
    import shutil

    from python_fluid_simulation_tpu_torch.models import train_unet_prod as prod

    out = os.path.join(prod.OUT, "chip_smoke")
    shutil.rmtree(out, ignore_errors=True)
    try:
        read_counts = reset_counters()
        t0 = time.perf_counter()
        prod.capture(PIPE_CAPTURE, out=out)
        t1 = time.perf_counter()
        losses = prod.train(1, width=UNET_WIDTH, steps_cap=PIPE_PAIRS, out=out)
        t2 = time.perf_counter()
        rec, series = prod.evaluate(PIPE_EVAL, width=UNET_WIDTH, out=out)
        t3 = time.perf_counter()
        launches = read_counts()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    need = ("cell_poisson_pcg", *REDUCE_ROUTE, "binned_segment_broadcast", "fold", "coupled_visc_pcg",
            "coupled_matvec_geom")
    for name in need:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the capture -> train -> eval path")
    if len(losses) != PIPE_PAIRS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"pipeline train losses {losses}")
    if len(series["iou"]) != PIPE_EVAL or not all(0.0 <= v <= 1.0 for v in series["iou"]):
        raise AssertionError(f"pipeline eval IoU {series['iou']}")
    return dict(capture_steps=PIPE_CAPTURE, train_pairs=PIPE_PAIRS, eval_steps=PIPE_EVAL, losses=losses,
                metrics=rec, iou=series["iou"], apic_visc_iters=series["apic_visc_iters"],
                warm_visc_iters=series["warm_visc_iters"], capture_seconds=t1 - t0, train_seconds=t2 - t1,
                eval_seconds=t3 - t2), launches


def train_phase():
    """The trainer on the card: TRAIN_PAIRS flagship pairs captured, full-
    width fp32 and bf16 training steps (timed, split, beside their bounds,
    the loss falling, the first step bitwise repeatable), the card against
    the CPU at width TRAIN_SMALL_WIDTH, both unpool forms, and the pipeline
    at small counts (its launches are the phase's)."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_scene
    from python_fluid_simulation_tpu_torch.models import train_unet_prod as prod
    from python_fluid_simulation_tpu_torch.models.train import generate_training_data

    out = {}
    # 1. capture on the pipeline's config (the flagship at a fixed dt)
    t0 = time.perf_counter()
    cfg = prod._cfg()
    pairs = list(generate_training_data(buckling_scene(cfg, seed=0, device="cuda"), cfg, TRAIN_PAIRS))
    torch.cuda.synchronize()
    for i, ex in enumerate(pairs):
        if tuple(ex.x.shape) != UNET_BOX or tuple(ex.y.shape) != (1, 3) + UNET_BOX[2:]:
            raise AssertionError(f"pair {i}: x {tuple(ex.x.shape)}, y {tuple(ex.y.shape)}")
        for k in ("x", "y", "mask"):
            if not torch.isfinite(getattr(ex, k)).all():
                raise AssertionError(f"pair {i}: non-finite {k}")
        if i and not ex.y.abs().max().item() > 0:
            raise AssertionError(f"pair {i}: the target is zero (step {i} solves viscosity)")
    out["capture"] = dict(pairs=TRAIN_PAIRS, box=list(UNET_BOX), seconds=time.perf_counter() - t0,
                          max_abs_target=[ex.y.abs().max().item() for ex in pairs])

    # 2-3. full-width training steps, fp32 then bf16; the first step of each
    # run twice from a fresh trainer, bitwise
    t0 = time.perf_counter()
    for dtype, label in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        det = repeat_first_step(dtype, pairs[1], f"{label} training")
        torch.cuda.empty_cache()
        model, ts, train_step = fresh_trainer(dtype, pairs[1].x)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != UNET_PARAMS:
            raise AssertionError(f"the width-{UNET_WIDTH} UNet has {n_params} parameters, expected {UNET_PARAMS}")
        ts, warm_loss = train_step(ts, pairs[1])
        steps = TRAIN_FP32_STEPS if dtype == torch.float32 else TRAIN_BF16_STEPS
        ts, losses, rows, peak = timed_train_steps(model, ts, train_step, [pairs[1]] * steps)
        # fp32: over the warm-up and the 3 timed steps; bf16: over the 10
        falls = [float(warm_loss)] + losses if dtype == torch.float32 else losses
        if not falls[-1] < falls[0]:
            raise AssertionError(f"{label} training on pair 1: the loss did not fall: {falls}")
        row = dict(determinism=det, warmup_loss=float(warm_loss), losses_pair1=losses,
                   steps_pair1=summarize_steps(rows), peak_bytes_above_start=peak,
                   max_memory_allocated=torch.cuda.max_memory_allocated(), bound=train_bounds(model, dtype))
        if dtype == torch.bfloat16:
            ts, losses_pass, rows_pass, _ = timed_train_steps(model, ts, train_step, pairs[1:])
            row.update(losses_pass=losses_pass, steps_pass=summarize_steps(rows_pass))
        else:
            fp32_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out[label] = row
        del model, ts
        torch.cuda.empty_cache()
    out["steps_seconds"] = time.perf_counter() - t0

    # 4. the card against the CPU, width TRAIN_SMALL_WIDTH
    t0 = time.perf_counter()
    out["card_vs_cpu"] = train_card_vs_cpu()
    out["card_vs_cpu"]["seconds"] = time.perf_counter() - t0

    # 5. both unpool forms, on the fp32 run's weights and pair 1's box
    t0 = time.perf_counter()
    out["unpool"] = unpool_phase(fp32_state, pairs[1].x)
    out["unpool"]["seconds"] = time.perf_counter() - t0
    del pairs, fp32_state
    torch.cuda.empty_cache()

    # 6. the pipeline at small counts
    t0 = time.perf_counter()
    out["pipeline"], launches = pipeline_phase()
    out["pipeline"]["seconds"] = time.perf_counter() - t0
    return out, launches


def same_bits(a, b):
    """Equal dtypes, shapes and bits: fp32 compared as int32 words (-0.0
    is not 0.0, a NaN equals its own bits), other types by value."""
    import torch

    if a.dtype != b.dtype or a.device != b.device:
        return False
    return bits_equal(a, b) if a.dtype == torch.float32 else torch.equal(a, b)


def state_differences(a, b, solid=False):
    """The fields of two states that differ in a bit (particles x, v, c,
    t, step_idx, visc_mg; with ``solid`` the solid's phi, v and table)."""
    import torch

    pairs = [(k, getattr(a.particles, k), getattr(b.particles, k)) for k in ("x", "v", "c")]
    pairs += [(k, torch.as_tensor(getattr(a, k)), torch.as_tensor(getattr(b, k))) for k in ("t", "step_idx", "visc_mg")]
    if solid:
        pairs += [(f"solid.{k}", getattr(a.solid, k), getattr(b.solid, k)) for k in ("phi", "v", "rb")]
    return [k for k, x, y in pairs if not same_bits(x, y)]


def metric_differences(a, b):
    return sorted(set(a) ^ set(b)) + [k for k in a if k in b and not same_bits(a[k], b[k])]


def generic_solves(cfg, mg_branch):
    """The solves of a step that run the generic CG (`solvers/cg.py`:
    under capture a WHILE node each), from the configuration and the
    'auto' branch."""
    sol, mu = cfg.solver, cfg.physics.mu
    out = [s for s in ("density", "pressure") if sol.precond == "mg" or not sol.jacobi_precond]
    if mu > 0 and sol.viscosity_mode != "unet":
        mg = sol.viscosity_precond == "mg" or (sol.viscosity_precond == "auto" and mg_branch)
        if mg or not sol.jacobi_precond:
            out.append("viscosity")
    return out


def mesh_solves(cfg):
    """The distributed solves of a mesh step (``parallel/halo.py``: under
    capture a WHILE node each): density, pressure and, with mu > 0
    outside 'unet', viscosity."""
    solves = ["density", "pressure"]
    if cfg.physics.mu > 0 and cfg.solver.viscosity_mode != "unet":
        solves.append("viscosity")
    return solves


def mesh_halo_launches(cfg, metrics):
    """The halo pull launches of mesh steps with these metrics, counted
    from their iterations (the slots on one card: one launch an exchange
    along x; z exchanges are plain): the search direction's exchange each
    iteration of the cell solves, and of the viscosity solve's three
    fields each iteration and once before its loop (the init matvec)."""
    n = 0
    for m in metrics:
        n += int(m["density_iters"]) + int(m["pressure_iters"])
        if "viscosity" in mesh_solves(cfg):
            n += 3 * (int(m["viscosity_iters"]) + 1)
    return n


def event_timed(fn, sync_error=False):
    """(fn(), ms between CUDA events around it, host ms to a synchronize);
    with ``sync_error`` fn runs under ``set_sync_debug_mode("error")``."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3


def eager_vs_graph(label, cfg, state0, steps, unet=None, sync_check=True, mesh=None, bucketed=False,
                   eager_states=None):
    """`steps` eager steps (``step_3d``, the geometry built inside as the
    captured step builds it) and `steps` replays of ``make_step``'s graph
    from the same state, after one warm-up of each (the graph's is its
    capture): every step's particles, t, step_idx, visc_mg and metrics
    bitwise equal; no wrapper launches a kernel during the replays, and
    with ``sync_check`` the replays run under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync fails).
    With a ``mesh`` (and ``bucketed``) the sharded step: its distributed
    solves are the WHILE nodes, and the halo launches of the replays,
    counted from their iterations (`mesh_halo_launches`), equal the eager
    steps' counted launches.  ``eager_states`` (a list) receives the eager
    states.  Returns the row (with the eager steps' counted launches) and
    the WHILE-node test launches of the replays."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step import make_step, step_3d
    from python_fluid_simulation_tpu_torch.ops.cuda_graph import captured_while

    step = make_step(cfg, unet=unet, mesh=mesh, bucketed=bucketed)
    eager_step = functools.partial(step_3d, unet=unet, mesh=mesh, bucketed=bucketed)
    event_timed(lambda: eager_step(state0, cfg))
    nodes0 = captured_while.nodes
    _, capture_event_ms, capture_host_ms = event_timed(lambda: step(state0))
    read_counts = reset_counters()
    eager, eager_ms, eager_host_ms = [state0], [], []
    eager_metrics = []
    for _ in range(steps):
        (st, m), ms, host = event_timed(lambda: eager_step(eager[-1], cfg))
        eager.append(st)
        eager_metrics.append(m)
        eager_ms.append(ms)
        eager_host_ms.append(host)
    eager_launches = read_counts()
    read_counts = reset_counters()
    rep = next(iter(step.replayers.values()))
    replays0 = rep.replays
    graph, graph_ms, graph_host_ms, graph_metrics = [state0], [], [], []
    for i in range(steps):
        (st, m), ms, host = event_timed(lambda: step(graph[-1]), sync_error=sync_check)
        graph.append(st)
        graph_metrics.append(m)
        graph_ms.append(ms)
        graph_host_ms.append(host)
    graph_launches = read_counts()
    replays = rep.replays - replays0
    if replays != steps or any(graph_launches.values()):
        raise AssertionError(f"{label}: {replays} replays for {steps} steps, wrapper launches {graph_launches}")
    for i in range(steps):
        bad = state_differences(eager[i + 1], graph[i + 1], solid=cfg.moving_solid)
        bad += metric_differences(eager_metrics[i], graph_metrics[i])
        if bad:
            raise AssertionError(f"{label} step {i}: graph and eager differ in {bad}")
    branches = sorted(str(k) for k in rep.captured)
    nodes = captured_while.nodes - nodes0  # every capture of this step (one a branch)

    def loops(mg_branch):
        return mesh_solves(cfg) if mesh is not None else generic_solves(cfg, mg_branch)

    want_nodes = sum(len(loops(b)) for b in rep.captured)
    if nodes != want_nodes:
        raise AssertionError(f"{label}: {nodes} WHILE nodes recorded, {want_nodes} CG solves captured")
    # the test kernel runs once before each node's loop and once an iteration
    test_launches = 0
    for i, m in enumerate(graph_metrics):
        mg_branch = mesh is None and int(torch.as_tensor(graph[i].visc_mg)) > 0
        test_launches += sum(int(m[f"{s}_iters"]) + 1 for s in loops(mg_branch))
    mesh_row = {}
    if mesh is not None:
        replay_halo = mesh_halo_launches(cfg, graph_metrics)
        if replay_halo != eager_launches["halo_exchange_rdma"]:
            raise AssertionError(f"{label}: {replay_halo} halo launches from the replays' iterations, "
                                 f"{eager_launches['halo_exchange_rdma']} counted in the eager steps")
        lost = [int(m["bucket_lost"]) for m in graph_metrics] if bucketed else None
        if bucketed and any(lost):
            raise AssertionError(f"{label}: bucket_lost {lost}")
        mesh_row = dict(mesh=mesh.shape, bucketed=bucketed, bucket_lost=lost,
                        halo_launches_per_replayed_step=replay_halo / steps,
                        halo_launches_counted="from the replays' iterations (mesh_halo_launches), equal to the "
                                              "eager steps' counter")
    if eager_states is not None:
        eager_states.extend(eager)
    caps = list(rep.captured.values())
    if len(caps) == 1:  # the nodes a replay runs: the top level, and each WHILE body once an iteration
        order = [s for s in ("density", "viscosity", "pressure") if s in loops(next(iter(rep.captured)))]
        if len(caps[0].loop_nodes) != len(order):
            raise AssertionError(f"{label}: WHILE bodies {caps[0].loop_nodes} for the solves {order}")
        mesh_row["nodes_per_replayed_step"] = [
            caps[0].nodes - len(order) + sum(n * int(m[f"{s}_iters"]) for s, n in zip(order, caps[0].loop_nodes))
            for m in graph_metrics]
    return dict(**mesh_row,
        steps=steps, branches=branches, bitwise=True, sync_debug_mode_error=sync_check,
        eager_ms=eager_ms, graph_ms=graph_ms, median_eager_ms=statistics.median(eager_ms),
        median_graph_ms=statistics.median(graph_ms),
        eager_host_ms=eager_host_ms, graph_host_ms=graph_host_ms,
        eager_wrapper_launches_per_step=sum(eager_launches.values()) / steps,
        graph_wrapper_launches_per_step=0, graph_replays_per_step=replays / steps,
        while_nodes=nodes, while_test_launches=test_launches,
        capture_seconds=[c.seconds for c in caps], capture_call_event_ms=capture_event_ms,
        capture_call_host_ms=capture_host_ms, graph_pool_bytes=[c.pool_bytes for c in caps],
        graph_nodes=[c.nodes for c in caps], loop_body_nodes=[list(c.loop_nodes) for c in caps],
        iters={k: [int(m[f"{k}_iters"]) for m in graph_metrics] for k in ("density", "viscosity", "pressure")},
        eager_launches=eager_launches,
    ), test_launches


def while_node_phase():
    """The WHILE node's test kernel (``csrc/cuda_graph.cu``) against its
    plain version, the eager loop's host test: iterations of captured
    loops equal to the host loop's on edge cases (capped, converged
    before the loop, delta 0, max_iter 0, a body that halves res), and
    the ms of one test launch (a 1000-iteration loop with an empty body,
    its count reset inside the graph) beside one host test."""
    import numpy as np
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_graph import captured_while, graph_capture

    def scalar(v, dtype=torch.float32):
        return torch.full((), v, dtype=dtype, device="cuda")

    def host_loop(res, thresh, delta, max_iter, halve):
        k = 0
        while res >= thresh and k < max_iter and delta != 0:
            res = float(np.float32(res) * np.float32(0.5)) if halve else res
            k += 1
        return k

    cases = [(1.0, 0.0, 1.0, 1000, False), (0.0, 1.0, 1.0, 1000, False), (1.0, 0.0, 0.0, 1000, False),
             (1.0, 0.0, 1.0, 0, False), (1.0, 1e-3, 1.0, 1000, True)]
    rows, worst = [], 0
    for res_v, thresh_v, delta_v, max_iter, halve in cases:
        k, res, thresh, delta = scalar(0, torch.int32), scalar(res_v), scalar(thresh_v), scalar(delta_v)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph) as body_pool:
            k.zero_()
            res.fill_(res_v)
            captured_while((lambda: res.mul_(0.5)) if halve else (lambda: None), k, res, thresh, delta, max_iter)
        graph.replay()
        graph.replay()  # the graph resets k and res itself
        torch.cuda.synchronize()
        want = host_loop(res_v, thresh_v, delta_v, max_iter, halve)
        worst = max(worst, abs(int(k) - want))
        row = dict(res=res_v, thresh=thresh_v, delta=delta_v, max_iter=max_iter, body="halve res" if halve else "empty",
                   iters=int(k), host_iters=want)
        if max_iter == 1000 and not halve and res_v >= thresh_v and delta_v:
            reps = 20
            row["ms_per_test"] = cuda_time_ms(graph.replay, reps) / (max_iter + 1)
        rows.append(row)
        del graph, body_pool
    if worst:
        raise AssertionError(f"while node vs the host loop: {rows}")
    res, thresh, delta = scalar(1.0), scalar(0.0), scalar(1.0)
    plain_ms = cuda_time_ms(lambda: bool((res >= thresh) & (delta != 0)), 200)
    timed = next(r for r in rows if "ms_per_test" in r)
    return dict(cases=rows, max_abs_err=worst, ms=timed["ms_per_test"], plain_ms=plain_ms,
                # reads res, thresh, delta and k, writes k (20 bytes); 3 compares and an add
                **bound(20, 4))


def rebuild_geometry(cfg, solid, dt):
    """The moving-solid step's geometry rebuild (engine/step.py): the
    bodies advanced by dt, the level set and velocity on the dual lattice,
    the geometry cache."""
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache
    from python_fluid_simulation_tpu_torch.ops import sdf
    from python_fluid_simulation_tpu_torch.ops.indexing import grid_positions
    from python_fluid_simulation_tpu_torch.state import SolidState

    g = cfg.grid
    rb = sdf.advance_rigid_bodies(solid.rb, dt)
    phi, v = sdf.evaluate(rb, grid_positions(g.dual_res, g.bound_min, g.dual_cell_size, (0.0,) * 3, device=rb.device))
    return build_geom_cache(SolidState(phi=phi, v=v, rb=rb))


def graph_phase(unet_sd):
    """The step as one captured program (``make_step``): eager against
    graph, bitwise, on every configuration the card runs; ms and launches
    a step of each; the moving box; the WHILE node's test kernel."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        moving_box_config,
        moving_box_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import step_3d
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    def with_solver(c, **kw):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, **kw))

    def flagged(state, v):
        return dataclasses.replace(state, visc_mg=torch.full((), v, dtype=torch.int32, device="cuda"))

    rows, test_launches = {}, 0

    def run(label, *a, **kw):
        nonlocal test_launches
        rows[label], n = eager_vs_graph(label, *a, **kw)
        test_launches += n
        torch.cuda.empty_cache()

    cfg = buckling_config()
    s0 = buckling_scene(cfg, seed=0, device="cuda")
    run("flagship", cfg, s0, GRAPH_STEPS)
    unet = UNet3D(width=UNET_WIDTH).eval()
    unet.load_state_dict(unet_sd)
    unet = unet.to("cuda")
    for mode in ("unet", "unet_warm"):
        run(f"flagship_{mode}", with_solver(cfg, viscosity_mode=mode), s0, GRAPH_CHECK_STEPS, unet=unet)
    del unet
    run("flagship_nojac", with_solver(cfg, jacobi_precond=False), s0, GRAPH_CHECK_STEPS)
    del s0
    cfg = scaled_buckling_config(RES_128)
    run("128", cfg, buckling_scene(cfg, seed=0, device="cuda"), GRAPH_CHECK_STEPS)
    for res in (RES_COIL, RES_504):
        cfg = coiling_config(res)
        s2 = coiling_scene(cfg, seed=0, device="cuda")
        for _ in range(2):  # the first steps from rest solve no viscosity
            s2, _ = step_3d(s2, cfg)
        for flag, branch in ((0, "jacobi"), (2, "mg")):
            label = f"coil_{res}_auto_{branch}"
            run(label, cfg, flagged(s2, flag), GRAPH_CHECK_STEPS, sync_check=False)
            if ("True" if flag else "False") not in rows[label]["branches"]:
                raise AssertionError(f"{label}: the first step did not take the {branch} branch: {rows[label]}")
        del s2
    cfg = scaled_buckling_config(RES_256)
    run("256", cfg, buckling_scene(cfg, seed=0, device="cuda"), GRAPH_CHECK_STEPS)

    # the moving box: the geometry rebuilt inside every step
    cfg = moving_box_config(dx=MOVING_DX)
    s0 = moving_box_scene(cfg, seed=0, device="cuda")
    run("moving_box", cfg, s0, MOVING_STEPS)
    from python_fluid_simulation_tpu_torch.engine.step import make_step

    final = s0
    step = make_step(cfg)
    for _ in range(MOVING_STEPS):
        final, m = step(final)
    dt = m["dt"]
    rebuild_eager_ms = cuda_time_ms(lambda: rebuild_geometry(cfg, s0.solid, dt), 20)
    graph = torch.cuda.CUDAGraph()
    rebuild_geometry(cfg, s0.solid, dt)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        rebuild_geometry(cfg, s0.solid, dt)
    rebuild_graph_ms = cuda_time_ms(graph.replay, 20)
    del graph, step
    moving = rows["moving_box"]
    moving.update(
        grid=list(cfg.grid.res), particles=int(s0.particles.x.shape[0]),
        body_displacement=(final.solid.rb[1, 1:4, 3] - s0.solid.rb[1, 1:4, 3]).tolist(),
        rebuild_geometry_eager_ms=rebuild_eager_ms, rebuild_geometry_graph_ms=rebuild_graph_ms,
        rebuild_share_of_graph_step=rebuild_graph_ms / moving["median_graph_ms"])
    if not moving["body_displacement"][1] < -1e-3:
        raise AssertionError(f"moving box: the body did not sink: {moving['body_displacement']}")
    torch.cuda.empty_cache()
    return rows, test_launches, while_node_phase()


def run_cli(argv):
    """``run.main(argv)`` with its standard output kept: (seconds, the
    steps/s of its last block line, the output, the graphs `simulate`
    captured and the replayers it made during the run)."""
    import io

    from python_fluid_simulation_tpu_torch import run as cli
    from python_fluid_simulation_tpu_torch.engine.step import simulate

    held = simulate.capture
    captures, replayers = held.captures, held.replayers
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"run.main({argv}) returned {rc}:\n{out}")
    rates = [float(ln.split("(")[1].split()[0]) for ln in out.splitlines() if ln.endswith("steps/s)")]
    return seconds, rates[-1], out, held.captures - captures, held.replayers - replayers


def npz_leaves(path):
    import numpy as np

    with np.load(path) as d:
        return [d[f"arr_{i}"] for i in range(len(d.files))]


def cli_phase(smi):
    """The port's CLI (``run.main``) on the card: the flagship in blocks
    with every output, resumed from its middle checkpoint (bitwise), one
    capture a run (one an 'auto' branch), the same steps as one
    ``simulate`` call, and the two unit APIs on the step's kernels vs
    their plain versions (bitwise)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from python_fluid_simulation_tpu_torch import native
    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
    )
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, simulate
    from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_fold, levelset, scatter, transfers

    held = simulate.capture
    held.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    native.load()  # the marching cubes' g++ build (nothing is built before this phase)
    mc_load_seconds = time.perf_counter() - t0
    out = {"marching_cubes_build_seconds": native.LIB.build_seconds, "marching_cubes_load_seconds": mc_load_seconds}
    n_blocks = CLI_STEPS // CLI_BLOCK
    with tempfile.TemporaryDirectory(prefix="pfs_cli_") as tmp:
        full, resumed, from_mid = (os.path.join(tmp, n) for n in ("full", "resumed", "from_mid"))
        flag = ["--scene", "buckling", "--max-steps", str(CLI_STEPS), "--block", str(CLI_BLOCK)]
        seconds, rate, text, captures, replayers = run_cli(
            [*flag, "--out", full, "--metrics", "--snapshot-pickle", "--export-obj", "--export-html",
             "--checkpoint-every", str(CLI_BLOCK)])
        if (captures, replayers) != (1, 1):
            raise AssertionError(f"cli flagship: {captures} captures by {replayers} replayers over {n_blocks} blocks")
        capture_s = held.replayer.captured[None].seconds
        names = sorted(os.listdir(full))
        for name in ("ckpt", "metrics.jsonl", "ps.pickle", "replay.html", "surface.obj"):
            if name not in names:
                raise AssertionError(f"cli flagship: no {name} in {names}")
        with open(os.path.join(full, "surface.obj")) as f:
            triangles = sum(1 for ln in f if ln.startswith("f "))
        with open(os.path.join(full, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        if [r["step"] for r in recs] != list(range(CLI_STEPS)) or not all(
                r[f"{k}_converged"] for r in recs for k in ("density", "viscosity", "pressure")):
            raise AssertionError(f"cli flagship: metrics {[(r['step'], r['pressure_converged']) for r in recs]}")
        if "solid mesh skipped" in text:
            raise AssertionError(f"cli flagship: {text}")
        out["flagship"] = dict(
            steps=CLI_STEPS, block=CLI_BLOCK, seconds=seconds, cli_steps_per_s=rate, captures=captures,
            capture_seconds=capture_s, surface_triangles=triangles,
            html_bytes=os.path.getsize(os.path.join(full, "replay.html")),
            checkpoint_bytes=os.path.getsize(os.path.join(full, "ckpt", f"state_{CLI_STEPS}.npz")))

        # resume from the middle checkpoint: bitwise the uninterrupted run
        os.makedirs(from_mid)
        for name in ("config.json", f"state_{CLI_BLOCK}.npz"):
            shutil.copy(os.path.join(full, "ckpt", name), os.path.join(from_mid, name))
        r_seconds, r_rate, _, r_captures, r_replayers = run_cli(
            [*flag, "--out", resumed, "--checkpoint-every", str(CLI_BLOCK), "--resume", from_mid])
        want = npz_leaves(os.path.join(full, "ckpt", f"state_{CLI_STEPS}.npz"))
        got = npz_leaves(os.path.join(resumed, "ckpt", f"state_{CLI_STEPS}.npz"))
        differ = [i for i, (a, b) in enumerate(zip(got, want)) if a.dtype != b.dtype or a.tobytes() != b.tobytes()]
        if differ or (r_captures, r_replayers) != (1, 1):
            raise AssertionError(f"cli resume: leaves {differ} differ; {r_captures} captures, {r_replayers} replayers")
        out["resume"] = dict(from_step=CLI_BLOCK, to_step=CLI_STEPS, seconds=r_seconds, cli_steps_per_s=r_rate,
                             captures=r_captures, bitwise_the_uninterrupted_run=True)

        # the bucketed flagship on 4 slots of the card: one capture a run,
        # resumed from the middle checkpoint bitwise
        m_full, m_resumed, m_mid = (os.path.join(tmp, n) for n in ("mesh_full", "mesh_resumed", "mesh_from_mid"))
        m_flag = ["--scene", "buckling", "--mesh", str(MESH_SLOTS), "--bucketed", "--max-steps", str(CLI_MESH_STEPS),
                  "--block", str(CLI_MESH_BLOCK), "--checkpoint-every", str(CLI_MESH_BLOCK)]
        m_seconds, m_rate, m_text, m_captures, m_replayers = run_cli([*m_flag, "--out", m_full, "--metrics"])
        with open(os.path.join(m_full, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        if (m_captures, m_replayers) != (1, 1) or "bucket-sharded over" not in m_text or any(
                r["bucket_lost"] for r in recs) or len(recs) != CLI_MESH_STEPS:
            raise AssertionError(f"cli bucketed flagship: {m_captures} captures by {m_replayers} replayers, "
                                 f"lost {[r['bucket_lost'] for r in recs]}")
        m_capture_s = held.replayer.captured[None].seconds
        os.makedirs(m_mid)
        for name in ("config.json", f"state_{CLI_MESH_BLOCK}.npz"):
            shutil.copy(os.path.join(m_full, "ckpt", name), os.path.join(m_mid, name))
        mr_seconds, mr_rate, _, mr_captures, mr_replayers = run_cli([*m_flag, "--out", m_resumed, "--resume", m_mid])
        m_want = npz_leaves(os.path.join(m_full, "ckpt", f"state_{CLI_MESH_STEPS}.npz"))
        m_got = npz_leaves(os.path.join(m_resumed, "ckpt", f"state_{CLI_MESH_STEPS}.npz"))
        differ = [i for i, (a, b) in enumerate(zip(m_got, m_want)) if a.dtype != b.dtype or a.tobytes() != b.tobytes()]
        if differ or (mr_captures, mr_replayers) != (1, 1):
            raise AssertionError(f"cli bucketed resume: leaves {differ} differ; {mr_captures} captures, "
                                 f"{mr_replayers} replayers")
        out["flagship_mesh_bucketed"] = dict(
            mesh=MESH_SLOTS, steps=CLI_MESH_STEPS, block=CLI_MESH_BLOCK, seconds=m_seconds, cli_steps_per_s=m_rate,
            captures=m_captures, capture_seconds=m_capture_s, bucket_lost=0,
            resume=dict(from_step=CLI_MESH_BLOCK, seconds=mr_seconds, cli_steps_per_s=mr_rate, captures=mr_captures,
                        bitwise_the_uninterrupted_run=True))
        held.clear()

    # the same steps as one simulate call (a fresh capture), its final state
    # bitwise the CLI's; then the same blocks re-capturing each one, as a
    # simulate without the held capture would
    cfg = buckling_config()
    s0 = buckling_scene(cfg, seed=0, device="cuda")
    geom = build_geom_cache(s0.solid)
    held.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one, _ = simulate(s0, cfg, CLI_STEPS, geom=geom)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_capture_s = held.replayer.captured[None].seconds
    for i, k in enumerate(("x", "v", "c")):
        if getattr(one.particles, k).cpu().numpy().tobytes() != want[i].tobytes():
            raise AssertionError(f"cli: one simulate call of {CLI_STEPS} steps differs from the CLI run in {k}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = s0
    for _ in range(n_blocks):
        state, _ = simulate(state, cfg, CLI_BLOCK, geom=geom)
    torch.cuda.synchronize()
    kept_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = s0
    for _ in range(n_blocks):
        held.clear()
        state, _ = simulate(state, cfg, CLI_BLOCK, geom=geom)
    torch.cuda.synchronize()
    recapture_s = time.perf_counter() - t0
    out["one_simulate_call"] = dict(
        steps=CLI_STEPS, seconds=one_s, steps_per_s=CLI_STEPS / one_s, capture_seconds=one_capture_s,
        bitwise_the_cli_run=True,
        cli_overhead_per_block_s=(CLI_STEPS / out["flagship"]["cli_steps_per_s"] - one_s) / n_blocks,
        blocks_capture_kept_s=kept_s, blocks_recaptured_s=recapture_s,
        capture_saved_per_block_s=(recapture_s - kept_s) / n_blocks)

    # the unit APIs on the flagship's final particles: p2g_axis (each axis)
    # and compute_fluid_volume through rows 13, 11 and 14, bitwise their
    # plain versions on the same CUDA tensors
    g = cfg.grid
    p = one.particles
    face_bias = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))

    def units():
        res = []
        for a in range(3):
            fshape = tuple(n + (1 if i == a else 0) for i, n in enumerate(g.res))
            res += transfers.p2g_axis(p.x, p.m, p.v, p.c[:, a], a, g.res, fshape, face_bias[a], g.bound_min,
                                      g.cell_size)
        res.append(levelset.compute_fluid_volume(p.x, cfg.particle_dx**3, g.dual_res, g.bound_min,
                                                 g.dual_cell_size, pm=p.m))
        return res

    read_counts = reset_counters()
    got = units()
    torch.cuda.synchronize()
    unit_launches = {k: v for k, v in read_counts().items() if v}
    with patched([(scatter, "scan_reduce", cuda_binned.scan_reduce_plain), (scatter, "fold", cuda_fold.fold_plain)]):
        plain = units()
    if unit_launches != {"seg_scan_sorted": 4, "binned_segment_place_live": 4, "fold": 7}:
        raise AssertionError(f"cli units: launches {unit_launches}")
    names = [f"p2g_axis_{a}_{q}" for a in range(3) for q in ("gm", "gv")] + ["compute_fluid_volume"]
    differ = [n for n, a, b in zip(names, got, plain) if not bits_equal(a, b)]
    if differ or not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"cli units: {differ} differ from the plain versions")
    out["unit_apis"] = dict(launches=unit_launches, bitwise_the_plain_versions=names,
                            particles=int(p.x.shape[0]), fluid_volume_sum=float(got[-1].sum()))
    del one, state, s0, geom, got, plain
    held.clear()
    torch.cuda.empty_cache()

    # coiling 'auto' through the CLI: one capture a branch reached; then the
    # same configuration's two branches across blocks of one replayer
    with tempfile.TemporaryDirectory(prefix="pfs_cli_coil_") as tmp:
        c_seconds, c_rate, _, c_captures, c_replayers = run_cli(
            ["--scene", "coiling", "--max-steps", str(CLI_COIL_STEPS), "--block", str(CLI_COIL_BLOCK),
             "--out", tmp, "--metrics"])
        branches = sorted(str(b) for b in held.replayer.captured)
    if c_replayers != 1 or c_captures != len(branches):
        raise AssertionError(f"cli coiling: {c_captures} captures by {c_replayers} replayers, branches {branches}")
    cfg = coiling_config(RES_COIL)
    s = coiling_scene(cfg, seed=0, device="cuda")
    geom = build_geom_cache(s.solid)
    held.clear()
    flags = (0, 2, 0, 2)
    captures, replayers = held.captures, held.replayers
    for v in flags:
        s = dataclasses.replace(s, visc_mg=torch.full((), v, dtype=torch.int32, device="cuda"))
        s, _ = simulate(s, cfg, CLI_COIL_BLOCK, geom=geom)
    both = sorted(str(b) for b in held.replayer.captured)
    if (held.captures - captures, held.replayers - replayers) != (2, 1) or both != ["False", "True"]:
        raise AssertionError(f"cli coiling auto: {held.captures - captures} captures by "
                             f"{held.replayers - replayers} replayers for the flags {flags}, branches {both}")
    out["coiling"] = dict(steps=CLI_COIL_STEPS, block=CLI_COIL_BLOCK, seconds=c_seconds, cli_steps_per_s=c_rate,
                          captures=c_captures, branches=branches,
                          auto_blocks_flags=list(flags), auto_blocks_captures=2, auto_blocks_branches=both)
    del s, geom
    held.clear()
    torch.cuda.empty_cache()
    out["nvidia_smi"] = smi
    return out


def twod_fold_rows(cfg, state):
    """Every fold of one 2D step (eager, on the card): the 2D fold bitwise
    its plain version, then `fold_phase` on the 3D fold the kernel runs
    (``cuda_fold.lift_2d``): the live kernel bitwise its plain version,
    the dense route and tests/live_table_model.py's model, with ms, plain
    ms, the scatter_reduce_ yardstick and the bound."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step2d import step_2d
    from python_fluid_simulation_tpu_torch.ops import cuda_fold

    with recorded_folds() as folds:
        step_2d(state, cfg)
    lifted = []
    for label, args, kw in folds:
        got, ref = cuda_fold.fold(*args, **kw), cuda_fold.fold_plain(*args, **kw)
        if len(args[2]) != 2 or not bits_equal(got, ref):
            raise AssertionError(f"2D fold[{label}]: {tuple(args[2])}, the kernel differs from its plain version")
        lifted.append((label, cuda_fold.lift_2d(*args[:3]) + tuple(args[3:]), kw))
    rows = fold_phase(lifted)
    # the device time of the kernel and of the scatter_reduce_ yardstick
    # (the event ms above are the host's: small folds are launch-bound)
    for row, (_, args, kw) in zip(rows, lifted):
        table, axis_shifts, out_shape, combine, fill = args
        dense = table.dense()
        idx, vals = fold_targets(dense, axis_shifts, out_shape), dense.reshape(-1)

        def library():
            out = torch.full(tuple(out_shape), float(fill), dtype=dense.dtype, device=dense.device)
            return out.view(-1).scatter_reduce_(0, idx, vals, reduce="sum" if combine == "add" else "amin",
                                                include_self=True)

        dev = device_times({"kernel": lambda: cuda_fold.fold(*args, **kw), "library": library}, 20)
        row.update(device_ms=dev["kernel"], library_device_ms=dev["library"])
    return rows


def eager_vs_graph_2d(label, cfg, state0, steps):
    """`eager_vs_graph` for the 2D step: `steps` eager ``step_2d`` calls and
    `steps` replays of ``make_step_2d``'s graph from the same state after
    one warm-up each, bitwise (particles, t, step_idx, metrics); no wrapper
    launch and no host sync (``set_sync_debug_mode("error")``) in the
    replays; one WHILE node a generic CG solve (density, pressure and,
    with mu > 0, viscosity).  Returns the row, the eager states and the
    eager run's launches."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step2d import make_step_2d, step_2d
    from python_fluid_simulation_tpu_torch.ops.cuda_graph import captured_while

    step = make_step_2d(cfg)
    event_timed(lambda: step_2d(state0, cfg))
    nodes0 = captured_while.nodes
    _, capture_event_ms, capture_host_ms = event_timed(lambda: step(state0))
    read = reset_counters()
    eager, eager_metrics, eager_ms = [state0], [], []
    for _ in range(steps):
        (st, m), ms, _ = event_timed(lambda: step_2d(eager[-1], cfg))
        eager.append(st)
        eager_metrics.append(m)
        eager_ms.append(ms)
    launches = read()
    read = reset_counters()
    rep = next(iter(step.replayers.values()))
    replays0 = rep.replays
    graph, graph_metrics, graph_ms = [state0], [], []
    for _ in range(steps):
        (st, m), ms, _ = event_timed(lambda: step(graph[-1]), sync_error=True)
        graph.append(st)
        graph_metrics.append(m)
        graph_ms.append(ms)
    graph_launches = read()
    if rep.replays - replays0 != steps or any(graph_launches.values()):
        raise AssertionError(f"{label}: {rep.replays - replays0} replays, wrapper launches {graph_launches}")
    for i in range(steps):
        bad = state_differences(eager[i + 1], graph[i + 1]) + metric_differences(eager_metrics[i], graph_metrics[i])
        if bad:
            raise AssertionError(f"{label} step {i}: graph and eager differ in {bad}")
    nodes = captured_while.nodes - nodes0
    want_nodes = 3 if cfg.physics.mu > 0 else 2
    if nodes != want_nodes:
        raise AssertionError(f"{label}: {nodes} WHILE nodes, {want_nodes} generic CG solves")
    per_step = {k: v / steps for k, v in launches.items()}
    need = ("seg_scan_sorted", "binned_segment_place_live", "fold")
    if any(not launches[k] for k in need) or any(launches[k] for k in ROWS_1_TO_10):
        raise AssertionError(f"{label}: launches {launches} (rows 11, 13, 14 and none of rows 1-10)")
    iters = {k: [int(m[f"{k}_iters"]) for m in graph_metrics] for k in ("density", "viscosity", "pressure")}
    if any(i >= cfg.solver.max_iter for v in iters.values() for i in v):
        raise AssertionError(f"{label}: a solve hit max_iter: {iters}")
    for k in ("x", "v", "c"):
        if not bool(torch.isfinite(getattr(graph[-1].particles, k)).all()):
            raise AssertionError(f"{label}: non-finite particle {k}")
    cap = next(iter(rep.captured.values()))
    return dict(
        grid=list(cfg.grid.res), particles=int(state0.particles.x.shape[0]), steps=steps, bitwise=True,
        sync_debug_mode_error=True, eager_ms=eager_ms, graph_ms=graph_ms,
        median_eager_ms=statistics.median(eager_ms), median_graph_ms=statistics.median(graph_ms),
        capture_seconds=cap.seconds, capture_call_event_ms=capture_event_ms, capture_call_host_ms=capture_host_ms,
        graph_pool_bytes=cap.pool_bytes, while_nodes=nodes, iters=iters,
        launches_per_step={k: v for k, v in per_step.items() if v},
    ), eager, launches


def twod_phase(smi):
    """The 2D engine on the card: the dam break and the droplet at
    ``SimConfig2D()`` (the CLI's 64x64 cells) and the dam break at dx
    1/256 (about 55k particles), each eager against its graph, bitwise;
    the third step on the kernels against the same step with every kernel
    swapped for its plain version (STEP_TOL), the CPU from the card's
    state reported; every fold of a step (the 2D fold as the kernel's 3D
    fold) bitwise; the CLI's 2D dam break."""
    import tempfile

    import torch

    from python_fluid_simulation_tpu_torch.config import GridConfig2D
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
    from python_fluid_simulation_tpu_torch.engine.step2d import (
        SimConfig2D,
        dam_break_scene_2d,
        droplet_scene_2d,
        simulate_2d,
        step_2d,
    )

    rows, launches_by, folds = {}, {}, {}
    fine = SimConfig2D(grid=GridConfig2D(dx=TWOD_FINE[0]), particle_dx=TWOD_FINE[1])
    for label, maker, cfg in (("dam_break_2d", dam_break_scene_2d, SimConfig2D()),
                              ("droplet_2d", droplet_scene_2d, SimConfig2D()),
                              ("dam_break_2d_256", dam_break_scene_2d, fine)):
        cfg, s0 = maker(cfg, seed=0, device="cuda")
        row, states, launches = eager_vs_graph_2d(label, cfg, s0, TWOD_STEPS)
        before, after = states[2], states[3]
        read = reset_counters()
        with plain_kernels():
            plain_after, _ = step_2d(before, cfg)
        if any(read().values()):
            raise AssertionError(f"{label}: the plain step launched a kernel")
        err = {k: float((getattr(after.particles, k) - getattr(plain_after.particles, k)).abs().max())
               for k in STEP_TOL}
        if any(err[k] > tol for k, tol in STEP_TOL.items()):
            raise AssertionError(f"{label} step 2 vs the plain step on the card: {err}")
        cpu_after, _ = step_2d(state_from_numpy(state_to_numpy(before), device="cpu"), cfg)
        vs_cpu = step_diff(state_to_numpy(after), state_to_numpy(cpu_after))
        row.update(card_vs_plain_on_card=err, card_vs_plain_bitwise=not state_differences(after, plain_after),
                   reported_vs_cpu=vs_cpu)
        folds[label] = twod_fold_rows(cfg, before)
        # simulate_2d replays the held capture, bitwise the eager steps
        held = simulate_2d.capture
        held.clear()
        captures = held.captures
        sim_state, _ = simulate_2d(s0, cfg, 3)
        bad = state_differences(sim_state, states[3])
        if bad or held.captures - captures != 1:
            raise AssertionError(f"{label}: simulate_2d differs from the eager steps in {bad} "
                                 f"({held.captures - captures} captures)")
        held.clear()
        rows[label], launches_by[label] = row, launches
        del states, before, after, plain_after, cpu_after, sim_state, s0
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pfs_cli_2d_") as tmp:
        seconds, rate, _, _, _ = run_cli(["--scene", "dam_break_2d", "--max-steps", str(CLI_2D_STEPS), "--block",
                                          str(CLI_2D_STEPS), "--out", tmp, "--metrics"])
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
    max_iter = SimConfig2D().solver.max_iter
    if [r["step"] for r in recs] != list(range(CLI_2D_STEPS)) or any(
            r[f"{k}_iters"] >= max_iter for r in recs for k in ("density", "viscosity", "pressure")):
        raise AssertionError(f"cli dam_break_2d: metrics {recs}")
    cli_row = dict(steps=CLI_2D_STEPS, seconds=seconds, cli_steps_per_s=rate, every_solve_converged=True,
                   iters={k: [r[f"{k}_iters"] for r in recs] for k in ("density", "viscosity", "pressure")})
    return dict(runs=rows, folds=folds, cli=cli_row, nvidia_smi=smi), launches_by


def matched(state, n):
    """(x, v, m) of the live particles, ordered by mass (unique masses
    match a particle across the two layouts)."""
    import torch

    m = state.particles.m
    live = m > 0
    if int(live.sum()) != n:
        raise AssertionError(f"{int(live.sum())} live particles, want {n}")
    order = torch.argsort(m[live])
    return state.particles.x[live][order], state.particles.v[live][order], m[live][order]


def unique_masses(state):
    """The state with masses m (1 + BUCKET_MASS_STEP i), distinct in fp32,
    so that a particle is matched across two layouts by its mass."""
    import torch

    n = state.particles.x.shape[0]
    scale = 1.0 + BUCKET_MASS_STEP * torch.arange(n, dtype=torch.float32, device=state.particles.m.device)
    m = state.particles.m * scale
    if int(torch.unique(m).numel()) != n:
        raise AssertionError("the scaled masses are not distinct")
    return dataclasses.replace(state, particles=dataclasses.replace(state.particles, m=m))


def vs_unsharded(label, states, ref_states, n):
    """max |dx|, |dv| of each step of `states` against `ref_states` (as
    many as given), the particles matched by mass; both under the mesh
    bars."""
    import torch

    errs = []
    for i in range(1, len(ref_states)):
        xb, vb, mb = matched(states[i], n)
        xr, vr, mr = matched(ref_states[i], n)
        if not torch.equal(mb, mr):
            raise AssertionError(f"{label} step {i - 1}: the particle sets differ")
        dx, dv = float((xb - xr).abs().max()), float((vb - vr).abs().max())
        if not (dx < MESH_DX and dv < MESH_DV):
            raise AssertionError(f"{label} step {i - 1} vs unsharded: |dx| {dx}, |dv| {dv}")
        errs.append({"dx": dx, "dv": dv})
    return errs


def plain_steps_bitwise(label, step, start, states, cfg, geom, steps):
    """The same steps with every kernel swapped for its plain version: no
    launch, and every step's particles bitwise the kernels' steps."""
    read = reset_counters()
    with plain_kernels():
        pl = [start]
        for _ in range(steps):
            pl.append(step(pl[-1], cfg, geom=geom)[0])
    if any(read().values()):
        raise AssertionError(f"{label}: the plain steps launched kernels")
    for i in range(1, steps + 1):
        bad = [k for k in "xvcm" if not same_bits(getattr(states[i].particles, k), getattr(pl[i].particles, k))]
        if bad:
            raise AssertionError(f"{label} step {i - 1}: kernels vs plain versions differ in {bad}")


def bucketed_run(label, cfg, state0, geom, mesh, steps, ref_states=None, plain=False):
    """`steps` bucketed steps on `mesh` (1D: by x-slab, (x, z): by x-by-z
    block) from `state0` (masses unique), the counters reset just before;
    against ``ref_states`` (the state and the unsharded steps from it, as
    many as given) by mass; with ``plain`` the same steps with every kernel
    swapped for its plain version, bitwise.  Returns the row and the
    launches."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step import step_3d
    from python_fluid_simulation_tpu_torch.parallel.mesh import shard_state
    from python_fluid_simulation_tpu_torch.profile_step import bucketed_particles

    n = int(state0.particles.x.shape[0])
    start = shard_state(state0, mesh)
    spec, particles = bucketed_particles(start, cfg, mesh)
    start = dataclasses.replace(start, particles=particles)
    step_b = functools.partial(step_3d, mesh=mesh, bucketed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = reset_counters()
    state, states, step_ms, metrics = run_steps(step_b, start, cfg, geom, steps, steps)
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    check_run(state, metrics, launches, ("halo_exchange_rdma", *REDUCE_ROUTE, "binned_segment_broadcast", "fold"),
              label)
    lost = [m["bucket_lost"] for m in metrics]
    if any(lost):
        raise AssertionError(f"{label}: bucket_lost {lost}")
    row = dict(mesh=mesh.shape, spec=spec._asdict(), particles=n, step_ms=step_ms,
               median_step_ms=statistics.median(step_ms[1:] if len(step_ms) > 1 else step_ms), bucket_lost=lost,
               max_memory_allocated=peak, halo_launches_per_step=launches["halo_exchange_rdma"] / steps,
               launches_per_step={k: v / steps for k, v in launches.items() if v},
               iters={k: [m[f"{k}_iters"] for m in metrics] for k in ("density", "viscosity", "pressure")})
    if ref_states is not None:
        row["vs_unsharded_by_step"] = vs_unsharded(label, states, ref_states, n)
    if plain:
        plain_steps_bitwise(label, step_b, start, states, cfg, geom, steps)
        row["kernels_vs_plain_bitwise"] = True
    del state, states, start
    torch.cuda.empty_cache()
    return row, launches


def bucketed_phase(smi):
    """Bucketed residency on meshes of the card, masses made unique: the
    flagship on 4 slots (slab width 12) and on (2, 2) (24 x 24) against
    the unsharded steps, ``coiling_config(504)`` on 2 slots (slab width 63)
    and on (2, 2) (63 x 63, both odd) against the unsharded first step,
    each bitwise its plain-kernel steps; the CLI's ``--scene buckling
    --mesh 4 --bucketed``."""
    import tempfile

    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
    )
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d

    out, launches_by = {}, {}
    cfg = buckling_config()
    s0 = unique_masses(buckling_scene(cfg, seed=0, device="cuda"))
    geom = build_geom_cache(s0.solid)
    ref = [s0]
    for _ in range(BUCKET_STEPS):
        ref.append(step_3d(ref[-1], cfg, geom=geom)[0])
    for key, label, mesh in (("flagship_4", "flagship bucketed", make_mesh(BUCKET_SLOTS)),
                             ("flagship_2x2", "flagship bucketed (2, 2)", make_mesh2d(BUCKET_2D))):
        out[key], launches_by[key] = bucketed_run(label, cfg, s0, geom, mesh, BUCKET_STEPS, ref_states=ref,
                                                  plain=True)
    del ref, s0, geom
    torch.cuda.empty_cache()
    cfg504 = coiling_config(RES_504)
    s504 = unique_masses(coiling_scene(cfg504, seed=0, device="cuda"))
    geom504 = build_geom_cache(s504.solid)
    ref = [s504, step_3d(s504, cfg504, geom=geom504)[0]]
    for key, label, mesh in (("coil_504_2", "504 bucketed", make_mesh(BUCKET_504_SLOTS)),
                             ("coil_504_2x2", "504 bucketed (2, 2)", make_mesh2d(BUCKET_2D))):
        out[key], launches_by[key] = bucketed_run(label, cfg504, s504, geom504, mesh, BUCKET_504_STEPS,
                                                  ref_states=ref, plain=True)
    del ref, s504, geom504
    torch.cuda.empty_cache()
    widths = {k: (r["spec"].get("slab_wx"), r["spec"].get("slab_wz")) for k, r in out.items() if "2x2" in k}
    if widths != {"flagship_2x2": (24, 24), "coil_504_2x2": (63, 63)}:
        raise AssertionError(f"bucketed (2, 2) slabs: {widths}")
    with tempfile.TemporaryDirectory(prefix="pfs_cli_bucketed_") as tmp:
        seconds, rate, text, _, _ = run_cli(["--scene", "buckling", "--mesh", str(BUCKET_SLOTS), "--bucketed",
                                             "--max-steps", "3", "--block", "3", "--out", tmp, "--metrics"])
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
    if len(recs) != 3 or any(r["bucket_lost"] for r in recs) or not all(
            r[f"{k}_converged"] for r in recs for k in ("density", "viscosity", "pressure")):
        raise AssertionError(f"cli bucketed: metrics {recs}")
    if "bucket-sharded over" not in text:
        raise AssertionError(f"cli bucketed: {text}")
    out["cli"] = dict(steps=3, seconds=seconds, cli_steps_per_s=rate, bucket_lost=[0, 0, 0],
                      every_solve_converged=True)
    out["nvidia_smi"] = smi
    return out, launches_by


def mesh_learned_phase(smi, unet_sd):
    """The learned modes under a mesh: the flagship (masses unique) in
    'unet' and 'unet_warm' with the full-width UNet on
    ``make_mesh(MESH_SLOTS)`` and ``make_mesh2d((2, 2))``, and 'unet_warm'
    bucketed on (2, 2), `MESH_LEARNED_STEPS` steps each with the counters
    reset just before: every step within MESH_DX / MESH_DV of the
    unsharded learned step on the card (by mass), bitwise the same steps
    with every kernel swapped for its plain version, every solve
    converged; 'unet_warm' launches rows 7/8 twice a step (its line
    search) and no PCG kernel, 'unet' neither.  Reported: ms a step, the
    viscosity iterations and the line search's α beside the unsharded
    run's."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d, shard_state
    from python_fluid_simulation_tpu_torch.profile_step import bucketed_particles
    from python_fluid_simulation_tpu_torch.solvers import viscosity

    unet = UNet3D(width=UNET_WIDTH).eval()
    unet.load_state_dict(unet_sd)
    unet = unet.to("cuda")
    cfg0 = buckling_config()
    s0 = unique_masses(buckling_scene(cfg0, seed=0, device="cuda"))
    n = int(s0.particles.x.shape[0])
    geom = build_geom_cache(s0.solid)
    line, alphas = viscosity.rescaled_warm_start, []

    def rec_line(*a, **kw):
        x0, alpha = line(*a, **kw)
        alphas.append(alpha)
        return x0, alpha

    def summary(ms, metrics):
        return dict(step_ms=ms, median_step_ms=statistics.median(ms[1:]),
                    iters={k: [m[f"{k}_iters"] for m in metrics] for k in ("density", "viscosity", "pressure")},
                    alpha=[float(a) for a in alphas])

    out, launches_by = {}, {}
    steps = MESH_LEARNED_STEPS
    for mode in ("unet", "unet_warm"):
        cfg = dataclasses.replace(cfg0, solver=dataclasses.replace(cfg0.solver, viscosity_mode=mode))
        alphas.clear()
        with patched([(viscosity, "rescaled_warm_start", rec_line)]):
            _, ref, ms, metrics = run_steps(functools.partial(step_3d, unet=unet), s0, cfg, geom, steps, steps)
        out[f"{mode}_unsharded"] = summary(ms, metrics)
        runs = [("1d_4", make_mesh(MESH_SLOTS), False), ("2d_2x2", make_mesh2d(BUCKET_2D), False)]
        if mode == "unet_warm":
            runs.append(("2d_2x2_bucketed", make_mesh2d(BUCKET_2D), True))
        for label, mesh, bucketed in runs:
            key, name = f"{mode}_{label}", f"flagship {mode} {label}"
            start = shard_state(s0, mesh)
            if bucketed:
                start = dataclasses.replace(start, particles=bucketed_particles(start, cfg, mesh)[1])
            step_m = functools.partial(step_3d, unet=unet, mesh=mesh, bucketed=bucketed)
            alphas.clear()
            with patched([(viscosity, "rescaled_warm_start", rec_line)]):
                read = reset_counters()
                state, states, ms, metrics = run_steps(step_m, start, cfg, geom, steps, steps)
                launches = read()
            need = ("halo_exchange_rdma", *REDUCE_ROUTE, "binned_segment_broadcast", "fold")
            if mode == "unet_warm":
                need += ("coupled_stencil_matvec",)
            check_run(state, metrics, launches, need, name)
            refused = ("cell_poisson_pcg", "fused_poisson_pcg", "coupled_visc_pcg", "coupled_matvec_geom")
            if mode == "unet":
                refused += ("coupled_stencil_matvec",)
            wrong = {k: launches[k] for k in refused if launches[k]}
            if wrong:
                raise AssertionError(f"{name}: launched {wrong}")
            if mode == "unet_warm" and launches["coupled_stencil_matvec"] != 2 * steps:
                raise AssertionError(f"{name}: {launches['coupled_stencil_matvec']} line-search matvecs in {steps} steps")
            if bucketed and any(m["bucket_lost"] for m in metrics):
                raise AssertionError(f"{name}: bucket_lost {[m['bucket_lost'] for m in metrics]}")
            row = summary(ms, metrics)
            row.update(mesh=mesh.shape, bucketed=bucketed, vs_unsharded_by_step=vs_unsharded(name, states, ref, n),
                       halo_launches_per_step=launches["halo_exchange_rdma"] / steps,
                       coupled_stencil_matvec_launches_per_step=launches["coupled_stencil_matvec"] / steps)
            plain_steps_bitwise(name, step_m, start, states, cfg, geom, steps)
            row["kernels_vs_plain_bitwise"] = True
            out[key], launches_by[key] = row, launches
            del state, states, start
        del ref
    out["unet_width"], out["nvidia_smi"] = UNET_WIDTH, smi
    del unet, s0, geom
    torch.cuda.empty_cache()
    return out, launches_by


def push_captured():
    """Row 15's push recorded into a CUDA graph on one card over
    ``make_mesh(2)`` (``ops/cuda_graph.py::graph_capture``) and replayed
    three times, new block contents and one eager push between replays:
    every replay's outputs bitwise the eager push of the same blocks, and
    the slots' device epochs advanced by every exchange, replayed or
    eager.  Returns the row."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_graph import graph_capture
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    blocks = [torch.randn((16, 64, 32), generator=gen, device="cuda") for _ in range(2)]
    halo_rdma.halo_exchange_push(mesh, blocks, "x")  # the mesh's counters, made eagerly
    graph = torch.cuda.CUDAGraph()
    before = halo_rdma.halo_exchange_push.launches
    with graph_capture(graph, capture_error_mode="thread_local") as pools:
        outs = halo_rdma.halo_exchange_push(mesh, blocks, "x")
    recorded = halo_rdma.halo_exchange_push.launches - before
    sem, counters = mesh.push_state("x")
    epochs = []
    for rep in range(3):
        for b in blocks:
            b.add_(1.0)
        graph.replay()
        want = halo_rdma.halo_exchange_push(mesh, blocks, "x")
        torch.cuda.synchronize()
        if not all(bits_equal(g, w) for g, w in zip(outs, want)):
            raise AssertionError(f"the captured push, replay {rep}: differs from the eager push")
        epochs.append([c.tolist() for c in counters])
    want_epochs = [1 + 2 * (rep + 1) for rep in range(3)]
    if [[c[0] for c in e] for e in epochs] != [[w, w] for w in want_epochs] or any(c[2] for e in epochs for c in e) \
            or int(sem[-1]):
        raise AssertionError(f"the captured push: slot counters {epochs} (epochs {want_epochs} wanted), error word "
                             f"{int(sem[-1])}")
    del graph, pools
    return dict(slots=2, block=list(blocks[0].shape), recorded_launches=recorded, replays=3,
                bitwise_the_eager_push=True, slot_counters_after_each_replay_and_push=epochs)


def psum_phase():
    """The cross-card sum (``csrc/mesh_psum.cu``) on one card: over
    `PSUM_SLOTS` slots of cuda:0 (one launch a slot, each on its slot's
    stream, each spinning until every slot's partials have landed), 1, 2
    and 3 dots of seeded partials, `PSUM_REPS` calls each with changing
    partials, bitwise its plain version (the slot-order sum); CUDA-event
    and device ms of a call beside the plain version's and the bound (the
    bytes a call moves: every slot's partials stored into every slot's
    buffer and read back once, the counters, over 3.35 TB/s; the same
    bytes over NVLink at 450 GB/s, where the slots are cards)."""
    import torch

    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, timed = [], {}
    for slots in PSUM_SLOTS:
        mesh = make_mesh(slots)
        for dots in (1, 2, 3):
            parts = [tuple(torch.randn((), generator=gen, device="cuda") for _ in range(dots)) for _ in range(slots)]
            before = halo_rdma.mesh_psum.launches
            bad = torch.zeros((), dtype=torch.int64, device="cuda")
            for _ in range(PSUM_REPS):
                for p in parts:
                    for t in p:
                        t.mul_(1.0001).add_(0.5)
                got = halo_rdma.mesh_psum(mesh, parts)
                want = halo_rdma.mesh_psum_plain(mesh, parts)
                for g, w in zip(got, want):
                    bad += (g[0].view(torch.int32) != w[0].view(torch.int32)).sum()
            launched = halo_rdma.mesh_psum.launches - before
            if int(bad) or launched != PSUM_REPS * slots:
                raise AssertionError(f"mesh_psum over {slots} slots, {dots} dots: {int(bad)} sums differ, "
                                     f"{launched} launches")
            nbytes = halo_rdma.psum_bytes(slots, dots)
            row = dict(slots=slots, dots=dots, calls=PSUM_REPS, max_abs_err=0.0, launches_per_call=slots,
                       ms=cuda_time_ms(lambda: halo_rdma.mesh_psum(mesh, parts), PSUM_TIMED),
                       plain_ms=cuda_time_ms(lambda: halo_rdma.mesh_psum_plain(mesh, parts), PSUM_TIMED),
                       library_ms=None, **bound(nbytes, dots * (slots - 1)),
                       nvlink_bytes=nbytes, nvlink_bound_ms=nbytes / NVLINK_BYTES_PER_S * 1e3)
            timed[(slots, dots)] = functools.partial(halo_rdma.mesh_psum, mesh, parts)
            rows.append(row)
    for (slots, dots), ms in device_times(timed, PSUM_TIMED).items():
        next(r for r in rows if r["slots"] == slots and r["dots"] == dots)["device_ms"] = ms
    return rows


def graph_mesh_phase(smi, unet_sd):
    """The sharded, bucketed and learned mesh steps as captured programs
    (``make_step(cfg, mesh=, bucketed=)``), every slot on the card: eager
    against graph, bitwise, with no host sync in a replay, on the flagship
    sharded and bucketed on ``make_mesh(4)`` and ``make_mesh2d((2, 2))``,
    ``coiling_config(504)`` sharded on 4 slots and bucketed on 2 and on
    (2, 2), ``scaled_buckling_config(128)`` and ``coiling_config(256)``
    sharded on 4 slots, the flagship with the full-width UNet in 'unet' and
    'unet_warm' on both meshes and 'unet_warm' bucketed on (2, 2), the
    moving box (its geometry rebuilt on the mesh every step) sharded on 4
    slots; ms a step of each, capture seconds, pool bytes, WHILE nodes,
    halo launches a replayed step.  Then ``simulate(mesh=,
    bucketed=True)``: two calls, one capture, the first bitwise the eager
    steps; the push captured and replayed (`push_captured`)."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        moving_box_config,
        moving_box_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import simulate
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d, shard_state
    from python_fluid_simulation_tpu_torch.profile_step import bucketed_particles

    rows, test_launches, launches_by = {}, 0, {}

    def start_on(state, cfg, mesh, bucketed):
        start = shard_state(state, mesh)
        if bucketed:
            start = dataclasses.replace(start, particles=bucketed_particles(start, cfg, mesh)[1])
        return start

    def run(label, cfg, state, mesh, bucketed, steps, unet=None, eager_states=None):
        nonlocal test_launches
        row, n = eager_vs_graph(label, cfg, start_on(state, cfg, mesh, bucketed), steps, unet=unet, mesh=mesh,
                                bucketed=bucketed, eager_states=eager_states)
        launches_by[label] = row.pop("eager_launches")
        rows[label], test_launches = row, test_launches + n
        torch.cuda.empty_cache()

    meshes = {"4": lambda: make_mesh(MESH_SLOTS), "2x2": lambda: make_mesh2d(BUCKET_2D)}
    cfg = buckling_config()
    s0 = buckling_scene(cfg, seed=0, device="cuda")
    kept = []
    for bucketed in (False, True):
        for name, make in meshes.items():
            label = f"flagship_{'bucketed' if bucketed else 'sharded'}_{name}"
            run(label, cfg, s0, make(), bucketed, GRAPH_MESH_STEPS,
                eager_states=kept if (bucketed and name == "4") else None)

    # simulate(mesh=, bucketed=True): one capture across two calls, the
    # first call bitwise the eager steps from the same state
    held = simulate.capture
    held.clear()
    mesh = make_mesh(MESH_SLOTS)
    start = start_on(s0, cfg, mesh, True)
    captures, replayers = held.captures, held.replayers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, _ = simulate(start, cfg, GRAPH_MESH_STEPS, mesh=mesh, bucketed=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second, m2 = simulate(first, cfg, GRAPH_MESH_STEPS, mesh=mesh, bucketed=True)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    bad = state_differences(kept[-1], first)
    made = (held.captures - captures, held.replayers - replayers)
    if bad or made != (1, 1) or any(int(v) for v in m2["bucket_lost"]):
        raise AssertionError(f"simulate(mesh=, bucketed=True): differs from the eager steps in {bad}; "
                             f"{made[0]} captures by {made[1]} replayers; lost {m2['bucket_lost'].tolist()}")
    rows["simulate_flagship_bucketed_4"] = dict(
        calls=2, steps_per_call=GRAPH_MESH_STEPS, captures=1, first_call_s=first_s, second_call_s=second_s,
        second_call_ms_per_step=second_s / GRAPH_MESH_STEPS * 1e3, bitwise_the_eager_steps=True,
        capture_seconds=held.replayer.captured[None].seconds, graph_pool_bytes=held.replayer.captured[None].pool_bytes)
    held.clear()
    del kept, first, second, start
    torch.cuda.empty_cache()

    unet = UNet3D(width=UNET_WIDTH).eval()
    unet.load_state_dict(unet_sd)
    unet = unet.to("cuda")
    for mode in ("unet", "unet_warm"):
        cfg_u = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_mode=mode))
        for name, make in meshes.items():
            run(f"flagship_{mode}_{name}", cfg_u, s0, make(), False, GRAPH_MESH_UNET_STEPS, unet=unet)
        if mode == "unet_warm":
            run(f"flagship_{mode}_bucketed_2x2", cfg_u, s0, make_mesh2d(BUCKET_2D), True, GRAPH_MESH_UNET_STEPS,
                unet=unet)
    del unet, s0
    torch.cuda.empty_cache()

    cfg504 = coiling_config(RES_504)
    s504 = coiling_scene(cfg504, seed=0, device="cuda")
    for label, mesh, bucketed in (("coil_504_sharded_4", make_mesh(MESH_SLOTS), False),
                                  ("coil_504_bucketed_2", make_mesh(BUCKET_504_SLOTS), True),
                                  ("coil_504_bucketed_2x2", make_mesh2d(BUCKET_2D), True)):
        run(label, cfg504, s504, mesh, bucketed, GRAPH_MESH_504_STEPS)
    del s504
    torch.cuda.empty_cache()
    for label, c, scene in (("128_sharded_4", scaled_buckling_config(RES_128), buckling_scene),
                            ("coil_256_sharded_4", coiling_config(RES_COIL), coiling_scene)):
        run(label, c, scene(c, seed=0, device="cuda"), make_mesh(MESH_SLOTS), False, GRAPH_MESH_STEPS)
    cfg_mb = moving_box_config(dx=MOVING_MESH_DX)
    run("moving_box_sharded_4", cfg_mb, moving_box_scene(cfg_mb, seed=0, device="cuda"), make_mesh(MESH_SLOTS), False,
        MOVING_MESH_STEPS)
    rows["push_captured"] = push_captured()
    rows["nvidia_smi"] = smi
    return rows, test_launches, launches_by


def all_nvidia_smi_lines():
    """Every card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def sync_all():
    """Wait for every card (``torch.cuda.synchronize()`` waits for the
    current one only)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def launch_devices():
    """Every kernel launch inside, by wrapper name and card: the launches
    pass through ``ops/_cuda_build.py::launching``, which each wrapper
    enters once where it counts one launch; a Counter of (name, device)."""
    from python_fluid_simulation_tpu_torch.ops import _cuda_build

    seen = collections.Counter()
    real = _cuda_build.launching

    @contextlib.contextmanager
    def recorded(name, *tensors, stream=None):
        with real(name, *tensors, stream=stream) as handle:
            seen[(name, str(_cuda_build.launch_device(name, *tensors)))] += 1
            yield handle

    _cuda_build.launching = recorded
    try:
        yield seen
    finally:
        _cuda_build.launching = real


def by_card(seen):
    """{device: {wrapper name: launches}} of a `launch_devices` record."""
    out = {}
    for (name, dev), n in sorted(seen.items()):
        out.setdefault(dev, {})[name] = n
    return out


def state_on(state, dev):
    """A copy of `state` on `dev` (through the host, bit for bit)."""
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy

    return state_from_numpy(state_to_numpy(state), device=dev)


def cpu_bits_differ(a, b):
    """The fields of two states (any devices) that differ in a bit."""
    import torch

    pairs = [(k, getattr(a.particles, k), getattr(b.particles, k)) for k in ("x", "v", "c", "m")]
    pairs += [(k, torch.as_tensor(getattr(a, k)), torch.as_tensor(getattr(b, k))) for k in ("t", "step_idx")]
    return [k for k, x, y in pairs if not same_bits(x.cpu(), y.cpu())]


def one_card_runs(label, cfg, s0, steps, unet=None):
    """`steps` eager steps (``step_3d``, the geometry built inside, as the
    captured step builds it) and `steps` replays of ``make_step``'s graph
    from `s0`, with its tensors' card not the current one where `s0` is
    off cuda:0; every replay bitwise its eager step.  Returns (eager
    states, replayed states, eager ms a step)."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step import make_step, step_3d

    eager, ms = [s0], []
    for _ in range(steps):
        sync_all()
        t0 = time.perf_counter()
        eager.append(step_3d(eager[-1], cfg, unet=unet)[0])
        sync_all()
        ms.append((time.perf_counter() - t0) * 1e3)
    step = make_step(cfg, unet=unet)
    replayed = [s0]
    for _ in range(steps):
        replayed.append(step(replayed[-1])[0])
    sync_all()
    for i in range(1, steps + 1):
        bad = cpu_bits_differ(eager[i], replayed[i])
        if bad:
            raise AssertionError(f"{label} on {s0.particles.x.device} step {i - 1}: the replay differs from the eager "
                                 f"step in {bad}")
    del step
    torch.cuda.empty_cache()
    return eager, replayed, ms


# the rows each path-1 configuration must launch on the other card (by
# the name its wrapper passes to ``launching``)
CARDS_PATH1_NEEDS = {
    "flagship": ("cell_poisson_pcg", "coupled_visc_pcg", "seg_scan_sorted", "place_live", "segment_broadcast", "fold"),
    "128": ("stencil_matvec", "mg_vcycle_tail"),
    "coiling_auto_mg": ("coupled_matvec_geom", "stencil_matvec", "mg_vcycle_tail"),
    "flagship_nojac": ("stencil_matvec", "coupled_stencil_matvec"),
    "coil_504_lean": ("fused_poisson_pcg",),
    "halo_pull": ("halo_exchange_rdma",),
    "wide_reduce": ("segment_reduce",),
}


def cards_path1(other):
    """Path 1: the single-device step with its tensors on `other`, cuda:0
    current, eagerly and through ``make_step``, each step bitwise the same
    step on cuda:0 in this run: the flagship (rows 1, 2, 11-14), 128^3
    (6, 9), coiling 'auto' from visc_mg = 2 (4, 6, 9 batched), the
    flagship with ``jacobi_precond=False`` (5, 7, 8), one lean 504 step
    (3); then the halo pull over 4 slots of `other` (15) and a
    `WIDE_CHANNELS`-channel reduce through the serial kernel (10), each
    bitwise its plain version and the same call on cuda:0.  Every
    launch of the other card's runs is on that card, none on cuda:0."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import step_3d
    from python_fluid_simulation_tpu_torch.ops import cuda_binned as cbn
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.halo import _padded_extent
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.current_device() != 0:
        raise AssertionError("path 1 runs with cuda:0 current")
    home = torch.device("cuda", 0)

    def with_solver(c, **kw):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, **kw))

    def warmed(cfg, s, n):  # steps on cuda:0 so the systems are not at rest
        for _ in range(n):
            s, _ = step_3d(s, cfg)
        return s

    flag = buckling_config()
    configs = [
        ("flagship", flag, lambda: buckling_scene(flag, seed=0, device=home), CARDS_STEPS),
        ("128", scaled_buckling_config(RES_128),
         lambda: buckling_scene(scaled_buckling_config(RES_128), seed=0, device=home), CARDS_STEPS),
        ("coiling_auto_mg", coiling_config(RES_COIL),
         lambda: dataclasses.replace(warmed(coiling_config(RES_COIL), coiling_scene(coiling_config(RES_COIL), seed=0,
                                                                                     device=home), 2), visc_mg=2),
         CARDS_STEPS),
        ("flagship_nojac", with_solver(flag, jacobi_precond=False),
         lambda: buckling_scene(flag, seed=0, device=home), CARDS_STEPS),
        ("coil_504_lean", coiling_config(RES_504),
         lambda: dataclasses.replace(warmed(coiling_config(RES_504), coiling_scene(coiling_config(RES_504), seed=0,
                                                                                    device=home), 2), visc_mg=2), 1),
    ]
    rows = {}
    for label, cfg, make, steps in configs:
        s0 = state_on(make(), home)  # both cards start from the same host copy
        t0 = time.perf_counter()
        eager0, replay0, ms0 = one_card_runs(label, cfg, s0, steps)
        with launch_devices() as seen:
            eager1, replay1, ms1 = one_card_runs(label, cfg, state_on(s0, other), steps)
        cards = by_card(seen)
        if set(cards) != {str(other)} and other != home:
            raise AssertionError(f"{label} on {other}: launches on {sorted(cards)}")
        missing = [k for k in CARDS_PATH1_NEEDS[label] if not cards.get(str(other), {}).get(k)]
        if missing:
            raise AssertionError(f"{label} on {other}: {missing} never launched there")
        for i in range(1, steps + 1):
            for kind, a, b in (("eager", eager0, eager1), ("replayed", replay0, replay1)):
                bad = cpu_bits_differ(a[i], b[i])
                if bad:
                    raise AssertionError(f"{label} {kind} step {i - 1}: {other} differs from cuda:0 in {bad}")
        rows[label] = dict(steps=steps, launches_by_card=cards, eager_ms_cuda0=ms0, eager_ms_other=ms1,
                           bitwise_cuda0_eager_and_replayed=True, replay_bitwise_eager=True,
                           seconds=time.perf_counter() - t0)
        del s0, eager0, replay0, eager1, replay1
        torch.cuda.empty_cache()

    # row 15: the pull over 4 slots of the other card, bitwise its plain
    # version and the same exchange on cuda:0
    gen = torch.Generator(device=home).manual_seed(0)
    shape = (_padded_extent(126, MESH_SLOTS) // MESH_SLOTS, 504, 126)
    blocks0 = [torch.randn(shape, generator=gen, device=home) for _ in range(MESH_SLOTS)]
    outs = {}
    with launch_devices() as seen:
        for dev in (home, other):
            mesh = make_mesh(MESH_SLOTS, device=dev)
            blocks = [b.to(dev) for b in blocks0]
            got = halo_rdma.halo_exchange_rdma(mesh, blocks, "x")
            want = halo_rdma.halo_exchange_rdma_plain(mesh, blocks, "x")
            if not all(bits_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"halo pull on {dev}: differs from its plain version")
            outs[str(dev)] = [g.cpu() for g in got]
    if not all(bits_equal(a, b) for a, b in zip(outs[str(home)], outs[str(other)])):
        raise AssertionError(f"halo pull: {other} differs from cuda:0")
    rows["halo_pull"] = dict(block=list(shape), slots=MESH_SLOTS, launches_by_card=by_card(seen),
                             bitwise_plain_and_cuda0=True)
    del blocks0, blocks, got, want, outs

    # row 10: a WIDE_CHANNELS-channel reduce of sorted ids through the dense
    # segment_reduce (the serial kernel), add and min
    k, m = 200_000, FLAGSHIP[0][0] * FLAGSHIP[0][1] * FLAGSHIP[0][2]
    ids0 = torch.sort(torch.randint(0, m, (k,), generator=gen, device=home)).values
    vals0 = torch.randn((k, WIDE_CHANNELS), generator=gen, device=home)
    res = {}
    with launch_devices() as seen:
        for dev in (home, other):
            ids, vals = ids0.to(dev), vals0.to(dev)
            for op in ("add", "min"):
                got = cbn.segment_reduce(vals, ids, m, op, 0.0, channels_first=True)
                if op == "min" and not bits_equal(got, cbn.segment_reduce_plain(vals, ids, m, op, 0.0,
                                                                                channels_first=True)):
                    raise AssertionError(f"wide min reduce on {dev}: differs from its plain version")
                res[(str(dev), op)] = got.cpu()
    for op in ("add", "min"):
        if not bits_equal(res[(str(home), op)], res[(str(other), op)]):
            raise AssertionError(f"wide {op} reduce: {other} differs from cuda:0")
    rows["wide_reduce"] = dict(K=k, C=WIDE_CHANNELS, M=m, launches_by_card=by_card(seen),
                               min_bitwise_plain=True, bitwise_cuda0=True)
    del ids0, vals0, res
    for label in ("halo_pull", "wide_reduce"):
        got = rows[label]["launches_by_card"]
        if set(got) != {str(home), str(other)} or not all(got[str(other)].get(n) for n in CARDS_PATH1_NEEDS[label]):
            raise AssertionError(f"{label}: launches {got}")
    torch.cuda.empty_cache()
    return rows


def profiled_idle(step, state):
    """One step under torch.profiler: the host ms, each card's busy ms
    (the union of its kernel and copy intervals; also without the
    kernels that spin on other cards, `SPIN_KERNELS`) and idle share, and
    the copies a step by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from python_fluid_simulation_tpu_torch.profile_step import _busy_us

    sync_all()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state)
        sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("pfs_")]
    if not dev_events:
        raise AssertionError("the profiler saw no device event")
    cards = {}
    for idx in sorted({e.device_index for e in dev_events}):
        on_card = [e for e in dev_events if e.device_index == idx]
        busy = _busy_us(on_card) / 1e3
        # the kernels that wait for other cards (the push, the cross-card
        # sum) are busy while they spin on launches the host has not made yet
        working = [e for e in on_card if not any(k in e.name for k in SPIN_KERNELS)]
        cards[f"cuda:{idx}"] = dict(busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                                    busy_ms_without_spins=_busy_us(working) / 1e3)
    copies = collections.Counter(e.name for e in dev_events if e.name.startswith("Memcpy"))
    iters = sum(int(m[f"{k}_iters"]) for k in ("density", "viscosity", "pressure"))
    return dict(step_ms=wall_ms, cards=cards, idle_share_mean=statistics.mean(c["idle_share"] for c in cards.values()),
                copies_per_step=dict(copies), solver_iterations=iters,
                copies_per_iteration=sum(copies.values()) / max(iters, 1))


def cards_mesh_run(label, cfg, s0, meshes, bucketed, steps, ref_states, unet=None, replays=None, simulate_calls=False):
    """Path 2, one configuration: `steps` eager steps of ``step_3d(mesh=,
    bucketed=)`` from `s0` (masses unique) with slot i on cuda:i, bitwise
    the same steps on the same mesh layout with every slot on cuda:0 and
    the same steps on the cards with every kernel swapped for its plain
    version; within MESH_DX / MESH_DV of `ref_states` by mass;
    ``bucket_lost`` 0; the routes: every ring across cards pushes, no pull
    on the cards.  Then one more step profiled: each card's idle share and
    the copies a step and an iteration.  Then the same configuration
    through ``make_step(mesh=<cards>)`` (`cards_replayed`: `replays` of
    the first eager steps, default all), and with ``simulate_calls`` two
    ``simulate(mesh=<cards>)`` calls of `steps` steps, one capture, the
    first bitwise the eager steps."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step import step_3d
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.mesh import shard_state
    from python_fluid_simulation_tpu_torch.profile_step import bucketed_particles

    cards_mesh, one_mesh = meshes
    n = int(s0.particles.x.shape[0])

    def start_on(mesh):
        start = shard_state(s0, mesh)
        if bucketed:
            start = dataclasses.replace(start, particles=bucketed_particles(start, cfg, mesh)[1])
        return start

    def run(mesh, start):
        step = functools.partial(step_3d, mesh=mesh, bucketed=bucketed, unet=unet)
        states, ms, metrics = [start], [], []
        for _ in range(steps):
            sync_all()
            t0 = time.perf_counter()
            st, m = step(states[-1], cfg)
            sync_all()
            ms.append((time.perf_counter() - t0) * 1e3)
            states.append(st)
            metrics.append(m)
        return step, states, ms, metrics

    routes = {ax: halo_rdma.halo_route(cards_mesh, ax) for ax in cards_mesh.axis_names}
    start = start_on(cards_mesh)
    read = reset_counters()
    with launch_devices() as seen:
        step, states, ms, raw_metrics = run(cards_mesh, start)
    launches = read()
    metrics = [{k: v.item() for k, v in m.items()} for m in raw_metrics]
    check_run(states[-1], metrics, launches, ("halo_exchange_push", "mesh_psum", *REDUCE_ROUTE,
                                              "binned_segment_broadcast", "fold"), label)
    cards = by_card(seen)
    pulls = {d: c.get("halo_exchange_rdma", 0) for d, c in cards.items() if c.get("halo_exchange_rdma")}
    pushes = {d: c.get("halo_exchange_push", 0) for d, c in cards.items()}
    if routes["x"] != "push" or pulls or launches["halo_exchange_rdma"] or len(set(pushes.values())) != 1:
        raise AssertionError(f"{label}: routes {routes}, pulls {pulls}, pushes by card {pushes}")
    lost = [m["bucket_lost"] for m in metrics] if bucketed else []
    if any(lost):
        raise AssertionError(f"{label}: bucket_lost {lost}")
    _, one, one_ms, _ = run(one_mesh, start_on(one_mesh))
    for i in range(1, steps + 1):
        bad = [k for k in "xvcm" if not same_bits(getattr(states[i].particles, k), getattr(one[i].particles, k))]
        if bad:
            raise AssertionError(f"{label} step {i - 1}: four cards vs one card differ in {bad}")
    del one
    plain_steps_bitwise(label, step, start, states, cfg, None, steps)
    errs = vs_unsharded(label, states, ref_states, n)
    profile = profiled_idle(lambda s: step(s, cfg), states[-1])
    row = dict(mesh=cards_mesh.shape, devices=[str(d) for d in cards_mesh.devices], bucketed=bucketed, steps=steps,
               step_ms=ms, median_step_ms=statistics.median(ms), one_card_step_ms=one_ms, routes=routes,
               push_launches_per_step=launches["halo_exchange_push"] / steps,
               psum_launches_per_step=launches["mesh_psum"] / steps, launches_by_card=cards,
               iters={k: [m[f"{k}_iters"] for m in metrics] for k in ("density", "viscosity", "pressure")},
               bucket_lost=lost, bitwise_one_card=True, kernels_vs_plain_bitwise=True, vs_unsharded_by_step=errs,
               profiled_step=profile)
    n = steps if replays is None else replays
    row["replayed"] = cards_replayed(label, cfg, start, cards_mesh, bucketed, states[:n + 1], raw_metrics[:n], unet,
                                     profile)
    if simulate_calls:
        row["simulate"] = cards_simulate(label, cfg, start, cards_mesh, bucketed, states, steps)
    del states, start
    torch.cuda.empty_cache()
    return row


def cards_replayed(label, cfg, start, mesh, bucketed, eager, eager_metrics, unet, eager_profile):
    """``make_step(cfg, mesh=<the cards>, bucketed=)`` from `start`: the
    first call captures (one graph over the cards, launched on cuda:0,
    each distributed solve one WHILE node a card), then one replay for
    each eager step in `eager` (the four-card ``step_3d`` states from
    `start`, `eager_metrics` theirs), each from the eager state before it:
    bitwise the eager step (particles, t, step_idx, visc_mg, every
    metric), no host sync in a replay (``set_sync_debug_mode("error")``),
    no wrapper launch, and every card's iteration count of each solve
    (the replicas of k the captured loops carry, read after the replay)
    equal, and equal to the step's metric.  Returns the row: eager and
    replayed ms a step, each card's idle share in a replay (the eager
    step's profiled busy ms of the card over the replayed ms; the
    profiler reports no kernel of a WHILE body), capture seconds, pool
    bytes, top-level nodes, WHILE nodes and their bodies' nodes."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step import make_step
    from python_fluid_simulation_tpu_torch.ops.cuda_graph import captured_while
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.solvers import cg

    carried = []
    real = cg.loop

    def recording(carry, thresh, max_iter, iteration):  # a mesh step's loops are its distributed solves'
        out = real(carry, thresh, max_iter, iteration)
        carried.append(out.k)
        return out

    step = make_step(cfg, unet=unet, mesh=mesh, bucketed=bucketed)
    nodes0 = captured_while.nodes
    cg.loop = recording
    try:
        _, capture_event_ms, capture_host_ms = event_timed(lambda: step(start))
    finally:
        cg.loop = real
    sync_all()
    order = [s for s in ("density", "viscosity", "pressure") if s in mesh_solves(cfg)]
    ks = dict(zip(order, carried[-len(order):]))  # the captured loops' (the warm-up's eager ones come first)
    cards = halo_rdma.replica_devices(mesh)
    rep = next(iter(step.replayers.values()))
    cap = rep.captured[None]
    while_nodes = captured_while.nodes - nodes0
    if while_nodes != len(order) * len(cards) or len(cap.loop_nodes) != while_nodes or any(
            [k.device for k in kk] != cards for kk in ks.values()):
        raise AssertionError(f"{label}: {while_nodes} WHILE nodes, bodies {cap.loop_nodes}, for {order} over {cards}")
    read = reset_counters()
    ms, host_ms, iters = [], [], []
    for i in range(len(eager_metrics)):
        (st, m), e_ms, h_ms = event_timed(lambda: step(eager[i]), sync_error=True)
        sync_all()
        ms.append(e_ms)
        host_ms.append(h_ms)
        bad = state_differences(eager[i + 1], st, solid=cfg.moving_solid) + metric_differences(eager_metrics[i], m)
        if bad:
            raise AssertionError(f"{label} replay {i}: differs from the eager four-card step in {bad}")
        by_solve = {s: [int(k) for k in ks[s]] for s in order}
        if any(len(set(v)) != 1 or v[0] != int(m[f"{s}_iters"]) for s, v in by_solve.items()):
            raise AssertionError(f"{label} replay {i}: iterations by card {by_solve}, metrics "
                                 f"{[int(m[f'{s}_iters']) for s in order]}")
        iters.append(by_solve)
    launched = read()
    if any(launched.values()):
        raise AssertionError(f"{label}: wrapper launches during the replays {launched}")
    median = statistics.median(ms)
    busy = {d: c["busy_ms_without_spins"] for d, c in eager_profile["cards"].items()}
    out = dict(replays=len(ms), bitwise_the_eager_four_card_step=True, sync_debug_mode_error=True,
               replayed_ms=ms, replayed_host_ms=host_ms, median_replayed_ms=median,
               iters_by_card=iters,
               idle_share_by_card={d: 1.0 - b / median for d, b in busy.items()},
               idle_share_from="1 - each card's busy ms in the profiled eager step, the spinning kernels left out "
                               "(SPIN_KERNELS), over the median replayed ms",
               capture_seconds=cap.seconds, capture_call_event_ms=capture_event_ms,
               capture_call_host_ms=capture_host_ms, graph_pool_bytes=cap.pool_bytes, graph_nodes=cap.nodes,
               while_nodes=while_nodes, loop_body_nodes=list(cap.loop_nodes))
    del step, rep, cap
    torch.cuda.empty_cache()
    return out


def cards_simulate(label, cfg, start, mesh, bucketed, eager, steps):
    """``simulate(mesh=<the cards>, bucketed=)`` twice from `start`, `steps`
    steps a call: one capture by one replayer, the first call's state
    bitwise the eager four-card steps', ``bucket_lost`` 0."""
    import torch

    from python_fluid_simulation_tpu_torch.engine.step import simulate

    held = simulate.capture
    held.clear()
    captures, replayers = held.captures, held.replayers
    sync_all()
    t0 = time.perf_counter()
    first, _ = simulate(start, cfg, steps, mesh=mesh, bucketed=bucketed)
    sync_all()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, m2 = simulate(first, cfg, steps, mesh=mesh, bucketed=bucketed)
    sync_all()
    second_s = time.perf_counter() - t0
    bad = state_differences(eager[steps], first)
    made = (held.captures - captures, held.replayers - replayers)
    lost = [int(v) for v in m2["bucket_lost"]] if bucketed else []
    if bad or made != (1, 1) or any(lost):
        raise AssertionError(f"{label} simulate(mesh=<cards>): differs from the eager steps in {bad}; {made[0]} "
                             f"captures by {made[1]} replayers; lost {lost}")
    out = dict(calls=2, steps_per_call=steps, captures=1, first_call_s=first_s, second_call_s=second_s,
               second_call_ms_per_step=second_s / steps * 1e3, bitwise_the_eager_steps=True,
               capture_seconds=held.replayer.captured[None].seconds)
    held.clear()
    torch.cuda.empty_cache()
    return out


def cards_cli(tmp):
    """``run.main --scene buckling --mesh 4 [--bucketed]`` on a host of
    four cards: the run prints the cards' layout (slot i on cuda:i), takes
    `CARDS_CLI_STEPS` steps in blocks of `CARDS_CLI_BLOCK` with one
    capture, and a run resumed from the first block's checkpoint ends
    bitwise the uninterrupted run, with one capture."""
    import shutil

    from python_fluid_simulation_tpu_torch.engine.step import simulate

    out = {}
    for bucketed in (False, True):
        key = "bucketed" if bucketed else "sharded"
        full, resumed, mid = (os.path.join(tmp, f"{key}_{n}") for n in ("full", "resumed", "from_mid"))
        flags = ["--scene", "buckling", "--mesh", str(CARDS), *(["--bucketed"] if bucketed else []),
                 "--max-steps", str(CARDS_CLI_STEPS), "--block", str(CARDS_CLI_BLOCK),
                 "--checkpoint-every", str(CARDS_CLI_BLOCK)]
        seconds, rate, text, captures, replayers = run_cli([*flags, "--out", full, "--metrics"])
        with open(os.path.join(full, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        layout = f"{CARDS} cards (cuda:0..cuda:{CARDS - 1})"
        if (captures, replayers) != (1, 1) or layout not in text or len(recs) != CARDS_CLI_STEPS or (
                bucketed and any(r["bucket_lost"] for r in recs)):
            raise AssertionError(f"cli --mesh {CARDS} {key}: {captures} captures by {replayers} replayers, "
                                 f"{len(recs)} steps logged, layout line present: {layout in text}")
        capture_s = simulate.capture.replayer.captured[None].seconds
        os.makedirs(mid)
        for name in ("config.json", f"state_{CARDS_CLI_BLOCK}.npz"):
            shutil.copy(os.path.join(full, "ckpt", name), os.path.join(mid, name))
        r_seconds, r_rate, _, r_captures, r_replayers = run_cli([*flags, "--out", resumed, "--resume", mid])
        want = npz_leaves(os.path.join(full, "ckpt", f"state_{CARDS_CLI_STEPS}.npz"))
        got = npz_leaves(os.path.join(resumed, "ckpt", f"state_{CARDS_CLI_STEPS}.npz"))
        differ = [i for i, (a, b) in enumerate(zip(got, want)) if a.dtype != b.dtype or a.tobytes() != b.tobytes()]
        if differ or (r_captures, r_replayers) != (1, 1):
            raise AssertionError(f"cli --mesh {CARDS} {key} resumed: leaves {differ} differ; {r_captures} captures")
        out[key] = dict(layout=layout, steps=CARDS_CLI_STEPS, block=CARDS_CLI_BLOCK, seconds=seconds,
                        cli_steps_per_s=rate, captures=captures, capture_seconds=capture_s,
                        iters=[[r[f"{k}_iters"] for k in ("density", "viscosity", "pressure")] for r in recs],
                        resume=dict(from_step=CARDS_CLI_BLOCK, seconds=r_seconds, cli_steps_per_s=r_rate,
                                    captures=r_captures, bitwise_the_uninterrupted_run=True))
        simulate.capture.clear()
    return out


def cards_path2(unet_sd):
    """Path 2 on four cards (`cards_mesh_run` each, eager and through
    ``make_step(mesh=<four cards>)``): the flagship sharded and bucketed on
    4 slots and (2, 2) (the bucketed ×4 also through two ``simulate``
    calls), ``coiling_config(504)`` and ``scaled_buckling_config(128)``
    (held to the unsharded step with the Jacobi preconditioners) sharded
    on 4 slots, the flagship in
    'unet_warm' bucketed on (2, 2) with the full-width UNet, the moving box
    (``moving_box_config(1/64)``) sharded on 4 slots; then the CLI with
    ``--mesh 4`` and ``--mesh 4 --bucketed`` over the cards."""
    import tempfile

    import torch

    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        moving_box_config,
        moving_box_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D
    from python_fluid_simulation_tpu_torch.parallel.mesh import cuda_devices, make_mesh, make_mesh2d

    cards = cuda_devices(CARDS)
    meshes = {"4": (make_mesh(CARDS, devices=cards), make_mesh(CARDS)),
              "2x2": (make_mesh2d(BUCKET_2D, devices=cards), make_mesh2d(BUCKET_2D))}
    rows = {}

    def unsharded(cfg, s0, steps, unet=None):
        geom = build_geom_cache(s0.solid)
        ref = [s0]
        for _ in range(steps):
            ref.append(step_3d(ref[-1], cfg, geom=geom, unet=unet)[0])
        return ref

    cfg = buckling_config()
    s0 = unique_masses(buckling_scene(cfg, seed=0, device="cuda:0"))
    ref = unsharded(cfg, s0, CARDS_STEPS)
    for bucketed in (False, True):
        for name, pair in meshes.items():
            label = f"flagship_{'bucketed' if bucketed else 'sharded'}_{name}"
            rows[label] = cards_mesh_run(label, cfg, s0, pair, bucketed, CARDS_STEPS, ref,
                                         simulate_calls=bucketed and name == "4")

    cfg_w = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_mode="unet_warm"))
    unet = UNet3D(width=UNET_WIDTH).eval()
    unet.load_state_dict(unet_sd)
    unet = unet.to("cuda:0")
    ref = unsharded(cfg_w, s0, CARDS_STEPS, unet)
    rows["flagship_unet_warm_bucketed_2x2"] = cards_mesh_run("flagship unet_warm bucketed 2x2", cfg_w, s0,
                                                             meshes["2x2"], True, CARDS_STEPS, ref, unet=unet)
    del unet, ref, s0
    torch.cuda.empty_cache()

    cfg504 = coiling_config(RES_504)
    s504 = unique_masses(coiling_scene(cfg504, seed=0, device="cuda:0"))
    ref = unsharded(cfg504, s504, CARDS_504_STEPS)
    rows["coil_504_sharded_4"] = cards_mesh_run("504 sharded 4", cfg504, s504, meshes["4"], False, CARDS_504_STEPS,
                                                ref)
    del ref, s504
    torch.cuda.empty_cache()

    cfg128 = scaled_buckling_config(RES_128)
    s128 = unique_masses(buckling_scene(cfg128, seed=0, device="cuda:0"))
    ref = unsharded(jacobi_solves(cfg128), s128, CARDS_STEPS)
    rows["128_sharded_4"] = cards_mesh_run("128^3 sharded 4", cfg128, s128, meshes["4"], False, CARDS_STEPS, ref)
    del ref, s128
    torch.cuda.empty_cache()

    cfg_mb = moving_box_config(dx=CARDS_MOVING_DX)
    s_mb = unique_masses(moving_box_scene(cfg_mb, seed=0, device="cuda:0"))
    ref = unsharded(cfg_mb, s_mb, CARDS_STEPS)
    rows["moving_box_sharded_4"] = cards_mesh_run("moving box sharded 4", cfg_mb, s_mb, meshes["4"], False,
                                                  CARDS_STEPS, ref)
    del ref, s_mb
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        rows["cli"] = cards_cli(tmp)
    return rows


def cards_halo():
    """Row 15's push across cards: at every field of `HALO_FIELDS`, on 2
    and 4 cards (slot i on cuda:i), `CARDS_HALO_REPS` exchanges with
    changing contents through ``halo.halo_exchange`` (the push: the rings
    span cards), bitwise the plain route; CUDA-event and device ms beside
    the same exchange on one card (the push called directly, and the
    pull), the computed NVLink plane bound and the same-card byte bound."""
    import torch

    from python_fluid_simulation_tpu_torch.parallel import halo, halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.halo import _padded_extent
    from python_fluid_simulation_tpu_torch.parallel.mesh import cuda_devices, make_mesh

    gen = torch.Generator(device="cuda:0").manual_seed(0)
    rows = []
    for slots in CARDS_HALO_SLOTS:
        across = make_mesh(slots, devices=cuda_devices(slots))
        one = make_mesh(slots, device="cuda:0")
        if halo_rdma.halo_route(across, "x") != "push" or halo_rdma.halo_route(one, "x") != "pull":
            raise AssertionError(f"halo routes over {slots} slots")
        timed = {}
        for name, shape in HALO_FIELDS:
            n = _padded_extent(shape[0], slots) // slots
            bshape = (n,) + shape[1:]
            plane = math.prod(bshape[1:])
            base = [torch.randn(bshape, generator=gen, device="cuda:0") for _ in range(slots)]
            b_across = [b.to(d) for b, d in zip(base, across.devices)]
            before = halo_rdma.halo_exchange_push.launches
            bad = 0
            for _ in range(CARDS_HALO_REPS):
                for b in (*base, *b_across):
                    b.add_(1.0)
                got = halo.halo_exchange(across, b_across, "x")
                want = halo_rdma.halo_exchange_rdma_plain(one, base, "x")
                bad += sum(int((g.to(w.device) != w).sum()) for g, w in zip(got, want))
            launched = halo_rdma.halo_exchange_push.launches - before
            if bad or launched != CARDS_HALO_REPS * slots:
                raise AssertionError(f"push across {slots} cards, {name}: {bad} elements differ, {launched} launches")
            calls = {
                "push_across_cards": functools.partial(halo.halo_exchange, across, b_across, "x"),
                "push_one_card": functools.partial(halo_rdma.halo_exchange_push, one, base, "x"),
                "pull_one_card": functools.partial(halo.halo_exchange, one, base, "x"),
            }
            row = dict(field=name, global_shape=list(shape), slots=slots, block=list(bshape), exchanges=CARDS_HALO_REPS,
                       mismatched_elements=0, **bound(halo_rdma.halo_bytes(slots, n, plane), 0),
                       nvlink_plane_bytes=plane * 4, nvlink_bound_ms=plane * 4 / NVLINK_BYTES_PER_S * 1e3,
                       ms={k: cuda_time_ms(f, HALO_TIMED) for k, f in calls.items()})
            for k, f in calls.items():
                timed[(name, k)] = f
            rows.append(row)
        for (name, k), ms in device_times(timed, HALO_TIMED).items():
            row = next(r for r in rows if r["slots"] == slots and r["field"] == name)
            row.setdefault("device_ms", {})[k] = ms
        del timed, base, b_across
        torch.cuda.empty_cache()
    return rows


def cards_psum():
    """The cross-card sum over 2 and 4 cards (slot i on cuda:i, one launch
    a card on its current stream), 1, 2 and 3 dots: `PSUM_REPS` calls with
    changing partials each bitwise the plain slot-order sum on every
    card; CUDA-event ms a call eagerly (host-bound: one launch a card) and
    replayed, `PSUM_TIMED` calls back to back in one graph over the cards
    (``graph_capture``), timed by CUDA events on cuda:0: the device's ms an
    all-reduce, beside the NVLink bound of the bytes it sends."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_graph import graph_capture
    from python_fluid_simulation_tpu_torch.parallel import halo_rdma
    from python_fluid_simulation_tpu_torch.parallel.mesh import cuda_devices, make_mesh

    rows = []
    for slots in (2, CARDS):
        cards = cuda_devices(slots)
        mesh = make_mesh(slots, devices=cards)
        for dots in (1, 2, 3):
            gen = torch.Generator(device="cuda:0").manual_seed(slots * 10 + dots)
            parts = [tuple(torch.randn((), generator=gen, device="cuda:0").to(d) for _ in range(dots)) for d in cards]
            bad = 0
            for _ in range(PSUM_REPS):
                for p in parts:
                    for t in p:
                        t.mul_(1.0001).add_(0.5)
                got = halo_rdma.mesh_psum(mesh, parts)
                want = halo_rdma.mesh_psum_plain(mesh, parts)
                bad += sum(int((r.view(torch.int32) != w.view(torch.int32).to(r.device)).sum())
                           for g, ws in zip(got, want) for r, w in zip(g, ws))
            if bad:
                raise AssertionError(f"mesh_psum over {slots} cards, {dots} dots: {bad} replicas differ")
            sync_all()
            graph = torch.cuda.CUDAGraph()
            with graph_capture(graph, cards[0], cards, capture_error_mode="thread_local") as pools:
                for _ in range(PSUM_TIMED):
                    halo_rdma.mesh_psum(mesh, parts)
            graph.replay()
            sync_all()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            sync_all()
            nbytes = slots * (slots - 1) * (dots + 1) * 4  # the partials and an arrival to every other card
            rows.append(dict(cards=slots, dots=dots, calls=PSUM_REPS, bitwise_plain=True,
                             eager_ms=cuda_time_ms(lambda: halo_rdma.mesh_psum(mesh, parts), PSUM_TIMED),
                             replayed_ms=start.elapsed_time(stop) / PSUM_TIMED, nvlink_bytes=nbytes,
                             nvlink_bound_ms=nbytes / slots / NVLINK_BYTES_PER_S * 1e3))
            del graph, pools
    return rows


# A graph over the cards with one WHILE node a card and a trivial body,
# built from this source alone (no kernel of the port): the profiler's
# illegal address on a replay over the cards, reproduced (profiler_repro).
WHILE_REPRO_CU = r"""
#include <cuda_runtime.h>
__global__ void repro_test(cudaGraphConditionalHandle h, int* k, int n, int step) {
  const int kk = *k + step;
  if (step) *k = kk;
  cudaGraphSetConditional(h, kk < n ? 1u : 0u);
}
__global__ void repro_body(int* x) { x[threadIdx.x] += 1; }
extern "C" int repro_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) { cudaGetLastError(); e = cudaSuccess; }
  return e;
}
extern "C" int repro_body_launch(void* stream, void* x) {
  repro_body<<<1, 32, 0, (cudaStream_t)stream>>>((int*)x);
  return cudaGetLastError();
}
// a WHILE node after the first test on `stream`; its body is then captured on body_stream
extern "C" int repro_while_begin(void* stream, void* body_stream, void* k, int n, unsigned long long* hout) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus st; cudaGraph_t g; const cudaGraphNode_t* deps; size_t nd;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &st, nullptr, &g, &deps, &nd);
  if (e) return e;
  cudaGraphConditionalHandle h;
  if ((e = cudaGraphConditionalHandleCreate(&h, g, 0, 0))) return e;
  repro_test<<<1, 1, 0, s>>>(h, (int*)k, n, 0);
  if ((e = cudaGetLastError())) return e;
  if ((e = cudaStreamGetCaptureInfo(s, &st, nullptr, &g, &deps, &nd))) return e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h; p.conditional.type = cudaGraphCondTypeWhile; p.conditional.size = 1;
  cudaGraphNode_t node;
  if ((e = cudaGraphAddNode(&node, g, deps, nd, &p))) return e;
  if ((e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies))) return e;
  if ((e = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, p.conditional.phGraph_out[0], nullptr, nullptr,
                                         0, cudaStreamCaptureModeThreadLocal))) return e;
  *hout = h;
  return 0;
}
extern "C" int repro_while_end(void* body_stream, unsigned long long h, void* k, int n) {
  cudaStream_t s = (cudaStream_t)body_stream;
  repro_test<<<1, 1, 0, s>>>((cudaGraphConditionalHandle)h, (int*)k, n, 1);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t e2 = cudaStreamEndCapture(s, &body);
  return e ? e : e2;
}
"""
# (cards, WHILE nodes, a profiler session before the graph is made)
WHILE_REPRO_CASES = ((2, True, False), (2, True, True), (2, False, True), (1, True, True))
WHILE_REPRO_ITERS = 5


def while_repro_library() -> str:
    """The repro's source compiled once (nvcc, sm_90a) into the port's
    build directory; returns the library's path."""
    import hashlib

    from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb

    key = hashlib.sha256((WHILE_REPRO_CU + " ".join(cb.ARCH_FLAGS)).encode()).hexdigest()[:16]
    out = os.path.join(os.path.dirname(cb.__file__), os.pardir, "_build", f"while_repro_{key}.so")
    out = os.path.normpath(out)
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        src = out[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(WHILE_REPRO_CU)
        subprocess.run([cb._nvcc(), *cb.ARCH_FLAGS, "-O2", "-shared", "-Xcompiler", "-fPIC", src, "-o", out + ".tmp"],
                       check=True, capture_output=True)
        os.replace(out + ".tmp", out)
    return out


def while_repro_run(cards: int, whiles: bool, profiled_before: bool) -> dict:
    """One graph over `cards` cards (the capture on cuda:0, every other
    card's stream forked from it): on each card a counter kernel, inside
    one WHILE node of WHILE_REPRO_ITERS iterations where `whiles`. With
    `profiled_before` a profiler session (one kernel a card) runs before
    the graph is made. Then one replay unprofiled and one under
    torch.profiler (CPU and CUDA activities, as `profiled_idle`), each
    from zeroed counters, every card synchronised; returns the counts
    and the profile's device events."""
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    lib = ctypes.CDLL(while_repro_library())
    devs = [torch.device("cuda", i) for i in range(cards)]
    if profiled_before:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for d in devs:
                torch.ones(1000, device=d).sum().item()
    for i in range(cards):
        with torch.cuda.device(i):
            for j in range(cards):
                if j != i and lib.repro_peer(j):
                    raise RuntimeError(f"peer access cuda:{i} -> cuda:{j}")
    k = [torch.zeros((), dtype=torch.int32, device=d) for d in devs]
    x = [torch.zeros(32, dtype=torch.int32, device=d) for d in devs]
    cap = [torch.cuda.Stream(device=d) for d in devs]
    body = [torch.cuda.Stream(device=d) for d in devs]
    ptr = ctypes.c_void_p
    sync = lambda: [torch.cuda.synchronize(d) for d in devs]  # noqa: E731
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(0), torch.cuda.graph(graph, stream=cap[0]):
        fork = torch.cuda.Event()
        fork.record(cap[0])
        for st in cap[1:]:
            st.wait_event(fork)
        for i, d in enumerate(devs):
            with torch.cuda.device(d):
                if whiles:
                    h = ctypes.c_ulonglong(0)
                    if lib.repro_while_begin(ptr(cap[i].cuda_stream), ptr(body[i].cuda_stream), ptr(k[i].data_ptr()),
                                             WHILE_REPRO_ITERS, ctypes.byref(h)):
                        raise RuntimeError("WHILE node")
                    lib.repro_body_launch(ptr(body[i].cuda_stream), ptr(x[i].data_ptr()))
                    if lib.repro_while_end(ptr(body[i].cuda_stream), h, ptr(k[i].data_ptr()), WHILE_REPRO_ITERS):
                        raise RuntimeError("WHILE body")
                elif lib.repro_body_launch(ptr(cap[i].cuda_stream), ptr(x[i].data_ptr())):
                    raise RuntimeError("body launch")
        for st in cap[1:]:
            done = torch.cuda.Event()
            done.record(st)
            cap[0].wait_event(done)

    def replay():
        for t in (*k, *x):
            t.zero_()
        sync()
        graph.replay()
        sync()
        return [int(t[0]) for t in x]

    want = [WHILE_REPRO_ITERS if whiles else 1] * cards
    unprofiled = replay()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = replay()
    kernels = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name.startswith("repro_")})
    return dict(unprofiled_counts=unprofiled, profiled_counts=profiled, right=unprofiled == profiled == want,
                profiled_kernels=kernels)


def profiler_repro_phase() -> list:
    """Each of WHILE_REPRO_CASES in a process of its own (a fault ends
    the CUDA context): its exit code, the result, and the CUDA error it
    printed. The case without an earlier profiler session must profile
    its replay with the right counts; the others are reported."""
    rows = []
    while_repro_library()  # built once, before the children start
    for cards, whiles, before in WHILE_REPRO_CASES:
        code = ("import json, chip_smoke; "
                f"print(json.dumps(chip_smoke.while_repro_run({cards}, {whiles}, {before})), flush=True)")
        t = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                               capture_output=True, text=True, timeout=180)
            rc, out, err = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        result = next((json.loads(ln) for ln in reversed(str(out).splitlines()) if ln.startswith("{")), None)
        error = next((ln.strip() for ln in str(err).splitlines() if "CUDA error" in ln or "Error" in ln), None)
        row = dict(cards=cards, while_nodes=whiles, profiler_session_before=before, rc=rc, result=result,
                   error=error, seconds=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps({"profiler_repro": row}), flush=True)
        if not before and not (rc == 0 and result and result["right"]):
            raise AssertionError(f"profiler repro, no earlier session: {row}")
    return rows


def cards_phase(unet_sd):
    """The port on four cards: every card's nvidia-smi line, path 2
    across the four cards (eager, captured, simulate, the CLI), row 15's
    push and the cross-card sum timed across cards, path 1 on cuda:3.
    Returns the phase's JSON."""
    import torch

    t0 = time.perf_counter()
    smi = all_nvidia_smi_lines()
    for ln in smi:
        print(ln, flush=True)
    other = torch.device("cuda", CARDS - 1)
    out = {"phase": "cards", "nvidia_smi": smi, "count": torch.cuda.device_count()}
    t = time.perf_counter()
    out["path2"] = dict(runs=cards_path2(unet_sd), seconds=time.perf_counter() - t)
    print(json.dumps({"cards_path2": out["path2"]}), flush=True)  # the longest part, kept if a later one fails
    t = time.perf_counter()
    out["halo"] = dict(rows=cards_halo(), seconds=time.perf_counter() - t)
    t = time.perf_counter()
    out["psum"] = dict(rows=cards_psum(), seconds=time.perf_counter() - t)
    t = time.perf_counter()
    out["path1"] = dict(card=str(other), runs=cards_path1(other), seconds=time.perf_counter() - t)
    t = time.perf_counter()
    out["profiler_repro"] = dict(cases=profiler_repro_phase(), seconds=time.perf_counter() - t)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=()) -> int:
    import torch

    cards_only = "--cards" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script only runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.ops import _cuda_build
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import stencil_matvec
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, shard_state
    from python_fluid_simulation_tpu_torch.profile_step import profile_steps
    from python_fluid_simulation_tpu_torch.solvers import pressure

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # -- device
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    # -- build: every csrc/*.cu compiled in parallel, one link
    t0 = time.perf_counter()
    info = _cuda_build.build()
    _cuda_build.LIB.get()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "ptxas info" in ln and ("registers" in ln or "Compiling entry" in ln or "spill" in ln)
             or "bytes stack frame" in ln]
    emit({"phase": "build", "nvcc_seconds": info.seconds, "cached": info.cached,
          "sources": [p.name for p in _cuda_build.sources()], "ptxas": ptxas,
          "redesigned_kernel_resources": kernel_resources(info.log),
          "seconds": time.perf_counter() - t0})

    if "--cpu-root" in argv:  # python3 chip_smoke.py --cpu-root: the card vs CPU steps by the CPU's root
        emit({"phase": "cpu_root", "nvidia_smi": smi, "runs": cpu_root_phase(), "step_tol": STEP_TOL})
        emit({"phase": "done", "seconds": time.perf_counter() - t_all})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return 0

    if cards_only:  # python3 chip_smoke.py --cards: the cards phase alone
        if count < CARDS:
            emit({"phase": "cards", "skipped": f"needs {CARDS} cards, this host has {count}"})
            return 2
        from python_fluid_simulation_tpu_torch.convert import random_flax_unet_params, unet_state_dict_from_flax

        emit(cards_phase(unet_state_dict_from_flax(random_flax_unet_params(UNET_WIDTH, seed=0))))
        emit({"phase": "done", "seconds": time.perf_counter() - t_all})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
        return 0

    # -- kernels on the real systems of a flagship step
    t0 = time.perf_counter()
    cfg = buckling_config()
    state0 = buckling_scene(cfg, seed=0, device="cuda")
    n_particles = int(state0.particles.x.shape[0])
    if (cfg.grid.res, n_particles) != FLAGSHIP:
        raise AssertionError(f"unexpected flagship: grid {cfg.grid.res}, {n_particles} particles")
    geom = build_geom_cache(state0.solid)
    # the first steps start from rest (the viscosity solve exits at once),
    # so the systems are taken from the third step
    state2 = state0
    for _ in range(2):
        state2, _ = step_3d(state2, cfg, geom=geom)
    with recorded_reduces() as reduces, recorded_broadcasts() as broadcasts, recorded_folds() as folds:
        captured = capture_systems(step_3d, state2, cfg, geom)
    del state2
    reduce_sweep = route_sweep("flagship", reduces)  # rows 10 and 11 side by side, printed in kernels_256
    bc_flag_rows = broadcast_phase(broadcasts)
    live_flag_rows = live_reduce_phase(reduces, folds)
    fold_flag_rows = fold_phase(folds)
    del reduces, broadcasts, folds
    if len(captured["cell"]) != 2 or len(captured["coupled"]) != 1:
        raise AssertionError(f"expected 2 cell solves and 1 coupled solve, got {len(captured['cell'])}, {len(captured['coupled'])}")
    cell_rows = cell_kernel_phase(captured["cell"])
    edge_rows = poisson_edge_phase(captured["cell"][1])
    model_rows = list_model_phase(captured["cell"])
    coupled_row = coupled_kernel_phase(captured["coupled"][0])
    del captured
    emit({"phase": "kernels", "cell_poisson_pcg": cell_rows, "poisson_edge_cases": edge_rows,
          "poisson_pcg_vs_model": model_rows, "coupled_visc_pcg": coupled_row, "binned_segment_broadcast": bc_flag_rows,
          "place_live": live_flag_rows, "fold": fold_flag_rows, "seconds": time.perf_counter() - t0})

    # -- flagship main path: launch counts reset just before, read just after
    t0 = time.perf_counter()
    read_counts = reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = {"flagship": {}}  # bytes: the counted steps of the main runs, by configuration
    state, states, step_ms, metrics = run_steps(step_3d, state0, cfg, geom, 11, max(CHECKED_STEPS) + 1,
                                                count=counts["flagship"])
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_run(state, metrics, launches, ("cell_poisson_pcg", "coupled_visc_pcg", *REDUCE_ROUTE,
                                         "binned_segment_broadcast", "fold"), "flagship")

    # reported, not asserted: the first step again, bit for bit
    first = state_to_numpy(states[1])
    again, _ = step_3d(state0, cfg, geom=geom)
    step_repeatable = all(bool((getattr(again.particles, k).cpu().numpy() == first[k]).all()) for k in ("x", "v", "c"))

    # each checked step on the card vs the same step on the CPU (plain
    # versions) from the card's state before it
    tc = time.perf_counter()
    counts["flagship"]["cpu"] = {}
    step_err = {i: card_vs_cpu(step_3d, states[i], states[i + 1], cfg, f"flagship step {i}",
                               counts["flagship"]["cpu"] if i == COUNTED_STEP else None) for i in CHECKED_STEPS}
    cpu_seconds = time.perf_counter() - tc
    del states, state, state0, geom
    timed = step_ms[1:]
    emit({"phase": "main", "grid": list(cfg.grid.res), "particles": n_particles,
          "warmup_step_ms": step_ms[0], "step_ms": timed, "median_step_ms": statistics.median(timed),
          "counted_step": COUNTED_STEP, "counted_step_ms": counts["flagship"]["ms"],
          "iters": {s: [m[f"{s}_iters"] for m in metrics] for s in ("density", "viscosity", "pressure")},
          "launches": launches, "max_memory_allocated": peak,
          "first_step_bitwise_repeatable": step_repeatable,
          "cpu_steps_seconds": cpu_seconds, "card_vs_cpu_by_step": step_err, "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- 128^3: the kernels on the systems and scatter inputs of step 3
    t0 = time.perf_counter()
    cfg128 = scaled_buckling_config(RES_128)
    s128 = buckling_scene(cfg128, seed=0, device="cuda")
    n128 = int(s128.particles.x.shape[0])
    if (cfg128.grid.res, n128) != SHAPE_128 or cfg128.solver.precond != "mg":
        raise AssertionError(f"unexpected 128^3 config: grid {cfg128.grid.res}, {n128} particles, {cfg128.solver.precond}")
    geom128 = build_geom_cache(s128.solid)
    state2 = s128
    for _ in range(2):
        state2, _ = step_3d(state2, cfg128, geom=geom128)
    got = capture_128(step_3d, state2, cfg128, geom128)
    del state2
    if len(got["cell"]) != 2 or len(got["coupled"]) != 1 or not got["reduce"] or not got["broadcast"]:
        raise AssertionError(f"128^3 capture: {[(k, len(v)) for k, v in got.items()]}")
    cell = [(label, args) for label, (_, args, _) in zip(("density", "pressure"), got["cell"])]
    solve_kw = got["cell"][0][2]
    if solve_kw.get("precond") != "mg":
        raise AssertionError(f"128^3 cell solves are not MG-PCG: {solve_kw}")
    mg_kw = dict(n_smooth=2, omega=0.8, coarse_iters=24, min_dim=4)
    if solve_kw.get("mg_opts") is not None:
        n_s, m_d, c_i = solve_kw["mg_opts"]
        mg_kw.update(n_smooth=int(n_s), min_dim=int(m_d), coarse_iters=int(c_i))
    stencil_rows = stencil_phase(cell)
    b_p, (diag_p, coefs_p, _) = cell[1][1]
    stencil_lib = stencil_library(diag_p, coefs_p, b_p, stencil_matvec(diag_p, coefs_p, b_p))
    tail128, vcycle = vcycle_phase(b_p, diag_p, coefs_p, mg_kw, "128^3 pressure")
    mg_rows = mg_solve_phase(cell, solve_kw)
    red_rows, bc_rows = binned_phase(got["reduce"], got["broadcast"])
    reduce_sweep += route_sweep("128", got["reduce"])
    jac_kw = {k: solve_kw[k] for k in ("tol", "rel_tol", "max_iter")}
    cell128_rows = cell_kernel_phase([((b, d, c, pd), jac_kw) for _, (b, (d, c, pd)) in cell])
    # the other side of the gate on the same systems
    fused128_rows = fused_kernel_phase([(label, (b, torch.zeros_like(b), d, c, pd), jac_kw)
                                        for label, (b, (d, c, pd)) in cell])
    coupled128 = coupled_kernel_phase((got["coupled"][0][1], got["coupled"][0][2]))
    # rows 7-8 at their own size class (the TPU takes the blocked kernel here)
    coupled_stencil128 = coupled_stencil_phase((got["coupled"][0][1], got["coupled"][0][2]))
    del got, cell
    emit({"phase": "kernels_128", "grid": list(cfg128.grid.res), "particles": n128,
          "stencil_matvec": stencil_rows, "stencil_matvec_library": stencil_lib, "mg_vcycle_tail": tail128, "vcycle": vcycle, "mg_pcg": mg_rows,
          "binned_segment_reduce": red_rows, "binned_segment_broadcast": bc_rows,
          "cell_poisson_pcg_jacobi": cell128_rows, "fused_poisson_pcg_jacobi": fused128_rows,
          "coupled_visc_pcg": coupled128, "coupled_stencil_matvec": coupled_stencil128,
          "seconds": time.perf_counter() - t0})

    # -- 128^3 main path
    t0 = time.perf_counter()
    read_counts = reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts["128"] = {}
    with counted_tails() as cycles128:
        state, states, step_ms128, metrics128 = run_steps(step_3d, s128, cfg128, geom128, STEPS_128,
                                                          CHECKED_STEP_128 + 1, count=counts["128"])
    launches128 = read_counts()
    check_one_tail_a_cycle(launches128, cycles128[0], "128^3")
    peak128 = torch.cuda.max_memory_allocated()
    check_run(state, metrics128, launches128, ("coupled_visc_pcg", "stencil_matvec", "mg_vcycle_tail",
                                               *REDUCE_ROUTE, "binned_segment_broadcast", "fold"), "128^3")
    first = state_to_numpy(states[1])
    again, _ = step_3d(s128, cfg128, geom=geom128)
    for k in ("x", "v", "c"):
        if not (getattr(again.particles, k).cpu().numpy() == first[k]).all():
            raise AssertionError(f"128^3: the first step run twice differs in {k}")
    tc = time.perf_counter()
    counts["128"]["cpu"] = {}
    err128 = card_vs_cpu(step_3d, states[CHECKED_STEP_128], states[CHECKED_STEP_128 + 1], cfg128,
                         f"128^3 step {CHECKED_STEP_128}", counts["128"]["cpu"])
    cpu128 = time.perf_counter() - tc
    del states, state
    timed128 = step_ms128[1:]
    emit({"phase": "main_128", "grid": list(cfg128.grid.res), "particles": n128,
          "warmup_step_ms": step_ms128[0], "step_ms": timed128, "median_step_ms": statistics.median(timed128),
          "counted_step": COUNTED_STEP, "counted_step_ms": counts["128"]["ms"],
          "iters": {s: [m[f"{s}_iters"] for m in metrics128] for s in ("density", "viscosity", "pressure")},
          "launches": launches128, "vcycles": cycles128[0], "max_memory_allocated": peak128,
          "first_step_bitwise_repeatable": True,
          "cpu_step_seconds": cpu128, "card_vs_cpu": {CHECKED_STEP_128: err128}, "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- coiling: the kernels on the viscosity system and folds of step 3
    t0 = time.perf_counter()
    cfgc = coiling_config(RES_COIL)
    sc = coiling_scene(cfgc, seed=0, device="cuda")
    nc = int(sc.particles.x.shape[0])
    if ((cfgc.grid.res, nc) != SHAPE_COIL or cfgc.solver.viscosity_precond != "auto"
            or cfgc.solver.precond != "mg"):
        raise AssertionError(f"unexpected coiling config: grid {cfgc.grid.res}, {nc} particles, {cfgc.solver}")
    geomc = build_geom_cache(sc.solid)
    state2 = sc
    for _ in range(2):
        state2, _ = step_3d(state2, cfgc, geom=geomc)
    with recorded_reduces() as reduces:
        got = capture_coil(step_3d, state2, cfgc, geomc)
    del state2
    reduce_sweep += route_sweep("coiling", reduces)
    if len(got["coupled"]) != 1 or not got["fold"] or len(got["cell"]) != 2:
        raise AssertionError(f"coiling capture: {[(k, len(v)) for k, v in got.items()]}")
    _, (b_c, (diag_c, coefs_c, _)), kw_c = got["cell"][1]  # the pressure solve
    if kw_c.get("precond") != "mg":
        raise AssertionError(f"coiling cell solves are not MG-PCG: {kw_c}")
    mg_kw_c = dict(n_smooth=2, omega=0.8, coarse_iters=24, min_dim=4)
    if kw_c.get("mg_opts") is not None:
        n_s, m_d, c_i = kw_c["mg_opts"]
        mg_kw_c.update(n_smooth=int(n_s), min_dim=int(m_d), coarse_iters=int(c_i))
    tail_coil, vcycle_coil = vcycle_phase(b_c, diag_c, coefs_c, mg_kw_c, "coiling pressure")
    live_coil_rows = live_reduce_phase(reduces, got["fold"])
    del reduces
    visc = (got["coupled"][0][1], got["coupled"][0][2])
    coupled_coil = coupled_kernel_phase(visc)
    geom_rows = geom_matvec_phase(visc)
    geom_lib = geom_matvec_library(visc)
    level0_row, btail_row, bvcycle = batched_vcycle_phase(visc)
    vmg_row = visc_mg_solve_phase(visc)
    fold_rows = fold_phase(got["fold"])
    del got, visc
    emit({"phase": "kernels_coil", "grid": list(cfgc.grid.res), "particles": nc,
          "coupled_visc_pcg": coupled_coil, "coupled_matvec_geom": geom_rows, "coupled_matvec_geom_library": geom_lib,
          "batched_level0_matvec": level0_row,
          "mg_vcycle_tail": tail_coil, "vcycle": vcycle_coil,
          "mg_vcycle_tail_batched": btail_row, "batched_vcycle": bvcycle, "visc_mg_pcg": vmg_row,
          "place_live": live_coil_rows, "fold": fold_rows, "seconds": time.perf_counter() - t0})

    # -- coiling main path: 'auto' from the scene, 'mg', and 'auto' from
    #    visc_mg = 2; each run's counters reset just before it, read just
    #    after
    t0 = time.perf_counter()
    cfg_mg = dataclasses.replace(cfgc, solver=dataclasses.replace(cfgc.solver, viscosity_precond="mg"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, launches_by_run, cycles_by_run = {}, {}, {}
    counts["coiling_256_auto"] = {}
    for label, run_cfg in (("auto", cfgc), ("mg", cfg_mg)):
        read_counts = reset_counters()
        with counted_tails() as cycles:
            runs[label] = run_coil(step_3d, sc, run_cfg, geomc, STEPS_COIL, CHECKED_STEP_COIL + 1,
                                   count=counts["coiling_256_auto"] if label == "auto" else None)
        launches_by_run[label], cycles_by_run[label] = read_counts(), cycles[0]
    # 'auto' with the flag set takes its MG branch: from the 'auto' run's
    # state after 2 steps (the first two steps from rest solve nothing)
    read_counts = reset_counters()
    with counted_tails() as cycles:
        runs["auto_from_visc_mg_2"] = run_coil(step_3d, dataclasses.replace(runs["auto"][1][2], visc_mg=2), cfgc,
                                               geomc, 2, 0)
    launches_by_run["auto_from_visc_mg_2"], cycles_by_run["auto_from_visc_mg_2"] = read_counts(), cycles[0]
    for label, n_cycles in cycles_by_run.items():
        check_one_tail_a_cycle(launches_by_run[label], n_cycles, f"coiling {label}")
    peakc = torch.cuda.max_memory_allocated()
    every_path = ("stencil_matvec", "mg_vcycle_tail", "fold", *REDUCE_ROUTE, "binned_segment_broadcast")
    for label, (state, _, _, metrics, branch) in runs.items():
        need = every_path  # the cell MG-PCG and the scatters; then each viscosity branch the run took
        if "jacobi" in branch:
            need += ("coupled_visc_pcg",)
        if "mg" in branch:
            need += ("coupled_matvec_geom", "mg_vcycle_tail_batched")
        check_run(state, metrics, launches_by_run[label], need, f"coiling {label}")
        if label != "auto" and branch != ["mg"] * len(branch):
            raise AssertionError(f"coiling {label}: the viscosity solve left the MG branch: {branch}")
    if runs["auto"][4][0] != "jacobi":
        raise AssertionError("coiling auto: the first step from the scene did not take the Jacobi branch")
    launchesc = {name: sum(lr[name] for lr in launches_by_run.values()) for name in launches_by_run["auto"]}
    first = state_to_numpy(runs["mg"][1][1])
    again, _ = step_3d(sc, cfg_mg, geom=geomc)
    for k in ("x", "v", "c"):
        if not (getattr(again.particles, k).cpu().numpy() == first[k]).all():
            raise AssertionError(f"coiling mg: the first step run twice differs in {k}")
    tc = time.perf_counter()
    errc = {label: card_vs_cpu(step_3d, runs[label][1][CHECKED_STEP_COIL], runs[label][1][CHECKED_STEP_COIL + 1],
                               run_cfg, f"coiling {label} step {CHECKED_STEP_COIL}")
            for label, run_cfg in (("auto", cfgc), ("mg", cfg_mg))}
    cpuc = time.perf_counter() - tc
    coil_out = {}
    for label, (_, _, step_msc, metricsc, branch) in runs.items():
        timed = step_msc[1:] if len(step_msc) > 2 else step_msc
        coil_out[label] = dict(
            warmup_step_ms=step_msc[0], step_ms=timed, median_step_ms=statistics.median(timed), branch=branch,
            iters={k: [m[f"{k}_iters"] for m in metricsc] for k in ("density", "viscosity", "pressure")},
            visc_rel_residual=[m["viscosity_rel_residual"] for m in metricsc],
        )
    coil_state2 = runs["auto"][1][2]  # for 'auto' with jacobi_precond=False
    del runs
    emit({"phase": "main_coil", "grid": list(cfgc.grid.res), "particles": nc, "runs": coil_out,
          "counted_step": ["auto", COUNTED_STEP], "counted_step_ms": counts["coiling_256_auto"]["ms"],
          "launches": launches_by_run, "vcycles": cycles_by_run, "max_memory_allocated": peakc,
          "first_mg_step_bitwise_repeatable": True,
          "cpu_steps_seconds": cpuc, "card_vs_cpu": errc, "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- 504: the kernels on the systems, the viscosity system and the
    #    level set's fold of step 3 of the 'auto' run (its Jacobi branch)
    t0 = time.perf_counter()
    cfg504 = coiling_config(RES_504)
    s504 = coiling_scene(cfg504, seed=0, device="cuda")
    n504 = int(s504.particles.x.shape[0])
    cells504 = math.prod(cfg504.grid.res)
    if ((cfg504.grid.res, n504) != SHAPE_504 or cfg504.solver.viscosity_precond != "auto"
            or cfg504.solver.precond != "jacobi" or not cells504 > pressure.FUSED_POISSON_CELLS):
        raise AssertionError(f"unexpected 504 config: grid {cfg504.grid.res}, {n504} particles, {cfg504.solver}")
    geom504 = build_geom_cache(s504.solid)
    state2 = s504
    for _ in range(2):
        state2, _ = step_3d(state2, cfg504, geom=geom504)
    with recorded_reduces() as reduces, recorded_broadcasts() as broadcasts:
        got = capture_504(step_3d, state2, cfg504, geom504)
    del state2
    reduce_sweep += route_sweep("504", reduces)
    bc504_rows = broadcast_phase(broadcasts)
    live504_rows = live_reduce_phase(reduces, got["fold"])
    del reduces, broadcasts
    if len(got["fused"]) != 2 or got["cell"] or len(got["coupled"]) != 1 or len(got["fold"]) != 18:
        raise AssertionError(f"504 capture: {[(k, len(v)) for k, v in got.items()]}")
    cell504 = [(label, args, kw) for label, (args, kw) in zip(("density", "pressure"), got["fused"])]
    b_p, _, diag_p, coefs_p, pd_p = cell504[1][1]
    # x0 as an input: the pressure system from a random start too
    x0_rand = torch.randn(b_p.shape, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    x0_rand *= b_p.abs().max()
    fused504_rows = fused_kernel_phase(
        cell504 + [("pressure_random_x0", (b_p, x0_rand, diag_p, coefs_p, pd_p), cell504[1][2])])
    sweep = poisson_sweep(b_p, diag_p, coefs_p, pd_p, SWEEP_PLANES)
    del x0_rand, b_p, diag_p, coefs_p, pd_p, cell504
    visc504 = got["coupled"][0]
    geom504_rows = geom_matvec_phase(visc504)
    geom504_lib = geom_matvec_library(visc504)  # 360M entries: ~4.3 GB of CSR, ~12 GB to build
    coupled504 = coupled_kernel_phase(visc504)
    lean_row = lean_precond_phase(visc504)
    lean_pcg = visc_mg_solve_phase(visc504)
    if not lean_pcg["bitwise"]:
        raise AssertionError(f"504 lean MG-PCG: kernels vs plain versions not bitwise (max abs {lean_pcg['max_abs_err']})")
    fold504 = fold_phase(got["fold"])
    # the level set's 125-channel fold: its dense route folds a 4.0 GB table
    ls504 = next(r for r in fold504 if r["C"] == 125)
    if ls504["dense_table_bytes"] <= 2**31 or not ls504["bitwise"]:
        raise AssertionError(f"504 level-set fold: {ls504}")
    del got, visc504
    torch.cuda.empty_cache()
    emit({"phase": "kernels_504", "grid": list(cfg504.grid.res), "particles": n504,
          "fused_poisson_pcg": fused504_rows, "poisson_sweep": sweep,
          "fused_poisson_cells": pressure.FUSED_POISSON_CELLS, "coupled_matvec_geom": geom504_rows,
          "coupled_matvec_geom_library": geom504_lib, "binned_segment_broadcast": bc504_rows,
          "coupled_visc_pcg": coupled504, "lean_preconditioner": lean_row, "lean_mg_pcg": lean_pcg,
          "place_live": live504_rows, "fold": fold504, "seconds": time.perf_counter() - t0})

    # -- 504 main path: 'auto' from the scene (the Jacobi branch), then
    #    'auto' from visc_mg = 2 (the lean MG branch) from its state after
    #    2 steps; each run's counters reset just before it, read just after
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs504, launches_by_run504 = {}, {}
    read_counts = reset_counters()
    counts["coiling_504_auto"] = {}
    runs504["auto"] = run_coil(step_3d, s504, cfg504, geom504, STEPS_504_AUTO, max(2, STEPS_MESH_504),
                               count=counts["coiling_504_auto"])
    launches_by_run504["auto"] = read_counts()
    read_counts = reset_counters()
    with counted_tails() as cycles504:
        runs504["auto_from_visc_mg_2"] = run_coil(step_3d, dataclasses.replace(runs504["auto"][1][2], visc_mg=2),
                                                  cfg504, geom504, STEPS_504, 1)
    launches_by_run504["auto_from_visc_mg_2"] = read_counts()
    check_one_tail_a_cycle(launches_by_run504["auto_from_visc_mg_2"], cycles504[0], "504 lean")
    peak504 = torch.cuda.max_memory_allocated()
    every_path = ("fused_poisson_pcg", "fold", *REDUCE_ROUTE, "binned_segment_broadcast")
    need_by_run = {"auto": every_path + ("coupled_visc_pcg",),
                   "auto_from_visc_mg_2": every_path + ("coupled_matvec_geom", "coupled_matvec_geom_same_axis",
                                                        "mg_vcycle_tail_batched", "stencil_matvec")}
    for label, (state, _, _, metrics, branch) in runs504.items():
        check_run(state, metrics, launches_by_run504[label], need_by_run[label], f"504 {label}")
        if launches_by_run504[label]["cell_poisson_pcg"]:
            raise AssertionError(f"504 {label}: a cell solve took cell_poisson_pcg")
        want = "mg" if label != "auto" else "jacobi"
        if branch != [want] * len(branch):
            raise AssertionError(f"504 {label}: the viscosity solve took {branch}")
    # the first lean-MG step again, bit for bit
    before, first = runs504["auto_from_visc_mg_2"][1][0], runs504["auto_from_visc_mg_2"][1][1]
    with recorded_levelsets() as levelsets504:
        again, _ = step_3d(before, cfg504, geom=geom504)
    for k in ("x", "v", "c"):
        if not torch.equal(getattr(again.particles, k), getattr(first.particles, k)):
            raise AssertionError(f"504: the first lean-MG step run twice differs in {k}")
    del again
    levelset504 = levelset_card_vs_cpu(levelsets504, cfg504, geom504)
    del levelsets504
    # the first lean step held against the same step on the card with every
    # kernel swapped for its plain version
    tc = time.perf_counter()
    err504, _ = card_vs_plain(step_3d, before, first, cfg504, geom504, "504 first lean-MG step")
    plain504 = time.perf_counter() - tc
    launches504 = {name: sum(lr[name] for lr in launches_by_run504.values()) for name in launches_by_run504["auto"]}
    out504 = {}
    for label, (_, _, step_ms504, metrics504, branch) in runs504.items():
        timed = step_ms504[1:]
        out504[label] = dict(
            warmup_step_ms=step_ms504[0], step_ms=timed, median_step_ms=statistics.median(timed), branch=branch,
            iters={k: [m[f"{k}_iters"] for m in metrics504] for k in ("density", "viscosity", "pressure")},
            visc_rel_residual=[m["viscosity_rel_residual"] for m in metrics504],
        )
    auto504 = runs504["auto"]  # the unsharded 'auto' run from the scene, for mesh_504
    auto504_metrics = auto504[3][:STEPS_MESH_504]  # its steps the mesh run also takes
    del runs504, before, first
    emit({"phase": "main_504", "grid": list(cfg504.grid.res), "particles": n504, "runs": out504,
          "counted_step": ["auto", COUNTED_STEP], "counted_step_ms": counts["coiling_504_auto"]["ms"],
          "launches": launches_by_run504, "lean_vcycles": cycles504[0], "max_memory_allocated": peak504,
          "first_lean_step_bitwise_repeatable": True, "levelset_card_vs_cpu": levelset504,
          "check": "the first lean-MG step vs the same step on the card with every kernel swapped for its plain version",
          "plain_step_seconds": plain504, "card_vs_plain_on_card": err504,
          "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- the sharded 504 step on a 1D mesh of MESH_SLOTS slots of the card,
    #    from the scene main_504 started from: 1 warm-up + 2 timed steps
    #    with the counters reset just before, then 1 profiled step
    t0 = time.perf_counter()
    m504 = make_mesh(MESH_SLOTS)
    step_m504 = functools.partial(step_3d, mesh=m504)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counts = reset_counters()
    state, _, ms_m504, metrics_m504 = run_steps(step_m504, shard_state(s504, m504), cfg504, geom504, STEPS_MESH_504, 0)
    launches_m504 = read_counts()
    peak_m504 = torch.cuda.max_memory_allocated()
    check_run(state, metrics_m504, launches_m504, ("halo_exchange_rdma", "fold", *REDUCE_ROUTE,
                                                   "binned_segment_broadcast"), "504 mesh")
    ref504 = auto504[1][STEPS_MESH_504]  # the unsharded state after as many steps
    dx504 = float((state.particles.x[:n504] - ref504.particles.x).abs().max())
    dv504 = float((state.particles.v[:n504] - ref504.particles.v).abs().max())
    if not (dx504 < MESH_DX and dv504 < MESH_DV):
        raise AssertionError(f"504 mesh vs unsharded after {STEPS_MESH_504} steps: |dx| {dx504}, |dv| {dv504}")
    # the unsharded second step's own viscosity system, solved by the
    # coupled PCG kernel and distributed on the same slots: the sharded
    # run's exits move with its (rounding-level different) systems, a
    # solve of one system must not; each solve's residual at its exit and
    # one iteration before shows how close to the threshold it stopped
    from python_fluid_simulation_tpu_torch.engine import step as step_mod
    from python_fluid_simulation_tpu_torch.solvers import viscosity as visc_mod

    calls = []

    def rec_visc(*a, **kw):
        calls.append((a, kw))
        return visc_mod.viscosity_solve_3d(*a, **kw)

    with patched([(step_mod, "viscosity_solve_3d", rec_visc)]):
        step_3d(auto504[1][1], cfg504, geom=geom504)
    visc_args, visc_kw = calls[0]
    visc_kw = dict(visc_kw, precond_kind="jacobi", auto_use_mg=None)
    same_system, faces = {}, {}
    for label, extra in (("coupled_visc_pcg", {}), ("distributed", {"mesh": m504})):
        solved = visc_mod.viscosity_solve_3d(*visc_args, **{**visc_kw, **extra})
        k = int(solved.stats.iters)
        before = visc_mod.viscosity_solve_3d(*visc_args, **{**visc_kw, **extra, "max_iter": max(k - 1, 0)})
        same_system[label] = dict(iters=k, residual=float(solved.stats.residual),
                                  residual_one_iteration_before=float(before.stats.residual),
                                  tol_squared=visc_kw["tol"] ** 2)
        faces[label] = solved.v_faces
        del solved, before
    if abs(same_system["distributed"]["iters"] - same_system["coupled_visc_pcg"]["iters"]) > VISC_MESH_ITERS:
        raise AssertionError(f"504 second step's viscosity system: {same_system}")
    for a, (got, ref) in enumerate(zip(faces["distributed"], faces["coupled_visc_pcg"])):
        check_close(f"504 second step's viscosity system, distributed vs kernel, face {a}", got, ref, VISC_MESH_TOL)
    same_system["max_abs_diff"] = max(max_err(g, r)[0] for g, r in zip(faces["distributed"], faces["coupled_visc_pcg"]))
    del calls, visc_args, visc_kw, faces
    _, prof_m504, _ = profile_steps(lambda st: step_m504(st, cfg504, geom=geom504), state, 1)
    halo_dev = prof_m504["own_kernels_per_step"].get("halo_pull_kernel", {})
    timed = ms_m504[1:]
    emit({"phase": "mesh_504", "grid": list(cfg504.grid.res), "particles": n504, "mesh": m504.shape,
          "warmup_step_ms": ms_m504[0], "step_ms": timed, "median_step_ms": statistics.median(timed),
          "max_memory_allocated": peak_m504, "launches": launches_m504,
          "halo_launches_per_step": launches_m504["halo_exchange_rdma"] / STEPS_MESH_504,
          "iters": {k: [m[f"{k}_iters"] for m in metrics_m504] for k in ("density", "viscosity", "pressure")},
          "unsharded_iters": {k: [m[f"{k}_iters"] for m in auto504_metrics] for k in ("density", "viscosity", "pressure")},
          # the viscosity exits (||r||^2 and over ||r0||^2), sharded then unsharded
          "visc_residual": [[m["viscosity_residual"] for m in run] for run in (metrics_m504, auto504_metrics)],
          "visc_rel_residual": [[m["viscosity_rel_residual"] for m in run] for run in (metrics_m504, auto504_metrics)],
          "vs_unsharded": {"dx": dx504, "dv": dv504, "bars": [MESH_DX, MESH_DV]},
          "unsharded_second_step_viscosity_system": same_system,
          "profile": {k: prof_m504[k] for k in ("step_ms", "device_busy_ms_per_step", "device_idle_share",
                                                "cuda_events_per_step", "runtime_calls_per_step",
                                                "own_kernels_per_step", "top_device")},
          "halo_kernel_device_ms_per_step": halo_dev.get("device_ms"),
          "halo_kernel_launches_per_step_profiled": halo_dev.get("launches"),
          "seconds": time.perf_counter() - t0})
    del state, auto504, ref504, s504, geom504, m504, prof_m504
    torch.cuda.empty_cache()

    # -- the reference's unpreconditioned CG (jacobi_precond=False) and the
    #    dt-scaled pressure assembly: the kernels on the flagship's third
    #    step with jacobi_precond=False
    t0 = time.perf_counter()

    def with_solver(c, **kw):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, **kw))

    cfg_nj = with_solver(cfg, jacobi_precond=False)
    s_f = buckling_scene(cfg, seed=0, device="cuda")
    geom = build_geom_cache(s_f.solid)
    state2 = s_f
    for _ in range(2):
        state2, _ = step_3d(state2, cfg_nj, geom=geom)
    got = capture_nojac(step_3d, state2, cfg_nj, geom)
    del state2
    if len(got["cell"]) != 2 or len(got["visc_fields"]) != 1 or len(got["visc_cg"]) != 1:
        raise AssertionError(f"jacobi_precond=False capture: {[(k, len(v)) for k, v in got.items()]}")
    (s_mu_f, sphi_f, vol_f, _), _ = got["visc_fields"][0]
    (_, b_f, x0_f), _ = got["visc_cg"][0]
    coupled_stencil_row = coupled_stencil_phase(((b_f, x0_f, None, sphi_f, vol_f, s_mu_f), {}))
    prepared_rows = prepared_matvec_phase([(label, (args[0], args[1]))
                                           for label, (args, _) in zip(("density", "pressure"), got["cell"])])
    nojac_solves = nojac_solve_phase(got)
    del got, b_f, x0_f, sphi_f, vol_f, s_mu_f
    emit({"phase": "kernels_options", "grid": list(cfg.grid.res), "coupled_stencil_matvec": coupled_stencil_row,
          "prepared_matvec": prepared_rows, "unpreconditioned_solves": nojac_solves,
          "seconds": time.perf_counter() - t0})

    # -- the options' main paths, counters reset just before each run and
    #    read just after: the flagship with jacobi_precond=False and with
    #    pressure_dt_scaled, the 128^3 step with jacobi_precond=False, and
    #    coiling 'auto' with jacobi_precond=False from the 'auto' run's
    #    state after 2 steps (its Jacobi branch: CG over the materialised
    #    matvec with the Jacobi preconditioner)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches_opt, opt_out = {}, {}
    every_path = (*REDUCE_ROUTE, "binned_segment_broadcast", "fold")

    def refuse(label, launched, names):
        for name in names:
            if launched[name]:
                raise AssertionError(f"{label}: {name} was launched ({launched[name]} times)")

    def summary(step_ms, metrics, **extra):
        timed = step_ms[1:]
        return dict(warmup_step_ms=step_ms[0], step_ms=timed, median_step_ms=statistics.median(timed),
                    iters={k: [m[f"{k}_iters"] for m in metrics] for k in ("density", "viscosity", "pressure")},
                    **extra)

    read_counts = reset_counters()
    state, states, ms_nj, metrics_nj = run_steps(step_3d, s_f, cfg_nj, geom, STEPS_NOJAC, 3)
    launches_opt["flagship_nojac"] = read_counts()
    check_run(state, metrics_nj, launches_opt["flagship_nojac"],
              ("coupled_stencil_matvec", "stencil_matvec") + every_path, "flagship jacobi_precond=False")
    refuse("flagship jacobi_precond=False", launches_opt["flagship_nojac"],
           ("cell_poisson_pcg", "fused_poisson_pcg", "coupled_visc_pcg"))
    first = state_to_numpy(states[1])
    again, _ = step_3d(s_f, cfg_nj, geom=geom)
    nj_repeatable = all(bool((getattr(again.particles, k).cpu().numpy() == first[k]).all()) for k in ("x", "v", "c"))
    nj_check = step_vs_cpu_or_plain(step_3d, states[2], states[3], cfg_nj, geom, "flagship jacobi_precond=False step 2")
    opt_out["flagship_nojac"] = summary(ms_nj, metrics_nj, first_step_bitwise_repeatable=nj_repeatable,
                                        step_2=nj_check)
    del states, state, again

    cfg_dt = with_solver(cfg, pressure_dt_scaled=True)
    read_counts = reset_counters()
    state, states, ms_dt, metrics_dt = run_steps(step_3d, s_f, cfg_dt, geom, STEPS_OPTION, 3)
    launches_opt["flagship_dt_scaled"] = read_counts()
    check_run(state, metrics_dt, launches_opt["flagship_dt_scaled"],
              ("cell_poisson_pcg", "coupled_visc_pcg") + every_path, "flagship pressure_dt_scaled")
    opt_out["flagship_dt_scaled"] = summary(ms_dt, metrics_dt, step_2=step_vs_cpu_or_plain(
        step_3d, states[2], states[3], cfg_dt, geom, "flagship pressure_dt_scaled step 2"))
    del states, state, s_f, geom

    cfg128_nj = with_solver(cfg128, jacobi_precond=False)
    read_counts = reset_counters()
    state, _, ms128_nj, metrics128_nj = run_steps(step_3d, s128, cfg128_nj, geom128, STEPS_OPTION, 0)
    launches_opt["128_nojac"] = read_counts()
    check_run(state, metrics128_nj, launches_opt["128_nojac"],
              ("coupled_stencil_matvec", "stencil_matvec", "mg_vcycle_tail") + every_path, "128^3 jacobi_precond=False")
    refuse("128^3 jacobi_precond=False", launches_opt["128_nojac"], ("coupled_visc_pcg",))
    opt_out["128_nojac"] = summary(ms128_nj, metrics128_nj)
    del state

    opt_out["128_dt_scaled"], launches_opt["128_dt_scaled"] = dt_scaled_128(step_3d, s128, cfg128, geom128)
    del s128, geom128

    cfgc_nj = with_solver(cfgc, jacobi_precond=False)
    read_counts = reset_counters()
    state, _, msc_nj, metricsc_nj, branch_nj = run_coil(step_3d, coil_state2, cfgc_nj, geomc, 2, 0)
    launches_opt["coil_auto_nojac"] = read_counts()
    if branch_nj[0] != "jacobi":
        raise AssertionError(f"coiling 'auto' jacobi_precond=False: the first step took {branch_nj}")
    check_run(state, metricsc_nj, launches_opt["coil_auto_nojac"],
              ("coupled_stencil_matvec", "stencil_matvec", "mg_vcycle_tail") + every_path
              + (("coupled_matvec_geom",) if "mg" in branch_nj else ()), "coiling 'auto' jacobi_precond=False")
    refuse("coiling 'auto' jacobi_precond=False", launches_opt["coil_auto_nojac"], ("coupled_visc_pcg",))
    opt_out["coil_auto_nojac"] = dict(step_ms=msc_nj, branch=branch_nj, iters={
        k: [m[f"{k}_iters"] for m in metricsc_nj] for k in ("density", "viscosity", "pressure")})
    del state, coil_state2, geomc
    emit({"phase": "main_options", "runs": opt_out, "launches": launches_opt,
          "max_memory_allocated": torch.cuda.max_memory_allocated(), "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- 256: every segment reduce of the third step on both routes, and
    #    the route sweep of all five sizes
    t0 = time.perf_counter()
    cfg256 = scaled_buckling_config(RES_256)
    s256 = buckling_scene(cfg256, seed=0, device="cuda")
    n256 = int(s256.particles.x.shape[0])
    if ((cfg256.grid.res, n256) != SHAPE_256 or cfg256.solver.precond != "jacobi"
            or cfg256.solver.viscosity_precond != "jacobi"
            or not math.prod(cfg256.grid.res) > pressure.FUSED_POISSON_CELLS):
        raise AssertionError(f"unexpected 256 config: grid {cfg256.grid.res}, {n256} particles, {cfg256.solver}")
    geom256 = build_geom_cache(s256.solid)
    state2 = s256
    for _ in range(2):
        state2, _ = step_3d(state2, cfg256, geom=geom256)
    with recorded_reduces() as reduces, recorded_broadcasts() as broadcasts:
        got = capture_504(step_3d, state2, cfg256, geom256)
    del state2
    if len(reduces) != 4 or len(got["fold"]) != 18:
        raise AssertionError(f"256 capture: {len(reduces)} reduces, {len(got['fold'])} folds")
    bc256_rows = broadcast_phase(broadcasts)
    del broadcasts
    scan_rows = scan_route_phase(reduces)
    wide_rows = wide_reduce_phase(reduces)
    reduce_sweep += route_sweep("256", reduces)
    live256_rows = live_reduce_phase(reduces, got["fold"])
    del reduces
    fold256_rows = fold_phase(got.pop("fold"))
    torch.cuda.empty_cache()
    # rows 3 and 2 on the step's cell systems (6.07M cells) and viscosity
    # system (18M faces)
    if len(got["fused"]) != 2 or got["cell"] or len(got["coupled"]) != 1:
        raise AssertionError(f"256 capture: {[(k, len(v)) for k, v in got.items()]}")
    fused256_rows = fused_kernel_phase([(label, args, kw) for label, (args, kw) in zip(("density", "pressure"),
                                                                                      got["fused"])])
    coupled256 = coupled_kernel_phase(got["coupled"][0])
    del got
    torch.cuda.empty_cache()
    emit({"phase": "kernels_256", "grid": list(cfg256.grid.res), "particles": n256, "reduce": scan_rows,
          "serial_reduce_wide": wide_rows, "route_sweep": reduce_sweep, "place_live": live256_rows, "fold": fold256_rows,
          "fused_poisson_pcg": fused256_rows, "coupled_visc_pcg": coupled256,
          "binned_segment_broadcast": bc256_rows,
          "seconds": time.perf_counter() - t0})

    # -- 256 main path: counters reset just before, read just after
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read_counts = reset_counters()
    counts["256"] = {}
    state, states, step_ms256, metrics256 = run_steps(step_3d, s256, cfg256, geom256, STEPS_256, STEPS_256,
                                                      count=counts["256"])
    launches256 = read_counts()
    peak256 = torch.cuda.max_memory_allocated()
    check_run(state, metrics256, launches256, ("fused_poisson_pcg", "coupled_visc_pcg", *REDUCE_ROUTE,
                                               "binned_segment_broadcast", "fold"), "256")
    for name in ("cell_poisson_pcg", "binned_segment_reduce"):
        if launches256[name]:
            raise AssertionError(f"256: {name} was launched ({launches256[name]} times)")
    again, _ = step_3d(s256, cfg256, geom=geom256)
    for k in ("x", "v", "c"):
        if not torch.equal(getattr(again.particles, k), getattr(states[1].particles, k)):
            raise AssertionError(f"256: the first step run twice differs in {k}")
    del again
    # the last step held against the same step on the card with every
    # kernel swapped for its plain version
    tc = time.perf_counter()
    err256, _ = card_vs_plain(step_3d, states[-2], states[-1], cfg256, geom256, f"256 step {STEPS_256 - 1}")
    plain256 = time.perf_counter() - tc
    timed256 = step_ms256[1:]
    del states, state, s256, geom256
    emit({"phase": "main_256", "grid": list(cfg256.grid.res), "particles": n256,
          "warmup_step_ms": step_ms256[0], "step_ms": timed256, "median_step_ms": statistics.median(timed256),
          "counted_step": COUNTED_STEP, "counted_step_ms": counts["256"]["ms"],
          "iters": {k: [m[f"{k}_iters"] for m in metrics256] for k in ("density", "viscosity", "pressure")},
          "launches": launches256, "max_memory_allocated": peak256, "first_step_bitwise_repeatable": True,
          "check": f"step {STEPS_256 - 1} vs the same step on the card with every kernel swapped for its plain version",
          "card_vs_plain_on_card": err256, "plain_step_seconds": plain256, "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- the learned operator: the full-width UNet on the flagship's real
    #    feature box of the third 'unet_warm' step, and that step's warm
    #    start (rows 4 and 2) vs their plain versions
    t0 = time.perf_counter()
    from python_fluid_simulation_tpu_torch.convert import random_flax_unet_params, unet_state_dict_from_flax
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    unet_sd = unet_state_dict_from_flax(random_flax_unet_params(UNET_WIDTH, seed=0))
    unet = UNet3D(width=UNET_WIDTH).eval()
    unet.load_state_dict(unet_sd)
    unet = unet.to("cuda")
    unet16 = UNet3D(width=UNET_WIDTH, dtype=torch.bfloat16).eval()
    unet16.load_state_dict(unet_sd)
    unet16 = unet16.to("cuda")
    unet_cpu = UNet3D(width=UNET_WIDTH).eval()
    unet_cpu.load_state_dict(unet_sd)
    step_unet = functools.partial(step_3d, unet=unet)
    step_unet_cpu = functools.partial(step_3d, unet=unet_cpu)
    cfg_unet, cfg_warm = with_solver(cfg, viscosity_mode="unet"), with_solver(cfg, viscosity_mode="unet_warm")
    s_u = buckling_scene(cfg, seed=0, device="cuda")
    geom = build_geom_cache(s_u.solid)
    state2 = s_u
    for _ in range(2):
        state2, _ = step_unet(state2, cfg_warm, geom=geom)
    got = capture_unet(step_unet, state2, cfg_warm, geom)
    del state2
    if len(got["unet"]) != 1 or len(got["line"]) != 1 or len(got["coupled"]) != 1:
        raise AssertionError(f"unet_warm capture: {[(k, len(v)) for k, v in got.items()]}")
    forward_row = unet_forward_phase(unet, unet16, unet_sd, got["unet"][0], cfg)
    warm_row = warm_start_phase(got["line"][0], got["coupled"][0])
    del got, unet16
    torch.cuda.empty_cache()
    emit({"phase": "kernels_unet", "grid": list(cfg.grid.res), "width": UNET_WIDTH, "forward": forward_row,
          "warm_start": warm_row, "seconds": time.perf_counter() - t0})

    # -- the learned operator's main paths: 'unet' then 'unet_warm' on the
    #    flagship, 1 warm-up + 5 timed steps each, counters reset just
    #    before each run and read just after
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    unet_out, launches_unet = {}, {}
    for mode, run_cfg in (("unet", cfg_unet), ("unet_warm", cfg_warm)):
        events, remove_hooks = unet_forward_events(unet)
        read_counts = reset_counters()
        unet_count = {"kw": {"unet": unet}} if mode == "unet" else None
        if unet_count is not None:
            counts["flagship_unet"] = unet_count
        state, states, ms_u, metrics_u = run_steps(step_unet, s_u, run_cfg, geom, STEPS_UNET, STEPS_UNET,
                                                   count=unet_count)
        launches_unet[mode] = read_counts()
        remove_hooks()
        torch.cuda.synchronize()
        forward_ms = [start.elapsed_time(stop) for start, stop in events]
        if len(forward_ms) != STEPS_UNET:
            raise AssertionError(f"{mode}: {len(forward_ms)} UNet forwards in {STEPS_UNET} steps")
        if unet_count is not None:  # the counted step's forward, as its step ms, left out
            forward_ms.pop(COUNTED_STEP)
        need = ("cell_poisson_pcg", *REDUCE_ROUTE, "binned_segment_broadcast", "fold")
        if mode == "unet_warm":
            need += ("coupled_visc_pcg", "coupled_matvec_geom")
        check_run(state, metrics_u, launches_unet[mode], need, f"flagship {mode}")
        if mode == "unet":
            refuse(f"flagship {mode}", launches_unet[mode], ("coupled_visc_pcg", "coupled_matvec_geom"))
            if any(m["viscosity_iters"] for m in metrics_u):
                raise AssertionError(f"flagship unet: viscosity iterations {[m['viscosity_iters'] for m in metrics_u]}")
        again, _ = step_unet(s_u, run_cfg, geom=geom)
        for k in ("x", "v", "c"):
            if not torch.equal(getattr(again.particles, k), getattr(states[1].particles, k)):
                raise AssertionError(f"flagship {mode}: the first step run twice differs in {k}")
        del again
        before, after = states[CHECKED_STEP_UNET], states[CHECKED_STEP_UNET + 1]
        err_u, _ = card_vs_plain(step_unet, before, after, run_cfg, geom, f"flagship {mode} step {CHECKED_STEP_UNET}")
        tc = time.perf_counter()
        cpu_after, _ = step_unet_cpu(state_from_numpy(state_to_numpy(before), device="cpu"), run_cfg)
        cpu_u = time.perf_counter() - tc
        vs_cpu = step_diff(state_to_numpy(after), state_to_numpy(cpu_after))
        # reported, not asserted (random weights): the 'apic' solve from the
        # same states
        apic_iters = [int(step_3d(s, cfg, geom=geom)[1]["viscosity_iters"]) for s in states[:-1]]
        timed = ms_u[1:]
        unet_out[mode] = dict(
            warmup_step_ms=ms_u[0], step_ms=timed, median_step_ms=statistics.median(timed),
            forward_ms=forward_ms, unet_share_of_step=statistics.median(
                f / s for f, s in zip(forward_ms[1:], timed)),
            iters={k: [m[f"{k}_iters"] for m in metrics_u] for k in ("density", "viscosity", "pressure")},
            apic_viscosity_iters_from_same_states=apic_iters, first_step_bitwise_repeatable=True,
            counted_step=COUNTED_STEP if unet_count is not None else None,
            check=f"step {CHECKED_STEP_UNET} vs the same step on the card with every kernel swapped for its plain "
                  "version (the UNet on the card in both)",
            card_vs_plain_on_card=err_u, reported_vs_cpu=vs_cpu, cpu_step_seconds=cpu_u)
        del state, states, cpu_after
    peak_unet = torch.cuda.max_memory_allocated()
    del s_u, geom, unet, unet_cpu
    torch.cuda.empty_cache()
    emit({"phase": "main_unet", "grid": list(cfg.grid.res), "width": UNET_WIDTH, "runs": unet_out,
          "launches": launches_unet, "max_memory_allocated": peak_unet, "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- the trainer: captured flagship pairs, full-width training steps,
    #    determinism, the card vs the CPU, both unpool forms, and the
    #    capture -> train -> eval pipeline at small counts (counted)
    t0 = time.perf_counter()
    train_out, launches_train = train_phase()
    emit({"phase": "train", "grid": list(cfg.grid.res), "width": UNET_WIDTH, **train_out,
          "launches": launches_train, "seconds": time.perf_counter() - t0})

    # -- row 15: the halo kernel against its plain version at every shape
    #    the sharded steps exchange, over 2, 4 and 8 slots of the card
    t0 = time.perf_counter()
    halo_rows = halo_phase()
    emit({"phase": "halo", "rows": halo_rows, "seconds": time.perf_counter() - t0})

    # -- the cross-card sum of the distributed dots, on slots of the card
    t0 = time.perf_counter()
    psum_rows = psum_phase()
    emit({"phase": "psum", "rows": psum_rows, "seconds": time.perf_counter() - t0})

    # -- the sharded flagship step: 1D and (2, 2) meshes of the card
    t0 = time.perf_counter()
    s_mesh = buckling_scene(cfg, seed=0, device="cuda")
    geom = build_geom_cache(s_mesh.solid)
    mesh_out, launches_mesh = mesh_phase(step_3d, mesh_runs(cfg, geom, s_mesh))
    del s_mesh, geom
    emit({"phase": "mesh", "grid": list(cfg.grid.res), "particles": n_particles, "runs": mesh_out,
          "launches": launches_mesh, "bars": [MESH_DX, MESH_DV], "seconds": time.perf_counter() - t0})

    # -- the step as one captured program: make_step's graph replayed
    #    against the eager step, bitwise, on every configuration
    t0 = time.perf_counter()
    graph_rows, while_launches, while_row = graph_phase(unet_sd)
    emit({"phase": "graph", "nvidia_smi": smi, "runs": graph_rows, "while_node": while_row,
          "seconds": time.perf_counter() - t0})

    # -- bytes: each counted step of the main runs against its
    #    configuration's replayed ms a step
    t0 = time.perf_counter()
    shapes = {"flagship": FLAGSHIP, "128": SHAPE_128, "coiling_256_auto": SHAPE_COIL, "coiling_504_auto": SHAPE_504,
              "256": SHAPE_256, "flagship_unet": FLAGSHIP}
    for row in bytes_phase(counts, shapes, graph_rows, kind, smi):
        emit(dict(row, seconds=time.perf_counter() - t0))

    # -- the CLI: run.main on the flagship (blocks, every output, resume
    #    bitwise, one capture a run), coiling 'auto', and the unit APIs
    t0 = time.perf_counter()
    cli_out = cli_phase(smi)
    emit({"phase": "cli", **cli_out, "seconds": time.perf_counter() - t0})

    # -- the 2D engine: both scenes and the fine dam break, eager vs graph,
    #    kernels vs plain versions, every 2D fold, the CLI's 2D scene
    t0 = time.perf_counter()
    twod_out, launches_2d = twod_phase(smi)
    emit({"phase": "twod", **twod_out, "launches": launches_2d, "seconds": time.perf_counter() - t0})

    # -- bucketed residency on 1D slab meshes: the flagship on 4 slots, 504
    #    on 2, the CLI's --mesh 4 --bucketed
    t0 = time.perf_counter()
    bucket_out, launches_bucket = bucketed_phase(smi)
    emit({"phase": "bucketed", **bucket_out, "launches": launches_bucket, "seconds": time.perf_counter() - t0})

    # -- the learned modes under a mesh: 'unet' and 'unet_warm' on 4 slots
    #    and on (2, 2), 'unet_warm' bucketed on (2, 2)
    t0 = time.perf_counter()
    learned_out, launches_learned = mesh_learned_phase(smi, unet_sd)
    emit({"phase": "mesh_learned", **learned_out, "launches": launches_learned, "seconds": time.perf_counter() - t0})

    # -- the sharded, bucketed and learned mesh steps as captured programs:
    #    make_step(mesh=, bucketed=)'s graphs against the eager steps, bitwise
    t0 = time.perf_counter()
    graph_mesh_out, mesh_while_launches, launches_graph_mesh = graph_mesh_phase(smi, unet_sd)
    while_launches += mesh_while_launches
    emit({"phase": "graph_mesh", "runs": graph_mesh_out, "launches": launches_graph_mesh,
          "seconds": time.perf_counter() - t0})

    # -- the port on four cards: path 1 on another card, path 2 across four,
    #    the push across cards; on a host of fewer cards one line
    if count >= CARDS:
        emit(cards_phase(unet_sd))
    else:
        emit({"phase": "cards", "skipped": f"needs {CARDS} cards, this host has {count}"})

    # -- summary: the nvidia-smi line, the kernels line, then the result
    every_run = [launches, launches128, launchesc, launches504, launches_m504, *launches_opt.values(), launches256,
                 *launches_unet.values(), launches_train, *launches_mesh.values(), *launches_2d.values(),
                 *launches_bucket.values(), *launches_learned.values(), *launches_graph_mesh.values()]

    def entry(name, source, replaces, row, library_ms=None, counter=None):
        return {"name": name, "route": "cuda", "source": f"python_fluid_simulation_tpu_torch/csrc/{source}",
                "replaces": f"python_fluid_simulation_tpu/ops/{replaces}",
                "launches": sum(run[counter or name] for run in every_run),
                "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": max(row["bytes_ms"], row["ops_ms"]),
                "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations",
                "library_ms": library_ms}

    def total(rows, keys=("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")):
        """One step's (or one V-cycle's) calls summed."""
        out = {k: sum(r[k] for r in rows) for k in keys if k in rows[0]}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return out

    # the cell kernel is timed on the pressure system; its error is the
    # larger of the density and pressure systems'
    pres = dict(cell_rows[1], max_abs_err=max(r["max_abs_err"] for r in cell_rows))
    sten = dict(stencil_rows[1], max_abs_err=max(r["max_abs_err"] for r in stencil_rows))
    red, bc, fold = total(red_rows), total(bc_rows), total(fold_rows)
    fold2d = total(twod_out["folds"]["dam_break_2d_256"])
    fold2d["library_device_ms"] = sum(r["library_device_ms"] for r in twod_out["folds"]["dam_break_2d_256"])
    fold2d["bound_ms"] = max(fold2d.pop("bytes_ms"), fold2d.pop("ops_ms"))
    fold2d["launches_per_step"] = twod_out["runs"]["dam_break_2d_256"]["launches_per_step"]["fold"]
    scan_red = total([r["scan_reduce"] for r in scan_rows])
    kernels = [
        entry("cell_poisson_pcg", "poisson_pcg.cu", "pallas_stencils.py:125", pres),
        entry("coupled_visc_pcg", "coupled_visc_pcg.cu", "pallas_cg.py:673", coupled_row),
        # the blocked Poisson PCG on the 504 pressure system
        entry("fused_poisson_pcg", "poisson_pcg.cu", "pallas_cg.py:263",
              dict(fused504_rows[1], max_abs_err=max(r["max_abs_err"] for r in fused504_rows))),
        entry("stencil_matvec", "stencil_matvec.cu", "pallas_stencils.py:299", sten, stencil_lib["library_ms"]),
        # the tail of one 128^3 pressure V-cycle (coiling's cell tail in kernels_coil)
        entry("mg_vcycle_tail", "mg_vcycle.cu", "pallas_mg.py:100", tail128),
        dict(entry("binned_segment_reduce", "binned_segment.cu", "pallas_binned.py:423", red, red["library_ms"]),
             device_ms=red["device_ms"]),
        # the scan route on the 256 step's four reduces: row 11 (the live
        # placement, with row 13 as its first phase) and row 13 (the scan)
        dict(entry("scan_reduce", "binned_segment.cu", "pallas_binned.py:327", scan_red, scan_red["library_ms"],
                   counter="binned_segment_place_live"),
             first_phase="python_fluid_simulation_tpu_torch/csrc/seg_scan.cu",
             placement_ms=sum(r["ms"] for r in live256_rows), placement_plain_ms=sum(r["plain_ms"] for r in live256_rows),
             placement_bound_ms=sum(max(r["bytes_ms"], r["ops_ms"]) for r in live256_rows)),
        entry("seg_scan_sorted", "seg_scan.cu", "pallas_segscan.py:173", total([r["seg_scan_sorted"] for r in scan_rows])),
        entry("binned_segment_broadcast", "binned_segment.cu", "pallas_binned.py:179", bc, bc["library_ms"]),
        # the full operator (the MG-PCG's outer matvec); same-axis in kernels_coil
        entry("coupled_matvec_geom", "coupled_matvec.cu", "pallas_cg.py:714", geom_rows[0], geom_lib["library_ms"]),
        # the tail of one batched viscosity V-cycle (B = 3; the lean 504 inner tail in kernels_504)
        entry("mg_vcycle_tail_batched", "mg_vcycle.cu", "pallas_mg.py:100", btail_row),
        # the folds of one coiling step, on their live tables; the 2D folds of
        # one step of the 256x256 dam break (as 3D folds with a unit axis) apart
        dict(entry("fold", "fold.cu", "pallas_fold.py:97", fold, fold["library_ms"]),
             fold_2d={k: v for k, v in fold2d.items() if k != "max_abs_err"}),
        # rows 7 and 8 in one kernel, on the flagship's fields (128^3 in kernels_128)
        dict(entry("coupled_stencil_matvec", "coupled_stencil_matvec.cu", "pallas_stencils.py:379",
                   coupled_stencil_row, coupled_stencil_row["library_ms"]),
             also_replaces="python_fluid_simulation_tpu/ops/pallas_stencils.py:520"),
        # row 5: the same kernel as stencil_matvec, as the prepared pressure matvec
        entry("stencil_matvec_prepared", "stencil_matvec.cu", "pallas_stencils.py:79",
              dict(prepared_rows[1], max_abs_err=max(r["max_abs_err"] for r in prepared_rows)),
              prepared_rows[1]["library_ms"], counter="stencil_matvec"),
    ]
    # row 15 on the 504 cell slabs over MESH_SLOTS slots (mesh_504's exchanges);
    # bitwise at every shape and slot count
    halo_row = next(r for r in halo_rows if r["field"] == "504_cells" and r["slots"] == MESH_SLOTS)
    for name, route, source in (("halo_exchange_rdma", "pull", "halo_pull.cu"),
                                ("halo_exchange_push", "push", "halo_rdma.cu")):
        kernels.append(dict(
            entry(name, source, "", dict(halo_row, max_abs_err=max(r["max_abs_err"] for r in halo_rows),
                                         ms=halo_row[route]["ms"]), halo_row["library_ms"]),
            device_ms=halo_row[route]["device_ms"], replaces="python_fluid_simulation_tpu/parallel/halo_rdma.py:133"))
    # not a TPU kernel: the cross-card sum of the distributed dots, JAX's
    # lax.psum (a 3-dot call over MESH_SLOTS slots of the card; on four
    # cards it is path 2's, --cards)
    psum_row = next(r for r in psum_rows if r["slots"] == MESH_SLOTS and r["dots"] == 3)
    kernels.append(dict(entry("mesh_psum", "mesh_psum.cu", "", psum_row), device_ms=psum_row["device_ms"],
                        replaces="python_fluid_simulation_tpu/parallel/halo.py:105"))
    # not a TPU kernel: the exit test of the captured CG loops, whose JAX
    # counterpart is the cond of lax.while_loop in the generic cg; its
    # plain version is the eager loop's host test; launched by the graph
    # phase's replays (once before each WHILE node's loop, once an iteration)
    kernels.append({"name": "while_test", "route": "cuda",
                    "source": "python_fluid_simulation_tpu_torch/csrc/cuda_graph.cu",
                    "replaces": "python_fluid_simulation_tpu/solvers/cg.py:70", "launches": while_launches,
                    "max_abs_err": while_row["max_abs_err"], "ms": while_row["ms"], "plain_ms": while_row["plain_ms"],
                    "bound_ms": max(while_row["bytes_ms"], while_row["ops_ms"]),
                    "bound_by": "bytes" if while_row["bytes_ms"] >= while_row["ops_ms"] else "operations",
                    "library_ms": None})
    emit({"phase": "done", "halo_rdma_nvlink_bound_computed": halo_plane_bounds(),
          "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

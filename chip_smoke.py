#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line), in the
order 1-6, 8-14, 15 and 7 (beside 16a), 16, 17, 18; the seconds of each are printed
on a ``[phases]`` line:

1. Build the CUDA kernels from ``conan_fgw_tpu_torch/csrc`` and print the
   build time, each kernel's registers and spills (a cfconv or K3 kernel
   that spills fails the run), and the card's name and power limit; build
   the native batch packer (``conan_fgw_tpu_torch/native/packer.cpp``).
2. Kernel against plain version, on the card: K1 (cfconv forward), K2
   (cfconv backward: dx, dW1, db1, dW2, db2) and K3 (FGW couplings: T and
   the diverged flags) at the slice shape (G = S = 120 conformer graphs,
   N = 32, F = 128, 50 Gaussians) and at N = 64 with the 32-neighbour cap
   active; inputs are synthetic molecules and seeded tensors. K3 is also
   held on the barycenter's second outer iteration at N = 32 and 64 (dense
   C1, warm-started plans: its multi-iteration, freeze and rollback paths)
   and, alone, at N = 96 and N = 128, where it reads C1 and C2 through L2.
   A NaN planted
   in one solve's T0 must flag that solve as diverged, as the plain version
   does. K3 is also held on zero-mass marginals (``bary_pad_mode: masked``)
   and on the deep budget of ``config/schnet/sol1k_5_bc_deep.yaml``
   (epsilon 0.05, 10 PGD x 10 Sinkhorn), both at N = 32. K1 and K2 are
   also held at the classification width (256 filters, 10 Gaussians; the
   kernels' second instantiation, counted as ``cfconv_fwd_f256`` and
   ``cfconv_bwd_f256``) on G = 90 graphs (sol1k_class's 18 molecules x 5
   conformers) at N = 32 and N = 64 with the cap active. Prints each one's max error against its tolerance, its time (CUDA
   events over eager back-to-back calls; for K3 also over CUDA-graph
   replays, ``graph_ms``, which leave out the wrapper's host time) and its
   bound, and K3's Sinkhorn iterations. K2 is launched twice on the same
   inputs and must give bit-identical results. Each kernel gets two bounds:
   its tensor-core products (K1/K2's filter MLP, K3's two N^3 products)
   over the TF32 tensor-core peak (the one in the result line), and
   everything over the f32 CUDA-core peak.
3. Training, the main path: ``fit`` on 48 synthetic molecules (K = 5
   conformers, B = 24, full width), stage 1 for 2 epochs, then stage 2 for
   2 epochs on the same model, its steps as CUDA graphs (``fit`` always
   steps through ``train/graphs.py``; each stage must capture a train and
   an eval graph). Launch counts are zeroed just before and read just
   after; losses must be finite and every kernel must have run. Then three
   more stage-2 steps run eagerly under ``torch.profiler`` for the device
   time by kernel and the device's busy share.
4. Step parity: one stage-2 training step from identical weights through
   the kernels on the card and through the plain versions on the CPU.
5. The runner on the repo's ``data/sol250``: ``train/runner.py``'s
   ``main`` trains stage 1 (``config/schnet/sol250_5.yaml``) and then stage
   2 (``sol250_5_bc.yaml``), each for 2 epochs, on the card, with its
   checkpoints in a temporary directory. Launch counts are zeroed before
   each stage and read after it: K1 and K2 must grow in both, K3 in stage 2
   only, and no plain version may run. The stage-2 weights right after the
   warm start must equal stage 1's ``best`` file bit for bit; both stages
   must run steps in the N=32 and the N=64 bucket; every loss and
   ``test_rmse`` must be finite. A ``--resume`` run of stage 2 with 3
   epochs must start at epoch 2 and add one row, and ``predict.main`` on
   stage 2's ``best`` must give the test RMSE the runner reported, to 1e-6
   relative. Prints each stage's epoch times, steps per epoch, ms per step
   by bucket and ``fgw_diverged``. The steps run as CUDA graphs
   (``train/graphs.py``): each run must capture train and eval graphs, and
   the launch counts must be the eager path's (K2 three a train step;
   three K1 a forward, and in stage 2 as many K3 a forward as the config's
   barycenter has outer iterations: five). Their batches come through the host
   pipeline: every one packed natively on the prefetch thread into a
   pinned slot and copied from it without waiting, none packed by numpy or
   copied from pageable memory.
6. The classification path on the repo's ``data/sol1k_class``: the
   runner's ``main`` trains stage 1 (``config/schnet/sol1k_class_5.yaml``)
   and then stage 2 (``sol1k_class_5_bc.yaml``), each for 2 epochs, at the
   full classification width (hidden 512, 256 filters, 10 Gaussians): the
   F=256 K1/K2 launches must grow in both stages and K3's in stage 2 only,
   no other width's kernel and no plain version may run, both buckets must
   run, the warm start must be bit-exact, losses finite, ``val_auroc`` and
   ``test_auroc`` in [0, 1], ``best`` at the epoch of the highest
   ``val_auroc``, ``predict.main``'s probabilities must be the sigmoid of
   the logits of the runner's test evaluation to 1e-6, and the AUROC of
   those logits and (where no probability is 0 or 1, which would tie) of
   the probabilities must equal the runner's ``test_auroc`` to 1e-6. These
   steps run as CUDA graphs too, with phase 5's checks on captures and
   launch counts.
8. CUDA graphs at full width: the flagship regression model in stage 1 and
   stage 2 at N=32 and N=64 (B=24, K=5) and the classification model in
   stage 2 at N=32 (B=18). Each runs 20 synthetic batches eagerly and
   through ``StepGraphs`` from identical weights, with the lr halved by
   ``set_learning_rate`` after 10 steps: per-step losses and final weights
   must agree to 1e-5 relative (bit-identity is printed), the launch counts
   must be equal, and the eval graph's predictions must equal eager eval's
   to 1e-6. The eager steps take pre-packed batches, the graphed ones the
   host pipeline's (prefetch, native packing into pinned slots,
   non-blocking copies). Then 25 warmed steps a turn give ms per step and
   graphs/s by host clock ending in a synchronise, in turns eager,
   graphed, pipelined, serial and back: eager and graphed steps on
   pre-packed batches copied from pageable memory, pipelined ones through
   the host pipeline, serial ones packed by numpy on the main thread and
   copied from pageable memory (``fit(prefetch=False, native=False)``'s
   path). One more pipelined turn splits its host time per step: waiting
   on the prefetch queue, the copy, waiting for a slot's earlier copy, and
   the replay with the rest; and the prefetch thread's native packing per
   batch (its foreign call apart), beside numpy packing. A sixth case is
   stage 1 at N=32 with sol250's stage-1 batch of 96. Stage 2 also profiles three graphed steps: busy share,
   kernels per step; the graph's K1/K2/K3 nodes must equal the launches
   its capture counted, and the executions the profiler sees must not
   exceed the launch counts (``graphed_launches``).
9. The host pipeline: the native packer against the numpy one, byte for
   byte, over every batch of ``data/sol250`` (batches 96 and 24) and
   ``data/sol1k_class`` (18), every split and bucket, also into a reused
   pinned buffer; then sol250's stage 1 through ``fit`` for 2 epochs from
   the same seeded model, through the pipeline and with ``prefetch=False,
   native=False``: losses and weights must agree bit for bit.
10. The ViSNet and DimeNet paths (``config/visnet/sol250_5*``,
   ``config/dimenet/sol250_5*``; neither launches K1 or K2). K3 against its
   plain version at DimeNet's alpha 0.5 on a fixed structure (the first
   conformer's cutoff-5 graph as C1 at every outer iteration), at N = 32
   and N = 64, first and second outer iteration, within phase 2's gate.
   Then per backbone: three eager steps of the runner's model at each
   config's batch on sol250's molecules of each bucket, stage 1 and 2, for
   ms per step and the peak memory; the runner's ``main`` for both stages
   (2 epochs each) with phase 5's checks, except that K1 and K2 must not
   launch and K3 must launch five times a stage-2 forward, and the peak
   memory of each stage; ``predict.main`` on stage 2's ``best`` against the
   runner's test RMSE; one stage-2 step on the card against the CPU (phase
   4's gates) at the stage-2 config's batch; and phase 8's case for stage 2
   at N = 32 at that batch (24 for ViSNet, 16 for DimeNet), with its timed
   turns and the profile of three graphed steps.
11. The ESAN variants and the aux head families (``models/esan.py``,
   ``models/aux_heads.py``). K1 and K2 against the plain version on the
   info-sharing SchNet's input, the averaged conformers of a sol250 batch
   of 32 (G = 32) at N = 32 and N = 64, whose atoms lie at 0.02-0.2 A
   (``avg-N32``/``avg-N64`` rows); the cap must bind at N = 64. The
   runner's ``main`` trains stage 1 of ``config/esan/sol250_avg_conf.yaml``
   and ``sol250_geometry.yaml`` (2 epochs, batch 32) with phase 5's checks,
   except that K1 must launch exactly twelve times a forward (train or
   eval) and K2 twelve a train step, and K3 never; ``predict.main`` on
   each ``best`` must give the runner's test RMSE to 1e-6; prints epoch
   times, ms per step by bucket and each run's peak memory. Then each of
   the eight families (the three ESAN variants, ``scalars``,
   ``embeddings``, ``covalent``, ``attention``, ``gat_only``) at N = 32 and
   N = 64 on sol250's molecules at batch 32, stage 1: one step on the card
   against the CPU (phase 4's gates) on 16 of the batch's molecules (the
   attention head: all 32); 12 steps eager against graphed (the
   host pipeline) through an lr change, to phase 8's gates, with equal
   launch counts (K1 and K2 as many a step as the family's SchNets have
   radius-graph interactions: 12 for the first two ESAN variants, 6 for
   the third, ``scalars`` and ``covalent``, whose covalent blocks are plain
   PyTorch, 3 for ``embeddings`` and ``attention``, 0 for ``gat_only``)
   and the barycenter heads unchanged; the eval graph against eager eval;
   ms per step eager and graphed in turns, each run's peak memory, and a
   profile of three graphed steps (busy share; the graph's nodes and the
   profiler's executions back the launch counts, as in phase 8).
12. bf16 compute (``compute_dtype: bfloat16``). K1 and K2's bf16 variants
   (bf16 node features and cotangent, f32 weights; counted as
   ``cfconv_fwd_bf16``, ``cfconv_bwd_bf16``, ``cfconv_fwd_f256_bf16`` and
   ``cfconv_bwd_f256_bf16``) against the bf16 plain version on phase 2's
   inputs at F=128 (G=120) and F=256 (G=90), N=32 and N=64: ``out`` and
   ``dx`` equal the f32 kernels' results on the widened inputs rounded to
   bf16 bit for bit, and lie within one bf16 ulp of the plain version's
   beyond the distance of the two f32 results they round (that distance
   within ``CFCONV_RTOL`` of the largest; the share of elements that differ
   is printed); the weight gradients within ``CFCONV_RTOL``; K2 twice
   bit-identical; times and bounds as in phase 2. The flagship at
   ``bench.py``'s ``mixed_precision`` shape (B=24, K=5, N=32) with a bf16
   trunk: one stage-2 step card against CPU (phase 4's gates), phase 8's case (20 steps
   eager against graphed through an lr change, the eval graph, timed turns
   beside phase 8's f32 figures, the profile), and the peak memory of eager
   steps in f32 and bf16. The runner's ``main`` on bf16 copies of
   ``config/schnet/sol250_5.yaml`` and ``sol250_5_bc.yaml`` (2 epochs each)
   with phase 5's checks, where only the bf16 K1/K2 and K3 may launch, and
   predict on stage 2's best, beside phase 5's f32 test RMSE. The
   classification model (F=256) in bf16: one stage-2 step card against CPU
   at batch 18, and phase 8's case. DimeNet with bf16 triplet tensors
   (``config/dimenet/sol250_5_bc.yaml`` with ``compute_dtype: bfloat16``):
   one stage-2 step card against CPU at batch 16, phase 8's case beside
   phase 10's f32 figures, the peak memory of eager steps in f32 and bf16
   at N=32, and at ``bench.py``'s ``dimenet_n96_bf16`` shape (B=8, N=96),
   where 20 steps at the config's lr, in bf16 and in f32, must stay finite
   (the model starts near 1e20 at random weights, so this shows only that
   nothing reaches inf).
13. The per-molecule FGW path and the rest of the solver
   (``ops/fgw/``, ``ops/cuda/fgw.py::fgw_couplings``). K3 through its
   per-molecule wrapper (counted as ``fgw_couplings_mol``; the padding of a
   molecule's n atoms to a multiple of 32 left out of the solve) against
   the unpadded plain solve on the CPU at K = 5, n = 11, 32 and 53: the
   plans within ``FGW_ATOL``, equal diverged counts, one launch a call; its
   eager and graph-replay time and bound. The per-molecule
   ``fgw_barycenter`` (n = 23, K = 5) on the card against the same call on
   the CPU for the default options, ``warmstart=False`` with ``init_C``,
   ``fixed_features``, ``fixed_structure``, ``kl_loss`` and
   ``stop_grad_couplings=False``: Y and C within 1e-3, the gradient with
   respect to ``Ys`` within 1e-4 in norm, ``outer_iters`` K3 launches a
   call on K3's route and none on the plain one (launch counts zeroed just
   before and read just after: this slice's main path). The batched
   barycenter against per-molecule calls on the card. The seven solvers
   of ``ops/fgw/variants.py`` on the card against the CPU at the JAX
   tests' sizes. The deep budget through the runner's ``main``:
   ``config/schnet/sol1k_5.yaml`` and then ``sol1k_5_bc_deep.yaml`` (15
   outer x 10 PGD x 10 Sinkhorn iterations, eps 0.05), 2 epochs each, with
   phase 5's checks (K3 fifteen times a stage-2 forward), and one deep
   stage-2 step card against CPU within ``DEEP_STEP_RTOL``.
14. The GEOM path (``data/geom.py``, the runner's ``dataset: geom``). K1
   and K2 at N = 96 and N = 128 (F=128 with 50 Gaussians on G = 120, F=256
   with 10 on G = 90; f32 and bf16 node features; seeded molecules of
   65-121 atoms, the cap binding) with phase 2's and phase 12's gates, and
   K3 on the barycenter's second outer iteration there (S = 90), within
   ``FGW_ATOL``; these rows carry the shapes ``n96`` and ``n128`` in the
   result line. Then a synthetic CoV-2 set in the GEOM layout (80/12/12
   drug-like molecules of 65-128 atoms from ``SEED``, half in each bucket;
   ``.npz`` stores of 3-8 conformers embedded by ``dg_generate`` in a pool
   of processes; a few molecules without a store, re-embedded at every
   access) in a temporary directory; the runner's ``main`` on
   ``config/schnet/cov2_5.yaml`` and then ``cov2_5_bc.yaml`` (2 epochs
   each) with phase 6's checks, both large buckets in every epoch, and
   predict's AUROC equal to the runner's; one stage-2 step at N = 128
   (B = 18) card against CPU within phase 4's gate; and
   ``DimeNetGEOMExperiment``'s stage 1 (B = 8, 2 epochs) through the
   runner, where no kernel may launch. Prints ms per step by bucket, epoch
   times, the host time of ``GEOMDataset.records()`` and the peak memory by
   stage, step kind and bucket.
15. Data-parallel training (``parallel/``, ``train/loop.py::SplitStep``,
   the split train graphs of ``train/graphs.py``); the ranks are processes
   spawned by ``parallel/mesh.py::launch``. 15a: a one-rank NCCL group on
   the card runs 3 graphed flagship stage-2 steps (B=24, K=5, N=32) through
   the split step (two graphs around the all-reduce) and must give the
   single graph's losses, gradients and weights bit for bit. 15b: two ranks
   share the card over gloo (CUDA tensors, the all-reduce through the
   host); one global stage-2 step from the seeded model, 12 + 12 real rows
   and then 12 + 5 (the global denominator), against the single-process
   step on the card: the loss to 1e-6 relative, the global gradient norm
   to 1e-5, each parameter's gradient to 1e-4 in norm beyond
   ``PARAM_FLOOR`` of the global norm; K1/K2/K3 against their plain
   versions at the rank's shape (G = 60, N = 32; rows ``dp-N32``); 3
   graphed steps a rank, whose two train graphs' K1/K2/K3 nodes must equal
   the launches their capture counted, and each rank's graphed ms/step.
   15c: the runner's ``run_main`` on the two-rank mesh, ``sol250_5.yaml``
   then ``sol250_5_bc.yaml`` (2 epochs each, stage 2 warm-started, the warm
   start bit-exact on both ranks): equal summaries, trained weights
   bit-identical (``check_replicas`` and a digest), rank 0 alone writing,
   launches per rank K1 3 a forward, K2 3 a train step, K3 5 a stage-2
   forward, phase 5's host-pipeline checks, both buckets every epoch, and
   ``test_rmse`` within 2e-3 of phase 5's one-process run. 15d: 15b's
   graphed steps again in fresh processes (launched beside 15c), bit for
   bit. Two processes
   time-sharing one card show no data-parallel speed; the times printed
   are each rank's share.
16. The tools (``conan_fgw_tpu_torch/tools``) and the K=3 runner path.
   16a: ``python -m conan_fgw_tpu_torch.tools.prepare_data --builtin sol250
   --store_conformers 10`` into a temporary ``--data_root`` on half the
   host's CPUs, started before phase 15 and run beside phases 15 and 7 (it
   is waited for before 16b): its train/valid/test CSVs and every ``.npz`` store
   must be the repo's ``data/sol250`` byte for byte, its manifest 322
   molecules split 257/33/32; prints the seconds from its start to its
   end. 16b: K1/K2 at ``eval_geom_scale``'s shape (G = 480: 96 molecules x
   5 conformers, N = 32; rows ``eval-N32-G480``), and K1/K2 on G = 72 and 96 graphs and
   K3 on S = 72 and 96 solves (K = 3: sol250_3_bc's batch of 24 and
   sol250_3's and synthetic_e2e's of 32) at N = 32 and at N = 64 with the
   cap active, against their plain versions with phase 2's gates, times and
   bounds (rows ``K3-N32-G72`` ... and ``K3-N32-S72`` ...). 16c: the runner's
   ``main`` on ``config/schnet/sol250_3.yaml`` then ``sol250_3_bc.yaml`` (2
   epochs each) on 16a's data, with phase 5's checks (captures, exact
   K1/K2/K3 launches, no plain version, both buckets, the warm start bit
   for bit, finite ``test_rmse``) and ``--out_json`` summaries equal to the
   printed ones. 16d: ``tools.summarize_protocol`` over those two files
   prints a row each with its ``test_rmse`` mean. 16e:
   ``tools.synthetic_e2e --epochs 2 --size 64`` on the card (K = 3, B = 32),
   exact launches by stage, losses and both stages' test RMSE finite. 16f:
   ``tools.eval_geom_scale`` on 960 molecules (10 batches of 96, K = 5), K1
   three a forward and nothing else, the predictions finite and aligned
   with their records, the first 96 within ``STEP_RTOL`` of the same
   model's ``evaluate`` on the CPU; prints ``eval_epoch_s`` and
   ``molecules_per_s``.
17. The last of the JAX package in the port. 17a: K3 on the flat path
   (``fgw_couplings_flat``) at sizes that are no bucket, padded to the next
   multiple of 32 with the true n passed to K3: N = 22 at S = 2,560 (the
   demo's 256 x 10 solves), n = 11 and n = 53 at S = 120, against the plain
   unpadded solve (``FGW_ATOL``, flags equal, one launch a call), eager
   and graph-replay ms and the bound of the n x n work (rows
   ``N22-S2560``, ``n11-S120``, ``n53-S120``); a bucket size (N = 32) must
   reach K3 unpadded. 17b: ``examples/fgw_parity_demo_torch.py``'s ``main``
   on the card (one barycenter of K = 10 graphs at N = 22 timed ten times,
   then 256 at once): exact K3 launches (55 through the per-molecule
   wrapper, 10 flat), Y of both within the larger of 1e-3 and 1.5 times
   the CPU f32 solve's distance from a float64 CPU solve. 17c: float16
   compute: K1/K2's f16 variants (counted as ``cfconv_fwd_f16``,
   ``cfconv_bwd_f16``, ``cfconv_fwd_f256_f16``, ``cfconv_bwd_f256_f16``)
   at phase 12's shapes with phase 12's gates in f16 ulps (bit for bit the
   f32 kernels rounded; the plain version's f16 route, the filter MLP in
   f16 as JAX's XLA cfconv, within ``F16_ROUTE_RTOL``); the f16 flagship's
   graphed stage-2 step (B = 8, without the clip) against a CPU step in the
   f16 variants' arithmetic (loss and gradient within ``STEP_RTOL``) and
   against a float64 CPU step, no farther from it than 1.5 times the CPU's
   f16 route (the filter MLP in f16, JAX's XLA semantics) lies; f16 and f32
   graphed ms in turns at B = 24; one eager f16 classification step (F=256).
   17d: the nearest-neighbour cap: K1/K2 with ``cap_mode="nearest"`` at
   N = 64 (the cap binding) with phase 2's gates (rows ``N64-nearest``);
   K1's own neighbour sets (read from K1 with the filter fixed at 1 and
   one-hot features) against the plain version's, rows that differ
   allowed only at near ties (1e-5 A); the nearest-cap SchNet's stage-2
   step at N = 64 (B = 8) card against CPU (phase 4's gates) and three
   graphed steps against eager (phase 8's gate). 17e: ``remat``: three
   graphed flagship stage-2 steps bit for bit those of ``remat=False``,
   the train graph's K1 nodes 6 against 3 (K2 3); the peak memory of eager
   steps with and without remat at B = 24 and at ``bench.py``'s
   ``large_batch`` shape (B = 256, K = 5, N = 32, f32). 17f:
   ``accumulate_steps=4``: ``fit`` through CUDA graphs for one epoch of
   sol250's stage 1 at batch 32 (9 mini-steps, 2 updates, 1 pending):
   "train" and "train_update" graphs, Adam's count in ``last_state`` the
   updates, the weights within 1e-5 of the same fit stepped eagerly and
   within 1e-3 of it on the CPU (of the largest weight), and a second
   epoch resumed in the middle of the accumulation bit for bit the
   straight two-epoch run; ms per mini-step.
18. Molecules above 128 atoms and the last options. 18a: K1/K2 on their
   large route (``csrc/cfconv_wgmma.cu``, counted under ``_large`` names)
   at N = 160, 192, 256 and 181 (no multiple of 32), F=128 with 50
   Gaussians and F=256 with 10 on G = 90 seeded graphs of 109-251 atoms,
   the cap binding, with phase 2's gates; at N = 192 also the nearest cap
   and the bf16 and f16 variants with phase 12's and 17's gates (rows
   ``n160`` ... ``n192-nearest``); at N = 320 and 544 on G = 10 seeded
   point clouds that fill each N (the plain version's (G, N, N, F) filter
   is 1.5-3 GB there), both widths, phase 2's gates, the plain version's
   peak memory printed. 18b: K3's cluster route
   (``fgw_couplings_cluster_kernel``, counted under ``_cluster`` names) on
   the F=256 molecules (S = 90) at N = 160, 192 and 256, first and second
   outer iteration, and at N = 181 through ``fgw_couplings_flat`` (padded
   to 192), within ``FGW_ATOL``, flags equal, its cluster size, band rows,
   shared bytes and clusters the card holds printed, two launches on one
   input bit for bit equal; K3's stream route
   (``fgw_couplings_stream_kernel``, counted under ``_stream`` names) at
   N = 288 (the F=256 molecules, first and second outer iteration, two
   launches bit for bit equal, the global route's time on the same input
   beside it), at N = 320, 384 and 448 (seeded point clouds, first outer
   iteration) and at n = 270 through ``fgw_couplings_flat`` (padded to
   288), its plan, shared bytes, clusters at once and rounds at S = 90
   printed for every N it takes, and at N = 512 (point clouds, S = 90,
   first outer iteration, then a later one, ``later_inputs``, whose M
   differs from row to row, with the global route's time on that input
   beside it); the global route (``csrc/fgw_team.cu``'s
   ``fgw_couplings_team_kernel``) at N = 544 and N = 800 (no
   multiple of 64; S = 15, point clouds), above the stream route's 512,
   on the first outer iteration's input and on a later one's, the later
   plans also within ``FGW_REL`` of the plain plan's move from T0 (the
   first iteration's plans stay within about 1% of T0), at N = 544 with
   two launches on the later input bit for bit equal and a NaN planted in
   one of its T0 (rolled back, flagged, NaN positions equal), its plan
   (band rows, CTAs a team, teams at once, shared bytes, rounds) printed
   for every N and S it runs; K3' at n =
   150 (cluster), 270 (stream) and 520 (global); the per-molecule
   barycenter at n = 150, 270 and 520
   and the batched one at n = 270 and 520 on the card against the CPU,
   each counting its route's launches alone. 18c: a
   synthetic CoV-2 set of 36/8/8 molecules of 97-128 and 129-181 atoms in
   turn; the runner's ``main`` on ``cov2_5.yaml`` then ``cov2_5_bc.yaml``
   with ``max_atoms: 192`` (2 epochs each) with phase 14's checks, both the
   N = 128 and the N = 192 bucket every epoch, K1/K2/K3 counted over the
   small and large routes, and every train graph's K1/K2/K3 nodes equal to
   what its capture counted (the N = 192 graph's on the large kernels,
   K3's five on the cluster route and none on the team kernel);
   predict; one stage-2 step at N = 192 card against CPU. 18d: one graphed
   ``fit`` of the flagship (F=128, stage 2) with ``shuffle=True,
   bucketed=False``: every batch at N = 192 on the large kernels alone, and
   the batches it stepped equal to a CPU replay of ``batch_iterator`` under
   ``loop.epoch_rng``, molecule by molecule; the replays' ms a step beside
   the 18.32-19.01 of the kernels before K2 at F=128's wgmma kernel. 18e: one ViSNet stage-2 step
   with ``vertex``, ``vecnorm_type="max_min"``, ``trainable_vecnorm`` and
   ``trainable_rbf`` card against CPU (phase 4's gates). 18f: two graphed
   stage-2 steps at N = 192 of the F=128 and the F=256 model in bf16 and
   in f16, each launching its own large variants, then the ms a step of
   ``BIG_TIMED`` replays of each graph.
7. Reproducibility: two fresh processes run the same seeded stage-1 and
   stage-2 steps on ``data/sol250``, stage-2 steps of the seeded ViSNet
   and DimeNet models, stage-1 steps of the geometry ESAN and the
   covalent head at batch 32, and stage-2 steps of the bf16 flagship,
   eagerly and then through CUDA graphs fed by
   the host pipeline, and must give bit-identical batches, losses,
   gradients and weights; a
   third runs the eager steps under
   ``torch.use_deterministic_algorithms(True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and must finish. The three
   processes run at once.

Then it prints the per-kernel JSON line (every kernel, each width, type
and shape held, with its launches on each runner path; the bf16 variants'
``launches`` are those of phase 12's runner, K3's per-molecule wrapper's
those of phase 13's per-molecule barycenters; the f16 variants' those of phase
17's f16 flagship and classification steps; ``geom_launches`` those of
phase 14's runners, ``dp_launches`` rank 0's in phase 15's,
``tools_launches`` phase 16's runner, synthetic_e2e and eval_geom_scale's,
also on the ``[done]`` line, ``f16_launches`` phase 17's and
``phase18_launches`` phase 18's; the large routes' ``launches`` are phase
18's and their row N = 192's, n = 150's for K3' on the cluster route,
N = 288's and n = 270's on the stream route, N = 544's and n = 520's on the
global route), the card
line and, last,
``{"ok": true, "device": {...}}``.

Launch counts under CUDA graphs: a kernel's wrapper counts once while a
graph is captured and does not run when the graph is replayed, so each
graph adds its capture's counts once per later replay
(``train/graphs.py::LaunchReplays``). The counts of phases 3, 5 and 6
(``launches``, ``runner_launches``, ``classification_launches``) and of
phase 12 are derived so. Phases 8 and 11 back them with the graph itself: its K1/K2/K3
kernel nodes, read from its ``debug_dump``, must equal the launches its
capture counted, as every node runs once a replay; the profiler's count
of executions over three replays must not exceed the derived counts and
must see each of those kernels run (it drops a few device records of a
window, so it may fall short).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
B, K = 24, 5
CUTOFF, GAUSS, CAP, F = 10.0, 50, 32, 128
FGW_KW = dict(alpha=0.1, epsilon=0.1, pgd_iters=5, pgd_tol=1e-4, sinkhorn_iters=5,
              sinkhorn_thr=1e-2)
# the deep budget of config/schnet/sol1k_5_bc_deep.yaml: epsilon 0.05, 10 PGD
# steps of 10 Sinkhorn iterations
FGW_DEEP_KW = dict(FGW_KW, epsilon=0.05, pgd_iters=10, sinkhorn_iters=10)
# the classification model's cfconv: 256 filters, 10 Gaussians, and
# sol1k_class's batch of 18 molecules of K = 5 conformers (G = 90 graphs)
F_CLS, GAUSS_CLS, B_CLS = 256, 10, 18
# published H100 SXM peaks: f32 on the CUDA cores, TF32 on the tensor cores
# (dense), HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# tolerances of the kernel checks
CFCONV_RTOL = 5e-4  # max |kernel - plain| / max |plain|, the TPU kernel's contract
FGW_ATOL = 2.5e-6   # plans, absolute; diverged flags exactly
# plans of a later outer iteration (``later_inputs``) also within this share
# of the plain plan's largest move from T0: a plan left at T0, or a band of
# it left unwritten, misses it by a factor of 1,000
FGW_REL = 1e-3
# step parity (kernels on the card vs plain on the CPU): the loss and the
# global gradient norm to 1e-3 (the barycenter's bound); each parameter's
# gradient norm to 1e-2, with an absolute floor of 1e-6 of the global norm
# (the second GAT layer's attention vectors get gradients near 1e-8, where
# CPU and card round differently)
STEP_RTOL, PARAM_RTOL, PARAM_FLOOR = 1e-3, 1e-2, 1e-6

REPLACES = {
    "cfconv_fwd": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    "fgw_couplings": "conan_fgw_tpu/ops/pallas/fgw.py:362",
    # K3 through the per-molecule wrapper (padded to a multiple of 32)
    "fgw_couplings_mol": "conan_fgw_tpu/ops/pallas/fgw.py:394",
    "cfconv_fwd_f256": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd_f256": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    # the bf16 variants (bf16 node features: the Pallas kernels' x, out, g
    # and dx in a bf16 trunk, compute_dtype: bfloat16)
    "cfconv_fwd_bf16": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd_bf16": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    "cfconv_fwd_f256_bf16": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd_f256_bf16": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    # the f16 variants (compute_dtype: float16, which the JAX model sends to
    # its XLA cfconv; the kernels it replaces are the Pallas ones all the same)
    "cfconv_fwd_f16": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd_f16": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    "cfconv_fwd_f256_f16": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd_f256_f16": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    # graphs above 128 atoms (phase 18): K3's cluster route (129-256 atoms),
    # its stream route (257-512) and its global route (above 512), through
    # both wrappers, and K1/K2 at both widths and types: csrc/cfconv_wgmma.cu's
    "fgw_couplings_cluster": "conan_fgw_tpu/ops/pallas/fgw.py:362",
    "fgw_couplings_mol_cluster": "conan_fgw_tpu/ops/pallas/fgw.py:394",
    "fgw_couplings_stream": "conan_fgw_tpu/ops/pallas/fgw.py:362",
    "fgw_couplings_mol_stream": "conan_fgw_tpu/ops/pallas/fgw.py:394",
    "fgw_couplings_large": "conan_fgw_tpu/ops/pallas/fgw.py:362",
    "fgw_couplings_mol_large": "conan_fgw_tpu/ops/pallas/fgw.py:394",
    **{f"cfconv_{kind}{width}_large{dtype}": f"conan_fgw_tpu/ops/pallas/cfconv.py:{line}"
       for kind, line in (("fwd", 223), ("bwd", 146)) for width in ("", "_f256")
       for dtype in ("", "_bf16", "_f16")},
}
# csrc/cfconv_wgmma.cu's kernels of K1, and of K2 at F=256, above 128 atoms
# (graph nodes, ptxas)
WGMMA_KERNELS = ("cfconv_msg_wgmma_kernel", "cfconv_dw_wgmma_kernel")
# csrc/cfconv_wgmma.cu's kernel of K2 at F=128 above 128 atoms
LARGE_BWD_KERNEL = "cfconv_bwd_wgmma_kernel"
# csrc/fgw_team.cu's kernel of K3 above 512 atoms (the global route)
TEAM_KERNEL = "fgw_couplings_team_kernel"
# the launch names of phase 18's routes above 128 atoms
LARGE_NAMES = tuple(name for name in REPLACES if name.endswith(("_large", "_large_bf16",
                                                                "_large_f16", "_cluster",
                                                                "_stream")))
SOURCES = {
    "cfconv_fwd": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "fgw_couplings": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "fgw_couplings_mol": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "cfconv_fwd_f256": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd_f256": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_fwd_bf16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd_bf16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_fwd_f256_bf16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd_f256_bf16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_fwd_f16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd_f16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_fwd_f256_f16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd_f256_f16": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "fgw_couplings_cluster": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "fgw_couplings_mol_cluster": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "fgw_couplings_stream": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "fgw_couplings_mol_stream": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "fgw_couplings_large": "conan_fgw_tpu_torch/csrc/fgw_team.cu",
    "fgw_couplings_mol_large": "conan_fgw_tpu_torch/csrc/fgw_team.cu",
    **{name: "conan_fgw_tpu_torch/csrc/cfconv_wgmma.cu" for name in LARGE_NAMES
       if name.startswith("cfconv")},
}
# seconds between the edges of the profiler's window and the steps it profiles
PROFILE_MARGIN_S = 0.05
# the kernels of the regression path (phases 3 and 5) and of the
# classification path (phase 6)
REGRESSION = ("cfconv_fwd", "cfconv_bwd", "fgw_couplings")
CLASSIFICATION = ("cfconv_fwd_f256", "cfconv_bwd_f256", "fgw_couplings")
# the same two paths in bf16 compute (phase 12)
REGRESSION_BF16 = ("cfconv_fwd_bf16", "cfconv_bwd_bf16", "fgw_couplings")
CLASSIFICATION_BF16 = ("cfconv_fwd_f256_bf16", "cfconv_bwd_f256_bf16", "fgw_couplings")
# and in f16 compute (phase 17)
REGRESSION_F16 = ("cfconv_fwd_f16", "cfconv_bwd_f16", "fgw_couplings")
CLASSIFICATION_F16 = ("cfconv_fwd_f256_f16", "cfconv_bwd_f256_f16", "fgw_couplings")
# the f16 kernels against the plain version's f16 route (the filter MLP in
# f16, as JAX's XLA cfconv computes an f16 trunk): it lies about 2e-3 of the
# largest from the f32 result rounded at phase 2's shapes (a CPU measurement)
F16_ROUTE_RTOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Mean milliseconds per call with the host out of the way: ``reps``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events. ``fn`` must have been called before (warm-up)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """Least ms for the work: the bytes over the memory rate against the
    operations, ``tc_flops`` of them over the TF32 tensor-core peak and the
    rest over the f32 CUDA-core peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, tc_flops / PEAK_TF32 + (flops - tc_flops) / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_build():
    from conan_fgw_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, built_s = _build.build()
    _build.load_library()
    print(f"[build] {path.name}: nvcc {built_s:.1f} s, total {time.perf_counter() - t0:.1f} s")
    from conan_fgw_tpu_torch.data import native

    t0 = time.perf_counter()
    packer = native.build()
    native.load_library()
    print(f"[build] {packer.name}: the native packer, g++ and load {time.perf_counter() - t0:.1f} s")
    report = _build.BUILD_DIR / path.name.replace("libconan_kernels_", "ptxas_").replace(".so", ".txt")
    if report.exists():
        entry, spills = "", {}
        for line in report.read_text().splitlines():
            shown = "Compiling entry" in line or "registers" in line or "spill" in line
            if shown and "C7519" not in line:  # not ptxas's notes of warpgroup arrives
                print("[ptxas]", line.strip())
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "spill" in line and ("cfconv" in entry or "fgw_couplings" in entry):
                spills[entry] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        print(f"[ptxas] spill bytes (stores + loads) by kernel: {spills}")
        require(any("fgw_couplings_kernel" in e for e in spills), "no ptxas report for K3")
        require(any(TEAM_KERNEL in e for e in spills)
                and any("fgw_couplings_cluster_kernel" in e for e in spills)
                and any("fgw_couplings_stream_kernel" in e for e in spills)
                and all(any(k in e for e in spills) for k in (*WGMMA_KERNELS, LARGE_BWD_KERNEL)),
                "no ptxas report for the large-N kernels")
        require(spills and not any(spills.values()), "a kernel spills registers")


# ---------------------------------------------------------------- phase 2
def packed_geometry(seed, n_mols, heavy, n_atoms, device, k=K):
    """Positions and masks of packed synthetic molecules of ``k``
    conformers: (B*k, N, 3), (B*k, N)."""
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset

    recs = random_dataset(seed, n_mols, num_conformers=k, heavy_range=heavy, device=device)
    pb = pack_batch(recs, max_atoms=n_atoms, batch_size=n_mols).to(device)
    pos = pb.pos.reshape(-1, n_atoms, 3).contiguous()
    mask = pb.atom_mask.repeat_interleave(k, dim=0)
    return pos, mask


def count_edges(pos, mask, cap, cap_mode="index"):
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    return int(radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, cap, cap_mode).sum())


def cfconv_params(G, N, gen, dev, F=F, GAUSS=GAUSS):
    """Seeded features, filter weights and cotangent: ``x, w1, b1, w2, b2, cot``."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cpu") * scale).to(dev)

    x = rnd(G, N, F)
    w1, b1 = rnd(GAUSS, F, scale=(6 / (GAUSS + F)) ** 0.5), rnd(F, scale=0.1)
    w2, b2 = rnd(F, F, scale=(3 / F) ** 0.5), rnd(F, scale=0.1)
    return x, w1, b1, w2, b2, rnd(G, N, F)


def bf16_ulp(t, bits=8, tiny=0.0):
    """The spacing of bf16 values at each element of ``t`` (f32): 2^(e - 8)
    for ``t = m 2^e``, ``0.5 <= |m| < 1``; 0 at 0. ``bits`` 11 and ``tiny``
    2^-24 give f16's (whose subnormals are spaced 2^-24)."""
    import torch

    mant, exp = torch.frexp(t.float())
    ulp = torch.where(mant == 0, torch.zeros_like(t.float()),
                      torch.ldexp(torch.ones_like(mant), exp - bits))
    return ulp.clamp_min(tiny)


def type_ulp(t, dtype):
    """The spacing of ``dtype`` (bf16 or f16) values at each element of ``t``."""
    import torch

    return bf16_ulp(t) if dtype == torch.bfloat16 else bf16_ulp(t, 11, 2.0**-24)


def check_cfconv(label, pos, mask, gen, rows, F=F, GAUSS=GAUSS, dtype=None, cap_mode="index",
                 plain_reps=10):
    """K1 and K2 against the plain version at one shape; ``F``/``GAUSS``
    pick the width (the classification model's is 256 filters and 10
    Gaussians), whose rows go under its launch-count names. With ``dtype``
    bf16, the node features and the cotangent are bf16 (phase 12): ``out``
    and ``dx`` must equal bit for bit the f32 kernels' results on the
    widened inputs rounded to bf16, and lie within one bf16 ulp of the plain
    version's, element by element, beyond the distance of the two f32
    results they round (an element that cancels to 1e-6 of the largest
    differs by many of its own ulps in f32 already; that distance is held to
    ``CFCONV_RTOL`` of the largest). The weight gradients (f32) are held to
    ``CFCONV_RTOL`` and must equal the f32 kernel's bit for bit. With
    ``dtype`` f16 (phase 17) the same, in f16 ulps, against the plain
    version of the f16 variants' arithmetic (the f32 plain version on the
    widened inputs, rounded); ``_cfconv_plain``'s own f16 route (the filter
    MLP in f16, as JAX's XLA cfconv) must lie within ``F16_ROUTE_RTOL``.
    ``cap_mode`` "nearest" (phase 17) runs the kernels and the plain version
    with the nearest-neighbour cap; its rows go under ``label``. Above 128
    atoms the kernels are those of ``ops/cuda/cfconv.py::route``
    (csrc/cfconv_wgmma.cu's), under their ``_large`` names; ``plain_reps``
    cuts the plain version's timed (and warm-up) calls there. Two launches
    of K2 (and above 128 atoms of K1) on the same inputs must agree bit for
    bit. Prints the plain version's peak memory beyond what was held
    before its forward and backward."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.cfconv import (
        LARGEST_TEMPLATE,
        _cfconv_plain,
        cfconv_backward,
        cfconv_forward,
        kernel_name,
    )

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    f16 = dtype == torch.float16
    narrow = bf16 or f16
    tag = f"{label} F{F}" + (" bf16" if bf16 else " f16" if f16 else "")
    G, N, _ = pos.shape
    maskf = mask.to(torch.float32).contiguous()
    x, w1, b1, w2, b2, cot = cfconv_params(G, N, gen, pos.device, F, GAUSS)
    x, cot = x.to(dtype), cot.to(dtype)
    out_k = cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP, cap_mode)
    out_again = (cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP, cap_mode)
                 if N > LARGEST_TEMPLATE else out_k)
    grads_k = cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP, cap_mode)
    grads_again = cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP, cap_mode)
    torch.cuda.synchronize()
    same = [n for n, a, b in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), (out_k, *grads_k),
                                 (out_again, *grads_again)) if torch.equal(a, b)]
    print(f"[cfconv {tag}] {'fwd and ' if N > LARGEST_TEMPLATE else ''}bwd twice on the same"
          f" inputs: bit-identical {same}")
    require(len(same) == 6, f"cfconv {tag} is not deterministic")
    require(out_k.dtype == grads_k[0].dtype == dtype
            and all(t.dtype == torch.float32 for t in grads_k[1:]),
            f"cfconv {tag}: out {out_k.dtype}, grads {[t.dtype for t in grads_k]}")
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    if f16:
        # the f16 variants' plain version: the f32 one on the widened
        # inputs, rounded (autograd then rounds dx to f16 too)
        out_p = _cfconv_plain(pos, maskf, leaves[0].float(), *leaves[1:], CUTOFF, GAUSS, CAP,
                              cap_mode).to(dtype)
    else:
        out_p = _cfconv_plain(pos, maskf, *leaves, CUTOFF, GAUSS, CAP, cap_mode)
    grads_p = torch.autograd.grad(out_p, leaves, cot)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)

    err_fwd = float((out_k.float() - out_p.detach().float()).abs().max())
    rel_fwd = rel(out_k, out_p.detach())
    rels_bwd = {n: rel(a, b) for n, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads_k, grads_p)}
    err_bwd = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads_k, grads_p))
    print(f"[cfconv {tag}] fwd max_abs_err {err_fwd:.3e} rel {rel_fwd:.3e} (tol {CFCONV_RTOL})")
    print(f"[cfconv {tag}] bwd rel errors "
          + " ".join(f"{n} {v:.3e}" for n, v in rels_bwd.items()) + f" (tol {CFCONV_RTOL})")
    if narrow:
        # the bf16 and f16 variants widen, compute as the f32 ones and round once
        kind = "bf16" if bf16 else "f16"
        wide = [t.float().contiguous() for t in (x, cot)]
        out_w = cfconv_forward(pos, maskf, wide[0], w1, b1, w2, b2, CUTOFF, CAP, cap_mode)
        grads_w = cfconv_backward(pos, maskf, wide[0], w1, b1, w2, b2, wide[1], CUTOFF, CAP,
                                  cap_mode)
        equal = [torch.equal(out_k, out_w.to(dtype)), torch.equal(grads_k[0], grads_w[0].to(dtype)),
                 *(torch.equal(a, b) for a, b in zip(grads_k[1:], grads_w[1:]))]
        print(f"[cfconv {tag}] against the f32 kernels on the widened inputs, rounded: bit-identical"
              f" out, dx, dw1, db1, dw2, db2 {equal}")
        require(all(equal), f"cfconv {tag}: the {kind} variants differ from the f32 kernels rounded")
        leaves32 = [t.float().requires_grad_(True) for t in leaves]
        out_p32 = _cfconv_plain(pos, maskf, *leaves32, CUTOFF, GAUSS, CAP, cap_mode)
        dx_p32 = torch.autograd.grad(out_p32, leaves32[0], wide[1])[0]
        for name, k, p, k32, p32 in (("out", out_k, out_p.detach(), out_w, out_p32.detach()),
                                     ("dx", grads_k[0], grads_p[0], grads_w[0], dx_p32)):
            k, p = k.float(), p.float()
            ulp = torch.maximum(type_ulp(k, dtype), type_ulp(p, dtype))
            beyond = float(((k - p).abs() - (k32 - p32).abs()).div(ulp.clamp_min(1e-38)).max())
            over = float(((k - p).abs() > ulp).to(torch.float32).mean())
            differ = float((k != p).to(torch.float32).mean())
            f32_rel = rel(k32, p32)
            print(f"[cfconv {tag}] {name}: {100 * differ:.3f}% of elements differ from the plain"
                  f" version's, {100 * over:.4f}% by more than one {kind} ulp; at most {beyond:.2f}"
                  f" ulp beyond the f32 results' distance (tol 1), which is {f32_rel:.3e} of the"
                  f" largest (tol {CFCONV_RTOL})")
            require(beyond <= 1.0 and f32_rel <= CFCONV_RTOL,
                    f"cfconv {tag} {name} is more than one {kind} ulp off")
        if f16:
            route = _cfconv_plain(pos, maskf, x, w1, b1, w2, b2, CUTOFF, GAUSS, CAP, cap_mode)
            route_rel = rel(out_k, route)
            print(f"[cfconv {tag}] out against the plain version's f16 route (the filter MLP in"
                  f" f16, as JAX's XLA cfconv): {route_rel:.3e} of the largest (tol"
                  f" {F16_ROUTE_RTOL})")
            require(route_rel <= F16_ROUTE_RTOL, f"cfconv {tag}: the f16 route is {route_rel} off")
    else:
        require(rel_fwd <= CFCONV_RTOL, f"cfconv {tag} forward disagrees: {rel_fwd}")
    for n, v in rels_bwd.items():
        require(narrow and n == "dx" or v <= CFCONV_RTOL, f"cfconv {tag} backward {n} disagrees: {v}")

    edges = count_edges(pos, mask, CAP, cap_mode)
    fwd_ms = cuda_ms(lambda: cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP, cap_mode))
    bwd_ms = cuda_ms(lambda: cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP,
                                             cap_mode))
    plain_fwd_ms = cuda_ms(lambda: _cfconv_plain(pos, maskf, x, w1, b1, w2, b2, CUTOFF, GAUSS, CAP,
                                                 cap_mode), reps=plain_reps,
                           warmup=min(2, plain_reps))

    def plain_bwd():
        o = _cfconv_plain(pos, maskf, *leaves, CUTOFF, GAUSS, CAP, cap_mode)
        torch.autograd.grad(o, leaves, cot)

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_bwd_ms = cuda_ms(plain_bwd, reps=plain_reps, warmup=min(2, plain_reps))
    plain_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    w_bytes = 4 * (GAUSS * F + F * F + 2 * F)
    feat = x.element_size()  # x, out, the cotangent and dx
    io_fwd = 4 * (G * N * 3 + G * N) + feat * 2 * G * N * F + w_bytes
    io_bwd = 4 * (G * N * 3 + G * N) + feat * 3 * G * N * F + 2 * w_bytes
    # the filter MLP's products (tensor cores in the kernels) and the rest
    mlp_fwd, mlp_bwd = edges * 2 * (GAUSS * F + F * F), edges * (4 * GAUSS * F + 6 * F * F)
    flops_fwd, flops_bwd = mlp_fwd + edges * 2 * F, mlp_bwd + edges * 4 * F
    print(f"[cfconv {tag}] G={G} N={N} F={F} Gs={GAUSS} edges={edges}: fwd {fwd_ms:.4f} ms"
          f" (plain {plain_fwd_ms:.4f}), bwd {bwd_ms:.4f} ms (plain fwd+bwd {plain_bwd_ms:.4f},"
          f" peak {plain_peak:.2f} GiB)")
    for name, ms, plain_ms, err, io, flops, mlp in (
        (kernel_name("cfconv_fwd", F, dtype, N > LARGEST_TEMPLATE), fwd_ms, plain_fwd_ms, err_fwd,
         io_fwd, flops_fwd, mlp_fwd),
        (kernel_name("cfconv_bwd", F, dtype, N > LARGEST_TEMPLATE), bwd_ms, plain_bwd_ms, err_bwd, io_bwd, flops_bwd,
         mlp_bwd),
    ):
        tc, f32 = bound(io, flops, mlp), bound(io, flops)
        print(f"[cfconv {tag}] {name}: bound {tc[0]:.5f} ms on the tensor cores"
              f" ({100 * tc[0] / ms:.1f}% reached), {f32[0]:.5f} ms in f32 on the CUDA cores"
              f" ({100 * f32[0] / ms:.1f}%); {flops / ms / 1e9:.1f} TFLOP/s")
        rows[name][label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=tc, bound_f32=f32)


def fgw_problem(pos, mask, gen, masked=False, cutoff=CUTOFF, k=K):
    """K3's inputs at the barycenter's first outer iteration: ``(Ms, C1, C2,
    ps, qs, T0)`` over ``S = B*K`` solves, with the conformer graphs' 0/1
    neighbour structure as C2 and the first conformer's as C1, random
    features, uniform marginals and the product plan as T0. ``masked``
    gives the marginals and features of ``bary_pad_mode: masked``
    (``models/heads.py``): mass 1/n on a molecule's n atoms and none on its
    padding rows, whose features are 0. ``k`` is the conformers a molecule
    (``K`` by default). Also returns the features ``Ys (B, K, N, D)`` and
    structures ``Cs (B, K, N, N)``."""
    import torch

    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    dev = pos.device
    S, N, _ = pos.shape
    nbr = radius_graph_mask(pairwise_distances(pos), mask, cutoff, CAP)
    Cs = nbr.transpose(-1, -2).to(torch.float32).reshape(-1, k, N, N)
    Ys = (torch.rand(S // k, k, N, F // 2, generator=gen) * 1.9 + 0.1).to(dev)
    p = torch.full((S // k, N), 1.0 / N, device=dev)
    if masked:
        atoms = mask.reshape(-1, k, N)[:, 0].to(torch.float32)
        p = atoms / atoms.sum(-1, keepdim=True).clamp(min=1.0)
        Ys = Ys * atoms[:, None, :, None]
    Ms = sqdist(torch.zeros_like(Ys[:, 0])[:, None], Ys).reshape(S, N, N).contiguous()
    C1 = Cs[:, :1].expand(-1, k, N, N).reshape(S, N, N).contiguous()
    C2 = Cs.reshape(S, N, N).contiguous()
    ps = p[:, None].expand(-1, k, N).reshape(S, N).contiguous()
    qs = ps.clone()
    T0 = (ps[:, :, None] * qs[:, None, :]).contiguous()
    return (Ms, C1, C2, ps, qs, T0), Ys, Cs


def second_outer_inputs(args, Ys, Cs, kw=FGW_KW, fixed_structure=False):
    """K3's inputs at the barycenter's second outer iteration: one plain
    coupling call on the first iteration's ``args``, then the feature and
    structure update of ``ops/fgw/barycenter.py`` (uniform weights and
    marginals): M from the updated features, the dense updated structure as
    C1 (with ``fixed_structure``, the first iteration's C1 again), and the
    first iteration's plans as T0."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_plain
    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist

    _, _, C2, ps, qs, _ = args
    Bm, Km, N, _ = Cs.shape
    T, _ = fgw_couplings_plain(*args, **kw)
    T = T.reshape(Bm, Km, N, N)
    p = ps.reshape(Bm, Km, N)[:, 0]
    lambdas = torch.full((Bm, Km), 1.0 / Km, device=Ys.device)
    Y = (1.0 / p)[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T, Ys)
    Ms = sqdist(Y[:, None], Ys).reshape(-1, N, N).contiguous()
    if fixed_structure:
        C1 = args[1]
    else:
        C = torch.einsum("bk,bknm,bkmj,bklj->bnl", lambdas, T, Cs, T) / (p[:, :, None] * p[:, None, :])
        C1 = C[:, None].expand(Bm, Km, N, N).reshape(-1, N, N).contiguous()
    return Ms, C1, C2, ps, qs, T.reshape(-1, N, N).contiguous()


def later_inputs(args, Ys, gen):
    """K3's inputs of a later outer iteration: ``args`` with M from random
    barycenter features in [0.1, 1.1) (as ``mol_args`` draws them), which
    differ from row to row. At the first outer iteration (``fgw_problem``)
    the barycenter's features are 0, so M is the same down every column,
    the potentials absorb it and the plan stays within about 1% of T0;
    here the plan moves far from T0 (at N = 544 to entries near 1/N)."""
    import torch

    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist

    Bm, _, N, D = Ys.shape
    Y0 = (torch.rand(Bm, 1, N, D, generator=gen) + 0.1).to(Ys.device)
    return (sqdist(Y0, Ys).reshape(-1, N, N).contiguous(), *args[1:])


def fgw_limit(T_p, T0, rel):
    """The plans' gate and the plain plan's largest move from ``T0`` (NaN
    left out): ``FGW_ATOL``, and with ``rel`` no more than ``FGW_REL`` of
    that move."""
    moved = float((T_p - T0).nan_to_num(0.0).abs().max())
    return (min(FGW_ATOL, FGW_REL * moved) if rel else FGW_ATOL), moved


def fgw_bound(S, N, sk_run, kw=FGW_KW):
    """Least ms for ``S`` solves at ``N`` that ran ``sk_run`` Sinkhorn
    iterations in all, with the two products on the tensor cores (as the
    kernel runs them) and, second, all in f32 on the CUDA cores. Per solve
    and PGD step: two N^3 products (2 flops per FMA), then about 15
    operations per element for the gradient assembly, the first Sinkhorn
    iteration's marginal check and the candidate plan; per Sinkhorn
    iteration run, two log-sum-exp sweeps of 5 operations per element.
    Bytes: M, C1, C2, T0 and T, p and q, the two flags."""
    products = S * kw["pgd_iters"] * 4 * N**3
    flops = products + S * kw["pgd_iters"] * 15 * N * N + sk_run * 10 * N * N
    nbytes = 4 * (5 * S * N * N + 2 * S * N) + 2 * 4 * S
    return bound(nbytes, flops, products), bound(nbytes, flops)


def check_fgw(label, args, rows, kw=FGW_KW, rel=False):
    """K3 against its plain version on one set of coupling inputs, with the
    solver budget ``kw``; with ``rel`` also within ``FGW_REL`` of the plain
    plan's move from T0 (``fgw_limit``)."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import _couplings, fgw_couplings_plain, launch_name

    S, N, _ = args[0].shape
    name = launch_name("fgw_couplings", N)
    T_k, (div_k, sk_iters) = _couplings(*args, **kw)
    T_p, (div_p, _) = fgw_couplings_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    limit, moved = fgw_limit(T_p, args[5], rel)
    flags_equal = bool(torch.equal(div_k, div_p))
    sk_run = int(sk_iters.sum())
    print(f"[fgw {label}] T max_abs_err {err:.3e} (tol {limit:.3e}; the plain plan moved"
          f" {moved:.3e} from T0); diverged kernel {int(div_k.sum())} plain {int(div_p.sum())};"
          f" {sk_run} Sinkhorn iterations run of {S * kw['pgd_iters'] * kw['sinkhorn_iters']}"
          f" budgeted")
    require(err <= limit, f"fgw {label} plans disagree: {err}")
    require(flags_equal, f"fgw {label} diverged flags disagree")
    # eager calls leave the card waiting for the host between launches once
    # the kernel is shorter than the wrapper's host time: graph replays give
    # the kernel's own time beside the eager one
    ms = cuda_ms(lambda: _couplings(*args, **kw))
    replay_ms = graph_ms(lambda: _couplings(*args, **kw))
    plain_ms = cuda_ms(lambda: fgw_couplings_plain(*args, **kw), reps=3, warmup=1)
    tc, f32 = fgw_bound(S, N, sk_run, kw)
    print(f"[fgw {label}] S={S} N={N}: kernel {ms:.4f} ms (eager calls; graph replays"
          f" {replay_ms:.4f} ms), plain {plain_ms:.4f} ms; bound {tc[0]:.5f} ms on the tensor"
          f" cores ({tc[1]}, {100 * tc[0] / ms:.1f}% reached, {100 * tc[0] / replay_ms:.1f}% of"
          f" the replays), {f32[0]:.5f} ms in f32 on the CUDA cores")
    rows[name][label] = dict(max_abs_err=err, ms=ms, graph_ms=replay_ms, plain_ms=plain_ms,
                             bound=tc, bound_f32=f32, sinkhorn_iters=sk_run, tol=limit,
                             moved=moved)


def check_fgw_nan(args, label="N32-nan", rel=False):
    """K3 against its plain version with a NaN (the bits 0x7fffffff, the
    card's own NaN) planted in solve 0's T0: the products must carry it, so
    that the solve rolls back and is flagged as diverged; the other solves
    within ``fgw_limit``'s gate."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import _couplings, fgw_couplings_plain

    T0 = args[5].clone()
    T0.view(torch.int32)[0, 0, 0] = 0x7FFFFFFF
    args = (*args[:5], T0)
    T_k, (div_k, _) = _couplings(*args, **FGW_KW)
    T_p, (div_p, _) = fgw_couplings_plain(*args, **FGW_KW)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(T_k.isnan(), T_p.isnan()))
    err = float((T_k - T_p).nan_to_num(0.0).abs().max())
    limit, moved = fgw_limit(T_p, T0, rel)
    print(f"[fgw {label}] NaN in solve 0's T0: diverged kernel {div_k.tolist()[:3]}"
          f" plain {div_p.tolist()[:3]} (first three); NaN positions equal {same_nan};"
          f" T max_abs_err elsewhere {err:.3e} (tol {limit:.3e}; the plain plan moved"
          f" {moved:.3e} from T0)")
    require(int(div_p[0]) == 1, "the plain version does not flag the NaN solve")
    require(bool(torch.equal(div_k, div_p)), f"fgw {label} diverged flags disagree")
    require(same_nan and err <= limit, f"fgw {label} plans disagree")


# K3's checks: (label, heavy atoms per molecule, bucket). N=96 and N=128
# run K3 only; N=128 is the route that reads C1 and C2 through L2.
FGW_SHAPES = (("N32", (8, 13), 32), ("N64", (20, 26), 64), ("N96", (48, 54), 96),
              ("N128", (60, 66), 128))


def phase_kernels(device):
    import torch

    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    rows = {name: {} for name in REPLACES}
    gen = torch.Generator().manual_seed(SEED)
    for label, heavy, n_atoms in FGW_SHAPES:
        pos, mask = packed_geometry(SEED + n_atoms, B, heavy, n_atoms, device)
        if n_atoms == 64:
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            require(bool((within > CAP).any()), "N=64 inputs never engage the neighbour cap")
        if n_atoms <= 64:
            check_cfconv(label, pos, mask, gen, rows)
        args, Ys, Cs = fgw_problem(pos, mask, gen)
        check_fgw(label, args, rows)
        if n_atoms == 32:
            check_fgw_nan(args)
        if n_atoms <= 64:
            check_fgw(f"{label}-outer2", second_outer_inputs(args, Ys, Cs), rows)
        if n_atoms == 32:
            # the two inputs the runner accepts beyond the default: zero-mass
            # marginals (bary_pad_mode: masked) and the deep budget
            check_fgw(f"{label}-masked", fgw_problem(pos, mask, gen, masked=True)[0], rows)
            check_fgw(f"{label}-deep", args, rows, FGW_DEEP_KW)
    # the classification width at sol1k_class's batch, N=64 with the cap active
    for label, heavy, n_atoms in FGW_SHAPES[:2]:
        pos, mask = packed_geometry(SEED + 1000 + n_atoms, B_CLS, heavy, n_atoms, device)
        if n_atoms == 64:
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            require(bool((within > CAP).any()), "N=64 inputs never engage the neighbour cap")
        check_cfconv(label, pos, mask, gen, rows, F_CLS, GAUSS_CLS)
    return rows


# ---------------------------------------------------------------- phase 3
def phase_train(device, card):
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train.loop import TrainSettings, fit

    train = random_dataset(SEED + 1, 2 * B, num_conformers=K, heavy_range=(8, 13), device=device)
    val = random_dataset(SEED + 2, B, num_conformers=K, heavy_range=(8, 13), device=device)
    model = ConanModel(seed=SEED, device=device)
    totals, stage_rows = {}, {}
    reset_launches()
    for stage, bary in ((1, False), (2, True)):
        before = dict(launches)
        settings = TrainSettings(num_epochs=2, batch_size=B, use_barycenter=bary, seed=SEED)
        res = fit(settings, train, val, model=model, device=device)
        model = res.model
        steps = sum(r["train_steps"] for r in res.history)
        captured = sorted(k[0] for k, st in res.graphs.steps.items() if st.graph is not None)
        require(captured == ["eval", "train"], f"stage {stage}: CUDA graphs captured {captured}")
        grew = {k: launches[k] - before.get(k, 0) for k in REGRESSION}
        for r in res.history:
            require(all(v == v and abs(v) != float("inf") for v in (r["train_loss"], r["val_loss"])),
                    f"stage {stage} epoch {r['epoch']} has a non-finite loss")
        require(grew["cfconv_fwd"] >= 3 * steps, f"stage {stage}: K1 launched {grew['cfconv_fwd']}")
        require(grew["cfconv_bwd"] >= 3 * steps, f"stage {stage}: K2 launched {grew['cfconv_bwd']}")
        if bary:
            require(grew["fgw_couplings"] >= 5 * steps, f"stage 2: K3 launched {grew['fgw_couplings']}")
        last = res.history[-1]  # the second epoch: kernels built, caches warm
        step_ms = 1e3 * last["train_s"] / last["train_steps"]
        gps = B * K * last["train_steps"] / last["train_s"]
        print(f"[train stage {stage}] {steps} steps, losses "
              + ", ".join(f"{r['train_loss']:.4f}/{r['val_loss']:.4f}" for r in res.history)
              + f"; epoch 2 (graph replays): {step_ms:.2f} ms/step, {gps:.1f} graphs/s on {card};"
              f" launches {grew}")
        stage_rows[stage] = dict(step_ms=step_ms, graphs_per_s=gps, steps=steps)
    totals = {k: launches[k] for k in REGRESSION}
    print(f"[train] main-path launches {totals}")
    for k, v in totals.items():
        require(v > 0, f"kernel {k} was never launched on the main path")
    return model, totals, stage_rows


def profile_stage2(model, device):
    """Device time by kernel over three eager stage-2 training steps (after
    the main path's counts were read), and the device's busy share of the
    wall time. Prints "not measured" where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.train.loop import TrainSettings, make_optimizer, train_step

    recs = random_dataset(SEED + 4, B, num_conformers=K, heavy_range=(8, 10), device=device)
    batch = pack_batch(recs, max_atoms=32, batch_size=B).to(device)
    settings = TrainSettings(batch_size=B, use_barycenter=True)
    opt = make_optimizer(model, settings)
    train_step(model, opt, batch, settings)
    torch.cuda.synchronize()
    return profile_steps("[profile] stage-2 step", lambda: train_step(model, opt, batch, settings))


def profile_steps(label, step, steps: int = 3):
    """``steps`` calls of ``step`` under ``torch.profiler``: prints the wall
    and device busy time per step, kernels per step and the largest kernels;
    returns ``(busy share, kernels per step, {kernel name: executions},
    {wrapper: launches} over the steps)``, or None where the profiler saw no
    device time ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conan_fgw_tpu_torch.ops.cuda import launches

    # the profiler has lost the first kernels of its window (PERF.md section
    # 7): the steps start, and end, PROFILE_MARGIN_S inside it
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        before = collections.Counter(launches)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        grew = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
        time.sleep(PROFILE_MARGIN_S)
    # device-side kernels and copies only: the CPU ops that launched them, and
    # annotated regions on the device's timeline (the optimizer's step), span
    # the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        print(f"{label}: device time not measured (the profiler saw no device activity)")
        return None
    per_step = sum(e.count for e in events) // steps
    print(f"{label}: wall {wall_us / steps / 1e3:.3f} ms, device busy"
          f" {busy_us / steps / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% busy), {per_step}"
          " kernels/step")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"{label}   {e.self_device_time_total / steps / 1e3:8.3f} ms/step"
              f"  x{e.count // steps:<4d} {e.key[:70]}")
    counts = collections.Counter()
    for e in events:
        counts[e.key] += e.count
    return busy_us / wall_us, per_step, counts, grew


@contextlib.contextmanager
def kept_graphs():
    """Inside, every ``torch.cuda.CUDAGraph`` made keeps its cudaGraph_t
    (``keep_graph``, instantiated at its first replay) in debug mode, so
    that ``graph_kernels`` can read its nodes."""
    import torch

    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls, keep_graph=True):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=True):
            super().__init__(True)
            self.enable_debug_mode()

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


def graph_kernels(graph) -> dict:
    """The K1/K2/K3 kernel nodes of a graph captured under ``kept_graphs``,
    by the kernel names of ``PROFILED``, from its ``debug_dump``."""
    import warnings

    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # debug_dump's own notes
        path = Path(tmp) / "graph.dot"
        graph.debug_dump(str(path))
        require(path.exists(), "a captured graph could not be dumped")
        nodes = re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)\];?\s*$', path.read_text(),
                           flags=re.S | re.M)
    require(bool(nodes), "the dump of a captured graph holds no nodes")
    return {name: sum(name in body for body in nodes) for name in PROFILED}


def captured_nodes(label, step) -> dict:
    """The K1/K2/K3 kernel nodes of a captured step's graph (made under
    ``kept_graphs``), which must equal the launches its capture counted:
    every node runs once a replay."""
    nodes = graph_kernels(step.graph)
    captured = {name: sum(step.counts.delta.get(k, 0) for k in names)
                for name, names in PROFILED.items()}
    require(nodes == captured, f"{label}: the train graph holds the K1/K2/K3 nodes {nodes},"
            f" its capture counted {captured}")
    return nodes


def graphed_launches(label, graphs, pb, steps: int = 3):
    """Backs the derived launch counts (``LaunchReplays``) of the graphed
    train step of ``pb``'s shape: the K1/K2/K3 kernel nodes of its graph
    must equal the launches its capture counted, since every node runs
    once a replay; then ``profile_steps`` over ``steps`` replays of ``pb``,
    whose derived counts must be ``steps`` times the nodes. The profiler's
    count of executions must not exceed them and must see each kernel of
    the graph run, but may fall short: it drops a few of the thousands of
    device records of a window (PERF.md section 7). Returns ``(busy share,
    kernels per step, {kernel name: executions seen})``."""
    nodes = captured_nodes(label, graphs.steps[("train", pb.z.shape)])
    prof = profile_steps(label, lambda: graphs.train(pb), steps)
    require(prof is not None, f"{label}: the profiler saw no device activity")
    busy, per_step, counts, grew = prof
    seen = {name: sum(c for key, c in counts.items() if name in key) for name in PROFILED}
    counted = {name: sum(grew.get(k, 0) for k in names) for name, names in PROFILED.items()}
    require(counted == {name: steps * n for name, n in nodes.items()},
            f"{label}: {steps} replays counted {counted}, the graph holds {nodes}")
    require(all(seen[k] <= counted[k] and (seen[k] > 0) == (counted[k] > 0) for k in PROFILED),
            f"{label}: the profiler saw {seen}, launches {counted}")
    print(f"{label}: K1/K2/K3 nodes of the train graph {nodes}, as its capture counted;"
          f" executions over {steps} replays {counted}, seen by the profiler {seen}")
    return busy, per_step, seen


# ---------------------------------------------------------------- phase 4
def phase_parity(model, device, batch=B, label="parity", rtol=STEP_RTOL):
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset

    recs = random_dataset(SEED + 3, batch, num_conformers=K, heavy_range=(8, 10), device=device)
    return step_parity(model, pack_batch(recs, max_atoms=32, batch_size=batch), device, label,
                       rtol=rtol)


@contextlib.contextmanager
def kernel_arithmetic():
    """Within it, the SchNet blocks' cfconv runs on the CPU as K1 and K2
    compute it: ``cfconv_edges`` with ``split_mm``
    (``scripts/torch_precision_probe.py`` measures steps with it)."""
    import torch

    from conan_fgw_tpu_torch.models import schnet
    from conan_fgw_tpu_torch.ops.cuda.cfconv import cfconv_edges, split_mm

    class Split(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors, cap_mode):
            ctx.save_for_backward(pos, mask, x, w1, b1, w2, b2)
            ctx.params = (cutoff, max_neighbors)
            ctx.cap_mode = cap_mode
            return cfconv_edges(pos, mask, x, w1, b1, w2, b2, torch.zeros_like(x), cutoff,
                                max_neighbors, mm=split_mm, cap_mode=cap_mode)[0]

        @staticmethod
        def backward(ctx, g):
            grads = cfconv_edges(*ctx.saved_tensors, g.contiguous(), *ctx.params, mm=split_mm,
                                 cap_mode=ctx.cap_mode)[1]
            return (None, None, *grads, None, None, None)

    def split(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, max_neighbors=32,
              cap_mode="index"):
        require(w1.shape[0] == num_gaussians, "kernel arithmetic: the filter's width")
        return Split.apply(pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors, cap_mode)

    original = schnet.cfconv
    schnet.cfconv = split
    try:
        yield
    finally:
        schnet.cfconv = original


def _plain_step(model, pb, bary, dtype=None, kernel=False):
    """Loss and per-parameter gradient norms of one step of a CPU copy of
    ``model`` (the plain versions) on ``pb``, in ``dtype`` where given, and
    with ``kernel`` in K1/K2's arithmetic (``kernel_arithmetic``)."""
    import dataclasses

    from conan_fgw_tpu_torch.train.loop import masked_mse

    m = copy.deepcopy(model).to(device="cpu", dtype=dtype)
    m.zero_grad(set_to_none=True)
    batch = pb.to("cpu")
    if dtype is not None:
        batch = dataclasses.replace(batch, pos=batch.pos.to(dtype))
    with kernel_arithmetic() if kernel else contextlib.nullcontext():
        pred, _ = m(batch, use_barycenter=bary)
        loss = masked_mse(pred, batch)
        loss.backward()
    return float(loss.detach()), {k: float(p.grad.norm()) for k, p in m.named_parameters()
                                  if p.grad is not None}


def _norm(norms: dict) -> float:
    return sum(v * v for v in norms.values()) ** 0.5


def step_parity(model, pb, device, label, bary=True, rtol=STEP_RTOL):
    """One training step's loss and gradients from identical weights, on
    the host batch ``pb``, through the kernels on the card and through the
    plain versions on the CPU (stage 2 with ``bary``), within phase 4's
    gates (the loss and the global gradient norm within ``rtol``)."""
    from conan_fgw_tpu_torch.train.loop import masked_mse

    model.zero_grad(set_to_none=True)
    batch = pb.to(device)
    pred, _ = model(batch, use_barycenter=bary)
    loss = masked_mse(pred, batch)
    loss.backward()
    lk = float(loss.detach())
    nk = {k: float(p.grad.norm()) for k, p in model.named_parameters() if p.grad is not None}
    t0 = time.perf_counter()
    lp, np_ = _plain_step(model, pb, bary)
    cpu_s = time.perf_counter() - t0
    gk, gp = _norm(nk), _norm(np_)
    rel = {k: abs(nk[k] - np_[k]) / max(np_[k], PARAM_FLOOR * gp) for k in np_}
    worst = max(rel.values())
    for k in sorted(rel, key=rel.get, reverse=True)[:5]:
        print(f"[{label}] {k}: grad norm kernel {nk[k]:.6e} plain {np_[k]:.6e} rel {rel[k]:.3e}")
    stage = "stage-2" if bary else "stage-1"
    loss_rel, grad_rel = abs(lk - lp) / abs(lp), abs(gk - gp) / gp
    print(f"[{label}] loss kernel {lk:.6f} plain {lp:.6f} (rel {abs(lk - lp) / abs(lp):.3e});"
          f" grad norm kernel {gk:.6f} plain {gp:.6f} (rel {abs(gk - gp) / gp:.3e});"
          f" worst parameter grad-norm rel err {worst:.3e} (tol {rtol}, {PARAM_RTOL}); the CPU"
          f" step took {cpu_s:.1f} s")
    require(set(nk) == set(np_), f"{label}: card and CPU differ in which parameters get gradients")
    require(worst <= PARAM_RTOL, f"{label}: a parameter's gradient norm disagrees")
    missed = [k for k, v in (("loss", loss_rel), ("gradient norm", grad_rel)) if v > rtol]
    require(not missed, f"{label}: {stage} {' and '.join(missed)} off by more than {rtol}")
    model.zero_grad(set_to_none=True)
    return dict(loss_rel=loss_rel, grad_norm_rel=grad_rel, worst_param_rel=worst, cpu_s=cpu_s)


# ---------------------------------------------------------------- phase 5
RUNNER_STAGES = (("conan_fgw_pre", "config/schnet/sol250_5.yaml"),
                 ("conan_fgw", "config/schnet/sol250_5_bc.yaml"))
RUNNER_EPOCHS = 2
PREDICT_RTOL = 1e-6


def config_copy(src: str, out_dir: Path, epochs: int) -> str:
    """A copy of the YAML config ``src`` with ``num_epochs: epochs``."""
    text, n = re.subn(r"(?m)^num_epochs: \d+$", f"num_epochs: {epochs}", Path(src).read_text())
    require(n == 1, f"{src}: no num_epochs line to set")
    path = out_dir / f"{Path(src).stem}_{epochs}ep.yaml"
    path.write_text(text)
    return str(path)


@contextlib.contextmanager
def runner_spies():
    """Count calls of the kernels' plain versions and CUDA-graph captures by
    kind, record the weights each checkpoint restore leaves in the model,
    and count the host pipeline's numpy packs, pageable copies and staged
    copies from pinned slots and the steps it feeds, train and eval
    (``train_forwards``, ``eval_forwards``): ``(plain_calls, restores,
    captures, host)``, ``restores`` a list of ``(directory, which,
    state_dict on the host)``."""
    from conan_fgw_tpu_torch.data import loader
    from conan_fgw_tpu_torch.ops.cuda import cfconv as cfconv_mod
    from conan_fgw_tpu_torch.ops.cuda import fgw as fgw_mod
    from conan_fgw_tpu_torch.train import graphs as graphs_mod
    from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
    from conan_fgw_tpu_torch.train.graphs import StepGraphs

    plain_calls, restores, captures = collections.Counter(), [], collections.Counter()
    host = collections.Counter()
    saved = [(cfconv_mod, "_cfconv_plain"), (fgw_mod, "fgw_couplings_plain"),
             (RunCheckpointer, "restore_params"), (StepGraphs, "_capture"),
             (loader, "pack_batch"), (graphs_mod._Step, "load"), (graphs_mod.PinnedSlots, "stage"),
             (StepGraphs, "_run")]
    originals = [getattr(owner, name) for owner, name in saved]

    def counted(name, fn):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return call

    def restore_params(self, model, which="best"):
        out = originals[2](self, model, which)
        restores.append((self.directory, which,
                         {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}))
        return out

    def capture(self, step, fn, kind):
        captures[kind] += 1
        return originals[3](self, step, fn, kind)

    def host_counted(name, fn):
        def call(*args, **kwargs):
            host[name] += 1
            return fn(*args, **kwargs)
        return call

    cfconv_mod._cfconv_plain = counted("cfconv", originals[0])
    fgw_mod.fgw_couplings_plain = counted("fgw", originals[1])
    RunCheckpointer.restore_params = restore_params
    StepGraphs._capture = capture
    loader.pack_batch = host_counted("numpy_pack", originals[4])
    graphs_mod._Step.load = host_counted("pageable_copy", originals[5])
    graphs_mod.PinnedSlots.stage = host_counted("staged_copy", originals[6])

    def run_counted(self, kind, pb):
        host[f"{kind}_forwards"] += 1
        return originals[7](self, kind, pb)

    StepGraphs._run = run_counted
    try:
        yield plain_calls, restores, captures, host
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


def run_main(main, argv):
    """``main(argv)`` with its printed output kept off this script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def runner_stage(label, stage, cfg, ctx, *extra, start=0, kernels=REGRESSION, metric="rmse",
                 per_forward=3, buckets=(32, 64)):
    """One runner run with the launch counts zeroed before it; checks and
    prints it, returns ``(summary, history, launches)``. ``ctx`` holds the
    common arguments, the temporary directory, the plain-call counts, the
    device and the card line; ``start`` is the first epoch this run trains;
    ``kernels`` names the path's K1, K2 and K3 counts (each a name, or a
    tuple of names whose counts add up: a small and a large route), and ``metric`` its
    validation and test metric (``rmse``, or ``auroc`` for classification).
    ``per_forward`` is the path's K1 launches a forward and K2 launches a
    train step: 3 for the flagship's SchNet, its interactions for an ESAN or
    aux head (phase 11). Every epoch must step in each of ``buckets``. The
    run must capture at least one train and one eval graph."""
    import numpy as np
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train import runner
    from conan_fgw_tpu_torch.train.config import load_config

    common, tmp, plain_calls, captures, host, device, card = ctx
    k1, k2, k3 = kernels  # K1 and K2 None: the path has no cfconv (ViSNet, DimeNet)
    reset_launches()
    captures.clear()
    host.clear()
    t0 = time.perf_counter()
    summary = run_main(runner.main, ["--config", cfg, "--stage", stage, *common, *extra])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = {k: launches[k] for k in REPLACES}
    names = {k: (k,) if isinstance(k, str) else k for k in kernels if k is not None}
    total = {k: sum(grew[n] for n in names[k]) for k in names}
    run_dir = tmp / "models" / "smoke" / "0" / f"run_{stage}:0"
    history = json.loads((run_dir / "last_state.meta.json").read_text())["loop"]["history"]
    steps = sum(r["train_steps"] for r in history)
    val_key = "val_mse" if metric == "rmse" else f"val_{metric}"
    require(not plain_calls, f"runner {label}: plain versions ran: {dict(plain_calls)}")
    if device == "cuda":
        require(captures["train"] and captures["eval"],
                f"runner {label}: CUDA graphs captured {dict(captures)}")
        # every batch natively packed into a pinned slot and staged from it
        require(host["staged_copy"] > 0 and not host["numpy_pack"] and not host["pageable_copy"],
                f"runner {label}: host pipeline {dict(host)}")
    for r in history:
        require(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]),
                f"runner {label} epoch {r['epoch']} has a non-finite loss")
        require(all(r.get(f"steps_n{n}", 0) > 0 for n in buckets),
                f"runner {label} epoch {r['epoch']} did not run every bucket of {buckets}: {r}")
    require(np.isfinite(summary[f"test_{metric}"]["mean"]), f"runner {label}: test_{metric} not finite")
    new_steps = sum(r["train_steps"] for r in history if r["epoch"] >= start)
    others = [k for k in REPLACES if not any(k in v for v in names.values()) and grew[k]]
    require(not others, f"runner {label}: kernels of another width or path launched: {others}")
    # fit's steps ran as CUDA graphs; the counts must be the eager path's: every forward
    # (train or eval, a graph's capture standing for its first replay) per_forward K1 and,
    # in stage 2, the config's outer iterations of K3 (5, or 15 at the deep budget); every
    # train step per_forward K2 (ViSNet and DimeNet: no cfconv)
    forwards = host["train_forwards"] + host["eval_forwards"]
    require(host["train_forwards"] == new_steps and host["eval_forwards"] > 0,
            f"runner {label}: {dict(host)} forwards in {new_steps} steps")
    if k1 is not None:
        require(total[k1] == per_forward * forwards,
                f"runner {label}: K1 launched {total[k1]} in {forwards} forwards")
        require(total[k2] == per_forward * new_steps,
                f"runner {label}: K2 launched {total[k2]} in {new_steps} steps")
    outer = runner.fgw_config(load_config(cfg)).outer_iters
    require(total[k3] == (outer * forwards if stage == "conan_fgw" else 0),
            f"runner {label}: K3 launched {total[k3]} in {forwards} {stage} forwards, want"
            f" {outer} a forward")
    for r in history:
        by_bucket = ", ".join(f"{r[f'steps_n{n}']} at N={n}"
                              f" ({1e3 * r[f'train_s_n{n}'] / r[f'steps_n{n}']:.2f} ms/step)"
                              for n in buckets)
        print(f"[runner {label}] epoch {r['epoch']}: {r['epoch_time_s']:.3f} s, {r['train_steps']}"
              f" steps ({by_bucket}), fgw_diverged {r['fgw_diverged']}, train_loss"
              f" {r['train_loss']:.5g}, {val_key} {r[val_key]:.5g}")
    print(f"[runner {label}] {steps} steps in all, {new_steps} in this run: {wall:.1f} s wall with"
          f" data and test on {card}; test_{metric} {summary[f'test_{metric}']['mean']:.6f};"
          f" launches {grew}; CUDA graphs captured {dict(captures)}; host pipeline {dict(host)}")
    return summary, history, grew


def stage_row(history, summary, metric, buckets=(32, 64)):
    """What the result line keeps of one runner stage."""
    last = history[-1]
    by_bucket = {}
    for n in buckets:
        by_bucket[f"steps_n{n}"] = last[f"steps_n{n}"]
        by_bucket[f"ms_n{n}"] = 1e3 * last[f"train_s_n{n}"] / last[f"steps_n{n}"]
    return dict(epoch_s=[r["epoch_time_s"] for r in history], steps=last["train_steps"],
                **by_bucket, fgw_diverged=[r["fgw_diverged"] for r in history],
                **{f"test_{metric}": summary[f"test_{metric}"]["mean"]})


def check_warm_start(restores, first_restore, pre_dir):
    """The stage-2 weights right after the warm start equal stage 1's
    ``best`` file bit for bit."""
    import numpy as np

    warm = [st for d, which, st in restores[first_restore:] if Path(d) == pre_dir and which == "best"]
    require(len(warm) == 1, f"stage 2 restored stage 1's best {len(warm)} times")
    with np.load(pre_dir / "best.npz") as best:
        differ = [k for k, v in warm[0].items()
                  if not np.array_equal(best[k].view(np.uint32), v.numpy().view(np.uint32))]
        require(set(best.files) == set(warm[0]), "stage 1's best and the model differ in keys")
    print(f"[runner] warm start: {len(warm[0])} tensors equal stage 1's best bit for bit,"
          f" {len(differ)} differ")
    require(not differ, f"the warm start differs from stage 1's best in {differ[:3]}")


def phase_runner(device, card):
    """Phase 5: the runner's two stages, a resume and predict on sol250."""
    from conan_fgw_tpu_torch.train import predict

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as name, \
            runner_spies() as (plain_calls, restores, captures, host):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        cfgs, totals = {}, collections.Counter()
        for stage, src in RUNNER_STAGES:
            first_restore = len(restores)  # stage 1 restores its own best for its test
            cfgs[stage] = config_copy(src, tmp, RUNNER_EPOCHS)
            label = "stage 1" if stage == "conan_fgw_pre" else "stage 2"
            summary, history, grew = runner_stage(label, stage, cfgs[stage], ctx)
            totals.update(grew)
            out[label] = stage_row(history, summary, "rmse")

        check_warm_start(restores, first_restore, tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")

        metrics_csv = tmp / "metrics" / "smoke" / "0" / "run_conan_fgw:0" / "metrics.csv"
        before = metrics_csv.read_text().splitlines()
        resume_cfg = config_copy(RUNNER_STAGES[1][1], tmp, RUNNER_EPOCHS + 1)
        summary, history, _ = runner_stage("stage 2 resume", "conan_fgw", resume_cfg, ctx,
                                           "--resume", start=RUNNER_EPOCHS)
        after = metrics_csv.read_text().splitlines()
        require([r["epoch"] for r in history] == list(range(RUNNER_EPOCHS + 1)),
                f"resume history epochs {[r['epoch'] for r in history]}")
        require(after[: len(before)] == before and len(after) == len(before) + 1,
                f"resume: metrics.csv went from {len(before)} to {len(after)} rows, or its"
                " earlier rows changed")
        print(f"[runner] resume: started at epoch {RUNNER_EPOCHS}, metrics.csv {len(before)} ->"
              f" {len(after)} rows, the earlier ones unchanged")

        stage2_dir = tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"
        reported = summary["test_rmse"]["mean"]
        rmse = run_main(predict.main, ["--config", resume_cfg, "--checkpoint", str(stage2_dir),
                                       "--data_root", ".", "--device", device,
                                       "--out", str(tmp / "preds.csv")])
        rel = abs(rmse - reported) / abs(reported)
        print(f"[runner] predict on stage 2's best: test RMSE {rmse!r}, the runner's {reported!r},"
              f" rel {rel:.3e} (tol {PREDICT_RTOL})")
        require(rel <= PREDICT_RTOL, "predict's test RMSE disagrees with the runner's")
        require(not plain_calls, f"plain versions ran: {dict(plain_calls)}")
    out["launches"] = dict(totals)
    return out


# ---------------------------------------------------------------- phase 6
CLASS_STAGES = (("conan_fgw_pre", "config/schnet/sol1k_class_5.yaml"),
                ("conan_fgw", "config/schnet/sol1k_class_5_bc.yaml"))


def phase_classification(device, card):
    """Phase 6: the classification model's two stages and predict on
    ``data/sol1k_class`` through the runner, at full width (hidden 512, 256
    filters, 10 Gaussians): the F=256 kernels and K3."""
    out, totals = {}, collections.Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_class_") as name, \
            runner_spies() as (plain_calls, restores, captures, host):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        for stage, src in CLASS_STAGES:
            first_restore = len(restores)
            cfg = config_copy(src, tmp, RUNNER_EPOCHS)
            label = "class stage 1" if stage == "conan_fgw_pre" else "class stage 2"
            with last_evaluation() as test_eval:
                summary, history, grew = runner_stage(label, stage, cfg, ctx,
                                                      kernels=CLASSIFICATION, metric="auroc")
            totals.update(grew)
            out[label] = stage_row(history, summary, "auroc")
            check_best_auroc(label, history, summary, tmp / "models" / "smoke" / "0" / f"run_{stage}:0")
        check_warm_start(restores, first_restore, tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
        check_predict_auroc("class stage 2", cfg, tmp, ".", summary, device, test_eval)
        require(not plain_calls, f"plain versions ran: {dict(plain_calls)}")
    out["launches"] = dict(totals)
    return out


def check_best_auroc(label, history, summary, run_dir):
    """Every AUROC in [0, 1], and ``best`` at the epoch of the highest
    ``val_auroc``."""
    import numpy as np

    aurocs = [r["val_auroc"] for r in history]
    require(all(0.0 <= v <= 1.0 for v in aurocs + [summary["test_auroc"]["mean"]]),
            f"{label}: an AUROC outside [0, 1]: {aurocs}, {summary['test_auroc']}")
    best_epoch = json.loads((run_dir / "best.meta.json").read_text())["epoch"]
    require(best_epoch == int(np.argmax(aurocs)),
            f"{label}: best is epoch {best_epoch}, the highest val_auroc is at"
            f" {int(np.argmax(aurocs))} ({aurocs})")
    print(f"[runner {label}] best: epoch {best_epoch} of val_auroc {aurocs} (higher is better)")


@contextlib.contextmanager
def last_evaluation():
    """The logits and targets of the last ``loop.evaluate`` call inside: a
    runner run's last is its test split on ``best``."""
    from conan_fgw_tpu_torch.train import loop

    seen, original = {}, loop.evaluate

    def evaluate(*args, **kwargs):
        out = original(*args, **kwargs)
        seen["logits"], seen["y"] = out[1], out[2]
        return out

    loop.evaluate = evaluate
    try:
        yield seen
    finally:
        loop.evaluate = original


def check_predict_auroc(label, cfg, tmp, data_root, summary, device, test_eval):
    """``predict.main`` on the stage-2 run's ``best`` under ``tmp``: its
    probabilities must be the sigmoid of the logits of the runner's test
    evaluation (``test_eval``, from ``last_evaluation``) to
    ``PREDICT_RTOL``, their targets equal, and the AUROC of those logits the
    runner's ``test_auroc``; so must the AUROC of the probabilities, unless
    some are 0 or 1 (a logit beyond about 37 is 1.0 in float64), where they
    tie and lose the logits' order."""
    import csv

    import numpy as np

    from conan_fgw_tpu_torch.train import metrics as metrics_lib
    from conan_fgw_tpu_torch.train import predict

    preds = tmp / "class_preds.csv"
    run_main(predict.main, ["--config", cfg, "--checkpoint",
                            str(tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"),
                            "--data_root", data_root, "--device", device, "--out", str(preds)])
    with open(preds) as f:
        rows = list(csv.DictReader(f))
    prob = np.asarray([float(r["prediction"]) for r in rows])
    target = np.asarray([float(r["target"]) for r in rows])
    logits = np.asarray(test_eval["logits"], np.float64)
    require(bool(np.all((prob >= 0) & (prob <= 1))), "predict's probabilities leave [0, 1]")
    require(np.array_equal(target, test_eval["y"]), "predict's targets are not the runner's")
    diff = float(np.abs(prob - 1.0 / (1.0 + np.exp(-logits))).max())
    auroc = metrics_lib.roc_auc(target.astype(np.int64), logits)
    auroc_prob = metrics_lib.roc_auc(target.astype(np.int64), prob)
    reported = summary["test_auroc"]["mean"]
    saturated = int(np.sum((prob == 0) | (prob == 1)))
    print(f"[runner] predict on {label}'s best: probabilities {diff:.3e} from the sigmoid of the"
          f" runner's test logits (tol {PREDICT_RTOL}); AUROC of those logits {auroc!r}, of the"
          f" probabilities {auroc_prob!r}, the runner's {reported!r} ({saturated} of {len(prob)}"
          f" probabilities at 0 or 1; logits {logits.min():.4g} to {logits.max():.4g})")
    require(diff <= PREDICT_RTOL, "predict's probabilities disagree with the runner's test logits")
    require(abs(auroc - reported) <= PREDICT_RTOL, "the runner's test logits do not give its AUROC")
    require(saturated or abs(auroc_prob - reported) <= PREDICT_RTOL,
            "predict's test AUROC disagrees with the runner's")
    return auroc_prob


# ---------------------------------------------------------------- phase 8
# how the result line's launch counts were taken
LAUNCHES_COUNTED = ("wrapper counts over CUDA-graphed steps: each graph's capture-time counts"
                    " once per replay (train/graphs.py::LaunchReplays), held against the"
                    " profiler's kernel executions in phase 8")
GRAPH_STEPS = 20     # batches of the eager-against-graphed run
GRAPH_LR_AT = 10     # set_learning_rate after this many steps, in both runs
GRAPH_TIMED = 12     # warmed steps in each timing turn (50 before PR 16, 25 before PR 20)
GRAPH_RTOL = 1e-5    # per-step losses and final weights, relative
GRAPH_EVAL_RTOL = 1e-6
# label, classification?, stage 2?, bucket N, heavy atoms per molecule, batch.
# Every case draws its molecules, in order and cycled, from the 480 of its
# bucket (GRAPH_STEPS batches of B); B=96 is config/schnet/sol250_5.yaml's
# stage-1 batch
GRAPH_CASES = (("stage 1 N32", False, False, 32, (8, 13), B),
               ("stage 1 N64", False, False, 64, (20, 26), B),
               ("stage 2 N32", False, True, 32, (8, 13), B),
               ("stage 2 N64", False, True, 64, (20, 26), B),
               ("class stage 2 N32", True, True, 32, (8, 13), B_CLS),
               ("stage 1 N32 B96", False, False, 32, (8, 13), 96))
PROFILED = {"cfconv_fwd_kernel": ("cfconv_fwd", "cfconv_fwd_f256", "cfconv_fwd_bf16",
                                  "cfconv_fwd_f256_bf16", "cfconv_fwd_f16", "cfconv_fwd_f256_f16"),
            "cfconv_bwd_kernel": ("cfconv_bwd", "cfconv_bwd_f256", "cfconv_bwd_bf16",
                                  "cfconv_bwd_f256_bf16", "cfconv_bwd_f16", "cfconv_bwd_f256_f16"),
            "fgw_couplings_kernel": ("fgw_couplings",),
            # above 128 atoms: the message kernel, one a K1 and one a K2 call at
            # F=256 (its dx), K2's weight-gradient kernel at F=256, and K2 at F=128
            "cfconv_msg_wgmma_kernel": tuple(n for n in LARGE_NAMES if n.startswith("cfconv_")
                                             and not n.startswith("cfconv_bwd_large")),
            "cfconv_dw_wgmma_kernel": tuple(n for n in LARGE_NAMES
                                            if n.startswith("cfconv_bwd_f256_large")),
            LARGE_BWD_KERNEL: tuple(n for n in LARGE_NAMES if n.startswith("cfconv_bwd_large")),
            "fgw_couplings_cluster_kernel": ("fgw_couplings_cluster",),
            "fgw_couplings_stream_kernel": ("fgw_couplings_stream",),
            TEAM_KERNEL: ("fgw_couplings_large",)}
# the kernels of graphs up to 128 atoms, which phase 8's graphs run
SMALL_PROFILED = ("cfconv_fwd_kernel", "cfconv_bwd_kernel", "fgw_couplings_kernel")


def _max_rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@functools.cache
def graph_records(n_atoms: int, heavy: tuple, device: str) -> list:
    """Phase 8's synthetic molecules of one bucket (B=24's GRAPH_STEPS batches)."""
    from conan_fgw_tpu_torch.data.synthetic import random_dataset

    return random_dataset(SEED + 500 + n_atoms, GRAPH_STEPS * B, num_conformers=K,
                          heavy_range=heavy, device=device)


@contextlib.contextmanager
def host_split():
    """Host seconds of the pipelined graphed step's parts, summed into the
    yielded dict. On the prefetch thread: ``pack`` (the native packer into a
    pinned slot) and ``native`` (its foreign call, which runs without the
    interpreter lock). On the main thread: ``stage`` (``StepGraphs._load``:
    the non-blocking copy, its event, freeing landed slots) and
    ``slot_wait`` (the part of ``stage`` waiting for an earlier copy while
    too many are in flight)."""
    from conan_fgw_tpu_torch.data import native
    from conan_fgw_tpu_torch.train import graphs as graphs_mod

    spent = collections.Counter()
    lib = native.load_library()
    saved = [(graphs_mod, "pack_batch_native"), (graphs_mod.StepGraphs, "_load"),
             (graphs_mod.PinnedSlots, "reclaim"), (lib, "pack_batch")]
    originals = [getattr(owner, name) for owner, name in saved]

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for (owner, name), fn, key in zip(saved, originals,
                                      ("pack", "stage", "slot_wait", "native")):
        setattr(owner, name, timed(key, fn))
    try:
        yield spent
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


def graph_case(label, classify, bary, n_atoms, heavy, batch, device, card, base=None,
               timed=GRAPH_TIMED):
    """One shape of phase 8: eager steps on pre-packed batches against
    graphed steps fed by the host pipeline (prefetch, native packing into
    pinned slots, non-blocking copies), from identical weights through an lr
    change; the eval graph against eager eval; ms per step in turns (eager,
    graphed, pipelined, serial and back); the pipelined step's host time
    split; for stage 2 a profile of three graphed steps. ``base`` is the
    model to start from (default: the seeded SchNet model of the case's
    task); a model without cfconv must launch K3 alone. ``timed`` warmed
    steps a turn."""
    import dataclasses

    import numpy as np
    import torch

    from conan_fgw_tpu_torch.data.loader import batches as host_batches
    from conan_fgw_tpu_torch.data.packing import bucket_for, pack_batch
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.models.schnet import SchNet3D
    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.train import loop

    # the molecules of the case's own bucket, so that the pipeline's
    # bucketed batches are the pre-packed ones: one shape, in input order
    pool = [r for r in graph_records(n_atoms, heavy, device)
            if bucket_for(r.num_atoms, loop.bucket_boundaries(n_atoms)) == n_atoms]
    recs = [pool[i % len(pool)] for i in range(GRAPH_STEPS * batch)]
    if classify:
        median = float(np.median([r.y for r in recs]))
        recs = [dataclasses.replace(r, y=float(r.y > median)) for r in recs]
    t0 = time.perf_counter()
    batches = list(host_batches(recs, batch, n_atoms, pack=pack_batch))
    numpy_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    require(len(batches) == GRAPH_STEPS and all(pb.mol_mask.all() for pb in batches),
            f"graphs {label}: the batches are not {GRAPH_STEPS} full ones at N={n_atoms}")
    width = dict(task="classification", hidden_channels=512, num_filters=256,
                 num_gaussians=GAUSS_CLS) if classify else {}
    if base is None:
        base = ConanModel(seed=SEED, device=device, **width)
    schnet = isinstance(base.backbone, SchNet3D)
    settings = loop.TrainSettings(task=width.get("task", "regression"), batch_size=batch,
                                  use_barycenter=bary)

    # eager against graphed, from identical weights and a fresh Adam each
    runs = {}
    for mode in ("eager", "graphed"):
        model = copy.deepcopy(base)
        opt = loop.make_optimizer(model, settings)
        graphs = loop.step_graphs(model, opt, settings, device)
        before, losses = collections.Counter(launches), []
        if mode == "eager":
            for i, pb in enumerate(batches):
                if i == GRAPH_LR_AT:
                    loop.set_learning_rate(opt, 0.5 * settings.learning_rate)
                losses.append(loop.train_step(model, opt, pb.to(device), settings)[0])
        else:
            with kept_graphs(), loop.step_batches(recs, settings, n_atoms, graphs) as staged:
                for i, pb in enumerate(staged):
                    if i == GRAPH_LR_AT:
                        loop.set_learning_rate(opt, 0.5 * settings.learning_rate)
                    losses.append(graphs.train(pb)[0])
        torch.cuda.synchronize()
        grew = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
        runs[mode] = (model, opt, graphs, torch.stack(losses), grew)
    (m_e, opt_e, _, loss_e, grew_e), (m_g, opt_g, graphs, loss_g, grew_g) = runs["eager"], runs["graphed"]
    require(loss_e.isfinite().all(), f"graphs {label}: a non-finite eager loss")
    require(len(loss_g) == GRAPH_STEPS, f"graphs {label}: the pipeline gave {len(loss_g)} batches")
    loss_rel = _max_rel(loss_g, loss_e)
    w_rel = max(_max_rel(q.detach(), p.detach()) for p, q in zip(m_e.parameters(), m_g.parameters()))
    bits = bool(torch.equal(loss_e, loss_g)) and all(
        torch.equal(p, q) for p, q in zip(m_e.parameters(), m_g.parameters()))
    captured = sorted(k[0] for k, s in graphs.steps.items() if s.graph is not None)
    require(list(graphs.pools) == [(batch, K, n_atoms)],
            f"graphs {label}: pinned slots for {list(graphs.pools)}")
    print(f"[graphs {label}] {GRAPH_STEPS} steps eager vs graphed (batches through prefetch,"
          f" native packing into pinned slots), lr halved after {GRAPH_LR_AT}: losses rel"
          f" {loss_rel:.3e}, weights rel {w_rel:.3e} (tol {GRAPH_RTOL}); bit-identical {bits};"
          f" graphs captured {captured}; launches eager {grew_e} graphed {grew_g}")
    require(loss_rel <= GRAPH_RTOL and w_rel <= GRAPH_RTOL, f"graphs {label}: eager and graphed differ")
    require(captured == ["train"], f"graphs {label}: captured {captured}")
    require(grew_e == grew_g, f"graphs {label}: launches eager {grew_e} graphed {grew_g}")

    # the eval graph against eager eval on the same weights (the first
    # batch warms up, the second is captured, the rest replay)
    before, preds_g, preds_e = collections.Counter(launches), [], []
    for pb in batches[:5]:
        preds_g.append(graphs.eval(pb)[1])
    grew_eval = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
    before = collections.Counter(launches)
    for pb in batches[:5]:
        preds_e.append(loop.eval_step(m_g, pb.to(device), settings)[1])
    grew_eager_eval = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
    eval_rel = _max_rel(torch.cat(preds_g), torch.cat(preds_e))
    print(f"[graphs {label}] eval graph vs eager eval, 5 batches: predictions rel {eval_rel:.3e}"
          f" (tol {GRAPH_EVAL_RTOL}); launches {grew_eval}")
    require(eval_rel <= GRAPH_EVAL_RTOL, f"graphs {label}: the eval graph disagrees")
    require(grew_eval == grew_eager_eval, f"graphs {label}: eval launches {grew_eval} against"
            f" {grew_eager_eval} eager")

    # timing in turns of timed warmed steps over the batches: eager
    # and graphed steps on pre-packed batches (pageable copies), pipelined
    # ones through the host pipeline, serial ones packed by numpy on this
    # thread (pageable copies)
    order = [batches[i % GRAPH_STEPS] for i in range(timed)]
    timed_recs = [r for i in range(timed) for r in recs[(i % GRAPH_STEPS) * batch:][:batch]]

    def eager_turn():
        for pb in order:
            loop.train_step(m_e, opt_e, pb.to(device), settings)

    def graphed_turn():
        for pb in order:
            graphs.train(pb)

    def pipelined_turn(split=None, **pipeline):
        with loop.step_batches(timed_recs, settings, n_atoms, graphs, **pipeline) as staged:
            staged = iter(staged)
            while True:
                t0 = time.perf_counter()
                pb = next(staged, None)
                if split is not None:
                    split["queue_wait"] += time.perf_counter() - t0
                if pb is None:
                    return
                graphs.train(pb)

    turn_fns = {"eager": eager_turn, "graphed": graphed_turn, "pipelined": pipelined_turn,
                "serial": functools.partial(pipelined_turn, prefetch=False, native=False)}
    turns = collections.defaultdict(list)
    for mode in (*turn_fns, *reversed(turn_fns)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turn_fns[mode]()
        torch.cuda.synchronize()
        turns[mode].append(1e3 * (time.perf_counter() - t0) / timed)
    # the pipelined step's host time per step, from one more turn
    with host_split() as split:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipelined_turn(split)
        torch.cuda.synchronize()
        split_turn_ms = 1e3 * (time.perf_counter() - t0) / timed
    per = {k: 1e3 * v / timed for k, v in split.items()}
    per["copy"] = per["stage"] - per["slot_wait"]
    per["replay"] = split_turn_ms - per["queue_wait"] - per["stage"]
    gps = {m: batch * K * 1e3 / min(v) for m, v in turns.items()}
    print(f"[graphs {label}] ms/step over {timed} warmed steps, turns "
          + "/".join(turns) + ", then back: " + "; ".join(
              f"{m} {v[0]:.3f}/{v[1]:.3f}" for m, v in turns.items())
          + f" on {card}; graphs/s " + ", ".join(f"{m} {v:.1f}" for m, v in gps.items()))
    print(f"[graphs {label}] pipelined step, host ms per step ({split_turn_ms:.3f} ms a step):"
          f" queue wait {per['queue_wait']:.3f}, copy {per['copy']:.3f} (non-blocking), slot"
          f" wait {per['slot_wait']:.3f}, replay and the rest {per['replay']:.3f}; prefetch thread:"
          f" native packing {per['pack']:.3f} ms a batch (the foreign call {per['native']:.3f},"
          f" the interpreter lock held {per['pack'] - per['native']:.3f}); numpy packing"
          f" {numpy_ms:.3f} ms a batch")
    row = dict(eager_ms=turns["eager"], graphed_ms=turns["graphed"],
               pipelined_ms=turns["pipelined"], serial_ms=turns["serial"],
               **{f"{m}_gps": v for m, v in gps.items()}, numpy_pack_ms=numpy_ms,
               native_pack_ms=per["pack"], native_call_ms=per["native"],
               staged_copy_ms=per["copy"], slot_wait_ms=per["slot_wait"],
               queue_wait_ms=per["queue_wait"], pipelined_replay_ms=per["replay"],
               split_step_ms=split_turn_ms, loss_rel=loss_rel, weights_rel=w_rel,
               eval_rel=eval_rel, bit_identical=bits)
    if bary:
        # the launch counts of graphed steps are derived (LaunchReplays): the
        # graph's nodes and the profiler's executions must back them
        busy, per_step, seen = graphed_launches(f"[graphs {label}] profile, graphed", graphs,
                                                batches[0])
        ran = [seen[k] for k in SMALL_PROFILED] if schnet else [seen["fgw_couplings_kernel"]]
        require(all(ran), f"graphs {label}: the profiler saw {seen}")
        row.update(busy_share=busy, kernels_per_step=per_step)
    del runs, graphs, m_e, m_g, opt_e, opt_g
    torch.cuda.empty_cache()
    return row


def phase_graphs(device, card):
    """Phase 8: the train and eval steps as CUDA graphs, at full width."""
    return {label: graph_case(label, *case, device, card) for label, *case in GRAPH_CASES}


# ---------------------------------------------------------------- phase 9
# configs whose datasets the packer check packs, at their batch sizes (the
# stage-1 and stage-2 batches of sol250, sol1k_class's)
PACKER_DATA = (("config/schnet/sol250_5.yaml", (96, 24)),
               ("config/schnet/sol1k_class_5.yaml", (18,)))
PIPELINE_EPOCHS = 2


def packer_check(device):
    """The native packer against the numpy one, byte for byte, over every
    batch of every split of ``data/sol250`` and ``data/sol1k_class`` at their
    configs' batch sizes, in every bucket they reach: packed fresh and into
    one reused pinned buffer per shape."""
    import numpy as np

    from conan_fgw_tpu_torch.data import native
    from conan_fgw_tpu_torch.data.loader import bucketed_batches
    from conan_fgw_tpu_torch.data.packing import batch_layout, pack_batch
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.graphs import host_batch
    from conan_fgw_tpu_torch.train.runner import load_datasets

    out = {}
    for cfg, sizes in PACKER_DATA:
        ds = load_datasets(load_config(cfg), "data")
        splits = {m: ds[m].records() for m in ("train", "valid", "test")}
        buckets = loop.bucket_boundaries(loop.dataset_max_atoms(
            [r for recs in splits.values() for r in recs]))
        for batch in sizes:
            pinned, shapes, spent = {}, collections.Counter(), collections.Counter()

            def check(chunk, *, max_atoms, batch_size):
                t0 = time.perf_counter()
                want = pack_batch(chunk, max_atoms=max_atoms, batch_size=batch_size)
                t1 = time.perf_counter()
                got = native.pack_batch_native(chunk, max_atoms=max_atoms, batch_size=batch_size)
                spent["numpy"] += t1 - t0
                spent["native"] += time.perf_counter() - t1
                shape = want.z.shape
                if shape not in pinned:
                    pinned[shape] = host_batch(batch_layout(*shape), pin=device == "cuda")[1]
                into = native.pack_batch_native(chunk, max_atoms=max_atoms, batch_size=batch_size,
                                                out=pinned[shape])
                for name in ("z", "pos", "atom_mask", "x2d", "bond_adj", "bond_attr", "y",
                             "mol_mask"):
                    ref = getattr(want, name)
                    for other in (got, into):
                        a = getattr(other, name)
                        require(a.dtype == ref.dtype and a.shape == ref.shape
                                and np.array_equal(a.view(np.uint8), ref.view(np.uint8)),
                                f"packer check {cfg} batch {batch} N={max_atoms}: {name} differs")
                shapes[max_atoms] += 1
                return want

            for recs in splits.values():
                for _ in bucketed_batches(recs, batch, buckets, pack=check):
                    pass
            n = sum(shapes.values())
            label = f"{Path(cfg).stem} B={batch}"
            print(f"[packer] {label}: {n} batches byte-identical, native and numpy, fresh and into"
                  f" a reused pinned buffer, by bucket {dict(shapes)}; host ms a batch: numpy"
                  f" {1e3 * spent['numpy'] / n:.3f}, native {1e3 * spent['native'] / n:.3f}")
            out[label] = dict(batches=n, by_bucket=dict(shapes),
                              numpy_ms=1e3 * spent["numpy"] / n, native_ms=1e3 * spent["native"] / n)
    return out


def phase_pipeline(device, card):
    """Phase 9: the packer check, then two ``fit`` runs of sol250's stage 1
    (``config/schnet/sol250_5.yaml``, 2 epochs, from the same seeded model):
    through the host pipeline (prefetch, native packing into pinned slots)
    and with ``prefetch=False, native=False`` (numpy packing on the main
    thread, pageable copies). Losses and weights must agree bit for bit;
    prints both runs' ms per step by bucket."""
    import torch

    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.loop import fit
    from conan_fgw_tpu_torch.train.runner import STAGE_PRE, build_model, build_settings, load_datasets

    out = {"packer": packer_check(device)}
    config = load_config(RUNNER_STAGES[0][1])
    settings = build_settings(config, STAGE_PRE)
    settings.num_epochs = PIPELINE_EPOCHS
    ds = load_datasets(config, "data")

    def train_records(epoch):
        ds["train"].set_epoch(epoch)
        return ds["train"].records()

    runs = {}
    for mode, kw in (("serial numpy", dict(prefetch=False, native=False)), ("prefetched", {})):
        with runner_spies() as (plain_calls, _, _, host):
            res = fit(settings, train_records, ds["valid"].records(),
                      model=build_model(config, seed=settings.seed, device=device), device=device,
                      **kw)
        require(not plain_calls, f"pipeline {mode}: plain versions ran: {dict(plain_calls)}")
        if mode == "prefetched":
            require(host["staged_copy"] and not host["numpy_pack"] and not host["pageable_copy"],
                    f"pipeline {mode}: host pipeline {dict(host)}")
        else:
            require(host["numpy_pack"] and host["pageable_copy"] and not host["staged_copy"],
                    f"pipeline {mode}: host pipeline {dict(host)}")
        runs[mode] = res
        for r in res.history:
            print(f"[pipeline {mode}] epoch {r['epoch']}: {r['epoch_time_s']:.3f} s,"
                  f" {1e3 * r['train_s_n32'] / r['steps_n32']:.2f} ms/step at N=32"
                  f" ({r['steps_n32']} steps), {1e3 * r['train_s_n64'] / r['steps_n64']:.2f} at"
                  f" N=64 ({r['steps_n64']}), train_loss {r['train_loss']!r}, val_loss"
                  f" {r['val_loss']!r}; host pipeline {dict(host)} on {card}")
    a, b = runs["prefetched"], runs["serial numpy"]
    keys = ("train_loss", "val_loss", "val_mse", "val_rmse")
    same_losses = [[ra[k] for k in keys] for ra in a.history] == [[rb[k] for k in keys]
                                                                   for rb in b.history]
    same_weights = all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    print(f"[pipeline] sol250 stage 1, {PIPELINE_EPOCHS} epochs: prefetched and native against"
          f" serial numpy, losses bit-identical {same_losses}, weights bit-identical {same_weights}")
    require(same_losses and same_weights, "the prefetched run differs from the serial numpy run")
    for mode, res in runs.items():
        last = res.history[-1]
        out[mode] = dict(ms_n32=1e3 * last["train_s_n32"] / last["steps_n32"],
                         ms_n64=1e3 * last["train_s_n64"] / last["steps_n64"],
                         epoch_s=[r["epoch_time_s"] for r in res.history])
    return out


# ---------------------------------------------------------------- phase 10
# the ViSNet and DimeNet paths: (stage-1 config, stage-2 config) each
BACKBONES = {"visnet": ("config/visnet/sol250_5.yaml", "config/visnet/sol250_5_bc.yaml"),
             "dimenet": ("config/dimenet/sol250_5.yaml", "config/dimenet/sol250_5_bc.yaml")}
# what those paths launch: no cfconv, K3 in stage 2
BACKBONE_KERNELS = (None, None, "fgw_couplings")
# DimeNet's barycenter budget: alpha 0.5 with the structure held fixed
FGW_FIXED_KW = dict(FGW_KW, alpha=0.5)
MEMORY_STEPS = 3  # eager steps a stage and bucket; the last two are timed
# warmed steps a timing turn of phase 8's case (steps of 50-110 ms; 10 before PR 20)
BACKBONE_TIMED = 5


def check_fgw_fixed(device, rows):
    """K3 against its plain version at DimeNet's alpha 0.5 on a fixed
    structure (C1 the first conformer's cutoff-5 graph at every outer
    iteration) at DimeNet's stage-2 batch of 16 molecules, N=32 and N=64:
    the first outer iteration and the second (updated M, the first plans
    as T0, the same C1)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 7)
    for label, heavy, n_atoms in FGW_SHAPES[:2]:
        pos, mask = packed_geometry(SEED + 2000 + n_atoms, 16, heavy, n_atoms, device)
        args, Ys, Cs = fgw_problem(pos, mask, gen, cutoff=5.0)
        tag = "alpha05" if n_atoms == 32 else f"alpha05-{label}"
        check_fgw(tag, args, rows, FGW_FIXED_KW)
        check_fgw(f"{tag}-outer2", second_outer_inputs(args, Ys, Cs, FGW_FIXED_KW,
                                                      fixed_structure=True), rows, FGW_FIXED_KW)


def backbone_memory(name, device, card):
    """Eager train steps of the runner's model from each config at its own
    batch on ``data/sol250``'s molecules of one bucket (cycled to fill the
    batch), stage 1 and 2, N=32 and N=64: ms per step (the last two of
    ``MEMORY_STEPS``, each ending in a synchronise) and the peak of
    ``torch.cuda.max_memory_allocated`` from a fresh model on, less what
    was allocated before it."""
    import torch

    from conan_fgw_tpu_torch.data.packing import bucket_for, pack_batch
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import STAGE_BC, STAGE_PRE, build_model, build_settings
    from conan_fgw_tpu_torch.train.runner import load_datasets

    out = {}
    for stage, cfg in zip((STAGE_PRE, STAGE_BC), BACKBONES[name]):
        config = load_config(cfg)
        settings = build_settings(config, stage)
        records = load_datasets(config, "data")["train"].records()
        for n_atoms in (32, 64):
            pool = [r for r in records if bucket_for(r.num_atoms, (32, 64)) == n_atoms]
            recs = [pool[i % len(pool)] for i in range(settings.batch_size)]
            batch = pack_batch(recs, max_atoms=n_atoms, batch_size=settings.batch_size).to(device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # by earlier phases and the batch
            model = build_model(config, seed=SEED, device=device)
            opt = loop.make_optimizer(model, settings)
            times = []
            for _ in range(MEMORY_STEPS):
                t0 = time.perf_counter()
                loss, _ = loop.train_step(model, opt, batch, settings)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            ms = 1e3 * min(times[1:])
            require(bool(torch.isfinite(loss)), f"{name} {stage} N={n_atoms}: a non-finite loss")
            key = f"{'stage 1' if stage == STAGE_PRE else 'stage 2'} N{n_atoms}"
            print(f"[{name} memory] {key}, batch {settings.batch_size} (G={settings.batch_size * K}):"
                  f" eager {ms:.2f} ms/step, peak {peak:.2f} GiB allocated (model, Adam and the"
                  f" step, beyond what was held before) on {card}")
            out[key] = dict(eager_ms=ms, peak_gib=peak)
            del model, opt, batch
    torch.cuda.empty_cache()
    return out


def phase_backbones(device, card, rows):
    """Phase 10: the ViSNet and DimeNet paths. K3 at alpha 0.5 on a fixed
    structure; then per backbone: eager steps' time and peak memory by
    stage and bucket; the runner's two stages and predict on
    ``data/sol250`` (launch counts zeroed before each stage and read after
    it: no cfconv kernel, K3 in stage 2 only, no plain version, both
    buckets as CUDA graphs fed by the host pipeline, the warm start bit for
    bit, predict's RMSE the runner's, and the peak memory of each stage);
    one stage-2 step on the card against the CPU; and phase 8's case for
    stage 2 at N=32 at the stage-2 config's batch."""
    import torch

    from conan_fgw_tpu_torch.train import predict
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model

    check_fgw_fixed(device, rows)
    out = {}
    for name, (pre_cfg, bc_cfg) in BACKBONES.items():
        row = out[name] = {"memory": backbone_memory(name, device, card)}
        totals = collections.Counter()
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmpname, \
                runner_spies() as (plain_calls, restores, captures, host):
            tmp = Path(tmpname)
            common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                      "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                      "--metrics_dir", str(tmp / "metrics"), "--device", device]
            ctx = (common, tmp, plain_calls, captures, host, device, card)
            for stage, src in zip(("conan_fgw_pre", "conan_fgw"), (pre_cfg, bc_cfg)):
                first_restore = len(restores)
                cfg = config_copy(src, tmp, RUNNER_EPOCHS)
                label = f"{name} stage {1 if stage == 'conan_fgw_pre' else 2}"
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                summary, history, grew = runner_stage(label, stage, cfg, ctx,
                                                      kernels=BACKBONE_KERNELS)
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                print(f"[runner {label}] peak {peak:.2f} GiB allocated beyond what was held before"
                      f" (both buckets' train and eval graphs with their pools) on {card}")
                totals.update(grew)
                row[label] = dict(stage_row(history, summary, "rmse"), peak_gib=peak)
            check_warm_start(restores, first_restore,
                             tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
            reported = summary["test_rmse"]["mean"]
            rmse = run_main(predict.main, ["--config", cfg, "--checkpoint",
                                           str(tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"),
                                           "--data_root", ".", "--device", device,
                                           "--out", str(tmp / "preds.csv")])
            rel = abs(rmse - reported) / abs(reported)
            print(f"[runner {name}] predict on stage 2's best: test RMSE {rmse!r}, the runner's"
                  f" {reported!r}, rel {rel:.3e} (tol {PREDICT_RTOL})")
            require(rel <= PREDICT_RTOL, f"{name}: predict's test RMSE disagrees with the runner's")
            require(not plain_calls, f"{name}: plain versions ran: {dict(plain_calls)}")
        row["launches"] = {k: totals[k] for k in REPLACES}
        require(row["launches"]["fgw_couplings"] > 0, f"{name}: K3 never launched")
        config = load_config(bc_cfg)
        row["parity"] = phase_parity(build_model(config, seed=SEED, device=device), device,
                                     batch=config.batch_size // 2,
                                     label=f"{name} parity B{config.batch_size // 2}")
        row["graphs"] = graph_case(f"{name} stage 2 N32", False, True, 32, (8, 13),
                                   config.batch_size, device, card,
                                   base=build_model(config, seed=SEED, device=device),
                                   timed=BACKBONE_TIMED)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 11
# the ESAN configs the runner trains (stage 1)
ESAN_CONFIGS = ("config/esan/sol250_avg_conf.yaml", "config/esan/sol250_geometry.yaml")
# every head family other than conan (ExperimentSpec.model) with its K1
# launches a forward, K2 a train step: its SchNets' interactions
FAMILIES = {"esan:avg_conf_esan": 12, "esan:geometry_induced_esan": 12,
            "esan:geometry_2d_induced_esan": 6, "scalars": 6, "covalent": 6, "embeddings": 3,
            "attention": 3, "gat_only": 0}
FAMILY_BATCH = 32  # the ESAN configs' batch
FAMILY_TIMED = 5  # warmed steps a timing turn (10 before PR 20)
FAMILY_STEPS = 12  # batches of the eager-against-graphed run (phase 8's 20 before PR 20)
FAMILY_LR_AT = 6  # set_learning_rate after this many steps, in both runs
# molecules of the card-against-CPU step (the CPU side's cost; 32 before
# PR 20), but the attention head's full batch: its N=64 step's gradient
# norm lay 9.4e-4 from the CPU's, near the 1e-3 gate
FAMILY_PARITY_B = 16


def sol250_batch(records, n_atoms, batch, start=0):
    """``records``' molecules of the bucket ``n_atoms`` (cycled from
    ``start``) packed into one full host batch."""
    from conan_fgw_tpu_torch.data.packing import bucket_for, pack_batch

    pool = [r for r in records if bucket_for(r.num_atoms, (32, 64)) == n_atoms]
    recs = [pool[(start + i) % len(pool)] for i in range(batch)]
    return recs, pack_batch(recs, max_atoms=n_atoms, batch_size=batch)


def check_averaged(records, device, rows):
    """K1 and K2 against the plain version on the info-sharing SchNet's
    input: the averaged conformers of one sol250 batch of 32 at N=32 and
    N=64 (G=32 graphs), whose atoms lie far closer than a conformer's."""
    import torch

    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    gen = torch.Generator().manual_seed(SEED + 11)
    for n_atoms in (32, 64):
        _, pb = sol250_batch(records, n_atoms, FAMILY_BATCH)
        pb = pb.to(device)
        pos, mask = pb.pos.mean(1).contiguous(), pb.atom_mask
        dist = pairwise_distances(pos)
        pair = mask[:, :, None] & mask[:, None, :] & ~torch.eye(n_atoms, dtype=torch.bool,
                                                                 device=device)
        closest = torch.where(pair, dist, torch.full_like(dist, float("inf"))).amin(-1)[mask]
        within = radius_graph_mask(dist, mask, CUTOFF, None).sum(-1)[mask]
        capped = float((within > CAP).to(torch.float32).mean())
        print(f"[esan averaged N{n_atoms}] closest atom pair: smallest {float(closest.min()):.4f},"
              f" median {float(closest.median()):.4f} A; {100 * capped:.1f}% of atoms have more"
              f" than {CAP} neighbours within the cutoff")
        if n_atoms == 64:
            require(capped > 0, "averaged N=64 inputs never engage the neighbour cap")
        check_cfconv(f"avg-N{n_atoms}", pos, mask, gen, rows)


def family_case(spec, n_atoms, records, device, card):
    """One head family at one bucket, stage 1, at batch 32 on sol250's
    molecules: one step of ``FAMILY_PARITY_B`` of them (the attention
    head: 32) on the card against the CPU (phase 4's gates);
    ``FAMILY_STEPS`` steps eager (pre-packed batches) against graphed (the
    host pipeline), from identical weights through an lr change (phase 8's
    gates; the barycenter heads, which get no gradient, must stay
    bit-unchanged); the eval graph against eager eval; ms per step eager
    and graphed in turns; the peak memory of each run; and a profile of
    three graphed steps (busy share)."""
    import torch

    from conan_fgw_tpu_torch.data.loader import batches as host_batches
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.runner import build_aux_model

    label = f"{spec} N{n_atoms}"
    recs = [r for i in range(FAMILY_STEPS)
            for r in sol250_batch(records, n_atoms, FAMILY_BATCH, i * FAMILY_BATCH)[0]]
    batches = list(host_batches(recs, FAMILY_BATCH, n_atoms, pack=pack_batch))
    require(len(batches) == FAMILY_STEPS and all(pb.mol_mask.all() for pb in batches),
            f"{label}: the batches are not {FAMILY_STEPS} full ones")
    base = build_aux_model(spec, 128, seed=SEED, device=device)
    parity_b = FAMILY_BATCH if spec == "attention" else FAMILY_PARITY_B
    part = pack_batch(recs[:parity_b], max_atoms=n_atoms, batch_size=parity_b)
    row = {"parity": step_parity(base, part, device, f"{label} parity B{parity_b}", bary=False)}
    settings = loop.TrainSettings(batch_size=FAMILY_BATCH, learning_rate=1e-3)  # the ESAN configs'
    runs = {}
    for mode in ("eager", "graphed"):
        model = copy.deepcopy(base)
        opt = loop.make_optimizer(model, settings)
        graphs = loop.step_graphs(model, opt, settings, device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        before, losses = collections.Counter(launches), []
        if mode == "eager":
            for i, pb in enumerate(batches):
                if i == FAMILY_LR_AT:
                    loop.set_learning_rate(opt, 0.5 * settings.learning_rate)
                losses.append(loop.train_step(model, opt, pb.to(device), settings)[0])
        else:
            with kept_graphs(), loop.step_batches(recs, settings, n_atoms, graphs) as staged:
                for i, pb in enumerate(staged):
                    if i == FAMILY_LR_AT:
                        loop.set_learning_rate(opt, 0.5 * settings.learning_rate)
                    losses.append(graphs.train(pb)[0])
        torch.cuda.synchronize()
        row[f"{mode}_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        grew = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
        runs[mode] = (model, opt, graphs, torch.stack(losses), grew)
    (m_e, opt_e, _, loss_e, grew_e), (m_g, _, graphs, loss_g, grew_g) = runs["eager"], runs["graphed"]
    k1 = FAMILIES[spec]
    want = {"cfconv_fwd": k1 * FAMILY_STEPS, "cfconv_bwd": k1 * FAMILY_STEPS} if k1 else {}
    require(loss_e.isfinite().all(), f"{label}: a non-finite eager loss")
    loss_rel = _max_rel(loss_g, loss_e)
    w_rel = max(_max_rel(q.detach(), p.detach()) for p, q in zip(m_e.parameters(), m_g.parameters()))
    bits = bool(torch.equal(loss_e, loss_g)) and all(
        torch.equal(p, q) for p, q in zip(m_e.parameters(), m_g.parameters()))
    unused = [k for k, p in base.named_parameters() if "_bary" in k]
    kept = all(torch.equal(dict(m.named_parameters())[k], dict(base.named_parameters())[k])
               for m in (m_e, m_g) for k in unused)
    captured = sorted(k[0] for k, st in graphs.steps.items() if st.graph is not None)
    print(f"[{label}] {FAMILY_STEPS} steps eager vs graphed (host pipeline), lr halved after"
          f" {FAMILY_LR_AT}: losses rel {loss_rel:.3e}, weights rel {w_rel:.3e} (tol {GRAPH_RTOL});"
          f" bit-identical {bits}; {len(unused)} barycenter-head tensors unchanged {kept};"
          f" launches eager {grew_e} graphed {grew_g}; peak eager {row['eager_peak_gib']:.2f}"
          f" GiB, graphed {row['graphed_peak_gib']:.2f} GiB allocated on {card}")
    require(loss_rel <= GRAPH_RTOL and w_rel <= GRAPH_RTOL, f"{label}: eager and graphed differ")
    require(captured == (["train"] if device == "cuda" else []), f"{label}: captured {captured}")
    require(grew_e == grew_g == want, f"{label}: launches eager {grew_e} graphed {grew_g}, want {want}")
    require(kept, f"{label}: a barycenter head moved without a gradient")

    evals = batches[:4]
    before = collections.Counter(launches)
    preds_g = [graphs.eval(pb)[1] for pb in evals]
    grew_eval = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
    preds_e = [loop.eval_step(m_g, pb.to(device), settings)[1] for pb in evals]
    eval_rel = _max_rel(torch.cat(preds_g), torch.cat(preds_e))
    print(f"[{label}] eval graph vs eager eval, {len(evals)} batches: predictions rel"
          f" {eval_rel:.3e} (tol {GRAPH_EVAL_RTOL}); launches {grew_eval}")
    require(eval_rel <= GRAPH_EVAL_RTOL, f"{label}: the eval graph disagrees")
    require(grew_eval == ({"cfconv_fwd": len(evals) * k1} if k1 else {}),
            f"{label}: eval launches {grew_eval}")

    order = [batches[i % FAMILY_STEPS] for i in range(FAMILY_TIMED)]
    turn_fns = {"eager": lambda: [loop.train_step(m_e, opt_e, pb.to(device), settings)
                                  for pb in order],
                "graphed": lambda: [graphs.train(pb) for pb in order]}
    turns = collections.defaultdict(list)
    for mode in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turn_fns[mode]()
        torch.cuda.synchronize()
        turns[mode].append(1e3 * (time.perf_counter() - t0) / FAMILY_TIMED)
    # the graphed steps' launch counts are derived (LaunchReplays): the
    # profiler's executions must back them, as in phase 8
    busy, per_step, seen = graphed_launches(f"[{label}] profile, graphed", graphs, batches[0])
    print(f"[{label}] ms/step over {FAMILY_TIMED} warmed steps, turns eager/graphed, then back:"
          f" eager {turns['eager'][0]:.3f}/{turns['eager'][1]:.3f}, graphed"
          f" {turns['graphed'][0]:.3f}/{turns['graphed'][1]:.3f} on {card}")
    row.update(eager_ms=turns["eager"], graphed_ms=turns["graphed"], busy_share=busy,
               kernels_per_step=per_step, profiled=seen, loss_rel=loss_rel,
               weights_rel=w_rel, eval_rel=eval_rel, bit_identical=bits, launches=grew_g)
    del runs, graphs, m_e, m_g, opt_e, base
    torch.cuda.empty_cache()
    return row


def phase_esan(device, card, rows):
    """Phase 11: the ESAN and aux head families. K1/K2 on averaged
    conformers; the runner's stage 1 on the two ESAN configs with phase 5's
    checks (K1 exactly twelve a forward, K2 twelve a train step, no K3) and
    predict on their best; then every family step by step at N=32 and
    N=64 (``family_case``)."""
    import torch

    from conan_fgw_tpu_torch.train import predict
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import load_datasets

    records = load_datasets(load_config(ESAN_CONFIGS[0]), "data")["train"].records()
    check_averaged(records, device, rows)
    out = {"runner": {}, "families": {}}
    for src in ESAN_CONFIGS:
        name = Path(src).stem
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmpname, \
                runner_spies() as (plain_calls, _, captures, host):
            tmp = Path(tmpname)
            common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                      "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                      "--metrics_dir", str(tmp / "metrics"), "--device", device]
            ctx = (common, tmp, plain_calls, captures, host, device, card)
            cfg = config_copy(src, tmp, RUNNER_EPOCHS)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            summary, history, grew = runner_stage(name, "conan_fgw_pre", cfg, ctx, per_forward=12)
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            reported = summary["test_rmse"]["mean"]
            rmse = run_main(predict.main, ["--config", cfg, "--checkpoint",
                                           str(tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0"),
                                           "--data_root", ".", "--device", device,
                                           "--out", str(tmp / "preds.csv")])
            rel = abs(rmse - reported) / abs(reported)
            print(f"[runner {name}] peak {peak:.2f} GiB allocated beyond what was held before (both"
                  f" buckets' train and eval graphs with their pools) on {card}; predict on best:"
                  f" test RMSE {rmse!r}, the runner's {reported!r}, rel {rel:.3e} (tol {PREDICT_RTOL})")
            require(rel <= PREDICT_RTOL, f"{name}: predict's test RMSE disagrees with the runner's")
            require(not plain_calls, f"{name}: plain versions ran: {dict(plain_calls)}")
        out["runner"][name] = dict(stage_row(history, summary, "rmse"), peak_gib=peak,
                                   launches={k: grew[k] for k in REPLACES})
    for spec in FAMILIES:
        for n_atoms in (32, 64):
            out["families"][f"{spec} N{n_atoms}"] = family_case(spec, n_atoms, records, device, card)
    return out


# ---------------------------------------------------------------- phase 12
BF16 = "compute_dtype: bfloat16\n"
# bench.py's dimenet_n96_bf16 row: DimeNet stage 2 at B=8, K=5, N=96, where
# a bf16 edge-state chain overflowed in JAX (commit 31c42ad)
DIMENET_N96_BATCH, DIMENET_N96_STEPS = 8, 20
BF16_MEMORY_STEPS = 3  # eager steps for a peak; the last two are timed


def bf16_copy(src: str, out_dir: Path, epochs: int | None = None) -> str:
    """A copy of the YAML config ``src`` with ``compute_dtype: bfloat16``
    appended (and ``num_epochs: epochs`` where given)."""
    path = Path(config_copy(src, out_dir, epochs)) if epochs else out_dir / Path(src).name
    text = path.read_text() if epochs else Path(src).read_text()
    require("compute_dtype" not in text, f"{src} already sets compute_dtype")
    path = path.with_name(f"{path.stem}_bf16.yaml")
    path.write_text(text + BF16)
    return str(path)


def phase_bf16_kernels(device, rows):
    """Phase 12's kernel checks: K1/K2's bf16 variants against the bf16
    plain version on phase 2's inputs with bf16 node features and
    cotangent, at F=128 (G=120, N=32 and N=64 with the cap active) and at
    F=256 (G=90, N=32 and 64)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 12)
    for label, heavy, n_atoms in FGW_SHAPES[:2]:
        pos, mask = packed_geometry(SEED + n_atoms, B, heavy, n_atoms, device)
        check_cfconv(label, pos, mask, gen, rows, dtype=torch.bfloat16)
        pos, mask = packed_geometry(SEED + 1000 + n_atoms, B_CLS, heavy, n_atoms, device)
        check_cfconv(label, pos, mask, gen, rows, F_CLS, GAUSS_CLS, dtype=torch.bfloat16)


def eager_peak(label, model, batch, settings, card, steps=BF16_MEMORY_STEPS):
    """``steps`` eager train steps of ``model`` on ``batch`` (on the card):
    ms per step (the best of the last ``steps - 1``) and the peak of
    ``torch.cuda.max_memory_allocated`` beyond what was held before."""
    import torch

    from conan_fgw_tpu_torch.train import loop

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    opt = loop.make_optimizer(model, settings)
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(loop.train_step(model, opt, batch, settings)[0])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    ms = 1e3 * min(times[1:])
    finite = bool(torch.stack(losses).isfinite().all())
    print(f"[{label}] {steps} eager steps: {ms:.2f} ms/step, peak {peak:.2f} GiB allocated (Adam and"
          f" the step, beyond what was held before) on {card}; losses finite {finite}")
    require(finite, f"{label}: a non-finite loss")
    del opt
    return dict(eager_ms=ms, peak_gib=peak, losses=[float(v) for v in losses])


def _grew_only(label, before, allowed):
    """The launches since ``before`` touch only the kernels ``allowed``."""
    from conan_fgw_tpu_torch.ops.cuda import launches

    grew = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
    require(set(grew) <= set(allowed), f"{label}: kernels launched {grew}, want only {allowed}")
    return grew


def phase_bf16(device, card, rows, f32=None):
    """Phase 12: bf16 compute (``compute_dtype: bfloat16``). K1/K2's bf16
    variants against the bf16 plain version; the flagship SchNet at
    ``bench.py``'s ``mixed_precision`` shape (B=24, K=5, N=32): one stage-2
    step card against CPU (phase 4's gates), phase 8's eager-against-graphed
    case with its timed turns, and the peak memory of eager steps in f32 and
    bf16; the runner's stage 1 and stage 2 on bf16 copies of
    ``config/schnet/sol250_5*.yaml`` with phase 5's checks (only the bf16
    K1/K2 and K3 launch) and predict; the classification model's stage-2
    step at F=256 and batch 18 card against CPU, and its graphed case;
    DimeNet's stage-2 step at batch 16 card against CPU, its graphed case,
    the peak memory in f32 and bf16, and 20 training steps in bf16 and in
    f32 at ``bench.py``'s N=96 B=8 shape, which must stay finite. ``f32``
    holds the f32 figures of this run (phases 5, 8 and 10) to print beside."""
    import dataclasses

    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.train import loop, predict
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import STAGE_BC, build_model, build_settings

    f32 = f32 or {}
    out = {"kernels": {}}
    phase_bf16_kernels(device, rows)

    # the flagship at the mixed_precision shape
    model = ConanModel(seed=SEED, device=device, compute_dtype="bfloat16")
    require(all(b.compute_dtype == torch.bfloat16 for b in model.backbone.blocks),
            "the bf16 flagship's blocks are not bf16")
    before = collections.Counter(launches)
    out["parity"] = phase_parity(model, device, label="bf16 parity")
    _grew_only("bf16 parity", before, REGRESSION_BF16)
    before = collections.Counter(launches)
    out["graphs"] = graph_case("bf16 stage 2 N32", False, True, 32, (8, 13), B, device, card,
                               base=ConanModel(seed=SEED, device=device, compute_dtype="bfloat16"))
    _grew_only("bf16 graphs", before, REGRESSION_BF16)
    flag = f32.get("graphs", {})
    if flag:
        print(f"[graphs bf16 stage 2 N32] against f32 (phase 8, this run): eager"
              f" {min(out['graphs']['eager_ms']):.3f} vs {min(flag['eager_ms']):.3f}, graphed"
              f" {min(out['graphs']['graphed_ms']):.3f} vs {min(flag['graphed_ms']):.3f}, pipelined"
              f" {min(out['graphs']['pipelined_ms']):.3f} vs {min(flag['pipelined_ms']):.3f} ms/step"
              f" on {card}")
    recs = random_dataset(SEED + 3, B, num_conformers=K, heavy_range=(8, 10), device=device)
    batch = pack_batch(recs, max_atoms=32, batch_size=B).to(device)
    settings = loop.TrainSettings(batch_size=B, use_barycenter=True)
    out["memory"] = {
        dtype: eager_peak(f"bf16 memory flagship {dtype}",
                          ConanModel(seed=SEED, device=device, compute_dtype=dtype), batch,
                          settings, card)
        for dtype in ("float32", "bfloat16")}
    del model, batch

    # the runner on bf16 copies of the sol250 configs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as name, \
            runner_spies() as (plain_calls, restores, captures, host):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        totals, cfgs = collections.Counter(), {}
        for stage, src in RUNNER_STAGES:
            first_restore = len(restores)
            cfgs[stage] = bf16_copy(src, tmp, RUNNER_EPOCHS)
            label = "bf16 stage 1" if stage == "conan_fgw_pre" else "bf16 stage 2"
            summary, history, grew = runner_stage(label, stage, cfgs[stage], ctx,
                                                  kernels=REGRESSION_BF16)
            totals.update(grew)
            out[label] = stage_row(history, summary, "rmse")
        check_warm_start(restores, first_restore,
                         tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
        reported = summary["test_rmse"]["mean"]
        rmse = run_main(predict.main, ["--config", cfgs[STAGE_BC], "--checkpoint",
                                       str(tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"),
                                       "--data_root", ".", "--device", device,
                                       "--out", str(tmp / "preds.csv")])
        rel = abs(rmse - reported) / abs(reported)
        f32_rmse = f32.get("runner", {}).get("stage 2", {}).get("test_rmse")
        print(f"[runner bf16] predict on stage 2's best: test RMSE {rmse!r}, the runner's"
              f" {reported!r}, rel {rel:.3e} (tol {PREDICT_RTOL}); the f32 runner's (phase 5,"
              f" this run) {f32_rmse!r}")
        require(rel <= PREDICT_RTOL, "bf16: predict's test RMSE disagrees with the runner's")
        require(not plain_calls, f"bf16 runner: plain versions ran: {dict(plain_calls)}")
    out["launches"] = {k: totals[k] for k in REPLACES}
    for k in REGRESSION_BF16:
        require(out["launches"][k] > 0, f"bf16 runner: {k} never launched")

    # classification at F=256, sol1k_class's batch of 18
    model = ConanModel(seed=SEED, device=device, task="classification", hidden_channels=512,
                       num_filters=256, num_gaussians=GAUSS_CLS, compute_dtype="bfloat16")
    before = collections.Counter(launches)
    out["class_parity"] = phase_parity(model, device, batch=B_CLS, label="bf16 class parity")
    out["class_graphs"] = graph_case(
        "bf16 class stage 2 N32", True, True, 32, (8, 13), B_CLS, device, card,
        base=ConanModel(seed=SEED, device=device, task="classification", hidden_channels=512,
                        num_filters=256, num_gaussians=GAUSS_CLS, compute_dtype="bfloat16"))
    out["class_launches"] = _grew_only("bf16 classification", before, CLASSIFICATION_BF16)
    require(all(out["class_launches"].get(k, 0) > 0 for k in CLASSIFICATION_BF16),
            f"bf16 classification: launches {out['class_launches']}")
    del model

    # DimeNet: bf16 triplet tensors
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_dimenet_") as name:
        cfg = load_config(bf16_copy(BACKBONES["dimenet"][1], Path(name)))
    require(cfg.compute_dtype == "bfloat16", "the DimeNet copy is not bf16")
    f32_cfg = load_config(BACKBONES["dimenet"][1])
    out["dimenet_parity"] = phase_parity(build_model(cfg, seed=SEED, device=device), device,
                                         batch=cfg.batch_size // 2,
                                         label=f"bf16 dimenet parity B{cfg.batch_size // 2}")
    before = collections.Counter(launches)
    out["dimenet_graphs"] = graph_case("bf16 dimenet stage 2 N32", False, True, 32, (8, 13),
                                       cfg.batch_size, device, card,
                                       base=build_model(cfg, seed=SEED, device=device),
                                       timed=BACKBONE_TIMED)
    _grew_only("bf16 dimenet", before, ("fgw_couplings",))
    dn32 = f32.get("backbones", {}).get("dimenet", {}).get("graphs", {})
    if dn32:
        print(f"[graphs bf16 dimenet stage 2 N32] against f32 (phase 10, this run): graphed"
              f" {min(out['dimenet_graphs']['graphed_ms']):.3f} vs {min(dn32['graphed_ms']):.3f}"
              f" ms/step on {card}")
    settings = build_settings(cfg, STAGE_BC)
    recs = random_dataset(SEED + 12, cfg.batch_size, num_conformers=K, heavy_range=(8, 13),
                          device=device)
    batch = pack_batch(recs, max_atoms=32, batch_size=cfg.batch_size).to(device)
    out["dimenet_memory"] = {
        name: eager_peak(f"bf16 memory dimenet N32 B{cfg.batch_size} {name}",
                         build_model(c, seed=SEED, device=device), batch, settings, card)
        for name, c in (("float32", f32_cfg), ("bfloat16", cfg))}
    # bench.py's dimenet_n96_bf16 shape: the steps must stay finite. The
    # model starts near 1e20 (the edge state grows some 30x a block at
    # random weights), so this shows only that nothing reaches inf; the f32
    # losses of the same steps stand beside
    recs = random_dataset(SEED + 96, DIMENET_N96_BATCH, num_conformers=K, heavy_range=(48, 54),
                          device=device)
    batch = pack_batch(recs, max_atoms=96, batch_size=DIMENET_N96_BATCH).to(device)
    settings = dataclasses.replace(build_settings(cfg, STAGE_BC), batch_size=DIMENET_N96_BATCH)
    out["dimenet_n96"] = {
        name: eager_peak(f"bf16 dimenet N96 B{DIMENET_N96_BATCH} {name}",
                         build_model(c, seed=SEED, device=device), batch, settings, card,
                         steps=DIMENET_N96_STEPS)
        for name, c in (("float32", f32_cfg), ("bfloat16", cfg))}
    print(f"[bf16 dimenet N96] {DIMENET_N96_STEPS} steps at lr {settings.learning_rate}, all"
          " finite; losses " + "; ".join(
              f"{name} {run['losses'][0]:.6e} -> {run['losses'][-1]:.6e}"
              for name, run in out["dimenet_n96"].items()))
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- determinism
DET_STEPS = 3  # stage-1 steps, then as many stage-2 steps, from the same weights
# graphed steps per stage: the shape's eager warm-up, the capture with its
# first replay, then replays
DET_GRAPH_STEPS = 4
# the head families whose stage-1 steps the workers run too (at batch 32):
# K1/K2 at depth 6, the GAT's 50-wide edge features, the covalent block
DET_AUX = {"esan_geometry": "esan:geometry_induced_esan", "covalent": "covalent"}


def _digest(*arrays) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def determinism_worker(out_path: str, deterministic: bool) -> int:
    """One fresh process's run of the seeded steps: ``DET_STEPS`` stage-1
    steps at batch 96 and ``DET_STEPS`` stage-2 steps at batch 24 on
    ``data/sol250``'s first train records, from the seeded flagship model,
    then ``DET_STEPS`` stage-2 steps of the runner's seeded ViSNet and
    DimeNet models at their stage-2 configs' batches, stage-1 steps of the
    ``DET_AUX`` heads and stage-2 steps of the bf16 flagship (``compute_dtype:
    bfloat16``) at batch 24. Writes, per step, the
    batch's digest, the loss's bits, each gradient's digest before the clip
    and each weight's digest after the update, to ``out_path`` (JSON). Then,
    from the seeded models again, ``DET_GRAPH_STEPS`` steps a stage through
    ``StepGraphs`` on the N=32 molecules, their batches through the host
    pipeline (prefetch, native packing into pinned slots; stages ``g1``,
    ``g2``, ``gvisnet``, ``gdimenet``, the aux heads' and ``gbf16``), whose gradients are read after the
    clip from the graph's static tensors. ``deterministic`` runs the eager
    steps only, under ``torch.use_deterministic_algorithms(True)``, which
    raises naming an operation that has no deterministic implementation."""
    import os

    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before CUDA starts
    import struct

    import torch

    from conan_fgw_tpu_torch.data.datasets import ConformerDataset
    from conan_fgw_tpu_torch.data.loader import bucketed_batches
    from conan_fgw_tpu_torch.device import pin_full_f32
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.loop import (
        TrainSettings,
        clip_by_global_norm_,
        make_optimizer,
        masked_mse,
        step_batches,
        step_graphs,
    )
    from conan_fgw_tpu_torch.train.runner import build_aux_model, build_model

    pin_full_f32()
    torch.use_deterministic_algorithms(deterministic)
    records = ConformerDataset("train", "data", "sol250", "logS_surrogate", K).records()[:192]
    rows, t_steps, graph_s = [], [], []

    def eager_steps(model, settings, stage):
        opt = make_optimizer(model, settings)
        batches = bucketed_batches(records, settings.batch_size, buckets=(32, 64))
        for _, pb in zip(range(DET_STEPS), batches):
            row = {"stage": stage,
                   "batch": _digest(*(getattr(pb, f) for f in ("z", "pos", "atom_mask", "y")))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = pb.to("cuda")
            opt.zero_grad(set_to_none=True)
            pred, _ = model(batch, use_barycenter=settings.use_barycenter)
            loss = masked_mse(pred, batch)
            loss.backward()
            row["loss"] = struct.pack("<f", float(loss.detach())).hex()
            row["grads"] = {k: _digest(p.grad.cpu().numpy()) for k, p in model.named_parameters()
                            if p.grad is not None}
            clip_by_global_norm_(list(model.parameters()), settings.grad_clip)
            opt.step()
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
            row["weights"] = {k: _digest(p.detach().cpu().numpy()) for k, p in model.named_parameters()}
            rows.append(row)

    def graphed_steps(model, settings, stage):
        # the N=32 molecules, cycled, through the host pipeline as fit takes
        # them: prefetched, packed natively into pinned slots
        names = [k for k, _ in model.named_parameters()]
        graphs = step_graphs(model, make_optimizer(model, settings), settings, "cuda")
        n32 = [r for r in records if r.num_atoms <= 32]
        stream = [n32[i % len(n32)] for i in range(DET_GRAPH_STEPS * settings.batch_size)]
        with step_batches(stream, settings, 32, graphs) as staged:
            for pb in staged:
                digest = _digest(*(getattr(pb, f) for f in ("z", "pos", "atom_mask", "y")))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _ = graphs.train(pb)
                torch.cuda.synchronize()
                graph_s.append(time.perf_counter() - t0)
                rows.append({
                    "stage": stage,
                    "batch": digest,
                    "loss": struct.pack("<f", float(loss)).hex(),
                    "grads": {k: _digest(g.cpu().numpy()) for k, g in zip(names, graphs.grads)
                              if g is not None},
                    "weights": {k: _digest(p.detach().cpu().numpy())
                                for k, p in model.named_parameters()},
                })
        require(graphs.pools, "the determinism worker's graphed steps had no pinned slots")
        require(sum(s.graph is not None for s in graphs.steps.values()) == 1,
                "the determinism worker captured no graph")

    schnet_stages = ((False, 96), (True, 24))
    backbones = {name: load_config(bc_cfg) for name, (_, bc_cfg) in BACKBONES.items()}
    aux_settings = TrainSettings(batch_size=FAMILY_BATCH)
    model = ConanModel(seed=SEED, device="cuda")
    for bary, batch_size in schnet_stages:
        eager_steps(model, TrainSettings(batch_size=batch_size, use_barycenter=bary), 2 if bary else 1)
    for name, config in backbones.items():
        eager_steps(build_model(config, seed=SEED, device="cuda"),
                    TrainSettings(batch_size=config.batch_size, use_barycenter=True), name)
    for name, spec in DET_AUX.items():
        eager_steps(build_aux_model(spec, 128, seed=SEED, device="cuda"), aux_settings, name)
    bf16_settings = TrainSettings(batch_size=24, use_barycenter=True)
    eager_steps(ConanModel(seed=SEED, device="cuda", compute_dtype="bfloat16"), bf16_settings,
                "bf16")
    if not deterministic:
        model = ConanModel(seed=SEED, device="cuda")
        for bary, batch_size in schnet_stages:
            graphed_steps(model, TrainSettings(batch_size=batch_size, use_barycenter=bary),
                          f"g{2 if bary else 1}")
        for name, config in backbones.items():
            graphed_steps(build_model(config, seed=SEED, device="cuda"),
                          TrainSettings(batch_size=config.batch_size, use_barycenter=True), f"g{name}")
        for name, spec in DET_AUX.items():
            graphed_steps(build_aux_model(spec, 128, seed=SEED, device="cuda"), aux_settings,
                          f"g{name}")
        graphed_steps(ConanModel(seed=SEED, device="cuda", compute_dtype="bfloat16"),
                      bf16_settings, "gbf16")
    Path(out_path).write_text(json.dumps({"steps": rows, "step_s": t_steps, "graph_step_s": graph_s}))
    return 0


def _start_worker(path: Path, deterministic: bool, logs: Path) -> subprocess.Popen:
    """A determinism worker writing ``path``, its output to a file in ``logs``."""
    log = open(logs / f"{path.stem}.log", "w")
    with log:
        return subprocess.Popen([sys.executable, __file__, "--determinism-worker", str(path),
                                 "1" if deterministic else "0"], stdout=log,
                                stderr=subprocess.STDOUT, text=True)


def _finish_workers(procs: dict, logs: Path) -> dict:
    """Waits for every worker (all are stopped if one fails) and returns
    each one's JSON by its file's stem."""
    try:
        for path, proc in procs.items():
            code = proc.wait(timeout=600)
            require(code == 0, f"determinism worker {path.stem} failed:\n"
                    + (logs / f"{path.stem}.log").read_text()[-3000:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {path.stem: json.loads(path.read_text()) for path in procs}


def _first_difference(a: dict, b: dict):
    """``(step, stage, what differs)`` of two workers' runs, or None."""
    for k, (ra, rb) in enumerate(zip(a["steps"], b["steps"])):
        diff = {key: [n for n in ra[key] if ra[key][n] != rb[key].get(n)]
                for key in ("grads", "weights")}
        diff.update({key: ra[key] != rb[key] for key in ("batch", "loss")})
        if any(diff.values()):
            return k, ra["stage"], diff
    return None


def phase_determinism():
    """Reproducibility across processes: two fresh processes run
    ``determinism_worker`` as a user's run does, and their batches, losses,
    gradients and weights must agree bit for bit; a third runs it under
    ``torch.use_deterministic_algorithms(True)`` and must finish (torch
    raises on an operation of the path that has no deterministic
    implementation). The three run at once, sharing the card (their step
    times are each one's share of it). Prints the first difference, if
    any, and the step times of both modes."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as name:
        tmp = Path(name)
        runs = {tmp / "run0.json": False, tmp / "run1.json": False, tmp / "strict.json": True}
        procs = {path: _start_worker(path, strict, tmp) for path, strict in runs.items()}
        done = _finish_workers(procs, tmp)
    a, b, strict = done["run0"], done["run1"], done["strict"]
    first = _first_difference(a, b)
    ms = [1e3 * min(x, y) for x, y in zip(a["step_s"], b["step_s"])]
    print(f"[determinism] step ms (the faster process): " + ", ".join(f"{v:.2f}" for v in ms)
          + "; under deterministic algorithms: "
          + ", ".join(f"{1e3 * v:.2f}" for v in strict["step_s"]))
    same_strict = _first_difference(a, strict) is None
    print(f"[determinism] deterministic-algorithms run finished; bit-identical to the default"
          f" runs: {same_strict}")
    if first is not None:
        k, stage, diff = first
        print(f"[determinism] first difference at step {k} (stage {stage}): batch {diff['batch']},"
              f" loss {diff['loss']}, gradients {diff['grads'][:8]}, weights {diff['weights'][:8]}")
    require(first is None, "two processes of the same seeded steps differ")
    graphed = sum(str(r["stage"]).startswith("g") for r in a["steps"])
    # SchNet stage 1 and 2, the backbones, the aux heads and the bf16 flagship
    require(graphed == (3 + len(BACKBONES) + len(DET_AUX)) * DET_GRAPH_STEPS,
            f"the workers ran {graphed} graphed steps")
    graph_ms = [1e3 * min(x, y) for x, y in zip(a["graph_step_s"], b["graph_step_s"])]
    print(f"[determinism] two processes: batches, losses, gradients and weights bit-identical over"
          f" {len(a['steps'])} steps ({len(a['steps']) - graphed} eager, {graphed} through CUDA"
          f" graphs; SchNet stage 1 and stage 2, ViSNet and DimeNet stage 2, the geometry ESAN and"
          f" the covalent head stage 1, the bf16 flagship stage 2); graphed step ms"
          f" (the faster process, each with a"
          " synchronise): " + ", ".join(f"{v:.2f}" for v in graph_ms))
    return dict(steps=len(a["steps"]), step_ms=ms, graph_step_ms=graph_ms,
                strict_step_ms=[1e3 * v for v in strict["step_s"]], strict_identical=same_strict)


# ---------------------------------------------------------------- phase 13
# the per-molecule K3 wrapper's atom counts: padded to 32, a full bucket,
# padded to 64
MOL_SIZES = (11, 32, 53)
MOL_ATOMS = 23  # the per-molecule barycenter's molecule (padded to 32 on the card)
MOL_D = 8       # its feature width
BARY_ATOL = 1e-3   # barycenter Y and C, card against CPU: the CPU tests' tolerance
BARY_GRAD_RTOL = 1e-4  # the gradient w.r.t. Ys in norm: the CPU tests' tolerance
VARIANT_ATOL = 1e-5  # the seven variants' plans, card against CPU
MOL_BATCH = 4  # molecules of the batched barycenter held against per-molecule calls
# the deep budget through the runner: stage 1, then stage 2 warm-started
DEEP_STAGES = (("conan_fgw_pre", "config/schnet/sol1k_5.yaml"),
               ("conan_fgw", "config/schnet/sol1k_5_bc_deep.yaml"))
DEEP_EPOCHS = 2  # the second epoch's steps are replays: its ms/step is the steady state
# the deep stage-2 step, card against CPU: the larger of phase 4's gate and 4
# times the largest distance of a plain f32 CPU step from its float64 step.
# `scripts/torch_precision_probe.py --deep --cpu` measured that distance on
# this step's model and batch before any card ran it: 1.046e-6 (loss and
# gradient norm, the plain step and four draws of 1e-7 weight noise), so the
# deep budget asks for no wider gate than phase 4's
DEEP_STEP_RTOL = max(STEP_RTOL, 4 * 1.046e-6)
# the barycenter's options held card against CPU: (label, FGWConfig fields,
# init_C from the conformers' mean structure)
BARY_OPTIONS = (("default", {}, False), ("warmstart off, init_C", {"warmstart": False}, True),
                ("fixed_features", {"fixed_features": True}, False),
                ("fixed_structure", {"fixed_structure": True}, False),
                ("kl_loss", {"loss_fun": "kl_loss"}, False),
                ("no stop-gradient", {"stop_grad_couplings": False}, False))


def molecule_problem(n, seed, device, D=MOL_D):
    """One molecule of ``n`` atoms in K conformers: features ``Ys (K, n, D)``
    in [0.1, 1.1] (the JAX tests' well-conditioned range), the conformers'
    0/1 radius-graph structure ``Cs (K, n, n)`` (random positions of 2 A
    spread, cutoff 4 A), uniform marginals ``ps (K, n)`` and ``p (n,)``."""
    import torch

    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    gen = torch.Generator().manual_seed(seed)
    pos = torch.randn(K, n, 3, generator=gen) * 2.0
    Cs = radius_graph_mask(pairwise_distances(pos), torch.ones(K, n, dtype=torch.bool), 4.0,
                           None).to(torch.float32)
    Ys = torch.rand(K, n, D, generator=gen) + 0.1
    p = torch.full((n,), 1.0 / n)
    return [t.to(device) for t in (Ys, Cs, p.expand(K, n).contiguous(), p)]


def mol_args(n, device):
    """K3' inputs of one molecule of ``n`` atoms (``molecule_problem``, a
    later outer iteration's features): ``fgw_couplings``' arguments ``(Ms,
    Cb, Cks, p, qs, T0s)`` and K3's, as that wrapper pads them to the next
    multiple of 32 (its flat solves, the barycenter structure repeated)."""
    import torch
    import torch.nn.functional as Fn

    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist

    Ys, Cs, ps, p = molecule_problem(n, SEED + n, device)
    gen = torch.Generator().manual_seed(SEED + 2 * n)
    Y0 = (torch.rand(n, Ys.shape[-1], generator=gen) + 0.1).to(device)
    Ms = sqdist(Y0[None], Ys).contiguous()  # a later outer iteration's features
    T0 = (p[None, :, None] * ps[:, None, :]).contiguous()
    N = n + (-n % 32)
    pad = lambda x: Fn.pad(x, (0, N - n) if x.dim() == 2 else (0, N - n, 0, N - n)).contiguous()  # noqa: E731
    padded = (pad(Ms), pad(Cs[0].expand(K, n, n)), pad(Cs), pad(p.expand(K, n)), pad(ps), pad(T0))
    return (Ms, Cs[0], Cs, p, ps, T0), padded


def check_fgw_mol(n, device, rows, kw=FGW_KW):
    """K3's per-molecule wrapper (``fgw_couplings``, n padded to a multiple of
    32 and left out of the solve) on the card against the unpadded plain
    solve on the CPU, K = 5: the plans within ``FGW_ATOL``, equal counts of
    diverged solves, exactly one K3 launch a call; its time and bound."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.ops.cuda.fgw import _couplings, fgw_couplings, launch_name
    from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling

    name = launch_name("fgw_couplings_mol", n + (-n % 32))
    args, padded = mol_args(n, device)
    Ms, _, Cs, p, ps, T0 = args
    N = n + (-n % 32)
    # the Sinkhorn iterations K3 runs on the wrapper's padded input, for the bound
    _, (_, iters) = _couplings(*padded, n=n, count="uncounted", **kw)
    sk_run = int(iters.sum())
    reset_launches()
    T_k, (count_k, _) = fgw_couplings(*args, **kw)
    torch.cuda.synchronize()
    counted = {k: v for k, v in launches.items() if v}
    Ms_c, Cb_c, Cs_c, p_c, ps_c, T0_c = (t.cpu() for t in args)
    T_p, div_p, _ = fgw_coupling(Ms_c, Cb_c.expand(K, n, n), Cs_c, p_c.expand(K, n), ps_c, T0_c,
                                 **kw)
    err = float((T_k.cpu() - T_p).abs().max())
    print(f"[fgw mol N{n}] K3 on {N} rows (n={n}) against the unpadded plain solve on the CPU:"
          f" T max_abs_err {err:.3e} (tol {FGW_ATOL}); diverged kernel {int(count_k)} plain"
          f" {int(div_p.sum())}; launches {counted}; {sk_run} Sinkhorn iterations run of"
          f" {K * kw['pgd_iters'] * kw['sinkhorn_iters']} budgeted")
    require(tuple(T_k.shape) == (K, n, n) and count_k.dtype == torch.int32 and count_k.dim() == 0,
            f"fgw mol N{n}: returned {tuple(T_k.shape)}, {count_k.dtype}")
    require(counted == {name: 1}, f"fgw mol N{n}: launches {counted}, want one K3")
    require(err <= FGW_ATOL, f"fgw mol N{n} plans disagree: {err}")
    require(int(count_k) == int(div_p.sum()), f"fgw mol N{n} diverged counts disagree")
    ms = cuda_ms(lambda: fgw_couplings(*args, **kw))
    replay_ms = graph_ms(lambda: fgw_couplings(*args, **kw))
    plain_ms = cuda_ms(lambda: fgw_coupling(Ms, Cs[0].expand(K, n, n), Cs, p.expand(K, n), ps, T0,
                                            **kw), reps=3, warmup=1)
    tc, f32 = fgw_bound(K, n, sk_run, kw)
    print(f"[fgw mol N{n}] K={K}: wrapper {ms:.4f} ms (eager calls, padding included; graph replays"
          f" {replay_ms:.4f} ms), plain {plain_ms:.4f} ms on the card; bound {tc[0]:.6f} ms ({tc[1]},"
          f" {100 * tc[0] / ms:.2f}% reached), {f32[0]:.6f} ms in f32 on the CUDA cores")
    rows[name][f"N{n}"] = dict(max_abs_err=err, ms=ms, graph_ms=replay_ms,
                                              plain_ms=plain_ms, bound=tc, bound_f32=f32,
                                              sinkhorn_iters=sk_run)


def _barycenter_run(Ys, Cs, ps, p, config, init_C, R):
    """``fgw_barycenter`` with ``return_diverged``, then the gradient of
    ``sum(Y * R)`` with respect to ``Ys`` (None with fixed features):
    ``(Y, C, n_div, grad)``."""
    import torch

    from conan_fgw_tpu_torch.ops.fgw import fgw_barycenter

    Ys = Ys.detach().clone().requires_grad_(True)
    lam = torch.full((K,), 1.0 / K, device=Ys.device)
    Y, C, n_div = fgw_barycenter(Ys, Cs, ps, p, lam, config, init_C=init_C, return_diverged=True)
    grad = None
    if Y.requires_grad:
        (Y * R).sum().backward()
        grad = Ys.grad
    return Y.detach(), C.detach(), int(n_div), grad


def check_barycenters(device):
    """The per-molecule barycenter on the card against the same call on the
    CPU for each option of ``BARY_OPTIONS``: Y and C within ``BARY_ATOL``,
    equal diverged counts, the gradient w.r.t. ``Ys`` within
    ``BARY_GRAD_RTOL`` in norm; ``outer_iters`` K3 launches a call on the
    kernel's route and none on the plain one. Launch counts are zeroed just
    before and read just after: this is the slice's main path."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.ops.fgw import FGWConfig

    Ys, Cs, ps, p = molecule_problem(MOL_ATOMS, SEED + 77, device)
    R = torch.randn(MOL_ATOMS, MOL_D, generator=torch.Generator().manual_seed(SEED + 78)).to(device)
    out = {}
    reset_launches()
    for label, opts, init in BARY_OPTIONS:
        cfg = FGWConfig(**opts)
        C_in = 0.1 + 0.8 * Cs if cfg.loss_fun == "kl_loss" else Cs  # the KL loss takes logs
        init_C = C_in.mean(0) if init else None
        before = collections.Counter(launches)
        Y_k, C_k, nd_k, g_k = _barycenter_run(Ys, C_in, ps, p, cfg, init_C, R)
        torch.cuda.synchronize()
        grew = {k: v - before[k] for k, v in launches.items() if v - before[k]}
        cpu = [t.cpu() for t in (Ys, C_in, ps, p)]
        Y_c, C_c, nd_c, g_c = _barycenter_run(*cpu, cfg, None if init_C is None else init_C.cpu(),
                                              R.cpu())
        err_y = float((Y_k.cpu() - Y_c).abs().max())
        err_c = float((C_k.cpu() - C_c).abs().max())
        grad_rel = (None if g_c is None else
                    float((g_k.cpu() - g_c).norm() / g_c.norm()))
        want = {"fgw_couplings_mol": cfg.outer_iters} if cfg.uses_kernel() else {}
        print(f"[fgw barycenter {label}] n={MOL_ATOMS}, K={K}: Y max_abs_err {err_y:.3e}, C"
              f" {err_c:.3e} (tol {BARY_ATOL}); diverged card {nd_k} CPU {nd_c}; gradient"
              f" w.r.t. Ys rel {grad_rel if grad_rel is None else f'{grad_rel:.3e}'}"
              f" (tol {BARY_GRAD_RTOL}); launches {grew}")
        require(grew == want, f"fgw barycenter {label}: launches {grew}, want {want}")
        require(err_y <= BARY_ATOL and err_c <= BARY_ATOL, f"fgw barycenter {label} disagrees")
        require(nd_k == nd_c, f"fgw barycenter {label}: diverged counts disagree")
        require((g_k is None) == (g_c is None) and (grad_rel is None or grad_rel <= BARY_GRAD_RTOL),
                f"fgw barycenter {label}: the gradient disagrees")
        out[label] = dict(y_err=err_y, c_err=err_c, grad_rel=grad_rel)
    out["launches"] = {k: launches[k] for k in REPLACES}
    require(out["launches"]["fgw_couplings_mol"] > 0, "the per-molecule K3 never launched")
    return out


def check_batched_barycenter(device):
    """The batched barycenter (one ``fgw_couplings_flat`` launch an outer
    iteration over all B*K solves) against per-molecule calls (one
    ``fgw_couplings`` launch each), all on the card, at N = 32."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.ops.fgw import FGWConfig, fgw_barycenter, fgw_barycenter_batch

    mols = [molecule_problem(32, SEED + 90 + b, device) for b in range(MOL_BATCH)]
    Ys = torch.stack([m[0] for m in mols])
    Cs = torch.stack([m[1] for m in mols])
    cfg = FGWConfig()
    reset_launches()
    Y_b, C_b, (n_b, _) = fgw_barycenter_batch(Ys, Cs, config=cfg)
    lam = torch.full((K,), 1.0 / K, device=device)
    per = [fgw_barycenter(m[0], m[1], m[2], m[3], lam, cfg, return_diverged=True) for m in mols]
    torch.cuda.synchronize()
    err_y = max(float((Y_b[b] - per[b][0]).abs().max()) for b in range(MOL_BATCH))
    err_c = max(float((C_b[b] - per[b][1]).abs().max()) for b in range(MOL_BATCH))
    counted = {k: v for k, v in launches.items() if v}
    print(f"[fgw batched] B={MOL_BATCH}, K={K}, N=32: batched against per-molecule calls on the"
          f" card: Y max_abs_err {err_y:.3e}, C {err_c:.3e} (tol {BARY_ATOL}); diverged"
          f" {int(n_b)} and {sum(int(x[2]) for x in per)}; launches {counted}")
    want = {"fgw_couplings": cfg.outer_iters, "fgw_couplings_mol": MOL_BATCH * cfg.outer_iters}
    require(counted == want, f"fgw batched: launches {counted}, want {want}")
    require(err_y <= BARY_ATOL and err_c <= BARY_ATOL, "fgw batched disagrees with per-molecule")
    require(int(n_b) == sum(int(x[2]) for x in per), "fgw batched: diverged counts disagree")
    return dict(y_err=err_y, c_err=err_c)


def variant_calls():
    """The seven solvers of ``ops/fgw/variants.py`` at ``tests/test_fgw_variants.py``'s
    sizes: ``(label, function, numpy arguments, keywords)``."""
    import numpy as np

    from conan_fgw_tpu_torch.ops.fgw import variants as v

    rng = np.random.default_rng(SEED)
    cost = (rng.random((9, 9)) * 2).astype(np.float32)
    u9 = np.full((9,), 1.0 / 9, np.float32)
    N = 8
    M = rng.random((N, N)).astype(np.float32)
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    Bm = (rng.random((N, N)) < 0.4).astype(np.float32)
    u8 = np.full((N,), 1.0 / N, np.float32)
    Ys = rng.random((3, N, 4)).astype(np.float32)
    Cs = (rng.random((3, N, N)) < 0.4).astype(np.float32)
    Cs = np.maximum(Cs, Cs.transpose(0, 2, 1))
    bary = (Ys, Cs, np.full((3, N), 1.0 / N, np.float32), u8, np.full((3,), 1.0 / 3, np.float32))
    return (("sinkhorn_knopp", v.sinkhorn_knopp, (u9, u9, cost, 0.1), {}),
            ("sinkhorn_stabilized", v.sinkhorn_stabilized, (u9, u9, cost, 0.1), {}),
            ("sinkhorn_epsilon_scaling", v.sinkhorn_epsilon_scaling, (u9, u9, cost, 0.1),
             {"num_iters": 400}),
            ("greenkhorn", v.greenkhorn, (u9, u9, cost, 0.1), {"num_iters": 3000}),
            ("fgw_coupling_bapg", v.fgw_coupling_bapg, (M, A, Bm, u8, u8),
             {"alpha": 0.3, "rho": 0.1, "num_iters": 40}),
            ("fgw_coupling_bregman", v.fgw_coupling_bregman, (M, A, Bm, u8, u8),
             {"alpha": 0.5, "epsilon": 0.5, "num_iters": 50}),
            ("fgw_barycenter_bapg", v.fgw_barycenter_bapg, bary,
             {"alpha": 0.5, "rho": 1.0, "outer_iters": 3, "coupling_iters": 30}))


def check_variants(device):
    """Each variant on CUDA tensors against the same call on the CPU, within
    ``VARIANT_ATOL``; none launches a kernel of the port."""
    import numpy as np
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches

    out = {}
    reset_launches()
    for label, fn, args, kw in variant_calls():
        def call(dev):
            res = fn(*[torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
                       for a in args], **kw)
            return [t.detach().cpu() for t in (res if isinstance(res, tuple) else (res,))]

        t0 = time.perf_counter()
        card = call(device)
        card_s = time.perf_counter() - t0
        err = max(float((a - b).abs().max()) for a, b in zip(card, call("cpu")))
        print(f"[fgw variants] {label}: card against CPU max_abs_err {err:.3e} (tol"
              f" {VARIANT_ATOL}); {1e3 * card_s:.1f} ms on the card (host clock, first call)")
        require(err <= VARIANT_ATOL and all(torch.isfinite(t).all() for t in card),
                f"fgw variants: {label} disagrees")
        out[label] = err
    require(not any(launches.values()), f"fgw variants launched kernels: {dict(launches)}")
    return out


def phase_fgw(device, card, rows):
    """Phase 13: the per-molecule FGW path and the rest of the solver. K3's
    per-molecule wrapper at n = 11, 32 and 53; the per-molecule barycenter
    with each option (the slice's main path, its launch counts zeroed just
    before and read just after); the batched barycenter against
    per-molecule calls; the seven variants; and the deep budget through the
    runner (``config/schnet/sol1k_5.yaml``, then ``sol1k_5_bc_deep.yaml``
    warm-started: phase 5's checks, with K3 at 15 launches a stage-2
    forward) and one deep stage-2 step card against CPU."""
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model

    for n in MOL_SIZES:
        check_fgw_mol(n, device, rows)
    out = check_barycenters(device)
    out["batched"] = check_batched_barycenter(device)
    out["variants"] = check_variants(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deep_") as name, \
            runner_spies() as (plain_calls, restores, captures, host):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        runs = {}
        for stage, src in DEEP_STAGES:
            first_restore = len(restores)
            label = "deep stage 1" if stage == "conan_fgw_pre" else "deep stage 2"
            summary, history, grew = runner_stage(label, stage, config_copy(src, tmp, DEEP_EPOCHS),
                                                  ctx)
            runs[label] = dict(stage_row(history, summary, "rmse"), launches=grew)
        check_warm_start(restores, first_restore,
                         tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
    out["runner"] = runs
    config = load_config(DEEP_STAGES[1][1])
    out["parity"] = phase_parity(build_model(config, seed=SEED, device=device), device,
                                 batch=config.batch_size, label="deep parity",
                                 rtol=DEEP_STEP_RTOL)
    return out


# ---------------------------------------------------------------- phase 14
# K1/K2 at the large buckets: (label, heavy atoms a molecule, bucket), the
# ranges chosen so that the seeded molecules fill each bucket (61-95 and
# 82-128 atoms with hydrogens) and the cap binds
LARGE_SHAPES = (("N96", (46, 52), 96), ("N128", (62, 68), 128))
GEOM_STAGES = (("conan_fgw_pre", "config/schnet/cov2_5.yaml"),
               ("conan_fgw", "config/schnet/cov2_5_bc.yaml"))
GEOM_BUCKETS = (96, 128)
# the synthetic CoV-2 set: molecules a split, half of 65-96 atoms (N=96)
# and half of 97-128 (N=128); the first of each split's molecules listed in
# GEOM_NO_STORE have no store (the dg_generate fallback); each store holds
# 3-8 conformers, so K=5 resamples some stores and oversamples others
GEOM_SPLITS = {"train": 80, "valid": 12, "test": 12}
GEOM_NO_STORE = {"train": 2, "valid": 1, "test": 1}
GEOM_STORED = (3, 8)
# drug-like pieces, each bonded to the last atom of the one before: rings,
# amides, esters, sulfonamides, ethers and alkyl linkers
GEOM_FRAGMENTS = ("c1ccccc1", "c1ccncc1", "c1ccc(F)cc1", "c1ccc(Cl)cc1", "c1ccc(OC)cc1",
                  "c1ccc(C(F)(F)F)cc1", "c1ccc2ccccc2c1", "c1cncnc1", "C1CCN(CC1)",
                  "N1CCN(CC1)", "C1CCOC1", "C1CC1", "C(=O)N", "C(=O)O", "S(=O)(=O)N", "CC",
                  "CCC", "COC", "CCO", "NC", "CC(C)", "C(=O)NC")
# DimeNetGEOMExperiment's run: bench.py's dimenet_n96 batch, stage 1 only
GEOM_DIMENET = """dataset_name: ['cov2']
target: ['score']
num_conformers: 5
batch_size: 8
experiment: conan_fgw.src.experiments.DimeNetGEOMExperiment
num_epochs: 2
learning_rate: 0.001
model_name: dimenet
"""


def geom_smiles(rng, lo, hi):
    """A drug-like SMILES of ``lo``-``hi`` atoms with hydrogens: fragments
    chained until a size drawn in the range is reached."""
    from conan_fgw_tpu_torch.data import smiles as smi

    def atoms(s):
        return smi.add_hydrogens(smi.parse_smiles(s)).num_atoms

    while True:
        target, s = int(rng.integers(lo, hi + 1)), "C"
        while atoms(s) < target:
            s += GEOM_FRAGMENTS[int(rng.integers(len(GEOM_FRAGMENTS)))]
        if atoms(s) <= hi:
            return s


def geom_conformers(job):
    """``dg_generate``'s conformers for one ``(smiles, count, seed)`` (a
    worker of ``make_geom``'s process pool)."""
    from conan_fgw_tpu_torch.data import smiles as smi
    from conan_fgw_tpu_torch.data.conformers import dg_generate

    smiles, count, seed = job
    return dg_generate(smi.add_hydrogens(smi.parse_smiles(smiles)), count, seed=seed)


def make_geom(root: Path, splits=None, no_store=None, sizes=((65, 96), (97, 128)),
              buckets=GEOM_BUCKETS) -> dict:
    """The synthetic CoV-2 set in the GEOM layout under ``root/data/cov2``:
    split CSVs with an ``active`` label (both classes in every split) and a
    float ``score``, and ``.npz`` stores (``positions``, ``smiles``) under
    ``conformers_npz``, embedded by ``dg_generate`` in a pool of worker
    processes. ``splits`` molecules a split (``GEOM_SPLITS``), the first
    ``no_store`` of each without a store (``GEOM_NO_STORE``), their atom
    counts drawn in turn from the ranges of ``sizes``, each range the
    atoms of one bucket of ``buckets``. Returns the molecules' atom counts
    by split."""
    splits, no_store = splits or GEOM_SPLITS, no_store or GEOM_NO_STORE
    import csv
    import multiprocessing
    import os

    import numpy as np

    from conan_fgw_tpu_torch.data import smiles as smi
    from conan_fgw_tpu_torch.data.conformers import store_path

    rng = np.random.default_rng(SEED)
    ddir = root / "data" / "cov2"
    (ddir / "conformers_npz").mkdir(parents=True)
    jobs, atoms = [], {}
    for mode, count in splits.items():
        rows = []
        for i in range(count):
            smiles = geom_smiles(rng, *sizes[i % len(sizes)])
            rows.append({"smiles": smiles, "active": int(i % 3 == 0),
                         "score": round(float(rng.normal()), 4), "mol_id": f"{mode}{i}"})
            if i >= no_store[mode]:
                stored = int(rng.integers(GEOM_STORED[0], GEOM_STORED[1] + 1))
                jobs.append((smiles, stored, len(jobs)))
        with open(ddir / f"{mode}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["smiles", "active", "score", "mol_id"])
            w.writeheader()
            w.writerows(rows)
        atoms[mode] = [smi.add_hydrogens(smi.parse_smiles(r["smiles"])).num_atoms for r in rows]
        by_bucket = collections.Counter(next((b for b in buckets if a <= b), None)
                                        for a in atoms[mode])
        print(f"[geom data] {mode}: {count} molecules, "
              + ", ".join(f"{by_bucket[b]} at N={b}" for b in buckets)
              + f" ({min(atoms[mode])}-{max(atoms[mode])} atoms), the first {no_store[mode]}"
              f" without a store")
        require(min(atoms[mode]) >= sizes[0][0] and all(by_bucket[b] for b in buckets)
                and sum(by_bucket[b] for b in buckets) == count,
                f"geom {mode}: molecules outside the buckets {buckets}")
        require(len({r["active"] for r in rows}) == 2, f"geom {mode}: one class only")
    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        stores = pool.map(geom_conformers, jobs)
    embed_s = time.perf_counter() - t0
    for (smiles, _, _), pos in zip(jobs, stores):
        np.savez_compressed(store_path(str(ddir / "conformers_npz"), smiles), positions=pos,
                            smiles=np.str_(smiles))
    counts = collections.Counter(stored for _, stored, _ in jobs)
    n_conf = sum(stored for _, stored, _ in jobs)
    print(f"[geom data] {len(jobs)} stores holding {dict(sorted(counts.items()))} conformers"
          f" ({n_conf} in all), embedded by dg_generate in {embed_s:.1f} s on {workers}"
          f" processes ({1e3 * embed_s * workers / n_conf:.0f} ms a conformer a process)")
    return atoms


@contextlib.contextmanager
def geom_spies():
    """Peak allocated device memory by step kind and batch shape (the
    allocator's high-water mark over each step, reset before it: what the
    run holds, graph pools included, plus the step), and the host seconds
    of ``GEOMDataset.records`` calls (reading every store, re-embedding the
    molecules without one): ``(peaks, records_s)``."""
    import torch

    from conan_fgw_tpu_torch.data.geom import GEOMDataset
    from conan_fgw_tpu_torch.train.graphs import StepGraphs

    peaks, records_s = collections.Counter(), []
    run, records = StepGraphs._run, GEOMDataset.records

    def run_peak(self, kind, pb):
        torch.cuda.reset_peak_memory_stats()
        out = run(self, kind, pb)
        key = f"{kind} N{pb.max_atoms}"
        peaks[key] = max(peaks[key], torch.cuda.max_memory_allocated())
        return out

    def timed_records(self):
        t0 = time.perf_counter()
        out = records(self)
        records_s.append((len(out), time.perf_counter() - t0))
        return out

    StepGraphs._run, GEOMDataset.records = run_peak, timed_records
    try:
        yield peaks, records_s
    finally:
        StepGraphs._run, GEOMDataset.records = run, records


def geom_stage(label, stage, cfg, ctx, card, kernels, metric, buckets=GEOM_BUCKETS):
    """One runner stage on the GEOM set, in each of ``buckets``, with its
    peak memory by step kind and bucket beyond what was held before, and
    the host time of its record loading."""
    import torch

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    with geom_spies() as (peaks, records_s):
        summary, history, grew = runner_stage(label, stage, cfg, ctx, kernels=kernels,
                                              metric=metric, buckets=buckets)
    peak_gib = {k: (v - held) / 2**30 for k, v in sorted(peaks.items())}
    loads = [f"{n} in {s:.2f} s" for n, s in records_s]
    print(f"[runner {label}] peak allocated beyond what was held before, by step kind and bucket"
          f" (GiB): {', '.join(f'{k} {v:.2f}' for k, v in peak_gib.items())} on {card};"
          f" GEOMDataset.records() host time: {', '.join(loads)}")
    row = dict(stage_row(history, summary, metric, buckets), peak_gib=peak_gib,
               records_s=[s for _, s in records_s], launches=grew)
    return summary, history, row


def check_large_kernels(device, rows):
    """K1 and K2 at N=96 and N=128 (F=128 with 50 Gaussians on G=120 graphs,
    F=256 with 10 on G=90; f32 and bf16 node features) and K3 on the
    barycenter's second outer iteration there at S=90 (the CoV-2 batch of
    18 molecules x 5 conformers)."""
    import torch

    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    gen = torch.Generator().manual_seed(SEED + 14)
    for label, heavy, n_atoms in LARGE_SHAPES:
        # the F=256 case last: its molecules (S=90) serve K3 below
        for seed, batch, width in ((3000, B, (F, GAUSS)), (4000, B_CLS, (F_CLS, GAUSS_CLS))):
            pos, mask = packed_geometry(SEED + seed + n_atoms, batch, heavy, n_atoms, device)
            atoms = mask.reshape(batch, K, -1)[:, 0].sum(-1)
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            print(f"[large {label}] G={batch * K}: {int(atoms.min())}-{int(atoms.max())} atoms a"
                  f" molecule, up to {int(within.max())} neighbours within the cutoff (cap {CAP})")
            require(bool((within > CAP).any()), f"{label} inputs never engage the neighbour cap")
            for dtype in (None, torch.bfloat16):
                check_cfconv(label, pos, mask, gen, rows, *width, dtype=dtype)
        args, Ys, Cs = fgw_problem(pos, mask, gen)
        check_fgw(f"{label}-outer2", second_outer_inputs(args, Ys, Cs), rows)


def phase_geom(device, card, rows):
    """Phase 14: the GEOM path. K1/K2 (both widths and types) and K3 at N=96
    and N=128; a synthetic CoV-2 set in the GEOM layout; the runner's
    ``main`` on ``config/schnet/cov2_5.yaml`` and then ``cov2_5_bc.yaml`` (2
    epochs each; phase 6's checks, both large buckets every epoch) and
    predict; one stage-2 step at N=128 card against CPU; and
    ``DimeNetGEOMExperiment``'s stage 1 through the runner (no kernel may
    launch)."""
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model, load_datasets

    t0 = time.perf_counter()
    check_large_kernels(device, rows)
    print(f"[geom] the large-bucket kernel checks took {time.perf_counter() - t0:.1f} s")
    out, totals = {}, collections.Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_geom_") as name:
        tmp = Path(name)
        out["atoms"] = make_geom(tmp)
        common = ["--data_root", str(tmp), "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        with runner_spies() as (plain_calls, restores, captures, host):
            ctx = (common, tmp, plain_calls, captures, host, device, card)
            for stage, src in GEOM_STAGES:
                first_restore = len(restores)
                cfg = config_copy(src, tmp, RUNNER_EPOCHS)
                label = "geom stage 1" if stage == "conan_fgw_pre" else "geom stage 2"
                with last_evaluation() as test_eval:
                    summary, history, out[label] = geom_stage(label, stage, cfg, ctx, card,
                                                              CLASSIFICATION, "auroc")
                totals.update(out[label]["launches"])
                check_best_auroc(label, history, summary,
                                 tmp / "models" / "smoke" / "0" / f"run_{stage}:0")
            check_warm_start(restores, first_restore,
                             tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
            check_predict_auroc("geom stage 2", cfg, tmp, str(tmp), summary, device, test_eval)
            require(not plain_calls, f"geom: plain versions ran: {dict(plain_calls)}")

        # one stage-2 step at N=128 on 9 molecules of the train split (half
        # the config's batch: the CPU side's cost); the CPU side runs the
        # plain versions, so outside the spies
        config = load_config(cfg)
        half = config.batch_size // 2
        records = [r for r in load_datasets(config, str(tmp / "data"))["train"].records()
                   if r.num_atoms > 96][:half]
        pb = pack_batch(records, max_atoms=128, batch_size=half)
        out["parity"] = step_parity(build_model(config, seed=SEED, device=device), pb, device,
                                    f"geom parity N128 B{len(records)}")

        dimenet = tmp / "dimenet_geom.yaml"
        dimenet.write_text(GEOM_DIMENET)
        with runner_spies() as (plain_calls, restores, captures, host):
            ctx = (common, tmp, plain_calls, captures, host, device, card)
            _, _, out["dimenet stage 1"] = geom_stage("geom dimenet stage 1", "conan_fgw_pre",
                                                       str(dimenet), ctx, card, BACKBONE_KERNELS,
                                                       "rmse")
            totals.update(out["dimenet stage 1"]["launches"])
    out["launches"] = {k: totals[k] for k in REPLACES}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[geom] phase 14 took {out['phase_s']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------- phase 15
DP_WORLD = 2           # ranks sharing the one card over gloo (15b-15d)
DP_STEPS = 3           # steps of 15a and 15d: the eager warm-up, the capture, a replay
DP_TIMED = 20          # warmed graphed steps a rank times
DP_REAL = (B, 17)      # real rows of 15b's global batches: 12 + 12, then 12 + 5
# 15b: the two ranks' step against one process's at the flagship shape
DP_LOSS_RTOL, DP_NORM_RTOL, DP_PARAM_RTOL = 1e-6, 1e-5, 1e-4
DP_RMSE_RTOL = 2e-3    # the JAX package's data-parallel CLI bound (tests/test_cli.py)
DP_NOTE = ("two processes time-sharing one card show no data-parallel speed: these times are"
           " one rank's share of the card")


def dp_records(device):
    """``DP_STEPS`` global batches of the flagship shape: B molecules of N <= 32."""
    from conan_fgw_tpu_torch.data.synthetic import random_dataset

    return random_dataset(SEED + 15, DP_STEPS * B, num_conformers=K, heavy_range=(8, 10),
                          device=device)


def dp_graphed(model, settings, mesh, records, kept=False):
    """``DP_STEPS`` graphed train steps of ``model`` over ``records`` through
    the host pipeline (with ``mesh``: each rank's row block and the split
    step), then ``DP_TIMED`` more for this process's ms/step. Returns the
    per-step loss bits and gradient and weight digests, the ms/step, and the
    ``StepGraphs``."""
    import struct

    import torch

    from conan_fgw_tpu_torch.train.loop import make_optimizer, step_batches, step_graphs

    dev = next(model.parameters()).device
    opt = make_optimizer(model, settings)
    with kept_graphs() if kept else contextlib.nullcontext():
        graphs = (step_graphs(model, opt, settings, dev) if mesh is None
                  else step_graphs(model, opt, settings, dev, mesh))
        steps = []
        with step_batches(records, settings, 32, graphs, mesh=mesh) as batches:
            for pb in batches:
                loss, _ = graphs.train(pb)
                steps.append({"loss": struct.pack("<f", float(loss)).hex(),
                              "grads": _digest(*(g.cpu().numpy() for g in graphs.grads
                                                 if g is not None)),
                              "weights": _digest(*(p.detach().cpu().numpy()
                                                   for p in model.parameters()))})
    require(len(steps) == DP_STEPS, f"{len(steps)} data-parallel steps, want {DP_STEPS}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED // DP_STEPS + 1):
        with step_batches(records, settings, 32, graphs, mesh=mesh) as batches:
            for pb in batches:
                graphs.train(pb)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / ((DP_TIMED // DP_STEPS + 1) * DP_STEPS)
    return steps, ms, graphs


def dp_world1(mesh):
    """15a, in a one-rank NCCL group: ``DP_STEPS`` graphed steps of the split
    step (two graphs and the all-reduce) against the single graph, from the
    same seeded model on the same batches; their losses, gradients and
    weights must be bit-identical."""
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.train.loop import TrainSettings

    require(mesh.world == 1, f"15a: {mesh}")
    records = dp_records(mesh.device.type)
    settings = TrainSettings(batch_size=B, use_barycenter=True, seed=SEED)
    runs = {}
    for label, m in (("single graph", None), ("split", mesh)):
        steps, ms, graphs = dp_graphed(ConanModel(seed=SEED, device=mesh.device), settings, m,
                                       records)
        split = [st.after is not None for k, st in graphs.steps.items() if k[0] == "train"]
        require(not graphs.graphed or split == [m is not None],
                f"15a {label}: train graphs split {split}")
        runs[label] = dict(steps=steps, ms=ms)
    return runs


def _flat_grads(split, model) -> dict:
    """The summed gradients in a ``SplitStep``'s buffer, by parameter name."""
    named = [(k, p) for k, p in model.named_parameters() if p.grad is not None]
    flat = split.flat.cpu()
    require(sum(p.numel() for _, p in named) + 2 == flat.numel(), "the all-reduce buffer's size")
    out, at = {}, 0
    for k, p in named:
        out[k] = flat[at: at + p.numel()].reshape(p.shape).numpy().copy()
        at += p.numel()
    return out


def dp_ranks(mesh, parity: bool):
    """15b and 15d on one rank of the gloo mesh on the card: with
    ``parity``, one eager split step from the seeded model on each of
    ``DP_REAL``'s global batches (the summed loss and gradients); then
    ``dp_graphed`` (its graphs kept, their K1/K2/K3 nodes read)."""
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.parallel.mesh import shard_batch
    from conan_fgw_tpu_torch.train.loop import SplitStep, TrainSettings, make_optimizer

    records = dp_records(mesh.device.type)
    settings = TrainSettings(batch_size=B, use_barycenter=True, seed=SEED)
    out = {"parity": {}}
    for n_real in DP_REAL if parity else ():
        model = ConanModel(seed=SEED, device=mesh.device)
        split = SplitStep(model, make_optimizer(model, settings), settings, mesh)
        pb = shard_batch(pack_batch(records[:n_real], max_atoms=32, batch_size=B), mesh)
        split.before(pb.to(mesh.device), torch.tensor(float(n_real), device=mesh.device))
        split.reduce()
        out["parity"][n_real] = dict(loss=float(split.flat[-2]), grads=_flat_grads(split, model),
                                     real=int(pb.mol_mask.sum()))
    before = collections.Counter(launches)
    steps, ms, graphs = dp_graphed(ConanModel(seed=SEED, device=mesh.device), settings, mesh,
                                   records, kept=True)
    (step,) = [st for k, st in graphs.steps.items() if k[0] == "train"]
    nodes = [graph_kernels(g) for g in (step.graph, step.after)]
    captured = {name: sum(step.counts.delta.get(k, 0) for k in names)
                for name, names in PROFILED.items()}
    require({k: nodes[0][k] + nodes[1][k] for k in PROFILED} == captured,
            f"rank {mesh.rank}: the split train graphs hold {nodes}, the capture counted"
            f" {captured}")
    out.update(steps=steps, ms=ms, nodes=nodes, rows=B // mesh.world,
               launches={k: launches[k] - before[k] for k in REGRESSION})
    return out


def dp_runner_rank(mesh, argv, pre_dir):
    """15c on one rank: the runner's ``run_main`` on the gloo mesh of the
    card (rank 0 alone writes) inside ``runner_spies``; ``fit``'s replicas
    checked equal when it returns. Returns the summary, the launches, the
    host pipeline's counts, the files written, a digest of the trained
    weights and the history; with ``pre_dir``, the warm start is held to
    stage 1's ``best`` bit for bit."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.parallel import collectives
    from conan_fgw_tpu_torch.train import checkpoints, loop, runner

    fit, write_npz, trained, written = loop.fit, checkpoints._write_npz, {}, []

    def fit_checked(*args, **kwargs):
        res = fit(*args, **kwargs)
        collectives.check_replicas(res.model, kwargs["mesh"])
        trained["digest"] = _digest(*(t.cpu().numpy() for t in res.model.state_dict().values()))
        trained["history"] = res.history
        return res

    def write_counted(path, arrays):
        written.append(path)
        return write_npz(path, arrays)

    loop.fit, checkpoints._write_npz = fit_checked, write_counted
    with runner_spies() as (plain_calls, restores, captures, host):
        reset_launches()
        t0 = time.perf_counter()
        summary = runner.run_main(runner.parse_args(argv), mesh, writes=mesh.rank == 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if pre_dir is not None:
            check_warm_start(restores, 0, Path(pre_dir))
    return dict(summary=summary, launches={k: launches[k] for k in REPLACES}, host=dict(host),
                captures=dict(captures), plain=dict(plain_calls), written=written, wall=wall,
                **trained)


def check_dp_runner(label, stage, ranks, cfg, single, device, card):
    """15c's gates on the two ranks of one runner stage."""
    from conan_fgw_tpu_torch.train import runner
    from conan_fgw_tpu_torch.train.config import load_config

    r0, r1 = ranks
    require(r0["summary"] == r1["summary"], f"dp {label}: the ranks' summaries differ")
    require(r0["digest"] == r1["digest"], f"dp {label}: the ranks' trained weights differ")
    require(r0["written"] and not r1["written"],
            f"dp {label}: rank 0 wrote {len(r0['written'])} files, rank 1 {len(r1['written'])}")
    outer = runner.fgw_config(load_config(cfg)).outer_iters if stage == "conan_fgw" else 0
    for rank, r in enumerate(ranks):
        host, grew = r["host"], r["launches"]
        steps = sum(row["train_steps"] for row in r["history"])
        forwards = host["train_forwards"] + host["eval_forwards"]
        require(not r["plain"], f"dp {label} rank {rank}: plain versions ran: {r['plain']}")
        if device == "cuda":
            require(r["captures"].get("train") and r["captures"].get("eval"),
                    f"dp {label} rank {rank}: CUDA graphs captured {r['captures']}")
            require(host["staged_copy"] > 0 and not host.get("numpy_pack")
                    and not host.get("pageable_copy"),
                    f"dp {label} rank {rank}: host pipeline {host}")
        require(host["train_forwards"] == steps and host["eval_forwards"] > 0,
                f"dp {label} rank {rank}: {host} forwards in {steps} steps")
        want = {"cfconv_fwd": 3 * forwards, "cfconv_bwd": 3 * steps,
                "fgw_couplings": outer * forwards}
        require({k: grew[k] for k in want} == want and not any(
            grew[k] for k in REPLACES if k not in want),
            f"dp {label} rank {rank}: launches {grew}, want {want}")
        for row in r["history"]:
            require(all(row.get(f"steps_n{n}", 0) > 0 for n in (32, 64)),
                    f"dp {label} rank {rank} epoch {row['epoch']} missed a bucket: {row}")
            by_bucket = ", ".join(f"{row[f'steps_n{n}']} at N={n}"
                                  f" ({1e3 * row[f'train_s_n{n}'] / row[f'steps_n{n}']:.2f}"
                                  " ms/step)" for n in (32, 64))
            print(f"[dp {label}] rank {rank} epoch {row['epoch']}: {row['epoch_time_s']:.3f} s,"
                  f" {row['train_steps']} steps ({by_bucket}), train_loss"
                  f" {row['train_loss']:.5g}, val_mse {row['val_mse']:.5g}")
        print(f"[dp {label}] rank {rank}: {r['wall']:.1f} s wall; launches {want}"
              f" = 3 x {forwards} forwards, 3 x {steps} steps, {outer} x {forwards}; host"
              f" pipeline {host}")
    rmse = r0["summary"]["test_rmse"]["mean"]
    rel = abs(rmse - single) / abs(single)
    print(f"[dp {label}] test_rmse {rmse!r} on both ranks, one process's (phase 5) {single!r}:"
          f" rel {rel:.3e} (tol {DP_RMSE_RTOL}); trained weights bit-identical across the ranks;"
          f" rank 0 wrote {len(r0['written'])} checkpoint files, rank 1 none; on {card}")
    require(rel <= DP_RMSE_RTOL, f"dp {label}: test_rmse off one process's by {rel:.3e}")
    last = r0["history"][-1]
    return dict(test_rmse=rmse, rel=rel, wall_s=[r["wall"] for r in ranks],
                ms_n32=[1e3 * r["history"][-1]["train_s_n32"] / r["history"][-1]["steps_n32"]
                        for r in ranks],
                ms_n64=[1e3 * r["history"][-1]["train_s_n64"] / r["history"][-1]["steps_n64"]
                        for r in ranks],
                steps=last["train_steps"], launches=r0["launches"])


def check_dp_parity(ranks, device):
    """15b: each ``DP_REAL`` global batch's two-rank step against the
    single-process step on the card, from the same seeded weights."""
    import numpy as np

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.train.loop import masked_mse

    records = dp_records(device)
    out = {}
    for n_real in DP_REAL:
        require(ranks[0]["parity"][n_real]["loss"] == ranks[1]["parity"][n_real]["loss"],
                f"dp parity {n_real}: the ranks' summed losses differ")
        model = ConanModel(seed=SEED, device=device)
        batch = pack_batch(records[:n_real], max_atoms=32, batch_size=B).to(device)
        pred, _ = model(batch, use_barycenter=True)
        loss = masked_mse(pred, batch)
        loss.backward()
        single = {k: p.grad.cpu().numpy() for k, p in model.named_parameters()
                  if p.grad is not None}
        got = ranks[0]["parity"][n_real]
        require(set(got["grads"]) == set(single), f"dp parity {n_real}: gradients of other weights")
        gs = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in single.values())))
        gd = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in got["grads"].values())))
        rel = {k: float(np.linalg.norm(got["grads"][k] - g))
               / max(float(np.linalg.norm(g)), PARAM_FLOOR * gs) for k, g in single.items()}
        loss_rel = abs(got["loss"] - float(loss.detach())) / abs(float(loss.detach()))
        worst = max(rel, key=rel.get)
        print(f"[dp parity] {n_real} real rows ({[r['parity'][n_real]['real'] for r in ranks]}"
              f" a rank): loss two ranks {got['loss']:.8g} one process {float(loss):.8g} (rel"
              f" {loss_rel:.3e}, tol {DP_LOSS_RTOL}); gradient norm {gd:.8g} / {gs:.8g} (rel"
              f" {abs(gd - gs) / gs:.3e}, tol {DP_NORM_RTOL}); worst parameter {worst}"
              f" {rel[worst]:.3e} (tol {DP_PARAM_RTOL})")
        require(loss_rel <= DP_LOSS_RTOL, f"dp parity {n_real}: the loss is off by {loss_rel}")
        require(abs(gd - gs) / gs <= DP_NORM_RTOL, f"dp parity {n_real}: the gradient norm")
        require(rel[worst] <= DP_PARAM_RTOL, f"dp parity {n_real}: {worst}'s gradient")
        out[n_real] = dict(loss_rel=loss_rel, grad_norm_rel=abs(gd - gs) / gs,
                           worst_param_rel=rel[worst])
    return out


def phase_dp(device, card, rows, single):
    """Phase 15: data-parallel training (``parallel/``, ``SplitStep``, the
    split train graphs). 15a: a one-rank NCCL group, the split step
    bit-identical to the single graph. 15b: two ranks sharing the card over
    gloo, one global step against one process (12 + 12 real rows, then 12
    + 5), K1/K2/K3 at the rank's shape, the split graphs' nodes against the
    capture's counts. 15c: the runner's two stages on ``data/sol250`` on
    the two-rank mesh. 15d: 15b's graphed steps again in fresh processes,
    bit for bit, launched beside 15c (from a thread: its ranks share the
    card with 15c's). ``single`` holds phase 5's test RMSE by stage."""
    import concurrent.futures

    import torch

    from conan_fgw_tpu_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    out = {}
    # every rank on the one card; the CPU (a rehearsal) has gloo only
    dev, world1_backend = ("cuda:0", "nccl") if device == "cuda" else (device, "gloo")
    # 15a
    (w1,) = launch(dp_world1, 1, backend=world1_backend, device=dev)
    a, b = w1["single graph"], w1["split"]
    same = a["steps"] == b["steps"]
    print(f"[dp world 1] {DP_STEPS} graphed steps, split around a one-rank {world1_backend}"
          f" all-reduce, against the single graph: losses, gradients and weights bit-identical"
          f" {same};"
          f" ms/step single graph {a['ms']:.3f}, split {b['ms']:.3f} on {card}")
    require(same, f"15a: the split step differs from the single graph: {a['steps']} {b['steps']}")
    out["world1"] = dict(single_ms=a["ms"], split_ms=b["ms"])

    # 15b and the first run of 15d
    pos, mask = packed_geometry(SEED + 15, B // DP_WORLD, (8, 10), 32, device)
    gen = torch.Generator().manual_seed(SEED + 15)
    check_cfconv("dp-N32", pos, mask, gen, rows)
    check_fgw("dp-N32", fgw_problem(pos, mask, gen)[0], rows)
    first = launch(dp_ranks, DP_WORLD, True, backend="gloo", device=dev)
    out["parity"] = check_dp_parity(first, device)
    for rank, r in enumerate(first):
        print(f"[dp graphs] rank {rank}: {r['rows']} rows a rank; K1/K2/K3 nodes of the split"
              f" train graphs {r['nodes'][0]} and {r['nodes'][1]}, as the capture counted;"
              f" launches over {DP_STEPS} + {DP_TIMED // DP_STEPS * DP_STEPS + DP_STEPS} steps"
              f" {r['launches']}; graphed {r['ms']:.3f} ms/step on {card}")
    print(f"[dp graphs] {DP_NOTE}")
    out["graphed_ms"] = [r["ms"] for r in first]

    # 15d's fresh processes, beside 15c
    pool = concurrent.futures.ThreadPoolExecutor(1)
    again_run = pool.submit(launch, dp_ranks, DP_WORLD, False, backend="gloo", device=dev)
    # 15c
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as name:
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", dev]
        pre_dir = tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0"
        for stage, src in RUNNER_STAGES:
            cfg = config_copy(src, tmp, RUNNER_EPOCHS)
            label = "stage 1" if stage == "conan_fgw_pre" else "stage 2"
            ranks = launch(dp_runner_rank, DP_WORLD, ["--config", cfg, "--stage", stage, *common],
                           None if stage == "conan_fgw_pre" else str(pre_dir),
                           backend="gloo", device=dev)
            out[label] = check_dp_runner(f"runner {label}", stage, ranks, cfg, single[label],
                                         device, card)
        log = (tmp / "logs" / "smoke" / "0" / "run_conan_fgw" / "log.txt").read_text()
        require("rank 0 of 2" in log and "rank 1 of 2" not in log, "dp: rank 1 wrote the log")
    print(f"[dp runner] {DP_NOTE}; the warm start bit-exact on both ranks")

    # 15d: the same steps in fresh processes
    again = again_run.result()
    pool.shutdown()
    runs = [r["steps"] for r in (*first, *again)]
    same = all(s == runs[0] for s in runs)
    print(f"[dp determinism] {DP_STEPS} graphed two-rank steps in two launches of fresh processes:"
          f" losses, gradients and weights bit-identical across runs and ranks {same}")
    require(same, f"15d: the two-rank steps differ: {runs}")
    out["launches"] = {k: out["stage 1"]["launches"][k] + out["stage 2"]["launches"][k]
                       for k in REPLACES}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[dp] phase 15 took {out['phase_s']:.1f} s; rank 0's runner launches {out['launches']}")
    return out


# ---------------------------------------------------------------- phase 16
TOOLS_STAGES = (("conan_fgw_pre", "config/schnet/sol250_3.yaml"),
                ("conan_fgw", "config/schnet/sol250_3_bc.yaml"))
K3 = 3               # the K=3 configs' conformers
SOL250 = Path("data/sol250")
SOL250_MOLECULES, SOL250_SPLITS = 322, {"train": 257, "valid": 33, "test": 32}
# K1/K2 and K3 at the K=3 paths' shapes: (label, molecules, heavy atoms, bucket);
# 24 molecules are sol250_3_bc's batch (G = S = 72), 32 sol250_3's and
# synthetic_e2e's (G = S = 96)
TOOLS_SHAPES = (("K3-N32-G72", 24, (8, 13), 32), ("K3-N32-G96", 32, (8, 13), 32),
                ("K3-N64-G72", 24, (20, 26), 64), ("K3-N64-G96", 32, (20, 26), 64))
TOOLS_E2E = ("--epochs", "2", "--size", "64")
TOOLS_EVAL_N = 960   # 10 batches of 96
TOOLS_EVAL_BATCH = 96  # eval_geom_scale's batch: K1 on G = 480 graphs
TOOLS_CPU_N, TOOLS_CPU_BATCH = 96, 24  # 16f's CPU reference: the first 96, in batches of 24


def check_k3_kernels(device, rows):
    """16b: K1/K2 at ``eval_geom_scale``'s G = 480 (N=32), on G = 72 and 96
    graphs and K3 on S = 72 and 96 solves, at N=32 and at N=64 with the cap
    active, against their plain versions."""
    import torch

    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    gen = torch.Generator().manual_seed(SEED + 16)
    pos, mask = packed_geometry(SEED + 1696, TOOLS_EVAL_BATCH, (8, 13), 32, device)
    check_cfconv("eval-N32-G480", pos, mask, gen, rows)
    for label, n_mols, heavy, n_atoms in TOOLS_SHAPES:
        pos, mask = packed_geometry(SEED + 1600 + n_mols + n_atoms, n_mols, heavy, n_atoms,
                                    device, k=K3)
        if n_atoms == 64:
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            require(bool((within > CAP).any()), f"{label} inputs never engage the neighbour cap")
        check_cfconv(label, pos, mask, gen, rows)
        check_fgw(label.replace("-G", "-S"), fgw_problem(pos, mask, gen, k=K3)[0], rows)


def start_prepare_sol250(root: Path):
    """16a's ``tools.prepare_data --builtin sol250`` into ``root``, started
    in a process of its own on half the host's CPUs (each molecule's store
    is seeded: the worker count does not change a byte);
    ``finish_prepare_sol250`` waits for it. ``main`` starts it before phase
    15, and it runs beside phases 15 and 7: their checks are bits and
    tolerances, not times."""
    import os

    workers = max(1, (os.cpu_count() or 2) // 2)
    proc = subprocess.Popen(
        [sys.executable, "-m", "conan_fgw_tpu_torch.tools.prepare_data", "--builtin", "sol250",
         "--store_conformers", "10", "--data_root", str(root), "--workers", str(workers)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter(), workers


def finish_prepare_sol250(root: Path, started) -> float:
    """16a: wait for ``start_prepare_sol250``'s run; its CSVs and stores
    must be the repo's ``data/sol250`` byte for byte. Returns the seconds
    from its start to its end."""
    proc, t0, workers = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"prepare_data failed:\n{stdout[-2000:]}{stderr[-4000:]}")
    out = root / "data" / "sol250"
    for name in ("train.csv", "valid.csv", "test.csv"):
        require((out / name).read_bytes() == (SOL250 / name).read_bytes(),
                f"prepare_data: {name} differs from data/sol250's")
    stores, differ = 0, []
    for mode in SOL250_SPLITS:
        made = sorted(p.name for p in (out / f"conformers_{mode}").iterdir())
        committed = sorted(p.name for p in (SOL250 / f"conformers_{mode}").iterdir())
        require(made == committed, f"prepare_data: conformers_{mode} holds other stores")
        stores += len(made)
        differ += [f"{mode}/{n}" for n in made if (out / f"conformers_{mode}" / n).read_bytes()
                   != (SOL250 / f"conformers_{mode}" / n).read_bytes()]
    manifest = json.loads((out / "manifest.json").read_text())
    print(f"[tools prepare] prepare_data --builtin sol250 on {workers} processes: {seconds:.1f} s;"
          f" {manifest['n_molecules']} molecules, splits {manifest['splits']}; train/valid/test.csv"
          f" and {stores - len(differ)} of {stores} stores byte-identical to data/sol250")
    require(not differ, f"prepare_data: {len(differ)} stores differ from data/sol250's, e.g."
            f" {differ[:3]}")
    require(manifest["n_molecules"] == SOL250_MOLECULES and manifest["splits"] == SOL250_SPLITS,
            f"prepare_data: manifest {manifest}")
    return seconds


def prepare_sol250(root: Path) -> float:
    """16a in line: ``start_prepare_sol250`` and ``finish_prepare_sol250``."""
    return finish_prepare_sol250(root, start_prepare_sol250(root))


def check_summaries(summaries: dict, directory: Path) -> None:
    """16d: ``tools.summarize_protocol`` over 16c's ``--out_json`` files: a
    row each, with their ``test_rmse`` means."""
    from conan_fgw_tpu_torch.tools import summarize_protocol

    with contextlib.redirect_stdout(io.StringIO()) as text:
        summarize_protocol.main([str(directory)])
    lines = text.getvalue().splitlines()
    print("[tools summarize] " + "\n[tools summarize] ".join(lines))
    require(len(lines) == 1 + len(summaries), f"summarize_protocol printed {lines}")
    for line, (name, summary) in zip(lines[1:], sorted(summaries.items())):
        r = summary["test_rmse"]
        require(line.split()[:2] == [name, f"{r['mean']:.4f}"],
                f"summarize_protocol's row {line!r} is not {name}'s mean {r['mean']!r}")


def synthetic_e2e_stages(tmp, spies, device):
    """16e: ``tools.synthetic_e2e`` on the card, its two stages' launch
    counts zeroed before and read after each; exact counts, as 16c's."""
    import numpy as np

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.tools import synthetic_e2e

    plain_calls, _, captures, host = spies
    stages, original = [], synthetic_e2e.run_experiment

    def counted(config, **kw):
        reset_launches()
        captures.clear()
        host.clear()
        out = original(config, **kw)
        stages.append((kw["stage"], {k: launches[k] for k in REPLACES}, dict(host),
                       dict(captures)))
        return out

    synthetic_e2e.run_experiment = counted
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = synthetic_e2e.main([*TOOLS_E2E, "--models_dir", str(tmp / "synthetic"),
                                     "--device", device])
        wall = time.perf_counter() - t0
    finally:
        synthetic_e2e.run_experiment = original
    require(not plain_calls, f"synthetic_e2e: plain versions ran: {dict(plain_calls)}")
    totals = collections.Counter()
    for (stage, grew, counts, graphs), key in zip(stages, ("stage1", "stage2")):
        summary, runs = result[key]
        forwards = counts.get("train_forwards", 0) + counts.get("eval_forwards", 0)
        want = {"cfconv_fwd": 3 * forwards, "cfconv_bwd": 3 * counts.get("train_forwards", 0),
                "fgw_couplings": 5 * forwards if stage == "conan_fgw" else 0}
        got = {k: grew[k] for k in REGRESSION}
        history = runs[0]["history"]
        print(f"[tools synthetic_e2e] {stage}: {len(history)} epochs,"
              f" {sum(r['train_steps'] for r in history)} steps, train_loss"
              f" {[round(r['train_loss'], 5) for r in history]}, test_rmse"
              f" {summary['test_rmse']['mean']:.6f}; {forwards} forwards, launches {got};"
              f" CUDA graphs captured {graphs}")
        require(got == want and not any(grew[k] for k in REPLACES if k not in REGRESSION),
                f"synthetic_e2e {stage}: launches {grew}, want {want}")
        require(device != "cuda" or (graphs.get("train") and graphs.get("eval")),
                f"synthetic_e2e {stage}: CUDA graphs captured {graphs}")
        require(all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in history)
                and np.isfinite(summary["test_rmse"]["mean"]),
                f"synthetic_e2e {stage}: a loss or test_rmse is not finite")
        totals.update(got)
    print(f"[tools synthetic_e2e] stage-1 test RMSE {result['stage1'][0]['test_rmse']['mean']:.4f},"
          f" stage-2 {result['stage2'][0]['test_rmse']['mean']:.4f}, target std"
          f" {result['target_std']:.4f}; {wall:.1f} s wall on the card")
    return dict(wall_s=wall, launches=dict(totals),
                test_rmse=[result[k][0]["test_rmse"]["mean"] for k in ("stage1", "stage2")])


def eval_at_scale(device, card, plain_calls):
    """16f: ``tools.eval_geom_scale`` at ``TOOLS_EVAL_N`` molecules on the
    card (K1 three a forward, nothing else), then its first 96 molecules'
    predictions against the same model's ``evaluate`` on the CPU (the plain
    versions)."""
    import numpy as np

    from conan_fgw_tpu_torch.data.loader import bucket_order
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.tools import eval_geom_scale
    from conan_fgw_tpu_torch.train import loop as loop_lib

    forwards, original = [], loop_lib.eval_step

    def counted(*args, **kwargs):
        forwards.append(1)
        return original(*args, **kwargs)

    loop_lib.eval_step = counted
    reset_launches()
    try:
        summary, pred = eval_geom_scale.run(TOOLS_EVAL_N, device=device)
    finally:
        loop_lib.eval_step = original
    grew = {k: launches[k] for k in REPLACES}
    print(f"[tools eval_geom_scale] {json.dumps(summary)} on {card}; {len(forwards)} forwards,"
          f" launches {grew}")
    require(summary["n_molecules"] == TOOLS_EVAL_N and pred.shape == (TOOLS_EVAL_N,),
            f"eval_geom_scale: {summary['n_molecules']} molecules, {pred.shape} predictions")
    require(grew["cfconv_fwd"] == 3 * len(forwards) and not any(
        v for k, v in grew.items() if k != "cfconv_fwd"), f"eval_geom_scale: launches {grew}")
    require(not plain_calls, f"eval_geom_scale: plain versions ran: {dict(plain_calls)}")

    # the first molecules of the same seed (a molecule's bucket is its own
    # atom count's, and its prediction does not depend on its batch)
    cpu = eval_geom_scale.records(TOOLS_CPU_N, "cpu")
    max_atoms = loop_lib.dataset_max_atoms(cpu)
    settings = loop_lib.TrainSettings(use_barycenter=False, batch_size=TOOLS_CPU_BATCH)
    t0 = time.perf_counter()
    _, cpu_pred, _ = loop_lib.evaluate(ConanModel(device="cpu"), cpu, settings, max_atoms, "cpu")
    order = bucket_order(cpu, buckets=loop_lib.bucket_boundaries(max_atoms))
    want = np.empty_like(cpu_pred)
    want[np.asarray(order)] = cpu_pred
    rel = float(np.abs(pred[:TOOLS_CPU_N] - want).max() / np.abs(want).max())
    print(f"[tools eval_geom_scale] the first {TOOLS_CPU_N} predictions against the CPU's"
          f" evaluate (plain versions, batches of {TOOLS_CPU_BATCH}, {time.perf_counter() - t0:.1f}"
          f" s): {rel:.3e} of the largest (tol {STEP_RTOL}); eval epoch"
          f" {summary['eval_epoch_s']:.3f} s, {summary['molecules_per_s']:.1f} molecules/s")
    require(rel <= STEP_RTOL, f"eval_geom_scale: the card's predictions are {rel} off the CPU's")
    return dict(summary, cpu_rel=rel, launches=grew)


def phase_tools(device, card, rows, prepared=None):
    """Phase 16: the tools (``conan_fgw_tpu_torch/tools``) and the K=3
    runner path. 16a ``prepare_data --builtin sol250`` byte for byte (or
    ``prepared``, ``(its data root, its seconds)`` where ``main`` ran it
    beside phases 15 and 7); 16b K1/K2/K3 at the K=3 shapes; 16c ``sol250_3.yaml``
    then ``sol250_3_bc.yaml`` through the runner on 16a's data with phase
    5's checks and ``--out_json``; 16d ``summarize_protocol`` over them; 16e
    ``synthetic_e2e``; 16f ``eval_geom_scale`` against the CPU."""
    t0 = time.perf_counter()
    out, totals = {}, collections.Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as name:
        tmp = Path(name)
        if prepared is None:
            out["prepare_s"] = prepare_sol250(tmp)
        else:
            data_root, out["prepare_s"] = prepared
            (tmp / "data").symlink_to(Path(data_root).resolve() / "data")
        check_k3_kernels(device, rows)
        common = ["--data_root", str(tmp), "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        summaries = {}
        with runner_spies() as spies:
            plain_calls, restores, captures, host = spies
            ctx = (common, tmp, plain_calls, captures, host, device, card)
            for stage, src in TOOLS_STAGES:
                first_restore = len(restores)
                cfg = config_copy(src, tmp, RUNNER_EPOCHS)
                label = f"K3 {'stage 1' if stage == 'conan_fgw_pre' else 'stage 2'}"
                out_json = tmp / "protocol" / f"{Path(src).stem}.json"
                summary, history, grew = runner_stage(label, stage, cfg, ctx,
                                                      "--out_json", str(out_json))
                require(json.loads(out_json.read_text()) == summary,
                        f"runner {label}: --out_json differs from the summary")
                summaries[Path(src).stem] = summary
                totals.update(grew)
                out[label] = stage_row(history, summary, "rmse")
            check_warm_start(restores, first_restore,
                             tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
            check_summaries(summaries, tmp / "protocol")
            out["synthetic_e2e"] = synthetic_e2e_stages(tmp, spies, device)
            totals.update(out["synthetic_e2e"]["launches"])
            plain_calls.clear()
            out["eval_geom_scale"] = eval_at_scale(device, card, plain_calls)
            totals.update(out["eval_geom_scale"]["launches"])
    out["launches"] = {k: totals[k] for k in REPLACES}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[tools] phase 16 took {out['phase_s']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------- phase 17
# K3 on the flat path at sizes that are no bucket: the demo's 256 x 10 solves
# at N=22, and n = 11 and 53 (padded to 32 and 64); (label, solves, n)
ANYN_CASES = (("N22-S2560", 2560, 22), ("n11-S120", 120, 11), ("n53-S120", 120, 53))
DEMO = Path("examples/fgw_parity_demo_torch.py")
DEMO_ATOL = 1e-3  # the barycenter's 1e-3 (BARY_ATOL), or 1.5x the CPU f32 distance from f64
# the f16 step's gate against float64 (tests/test_torch_dtypes.py): no
# farther than F16_FARTHER times the CPU's f16 route (JAX's XLA cfconv in f16)
F16_FARTHER = 1.5
F16_PARITY_B = 8  # the f16 step held against the CPU (three CPU steps at full width)
F16_TIMED = 20  # graphed steps a timing turn
NEAR_N, NEAR_B = 64, 8  # the nearest cap's SchNet step: N=64 (the cap binds), batch 8
NEAR_TIE = 1e-5  # A: a neighbour set may differ only where two distances lie this close
REMAT_STEPS = 3  # graphed steps: the eager warm-up, the capture, a replay
LARGE_B = 256  # bench.py's large_batch rows: B=256, K=5, N=32
ACC_K = 4  # accumulate_steps of 17f
ACC_B = 32  # its batch (sol250_3's): 9 mini-steps an epoch, so one is pending at its end
ACC_CPU_RTOL = 1e-3  # 17f's weights on the card against the CPU, of the largest weight
ACC_EAGER_RTOL = 1e-5  # graphed against eager (phase 8's GRAPH_RTOL)


def anyn_problem(S, n, seed, device):
    """``S`` seeded FGW coupling problems of ``n`` atoms: ``(Ms, C1, C2, ps,
    qs, T0)``, random features' squared distances, 0/1 structures, uniform
    marginals and the product plan."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    Y0, Ys = torch.rand(S, n, 4, generator=gen), torch.rand(S, n, 4, generator=gen) + 0.1
    Ms = ((Y0[:, :, None, :] - Ys[:, None, :, :]) ** 2).sum(-1)
    C1 = (torch.rand(S, n, n, generator=gen) > 0.6).to(torch.float32)
    C2 = (torch.rand(S, n, n, generator=gen) > 0.6).to(torch.float32)
    ps = torch.full((S, n), 1.0 / n)
    T0 = ps[:, :, None] * ps[:, None, :]
    return tuple(t.to(device).contiguous() for t in (Ms, C1, C2, ps, ps.clone(), T0))


def check_flat(tag, args, rows, label):
    """``fgw_couplings_flat`` on ``args`` of ``n`` atoms (padded to the next
    multiple of 32, the true n passed to K3) against the plain unpadded
    solve on the card: plans within ``FGW_ATOL``, flags equal, one launch
    (under ``launch_name``'s name for the padded N); eager and graph-replay ms and
    the bound of the n x n work, under ``rows[...][label]``."""
    import torch
    import torch.nn.functional as Fn

    from conan_fgw_tpu_torch.ops.cuda import fgw as k3
    from conan_fgw_tpu_torch.ops.cuda import launches

    S, n, _ = args[0].shape
    N = n + (-n % 32)
    name = k3.launch_name("fgw_couplings", N)
    before = collections.Counter(launches)
    T_k, (div_k, _) = k3.fgw_couplings_flat(*args, **FGW_KW)
    grew = {k: v - before[k] for k, v in launches.items() if v != before[k]}
    T_p, (div_p, _) = k3.fgw_couplings_plain(*args, **FGW_KW)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    pad = lambda x: Fn.pad(x, (0, N - n) if x.dim() == 2 else (0, N - n, 0, N - n)).contiguous()  # noqa: E731
    _, (_, iters) = k3._couplings(*map(pad, args), n=n, count="uncounted", **FGW_KW)
    sk_run = int(iters.sum())
    print(f"[fgw {tag}] K3 on {N} rows (n={n}) against the plain unpadded solve: T"
          f" max_abs_err {err:.3e} (tol {FGW_ATOL}); diverged kernel {int(div_k.sum())} plain"
          f" {int(div_p.sum())}; launches {grew}; {sk_run} Sinkhorn iterations run")
    require(tuple(T_k.shape) == (S, n, n), f"fgw {tag}: T {tuple(T_k.shape)}")
    require(grew == {name: 1}, f"fgw {tag}: launches {grew}")
    require(err <= FGW_ATOL, f"fgw {tag} plans disagree: {err}")
    require(bool(torch.equal(div_k, div_p)), f"fgw {tag} diverged flags disagree")
    ms = cuda_ms(lambda: k3.fgw_couplings_flat(*args, **FGW_KW))
    replay_ms = graph_ms(lambda: k3.fgw_couplings_flat(*args, **FGW_KW))
    plain_ms = cuda_ms(lambda: k3.fgw_couplings_plain(*args, **FGW_KW), reps=3, warmup=1)
    tc, f32 = fgw_bound(S, n, sk_run)
    print(f"[fgw {tag}] S={S}: {ms:.4f} ms (eager calls, padding included; graph"
          f" replays {replay_ms:.4f} ms), plain {plain_ms:.4f} ms; bound {tc[0]:.5f} ms"
          f" ({tc[1]}, {100 * tc[0] / ms:.2f}% reached, {100 * tc[0] / replay_ms:.2f}% of the"
          f" replays), {f32[0]:.5f} ms in f32 on the CUDA cores")
    rows[name][label] = dict(max_abs_err=err, ms=ms, graph_ms=replay_ms, plain_ms=plain_ms,
                             bound=tc, bound_f32=f32, sinkhorn_iters=sk_run)


def check_fgw_anyn(device, rows):
    """17a: ``fgw_couplings_flat`` at ``ANYN_CASES`` (padded to the next
    multiple of 32, the true n passed to K3) against the plain unpadded
    solve on the card: plans within ``FGW_ATOL``, flags equal, one launch a
    call; eager and graph-replay ms, the bound of the n x n work. Then a
    bucket size (N=32) must reach K3 unpadded, as the runner's buckets do."""
    from conan_fgw_tpu_torch.ops.cuda import fgw as k3

    for label, S, n in ANYN_CASES:
        check_flat(f"anyn {label}", anyn_problem(S, n, SEED + 1700 + n, device), rows, label)
    # a bucket size takes the unpadded launch (n unset), as on the runner's path
    seen, launch = [], k3._couplings
    k3._couplings = lambda *a, **kw: seen.append((tuple(a[0].shape), kw.get("n"))) or launch(*a, **kw)
    try:
        k3.fgw_couplings_flat(*anyn_problem(120, 32, SEED + 1732, device), **FGW_KW)
    finally:
        k3._couplings = launch
    print(f"[fgw anyn N32] a bucket size reaches K3 as {seen} (shape, n): unpadded")
    require(seen == [((120, 32, 32), None)], f"fgw anyn N32: K3 saw {seen}")


def run_demo(device, card):
    """17b: ``examples/fgw_parity_demo_torch.py``'s ``main`` on the card (its
    random-graph branch): the single solve (K3's per-molecule wrapper, ten
    timed after a warm-up) and the batch of 256 (one flat K3 launch an outer
    iteration). Y of both, against a float64 solve on the CPU of the same
    graphs, within the larger of ``DEMO_ATOL`` and 1.5 times the CPU f32
    solve's own distance from it (the barycenter amplifies f32 rounding)."""
    import importlib.util

    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter

    spec = importlib.util.spec_from_file_location("fgw_parity_demo_torch", DEMO)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    missing = str(Path(tempfile.gettempdir()) / "chip_smoke_no_fixture.pt")
    before = collections.Counter(launches)
    out = demo.main(["--fixture", missing, "--device", device])
    grew = {k: v - before[k] for k, v in launches.items() if v != before[k]}
    outer = FGWConfig().outer_iters
    want = {"fgw_couplings_mol": 11 * outer, "fgw_couplings": 2 * outer}
    require(grew == want, f"demo: launches {grew}, want {want}")
    Ys, Cs, ps, lam, _ = demo.load_problem(missing)
    N = Ys.shape[1]
    refs = {}
    for dt in (torch.float32, torch.float64):
        args = [torch.from_numpy(a).to(dt) for a in (Ys, Cs, ps)]
        refs[dt] = fgw_barycenter(*args, torch.full((N,), 1.0 / N, dtype=dt),
                                  torch.from_numpy(lam).to(dt), FGWConfig())[0]
    y64 = refs[torch.float64]
    cpu_err = float((refs[torch.float32].double() - y64).abs().max())
    gate = max(DEMO_ATOL, 1.5 * cpu_err)
    single = float((out["Y"].double() - y64).abs().max())
    batch = float((out["Y_batch"].double() - y64[None]).abs().max())
    print(f"[demo] single solve {out['single_ms']:.4f} ms, {out['batch']} at once"
          f" {out['batch_ms']:.4f} ms ({out['batch_ms'] / out['batch']:.5f} ms/molecule) on {card};"
          f" launches {grew}; Y against a float64 CPU solve: single {single:.3e}, batch {batch:.3e}"
          f" (tol {gate:.3e}: the CPU f32 solve lies {cpu_err:.3e} from it)")
    require(single <= gate and batch <= gate, f"demo: Y {single}, {batch} off (tol {gate})")
    return dict(single_ms=out["single_ms"], batch_ms=out["batch_ms"], batch=out["batch"],
                single_err=single, batch_err=batch, cpu_err=cpu_err, launches=grew)


def _step_vector(model, batch, bary=True):
    """One train step's loss and its gradient as one float64 vector (zeros
    for a parameter without a gradient), on the model's device."""
    import numpy as np

    from conan_fgw_tpu_torch.train.loop import masked_mse

    model.zero_grad(set_to_none=True)
    pred, _ = model(batch, use_barycenter=bary)
    loss = masked_mse(pred, batch)
    loss.backward()
    grads = [np.zeros(p.shape) if p.grad is None else p.grad.detach().cpu().double().numpy()
             for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), np.concatenate([g.ravel() for g in grads])


def _f32_reference(model, dtype):
    """A CPU copy of the f16 ``model`` computing in ``dtype`` (float64, or
    float32 where ``dtype`` is None would keep f16): its blocks' compute
    type cleared, its parameters cast."""
    m = copy.deepcopy(model).to("cpu")
    for blk in m.backbone.blocks:
        blk.compute_dtype = None
    return m.to(dtype)


def check_f16_step(device, card):
    """17c's model part: the f16 flagship's stage-2 step graphed on the card
    (the replay of the third step, at batch ``F16_PARITY_B``) against the
    same step of a CPU copy in the f16 variants' arithmetic
    (``kernel_arithmetic``: the f32 products widened from f16 and rounded
    back) within phase 4's ``STEP_RTOL``, loss and gradient; and against a
    float64 step, no farther than ``F16_FARTHER`` times the CPU's f16 step
    by the plain version's f16 route (the filter MLP in f16, as JAX's XLA
    cfconv) lies from it. The graphed steps leave out the clip
    (``grad_clip`` 1e30), whose scaling would hide the gradient's norm.
    Then the f16 and f32 graphed ms at the flagship shape (B=24) in turns,
    and one eager stage-2 step of the f16 classification model (F=256) for
    its variants."""
    import dataclasses

    import numpy as np
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.train import loop

    def graphed(dtype, pb, settings):
        model = ConanModel(seed=SEED, device=device, compute_dtype=dtype)
        graphs = loop.step_graphs(model, loop.make_optimizer(model, settings), settings, device)
        for _ in range(REMAT_STEPS - 1):  # the eager warm-up, the capture and its replay
            graphs.train(pb)
        return model, graphs

    before = collections.Counter(launches)
    recs = random_dataset(SEED + 3, F16_PARITY_B, num_conformers=K, heavy_range=(8, 10),
                          device=device)
    pb = pack_batch(recs, max_atoms=32, batch_size=F16_PARITY_B)
    settings = loop.TrainSettings(batch_size=F16_PARITY_B, use_barycenter=True, grad_clip=1e30)
    model, graphs = graphed("float16", pb, settings)
    snapshot = copy.deepcopy(model)
    loss_k, _ = graphs.train(pb)  # a replay
    torch.cuda.synchronize()
    on_card = (float(loss_k), np.concatenate([
        (np.zeros(p.shape) if g is None else g.detach().cpu().double().numpy()).ravel()
        for p, g in zip(model.parameters(), graphs.grads)]))
    cpu_batch = pb.to("cpu")
    t0 = time.perf_counter()
    with kernel_arithmetic():
        arith = _step_vector(copy.deepcopy(snapshot).to("cpu"), cpu_batch)
    route = _step_vector(copy.deepcopy(snapshot).to("cpu"), cpu_batch)
    ref = _step_vector(_f32_reference(snapshot, torch.float64),
                       dataclasses.replace(cpu_batch, pos=cpu_batch.pos.double()))
    cpu_s = time.perf_counter() - t0

    def d(a, b):
        return abs(a[0] - b[0]) / abs(b[0]), float(np.linalg.norm(a[1] - b[1]) / np.linalg.norm(b[1]))

    out = dict(card_arith=d(on_card, arith), card_f64=d(on_card, ref), route_f64=d(route, ref),
               card_route=d(on_card, route), cpu_s=cpu_s)
    print(f"[f16 parity B{F16_PARITY_B}] graphed replay (loss, gradient) against the CPU step in"
          f" the f16 variants' arithmetic {out['card_arith'][0]:.3e}, {out['card_arith'][1]:.3e}"
          f" (tol {STEP_RTOL}); against float64 {out['card_f64'][0]:.3e}, {out['card_f64'][1]:.3e},"
          f" where the CPU's f16 route (JAX's XLA cfconv in f16) lies {out['route_f64'][0]:.3e},"
          f" {out['route_f64'][1]:.3e} (tol {F16_FARTHER}x); card against that route"
          f" {out['card_route'][0]:.3e}, {out['card_route'][1]:.3e}; the CPU steps took"
          f" {cpu_s:.1f} s")
    require(max(out["card_arith"]) <= STEP_RTOL, f"f16 parity: {out['card_arith']} from the CPU")
    require(all(c <= F16_FARTHER * r for c, r in zip(out["card_f64"], out["route_f64"])),
            f"f16 parity: {out['card_f64']} from float64, the CPU's f16 route {out['route_f64']}")
    del model, graphs, snapshot

    recs = random_dataset(SEED + 3, B, num_conformers=K, heavy_range=(8, 10), device=device)
    pb = pack_batch(recs, max_atoms=32, batch_size=B)
    settings = loop.TrainSettings(batch_size=B, use_barycenter=True)
    graphs = {dtype: graphed(dtype, pb, settings)[1] for dtype in ("float32", "float16")}
    turns = {"float32": [], "float16": []}
    for dtype in ("float32", "float16", "float16", "float32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(F16_TIMED):
            graphs[dtype].train(pb)
        torch.cuda.synchronize()
        turns[dtype].append(1e3 * (time.perf_counter() - t0) / F16_TIMED)
    grew = _grew_only("f16 flagship", before, REGRESSION + REGRESSION_F16)
    require(all(grew.get(k, 0) > 0 for k in REGRESSION_F16), f"f16 flagship: launches {grew}")
    out["graphed_ms"] = {k: min(v) for k, v in turns.items()}
    print(f"[f16 graphs stage 2 N32] graphed {out['graphed_ms']['float16']:.3f} ms/step in f16,"
          f" {out['graphed_ms']['float32']:.3f} in f32 (best of two turns of {F16_TIMED}) on {card}")
    del graphs

    cls = ConanModel(seed=SEED, device=device, task="classification", hidden_channels=512,
                     num_filters=256, num_gaussians=GAUSS_CLS, compute_dtype="float16")
    recs = random_dataset(SEED + 18, B_CLS, num_conformers=K, heavy_range=(8, 13), device=device)
    cls_batch = pack_batch(recs, max_atoms=32, batch_size=B_CLS).to(device)
    cls_settings = loop.TrainSettings(task="classification", batch_size=B_CLS, use_barycenter=True)
    before = collections.Counter(launches)
    loss, _ = loop.train_step(cls, loop.make_optimizer(cls, cls_settings), cls_batch, cls_settings)
    out["class_launches"] = _grew_only("f16 classification", before, CLASSIFICATION_F16)
    require(bool(loss.isfinite()) and all(out["class_launches"].get(k, 0) > 0
                                          for k in CLASSIFICATION_F16),
            f"f16 classification: loss {float(loss)}, launches {out['class_launches']}")
    print(f"[f16 classification] one eager stage-2 step: loss {float(loss):.6f}, launches"
          f" {out['class_launches']}")
    out["launches"] = {**grew, **out["class_launches"]}
    return out


def kernel_neighbours(pos, maskf, cap_mode):
    """The neighbour set K1 computes, read from K1 itself: with the filter W
    fixed at 1 (zero weights, a bias of 1) and x the one-hot atom index,
    ``out[g, i, j]`` is the gate of edge (i, j), non-zero exactly where j is
    a neighbour of i. F=128 channels hold N <= 128 atoms."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.cfconv import cfconv_forward

    G, N, _ = pos.shape
    dev = pos.device
    x = torch.zeros(G, N, F, device=dev)
    x[:, torch.arange(N), torch.arange(N)] = 1.0
    w1, b1 = torch.zeros(GAUSS, F, device=dev), torch.zeros(F, device=dev)
    w2, b2 = torch.zeros(F, F, device=dev), torch.ones(F, device=dev)
    out = cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP, cap_mode)
    return out[..., :N] > 0


def check_nearest(device, card, rows):
    """17d: K1/K2 with the nearest cap against the plain version at N=64
    (phase 2's inputs there, the cap binding); the kernels' neighbour sets
    against the plain version's, where a row may differ only by a near tie
    (two distances within ``NEAR_TIE``, which the card's distance arithmetic
    may order otherwise); a stage-2 step of the nearest-cap SchNet model at
    N=64 card against CPU (phase 4's gates) and eager against graphed
    (phase 8's gate)."""
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
    from conan_fgw_tpu_torch.train import loop

    gen = torch.Generator().manual_seed(SEED + 1764)
    label, heavy, n_atoms = FGW_SHAPES[1]
    pos, mask = packed_geometry(SEED + n_atoms, B, heavy, n_atoms, device)
    within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
    require(bool((within > CAP).any()), "nearest: the N=64 inputs never engage the cap")
    check_cfconv(f"{label}-nearest", pos, mask, gen, rows, cap_mode="nearest")

    got = kernel_neighbours(pos, mask.to(torch.float32).contiguous(), "nearest").cpu()
    want = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, CAP, "nearest").cpu()
    dist = pairwise_distances(pos.cpu().double())  # to tell a near tie
    bad = (got != want).any(-1)
    for g, i in bad.nonzero().tolist():
        # the farthest neighbour the plain version keeps: the cap's edge, or
        # the cutoff's where the cap does not bind
        edge = float(dist[g, i][want[g, i]].max())
        moved = dist[g, i][got[g, i] != want[g, i]]
        tie = ((moved - edge).abs() <= NEAR_TIE) | ((moved - CUTOFF).abs() <= NEAR_TIE)
        require(bool(tie.all()), f"nearest: graph {g} row {i} keeps other neighbours than the plain"
                f" version, at {moved.tolist()} against its edge {edge}")
    ties = int(bad.sum())
    print(f"[nearest N64] K1's neighbour sets against the plain version's: {ties} of"
          f" {int(mask.sum())} rows differ, all by near ties (within {NEAR_TIE} A); the cap binds"
          f" in {int((within > CAP).sum())} rows")

    recs = random_dataset(SEED + 64, NEAR_B, num_conformers=K, heavy_range=heavy, device=device)
    pb = pack_batch(recs, max_atoms=NEAR_N, batch_size=NEAR_B)
    model = ConanModel(seed=SEED, device=device, neighbor_cap_mode="nearest")
    out = {"parity": step_parity(model, pb, device, "nearest parity")}
    settings = loop.TrainSettings(batch_size=NEAR_B, use_barycenter=True)
    losses, weights = {}, {}
    for mode in ("eager", "graphed"):
        m = copy.deepcopy(model)
        opt = loop.make_optimizer(m, settings)
        graphs = loop.step_graphs(m, opt, settings, device)
        losses[mode] = torch.stack([
            loop.train_step(m, opt, pb.to(device), settings)[0] if mode == "eager"
            else graphs.train(pb)[0] for _ in range(REMAT_STEPS)])
        weights[mode] = list(m.parameters())
    loss_rel = _max_rel(losses["graphed"], losses["eager"])
    w_rel = max(_max_rel(q.detach(), p.detach()) for p, q in zip(weights["eager"],
                                                                   weights["graphed"]))
    print(f"[nearest graphs N64 B{NEAR_B}] {REMAT_STEPS} graphed steps against eager: losses"
          f" {loss_rel:.3e}, weights {w_rel:.3e} (tol {GRAPH_RTOL})")
    require(loss_rel <= GRAPH_RTOL and w_rel <= GRAPH_RTOL, "nearest: graphed against eager")
    out.update(ties=ties, graphs_loss_rel=loss_rel, graphs_weight_rel=w_rel)
    return out


def check_remat(device, card):
    """17e: the flagship stage-2 step with ``remat`` through CUDA graphs:
    the replay's gradients, loss and weights bit for bit those of
    ``remat=False``; the train graph's K1 nodes twice those without (K1
    recomputes each block in the backward); then the peak memory of eager
    steps with and without remat at B=24 and at B=256 (``bench.py``'s
    ``large_batch`` shape, K=5, N=32, f32)."""
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.train import loop

    recs = random_dataset(SEED + 3, B, num_conformers=K, heavy_range=(8, 10), device=device)
    pb = pack_batch(recs, max_atoms=32, batch_size=B)
    settings = loop.TrainSettings(batch_size=B, use_barycenter=True)
    runs = {}
    with kept_graphs():
        for remat in (False, True):
            model = ConanModel(seed=SEED, device=device, remat=remat)
            graphs = loop.step_graphs(model, loop.make_optimizer(model, settings), settings, device)
            losses = [graphs.train(pb)[0] for _ in range(REMAT_STEPS)]
            torch.cuda.synchronize()
            nodes = graph_kernels(graphs.steps[("train", pb.z.shape)].graph)
            runs[remat] = (model, graphs, torch.stack(losses), nodes)
    (m0, g0, l0, n0), (m1, g1, l1, n1) = runs[False], runs[True]
    same_grads = all((a is None and b is None) or torch.equal(a, b)
                     for a, b in zip(g0.grads, g1.grads))
    same = same_grads and torch.equal(l0, l1) and all(
        torch.equal(p, q) for p, q in zip(m0.parameters(), m1.parameters()))
    print(f"[remat] {REMAT_STEPS} graphed stage-2 steps: gradients, losses and weights bit-identical"
          f" to remat=False {same}; train graph nodes {n1} against {n0}")
    require(same, "remat: the graphed steps differ from remat=False")
    require(n1["cfconv_fwd_kernel"] == 2 * n0["cfconv_fwd_kernel"] == 6
            and n1["cfconv_bwd_kernel"] == n0["cfconv_bwd_kernel"] == 3,
            f"remat: K1/K2 nodes {n1} against {n0}")
    del runs, m0, m1, g0, g1
    out = {"nodes": {"remat": n1, "no_remat": n0}, "memory": {}}
    for b in (B, LARGE_B):
        recs = random_dataset(SEED + b, b, num_conformers=K, heavy_range=(8, 10), device=device)
        batch = pack_batch(recs, max_atoms=32, batch_size=b).to(device)
        settings = loop.TrainSettings(batch_size=b, use_barycenter=True)
        for remat in (False, True):
            out["memory"][f"B{b} remat {remat}"] = eager_peak(
                f"remat memory B{b} remat={remat}", ConanModel(seed=SEED, device=device, remat=remat),
                batch, settings, card)
        del batch
        ratio = (out["memory"][f"B{b} remat True"]["peak_gib"]
                 / out["memory"][f"B{b} remat False"]["peak_gib"])
        print(f"[remat memory B{b}] peak with remat / without: {ratio:.3f} on {card}")
    torch.cuda.empty_cache()
    return out


class _EagerAccumulating:
    """``fit``'s steps without graphs, each batch moved with ``to`` and
    stepped eagerly, with the accumulation's mini-steps: the reference of
    the graphed accumulation."""

    def __init__(self, model, optimizer, settings, device, accumulation=None):
        from conan_fgw_tpu_torch.train import loop

        def train(pb):
            update = accumulation.begin()
            out = loop.train_step(model, optimizer, pb.to(device), settings, accumulation, update)
            accumulation.end()
            return out

        self.train = train
        self.eval = lambda pb: loop.eval_step(model, pb.to(device), settings)

    def stage(self, records, batch_size, buckets):
        return None


def check_accumulate(device, card):
    """17f: ``fit`` with ``accumulate_steps=4`` through CUDA graphs, one
    epoch of sol250's stage 1 (``ACC_B``): two train graphs a shape ("train",
    "train_update"); the weights within ``ACC_EAGER_RTOL`` of the same fit
    stepped eagerly on the card and within ``ACC_CPU_RTOL`` of it on the
    CPU (each the largest difference over the largest weight); Adam's count
    in ``last_state`` equal to the updates; a second epoch resumed from that
    ``last_state`` (in the middle of an accumulation) bit for bit the
    straight two-epoch run; ms per mini-step."""
    import numpy as np
    import torch

    from conan_fgw_tpu_torch.data.datasets import ConformerDataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer

    train = ConformerDataset("train", "data", "sol250", "logS_surrogate", K).records()
    val = ConformerDataset("valid", "data", "sol250", "logS_surrogate", K).records()
    max_atoms = loop.dataset_max_atoms(train + val)

    def run(epochs, dev, directory=None, resume=False):
        settings = loop.TrainSettings(batch_size=ACC_B, num_epochs=epochs, accumulate_steps=ACC_K,
                                      max_atoms=max_atoms, seed=SEED)
        ckpt = RunCheckpointer(str(directory)) if directory else None
        return loop.fit(settings, train, val, model=ConanModel(seed=SEED, device=dev), device=dev,
                        checkpointer=ckpt, resume=resume)

    def rel(a, b):
        diff = max(float((p.detach().cpu() - q.detach().cpu()).abs().max())
                   for p, q in zip(a.parameters(), b.parameters()))
        return diff / max(float(q.detach().abs().max()) for q in b.parameters())

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_acc_") as name:
        tmp = Path(name)
        graphed = run(1, device, tmp / "a")
        kinds = sorted({k[0] for k in graphed.graphs.steps if k[0] != "eval"})
        captured = sorted(f"{k[0]} N{k[1][2]}" for k, st in graphed.graphs.steps.items()
                          if k[0] != "eval" and st.graph is not None)
        require(kinds == ["train", "train_update"] and captured,
                f"accumulate: train kinds {kinds}, graphs captured {captured}")
        steps = graphed.history[0]["train_steps"]
        with np.load(tmp / "a" / "last_state.npz") as data:
            adam = {float(data[k]) for k in data.files if k.startswith("adam/") and k.endswith("/step")}
            m = int(data["accumulate/mini_step"])
        require(adam == {float(steps // ACC_K)} and m == steps % ACC_K and m > 0,
                f"accumulate: Adam's steps {adam}, mini-step {m} after {steps} mini-steps")
        original = loop.step_graphs
        loop.step_graphs = _EagerAccumulating
        try:
            eager = run(1, device)
        finally:
            loop.step_graphs = original
        t0 = time.perf_counter()
        cpu = run(1, "cpu")
        cpu_s = time.perf_counter() - t0
        straight = run(2, device, tmp / "b")
        resumed = run(2, device, tmp / "a", resume=True)
        out.update(eager_rel=rel(graphed.model, eager.model), cpu_rel=rel(graphed.model, cpu.model),
                   steps=steps, updates=steps // ACC_K, cpu_s=cpu_s,
                   step_ms=1e3 * straight.history[1]["train_s"] / straight.history[1]["train_steps"])
        same = all(torch.equal(p, q) for p, q in zip(straight.model.parameters(),
                                                     resumed.model.parameters()))
        print(f"[accumulate k={ACC_K}] one sol250 stage-1 epoch of {steps} mini-steps, {steps // ACC_K}"
              f" updates (Adam's count), {m} mini-steps pending: weights against eager"
              f" {out['eager_rel']:.3e} (tol {ACC_EAGER_RTOL}), against the CPU {out['cpu_rel']:.3e}"
              f" (tol {ACC_CPU_RTOL}; the CPU fit took {cpu_s:.1f} s); the resumed second epoch bit"
              f" for bit the straight run's {same}; graphed {out['step_ms']:.3f} ms per mini-step"
              f" (second epoch) on {card}; train graphs captured in the first epoch {captured}")
        require(out["eager_rel"] <= ACC_EAGER_RTOL, "accumulate: graphed against eager")
        require(out["cpu_rel"] <= ACC_CPU_RTOL, "accumulate: card against the CPU")
        require(same, "accumulate: the resumed run differs from the straight one")
    return out


def phase_last(device, card, rows):
    """Phase 17: the last of the JAX package in the port. 17a K3's flat
    path at any atom count; 17b the FGW demo; 17c float16 (K1/K2's f16
    variants, the f16 flagship step graphed against the CPU, f16 against
    f32 graphed ms); 17d the nearest-neighbour cap; 17e ``remat``; 17f
    ``accumulate_steps``."""
    import torch

    t0 = time.perf_counter()
    out = {}
    check_fgw_anyn(device, rows)
    out["demo"] = run_demo(device, card)
    gen = torch.Generator().manual_seed(SEED + 1716)
    for label, heavy, n_atoms in FGW_SHAPES[:2]:
        pos, mask = packed_geometry(SEED + n_atoms, B, heavy, n_atoms, device)
        check_cfconv(label, pos, mask, gen, rows, dtype=torch.float16)
        pos, mask = packed_geometry(SEED + 1000 + n_atoms, B_CLS, heavy, n_atoms, device)
        check_cfconv(label, pos, mask, gen, rows, F_CLS, GAUSS_CLS, dtype=torch.float16)
    out["f16"] = check_f16_step(device, card)
    out["nearest"] = check_nearest(device, card, rows)
    out["remat"] = check_remat(device, card)
    out["accumulate"] = check_accumulate(device, card)
    out["launches"] = {k: out["f16"]["launches"].get(k, 0) for k in REPLACES}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[last] phase 17 took {out['phase_s']:.1f} s; the f16 paths' launches"
          f" {out['f16']['launches']}")
    return out


# ---------------------------------------------------------------- phase 18
# K1/K2 and K3 above 128 atoms: (label, heavy atoms a molecule, N), the
# ranges chosen so that the seeded molecules fill each N (109-154, 137-165
# and 190-241 atoms with hydrogens at sol1k_class's batch; 126-160 at
# N=181, no multiple of 32) and the cap binds
BIG_SHAPES = (("N160", (80, 88), 160), ("N192", (96, 104), 192), ("N256", (136, 148), 256),
              ("N181", (90, 98), 181))
BIG_MOL = 150  # K3' (the per-molecule wrapper, padded to 160) and its barycenter
# above the cluster route's 256 atoms, K3's stream route: N = 288 (F=256
# molecules, S = 90), first and second outer iteration; N = 320, 384 and
# 448 (S = 90 seeded point clouds that fill each N, first outer
# iteration); n = 270 through the flat path (padded to 288); K3' and both
# barycenters at n = 270
STREAM_SHAPE = ("N288", (150, 166), 288)
STREAM_CLOUDS = ((320, (292, 320)), (384, (356, 384)), (448, (420, 448)), (512, (481, 512)))
STREAM_MOL = 270
STREAM_BATCH = 2  # molecules of the batched barycenter at n = STREAM_MOL
# above the stream route's 512 atoms, K3's global route: S = 15 point
# clouds at N = 544 and at N = 800 (no multiple of 64); K3' and both
# barycenters at n = 520 (padded to 544)
GLOBAL_N, GLOBAL_S = 544, 15
GLOBAL_BIG = 800
GLOBAL_MOL = 520
GLOBAL_BATCH = 1
# K1/K2 above 256 atoms: G = 10 point clouds (2 molecules x 5 conformers;
# at G = 90 the plain version's (G, N, N, F) filter alone would be 13.6 GB
# at N = 544, F = 128) that fill each N
CFCONV_CLOUDS = (320, 544)
CFCONV_CLOUD_MOLS = 2
# timed calls of the plain cfconv at these shapes (0.1-1 s each), after
# as many warm-up calls (3 after 2 before PR 20)
BIG_PLAIN_REPS = 1
BIG_TIMED = 5  # timed replays of each of 18f's graphed steps


def cloud_geometry(seed, n_mols, atoms, N, device, k=K):
    """Seeded stand-ins for molecules of ``atoms = (lo, hi)`` atoms, ``k``
    conformers each, packed to ``N``: a Gaussian cloud of 0.9 n^(1/3) A per
    molecule (about a molecule's density; the neighbour cap binds) and
    0.3 A of noise per conformer. ``(pos (B*k, N, 3), mask (B*k, N))``, as
    ``packed_geometry`` without its molecule builder, whose cost grows with
    the atoms."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sizes = torch.randint(atoms[0], atoms[1] + 1, (n_mols,), generator=gen).tolist()
    pos = torch.zeros(n_mols, k, N, 3)
    mask = torch.zeros(n_mols, k, N, dtype=torch.bool)
    for b, n in enumerate(sizes):
        base = torch.randn(n, 3, generator=gen) * (0.9 * n ** (1 / 3))
        pos[b, :, :n] = base + 0.3 * torch.randn(k, n, 3, generator=gen)
        mask[b, :, :n] = True
    return pos.reshape(-1, N, 3).to(device), mask.reshape(-1, N).to(device)


def check_big_kernels(device, rows):
    """18a/18b: K1 and K2 at N=160, 192, 256 and 181 (csrc/cfconv_wgmma.cu),
    F=128 with 50 Gaussians and F=256 with 10, on G=90 graphs (the CoV-2
    batch of 18 molecules x 5 conformers), f32 with the index cap; at N=192
    also the nearest cap and bf16 and f16 node features; phase 2's and
    12's gates; last, at N=320 and 544 on G=10 point clouds
    (``CFCONV_CLOUDS``). K3's cluster route on the F=256 molecules (S=90): the first
    and second outer iteration at N=160, 192 and 256, and N=181 through
    ``fgw_couplings_flat`` (padded to 192); two launches bit for bit equal
    at N=192. K3's stream route: the first and second outer iteration at
    N=288 (F=256 molecules, S=90), two launches bit for bit equal there and
    the global route's time on the same input; the first at N=320, 384 and
    448 and 512 (point clouds, S=90), at 512 also a later outer
    iteration's input (``later_inputs``, the ``FGW_REL`` gate too) with the
    global route's time on it beside; n=270 through
    ``fgw_couplings_flat``. The global route at N=544 and N=800 (S=15),
    first and later outer iteration (the later with the ``FGW_REL`` gate;
    at N=544 two launches bit for bit and a NaN planted in one T0), its
    plan for every N and S it runs. K3' at n=150
    (cluster), 270 (stream) and 520 (global). Returns each route's shape by
    N (CTAs, band rows, shared bytes a CTA, clusters the card holds; the
    stream route's plan and rounds at S=90; the global route's plans) and
    the global route's time at N=288 and 512."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import _build
    from conan_fgw_tpu_torch.ops.cuda import fgw as k3
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    lib = _build.load_library()
    shapes = {"cluster": {}, "stream": {}}
    for N in range(k3.LARGEST_TEMPLATE + 32, k3.LARGEST_CLUSTER + 1, 32):
        way = k3.route(N)
        shape = shapes["cluster"][N] = dict(ctas=way.ctas, rows=way.rows,
                                            smem=lib.fgw_cluster_smem(N, way.rows),
                                            active=lib.fgw_cluster_active(N, way.rows))
        print(f"[big K3 N{N}] cluster route: {way.ctas} CTAs of {way.rows} rows a solve,"
              f" {shape['smem']} shared bytes a CTA, {shape['active']} clusters at once")
        require(shape["active"] > 0, f"K3's cluster route places no cluster at N={N}")
    for N, R in k3.STREAM_ROWS.items():
        plan, active = lib.fgw_stream_plan(N, R), lib.fgw_stream_active(N, R)
        shape = shapes["stream"][N] = dict(
            ctas=N // R, rows=R, sub=plan // 10000, ks=plan // 100 % 100, stages=plan % 100,
            smem=lib.fgw_stream_smem(N, R), active=active,
            rounds_s90=-(-90 // active) if active > 0 else None)
        print(f"[big K3 N{N}] stream route: {N // R} CTAs of {R} rows a solve, sub-bands of"
              f" {shape['sub']} rows, k-slices of {shape['ks']} in {shape['stages']} stages,"
              f" {shape['smem']} shared bytes a CTA, {active} clusters at once,"
              f" {shape['rounds_s90']} rounds at S=90")
        require(active > 0, f"K3's stream route places no cluster at N={N}")

    gen = torch.Generator().manual_seed(SEED + 18)
    for label, heavy, n_atoms in BIG_SHAPES:
        for seed, width in ((5000, (F, GAUSS)), (6000, (F_CLS, GAUSS_CLS))):
            pos, mask = packed_geometry(SEED + seed + n_atoms, B_CLS, heavy, n_atoms, device)
            atoms = mask.reshape(B_CLS, K, -1)[:, 0].sum(-1)
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            print(f"[big {label}] G={B_CLS * K}: {int(atoms.min())}-{int(atoms.max())} atoms a"
                  f" molecule, up to {int(within.max())} neighbours within the cutoff (cap {CAP})")
            require(bool((within > CAP).any()), f"{label} inputs never engage the neighbour cap")
            check_cfconv(label, pos, mask, gen, rows, *width, plain_reps=BIG_PLAIN_REPS)
            if n_atoms == 192:
                check_cfconv(f"{label}-nearest", pos, mask, gen, rows, *width, cap_mode="nearest",
                             plain_reps=BIG_PLAIN_REPS)
                for dtype in (torch.bfloat16, torch.float16):
                    check_cfconv(label, pos, mask, gen, rows, *width, dtype=dtype,
                                 plain_reps=BIG_PLAIN_REPS)
        args, Ys, Cs = fgw_problem(pos, mask, gen)
        if n_atoms % 32:
            check_flat(f"big {label}", args, rows, label)
        else:
            check_fgw(label, args, rows)
            check_fgw(f"{label}-outer2", second_outer_inputs(args, Ys, Cs), rows)
        if n_atoms == 192:
            check_fgw_bits(label, args)
    label, heavy, n_atoms = STREAM_SHAPE
    pos, mask = packed_geometry(SEED + 6000 + n_atoms, B_CLS, heavy, n_atoms, device)
    args, Ys, Cs = fgw_problem(pos, mask, gen)
    check_fgw(label, args, rows)
    check_fgw(f"{label}-outer2", second_outer_inputs(args, Ys, Cs), rows)
    check_fgw_bits(label, args)
    shapes["global_N288"] = check_global_beside(label, args, rows)
    n = STREAM_MOL
    cut = tuple((x[:, :n, :n] if x.dim() == 3 else x[:, :n]).contiguous() for x in args)
    check_flat(f"big N{n}", cut, rows, f"N{n}")
    for N, atoms in STREAM_CLOUDS:
        pos, mask = cloud_geometry(SEED + 6100 + N, B_CLS, atoms, N, device)
        args, Ys, _ = fgw_problem(pos, mask, gen)
        check_fgw(f"N{N}", args, rows)
        if N == k3.LARGEST_STREAM:  # the global route beside the stream route's largest N
            later = later_inputs(args, Ys, gen)
            check_fgw(f"N{N}-later", later, rows, rel=True)
            shapes["global_N512"] = check_global_beside(f"N{N}-later", later, rows, rel=True)
    shapes["global"] = {f"N{N}-S{S}": team_plan_row(S, N) for N, S in (
        (STREAM_SHAPE[2], B_CLS * K), (k3.LARGEST_STREAM, B_CLS * K), (GLOBAL_N, GLOBAL_S),
        (GLOBAL_N, K), (GLOBAL_BIG, GLOBAL_S))}
    for N in (GLOBAL_N, GLOBAL_BIG):
        pos, mask = cloud_geometry(SEED + 6100 + N, GLOBAL_S // K, (N - 31, N), N, device)
        args, Ys, _ = fgw_problem(pos, mask, gen)
        check_fgw(f"N{N}", args, rows)
        later = later_inputs(args, Ys, gen)
        check_fgw(f"N{N}-later", later, rows, rel=True)
        if N == GLOBAL_N:
            check_fgw_bits(f"N{N}-later", later)
            check_fgw_nan(later, f"N{N}-later-nan", rel=True)
    for n in (BIG_MOL, STREAM_MOL, GLOBAL_MOL):
        check_fgw_mol(n, device, rows)
    for N in CFCONV_CLOUDS:
        pos, mask = cloud_geometry(SEED + 6200 + N, CFCONV_CLOUD_MOLS, (N - 31, N), N, device)
        within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
        print(f"[big N{N}] G={pos.shape[0]} point clouds: up to {int(within.max())} neighbours"
              f" within the cutoff (cap {CAP})")
        require(bool((within > CAP).any()), f"N{N} inputs never engage the neighbour cap")
        for width in ((F, GAUSS), (F_CLS, GAUSS_CLS)):
            check_cfconv(f"N{N}", pos, mask, gen, rows, *width, plain_reps=BIG_PLAIN_REPS)
    return shapes


def team_plan_row(S, N):
    """The global route's plan of ``S`` solves at ``N`` on this card, as the
    library has it (``fgw_team_plan``; the wrapper holds it to
    ``ops/cuda/fgw.py::team_plan``), printed."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import fgw as k3

    plan = k3._team_ready(N, S, torch.cuda.current_device())
    row = dict(rows=plan.rows, ctas=plan.ctas, teams=plan.teams, rounds=plan.rounds,
               passes=plan.passes, per_pass=plan.per_pass, smem=plan.smem,
               scratch_mb=4 * plan.scratch_floats / 2**20)
    print(f"[big K3 N{N} S{S}] global route: bands of {plan.rows} rows, {plan.ctas} CTAs a team,"
          f" {plan.teams} teams at once, {plan.rounds} rounds, {plan.passes} passes of"
          f" {plan.per_pass} column tiles, {plan.smem} shared bytes a CTA, scratch"
          f" {row['scratch_mb']:.1f} MB")
    return row


def check_global_beside(label, args, rows, rel=False):
    """The global route on the stream route's input (its library entry
    called directly, uncounted, with the scratch of the wrapper's plan):
    plans within ``fgw_limit``'s gate of the plain version, flags equal,
    and its ms beside the stream route's, from the same run."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import _build
    from conan_fgw_tpu_torch.ops.cuda import fgw as k3

    lib = _build.load_library()
    S, N, _ = args[0].shape
    solver = tuple(FGW_KW[k] for k in ("alpha", "epsilon", "pgd_iters", "pgd_tol", "sinkhorn_iters",
                                       "sinkhorn_thr"))
    floats = k3._team_ready(N, S, torch.cuda.current_device()).scratch_floats

    def launch():
        T = torch.empty_like(args[0])
        flags = torch.empty((2, S), dtype=torch.int32, device=T.device)
        scratch = torch.empty(floats, device=T.device)
        code = lib.fgw_couplings_large(*(a.data_ptr() for a in args), T.data_ptr(),
                                       flags[0].data_ptr(), flags[1].data_ptr(), scratch.data_ptr(),
                                       S, N, N, *solver, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "fgw_couplings_large")
        return T, flags[0]

    T_g, div_g = launch()
    T_p, (div_p, _) = k3.fgw_couplings_plain(*args, **FGW_KW)
    torch.cuda.synchronize()
    err = float((T_g - T_p).abs().max())
    limit, _ = fgw_limit(T_p, args[5], rel)
    ms, replay_ms = cuda_ms(launch), graph_ms(launch)
    mine = rows[k3.launch_name("fgw_couplings", N)][label]
    print(f"[fgw {label}] the global route on the same input: {ms:.4f} ms (eager calls; graph"
          f" replays {replay_ms:.4f} ms) against the stream route's {mine['ms']:.4f}"
          f" ({mine['graph_ms']:.4f}): {ms / mine['ms']:.2f}x; its T max_abs_err {err:.3e}"
          f" (tol {limit:.3e})")
    require(err <= limit and bool(torch.equal(div_g, div_p)),
            f"fgw {label}: the global route disagrees with the plain version")
    return dict(ms=ms, graph_ms=replay_ms, max_abs_err=err)


def check_fgw_bits(label, args):
    """Two launches of K3 on the same input give the same bits (no atomics;
    the cluster's reductions run in rank order)."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import _couplings

    first = _couplings(*args, count="uncounted", **FGW_KW)
    second = _couplings(*args, count="uncounted", **FGW_KW)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[fgw {label}] two launches on one input: T, flags and iterations bit for bit equal {same}")
    require(same, f"fgw {label}: two launches on one input differ")


def check_big_barycenter(device, n):
    """18b: the per-molecule barycenter at ``n`` atoms (K3' on the route of
    the padded n, five launches) on the card against the CPU: Y and C
    within ``BARY_ATOL``, the gradient w.r.t. ``Ys`` within
    ``BARY_GRAD_RTOL``; its launch counts are zeroed just before and read
    just after."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.ops.cuda.fgw import launch_name
    from conan_fgw_tpu_torch.ops.fgw import FGWConfig

    Ys, Cs, ps, p = molecule_problem(n, SEED + 1727 + n, device)
    R = torch.randn(n, MOL_D, generator=torch.Generator().manual_seed(SEED + 1728 + n))
    cfg = FGWConfig()
    reset_launches()
    Y_k, C_k, nd_k, g_k = _barycenter_run(Ys, Cs, ps, p, cfg, None, R.to(device))
    torch.cuda.synchronize()
    grew = {k: v for k, v in launches.items() if v}
    Y_c, C_c, nd_c, g_c = _barycenter_run(*(t.cpu() for t in (Ys, Cs, ps, p)), cfg, None, R)
    err_y = float((Y_k.cpu() - Y_c).abs().max())
    err_c = float((C_k.cpu() - C_c).abs().max())
    grad_rel = float((g_k.cpu() - g_c).norm() / g_c.norm())
    print(f"[big barycenter] n={n}, K={K}: Y max_abs_err {err_y:.3e}, C {err_c:.3e} (tol"
          f" {BARY_ATOL}); diverged card {nd_k} CPU {nd_c}; gradient w.r.t. Ys rel"
          f" {grad_rel:.3e} (tol {BARY_GRAD_RTOL}); launches {grew}")
    want = {launch_name("fgw_couplings_mol", n + (-n % 32)): cfg.outer_iters}
    require(grew == want, f"big barycenter n={n}: launches {grew}, want {want}")
    require(err_y <= BARY_ATOL and err_c <= BARY_ATOL, f"big barycenter n={n} disagrees")
    require(nd_k == nd_c and grad_rel <= BARY_GRAD_RTOL, f"big barycenter n={n}: flags or gradient")
    return dict(y_err=err_y, c_err=err_c, grad_rel=grad_rel, launches=grew)


def check_big_batch(device, n, batch):
    """18b: ``fgw_barycenter_batch`` on ``batch`` molecules of ``n`` atoms
    (flat K3 on the route of the padded n, five launches) on the card
    against the CPU: Y and C within ``BARY_ATOL``, diverged counts equal;
    launch counts zeroed just before, read just after."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.ops.cuda.fgw import launch_name
    from conan_fgw_tpu_torch.ops.fgw import FGWConfig, fgw_barycenter_batch

    mols = [molecule_problem(n, SEED + 1890 + b, "cpu")[:2] for b in range(batch)]
    Ys = torch.stack([m[0] for m in mols])
    Cs = torch.stack([m[1] for m in mols])
    cfg = FGWConfig()
    reset_launches()
    Y_k, C_k, (nd_k, _) = fgw_barycenter_batch(Ys.to(device), Cs.to(device), config=cfg)
    torch.cuda.synchronize()
    grew = {k: v for k, v in launches.items() if v}
    Y_c, C_c, (nd_c, _) = fgw_barycenter_batch(Ys, Cs, config=cfg)
    err_y = float((Y_k.cpu() - Y_c).abs().max())
    err_c = float((C_k.cpu() - C_c).abs().max())
    print(f"[big batch] {batch} molecules of n={n}, K={K}: Y max_abs_err"
          f" {err_y:.3e}, C {err_c:.3e} (tol {BARY_ATOL}); diverged card {int(nd_k)} CPU"
          f" {int(nd_c)}; launches {grew}")
    want = {launch_name("fgw_couplings", n + (-n % 32)): cfg.outer_iters}
    require(grew == want, f"big batch n={n}: launches {grew}, want {want}")
    require(err_y <= BARY_ATOL and err_c <= BARY_ATOL, f"big batch n={n} disagrees")
    require(int(nd_k) == int(nd_c), f"big batch n={n}: diverged counts differ")
    return dict(y_err=err_y, c_err=err_c, launches=grew)


# 18c: the runner at max_atoms 192 on a synthetic CoV-2 set whose molecules
# fill the N=128 and the N=192 bucket in turn (97-128 and 129-181 atoms)
GEOM18_SPLITS = {"train": 36, "valid": 8, "test": 8}
GEOM18_NO_STORE = {"train": 1, "valid": 1, "test": 1}
GEOM18_SIZES = ((97, 128), (129, 181))
GEOM18_BUCKETS = (128, 192)
BIG_DTYPE_B = 4  # 18f's batch (B x K = 20 graphs at N=192)
# 18e: ViSNet with every option the JAX module has
VISNET_OPTIONS = dict(vertex=True, vecnorm_type="max_min", trainable_vecnorm=True,
                      trainable_rbf=True)
VISNET_B = 8


def max_atoms_copy(src: str, out_dir: Path, epochs: int, max_atoms: int = 192) -> str:
    """A copy of the YAML config ``src`` with ``num_epochs: epochs`` and
    ``max_atoms: max_atoms`` appended."""
    path = Path(config_copy(src, out_dir, epochs))
    text = path.read_text()
    require("max_atoms" not in text, f"{src} already sets max_atoms")
    out = path.with_name(f"{path.stem}_n{max_atoms}.yaml")
    out.write_text(text + f"max_atoms: {max_atoms}\n")
    return str(out)


@contextlib.contextmanager
def made_step_graphs():
    """Inside, every ``StepGraphs`` made is appended to the list it yields."""
    from conan_fgw_tpu_torch.train.graphs import StepGraphs

    made, init = [], StepGraphs.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    StepGraphs.__init__ = spy
    try:
        yield made
    finally:
        StepGraphs.__init__ = init


def check_train_graph_nodes(label, made) -> dict:
    """The K1/K2/K3 kernel nodes of every train graph of ``made`` (captured
    under ``kept_graphs``) against the launches its capture counted, by
    shape: ``{N: nodes}``."""
    out = {}
    for graphs in made:
        for (kind, shape), step in graphs.steps.items():
            if kind == "train" and step.graph is not None:
                nodes = captured_nodes(f"{label} N{shape[-1]}", step)
                out[shape[-1]] = {k: v for k, v in nodes.items() if v}
    print(f"[{label}] K1/K2/K3 nodes of the train graphs by N, as their captures counted: {out}")
    return out


def check_big_runner(device, card, tmp, common):
    """18c: ``cov2_5.yaml`` then ``cov2_5_bc.yaml`` with ``max_atoms: 192``
    (2 epochs each) on the set of ``GEOM18_*``: phase 14's checks (warm
    start, best at the highest ``val_auroc``, predict equal to the runner,
    no plain version, both buckets every epoch, exact K1/K2/K3 counts
    summed over the small and large routes), and every train graph's
    K1/K2/K3 nodes equal to what its capture counted, the N=192 graph's on
    the large kernels; then one stage-2 step at N=192 card against CPU, on
    half the config's batch as phase 14's N=128 step (the CPU's f32 step is
    the less precise of the two there: at 4 molecules it lay 1.34e-3 from
    a float64 step in the loss, the card 9.7e-5; PERF.md §6)."""
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model, load_datasets

    kernels = (("cfconv_fwd_f256", "cfconv_fwd_f256_large"),
               ("cfconv_bwd_f256", "cfconv_bwd_f256_large"),
               ("fgw_couplings", "fgw_couplings_cluster"))
    out, totals = {}, collections.Counter()
    with runner_spies() as (plain_calls, restores, captures, host), kept_graphs():
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        for stage, src in GEOM_STAGES:
            first_restore = len(restores)
            cfg = max_atoms_copy(src, tmp, RUNNER_EPOCHS)
            label = "geom192 stage 1" if stage == "conan_fgw_pre" else "geom192 stage 2"
            with last_evaluation() as test_eval, made_step_graphs() as made:
                summary, history, out[label] = geom_stage(label, stage, cfg, ctx, card, kernels,
                                                          "auroc", GEOM18_BUCKETS)
            out[label]["nodes"] = check_train_graph_nodes(label, made)
            big = out[label]["nodes"].get(192, {})
            require(all(big.get(k) for k in WGMMA_KERNELS)
                    and big.get("fgw_couplings_cluster_kernel", 0) == (5 if stage == "conan_fgw" else 0)
                    and not big.get(TEAM_KERNEL)
                    and not big.get("fgw_couplings_stream_kernel"),
                    f"{label}: the N=192 train graph's large-kernel nodes {big}")
            del made
            totals.update(out[label]["launches"])
            check_best_auroc(label, history, summary,
                             tmp / "models" / "smoke" / "0" / f"run_{stage}:0")
        check_warm_start(restores, first_restore,
                         tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
        check_predict_auroc("geom192 stage 2", cfg, tmp, str(tmp), summary, device, test_eval)
        require(not plain_calls, f"geom192: plain versions ran: {dict(plain_calls)}")
    config = load_config(cfg)
    half = config.batch_size // 2
    records = [r for r in load_datasets(config, str(tmp / "data"))["train"].records()
               if r.num_atoms > 128][:half]
    pb = pack_batch(records, max_atoms=192, batch_size=half)
    out["parity"] = step_parity(build_model(config, seed=SEED, device=device), pb, device,
                                f"geom192 parity N192 B{len(records)}")
    out["launches"] = dict(totals)
    return out, config


def check_shuffled_fit(device, config, tmp):
    """18d: one graphed ``fit`` of the flagship regression model (F=128,
    stage 2) on the set's train molecules with ``shuffle=True,
    bucketed=False``: every batch at N=192, on the large kernels alone; the
    batches it stepped, epoch by epoch, equal a CPU replay of
    ``batch_iterator`` under ``epoch_rng`` (numpy packer, no prefetch),
    molecule by molecule; the launch counts, zeroed just before and read
    just after, are this path's."""
    import numpy as np
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train import graphs as graphs_mod
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.runner import load_datasets

    data = load_datasets(config, str(tmp / "data"))
    train, val = data["train"].records(), data["valid"].records()
    settings = loop.TrainSettings(batch_size=config.batch_size, num_epochs=RUNNER_EPOCHS,
                                  use_barycenter=True, shuffle=True, bucketed=False,
                                  max_atoms=192, seed=SEED)
    seen, train_step = [], graphs_mod.StepGraphs.train

    def spy(self, pb):
        seen.append((pb.z.copy(), pb.pos[:, 0, 0].copy()))
        return train_step(self, pb)

    graphs_mod.StepGraphs.train = spy
    reset_launches()
    t0 = time.perf_counter()
    try:
        result = loop.fit(settings, train, val, model=ConanModel(seed=SEED, device=device),
                          device=device)
        torch.cuda.synchronize()
    finally:
        graphs_mod.StepGraphs.train = train_step
    wall = time.perf_counter() - t0
    grew = {k: v for k, v in launches.items() if v}
    replay = [(pb.z, pb.pos[:, 0, 0]) for epoch in range(RUNNER_EPOCHS)
              for pb in loop.batch_iterator(train, settings.batch_size, 192, shuffle=True,
                                            rng=loop.epoch_rng(settings, epoch), prefetch=False,
                                            bucketed=False, pack=pack_batch)]
    same = len(seen) == len(replay) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(seen, replay))
    shapes = sorted({z.shape[-1] for z, _ in seen})
    losses = [r["train_loss"] for r in result.history]
    # the last epoch's steps are replays of the N=192 train graph
    last = result.history[-1]
    replay_ms = 1e3 * last["train_s_n192"] / last["steps_n192"]
    print(f"[shuffled fit] {len(seen)} graphed steps over {RUNNER_EPOCHS} epochs, shuffle=True,"
          f" bucketed=False: batch N {shapes}; order equal to the CPU replay {same}; train loss"
          f" {losses}; launches {grew}; {wall:.1f} s; the last epoch's stage-2 steps at N=192"
          f" (B={settings.batch_size}, F=128, graph replays) {replay_ms:.2f} ms/step (the kernels"
          f" before K2 at F=128's wgmma kernel: 18.32-19.01)")
    require(same, "shuffled fit: the batch order differs from the CPU replay")
    require(shapes == [192], f"shuffled fit: batches at N={shapes}")
    require(all(np.isfinite(losses)), "shuffled fit: a non-finite loss")
    want = {"cfconv_fwd_large", "cfconv_bwd_large", "fgw_couplings_cluster"}
    require(set(grew) == want, f"shuffled fit: launches {grew}, want {sorted(want)} only")
    return dict(steps=len(seen), losses=losses, launches=grew, wall_s=wall, replay_ms=replay_ms)


def check_visnet_options(device):
    """18e: one ViSNet stage-2 step with ``VISNET_OPTIONS`` (the runner's
    ViSNet model, its backbone rebuilt with them and initialised as flax
    does) on the card against the CPU within phase 4's gates."""
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import init_like_flax
    from conan_fgw_tpu_torch.models.visnet import ViSNet3D
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model

    model = build_model(load_config(BACKBONES["visnet"][1]), seed=SEED, device="cpu")
    model.backbone = ViSNet3D(128, cutoff=5.0, max_neighbors=CAP, **VISNET_OPTIONS)
    init_like_flax(model.backbone, torch.Generator().manual_seed(SEED + 1850))
    recs = random_dataset(SEED + 1851, VISNET_B, num_conformers=K, heavy_range=(8, 10),
                          device=device)
    pb = pack_batch(recs, max_atoms=32, batch_size=VISNET_B)
    return step_parity(model.to(device), pb, device, f"visnet options B{VISNET_B}")


def check_big_dtypes(device, config, tmp):
    """18f: the large kernels' bf16 and f16 variants on their path: two
    graphed stage-2 train steps (the eager warm-up, then the capture and
    its replay) at N=192 of the regression model (F=128) and of the
    classification model (F=256) in each type, launch counts zeroed just
    before and read just after; each must launch its own variants and no
    other cfconv kernel, and its losses must be finite. Then ``BIG_TIMED``
    replays of each graph, timed. Returns the launches and the ms a step
    by type and width."""
    import dataclasses

    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model, load_datasets

    records = [r for r in load_datasets(config, str(tmp / "data"))["train"].records()
               if r.num_atoms > 128][:BIG_DTYPE_B]
    pb = pack_batch(records, max_atoms=192, batch_size=BIG_DTYPE_B)
    regression = load_config(RUNNER_STAGES[1][1])
    out, ms = collections.Counter(), {}
    for cfg in (regression, config):
        for dtype in ("bfloat16", "float16"):
            model = build_model(dataclasses.replace(cfg, compute_dtype=dtype), seed=SEED,
                                device=device)
            settings = loop.TrainSettings(task=cfg.spec.task, batch_size=BIG_DTYPE_B,
                                          use_barycenter=True)
            graphs = loop.step_graphs(model, loop.make_optimizer(model, settings), settings,
                                      device)
            reset_launches()
            losses = [float(graphs.train(pb)[0]) for _ in range(2)]
            torch.cuda.synchronize()
            grew = {k: v for k, v in launches.items() if v}
            F = 256 if cfg.spec.task == "classification" else 128
            suffix = "_bf16" if dtype == "bfloat16" else "_f16"
            width = "" if F == 128 else "_f256"
            want = {f"cfconv_fwd{width}_large{suffix}", f"cfconv_bwd{width}_large{suffix}",
                    "fgw_couplings_cluster"}
            t0 = time.perf_counter()
            for _ in range(BIG_TIMED):
                graphs.train(pb)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / BIG_TIMED
            ms[f"{dtype}_f{F}"] = step_ms
            print(f"[big {dtype} F{F}] two graphed stage-2 steps at N=192 (B={BIG_DTYPE_B}):"
                  f" losses {losses}; launches {grew}; {BIG_TIMED} replays {step_ms:.2f} ms a step")
            require(set(grew) == want, f"big {dtype} F{F}: launches {grew}, want {sorted(want)}")
            require(all(l == l and abs(l) != float("inf") for l in losses),
                    f"big {dtype} F{F}: a non-finite loss")
            out.update(grew)
            del model, graphs
    torch.cuda.empty_cache()
    return dict(out), ms


def phase_large(device, card, rows):
    """Phase 18: molecules above 128 atoms and the last options. 18a/18b
    the large kernels against their plain versions (``check_big_kernels``)
    and the per-molecule barycenter at n=150; 18c the runner at max_atoms
    192; 18d a shuffled, unbucketed graphed ``fit``; 18e ViSNet's options;
    18f the large kernels' bf16 and f16 variants on graphed steps."""
    t0 = time.perf_counter()
    out = {"k3_shapes": check_big_kernels(device, rows)}
    out["barycenter"] = check_big_barycenter(device, BIG_MOL)
    out["stream_barycenter"] = check_big_barycenter(device, STREAM_MOL)
    out["stream_batch"] = check_big_batch(device, STREAM_MOL, STREAM_BATCH)
    out["global_barycenter"] = check_big_barycenter(device, GLOBAL_MOL)
    out["global_batch"] = check_big_batch(device, GLOBAL_MOL, GLOBAL_BATCH)
    out["kernels_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_geom192_") as name:
        tmp = Path(name)
        out["atoms"] = make_geom(tmp, GEOM18_SPLITS, GEOM18_NO_STORE, GEOM18_SIZES,
                                 GEOM18_BUCKETS)
        common = ["--data_root", str(tmp), "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        out["runner"], config = check_big_runner(device, card, tmp, common)
        out["shuffled_fit"] = check_shuffled_fit(device, config, tmp)
        out["dtypes"], out["dtype_step_ms"] = check_big_dtypes(device, config, tmp)
    out["visnet_options"] = check_visnet_options(device)
    totals = collections.Counter(out["runner"]["launches"])
    totals.update(out["shuffled_fit"]["launches"])
    totals.update(out["dtypes"])
    for key in ("barycenter", "stream_barycenter", "stream_batch", "global_barycenter",
                "global_batch"):
        totals.update(out[key]["launches"])
    out["launches"] = {k: totals[k] for k in REPLACES}
    missing = [k for k in LARGE_NAMES if not out["launches"][k]]
    require(not missing, f"phase 18: large kernels never launched on a path: {missing}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[large] phase 18 took {out['phase_s']:.1f} s (kernel checks {out['kernels_s']:.1f} s);"
          f" launches {out['launches']}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import conan_fgw_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    from conan_fgw_tpu_torch.device import pin_full_f32

    pin_full_f32()
    t0 = time.perf_counter()
    device = "cuda"
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_s = {}

    def timed(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[label] = round(time.perf_counter() - t, 1)
        return out

    timed("1", phase_build)
    rows = timed("2", phase_kernels, device)
    model, totals, stage_rows = timed("3", phase_train, device, card)
    timed("3 profile", profile_stage2, model, device)
    timed("4", phase_parity, model, device)
    stage_rows["runner"] = timed("5", phase_runner, device, card)
    stage_rows["classification"] = timed("6", phase_classification, device, card)
    stage_rows["graphs"] = timed("8", phase_graphs, device, card)
    stage_rows["pipeline"] = timed("9", phase_pipeline, device, card)
    stage_rows["backbones"] = timed("10", phase_backbones, device, card, rows)
    stage_rows["esan"] = timed("11", phase_esan, device, card, rows)
    stage_rows["bf16"] = timed("12", phase_bf16, device, card, rows, f32={
        "graphs": stage_rows["graphs"]["stage 2 N32"], "runner": stage_rows["runner"],
        "backbones": stage_rows["backbones"]})
    stage_rows["fgw"] = timed("13", phase_fgw, device, card, rows)
    stage_rows["geom"] = timed("14", phase_geom, device, card, rows)
    # 16a's data is made on half the host's CPUs while phase 15's ranks and
    # phase 7's fresh processes run, which time nothing they are held to
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prepare_") as data_root:
        started = start_prepare_sol250(Path(data_root))
        try:
            single = {label: stage_rows["runner"][label]["test_rmse"]
                      for label in ("stage 1", "stage 2")}
            stage_rows["dp"] = timed("15", phase_dp, device, card, rows, single)
            stage_rows["determinism"] = timed("7", phase_determinism)
        except BaseException:
            started[0].kill()
            started[0].wait()
            raise
        prepared = (data_root, timed("16a wait", finish_prepare_sol250, Path(data_root), started))
        stage_rows["tools"] = timed("16", phase_tools, device, card, rows, prepared)
    stage_rows["last"] = timed("17", phase_last, device, card, rows)
    stage_rows["large"] = timed("18", phase_large, device, card, rows)
    stage_rows["phase_s"] = phase_s
    print(f"[phases] seconds by phase {json.dumps(phase_s)}")

    def extra(row):
        out = {"bound_f32_ms": row["bound_f32"][0]} if "bound_f32" in row else {}
        out.update({k: row[k] for k in ("graph_ms", "sinkhorn_iters") if k in row})
        return out

    # launches: the regression kernels on the main path (phase 3), the F=256
    # ones on the classification path (phase 6), the bf16 variants on the
    # bf16 runner's path (phase 12), the F=256 bf16 ones on phase 12's
    # classification step and graphs, K3 through its per-molecule wrapper
    # on the per-molecule barycenter's path (phase 13); each
    # also by runner path, the ViSNet and DimeNet runners' (phase 10), the
    # ESAN configs' (phase 11), the bf16 runner's (phase 12) and the deep
    # budget's (phase 13), the GEOM runners' (phase 14), rank 0's of the
    # data-parallel runner (phase 15) and the tools' K=3 paths' (phase 16)
    # included.
    # All these paths step through CUDA graphs: see the module docstring
    # The large routes' launches are those of phase 18's paths (the runner at
    # max_atoms 192, the shuffled fit, the bf16 and f16 steps, the
    # per-molecule barycenters at n=150, 270 and 520, the batched ones at
    # n=270 and 520), and their row is N=192's (K3 through the per-molecule
    # wrapper: n=150's on the cluster route; the stream route: N=288's and
    # n=270's; the global route: N=544's and n=520's)
    class_launches = stage_rows["classification"]["launches"]
    bf16_launches = stage_rows["bf16"]["launches"]
    large_launches = stage_rows["large"]["launches"]
    kernels = []
    for name in REPLACES:
        r = rows[name][{"fgw_couplings_mol_cluster": f"N{BIG_MOL}",
                        "fgw_couplings_stream": STREAM_SHAPE[0],
                        "fgw_couplings_mol_stream": f"N{STREAM_MOL}",
                        "fgw_couplings_large": f"N{GLOBAL_N}",
                        "fgw_couplings_mol_large": f"N{GLOBAL_MOL}"}.get(
                            name, "N192" if name in LARGE_NAMES else "N32")]
        bound_ms, bound_by = r["bound"]
        main_path = (large_launches[name] if name in LARGE_NAMES else
                     totals[name] if name in REGRESSION else
                     stage_rows["fgw"]["launches"][name] if name == "fgw_couplings_mol" else
                     stage_rows["last"]["launches"][name] if name.endswith("_f16") else
                     stage_rows["bf16"]["class_launches"][name] if name.endswith("_f256_bf16") else
                     bf16_launches[name] if name.endswith("_bf16") else class_launches[name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": main_path,
            "runner_launches": stage_rows["runner"]["launches"].get(name, 0),
            "bf16_runner_launches": bf16_launches.get(name, 0),
            "deep_runner_launches": sum(run["launches"].get(name, 0)
                                        for run in stage_rows["fgw"]["runner"].values()),
            "classification_launches": class_launches.get(name, 0),
            "geom_launches": stage_rows["geom"]["launches"].get(name, 0),
            "dp_launches": stage_rows["dp"]["launches"].get(name, 0),
            "tools_launches": stage_rows["tools"]["launches"].get(name, 0),
            "f16_launches": stage_rows["last"]["launches"].get(name, 0),
            "phase18_launches": large_launches[name],
            **{f"{bb}_launches": stage_rows["backbones"][bb]["launches"].get(name, 0)
               for bb in BACKBONES},
            **{f"{cfg}_launches": run["launches"].get(name, 0)
               for cfg, run in stage_rows["esan"]["runner"].items()},
            "max_abs_err": max(rows[name][lab]["max_abs_err"] for lab in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra(r),
        })
        for lab, other in rows[name].items():
            if other is not r:
                kernels[-1][lab.lower()] = dict(
                    ms=other["ms"], plain_ms=other["plain_ms"], bound_ms=other["bound"][0],
                    **extra(other))
    flagship = stage_rows["graphs"]["stage 2 N32"]
    print(f"[done] {time.perf_counter() - t0:.1f} s; stage 2 {stage_rows[2]['step_ms']:.2f} ms/step"
          f" (phase 3, graphed); phase 8 at N=32: eager {min(flagship['eager_ms']):.3f}, graphed"
          f" {min(flagship['graphed_ms']):.3f} ms/step; geom_launches"
          f" {json.dumps({k['name']: k['geom_launches'] for k in kernels})}; dp_launches (rank 0)"
          f" {json.dumps({k['name']: k['dp_launches'] for k in kernels})}; tools_launches"
          f" {json.dumps({k['name']: k['tools_launches'] for k in kernels})}; phase 17"
          f" {stage_rows['last']['phase_s']:.1f} s; phase 18 {stage_rows['large']['phase_s']:.1f} s;"
          f" phase18_launches {json.dumps({k['name']: k['phase18_launches'] for k in kernels})}")
    print(json.dumps({"kernels": kernels, "launches_counted": LAUNCHES_COUNTED, "train": stage_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--determinism-worker":
        sys.exit(determinism_worker(sys.argv[2], sys.argv[3] == "1"))
    sys.exit(main())

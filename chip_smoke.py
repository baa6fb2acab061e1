#!/usr/bin/env python3
"""Drive the PyTorch port of GreenDyGNN on one NVIDIA GPU and check it.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. Print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` (sm_90a),
   one ``nvcc`` per source, all at once. Read ptxas's report of the bf16
   flash kernel (``flash_fwd_wgmma_kernel<D, D_v>``, (D, D_v) in (32,
   32), (64, 64), (128, 128) and MLA's (96, 64) and (192, 128)) and of
   the backward's 31 instances: log their registers and spills, and fail if a bf16
   instance spills or if ptxas says "wgmma.mma_async instructions are
   serialized". Likewise fail if an
   instance of the CSR SpMM (``csr_spmm_kernel<G, V>``, 12 of them) or of
   the EmbeddingBag kernel (``embedding_bag_kernel<G, V, U>``, 24 of them)
   spills, or the envs' window kernels' instance for the path's owner
   count (``queue_window_kernel<3>``, ``cluster_window_kernel<3>``; those
   of 1, 2, 4, 8 and 16 are logged with the shared memory a block takes).
2. The policy phase, after the build and the checks of phase 3 that
   read the trainer's kernels from the profiler (the profiler has
   dropped kernels from later traces in a process that ran the
   training's millions of launches first): the paper's calibrate -> train -> deploy
   flow through ``repro_torch.train.policy``. ``calibrate_table_from_bundle`` and
   ``calibrate_from_bundle`` run on the main path's bundle (the (W, delta)
   stall grid through the modeled trainer). The tensor cost laws, both
   simulators' reset and 12 steps of 8 envs (the same draws on both
   devices) and the DQN loss's gradients are held on the card against
   the same calls on the CPU (``TOL_POLICY``, rtol 1e-5). Then
   ``get_or_train_policy`` trains Double-DQN on the card in the table and
   the analytic env (32 envs, ``POLICY_ITERS`` iterations each, artifacts
   in a temporary directory), logging iterations/s, episodes, gradient
   steps and the mean reward of the last 200 iterations. On 4 held-out
   episodes run to their end, each greedy policy's discounted return
   (the objective DQN maximises) must beat the fresh qnet's (seed 99, as
   in the reference's training test); the energy and the return of the
   trained policy, the fresh qnet, the untrained qnet training starts
   from and static W = 2 and 16 are logged. Two same-seed card runs must
   give equal qnets. After the timing (phase 7), pairs of short
   runs (unprofiled, then under ``torch.profiler``) give per-iteration
   host wall, device kernels, copies, device busy and idle share, and,
   with CUDA's sync debug mode on, the host syncs, which must not grow
   with the iterations.
   The queue phase follows (``phase_queue``): the queue env
   (``core/queue_sim.py``) on the card against the CPU, reset and
   ``ENV_CHECK_STEPS`` steps of 28 envs covering all 14 scenario codes,
   W = 1, 16 and 128, windows cut by the horizon, once plain and once at
   ``mem_budget_frac`` 0.3 with the headroom entry (``TOL_POLICY``; a
   finished episode's 0 / 0 entries are NaN on both sides); the
   ``queue_window`` kernel against its plain version on the same
   operands for every code at every W, at P = 3, 1, 2, 4, 8 and 16 and
   under the memory spill (``TOL_POLICY``, a relaunch bit-identical, live
   steps = eff_window); ``get_or_train_policy(env="queue")`` on the analytic
   pool (32 envs, ``QUEUE_ITERS`` iterations, the default scenario
   pool), which must launch the kernel exactly twice an iteration (+1 for
   the first reset); held-out whole episodes under ``paper_schedule`` and
   ``bursty_markov``, where the trained policy's discounted return must
   beat the fresh qnet's (energies logged beside static W = 2 and 16).
   After the timing, the profiled pairs of runs cover the queue env too.
   The cluster-env phase follows (``phase_cluster_env``): the cluster env
   (``envs/cluster_sim.py``) on the card against the CPU (reset and
   ``ENV_CHECK_STEPS`` steps of 28 envs over every queue code, archetype
   and live-peer count, plain and at ``mem_budget_frac`` 0.3 with the
   headroom entry, ``TOL_POLICY``); the ``cluster_window`` kernel against its plain
   version for every archetype, live-peer count, sync mode, peer policy
   and W at P = 3, 1, 2, 4, 8 and 16 and P = 3 under the spill
   (``TOL_POLICY``, a relaunch bit-identical, live steps = eff_window);
   the reduction: at zero peers and clean factors the kernel's outputs
   ``torch.equal`` to ``queue_window``'s, and a 28-env card episode of
   the cluster env equal to the queue env's bit for bit;
   ``get_or_train_policy(env="cluster", n_workers=4)`` on the analytic
   pool (32 envs, ``POLICY_ITERS`` iterations), 2 launches an iteration
   + 1; held-out whole episodes (default pools; the full fleet under a
   hot owner), the trained qnet's discounted return above the fresh
   qnet's. Then the deployment, in a fresh process of this script
   (``--deploy DIR``, the qnets passed as files): ``run_cluster`` at
   P = 4, measured, batch 2000, 3 epochs of 8 steps (1 of warmup), under
   ``clean``, ``paper_schedule`` and partition 0's NIC at 0.35, with
   static_w, greendygnn under the cluster-trained policy and greendygnn
   under the queue-trained one: joules per rank-epoch and barrier wait
   logged side by side, every rank's launch counts held, and the
   process's first run's epoch 0 within ``EPOCH0_BAND`` of its later
   epochs' joules on every rank.
   The paper phase (``phase_paper``) starts after the policy phase, in
   a process of its own (``--paper DIR``, the qnet passed as a file)
   that runs beside the queue and cluster-env phases and is joined
   before the deployment, its output relayed then: the
   table-trained qnet stands as ``qnet_main`` and ``qnet_example`` in a
   temporary artifact directory; every module of
   ``repro_torch.paper.run`` runs at the reference's full grid on the
   card (Table I's 3 datasets x 3 batches x 4 methods at 14 epochs of
   32 steps, Table II's ablations, Figs. 1 and 5-9, Fig. 8's 7 x 6
   grid, pipeline overlap at W = 16), its rows and each module's wall
   time logged; a module that raises ends the run. Table I's
   ``PAPER_CELL`` rerun on the CPU must give the card's totals, windows
   and digest. Then the four examples of ``repro_torch.examples`` at
   their defaults: quickstart (its own 2,500-iteration DQN on the
   card), serve_lm, train_distributed_gnn (its checkpoint read back)
   and congestion_adaptation_demo. No hand-written kernel may launch in
   the phase.
   The sweeps phase (``phase_sweeps``) runs beside it, in a process of
   its own (``--sweeps DIR``, ``phase_dryrun``'s records passed as the
   dry-run's files), joined after it: the reference's last harness
   modules through ``repro_torch.paper``, their policies trained there at
   ``SWEEP_ITERS`` iterations (each training's iterations/s logged with
   the host's CPU; each must launch its env's window kernel 2 an
   iteration + 1 times, and the eight trainings of the phase must all
   run), at the reference's batch over ``SWEEP_STEPS`` steps.
   ``scenario_sweep``: the 12 registry scenarios x dgl, bgl, static_w
   and heuristic at P = 1, then its clean-parity check.
   ``cluster_sweep`` at P = 4: the 6 scenarios x the 5 methods, the
   mixture axis and the memory axis at ``tight``, held to the
   reference's ``--check`` invariants that do not rest on the policies'
   quality (emergent queueing on every scenario without an overlay, the
   unlimited budget digest-equal to the in-RAM store, the paired
   greendygnn cells equal, block fetches and evictions). ``run_cluster`` at P = 2 and 8, static_w and greendygnn
   (the cluster twin's policy for P: the window kernel at 1 and 7
   owners), each digest-equal to its rerun on the CPU. ``policy_gauntlet``:
   the 12 scenarios x the baselines and the analytic, table and queue
   policies; its gate logged. ``roofline_report`` over the records. The
   memory axis and the trainings must launch ``embedding_bag``,
   ``queue_window`` and ``cluster_window``.
3. Hold each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it. The trainer's kernels' checks run
   right after the build, with the trainer's two profiles of phase 4:
   they read the kernels' instances from ``torch.profiler``, and a
   process that has launched ~3M kernels (the policy phase launches tens
   of millions) got none of those kernels into a trace. The trainer's kernels at the first
   mini-batch of the default ``reddit`` trace: the CSR SpMM for layer 0,
   layer 1 and layer 1's transposed CSR (atol 1e-4, rtol 1e-5: fp32
   summed in another order; two launches bit-identical); ``Spmm``'s
   backward against plain autograd
   (same tolerance). Then the CSR SpMM at any width: F = 6 and 130 (the
   scalar instance) and 132 and 256 (float4, two column slabs) on the
   layer-0 CSR, and F = 1,433 on full_graph_sm's layer-0 CSR from the
   trainer's input rows (1,436 floats apart: float4, 12 slabs) and from
   the same rows contiguous (scalar, 45 slabs); each against the plain
   version (``TOL_SPMM``), relaunched bit-identical, the instance read
   from the profiler's kernel names. The EmbeddingBag
   gather ``torch.equal`` to ``table[idx]`` at the padded L = 8192 shape
   the gather ran until the port dropped the pad, and at the path's own
   shape (one bag per hit, built by ``BagFormat.from_numpy`` as the device
   tier builds it); weighted bags with 512 empty bags (atol 1e-5 against
   the plain version), through the tensor wrapper and the format alike;
   relaunches bit-identical; a row width D % 4 != 0 (602, reddit's) and
   an unaligned table, which must run the scalar instance (kernel names
   read from ``torch.profiler``). Flash attention: the reference's test matrix and ragged
   lengths in float32 (atol 2e-5, rtol 1e-4, against the plain version and
   the dense oracle), GQA over strided heads; then the bf16 tensor-core
   kernel over a matrix: (D, D_v) in {(32, 32), (64, 64), (128, 128),
   (96, 64)}, causal and not, ragged S (100, 200, 4000), Sk > Sq, GQA
   over strided head views, each against
   the plain version (atol 1e-3, rtol 1e-2: both round p the same way and
   cast the output once, so they differ by about one bf16 ulp) and the
   float32 oracle (atol 4e-2, rtol 2e-2: p and the output rounded to
   bf16), with its per-row relative L2 errors logged. Then TinyLlama's
   prefill shape (B=2, S=4096, Hq=32, Hkv=4, D=64, causal): in float32
   against the plain version and the dense oracle (atol 2e-5, rtol 1e-4);
   in bf16 against the plain version and the float32 oracle at the same
   tolerances as the matrix; two bf16 launches bit-identical. The plain
   version runs the bf16 kernel's own ``TILE_Q`` x ``TILE_K`` tiles, so
   both round p at the same running max. MLA's (96, 64) instance in
   float32 too (causal and not, ragged S, Sk > Sq, strided GQA heads,
   against the plain version and ``dense_attention``), and bf16 at
   qwen3's (Hq=16, Hkv=8, D=128) and minicpm3's (H=40, D=96, D_v=64)
   prefill shapes (B=2, S=4096), relaunched bit-identical.
4. Run the trainer's main path, ``repro_torch.train.gnn_trainer.run``: the
   GreenDyGNN trainer with measured compute and the device payload tier,
   batch 2000, 3 epochs (2 of warmup) of 8 steps, its controller running
   the table-trained policy of phase 2.
   Every launch count is zeroed just before and read just after; the run
   must have launched both of its kernels (the CSR SpMM 3 times a step,
   twice in the parity check and 3 times in each of the engine's untimed
   first runs of a new shape signature, ``n_compiles``; the
   EmbeddingBag kernel once a step with hits and once a rebuild that keeps
   rows of the active table, its persisted-row gather), passed
   the CSR-path/scatter parity check (< 2e-3), given finite losses and
   let the controller decide after warmup. Then more trainer paths
   through ``gnn_trainer.run``, each with the counts zeroed just before
   and read just after and held to the same launch rules: full_graph_sm
   (d_in = 1,433, 6 measured steps); the congestion runs, the reddit
   stand-in at the main path's widths and batch (5 epochs of 4 steps, 1
   of warmup) for dgl, static_w, heuristic and greendygnn (once under
   the table-trained and once under the queue-trained policy) under the
   event fabric's ``paper_schedule`` and ``bursty_markov``, one line a run
   with its joules per epoch, windows, hits, misses, remote bytes and
   launches, the adaptive methods required to decide; ooc_community
   (96 features, streamed) under a host budget of 0.3 of its feature
   matrix, which must fetch blocks and stay within the budget unless a
   pin ran over it. A short static-window run on the card is then
   compared with the same run on the CPU through the plain versions
   (discrete streams equal, losses rtol 1e-4), and static_w and heuristic
   under both scenarios in the modeled lane with device payloads (the
   card gathers through the EmbeddingBag kernel) with the CPU: every field
   of the result digest, energy totals included, bit-equal. The trainer's
   profile (``phase_profile``, run right after the build, see phase 3)
   splits steady trainer steps into device time by kernel against
   the host clock, and fails unless the steps' kernels include
   ``csr_spmm_kernel``, and one
   ``embedding_bag_kernel`` per step with hits (and one per rebuild that
   keeps rows) and no
   ``radixSortKVInPlace``; it logs the host spans (the device-tier
   gather, the host feature rows, the input placement) and the copies
   each way.
   Then the threaded pipeline (``async_pipeline=True``) at the main path's
   widths and batch, static_w: at W = 4 and W = 7 (windows straddling
   epochs), 3 epochs of 8 steps, the synchronous and the threaded run
   through ``gnn_trainer.run`` give equal hit and miss streams, windows and
   fetched rows per owner, under the same launch rules (threaded, every
   persisted-row gather is counted on the builder thread); at every swap of
   the threaded W = 4 run the table the builder made on its own stream,
   and the gather of every active slot, are ``torch.equal`` to the host
   payload (the checks' launches taken off the count). The host wall per
   step, split into the consumer's time at rebuild boundaries and the
   rest, synchronous, threaded, and threaded with the prefetcher's
   resolver a no-op, in turns ((sync, async, async-noprefetch,
   async-noprefetch, async, sync) twice), and the ``PipelineReport``
   (builder wall, exposed wait, overlap
   efficiency, swap latency) are printed. ``torch.profiler`` over two
   threaded windows (``phase_pipeline_profile``, also right after the
   build) must show the builds' uploads as pinned copies on a
   stream other than the compute stream, the persisted-row gathers there
   too, and no pageable copy the size of a payload table. greendygnn
   threaded under the paper schedule must rebuild and decide windows in
   the action set; ooc_community threaded under a host budget of 0.3 of its
   matrix must give the CPU's ``tier_counts``.
5. The cluster phase (``phase_cluster``): P = 4 trainers, every partition
   a rank, through ``repro_torch.train.cluster.run_cluster``, at the main
   path's widths and batch (the reddit stand-in, batch 2000, fanouts (10,
   25), device payloads, 3 epochs of 8 steps). Each run zeroes the counts
   just before it and reads them just after; each rank's launches are
   read around its steps (the gate runs one rank at a time): 3 CSR SpMM
   launches a measured step, 2 in its parity check and 3 in each untimed
   first run of a new shape signature (the forward ones
   on its ``trainer-worker-{rank}`` thread, the backward's on the thread
   PyTorch's autograd engine keeps for the card), and one EmbeddingBag
   launch a step with hits and one a rebuild that keeps rows, on its own
   thread. Held: the reference's pinned P = 4 modeled run gives
   ``report_digest`` ``41d1a2d4…`` on the card and on the CPU; a P = 4
   modeled ``paper_schedule`` run with device payloads gives one digest
   on both; measured static_w under ``clean`` and ``paper_schedule``:
   every rank's hit and miss streams equal the CPU's and its losses
   within rtol 1e-4 (``TOL_CLUSTER_LOSS``); measured greendygnn under the
   table-trained policy: every rank's controller decides, in the action
   set; modeled: partition 0's NIC at 0.25 of its rate raises the
   fabric's queueing, a straggler at 2x t_base makes its peers wait at
   the barrier and ``max_stale=1`` cuts the wait; int8 and top-k (0.05)
   measured runs charge ``model_wire_bytes`` (int8 about a quarter of
   the uncompressed bytes), and both schemes on one set of SAGE
   gradients are bit-equal on the card and the CPU; a ``run_model=True``
   modeled P = 1 run (batch 600, 2 epochs of 4 steps: at batch 2000 a
   batch repeats a seed, which the reference's model step cannot take)
   gives model losses within rtol 1e-4 of the CPU's. It
   prints a line a rank (joules per epoch, wall, barrier wait, collective
   time, queueing, launches), the cluster's ``totals_kj`` and host wall
   per global step, the device busy and idle share of a profiled window
   of 2 global steps, and ends with the kernels built from cold by the
   ranks' own first launches (a fresh build directory, a threaded run of
   2 steps): one build, under the build lock.
   The trace phase (``phase_trace``) follows: greentrace
   (``repro_torch.obs``) on the card. ``python -m repro_torch.obs capture
   --workers 4`` (modeled lane, the card's device) must write files
   byte-equal to the reference's ``results/traces/{clean,hot_owner}.json``,
   reconciled, ``diff``'s top row ``link0/queue`` with more joules under
   the hot owner, and ``report --chrome`` a Chrome trace. Then, each with
   the counts zeroed just before it and read just after, ``trace=True``
   through: the main path (greendygnn, device payloads, the table-trained
   qnet, 3 x 8 steps; untraced, traced, traced, untraced, the first run's
   decisions replayed in the others so all take the same windows): launch
   counts equal traced and untraced, the ledger reconciled bit for bit,
   one ``controller/decide`` instant a decision, every
   ``compute/measured`` span naming the card and memory-bound at its
   peaks (``repro_torch.launch.roofline``); the threaded pipeline
   (static_w, W = 4): launches equal to the untraced run's, each
   rebuild's ``plan`` and ``fetch`` spans from the builder thread and its
   ``exposed-wait`` and ``swap`` spans from the consumer, reconciled;
   ``ooc_community`` at a host budget of 0.3 of its matrix: one
   ``store/tier-window`` counter a window, summing to the tier counts at
   the last window's boundary and equal to the CPU's; the measured P = 4
   ``run_cluster`` (static_w, ``clean``: untraced, traced, traced,
   untraced; then partition 0's NIC at 0.35, traced): launches by rank
   equal, every rank reconciled, every fabric span decomposed per owner,
   ``link0/queue`` attributed more joules under the hot owner. It logs
   the host wall a step (P = 1) and a global step (P = 4), traced and
   untraced, and its results go on a ``{"trace": ...}`` line before the
   ``kernels`` line.
6. Run the LM serving path at full width: ``tinyllama-1.1b`` (22 layers,
   d_model 2048, bf16, seeded random weights). Counts zeroed, then
   ``repro_torch.launch.serve.run`` (batch 4, prompt 8, generation 16;
   decode steps launch no flash kernel) and one ``prefill`` of B=2, S=4096
   (one flash launch per layer: 22), counts read. The serve run's last
   prompt step's logits are held against ``prefill`` on the same prompt,
   and the S=4096 prefill against the same model through the dense
   attention path: finite, the same argmax in every row, max |diff| under
   ``TOL_LOGITS``. Then ``torch.profiler`` splits one prefill's device time
   between the flash kernel, the matrix products and the rest (and fails
   unless every flash launch in it is ``flash_fwd_wgmma_kernel``, 22 of
   them), and a window of decode steps into device kernels per step,
   device busy time against the unprofiled host wall, and the host ops
   that take the most CPU time. Then the same serving phase and prefill
   profile at ``qwen3-1.7b`` (28 layers, GQA 16/8 at D=128, qk-norm;
   2.03B parameters) and ``minicpm3-4b`` (62 MLA layers: q/k head dim
   96, v head dim 64; 4.26B parameters), at full width: 28 and 62 flash
   launches a prefill, all ``flash_fwd_wgmma_kernel``; minicpm3's serve
   run decodes by the absorbed-matrix path against the latent cache, and
   its last prompt step is held against the expanded prefill. Then the
   MoE archs: ``moonshot-v1-16b-a3b`` at full depth (48 layers, GQA 16 x
   128, the first dense, then 64 routed experts top-6 and 2 shared;
   28.39B parameters) and ``deepseek-v2-236b`` (MLA at (192, 128), 128
   heads; 160 experts top-6 and 2 shared) cut in depth to what
   ``serve_peak_estimate`` fits in ``MEM_FRAC`` of the card (the log
   states the estimate). Each logs its routing: the share of (token, k)
   assignments dropped at capacity and the heaviest expert's load, for
   the decode steps (no drop: required) and the prefill. A bf16
   difference between two paths can flip an expert choice and so move
   which later tokens an expert drops, so each comparison's second path
   replays the first path's routing and logs the share of assignments
   its own router picked otherwise: the decode steps replay a no-drop
   prefill of the prompts, and the dense path replays a flash prefill of
   one sequence (the dense comparison's memory). At the served depth the
   decode steps are held against the prefill at ``TOL_MOE_DEEP`` (a
   max |diff| and a row relative L2 set from ``scripts/moe_depth_gap.py``'s
   readings against depth), and the serve run's logits, on its own
   routing, must equal those of the same decode steps. After the served
   model is freed, a model of ``MOE_CMP_LAYERS`` layers drawn on its own
   holds both comparisons at ``TOL_LOGITS`` (``phase_moe_paths``), each
   path's pick within the bound of the other path's best logit
   (random-weight logits tie in some rows).
   The LM training phase (``phase_lm_train``) follows. The flash
   backward (``csrc/flash_attention_bwd.cu``: float32 SIMT kernels, bf16
   ``wgmma`` kernels, one C entry) against its plain version on the same
   inputs, both given the kernel forward's ``lse``: float32
   (``TOL_BWD_F32``) and bf16 (rtol ``TOL_BWD_BF16_RTOL``, atol a
   fraction of the tensor's largest |plain|) at D = 32, 64, 128, causal
   and not, MHA, a ragged S, Sk > Sq and strided GQA heads; bf16 at the
   training shape (B=1, S=4096, Hq=32, Hkv=4, D=64, causal), two
   launches bit-identical, every gradient finite and non-zero. The
   forward with ``lse`` gives ``o`` bit-equal to the forward without it,
   and ``lse`` within ``TOL_LSE`` of the plain forward's. Through
   autograd the backward must launch once, on the autograd engine's
   thread, and give the direct call's gradients. Then the train_4k
   cell's step
   (``launch.train.make_train_step``: warmup-cosine AdamW 3e-4 / 2,000 /
   100,000, wd 0.1, clip 1.0, ``grad_accum`` 2; ``lm_loss`` with remat
   and ``loss_chunk`` 1,024) at TinyLlama-1.1B's full width, seeded
   random bf16 weights, S = 4,096, the cell's global batch of 256 cut to
   2: 6 steps with the counts zeroed just before and read just after
   (flash forward 88 launches a step, the pass and remat's recompute;
   backward 44, none on the main thread; the plain backward refused),
   losses finite and the first within 1.5 of ln V; each step's time
   (CUDA events), host wall and tokens/s, the peak memory, the step's
   bound at the bf16 peak; ``wq``, ``wk``, ``wv`` gradients non-zero in
   every layer. After step 3 the state is checkpointed blocking and
   async (``train.checkpoint``); both restore into a freshly drawn tree
   with every leaf ``torch.equal`` and step 3, and 3 steps from the
   restored state give the uninterrupted run's losses (``TOL_RESUME``).
   One profiled step gives the device busy time by kernel group and the
   idle share, and shows every backward on the ``wgmma`` kernels (44
   launches each of dK/dV and dQ). Then the user's entry point in subprocesses: ``python -m
   repro_torch.launch.train --arch tinyllama-1.1b --steps 20
   --ckpt-every 10`` and ``--resume --steps 10``, their printed lines
   checked. The backward's checks cover MLA's (96, 64) and (192, 128)
   instances (float32 and bf16, causal and not, ragged S, Sk > Sq,
   strided GQA heads) and bf16 at qwen3's, minicpm3's, moonshot's and
   deepseek-v2's training shapes (two launches bit-identical). Then
   ``phase_lm_train_arch`` runs the train_4k step at ``qwen3-1.7b``,
   ``minicpm3-4b``, ``moonshot-v1-16b-a3b`` and ``deepseek-v2-236b``:
   full width, S = 4,096, the global batch cut to ``grad_accum`` (2, 4,
   4 and 8, one sequence a microbatch), ``NEW_TRAIN_STEPS`` steps, the
   depth cut only where the
   step's estimated peak would not fit ``MEM_FRAC`` of the card
   (logged beside the measured peak): flash forward launches ``2 L
   accum`` a step, backward ``L accum``, none of them on the main
   thread; losses finite, the first within 1.5 of ln V; every layer's
   attention parameters get gradients (and every MoE layer's router,
   experts and shared experts); the first step's routing logged as in
   serving; step time (events), tokens/s, peak memory, bound; a profiled
   step. moonshot trains 3 of 48 layers, deepseek-v2 1 (its dense layer
   at full width: one MoE layer alone would need ~111 GB).
   Then the GNN zoo and FM (``phase_gnn_archs``, ``phase_fm``): the
   reference's cells (``repro_torch.launch.cell``: ``build_gnn_cell``,
   ``build_fm_cell``) at each arch's ``make_config()``, parameters and
   inputs drawn from the seed. PNA (d 75, 4 layers) and GatedGCN (70,
   16) at ``full_graph_sm`` (2,708 nodes, 10,752 padded edges, 1,433
   features) and ``minibatch_lg`` (180,224 nodes, 179,200 edges, 602
   features); NequIP (mul 32, 5 layers) and MACE (mul 128, 2 layers,
   correlation 3) at ``molecule`` (3,840 atoms, 8,192 edges) and
   ``full_graph_sm``; the other crosses but ``ogb_products`` where
   ``gnn_peak_estimate`` fits ``MEM_FRAC`` of the card and the CPU side
   of its check, scaled from the arch's largest run cell, fits
   ``CPU_CHECK_MAX_S`` (each estimate logged, and beside each run cell's
   measured peak; ``scripts/gnn_cells.py`` runs the crosses that fit the
   card but not that); ``ogb_products`` only estimated. Each arch's
   ``full_graph_sm`` cell (the others are ``GNN_CPU_UNCHECKED``, held by
   ``scripts/gnn_cells.py``): the first loss and gradients on the card
   against the same step on the CPU (``TOL_CELL_LOSS``, each gradient
   leaf's relative L2 and max share, ``TOL_CELL_GRAD``; PNA at
   ``TOL_CELL_GRAD_PNA`` and in float64 too, ``TOL_CELL_F64``),
   ``CELL_STEPS`` AdamW steps on the one batch that must lower the
   loss (median step by events, host wall, peak memory), one profiled
   step (device busy by group: gather, scatter, products, elementwise;
   idle share). At ``molecule``, NequIP's and MACE's energies invariant
   under a random rotation and a translation (``TOL_INVARIANT``), and
   NequIP's aggregation in 4 edge chunks equal to the unchunked one
   (``TOL_CHUNKED``). FM at 33,775,616 rows: the train step (card
   against CPU, then ``CELL_STEPS`` steps), the serve steps at batch
   512 and 262,144 and the retrieval of 1,000,000 candidates (card
   against CPU, ``TOL_FM``; retrieval also against ``scores`` over
   (query ‖ candidate) rows), each timed and profiled. No hand-written
   kernel is on these paths: every launch count must stay unchanged.
   Then the dry-run (``phase_dryrun``): ``repro_torch.launch.dryrun``'s
   record (``launch.count``: FLOPs by dtype, bytes, the live-bytes peak,
   the roofline terms at the card's peaks, per-device argument bytes
   under both production rule sets) of each GNN and FM cell above and
   the four ``greendygnn-sage`` cells, at full config on the ``meta``
   device (the LM archs' reference cells, minutes on meta: ``python -m
   repro_torch.launch.dryrun --all``);
   then ``greendygnn-sage`` on the card at each shape whose counted peak
   fits ``MEM_FRAC`` of the card and whose CPU check fits
   ``CPU_CHECK_MAX_S``, as ``run_gnn_cell`` runs the zoo (the rest in
   ``scripts/gnn_cells.py``). Every cell the card runs (the GNN and FM
   cells, the sage cells, each LM arch's prefill, a decode step and its
   ``train_4k`` step) runs one more, untimed step under the counter
   (``hold_count``): its FLOPs and bytes must equal the count of the same
   step on ``meta`` tensors of the same shapes, and its kernel charges
   the launches ``_build.count_launch`` counted; the counted peak is
   logged beside ``max_memory_allocated`` and the phase's estimate, and
   the roofline bound beside the measured step time.
7. Time each kernel, its plain version and the equivalent library call
   with CUDA events (median of 25 launches, L2 flushed before each and
   each queued behind a spin kernel so the host's enqueue time is not
   counted), beside the least time the card could take, and print one
   ``{"kernels": ...}`` line. A second SpMM row,
   ``csr_spmm_f1433``, times full_graph_sm's layer 0 (F = 1,433) with its
   bound from the entries, the X rows they reference and Y, and the
   scalar instance's time on the same rows contiguous (``scalar_ms``). The EmbeddingBag
   row, at the path's shape, also carries the kernel's own device time
   from ``torch.profiler`` (``kernel_ms``: L2 flushed before each call;
   ``kernel_warm_ms``: back to back), read right after the build
   (``phase_bag_profile``: later the profiler drops the gather from its
   traces) and null where no trace of three held the kernel for every
   call, and the event time at the padded shape (``padded_ms``). A second EmbeddingBag row,
   ``embedding_bag_persisted``, times the persisted-row gather at the
   threaded run's median rebuild. The ``queue_window`` row times the
   queue env's window kernel at 32 envs and W = 128 (every step live)
   against its plain version, with its launches in the queue training;
   the ``cluster_window`` row likewise at 32 envs (every archetype and
   live-peer count), P = 3 and W = 128, with its launches in the cluster
   training. The ``flash_attention_bwd`` row times the backward kernels
   at the training shape against their plain version, the backward of
   ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
   (the yardstick, timed in turns with the kernels) and the bound of the
   gradient's five products over the causal half, with its launches in
   the training run. The rows ``flash_attention_<arch>`` (qwen3,
   minicpm3, moonshot, deepseek) time the forward at those archs'
   prefill shapes (launches: a prefill's), ``flash_attention_bwd_<arch>``
   the backward at their training shapes (launches: the training run's),
   SDPA's beside each. The ``step_gate`` row (``csrc/step_gate.cu``,
   which holds the stream while the trainer's measured step is enqueued,
   so its CUDA events time device work only) times an open gate against
   its plain version, with its launches on the main path (one a measured
   step); ``phase_step_gate`` checks it first: an open gate delivers its
   token, a closed one times out, and a gated event pair around two
   short kernels and a 50 ms host stall times the kernels, not the stall.
   TF32 is off throughout: float32 results are compared in full float32.
   Every bound is read from ``repro_torch.launch.roofline``'s peaks for
   the card's name (a card missing from its table fails the run).
8. Each phase's wall time is logged on a line of its own (``phase
   NAME: S s``), and all of them, longest first, before the end.
9. The last line is ``{"ok": true, "device": {...}}``.

Kernel builds land in ``build/kernels/`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL_SPMM = dict(atol=1e-4, rtol=1e-5)
TOL_BAGS = dict(atol=1e-5, rtol=0.0)
TOL_F32 = dict(atol=2e-5, rtol=1e-4)     # the reference's flash tolerances
TOL_BF16 = dict(atol=4e-2, rtol=2e-2)     # bf16 kernel vs float32 oracle
TOL_BF16_PLAIN = dict(atol=1e-3, rtol=1e-2)  # bf16 kernel vs bf16 plain
# logits of the random-weight bf16 model (scale ~1-6) after 22-62 layers,
# one path against another (flash against dense attention; decode steps
# against a prefill, MLA's absorbed decode against its expanded prefill;
# at the MoE archs the second path replays the first's routing): bf16
# rounding at different places, one bf16 ulp at 4-8 is 0.031
TOL_LOGITS = 0.25
PREFILL_B, PREFILL_S = 2, 4096          # the LM archs' prefill shape here
# the later LM slices' archs, at full width: (Hq, Hkv, D of q and k, D_v)
# of their attention, qwen3's GQA at D = 128 and minicpm3's MLA, whose
# prefill and training expand the latent to 40 heads of q/k dim
# d_nope + d_rope = 96 and v dim d_v = 64
PREFILL_HEADS = {"qwen3-1.7b": (16, 8, 128, 128),
                 "minicpm3-4b": (40, 40, 96, 64),
                 "moonshot-v1-16b-a3b": (16, 16, 128, 128),
                 "deepseek-v2-236b": (128, 128, 192, 128)}
NEW_LM_ARCHS = tuple(PREFILL_HEADS)
# MLA's q/k head dims and their v head dims (minicpm3, deepseek-v2)
MLA_DV = {96: 64, 192: 128}
# an MoE layer's expert stacks, (E, D, F) and (E, F, D)
EXPERT_STACKS = ("w_gate", "w_up", "w_down")
# their train_4k steps: the global batch cut to grad_accum (one sequence a
# microbatch), NEW_TRAIN_STEPS steps; depth cut only where the card's
# memory forces it: to the most layers whose estimated peak
# (train_peak_estimate) fits in MEM_FRAC of the card. minicpm3's 4.26B
# parameters would need ~135 GB. Serving cuts depth by the same rule
# (serve_peak_estimate: deepseek-v2's 236B parameters do not fit)
NEW_TRAIN_STEPS = 3
MEM_FRAC = 0.85
# the policy phase: card against CPU within float32 reassociation and
# last-bit pow/sin differences; training on 32 envs, a few thousand
# iterations an env (2,000 since the counter's holds were added, for the
# script's time: at 4,000 a slow host took 1,231 s of its 1,200); a
# same-seed pair of short runs; two profiled runs
TOL_POLICY = dict(rtol=1e-5, atol=1e-6)
POLICY_ENVS = 32
POLICY_ITERS = 1500
# the queue env's policy learns later: at 1,500 iterations its held-out
# return was the fresh qnet's (-105.5 against -106.1), at 2,000 -19.8
QUEUE_ITERS = 2000
POLICY_SHORT = 100
POLICY_PROFILED = (5, 15)
POLICY_HELD_OUT = 4
ENV_CHECK_STEPS = 6       # the queue and cluster envs' card-vs-CPU steps
REPEATS = 25
# the MoE archs' paths: on a model of MOE_CMP_LAYERS layers (1 dense + 3
# MoE) drawn on its own, decode against prefill and flash against dense
# at TOL_LOGITS; at the served depth, decode against prefill (the routing
# replayed) at TOL_MOE_DEEP. The reference's expert stacks draw at
# 1/sqrt(E) (ROADMAP queue 3 item 5), so each MoE layer adds a large
# output to the residual stream, and two paths' bf16 roundings grow apart
# with depth (scripts/moe_depth_gap.py, H100: moonshot's decode against
# prefill 0.082 / 0.125 / 0.211 / 0.422 max|diff|, row rel L2 0.017 /
# 0.028 / 0.047 / 0.092 at 4 / 8 / 16 / 48 layers; deepseek-v2's 0.137,
# 0.030 at 9), where the same paths in float32 agree within 5e-5 at 12
# layers with no routing flip. TOL_MOE_DEEP is ~1.8x and ~2.2x moonshot's
# 48-layer reading; a fault moves the logits by their whole scale (max
# ~5, row rel L2 ~1)
MOE_CMP_LAYERS = 4
TOL_MOE_DEEP = dict(max_abs=0.75, rel_l2=0.2)
# serve.run in the serving phase: batch 4, SERVE_PROMPT prompt steps, then
# SERVE_GEN greedy tokens
SERVE_PROMPT, SERVE_GEN = 8, 16
# a spin of about 0.5 ms on the device before each timed call, long enough
# for the host to enqueue the events and the call behind it
SPIN_CYCLES = 1_000_000
SEED = 0

MAIN_PATH = dict(
    method="greendygnn", compute="measured", scenario=None,
    async_pipeline=False, trace=False, batch_size=2000, n_epochs=3,
    warmup_epochs=2, steps_per_epoch=8, seed=SEED,
)

# the other trainer paths, each through gnn_trainer.run with the measured
# lane and device payloads: full_graph_sm (d_in 1,433) for a few steps,
# the congestion runs (the reddit stand-in at MAIN_PATH's widths and batch
# under each method and scenario), ooc_community under a host budget
FULL_GRAPH = dict(method="static_w", dataset="full_graph_sm",
                  compute="measured", batch_size=2000, n_epochs=2,
                  warmup_epochs=1, steps_per_epoch=3, seed=SEED)
# (5 epochs: the paper schedule congests from epoch 3 on)
CONGESTION = dict(MAIN_PATH, n_epochs=5, warmup_epochs=1, steps_per_epoch=4,
                  static_window=2)
# the threaded pipeline at MAIN_PATH's widths and batch: static_w, W = 4
# (W = 7 too, so that windows straddle epochs)
PIPELINE = dict(MAIN_PATH, method="static_w", static_window=4)
PIPELINE_FEAT = 64                      # the reddit stand-in's features
# the cluster phase: the main path's trainer (the reddit stand-in, batch
# 2000, fanouts (10, 25), measured compute, device payloads, 3 epochs of 8
# steps) at P = 4, so every partition trains; the reference's pinned P = 4
# modeled run (tests/test_compute.py::_PIN_CFG) and its report digest
CLUSTER = dict(MAIN_PATH, method="static_w")
CLUSTER_P = 4
CLUSTER_PIN = dict(method="static_w", dataset="reddit", batch_size=600,
                   n_epochs=2, steps_per_epoch=8, scenario="clean", seed=0)
CLUSTER_PIN_DIGEST = ("41d1a2d4d2a3e26dac2bfcd3618cab19"
                      "fa12ffb53b1db759670fece305fbce28")
CLUSTER_PROFILE_STEP = 4                # the profiled window's first step
RUN_MODEL = dict(CLUSTER_PIN, steps_per_epoch=4, compute="modeled",
                 run_model=True)
# card against CPU: fp32 sums in another order (the SpMM, atomics in the
# scatter path), compounded over the AdamW steps
TOL_CLUSTER_LOSS = dict(rtol=1e-4, atol=0.0)
# the LM training phase: the train_4k cell's step (S = 4,096, grad_accum
# 2) at TinyLlama's full width, its global batch of 256 cut to 2 (two
# microbatches of 1); 6 steps, a checkpoint after the third
TRAIN_S, TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_AT = 4096, 2, 6, 3
# the backward kernel against its plain version: float32 in another
# summation order; bf16 outputs one rounding apart (rtol), atol 1e-3 of the
# tensor's largest |plain| for the float32 sums' reassociation near zero
TOL_BWD_F32 = dict(atol=2e-5, rtol=1e-4)
TOL_BWD_BF16_RTOL, TOL_BWD_BF16_ATOL_FRAC = 1e-2, 1e-3
# the forward's lse against the plain forward's: the same scores summed in
# another order (l over up to 4,096 keys) and, for bf16, exp as ex2.approx
TOL_LSE = dict(atol=1e-4, rtol=1e-5)
# a resumed run against the uninterrupted one: losses (the embedding's
# backward may accumulate in another order)
TOL_RESUME = dict(rtol=1e-3, atol=0.0)
BUDGETED = dict(method="static_w", dataset="ooc_community",
                compute="measured", scenario="clean", batch_size=2000,
                n_epochs=2, warmup_epochs=1, steps_per_epoch=4,
                static_window=2, seed=SEED)


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_S = {}     # phase -> wall seconds, for the end's summary


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall time logged on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f} s")
    return out


# ----------------------------------------------------------------- timing
class Timer:
    """Median CUDA-event time of a callable, L2 flushed before each run.

    Each run is queued behind a spin kernel, so the device reaches the
    start event only after the host has enqueued the call and the end
    event: the events time the device's work, not the host's enqueue
    (which for a kernel of a few microseconds is the larger)."""

    def __init__(self, torch, device):
        self.torch = torch
        # larger than the 50 MB L2, rewritten before every timed launch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self._setup_names = None   # the flush's and the spin's kernels

    def ms(self, fn, repeats: int = REPEATS, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        samples = []
        for _ in range(repeats):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    def kernel_ms(self, fn, pattern: str, repeats: int = REPEATS,
                  warm_calls: int = 50, tries: int = 3):
        """The device time of ``fn``'s own kernels from ``torch.profiler``
        (no launch latency, no event cost): (flushed, warm). Flushed: the
        L2 zeroed and a spin queued before each of ``repeats`` calls, the
        flush's and the spin's kernels left out. Warm: ``warm_calls``
        calls back to back, their inputs in L2. The profiler here has
        dropped kernels from a trace (``scripts/profiler_drops.py``), so
        a reading counts only if its trace holds a kernel whose name
        matches ``pattern`` (``fn``'s own) for every call; it is taken
        again, up to ``tries`` times, and is None if no trace held them."""
        import re

        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if self._setup_names is None:
            with profile(activities=acts) as prof:
                for _ in range(3):
                    self.flush.zero_()
                    torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
            self._setup_names = set(device_time_by_name(prof))

        def setup():
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)

        def reading(calls, before_each):
            for _ in range(tries):
                with profile(activities=acts) as prof:
                    for _ in range(calls):
                        before_each()
                        fn()
                    torch.cuda.synchronize()
                by_name = device_time_by_name(prof)
                own = sum(cnt for name, (_, cnt) in by_name.items()
                          if re.search(pattern, name))
                if own >= calls:
                    return sum(us for name, (us, _) in by_name.items()
                               if name not in self._setup_names) / 1e3 / calls
                log(f"profiler: {own} of {calls} {pattern} kernels in the "
                    "trace; taking it again")
            return None

        for _ in range(3):
            fn()
        return reading(repeats, setup), reading(warm_calls, lambda: None)


def fmt_ms(ms) -> str:
    """A profiler reading for the log: None where no trace held it."""
    return "not in the trace" if ms is None else f"{ms:.4f} ms"


def bound_ms(n_bytes: float, n_flops: float,
             dtype: str = "fp32") -> tuple[float, str]:
    """The least time the card could take: the bytes over its HBM rate or
    the operations over its peak for ``dtype``, whichever is larger, at
    the peaks ``repro_torch.launch.roofline`` holds for the card's name
    (published dense rates at the full power limit)."""
    import torch

    from repro_torch.launch import roofline

    peaks = roofline.device_peaks(torch.device("cuda", 0))
    t_ops, t_bytes = (t * 1e3 for t in peaks.terms(n_flops, n_bytes, dtype))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bag_bytes(torch, fmt, d: int) -> int:
    """The bytes a sum-mode bag function over ``fmt`` must move at width
    ``d``: each distinct table row a lookup of non-zero weight reads,
    once; each bag's row, written once; the int32 indices; the weights,
    unless all are 1; the offsets, unless every bag holds exactly one
    lookup (bag b is then lookup b)."""
    n_look = fmt.idx.numel()
    read = torch.unique(fmt.idx[fmt.w != 0]).numel()
    n_bytes = (read + fmt.n_bags) * d * 4 + n_look * 4
    if not bool((fmt.w == 1).all()):
        n_bytes += n_look * 4
    if not (fmt.n_bags == n_look and fmt.max_len == 1):
        n_bytes += (fmt.n_bags + 1) * 4
    return n_bytes


# ------------------------------------------------------------- phase 1
def phase_card_and_build(torch):
    smi = smi_line()
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for stem, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{stem}]: {line.strip()}")
    check_wgmma_build(_build.build_log("flash_attention") or "")
    check_csr_build(_build.build_log("csr_spmm") or "")
    check_bag_build(_build.build_log("embedding_bag") or "")
    check_window_build(_build.build_log("queue_window") or "",
                       "queue_window")
    check_window_build(_build.build_log("cluster_window") or "",
                       "cluster_window")
    check_bwd_build(_build.build_log("flash_attention_bwd") or "")
    return smi


def ptxas_functions(text: str) -> dict:
    """{function: {"registers": n, "spill_stores": n, "spill_loads": n}}
    from nvcc's ``-Xptxas -v`` report."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        hit = (re.search(r"Compiling entry function '([^']+)'", line)
               or re.search(r"Function properties for (\S+)", line))
        if hit:
            cur = funcs.setdefault(hit.group(1), {})
            continue
        if cur is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            cur["spill_stores"], cur["spill_loads"] = map(int, hit.groups())
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            cur["registers"] = int(hit.group(1))
        hit = re.search(r"(\d+) bytes smem", line)
        if hit:
            cur["smem"] = int(hit.group(1))
    return funcs


def check_wgmma_build(text: str) -> None:
    """The bf16 flash kernel's ptxas report: one instance per compiled
    (D, D_v) pair, (96, 64) MLA's among them, no spills, and no wgmma that
    ptxas had to serialize (which it reports when it cannot keep the
    asynchronous products in flight)."""
    import re

    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

    serialized = [ln.strip() for ln in text.splitlines()
                  if "wgmma.mma_async instructions are serialized" in ln]
    for ln in serialized:
        log(f"  ptxas[flash_attention] {ln}")
    require(not serialized, "ptxas serialized the flash kernel's wgmma")
    found = {}
    for name, info in ptxas_functions(text).items():
        if "flash_fwd_wgmma_kernel" in name:
            pair = re.search(r"ILi(\d+)ELi(\d+)E", name).groups()
            found[tuple(map(int, pair))] = info
    require(sorted(found) == sorted(HEAD_DIMS),
            f"ptxas report lists wgmma flash instances for (D, D_v) in "
            f"{sorted(found)}, not {sorted(HEAD_DIMS)} (is the build log "
            "missing?)")
    for (d, dv), info in sorted(found.items()):
        log(f"  ptxas[flash_attention] flash_fwd_wgmma_kernel<{d}, {dv}>: "
            f"{info.get('registers')} registers, {info.get('spill_stores')} "
            f"bytes spill stores, {info.get('spill_loads')} bytes spill loads")
        require(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                f"flash_fwd_wgmma_kernel<{d}, {dv}> spills")


def check_csr_build(text: str) -> None:
    """The CSR SpMM's ptxas report: one instance per group width G (1 to
    32 lanes) and lane width V (4: float4, 1: scalar), none spilling its
    batch registers."""
    import re

    found = {}
    for name, info in ptxas_functions(text).items():
        hit = re.search(r"csr_spmm_kernelILi(\d+)ELi(\d+)E", name)
        if hit:
            found[tuple(map(int, hit.groups()))] = info
    want = [(g, v) for g in (1, 2, 4, 8, 16, 32) for v in (1, 4)]
    require(sorted(found) == want,
            f"ptxas report lists csr_spmm_kernel instances (G, V) = "
            f"{sorted(found)}, not G = 1 to 32 by V = 1, 4 (is the build "
            "log missing?)")
    for (g, v), info in sorted(found.items()):
        log(f"  ptxas[csr_spmm] csr_spmm_kernel<{g}, {v}>: "
            f"{info.get('registers')} registers, {info.get('spill_stores')} "
            f"bytes spill stores, {info.get('spill_loads')} bytes spill loads")
        require(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                f"csr_spmm_kernel<{g}, {v}> spills")


def check_window_build(text: str, stem: str) -> None:
    """An env window kernel's ptxas report (``queue_window`` or
    ``cluster_window``, both fluid_window.cuh's code, a block per env):
    one instance per exact owner count 1 to 4 and per owner bound 8 and
    16, each logged with its registers, spills, static shared memory and
    the dynamic shared memory a block takes at its owner count; the
    path's (P = 3) must not spill."""
    import re

    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.kernels.queue_window import ops as qw

    smem = {"queue_window": qw.smem_bytes,
            "cluster_window": cw.smem_bytes}[stem]
    found = {}
    for name, info in ptxas_functions(text).items():
        hit = re.search(rf"{stem}_kernelILi(\d+)E", name)
        if hit:
            found[int(hit.group(1))] = info
    require(sorted(found) == [1, 2, 3, 4, 8, 16],
            f"ptxas report lists {stem}_kernel instances "
            f"{sorted(found)}, not 1, 2, 3, 4, 8 and 16 (is the build log "
            "missing?)")
    for p, info in sorted(found.items()):
        log(f"  ptxas[{stem}] {stem}_kernel<{p}>: "
            f"{info.get('registers')} registers, {info.get('spill_stores')} "
            f"bytes spill stores, {info.get('spill_loads')} bytes spill "
            f"loads, {info.get('smem', 0)} bytes static shared memory; "
            f"{smem(p)} bytes dynamic shared memory a block at P = {p}")
    require(found[3].get("spill_stores") == 0
            and found[3].get("spill_loads") == 0,
            f"{stem}_kernel<3> spills")


def check_bag_build(text: str) -> None:
    """The EmbeddingBag kernel's ptxas report: one instance per group
    width G (1 to 32), row load (V = 4 float4, V = 1 scalar) and rows in
    flight (U = 1 for exactly one lookup a bag, 8 for any other bags),
    none spilling, the U = 1 ones in 32 registers (64 warps an SM)."""
    import re

    found = {}
    for name, info in ptxas_functions(text).items():
        hit = re.search(r"embedding_bag_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                        name)
        if hit:
            found[tuple(map(int, hit.groups()))] = info
    want = [(g, v, u) for g in (1, 2, 4, 8, 16, 32) for v in (1, 4)
            for u in (1, 8)]
    require(sorted(found) == sorted(want),
            f"ptxas report lists embedding_bag_kernel instances "
            f"{sorted(found)}, not G = 1 to 32 by V = 1, 4 by U = 1, 8")
    for (g, v, u), info in sorted(found.items()):
        log(f"  ptxas[embedding_bag] embedding_bag_kernel<{g}, {v}, {u}>: "
            f"{info.get('registers')} registers, {info.get('spill_stores')} "
            f"bytes spill stores, {info.get('spill_loads')} bytes spill loads")
        require(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                f"embedding_bag_kernel<{g}, {v}, {u}> spills")
        require(u != 1 or info.get("registers", 99) <= 32,
                f"embedding_bag_kernel<{g}, {v}, {u}> uses "
                f"{info.get('registers')} registers, more than 32")


def bag_instances(torch, fn) -> list:
    """The (G, V, U) of every EmbeddingBag kernel ``fn`` launches, from
    the kernel names ``torch.profiler`` reports."""
    from repro_torch.kernels.embedding_bag import embedding_bag

    return kernel_instances(
        torch, fn, r"embedding_bag_kernel<(\d+),\s*(\d+),\s*(\d+)>",
        embedding_bag)


# ------------------------------------------------------------- phase 2
def main_path_operands(torch, device):
    """The kernels' operands as the main path's first step builds them."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import compute, gnn_trainer as gt

    cfg = gt.RunConfig(**MAIN_PATH, mem_budget=MemoryBudget(),
                       device=str(device))
    cfg.n_epochs = 1
    cfg.steps_per_epoch = 1
    graph, _owner, _traces, mbs = gt.build_trace(cfg)
    eng = compute.ComputeEngine(graph, cfg)
    mb = mbs[0][0]
    layers, x_rows, n_edges = eng.prepare(mb)
    gen = torch.Generator().manual_seed(SEED)
    x0 = eng.pad_input(graph.features[mb.input_nodes], x_rows)
    h1 = torch.randn((layers[0]["fwd"].n_rows, 16), generator=gen).to(device)
    dy1 = torch.randn((layers[1]["fwd"].n_rows, 16), generator=gen).to(device)
    n_feat = graph.features.shape[1]
    capacity = int(cfg.cache_frac * graph.n_nodes)
    remote = int((_owner[mb.input_nodes] != 0).sum())
    return dict(layers=layers, x0=x0, h1=h1, dy1=dy1,
                n_edges=n_edges, n_feat=n_feat, capacity=capacity,
                n_remote=remote)


def spmm_cases(ops):
    """(label, CSR format, x) for the three SpMM calls of one step."""
    layers, x0, h1, dy1 = ops["layers"], ops["x0"], ops["h1"], ops["dy1"]
    return [
        ("layer0", layers[0]["fwd"], x0),
        ("layer1", layers[1]["fwd"], h1),
        ("layer1^T", layers[1]["bwd"], dy1),
    ]


def phase_kernels_vs_plain(torch, device, ops):
    from repro_torch.kernels.segment_mm import (
        Spmm, csr_spmm, csr_spmm_plain,
    )

    errs = {"csr_spmm": 0.0, "embedding_bag": 0.0}
    for label, fmt, x in spmm_cases(ops):
        got = csr_spmm(fmt, x)
        again = csr_spmm(fmt, x)
        torch.cuda.synchronize()
        want = csr_spmm_plain(fmt.rowptr, fmt.col, fmt.val, x)
        err = float((got - want).abs().max())
        errs["csr_spmm"] = max(errs["csr_spmm"], err)
        log(f"csr_spmm {label}: nnz={fmt.col.shape[0]} x={tuple(x.shape)} "
            f"y={tuple(got.shape)} max|kernel-plain|={err:.3e}, "
            f"bit-identical relaunch: {torch.equal(got, again)}")
        require(torch.allclose(got, want, **TOL_SPMM),
                f"csr_spmm {label}: kernel vs plain max |diff| {err:.3e}")
        require(torch.equal(got, again),
                f"csr_spmm {label}: two launches differ")

    # autograd: dX = A^T dY through the kernel vs plain autograd
    lay = ops["layers"][1]
    h = ops["h1"].clone().requires_grad_(True)
    y = Spmm.apply(h, lay["fwd"], lay["bwd"])
    (dx_k,) = torch.autograd.grad(y, h, grad_outputs=ops["dy1"])
    h_p = ops["h1"].clone().requires_grad_(True)
    f = lay["fwd"]
    y_p = csr_spmm_plain(f.rowptr, f.col, f.val, h_p)
    (dx_p,) = torch.autograd.grad(y_p, h_p, grad_outputs=ops["dy1"])
    err = float((dx_k - dx_p).abs().max())
    errs["csr_spmm"] = max(errs["csr_spmm"], err)
    require(torch.allclose(dx_k, dx_p, **TOL_SPMM),
            f"Spmm backward vs plain autograd: {err:.3e}")
    log(f"Spmm backward: max|kernel-plain autograd|={err:.3e}")

    errs["embedding_bag"] = phase_bags_vs_plain(torch, device, ops)
    return errs


def phase_bags_vs_plain(torch, device, ops):
    """The EmbeddingBag kernel against ``table[idx]`` and its plain
    version; keeps the gather's operands in ``ops`` for the timing phase
    and returns the largest weighted-bag difference."""
    import numpy as np

    from repro_torch.kernels.embedding_bag import (
        BagFormat, bag_plain, bag_sum, embedding_bag, embedding_bag_plain,
    )

    def fmt_of(idx, seg, n_bags, w=None):
        return BagFormat.from_numpy(
            idx.cpu().numpy(), seg.cpu().numpy(), n_bags,
            None if w is None else w.cpu().numpy(), device)

    # the device tier's gather. Padded, as it ran until the port dropped
    # the pad: L = 8192, one lookup per bag, unit weights, pad bags weight
    # 0, through the tensor wrapper; bit-equal to table[idx]
    gen = torch.Generator().manual_seed(SEED + 1)
    table = torch.randn((ops["capacity"], ops["n_feat"]),
                        generator=gen).to(device)
    n = min(ops["n_remote"], 8192)
    L = 1 << (n - 1).bit_length()
    idx = torch.randint(0, ops["capacity"], (L,), generator=gen,
                        dtype=torch.int32).to(device)
    w = torch.zeros(L, device=device)
    w[:n] = 1.0
    seg = torch.arange(L, dtype=torch.int32, device=device)
    got = embedding_bag(table, idx, seg, L, w)
    torch.cuda.synchronize()
    want_rows = table[idx[:n].long()]
    require(torch.equal(got[:n], want_rows),
            "embedding_bag gather is not bit-equal to table[idx]")
    require(bool((got[n:] == 0).all()), "embedding_bag pad bags not zero")
    want = embedding_bag_plain(table, idx, seg, w, L)
    require(torch.equal(got, want), "embedding_bag gather: kernel != plain")
    # the path's own shape: n bags of one unit-weight lookup, built in
    # numpy and moved in one copy, as DevicePayloadTier.gather builds it
    path = fmt_of(idx[:n], seg[:n], n)
    got = bag_sum(path, table)
    again = bag_sum(path, table)
    torch.cuda.synchronize()
    require(torch.equal(got, want_rows),
            "embedding_bag unpadded gather is not bit-equal to table[idx]")
    require(torch.equal(got, again), "embedding_bag gather: relaunch differs")
    inst = bag_instances(torch, lambda: bag_sum(path, table))
    require(inst == [(16, 4, 1)],
            f"embedding_bag gather ran instances {inst}, not (16, 4, 1)")
    # one lookup or none a bag: the general instance, same rows
    spare = fmt_of(idx[:n], seg[:n], n + 100)
    got = bag_sum(spare, table)
    torch.cuda.synchronize()
    require(torch.equal(got[:n], want_rows) and not bool(got[n:].any()),
            "embedding_bag gather with 100 empty bags: rows differ")
    inst += bag_instances(torch, lambda: bag_sum(spare, table))
    require(inst == [(16, 4, 1), (16, 4, 8)],
            f"embedding_bag gathers ran instances {inst}, not (16, 4, 1) "
            "and, with empty bags, (16, 4, 8)")
    log(f"embedding_bag gather: L={L} (padded) and {n} bags (unpadded), "
        f"table={tuple(table.shape)}: bit-equal to table[idx], relaunch "
        f"bit-identical, instance (G, V, U) {inst[0]}; with 100 empty "
        f"bags too {inst[1]}")
    ops["bags"] = dict(table=table, padded=fmt_of(idx, seg, L, w),
                       path=path)

    # weighted bags, random order, 512 bags empty: the tensor wrapper and
    # the numpy format give the same operands, so the same bits
    err = 0.0
    n_bags = 4096
    seg_r = torch.randint(0, n_bags - 512, (L,), generator=gen,
                          dtype=torch.int32).to(device)
    w_r = torch.randn(L, generator=gen).to(device)
    got = embedding_bag(table, idx, seg_r, n_bags, w_r)
    fmt = fmt_of(idx, seg_r, n_bags, w_r)
    got_f, again = bag_sum(fmt, table), bag_sum(fmt, table)
    torch.cuda.synchronize()
    want = bag_plain(fmt, table)
    err = max(err, float((got - want).abs().max()))
    require(torch.allclose(got, want, **TOL_BAGS),
            f"embedding_bag weighted bags: {err:.3e}")
    require(bool((got[n_bags - 512:] == 0).all()), "empty bags not zero")
    require(torch.equal(got, got_f) and torch.equal(got_f, again),
            "embedding_bag weighted: wrapper, format and relaunch differ")
    inst = bag_instances(torch, lambda: bag_sum(fmt, table))
    require(inst == [(16, 4, 8)],
            f"embedding_bag weighted ran instances {inst}, not (16, 4, 8)")
    log(f"embedding_bag weighted: {n_bags} bags, 512 empty, longest "
        f"{fmt.max_len}, max|kernel-plain|={err:.3e}, relaunch "
        f"bit-identical, instance (G, V, U) {inst}")

    # the scalar instance: reddit's 602 features (D % 4 != 0), and a
    # 64-wide table one float off 16-byte alignment
    wide = torch.randn((ops["capacity"], 602), generator=gen).to(device)
    flat = torch.randn(ops["capacity"] * ops["n_feat"] + 1,
                       generator=gen).to(device)
    skew = flat[1:].view(ops["capacity"], ops["n_feat"])
    for label, tab in (("D=602", wide), ("unaligned", skew)):
        got = bag_sum(path, tab)
        got_w = bag_sum(fmt, tab)
        torch.cuda.synchronize()
        require(torch.equal(got, tab[idx[:n].long()]),
                f"embedding_bag {label}: gather not bit-equal to table[idx]")
        want = bag_plain(fmt, tab)
        e = float((got_w - want).abs().max())
        err = max(err, e)
        require(torch.allclose(got_w, want, **TOL_BAGS),
                f"embedding_bag {label} weighted: {e:.3e}")
        inst = (bag_instances(torch, lambda: bag_sum(path, tab))
                + bag_instances(torch, lambda: bag_sum(fmt, tab)))
        require(inst == [(32, 1, 1), (32, 1, 8)],
                f"embedding_bag {label}: ran {inst}, not the scalar "
                "instances (32, 1, 1) and (32, 1, 8)")
        log(f"embedding_bag {label} table={tuple(tab.shape)}: gather "
            f"bit-equal, weighted max|kernel-plain|={e:.3e}, instances "
            f"(G, V, U) {inst}")
    return err


def phase_bag_profile(torch, device, ops):
    """The EmbeddingBag kernel's and ``F.embedding_bag``'s own device time
    from ``torch.profiler`` (``Timer.kernel_ms``: L2 flushed before each
    call, and back to back) at the padded and the path's shapes, and the
    kernel's floor on one empty bag, into ``ops["bag_profile"]``. Read
    here, before the policy phases' tens of millions of launches: later
    in the process the profiler drops the gather from its traces."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag_ops

    timer = Timer(torch, device)
    bags = ops["bags"]
    table = bags["table"]
    own, lib_pat = r"embedding_bag_kernel<", r"(?i)embeddingbag|embedding_bag"
    readings = {}
    for label in ("padded", "path"):
        fmt = bags[label]
        out = torch.empty((fmt.n_bags, table.shape[1]), device=device)
        kernel = timer.kernel_ms(lambda: bag_ops.bag_launch(fmt, table, out),
                                 own)
        lib = timer.kernel_ms(lambda: F.embedding_bag(
            fmt.idx, table, fmt.offsets[:-1], mode="sum",
            per_sample_weights=fmt.w, include_last_offset=False), lib_pat)
        readings[label] = {"kernel": kernel, "library": lib}
        log(f"profile embedding_bag {label} L={fmt.idx.numel()} "
            f"bags={fmt.n_bags}: kernel {fmt_ms(kernel[0])} flushed / "
            f"{fmt_ms(kernel[1])} warm; F.embedding_bag {fmt_ms(lib[0])} / "
            f"{fmt_ms(lib[1])}")
    empty = bag_ops.BagFormat.from_numpy([], [], 1, None, device)
    one = torch.zeros((1, table.shape[1]), device=device)
    out = torch.empty_like(one)
    floor = timer.kernel_ms(lambda: bag_ops.bag_launch(empty, one, out), own)
    log(f"profile embedding_bag floor (one empty bag): {fmt_ms(floor[0])} "
        f"flushed / {fmt_ms(floor[1])} warm")
    ops["bag_profile"] = readings


def phase_flash_vs_plain(torch, device):
    """The flash-attention kernel against its plain version and the dense
    oracle; returns the largest kernel-vs-plain difference and the
    prefill-shape operands of each LM arch ({arch: (q, k, v)}) for the
    timing phase."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_kernel, flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import (
        HEAD_DIMS, TILE_K, TILE_Q,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.lm.attention import dense_attention

    gen = torch.Generator().manual_seed(SEED + 2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    err = 0.0
    # tests/test_kernels.py's matrix, its block sweep's shape, and ragged
    # lengths the float32 kernel's 64-row tiles do not divide (block = S)
    for s, d, causal, blk in [(128, 64, True, 64), (256, 64, True, 64),
                              (128, 128, False, 64), (512, 32, True, 64),
                              (256, 32, True, 32), (100, 64, True, 100),
                              (100, 128, False, 100), (200, 32, True, 200)]:
        q, k, v = randn(3, s, d), randn(3, s, d), randn(3, s, d)
        got = flash_attention_kernel(q, k, v, causal, blk, blk)
        want = flash_attention_plain(q[:, :, None], k[:, :, None],
                                     v[:, :, None], causal, blk,
                                     blk)[:, :, 0]
        oracle = attention_ref(q, k, v, causal)
        e = diff(got, want)
        err = max(err, e)
        require(torch.allclose(got, want, **TOL_F32),
                f"flash s={s} d={d} causal={causal}: kernel vs plain {e:.3e}")
        require(torch.allclose(got, oracle, **TOL_F32),
                f"flash s={s} d={d} causal={causal}: kernel vs oracle "
                f"{diff(got, oracle):.3e}")
        log(f"flash f32 s={s} d={d} causal={causal}: max|kernel-plain|="
            f"{e:.3e} max|kernel-oracle|={diff(got, oracle):.3e}")

    # GQA over (B, S, H, D) views with non-packed head strides
    qb, kb = randn(2, 128, 16, 32), randn(2, 128, 4, 32)
    q, k, v = qb[:, :, :8], kb[:, :, :2], kb[:, :, 2:]
    got = flash_attention(q, k, v, True, 64, 64)
    want = flash_attention_plain(q, k, v, True, 64, 64)
    dense = dense_attention(q, k, v, causal=True)
    e = diff(got, want)
    err = max(err, e)
    require(torch.allclose(got, want, **TOL_F32), f"flash GQA: {e:.3e}")
    require(torch.allclose(got, dense, **TOL_F32),
            f"flash GQA vs dense_attention: {diff(got, dense):.3e}")
    log(f"flash GQA (2,128,8,32)/(2,128,2,32), strided heads: "
        f"max|kernel-plain|={e:.3e} max|kernel-dense|={diff(got, dense):.3e}")

    # MLA's instances, q/k head dim 96 and v head dim 64 (minicpm3), 192
    # and 128 (deepseek-v2), float32: causal and not, ragged S, Sk > Sq,
    # GQA over strided heads, against the plain version and
    # dense_attention
    for d, dv in MLA_DV.items():
        qb, kb = randn(1, 192, 8, d), randn(1, 192, 4, d)
        vb = randn(1, 192, 4, dv)
        for label, q, k, v, causal in [
                ("s=256 MHA causal", randn(2, 256, 4, d),
                 randn(2, 256, 4, d), randn(2, 256, 4, dv), True),
                ("s=256 GQA 4/2 full", randn(2, 256, 4, d),
                 randn(2, 256, 2, d), randn(2, 256, 2, dv), False),
                ("s=100 (ragged) causal", randn(1, 100, 4, d),
                 randn(1, 100, 4, d), randn(1, 100, 4, dv), True),
                ("sq=136 sk=200 causal", randn(1, 136, 4, d),
                 randn(1, 200, 2, d), randn(1, 200, 2, dv), True),
                ("strided heads causal", qb[:, :, 2:6], kb[:, :, :2],
                 vb[:, :, 2:], True)]:
            got = flash_attention(q, k, v, causal, q.shape[1], k.shape[1])
            want = flash_attention_plain(q, k, v, causal, q.shape[1],
                                         k.shape[1])
            dense = dense_attention(q, k, v, causal=causal)
            e = diff(got, want)
            err = max(err, e)
            tag = f"flash f32 {d}/{dv} {label}"
            require(tuple(got.shape) == tuple(q.shape[:3]) + (dv,),
                    f"{tag}: shape {tuple(got.shape)}")
            require(torch.allclose(got, want, **TOL_F32),
                    f"{tag}: kernel vs plain {e:.3e}")
            require(torch.allclose(got, dense, **TOL_F32),
                    f"{tag}: kernel vs dense {diff(got, dense):.3e}")
            log(f"flash f32 d={d} dv={dv} {label}: max|kernel-plain|="
                f"{e:.3e} max|kernel-dense|={diff(got, dense):.3e}")

    def row_rel(a, b_):  # largest per-row relative L2 error
        a, b_ = a.float(), b_.float()
        return float(((a - b_).norm(dim=-1)
                      / b_.norm(dim=-1).clamp_min(1e-30)).max())

    # bf16, the tensor-core kernel: every compiled D, causal or not, ragged
    # S (100 and 200 below one q tile, 4000 not a multiple of TILE_Q),
    # Sk > Sq, and GQA over strided head views. Against the plain version
    # at the kernel's own tiles (p is rounded after the running max, which
    # depends on the tiling) and the float32 oracle on the same bf16
    # inputs (dense attention computed in float32).
    bf = torch.bfloat16
    cases = []
    for d, dv in HEAD_DIMS:
        for causal in (True, False):
            for s in (100, 200, 4000):
                q, k, v = (randn(1, s, 4, d, dtype=bf),
                           randn(1, s, 2, d, dtype=bf),
                           randn(1, s, 2, dv, dtype=bf))
                cases.append((f"d={d} dv={dv} causal={causal} s={s}", q, k, v,
                              causal))
    for d, dv in ((64, 64), (128, 128), (96, 64), (192, 128)):
        for causal in (True, False):
            q, k, v = (randn(2, 200, 4, d, dtype=bf),
                       randn(2, 456, 1, d, dtype=bf),
                       randn(2, 456, 1, dv, dtype=bf))
            cases.append((f"d={d} dv={dv} causal={causal} sq=200 sk=456", q,
                          k, v, causal))
    qb, kvb = randn(2, 300, 16, 64, dtype=bf), randn(2, 300, 4, 64,
                                                     dtype=bf)
    cases.append(("GQA strided heads q (2,300,8|16,64) kv (2,300,2|4,64)",
                  qb[:, :, 4:12], kvb[:, :, :2], kvb[:, :, 2:], True))
    for label, q, k, v, causal in cases:
        got = flash_attention(q, k, v, causal, q.shape[1], k.shape[1])
        want = flash_attention_plain(q, k, v, causal, TILE_Q, TILE_K)
        oracle = dense_attention(q.float(), k.float(), v.float(),
                                 causal=causal)
        e, e_or = diff(got, want), diff(got, oracle)
        rel, rel_or = row_rel(got, want), row_rel(got, oracle)
        err = max(err, e)
        log(f"flash bf16 {label}: max|kernel-plain|={e:.3e} (row rel L2 "
            f"{rel:.3e}), max|kernel-f32 oracle|={e_or:.3e} (row rel L2 "
            f"{rel_or:.3e})")
        require(bool(torch.isfinite(got).all()),
                f"flash bf16 {label}: not finite")
        require(torch.allclose(got.float(), want.float(), **TOL_BF16_PLAIN),
                f"flash bf16 {label}: kernel vs plain {e:.3e}")
        require(torch.allclose(got.float(), oracle, **TOL_BF16),
                f"flash bf16 {label}: kernel vs f32 oracle {e_or:.3e}")
    del cases, qb, kvb

    # TinyLlama's prefill shape, the blocks the model path passes: float32
    # (the long tile loop, the causal skip at large q0 and GQA, held
    # tightly), then bf16 (the instance the model runs)
    b, s, hq, hkv, d = PREFILL_B, PREFILL_S, 32, 4, 64

    def heads(x):  # (B, S, H, D) -> (B*Hq, S, D) float32, KV heads repeated
        x = x.float().repeat_interleave(hq // x.shape[2], dim=2)
        return x.permute(0, 2, 1, 3).reshape(b * hq, s, d)

    def oracle_of(q, k, v):
        o = attention_ref(heads(q), heads(k), heads(v), True)
        return o.reshape(b, hq, s, d).permute(0, 2, 1, 3)

    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    got = flash_attention(q, k, v, True, 128, 1024)
    want = flash_attention_plain(q, k, v, True, 128, 1024)
    e = diff(got, want)
    err = max(err, e)
    require(torch.allclose(got, want, **TOL_F32),
            f"flash prefill f32: kernel vs plain {e:.3e}")
    oracle = oracle_of(q, k, v)
    e_or = diff(got, oracle)
    require(torch.allclose(got, oracle, **TOL_F32),
            f"flash prefill f32: kernel vs oracle {e_or:.3e}")
    log(f"flash prefill f32 q={tuple(q.shape)} kv={tuple(k.shape)}: "
        f"max|kernel-plain|={e:.3e} max|kernel-oracle|={e_or:.3e}")
    del q, k, v, got, want, oracle

    q, k, v = (randn(b, s, hq, d, dtype=bf), randn(b, s, hkv, d, dtype=bf),
               randn(b, s, hkv, d, dtype=bf))
    got = flash_attention(q, k, v, True, 128, 1024)
    again = flash_attention(q, k, v, True, 128, 1024)
    torch.cuda.synchronize()
    require(torch.equal(got, again), "flash prefill: two launches differ")
    # p's bf16 rounding depends on the running max, so on the tiling: the
    # plain version runs the kernel's tiles
    want = flash_attention_plain(q, k, v, True, TILE_Q, TILE_K)
    e, rel = diff(got, want), row_rel(got, want)
    err = max(err, e)
    require(torch.allclose(got.float(), want.float(), **TOL_BF16_PLAIN),
            f"flash prefill bf16: kernel vs plain {e:.3e} (row rel {rel:.3e})")
    oracle = oracle_of(q, k, v)
    e_or, rel_or = diff(got, oracle), row_rel(got, oracle)
    require(torch.allclose(got.float(), oracle, **TOL_BF16),
            f"flash prefill bf16: kernel vs f32 oracle {e_or:.3e}")
    del oracle
    log(f"flash prefill bf16 q={tuple(q.shape)} kv={tuple(k.shape)}: "
        f"max|kernel-plain|={e:.3e} (row rel L2 {rel:.3e}), max|kernel-f32 "
        f"oracle|={e_or:.3e} (row rel L2 {rel_or:.3e}), typical |o| "
        f"{float(want.float().abs().median()):.3e}, bit-identical relaunch")
    operands = {"tinyllama-1.1b": (q, k, v)}

    # qwen3's and minicpm3's prefill shapes (B=2, S=4096), bf16: the
    # instances their models run, against the plain version at the
    # kernel's tiles and dense_attention in float32; two launches
    # bit-identical
    for arch, (hq, hkv, d, dv) in PREFILL_HEADS.items():
        q, k, v = (randn(b, s, hq, d, dtype=bf), randn(b, s, hkv, d, dtype=bf),
                   randn(b, s, hkv, dv, dtype=bf))
        got = flash_attention(q, k, v, True, 128, 1024)
        again = flash_attention(q, k, v, True, 128, 1024)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"flash {arch} prefill: two "
                "launches differ")
        want = flash_attention_plain(q, k, v, True, TILE_Q, TILE_K)
        e, rel = diff(got, want), row_rel(got, want)
        err = max(err, e)
        require(torch.allclose(got.float(), want.float(), **TOL_BF16_PLAIN),
                f"flash {arch} prefill bf16: kernel vs plain {e:.3e}")
        oracle = torch.cat([dense_attention(q[i:i + 1].float(),
                                            k[i:i + 1].float(),
                                            v[i:i + 1].float(), causal=True)
                            for i in range(b)])
        e_or = diff(got, oracle)
        require(torch.allclose(got.float(), oracle, **TOL_BF16),
                f"flash {arch} prefill bf16: kernel vs f32 oracle {e_or:.3e}")
        del oracle, want, again
        log(f"flash {arch} prefill bf16 q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}: max|kernel-plain|="
            f"{e:.3e} (row rel L2 {rel:.3e}), max|kernel-f32 oracle|="
            f"{e_or:.3e}, bit-identical relaunch")
        operands[arch] = (q, k, v)
    return err, operands


def device_time_by_name(prof) -> dict:
    """{kernel or copy name: [device us, count]} from a profiler run. The
    measured step's gate (``step_gate_kernel``) is left out: it waits
    while the host enqueues the step, and does no work."""
    import collections

    from torch.autograd import DeviceType

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and not e.name.startswith("step_gate_kernel"):
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    return by_name


def traced(torch, fn) -> dict:
    """``device_time_by_name`` of a ``torch.profiler`` window around
    ``fn()``. A short spin and a pause lead the window, since the profiler
    can miss the device's first activity after it starts, and a pause
    ends it, since it has also dropped the last kernels before its stop
    (the device clock read ahead of the host's); the spin's kernel,
    learned from a profile of it alone, is left out."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as probe:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    lead = set(device_time_by_name(probe))
    with profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return {name: v for name, v in device_time_by_name(prof).items()
            if name not in lead}


def kernel_instances(torch, fn, pattern: str, wrapper,
                     tries: int = 3) -> list:
    """The template arguments of every kernel whose name matches
    ``pattern`` that ``fn`` launches, read from the profiler's kernel
    names. The profiler here has dropped kernels from a trace, so a trace
    holding fewer matches than ``wrapper`` counted launches is taken
    again, up to ``tries`` times; the last is returned as it is."""
    import re

    for _ in range(tries):
        before = wrapper.launches
        by_name = traced(torch, fn)
        launched = wrapper.launches - before
        found = []
        for name, (_, cnt) in by_name.items():
            hit = re.search(pattern, name)
            if hit:
                found += [tuple(map(int, hit.groups()))] * cnt
        if len(found) >= launched:
            return found
        log(f"profiler: {len(found)} of {launched} {pattern} launches "
            "in the trace; taking it again")
    return found


# ------------------------------------------------------ the policy phase
def fixed_draws(torch, draws_cls, device, cover_pool: bool = False):
    """A ``draws_cls`` (an env's ``Draws``) whose draws are a seeded CPU
    generator's, moved to ``device``: the same draws on the card and on
    the CPU. ``cover_pool`` makes env e take entry e % len of the
    scenario pool (and, in the cluster env, of the archetype pool, with
    the peer counts in turn), so a batch covers the pools."""
    import dataclasses

    def to(x):
        return to_device(x, device)

    class FixedDraws(draws_cls):
        def profile(self, cfg, n):
            return to(super().profile(cfg, n))

        def noise(self, cfg, n):
            return to(super().noise(cfg, n))

        def scenario(self, cfg, n):
            u = super().scenario(cfg, n)
            if cover_pool:
                u = dataclasses.replace(u, pool_idx=torch.arange(n) % len(
                    cfg.scenario_pool))
            return to(u)

        def window(self, cfg, n):
            return to(super().window(cfg, n))

        def cluster(self, cfg, n):
            c = super().cluster(cfg, n)
            if cover_pool:
                idx = torch.arange(n)
                c = dataclasses.replace(
                    c, kind_idx=idx % len(cfg.cluster_pool),
                    peers_idx=(idx // len(cfg.cluster_pool))
                    % len(cfg.resolved_peer_pool()))
            return to(c)

    return FixedDraws(torch.Generator().manual_seed(SEED))


def policy_card_vs_cpu(torch, device, tables, theta):
    """The tensor cost laws, both envs' reset and steps, and the DQN
    loss's gradients on the card against the same calls on the CPU, on
    the same inputs (``TOL_POLICY``). Returns the largest |diff|."""
    import numpy as np

    from repro_torch.core import cost_model as cm, dqn, simulator as sim
    from repro_torch.core import table_sim
    from repro_torch.train import policy as pol

    rng = np.random.default_rng(SEED)
    n = 64
    window = np.asarray(cm.WINDOW_CHOICES, np.float32)[rng.integers(0, 8, n)]
    sigma = (1 + 5 * rng.random((n, 3))).astype(np.float32)
    weights = rng.dirichlet(np.ones(3), n).astype(np.float32)
    actions = rng.integers(0, 32, (12, 8))
    q_seeds = (1, 2)
    batch_np = (rng.normal(size=(64, 23)).astype(np.float32),
                rng.integers(0, 32, 64), rng.normal(size=64).astype(
                    np.float32), rng.normal(size=(64, 23)).astype(np.float32),
                rng.random(64) < 0.2)

    def outputs(dev):
        out = {}
        pool = pol.make_params_pool([theta] * n, device=dev)
        w, s, ww = (torch.as_tensor(x, device=dev)
                    for x in (window, sigma, weights))
        out["sigma_from_delta_t"] = cm.sigma_from_delta_t(pool, (s - 1) * 7)
        out["hit_rate_t"] = cm.hit_rate_t(pool, w)
        out["rebuild_time_t"] = cm.rebuild_time_t(pool, w)
        out["allreduce_penalty_t"] = cm.allreduce_penalty_t(pool, s)
        out["per_owner_hit_rates_t"] = cm.per_owner_hit_rates_t(pool, w, ww)
        out["step_time_t"] = cm.step_time_t(pool, w, s, ww)
        out["step_energy_t"] = cm.step_energy_t(pool, w, s, ww)
        cfg = sim.EnvConfig(schedule=0, n_epochs=6, steps_per_epoch=32)
        for name, env, entry in (("analytic", sim, theta),
                                 ("table", table_sim, tables)):
            draws = fixed_draws(torch, sim.Draws, dev)
            state = env.reset(cfg, draws,
                              pol.make_params_pool([entry] * 8, device=dev))
            out[f"{name} reset obs"] = state.obs
            for i, a in enumerate(actions):
                state, obs, reward, done = env.step(
                    cfg, state, torch.as_tensor(a, device=dev), draws)
                for k, v in (("obs", obs), ("reward", reward),
                             ("done", done.float()),
                             ("energy", state.total_energy),
                             ("time", state.total_time)):
                    out[f"{name} step {i} {k}"] = v
        online, target = (dqn.init_qnet(torch.Generator().manual_seed(k), 23,
                                        32, device=dev) for k in q_seeds)
        batch = tuple(torch.as_tensor(x, device=dev) for x in batch_np)
        loss, grads = dqn.loss_and_grads(online, target, batch)
        out["dqn_loss"] = loss
        for layer, sub in grads.items():
            for k, g in sub.items():
                out[f"dqn_loss grad {layer}.{k}"] = g
        return out

    card, cpu = outputs(device), outputs(torch.device("cpu"))
    worst = 0.0
    for k, want in cpu.items():
        got = card[k].cpu()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        require(torch.allclose(got, want, **TOL_POLICY),
                f"policy card vs CPU: {k} max |diff| {err:.3e}")
    log(f"policy card vs CPU: {len(cpu)} tensors (7 cost laws, both envs' "
        f"reset and 12 steps of 8 envs, the DQN loss and its 6 gradients) "
        f"within rtol {TOL_POLICY['rtol']}, atol {TOL_POLICY['atol']}; max "
        f"|diff| {worst:.3e}")
    return worst


def syncs_during(torch, fn) -> int:
    """``fn()`` with CUDA's sync debug mode on: the number of host syncs
    it made (device-to-host reads, synchronizing copies)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def training_cfg(env_name: str, **kw):
    """The env configuration ``train_policy`` trains ``env_name`` at: 30
    epochs of 32 steps (the queue env: its default scenario pool; the
    cluster env: ``CLUSTER_P`` ranks and its default pools), ``kw``
    replacing fields of the cluster env's."""
    from repro_torch.core import queue_sim as qs, simulator as sim
    from repro_torch.envs import cluster_sim as cs

    if env_name == "queue":
        return qs.QueueEnvConfig(steps_per_epoch=32, n_epochs=30)
    if env_name == "cluster":
        return cs.ClusterEnvConfig(n_parts=CLUSTER_P, steps_per_epoch=32,
                                   n_epochs=30, **kw)
    return sim.EnvConfig(schedule=0, steps_per_epoch=32, n_epochs=30)


def phase_policy_profile(torch, device, pools):
    for env_name, pool in pools.items():
        policy_profile(torch, device, env_name, pool)


def policy_profile(torch, device, env_name, pool):
    """Two unprofiled and two profiled ``train_dqn`` runs of
    ``POLICY_PROFILED`` iterations, updating from the first iteration;
    the differences of the pairs are per-iteration numbers free of the
    runs' set-up: host wall, host syncs (must be 0), device kernels and
    copies, device busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dqn
    from repro_torch.envs import resolve_env

    env = resolve_env(env_name)
    env_cfg = training_cfg(env_name)

    def run(iters):
        dqn.train_dqn(dqn.DQNConfig(
            n_envs=POLICY_ENVS, iterations=iters, min_replay=POLICY_ENVS,
            eps_decay_iters=iters, seed=SEED, device=str(device)),
            env_cfg, pool, env=env)

    walls, syncs, kernels, copies, busy = {}, {}, {}, {}, {}
    for iters in POLICY_PROFILED:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        syncs[iters] = syncs_during(torch, lambda: run(iters))
        torch.cuda.synchronize()
        walls[iters] = time.perf_counter() - t0
    for iters in POLICY_PROFILED:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(iters)
            torch.cuda.synchronize()
        by_name = device_time_by_name(prof)
        kernels[iters] = sum(c for name, (_, c) in by_name.items()
                             if not name.startswith("Mem"))
        copies[iters] = sum(c for name, (_, c) in by_name.items()
                            if name.startswith("Mem"))
        busy[iters] = sum(us for us, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    a, b = POLICY_PROFILED
    d = b - a
    wall_ms = (walls[b] - walls[a]) * 1e3 / d
    busy_ms = (busy[b] - busy[a]) / d
    log(f"policy profile {env_name} ({POLICY_ENVS} envs, runs of {a} and "
        f"{b} iterations): host wall {wall_ms:.4f} ms/iteration "
        f"(unprofiled), {(kernels[b] - kernels[a]) / d:.2f} device kernels "
        f"and {(copies[b] - copies[a]) / d:.2f} copies/sets per iteration, "
        f"device busy {busy_ms:.4f} ms/iteration, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}; host syncs {syncs[a]} and "
        f"{syncs[b]} a run; {smi_line()}")
    for name, (us, cnt) in top:
        log(f"  device {us / 1e3 / b:8.4f} ms/iteration x{cnt / b:6.2f}  "
            f"{name[:80]}")
    require(syncs[a] == syncs[b],
            f"policy {env_name}: {syncs[b] - syncs[a]} host syncs in "
            f"{d} iterations; the loop must read nothing back")
    require(kernels[b] > kernels[a], f"policy {env_name}: no device kernel")


def held_out(torch, device, env_name, pool, policy_fn, cfg=None):
    """``policy_fn`` over ``POLICY_HELD_OUT`` held-out episodes of
    ``cfg`` (default: the training env's configuration), each run to its
    end: (energy per episode, discounted return per episode, the objective
    DQN maximises: sum of GAMMA^t r_t over its decisions)."""
    from repro_torch.core import dqn, simulator as sim
    from repro_torch.envs import resolve_env

    env = resolve_env(env_name)
    cfg = cfg or training_cfg(env_name)
    draws = getattr(env, "Draws", sim.Draws)(
        torch.Generator(device=device).manual_seed(SEED + 99))
    params = sim.take(pool, torch.zeros(POLICY_HELD_OUT, dtype=torch.long,
                                        device=device))
    out = sim.rollout_policy(cfg, draws, params, policy_fn,
                             max_decisions=cfg.total_steps, env=env)
    trace = out["trace"]
    steps_run = (trace["window"] * trace["active"]).sum(0)
    require(bool((steps_run >= cfg.total_steps).all()),
            f"policy {env_name}: a held-out episode did not finish")
    disc = dqn.GAMMA ** torch.arange(trace["reward"].shape[0],
                                     device=device, dtype=torch.float32)
    # a finished episode's later steps are frozen; their rewards (0 / 0
    # in the queue env, as in the reference) count for nothing
    ret = (torch.where(trace["active"], trace["reward"], 0.0)
           * disc[:, None]).sum(0)
    return out["total_energy"].cpu(), ret.cpu()


def _fmt(xs) -> str:
    return (f"{[round(float(x), 2) for x in xs]} (mean "
            f"{float(xs.mean()):.2f})")


def phase_policy(torch, device, smi):
    """Calibrate on the main path's bundle, hold the simulators and the
    loss on the card against the CPU, train Double-DQN on the card in the
    table and the analytic env, and check the training.
    Returns the table-trained qnet, which the greendygnn phases run, and
    the parameter pools (``phase_policy_profile`` profiles training on
    them after the other profiles: its windows hold ~750 kernels an
    iteration)."""
    import tempfile

    from repro_torch.core import controller as ctl, cost_model as cm, dqn
    from repro_torch.core import simulator as sim
    from repro_torch.envs import resolve_env
    from repro_torch.train import gnn_trainer as gt, policy as pol

    cal_cfg = gt.RunConfig(**dict(MAIN_PATH, compute="modeled"),
                           device=str(device))
    bundle = gt.build_trace(cal_cfg)
    t0 = time.perf_counter()
    tables = pol.calibrate_table_from_bundle(bundle, cal_cfg)
    t_table = time.perf_counter() - t0
    theta, diag = pol.calibrate_from_bundle(bundle, cal_cfg)
    t_theta = time.perf_counter() - t0 - t_table
    log(f"policy calibration on the main path's bundle: tables in "
        f"{t_table:.2f} s (hit at W=16, uniform: "
        f"{[round(float(h), 4) for h in tables.hit[4, 0]]}); theta in "
        f"{t_theta:.2f} s (h_min {theta.h_min:.4f}, h_max {theta.h_max:.4f}, "
        f"w_half {theta.w_half:.3f}, rebuild {theta.rebuild_a:.4g} + "
        f"{theta.rebuild_b:.4g} W^{theta.rebuild_c:.4f}, t_miss0 "
        f"{theta.t_miss0:.4g}, remote_nodes {theta.remote_nodes:.1f})")
    policy_card_vs_cpu(torch, device, tables, theta)

    pools = {"table": pol.make_params_pool([tables], device=device),
             "analytic": pol.make_params_pool([theta], device=device)}
    # the reference's fresh qnet in its training test (seed 99), and the
    # untrained qnet training starts from, which the greendygnn phases
    # ran until they took a trained one
    fresh, start = (dqn.init_qnet(torch.Generator().manual_seed(k), 23, 32,
                                  device=device) for k in (99, SEED))
    qnets = {}
    with tempfile.TemporaryDirectory() as tmp:
        cached, pol.ARTIFACT_DIR = pol.ARTIFACT_DIR, tmp
        try:
            for env in ("table", "analytic"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, qnets[env] = pol.get_or_train_policy(
                    pools[env], name="smoke", iterations=POLICY_ITERS,
                    force=True, env=env, device=str(device),
                    n_envs=POLICY_ENVS, seed=SEED)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with open(pathlib.Path(tmp) / f"smoke_{env}.json") as f:
                    meta = json.load(f)
                policies = {name: dqn.greedy_policy(q) for name, q in (
                    ("trained", qnets[env]), ("fresh", fresh),
                    ("start", start))}
                for w in (2, 16):
                    a = ctl.encode_action(cm.WINDOW_CHOICES.index(w), 0, 3)
                    policies[f"static W={w}"] = (
                        lambda obs, a=a: torch.full((obs.shape[0],), a,
                                                    device=obs.device))
                runs = {name: held_out(torch, device, env, pools[env], fn)
                        for name, fn in policies.items()}
                log(f"policy {env}: {POLICY_ITERS} iterations x "
                    f"{POLICY_ENVS} envs on the card in {wall:.2f} s "
                    f"({POLICY_ITERS / wall:.1f} iterations/s, artifact "
                    f"write included), {meta['episodes']} episodes, "
                    f"{meta['grad_steps']} gradient steps, mean reward of "
                    f"the last 200 iterations {meta['final_reward']:.4f}; "
                    f"{smi}")
                for name, (energy, ret) in runs.items():
                    log(f"  held-out {name}: energy (J) {_fmt(energy)}, "
                        f"discounted return {_fmt(ret)}")
                require(meta["grad_steps"] > 0 and meta["episodes"] > 0,
                        f"policy {env}: no gradient step or episode")
                require(float(runs["trained"][1].mean())
                        > float(runs["fresh"][1].mean()),
                        f"policy {env}: the trained policy's discounted "
                        "return does not beat the fresh qnet's on the "
                        "held-out episodes")
        finally:
            pol.ARTIFACT_DIR = cached

    runs = [dqn.train_dqn(
        dqn.DQNConfig(n_envs=POLICY_ENVS, iterations=POLICY_SHORT,
                      min_replay=256, eps_decay_iters=POLICY_SHORT // 2,
                      seed=SEED, device=str(device)),
        sim.EnvConfig(schedule=0, steps_per_epoch=32, n_epochs=30),
        pools["table"], env=resolve_env("table")) for _ in range(2)]
    same = all(torch.equal(runs[0]["qnet"][layer][k], runs[1]["qnet"][layer][k])
               for layer in runs[0]["qnet"] for k in runs[0]["qnet"][layer])
    require(same and torch.equal(runs[0]["metrics"]["loss"],
                                 runs[1]["metrics"]["loss"]),
            "policy: two same-seed card runs gave different qnets")
    log(f"policy: two same-seed card runs of {POLICY_SHORT} iterations "
        f"gave equal qnets and losses")
    return qnets["table"], pools


# ------------------------------------------------------- the paper phase
PAPER_CELL = ("reddit", 2000, "greendygnn")   # Table I's cell rerun on CPU


def paper_rows(smi, sweep) -> list:
    """Every module of ``repro_torch.paper.run`` over ``sweep``: their rows
    logged with each module's wall time; a module that raised ends the
    run."""
    import io

    from repro_torch.paper import run as paper_run

    out = io.StringIO()
    failed = paper_run.run_all(sweep, paper_run.MODULES, out=out)
    rows = out.getvalue().splitlines()
    for row in rows:
        log(f"paper {row}")
    log(f"paper: {len(paper_run.MODULES)} modules; {smi}")
    require(not failed, f"paper: {failed} raised")
    return rows


def phase_paper(torch, device, smi, qnet) -> None:
    """The paper's harness and the four examples on the card, with
    ``phase_policy``'s table qnet standing as ``qnet_main`` and
    ``qnet_example`` in a temporary artifact directory.

    Every module of ``repro_torch.paper.run`` at the reference's full
    grid (3 datasets x 3 batches x 4 methods, 14 epochs of 32 steps, the
    ablations and clean runs, Fig. 8's 7 x 6 grid, pipeline overlap at W
    = 16), then quickstart (its own 2,500-iteration DQN on the card),
    serve_lm, train_distributed_gnn and congestion_adaptation_demo at
    their defaults. Checks: no module raised; Fig. 8 ran its 42 points;
    the pipeline's parity is OK; Table I's ``PAPER_CELL`` rerun on the
    CPU (its qnet copied there) gives the card's totals, windows and
    result digest (the modeled lane is numpy: only the qnet's device
    differs); the examples' outputs are finite and of their shapes, the
    checkpoint reads back; and no hand-written kernel launched (these
    paths run none)."""
    import tempfile

    import numpy as np

    from repro_torch.analysis.digest import result_digest
    from repro_torch.core import dqn
    from repro_torch.examples import (
        congestion_adaptation_demo, quickstart, serve_lm,
        train_distributed_gnn,
    )
    from repro_torch.paper.common import Sweep
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train import policy as pol

    before = kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("qnet_main", "qnet_example"):
            dqn.save_qnet(os.path.join(tmp, f"{name}.npz"), qnet)
        cached, pol.ARTIFACT_DIR = pol.ARTIFACT_DIR, tmp
        try:
            sweep = Sweep(device=str(device),
                          results_dir=os.path.join(tmp, "results"))
            rows = paper_rows(smi, sweep)
            require("fig8/grid_points,42," in rows,
                    "paper: Fig. 8 did not run its 7 x 6 grid")
            require(any(r.startswith("pipeline/reddit/parity,OK,")
                        for r in rows),
                    "paper: the threaded pipeline's parity failed")
            ds, batch, method = PAPER_CELL
            t0 = time.perf_counter()
            a = sweep.run(ds, batch, method, True)
            cpu_cfg = dataclasses.replace(
                sweep.base_cfg(ds, batch, method=method, congested=True),
                device="cpu", q_fn=dqn.q_fn_of(dqn.load_qnet(
                    os.path.join(tmp, "qnet_main.npz"))))
            b = gt.run(cpu_cfg, sweep.trace(ds, batch))
            require(a.totals() == b.totals()
                    and np.array_equal(a.window_per_epoch,
                                       b.window_per_epoch)
                    and result_digest(a) == result_digest(b),
                    f"paper: Table I's {PAPER_CELL} on the card "
                    f"{a.totals()} / windows {a.window_per_epoch} against "
                    f"the CPU {b.totals()} / {b.window_per_epoch}")
            log(f"paper: Table I's {PAPER_CELL} card = CPU (totals, "
                f"windows {a.window_per_epoch.tolist()}, digest), CPU rerun "
                f"{time.perf_counter() - t0:.1f} s")

            t0 = time.perf_counter()
            energies = quickstart.main(["--device", str(device)])
            require(len(energies) == 5 and all(
                math.isfinite(e) and e > 0 for e in energies.values()),
                f"quickstart: energies {energies}")
            log(f"example quickstart: {time.perf_counter() - t0:.1f} s; "
                f"{smi}")
            t0 = time.perf_counter()
            gen = serve_lm.main(["--device", str(device)])
            require(tuple(gen.ids.shape) == (serve_lm.BATCH,
                                              serve_lm.GEN_LEN)
                    and bool(torch.isfinite(gen.logits).all()),
                    f"serve_lm: ids {tuple(gen.ids.shape)}")
            log(f"example serve_lm: {time.perf_counter() - t0:.1f} s; "
                f"{smi}")
            t0 = time.perf_counter()
            ckpt_dir = os.path.join(tmp, "ckpt")
            res = train_distributed_gnn.main(["--device", str(device),
                                              "--ckpt-dir", ckpt_dir])
            tree = train_distributed_gnn.checkpoint_tree(res)
            back, step = ckpt.restore_checkpoint(
                ckpt_dir, {k: torch.zeros_like(v) for k, v in tree.items()})
            require(math.isfinite(res.totals()["total_kj"])
                    and res.accuracy_per_epoch.shape == (8,)
                    and step == 8
                    and all(torch.equal(back[k], v) for k, v in tree.items()),
                    "train_distributed_gnn: totals, accuracies or the "
                    "checkpoint")
            log(f"example train_distributed_gnn: "
                f"{time.perf_counter() - t0:.1f} s; {smi}")
            t0 = time.perf_counter()
            runs = congestion_adaptation_demo.main(["--device", str(device)])
            require(all(math.isfinite(r.totals()["total_kj"])
                        for r in runs.values()),
                    "congestion_adaptation_demo: totals")
            log(f"example congestion_adaptation_demo: "
                f"{time.perf_counter() - t0:.1f} s; {smi}")
        finally:
            pol.ARTIFACT_DIR = cached
    require(kernel_counts() == before,
            f"the paper phase launched a hand-written kernel: {before} -> "
            f"{kernel_counts()}")


class ChildPhase:
    """A phase in a process of its own: this script with ``--NAME DIR``,
    ``write_inputs(DIR)`` having put its inputs there. The paper and the
    sweeps phases run so, started after the policy phase and run beside
    the queue and cluster-env phases: all of them are host-bound and
    leave the card idle most of the time. Its output goes to a file,
    relayed to this process's output at ``join``."""

    def __init__(self, name: str, timeout_s: float, write_inputs):
        import tempfile

        self.name, self.timeout_s = name, timeout_s
        self.tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
        write_inputs(self.tmp)
        self.out = open(self.tmp / f"{name}.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), f"--{name}",
             str(self.tmp)], stdout=self.out, stderr=subprocess.STDOUT)

    def join(self) -> None:
        """Wait for the process, relay its output, fail if it failed; its
        phase times go into ``PHASE_S`` marked ``(own process)``."""
        try:
            rc = self.proc.wait(timeout=self.timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        try:
            with open(self.tmp / f"{self.name}.log") as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()
            require(rc == 0, f"the {self.name} process exited {rc}")
            with open(self.tmp / "phases.json") as f:
                for k, v in json.load(f).items():
                    PHASE_S[f"{k} (own process)"] = v
        finally:
            self.stop()

    def stop(self) -> None:
        """End the process if it still runs and remove its directory;
        idempotent."""
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def paper_process(qnet) -> ChildPhase:
    """``phase_paper`` in a process of its own, the table qnet passed as
    a file."""
    from repro_torch.core import dqn

    return ChildPhase("paper", PAPER_TIMEOUT_S, lambda tmp: dqn.save_qnet(
        str(tmp / "qnet.npz"), qnet))


def child_main(name: str, fn, tmp) -> int:
    """The ``--NAME DIR`` entry: ``fn(DIR)`` timed as phase NAME; the
    phase times to DIR/phases.json."""
    timed(name, fn, pathlib.Path(tmp))
    with open(pathlib.Path(tmp) / "phases.json", "w") as f:
        json.dump(PHASE_S, f)
    return 0


# the paper process's limit: it took 164.9-225.1 s alone (NVIDIA H100 80GB
# HBM3, 700 W)
PAPER_TIMEOUT_S = 600


# ------------------------------------------------------ the sweeps phase
# the sweeps' lengths on the card: the reference's batch (1000) and
# epochs of 16 steps, 3 epochs (2 of warmup: the policies decide once a
# rank at step 32); the full-size run (``scripts/paper_sweeps.py``) takes
# the reference's 8 and 6 epochs
SWEEP_STEPS = 48
SWEEP_ITERS = 100          # each policy's training budget, 64 envs
GAUNTLET_ENVS = 32         # the gauntlet's training envs
SWEEP_P_CPU = (2, 8)       # run_cluster sizes rerun on the CPU
SWEEPS_TIMEOUT_S = 600


def host_cpu() -> str:
    """The host's CPU model (``/proc/cpuinfo``'s, where it names one) and
    the CPUs this process may run on."""
    import platform

    model = "unnamed"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    return (f"host CPU {model} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} of {os.cpu_count()} CPUs")


# the trainings phase_sweeps must run, as (env, owners): the cluster
# sweep's cluster-twin, queue-env and headroom-aware policies at P = 4,
# the cluster twin's at P = 2 and 8, and the gauntlet's three
SWEEP_TRAININGS = sorted([("cluster", 3), ("queue", 3), ("cluster", 3),
                          ("cluster", 1), ("cluster", 7), ("analytic", 3),
                          ("table", 3), ("queue", 3)])


def sweeps_training(smi, host, trained):
    """``trainings_timed``'s report: log a training, add its (env, owners)
    to ``trained``, and require that it launched its env's window kernel
    2 an iteration + 1 times (a probe window at the first reset, then a
    step and a reset's probe window an iteration) and the other window
    kernel never."""
    from repro_torch.paper.common import WINDOW_KERNEL

    def report(rec):
        trained.append((rec["env"], rec["owners"]))
        its, own = rec["iterations"], WINDOW_KERNEL.get(rec["env"])
        log(f"sweeps training {rec['env']} ({rec['owners']} owners"
            + (f", {rec['cluster_kwargs']}" if rec["cluster_kwargs"]
               else "")
            + f"): {its} iterations x {rec['n_envs']} envs in "
            f"{rec['wall_s']:.2f} s ({rec['iterations_per_s']:.1f} "
            f"iterations/s), {rec['episodes']} episodes, window launches "
            f"{rec['queue_window']} queue / {rec['cluster_window']} "
            f"cluster; {smi}; {host}")
        for k in WINDOW_KERNEL.values():
            want = 2 * its + 1 if k == own else 0
            require(rec[k] == want,
                    f"sweeps training {rec['env']} ({rec['owners']} "
                    f"owners): {rec[k]} {k} launches, not {want}")
    return report


def sweeps_scenario(device, smi) -> None:
    """``scenario_sweep`` at P = 1: the 12 registry scenarios x dgl, bgl,
    static_w and heuristic, then ``check_clean_parity`` (the 5% band and
    the bit-equal streams)."""
    from repro_torch.paper import scenario_sweep as ss

    res = ss.main(["--steps", str(SWEEP_STEPS), "--check-clean-parity",
                   "--device", str(device)])
    rows = res["rows"]
    require(list(rows) == ss.default_scenarios() and len(rows) == 12
            and all(list(c) == ss.DEFAULT_METHODS for c in rows.values())
            and all(math.isfinite(v["total_kj"]) and v["total_kj"] > 0
                    for c in rows.values() for v in c.values()),
            f"scenario_sweep: rows {rows}")
    log(f"sweeps scenario_sweep: {len(rows)} scenarios x "
        f"{len(ss.DEFAULT_METHODS)} methods at P = 1, clean parity held; "
        f"{smi}")


def sweeps_cluster(device, smi) -> None:
    """``cluster_sweep`` at P = 4 with the mixture axis and the memory
    axis at ``tight``, its policies trained here; the reference's
    ``--check`` invariants that do not rest on the policies' quality must
    hold."""
    from repro_torch.paper import cluster_sweep as cs

    args = cs.parse_args([
        "--workers", "4", "--steps", str(SWEEP_STEPS), "--mixture",
        "--mem-budget", "tight", "--iterations", str(SWEEP_ITERS),
        "--check", "--device", str(device)])
    before = kernel_counts()
    result = cs.run_sweep(args)
    rows, mem = result["rows"][4], result["mem"][4]
    emergent = [n for n in rows if not n.startswith("injected:")]
    require(len(rows) == 6 and all(
        list(c) == args.methods.split(",") for c in rows.values()),
        f"cluster_sweep: rows {list(rows)}")
    queue = {n: rows[n]["greendygnn"]["queue_s"] for n in emergent}
    require(all(q > 0 for q in queue.values()),
            f"cluster_sweep: no emergent queueing: {queue}")
    tight = mem["rows"]["tight"]["greendygnn"]
    tc = tight["tier_counts"]
    require(mem["unlimited_parity"],
            "cluster_sweep: the unlimited budget differs from the in-RAM "
            "store")
    require(tight["deterministic"],
            "cluster_sweep: the paired greendygnn cells disagree")
    require(tc["block_fetches"] > 0 and tc["evictions"] > 0,
            f"cluster_sweep: no tier traffic under tight: {tc}")
    bags = kernel_counts()["embedding_bag"] - before["embedding_bag"]
    require(bags > 0, "cluster_sweep: the memory axis launched no "
                      "embedding_bag kernel")
    log(f"sweeps cluster_sweep P = 4: 6 scenarios x 5 methods, "
        f"{len(result['mixtures'][4])} mixtures, memory axis at tight; "
        f"emergent queueing {queue}; unlimited parity, deterministic "
        f"pair, tier counts {tc}; embedding_bag launches {bags}; {smi}")


def sweeps_cpu_reruns(torch, device, smi) -> None:
    """``run_cluster`` at P = 2 and 8 under clean, static_w and greendygnn
    (the cluster twin's policy for P, trained here: the window kernel's
    1- and 7-owner instances in a training loop), each held against the
    same run on the CPU by ``report_digest``."""
    from repro_torch.analysis.digest import report_digest
    from repro_torch.core import dqn
    from repro_torch.paper import cluster_sweep as cs
    from repro_torch.train import policy as pol
    from repro_torch.train.cluster import (
        ClusterConfig, build_cluster_traces, run_cluster,
    )

    for P in SWEEP_P_CPU:
        cfg0 = dataclasses.replace(
            cs.base_cfg("reddit", 1000, device=str(device)), n_parts=P,
            n_epochs=SWEEP_STEPS // 16, steps_per_epoch=16)
        bundles = build_cluster_traces(cfg0, P)
        pool = cs.calib_pool(cfg0, bundles[0])
        q_fns = cs.get_q_fns(cfg0, pool, SWEEP_ITERS, False, {"greendygnn"})
        cpu_q = dqn.q_fn_of(dqn.load_qnet(
            os.path.join(pol.ARTIFACT_DIR, f"qnet_sweep_cluster_p{P}.npz"),
            device="cpu"))
        for method, q_card, q_cpu in (("static_w", None, None),
                                      ("greendygnn", q_fns["greendygnn"],
                                       cpu_q)):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(cfg0, method=method, scenario="clean",
                                      q_fn=q_card)
            card = run_cluster(cfg, ClusterConfig(n_workers=P),
                               trace_bundles=bundles)
            t_card = time.perf_counter() - t0
            cpu = run_cluster(dataclasses.replace(cfg, device="cpu",
                                                  q_fn=q_cpu),
                              ClusterConfig(n_workers=P),
                              trace_bundles=bundles)
            windows = [r.window_per_epoch.tolist() for r in card.results]
            require(report_digest(card) == report_digest(cpu),
                    f"run_cluster P = {P} {method}: card "
                    f"{card.totals_kj()} / windows {windows} against the "
                    f"CPU {cpu.totals_kj()}")
            log(f"sweeps run_cluster P = {P} {method} clean: card = CPU "
                f"(report_digest {report_digest(card)[:16]}...), "
                f"{card.totals_kj()['total_kj']:.6f} kJ, queueing "
                f"{card.total_queue_s:.6f} s, windows {windows[0]}, card "
                f"run {t_card:.2f} s; {smi}")


def sweeps_gauntlet(device, smi) -> None:
    """``policy_gauntlet``: the 12 scenarios x dgl, bgl, static_w and the
    analytic, table and queue policies, trained here; its gate logged."""
    from repro_torch.paper import policy_gauntlet as pg

    res = pg.main(["--steps", str(SWEEP_STEPS), "--iterations",
                   str(SWEEP_ITERS), "--n-envs", str(GAUNTLET_ENVS),
                   "--device", str(device)])
    rows = res["rows"]
    cols = pg.BASELINES + [f"dqn_{e}" for e in pg.TRAIN_ENVS]
    require(list(rows) == pg.default_scenarios()
            and all(list(c) == cols for c in rows.values())
            and all(math.isfinite(v["total_kj"]) and v["total_kj"] > 0
                    for c in rows.values() for v in c.values()),
            f"policy_gauntlet: rows {rows}")
    try:
        pg.check_acceptance(rows)
        gate = "held"
    except SystemExit as e:
        gate = f"failed: {e} (policies of {SWEEP_ITERS} iterations; not " \
            "required)"
    log(f"sweeps policy_gauntlet: {len(rows)} scenarios x {len(cols)} "
        f"columns; gate {gate}; {smi}")


def sweeps_roofline(records_dir, smi) -> None:
    """``roofline_report`` over the records ``phase_dryrun`` counted."""
    from repro_torch.paper import roofline_report as rr

    n = {d: len(rr.load_records(d, records_dir)) for d in ("meta", "cuda")}
    rows = rr.main(None, records_dir=records_dir)
    for row in rows:
        log(f"sweeps {row}")
    require(n["meta"] > 0 and rows[-3:-1] == [
        f"roofline/cells_meta,{n['meta']},expect 44",
        f"roofline/cells_cuda,{n['cuda']},the cells the card ran"]
        and len(rows) == n["meta"] + 3,
        f"roofline_report: {rows[-3:]} over {n}")


def phase_sweeps(torch, device, tmp) -> None:
    """The reference's last harness modules on the card, its policies
    trained at ``SWEEP_ITERS`` iterations in a temporary artifact
    directory: ``scenario_sweep``, ``cluster_sweep`` at P = 4,
    ``run_cluster`` at P = 2 and 8 against the CPU, ``policy_gauntlet``
    and ``roofline_report`` over the dry-run's records in ``tmp``. The
    memory axis's device tiers and the trainings must launch the
    ``embedding_bag``, ``queue_window`` and ``cluster_window`` kernels."""
    from repro_torch.paper import cluster_sweep, policy_gauntlet
    from repro_torch.paper import scenario_sweep
    from repro_torch.paper.common import trainings_timed
    from repro_torch.train import policy as pol

    smi, host = smi_line(), host_cpu()
    log(f"sweeps: {host}")
    before = kernel_counts()
    pol.ARTIFACT_DIR = str(tmp / "artifacts")
    for mod in (scenario_sweep, cluster_sweep, policy_gauntlet):
        mod.RESULTS_DIR = str(tmp / "results")
    trained = []
    with trainings_timed(sweeps_training(smi, host, trained)):
        timed("sweeps scenario_sweep", sweeps_scenario, device, smi)
        timed("sweeps cluster_sweep", sweeps_cluster, device, smi)
        timed("sweeps run_cluster P = 2, 8", sweeps_cpu_reruns, torch,
              device, smi)
        timed("sweeps policy_gauntlet", sweeps_gauntlet, device, smi)
    timed("sweeps roofline_report", sweeps_roofline, tmp / "records", smi)
    launched = {k: v - before[k] for k, v in kernel_counts().items()}
    log(f"sweeps: launches {launched}; {host}")
    require(sorted(trained) == SWEEP_TRAININGS,
            f"sweeps: trained {sorted(trained)}, not {SWEEP_TRAININGS}")
    require(all(launched[k] > 0 for k in ("embedding_bag", "queue_window",
                                          "cluster_window")),
            f"sweeps: a kernel of the path did not launch: {launched}")


def sweeps_process(records) -> ChildPhase:
    """``phase_sweeps`` in a process of its own, ``phase_dryrun``'s
    records passed as the dry-run's files."""
    def write(tmp):
        (tmp / "records").mkdir()
        for (arch, shape), rec in records.items():
            (tmp / "records" / f"{arch}__{shape}__{rec['device']}.json"
             ).write_text(json.dumps(rec, default=str))
    return ChildPhase("sweeps", SWEEPS_TIMEOUT_S, write)


# ------------------------------------------------------- the queue phase
def queue_card_vs_cpu(torch, device, theta):
    """The queue env's reset and ``ENV_CHECK_STEPS`` steps of 28 envs on
    the card against
    the same calls on the CPU (the CPU runs the kernel's plain version),
    draws fixed on the host: env e takes scenario code e % 14, so every
    code runs; the actions cycle W = 1, 16 and 128 and the allocations;
    4 epochs of 32 steps, so W = 128 windows are cut by the horizon and
    episodes end; once as configured by default and once at
    ``mem_budget_frac`` 0.3 with the headroom entry. Returns the largest
    |diff|."""
    from repro_torch.core import controller as ctl, queue_sim as qs
    from repro_torch.train import policy as pol

    n = 28
    codes = tuple(sorted(qs.SCENARIO_CODES.values()))
    w_idx = (0, 4, 7)                       # W = 1, 16, 128
    actions = [[ctl.encode_action(w_idx[(i + e) % 3], (i * e) % 4, 3)
                for e in range(n)] for i in range(ENV_CHECK_STEPS)]
    worst, n_tensors = 0.0, 0
    for mem, headroom in ((0.0, False), (0.3, True)):
        cfg = qs.QueueEnvConfig(n_epochs=4, steps_per_epoch=32,
                                scenario_pool=codes, mem_budget_frac=mem,
                                observe_headroom=headroom)

        def outputs(dev):
            draws = fixed_draws(torch, qs.Draws, dev, cover_pool=True)
            state = qs.reset(cfg, draws,
                             pol.make_params_pool([theta] * n, device=dev))
            out = {"reset obs": state.obs}
            cuts = 0
            for i, a in enumerate(actions):
                a = torch.as_tensor(a, device=dev)
                window = ctl.decode_action_t(a, 3)[0]
                cuts += int(((state.step_pos + window) > cfg.total_steps)
                            .sum())
                state, obs, reward, done = qs.step(cfg, state, a, draws)
                for k, v in (("obs", obs), ("reward", reward),
                             ("done", done)):
                    out[f"step {i} {k}"] = v.float()
                for k in ("total_energy", "total_time", "util_state",
                          "delta_level", "backlog", "rb_backlog",
                          "shared_backlog"):
                    out[f"step {i} {k}"] = getattr(state, k)
            out["codes"] = state.scenario.kind.float()
            return out, cuts

        (card, cuts), (cpu, _) = outputs(device), outputs(torch.device("cpu"))
        require(sorted(set(cpu["codes"].long().tolist())) == list(codes),
                "queue card vs CPU: a scenario code did not run")
        require(cuts > 0, "queue card vs CPU: no window cut by the horizon")
        require(card["reset obs"].shape[1] == ctl.state_dim(3, headroom),
                "queue card vs CPU: the state's size")
        for k, want in cpu.items():
            # a step of a finished episode runs no step of its window, and
            # its observation divides 0 by 0 as the reference's does
            got = card[k].cpu()
            both_nan = torch.isnan(got) & torch.isnan(want)
            err = float((got - want).abs().masked_fill(both_nan, 0).max())
            worst = max(worst, err)
            require(torch.allclose(got, want, equal_nan=True, **TOL_POLICY),
                    f"queue card vs CPU (mem {mem}): {k} max |diff| "
                    f"{err:.3e}")
        n_tensors += len(cpu)
        log(f"queue card vs CPU, mem_budget_frac {mem}, headroom "
            f"{headroom}: reset and {ENV_CHECK_STEPS} steps of {n} envs (all "
            f"14 codes, W "
            f"= 1/16/128, {cuts} windows cut by the horizon) within rtol "
            f"{TOL_POLICY['rtol']}, atol {TOL_POLICY['atol']}")
    log(f"queue card vs CPU: {n_tensors} tensors; max |diff| {worst:.3e}")
    return worst


def to_device(x, device):
    """Tensors, tuples and dataclasses of tensors (nested) on ``device``."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return x.to(device)


def queue_window_operands(torch, device, theta, n_owners, codes, windows,
                          mem=0.0, seed=SEED):
    """A batch of windows as the env hands them to the kernel, one env a
    (code, W) pair: carried fabric states, step positions across the run,
    eff_window W but cut for some envs (to W/2, to 0). Returns (cfg,
    params, scenario, Volumes, FabricState, uniforms, window, eff_window,
    step_pos) on ``device``, drawn on the CPU."""
    from repro_torch.core import controller as ctl, queue_sim as qs
    from repro_torch.train import policy as pol

    g = torch.Generator().manual_seed(seed)
    cfg = qs.QueueEnvConfig(n_owners=n_owners, n_epochs=30,
                            steps_per_epoch=32, mem_budget_frac=mem)
    code = torch.as_tensor(codes).repeat_interleave(len(windows))
    window = torch.as_tensor(windows, dtype=torch.float32).repeat(len(codes))
    n = code.shape[0]
    draws = qs.Draws(g)
    sc = qs.sample_scenario(draws.scenario(cfg, n), draws.profile(cfg, n),
                            code, cfg.total_steps, n_owners)
    alloc = torch.randint(0, n_owners + 1, (n,), generator=g)
    weights = ctl.allocation_weights_t(alloc, n_owners)
    step_pos = torch.floor(torch.rand(n, generator=g) * cfg.total_steps)
    eff = window.clone()
    eff[3::5] = torch.floor(window[3::5] / 2)
    eff[4::7] = 0.0
    carried = ((torch.rand((n, n_owners), generator=g) < 0.5).float(),
               40 * torch.rand((n, n_owners), generator=g),
               0.05 * torch.rand((n, n_owners), generator=g),
               0.05 * torch.rand((n, n_owners), generator=g),
               0.05 * torch.rand(n, generator=g))
    uniforms = draws.window(cfg, n)
    sc, window, weights, step_pos, eff, uniforms, carried = to_device(
        (sc, window, weights, step_pos, eff, uniforms, carried), device)
    params = pol.make_params_pool([theta] * n, device=device)
    _, vol, fabric = qs.window_operands(cfg, params, window, weights,
                                        *carried)
    return (cfg, params, sc, vol, fabric, uniforms, window, eff, step_pos)


def queue_kernel_vs_plain(torch, device, theta):
    """The ``queue_window`` kernel against its plain version on the card,
    on the same operands: every scenario code at every W, at P = 3 (the
    path's), 1, 2, 4, 8 and 16 (the kernel's other instances), and P = 3
    under ``mem_budget_frac`` 0.3; every output within ``TOL_POLICY``; a
    relaunch bit-identical. Returns the largest |diff|."""
    import dataclasses

    from repro_torch.core import cost_model as cm, queue_sim as qs
    from repro_torch.kernels.queue_window import ops as qw

    codes = sorted(qs.SCENARIO_CODES.values())
    worst = 0.0
    for p, mem in ((3, 0.0), (3, 0.3), (1, 0.0), (2, 0.0), (4, 0.0),
                   (8, 0.0), (16, 0.0)):
        args = queue_window_operands(torch, device, theta, p, codes,
                                     cm.WINDOW_CHOICES, mem=mem)
        acc_k, fab_k = qw.queue_window(*args)
        acc_k2, fab_k2 = qw.queue_window(*args)
        acc_p, fab_p = qw.queue_window_plain(*args)
        got = {**acc_k, **dataclasses.asdict(fab_k)}
        again = {**acc_k2, **dataclasses.asdict(fab_k2)}
        want = {**acc_p, **dataclasses.asdict(fab_p)}
        for k, v in want.items():
            err = float((got[k] - v).abs().max())
            worst = max(worst, err)
            require(torch.allclose(got[k], v, **TOL_POLICY),
                    f"queue_window P={p} mem {mem}: {k} max |diff| "
                    f"{err:.3e} against the plain version")
            require(torch.equal(got[k], again[k]),
                    f"queue_window P={p}: {k} differs between launches")
        require(torch.equal(acc_k["n"], args[7]),
                f"queue_window P={p}: live steps != eff_window")
        log(f"queue_window P={p} mem {mem}: {len(codes)} codes x "
            f"{len(cm.WINDOW_CHOICES)} windows ({args[6].shape[0]} envs, "
            f"{int(args[7].sum())} live steps) within rtol "
            f"{TOL_POLICY['rtol']}, atol {TOL_POLICY['atol']} of the plain "
            f"version, relaunch identical")
    log(f"queue_window against plain: max |diff| {worst:.3e}")
    return worst


def phase_queue(torch, device, smi, pools):
    """The queue env on the card: card against CPU, the kernel against
    its plain version, then ``get_or_train_policy(env="queue")`` on the
    analytic pool (``POLICY_ENVS`` envs, ``QUEUE_ITERS`` iterations, the
    default scenario pool), its kernel launches counted, and held-out
    whole episodes under the paper schedule and bursty Markov load.
    Returns the queue-trained qnet and what the timing row needs."""
    import dataclasses
    import tempfile

    from repro_torch.core import controller as ctl, cost_model as cm, dqn
    from repro_torch.core import queue_sim as qs
    from repro_torch.kernels.queue_window import ops as qw
    from repro_torch.train import policy as pol

    pool = pools["analytic"]
    theta = cm.CostModelParams(**{
        f.name: float(getattr(pool, f.name)[0])
        for f in dataclasses.fields(pool)})
    queue_card_vs_cpu(torch, device, theta)
    err = queue_kernel_vs_plain(torch, device, theta)

    with tempfile.TemporaryDirectory() as tmp:
        cached, pol.ARTIFACT_DIR = pol.ARTIFACT_DIR, tmp
        try:
            torch.cuda.synchronize()
            qw.queue_window.launches = 0
            t0 = time.perf_counter()
            _, qnet = pol.get_or_train_policy(
                pool, name="smoke", iterations=QUEUE_ITERS, force=True,
                env="queue", device=str(device), n_envs=POLICY_ENVS,
                seed=SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = qw.queue_window.launches
            with open(pathlib.Path(tmp) / "smoke_queue.json") as f:
                meta = json.load(f)
        finally:
            pol.ARTIFACT_DIR = cached
    log(f"policy queue: {QUEUE_ITERS} iterations x {POLICY_ENVS} envs on "
        f"the card in {wall:.2f} s ({QUEUE_ITERS / wall:.1f} iterations/s, "
        f"artifact write included), {meta['episodes']} episodes, "
        f"{meta['grad_steps']} gradient steps, mean reward of the last 200 "
        f"iterations {meta['final_reward']:.4f}; queue_window launches "
        f"{launches} ({launches / QUEUE_ITERS:.4f} an iteration); {smi}")
    require(meta["grad_steps"] > 0 and meta["episodes"] > 0,
            "policy queue: no gradient step or episode")
    # a probe window at the first reset, then a step and a reset's probe
    # window every iteration
    require(launches == 2 * QUEUE_ITERS + 1,
            f"policy queue: {launches} queue_window launches, not 2 an "
            f"iteration + 1")

    fresh = dqn.init_qnet(torch.Generator().manual_seed(99), 23, 32,
                          device=device)
    policies = {"trained": dqn.greedy_policy(qnet),
                "fresh": dqn.greedy_policy(fresh)}
    for w in (2, 16):
        a = ctl.encode_action(cm.WINDOW_CHOICES.index(w), 0, 3)
        policies[f"static W={w}"] = (
            lambda obs, a=a: torch.full((obs.shape[0],), a,
                                        device=obs.device))
    returns = {name: [] for name in policies}
    for code in ("paper_schedule", "bursty_markov"):
        cfg = qs.QueueEnvConfig(steps_per_epoch=32, n_epochs=30,
                                scenario_pool=(qs.SCENARIO_CODES[code],))
        for name, fn in policies.items():
            energy, ret = held_out(torch, device, "queue", pool, fn, cfg=cfg)
            returns[name].append(ret)
            log(f"  held-out queue {code} {name}: energy (J) "
                f"{_fmt(energy)}, discounted return {_fmt(ret)}")
    mean = {k: float(torch.cat(v).mean()) for k, v in returns.items()}
    log(f"policy queue: held-out mean discounted return {mean}; {smi}")
    require(mean["trained"] > mean["fresh"],
            "policy queue: the trained policy's discounted return does not "
            "beat the fresh qnet's on the held-out episodes")
    return qnet, {"launches": launches, "iterations": QUEUE_ITERS,
                  "max_abs_err": err, "theta": theta}


def queue_window_timing_row(torch, device, info):
    """The kernel at 32 envs and W = 128 (the training's batch at its
    longest window), by CUDA events as the other rows; its plain version
    on the same operands; the bound from the bytes the operands and
    outputs weigh and the operations of this batch's live steps."""
    from repro_torch.core import queue_sim as qs
    from repro_torch.kernels.queue_window import ops as qw

    timer = Timer(torch, device)
    codes = sorted(qs.default_training_pool())
    codes = (codes * 3)[:POLICY_ENVS]
    args = queue_window_operands(torch, device, info["theta"], 3, codes,
                                 (128,), seed=SEED + 1)
    cfg, params, sc, vol, fabric, uniforms, window, eff, pos = args
    eff = window.clone()                      # every step live
    args = args[:7] + (eff, pos)
    scal, ints, own, state = qw.pack(cfg, params, sc, vol, fabric, window,
                                     eff, pos)
    n, p = fabric.backlog.shape
    acc = torch.empty((n, len(qw.ACC)), device=device)
    acc_own = torch.empty((n, len(qw.ACC_OWNERS), p), device=device)
    state_out = torch.empty_like(state)
    before = qw.queue_window.launches
    ms = timer.ms(lambda: qw.launch(scal, ints, own, state, uniforms, acc,
                                    acc_own, state_out, cfg.n_epochs,
                                    cfg.steps_per_epoch))
    qw.queue_window.launches = before
    plain = timer.ms(lambda: qw.queue_window_plain(*args), repeats=5,
                     warm=1)
    n_bytes = sum(t.numel() * t.element_size() for t in (
        scal, ints, own, state, uniforms, acc, acc_own, state_out))
    # per live step: ~60 operations an env and ~75 an owner (the two
    # processes, utilization, delay, phi, both step costs, the drain, the
    # accumulators), counted from the kernel's source
    live = float(eff.clamp(max=qw.MAX_WINDOW).sum())
    n_flops = live * (60 + 75 * p)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"time queue_window n={n} P={p} W=128: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {n_bytes / 1e3:.1f} "
        f"KB, {n_flops:.4g} operations), kernel / bound "
        f"{ms / b_ms:.0f}x; {smi_line()}")
    # the reference's batch: 64 envs, a block each
    args64 = queue_window_operands(torch, device, info["theta"], 3,
                                   (codes * 6)[:2 * POLICY_ENVS], (128,),
                                   seed=SEED + 1)
    args64 = args64[:7] + (args64[6].clone(), args64[8])
    packed = qw.pack(*args64[:5], args64[6], args64[7], args64[8])
    out64 = (torch.empty((2 * n, len(qw.ACC)), device=device),
             torch.empty((2 * n, len(qw.ACC_OWNERS), p), device=device),
             torch.empty_like(packed[3]))
    ms64 = timer.ms(lambda: qw.launch(*packed, args64[5], *out64,
                                      cfg.n_epochs, cfg.steps_per_epoch))
    qw.queue_window.launches = before
    log(f"time queue_window n={2 * n} P={p} W=128: kernel {ms64:.4f} ms "
        f"({ms64 / ms:.2f}x the {n}-env launch); {smi_line()}")
    return {
        "name": "queue_window", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/queue_window.cu",
        "replaces": "src/repro/core/queue_sim.py:654 (lax.scan of substep; "
                    "no pl.pallas_call)",
        "launches": info["launches"], "max_abs_err": info["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "launches_per_iteration": info["launches"] / info["iterations"],
    }


# ------------------------------------------------- the cluster-env phase
def cluster_env_cfg(n_owners=3, **kw):
    """The cluster env at ``n_owners + 1`` ranks, 30 epochs of 32 steps
    (``train_policy``'s), every peer count and archetype in its pools."""
    from repro_torch.envs import cluster_sim as cs

    return cs.ClusterEnvConfig(**dict(dict(
        n_parts=n_owners + 1, steps_per_epoch=32, n_epochs=30,
        peer_pool=tuple(range(n_owners + 1))), **kw))


def cluster_window_operands(torch, device, theta, n_owners, windows,
                            mem=0.0, sync="allreduce", policy="mixed",
                            seed=SEED, clean=False):
    """A batch of cluster windows as the env hands them to the kernel:
    one env for each (archetype, live peers, W), the injected overlay
    cycling through every queue code, carried fabric and peer states
    (some peers at their rebuild boundary), eff_window W but cut for some
    envs. ``clean`` makes every env the zero-peer clean configuration.
    Returns (cfg, the ego's params, the overlay scenario, Volumes,
    FabricState, Peers, PeerState, uniforms, window, eff_window, step_pos)
    on ``device``, drawn on the CPU."""
    import dataclasses

    from repro_torch.core import controller as ctl, queue_sim as qs
    from repro_torch.envs import cluster_sim as cs
    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.train import policy as pol

    g = torch.Generator().manual_seed(seed)
    cfg = cluster_env_cfg(n_owners, mem_budget_frac=mem, sync=sync,
                          peer_policy=policy)
    n_kinds, n_peers = cs.N_CLUSTER, n_owners + 1
    kinds = torch.arange(n_kinds).repeat_interleave(n_peers * len(windows))
    peers = torch.arange(n_peers).repeat_interleave(len(windows)).repeat(
        n_kinds)
    window = torch.as_tensor(windows, dtype=torch.float32).repeat(
        n_kinds * n_peers)
    n = window.shape[0]
    if clean:
        kinds, peers = torch.zeros_like(kinds), torch.zeros_like(peers)
    draws = qs.Draws(g)
    u = draws.scenario(cfg, n)
    u = dataclasses.replace(u, pool_idx=torch.arange(n) % len(
        cfg.scenario_pool))
    c = dataclasses.replace(cs.ClusterDraws(g).cluster(cfg, n),
                            kind_idx=kinds, peers_idx=peers)
    sc = cs.sample_scenario(u, draws.profile(cfg, n), c, cfg)
    alloc = torch.randint(0, n_owners + 1, (n,), generator=g)
    weights = ctl.allocation_weights_t(alloc, n_owners)
    step_pos = torch.floor(torch.rand(n, generator=g) * cfg.total_steps)
    eff = window.clone()
    eff[3::5] = torch.floor(window[3::5] / 2)
    eff[4::7] = 0.0
    carried = ((torch.rand((n, n_owners), generator=g) < 0.5).float(),
               40 * torch.rand((n, n_owners), generator=g),
               0.05 * torch.rand((n, n_owners), generator=g),
               0.05 * torch.rand((n, n_owners), generator=g),
               0.05 * torch.rand(n, generator=g))
    peer_state = cw.PeerState(
        0.05 * torch.rand((n, n_owners), generator=g) * (peers > 0)[:, None],
        torch.randint(-1, 24, (n,), generator=g).float(),
        torch.randint(4, 33, (n,), generator=g).float())
    uniforms = draws.window(cfg, n)
    sc, window, weights, step_pos, eff, uniforms, carried, peer_state = \
        to_device((sc, window, weights, step_pos, eff, uniforms, carried,
                   peer_state), device)
    params = pol.make_params_pool([theta] * n, device=device)
    ego = dataclasses.replace(params, t_base=params.t_base * sc.ego_compute)
    _, vol, fabric = qs.window_operands(cfg, ego, window, weights, *carried,
                                        demand=sc.demand_skew)
    return (cfg, ego, sc.base, vol, fabric, cs.peer_operands(cfg, params, sc),
            peer_state, uniforms, window, eff, step_pos)


def cluster_kernel_vs_plain(torch, device, theta):
    """The ``cluster_window`` kernel against its plain version on the card,
    on the same operands: every archetype, every live-peer count, every
    W and every queue code, at P = 3 (the path's), 1, 2, 4, 8 and 16, and
    P = 3 under ``mem_budget_frac`` 0.3; each of those in three batches
    (the sync modes, with the static, reactive and mixed peers); every
    output within ``TOL_POLICY``, a relaunch bit-identical, live steps =
    eff_window. Returns the largest |diff|."""
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels.cluster_window import ops as cw

    worst = 0.0
    batches = (("allreduce", "static"), ("reduce_scatter", "greendygnn"),
               ("none", "mixed"))
    for p, mem in ((3, 0.0), (3, 0.3), (1, 0.0), (2, 0.0), (4, 0.0),
                   (8, 0.0), (16, 0.0)):
        n_env = live = 0
        for b, (sync, policy) in enumerate(batches):
            args = cluster_window_operands(
                torch, device, theta, p, cm.WINDOW_CHOICES, mem=mem,
                sync=sync, policy=policy, seed=SEED + b)
            got = cw.as_dict(*cw.cluster_window(*args))
            again = cw.as_dict(*cw.cluster_window(*args))
            want = cw.as_dict(*cw.cluster_window_plain(*args))
            for k, v in want.items():
                err = float((got[k] - v).abs().max())
                worst = max(worst, err)
                require(torch.allclose(got[k], v, **TOL_POLICY),
                        f"cluster_window P={p} mem {mem} {sync}/{policy}: "
                        f"{k} max |diff| {err:.3e} against the plain version")
                require(torch.equal(got[k], again[k]),
                        f"cluster_window P={p}: {k} differs between launches")
            require(torch.equal(got["n"], args[9]),
                    f"cluster_window P={p}: live steps != eff_window")
            n_env += args[8].shape[0]
            live += int(args[9].sum())
        log(f"cluster_window P={p} mem {mem}: 4 archetypes x {p + 1} peer "
            f"counts x {len(cm.WINDOW_CHOICES)} windows, 3 sync modes and "
            f"peer policies ({n_env} envs, {live} live steps) within rtol "
            f"{TOL_POLICY['rtol']}, atol {TOL_POLICY['atol']} of the plain "
            f"version, relaunch identical")
    log(f"cluster_window against plain: max |diff| {worst:.3e}")
    return worst


def equal_or_both_nan(torch, a, b) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def cluster_reduction_on_card(torch, device, theta):
    """With no live peer and clean factors: the ``cluster_window`` kernel's
    outputs ``torch.equal`` to the ``queue_window`` kernel's on the same
    operands (every queue code, every W, P = 3 and 8, and P = 3 under the
    memory spill), and a card episode of the cluster env (reset and 12
    steps of 28 envs) equal to the queue env's on the same draws, bit for
    bit (a finished episode's 0 / 0 is NaN on both sides)."""
    from repro_torch.core import controller as ctl, cost_model as cm
    from repro_torch.core import queue_sim as qs
    from repro_torch.envs import cluster_sim as cs
    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.kernels.queue_window import ops as qw
    from repro_torch.train import policy as pol

    for p, mem in ((3, 0.0), (3, 0.3), (8, 0.0)):
        args = cluster_window_operands(torch, device, theta, p,
                                       cm.WINDOW_CHOICES, mem=mem,
                                       clean=True)
        cfg, ego, sc, vol, fabric, peers, peer_state = args[:7]
        require(float(peers.n_live.sum()) == 0.0
                and bool((peers.link_scale == 1).all()),
                "cluster reduction: the operands have live peers")
        qcfg = qs.QueueEnvConfig(n_owners=p, n_epochs=cfg.n_epochs,
                                 steps_per_epoch=cfg.steps_per_epoch,
                                 mem_budget_frac=mem)
        acc_c, fab_c, ps_c = cw.cluster_window(*args)
        acc_q, fab_q = qw.queue_window(qcfg, ego, sc, vol, fabric,
                                       *args[7:])
        got = cw.as_dict(acc_c, fab_c, ps_c)
        want = cw.as_dict(acc_q, fab_q, cw.PeerState(
            torch.zeros_like(fab_q.backlog), ps_c.peer_left,
            ps_c.peer_window))
        for k, v in want.items():
            require(torch.equal(got[k], v),
                    f"cluster reduction P={p} mem {mem}: {k} of the "
                    "cluster_window kernel differs from queue_window's")
    n = 28
    codes = tuple(sorted(qs.SCENARIO_CODES.values()))
    ccfg = cs.ClusterEnvConfig(n_parts=4, n_epochs=4, steps_per_epoch=32,
                               scenario_pool=codes, peer_pool=(0,),
                               cluster_pool=(0,))
    qcfg = qs.QueueEnvConfig(n_owners=3, n_epochs=4, steps_per_epoch=32,
                             scenario_pool=codes)
    params = pol.make_params_pool([theta] * n, device=device)
    gc_, gq = (torch.Generator(device=device).manual_seed(SEED + 5)
               for _ in range(2))
    dc, dq = cs.ClusterDraws(gc_), qs.Draws(gq)
    sc_, sq = cs.reset(ccfg, dc, params), qs.reset(qcfg, dq, params)
    require(torch.equal(sc_.obs, sq.obs),
            "cluster reduction episode: reset observations differ")
    actions = torch.Generator().manual_seed(SEED + 6)
    for i in range(12):
        a = torch.randint(0, ctl.n_actions(3), (n,),
                          generator=actions).to(device)
        sc_, oc, rc, d_c = cs.step(ccfg, sc_, a, dc)
        sq, oq, rq, d_q = qs.step(qcfg, sq, a, dq)
        for k, x, y in (("obs", oc, oq), ("reward", rc, rq),
                        ("backlog", sc_.backlog, sq.backlog),
                        ("rb_backlog", sc_.rb_backlog, sq.rb_backlog),
                        ("total_energy", sc_.total_energy, sq.total_energy),
                        ("total_time", sc_.total_time, sq.total_time)):
            require(equal_or_both_nan(torch, x, y),
                    f"cluster reduction episode: step {i} {k} differs from "
                    "the queue env's")
        require(torch.equal(d_c, d_q), f"cluster reduction episode: step "
                f"{i} done differs")
    log(f"cluster reduction on the card: cluster_window == queue_window "
        f"(torch.equal) at zero peers (P = 3, 8; the spill), and a {n}-env "
        f"episode (reset, 12 steps, {int(d_c.sum())} finished) equal to the "
        f"queue env's bit for bit")


def cluster_card_vs_cpu(torch, device, theta):
    """The cluster env's reset and ``ENV_CHECK_STEPS`` steps of 28 envs on
    the card against
    the same calls on the CPU (the plain version), draws fixed on the host:
    every queue code and archetype runs, live peers 0 to 3, the actions
    cycling W = 1, 16 and 128; once by default and once at
    ``mem_budget_frac`` 0.3 with the headroom entry. Returns the largest
    |diff|."""
    from repro_torch.core import controller as ctl, queue_sim as qs
    from repro_torch.envs import cluster_sim as cs
    from repro_torch.train import policy as pol

    n = 28
    codes = tuple(sorted(qs.SCENARIO_CODES.values()))
    w_idx = (0, 4, 7)
    actions = [[ctl.encode_action(w_idx[(i + e) % 3], (i * e) % 4, 3)
                for e in range(n)] for i in range(ENV_CHECK_STEPS)]
    worst = 0.0
    for mem, headroom in ((0.0, False), (0.3, True)):
        cfg = cluster_env_cfg(3, n_epochs=4, scenario_pool=codes,
                              mem_budget_frac=mem, observe_headroom=headroom)

        def outputs(dev):
            draws = fixed_draws(torch, cs.ClusterDraws, dev, cover_pool=True)
            state = cs.reset(cfg, draws,
                             pol.make_params_pool([theta] * n, device=dev))
            out = {"reset obs": state.obs}
            for i, a in enumerate(actions):
                state, obs, reward, done = cs.step(
                    cfg, state, torch.as_tensor(a, device=dev), draws)
                for k, v in (("obs", obs), ("reward", reward),
                             ("done", done)):
                    out[f"step {i} {k}"] = v.float()
                for k in ("total_energy", "total_time", "backlog",
                          "rb_backlog", "shared_backlog", "peer_backlog",
                          "peer_left", "peer_window"):
                    out[f"step {i} {k}"] = getattr(state, k)
            out["kinds"] = state.scenario.cluster_kind.float()
            out["peers"] = state.scenario.n_peers.float()
            return out

        card, cpu = outputs(device), outputs(torch.device("cpu"))
        require(sorted(set(cpu["kinds"].long().tolist())) == [0, 1, 2, 3]
                and sorted(set(cpu["peers"].long().tolist())) == [0, 1, 2, 3],
                "cluster card vs CPU: an archetype or peer count did not run")
        for k, want in cpu.items():
            got = card[k].cpu()
            both_nan = torch.isnan(got) & torch.isnan(want)
            err = float((got - want).abs().masked_fill(both_nan, 0).max())
            worst = max(worst, err)
            require(torch.allclose(got, want, equal_nan=True, **TOL_POLICY),
                    f"cluster card vs CPU (mem {mem}): {k} max |diff| "
                    f"{err:.3e}")
        log(f"cluster card vs CPU, mem_budget_frac {mem}, headroom "
            f"{headroom}: reset and {ENV_CHECK_STEPS} steps of {n} envs (14 "
            f"codes, 4 "
            f"archetypes, 0-3 live peers, W = 1/16/128) within rtol "
            f"{TOL_POLICY['rtol']}, atol {TOL_POLICY['atol']}")
    log(f"cluster card vs CPU: max |diff| {worst:.3e}")
    return worst


def phase_cluster_env(torch, device, smi, pools):
    """The cluster env on the card: card against CPU, the kernel against
    its plain version, the zero-peer reduction, then
    ``train_policy(env="cluster", n_workers=4)`` through
    ``get_or_train_policy`` on the analytic pool (``POLICY_ENVS`` envs,
    ``POLICY_ITERS`` iterations), its kernel launches counted, and
    held-out whole episodes. Returns the cluster-trained qnet and what the
    timing row needs."""
    import dataclasses
    import tempfile

    from repro_torch.core import controller as ctl, cost_model as cm, dqn
    from repro_torch.envs import cluster_sim as cs
    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.train import policy as pol

    t_phase = time.perf_counter()
    pool = pools["analytic"]
    theta = cm.CostModelParams(**{
        f.name: float(getattr(pool, f.name)[0])
        for f in dataclasses.fields(pool)})
    cluster_card_vs_cpu(torch, device, theta)
    err = cluster_kernel_vs_plain(torch, device, theta)
    cluster_reduction_on_card(torch, device, theta)
    t_checks = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory() as tmp:
        cached, pol.ARTIFACT_DIR = pol.ARTIFACT_DIR, tmp
        try:
            torch.cuda.synchronize()
            cw.cluster_window.launches = 0
            t0 = time.perf_counter()
            _, qnet = pol.get_or_train_policy(
                pool, name="smoke", iterations=POLICY_ITERS, force=True,
                env="cluster", n_workers=CLUSTER_P, device=str(device),
                n_envs=POLICY_ENVS, seed=SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cw.cluster_window.launches
            with open(pathlib.Path(tmp)
                      / f"smoke_cluster_p{CLUSTER_P}.json") as f:
                meta = json.load(f)
        finally:
            pol.ARTIFACT_DIR = cached
    log(f"policy cluster (P={CLUSTER_P}): {POLICY_ITERS} iterations x "
        f"{POLICY_ENVS} envs on the card in {wall:.2f} s "
        f"({POLICY_ITERS / wall:.1f} iterations/s, artifact write "
        f"included), {meta['episodes']} episodes, {meta['grad_steps']} "
        f"gradient steps, mean reward of the last 200 iterations "
        f"{meta['final_reward']:.4f}; cluster_window launches {launches} "
        f"({launches / POLICY_ITERS:.4f} an iteration); {smi}")
    require(meta["grad_steps"] > 0 and meta["episodes"] > 0,
            "policy cluster: no gradient step or episode")
    require(launches == 2 * POLICY_ITERS + 1,
            f"policy cluster: {launches} cluster_window launches, not 2 an "
            "iteration + 1")

    fresh = dqn.init_qnet(torch.Generator().manual_seed(99), 23, 32,
                          device=device)
    policies = {"trained": dqn.greedy_policy(qnet),
                "fresh": dqn.greedy_policy(fresh)}
    for w in (2, 16):
        a = ctl.encode_action(cm.WINDOW_CHOICES.index(w), 0, 3)
        policies[f"static W={w}"] = (
            lambda obs, a=a: torch.full((obs.shape[0],), a,
                                        device=obs.device))
    returns = {name: [] for name in policies}
    for label, kw in (("default pools", {}),
                      ("full fleet, hot owner", {
                          "peer_pool": (3,),
                          "cluster_pool": (cs.CLUSTER_CODES["hot_owner"],)})):
        cfg = training_cfg("cluster", **kw)
        for name, fn in policies.items():
            energy, ret = held_out(torch, device, "cluster", pool, fn,
                                   cfg=cfg)
            returns[name].append(ret)
            log(f"  held-out cluster {label} {name}: energy (J) "
                f"{_fmt(energy)}, discounted return {_fmt(ret)}")
    mean = {k: float(torch.cat(v).mean()) for k, v in returns.items()}
    log(f"policy cluster: held-out mean discounted return {mean}; checks "
        f"{t_checks:.1f} s, phase {time.perf_counter() - t_phase:.1f} s; "
        f"{smi}")
    require(mean["trained"] > mean["fresh"],
            "policy cluster: the trained policy's discounted return does "
            "not beat the fresh qnet's on the held-out episodes")
    return qnet, {"launches": launches, "iterations": POLICY_ITERS,
                  "max_abs_err": err, "theta": theta}


def cluster_window_timing_row(torch, device, info):
    """The kernel at 32 envs, P = 3 and W = 128 (the training's batch at
    its longest window, every step live, every archetype and peer count),
    by CUDA events as the other rows; its plain version on the same
    operands; the bound from the bytes of the packed operands and outputs
    and the operations of this batch's live steps."""
    from repro_torch.kernels.cluster_window import ops as cw
    from repro_torch.kernels.queue_window import ops as qw

    timer = Timer(torch, device)
    # 4 archetypes x 4 peer counts x 2 windows = the training's 32 envs
    args = cluster_window_operands(torch, device, info["theta"], 3,
                                   (128, 128), seed=SEED + 1)
    cfg, ego, sc, vol, fabric, peers, peer_state, uniforms, window, eff, \
        pos = args
    eff = window.clone()                      # every step live
    args = args[:9] + (eff, pos)
    scal, ints, own, state = qw.pack(cfg, ego, sc, vol, fabric, window, eff,
                                     pos)
    pscal, pown = cw.pack_peers(ego, peers, peer_state)
    out = cw.outputs(state)
    n, p = fabric.backlog.shape
    before = cw.cluster_window.launches
    ms = timer.ms(lambda: cw.launch(scal, ints, own, state, uniforms, pscal,
                                    pown, *out, cfg.n_epochs,
                                    cfg.steps_per_epoch))
    cw.cluster_window.launches = before
    plain = timer.ms(lambda: cw.cluster_window_plain(*args), repeats=5,
                     warm=1)
    n_bytes = sum(t.numel() * t.element_size() for t in (
        scal, ints, own, state, uniforms, pscal, pown, *out))
    # per live step: the queue window's ~60 operations an env and ~75 an
    # owner, and the cluster's ~40 an env and ~25 an owner (the peers'
    # window and volumes, the barrier, the collective's energy, the
    # drain's peer term), counted from fluid_window.cuh
    live = float(eff.clamp(max=qw.MAX_WINDOW).sum())
    n_flops = live * (100 + 100 * p)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"time cluster_window n={n} P={p} W=128: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {n_bytes / 1e3:.1f} "
        f"KB, {n_flops:.4g} operations), kernel / bound "
        f"{ms / b_ms:.0f}x; {smi_line()}")
    # the reference's batch: 64 envs, a block each
    args64 = cluster_window_operands(torch, device, info["theta"], 3,
                                     (128,) * 4, seed=SEED + 1)
    cfg64, ego64, sc64, vol64, fab64, peers64, ps64, unif64, win64 = \
        args64[:9]
    packed = qw.pack(cfg64, ego64, sc64, vol64, fab64, win64, win64.clone(),
                     args64[10])
    pk64 = cw.pack_peers(ego64, peers64, ps64)
    out64 = cw.outputs(packed[3])
    ms64 = timer.ms(lambda: cw.launch(*packed, unif64, *pk64, *out64,
                                      cfg.n_epochs, cfg.steps_per_epoch))
    cw.cluster_window.launches = before
    log(f"time cluster_window n={out64[0].shape[0]} P={p} W=128: kernel "
        f"{ms64:.4f} ms ({ms64 / ms:.2f}x the {n}-env launch); "
        f"{smi_line()}")
    return {
        "name": "cluster_window", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cluster_window.cu",
        "replaces": "src/repro/envs/cluster_sim.py:545 (lax.scan of "
                    "substep; no pl.pallas_call)",
        "launches": info["launches"], "max_abs_err": info["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "launches_per_iteration": info["launches"] / info["iterations"],
    }



# -------------------------------------------- the cluster deployment phase
DEPLOY = dict(CLUSTER, warmup_epochs=1)     # 3 epochs of 8 steps
DEPLOY_SCENARIOS = (("clean", "clean", None),
                    ("paper_schedule", "paper_schedule", None),
                    ("hot owner 0.35", "clean", (0.35, 1.0, 1.0, 1.0)))
# epoch 0's joules a rank against the later epochs' [min, max]
EPOCH0_BAND = 0.15


def phase_cluster_deploy(torch, device, smi, qnets):
    """The cluster-trained policy deployed where the reference judges it:
    ``run_cluster`` with P = 4 ranks, the measured lane, batch 2000, 3
    epochs of 8 steps (1 of warmup), under ``clean``, ``paper_schedule``
    and partition 0's NIC at 0.35 of its rate; greendygnn under the
    cluster-trained policy, greendygnn under the queue-trained policy, and
    static_w, side by side. Each run's launch counts are held
    (``require_rank_counts``, the engine's untimed first runs included).
    Run first in a process of its own (``--deploy``), so that its first
    run, static_w under ``clean``, is the process's first use of the
    card's training kernels: that run's epoch 0 must cost, on every rank,
    within ``EPOCH0_BAND`` of the later epochs' joules. Returns {run
    label: {joules per rank-epoch, barrier wait, ...}}."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.core import controller as ctl, cost_model as cm, dqn
    from repro_torch.train import cluster as cl

    t_phase = time.perf_counter()
    cc = cl.ClusterConfig(n_workers=CLUSTER_P)
    decisions = []
    decide = ctl.AdaptiveController.decide

    def logged_decide(self, stats):
        out = decide(self, stats)
        decisions.append((threading.current_thread().name, int(out[0])))
        return out

    bundles = cl.build_cluster_traces(
        cluster_cfg("cpu", **DEPLOY), CLUSTER_P)
    methods = (("static_w", {"method": "static_w"}),
               ("greendygnn cluster-trained",
                {"method": "greendygnn",
                 "q_fn": dqn.q_fn_of(qnets["cluster"])}),
               ("greendygnn queue-trained",
                {"method": "greendygnn", "q_fn": dqn.q_fn_of(qnets["queue"])}))
    out = {}
    for scen_label, scenario, link in DEPLOY_SCENARIOS:
        for label, kw in methods:
            cfg = cluster_cfg(device, **dict(DEPLOY, scenario=scenario,
                                             **kw))
            ccs = dataclasses.replace(cc, link_rate_scale=link)
            decisions.clear()
            ctl.AdaptiveController.decide = logged_decide
            try:
                rep, counts, wall, swaps, per_step = counted_cluster(
                    torch, cfg, ccs, bundles)
            finally:
                ctl.AdaptiveController.decide = decide
            name = f"{label} {scen_label}"
            require_rank_counts(f"deploy {name}", rep, counts, swaps)
            log_cluster(f"deploy {name}", rep, counts, wall, per_step, smi)
            joules = np.array([[rank_epoch_joules(rep.results[r], e)
                                for e in range(cfg.n_epochs)]
                               for r in range(CLUSTER_P)])
            require(bool(np.all(np.isfinite(joules)) and np.all(joules > 0)),
                    f"deploy {name}: joules per rank-epoch {joules}")
            compiles = [rep.results[r].compute_report["n_compiles"]
                        for r in range(CLUSTER_P)]
            chosen = [[w for t, w in decisions
                       if t == f"trainer-worker-{r}"] for r in range(CLUSTER_P)]
            if kw["method"] == "greendygnn":
                for r, mine in enumerate(chosen):
                    require(len(mine) >= 1
                            and all(w in cm.WINDOW_CHOICES for w in mine),
                            f"deploy {name}: rank {r} decided {mine}")
            if not out:
                # the process's first run (static_w, clean: its epochs
                # cost alike): the card's first use must stay out of it
                later = joules[:, 1:]
                lo = later.min(1) * (1 - EPOCH0_BAND)
                hi = later.max(1) * (1 + EPOCH0_BAND)
                require(bool(np.all((joules[:, 0] >= lo)
                                    & (joules[:, 0] <= hi))),
                        f"deploy {name}: epoch 0 joules a rank "
                        f"{joules[:, 0].round(4).tolist()} outside the later "
                        f"epochs' band [{lo.round(4).tolist()}, "
                        f"{hi.round(4).tolist()}]")
                log(f"deploy {name} (first in its process): epoch 0 "
                    f"{joules[:, 0].round(4).tolist()} J a rank, within "
                    f"{EPOCH0_BAND:.0%} of the later epochs' "
                    f"[{later.min():.4f}, {later.max():.4f}]")
            out[name] = {
                "joules_per_rank_epoch": float(joules.mean()),
                "epoch0_j": joules[:, 0].tolist(),
                "later_j": joules[:, 1:].tolist(),
                "barrier_wait_s": float(np.sum(rep.sync_wait_s)),
                "windows": [rep.results[r].window_per_epoch.tolist()
                            for r in range(CLUSTER_P)],
                "decisions": chosen,
                "n_compiles": compiles,
                "compile_s": [rep.results[r].compute_report["compile_s"]
                              for r in range(CLUSTER_P)],
            }
            log(f"deploy {name}: {out[name]['joules_per_rank_epoch']:.4f} J "
                f"per rank-epoch (mean), barrier wait "
                f"{out[name]['barrier_wait_s']:.6f} s over the ranks, "
                f"decisions by rank {chosen}, mean window per epoch by rank "
                f"{out[name]['windows']}, "
                f"untimed first runs {compiles} a rank "
                f"({max(out[name]['compile_s']):.3f} s at most); {smi}")
    for scen_label, _, _ in DEPLOY_SCENARIOS:
        row = {label: round(out[f"{label} {scen_label}"]
                            ["joules_per_rank_epoch"], 4)
               for label, _ in methods}
        log(f"deploy {scen_label}: joules per rank-epoch {row}")
    log(f"deploy phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def run_deploy_process(torch, qnets):
    """``phase_cluster_deploy`` in a fresh process (this script with
    ``--deploy``), the qnets passed as files; its log lines go to this
    process's output. Returns its results."""
    import tempfile

    from repro_torch.core import dqn

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, qnet in qnets.items():
            dqn.save_qnet(str(pathlib.Path(tmp) / f"{name}.npz"), qnet)
        sys.stdout.flush()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--deploy", tmp], timeout=600)
        require(proc.returncode == 0,
                f"the deployment process exited {proc.returncode}")
        with open(pathlib.Path(tmp) / "deploy.json") as f:
            out = json.load(f)
    return out


def deploy_main(torch, device, tmp) -> int:
    """The ``--deploy DIR`` entry: the deployment phase first in this
    process, on the qnets in DIR; its results to DIR/deploy.json."""
    from repro_torch.core import dqn

    smi = smi_line()
    qnets = {name: dqn.load_qnet(str(pathlib.Path(tmp) / f"{name}.npz"),
                                 device=device)
             for name in ("cluster", "queue")}
    out = phase_cluster_deploy(torch, device, smi, qnets)
    with open(pathlib.Path(tmp) / "deploy.json", "w") as f:
        json.dump(out, f)
    return 0


# ------------------------------------------------------- the step gate
GATE_STALL_S = 0.05     # the host stall the gated event pair must not time


def phase_step_gate(torch, device) -> float:
    """``csrc/step_gate.cu`` against its plain version, and what it is
    for. An open gate (the flag already holding the token) writes the
    token, a closed one with a 2 ms timeout writes minus the token, as
    ``step_gate_plain`` gives both; ``StepGate.check`` raises on the
    second. Then an event pair around two short kernels with a
    ``GATE_STALL_S`` host stall between them: without the gate it times
    the stall, behind a closed gate opened after the end event it must
    time the kernels only. Returns the largest |kernel - plain|."""
    from repro_torch.kernels.step_gate import ops as gate_ops

    words = torch.zeros(2, dtype=torch.int32, pin_memory=True)
    view = words.numpy()
    errs = []
    for token, flag, timeout_s in ((7, 7, 1.0), (8, 0, 0.002)):
        view[:] = (flag, 0)
        gate_ops.step_gate(words, token, device, timeout_s)
        torch.cuda.synchronize()
        got = int(view[gate_ops.STATUS])
        view[:] = (flag, 0)
        gate_ops.step_gate_plain(words, token)
        want = int(view[gate_ops.STATUS])
        errs.append(abs(got - want))
        require(got == want == (token if flag == token else -token),
                f"step_gate token {token}, flag {flag}: kernel {got}, "
                f"plain {want}")
    gate = gate_ops.StepGate(device, timeout_s=0.002)
    gate.close()
    torch.cuda.synchronize()
    try:
        gate.check()
        raise SmokeError("StepGate.check passed a gate that timed out")
    except RuntimeError as e:
        log(f"step_gate: a gate left closed timed out and check raised: {e}")

    def bracket(gated: bool) -> float:
        g = gate_ops.StepGate(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if gated:
            g.close()
        start.record()
        torch.cuda._sleep(100_000)
        time.sleep(GATE_STALL_S)
        torch.cuda._sleep(100_000)
        end.record()
        if gated:
            g.open()
        end.synchronize()
        if gated:
            g.check()
        return start.elapsed_time(end)

    plain_ms, gated_ms = bracket(False), bracket(True)
    log(f"step_gate: two short kernels and a {GATE_STALL_S * 1e3:.0f} ms "
        f"host stall between them: events {plain_ms:.3f} ms ungated, "
        f"{gated_ms:.3f} ms behind the gate; kernel against plain "
        f"max |diff| {max(errs)}")
    require(plain_ms >= GATE_STALL_S * 1e3,
            f"the ungated events did not time the stall ({plain_ms} ms)")
    require(gated_ms < GATE_STALL_S * 1e3 / 5,
            f"the gated events timed the host stall ({gated_ms} ms)")
    return float(max(errs))


def step_gate_row(torch, device, launches: int, err: float) -> dict:
    """An open gate (a launch and one read of the host's flag) against its
    plain version on the same words; bound: the 8 bytes it moves."""
    from repro_torch.kernels.step_gate import ops as gate_ops

    timer = Timer(torch, device)
    words = torch.zeros(2, dtype=torch.int32, pin_memory=True)
    words.numpy()[gate_ops.FLAG] = 1
    ms = timer.ms(lambda: gate_ops.step_gate(words, 1, device))
    plain = timer.ms(lambda: gate_ops.step_gate_plain(words, 1))
    b_ms, b_by = bound_ms(8, 0)
    log(f"time step_gate (open): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b_ms:.7f} ms ({b_by}; 8 bytes); {launches} launches on "
        f"the main path; {smi_line()}")
    return {
        "name": "step_gate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/step_gate.cu",
        "replaces": "src/repro/train/compute.py:305 (no kernel: the "
                    "reference times its measured step as one compiled "
                    "executable)",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


# ------------------------------------------------------------- phase 3
def phase_main_path(torch, device, qnet):
    """The GreenDyGNN trainer's main path, its controller driven by
    ``qnet`` (the policy phase's table-trained qnet)."""
    import numpy as np

    from repro_torch.core import dqn
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.kernels.step_gate import step_gate
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    q_base = dqn.q_fn_of(qnet)
    decisions = []

    def q_fn(state):
        decisions.append(int(np.argmax(q_base(state))))
        return q_base(state)

    cfg = gt.RunConfig(**MAIN_PATH, q_fn=q_fn,
                       mem_budget=MemoryBudget(host_bytes=None,
                                               device_payloads=True),
                       device=str(device))
    bundle = gt.build_trace(cfg)
    with plans_swapped() as plans:
        csr_spmm.launches = 0
        embedding_bag.launches = 0
        step_gate.launches = 0
        t0 = time.perf_counter()
        res = gt.run(cfg, bundle)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"csr_spmm": csr_spmm.launches,
                  "embedding_bag": embedding_bag.launches,
                  "step_gate": step_gate.launches}
    kept = persisted_builds(plans)
    rep = res.compute_report
    n_steps = cfg.n_epochs * cfg.steps_per_epoch
    steps_with_hits = int((res.step_hits > 0).sum())
    log(f"main path: {n_steps} steps in {wall:.2f} s, windows "
        f"{res.window_per_epoch.tolist()}, hits {int(res.step_hits.sum())}, "
        f"misses {int(res.step_misses.sum())}, launches {counts}, "
        f"{len(plans)} rebuilds ({kept} carrying persisted rows), "
        f"decisions {decisions}")
    log(f"main path: losses {[round(x, 4) for x in rep['losses']]}")
    # 2 forward + 1 backward per step, 2 forward in the parity check, and
    # 3 in the engine's untimed first run of each new shape signature
    require(counts["csr_spmm"] == 3 * n_steps + 2 + 3 * rep["n_compiles"],
            f"csr_spmm launches {counts['csr_spmm']} != 3 per step + 2 + 3 "
            f"per untimed first run ({rep['n_compiles']})")
    # one gather a step with hits, one persisted-row gather a rebuild
    # that keeps rows of the active table
    require(steps_with_hits > 0
            and counts["embedding_bag"] == steps_with_hits + kept,
            f"embedding_bag launches {counts['embedding_bag']} != "
            f"{steps_with_hits} steps with hits + {kept} rebuilds with "
            "persisted rows")
    require(rep["n_steps"] == n_steps, "measured steps missing")
    # one gate a measured step; the untimed first runs are not gated
    require(counts["step_gate"] == n_steps,
            f"step_gate launches {counts['step_gate']} != {n_steps} "
            "measured steps")
    require(rep["parity_max_diff"] is not None
            and rep["parity_max_diff"] < 2e-3,
            f"parity_max_diff {rep['parity_max_diff']}")
    require(all(math.isfinite(x) for x in rep["losses"]), "non-finite loss")
    require(len(decisions) >= 1, "the controller never decided")
    step_ms = statistics.median(rep["step_s"]) * 1e3
    log(f"main path: parity_max_diff {rep['parity_max_diff']:.3e}, median "
        f"measured step {step_ms:.3f} ms, {rep['n_compiles']} untimed first "
        f"runs ({rep['compile_s']:.3f} s, agg_impl {rep['agg_impl']})")
    return counts, step_ms, n_steps


def phase_card_vs_cpu(torch, device):
    """A short static-window run on the card against the same run on the
    CPU (plain versions), from the same parameters."""
    import numpy as np

    from repro_torch.convert import sage_params_to_jax
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train.worker import TrainerWorker

    base = dict(MAIN_PATH, method="static_w", batch_size=600, n_epochs=2,
                warmup_epochs=1, steps_per_epoch=4, static_window=2)
    results = {}
    params0 = None
    for dev in (str(device), "cpu"):
        cfg = gt.RunConfig(**base, mem_budget=MemoryBudget(),
                           device=dev)
        w = TrainerWorker(cfg, gt.build_trace(cfg))
        if params0 is None:
            params0 = sage_params_to_jax(w.engine.params)
        w.engine.load_params(params0)
        for e in range(cfg.n_epochs):
            w.begin_epoch(e)
            for s in range(cfg.steps_per_epoch):
                w.step(e, s)
            w.end_epoch(e)
        results[dev] = w.result()
    a, b = results[str(device)], results["cpu"]
    for name in ("step_hits", "step_misses", "fetched_rows_by_owner",
                 "window_per_epoch"):
        require(np.array_equal(getattr(a, name), getattr(b, name)),
                f"card vs CPU: {name} differs")
    la = np.asarray(a.compute_report["losses"])
    lb = np.asarray(b.compute_report["losses"])
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    require(np.allclose(la, lb, rtol=1e-4, atol=0.0),
            f"card vs CPU losses rel diff {rel:.3e}")
    log(f"card vs CPU static_w run: discrete streams equal, losses max rel "
        f"diff {rel:.3e}")


def phase_profile(torch, device, n_warm: int = 2, n_each: int = 4):
    """Where a trainer step's time goes at the main path's size.

    After ``n_warm`` steps (the parity check, first allocations), the host
    clock times ``n_each`` steps with the worker's parts wrapped in host
    timers; then ``torch.profiler`` records ``n_each`` more for the device
    time by kernel (and the next ``n_each``, up to twice, if the trace
    dropped a kernel the wrappers counted: on a slow host both of two
    windows have held 3 of 4 gathers). A window's gathers are one a step
    with hits and one a rebuild in it that keeps rows (its persisted-row
    gather). The profiler's own host overhead is large, so the host wall
    comes from the unprofiled steps."""
    import collections

    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train.worker import TrainerWorker

    # two more windows of steps, for traces the profiler dropped kernels of
    cfg = gt.RunConfig(**dict(MAIN_PATH, method="static_w", n_epochs=1,
                              steps_per_epoch=n_warm + 4 * n_each),
                       mem_budget=MemoryBudget(device_payloads=True),
                       device=str(device))
    w = TrainerWorker(cfg, gt.build_trace(cfg))
    w.begin_epoch(0)
    for s in range(n_warm):
        w.step(0, s)
    torch.cuda.synchronize()

    spans = collections.defaultdict(float)

    def timed(name, fn):
        def inner(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans[name] += time.perf_counter() - t
        return inner

    w.engine.prepare = timed("prepare: numpy CSR + copies",
                             w.engine.prepare)
    w.engine.input_rows = timed("input rows: one copy + placement",
                                w.engine.input_rows)
    w.engine._step_fn = timed("SAGE fwd/bwd/AdamW (host)",
                              w.engine._step_fn)
    w.device_tier.gather = timed("device-tier gather", w.device_tier.gather)
    w._resolve_features = timed("feature rows (host rows, numpy)",
                                w._resolve_features)
    t0 = time.perf_counter()
    for s in range(n_warm, n_warm + n_each):
        w.step(0, s)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_each
    engine_ms = statistics.median(w.engine.step_s[n_warm:]) * 1e3
    log(f"profile ({n_each} steady trainer steps, batch {cfg.batch_size}): "
        f"host wall {wall_ms:.3f} ms/step, measured compute (CUDA events) "
        f"{engine_ms:.3f} ms/step")
    for name, sec in sorted(spans.items(), key=lambda kv: -kv[1]):
        log(f"  host {sec * 1e3 / n_each:8.3f} ms/step  {name}")
    log(f"  host {wall_ms - sum(spans.values()) * 1e3 / n_each:8.3f} "
        "ms/step  rest of the trainer step")

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_mm import csr_spmm

    def window(first):
        for s in range(first, first + n_each):
            w.step(0, s)

    for attempt in (1, 2, 3):
        bags0, csr0 = embedding_bag.launches, csr_spmm.launches
        compiles0 = w.engine.n_compiles
        with plans_swapped() as plans:
            by_name = traced(torch,
                             lambda: window(n_warm + attempt * n_each))
        kept = persisted_builds(plans)
        # a new shape signature's untimed first run launches 3 more
        warm_runs = w.engine.n_compiles - compiles0
        wrapper_bags = embedding_bag.launches - bags0
        traced_csr = sum(cnt for name, (_, cnt) in by_name.items()
                         if "csr_spmm_kernel" in name)
        traced_bags = sum(cnt for name, (_, cnt) in by_name.items()
                          if "embedding_bag_kernel" in name)
        if (traced_csr == csr_spmm.launches - csr0
                and traced_bags == wrapper_bags):
            break
        log(f"profile: the trace holds {traced_csr} of "
            f"{csr_spmm.launches - csr0} csr_spmm and {traced_bags} of "
            f"{wrapper_bags} embedding_bag launches; taking the next "
            f"{n_each} steps")
    steps_with_hits = sum(h > 0 for h in w.step_hits[-n_each:])
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3 / n_each
    log(f"profile: device busy {busy_ms:.3f} ms/step, device idle share "
        f"{1.0 - busy_ms / wall_ms:.4f} of the unprofiled host wall")
    require(bool(by_name), "profile: the profiler reported no device time")
    copies = [(us, cnt) for name, (us, cnt) in by_name.items()
              if name.startswith("Memcpy HtoD")]
    log(f"profile: host-to-device copies "
        f"{sum(us for us, _ in copies) / 1e3 / n_each:.4f} ms/step "
        f"x{sum(cnt for _, cnt in copies) / n_each:.1f}")
    for name, (us, cnt) in sorted(by_name.items()):
        if name.startswith("Memcpy DtoH"):
            log(f"profile: device-to-host copies {us / 1e3 / n_each:.4f} "
                f"ms/step x{cnt / n_each:.1f}  {name}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, cnt) in top:
        log(f"  device {us / 1e3 / n_each:8.4f} ms/step x{cnt / n_each:5.1f}"
            f"  {name[:80]}")
    csr = [(us, cnt) for name, (us, cnt) in by_name.items()
           if "csr_spmm_kernel" in name]
    n_csr = sum(cnt for _, cnt in csr)
    log(f"profile: {n_csr} csr_spmm_kernel launches in {n_each} steps, "
        f"{sum(us for us, _ in csr) / 1e3 / n_each:.4f} ms/step of device "
        f"time")
    want_csr = 3 * (n_each + warm_runs)
    require(n_csr == want_csr,
            f"profile: {n_csr} csr_spmm_kernel launches (want {want_csr}: "
            f"{warm_runs} untimed first runs)")
    bags = [(us, cnt) for name, (us, cnt) in by_name.items()
            if "embedding_bag_kernel" in name]
    n_bags = sum(cnt for _, cnt in bags)
    n_sort = sum(cnt for name, (_, cnt) in by_name.items()
                 if "radixSort" in name)
    log(f"profile: {n_bags} embedding_bag_kernel launches in {n_each} steps "
        f"({steps_with_hits} with hits, {kept} rebuilds keeping rows, "
        f"{wrapper_bags} counted by the wrapper), "
        f"{sum(us for us, _ in bags) / 1e3 / n_each:.4f} ms/step of device "
        f"time; {n_sort} radixSort kernels")
    require(steps_with_hits > 0
            and n_bags == wrapper_bags == steps_with_hits + kept,
            f"profile: {n_bags} embedding_bag_kernel launches in the trace, "
            f"{wrapper_bags} counted, want one per step with hits "
            f"({steps_with_hits}) and one per rebuild keeping rows ({kept})")
    require(n_sort == 0, f"profile: {n_sort} radixSort kernels in the steps")


# ------------------------------------------------------------- phase 3b
def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def csr_instances(torch, fn) -> list:
    """The (G, V) of every CSR SpMM kernel ``fn`` launches, from the
    kernel names ``torch.profiler`` reports."""
    from repro_torch.kernels.segment_mm import csr_spmm

    return kernel_instances(torch, fn, r"csr_spmm_kernel<(\d+),\s*(\d+)>",
                            csr_spmm)


def full_graph_operands(torch, device):
    """full_graph_sm's first mini-batch as the trainer prepares it: the
    layer-0 CSR and the input rows in the trainer's layout (rows 1,436
    floats apart, the first 1,433 used)."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import compute, gnn_trainer as gt

    cfg = gt.RunConfig(**dict(FULL_GRAPH, n_epochs=1, steps_per_epoch=1),
                       mem_budget=MemoryBudget(), device=str(device))
    graph, _owner, _traces, mbs = gt.build_trace(cfg)
    eng = compute.ComputeEngine(graph, cfg)
    mb = mbs[0][0]
    layers, x_rows, _ = eng.prepare(mb)
    x = eng.pad_input(graph.features[mb.input_nodes], x_rows)
    return layers[0]["fwd"], x, len(mb.input_nodes)


def phase_spmm_widths(torch, device, ops):
    """The CSR SpMM at widths the kernel took no launch at before: F = 6,
    130 (scalar instance), 132, 256 (float4, two slabs) on the reddit
    layer-0 CSR, and F = 1,433 on full_graph_sm's layer-0 CSR, from the
    trainer's padded-stride input (float4, twelve slabs) and from the same
    rows contiguous (scalar, 45 slabs). Each against the plain version at
    ``TOL_SPMM`` and a relaunch bit-identical."""
    from repro_torch.kernels.segment_mm import csr_spmm, csr_spmm_plain
    from repro_torch.kernels.segment_mm import ops as spmm_ops

    fmt0 = ops["layers"][0]["fwd"]
    gen = torch.Generator().manual_seed(SEED + 1)
    cases = []
    for f in (6, 130, 132, 256):
        x = torch.randn((fmt0.n_cols, f), generator=gen).to(device)
        cases.append((f"reddit layer0 F={f}", fmt0, x))
    fmt_fg, x_fg, _ = full_graph_operands(torch, device)
    cases.append(("full_graph_sm layer0 F=1433 trainer layout", fmt_fg, x_fg))
    cases.append(("full_graph_sm layer0 F=1433 contiguous", fmt_fg,
                  x_fg.contiguous()))
    err_max = 0.0
    for label, fmt, x in cases:
        f = x.shape[1]
        got = csr_spmm(fmt, x)
        again = csr_spmm(fmt, x)
        torch.cuda.synchronize()
        want = csr_spmm_plain(fmt.rowptr, fmt.col, fmt.val, x)
        err = float((got - want).abs().max())
        err_max = max(err_max, err)
        vec = spmm_ops._rows_ok(x, f)
        plan = spmm_ops.csr_plan(f, vec)
        inst = csr_instances(torch, lambda: csr_spmm(fmt, x))
        line = (f"csr_spmm {label}: x={tuple(x.shape)} stride={x.stride()} "
                f"nnz={fmt.col.shape[0]} instance {inst} (plan G={plan.g} "
                f"V={plan.v} slabs={plan.n_slabs}) max|kernel-plain|="
                f"{err:.3e}, bit-identical relaunch: {torch.equal(got, again)}")
        require(inst == [(plan.g, plan.v)],
                f"csr_spmm {label}: launched {inst}, plan {plan}")
        require(torch.allclose(got, want, **TOL_SPMM),
                f"csr_spmm {label}: kernel vs plain max |diff| {err:.3e}")
        require(torch.equal(got, again),
                f"csr_spmm {label}: two launches differ")
        log(line)
    require(spmm_ops._rows_ok(x_fg, 1433),
            "the trainer's full_graph_sm input does not take the float4 "
            "instance")
    return err_max


@contextlib.contextmanager
def plans_swapped():
    """Log every rebuild plan the cache swaps to, with the active nodes
    it was diffed against, for as long as the context is open."""
    from repro_torch.core.windowed_cache import DoubleBufferedCache

    swap = DoubleBufferedCache.swap
    plans = []

    def logged(self, plan):
        plans.append((self.active_nodes, plan))
        return swap(self, plan)

    DoubleBufferedCache.swap = logged
    try:
        yield plans
    finally:
        DoubleBufferedCache.swap = swap


def persisted_builds(plans) -> int:
    """Rebuilds that keep rows of the active table: with device payloads
    each gathers them device-to-device, one EmbeddingBag launch."""
    return sum(bool(plan.persisted.any()) for _, plan in plans)


def counted_run(torch, cfg, bundle):
    """``gnn_trainer.run`` with every launch count zeroed just before and
    read just after: (result, counts, wall seconds, the plans swapped to
    with the active nodes each was diffed against). ``counts`` also holds
    the EmbeddingBag launches made on the pipeline's builder thread (the
    thread named ``cache-builder``), as the wrapper counted them."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.train import gnn_trainer as gt

    with plans_swapped() as plans:
        for wrapper in (csr_spmm, embedding_bag):
            wrapper.launches = 0
            wrapper.launches_by_thread = {}
        t0 = time.perf_counter()
        res = gt.run(cfg, bundle)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"csr_spmm": csr_spmm.launches,
                  "embedding_bag": embedding_bag.launches,
                  "embedding_bag_builder":
                      embedding_bag.launches_by_thread.get("cache-builder", 0)}
    return res, counts, wall, plans


def require_path_counts(label, res, counts, plans, measured=True):
    """The main path's launch rules: 3 CSR launches a measured step, 2 in
    the parity check and 3 in each untimed first run of a new shape
    signature (``n_compiles``), one gather a step with
    hits and one persisted-row gather for each rebuild in ``plans`` that
    keeps rows of the active table; with the threaded pipeline, every
    persisted-row gather is launched on the builder thread, and no other
    gather is."""
    kept = persisted_builds(plans)
    n_steps = len(res.step_hits)
    with_hits = int((res.step_hits > 0).sum())
    if measured:
        rep = res.compute_report
        require(counts["csr_spmm"] == 3 * n_steps + 2 + 3 * rep["n_compiles"],
                f"{label}: csr_spmm launches {counts['csr_spmm']} != 3 per "
                f"step + 2 + 3 per untimed first run ({rep['n_compiles']})")
        require(rep["n_steps"] == n_steps, f"{label}: measured steps missing")
        require(all(math.isfinite(v) for v in rep["losses"]),
                f"{label}: non-finite loss")
        require(rep["parity_max_diff"] is not None
                and rep["parity_max_diff"] < 2e-3,
                f"{label}: parity_max_diff {rep['parity_max_diff']}")
    else:
        require(counts["csr_spmm"] == 0, f"{label}: SpMM in a modeled run")
    require(counts["embedding_bag"] == with_hits + kept,
            f"{label}: embedding_bag launches {counts['embedding_bag']} != "
            f"{with_hits} steps with hits + {kept} rebuilds with persisted "
            "rows")
    on_builder = kept if res.pipeline is not None else 0
    require(counts["embedding_bag_builder"] == on_builder,
            f"{label}: {counts['embedding_bag_builder']} embedding_bag "
            f"launches on the builder thread, not {on_builder}")


def phase_full_graph(torch, device):
    """A few measured trainer steps on full_graph_sm (d_in = 1,433) with
    device payloads, through ``gnn_trainer.run``."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    cfg = gt.RunConfig(**FULL_GRAPH,
                       mem_budget=MemoryBudget(device_payloads=True),
                       device=str(device))
    res, counts, wall, plans = counted_run(torch, cfg, gt.build_trace(cfg))
    rep = res.compute_report
    n_steps = cfg.n_epochs * cfg.steps_per_epoch
    log(f"full_graph_sm: {n_steps} measured steps in {wall:.2f} s, hits "
        f"{res.step_hits.tolist()}, misses {res.step_misses.tolist()}, "
        f"launches {counts}, parity_max_diff {rep['parity_max_diff']:.3e}, "
        f"losses {[round(v, 4) for v in rep['losses']]}, median measured "
        f"step {statistics.median(rep['step_s']) * 1e3:.3f} ms")
    require_path_counts("full_graph_sm", res, counts, plans)
    require(int((res.step_hits > 0).sum()) > 0, "full_graph_sm: no hits")
    return counts


def epoch_joules(res, epoch: int) -> float:
    """The meter's joules in one epoch, over all its nodes."""
    marks = res.meter.epoch_marks
    prev = marks[epoch - 1] if epoch else {"gpu_j": 0.0, "cpu_j": 0.0}
    return float((marks[epoch]["gpu_j"] + marks[epoch]["cpu_j"]
                  - prev["gpu_j"] - prev["cpu_j"]) * res.meter.n_nodes)


def phase_congestion(torch, device, smi, qnets):
    """Each method under the paper schedule and a time-driven scenario,
    measured lane, device payloads, 5 epochs of 4 steps (1 of warmup, W =
    2 until a controller decides; the schedule congests epoch 3); one
    line a run. greendygnn runs once under each policy of ``qnets`` (the
    table-trained and the queue-trained one)."""
    from repro_torch.core import controller as ctl, dqn
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    decisions = []
    decide = ctl.AdaptiveController.decide

    def counted_decide(self, stats):
        decisions.append(1)
        return decide(self, stats)

    bundle = gt.build_trace(gt.RunConfig(**CONGESTION, device=str(device)))
    ctl.AdaptiveController.decide = counted_decide
    try:
        runs = [(m, None) for m in ("dgl", "static_w", "heuristic")] + [
            ("greendygnn", name) for name in qnets]
        for scenario in ("paper_schedule", "bursty_markov"):
            for method, policy in runs:
                cfg = gt.RunConfig(
                    **dict(CONGESTION, method=method, scenario=scenario),
                    q_fn=dqn.q_fn_of(qnets[policy]) if policy else None,
                    mem_budget=MemoryBudget(device_payloads=True),
                    device=str(device))
                if policy:
                    method = f"{method} ({policy}-trained)"
                decisions.clear()
                res, counts, wall, plans = counted_run(torch, cfg, bundle)
                joules = [round(epoch_joules(res, e), 4)
                          for e in range(cfg.n_epochs)]
                log(f"congestion {scenario} {method}: joules per epoch "
                    f"{joules}, "
                    f"windows {res.window_per_epoch.tolist()}, hits "
                    f"{int(res.step_hits.sum())}, misses "
                    f"{int(res.step_misses.sum())}, remote bytes "
                    f"{res.meter.remote_bytes:.0f}, launches {counts}, "
                    f"decisions {len(decisions)}, sigma "
                    f"{res.sigma_trace.max():.4f} max, wall {wall:.2f} s; "
                    f"{smi}")
                require(res.scenario == scenario,
                        f"congestion: the run used {res.scenario}")
                require_path_counts(f"congestion {scenario} {method}", res,
                                    counts, plans)
                if method not in ("dgl", "static_w"):
                    require(len(decisions) >= 1,
                            f"congestion {scenario} {method}: the "
                            "controller never decided")
    finally:
        ctl.AdaptiveController.decide = decide


def phase_budgeted_tier(torch, device):
    """ooc_community (96 features, streamed) under a host budget of 0.3 of
    its feature matrix, over the clean fabric, measured lane."""
    from repro_torch.graph import datasets
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    src = datasets.materialize("ooc_community", seed=0).feature_source
    host = 0.3 * src.n_rows * src.bytes_per_row
    cfg = gt.RunConfig(**BUDGETED, mem_budget=MemoryBudget(
        host_bytes=host, chunk_rows=256, device_payloads=True),
        device=str(device))
    res, counts, wall, plans = counted_run(torch, cfg, gt.build_trace(cfg))
    tc = res.tier_counts
    log(f"budgeted tier ooc_community: host budget {host:.0f} B, "
        f"tier_counts {tc}, launches {counts}, wall {wall:.2f} s")
    require_path_counts("budgeted tier", res, counts, plans)
    require(tc["block_fetches"] > 0, "budgeted tier: no block fetches")
    require(tc["peak_resident_bytes"] <= host or tc["pinned_over_budget"] > 0,
            f"budgeted tier: peak {tc['peak_resident_bytes']} B over the "
            f"{host:.0f} B budget with no pin over budget")


def phase_card_vs_cpu_fabric(torch, device):
    """static_w and heuristic under the paper schedule and bursty_markov,
    modeled lane with device payloads, on the card (the EmbeddingBag
    kernel gathers the hits) and on the CPU (its plain version): every
    field of the reference's result digest equal, bit for bit."""
    import numpy as np

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    base = dict(CONGESTION, compute="modeled")
    bundle = gt.build_trace(gt.RunConfig(**base, device="cpu"))
    for scenario in ("paper_schedule", "bursty_markov"):
        for method in ("static_w", "heuristic"):
            out = []
            for dev in (str(device), "cpu"):
                cfg = gt.RunConfig(**dict(base, method=method,
                                          scenario=scenario),
                                   mem_budget=MemoryBudget(
                                       device_payloads=True), device=dev)
                with plans_swapped() as plans:
                    embedding_bag.launches = 0
                    res = gt.run(cfg, bundle)
                    out.append((res, embedding_bag.launches,
                                persisted_builds(plans)))
            (a, launched, kept), (b, _, _) = out
            fields = []
            for name in ("gpu_j", "cpu_j", "wall_s", "remote_bytes",
                         "n_rpcs"):
                fields.append((name, getattr(a.meter, name),
                               getattr(b.meter, name)))
            for name in ("step_hits", "step_misses", "fetched_rows_by_owner",
                         "sigma_trace", "hit_rate_per_epoch",
                         "window_per_epoch"):
                fields.append((name, getattr(a, name), getattr(b, name)))
            for name, x, y in fields:
                require(np.asarray(x).tobytes() == np.asarray(y).tobytes(),
                        f"card vs CPU {scenario} {method}: {name} differs")
            require(a.tier_counts == b.tier_counts,
                    f"card vs CPU {scenario} {method}: tier counts differ")
            with_hits = int((a.step_hits > 0).sum())
            require(with_hits > 0 and launched == with_hits + kept,
                    f"card vs CPU {scenario} {method}: {launched} gathers "
                    f"on the card for {with_hits} steps with hits and "
                    f"{kept} rebuilds with persisted rows")
            log(f"card vs CPU {scenario} {method} (modeled): digest fields "
                f"equal, energy {float(a.meter.gpu_j + a.meter.cpu_j)!r} J, "
                f"{launched} gathers on the card")


# ------------------------------------------------------------- phase 3c
def pipeline_cfg(device, **kw):
    """PIPELINE with device payloads over an unlimited host tier."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    return gt.RunConfig(**dict(PIPELINE, **kw),
                        mem_budget=MemoryBudget(device_payloads=True),
                        device=str(device))


def require_parity(label, sync, asyn):
    """The threaded run's hit and miss streams, windows and per-owner
    fetched rows equal the synchronous run's (the reference's parity
    criterion, with the windows added)."""
    import numpy as np

    from repro_torch.pipeline.parity import compare_runs

    rep = compare_runs(sync, asyn)
    require(rep.ok, f"{label}: threaded run differs from the synchronous "
            f"one\n{rep.describe()}")
    require(np.array_equal(sync.window_per_epoch, asyn.window_per_epoch),
            f"{label}: windows differ")


@contextlib.contextmanager
def tier_invariant(torch, stats):
    """At every swap, once the pointer has flipped: the active table, and
    every active slot gathered through the EmbeddingBag kernel, are
    ``torch.equal`` to the host payload. The checks' own launches are
    tallied in ``stats["launches"]``, to be taken off the run's count (a
    swap runs on the consumer thread with no build in flight, so nothing
    else launches meanwhile)."""
    import numpy as np

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.store import DevicePayloadTier

    install = DevicePayloadTier.install

    def checked(self, pending):
        install(self, pending)
        torch.cuda.synchronize()
        host = torch.from_numpy(self._payload)
        n0 = embedding_bag.launches
        rows = self.gather_rows(np.arange(len(host)))
        torch.cuda.synchronize()
        stats["launches"] += embedding_bag.launches - n0
        require(torch.equal(self._table.cpu(), host),
                f"tier invariant: swap {stats['swaps']}: the table built on "
                "the builder's stream differs from the host payload")
        require(torch.equal(rows.cpu(), host),
                f"tier invariant: swap {stats['swaps']}: the gather of the "
                "active slots differs from the host payload")
        stats["swaps"] += 1
        stats["rows"] += len(host)

    DevicePayloadTier.install = checked
    try:
        yield stats
    finally:
        DevicePayloadTier.install = install


@contextlib.contextmanager
def builds_logged():
    """Log every build the consumer waits for: (plan s, fetch s, submit
    to publish s, exposed wait s), the first being the cold start."""
    from repro_torch.pipeline import CacheBuilder

    wait = CacheBuilder.wait
    builds = []

    def logged(self, ticket):
        buf, exposed = wait(self, ticket)
        builds.append((buf.t_plan_s, buf.t_fetch_s, buf.t_total_s, exposed))
        return buf, exposed

    CacheBuilder.wait = logged
    try:
        yield builds
    finally:
        CacheBuilder.wait = wait


@contextlib.contextmanager
def prefetch_resolve_off():
    """The prefetcher's resolver made a no-op: every scheduled batch
    resolves to None at once. The run keeps its prefetch thread, queue
    and accounting, but reads none of the rows whose payload the step
    discards."""
    from repro_torch.pipeline import PrefetchQueue

    init = PrefetchQueue.__init__

    def off(self, resolve_fn, depth, sanitize=None):
        init(self, lambda item: None, depth, sanitize)

    PrefetchQueue.__init__ = off
    try:
        yield
    finally:
        PrefetchQueue.__init__ = init


@contextlib.contextmanager
def boundaries_timed():
    """The consumer's host seconds at rebuild boundaries, summed in
    ``spent[0]``: the whole synchronous rebuild, or the threaded one's
    wait, swap and next submit."""
    from repro_torch.train.worker import TrainerWorker

    spent = [0.0]
    originals = {name: getattr(TrainerWorker, name)
                 for name in ("_rebuild_sync", "_rebuild_async")}

    def timed(fn):
        def run(self, *args):
            t0 = time.perf_counter()
            try:
                return fn(self, *args)
            finally:
                spent[0] += time.perf_counter() - t0
        return run

    for name, fn in originals.items():
        setattr(TrainerWorker, name, timed(fn))
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(TrainerWorker, name, fn)


def timed_steps(torch, cfg, bundle):
    """Drive a TrainerWorker through ``cfg``'s steps as
    ``gnn_trainer.run`` does: (result, host wall per step in ms, from
    the first step to the device's end of the last)."""
    from repro_torch.train.worker import TrainerWorker

    w = TrainerWorker(cfg, bundle)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(cfg.n_epochs):
            w.begin_epoch(e)
            for s in range(cfg.steps_per_epoch):
                w.step(e, s)
            w.end_epoch(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        w.close()
    return w.result(), wall * 1e3 / (cfg.n_epochs * cfg.steps_per_epoch)


def phase_pipeline(torch, device, smi):
    """The threaded pipeline through ``gnn_trainer.run`` at MAIN_PATH's
    widths and batch: static_w at W = 4 and W = 7, synchronous and
    threaded, streams equal; the tier invariant at every swap of the
    threaded W = 4 run; the launch rules; then the host wall per step,
    synchronous, threaded and threaded without the prefetcher's row
    reads, in turns. Returns what the timing phase
    needs: the threaded W = 4 run's plans, the EmbeddingBag launches its
    builder thread made (the persisted-row gathers) and its rebuilds."""
    from repro_torch.train import gnn_trainer as gt

    bundle = gt.build_trace(pipeline_cfg(device))
    inv = {"swaps": 0, "rows": 0, "launches": 0}
    out = {}
    for window in (4, 7):
        for mode in ("sync", "async"):
            cfg = pipeline_cfg(device, static_window=window,
                               async_pipeline=mode == "async")
            label = f"pipeline W={window} {mode}"
            checks = (tier_invariant(torch, inv) if (window, mode)
                      == (4, "async") else contextlib.nullcontext())
            with checks:
                res, counts, wall, plans = counted_run(torch, cfg, bundle)
            if (window, mode) == (4, "async"):
                counts["embedding_bag"] -= inv["launches"]
            kept = persisted_builds(plans)
            log(f"{label}: {len(res.step_hits)} steps in {wall:.2f} s, "
                f"windows {res.window_per_epoch.tolist()}, hits "
                f"{int(res.step_hits.sum())}, misses "
                f"{int(res.step_misses.sum())}, fetched rows "
                f"{res.fetched_rows_by_owner.astype(int).tolist()}, "
                f"launches {counts}, {len(plans)} rebuilds ({kept} carrying "
                "persisted rows)")
            require_path_counts(label, res, counts, plans)
            out[window, mode] = (res, plans, counts)
        sync, asyn = out[window, "sync"][0], out[window, "async"][0]
        require_parity(f"pipeline W={window}", sync, asyn)
        require(sync.pipeline is None and asyn.pipeline is not None
                and asyn.pipeline.n_rebuilds == len(out[window, "async"][1]),
                f"pipeline W={window}: report missing or rebuilds miscounted")
        log(f"pipeline W={window}: threaded and synchronous streams, windows "
            "and fetched rows equal")
        log(f"pipeline W={window} report: {json.dumps(asyn.pipeline.summary())}")
    require(inv["swaps"] == out[4, "async"][0].pipeline.n_rebuilds > 0,
            f"tier invariant checked at {inv['swaps']} swaps")
    log(f"tier invariant: {inv['swaps']} swaps of the threaded W=4 run, "
        f"{inv['rows']} active rows, table and kernel gather torch.equal to "
        f"the host payload at each ({inv['launches']} check launches taken "
        "off the count)")

    # host wall per step in turns (twice: the host's noise between runs
    # is of the order of the differences): synchronous, threaded, and
    # threaded with the prefetcher's resolver a no-op, which parts the
    # threaded path's extra host time between the discarded prefetch and
    # the rest (the builder beside the consumer, the swap). Each run's
    # wall is split into the consumer's time at rebuild boundaries and
    # the rest of its steps.
    modes = ("sync", "async", "async-noprefetch")
    walls = {m: [] for m in modes}
    at_bound = {m: [] for m in modes}
    n_steps = PIPELINE["n_epochs"] * PIPELINE["steps_per_epoch"]
    for mode in ("sync", "async", "async-noprefetch", "async-noprefetch",
                 "async", "sync") * 2:
        cfg = pipeline_cfg(device, async_pipeline=mode != "sync")
        off = (prefetch_resolve_off() if mode == "async-noprefetch"
               else contextlib.nullcontext())
        with off, builds_logged() as builds, boundaries_timed() as spent:
            res, ms = timed_steps(torch, cfg, bundle)
        require_parity(f"pipeline timed {mode}", out[4, "sync"][0], res)
        bound = spent[0] * 1e3 / n_steps
        walls[mode].append(ms)
        at_bound[mode].append(bound)
        head = (f"pipeline timed {mode}: host wall {ms:.3f} ms/step "
                f"({bound:.3f} at rebuild boundaries, {ms - bound:.3f} in "
                "the rest of the steps)")
        if res.pipeline is None:
            log(f"{head}; {smi}")
            continue
        rep = res.pipeline
        require(rep.prefetch_batches == n_steps,
                f"pipeline timed {mode}: {rep.prefetch_batches} prefetched "
                f"batches for {n_steps} steps")
        n = max(rep.n_rebuilds, 1)
        log(f"{head}; per rebuild builder wall "
            f"{rep.builder_wall_s * 1e3 / n:.3f} ms, exposed wait "
            f"{rep.exposed_wait_s * 1e3 / n:.3f} ms, overlap efficiency "
            f"{rep.overlap_efficiency:.4f}, swap latency "
            f"{rep.swap_latency_s * 1e3:.4f} ms mean "
            f"({rep.swap_latency_max_s * 1e3:.4f} max), {rep.n_rebuilds} "
            f"rebuilds; prefetch wait {rep.prefetch_wait_s * 1e3:.3f} ms "
            f"over {rep.prefetch_batches} batches, {rep.prefetch_stalls} "
            f"stalls, resolver work {rep.prefetch_resolve_s * 1e3:.3f} ms "
            f"(payloads discarded); {smi}")
        log(f"pipeline timed {mode} summary: {json.dumps(rep.summary())}")
        cold, rest = builds[0], builds[1:]
        log(f"pipeline timed {mode} builds, ms (plan, fetch, submit to "
            f"publish, exposed): cold start "
            f"{[round(v * 1e3, 3) for v in cold]}; the other "
            f"{len(rest)}, medians "
            f"{[round(statistics.median(b[k] for b in rest) * 1e3, 3) for k in range(4)]}"
            f", max exposed {max(b[3] for b in rest) * 1e3:.3f}")
    mean = {m: statistics.mean(walls[m]) for m in modes}
    mean_b = {m: statistics.mean(at_bound[m]) for m in modes}
    log(f"pipeline host wall per step (W=4, {PIPELINE['n_epochs']} x "
        f"{PIPELINE['steps_per_epoch']} steps, order (sync async "
        "async-noprefetch async-noprefetch async sync) x 2): "
        + "; ".join(f"{m} {walls[m]} ms, at boundaries {at_bound[m]} ms"
                    for m in modes) + f"; {smi}")
    log("pipeline host wall per step, means (wall / at boundaries / rest), "
        "ms: " + "; ".join(
            f"{m} {mean[m]:.3f} / {mean_b[m]:.3f} / "
            f"{mean[m] - mean_b[m]:.3f}" for m in modes)
        + f"; threaded - sync {mean['async'] - mean['sync']:.3f}, of which "
        f"the discarded prefetch (threaded - no-prefetch) "
        f"{mean['async'] - mean['async-noprefetch']:.3f} and the rest "
        f"(no-prefetch - sync) "
        f"{mean['async-noprefetch'] - mean['sync']:.3f}")
    res, plans, counts = out[4, "async"]
    return plans, counts["embedding_bag_builder"], res.pipeline.n_rebuilds


def chrome_events(prof, path):
    """The device's kernel and copy events of a finished profile, from its
    Chrome trace: [(category, name, stream, bytes)]."""
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy"):
            continue
        args = e.get("args", {})
        require("stream" in args,
                f"profile trace: no stream in {e.get('name')}'s args "
                f"{sorted(args)}")
        events.append((e["cat"], e["name"], args["stream"],
                       args.get("bytes")))
    return events


def phase_pipeline_profile(torch, device, n_warm: int = 8, n_each: int = 8):
    """Two threaded windows (W = 4: steps 8-15, swaps at 8 and 12) under
    ``torch.profiler``: the builder's payload upload is a pinned copy on a
    stream other than the compute stream, its persisted-row gathers run
    there too, and no pageable copy the size of a payload table follows a
    swap (the first gather reads the table built off the critical path)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train.worker import TrainerWorker

    # a second pair of windows (steps 16-23), for a trace the profiler
    # dropped a counted kernel of; the epoch runs on past it, so that
    # window's last swap submits a build too
    cfg = pipeline_cfg(device, n_epochs=1, steps_per_epoch=n_warm + 3 * n_each,
                       async_pipeline=True)
    w = TrainerWorker(cfg, gt.build_trace(cfg))
    path = ROOT / "build" / "pipeline_profile.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        w.begin_epoch(0)
        for s in range(n_warm):
            w.step(0, s)
        torch.cuda.synchronize()
        for first in (n_warm, n_warm + n_each):
            bags0 = embedding_bag.launches
            builder0 = embedding_bag.launches_by_thread.get("cache-builder",
                                                            0)
            with plans_swapped() as plans, profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                # pauses lead and end the window (see ``traced``)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(0.05)
                for s in range(first, first + n_each):
                    w.step(0, s)
                # the build submitted at the last swap ends inside the
                # window
                require(w.pending_ticket.done.wait(timeout=120),
                        "profile: the last build did not finish")
                torch.cuda.synchronize()
                time.sleep(0.05)
            wrapper_bags = embedding_bag.launches - bags0
            builder_bags = (embedding_bag.launches_by_thread.get(
                "cache-builder", 0) - builder0)
            events = chrome_events(prof, path)
            traced_bags = sum("embedding_bag_kernel" in name
                              for _, name, _, _ in events)
            if traced_bags == wrapper_bags:
                break
            log(f"profile pipeline: the trace holds {traced_bags} of "
                f"{wrapper_bags} embedding_bag launches; taking steps "
                f"{first + n_each}-{first + 2 * n_each - 1}")
    finally:
        w.close()
    csr_streams = {st for cat, name, st, _ in events
                   if "csr_spmm_kernel" in name}
    require(len(csr_streams) == 1,
            f"profile: the SAGE step's SpMM ran on streams {csr_streams}")
    (compute,) = csr_streams
    copies = [(name, st, b) for cat, name, st, b in events
              if cat == "gpu_memcpy" and "HtoD" in name]
    for name, st, b in copies:
        if "Pinned" in name or (b or 0) > 1 << 20:
            log(f"profile pipeline: {name} on stream {st}"
                f"{' (compute)' if st == compute else ''}: {b} B")
    pinned = [(st, b) for name, st, b in copies if "Pinned" in name]
    table_bytes = [len(plan.hot_nodes) * w.device_tier.n_feat * 4
                   for _, plan in plans]
    pageable = [b for name, st, b in copies if "Pageable" in name]
    require(all(b is not None for b in pageable + [b for _, b in pinned]),
            "profile: copies without a byte count in the trace")
    bags = [st for cat, name, st, _ in events
            if "embedding_bag_kernel" in name]
    side_bags = sum(st != compute for st in bags)
    with_hits = sum(h > 0 for h in w.step_hits[first:first + n_each])
    log(f"profile pipeline ({n_each} threaded steps, {len(plans)} swaps, "
        f"tables of {table_bytes} B): compute stream {compute}; "
        f"{len(pinned)} pinned uploads on streams "
        f"{sorted({st for st, _ in pinned})} ({sum(b for _, b in pinned)} "
        f"B); {len(pageable)} pageable copies, largest "
        f"{max(pageable, default=0)} B; embedding_bag_kernel "
        f"{len(bags) - side_bags} on the compute stream ({with_hits} steps "
        f"with hits), {side_bags} on the builder's stream, "
        f"{wrapper_bags} counted by the wrapper, {builder_bags} of them on "
        "the builder thread")
    require(len(plans) == 2, f"profile: {len(plans)} swaps in two windows")
    require(len(pinned) >= 2 and all(st != compute for st, _ in pinned),
            "profile: the builds' pinned uploads are not on a stream of "
            "their own")
    require(max(pageable, default=0) < min(table_bytes),
            f"profile: a pageable copy of {max(pageable)} B, a payload "
            f"table's size ({min(table_bytes)} B), ran in the window")
    require(len(bags) - side_bags == with_hits > 0,
            f"profile: {len(bags) - side_bags} hit gathers on the compute "
            f"stream for {with_hits} steps with hits")
    require(1 <= side_bags <= 3 and len(bags) == wrapper_bags
            and side_bags == builder_bags,
            f"profile: {side_bags} persisted-row gathers on the builder's "
            f"stream, {builder_bags} counted on its thread; {len(bags)} "
            f"gathers traced, {wrapper_bags} counted")


def phase_pipeline_adaptive(torch, device, qnet):
    """greendygnn threaded under the paper schedule (CONGESTION's 5 epochs
    of 4 steps), driven by ``qnet`` (the table-trained policy): it runs,
    rebuilds, and every window it decides lies in the action set."""
    from repro_torch.core import controller as ctl, cost_model as cm, dqn
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    cfg = gt.RunConfig(**dict(CONGESTION, method="greendygnn",
                              scenario="paper_schedule", async_pipeline=True),
                       q_fn=dqn.q_fn_of(qnet),
                       mem_budget=MemoryBudget(device_payloads=True),
                       device=str(device))
    decide = ctl.AdaptiveController.decide
    windows = []

    def logged(self, stats):
        w, ww, action = decide(self, stats)
        windows.append(float(w))
        return w, ww, action

    ctl.AdaptiveController.decide = logged
    try:
        res, counts, wall, plans = counted_run(torch, cfg,
                                               gt.build_trace(cfg))
    finally:
        ctl.AdaptiveController.decide = decide
    log(f"pipeline greendygnn paper_schedule (threaded): windows per epoch "
        f"{res.window_per_epoch.tolist()}, decided {windows}, "
        f"{res.pipeline.n_rebuilds} rebuilds, launches {counts}, wall "
        f"{wall:.2f} s; report {json.dumps(res.pipeline.summary())}")
    require_path_counts("pipeline greendygnn", res, counts, plans)
    require(res.pipeline.n_rebuilds > 0, "pipeline greendygnn: no rebuild")
    choices = {float(c) for c in cm.WINDOW_CHOICES}
    require(len(windows) >= 1 and set(windows) <= choices,
            f"pipeline greendygnn: decided windows {windows} outside "
            f"{sorted(choices)}")


def phase_pipeline_budgeted(torch, device):
    """ooc_community threaded under a host budget of 0.3 of its matrix:
    the card's run and the same run on the CPU give equal ``tier_counts``
    and streams."""
    import numpy as np

    from repro_torch.graph import datasets
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    src = datasets.materialize("ooc_community", seed=0).feature_source
    host = 0.3 * src.n_rows * src.bytes_per_row
    runs = {}
    for dev in (str(device), "cpu"):
        cfg = gt.RunConfig(**BUDGETED, async_pipeline=True,
                           mem_budget=MemoryBudget(host_bytes=host,
                                                   chunk_rows=256,
                                                   device_payloads=True),
                           device=dev)
        runs[dev] = counted_run(torch, cfg, gt.build_trace(cfg))
    res, counts, wall, plans = runs[str(device)]
    cpu = runs["cpu"][0]
    log(f"pipeline budgeted ooc_community (threaded): tier_counts "
        f"{res.tier_counts}, the CPU's {cpu.tier_counts}, launches {counts}, "
        f"wall {wall:.2f} s")
    require_path_counts("pipeline budgeted", res, counts, plans)
    require(res.tier_counts == cpu.tier_counts,
            "pipeline budgeted: tier_counts differ between card and CPU")
    for name in ("step_hits", "step_misses", "fetched_rows_by_owner"):
        require(np.array_equal(getattr(res, name), getattr(cpu, name)),
                f"pipeline budgeted: {name} differs between card and CPU")
    require(res.tier_counts["block_fetches"] > 0,
            "pipeline budgeted: no block fetches")


def persisted_gather_row(torch, device, plans, launches: int,
                         n_rebuilds: int):
    """The device tier's persisted-row gather at the threaded main-path
    run's median rebuild: the kept rows gathered out of the active table
    (8,400 x 64 at the path's capacity), checked ``torch.equal`` to
    ``table[pos]``, then timed beside its plain version and
    ``F.embedding_bag`` (timed here only) on the same operands.
    ``launches`` are the EmbeddingBag launches the wrapper counted on the
    builder thread of the threaded W = 4 run."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag_ops

    kept = sorted((int(plan.persisted.sum()), i)
                  for i, (_, plan) in enumerate(plans) if plan.persisted.any())
    old, plan = plans[kept[len(kept) // 2][1]]
    pos = np.searchsorted(old, plan.hot_nodes[plan.persisted])
    n = len(pos)
    gen = torch.Generator().manual_seed(SEED + 5)
    d = PIPELINE_FEAT
    table = torch.randn((len(old), d), generator=gen).to(device)
    fmt = bag_ops.BagFormat.from_numpy(pos, np.arange(n), n, None, device)
    got = bag_ops.bag_sum(fmt, table)
    torch.cuda.synchronize()
    want = table[torch.as_tensor(pos, device=device)]
    require(torch.equal(got, want),
            "persisted gather: not torch.equal to table[pos]")
    err = float((got - bag_ops.bag_plain(fmt, table)).abs().max())
    timer = Timer(torch, device)
    out = torch.empty((n, d), device=device)
    ms = timer.ms(lambda: bag_ops.bag_launch(fmt, table, out))
    plain = timer.ms(lambda: bag_ops.bag_plain(fmt, table))
    lib = timer.ms(lambda: F.embedding_bag(
        fmt.idx, table, fmt.offsets[:-1], mode="sum",
        per_sample_weights=fmt.w, include_last_offset=False))
    # n distinct rows read and written once and n indices: unit weights
    # and one lookup a bag need neither weights nor offsets
    n_bytes = bag_bytes(torch, fmt, d)
    require(n_bytes == 2 * n * d * 4 + n * 4,
            f"persisted gather: {n_bytes} B counted for {n} rows")
    b_ms, b_by = bound_ms(n_bytes, 2.0 * n * d)
    log(f"time embedding_bag persisted gather: {n} of {len(old)} rows "
        f"(median of {len(kept)} rebuilds keeping rows, "
        f"{[k for k, _ in kept]}): kernel {ms:.4f} ms (events); plain "
        f"{plain:.4f} ms; F.embedding_bag {lib:.4f} ms; bound {b_ms:.4f} ms "
        f"({b_by}; {n_bytes / 1e6:.3f} MB); {launches} launches on the "
        f"builder thread in {n_rebuilds} rebuilds")
    return {
        "name": "embedding_bag_persisted", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:48",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "rows": n, "launches_per_rebuild": launches / max(n_rebuilds, 1),
    }


def spmm_wide_timing_row(torch, device, launches: int, err: float):
    """The CSR SpMM at full_graph_sm's layer 0 (F = 1,433, the trainer's
    padded-stride input): kernel, plain version and ``torch.sparse.mm``
    (timed here only, on the same rows made contiguous), beside the bytes
    bound of the entries, the row pointers, the X rows the entries
    reference and Y."""
    from repro_torch.kernels.segment_mm import ops as spmm_ops

    timer = Timer(torch, device)
    fmt, x, _ = full_graph_operands(torch, device)
    f = x.shape[1]
    y = torch.empty((fmt.n_rows, -(-f // 4) * 4), device=device)[:, :f]
    ms = timer.ms(lambda: spmm_ops.csr_launch(fmt, x, y))
    plain = timer.ms(lambda: spmm_ops.csr_spmm_plain(
        fmt.rowptr, fmt.col, fmt.val, x))
    xc = x.contiguous()
    yc = torch.empty((fmt.n_rows, f), device=device)
    scalar = timer.ms(lambda: spmm_ops.csr_launch(fmt, xc, yc))
    csr = torch.sparse_csr_tensor(fmt.rowptr, fmt.col, fmt.val,
                                  (fmt.n_rows, x.shape[0]),
                                  check_invariants=True)
    lib = timer.ms(lambda: torch.sparse.mm(csr, xc))
    nnz = fmt.col.numel()
    n_x_rows = int(torch.unique(fmt.col).numel())
    n_bytes = (nnz * 8 + fmt.rowptr.numel() * 4 + n_x_rows * f * 4
               + fmt.n_rows * f * 4)
    n_flops = 2.0 * nnz * f
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    log(f"time csr_spmm full_graph_sm layer0 F={f}: kernel {ms:.4f} ms "
        f"(float4, the trainer's rows), {scalar:.4f} ms (scalar, the rows "
        f"contiguous), plain {plain:.4f} ms, torch.sparse.mm {lib:.4f} ms, "
        f"bound "
        f"{b_ms:.4f} ms ({b_by}; {n_bytes / 1e6:.3f} MB: nnz {nnz}, "
        f"{n_x_rows} X rows referenced, Y {fmt.n_rows} x {f})")
    return {
        "name": "csr_spmm_f1433", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/csr_spmm.cu",
        "replaces": "src/repro/kernels/segment_mm/kernel.py:78",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "scalar_ms": scalar,
    }


# ------------------------------------------------------ the cluster phase
@contextlib.contextmanager
def swaps_by_thread():
    """Log every ``DoubleBufferedCache.swap`` with the thread that made
    it: (thread name, plan). A rank's synchronous rebuilds swap on its own
    ``trainer-worker-{rank}`` thread."""
    import threading

    from repro_torch.core.windowed_cache import DoubleBufferedCache

    swap = DoubleBufferedCache.swap
    swaps = []

    def logged(self, plan):
        swaps.append((threading.current_thread().name, plan))
        return swap(self, plan)

    DoubleBufferedCache.swap = logged
    try:
        yield swaps
    finally:
        DoubleBufferedCache.swap = swap


@contextlib.contextmanager
def global_steps_timed():
    """Host clock at each global step's publish (the driver's end of a
    lockstep round): the host wall per global step is their spacing."""
    from repro_torch.train import cluster as cl

    publish = cl._StepGate.publish_sync
    stamps = []

    def stamped(self, g, sync):
        stamps.append(time.perf_counter())
        return publish(self, g, sync)

    cl._StepGate.publish_sync = stamped
    try:
        yield stamps
    finally:
        cl._StepGate.publish_sync = publish


@contextlib.contextmanager
def launches_by_rank():
    """Each rank's kernel launches, read as the wrappers' totals before
    and after each of its steps: the gate runs one rank's step at a time,
    and a step's launches (its backward's too, which PyTorch's autograd
    engine runs on a thread of its own for a CUDA device) end inside it.
    {wrapper name: {rank: launches}}."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.train.worker import TrainerWorker

    step = TrainerWorker.step
    wrappers = {"csr_spmm": csr_spmm, "embedding_bag": embedding_bag}
    by_rank = {name: {} for name in wrappers}

    def counted(self, epoch, s):
        before = {name: w.launches for name, w in wrappers.items()}
        out = step(self, epoch, s)
        for name, w in wrappers.items():
            got = by_rank[name]
            got[self.rank] = got.get(self.rank, 0) + w.launches - before[name]
        return out

    TrainerWorker.step = counted
    try:
        yield by_rank
    finally:
        TrainerWorker.step = step


def counted_cluster(torch, cfg, cc, bundles):
    """``run_cluster`` with every launch count zeroed just before and read
    just after: (report, {wrapper: launches by thread, and "by_rank":
    {wrapper: launches by rank}}, wall seconds, the swaps by thread, host
    seconds per global step)."""
    import numpy as np

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.train import cluster as cl

    wrappers = {"csr_spmm": csr_spmm, "embedding_bag": embedding_bag}
    with swaps_by_thread() as swaps, global_steps_timed() as stamps, \
            launches_by_rank() as by_rank:
        for wrapper in wrappers.values():
            wrapper.launches = 0
            wrapper.launches_by_thread = {}
        t0 = time.perf_counter()
        rep = cl.run_cluster(cfg, cc, trace_bundles=bundles)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: dict(w.launches_by_thread)
                  for name, w in wrappers.items()}
    counts["by_rank"] = by_rank
    return rep, counts, wall, swaps, list(np.diff(stamps))


def require_rank_counts(label, rep, counts, swaps, measured=True):
    """Each active rank launched its own kernels: 3 CSR launches a
    measured step, 2 in its parity check and 3 in each of its engine's
    untimed first runs of a new shape signature (``n_compiles``), one
    gather a step with hits and one persisted-row gather a rebuild that
    keeps rows. The forward launches and the gathers run on the rank's
    ``trainer-worker-{rank}`` thread; the backward's CSR launch (layer 1
    transposed) on the thread PyTorch's autograd engine keeps for the
    card, one a measured step and one an untimed first run; no other
    thread launched."""
    ranks = {f"trainer-worker-{r}" for r in rep.active_ranks}
    backward = 0
    for r in rep.active_ranks:
        name = f"trainer-worker-{r}"
        res = rep.results[r]
        n_steps = len(res.step_hits)
        with_hits = int((res.step_hits > 0).sum())
        kept = sum(bool(plan.persisted.any())
                   for t, plan in swaps if t == name)
        csr = counts["by_rank"]["csr_spmm"].get(r, 0)
        bags = counts["by_rank"]["embedding_bag"].get(r, 0)
        warm = res.compute_report["n_compiles"] if measured else 0
        want = 3 * n_steps + 2 + 3 * warm if measured else 0
        require(csr == want, f"{label}: rank {r} launched csr_spmm {csr} "
                f"times, not {want} ({warm} untimed first runs)")
        fwd = counts["csr_spmm"].get(name, 0)
        want_fwd = 2 * n_steps + 2 + 2 * warm if measured else 0
        require(fwd == want_fwd, f"{label}: rank {r}'s thread launched "
                f"csr_spmm {fwd} times, not {want_fwd}")
        backward += n_steps + warm if measured else 0
        require(bags == counts["embedding_bag"].get(name, 0)
                == with_hits + kept,
                f"{label}: rank {r} launched embedding_bag {bags} times "
                f"({counts['embedding_bag'].get(name, 0)} on its thread), "
                f"not {with_hits} steps with hits + {kept} rebuilds with "
                "persisted rows")
    other = {t: n for t, n in counts["csr_spmm"].items() if t not in ranks}
    require(sum(other.values()) == backward and len(other) <= 1,
            f"{label}: csr_spmm off the ranks' threads {other}, not "
            f"{backward} backward launches on the autograd engine's thread")
    other = {t: n for t, n in counts["embedding_bag"].items()
             if t not in ranks}
    require(not other, f"{label}: embedding_bag launched off the ranks' "
            f"threads: {other}")


def rank_epoch_joules(res, epoch: int) -> float:
    """One rank's node energy in one epoch (raw, as ``totals_kj`` sums)."""
    marks = res.meter.epoch_marks
    prev = marks[epoch - 1] if epoch else {"gpu_j": 0.0, "cpu_j": 0.0}
    return float(marks[epoch]["gpu_j"] + marks[epoch]["cpu_j"]
                 - prev["gpu_j"] - prev["cpu_j"])


def log_cluster(label, rep, counts, wall, per_step, smi):
    """One line a rank, and the cluster's totals."""
    for r in range(rep.n_workers):
        res = rep.results[r]
        name = f"trainer-worker-{r}"
        joules = [round(rank_epoch_joules(res, e), 4)
                  for e in range(len(res.meter.epoch_marks))]
        cr = res.compute_report
        step_ms = (f", measured step {statistics.median(cr['step_s']) * 1e3:.3f}"
                   " ms median" if cr else "")
        log(f"cluster {label} rank {r} ({rep.methods[r]}): joules per epoch "
            f"{joules}, wall {res.meter.wall_s:.6f} s, barrier wait "
            f"{rep.sync_wait_s[r]:.6f} s, collective {rep.sync_coll_s[r]:.6f}"
            f" s, queueing {rep.requester_metrics[r]['queue_s']:.6f} s, "
            f"hits {int(res.step_hits.sum())}, misses "
            f"{int(res.step_misses.sum())}, launches csr_spmm "
            f"{counts['by_rank']['csr_spmm'].get(r, 0)} "
            f"({counts['csr_spmm'].get(name, 0)} on its thread) "
            f"embedding_bag {counts['by_rank']['embedding_bag'].get(r, 0)}"
            f"{step_ms}")
    host = (f"{statistics.median(per_step) * 1e3:.3f} ms median, "
            f"{statistics.mean(per_step) * 1e3:.3f} ms mean"
            if per_step else "n/a")
    log(f"cluster {label}: csr_spmm launches by thread {counts['csr_spmm']}")
    log(f"cluster {label}: totals_kj {rep.totals_kj()}, total queueing "
        f"{rep.total_queue_s:.6f} s, grad wire bytes {rep.grad_wire_bytes:.0f}"
        f" ({rep.grad_compression}), host wall per global step {host}, run "
        f"{wall:.2f} s; {smi}")


def cluster_cfg(device, **kw):
    """CLUSTER with device payloads over an unlimited host tier."""
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    return gt.RunConfig(**dict(CLUSTER, **kw),
                        mem_budget=MemoryBudget(device_payloads=True),
                        device=str(device))


def phase_cluster(torch, device, smi, qnet):
    """P = 4 GreenDyGNN trainers on the card over one shared fabric
    (``repro_torch.train.cluster.run_cluster``), held against the CPU."""
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.analysis import digest as dg
    from repro_torch.core import controller as ctl, cost_model as cm, dqn
    from repro_torch.train import cluster as cl
    from repro_torch.train import compute as comp
    from repro_torch.train import gnn_trainer as gt

    P = CLUSTER_P
    cc = cl.ClusterConfig(n_workers=P)

    # 1. modeled lane: the reference's pinned P = 4 digest, card and CPU
    for dev in (str(device), "cpu"):
        rep = cl.run_cluster(gt.RunConfig(**CLUSTER_PIN, device=dev), cc)
        got = dg.report_digest(rep)
        require(got == CLUSTER_PIN_DIGEST,
                f"cluster pin on {dev}: report_digest {got[:8]}… != "
                f"{CLUSTER_PIN_DIGEST[:8]}…")
    log(f"cluster pin (P={P}, modeled): report_digest {got[:8]}… on the "
        "card and on the CPU")
    cpu_cfg = gt.RunConfig(**CLUSTER, device="cpu")
    bundles = cl.build_cluster_traces(cpu_cfg, P)
    dev_rows = int(cpu_cfg.cache_frac * bundles[0][0].n_nodes)
    n_feat = bundles[0][0].features.shape[1]
    log(f"cluster: {P} device tiers of {dev_rows} x {n_feat} float32 rows, "
        f"{dev_rows * n_feat * 4 / 1e6:.2f} MB each, one per rank")
    digests = []
    for dev in (device, "cpu"):
        cfg = cluster_cfg(dev, compute="modeled", scenario="paper_schedule")
        rep, counts, wall, swaps, per_step = counted_cluster(
            torch, cfg, cc, bundles)
        if dev == device:
            require_rank_counts("modeled paper_schedule", rep, counts, swaps,
                                measured=False)
            log_cluster("modeled paper_schedule (card)", rep, counts, wall,
                        per_step, smi)
        digests.append(dg.report_digest(rep))
    require(digests[0] == digests[1],
            "cluster modeled paper_schedule with device payloads: card "
            f"digest {digests[0][:8]}… != CPU's {digests[1][:8]}…")
    log(f"cluster modeled paper_schedule with device payloads: digest "
        f"{digests[0][:8]}… on the card and on the CPU")

    # 2. measured lane, static_w, under clean and paper_schedule
    torch.cuda.reset_peak_memory_stats(device)
    measured = {}
    for scenario in ("clean", "paper_schedule"):
        out = {}
        for dev in (device, "cpu"):
            cfg = cluster_cfg(dev, scenario=scenario)
            out[str(dev)] = counted_cluster(torch, cfg, cc, bundles)
        rep, counts, wall, swaps, per_step = out[str(device)]
        cpu = out["cpu"][0]
        require_rank_counts(f"measured {scenario}", rep, counts, swaps)
        log_cluster(f"measured static_w {scenario}", rep, counts, wall,
                    per_step, smi)
        for r in range(P):
            a, b = rep.results[r], cpu.results[r]
            require(np.array_equal(a.step_hits, b.step_hits)
                    and np.array_equal(a.step_misses, b.step_misses),
                    f"cluster measured {scenario}: rank {r}'s hit/miss "
                    "streams differ from the CPU's")
            la = np.asarray(a.compute_report["losses"])
            lb = np.asarray(b.compute_report["losses"])
            require(np.all(np.isfinite(la))
                    and np.allclose(la, lb, **TOL_CLUSTER_LOSS),
                    f"cluster measured {scenario}: rank {r}'s losses max "
                    f"rel diff {np.max(np.abs(la - lb) / np.abs(lb)):.3e}")
        rel = max(float(np.max(np.abs(
            np.asarray(rep.results[r].compute_report["losses"])
            - np.asarray(cpu.results[r].compute_report["losses"]))
            / np.abs(np.asarray(cpu.results[r].compute_report["losses"]))))
            for r in range(P))
        log(f"cluster measured static_w {scenario}: every rank's hit/miss "
            f"streams equal the CPU's, losses max rel diff {rel:.3e}")
        measured[scenario] = out[str(device)]
    log(f"cluster measured: peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 1e6:.1f} MB")

    # 3. measured lane, greendygnn under the table-trained policy
    decisions = []
    decide = ctl.AdaptiveController.decide

    def logged_decide(self, stats):
        out = decide(self, stats)
        decisions.append((threading.current_thread().name, int(out[0])))
        return out

    ctl.AdaptiveController.decide = logged_decide
    try:
        cfg = cluster_cfg(device, method="greendygnn",
                          scenario="paper_schedule",
                          q_fn=dqn.q_fn_of(qnet))
        rep, counts, wall, swaps, per_step = counted_cluster(
            torch, cfg, cc, bundles)
    finally:
        ctl.AdaptiveController.decide = decide
    require_rank_counts("greendygnn", rep, counts, swaps)
    log_cluster("measured greendygnn paper_schedule", rep, counts, wall,
                per_step, smi)
    for r in range(P):
        mine = [w for t, w in decisions if t == f"trainer-worker-{r}"]
        require(len(mine) >= 1, f"cluster greendygnn: rank {r} never decided")
        require(all(w in cm.WINDOW_CHOICES for w in mine),
                f"cluster greendygnn: rank {r} chose windows {mine}")
        log(f"cluster greendygnn rank {r}: decisions {mine}, windows per "
            f"epoch {rep.results[r].window_per_epoch.tolist()}")

    # 4. emergent congestion (modeled lane, device payloads, on the card)
    def modeled(**kw):
        cfg = cluster_cfg(device, compute="modeled")
        rep, counts, wall, swaps, _ = counted_cluster(
            torch, cfg, dataclasses.replace(cc, **kw), bundles)
        require_rank_counts(f"modeled {kw}", rep, counts, swaps,
                            measured=False)
        return rep

    clean = modeled()
    hot = modeled(link_rate_scale=(0.25, 1.0, 1.0, 1.0))
    log(f"cluster hot owner (partition 0 at 0.25): total queueing "
        f"{hot.total_queue_s:.6f} s against clean {clean.total_queue_s:.6f} "
        "s; mean transfer by rank "
        f"{[round(m['mean_transfer_s'], 6) for m in hot.requester_metrics]} "
        "against "
        f"{[round(m['mean_transfer_s'], 6) for m in clean.requester_metrics]}")
    require(hot.total_queue_s > clean.total_queue_s,
            "cluster: the hot owner did not raise the fabric's queueing")
    slow = modeled(compute_scale=(2.0, 1.0, 1.0, 1.0))
    stale = modeled(compute_scale=(2.0, 1.0, 1.0, 1.0), max_stale=1,
                    max_lag=2)
    log(f"cluster straggler (rank 0 at 2x t_base): barrier wait by rank "
        f"{slow.sync_wait_s.tolist()}; with max_stale=1 "
        f"{stale.sync_wait_s.tolist()}")
    require(bool(np.all(slow.sync_wait_s[1:] > 0)),
            "cluster: the straggler's peers did not wait at the barrier")
    require(stale.sync_wait_s[1:].sum() < slow.sync_wait_s[1:].sum(),
            "cluster: max_stale=1 did not cut the peers' barrier wait")

    # 5. compression: the wire bytes charged, and card against CPU
    graph = bundles[0][0]
    none_bytes = measured["clean"][0].grad_wire_bytes
    for scheme in ("int8", "topk"):
        cfg = cluster_cfg(device, n_epochs=1)
        ccs = dataclasses.replace(cc, grad_compression=scheme, topk_frac=0.05)
        rep, counts, wall, swaps, per_step = counted_cluster(
            torch, cfg, ccs, bundles)
        require_rank_counts(f"measured {scheme}", rep, counts, swaps)
        want = comp.model_wire_bytes(graph, scheme, 0.05)
        require(rep.grad_wire_bytes == want
                and all(r.compute_report["sync_wire_bytes"] == want
                        for r in rep.results),
                f"cluster {scheme}: grad_wire_bytes {rep.grad_wire_bytes} != "
                f"model_wire_bytes {want}")
        log_cluster(f"measured {scheme}", rep, counts, wall, per_step, smi)
        log(f"cluster {scheme}: {want:.0f} wire bytes a sync, "
            f"{none_bytes / want:.3f}x fewer than uncompressed "
            f"({none_bytes:.0f})")
        if scheme == "int8":
            require(3.5 < none_bytes / want < 4.0,
                    f"cluster int8: {none_bytes / want:.3f}x, not about 4x")
    compression_card_vs_cpu(torch, device, bundles[0])

    # 6. the modeled-lane model (run_model=True), P = 1, card against CPU,
    # at RUN_MODEL: at the main path's batch (and the pin's 8 steps) a
    # batch repeats a seed, and the model step (the reference's and so the
    # port's) takes a label per seed against a logit per distinct seed
    from repro_torch.train.worker import TrainerWorker

    losses = {}
    pin_bundle = gt.build_trace(gt.RunConfig(**RUN_MODEL, device="cpu"))
    for dev in (str(device), "cpu"):
        cfg = gt.RunConfig(**RUN_MODEL, device=dev)
        w = TrainerWorker(cfg, pin_bundle)
        for e in range(cfg.n_epochs):
            w.begin_epoch(e)
            for s in range(cfg.steps_per_epoch):
                w.step(e, s)
            w.end_epoch(e)
        losses[dev] = (np.asarray(w.model_state["losses"]), w.acc_log[-1])
    (la, acc_a), (lb, acc_b) = losses[str(device)], losses["cpu"]
    require(np.all(np.isfinite(la)) and np.allclose(la, lb,
                                                    **TOL_CLUSTER_LOSS),
            f"run_model modeled lane: card losses {la} against CPU {lb}")
    log(f"run_model (modeled lane, P=1): card losses "
        f"{[round(float(x), 5) for x in la]}, max rel diff to the CPU "
        f"{float(np.max(np.abs(la - lb) / np.abs(lb))):.3e}, accuracy "
        f"{acc_a:.4f} (CPU {acc_b:.4f})")

    cluster_profile(torch, device, bundles, measured["clean"][4])
    cold_build_cluster(torch, device, bundles)


def compression_card_vs_cpu(torch, device, bundle):
    """int8 and top-k of one fixed set of SAGE gradients (the first
    mini-batch's, an error of a hundredth of them carried in) on the card
    and on the CPU: int8 bit for bit, top-k the same kept entries."""
    import numpy as np

    from repro_torch.optim import optimizers as optim
    from repro_torch.train import compute as comp
    from repro_torch.train import grad_compression as gc

    graph, _, _, mbs = bundle
    cfg = cluster_cfg(device)
    eng = comp.ComputeEngine(graph, cfg)
    mb = mbs[0][0]
    layers, x_rows, _ = eng.prepare(mb)
    x = eng.pad_input(np.asarray(graph.features[mb.input_nodes], np.float32),
                      x_rows)
    _, grads = eng.loss_and_grads(x, layers)
    err = optim.tree_map(lambda g: g * 0.01, grads)
    host = optim.tree_map(lambda g: g.cpu(), grads)
    host_err = optim.tree_map(lambda g: g.cpu(), err)
    for label, fn in (("int8", gc.compress_int8),
                      ("topk", lambda g, e: gc.compress_topk(g, e, 0.05))):
        card = fn(grads, err)
        cpu = fn(host, host_err)
        same = all(torch.equal(a.cpu(), b) for tree_a, tree_b in zip(card, cpu)
                   for a, b in zip(optim.tree_leaves(tree_a),
                                   optim.tree_leaves(tree_b)))
        require(same, f"compression {label}: the card's result differs from "
                "the CPU's")
        kept = sum(int((t != 0).sum()) for t in optim.tree_leaves(card[0]))
        log(f"compression {label} of the first mini-batch's SAGE gradients: "
            f"card equal to the CPU bit for bit ({kept} nonzero entries "
            "sent)")


def cluster_profile(torch, device, bundles, per_step):
    """Device busy and idle share over one ``torch.profiler`` window of 2
    global steps of the measured static_w cluster (all ranks parked at the
    gate at both ends), against the unprofiled host wall per global step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import cluster as cl

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as probe:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    lead = set(device_time_by_name(probe))
    prof = profile(activities=acts)
    arrived = cl._StepGate.await_all_arrived
    seen = {"g": -1, "t": []}
    first = CLUSTER_PROFILE_STEP

    def hooked(self):
        arrived(self)
        seen["g"] += 1
        if seen["g"] == first:
            torch.cuda.synchronize()
            prof.start()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
            seen["t"].append(time.perf_counter())
        elif seen["g"] == first + 2:
            torch.cuda.synchronize()
            seen["t"].append(time.perf_counter())
            time.sleep(0.05)
            prof.stop()

    cl._StepGate.await_all_arrived = hooked
    try:
        cfg = cluster_cfg(device, n_epochs=1)
        rep, counts, _, _, _ = counted_cluster(
            torch, cfg, cl.ClusterConfig(n_workers=CLUSTER_P), bundles)
    finally:
        cl._StepGate.await_all_arrived = arrived
    by_name = {n: v for n, v in device_time_by_name(prof).items()
               if n not in lead}
    require(bool(by_name), "cluster profile: no device time in the window")
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3 / 2
    profiled_ms = (seen["t"][1] - seen["t"][0]) * 1e3 / 2
    host_ms = statistics.median(per_step) * 1e3
    n_csr = sum(c for n, (_, c) in by_name.items() if "csr_spmm_kernel" in n)
    n_bag = sum(c for n, (_, c) in by_name.items()
                if "embedding_bag_kernel" in n)
    log(f"cluster profile (2 global steps, P={CLUSTER_P}): device busy "
        f"{busy_ms:.3f} ms a global step, idle share "
        f"{1.0 - busy_ms / host_ms:.4f} of the unprofiled host wall "
        f"({host_ms:.3f} ms a global step; {profiled_ms:.3f} ms profiled); "
        f"{n_csr} csr_spmm_kernel and {n_bag} embedding_bag_kernel launches "
        f"in the trace ({3 * 2 * CLUSTER_P} csr_spmm for the steps, and 3 for "
        "each untimed first run of a new shape signature)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, cnt) in top:
        log(f"  device {us / 1e3 / 2:8.4f} ms/global step x{cnt / 2:5.1f}"
            f"  {name[:80]}")


def cold_build_cluster(torch, device, bundles):
    """The kernels built from cold by the cluster's own first launches: a
    fresh build directory, no library loaded, and a measured threaded
    P = 4 run of 2 steps, whose 4 worker threads and 4 builder threads
    launch first. The build runs once, under the build lock."""
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.train import cluster as cl

    saved_dir, saved_libs = _build.BUILD_DIR, dict(_build._libs)
    build_all = _build.build_all
    builds = []

    def counted_build():
        secs = build_all()
        builds.append(secs)
        return secs

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        _build.BUILD_DIR = pathlib.Path(tmp)
        _build._libs.clear()
        _build.build_all = counted_build
        try:
            cfg = cluster_cfg(device, n_epochs=1, steps_per_epoch=2,
                              static_window=1, async_pipeline=True)
            t0 = time.perf_counter()
            rep, counts, _, _, _ = counted_cluster(
                torch, cfg, cl.ClusterConfig(n_workers=CLUSTER_P), bundles)
            wall = time.perf_counter() - t0
        finally:
            _build.BUILD_DIR = saved_dir
            _build.build_all = build_all
            _build._libs.clear()
            _build._libs.update(saved_libs)
    ranks = [f"trainer-worker-{r}" for r in range(CLUSTER_P)]
    require(len(builds) == 1 and builds[0],
            f"cold build: build_all ran {len(builds)} times ({builds})")
    require(all(counts["csr_spmm"].get(t, 0) > 0 for t in ranks),
            f"cold build: csr_spmm launches by thread {counts['csr_spmm']}")
    log(f"cluster cold build: one build of {sorted(builds[0])} from the "
        f"ranks' first launches ({max(builds[0].values()):.1f} s), P="
        f"{CLUSTER_P} threaded run {wall:.2f} s, launches by thread "
        f"{counts}")


# ------------------------------------------------------------- phase 4
def same_choice(a, b):
    """(argmax equal in every row, rows with equal argmax, max |a - b|)."""
    exact = a.argmax(dim=-1) == b.argmax(dim=-1)
    return bool(exact.all()), int(exact.sum()), float((a - b).abs().max())


# -------------------------------------------------------- the trace phase
# the reference's cluster sweep's hot owner: partition 0's NIC at 0.35
TRACE_HOT = (0.35, 1.0, 1.0, 1.0)


@contextlib.contextmanager
def steps_timed():
    """Host seconds of each ``TrainerWorker.step`` (a measured step ends
    in a device synchronisation, so its host wall covers its device
    work)."""
    from repro_torch.train.worker import TrainerWorker

    step = TrainerWorker.step
    walls = []

    def timed(self, epoch, s):
        t0 = time.perf_counter()
        out = step(self, epoch, s)
        walls.append(time.perf_counter() - t0)
        return out

    TrainerWorker.step = timed
    try:
        yield walls
    finally:
        TrainerWorker.step = step


@contextlib.contextmanager
def span_threads():
    """The threads each kind of greentrace span is emitted from:
    {(component, name): {thread name}}."""
    import threading

    from repro_torch.obs.tracer import Tracer

    span = Tracer.span
    seen = {}

    def recorded(self, component, name, *a, **k):
        seen.setdefault((component, name), set()).add(
            threading.current_thread().name)
        return span(self, component, name, *a, **k)

    Tracer.span = recorded
    try:
        yield seen
    finally:
        Tracer.span = span


def trace_events(payload, component=None, kind=None):
    return [e for sec in payload["ranks"] for e in sec["events"]
            if (component is None or e["component"] == component)
            and (kind is None or e["kind"] == kind)]


def require_owner_spans(label, payload):
    """Every fabric span decomposes per owner link: ready <= start <=
    finish, queueing >= 0, service > 0. Returns the spans."""
    spans = trace_events(payload, "fabric", "span")
    require(spans, f"{label}: no fabric spans")
    for s in spans:
        owners = s["args"]["owners"]
        require(owners, f"{label}: a fabric span without owners")
        for o in owners:
            require(o["finish_s"] >= o["start_s"] >= o["ready_s"]
                    and o["queue_s"] >= 0 and o["service_s"] > 0,
                    f"{label}: fabric span owner {o} does not decompose")
    return spans


def trace_capture(torch, device):
    """``python -m repro_torch.obs capture --workers 4`` on the card (the
    modeled lane): both files byte-equal to the committed reference
    captures, reconciled, the hot owner's link-0 queueing the top mover,
    and ``report --chrome`` writes a Chrome trace."""
    import tempfile

    from repro_torch.obs import __main__ as cli
    from repro_torch.obs import load_trace, reconcile, report

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        require(cli.main(["capture", "--workers", "4", "--device",
                          str(device), "--out", str(tmp)]) == 0,
                "trace capture: exit code")
        wall = time.perf_counter() - t0
        for name in ("clean", "hot_owner"):
            got = (tmp / f"{name}.json").read_bytes()
            want = (ROOT / "results" / "traces" / f"{name}.json").read_bytes()
            require(got == want, f"trace capture: {name}.json differs from "
                    f"results/traces/{name}.json ({len(got)} against "
                    f"{len(want)} bytes)")
        clean = load_trace(tmp / "clean.json")
        hot = load_trace(tmp / "hot_owner.json")
        reconcile(clean)
        reconcile(hot)
        top = report.diff(clean, hot)[0]
        require(top["key"] == "link0/queue" and top["delta_j"] > 0,
                f"trace capture: top diff row {top}")
        chrome = tmp / "hot_owner.chrome.json"
        require(cli.main(["report", str(tmp / "hot_owner.json"), "--chrome",
                          str(chrome)]) == 0, "trace report --chrome")
        n_chrome = len(json.loads(chrome.read_text())["traceEvents"])
    n_events = sum(len(s["events"]) for s in hot["ranks"])
    log(f"trace capture (P=4, modeled, on the card): clean.json and "
        f"hot_owner.json byte-equal to results/traces, {n_events} events, "
        f"reconciled; diff top {top['key']} {top['delta_j']:+.3f} J; chrome "
        f"{n_chrome} trace events; {wall:.2f} s")
    return {"byte_equal": True, "events": n_events, "diff_top": top["key"],
            "diff_top_delta_j": top["delta_j"], "chrome_events": n_chrome}


def trace_main_path(torch, device, smi, qnet):
    """The main path (greendygnn, device payloads, the table-trained
    qnet, 3 x 8 measured steps) untraced, traced, traced, untraced. The
    first run's decisions are replayed in the others (each decision's
    argmax forced), so all four take the same windows: the traced runs'
    SpMM and EmbeddingBag launches must equal the untraced runs', their
    ledgers reconcile bit for bit, one ``controller/decide`` instant
    carries each decision, and every ``compute/measured`` span names the
    card and is memory-bound at its peaks."""
    import dataclasses

    import numpy as np

    from repro_torch.core import dqn
    from repro_torch.obs import reconcile
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt

    q_base = dqn.q_fn_of(qnet)
    recorded = []
    policy = []        # a replaying run's own argmax at each decision

    def record(state):
        q = np.asarray(q_base(state))
        recorded.append(int(np.argmax(q)))
        return q

    def replay(state):
        q = np.asarray(q_base(state), np.float64).copy()
        policy[-1].append(int(np.argmax(q)))
        q[recorded[len(policy[-1]) - 1]] = q.max() + 1.0
        return q

    cfg = gt.RunConfig(**MAIN_PATH, q_fn=record,
                       mem_budget=MemoryBudget(host_bytes=None,
                                               device_payloads=True),
                       device=str(device))
    bundle = gt.build_trace(cfg)
    card = torch.cuda.get_device_name(device)
    n_steps = cfg.n_epochs * cfg.steps_per_epoch
    walls = {False: [], True: []}
    counts_by = {False: [], True: []}
    for i, traced in enumerate((False, True, True, False)):
        run_cfg = dataclasses.replace(cfg, trace=traced,
                                      q_fn=record if i == 0 else replay)
        policy.append([])
        with steps_timed() as step_walls:
            res, counts, wall, plans = counted_run(torch, run_cfg, bundle)
        label = f"trace main path ({'traced' if traced else 'untraced'})"
        require_path_counts(label, res, counts, plans)
        walls[traced].append(statistics.median(step_walls) * 1e3)
        counts_by[traced].append(
            {k: counts[k] for k in ("csr_spmm", "embedding_bag")})
        if not traced:
            require(res.trace is None, f"{label}: trace=False gave a trace")
            continue
        totals = reconcile(res.trace)
        m = res.trace["ranks"][0]["meter"]
        require(totals[0]["gpu_j"] == m["gpu_j"] == res.meter.gpu_j
                and totals[0]["cpu_j"] == m["cpu_j"] == res.meter.cpu_j,
                f"{label}: the ledger's totals differ from the meter's")
        decides = trace_events(res.trace, "controller", "instant")
        require([e["args"]["action"] for e in decides] == recorded,
                f"{label}: decide instants "
                f"{[e['args']['action'] for e in decides]} != decisions "
                f"{recorded}")
        spans = trace_events(res.trace, "compute", "span")
        require(len(spans) == n_steps,
                f"{label}: {len(spans)} compute spans for {n_steps} steps")
        for s in spans:
            a = s["args"]
            require(a["roof_device"] == card and a["bound"] == "memory",
                    f"{label}: compute span args {a}")
        roof = spans[-1]["args"]
    require(len(recorded) >= 1, "trace main path: the controller never "
            "decided")
    require(all(c == counts_by[False][0]
                for c in counts_by[False] + counts_by[True]),
            f"trace main path: launch counts differ, untraced "
            f"{counts_by[False]}, traced {counts_by[True]}")
    agree = sum(a == b for run in policy for a, b in zip(run, recorded))
    n_replayed = sum(len(run) for run in policy)
    ms = (f"{statistics.median(walls[True]):.3f} (runs "
          f"{[round(w, 3) for w in walls[True]]}) traced, "
          f"{statistics.median(walls[False]):.3f} (runs "
          f"{[round(w, 3) for w in walls[False]]}) untraced")
    log(f"trace main path (P=1, greendygnn, measured): reconciled "
        f"bit-exact, decisions {recorded} (the replaying runs' own argmax "
        f"agreed at {agree} of {n_replayed}), launches "
        f"{counts_by[True][0]} traced and untraced; last compute span "
        f"{roof}; host wall a step, median ms: {ms}; {smi}")
    return {"reconciled": True, "decisions": len(recorded),
            "launches": counts_by[True][0],
            "host_ms_per_step_traced": statistics.median(walls[True]),
            "host_ms_per_step_untraced": statistics.median(walls[False]),
            "roof_device": card, "bound": roof["bound"],
            "roof_memory_s": roof["roof_memory_s"],
            "roof_compute_s": roof["roof_compute_s"]}


def trace_pipeline(torch, device):
    """The threaded pipeline (static_w, W = 4) traced, beside the same run
    untraced: equal launches; each rebuild's ``plan`` and ``fetch`` spans
    from the builder thread and its ``exposed-wait`` and ``swap`` spans
    from the consumer; the ledger reconciles bit for bit."""
    from repro_torch.obs import reconcile
    from repro_torch.train import gnn_trainer as gt

    out = {}
    for traced in (False, True):
        cfg = pipeline_cfg(device, async_pipeline=True, trace=traced)
        with span_threads() as seen:
            res, counts, wall, plans = counted_run(torch, cfg,
                                                   gt.build_trace(cfg))
        require_path_counts(f"trace pipeline (trace={traced})", res, counts,
                            plans)
        out[traced] = (res, counts, seen)
    res, counts, seen = out[True]
    require(counts == out[False][1],
            f"trace pipeline: launches {counts} traced, {out[False][1]} "
            "untraced")
    reconcile(res.trace)
    n = res.pipeline.n_rebuilds
    names = {}
    for e in trace_events(res.trace, "pipeline", "span"):
        names[e["name"]] = names.get(e["name"], 0) + 1
    require(n > 0 and names == {"plan": n, "fetch": n, "exposed-wait": n,
                                "swap": n},
            f"trace pipeline: spans {names} for {n} rebuilds")
    require(seen[("pipeline", "plan")] == {"cache-builder"}
            and seen[("pipeline", "fetch")] == {"cache-builder"}
            and "cache-builder" not in seen[("pipeline", "exposed-wait")]
            and "cache-builder" not in seen[("pipeline", "swap")],
            f"trace pipeline: span threads {seen}")
    log(f"trace pipeline (static_w W=4, threaded): {n} rebuilds, spans "
        f"{names}, plan/fetch on the builder thread, reconciled bit-exact, "
        f"launches {counts} traced and untraced")
    return {"rebuilds": n, "spans": names, "reconciled": True}


def trace_budgeted(torch, device):
    """ooc_community under a host budget of 0.3 of its matrix, traced,
    synchronous, on the card and on the CPU: one ``store/tier-window``
    counter a window, the counters' deltas summing to the tier counts at
    the last window's boundary (the last window's own steps come after
    it, as in the reference), the card's counters equal to the CPU's, and
    both ledgers reconcile."""
    from repro_torch.graph import datasets
    from repro_torch.obs import reconcile
    from repro_torch.store import MemoryBudget
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train.worker import TrainerWorker

    src = datasets.materialize("ooc_community", seed=0).feature_source
    host = 0.3 * src.n_rows * src.bytes_per_row
    counters = TrainerWorker._trace_tier_counters
    tiers = []                # the card's run's tier-window counters, the CPU's
    for dev in (str(device), "cpu"):
        snapshots = []

        def snapshot(self, *a, _s=snapshots):
            counters(self, *a)
            _s.append(self.store.tier_stats.counts())

        cfg = gt.RunConfig(**BUDGETED, trace=True, mem_budget=MemoryBudget(
            host_bytes=host, chunk_rows=256, device_payloads=True),
            device=dev)
        TrainerWorker._trace_tier_counters = snapshot
        try:
            res, counts, wall, plans = counted_run(torch, cfg,
                                                   gt.build_trace(cfg))
        finally:
            TrainerWorker._trace_tier_counters = counters
        if not tiers:
            require_path_counts("budgeted trace", res, counts, plans)
            card_res, card_counts = res, counts
        reconcile(res.trace)
        cs = [e["args"] for e in trace_events(res.trace, "store", "counter")]
        windows = trace_events(res.trace, "window", "instant")
        require(len(cs) == len(windows) == len(snapshots) > 0,
                f"budgeted trace on {dev}: {len(cs)} counters for "
                f"{len(windows)} windows")
        total = {}
        for c in cs:
            for k, v in c.items():
                if k != "peak_resident_bytes":
                    total[k] = total.get(k, 0) + v
        last = dict(snapshots[-1])
        require(last.pop("peak_resident_bytes")
                == cs[-1]["peak_resident_bytes"]
                and total == last, f"budgeted trace on {dev}: counter sums "
                f"{total} != tier counts at the last boundary {last}")
        tiers.append(cs)
    cs = tiers[0]
    require(cs == tiers[1],
            "budgeted trace: the card's tier counters differ from the CPU's")
    log(f"trace budgeted ooc_community: {len(cs)} tier-window counters, "
        f"equal to the CPU's, summing to the last boundary's tier counts; "
        f"tier_counts {card_res.tier_counts}; launches {card_counts}; "
        "reconciled")
    return {"windows": len(cs), "counters_equal_cpu": True,
            "reconciled": True}


def trace_cluster(torch, device, smi):
    """P = 4 measured ``run_cluster`` (static_w, device payloads) under
    ``clean``: untraced, traced, traced, untraced, the traced runs'
    launches by rank equal to the untraced runs'; then traced with
    partition 0's NIC at 0.35. Every rank reconciles bit for bit, every
    fabric span decomposes per owner, and the hot owner's link-0
    queueing attribution is larger than under ``clean``."""
    from repro_torch.obs import reconcile, report
    from repro_torch.train import cluster as cl
    from repro_torch.train import gnn_trainer as gt

    P = CLUSTER_P
    bundles = cl.build_cluster_traces(gt.RunConfig(**CLUSTER, device="cpu"),
                                      P)
    walls = {False: [], True: []}
    by_rank = {False: [], True: []}
    reps = {}
    runs = [(False, "clean"), (True, "clean"), (True, "clean"),
            (False, "clean"), (True, "hot")]
    for traced, scen in runs:
        cc = cl.ClusterConfig(n_workers=P, **(
            {"link_rate_scale": TRACE_HOT} if scen == "hot" else {}))
        cfg = cluster_cfg(device, scenario="clean", trace=traced)
        rep, counts, wall, swaps, per_step = counted_cluster(
            torch, cfg, cc, bundles)
        label = f"trace cluster {scen} (trace={traced})"
        require_rank_counts(label, rep, counts, swaps)
        if scen == "clean":
            walls[traced].append(float(statistics.median(per_step)) * 1e3)
            by_rank[traced].append(counts["by_rank"])
        if not traced:
            require(rep.trace is None, f"{label}: trace=False gave a trace")
            continue
        totals = reconcile(rep.trace)
        require(sorted(totals) == list(range(P))
                and all(totals[r]["gpu_j"] == rep.results[r].meter.gpu_j
                        and totals[r]["cpu_j"] == rep.results[r].meter.cpu_j
                        for r in range(P)),
                f"{label}: a rank's ledger differs from its meter")
        require_owner_spans(label, rep.trace)
        reps[scen] = rep
    require(all(c == by_rank[False][0] for c in by_rank[False] + by_rank[True]),
            f"trace cluster: launches by rank differ, untraced "
            f"{by_rank[False]}, traced {by_rank[True]}")
    att = {s: report.attribution(r.trace) for s, r in reps.items()}
    q_clean = att["clean"].get("link0/queue", 0.0)
    q_hot = att["hot"].get("link0/queue", 0.0)
    require(q_hot > q_clean, f"trace cluster: link0/queue {q_hot} J under "
            f"the hot owner, not above clean's {q_clean} J")
    ms = (f"{statistics.median(walls[True]):.3f} (runs "
          f"{[round(w, 3) for w in walls[True]]}) traced, "
          f"{statistics.median(walls[False]):.3f} (runs "
          f"{[round(w, 3) for w in walls[False]]}) untraced")
    log(f"trace cluster (P={P}, measured static_w): every rank reconciled "
        f"bit-exact, fabric spans per owner, launches by rank "
        f"{by_rank[True][0]} traced and untraced; link0/queue {q_clean:.6f}"
        f" J clean, {q_hot:.6f} J hot owner; host wall a global step, "
        f"median ms: {ms}; {smi}")
    return {"reconciled": True, "link0_queue_j_clean": q_clean,
            "link0_queue_j_hot": q_hot,
            "host_ms_per_global_step_traced": statistics.median(walls[True]),
            "host_ms_per_global_step_untraced":
                statistics.median(walls[False])}


def phase_trace(torch, device, smi, qnet):
    """greentrace on the card: the modeled capture byte-equal to the
    reference's, then ``trace=True`` through the main path, the threaded
    pipeline, the budgeted tier and the P = 4 cluster."""
    out = {"capture": trace_capture(torch, device),
           "p1": trace_main_path(torch, device, smi, qnet),
           "pipeline": trace_pipeline(torch, device),
           "budgeted": trace_budgeted(torch, device),
           "p4": trace_cluster(torch, device, smi)}
    return out


@contextlib.contextmanager
def routing(replay=None):
    """Every MoE layer's routing while the context is open: the
    ``moe.route_topk`` calls' (weights, experts), in call order, into the
    list it yields. With ``replay`` (a call's index -> the (weights,
    experts) to take), each call takes the replayed routing instead of its
    own, and the yielded stats count the (token, expert) assignments its
    own router picked that the replayed routing does not."""
    from repro_torch.models.lm import moe

    route = moe.route_topk
    calls, stats = [], {"assignments": 0, "flipped": 0}

    def hooked(logits, top_k):
        w, e = route(logits, top_k)
        if replay is not None:
            rw, re_ = replay(len(calls))
            kept = (e[:, :, None] == re_[:, None, :]).any(-1)
            stats["assignments"] += e.numel()
            stats["flipped"] += int((~kept).sum())
            w, e = rw, re_
        calls.append((w, e))
        return w, e

    moe.route_topk = hooked
    try:
        yield calls, stats
    finally:
        moe.route_topk = route


def moe_load(torch, calls, cfg, no_drop: bool = False):
    """(share of the (token, k) assignments dropped at the experts'
    capacity, the heaviest expert's load over the mean load) over the
    recorded MoE calls of ``cfg``."""
    from repro_torch.models.lm import moe

    dropped = total = 0
    heaviest = 0.0
    for _, e in calls:
        cap = moe.capacity_of(e.shape[0], cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor, no_drop)
        counts = torch.bincount(e.flatten(), minlength=cfg.n_experts)
        dropped += int((counts - cap).clamp_min(0).sum())
        total += e.numel()
        heaviest = max(heaviest,
                       float(counts.max()) * cfg.n_experts / e.numel())
    return dropped / max(total, 1), heaviest


def fit_depth(full, estimate, budget: float) -> int:
    """The most layers (down to 1) of ``full`` whose ``estimate`` of the
    peak bytes fits in ``budget``."""
    import dataclasses

    depth = full.n_layers
    while depth > 1 and estimate(
            dataclasses.replace(full, n_layers=depth)) > budget:
        depth -= 1
    return depth


def serve_peak_estimate(cfg, rows: int) -> float:
    """Bytes the serving phase holds at its peak: the bf16 weights, the
    full-depth flash-against-dense comparison's dense attention over
    ``rows`` sequences of ``PREFILL_S`` (float32 scores and probabilities
    beside their bf16 copies: ~10 bytes a (head, query, key), as measured
    at deepseek-v2's 128 heads; none at the MoE archs, which make that
    comparison on a model of their own, ``phase_moe_paths``), and ~3 GB
    of activations, logits and cache."""
    return (2.0 * lm_param_counts(cfg)[0]
            + 10.0 * rows * cfg.n_heads * PREFILL_S ** 2 + 3e9)


def phase_serving(torch, device, arch_id: str = "tinyllama-1.1b"):
    """The LM serving path of ``arch_id`` at full width, through the
    user's entry points, with the launch counts zeroed just before and
    read just after; the depth cut only where ``serve_peak_estimate`` does
    not fit ``MEM_FRAC`` of the card (deepseek-v2). The MoE archs log
    their routing (the share of assignments dropped at capacity, the
    heaviest expert's load). Then ``compare_paths``: decode against
    prefill and flash against dense; at the MoE archs, decode against
    prefill at ``TOL_MOE_DEEP`` and the serve run's logits equal to the
    decode steps', flash against dense left to ``phase_moe_paths``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.launch import serve
    from repro_torch.models.lm import transformer as tf
    from repro_torch.optim.optimizers import tree_leaves

    full = get_arch(arch_id).make_config()
    rows = 0 if full.moe else PREFILL_B   # the dense comparison's sequences
    budget = MEM_FRAC * torch.cuda.get_device_properties(device).total_memory
    depth = fit_depth(full, lambda c: serve_peak_estimate(c, rows), budget)
    cfg = (full if depth == full.n_layers
           else dataclasses.replace(full, n_layers=depth))
    if depth < full.n_layers:
        log(f"serve {arch_id}: {lm_param_counts(full)[0] / 1e9:.3f}B "
            f"parameters at full depth ({full.n_layers} layers), the "
            f"phase's peak estimated at "
            f"{serve_peak_estimate(full, rows) / 1e9:.1f} GB against "
            f"{MEM_FRAC} of the card ({budget / 1e9:.1f} GB): depth cut to "
            f"{depth} layers (estimated "
            f"{serve_peak_estimate(cfg, rows) / 1e9:.1f} GB)")
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"{arch_id}: {n_params / 1e9:.3f}B parameters ({cfg.dtype}, "
        f"{cfg.n_layers} layers, {cfg.attn_type}"
        + (f", {cfg.first_k_dense} dense + {cfg.n_scan_layers} MoE of "
           f"{cfg.n_experts} experts, top-{cfg.top_k}, {cfg.n_shared} "
           f"shared" if cfg.moe else "")
        + f") drawn on the card in {time.perf_counter() - t0:.2f} s")
    has_moe = cfg.moe and cfg.n_scan_layers > 0
    prompts, tokens = serve_inputs(torch, cfg, device)

    csr_spmm.launches = 0
    embedding_bag.launches = 0
    flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with routing() as (serve_routes, _):
        res = serve.run(cfg, batch=4, prompt_len=SERVE_PROMPT,
                        gen_len=SERVE_GEN, device=device, prompts=prompts,
                        params=params)
    serve_s = time.perf_counter() - t0
    after_serve = flash_attention.launches
    t0 = time.perf_counter()
    with routing() as (prefill_routes, _):
        logits = tf.prefill(params, cfg, tokens)
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = {"csr_spmm": csr_spmm.launches,
              "embedding_bag": embedding_bag.launches,
              "flash_attention": flash_attention.launches}
    log(f"serving path {arch_id}: serve.run (batch 4, prompt 8, gen 16) "
        f"{serve_s:.2f} s "
        f"(decode {res.decode_s * 1e3 / 15:.2f} ms/step, "
        f"{4 * 15 / res.decode_s:.0f} tok/s), prefill B={PREFILL_B} "
        f"S={PREFILL_S} {prefill_s * 1e3:.1f} ms (first call), launches "
        f"{counts}; peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
        f"(max_memory_allocated; estimated "
        f"{serve_peak_estimate(cfg, rows) / 2**30:.2f} GiB)")
    require(after_serve == 0, f"decode steps launched the flash kernel "
            f"{after_serve} times")
    require(counts["flash_attention"] == cfg.n_layers,
            f"prefill launched the flash kernel {counts['flash_attention']} "
            f"times, not once per layer ({cfg.n_layers})")
    require(counts["csr_spmm"] == counts["embedding_bag"] == 0,
            "the serving path launched a trainer kernel")
    if has_moe:
        n_moe = cfg.n_scan_layers
        require(len(serve_routes) == 23 * n_moe
                and len(prefill_routes) == n_moe,
                f"{arch_id}: {len(serve_routes)} and {len(prefill_routes)} "
                f"MoE routings, not {23 * n_moe} and {n_moe}")
        drop_s, heavy_s = moe_load(torch, serve_routes, cfg, no_drop=True)
        drop_p, heavy_p = moe_load(torch, prefill_routes, cfg)
        log(f"MoE routing {arch_id}: decode steps (no drop, capacity B) "
            f"dropped {drop_s:.4f} of the assignments, heaviest expert "
            f"{heavy_s:.2f}x the mean load; prefill B={PREFILL_B} "
            f"S={PREFILL_S} (capacity factor {cfg.capacity_factor}) dropped "
            f"{drop_p:.4f}, heaviest expert {heavy_p:.2f}x the mean")
        require(drop_s == 0.0, f"{arch_id}: a decode step dropped")
    del serve_routes, prefill_routes

    # serve: the tokens, and the last prompt step's logits against prefill
    require(tuple(res.tokens.shape) == (4, 16), "serve tokens shape")
    require(bool(((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()),
            "serve tokens out of range")
    require(bool(torch.isfinite(res.prompt_logits).all()),
            "serve logits not finite")
    require(tuple(logits.shape) == (PREFILL_B, cfg.padded_vocab),
            "prefill shape")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    if not has_moe:
        compare_paths(torch, device, cfg, params, prompts, tokens, arch_id,
                      res.prompt_logits, logits)
    else:
        compare_paths(torch, device, cfg, params, prompts, tokens, arch_id,
                      res.prompt_logits, None, bound=TOL_MOE_DEEP,
                      dense=False)
    torch.cuda.empty_cache()
    hold_count(torch, f"prefill {arch_id} B={PREFILL_B} S={PREFILL_S}",
               lambda p, t: tf.prefill(p, cfg, t), (params, tokens),
               estimate=serve_peak_estimate(cfg, rows))
    cache = tf.init_cache(cfg, len(prompts), SERVE_PROMPT + SERVE_GEN,
                          device=device)
    hold_count(torch, f"decode {arch_id} B={len(prompts)} at {SERVE_PROMPT}",
               lambda p, tok, c: tf.decode_step(p, cfg, tok, c,
                                                SERVE_PROMPT),
               (params, prompts[:, -1:].to(device), cache))
    del cache
    torch.cuda.empty_cache()
    return counts, cfg, params, tokens


def serve_inputs(torch, cfg, device):
    """The serving phase's prompts (4, SERVE_PROMPT), on the host, and
    its prefill tokens (PREFILL_B, PREFILL_S), on ``device``."""
    gen = torch.Generator().manual_seed(SEED + 3)
    prompts = torch.randint(0, cfg.vocab, (4, SERVE_PROMPT), generator=gen)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen).to(device)
    return prompts, tokens


def phase_serve_arch(torch, device, arch_id: str) -> int:
    """A later slice's arch: its serving phase and prefill profile, then
    its MoE paths where it has experts, its parameters freed before the
    next arch's are drawn. Returns the flash launches of its prefill."""
    counts, cfg, params, tokens = phase_serving(torch, device, arch_id)
    phase_profile_prefill(torch, cfg, params, tokens)
    del params, tokens
    torch.cuda.empty_cache()
    if cfg.moe:
        phase_moe_paths(torch, device, arch_id)
    return counts["flash_attention"]


def phase_moe_paths(torch, device, arch_id: str) -> None:
    """An MoE arch's paths on a model of ``MOE_CMP_LAYERS`` layers drawn
    on its own (after the served model's parameters are freed, so that
    the dense comparison's memory does not cut the serving depth): decode
    steps against prefill and the S=4096 prefill through the flash kernel
    against the dense path, held at ``TOL_LOGITS``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import transformer as tf

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch_id).make_config(),
                              n_layers=MOE_CMP_LAYERS)
    params = tf.init(cfg, seed=SEED, device=device)
    prompts, tokens = serve_inputs(torch, cfg, device)
    compare_paths(torch, device, cfg, params, prompts, tokens, arch_id,
                  None, None)
    del params, tokens
    torch.cuda.empty_cache()
    log(f"MoE paths {arch_id} ({MOE_CMP_LAYERS} layers drawn on their "
        f"own): {time.perf_counter() - t0:.1f} s")


def compare_paths(torch, device, cfg, params, prompts, tokens, arch_id,
                  serve_logits, prefill_logits, bound=TOL_LOGITS,
                  dense: bool = True) -> dict:
    """Two paths of one model against each other, each held to ``bound``
    (None: logged only): the last prompt step of cached decode steps
    against ``prefill`` of the prompts (MLA: the absorbed decode against
    the expanded prefill), and, with ``dense``, the S=4096 prefill
    through the flash kernel against the dense path. ``bound`` is a
    max |diff| (``TOL_LOGITS``) with the argmax equal in every row, or a
    dict of ``max_abs`` and ``rel_l2`` (the row's relative L2) bounds
    (``TOL_MOE_DEEP``). At the MoE archs the argmax may differ where the
    top logits tie within the max |diff| bound; each path's pick must be
    that close to the other's best. ``serve_logits``/``prefill_logits``:
    the serve run's and the counted prefill's, when they are what the
    comparison takes. At the MoE archs a bf16 difference between two
    paths can flip an expert choice, and a flip moves which later tokens
    an expert's capacity drops, so the second path replays the first
    path's routing (``routing``; the share of assignments its own router
    picked otherwise is logged): decode steps replay a no-drop prefill of
    the prompts (decode routes without drops), and the dense path replays
    a flash prefill of one sequence (the dense comparison's memory); the
    serve run's logits, on its own routing, must equal those of the same
    decode steps on theirs. Returns {label: {max_abs, rel_l2,
    argmax_equal, rows, flipped}}."""
    import dataclasses

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import transformer as tf

    has_moe = cfg.moe and cfg.n_scan_layers > 0
    tag = f"{arch_id} ({cfg.n_layers} layers, {cfg.dtype})"
    deep = isinstance(bound, dict)
    window = bound["max_abs"] if deep else bound
    readings = {}

    def held(label, a, b, st, n_rows):
        ok, exact, tol = same_choice(a, b)
        if has_moe and window is not None:
            # each path's pick within the bound of the other's best: the
            # MoE archs' random-weight logits tie within the paths' bf16
            # difference in some rows (deepseek: 1 of 4 at 4 layers)
            ok = all(
                bool((y.gather(-1, x.argmax(-1, keepdim=True))[:, 0]
                      >= y.amax(-1) - window).all())
                for x, y in ((a, b), (b, a)))
        rel = float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())
        flipped = st["flipped"] / max(st["assignments"], 1)
        readings[label] = dict(max_abs=tol, rel_l2=rel, argmax_equal=exact,
                               rows=n_rows, flipped=flipped)
        flips = ("" if not st["assignments"] else
                 f"; the second path replayed the first's routing: "
                 f"{st['flipped']}/{st['assignments']} assignments "
                 f"({flipped:.4f}) its own router picked otherwise")
        log(f"{label} {tag}: max|diff| {tol:.4g} (logits max "
            f"|{float(b.abs().max()):.3f}|, row rel L2 {rel:.4g}), argmax "
            f"equal in {exact}/{n_rows} rows{flips}"
            + ("" if bound is not None else " (logged, not held)"))
        if deep:
            require(ok and tol <= bound["max_abs"]
                    and rel <= bound["rel_l2"],
                    f"{arch_id}: {label}: max|diff| {tol:.4g}, row rel L2 "
                    f"{rel:.4g} against {bound}")
        elif bound is not None:
            require(ok and tol <= bound, f"{arch_id}: {label}")

    path = ("absorbed MLA decode vs expanded prefill"
            if cfg.attn_type == "mla" else "decode vs prefill")
    none = {"assignments": 0, "flipped": 0}
    n_prompt = prompts.shape[1]
    if not has_moe:
        pre = tf.prefill(params, cfg, prompts.to(device)).float()
        held(f"serve vs prefill ({path}, S={n_prompt}, dense path)",
             serve_logits.float(), pre, none, 4)
    else:
        nd = dataclasses.replace(cfg, capacity_factor=2.0 * cfg.n_experts
                                 / cfg.top_k)
        with routing() as (rec, _):
            pre = tf.prefill(params, nd, prompts.to(device)).float()
        b_rows = torch.arange(4, device=device) * n_prompt

        def from_prefill(i):
            w, e = rec[i % cfg.n_scan_layers]
            at = b_rows + i // cfg.n_scan_layers
            return w[at], e[at]

        def decode(replay):
            # the serve run's cache length: its prompt steps' shapes
            cache = tf.init_cache(cfg, 4, SERVE_PROMPT + SERVE_GEN,
                                  device=device)
            with routing(replay) as (_, st):
                for i in range(n_prompt):
                    out, cache = tf.decode_step(
                        params, cfg, prompts[:, i:i + 1].to(device), cache, i)
            return out, st

        dec, st = decode(from_prefill)
        del rec
        held(f"decode steps vs no-drop prefill ({path}, S={n_prompt}, "
             "dense path)", dec.float(), pre, st, 4)
        if serve_logits is not None:
            own, _ = decode(None)
            gap = float((serve_logits.float() - own.float()).abs().max())
            log(f"  the serve run's logits against the same decode steps' "
                f"on their own routing: max|diff| {gap:.4g} (held equal; "
                f"{float((serve_logits.float() - dec.float()).abs().max()):.4g}"
                " from the replayed run)")
            require(torch.equal(serve_logits, own),
                    f"{arch_id}: the serve run's logits differ from its "
                    f"decode steps' by {gap:.4g}")
    if not dense:
        return readings

    rows = 1 if has_moe else PREFILL_B
    flash, rec = prefill_logits, []
    if flash is None:
        with routing() as (rec, _):
            flash = tf.prefill(params, cfg, tokens[:rows])
    before = flash_attention.launches
    dense_cfg = dataclasses.replace(cfg, blockwise_threshold=PREFILL_S + 1)
    with routing(rec.__getitem__) as (_, st):
        dense_out = tf.prefill(params, dense_cfg, tokens[:rows]).float()
    require(flash_attention.launches == before,
            "the dense path launched the flash kernel")
    held(f"prefill S={PREFILL_S} B={rows}: flash vs dense path",
         flash.float(), dense_out, st, rows)
    del dense_out, flash
    return readings


def phase_profile_decode(torch, device, cfg, params, batch: int = 4,
                         n_warm: int = 4, n_each: int = 8):
    """Where a full-width decode step's time goes: ``n_each`` greedy steps
    timed on the host clock, then ``n_each`` more under
    ``torch.profiler`` for the device kernels per step and their busy
    time, and the host ops that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.lm import transformer as tf

    cache = tf.init_cache(cfg, batch, n_warm + 2 * n_each, device=device)
    state = {"tok": torch.zeros((batch, 1), dtype=torch.long, device=device),
             "pos": 0}

    def step():
        logits, _ = tf.decode_step(params, cfg, state["tok"], cache,
                                   state["pos"])
        state["tok"] = logits.argmax(dim=-1)[:, None]
        state["pos"] += 1

    for _ in range(n_warm):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_each):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_each
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_each):
            step()
        torch.cuda.synchronize()
    by_name = device_time_by_name(prof)
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3 / n_each
    n_kernels = sum(cnt for name, (_, cnt) in by_name.items()
                    if not name.startswith("Mem")) / n_each
    n_copies = sum(cnt for name, (_, cnt) in by_name.items()
                   if name.startswith("Mem")) / n_each
    log(f"profile decode (batch {batch}, {n_each} steps): host wall "
        f"{wall_ms:.3f} ms/step (unprofiled), device busy {busy_ms:.3f} "
        f"ms/step, idle share {1.0 - busy_ms / wall_ms:.4f}, "
        f"{n_kernels:.1f} device kernels and {n_copies:.1f} copies/sets "
        f"per step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, cnt) in top:
        log(f"  device {us / 1e3 / n_each:8.4f} ms/step x{cnt / n_each:6.1f}"
            f"  {name[:80]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        log(f"  host (profiled) {e.self_cpu_time_total / 1e3 / n_each:8.3f} "
            f"ms/step x{e.count / n_each:6.1f}  {e.key[:70]}")
    return wall_ms, busy_ms, n_kernels


def phase_profile_prefill(torch, cfg, params, tokens):
    """Where one full-width prefill's time goes: the flash kernel against
    the matrix products and the rest, on the device, beside the host
    wall of an unprofiled prefill. The profiler here has dropped kernels
    from a trace, so a trace holding fewer flash kernels than the wrapper
    counted launches is taken again, up to 3 times."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import transformer as tf

    tf.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(3):
        before = flash_attention.launches
        by_name = traced(torch, lambda: tf.prefill(params, cfg, tokens))
        launched = flash_attention.launches - before
        require(bool(by_name), "profile prefill: no device time reported")
        groups = {"flash kernel": 0.0, "matrix products": 0.0, "rest": 0.0}
        n_wgmma = n_flash = 0
        for name, (us, cnt) in by_name.items():
            low = name.lower()
            if "flash_fwd" in low:
                groups["flash kernel"] += us / 1e3
                n_flash += cnt
                n_wgmma += cnt if "flash_fwd_wgmma" in low else 0
            elif any(w in low for w in ("gemm", "gemv", "nvjet", "sm90_",
                                        "cutlass", "xmma", "cublas")):
                groups["matrix products"] += us / 1e3
            else:
                groups["rest"] += us / 1e3
        if n_flash >= launched:
            break
        log(f"profiler: {n_flash} of {launched} flash launches in the "
            "prefill trace; taking it again")
    busy = sum(groups.values())
    log(f"profile prefill B={PREFILL_B} S={PREFILL_S}: host wall "
        f"{wall_ms:.3f} ms (unprofiled), device busy {busy:.3f} ms, idle "
        f"share {1.0 - busy / wall_ms:.4f}")
    for name, ms in groups.items():
        log(f"  {name:16s} {ms:9.3f} ms  share {ms / busy:.4f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, cnt) in top:
        log(f"  device {us / 1e3:9.3f} ms x{cnt:4d}  {name[:90]}")
    # every bf16 flash launch runs the tensor-core kernel, once per layer
    require(n_wgmma == cfg.n_layers and n_flash == n_wgmma,
            f"profile prefill: {n_wgmma} flash_fwd_wgmma launches of "
            f"{n_flash} flash launches, not {cfg.n_layers}")


# ------------------------------------------------ the LM training phase
def check_bwd_build(text: str) -> None:
    """The flash backward's ptxas report: the delta pass for float32 and
    bf16 at each D_v (32, 64, 128), and the float32 SIMT dK/dV and dQ
    kernels, the bf16 wgmma ones and the sum of the dK/dV parts at each
    compiled (D, D_v) pair, MLA's (96, 64) and (192, 128) among them (31
    instances; at (192, 128) the wgmma dK/dV and dQ kernels are the
    two-warpgroup ones, ``*_wgmma2_kernel``), logged with their registers
    and spills; no wgmma that ptxas had to serialize, and no spill in a
    bf16 instance."""
    import re

    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

    serialized = [ln.strip() for ln in text.splitlines()
                  if "wgmma.mma_async instructions are serialized" in ln]
    for ln in serialized:
        log(f"  ptxas[flash_attention_bwd] {ln}")
    require(not serialized, "ptxas serialized the flash backward's wgmma")
    found = {}
    for name, info in ptxas_functions(text).items():
        hit = re.search(r"(bwd_(?:prep|dkdv|dq|reduce)(?:_wgmma2?)?_kernel)"
                        r"I(f|13__nv_bfloat16)?Li(\d+)E(?:Li(\d+)E)?", name)
        if hit:
            kern, t, d, dv = hit.groups()
            bf = (t == "13__nv_bfloat16" or "wgmma" in kern
                  or "reduce" in kern)
            dims = f"{d}" if dv is None else f"{d}, {dv}"
            found[(kern, "bf16" if bf else "f32", dims)] = info
    pairs = [f"{d}, {dv}" for d, dv in HEAD_DIMS]
    want = sorted([("bwd_prep_kernel", t, f"{dv}") for t in ("f32", "bf16")
                   for dv in sorted({dv for _, dv in HEAD_DIMS})]
                  + [(k, "f32", p) for k in ("bwd_dkdv_kernel",
                                             "bwd_dq_kernel")
                     for p in pairs]
                  + [(k.replace("wgmma", "wgmma2") if d > 128 else k,
                      "bf16", f"{d}, {dv}")
                     for k in ("bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel",
                               "bwd_reduce_kernel")
                     for d, dv in HEAD_DIMS])
    require(sorted(found) == want,
            f"ptxas report lists flash backward instances {sorted(found)}, "
            f"not {want} (is the build log missing?)")
    for (kern, t, d), info in sorted(found.items()):
        log(f"  ptxas[flash_attention_bwd] {kern}<{t}, {d}>: "
            f"{info.get('registers')} registers, {info.get('spill_stores')} "
            f"bytes spill stores, {info.get('spill_loads')} bytes spill loads")
        if t == "bf16":
            require(info.get("spill_stores") == 0
                    and info.get("spill_loads") == 0,
                    f"{kern}<bf16, {d}> spills")


def bwd_vs_plain(torch, device):
    """The backward kernels against their plain version on the same
    inputs, both given the kernel forward's ``lse``: float32 and bf16 at
    every compiled D, causal and not, a ragged S, Sk > Sq and GQA over
    strided head views; bf16 at the training shape (relaunched
    bit-identical). The forward with ``lse`` gives ``o`` bit-equal to the
    forward without it, and ``lse`` agrees with the plain forward's. Then
    through autograd, where the backward must run on PyTorch's autograd
    thread and give the direct call's gradients. MLA's (96, 64) instance
    runs the same matrix, and bf16 at minicpm3's training shape. Returns
    the largest |kernel - plain| and the training-shape operands of each
    LM arch ({arch: (q, k, v, o, do, lse)})."""
    import threading

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_lse, flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

    gen = torch.Generator().manual_seed(SEED + 7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    def compare(label, got, want, bf16):
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            require(bool(torch.isfinite(a).all()),
                    f"flash bwd {label}: {name} not finite")
            require(bool(a.abs().max() > 0), f"flash bwd {label}: {name} is 0")
            e = float((a.float() - b.float()).abs().max())
            tol = (dict(rtol=TOL_BWD_BF16_RTOL, atol=TOL_BWD_BF16_ATOL_FRAC
                        * float(b.float().abs().max())) if bf16
                   else TOL_BWD_F32)
            require(torch.allclose(a.float(), b.float(), **tol),
                    f"flash bwd {label} {name}: kernel vs plain {e:.3e}")
            errs.append(e)
        log(f"flash bwd {label}: max|kernel-plain| dq {errs[0]:.3e} dk "
            f"{errs[1]:.3e} dv {errs[2]:.3e}")
        return max(errs)

    def forward(label, q, k, v, causal, block_q, block_k):
        """The kernel forward with lse, checked against the forward
        without it (bit-equal o) and the plain forward's lse."""
        o, lse = flash_attention_lse(q, k, v, causal, block_q, block_k)
        require(torch.equal(o, flash_attention(q, k, v, causal, block_q,
                                               block_k)),
                f"flash fwd {label}: o with lse differs from o without")
        _, want = flash_attention_plain(q, k, v, causal, block_q, block_k,
                                        return_lse=True)
        e = float((lse - want).abs().max())
        require(torch.allclose(lse, want, **TOL_LSE),
                f"flash fwd {label}: lse vs plain {e:.3e}")
        return o, lse, e

    err, lse_err = 0.0, 0.0
    cases = []
    for dt in ("f32", "bf16"):
        cases += [(dt, f"d={d} dv={dv} causal={c} s=256 GQA 8/2",
                   (2, 256, 8, d), (2, 256, 2, d), c, dv)
                  for d, dv in HEAD_DIMS for c in (True, False)]
        cases += [(dt, "d=64 causal=True s=256 MHA", (1, 256, 4, 64),
                   (1, 256, 4, 64), True, None),
                  (dt, "d=64 causal=True s=200 (ragged)", (1, 200, 4, 64),
                   (1, 200, 1, 64), True, None),
                  (dt, "d=64 causal=False sq=128 sk=320", (1, 128, 4, 64),
                   (1, 320, 2, 64), False, None),
                  (dt, "d=64 causal=True sq=136 sk=200 (Sk > Sq, ragged)",
                   (1, 136, 4, 64), (1, 200, 2, 64), True, None),
                  (dt, "d=32 causal=True strided heads", (2, 128, 16, 32),
                   (2, 128, 4, 32), True, "strided"),
                  (dt, "d=128 causal=False strided heads s=192",
                   (1, 192, 16, 128), (1, 192, 4, 128), False, "strided"),
                  (dt, "d=96 dv=64 causal=True MHA s=256", (1, 256, 4, 96),
                   (1, 256, 4, 96), True, 64),
                  (dt, "d=96 dv=64 causal=True s=200 (ragged)",
                   (1, 200, 4, 96), (1, 200, 1, 96), True, 64),
                  (dt, "d=96 dv=64 causal=True sq=136 sk=200 (Sk > Sq, "
                   "ragged)", (1, 136, 4, 96), (1, 200, 2, 96), True, 64),
                  (dt, "d=96 dv=64 causal=False strided heads s=192",
                   (1, 192, 16, 96), (1, 192, 4, 96), False, "strided"),
                  (dt, "d=192 dv=128 causal=True MHA s=256",
                   (1, 256, 4, 192), (1, 256, 4, 192), True, 128),
                  (dt, "d=192 dv=128 causal=True s=200 (ragged)",
                   (1, 200, 4, 192), (1, 200, 1, 192), True, 128),
                  (dt, "d=192 dv=128 causal=True sq=136 sk=200 (Sk > Sq, "
                   "ragged)", (1, 136, 4, 192), (1, 200, 2, 192), True, 128),
                  (dt, "d=192 dv=128 causal=False strided heads s=192",
                   (1, 192, 16, 192), (1, 192, 4, 192), False, "strided")]
    for dt, label, qs, ks, causal, how in cases:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        label = f"{dt} {label}"
        if how == "strided":   # views into wider head axes
            qb, kb = randn(*qs, dtype=dtype), randn(*ks, dtype=dtype)
            q, k, v = qb[:, :, 4:12], kb[:, :, :2], kb[:, :, 2:]
            if qs[-1] in MLA_DV:   # v's heads from a tensor of D_v
                v = randn(*ks[:3], MLA_DV[qs[-1]], dtype=dtype)[:, :, 2:]
        else:
            dv = how or ks[-1]
            q, k, v = (randn(*qs, dtype=dtype), randn(*ks, dtype=dtype),
                       randn(*ks[:3], dv, dtype=dtype))
        do = randn(*q.shape[:3], v.shape[-1], dtype=dtype)
        o, lse, e = forward(label, q, k, v, causal, q.shape[1], k.shape[1])
        lse_err = max(lse_err, e)
        got = flash_attention_bwd(q, k, v, o, do, causal, lse)
        want = flash_attention_bwd_plain(q, k, v, o, do, causal, lse=lse)
        err = max(err, compare(label, got, want, dt == "bf16"))

    # the training shape: one microbatch of TinyLlama at S = 4,096, bf16
    bf = torch.bfloat16
    b, s, hq, hkv, d = 1, TRAIN_S, 32, 4, 64
    q, k, v = (randn(b, s, hq, d, dtype=bf), randn(b, s, hkv, d, dtype=bf),
               randn(b, s, hkv, d, dtype=bf))
    do = randn(b, s, hq, d, dtype=bf)
    block_k = min(s, 1024)    # the model's attn_block_k
    o, lse, e = forward("bf16 training shape", q, k, v, True, 128, block_k)
    lse_err = max(lse_err, e)
    got = flash_attention_bwd(q, k, v, o, do, True, lse)
    again = flash_attention_bwd(q, k, v, o, do, True, lse)
    torch.cuda.synchronize()
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            "flash bwd: two launches on the same inputs differ")
    want = flash_attention_bwd_plain(q, k, v, o, do, True, lse=lse)
    err = max(err, compare(f"bf16 training shape q={tuple(q.shape)} "
                           f"kv={tuple(k.shape)} causal, bit-identical "
                           "relaunch", got, want, True))
    del want
    log(f"flash fwd with lse: o bit-equal to the forward without it in "
        f"every case; max|lse - plain| {lse_err:.3e}")

    # through autograd: the Function's backward launches the kernel on the
    # autograd engine's device thread
    before = dict(flash_attention_bwd.launches_by_thread)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, True, 128, block_k)
    require(type(out.grad_fn).__name__ == "FlashAttentionBackward",
            f"flash_attention under grad has grad_fn {out.grad_fn}")
    out.backward(do)
    torch.cuda.synchronize()
    after = flash_attention_bwd.launches_by_thread
    new = {t: n - before.get(t, 0) for t, n in after.items()
           if n != before.get(t, 0)}
    require(sum(new.values()) == 1
            and threading.current_thread().name not in new,
            f"autograd's backward launches by thread {new}: not one, on the "
            "autograd thread")
    require(all(torch.equal(x.grad, y) for x, y in zip(leaves, got)),
            "flash bwd through autograd differs from the direct call")
    log(f"flash bwd through autograd: one launch on thread {sorted(new)}, "
        "gradients equal to the direct call's")
    operands = {"tinyllama-1.1b": (q, k, v, o, do, lse)}
    del leaves, out, got, again

    # qwen3's and minicpm3's training shapes (one microbatch at S =
    # 4,096), bf16: two launches bit-identical, against the plain version
    for arch, (hq, hkv, d, dv) in PREFILL_HEADS.items():
        q, k, v = (randn(1, s, hq, d, dtype=bf), randn(1, s, hkv, d, dtype=bf),
                   randn(1, s, hkv, dv, dtype=bf))
        do = randn(1, s, hq, dv, dtype=bf)
        o, lse, e = forward(f"bf16 {arch} training shape", q, k, v, True,
                            128, block_k)
        lse_err = max(lse_err, e)
        got = flash_attention_bwd(q, k, v, o, do, True, lse)
        again = flash_attention_bwd(q, k, v, o, do, True, lse)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"flash bwd {arch}: two launches on the same inputs differ")
        want = flash_attention_bwd_plain(q, k, v, o, do, True, lse=lse)
        err = max(err, compare(f"bf16 {arch} training shape q="
                               f"{tuple(q.shape)} k={tuple(k.shape)} v="
                               f"{tuple(v.shape)} causal, bit-identical "
                               "relaunch", got, want, True))
        del got, again, want
        operands[arch] = (q, k, v, o, do, lse)
    return err, operands


def train_bound(cfg, tokens: int) -> tuple[float, float]:
    """(operations, bytes) a train_4k step needs at least: 6 N T for the
    matrix products' forward and backward over N matrix parameters and T
    tokens, 2 N T again for remat's recompute (every layer and the loss
    chunks' logits), and attention's products over the causal half (the
    forward's two, recomputed, and the backward's five) a layer and a
    microbatch; bytes: AdamW reading and writing the bf16 parameters and
    the float32 moments once. The matrices are the layer's own (GQA:
    wq, wk, wv, wo; MLA: w_dq, w_uq, w_dkv, the latent's expansions w_uk
    and w_uv, w_kr, wo), and attention's q/k head dim D and v head dim
    D_v (MLA: d_nope + d_rope and d_v) price its products: 2 (D + D_v) a
    (query, key) pair for each forward, 2 (3 D + 2 D_v) for the
    backward."""
    n_all, n_mat, _ = lm_param_counts(cfg)
    if cfg.attn_type == "mla":
        d_qk, d_v = cfg.d_nope + cfg.d_rope, cfg.d_v
    else:
        d_qk = d_v = cfg.d_head
    s = TRAIN_S
    pairs = s * (s + 1) / 2
    attn = 2.0 * cfg.n_heads * pairs * (2 * (d_qk + d_v) + 3 * d_qk
                                        + 2 * d_v)
    n_micro = tokens // s
    n_flops = 8.0 * n_mat * tokens + attn * cfg.n_layers * n_micro
    n_bytes = 2.0 * n_all * (2 + 4 + 4)
    return n_flops, n_bytes


def phase_lm_train(torch, device, smi):
    """LM training at TinyLlama-1.1B's full width through the user's entry
    points: the train_4k cell's step (``launch.train.make_train_step``:
    warmup-cosine AdamW, wd 0.1, clip 1.0, ``grad_accum`` microbatches;
    ``lm_loss`` with remat and chunked cross-entropy), checkpoint and
    resume (``train.checkpoint``), and the launcher in subprocesses.
    Returns the backward kernel's timing row, the largest kernel-vs-plain
    difference of the backward's checks and their training-shape operands
    of each LM arch."""
    import tempfile

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.launch import train as lt
    from repro_torch.models.lm import transformer as tf
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train import checkpoint as ckpt

    bwd_err, operands = bwd_vs_plain(torch, device)

    cfg = get_arch("tinyllama-1.1b").make_config()
    require(cfg.remat and cfg.grad_accum == 2 and cfg.loss_chunk == 1024
            and TRAIN_S >= cfg.blockwise_threshold,
            "tinyllama-1.1b's config is not the train_4k cell's")
    opt = optim.adamw(optim.warmup_cosine_schedule(3e-4, 2000, 100_000),
                      weight_decay=0.1, max_grad_norm=1.0)
    step = lt.make_train_step(cfg, opt, accum=cfg.grad_accum)

    def batch(i):  # step i's tokens and their next tokens as targets
        gen = torch.Generator().manual_seed(SEED + 100 + i)
        seq = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_S + 1),
                            generator=gen).to(device)
        return seq[:, :-1].contiguous(), seq[:, 1:].contiguous()

    def clone(tree):
        params, st = tree
        return (tree_map(torch.clone, params),
                optim.OptState(st.step, tree_map(torch.clone, st.mu),
                               tree_map(torch.clone, st.nu)))

    def equal_trees(a, b):
        fa, fb = ckpt._flatten(a), ckpt._flatten(b)
        return fa.keys() == fb.keys() and all(
            (x == fb[key]) if isinstance(x, int)
            else (x.dtype == fb[key].dtype and torch.equal(x, fb[key]))
            for key, x in fa.items())

    def run(params, state, first, n, saved=None):
        losses, ev_ms, wall = [], [], []
        for i in range(first, first + n):
            tokens, targets = batch(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            params, state, loss = step(params, state, tokens, targets)
            end.record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
            log(f"train step {i + 1}: loss {losses[-1]:.4f}, {ev_ms[-1]:.1f} "
                f"ms (events), host wall {wall[-1]:.1f} ms, "
                f"{TRAIN_BATCH * TRAIN_S / ev_ms[-1] * 1e3:.0f} tokens/s")
            if saved is not None and i + 1 == TRAIN_SAVE_AT:
                # the training's own peak, before the clone kept for the
                # restore check adds a copy of the state
                saved["peak"] = torch.cuda.max_memory_allocated(device)
                saved["state"] = clone((params, state))
                t0 = time.perf_counter()
                ckpt.save_checkpoint(saved["blocking"], i + 1,
                                     (params, state))
                t1 = time.perf_counter()
                ckpt.save_checkpoint(saved["async"], i + 1, (params, state),
                                     blocking=False)
                saved["s"] = (t1 - t0, time.perf_counter() - t1)
        return params, state, losses, ev_ms, wall

    t0 = time.perf_counter()
    params = tf.init(cfg, seed=SEED, device=device)
    state = opt.init(params)
    torch.cuda.synchronize()
    log(f"train: tinyllama-1.1b params ({cfg.dtype}) and AdamW state drawn "
        f"in {time.perf_counter() - t0:.2f} s; the train_4k cell's step at "
        f"S={TRAIN_S}, global batch cut from 256 to {TRAIN_BATCH} "
        f"({cfg.grad_accum} microbatches of {TRAIN_BATCH // cfg.grad_accum}), "
        f"remat, loss_chunk {cfg.loss_chunk}")

    with tempfile.TemporaryDirectory() as tmp:
        saved = {"blocking": f"{tmp}/blocking", "async": f"{tmp}/async"}
        plain_bwd = flash_ops.flash_attention_bwd_plain

        def refuse(*args, **kw):
            raise SmokeError("the plain flash backward ran on the card")

        # the main path's run, counts zeroed just before and read just after
        for w in (flash_attention, flash_attention_bwd, csr_spmm,
                  embedding_bag):
            w.launches = 0
            w.launches_by_thread.clear()
        flash_ops.flash_attention_bwd_plain = refuse
        torch.cuda.reset_peak_memory_stats(device)
        try:
            params, state, losses, ev_ms, wall = run(params, state, 0,
                                                     TRAIN_STEPS, saved)
        finally:
            flash_ops.flash_attention_bwd_plain = plain_bwd
        peak = torch.cuda.max_memory_allocated(device)
        counts = {"flash_attention": flash_attention.launches,
                  "flash_attention_bwd": flash_attention_bwd.launches,
                  "csr_spmm": csr_spmm.launches,
                  "embedding_bag": embedding_bag.launches}
        by_thread = dict(flash_attention_bwd.launches_by_thread)
        ckpt.wait_async()
        per_fwd = cfg.n_layers * cfg.grad_accum * 2   # the pass and remat's
        per_bwd = cfg.n_layers * cfg.grad_accum
        log(f"train launches in {TRAIN_STEPS} steps: {counts} (backward by "
            f"thread {by_thread}); per step flash forward "
            f"{counts['flash_attention'] / TRAIN_STEPS:.1f}, backward "
            f"{counts['flash_attention_bwd'] / TRAIN_STEPS:.1f}")
        require(counts["flash_attention"] == per_fwd * TRAIN_STEPS,
                f"flash forward launches {counts['flash_attention']}, not "
                f"{per_fwd} a step")
        require(counts["flash_attention_bwd"] == per_bwd * TRAIN_STEPS,
                f"flash backward launches {counts['flash_attention_bwd']}, "
                f"not {per_bwd} a step")
        require("MainThread" not in by_thread,
                "the flash backward launched on the main thread")
        require(counts["csr_spmm"] == counts["embedding_bag"] == 0,
                "LM training launched a trainer kernel")
        require(all(math.isfinite(x) for x in losses),
                f"train losses not finite: {losses}")
        ln_v = math.log(cfg.vocab)
        require(abs(losses[0] - ln_v) < 1.5,
                f"first loss {losses[0]:.4f} is not near ln V = {ln_v:.4f}")

        steady = statistics.median(ev_ms[1:])
        steady_wall = statistics.median(wall[1:])
        tokens = TRAIN_BATCH * TRAIN_S
        n_flops, n_bytes = train_bound(cfg, tokens)
        b_ms, b_by = bound_ms(n_bytes, n_flops, "bf16")
        log(f"train step (median of steps 2-{TRAIN_STEPS}): {steady:.1f} ms "
            f"(events), host wall {steady_wall:.1f} ms, "
            f"{tokens / steady * 1e3:.0f} tokens/s; first step {ev_ms[0]:.1f}"
            f" ms; peak memory {saved['peak'] / 2**30:.2f} GiB over steps "
            f"1-{TRAIN_SAVE_AT} ({peak / 2**30:.2f} GiB with the checkpoint "
            f"check's copy of the state; max_memory_allocated); bound "
            f"{b_ms:.1f} ms ({b_by}; "
            f"{n_flops:.4g} operations at the bf16 peak, {n_bytes / 1e9:.1f} "
            f"GB); step / bound {steady / b_ms:.2f}x; {smi}")

        # wq, wk and wv get gradients through the backward kernel
        before = flash_attention_bwd.launches
        tokens_1, targets_1 = batch(0)
        _, grads = lt.value_and_grad(params, cfg, tokens_1[:1],
                                     targets_1[:1])
        require(flash_attention_bwd.launches - before == cfg.n_layers,
                "value_and_grad did not launch the backward once a layer")
        for name in ("wq", "wk", "wv"):
            g = grads["layers"][name].float()
            per_layer = g.abs().flatten(1).amax(dim=1)
            require(bool(torch.isfinite(g).all()) and bool((per_layer > 0).all()),
                    f"{name}: a layer got no gradient through the kernel")
        log("train: wq, wk, wv gradients finite and non-zero in all "
            f"{cfg.n_layers} layers through the backward kernel")
        del grads, g

        # checkpoint and resume: restore into a freshly drawn tree
        del params, state
        torch.cuda.empty_cache()
        fresh = tf.init(cfg, seed=SEED + 1, device=device)
        target = (fresh, opt.init(fresh))
        restored = {}
        for kind in ("blocking", "async"):
            t0 = time.perf_counter()
            tree, at = ckpt.restore_checkpoint(saved[kind], target)
            torch.cuda.synchronize()
            require(at == TRAIN_SAVE_AT and tree[1].step == TRAIN_SAVE_AT,
                    f"{kind} checkpoint restored step {at}")
            require(equal_trees(tree, saved["state"]),
                    f"{kind} checkpoint: a restored leaf differs")
            restored[kind] = time.perf_counter() - t0
            if kind == "blocking":
                del tree
        del target, fresh, saved["state"]
        torch.cuda.empty_cache()
        log(f"checkpoint at step {TRAIN_SAVE_AT}: saved in "
            f"{saved['s'][0]:.2f} s (blocking) / {saved['s'][1]:.2f} s to "
            f"return (async); restored in {restored['blocking']:.2f} / "
            f"{restored['async']:.2f} s, every leaf equal, on "
            f"{tree[0]['embed'].device}")
        params, state = tree
        params, state, resumed, _, _ = run(
            params, state, TRAIN_SAVE_AT, TRAIN_STEPS - TRAIN_SAVE_AT)
        want = losses[TRAIN_SAVE_AT:]
        gap = max(abs(a - b) for a, b in zip(resumed, want))
        log(f"resumed steps {TRAIN_SAVE_AT + 1}-{TRAIN_STEPS}: losses "
            f"{[round(x, 4) for x in resumed]} against "
            f"{[round(x, 4) for x in want]} uninterrupted, max |diff| "
            f"{gap:.3e}{' (bitwise)' if resumed == want else ''}")
        require(all(math.isclose(a, b, rel_tol=TOL_RESUME["rtol"])
                    for a, b in zip(resumed, want)),
                "resumed losses differ from the uninterrupted run's")

    # one profiled step: device busy, idle share, time by kernel group
    profile_train_step(torch, "tinyllama-1.1b",
                       lambda: step(params, state, *batch(TRAIN_STEPS)),
                       steady_wall, per_bwd)
    hold_count(torch, "train tinyllama-1.1b", step,
               (params, state, *batch(TRAIN_STEPS + 1)), step_ms=steady,
               estimate=train_peak_estimate(cfg))
    del params, state
    torch.cuda.empty_cache()

    launcher_checks(torch)
    row = bwd_timing_row(torch, device, operands["tinyllama-1.1b"],
                         counts["flash_attention_bwd"], TRAIN_STEPS, bwd_err)
    return row, bwd_err, operands


def lm_param_counts(cfg) -> tuple[int, float, int]:
    """(every parameter, the matrices' a token runs through, the largest
    leaf's) of ``cfg``'s model, from the port's own layer shapes (MLA's or
    GQA's; the ``first_k_dense`` dense layers and the stacked ones, MoE's
    router, expert stacks and shared experts). A token runs through
    ``top_k`` of the ``n_experts`` experts, so the expert stacks count at
    that share in the matrices."""
    from repro_torch.models.lm import transformer as tf

    def layer(use_moe):  # (parameters, matrices a token runs, largest)
        shapes = {name: sh for name, (sh, _, _)
                  in tf._layer_shapes(cfg, use_moe).items()}
        n_all = sum(math.prod(sh) for sh in shapes.values())
        n_mat = sum(math.prod(sh) * (cfg.top_k / cfg.n_experts
                                     if use_moe and name in EXPERT_STACKS
                                     else 1.0)
                    for name, sh in shapes.items() if len(sh) > 1)
        return n_all, n_mat, max(math.prod(sh) for sh in shapes.values())

    d, v = cfg.d_model, cfg.padded_vocab
    dense, stacked = layer(False), layer(cfg.moe)
    n_dense, n_stack = cfg.first_k_dense, cfg.n_scan_layers
    n_mat = n_dense * dense[1] + n_stack * stacked[1] + d * v  # lm_head
    n_all = (n_dense * dense[0] + n_stack * stacked[0] + 2 * d * v
             + d)                                   # embed, final_norm
    largest = max(d * v, dense[2] if n_dense else 0,
                  n_stack * stacked[2])
    return n_all, n_mat, largest


def train_peak_estimate(cfg) -> float:
    """Bytes the train_4k step holds at its peak (AdamW's update): bf16
    weights, the float32 moments old and new, the float32 gradient sum
    and the updates, 28 bytes a parameter, plus three float32 temporaries
    of the largest stacked leaf and ~3 GB of activations and logits."""
    n_all, _, largest = lm_param_counts(cfg)
    return 28.0 * n_all + 3 * 4.0 * largest + 3e9


def phase_lm_train_arch(torch, device, smi, arch_id: str) -> dict:
    """The train_4k cell's step at a later slice's arch, full width:
    ``make_train_step`` (warmup-cosine AdamW, wd 0.1, clip 1.0,
    ``grad_accum`` microbatches; ``lm_loss`` with remat and chunked
    cross-entropy) at S = 4,096, the global batch cut to ``grad_accum``
    (one sequence a microbatch), ``NEW_TRAIN_STEPS`` steps, the depth cut
    where the card's memory forces it (to the most layers whose estimated
    peak fits in ``MEM_FRAC`` of the card; logged with the estimate
    that forced it and the measured peak). The counts are zeroed
    just before the steps and read just after; at the MoE archs the
    first step's routing is logged (the share of assignments dropped at
    capacity, the heaviest expert's load). Then the attention parameters'
    gradients in every layer (MoE: the router, the experts and the shared
    experts too) and one profiled step. Returns the launch counts."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train as lt
    from repro_torch.models.lm import transformer as tf

    full = get_arch(arch_id).make_config()
    require(full.remat and TRAIN_S >= full.blockwise_threshold,
            f"{arch_id}'s config does not train through remat and flash")
    card = torch.cuda.get_device_properties(device)
    budget = MEM_FRAC * card.total_memory
    depth = fit_depth(full, train_peak_estimate, budget)
    cut = None if depth == full.n_layers else depth
    cfg = full if cut is None else dataclasses.replace(full, n_layers=cut)
    accum = cfg.grad_accum
    n_full, n_all = lm_param_counts(full)[0], lm_param_counts(cfg)[0]
    log(f"train {arch_id}: {n_full / 1e9:.3f}B parameters at full depth "
        f"({full.n_layers} layers), the step's peak estimated at "
        f"{train_peak_estimate(full) / 1e9:.1f} GB against "
        f"{MEM_FRAC} of the card's {card.total_memory / 1e9:.1f} GB; "
        + ("no depth cut" if cut is None else
           f"depth cut to {cut} layers ({n_all / 1e9:.3f}B parameters, "
           f"estimated {train_peak_estimate(cfg) / 1e9:.1f} GB)")
        + f"; full width, S={TRAIN_S}, global batch {accum} ({accum} "
        f"microbatches of 1), remat, loss_chunk {cfg.loss_chunk}")
    opt = optim.adamw(optim.warmup_cosine_schedule(3e-4, 2000, 100_000),
                      weight_decay=0.1, max_grad_norm=1.0)
    step = lt.make_train_step(cfg, opt, accum=accum)

    def batch(i):  # step i's tokens and their next tokens as targets
        gen = torch.Generator().manual_seed(SEED + 200 + i)
        seq = torch.randint(0, cfg.vocab, (accum, TRAIN_S + 1),
                            generator=gen).to(device)
        return seq[:, :-1].contiguous(), seq[:, 1:].contiguous()

    params = tf.init(cfg, seed=SEED, device=device)
    state = opt.init(params)
    plain_bwd = flash_ops.flash_attention_bwd_plain

    def refuse(*args, **kw):
        raise SmokeError("the plain flash backward ran on the card")

    for w in (flash_attention, flash_attention_bwd):
        w.launches = 0
        w.launches_by_thread.clear()
    flash_ops.flash_attention_bwd_plain = refuse
    torch.cuda.reset_peak_memory_stats(device)
    losses, ev_ms, wall = [], [], []
    try:
        for i in range(NEW_TRAIN_STEPS):
            tokens, targets = batch(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            with routing() as (routes, _):
                params, state, loss = step(params, state, tokens, targets)
            end.record()
            torch.cuda.synchronize()
            if i == 0 and cfg.moe and cfg.n_scan_layers:
                # the forward and remat's recompute route each microbatch
                # in every MoE layer alike
                require(len(routes) == 2 * cfg.n_scan_layers * accum,
                        f"{arch_id}: {len(routes)} MoE routings in a step")
                drop, heavy = moe_load(torch, routes, cfg)
                log(f"MoE routing {arch_id} train step 1 ({accum} "
                    f"microbatches of {TRAIN_S} tokens, capacity factor "
                    f"{cfg.capacity_factor}): dropped {drop:.4f} of the "
                    f"assignments, heaviest expert {heavy:.2f}x the mean "
                    "load")
            del routes
            wall.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
            log(f"train {arch_id} step {i + 1}: loss {losses[-1]:.4f}, "
                f"{ev_ms[-1]:.1f} ms (events), host wall {wall[-1]:.1f} ms")
    finally:
        flash_ops.flash_attention_bwd_plain = plain_bwd
    peak = torch.cuda.max_memory_allocated(device)
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention_bwd": flash_attention_bwd.launches}
    by_thread = dict(flash_attention_bwd.launches_by_thread)
    per_fwd, per_bwd = 2 * cfg.n_layers * accum, cfg.n_layers * accum
    log(f"train {arch_id} launches in {NEW_TRAIN_STEPS} steps: {counts} "
        f"(backward by thread {by_thread})")
    require(counts["flash_attention"] == per_fwd * NEW_TRAIN_STEPS,
            f"{arch_id}: flash forward launches {counts['flash_attention']},"
            f" not {per_fwd} a step")
    require(counts["flash_attention_bwd"] == per_bwd * NEW_TRAIN_STEPS,
            f"{arch_id}: flash backward launches "
            f"{counts['flash_attention_bwd']}, not {per_bwd} a step")
    require("MainThread" not in by_thread,
            f"{arch_id}: the flash backward launched on the main thread")
    require(all(math.isfinite(x) for x in losses),
            f"{arch_id}: train losses not finite: {losses}")
    ln_v = math.log(cfg.vocab)
    require(abs(losses[0] - ln_v) < 1.5,
            f"{arch_id}: first loss {losses[0]:.4f} is not near ln V = "
            f"{ln_v:.4f}")
    steady = statistics.median(ev_ms[1:])
    steady_wall = statistics.median(wall[1:])
    n_tokens = accum * TRAIN_S
    n_flops, n_bytes = train_bound(cfg, n_tokens)
    b_ms, b_by = bound_ms(n_bytes, n_flops, "bf16")
    log(f"train {arch_id} step (median of steps 2-{NEW_TRAIN_STEPS}): "
        f"{steady:.1f} ms (events), host wall {steady_wall:.1f} ms, "
        f"{n_tokens / steady * 1e3:.0f} tokens/s; first step "
        f"{ev_ms[0]:.1f} ms; peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated; estimated "
        f"{train_peak_estimate(cfg) / 2**30:.2f} GiB); bound {b_ms:.1f} ms "
        f"({b_by}; {n_flops:.4g} operations at the bf16 peak, "
        f"{n_bytes / 1e9:.1f} GB); step / bound {steady / b_ms:.2f}x; {smi}")

    # every layer's attention parameters get gradients through the kernel
    before = flash_attention_bwd.launches
    tokens_1, targets_1 = batch(0)
    _, grads = lt.value_and_grad(params, cfg, tokens_1[:1], targets_1[:1])
    require(flash_attention_bwd.launches - before == cfg.n_layers,
            f"{arch_id}: value_and_grad did not launch the backward once a "
            "layer")
    names = (("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_kr", "wo")
             if cfg.attn_type == "mla" else ("wq", "wk", "wv", "wo"))
    moe_names = ("router", "w_gate", "w_up", "w_down") + (
        ("ws_gate", "ws_up", "ws_down") if cfg.n_shared else ())
    # every layer's: the dense layers' own leaves, the stack's per layer
    groups = [(grads[f"dense_layer_{i}"], names, False)
              for i in range(cfg.first_k_dense)]
    if cfg.n_scan_layers:
        groups.append((grads["layers"],
                       names + (moe_names if cfg.moe else ()), True))
    for tree, group, stacked in groups:
        for name in group:
            g = tree[name].float()
            per_layer = (g.abs().flatten(1).amax(dim=1) if stacked
                         else g.abs().max()[None])
            require(bool(torch.isfinite(g).all())
                    and bool((per_layer > 0).all()),
                    f"{arch_id} {name}: a layer got no gradient")
    log(f"train {arch_id}: {', '.join(names)} gradients finite and non-zero "
        f"in all {cfg.n_layers} layers through the backward kernel"
        + (f"; {', '.join(moe_names)} in all {cfg.n_scan_layers} MoE layers"
           if cfg.moe and cfg.n_scan_layers else ""))
    del grads, g

    profile_train_step(torch, arch_id,
                       lambda: step(params, state, *batch(NEW_TRAIN_STEPS)),
                       steady_wall, per_bwd)
    hold_count(torch, f"train {arch_id}" + (f" ({cut} layers)" if cut
                                            else ""),
               step, (params, state, *batch(NEW_TRAIN_STEPS + 1)),
               step_ms=steady, estimate=train_peak_estimate(cfg))
    del params, state
    torch.cuda.empty_cache()
    return counts


def profile_train_step(torch, arch_id: str, run_step, steady_wall: float,
                       per_bwd: int) -> None:
    """One profiled train step (``run_step``): the device busy time by
    kernel group (flash forward, flash backward, matrix products, the
    rest) and the idle share against the unprofiled median host wall;
    fails unless every backward of the bf16 step ran the tensor-core
    kernels (``per_bwd`` launches each of dK/dV and dQ). The profiler of a
    process that has launched millions of kernels drops some from a
    trace, so a trace missing any of them is taken again, up to 3
    times."""
    import re

    for _ in range(3):
        by_name = traced(torch, run_step)
        require(bool(by_name), f"profile train {arch_id}: no device time")
        groups = {"flash forward": 0.0, "flash backward": 0.0,
                  "matrix products": 0.0, "rest": 0.0}
        n_bwd_wgmma = {"dkdv": 0, "dq": 0}
        for name, (us, cnt) in by_name.items():
            low = name.lower()
            if "flash_fwd" in low:
                groups["flash forward"] += us / 1e3
            elif re.search(r"bwd_(prep|dkdv|dq|reduce)(_wgmma2?)?_kernel",
                           low):
                groups["flash backward"] += us / 1e3
                hit = re.search(r"bwd_(dkdv|dq)_wgmma2?_kernel", low)
                if hit:
                    n_bwd_wgmma[hit.group(1)] += cnt
            elif any(w in low for w in ("gemm", "gemv", "nvjet", "sm90_",
                                        "cutlass", "xmma", "cublas")):
                groups["matrix products"] += us / 1e3
            else:
                groups["rest"] += us / 1e3
        if n_bwd_wgmma == {"dkdv": per_bwd, "dq": per_bwd}:
            break
        log(f"profiler: {n_bwd_wgmma} wgmma backward launches of "
            f"{per_bwd} each in the {arch_id} step's trace; taking it again")
    busy = sum(groups.values())
    log(f"profile train {arch_id} step: device busy {busy:.1f} ms against a "
        f"host wall of {steady_wall:.1f} ms (unprofiled median), idle share "
        f"{1.0 - busy / steady_wall:.4f}")
    for name, ms in groups.items():
        log(f"  {name:16s} {ms:9.3f} ms  share {ms / busy:.4f}")
    require(n_bwd_wgmma == {"dkdv": per_bwd, "dq": per_bwd},
            f"profile train {arch_id}: wgmma backward launches "
            f"{n_bwd_wgmma}, not {per_bwd} each")


def launcher_checks(torch):
    """``python -m repro_torch.launch.train`` on the card, in
    subprocesses: 20 steps checkpointed every 10, then ``--resume`` for
    10 more; the printed lines are the reference's."""
    import os
    import re
    import tempfile

    num = r"-?\d+\.\d{4}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "tinyllama-1.1b", "--ckpt-dir", tmp]
        runs = [(["--steps", "20", "--ckpt-every", "10"],
                 [rf"step 5: loss {num}", rf"step 10: loss {num} "
                  r"\(checkpointed\)", rf"step 15: loss {num}",
                  rf"step 20: loss {num} \(checkpointed\)",
                  r"20 steps in \d+\.\ds"]),
                (["--resume", "--steps", "10"],
                 [r"resumed from step 20", rf"step 25: loss {num}",
                  rf"step 30: loss {num} \(checkpointed\)",
                  r"10 steps in \d+\.\ds"])]
        for args, want in runs:
            t0 = time.perf_counter()
            out = subprocess.run(base + args, capture_output=True, text=True,
                                 timeout=300, env=env, cwd=ROOT)
            require(out.returncode == 0,
                    f"launcher {args}: exit {out.returncode}: "
                    f"{out.stderr[-2000:]}")
            lines = out.stdout.splitlines()
            require(len(lines) == len(want)
                    and all(re.fullmatch(w, ln) for w, ln in zip(want, lines)),
                    f"launcher {args} printed {lines}")
            losses = [float(x) for x in re.findall(r"loss (\S+)", out.stdout)]
            require(all(math.isfinite(x) for x in losses),
                    f"launcher {args}: losses {losses}")
            log(f"launcher {' '.join(args)} ({time.perf_counter() - t0:.1f} s"
                f" with the process's start): {' | '.join(lines)}")


def bwd_timing_row(torch, device, operands, launches: int, n_steps: int,
                   err: float, name: str = "flash_attention_bwd"):
    """The backward kernels at an LM arch's training shape (one layer's
    call of one microbatch; TinyLlama's for the row
    ``flash_attention_bwd``), their plain version, and the backward of
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    (timed here only, never called by the port) as the library
    yardstick, the kernel and SDPA timed in turns (kernel, SDPA, SDPA,
    kernel), each the median of its two medians; where ``dkdv_split``
    cuts the dK/dV heads in parts, also the kernels with dK/dV in one
    part a KV head."""
    import re

    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops

    timer = Timer(torch, device)
    q, k, v, o, do, lse = operands
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    before = flash_attention_bwd.launches
    turns = {"kernel": [], "sdpa": []}
    for who in ("kernel", "sdpa", "sdpa", "kernel"):
        if who == "kernel":
            turns[who].append(timer.ms(lambda: flash_ops.launch_bwd(
                q, k, v, o, do, lse, dq, dk, dv, True)))
        else:
            turns[who].append(timer.ms(lambda: torch.autograd.grad(
                out, leaves, dot, retain_graph=True)))
    split = flash_ops.dkdv_split(q, k)
    one_part = None
    if split > 1:
        # the same kernels with dK/dV in one part a KV head (dkdv_split's
        # other side), and the device time of each, by the profiler
        chosen = flash_ops.dkdv_split
        for parts in (split, 1):
            flash_ops.dkdv_split = lambda q, k, n=parts: n
            try:
                call = (lambda: flash_ops.launch_bwd(q, k, v, o, do, lse, dq,
                                                     dk, dv, True))
                if parts == 1:
                    one_part = timer.ms(call)
                by_name = traced(torch, lambda: [call() for _ in range(10)])
            finally:
                flash_ops.dkdv_split = chosen
            times = sorted((re.search(r"bwd_\w+<[^>]*>", n).group(0),
                            us / 1e4)
                           for n, (us, _) in by_name.items() if "bwd_" in n)
            log(f"  {name} kernels, dK/dV in {parts} part(s), ms a call: "
                + ", ".join(f"{n} {t:.4f}" for n, t in times))
    flash_attention_bwd.launches = before
    ms, lib = (statistics.median(turns[w]) for w in ("kernel", "sdpa"))
    plain = timer.ms(lambda: flash_ops.flash_attention_bwd_plain(
        q, k, v, o, do, True, lse=lse), repeats=5, warm=1)
    b, s, hq, d = q.shape
    d_v = v.shape[-1]
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (q, k, v, o, do, lse, dq, dk, dv))
    # the gradient's five products (Q.K^T, dV, dP, dQ, dK) over the causal
    # half, the key j <= query i pairs: 2 D operations each for Q.K^T, dQ
    # and dK, 2 D_v for dV and dP
    n_flops = 2.0 * (3 * d + 2 * d_v) * b * hq * (s * (s + 1) / 2)
    b_ms, b_by = bound_ms(n_bytes, n_flops, "bf16")
    part_txt = ("" if one_part is None else
                f", {one_part:.4f} ms in one")
    log(f"time {name} q={tuple(q.shape)} k={tuple(k.shape)} "
        f"v={tuple(v.shape)} bf16 causal: kernel {ms:.4f} ms (turns "
        f"{turns['kernel']}; {n_flops / ms / 1e9:.2f} TFLOP/s of the five "
        f"products; dK/dV in {split} parts a KV head{part_txt}), plain "
        f"{plain:.4f} ms, SDPA backward {lib:.4f} ms (turns "
        f"{turns['sdpa']}), kernel / SDPA {ms / lib:.2f}x, bound "
        f"{b_ms:.4f} ms "
        f"({b_by}; {n_bytes / 1e6:.1f} MB, {n_flops:.4g} operations at the "
        f"bf16 tensor-core peak), kernel / bound {ms / b_ms:.1f}x; "
        f"{launches / n_steps:.0f} launches a step; {smi_line()}")
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/lm/attention.py:40 (XLA autodiff of "
                    "blockwise_attention; no pl.pallas_call)",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "launches_per_step": launches / n_steps,
        "dkdv_parts": split, "instance": f"{d}/{d_v}",
    }
    if one_part is not None:
        row["one_part_ms"] = one_part
    return row


# ------------------------------------------------------------- phase 5
def phase_timing(torch, device, ops, counts, n_steps):
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.segment_mm import ops as spmm_ops

    timer = Timer(torch, device)
    rows = []
    per_step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                "flops": 0.0}
    for label, fmt, x in spmm_cases(ops):
        y = torch.empty((fmt.n_rows, x.shape[1]), device=device)
        ms = timer.ms(lambda: spmm_ops.csr_launch(fmt, x, y))
        plain = timer.ms(lambda: spmm_ops.csr_spmm_plain(
            fmt.rowptr, fmt.col, fmt.val, x))
        csr = torch.sparse_csr_tensor(fmt.rowptr, fmt.col, fmt.val,
                                      (fmt.n_rows, x.shape[0]),
                                      check_invariants=True)
        lib = timer.ms(lambda: torch.sparse.mm(csr, x))
        nnz = fmt.col.numel()
        # the least the function moves: entries (col + val), row pointers,
        # X read once, Y written once
        n_bytes = (nnz * 8 + fmt.rowptr.numel() * 4 + x.numel() * 4
                   + y.numel() * 4)
        n_flops = 2.0 * nnz * x.shape[1]
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        log(f"time csr_spmm {label}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, torch.sparse.mm {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{n_bytes / 1e6:.3f} MB, nnz {nnz}, {n_flops:.4g} operations)")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bytes", n_bytes), ("flops", n_flops)):
            per_step[k] += v
    spmm_bound, spmm_by = bound_ms(per_step["bytes"], per_step["flops"])
    log(f"time csr_spmm per step (3 calls): kernel {per_step['ms']:.4f} ms, "
        f"plain {per_step['plain_ms']:.4f} ms, torch.sparse.mm "
        f"{per_step['library_ms']:.4f} ms, bound {spmm_bound:.4f} ms")
    rows.append({
        "name": "csr_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/csr_spmm.cu",
        "replaces": "src/repro/kernels/segment_mm/kernel.py:78",
        "launches": counts["csr_spmm"],
        "max_abs_err": ops["errs"]["csr_spmm"],
        "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
        "bound_ms": spmm_bound, "bound_by": spmm_by,
        "library_ms": per_step["library_ms"],
    })

    bags = ops["bags"]
    table = bags["table"]
    times = {}
    for label in ("padded", "path"):
        fmt = bags[label]
        out = torch.empty((fmt.n_bags, table.shape[1]), device=device)
        ms = timer.ms(lambda: bag_ops.bag_launch(fmt, table, out))
        plain = timer.ms(lambda: bag_ops.bag_plain(fmt, table))
        lib = timer.ms(lambda: F.embedding_bag(
            fmt.idx, table, fmt.offsets[:-1], mode="sum",
            per_sample_weights=fmt.w, include_last_offset=False))
        n_look, d = fmt.idx.numel(), table.shape[1]
        n_bytes = bag_bytes(torch, fmt, d)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * n_look * d)
        prof = ops["bag_profile"][label]
        times[label] = dict(ms=ms, kernel_ms=prof["kernel"][0],
                            kernel_warm_ms=prof["kernel"][1],
                            plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by)
        log(f"time embedding_bag {label} L={n_look} bags={fmt.n_bags}: "
            f"kernel {ms:.4f} ms (events); plain {plain:.4f} ms; "
            f"F.embedding_bag {lib:.4f} ms (events); bound {b_ms:.4f} ms "
            f"({b_by}; {n_bytes / 1e6:.2f} MB)")
    path = times["path"]
    rows.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:48",
        "launches": counts["embedding_bag"],
        "max_abs_err": ops["errs"]["embedding_bag"],
        **path, "padded_ms": times["padded"]["ms"],
    })
    log(f"launches per step: csr_spmm "
        f"{counts['csr_spmm'] / n_steps:.3f}, embedding_bag "
        f"{counts['embedding_bag'] / n_steps:.3f}")
    return rows


def flash_timing_row(torch, device, operands, launches: int, err: float,
                     name: str = "flash_attention"):
    """The flash kernel at an LM arch's prefill shape (one layer's call;
    TinyLlama's for the row ``flash_attention``), its plain version at the
    kernel's tiles, and ``F.scaled_dot_product_attention`` (timed here
    only, never called by the port) as the library yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops

    timer = Timer(torch, device)
    q, k, v = operands
    o = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device=device)
    ms = timer.ms(lambda: flash_ops.launch(q, k, v, o, True))
    plain = timer.ms(lambda: flash_ops.flash_attention_plain(
        q, k, v, True, flash_ops.TILE_Q, flash_ops.TILE_K), repeats=3,
        warm=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    b, s, hq, d = q.shape
    dv = v.shape[-1]
    n_bytes = (q.numel() + k.numel() + v.numel() + o.numel()) * q.element_size()
    # both products over the causal half: the key j <= query i pairs, 2 D
    # operations for q . k and 2 D_v for p . v
    n_flops = 2.0 * (d + dv) * b * hq * (s * (s + 1) / 2)
    b_ms, b_by = bound_ms(n_bytes, n_flops, "bf16")
    log(f"time {name} q={tuple(q.shape)} k={tuple(k.shape)} "
        f"v={tuple(v.shape)} bf16 causal: kernel {ms:.4f} ms "
        f"({n_flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
        f"F.scaled_dot_product_attention {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {n_bytes / 1e6:.1f} MB, {n_flops:.4g} operations at the "
        f"bf16 tensor-core peak), kernel / bound {ms / b_ms:.2f}x; "
        f"{launches} launches; {smi_line()}")
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "instance": f"{d}/{dv}",
    }


# ----------------------------------------------------------------- main
# ------------------------------------------------ the GNN zoo and FM cells
# (arch, shape) cells run at make_config(): the first eight always, the
# next four where gnn_peak_estimate fits MEM_FRAC of the card and their
# CPU check CPU_CHECK_MAX_S, ogb_products only estimated
GNN_CELLS = (("pna", "full_graph_sm"), ("pna", "minibatch_lg"),
             ("gatedgcn", "full_graph_sm"), ("gatedgcn", "minibatch_lg"),
             ("nequip", "molecule"), ("nequip", "full_graph_sm"),
             ("mace", "molecule"), ("mace", "full_graph_sm"))
GNN_IF_FITS = (("pna", "molecule"), ("gatedgcn", "molecule"),
               ("nequip", "minibatch_lg"), ("mace", "minibatch_lg"))
GNN_ESTIMATED = tuple((a, "ogb_products")
                      for a in ("pna", "gatedgcn", "nequip", "mace"))
# cells whose first step is not held against the CPU here (46 s of CPU
# steps on an H100's host in PR 30's proof run): each arch stays held at
# full_graph_sm (PNA in float64 too), which also scales the CPU cost of
# the GNN_IF_FITS crosses; scripts/gnn_cells.py holds any of them
# (``python3 scripts/gnn_cells.py pna:minibatch_lg ...``)
GNN_CPU_UNCHECKED = (("pna", "minibatch_lg"), ("gatedgcn", "minibatch_lg"),
                     ("pna", "molecule"), ("gatedgcn", "molecule"),
                     ("nequip", "molecule"), ("mace", "molecule"))
CELL_STEPS = 5             # AdamW steps on one batch
# card against CPU, float32 on both (TF32 off), sums in another order
# (the card's index_add is atomic): the loss; each gradient leaf's
# relative L2 error, and its max |card - CPU| within a share of its
# largest |CPU| value. PNA's max share is wider: its std aggregator,
# sqrt(max(E[m^2] - E[m]^2, 0) + 1e-5), takes the difference of two sums
# of ~O(10) squares, whose float32 rounding is of the order of the 1e-5,
# so a node whose messages are near equal has a std and a gradient set
# by rounding (on an H100 at PNA's molecule cell: 8.1e-3 of the leaf's
# scale, relative L2 1.8e-3)
TOL_CELL_LOSS = dict(rtol=1e-4, atol=1e-6)
TOL_CELL_GRAD = dict(l2=1e-3, max=1e-3)
TOL_CELL_GRAD_PNA = dict(l2=1e-2, max=3e-2)
# PNA's card step is also held in float64 against the CPU's, where that
# rounding is some 1e-9 of the 1e-5: the same semantics on both devices,
# a leaf's max share (6.9e-8 on an H100 at full_graph_sm, where each
# float32 step lay 1.0e-4 and 2.5e-4 from the CPU's float64 one)
TOL_CELL_F64 = 1e-6
TOL_INVARIANT = dict(rtol=1e-3, atol=1e-3)  # energies, rotated and moved
TOL_CHUNKED = dict(rtol=1e-4, atol=1e-5)    # NequIP, 4 edge chunks
TOL_CHUNKED_GRAD = 1e-4                     # a leaf's share of its scale
TOL_FM = dict(rtol=1e-4, atol=1e-6)         # FM scores, card against CPU
# the float32 values a model's backward keeps, per layer: per edge a
# multiple of the width (PNA's gathers, messages and its max and min
# inputs; GatedGCN's gathers, gates and edge-feature LayerNorm) and per
# node (PNA's 13 d concatenation and aggregators); the irreps models keep
# per edge ~75 mul + 128 (the source features, the radial MLP's 15 mul
# path weights, the 15 paths' products, 51 mul in all) and per node
# ~40 mul, and MACE ~22 mul more a node for each power past the first
# (the products are not kept; fitted to the peaks measured at molecule
# and full_graph_sm on an H100); ~0.1 GB of the allocator's and cuBLAS's
# workspaces besides
GNN_SAVED = {"pna": (5, 30), "gatedgcn": (12, 10)}
GNN_WORKSPACE = 0.1e9
# a cross past the required cells runs here only where its CPU check,
# scaled from the arch's largest run cell by the estimate's activation
# bytes, takes at most this: the CPU side of the card-against-CPU checks
# is most of the two phases' time, which must stay near 90 s so the
# script keeps well inside its 1,200 s (on an H100's 8-core host NequIP's
# minibatch_lg check took 29.9 s and the script 1,074 s with it; MACE's
# is ~100 s). scripts/gnn_cells.py runs the crosses left out
CPU_CHECK_MAX_S = 10.0


def gnn_peak_estimate(arch_id: str, cfg, meta: dict,
                      d_feat: int) -> tuple[float, float]:
    """Bytes a GNN cell's train step holds at its peak, and the
    activations' share of them: the parameters, their gradients, AdamW's
    two moments and the updates (5 float32 copies), the inputs, the
    activations the backward keeps (edges counted at one chunk where the
    model chunks them) and a backward's three edge-sized temporaries,
    and ``GNN_WORKSPACE``."""
    from repro_torch.launch import cell as lc
    from repro_torch.optim.optimizers import tree_leaves

    params, _ = lc._model(arch_id).init(cfg, device="meta")
    n_par = sum(t.numel() for t in tree_leaves(params))
    n, e = meta["n_nodes"], meta["n_edges"]
    e_act = meta.get("edge_chunk") or e
    inputs = 4.0 * n * (d_feat if arch_id in GNN_SAVED else 4) + 17.0 * e
    if arch_id in GNN_SAVED:
        per_e, per_n = GNN_SAVED[arch_id]
        d = cfg.d_hidden
        act = cfg.n_layers * 4.0 * d * (per_e * e_act + per_n * n)
        act += 3 * 4.0 * d * e_act
    else:
        mul = cfg.d_hidden
        per_n = 40 * mul + (22 * mul * (cfg.correlation - 1)
                            if arch_id == "mace" else 0)
        act = cfg.n_layers * 4.0 * (e_act * (75 * mul + 128) + n * per_n)
        act += 3 * 4.0 * e_act * 9 * mul
    return 5 * 4.0 * n_par + inputs + act + GNN_WORKSPACE, act


def leaf_errors(torch, got, want) -> dict:
    """{leaf path: (max |got - want| over the leaf's largest |want|,
    ||got - want|| over ||want||)} across two trees of one structure."""
    out = {}

    def walk(g, w, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        # on ``got``'s device (FM's 337.8M-value table gradient), the sums
        # of squares in float64
        w = w.detach().to(g.device, g.dtype)
        d = g.detach() - w
        norm2 = torch.linalg.vector_norm
        scale = float(w.abs().max())
        norm = float(norm2(w, dtype=torch.float64))
        err = float(d.abs().max())
        err2 = float(norm2(d, dtype=torch.float64))
        out[path] = (err / scale if scale > 0 else err,
                     err2 / norm if norm > 0 else err2)

    walk(got, want, "")
    return out


def worst(errs: dict, i: int) -> tuple[float, str]:
    """The largest of ``leaf_errors``' ``i``-th measure, and its leaf."""
    path = max(errs, key=lambda p: errs[p][i])
    return errs[path][i], path


def kernel_group(name: str) -> str:
    """A device kernel's group for the GNN and FM profiles: matrix
    products; scatter (``index_add``'s ``indexFunc*``, ``scatter_reduce``
    and ``scatter_add``, which ATen runs as
    ``_cuda_scatter_gather_internal_kernel<true, ...>`` or a reducing
    scatter, and indexing's backward ``index_put``); gather
    (``index_select``'s ``indexSelect*``, ``gather``'s
    ``..._internal_kernel<false, ...>``, advanced indexing); or
    elementwise (the rest: arithmetic, reductions, copies)."""
    low = name.lower()
    if any(w in low for w in ("gemm", "gemv", "nvjet", "sm90_", "cutlass",
                              "xmma", "cublas", "bmm")):
        return "products"
    if "scatter_gather" in low:
        return ("gather" if "internal_kernel<false" in low.replace(" ", "")
                else "scatter")
    if any(w in low for w in ("index_add", "indexfunc", "scatter",
                              "indexing_backward", "index_put")):
        return "scatter"
    if any(w in low for w in ("index_elementwise", "indexselect",
                              "index_select", "gather", "index_kernel")):
        return "gather"
    return "elementwise"


def profile_cell(torch, label: str, run, host_ms: float) -> None:
    """One profiled call of ``run``: device busy time by kernel group and
    the idle share against the unprofiled median host wall. A trace that
    holds no kernel is taken again, up to 3 times."""
    for _ in range(3):
        by_name = traced(torch, run)
        if by_name:
            break
        log(f"profiler: no kernel in the {label} trace; taking it again")
    require(bool(by_name), f"profile {label}: no device time")
    groups = {"gather": 0.0, "scatter": 0.0, "products": 0.0,
              "elementwise": 0.0}
    for name, (us, _) in by_name.items():
        groups[kernel_group(name)] += us / 1e3
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"profile {label}: device busy {busy:.3f} ms against a host wall "
        f"of {host_ms:.3f} ms (unprofiled median), idle share "
        f"{max(0.0, 1.0 - busy / host_ms):.4f}; "
        + ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.3f})"
                    for g, ms in groups.items())
        + "; top kernels: "
        + "; ".join(f"[{kernel_group(n)}] {n[:160]} {us / 1e3:.3f} ms "
                    f"x{cnt}" for n, (us, cnt) in top))


def timed_calls(torch, fn, n: int) -> tuple[list, list, list]:
    """``n`` calls of ``fn``: their results, CUDA-event ms and host wall
    ms (each call synchronized)."""
    out, ev, wall = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out.append(fn())
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(start.elapsed_time(end))
    return out, ev, wall


def kernel_counts() -> dict:
    """Every hand-written kernel's launch count."""
    from repro_torch.kernels.cluster_window import cluster_window
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.queue_window import queue_window
    from repro_torch.kernels.segment_mm import csr_spmm
    from repro_torch.kernels.step_gate import step_gate

    return {w.__name__: w.launches
            for w in (csr_spmm, embedding_bag, flash_attention,
                      flash_attention_bwd, queue_window, cluster_window,
                      step_gate)}


# ------------------------------------------------ the counter, held on card
# a cell the card runs takes one more, untimed step under launch.count's
# counter, held against the same step counted on meta tensors
HELD = []        # every hold_count's summary, for the end's log
RECORDS = {}     # (arch, shape) -> launch.dryrun record of a held cell
# seconds hold_count spent: its counted steps on the card and on meta, and
# the steps it timed itself
COUNT_S = {"card": 0.0, "meta": 0.0, "timed_step": 0.0}


def hold_count(torch, label: str, fn, args, *, meta_cell=None,
               step_ms: float | None = None,
               estimate: float | None = None) -> dict:
    """One untimed ``fn(*args)`` on the card under ``launch.count``'s
    counter, and the same step on ``meta``: ``meta_cell``'s step and
    arguments (a ``launch.cell`` cell built on ``meta``, whose dry-run
    record goes to ``RECORDS``), else ``fn`` on ``meta`` tensors of the
    arguments' shapes. Their FLOPs by dtype and bytes must be equal, and
    the card run's kernel charges equal to the launches
    ``_build.count_launch`` counted during it. Logs
    ``max_memory_allocated`` of the counted step beside the counted peaks
    and ``estimate``, and the roofline bound (the card's peaks) beside
    ``step_ms`` (timed here, one uncounted step, if not given). Returns
    the card run's summary with the bound."""
    from repro_torch.launch import count, dryrun, roofline

    device = torch.device("cuda", torch.cuda.current_device())
    if step_ms is None:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end)
        del out
        COUNT_S["timed_step"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    held_before = torch.cuda.memory_allocated(device)
    before = kernel_counts()
    on_card = count.Counter()
    card, out = count.count_call(fn, *args, counter=on_card)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    launched = {k: v - before[k] for k, v in kernel_counts().items()
                if v != before[k]}
    del out
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta_fn, meta_args = ((meta_cell["step_fn"], meta_cell["args"])
                          if meta_cell else (fn, count.to_meta(args)))
    # meta's launches are sized by this card's SMs, as the card's are
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    on_meta = count.Counter(sms=sms)
    meta, meta_out = count.count_call(meta_fn, *meta_args, counter=on_meta)
    first_use = on_card.differences(on_meta)
    if first_use:
        # a model that keeps constants on each device (irreps' CG
        # tensors) copies them there on its first step: the card's came
        # with the cell's earlier steps, meta's with this one; count a
        # second meta step, its constants cached as the card's are
        log(f"count {label}: meta's first step differs in "
            f"{ {op: (c, m) for op, (c, m) in first_use.items()} } "
            "(card [calls, FLOPs, bytes], meta); counting a second meta "
            "step, the device's constants cached")
        on_meta = count.Counter(sms=sms)
        meta, meta_out = count.count_call(meta_fn, *meta_args,
                                          counter=on_meta)
    t_meta = time.perf_counter() - t0
    COUNT_S["card"] += t_card
    COUNT_S["meta"] += t_meta
    if meta_cell:
        RECORDS[meta_cell["cell_id"]] = dryrun.record(
            *meta_cell["cell_id"], meta_cell, meta,
            dryrun.storage_bytes(meta_out), t_meta)
    del meta_out
    peaks = roofline.device_peaks(device)
    terms = roofline.roofline_terms(card["flops_by_dtype"], card["bytes"],
                                    None, peaks)
    bound = terms["bound_s"] * 1e3
    charges = {k: v["calls"] for k, v in card["kernels"].items()}
    est = "" if estimate is None else (
        f", the phase's estimate {estimate / 2**30:.3f} GiB")
    log(f"count {label}: {card['flops']:.6g} FLOPs "
        f"{card['flops_by_dtype']}, {card['bytes']:.6g} bytes, "
        f"{card['n_ops']} ops, kernel charges {charges} (launched "
        f"{launched}); meta {meta['flops']:.6g} FLOPs, {meta['bytes']:.6g} "
        f"bytes, {meta['n_ops']} ops; peak: max_memory_allocated "
        f"{peak / 2**30:.3f} GiB, counted "
        f"{card['peak_live_bytes'] / 2**30:.3f} GiB on the card and "
        f"{meta['peak_live_bytes'] / 2**30:.3f} GiB on meta; above what "
        f"was allocated before the step ({held_before / 2**30:.3f} GiB, "
        f"the arguments {card['tracked_bytes'] / 2**30:.3f} GiB of it): "
        f"allocated {(peak - held_before) / 2**30:.3f} GiB, counted "
        f"{(card['peak_live_bytes'] - card['tracked_bytes']) / 2**30:.3f} "
        f"GiB{est}; "
        f"roofline bound {bound:.4f} ms ({terms['dominant']}: compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms) against the measured step "
        f"{step_ms:.4f} ms: bound / step {bound / step_ms:.3f}; counted "
        f"in {t_card:.1f} s on the card, {t_meta:.1f} s on meta; "
        f"{smi_line()}")
    if bound > step_ms:
        log(f"count {label}: the bound exceeds the measured step: the "
            "count's bytes overstate what the step moves")
    diff = on_card.differences(on_meta)
    if diff:
        for op, (c, m) in list(diff.items())[:20]:
            log(f"count {label}: {op} card [calls, FLOPs, bytes] {c}, "
                f"meta {m}")
    require(card["flops_by_dtype"] == meta["flops_by_dtype"]
            and card["bytes"] == meta["bytes"],
            f"count {label}: the card's count ({card['flops_by_dtype']}, "
            f"{card['bytes']} bytes) differs from meta's "
            f"({meta['flops_by_dtype']}, {meta['bytes']} bytes) in "
            f"{len(diff)} ops")
    require(card["kernels"] == meta["kernels"],
            f"count {label}: kernel charges {card['kernels']} on the card, "
            f"{meta['kernels']} on meta")
    require(charges == launched,
            f"count {label}: kernel charges {charges}, launches {launched}")
    out = {"label": label, **card, "bound_ms": bound, "step_ms": step_ms,
           "max_memory_allocated": peak, "allocated_before": held_before,
           "meta_peak_live_bytes": meta["peak_live_bytes"],
           "estimate": estimate}
    HELD.append(out)
    return out


def card_vs_cpu_step(torch, label, loss_fn, params, inputs,
                     tol: dict = TOL_CELL_GRAD, f64: bool = False):
    """The first loss and gradients on the card and on the CPU from the
    same parameters and inputs, held to ``TOL_CELL_LOSS`` and ``tol``
    (each leaf's relative L2 and max share); with ``f64`` the same step
    in float64 on both devices too, held to ``TOL_CELL_F64``, beside the
    CPU's own float32 error against its float64 step. Returns the
    seconds the CPU's float32 step took."""
    from repro_torch.launch import cell as lc
    from repro_torch.optim.optimizers import tree_map

    def on(dev, dtype=None):
        def move(t):
            t = t.detach().to(dev)
            return t.to(dtype) if dtype and t.is_floating_point() else t
        return move

    loss, grads = lc.value_and_grad(loss_fn, params, *inputs)
    t0 = time.perf_counter()
    cpu = on("cpu")
    cpu_loss, cpu_grads = lc.value_and_grad(
        loss_fn, tree_map(cpu, params), *map(cpu, inputs))
    t_cpu = time.perf_counter() - t0
    errs = leaf_errors(torch, grads, cpu_grads)
    (err, where), (err2, where2) = worst(errs, 0), worst(errs, 1)
    log(f"{label}: loss card {float(loss):.6f} / CPU {float(cpu_loss):.6f}; "
        f"gradients: largest leaf max error {err:.3e} of its scale "
        f"({where}), relative L2 {err2:.3e} ({where2}); CPU step "
        f"{t_cpu:.1f} s")
    require(math.isfinite(float(loss)), f"{label}: loss not finite")
    require(math.isclose(float(loss), float(cpu_loss),
                         rel_tol=TOL_CELL_LOSS["rtol"],
                         abs_tol=TOL_CELL_LOSS["atol"]),
            f"{label}: card loss {float(loss)} against CPU "
            f"{float(cpu_loss)}")
    require(err2 <= tol["l2"],
            f"{label}: gradient {where2} off by {err2:.3e} (relative L2)")
    require(err <= tol["max"],
            f"{label}: gradient {where} off by {err:.3e} of its scale")
    if f64:
        card64 = on(loss.device, torch.float64)
        cpu64 = on("cpu", torch.float64)
        l64, g64 = lc.value_and_grad(loss_fn, tree_map(card64, params),
                                     *map(card64, inputs))
        l64c, g64c = lc.value_and_grad(loss_fn, tree_map(cpu64, params),
                                       *map(cpu64, inputs))
        e64, w64 = worst(leaf_errors(torch, g64, g64c), 0)
        own, w_own = worst(leaf_errors(torch, cpu_grads, g64c), 0)
        card_own, w_card = worst(leaf_errors(torch, grads, g64c), 0)
        log(f"{label} float64: loss card {float(l64):.12f} / CPU "
            f"{float(l64c):.12f}; gradients largest leaf max error "
            f"{e64:.3e} ({w64}); float32 against the CPU's float64: CPU "
            f"{own:.3e} ({w_own}), card {card_own:.3e} ({w_card})")
        require(e64 <= TOL_CELL_F64,
                f"{label}: float64 gradient {w64} off by {e64:.3e}")
    return t_cpu


def train_cell_steps(torch, device, label, cell, base: int) -> dict:
    """``CELL_STEPS`` AdamW steps of ``cell`` on its one batch: the loss
    must come down; the median step (events, steps 2 on), host wall and
    peak memory (less ``base``, the bytes the process held before the
    cell was built) are returned and logged."""
    params, state, *inputs = cell["args"]
    step = cell["step_fn"]
    torch.cuda.reset_peak_memory_stats(device)
    losses, ev, wall = [], [], []
    for _ in range(CELL_STEPS):
        (res,), e_ms, w_ms = timed_calls(
            torch, lambda: step(params, state, *inputs), 1)
        params, state, loss = res
        losses.append(float(loss))
        ev += e_ms
        wall += w_ms
    peak = torch.cuda.max_memory_allocated(device) - base
    require(all(math.isfinite(x) for x in losses),
            f"{label}: losses not finite: {losses}")
    require(losses[-1] < losses[0],
            f"{label}: {CELL_STEPS} AdamW steps did not lower the loss: "
            f"{losses}")
    out = {"ms": statistics.median(ev[1:]), "wall": statistics.median(wall[1:]),
           "first_ms": ev[0], "peak": peak, "losses": losses,
           "params": params, "state": state, "inputs": inputs}
    log(f"{label}: losses {', '.join(f'{x:.5f}' for x in losses)}; step {out['ms']:.3f} ms (events, "
        f"median of steps 2-{CELL_STEPS}), host wall {out['wall']:.3f} ms, "
        f"first step {ev[0]:.1f} ms; peak {peak / 2**30:.3f} GiB")
    return out


def random_rotation(seed: int):
    import numpy as np

    r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))[0]
    if np.linalg.det(r) < 0:
        r[:, 0] *= -1
    return r.astype(np.float32)


def geometric_checks(torch, label, arch_id, cell) -> None:
    """At the molecule cell: the energies invariant under a random
    rotation and a translation of the positions; NequIP's 4-chunk
    aggregation against the unchunked one (energies and gradients)."""
    from repro_torch.launch import cell as lc

    model = lc._model(arch_id)
    cfg = cell["cfg"]
    params, _, species, pos, ei, mask, gid, targets = cell["args"]
    n_graphs = targets.shape[0]

    def energies(p, positions, c=cfg):
        return model.apply(p, c, species, positions, ei, mask, gid, n_graphs)

    with torch.no_grad():
        e0 = energies(params, pos)
        rot = torch.from_numpy(random_rotation(3)).to(pos.device)
        shift = torch.tensor([10.0, -3.0, 2.0], device=pos.device)
        e_rot = energies(params, pos @ rot.T)
        e_move = energies(params, pos + shift)
    d_rot = float((e_rot - e0).abs().max())
    d_move = float((e_move - e0).abs().max())
    scale = float(e0.abs().max())
    log(f"{label}: energies (|E| up to {scale:.4f}) rotated max |diff| "
        f"{d_rot:.3e}, translated {d_move:.3e}")
    for name, e in (("rotation", e_rot), ("translation", e_move)):
        require(bool(torch.allclose(e, e0, **TOL_INVARIANT)),
                f"{label}: energies not invariant under a {name}")
    if arch_id != "nequip":
        return
    chunk = ei.shape[1] // 4
    cfg4 = dataclasses.replace(cfg, edge_chunk=chunk)

    def loss_of(c):
        def fn(p):
            return torch.mean((energies(p, pos, c) - targets) ** 2)
        return fn

    l1, g1 = lc.value_and_grad(loss_of(cfg), params)
    l4, g4 = lc.value_and_grad(loss_of(cfg4), params)
    with torch.no_grad():
        e4 = energies(params, pos, cfg4)
    err, where = worst(leaf_errors(torch, g4, g1), 0)
    log(f"{label}: 4 edge chunks of {chunk}: energies max |diff| "
        f"{float((e4 - e0).abs().max()):.3e}, loss {float(l4):.6f} / "
        f"{float(l1):.6f}, gradients largest leaf error {err:.3e} ({where})")
    require(bool(torch.allclose(e4, e0, **TOL_CHUNKED)),
            f"{label}: chunked energies differ")
    require(err <= TOL_CHUNKED_GRAD,
            f"{label}: chunked gradient {where} off by {err:.3e}")


def tree_cpu(tree):
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t: t.detach().float().cpu(), tree)


def meta_cell_of(arch_id: str, shape: str) -> dict:
    """The (``arch_id``, ``shape``) cell of ``launch.cell`` at full config
    on ``meta``, with its ``cell_id``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import cell as lc

    return {**lc.build_cell(get_arch(arch_id), shape, "meta"),
            "cell_id": (arch_id, shape)}


def gnn_estimate(arch_id: str, shape: str):
    """``gnn_peak_estimate`` of the (``arch_id``, ``shape``) cell at the
    arch's full config, and the cell's sizes. GraphSAGE has no such
    formula: its estimate is the peak ``launch.count`` counts for the
    step on ``meta`` and ``GNN_WORKSPACE``, its activations that peak
    less the arguments."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import cell as lc

    arch = get_arch(arch_id)
    n, e, d_feat, chunk = lc._gnn_graph_arrays(arch, GNN_SHAPES[shape])
    if arch_id not in GNN_SAVED and arch_id not in lc.GEOMETRIC:
        from repro_torch.launch import dryrun

        rec = dryrun.run_cell(arch_id, shape, "meta", save=False)
        mem = rec["memory"]
        return ((mem["peak_live_bytes"] + GNN_WORKSPACE,
                 mem["peak_live_bytes"] - mem["argument_bytes_per_device"]),
                {"n_nodes": n, "n_edges": e, "edge_chunk": chunk})
    cfg = (dataclasses.replace(arch.make_config(), edge_chunk=chunk)
           if arch_id in lc.GEOMETRIC else arch.make_config(d_in=d_feat))
    meta = {"n_nodes": n, "n_edges": e, "edge_chunk": chunk}
    return gnn_peak_estimate(arch_id, cfg, meta, d_feat), meta


def run_gnn_cell(torch, device, smi, arch_id: str, shape: str,
                 cpu_check: bool = True) -> float | None:
    """One GNN cell at full config: with ``cpu_check``, its first loss and
    gradients on the card against the CPU (PNA in float64 too, but at
    ``minibatch_lg``); ``CELL_STEPS`` AdamW steps that must lower the
    loss (median step, peak memory against the estimate), one profiled
    step, and at ``molecule`` the geometric models' invariance and
    NequIP's chunked aggregation. Returns the seconds the CPU's step
    took (None without the check)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import cell as lc

    t0 = time.perf_counter()
    label = f"gnn {arch_id} {shape}"
    base = torch.cuda.memory_allocated(device)
    cell = lc.build_gnn_cell(get_arch(arch_id), shape, device, seed=SEED)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    params, _, *inputs = cell["args"]
    t_cpu = None
    if cpu_check:
        t_cpu = card_vs_cpu_step(
            torch, label, cell["loss_fn"], params, inputs,
            TOL_CELL_GRAD_PNA if arch_id == "pna" else TOL_CELL_GRAD,
            f64=arch_id == "pna" and shape != "minibatch_lg")
    else:
        log(f"{label}: not held against the CPU here "
            "(scripts/gnn_cells.py holds it)")
    res = train_cell_steps(torch, device, label, cell, base)
    (est, _), _ = gnn_estimate(arch_id, shape)
    log(f"{label}: {cell['meta']}; peak {res['peak'] / 2**30:.3f} GiB "
        f"measured against {est / 2**30:.3f} GiB estimated; build "
        f"{t_build:.1f} s; {smi}")
    hold_count(torch, label, cell["step_fn"],
               (res["params"], res["state"], *res["inputs"]),
               meta_cell=meta_cell_of(arch_id, shape),
               step_ms=res["ms"], estimate=est)
    profile_cell(torch, f"{label} step",
                 lambda: cell["step_fn"](res["params"], res["state"],
                                         *res["inputs"]),
                 res["wall"])
    if shape == "molecule" and arch_id in lc.GEOMETRIC:
        geometric_checks(torch, label, arch_id, cell)
    del cell, res
    torch.cuda.empty_cache()
    log(f"{label}: {time.perf_counter() - t0:.1f} s")
    return t_cpu


def phase_gnn_archs(torch, device, smi) -> None:
    """The reference's GNN cells (``launch/cell.py``) at full config,
    ``run_gnn_cell`` each: the ``GNN_CELLS``, then the ``GNN_IF_FITS``
    cells where ``gnn_peak_estimate`` fits ``MEM_FRAC`` of the card and
    their CPU check, scaled from the arch's largest run cell by the
    estimate's activation bytes, ``CPU_CHECK_MAX_S`` (those it leaves out
    run in ``scripts/gnn_cells.py``); ``ogb_products`` estimated only. No
    hand-written kernel is on this path: every launch count stays as it
    was."""
    before = kernel_counts()
    budget = MEM_FRAC * torch.cuda.get_device_properties(device).total_memory
    cpu_cost = {}    # arch -> [(activation bytes, CPU check s)] of run cells
    n_run = 0

    def run(arch_id, shape):
        t_cpu = run_gnn_cell(torch, device, smi, arch_id, shape,
                             (arch_id, shape) not in GNN_CPU_UNCHECKED)
        if t_cpu is not None:
            cpu_cost.setdefault(arch_id, []).append(
                (gnn_estimate(arch_id, shape)[0][1], t_cpu))

    for arch_id, shape in GNN_CELLS:
        run(arch_id, shape)
        n_run += 1
    for arch_id, shape in GNN_IF_FITS + GNN_ESTIMATED:
        (est, act), meta = gnn_estimate(arch_id, shape)
        act_ref, cpu_ref = max(cpu_cost[arch_id])
        cpu_s = cpu_ref * act / act_ref
        fits = est <= budget and shape != "ogb_products"
        go = fits and cpu_s <= CPU_CHECK_MAX_S
        log(f"gnn {arch_id} {shape}: {meta}, peak estimated at "
            f"{est / 2**30:.2f} GiB against {MEM_FRAC} of the card "
            f"({budget / 2**30:.2f} GiB), its CPU check at ~{cpu_s:.0f} s "
            f"against {CPU_CHECK_MAX_S:.0f} s: "
            + ("run" if go else "not run" + (
                " (scripts/gnn_cells.py runs it)" if fits else "")))
        if go:
            run(arch_id, shape)
            n_run += 1
    require(kernel_counts() == before,
            f"the GNN cells launched a hand-written kernel: {before} -> "
            f"{kernel_counts()}")
    log(f"GNN zoo phase: {n_run} cells")


def phase_fm(torch, device, smi) -> None:
    """FM at its full config (33,775,616 rows x 10) through the
    reference's four cells: the train step (card against CPU, then
    ``CELL_STEPS`` AdamW steps that must lower the loss), the two serve
    steps and the retrieval step (scores against the CPU's; retrieval
    also against ``scores`` over (query ‖ candidate) rows), each timed
    (events) and profiled once. No hand-written kernel runs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import FM_SHAPES
    from repro_torch.launch import cell as lc
    from repro_torch.models.recsys import fm

    before = kernel_counts()
    arch = get_arch("fm")
    for shape in FM_SHAPES:
        t0 = time.perf_counter()
        label = f"fm {shape}"
        base = torch.cuda.memory_allocated(device)
        cell = lc.build_fm_cell(arch, shape, device, seed=SEED)
        cfg = cell["cfg"]
        cpu_params = None
        if cell["kind"] == "train_step":
            params, _, *inputs = cell["args"]
            card_vs_cpu_step(torch, label, cell["loss_fn"], params, inputs)
            res = train_cell_steps(torch, device, label, cell, base)
            log(f"{label}: table {cfg.total_rows} x {cfg.embed_dim}; "
                f"{smi}")
            hold_count(torch, label, cell["step_fn"],
                       (res["params"], res["state"], *res["inputs"]),
                       meta_cell=meta_cell_of("fm", shape), step_ms=res["ms"])
            profile_cell(torch, f"{label} step",
                         lambda: cell["step_fn"](res["params"],
                                                 res["state"],
                                                 *res["inputs"]),
                         res["wall"])
            del res
        else:
            params, *inputs = cell["args"]
            cpu_params = tree_cpu(params)
            with torch.no_grad():
                outs, ev, wall = timed_calls(
                    torch, lambda: cell["step_fn"](params, *inputs), 10)
                cpu = cell["step_fn"](cpu_params, *(t.cpu() for t in inputs))
            got = outs[-1].cpu()
            err = float((got - cpu).abs().max())
            log(f"{label}: {tuple(got.shape)} scores, max |card - CPU| "
                f"{err:.3e}; {statistics.median(ev[1:]):.4f} ms (events, "
                f"median of 9), host wall {statistics.median(wall[1:]):.4f} "
                f"ms; {smi}")
            require(bool(torch.isfinite(got).all()), f"{label}: not finite")
            require(bool(torch.allclose(got, cpu, **TOL_FM)),
                    f"{label}: card scores differ from the CPU's")
            if shape == "retrieval_cand":
                query, rows = inputs
                offs = torch.from_numpy(fm.offsets(cfg)).to(device)
                n = 4096
                ids = torch.cat([query[None].expand(n, -1),
                                 (rows[:n] - offs[-1])[:, None]], 1)
                with torch.no_grad():
                    direct = fm.scores(params, cfg, ids, offs)
                d = float((direct - outs[-1][:n]).abs().max())
                log(f"{label}: retrieval_scores against scores over "
                    f"(query ‖ candidate) rows, {n} candidates: max |diff| "
                    f"{d:.3e}")
                require(bool(torch.allclose(direct, outs[-1][:n], **TOL_FM)),
                        f"{label}: retrieval_scores differ from scores")
            with torch.no_grad():
                profile_cell(torch, f"{label} call",
                             lambda: cell["step_fn"](params, *inputs),
                             statistics.median(wall[1:]))
                hold_count(torch, label, cell["step_fn"], (params, *inputs),
                           meta_cell=meta_cell_of("fm", shape),
                           step_ms=statistics.median(ev[1:]))
        del cell, params, inputs, cpu_params
        torch.cuda.empty_cache()
        log(f"{label}: {time.perf_counter() - t0:.1f} s")
    require(kernel_counts() == before,
            f"the FM cells launched a hand-written kernel: {before} -> "
            f"{kernel_counts()}")


# ------------------------------------------------------ the dry-run phase
SAGE_SHAPES = ("molecule", "full_graph_sm", "minibatch_lg", "ogb_products")


def dryrun_cells() -> list:
    """The cells counted on meta at full config here: every GNN and FM
    cell the card runs (here or in ``scripts/gnn_cells.py``) and the sage
    cells. The LM steps the card runs are counted on meta at the card's
    own configs by ``hold_count``; the LM archs' reference cells at full
    config take minutes on meta (``python -m repro_torch.launch.dryrun
    --all``)."""
    from repro_torch.configs.shapes import FM_SHAPES

    return (list(GNN_CELLS + GNN_IF_FITS)
            + [("greendygnn-sage", s) for s in SAGE_SHAPES]
            + [("fm", s) for s in FM_SHAPES])


def phase_dryrun(torch, device, smi) -> dict:
    """``repro_torch.launch.dryrun``'s record of each of ``dryrun_cells``
    at full config on ``meta``: FLOPs by dtype, bytes, the live-bytes
    peak, the roofline terms at the card's peaks, the per-device argument
    bytes under both production rule sets. Then ``greendygnn-sage`` on
    the card (``run_gnn_cell``: card against CPU, AdamW steps, the counter
    held) at each of ``SAGE_SHAPES`` whose counted peak fits ``MEM_FRAC``
    of the card and whose CPU check, scaled from the largest sage cell
    run by the step's counted bytes, fits ``CPU_CHECK_MAX_S``
    (``scripts/gnn_cells.py`` runs the rest). No hand-written kernel is on
    these paths. Returns the meta records by (arch, shape), which
    ``phase_sweeps`` reports."""
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    before = kernel_counts()
    records = {}
    for arch_id, shape in dryrun_cells():
        rec = RECORDS.get((arch_id, shape)) or dryrun.run_cell(
            arch_id, shape, "meta", save=False)
        r, mem = rec["roofline"], rec["memory"]
        calls = {k: v["calls"] for k, v in rec["counted"]["kernels"].items()}
        sh = rec["sharded"]
        records[(arch_id, shape)] = rec
        log(f"dryrun {arch_id} {shape} (meta, full config): "
            f"{r['flops_per_device']:.6g} FLOPs {r['flops_by_dtype']}, "
            f"{r['bytes_per_device']:.6g} bytes, {rec['counted']['n_ops']} "
            f"ops, kernels "
            f"{calls}; peak {mem['peak_live_bytes'] / 2**30:.3f} GiB "
            f"(arguments "
            f"{mem['argument_bytes_per_device'] / 2**30:.3f}); bound "
            f"{r['bound_s'] * 1e3:.4f} ms ({r['dominant']}, compute share "
            f"{r['roofline_fraction']:.3f}) at the {r['card']} peaks; "
            f"arguments a device: single pod "
            f"{sh['single']['argument_bytes_per_device'] / 2**20:.2f} MiB, "
            f"multi pod {sh['multi']['argument_bytes_per_device'] / 2**20:.2f}"
            f" MiB (divisible {sh['single']['divisible']}/"
            f"{sh['multi']['divisible']})"
            + (f"; model FLOPs {rec['model_flops_global']:.6g}, useful "
               f"share {rec['useful_flops_ratio']}"
               if rec["model_flops_global"] else "")
            + f"; counted in {rec['count_s']:.1f} s")
        require(r["bytes_per_device"] > 0 and math.isfinite(r["bound_s"])
                and mem["peak_live_bytes"] >= mem["argument_bytes_per_device"]
                and sh["multi"]["argument_bytes_per_device"] > 0,
                f"dryrun {arch_id} {shape}: {r}, {mem}")
    log(f"dryrun: {len(records)} cells on meta ("
        f"{sum(c in RECORDS for c in records)} counted by their cells' "
        f"held steps) in {time.perf_counter() - t_phase:.1f} s")
    budget = MEM_FRAC * torch.cuda.get_device_properties(device).total_memory
    ran = []       # (counted bytes, CPU check s) of the sage cells run
    for shape in SAGE_SHAPES:
        (est, _), meta = gnn_estimate("greendygnn-sage", shape)
        moved = records[("greendygnn-sage", shape)]["counted"]["bytes"]
        cpu_s = (max(ran)[1] * moved / max(ran)[0]) if ran else 0.0
        go = est <= budget and cpu_s <= CPU_CHECK_MAX_S
        log(f"gnn greendygnn-sage {shape}: {meta}, counted peak "
            f"{(est - GNN_WORKSPACE) / 2**30:.3f} GiB (+ "
            f"{GNN_WORKSPACE / 1e9:.1f} GB of workspace) against {MEM_FRAC} "
            f"of the card ({budget / 2**30:.2f} GiB), its CPU check at "
            f"~{cpu_s:.1f} s against {CPU_CHECK_MAX_S:.0f} s: "
            + ("run" if go else "not run" + (
                " (scripts/gnn_cells.py runs it)" if est <= budget else "")))
        if go:
            ran.append((moved, run_gnn_cell(torch, device, smi,
                                            "greendygnn-sage", shape)))
    require(len(ran) >= 2, f"only {len(ran)} greendygnn-sage cells ran")
    require(kernel_counts() == before,
            f"the dry-run phase launched a hand-written kernel: {before} -> "
            f"{kernel_counts()}")
    return records


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if sys.argv[1:2] == ["--deploy"]:
        return deploy_main(torch, device, sys.argv[2])
    if sys.argv[1:2] == ["--paper"]:
        from repro_torch.core import dqn

        return child_main("paper", lambda tmp: phase_paper(
            torch, device, smi_line(),
            dqn.load_qnet(str(tmp / "qnet.npz"), device=device)),
            sys.argv[2])
    if sys.argv[1:2] == ["--sweeps"]:
        return child_main("sweeps", lambda tmp: phase_sweeps(
            torch, device, tmp), sys.argv[2])

    t_start = time.perf_counter()
    smi = timed("card_and_build", phase_card_and_build, torch)
    # the phases that read the trainer's kernels from the profiler first:
    # a process that has launched ~3M kernels (the policy training launches
    # tens of millions) got no csr_spmm or embedding_bag kernel into a
    # trace, where a fresh one traced every launch
    timed("profile", phase_profile, torch, device)
    timed("pipeline_profile", phase_pipeline_profile, torch, device)
    ops = timed("main_path_operands", main_path_operands, torch, device)
    ops["errs"] = timed("kernels_vs_plain", phase_kernels_vs_plain, torch,
                        device, ops)
    timed("bag_profile", phase_bag_profile, torch, device, ops)
    wide_err = timed("spmm_widths", phase_spmm_widths, torch, device, ops)
    ops["errs"]["csr_spmm"] = max(ops["errs"]["csr_spmm"], wide_err)
    # the GNN zoo and FM profile their steps too: before the policy
    # training's millions of launches (a late trace held no kernel)
    timed("gnn_archs", phase_gnn_archs, torch, device, smi)
    timed("fm", phase_fm, torch, device, smi)
    records = timed("dryrun", phase_dryrun, torch, device, smi)
    # the LM phases read their flash launches from the profiler too: a
    # prefill trace taken after the policy training held 47 of the 48
    # flash kernels the wrapper counted, in each of three tries
    lm_counts, cfg, params, tokens = timed("serving", phase_serving, torch,
                                           device)
    timed("profile_prefill", phase_profile_prefill, torch, cfg, params,
          tokens)
    timed("profile_decode", phase_profile_decode, torch, device, cfg, params)
    del params
    torch.cuda.empty_cache()
    new_lm = {}   # the later slices' archs: qwen3, MLA's minicpm3, MoE's
    # moonshot and deepseek-v2 (MLA at (192, 128)), one arch's parameters
    # freed before the next arch's are drawn
    for arch in NEW_LM_ARCHS:
        new_lm[arch] = {"prefill": timed(f"serving {arch}", phase_serve_arch,
                                         torch, device, arch)}
    bwd_row, bwd_err, bwd_operands = timed("lm_train", phase_lm_train, torch,
                                           device, smi)
    for arch in NEW_LM_ARCHS:
        new_lm[arch]["train"] = timed(f"lm_train {arch}",
                                      phase_lm_train_arch, torch, device,
                                      smi, arch)
    qnet, policy_pools = timed("policy", phase_policy, torch, device, smi)
    children = [timed("paper_start", paper_process, qnet)]
    try:
        children.append(timed("sweeps_start", sweeps_process, records))
        queue_qnet, queue_info = timed("queue", phase_queue, torch, device,
                                       smi, policy_pools)
        cluster_qnet, cluster_info = timed("cluster_env", phase_cluster_env,
                                           torch, device, smi, policy_pools)
        for child in children:
            timed(f"{child.name}_wait", child.join)
    finally:
        for child in children:
            child.stop()
    timed("deploy", run_deploy_process, torch,
          {"cluster": cluster_qnet, "queue": queue_qnet})
    policy_pools["queue"] = policy_pools["analytic"]
    policy_pools["cluster"] = policy_pools["analytic"]
    flash_err, flash_operands = timed("flash_vs_plain", phase_flash_vs_plain,
                                      torch, device)
    gate_err = timed("step_gate", phase_step_gate, torch, device)
    counts, step_ms, n_steps = timed("main_path", phase_main_path, torch,
                                     device, qnet)
    full_counts = timed("full_graph", phase_full_graph, torch, device)
    timed("congestion", phase_congestion, torch, device, smi,
          {"table": qnet, "queue": queue_qnet})
    timed("budgeted_tier", phase_budgeted_tier, torch, device)
    timed("card_vs_cpu", phase_card_vs_cpu, torch, device)
    timed("card_vs_cpu_fabric", phase_card_vs_cpu_fabric, torch, device)
    pipe_plans, pipe_builder_bags, pipe_rebuilds = timed(
        "pipeline", phase_pipeline, torch, device, smi)
    timed("pipeline_adaptive", phase_pipeline_adaptive, torch, device, qnet)
    timed("pipeline_budgeted", phase_pipeline_budgeted, torch, device)
    timed("cluster", phase_cluster, torch, device, smi, qnet)
    trace = timed("trace", phase_trace, torch, device, smi, qnet)
    t0 = time.perf_counter()
    rows = phase_timing(torch, device, ops, counts, n_steps)
    rows.append(persisted_gather_row(torch, device, pipe_plans,
                                     pipe_builder_bags, pipe_rebuilds))
    rows.append(spmm_wide_timing_row(torch, device, full_counts["csr_spmm"],
                                     wide_err))
    rows.append(flash_timing_row(torch, device,
                                 flash_operands.pop("tinyllama-1.1b"),
                                 lm_counts["flash_attention"], flash_err))
    rows.append(bwd_row)
    for arch in NEW_LM_ARCHS:
        short = arch.split("-")[0]
        rows.append(flash_timing_row(
            torch, device, flash_operands.pop(arch),
            new_lm[arch]["prefill"], flash_err,
            name=f"flash_attention_{short}"))
        train = new_lm[arch]["train"]
        rows.append(bwd_timing_row(
            torch, device, bwd_operands.pop(arch),
            train["flash_attention_bwd"], NEW_TRAIN_STEPS, bwd_err,
            name=f"flash_attention_bwd_{short}"))
    rows.append(queue_window_timing_row(torch, device, queue_info))
    rows.append(cluster_window_timing_row(torch, device, cluster_info))
    rows.append(step_gate_row(torch, device, counts["step_gate"], gate_err))
    PHASE_S["timing"] = time.perf_counter() - t0
    log(f"phase timing: {PHASE_S['timing']:.1f} s")
    timed("policy_profile", phase_policy_profile, torch, device,
          policy_pools)
    log("counter held on the card: " + json.dumps([
        {k: h[k] for k in ("label", "flops", "bytes", "peak_live_bytes",
                           "tracked_bytes", "max_memory_allocated",
                           "allocated_before", "bound_ms", "step_ms")}
        for h in HELD]))
    log(f"counter holds: {len(HELD)} steps, counted in "
        f"{COUNT_S['card']:.1f} s on the card and {COUNT_S['meta']:.1f} s "
        f"on meta, {COUNT_S['timed_step']:.1f} s of steps timed for them")
    log("phases by wall time (s): " + json.dumps(
        {k: round(v, 1) for k, v in sorted(PHASE_S.items(),
                                           key=lambda kv: -kv[1])}))
    log(f"median measured step: {step_ms:.4f} ms; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"trace": trace}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

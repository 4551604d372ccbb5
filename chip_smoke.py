#!/usr/bin/env python3
"""Drive the torch port (neutronstarlite_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 0.1] [--epochs 5] [--seed 0]

Phases (each prints its lines; any failure exits non-zero):

1. device: the card's name, and name + power limit from nvidia-smi;
2. build: both CUDA kernels from neutronstarlite_torch/csrc with nvcc;
3. kernel checks: each kernel, f32 and bf16, forward and backward through
   its autograd.Function, against its plain PyTorch version on the card, on
   a synthetic power-law graph with a hub row (split into pieces by the ELL
   work list) and a bsp dst tile that runs in several pieces, f in
   {41, 128, 602};
4. main path: GCN 602-128-41 (the widths of configs/gcn_reddit_full.cfg,
   PRECISION:bfloat16) on a synthetic power-law graph at --scale of Reddit
   (0.1: V=23,296, E=11,461,589), built through from_arrays and trained by
   the trainer: one epoch on the plain scatter route, --epochs on the bsp
   route (OPTIM_KERNEL:1 PALLAS:1) and on the ELL route (the same with
   NTS_PALLAS_RESIDENT=1), all from the same seeded parameters with
   drop_rate 0. Each kernel route's first forward's logits are held
   against one eval forward of the plain route in f32 (the bf16 plain
   route rounds its products to bf16; its gap is printed beside), and its
   first-epoch loss against the plain route's (a disagreement
   there is printed at once and fails the run after phase 6, so that a
   failing run still prints its numbers); each kernel route's launch count
   is read from that run;
5. the Cora fixture through the CLI entry point (run.main) on the card:
   GCN with OPTIM_KERNEL:1 PALLAS:1, and GAT with OPTIM_KERNEL:1;
6. main-path checks and timing: on the trainers' own tables, for every
   (tables, width) pair one training epoch runs (forward at 602 and 128,
   backward at 128), each kernel against its plain version (bf16), then
   the CUDA-event times of the kernel, the plain version and one
   torch.sparse.mm call on the same inputs, beside the bound; and each
   kernel's launch geometry for each pair (bsp: pieces, the heaviest
   piece's blocks, CTAs, shared bytes per CTA; ELL: work items, the
   heaviest item's slots, split rows and their pieces, scratch bytes,
   warps; both: CTAs per SM from the CUDA occupancy API, registers, spills);
7. GAT 602-128-41 f32 on a unit-weight build of the main path's edges: one
   epoch on the edge chain, --epochs on the ELL attention (OPTIM_KERNEL:1)
   from the same parameters, whose first logits and first-epoch loss are
   held against the chain's, and whose ell_level launches per epoch must
   be at most 8; then each of an epoch's four ELL calls on runtime
   weights (fwd 128, fwd 41, bwd 41, bwd 128) on the trainer's own tables
   against its plain version, timed beside it, one torch.sparse.mm with
   the alpha values and the bound; the grad_alpha kernel at both layers
   against its plain version, timed beside it, one
   torch.sparse.sampled_addmm (the same SDDMM) and its bound, one launch
   per call; the row softmax of an epoch timed; one epoch under
   torch.profiler (device busy time, idle share, time by kernel);
8. GIN and CommNet 602-128-41 f32: one epoch on the scatter route, then 2
   on the ELL route and 2 on the bsp route, each kernel route's
   first-epoch loss held against the scatter route's, 3 more epochs timed
   and one profiled;
9. GGCN 602-128-41 f32 on its edge chain, 2 epochs at 0.2 x --scale; its
   peak device memory;
10. the blocked ELL route and KERNEL:fused_edge (plain PyTorch, no new
   kernel; each route's run must leave both kernels' launch counts at 0):
   (a) GCN 602-128-41 bf16 through OPTIM_KERNEL:1 KERNEL_TILE:4096 on
   phase 4's graph and parameters, --epochs, its first logits held
   against the f32 plain route's and its epoch-0 loss against the plain
   route's; (b) GAT f32 through KERNEL:fused_edge from phase 7's chain
   parameters, --epochs, held against the chain under phase 7's rules,
   with the time of the fused op's forward and of each of its three
   backward passes over one epoch's calls, and one profiled epoch (device
   activity only: the host ops of these epochs' ~25,000 launches take some
   20 s to parse, so their table is left out here and in (c));
   (c) GGCN f32 fused from phase 9's parameters at 0.2 x --scale, held
   against the chain, then 2 epochs at --scale itself (0.1: V=23,296,
   E=11,461,589) with its peak memory, pass times and one profiled epoch; (d) the fused op alone on a
   power-law graph with a hub and 6 tiles, C=1 and C=f, forward and all
   three gradients on the card against the CPU (F32_TOL), and two calls
   on the card bitwise equal;
11. resilience on the card, GCN bf16 602-128-41 with DROP_RATE 0.5 on
   phase 4's graph (each run with the kernels' counts at 0 before it and
   its kernel's launches read after): (a) the ELL route, 6 straight
   epochs against 3 + save + a new trainer restored + 3, losses, params
   and Adam m, v, step bitwise (max |d| 0); (b) the bsp route (f32
   atomics, not repeatable): the restored tensors equal to the saved ones,
   the continued losses within 2 x the spread of two straight runs (+
   BSP_RESUME_RTOL of the loss); (c) supervised_run under
   NTS_FAULT_SPEC=nan_loss@epoch=3 with a checkpoint each epoch: one
   nonfinite_loss fault and one rollback in a recording sink, (a)'s
   straight run bitwise; (d) ckpt_corrupt on the final save: quarantine,
   fallback to step 1, a 3-epoch resume; (e) a Cora GCN 1433-16-7
   checkpoint written on the CPU restored on the card (eval logits within
   1e-3), and the Cora CLI with CHECKPOINT_DIR run to EPOCHS:5, then
   EPOCHS:10, which resumes at 5 and trains 5-9; (f) save, restore and
   verify_step_dir times of one step, the guard check alone, and the ELL
   epoch loop with the guards armed and not;
12. the sampled trainer (GCNSAMPLE, plain PyTorch, no kernel: every run
   must leave both kernels' launch counts at 0), 602-128-41 bf16,
   BATCH_SIZE 512, FANOUT 25-10 (caps [128000, 5120, 512]), DROP_RATE 0, on
   a planted-partition graph at phase 4's V (graph/synthetic.py
   planted_partition_graph: mean degree 50, the data-prep tool's Reddit
   degree, 41 classes, 602-wide class-embedding features, phase 4's split):
   every mode trains 3 epochs, its loss must fall epoch by epoch and its
   final train accuracy (the sync sampler's evaluation pass) must sit
   within SAMPLED_ACC_ATOL of sync's; (a) sync, its batch count, epoch
   times and stage split (sample_wait, step_dispatch, step_device); (b)
   pipelined with 4 sampling threads, its losses and parameters
   against (a)'s bitwise (else against the spread of two sync runs) and its
   sample_wait against (a)'s; (c) device, its first-epoch loss within
   SAMPLED_LOSS_ATOL of (a)'s, epoch times and peak memory; (d) fused, 3
   epochs twice: one CUDA-graph capture and
   n_batches replays per epoch, 0 batch bytes from the host, the rerun
   bitwise, the first-epoch loss as in (c), the per-batch step time (CUDA
   events), one profiled epoch (device busy, idle share, kernels, the top
   kernels, host-to-device copies: 0) and one batch's fused subgraph on the
   card bitwise equal to the CPU's; (e) configs/gcn_sample_pipeline_smoke.cfg
   and configs/gcn_sample_fused_smoke.cfg through the CLI on the card;
13. the obs plane (metrics stream, run_summary, spans, numerics, program
   cost, perf ledger, profiler trace) on phase 4's graph, GCN 602-128-41
   bf16, DROP_RATE 0, the streams in a temporary directory: (a) the ELL
   route, 5 epochs each without a sink, with obs at its defaults
   (NTS_METRICS_DIR, NTS_LEDGER_DIR), with NTS_NUMERICS=1 and with
   NTS_TRACE_STEP=1: the four loss curves bitwise equal, every record
   valid, run_start, 5 epoch records, the span tree run -> epoch ->
   stages, no tensor_stats without numerics and every group's each epoch
   with it, the trace step's forward_backward / optim stages, the step's
   program_cost (flops, memory rise) and one per (tables, width) kernel
   pair with flops and bytes equal to the bound formula below, one ledger
   row, the run_summary's peak memory equal to max_memory_allocated; the
   profiler's count of library kernels (the hand-written ones, which the
   trace at times misses, are held by their launch counters) and the ELL
   launches of one step without a sink, at the defaults (equal) and with
   numerics (more kernels, the same launches); the steady epochs beside phase 4's and the host time of the
   per-epoch obs bookkeeping; (b) nan_loss@epoch=1,layer=1 under
   supervised_run: one nonfinite_provenance record naming layer 1, then
   the fault and the rollback; (c) the fused sampled trainer (phase 12's
   configuration), 3 epochs with and without NTS_NUMERICS=1: losses and
   parameters bitwise equal, one capture, the stats read from the captured
   graph's buffer, 0 host-to-device copies in a profiled epoch, the sample
   counters equal to phase 12's; (d) NTS_PROFILE_DIR over 3 epochs of the
   ELL and the bsp routes: the Chrome traces hold the tracer's
   record_function scopes (epoch, step_dispatch, step_device) and both
   kernels (ell_work_kernel, bsp_ell_kernel), and the bsp run's
   program_cost records hold the bound formula too;
14. online serving (see phase_serving);
15. the distributed trainers on the sim twin (NTS_DIST_SIMULATE=1,
   PARTITIONS 8: NCCL cannot put two ranks on one card): (a) on phase 4's
   graph, every shard's rectangular ELL and bsp tables ([vp, P*vp]), both
   directions, each kernel against its plain version at f 602, 128, 41
   bf16 and 41 f32 (the f32 check adds F32_SUM_TOL of each output's
   absolute sum of terms, as phase 7's), then one training epoch's per-shard calls (fwd 602,
   fwd 128, bwd 128 on 8 shards) timed beside the plain version,
   torch.sparse.mm over each shard's [vp, P*vp] CSR and the bound (x read
   over P*vp rows), with the heaviest shard's launch geometry; (b) GCNDIST
   602-128-41 bf16 through the ELL, bsp, blocked (KERNEL_TILE 4096) and
   ring routes and GCNEAGERDIST on the bsp route, 3 epochs each from the
   seeded parameters, first logits (valid rows) and epoch-0 loss held
   against the single-device ELL route (LOGITS_TOL, LOSS_RTOL; the eager
   one against a single-device eager ELL run), launches in the run and
   per epoch (a kernel route launches its kernel only, blocked and ring
   neither), epoch times, host table build, peak memory; (c) python -m
   neutronstarlite_torch.graph.prep --dataset reddit --out data (timed),
   then configs/gcn_reddit_full.cfg unchanged through run.main: 10 epochs,
   falling loss, test accuracy >= NORTH_STAR_MIN_TEST_ACC, its epoch times,
   host build and peak memory; (d) configs/gcn_reddit_full_dist_bsp.cfg
   through run.main on (c)'s data, the twin at full scale (P=8): falling
   loss, only bsp_ell launched (its _dist_blocked.cfg twin is left out for
   the time limit; (b) runs the blocked route);
16. the pipelined ring, the 2D mesh and the split mirror (plain PyTorch,
   no hand-written kernel: every run must leave both kernels' launch
   counts at 0) on the sim twin at P=8, GCN 602-128-41 bf16 on phase 9's
   graph (0.2 x --scale, for the time limit), drop 0: (a) GCNDIST on
   DIST_PATH:ring_blocked
   (vt = min(vp, 512)), on MESH:4,2 (ring_blocked_sim), on
   COMM_LAYER:mirror and on COMM_LAYER:auto without OPTIM_KERNEL (its
   choice, mb and vp printed), and GCNEAGERDIST on ring_blocked,
   RING_EPOCHS each: first logits (valid rows) and epoch-0 loss against
   single-device ELL runs on that graph (GCN with the ELL kernel, GCNEAGER
   as phase 15's eager reference; LOGITS_TOL, LOSS_RTOL), the live wire,
   ring and mesh gauges and the wire counter equal to ring_wire_plan /
   predict_mesh / (P-1)*mb, epoch times, host table build, peak memory;
   (b) GCNDIST f32 on ring_blocked with WIRE_DTYPE:bf16 beside f32, one
   epoch each: first logits within 0.02 max|f32| and not bitwise equal, the wire bytes
   halved; (c) NTS_OVERLAP_PROBE=1 on (a)'s ring_blocked run: the
   ring.probe_* gauges present (the twin's hop is a slice, so the probe
   measures the schedule's overhead, not wire time); (d)
   configs/gcn_dist_ring_smoke.cfg and gcn_dist_mesh_smoke.cfg unchanged
   through run.main on the card with NTS_DIST_SIMULATE=1: exit 0, finite
   losses;
17. every trainer over the uniform mirror-slot exchange (plain PyTorch, no
   hand-written kernel: each run starts with both kernels' counts at 0
   and must leave them there) on the sim twin at P=8, 602-128-41 f32, drop
   0; each run prints its steady epoch time, host table build, peak memory
   and wire gauges, which must equal the accounting, as must the wire
   counter: (a) TEST_GETDEP on phase 7's unit-weight graph: fwd_err and
   bwd_err 0; (b) GATDIST on the mirror chain from phase 7's chain
   parameters, MIRROR_EPOCHS: first logits (valid rows) and epoch-0 loss
   against phase 7's single-device chain (GAT_LOGITS_TOL, GAT_LOSS_RTOL);
   (c) GATDIST KERNEL:fused_edge on DIST_PATH:ring_blocked_sim,
   FUSED_RING_EPOCHS, on phase 9's graph (0.2 x --scale: at --scale one
   epoch of the twin's fused ring is ~10^6 launches, 18 s), against the
   mirror chain from the same parameters on that graph under phase 10's
   rule for fused against chain, kernel.edge_hbm_bytes_per_epoch 0, and
   one training epoch under torch.profiler (launches per epoch, idle
   share); (f) GATDIST
   PRECISION:bfloat16 against (b) under JAX's bf16 bound (BF16_LOSS_TOL,
   BF16_ACC_DROP) with half the wire bytes; (d) GGCNDIST's chain at 0.2 x
   --scale from phase 9's parameters against phase 9's chain, the fused
   ring at 0.2 x against that chain (phase 10 (c) runs GGCN's fused op at
   --scale);
   (e) the chunked chain's per-rank body (GGCN, C = f = 128) at --scale
   with the default NTS_EDGE_CHUNK against the whole body on the same
   rank, forward and both gradients in f64 (in f32 a hub source's
   gradient row, summed chunk by chunk or at once, rounds apart by more
   than F32_TOL), on ranks CHUNK_RANKS (0 and 7) of the 8, with the chunk
   count and both bodies' f32 peaks; (g) GCNDISTCACHE on phase 9's graph
   (0.2 x --scale, for the time limit): PROC_REP:0 against
   GCNDIST COMM_LAYER:mirror f32 (first logits, epoch-0 loss), PROC_REP:1
   REP_THRESHOLD:auto (its cached fraction, mc, mf and wire bytes) against
   PROC_REP:0 (CACHE_REFRESH:1 is the fresh fetch), and CACHE_REFRESH:3
   with finite losses;
18. the autotuner (tune/) and the exchange benchmark
   (parallel/comm_bench.py), each tuned run's stream schema-valid with one
   tune_decision and a tune_trial per candidate, the pick no slower than
   any trialled candidate, each candidate's prior bytes, trial ms and
   source printed with the trial phase's peak memory: (a) comm_bench's
   ring, ell, mirror and ring_blocked layers on the twin at phase 4's V,
   mean degree 492, f 602, P=8 (wire rows, peak rows and MiB, ms per
   forward+backward step), the ell leg launching ell_level (and never
   bsp_ell) and its per-shard sums held against the plain version; (b)
   GCNDIST bf16 602-128-41 at P=8 on phase 9's graph (0.2 x --scale, for
   the time limit) with DIST_PATH, WIRE_DTYPE and MESH auto
   (1 x 2 x 4 = 8 candidates, 4 trialled) under NTS_TUNE=measure, with each
   trial's program_cost, 3 epochs under the decision, then NTS_TUNE=cached
   (the same decision, no trial), then the decided tuple pinned: first
   logits and losses bitwise; (c) GAT f32 on phase 7's graph with KERNEL
   and ELL_LEVELS auto (the chain, fused binned and fused pow2), one epoch
   under the decision; (d) GATDIST f32 with KERNEL auto (the mirror chain
   against the fused ring) at 0.2 x --scale on phase 9's graph, one
   epoch; (e) GCNSAMPLE bf16 at phase 12's shape with SAMPLE_PIPELINE auto
   (four modes), one epoch; (f) configs/gcn_dist_tune_smoke.cfg (with
   NTS_DIST_SIMULATE=1) and configs/gcn_dist_mesh_smoke.cfg (with
   NTS_MESH=auto) unchanged through run.main, measure then cached: the
   same decision, no trial on the replay. (b) to (f) leave both kernels'
   counts at 0;
19. the rest of the distributed plane on the P=8 twin, phase 4's graph,
   GCNDIST 602-128-41 bf16, drop 0: (a) OPTIM_KERNEL:1 (the per-shard
   rectangular ell_level tables) with NTS_ELASTIC=1,
   NTS_HEARTBEAT_MISS_K=1, rank_loss@partition=3,epoch=2,
   CHECKPOINT_EVERY:1, 6 epochs under supervised_run: the loss detected and
   replanned 8 -> 7, a finite loss, the heartbeat / rank_loss / replan
   (moved_vertices) / recovery(action=replan) records,
   dist.active_partitions 8 -> 7, ell_level launched on every epoch after
   the replan (its counts set to 0 before the run and read after it), and
   each rebuilt shard's kernel output (602 and 128, both directions)
   against its plain version (BF16_TOL); the replan and rebuild seconds,
   the epoch time before and after and the peak memory are printed; (b)
   the replan oracle: an 8-partition trainer replanned to 7 and resumed
   from its step-3 checkpoint against a fresh P=7 run from a copy of it,
   loss curves and final parameters bitwise; (c)
   slow_rank@partition=5,ms=<5x the step>,times=3 with NTS_STRAGGLER=1:
   exactly one straggler record, naming partition 5, and no rank_loss;
   (e) the DEBUGINFO report of GCNDIST on the ELL route and of GATDIST's
   chain (phase 7's unit-weight graph, f32): every bucket >= 0, the
   buckets summing to the step within DEBUG_SUM_RTOL; (f) CKPT_BACKEND:orbax
   (torch.distributed.checkpoint): 3 epochs, then a new trainer resumed to
   6, bitwise the straight 6-epoch curve; (d) NTS_NUMERICS=1 on
   DIST_PATH:ring_blocked_sim WIRE_DTYPE:bf16, on phase 9's graph (0.2 x
   --scale, for the time limit): the loss curve bitwise the
   one with numerics off, tensor_stats for params, grads, activations,
   logits and the wire payload, and with NTS_QUANT_PROBE=1 the
   wire.quant_rel_err gauge within QUANT_ATOL of the host's value on the
   same payload, 2 epochs each. Only (a), (b), (e) and (f) run a kernel
   (ell_level);
20. the live graph and the stream (serve/delta.py, stream/; plain PyTorch,
   no kernel: both kernels' launch counts stay 0 through the phase), on
   phase 14's sampled GCN 602-128-41 bf16, FANOUT 25-10, trained one fused
   epoch on phase 9's graph (0.2 x --scale, for the time limit) into a
   checkpoint and served from it (buckets
   1-4-16-64; see phase_live_graph): (a) engines in the sync, device and
   fused modes over one toolkit, a 256-row vertex margin reserved before
   warm-up, then an edge-only delta (64 inserts, 16 removals of existing
   edges) and a delta appending 8 vertices within the margin, each applied
   through three pipelined servers whose executors hold a flush prepared
   before it: no capture, every captured tensor's address unchanged, the
   held flush answers bitwise what the pre-delta engine answered, and the
   next flush (dirty and clean vertices) bitwise what a fresh engine over
   the post-delta graph answers from the same generator state; plan_delta's
   and the apply's seconds, the dirty sizes and the rows patched; (b) a
   delta appending more vertices than the margin holds: the ladders are
   dropped and captured again once per bucket, and the engines still match
   a fresh one; (c) a 2-writer graph_gen.delta_trace through a DeltaLog
   and a StreamIngestor into a fleet of 2 fused replicas under a
   closed-loop load, at the rate the host sustains (from (a) and (b)),
   beside the same load without deltas: p50, p99, throughput, the deltas
   applied, no error, no capture after warm-up, and no cached row older
   than a delta that dirtied it; (d) one FineTuneWorker.drain_once over the
   stream's dirty region (batches, loss, seconds), the serving engine's
   weights untouched, its checkpoint restored into an engine, and
   exc@point=finetune_round rolled through;
21. cross-host serving (serve/crosshost.py; host code over HTTP and plain
   PyTorch in each child: both kernels' launch counts stay 0 in this
   process): phase 14's checkpoint (GCNSAMPLE 602-128-41 bf16, FANOUT
   25-10, fused, buckets 1-4-16-64) served by replica processes that each
   read phase 4's graph, features, labels and masks from files written
   here (see phase_crosshost): (a) 3 children spawned together: the 2 of
   CrossHostFleet.spawn (XH_REPLICAS: the rollout runs on 2 replicas for
   the time limit) and the 1 of tools/serve_router (a process of its own),
   each child's startup split (import, CUDA init, graph build, model,
   restore, captures) and memory, nvidia-smi's compute apps; (b) SIGKILL of
   one child under serve_bench's open loop at 100 requests/s: exactly 1
   target_loss, 1 recovery action=restart, 0 sheds and 0 errors, the
   restart's seconds and the clients' p50 / p99; meanwhile serve_router,
   once its child serves, is offered a drifted copy (float leaves x 1.5 +
   0.25, valid digests): exit 3, canary_reject, 0 restarts; (c) a rolling
   rollout to a byte-identical copy under the same load: promoted, canary
   disagreement exactly 0.0, 2 drains and restarts, 0 sheds, the merged
   p99 of the kind=fleet ledger rows present in every row once
   established; (d) 2 replay_seed probes per replica bitwise a fresh
   in-process engine built from the promoted checkpoint; (e) serve_bench
   --targets --trace (its main, in this process, beside the fleet's polling
   and supervision) with 8 closed-loop clients: the clients' submit ->
   answer p50 and p99, the replicas' merged p50 and p99, requests/s beside
   phase 14's one-process numbers, the trace's
   complete-chain fraction (>= 0.95), the chains carrying graph_seq 0 and
   model_seq, and the merged Chrome trace valid; (f) under
   net_drop@target=1,times=1 the dropped fetch retried and answered, and
   routed requests all answered; (g) both kernels' counts 0; (h) after
   close() no child process left (reaped, off nvidia-smi's list and its
   memory freed);
22. the measurement and audit tools (neutronstarlite_torch/tools), each
   through its entry point in this process: (a) micro_bench at its own
   shapes (--scale MICRO_SCALE 1.0: V 116,482, E 5,730,794, bf16), each op
   timed alone with both kernels' counts set to 0 before it and read after:
   every op has its ms and no error, bsp_streamed_bf16 launches bsp_ell and
   pallas_ell_resident_bf16 (f 128) and pallas_ell_fchunked_602_bf16 (f
   602) launch ell_level, the other nine ops neither; then each kernel op's
   output against its plain version on the same inputs (BF16_TOL), and each
   op's ms beside its bound and, for the aggregations, one torch.sparse.mm
   on the same graph and width; (b) bench_sample at --scale 0.1
   (TOOLS_SAMPLE_BATCHES timed batches); (c) sample_bench at its default
   scale, TOOLS_SAMPLE_EPOCHS epochs, in the modes sync, pipelined and fused: sync and pipelined give
   the same losses, fused moves no batch bytes; (d) bench_matrix --epochs
   2 --warmup 1 over copies of configs/ in a temporary directory, each
   CHECKPOINT_DIR moved into it (NTS_DIST_SIMULATE=1 for the dist smoke cfgs,
   NTS_TUNE=measure for the tune smoke cfg): every row measured but those
   whose cfg names a data file by an absolute path that is missing here
   (the reference checkout's data), which fail with FileNotFoundError
   naming it; (e) drift_audit over phase 19's streams
   (its verdict; with NTS_QUANT_TOL=1e-4 the bf16 ring's measured wire
   error is drift: exit 3, wire_quant_rel_err); (f) perf_sentinel check and
   list-keys over the ledger rows phases 13 and 21 wrote; (g) dashboard
   renders phase 21's router stream (its hub polls) and ledger to HTML;
23. the native host runtime and the capacity tools: (a) the native library
   (built at the run's start with the host compiler; its seconds); (b) at
   --scale, phase 4's edge list built natively and with NumPy (their
   seconds, graph_digest equal, the native weights bitwise the float32
   formula and within NATIVE_WEIGHT_ULPS of the NumPy build's), the ELL,
   bsp and blocked tables from the native graph both ways (their seconds,
   bitwise equal), ell_level and bsp_ell once each at f PHASE23_F bf16 on
   the native tables against their plain versions (BF16_TOL), and a GCN
   epoch-0 loss on the native graph within 1e-3 of the NumPy graph's; (c)
   phase 22 (b)'s bench_sample, whose batches must have been drawn by the
   native sample_hop (its call count), beside PR 18's NumPy sampler; (d)
   tools/aot_check on phase 4's cfg for both kernel routes, trainers built
   on the CPU: the predicted step peak within PHASE23_PEAK_BAND of the
   route's own peak in phase 4, every launch check passed; and one rank of
   phase 15's GCNDIST (P=DIST_P, ELL) on the bench graph, which must fit;
   (e) tools/aot_bsp_scale --scale 10 with its launch on the card,
   and tools/roofline through tools/tpu_plan's runner (--list, then the
   roofline step, which leaves its .ok marker) against phase 4's epochs.

The bound of one aggregation is the same for both kernels, taken from the
graph: the bytes it must move (E int32 indices and f32 weights, V+1 int32
offsets, x read once and the output written once) over 3.35 TB/s, or its
2*E*f float32 operations over 67 TFLOP/s, whichever is larger. The counts
are neutronstarlite_torch/obs/cost.aggregation_cost, the formula of the
trainers' program_cost records. In the
{"kernels": [...]} line, ms, plain_ms, library_ms and bound_ms are those of
one training epoch's aggregation calls: the sums over the pairs above
(phase 6 for ell_level and bsp_ell, phase 7 for ell_level_gat, the same
kernel on runtime weights, and for gat_grad_alpha, csrc/ell_gat.cu at both
GAT layers, whose bound is its own: 2*E*f f32 operations against g and h
read once, the slot indices and the output's slots; phase 15 (a) for ell_level_dist and
bsp_ell_dist, the kernels on the rectangular per-shard tables, whose
launches are those of phase 15 (b)'s ELL and bsp runs).

Tolerances scale with the reference: atol is a fraction of the reference's
root mean square, so a wrong kernel cannot hide under a fixed atol when the
outputs are small. The f32 runtime-weight checks add a fraction of each
output's absolute sum of terms: a sum of ~400k terms that cancels keeps
its rounding error.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing either.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import glob
import io
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# (atol as a fraction of the reference's RMS, rtol)
F32_TOL = (4e-5, 1e-4)  # summation order differs
BF16_TOL = (2.0 ** -7, 2.0 ** -7)  # one bf16 ulp of rounding either way
LOGITS_TOL = (2.0 ** -4, 2.0 ** -4)  # bf16 GCN logits after two bf16 layers
LOSS_RTOL = 1e-3  # first-epoch loss, bf16 kernel route vs plain route
# f32 sums of many terms in two orders: the kernel sums pieces of up to
# ~4k slots one after another (worst case 4096 * 2^-24 = 2.4e-4 of the
# terms' absolute sum, typically ~60 * 2^-24), the plain version sums a
# row at once; an output that cancels to near zero keeps that error, so
# the GAT runtime-weight checks allow 1e-4 of the absolute sum on top
F32_SUM_TOL = 1e-4
# GAT ELL route vs its edge chain, f32: the chain's softmax denominators
# and weighted sums add up to ~400k terms per hub row (0.1 scale) with
# atomics in a varying order, the kernel in pieces. On an H100 the worst
# first logit sat 3.8e-3 of the logits' rms apart at 0.1 scale (longest
# row 399,835 slots) and 3.0e-2 at full scale (1,858,017): the gap grows
# with the longest row, so the rms term is taken per GAT_ROW slots of it
GAT_LOGITS_TOL = (1e-2, 1e-3)
GAT_ROW = 399_835
GAT_LOSS_RTOL = 1e-5
FAMILY_LOSS_RTOL = 1e-4  # GIN / CommNet kernel routes vs scatter, f32
# bsp resume (phase 11): the bsp kernel adds in f32 atomics in a varying
# order, so a continued run is held to twice the spread of two straight
# runs, plus this fraction of the loss for when those two happen to agree
BSP_RESUME_RTOL = 1e-5


T_START = time.perf_counter()  # the run's start (main resets it); log() prints the
# seconds since. A run still going after WATCHDOG_S ends with every thread's
# stack on stderr, so that a stall shows where it sits (the limit is 1200 s)
WATCHDOG_S = 1140


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T_START:6.1f}s] {msg}", flush=True)


def check_close(name, got, want, tol, abs_sum=None) -> float:
    """Max abs error of got against want; raises where an element is off
    by more than tol[0] * rms(want) + tol[1] * |want|, plus
    F32_SUM_TOL * abs_sum where ``abs_sum`` (the sum of the absolute
    values of each output's terms) is given."""
    import torch

    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    if not want.numel():
        return 0.0
    rms = float(want.pow(2).mean().sqrt())
    err = (got - want).abs()
    limit = tol[0] * rms + tol[1] * want.abs()
    if abs_sum is not None:
        limit = limit + F32_SUM_TOL * abs_sum.detach().float()
    bad = err > limit
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off, max abs err "
            f"{float(err.max()):.3e}, reference rms {rms:.3e}"
        )
    return float(err.max())


def epoch_calls(sizes):
    """(tables, width) of each aggregation one training epoch runs in the
    standard order: every layer's forward at its input width, and the
    backward of every layer but the first (the features need no gradient)."""
    return [("fwd", s) for s in sizes[:-1]] + [("bwd", s) for s in sizes[1:-1]]


def bound_ms(g, f: int, elem_bytes: int):
    """(bytes ms, operations ms) of one aggregation over g at width f: the
    bytes it must move (E int32 indices + f32 weights, V+1 int32 offsets,
    x read once, the output written once) over the memory rate, and its
    2*E*f float32 operations over the f32 rate. Padding is a cost of a
    layout, so it is not counted. The counts are obs/cost.aggregation_cost,
    the formula of the trainers' program_cost records."""
    from neutronstarlite_torch.obs.cost import aggregation_cost

    flops, moved = aggregation_cost(g.e_num, g.v_num, f, elem_bytes)
    return moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3


def bsp_geometry(tables, f: int, dtype) -> dict:
    """The bsp kernel's launch at width f over these tables: its pieces,
    the heaviest piece's blocks, the tiles split into several pieces, the
    CTAs, and the kernel instance's occupancy."""
    import numpy as np

    from neutronstarlite_torch.ops import _build
    from neutronstarlite_torch.ops.bsp_ell import occupancy

    ptr = tables.pieces(f).cpu().numpy()
    tile_ptr = tables.tile_ptr.cpu().numpy()
    sizes = np.diff(ptr)
    per_tile = np.bincount(np.searchsorted(tile_ptr, ptr[:-1], side="right") - 1)
    chunks = -(-f // _build.kernel_cols("bsp_ell"))
    return {
        "pieces": len(sizes), "heaviest_blocks": int(sizes.max(initial=0)),
        "data_blocks": int(tile_ptr[-1]), "tiles": len(tile_ptr) - 1,
        "split_tiles": int((per_tile > 1).sum()), "ctas": chunks * len(sizes),
        **occupancy(dtype, f),
    }


def bsp_geometry_text(g: dict) -> str:
    return (f"{g['pieces']} pieces of its {g['data_blocks']} data blocks in {g['tiles']} "
            f"dst tiles ({g['split_tiles']} split), heaviest piece {g['heaviest_blocks']} "
            f"blocks, {g['ctas']} CTAs, {g['smem_bytes']} shared bytes per CTA, "
            f"{g['ctas_per_sm']} CTAs per SM (CUDA occupancy API; {g['regs']} registers, "
            f"{g['local_bytes']} spill bytes per thread)")


def ell_geometry(tables, f: int, dtype) -> dict:
    """The ELL kernel's launch at width f over these tables: its work items,
    the heaviest item's live slots, the split rows and their pieces, the
    f32 scratch bytes, the warps launched, and the kernel instance's
    occupancy."""
    from neutronstarlite_torch.ops import _build
    from neutronstarlite_torch.ops.ell_kernel import occupancy, work_list

    w = work_list(tables, f)
    items = w.items.cpu().numpy()
    return {
        "items": w.n_items, "heaviest_slots": int((items[:, 3] - items[:, 2]).max(initial=0)),
        "cap": w.cap, "split_rows": w.n_split, "pieces": w.n_pieces,
        "scratch_bytes": w.n_pieces * f * 4,
        "warps": w.n_items * -(-f // _build.kernel_cols("ell_level")),
        **occupancy(dtype, f),
    }


def ell_geometry_text(g: dict) -> str:
    return (f"{g['items']} work items (cap {g['cap']} live slots, heaviest "
            f"{g['heaviest_slots']}), {g['split_rows']} split rows in {g['pieces']} pieces, "
            f"{g['scratch_bytes']} scratch bytes, {g['warps']} warps, {g['ctas_per_sm']} "
            f"CTAs per SM (CUDA occupancy API; {g['regs']} registers, {g['local_bytes']} "
            f"spill bytes per thread)")


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel_checks(dev, seed: int) -> dict:
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
    from neutronstarlite_torch.ops.bsp_ell import BspAggregate, BspEllPair, bsp_tables_aggregate
    from neutronstarlite_torch.ops.ell import EllPair
    from neutronstarlite_torch.ops.ell_kernel import EllAggregate

    v, e = 30000, 600000
    g = build_graph(*synthetic_power_law_graph(v, e, seed=seed + 7), v)
    ell = EllPair.from_host(g, device=dev)
    bsp = BspEllPair.from_host(g, device=dev)
    log(f"check graph V={v} E={g.e_num} max in-degree {int(g.in_degree.max())}, "
        f"top ELL level {tuple(ell.fwd.nbr[-1].shape)}")
    for f in (41, 128, 602):
        for direction in ("fwd", "bwd"):
            geo = ell_geometry(getattr(ell, direction), f, torch.float32)
            if geo["split_rows"] <= 0:
                raise AssertionError(f"the check graph's ELL {direction} work list "
                                     f"splits no row at f={f}")
            log(f"check graph ELL {direction} tables at f={f}: {ell_geometry_text(geo)}")
            geo = bsp_geometry(getattr(bsp, direction), f, torch.float32)
            if geo["split_tiles"] <= 0:
                raise AssertionError(f"the check graph's bsp {direction} tables split "
                                     f"no dst tile at f={f}")
            log(f"check graph bsp {direction} tables at f={f}: {bsp_geometry_text(geo)}")
    rng = np.random.default_rng(seed)
    worst = {}
    cases = {
        "ell_level": (EllAggregate.apply, ell, lambda t, x: t.plain(x)),
        "bsp_ell": (BspAggregate.apply, bsp, bsp_tables_aggregate),
    }
    for f in (41, 128, 602):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x0 = torch.from_numpy(rng.standard_normal((v, f), dtype=np.float32))
            c0 = torch.from_numpy(rng.standard_normal((v, f), dtype=np.float32))
            for name, (fn, pair, plain) in cases.items():
                x = x0.to(dev, dtype).requires_grad_(True)
                c = c0.to(dev, dtype)
                out = fn(x, pair.fwd, pair.bwd)
                out.backward(c)
                torch.cuda.synchronize()
                e_f = check_close(f"{name} fwd f={f} {dtype}", out,
                                  plain(pair.fwd, x.detach()), tol)
                e_b = check_close(f"{name} bwd f={f} {dtype}", x.grad,
                                  plain(pair.bwd, c), tol)
                log(f"check {name:9s} f={f:3d} {str(dtype):14s} max abs err "
                    f"fwd {e_f:.3e} bwd {e_b:.3e}")
                worst[name] = max(worst.get(name, 0.0), e_f, e_b)
    del ell, bsp
    torch.cuda.empty_cache()
    return worst


def phase_main_path(dev, scale: float, epochs: int, seed: int):
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import reddit_scaled, synthetic_power_law_graph
    from neutronstarlite_torch.models.gcn import GCNTrainer
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.utils.config import InputInfo

    v, e = reddit_scaled(scale)
    t0 = time.perf_counter()
    src, dst = synthetic_power_law_graph(v, e, seed=seed)
    g = build_graph(src, dst, v)
    rng = np.random.default_rng(seed)
    datum = GNNDatum(
        feature=rng.standard_normal((v, 602), dtype=np.float32) * 0.1,
        label=rng.integers(0, 41, size=v, dtype=np.int32),
        mask=(np.arange(v) % 3).astype(np.int32),
    )
    log(f"main path graph V={v} E={g.e_num} max in-degree {int(g.in_degree.max())}: "
        f"host generate+CSC/CSR build {time.perf_counter() - t0:.1f} s")

    def trainer(route: str, n_epochs: int, precision: str = "bfloat16"):
        cfg = InputInfo(
            algorithm="GCN", vertices=v, layer_string="602-128-41", epochs=n_epochs,
            drop_rate=0.0, precision=precision, learn_rate=0.01,
            weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
            optim_kernel=route != "plain", pallas_kernel=route != "plain",
        )
        os.environ["NTS_PALLAS_RESIDENT"] = "1" if route == "ell" else "0"
        return GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                      host_graph=g)

    results = {"edges": (src, dst), "datum": datum}
    # the logits reference: one eval forward of the plain route in f32 from
    # the same seeded parameters (the bf16 plain route rounds its products
    # to bf16, the kernels keep them f32); the bf16 plain route's logits
    # are printed beside it as the earlier reference
    ref32 = trainer("plain", 0, "float32")
    results["logits_f32"] = ref_logits = ref32.eval_logits()
    del ref32
    plain = trainer("plain", 1)
    plain_logits = plain.eval_logits()  # drop_rate 0: the first forward's logits
    plain.run()
    results["plain"] = {"losses": list(plain.loss_history)}
    log(f"route plain: epoch-0 loss {plain.loss_history[0]:.6f} "
        f"({plain.epoch_times[0]:.3f} s)")
    del plain
    counters = {"bsp": bsp_aggregate, "ell": ell_level_aggregate}
    # a route that disagrees with the plain route fails the run at its end,
    # after the later phases have run and printed their numbers
    failures = results["failures"] = []

    def defer(msg):
        failures.append(msg)
        log(f"FAILED {msg} (the later phases still run; the script fails at the end)")

    for route in ("bsp", "ell"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # before this route's tables
        tr = trainer(route, epochs)
        first = tr.eval_logits()
        old_gap = float((first - plain_logits).abs().max())
        try:
            logits_err = check_close(f"route {route} first logits", first, ref_logits,
                                     LOGITS_TOL)
        except AssertionError as exc:
            defer(str(exc))
            logits_err = float("nan")
        rms = float(ref_logits.pow(2).mean().sqrt())
        if route == "ell":  # phase 15 holds the distributed routes against it
            results["ell_first_logits"] = first
        del first
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        tr.run()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        for c in counters.values():
            c.launches = 0
        tr.train_step()
        torch.cuda.synchronize()
        per_epoch = counters[route].launches
        losses = tr.loss_history
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"route {route}: non-finite loss {losses}")
        ref = results["plain"]["losses"][0]
        if abs(losses[0] - ref) > LOSS_RTOL * abs(ref):
            defer(f"route {route}: epoch-0 loss {losses[0]} vs plain {ref}")
        if launches[route] <= 0:
            raise AssertionError(f"route {route}: its kernel was never launched")
        other = "ell" if route == "bsp" else "bsp"
        if launches[other]:
            raise AssertionError(f"route {route} launched the {other} kernel")
        results[route] = {
            "trainer": tr, "losses": losses, "launches": launches[route],
            "launches_per_epoch": per_epoch, "epoch_times": list(tr.epoch_times),
            "build_s": tr.build_model_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            # the route's own: its trainer's rise over what was allocated
            # before it was built (phase 23 (d) holds aot_check to it)
            "own_peak_bytes": torch.cuda.max_memory_allocated() - base,
        }
        log(f"route {route}: first logits max abs err {logits_err:.3e} against the "
            f"f32 plain route's (their rms {rms:.3e}; against the bf16 plain route's, "
            f"the earlier reference, {old_gap:.3e}); epoch-0 loss {losses[0]:.6f} vs "
            f"plain {ref:.6f} (rel {abs(losses[0] - ref) / abs(ref):.2e})")
        log(f"route {route}: losses {[round(x, 6) for x in losses]}; "
            f"{launches[route]} launches in {epochs} epochs + eval, "
            f"{per_epoch} per training epoch; epochs (s) "
            f"{[round(t, 4) for t in tr.epoch_times]}, {epochs}-epoch wall "
            f"{sum(tr.epoch_times):.3f} s; host table build "
            f"{results[route]['build_s']:.1f} s; peak device memory "
            f"{results[route]['peak_gib']:.2f} GiB (the route's own "
            f"{results[route]['own_peak_bytes'] / 2 ** 30:.3f} GiB)")
    return g, results


def phase_cora_cli(dev) -> None:
    """The Cora fixture through run.main on the card: GCN on the bsp route
    and GAT on its ELL attention, each with its kernel's count set to 0
    just before and read just after."""
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    fix = os.path.join(REPO, "tests", "fixtures", "cora")
    runs = (
        ("GCNCPU", "PALLAS:1\n", bsp_aggregate, "bsp"),
        ("GATCPU", "", ell_level_aggregate, "ell_level"),
    )
    for algorithm, extra, counter, kernel in runs:
        lines = []

        class Grab(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        grab = Grab()
        logging.getLogger("nts_torch").addHandler(grab)
        counter.launches = 0
        try:
            with tempfile.TemporaryDirectory() as tmp:
                cfg = os.path.join(tmp, "cora.cfg")
                with open(cfg, "w") as fh:
                    fh.write(
                        f"ALGORITHM:{algorithm}\nVERTICES:2708\nLAYERS:1433-16-7\nEPOCHS:5\n"
                        f"EDGE_FILE:{fix}/cora.2708.edge.self\n"
                        f"LABEL_FILE:{fix}/cora.labeltable\nMASK_FILE:{fix}/cora.mask\n"
                        "LEARN_RATE:0.01\nWEIGHT_DECAY:0.0001\nDECAY_EPOCH:-1\n"
                        f"DROP_RATE:0.5\nOPTIM_KERNEL:1\n{extra}"
                    )
                os.environ["NTS_PALLAS_RESIDENT"] = "0"
                rc = run.main([cfg, "--device", dev.type])
        finally:
            logging.getLogger("nts_torch").removeHandler(grab)
        torch.cuda.synchronize()
        launches = counter.launches
        acc = [ln for ln in lines if ln.startswith("Train Acc:")]
        if rc != 0 or not acc or launches <= 0:
            raise AssertionError(f"Cora CLI {algorithm} run: rc {rc}, {len(acc)} Train Acc "
                                 f"lines, {launches} {kernel} launches")
        log(f"Cora CLI {algorithm} on {dev}: rc 0, {acc[-1]}, {launches} {kernel} launches")


def phase_timing(dev, g, results, check_errs: dict, seed: int):
    import numpy as np
    import torch

    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate, bsp_tables_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    v = g.v_num
    calls = epoch_calls(results["bsp"]["trainer"].cfg.layer_sizes())
    rng = np.random.default_rng(seed + 3)
    xs = {f: torch.from_numpy(rng.standard_normal((v, f), dtype=np.float32)).to(
        dev, torch.bfloat16) for f in sorted({f for _, f in calls})}
    csr = {
        "fwd": (g.column_offset, g.row_indices, g.edge_weight_forward),
        "bwd": (g.row_offset, g.column_indices, g.edge_weight_backward),
    }
    library = {}  # (tables, f) -> (ms, output) of one torch.sparse.mm
    for direction in sorted({d for d, _ in calls}):
        ptr, idx, w = csr[direction]
        a = torch.sparse_csr_tensor(
            torch.from_numpy(ptr).to(dev), torch.from_numpy(idx.astype(np.int64)).to(dev),
            torch.from_numpy(w).to(dev, torch.bfloat16), size=(v, v),
        )
        for d, f in calls:
            if d == direction:
                library[(d, f)] = (cuda_ms(lambda: torch.sparse.mm(a, xs[f])),
                                   torch.sparse.mm(a, xs[f]))
        del a
    specs = {
        "ell_level": ("ell", ell_level_aggregate,
                      lambda t, y: t.plain(y),
                      "neutronstarlite_torch/csrc/ell_level.cu",
                      "neutronstarlite_tpu/ops/pallas_kernels.py:91"),
        "bsp_ell": ("bsp", bsp_aggregate, bsp_tables_aggregate,
                    "neutronstarlite_torch/csrc/bsp_ell.cu",
                    "neutronstarlite_tpu/ops/bsp_ell.py:503"),
    }
    rows = []
    for name, (route, wrapper, plain, source, replaces) in specs.items():
        pair = results[route]["trainer"].compute_graph
        err = check_errs[name]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0}
        for direction, f in calls:
            tables, x = getattr(pair, direction), xs[f]
            got = wrapper(tables, x)
            e = check_close(f"{name} main path {direction} f={f}", got,
                            plain(tables, x), BF16_TOL)
            err = max(err, e)
            ms = cuda_ms(lambda: wrapper(tables, x))
            plain_ms = cuda_ms(lambda: plain(tables, x), n=3, warmup=1)
            lib_ms, lib_out = library[(direction, f)]
            lib_dev = float((got.float() - lib_out.float()).abs().max())
            t_bytes, t_ops = bound_ms(g, f, x.element_size())
            for k, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", max(t_bytes, t_ops)), ("bytes_ms", t_bytes),
                           ("ops_ms", t_ops)):
                tot[k] += val
            if name == "bsp_ell":
                log(f"main path bsp_ell {direction} f={f} bf16 launch: "
                    f"{bsp_geometry_text(bsp_geometry(tables, f, x.dtype))}")
            else:
                log(f"main path ell_level {direction} f={f} bf16 launch: "
                    f"{ell_geometry_text(ell_geometry(tables, f, x.dtype))}")
            log(f"main path {name} {direction} tables V={v} E={g.e_num} f={f} bf16 "
                f"({tables.slot_count()} table slots): max abs err {e:.3e} against "
                f"the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.sparse.mm {lib_ms:.4f} ms (max abs deviation from the kernel "
                f"{lib_dev:.3e}: its bf16 sums), bound {max(t_bytes, t_ops):.4f} ms "
                f"(bytes {t_bytes:.4f}, f32 ops {t_ops:.4f})")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": results[route]["launches"], "max_abs_err": err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
        log(f"timing {name}, one epoch's {len(calls)} aggregations {calls}: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, torch.sparse.mm "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (bytes "
            f"{tot['bytes_ms']:.4f}, f32 ops {tot['ops_ms']:.4f}); launches per "
            f"epoch {results[route]['launches_per_epoch']}")
    return rows


def gat_epoch_calls(tr):
    """One GAT ELL epoch's four kernel calls on the trainer's own tables,
    at its current parameters: (tables, f, x, runtime weights). Forward at
    each layer's output width over the CSC tables with that layer's
    alphas, backward over the CSR tables with the same alphas laid out
    there (the gradients are random, of the right shape)."""
    import torch

    from neutronstarlite_torch.models.gat import LEAKY_SLOPE
    from neutronstarlite_torch.ops.ell_gat import gat_ell_alpha, runtime_weighted_aggregate

    gep = tr.compute_graph
    gen = torch.Generator(device=tr.device).manual_seed(tr.seed + 5)
    calls, x, layers = [], tr.feature, []
    with torch.no_grad():
        for i, layer in enumerate(tr.params):
            h = x @ layer["W"]
            f = h.shape[1]
            al, ar = (h @ layer["a"][:f])[:, 0], (h @ layer["a"][f:])[:, 0]
            alphas = gat_ell_alpha(gep, al, ar, LEAKY_SLOPE)
            layers.append((f, h, al, ar, alphas))
            out = runtime_weighted_aggregate(gep, alphas, h)
            x = out if i == len(tr.params) - 1 else torch.relu(out)
    for f, h, _, _, alphas in layers:
        calls.append(("fwd", f, h, alphas))
    for f, h, _, _, alphas in reversed(layers):
        g = torch.randn(h.shape, generator=gen, device=h.device)
        calls.append(("bwd", f, g, gep.transpose_alphas(alphas)))
    return calls, layers


def gat_sparse(g, gep, alphas, direction: str):
    """torch.sparse CSR of the alphas over the graph's edges: A[dst, src]
    (fwd) or its transpose (bwd), the values taken from the forward slots
    of each edge."""
    import numpy as np
    import torch

    from neutronstarlite_torch.ops.ell_gat import _edge_flat_slots

    dev = gep.fwd_row_vertex.device
    flat = torch.cat([a.reshape(-1) for a in alphas])
    if direction == "fwd":
        slots = torch.from_numpy(_edge_flat_slots(
            g.column_offset, g.dst_of_edge.astype(np.int64), gep.pair.fwd)).to(dev)
        ptr, idx = g.column_offset, g.row_indices
    else:
        bwd_slots = torch.from_numpy(_edge_flat_slots(
            g.row_offset, g.src_of_edge.astype(np.int64), gep.pair.bwd)).to(dev)
        slots = gep.bwd_idx_flat[bwd_slots].long()
        ptr, idx = g.row_offset, g.column_indices
    return torch.sparse_csr_tensor(
        torch.from_numpy(ptr).to(dev), torch.from_numpy(idx.astype(np.int64)).to(dev),
        flat[slots], size=(g.v_num, g.v_num),
    )


OWN_KERNELS = ("ell_work_kernel", "ell_split_reduce", "bsp_ell_kernel", "::cast_kernel<",
               "gat_grad_alpha_kernel")


def profile_step(step, top: int = 8, host: bool = True) -> dict:
    """One call of ``step`` (a training epoch) under torch.profiler: the
    host wall time around it (ended by a synchronise), the device's busy
    time (the union of its kernels' intervals) and idle share, the device
    time of the ELL kernel and of the GEMM kernels, the ``top`` kernels by
    device time and, with ``host``, the ``top`` host ops by self CPU time
    (tracing the host ops of a step of some 25,000 launches adds about 20 s
    of parsing). Empty when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        # kernels of its own open the trace, a spin kernel closes them and a
        # pause follows: the trace at times misses the first kernels after
        # it starts (one, then in the whole script up to nine of the step's
        # first ones); what precedes the spin kernel's end is left out below
        for _ in range(32):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device events as kineto recorded them: the function events
    # (prof.events()) keep only those correlated with a host op, and in the
    # whole script they dropped a few library kernels (118 vs 128 traced in
    # a step that launches the same kernels)
    kernels = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    lead_end = max((b for name, _, b in kernels if "spin_kernel" in name), default=None)
    if lead_end is not None:
        kernels = [k for k in kernels if k[1] >= lead_end]
    if not kernels:
        return {}
    spans = sorted((a, b) for _, a, b in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the kernels' intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    total = sum(by_name.values())
    host_ops = sorted(((a.key, a.self_cpu_time_total) for a in prof.key_averages()),
                      key=lambda kv: -kv[1])[:top] if host else []
    h2d = sum(1 for name, _, _ in kernels if "HtoD" in name)
    # the hand-written kernels (launched through ctypes) the trace caught:
    # CUPTI at times misses some of them, so a kernel count that must hold
    # between two runs leaves them out (their wrappers count every launch)
    own = sum(1 for name, _, _ in kernels if any(k in name for k in OWN_KERNELS))
    ell = sum(t for n, t in by_name.items() if "ell_work_kernel" in n or "ell_split_reduce" in n)
    gemm = sum(t for n, t in by_name.items() if "gemm" in n.lower() or "cutlass" in n.lower())
    counts = {}
    for name, _, _ in kernels:
        counts[name] = counts.get(name, 0) + 1
    return {
        "wall_ms": wall_ms, "busy_ms": busy / 1e3, "kernel_ms": total / 1e3,
        "idle_share": max(0.0, 1.0 - busy / 1e3 / wall_ms), "ell_ms": ell / 1e3,
        "gemm_ms": gemm / 1e3, "kernels": len(kernels), "h2d": h2d, "own": own,
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top], "host": host_ops,
        "counts": counts,
    }


def kernel_name_diff(a: dict, b: dict) -> dict:
    """{kernel name: (count in a, count in b)} where two profiles differ."""
    ca, cb = a.get("counts") or {}, b.get("counts") or {}
    return {n[:60]: (ca.get(n, 0), cb.get(n, 0)) for n in sorted(set(ca) | set(cb))
            if ca.get(n, 0) != cb.get(n, 0)}


def profile_launches(step) -> dict:
    """One call of ``step`` under torch.profiler with device activity only,
    read from the raw kineto events (parsing a million function events in
    Python takes minutes): the host wall time around it, the kernels
    launched, the device's busy time (the union of their intervals) and
    idle share. Empty when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    if not spans:
        return {}
    busy, end = 0, float("-inf")
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e6, "kernels": len(spans),
            "idle_share": max(0.0, 1.0 - busy / 1e6 / wall_ms),
            "read_s": time.perf_counter() - t_read}


def profile_text(p: dict) -> str:
    if not p:
        return "device time not measured (the trace holds no device events)"
    top = "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in p["top"])
    host = "; ".join(f"{n[:40]} {t / 1e3:.3f} ms" for n, t in p["host"]) or "not traced"
    return (f"host wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms (idle share "
            f"{p['idle_share']:.3f}), {p['kernels']} kernels summing {p['kernel_ms']:.3f} ms: "
            f"ell_level {p['ell_ms']:.3f}, GEMM {p['gemm_ms']:.3f}, the rest "
            f"{p['kernel_ms'] - p['ell_ms'] - p['gemm_ms']:.3f}; top kernels: {top}; top host "
            f"ops by self CPU time: {host}")


def phase_gat(dev, epochs: int, seed: int, results, failures):
    """GAT 602-128-41 f32 with drop_rate 0 on a unit-weight build of the
    main path's edges: one epoch on the edge chain, --epochs on the ELL
    attention (OPTIM_KERNEL:1) from the same parameters; the ELL route's
    first logits and first-epoch loss against the chain's. Then, on the
    ELL trainer's own tables, each of an epoch's four runtime-weight
    kernel calls against its plain version, timed beside the plain
    version, one torch.sparse.mm with the alpha values and the bound; the
    grad_alpha kernel at both layers against its plain version, timed
    beside it, one torch.sparse.sampled_addmm and its bound; and the row
    softmax of an epoch. Returns the
    {"kernels": ...} rows ell_level_gat and gat_grad_alpha."""
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.models.gat import GATTrainer, LEAKY_SLOPE
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell import ell_tables_aggregate
    from neutronstarlite_torch.ops.ell_gat import gat_ell_alpha
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.utils.config import InputInfo

    src, dst = results["edges"]
    datum = results["datum"]
    v = datum.feature.shape[0]
    t0 = time.perf_counter()
    g1 = build_graph(src, dst, v, weight="ones")
    log(f"GAT graph (unit weights) V={v} E={g1.e_num}: host build "
        f"{time.perf_counter() - t0:.1f} s")

    def trainer(route: str, n_epochs: int):
        cfg = InputInfo(
            algorithm="GAT", vertices=v, layer_string="602-128-41", epochs=n_epochs,
            drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
            decay_epoch=100, optim_kernel=route == "ell",
        )
        return GATTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                      host_graph=g1)

    chain = trainer("chain", 1)
    chain_logits = chain.eval_logits()  # drop_rate 0: the first forward's logits
    params = [{k: t.detach().clone() for k, t in layer.items()} for layer in chain.params]
    torch.cuda.reset_peak_memory_stats()
    chain.run()
    chain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref = chain.loss_history[0]
    log(f"GAT edge chain: epoch-0 loss {ref:.6f} ({chain.epoch_times[0]:.3f} s, peak "
        f"device memory {chain_peak:.2f} GiB)")
    results["gat"] = {"graph": g1, "params": params, "logits": chain_logits, "loss": ref,
                      "chain_s": chain.epoch_times[0]}
    del chain
    tr = trainer("ell", epochs)
    tr.load_params(params)
    try:
        row = max(1.0, float(g1.in_degree.max()) / GAT_ROW)
        logits_err = check_close("GAT ELL first logits", tr.eval_logits(), chain_logits,
                                 (GAT_LOGITS_TOL[0] * row, GAT_LOGITS_TOL[1]))
    except AssertionError as exc:
        failures.append(str(exc))
        log(f"FAILED {exc}")
        logits_err = float("nan")
    rms = float(chain_logits.pow(2).mean().sqrt())
    del chain_logits
    torch.cuda.reset_peak_memory_stats()
    ell_level_aggregate.launches = bsp_aggregate.launches = 0
    tr.compute_graph.grad_alpha_launches = 0
    tr.run()
    torch.cuda.synchronize()
    launches, stray = ell_level_aggregate.launches, bsp_aggregate.launches
    ga_launches = tr.compute_graph.grad_alpha_launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ell_level_aggregate.launches = tr.compute_graph.grad_alpha_launches = 0
    tr.train_step()
    torch.cuda.synchronize()
    per_epoch, ga_per_epoch = ell_level_aggregate.launches, tr.compute_graph.grad_alpha_launches
    losses = tr.loss_history
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"GAT ELL: non-finite loss {losses}")
    if launches <= 0 or stray:
        raise AssertionError(f"GAT ELL: {launches} ell_level launches, {stray} bsp launches")
    if per_epoch > 8:
        raise AssertionError(f"GAT ELL: {per_epoch} ell_level launches per epoch (> 8)")
    if ga_per_epoch != len(tr.params):  # one grad_alpha launch per layer
        raise AssertionError(f"GAT ELL: {ga_per_epoch} grad_alpha launches per epoch")
    if abs(losses[0] - ref) > GAT_LOSS_RTOL * abs(ref):
        failures.append(f"GAT ELL: epoch-0 loss {losses[0]} vs edge chain {ref}")
        log(f"FAILED {failures[-1]}")
    log(f"GAT ELL: first logits max abs err {logits_err:.3e} against the edge chain's "
        f"(their rms {rms:.3e}); epoch-0 loss {losses[0]:.6f} vs chain {ref:.6f} (rel "
        f"{abs(losses[0] - ref) / abs(ref):.2e})")
    results["gat"]["ell_epochs"] = list(tr.epoch_times)
    log(f"GAT ELL: losses {[round(x, 6) for x in losses]}; {launches} ell_level launches "
        f"in {epochs} epochs + eval, {per_epoch} per training epoch; {ga_launches} grad_alpha "
        f"launches in {epochs} epochs, {ga_per_epoch} per training epoch; epochs (s) "
        f"{[round(t, 4) for t in tr.epoch_times]}; host table build "
        f"{tr.build_model_s:.1f} s; peak device memory {peak:.2f} GiB")

    # the runtime-weight kernel on the trainer's own tables
    gep = tr.compute_graph
    calls, layers = gat_epoch_calls(tr)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0}
    err = 0.0
    for direction, f, x, w in calls:
        tables = getattr(gep.pair, direction)
        got = ell_level_aggregate(tables, x, w)
        want = ell_tables_aggregate(x, tables.nbr, w)[tables.inv_perm]
        abs_sum = ell_tables_aggregate(x.abs(), tables.nbr, w)[tables.inv_perm]
        e = check_close(f"GAT ell_level {direction} f={f}", got, want, F32_TOL, abs_sum)
        del abs_sum
        err = max(err, e)
        ms = cuda_ms(lambda: ell_level_aggregate(tables, x, w))
        plain_ms = cuda_ms(lambda: ell_tables_aggregate(x, tables.nbr, w)[tables.inv_perm],
                           n=3, warmup=1)
        layer_alphas = next(a for lf, _, _, _, a in layers if lf == f)
        a = gat_sparse(g1, gep, layer_alphas, direction)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(a, x))
        lib_dev = float((torch.sparse.mm(a, x) - got).abs().max())
        del a
        t_bytes, t_ops = bound_ms(g1, f, 4)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", max(t_bytes, t_ops)), ("bytes_ms", t_bytes),
                       ("ops_ms", t_ops)):
            tot[k] += val
        log(f"GAT ell_level {direction} f={f} f32 runtime weights launch: "
            f"{ell_geometry_text(ell_geometry(tables, f, x.dtype))}")
        log(f"GAT ell_level {direction} tables V={v} E={g1.e_num} f={f} f32: max abs err "
            f"{e:.3e} against the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm {lib_ms:.4f} ms (max abs deviation from the kernel "
            f"{lib_dev:.3e}), bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
            f"f32 ops {t_ops:.4f})")
    # grad_alpha at both layers: the kernel (one launch per call) against
    # its plain version, each timed, beside the bound (2*E*f f32 operations
    # against g and h read once, 8*V*f bytes, the slot indices, 4*E, and the
    # output, 4 B per slot, zero fill included) and one
    # torch.sparse.sampled_addmm, the same SDDMM over the edges
    gens = torch.Generator(device=dev).manual_seed(seed + 6)
    grads = [torch.randn(h.shape, generator=gens, device=dev) for _, h, _, _, _ in layers]
    ga = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
          "ops_ms": 0.0}
    ga_err = 0.0
    for gr, (f, h, _, _, _) in zip(grads, layers):
        before = gep.grad_alpha_launches
        got = torch.cat([a.reshape(-1) for a in gep.grad_alphas(gr, h)])
        torch.cuda.synchronize()
        if gep.grad_alpha_launches - before != 1:
            raise AssertionError(f"GAT grad_alpha f={f}: "
                                 f"{gep.grad_alpha_launches - before} launches in one call")
        want = torch.cat([a.reshape(-1) for a in gep.plain_grad_alphas(gr, h)])
        abs_sum = torch.cat([a.reshape(-1) for a in gep.plain_grad_alphas(gr.abs(), h.abs())])
        e = check_close(f"GAT grad_alpha f={f}", got, want, F32_TOL, abs_sum)
        del got, want, abs_sum
        ga_err = max(ga_err, e)
        ms = cuda_ms(lambda: gep.grad_alphas(gr, h))
        plain_ms = cuda_ms(lambda: gep.plain_grad_alphas(gr, h), n=3, warmup=1)
        a = gat_sparse(g1, gep, gep.grad_alphas(gr, h), "fwd")  # the kernel's values, A[dst, src]
        lib_ms = cuda_ms(lambda: torch.sparse.sampled_addmm(a, gr, h.t(), beta=0.0))
        lib_dev = float((torch.sparse.sampled_addmm(a, gr, h.t(), beta=0.0).values()
                         - a.values()).abs().max())
        del a
        slots = sum(n.numel() for n in gep.pair.fwd.nbr)
        t_bytes = (8.0 * v * f + 4.0 * g1.e_num + 4.0 * slots) / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * g1.e_num * f / F32_FLOPS * 1e3
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", max(t_bytes, t_ops)), ("bytes_ms", t_bytes),
                       ("ops_ms", t_ops)):
            ga[k] += val
        log(f"GAT grad_alpha f={f} f32 V={v} E={g1.e_num}: max abs err {e:.3e} against the "
            f"plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sparse.sampled_addmm {lib_ms:.4f} ms (max abs deviation from the kernel "
            f"{lib_dev:.3e}), bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, f32 ops "
            f"{t_ops:.4f})")

    def softmax_pass(al, ar):
        al, ar = al.detach().requires_grad_(True), ar.detach().requires_grad_(True)
        alphas = gat_ell_alpha(gep, al, ar, LEAKY_SLOPE)
        torch.autograd.backward(alphas, [torch.ones_like(a) for a in alphas])

    softmax_ms = sum(cuda_ms(lambda: softmax_pass(al, ar), n=3, warmup=1)
                     for _, _, al, ar, _ in layers)
    log(f"GAT ELL training epoch under torch.profiler: {profile_text(profile_step(tr.train_step))}")
    epoch_ms = 1e3 * float(np.mean(tr.epoch_times[1:] or tr.epoch_times))
    log(f"timing GAT ELL epoch ({epoch_ms:.3f} ms, host clock around the synchronised "
        f"step): ell_level runtime-weight calls {[(d, f) for d, f, _, _ in calls]} "
        f"{tot['ms']:.4f} ms (plain {tot['plain_ms']:.4f}, torch.sparse.mm "
        f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}: bytes {tot['bytes_ms']:.4f}, "
        f"f32 ops {tot['ops_ms']:.4f}); grad_alpha kernel, both layers {ga['ms']:.4f} ms "
        f"(plain {ga['plain_ms']:.4f}, torch.sparse.sampled_addmm {ga['library_ms']:.4f}, "
        f"bound {ga['bound_ms']:.4f}); row softmax "
        f"forward+backward, both layers {softmax_ms:.4f} ms; ell_level launches per epoch "
        f"{per_epoch}")
    rows = [{
        "name": "ell_level_gat", "route": "cuda",
        "source": "neutronstarlite_torch/csrc/ell_level.cu",
        "replaces": "neutronstarlite_tpu/ops/pallas_kernels.py:91",
        "launches": launches, "max_abs_err": err, "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        "library_ms": tot["library_ms"],
    }, {
        "name": "gat_grad_alpha", "route": "cuda",
        "source": "neutronstarlite_torch/csrc/ell_gat.cu",
        "replaces": "none (plain jnp in neutronstarlite_tpu/ops/ell_gat.py)",
        "launches": ga_launches, "max_abs_err": ga_err, "ms": ga["ms"],
        "plain_ms": ga["plain_ms"], "bound_ms": ga["bound_ms"],
        "bound_by": "bytes" if ga["bytes_ms"] >= ga["ops_ms"] else "operations",
        "library_ms": ga["library_ms"],
    }]
    del tr, gep, calls, layers, grads
    torch.cuda.empty_cache()
    return rows


def phase_gin_commnet(dev, g, epochs: int, seed: int, results, failures) -> None:
    """GIN and CommNet 602-128-41 f32, drop_rate 0, from one seed: one epoch
    on the scatter route, then --epochs on the ELL and bsp routes; each
    kernel route's first-epoch loss against the scatter route's (a
    relative tolerance: f32, and the bsp kernel's atomics add in a varying
    order)."""
    import torch

    from neutronstarlite_torch.models.commnet import CommNetTrainer
    from neutronstarlite_torch.models.gin import GINTrainer
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.utils.config import InputInfo

    src, dst = results["edges"]
    datum = results["datum"]
    v = g.v_num
    counters = {"bsp": bsp_aggregate, "ell": ell_level_aggregate}
    for name, cls in (("GIN", GINTrainer), ("COMMNET", CommNetTrainer)):
        ref = None
        for route, n_epochs in (("scatter", 1), ("ell", epochs), ("bsp", epochs)):
            cfg = InputInfo(
                algorithm=name, vertices=v, layer_string="602-128-41", epochs=n_epochs,
                drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
                decay_epoch=100, optim_kernel=route != "scatter",
                pallas_kernel=route == "bsp",
            )
            os.environ["NTS_PALLAS_RESIDENT"] = "0"
            tr = cls.from_arrays(cfg, src, dst, datum, seed=seed, device=dev, host_graph=g)
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            tr.run()
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            per_epoch, steady = 0, []
            if route != "scatter":
                counters[route].launches = 0
                for i in range(3):  # steady epochs, host clock around a synchronised step
                    t0 = time.perf_counter()
                    tr.train_step()
                    torch.cuda.synchronize()
                    steady.append(time.perf_counter() - t0)
                    if i == 0:
                        per_epoch = counters[route].launches
                log(f"{name} {route} training epoch under torch.profiler: "
                    f"{profile_text(profile_step(tr.train_step))}")
            losses = tr.loss_history
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{name} {route}: non-finite loss {losses}")
            if route == "scatter":
                ref = losses[0]
                if any(launches.values()):
                    raise AssertionError(f"{name} scatter launched a kernel: {launches}")
            else:
                other = "ell" if route == "bsp" else "bsp"
                if launches[route] <= 0 or launches[other]:
                    raise AssertionError(f"{name} {route}: launches {launches}")
                if abs(losses[0] - ref) > FAMILY_LOSS_RTOL * abs(ref):
                    failures.append(f"{name} {route}: epoch-0 loss {losses[0]} vs scatter {ref}")
                    log(f"FAILED {failures[-1]}")
            log(f"{name} {route}: losses {[round(x, 6) for x in losses]} (scatter epoch-0 "
                f"{ref:.6f}); {launches.get(route, 0)} launches, {per_epoch} per training "
                f"epoch; epochs (s) {[round(t, 4) for t in tr.epoch_times]}, then "
                f"{[round(t, 4) for t in steady]}; host table build "
                f"{tr.build_model_s:.1f} s; peak device memory "
                f"{peak:.2f} GiB")
            del tr
            torch.cuda.empty_cache()


def ggcn_graph(scale: float, seed: int):
    """(src, dst, datum) of GGCN's power-law graph at ``scale`` of Reddit."""
    import numpy as np

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.synthetic import reddit_scaled, synthetic_power_law_graph

    v, e = reddit_scaled(scale)
    src, dst = synthetic_power_law_graph(v, e, seed=seed + 11)
    rng = np.random.default_rng(seed + 11)
    return src, dst, GNNDatum(
        feature=rng.standard_normal((v, 602), dtype=np.float32) * 0.1,
        label=rng.integers(0, 41, size=v, dtype=np.int32),
        mask=(np.arange(v) % 3).astype(np.int32),
    )


def phase_ggcn(dev, scale: float, seed: int) -> dict:
    """GGCN 602-128-41 f32 on its edge chain, 2 epochs, at a fifth of the
    main path's scale: its [E, 128] f32 edge tensors (5.9 GB each at 0.1 of
    Reddit) are kept several times over by autograd. Returns the graph, the
    initial parameters, the first logits and the epoch-0 loss, which
    phase 10 holds the fused route against."""
    import torch

    from neutronstarlite_torch.models.ggcn import GGCNTrainer
    from neutronstarlite_torch.utils.config import InputInfo

    src, dst, datum = ggcn_graph(scale * 0.2, seed)
    v = datum.feature.shape[0]
    cfg = InputInfo(
        algorithm="GGCN", vertices=v, layer_string="602-128-41", epochs=2, drop_rate=0.0,
        learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
    )
    tr = GGCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev)
    chain = {"edges": (src, dst), "datum": datum, "graph": tr.host_graph,
             "params": [{k: t.detach().clone() for k, t in layer.items()}
                        for layer in tr.params],
             "logits": tr.eval_logits()}
    torch.cuda.reset_peak_memory_stats()
    out = tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logits = tr.eval_logits()
    if tuple(logits.shape) != (v, 41) or not torch.isfinite(logits).all():
        raise AssertionError(f"GGCN: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if not all(math.isfinite(x) for x in tr.loss_history):
        raise AssertionError(f"GGCN: non-finite loss {tr.loss_history}")
    log(f"GGCN edge chain V={v} E={tr.host_graph.e_num}: losses "
        f"{[round(x, 6) for x in tr.loss_history]}, train acc {out['acc']['train']:.4f}; "
        f"epochs (s) {[round(t, 4) for t in tr.epoch_times]}; peak device memory "
        f"{peak:.2f} GiB")
    chain.update(loss=tr.loss_history[0], epochs=list(tr.epoch_times), peak_gib=peak)
    del tr, logits
    torch.cuda.empty_cache()
    return chain


def kernel_launches() -> dict:
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    return {"ell_level": ell_level_aggregate.launches, "bsp_ell": bsp_aggregate.launches}


def zero_launches() -> None:
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate

    ell_level_aggregate.launches = bsp_aggregate.launches = 0


def check_no_kernel(name: str) -> None:
    """The blocked and fused routes are plain PyTorch: neither hand-written
    kernel may have been launched since the counts were set to 0."""
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"{name} launched a hand-written kernel: {launches}")


def run_route(tr, name: str, ref_logits, logits_tol, ref_loss: float, loss_rtol: float,
              failures) -> dict:
    """Hold the trainer's first logits against ``ref_logits`` and its
    epoch-0 loss against ``ref_loss``, run it with the kernels' counts at 0
    and its peak memory reset, and check that no kernel ran; a
    disagreement is deferred to ``failures``."""
    import torch

    zero_launches()
    try:
        err = check_close(f"{name} first logits", tr.eval_logits(), ref_logits, logits_tol)
    except AssertionError as exc:
        failures.append(str(exc))
        log(f"FAILED {exc}")
        err = float("nan")
    torch.cuda.reset_peak_memory_stats()
    tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_no_kernel(name)
    losses = tr.loss_history
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if rel > loss_rtol:
        failures.append(f"{name}: epoch-0 loss {losses[0]} vs reference {ref_loss}")
        log(f"FAILED {failures[-1]}")
    rms = float(ref_logits.pow(2).mean().sqrt())
    log(f"{name}: first logits max abs err {err:.3e} (reference rms {rms:.3e}); epoch-0 "
        f"loss {losses[0]:.6f} vs {ref_loss:.6f} (rel {rel:.2e}); losses "
        f"{[round(x, 6) for x in losses]}; epochs (s) {[round(t, 4) for t in tr.epoch_times]}; "
        f"host table build {tr.build_model_s:.1f} s; peak device "
        f"memory {peak:.2f} GiB; ell_level and bsp_ell launches 0")
    return {"peak_gib": peak, "epochs": list(tr.epoch_times)}


def fused_pass_ms(pair, layers, seed: int) -> dict:
    """CUDA-event times of the fused op's forward and its three backward
    passes, summed over ``layers`` [(h, asrc, adst, slope)] (one training
    epoch's calls), each pass on a random output gradient."""
    import torch

    from neutronstarlite_torch.ops import fused_edge as fe

    gen = torch.Generator(device=layers[0][0].device).manual_seed(seed)
    tot = {"forward": 0.0, "A (T1)": 0.0, "B (grad_adst)": 0.0, "C (grad_h, grad_asrc)": 0.0}
    for h, asrc, adst, slope in layers:
        V, f, C = h.shape[0], h.shape[1], asrc.shape[1]

        def zeros(c):
            return torch.zeros((V, c), device=h.device)

        def forward():
            return fe.fused_forward_into(pair.fwd, fe.fused_init_state(V, C, f, h.device),
                                         h, asrc, adst, slope)

        m, l, _ = forward()
        g = torch.randn(h.shape, generator=gen, device=h.device)
        t1 = fe.fused_bwd_t1_into(pair.fwd, zeros(C), h, asrc, adst, m, l, g, slope)
        passes = {
            "forward": forward,
            "A (T1)": lambda: fe.fused_bwd_t1_into(pair.fwd, zeros(C), h, asrc, adst, m, l,
                                                   g, slope),
            "B (grad_adst)": lambda: fe.fused_bwd_gadst_into(pair.fwd, zeros(C), h, asrc,
                                                             adst, m, l, t1, g, slope),
            "C (grad_h, grad_asrc)": lambda: fe.fused_bwd_src_into(
                pair.bwd, (zeros(f), zeros(C)), h, asrc, adst, m, l, t1, g, slope),
        }
        for k, fn in passes.items():
            tot[k] += cuda_ms(fn, n=2, warmup=1)
    return tot


def fused_layers(tr, halves, slope: float):
    """(h, asrc, adst, slope) of each layer of a fused trainer's eval
    forward at its parameters; ``halves(layer, h)`` gives the score
    halves (GAT: h @ a[:f], h @ a[f:]; GGCN: h @ Ws, h @ Wd)."""
    import torch

    from neutronstarlite_torch.ops.fused_edge import fused_edge_attention_aggregate

    out, x = [], tr.feature
    with torch.no_grad():
        for layer in tr.params:
            h = x @ layer["W"]
            asrc, adst = halves(layer, h)
            out.append((h, asrc, adst, slope))
            x = torch.relu(fused_edge_attention_aggregate(tr.compute_graph, h, asrc, adst,
                                                          slope))
    return out


def pass_text(ms: dict) -> str:
    return ", ".join(f"{k} {t:.2f} ms" for k, t in ms.items())


def phase_blocked_and_fused(dev, g, scale: float, epochs: int, seed: int, results,
                            ggcn_chain: dict, failures) -> None:
    """Phase 10: the blocked ELL route and KERNEL:fused_edge, plain PyTorch
    on the card. (a) GCN bf16 through OPTIM_KERNEL:1 KERNEL_TILE:4096 on
    phase 4's graph and seeded parameters; (b) GAT f32 through
    KERNEL:fused_edge from phase 7's chain parameters; (c) GGCN f32 fused
    from phase 9's chain parameters at 0.2 x --scale, then fused at --scale
    itself; (d) the fused op alone on the card against the CPU, C=1 and
    C=f, and twice on the card. No route may launch a hand-written
    kernel."""
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import synthetic_power_law_graph
    from neutronstarlite_torch.models.gat import LEAKY_SLOPE, GATTrainer
    from neutronstarlite_torch.models.gcn import GCNTrainer
    from neutronstarlite_torch.models.ggcn import GGCN_LEAKY_SLOPE, GGCNTrainer
    from neutronstarlite_torch.ops.blocked_ell import BlockedEllPair
    from neutronstarlite_torch.ops.fused_edge import FusedEdgePair, fused_edge_attention_aggregate
    from neutronstarlite_torch.utils.config import InputInfo

    src, dst = results["edges"]
    datum = results["datum"]
    v = g.v_num
    common = dict(layer_string="602-128-41", drop_rate=0.0, learn_rate=0.01,
                  weight_decay=1e-4, decay_rate=0.97, decay_epoch=100)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 10 on {smi}")

    # (a) GCN bf16 through the blocked ELL route
    os.environ["NTS_PALLAS_RESIDENT"] = "0"
    cfg = InputInfo(algorithm="GCN", vertices=v, epochs=epochs, precision="bfloat16",
                    optim_kernel=True, kernel_tile=4096, **common)
    tr = GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev, host_graph=g)
    if not isinstance(tr.compute_graph, BlockedEllPair):
        raise AssertionError(f"GCN blocked: compute graph {type(tr.compute_graph).__name__}")
    fwd = tr.compute_graph.fwd
    log(f"GCN blocked tables: {fwd.n_tiles} tiles of {fwd.vt}, {len(fwd.nbr)} levels, "
        f"{fwd.slot_count()} fwd slots for {g.e_num} edges")
    run_route(tr, "GCN blocked (OPTIM_KERNEL:1 KERNEL_TILE:4096, bf16)",
              results["logits_f32"], LOGITS_TOL, results["plain"]["losses"][0], LOSS_RTOL,
              failures)
    del tr
    torch.cuda.empty_cache()

    # (b) GAT f32 through KERNEL:fused_edge
    gat = results["gat"]
    cfg = InputInfo(algorithm="GAT", vertices=v, epochs=epochs, kernel="fused_edge",
                    **common)
    tr = GATTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                host_graph=gat["graph"])
    tr.load_params(gat["params"])
    if not isinstance(tr.compute_graph, FusedEdgePair):
        raise AssertionError(f"GAT fused: compute graph {type(tr.compute_graph).__name__}")
    row = max(1.0, float(gat["graph"].in_degree.max()) / GAT_ROW)
    out = run_route(tr, "GAT fused (KERNEL:fused_edge, f32)", gat["logits"],
                    (GAT_LOGITS_TOL[0] * row, GAT_LOGITS_TOL[1]), gat["loss"],
                    GAT_LOSS_RTOL, failures)
    ms = fused_pass_ms(tr.compute_graph, fused_layers(
        tr, lambda p, h: (h @ p["a"][:h.shape[1]], h @ p["a"][h.shape[1]:]), LEAKY_SLOPE),
        seed + 7)
    steady = out["epochs"][1:] or out["epochs"]
    log(f"timing GAT fused epoch {1e3 * float(np.mean(steady)):.3f} ms (host clock around "
        f"the synchronised step; the ELL attention's epochs (s) "
        f"{[round(t, 4) for t in gat['ell_epochs']]}, the chain's {gat['chain_s']:.4f} s); "
        f"fused op passes, both layers: {pass_text(ms)}; "
        f"{tr.compute_graph.slot_count()} table slots")
    log(f"GAT fused training epoch under torch.profiler: "
        f"{profile_text(profile_step(tr.train_step, host=False))}")
    check_no_kernel("GAT fused")
    del tr
    torch.cuda.empty_cache()

    # (c) GGCN f32 through KERNEL:fused_edge: against the chain at 0.2 x
    # --scale (where phase 9 ran it), then alone at --scale
    vc = ggcn_chain["datum"].feature.shape[0]
    cfg = InputInfo(algorithm="GGCN", vertices=vc, epochs=2, kernel="fused_edge", **common)
    tr = GGCNTrainer.from_arrays(cfg, *ggcn_chain["edges"], ggcn_chain["datum"], seed=seed,
                                 device=dev, host_graph=ggcn_chain["graph"])
    tr.load_params(ggcn_chain["params"])
    row = max(1.0, float(ggcn_chain["graph"].in_degree.max()) / GAT_ROW)
    out = run_route(tr, f"GGCN fused at 0.2 x scale (V={vc})", ggcn_chain["logits"],
                    (GAT_LOGITS_TOL[0] * row, GAT_LOGITS_TOL[1]), ggcn_chain["loss"],
                    GAT_LOSS_RTOL, failures)
    log(f"GGCN at 0.2 x scale: fused epochs (s) {[round(t, 4) for t in out['epochs']]}, "
        f"peak {out['peak_gib']:.2f} GiB; the chain's epochs (s) "
        f"{[round(t, 4) for t in ggcn_chain['epochs']]}, peak {ggcn_chain['peak_gib']:.2f} GiB")
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gsrc, gdst, gdatum = ggcn_graph(scale, seed)
    vg = gdatum.feature.shape[0]
    cfg = InputInfo(algorithm="GGCN", vertices=vg, epochs=2, kernel="fused_edge", **common)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    tr = GGCNTrainer.from_arrays(cfg, gsrc, gdst, gdatum, seed=seed, device=dev)
    setup_s = time.perf_counter() - t0
    res = tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logits = tr.eval_logits()
    check_no_kernel("GGCN fused at scale")
    if (tuple(logits.shape) != (vg, 41) or not torch.isfinite(logits).all()
            or not all(math.isfinite(x) for x in tr.loss_history)):
        raise AssertionError(f"GGCN fused at scale: logits {tuple(logits.shape)}, losses "
                             f"{tr.loss_history}")
    ms = fused_pass_ms(tr.compute_graph, fused_layers(
        tr, lambda p, h: (h @ p["Ws"], h @ p["Wd"]), GGCN_LEAKY_SLOPE), seed + 8)
    log(f"GGCN fused at --scale {scale} V={vg} E={tr.host_graph.e_num}: losses "
        f"{[round(x, 6) for x in tr.loss_history]}, train acc {res['acc']['train']:.4f}; "
        f"epochs (s) {[round(t, 4) for t in tr.epoch_times]}; host table build "
        f"{tr.build_model_s:.1f} s (graph generate + build + tables "
        f"{setup_s:.1f} s); peak device memory {peak:.2f} GiB; fused op passes, both "
        f"layers: {pass_text(ms)}; {tr.compute_graph.slot_count()} table slots")
    log(f"GGCN fused training epoch at --scale under torch.profiler: "
        f"{profile_text(profile_step(tr.train_step, host=False))}")
    del tr, logits
    torch.cuda.empty_cache()

    # (d) the fused op alone: card against CPU, and twice on the card
    vs = 6000
    gs = build_graph(*synthetic_power_law_graph(vs, 120_000, seed=seed + 13), vs,
                     weight="ones")
    pair_cpu = FusedEdgePair.from_host(gs, vt=1024)
    pair = FusedEdgePair.from_host(gs, vt=1024, device=dev)
    rng = np.random.default_rng(seed + 13)
    f = 64
    for C, slope in ((1, 0.01), (f, 0.2)):
        arrays = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                  for sh in ((vs, f), (vs, C), (vs, C), (vs, f))]
        runs = []
        for device, p in (("cpu", pair_cpu), (dev, pair), (dev, pair)):
            ins = [a.detach().to(device).requires_grad_(True) for a in arrays[:3]]
            o = fused_edge_attention_aggregate(p, *ins, slope)
            o.backward(arrays[3].to(device))
            runs.append([o.detach()] + [a.grad for a in ins])
        torch.cuda.synchronize()
        check_no_kernel("fused op")
        errs = [check_close(f"fused op C={C} {name} card vs CPU", got.cpu(), want, F32_TOL)
                for name, got, want in zip(("out", "grad_h", "grad_asrc", "grad_adst"),
                                           runs[1], runs[0])]
        if not all(torch.equal(a, b) for a, b in zip(runs[1], runs[2])):
            raise AssertionError(f"fused op C={C}: two calls on the card differ")
        log(f"fused op alone V={vs} E={gs.e_num} (max in-degree {int(gs.in_degree.max())}, "
            f"{pair.fwd.n_tiles} tiles) C={C}: card vs CPU max abs err out/grad_h/grad_asrc/"
            f"grad_adst {', '.join(f'{e:.2e}' for e in errs)} (tolerance {F32_TOL[0]}*rms + "
            f"{F32_TOL[1]}*|ref|); two calls on the card bitwise equal")


class Recorder:
    """A fault/recovery sink (resilience.events): keeps (record, kind or
    action, fields)."""

    def __init__(self):
        self.records = []

    def event(self, event_kind, **fields):
        self.records.append((event_kind, fields.get("kind") or fields.get("action"), fields))


def named_leaves(tr) -> dict:
    """The trainer's checkpoint leaves by name (params[0]['W'], opt.m[..]),
    as float64 numpy arrays on the host."""
    import numpy as np
    import torch

    from neutronstarlite_torch.utils import tree as tree_util

    return {name + path: (leaf.detach().double().cpu().numpy() if torch.is_tensor(leaf)
                          else np.asarray(leaf, dtype=np.float64))
            for name, t in tr.checkpoint_state().items()
            for path, leaf in tree_util.flatten_with_path(t)}


def max_leaf_diff(a: dict, b: dict) -> float:
    import numpy as np

    if list(a) != list(b):
        raise AssertionError(f"leaf names differ: {list(a)[:4]} vs {list(b)[:4]}")
    return max(float(np.abs(a[k] - b[k]).max()) if a[k].size else 0.0 for k in a)


def phase_resilience(dev, g, seed: int, results, failures) -> None:
    """Phase 11: checkpoints and the supervisor on the card, GCN bf16
    602-128-41 with DROP_RATE 0.5 on phase 4's graph. (a) the ELL route, 6
    straight epochs against 3 + save + a new trainer restored + 3, bitwise;
    (b) the bsp route: the restored tensors against the saved ones, and the
    continued losses against the spread of two straight runs; (c)
    supervised_run under nan_loss@epoch=3 with a checkpoint each epoch:
    one fault, one rollback, the straight run's losses bitwise; (d)
    ckpt_corrupt on the final save: quarantine, fallback, resume; (e) a
    CPU checkpoint of Cora GCN restored on the card, and the Cora CLI
    resumed from a checkpoint; (f) save, restore and verify times, and the
    ELL epoch with the guards armed and not."""
    import numpy as np
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import load_edges
    from neutronstarlite_torch.models.gcn import GCNTrainer
    from neutronstarlite_torch.ops.bsp_ell import bsp_aggregate
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.resilience import events, faults, guards
    from neutronstarlite_torch.resilience.supervisor import supervised_run
    from neutronstarlite_torch.utils.checkpoint import list_steps, verify_step_dir
    from neutronstarlite_torch.utils.config import InputInfo

    src, dst = results["edges"]
    datum = results["datum"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 11 on {smi}")
    counters = {"ell": ell_level_aggregate, "bsp": bsp_aggregate}
    work = tempfile.mkdtemp(prefix="nts-phase11-")

    def trainer(route, epochs, ck="", every=0):
        os.environ["NTS_PALLAS_RESIDENT"] = "1" if route == "ell" else "0"
        cfg = InputInfo(
            algorithm="GCN", vertices=g.v_num, layer_string="602-128-41", epochs=epochs,
            drop_rate=0.5, precision="bfloat16", learn_rate=0.01, weight_decay=1e-4,
            decay_rate=0.97, decay_epoch=100, optim_kernel=True, pallas_kernel=True,
            checkpoint_dir=ck, checkpoint_every=every,
        )
        return GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                      host_graph=g)

    def drive(tr, route):
        """tr.run() with the kernels' counts at 0 before it; its kernel's
        launches, read just after."""
        zero_launches()
        tr.run()
        torch.cuda.synchronize()
        launches = kernel_launches()["ell_level" if route == "ell" else "bsp_ell"]
        if launches <= 0:
            raise AssertionError(f"phase 11 {route}: its kernel was never launched")
        return launches

    def rerun(tr, epochs, ck):
        """The same trainer (its tables kept) from fresh parameters."""
        tr.init_model()
        tr.cfg.epochs, tr.cfg.checkpoint_dir = epochs, ck
        tr.epoch_times, tr.loss_history = [], []
        tr._first_epoch_trained, tr._guard_state = None, None
        return tr

    def check(name, ok, msg):
        if not ok:
            failures.append(f"phase 11 {name}: {msg}")
            log(f"FAILED {failures[-1]}")

    try:
        # (a) the ELL route: 6 straight against 3 + save + restore + 3
        ck = os.path.join(work, "ell")
        straight = trainer("ell", 6)
        n_s = drive(straight, "ell")
        first = trainer("ell", 3, ck)
        n_1 = drive(first, "ell")
        second = trainer("ell", 6, ck)
        n_2 = drive(second, "ell")
        resumed = first.loss_history + second.loss_history
        loss_d = max(abs(a - b) for a, b in zip(resumed, straight.loss_history))
        leaf_d = max_leaf_diff(named_leaves(second), named_leaves(straight))
        log(f"(a) ELL resume: losses straight {straight.loss_history}, 3 + restore + 3 "
            f"{resumed}; max |d| losses {loss_d:.3e}, params and Adam m, v, step "
            f"{leaf_d:.3e} (must be 0); ell_level launches {n_s} straight, {n_1} + {n_2} "
            f"resumed")
        check("(a) ELL resume", len(second.loss_history) == 3 and loss_d == 0.0
              and leaf_d == 0.0, f"max |d| losses {loss_d}, leaves {leaf_d}")
        straight_leaves = named_leaves(straight)
        del first, second

        # (b) the bsp route, one trainer (its tables built once)
        ck = os.path.join(work, "bsp")
        tr = trainer("bsp", 6)
        drive(tr, "bsp")
        s1 = list(tr.loss_history)
        drive(rerun(tr, 6, ""), "bsp")
        s2 = list(tr.loss_history)
        drive(rerun(tr, 3, ck), "bsp")
        part1, saved = list(tr.loss_history), named_leaves(tr)
        rerun(tr, 6, ck)
        if tr.restore(ck) != 3:
            raise AssertionError("phase 11 (b): the bsp checkpoint did not restore step 3")
        restored_d = max_leaf_diff(named_leaves(tr), saved)
        drive(tr, "bsp")
        cont = tr.loss_history
        spread = max(abs(a - b) for a, b in zip(s1[3:], s2[3:]))
        dev_ = max(abs(a - b) for a, b in zip(cont, s1[3:]))
        limit = 2.0 * spread + BSP_RESUME_RTOL * max(abs(x) for x in s1)
        log(f"(b) bsp resume: restored tensors vs saved max |d| {restored_d:.3e} (must be "
            f"0); continued losses {cont} vs straight {s1[3:]} and {s2[3:]}: max |d| "
            f"{dev_:.3e}, the two straight runs' spread {spread:.3e} (limit 2 x spread + "
            f"{BSP_RESUME_RTOL:g} x |loss| = {limit:.3e}); first three {part1}")
        check("(b) bsp restore", restored_d == 0.0, f"restored tensors off by {restored_d}")
        check("(b) bsp continuation", len(cont) == 3 and dev_ <= limit,
              f"continued losses off by {dev_} (spread {spread})")
        del tr

        # (c) rollback under nan_loss@epoch=3
        ck = os.path.join(work, "rollback")
        tr = trainer("ell", 6, ck, every=1)
        rec = Recorder()
        os.environ["NTS_FAULT_SPEC"] = "nan_loss@epoch=3"
        faults.reset()
        events.set_sink(rec)
        try:
            zero_launches()
            supervised_run(tr, backoff_base_s=0.0)
            torch.cuda.synchronize()
            n_c = kernel_launches()["ell_level"]
        finally:
            os.environ.pop("NTS_FAULT_SPEC")
            faults.reset()
            events.set_sink(None)
        seq = [(r[0], r[1], r[2].get("epoch")) for r in rec.records]
        loss_d = max(abs(a - b) for a, b in zip(tr.loss_history, straight.loss_history))
        leaf_d = max_leaf_diff(named_leaves(tr), straight_leaves)
        log(f"(c) rollback: records {seq}; losses {tr.loss_history}; max |d| against (a)'s "
            f"straight run: losses {loss_d:.3e}, leaves {leaf_d:.3e} (must be 0); "
            f"ell_level launches {n_c}")
        check("(c) rollback", seq == [("fault", "nonfinite_loss", 3),
                                      ("recovery", "rollback", 3)]
              and len(tr.loss_history) == 6 and loss_d == 0.0 and leaf_d == 0.0
              and n_c > 0, f"records {seq}, |d| losses {loss_d}, leaves {leaf_d}")

        # (d) a corrupt final save: quarantine, fallback to step 1, resume
        ck = os.path.join(work, "corrupt")
        os.environ["NTS_FAULT_SPEC"] = "ckpt_corrupt@save=3"
        faults.reset()
        try:
            drive(rerun(tr, 2, ck), "ell")  # saves steps 1, 2 and 2 again (#3, corrupted)
        finally:
            os.environ.pop("NTS_FAULT_SPEC")
            faults.reset()
        rec = Recorder()
        events.set_sink(rec)
        try:
            tr.cfg.checkpoint_every = 0
            drive(rerun(tr, 4, ck), "ell")
        finally:
            events.set_sink(None)
        seq = [(r[0], r[1]) for r in rec.records]
        quarantined = sorted(n for n in os.listdir(ck) if n.endswith(".corrupt"))
        log(f"(d) corrupt checkpoint: records {seq}; quarantined {quarantined}; resumed "
            f"run trained {len(tr.epoch_times)} epochs, losses {tr.loss_history}")
        check("(d) corrupt checkpoint",
              seq == [("fault", "ckpt_corrupt"), ("recovery", "ckpt_fallback"),
                      ("recovery", "resume")] and len(tr.epoch_times) == 3
              and quarantined and all(math.isfinite(x) for x in tr.loss_history),
              f"records {seq}, {len(tr.epoch_times)} epochs, quarantined {quarantined}")

        # (f) save, restore, verify and the guards at this width
        ck = os.path.join(work, "times")
        t_save, t_restore, t_verify = [], [], []
        for i in range(5):
            t0 = time.perf_counter()
            straight.save(ck, 100 + i)
            t_save.append(time.perf_counter() - t0)
            step_dir = list_steps(ck)[-1][1]
            t0 = time.perf_counter()
            verify_step_dir(step_dir)
            t_verify.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            straight.restore(ck)
            torch.cuda.synchronize()
            t_restore.append(time.perf_counter() - t0)
        nbytes = sum(os.path.getsize(os.path.join(step_dir, n)) for n in os.listdir(step_dir))
        guard_ms = []
        with guards.armed():
            for epoch in range(20):
                t0 = time.perf_counter()
                guards.epoch_check(tr, 50 + epoch, 0.01, 1.0)
                guard_ms.append((time.perf_counter() - t0) * 1e3)
        loop = {}
        for armed in (False, True) * 3:
            ends = []
            rerun(tr, 20, "")
            emit = tr.emit_epoch
            tr.emit_epoch = lambda *a, **k: (emit(*a, **k), ends.append(time.perf_counter()))
            if armed:
                with guards.armed():
                    drive(tr, "ell")
            else:
                drive(tr, "ell")
            del tr.emit_epoch
            steady = np.diff(ends)[1:] * 1e3  # from the 2nd epoch's end on
            loop.setdefault(armed, []).extend(steady.tolist())
        log(f"(f) at 602-128-41 on {smi}: save {np.mean(t_save) * 1e3:.2f} ms, "
            f"restore {np.mean(t_restore) * 1e3:.2f} ms, verify_step_dir "
            f"{np.mean(t_verify) * 1e3:.2f} ms (means of 5; {nbytes} bytes per step); "
            f"guard check alone {np.mean(guard_ms):.3f} ms (mean of 20); ELL epoch loop "
            f"(step, guards, cadence accuracies), end to end of the steady epochs of 3 "
            f"alternating 20-epoch runs each: guards unarmed mean {np.mean(loop[False]):.3f} "
            f"ms, median {np.median(loop[False]):.3f} (range {min(loop[False]):.3f}-"
            f"{max(loop[False]):.3f}); armed mean {np.mean(loop[True]):.3f} ms, median "
            f"{np.median(loop[True]):.3f} ({min(loop[True]):.3f}-{max(loop[True]):.3f})")
        del tr, straight
        torch.cuda.empty_cache()

        # (e) Cora GCN: a CPU checkpoint on the card, and the CLI resumed
        fix = os.path.join(REPO, "tests", "fixtures", "cora")
        c_src, c_dst = load_edges(os.path.join(fix, "cora.2708.edge.self"))
        c_datum = GNNDatum.read_feature_label_mask(
            "", os.path.join(fix, "cora.labeltable"), os.path.join(fix, "cora.mask"),
            2708, 1433, seed=0)
        ck = os.path.join(work, "cora")

        def cora(device, epochs):
            cfg = InputInfo(algorithm="GCNCPU", vertices=2708, layer_string="1433-16-7",
                            epochs=epochs, drop_rate=0.5, decay_epoch=-1, checkpoint_dir=ck)
            return GCNTrainer.from_arrays(cfg, c_src, c_dst, c_datum, seed=seed,
                                          device=device)

        cpu = cora("cpu", 3)
        cpu.run()
        card = cora(dev, 3)
        if card.restore(ck) != 3:
            raise AssertionError("phase 11 (e): the CPU checkpoint did not restore")
        err = float((card.eval_logits().cpu() - cpu.eval_logits()).abs().max())
        log(f"(e) Cora GCN 1433-16-7: a checkpoint written on the CPU restored on {dev}: "
            f"eval logits max |d| {err:.3e} against the CPU eval (limit 1e-3)")
        check("(e) CPU checkpoint on the card", err <= 1e-3, f"eval logits off by {err}")

        lines = []

        class Grab(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        trained = []
        cfg_path = os.path.join(work, "cora.cfg")
        for epochs in (5, 10):
            with open(cfg_path, "w") as fh:
                fh.write(
                    f"ALGORITHM:GCNCPU\nVERTICES:2708\nLAYERS:1433-16-7\nEPOCHS:{epochs}\n"
                    f"EDGE_FILE:{fix}/cora.2708.edge.self\nLABEL_FILE:{fix}/cora.labeltable\n"
                    f"MASK_FILE:{fix}/cora.mask\nDECAY_EPOCH:-1\nDROP_RATE:0.5\n"
                    f"OPTIM_KERNEL:1\nCHECKPOINT_DIR:{work}/cli\n"
                )
            lines.clear()
            grab = Grab()
            logging.getLogger("nts_torch").addHandler(grab)
            try:
                os.environ["NTS_PALLAS_RESIDENT"] = "0"
                rc = run.main([cfg_path, "--device", dev.type])
            finally:
                logging.getLogger("nts_torch").removeHandler(grab)
            trained.append([int(ln.split()[1]) for ln in lines
                            if ln.startswith("Epoch ") and " loss " in ln])
            if rc != 0:
                raise AssertionError(f"phase 11 (e): Cora CLI EPOCHS:{epochs} returned {rc}")
        resumed = [ln for ln in lines if ln.startswith("restored checkpoint at epoch 5")]
        log(f"(e) Cora CLI with CHECKPOINT_DIR: EPOCHS:5 trained {trained[0]}, then "
            f"EPOCHS:10 logged {resumed[:1]} and trained {trained[1]}")
        check("(e) CLI resume", trained == [list(range(5)), list(range(5, 10))]
              and len(resumed) == 1 and "RECOVERY resume {'epoch': 5}" in lines,
              f"trained {trained}, resume lines {resumed}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

# phase 12: the first-epoch loss of the device and fused modes against the
# sync mode's. The modes draw other neighbourhoods (pre-thinning at D=512
# changes the distribution above degree 512; fused also shuffles on the
# device, so its batches hold other seeds), and the gap a different draw
# makes is of the order of JAX's own fused-vs-sync pin (0.08 on its test
# graph); 0.05 absolute.
SAMPLED_LOSS_ATOL = 0.05
# phase 12: each mode's train accuracy after 3 epochs against sync's. The
# planted labels are learnable, so every mode climbs far above 1/41; the
# modes' different draws move the 48-step trajectory, and over 7,765
# training vertices one point of accuracy is 78 of them. 0.05 absolute.
SAMPLED_ACC_ATOL = 0.05
SAMPLED_DEGREE = 50  # graph/prep.py's Reddit mean degree
SAMPLED_EPOCHS = 3


def phase_sampled(dev, g, seed: int, results) -> None:
    """Phase 12: the sampled trainer (GCNSAMPLE) at 602-128-41 bf16,
    BATCH_SIZE 512, FANOUT 25-10, DROP_RATE 0, on a planted-label graph at
    phase 4's V, the trainers' own accuracy pass off (NTS_FINAL_EVAL=0;
    the train accuracy is taken once per mode). Every mode trains
    SAMPLED_EPOCHS: (a) sync; (b) pipelined, with 4 sampling threads;
    (c) device; (d) fused, twice, then its per-batch step time, one
    profiled epoch, and one batch's subgraph on the card against the CPU;
    (e) the two Cora sampled smoke cfgs through the CLI. Every mode's loss
    must fall each epoch and its train accuracy sit within
    SAMPLED_ACC_ATOL of sync's. Every run must leave both kernels' launch
    counts at 0. A failed check prints FAILED and fails the run at the end
    of the phase."""
    import numpy as np
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import planted_partition_graph
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
    from neutronstarlite_torch.sample import fused as t_fused
    from neutronstarlite_torch.utils.config import InputInfo

    t0 = time.perf_counter()
    src, dst, feature, label = planted_partition_graph(
        g.v_num, 41, avg_degree=SAMPLED_DEGREE, feature_size=602, seed=seed)
    datum = GNNDatum(feature=feature, label=label,
                     mask=(np.arange(g.v_num) % 3).astype(np.int32))
    g = build_graph(src, dst, g.v_num)
    log(f"phase 12 planted-partition graph V={g.v_num} E={g.e_num} (mean degree "
        f"{SAMPLED_DEGREE}, 41 planted classes, 602-wide features): host generate+build "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 12 on {smi}")
    failures = []

    def check(name, ok, detail):
        if not ok:
            failures.append(f"phase 12 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    saved_env = {k: os.environ.get(k) for k in (
        "NTS_FINAL_EVAL", "NTS_SAMPLE_WORKERS", "NTS_SAMPLE_CTX", "NTS_SAMPLE_PIPELINE")}
    os.environ["NTS_FINAL_EVAL"] = "0"
    os.environ.pop("NTS_SAMPLE_PIPELINE", None)
    os.environ.pop("NTS_SAMPLE_CTX", None)

    def trainer(mode, epochs):
        cfg = InputInfo(
            algorithm="GCNSAMPLE", vertices=g.v_num, layer_string="602-128-41",
            precision="bfloat16", batch_size=512, fanout_string="25-10", epochs=epochs,
            drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
            decay_epoch=100, sample_pipeline=mode,
        )
        t0 = time.perf_counter()
        tr = GCNSampleTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                          host_graph=g)
        return tr, time.perf_counter() - t0

    accs = {}

    def drive(tr, name):
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        tr.run()
        torch.cuda.synchronize()
        check_no_kernel(f"phase 12 {name}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = tr.loss_history
        check(f"{name} finite", all(math.isfinite(x) for x in losses), f"losses {losses}")
        check(f"{name} loss falls", all(b < a for a, b in zip(losses, losses[1:])),
              f"losses {losses}")
        if name not in accs:
            te = time.perf_counter()
            accs[name] = tr._evaluate(0)
            log(f"({name}) train accuracy {accs[name]:.4f} after {len(losses)} epochs "
                f"(sync-sampler pass, {time.perf_counter() - te:.1f} s)")
        stages = "; ".join(
            f"epoch {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in st.items())
            for i, st in enumerate(tr.stage_history))
        log(f"({name}) losses {[round(x, 6) for x in tr.loss_history]}; epochs (s) "
            f"{[round(t, 4) for t in tr.epoch_times]}; {tr.counts['sample.batches']} batches; "
            f"stage split (s) {stages}; counts {tr.counts}; peak device memory "
            f"{peak:.2f} GiB; ell_level and bsp_ell launches 0")
        return peak

    def params_equal(a, b):
        return all(torch.equal(p, q) for p, q in zip(a.flat_params, b.flat_params))

    try:
        # (a) sync, inline sampling
        os.environ["NTS_SAMPLE_WORKERS"] = "0"
        sync, build_s = trainer("sync", SAMPLED_EPOCHS)
        drive(sync, "a sync")
        n_batches = sync.counts["sample.batches"] // SAMPLED_EPOCHS
        wait = sync.stage_history[0]["sample_wait"]
        log(f"(a) sync: {n_batches} batches per epoch, epoch 0 {sync.epoch_times[0]:.3f} s, "
            f"sample_wait {wait:.3f} s = {wait / sync.epoch_times[0]:.1%} of the epoch "
            f"(host-bound share); trainer build {build_s:.1f} s")

        # (b) pipelined, 4 workers: with the native sampler they are threads
        # of this process (a fork after the CUDA context exists is refused)
        os.environ["NTS_SAMPLE_WORKERS"] = "4"
        pipe, build_s = trainer("pipelined", SAMPLED_EPOCHS)
        pool = pipe.par_sampler.ctx_method
        drive(pipe, "b pipelined")
        os.environ["NTS_SAMPLE_WORKERS"] = "0"
        bitwise = pipe.loss_history == sync.loss_history and params_equal(pipe, sync)
        pwait = pipe.stage_history[0]["sample_wait"]
        check("b pipelined workers are threads", pool == "thread", f"ctx {pool}")
        later = (np.mean(pipe.epoch_times[1:]), np.mean(sync.epoch_times[1:]))
        log(f"(b) pipelined ({pipe.sample_workers} {pool} workers, build {build_s:.1f} s): "
            f"epoch {pipe.epoch_times[0]:.3f} s vs sync {sync.epoch_times[0]:.3f} s, later "
            f"epochs {later[0]:.3f} s vs {later[1]:.3f}; "
            f"sample_wait {pwait:.3f} s vs sync {wait:.3f} s; losses and parameters bitwise "
            f"equal to sync: {bitwise}")
        if not bitwise:
            again, _ = trainer("sync", SAMPLED_EPOCHS)
            drive(again, "a' second sync")
            spread = abs(again.loss_history[0] - sync.loss_history[0])
            gap = abs(pipe.loss_history[0] - sync.loss_history[0])
            log(f"(b) not bitwise: pipelined {gap:.3e} from sync, two sync runs {spread:.3e}")
            check("b pipelined vs sync spread", gap <= spread,
                  f"pipelined {gap} from sync, outside two sync runs' spread {spread}")
            del again
        del pipe

        ref_loss = sync.loss_history[0]
        # (c) device, 3 epochs
        devm, build_s = trainer("device", SAMPLED_EPOCHS)
        peak = drive(devm, "c device")
        gap = abs(devm.loss_history[0] - ref_loss)
        check("c device first-epoch loss", gap <= SAMPLED_LOSS_ATOL,
              f"{devm.loss_history[0]} vs sync {ref_loss}")
        log(f"(c) device: table [{g.v_num}, {devm.par_sampler.hop_sampler.width}], "
            f"{devm.par_sampler.hop_sampler.thinned} pre-thinned vertices, build {build_s:.1f} s; "
            f"epoch-0 loss {devm.loss_history[0]:.6f} vs sync {ref_loss:.6f} (|d| {gap:.4f}, "
            f"atol {SAMPLED_LOSS_ATOL}); epochs (s) {[round(t, 4) for t in devm.epoch_times]}; "
            f"peak {peak:.2f} GiB")
        del devm

        # (d) fused, 3 epochs, twice
        fused = []
        for _ in range(2):
            tr, build_s = trainer("fused", SAMPLED_EPOCHS)
            peak = drive(tr, "d fused")
            fused.append((tr, peak, build_s))
        tr, peak, build_s = fused[0]
        runner = tr._fused
        check("d one capture", runner.captures == 1, f"{runner.captures} captures")
        check("d replays", runner.replays == SAMPLED_EPOCHS * runner.n_batches,
              f"{runner.replays} replays for {runner.n_batches} batches x 3 epochs")
        check("d h2d bytes", tr.counts["sample.h2d_bytes"] == 0, tr.counts)
        results["fused_counts"] = tr.counts
        again = fused[1][0]
        rerun = again.loss_history == tr.loss_history and params_equal(again, tr)
        check("d rerun bitwise", rerun, f"{tr.loss_history} vs {again.loss_history}")
        gap = abs(tr.loss_history[0] - ref_loss)
        check("d fused first-epoch loss", gap <= SAMPLED_LOSS_ATOL,
              f"{tr.loss_history[0]} vs sync {ref_loss}")
        log(f"(d) fused: {runner.captures} capture, {runner.replays} replays "
            f"({runner.n_batches} per epoch), sample.h2d_bytes {tr.counts['sample.h2d_bytes']}; "
            f"rerun bitwise {rerun}; epoch-0 loss {tr.loss_history[0]:.6f} vs sync "
            f"{ref_loss:.6f} (|d| {gap:.4f}); epochs (s) "
            f"{[round(t, 4) for t in tr.epoch_times]} (rerun "
            f"{[round(t, 4) for t in again.epoch_times]}); peak {peak:.2f} GiB; build "
            f"{build_s:.1f} s")
        del again, fused
        ref_acc = accs["a sync"]
        for name, acc in accs.items():
            check(f"{name} train accuracy", abs(acc - ref_acc) <= SAMPLED_ACC_ATOL,
                  f"{acc:.4f} vs sync {ref_acc:.4f} (atol {SAMPLED_ACC_ATOL})")
        log(f"train accuracy after {SAMPLED_EPOCHS} epochs per mode (sync {ref_acc:.4f}, atol "
            f"{SAMPLED_ACC_ATOL}; chance 1/41 = {1 / 41:.4f}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in accs.items()))
        # per-batch step time: CUDA events around one epoch's replays
        zero_launches()
        runner.run_epoch(3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        steps = []
        for epoch in (4, 5):
            runner.epoch_t.fill_(epoch)
            runner.batch_t.zero_()
            runner._shuffle()
            start.record()
            for _ in range(runner.n_batches):
                runner.graph.replay()
            end.record()
            torch.cuda.synchronize()
            steps.append(start.elapsed_time(end) / runner.n_batches)
        prof = profile_step(lambda: runner.run_epoch(6))
        check_no_kernel("phase 12 fused timing")
        check("d profiled H2D copies", prof.get("h2d", 0) == 0,
              f"{prof.get('h2d')} host-to-device copies in a fused epoch")
        log(f"(d) fused step {[round(x, 4) for x in steps]} ms per batch (CUDA events over "
            f"{runner.n_batches} replays); one profiled epoch: {profile_text(prof)}; "
            f"host-to-device copies in it: {prof.get('h2d', 'not measured')}")
        # one batch's subgraph, card against CPU, on the trainer's tables
        cpu_tables = [t.cpu() for t in (runner.nbr, runner.eff_deg, runner.out_deg,
                                        runner.in_deg)]
        seeds = runner.seeds_mat[0]
        key = t_fused.fold(runner.seed, 3, 0, t_fused.DRAW_TAG)
        got = t_fused.fused_sample_subgraph(runner.nbr, runner.eff_deg, runner.out_deg,
                                            runner.in_deg, seeds, 512, key,
                                            runner.node_caps, runner.fanouts)
        want = t_fused.fused_sample_subgraph(*cpu_tables, seeds.cpu(), 512, key,
                                             runner.node_caps, runner.fanouts)
        flat = lambda sub: list(sub[0]) + [t for hop in sub[1] for t in hop]
        same = all(torch.equal(a.cpu(), b) for a, b in zip(flat(got), flat(want)))
        check("d subgraph card vs CPU", same, "a fused subgraph differs")
        log(f"(d) one batch's fused subgraph on the card bitwise equal to the CPU's: {same} "
            f"(nodes {[int((n != 0).sum()) for n in want[0]]} non-zero ids per layer)")
        del tr, runner
        torch.cuda.empty_cache()

        # (e) the Cora sampled smoke cfgs through the CLI on the card
        os.environ.pop("NTS_FINAL_EVAL", None)
        os.environ.pop("NTS_SAMPLE_WORKERS", None)
        for name in ("gcn_sample_pipeline_smoke", "gcn_sample_fused_smoke"):
            lines = []

            class Grab(logging.Handler):
                def emit(self, record):
                    lines.append(record.getMessage())

            grab = Grab()
            logging.getLogger("nts_torch").addHandler(grab)
            zero_launches()
            try:
                rc = run.main([os.path.join(REPO, "configs", f"{name}.cfg"), "--device",
                               dev.type])
            finally:
                logging.getLogger("nts_torch").removeHandler(grab)
            check_no_kernel(f"phase 12 CLI {name}")
            acc = [ln for ln in lines if ln.startswith(("Train Acc:", "Eval Acc:", "Test Acc:"))]
            check(f"e CLI {name}", rc == 0 and len(acc) == 3, f"rc {rc}, {acc}")
            log(f"(e) CLI {name} on {dev}: rc {rc}, {'; '.join(acc)}")
    finally:
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    if failures:
        raise AssertionError("; ".join(failures))


# phase 13: the obs plane on the card. Every run is GCN 602-128-41 bf16 on
# phase 4's graph with DROP_RATE 0; the streams go to a temporary directory
OBS_EPOCHS = 5
OBS_LAYER_NAMES = {"params/l0", "params/l1", "grads/l0", "grads/l1", "acts/l0", "acts/l1",
                   "logits", "grads/global"}


def read_stream(d: str) -> list:
    import glob

    files = sorted(glob.glob(os.path.join(d, "*.jsonl")))
    if len(files) != 1:
        raise AssertionError(f"expected one metrics stream under {d}, found {files}")
    with open(files[0]) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def keep(results, name: str, *paths) -> None:
    """Copy files or directories a phase made into the run's kept directory
    (``results["kept"]``, which phase 22 reads), before the phase removes
    its own work directory. Without a kept directory (a phase driven alone)
    nothing is copied."""
    if "kept" not in results:
        return
    dst = os.path.join(results["kept"], name)
    os.makedirs(dst, exist_ok=True)
    for p in paths:
        if os.path.isdir(p):
            shutil.copytree(p, os.path.join(dst, os.path.basename(p)), dirs_exist_ok=True)
        elif os.path.exists(p):
            shutil.copy2(p, dst)


def span_tree(recs) -> list:
    spans = [r for r in recs if r["event"] == "span"]
    names = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], names.get(s["parent_id"])) for s in spans]


def steady_ms(times) -> float:
    warm = sorted(times[1:])
    return 1e3 * warm[len(warm) // 2]


def phase_obs(dev, g, seed: int, results) -> None:
    """Phase 13: the obs plane (metrics stream, run_summary, spans, numerics,
    program cost, ledger, profiler trace) on the card, at phase 4's graph
    and widths. (a) GCN bf16 on the ELL route, OBS_EPOCHS epochs without a
    sink, with obs at its defaults (NTS_METRICS_DIR, NTS_LEDGER_DIR), with
    NTS_NUMERICS=1 and with NTS_TRACE_STEP=1: the losses bitwise equal, the
    records valid, the span tree, tensor_stats, program_cost of the step and
    of each (tables, width) kernel pair equal to the bound formula, one
    ledger row, the run_summary's peak memory equal to
    max_memory_allocated; the profiler's count of library kernels of one
    step without a sink, with the defaults and with numerics, and the ELL
    launches per step; the steady epochs beside phase 4's and the host time of the
    per-epoch obs bookkeeping. (b) NTS_FAULT_SPEC=nan_loss@epoch=1,layer=1
    under supervised_run: a nonfinite_provenance record names layer 1. (c)
    the sampled trainer, fused, 3 epochs with and without NTS_NUMERICS=1:
    the losses bitwise equal, the stats from the captured graph, 0 H2D
    copies in a profiled epoch, the sample counters equal to phase 12's.
    (d) NTS_PROFILE_DIR over the ELL and bsp routes: the Chrome traces hold
    the tracer's record_function scopes and both kernels' names; the bsp
    kernel's program_cost records equal the bound formula. A failed
    check prints FAILED and fails the run at the end of the phase."""
    import numpy as np
    import torch

    from neutronstarlite_torch.models.gcn import GCNTrainer
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
    from neutronstarlite_torch.obs import cost, ledger, schema
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.resilience import events, faults
    from neutronstarlite_torch.resilience.supervisor import supervised_run
    from neutronstarlite_torch.utils.config import InputInfo

    t_phase = time.perf_counter()
    src, dst = results["edges"]
    datum = results["datum"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 13 on {smi}")
    failures = []

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"phase 13 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    env_keys = ("NTS_METRICS_DIR", "NTS_LEDGER_DIR", "NTS_PROFILE_DIR", "NTS_NUMERICS",
                "NTS_TRACE_STEP", "NTS_FAULT_SPEC", "NTS_BACKOFF_BASE_S", "NTS_PALLAS_RESIDENT",
                "NTS_FINAL_EVAL", "NTS_SAMPLE_WORKERS", "NTS_SAMPLE_PIPELINE")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    work = tempfile.mkdtemp(prefix="nts-obs-")

    def set_env(**kw):
        for k in env_keys:
            os.environ.pop(k, None)
        os.environ["NTS_FINAL_EVAL"] = "0"
        for k, v in kw.items():
            os.environ[k] = str(v)

    def gcn(route, epochs, **kw):
        cfg = InputInfo(
            algorithm="GCN", vertices=g.v_num, layer_string="602-128-41", epochs=epochs,
            drop_rate=0.0, precision="bfloat16", learn_rate=0.01, weight_decay=1e-4,
            decay_rate=0.97, decay_epoch=100, optim_kernel=True, pallas_kernel=True, **kw,
        )
        os.environ["NTS_PALLAS_RESIDENT"] = "1" if route == "ell" else "0"
        return GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev, host_graph=g)

    def obs_host_ms(tr):
        """Wrap the trainer's per-epoch obs bookkeeping with a host clock:
        emit_epoch (the records, the histogram, the spans, the guards) and
        maybe_emit_numerics (the stats' fetch and records); both run
        outside the timed epoch."""
        spent = {"emit_epoch": [], "numerics": []}
        for name, key in (("emit_epoch", "emit_epoch"), ("maybe_emit_numerics", "numerics")):
            fn = getattr(tr, name)

            def timed(*a, fn=fn, key=key, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                spent[key].append(time.perf_counter() - t0)
                return out

            setattr(tr, name, timed)
        return spent

    def validate(name, recs):
        try:
            for r in recs:
                schema.validate_event(r)
        except ValueError as e:
            check(f"{name} schema", False, str(e))

    try:
        # (a) the ELL route: no sink, defaults, numerics, trace step
        runs = {}
        for name, env in (("no sink", {}),
                          ("defaults", {"NTS_METRICS_DIR": f"{work}/a-defaults",
                                        "NTS_LEDGER_DIR": f"{work}/ledger"}),
                          ("numerics", {"NTS_METRICS_DIR": f"{work}/a-numerics",
                                        "NTS_NUMERICS": 1}),
                          ("trace step", {"NTS_METRICS_DIR": f"{work}/a-trace",
                                          "NTS_TRACE_STEP": 1})):
            set_env(**env)
            tr = gcn("ell", OBS_EPOCHS)
            spent = obs_host_ms(tr)
            zero_launches()
            tr.run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            runs[name] = {"tr": tr, "obs_ms": {k: 1e3 * float(np.median(v[1:])) if len(v) > 1
                                               else 0.0 for k, v in spent.items()},
                          "launches": kernel_launches()["ell_level"], "peak": peak,
                          "dir": env.get("NTS_METRICS_DIR")}
        base = runs["defaults"]["tr"].loss_history
        for name in ("no sink", "numerics", "trace step"):
            got = runs[name]["tr"].loss_history
            check(f"(a) {name} losses bitwise", got == base, f"{got} vs {base}")
        recs = read_stream(runs["defaults"]["dir"])
        validate("(a) defaults", recs)
        kinds = [r["event"] for r in recs]
        summary = recs[-1]
        check("(a) stream shape", kinds[0] == "run_start" and kinds.count("epoch") == OBS_EPOCHS
              and summary["event"] == "run_summary" and "tensor_stats" not in kinds, kinds)
        tree = span_tree(recs)
        check("(a) span tree", ("epoch", "run") in tree and ("step_dispatch", "epoch") in tree
              and ("step_device", "epoch") in tree and tree[-1] == ("run", None), tree)
        costs = {r["label"]: r for r in recs if r["event"] == "program_cost"}
        step = costs.get("fullbatch.train_step/GCNTrainer")
        check("(a) step program_cost", step is not None and step["flops"] > 0
              and (step["memory"] or {}).get("peak_bytes", 0) > 0, step)
        pairs = [("fwd", 602), ("fwd", 128), ("bwd", 128)]
        for direction, f in pairs:
            rec = costs.get(f"kernel.ell_level/{direction}/f{f}/bfloat16")
            want = cost.aggregation_cost(g.e_num, g.v_num, f, 2)
            check(f"(a) kernel program_cost {direction} f={f}",
                  rec is not None and (rec["flops"], rec["bytes_accessed"]) == want,
                  f"{rec} vs the bound formula {want}")
        mem = summary["memory"]
        check("(a) run_summary peak memory", mem["peak_bytes_in_use"] == runs["defaults"]["peak"],
              f"{mem} vs max_memory_allocated {runs['defaults']['peak']}")
        rows = ledger.read_rows(f"{work}/ledger")
        check("(a) one ledger row", len(rows) == 1 and rows[0]["kind"] == "run", rows)
        nrecs = read_stream(runs["numerics"]["dir"])
        validate("(a) numerics", nrecs)
        stats = [r for r in nrecs if r["event"] == "tensor_stats"]
        check("(a) tensor_stats", {r["name"] for r in stats} == OBS_LAYER_NAMES
              and len(stats) == OBS_EPOCHS * len(OBS_LAYER_NAMES)
              and all(r["finite_fraction"] == 1.0 for r in stats),
              sorted({r["name"] for r in stats}))
        trecs = read_stream(runs["trace step"]["dir"])
        validate("(a) trace step", trecs)
        tstages = [list(r["stages"]) for r in trecs if r["event"] == "epoch"]
        check("(a) trace-step stages", all(s == ["forward_backward", "optim"] for s in tstages),
              tstages)
        # the kernels and the ELL launches of one step with numerics off (no
        # sink, defaults) and on
        variants = ("no sink", "defaults", "numerics")
        kernels, launches, profs, counts = {}, {}, {}, {n: {} for n in variants}
        for name in variants:
            tr = runs[name]["tr"]
            zero_launches()
            tr._epoch_step(False)
            torch.cuda.synchronize()
            launches[name] = kernel_launches()["ell_level"]
        # CUPTI drops records at times (once all but the last 10 of a step's
        # 126 kernels) and never adds one, so each kernel name counts the
        # most that any of up to three traces of the same step caught;
        # library kernels are those counts less the hand-written ones (held
        # by the launch counters instead)
        for _ in range(3):
            for name in variants:
                p = profile_step(lambda tr=runs[name]["tr"]: tr._epoch_step(False))
                profs.setdefault(name, p)
                for k, c in (p.get("counts") or {}).items():
                    counts[name][k] = max(counts[name].get(k, 0), c)
            kernels = {n: sum(counts[n].values()) for n in variants}
            library = {n: sum(c for k, c in counts[n].items()
                              if not any(o in k for o in OWN_KERNELS)) for n in variants}
            if library["no sink"] == library["defaults"] < library["numerics"]:
                break
        check("(a) no extra kernels without numerics", library["no sink"] == library["defaults"]
              and launches["no sink"] == launches["defaults"] == launches["numerics"],
              f"library kernels {library} (traced {kernels}), ELL launches {launches}; "
              f"names counted apart: "
              f"{kernel_name_diff({'counts': counts['no sink']}, {'counts': counts['defaults']})}")
        check("(a) numerics adds its reductions", library["numerics"] > library["defaults"],
              library)
        p4 = steady_ms(results["ell"]["epoch_times"])
        ms = {name: steady_ms(runs[name]["tr"].epoch_times) for name in runs}
        log(f"(a) ELL {OBS_EPOCHS} epochs, losses bitwise across the four runs: "
            f"{all(runs[n]['tr'].loss_history == base for n in runs)}; steady epoch (ms, host "
            f"clock, synchronised): phase 4 {p4:.3f}, no sink {ms['no sink']:.3f}, defaults "
            f"{ms['defaults']:.3f}, numerics {ms['numerics']:.3f}, trace step "
            f"{ms['trace step']:.3f}; per-epoch obs bookkeeping outside the timed interval "
            f"(ms, median of epochs 1-4): " + ", ".join(
                f"{n} emit_epoch {runs[n]['obs_ms']['emit_epoch']:.3f} + numerics "
                f"{runs[n]['obs_ms']['numerics']:.3f}" for n in runs))
        log("(a) one profiled step (host wall / device busy ms, idle share): " + "; ".join(
            f"{n} {p.get('wall_ms', float('nan')):.3f} / {p.get('busy_ms', float('nan')):.3f}, "
            f"{p.get('idle_share', float('nan')):.3f}" for n, p in profs.items()))
        log(f"(a) the numerics step under the profiler: {profile_text(profs['numerics'])}")
        step = step or {}
        rise = (step.get("memory") or {}).get("peak_bytes")
        log(f"(a) kernels in one profiled step: {kernels} (library kernels {library}); ELL "
            f"launches per step {launches}; "
            f"{len(recs)} records, {kinds.count('span')} spans; program_cost: step flops "
            f"{step.get('flops')} (kernels {step.get('kernel_flops')}), memory rise "
            f"{rise} bytes; kernels "
            + "; ".join(f"{lab} flops {r['flops']:.4g} bytes {r['bytes_accessed']:.4g} "
                        f"x{r['calls_per_step']}" for lab, r in costs.items()
                        if lab.startswith("kernel."))
            + f"; run_summary peak {mem['peak_bytes_in_use']} bytes; ledger rows "
            f"{len(rows)}; tensor_stats records {len(stats)}")
        for name in list(runs):
            runs[name].pop("tr")
        torch.cuda.empty_cache()

        # (b) provenance under nan_loss@epoch=1,layer=1
        set_env(NTS_METRICS_DIR=f"{work}/b", NTS_FAULT_SPEC="nan_loss@epoch=1,layer=1",
                NTS_BACKOFF_BASE_S=0)
        faults.reset()
        events.set_sink(None)
        tr = gcn("ell", 3, checkpoint_dir=f"{work}/b-ck", checkpoint_every=1)
        zero_launches()
        supervised_run(tr)
        torch.cuda.synchronize()
        faults.reset()
        brecs = read_stream(f"{work}/b")
        validate("(b)", brecs)
        prov = [r for r in brecs if r["event"] == "nonfinite_provenance"]
        seq = [(r["event"], r.get("kind") or r.get("action")) for r in brecs
               if r["event"] in ("fault", "recovery")]
        check("(b) provenance names layer 1", len(prov) == 1 and prov[0]["layer"] == 1
              and prov[0]["op"] == "activation" and prov[0]["injected"] is True, prov)
        check("(b) fault and rollback", seq == [("fault", "nonfinite_loss"),
                                                ("recovery", "rollback")], seq)
        log(f"(b) provenance: {prov[0] if prov else None}; records {seq}; losses "
            f"{tr.loss_history}; ELL launches {kernel_launches()['ell_level']}")
        del tr

        # (c) fused sampled, 3 epochs with and without numerics
        fused = {}
        for name, env in (("plain", {"NTS_METRICS_DIR": f"{work}/c-plain"}),
                          ("numerics", {"NTS_METRICS_DIR": f"{work}/c-num",
                                        "NTS_NUMERICS": 1})):
            set_env(NTS_SAMPLE_WORKERS=0, **env)
            cfg = InputInfo(
                algorithm="GCNSAMPLE", vertices=g.v_num, layer_string="602-128-41",
                precision="bfloat16", batch_size=512, fanout_string="25-10", epochs=3,
                drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
                decay_epoch=100, sample_pipeline="fused",
            )
            tr = GCNSampleTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                              host_graph=g)
            zero_launches()
            tr.run()
            torch.cuda.synchronize()
            check_no_kernel(f"phase 13 (c) {name}")
            fused[name] = tr
        a, b = fused["plain"], fused["numerics"]
        runner = b._fused
        same = a.loss_history == b.loss_history and all(
            torch.equal(p, q) for p, q in zip(a.flat_params, b.flat_params))
        check("(c) numerics bitwise", same, f"{a.loss_history} vs {b.loss_history}")
        crecs = read_stream(f"{work}/c-num")
        validate("(c)", crecs)
        cstats = [r for r in crecs if r["event"] == "tensor_stats"]
        check("(c) stats from the captured graph", runner.captures == 1
              and runner.replays == 3 * runner.n_batches and runner.stats is not None
              and {r["name"] for r in cstats} == {"params/l0", "params/l1", "grads/l0",
                                                  "grads/l1", "grads/global"}
              and len(cstats) == 3 * 5, f"captures {runner.captures}, replays "
              f"{runner.replays}, {len(cstats)} tensor_stats")
        prof = profile_step(lambda: runner.run_epoch(3))
        check("(c) no H2D copies", prof.get("h2d", 0) == 0, prof.get("h2d"))
        want = results.get("fused_counts")
        check("(c) sample counters equal phase 12's", b.counts == want == a.counts,
              f"{b.counts} vs phase 12 {want}")
        scans = [r for r in crecs if r["event"] == "epoch_scan"]
        log(f"(c) fused, 3 epochs: losses bitwise with and without numerics {same}; "
            f"{runner.captures} capture, {runner.replays} replays; epochs (s) plain "
            f"{[round(t, 4) for t in a.epoch_times]}, numerics "
            f"{[round(t, 4) for t in b.epoch_times]}; {len(cstats)} tensor_stats; "
            f"{len(scans)} epoch_scan; counters {b.counts} (phase 12 {want}); one profiled "
            f"epoch: {prof.get('kernels')} kernels, H2D copies {prof.get('h2d', 'not measured')}")
        del fused, a, b, runner
        torch.cuda.empty_cache()

        # (d) the profiler traces of the ELL and bsp routes, and the bsp
        # kernel's program_cost records
        for route in ("ell", "bsp"):
            set_env(NTS_METRICS_DIR=f"{work}/d-{route}", NTS_PROFILE_DIR=f"{work}/prof")
            gcn(route, 3).run()
        torch.cuda.synchronize()
        drecs = read_stream(f"{work}/d-bsp")
        validate("(d) bsp", drecs)
        dcosts = {r["label"]: r for r in drecs if r["event"] == "program_cost"}
        for direction, f in pairs:
            rec = dcosts.get(f"kernel.bsp_ell/{direction}/f{f}/bfloat16")
            want = cost.aggregation_cost(g.e_num, g.v_num, f, 2)
            check(f"(d) bsp program_cost {direction} f={f}",
                  rec is not None and (rec["flops"], rec["bytes_accessed"]) == want,
                  f"{rec} vs the bound formula {want}")
        import glob

        names = set()
        traces = sorted(glob.glob(f"{work}/prof/GCNTrainer/*.json"))
        for path in traces:
            with open(path) as fh:
                names |= {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
        scopes = {"epoch", "step_dispatch", "step_device"} <= names
        ell_k = any("ell_work_kernel" in n for n in names)
        bsp_k = any("bsp_ell_kernel" in n for n in names)
        check("(d) trace scopes and kernels", len(traces) == 2 and scopes and ell_k and bsp_k,
              f"{len(traces)} traces, scopes {scopes}, ell {ell_k}, bsp {bsp_k}")
        log(f"(d) {len(traces)} Chrome traces: tracer scopes {scopes}, ell_work_kernel "
            f"{ell_k}, bsp_ell_kernel {bsp_k}; {len(names)} distinct event names")
    finally:
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        events.set_sink(None)
        keep(results, "ledger13", f"{work}/ledger")
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))


# phase 14: online serving of the sampled GCN (phase 12's configuration,
# trained 2 fused epochs into a checkpoint) on phase 4's graph
SERVE_BUCKETS = (1, 4, 16, 64)
SERVE_CLIENTS = 8


def read_records(path: str) -> list:
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def phase_serving(dev, g, seed: int, results) -> None:
    """Phase 14: online serving (serve/, plain PyTorch, no kernel: both
    kernels' launch counts stay 0) of GCN 602-128-41 bf16, FANOUT 25-10,
    trained 2 epochs in the fused mode at BATCH_SIZE 512 on phase 4's graph
    with CHECKPOINT_DIR in a temporary directory, then served from that
    checkpoint with SERVE_BUCKETS 1-4-16-64, SERVE_MAX_BATCH 64,
    SERVE_MAX_WAIT_MS 2 and SERVE_MAX_QUEUE 1024; requests are single
    vertices drawn uniformly from V (numpy seed 0). (a) engines in the sync,
    device and fused modes: the restored step, one CUDA-graph capture per
    bucket and its seconds, each bucket's replay beside its eager forward
    (CUDA events, 20 after 3 warm-ups), peak memory; (b) per mode and
    bucket, served logits bitwise equal to the eager forward on the same
    operands (sync, device: the same SampledBatch; fused: the same seeds
    and key), and a warm clone against a cold engine from one seed, the
    same served sequence (sync, fused); (c) serve_bench closed loop with
    SERVE_CLIENTS clients: sync and pipelined 100 requests, device and
    fused 2,000, then fused open loop at 1,000 requests/s for 2,000: p50,
    p95, p99, throughput, sheds, mean flush size; then 300 device and 300
    fused requests under torch.profiler (device busy time, idle share, top
    kernels); (d) the cache
    (SERVE_CACHE_CAP 4096): 2,000 requests over 256 distinct vertices, the
    hits, and a cached row bitwise the row first served; (e) a fleet of 3
    replicas with SERVE_CB 1, fused, 2,000 requests with one injected
    replica death mid-load: no capture in the clones, the replica
    restarted, its in-flight requests re-routed, no error; (f)
    NTS_METRICS_PORT=0 over a fused leg: /metrics's serve latency
    histogram counts the served requests, /healthz answers 200, /slo
    parses; (g) configs/serve_cora_smoke.cfg trained through the CLI with
    CHECKPOINT_DIR, then served by ``python -m
    neutronstarlite_torch.serve.server`` on the card. A failed check
    prints FAILED and fails the run at the end."""
    import dataclasses
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from neutronstarlite_torch import obs
    from neutronstarlite_torch import run as run_cli
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer, batch_forward
    from neutronstarlite_torch.obs import exporter as obs_exporter
    from neutronstarlite_torch.serve.batcher import ServeOptions
    from neutronstarlite_torch.serve.engine import InferenceEngine, batch_device_arrays, unflatten
    from neutronstarlite_torch.serve.fleet import ReplicaSet
    from neutronstarlite_torch.serve.server import InferenceServer
    from neutronstarlite_torch.tools import serve_bench
    from neutronstarlite_torch.utils.config import InputInfo

    t_phase = time.perf_counter()
    src, dst = results["edges"]
    datum = results["datum"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 14 on {smi}")
    failures = []

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"phase 14 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    saved_env = {k: os.environ.get(k) for k in (
        "NTS_FINAL_EVAL", "NTS_SAMPLE_WORKERS", "NTS_SAMPLE_PIPELINE", "NTS_METRICS_DIR",
        "NTS_METRICS_PORT", "NTS_SLO_SPEC", "NTS_SERVE_HEARTBEAT_S", "NTS_HEARTBEAT_MISS_K")}
    for k in saved_env:
        os.environ.pop(k, None)
    os.environ["NTS_FINAL_EVAL"] = "0"
    os.environ["NTS_SAMPLE_WORKERS"] = "0"
    V = g.v_num
    want_counts = {b: 1 for b in SERVE_BUCKETS}
    try:
        ckpt = os.path.join(work, "ck")
        cfg = InputInfo(
            algorithm="GCNSAMPLE", vertices=V, layer_string="602-128-41",
            precision="bfloat16", batch_size=512, fanout_string="25-10", epochs=2,
            drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
            decay_epoch=100, sample_pipeline="fused", checkpoint_dir=ckpt,
            serve_buckets="1-4-16-64", serve_max_batch=64, serve_max_wait_ms=2.0,
            serve_max_queue=1024,
        )
        t0 = time.perf_counter()
        tr = GCNSampleTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                          host_graph=g)
        zero_launches()
        tr.run()
        torch.cuda.synchronize()
        check_no_kernel("phase 14 training")
        log(f"trained GCN 602-128-41 bf16 fused 2 epochs (losses "
            f"{[round(x, 6) for x in tr.loss_history]}) into a checkpoint in "
            f"{time.perf_counter() - t0:.1f} s (trainer build included)")
        # phase 21 serves the same model from its replica processes
        results["serve_ckpt"] = shutil.copytree(
            ckpt, os.path.join(tempfile.mkdtemp(prefix="chip_smoke_serve_ck_"), "ck"))
        base = ServeOptions.from_cfg(cfg)
        check("ladder", base.ladder() == list(SERVE_BUCKETS), f"{base.ladder()}")

        def opts(mode, **kw):
            return dataclasses.replace(base, sample_pipeline=mode, **kw)

        # (a) one engine per mode: captures, replay vs eager, memory
        engines = {}
        for mode in ("sync", "device", "fused"):
            zero_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eng = InferenceEngine(tr, ckpt, options=opts(mode), rng=np.random.default_rng(seed))
            cap_s = []
            for b in SERVE_BUCKETS:
                t0 = time.perf_counter()
                eng.warmup([b])
                torch.cuda.synchronize()
                cap_s.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check(f"(a) {mode} restored step", eng.ckpt_step == 2, f"step {eng.ckpt_step}")
            check(f"(a) {mode} one capture per bucket", eng.compile_counts == want_counts,
                  f"{eng.compile_counts}")
            times = []
            for b in SERVE_BUCKETS:
                entry = eng._fused_compiled[b][1] if mode == "fused" else eng._compiled[b]
                if entry.graph is None:
                    check(f"(a) {mode} bucket {b} is a CUDA graph", False, "no graph")
                    continue
                times.append((cuda_ms(entry.graph.replay),
                              cuda_ms(lambda: entry.run(entry.static))))
            check_no_kernel(f"phase 14 (a) {mode}")
            log(f"(a) {mode}: restored step {eng.ckpt_step}, captures {eng.compile_counts}; "
                + "; ".join(f"bucket {b} (caps {eng.sampler.node_caps(b)}): capture "
                            f"{c:.3f} s, replay {r:.4f} ms vs eager {e:.4f} ms"
                            for b, c, (r, e) in zip(SERVE_BUCKETS, cap_s, times))
                + f"; peak device memory {peak:.2f} GiB (CUDA events, 20 after 3)")
            engines[mode] = eng

        # (b) served logits against the eager forward on the same operands
        pick = np.random.default_rng(0)
        for mode, eng in engines.items():
            same = []
            for b in SERVE_BUCKETS:
                ids = pick.choice(V, size=b, replace=False)
                if mode == "fused":
                    key = int(pick.integers(0, 2 ** 31 - 1))
                    served = eng.execute_fused_prepared(eng.prepare_fused(ids, b, key=key), b)
                    buf = torch.from_numpy(np.concatenate([ids, [b, key]])).to(dev)
                    want = eng.fused_forward(buf, b)
                else:
                    batch = eng.sampler.sample(b, ids)
                    served = eng.forward_batch(batch, b)
                    arrays = [torch.from_numpy(a).to(dev) for a in batch_device_arrays(batch)]
                    with torch.no_grad():
                        want = batch_forward(eng.weights, eng.feature,
                                             *unflatten(arrays, len(eng.fanouts)),
                                             eng.sampler.node_caps(b), eng.compute_dtype)
                want = want.cpu().numpy()
                ok = served.shape == (b, 41) and bool(np.isfinite(served).all()) \
                    and np.array_equal(served, want)
                check(f"(b) {mode} bucket {b} served == eager", ok,
                      f"max |d| {float(np.abs(served - want).max()):.3e}")
                same.append(ok)
            log(f"(b) {mode}: served logits bitwise the eager forward on the same operands "
                f"for buckets {SERVE_BUCKETS}: {same}")
        for mode in ("sync", "fused"):
            warm = engines[mode].clone(rng=np.random.default_rng(seed + 7))
            cold = InferenceEngine(tr, ckpt, options=opts(mode),
                                   rng=np.random.default_rng(seed + 7))
            seq = np.random.default_rng(1)
            same = all(np.array_equal(warm.predict(ids), cold.predict(ids))
                       for ids in (seq.choice(V, size=n, replace=False)
                                   for n in (1, 3, 16, 64, 5)))
            check(f"(b) {mode} warm clone == cold engine", same)
            check(f"(b) {mode} cold engine captures", cold.compile_counts == want_counts,
                  f"{cold.compile_counts}")
            check(f"(b) {mode} warm clone captured nothing",
                  engines[mode].compile_counts == want_counts, f"{engines[mode].compile_counts}")
            log(f"(b) {mode}: a warm clone and a cold engine from one seed serve the same "
                f"5-request sequence: {same}; cold engine captures {cold.compile_counts}")
            del cold
        check_no_kernel("phase 14 (b)")

        # (c) serve_bench's load models over clones with their own streams
        # (a directory per leg: a stream's name has a one-second clock)
        def metrics_dir(tag):
            os.environ["NTS_METRICS_DIR"] = os.path.join(work, "metrics", tag)

        def leg(name, mode, requests, server_mode=None, load="closed", rps=200.0):
            metrics_dir(name.split()[1] + load)
            reg = obs.open_run("serve-leg", cfg=cfg, seed=seed)
            eng = engines[mode].clone(metrics=reg, rng=np.random.default_rng(seed))
            zero_launches()
            r = serve_bench.measure(eng, options=opts(server_mode or mode), mode=load, rps=rps,
                                    clients=SERVE_CLIENTS, requests=requests, seed=seed)
            check_no_kernel(f"phase 14 {name}")
            n = requests
            check(f"{name} served", (r["served"], r["shed"], r["errors"]) == (n, 0, 0),
                  f"served {r['served']}, shed {r['shed']}, errors {r['errors']}")
            check(f"{name} latency from the hist records", r["latency_source"] == "hist",
                  f"{r['latency_source']}")
            check(f"{name} no capture", engines[mode].compile_counts == want_counts,
                  f"{engines[mode].compile_counts}")
            log(f"{name}: p50 {r['p50_ms']:.3f} / p95 {r['p95_ms']:.3f} / p99 "
                f"{r['p99_ms']:.3f} ms, {r['throughput_rps']:.1f} requests/s, "
                f"{r['served']} served, {r['shed']} shed, {r['errors']} errors, "
                f"{r['batches']} flushes of {r['mean_flush_requests']:.2f} requests, "
                f"wall {r['wall_s']:.2f} s (host clock)")
            return r

        leg("(c) sync closed", "sync", 100)
        leg("(c) pipelined closed", "sync", 100, server_mode="pipelined")
        leg("(c) device closed", "device", 2000)
        results["serve_fused_closed"] = leg("(c) fused closed", "fused", 2000)
        leg("(c) fused open 1000/s", "fused", 2000, load="open", rps=1000.0)
        for mode in ("device", "fused"):  # where the time goes while serving
            server = InferenceServer(engines[mode].clone(rng=np.random.default_rng(seed)))
            prof = profile_step(lambda: serve_bench.run_closed_loop(
                server, V, 300, SERVE_CLIENTS, 1, seed))
            server.close()
            log(f"(c) {mode}, 300 closed-loop requests under torch.profiler: "
                f"{profile_text(prof)}")

        # (d) the embedding cache over 256 distinct vertices
        pool = np.random.default_rng(0).choice(V, size=256, replace=False)

        class PoolClient:
            def __init__(self, server):
                self.server = server

            def submit(self, ids):
                return self.server.submit(pool[np.asarray(ids)])

        metrics_dir("cache")
        reg = obs.open_run("serve-cache", cfg=cfg, seed=seed)
        server = InferenceServer(engines["fused"].clone(metrics=reg,
                                                        rng=np.random.default_rng(seed)),
                                 options=opts("fused", cache_cap=4096))
        zero_launches()
        first = {int(v): server.predict([v]) for v in pool[:8]}
        errors = serve_bench.run_closed_loop(PoolClient(server), len(pool), 2000, SERVE_CLIENTS,
                                             1, seed)
        again = [server.submit([v]) for v in first]
        rows_same = all(np.array_equal(r.result(timeout=60), first[v]) and r.status == "cached"
                        for r, v in zip(again, first))
        st = server.close()
        check_no_kernel("phase 14 (d)")
        cache = st["cache"]
        # each of the 256 misses once; a flush looks a repeated id up once
        check("(d) cache", errors == 0 and rows_same and cache["misses"] <= len(pool)
              and cache["hits"] >= 1000,
              f"errors {errors}, rows bitwise {rows_same}, {cache}")
        log(f"(d) cache (SERVE_CACHE_CAP 4096): {st['requests']} requests over 256 vertices, "
            f"{cache}; p50 {st['latency_ms']['p50']:.3f} / p99 {st['latency_ms']['p99']:.3f} ms; "
            f"a cached row bitwise the row first served: {rows_same}")

        # (e) a 3-replica fleet, continuous batching, one replica killed
        os.environ["NTS_SERVE_HEARTBEAT_S"] = "0.1"
        os.environ["NTS_HEARTBEAT_MISS_K"] = "1"
        metrics_dir("fleet")
        zero_launches()
        fleet = ReplicaSet.from_engine(engines["fused"], 3,
                                       options=opts("fused", continuous_batching=True),
                                       seed=seed)
        load = {}
        loader = threading.Thread(target=lambda: load.update(errors=serve_bench.run_closed_loop(
            fleet, V, 2000, SERVE_CLIENTS, 1, seed)), daemon=True)
        t0 = time.perf_counter()
        loader.start()

        def wait_for(cond, timeout=30.0):
            deadline = time.perf_counter() + timeout
            while not cond() and time.perf_counter() < deadline:
                time.sleep(0.005)
            return cond()

        served = lambda: sum(r.requests_total() for r in fleet.replicas)  # noqa: E731
        wait_for(lambda: served() >= 500)
        victim = fleet._sticky if fleet._sticky is not None else 0
        # kill while requests wait in its queue, so that some are in flight
        wait_for(lambda: fleet.replicas[victim].server.batcher.depth > 0, timeout=5.0)
        t_kill = time.perf_counter()
        fleet.inject_replica_death(victim)
        restarted = wait_for(lambda: fleet.replicas[victim].restarts == 1)
        restart_s = time.perf_counter() - t_kill
        loader.join(timeout=120)
        fst = fleet.close()
        check_no_kernel("phase 14 (e)")
        front = read_records(fleet.registry.path) if fleet.registry.path else []
        recov = [e for e in front if e["event"] == "recovery" and e.get("action") == "restart"]
        losses = [e for e in front if e["event"] == "rank_loss"]
        stolen = recov[0].get("stolen_requests") if recov else None
        check("(e) fleet", restarted and not loader.is_alive() and load.get("errors") == 0
              and fst["requests"] == 2000 and fst["shed"] == 0 and len(recov) == 1
              and len(losses) == 1, f"restarted {restarted}, load {load}, {fst['requests']} "
              f"served, {fst['shed']} shed, {len(recov)} restarts, {len(losses)} rank_loss")
        check("(e) no capture in the clones", engines["fused"].compile_counts == want_counts,
              f"{engines['fused'].compile_counts}")
        lat = fst["latency_ms"]
        results["serve_fleet_latency"] = lat
        log(f"(e) fleet of 3 (SERVE_CB 1, fused): replica r{victim} killed after "
            f"{t_kill - t0:.2f} s, restarted {restart_s:.2f} s later (heartbeat 0.1 s, miss_k 1), "
            f"{stolen} in-flight requests re-routed; {fst['requests']} served, {fst['shed']} "
            f"shed, {load.get('errors')} errors; merged p50 {lat['p50']:.3f} / p99 "
            f"{lat['p99']:.3f} ms; captures {engines['fused'].compile_counts}")
        os.environ.pop("NTS_SERVE_HEARTBEAT_S")
        os.environ.pop("NTS_HEARTBEAT_MISS_K")

        # (f) the live exporter over a fused leg
        os.environ["NTS_METRICS_PORT"] = "0"
        os.environ["NTS_SLO_SPEC"] = "serve_p99_ms<=1000@1m"
        metrics_dir("exporter")
        reg = obs.open_run("serve-exporter", cfg=cfg, seed=seed)
        server = InferenceServer(engines["fused"].clone(metrics=reg,
                                                        rng=np.random.default_rng(seed)))
        exp = server.exporter
        try:
            zero_launches()
            errors = serve_bench.run_closed_loop(server, V, 500, SERVE_CLIENTS, 1, seed)
            url = f"http://127.0.0.1:{exp.port}"

            def get(path):
                try:
                    with urllib.request.urlopen(url + path, timeout=30) as r:
                        return r.status, r.read().decode()
                except urllib.error.HTTPError as e:
                    return e.code, ""

            code_m, text = get("/metrics")
            count = [ln for ln in text.splitlines()
                     if ln.startswith("nts_serve_latency_ms_count")]
            counted = float(count[0].split()[-1]) if count else None
            code_h, health = get("/healthz")
            code_s, slo = get("/slo")
            slo_ok = code_s == 200 and isinstance(json.loads(slo), list)
            check("(f) exporter", errors == 0 and code_m == 200 and counted == 500
                  and code_h == 200 and json.loads(health)["ok"] and slo_ok,
                  f"errors {errors}, /metrics {code_m} count {counted}, /healthz {code_h}, "
                  f"/slo {code_s}")
            log(f"(f) NTS_METRICS_PORT=0 -> port {exp.port}: /metrics {code_m} "
                f"(nts_serve_latency_ms_count {counted} of 500 served), /healthz {code_h}, /slo "
                f"{code_s} ({len(json.loads(slo)) if slo_ok else 0} objective)")
        finally:
            server.close()
            exp.close()
            obs_exporter._singleton = None
            os.environ.pop("NTS_METRICS_PORT")
            os.environ.pop("NTS_SLO_SPEC")
        check_no_kernel("phase 14 (f)")

        # (g) the Cora serve smoke: the CLI trains, the serve CLI serves
        os.environ.pop("NTS_METRICS_DIR")
        os.environ.pop("NTS_FINAL_EVAL")
        with open(os.path.join(REPO, "configs", "serve_cora_smoke.cfg")) as fh:
            text = fh.read().replace("../tests", os.path.join(REPO, "tests"))
        cora = os.path.join(work, "serve_cora_smoke.cfg")
        with open(cora, "w") as fh:
            fh.write(text + f"CHECKPOINT_DIR:{os.path.join(work, 'cora_ck')}\n")
        zero_launches()
        rc = run_cli.main([cora, "--device", "cuda"])
        check_no_kernel("phase 14 (g) training")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "neutronstarlite_torch.serve.server", cora], cwd=REPO,
            capture_output=True, text=True, timeout=300,
        )
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("served ")]
        ok = rc == 0 and proc.returncode == 0 and bool(line) \
            and line[0].startswith("served 50 requests (shed 0, errors 0)") \
            and "CUDA graph" in proc.stdout + proc.stderr
        check("(g) serve CLI", ok, f"train rc {rc}, serve rc {proc.returncode}: "
              f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
        log(f"(g) Cora serve smoke: trained through the CLI (rc {rc}), then `python -m "
            f"neutronstarlite_torch.serve.server` on the card ({time.perf_counter() - t0:.1f} "
            f"s): {line[0] if line else proc.stdout[-300:]}")
    finally:
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    results["failures"].extend(failures)


# phase 15: the distributed trainers (GCNDIST and its family) on the sim
# twin. NCCL cannot put two ranks on one card, so PARTITIONS runs as the
# collective-free twin (NTS_DIST_SIMULATE=1): each shard's rectangular
# tables ([vp, P*vp]) run over the whole [P*vp, f] slab in turn.
DIST_P = 8
DIST_EPOCHS = 3
RING_EPOCHS = 2  # phase 16 (a)'s epochs per route
# (c): configs/gcn_reddit_full.cfg on the data-prep tool's Reddit (planted
# labels over 41 classes, mean degree 50). A model that learned nothing
# sits at 1/41 = 0.024; the planted classes are learnable (GCN 602-128-41
# f32 on the CPU at a tenth of the vertices reaches 1.0 in the cfg's 10
# epochs), and 0.5 leaves room for bf16 and dropout 0.5
NORTH_STAR_MIN_TEST_ACC = 0.5


def dist_shard_calls(tables, d, sizes):
    """(direction, f, shard, tables) of one standard-order training epoch's
    per-shard kernel calls: each layer's forward at its input width on
    every shard, and the backward of every layer but the first."""
    return [(direction, f, p, getattr(tables, direction)[p])
            for direction, f in epoch_calls(sizes) for p in range(d.partitions)]


def phase_dist(dev, g, seed: int, results) -> list:
    """Phase 15 (see the module docstring): (a) both kernels on every
    shard's rectangular tables, checked and timed; (b) GCNDIST 602-128-41
    bf16 at P=8 through the ELL, bsp, blocked and ring routes, and
    GCNEAGERDIST on the bsp route, against the single-device ELL route;
    (c) the data-prep tool and configs/gcn_reddit_full.cfg through the CLI;
    (d) the two distributed Reddit cfgs through the CLI on (c)'s data.
    Returns the {"kernels": ...} rows ell_level_dist and bsp_ell_dist."""
    import numpy as np
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.models.gcn import GCNEagerTrainer
    from neutronstarlite_torch.models.gcn_dist import DistGCNEagerTrainer, DistGCNTrainer
    from neutronstarlite_torch.obs.cost import aggregation_cost
    from neutronstarlite_torch.ops.bsp_ell import (
        DEFAULT_VT,
        bsp_aggregate,
        bsp_tables_aggregate,
    )
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.parallel.dist_bsp import build_dist_bsp
    from neutronstarlite_torch.parallel.dist_ell import build_dist_ell, per_device_adjacency
    from neutronstarlite_torch.parallel.dist_graph import DistGraph
    from neutronstarlite_torch.utils.config import InputInfo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 15 on {smi}")
    t_phase = time.perf_counter()
    failures = results["failures"]

    def check(name, ok, detail):
        if not ok:
            failures.append(f"phase 15 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    saved_env = {k: os.environ.get(k) for k in ("NTS_DIST_SIMULATE", "NTS_PALLAS_RESIDENT")}
    os.environ["NTS_DIST_SIMULATE"] = "1"
    os.environ.pop("NTS_PALLAS_RESIDENT", None)
    sizes = [602, 128, 41]
    prep = None
    try:
        # ---- (a) the kernels on every shard's rectangular tables ----------------
        t0 = time.perf_counter()
        d = DistGraph.build(g, DIST_P)
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        ell = build_dist_ell(d, range(DIST_P), device=dev)
        t_ell = time.perf_counter() - t0
        t0 = time.perf_counter()
        bsp = build_dist_bsp(d, range(DIST_P), vt=DEFAULT_VT, device=dev)
        t_bsp = time.perf_counter() - t0
        n_src = DIST_P * d.vp
        adj = {direction: per_device_adjacency(d, direction == "bwd")[0]
               for direction in ("fwd", "bwd")}
        edges = {(direction, p): int(a[0][-1]) for direction in adj
                 for p, a in enumerate(adj[direction])}
        log(f"(a) DistGraph P={DIST_P} vp={d.vp} (P*vp={n_src}) over V={g.v_num} "
            f"E={g.e_num}: {t_graph:.1f} s; per-shard ELL tables {t_ell:.1f} s, bsp tables "
            f"{t_bsp:.1f} s (both directions); shard edges fwd "
            f"{[edges[('fwd', p)] for p in range(DIST_P)]}")
        specs = {
            "ell_level_dist": (ell, ell_level_aggregate, lambda t, v: t.plain(v),
                               "neutronstarlite_torch/csrc/ell_level.cu",
                               "neutronstarlite_tpu/ops/pallas_kernels.py:91"),
            "bsp_ell_dist": (bsp, bsp_aggregate, bsp_tables_aggregate,
                             "neutronstarlite_torch/csrc/bsp_ell.cu",
                             "neutronstarlite_tpu/ops/bsp_ell.py:503"),
        }
        rng = np.random.default_rng(seed + 15)
        errs = {name: 0.0 for name in specs}
        checks = [(602, torch.bfloat16, BF16_TOL), (128, torch.bfloat16, BF16_TOL),
                  (41, torch.bfloat16, BF16_TOL), (41, torch.float32, F32_TOL)]
        for f, dtype, tol in checks:
            x = torch.from_numpy(rng.standard_normal((n_src, f), dtype=np.float32)).to(dev, dtype)
            for name, (tables, wrapper, plain, _, _) in specs.items():
                err = 0.0
                for direction in ("fwd", "bwd"):
                    for p, t in getattr(tables, direction).items():
                        got = wrapper(t, x)
                        if got.shape != (d.vp, f):
                            raise AssertionError(f"{name} shard {p}: shape {tuple(got.shape)}")
                        # f32: rows of up to ~400k terms that cancel keep their
                        # rounding; the weights are >= 0, so the plain version
                        # over |x| is each output's absolute sum of terms
                        abs_sum = plain(t, x.abs()) if dtype == torch.float32 else None
                        err = max(err, check_close(f"{name} {direction} shard {p} f={f} "
                                                   f"{dtype}", got, plain(t, x), tol, abs_sum))
                errs[name] = max(errs[name], err)
                log(f"(a) check {name:14s} f={f:3d} {str(dtype):14s} every shard, fwd and "
                    f"bwd: max abs err {err:.3e} against the plain version")
        del x
        xs = {f: torch.from_numpy(rng.standard_normal((n_src, f), dtype=np.float32)).to(
            dev, torch.bfloat16) for f in (602, 128)}
        library = {}  # (direction, shard, f) -> ms of torch.sparse.mm over the shard's CSR
        for direction in ("fwd", "bwd"):
            for p, (offs, nbr, w, _deg) in enumerate(adj[direction]):
                a = torch.sparse_csr_tensor(
                    torch.from_numpy(offs).to(dev), torch.from_numpy(nbr).to(dev),
                    torch.from_numpy(w).to(dev, torch.bfloat16), size=(d.vp, n_src))
                for dd, f, pp, _ in dist_shard_calls(ell, d, sizes):
                    if (dd, pp) == (direction, p):
                        library[(dd, p, f)] = cuda_ms(lambda: torch.sparse.mm(a, xs[f]))
                del a
        rows = []
        for name, (tables, wrapper, plain, source, replaces) in specs.items():
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                       bound_ms=0.0)
            for direction, f, p, t in dist_shard_calls(tables, d, sizes):
                x = xs[f]
                flops, moved = aggregation_cost(edges[(direction, p)], d.vp, f,
                                                x.element_size(), n_src=n_src)
                b_ms, o_ms = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
                for k, val in (("ms", cuda_ms(lambda: wrapper(t, x))),
                               ("plain_ms", cuda_ms(lambda: plain(t, x), n=3, warmup=1)),
                               ("library_ms", library[(direction, p, f)]),
                               ("bytes_ms", b_ms), ("ops_ms", o_ms),
                               ("bound_ms", max(b_ms, o_ms))):
                    tot[k] += val
            for direction, f in epoch_calls(sizes):
                heavy = max(range(DIST_P), key=lambda p: edges[(direction, p)])
                t = getattr(tables, direction)[heavy]
                geo = (bsp_geometry_text(bsp_geometry(t, f, torch.bfloat16))
                       if name == "bsp_ell_dist"
                       else ell_geometry_text(ell_geometry(t, f, torch.bfloat16)))
                log(f"(a) {name} {direction} f={f} bf16, heaviest shard {heavy} "
                    f"({edges[(direction, heavy)]} edges, {t.slot_count()} slots): {geo}")
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": errs[name], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
                "library_ms": tot["library_ms"],
            })
            log(f"(a) timing {name}, one epoch's {len(epoch_calls(sizes)) * DIST_P} per-shard "
                f"calls {epoch_calls(sizes)} x {DIST_P} shards (CUDA events, 20 after 3): "
                f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, torch.sparse.mm "
                f"over each shard's [{d.vp}, {n_src}] CSR {tot['library_ms']:.4f} ms, bound "
                f"{tot['bound_ms']:.4f} ms (bytes {tot['bytes_ms']:.4f}, f32 ops "
                f"{tot['ops_ms']:.4f}; x read over n_src = {n_src} rows)")
        del ell, bsp, xs, adj
        torch.cuda.empty_cache()

        # (c)'s data-prep tool runs on the host beside (b): a process of its
        # own that does not touch the card
        t_prep0 = time.perf_counter()
        prep_out = tempfile.TemporaryFile(mode="w+")
        prep = subprocess.Popen(
            [sys.executable, "-m", "neutronstarlite_torch.graph.prep", "--dataset", "reddit",
             "--out", "data"], cwd=REPO, stdout=prep_out, stderr=subprocess.STDOUT, text=True,
        )

        # ---- (b) the trainers on the twin ----------------------------------------
        src, dst = results["edges"]
        datum = results["datum"]

        def cfg_of(algorithm, route, epochs):
            return InputInfo(
                algorithm=algorithm, vertices=g.v_num, layer_string="602-128-41",
                epochs=epochs, drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                weight_decay=1e-4, decay_rate=0.97, decay_epoch=100, partitions=DIST_P,
                optim_kernel=route != "ring", pallas_kernel=route == "bsp",
                kernel_tile=4096 if route == "blocked" else 0,
                comm_layer="ring" if route == "ring" else "auto",
            )

        eager_ref = GCNEagerTrainer.from_arrays(
            InputInfo(algorithm="GCNEAGER", vertices=g.v_num, layer_string="602-128-41",
                      epochs=1, drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                      weight_decay=1e-4, decay_rate=0.97, decay_epoch=100, optim_kernel=True),
            src, dst, datum, seed=seed, device=dev, host_graph=g)
        refs = {"GCNDIST": (results.pop("ell_first_logits"), results["ell"]["losses"][0])}
        first = eager_ref.eval_logits()
        eager_ref.run()
        refs["GCNEAGERDIST"] = (first, eager_ref.loss_history[0])
        del eager_ref, first
        dist_runs = {}
        for algorithm, route in (("GCNDIST", "ell"), ("GCNDIST", "bsp"),
                                 ("GCNDIST", "blocked"), ("GCNDIST", "ring"),
                                 ("GCNEAGERDIST", "bsp")):
            cls = DistGCNEagerTrainer if algorithm == "GCNEAGERDIST" else DistGCNTrainer
            name = f"{algorithm} {route}"
            tr = cls.from_arrays(cfg_of(algorithm, route, DIST_EPOCHS), src, dst, datum,
                                 seed=seed, device=dev, host_graph=g)
            valid = torch.from_numpy(np.nonzero(tr.dist.valid_mask())[0]).to(dev)
            ref_logits, ref_loss = refs[algorithm]
            try:
                err = check_close(f"{name} first logits", tr.eval_logits()[valid],
                                  ref_logits, LOGITS_TOL)
            except AssertionError as exc:
                failures.append(f"phase 15 {exc}")
                log(f"FAILED {exc}")
                err = float("nan")
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            tr.run()
            torch.cuda.synchronize()
            launches = kernel_launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            zero_launches()
            tr.train_step()
            torch.cuda.synchronize()
            per_epoch = kernel_launches()
            losses = tr.loss_history
            check(f"{name} finite", all(math.isfinite(x) for x in losses), losses)
            rel = abs(losses[0] - ref_loss) / abs(ref_loss)
            check(f"{name} epoch-0 loss", rel <= LOSS_RTOL,
                  f"{losses[0]} vs single-device ELL {ref_loss} (rel {rel:.2e})")
            want = {"ell": "ell_level", "bsp": "bsp_ell"}.get(route)
            for k, n in launches.items():
                check(f"{name} {k} launches", (n > 0) == (k == want),
                      f"{launches} in the run")
            dist_runs[(algorithm, route)] = launches
            log(f"(b) {name}: first logits max abs err {err:.3e} against the single-device "
                f"ELL route's; epoch-0 loss {losses[0]:.6f} vs {ref_loss:.6f} (rel "
                f"{rel:.2e}); losses {[round(x, 6) for x in losses]}; epochs (s) "
                f"{[round(t, 4) for t in tr.epoch_times]}; launches {launches} in "
                f"{DIST_EPOCHS} epochs + eval, {per_epoch} per training epoch; host table "
                f"build {tr.build_model_s:.1f} s; peak device memory {peak:.2f} GiB")
            del tr
            torch.cuda.empty_cache()
        rows[0]["launches"] = dist_runs[("GCNDIST", "ell")]["ell_level"]
        rows[1]["launches"] = dist_runs[("GCNDIST", "bsp")]["bsp_ell"]

        # ---- (c) the data-prep tool and the north-star cfg -----------------------
        t0 = time.perf_counter()
        rc = prep.wait(timeout=600)
        t_prep, t_wait = time.perf_counter() - t_prep0, time.perf_counter() - t0
        prep_out.seek(0)
        text = prep_out.read()
        if rc != 0:
            raise AssertionError(f"prep failed ({rc}): {text[-2000:]}")
        log(f"(c) python -m neutronstarlite_torch.graph.prep --dataset reddit --out data: "
            f"{t_prep:.1f} s beside (b), {t_wait:.1f} s of it waited for; "
            f"{' '.join(text.split())}")

        def cli(cfg_name):
            """The cfg through run.main on the card; the trainer and its result
            are read from supervised_run."""
            seen = {}
            original = run.supervised_run

            def spy(toolkit, *a, **k):
                seen["tr"] = toolkit
                seen["result"] = original(toolkit, *a, **k)
                return seen["result"]

            run.supervised_run = spy
            zero_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                rc = run.main([os.path.join(REPO, "configs", cfg_name)])
            finally:
                run.supervised_run = original
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            tr = seen.get("tr")
            return rc, tr, seen.get("result"), wall, kernel_launches(), \
                torch.cuda.max_memory_allocated() / 2 ** 30

        rc, tr, res, wall, launches, peak = cli("gcn_reddit_full.cfg")
        check("(c) gcn_reddit_full.cfg rc", rc == 0, rc)
        if tr is not None and res is not None:
            losses, acc = tr.loss_history, res["acc"]
            check("(c) 10 epochs", len(losses) == 10, losses)
            check("(c) loss falls", losses[-1] < losses[0], losses)
            check("(c) test accuracy", acc["test"] >= NORTH_STAR_MIN_TEST_ACC,
                  f"{acc['test']} < {NORTH_STAR_MIN_TEST_ACC:.3f}")
            check("(c) ELL kernel", launches["ell_level"] > 0 and not launches["bsp_ell"],
                  launches)
            log(f"(c) configs/gcn_reddit_full.cfg through the CLI (V={tr.host_graph.v_num} "
                f"E={tr.host_graph.e_num}, ELL, bf16, dropout 0.5): losses "
                f"{[round(x, 4) for x in losses]}; Train/Eval/Test accuracy "
                f"{acc['train']:.4f} / {acc['eval']:.4f} / {acc['test']:.4f} (floor "
                f"{NORTH_STAR_MIN_TEST_ACC:.3f}, chance 1/41); epochs (s) "
                f"{[round(t, 4) for t in tr.epoch_times]}, steady mean "
                f"{tr.avg_epoch_time():.4f}; host graph load + CSC/CSR build "
                f"{tr.timers.total('graph_load'):.1f} s, table build {tr.build_model_s:.1f} s; "
                f"peak device memory {peak:.2f} GiB; {launches['ell_level']} ell_level "
                f"launches; CLI wall {wall:.1f} s")
        del tr, res
        torch.cuda.empty_cache()

        # ---- (d) the distributed Reddit cfg on (c)'s data ------------------------
        # (its blocked twin, gcn_reddit_full_dist_blocked.cfg, is left out for
        # the script's time limit: (b) runs the blocked route at --scale)
        for cfg_name, want in (("gcn_reddit_full_dist_bsp.cfg", "bsp_ell"),):
            rc, tr, res, wall, launches, peak = cli(cfg_name)
            check(f"(d) {cfg_name} rc", rc == 0, rc)
            if tr is None or res is None:
                continue
            losses = tr.loss_history
            check(f"(d) {cfg_name} loss falls", losses[-1] < losses[0], losses)
            for k, n in launches.items():
                check(f"(d) {cfg_name} {k} launches", (n > 0) == (k == want), launches)
            acc = res["acc"]
            log(f"(d) configs/{cfg_name} through the CLI, NTS_DIST_SIMULATE=1 (P="
                f"{tr.dist.partitions}, vp={tr.dist.vp}): losses "
                f"{[round(x, 4) for x in losses]}; Train/Eval/Test accuracy "
                f"{acc['train']:.4f} / {acc['eval']:.4f} / {acc['test']:.4f}; epochs (s) "
                f"{[round(t, 4) for t in tr.epoch_times]}, steady mean "
                f"{tr.avg_epoch_time():.4f}; host graph load + CSC/CSR build "
                f"{tr.timers.total('graph_load'):.1f} s, table build {tr.build_model_s:.1f} "
                f"s; peak device memory {peak:.2f} GiB; launches {launches}; CLI wall "
                f"{wall:.1f} s")
            del tr, res
            torch.cuda.empty_cache()
    finally:
        if prep is not None:
            if prep.poll() is None:
                prep.kill()
                prep.wait()
            prep_out.close()
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return rows



def phase_ring(dev, scale: float, seed: int, results) -> None:
    """Phase 16 (see the module docstring): the pipelined ring, the 2D mesh
    and the split mirror on the sim twin, against the single-device ELL
    route, on phase 9's graph (0.2 x --scale); the wire dtype; the overlap
    probe; the two smoke cfgs."""
    import numpy as np
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.models.gcn import GCNEagerTrainer, GCNTrainer
    from neutronstarlite_torch.models.gcn_dist import (
        DistGCNEagerTrainer,
        DistGCNTrainer,
        exchange_widths,
    )
    from neutronstarlite_torch.parallel.dist_ring_blocked import ring_wire_plan
    from neutronstarlite_torch.parallel.mirror import SplitMirror
    from neutronstarlite_torch.tools.wire_accounting import predict_mesh
    from neutronstarlite_torch.utils.config import InputInfo

    log("phase 16 on " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    t_phase = time.perf_counter()
    failures = results["failures"]

    def check(name, ok, detail):
        if not ok:
            failures.append(f"phase 16 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    keys = ("NTS_DIST_SIMULATE", "NTS_OVERLAP_PROBE", "NTS_PALLAS_RESIDENT", "NTS_WIRE_DTYPE",
            "NTS_MESH")
    saved_env = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    # phase 9's graph at 0.2 x --scale: at --scale each ring_blocked twin
    # spends ~9 s in its host table build, and the script must stay well
    # inside its time limit
    t0 = time.perf_counter()
    src, dst, datum = ggcn_graph(0.2 * scale, seed)
    g = build_graph(src, dst, datum.feature.shape[0])
    sizes = [602, 128, 41]

    def cfg_of(algorithm, epochs=RING_EPOCHS, precision="bfloat16", **kw):
        cfg = InputInfo(
            algorithm=algorithm, vertices=g.v_num, layer_string="602-128-41", epochs=epochs,
            drop_rate=0.0, precision=precision, learn_rate=0.01, weight_decay=1e-4,
            decay_rate=0.97, decay_epoch=100, partitions=DIST_P,
        )
        for k, v in kw.items():
            setattr(cfg, k, v)
        return cfg

    # the single-device ELL references on that graph (phase 15's, there)
    os.environ["NTS_PALLAS_RESIDENT"] = "1"
    refs = {}
    for algorithm, cls in (("GCNDIST", GCNTrainer), ("GCNEAGERDIST", GCNEagerTrainer)):
        ref = cls.from_arrays(cfg_of(algorithm.replace("DIST", ""), epochs=1,
                                     partitions=1, optim_kernel=True,
                                     pallas_kernel=algorithm == "GCNDIST"),
                              src, dst, datum, seed=seed, device=dev, host_graph=g)
        first = ref.eval_logits()
        ref.run()
        refs[algorithm] = (first, ref.loss_history[0])
        del ref
    os.environ.pop("NTS_PALLAS_RESIDENT")
    os.environ["NTS_DIST_SIMULATE"] = "1"
    log(f"phase 16 on phase 9's graph (V={g.v_num} E={g.e_num}, 0.2 x --scale): the "
        f"single-device ELL references (GCN, GCNEAGER) in {time.perf_counter() - t0:.1f} s")

    def trainer(algorithm, **kw):
        cls = DistGCNEagerTrainer if algorithm == "GCNEAGERDIST" else DistGCNTrainer
        return cls.from_arrays(cfg_of(algorithm, **kw), src, dst, datum, seed=seed,
                               device=dev, host_graph=g)

    def expected_gauges(tr, epochs):
        """The wire gauges and counter from the accounting alone."""
        eager, itemsize = type(tr).eager, 2
        widths = exchange_widths(eager, sizes)
        P, vp = tr.dist.partitions, tr.dist.vp
        if tr.comm_layer == "mirror":
            rows = (P - 1) * tr.dist.mb
            return {"wire.rows_per_layer": rows,
                    "wire.bytes_per_epoch_fwd": rows * sum(widths) * itemsize}, \
                rows * sum(widths) * itemsize * epochs
        spec = tr.mesh_spec
        plan = ring_wire_plan(tr.compute_graph.tables.fwd, widths, itemsize,
                              pf=spec.pf if spec is not None else 1)
        want = {"wire.rows_per_layer": plan["transfers"] * vp,
                "wire.bytes_per_epoch_fwd": sum(h["bytes"] for h in plan["steps"]),
                "wire.peak_resident_rows": plan["peak_resident_rows"],
                "ring.transfers": plan["transfers"],
                "ring.skipped_steps": len(plan["skipped_steps"]),
                "wire.peak_resident_feature_bytes": plan["peak_resident_feature_bytes"]}
        if spec is not None:
            pred = predict_mesh(g, spec.pv, spec.pf, widths, itemsize)
            want.update({"mesh.shape": spec.label(), "mesh.pv": spec.pv, "mesh.pf": spec.pf,
                         "mesh.devices": spec.devices, "mesh.slab_cols": plan["slab_cols"],
                         "wire.peak_resident_feature_bytes":
                             pred["peak_resident_feature_bytes"]})
            if not plan["skipped_steps"]:
                want["wire.bytes_per_epoch_fwd"] = pred["bytes_per_epoch"]
        return want, want["wire.bytes_per_epoch_fwd"] * epochs

    try:
        # ---- (a) the routes, RING_EPOCHS each -------------------------------------
        os.environ["NTS_OVERLAP_PROBE"] = "1"  # (c): on the first ring run
        for name, algorithm, kw in (
                ("ring_blocked", "GCNDIST", dict(dist_path="ring_blocked")),
                ("MESH:4,2", "GCNDIST", dict(dist_path="ring_blocked_sim", mesh="4,2")),
                ("mirror", "GCNDIST", dict(comm_layer="mirror")),
                ("auto", "GCNDIST", {}),
                ("eager ring_blocked", "GCNEAGERDIST", dict(dist_path="ring_blocked"))):
            t0 = time.perf_counter()
            tr = trainer(algorithm, **kw)
            t_build = time.perf_counter() - t0
            if name == "auto":
                mb, vp = SplitMirror.estimate_mb_remote(g, DIST_P)
                check("auto choice", tr.comm_layer == ("mirror" if mb <= vp else "ring"),
                      f"{tr.comm_layer} with mb={mb} vp={vp}")
                log(f"(a) COMM_LAYER:auto at P={DIST_P} without OPTIM_KERNEL -> "
                    f"{tr.comm_layer} (mirror mb={mb} remote slots/pair vs ring vp={vp})")
            valid = torch.from_numpy(np.nonzero(tr.dist.valid_mask())[0]).to(dev)
            ref_logits, ref_loss = refs[algorithm]
            zero_launches()
            try:
                err = check_close(f"{name} first logits", tr.eval_logits()[valid],
                                  ref_logits, LOGITS_TOL)
            except AssertionError as exc:
                failures.append(f"phase 16 {exc}")
                log(f"FAILED {exc}")
                err = float("nan")
            torch.cuda.reset_peak_memory_stats()
            tr.run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            launches = kernel_launches()
            check(f"{name} kernels", not any(launches.values()), f"{launches} launched")
            losses = tr.loss_history
            check(f"{name} finite", all(math.isfinite(x) for x in losses), losses)
            rel = abs(losses[0] - ref_loss) / abs(ref_loss)
            check(f"{name} epoch-0 loss", rel <= LOSS_RTOL,
                  f"{losses[0]} vs single-device ELL {ref_loss} (rel {rel:.2e})")
            gauges = tr.metrics._gauges
            want, counter = expected_gauges(tr, len(losses))
            got = {k: gauges.get(k) for k in want}
            check(f"{name} gauges", got == want, f"{got} vs the accounting's {want}")
            live = tr.metrics._counters.get("wire.bytes_fwd")
            check(f"{name} wire counter", live == counter, f"{live} vs {counter}")
            log(f"(a) {name} (P={tr.dist.partitions}, vp={tr.dist.vp}, "
                f"{tr.comm_layer}): first logits max abs err {err:.3e} against the "
                f"single-device ELL route's; epoch-0 loss {losses[0]:.6f} vs {ref_loss:.6f} "
                f"(rel {rel:.2e}); losses {[round(x, 6) for x in losses]}; epochs (s) "
                f"{[round(t, 4) for t in tr.epoch_times]}; host table build "
                f"{tr.build_model_s:.1f} s (trainer {t_build:.1f} s); peak device memory "
                f"{peak:.2f} GiB; launches {launches}; gauges {got} = the accounting; "
                f"wire.bytes_fwd {live}")
            if name == "ring_blocked":
                os.environ.pop("NTS_OVERLAP_PROBE")
                probe = {k: gauges.get(k) for k in (
                    "ring.probe_overlap_s", "ring.probe_compute_s", "ring.probe_exchange_s",
                    "ring.probe_simulated", "ring.overlap_efficiency")}
                check("(c) overlap probe gauges",
                      all(probe[k] is not None for k in list(probe)[:4])
                      and probe["ring.probe_simulated"] is True, probe)
                log(f"(c) NTS_OVERLAP_PROBE=1 on the ring_blocked run: {probe} (the twin's "
                    "hop is a slice of x: this measures the schedule's overhead, not wire "
                    "time)")
            del tr
            torch.cuda.empty_cache()

        # ---- (b) the wire dtype ---------------------------------------------------
        wire = {}
        for wd in ("f32", "bf16"):
            tr = trainer("GCNDIST", epochs=1, precision="float32", dist_path="ring_blocked",
                         wire_dtype=wd)
            first = tr.eval_logits()
            tr.run()
            torch.cuda.synchronize()
            wire[wd] = (first, tr.metrics._gauges["wire.bytes_per_epoch_fwd"],
                        list(tr.epoch_times), list(tr.loss_history))
            del tr
        f32, bf16 = wire["f32"][0], wire["bf16"][0]
        gap, bound = float((bf16 - f32).abs().max()), 0.02 * float(f32.abs().max())
        check("(b) bf16 wire logits", gap <= bound, f"max |d| {gap} > {bound}")
        check("(b) bf16 wire is real", not torch.equal(bf16, f32), "bitwise the f32 wire")
        check("(b) wire bytes halve", 2 * wire["bf16"][1] == wire["f32"][1],
              f"{wire['bf16'][1]} vs {wire['f32'][1]}")
        log(f"(b) GCNDIST ring_blocked f32, WIRE_DTYPE:bf16 vs f32: first logits max |d| "
            f"{gap:.3e} (bound 0.02 max|f32| = {bound:.3e}); wire bytes per epoch "
            f"{wire['bf16'][1]} vs {wire['f32'][1]}; epochs (s) bf16 "
            f"{[round(t, 4) for t in wire['bf16'][2]]}, f32 "
            f"{[round(t, 4) for t in wire['f32'][2]]}; losses bf16 "
            f"{[round(x, 6) for x in wire['bf16'][3]]}, f32 "
            f"{[round(x, 6) for x in wire['f32'][3]]}")
        del wire, f32, bf16
        torch.cuda.empty_cache()

        # ---- (d) the smoke cfgs through the CLI -------------------------------------
        for cfg_name in ("gcn_dist_ring_smoke.cfg", "gcn_dist_mesh_smoke.cfg"):
            seen = {}
            original = run.supervised_run

            def spy(toolkit, *a, **k):
                seen["tr"] = toolkit
                return original(toolkit, *a, **k)

            run.supervised_run = spy
            zero_launches()
            t0 = time.perf_counter()
            try:
                rc = run.main([os.path.join(REPO, "configs", cfg_name)])
            finally:
                run.supervised_run = original
            wall = time.perf_counter() - t0
            tr = seen.get("tr")
            losses = tr.loss_history if tr is not None else []
            check(f"(d) {cfg_name}", rc == 0 and losses and all(map(math.isfinite, losses)),
                  f"rc {rc}, losses {losses}")
            check(f"(d) {cfg_name} kernels", not any(kernel_launches().values()),
                  kernel_launches())
            log(f"(d) configs/{cfg_name} through the CLI on the card, NTS_DIST_SIMULATE=1: "
                f"rc {rc}, losses {[round(x, 4) for x in losses]}, device "
                f"{tr.device if tr is not None else None}, CLI wall {wall:.1f} s")
            del tr, seen
    finally:
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")


# phase 17: every trainer over the uniform mirror-slot exchange (plain
# PyTorch: each run must leave both kernels' launch counts at 0) on the sim
# twin at P=8. MIRROR_EPOCHS per run; the fused ring runs one (it is
# launch-bound: ~20 s per epoch at 0.1, and the script must stay well
# inside its time limit)
MIRROR_EPOCHS = 3
FUSED_RING_EPOCHS = 1
CHUNK_RANKS = (0, DIST_P - 1)  # the ranks whose chunked chain body (e) checks
# (f): JAX's test_dist_gat_bf16_tracks_f32 bound on the last loss (rtol,
# atol) and the train accuracy's allowed drop
BF16_LOSS_TOL = (0.05, 0.02)
BF16_ACC_DROP = 0.05


def steady_s(times) -> float:
    """The mean epoch time after the first (the first alone when there is
    only one)."""
    return float(sum(times[1:]) / len(times[1:])) if len(times) > 1 else float(times[0])


def phase_mirror(dev, g, seed: int, results, ggcn_chain: dict, scale: float) -> None:
    """Phase 17 (see the module docstring): TEST_GETDEP, GATDIST on the
    mirror chain, on the fused ring and in bf16, GGCNDIST's chain and fused
    ring, the chunked chain's per-rank body, and the DepCache GCN."""
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.models import get_algorithm
    from neutronstarlite_torch.models.gat_dist import edge_chunk
    from neutronstarlite_torch.parallel import dist_edge_ops as deo
    from neutronstarlite_torch.parallel.dist_fused_edge import fused_wire_cols
    from neutronstarlite_torch.parallel.mirror import MirrorGraph, chunk_edge_list
    from neutronstarlite_torch.utils.config import InputInfo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"phase 17 on {smi}")
    t_phase = time.perf_counter()
    failures = results["failures"]
    rows_out = results.setdefault("phase17", [])

    def check(name, ok, detail):
        if not ok:
            failures.append(f"phase 17 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    keys = ("NTS_DIST_SIMULATE", "NTS_EDGE_CHUNK", "NTS_WIRE_DTYPE", "NTS_PALLAS_RESIDENT")
    saved_env = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ["NTS_DIST_SIMULATE"] = "1"
    src, dst = results["edges"]
    datum = results["datum"]
    gat = results["gat"]

    def cfg_of(algorithm, v, epochs=MIRROR_EPOCHS, precision="float32", **kw):
        cfg = InputInfo(algorithm=algorithm, vertices=v, layer_string="602-128-41",
                        epochs=epochs, drop_rate=0.0, precision=precision, learn_rate=0.01,
                        weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                        partitions=DIST_P)
        for k, val in kw.items():
            setattr(cfg, k, val)
        return cfg

    def build(algorithm, edges, d, host_graph, params=None, **kw):
        zero_launches()
        t0 = time.perf_counter()
        tr = get_algorithm(algorithm).from_arrays(
            cfg_of(algorithm, d.feature.shape[0], **kw), *edges, d, seed=seed, device=dev,
            host_graph=host_graph)
        if params is not None:
            tr.load_params(params)
        return tr, time.perf_counter() - t0

    def train(tr, name):
        """Run with the kernels' counts at 0 and the peak reset; returns
        the peak GiB."""
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        tr.run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = kernel_launches()
        check(f"{name} kernels", not any(launches.values()), f"{launches} launched")
        check(f"{name} finite", all(math.isfinite(x) for x in tr.loss_history),
              tr.loss_history)
        return peak

    def wire_check(tr, name, want_gauges: dict, per_epoch: list):
        got = {k: tr.metrics._gauges.get(k) for k in want_gauges}
        check(f"{name} gauges", got == want_gauges, f"{got} vs the accounting's {want_gauges}")
        live = tr.metrics._counters.get("wire.bytes_fwd")
        check(f"{name} wire counter", live == sum(per_epoch), f"{live} vs {sum(per_epoch)}")
        return got, live

    def first_logits(tr, ref, name, graph):
        valid = torch.from_numpy(np.nonzero(tr.dist.valid_mask())[0]).to(dev)
        row = max(1.0, float(graph.in_degree.max()) / GAT_ROW)
        try:
            return check_close(f"phase 17 {name} first logits", tr.eval_logits()[valid], ref,
                               (GAT_LOGITS_TOL[0] * row, GAT_LOGITS_TOL[1]))
        except AssertionError as exc:
            failures.append(str(exc))
            log(f"FAILED {exc}")
            return float("nan")

    def loss_check(tr, ref, name, rtol=GAT_LOSS_RTOL):
        rel = abs(tr.loss_history[0] - ref) / abs(ref)
        check(f"{name} epoch-0 loss", rel <= rtol, f"{tr.loss_history[0]} vs {ref} "
              f"(rel {rel:.2e})")
        return rel

    def record(name, tr, t_build, peak, extra=""):
        ep = steady_s(tr.epoch_times)
        rows_out.append({"run": name, "epoch_s": ep, "build_s": tr.build_model_s,
                         "peak_gib": peak,
                         "wire_bytes": tr.metrics._gauges.get("wire.bytes_per_epoch_fwd")})
        log(f"({name}) losses {[round(x, 6) for x in tr.loss_history]}; epochs (s) "
            f"{[round(t, 4) for t in tr.epoch_times]} (steady {ep:.4f}); host table build "
            f"{tr.build_model_s:.1f} s (trainer {t_build:.1f} s); peak device memory "
            f"{peak:.2f} GiB; ell_level and bsp_ell launches 0{extra}")

    try:
        P = DIST_P
        # ---- (a) TEST_GETDEP -----------------------------------------------------------
        tr, t_build = build("TEST_GETDEP", (src, dst), datum, gat["graph"])
        zero_launches()
        t0 = time.perf_counter()
        out = tr.run()
        torch.cuda.synchronize()
        check("(a) TEST_GETDEP", out["pass"] and out["fwd_err"] == 0 and out["bwd_err"] == 0,
              out)
        check("(a) kernels", not any(kernel_launches().values()), kernel_launches())
        log(f"(a) TEST_GETDEP P={P} mb={tr.mg.mb} vp={tr.mg.vp}: pass {out['pass']}, fwd_err "
            f"{out['fwd_err']}, bwd_err {out['bwd_err']}; run {time.perf_counter() - t0:.2f} "
            f"s, trainer {t_build:.1f} s; ell_level and bsp_ell launches 0")
        del tr

        # ---- (b) GATDIST f32 on the mirror chain ----------------------------------------
        sizes = [602, 128, 41]
        tr, t_build = build("GATDIST", (src, dst), datum, gat["graph"], gat["params"])
        err = first_logits(tr, gat["logits"], "(b) GATDIST chain", gat["graph"])
        peak = train(tr, "(b) GATDIST chain")
        rel = loss_check(tr, gat["loss"], "(b) GATDIST chain")
        mg = tr.dist
        rows = (P - 1) * mg.mb
        want = {"wire.comm_layer": "mirror", "wire.rows_per_layer": rows,
                "wire.bytes_per_epoch_fwd": rows * sum(f + 1 for f in sizes[1:]) * 4,
                "kernel.path": "eager_edge"}
        got, live = wire_check(tr, "(b)", want,
                               [want["wire.bytes_per_epoch_fwd"]] * MIRROR_EPOCHS)
        record("b", tr, t_build, peak,
               f"; P={P} vp={mg.vp} mb={mg.mb} El={mg.el}; first logits max abs err "
               f"{err:.3e} against phase 7's chain, epoch-0 loss rel {rel:.2e}; gauges {got} "
               f"= the accounting; wire.bytes_fwd {live}")
        chain_acc = tr.test(tr.eval_logits().float().cpu().numpy(), 0)
        chain_last = tr.loss_history[-1]
        del tr
        torch.cuda.empty_cache()

        # ---- (c) GATDIST on the fused ring (ring_blocked_sim), at 0.2 x scale -----------
        # on phase 9's graph (at --scale one epoch of the twin's fused ring is
        # some 10^6 launches, 18 s), against the mirror chain on that graph
        gg = ggcn_chain
        ge = gg["edges"]
        tr, _ = build("GATDIST", ge, gg["datum"], gg["graph"], gat["params"],
                      epochs=FUSED_RING_EPOCHS)
        small_first = tr.eval_logits()
        train(tr, "(c) GATDIST chain, 0.2 x scale")
        small_loss = tr.loss_history[0]
        del tr
        tr, t_build = build("GATDIST", ge, gg["datum"], gg["graph"], gat["params"],
                            epochs=FUSED_RING_EPOCHS, kernel="fused_edge",
                            dist_path="ring_blocked_sim")
        row = max(1.0, float(gg["graph"].in_degree.max()) / GAT_ROW)
        try:
            err = check_close("phase 17 (c) GATDIST fused first logits", tr.eval_logits(),
                              small_first, (GAT_LOGITS_TOL[0] * row, GAT_LOGITS_TOL[1]))
        except AssertionError as exc:
            failures.append(str(exc))
            log(f"FAILED {exc}")
            err = float("nan")
        peak = train(tr, "(c) GATDIST fused")
        rel = loss_check(tr, small_loss, "(c) GATDIST fused")
        vp = tr.dist.vp
        want = {"wire.comm_layer": "ring_fused", "wire.rows_per_layer": (P - 1) * vp,
                "wire.bytes_per_epoch_fwd": (P - 1) * vp * sum(
                    fused_wire_cols(f, 1)["fwd"] for f in sizes[1:]) * 4,
                "kernel.path": "fused_edge", "kernel.edge_hbm_bytes_per_epoch": 0}
        got, live = wire_check(tr, "(c)", want,
                               [want["wire.bytes_per_epoch_fwd"]] * FUSED_RING_EPOCHS)
        zero_launches()
        prof = profile_launches(tr.train_step)
        check("(c) profile kernels", not any(kernel_launches().values()), kernel_launches())
        record("c", tr, t_build, peak,
               f"; vt {tr.metrics._gauges['kernel.fused_vt']}, "
               f"{tr.metrics._gauges['kernel.fused_slots']} table slots; V={gg['graph'].v_num} "
               f"E={gg['graph'].e_num}; first logits max abs err {err:.3e} against the mirror "
               f"chain's on that graph, epoch-0 loss rel {rel:.2e}; gauges {got} = "
               f"the accounting; wire.bytes_fwd {live}; one training epoch under "
               f"torch.profiler (device activity, raw events): "
               + (f"host wall {prof['wall_ms']:.1f} ms, {prof['kernels']} kernels, device "
                  f"busy {prof['busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f} (trace "
                  f"read in {prof['read_s']:.1f} s)" if prof else
                  "device time not measured (the trace holds no device events)"))
        rows_out[-1].update(launches=prof.get("kernels"), idle=prof.get("idle_share"))
        del tr, small_first
        torch.cuda.empty_cache()

        # ---- (f) GATDIST PRECISION:bfloat16 against (b) ----------------------------------
        tr, t_build = build("GATDIST", (src, dst), datum, gat["graph"], gat["params"],
                            precision="bfloat16")
        peak = train(tr, "(f) GATDIST bf16")
        acc16 = tr.test(tr.eval_logits().float().cpu().numpy(), 0)
        last16 = tr.loss_history[-1]
        check("(f) bf16 loss", abs(last16 - chain_last) <= BF16_LOSS_TOL[1]
              + BF16_LOSS_TOL[0] * abs(chain_last), f"{last16} vs f32 {chain_last}")
        check("(f) bf16 train accuracy", acc16 >= chain_acc - BF16_ACC_DROP,
              f"{acc16} vs f32 {chain_acc}")
        got = tr.metrics._gauges["wire.bytes_per_epoch_fwd"]
        check("(f) bf16 wire", 2 * got == (P - 1) * mg.mb * sum(f + 1 for f in sizes[1:]) * 4,
              got)
        record("f", tr, t_build, peak,
               f"; last loss {last16:.6f} vs f32 {chain_last:.6f} (bound {BF16_LOSS_TOL[0]} "
               f"rel + {BF16_LOSS_TOL[1]}), train acc {acc16:.4f} vs f32 {chain_acc:.4f}; wire "
               f"bytes per epoch {got} (half the f32 chain's)")
        del tr
        torch.cuda.empty_cache()

        # ---- (d) GGCNDIST: the chain at 0.2 x scale, the fused ring -----------------------
        tr, t_build = build("GGCNDIST", ge, gg["datum"], gg["graph"], gg["params"],
                            epochs=2)
        g_first = tr.eval_logits()
        err = first_logits(tr, gg["logits"], "(d) GGCNDIST chain", gg["graph"])
        peak = train(tr, "(d) GGCNDIST chain")
        rel = loss_check(tr, gg["loss"], "(d) GGCNDIST chain")
        m2 = tr.dist
        rows = (P - 1) * m2.mb
        want = {"wire.comm_layer": "mirror", "wire.rows_per_layer": rows,
                "wire.bytes_per_epoch_fwd": rows * sum(2 * f for f in sizes[1:]) * 4}
        got, live = wire_check(tr, "(d) chain", want, [want["wire.bytes_per_epoch_fwd"]] * 2)
        record("d chain", tr, t_build, peak,
               f"; V={m2.v_num} E={m2.e_num} vp={m2.vp} mb={m2.mb} El={m2.el}; first logits "
               f"max abs err {err:.3e} against phase 9's chain, epoch-0 loss rel {rel:.2e}; "
               f"gauges {got} = the accounting")
        g_loss = tr.loss_history[0]
        del tr
        torch.cuda.empty_cache()
        tr, t_build = build("GGCNDIST", ge, gg["datum"], gg["graph"], gg["params"],
                            epochs=1, kernel="fused_edge", dist_path="ring_blocked_sim")
        row = max(1.0, float(gg["graph"].in_degree.max()) / GAT_ROW)
        try:
            err = check_close("phase 17 (d) GGCNDIST fused first logits", tr.eval_logits(),
                              g_first, (GAT_LOGITS_TOL[0] * row, GAT_LOGITS_TOL[1]))
        except AssertionError as exc:
            failures.append(str(exc))
            log(f"FAILED {exc}")
            err = float("nan")
        peak = train(tr, "(d) GGCNDIST fused, 0.2 x scale")
        rel = loss_check(tr, g_loss, "(d) GGCNDIST fused, 0.2 x scale")
        record("d fused 0.2", tr, t_build, peak,
               f"; first logits max abs err {err:.3e} against the chain's, epoch-0 loss rel "
               f"{rel:.2e}")
        del tr, g_first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gsrc, gdst, gdatum = ggcn_graph(scale, seed)
        g2 = build_graph(gsrc, gdst, gdatum.feature.shape[0], weight="ones")
        t_graph = time.perf_counter() - t0
        del gsrc, gdst, gdatum

        # ---- (e) the chunked chain's per-rank body at --scale -----------------------------
        # held in f64 (the bodies sum wide: f64 inputs sum in f64), where a
        # hub source's gradient row, summed chunk by chunk or at once, agrees
        # to rounding; each body's peak is measured in f32, as the ranks run;
        # on CHUNK_RANKS of the 8 (each rank's lists hold some 1.5M edges)
        t0 = time.perf_counter()
        mg2 = MirrorGraph.build(g2, P)
        ec = edge_chunk()
        ch = chunk_edge_list(mg2, ec)
        ex = deo.UniformMirror(mg2, None, dev, edges=False)
        t_tables = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(seed + 17)
        f = 128
        payload = torch.randn((P * mg2.vp, 2 * f), generator=gen, device=dev) * 0.1
        mirrors = deo.dist_get_dep_nbr(ex, payload).view(P, P * mg2.mb, 2 * f)
        hd_all = torch.randn((P * mg2.vp, f), generator=gen, device=dev) * 0.1
        errs, peaks = [], {"chunked": 0.0, "whole": 0.0}

        def body(how, p, m, hd):
            if how == "chunked":
                return deo.gated_chain_chunked_body(deo.ChunkTables.of_rank(ch, p, dev),
                                                    mg2.vp, m, hd, f, 0.2)
            return deo.gated_chain_body(deo.EdgeLists.of_rank(mg2, p, dev), m, hd, f, 0.2)

        zero_launches()
        t0 = time.perf_counter()
        for p in CHUNK_RANKS:
            cot = torch.randn((mg2.vp, f), generator=gen, device=dev)
            outs = {}
            for how in ("chunked", "whole"):
                for dtype in (torch.float32, torch.float64):
                    m = mirrors[p].to(dtype).requires_grad_(True)
                    hd = hd_all[p * mg2.vp:(p + 1) * mg2.vp].to(dtype).requires_grad_(True)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    y = body(how, p, m, hd)
                    y.backward(cot.to(y.dtype))
                    torch.cuda.synchronize()
                    if dtype == torch.float32:
                        peaks[how] = max(peaks[how],
                                         (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
                    else:
                        outs[how] = (y.detach(), m.grad, hd.grad)
                    del y, m, hd
            errs.append([check_close(f"phase 17 (e) rank {p} {what} (f64)", a, b, F32_TOL)
                         for what, a, b in zip(("forward", "grad mirrors", "grad dst half"),
                                               outs["chunked"], outs["whole"])])
            del outs
        check("(e) kernels", not any(kernel_launches().values()), kernel_launches())
        log(f"(e) chunked chain body, GGCN C=f=128 at --scale {scale} (V={g2.v_num} "
            f"E={g2.e_num}, graph {t_graph:.1f} s; El={mg2.el}/rank), NTS_EDGE_CHUNK {ec}: "
            f"{ch.n_chunks} chunk(s) of up to {ch.slot.shape[2]} edges (dp={ch.dp}) per rank; "
            f"in f64, max abs err against the whole body on ranks {list(CHUNK_RANKS)} "
            f"(forward, grad mirrors, grad dst half) "
            f"{[f'{max(e[i] for e in errs):.3e}' for i in range(3)]} (F32_TOL); f32 peak "
            f"memory above the inputs, worst rank: chunked {peaks['chunked']:.2f} GiB, whole "
            f"{peaks['whole']:.2f} GiB; tables {t_tables:.1f} s, the ranks' checks "
            f"{time.perf_counter() - t0:.1f} s")
        rows_out.append({"run": "e", "chunks": ch.n_chunks, "peak_chunked": peaks["chunked"],
                         "peak_whole": peaks["whole"]})
        del mirrors, payload, hd_all, ex, mg2, ch, g2
        torch.cuda.empty_cache()

        # ---- (g) the DepCache GCN --------------------------------------------------------
        # on phase 9's graph (0.2 x --scale) with GCN's weights: at --scale its
        # four twins' host builds took ~20 s, and the script must stay well
        # inside its time limit
        gn = build_graph(*ge, gg["datum"].feature.shape[0])
        ref, t_build = build("GCNDIST", ge, gg["datum"], gn, epochs=1, comm_layer="mirror")
        ref_first = ref.eval_logits()
        train(ref, "(g) GCNDIST mirror f32")
        ref_loss = ref.loss_history[0]
        log(f"(g) reference GCNDIST COMM_LAYER:mirror f32: epoch-0 loss {ref_loss:.6f}")
        del ref
        runs = {}
        for name, kw in (("rep0", {}),
                         ("auto", dict(process_rep=True, rep_threshold=-1)),
                         ("refresh3", dict(process_rep=True, rep_threshold=-1,
                                           cache_refresh=3))):
            tr, t_build = build("GCNDISTCACHE", ge, gg["datum"], gn, **kw)
            first = tr.eval_logits()
            peak = train(tr, f"(g) {name}")
            cmg = tr.dist
            rf, rp = (P - 1) * cmg.mb, (P - 1) * cmg.mf
            want = {"wire.comm_layer": "mirror+depcache", "wire.rows_per_layer_full": rf,
                    "wire.rows_per_layer_partial": rp}
            l0 = rp if cmg.mc else rf
            hist = name == "refresh3" and cmg.mc > 0
            per_epoch = []
            for e in range(MIRROR_EPOCHS):
                refresh = hist and e % 3 == 0
                deep = rp if hist else rf
                per_epoch.append(4 * (l0 * 602 + deep * 128) + (4 * rf * 730 if refresh else 0))
            got, live = wire_check(tr, f"(g) {name}", want, per_epoch)
            runs[name] = (first, list(tr.loss_history))
            record(f"g {name}", tr, t_build, peak,
                   f"; threshold {tr.threshold}, cached fraction {cmg.cached_fraction:.4f}, "
                   f"mc={cmg.mc} mf={cmg.mf} mb={cmg.mb}; gauges {got} = the accounting; wire "
                   f"bytes per epoch {per_epoch} (counter {live})")
            del tr
            torch.cuda.empty_cache()
        # f32 sums of the hub rows in other orders (the split mirror adds its
        # remote and resident edges apart): the chains' tolerance
        err = check_close("phase 17 (g) rep0 first logits vs GCNDIST mirror", runs["rep0"][0],
                          ref_first, GAT_LOGITS_TOL)
        rel = abs(runs["rep0"][1][0] - ref_loss) / abs(ref_loss)
        check("(g) rep0 epoch-0 loss", rel <= GAT_LOSS_RTOL, f"rel {rel:.2e}")
        err2 = check_close("phase 17 (g) auto first logits vs rep0", runs["auto"][0],
                           runs["rep0"][0], GAT_LOGITS_TOL)
        gap = max(abs(a - b) for a, b in zip(runs["auto"][1], runs["rep0"][1]))
        check("(g) auto vs rep0 losses", gap <= GAT_LOSS_RTOL * abs(runs["rep0"][1][0]),
              f"max gap {gap:.3e}")
        log(f"(g) PROC_REP:0 vs GCNDIST mirror: first logits max abs err {err:.3e}, epoch-0 "
            f"loss rel {rel:.2e}; PROC_REP:1 auto (CACHE_REFRESH:1) vs PROC_REP:0: first "
            f"logits {err2:.3e}, losses max gap {gap:.3e}; CACHE_REFRESH:3 losses "
            f"{[round(x, 6) for x in runs['refresh3'][1]]}")
        del runs, ref_first, gn
    finally:
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")


TUNE_P = 8  # the twin's partitions in phase 18 (phase 15's)
TUNE_AVG_DEGREE = 492  # comm_bench's mean degree: the main path's


def tune_rows_text(rows) -> str:
    """Each candidate's prior bytes, trial ms and source, one per line."""
    return "\n".join(
        f"    {r['candidate']:32s} prior {r['predicted_bytes']:>14,d} B  "
        + (f"trial {r['seconds'] * 1e3:9.3f} ms" if r["seconds"] is not None
           else "trial       n/a   ") + f"  {r['source']}" for r in rows)


def phase_tune(dev, g, seed: int, results, scale: float) -> None:
    """Phase 18 (see the module docstring): comm_bench's four layers, then
    the autotuner on every family: GCNDIST bf16 (DIST_PATH, WIRE_DTYPE and
    MESH auto) measured, replayed from the cache and held bitwise against
    its pinned tuple; GAT (KERNEL and ELL_LEVELS auto); GATDIST (KERNEL
    auto) at 0.2 x --scale; GCNSAMPLE (SAMPLE_PIPELINE auto); and the two
    shipped tune cfgs through the CLI."""
    import numpy as np
    import torch

    from neutronstarlite_torch import run
    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.graph.synthetic import planted_partition_graph
    from neutronstarlite_torch.models import get_algorithm
    from neutronstarlite_torch.obs.schema import validate_stream
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.parallel import comm_bench
    from neutronstarlite_torch.tune.space import Candidate
    from neutronstarlite_torch.utils.config import InputInfo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"phase 18 on {smi}")
    t_phase = time.perf_counter()
    failures = results["failures"]

    def check(name, ok, detail):
        if not ok:
            failures.append(f"phase 18 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    keys = ("NTS_TUNE", "NTS_TUNE_DIR", "NTS_TUNE_STEPS", "NTS_TUNE_MAX_TRIALS",
            "NTS_DIST_SIMULATE", "NTS_MESH", "NTS_METRICS_DIR", "NTS_PALLAS_RESIDENT",
            "NTS_WIRE_DTYPE", "NTS_SAMPLE_PIPELINE", "NTS_SAMPLE_WORKERS", "NTS_FINAL_EVAL",
            "NTS_EDGE_CHUNK")
    saved_env = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    src, dst = results["edges"]
    datum = results["datum"]

    def records(d):
        recs = []
        for path in sorted(glob.glob(os.path.join(d, "*.jsonl"))):
            with open(path) as fh:
                recs += [json.loads(line) for line in fh if line.strip()]
        validate_stream(recs)
        return recs

    def of(recs, kind):
        return [r for r in recs if r["event"] == kind]

    def tuned(name, algorithm, cls_cfg, s, d, dat, graph, mode, epochs=0):
        """One trainer under NTS_TUNE=mode with its stream in tmp/name:
        (trainer, its records, build seconds)."""
        mdir = os.path.join(tmp, name)
        os.environ["NTS_TUNE"] = mode
        os.environ["NTS_METRICS_DIR"] = mdir
        t0 = time.perf_counter()
        try:
            tr = get_algorithm(algorithm).from_arrays(cls_cfg, s, d, dat, seed=seed,
                                                      device=dev, host_graph=graph)
        finally:
            os.environ.pop("NTS_TUNE", None)
        build_s = time.perf_counter() - t0
        tr.metrics.close()
        return tr, records(mdir), build_s

    def report(name, tr, recs, build_s, n_trials=None):
        decisions = of(recs, "tune_decision")
        trials = of(recs, "tune_trial")
        check(f"{name} one decision", len(decisions) == 1, f"{len(decisions)} decisions")
        if not decisions:
            return None
        dec = decisions[0]
        gauges = tr.metrics.snapshot()["gauges"]
        rows = getattr(tr, "tune_rows", None) or []
        if n_trials is not None:
            check(f"{name} trials", len(trials) == n_trials,
                  f"{len(trials)} tune_trial records, want {n_trials}")
        measured = [r for r in rows if r["seconds"] is not None]
        if dec["source"] == "measured" and measured:
            check(f"{name} pick", dec["seconds"] <= min(r["seconds"] for r in measured),
                  f"{dec['seconds']} vs {[r['seconds'] for r in measured]}")
        peak = gauges.get("tune.trial_peak_bytes")
        log(f"{name}: {dec['source']} decision {dec['candidate']} over {len(rows)} "
            f"candidates ({len(measured)} trialled), trial phase peak "
            f"{peak / 2 ** 30 if peak else float('nan'):.2f} GiB, build incl. tuning "
            f"{build_s:.1f} s\n" + tune_rows_text(rows))
        return dec

    try:
        # ---- (a) comm_bench's four layers ------------------------------------------
        t0 = time.perf_counter()
        zero_launches()
        keep = {}
        bench = comm_bench.bench_layers(g.v_num, TUNE_AVG_DEGREE, 602, TUNE_P, 2, device=dev,
                                        keep=keep)
        torch.cuda.synchronize()
        launches = kernel_launches()
        check("(a) ell leg launches ell_level", launches["ell_level"] > 0 and
              not launches["bsp_ell"], f"launches {launches}")
        x, ell = keep.pop("x"), keep.pop("ell")
        err = 0.0
        for direction in ("fwd", "bwd"):
            for p, t in getattr(ell, direction).items():
                try:
                    err = max(err, check_close(
                        f"(a) ell leg {direction} shard {p}", ell_level_aggregate(t, x),
                        t.plain(x), F32_TOL, t.plain(x.abs())))
                except AssertionError as exc:
                    check(f"(a) ell leg {direction} shard {p}", False, str(exc))
        del x, ell, keep
        torch.cuda.empty_cache()
        meta = bench["meta"]
        log(f"(a) comm_bench V={meta['v_num']} E={meta['e_num']} f={meta['feature']} "
            f"P={meta['P']} vp={meta['vp']} mb={meta['mb']} ({time.perf_counter() - t0:.1f} s "
            f"incl. host build); ell leg's per-shard sums vs the plain version max abs err "
            f"{err:.3e}; launches {launches}")
        for name in ("ring", "ell", "mirror", "ring_blocked"):
            r = bench[name]
            check(f"(a) {name} finite", math.isfinite(r["check"]), r)
            log(f"(a) {name:12s} wire {r['wire_rows_per_dev_layer']:>8,d} rows "
                f"({r['wire_mb_per_dev_layer_f32']:8.2f} MiB f32) / partition / layer, peak "
                f"{r['peak_live_rows']:>8,d} rows ({r['peak_live_mb_f32']:8.2f} MiB), "
                f"{r['step_s'] * 1e3:9.3f} ms per fwd+bwd step")
        log(f"(a) ring_blocked per-step table work (s): "
            f"{bench['ring_blocked']['per_step_compute_s']}")

        # ---- (b) GCNDIST bf16, DIST_PATH / WIRE_DTYPE / MESH auto --------------------
        # on phase 9's graph (0.2 x --scale): at --scale the trials' host
        # table builds alone take ~30 s, and the script must stay well
        # inside its time limit
        os.environ["NTS_DIST_SIMULATE"] = "1"
        os.environ["NTS_TUNE_DIR"] = os.path.join(tmp, "cache")
        s9, d9, dat9 = ggcn_graph(0.2 * scale, seed)
        v9 = dat9.feature.shape[0]
        g9n = build_graph(s9, d9, v9)

        def gcn_cfg(**kw):
            cfg = InputInfo(algorithm="GCNDIST", vertices=v9, layer_string="602-128-41",
                            epochs=3, drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                            weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                            partitions=TUNE_P)
            for k, v in kw.items():
                setattr(cfg, k, v)
            return cfg

        autos = dict(dist_path="auto", wire_dtype="auto", mesh="auto")
        zero_launches()
        tr, recs, build_s = tuned("b_measure", "GCNDIST", gcn_cfg(**autos), s9, d9, dat9,
                                  g9n, "measure")
        dec = report(f"(b) GCNDIST measure (V={v9} E={g9n.e_num})", tr, recs, build_s,
                     n_trials=8)
        check("(b) candidates", len(getattr(tr, "tune_rows", [])) == 8,
              f"{len(getattr(tr, 'tune_rows', []))} candidates, want 1 x 2 x 4")
        costs = {r["label"] for r in of(recs, "program_cost")}
        check("(b) trial costs", all(f"tune.trial/{r['candidate']}" in costs
                                     for r in tr.tune_rows if r["seconds"] is not None),
              f"program_cost labels {sorted(costs)}")
        if dec is not None:
            first = tr.eval_logits()
            t0 = time.perf_counter()
            tr.run()
            torch.cuda.synchronize()
            tuned_losses, tuned_epochs = list(tr.loss_history), list(tr.epoch_times)
            log(f"(b) {dec['candidate']}: 3 epochs {[round(t, 4) for t in tuned_epochs]} s, "
                f"losses {[round(v, 6) for v in tuned_losses]} ({time.perf_counter() - t0:.1f}"
                f" s)")
            del tr
            tr, recs, _ = tuned("b_cached", "GCNDIST", gcn_cfg(**autos), s9, d9, dat9, g9n,
                                "cached")
            dc = of(recs, "tune_decision")
            check("(b) cached replay", len(dc) == 1 and dc[0]["source"] == "cached"
                  and dc[0]["candidate"] == dec["candidate"] and not of(recs, "tune_trial"),
                  f"decisions {dc}, {len(of(recs, 'tune_trial'))} trials")
            del tr
            pin = {k: v for k, v in Candidate.from_label(dec["candidate"]).as_dict().items()
                   if k in autos}
            tp = get_algorithm("GCNDIST").from_arrays(gcn_cfg(**pin), s9, d9, dat9,
                                                      seed=seed, device=dev, host_graph=g9n)
            pfirst = tp.eval_logits()
            tp.run()
            torch.cuda.synchronize()
            check("(b) pinned first logits bitwise", torch.equal(first, pfirst),
                  f"max |d| {float((first - pfirst).abs().max())}")
            check("(b) pinned losses bitwise", tuned_losses == list(tp.loss_history),
                  f"{tuned_losses} vs {tp.loss_history}")
            log(f"(b) pinned {pin}: epochs {[round(t, 4) for t in tp.epoch_times]} s; first "
                f"logits and losses bitwise: {torch.equal(first, pfirst)} / "
                f"{tuned_losses == list(tp.loss_history)}")
            del tp, first, pfirst
        del g9n
        check_no_kernel("phase 18 (b)")
        torch.cuda.empty_cache()
        os.environ.pop("NTS_DIST_SIMULATE", None)

        # ---- (c) GAT f32, KERNEL / ELL_LEVELS auto on phase 7's graph ----------------
        gat_cfg = InputInfo(algorithm="GAT", vertices=g.v_num, layer_string="602-128-41",
                            epochs=1, drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4,
                            decay_rate=0.97, decay_epoch=100, kernel="auto",
                            ell_levels="auto")
        zero_launches()
        tr, recs, build_s = tuned("c", "GAT", gat_cfg, src, dst, datum,
                                  results["gat"]["graph"], "measure")
        report("(c) GAT measure", tr, recs, build_s, n_trials=3)
        tr.run()
        torch.cuda.synchronize()
        check("(c) finite", all(math.isfinite(v) for v in tr.loss_history), tr.loss_history)
        check_no_kernel("phase 18 (c)")
        log(f"(c) {gat_cfg.kernel or 'chain'} {gat_cfg.ell_levels}: epoch "
            f"{tr.epoch_times[0]:.3f} s, loss {tr.loss_history[0]:.6f}")
        del tr
        torch.cuda.empty_cache()

        # ---- (d) GATDIST f32, KERNEL auto, at 0.2 x scale (phase 9's graph) ----------
        os.environ["NTS_DIST_SIMULATE"] = "1"
        g9 = build_graph(s9, d9, v9, weight="ones")
        gd_cfg = InputInfo(algorithm="GATDIST", vertices=v9, layer_string="602-128-41",
                           epochs=1, drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4,
                           decay_rate=0.97, decay_epoch=100, partitions=TUNE_P,
                           kernel="auto")
        zero_launches()
        tr, recs, build_s = tuned("d", "GATDIST", gd_cfg, s9, d9, dat9, g9, "measure")
        report(f"(d) GATDIST measure (V={v9} E={g9.e_num})", tr, recs, build_s, n_trials=2)
        tr.run()
        torch.cuda.synchronize()
        check("(d) finite", all(math.isfinite(v) for v in tr.loss_history), tr.loss_history)
        check_no_kernel("phase 18 (d)")
        log(f"(d) {gd_cfg.kernel or 'mirror chain'}: epoch {tr.epoch_times[0]:.3f} s")
        del tr, g9
        torch.cuda.empty_cache()
        os.environ.pop("NTS_DIST_SIMULATE", None)

        # ---- (e) GCNSAMPLE bf16, SAMPLE_PIPELINE auto at phase 12's shape ------------
        s12, d12, feat, label = planted_partition_graph(
            g.v_num, 41, avg_degree=SAMPLED_DEGREE, feature_size=602, seed=seed)
        dat12 = GNNDatum(feature=feat, label=label,
                         mask=(np.arange(g.v_num) % 3).astype(np.int32))
        g12 = build_graph(s12, d12, g.v_num)
        os.environ.update(NTS_SAMPLE_WORKERS="0", NTS_FINAL_EVAL="0")
        sp_cfg = InputInfo(algorithm="GCNSAMPLE", vertices=g.v_num,
                           layer_string="602-128-41", precision="bfloat16", batch_size=512,
                           fanout_string="25-10", epochs=1, drop_rate=0.0, learn_rate=0.01,
                           weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                           sample_pipeline="auto")
        zero_launches()
        tr, recs, build_s = tuned("e", "GCNSAMPLE", sp_cfg, s12, d12, dat12, g12, "measure")
        report("(e) GCNSAMPLE measure", tr, recs, build_s, n_trials=4)
        tr.run()
        torch.cuda.synchronize()
        check("(e) finite", all(math.isfinite(v) for v in tr.loss_history), tr.loss_history)
        check_no_kernel("phase 18 (e)")
        log(f"(e) {sp_cfg.sample_pipeline or 'sync'}: epoch {tr.epoch_times[0]:.3f} s")
        if hasattr(tr, "close"):
            tr.close()
        del tr, g12

        # ---- (f) the two shipped cfgs through the CLI ----------------------------------
        for name, extra in (("tune", {"NTS_DIST_SIMULATE": "1"}), ("mesh", {"NTS_MESH": "auto"})):
            cfg_path = os.path.join(REPO, "configs", f"gcn_dist_{name}_smoke.cfg")
            os.environ.update(extra, NTS_TUNE_DIR=os.path.join(tmp, f"f_{name}"))
            decided = []
            for mode in ("measure", "cached"):
                mdir = os.path.join(tmp, f"f_{name}_{mode}")
                os.environ.update(NTS_TUNE=mode, NTS_METRICS_DIR=mdir)
                rc = run.main([cfg_path])
                recs = records(mdir)
                dec = of(recs, "tune_decision")
                check(f"(f) {name} {mode}", rc == 0 and len(dec) == 1
                      and dec[0]["source"] == ("measured" if mode == "measure" else "cached")
                      and (mode == "measure" or not of(recs, "tune_trial")),
                      f"rc {rc}, decisions {dec}")
                decided.append(dec[0]["candidate"] if dec else None)
            check(f"(f) {name} same decision", decided[0] == decided[1], decided)
            log(f"(f) configs/gcn_dist_{name}_smoke.cfg: measured {decided[0]}, cached "
                f"{decided[1]}")
            for k in extra:
                os.environ.pop(k, None)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


ELASTIC_EPOCHS = 6
ELASTIC_LOST = 3  # the partition phase 19 (a) kills
STRAGGLER_PART = 5
DEBUG_SUM_RTOL = 0.10  # the DEBUGINFO buckets against the whole step
QUANT_ATOL = 1e-6
ELASTIC_ENV = ("NTS_DIST_SIMULATE", "NTS_ELASTIC", "NTS_HEARTBEAT_MISS_K", "NTS_FAULT_SPEC",
               "NTS_BACKOFF_BASE_S", "NTS_METRICS_DIR", "NTS_STRAGGLER", "NTS_NUMERICS",
               "NTS_QUANT_PROBE", "NTS_DEBUGINFO", "NTS_PALLAS_RESIDENT", "NTS_CKPT_BACKEND",
               "NTS_WIRE_DTYPE", "NTS_TUNE", "NTS_MAX_RESTARTS")


def debuginfo_buckets(report: str) -> dict:
    """{key: ms} of a DEBUGINFO report's ``#key=value(ms)`` lines."""
    out = {}
    for line in report.splitlines():
        if line.startswith("#") and line.endswith("(ms)"):
            key, _, val = line[1:-4].partition("=")
            out[key] = float(val)
    return out


def phase_elastic(dev, g, seed: int, results, scale: float) -> None:
    """Phase 19 (see the module docstring): the rest of the distributed
    plane on the P=8 twin at phase 4's graph, GCNDIST 602-128-41 bf16,
    drop 0: (a) a rank loss replanned 8 -> 7 under supervised_run on the
    ELL route, the kernel on the rebuilt 7-shard tables; (b) the replan
    oracle, bitwise; (c) a slow_rank straggler; (d) numerics and the
    quantisation probe on the bf16 ring; (e) DEBUGINFO for GCNDIST (ELL)
    and GATDIST (chain); (f) the sharded checkpoint backend's resume."""
    import numpy as np
    import torch

    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.models.gat_dist import DistGATTrainer
    from neutronstarlite_torch.models.gcn_dist import DistGCNTrainer
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.resilience import elastic, faults
    from neutronstarlite_torch.resilience.supervisor import supervised_run
    from neutronstarlite_torch.utils.config import InputInfo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 19 on {smi}")
    t_phase = time.perf_counter()
    failures = results["failures"]
    src, dst = results["edges"]
    datum = results["datum"]

    def check(name, ok, detail):
        if not ok:
            failures.append(f"phase 19 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    def cfg_of(epochs, **kw):
        cfg = InputInfo(algorithm="GCNDIST", vertices=g.v_num, layer_string="602-128-41",
                        epochs=epochs, drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                        weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                        partitions=DIST_P, optim_kernel=True)
        for k, val in kw.items():
            setattr(cfg, k, val)
        return cfg

    def build(cfg, cls=DistGCNTrainer, graph=g):
        t0 = time.perf_counter()
        tr = cls.from_arrays(cfg, src, dst, datum, seed=seed, device=dev, host_graph=graph)
        return tr, time.perf_counter() - t0

    def fresh(tr, **kw):
        """The trainer's parameters and histories back to the seed's."""
        for k, val in kw.items():
            setattr(tr.cfg, k, val)
        tr.init_model()
        tr.epoch_times.clear()
        tr.loss_history.clear()
        tr._first_epoch_trained = None

    def of(recs, kind):
        return [r for r in recs if r["event"] == kind]

    saved_env = {k: os.environ.get(k) for k in ELASTIC_ENV}
    for k in ELASTIC_ENV:
        os.environ.pop(k, None)
    os.environ.update(NTS_DIST_SIMULATE="1", NTS_BACKOFF_BASE_S="0")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    faults.reset()
    elastic.reset()
    try:
        # ---- (a) rank loss -> survivor replan 8 -> 7 through the ELL kernel -------------
        os.environ.update(NTS_ELASTIC="1", NTS_HEARTBEAT_MISS_K="1",
                          NTS_FAULT_SPEC=f"rank_loss@partition={ELASTIC_LOST},epoch=2",
                          NTS_METRICS_DIR=os.path.join(tmp, "a_obs"))
        faults.reset()
        tr, t_build = build(cfg_of(ELASTIC_EPOCHS, checkpoint_dir=os.path.join(tmp, "a_ck"),
                                   checkpoint_every=1))
        p_before = tr.metrics.snapshot()["gauges"].get("dist.active_partitions")
        marks = []  # (epoch, partitions, seconds, ell_level launches so far)
        orig_end = tr.end_of_epoch

        def spy(epoch, seconds, stages):
            torch.cuda.synchronize()
            marks.append((epoch, tr.dist.partitions, seconds, ell_level_aggregate.launches))
            orig_end(epoch, seconds, stages)

        tr.end_of_epoch = spy
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = supervised_run(tr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr.metrics.close()
        recs = read_stream(os.path.join(tmp, "a_obs"))
        p_after = tr.metrics.snapshot()["gauges"].get("dist.active_partitions")
        replans, losses_rec = of(recs, "replan"), of(recs, "rank_loss")
        recov = [r for r in of(recs, "recovery") if r.get("action") == "replan"]
        check("(a) replan 8 -> 7", tr.dist.partitions == DIST_P - 1 and len(replans) == 1
              and replans[0]["from_partitions"] == DIST_P
              and replans[0]["to_partitions"] == DIST_P - 1
              and replans[0].get("moved_vertices", 0) > 0, replans)
        check("(a) finite loss", math.isfinite(res["loss"]) and len(tr.loss_history)
              == ELASTIC_EPOCHS, (res["loss"], tr.loss_history))
        check("(a) records", bool(of(recs, "heartbeat")) and len(losses_rec) == 1
              and losses_rec[0]["partition"] == ELASTIC_LOST and len(recov) == 1
              and recov[0].get("partitions") == DIST_P - 1,
              (losses_rec, recov, len(of(recs, "heartbeat"))))
        check("(a) dist.active_partitions", (p_before, p_after) == (DIST_P, DIST_P - 1),
              (p_before, p_after))
        check("(a) ell_level only", launches["ell_level"] > 0 and not launches["bsp_ell"],
              launches)
        per_epoch, last = [], 0
        for epoch, parts, secs, n in marks:
            per_epoch.append((epoch, parts, n - last, secs))
            last = n
        after = [(e, n) for e, parts, n, _ in per_epoch if parts == DIST_P - 1]
        check("(a) ell_level on every epoch after the replan",
              len(after) == ELASTIC_EPOCHS - 2 and all(n > 0 for _, n in after), per_epoch)
        ex = tr.compute_graph
        n_src = tr.dist.partitions * tr.dist.vp
        rng = np.random.default_rng(seed + 19)
        err = 0.0
        for f in (602, 128):
            x = torch.from_numpy(rng.standard_normal((n_src, f), dtype=np.float32)).to(
                dev, torch.bfloat16)
            for direction in ("fwd", "bwd"):
                shards = getattr(ex.tables, direction)
                check(f"(a) {direction} shards", sorted(shards) == list(range(DIST_P - 1)),
                      sorted(shards))
                for p, t in shards.items():
                    got = ell_level_aggregate(t, x)
                    if got.shape != (tr.dist.vp, f):
                        raise AssertionError(f"(a) shard {p}: shape {tuple(got.shape)}")
                    err = max(err, check_close(f"phase 19 (a) rebuilt {direction} shard {p} "
                                               f"f={f} bf16", got, t.plain(x), BF16_TOL))
        before_s = [s for _, parts, _, s in per_epoch if parts == DIST_P][1:]
        after_s = [s for _, parts, _, s in per_epoch if parts == DIST_P - 1][1:]
        log(f"(a) GCNDIST ELL P={DIST_P} -> {tr.dist.partitions} (vp {tr.dist.vp}, n_src "
            f"{n_src}): rank_loss of partition {losses_rec[0]['partition'] if losses_rec else '?'}"
            f" at epoch {losses_rec[0]['epoch'] if losses_rec else '?'}; replan "
            f"{replans[0]['seconds'] if replans else float('nan'):.2f} s (the host rebuild of "
            f"the P=7 plan; the P=8 table build took {tr.build_model_s:.2f} s, the trainer "
            f"{t_build:.2f} s), moved_vertices "
            f"{replans[0].get('moved_vertices') if replans else '?'}; losses "
            f"{[round(x, 6) for x in tr.loss_history]}; per epoch (epoch, P, ell_level "
            f"launches, s) {[(e, p, n, round(s, 4)) for e, p, n, s in per_epoch]}; steady "
            f"epoch before {np.median(before_s) if before_s else float('nan'):.4f} s, after "
            f"{np.median(after_s) if after_s else float('nan'):.4f} s; rebuilt 7-shard "
            f"kernel vs plain max abs err {err:.3e}; peak device memory {peak:.2f} GiB; "
            f"supervised wall {wall:.1f} s; {len(of(recs, 'heartbeat'))} heartbeats")
        results["elastic_per_epoch"] = per_epoch
        del tr, ex
        torch.cuda.empty_cache()
        for k in ("NTS_ELASTIC", "NTS_HEARTBEAT_MISS_K", "NTS_FAULT_SPEC", "NTS_METRICS_DIR"):
            os.environ.pop(k, None)
        faults.reset()
        elastic.reset()

        # ---- (b) the replan oracle, bitwise ---------------------------------------------
        ck_a, ck_b = os.path.join(tmp, "b_ck_a"), os.path.join(tmp, "b_ck_b")
        ta, _ = build(cfg_of(3, checkpoint_dir=ck_a, checkpoint_every=1))
        ta.run()
        shutil.copytree(ck_a, ck_b)
        ta.cfg.epochs = ELASTIC_EPOCHS
        elastic.replan_survivors(ta, ELASTIC_LOST)
        elastic.reset()
        ta.run()
        tb, _ = build(cfg_of(ELASTIC_EPOCHS, partitions=DIST_P - 1, checkpoint_dir=ck_b,
                             checkpoint_every=1))
        tb.run()
        torch.cuda.synchronize()
        post_a = ta.loss_history[3:]
        same_params = all(torch.equal(a, b) for a, b in zip(ta.flat_params, tb.flat_params))
        check("(b) oracle bitwise", post_a == tb.loss_history and same_params,
              (post_a, tb.loss_history, same_params))
        log(f"(b) replanned 8 -> 7 and resumed at 3 vs a fresh P=7 run from a copy of the "
            f"checkpoint: losses {[round(x, 6) for x in post_a]} vs "
            f"{[round(x, 6) for x in tb.loss_history]}, bitwise "
            f"{post_a == tb.loss_history}; final parameters bitwise {same_params}")
        del ta, tb
        torch.cuda.empty_cache()

        # ---- (c) the straggler chaos ---------------------------------------------------
        os.environ.update(NTS_STRAGGLER="1", NTS_METRICS_DIR=os.path.join(tmp, "c_obs"))
        tc, _ = build(cfg_of(5))
        for _ in range(2):
            tc.train_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            tc.train_step()
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) / 3 * 1e3
        sleep_ms = max(5.0 * epoch_ms, 20.0)
        os.environ["NTS_FAULT_SPEC"] = (f"slow_rank@partition={STRAGGLER_PART},"
                                        f"ms={sleep_ms:.1f},times=3")
        faults.reset()
        fresh(tc)
        tc.run()
        tc.metrics.close()
        recs = read_stream(os.path.join(tmp, "c_obs"))
        strag = of(recs, "straggler")
        check("(c) one straggler naming partition 5",
              [r["partition"] for r in strag] == [STRAGGLER_PART], strag)
        check("(c) no rank_loss", not of(recs, "rank_loss"), of(recs, "rank_loss"))
        log(f"(c) slow_rank@partition={STRAGGLER_PART},ms={sleep_ms:.1f},times=3 (about 5x "
            f"the {epoch_ms:.2f} ms step) with NTS_STRAGGLER=1: straggler records "
            f"{[(r['partition'], r['epoch'], round(r['excess'], 2)) for r in strag]}, "
            f"rank_loss records {len(of(recs, 'rank_loss'))}, slow_rank injections "
            f"{sum(1 for r in of(recs, 'fault') if r.get('kind') == 'slow_rank')}")
        for k in ("NTS_STRAGGLER", "NTS_FAULT_SPEC", "NTS_METRICS_DIR"):
            os.environ.pop(k, None)
        faults.reset()

        # ---- (e) DEBUGINFO: GCNDIST on the ELL route, GATDIST's chain -------------------
        reports = {"GCNDIST ELL": tc.debug_info()}
        gat = results["gat"]
        tg, _ = build(InputInfo(algorithm="GATDIST", vertices=g.v_num,
                                layer_string="602-128-41", epochs=1, drop_rate=0.0,
                                learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
                                decay_epoch=100, partitions=DIST_P),
                      cls=DistGATTrainer, graph=gat["graph"])
        reports["GATDIST chain"] = tg.debug_info()
        del tg
        torch.cuda.empty_cache()
        for name, report in reports.items():
            b = debuginfo_buckets(report)
            parts = sum(b.get(k, -1.0) for k in ("nn_time", "graph_time", "backward_time",
                                                  "update_time"))
            step = b.get("all_train_step_time", 0.0)
            check(f"(e) {name} buckets", len(b) == 6 and all(v >= 0 for v in b.values())
                  and abs(parts - step) <= DEBUG_SUM_RTOL * step, b)
            log(f"(e) DEBUGINFO {name} (CUDA events, median of 3): "
                f"{' '.join(f'{k}={v:.3f}' for k, v in b.items())} ms; buckets sum "
                f"{parts:.3f} ms vs step {step:.3f} ms")

        # ---- (f) the sharded checkpoint backend: 3 + 3 against 6 ------------------------
        fresh(tc, epochs=ELASTIC_EPOCHS)
        tc.run()
        straight = list(tc.loss_history)
        ck_f = os.path.join(tmp, "f_ck")
        fresh(tc, epochs=3, checkpoint_dir=ck_f, checkpoint_every=1, ckpt_backend="orbax")
        t0 = time.perf_counter()
        tc.run()
        first = list(tc.loss_history)
        t_first = time.perf_counter() - t0
        del tc
        td, _ = build(cfg_of(ELASTIC_EPOCHS, checkpoint_dir=ck_f, checkpoint_every=1,
                             ckpt_backend="orbax"))
        td.run()
        torch.cuda.synchronize()
        resumed = first + td.loss_history
        steps = sorted(os.listdir(os.path.join(ck_f, "orbax")))
        check("(f) sharded resume bitwise", resumed == straight and td._first_epoch_trained == 3,
              (resumed, straight, td._first_epoch_trained))
        log(f"(f) CKPT_BACKEND:orbax (torch.distributed.checkpoint, asynchronous): 3 epochs "
            f"({t_first:.2f} s with a save per epoch), then a new trainer resumed at "
            f"{td._first_epoch_trained}: losses {[round(x, 6) for x in resumed]} vs the "
            f"straight 6 {[round(x, 6) for x in straight]}, bitwise {resumed == straight}; "
            f"steps kept {steps}")
        del td
        torch.cuda.empty_cache()

        # ---- (d) numerics and the quantisation probe on the bf16 ring -------------------
        # on phase 9's graph (0.2 x --scale): at --scale the ring's host
        # table build alone takes ~9 s, and the script must stay well
        # inside its time limit
        os.environ.update(NTS_QUANT_PROBE="1", NTS_METRICS_DIR=os.path.join(tmp, "d_obs"))
        s9, d9, dat9 = ggcn_graph(0.2 * scale, seed)
        g9 = build_graph(s9, d9, dat9.feature.shape[0])
        tn = DistGCNTrainer.from_arrays(
            cfg_of(2, optim_kernel=False, dist_path="ring_blocked_sim", wire_dtype="bf16",
                   vertices=g9.v_num), s9, d9, dat9, seed=seed, device=dev, host_graph=g9)
        zero_launches()
        tn.run()
        off, off_s = list(tn.loss_history), steady_s(tn.epoch_times)
        fresh(tn)
        os.environ["NTS_NUMERICS"] = "1"
        tn.run()
        on = list(tn.loss_history)
        check("(d) no kernel", not any(kernel_launches().values()), kernel_launches())
        gauge = tn.metrics.snapshot()["gauges"].get("wire.quant_rel_err")
        x64 = tn.feature.detach().cpu().double()
        q64 = tn.feature.detach().cpu().to(torch.bfloat16).double()
        host = float((q64 - x64).square().mean().sqrt() / x64.square().mean().sqrt())
        tn.metrics.close()
        recs = read_stream(os.path.join(tmp, "d_obs"))
        names = {r["name"] for r in of(recs, "tensor_stats")}
        want = {"params/l0", "params/l1", "grads/l0", "grads/l1", "acts/l0", "acts/l1",
                "logits", "wire/l0", "wire.payload/l0"}
        check("(d) numerics bitwise", on == off, (on, off))
        check("(d) tensor_stats groups", want <= names, sorted(names))
        check("(d) quant_rel_err", gauge is not None and abs(gauge - host) <= QUANT_ATOL,
              (gauge, host))
        log(f"(d) GCNDIST bf16 ring_blocked_sim WIRE_DTYPE:bf16: losses off "
            f"{[round(x, 6) for x in off]}, NTS_NUMERICS=1 bitwise {on == off}; "
            f"tensor_stats groups {sorted(names)}; wire.quant_rel_err {gauge!r} vs host "
            f"{host!r} (|d| {abs((gauge or 0) - host):.2e}); steady epoch off {off_s:.4f} s, "
            f"on {steady_s(tn.epoch_times):.4f} s")
        del tn, g9
        torch.cuda.empty_cache()
    finally:
        faults.reset()
        elastic.reset()
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        keep(results, "phase19", *(os.path.join(tmp, d) for d in ("a_obs", "c_obs", "d_obs")))
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")


LIVE_MARGIN = 256  # phase 20's reserved vertex rows
LIVE_IDS = 64  # vertices per checked flush: dirty and clean (the top bucket)
LIVE_BASE_S = 4.0  # (c)'s load without deltas, seconds


class _HeldServers:
    """Pipelined servers whose executors wait on one event before each
    flush: a flush prepared before a delta is held while the delta waits
    for it (``InferenceServer.drain_prepared``)."""

    def __init__(self, engines):
        import threading

        from neutronstarlite_torch.serve.server import InferenceServer

        self.release = threading.Event()
        self.servers = {}
        for mode, eng in engines.items():
            server = InferenceServer(eng)
            run = server._execute_prepared

            def held(*args, _run=run):
                self.release.wait(300)
                return _run(*args)

            server._execute_prepared = held
            self.servers[mode] = server

    def close(self):
        self.release.set()
        for server in self.servers.values():
            server.close()


def phase_live_graph(dev, seed: int, results, scale: float) -> None:
    """Phase 20: graph deltas under running engines, servers and a fleet,
    the delta log, stream ingest with its capacity margin and the fine-tune
    worker, on the card (see the module docstring, item 20). A failed check
    prints FAILED and fails the run at the end."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from neutronstarlite_torch.graph.dataset import GNNDatum
    from neutronstarlite_torch.graph.storage import build_graph
    from neutronstarlite_torch.models.gcn_sample import GCNSampleTrainer
    from neutronstarlite_torch.resilience import faults
    from neutronstarlite_torch.serve.batcher import ServeOptions
    from neutronstarlite_torch.serve.delta import GraphDelta, apply_to_servers, plan_delta
    from neutronstarlite_torch.serve.engine import InferenceEngine
    from neutronstarlite_torch.serve.fleet import ReplicaSet
    from neutronstarlite_torch.stream.finetune import FineTuneWorker
    from neutronstarlite_torch.stream.ingest import StreamIngestor, reserve_feature_margin
    from neutronstarlite_torch.stream.log import read_log_entries
    from neutronstarlite_torch.tools import graph_gen
    from neutronstarlite_torch.utils.config import InputInfo

    t_phase = time.perf_counter()
    # on phase 9's graph (0.2 x --scale): at --scale each delta's host plan
    # and apply take 6-9 s, and the script must stay inside its time limit
    src, dst, datum = ggcn_graph(0.2 * scale, seed)
    g = build_graph(src, dst, datum.feature.shape[0])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 20 on {smi}")
    failures = []

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"phase 20 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    work = tempfile.mkdtemp(prefix="chip_smoke_live_")
    saved_env = {k: os.environ.get(k) for k in (
        "NTS_FINAL_EVAL", "NTS_SAMPLE_WORKERS", "NTS_SAMPLE_PIPELINE", "NTS_METRICS_DIR",
        "NTS_FAULT_SPEC", "NTS_SERVE_CB", "NTS_STREAM_VERTEX_MARGIN")}
    for k in saved_env:
        os.environ.pop(k, None)
    os.environ["NTS_FINAL_EVAL"] = "0"
    os.environ["NTS_SAMPLE_WORKERS"] = "0"
    modes = ("sync", "device", "fused")
    V = g.v_num
    rng = np.random.default_rng(seed + 20)
    held = None
    zero_launches()
    try:
        ckpt = os.path.join(work, "ck")

        def make_cfg(v):
            return InputInfo(
                algorithm="GCNSAMPLE", vertices=v, layer_string="602-128-41",
                precision="bfloat16", batch_size=512, fanout_string="25-10", epochs=1,
                drop_rate=0.0, learn_rate=0.01, weight_decay=1e-4, decay_rate=0.97,
                decay_epoch=100, sample_pipeline="fused", checkpoint_dir=ckpt,
                serve_buckets="1-4-16-64", serve_max_batch=64, serve_max_wait_ms=2.0,
                serve_max_queue=1024,
            )

        cfg = make_cfg(V)
        t0 = time.perf_counter()
        tr = GCNSampleTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                          host_graph=g)
        tr.run()
        torch.cuda.synchronize()
        log(f"trained GCN 602-128-41 bf16 fused 1 epoch (loss {tr.loss_history[0]:.6f}) into "
            f"a checkpoint in {time.perf_counter() - t0:.1f} s (trainer build included); "
            f"device table {tuple(tr.par_sampler.hop_sampler.nbr.shape)}, "
            f"{tr.par_sampler.hop_sampler.thinned} vertices pre-thinned")
        base = ServeOptions.from_cfg(cfg)

        def opts(mode, **kw):
            return dataclasses.replace(base, sample_pipeline=mode, **kw)

        def fresh_engines(plan, rows=None):
            """The oracle: a new toolkit over the plan's edge list (its fused
            neighbour table serves the device mode too), restored from the
            same checkpoint, one engine per mode."""
            d = datum
            if rows is not None:
                k = sum(len(r) for r in rows)
                d = GNNDatum(feature=np.concatenate([datum.feature, *rows]),
                             label=np.concatenate([datum.label, np.zeros(k, np.int32)]),
                             mask=np.concatenate([datum.mask, np.full(k, 2, np.int32)]))
            # a delta rebuilds its graph with NumPy, as JAX's does: the
            # oracle is the NumPy build of the same edge list
            g2 = build_graph(plan.src, plan.dst, plan.v_num, use_native=False)
            tk = GCNSampleTrainer.from_arrays(make_cfg(plan.v_num), plan.src, plan.dst, d,
                                              seed=seed, device=dev, host_graph=g2)
            return {m: InferenceEngine(tk, ckpt, options=opts(m),
                                       rng=np.random.default_rng(0)) for m in modes}

        # (a) one engine per mode over the trained toolkit, the margin first
        engines = {m: InferenceEngine(tr, ckpt, options=opts(m, continuous_batching=True),
                                      rng=np.random.default_rng(seed)) for m in modes}
        reserve_feature_margin(list(engines.values()), LIVE_MARGIN)
        for eng in engines.values():
            eng.warmup()
        torch.cuda.synchronize()
        want_counts = {b: 1 for b in SERVE_BUCKETS}
        check("(a) one capture per bucket", all(e.compile_counts == want_counts
                                                for e in engines.values()),
              f"{[e.compile_counts for e in engines.values()]}")

        def addresses():
            hs = tr.par_sampler.hop_sampler
            out = [engines["sync"].feature.data_ptr(), hs.nbr.data_ptr(),
                   hs.eff_deg.data_ptr()]
            return out + [t.data_ptr() for t in engines["fused"]._fused_tables()[2:]]

        ptrs0 = addresses()
        twins = {m: e.clone(rng=np.random.default_rng(seed + 1)) for m, e in engines.items()}
        held = _HeldServers({m: e.clone(rng=np.random.default_rng(seed + 1))
                             for m, e in engines.items()})
        def quiet(k):
            """k vertices of least in-degree: wiring appends to them keeps the
            table's width."""
            deg = tr.host_graph.in_degree
            return np.argsort(deg, kind="stable")[:k]

        def append_delta(k):
            v0 = tr.host_graph.v_num
            peers = quiet(k)
            feats = (rng.standard_normal((k, 602)) * 0.1).astype(np.float32)
            add = [(int(p), v0 + i) for i, p in enumerate(peers)] + \
                [(v0 + i, int(p)) for i, p in enumerate(peers)]
            return GraphDelta.edges(add=add, add_vertices=k, add_features=feats), feats

        def run_delta(tag, delta, rows, expect_counts, expect_same_ptrs):
            gph = tr.host_graph
            t0 = time.perf_counter()
            plan = plan_delta(gph, delta, hops=2)
            plan_s = time.perf_counter() - t0
            clean = np.setdiff1d(np.arange(gph.v_num), plan.dirty)
            dirty = plan.dirty[plan.dirty < gph.v_num]  # the ids a pre-delta flush knows
            n_clean = min(LIVE_IDS // 2, len(clean))  # a 2-hop closure may dirty them all
            pick = np.concatenate([rng.choice(dirty, LIVE_IDS - n_clean, replace=False),
                                   rng.choice(clean, n_clean, replace=False)])
            ids = np.unique(pick)
            for m in modes:  # the twin draws what the held server will draw
                twins[m].sampler.rng.bit_generator.state = \
                    held.servers[m].engine.sampler.rng.bit_generator.state
            want_pre = {m: twins[m].predict(ids) for m in modes}
            held.release.clear()
            reqs = {m: held.servers[m].submit(ids) for m in modes}
            deadline = time.perf_counter() + 120
            while any(s._prepared == 0 for s in held.servers.values()) \
                    and time.perf_counter() < deadline:
                time.sleep(0.005)
            out = {}

            def apply():
                out["plan"] = apply_to_servers(
                    list(held.servers.values()), delta,
                    extra_engines=list(engines.values()) + list(twins.values()), plan=plan)

            th = threading.Thread(target=apply)
            th.start()
            time.sleep(0.3)
            waited = th.is_alive()
            t1 = time.perf_counter()
            held.release.set()
            th.join(180)  # drain_prepared gives up after 120 s
            torch.cuda.synchronize()
            apply_s = time.perf_counter() - t1
            check(f"{tag} the delta waited for the prepared flushes", waited)
            check(f"{tag} applied", "plan" in out)
            same_pre = {m: np.array_equal(reqs[m].result(timeout=120), want_pre[m])
                        for m in modes}
            check(f"{tag} prepared flush answers pre-delta", all(same_pre.values()),
                  f"{same_pre}")
            fresh = fresh_engines(plan, rows)
            post_ids = ids if not plan.added_vertices else np.unique(np.concatenate(
                [ids[: LIVE_IDS - 8], np.arange(plan.v_num - min(8, plan.added_vertices),
                                                plan.v_num)]))
            same_post = {}
            for m in modes:
                srv = held.servers[m]
                fresh[m].sampler.rng.bit_generator.state = srv.engine.sampler.rng.bit_generator.state
                got = srv.predict(post_ids, timeout=120)
                same_post[m] = got.shape == (len(post_ids), 41) and bool(np.isfinite(got).all()) \
                    and np.array_equal(got, fresh[m].predict(post_ids))
            check(f"{tag} next flush == fresh engine", all(same_post.values()), f"{same_post}")
            for eng in engines.values():
                eng.warmup()
            torch.cuda.synchronize()
            counts = [e.compile_counts for e in engines.values()]
            check(f"{tag} captures", all(c == expect_counts for c in counts), f"{counts}")
            check(f"{tag} captured tensors in place", (addresses() == ptrs0) == expect_same_ptrs,
                  f"{addresses()} vs {ptrs0}")
            check_no_kernel(f"phase 20 {tag}")
            log(f"{tag}: +{plan.added_edges}e -{plan.removed_edges}e +{plan.added_vertices}v, "
                f"dirty rows {len(plan.dirty_rows)}, dirty predictions {len(plan.dirty)} of "
                f"{plan.v_num} ({n_clean} clean vertices checked), "
                f"rows patched {out['plan'].rows_patched if 'plan' in out else None}; "
                f"plan_delta {plan_s:.3f} s, apply {apply_s:.3f} s (host clock, the held "
                f"flushes included); prepared flush pre-delta bitwise {same_pre}; next flush "
                f"({len(post_ids)} vertices) == fresh engine {same_post}; captures {counts[0]}")
            del fresh
            return plan_s, apply_s

        d1_add = [(int(a), int(b)) for a, b in rng.integers(0, V, size=(64, 2))]
        old_e = rng.choice(g.e_num, 16, replace=False)
        d1_rm = [(int(g.row_indices[i]), int(g.dst_of_edge[i])) for i in old_e]
        host_s = [run_delta("(a) edge-only delta", GraphDelta.edges(add=d1_add, remove=d1_rm),
                            None, want_counts, True)]
        d2, f2 = append_delta(8)
        host_s.append(run_delta("(a) 8 vertices within the margin", d2, [f2], want_counts,
                                True))
        # (b) past the margin: the slab grows, the ladders capture again
        d3, f3 = append_delta(LIVE_MARGIN - 8 + 1)
        host_s.append(run_delta("(b) overflow", d3, [f2, f3], {b: 2 for b in SERVE_BUCKETS},
                                False))
        held.close()
        held = None
        del engines, twins
        torch.cuda.empty_cache()

        # (c) the stream into a 2-replica fused fleet, beside the same load,
        # at the rate the host sustains: one delta per (a) and (b)'s median
        # plan + apply seconds
        per_delta_s = float(np.median([p + a for p, a in host_s]))
        rate = 1.0 / per_delta_s
        head = tr.host_graph
        n_sub = min(head.e_num, 200_000)  # the trace's removal pool
        trace = graph_gen.delta_trace(head.row_indices[:n_sub], head.dst_of_edge[:n_sub],
                                      head.v_num, 602, rounds=1, writers=2, vertex_every=1,
                                      seed=seed)
        root = os.path.join(work, "log")
        t0 = time.perf_counter()
        dlog = graph_gen.write_trace_log(root, head, trace)
        log_s = time.perf_counter() - t0
        eng_c = InferenceEngine(tr, ckpt, options=opts("fused", cache_cap=4096),
                                rng=np.random.default_rng(seed))
        ing = StreamIngestor([eng_c], margin=LIVE_MARGIN, dirty_mode="exact")
        ing.arm()
        eng_c.warmup()
        torch.cuda.synchronize()
        counts_c = dict(eng_c.compile_counts)

        def load(fleet, stop):
            errors = []

            def client(i):
                r = np.random.default_rng(seed + 100 + i)
                while not stop.is_set():
                    try:
                        fleet.submit(r.integers(0, V, 1)).result(timeout=30)
                    except Exception as e:  # counted, the load goes on
                        errors.append(repr(e))

            ts = [threading.Thread(target=client, args=(i,), daemon=True)
                  for i in range(SERVE_CLIENTS)]
            for t in ts:
                t.start()
            return ts, errors

        def serve_leg(with_stream):
            fleet = ReplicaSet.from_engine(eng_c, 2, options=opts("fused", cache_cap=4096),
                                           seed=seed)
            ing.servers = [r.server for r in fleet.replicas]
            stop = threading.Event()
            t0 = time.perf_counter()
            ts, errors = load(fleet, stop)
            applied = []
            if with_stream:
                for e in read_log_entries(root):
                    t_begin = time.monotonic()
                    plan = ing.apply(e)
                    applied.append((t_begin, set(plan.dirty.tolist())))
                    time.sleep(max(0.0, 1.0 / rate - (time.monotonic() - t_begin)))
            else:
                time.sleep(LIVE_BASE_S)
            stop.set()
            deadline = time.perf_counter() + 60
            for t in ts:
                t.join(max(0.0, deadline - time.perf_counter()))
            errors += [f"client {i} still waiting" for i, t in enumerate(ts) if t.is_alive()]
            wall = time.perf_counter() - t0
            stale = 0
            for r in fleet.replicas:
                for vid, (t_ins, _row) in list(r.server.cache._rows.items()):
                    stale += sum(1 for t_begin, dirty in applied
                                 if vid in dirty and t_ins < t_begin)
            st = fleet.close()
            return st, errors, applied, stale, wall

        base_st, base_err, _, _, base_wall = serve_leg(False)
        st, errors, applied, stale, wall = serve_leg(True)
        check_no_kernel("phase 20 (c)")
        check("(c) stream applied", len(applied) == dlog.head_seq == 2
              and eng_c.graph_digest() == dlog.head_digest,
              f"{len(applied)} of {dlog.head_seq}")
        check("(c) no error", not errors and not base_err and st["shed"] == 0,
              f"{errors[:3]} {base_err[:3]} shed {st['shed']}")
        check("(c) no capture after warm-up", eng_c.compile_counts == counts_c,
              f"{eng_c.compile_counts}")
        check("(c) no pre-delta row in the cache", stale == 0, f"{stale}")
        for name, s_, w in (("without deltas", base_st, base_wall),
                            (f"with the stream at {rate:.3f}/s", st, wall)):
            lat = s_["latency_ms"]
            log(f"(c) fleet of 2 fused replicas, {SERVE_CLIENTS} closed-loop clients, {name}: "
                f"{s_['requests']} served in {w:.1f} s ({s_['requests'] / w:.1f} requests/s), "
                f"p50 {lat['p50']:.3f} / p99 {lat['p99']:.3f} ms, shed {s_['shed']}")
        log(f"(c) trace: 1 round x 2 writers (vertex_every 1) written to the log in "
            f"{log_s:.1f} s; {len(applied)} entries applied at {rate:.3f}/s (one per the "
            f"{per_delta_s:.2f} s of (a) and (b)'s median plan + apply), digest == log head "
            f"{eng_c.graph_digest() == dlog.head_digest}; captures {eng_c.compile_counts}; "
            f"cached rows older than a delta that dirtied them: {stale}")

        # (d) the fine-tune worker over the stream's dirty region
        weights0 = [w.clone() for w in eng_c.weights]
        ck_ft = os.path.join(work, "ft")
        worker = FineTuneWorker(tr, ing, ck_ft, seed=seed)  # 4 x BATCH_SIZE seeds
        torch.cuda.synchronize()
        s = worker.drain_once()
        n_seeds = min(4 * cfg.batch_size, int((datum.mask == 0).sum()))
        check("(d) a round", s is not None and s["batches"] == -(-n_seeds // 512)
              and np.isfinite(s["loss"]), f"{s}")
        check("(d) serving weights untouched", all(torch.equal(a, b) for a, b in
                                                   zip(weights0, eng_c.weights)))
        restored = InferenceEngine(tr, ck_ft, options=opts("sync"),
                                   rng=np.random.default_rng(seed))
        ok = restored.ckpt_step == 0 and bool(np.isfinite(restored.predict(
            np.arange(8))).all()) and all(torch.equal(w, p["W"].detach()) for w, p in
                                          zip(restored.weights, tr.params))
        check("(d) the checkpoint restores", ok)

        class Region:
            head_seq = 3

            def take_dirty(self):
                return np.arange(0, V, 97), 3, 3

        os.environ["NTS_FAULT_SPEC"] = "exc@point=finetune_round"
        faults.reset()
        chaos = FineTuneWorker(tr, Region(), ck_ft, seeds_per_round=512, max_retries=2,
                               seed=seed)
        s2 = chaos.drain_once()
        fired = [sp.fired for sp in faults.active_plan()]
        os.environ.pop("NTS_FAULT_SPEC")
        faults.reset()
        check("(d) exc@point=finetune_round rolls through", s2 is not None and fired == [1]
              and chaos.rounds == 1, f"{s2} fired {fired}")
        check_no_kernel("phase 20 (d)")
        log(f"(d) fine-tune drain over seq {s['seq_lo']}..{s['seq_hi']} ({s['dirty']} dirty "
            f"vertices): {s['batches']} batches, loss {s['loss']:.6f}, {s['seconds']:.2f} s "
            f"(checkpoint save included, host clock); serving weights untouched; the "
            f"checkpoint restored into an engine (step {restored.ckpt_step}); "
            f"exc@point=finetune_round fired {fired} and the retried round finished "
            f"({s2['seconds'] if s2 else None} s)")
        check_no_kernel("phase 20")
        log(f"(e) both kernels' launch counts 0 through phase 20: {kernel_launches()}")
    finally:
        if held is not None:
            held.close()
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    results["failures"].extend(failures)


# phase 21: cross-host serving. The model of phase 14 (its checkpoint)
# served by replica PROCESSES behind serve/crosshost's HTTP router; every
# child reads phase 4's graph from files, restores and captures on its own
XH_REPLICAS = 2  # the fleet's children; serve_router's one makes 3 spawned at once
XH_RPS = 100.0  # the open-loop load under the kill and under the roll
XH_PROBES = ((21, 16), (22, 64))  # (replay seed, vertices) of (d)'s probes
XH_REQUESTS = 1000  # (e)'s closed-loop requests through serve_bench --targets
XH_WAIT_S = 120.0  # the bound of every wait for a child


def compute_apps() -> dict:
    """pid -> MiB of every compute process nvidia-smi lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    apps = {}
    for ln in out.splitlines():
        parts = [p.strip() for p in ln.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = parts[1]
    return apps


def mib(apps: dict) -> float:
    """The MiB of nvidia-smi's compute apps, summed."""
    return sum(float(v) for v in apps.values() if v.replace(".", "", 1).isdigit())


def fmt_ms(v) -> str:
    return f"{v:.3f}" if isinstance(v, (int, float)) else "n/a"


def open_load(fleet, v_num: int, seed: int):
    """serve_bench's open loop on ``fleet`` at XH_RPS (one vertex a request)
    in a thread, until the function returned is called; that returns the
    requests sent and the errors among them."""
    import threading

    from neutronstarlite_torch.tools.serve_bench import run_open_loop

    halt, reqs, out = threading.Event(), [], {}
    thread = threading.Thread(target=lambda: out.update(errors=run_open_loop(
        fleet, v_num, 0, XH_RPS, 1, seed, done=reqs, stop=halt)), daemon=True)
    thread.start()

    def stop():
        halt.set()
        thread.join(timeout=XH_WAIT_S + 30)
        return reqs, out.get("errors", len(reqs))

    return stop


def stop_router(proc) -> None:
    """End a serve_router process as ^C does (it closes its fleet, so its
    children go with it), then kill it if it lingers."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def drift_checkpoint(src: str, dst: str) -> str:
    """A copy of checkpoint ``src`` whose float leaves are x * 1.5 + 0.25,
    its digests made valid again (it passes the rollout's preflight)."""
    import numpy as np

    from neutronstarlite_torch.utils import checkpoint as ckpt_mod

    shutil.copytree(src, dst)
    for _step, d in ckpt_mod.list_steps(dst):
        path = os.path.join(d, ckpt_mod.ARRAYS)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, ckpt_mod.MANIFEST)) as fh:
            manifest = json.load(fh)
        for k, a in arrays.items():
            if a.dtype.kind == "f":
                arrays[k] = (a * 1.5 + 0.25).astype(a.dtype)
                manifest["arrays"][k]["sha256"] = ckpt_mod._leaf_digest(arrays[k])
        np.savez(path, **arrays)
        with open(os.path.join(d, ckpt_mod.MANIFEST), "w") as fh:
            json.dump(manifest, fh)
    return dst


def phase_crosshost(dev, g, seed: int, results) -> None:
    """Phase 21: cross-host serving on the card (see the module docstring,
    item 21). On a CPU ``dev`` (a dry run) the children get ``--device
    cpu``. A failed check prints FAILED and fails the run at the end."""
    import gc

    import numpy as np
    import torch

    from neutronstarlite_torch.graph.prep import (
        _write_edges_binary,
        _write_feature_table,
        _write_label_table,
        _write_mask,
    )
    from neutronstarlite_torch.obs import httpc, ledger
    from neutronstarlite_torch.obs import registry as obs_registry
    from neutronstarlite_torch.resilience import faults
    from neutronstarlite_torch.serve import crosshost
    from neutronstarlite_torch.serve.engine import InferenceEngine
    from neutronstarlite_torch.tools import serve_bench, trace_timeline
    from neutronstarlite_torch.tools.metrics_report import expand_paths
    from neutronstarlite_torch.utils.config import InputInfo

    t_phase = time.perf_counter()
    src, dst = results["edges"]
    datum = results["datum"]
    V = g.v_num
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"phase 21 on {smi}")
    failures = []

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"phase 21 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    ckpt = results.pop("serve_ckpt", None)
    child_dev = None if dev.type == "cuda" else dev.type  # a CPU dry run's children
    work = tempfile.mkdtemp(prefix="chip_smoke_xhost_")
    saved_env = {k: os.environ.get(k) for k in (
        "NTS_METRICS_DIR", "NTS_TRACE", "NTS_FAULT_SPEC", "NTS_LEDGER_DIR", "NTS_METRICS_PORT",
        "NTS_SLO_SPEC", "NTS_SAMPLE_PIPELINE", "NTS_HUB_MISS_K", "NTS_FINAL_EVAL")}
    for k in saved_env:
        os.environ.pop(k, None)
    children_dir = os.path.join(work, "children")  # the replicas' streams
    bench_dir = os.path.join(work, "bench")  # serve_bench's router stream
    ledger_dir = os.path.join(work, "ledger")
    fleet = cli = None
    pids = set()  # every child process this phase started
    zero_launches()
    try:
        check("(a) phase 14's checkpoint", ckpt is not None, "phase 14 left none")
        if ckpt is None:
            return
        # phase 4's graph, features, labels and masks as the cfg's files
        t0 = time.perf_counter()
        data = os.path.join(work, "data")
        os.makedirs(data)
        _write_edges_binary(os.path.join(data, "edges.bin"), src, dst)
        feature_file = _write_feature_table(os.path.join(data, "features"), datum.feature,
                                            text=False)
        _write_label_table(os.path.join(data, "labels.txt"), datum.label)
        _write_mask(os.path.join(data, "mask.txt"), datum.mask)
        cfg_path = os.path.join(work, "serve.cfg")
        with open(cfg_path, "w") as fh:
            fh.write("\n".join([
                "ALGORITHM:GCNSAMPLE", f"VERTICES:{V}", "LAYERS:602-128-41",
                "PRECISION:bfloat16", "BATCH_SIZE:512", "FANOUT:25-10", "EPOCHS:2",
                "DROP_RATE:0", "LEARN_RATE:0.01", "WEIGHT_DECAY:0.0001",
                "SAMPLE_PIPELINE:fused", "SERVE_BUCKETS:1-4-16-64", "SERVE_MAX_BATCH:64",
                "SERVE_MAX_WAIT_MS:2", "SERVE_MAX_QUEUE:1024",
                f"EDGE_FILE:{os.path.join(data, 'edges.bin')}",
                f"FEATURE_FILE:{feature_file}",
                f"LABEL_FILE:{os.path.join(data, 'labels.txt')}",
                f"MASK_FILE:{os.path.join(data, 'mask.txt')}",
            ]) + "\n")
        log(f"wrote phase 4's graph ({len(src):,} edges), features {datum.feature.shape}, "
            f"labels and masks and a GCNSAMPLE fused serve cfg in "
            f"{time.perf_counter() - t0:.1f} s")
        apps0 = compute_apps()
        router_reg = obs_registry.MetricsRegistry(
            "router-chip-smoke", algorithm="ROUTER", fingerprint="f",
            path=os.path.join(work, "router.jsonl"))

        # (a) three replica processes, spawned together: the fleet's
        # XH_REPLICAS and the one of tools/serve_router (a process of its
        # own), which is offered a drifted candidate once its child serves
        # and runs beside (a) and (b)
        drifted = drift_checkpoint(ckpt, os.path.join(work, "drift"))
        t0 = t_cli = time.perf_counter()
        cli_log = os.path.join(work, "serve_router.log")
        with open(cli_log, "w") as fh:
            cli = subprocess.Popen(
                [sys.executable, "-m", "neutronstarlite_torch.tools.serve_router", cfg_path,
                 ckpt, "--replicas", "1", "--rollout", drifted, "--rollout-after", "1",
                 "--polls", "2", "--json", "--spawn-dir", os.path.join(work, "router_spawn")]
                + (["--device", child_dev] if child_dev else []),
                cwd=REPO, stdout=fh, stderr=subprocess.STDOUT,
                env=dict(os.environ, NTS_METRICS_DIR=os.path.join(work, "router_cli"),
                         NTS_PROGRAM_COST="0"),
            )
        fleet = crosshost.CrossHostFleet.spawn(
            cfg_path, ckpt, XH_REPLICAS, spawn_dir=os.path.join(work, "spawn"), seed=seed,
            # the children's streams carry their spans; no program_cost
            # record is counted per bucket (its flop counter cost ~5 s of
            # each start on the card)
            extra_env={"NTS_METRICS_DIR": children_dir, "NTS_TRACE": "1",
                       "NTS_PROGRAM_COST": "0"},
            registry=router_reg, ledger_dir=ledger_dir, spawn_timeout_s=XH_WAIT_S,
            device=child_dev,
        )
        spawn_s = time.perf_counter() - t0
        apps = compute_apps()
        for r in fleet.replicas:
            pids.add(r.proc.pid)
            su = r.startup or {}
            check(f"(a) {r.rid} startup split", all(k in su for k in (
                "import_s", "cuda_init_s", "graph_s", "model_s", "restore_s", "capture_s")),
                f"{su}")
            log(f"(a) {r.rid} pid {r.proc.pid} at {r.base_url}: startup "
                + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in su.items())
                + f"; nvidia-smi {apps.get(r.proc.pid, 'not listed by pid')} MiB")
        log(f"(a) the fleet's {XH_REPLICAS} children up in {spawn_s:.1f} s, spawned together "
            f"with serve_router's; nvidia-smi --query-compute-apps pid: MiB before {apps0}, "
            f"after {apps} (this process, serve_router and the 3 children: "
            f"+{mib(apps) - mib(apps0):.0f} MiB)")
        check("(a) every replica beating", all(s["beating"] for s in fleet.route_states()),
              f"{fleet.route_states()}")

        # (b) SIGKILL one child under open-loop load
        shed0 = fleet.stats()["shed"]
        stop = open_load(fleet, V, seed + 1)
        time.sleep(1.0)
        victim = fleet.replicas[1]
        t_kill = time.perf_counter()
        os.kill(victim.proc.pid, signal.SIGKILL)
        deadline = t_kill + XH_WAIT_S
        while victim.restarts == 0 and time.perf_counter() < deadline:
            time.sleep(0.02)
        back_s = time.perf_counter() - t_kill
        time.sleep(0.5)
        reqs, errors = stop()
        pids.add(victim.proc.pid)
        shed = fleet.stats()["shed"] - shed0
        cl = serve_bench.client_latency_ms(reqs)
        check("(b) restart under load", victim.restarts == 1 and errors == 0 and shed == 0,
              f"restarts {victim.restarts}, errors {errors}, shed {shed}")
        log(f"(b) SIGKILL of r1 under {XH_RPS:.0f} requests/s open loop: respawned "
            f"{back_s:.2f} s after the kill (the respawn itself {victim.restart_s} s, "
            f"startup {victim.startup}); {len(reqs)} requests, {errors} errors, {shed} shed; "
            f"client submit -> answer p50 / p99 {fmt_ms(cl['p50'])} / {fmt_ms(cl['p99'])} ms")

        # (c) a rolling rollout to a byte-identical candidate under load
        cand = shutil.copytree(ckpt, os.path.join(work, "cand"))
        shed0 = fleet.stats()["shed"]
        stop = open_load(fleet, V, seed + 2)
        t0 = time.perf_counter()
        rec = fleet.rollout(cand)
        roll_s = time.perf_counter() - t0
        reqs, errors = stop()
        for r in fleet.replicas:
            pids.add(r.proc.pid)
        shed = fleet.stats()["shed"] - shed0
        cl = serve_bench.client_latency_ms(reqs)
        canary = rec.get("canary") or {}
        rolled = fleet.registry.counter_get("fleet.rollout_restarts")
        check("(c) rollout promoted", rec["verdict"] == "promoted"
              and canary.get("disagreement") == 0.0 and rec["restarted"] == XH_REPLICAS
              and rolled == XH_REPLICAS and errors == 0 and shed == 0,
              f"{rec}, rollout restarts {rolled}, errors {errors}, shed {shed}")
        log(f"(c) rollout to a byte-identical copy under {XH_RPS:.0f} requests/s: "
            f"{rec['verdict']} in {roll_s:.1f} s, canary disagreement "
            f"{canary.get('disagreement')} over {canary.get('batches')} batches "
            f"({canary.get('seeds')} seeds, mirrored {canary.get('mirrored')}), "
            f"{rec['restarted']} drains and restarts; {len(reqs)} requests, {errors} errors, "
            f"{shed} shed; client submit -> answer p50 / p99 {fmt_ms(cl['p50'])} / "
            f"{fmt_ms(cl['p99'])} ms")
        rows = [r for r in ledger.read_rows(directory=ledger_dir) if r["kind"] == "fleet"]
        p99 = [(r.get("hist_quantiles") or {}).get("serve.latency_ms", {}).get("p99")
               for r in rows]
        first = next((i for i, v in enumerate(p99) if v is not None), None)
        unbroken = first is not None and all(v is not None for v in p99[first:])
        check("(c) merged p99 unbroken in the kind=fleet rows", unbroken,
              f"{p99[first:] if first is not None else p99}")
        log(f"(c) {len(rows)} kind=fleet rows, merged p99 present from row {first} on: "
            f"{unbroken} (last {p99[-1] if p99 else None} ms)")
        # (d) the replay oracle: every replica against a fresh engine
        t0 = time.perf_counter()
        fresh = InferenceEngine.from_config(
            InputInfo.read_from_cfg_file(cfg_path), base_dir=work, ckpt_dir=cand,
            rng=np.random.default_rng(0), device=dev)
        build_s = time.perf_counter() - t0
        pick = np.random.default_rng(seed + 21)
        same = []
        for rseed, k in XH_PROBES:
            ids = pick.choice(V, size=k, replace=False).tolist()
            gen = fresh.sampler.rng
            gen.bit_generator.state = np.random.default_rng(rseed).bit_generator.state
            want = fresh.predict(np.asarray(ids, dtype=np.int64))
            for r in fleet.replicas:
                out = json.loads(httpc.fetch(r.predict_url, data=json.dumps(
                    {"node_ids": ids, "replay_seed": rseed}).encode(), retries=0))
                got = np.asarray(out["values"], dtype=np.dtype(out["dtype"]))
                same.append(out["dtype"] == "float32" and np.array_equal(got, want))
        check("(d) replay probes bitwise a fresh engine", all(same), f"{same}")
        log(f"(d) {len(same)} replay probes ({len(XH_PROBES)} seeds x {XH_REPLICAS} replicas, "
            f"{[k for _, k in XH_PROBES]} vertices) bitwise a fresh in-process engine built "
            f"from the promoted checkpoint ({build_s:.1f} s): {same}")
        del fresh, gen
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        try:
            cli.wait(timeout=2 * XH_WAIT_S + 60)
        except subprocess.TimeoutExpired:
            stop_router(cli)
        with open(cli_log) as fh:
            err = fh.read()
        verdict = [ln for ln in err.splitlines() if "serve_router: rollout " in ln]
        closed = [ln for ln in err.splitlines() if "serve_router: closed: " in ln]
        rec2 = json.loads(verdict[0].split(": ", 2)[2]) if verdict else {}
        cstats = json.loads(closed[0].split("closed: ", 1)[1]) if closed else {}
        check("(c) drifted candidate refused", cli.returncode == 3
              and rec2.get("verdict") == "canary_reject" and rec2.get("restarted") == 0
              and cstats.get("restarts") == 0,
              f"rc {cli.returncode}, {rec2}, {cstats}, {err[-1500:]}")
        started = [ln.split(" - ", 1)[-1] for ln in err.splitlines() if " startup on " in ln]
        log(f"(c) tools/serve_router offered a drifted candidate (x * 1.5 + 0.25, valid "
            f"digests): exit {cli.returncode}, {rec2.get('verdict')}, canary disagreement "
            f"{(rec2.get('canary') or {}).get('disagreement')}, restarted "
            f"{rec2.get('restarted')}; done {time.perf_counter() - t_cli:.1f} s after its "
            f"start, beside (a) and (b); its child: {started}")

        # (e) serve_bench --targets --trace against the live fleet; the trace
        # join reads its router's stream and the serving children's (a
        # stream's name carries its pid), not the streams of the children
        # killed or rolled before
        live = [os.path.join(children_dir, f) for f in sorted(os.listdir(children_dir))
                if any(f.endswith(f"-{r.proc.pid}-p0.jsonl") for r in fleet.replicas)]
        t0 = time.perf_counter()
        out = io.StringIO()
        os.environ["NTS_METRICS_DIR"] = bench_dir  # serve_bench's router stream
        try:
            with contextlib.redirect_stdout(out):
                rc = serve_bench.main(
                    ["--targets", ",".join(r.base_url for r in fleet.replicas), "--trace",
                     "--trace-dirs", *live, bench_dir, "--v-num", str(V),
                     "--clients", str(SERVE_CLIENTS), "--requests", str(XH_REQUESTS),
                     "--seed", str(seed)])
        finally:
            os.environ.pop("NTS_METRICS_DIR")
        bench_s = time.perf_counter() - t0
        try:
            extra = json.loads(out.getvalue().strip().splitlines()[-1])["extra"]
        except (IndexError, ValueError, KeyError):
            extra = {}
        check("(e) serve_bench --targets --trace", rc == 0
              and extra.get("served") == XH_REQUESTS and extra.get("shed") == 0
              and extra.get("errors") == 0 and (extra.get("trace_complete_frac") or 0) >= 0.95,
              f"rc {rc}, {extra}, {out.getvalue()[-1500:]}")
        one = results.get("serve_fused_closed") or {}
        fl = results.get("serve_fleet_latency") or {}
        log(f"(e) serve_bench --targets ({XH_REPLICAS} processes, {SERVE_CLIENTS} closed-loop "
            f"clients, {XH_REQUESTS} requests; its router in this process, beside the "
            f"fleet's polling and supervision): client submit -> answer p50 "
            f"{fmt_ms(extra.get('client_p50_ms'))} / p99 {fmt_ms(extra.get('client_p99_ms'))} ms, "
            f"{fmt_ms(extra.get('throughput_rps'))} requests/s; the replicas' merged histograms "
            f"p50 {fmt_ms(extra.get('p50_ms'))} / p99 {fmt_ms(extra.get('p99_ms'))} ms; trace "
            f"complete_frac {extra.get('trace_complete_frac')} over "
            f"{extra.get('trace_chains')} chains, router overhead p50 / p99 "
            f"{fmt_ms(extra.get('router_overhead_p50_ms'))} / "
            f"{fmt_ms(extra.get('router_overhead_p99_ms'))} ms; {bench_s:.1f} s. Phase 14, one "
            f"process: fused closed p50 {fmt_ms(one.get('p50_ms'))} / p99 "
            f"{fmt_ms(one.get('p99_ms'))} ms, {fmt_ms(one.get('throughput_rps'))} requests/s; "
            f"its 3-replica fleet p50 "
            f"{fmt_ms(fl.get('p50'))} / p99 {fmt_ms(fl.get('p99'))} ms")
        t0 = time.perf_counter()
        streams = trace_timeline.load_streams(expand_paths(live + [bench_dir]), fleet=True)
        rep = trace_timeline.request_tracing_report(
            [e for s in streams for e in s.events]) or {"chains": []}
        ok = [c for c in rep["chains"] if c["status"] == "ok"]
        lineage = [c for c in ok if c["complete"] and c["graph_seq"] == 0
                   and c["model_seq"] == rec.get("ckpt_step")]
        frac = len(lineage) / len(ok) if ok else 0.0
        n_chrome = trace_timeline.validate_chrome_trace(trace_timeline.chrome_trace(streams))
        check("(e) complete chains with lineage", frac >= 0.95 and n_chrome > 0,
              f"{len(lineage)} of {len(ok)}, chrome events {n_chrome}")
        log(f"(e) {len(lineage)} of {len(ok)} ok requests ({frac:.4f}) form complete chains "
            f"carrying graph_seq 0 and model_seq {rec.get('ckpt_step')}; the merged Chrome "
            f"trace of {len(streams)} streams validates ({n_chrome} events); "
            f"{time.perf_counter() - t0:.1f} s")

        # (f) a dropped connection is retried and answered
        os.environ["NTS_FAULT_SPEC"] = "net_drop@target=1,times=1"
        faults.reset()
        rseed, k = XH_PROBES[0]
        ids = np.random.default_rng(seed + 21).choice(V, size=k, replace=False).tolist()
        r1 = fleet.replicas[1]
        out = json.loads(httpc.fetch(r1.predict_url, data=json.dumps(
            {"node_ids": ids, "replay_seed": rseed}).encode(), retries=1, target=1))
        fired = [sp.fired for sp in faults.active_plan()]
        shed0 = fleet.stats()["shed"]
        faults.reset()  # armed again for the router's fetches
        answers = [fleet.submit([v]) for v in range(0, V, V // 50)]
        answered = sum(1 for a in answers if a.result(timeout=XH_WAIT_S) is not None)
        fired2 = [sp.fired for sp in faults.active_plan()]
        os.environ.pop("NTS_FAULT_SPEC")
        faults.reset()
        check("(f) net_drop retried and answered", fired == [1] and out.get("status") == "ok"
              and answered == len(answers) and fleet.stats()["shed"] == shed0,
              f"fired {fired} / {fired2}, {out.get('status')}, answered {answered}")
        log(f"(f) net_drop@target=1,times=1: the dropped attempt retried and answered "
            f"(fired {fired}); armed again under {len(answers)} routed requests: "
            f"{answered} answered, 0 shed (fired {fired2})")

        # (h) teardown: no child left on the card
        t0 = time.perf_counter()
        stats = fleet.close()
        fleet = None
        left = set(compute_apps()) & pids
        while left and time.perf_counter() - t0 < 30:
            time.sleep(0.5)
            left = set(compute_apps()) & pids
        apps = compute_apps()
        freed = mib(apps) <= mib(apps0) + 256  # a child holds > 1 GiB
        alive = []
        for pid in pids:  # reaped: the pid is gone
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        check("(h) no child left", not left and not alive and freed
              and set(apps) <= set(apps0) | {os.getpid()},
              f"left {left}, alive {alive}, compute apps {apps} (before {apps0})")
        log(f"(h) close() in {time.perf_counter() - t0:.1f} s: {stats}; children {sorted(pids)} "
            f"gone, nvidia-smi compute apps {apps}")
        recs = read_records(os.path.join(work, "router.jsonl"))
        losses = [e for e in recs if e["event"] == "target_loss"]
        restarts = [e for e in recs if e["event"] == "recovery" and e["action"] == "restart"]
        rollouts = [e["verdict"] for e in recs if e["event"] == "rollout"]
        check("(b) one target_loss, one restart, one promoted rollout",
              len(losses) == 1 and len(restarts) == 1 and rollouts == ["promoted"],
              f"{len(losses)} target_loss, {len(restarts)} restarts, rollouts {rollouts}")
        log(f"(b)-(c) the router's stream: {len(losses)} target_loss, {len(restarts)} "
            f"recovery action=restart ({restarts[0].get('seconds') if restarts else None} s), "
            f"rollouts {rollouts}")
        # (g) the router process ran no hand-written kernel
        launches = kernel_launches()
        check("(g) both kernels idle", not any(launches.values()), f"{launches}")
        log(f"(g) both kernels' launch counts through phase 21: {launches}")
    finally:
        if cli is not None:
            stop_router(cli)
        if fleet is not None:
            fleet.close()
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        faults.reset()
        keep(results, "ledger21", ledger_dir)
        keep(results, "phase21", os.path.join(work, "router.jsonl"))
        shutil.rmtree(work, ignore_errors=True)
        if ckpt is not None:
            shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    log(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    results["failures"].extend(failures)


# phase 22: the measurement and audit tools (see the module docstring, item 22)
MICRO_SCALE = 1.0  # micro_bench's own shapes: V 116,482, E 5,730,794
MICRO_ITERS = 3
TOOLS_SAMPLE_BATCHES = 2  # bench_sample's timed batches (its default 60)
TOOLS_SAMPLE_EPOCHS = 2  # sample_bench's epochs per mode (its default 3)
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense


def micro_bound_ms(name: str, v: int, e: int, c: int) -> tuple:
    """(bytes ms, operations ms) of micro_bench op ``name`` at V=v, E=e:
    each input read once and each output written once over 3.35 TB/s, the
    operations over the card's peak for their type. Aggregations:
    obs/cost.aggregation_cost; the edge ops (forward and the gradient with
    respect to h, which is the transposed aggregation of 2 * out): ids E*8 B,
    x, the two score inputs (c channels) and the gradient, against 4*E*f
    multiply-adds plus 5*E*c for score and softmax, in f32."""
    from neutronstarlite_torch.obs.cost import aggregation_cost
    from neutronstarlite_torch.tools.micro_bench import F, F_WIDE

    if name == "matmul_bf16_602x128":
        moved, ops, peak = (v * F_WIDE + F_WIDE * F + v * F) * 2, 2.0 * v * F_WIDE * F, BF16_FLOPS
    elif name == "hbm_stream_f32_64MB":
        moved, ops, peak = 2 * (8 << 20) * 4, float(8 << 20), F32_FLOPS
    elif name == "row_gather_bf16":
        moved, ops, peak = v * F * 2 + e * 8 + e * F * 2, 0.0, F32_FLOPS
    elif name.startswith("edge_"):
        moved = e * 8 + 2 * v * F * 2 + 2 * v * c * (4 if c == 1 else 2)
        ops, peak = 4.0 * e * F + 5.0 * e * c, F32_FLOPS
    else:
        ops, moved = aggregation_cost(e, v, F_WIDE if "602" in name else F, 2)
        peak = F32_FLOPS
    return moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


def run_tool(main_fn, argv, **env):
    """A tool's entry point in this process with ``env`` set for the call:
    (exit code, its last JSON line or None, seconds). Its stdout is kept
    from the log; its stderr passes through. The whole environment is put
    back afterwards, whatever the tool changed."""
    saved = dict(os.environ)
    os.environ.update(env)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main_fn(argv)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), time.perf_counter() - t0


def phase_tools(dev, seed: int, results, micro_scale: float = MICRO_SCALE) -> None:
    """Phase 22: the tools on the card (module docstring, item 22). On a CPU
    ``dev`` (a dry run) every tool gets --device cpu. A failed check prints
    FAILED and fails the run at the end."""
    import numpy as np
    import torch

    from neutronstarlite_torch import native
    from neutronstarlite_torch.ops.bsp_ell import bsp_tables_aggregate
    from neutronstarlite_torch.tools import (bench_matrix, bench_sample, dashboard,
                                             drift_audit, micro_bench, perf_sentinel,
                                             sample_bench)

    t_phase = time.perf_counter()
    failures = []
    cuda = dev.type == "cuda"
    dev_args = [] if cuda else ["--device", "cpu"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"phase 22 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    kept = results.get("kept", "")  # what phases 13, 19 and 21 kept
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        # ---- (a) micro_bench at its own shapes ----------------------------------------
        t0 = time.perf_counter()
        v, e = micro_bench.shapes(micro_scale)
        bench = micro_bench.MicroBench(v, e, 7, dev)
        ops, launches = {}, {}
        for name, needs, _, _ in bench.ops():
            for k in needs:  # the host builds stay outside the counted run
                bench.need(k)
            zero_launches()
            out = micro_bench.run(bench, [name], MICRO_ITERS)
            sync()
            launches[name] = kernel_launches()
            ops[name] = out["ops"][name]
        check("(a) platform", out["platform"] == ("gpu" if cuda else "cpu"), out["platform"])
        for name, rec in ops.items():
            check(f"(a) {name} timed", "error" not in rec and rec.get("ms", 0) > 0, rec)
            kernel = micro_bench.KERNEL_OPS.get(name)
            want = {k: (k == kernel) for k in ("ell_level", "bsp_ell")}
            got = {k: n > 0 for k, n in launches[name].items()}
            check(f"(a) {name} launches", got == want, f"{launches[name]} (want {want})")
        g = bench.need("g")
        errs = {}
        for name, kernel in micro_bench.KERNEL_OPS.items():
            x = bench.need("xw" if "602" in name else "x")
            got = bench.op(name)(1.0)
            plain = (bsp_tables_aggregate(bench.need("bsp").fwd, x) if kernel == "bsp_ell"
                     else bench.need("ell").fwd.plain(x))
            sync()
            try:
                errs[name] = check_close(f"(a) {name}", got, plain, BF16_TOL)
            except AssertionError as exc:
                check(f"(a) {name} against its plain version", False, str(exc))
            del got, plain
        library = {}
        if cuda:
            a = torch.sparse_csr_tensor(
                torch.from_numpy(g.column_offset).to(dev),
                torch.from_numpy(g.row_indices.astype(np.int64)).to(dev),
                torch.from_numpy(g.edge_weight_forward).to(dev, torch.bfloat16), size=(v, v))
            for f, key in ((micro_bench.F, "x"), (micro_bench.F_WIDE, "xw")):
                library[f] = cuda_ms(lambda: torch.sparse.mm(a, bench.need(key)))
            del a
        log(f"(a) micro_bench V={v} E={e} bf16, median of {MICRO_ITERS} after {micro_bench.WARMUP} warm-up "
            f"(CUDA events), built and timed in {time.perf_counter() - t0:.1f} s:")
        for name, rec in ops.items():
            b_ms, o_ms = micro_bound_ms(name, v, e, micro_bench.F if "ggcn" in name else 1)
            f = micro_bench.F_WIDE if "602" in name or name.startswith("matmul") else \
                micro_bench.F
            lib = library.get(f) if name in (
                "ell_aggregate_xla_bf16", "sorted_scatter_bf16", "bsp_streamed_bf16",
                "pallas_ell_resident_bf16", "pallas_ell_fchunked_602_bf16") else None
            rate = (f"{rec['tflops']} TFLOP/s" if "tflops" in rec
                    else f"apparent {rec.get('apparent_gbs')} GB/s")
            log(f"(a)   {name:30s} {rec.get('ms', float('nan')):9.4f} ms  bound "
                f"{max(b_ms, o_ms):.4f} ms ({'bytes' if b_ms >= o_ms else 'operations'}; "
                f"bytes {b_ms:.4f}, ops {o_ms:.4f})  {rate}  torch.sparse.mm "
                f"{'-' if lib is None else f'{lib:.4f} ms'}  launches {launches[name]}"
                + (f"  max abs err vs plain {errs[name]:.3e}" if name in errs else ""))
        results["micro_bench"] = ops
        del bench, g
        if cuda:
            torch.cuda.empty_cache()

        cache = os.path.join(work, "bench_cache")
        # ---- (b) bench_sample at 0.1 ------------------------------------------------------
        hops0 = native.sample_hop.calls
        rc, out, secs = run_tool(bench_sample.main, ["--scale", "0.1", "--batches",
                                                     str(TOOLS_SAMPLE_BATCHES), "--warmup", "1"]
                                 + dev_args, NTS_BENCH_CACHE=cache)
        ex = (out or {}).get("extra", {})
        # phase 23 (c) reads it, and how many hops its samplers drew natively
        results["bench_sample"] = out
        results["bench_sample_native_hops"] = native.sample_hop.calls - hops0
        check("(b) bench_sample", rc == 0 and out is not None and out["value"] > 0
              and math.isfinite(ex.get("final_loss", float("nan"))), (rc, out))
        log(f"(b) bench_sample at 0.1 (V={ex.get('v_num')} E={ex.get('e_num')}, B 512, "
            f"fanout 25-10, f32, {TOOLS_SAMPLE_BATCHES} batches) in {secs:.1f} s: median "
            f"batch {(out or {}).get('value')} s (sample {ex.get('sample_s_median')} s, "
            f"device+pad {ex.get('device_pad_s_median')} s), {ex.get('edge_slots_per_sec')} "
            f"edge slots/s, epoch extrapolated {ex.get('epoch_s_extrapolated')} s, final "
            f"loss {ex.get('final_loss')}; graph cache built in "
            f"{ex.get('graph_cache_build_s')} s, trainer in {ex.get('build_s')} s")

        # ---- (c) sample_bench, three modes -----------------------------------------------
        rc, out, secs = run_tool(sample_bench.main, ["--modes", "sync,pipelined,fused",
                                                     "--epochs", str(TOOLS_SAMPLE_EPOCHS)]
                                 + dev_args, NTS_BENCH_CACHE=cache)
        ex = (out or {}).get("extra", {})
        modes = ex.get("modes", {})
        check("(c) sample_bench", rc == 0 and set(modes) == {"sync", "pipelined", "fused"},
              (rc, out))
        check("(c) sync and pipelined losses equal",
              ex.get("sync_pipelined_loss_parity") is True, ex)
        check("(c) fused moves no batch bytes",
              (modes.get("fused") or {}).get("sample_h2d_bytes_total") == 0.0, modes.get("fused"))
        for m, r in modes.items():
            check(f"(c) {m} finite", all(math.isfinite(x) for x in r["loss_history"])
                  and (r["batches_per_sec"] or 0) > 0, r)
            log(f"(c) sample_bench {m} at 0.02 (V={ex.get('v_num')}): warm epoch "
                f"{r['warm_epoch_s']} s, {r['batches_per_sec']} batches/s, losses "
                f"{[round(x, 6) for x in r['loss_history']]}, stall ms "
                f"{r['sample_stall_ms_total']}, h2d bytes {r['sample_h2d_bytes_total']}, "
                f"dispatches {r['dispatches']}")
        log(f"(c) sample_bench in {secs:.1f} s: sync == pipelined "
            f"{ex.get('sync_pipelined_loss_parity')}, fused vs sync max loss gap "
            f"{ex.get('fused_sync_loss_maxdiff')}")

        # ---- (d) bench_matrix over configs/ ----------------------------------------------
        # over copies in the work dir, each CHECKPOINT_DIR (the elastic
        # smoke's names a fixed path) moved into it; ../tests resolves to the
        # repo's fixtures, and ../data to what prep makes in the work dir
        cfgs = os.path.join(work, "configs")
        os.makedirs(cfgs)
        os.symlink(os.path.join(REPO, "tests"), os.path.join(work, "tests"))
        for path in glob.glob(os.path.join(REPO, "configs", "*.cfg")):
            with open(path) as fh:
                text = re.sub(r"^CHECKPOINT_DIR:\S+", "CHECKPOINT_DIR:"
                              + os.path.join(work, "ck", os.path.basename(path)), fh.read(),
                              flags=re.M)
            with open(os.path.join(cfgs, os.path.basename(path)), "w") as fh:
                fh.write(text)
        rc, out, secs = run_tool(bench_matrix.main, ["--configs", cfgs, "--epochs", "2",
                                                     "--warmup", "1"] + dev_args,
                                 NTS_DIST_SIMULATE="1", NTS_TUNE="measure",
                                 NTS_TUNE_DIR=os.path.join(work, "tune"))
        rows = (out or {}).get("rows", [])
        check("(d) bench_matrix", rc == 0 and rows, (rc, out))
        for r in rows:
            # the cfgs that read the reference checkout's data name it by an
            # absolute path; relative ones are the repo's or prep's
            with open(os.path.join(cfgs, r["workload"] + ".cfg")) as fh:
                missing = [p for p in re.findall(r"^\w+_FILE:(\S+)", fh.read(), re.M)
                           if os.path.isabs(p) and not os.path.exists(p)]
            if missing:
                check(f"(d) {r['workload']} fails on its missing data",
                      str(r.get("error", "")).startswith("FileNotFoundError")
                      and any(p in r["error"] for p in missing), r)
            else:
                check(f"(d) {r['workload']} measured", r.get("epoch_s") is not None
                      and r.get("loss") is not None and math.isfinite(r["loss"]), r)
            log(f"(d) {r['workload']:26s} " + (
                f"{r['algorithm']:16s} epoch {r['epoch_s'] * 1e3:9.3f} ms, first "
                f"{r['first_epoch_s']} s, build {r['build_s']} s, loss {r['loss']:.6f}"
                if r.get("epoch_s") is not None else f"error {r.get('error')}"))
        log(f"(d) bench_matrix: {sum(r.get('epoch_s') is not None for r in rows)} of "
            f"{len(rows)} rows measured in {secs:.1f} s")

        # ---- (e) drift_audit over phase 19's streams ---------------------------------------
        streams = sorted(glob.glob(os.path.join(kept, "phase19", "*_obs")))
        check("(e) phase 19's streams", len(streams) == 3, streams)
        if streams:
            rc, _, _ = run_tool(drift_audit.main, streams + ["--no-flag", "--json"])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                drift_audit.main(streams + ["--no-flag"])
            check("(e) drift_audit verdict", rc in (0, 3), rc)
            drift_recs = 0
            for path in glob.glob(os.path.join(kept, "phase19", "*_obs", "*.jsonl")):
                with open(path) as fh:
                    drift_recs += sum('"model_drift"' in line for line in fh)
            log(f"(e) drift_audit over phase 19's streams: exit {rc}: "
                f"{buf.getvalue().strip()} ({drift_recs} model_drift records in the streams)")
            quant = [s_ for s_ in streams if s_.endswith("d_obs")]
            rc, out, _ = run_tool(drift_audit.main, quant + ["--no-flag", "--json"],
                                  NTS_QUANT_TOL="1e-4")
            qd = [d for d in (out or {}).get("drift", []) if d["source"] == "wire_quant"]
            check("(e) NTS_QUANT_TOL=1e-4 finds the bf16 wire's error", rc == 3 and qd
                  and qd[0]["metric"] == "wire_quant_rel_err", (rc, out))
            log(f"(e) with NTS_QUANT_TOL=1e-4 over phase 19 (d): exit {rc}, measured wire "
                f"quant error {qd[0]['observed'] if qd else None}")

        # ---- (f) perf_sentinel over phases 13 and 21's ledger rows ---------------------------
        led = os.path.join(work, "ledger")
        os.makedirs(led)
        parts = sorted(glob.glob(os.path.join(kept, "ledger13", "*", "*.jsonl"))
                       + glob.glob(os.path.join(kept, "ledger21", "*", "*.jsonl")))
        with open(os.path.join(led, "ledger.jsonl"), "w") as fh:
            for part in parts:
                with open(part) as src_fh:
                    fh.write(src_fh.read())
        check("(f) ledger rows kept", parts, kept)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc_check, _, _ = run_tool(perf_sentinel.main, ["check", "--ledger", led])
            rc_fleet, _, _ = run_tool(perf_sentinel.main, ["check", "--ledger", led,
                                                           "--kind", "fleet"])
        rc_keys, keys, _ = run_tool(perf_sentinel.main, ["list-keys", "--ledger", led,
                                                         "--json"])
        check("(f) perf_sentinel", rc_check in (0, 2) and rc_fleet in (0, 2) and rc_keys == 0,
              (rc_check, rc_fleet, rc_keys, err.getvalue()[-500:]))
        log(f"(f) perf_sentinel over {len(parts)} ledger files: check (run) exit {rc_check}, "
            f"(fleet) exit {rc_fleet}; list-keys "
            f"{[(k['kind'], k['rows']) for k in (keys or {}).get('keys', [])]}; "
            + " | ".join(ln for ln in err.getvalue().splitlines() if ln.strip())[-600:])

        # ---- (g) the dashboard over phase 21's hub stream ------------------------------------
        hub = glob.glob(os.path.join(kept, "phase21", "router.jsonl"))
        check("(g) phase 21's router stream", hub, kept)
        if hub:
            html_path = os.path.join(work, "dashboard.html")
            rc, _, _ = run_tool(dashboard.main, ["--stream", hub[0], "--ledger", led, "--out",
                                                 html_path])
            doc = open(html_path).read() if os.path.exists(html_path) else ""
            model = dashboard.fabric_model(dashboard.load_stream_events(hub))
            check("(g) dashboard", rc == 0 and doc.startswith("<!doctype html>")
                  and "fleet topology" in doc and model["polls"] > 0, (rc, len(doc)))
            log(f"(g) dashboard: exit {rc}, {len(doc)} bytes of HTML from phase 21's router "
                f"stream ({model['polls']} hub polls, {len(model['targets'])} targets); "
                f"{dashboard.watch_line(model)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    results["failures"].extend(failures)


PHASE23_PEAK_BAND = 0.25  # aot_check's predicted peak against phase 4's, relative
# native against NumPy GCN weights: a product, a square root and a
# reciprocal each rounded in float32 (relative error up to ~2.5 * 2^-24)
# against one rounding of the float64 value (2^-25)
NATIVE_WEIGHT_ULPS = 3
PHASE23_F = 128  # the width of (b)'s kernel checks on the native tables
PR18_SAMPLE_BATCH_S = (2.20, 2.28)  # bench_sample at 0.1 with the NumPy sampler


def phase_native_capacity(dev, g, seed: int, results, scale: float) -> None:
    """Phase 23 (module docstring, item 23): the native host runtime and the
    capacity tools. A failed check prints FAILED and fails the run at the
    end."""
    import numpy as np
    import torch

    from neutronstarlite_torch import native
    from neutronstarlite_torch.graph.digest import graph_digest
    from neutronstarlite_torch.graph.storage import build_graph, gcn_norm_weights
    from neutronstarlite_torch.models.gcn import GCNTrainer
    from neutronstarlite_torch.ops.blocked_ell import BlockedEllPair
    from neutronstarlite_torch.ops.bsp_ell import BspEllPair, bsp_aggregate, bsp_tables_aggregate
    from neutronstarlite_torch.ops.ell import EllPair
    from neutronstarlite_torch.ops.ell_kernel import ell_level_aggregate
    from neutronstarlite_torch.tools import aot_bsp_scale, aot_check, tpu_plan
    from neutronstarlite_torch.utils.config import InputInfo

    t_phase = time.perf_counter()
    failures = results["failures"]
    src, dst = results["edges"]
    datum = results["datum"]
    work = tempfile.mkdtemp(prefix="chip_smoke_p23_")

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"phase 23 {name}: {detail}")
            log(f"FAILED {failures[-1]}")

    def numpy_build(fn):
        os.environ["NTS_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0
        finally:
            os.environ.pop("NTS_NO_NATIVE")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    try:
        # (a) the native library, built at the start of the run
        check("(a) native runtime available", native.available(), "available() is False")
        log(f"(a) native runtime: {native.SO}, built in {native.build_seconds:.2f} s by "
            f"{native.built_with} (compilers tried in order: {native.compilers()}), version "
            f"{native.get_lib().nts_native_version()}")

        # (b) host builds, native against NumPy, and the kernels on native tables
        v = g.v_num
        gn, t_gn = timed(lambda: build_graph(src, dst, v))
        gp, t_gp = numpy_build(lambda: build_graph(src, dst, v, use_native=False))
        same = graph_digest(gn) == graph_digest(gp)
        # the native weight is float32 arithmetic, 1 / sqrt(f32(d_out) *
        # f32(d_in)), three roundings; the NumPy build's rounds the float64
        # value once, so the two may sit up to NATIVE_WEIGHT_ULPS apart
        d_out = np.maximum(gn.out_degree[gn.row_indices], 1).astype(np.float32)
        d_in = np.maximum(gn.in_degree[gn.dst_of_edge], 1).astype(np.float32)
        f32_w = np.float32(1.0) / np.sqrt(d_out * d_in)
        ref_w = gcn_norm_weights(gn.row_indices.astype(np.uint32),
                                 gn.dst_of_edge.astype(np.uint32), gn.out_degree, gn.in_degree)
        ulps = float((np.abs(gn.edge_weight_forward - ref_w) / np.spacing(np.abs(ref_w))).max())
        bitwise = gn.edge_weight_forward.tobytes() == f32_w.tobytes()
        check("(b) graph digest", same, "native and NumPy graphs differ")
        check("(b) weights bitwise the float32 formula", bitwise, "native weights differ")
        check("(b) weights against the NumPy build", ulps <= NATIVE_WEIGHT_ULPS, f"{ulps} ulp")
        log(f"(b) build_graph at {scale} (V={v} E={gn.e_num}): native {t_gn:.3f} s, NumPy "
            f"{t_gp:.3f} s; graph_digest equal {same}; native weights bitwise the float32 "
            f"formula {bitwise}, at most {ulps:.0f} ulp from the NumPy build's")
        builds = {}
        tables = {}
        for name, make in (("ell", lambda: EllPair.from_host(gn, device=dev)),
                           ("bsp", lambda: BspEllPair.from_host(gn, device=dev)),
                           ("blocked", lambda: BlockedEllPair.from_host(gn, vt=4096,
                                                                        device=dev))):
            a, t_a = timed(make)
            b, t_b = numpy_build(make)
            torch.cuda.synchronize()
            ta = [x for x in aot_check.tensors_in(a)]
            tb = [x for x in aot_check.tensors_in(b)]
            eq = len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))
            check(f"(b) {name} tables native == NumPy", eq, "tables differ")
            builds[name] = (t_a, t_b)
            tables[name] = a
            del b
        log("(b) table builds from the native graph (host build + copy to the card), "
            "native / NumPy s: " + ", ".join(f"{k} {a:.3f} / {b:.3f}"
                                              for k, (a, b) in builds.items())
            + "; native tables bitwise the NumPy ones")
        gen = torch.Generator(device=dev).manual_seed(seed + 23)
        x = (torch.randn((v, PHASE23_F), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        e_ell = check_close("(b) ell_level on native tables", ell_level_aggregate(
            tables["ell"].fwd, x), tables["ell"].fwd.plain(x), BF16_TOL)
        e_bsp = check_close("(b) bsp_ell on native tables", bsp_aggregate(
            tables["bsp"].fwd, x), bsp_tables_aggregate(tables["bsp"].fwd, x), BF16_TOL)
        log(f"(b) on the native tables at f {PHASE23_F} bf16: ell_level max abs err "
            f"{e_ell:.3e}, bsp_ell {e_bsp:.3e} against their plain versions (BF16_TOL)")
        del tables, x
        torch.cuda.empty_cache()
        losses = {}
        for name, host in (("native", gn), ("numpy", gp)):
            cfg = InputInfo(algorithm="GCN", vertices=v, layer_string="602-128-41", epochs=1,
                            drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                            weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                            optim_kernel=True, pallas_kernel=True)
            os.environ["NTS_PALLAS_RESIDENT"] = "1"
            tr = GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device=dev,
                                        host_graph=host)
            tr.run()
            losses[name] = tr.loss_history[0]
            del tr
        torch.cuda.empty_cache()
        gap = abs(losses["native"] - losses["numpy"])
        check("(b) epoch-0 loss native vs NumPy graph", gap <= 1e-3, f"{losses}")
        log(f"(b) GCN bf16 ELL epoch-0 loss on the native graph {losses['native']:.6f}, on the "
            f"NumPy graph {losses['numpy']:.6f} (|d| {gap:.2e}, limit 1e-3)")
        del gp

        # (c) bench_sample at 0.1 with the native sampler (phase 22 (b)'s run)
        out = results.get("bench_sample") or {}
        ex = out.get("extra", {})
        hops = results.get("bench_sample_native_hops", 0)
        # 2 hops per batch of TOOLS_SAMPLE_BATCHES + 1 warm-up
        check("(c) bench_sample native", hops >= 2 * (TOOLS_SAMPLE_BATCHES + 1),
              f"{hops} native sample_hop calls")
        if out:
            log(f"(c) bench_sample at 0.1 with the native sampler ({hops} native sample_hop "
                f"calls; phase 22 (b)): "
                f"{out['value']} s per batch, of it sampling {ex.get('sample_s_median')} s "
                f"(host share {ex.get('sample_s_median', 0) / out['value']:.3f}); PR 18's "
                f"NumPy sampler {PR18_SAMPLE_BATCH_S[0]}-{PR18_SAMPLE_BATCH_S[1]} s per batch")

        # (d) aot_check on phase 4's cfg and routes against phase 4's peaks
        for route in ("bsp", "ell"):
            cfg = InputInfo(algorithm="GCN", vertices=v, layer_string="602-128-41",
                            epochs=1, drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                            weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                            optim_kernel=True, pallas_kernel=True)
            os.environ["NTS_PALLAS_RESIDENT"] = "1" if route == "ell" else "0"
            cpu_tr = GCNTrainer.from_arrays(cfg, src, dst, datum, seed=seed, device="cpu",
                                            host_graph=g)
            rep = aot_check.check(cfg, trainer=cpu_tr)
            del cpu_tr
            got = results[route]["own_peak_bytes"]
            rel = rep["step_peak_bytes"] / got - 1.0
            check(f"(d) {route} predicted peak", abs(rel) <= PHASE23_PEAK_BAND and rep["fits"],
                  f"predicted {rep['step_peak_bytes']} vs measured {got} ({rel:+.3f})")
            worst = min((c["limit"] - c["value"], c["name"]) for c in rep["checks"])
            log(f"(d) aot_check {route} (phase 4's cfg, {scale}): static "
                f"{rep['static_bytes']} B ({rep['static']}), kernel caches "
                f"{rep['kernel_cache']} B, transient {rep['transient']} B, step peak "
                f"{rep['step_peak_bytes']} B against phase 4's own peak {got} B "
                f"({rel:+.3f}, band {PHASE23_PEAK_BAND}); with the cuBLAS workspaces "
                f"{rep['peak_bytes']} B of {rep['memory_bytes']:.0f} ({rep['memory_source']}); "
                f"{len(rep['checks'])} launch checks, refused {rep['refused']}, least headroom "
                f"{worst[0]} ({worst[1]}); {rep['check_s']:.1f} s")

        # one rank of phase 15's GCNDIST (P=DIST_P, ELL) on the bench graph at this
        # scale: a rank's peak has no card of its own here (phase 15 runs the
        # twin); the dry rank is held to a real gloo rank on the CPU
        # (tests/test_torch_capacity.py)
        os.environ.pop("NTS_PALLAS_RESIDENT", None)  # a single-device switch
        dcfg = InputInfo(algorithm="GCNDIST", vertices=v, layer_string="602-128-41",
                         epochs=1, drop_rate=0.0, precision="bfloat16", learn_rate=0.01,
                         weight_decay=1e-4, decay_rate=0.97, decay_epoch=100,
                         partitions=DIST_P, optim_kernel=True)
        rep = aot_check.check(dcfg, synthetic_scale=scale)
        check("(d) GCNDIST rank fits", rep["fits"] and rep["case"] == "dist",
              f"{rep.get('refused')}, peak {rep['peak_bytes']}")
        log(f"(d) aot_check GCNDIST P={DIST_P} ELL at --synthetic-scale {scale}: rank "
            f"{rep['rank']} of in-edges {rep['rank_in_edges']} (vp {rep['vp']}): static "
            f"{rep['static_bytes']} B ({rep['static']}), kernel caches {rep['kernel_cache']} "
            f"B, transient {rep['transient']} B, step peak {rep['step_peak_bytes']} B; "
            f"{len(rep['checks'])} launch checks, refused {rep['refused']}; "
            f"{rep['check_s']:.1f} s")

        # (e) aot_bsp_scale at 10x with its launch, roofline through the plan runner
        rc, out, secs = run_tool(aot_bsp_scale.main, ["--scale", "10", "--f", "602"])
        geo = (out or {}).get("geometry", {})
        launch = (out or {}).get("launch", {})
        check("(e) aot_bsp_scale", rc == 0 and out is not None and launch.get("ok")
              and launch.get("launches") == 2, f"rc {rc}, launch {launch}")
        if out:
            tight = min(geo["ints"].items(), key=lambda kv: kv[1]["headroom"])
            log(f"(e) aot_bsp_scale --scale 10 (V={out['v_num']} E={out['e_num']}, f 602) in "
                f"{secs:.1f} s: blocks {geo['blocks']} (estimate; bound {geo['blocks_bound']}), "
                f"grid {geo['ints']['grid_ctas']['value']} CTAs, least int headroom "
                f"{tight[1]['headroom']} ({tight[0]}), slots {geo['slots']} (headroom to 2^31 "
                f"{geo['slots_vs_2_31']['headroom']}; {geo['slots_vs_2_31']['note']}), device "
                f"bytes {geo['device_bytes']} (fits {geo['fits']}); launch over "
                f"{launch.get('blocks')} blocks at key {launch.get('key')}: "
                f"{launch.get('launches')} launches, max abs err {launch.get('max_abs_err')} "
                f"(limit {launch.get('tol')}), {launch.get('seconds')} s")
        plan_dir = os.path.join(work, "plan")
        os.makedirs(plan_dir)
        for route in ("ell", "bsp"):
            times = results[route]["epoch_times"]
            with open(os.path.join(plan_dir, f"phase4_{route}.json"), "w") as fh:
                json.dump({"metric": f"gcn_epoch_standard_{route}",
                           "value": float(np.mean(times[1:] or times)), "unit": "s",
                           "extra": {"order": "standard", "path": route, "scale": scale}}, fh)
        rc, _, secs = run_tool(tpu_plan.main, ["--out", plan_dir, "--list"])
        check("(e) tpu_plan --list", rc == 0, f"rc {rc}")
        rc, _, secs = run_tool(tpu_plan.main, ["--out", plan_dir, "--scale", str(scale),
                                               "--only", "roofline", "--max-wall-s", "300"])
        ok_marker = os.path.exists(os.path.join(plan_dir, "roofline.ok"))
        rows = []
        if os.path.exists(os.path.join(plan_dir, "roofline.json")):
            with open(os.path.join(plan_dir, "roofline.json")) as fh:
                rows = json.load(fh)["rows"]
        check("(e) tpu_plan roofline step", rc == 0 and ok_marker, f"rc {rc}, ok {ok_marker}")
        for r in rows:
            if r["measured_s"] is not None:
                log(f"(e) roofline --scale {scale}: {r['order']} {r['path']} bound "
                    f"{r['bound_s'] * 1e3:.4f} ms against phase 4's epoch "
                    f"{r['measured_s'] * 1e3:.4f} ms: achieved {r['achieved']:.4f}")
        check("(e) roofline read phase 4", sum(r["measured_s"] is not None for r in rows) == 2,
              f"{rows}")
        log(f"(e) tpu_plan --only roofline through the runner in {secs:.1f} s, marker "
            f"{ok_marker}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 23 in {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1, help="fraction of Reddit's V and E")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from neutronstarlite_torch.ops import _build

    global T_START
    T_START = t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    build_s = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
    log(f"built {', '.join(_build.KERNELS)} for sm_90a in {build_s:.1f} s")
    from neutronstarlite_torch import native

    if not native.available():  # phase 23 requires it; the host builds use it
        print("chip_smoke: the native host runtime is unavailable", file=sys.stderr)
        return 1
    log(f"built the native host runtime in {native.build_seconds:.2f} s by "
        f"{native.built_with}")

    spent = []  # (phase, seconds) in the order they ran

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        spent.append((name, round(time.perf_counter() - t0, 1)))
        return out

    check_errs = timed("3", phase_kernel_checks, dev, args.seed)
    g, results = timed("4", phase_main_path, dev, args.scale, args.epochs, args.seed)
    # what phases 13, 19 and 21 leave for phase 22 (their streams and ledger rows)
    results["kept"] = tempfile.mkdtemp(prefix="chip_smoke_kept_")
    timed("5", phase_cora_cli, dev)
    rows = timed("6", phase_timing, dev, g, results, check_errs, args.seed)
    for route in ("bsp", "ell"):  # free the GCN trainers' tables
        results[route].pop("trainer")
    torch.cuda.empty_cache()
    rows += timed("7", phase_gat, dev, args.epochs, args.seed, results, results["failures"])
    timed("8", phase_gin_commnet, dev, g, 2, args.seed, results, results["failures"])
    ggcn_chain = timed("9", phase_ggcn, dev, args.scale, args.seed)
    timed("10", phase_blocked_and_fused, dev, g, args.scale, args.epochs, args.seed, results,
          ggcn_chain, results["failures"])
    timed("11", phase_resilience, dev, g, args.seed, results, results["failures"])
    timed("12", phase_sampled, dev, g, args.seed, results)
    timed("13", phase_obs, dev, g, args.seed, results)
    timed("14", phase_serving, dev, g, args.seed, results)
    rows += timed("15", phase_dist, dev, g, args.seed, results)
    timed("16", phase_ring, dev, args.scale, args.seed, results)
    timed("17", phase_mirror, dev, g, args.seed, results, ggcn_chain, args.scale)
    timed("18", phase_tune, dev, g, args.seed, results, args.scale)
    timed("19", phase_elastic, dev, g, args.seed, results, args.scale)
    timed("20", phase_live_graph, dev, args.seed, results, args.scale)
    timed("21", phase_crosshost, dev, g, args.seed, results)
    timed("22", phase_tools, dev, args.seed, results)
    timed("23", phase_native_capacity, dev, g, args.seed, results, args.scale)
    shutil.rmtree(results.pop("kept"), ignore_errors=True)
    faulthandler.cancel_dump_traceback_later()
    log(f"seconds per phase: {dict(spent)}")
    if results["failures"]:
        for msg in results["failures"]:
            log(f"FAILED {msg}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

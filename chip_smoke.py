#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Builds full-width qwen1.5-4b (40 layers, d 2560, vocab 151936, bf16,
   seeded random weights) and one engine per estimator: ``exact``,
   ``mimps`` (which runs the k-means), then ``topk``, ``mince``, ``fmbe``
   and ``selfnorm``, which reuse the mimps k-means assignment, and ``lsh``
   (8 tables of 8-bit SimHash codes over the head). The fmbe build
   (feature map, index, pack and per-block sketch sums through
   ``fmbe_phi``) starts with every launch count at 0, is timed by itself
   and must launch only the tensor-core ``fmbe_phi``.
3. Holds each kernel against its plain PyTorch version at the shapes the
   main path gives it (bf16 inputs; LSEs and scores to 1e-3 absolute, top
   ids equal wherever the gap to the neighbouring scores exceeds 1e-3,
   union pad slots exactly 0; the signed FMBE sums to 1e-4 of the sum of
   their terms' magnitudes; ``lsh_probe`` on the trimmed candidate union
   and on the dense fallback, its counts equal exactly and its membership
   equal to the plan's, its query codes equal to the plan's except where a
   projection lies within 1e-5 of 0 relative to |h| |proj row|, two calls
   bit-equal; ``union_scores`` two calls bit-equal too) and times the
   kernel, the plain version and, where one exists, a PyTorch library call
   computing the same function, beside the kernel's bound, with the
   kernel's share of the bound and its GB/s for ``union_scores`` and
   ``lsh_probe`` (``union_scores`` also with the L2 cache flushed before
   each call, a time its record takes if the warm one beats the bound).
   ``topk_z`` also runs on 16 decode hidden states of the same model (the
   traffic path's lanes, ``topk_z[q16]``), and logs its geometry (query
   tile, CTAs, boxes a CTA, the ring held to the built kernel's) and the
   time on the rows that give every CTA the same boxes.
   ``ivf_score`` runs on the mimps plan's probe ids (two calls bit-equal,
   the rows its kernels copy equal to its bound's distinct blocks, timed
   as ``ivf_decode`` is, by kernel too) and is then driven through its
   entry point ``ops.ivf_block_scores`` with the launch counts at 0.
4. Holds the estimators against each other on the same hidden states and
   tail draws: ``mimps`` within 0.05 of the exact log Z, ``mince`` equal to
   ``mimps`` to 1e-3, ``topk`` at most the exact log Z (+1e-3) with
   ``mimps``'s top ids, ``fmbe`` and ``lsh`` finite and at least their head
   LSE (``lsh`` draws its own tail; its gap to the exact log Z is
   recorded).
5. Serves the model through ``generate`` with each estimator: 8 requests,
   prompt 16, 16 new tokens, greedy. Each engine's decode step is captured
   in a CUDA graph first (timed), then ``generate`` replays it once a step,
   starting with every kernel's launch count at 0: each kernel of the path
   must launch once a replay or a whole multiple of it. The same requests
   then go through ``host_loop=True`` from the same generator state: the
   tokens, log_prob and log_z must be bit-equal. Logs wall ms/step and
   tokens/s of both, and the captured step's device ms (graph replay).
   mimps also runs at temperature 1.0 on the same graph, bit-equal to its
   host loop. The lsh run logs its candidate union per step against the
   trimmed capacity (at least one step on the trimmed branch), and an lsh
   engine with ``head_cap`` 64 takes the dense branch on every step,
   captured and bit-equal too. One captured mimps step with the lanes at
   positions shifted by 0 to 3 must equal the same step taken eagerly bit
   for bit (tokens, log_prob, log_z, KV cache). The step parts (trunk and
   each output layer, lsh included) are timed as CUDA graphs; one replay
   of the captured mimps step runs under ``torch.profiler`` (kernels a
   step, time by kernel), and one eager trunk call by kind (projections,
   attention, norms, RoPE, elementwise), its output bit-equal to the plain
   trunk's.
5b. The lifecycle phase (``lifecycle``), on the same parameters: a mimps
   engine with the fixed-capacity index (``device_index=True``: 553
   blocks at qwen1.5-4b) and the health guard on serves the same traffic,
   its tokens and log Z bit-equal to the unguarded run's; with NaN rows
   installed in its index every query of every step is flagged and the
   tokens and log Z are the exact engine's; ``shadow_exact_log_z`` is
   bit-equal to the exact tier's log Z; ``swap_index`` to a new head keeps
   every state shape and serves a fresh engine's tokens; a two-block
   permutation is caught by ``verify_and_restore`` and the restored index
   and tokens are bit-equal to the clean ones; topk, mince and fmbe serve
   through ``tier_state`` on the shared index. Every run goes through the
   captured ``generate`` and then the host loop (which records the guard's
   flags of each step), bit-equal; the runs after the swap and after the
   restore must each capture afresh. Each run of the path starts
   with the launch counts at 0 and must launch ``ivf_decode``,
   ``union_scores``, ``fmbe_phi``, ``fmbe_z`` and the gated ``topk_z``.
   Times the fixed-capacity build, the swap, the restore and the digest,
   the gated ``topk_z`` with no query and with every query flagged, and a
   guarded against an unguarded output layer. The serving engines and
   parameters are then freed.
5c. The estimators phase (``estimators``), on the same parameters and the
   serving phase's 8 hidden states: ``PartitionLayer`` over qwen1.5-4b's
   lm_head (151936 x 2560, bf16) for exact, mimps (with an index), nmimps,
   uniform, mince, fmbe and selfnorm, its kernels (``topk_z``,
   ``ivf_score``, ``fmbe_z``, and ``fmbe_phi`` in the fmbe build) against
   ``use_kernel=False`` on the same injected draws: log Z within 1e-3,
   ``top_candidates`` (k 8) ids equal wherever the neighbouring scores are
   more than 1e-3 apart, two calls bit-equal, mimps within 0.05 of exact,
   the fmbe sketch's signed sums within 1e-4 of the sum of their terms;
   mince also with the paper's weighting. Each method's path starts with
   the launch counts at 0 and must launch its kernels. Then the paper's
   Fig. 1 and Tables 1-3 (``repro_torch.studies.paper_tables``) at the JAX
   scripts' sizes (n 20000, d 64, 100 queries, seeds 0-2, FMBE with 16384
   features), printed, their f32 kernels launched, and every ordering of
   ``paper_tables.ORDERINGS`` required. Then the paper's Table 4
   (``repro_torch.studies.table4_lbl``) at the JAX script's full size (an
   LBL model, V 10000, d 100, trained 300 NCE steps; 500 held-out
   contexts): its class vectors (d + 1 = 101 wide) and queries padded with
   zero columns to 104 for ``topk_z`` (the exact log Z) and ``ivf_score``
   (MIMPS over a 128-row block index), both launched at f32 only, held to
   ``use_kernel=False`` within 1e-3, the padded plain path to the unpadded
   one within T4_PAD_TOL, and MIMPS beating Z = 1 at every (n_probe, l).
6. Builds the training state of the same model (``init_train_state``:
   bf16 parameters, f32 AdamW moments) and holds the fused CE kernels
   against their plain versions on the forward's hidden states of one
   synthetic batch (B 4 x S 256, T = 1024), w = lm_head, g_nll = 1/T and
   the selfnorm cotangent g_lse = 2 alpha lse / T: nll and lse to 1e-3, dh
   and dW (f32, before the cast) to 2**-7 of the sum of their terms'
   magnitudes per element and 2**-10 on average (both versions round the
   coefficient to bf16), the same against ``fused_ce_bwd_chunked_plain``
   (the kernel's chunked decomposition), two calls bit-equal; times both
   beside their bounds, plain versions and library calls, and prints their
   achieved TFLOP/s and share of the bound, the backward's chunk size and
   scratch bytes, its peak memory across one call, each kernel's
   registers, shared memory and spills as ptxas reported them, each
   launch of the two by name (``torch.profiler``), and the backward with
   its dh and dW items dealt longest first (its path) against round-robin
   (the same bits required; timed in the order longest-first, round-robin,
   round-robin, longest-first).
7. Trains: 4 ``fused_ce`` steps on that batch, repeated (the loss must be
   finite and fall), then 2 ``selfnorm`` steps, each starting with the
   launch counts at 0 and launching each fused CE kernel exactly once;
   prints ms/step, tokens/s and peak memory, then one more step split
   into forward, loss, backward and optimizer, and one under
   ``torch.profiler`` (device busy time, idle share, top kernels and host
   ops).

7b. Estimator-backed training (``estimator_train``) of the same
   full-width model on the same batch, each loss from a fresh
   ``init_train_state`` (the previous state freed): mimps_ce (the 553-block
   IVF index in ``TrainState.index``) and lsh_ce (8 tables of 8-bit codes):
   at the first step's inputs the sparse CE's nll and log Z to 1e-5 of 1 +
   |value| from a float64 evaluation of the same formula on the same plan
   and operands, dh and dw before the cast to 1e-4 of the sum of their
   terms' magnitudes (1e-5 on average) and after it to GRAD_REL, every dw
   row outside head ∪ tail ∪ labels exactly 0, two calls bit-equal, and
   for lsh_ce each row of each token in exactly one of head, tail
   population and label term; then 4 steps, ``make_index_refresh`` between
   steps 2 and 3 (the index's shapes kept, churn and drift finite), the
   loss finite and falling; mimps_ce takes one more step split into parts
   and 2 fused_ce steps for comparison. mince_ce, nce and sampled take 2
   steps each (nce and sampled on one noise draw), finite and falling. The
   estimator steps launch none of the nine kernels. Logs ms a step (wall
   and CUDA events), tokens/s, peak memory, head_live, head_hit_rate and
   k_eff a step, the refresh's seconds and the sparse CE's ms.
7c. The checkpoint round trip (``checkpoint_round_trip``) on the reduced
   qwen1.5-4b config, mimps_ce and lsh_ce: save after 2 steps, restore
   (twice): every leaf, the index and the generator bit-equal to the
   saved state; step 3 from the two restored copies, and, if they are
   bit-equal, the uninterrupted step 3 equal to them bit for bit (else
   where they first differ is logged).

8. The f32 phase: the same model at full width in f32 with its depth cut
   to 4 layers (the one cut). Each estimator builds its engine (the f32
   fmbe build timed, its ``fmbe_phi`` launches all f32) and takes one
   decode step through the captured ``generate`` with the launch counts at
   0, bit-equal to the host loop's; each kernel of its path must launch,
   and only at f32 (``by_variant``). Every
   kernel is held to its plain version at f32 at the path's shapes under
   the limits above. The f32 CE pair and ``fmbe_phi`` run on the tensor
   cores on three exact bf16 planes of each f32 operand (omega's +-1 rows
   are exact as they are), and nothing is rounded to bf16: the CE
   backward's dh and dW to 1e-4 of the sum of their terms, 1e-5 on
   average; the CE forward's nll and lse to 1e-3 of its plain version and
   of its plane decomposition and to 1e-5 of 1 + |value| from float64;
   ``fmbe_phi`` to its plain version and to its plane decomposition; each
   kernel's split of its operands equal to ``split_planes`` bit for bit.
   Then 2 ``fused_ce`` train steps launch one f32 CE kernel of each kind a
   step.

8b. The audio phase (``audio_phase``), after the f32 model is freed:
   full-width musicgen-medium (48 layers, d 1536, 4 codebooks of vocab
   2048, untied; bf16, seed 0, nothing cut; the count held to the JAX
   package's). Serving has no retrieval state: the captured ``generate``
   (8 requests, prompt (8, 16, 4), 32 new) at temperature 0 and 1.0 on
   one captured step, bit-equal to the host loop and launching none of
   the nine kernels, ms a step and frames/s beside the trunk's weight
   read, the replay's profile and the trunk by kind; ``swap_index`` to new
   weights drops the captured step and serves a fresh engine's tokens.
   Training at B 4 x S 256 x 4 codebooks: the fused CE pair at the first
   step's flattened head (T 4096, V 8192, d 1536) against its plain
   version and against float64 (``ce_pair_held``: nll/lse within
   FWD64_REL of a score's sum of |terms|, dh and dW within GRAD_REL of the
   sum of their terms, two calls bit-equal), then fused_ce and
   selfnorm 3 steps each (one launch of each CE kernel a step), ce, nce
   and sampled 2 each (none), at TrainConfig's defaults (lr 3e-4 after a
   100-step warmup), the loss finite and fused_ce's falling each step.
8c. gemma3-4b training (``gemma3_train_phase``) at full width (bf16,
   seed 0, remat full, nothing cut), B 1 x S 2048 past its 1024 window:
   the CE pair at step 1's inputs (T 2048, V 262144, d 2560) against its
   plain version and float64, the tied table's gradient against the
   fused CE's dW plus the gather's scatter taken apart (within one bf16
   step), 3 fused_ce steps at TrainConfig's defaults (finite, falling
   each step) and one more split into parts; ms a step and peaks.
   Both phases run before the traffic phase. Their launches and their
   errors against the plain versions join the ``fused_ce_fwd``/
   ``fused_ce_bwd`` records; their errors against float64 go into the
   records' ``max_err_vs_float64`` and
   ``max_err_over_sum_terms_vs_float64``.

9. The traffic phase (``traffic``), last, on the serving phase's
   parameters made again from their seed (its ``torch.profiler`` sessions
   slow the host-bound train steps run after them in the same process;
   ``tools/traffic_train_order.py``): a mimps
   engine with the fixed-capacity index and the guard behind one
   ``Scheduler`` of 16 lanes (prompt cap 128, max_len 160), its step one
   CUDA graph a tier. Parity: six staggered requests (prompts 5-120, 4-32
   new tokens, greedy and sampled) give the tokens each gives alone in the
   table and through its solo captured ``generate(generator=)`` (where
   batch 1 differs, the first differing step and the trunk's batch-1 vs
   batch-16 hidden states are logged and every request is held to
   ``generate`` at batch 16, a sampled one with row 0 of generate's noise
   injected). Traffic: 64 requests (prompts 16-128, 32 new
   tokens) on Poisson arrivals at 0.25 a step: all complete, nothing is
   captured again, ``ivf_decode`` launches once a step and the gated
   ``topk_z`` twice; goodput, token-latency percentiles, first-token
   latency, occupancy, step device and host ms, the dedup ratio and the
   captures are logged beside the sequential captured ``generate`` over
   the same requests. Overload: 48 requests at twice the rate, queue 16,
   ladder watermarks 8/2: the tier walks mimps -> topk and back, every
   shed has its reason, completions balance, one capture a tier. Faults:
   a NaN lane contained, step faults retried, a permuted index restored
   by the digest every 4 steps with one capture again, tokens unchanged.
   A shared 64-token prefix (32 requests) through a 128-block pool of
   16-token blocks, plain and drafted by topk and fmbe at spec_k 4, cold
   and warm: tokens bit-identical to the plain scheduler without a pool.
   Last, one eager step of a busy table (12 of 16 lanes) at mimps, at
   topk, and drafted by topk and by fmbe: every ``ivf_decode``,
   ``union_scores``, ``fmbe_z`` and gated ``topk_z`` call of the step
   (Q 16, and 64 in a verify) made again and held to its plain version.

10. The MoE phase (``moe_last``), after every earlier phase's model,
   index and graphs are freed: full-width deepseek-moe-16b (28 layers, d
   2048, 64 routed experts of 1408 and 2 shared, top-6, vocab 102400,
   bf16, seeded random weights; nothing cut), its peak memory after the
   init and after the index build; a mimps engine at the config's
   partition with the fixed-capacity index and the guard. The captured
   ``generate`` (8 lanes, prompt 16, 16 new) at mimps and at the exact
   tier, bit-equal to the host loop, each kernel once a step;
   ``ops.ivf_block_scores`` at the MoE index's shapes and one mimps and
   one exact step of a busy 16-lane table (``held_step``) held to their
   plain versions; then the ``Server`` (32 Poisson requests on 16 lanes)
   with observability off and with ``Observability`` (trace, snapshot,
   shadow every 4 steps, harvest every 8, a scrape of ``/metrics``) in
   turns off, on, on, off: tokens bit-identical, one capture each, the
   trace, the snapshot and the scrape checked; the captured step's device
   ms, profile and trunk by kind (experts apart).

11. The families phase (``families_last``): gemma3-4b, rwkv6-7b
   and zamba2-7b in turn, each at its published widths (bf16, seed 0,
   nothing cut; the parameter count held to the JAX package's) and freed
   before the next, behind an engine at the config's partition with the
   guard (mimps at fixed capacity: 768 and 384 blocks; zamba2: exact).
   Peak memory after the init and after the index; the captured
   ``generate`` (8 lanes, greedy) bit-equal to the host loop, gemma3's
   prompt of 1024 carrying every local ring past its 1024 slots;
   ``ops.ivf_block_scores`` at the index; one busy 16-lane step at each
   tier with every kernel call held to its plain version and the ring
   geometry of ``ivf_decode`` and ``union_scores`` logged (d 2560 and
   4096); the scheduler on a staggered trace, every request in a fresh
   lane equal to ``generate`` at batch 16, the reused and the dead lane
   of RWKV6 and Zamba2 logged beside theirs (C11), the captured table
   equal to ``Scheduler(eager=True)`` bit for bit; the ``Server`` with
   ``Observability`` on, 32 Poisson requests, one capture; speculation
   and the prefix pool refused; the step's device ms, profile and trunk
   by kind (recurrences and conv apart).

11b. The mesh phase (``mesh_last``), after the families are freed, on
   the traffic phase's model and table (full-width qwen1.5-4b, mimps with
   the fixed-capacity index and the guard, 16 lanes). (a) In this
   process, a one-rank NCCL group at mesh (1, 1): the parity trace and 16
   traffic requests through the captured mesh step, whose tokens and log
   Z must equal the one-device captured scheduler's bit for bit, one
   capture; both steps' replay device ms, the NCCL kernels of a replay,
   the all-reduces of an eager step, the row gather and its all-reduce
   timed apart, and an eager step's kernel calls held to their plain
   versions. (b) Four processes of this script (``--mesh-rank``) on the
   one card over gloo, eager, joined with a deadline: at (1, 4) every
   method's ``shard_decode`` on 16 hidden states held to the one-device
   decode on the same operands (top-1 equal, log Z within 1e-5, ids where
   the scores are 1e-3 apart; whether the bits are equal logged); at
   (2, 2) four greedy requests of 16 tokens, each equal to ``generate``
   at batch 8 with the request in every lane (C9: a replica runs 8
   lanes). The ranks' launches, peak memory and seconds come back.

12. The VLM phase (``vlm_last``), last, after the families are freed:
   llama-3.2-vision-90b at its published widths (d 8192, d_ff 28672,
   vocab 128256, 1601 image tokens; bf16, seed 0) with its depth cut to
   30 layers, 6 whole groups of 4 self + 1 cross-attention block (the one
   cut; the count held to the JAX package's 27,770,986,496), the live
   CUDA tensors before the init, peak memory after the init and after the
   index build; a mimps engine at the config's partition with the
   fixed-capacity index and the guard. The captured ``generate`` (8
   requests, prompt 16, 32 new) with a seeded (8, 1601, 8192) image at
   temperature 0 and 1.0, bit-equal to the host loop, ``ivf_decode`` and
   the gated ``topk_z`` once a step; a second image on the same graph
   (no capture again) gives other tokens; the replay's profile and the
   trunk by kind ("cross kv", "cross attention" apart). On the prefill's
   hidden states mimps within 0.05 of the exact log Z; ``topk_z`` and
   ``ivf_decode`` at d 8192 held to their plain versions and timed
   (``topk_z[d8192]``, ``ivf_decode[d8192]``), the ring geometry at d
   8192; one eager step's ``ivf_decode`` and gated ``topk_z`` calls held
   to their plain versions (the gated one also with every lane flagged).

13. The training mesh phase (``train_mesh_last``): (a) in this
   process, a one-rank NCCL group at mesh (1, 1), full-width, full-depth
   qwen1.5-4b, fused_ce at B 4 x S 256: three sharded steps
   (``init_train_state(mesh=)``, ``make_train_step(mesh=)``), then, the
   sharded state freed, three one-device steps from the same seed: the
   losses, grad norms and every leaf of the parameters, m and v bit-equal
   (fingerprints of the int32 words on the device), each CE kernel once a
   step; ms a step of both, the parameters' gather alone and the third
   step's all-reduces timed apart. (b) Four processes of this script
   (``--train-mesh-rank``) on the one card over gloo, qwen1.5-4b at full
   width with its depth cut to 4 layers (1.095 B parameters), B 8 x S 256:
   rank 0 first takes two one-device steps, two more with two
   microbatches holding the two replicas' rows, and one mimps_ce step of
   each kind. The
   step computes on each rank's slices (the compute split over 'model':
   attention heads, MLP columns, vocab rows); no leaf is gathered whole.
   At (1, 4) one step and at (2, 2) two, fused_ce: the losses, grad norms
   and every leaf's gradient (m / (1 - b1) after step 1) within
   ``TM_*``'s limits of the one-device run, each model slice the same on
   both data replicas, and each rank's ``fused_ce_fwd`` and
   ``fused_ce_bwd`` at its V / model rows (the labels shifted, the LSEs
   combined over 'model') held to their plain versions; at (2, 2) one
   mimps_ce step (one plan over the whole batch) within the limits of
   one device's mimps_ce step (a figure past them within ``TM_NOISE``
   times its move in the two-microbatch mimps_ce step); one (2, 2) step
   with ``pod_axis="data"`` and int8: finite, both data replicas of each
   model slice bit-equal, one int32 all-reduce a leaf in the compressor.
   Each rank's CE launches, peak memory (beside the 6.57 GB of whole bf16
   parameters and f32 gradients a gathering rank holds), leaves gathered
   and seconds come back. (c) ``python -m repro_torch.launch.train
   --reduced`` on the card: 3 steps with a
   checkpoint at 2, then a run from that checkpoint alone: the final
   checkpoints bit-equal. (b) and (c) run at cut depth and the reduced
   config: four ranks share one card, and a full checkpoint is about 40 GB
   on disk. (c) runs in a thread beside (b).

14. The serving entry point and the autotuner (``serve_cli_last``),
   last: full-width qwen1.5-4b with a cold autotune cache of its own. (a)
   ``Engine(autotune=True, autotune_batch=16)`` at mimps sweeps
   ``ivf_decode`` at 8 and at 16 queries (one sweep a query-tile count);
   ``tune`` of the engine's exact, topk, fmbe and lsh tier states sweeps
   ``topk_z``, ``union_scores``, ``fmbe_z`` and ``lsh_probe`` on the same
   seeded batch's 8 and 16 rows: every candidate's burst time, each
   winner's ten-call graph time beside the default launch's, and the
   winner at its sweep's operands held to its plain version; the sweeps'
   timing launches are logged apart from the path's. (b) A second
   autotuned engine reads the cache (no sweep, the same config). (c)
   ``generate`` of 8 lanes, 32 new tokens at T 0 on the tuned engine
   (captured = host loop) equals an untuned engine's tokens; the two
   engines' captured steps at 8 and 16 lanes replayed in turns. (d)
   ``python -m repro_torch.launch.serve`` (16 slots, 32 requests, 16 new
   tokens, ``--sequential``, a trace and a snapshot) in a subprocess exits
   0 with every request done; goodput, sequential tokens/s, the C9
   agreement count and the trace's step spans (the first, which holds the
   step's capture, apart) logged; the port's ``obs_report`` exits 0 on
   the trace.

15. The dry run and cost report (``dryrun_last``), last: (a)
   ``python -m repro_torch.launch.dryrun`` for qwen1.5-4b at train_4k,
   prefill_32k, decode_32k and decode_32k mimps on mesh ``single`` (a
   fake process group of 256 ranks, one CPU process a cell, started
   first and joined last): each cell's per-rank counts logged and
   decode_32k's trunk FLOPs held to the config's closed form. (b) The
   traffic phase's captured 16-lane mimps step counted on fake tensors
   (``hlo_analysis.fake_copy`` of the scheduler) beside its replay by CUDA
   events and by kind (``breakdown.measure_step``): the whole step's share
   of the card's bound. (c) ``streaming_logz_argmax``'s ``topk_z`` route
   against its plain chunks at V 151936, then four processes of this
   script (``--dryrun-rank``) over gloo at mesh (1, 4): ``sharded_decode``
   mimps, mince and fmbe on (b)'s index with and without the kernels
   (``ivf_score``, ``fmbe_z``), held to each other, the exhaustive probe
   to ``topk_z``'s exact log Z, every rank's outputs bit-equal.

Every phase logs its seconds, the CUDA memory allocated before and after
it and its peak; a phase that leaves more than 256 MB allocated also logs
the allocator's largest segments (``memory_summary``).

Prints the kernel record as one JSON line before the last (each kernel at
bf16, the gated ``topk_z`` as ``topk_z[gated]``, ``topk_z`` at 16 lanes as
``topk_z[q16]``, whose launches are those of its 16-query instance (Q > 8)
in every phase and are counted in ``topk_z`` or ``topk_z[gated]`` too,
then each at f32 as
``<name>[f32]``, then ``topk_z`` and ``ivf_decode`` at the VLM's d 8192
as ``<name>[d8192]``, whose launches are the VLM phase's and are counted
in the bf16 records too), and as the last line ``{"ok": true,
"device": {...}}``. Any failure exits non-zero.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import gc
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores
TOL = 1e-3
CODE_REL = 1e-5                # a code may flip where |proj| <= this * |h||p|
FMBE_REL = 1e-4                # signed FMBE sums: of sum |terms|, + 1e-6
N_REQ, PROMPT, NEW = 8, 16, 16
SERVE_SEED = 11                # the decode generator's seed of a served pair
PHI_CHUNK_BLOCKS = 16          # blocks per fmbe_phi launch in the build
# fused CE backward: both versions round coef to bf16, so one coefficient
# may round one bf16 step (<= 2**-7 relative) apart; + 1e-5 for f32 sums
GRAD_REL = 2 ** -7 + 1e-5      # of sum |terms|, per element
GRAD_MEAN = 2 ** -10           # of sum |terms|, on average
# against float64 only the kernel's side rounds the coefficient to bf16: a
# dW element of one dominant term is off by that rounding alone, up to
# 2^-8 and 0.72 x 2^-9 on average over a binade
GRAD64_MEAN = 2 ** -9          # of sum |terms|, on average
TRAIN_B, TRAIN_S = 4, 256      # T = 1024 tokens a step
FUSED_STEPS, SELFNORM_STEPS = 4, 2
EST_STEPS = 4                  # mimps_ce and lsh_ce steps (a refresh after 2)
# the f32 phase: qwen1.5-4b at full width, f32, depth cut to F32_LAYERS
F32_LAYERS = 4
F32_STEPS = 2
# the f32 CE pair rounds nothing: f32 scores, exp and sums in another order
F32_GRAD_REL = 1e-4            # of sum |terms|, per element
F32_GRAD_MEAN = 1e-5           # of sum |terms|, on average
F32_FWD_REL = 1e-5             # f32 nll and lse to float64, of 1 + |value|
SERVE_METHODS = ("exact", "mimps", "topk", "mince", "fmbe", "selfnorm",
                 "lsh")
PATH_KERNELS = {"exact": ("topk_z",), "mimps": ("ivf_decode",),
                "topk": ("union_scores",), "mince": ("union_scores",),
                "fmbe": ("union_scores", "fmbe_z"),
                "selfnorm": ("topk_z",), "lsh": ("lsh_probe",)}


class SmokeError(RuntimeError):
    pass


MEM_LEFT_BYTES = 256e6          # a phase that leaves more: its segments


def memory_summary(torch, phase, top=6):
    """Logs the largest segments of the caching allocator
    (``torch.cuda.memory_snapshot()``): size, bytes allocated, the pool
    (a CUDA graph's private pool is not (0, 0)), the largest live blocks,
    and their allocation frames where the allocator recorded them (only
    with ``torch.cuda.memory._record_memory_history``, which this script
    leaves off: it would slow every timed phase)."""
    segs = sorted(torch.cuda.memory_snapshot(),
                  key=lambda s: -s["allocated_size"])[:top]
    for seg in segs:
        live = sorted((b for b in seg["blocks"]
                       if b["state"] == "active_allocated"),
                      key=lambda b: -b["size"])[:3]
        blocks = "; ".join(
            f"{b['size'] / 1e6:.1f} MB"
            + "".join(f" <- {f['filename'].rsplit('/', 1)[-1]}:{f['line']}"
                      f" {f['name']}" for f in b.get("frames", [])[:3])
            for b in live)
        log(f"  {phase} left: segment {seg['total_size'] / 1e6:.1f} MB, "
            f"{seg['allocated_size'] / 1e6:.1f} MB allocated, pool "
            f"{seg.get('segment_pool_id')}, stream {seg['stream']}; "
            f"largest live blocks: {blocks}")


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, warm=3):
    """Device time of ``fn``: median milliseconds over ``reps`` replays of a
    CUDA graph captured from one call, timed with CUDA events. The graph
    leaves out the host's launch overhead, which ``eager_ms`` includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_events(torch, graph.replay, reps)


def graph10_ms(torch, fn, reps=20, warm=3):
    """Device time of one call of ``fn`` in a CUDA graph of ten calls
    (median of ``reps`` replays, divided by ten): the one-call replay less
    most of a graph's own cost (``floor_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            fn()
    return _median_events(torch, graph.replay, reps) / 10


def floor_ms(torch):
    """The one-call replay of a graph of one one-element kernel: what a
    replay costs before any work."""
    one = torch.zeros(1, device="cuda")
    return time_ms(torch, lambda: one.add_(1.0))


def flushed_ms(torch, fn, reps=20):
    """Device time of ``fn`` with the L2 cache flushed before each call: a
    CUDA graph of a 64 MB write and then ``fn``, less a graph of the write
    alone (medians of ``reps`` replays each)."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    both = time_ms(torch, lambda: (scratch.zero_(), fn()), reps)
    return both - time_ms(torch, scratch.zero_, reps)


def share(bound, ms):
    """A kernel's time as a share of its bound, as a percentage."""
    return f"{100 * bound / ms:.1f}%"


def eager_ms(torch, fn, reps=20, warm=3):
    """Median milliseconds of one eager call, host launch overhead included."""
    for _ in range(warm):
        fn()
    return _median_events(torch, fn, reps)


def _median_events(torch, fn, reps):
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def wall_ms(torch, fn, reps=10):
    """Median host-clock milliseconds of ``fn`` ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def bound_ms(n_bytes, n_ops, f32_ops=0):
    """Least time for the work: bytes over the memory rate, or bf16 ``n_ops``
    at the tensor-core rate plus ``f32_ops`` at the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare_lse(name, got, want):
    got, want = got.float().cpu(), want.float().cpu()
    same_inf = (got.isneginf() == want.isneginf()).all().item()
    check(same_inf, f"{name}: -inf pattern differs")
    fin = ~want.isneginf()
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    check(err <= TOL, f"{name}: max abs err {err} > {TOL}")
    return err


def compare_topk(name, kv, ki, pv, pi):
    """kv/ki: kernel top-k; pv/pi: plain top-(k+1). Values agree to TOL at
    every rank; ids agree wherever the gap to both neighbours > TOL."""
    kv, ki, pv, pi = (t.cpu() for t in (kv, ki, pv, pi))
    k = kv.shape[1]
    err = (kv - pv[:, :k]).abs().max().item()
    check(err <= TOL, f"{name}: top-k scores differ by {err}")
    checked = 0
    for q in range(kv.shape[0]):
        for j in range(k):
            up = pv[q, j - 1] - pv[q, j] if j else float("inf")
            down = pv[q, j] - pv[q, j + 1]
            if up > TOL and down > TOL:
                check(ki[q, j] == pi[q, j],
                      f"{name}: query {q} rank {j} id {int(ki[q, j])} != "
                      f"plain {int(pi[q, j])}")
                checked += 1
    return err, checked


def compare_signed_sum(name, got, want, terms):
    """FMBE sums are signed and cancel: |got - want| <= 1e-4 * sum |terms|
    + 1e-6 along the last axis of ``terms``. Returns (max abs err, max
    err / tolerance)."""
    err = (got.double() - want.double()).abs()
    tol = FMBE_REL * terms.double().abs().sum(-1) + 1e-6
    ratio = (err / tol).max().item()
    check(ratio <= 1.0, f"{name}: error {err.max().item():.3e} exceeds "
          f"1e-4 of sum |terms| ({ratio:.3f} of the tolerance)")
    return err.max().item(), ratio


def capture_runner(torch, eng, tier=None):
    """Capture ``eng``'s decode step for N_REQ lanes ahead of ``generate``
    (its warm-up step and the capture, as ``generate`` would on first use).
    Returns (runner, wall seconds)."""
    from repro_torch.serve import engine as engine_mod
    torch.cuda.synchronize()
    t0 = time.time()
    run = engine_mod._graph_runner(eng, N_REQ, tier)
    run.capture(eng)
    torch.cuda.synchronize()
    return run, time.time() - t0


def served_pair(torch, eng, prompt, n, label, *, temperature=0.0,
                tier=None, seed=SERVE_SEED, wrap=None, host_first=None,
                img=None):
    """``generate`` through the captured step, then through the host loop
    from the same generator state (a VLM's image ``img`` in both); the
    tokens, log_prob and log_z must be bit-equal. ``wrap(fn)`` calls the
    captured run (the main path: a launch count is read there);
    ``host_first`` runs before the host loop. Returns ((tokens, aux, wall
    s) captured, (tokens, aux, wall s) host loop)."""
    from repro_torch.serve import generate
    runs = []
    for host_loop in (False, True):
        def run():
            eng.generator.manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.time()
            out, aux = generate(eng, prompt, n, return_aux=True,
                                temperature=temperature, tier=tier,
                                host_loop=host_loop, img=img)
            torch.cuda.synchronize()
            return out, aux, time.time() - t0
        if host_loop and host_first is not None:
            host_first()
        runs.append(wrap(run) if wrap is not None and not host_loop
                    else run())
    (a, a_aux, _), (b, b_aux, _) = runs
    check(torch.equal(a, b), f"{label}: captured tokens differ from the "
          f"host loop's")
    for name in ("log_prob", "log_z"):
        check(torch.equal(a_aux[name], b_aux[name]), f"{label}: captured "
              f"{name} differs from the host loop's")
    return runs


def load_zero(torch, run, prompt, steps):
    """Reset a captured step for ``steps`` replays of ``prompt`` (step 0,
    zero draws, temperature 0): a replay past the runner's ``max_len``
    buffers would index out of range."""
    tails = (None if run.tails is None else
             torch.zeros((steps, run.tails.shape[1]), dtype=torch.long,
                         device=run.tails.device))
    gumbel = torch.zeros((steps,) + tuple(run.gumbel.shape[1:]),
                         device=run.gumbel.device)
    run.load(prompt, tails, gumbel, 0.0)


def replay_ms(torch, run, prompt, reps=10, rounds=3):
    """Device milliseconds of one replay of a captured step: the median of
    ``rounds`` x ``reps`` replays, each round from step 0 of ``prompt``
    (CUDA events)."""
    times = []
    for _ in range(rounds):
        load_zero(torch, run, prompt, reps)
        times.append(_median_events(torch, run.graph.replay, reps))
    return statistics.median(times)


def per_lane_step(torch, eng, prompt, card):
    """Lanes shifted by 0 to 3 positions replay 4 prompt tokens eagerly
    (``Engine.decode_step`` on a (B,) position vector); the next step,
    captured in a CUDA graph and replayed, must equal the same step taken
    eagerly bit for bit: tokens, log_prob, log_z and the KV cache."""
    from repro_torch.serve import ServeState
    pc = eng.cfg.partition
    b = prompt.shape[0]
    dev = prompt.device
    gen = torch.Generator(device=dev).manual_seed(6)
    temp = torch.zeros((), dtype=torch.float32, device=dev)
    gumbel = torch.zeros((b, pc.sample_k), device=dev)
    pos0 = (torch.arange(b, device=dev) % 4).to(torch.int32)
    state = ServeState(cache=eng.model.init_decode_state(b, eng.max_len, dev),
                       pos=pos0, last_token=prompt[:, 0])
    for t in range(4):
        tail = eng.backend.draw_tail(eng.state, pc, gen)
        state = dataclasses.replace(state, last_token=prompt[:, t])
        _, state = eng.decode_step(state, temp, tail_idx=tail, gumbel=gumbel)
    tail = eng.backend.draw_tail(eng.state, pc, gen)
    state = dataclasses.replace(state, last_token=prompt[:, 4])
    eager_cache = {name: t.clone() for name, t in state.cache.items()}
    want, _ = eng.decode_step(dataclasses.replace(state, cache=eager_cache),
                              temp, tail_idx=tail, gumbel=gumbel)

    def step():
        return eng.decode_step(state, temp, tail_idx=tail, gumbel=gumbel)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()             # writes the same KV at the same slots
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()
    graph.replay()
    torch.cuda.synchronize()
    for name in ("token", "log_prob", "log_z", "overflow"):
        check(torch.equal(got[name], want[name]), f"per-lane positions: "
              f"the captured step's {name} differs from the eager step's")
    for name in eager_cache:
        check(torch.equal(state.cache[name], eager_cache[name]),
              f"per-lane positions: the captured step's KV {name} differs")
    log(f"per-lane positions {state.pos.tolist()}: one captured "
        f"{eng.backend.method} step bit-equal to the eager step (tokens, "
        f"log_prob, log_z, KV cache) [{card}]")


# where a decode trunk op runs, by the port function that calls it
TRUNK_KINDS = {"rmsnorm": "norms", "apply_rope": "RoPE",
               "rope_frequencies": "RoPE", "_project_qkv": "projections",
               "_dyn_update": "attention", "decode_position": "position",
               "embed": "embedding", "embed_tokens": "embedding",
               "tblock_decode": "elementwise",
               "mlp": "elementwise", "decode_self_attention": "attention",
               "wkv_scan": "recurrence", "ssm_scan": "recurrence",
               "_causal_conv": "conv", "_token_shift": "token shift",
               "<genexpr>": "token shift",   # rwkv's five interpolations
               "rwkv_time_mix": "rwkv mixes", "rwkv_channel_mix":
               "rwkv mixes", "rwkv_block": "elementwise",
               "mamba_block": "mamba other", "_copy_into": "state copy"}


def trunk_kinds(torch, fn, img=None):
    """Device milliseconds of one eager call of the decode trunk ``fn`` by
    kind: each torch call is put under a profiler range named by the port
    function that makes it (``TRUNK_KINDS``; a matmul inside
    ``decode_self_attention`` or ``mlp`` is a projection; inside
    ``moe_block`` the matmuls (experts, shared experts, router) are "moe
    matmuls" and every other op "moe other"; inside a VLM's
    ``cross_attention`` the products of the image ``img`` with wk and wv
    are "cross kv", the query and output projections "projections" and
    every other op "cross attention"). Returns ({kind: (device ms,
    kernels)}, the trunk's output)."""
    from torch.autograd import DeviceType
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile, record_function

    class Kinds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None and "repro_torch" not in \
                    f.f_code.co_filename:
                f = f.f_back
            where = f.f_code.co_name if f is not None else ""
            kind = TRUNK_KINDS.get(where, "other")
            in_moe = in_cross = False
            while f is not None and not (in_moe or in_cross):
                in_moe = f.f_code.co_name == "moe_block"
                in_cross = f.f_code.co_name == "cross_attention"
                f = f.f_back
            if getattr(func, "__name__", "") in ("__matmul__", "matmul"):
                kind = ("moe matmuls" if in_moe else "cross kv"
                        if in_cross and args and args[0] is img
                        else "projections")
            elif in_moe:
                kind = "moe other"
            elif in_cross:
                kind = "cross attention"
            with record_function(f"kind:{kind}"):
                return func(*args, **(kwargs or {}))

    def n_kernels(e):
        return len(e.kernels) + sum(n_kernels(c) for c in e.cpu_children)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with Kinds():
            out = fn()
        torch.cuda.synchronize()
    kinds = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("kind:"):
            ms, n = kinds.get(e.name[5:], (0.0, 0))
            kinds[e.name[5:]] = (ms + e.device_time_total / 1e3,
                                 n + n_kernels(e))
    return kinds, out


def step_breakdown(torch, run, eng, params, toks, pos, card, label,
                   img=None):
    """One replay of a captured bf16 decode step under torch.profiler (its
    kernels and their device time), and one eager trunk call by kind
    (``trunk_kinds``; a VLM's with its image ``img``), its output
    bit-equal to the plain call's. Returns the replay's kernel count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    load_zero(torch, run, toks[:, None], 2)
    run.graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run.graph.replay()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:50]
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"captured step profile ({label}, one replay): {len(kern)} kernels, "
        f"{sum(ms for ms, _ in by_name.values()):.3f} ms of kernel time; "
        f"top by time: "
        + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, (ms, c) in top)
        + f" [{card}]")
    cache = eng.model.init_decode_state(N_REQ, eng.max_len, toks.device)
    want = eng.model.decode_step(params, cache, toks, pos, img=img)
    kinds, got = trunk_kinds(torch, lambda: eng.model.decode_step(
        params, cache, toks, pos, img=img), img=img)
    check(torch.equal(got, want), "the trunk under the profiler's ranges "
          "differs from the plain trunk")
    total = sum(ms for ms, _ in kinds.values())
    log(f"{label} trunk by kind (eager, "
        f"{eng.cfg.n_layers} layers, kernel time): {total:.3f} ms in "
        f"{sum(n for _, n in kinds.values())} kernels; "
        + "; ".join(f"{k} {ms:.3f} ms ({n} kernels)" for k, (ms, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0]))
        + f"; weight read bound "
        f"{trunk_bytes(params, eng.cfg) / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"[{card}]")
    return len(kern)


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:        # a rank of mesh_last's (b)
        return mesh_rank(torch, int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--dryrun-rank"]:      # a rank of dryrun_last's (c)
        return dryrun_rank(torch, int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--train-mesh-rank"]:  # a rank of train_mesh_last
        return train_mesh_rank(torch, int(sys.argv[2]), sys.argv[3],
                               sys.argv[4])
    # the plain versions' f32 products run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_phi, fmbe_z
    from repro_torch.kernels.fused_ce import fused_ce_bwd, fused_ce_fwd
    from repro_torch.kernels.ivf_score import (ivf_decode, ivf_score,
                                              union_scores)
    from repro_torch.kernels.lsh_probe import lsh_probe
    from repro_torch.kernels.topk_z import topk_z

    kernels = {"topk_z": topk_z, "ivf_decode": ivf_decode,
               "union_scores": union_scores, "fmbe_phi": fmbe_phi,
               "fmbe_z": fmbe_z, "fused_ce_fwd": fused_ce_fwd,
               "fused_ce_bwd": fused_ce_bwd, "lsh_probe": lsh_probe,
               "ivf_score": ivf_score}

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.time()
    built = _build.build_all()
    log(f"build: {time.time() - t0:.1f} s (built {built})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def timed(phase, *args):
        t0 = time.time()
        gc.collect()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = phase(torch, card, *args)
        gc.collect()
        # C15: cuBLAS keeps a workspace for every stream a matmul ran on
        # (each graph capture's), after the phase's graphs are gone
        held = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        left = torch.cuda.memory_allocated()
        log(f"phase {phase.__name__}: {time.time() - t0:.1f} s; allocated "
            f"{left / 1e9:.3f} GB after it ({start / 1e9:.3f} GB before; "
            f"{(held - left) / 1e9:.3f} GB of cuBLAS workspaces freed), "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB since "
            f"its last reset [{card}]")
        if left - start > MEM_LEFT_BYTES:
            try:
                memory_summary(torch, phase.__name__)
            except Exception as e:                          # noqa: BLE001
                log(f"  memory_summary failed: {type(e).__name__}: {e}")
        return out

    records, study = timed(serve, kernels)
    torch.cuda.empty_cache()                    # the serving state is gone
    ce_records = timed(train, kernels)
    records += ce_records
    torch.cuda.empty_cache()                    # the training state is gone
    timed(estimator_train, kernels, ce_records)
    torch.cuda.empty_cache()
    timed(checkpoint_round_trip)
    f32_records = timed(f32_phase, kernels)
    for rec in f32_records:                     # the studies ran at f32
        rec["launches"] += study[rec["name"].removesuffix("[f32]")]
    gc.collect()
    torch.cuda.empty_cache()
    # the audio family and gemma3 training, before the traffic phase
    for phase in (audio_phase, gemma3_train_phase):
        counts, held = timed(phase, kernels)
        gc.collect()
        torch.cuda.empty_cache()                # the phase's model is gone
        for rec in ce_records:
            rec["launches"] += counts[rec["name"]]
            for key, err in held[rec["name"]].items():
                rec[key] = max(rec.get(key, 0.0), err)
    # traffic last: its torch.profiler sessions slow the host-bound train
    # steps run after them in the same process
    late = [timed(traffic_last, kernels)]
    gc.collect()
    torch.cuda.empty_cache()                    # the traffic state is gone
    late.append(timed(moe_last, kernels))
    gc.collect()
    torch.cuda.empty_cache()                    # the MoE model is gone
    late.append(timed(families_last, kernels))
    gc.collect()
    torch.cuda.empty_cache()                    # the families are gone
    late.append(timed(mesh_last, kernels))
    gc.collect()
    torch.cuda.empty_cache()                    # the mesh ranks are gone
    *vlm, vlm_records = timed(vlm_last, kernels)
    late.append(vlm)
    gc.collect()
    torch.cuda.empty_cache()                    # the VLM is gone
    counts, held = timed(train_mesh_last, kernels)
    for rec in ce_records:
        rec["launches"] += counts[rec["name"]]
        for key, err in held[rec["name"]].items():
            rec[key] = max(rec.get(key, 0.0), err)
    gc.collect()
    torch.cuda.empty_cache()                    # the training mesh is gone
    late.append(timed(serve_cli_last, kernels))
    gc.collect()
    torch.cuda.empty_cache()                    # the served engines are gone
    late.append(timed(dryrun_last, kernels))
    for counts, n_gated, held in late:
        for rec in records:                     # bf16 records, by name
            rec["launches"] += n_gated if rec["name"] == "topk_z[gated]" \
                else counts.get(rec["name"], 0)
            if rec["name"] in held:             # these phases' shapes too
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         held[rec["name"]])
    q16 = next(rec for rec in records if rec["name"] == Q16)
    check(q16["launches"] > 0, f"{Q16}: the 16-lane paths never launched "
          f"topk_z's 16-query instance")
    records += f32_records + vlm_records
    line = {"kernels": records}
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def serve(torch, card, kernels):
    """Phases 2-5c: the serving engines, the seven serving kernels against
    their plain versions, the estimators, serving, the step split, the
    lifecycle phase and the estimators phase. Returns the seven kernel
    records, then the gated ``topk_z``'s and ``topk_z[q16]`` (16 hidden
    states of the same model, the traffic path's lanes), and the studies'
    f32 launches by kernel; every serving tensor is freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels import fmbe as kfmbe
    from repro_torch.kernels.fmbe import fmbe_phi
    from repro_torch.core.lsh import draw_tail_ids
    from repro_torch.models import Model
    from repro_torch.serve import Engine, generate

    def reset_counts():
        _build.reset_counts(kernels.values())

    def read_counts():
        return {name: fn.launches for name, fn in kernels.items()}

    # -- 2. model and engines --------------------------------------------------
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")

    def with_method(method):
        return dataclasses.replace(cfg, partition=dataclasses.replace(
            cfg.partition, method=method))

    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.time() - t0:.1f} s")
    max_len = PROMPT + NEW
    engines = {"exact": Engine(Model(with_method("exact")), params, max_len,
                               seed=1)}
    t0 = time.time()
    engines["mimps"] = Engine(Model(cfg), params, max_len, seed=1)
    torch.cuda.synchronize()
    index = engines["mimps"].index
    check(index is not None, "mimps engine built no index")
    log(f"index: {index.n_blocks} blocks of {index.block_rows} rows, "
        f"{index.v_blocks.numel() * 2 / 1e9:.3f} GB, k-means build "
        f"{time.time() - t0:.1f} s")
    for method in ("topk", "mince", "selfnorm"):
        engines[method] = Engine(Model(with_method(method)), params, max_len,
                                 seed=1, index_assign=index.assign)
    reset_counts()
    t_fmbe = time.time()
    engines["fmbe"] = Engine(Model(with_method("fmbe")), params, max_len,
                             seed=1, index_assign=index.assign)
    torch.cuda.synchronize()
    fmbe_secs = time.time() - t_fmbe
    build_counts = read_counts()
    check(build_counts["fmbe_phi"] > 0, "the fmbe build never launched "
          "fmbe_phi")
    check(fmbe_phi.by_variant["bf16"] == build_counts["fmbe_phi"],
          f"the bf16 fmbe build ran fmbe_phi variants "
          f"{fmbe_phi.by_variant}, want the tensor-core one only")
    t0 = time.time()
    engines["lsh"] = Engine(Model(with_method("lsh")), params, max_len,
                            seed=1)
    torch.cuda.synchronize()
    lidx = engines["lsh"].state.lsh
    check(lidx is not None, "lsh engine built no index")
    log(f"lsh index: {lidx.n_tables} tables of {lidx.n_bits} bits, "
        f"{lidx.n_buckets} buckets of {lidx.bucket_cap} rows, "
        f"{int((lidx.slot_of_row < 0).sum())} of {lidx.n * lidx.n_tables} "
        f"row-table slots dropped, largest bucket "
        f"{int((lidx.buckets >= 0).sum(-1).max())}, build "
        f"{time.time() - t0:.2f} s [{card}]")
    fstate = engines["fmbe"].state.fmbe
    fm = fstate.fm
    check(fstate.lambda_blocks is not None, "fmbe engine built no block "
          "sketch")
    check(bool(torch.isfinite(fstate.lambda_blocks).all()),
          "fmbe lambda_blocks not finite")
    deg_sum = int(fm.degree.sum())
    log(f"fmbe build: P {fm.omega.shape[0]} features, max degree "
        f"{fm.omega.shape[1]}, mean degree {deg_sum / fm.omega.shape[0]:.4f}, "
        f"{fmbe_secs:.3f} s (engine build: k-means assignment injected, "
        f"index, pack, sketch) with launches {build_counts} [{card}]")
    for name, eng in engines.items():
        check(eng.backend.method == name, f"{name}: engine serves "
              f"{eng.backend.method}")
        check((eng.index is not None) ==
              (name in ("mimps", "topk", "mince", "fmbe")),
              f"{name}: unexpected index state")
        if eng.index is not None:
            check(torch.equal(eng.index.v_blocks, index.v_blocks),
                  f"{name}: index differs from mimps's")

    # decode hidden states of the real model for the kernel comparisons
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (N_REQ,), generator=gen, device=dev)
    exact_eng = engines["exact"]
    cache = exact_eng.model.init_decode_state(N_REQ, max_len, dev)
    h = exact_eng.model.decode_step(params, cache, toks, 0)
    w = exact_eng.state.w
    pc = cfg.partition
    k = pc.sample_k
    q = h.shape[0]
    log(f"hidden states: Q {q}, |h|_2 mean "
        f"{h.float().norm(dim=-1).mean().item():.2f}")

    # -- 3. kernels against their plain versions -----------------------------
    floor = floor_ms(torch)
    log(f"graph floor: a CUDA graph of one one-element kernel replays in "
        f"{floor:.4f} ms [{card}]")
    tz = topk_z_phase(torch, card, h, w, k)
    # the traffic path's 16 lanes: 16 decode hidden states of the same
    # model (their own generator: the draws below stay as they were)
    gen16 = torch.Generator(device=dev).manual_seed(3)
    cache16 = exact_eng.model.init_decode_state(T_SLOTS, max_len, dev)
    h16 = exact_eng.model.decode_step(
        params, cache16, torch.randint(0, cfg.vocab, (T_SLOTS,),
                                       generator=gen16, device=dev), 0)
    tz16 = dict(topk_z_phase(torch, card, h16, w, k, tag="[q16]"),
                launches=0)
    log(f"topk_z at Q {T_SLOTS} against Q {q}: {tz16['ms']:.4f} ms = "
        f"{tz16['ms'] / tz['ms']:.4f} of the Q {q} time (ten "
        f"{tz16['graph10_ms'] / tz['graph10_ms']:.4f}) [{card}]")
    del cache16, h16
    plan = make_plan(index, h, pc.n_probe, pc.l, generator=gen)
    ivf = ivf_decode_phase(torch, card, index, h, plan, pc, k)
    uni = union_scores_phase(torch, card, index, h, plan)
    fz = fmbe_z_phase(torch, card, fm, fstate, h, plan, deg_sum)

    # fmbe_phi on one real build chunk of v_blocks, and that chunk's
    # lambda_blocks as the build computed them
    fph = fmbe_phi_phase(torch, card, fm, index, fstate, deg_sum)

    lsp = lsh_probe_phase(torch, card, lidx, w, h, pc, k, gen)
    ivs = ivf_score_phase(torch, card, kernels, index, h, plan)

    # -- 4. the estimators on the same hidden states and tail draws -----------
    tail_idx = torch.randint(0, cfg.vocab, (pc.l,), generator=gen, device=dev)

    def decode(method, kk=k):
        eng = engines[method]
        if method == "lsh":           # lsh draws its own norm-tempered tail
            return eng.backend.decode(eng.state, h, pc, k=kk, generator=gen)
        return eng.backend.decode(eng.state, h, pc, k=kk, tail_idx=tail_idx)

    ex, mi, mc, tk, fb = (decode(m) for m in ("exact", "mimps", "mince",
                                              "topk", "fmbe"))
    gaps = {}
    for name, out in (("mimps", mi), ("mince", mc), ("topk", tk),
                      ("fmbe", fb)):
        check(bool(torch.isfinite(out.log_z).all()),
              f"{name} log_z not finite")
        gaps[name] = (out.log_z - ex.log_z).abs().max().item()
    check(gaps["mimps"] < 0.05, f"mimps log_z off the exact log_z by "
          f"{gaps['mimps']}")
    mince_gap = (mc.log_z - mi.log_z).abs().max().item()
    check(mince_gap <= TOL, f"mince log_z off mimps's by {mince_gap}")
    over = (tk.log_z - ex.log_z).max().item()
    check(over <= TOL, f"topk log_z above the exact log_z by {over}")
    mi_next = decode("mimps", k + 1)
    _, n_ids = compare_topk("topk vs mimps", tk.top_score, tk.top_id,
                            mi_next.top_score, mi_next.top_id)
    below = (fb.head_lse - fb.log_z).max().item()
    check(below <= TOL, f"fmbe log_z below its head_lse by {below}")
    ls = decode("lsh")
    check(bool(torch.isfinite(ls.log_z).all()), "lsh log_z not finite")
    gaps["lsh"] = (ls.log_z - ex.log_z).abs().max().item()
    ls_below = (ls.head_lse - ls.log_z).max().item()
    check(ls_below <= TOL, f"lsh log_z below its head_lse by {ls_below}")
    log(f"estimators vs exact log_z on the same hidden states (max abs): "
        + ", ".join(f"{m} {g:.4e}" for m, g in gaps.items())
        + f"; mince vs mimps {mince_gap:.2e}; topk - exact at most "
        f"{over:.4e}, {n_ids} topk ids equal mimps's; fmbe log_z - head_lse "
        f"at least {-below:.4e}; lsh log_z - exact per query "
        f"{[round(x, 4) for x in (ls.log_z - ex.log_z).tolist()]}, log_z - "
        f"head_lse at least {-ls_below:.4e}, union {int(ls.head_live)}, "
        f"k_eff {ls.k_eff.tolist()}")

    # -- 5. serve ------------------------------------------------------------
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    path_kernels = PATH_KERNELS
    served = {}
    totals = {name: 0 for name in kernels}
    totals["fmbe_phi"] = build_counts["fmbe_phi"]        # the fmbe build
    totals["ivf_score"] = ivs.pop("path_launches")    # ops.ivf_block_scores
    lsh_backend = engines["lsh"].backend

    # every fmbe_pack call from here on: a decode must never pack (it reads
    # degree to the host); the fmbe build made the pack the decode reads
    real_pack = kfmbe.fmbe_pack
    packs = []

    def counting_pack(*args, **kwargs):
        packs.append(1)
        return real_pack(*args, **kwargs)

    steps = PROMPT + NEW - 1
    runners = {}
    path_counts = {}

    def path_run(fn):
        """A captured run of the main path: the counts from 0, read
        after."""
        reset_counts()
        res = fn()
        path_counts.update(read_counts())
        return res

    for method, needs in path_kernels.items():
        eng = engines[method]
        run, capture_s = capture_runner(torch, eng)
        runners[method] = run
        kfmbe.fmbe_pack = counting_pack
        try:
            (out, aux, secs), (_, _, host_secs) = served_pair(
                torch, eng, prompt, NEW, f"serve {method}", wrap=path_run)
        finally:
            kfmbe.fmbe_pack = real_pack
        check(not packs, f"{method}: the serving run called fmbe_pack "
              f"{len(packs)} times")
        counts = dict(path_counts)
        check(out.shape == (N_REQ, NEW), f"{method}: tokens {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"{method}: token out of range")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"{method}: log_z not finite")
        check(eng.captures == 1, f"{method}: {eng.captures} captures")
        for name in needs:
            check(counts[name] > 0 and counts[name] % steps == 0,
                  f"{method}: the main path launched {name} "
                  f"{counts[name]} times in {steps} replays")
        for name in totals:
            totals[name] += counts[name]
        dev_ms = replay_ms(torch, run, prompt)
        served[method] = dict(tokens=out.cpu(), counts=counts)
        log(f"serve {method}: {N_REQ} requests x ({PROMPT} prompt + {NEW} "
            f"new), captured: {secs / steps * 1e3:.3f} ms/step wall, "
            f"{N_REQ * NEW / secs:.1f} new tokens/s, replay device "
            f"{dev_ms:.3f} ms/step, capture {capture_s:.3f} s; host loop: "
            f"{host_secs / steps * 1e3:.3f} ms/step, "
            f"{N_REQ * NEW / host_secs:.1f} new tokens/s; tokens, log_prob "
            f"and log_z bit-equal; launches {counts}, fmbe_pack calls "
            f"{len(packs)} [{card}]")

    # mimps at temperature 1.0: one graph serves every temperature
    eng = engines["mimps"]
    (t_out, _, secs), (_, _, host_secs) = served_pair(
        torch, eng, prompt, NEW, "serve mimps T=1.0", temperature=1.0)
    check(eng.captures == 1, "mimps at temperature 1.0 captured again")
    log(f"serve mimps at temperature 1.0: captured {secs / steps * 1e3:.3f} "
        f"ms/step, host loop {host_secs / steps * 1e3:.3f} ms/step, "
        f"bit-equal, {(t_out.cpu() != served['mimps']['tokens']).sum()} of "
        f"{t_out.numel()} tokens differ from greedy [{card}]")

    # the lsh branches, each captured and bit-equal to the eager loop; the
    # eager loop records each step's union
    cap = lsp["trimmed_capacity"]

    def lsh_unions(eng, label):
        unions = []

        class RecordingLsh(type(lsh_backend)):
            def decode(self, *args, **kwargs):
                out = super().decode(*args, **kwargs)
                unions.append(out.head_live)
                return out

        eng.backend = RecordingLsh()
        try:
            eng.generator.manual_seed(SERVE_SEED)
            generate(eng, prompt, NEW, host_loop=True)
        finally:
            eng.backend = lsh_backend
        unions = [int(u) for u in unions]
        check(len(unions) == steps, f"{label}: {len(unions)} steps recorded")
        return unions

    unions = lsh_unions(engines["lsh"], "lsh")
    n_trim = sum(u <= cap for u in unions)
    check(n_trim > 0, "lsh: no step took the trimmed branch")
    log(f"serve lsh: candidate union per step (trimmed capacity {cap}): "
        f"{unions}; trimmed branch on {n_trim} of {len(unions)} steps, "
        f"dense fallback on {len(unions) - n_trim}")
    dense_cap = 64
    dense_eng = Engine(Model(dataclasses.replace(cfg, partition=
                                                 dataclasses.replace(
                                                     cfg.partition,
                                                     method="lsh",
                                                     head_cap=dense_cap))),
                       params, max_len, seed=1, lsh_proj=lidx.proj)
    run, capture_s = capture_runner(torch, dense_eng)
    (_, d_aux, secs), (_, _, host_secs) = served_pair(
        torch, dense_eng, prompt, NEW, "serve lsh dense", wrap=path_run)
    check(path_counts["lsh_probe"] == steps,
          f"lsh dense: {path_counts['lsh_probe']} lsh_probe launches")
    totals["lsh_probe"] += path_counts["lsh_probe"]
    d_unions = lsh_unions(dense_eng, "lsh dense")
    check(all(u > dense_cap for u in d_unions), f"lsh with head_cap "
          f"{dense_cap}: a step kept the trimmed branch ({d_unions})")
    d_ms = replay_ms(torch, run, prompt)
    log(f"serve lsh dense (head_cap {dense_cap}, every step's union "
        f"{min(d_unions)}-{max(d_unions)} rows past it): captured "
        f"{secs / steps * 1e3:.3f} ms/step, replay device {d_ms:.3f} "
        f"ms/step, host loop {host_secs / steps * 1e3:.3f} ms/step, "
        f"bit-equal [{card}]")
    del dense_eng, run

    for rec in (tz, ivf, uni, fph, fz, lsp, ivs):
        rec["launches"] = totals[rec["name"]]
    for rec in (tz, ivf, uni, fz, lsp, ivs):       # the decode kernels
        rec["floor_ms"] = floor
    for method in ("mimps", "topk", "mince", "fmbe", "selfnorm", "lsh"):
        for ref in ("exact", "mimps"):
            share = (served[method]["tokens"] == served[ref]["tokens"]
                     ).float().mean().item()
            log(f"share of {method} greedy tokens equal to {ref}'s: "
                f"{share:.4f}")

    # lanes at different positions: one captured step bit-equal to eager
    per_lane_step(torch, engines["mimps"], prompt, card)

    # where a decode step's time goes: trunk vs output layer, host clock
    # (synchronised) beside device time (CUDA graph replay)
    pos1 = torch.ones((), dtype=torch.int32, device=dev)
    lsh_tail = draw_tail_ids(lidx, pc.l, gen)
    parts = [("trunk", lambda: exact_eng.model.decode_step(
        params, cache, toks, pos1))]
    parts += [(f"{m} output", lambda m=m: decode(m))
              for m in ("exact", "mimps", "topk", "mince", "fmbe",
                        "selfnorm")]
    parts.append(("lsh output", lambda: engines["lsh"].backend.decode(
        engines["lsh"].state, h, pc, k=k, tail_idx=lsh_tail)))
    for name, fn in parts:
        log(f"step part {name}: wall {wall_ms(torch, fn):.3f} ms, "
            f"device {time_ms(torch, fn):.3f} ms [{card}]")
    step_breakdown(torch, runners["mimps"], exact_eng, params, toks, pos1,
                   card, "mimps")
    del runners
    records = [tz, ivf, uni, fph, fz, lsp, ivs]
    del engines, exact_eng, cache, fstate, fm, lidx, index, plan
    gc.collect()
    torch.cuda.empty_cache()
    gated, life = lifecycle(torch, card, kernels, params, cfg, floor)
    for rec in records:
        rec["launches"] += life[rec["name"]]
    layer_counts, study_counts = estimators(torch, card, kernels, params,
                                            cfg, h)
    for rec in records:
        rec["launches"] += layer_counts[rec["name"]]
    return records + [gated, tz16], study_counts


# the traffic phase: full-width qwen1.5-4b behind the slot scheduler
T_SLOTS, T_PROMPT_CAP, T_NEW = 16, 128, 32
T_MAX_LEN = T_PROMPT_CAP + T_NEW
T_PARITY = ((5, 32, 0.0), (40, 4, 0.5), (120, 16, 0.0), (17, 8, 0.7),
            (77, 24, 0.0), (100, 12, 0.9))      # (prompt, new tokens, T)
T_PARITY_AT = (0, 3, 7, 12, 20, 30)
T_REQUESTS, T_RATE = 64, 0.25     # the traffic run: Poisson, numpy seed 0
T_OVERLOAD = 48                   # at twice the rate
T_PREFIX, T_PREFIX_REQ, T_PREFIX_NEW = 64, 32, 16
T_SPEC_K = 4
T_HELD_LANES, T_HELD_WARM = 12, 3    # the held steps' busy table


def traffic_last(torch, card, kernels):
    """Phase 9: the serving phase's full-width bf16 parameters made again
    from the same seed, then ``traffic``; returns what it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(f"traffic: the serving phase's parameters again (seed 0), "
        f"{time.time() - t0:.1f} s [{card}]")
    return traffic(torch, card, kernels, params, cfg)


def traffic(torch, card, kernels, params, cfg):
    """Phase 9: traffic serving (``repro_torch.serve.Scheduler`` and
    ``Server``) at full width. A mimps engine with the fixed-capacity index
    and the guard, and one scheduler of T_SLOTS lanes (prompt cap 128,
    max_len 160), whose step is one CUDA graph a tier. Runs, each with the
    launch counts from 0:

    1. Parity: six requests (prompts 5-120, 4-32 new tokens, three greedy,
       three at T 0.5-0.9 with their own seeds), admitted staggered: each
       request's tokens equal the same request alone in the table, and its
       solo captured ``generate(..., generator=<its seed>)``.
    2. Traffic: 64 requests (prompts cycling 16, 32, 64, 128; 32 new
       tokens; even ones greedy, odd ones at T 0.8), Poisson arrivals at
       0.25 a step (numpy seed 0): every request completes, nothing is
       captured again, ``ivf_decode`` launches once a step and the gated
       ``topk_z`` twice (the guard and the shadow gate). Logged beside the
       sequential captured ``generate`` over the same requests.
    3. Overload: 48 requests at twice the rate with a bounded queue, a
       default deadline and the ladder: the tier walks mimps -> topk and
       back, every shed has its reason, completions balance submissions,
       one capture a tier and none after.
    4. Faults: a NaN lane (its neighbours bit-identical to the fault-free
       run, the guard's flags counted), a step fault (retried, tokens
       unchanged), a permuted index with a digest every 4 steps (restored,
       every token unchanged, exactly one capture again, its seconds
       logged).
    5. A shared 64-token prefix with 1-4-token tails, 32 requests, through
       a 128-block pool of 16-token blocks: plain, and drafted by topk and
       by fmbe at spec_k 4, each on a cold and a warm pool, tokens
       bit-identical to the plain scheduler without a pool.
    6. The step's kernels at the table's shapes: on eager schedulers with
       12 of 16 lanes live at staggered positions, one mimps step, one topk
       step and one verify drafted by topk and by fmbe (``held_step``):
       every ``ivf_decode``, ``union_scores``, ``fmbe_z`` and (gated)
       ``topk_z`` call of the step made again and held to its plain
       version (these launches are not counted).

    Returns the path's launches by kernel, the gated ``topk_z``'s, and the
    held calls' max abs err by kernel record name."""
    import numpy as np

    from repro_torch.configs import ServingConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.serve import (CorruptIndexFault, Engine,
                                   NanLogitsFault, Request, Scheduler,
                                   Server, StepFault, generate,
                                   poisson_arrivals, trace_arrivals)

    dev = torch.device("cuda")
    t_phase = time.time()
    counted = PathCounts(torch, kernels)

    t0 = time.time()
    eng = Engine(Model(cfg), params, T_MAX_LEN, seed=7, device_index=True,
                 health_guard=True, device=dev)
    sched = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3)
    torch.cuda.synchronize()
    kv_gb = sum(t.numel() * t.element_size()
                for t in sched.table.cache.values()) / 1e9
    log(f"traffic: engine and a {T_SLOTS}-lane table ({kv_gb:.3f} GB of KV, "
        f"max_len {T_MAX_LEN}) built in {time.time() - t0:.2f} s [{card}]")
    vocab = cfg.vocab
    gen = torch.Generator(device=dev).manual_seed(21)

    def prompt(n):
        return torch.randint(0, vocab, (n,), generator=gen,
                             device=dev).cpu().numpy()

    def serve(reqs, at=None, server_cfg=None, s=None, rate=None):
        s = sched if s is None else s
        server = Server(s, server_cfg)
        arrivals = (poisson_arrivals(reqs, rate, seed=0) if rate
                    else trace_arrivals(reqs, at or [0] * len(reqs)))
        torch.cuda.synchronize()
        t0 = time.time()
        rep = server.run(arrivals=arrivals)
        torch.cuda.synchronize()
        by_id = {c.request.req_id: c for c in rep.completions}
        return rep, [by_id.get(r.req_id) for r in reqs], time.time() - t0

    def copy(reqs):
        return [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        seed=r.seed, temperature=r.temperature)
                for r in reqs]

    # -- 1. parity ---------------------------------------------------------
    par = [Request(prompt=prompt(p), max_new_tokens=n, seed=100 + i,
                   temperature=t)
           for i, (p, n, t) in enumerate(T_PARITY)]
    (rep, got, secs), counts, _ = counted(
        lambda: serve(par, list(T_PARITY_AT)))
    check(all(c is not None and c.error is None and
              len(c.tokens) == r.max_new_tokens for r, c in zip(par, got)),
          "traffic parity: a request did not complete")
    check(sched.captures == 1, f"traffic parity: {sched.captures} captures")
    check(counts["ivf_decode"] == rep.steps, f"traffic parity: ivf_decode "
          f"launched {counts['ivf_decode']} times in {rep.steps} steps")
    alone = []
    for r in copy(par):
        _, (c,), _ = serve([r])
        alone.append(c.tokens)
    check(alone == [c.tokens for c in got], "traffic parity: a request's "
          "tokens in the busy table differ from its tokens alone in it")
    solo = []
    for r in par:
        out = generate(eng, torch.as_tensor(r.prompt[None], device=dev),
                       r.max_new_tokens, temperature=r.temperature,
                       generator=torch.Generator(device=dev).manual_seed(
                           r.seed))
        solo.append(out[0].tolist())
    same = [a == c.tokens for a, c in zip(solo, got)]
    if all(same):
        log(f"traffic parity: {len(par)} requests (prompts "
            f"{[p for p, _, _ in T_PARITY]}, staggered), tokens equal to "
            f"each alone in the table and to its solo captured generate "
            f"(batch 1), {rep.steps} steps, {secs:.2f} s [{card}]")
    else:
        batch1_vs_16(torch, eng, params, par, got, solo, same, card, serve)
    # -- 2. traffic --------------------------------------------------------
    lengths = (16, 32, 64, 128)
    reqs = [Request(prompt=prompt(lengths[i % 4]), max_new_tokens=T_NEW,
                    seed=1000 + i, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(T_REQUESTS)]
    sched.shadow_every = 8
    sched.reset_metrics()
    caps = sched.captures
    (rep, got, secs), counts, n_gated = counted(
        lambda: serve(reqs, rate=T_RATE))
    check(all(c is not None and c.error is None and len(c.tokens) == T_NEW
              for c in got), "traffic: a request did not complete")
    check(sched.captures == caps, f"traffic: {sched.captures - caps} "
          f"captures after the warm-up run")
    check(counts["ivf_decode"] == rep.steps, f"traffic: ivf_decode "
          f"launched {counts['ivf_decode']} times in {rep.steps} steps")
    check(n_gated == 2 * rep.steps, f"traffic: the gated topk_z launched "
          f"{n_gated} times in {rep.steps} steps, want 2 a step")
    m = sched.harvest_metrics()
    ttft = [(c.first_token_time - c.admit_time) * 1e3 for c in got]
    step_ms = graph_step_ms(torch, sched, params, card)
    n_tok = sum(len(c.tokens) for c in got)
    log(f"traffic: {T_REQUESTS} requests (prompts 16/32/64/128, {T_NEW} new "
        f"tokens, half at T 0.8), Poisson {T_RATE}/step: {rep.summary()}; "
        f"{n_tok} tokens in {secs:.2f} s wall ({n_tok / secs:.1f} tokens/s "
        f"with set-up); first token after admission p50 "
        f"{statistics.median(ttft):.2f} ms, max {max(ttft):.2f} ms, queue "
        f"wait {rep.queue_wait_steps_mean:.2f} steps; a step's graph replay "
        f"{step_ms:.3f} ms device; shadow mimps rel err "
        f"{m['shadow_by_tier'].get('mimps')}; {counts['ivf_decode']} "
        f"ivf_decode and {n_gated} gated topk_z launches; captures "
        f"{sched.captures_by_tier} [{card}]")
    torch.cuda.synchronize()
    t0 = time.time()
    seq_tok = seq_steps = 0
    for r in reqs:
        out = generate(eng, torch.as_tensor(r.prompt[None], device=dev),
                       r.max_new_tokens, temperature=r.temperature,
                       generator=torch.Generator(device=dev).manual_seed(
                           r.seed))
        seq_tok += out.shape[1]
        seq_steps += len(r.prompt) + r.max_new_tokens - 1
    torch.cuda.synchronize()
    seq_s = time.time() - t0
    log(f"traffic, sequential captured generate over the same requests: "
        f"{seq_tok} tokens in {seq_s:.2f} s ({seq_tok / seq_s:.1f} tokens/s, "
        f"{seq_s / seq_steps * 1e3:.3f} ms a step over {seq_steps} steps); "
        f"the scheduler {rep.goodput_tok_s / (seq_tok / seq_s):.2f}x its "
        f"goodput [{card}]")
    # -- 3. overload -------------------------------------------------------
    over = [Request(prompt=prompt(lengths[i % 4]), max_new_tokens=T_NEW,
                    seed=3000 + i, temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(T_OVERLOAD)]
    ocfg = ServingConfig(max_queue=16, degrade_high=8, degrade_low=2,
                         default_deadline=400)
    (rep, got, secs), counts, _ = counted(
        lambda: serve(over, server_cfg=ocfg, rate=2 * T_RATE))
    tiers = [t for _, t in rep.tier_transitions]
    check(tiers[:1] == ["topk"] and tiers[-1:] == ["mimps"],
          f"overload: the ladder walked {rep.tier_transitions}")
    check(len(rep.completions) == T_OVERLOAD and all(c is not None
                                                     for c in got),
          f"overload: {len(rep.completions)} completions for {T_OVERLOAD} "
          f"submissions")
    check(all(c.reason for c in got if c.error is not None),
          "overload: a shed without its reason")
    check(sched.captures_by_tier == {"mimps": 1, "topk": 1},
          f"overload: captures {sched.captures_by_tier}")
    check(counts["union_scores"] > 0, "overload: the topk rung never "
          "launched union_scores")
    log(f"overload: {T_OVERLOAD} requests at {2 * T_RATE}/step, queue 16, "
        f"ladder 8/2: {rep.summary()}; tier path {rep.tier_transitions}; "
        f"tokens by tier {rep.tokens_by_tier}; launches ivf_decode "
        f"{counts['ivf_decode']}, union_scores {counts['union_scores']}; "
        f"captures {sched.captures_by_tier}; {secs:.2f} s [{card}]")
    # -- 4. faults ---------------------------------------------------------
    base_reqs = [Request(prompt=prompt(16 + 8 * i), max_new_tokens=12,
                         seed=5000 + i, temperature=0.0 if i % 2 else 0.7)
                 for i in range(6)]
    (_, base, _), _, _ = counted(lambda: serve(copy(base_reqs)))
    base = [c.tokens for c in base]
    caps = sched.captures
    victim = copy(base_reqs)
    sched.injector = NanLogitsFault([victim[2].req_id], steps=range(
        sched.steps_done + 1, sched.steps_done + 40))
    (rep, got, _), _, _ = counted(lambda: serve(victim))
    check(all(c.tokens == b for i, (c, b) in enumerate(zip(got, base))
              if i != 2), "faults: a NaN lane changed a neighbour's tokens")
    check(len(got[2].tokens) == 12 and rep.health["flagged"] > 0,
          f"faults: the NaN lane: {len(got[2].tokens)} tokens, health "
          f"{rep.health}")
    check(all(np.isfinite(c.log_zs).all() for c in got),
          "faults: a non-finite log Z was emitted")
    nan_health = rep.health
    sched.injector = StepFault([sched.steps_done + 2, sched.steps_done + 5])
    (rep, got, _), _, _ = counted(lambda: serve(copy(base_reqs)))
    check(rep.step_faults == 2 and [c.tokens for c in got] == base,
          f"faults: step faults {rep.step_faults}, tokens unchanged "
          f"{[c.tokens for c in got] == base}")
    at = (sched.steps_done // 4 + 2) * 4
    sched.injector = CorruptIndexFault(at_step=at, mode="permute", n_blocks=2)
    n_re = len(sched.recapture_log)
    (rep, got, _), counts, _ = counted(lambda: serve(
        copy(base_reqs), server_cfg=ServingConfig(verify_index_every=4)))
    sched.injector = None
    check(rep.index_restores == 1, f"faults: {rep.index_restores} restores")
    check([c.tokens for c in got] == base, "faults: tokens after the "
          "restore differ from the fault-free run's")
    check(len(sched.recapture_log) == n_re + 1 and
          sched.captures == caps + 1, f"faults: {sched.captures - caps} "
          f"captures for one restore")
    log(f"faults: NaN lane contained (neighbours bit-identical, health "
        f"{nan_health}); 2 step faults retried, tokens unchanged; permuted "
        f"index at step {at} restored by the digest every 4 steps, tokens "
        f"unchanged, one capture again in "
        f"{sched.recapture_log[-1][1] if sched.recapture_log else 0:.3f} "
        f"s (JAX recompiles nothing across a swap: its states are traced "
        f"arguments) [{card}]")
    # -- 5. prefix pool and speculation ------------------------------------
    shared = prompt(T_PREFIX)
    pre = [Request(prompt=np.concatenate([shared, prompt(1 + i % 4)]),
                   max_new_tokens=T_PREFIX_NEW, seed=7000 + i,
                   temperature=0.0 if i % 2 == 0 else 0.8)
           for i in range(T_PREFIX_REQ)]
    (rep, got, secs), _, _ = counted(lambda: serve(copy(pre)))
    want = [c.tokens for c in got]
    log(f"prefix/spec: plain, no pool: {rep.steps} steps, "
        f"{rep.goodput_tok_s:.1f} tokens/s, {secs:.2f} s [{card}]")
    for draft in (None, "topk", "fmbe"):
        kw = {} if draft is None else dict(spec_draft=draft,
                                           spec_k=T_SPEC_K)
        s = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3,
                      prefix_cache_blocks=128, prefix_block_tokens=16, **kw)
        for wave in ("cold", "warm"):
            (rep, got, secs), counts, _ = counted(
                lambda: serve(copy(pre), s=s))
            label = f"prefix/spec {draft or 'plain'} {wave}"
            check([c.tokens for c in got] == want, f"{label}: tokens differ "
                  f"from the plain run without a pool")
            if draft == "topk":
                check(counts["union_scores"] > 0, f"{label}: the draft "
                      f"never launched union_scores")
            if draft == "fmbe":
                check(counts["fmbe_z"] > 0, f"{label}: the draft never "
                      f"launched fmbe_z")
            check(counts["ivf_decode"] == rep.steps, f"{label}: ivf_decode "
                  f"{counts['ivf_decode']} in {rep.steps} steps")
            log(f"{label}: {rep.steps} steps, {rep.goodput_tok_s:.1f} "
                f"tokens/s, step device {rep.step_device_ms_mean:.3f} ms + "
                f"host {rep.step_host_ms_mean:.3f} ms, prefix {rep.prefix}, "
                f"acceptance {rep.spec_acceptance:.3f} "
                f"({rep.spec_accepted}/{rep.spec_proposed}), draft-flagged "
                f"{rep.draft_flagged}, {secs:.2f} s [{card}]")
        check(s.captures == 1, f"prefix/spec {draft}: {s.captures} captures")
        del s
        torch.cuda.empty_cache()
    # -- 6. the step's kernels at the table's shapes -----------------------
    held = {}
    before = _build.snapshot()
    for draft in (None, "topk", "fmbe"):
        kw = {} if draft is None else dict(spec_draft=draft, spec_k=T_SPEC_K)
        s = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3,
                      eager=True, **kw)
        busy = copy(reqs[:T_HELD_LANES])
        for i, r in enumerate(busy):
            s.admit(r)
            if i == T_HELD_LANES // 2 - 1:
                for _ in range(T_HELD_WARM):
                    s.step()
        for _ in range(T_HELD_WARM):
            s.step()
        tiers = ("mimps", "topk") if draft is None else ("mimps",)
        for tier in tiers:
            s.set_tier(tier)
            label = f"held {tier} step" if draft is None else \
                f"held {draft}-drafted verify"
            for name, err in held_step(torch, s, busy[1], label,
                                       card).items():
                held[name] = max(held.get(name, 0.0), err)
        s.drain()
        del s
        torch.cuda.empty_cache()
    _build.restore(before)
    for name in ("ivf_decode", "topk_z[gated]", "union_scores", "fmbe_z"):
        check(name in held, f"traffic: no {name} call was held to its plain "
              f"version at the table's shapes")
    path, n_gated = counted.totals()
    log(f"traffic path launches {path}, gated topk_z {n_gated}; kernels "
        f"held to their plain versions at the table's shapes, max abs err "
        f"{held}; phase {time.time() - t_phase:.1f} s [{card}]")
    return path, n_gated, held


def live_cuda_tensors(torch, min_bytes):
    """(shape, dtype, bytes) of every CUDA tensor of at least ``min_bytes``
    that the garbage collector reaches (memory a graph's pool or C++ alone
    holds is not among them)."""
    import warnings
    out = []
    with warnings.catch_warnings():     # isinstance on deprecated aliases
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    n = obj.numel() * obj.element_size()
                    if n >= min_bytes:
                        out.append((tuple(obj.shape), obj.dtype, n))
            except ReferenceError:      # a dead weak proxy
                continue
    return out


# the record of ``topk_z`` at the traffic path's 16 lanes; its launches are
# those of the bf16 kernel's 16-query instance (Q > 8), gated or not
Q16 = "topk_z[q16]"


class PathCounts:
    """Launches of a phase's main-path runs by kernel: ``counted(fn)``
    runs ``fn`` with every count at 0 and returns (its result, the counts
    of that run, the gated ``topk_z`` launches of that run), adding them to
    the phase's totals. ``topk_z``'s count includes its gated launches;
    ``totals()`` gives them apart. The counts also hold ``Q16``: the
    launches of ``topk_z``'s 16-query instance among ``topk_z``'s."""

    def __init__(self, torch, kernels):
        self.torch = torch
        self.kernels = kernels
        self.path = {name: 0 for name in kernels}
        self.path[Q16] = 0
        self.gated = 0

    def __call__(self, fn):
        from repro_torch.kernels import _build
        self.torch.cuda.synchronize()
        _build.reset_counts(self.kernels.values())
        res = fn()
        self.torch.cuda.synchronize()
        counts = {name: kfn.launches for name, kfn in self.kernels.items()}
        counts[Q16] = self.kernels["topk_z"].by_variant.get("bf16 n16", 0)
        for name in counts:
            self.path[name] += counts[name]
        gated = self.kernels["topk_z"].gated
        self.gated += gated
        return res, counts, gated

    def totals(self):
        """(launches by kernel, the gated ``topk_z`` apart; gated)."""
        path = dict(self.path)
        path["topk_z"] -= self.gated
        return path, self.gated


# the kernel wrappers a scheduler step calls, by the module that calls them
STEP_KERNEL_SITES = (("repro_torch.core.decode", "ivf_decode"),
                     ("repro_torch.core.decode", "union_scores"),
                     ("repro_torch.core.decode", "topk_z"),
                     ("repro_torch.core.backends", "topk_z"),
                     ("repro_torch.core.feature_maps", "fmbe_z"),
                     ("repro_torch.serve.output_layer", "ivf_decode"),
                     ("repro_torch.serve.output_layer", "union_scores"),
                     ("repro_torch.serve.output_layer", "topk_z"))


def held_step(torch, sched, victim, label, card):
    """One step of the eager scheduler ``sched`` on its busy table, with
    the kernel wrappers the step calls recording their arguments; a NaN
    fault on ``victim``'s lane (the guard's gated ``topk_z`` scores it) and
    the shadow oracle on (its gated ``topk_z`` scores every live lane).
    Then each recorded call is made again through its wrapper and held to
    its plain version on the same inputs: the hidden states, the tier's
    state and the plan (the live lanes' probe union) of that step, at
    Q = n_slots rows, or n_slots x spec_k in a speculative verify. Returns
    the max abs err by kernel record name."""
    from repro_torch.serve import NanLogitsFault
    sched.injector = NanLogitsFault([victim.req_id], [sched.steps_done])
    sched.shadow_every = 1
    try:
        rec, calls = recorded_calls(sched.step)
    finally:
        sched.injector = None
        sched.shadow_every = 0
    torch.cuda.synchronize()
    check(rec["health_flagged"] >= 1, f"{label}: the NaN lane was not "
          f"flagged ({rec['health_flagged']})")
    errs, notes = hold_calls(torch, label, calls)
    log(f"{label}: {rec['n_active']} of {sched.n_slots} lanes live, tier "
        f"{rec['tier']}; each kernel call of the step made again and held "
        f"to its plain version: " + "; ".join(notes) + f" [{card}]")
    return errs


def recorded_calls(fn):
    """``fn()`` with the kernel wrappers of ``STEP_KERNEL_SITES`` recording
    their arguments: (its result, [(name, wrapper, args, kwargs)])."""
    import importlib
    calls, saved = [], []
    for mod_name, fn_name in STEP_KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name)
        saved.append((mod, fn_name, real))

        def record(*args, _real=real, _name=fn_name, **kwargs):
            calls.append((_name, _real, args, kwargs))
            return _real(*args, **kwargs)
        setattr(mod, fn_name, record)
    try:
        return fn(), calls
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)


def hold_calls(torch, label, calls):
    """Each recorded call made again and held to its plain version
    (``hold_call``): (max abs err by record name, a note a call)."""
    errs, notes = {}, []
    for name, real, args, kwargs in calls:
        key, err, note = hold_call(torch, f"{label} {name}", name, real,
                                   args, kwargs)
        errs[key] = max(errs.get(key, 0.0), err)
        notes.append(note)
    return errs, notes


def hold_call(torch, label, name, real, args, kwargs):
    """One recorded kernel call made again through its wrapper ``real``
    (with its keyword arguments: ``k``, ``rows``, the launch knobs) and
    held to its plain version (the kernel phases' tolerances): (record
    name, max abs err, a note for the log)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_phi_plain, fmbe_z_plain
    from repro_torch.kernels.ivf_score import (ivf_decode_plain,
                                              stream_geometry,
                                              union_scores_plain)
    from repro_torch.kernels.lsh_probe import lsh_probe_plain
    from repro_torch.kernels.topk_z import topk_z_plain

    def ring(geo):
        return (f"{geo['rows']} rows x {geo['stages']} stages of pitch "
                f"{geo['pitch']} B, {geo['smem']} B of shared memory")
    if name == "ivf_decode":
        k = kwargs["k"]
        hl, tl, iv, ii = real(*args, **kwargs)
        p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k + 1)
        err = max(compare_lse(f"{label} head_lse", hl, p_hl),
                  compare_lse(f"{label} tail_lse", tl, p_tl))
        err_v, n_ids = compare_topk(label, iv, ii, p_v, p_i)
        live, cap = int(args[3]), args[2].shape[0]
        geo = stream_geometry(
            "ivf_decode", args[0].shape[2], args[0].dtype, u=cap,
            l=args[6].shape[0],
            grid_x=kwargs.get("grid_x") or _build.stream_grid(args[0].device))
        return name, max(err, err_v), (
            f"ivf_decode Q {args[1].shape[0]} union {live} live of {cap} "
            f"slots, d {args[0].shape[2]}: ring {ring(geo)}, lse err "
            f"{err:.2e}, top-k err {err_v:.2e} ({n_ids} ids)")
    if name == "union_scores":
        live = int(args[3])
        us = real(*args, **kwargs)
        p_us = union_scores_plain(*args)
        err = (us[:, :live] - p_us[:, :live]).abs().max().item()
        check(err <= TOL, f"{label}: live slots differ by {err}")
        check(bool((us[:, live:] == 0).all()), f"{label}: pad slots not 0")
        geo = stream_geometry("union_scores", args[0].shape[2],
                              args[0].dtype)
        return name, err, (f"union_scores Q {us.shape[0]} union {live} live "
                           f"of {us.shape[1]} slots, d {args[0].shape[2]}: "
                           f"ring {ring(geo)}, err {err:.2e}")
    if name == "topk_z":
        h, w, k = args
        rows = kwargs.get("rows")
        lse, tv, ti = real(h, w, k, **kwargs)
        p_lse, p_v, p_i = topk_z_plain(h, w, k + 1, rows)
        err = compare_lse(f"{label} lse", lse, p_lse)
        err_v, n_ids = compare_topk(label, tv, ti, p_v, p_i)
        on = h.shape[0] if rows is None else int((rows != 0).sum())
        key = "topk_z" if rows is None else "topk_z[gated]"
        return key, max(err, err_v), (
            f"{key} Q {h.shape[0]} ({on} rows scored), lse err {err:.2e}, "
            f"top-k err {err_v:.2e} ({n_ids} ids)")
    if name == "lsh_probe":
        k = kwargs["k"]
        hl, tl, iv, ii, cnt = real(*args, **kwargs)
        p_hl, p_tl, p_v, p_i, p_cnt = lsh_probe_plain(*args, k=k + 1)
        err = max(compare_lse(f"{label} head_lse", hl, p_hl),
                  compare_lse(f"{label} tail_lse", tl, p_tl))
        err_v, n_ids = compare_topk(label, iv, ii, p_v, p_i)
        check(torch.equal(cnt, p_cnt), f"{label}: collision counts differ")
        return name, max(err, err_v), (
            f"lsh_probe Q {args[1].shape[0]} over {int(args[4])} live of "
            f"{args[3].shape[0]} candidate columns, lse err {err:.2e}, "
            f"top-k err {err_v:.2e} ({n_ids} ids)")
    omega, degree, coef, lam, x = args
    z = real(*args, **kwargs)
    terms = fmbe_phi_plain(omega, degree, coef, x) * lam
    err, ratio = compare_signed_sum(label, z, fmbe_z_plain(*args), terms)
    return name, err, (f"fmbe_z Q {x.shape[0]} lambda {tuple(lam.shape)}, "
                       f"err {err:.3e} = {ratio:.4f} of the tolerance")


def graph_step_ms(torch, sched, params, card, label="traffic"):
    """Device milliseconds of one replay of the scheduler's captured step
    of its current tier, every lane idle (the step does every lane's work
    whatever its state): CUDA events over 20 replays. Then one replay
    under ``torch.profiler`` (kernels, time by kernel) and one eager trunk
    call of every lane at positions spread over max_len (0-150 at the
    traffic phase's 16 lanes and max_len 160) by kind (``trunk_kinds``),
    beside the trunk's weight bytes over the memory rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = sched._graphs[sched.tier]
    ms = _median_events(torch, g.graph.replay, 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    sched.reset_metrics()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kern:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:50]
        k_ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (k_ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    s = sched.n_slots
    log(f"{label} step profile ({sched.tier}, {s} lanes, one replay): "
        f"{len(kern)} kernels, {sum(v for v, _ in by_name.values()):.3f} ms "
        f"of kernel time; top: " + "; ".join(f"{n} {v:.3f} ms x{c}"
                                             for n, (v, c) in top)
        + f" [{card}]")
    eng = sched.engine
    dev = sched.device
    cache = eng.model.init_decode_state(s, eng.max_len, dev)
    toks = torch.zeros((s,), dtype=torch.long, device=dev)
    pos = (torch.arange(s, device=dev) * (eng.max_len // s)).to(torch.int32)
    kinds, _ = trunk_kinds(torch, lambda: eng.model.decode_step(
        params, cache, toks, pos))
    del cache
    weight_bytes = trunk_bytes(params, eng.cfg)
    log(f"{label} trunk by kind (eager, {s} lanes, KV of {eng.max_len}): "
        f"{sum(v for v, _ in kinds.values()):.3f} ms in "
        f"{sum(n for _, n in kinds.values())} kernels; "
        + "; ".join(f"{k} {v:.3f} ms ({n})" for k, (v, n) in
                    sorted(kinds.items(), key=lambda kv: -kv[1][0]))
        + f"; weight read bound {weight_bytes / 1e9:.3f} GB, "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms [{card}]")
    return ms


def batch1_vs_16(torch, eng, params, par, got, solo, same, card, serve):
    """Where a request's batch-1 ``generate`` differs from its lane of the
    16-lane table: log each request's first differing token, then feed the
    first such request's tokens (its prompt, then the table's samples)
    through the trunk at batch 1 and at batch 16 (the request in every
    lane) and log the first position whose hidden states differ and by how
    much (one GEMM shape against another). Then hold every request to
    ``generate`` at batch 16 with the request in every lane: a sampled
    request takes row 0 of the (16, sample_k) noise that generate draws a
    step, drawn again from a second generator seeded alike and injected
    through ``Request.gumbel``; the six run staggered in the table again
    (``serve``, as in the parity run) and each must give row 0 of
    generate's tokens."""
    from repro_torch.serve import Request, generate
    from repro_torch.serve.engine import _draw_gumbel
    dev = torch.device("cuda")
    first = [next((i for i, (a, b) in enumerate(zip(s, c.tokens))
                   if a != b), None) for s, c in zip(solo, got)]
    i = same.index(False)
    seq = list(par[i].prompt) + got[i].tokens[:-1]
    c1 = eng.model.init_decode_state(1, T_MAX_LEN, dev)
    c16 = eng.model.init_decode_state(T_SLOTS, T_MAX_LEN, dev)
    where, diff = None, 0.0
    with torch.inference_mode():
        for pos, t in enumerate(seq):
            tok = torch.tensor([int(t)], device=dev)
            h1 = eng.model.decode_step(params, c1, tok, pos)
            h16 = eng.model.decode_step(params, c16, tok.expand(T_SLOTS),
                                        pos)
            diff = (h1.float() - h16[:1].float()).abs().max().item()
            if diff > 0:
                where = pos
                break
    del c1, c16
    log(f"traffic parity: batch-1 generate differs from the table for "
        f"{same.count(False)} of {len(same)} requests (first differing "
        f"token {first}; each equals itself alone in the table); request "
        f"{i}'s tokens through the trunk at batch 1 and batch 16: the "
        f"hidden states first differ at position {where} (of "
        f"{len(seq)}), by {diff:.3e} [{card}]")
    k = eng.cfg.partition.sample_k
    injected, want = [], []
    for r in par:
        total = len(r.prompt) + r.max_new_tokens - 1
        gumbel = None
        if r.temperature > 0:
            g2 = torch.Generator(device=dev).manual_seed(r.seed)
            gumbel = torch.stack([_draw_gumbel((T_SLOTS, k), g2, dev)[0]
                                  for _ in range(total)]).cpu().numpy()
        injected.append(Request(prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens,
                                temperature=r.temperature, gumbel=gumbel))
        out = generate(eng, torch.as_tensor(r.prompt[None], device=dev)
                       .expand(T_SLOTS, -1), r.max_new_tokens,
                       temperature=r.temperature,
                       generator=torch.Generator(device=dev).manual_seed(
                           r.seed))
        want.append(out[0].tolist())
    _, got16, _ = serve(injected, list(T_PARITY_AT))
    for r, c, w in zip(par, got16, want):
        check(c is not None and c.tokens == w, f"traffic parity: a request "
              f"at T {r.temperature} differs from generate at batch 16 "
              f"too (row 0's noise injected)")
    log(f"traffic parity: every request, greedy and sampled (row 0 of "
        f"generate's batch-16 noise injected), staggered in the table, "
        f"equals generate at batch 16 [{card}]")


# the MoE phase: full-width deepseek-moe-16b through the captured generate
# and the server with observability
M_ARCH = "deepseek-moe-16b"
M_SLOTS, M_PROMPT_CAP, M_NEW = 16, 64, 16
M_MAX_LEN = M_PROMPT_CAP + M_NEW
M_LENGTHS = (8, 16, 32, 64)       # prompts of the served requests, cycled
M_REQUESTS, M_RATE = 32, 0.5      # Poisson arrivals, numpy seed 0
M_HELD_LANES, M_HELD_WARM = 12, 3    # the held steps' busy table


def moe_last(torch, card, kernels):
    """Phase 10: full-width deepseek-moe-16b (28 layers, d 2048, 64 routed
    experts of 1408 and 2 shared, top-6, vocab 102400, bf16, random weights
    from seed 0; nothing cut) after every earlier phase's state is freed.
    A mimps engine (the config's partition: k 1000, l 1000, n_probe 16,
    blocks of 512, at fixed capacity) with the guard:

    1. Peak memory after the init and after the index build.
    2. The captured ``generate``, 8 lanes (prompt 16, 16 new, greedy) at
       mimps and at the exact tier, each bit-equal to the host loop
       (tokens, log_prob, log_z) and launching its kernels once a step
       (mimps ``ivf_decode``, exact ``topk_z``; the guard's gated
       ``topk_z``); ms a step, new tokens/s, the replay's device ms.
    3. ``ops.ivf_block_scores`` on a mimps plan of 16 decode hidden states
       (``ivf_score`` at d 2048), held to its plain version.
    4. The step's kernels at the table's shapes: an eager scheduler of 16
       lanes with 12 live, one mimps step and one exact step
       (``held_step``), every kernel call held to its plain version.
    5. The server: 32 requests (prompts 8-64, 16 new tokens, half at T
       0.8), Poisson at 0.5 a step, on 16 lanes, on two schedulers whose
       step a warm-up request captured: one with observability off, one
       with ``Observability`` (a trace, a snapshot, shadow every 4 steps,
       harvest every 8, ``metrics_port`` 0 and the exposition started on
       an ephemeral port), in turns off, on, on, off: each pair's tokens
       bit-identical, one capture each and none in the runs,
       ``ivf_decode`` once a step and the gated ``topk_z`` twice; the
       trace parses line by line, its request spans number the
       completions, the snapshot's tiers with tokens are the tiers of its
       device steps, its counters reconcile with the reports, the shadow
       rel err is finite, and one scrape of ``/metrics`` on 127.0.0.1
       holds ``repro_serving_tokens_total``. Then the captured step's
       device ms, its profile and the trunk by kind
       (``graph_step_ms``).

    Returns what ``traffic`` returns: the path's launches, the gated
    ``topk_z``'s, the held calls' max abs err by record name."""
    import tempfile
    import urllib.request

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import ivf_score_plain
    from repro_torch.kernels.ops import ivf_block_scores
    from repro_torch.models import Model
    from repro_torch.obs import ObsConfig, Observability
    from repro_torch.serve import (Engine, Request, Scheduler, Server,
                                   poisson_arrivals, trace_arrivals)

    dev = torch.device("cuda")
    t_phase = time.time()
    counted = PathCounts(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 1e9
    big = sorted(live_cuda_tensors(torch, 64 << 20), key=lambda t: -t[2])
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(M_ARCH)
    pc = cfg.partition
    # -- 1. model and engine ------------------------------------------------
    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == cfg.param_count() + cfg.d_model, f"moe: {n_params} "
          f"params, the config counts {cfg.param_count()} + final norm")
    peak_init = torch.cuda.max_memory_allocated() / 1e9
    m = cfg.moe
    log(f"moe: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} experts "
        f"{m.n_experts} (top {m.top_k}, {m.n_shared} shared, d_ff "
        f"{m.expert_d_ff}) vocab {cfg.vocab} {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.3f}"
        f" GB, init {init_s:.1f} s; {left:.3f} GB allocated before it (live "
        f"tensors of 64 MB or more that Python reaches: "
        f"{[(shape, str(dt), round(n / 1e9, 3)) for shape, dt, n in big]}), "
        f"peak {peak_init:.3f} GB after it [{card}]")
    t0 = time.time()
    eng = Engine(Model(cfg), params, M_MAX_LEN, seed=7, device_index=True,
                 health_guard=True, device=dev)
    torch.cuda.synchronize()
    index = eng.index
    log(f"moe index: {index.n_blocks} blocks of {index.block_rows} rows "
        f"(fixed capacity), build {time.time() - t0:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB after it "
        f"[{card}]")
    # -- 2. the captured generate -------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    steps = PROMPT + NEW - 1
    for tier, kernel in ((None, "ivf_decode"), ("exact", "topk_z")):
        label = f"moe generate {tier or 'mimps'}"
        run, cap_s = capture_runner(torch, eng, tier)
        box = {}

        def wrap(fn):
            res, box["counts"], box["gated"] = counted(fn)
            return res
        (toks, _, secs), (_, _, h_secs) = served_pair(
            torch, eng, prompt, NEW, label, tier=tier, wrap=wrap)
        counts, n_gated = box["counts"], box["gated"]
        ungated = counts[kernel] - (n_gated if kernel == "topk_z" else 0)
        check(ungated == steps and n_gated == steps, f"{label}: {ungated} "
              f"{kernel} and {n_gated} gated topk_z launches in {steps} "
              f"steps, want one of each a step")
        check(toks.shape == (N_REQ, NEW), f"{label}: tokens "
              f"{tuple(toks.shape)}")
        log(f"{label}: {N_REQ} requests, prompt {PROMPT}, {NEW} new, "
            f"greedy: captured {secs / steps * 1e3:.3f} ms/step "
            f"({N_REQ * NEW / secs:.1f} new tokens/s; capture {cap_s:.2f} "
            f"s, replay {replay_ms(torch, run, prompt):.3f} ms device), "
            f"host loop {h_secs / steps * 1e3:.3f} ms/step "
            f"({N_REQ * NEW / h_secs:.1f} tokens/s), bit-equal (tokens, "
            f"log_prob, log_z); launches {kernel} {ungated}, gated topk_z "
            f"{n_gated} [{card}]")
    # -- 3. ivf_score at the MoE index's shapes ------------------------------
    cache = eng.model.init_decode_state(M_SLOTS, M_MAX_LEN, dev)
    h = eng.model.decode_step(
        params, cache, torch.randint(0, cfg.vocab, (M_SLOTS,), generator=gen,
                                     device=dev), 0)
    del cache
    plan = make_plan(index, h, pc.n_probe, pc.l, generator=gen)
    args = (index.v_blocks, h, plan.block_ids)
    scores, counts, _ = counted(lambda: ivf_block_scores(*args))
    err_is = (scores - ivf_score_plain(*args)).abs().max().item()
    check(counts["ivf_score"] > 0 and err_is <= TOL, f"moe ivf_score: "
          f"{counts['ivf_score']} launches, err {err_is}")
    log(f"moe ivf_score: ops.ivf_block_scores, Q {M_SLOTS} x {pc.n_probe} "
        f"probes of {index.block_rows} x {cfg.d_model}, err {err_is:.2e} "
        f"[{card}]")
    # -- 4. the step's kernels at the table's shapes -------------------------
    rng = np.random.default_rng(0)

    def requests(n, base):
        return [Request(prompt=rng.integers(0, cfg.vocab,
                                            M_LENGTHS[i % 4]),
                        max_new_tokens=M_NEW, seed=base + i,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(n)]

    held = {"ivf_score": err_is}
    before = _build.snapshot()
    s = Scheduler(eng, M_SLOTS, prompt_cap=M_PROMPT_CAP, seed=3,
                  eager=True)
    busy = requests(M_HELD_LANES, 500)
    for i, r in enumerate(busy):
        s.admit(r)
        if i == M_HELD_LANES // 2 - 1:
            for _ in range(M_HELD_WARM):
                s.step()
    for _ in range(M_HELD_WARM):
        s.step()
    for tier in ("mimps", "exact"):
        s.set_tier(tier)
        for name, err in held_step(torch, s, busy[1], f"moe held {tier} "
                                   f"step", card).items():
            held[name] = max(held.get(name, 0.0), err)
    s.drain()
    del s
    _build.restore(before)
    for name in ("ivf_decode", "topk_z", "topk_z[gated]"):
        check(name in held, f"moe: no {name} call was held to its plain "
              f"version at the table's shapes")
    # -- 5. the server, observability off and on ----------------------------
    reqs = requests(M_REQUESTS, 1000)
    warm = Request(prompt=reqs[0].prompt, max_new_tokens=2)

    def scheduler():
        """A scheduler whose step one warm-up request has captured, its
        metric state zeroed: both start from the same generator state."""
        sched = Scheduler(eng, M_SLOTS, prompt_cap=M_PROMPT_CAP, seed=3)
        Server(sched).run(arrivals=trace_arrivals([warm], [0]))
        sched.reset_metrics()
        return sched

    def serve(sched, obs):
        batch = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                         seed=r.seed, temperature=r.temperature)
                 for r in reqs]
        caps = sched.captures
        t0 = time.time()
        (rep, counts, n_gated) = counted(lambda: Server(sched, obs=obs).run(
            arrivals=poisson_arrivals(batch, M_RATE, seed=0)))
        secs = time.time() - t0
        by_id = {c.request.req_id: c for c in rep.completions}
        got = [by_id.get(r.req_id) for r in batch]
        label = f"moe server (observability {'on' if obs else 'off'})"
        check(all(c is not None and c.error is None and
                  len(c.tokens) == M_NEW for c in got),
              f"{label}: a request did not complete")
        check(sched.captures == caps, f"{label}: {sched.captures - caps} "
              f"captures after the warm-up")
        check(counts["ivf_decode"] == rep.steps and
              n_gated == 2 * rep.steps, f"{label}: {counts['ivf_decode']} "
              f"ivf_decode and {n_gated} gated topk_z launches in "
              f"{rep.steps} steps, want 1 and 2 a step")
        return rep, [c.tokens for c in got], secs

    off_s, on_s = scheduler(), scheduler()
    runs = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as tmp:
        trace, snap = Path(tmp) / "trace.jsonl", Path(tmp) / "snapshot.json"
        obs = Observability(ObsConfig(
            trace_path=str(trace), snapshot_path=str(snap), shadow_every=4,
            harvest_every=8, metrics_port=0))
        port = obs.registry.serve(0)
        try:
            # in turns: off, on, on, off (each pair on equal generator
            # states, so its tokens must be equal)
            for which in ("off", "on", "on", "off"):
                runs[which].append(serve(off_s, None) if which == "off"
                                   else serve(on_s, obs))
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=10) as resp:
                scrape = resp.read().decode()
        finally:
            obs.close()
        events = []
        for i, line in enumerate(trace.read_text().splitlines()):
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SmokeError(f"moe trace line {i}: {e}") from e
        harvest = json.loads(snap.read_text())["harvest"]
    for i in (0, 1):
        check(runs["on"][i][1] == runs["off"][i][1], f"moe server: run "
              f"{i + 1} with observability on gave other tokens than off")
    check(on_s.captures == off_s.captures == 1, f"moe server: "
          f"{on_s.captures} captures with observability, {off_s.captures} "
          f"without")
    check(len(events) == obs.tracer.events_written, f"moe trace: "
          f"{len(events)} lines for {obs.tracer.events_written} events")
    on_reps = [rep for rep, _, _ in runs["on"]]
    spans = sorted(e["args"]["req_id"] for e in events
                   if e["ph"] == "X" and e["name"] == "request")
    check(spans == sorted(c.request.req_id for rep in on_reps
                          for c in rep.completions),
          f"moe trace: {len(spans)} request spans for "
          f"{sum(len(rep.completions) for rep in on_reps)} completions")
    step_tiers = {e["name"].split(":", 1)[1] for e in events
                  if e["ph"] == "X" and e["name"].startswith("device_step:")}
    tok_tiers = {t for t, v in harvest["tokens_by_tier"].items() if v}
    check(tok_tiers == step_tiers, f"moe snapshot tiers {tok_tiers}, trace "
          f"tiers {step_tiers}")
    n_tok = sum(len(t) for _, toks, _ in runs["on"] for t in toks)
    n_steps = sum(rep.steps for rep in on_reps)
    check(harvest["tokens_total"] == n_tok and harvest["steps"] == n_steps,
          f"moe snapshot: {harvest['tokens_total']} tokens in "
          f"{harvest['steps']} steps, the reports {n_tok} in {n_steps}")
    shadow = harvest["shadow_by_tier"].get("mimps", {})
    check(shadow.get("count", 0) > 0 and
          math.isfinite(shadow["rel_err_mean"]), f"moe shadow: {shadow}")
    series = [ln for ln in scrape.splitlines()
              if ln.startswith("repro_serving_tokens_total ")]
    check(len(series) == 1, "moe: /metrics holds no "
          "repro_serving_tokens_total series")

    def summary(which):
        return "; ".join(
            f"{rep.goodput_tok_s:.1f} tokens/s, step device "
            f"{rep.step_device_ms_mean:.3f} ms + host "
            f"{rep.step_host_ms_mean:.3f} ms, {secs:.2f} s wall"
            for rep, _, secs in runs[which])
    log(f"moe server: {M_REQUESTS} requests (prompts {M_LENGTHS}, {M_NEW} "
        f"new, half at T 0.8), Poisson {M_RATE}/step, {M_SLOTS} lanes, the "
        f"step captured by a warm-up request; in turns off, on, on, off: "
        f"{on_reps[0].summary()}; observability off: {summary('off')}; on: "
        f"{summary('on')}; tokens bit-identical, {on_s.captures} capture "
        f"each; trace {len(events)} events, {len(spans)} request spans, "
        f"tiers {sorted(step_tiers)}; snapshot {harvest['steps']} steps, "
        f"tokens {harvest['tokens_by_tier']}, shadow mimps rel err mean "
        f"{shadow['rel_err_mean']:.3e} max {shadow['rel_err_max']:.3e} over "
        f"{shadow['count']} lane-steps; scrape: {series[0]} [{card}]")
    sched = on_s
    step_ms = graph_step_ms(torch, sched, params, card, label="moe")
    log(f"moe step: the captured {M_SLOTS}-lane step replays in "
        f"{step_ms:.3f} ms device [{card}]")
    path, n_gated = counted.totals()
    log(f"moe path launches {path}, gated topk_z {n_gated}; held max abs "
        f"err {held}; phase {time.time() - t_phase:.1f} s [{card}]")
    return path, n_gated, held


# the families phase: gemma3, RWKV6 and Zamba2 at full width through the
# captured generate, the slot scheduler and the Server
F_ARCHS = ("gemma3-4b", "rwkv6-7b", "zamba2-7b")
# each family's parameters at full width (the JAX package's eval_shape)
F_PARAMS = {"gemma3-4b": 3_879_907_840, "rwkv6-7b": 7_534_284_800,
            "zamba2-7b": 6_750_840_528}
F_SLOTS, F_NEW = 16, 16
F_RING = 1024                     # gemma3's sliding window: its local rings
F_PROMPT = {"gemma3-4b": F_RING, "rwkv6-7b": PROMPT, "zamba2-7b": PROMPT}
F_PROMPT_CAP = {"gemma3-4b": F_RING, "rwkv6-7b": 64, "zamba2-7b": 64}
F_LENGTHS = (8, 16, 32, 64)       # prompts of the held and served requests
F_REQUESTS, F_RATE = 32, 0.5      # the Server: Poisson arrivals, seed 0
# the scheduler's parity trace: (prompt, new tokens, temperature) and the
# arrival step of each. gemma3: every request counts, the first wraps its
# local rings (1020 + 12 - 1 positions > 1024). RWKV6 and Zamba2: the six
# at step 0 enter fresh lanes; the seventh enters lane 6, dead for 5
# steps, and the eighth lane 0, reused after the first request (C11)
F_TRACE = {
    "gemma3-4b": (((1020, 12, 0.0), (40, 16, 0.0), (64, 8, 0.7),
                   (16, 16, 0.0), (100, 12, 0.9), (24, 6, 0.0)),
                  (0, 3, 7, 12, 20, 30)),
    "recurrent": (((8, 2, 0.0), (16, 16, 0.0), (32, 16, 0.8),
                   (64, 12, 0.0), (24, 16, 0.9), (48, 8, 0.0),
                   (20, 16, 0.0), (12, 16, 0.0)),
                  (0, 0, 0, 0, 0, 0, 5, 20)),
}
F_HELD_LANES, F_HELD_WARM = 12, 3    # the held steps' busy table


def trunk_bytes(params, cfg):
    """Bytes one decode step reads from the trunk's weights (everything
    but the embedding, the head and the final norm): the shared block of
    the hybrid plan once a group."""
    skip = ("embed", "lm_head", "final_norm")
    n = sum(t.numel() * t.element_size()
            for k, v in params.items() if k not in skip
            for t in (_leaves(v) if isinstance(v, dict) else [v]))
    if "shared_attn" in params:
        groups = cfg.n_layers // cfg.shared_attn_every
        n += (groups - 1) * sum(t.numel() * t.element_size()
                                for t in _leaves(params["shared_attn"]))
    return n


def families_last(torch, card, kernels):
    """Phase 11: gemma3-4b, rwkv6-7b and zamba2-7b in turn
    (``family``), each freed before the next. Returns what ``traffic``
    returns, summed over the three."""
    path, n_gated, held = {}, 0, {}
    for arch in F_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        p, g, h = family(torch, card, kernels, arch)
        for name, n in p.items():
            path[name] = path.get(name, 0) + n
        n_gated += g
        for name, err in h.items():
            held[name] = max(held.get(name, 0.0), err)
    return path, n_gated, held


def family(torch, card, kernels, arch):
    """One family at its published widths (bf16, random weights from seed
    0; nothing cut) behind an engine at the config's partition with the
    guard (gemma3 and rwkv6: mimps, k 1000, l 1000, n_probe 16, blocks of
    512 at fixed capacity; zamba2: exact):

    1. The parameter count against the JAX package's, peak memory after
       the init and after the index build, the trunk's weight bytes and
       their read time at the memory rate. rwkv6's two projections that
       write into the residual stream are scaled by 1/sqrt(2 L) after the
       init (C12: at the JAX init's scales its stream overflows).
    2. The captured ``generate``, 8 lanes, greedy, bit-equal to the host
       loop (tokens, log_prob, log_z), each kernel once a step (the
       partition's and the guard's gated ``topk_z``): gemma3 with a prompt
       of 1024 and 16 new tokens (every local ring wraps), the others
       prompt 16 and 16 new. ms a step, new tokens/s, the replay's device
       ms.
    3. With an index: ``ops.ivf_block_scores`` on a mimps plan of 16
       decode hidden states, held to its plain version.
    4. One eager step of a busy 16-lane table (12 live) at each tier
       (mimps and topk, or exact), every kernel call held to its plain
       version (``held_step``; the stream kernels' ring geometry logged).
    5. The slot scheduler, 16 lanes, on ``F_TRACE`` (staggered): the
       requests that count (gemma3: all; the others: the six that enter
       fresh lanes before the first step) each equal ``generate`` at batch
       16 with the request in every lane (a sampled one with row 0 of
       generate's noise injected); the late and the reused lane's tokens
       are logged beside their ``generate`` (C11: admission does not reset
       a recurrent state and dead lanes step). The same trace through
       ``Scheduler(eager=True)`` gives the captured table's tokens,
       log_prob and log Z bit for bit: the capture's warm-up put the
       recurrent leaves back.
    6. The ``Server`` with ``Observability`` (trace, snapshot, shadow
       every 4 steps, harvest every 8): 32 Poisson requests, all complete,
       one capture, the kernels once a step; the trace's request spans
       number the completions. Then the captured step's device ms, its
       profile and the trunk by kind (``graph_step_ms``).
    7. Speculation (spec_k 4) and the prefix pool each raise
       ``NotImplementedError``.

    Returns the path's launches, the gated ``topk_z``'s and the held
    calls' max abs err by record name."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import ivf_score_plain
    from repro_torch.kernels.ops import ivf_block_scores
    from repro_torch.models import Model, tree_leaves
    from repro_torch.obs import ObsConfig, Observability
    from repro_torch.serve import (Engine, Request, Scheduler, Server,
                                   generate, poisson_arrivals,
                                   trace_arrivals)
    from repro_torch.serve.engine import _draw_gumbel

    dev = torch.device("cuda")
    t_phase = time.time()
    counted = PathCounts(torch, kernels)
    cfg = get_config(arch)
    pc = cfg.partition
    exact = pc.method == "exact"
    kernel = "topk_z" if exact else "ivf_decode"
    tag = arch.split("-")[0]
    cap, p_len = F_PROMPT_CAP[arch], F_PROMPT[arch]
    max_len = cap + F_NEW
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated() / 1e9
    # -- 1. model and engine ------------------------------------------------
    t0 = time.time()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    if cfg.family == "ssm":
        # the JAX RWKV6 block has no norm before its mixes, and its channel
        # mix is quadratic in the stream: at the init's scales a 32-layer
        # stream overflows by layer 9 (C12). GPT-2's residual scaling keeps
        # it finite: the two projections that write into the stream at
        # 1/sqrt(2 L) of their scale (0.125, exact in bf16)
        for leaf in (params["blocks"]["mix"]["wo"],
                     params["blocks"]["cmix"]["wv"]):
            leaf.mul_((2 * cfg.n_layers) ** -0.5)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == F_PARAMS[arch], f"{tag}: {n_params} params, the JAX "
          f"package's eval_shape counts {F_PARAMS[arch]}")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    t_bytes = trunk_bytes(params, cfg)
    log(f"{tag}: {cfg.name} family {cfg.family} layers {cfg.n_layers} d "
        f"{cfg.d_model} vocab {cfg.vocab} {cfg.dtype}, {n_params / 1e9:.3f} "
        f"B params ({cfg.param_count() / 1e9:.3f} B by the config's "
        f"param_count), {n_bytes / 1e9:.3f} GB, init {init_s:.1f} s; "
        f"{left:.3f} GB allocated before it, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB after it; a step "
        f"reads {t_bytes / 1e9:.3f} GB of trunk weights, "
        f"{t_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the memory rate "
        f"[{card}]")
    t0 = time.time()
    eng = Engine(model, params, max_len, seed=7, device_index=not exact,
                 health_guard=True, device=dev)
    torch.cuda.synchronize()
    index = eng.index
    log(f"{tag} engine: {pc.method}, "
        + ("no index" if index is None else
           f"{index.n_blocks} blocks of {index.block_rows} rows (fixed "
           f"capacity)")
        + f", built in {time.time() - t0:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB after it; "
        f"max_len {max_len} [{card}]")
    # -- 2. the captured generate -------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, p_len), generator=gen,
                           device=dev)
    steps = p_len + F_NEW - 1
    run, cap_s = capture_runner(torch, eng)
    box = {}

    def wrap(fn):
        res, box["counts"], box["gated"] = counted(fn)
        return res
    (toks, aux, secs), (_, _, h_secs) = served_pair(
        torch, eng, prompt, F_NEW, f"{tag} generate", wrap=wrap)
    check(all(bool(torch.isfinite(aux[k]).all()) for k in aux),
          f"{tag} generate: log_prob or log_z not finite")
    counts, n_g = box["counts"], box["gated"]
    ungated = counts[kernel] - (n_g if exact else 0)
    check(ungated == steps and n_g == steps, f"{tag} generate: {ungated} "
          f"{kernel} and {n_g} gated topk_z launches in {steps} steps, want "
          f"one of each a step")
    check(toks.shape == (N_REQ, F_NEW), f"{tag} generate: tokens "
          f"{tuple(toks.shape)}")
    log(f"{tag} generate: {N_REQ} requests, prompt {p_len}, {F_NEW} new, "
        f"greedy: captured {secs / steps * 1e3:.3f} ms/step "
        f"({N_REQ * F_NEW / secs:.1f} new tokens/s; capture {cap_s:.2f} s, "
        f"replay {replay_ms(torch, run, prompt):.3f} ms device), host loop "
        f"{h_secs / steps * 1e3:.3f} ms/step ({N_REQ * F_NEW / h_secs:.1f} "
        f"tokens/s), bit-equal (tokens, log_prob, log_z)"
        + (f"; every local ring of {F_RING} slots wrapped at position "
           f"{F_RING}" if arch == "gemma3-4b" else "")
        + f"; launches {kernel} {ungated}, gated topk_z {n_g} [{card}]")
    del run
    eng._graph_runners = {}
    # -- 3. ivf_score at the index's shapes ---------------------------------
    held = {}
    if index is not None:
        state = model.init_decode_state(F_SLOTS, 8, dev)
        h = model.decode_step(params, state, torch.randint(
            0, cfg.vocab, (F_SLOTS,), generator=gen, device=dev), 0)
        del state
        plan = make_plan(index, h, pc.n_probe, pc.l, generator=gen)
        args = (index.v_blocks, h, plan.block_ids)
        scores, c, _ = counted(lambda: ivf_block_scores(*args))
        err = (scores - ivf_score_plain(*args)).abs().max().item()
        check(c["ivf_score"] > 0 and err <= TOL, f"{tag} ivf_score: "
              f"{c['ivf_score']} launches, err {err}")
        held["ivf_score"] = err
        log(f"{tag} ivf_score: ops.ivf_block_scores, Q {F_SLOTS} x "
            f"{pc.n_probe} probes of {index.block_rows} x {cfg.d_model}, "
            f"err {err:.2e} [{card}]")
    # -- 4. the step's kernels at the table's shapes -------------------------
    rng = np.random.default_rng(0)

    def requests(n, base):
        return [Request(prompt=rng.integers(0, cfg.vocab, F_LENGTHS[i % 4]),
                        max_new_tokens=F_NEW, seed=base + i,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(n)]

    before = _build.snapshot()
    s = Scheduler(eng, F_SLOTS, prompt_cap=cap, seed=3, eager=True)
    busy = requests(F_HELD_LANES, 500)
    for i, r in enumerate(busy):
        s.admit(r)
        if i == F_HELD_LANES // 2 - 1:
            for _ in range(F_HELD_WARM):
                s.step()
    for _ in range(F_HELD_WARM):
        s.step()
    for tier in (("exact",) if exact else ("mimps", "topk")):
        s.set_tier(tier)
        for name, err in held_step(torch, s, busy[1], f"{tag} held {tier} "
                                   f"step", card).items():
            held[name] = max(held.get(name, 0.0), err)
    s.drain()
    del s
    _build.restore(before)
    for name in ((("topk_z", "topk_z[gated]") if exact else
                  ("ivf_decode", "union_scores", "topk_z[gated]"))):
        check(name in held, f"{tag}: no {name} call was held to its plain "
              f"version at the table's shapes")
    # -- 5. the slot scheduler against generate, captured against eager ----
    spec, at = F_TRACE["gemma3-4b" if arch == "gemma3-4b" else "recurrent"]
    prompts = [rng.integers(0, cfg.vocab, n) for n, _, _ in spec]
    k = pc.sample_k
    want, noise = [], []
    for i, (pr, (_, n, t)) in enumerate(zip(prompts, spec)):
        # generate at batch 16, the request in every lane; a sampled
        # request takes row 0 of the (16, k) noise generate draws a step
        out = generate(eng, torch.as_tensor(pr[None], device=dev)
                       .expand(F_SLOTS, -1), n, temperature=t,
                       generator=torch.Generator(device=dev).manual_seed(
                           40 + i))
        want.append(out[0].tolist())
        g2 = torch.Generator(device=dev).manual_seed(40 + i)
        noise.append(torch.stack([
            _draw_gumbel((F_SLOTS, k), g2, dev)[0]
            for _ in range(len(pr) + n - 1)]).cpu().numpy() if t > 0
            else None)

    def trace_reqs():
        return [Request(prompt=pr, max_new_tokens=n, temperature=t,
                        gumbel=g)
                for pr, (_, n, t), g in zip(prompts, spec, noise)]

    def serve(sched, reqs):
        t0 = time.time()
        rep = Server(sched).run(arrivals=trace_arrivals(reqs, list(at)))
        torch.cuda.synchronize()
        by_id = {c.request.req_id: c for c in rep.completions}
        got = [by_id.get(r.req_id) for r in reqs]
        check(all(c is not None and c.error is None and
                  len(c.tokens) == r.max_new_tokens
                  for r, c in zip(reqs, got)),
              f"{tag} scheduler: a request did not complete")
        return rep, got, time.time() - t0

    reqs = trace_reqs()
    sched = Scheduler(eng, F_SLOTS, prompt_cap=cap, seed=3)
    (rep, got, secs), c, n_g = counted(lambda: serve(sched, reqs))
    ungated = c[kernel] - (n_g if exact else 0)
    check(sched.captures == 1 and ungated == rep.steps and
          n_g == 2 * rep.steps, f"{tag} scheduler: {sched.captures} "
          f"captures, {ungated} {kernel} and {n_g} gated topk_z launches in "
          f"{rep.steps} steps, want one capture, 1 and 2 a step")
    del sched
    esched = Scheduler(eng, F_SLOTS, prompt_cap=cap, seed=3, eager=True)
    _, egot, e_secs = serve(esched, trace_reqs())
    del esched
    for a, b in zip(got, egot):
        check(a.tokens == b.tokens and a.log_probs == b.log_probs and
              a.log_zs == b.log_zs, f"{tag} scheduler: the captured step "
              f"differs from the eager step")
    fresh = len(spec) if arch == "gemma3-4b" else 6
    same = [c_.tokens == w for c_, w in zip(got, want)]
    check(all(same[:fresh]), f"{tag} scheduler: requests "
          f"{[i for i in range(fresh) if not same[i]]} differ from "
          f"generate at batch 16")
    lanes = {6: "lane 6, dead through 5 steps", 7: "lane 0, reused"}
    c11 = "; ".join(
        f"request {i} ({lanes[i]}): "
        f"{sum(a == b for a, b in zip(got[i].tokens, want[i]))} of "
        f"{len(want[i])} tokens as generate's, first "
        f"{got[i].tokens[:4]} vs {want[i][:4]}"
        for i in range(fresh, len(spec)))
    log(f"{tag} scheduler: {len(spec)} requests on {F_SLOTS} lanes at steps "
        f"{list(at)} (prompts {[n for n, _, _ in spec]}), {rep.steps} "
        f"steps, {secs:.2f} s captured, {e_secs:.2f} s eager; captured = "
        f"eager bit for bit (tokens, log_prob, log Z); {fresh} requests in "
        f"fresh lanes each equal generate at batch 16"
        + (f"; C11 (logged, not held): {c11}" if c11 else
           f"; the first wraps its {F_RING}-slot local rings")
        + f" [{card}]")
    # -- 6. the Server with observability ------------------------------------
    sreqs = requests(F_REQUESTS, 1000)
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.jsonl"
        obs = Observability(ObsConfig(
            trace_path=str(trace), snapshot_path=str(Path(tmp) / "s.json"),
            shadow_every=4, harvest_every=8))
        sched = Scheduler(eng, F_SLOTS, prompt_cap=cap, seed=3)
        try:
            t0 = time.time()
            rep, c, n_g = counted(lambda: Server(sched, obs=obs).run(
                arrivals=poisson_arrivals(sreqs, F_RATE, seed=0)))
            torch.cuda.synchronize()
            srv_s = time.time() - t0
        finally:
            obs.close()
        spans = [json.loads(line) for line in trace.read_text().splitlines()]
    done = [x for x in rep.completions if x.error is None and
            len(x.tokens) == F_NEW]
    n_spans = sum(e["ph"] == "X" and e["name"] == "request" for e in spans)
    ungated = c[kernel] - (n_g if exact else 0)
    check(len(done) == F_REQUESTS and n_spans == F_REQUESTS,
          f"{tag} server: {len(done)} of {F_REQUESTS} complete, "
          f"{n_spans} request spans")
    check(sched.captures_by_tier == {pc.method: 1}, f"{tag} server: "
          f"captures {sched.captures_by_tier}")
    check(ungated == rep.steps and n_g == 2 * rep.steps, f"{tag} server: "
          f"{ungated} {kernel} and {n_g} gated topk_z in {rep.steps} steps")
    log(f"{tag} server: {F_REQUESTS} requests (prompts {F_LENGTHS}, {F_NEW} "
        f"new, half at T 0.8), Poisson {F_RATE}/step, {F_SLOTS} lanes, "
        f"observability on: {rep.summary()}; {srv_s:.2f} s wall, one "
        f"capture, {len(spans)} trace events [{card}]")
    step_ms = graph_step_ms(torch, sched, params, card, label=tag)
    log(f"{tag} step: the captured {F_SLOTS}-lane step replays in "
        f"{step_ms:.3f} ms device, the trunk's weight read "
        f"{t_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms [{card}]")
    # -- 7. refusals ----------------------------------------------------------
    for kw in (dict(spec_draft="topk", spec_k=4),
               dict(prefix_cache_blocks=8)):
        try:
            Scheduler(eng, F_SLOTS, prompt_cap=cap, **kw)
        except NotImplementedError:
            continue
        raise SmokeError(f"{tag}: a scheduler with {kw} was not refused")
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(sched.table.cache)) / 1e9
    del sched, eng, params, model
    path, n_gated = counted.totals()
    log(f"{tag} path launches {path}, gated topk_z {n_gated}; held max abs "
        f"err {held}; the {F_SLOTS}-lane decode state {state_gb:.3f} GB; "
        f"speculation and the prefix pool refused; phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    return path, n_gated, held


LAYER_METHODS = ("exact", "mimps", "nmimps", "uniform", "mince", "fmbe",
                 "selfnorm")
# the kernels each method's PartitionLayer path must launch (the build's
# included): log_z, then top_candidates (topk_z, or ivf_score with an index)
LAYER_KERNELS = {"exact": ("topk_z",), "mimps": ("ivf_score",),
                 "fmbe": ("fmbe_phi", "fmbe_z", "topk_z")}
LAYER_K = 8                    # top_candidates' k
STUDY_KERNELS = ("topk_z", "fmbe_phi", "fmbe_z")
T4_KERNELS = ("topk_z", "ivf_score")
# the padded and unpadded plain Table 4 paths sum the same f32 products
# (zeros added): log Z equal to a few f32 ulps of |log Z| < 20
T4_PAD_TOL = 1e-5


def estimators(torch, card, kernels, params, cfg, h):
    """Phase 5c: the paper's estimators on the serving phase's bf16
    parameters. ``PartitionLayer`` at full width (qwen1.5-4b's lm_head, the
    serving phase's 8 hidden states) for each method of LAYER_METHODS, with
    the kernels against ``use_kernel=False`` on the same injected draws:
    log Ẑ within 1e-3, ``top_candidates`` (k 8) with ids equal wherever the
    neighbouring scores are more than 1e-3 apart, two calls bit-equal,
    mimps within 0.05 of exact; MINCE also with the paper's weighting (the
    oracle path, no kernel). Each method's build and first ``log_z`` +
    ``top_candidates`` run from launch counts of 0: each kernel of
    LAYER_KERNELS must launch. Logs build seconds and log_z ms (wall, a
    synchronise, 8 queries) of both paths. Then the four studies of
    ``repro_torch.studies.paper_tables`` at the JAX scripts' sizes (f32
    data: ``topk_z``, ``fmbe_phi`` and ``fmbe_z`` must launch, at f32
    only), their tables printed, every ordering of ``ORDERINGS`` required.
    Returns the layer path's and the studies' launches by kernel."""
    from repro_torch.core import estimators as est
    from repro_torch.core.feature_maps import apply_feature_map, fmbe_z_batch
    from repro_torch.core.partition_layer import PartitionLayer
    from repro_torch.kernels import _build
    from repro_torch.studies import paper_tables as pt
    from repro_torch.studies import table4_lbl as t4lbl

    t_phase = time.time()
    dev = h.device
    pc = cfg.partition
    w = params["lm_head"]
    v_rows, q = w.shape[0], h.shape[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = torch.randint(0, v_rows, (q, pc.l), generator=gen, device=dev)
    ranks = torch.randint(0, v_rows - pc.k, (q, pc.l), generator=gen,
                          device=dev)
    draws = {"mimps": rows, "uniform": rows, "mince": ranks}
    path = {name: 0 for name in kernels}

    def reset():
        torch.cuda.synchronize()
        _build.reset_counts(kernels.values())

    def read():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in kernels.items()}

    lz = {}
    for method in LAYER_METHODS:
        lcfg = dataclasses.replace(pc, method=method)
        reset()
        t0 = time.time()
        layer = PartitionLayer.build(
            lcfg, w, torch.Generator(device=dev).manual_seed(7), device=dev)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        built = read()
        reset()
        got = layer.log_z(w, h, draws=draws.get(method))
        tv, ti = layer.top_candidates(w, h, LAYER_K)
        counts = read()
        for name in kernels:
            path[name] += built[name] + counts[name]
        for name in LAYER_KERNELS.get(method, ("topk_z",)):
            check(built[name] + counts[name] > 0, f"estimators {method}: "
                  f"the PartitionLayer path launched no {name}")
        plain = layer.log_z(w, h, draws=draws.get(method), use_kernel=False)
        check(got.shape == (q,) and bool(torch.isfinite(got).all()),
              f"estimators {method}: log_z {got}")
        err = (got - plain).abs().max().item()
        check(err <= TOL, f"estimators {method}: log_z with the kernels off "
              f"the plain path by {err}")
        check(torch.equal(got, layer.log_z(w, h, draws=draws.get(method))),
              f"estimators {method}: two log_z calls differ")
        pv, pi = layer.top_candidates(w, h, LAYER_K + 1, use_kernel=False)
        _, n_ids = compare_topk(f"estimators {method} top_candidates", tv, ti,
                                pv, pi)
        tv2, ti2 = layer.top_candidates(w, h, LAYER_K)
        check(torch.equal(tv, tv2) and torch.equal(ti, ti2),
              f"estimators {method}: two top_candidates calls differ")
        extra = ""
        if method == "fmbe":        # the signed sums beside their cancellation
            st = layer.fmbe_state
            terms = apply_feature_map(st.fm, h) * st.lambda_tilde
            zk = fmbe_z_batch(st, h, True)
            zp = fmbe_z_batch(st, h, False)
            _, ratio = compare_signed_sum("estimators fmbe z", zk, zp, terms)
            extra = (f"; signed z {[f'{x:.4e}' for x in zp.tolist()]}, sum "
                     f"|terms| {terms.abs().sum(-1).max().item():.4e}, z error "
                     f"{ratio:.3f} of its limit")
        ms = wall_ms(torch, lambda: layer.log_z(w, h, draws=draws.get(method)))
        plain_ms = wall_ms(torch, lambda: layer.log_z(
            w, h, draws=draws.get(method), use_kernel=False))
        lz[method] = got
        log(f"estimators {method}: build {build_s:.3f} s (index "
            f"{layer.index is not None}, fmbe sketch "
            f"{layer.fmbe_state is not None}); log_z for {q} queries "
            f"{ms:.3f} ms wall, plain {plain_ms:.3f} ms; |kernels - plain| "
            f"{err:.3e}; top_candidates k {LAYER_K}: {n_ids} ids checked; "
            f"launches build {({n: c for n, c in built.items() if c})} "
            f"log_z + top_candidates {({n: c for n, c in counts.items() if c})}"
            f"{extra} [{card}]")
        del layer
    gap = (lz["mimps"] - lz["exact"]).abs().max().item()
    check(gap < 0.05, f"estimators: mimps log_z off exact by {gap}")
    paper = est.mince_log_z(w, h, pc.k, pc.l, weighting="paper",
                            tail_pos=ranks)
    check(bool(torch.isfinite(paper).all()) and torch.equal(
        paper, est.mince_log_z(w, h, pc.k, pc.l, weighting="paper",
                               tail_pos=ranks)),
          "estimators: mince (paper weighting) not finite or not "
          "bit-equal over two calls")
    log("estimators: log Z - exact per method (max abs): "
        + ", ".join(f"{m} {(x - lz['exact']).abs().max().item():.4e}"
                    for m, x in lz.items())
        + f", mince paper weighting "
        f"{(paper - lz['exact']).abs().max().item():.4e} [{card}]")

    # -- the paper's tables at the JAX scripts' sizes --------------------------
    reset()
    t0 = time.time()
    res = pt.run(device=dev)
    study_s = time.time() - t0
    study = {name: dict(fn.by_variant) for name, fn in kernels.items()}
    for name in STUDY_KERNELS:
        check(study[name]["f32"] > 0 and study[name]["bf16"] == 0,
              f"studies: {name} launched {study[name]}, want f32 only")
    log(pt.format_tables(res))
    for name in ("fig1", "table1", "table2", "table3"):
        log(f"study {name}: {res[name]['seconds']:.3f} s wall [{card}]")
    orderings = pt.check_orderings(res)
    for name, ok in orderings.items():
        log(f"ordering {'holds' if ok else 'BROKEN'}: {name}")
    check(all(orderings.values()), f"studies: broken orderings "
          f"{[n for n, ok in orderings.items() if not ok]}")

    # -- the paper's Table 4 at the JAX script's full size ---------------------
    reset()
    t0 = time.time()
    t4 = t4lbl.run(device=dev)
    t4_s = time.time() - t0
    t4_counts = {name: dict(fn.by_variant) for name, fn in kernels.items()}
    for name in T4_KERNELS:
        check(t4_counts[name]["f32"] > 0 and t4_counts[name]["bf16"] == 0,
              f"table4: {name} launched {t4_counts[name]}, want f32 only")
    for name, c in t4_counts.items():
        study[name]["f32"] += c["f32"]
    log(t4lbl.format_table(t4))
    check(all(math.isfinite(r["abse_mips"]) for r in t4["rows"]),
          f"table4: {t4['rows']}")
    check(t4["kernel_max_abs_err"] <= TOL, f"table4: the kernels off "
          f"use_kernel=False by {t4['kernel_max_abs_err']}")
    check(t4["pad_max_abs_diff"] <= T4_PAD_TOL, f"table4: the padded plain "
          f"path off the unpadded one by {t4['pad_max_abs_diff']}")
    check(t4lbl.mimps_beats_z1(t4), "table4: MIMPS does not beat Z = 1 "
          "(the JAX package's own run shows it at every pair)")
    log(f"table4: V {t4['sizes']['vocab']} d {t4['sizes']['d']} + 1 padded "
        f"to {t4['sizes']['padded_d']}, {t4['sizes']['n_blocks']} blocks of "
        f"{t4['sizes']['block_rows']}, {t4['sizes']['steps']} NCE steps of "
        f"batch {t4['sizes']['batch']} in {t4['train_seconds']:.3f} s "
        f"({t4['train_us_per_step']:.1f} us/step), {t4['sizes']['n_test']} "
        f"held-out contexts; kernels (topk_z, ivf_score) vs plain max |d log "
        f"Z| {t4['kernel_max_abs_err']:.3e}; padded vs unpadded plain "
        f"{t4['pad_max_abs_diff']:.3e} (bit-equal {t4['pad_bit_equal']}); "
        f"MIMPS beats Z = 1 at every pair; launches "
        f"{ {n: c['f32'] for n, c in t4_counts.items() if c['f32']} }; "
        f"{t4_s:.1f} s [{card}]")
    log(f"estimators phase: {time.time() - t_phase:.1f} s (the four studies "
        f"{study_s:.1f} s, Table 4 {t4_s:.1f} s), study launches "
        f"{ {n: c['f32'] for n, c in study.items() if c['f32']} } [{card}]")
    return path, {name: c["f32"] for name, c in study.items()}


def lifecycle(torch, card, kernels, params, cfg, floor):
    """Phase 6: the fixed-capacity index lifecycle at full width (bf16),
    with its hard checks. A mimps engine with ``device_index=True`` and
    ``health_guard=True`` serves 8 requests (prompt 16, 16 new tokens): its
    tokens and log Z must equal the unguarded run's bit for bit. With NaN
    rows installed in its index every query of every step must be flagged
    and the tokens and log Z must be the exact engine's. ``swap_index`` to a
    new head (the old one plus seeded noise; trunk shared) must keep every
    state shape and serve a fresh ``device_index`` engine's tokens on the
    new params. Two live blocks swapped must be caught by
    ``verify_and_restore``, the restored tensors and the tokens after it
    equal to the clean ones bit for bit. ``shadow_exact_log_z`` must equal
    the exact tier's log Z bit for bit. Then topk, mince and fmbe serve
    through ``tier_state`` on the shared index. Every run goes through the
    captured ``generate`` and then the host loop (which records the guard's
    flags), bit-equal, each reseeding the engine's decode generator (the
    same tail draws); the runs after the swap and after the restore must
    each capture afresh. Each captured run of the path starts with the
    launch counts at 0. Times the build, swap, restore and
    digest, the gated ``topk_z`` with no query and with every query
    flagged, and a guarded against an unguarded output layer (CUDA graph
    replay, which also shows the guard makes no host read). Returns the
    gated ``topk_z`` record and the path's launches by kernel."""
    from repro_torch.core import mips
    from repro_torch.core.backends import shadow_exact_log_z
    from repro_torch.core.decode import apply_health_guard
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk_z import NEG, topk_z, topk_z_plain
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.serve import engine as engine_mod

    dev = torch.device("cuda")
    pc = cfg.partition
    k = pc.sample_k
    max_len = PROMPT + NEW
    seed = 5
    gen = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    w = params["lm_head"]
    path = {name: 0 for name in kernels}
    path_gated = [0]

    def counted(fn):
        """``fn()`` as a part of the path: its launches are the path's."""
        torch.cuda.synchronize()
        _build.reset_counts(kernels.values())
        res = fn()
        torch.cuda.synchronize()
        for name, kfn in kernels.items():
            path[name] += kfn.launches
        path_gated[0] += kernels["topk_z"].gated
        return res

    flags_log = []
    real_guard = engine_mod.apply_health_guard

    def recording_guard(*args, **kwargs):
        out, flags = real_guard(*args, **kwargs)
        flags_log.append(flags)
        return out, flags

    def serve_run(eng, label, *, on_path=True, tier=None):
        """``generate`` through the captured step (the path, when
        ``on_path``), then the host loop, bit-equal; the host loop records
        the guard's flags of every step."""
        captures = eng.captures
        (out, aux, secs), (_, _, host_secs) = served_pair(
            torch, eng, prompt, NEW, f"lifecycle {label}", tier=tier,
            seed=seed, wrap=counted if on_path else None,
            host_first=flags_log.clear)
        check(out.shape == (N_REQ, NEW), f"lifecycle {label}: tokens "
              f"{out.shape}")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"lifecycle {label}: log_z not finite")
        flagged = [int((f > 0).sum()) for f in flags_log]
        if eng.health_guard:
            check(len(flagged) == PROMPT + NEW - 1, f"lifecycle {label}: "
                  f"{len(flagged)} guarded steps recorded")
        log(f"lifecycle {label}: captured {N_REQ * NEW / secs:.1f} new "
            f"tokens/s, host loop {N_REQ * NEW / host_secs:.1f}, bit-equal, "
            f"{eng.captures - captures} captures, flagged queries per step "
            f"{flagged if any(flagged) else 0} [{card}]")
        return out, aux, flagged, eng.captures - captures

    engine_mod.apply_health_guard = recording_guard
    try:
        # -- the fixed-capacity build, alone and in the engine ----------------
        v, d = w.shape
        nb = mips.ivf_capacity_blocks(v, pc.block_rows, pc.n_clusters)
        torch.cuda.synchronize()
        t0 = time.time()
        alone = mips.build_ivf_device(
            w, block_rows=pc.block_rows, n_clusters=pc.n_clusters,
            generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        build_s = time.time() - t0
        live = int(alone.valid.any(-1).sum())
        del alone
        t0 = time.time()
        eng = Engine(Model(cfg), params, max_len, seed=seed,
                     device_index=True, health_guard=True)
        torch.cuda.synchronize()
        engine_s = time.time() - t0
        idx = eng.index
        check(idx.n_blocks == nb, f"capacity index has {idx.n_blocks} "
              f"blocks, want {nb}")
        check(int(idx.valid.any(-1).sum()) == live, "the engine's build "
              "differs from build_ivf_device's")
        log(f"lifecycle: build_ivf_device {nb} blocks ({live} live) of "
            f"{pc.block_rows} rows, {idx.v_blocks.numel() * 2 / 1e9:.3f} GB, "
            f"{build_s:.3f} s; engine build {engine_s:.3f} s; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")

        # -- guarded healthy run against the unguarded one ---------------------
        toks, aux, flagged, _ = serve_run(eng, "mimps guarded")
        check(not any(flagged), f"a healthy run flagged {flagged}")
        eng.health_guard = False
        u_toks, u_aux, _, _ = serve_run(eng, "mimps unguarded",
                                        on_path=False)
        eng.health_guard = True
        for name in ("log_z", "log_prob"):
            check(torch.equal(aux[name], u_aux[name]),
                  f"guarded {name} differs from the unguarded run's")
        check(torch.equal(toks, u_toks), "guarded tokens differ from the "
              "unguarded run's")

        # -- a poisoned index: every step flagged, the exact engine's tokens --
        clean = eng.state
        poisoned = idx._replace(v_blocks=torch.full_like(idx.v_blocks,
                                                         float("nan")))
        eng._install_state(dataclasses.replace(clean, index=poisoned))
        p_toks, p_aux, flagged, _ = serve_run(eng, "mimps poisoned index")
        check(len(flagged) == PROMPT + NEW - 1 and
              all(f == N_REQ for f in flagged),
              f"poisoned run flagged {flagged} queries per step, want every "
              f"query of every step")
        eng._install_state(clean)
        del poisoned
        exact = Engine(Model(dataclasses.replace(
            cfg, partition=dataclasses.replace(pc, method="exact"))),
            params, max_len, seed=seed)
        e_toks, e_aux, _, _ = serve_run(exact, "exact", on_path=False)
        check(torch.equal(p_toks, e_toks), "poisoned guarded tokens differ "
              "from the exact engine's")
        check(torch.equal(p_aux["log_z"], e_aux["log_z"]), "poisoned guarded "
              "log_z differs from the exact engine's")

        # -- the shadow oracle against the exact tier --------------------------
        cache = exact.model.init_decode_state(N_REQ, max_len, dev)
        h = exact.model.decode_step(params, cache, prompt[:, 0], 0)
        shadow = counted(lambda: shadow_exact_log_z(eng.state, h, k=k))
        ex_out = exact.backend.decode(exact.state, h, pc, k=k)
        check(torch.equal(shadow, ex_out.log_z), "shadow_exact_log_z differs "
              "from the exact tier's log_z")

        # -- output layer, guarded against unguarded (graph replay) -----------
        tail_idx = torch.randint(0, v, (pc.l,), generator=gen, device=dev)

        def unguarded_out():
            return eng.backend.decode(eng.state, h, pc, k=k,
                                      tail_idx=tail_idx)

        def guarded_out():
            return real_guard(unguarded_out(), eng.state.w, h, k)

        g_out, g_flags = guarded_out()
        check(not g_flags.any(), "the timed step is not healthy")
        for a, b in zip(g_out[:6], unguarded_out()[:6]):
            check(torch.equal(a, b), "guarded step differs from unguarded")
        ms_u, ms_g = time_ms(torch, unguarded_out), time_ms(torch,
                                                            guarded_out)
        log(f"lifecycle: mimps output layer device time, unguarded "
            f"{ms_u:.4f} ms, guarded {ms_g:.4f} ms (+{ms_g - ms_u:.4f}; "
            f"both captured in a CUDA graph) [{card}]")

        # -- swap to a new head ------------------------------------------------
        noise = torch.randn(w.shape, generator=gen, device=dev,
                            dtype=w.dtype)
        new_params = dict(params, lm_head=w + 0.005 * noise)
        del noise
        before = engine_mod._shapes(eng.state)
        torch.cuda.synchronize()
        t0 = time.time()
        eng.swap_index(new_params)
        torch.cuda.synchronize()
        swap_s = time.time() - t0
        check(engine_mod._shapes(eng.state) == before,
              "swap_index changed a state shape")
        s_toks, s_aux, _, s_caps = serve_run(eng, "mimps after swap")
        check(s_caps == 1, f"the run after swap_index captured {s_caps} "
              f"times, want once afresh")
        fresh = Engine(Model(cfg), new_params, max_len, seed=seed,
                       device_index=True, health_guard=True)
        for a, b in zip(fresh.index, eng.index):
            check(a == b if isinstance(a, int) else torch.equal(a, b),
                  "the swapped index differs from a fresh build's")
        f_toks, f_aux, _, _ = serve_run(fresh, "fresh engine on the new head",
                                     on_path=False)
        del fresh
        check(torch.equal(s_toks, f_toks), "swapped tokens differ from a "
              "fresh engine's")
        check(torch.equal(s_aux["log_z"], f_aux["log_z"]), "swapped log_z "
              "differs from a fresh engine's")
        changed = (s_toks != toks).float().mean().item()

        # -- a two-block permutation, verify and restore -----------------------
        idx = eng.index
        clean_t = [t.clone() for t in idx if isinstance(t, torch.Tensor)]
        live_ids = torch.nonzero(idx.valid.any(-1))[:, 0].tolist()
        a_blk, b_blk = live_ids[0], live_ids[1]
        vb = idx.v_blocks.clone()
        vb[[a_blk, b_blk]] = vb[[b_blk, a_blk]]
        eng._install_state(dataclasses.replace(
            eng.state, index=idx._replace(v_blocks=vb)))
        del vb, idx
        torch.cuda.synchronize()
        t0 = time.time()
        restored = eng.verify_and_restore()
        torch.cuda.synchronize()
        verify_s = time.time() - t0
        check(restored, "verify_and_restore missed a two-block permutation")
        for a, b in zip((t for t in eng.index
                         if isinstance(t, torch.Tensor)), clean_t):
            check(torch.equal(a, b), "the restored index differs from the "
                  "clean one")
        del clean_t
        r_toks, r_aux, _, r_caps = serve_run(eng, "mimps after restore")
        check(r_caps == 1, f"the run after the restore captured {r_caps} "
              f"times, want once afresh")
        check(torch.equal(r_toks, s_toks) and
              torch.equal(r_aux["log_z"], s_aux["log_z"]),
              "tokens after the restore differ from the fault-free run's")
        check(not eng.verify_and_restore(), "a clean index failed its digest")
        t0 = time.time()
        dig = engine_mod._digest(eng.index.v_blocks)
        digest_s = time.time() - t0
        check(engine_mod._digest(eng.index.v_blocks) == dig,
              "the digest differs between two calls")
        torch.cuda.synchronize()
        t0 = time.time()
        eng.restore_index()
        torch.cuda.synchronize()
        restore_s = time.time() - t0
        log(f"lifecycle: swap_index {swap_s:.3f} s ({changed:.4f} of the "
            f"greedy tokens changed), verify_and_restore on a two-block "
            f"permutation of blocks {a_blk} and {b_blk} {verify_s:.3f} s, "
            f"restore_index {restore_s:.3f} s, digest {digest_s * 1e3:.2f} "
            f"ms ({dig[0]!r}, {dig[1]!r}), {eng.index_restores} restores "
            f"[{card}]")

        # -- degradation tiers on the shared index -----------------------------
        for tier in ("topk", "mince", "fmbe"):
            t0 = time.time()
            st = counted(lambda: eng.tier_state(tier))
            tier_s = time.time() - t0
            check(st.index is eng.index, f"the {tier} tier does not share "
                  f"the engine's index")
            log(f"lifecycle: {tier} tier state {tier_s:.3f} s")
            serve_run(eng, f"tier {tier}", tier=tier)
    finally:
        engine_mod.apply_health_guard = real_guard

    for name in ("ivf_decode", "union_scores", "fmbe_phi", "fmbe_z",
                 "topk_z"):
        check(path[name] > 0, f"lifecycle: the path never launched {name}")
    check(path_gated[0] > 0, "lifecycle: the guard never launched the "
          "gated topk_z")
    path["topk_z"] -= path_gated[0]            # the gated ones: their record
    log(f"lifecycle path launches {path}, gated topk_z {path_gated[0]}")

    # -- the gated topk_z against the ungated kernel and the plain version ---
    i32 = dict(dtype=torch.int32, device=dev)
    none, every = torch.zeros(N_REQ, **i32), torch.ones(N_REQ, **i32)
    full = topk_z(h, w, k)
    on = topk_z(h, w, k, rows=every)
    off = topk_z(h, w, k, rows=none)
    torch.cuda.synchronize()
    for a, b in zip(on, full):
        check(torch.equal(a, b), "gated topk_z with every query flagged "
              "differs from the ungated kernel's bits")
    check(bool(torch.isneginf(off[0]).all() and (off[1] == NEG).all()
               and not off[2].any()), "gated topk_z with no query flagged "
          "did not write the filler")
    p_lse, p_v, p_i = topk_z_plain(h, w, k + 1)
    err = compare_lse("topk_z[gated] lse", on[0], p_lse)
    err_v, _ = compare_topk("topk_z[gated]", on[1], on[2], p_v, p_i)
    q = N_REQ
    out_bytes = q * 4 + q * 4 + q * k * 8       # rows read; lse, top-k out
    g_bound, g_by = bound_ms(out_bytes, 0)
    rec = dict(name="topk_z[gated]", route="cuda",
               source="src/repro_torch/kernels/csrc/topk_z.cu",
               replaces="src/repro/kernels/topk_z.py:82",
               launches=path_gated[0], max_abs_err=max(err, err_v),
               ms=time_ms(torch, lambda: topk_z(h, w, k, rows=none)),
               plain_ms=time_ms(torch, lambda: topk_z_plain(h, w, k, none)),
               bound_ms=g_bound, bound_by=g_by, library_ms=None,
               graph10_ms=graph10_ms(torch,
                                     lambda: topk_z(h, w, k, rows=none)),
               floor_ms=floor,
               all_flagged_ms=time_ms(torch,
                                      lambda: topk_z(h, w, k, rows=every)),
               ungated_ms=time_ms(torch, lambda: topk_z(h, w, k)))
    log(f"topk_z[gated]: Q {q} k {k}: no query flagged {rec['ms']:.4f} ms "
        f"(ten {rec['graph10_ms']:.4f}; graph floor {floor:.4f}, bound "
        f"{g_bound:.6f} ms for {out_bytes} B); every query flagged "
        f"{rec['all_flagged_ms']:.4f} ms against ungated "
        f"{rec['ungated_ms']:.4f} ms (bit-equal); lse err {err:.2e} "
        f"[{card}]")
    return rec, path


M_RANKS = 4                       # (b): four processes on the one card
M_SLOTS = 16                      # lanes of every mesh table (8 a replica
                                  # at data 2)
M_REQS, M_PROMPT, M_NEW = 4, 16, 16   # (b)'s (2, 2) run: greedy requests
M_DEADLINE_S = 300                # (b)'s ranks are killed past this
M_TRAFFIC = 16                    # (a): the traffic mix's first requests


def mesh_last(torch, card, kernels):
    """Phase 11b: the serving mesh (``launch.mesh``, ``Engine(mesh=)``,
    the scheduler's mesh step) on full-width qwen1.5-4b, mimps with the
    fixed-capacity index and the guard, the traffic phase's table (16
    lanes, max_len 160).

    (a) In this process, a one-rank NCCL group (``FileStore``), mesh
        (1, 1): the parity trace and the first ``M_TRAFFIC`` requests of
        the traffic mix (Poisson, numpy seed 0) through the captured mesh
        scheduler and through the one-device captured scheduler on an
        engine of the same index: tokens and log Z bit for bit, one
        capture, ``ivf_decode`` once a step and the gated ``topk_z`` twice.
        Each step's graph replay in device ms beside the other's, and the
        mesh step's NCCL kernels by one replay under ``torch.profiler``
        (every collective is issued at size 1 too). Then one eager mesh
        step of a busy table with every kernel call held to its plain
        version (``held_step``: ``ivf_decode`` on the staged union, the
        gated ``topk_z`` on the rank's rows). The group is destroyed.
    (b) ``M_RANKS`` processes of this script on the one card over gloo
        (``mesh_rank``), eager, after everything above is freed: at (1, 4)
        every method's ``shard_decode`` on 16 hidden states of the model
        held to the one-device decode on the same operands (top-1 equal,
        log Z within 1e-5, top ids equal where the scores are 1e-3 apart,
        whether the bits are equal logged); at (2, 2) ``M_REQS`` greedy
        requests of ``M_NEW`` tokens, each equal to ``generate`` at batch
        8 with the request in every lane (C9's rule: a replica's trunk
        runs 8 lanes). Each rank's kernel launches in that run, peak
        memory and seconds come back to this process.

    Returns the path's launches, the gated ``topk_z``'s and the held
    calls' max abs err by record name."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import Model
    from repro_torch.serve import (Engine, Request, Scheduler, Server,
                                   poisson_arrivals, trace_arrivals)

    dev = torch.device("cuda")
    t_phase = time.time()
    counted = PathCounts(torch, kernels)
    cfg = get_config("qwen1.5-4b")
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    tmp = tempfile.mkdtemp(prefix="mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/nccl", 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    held = {}
    try:
        mesh = make_serving_mesh(1, 1)
        t0 = time.time()
        eng = Engine(Model(cfg), params, T_MAX_LEN, seed=7,
                     device_index=True, health_guard=True, device=dev,
                     mesh=mesh)
        solo = Engine(Model(cfg), params, T_MAX_LEN, seed=7,
                      device_index=True, health_guard=True, device=dev,
                      index_assign=eng.index.assign)
        torch.cuda.synchronize()
        log(f"mesh (a): a one-rank NCCL group, mesh (1, 1); a mesh engine "
            f"and a one-device engine on its index in "
            f"{time.time() - t0:.1f} s [{card}]")
        gen = torch.Generator(device=dev).manual_seed(21)

        def prompt(n):
            return torch.randint(0, cfg.vocab, (n,), generator=gen,
                                 device=dev).cpu().numpy()
        par = [(prompt(p), n, 100 + i, t)
               for i, (p, n, t) in enumerate(T_PARITY)]
        lengths = (16, 32, 64, 128)
        mix = [(prompt(lengths[i % 4]), T_NEW, 1000 + i,
                0.0 if i % 2 == 0 else 0.8) for i in range(M_TRAFFIC)]

        def run(sched):
            reqs = [Request(prompt=p, max_new_tokens=n, seed=sd,
                            temperature=t) for p, n, sd, t in par + mix]
            arr = (trace_arrivals(reqs[:len(par)], list(T_PARITY_AT))
                   + [dataclasses.replace(a, at_step=a.at_step + 40)
                      for a in poisson_arrivals(reqs[len(par):], T_RATE,
                                                seed=0)])
            rep = Server(sched).run(arrivals=arr)
            by = {c.request.req_id: c for c in rep.completions}
            return rep, [(by[r.req_id].tokens, by[r.req_id].log_zs)
                         for r in reqs]
        s_solo = Scheduler(solo, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3)
        rep_s, want = run(s_solo)
        s_mesh = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3)
        (rep, got), counts, n_gated = counted(lambda: run(s_mesh))
        check(got == want, "mesh (a): the captured mesh step's tokens or "
              "log Z differ from the one-device captured scheduler's")
        check(s_mesh.captures == 1, f"mesh (a): {s_mesh.captures} captures")
        check(counts["ivf_decode"] == rep.steps, f"mesh (a): ivf_decode "
              f"launched {counts['ivf_decode']} times in {rep.steps} steps")
        check(n_gated == 2 * rep.steps, f"mesh (a): the gated topk_z "
              f"launched {n_gated} times in {rep.steps} steps")
        ms = {}
        for name, s in (("one device", s_solo), ("mesh (1, 1)", s_mesh)):
            ms[name] = _median_events(torch,
                                      s._graphs[s.tier].graph.replay, 20)
        nccl = graph_kernels(torch, s_mesh, "nccl")
        log(f"mesh (a): {len(par) + M_TRAFFIC} requests (the parity trace, "
            f"then the traffic mix at Poisson {T_RATE}/step), {rep.steps} "
            f"steps ({rep_s.steps} on one device): tokens and log Z bit-equal "
            f"to the one-device captured scheduler's; one capture; a step's "
            f"graph replay {ms['mesh (1, 1)']:.4f} ms device against "
            f"{ms['one device']:.4f} ms on one device (+"
            f"{ms['mesh (1, 1)'] - ms['one device']:.4f} ms); NCCL kernels "
            f"a step: {nccl}; {counts['ivf_decode']} ivf_decode and "
            f"{n_gated} gated topk_z launches [{card}]")
        del s_solo, s_mesh
        # one eager mesh step of a busy table, each kernel call held
        before = _build.snapshot()
        s = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3,
                      eager=True)
        busy = [Request(prompt=p, max_new_tokens=n, seed=sd, temperature=t)
                for p, n, sd, t in mix[:T_HELD_LANES]]
        for r in busy:
            s.admit(r)
        for _ in range(T_HELD_WARM):
            s.step()
        calls = collectives_a_step(torch, s)
        log(f"mesh (a): an eager mesh step issues {len(calls)} all-reduces "
            f"(elements {calls}) on the one-rank groups [{card}]")
        staging_ms(torch, s, calls[0] * 4, card)
        held = held_step(torch, s, busy[1], "mesh (1, 1) held mimps step",
                         card)
        _build.restore(before)
        for name in ("ivf_decode", "topk_z[gated]"):
            check(name in held, f"mesh (a): no {name} call was held")
        s.drain()
        del s, eng, solo, mesh
    finally:
        dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    path, gated = counted.totals()
    try:
        rank_counts = mesh_ranks(torch, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for rc in rank_counts:
        for name, n in rc["counts"].items():
            path[name] = path.get(name, 0) + n
        gated += rc["gated"]
    log(f"mesh path launches {path}, gated topk_z {gated}; held max abs "
        f"err {held}; phase {time.time() - t_phase:.1f} s [{card}]")
    return path, gated, held


def staging_ms(torch, sched, n_bytes, card):
    """Device ms of the mesh step's row gather alone (``gather_rows`` of
    the plan's capacity: 27 distinct blocks, the pad slots repeating the
    last as ``plan_heads`` pads, then the tail rows) and of its all-reduce
    alone, beside the time to write ``n_bytes`` once at the memory rate."""
    from repro_torch.core.distributed import bitsum_
    from repro_torch.serve.output_layer import gather_rows
    index = sched.engine.index
    nb, br, d = index.v_blocks.shape
    cap = min(sched.n_slots * sched.engine.cfg.partition.n_probe, nb)
    dev = index.v_blocks.device
    ids = torch.clamp(torch.arange(cap, device=dev), max=26) * 20
    slots = torch.cat([(ids[:, None] * br + torch.arange(br, device=dev)
                        ).reshape(-1), torch.arange(1000, device=dev)])
    flat = index.v_blocks.reshape(-1, d)
    group = sched._model_group
    rows = gather_rows(flat, slots, group)
    gather = _median_events(torch, lambda: gather_rows(flat, slots, group),
                            10)
    reduce = _median_events(torch, lambda: bitsum_(rows, group), 10)
    log(f"mesh (a): the row gather of {cap} union slots and 1000 tail rows "
        f"({rows.numel() * rows.element_size() / 1e6:.1f} MB) "
        f"{gather:.4f} ms, its all-reduce alone {reduce:.4f} ms, against "
        f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms to write it once "
        f"[{card}]")


def collectives_a_step(torch, sched):
    """The element counts of the all-reduces one eager step of ``sched``
    issues, in order."""
    import torch.distributed as dist
    calls, real = [], dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)
    dist.all_reduce = counted
    try:
        sched.step()
    finally:
        dist.all_reduce = real
    return calls


def graph_kernels(torch, sched, needle):
    """Kernels of one replay of ``sched``'s captured step whose name holds
    ``needle``: 'n kernels, ms' by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = sched._graphs[sched.tier]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    sched.reset_metrics()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and needle in e.name.lower():
            name = e.name.split("(")[0][:48]
            ms, n = by.get(name, (0.0, 0))
            by[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return "; ".join(f"{n} x{c} {v:.4f} ms" for n, (v, c) in by.items()) \
        or "none"


def mesh_ranks(torch, card, tmp):
    """(b): ``M_RANKS`` processes of this script (``--mesh-rank``) joined
    with a deadline, every one killed past it; returns each rank's
    results and fails on any rank's failure."""
    t0 = time.time()
    procs = []
    for r in range(M_RANKS):
        out = open(f"{tmp}/rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             str(r), f"{tmp}/gloo", tmp], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT), out))
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t0 + M_DEADLINE_S - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    secs = time.time() - t0
    logs = [Path(f"{tmp}/rank{r}.log").read_text() for r in range(M_RANKS)]
    for r, (p, _) in enumerate(procs):
        check(p.returncode == 0, f"mesh (b): rank {r} exited "
              f"{p.returncode} after {secs:.1f} s:\n{logs[r][-3000:]}")
    res = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
           for r in range(M_RANKS)]
    for line in logs[0].splitlines():
        log(line)
    log(f"mesh (b): {M_RANKS} ranks on the one card over gloo in "
        f"{secs:.1f} s; peak memory by rank "
        f"{[round(x['peak_gb'], 3) for x in res]} GB, seconds by rank "
        f"{[round(x['seconds'], 1) for x in res]} [{card}]")
    check(all(x["tokens"] == res[0]["tokens"] for x in res),
          "mesh (b): the ranks served different tokens")
    return res


def separated_ids_equal(name, got, ref):
    """Top-k scores of two decodes to TOL, and their ids equal at every
    rank whose score is more than TOL from its neighbours' (the last rank:
    from the one above). Returns the number of ids compared."""
    gv, gi, rv, ri = (t.float().cpu() for t in (got.top_score, got.top_id,
                                                ref.top_score, ref.top_id))
    err = (gv - rv).abs().max().item()
    check(err <= TOL, f"{name}: top-k scores differ by {err}")
    n, k = 0, rv.shape[1]
    for q in range(rv.shape[0]):
        for j in range(k):
            up = rv[q, j - 1] - rv[q, j] if j else float("inf")
            down = rv[q, j] - rv[q, j + 1] if j + 1 < k else float("inf")
            if up > TOL and down > TOL:
                check(gi[q, j] == ri[q, j], f"{name}: query {q} rank {j} "
                      f"id {int(gi[q, j])} != {int(ri[q, j])}")
                n += 1
    return n


def mesh_rank(torch, rank, store, out):
    """One rank of ``mesh_last``'s (b), on the one card: a gloo group of
    ``M_RANKS`` over ``store``, full-width qwen1.5-4b from seed 0, then
    the (1, 4) decode holds and the (2, 2) run. Writes
    ``<out>/rank<r>.json``; rank 0 logs."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.backends import get_backend, local_shard
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_z
    from repro_torch.kernels.ivf_score import ivf_decode, union_scores
    from repro_torch.kernels.lsh_probe import lsh_probe
    from repro_torch.kernels.topk_z import topk_z
    from repro_torch.launch.mesh import axis_group, make_serving_mesh
    from repro_torch.models import Model
    from repro_torch.serve import (Engine, Request, Scheduler, Server,
                                   generate, trace_arrivals)

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()
    say = log if rank == 0 else (lambda msg: None)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(store, M_RANKS),
                            rank=rank, world_size=M_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    cfg = get_config("qwen1.5-4b")
    pc = cfg.partition
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.reset_peak_memory_stats()
    # -- (1, 4): every method's shard_decode against the one-device decode
    mesh = make_serving_mesh(1, M_RANKS, device_type="cuda")
    group = axis_group(mesh, "model")
    t0 = time.time()
    eng = Engine(model, params, T_MAX_LEN, seed=7, device_index=True,
                 health_guard=True, device=dev, mesh=mesh)
    toks = torch.randint(0, cfg.vocab, (16, M_PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    h = eng.prefill(toks)[0].contiguous()
    say(f"mesh (b) (1, 4): engine (index padded to "
        f"{eng.index.n_blocks} blocks) and 16 hidden states in "
        f"{time.time() - t0:.1f} s")
    for method in SERVE_METHODS:
        backend = get_backend(method)
        st = eng.tier_state(method)
        tail = (backend.draw_tail(st, pc, torch.Generator(
            device=dev).manual_seed(9)) if backend.has_tail(st) else None)
        # lsh keeps its plain path under the mesh (serve.output_layer)
        ref = backend.decode(st, h, pc, k=pc.sample_k,
                             use_kernel=method != "lsh", tail_idx=tail)
        loc = local_shard(st, M_RANKS, rank)

        def shard():
            return backend.shard_decode(loc, h, pc, group=group,
                                        k=pc.sample_k, use_kernel=True,
                                        tail_idx=tail)
        got = shard()
        torch.cuda.synchronize()
        t1 = time.time()
        shard()
        torch.cuda.synchronize()
        secs = time.time() - t1
        check(torch.equal(got.top_id[:, 0], ref.top_id[:, 0]),
              f"mesh (b) (1, 4) {method}: top-1 ids differ")
        err = (got.log_z - ref.log_z).abs().max().item()
        check(err <= 1e-5, f"mesh (b) (1, 4) {method}: log Z differs by "
              f"{err}")
        n_ids = separated_ids_equal(f"mesh (b) (1, 4) {method}", got, ref)
        bits = all(torch.equal(a, b) for a, b in zip(got[:6], ref[:6]))
        say(f"mesh (b) (1, 4) {method}: top-1 equal, log Z err {err:.2e}, "
            f"{n_ids} separated ids equal, bits equal: {bits}; "
            f"shard_decode {secs * 1e3:.1f} ms on gloo")
    assign = eng.index.assign
    del eng, loc, st, ref, got
    torch.cuda.empty_cache()
    # -- (2, 2): M_REQS greedy requests, each held to generate at batch 8
    mesh = make_serving_mesh(2, M_RANKS // 2, device_type="cuda")
    eng = Engine(model, params, T_MAX_LEN, seed=7, device_index=True,
                 health_guard=True, device=dev, mesh=mesh,
                 index_assign=assign)
    sched = Scheduler(eng, M_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3,
                      eager=True)
    gen = torch.Generator(device=dev).manual_seed(23)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (M_PROMPT,),
                                         generator=gen, device=dev),
                    max_new_tokens=M_NEW, seed=200 + i)
            for i in range(M_REQS)]
    kernels = {"topk_z": topk_z, "ivf_decode": ivf_decode,
               "union_scores": union_scores, "fmbe_z": fmbe_z,
               "lsh_probe": lsh_probe}
    torch.cuda.synchronize()
    _build.reset_counts(kernels.values())
    t0 = time.time()
    rep = Server(sched).run(arrivals=trace_arrivals(reqs, list(
        range(M_REQS))))
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    gated = topk_z.gated
    counts["topk_z"] -= gated
    by = {c.request.req_id: c for c in rep.completions}
    tokens = [by[r.req_id].tokens for r in reqs]
    check(all(len(t) == M_NEW for t in tokens), "mesh (b) (2, 2): a "
          "request did not complete")
    for r, got in zip(reqs, tokens):
        want = generate(eng, torch.as_tensor(r.prompt, device=dev)[None]
                        .expand(sched.lanes_per_replica, -1), M_NEW)
        check(want[0].tolist() == got, f"mesh (b) (2, 2): request "
              f"{r.req_id}'s tokens differ from generate at batch "
              f"{sched.lanes_per_replica}")
    say(f"mesh (b) (2, 2): {M_REQS} requests of {M_NEW} tokens on "
        f"{M_SLOTS} lanes ({sched.lanes_per_replica} a replica), "
        f"{rep.steps} eager steps in {secs:.2f} s ({secs / rep.steps * 1e3:.1f}"
        f" ms a step on gloo), each equal to generate at batch "
        f"{sched.lanes_per_replica}; launches {counts}, gated topk_z "
        f"{gated}")
    res = {"rank": rank, "counts": counts, "gated": gated, "tokens": tokens,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.time() - t_start}
    dist.destroy_process_group()
    Path(f"{out}/rank{rank}.json").write_text(json.dumps(res))
    return 0


# -- phase 15: the dry run and cost report -----------------------------------

D_ARCH = "qwen1.5-4b"
D_CELLS = (("train_4k", "exact"), ("prefill_32k", "exact"),
           ("decode_32k", "exact"), ("decode_32k", "mimps"))
D_DEADLINE_S = 420            # (a)'s cell processes are killed past this
D_RANKS = 4                   # (c): four processes on the one card, gloo
D_RANK_DEADLINE_S = 240       # (c)'s ranks are killed past this
D_QUERIES = 16                # (c): prefill hidden states of 16 prompts


def dryrun_last(torch, card, kernels):
    """Phase 15, last (``dryrun_last``): the dry run and cost report
    (``launch.dryrun``, ``hlo_analysis``, ``breakdown``) and the dry-run
    bodies of ``serve.output_layer`` on the card.

    (a) ``launch.dryrun`` for qwen1.5-4b at train_4k, prefill_32k,
        decode_32k and decode_32k mimps on mesh ``single`` (a fake process
        group of 256 ranks), one CPU process a cell, started first and
        joined last: each cell's per-rank FLOPs, bytes, collectives, peak
        and trace seconds logged; decode_32k's trunk FLOPs equal the
        config's closed form (8 lanes at KV 32768).
    (b) The traffic phase's captured 16-lane step (a guarded
        ``device_index`` mimps engine, max_len 160, one device: the
        mesh (1, 1) step without its size-1 collectives) counted on fake
        tensors (``hlo_analysis.fake_copy`` of the scheduler), its replay
        timed with CUDA events and by kind (``breakdown.measure_step``),
        and the whole step's share of the card's bound.
    (c) ``D_RANKS`` processes of this script (``--dryrun-rank``) on the
        one card over gloo, mesh (1, 4): ``sharded_decode`` mimps, mince
        and fmbe on (b)'s index (553 blocks of 512 padded with dead
        blocks to 556, 139 a rank), 16 prefill hidden states, p 4 and l
        250 a rank, with and without ``use_kernel``: ``ivf_score`` held to
        its plain version, log Z within 1e-3, top ids equal unless their
        scores are within 1e-3, the exhaustive probe within 1e-3 of
        ``topk_z``'s exact log Z, every rank's outputs bit-equal. Here,
        ``streaming_logz_argmax``'s ``topk_z`` route against its plain
        chunks at V 151936.

    Returns (the path's launches by record name, 0, the holds' max abs
    err by record name)."""
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import breakdown
    from repro_torch.launch.hlo_analysis import fake_copy
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request, Scheduler, Server
    from repro_torch.serve import trace_arrivals
    from repro_torch.serve.output_layer import streaming_logz_argmax
    from torch._subclasses.fake_tensor import FakeTensorMode

    t_phase = time.time()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    cells = []
    for shape, mode in D_CELLS:                 # (a), in the background
        out = open(f"{tmp}/{shape}_{mode}.log", "w")
        cells.append((shape, mode, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             D_ARCH, "--shape", shape, "--mesh", "single", "--output-mode",
             mode, "--out", f"{tmp}/a"], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT)))
    counts, held = {"topk_z": 0, "ivf_score": 0, "fmbe_z": 0}, {}
    try:
        # -- (b) the captured 16-lane step, counted and measured ----------
        cfg = get_config(D_ARCH)
        pc = cfg.partition
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        t0 = time.time()
        eng = Engine(model, params, T_MAX_LEN, seed=7, device_index=True,
                     health_guard=True, device=dev)
        sched = Scheduler(eng, T_SLOTS, prompt_cap=T_PROMPT_CAP, seed=3)
        gen = torch.Generator(device=dev).manual_seed(31)
        req = Request(prompt=torch.randint(0, cfg.vocab, (16,), generator=gen,
                                           device=dev).cpu().numpy(),
                      max_new_tokens=4, seed=300)
        Server(sched).run(arrivals=trace_arrivals([req], [0]))
        check(sched.captures == 1, f"dryrun (b): {sched.captures} captures")
        g = sched._graphs[sched.tier]
        replay_ms = _median_events(torch, g.graph.replay, 20)
        t_build = time.time() - t0
        fm = FakeTensorMode()
        fake = fake_copy(sched, fm)
        t1 = time.time()
        ms, by_kind, c = breakdown.measure_step(
            g.graph.replay, lambda: fake._step_body(fake.tier),
            fake_mode=fm, log=log)
        t_count = time.time() - t1
        bound_s = max(c.flops / BF16_FLOPS, c.bytes / HBM_BYTES_PER_S)
        dev_ms = sum(ms.values())
        log(f"dryrun (b): the captured {T_SLOTS}-lane {sched.tier} step "
            f"(max_len {T_MAX_LEN}, engine and capture "
            f"{t_build:.1f} s): counted on fake tensors in "
            f"{t_count:.1f} s: {c.flops / 1e9:.4f} GFLOP, "
            f"{c.bytes / 1e9:.4f} GB, {c.transcendentals / 1e6:.3f} M "
            f"transcendentals; replay {replay_ms:.4f} ms (CUDA events, "
            f"median of 20), {dev_ms:.4f} ms of kernel time under the "
            f"profiler; bound max({c.flops / BF16_FLOPS * 1e3:.4f}, "
            f"{c.bytes / HBM_BYTES_PER_S * 1e3:.4f}) ms = "
            f"{bound_s * 1e3:.4f} ms: whole-step share "
            f"{bound_s / (replay_ms / 1e3):.4f} [{card}]")
        unmatched = [k for k in set(ms) | set(by_kind)
                     if k.startswith("unmatched")]
        log(f"dryrun (b): kinds unmatched between the count and the "
            f"profile: {unmatched or 'none'}")
        # the inputs of (c): the index padded to a multiple of the ranks,
        # dead blocks ranked last by their radius, 16 hidden states, the
        # fmbe tier's feature map and sketch, the exact log Z
        idx = eng.index
        nb, br = idx.n_blocks, idx.block_rows
        pad = -nb % D_RANKS
        valid = torch.cat([idx.valid, idx.valid.new_zeros((pad, br))])
        live = valid.any(-1)
        radius = torch.cat([idx.block_radius.float(),
                            idx.block_radius.new_zeros(pad).float()])
        radius = torch.where(live, radius,
                             torch.full_like(radius, float("-inf")))
        toks = torch.randint(0, cfg.vocab, (D_QUERIES, 16), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        h = eng.prefill(toks)[0].clone().contiguous()
        fst = eng.tier_state("fmbe").fmbe
        w = model.head_matrix(params)
        lse_exact = kernels["topk_z"](h, w.contiguous(), 1)[0]
        torch.save({
            "v_blocks": torch.cat([idx.v_blocks, idx.v_blocks.new_zeros(
                (pad,) + tuple(idx.v_blocks.shape[1:]))]).cpu(),
            "centroids": torch.cat([idx.block_centroids,
                                    idx.block_centroids.new_zeros(
                                        (pad, idx.block_centroids.shape[1]))
                                    ]).cpu(),
            "radius": radius.cpu(), "valid": valid.cpu(), "h": h.cpu(),
            "omega": fst.fm.omega.cpu(), "degree": fst.fm.degree.cpu(),
            "coef": fst.fm.coef.cpu(), "p": fst.fm.p,
            "lambda": fst.lambda_tilde.cpu(), "lse_exact": lse_exact.cpu(),
            "n_probe": pc.n_probe, "l": pc.l}, f"{tmp}/c_inputs.pt")
        log(f"dryrun (c): index {nb} blocks of {br} + {pad} dead, "
            f"{D_QUERIES} hidden states saved for the ranks")
        # streaming_logz_argmax: the topk_z route (the path) and its plain
        # chunks on the whole head
        _build.reset_counts(kernels.values())
        got = streaming_logz_argmax(h, w.contiguous(), use_kernel=True)
        torch.cuda.synchronize()
        counts["topk_z"] += kernels["topk_z"].launches
        want = streaming_logz_argmax(h, w.contiguous(), use_kernel=False)
        err = (got[0] - want[0]).abs().max().item()
        check(err <= TOL, f"dryrun (c): streaming_logz_argmax's topk_z "
              f"route differs from its plain chunks by {err} in log Z")
        differ = got[1] != want[1]
        gap = (got[2] - want[2]).abs()
        check(bool((gap[differ] <= TOL).all()), "dryrun (c): "
              "streaming_logz_argmax's top ids differ where their scores "
              "are more than 1e-3 apart")
        held["topk_z"] = err
        log(f"dryrun (c): streaming_logz_argmax at V {w.shape[0]}, "
            f"{D_QUERIES} queries: topk_z route log Z err {err:.2e} from "
            f"the plain chunks, {int(differ.sum())} top ids differ (within "
            f"1e-3) [{card}]")
        del sched, fake, g, eng, params, model, w, h, fst, idx
        gc.collect()
        torch.cuda.empty_cache()
        # -- (c) the ranks -------------------------------------------------
        res = dryrun_ranks(torch, card, tmp)
        for r in res:
            for name, n in r["counts"].items():
                counts[name] += n
            for name, e in r["held"].items():
                held[name] = max(held.get(name, 0.0), e)
        # -- (a) the cells ---------------------------------------------------
        dryrun_cells_join(cfg, cells, tmp, card)
    finally:
        for *_, out, p in cells:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"dryrun path launches {counts}; held max abs err {held}; phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    return counts, 0, held


def dryrun_cells_join(cfg, cells, tmp, card):
    """(a): each cell's process joined with a deadline; its record
    logged, decode_32k's trunk held to the closed form."""
    t_end = time.time() + D_DEADLINE_S
    for shape, mode, out, p in cells:
        try:
            p.wait(timeout=max(1.0, t_end - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        out.flush()
        text = Path(out.name).read_text()
        check(p.returncode == 0, f"dryrun (a): {D_ARCH} {shape} {mode} "
              f"exited {p.returncode}:\n{text[-3000:]}")
        suffix = "" if mode == "exact" else f"__{mode}"
        r = json.loads(Path(f"{tmp}/a/single/{D_ARCH}__{shape}{suffix}"
                            f".json").read_text())
        log(f"dryrun (a): {D_ARCH} {shape} {mode} on mesh single "
            f"({r['n_chips']} fake ranks), {r['step']}: per rank "
            f"{r['flops_per_device']:.6e} FLOP, "
            f"{r['bytes_per_device']:.6e} bytes, collectives "
            f"{r['collective_bytes']}, peak "
            f"{r['peak_bytes_per_device'] / 1e9:.3f} GB, traced in "
            f"{r['trace_s']} s on the host (counts, not measurements) "
            f"[{card}]")
        if shape == "decode_32k" and mode == "exact":
            hd, s, lanes = cfg.resolved_head_dim, 32768, r["lanes_per_rank"]
            proj = cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
            trunk = 2 * (proj + 2 * cfg.n_heads * hd * s) * cfg.n_layers \
                * lanes
            got = r["sections"]["trunk"]["flops"]
            check(got == trunk, f"dryrun (a): decode_32k's trunk counts "
                  f"{got} FLOP, the closed form {trunk}")
            log(f"dryrun (a): decode_32k's trunk {got / 1e9:.2f} GFLOP = "
                f"the closed form at {lanes} lanes of KV {s}")


def dryrun_ranks(torch, card, tmp):
    """(c): ``D_RANKS`` processes of this script (``--dryrun-rank``) joined
    with a deadline; every rank's outputs bit-equal; returns each rank's
    results."""
    t0 = time.time()
    procs = []
    for r in range(D_RANKS):
        out = open(f"{tmp}/rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dryrun-rank",
             str(r), f"{tmp}/gloo", tmp], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT), out))
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t0 + D_RANK_DEADLINE_S - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    secs = time.time() - t0
    logs = [Path(f"{tmp}/rank{r}.log").read_text() for r in range(D_RANKS)]
    for r, (p, _) in enumerate(procs):
        check(p.returncode == 0, f"dryrun (c): rank {r} exited "
              f"{p.returncode} after {secs:.1f} s:\n{logs[r][-3000:]}")
    for line in logs[0].splitlines():
        log(line)
    outs = [torch.load(f"{tmp}/rank{r}.pt") for r in range(D_RANKS)]
    for r in range(1, D_RANKS):
        for key, vals in outs[0].items():
            check(all(torch.equal(a, b) for a, b in zip(vals, outs[r][key])),
                  f"dryrun (c): rank {r}'s {key} differs from rank 0's")
    res = [json.loads(Path(f"{tmp}/rank{r}.json").read_text())
           for r in range(D_RANKS)]
    log(f"dryrun (c): {D_RANKS} ranks over gloo in {secs:.1f} s, every "
        f"rank's outputs bit-equal; launches by rank "
        f"{[x['counts'] for x in res]} [{card}]")
    return res


def dryrun_rank(torch, rank, store, tmp):
    """One rank of ``dryrun_last``'s (c), on the one card. Writes
    ``<tmp>/rank<r>.pt`` (each case's kernel-route outputs) and
    ``<tmp>/rank<r>.json``; rank 0 logs."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.feature_maps import FeatureMap, FMBEState
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_pack, fmbe_z
    from repro_torch.kernels.ivf_score import ivf_score, ivf_score_plain
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import output_layer as ol

    torch.backends.cuda.matmul.allow_tf32 = False
    say = log if rank == 0 else (lambda msg: None)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(store, D_RANKS),
                            rank=rank, world_size=D_RANKS,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_serving_mesh(1, D_RANKS, device_type="cuda")
    z = torch.load(f"{tmp}/c_inputs.pt", mmap=True)
    nb = z["v_blocks"].shape[0]
    part = slice(rank * nb // D_RANKS, (rank + 1) * nb // D_RANKS)
    ivf = ol.IVFSpecs(
        v_blocks=z["v_blocks"][part].to(dev).contiguous(),
        centroids=z["centroids"][part].to(dev).contiguous(),
        radius=z["radius"][part].to(dev).contiguous(),
        valid=z["valid"][part].to(dev).contiguous())
    h = z["h"].to(dev)
    fm = FeatureMap(omega=z["omega"].to(dev), degree=z["degree"].to(dev),
                    coef=z["coef"].to(dev), p=z["p"])
    fstate = FMBEState(fm=fm, lambda_tilde=z["lambda"].to(dev),
                       pack=fmbe_pack(fm.omega, fm.degree, fm.coef))
    nb_l, br = ivf.v_blocks.shape[:2]
    p_local = max(1, z["n_probe"] // D_RANKS)
    l_local = max(8, z["l"] // D_RANKS)
    slots = torch.randint(0, nb_l * br, (l_local,), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(100 + rank))
    cases = (("mimps", p_local), ("mince", p_local), ("fmbe", p_local),
             ("mimps", nb_l), ("mince", nb_l))

    def run(method, p, use_kernel):
        kw = {"fmbe_state": fstate} if method == "fmbe" else {"slots": slots}
        if method == "mince":
            kw.update(iters=3, solver="halley")
        return ol.sharded_decode(mesh, method, ivf, h, n_probe_local=p,
                                 l_local=l_local, use_kernel=use_kernel,
                                 **kw)
    torch.cuda.synchronize()
    _build.reset_counts([ivf_score, fmbe_z])
    got = {f"{m}@p{p}": run(m, p, True) for m, p in cases}
    torch.cuda.synchronize()
    counts = {"ivf_score": ivf_score.launches, "fmbe_z": fmbe_z.launches}
    held = {}
    for (m, p), (key, k_out) in zip(cases, got.items()):
        t1 = time.perf_counter()
        p_out = run(m, p, False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        err = (k_out[0] - p_out[0]).abs().max().item()
        check(err <= TOL, f"dryrun (c) {key}: log Z differs from the plain "
              f"route by {err}")
        differ = k_out[1] != p_out[1]
        check(bool(((k_out[2] - p_out[2]).abs()[differ] <= TOL).all()),
              f"dryrun (c) {key}: top ids differ where their scores are "
              f"more than 1e-3 apart")
        name = "fmbe_z" if m == "fmbe" else "ivf_score"
        held[name] = max(held.get(name, 0.0), err)
        note = ""
        if p == nb_l:
            ex = (k_out[0] - z["lse_exact"].to(dev)).abs().max().item()
            check(ex <= TOL, f"dryrun (c) {key}: the exhaustive probe's "
                  f"log Z is {ex} from topk_z's exact log Z")
            note = f", exact log Z err {ex:.2e}"
        say(f"dryrun (c) rank 0 {key} (l {l_local}): log Z err {err:.2e} "
            f"from plain, {int(differ.sum())} top ids differ within 1e-3"
            f"{note}; plain route {plain_s * 1e3:.1f} ms on gloo")
    bids = ol._local_probe(ivf, h, p_local, False)[0]
    s_k = ivf_score(ivf.v_blocks, h, bids)
    s_p = ivf_score_plain(ivf.v_blocks, h, bids)
    err = (s_k - s_p).abs().max().item()
    check(err <= TOL, f"dryrun (c): ivf_score differs from its plain "
          f"version by {err}")
    held["ivf_score"] = max(held["ivf_score"], err)
    say(f"dryrun (c) rank 0: ivf_score at ({D_QUERIES}, {p_local}, {br}) "
        f"on {nb_l} local blocks: max abs err {err:.2e}")
    torch.save({k: tuple(t.cpu() for t in v) for k, v in got.items()},
               f"{tmp}/rank{rank}.pt")
    Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "counts": counts, "held": held}))
    dist.destroy_process_group()
    return 0


V_ARCH = "llama-3.2-vision-90b"
V_LAYERS = 30                     # 6 whole groups of 4 self + 1 cross
V_PARAMS = 27_770_986_496         # the JAX package's eval_shape at 30 layers
V_NEW = 32


TM_LAYERS = 4                     # (b): qwen1.5-4b's depth cut to 4 layers
TM_B = 8                          # (b): B 8 x S 256
TM_RANKS = 4
TM_DEADLINE_S = 420               # (b)'s ranks are killed past this
TM_CLI_TIMEOUT_S = 240            # (c): each run of the train CLI
# data > 1 against one device: a mean of replica means, so rounding alone
TM_LOSS_REL, TM_GNORM_REL = 1e-5, 1e-3
TM_GRAD_MAX, TM_GRAD_L2 = 2 ** -7, 1e-2   # of the leaf's max |g|; rel L2
# a figure that moves more than that when one device splits the same rows
# into the replicas' two microbatches (the embedding table's gradient,
# which CUDA's embedding backward rounds to bf16 in chunks of indices; the
# key bias's, 0 in exact arithmetic and so all rounding) is held to twice
# that move instead
TM_NOISE = 2.0


def word_sums(torch, x, chunk=1 << 24):
    """A whole leaf's fingerprint on the device: (sum w, sum (i + 1) w) mod
    2**64 over its int32 words w (its bytes where they do not fill
    words)."""
    b = x.detach().contiguous().view(-1).view(torch.uint8)
    w = b.view(torch.int32) if b.numel() % 4 == 0 else b.to(torch.int32)
    s1 = s2 = 0
    for start in range(0, w.numel(), chunk):
        c = w[start:start + chunk].long()
        i = torch.arange(start + 1, start + 1 + c.numel(), device=c.device)
        s1 += int(c.sum())
        s2 += int((c * i).sum())
    return [s1 % 2 ** 64, s2 % 2 ** 64]


def state_fingerprints(torch, state, specs=None, coord=0, parts=1):
    """``word_sums`` of every leaf of the parameters, m and v, by name, as
    the state holds them (a rank's slices); given the whole state and the
    leaves' specs by path (``param_spec`` at model ``parts``), of the slice
    at model coordinate ``coord`` instead."""
    from repro_torch.models.transformer import tree_paths
    out = {}
    for part, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        for path, x in tree_paths(tree):
            for dim, entry in enumerate(() if specs is None
                                        else specs[path]):
                if entry == "model":
                    n = x.shape[dim] // parts
                    x = x.narrow(dim, coord * n, n)
            out[part + path] = word_sums(torch, x)
    return out


def timed_collectives(torch, fn):
    """Runs ``fn`` with every ``all_reduce`` synchronised and timed on the
    host clock: (fn's result, {dtype: [calls, elements, ms]})."""
    import torch.distributed as dist
    real, by = dist.all_reduce, {}

    def timed(t, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *args, **kwargs)
        torch.cuda.synchronize()
        rec = by.setdefault(str(t.dtype).removeprefix("torch."), [0, 0, 0.0])
        rec[0] += 1
        rec[1] += t.numel()
        rec[2] += (time.perf_counter() - t0) * 1e3
        return out
    dist.all_reduce = timed
    try:
        return fn(), by
    finally:
        dist.all_reduce = real


def mesh_train_steps(torch, kernels, step, state, batches, label, card,
                     first=0, per=1):
    """``step`` over ``batches`` (steps ``first``, ...), each from launch
    counts at 0 and timed (wall, synchronised); every step must launch each
    CE kernel ``per`` times (once a microbatch). Returns (state, [(loss,
    grad_norm, ms)], the counts summed)."""
    from repro_torch.kernels import _build
    names = ("fused_ce_fwd", "fused_ce_bwd")
    logs, total = [], dict.fromkeys(names, 0)
    for i, batch in enumerate(batches, first):
        _build.reset_counts(kernels[n] for n in names)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {n: kernels[n].launches for n in names}
        check(counts == dict.fromkeys(names, per), f"{label} step {i} "
              f"launched {counts}, want each CE kernel {per} times")
        for n in names:
            total[n] += counts[n]
        loss, gn = met["loss_total"].item(), met["grad_norm"].item()
        check(math.isfinite(loss), f"{label} step {i}: loss {loss}")
        logs.append((loss, gn, ms))
        log(f"{label} step {i}: loss {loss!r}, grad norm {gn!r}, {ms:.1f} "
            f"ms [{card}]")
    return state, logs, total


def train_mesh_last(torch, card, kernels):
    """Phase 13: the training mesh (``launch.mesh``'s rules, the sharded
    ``make_train_step``, ``compress_psum``, ``launch/train.py``).

    (a) In this process, a one-rank NCCL group (``FileStore``), mesh
        (1, 1): full-width, full-depth qwen1.5-4b (bf16, seed 0), fused_ce
        at B ``TRAIN_B`` x S ``TRAIN_S``, ``TrainConfig(warmup_steps=1)``;
        two sharded steps from ``init_train_state(mesh=)`` and a third with
        its all-reduces timed apart (``timed_collectives``), then, the
        sharded state freed, three one-device steps from the same seed (two
        states do not fit at once): the losses, grad norms and every leaf
        of the parameters, m and v (``state_fingerprints``) equal; each of
        the first two steps launches each CE kernel once. ms a step of
        both; the parameters' gather alone.
    (b) ``TM_RANKS`` processes of this script (``--train-mesh-rank``) on
        the one card over gloo, eager, joined with a deadline: qwen1.5-4b
        at full width with its depth cut to ``TM_LAYERS``, B ``TM_B``; the
        compute split at (1, 4) one step and at (2, 2) two (fused_ce),
        and at (2, 2) one mimps_ce step, each within the limits of the
        one-device steps of its loss (rank 0's, taken first: on the
        whole batch, and with the replicas' rows as two microbatches for
        ``TM_NOISE``), no leaf gathered whole,
        the data replicas of each model slice bit-equal, each rank's CE
        pair at its vocab rows held to plain (``hold_ce_shard``); one
        (2, 2) step with ``pod_axis="data"`` and int8 (finite, the
        replicas the same, one int32 all-reduce a leaf). Each rank's CE
        launches, peak memory and seconds come back.
    (c) ``python -m repro_torch.launch.train --reduced`` on the card,
        beside (b): 3 steps with a checkpoint at 2, and a run from that
        checkpoint alone: the final checkpoints equal bit for bit.

    Returns the CE kernels' launches on the path and their max abs errors
    at the ranks' rows."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.launch.mesh import gather_tree, make_mesh_2d
    from repro_torch.models import Model
    from repro_torch.train import (init_train_state, make_train_step,
                                   params_placements)

    dev = torch.device("cuda")
    t_phase = time.time()
    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    tc = TrainConfig(loss="fused_ce", warmup_steps=1)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    batches = [{k: torch.from_numpy(a).to(dev)
                for k, a in zip(("tokens", "labels"), next(it))}
               for _ in range(2)]
    tmp = tempfile.mkdtemp(prefix="train_mesh_")
    counts = {"fused_ce_fwd": 0, "fused_ce_bwd": 0}
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/nccl", 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_2d((1, 1))
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(model, tc, 0, dev, mesh=mesh)
        step = make_train_step(model, tc, mesh=mesh)
        state, logs, got = mesh_train_steps(
            torch, kernels, step, state, batches, "train mesh (a) (1, 1)",
            card)
        for n in counts:
            counts[n] += got[n]
        peak = torch.cuda.max_memory_allocated() / 1e9
        places = params_placements(model, mesh)
        gather = _median_events(torch, lambda: gather_tree(state.params,
                                                           places), 3)
        (state, _), by = timed_collectives(
            torch, lambda: step(state, batches[1]))
        fp = state_fingerprints(torch, state)
        log(f"train mesh (a): peak {peak:.2f} GB; the parameters' gather "
            f"alone {gather:.4f} ms; a third step's all-reduces, each "
            f"synchronised: {by} (dtype: calls, elements, ms) [{card}]")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, tc, 0, dev)
    step = make_train_step(model, tc)
    state, ref_logs, _ = mesh_train_steps(
        torch, kernels, step, state, batches, "train mesh (a) one device",
        card)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    # the third step above changed the sharded state: take it here too
    state, _ = step(state, batches[1])
    ref_fp = state_fingerprints(torch, state)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    check([x[:2] for x in logs] == [x[:2] for x in ref_logs],
          f"train mesh (a): losses and grad norms {logs} differ from one "
          f"device's {ref_logs}")
    differ = [k for k in ref_fp if fp[k] != ref_fp[k]]
    check(not differ, f"train mesh (a): {len(differ)} leaves differ from "
          f"one device's, first {differ[:3]}")
    log(f"train mesh (a): {len(fp)} leaves of the parameters, m and v "
        f"bit-equal to one device after 3 steps; ms a step mesh "
        f"{[round(x[2], 1) for x in logs]} against one device "
        f"{[round(x[2], 1) for x in ref_logs]}; peak {peak:.2f} against "
        f"{ref_peak:.2f} GB [{card}]")

    # (c) beside (b): the CLI's two short processes need no collective
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cli = pool.submit(train_cli, torch, card, tmp)
            res, held = train_mesh_ranks(torch, card, tmp)
            cli.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in res:
        for n in counts:
            counts[n] += r["counts"][n]
    log(f"train mesh path launches {counts}; the CE pair held to plain at "
        f"the ranks' rows, max abs err {held}; phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    return counts, {n: {"max_abs_err": e} for n, e in held.items()}


def train_mesh_ranks(torch, card, tmp):
    """(b): ``TM_RANKS`` processes of this script (``--train-mesh-rank``)
    joined with a deadline, every one killed past it; returns each rank's
    results and fails on any rank's failure."""
    t0 = time.time()
    procs = []
    for r in range(TM_RANKS):
        out = open(f"{tmp}/train_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--train-mesh-rank", str(r), f"{tmp}/gloo", tmp], cwd=ROOT,
            stdout=out, stderr=subprocess.STDOUT), out))
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t0 + TM_DEADLINE_S - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    secs = time.time() - t0
    logs = [Path(f"{tmp}/train_rank{r}.log").read_text()
            for r in range(TM_RANKS)]
    for r, (p, _) in enumerate(procs):
        check(p.returncode == 0, f"train mesh (b): rank {r} exited "
              f"{p.returncode} after {secs:.1f} s:\n{logs[r][-3000:]}")
    res = [json.loads(Path(f"{tmp}/train_rank{r}.json").read_text())
           for r in range(TM_RANKS)]
    for line in logs[0].splitlines():
        log(line)
    # the split: no leaf of qwen1.5-4b gathered whole under fused_ce; the
    # two data replicas of each model slice the same bits after the (2, 2)
    # steps and after the int8 step
    for x in res:
        for key in ("1x4", "2x2"):
            check(x["gathered"][key] == [], f"train mesh (b) {key}: rank "
                  f"{x['rank']} gathered {x['gathered'][key]} whole")
        for what in ("fp_2x2", "int8_fp"):
            check(x[what] == res[x["rank"] % 2][what], f"train mesh (b) "
                  f"{what}: ranks {x['rank']} and {x['rank'] % 2} hold "
                  f"different bits of their model slice")
        check(x["counts"]["fused_ce_fwd"] > 0 and x["counts"][
            "fused_ce_bwd"] > 0, f"train mesh (b): rank {x['rank']} "
              f"launched {x['counts']}")
    held = {"fused_ce_fwd": max(h["fwd_err"] for x in res
                                for h in x["held"].values()),
            "fused_ce_bwd": max(max(h["dh_err"][0], h["dw_err"][0])
                                for x in res for h in x["held"].values())}
    for key in res[0]["held"]:
        log(f"train mesh (b) {key}: the CE pair at each rank's rows held to "
            f"plain: " + "; ".join(
                f"rank {x['rank']} T {h['t']} x {h['rows']} rows "
                f"({h['labels_on_shard']} labels on the shard): fwd "
                f"{h['fwd_err']:.2e}, dh {h['dh_err'][0]:.2e} "
                f"({h['dh_err'][1]:.2e} of sum |terms|), dW "
                f"{h['dw_err'][0]:.2e} ({h['dw_err'][1]:.2e})"
                for x in res for h in [x["held"][key]]) + f" [{card}]")
    log(f"train mesh (b): {TM_RANKS} ranks on the one card over gloo in "
        f"{secs:.1f} s; the split step within the limits of one device's at "
        f"(1, 4) and (2, 2) (fused_ce) and at (2, 2) (mimps_ce), leaves "
        f"gathered whole by rank {[x['gathered'] for x in res]}; each model "
        f"slice the same on both data replicas after the (2, 2) and int8 "
        f"steps; CE launches by rank {[x['counts'] for x in res]}; peak "
        f"memory by rank {[x['peaks_gb'] for x in res]} GB beside the "
        f"{res[0]['whole_gb']:.2f} GB of whole bf16 parameters and f32 "
        f"gradients a gathering rank holds; seconds by rank "
        f"{[round(x['seconds'], 1) for x in res]} [{card}]")
    return res, held


def train_mesh_rank(torch, rank, store, out):
    """One rank of ``train_mesh_last``'s (b), on the one card: a gloo
    group of ``TM_RANKS`` over ``store``; rank 0 first takes the
    one-device steps the split is held to (fused_ce: two steps on the
    whole batch and two with two microbatches of the replicas' rows;
    mimps_ce: one step of each) while the others wait. Writes
    ``<out>/train_rank<r>.json``; rank 0 logs and checks."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels.fused_ce import fused_ce_bwd, fused_ce_fwd
    from repro_torch.launch.mesh import (axis_group, batch_shardings,
                                         gather_leaf, make_mesh_2d,
                                         shard_tree)
    from repro_torch.models import Model
    from repro_torch.models.transformer import tree_paths
    from repro_torch.train import (init_train_state, losses,
                                   make_train_step, params_placements,
                                   train_loop)

    t_start = time.time()
    say = log if rank == 0 else (lambda msg: None)
    dev = torch.device("cuda")
    card = card_line()
    kernels = {"fused_ce_fwd": fused_ce_fwd, "fused_ce_bwd": fused_ce_bwd}
    dist.init_process_group("gloo", store=dist.FileStore(store, TM_RANKS),
                            rank=rank, world_size=TM_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=TM_LAYERS)
    model = Model(cfg)
    tc = TrainConfig(loss="fused_ce", warmup_steps=1)
    tc_est = dataclasses.replace(tc, loss="mimps_ce")
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TM_B, TRAIN_S)
    batches = [{k: torch.from_numpy(a).to(dev)
                for k, a in zip(("tokens", "labels"), next(it))}
               for _ in range(2)]
    n_params = sum(x.numel() for _, x in tree_paths(
        model.init(torch.Generator(), "meta")))
    # what a rank that gathers every leaf holds during a step: the whole
    # bf16 parameters and their whole f32 gradients
    whole_gb = n_params * (2 + 4) / 1e9
    counts = {"fused_ce_fwd": 0, "fused_ce_bwd": 0}

    def add(got):
        for n in counts:
            counts[n] += got[n]
    # one device with two microbatches, microbatch i holding replica i's
    # rows (``_batch_rows`` takes rows i::2): at (2, 2) the mesh sums the
    # same rows' partial gradients
    half = TM_B // 2
    perm = torch.stack([torch.arange(half), torch.arange(half, TM_B)],
                       1).reshape(-1).to(dev)
    replica_rows = [{k: v[perm] for k, v in b.items()} for b in batches]
    fused = est = None
    if rank == 0:
        say(f"train mesh (b): qwen1.5-4b, {TM_LAYERS} layers, "
            f"{n_params / 1e9:.3f} B parameters, B {TM_B} x S {TRAIN_S}; "
            f"whole bf16 parameters + f32 gradients {whole_gb:.2f} GB")
        refs = {}
        # mimps_ce plans per microbatch on one device, but over the whole
        # batch on the mesh: its two-microbatch run replays the whole
        # batch's plan (recorded in the run before it), microbatch i cut
        # to its rows as data replica i cuts it, so that its move is the
        # data split's rounding alone
        real_plan, whole_plan = losses._plan_whole_batch, []
        mb_calls = itertools.count()

        def recorded(plan_fn, h2, lab):
            whole_plan.append(real_plan(plan_fn, h2, lab))
            return whole_plan[-1]

        def replayed(plan_fn, h2, lab):
            (sp, aux), i, t = whole_plan[0], next(mb_calls), h2.shape[0]
            return sp._replace(**{k: getattr(sp, k)[i * t:(i + 1) * t]
                                  for k in losses._PER_TOKEN}), aux

        for name, tcr, rows, per, n_steps, plan in (
                ("one device", tc, batches, 1, 2, real_plan),
                ("one device, 2 microbatches of the replicas' rows",
                 dataclasses.replace(tc, microbatches=2), replica_rows, 2,
                 2, real_plan),
                ("one device mimps_ce", tc_est, batches, 0, 1, recorded),
                ("one device mimps_ce, 2 microbatches of the replicas' "
                 "rows", dataclasses.replace(tc_est, microbatches=2),
                 replica_rows, 0, 1, replayed)):
            state = init_train_state(model, tcr, 0, dev)
            step = make_train_step(model, tcr)
            losses._plan_whole_batch = plan
            try:
                state, ref_logs, _ = mesh_train_steps(
                    torch, kernels, step, state, rows[:1],
                    f"train mesh (b) {name}", card, per=per)
                m1 = {p: m.to("cpu", copy=True) for p, m in tree_paths(
                    state.opt.m)}
                if n_steps > 1:
                    state, logs2, _ = mesh_train_steps(
                        torch, kernels, step, state, rows[1:],
                        f"train mesh (b) {name}", card, 1, per=per)
                    ref_logs += logs2
            finally:
                losses._plan_whole_batch = real_plan
            refs[name] = (ref_logs, m1)
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        whole_plan.clear()              # its tensors stay on the card
        n_replayed = next(mb_calls)
        check(n_replayed == 2, "train mesh (b): the two-microbatch mimps_ce "
              f"step replayed the whole batch's plan {n_replayed} times, "
              "not once a microbatch")
        # (the one-device run, the two-microbatch run) of each loss
        mb = ", 2 microbatches of the replicas' rows"
        fused = refs["one device"], refs["one device" + mb]
        est = refs["one device mimps_ce"], refs["one device mimps_ce" + mb]
    dist.barrier()
    peaks, gathered, held = {}, {}, {}

    def rel(g, r):
        return (((g - r).abs().max() / r.abs().max()).item(),
                ((g - r).norm() / r.norm()).item())

    def grad_errors(state, places, refs):
        """Each leaf's gradient after step 1 (m / (1 - b1), gathered whole
        from the slices; every rank calls) against the one-device run's of
        ``refs`` (one device, two microbatches), beside the two-microbatch
        run's move: on rank 0, {path: (ours, its move)}."""
        errs = {}
        for path, leaf in tree_paths(state.opt.m):
            g = gather_leaf(leaf, places[path])
            if rank == 0:
                (_, ref_m), (_, mb_m) = refs
                errs[path] = rel(g.cpu(), ref_m[path]), rel(mb_m[path],
                                                            ref_m[path])
            del g
        return errs

    def held_to(label, logs, refs, errs):
        """Rank 0: the losses, grad norms and each leaf's gradient within
        ``TM_*``'s limits of the one-device run's of ``refs``, or within
        ``TM_NOISE`` times the two-microbatch run's move of the same
        figure, both runs of the same loss."""
        (ref, _), (mb_logs, _) = refs
        by_max = sorted(errs.items(), key=lambda kv: -kv[1][0][0])[:3]
        by_l2 = sorted(errs.items(), key=lambda kv: -kv[1][0][1])[:3]
        moves = [(abs(x[0] - r[0]) / abs(r[0]), abs(x[1] - r[1]) / abs(r[1]))
                 for x, r in zip(logs, ref)]
        say(f"{label}: losses {[x[0] for x in logs]} against "
            f"{[x[0] for x in ref]}, grad norms {[x[1] for x in logs]} "
            f"against {[x[1] for x in ref]} (relative errors {moves}); each "
            f"leaf's gradient after step 1 against one device's (of its max "
            f"|g|, in L2) beside 2 microbatches' move: the worst of its max "
            f"{by_max}, the worst in L2 {by_l2}; ms a step "
            f"{[round(x[2], 1) for x in logs]} [{card}]")
        bad = [p for p, ((d_max, d_l2), (f_max, f_l2)) in errs.items()
               if d_max > max(TM_GRAD_MAX, TM_NOISE * f_max)
               or d_l2 > max(TM_GRAD_L2, TM_NOISE * f_l2)]
        check(not bad, f"{label}: {len(bad)} leaves' gradients past the "
              f"limits: {bad[:5]}")
        for i, ((d_loss, d_gn), x, r) in enumerate(zip(moves, mb_logs,
                                                        ref)):
            f_loss, f_gn = (abs(x[0] - r[0]) / abs(r[0]),
                            abs(x[1] - r[1]) / abs(r[1]))
            check(d_loss <= max(TM_LOSS_REL, TM_NOISE * f_loss)
                  and d_gn <= max(TM_GNORM_REL, TM_NOISE * f_gn),
                  f"{label} step {i}: loss and grad norm off by {d_loss} "
                  f"and {d_gn} of one device's")

    def start(mesh, tcr, key, **kw):
        # the peak is the steps': init_train_state draws the whole state
        # on every rank before it keeps the slices
        state = init_train_state(model, tcr, 0, dev, mesh=mesh)
        step = make_train_step(model, tcr, mesh=mesh, **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gathered[key] = step.gathered
        return state, step

    # (1, 4) and (2, 2), fused_ce: the split step within the limits of one
    # device's; each rank's CE kernels at its V / model rows held to their
    # plain versions; at (2, 2) a second step, its all-reduces timed apart,
    # and each model slice the same bits on both data replicas
    fp_2x2 = by = None
    for shape in ((1, TM_RANKS), (2, TM_RANKS // 2)):
        key = f"{shape[0]}x{shape[1]}"
        mesh = make_mesh_2d(shape, "cuda")
        places = dict(tree_paths(params_placements(model, mesh)))
        state, step = start(mesh, tc, key)
        state, logs, got = mesh_train_steps(
            torch, kernels, step, state, batches[:1],
            f"train mesh (b) {shape}", card)
        add(got)
        errs = grad_errors(state, places, fused)
        if shape[0] > 1:
            (state, logs2, got), by = timed_collectives(
                torch, lambda: mesh_train_steps(
                    torch, kernels, step, state, batches[1:],
                    f"train mesh (b) {shape}", card, 1))
            add(got)
            logs += logs2
            fp_2x2 = state_fingerprints(torch, state)
        peaks[key] = torch.cuda.max_memory_allocated() / 1e9
        if rank == 0:
            held_to(f"train mesh (b) {shape}", logs, fused, errs)
        rows = shard_tree(batches[0], batch_shardings(mesh, batches[0],
                                                      TM_B))
        held[key] = hold_ce_shard(torch, model, state.params, rows,
                                  axis_group(mesh, "model"))
        del state, step
    say(f"train mesh (b) (2, 2): the second step's all-reduces, each "
        f"synchronised: {by} (dtype: calls, elements, ms) [{card}]")

    # (2, 2), mimps_ce: the hidden states gathered over 'data', one plan
    # over the whole batch, within the limits of one device's step on it
    # (or of twice its move with the replicas' rows as two microbatches)
    state, step = start(mesh, tc_est, "mimps_ce 2x2")
    state, logs, got = mesh_train_steps(
        torch, kernels, step, state, batches[:1],
        "train mesh (b) (2, 2) mimps_ce", card, per=0)
    errs = grad_errors(state, places, est)
    peaks["mimps_ce 2x2"] = torch.cuda.max_memory_allocated() / 1e9
    if rank == 0:
        held_to("train mesh (b) (2, 2) mimps_ce", logs, est, errs)
    del state, step

    # (2, 2), pod_axis="data", int8: finite, the same state on every rank
    tc8 = dataclasses.replace(tc, grad_compression="int8")
    state, step = start(mesh, tc8, "int8 2x2", pod_axis="data")
    int32, real_cp, real_ar = [], train_loop.compress_psum, dist.all_reduce

    def counting(t, *args, **kwargs):
        if t.dtype == torch.int32:
            int32.append(t.numel())
        return real_ar(t, *args, **kwargs)

    def compress(grads, group, mode, amax_group=None):
        dist.all_reduce = counting
        try:
            return real_cp(grads, group, mode, amax_group)
        finally:
            dist.all_reduce = real_ar
    train_loop.compress_psum = compress
    try:
        state, logs, got = mesh_train_steps(
            torch, kernels, step, state, batches[:1],
            "train mesh (b) (2, 2) int8 over data", card)
    finally:
        train_loop.compress_psum = real_cp
    add(got)
    n_leaves = len(list(tree_paths(state.params)))
    check(len(int32) == n_leaves, f"train mesh (b) int8: {len(int32)} int32 "
          f"all-reduces in the compressor for {n_leaves} leaves")
    int8_fp = state_fingerprints(torch, state)
    say(f"train mesh (b) (2, 2) int8 over data: loss {logs[0][0]!r}, grad "
        f"norm {logs[0][1]!r}, {len(int32)} int32 all-reduces "
        f"({sum(int32)} elements), {logs[0][2]:.1f} ms [{card}]")
    del state, step
    res = {"rank": rank, "counts": counts, "fp_2x2": fp_2x2,
           "int8_fp": int8_fp, "peaks_gb": peaks, "whole_gb": whole_gb,
           "gathered": gathered, "held": held,
           "seconds": time.time() - t_start}
    dist.destroy_process_group()
    Path(f"{out}/train_rank{rank}.json").write_text(json.dumps(res))
    return 0


def hold_ce_shard(torch, model, params, batch, group):
    """A rank's CE pair at its vocab rows, on the split forward's hidden
    states of its rows of the batch: ``fused_ce_fwd`` with the labels
    shifted to the shard held to ``fused_ce_fwd_plain`` (``TOL``), its
    LSEs combined over ``group``,
    then ``fused_ce_bwd`` with that lse held to ``fused_ce_bwd_plain``
    (``compare_terms``), both on the same inputs. Every rank of ``group``
    calls it. Returns the shapes and errors."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.distributed import logspace_psum, split_compute
    from repro_torch.kernels.fused_ce import (ce_coef, fused_ce_bwd,
                                             fused_ce_bwd_plain, fused_ce_fwd,
                                             fused_ce_fwd_plain)
    import torch.distributed as dist
    with split_compute(group), torch.no_grad():
        hidden, _ = model.forward(params, batch["tokens"])
    h = hidden.reshape(-1, hidden.shape[-1])
    w = model.head_matrix(params).detach()
    n = w.shape[0]
    lab = (batch["labels"].reshape(-1).long()
           - dist.get_rank(group) * n).to(torch.int32)
    mine = (lab >= 0) & (lab < n)
    nll, lse_l = fused_ce_fwd(h, w, lab)
    p_nll, p_lse = fused_ce_fwd_plain(h, w, lab)
    f_err = max((lse_l - p_lse).abs().max().item(),
                (nll - p_nll)[mine].abs().max().item() if mine.any()
                else 0.0)
    check(f_err <= TOL, f"fused_ce_fwd at {n} rows: nll/lse differ by "
          f"{f_err}")
    del p_nll, p_lse
    lse = logspace_psum(lse_l, group)
    t = h.shape[0]
    g_nll = torch.full((t,), 1.0 / t, device=h.device)
    g_lse = 2 * TrainConfig().selfnorm_alpha * lse / t
    bargs = (h, w, lab, lse, g_nll, g_lse)
    dh, dw = fused_ce_bwd(*bargs, cast=False)
    p_dh, p_dw = fused_ce_bwd_plain(*bargs, cast=False)
    coef = ce_coef(*bargs).abs()
    dh_err = compare_terms(f"fused_ce_bwd dh at {n} rows", dh, p_dh,
                           coef @ w.float().abs())
    dw_err = compare_terms(f"fused_ce_bwd dw at {n} rows", dw, p_dw,
                           coef.T @ h.float().abs())
    del coef, dh, dw, p_dh, p_dw
    torch.cuda.empty_cache()
    return {"t": t, "rows": n, "labels_on_shard": int(mine.sum()),
            "fwd_err": f_err, "dh_err": dh_err, "dw_err": dw_err}


def train_cli(torch, card, tmp):
    """(c): ``launch/train.py`` on the card, reduced: 3 steps with a
    checkpoint at 2, then a run from that checkpoint alone; the two final
    checkpoints must hold the same bits."""
    import os

    import numpy as np
    runs = {}
    flags = ["--reduced", "--steps", "3", "--ckpt-every", "2",
             "--harvest-every", "1"]
    for name in ("a", "b"):
        d = Path(tmp) / f"cli_{name}"
        if name == "b":
            shutil.copytree(Path(tmp) / "cli_a" / "step_0000000002",
                            d / "step_0000000002")
        t0 = time.time()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *flags,
             "--ckpt-dir", str(d)], cwd=ROOT, capture_output=True,
            text=True, timeout=TM_CLI_TIMEOUT_S,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        check(p.returncode == 0, f"train mesh (c): the CLI run {name} exited "
              f"{p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
        runs[name] = (time.time() - t0, p.stdout)
    check("resumed from step 2" in runs["b"][1], "train mesh (c): the "
          "second run did not resume from step 2")
    arrays = []
    for name in ("a", "b"):
        with np.load(Path(tmp) / f"cli_{name}" / "step_0000000003" /
                     "arrays.npz") as data:
            arrays.append({k: data[k] for k in data.files})
    check(arrays[0].keys() == arrays[1].keys() and all(
        np.array_equal(arrays[0][k].reshape(-1).view(np.uint8),
                       arrays[1][k].reshape(-1).view(np.uint8))
        for k in arrays[0]), "train mesh (c): the resumed run's final "
          "checkpoint differs from the uninterrupted run's")
    for line in runs["a"][1].splitlines():
        log(f"  cli: {line}")
    log(f"train mesh (c): the train CLI (reduced, cuda) 3 steps in "
        f"{runs['a'][0]:.1f} s, resumed from step 2 in {runs['b'][0]:.1f} "
        f"s; {len(arrays[0])} arrays of the final checkpoints bit-equal "
        f"[{card}]")


# -- phase 14: the serving entry point and the autotuner --------------------

CLI_LANES = 16                    # (a): the sweeps' batch, the traffic lanes
CLI_NEW = 32                      # (c): new tokens of the 8-lane generate
CLI_MAX_LEN = PROMPT + CLI_NEW
CLI_TIMEOUT_S = 300               # (d): the CLI's run
CLI_ARGS = ("--arch", "qwen1.5-4b", "--method", "mimps", "--slots", "16",
            "--requests", "32", "--gen", "16", "--sequential")
TIER_KERNELS = {"exact": "topk_z", "topk": "union_scores",
                "fmbe": "fmbe_z", "lsh": "lsh_probe"}


def serve_cli_last(torch, card, kernels):
    """Phase 14, last: the kernel autotuner and the serving entry point on
    full-width qwen1.5-4b (bf16, 40 layers, ``_MIMPS``: 553 blocks), with a
    cold autotune cache of its own (``REPRO_TORCH_AUTOTUNE_CACHE`` under a
    temporary directory).

    (a) ``Engine(autotune=True, autotune_batch=16)`` at mimps (the sweeps
        of ``ivf_decode`` at 8 and 16 queries, one a query-tile count),
        then ``tune`` of the engine's exact, topk, fmbe and lsh tier states
        on the same seeded batch's first 8 and 16 rows (``topk_z``,
        ``union_scores``, ``fmbe_z``, ``lsh_probe``): every candidate's
        burst time, each winner's ten-call graph time beside the default
        launch's, and each winner's call at its sweep's operands held to
        its plain version (``hold_call``). The sweeps' launches are timing
        launches: logged apart, not the path's.
    (b) A second autotuned engine (the k-means assignment injected) reads
        the cache: no sweep, the same ``kernel_cfg``, the read's seconds.
    (c) ``generate`` of 8 lanes, 32 new tokens, T 0 on the tuned engine
        (captured = host loop bit for bit, ``served_pair``) and on an
        untuned engine of the same index: the same tokens; log Z's largest
        difference logged (a grid splits the partials otherwise). Then the
        captured step of each engine at 8 and at 16 lanes replayed in
        turns (tuned, default, tuned, default): device ms a step.
    (d) ``python -m repro_torch.launch.serve`` with ``CLI_ARGS`` and a
        trace and snapshot in a subprocess: exit 0, every request
        completed, goodput, sequential tokens/s and the count of requests
        whose sequential tokens equal the slot table's (C9: logged, not
        held); the trace's ``device_step`` spans: the first step's (the
        step's capture) apart from the median of the rest; the port's
        ``obs_report`` exits 0 on the trace.
    Returns (launches by kernel, gated ``topk_z`` launches, the held max
    abs err by record name) of (c)."""
    import os
    import re
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import autotune as at
    from repro_torch.launch import obs_report
    from repro_torch.models import Model
    from repro_torch.models.transformer import torch_dtype
    from repro_torch.serve import Engine
    from repro_torch.serve import engine as engine_mod

    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    pc = cfg.partition
    counted = PathCounts(torch, kernels)
    sweeps = PathCounts(torch, kernels)
    held = {}
    tmp = Path(tempfile.mkdtemp(prefix="serve_cli_"))
    saved_env = os.environ.get(at.ENV)
    os.environ[at.ENV] = str(tmp / "autotune.json")
    try:
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dev)
        qs = [min(CLI_LANES, t * at.QUERY_TILE)
              for t in range(1, at.query_tiles(CLI_LANES) + 1)]

        # (a) the sweeps
        def tuned_build():
            t0 = time.time()
            eng = Engine(Model(cfg), params, CLI_MAX_LEN, seed=1,
                         autotune=True, autotune_batch=CLI_LANES)
            torch.cuda.synchronize()
            build_s = time.time() - t0
            # the engine's own tuning batch; its sweeps read back from the
            # cache (a hit: the build swept them), then each tier's
            gen = torch.Generator(device=dev).manual_seed(eng.seed + 0xA07)
            h = (0.1 * torch.randn((CLI_LANES, cfg.d_model), generator=gen,
                                   device=dev)).to(torch_dtype(cfg.dtype))
            recs, tiers = [], {}
            for q in qs:
                eng.backend.tune(eng.state, pc, h[:q], generator=gen)
                recs.append(("ivf_decode", q, dict(at.LAST["ivf_decode"])))
            for m, name in TIER_KERNELS.items():
                for q in qs:
                    tiers[(m, q)] = get_backend(m).tune(
                        eng.tier_state(m), pc, h[:q], generator=gen)
                    recs.append((name, q, dict(at.LAST[name])))
            torch.cuda.synchronize()
            return eng, recs, tiers, build_s

        (eng, recs, tiers, build_s), sweep_counts, _ = sweeps(tuned_build)
        want = {t + 1: eng.kernel_cfg.get(t + 1) for t in range(len(qs))}
        check(all(want.values()) and set(eng.kernel_cfg) == set(want),
              f"serve_cli (a): the mimps engine's kernel_cfg "
              f"{eng.kernel_cfg}, want one a query-tile count of {qs}")
        log(f"serve_cli (a): Engine(autotune=True, autotune_batch="
            f"{CLI_LANES}) built in {build_s:.1f} s, kernel_cfg by query "
            f"tiles {eng.kernel_cfg}; tiers' tune by (tier, Q) {tiers}; "
            f"the sweeps' timing launches (not the path's) {sweep_counts} "
            f"[{card}]")
        for name, q, rec in recs:
            check(rec["hit"] == (name == "ivf_decode") and
                  rec["ms"] is not None,
                  f"serve_cli (a): {name} at Q {q} did not sweep where "
                  f"it should: {rec}")
            sweep = "; ".join(
                f"{c['config']} " + (f"{c['ms']:.4f}" if "ms" in c
                                     else c["error"])
                for c in rec["swept"])
            check(all("ms" in c for c in rec["swept"]),
                  f"serve_cli (a): {name} at Q {q}: a candidate failed: "
                  f"{sweep}")
            real, args, kw = rec["call"]
            win = rec["config"]
            ten = graph10_ms(torch, lambda: real(*args, **kw, **win))
            ten_dflt = graph10_ms(torch, lambda: real(*args, **kw))
            key, err, note = hold_call(torch, f"serve_cli (a) {name}", name,
                                       real, args, dict(kw, **win))
            held[key] = max(held.get(key, 0.0), err)
            log(f"autotune {name} Q {q}: {len(rec['swept'])} candidates "
                f"(ms a call, burst of {at.BURST}): {sweep}; winner {win} "
                f"at {rec['ms']:.4f}; ten-call graph {ten:.4f} ms against "
                f"the default launch's {ten_dflt:.4f} "
                f"({ten / ten_dflt:.3f}x); held: {note} [{card}]")

        # (b) the cache read
        t0 = time.time()
        eng2 = Engine(Model(cfg), params, CLI_MAX_LEN, seed=1, autotune=True,
                      autotune_batch=CLI_LANES, index_assign=eng.index.assign)
        torch.cuda.synchronize()
        rec = at.LAST["ivf_decode"]
        check(rec["hit"] and eng2.kernel_cfg == eng.kernel_cfg,
              f"serve_cli (b): the second engine swept again or tuned "
              f"otherwise: {eng2.kernel_cfg} against {eng.kernel_cfg}")
        log(f"serve_cli (b): a second autotuned engine read the cache in "
            f"{rec['seconds'] * 1e3:.2f} ms (the last of its "
            f"{len(qs)} reads; engine build {time.time() - t0:.1f} s, "
            f"k-means assignment injected) [{card}]")
        del eng2

        # (c) tuned and default tokens, then the captured steps' replays
        plain = Engine(Model(cfg), params, CLI_MAX_LEN, seed=1,
                       index_assign=eng.index.assign)
        gen = torch.Generator(device=dev).manual_seed(4)
        prompt = torch.randint(0, cfg.vocab, (CLI_LANES, PROMPT),
                               generator=gen, device=dev)
        got = {}
        engines = (("tuned", eng), ("default", plain))
        for label, e in engines:
            (out, aux, s), _ = served_pair(
                torch, e, prompt[:N_REQ], CLI_NEW, f"serve_cli (c) {label}",
                wrap=lambda fn: counted(fn)[0])
            got[label] = (out, aux)
            log(f"serve_cli (c) {label}: generate {N_REQ} lanes x {CLI_NEW} "
                f"new tokens at T 0, captured bit-equal to the host loop, "
                f"{N_REQ * CLI_NEW / s:.1f} tokens/s (wall, the capture "
                f"included) [{card}]")
        check(torch.equal(got["tuned"][0], got["default"][0]),
              "serve_cli (c): the tuned engine's tokens differ from the "
              "default engine's")
        dz = (got["tuned"][1]["log_z"] -
              got["default"][1]["log_z"]).abs().max().item()
        log(f"serve_cli (c): tuned tokens = default tokens; log Z's largest "
            f"difference {dz:.3e} [{card}]")
        for lanes in (N_REQ, CLI_LANES):
            runs = {}
            for label, e in engines:
                run = engine_mod._graph_runner(e, lanes, None)
                if run.graph is None:
                    run.capture(e)
                runs[label] = run
            ms = {label: [] for label, _ in engines}
            for label in ("tuned", "default", "tuned", "default"):
                ms[label].append(replay_ms(torch, runs[label],
                                           prompt[:lanes]))
            t, d = min(ms["tuned"]), min(ms["default"])
            log(f"serve_cli (c) step at {lanes} lanes (knobs "
                f"{eng.knobs(lanes)}): captured replay tuned "
                f"{ms['tuned'][0]:.4f}, {ms['tuned'][1]:.4f} ms, default "
                f"{ms['default'][0]:.4f}, {ms['default'][1]:.4f} ms "
                f"(tuned/default {t / d:.4f}, best of two each) [{card}]")
        del eng, plain, params, got, runs
        at.LAST.clear()                         # the sweeps' operands
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the CLI
        trace, snap = tmp / "trace.jsonl", tmp / "snap.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *CLI_ARGS,
               "--trace-out", str(trace), "--metrics-snapshot", str(snap)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.time()
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=CLI_TIMEOUT_S)
        cli_s = time.time() - t0
        for line in res.stdout.splitlines():
            log(f"  serve CLI | {line}")
        check(res.returncode == 0, f"serve_cli (d): exit {res.returncode}:"
              f" {res.stderr[-2000:]}")
        n_req = re.search(r"continuous: (\d+) requests", res.stdout)
        good = re.search(r"([\d.]+) tok/s goodput", res.stdout)
        seq = re.search(r"sequential: \d+ tokens in [\d.]+s \(([\d.]+) "
                        r"tok/s\).*for (\d+)/(\d+) requests", res.stdout)
        check(n_req and int(n_req.group(1)) == 32 and good and seq,
              "serve_cli (d): the report lines are missing")
        check("robustness" not in res.stdout, "serve_cli (d): a request "
              "was shed or evicted")
        spans = []
        for line in trace.read_text().splitlines():
            e = json.loads(line)
            if e.get("ph") == "X" and e["name"].startswith("device_step:"):
                spans.append((e["ts"], e["dur"] / 1e3))
        spans = [ms for _, ms in sorted(spans)]
        check(len(spans) >= 2, f"serve_cli (d): {len(spans)} device_step "
              f"spans in the trace")
        rc = obs_report.main([str(trace), "--snapshot", str(snap)])
        check(rc == 0, f"serve_cli (d): obs_report exit {rc}")
        log(f"serve_cli (d): the CLI in {cli_s:.1f} s: 32 requests done, "
            f"goodput {good.group(1)} tok/s, sequential {seq.group(1)} "
            f"tok/s, sequential tokens equal to the slot table's for "
            f"{seq.group(2)}/{seq.group(3)} requests (C9: logged, not "
            f"held); device_step spans (host clock, dispatch to read-back): "
            f"{len(spans)}, mean {statistics.mean(spans):.2f} ms, the first "
            f"(the step's capture) {spans[0]:.2f} ms, the rest mean "
            f"{statistics.mean(spans[1:]):.2f} median "
            f"{statistics.median(spans[1:]):.2f} max {max(spans[1:]):.2f} "
            f"ms; obs_report exit 0 [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop(at.ENV, None)
        else:
            os.environ[at.ENV] = saved_env
        shutil.rmtree(tmp, ignore_errors=True)
    path, n_gated = counted.totals()
    log(f"serve_cli path launches {path}, gated topk_z {n_gated}; held max "
        f"abs err {held}")
    return path, n_gated, held


def vlm_last(torch, card, kernels):
    """Phase 12, last: llama-3.2-vision-90b at its published widths (d
    8192, 64 heads over 8 KV heads, d_ff 28672, vocab 128256, 1601 image
    tokens; bf16, random weights from seed 0) with its depth cut from 100
    to ``V_LAYERS`` layers, whole groups (the one cut: 100 layers are 175
    GB), behind a mimps engine at the config's partition (k 1000, l 1000,
    n_probe 16, blocks of 512 at fixed capacity) with the guard:

    1. The live CUDA tensors of 64 MB or more and the memory allocated
       before the init; the parameter count against the JAX package's,
       peak memory after the init and after the index build (with the
       card's free memory), the trunk's weight bytes and their read time.
    2. The image (8, 1601, 8192) bf16, standard normal from a seeded
       generator. The captured ``generate`` (8 requests, prompt 16, 32
       new) at temperature 0 and 1.0 on one captured step, each bit-equal
       to the host loop, ``ivf_decode`` and the gated ``topk_z`` once a
       step; a second image through the same runner gives other tokens
       with no capture again. ms a step, tokens/s, the replay's device ms,
       its profile and the trunk by kind ("cross kv": the image's K and V
       products, projected again every step as in the JAX package;
       "cross attention").
    3. On the hidden states of ``Engine.prefill`` with the image: the
       mimps log Ẑ within 0.05 of the exact log Z (``topk_z`` over the
       head at d 8192); ``topk_z`` and ``ivf_decode`` against their plain
       versions and timed at these shapes (records ``topk_z[d8192]`` and
       ``ivf_decode[d8192]``); the ring geometry of ``ivf_decode`` and
       ``union_scores`` at d 8192 (two stages or more).
    4. One eager step: every ``ivf_decode`` and gated ``topk_z`` call made
       again and held to its plain version, the gated call also with every
       lane flagged.

    Returns the path's launches, the gated ``topk_z``'s, the held calls'
    max abs err by record name and the two records (their launches: the
    path's ``ivf_decode`` and all its ``topk_z``, which the guard gates)."""
    from repro_torch.configs import get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import stream_geometry
    from repro_torch.kernels.topk_z import topk_z
    from repro_torch.models import Model
    from repro_torch.serve import Engine, ServeState

    dev = torch.device("cuda")
    t_phase = time.time()
    counted = PathCounts(torch, kernels)
    full = get_config(V_ARCH)
    cfg = dataclasses.replace(full, n_layers=V_LAYERS)
    pc = cfg.partition
    tag = "vlm"
    # -- 1. memory, model and engine ----------------------------------------
    big = live_cuda_tensors(torch, 64 << 20)
    left = torch.cuda.memory_allocated() / 1e9
    log(f"{tag}: {left:.3f} GB allocated before the init; live CUDA tensors "
        f"of 64 MB or more: "
        + ("; ".join(f"{tuple(sh)} {dt} {n / 1e9:.3f} GB"
                     for sh, dt, n in big) or "none") + f" [{card}]")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == V_PARAMS, f"{tag}: {n_params} params, the JAX "
          f"package's eval_shape counts {V_PARAMS}")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    t_bytes = trunk_bytes(params, cfg)
    read_ms = t_bytes / HBM_BYTES_PER_S * 1e3
    groups = cfg.n_layers // cfg.cross_attn_every
    log(f"{tag}: {cfg.name} family {cfg.family}, depth cut from "
        f"{full.n_layers} to {cfg.n_layers} layers ({groups} groups of "
        f"{cfg.cross_attn_every - 1} self + 1 cross; the one cut), d "
        f"{cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.n_image_tokens} image tokens, {cfg.dtype}: "
        f"{n_params / 1e9:.3f} B params, {n_bytes / 1e9:.3f} GB, init "
        f"{init_s:.1f} s; peak {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB after it; a step reads {t_bytes / 1e9:.3f} GB of trunk "
        f"weights, {read_ms:.3f} ms at the memory rate [{card}]")
    t0 = time.time()
    eng = Engine(model, params, PROMPT + V_NEW, seed=7, device_index=True,
                 health_guard=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    index = eng.index
    free, total = torch.cuda.mem_get_info()
    peak_reserved = torch.cuda.max_memory_reserved()
    log(f"{tag} engine: {pc.method}, {index.n_blocks} blocks of "
        f"{index.block_rows} rows (fixed capacity), built in {build_s:.2f} "
        f"s; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
        f"allocated ({peak_reserved / 1e9:.3f} GB reserved) after it, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"now; the card {total / 1e9:.3f} GB, free now {free / 1e9:.3f} "
        f"GB, at the peak {(total - peak_reserved) / 1e9:.3f} GB less what "
        f"the allocator does not hold [{card}]")
    # -- 2. the captured generate with the image -----------------------------
    gen = torch.Generator(device=dev).manual_seed(2)

    def image():
        return torch.randn((N_REQ, cfg.n_image_tokens, cfg.d_model),
                           generator=gen, device=dev).to(torch.bfloat16)
    img = image()
    prompt = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                           device=dev)
    steps = PROMPT + V_NEW - 1
    run, cap_s = capture_runner(torch, eng)
    box = {}

    def wrap(fn):
        res, box["counts"], box["gated"] = counted(fn)
        return res
    toks = {}
    for temp, im, what in ((0.0, img, "T 0"), (1.0, img, "T 1.0"),
                           (0.0, image(), "T 0, a second image")):
        (out, aux, secs), (_, _, h_secs) = served_pair(
            torch, eng, prompt, V_NEW, f"{tag} generate {what}",
            temperature=temp, wrap=wrap, img=im)
        check(all(bool(torch.isfinite(aux[k]).all()) for k in aux),
              f"{tag} generate {what}: log_prob or log_z not finite")
        counts, n_g = box["counts"], box["gated"]
        check(counts["ivf_decode"] == steps and n_g == steps, f"{tag} "
              f"generate {what}: {counts['ivf_decode']} ivf_decode and {n_g} "
              f"gated topk_z in {steps} steps, want one of each a step")
        check(eng.captures == 1, f"{tag} generate {what}: {eng.captures} "
              f"captures, want 1")
        toks[what] = out
        log(f"{tag} generate {what}: {N_REQ} requests, prompt {PROMPT}, "
            f"{V_NEW} new: captured {secs / steps * 1e3:.3f} ms/step "
            f"({N_REQ * V_NEW / secs:.1f} new tokens/s; capture {cap_s:.2f} "
            f"s), host loop {h_secs / steps * 1e3:.3f} ms/step "
            f"({N_REQ * V_NEW / h_secs:.1f} tokens/s), bit-equal (tokens, "
            f"log_prob, log_z); one capture; launches ivf_decode "
            f"{counts['ivf_decode']}, gated topk_z {n_g} [{card}]")
    check(not torch.equal(toks["T 0"], toks["T 0, a second image"]),
          f"{tag}: the second image gave the first image's tokens")
    run.load(prompt, None if run.tails is None else run.tails[:1],
             run.gumbel[:1], 0.0, img)
    replay = replay_ms(torch, run, prompt)
    n_kern = step_breakdown(torch, run, eng, params, prompt[:, 0],
                            torch.zeros((), dtype=torch.int32, device=dev),
                            card, tag, img=img)
    log(f"{tag} step: replay {replay:.3f} ms device, {n_kern} kernels, "
        f"against the trunk's weight read {read_ms:.3f} ms; the second "
        f"image's tokens differ from the first's in "
        f"{int((toks['T 0'] != toks['T 0, a second image']).sum())} of "
        f"{toks['T 0'].numel()} [{card}]")
    del run
    eng._graph_runners = {}
    # -- 3. accuracy, the kernels at d 8192 and their geometry ---------------
    h, _ = eng.prefill(prompt, img=img)
    h = h.clone()
    w, k = eng.state.w, pc.sample_k
    tail_idx = torch.randint(0, cfg.vocab, (pc.l,), generator=gen,
                             device=dev)
    mi = eng.backend.decode(eng.state, h, pc, k=k, tail_idx=tail_idx)
    exact_lz = topk_z(h, w, k)[0]
    gap = (mi.log_z - exact_lz).abs().max().item()
    check(bool(torch.isfinite(mi.log_z).all()) and gap < 0.05,
          f"{tag}: mimps log Z off the exact log Z by {gap}")
    log(f"{tag} accuracy: on the prefill's {N_REQ} hidden states (|h|_2 "
        f"mean {h.float().norm(dim=-1).mean().item():.2f}), mimps log Z "
        f"within {gap:.4f} of the exact log Z (limit 0.05); exact log Z "
        f"{[round(x, 3) for x in exact_lz.tolist()]} [{card}]")
    plan = make_plan(index, h, pc.n_probe, pc.l, generator=gen)
    records = [topk_z_phase(torch, card, h, w, k, tag="[d8192]"),
               ivf_decode_phase(torch, card, index, h, plan, pc, k,
                                tag="[d8192]")]
    geo = {name: stream_geometry(name, cfg.d_model, torch.bfloat16,
                                 u=plan.head_ids.shape[0], l=pc.l,
                                 grid_x=_build.stream_grid(dev))
           for name in ("ivf_decode", "union_scores")}
    for name, g in geo.items():
        check(g["stages"] >= 2, f"{tag}: {name}'s ring at d {cfg.d_model} "
              f"holds {g['stages']} stages")
    log(f"{tag} ring geometry at d {cfg.d_model} bf16: " + "; ".join(
        f"{name} {g['rows']} rows x {g['stages']} stages of pitch "
        f"{g['pitch']} B, {g['smem']} B of shared memory"
        for name, g in geo.items()) + f" [{card}]")
    # -- 4. one eager step's kernel calls held to their plain versions ------
    temp = torch.zeros((), dtype=torch.float32, device=dev)
    gumbel = torch.zeros((N_REQ, k), device=dev)
    state = ServeState(cache=model.init_decode_state(N_REQ, eng.max_len,
                                                     dev),
                       pos=torch.zeros((), dtype=torch.int32, device=dev),
                       last_token=prompt[:, 0])
    for t in range(5):
        state = dataclasses.replace(state, last_token=prompt[:, t])
        tail = eng.backend.draw_tail(eng.state, pc, gen)
        step = functools.partial(eng.decode_step, state, temp, tail_idx=tail,
                                 gumbel=gumbel, img=img)
        if t < 4:
            _, state = step()
    _, calls = recorded_calls(step)
    held, notes = hold_calls(torch, f"{tag} held step", calls)
    gated = [c for c in calls if c[0] == "topk_z" and
             c[3].get("rows") is not None]
    check(len(gated) == 1 and "ivf_decode" in held, f"{tag} held step: "
          f"calls {[c[0] for c in calls]}")
    name, real, args, kwargs = gated[0]
    key, err, note = hold_call(
        torch, f"{tag} held step, every lane flagged", name, real, args,
        dict(kwargs, rows=torch.ones_like(kwargs["rows"])))
    held[key] = max(held[key], err)
    log(f"{tag} held step (position 4, {N_REQ} lanes): each kernel call "
        f"made again and held to its plain version: " + "; ".join(notes)
        + f"; the gated call with every lane flagged: {note} [{card}]")
    del step, state, calls, gated, args, kwargs, real, eng, params, model
    path, n_gated = counted.totals()
    records[0]["launches"] = path["topk_z"] + n_gated
    records[1]["launches"] = path["ivf_decode"]
    log(f"{tag} path launches {path}, gated topk_z {n_gated}; held max abs "
        f"err {held}; phase {time.time() - t_phase:.1f} s [{card}]")
    return path, n_gated, held, records


def topk_z_phase(torch, card, h, w, k, tag=""):
    """``topk_z`` against its plain version on hidden states h and the head
    w (both bf16 or both f32); times it beside its byte bound, the plain
    version and a library call, and logs its geometry (the bf16 ring held
    to the built kernel's). At the VLM's d 8192 it also times the kernel
    on the first rows of w that give every CTA the same number of boxes,
    to show what the ragged last wave costs. Returns the record, named
    with ``tag``."""
    from repro_torch.kernels.topk_z import (geometry, library_ring, topk_z,
                                            topk_z_plain)
    q, d, v = h.shape[0], h.shape[1], w.shape[0]
    es = h.element_size()
    lse, tv, ti = topk_z(h, w, k)
    torch.cuda.synchronize()
    p_lse, p_v, p_i = topk_z_plain(h, w, k + 1)
    err = compare_lse(f"topk_z{tag} lse", lse, p_lse)
    err_v, n_ids = compare_topk(f"topk_z{tag}", tv, ti, p_v, p_i)
    tz_bytes = v * d * es + q * d * es + q * 4 + q * k * 8
    tz_bound, tz_by = bound_ms(tz_bytes, 2 * q * v * d)
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    geo = geometry(q, v, d, h.dtype, sms)

    def library_topk_z():
        logits = torch.matmul(h, w.T)
        return torch.logsumexp(logits.float(), -1), torch.topk(logits, k)

    tz = dict(name=f"topk_z{tag}", route="cuda",
              source="src/repro_torch/kernels/csrc/topk_z.cu",
              replaces="src/repro/kernels/topk_z.py:82",
              max_abs_err=max(err, err_v),
              ms=time_ms(torch, lambda: topk_z(h, w, k)),
              plain_ms=time_ms(torch, lambda: topk_z_plain(h, w, k)),
              bound_ms=tz_bound, bound_by=tz_by,
              library_ms=time_ms(torch, library_topk_z),
              graph10_ms=graph10_ms(torch, lambda: topk_z(h, w, k)),
              geometry={key: val for key, val in geo.items()
                        if key != "ranges"})
    tz_eager = eager_ms(torch, lambda: topk_z(h, w, k))
    log(f"topk_z{tag}: Q {q} V {v} d {d} k {k} {h.dtype}: lse err "
        f"{err:.2e}, top-k err {err_v:.2e}, {n_ids} ids checked; kernel "
        f"{tz['ms']:.4f} ms (eager call {tz_eager:.4f} ms), plain "
        f"{tz['plain_ms']:.4f} ms, library {tz['library_ms']:.4f} ms, bound "
        f"{tz_bound:.4f} ms ({tz_by}, {tz_bytes / 1e6:.1f} MB) [{card}]")
    if not geo["tensor_cores"]:
        log(f"topk_z{tag} geometry: the CUDA-core kernel, {geo['tiles']} "
            f"tile(s) of {geo['n']} queries x {geo['grid_x']} CTAs")
        return tz
    ring = library_ring(geo["n"])
    check(ring == (geo["stages"], geo["stage_bytes"], geo["smem"]),
          f"topk_z{tag}: the built ring (stages, stage bytes, shared "
          f"memory) {ring} is not geometry's")
    sizes = [b1 - b0 for b0, b1 in geo["ranges"]]
    log(f"topk_z{tag} geometry: N {geo['n']}, {geo['tiles']} tile(s) x "
        f"{geo['grid_x']} CTAs over {geo['boxes']} boxes of "
        f"{geo['box_rows']} rows, {min(sizes)}-{max(sizes)} boxes a CTA (the "
        f"busiest {max(sizes) * geo['grid_x'] / geo['boxes']:.4f} of the "
        f"mean), {geo['stages_per_box']} stages a box; a ring of "
        f"{geo['stages']} stages of {geo['stage_bytes']} B, "
        f"{geo['in_flight']} B of W in flight an SM, {geo['smem']} B of "
        f"dynamic shared memory (the built kernel's) [{card}]")
    if min(sizes) < max(sizes):
        even = min(sizes) * geo["grid_x"] * geo["box_rows"]
        w_even = w[:even]
        even_ms = time_ms(torch, lambda: topk_z(h, w_even, k))
        tz["even_rows_ms"] = even_ms
        log(f"topk_z{tag} balance: the first {even} rows ({min(sizes)} boxes "
            f"every CTA) {even_ms:.4f} ms; all {v} rows {tz['ms']:.4f} ms "
            f"= {tz['ms'] / even_ms:.4f} of it, against {v / even:.4f} for "
            f"the bytes and {max(sizes) / min(sizes):.4f} for the busiest "
            f"CTA's boxes [{card}]")
    return tz


def ivf_decode_phase(torch, card, index, h, plan, pc, k, tag=""):
    """``ivf_decode`` against its plain version on the mimps plan of h, two
    calls bit-equal; times it as one call, as ten calls in one graph and
    with the L2 cache flushed before each call, beside its byte bound, the
    plain version and a composed library yardstick (``einsum`` over the
    gathered union blocks and the tail rows, masked ``logsumexp``,
    ``topk``). Returns the record, named with ``tag``."""
    from repro_torch.core.decode import _tail_rows
    from repro_torch.kernels.ivf_score import ivf_decode, ivf_decode_plain
    q, d = h.shape
    es = h.element_size()
    row_logw = torch.where(index.valid, 0.0, -1e30).float()
    tail_rows = _tail_rows(index, plan)
    args = (index.v_blocks, h, plan.head_ids, plan.head_live,
            plan.head_member, row_logw, tail_rows, plan.tail_accept)
    out = ivf_decode(*args, k=k)
    again = ivf_decode(*args, k=k)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"ivf_decode{tag}: two calls differ in their bits")
    hl, tl, iv, ii = out
    p_hl, p_tl, p_v, p_i = ivf_decode_plain(*args, k=k + 1)
    err = max(compare_lse(f"ivf_decode{tag} head_lse", hl, p_hl),
              compare_lse(f"ivf_decode{tag} tail_lse", tl, p_tl))
    err_v, n_ids = compare_topk(f"ivf_decode{tag}", iv, ii, p_v, p_i)
    live, cap = int(plan.head_live), plan.head_ids.shape[0]
    br, l = index.block_rows, pc.l
    iv_bytes = (live * br * d * es + l * d * es + q * d * es + cap * 4
                + q * cap + live * br * 4 + q * l + q * (8 + 8 * k))
    iv_bound, iv_by = bound_ms(iv_bytes, 2 * q * (live * br + l) * d)
    ids = plan.head_ids.long()
    keep = (plan.head_member & (torch.arange(cap, device=h.device)
                                < plan.head_live)[None, :])[:, :, None]

    def library_ivf_decode():
        s = torch.einsum("qd,ubd->qub", h, index.v_blocks[ids]).float()
        eff = torch.where(keep, s + row_logw[ids][None],
                          torch.full_like(s, -1e30)).reshape(q, -1)
        ts = torch.matmul(h, tail_rows.T).float()
        return (torch.logsumexp(eff, -1), torch.topk(eff, k),
                torch.logsumexp(torch.where(plan.tail_accept, ts,
                                            torch.full_like(ts, -1e30)), -1))

    call = lambda: ivf_decode(*args, k=k)                   # noqa: E731
    ivf = dict(name=f"ivf_decode{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/ivf_decode.cu",
               replaces="src/repro/kernels/ivf_score.py:226",
               max_abs_err=max(err, err_v),
               ms=time_ms(torch, call),
               plain_ms=time_ms(torch, lambda: ivf_decode_plain(*args, k=k)),
               bound_ms=iv_bound, bound_by=iv_by,
               library_ms=time_ms(torch, library_ivf_decode),
               library_call="einsum over w_blocks[head_ids] and the tail "
               "rows, masked logsumexp, topk",
               graph10_ms=graph10_ms(torch, call),
               l2_flushed_ms=flushed_ms(torch, call),
               by_kernel_ms=kernel_split(torch, call))
    iv_eager = eager_ms(torch, call)
    log(f"ivf_decode{tag}: Q {q} union {live} live of {cap} slots x {br} "
        f"rows, l {l}, {h.dtype}: lse err {err:.2e}, top-k err "
        f"{err_v:.2e}, {n_ids} ids checked, two calls bit-equal; kernel "
        f"{ivf['ms']:.4f} ms ({share(iv_bound, ivf['ms'])} of the bound; "
        f"ten calls in one graph {ivf['graph10_ms']:.4f} ms a call, L2 "
        f"flushed before each call {ivf['l2_flushed_ms']:.4f} ms, eager "
        f"call {iv_eager:.4f} ms), plain {ivf['plain_ms']:.4f} ms, library "
        f"yardstick {ivf['library_ms']:.4f} ms, bound {iv_bound:.4f} ms "
        f"({iv_by}, {iv_bytes / 1e6:.1f} MB); device ms a call by kernel "
        f"(torch.profiler) {ivf['by_kernel_ms']} [{card}]")
    return ivf


def union_scores_phase(torch, card, index, h, plan, tag=""):
    """``union_scores`` on the mimps plan's union (the topk/mince/fmbe
    head), two calls bit-equal. Its live blocks (about 60 MB in bf16) sit
    near the 50 MB L2 cache, so it is also timed with the cache flushed
    before each call; the record takes that time if the warm one reads
    faster than the byte bound. Returns the record, named with ``tag``."""
    from repro_torch.kernels.ivf_score import union_scores, union_scores_plain
    q, d = h.shape
    es = h.element_size()
    live, cap = int(plan.head_live), plan.head_ids.shape[0]
    br = index.block_rows
    uargs = (index.v_blocks, h, plan.head_ids, plan.head_live)
    us = union_scores(*uargs)
    us_again = union_scores(*uargs)
    torch.cuda.synchronize()
    check(torch.equal(us, us_again),
          f"union_scores{tag}: two calls differ in their bits")
    p_us = union_scores_plain(*uargs)
    check(us.shape == (q, cap, br), f"union_scores shape {tuple(us.shape)}")
    err = (us[:, :live] - p_us[:, :live]).abs().max().item()
    check(err <= TOL, f"union_scores{tag}: live slots differ by {err}")
    check(bool((us[:, live:] == 0).all()),
          f"union_scores{tag}: pad slots not 0")
    us_bytes = (live * br * d * es + q * d * es + cap * 4 + 4
                + q * cap * br * 4)
    us_bound, us_by = bound_ms(us_bytes, 2 * q * live * br * d)

    def library_union_scores():
        return torch.einsum("qd,ubd->qub", h, index.v_blocks[plan.head_ids])

    warm = time_ms(torch, lambda: union_scores(*uargs))
    cold = flushed_ms(torch, lambda: union_scores(*uargs))
    uni = dict(name=f"union_scores{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/union_scores.cu",
               replaces="src/repro/kernels/ivf_score.py:110",
               max_abs_err=err,
               ms=warm if warm >= us_bound else cold,
               plain_ms=time_ms(torch, lambda: union_scores_plain(*uargs)),
               bound_ms=us_bound, bound_by=us_by,
               library_ms=time_ms(torch, library_union_scores),
               graph10_ms=graph10_ms(torch, lambda: union_scores(*uargs)),
               warm_ms=warm, l2_flushed_ms=cold,
               ms_is_l2_flushed=warm < us_bound)
    us_eager = eager_ms(torch, lambda: union_scores(*uargs))
    log(f"union_scores{tag}: Q {q} union {live} live of {cap} slots x {br} "
        f"rows, {h.dtype}: live err {err:.2e}, pad slots 0, two calls "
        f"bit-equal; kernel {warm:.4f} ms ({share(us_bound, warm)} of the "
        f"byte bound, {us_bytes / warm / 1e6:.1f} GB/s; eager call "
        f"{us_eager:.4f} ms), L2 flushed before each call {cold:.4f} ms "
        f"({share(us_bound, cold)}, {us_bytes / cold / 1e6:.1f} GB/s; the "
        f"record takes the {'flushed' if uni['ms_is_l2_flushed'] else 'warm'}"
        f" time), plain {uni['plain_ms']:.4f} ms, library "
        f"{uni['library_ms']:.4f} ms, bound {us_bound:.4f} ms ({us_by}, "
        f"{us_bytes / 1e6:.1f} MB) [{card}]")
    return uni


def fmbe_z_phase(torch, card, fm, fstate, h, plan, deg_sum, tag=""):
    """``fmbe_z`` (the tensor-core kernel on the build's pack,
    ``FMBEState.pack``) on the decode's per-query complement lambda,
    against its plain version and the pack's decomposition (f32: its
    planes), two calls bit-equal; times it as one call, as ten calls in
    one graph and with the L2 cache flushed before each call, beside the
    byte bound of the pack it reads and that of the f32 omega rows the
    CUDA-core kernel read before, the plain version and a composed library
    yardstick (``torch.matmul(x, pack.rows.T)``, the feature products, a
    matvec with lambda). Returns the record, named with ``tag``."""
    from repro_torch.kernels.fmbe import (PACK_TILE, fmbe_phi_plain, fmbe_z,
                                          fmbe_z_pack_plain,
                                          fmbe_z_planes_plain, fmbe_z_plain)
    q, d = h.shape
    es = h.element_size()
    n_feat, max_deg, _ = fm.omega.shape
    pack = fstate.pack
    check(pack is not None, f"fmbe_z{tag}: the fmbe build kept no pack")
    lam_rest = (fstate.lambda_tilde[None, :] -
                fstate.lambda_blocks[plan.block_ids.long()].sum(1))
    lam_rest = lam_rest.contiguous()
    zargs = (fm.omega, fm.degree, fm.coef, lam_rest, h)
    call = lambda: fmbe_z(*zargs, pack=pack)                # noqa: E731
    z = call()
    z_again = call()
    torch.cuda.synchronize()
    check(torch.equal(z, z_again), f"fmbe_z{tag} is not bit-reproducible")
    check(bool(torch.isfinite(z).all()), f"fmbe_z{tag} not finite")
    terms = fmbe_phi_plain(fm.omega, fm.degree, fm.coef, h) * lam_rest
    err, ratio = compare_signed_sum(f"fmbe_z{tag}", z, fmbe_z_plain(*zargs),
                                    terms)
    decomposition = (fmbe_z_planes_plain if h.dtype == torch.float32
                     else fmbe_z_pack_plain)
    d_err, d_ratio = compare_signed_sum(
        f"fmbe_z{tag} against its decomposition", z,
        decomposition(pack, lam_rest, h), terms)
    n_cols = pack.rows.shape[0]
    side = q * n_feat * 4 + q * d * es + q * 4
    fz_bytes = (n_cols * d * 2 + n_feat * 12 + (n_cols // PACK_TILE + 1) * 4
                + side)
    planes = 3 if h.dtype == torch.float32 else 1
    fz_bound, fz_by = bound_ms(fz_bytes, 2 * q * n_cols * d * planes)
    omega_bytes = deg_sum * d * 4 + n_feat * 8 + side
    omega_bound, _ = bound_ms(omega_bytes, 2 * q * deg_sum * d)
    rows = pack.rows if h.dtype == torch.bfloat16 else pack.rows.float()
    m_idx = torch.arange(max_deg, device=h.device)[:, None]
    use = pack.degree[None, :] > m_idx                        # (M, P)
    col = torch.where(use, pack.start[None, :] + m_idx, 0).long()

    def library_fmbe_z():
        proj = torch.matmul(h, rows.T).float()
        factors = torch.where(use[None], proj[:, col], 1.0)   # (Q, M, P)
        return (factors.prod(1) * pack.coef * lam_rest).sum(-1)

    fz = dict(name=f"fmbe_z{tag}", route="cuda",
              source="src/repro_torch/kernels/csrc/fmbe_z.cu",
              replaces="src/repro/kernels/fmbe.py:121",
              max_abs_err=max(err, d_err), max_err_over_tol=max(ratio,
                                                                 d_ratio),
              ms=time_ms(torch, call),
              plain_ms=time_ms(torch, lambda: fmbe_z_plain(*zargs)),
              bound_ms=fz_bound, bound_by=fz_by,
              library_ms=time_ms(torch, library_fmbe_z),
              library_call="torch.matmul(x, pack.rows.T), the feature "
              "products, a matvec with lambda",
              graph10_ms=graph10_ms(torch, call),
              l2_flushed_ms=flushed_ms(torch, call),
              bound_f32_omega_ms=omega_bound, pack_columns=n_cols,
              by_kernel_ms=kernel_split(torch, call))
    fz_eager = eager_ms(torch, call)
    log(f"fmbe_z{tag}: Q {q} P {n_feat} max degree {max_deg} (sum of "
        f"degrees {deg_sum}), pack {n_cols} columns, per-query lambda, "
        f"{h.dtype}: max abs err {err:.3e} = {ratio:.4f} of the tolerance "
        f"(against the pack's decomposition {d_ratio:.4f}), |z| up to "
        f"{z.abs().max().item():.3e}, two calls bit-equal; kernel "
        f"{fz['ms']:.4f} ms ({share(fz_bound, fz['ms'])} of the pack's "
        f"bound; ten calls in one graph {fz['graph10_ms']:.4f} ms a call, "
        f"L2 flushed before each call {fz['l2_flushed_ms']:.4f} ms, eager "
        f"call {fz_eager:.4f} ms), plain {fz['plain_ms']:.4f} ms, library "
        f"yardstick {fz['library_ms']:.4f} ms, bound {fz_bound:.4f} ms "
        f"({fz_by}, the pack's {fz_bytes / 1e6:.1f} MB; the f32 omega "
        f"rows' {omega_bytes / 1e6:.1f} MB: {omega_bound:.4f} ms); device ms "
        f"a call by kernel (torch.profiler) {fz['by_kernel_ms']} [{card}]")
    return fz


def fmbe_phi_phase(torch, card, fm, index, fstate, deg_sum):
    """``fmbe_phi`` (bf16 rows: the tensor-core kernel) on one real build
    chunk of ``PHI_CHUNK_BLOCKS`` blocks against its plain version, bit-equal
    over two calls, and that chunk's ``lambda_blocks`` as the build made
    them; times it beside its operations bound, the plain version, the
    product alone as ``torch.matmul(x, pack.rows.T)`` (the mainloop's
    yardstick, ``library_ms``: it does not compute phi), the packing, the
    build's masked block sum over the chunk's phi and the whole sketch
    (``build_fmbe_blocks``). Returns the record."""
    from repro_torch.core.feature_maps import build_fmbe_blocks
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_pack, fmbe_phi, fmbe_phi_plain
    nbc = PHI_CHUNK_BLOCKS
    br, d = index.block_rows, index.v_blocks.shape[-1]
    x = index.v_blocks[:nbc].reshape(-1, d)
    rows = x.shape[0]
    n_feat = fm.omega.shape[0]
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    pargs = (fm.omega, fm.degree, fm.coef, x)
    phi = fmbe_phi(*pargs, pack=pack)
    again = fmbe_phi(*pargs, pack=pack)
    torch.cuda.synchronize()
    check(torch.equal(phi, again), "fmbe_phi is not bit-reproducible")
    del again
    p_phi = fmbe_phi_plain(*pargs)
    norm = x.float().norm(dim=-1).clamp(min=1.0)
    scale = fm.coef.abs()[None, :] * norm[:, None] ** fm.degree[None, :]
    perr = (phi - p_phi).abs()
    ptol = FMBE_REL * (p_phi.abs() + scale)
    p_ratio = (perr / ptol).max().item()
    check(p_ratio <= 1.0, f"fmbe_phi: error {perr.max().item():.3e} is "
          f"{p_ratio:.3f} of the tolerance")
    masked = p_phi.reshape(nbc, br, -1) * index.valid[:nbc, :, None]
    lerr, l_ratio = compare_signed_sum(
        "lambda_blocks", fstate.lambda_blocks[:nbc], masked.sum(1),
        masked.transpose(1, 2))
    del p_phi, masked
    fp_bytes = deg_sum * d * 2 + n_feat * 8 + rows * d * 2 + rows * n_feat * 4
    fp_bound, fp_by = bound_ms(fp_bytes, 2 * rows * deg_sum * d)
    n_cols = pack.rows.shape[0]
    fph = dict(name="fmbe_phi", route="cuda",
               source="src/repro_torch/kernels/csrc/fmbe_phi_wgmma.cu",
               replaces="src/repro/kernels/fmbe.py:89",
               max_abs_err=perr.max().item(), max_err_over_tol=p_ratio,
               ms=time_ms(torch, lambda: fmbe_phi(*pargs, pack=pack)),
               plain_ms=time_ms(torch, lambda: fmbe_phi_plain(*pargs),
                                reps=5),
               bound_ms=fp_bound, bound_by=fp_by,
               library_ms=time_ms(torch, lambda: torch.matmul(
                   x, pack.rows.T)),
               library_call="torch.matmul(x, pack.rows.T), bf16: the "
               "projections alone, not phi",
               pack_ms=wall_ms(torch, lambda: fmbe_pack(
                   fm.omega, fm.degree, fm.coef), reps=3),
               mask_sum_ms=time_ms(torch, lambda: (
                   phi.reshape(nbc, br, -1)
                   * index.valid[:nbc, :, None]).sum(1)),
               pack_columns=n_cols)
    del phi, perr, ptol
    fph["sketch_ms"] = wall_ms(torch, lambda: build_fmbe_blocks(
        fm, index.v_blocks, index.valid, pack=pack), reps=3)
    macs = rows * deg_sum * d
    log(f"fmbe_phi: {nbc} blocks = {rows} rows x P {n_feat}, pack {n_cols} "
        f"columns for {deg_sum} live rows: max abs err "
        f"{fph['max_abs_err']:.3e} = {p_ratio:.4f} of the tolerance, two "
        f"calls bit-equal; chunk lambda_blocks err {lerr:.3e} = "
        f"{l_ratio:.4f} of the tolerance; tensor-core kernel "
        f"{fph['ms']:.4f} ms ({macs / fph['ms'] / 1e6:.1f} TMAC/s on the "
        f"live rows, {fp_bound / fph['ms']:.3f} of the bound), plain "
        f"{fph['plain_ms']:.4f} ms, torch.matmul(x, pack.T) {fph['library_ms']:.4f} ms "
        f"(yardstick, no phi), bound {fp_bound:.4f} ms ({fp_by}, "
        f"{fp_bytes / 1e6:.1f} MB, {macs / 1e9:.1f} G multiply-adds); "
        f"pack (host clock) {fph['pack_ms']:.3f} ms, the build's masked "
        f"block sum of the chunk's phi {fph['mask_sum_ms']:.4f} ms; the "
        f"whole sketch (build_fmbe_blocks, host clock) "
        f"{fph['sketch_ms']:.3f} ms [{card}]")
    for line in ptxas_report(_build.build_log.get("fmbe_phi_wgmma", "")):
        log(f"  ptxas fmbe_phi_wgmma: {line}")
    return fph


def lsh_probe_phase(torch, card, lidx, w, h, pc, k, gen, tag=""):
    """``lsh_probe`` against its plain version at the lsh engine's plan for
    the hidden states h: on the trimmed union the main path scores, and on
    the dense fallback that a small ``head_cap`` forces. Returns the
    kernel's record (the trimmed branch's numbers, the dense branch's under
    ``dense_*``)."""
    from repro_torch.core.lsh import (_collide, device_cands, lsh_plan,
                                      resolve_cand_cap)
    from repro_torch.kernels.lsh_probe import (lsh_probe, lsh_probe_plain,
                                               lsh_query_codes)
    q, d = h.shape
    v = w.shape[0]
    ltab, kbits = lidx.n_tables, lidx.n_bits
    cap = resolve_cand_cap(pc.head_cap, lidx, v)
    plan = lsh_plan(lidx, h, pc.l, generator=gen)
    live = int(plan.cand_live)
    if live > cap:         # the union overflowed: widen it to hold the
        plan = lsh_plan(lidx, h, pc.l, tail_ids=plan.tail_ids,  # trimmed
                        cand_cap=live)                          # branch too
    log(f"lsh plan: union {live} rows (trimmed capacity {cap}), k_eff "
        f"{plan.k_eff.tolist()}, accepted tail samples "
        f"{plan.tail_accept.sum(-1).tolist()} of {pc.l}")

    # the kernel's query codes against the plan's (f64 projections)
    kq = lsh_query_codes(h, lidx.proj)
    differ = kq != plan.qcodes
    pm = lidx.proj[..., :d].reshape(ltab * kbits, d).double()
    rel = ((h.double() @ pm.T) / (h.double().norm(dim=1)[:, None]
                                  * pm.norm(dim=1)[None, :])).abs()
    flips = (((kq ^ plan.qcodes)[..., None] >> torch.arange(
        kbits, device=h.device)) & 1).bool().reshape(q, -1)
    worst = rel[flips].max().item() if flips.any() else 0.0
    check(worst <= CODE_REL, f"lsh_probe: a query code differs from the "
          f"plan's where the projection is {worst:.3e} of |h||p| from 0")
    log(f"lsh_probe query codes: {int(differ.sum())} of {differ.numel()} "
        f"differ from the plan's ({int(flips.sum())} bits, each within "
        f"{CODE_REL} of 0 relative)")

    def hold(label, plan_b):
        # the main path's columns: width V, the branch chosen on the device
        rows, col_live = device_cands(plan_b)
        c = rows.shape[0]
        n_live = min(int(col_live), c)
        member = plan_b.occ_q[:, rows.long()] & \
            (torch.arange(c, device=h.device) < n_live)[None, :]
        args = (w, h, lidx.proj, rows, col_live, lidx.codes,
                lidx.slot_of_row, plan_b.tail_ids, plan_b.tail_accept,
                plan_b.tail_bias)
        out = lsh_probe(*args, k=k)
        again = lsh_probe(*args, k=k)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"lsh_probe {label}: not bit-reproducible")
        hl, tl, tv, ti, cnt = out
        p_hl, p_tl, p_v, p_i, p_cnt = lsh_probe_plain(*args, k=k + 1)
        err = max(compare_lse(f"lsh_probe {label} head_lse", hl, p_hl),
                  compare_lse(f"lsh_probe {label} tail_lse", tl, p_tl))
        err_v, n_ids = compare_topk(f"lsh_probe {label}", tv, ti, p_v, p_i)
        check(torch.equal(cnt, p_cnt), f"lsh_probe {label}: counts differ "
              f"from the plain version's")
        # membership: the plan's, or for a query whose code flipped at a
        # projection within CODE_REL of 0, that of the kernel's codes
        want = member.clone()
        flipped = differ.any(-1)
        if flipped.any():
            want[flipped] = _collide(lidx, kq[flipped], rows) & \
                (torch.arange(c, device=h.device) < n_live)[None, :]
        got_member = cnt > 0
        check(torch.equal(got_member[:, :n_live], want[:, :n_live]),
              f"lsh_probe {label}: counts > 0 differ from the membership")
        moved = int((got_member[:, :n_live] != member[:, :n_live]).sum())
        check(not got_member[:, n_live:].any(), f"lsh_probe {label}: counts "
              f"past the live columns")
        n_tail = plan_b.tail_ids.shape[0]
        es = h.element_size()
        n_bytes = (n_live * d * es + n_tail * d * es + q * d * es
                   + ltab * kbits * (d + 1) * 4 + n_live * 4
                   + n_live * ltab * 8 + n_tail * 8 + q * n_tail + 4
                   + q * c * 4 + q * (8 + 8 * k))
        bound, by = bound_ms(n_bytes, 2 * q * (n_live + n_tail) * d,
                             f32_ops=2 * q * ltab * kbits * d)
        ids, t_ids = rows[:n_live].long(), plan_b.tail_ids.long()
        member_live = member[:, :n_live]

        def library():             # over the live columns only
            s = torch.matmul(h, w[ids].T).float()
            eff = torch.where(member_live, s, torch.full_like(s, -1e30))
            ts = torch.matmul(h, w[t_ids].T).float() + plan_b.tail_bias
            tl_ = torch.logsumexp(torch.where(plan_b.tail_accept, ts,
                                              torch.full_like(ts, -1e30)), -1)
            return torch.logsumexp(eff, -1), torch.topk(eff, k), tl_

        rec = dict(ms=time_ms(torch, lambda: lsh_probe(*args, k=k)),
                   plain_ms=time_ms(torch,
                                    lambda: lsh_probe_plain(*args, k=k),
                                    reps=10),
                   bound_ms=bound, bound_by=by,
                   library_ms=time_ms(torch, library, reps=10),
                   graph10_ms=graph10_ms(torch,
                                         lambda: lsh_probe(*args, k=k)),
                   max_abs_err=max(err, err_v))
        eager = eager_ms(torch, lambda: lsh_probe(*args, k=k))
        log(f"lsh_probe {label}: Q {q} C {c} columns, {n_live} live, "
            f"l {n_tail}, k {k}: lse err {err:.2e}, top-k err {err_v:.2e}, "
            f"{n_ids} ids checked, counts equal, membership equal "
            f"({moved} columns moved by flipped codes), two calls "
            f"bit-equal; kernel {rec['ms']:.4f} ms ({share(bound, rec['ms'])}"
            f" of the {by} bound, {n_bytes / rec['ms'] / 1e6:.1f} GB/s; "
            f"eager call {eager:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"library {rec['library_ms']:.4f} ms, bound {bound:.4f} ms "
            f"({by}, {n_bytes / 1e6:.1f} MB) [{card}]")
        return rec

    trimmed = hold(f"trimmed{tag}", plan)
    # the trimmed union at its own width, as the host-chosen branch ran it
    narrow = (w, h, lidx.proj, plan.cand_rows, plan.cand_live, lidx.codes,
              lidx.slot_of_row, plan.tail_ids, plan.tail_accept,
              plan.tail_bias)
    trimmed["capacity_width_ms"] = time_ms(torch,
                                           lambda: lsh_probe(*narrow, k=k))
    log(f"lsh_probe trimmed{tag} at the capacity's width "
        f"({plan.cand_rows.shape[0]} columns, as the host-chosen branch "
        f"ran it): {trimmed['capacity_width_ms']:.4f} ms, at width V "
        f"{trimmed['ms']:.4f} ms [{card}]")
    dense_plan = lsh_plan(lidx, h, pc.l, tail_ids=plan.tail_ids,
                          cand_cap=64)
    check(int(dense_plan.cand_live) > 64, "lsh: head_cap 64 kept the union")
    dense = hold(f"dense{tag}", dense_plan)
    rec = dict(name=f"lsh_probe{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/lsh_probe.cu",
               replaces="src/repro/kernels/lsh_probe.py:133",
               trimmed_capacity=cap, query_codes_differing=int(differ.sum()),
               **trimmed)
    rec.update({f"dense_{key}": val for key, val in dense.items()})
    rec["max_abs_err"] = max(trimmed["max_abs_err"], dense["max_abs_err"])
    return rec


def ivf_score_phase(torch, card, kernels, index, h, plan, tag=""):
    """``ivf_score`` against its plain version on the mimps plan's (Q, p)
    probe ids, two calls bit-equal; times it as one call, as ten calls in
    one graph, with the L2 cache flushed before each call and by kernel
    (the prologue and the scores), beside its byte bound (each query tile's
    distinct blocks read once), the plain version and a library call; holds
    the rows its producers copy (the prologue's live counts x br rows) to
    the bound's. Then its main path: the entry point
    ``ops.ivf_block_scores``, driven once with the launch counts at 0.
    Returns the kernel's record with the path's launches under
    ``path_launches``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_score import (QT, ivf_score,
                                              ivf_score_plain, score_launch)
    from repro_torch.kernels.ops import ivf_block_scores
    nb, br, d = index.v_blocks.shape
    q, p = plan.block_ids.shape
    es = h.element_size()
    args = (index.v_blocks, h, plan.block_ids)
    got = ivf_score(*args)
    again = ivf_score(*args)
    torch.cuda.synchronize()
    check(got.shape == (q, p, br), f"ivf_score shape {tuple(got.shape)}")
    check(torch.equal(got, again),
          f"ivf_score{tag}: two calls differ in their bits")
    err = (got - ivf_score_plain(*args)).abs().max().item()
    check(err <= TOL, f"ivf_score{tag}: scores differ by {err}")
    # each query tile's distinct blocks, read once
    distinct = sum(int(torch.unique(plan.block_ids[t:t + QT]).numel())
                   for t in range(0, q, QT))
    block_bytes = distinct * br * d * es
    n_bytes = block_bytes + q * d * es + q * p * 4 + q * p * br * 4
    bound, by = bound_ms(n_bytes, 2 * q * p * br * d)
    live = score_launch(*args)[2]
    copied = int(live.sum()) * br * d * es
    check(copied == block_bytes, f"ivf_score{tag}: its producers copy "
          f"{copied} bytes of rows, the bound's distinct blocks are "
          f"{block_bytes}")
    ids = plan.block_ids.long()
    call = lambda: ivf_score(*args)                     # noqa: E731
    rec = dict(name=f"ivf_score{tag}", route="cuda",
               source="src/repro_torch/kernels/csrc/ivf_score.cu",
               replaces="src/repro/kernels/ivf_score.py:62",
               max_abs_err=err,
               ms=time_ms(torch, call),
               plain_ms=time_ms(torch, lambda: ivf_score_plain(*args),
                                reps=10),
               bound_ms=bound, bound_by=by,
               library_ms=time_ms(torch, lambda: torch.einsum(
                   "qd,qpbd->qpb", h, index.v_blocks[ids])),
               graph10_ms=graph10_ms(torch, call),
               l2_flushed_ms=flushed_ms(torch, call),
               by_kernel_ms=kernel_split(torch, call),
               copied_row_bytes=copied, bound_bytes=n_bytes)
    _build.reset_counts(kernels.values())
    scores = ivf_block_scores(*args)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in kernels.items()}
    check(counts["ivf_score"] > 0, "ops.ivf_block_scores never launched "
          "ivf_score")
    check(torch.equal(scores, got), "ops.ivf_block_scores differs from "
          "ivf_score")
    rec["path_launches"] = counts["ivf_score"]
    log(f"ivf_score{tag}: Q {q} x p {p} probes of {br} x {d} blocks "
        f"({distinct} distinct a query tile, summed over "
        f"{-(-q // QT)} tiles, of {nb}), {h.dtype}: err {err:.2e}, two "
        f"calls bit-equal; kernel {rec['ms']:.4f} ms "
        f"({share(bound, rec['ms'])} of the bound; ten calls in one graph "
        f"{rec['graph10_ms']:.4f} ms a call, "
        f"{share(bound, rec['graph10_ms'])}; L2 flushed before each call "
        f"{rec['l2_flushed_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
        f"library {rec['library_ms']:.4f} ms (einsum over the gathered "
        f"blocks), bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB); "
        f"rows copied {copied / 1e6:.1f} MB, the bound's distinct blocks "
        f"{block_bytes / 1e6:.1f} MB, {q * p * br * d * es / 1e6:.1f} MB "
        f"without deduplication; device ms a call by kernel "
        f"(torch.profiler) {rec['by_kernel_ms']}; ops.ivf_block_scores "
        f"launches {counts} [{card}]")
    return rec


def compare_terms(name, got, want, terms, rel=GRAD_REL, mean_rel=GRAD_MEAN):
    """Gradients: per element |got - want| <= rel * sum |terms|, and
    mean_rel on average (defaults: a coefficient rounded to bf16 on both
    sides). Returns (max abs err, max ratio, mean ratio)."""
    ratio = (got - want).abs() / terms.clamp(min=1e-30)
    worst, mean = ratio.max().item(), ratio.mean().item()
    check(worst <= rel and mean <= mean_rel,
          f"{name}: error up to {worst:.3e} (mean {mean:.3e}) of sum "
          f"|terms|, allowed {rel:.3e} (mean {mean_rel:.3e})")
    return (got - want).abs().max().item(), worst, mean


def ptxas_report(text):
    """The lines of an ``nvcc -Xptxas -v`` report that give each entry
    function's registers, shared memory, stack and spills."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            out.append(line.split("'")[1] if "'" in line else line)
        elif "registers" in line or "spill" in line:
            out.append("  " + line.replace("ptxas info    : ", ""))
    return out


def kernel_split(torch, fn, reps=20):
    """Device milliseconds a call of ``fn`` spends in each kernel (mean of
    ``reps`` eager calls under torch.profiler), by kernel name. A kernel
    launched as a programmatic dependent starts while the one before it
    runs, and its time includes that wait."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")[:60]
            out[name] = out.get(name, 0.0) + (e.self_device_time_total
                                              / 1e3 / reps)
    return out


def profile_step(torch, fn, n_top=10):
    """Runs ``fn`` once under torch.profiler. Returns (wall ms, device busy
    ms, the n_top device kernels and the n_top host ops by self time, as
    (name, calls, ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.key, e.count, e.self_device_time_total / 1e3))
        else:
            host.append((e.key, e.count, e.self_cpu_time_total / 1e3))
    dev.sort(key=lambda r: -r[2])
    host.sort(key=lambda r: -r[2])
    return wall, sum(r[2] for r in dev), dev[:n_top], host[:n_top]


def train(torch, card, kernels):
    """Phases 6-7: the fused CE kernels against their plain versions at the
    training shapes, then train steps of full-width qwen1.5-4b. Returns the
    two kernel records."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_ce import (bwd_launch, bwd_schedule,
                                             ce_coef, fused_ce_bwd,
                                             fused_ce_bwd_chunked_plain,
                                             fused_ce_bwd_plain, fused_ce_fwd,
                                             fused_ce_fwd_plain, grad_items,
                                             grad_order)
    from repro_torch.models import Model
    from repro_torch.train import (harvest_train_metrics,
                                   init_train_metric_state, init_train_state,
                                   make_train_step, observe_train_step)

    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"train state: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} "
        f"vocab {cfg.vocab} remat {cfg.remat}, {cfg.dtype} parameters and "
        f"f32 moments, {torch.cuda.memory_allocated() / 1e9:.2f} GB, "
        f"{time.time() - t0:.1f} s")
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}

    # -- 6. the fused CE kernels at the training shapes ----------------------
    params = state.params
    with torch.no_grad():
        hidden, _ = model.forward(params, tokens)
    h = hidden.reshape(-1, cfg.d_model)
    w = model.head_matrix(params).detach()
    lab = labels.reshape(-1)
    t, d, v = h.shape[0], h.shape[1], w.shape[0]
    nll, lse = fused_ce_fwd(h, w, lab)
    nll2, lse2 = fused_ce_fwd(h, w, lab)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2),
          "fused_ce_fwd is not bit-reproducible")
    p_nll, p_lse = fused_ce_fwd_plain(h, w, lab)
    f_err = max((nll - p_nll).abs().max().item(),
                (lse - p_lse).abs().max().item())
    check(f_err <= TOL, f"fused_ce_fwd: nll/lse differ by {f_err}")
    alpha = TrainConfig().selfnorm_alpha
    g_nll = torch.full((t,), 1.0 / t, device=dev)
    g_lse = 2 * alpha * lse / t          # d(alpha mean lse^2)/d lse
    bargs = (h, w, lab, lse, g_nll, g_lse)
    dh, dw = fused_ce_bwd(*bargs, cast=False)
    dh2, dw2 = fused_ce_bwd(*bargs, cast=False)
    torch.cuda.synchronize()
    check(torch.equal(dh, dh2) and torch.equal(dw, dw2),
          "fused_ce_bwd is not bit-reproducible")
    del dh2, dw2
    p_dh, p_dw = fused_ce_bwd_plain(*bargs, cast=False)
    coef = ce_coef(*bargs).abs()
    dh_terms, dw_terms = coef @ w.float().abs(), coef.T @ h.float().abs()
    del coef
    dh_err = compare_terms("fused_ce_bwd dh", dh, p_dh, dh_terms)
    dw_err = compare_terms("fused_ce_bwd dw", dw, p_dw, dw_terms)
    # the kernel's own decomposition (chunks of C columns) in plain PyTorch
    del p_dh, p_dw
    c_dh, c_dw = fused_ce_bwd_chunked_plain(*bargs, cast=False)
    cdh_err = compare_terms("fused_ce_bwd dh vs chunked plain", dh, c_dh,
                            dh_terms)
    cdw_err = compare_terms("fused_ce_bwd dw vs chunked plain", dw, c_dw,
                            dw_terms)
    log(f"fused_ce_bwd against fused_ce_bwd_chunked_plain: dh max "
        f"{cdh_err[1]:.3e} (mean {cdh_err[2]:.3e}), dW max {cdw_err[1]:.3e} "
        f"(mean {cdw_err[2]:.3e}) of sum |terms|")
    del c_dh, c_dw, dh_terms, dw_terms, dh, dw
    torch.cuda.empty_cache()
    fwd_bytes = t * d * 2 + v * d * 2 + t * 4 + 2 * t * 4
    fwd_bound, fwd_by = bound_ms(fwd_bytes, 2 * t * v * d)
    bwd_bytes = 2 * (t * d * 2 + v * d * 2) + 4 * t * 4
    bwd_bound, bwd_by = bound_ms(bwd_bytes, 6 * t * v * d)
    gn = g_nll + g_lse

    def library_fwd():
        logits = torch.matmul(h, w.T).float()
        lse_ = torch.logsumexp(logits, -1)
        return lse_ - logits.gather(1, lab.long()[:, None])[:, 0], lse_

    def library_bwd():
        logits = torch.matmul(h, w.T).float()
        coef_ = torch.softmax(logits, -1) * gn[:, None]
        coef_.scatter_add_(1, lab.long()[:, None], -g_nll[:, None])
        c = coef_.to(w.dtype)
        return c @ w, c.T @ h

    fwd = dict(name="fused_ce_fwd", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_fwd.cu",
               replaces="src/repro/kernels/fused_ce.py:128",
               max_abs_err=f_err,
               ms=time_ms(torch, lambda: fused_ce_fwd(h, w, lab)),
               plain_ms=time_ms(torch, lambda: fused_ce_fwd_plain(h, w, lab),
                                reps=5),
               bound_ms=fwd_bound, bound_by=fwd_by,
               library_ms=time_ms(torch, library_fwd))
    bwd = dict(name="fused_ce_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_bwd.cu",
               replaces="src/repro/kernels/fused_ce.py:169",
               max_abs_err=max(dh_err[0], dw_err[0]),
               max_err_over_sum_terms=max(dh_err[1], dw_err[1]),
               ms=time_ms(torch, lambda: fused_ce_bwd(*bargs), reps=10),
               plain_ms=time_ms(torch, lambda: fused_ce_bwd_plain(*bargs),
                                reps=5),
               bound_ms=bwd_bound, bound_by=bwd_by,
               library_ms=time_ms(torch, library_bwd, reps=10))
    log(f"fused_ce_fwd: T {t} V {v} d {d}: nll/lse err {f_err:.2e}, two "
        f"calls bit-equal; kernel {fwd['ms']:.4f} ms, plain "
        f"{fwd['plain_ms']:.4f} ms, library {fwd['library_ms']:.4f} ms, "
        f"bound {fwd_bound:.4f} ms ({fwd_by}, {2 * t * v * d / 1e12:.3f} "
        f"TFLOP, {fwd_bytes / 1e6:.1f} MB) [{card}]")
    log(f"fused_ce_bwd: T {t} V {v} d {d}, g_lse = 2 alpha lse / T: dh err "
        f"{dh_err[0]:.2e} (max {dh_err[1]:.3e}, mean {dh_err[2]:.3e} of sum "
        f"|terms|), dW err {dw_err[0]:.2e} (max {dw_err[1]:.3e}, mean "
        f"{dw_err[2]:.3e}), two calls bit-equal; kernel {bwd['ms']:.4f} ms, "
        f"plain {bwd['plain_ms']:.4f} ms, library {bwd['library_ms']:.4f} "
        f"ms, bound {bwd_bound:.4f} ms ({bwd_by}, "
        f"{6 * t * v * d / 1e12:.3f} TFLOP, {bwd_bytes / 1e6:.1f} MB) "
        f"[{card}]")
    for rec, n_ops in ((fwd, 2 * t * v * d), (bwd, 6 * t * v * d)):
        log(f"{rec['name']}: {n_ops / rec['ms'] / 1e9:.1f} TFLOP/s achieved "
            f"(dense bf16 peak {BF16_FLOPS / 1e12:.0f}), "
            f"{rec['bound_ms'] / rec['ms']:.3f} of its bound [{card}]")
        for line in ptxas_report(_build.build_log.get(rec["name"], "")):
            log(f"  ptxas {rec['name']}: {line}")
        log(f"  {rec['name']}: {_build.load(rec['name']).hgemm_smem_bytes()} "
            f"bytes of dynamic shared memory a CTA")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sch = bwd_schedule(t, v)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fused_ce_bwd(*bargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"fused_ce_bwd schedule: chunk C {sch['chunk']} of V {v} "
        f"({sch['n_chunks']} chunks), scratch {sch['scratch_bytes']} bytes "
        f"(T x C bf16), f32 dh sum {4 * t * d} bytes; max_memory_allocated "
        f"across one call {peak / 1e9:.3f} GB, {(peak - before) / 1e6:.1f} "
        f"MB above the {before / 1e9:.3f} GB before it (bf16 dh and dW "
        f"included) [{card}]")
    # each launch of the two kernels by name, device time a call
    reps = 5
    _, _, dev_top, _ = profile_step(torch, lambda: [
        (fused_ce_fwd(h, w, lab), fused_ce_bwd(*bargs)) for _ in range(reps)])
    for name, calls, ms in dev_top:
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        log(f"  launch {name.split('<')[0][-40:]:40s} {calls / reps:4.0f} a "
            f"call, {ms / reps:.4f} ms a call [{card}]")
    # the backward's dh + dW items dealt longest first (grad_order, the
    # kernel's path) against round-robin (what a strided loop walks):
    # the same bits, timed in the order longest first, round-robin,
    # round-robin, longest first
    rr = bwd_launch(*bargs, longest_first=False)
    torch.cuda.synchronize()
    check(torch.equal(out[0], rr[0]) and torch.equal(out[1], rr[1]),
          "fused_ce_bwd: round-robin deal changed the result")
    del out, rr
    deal_ms = {True: [], False: []}
    for lf in (True, False, False, True):
        deal_ms[lf].append(time_ms(
            torch, lambda lf=lf: bwd_launch(*bargs, longest_first=lf),
            reps=10))
    busiest = {lf: max(grad_order(t, d, sch["chunk"], sms, lf)[2])
               for lf in (True, False)}
    mean = sum(grad_items(t, d, sch["chunk"])) / sms
    log(f"fused_ce_bwd deal: longest first {deal_ms[True]} ms, round-robin "
        f"{deal_ms[False]} ms; busiest CTA of a full chunk {busiest[True]} "
        f"and {busiest[False]} stages of a mean {mean:.1f} [{card}]")
    del hidden, h, w, nll, lse, nll2, lse2, p_nll, p_lse, bargs, g_lse, gn
    del params
    torch.cuda.empty_cache()

    # -- 7. train ------------------------------------------------------------
    totals = {"fused_ce_fwd": 0, "fused_ce_bwd": 0}
    tm = init_train_metric_state(dev)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for loss_name, n_steps in (("fused_ce", FUSED_STEPS),
                               ("selfnorm", SELFNORM_STEPS)):
        tcfg = TrainConfig(loss=loss_name, warmup_steps=1)
        step = make_train_step(model, tcfg)
        for i in range(n_steps):
            _build.reset_counts(kernels.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {name: kernels[name].launches for name in totals}
            check(counts == {"fused_ce_fwd": 1, "fused_ce_bwd": 1},
                  f"{loss_name} step {i} launched {counts}, want one each")
            for name in totals:
                totals[name] += counts[name]
            tm = observe_train_step(tm, metrics)
            loss = metrics["loss_total"].item()
            check(math.isfinite(loss), f"{loss_name} step {i}: loss {loss}")
            losses.append((loss_name, loss, ms))
            log(f"train {loss_name} step {i}: loss {loss:.6f} (nll "
                f"{metrics['loss'].item():.6f}, mean log Z "
                f"{metrics['mean_log_z'].item():.4f}), grad norm "
                f"{metrics['grad_norm'].item():.4f}, lr {metrics['lr']:.3e}, "
                f"{ms:.1f} ms, {t / ms * 1e3:.1f} tokens/s, launches "
                f"{counts} [{card}]")
    fused = [x for x in losses if x[0] == "fused_ce"]
    check(fused[-1][1] < fused[0][1], f"fused_ce loss did not fall: "
          f"{[round(x[1], 6) for x in fused]}")
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(x[2] for x in losses[1:])
    log(f"train: {len(losses)} steps of B {TRAIN_B} x S {TRAIN_S} = {t} "
        f"tokens, steady {steady:.1f} ms/step (median of steps 2-"
        f"{len(losses)}), {t / steady * 1e3:.1f} tokens/s, peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated), depth {cfg.n_layers} "
        f"of {cfg.n_layers} [{card}]")
    log(f"train metrics: {harvest_train_metrics(tm)}")

    # one more fused_ce step, split into its parts
    tcfg = TrainConfig(loss="fused_ce", warmup_steps=1)
    state, _ = fused_ce_parts(torch, card, model, state, tcfg, batch,
                              "train")

    # one more fused_ce step under the profiler: the device's busy time and
    # idle share, and where the device and the host spend the step
    step = make_train_step(model, tcfg)
    wall, busy, dev_top, host_top = profile_step(
        torch, lambda: step(state, batch))
    log(f"train step profile: wall {wall:.1f} ms, device busy {busy:.1f} "
        f"ms, idle share {1 - busy / wall:.3f} [{card}]")
    for kind, rows in (("device", dev_top), ("host", host_top)):
        for name, calls, ms in rows:
            log(f"  {kind} {ms:9.3f} ms {calls:6d}x {name[:90]}")
    fwd["launches"] = totals["fused_ce_fwd"]
    bwd["launches"] = totals["fused_ce_bwd"]
    return [fwd, bwd]


def fused_ce_parts(torch, card, model, state, tcfg, batch, label):
    """One fused_ce step split into forward, loss (the fused CE forward),
    backward and optimizer: host clock with a synchronise after each part,
    beside CUDA-event device time. The step's update is kept. Returns (the
    state, {part: (wall ms, device ms)})."""
    from repro_torch.train import adamw_update, losses
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    walls = []

    def part(i, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[i].record()
        out = fn()
        events[i + 1].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    hidden, _ = part(0, lambda: model.forward(state.params, batch["tokens"]))
    loss = part(1, lambda: losses.streaming_ce(*losses._flatten_head(
        model, state.params, hidden, batch["labels"]))[0].mean())
    grads = part(2, lambda: torch.autograd.grad(loss, leaves))
    _, opt, _ = part(3, lambda: adamw_update(tcfg, state.params, grads,
                                             state.opt))
    del grads, hidden, loss
    parts = {}
    for i, name in enumerate(("forward", "loss", "backward", "optimizer")):
        parts[name] = (walls[i], events[i].elapsed_time(events[i + 1]))
        log(f"{label} step part {name}: wall {walls[i]:.3f} ms, device "
            f"{parts[name][1]:.3f} ms [{card}]")
    return state._replace(opt=opt), parts


def sparse_ce_float64(torch, h, w, sp, g_nll):
    """The sparse CE of the plan ``sp`` evaluated in float64 from the same
    operands, written apart from the port's code: (nll, log Z, dh, dw, and
    the sums of |terms| of dh and dw), for the loss mean(nll) (cotangent
    ``g_nll`` on nll, 0 on log Z). Only the head columns some token scores
    enter (the others add 0); dw is summed by ``index_add_``, whose order
    does not matter at float64."""
    neg = float("-inf")
    hd = h.double()
    live = sp.head_mask.any(0)
    rows = sp.head_rows[live].long()
    mask = sp.head_mask[:, live]
    wh = w[rows].double()
    s = hd @ wh.T
    head_lse = torch.logsumexp(torch.where(mask, s, neg), -1)
    tails, labels = sp.tail_ids.long(), sp.labels.long()
    wt, wl = w[tails].double(), w[labels].double()
    bias = sp.tail_bias.double()
    ts = hd @ wt.T + bias[None, :]
    acc = sp.tail_accept
    n_acc = (acc.double() * bias.exp()[None, :]).sum(-1)
    ntt = sp.n_tail_total.double()
    ok = (ntt > 0) & (n_acc > 0)
    scale = torch.log(ntt.clamp(min=1e-300)) - torch.log(
        n_acc.clamp(min=1e-300))
    log_tail = torch.where(ok, torch.logsumexp(
        torch.where(acc, ts, neg), -1) + scale, neg)
    s_lab = (hd * wl).sum(-1)
    log_z = torch.logsumexp(torch.stack(
        [head_lse, log_tail, torch.where(sp.label_in_head, neg, s_lab)]), 0)
    g = g_nll.double()
    p = torch.where(mask, (s - log_z[:, None]).exp(), 0.0) * g[:, None]
    del s
    sigma = torch.where(ok, ntt / n_acc.clamp(min=1e-300), 0.0)
    qc = torch.where(acc, (ts - log_z[:, None]).exp(), 0.0) \
        * (sigma * g)[:, None]
    lab = g * torch.where(sp.label_in_head, 0.0,
                          (s_lab - log_z).exp()) - g
    dh = p @ wh + qc @ wt + lab[:, None] * wl
    dh_terms = (p.abs() @ wh.abs() + qc.abs() @ wt.abs()
                + lab.abs()[:, None] * wl.abs())
    del wh
    dw = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
    dw_terms = torch.zeros_like(dw)
    for ids, coef in ((rows, p), (tails, qc)):
        dw.index_add_(0, ids, coef.T @ hd)
        dw_terms.index_add_(0, ids, coef.abs().T @ hd.abs())
    dw.index_add_(0, labels, lab[:, None] * hd)
    dw_terms.index_add_(0, labels, lab.abs()[:, None] * hd.abs())
    return log_z - s_lab, log_z, dh, dw, dh_terms, dw_terms


def sparse_ce_checks(torch, name, h, w, sp, lsh_plan=None):
    """The hard checks of the sparse CE at one step's inputs: nll and log Z
    of the f32 path to F32_FWD_REL of 1 + |value| from float64; dh and dw
    before the cast to F32_GRAD_REL of the sum of their terms (F32_GRAD_MEAN
    on average), after it (bf16) to GRAD_REL; every dw row outside head ∪
    tail ∪ labels exactly 0; two calls bit-equal (nll, log Z, dh, dw). For
    lsh_ce also its invariant: each row of each token in exactly one of
    head, tail population and label term. Returns a dict for the log."""
    from repro_torch.train import losses as tl
    t = h.shape[0]
    g_nll = torch.full((t,), 1.0 / t, device=h.device)
    g_lz = torch.zeros_like(g_nll)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        ev[0].record()
        nll, lz, res = tl._sparse_ce_fwd(h, w, *sp)
        ev[1].record()
        dh, dw = tl._sparse_ce_bwd(res, g_nll, g_lz, cast=False)
        ev[2].record()
        torch.cuda.synchronize()
        del res
        outs.append((nll, lz, dh, dw))
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    check(same, f"{name}: two sparse CE calls differ (nll, log Z, dh, dw)")
    nll, lz, dh, dw = outs[0]
    del outs
    r_nll, r_lz, r_dh, r_dw, dh_terms, dw_terms = sparse_ce_float64(
        torch, h, w, sp, g_nll)
    fwd_err = max(((nll.double() - r_nll).abs() / (1 + r_nll.abs())).max()
                  .item(), ((lz.double() - r_lz).abs()
                            / (1 + r_lz.abs())).max().item())
    check(fwd_err <= F32_FWD_REL, f"{name}: nll/log Z off float64 by "
          f"{fwd_err:.3e} of 1 + |value|")
    errs = {}
    for what, got, want, terms in (("dh", dh, r_dh, dh_terms),
                                   ("dw", dw, r_dw, dw_terms)):
        errs[what] = compare_terms(f"{name} {what} (f32)", got.double(),
                                   want, terms, F32_GRAD_REL, F32_GRAD_MEAN)
        low = got.to(h.dtype if what == "dh" else w.dtype).double()
        errs[what + " cast"] = compare_terms(
            f"{name} {what} ({low.dtype})", low, want, terms, GRAD_REL,
            GRAD_REL)
    del r_dh, r_dw, dh_terms, dw_terms
    allowed = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
    allowed[sp.head_rows[sp.head_mask.any(0)].long()] = True
    allowed[sp.tail_ids.long()] = True
    allowed[sp.labels.long()] = True
    touched = dw.abs().sum(-1) > 0
    check(not bool(touched[~allowed].any()), f"{name}: dw rows outside "
          f"head, tail and labels are not 0")
    out = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_err": fwd_err,
           "dh": errs["dh"][1], "dw": errs["dw"][1],
           "dh_cast": errs["dh cast"][1], "dw_cast": errs["dw cast"][1],
           "rows": int(touched.sum()), "allowed": int(allowed.sum()),
           "head_cols": int(sp.head_mask.any(0).sum())}
    if lsh_plan is not None:
        ar = torch.arange(t, device=h.device)
        labels = sp.labels.long()
        occ = lsh_plan.occ_q
        label_term = ~occ[ar, labels]
        population = ~occ
        population[ar, labels] = False
        cols = sp.head_mask.any(0)           # live columns: distinct rows
        scored = torch.zeros_like(occ)
        scored[:, sp.head_rows[cols].long()] = sp.head_mask[:, cols]
        parts = occ.to(torch.int8) + population.to(torch.int8)
        parts[ar, labels] += label_term.to(torch.int8)
        check(torch.equal(label_term, ~sp.label_in_head)
              and torch.equal(sp.n_tail_total, population.sum(-1).float())
              and bool((parts == 1).all())
              and torch.equal(sp.tail_accept,
                              population[:, sp.tail_ids.long()])
              and torch.equal(scored, occ),
              f"{name}: a row outside exactly one of head, tail population "
              f"and label term")
        out["lsh_head_rows_mean"] = occ.sum(-1).float().mean().item()
    return out


def estimator_train(torch, card, kernels, ce_records):
    """Phase 7b: estimator-backed training of full-width qwen1.5-4b (bf16,
    40 layers, remat full) on the training phase's batch (B 4 x S 256).
    mimps_ce and lsh_ce: ``init_train_state`` builds the index (553-block
    IVF; 8 x 8-bit LSH), the sparse CE is held at the first step's inputs
    (``sparse_ce_checks``), then 4 steps on the repeated batch with one
    ``make_index_refresh`` between steps 2 and 3 (shapes kept, churn and
    drift finite), the loss finite and falling; mimps_ce then takes one
    step split into parts and 2 fused_ce steps on the same state, for
    comparison. mince_ce, nce and sampled take 2 steps each, finite and
    falling (nce and sampled on one noise draw, so that their objective is
    fixed). No step of an estimator loss launches one of the nine kernels
    (the JAX package's estimator losses have none); the fused_ce steps
    launch one CE kernel of each kind a step, counted into ``ce_records``.
    Logs wall and CUDA-event ms a step, tokens/s, peak memory, head_live,
    head_hit_rate, k_eff, the refresh's seconds and the loss part's ms."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.train import (init_train_state, losses,
                                   make_index_refresh, make_train_step)

    t_phase = time.time()
    dev = torch.device("cuda")
    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    pc = cfg.partition
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    t = tokens.numel()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_step(step, state):
        _build.reset_counts(kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        state, metrics = step(state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        return state, metrics, wall, ev[0].elapsed_time(ev[1]), counts

    summary = {}
    for loss_name, n_steps in (("mimps_ce", EST_STEPS), ("lsh_ce", EST_STEPS),
                               ("mince_ce", 2), ("nce", 2), ("sampled", 2)):
        tcfg = TrainConfig(loss=loss_name, warmup_steps=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state = init_train_state(model, tcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.time() - t0
        if loss_name in ("mimps_ce", "lsh_ce"):
            with torch.no_grad():
                hidden, _ = model.forward(state.params, tokens)
            h = hidden.reshape(-1, cfg.d_model)
            w = model.head_matrix(state.params).detach()
            lab = labels.reshape(-1)
            gen = torch.Generator(device=dev).manual_seed(4)
            t1 = time.perf_counter()
            if loss_name == "lsh_ce":
                sp, aux, plan = losses.lsh_estimator_plan(
                    state.index, h, lab, gen, l=pc.l, cand_cap=pc.head_cap)
            else:
                (sp, aux), plan = losses.estimator_plan(
                    state.index, h, lab, gen, n_probe=pc.n_probe, l=pc.l,
                    head_cap=pc.head_cap), None
            torch.cuda.synchronize()
            plan_ms = (time.perf_counter() - t1) * 1e3
            chk = sparse_ce_checks(torch, loss_name, h, w, sp, plan)
            log(f"{loss_name} sparse CE at step 1's inputs: T {t}, head "
                f"columns scored {chk['head_cols']} (union "
                f"{int(aux['head_live'])}, k_eff mean "
                f"{aux['k_eff'].item():.1f}), tail {pc.l}, dw rows touched "
                f"{chk['rows']} of {chk['allowed']} allowed (head, tail, "
                f"labels) of V {w.shape[0]}, the rest exactly 0; nll/log Z "
                f"off float64 {chk['fwd_err']:.3e} of 1 + |value|; dh "
                f"{chk['dh']:.3e}, dw {chk['dw']:.3e} of sum |terms| in "
                f"f32 (bf16 after the cast: {chk['dh_cast']:.3e}, "
                f"{chk['dw_cast']:.3e}); two calls bit-equal; plan "
                f"{plan_ms:.2f} ms wall, forward {chk['fwd_ms']:.2f} ms, "
                f"backward {chk['bwd_ms']:.2f} ms (CUDA events)"
                + (f"; every row in exactly one of head, tail population, "
                   f"label term (mean head rows a token "
                   f"{chk['lsh_head_rows_mean']:.1f})"
                   if plan is not None else "") + f" [{card}]")
            del hidden, h, w, sp, plan
            torch.cuda.empty_cache()
        draw_source = None
        if loss_name in ("nce", "sampled"):
            # one noise draw for both steps, so the objective is fixed and
            # its value on the repeated batch must fall
            noise = torch.randint(0, cfg.vocab, (t, tcfg.nce_noise),
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(5), device=dev)
            draw_source = lambda s, i: noise  # noqa: E731
        step = make_train_step(model, tcfg, draw_source=draw_source)
        refresh = make_index_refresh(model, tcfg) \
            if loss_name in ("mimps_ce", "lsh_ce") else None
        vals, walls, devs = [], [], []
        for i in range(n_steps):
            if refresh is not None and i == 2:
                shapes = [tuple(x.shape) if torch.is_tensor(x) else x
                          for x in state.index]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, rm = refresh(state)
                torch.cuda.synchronize()
                ref_s = time.perf_counter() - t1
                check(shapes == [tuple(x.shape) if torch.is_tensor(x) else x
                                 for x in state.index],
                      f"{loss_name}: the refresh changed the index's shapes")
                churn, drift = rm["churn"].item(), rm["drift"].item()
                check(math.isfinite(churn) and math.isfinite(drift),
                      f"{loss_name}: refresh churn {churn} drift {drift}")
                log(f"{loss_name} refresh between steps 2 and 3: "
                    f"{ref_s:.3f} s wall, churn {churn:.4f}, drift "
                    f"{drift:.4e}, index shapes kept [{card}]")
            state, m, wall, dms, counts = timed_step(step, state)
            check(not counts, f"{loss_name} step {i} launched {counts}; the "
                  f"estimator losses run no kernel of the nine")
            loss = m["loss_total"].item()
            check(math.isfinite(loss), f"{loss_name} step {i}: loss {loss}")
            vals.append(loss)
            walls.append(wall)
            devs.append(dms)
            extra = ""
            if "head_live" in m:
                extra = (f", head_live {int(m['head_live'])}, head_hit_rate "
                         f"{m['head_hit_rate'].item():.4f}, k_eff "
                         f"{m['k_eff'].item():.1f}")
            log(f"train {loss_name} step {i}: loss {loss:.6f}, grad norm "
                f"{m['grad_norm'].item():.4f}, {wall:.1f} ms wall, "
                f"{dms:.1f} ms CUDA events, {t / wall * 1e3:.1f} tokens/s"
                f"{extra} [{card}]")
        check(vals[-1] < vals[0], f"{loss_name}: loss did not fall: {vals}")
        peak = torch.cuda.max_memory_allocated()
        summary[loss_name] = (statistics.median(walls[1:]),
                              statistics.median(devs[1:]), peak)
        log(f"train {loss_name}: {n_steps} steps of {t} tokens, init "
            f"(parameters, moments{', index' if refresh else ''}) "
            f"{init_s:.2f} s, steady {summary[loss_name][0]:.1f} ms wall / "
            f"{summary[loss_name][1]:.1f} ms CUDA events a step (median of "
            f"steps 2-{n_steps}), {t / summary[loss_name][0] * 1e3:.1f} "
            f"tokens/s, peak {peak / 1e9:.2f} GB [{card}]")
        if loss_name == "mimps_ce":
            est_parts(torch, card, model, state, tcfg, batch)
            fstep = make_train_step(model, TrainConfig(loss="fused_ce",
                                                       warmup_steps=1))
            fw = []
            for i in range(2):
                state, m, wall, dms, counts = timed_step(fstep, state)
                check(counts == {"fused_ce_fwd": 1, "fused_ce_bwd": 1},
                      f"fused_ce step {i} in the estimator phase launched "
                      f"{counts}")
                for rec in ce_records:
                    rec["launches"] += 1
                fw.append((wall, dms))
            log(f"train fused_ce on the mimps_ce state (this phase's "
                f"yardstick): {fw[-1][0]:.1f} ms wall, {fw[-1][1]:.1f} ms "
                f"CUDA events, {t / fw[-1][0] * 1e3:.1f} tokens/s; mimps_ce "
                f"{summary['mimps_ce'][0]:.1f} / {summary['mimps_ce'][1]:.1f} "
                f"ms [{card}]")
        del state, step, refresh
        gc.collect()
        torch.cuda.empty_cache()
    log(f"estimator training phase: {time.time() - t_phase:.1f} s [{card}]")


def est_parts(torch, card, model, state, tcfg, batch):
    """One mimps_ce step split into forward, loss (plan + sparse CE
    forward), backward and optimizer: wall ms with a synchronise after each
    part beside CUDA-event ms. The step's update is kept."""
    from repro_torch.train import adamw_update, losses
    from repro_torch.train.optimizer import tree_leaves
    cfg = model.cfg
    pc = cfg.partition
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    walls = []

    def part(i, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[i].record()
        out = fn()
        events[i + 1].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    hidden, _ = part(0, lambda: model.forward(state.params, batch["tokens"]))
    nll = part(1, lambda: losses.estimator_ce(
        state.index, hidden.reshape(-1, cfg.d_model),
        model.head_matrix(state.params), batch["labels"].reshape(-1),
        state.rng, n_probe=pc.n_probe, l=pc.l, head_cap=pc.head_cap)[0])
    loss = nll.mean()
    grads = part(2, lambda: torch.autograd.grad(loss, leaves))
    part(3, lambda: adamw_update(tcfg, state.params, grads, state.opt))
    del grads, hidden, nll, loss
    for i, name in enumerate(("forward", "loss", "backward", "optimizer")):
        log(f"train mimps_ce step part {name}: wall {walls[i]:.3f} ms, "
            f"device {events[i].elapsed_time(events[i + 1]):.3f} ms [{card}]")


def checkpoint_round_trip(torch, card):
    """Phase 7c: ``CheckpointManager`` on the card, on the reduced qwen1.5-4b
    config (a full-width state is about 40 GB of disk a save), for mimps_ce
    and lsh_ce: 2 steps, save (the index and the generator in the state),
    restore: every leaf equal to the saved state bit for bit. Then step 3
    from two restored copies: if the two are bit-equal (the step is
    reproducible), step 3 of the uninterrupted run must equal them bit for
    bit; if not, where they first differ is logged."""
    import shutil
    import tempfile
    from repro_torch.configs import TrainConfig, reduced_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.models import Model
    from repro_torch.train import (CheckpointManager, init_train_state,
                                   make_train_step)
    from repro_torch.train.checkpoint import _flatten, config_fingerprint

    t_phase = time.time()
    dev = torch.device("cuda")
    cfg = reduced_config("qwen1.5-4b")
    model = Model(cfg)

    def first_diff(a, b):
        for k, x in _flatten(a).items():
            y = _flatten(b)[k]
            if isinstance(x, torch.Generator):
                same = torch.equal(x.get_state(), y.get_state())
            elif torch.is_tensor(x):
                same = x.dtype == y.dtype and x.device == y.device and \
                    torch.equal(x, y)
            else:
                same = type(x) is type(y) and x == y
            if not same:
                return k
        return None

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        for loss_name in ("mimps_ce", "lsh_ce"):
            tcfg = TrainConfig(loss=loss_name, warmup_steps=1, lr=1e-3)
            state = init_train_state(model, tcfg, seed=0, device=dev)
            step = make_train_step(model, tcfg)
            it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), 4, 32)
            batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                        zip(("tokens", "labels"), next(it))}
                       for _ in range(3)]
            for b in batches[:2]:
                state, _ = step(state, b)
            mgr = CheckpointManager(f"{tmp}/{loss_name}", keep=2)
            fp = config_fingerprint(cfg, tcfg)
            t0 = time.perf_counter()
            mgr.save(2, state, config=fp, data_state={"step": 2})
            mgr.wait()
            save_ms = (time.perf_counter() - t0) * 1e3
            copies = []
            for _ in range(2):
                r, manifest = mgr.restore(None, like=state, config=fp)
                diff = first_diff(state, r)
                check(diff is None, f"checkpoint {loss_name}: restored {diff} "
                      f"differs from the saved state")
                copies.append(r)
            a, ma = step(copies[0], batches[2])
            b, mb = step(copies[1], batches[2])
            torch.cuda.synchronize()
            repro = first_diff(a, b)
            u, mu = step(state, batches[2])
            resumed = first_diff(u, a)
            if repro is None:
                check(resumed is None, f"checkpoint {loss_name}: step 3 after "
                      f"the restore differs from the uninterrupted step 3 "
                      f"first at {resumed}")
                verdict = ("step 3 reproducible; after the restore bit-equal "
                           "to the uninterrupted step 3")
            else:
                verdict = (f"step 3 not reproducible: two runs first differ "
                           f"at {repro}; the restored run against the "
                           f"uninterrupted one first at {resumed}, losses "
                           f"{mu['loss_total'].item():.9f} / "
                           f"{ma['loss_total'].item():.9f}")
            log(f"checkpoint {loss_name} (reduced qwen1.5-4b: d "
                f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.n_layers} layers; "
                f"{len(manifest['keys'])} arrays, index "
                f"{type(state.index).__name__}, generator on {dev}): save "
                f"{save_ms:.1f} ms, restore bit-equal to the saved state "
                f"(twice); {verdict} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"checkpoint phase: {time.time() - t_phase:.1f} s [{card}]")


def f32_phase(torch, card, kernels):
    """Phase 8: qwen1.5-4b at full width in f32 (d 2560, 20 heads of 128,
    d_ff 6912, vocab 151936), depth cut to F32_LAYERS, the one cut. Each
    serving method builds its engine (the fmbe build timed, its fmbe_phi
    launches all f32) and takes one decode step through the captured
    ``generate`` with the launch counts at 0, bit-equal to the host loop's;
    each kernel of its path must launch, and only at f32. Each kernel is held to its plain version at f32 at the path's
    shapes, under the bf16 phases' limits. Then F32_STEPS ``fused_ce``
    train steps, one f32 launch of each CE kernel a step, and the f32 CE
    pair against its plain versions (nll/lse to 1e-3, dh and dW to
    F32_GRAD_REL of the sum of their terms). Returns the f32 records,
    named ``<kernel>[f32]``, with the launches of this phase's main path
    runs."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.decode import make_plan
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.fmbe import fmbe_phi
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.train import init_train_state, make_train_step

    tag = "[f32]"
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), dtype="float32",
                              n_layers=F32_LAYERS)
    pc = cfg.partition
    k = pc.sample_k
    t0 = time.time()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"f32 model: {cfg.name} layers {cfg.n_layers} (cut from "
        f"{get_config('qwen1.5-4b').n_layers}) d {cfg.d_model} heads "
        f"{cfg.n_heads} x {cfg.d_model // cfg.n_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab} {cfg.dtype}, {n_params / 1e9:.3f} B params, init "
        f"{time.time() - t0:.1f} s")
    totals = {name: 0 for name in kernels}
    records = {}
    floor = floor_ms(torch)
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, 1), generator=gen,
                           device=dev)
    h = None
    assign = None
    for method in SERVE_METHODS:
        mcfg = dataclasses.replace(cfg, partition=dataclasses.replace(
            pc, method=method))
        _build.reset_counts(kernels.values())
        t0 = time.time()
        eng = Engine(Model(mcfg), params, 1, seed=1, index_assign=(
            assign if method in ("topk", "mince", "fmbe") else None))
        torch.cuda.synchronize()
        secs = time.time() - t0
        build = {name: fn.launches for name, fn in kernels.items()}
        check(all(fn.by_variant["bf16"] == 0 for fn in kernels.values()),
              f"{method} f32 build launched a bf16 kernel")
        if method == "fmbe":
            check(fmbe_phi.by_variant["f32"] == build["fmbe_phi"] > 0,
                  f"the f32 fmbe build ran fmbe_phi {fmbe_phi.by_variant}")
            log(f"f32 fmbe build: {secs:.3f} s with fmbe_phi launches "
                f"{fmbe_phi.by_variant} [{card}]")
        if method == "mimps":
            assign = eng.index.assign
        if h is None:                      # the step's hidden states
            cache = eng.model.init_decode_state(N_REQ, 1, dev)
            h = eng.model.decode_step(params, cache, prompt[:, 0], 0)
            check(h.dtype == torch.float32, f"f32 trunk gave {h.dtype}")
            log(f"f32 hidden states: Q {h.shape[0]}, |h|_2 mean "
                f"{h.norm(dim=-1).mean().item():.2f}")
        path = {}

        def path_run(fn):
            _build.reset_counts(kernels.values())
            res = fn()
            path.update({name: (fn_.launches, dict(fn_.by_variant))
                         for name, fn_ in kernels.items()})
            return res

        (out, aux, secs), (_, _, host_secs) = served_pair(
            torch, eng, prompt, 1, f"f32 serve {method}", wrap=path_run)
        check(eng.captures == 1, f"f32 {method}: {eng.captures} captures")
        counts = {name: c for name, (_, c) in path.items()}
        check(out.shape == (N_REQ, 1), f"f32 {method}: tokens {out.shape}")
        check(bool(torch.isfinite(aux["log_z"]).all()),
              f"f32 {method}: log_z not finite")
        for name in PATH_KERNELS[method]:
            check(counts[name]["f32"] > 0 and counts[name]["bf16"] == 0,
                  f"f32 {method}: {name} launched {counts[name]}, want f32 "
                  f"only")
        for name, (n, _) in path.items():
            totals[name] += n + build[name]
        log(f"f32 serve {method}: one decode step of {N_REQ} requests, "
            f"captured (warm-up step, capture, replay) {secs * 1e3:.1f} ms, "
            f"host loop {host_secs * 1e3:.1f} ms, bit-equal, log_z "
            f"{aux['log_z'][:, 0].tolist()}, "
            f"launches by dtype "
            f"{ {n: c for n, c in counts.items() if c['f32'] or c['bf16']} } "
            f"[{card}]")
        # the path's kernels against their plain versions at f32
        if method == "exact":
            records["topk_z"] = topk_z_phase(torch, card, h, eng.state.w, k,
                                             tag)
        elif method == "mimps":
            plan = make_plan(eng.index, h, pc.n_probe, pc.l, generator=gen)
            records["ivf_decode"] = ivf_decode_phase(
                torch, card, eng.index, h, plan, pc, k, tag)
            rec = ivf_score_phase(torch, card, kernels, eng.index, h, plan,
                                  tag)
            variants = kernels["ivf_score"].by_variant
            check(variants["f32"] == rec["path_launches"],
                  f"ops.ivf_block_scores ran {variants}")
            totals["ivf_score"] += rec.pop("path_launches")
            records["ivf_score"] = rec
        elif method == "topk":
            plan = make_plan(eng.index, h, pc.n_probe, pc.l, generator=gen)
            records["union_scores"] = union_scores_phase(
                torch, card, eng.index, h, plan, tag)
        elif method == "fmbe":
            plan = make_plan(eng.index, h, pc.n_probe, pc.l, generator=gen)
            fstate = eng.state.fmbe
            deg_sum = int(fstate.fm.degree.sum())
            records["fmbe_z"] = fmbe_z_phase(torch, card, fstate.fm, fstate,
                                             h, plan, deg_sum, tag)
            records["fmbe_phi"] = fmbe_phi_f32(torch, card, fstate, eng.index,
                                               deg_sum)
        elif method == "lsh":
            records["lsh_probe"] = lsh_probe_phase(
                torch, card, eng.state.lsh, eng.state.w, h, pc, k, gen, tag)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # -- training at f32 ------------------------------------------------------
    model = Model(cfg)
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), TRAIN_B, TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    step = make_train_step(model, TrainConfig(loss="fused_ce",
                                              warmup_steps=1))
    for i in range(F32_STEPS):
        _build.reset_counts(kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {n: dict(kernels[n].by_variant)
                  for n in ("fused_ce_fwd", "fused_ce_bwd")}
        check(all(c == {"bf16": 0, "f32": 1} for c in counts.values()),
              f"f32 fused_ce step {i} launched {counts}, want one f32 each")
        for name in counts:
            totals[name] += 1
        loss = metrics["loss_total"].item()
        check(math.isfinite(loss), f"f32 fused_ce step {i}: loss {loss}")
        log(f"f32 train fused_ce step {i}: loss {loss:.6f}, grad norm "
            f"{metrics['grad_norm'].item():.4f}, {ms:.1f} ms, B {TRAIN_B} x "
            f"S {TRAIN_S}, depth {cfg.n_layers} [{card}]")
    with torch.no_grad():
        hidden, _ = model.forward(state.params, tokens)
    records.update(ce_f32_phase(torch, card, hidden.reshape(-1, cfg.d_model),
                                model.head_matrix(state.params).detach(),
                                labels.reshape(-1)))
    del state, hidden
    torch.cuda.empty_cache()
    out = []
    for name in kernels:
        rec = records[name]
        rec["launches"] = totals[name]
        if "graph10_ms" in rec:                   # a decode kernel
            rec["floor_ms"] = floor
        out.append(rec)
    return out


def fmbe_phi_f32(torch, card, fstate, index, deg_sum):
    """``fmbe_phi`` at f32 (the tensor-core kernel on three exact bf16
    planes of x) on the f32 build's first chunk: against ``fmbe_phi_plain``
    (the limit), against ``fmbe_phi_planes_plain`` (the kernel's
    decomposition, the same limit) and against float64 (logged, beside the
    plain version's own error), two calls bit-equal, its split of x equal to
    ``split_planes`` bit for bit. Times it beside its bound for the bf16
    operations it issues and the f32-core bound, the plain version, the
    product alone in full f32 (``torch.matmul(x, pack.rows.float().T)``,
    the yardstick as at bf16) and the whole sketch (``build_fmbe_blocks``,
    host clock). Returns the record."""
    from repro_torch.core.feature_maps import build_fmbe_blocks
    from repro_torch.kernels.fmbe import (fmbe_pack, fmbe_phi,
                                         fmbe_phi_planes_plain,
                                         fmbe_phi_plain, phi_launch)
    from repro_torch.kernels.fused_ce import split_planes
    fm = fstate.fm
    nbc, d = PHI_CHUNK_BLOCKS, index.v_blocks.shape[-1]
    x = index.v_blocks[:nbc].reshape(-1, d)
    rows, n_feat = x.shape[0], fm.omega.shape[0]
    pack = fmbe_pack(fm.omega, fm.degree, fm.coef)
    pargs = (fm.omega, fm.degree, fm.coef, x)
    phi = fmbe_phi(*pargs, pack=pack)
    again = fmbe_phi(*pargs, pack=pack)
    torch.cuda.synchronize()
    check(torch.equal(phi, again), "fmbe_phi[f32] is not bit-reproducible")
    del again
    # the split of x: planes of the chunk's rows, zeros past d
    _, planes = phi_launch(pack, x)
    torch.cuda.synchronize()
    for q, plane in enumerate(split_planes(x)):
        check(torch.equal(planes[q, :, :d].view(torch.int16),
                          plane.view(torch.int16))
              and not planes[q, :, d:].any(),
              f"fmbe_phi[f32]: split plane {q} of x differs from "
              f"split_planes")
    del planes
    norm = x.norm(dim=-1).clamp(min=1.0)
    scale = fm.coef.abs()[None, :] * norm[:, None] ** fm.degree[None, :]
    ratios = {}
    for name, want in (("plain", fmbe_phi_plain(*pargs)),
                       ("planes", fmbe_phi_planes_plain(pack, x))):
        err = (phi - want).abs()
        ratios[name] = (err / (FMBE_REL * (want.abs() + scale))).max().item()
        check(ratios[name] <= 1.0, f"fmbe_phi[f32] vs {name}: error "
              f"{err.max().item():.3e} is {ratios[name]:.3f} of the "
              f"tolerance")
        if name == "plain":
            p_phi, max_err = want, err.max().item()
        del err, want
    # float64 from the same f32 rows: the kernel's and the plain version's
    proj64 = x.double() @ pack.rows.double().T
    want = torch.ones_like(phi, dtype=torch.float64)
    for m in range(fm.omega.shape[1]):
        use = pack.degree > m
        col = torch.where(use, pack.start + m, 0).long()
        want = torch.where(use[None, :], want * proj64[:, col], want)
    want = want * pack.coef.double()
    size = FMBE_REL * (want.abs() + scale.double())
    r64 = {name: ((got.double() - want).abs() / size).max().item()
           for name, got in (("kernel", phi), ("plain", p_phi))}
    del proj64, want, size, phi, p_phi
    n_bytes = deg_sum * d * 2 + n_feat * 8 + rows * d * 4 + rows * n_feat * 4
    macs = rows * deg_sum * d
    bound, by = bound_ms(n_bytes, 3 * 2 * macs)
    core_bound, _ = bound_ms(n_bytes, 0, f32_ops=2 * macs)
    rec = dict(name="fmbe_phi[f32]", route="cuda",
               source="src/repro_torch/kernels/csrc/fmbe_phi_wgmma.cu",
               replaces="src/repro/kernels/fmbe.py:89",
               max_abs_err=max_err, max_err_over_tol=ratios["plain"],
               planes_plain_err_over_tol=ratios["planes"],
               float64_err_over_tol=r64["kernel"],
               plain_float64_err_over_tol=r64["plain"],
               ms=time_ms(torch, lambda: fmbe_phi(*pargs, pack=pack)),
               plain_ms=time_ms(torch, lambda: fmbe_phi_plain(*pargs),
                                reps=5),
               bound_ms=bound, bound_by=by, f32_core_bound_ms=core_bound,
               library_ms=time_ms(torch, lambda: torch.matmul(
                   x, pack.rows.float().T)),
               library_call="torch.matmul(x, pack.rows.float().T), f32 "
               "without TF32: the projections alone, not phi")
    rec["sketch_ms"] = wall_ms(torch, lambda: build_fmbe_blocks(
        fm, index.v_blocks, index.valid, pack=pack), reps=3)
    log(f"fmbe_phi[f32]: {rows} rows x P {n_feat}, f32 x as three bf16 "
        f"planes on the tensor cores: max abs err {max_err:.3e} = "
        f"{ratios['plain']:.4f} of the tolerance against the plain version, "
        f"{ratios['planes']:.4f} against the plane decomposition; against "
        f"float64 {r64['kernel']:.4g} of the tolerance (plain f32 "
        f"{r64['plain']:.4g}); two calls bit-equal, split of x equal to "
        f"split_planes; kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, torch.matmul(x, pack.T) in f32 "
        f"{rec['library_ms']:.4f} ms (yardstick, no phi), bound "
        f"{bound:.4f} ms ({by}, {3 * 2 * macs / 1e12:.3f} TFLOP of bf16 "
        f"issued), f32-core bound {core_bound:.4f} ms; the whole sketch "
        f"(build_fmbe_blocks, host clock) {rec['sketch_ms']:.3f} ms "
        f"[{card}]")
    return rec


CE64_CHUNK = 16384                # vocab rows a float64 chunk


def forward64(torch, h, w, lab):
    """nll, lse and each token's largest sum of |h_i w_i| over the
    vocabulary (the terms of its largest score) in float64 from h and w,
    ``CE64_CHUNK`` vocab rows at a time; a label outside [0, V) leaves the
    label score at -1e30."""
    v = w.shape[0]
    h64, lab64 = h.double(), lab.long()
    lse = torch.full((h.shape[0],), float("-inf"), dtype=torch.float64,
                     device=h.device)
    picked = torch.full_like(lse, -1e30)
    terms = torch.zeros_like(lse)
    for r0 in range(0, v, CE64_CHUNK):
        r1 = min(v, r0 + CE64_CHUNK)
        w64 = w[r0:r1].double()
        logits = h64 @ w64.T
        lse = torch.logaddexp(lse, torch.logsumexp(logits, -1))
        hit = (lab64 >= r0) & (lab64 < r1)
        got = logits.gather(1, (lab64 - r0).clamp(0, r1 - r0 - 1)[:, None])
        picked = torch.where(hit, got[:, 0], picked)
        terms = torch.maximum(terms, (h64.abs() @ w64.abs().T).amax(-1))
        del logits, w64
    return lse - picked, lse, terms


def ce_f32_phase(torch, card, h, w, lab):
    """The f32 fused CE kernels against their plain versions on the f32
    model's hidden states: nll and lse to 1e-3 (against
    ``fused_ce_fwd_plain`` and against ``fused_ce_fwd_planes_plain``, the
    forward's three-plane decomposition) and to F32_FWD_REL of 1 + |value|
    against float64 (the plain f32 version's error logged beside), the
    forward's split of h and w equal to ``split_planes`` bit for bit, dh
    and dW (f32) to
    F32_GRAD_REL of the sum of their terms' magnitudes per element and
    F32_GRAD_MEAN on average, against ``fused_ce_bwd_plain`` and against
    ``fused_ce_bwd_chunked_plain`` (the backward's three-plane chunked
    decomposition), and in three token slices (the route of T above
    F32_MAX_DEPTH), two calls bit-equal; the backward's split kernel equal
    to ``split_planes`` bit for bit on h and on the last (ragged) chunk of
    w. Times the forward beside its bound at the bf16 rate for the 12 T V d
    operations it issues and the f32-rate bound of its 2 T V d of f32 work,
    and the backward beside its bound for the 36 T V d operations it issues
    and the f32-rate bound of its 6 T V d, the backward's split kernel
    alone, plain versions and library calls (cuBLAS in full f32); profiles
    both by kernel. Returns the two records."""
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels.fused_ce import (PAIRS, bwd_launch,
                                             bwd_schedule, ce_coef,
                                             fused_ce_bwd,
                                             fused_ce_bwd_chunked_plain,
                                             fused_ce_bwd_plain, fused_ce_fwd,
                                             fused_ce_fwd_planes_plain,
                                             fused_ce_fwd_plain, fwd_launch,
                                             planes_launch, split_planes)
    t, d = h.shape
    v = w.shape[0]
    nll, lse = fused_ce_fwd(h, w, lab)
    nll2, lse2 = fused_ce_fwd(h, w, lab)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2),
          "fused_ce_fwd[f32] is not bit-reproducible")
    del nll2, lse2
    f_errs = {}
    for name, plain in (("plain", fused_ce_fwd_plain),
                        ("planes", fused_ce_fwd_planes_plain)):
        p_nll, p_lse = plain(h, w, lab)
        f_errs[name] = max((nll - p_nll).abs().max().item(),
                           (lse - p_lse).abs().max().item())
        check(f_errs[name] <= TOL, f"fused_ce_fwd[f32]: nll/lse differ from "
              f"the {name} version by {f_errs[name]}")
        if name == "plain":
            plain_out = (p_nll, p_lse)
        del p_nll, p_lse
        torch.cuda.empty_cache()
    f_err = f_errs["plain"]
    want = forward64(torch, h, w, lab)[:2]
    f64 = {}
    for name, got in (("kernel", (nll, lse)), ("plain", plain_out)):
        f64[name] = max(((g.double() - x).abs() / (1 + x.abs())).max().item()
                        for g, x in zip(got, want))
    check(f64["kernel"] <= F32_FWD_REL, f"fused_ce_fwd[f32]: nll/lse "
          f"{f64['kernel']:.3e} of 1 + |value| from float64, allowed "
          f"{F32_FWD_REL}")
    del want, plain_out
    # the forward's split: h and all of w, as split_planes gives them
    _, _, fwd_planes = fwd_launch(h, w, lab)
    torch.cuda.synchronize()
    for name, x, got in (("h", h, fwd_planes[0]), ("w", w, fwd_planes[1])):
        for q, plane in enumerate(split_planes(x)):
            check(torch.equal(got[q, :, :d].view(torch.int16),
                              plane.view(torch.int16))
                  and not got[q, :, d:].any(),
                  f"fused_ce_fwd[f32]: split plane {q} of {name} differs "
                  f"from split_planes")
            del plane
    del fwd_planes
    torch.cuda.empty_cache()
    log(f"fused_ce_fwd[f32]: nll/lse {f_errs['plain']:.3e} from the plain "
        f"version, {f_errs['planes']:.3e} from the plane decomposition; "
        f"{f64['kernel']:.3e} of 1 + |value| from float64 (plain f32 "
        f"{f64['plain']:.3e}); its split planes of h and w equal "
        f"split_planes bit for bit")
    # the backward's split kernel: h, and the last chunk of w (rows past V
    # are zeros)
    sch = bwd_schedule(t, v, torch.float32)
    c, c0 = sch["chunk"], (sch["n_chunks"] - 1) * sch["chunk"]
    for name, x, rows in (("h", h, t), ("w chunk", w[c0:], c)):
        got = planes_launch(x, rows)
        torch.cuda.synchronize()
        want = torch.zeros_like(got)
        for q, plane in enumerate(split_planes(x)):
            want[q, :x.shape[0], :d] = plane
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"fused_ce_bwd[f32]: split kernel planes of {name} differ from "
              f"split_planes")
        del got, want
    log(f"fused_ce_bwd[f32] split kernel: planes of h ({t} rows) and of the "
        f"last chunk of w ({v - c0} rows into {c}) equal split_planes bit "
        f"for bit")
    g_nll = torch.full((t,), 1.0 / t, device=h.device)
    g_lse = 2 * TrainConfig().selfnorm_alpha * lse / t
    bargs = (h, w, lab, lse, g_nll, g_lse)
    dh, dw = fused_ce_bwd(*bargs)
    dh2, dw2 = fused_ce_bwd(*bargs)
    torch.cuda.synchronize()
    check(torch.equal(dh, dh2) and torch.equal(dw, dw2),
          "fused_ce_bwd[f32] is not bit-reproducible")
    del dh2, dw2
    coef = ce_coef(*bargs).abs()
    dh_terms, dw_terms = coef @ w.abs(), coef.T @ h.abs()
    del coef
    p_dh, p_dw = fused_ce_bwd_plain(*bargs)
    dh_err = compare_terms("fused_ce_bwd[f32] dh", dh, p_dh, dh_terms,
                           F32_GRAD_REL, F32_GRAD_MEAN)
    dw_err = compare_terms("fused_ce_bwd[f32] dw", dw, p_dw, dw_terms,
                           F32_GRAD_REL, F32_GRAD_MEAN)
    # the route of T > F32_MAX_DEPTH: token slices whose dW add up in f32,
    # here three slices of T / 3 (launches not counted)
    s_dh, s_dw = bwd_launch(*bargs, depth=-(-t // 3))
    sdh_err = compare_terms("fused_ce_bwd[f32] dh in 3 token slices", s_dh,
                            p_dh, dh_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    sdw_err = compare_terms("fused_ce_bwd[f32] dw in 3 token slices", s_dw,
                            p_dw, dw_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    log(f"fused_ce_bwd[f32] in 3 token slices: dh max {sdh_err[1]:.3e} "
        f"(mean {sdh_err[2]:.3e}), dW max {sdw_err[1]:.3e} (mean "
        f"{sdw_err[2]:.3e}) of sum |terms| against the plain version")
    del p_dh, p_dw, s_dh, s_dw
    c_dh, c_dw = fused_ce_bwd_chunked_plain(*bargs)
    cdh_err = compare_terms("fused_ce_bwd[f32] dh vs chunked plain", dh, c_dh,
                            dh_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    cdw_err = compare_terms("fused_ce_bwd[f32] dw vs chunked plain", dw, c_dw,
                            dw_terms, F32_GRAD_REL, F32_GRAD_MEAN)
    del c_dh, c_dw, dh_terms, dw_terms, dh, dw
    torch.cuda.empty_cache()
    fwd_bytes = t * d * 4 + v * d * 4 + t * 4 + 2 * t * 4
    fwd_issued = len(PAIRS) * 2 * t * v * d     # bf16 operations issued
    fwd_bound, fwd_by = bound_ms(fwd_bytes, fwd_issued)
    fwd_core, _ = bound_ms(fwd_bytes, 0, f32_ops=2 * t * v * d)
    bwd_bytes = 2 * (t * d * 4 + v * d * 4) + 4 * t * 4
    n_issued = 6 * len(PAIRS) * t * v * d       # bf16 operations issued
    bwd_bound, bwd_by = bound_ms(bwd_bytes, n_issued)
    core_bound, _ = bound_ms(bwd_bytes, 0, f32_ops=6 * t * v * d)
    gn = g_nll + g_lse

    def library_fwd():
        logits = torch.matmul(h, w.T)
        lse_ = torch.logsumexp(logits, -1)
        return lse_ - logits.gather(1, lab.long()[:, None])[:, 0], lse_

    def library_bwd():
        coef_ = torch.softmax(torch.matmul(h, w.T), -1) * gn[:, None]
        coef_.scatter_add_(1, lab.long()[:, None], -g_nll[:, None])
        return coef_ @ w, coef_.T @ h

    fwd = dict(name="fused_ce_fwd[f32]", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_fwd.cu",
               replaces="src/repro/kernels/fused_ce.py:128",
               max_abs_err=f_err, planes_plain_err=f_errs["planes"],
               float64_err_rel=f64["kernel"],
               plain_float64_err_rel=f64["plain"],
               ms=time_ms(torch, lambda: fused_ce_fwd(h, w, lab), reps=5),
               plain_ms=time_ms(torch, lambda: fused_ce_fwd_plain(h, w, lab),
                                reps=5),
               bound_ms=fwd_bound, bound_by=fwd_by,
               f32_core_bound_ms=fwd_core,
               library_ms=time_ms(torch, library_fwd, reps=5))
    fwd["tflops_f32_work"] = 2 * t * v * d / fwd["ms"] / 1e9
    fwd["tflops_issued"] = fwd_issued / fwd["ms"] / 1e9
    split_h = time_ms(torch, lambda: planes_launch(h), reps=10)
    split_chunk = time_ms(torch, lambda: planes_launch(w[:c], c), reps=10)
    bwd = dict(name="fused_ce_bwd[f32]", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_ce_bwd.cu",
               replaces="src/repro/kernels/fused_ce.py:169",
               max_abs_err=max(dh_err[0], dw_err[0]),
               max_err_over_sum_terms=max(dh_err[1], dw_err[1]),
               ms=time_ms(torch, lambda: fused_ce_bwd(*bargs), reps=5),
               plain_ms=time_ms(torch, lambda: fused_ce_bwd_plain(*bargs),
                                reps=3),
               bound_ms=bwd_bound, bound_by=bwd_by,
               f32_core_bound_ms=core_bound,
               split_ms=split_h + sch["n_chunks"] * split_chunk,
               split_h_ms=split_h, split_chunk_ms=split_chunk,
               library_ms=time_ms(torch, library_bwd, reps=3))
    bwd["tflops_f32_work"] = 6 * t * v * d / bwd["ms"] / 1e9
    bwd["tflops_issued"] = n_issued / bwd["ms"] / 1e9
    log(f"fused_ce_fwd[f32]: T {t} V {v} d {d}, three bf16 planes, "
        f"{len(PAIRS)} plane pairs: nll/lse err {f_err:.2e}, two calls "
        f"bit-equal; kernel {fwd['ms']:.4f} ms "
        f"({fwd['tflops_f32_work']:.1f} TFLOP/s of f32 work, "
        f"{fwd['tflops_issued']:.1f} TFLOP/s of bf16 issued), plain "
        f"{fwd['plain_ms']:.4f} ms, library {fwd['library_ms']:.4f} ms, "
        f"bound {fwd_bound:.4f} ms ({fwd_by}, {fwd_issued / 1e12:.3f} TFLOP "
        f"bf16 at {BF16_FLOPS / 1e12:.0f} TFLOP/s; f32-core bound "
        f"{fwd_core:.4f} ms at {F32_FLOPS / 1e12:.0f} TFLOP/s) [{card}]")
    log(f"fused_ce_bwd[f32]: T {t} V {v} d {d}, g_lse = 2 alpha lse / T, "
        f"chunk C {c} ({sch['n_chunks']} chunks), three bf16 planes, "
        f"{len(PAIRS)} plane pairs: dh err {dh_err[0]:.2e} (max "
        f"{dh_err[1]:.3e}, mean {dh_err[2]:.3e} of sum |terms|), dW err "
        f"{dw_err[0]:.2e} (max {dw_err[1]:.3e}, mean {dw_err[2]:.3e}); "
        f"against the chunked plane decomposition dh max {cdh_err[1]:.3e} "
        f"(mean {cdh_err[2]:.3e}), dW max {cdw_err[1]:.3e} (mean "
        f"{cdw_err[2]:.3e}); two calls bit-equal; kernel {bwd['ms']:.4f} ms "
        f"({bwd['tflops_f32_work']:.1f} TFLOP/s of f32 work, "
        f"{bwd['tflops_issued']:.1f} TFLOP/s of bf16 issued), split "
        f"{bwd['split_ms']:.4f} ms a call (h {split_h:.4f} + "
        f"{sch['n_chunks']} x chunk {split_chunk:.4f}), plain "
        f"{bwd['plain_ms']:.4f} ms, library {bwd['library_ms']:.4f} ms, "
        f"bound {bwd_bound:.4f} ms ({bwd_by}, {n_issued / 1e12:.3f} TFLOP "
        f"bf16 at {BF16_FLOPS / 1e12:.0f} TFLOP/s; f32-core bound "
        f"{core_bound:.4f} ms) [{card}]")
    # device time by kernel: the forward's split, partial and merge; the
    # backward's split, coefficient and gradients
    reps = 2
    for name, fn in (("fused_ce_fwd[f32]", lambda: fused_ce_fwd(h, w, lab)),
                     ("fused_ce_bwd[f32]", lambda: fused_ce_bwd(*bargs))):
        _, busy, dev_top, _ = profile_step(
            torch, lambda fn=fn: [fn() for _ in range(reps)])
        for kernel, calls, ms in dev_top:
            kernel = kernel.replace("(anonymous namespace)::", "").split(
                "(")[0]
            log(f"  launch {kernel[-40:]:40s} {calls / reps:4.0f} a call, "
                f"{ms / reps:.4f} ms a call [{card}]")
        log(f"  {name}: device busy {busy / reps:.4f} ms a call [{card}]")
    for name in ("fused_ce_fwd", "fused_ce_bwd"):
        for line in ptxas_report(_build_log(name)):
            log(f"  ptxas {name}: {line}")
    return {"fused_ce_fwd": fwd, "fused_ce_bwd": bwd}


# --------------------------------------------------------------------------
# The audio family and gemma3 training (before the traffic phase: its
# torch.profiler sessions slow the host-bound train steps run after them)
# --------------------------------------------------------------------------

A_ARCH = "musicgen-medium"
A_PARAMS = 1_837_254_144          # the JAX package's eval_shape count
A_PROMPT, A_NEW = 16, 32
A_MAX_LEN = A_PROMPT + A_NEW
A_TRAIN_B, A_TRAIN_S = 4, 256     # x 4 codebooks: T = 4096 head rows
A_STEPS = (("fused_ce", 3), ("selfnorm", 3), ("ce", 2), ("nce", 2),
           ("sampled", 2))
G_ARCH = "gemma3-4b"
G_TRAIN_B, G_TRAIN_S = 1, 2048    # past the 1024-token window
G_STEPS = 3
# both phases train at TrainConfig's defaults: lr 3e-4 after a 100-step
# linear warmup (3e-6, 6e-6, 9e-6 on their first three steps). At the full
# 3e-4 from the first step their losses fall and then rise in the JAX
# package too (C14)
# bf16 scores summed in f32 over d: nll and lse against the plain version
# and float64, of the token's largest sum of |h_i w_i| over the vocabulary
# (TOL's 1e-3 absolute is below the f32 sums' rounding at gemma3's head,
# whose LSEs are near 509)
FWD64_REL = 1e-5
CE_KERNELS = ("fused_ce_fwd", "fused_ce_bwd")


def ce_pair_held(torch, label, h, w, lab, card):
    """The bf16 fused CE pair on (h, w, lab) at a fused_ce step's
    cotangents (g_nll = 1/T, g_lse = 0), two calls of each bit-equal,
    held against its plain version and against a float64 evaluation of the
    same formula from the same operands (``CE64_CHUNK`` vocab rows at a
    time): nll and lse within FWD64_REL of the token's largest sum of
    |h_i w_i| (``forward64``), dh and dW (f32, before the cast) within
    GRAD_REL of the sum of their terms' magnitudes per element and
    GRAD_MEAN (against float64 GRAD64_MEAN) on average, the softmax's terms
    and the label's counted apart
    (at a softmax near one hot on the label they cancel in the
    coefficient, not in the f32 sums). The plain forward's distance from
    float64 is logged beside. Returns, by record, the errors against the
    plain version (``max_abs_err``, and ``max_err_over_sum_terms`` for the
    backward) and against float64 (``max_err_vs_float64``,
    ``max_err_over_sum_terms_vs_float64``)."""
    from repro_torch.kernels.fused_ce import (fused_ce_bwd,
                                             fused_ce_bwd_plain,
                                             fused_ce_fwd, fused_ce_fwd_plain)
    t, d = h.shape
    v = w.shape[0]
    nll, lse = fused_ce_fwd(h, w, lab)
    nll2, lse2 = fused_ce_fwd(h, w, lab)
    g_nll = torch.full((t,), 1.0 / t, device=h.device)
    g_lse = torch.zeros_like(g_nll)
    bargs = (h, w, lab, lse, g_nll, g_lse)
    dh, dw = fused_ce_bwd(*bargs, cast=False)
    dh2, dw2 = fused_ce_bwd(*bargs, cast=False)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2)
          and torch.equal(dh, dh2) and torch.equal(dw, dw2),
          f"{label}: the fused CE pair is not bit-reproducible")
    del nll2, lse2, dh2, dw2
    # forward: (abs err, err / a score's sum |terms|) of each pair
    nll64, lse64, terms = forward64(torch, h, w, lab)
    p_nll, p_lse = fused_ce_fwd_plain(h, w, lab)

    def fwd_err(a, b):
        err = torch.maximum((a[0].double() - b[0]).abs(),
                            (a[1].double() - b[1]).abs())
        return err.max().item(), (err / terms).max().item()
    fwd = {"plain": fwd_err((nll, lse), (p_nll, p_lse)),
           "float64": fwd_err((nll, lse), (nll64, lse64)),
           "plain vs float64": fwd_err((p_nll, p_lse), (nll64, lse64))}
    del p_nll, p_lse
    for what in ("plain", "float64"):
        check(fwd[what][1] <= FWD64_REL, f"{label}: fused_ce_fwd nll/lse "
              f"{fwd[what][0]:.3e} from {what}, {fwd[what][1]:.3e} of a "
              f"score's sum |terms|, allowed {FWD64_REL}")
    # backward: the plain version's dh and dW, then coef = g softmax -
    # g_nll onehot in float64 chunk by chunk, each chunk's dW rows held to
    # both
    p_dh, p_dw = fused_ce_bwd_plain(*bargs, cast=False)
    h64, lab64, g64 = h.double(), lab.long(), g_nll.double()
    dh64 = torch.zeros_like(h64)
    dh_terms = g64[:, None] * w[lab64].double().abs()
    worst = {"plain": [0.0, 0.0, 0.0], "float64": [0.0, 0.0, 0.0]}
    for r0 in range(0, v, CE64_CHUNK):
        r1 = min(v, r0 + CE64_CHUNK)
        w64 = w[r0:r1].double()
        soft = torch.exp(h64 @ w64.T - lse64[:, None]) * g64[:, None]
        hit = (lab64 >= r0) & (lab64 < r1)
        coef = soft.clone()
        coef[hit, lab64[hit] - r0] -= g64[hit]
        dh64 += coef @ w64
        dh_terms += soft @ w64.abs()
        dw_terms = (soft.T @ h64.abs()).index_add_(
            0, lab64[hit] - r0, g64[hit, None] * h64[hit].abs())
        for what, want in (("plain", p_dw[r0:r1].double()),
                           ("float64", coef.T @ h64)):
            err = (dw[r0:r1].double() - want).abs()
            ratio = err / dw_terms.clamp(min=1e-30)
            acc = worst[what]
            acc[0] = max(acc[0], err.max().item())
            acc[1] = max(acc[1], ratio.max().item())
            acc[2] += ratio.sum().item() / (v * d)
            del want, err, ratio
        del w64, soft, coef, dw_terms
    del p_dw
    means = {"plain": GRAD_MEAN, "float64": GRAD64_MEAN}
    for what, acc in worst.items():
        check(acc[1] <= GRAD_REL and acc[2] <= means[what],
              f"{label}: fused_ce_bwd dW up to {acc[1]:.3e} (mean "
              f"{acc[2]:.3e}) of sum |terms| from {what}, allowed "
              f"{GRAD_REL:.3e} (mean {means[what]:.3e})")
    dh_err = {what: compare_terms(f"{label}: fused_ce_bwd dh against "
                                  f"{what}", dh.double(), want, dh_terms,
                                  mean_rel=means[what])
              for what, want in (("plain", p_dh.double()),
                                 ("float64", dh64))}
    log(f"{label}: fused CE pair at T {t} V {v} d {d} (g_nll 1/T, g_lse 0), "
        f"float64 in chunks of {CE64_CHUNK} rows; nll/lse from the plain "
        f"version {fwd['plain'][0]:.3e} ({fwd['plain'][1]:.3e} of a score's "
        f"sum |terms|), from float64 {fwd['float64'][0]:.3e} "
        f"({fwd['float64'][1]:.3e}; the plain version "
        f"{fwd['plain vs float64'][0]:.3e}, "
        f"{fwd['plain vs float64'][1]:.3e}; mean lse "
        f"{lse.mean().item():.3f}, mean sum |terms| "
        f"{terms.mean().item():.1f}); of sum |terms| from the plain version "
        f"dh {dh_err['plain'][1]:.3e} (mean {dh_err['plain'][2]:.3e}), dW "
        f"{worst['plain'][1]:.3e} (mean {worst['plain'][2]:.3e}), from "
        f"float64 dh {dh_err['float64'][1]:.3e} (mean "
        f"{dh_err['float64'][2]:.3e}), dW {worst['float64'][1]:.3e} (mean "
        f"{worst['float64'][2]:.3e}); two calls bit-equal [{card}]")
    return {"fused_ce_fwd": {
                "max_abs_err": fwd["plain"][0],
                "max_err_vs_float64": fwd["float64"][0],
                "max_err_over_sum_terms_vs_float64": fwd["float64"][1]},
            "fused_ce_bwd": {
                "max_abs_err": max(dh_err["plain"][0], worst["plain"][0]),
                "max_err_over_sum_terms": max(dh_err["plain"][1],
                                              worst["plain"][1]),
                "max_err_vs_float64": max(dh_err["float64"][0],
                                          worst["float64"][0]),
                "max_err_over_sum_terms_vs_float64": max(
                    dh_err["float64"][1], worst["float64"][1])}}


def train_steps(torch, card, kernels, model, state, batch, loss_name,
                n_steps, label, **train):
    """``n_steps`` of ``make_train_step`` at ``loss_name`` and the
    ``TrainConfig`` fields ``train``, each with the
    launch counts at 0: the loss finite, the fused CE kernels once a step
    under fused_ce and selfnorm and no kernel under the others. Returns
    (state, [(loss, ms)], the CE kernels' launches)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import _build
    from repro_torch.train import make_train_step
    step = make_train_step(model, TrainConfig(loss=loss_name, **train))
    want = 1 if loss_name in ("fused_ce", "selfnorm") else 0
    tokens = batch["tokens"].numel()
    out, total = [], 0
    for i in range(n_steps):
        _build.reset_counts(kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: kfn.launches for name, kfn in kernels.items()}
        check(all(counts[name] == want for name in CE_KERNELS)
              and sum(counts.values()) == 2 * want,
              f"{label} {loss_name} step {i} launched {counts}")
        total += want
        loss = metrics["loss_total"].item()
        check(math.isfinite(loss), f"{label} {loss_name} step {i}: loss "
              f"{loss}")
        out.append((loss, ms))
        log_z = metrics.get("mean_log_z", torch.tensor(float("nan")))
        log(f"{label} {loss_name} step {i}: loss {loss:.6f} (mean log Z "
            f"{log_z.item():.4f}), grad norm "
            f"{metrics['grad_norm'].item():.4f}, {ms:.1f} ms, "
            f"{tokens / ms * 1e3:.1f} tokens/s [{card}]")
    return state, out, total


def audio_phase(torch, card, kernels):
    """The audio family: full-width musicgen-medium (48 layers, d 1536, 24
    heads of 64, d_ff 6144, 4 codebooks of vocab 2048, untied, bf16,
    random weights from seed 0; nothing cut).

    1. The parameter count against the JAX package's, the peak after the
       init, the trunk's weight bytes and their read time.
    2. Serving (no retrieval state: an exact softmax a codebook): the
       captured ``generate``, 8 requests, prompt (8, 16, 4), 32 new, at
       temperature 0 and 1.0 on one captured step, each bit-equal to the
       host loop (tokens, log_prob, log_z) and launching none of the nine
       kernels; ms a step and tokens/s of both, the replay's device ms
       beside the trunk's weight read, the replay's profile and the trunk
       by kind. ``swap_index`` to new weights drops the captured step, and
       the next ``generate`` (captured again) gives a fresh engine's
       tokens on them.
    3. Training (``init_train_state`` from seed 0, B 4 x S 256 x 4
       codebooks): the fused CE pair at the first step's inputs (T 4096,
       V 8192, d 1536: the codebook head flattened, C13) against its plain
       version and float64 (``ce_pair_held``); then fused_ce and selfnorm
       3 steps each, ce, nce and sampled 2 each at TrainConfig's defaults
       (the warmup's first lrs), the loss
       finite and fused_ce's falling each step; ms a step, tokens/s, the
       peak.

    Returns (the CE kernels' launches, their worst errors by record)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.models import Model
    from repro_torch.serve import Engine, generate
    from repro_torch.train import init_train_state, losses

    dev = torch.device("cuda")
    t_phase = time.time()
    cfg = get_config(A_ARCH)
    c = cfg.n_codebooks
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated() / 1e9
    # -- 1. the model --------------------------------------------------------
    t0 = time.time()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == A_PARAMS, f"audio: {n_params} params, the JAX "
          f"package's eval_shape counts {A_PARAMS}")
    t_bytes = trunk_bytes(params, cfg)
    read_ms = t_bytes / HBM_BYTES_PER_S * 1e3
    log(f"audio: {cfg.name} layers {cfg.n_layers} d {cfg.d_model} heads "
        f"{cfg.n_heads} x {cfg.resolved_head_dim} d_ff {cfg.d_ff} "
        f"{c} codebooks of vocab {cfg.vocab} {cfg.dtype} remat {cfg.remat}, "
        f"{n_params / 1e9:.3f} B params, init {time.time() - t0:.1f} s; "
        f"{left:.3f} GB allocated before it, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB after it; a step "
        f"reads {t_bytes / 1e9:.3f} GB of trunk weights, {read_ms:.3f} ms "
        f"at the memory rate [{card}]")
    # -- 2. serving ----------------------------------------------------------
    eng = Engine(model, params, A_MAX_LEN, seed=7, device=dev)
    check(eng.state is None and eng.index is None,
          "audio engine: built a retrieval state")
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (N_REQ, A_PROMPT, c), generator=gen,
                           device=dev)
    steps = A_PROMPT + A_NEW - 1
    counted = PathCounts(torch, kernels)
    run, cap_s = capture_runner(torch, eng)
    log(f"audio engine: max_len {A_MAX_LEN}, the captured step's noise "
        f"buffer {run.gumbel.numel() * 4 / 1e6:.1f} MB ({A_MAX_LEN} x "
        f"{N_REQ} x {c} x {cfg.vocab} f32), capture {cap_s:.2f} s [{card}]")
    served = {}
    for temp in (0.0, 1.0):
        box = {}

        def wrap(fn):
            res, box["counts"], _ = counted(fn)
            return res
        (toks, aux, secs), (_, _, h_secs) = served_pair(
            torch, eng, prompt, A_NEW, f"audio generate T {temp}",
            temperature=temp, wrap=wrap)
        check(tuple(toks.shape) == (N_REQ, A_NEW, c)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"audio generate: tokens {tuple(toks.shape)}")
        check(all(bool(torch.isfinite(aux[k]).all()) for k in aux)
              and bool((aux["log_prob"] <= 1e-4).all()),
              "audio generate: log_prob or log_z not finite, or a "
              "log_prob above 0")
        check(sum(box["counts"].values()) == 0, f"audio generate launched "
              f"{box['counts']}: the audio head runs none of the kernels")
        served[temp] = toks
        log(f"audio generate: {N_REQ} requests, prompt ({N_REQ}, "
            f"{A_PROMPT}, {c}), {A_NEW} new, T {temp}: captured "
            f"{secs / steps * 1e3:.3f} ms/step ({N_REQ * A_NEW / secs:.1f} "
            f"new frames/s, {N_REQ * A_NEW * c / secs:.1f} codebook "
            f"tokens/s), host loop {h_secs / steps * 1e3:.3f} ms/step "
            f"({N_REQ * A_NEW / h_secs:.1f} frames/s), bit-equal (tokens, "
            f"log_prob, log_z) [{card}]")
    check(eng.captures == 1, f"audio: {eng.captures} captures for two "
          f"temperatures, want 1")
    replay = replay_ms(torch, run, prompt)
    n_kern = step_breakdown(torch, run, eng, params, prompt[:, 0],
                            torch.zeros((), dtype=torch.int32, device=dev),
                            card, "audio")
    log(f"audio step: replay {replay:.3f} ms device, {n_kern} kernels, "
        f"against the trunk's weight read {read_ms:.3f} ms [{card}]")
    del run
    # swap to new weights: the captured step goes, the next one serves them
    new = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    t0 = time.time()
    eng.swap_index(new)
    swap_s = time.time() - t0
    check(eng._graph_runners == {} and eng.params is new,
          "audio swap_index kept the captured step or the old params")
    got = generate(eng, prompt, A_NEW)
    fresh = Engine(model, new, A_MAX_LEN, seed=7, device=dev)
    want = generate(fresh, prompt, A_NEW)
    check(eng.captures == 2 and torch.equal(got, want)
          and not torch.equal(got, served[0.0]),
          f"audio swap_index: {eng.captures} captures, tokens equal to the "
          f"fresh engine's {torch.equal(got, want)}")
    log(f"audio swap_index: {swap_s * 1e3:.3f} ms, captured afresh, greedy "
        f"tokens equal to a fresh engine's on the new weights (and not the "
        f"old ones') [{card}]")
    del eng, fresh, params, new, got, want, served
    gc.collect()
    torch.cuda.empty_cache()
    # -- 3. training ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"audio train state: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({cfg.dtype} parameters, f32 moments) [{card}]")
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), A_TRAIN_B,
                      A_TRAIN_S, n_codebooks=c)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    with torch.no_grad():
        hidden, _ = model.forward(state.params, tokens)
        h, w, lab = losses._flatten_head(model, state.params, hidden,
                                         labels)
    held = ce_pair_held(torch, "audio", h, w, lab, card)
    del hidden, h, w, lab
    torch.cuda.empty_cache()
    launches = dict.fromkeys(CE_KERNELS, 0)
    runs = {}
    for loss_name, n in A_STEPS:
        state, runs[loss_name], n_ce = train_steps(
            torch, card, kernels, model, state, batch, loss_name, n,
            "audio")
        for name in CE_KERNELS:
            launches[name] += n_ce
    fused = [x[0] for x in runs["fused_ce"]]
    check(all(b < a for a, b in zip(fused, fused[1:])),
          f"audio fused_ce loss did not fall each step: {fused}")
    frames = A_TRAIN_B * A_TRAIN_S
    for loss_name, rows in runs.items():
        ms = statistics.median(x[1] for x in rows[1:])
        log(f"audio train {loss_name}: {ms:.1f} ms a step after the first "
            f"({frames / ms * 1e3:.1f} frames/s, "
            f"{frames * c / ms * 1e3:.1f} codebook tokens/s) [{card}]")
    log(f"audio train: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB (max_memory_allocated); the phase {time.time() - t_phase:.1f} "
        f"s [{card}]")
    return launches, held


def tied_grad_check(torch, card, model, params, tokens, labels):
    """The tied table's gradient of the fused_ce loss (both uses live)
    against the fused CE's dW (the embedding gather on a detached table)
    plus the gather's scatter (the head detached), each taken apart: equal
    within one bf16 step at each element's magnitude (the largest of the
    three)."""
    from repro_torch.train import losses
    table = params["embed"]["table"]
    table.requires_grad_(True)
    d = model.cfg.d_model

    def grad(embed_from, head_from):
        p = dict(params, embed={"table": embed_from})
        hidden, _ = model.forward(p, tokens)
        nll, _ = losses.streaming_ce(hidden.reshape(-1, d), head_from,
                                     labels.reshape(-1))
        return torch.autograd.grad(nll.mean(), table)[0]
    g_total = grad(table, table)
    g_ce = grad(table.detach(), table)
    g_emb = grad(table, table.detach())
    worst, rows = 0.0, 0
    for r0 in range(0, table.shape[0], CE64_CHUNK):
        s = slice(r0, r0 + CE64_CHUNK)
        parts = (g_total[s].float(), g_ce[s].float(), g_emb[s].float())
        mag = torch.maximum(torch.maximum(parts[0].abs(), parts[1].abs()),
                            parts[2].abs())
        step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
        err = (parts[0] - parts[1] - parts[2]).abs()
        worst = max(worst, (err / step).max().item())
        rows += int(parts[2].ne(0).any(-1).sum())
        del parts, mag, step, err
    check(worst <= 1.0, f"tied table gradient: {worst:.3f} bf16 steps from "
          f"dW + scatter, allowed 1")
    check(rows > 0 and bool(g_ce.ne(0).any()),
          "tied table gradient: one of its two parts is zero")
    log(f"gemma3 tied table gradient: the whole (bf16) within {worst:.3f} "
        f"bf16 steps of the fused CE's dW plus the gather's scatter (into "
        f"{rows} rows), taken apart [{card}]")
    del g_total, g_ce, g_emb
    table.requires_grad_(False)


def gemma3_train_phase(torch, card, kernels):
    """gemma3-4b training at full width (34 layers, d 2560, V 262144 tied,
    window 1024, bf16, random weights from seed 0, remat full: each group
    of six blocks under one checkpoint; nothing cut) through
    ``make_train_step`` with fused_ce and AdamW, B 1 x S 2048 (past the
    window, so the local layers' band masks):

    1. ``init_train_state`` (f32 moments), the count against the JAX
       package's, its memory and peak.
    2. At step 1's inputs (T 2048, V 262144, d 2560) the fused CE pair
       against its plain version and float64 (``ce_pair_held``), and the
       tied table's gradient against the fused CE's dW plus the gather's
       scatter (``tied_grad_check``).
    3. 3 fused_ce steps at TrainConfig's defaults (the warmup's first
       lrs), the loss finite and falling each step, each CE kernel once a
       step; then one more split into its parts (the optimizer apart); ms
       a step, tokens/s, the peak.

    Returns (the CE kernels' launches, their worst errors by record)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataIterator, SyntheticCorpus
    from repro_torch.models import Model
    from repro_torch.train import init_train_state

    dev = torch.device("cuda")
    t_phase = time.time()
    cfg = get_config(G_ARCH)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state = init_train_state(model, TrainConfig(), seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state.params))
    check(n_params == F_PARAMS[G_ARCH], f"gemma3 train: {n_params} params, "
          f"the JAX package's eval_shape counts {F_PARAMS[G_ARCH]}")
    log(f"gemma3 train state: {cfg.name} layers {cfg.n_layers} d "
        f"{cfg.d_model} vocab {cfg.vocab} tied, window "
        f"{cfg.sliding_window}, remat {cfg.remat}, {n_params / 1e9:.3f} B "
        f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB ({cfg.dtype} "
        f"parameters, f32 moments), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"{time.time() - t0:.1f} s [{card}]")
    it = DataIterator(SyntheticCorpus(cfg.vocab, seed=0), G_TRAIN_B,
                      G_TRAIN_S)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in next(it))
    batch = {"tokens": tokens, "labels": labels}
    w = model.head_matrix(state.params)
    with torch.no_grad():
        hidden, _ = model.forward(state.params, tokens)
    held = ce_pair_held(torch, "gemma3", hidden.reshape(-1, cfg.d_model),
                           w, labels.reshape(-1), card)
    del hidden
    torch.cuda.empty_cache()
    tied_grad_check(torch, card, model, state.params, tokens, labels)
    torch.cuda.empty_cache()
    log(f"gemma3 checks at step 1's inputs: peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    torch.cuda.reset_peak_memory_stats()
    state, rows, n_ce = train_steps(torch, card, kernels, model, state,
                                    batch, "fused_ce", G_STEPS, "gemma3")
    check(all(b[0] < a[0] for a, b in zip(rows, rows[1:])),
          f"gemma3 fused_ce loss did not fall each step: "
          f"{[round(x[0], 4) for x in rows]}")
    state, parts = fused_ce_parts(
        torch, card, model, state, TrainConfig(), batch,
        "gemma3 train")
    ms = statistics.median(x[1] for x in rows[1:])
    t = G_TRAIN_B * G_TRAIN_S
    log(f"gemma3 train: {G_STEPS} fused_ce steps of B {G_TRAIN_B} x S "
        f"{G_TRAIN_S}, {ms:.1f} ms a step after the first ({t / ms * 1e3:.1f} "
        f"tokens/s; the optimizer {parts['optimizer'][0]:.1f} ms of the "
        f"split step's {sum(x[0] for x in parts.values()):.1f}), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(max_memory_allocated over the steps); the phase "
        f"{time.time() - t_phase:.1f} s [{card}]")
    del state
    return dict.fromkeys(CE_KERNELS, n_ce), held


def _build_log(name):
    from repro_torch.kernels import _build
    return _build.build_log.get(name, "")


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. device  — the card's name and power limit (``nvidia-smi``), and the time
   to build the hand-written kernels from ``src/repro_torch/kernels/csrc``.
   Then a ``ptxas`` line (registers, static shared memory, spills of the
   redesigned kernels, from the build's ptxas report); the run fails
   unless the SASS (``cuobjdump -sass``) of every tensor-core kernel holds
   ``HGMMA`` (warpgroup tensor-core) instructions: the forward's
   ``flash_wgmma`` for bf16 and for float32 k/v (``flash_wgmma_split``),
   each of the backward's ``bwd_wgmma`` instances (``BWD_WGMMA_INSTANCES``:
   both passes at hd 32, 64 and 128, the 128-wide head-split dK/dV pass,
   and both bf16-k/v passes at hd 64), ``bwd_dq_ds`` (the dS path's dQ) and
   each of ``bwd_wide``'s seven instances (``BWD_WIDE_INSTANCES``: the two
   recomputing passes, the dS path's dK/dV pass, the head-split dK/dV pass,
   and the bf16-k/v dK/dV (whole and head-split) and dQ passes).
1b. dryrun — in child processes (each one's default process group a
   ``fake`` one of 256 ranks; ``--dryrun-child trace``, ``run`` and
   ``serve``): (a) begun before phase 1's build (fake tensors: no kernel,
   nothing on the card; ``DRYRUN_TRACE_CHILDREN`` of them, each tracing
   its share of the cells), (b) right after it, while the script's own
   process holds nothing on the card, and (c) once (b) has ended; all are
   waited for before phase 2, so that no busy host process runs beside
   the timed phases, and (b) times a cell's step only once (a) has ended,
   but the device-bound cells of ``DRYRUN_BESIDE_TRACES``, which it runs
   first.  Rank (0, 0) of the
   16 x 16 production mesh
   for ``DRYRUN_CELLS`` (every architecture's ``train_4k``: minicpm-2b,
   gemma3-4b, recurrentgemma-9b, whisper-medium, kimi-k2, qwen3-moe,
   h2o-danube-3-4b, starcoder2-3b, internvl2-2b, rwkv6-7b; gemma3-4b and
   internvl2-2b ``decode_32k``; rwkv6-7b ``prefill_32k``), its state held
   as ``local_shard``s and gathered at use, but the blocks its
   tensor-parallel products take as they are (the projections, MLPs,
   recurrences, heads and vocabulary the rules split over 'model'; a
   decode step's attention on the rank's own q heads; kimi-k2's 2 of 512
   experts a layer and qwen3-moe's 1 of 256, behind the expert-parallel
   dispatch's two all-to-alls over the joint ('data', 'model') axis): (a)
   the cells so marked traced on fake CUDA tensors (``launch.dryrun``),
   their FLOPs, wire bytes by kind, argument bytes and peak equal to the
   committed ``experiments/dryrun_torch/`` records (traced on the CPU);
   (b) every cell's rank program run for real on the card (the fake
   group's collectives move nothing, so values are not checked; its
   arguments made one leaf at a time and freed before the next cell): a
   first step, whose FLOPs (``FlopCounterMode`` alone) must equal the
   record's (a plain warm-up for the cells (a) traces: the trace holds
   their FLOPs), whose ``max_memory_allocated`` must be within
   ``DRYRUN_PEAK_TOL`` of the record's peak and under the card's memory,
   and whose flash calls by design must be ``DRYRUN_LAUNCHES``'s, its
   launches joining the counts under ``dryrun_rank``; then a second step
   timed, with the same launches; (c) the same for the MoE families'
   serving ranks (``DRYRUN_SERVE_CELLS``: qwen3-moe-235b-a22b and
   kimi-k2-1t-a32b ``prefill_32k`` and ``decode_32k`` at full width and
   depth, each FLOP-counted; their attention calls are phase 6c's
   serving rows); and the sequence-split training
   ranks' islands (``DRYRUN_ISLANDS``: q [4, 256, H, hd] over k/v [4, 4096,
   KV, hd] float32; minicpm-2b's at q_offset 0 through
   ``flash_wgmma_split`` and ``bwd_wgmma``, gemma3-4b's
   at 0 and 3840, and at 3840 on a sliding-window layer, through
   ``flash_tiled`` and ``bwd_wide``, each split where ``attn_plan.h``
   splits, ``bwd_wide`` on the dS path at full attention) against the
   plain versions, each failing them given one key too few.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (hash_partition at the join's and the
   groupby's shuffle, segment_reduce at groupby_agg's three calls), with its
   time (CUDA events behind a sleep kernel, so that they time the device
   and not the host's launches; median of repeats, L2 flushed before each
   repeat; the hash kernel, well under 0.1 ms, timed as 8-16 launches back
   to back per event pair), the plain version's time, one PyTorch library call's time
   where one computes the same function, and the bound: the larger of bytes
   moved over 3.35 TB/s and operations over the peak of the engine that
   does them (H100 SXM data sheet): 67 TFLOP/s for float32 on the CUDA
   cores, or 989 TFLOP/s for bf16 on the tensor cores times the number of
   bf16 products a design makes of each float32 product (``FLASH_SPLIT``: 3
   where only one operand is split, 6 where both are).  The summary line carries one shape per kernel; the ``kernel``
   lines carry every shape.  join_probe's positions and hits must equal the
   plain version's on every row.
3. join    — ``ops_dist.sim_join`` at the paper's weak-scaling size: P = 8
   simulated workers on the one card, 9.1M rows per worker per side
   (``benchmarks/scaling_join.py`` WEAK_ROWS), checked row by row against
   numpy.
3b. comm   — the serverless communicator on the card.  (a) Phase 3's
   tables joined again over four fabrics: all-direct Lambda (phase 3's),
   a hybrid session with 7 of the 28 pairs blocked behind a Redis relay
   (a quarter, drawn from ``--seed`` by the rule of
   ``benchmarks/hybrid_links.py``), ``redis_communicator(8)`` and
   ``s3_communicator(8)``.  Each run must give phase 3's rows bit for bit,
   launch hash_partition 16 and join_probe 8 times, and receive every
   block on the card; its line gives the modeled comm seconds, bytes on
   the wire, each event's schedule (algo, relay, relayed pairs), the
   bootstrap events and the host wall.  (b) Every collective of the
   communicator on CUDA float32 tensors of 16M elements (64 MB) per rank
   over 8 ranks (allreduce and reduce_scatter with add and max,
   allgather(v), bcast, gather, scatter, send, alltoallv, the
   non-blocking handles, ping, and a 2-colour split): results on the card,
   bit-equal to numpy on host copies folded in rank order, each rank its
   own buffer, and every event's modeled seconds equal to the same call's
   on CPU tensors of the same shapes.  (c) A world-64 session on the
   Lambda fabric (the paper's 64-node point): bootstrap, ``expand`` by 16
   Cloud Run workers, detect + ``shrink`` of 8 ranks under each recovery
   policy, ``recover_link`` (transient and permanent), ``rebootstrap_rank``,
   each modeled price printed.
4. groupby — ``ops_dist.sim_groupby`` at the paper's §IV-C size: P = 4
   workers x 50M rows over 1000 groups, ``{"v": "sum"}``, combiner on and
   off, checked against ``np.bincount``.
4b. bsp    — the paper's weak-scaling join through ``BSPRuntime`` on the
   card: per rank two Tables of 9.1M int32 rows (keys a permutation,
   capacity twice that; built once for 64 ranks, 18.6 GB), the superstep of
   ``examples/serverless_scaling.py`` (a barrier, then ``join_unique`` of the
   rank's own tables), 3 supersteps (``BSP_STEPS``) with the example's one
   injected failure, at worlds 1-64 on ``lambda-10gb``, ``ec2-15gb-4vcpu``
   and ``rivanna-10gb``.  Each run's modeled seconds (all but the measured
   compute) must equal the same run on the CPU with the example's
   2048-row tables, join_probe must launch once per rank per superstep, and
   its trace must pass ``tracecheck``.  Its line gives each run's init,
   compute (the card's time over the platform's CPU factor), comm, barrier,
   total and retries, each platform's weak-scaling ratio T(1)/T(P) and the
   Lambda-vs-EC2 gap at 64.  Then the recovery drill: world 8, 1M float64
   rows a rank on the card, checkpoints in the S3 store, a rank lost at
   superstep 1 (``recovery_policy="shrink"``), a burst of 2 workers at
   superstep 2, overlapped supersteps; the final states bit-equal to a
   clean run's, every modeled second, the store op log and the span
   timeline equal to the same drill on the CPU, and no ``tracecheck``
   violation.
4c. codec  — ``compress=True`` on the card: phase 3's join (its rows bit
   for bit, 16 hash and 8 probe launches, every encoded part on the card,
   rank 0's blocks encoding to the same kinds and wire bytes as the codec
   on host copies; per event the wire and raw bytes and their ratio, the
   host wall beside phase 3's) and phase 4's groupby, combiner on and off
   (sums equal to ``np.bincount``, segment_reduce launches equal to
   phase 4's).
4d. jobs   — the serverless executor on the card: ``etl_csv`` through
   ``JobExecutor("aws-lambda").map`` over a 1M-row two-column CSV in the
   S3 store, cut into 2 MB partitions, with one kill and one 20 s
   straggle; the Tables on the card equal the CPU parse.  A ``map_reduce``
   whose 8 tasks hash-partition slices of a join worker's keys on the card
   into the join's 8 buckets; the summed histogram equals the plain
   version's on a host copy.  At ``cpu_scale=0`` both jobs' ``JobReport``
   and span timeline equal the CPU run's; at ``cpu_scale=1`` the line gives
   the measured figures; ``tracecheck`` finds no violation.
5. kernel  — flash_attention against its plain version at the serving
   path's shapes (gemma3-4b: prefill of a local and of a global layer,
   decode of a global and of a local layer), with the same timings and
   bound (operations: 4 hd per visible (query, key) pair; bytes: q, o and
   the k/v rows some query can see; the prefill rows give both the bound
   of the tensor-core design that runs them and the float32 CUDA-core
   bound, each with its share), and
   ``scaled_dot_product_attention``'s time as the library yardstick; plus
   rows with no valid key and a softcap at a small shape; and gemma3-4b's
   global layer at 32,768 keys (q [1, 512, 8, 256] at q_offset 32,256,
   bf16 k/v [1, 32768, 4, 256]; timed, and checked again with v of mean 1,
   where |O| ~ 1).  Both sides read the same k/v, so they differ only in
   the order of float32 sums: 2e-5 for either k/v type; at each main-path
   shape the kernel must also fail that limit given one key too few.
   The same phase checks the float32-k/v forwards with each row's
   log-sum-exp, o and lse within 2e-5, failing it given one key too few,
   and bit-equal across two runs: ``flash_wgmma_split`` (the training
   path's forward) at minicpm-2b's train shape and h2o-danube-3-4b's head
   width 120 (q [1, 4096, 32, 120], k/v [1, 4096, 8, 120], window 4096;
   there also the bf16 prefill and decode designs), and ``flash_tiled`` at
   gemma3-4b's global layer (q [1, 4096, 8, 256], k/v 4 heads), each timed
   with its own bound and its float32 CUDA-core bound.  And the families'
   shapes (phase 8b), bf16 k/v, each within 2e-5, failing it given one key
   too few, timed with its bound and SDPA: whisper-medium's encoder (q/k/v
   [4, 1500, 16, 64], non-causal: ``flash_wgmma``) and its prompt's
   cross-attention (q [4, 4, 16, 64] over the 1500 frames:
   ``flash_decode``), its decoder's self-attention over the 128-position
   cache (q [4, 4, 16, 64] at kv_len 4 and [4, 1, 16, 64] at 127:
   ``flash_decode``), qwen3-moe's prefill (q [4, 2048, 64, 128] over [4,
   2080, 4, 128] at kv_len 2048: ``flash_wgmma``), recurrentgemma-9b's
   local prefill (q [4, 4096, 16, 256], k/v [4, 4096, 1, 256], window
   2048), and decode at 16 rows per kv head (``flash_wgmma``): qwen3-moe q
   [4, 1, 64, 128] over [4, 2080, 4, 128], recurrentgemma q [4, 1, 16, 256]
   over [4, 4128, 1, 256]; and the dryrun phase's tp-16 decode islands
   (``RANK_DECODE_SHAPES``, ``flash_decode``): one q head over one bf16 kv
   head of 32,768 at the last position, 8 sequences, internvl2-2b's hd 128
   and gemma3-4b's hd 256 on a global and a window-1024 layer.
6. kernel  — flash_attention_bwd (the hand-written backward) against its
   plain version (``ref.attention_bwd_ref``) from the same o and lse, at
   minicpm-2b's train shape (q/k/v [2, 4096, 36, 64], causal), gemma3-4b's
   (q [1, 4096, 8, 256], k/v 4 heads, window 1024 and 0) and h2o-danube's
   (hd 120, window 4096), plus small cases with a softcap, GQA and ragged
   tiles at every head width; within ``BWD_TOL``, and failing it given one
   key too few.  Each shape names the design that ran (``bwd_wgmma`` for
   hd <= 128, ``bwd_wide`` for hd 256, both on the bf16 tensor cores) and
   gives both bounds with their shares: the tensor-core one (10 hd
   operations per visible pair, ``BWD_SPLIT`` bf16 products each, at 989
   TFLOP/s; ``bound_ms``) and the float32 CUDA-core one (10 hd at 67
   TFLOP/s), each against the bytes.  Its time, the plain version's time
   and autograd through float32 ``scaled_dot_product_attention`` as the
   library yardstick.  Then the gradient through ``ops.flash_attention``'s
   autograd where the kernels alone do not cover the call (``cache_checks``):
   a partly filled cache (kv_len 1200 of 1536 keys: dk, dv 0 past it,
   within ``BWD_TOL`` of ``attention_bwd_ref`` at that kv_len and failing
   it given one key too few) and rows past the keys whose last 65 see none
   (against the plain forward's autograd).
6b. kernel — the families' training attention (``FAMILY_TRAIN_SHAPES``),
   each forward with lse and its backward against the plain versions from
   the same o and lse, timed as phase 6 times: recurrentgemma-9b's local
   MQA (q [1, 4096, 16, 256] over bf16 k/v [1, 4096, 1, 256], window 2048:
   ``flash_wgmma`` and ``bwd_wide``), whisper-medium's encoder (bf16 q/k/v
   [4, 1500, 16, 64], non-causal, a ragged 1500: ``flash_wgmma`` and
   ``bwd_wgmma``), its cross-attention (q [4, 448, 16, 64] over bf16 k/v [4,
   1500, 16, 64]) and its decoder's self-attention (float32, causal, [4,
   448, 16, 64]: ``flash_wgmma_split``).  6c (run last, after phase 11,
   so that the end-to-end phases run as before it): the same at a
   tensor-parallel training rank's shapes (``TP_RANK_SHAPES``: one q head a
   rank at tp 16, 4 sequences; kimi-k2's island, q [2, 4096, 4, 112] over
   float32 k/v [2, 4096, 1, 112], causal; qwen3-moe's, q [2, 4096, 4, 128]
   over [2, 4096, 1, 128] (both with ``bwd_wgmma``'s dK/dV pass in 2 head
   subsets, ``head_split/bwd_wgmma``); h2o-danube-3-4b's, q [4, 4096, 2,
   120] over [4, 4096, 1, 120], window 4096; internvl2-2b's, q [4, 4096, 1, 128] over
   one kv head; starcoder2-3b's sequence islands, q [4, 256, 24, 128] at
   q_offset 0 and 3840 over [4, 4096, 2, 128]), each backward's plan (head
   subsets, k/v parts) held to the one the cell names; and the MoE serving
   ranks' calls, forward only (``serving_row``): the rank's 4 q heads over
   kv head 0 of the bf16 cache (a strided view of every kv head), qwen3-moe
   and kimi-k2 at prefill_32k (q [2, 32768, 4, hd] over [2, 32768, 1, hd]:
   ``flash_wgmma``; the plain version on the first and the last 2,048 query
   rows, and timed over the whole call 2,048 rows at a time) and at
   decode_32k (q [8, 1, 4, hd] at q_offset 32,767 over the 32,768-position
   cache: ``flash_decode``, kimi-k2's hd 112 in the 128-wide template),
   each within 2e-5 with v of mean 0 and of mean 1, failing it given one
   key too few, timed with its bound and SDPA (k/v repeated to the q
   heads, the memory-efficient kernel).  6b and 6c also fail
   unless the limits reject the plain version given one key too few.  bf16
   k/v enter ``bwd_wide`` as they are (Griffin's, with the head split) and
   ``bwd_wgmma`` too (Whisper's encoder and cross-attention, hd 64: plan
   (1, 1)), and dk, dv come back rounded to bfloat16: held at
   ``BWD_TOL`` plus one rounding.  Each bound counts the bf16 products its
   operands need (``attn_products``: 1 for a product of two bf16 values, 3
   where one operand is one, 6 where neither is; 4.2 a product for the
   backward on bf16 k/v, 3.2 where q is a bf16 value too), and
   ``bound_ms_as_run`` those the design makes (``FLASH_SPLIT``,
   ``BWD_SPLIT``, and ``kernel.bwd_products`` of the instance that runs:
   ``bwd_wide`` and ``bwd_wgmma`` at hd 64 take bf16 k/v as they are,
   4.2).  Each backward row also
   names its plan (the head subsets of its dK/dV pass, the k/v parts) and
   gives the device ms of each pass (``BWD_PASSES``, ``torch.profiler``).
7. serve   — ``serve_step.generate`` on gemma3-4b at full width (random
   weights from ``--seed``, made on the card): B = 4 requests of 4096
   prompt tokens, 32 new tokens each, greedy.  The one run that is counted
   is also the one that is timed: each step's tokens are brought to the
   host as a server streams them, which gives the time to first token, the
   gaps between tokens (median, max) and decode tokens/s; plus its wall
   and peak device memory.  Fixed lengths: a smoke measurement, not a
   traffic mix.
8. serve_check — (a) a teacher-forced ``forward`` of request 0's prompt +
   generated tokens (no cache) against the prefill and every decode step's
   logits, and each greedy token against its step's argmax; (b) a reduced
   gemma3-4b (6 layers, one global) on the card against the plain versions
   on the CPU from the same weights.  Its weights are freed before training.
8b. families — ``serve_step.generate`` on the four other model families,
   one run each, random weights and inputs from ``--seed`` made on the card,
   each family's weights freed before the next: qwen3-moe-235b-a22b at full
   width with bfloat16 weight storage, 2 of its 94 layers (22.1 GB of
   weights), B 4 x 2048 prompt tokens + 32, capacity factor 1.25; rwkv6-7b
   (7.5B float32 parameters), B 4 x 4096 + 32; recurrentgemma-9b (10.4B
   parameters, its cast leaves in bfloat16), B 4 x 4096 + 32; whisper-medium
   (24 + 24 layers), B 4 x 1500 frames, a 4-token prompt + 124 tokens.  Each
   run is counted and timed as phase 7's (time to first token, token gaps,
   decode tokens/s, peak memory) and fails unless flash attention ran
   exactly the calls its design rule gives (``FAMILY_RUNS``: qwen3-moe 2 +
   31 x 2 and recurrentgemma 12 + 31 x 12, all ``flash_wgmma``; rwkv6 none;
   whisper 24 ``flash_wgmma`` (encoder) + 24 + 24 + 123 x 48
   ``flash_decode``); then one prefill and one decode step under the
   profiler.  ``families_check``: each family at full width and a CPU-sized
   depth (qwen3-moe 1 layer, rwkv6 2, recurrentgemma 3, whisper 2 + 2), B 2 x
   16 prompt tokens: (a) the cache-free forward on the card against the
   CPU's from the same weights (1e-4 where the model computes in float32,
   2e-2 where its activations are bfloat16); (b) the cached path's logits
   at 16 generated steps against the cache-free forward on the card (2e-2;
   RWKV's chunked prefill against its steps 3e-4), each token its step's
   argmax.  Griffin's bfloat16 logits take 2e-2 of the largest logit as the
   absolute limit; each reading prints the limit applied, and both checks
   fail unless that limit rejects the same model with its attention output
   projection zeroed.  The phase sets
   ``allow_bf16_reduced_precision_reduction`` False (Griffin and Whisper
   refuse to run on the card without it) and restores it after.
8c. families_train — the families' training at full width through
   ``make_train_step`` (AdamW at lr 3e-4, constant; C 2), 4 steps on one
   batch from ``--seed`` each (``FAMILY_TRAIN``): rwkv6-7b at 4 of its 32
   layers, B 1 x 4096; recurrentgemma-9b at 3 of its 38 (one rec, rec, attn
   group), B 1 x 4096; whisper-medium at full depth, B 4 x 448 decoder
   tokens over 1500 frames.  Each line gives the losses, the step wall
   (median of steps 2-4), tokens/s, the peak memory and the flash
   attention calls by design, and the per-kernel times of its attention
   shapes (phase 6b); the run fails unless the losses are finite and step
   4's is below step 1's, the peak is under 75 GB, and the calls by design
   are those its layers make (each layer's forward and its recompute, and
   one backward; recurrentgemma's 4 backwards on bf16 k/v with the head
   split, ``csrc/attn_plan.h``, and Whisper's 4 x 48 encoder and
   cross-attention backwards on bf16 k/v in ``bwd_wgmma``, and no other
   path of the script with either but the dryrun ranks of the same
   families); then a fifth step under the profiler (a ``trace``
   line).  ``families_train_check``: each family at ``reduced()``,
   one step on the card against the CPU from the same master weights and
   batch: the loss and each gradient (the norm of the difference against
   the CPU's) within 1e-4 where the family computes in float32 and 2e-2
   where its activations are bfloat16; and AdamW's update from the CPU's
   gradient on both sides within 1e-6 (+ 1e-6 of the weight;
   ``FAMILY_UPDATE_TOL``: a 200th of a step at lr 3e-4).
9. train   — ``launch.train.train`` on minicpm-2b at full width and depth
   (2,724,880,896 parameters, random from ``--seed``): B 2 x 4096 tokens
   from its own pipeline (``data_iter``), 6 steps with its own
   ``OptConfig`` (WSD, float32 moments) at lr 3e-4 (``TRAIN_LR``).  Each
   step's host wall ends when its loss is on the host; the median of steps
   2-6, tokens/s, the model
   FLOPs of a step as a share of the float32 CUDA-core peak (the products
   stay float32 SGEMM, as in the reference; TF32 stays refused), the loss
   per step and peak device memory.  A smoke measurement (synthetic
   corpus), not a traffic result.  It fails unless flash attention's
   forward ran exactly 6 x 40 x 2 times (each layer's forward and its
   recompute), all in ``flash_wgmma_split``, and its backward 6 x 40
   times, all in ``bwd_wgmma``.  The run carries a modeled 64-worker
   Lambda session and a span ``Tracer``: 16 Cloud Run workers join at
   step 3, the top 8 ranks are evicted at step 5; the line gives the
   burst and shrink log lines, the spans per lane, ``critical_path()``
   and the size of the written trace JSON.
10. train_check — (a) one step (``make_train_step``'s gradients, then
   ``apply_updates``) on the card against the same step on the CPU (plain
   versions), at minicpm-2b's width with 2 layers and 2 x 256 tokens, from
   the same weights and batch: loss, every gradient, the updated weights
   and moments within the stated limits; (b) the same update with int8
   moments; (c) the kill/resume drill on the card (reduced minicpm-2b, a
   ``LocalStore`` checkpoint), each call with its own modeled 8-worker
   Lambda session: 2 steps, exit, resume to 4 must give the loss trace of
   4 uninterrupted steps, bit for bit, and the resumed call must log its
   re-bootstrap through the session.
10b. reshard — the resharded ranged restore (``dist.checkpoint.
   restore_sharded`` under ``dist.sharding.param_specs``) at full width and
   ``RESHARD_LAYERS`` of 40 layers: minicpm-2b's float32 masters (random
   from ``--seed``) and AdamW state with int8 moments (made non-zero by one
   ``apply_updates`` from a seeded random gradient; no backward), 9.1 GB
   (16.4 GB at 40 layers), saved once into an ``S3Store``
   and restored onto the card: whole (``restore``), then each model coord
   of ``benchmarks/ckpt_store.py``'s (1, 4) mesh and coords
   ``PRODUCTION_COORDS`` of ``launch.mesh.make_production_mesh()`` (16 x
   16, ZeRO on).  It fails unless the full restore is the saved tree bit
   for bit, every shard is ``sharding.local_shard``'s block of it bit for
   bit and on the card, the (1, 4) shards concatenated along each leaf's
   model dim give the full tree, model 0 restored once more into a CPU
   like_tree logs the same store ops as on the card, and, on the spmd
   phase's NCCL group, ``distribute_tensor`` with ``shardings_for``'s
   placements on ``make_host_mesh(model=1)`` gives ``local_shard``'s
   tensors for a reduced minicpm-2b.  Each restore's line: host wall,
   GETs, bytes, modeled seconds and USD, and the bytes and modeled
   seconds as shares of the full restore's (no gate; the reference's plan,
   ``scripts/torch_reshard_plan.py`` prices it without data).
11. spmd   — the SPMD surface (``core/backends/direct.py`` over a
   ``DeviceMesh``) on one NCCL rank: NCCL refuses two ranks on one card,
   so the process group (a ``FileStore`` in a temporary directory) has
   world 1 and the multi-rank behaviour is the gloo tests'; the phase
   fails unless the backend is ``nccl``.  (a), right after phase 4c:
   ``join_spmd`` on one join worker's tables (9.1M rows a side), raw and
   ``compress=True``, rows equal to numpy's join; ``groupby_spmd`` on one
   groupby worker's 50M rows, combiner on and off, sums equal to
   ``np.bincount``; walls and launches.  (b), after phase 10: each tp
   rank's island of ``attention_sharded`` in turn, through the port's
   autograd: minicpm-2b's train shape (q/k/v [2, 4096, 36, 64]) at tp 8
   (36 heads do not split: the sequence split, 8 islands of 512 rows at
   q_offset 0-3584, ``bwd_wgmma``), gemma3-4b's global layer (q [1, 4096,
   8, 256], k/v 4 heads) at tp 16 (16 islands of 256, ``flash_tiled`` and
   ``bwd_wide``), and whisper-medium's cross-attention (q [4, 128, 16, 64]
   over k/v [4, 1500, 16, 64], non-causal); each forward with lse within
   2e-5 and each backward within ``BWD_TOL`` of the plain versions (from
   the kernel's own o and lse), the islands reassembled (dq concatenated,
   dk and dv summed) within the same limits of one full-length call.  The
   gemma3 islands are under one wave of SMs, so their keys split
   (``csrc/attn_plan.h``): the phase fails unless ``kernel.split_launches``
   shows each of the 15 islands that see more than 256 keys split
   (``flash_tiled``) and the first not, every one of the 16 backwards on
   the dS path (the first with one chunk), and minicpm-2b's islands neither;
   both split kernels must repeat bit-equal at the last island, whose
   backward row carries the device time of each pass (``torch.profiler``:
   the prologues, the dK/dV pass, the dQ from dS and its merge) and whose
   forward row the split kernel's and the merge's.
   (c) head width 112 at kimi-k2's attention (q [1, 4096, 64, 112], k/v 8
   heads): the bf16-k/v forward (``flash_wgmma``), the float32 training
   forward and the backward through the port's entry points, each against
   its plain version.  Every new shape of (b) and (c) is timed as phase 5
   times (its bound; the plain version; SDPA, or SDPA's autograd for a
   backward) and gets a row in the summary line, with its launches on its
   path.  (d) ``make_train_step(ctx)`` and ``make_compressed_dp_train_step``
   at world 1 on minicpm-2b (full width, ``SPMD_DP_LAYERS`` layers), 3
   steps each from the same weights and batch: step 0's losses equal, the
   parameters after 3 steps within 2 x 3 x lr of each other (the reference
   test's bound), the residual in (0, 1), peak memory under 75 GB.  (e)
   ``_moe_ep`` at world 1 on one full-width qwen3-moe layer (9.66 GB of
   padded bf16 experts), 4 x 2048 tokens, against ``_moe_local`` at 2e-4,
   forward and backward: the gradients of x, the router, wi and wo (the
   bf16-stored ones rounded once more).

After each of the join, groupby, serve and train runs, a ``trace`` line:
one more run (or step) of the same cell under ``torch.profiler``, with the
device's busy time, its idle share of the wall and the device ops that took
longest.

The launch counters of every kernel are set to 0 just before each of the
main-path runs (join, each of the comm phase's four joins, groupby, each
bsp run, the codec's join and groupbys, the jobs' map_reduce, serve, each
families run, each families_train run, train, and the spmd phase's joins,
groupbys, islands, hd 112 calls and dp steps) and read just after; a kernel
of the path that did not launch, a serve run without exactly 34 + 31 x 34
flash-attention launches, a families run without its calls by design, or a
train run without the counts above, fails the run.  Then a ``launches`` line (each counter by run: the kernels, and
flash attention's calls by design), the kernels' summary line (one row per
kernel, and for flash attention one per design the main path runs), and as
the last line ``{"ok": true, "device": {...}}``.  Any mismatch or exception
exits non-zero before that line.  Without a CUDA device, or without the
repository's ``src/`` beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
OPS_PER_S = {
    "fp32": 67e12,         # H100 SXM float32 outside the tensor cores
    "bf16_tensor": 989e12, # H100 SXM bf16 on the tensor cores, dense
}
# bf16 products per float32 product on the tensor cores: flash_wgmma splits
# q and p (bf16 k/v are exact), flash_wgmma_split and the backward split both
# operands of every product
FLASH_SPLIT = {"flash_wgmma": 3, "flash_wgmma_split": 6}


def products_needed(a_bf16: bool, b_bf16: bool) -> int:
    """bf16 products that one product of two operands needs for float32
    accuracy: 1 where both are bf16 values, 3 where one is (the other split
    in three), 6 where neither is."""
    return 1 if a_bf16 and b_bf16 else 3 if a_bf16 or b_bf16 else 6


def attn_products(q_bf16: bool, kv_bf16: bool) -> tuple[float, float]:
    """The bf16 products per float32 product, averaged over its matrix
    products, that attention's forward (S = q k^T, o = p v) and backward
    (S, dP = do v^T, dV = p^T do, dK = dS^T q, dQ = dS k) need when q and
    k/v are or are not bf16 values; p, do and dS are float32."""
    fwd = (products_needed(q_bf16, kv_bf16) + products_needed(False, kv_bf16)) / 2
    bwd = (products_needed(q_bf16, kv_bf16) + 2 * products_needed(False, kv_bf16)
           + products_needed(False, False) + products_needed(False, q_bf16)) / 5
    return fwd, bwd

JOIN_P, JOIN_ROWS = 8, int(9.1e6)            # benchmarks/scaling_join.py:50
GROUPBY_P, GROUPBY_ROWS, GROUPS = 4, int(50e6), 1000  # benchmarks/groupby_scaling.py:16-17
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW = "gemma3-4b", 4, 4096, 32
TRAIN_ARCH, TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = "minicpm-2b", 2, 4096, 6
# OptConfig's own default learning rate.  ``train``'s default (3e-3) is
# sized for its reduced config: at full width it diverges once the warmup
# reaches it (losses 12.37 -> 12.12 -> 13.90 over 6 steps on the H100).
TRAIN_LR = 3e-4
# phase 9's modeled fabric: the paper's 64-node Lambda point, 16 Cloud Run
# workers admitted at step 3, the top 8 ranks evicted at step 5
TRAIN_COMM_WORLD = 64
TRAIN_BURST_SHRINK = dict(burst_at=3, burst_world=16, burst_provider="gcp-cloudrun",
                          shrink_at=5, shrink_world=8)
# phase 3b: a quarter of the 28 pairs of the P = 8 join blocked behind a
# relay (benchmarks/hybrid_links.py FRACTIONS); the collectives at 16M float32
# elements (64 MB) per rank over 8 ranks; the lifecycle at the paper's
# 64-node point
COMM_BLOCKED_SHARE = 1.0 / 4.0
COMM_WORLD, COMM_ELEMS = 8, 16 << 20
LIFECYCLE_WORLD = 64
# the bsp phase: the paper's weak-scaling join (Tables II/III: 9.1M rows per
# worker, benchmarks/scaling_join.py:50; worlds 1-64, benchmarks/common.py:25)
# on three platforms, each run the superstep of examples/serverless_scaling.py
# with its one injected failure (superstep 0, rank 1); its CPU twin runs the
# example's 2048-row tables; the recovery drill at world 8 with 1M float64
# rows a rank
BSP_WORLDS = (1, 2, 4, 8, 16, 32, 64)
BSP_PLATFORMS = ("lambda-10gb", "ec2-15gb-4vcpu", "rivanna-10gb")
BSP_STEPS = 3
BSP_CPU_ROWS = 2048
DRILL_WORLD, DRILL_ROWS, DRILL_STEPS = 8, 1 << 20, 4
# the jobs phase: a 1M-row two-column CSV cut into 2 MB partitions; the
# map_reduce splits one join worker's keys over 8 tasks
JOBS_CSV_ROWS, JOBS_CHUNK_BYTES, JOBS_MAP_TASKS = 1_000_000, 2 << 20, 8
# the families phase: one generate per run at full width, random weights from
# --seed: (run, arch, config overrides, B, prompt tokens, new tokens, the
# flash-attention forward calls by design that the run must make).  qwen3-moe
# at 2 of its 94 layers (a layer's 256 padded experts are 9.66 GB in
# bfloat16; its dryrun ranks serve all 94); whisper over its 30 s window (1500
# frames) with a 4-token prompt, the length of its start-of-transcript sequence
FAMILY_RUNS = (
    ("qwen3_moe", "qwen3-moe-235b-a22b", {"num_layers": 2}, 4, 2048, 32,
     {"flash_wgmma": 2 + 31 * 2}),
    ("rwkv6", "rwkv6-7b", {}, 4, 4096, 32, {}),
    ("recurrentgemma", "recurrentgemma-9b", {}, 4, 4096, 32,
     {"flash_wgmma": 12 + 31 * 12}),
    ("whisper", "whisper-medium", {}, 4, 4, 124,
     {"flash_wgmma": 24, "flash_decode": 24 + 24 + 123 * 48}),
)
# families_check: each family at full width and a depth the CPU runs, a
# 16-token prompt and 16 new tokens (RWKV's forward takes whole chunks of 16)
FAMILY_CHECK = (("qwen3-moe-235b-a22b", {"num_layers": 1}), ("rwkv6-7b", {"num_layers": 2}),
                ("recurrentgemma-9b", {"num_layers": 3}),
                ("whisper-medium", {"num_layers": 2, "encoder_layers": 2}))
FAMILY_CHECK_B, FAMILY_CHECK_PROMPT, FAMILY_CHECK_NEW = 2, 16, 16
# the families_train phase: make_train_step (AdamW at TRAIN_LR, constant, C 2)
# on one fixed batch from --seed, FAMILY_TRAIN_STEPS steps per family at full
# width: (run, arch, config overrides, B, tokens, the attention calls by
# design the run must make).  rwkv6-7b at 4 of its 32 layers, recurrentgemma
# at 3 of its 38 (one rec, rec, attn group), whisper-medium at full depth over
# its 1500 frames with openai/whisper's n_text_ctx of 448 decoder tokens.
# Each layer runs forward and, under remat, again in the backward: per step
# recurrentgemma 2 flash_wgmma (bf16 k/v) + 1 bwd_wide, on bf16 k/v with its
# 16-head group split over the SMs (attn_plan.h: 2 subsets); whisper 24 x 2
# encoder + 24 x 2 cross flash_wgmma, 24 x 2 decoder flash_wgmma_split
# (float32 k/v), 72 bwd_wgmma, the encoder's and the cross-attention's 48 of
# them on bf16 k/v as they are (bwd_wgmma's hd-64 bf16-k/v instances)
FAMILY_TRAIN_STEPS = 4
FAMILY_TRAIN = (
    ("rwkv6", "rwkv6-7b", {"num_layers": 4}, 1, 4096, {}),
    ("recurrentgemma", "recurrentgemma-9b", {"num_layers": 3}, 1, 4096,
     {"flash_wgmma": 4 * 2, "bwd_wide": 4, "head_split/bwd_wide": 4, "bf16_kv/bwd_wide": 4}),
    ("whisper", "whisper-medium", {}, 4, 448,
     {"flash_wgmma": 4 * 96, "flash_wgmma_split": 4 * 48, "bwd_wgmma": 4 * 72,
      "bf16_kv/bwd_wgmma": 4 * 48}),
)
# the one-step card-vs-CPU check at reduced(): loss and every gradient (the
# norm of the difference against the CPU gradient's) within 1e-4 where the
# family computes in float32, 2e-2 where its activations are bfloat16 (its
# products round to bfloat16 in another order on the card)
FAMILY_TRAIN_CHECK_B, FAMILY_TRAIN_CHECK_T = 2, 64
# AdamW's update on the card from the CPU's gradient against the CPU's
# (absolute, and relative to the weight): float32 rounding only
FAMILY_UPDATE_TOL = 1e-6
# the families' training attention shapes (bf16 k/v but Whisper's decoder):
# (cell, q, k/v, kv dtype, mask, the path that launches it, whether q holds
# bf16 values, the backward's plan (head subsets, k/v parts) the cell must
# take or None)
FAMILY_TRAIN_SHAPES = (
    ("griffin_local_train", (1, 4096, 16, 256), (1, 4096, 1, 256), "bfloat16",
     dict(causal=True, window=2048), "families_train/recurrentgemma", False, None),
    ("whisper_encoder_train", (4, 1500, 16, 64), (4, 1500, 16, 64), "bfloat16",
     dict(causal=False, window=0), "families_train/whisper", True, (1, 1)),
    ("whisper_cross_train", (4, 448, 16, 64), (4, 1500, 16, 64), "bfloat16",
     dict(causal=False, window=0), "families_train/whisper", False, (1, 1)),
    ("whisper_self_train", (4, 448, 16, 64), (4, 448, 16, 64), "float32",
     dict(causal=True, window=0), "families_train/whisper", False, None),
)
# the same for a training rank of the 16 x 16 mesh whose tensor-parallel
# products leave it one q head (tp 16; kimi-k2's four), a microbatch of 4
# sequences (kimi-k2's 2): the
# recurrentgemma-9b train_4k rank's local MQA (its q the float32 value of
# bf16, over the whole bf16 kv head: flash_wgmma, and bwd_wide with neither
# head subsets, a group of one, nor the dS path, its dQ grid of 256 blocks
# filling a wave: bf16 k/v as they are), and whisper-medium train_4k's
# encoder, decoder self- and cross-attention (bwd_wgmma; the encoder's and
# the cross-attention's on bf16 k/v as they are), as the dryrun
# phase's recurrentgemma-9b, whisper-medium and kimi-k2 ranks run them
TP_RANK_SHAPES = (
    ("griffin_rank_train", (4, 4096, 1, 256), (4, 4096, 1, 256), "bfloat16",
     dict(causal=True, window=2048), "dryrun_rank", True, (1, 1)),
    ("whisper_rank_encoder", (4, 1500, 1, 64), (4, 1500, 1, 64), "bfloat16",
     dict(causal=False, window=0), "dryrun_rank", True, (1, 1)),
    ("whisper_rank_self", (4, 4096, 1, 64), (4, 4096, 1, 64), "float32",
     dict(causal=True, window=0), "dryrun_rank", False, (1, 3)),
    ("whisper_rank_cross", (4, 4096, 1, 64), (4, 1500, 1, 64), "bfloat16",
     dict(causal=False, window=0), "dryrun_rank", False, (1, 1)),
    # kimi-k2 train_4k's expert-parallel rank: the head plan's island, 4 of
    # 64 q heads over kv head 0 of 8 (float32 products), 2 sequences a
    # microbatch: flash_wgmma_split (hd 112 in the 128-wide template), bwd_wgmma
    # with its dK/dV pass's 4 heads in 2 subsets (128 causal blocks in one wave)
    ("kimi_rank_train", (2, 4096, 4, 112), (2, 4096, 1, 112), "float32",
     dict(causal=True, window=0), "dryrun_rank", False, (2, 3)),
    # qwen3-moe train_4k's expert-parallel rank: 4 of 64 q heads over kv head
    # 0 of 4, hd 128, 2 sequences a microbatch; h2o-danube-3-4b's head plan,
    # 2 of 32 q heads over kv head 0 of 8 at hd 120 (the 128-wide
    # template), its window of 4096 on every layer; internvl2-2b's, 1 of 16
    # q heads over kv head 0 of 8 (its 256-patch prefix inside the 4096);
    # starcoder2-3b's sequence plan (24 heads do not split over 16): rows
    # [q_offset, q_offset + 256) of 4096, every head, over both kv heads, at
    # model rank 0 and 15 (the most keys).  All float32: flash_wgmma_split
    # and bwd_wgmma, qwen3-moe's with kimi-k2's 2 head subsets
    ("qwen3_rank_train", (2, 4096, 4, 128), (2, 4096, 1, 128), "float32",
     dict(causal=True, window=0), "dryrun_rank", False, (2, 3)),
    ("h2o_rank_train", (4, 4096, 2, 120), (4, 4096, 1, 120), "float32",
     dict(causal=True, window=4096), "dryrun_rank", False, (1, 3)),
    ("internvl2_rank_train", (4, 4096, 1, 128), (4, 4096, 1, 128), "float32",
     dict(causal=True, window=0), "dryrun_rank", False, (1, 3)),
    ("starcoder2_rank_seq0", (4, 256, 24, 128), (4, 4096, 2, 128), "float32",
     dict(causal=True, window=0, q_offset=0), "dryrun_rank", False, (1, 3)),
    ("starcoder2_rank_seq3840", (4, 256, 24, 128), (4, 4096, 2, 128), "float32",
     dict(causal=True, window=0, q_offset=3840), "dryrun_rank", False, (1, 3)),
    # the MoE families' serving ranks (DRYRUN_SERVE_CELLS), forward only (a
    # row whose mask names kv_len; its last field the cache's kv heads): the
    # rank's 4 q heads (float32) over kv head 0 of the bf16 cache, the
    # strided view of a cache of every kv head that the prefill and
    # transformer._decode_heads hand the kernel; flash_wgmma at prefill_32k
    # (2 sequences of 32,768 rows, 131,072 rows per kv head), flash_decode at
    # decode_32k (8 sequences at the last of 32,768 positions; kimi-k2's hd
    # 112 in the 128-wide template with a run-time width)
    ("qwen3_rank_prefill", (2, 32768, 4, 128), (2, 32768, 1, 128), "bfloat16",
     dict(causal=True, window=0, q_offset=0, kv_len=32768), "dryrun_rank", False, 4),
    ("qwen3_rank_decode", (8, 1, 4, 128), (8, 32768, 1, 128), "bfloat16",
     dict(causal=True, window=0, q_offset=32767, kv_len=32768), "dryrun_rank", False, 4),
    ("kimi_rank_prefill", (2, 32768, 4, 112), (2, 32768, 1, 112), "bfloat16",
     dict(causal=True, window=0, q_offset=0, kv_len=32768), "dryrun_rank", False, 8),
    ("kimi_rank_decode", (8, 1, 4, 112), (8, 32768, 1, 112), "bfloat16",
     dict(causal=True, window=0, q_offset=32767, kv_len=32768), "dryrun_rank", False, 8),
)
# a serving row's plain version runs this many query rows at a time: its
# first and last such block are held against the kernel (the last rows see
# the most keys), and the whole call is timed block by block (a prefill
# rank's 32,768 rows would take 2 x 4 x 32,768^2 float32 scores, 34 GB)
PLAIN_ROWS = 2048
# the decode islands of the dryrun phase's decode_32k ranks, tp 16: one q
# head a rank (float32) over the bf16 kv head it maps to, 8 sequences at the
# 32,768-position cache's last position: internvl2-2b's (hd 128, 24 a step)
# and gemma3-4b's (hd 256) on a global layer (5 a step) and a window-1024
# layer (29); flash_decode, held with phase 5's shapes
RANK_DECODE_SHAPES = (
    ("internvl2_rank_decode", (8, 1, 1, 128), (8, 32768, 1, 128),
     dict(causal=True, window=0, q_offset=32767, kv_len=32768)),
    ("gemma3_rank_decode_global", (8, 1, 1, 256), (8, 32768, 1, 256),
     dict(causal=True, window=0, q_offset=32767, kv_len=32768)),
    ("gemma3_rank_decode_local", (8, 1, 1, 256), (8, 32768, 1, 256),
     dict(causal=True, window=1024, q_offset=32767, kv_len=32768)),
)
# dk and dv of bf16 k/v come back rounded to bfloat16: BWD_TOL of their
# float32 values plus one rounding (half an ulp is 2^-9 of the value)
BF16_ROUND = 2.0**-8
# the spmd phase: one NCCL rank (NCCL refuses two ranks on one card); the
# islands of attention_sharded at the training shapes (minicpm-2b's 36 heads
# do not split over tp 8: the sequence split, 8 islands of 512 rows;
# gemma3-4b's global layer over tp 16: 16 of 256) and whisper-medium's
# cross-attention (its decoder's 128 positions over the 1500 frames); the
# dp steps on minicpm-2b at SPMD_DP_LAYERS of its 40 layers; one qwen3-moe
# layer through the expert-parallel dispatch
SPMD_ISLANDS = (("minicpm_seq_tp8", TRAIN_ARCH, TRAIN_B, 8),
                ("gemma3_global_seq_tp16", "gemma3-4b", 1, 16))
SPMD_CROSS = ("whisper-medium", 4, 128, 1500)   # arch, B, decoder positions, frames
SPMD_DP_LAYERS, SPMD_DP_STEPS = 8, 3
SPMD_MOE_B, SPMD_MOE_T = 4, 2048
SPMD_PG_TIMEOUT_S = 300
# phase 10b: the production mesh's shards restored (first, middle, last), of
# minicpm-2b's state at RESHARD_LAYERS of its 40 layers (full width)
PRODUCTION_COORDS = ((0, 0), (7, 11), (15, 15))
RESHARD_LAYERS = 20
# the attention backward's kernels by pass (profiler names, first match
# wins): the prologues, the dS path's dQ and its merge, the head split's
# dK/dV merge, the recomputing dQ pass (bwd_wide<true, ...>, bwd_wgmma<HD,
# true>), the dK/dV pass (the rest: bwd_wide<false, ...>, bwd_wgmma<HD,
# false>)
BWD_PASSES = {"prologues": ("bwd_prep",), "dq_from_ds": ("bwd_dq_ds",),
              "dq_merge": ("bwd_dq_merge",), "dkdv_merge": ("bwd_kv_merge",),
              "dq_recompute": ("bwd_wide<true", "32, true", "64, true", "128, true"),
              "dkdv": ("bwd_wide<false", "bwd_wgmma<")}
# bwd_wide's instances as their mangled template arguments <DQ, DS, HS, KV1>:
# the recomputing dK/dV and dQ passes, the dS path's dK/dV pass, the
# head-split dK/dV pass, and on bf16 k/v the dK/dV pass (whole and split)
# and the dQ pass
BWD_WIDE_INSTANCES = ("ILb0ELb0ELb0ELb0E", "ILb1ELb0ELb0ELb0E", "ILb0ELb1ELb0ELb0E",
                      "ILb0ELb0ELb1ELb0E", "ILb0ELb0ELb0ELb1E", "ILb0ELb0ELb1ELb1E",
                      "ILb1ELb0ELb0ELb1E")
# bwd_wgmma's instances <HD, DQ, HS, KV1>: both passes at hd 32, 64 and 128,
# the 128-wide head-split dK/dV pass, and at hd 64 on bf16 k/v both passes
BWD_WGMMA_INSTANCES = tuple(
    f"ILi{hd}ELb{dq}ELb{hs}ELb{kv1}E"
    for hd, dq, hs, kv1 in ((32, 0, 0, 0), (32, 1, 0, 0), (64, 0, 0, 0), (64, 1, 0, 0),
                            (128, 0, 0, 0), (128, 1, 0, 0), (128, 0, 1, 0), (64, 0, 0, 1),
                            (64, 1, 0, 1)))
# every path runs at its full size and depth but these
# the dryrun phase: one rank, (0, 0), of the 16 x 16 production mesh under a
# fake process group, each cell (arch, shape, whether it is also traced on
# fake CUDA tensors and held against its experiments/dryrun_torch/ record,
# traced on the CPU; rwkv6-7b prefill_32k's trace alone took 206 s there,
# kimi-k2 train_4k's 162 s) run once for real; the real run's FLOPs must
# equal the record's and its peak be within DRYRUN_PEAK_TOL of the record's
# estimate.  kimi-k2's rank holds 2 of the 512 padded experts a layer and
# qwen3-moe's 1 of 256 (128 live), each behind the expert-parallel dispatch
# over the joint ('data', 'model') axis.  Every architecture's train_4k rank
# runs (qwen3-moe's CPU trace took 218 s, rwkv6-7b's 523 s)
DRYRUN_CELLS = (("kimi-k2-1t-a32b", "train_4k", False),
                ("qwen3-moe-235b-a22b", "train_4k", False),
                ("minicpm-2b", "train_4k", True), ("gemma3-4b", "train_4k", True),
                ("gemma3-4b", "decode_32k", True), ("internvl2-2b", "decode_32k", True),
                ("recurrentgemma-9b", "train_4k", True), ("rwkv6-7b", "prefill_32k", False),
                ("whisper-medium", "train_4k", False), ("h2o-danube-3-4b", "train_4k", True),
                ("starcoder2-3b", "train_4k", True), ("internvl2-2b", "train_4k", True),
                ("rwkv6-7b", "train_4k", False))
# the MoE families' serving ranks, each at full width and depth, in a dryrun
# child of their own (``--dryrun-child serve``) that starts when the run
# child has ended: qwen3-moe-235b-a22b and kimi-k2-1t-a32b prefill_32k (2
# sequences of 32,768 a rank) and decode_32k (8 sequences over a 32,768-position
# bf16 cache of every kv head: 54.15 / 68.29 GB of arguments), each behind the
# expert-parallel dispatch (a decode step pads its 8 tokens to the replicated
# 'model' axis's 16); not traced on fake CUDA tensors (their CPU records are
# the estimates), so each counts its FLOPs on the card
DRYRUN_SERVE_CELLS = (("qwen3-moe-235b-a22b", "prefill_32k", False),
                      ("qwen3-moe-235b-a22b", "decode_32k", False),
                      ("kimi-k2-1t-a32b", "prefill_32k", False),
                      ("kimi-k2-1t-a32b", "decode_32k", False))
# each cell's flash-attention calls by design in one step (the timed one):
# a training rank's layers x microbatches x (forward, recompute) forwards
# and layers x microbatches backwards; a prefill's or a decode step's one
# call a layer
DRYRUN_LAUNCHES = {
    "minicpm-2b/train_4k": {"flash_wgmma_split": 40 * 4 * 2, "bwd_wgmma": 40 * 4},
    "gemma3-4b/train_4k": {"flash_tiled": 34 * 4 * 2, "bwd_wide": 34 * 4},
    "gemma3-4b/decode_32k": {"flash_decode": 34},
    "internvl2-2b/decode_32k": {"flash_decode": 24},
    "recurrentgemma-9b/train_4k": {"flash_wgmma": 12 * 4 * 2, "bwd_wide": 12 * 4},
    "rwkv6-7b/prefill_32k": {},
    # the encoder and cross-attention (bf16 k/v) and the decoder's self-attention
    "whisper-medium/train_4k": {"flash_wgmma": 2 * 24 * 4 * 2, "flash_wgmma_split": 24 * 4 * 2,
                                "bwd_wgmma": 3 * 24 * 4},
    "kimi-k2-1t-a32b/train_4k": {"flash_wgmma_split": 61 * 8 * 2, "bwd_wgmma": 61 * 8},
    "qwen3-moe-235b-a22b/train_4k": {"flash_wgmma_split": 94 * 8 * 2, "bwd_wgmma": 94 * 8},
    "h2o-danube-3-4b/train_4k": {"flash_wgmma_split": 24 * 4 * 2, "bwd_wgmma": 24 * 4},
    "starcoder2-3b/train_4k": {"flash_wgmma_split": 30 * 4 * 2, "bwd_wgmma": 30 * 4},
    "internvl2-2b/train_4k": {"flash_wgmma_split": 24 * 4 * 2, "bwd_wgmma": 24 * 4},
    "rwkv6-7b/train_4k": {},
    "qwen3-moe-235b-a22b/prefill_32k": {"flash_wgmma": 94},
    "qwen3-moe-235b-a22b/decode_32k": {"flash_decode": 94},
    "kimi-k2-1t-a32b/prefill_32k": {"flash_wgmma": 61},
    "kimi-k2-1t-a32b/decode_32k": {"flash_decode": 61},
}
# the rank-(0, 0) training islands held against the plain versions: (arch,
# q_offset, on a sliding-window layer) with the designs the path runs (the
# hd-256 islands: flash_tiled and bwd_wide, each split where
# csrc/attn_plan.h splits it; bwd_wide's split is the dS path, whose dQ pass
# is bwd_dq_ds, and the full-attention islands must take it); q [4, 256, H,
# hd] over k/v [4, 4096, KV, hd] float32, the 4 sequences of a microbatch,
# tp 16's sequence split.  gemma3-4b: five of six layers slide a 1024 window.
# starcoder2-3b's islands (the same plan) are TP_RANK_SHAPES rows
DRYRUN_ISLANDS = (("minicpm-2b", 0, False, "flash_wgmma_split", "bwd_wgmma"),
                  ("gemma3-4b", 0, False, "flash_tiled", "bwd_wide"),
                  ("gemma3-4b", 3840, False, "flash_tiled", "bwd_wide"),
                  ("gemma3-4b", 3840, True, "flash_tiled", "bwd_wide"))
DRYRUN_COORDS = {"data": 0, "model": 0}
# the cells whose backwards split the GQA group's heads in bwd_wgmma's dK/dV
# pass (attn_plan.h: the causal GQA-4 islands, TP_RANK_SHAPES' (2, 3))
DRYRUN_HEAD_SPLIT = ("kimi-k2-1t-a32b/train_4k", "qwen3-moe-235b-a22b/train_4k")
# the backwards of the dry-run ranks' timed steps that take bf16 k/v as they
# are in bwd_wgmma's hd-64 instances: whisper-medium/train_4k's encoder and
# cross-attention, 24 layers each, 4 microbatches (its decoder's k/v are
# float32); no other cell's
DRYRUN_BF16_KV_WGMMA = 2 * 24 * 4
# the cells whose timed step may run beside the fake-CUDA traces, first in
# DRYRUN_CELLS: device-bound (float32 products at ~36 TFLOP/s; 45.7-46.4 s
# a kimi-k2 step whether or not the traces ran beside it).  Every other
# cell's step is host-bound in part and is timed only after the traces end
DRYRUN_BESIDE_TRACES = ("kimi-k2-1t-a32b/train_4k", "qwen3-moe-235b-a22b/train_4k")
# the fake-CUDA traces run in this many children side by side, each taking
# every DRYRUN_TRACE_CHILDREN-th marked cell: one child tracing all eight
# traced for 396 s of DRYRUN_TIMEOUT_S on an H100 machine's host beside the
# run child (40-117 s a cell there), and a slower host's traces took 1.2x
DRYRUN_TRACE_CHILDREN = 2
DRYRUN_PEAK_TOL = 0.10
DRYRUN_TIMEOUT_S = 600
# float elements a rank's random leaf is drawn in at a time (1 GB of float32)
DRYRUN_MAKE_SLICE = 1 << 28

SIZE_CUTS: list[str] = [
    "bsp: 3 supersteps a run (the paper's 10 iterations; benchmarks/time_composition.py "
    "runs 3)",
    "families: qwen3-moe-235b-a22b at 2 of its 94 layers (full width, bf16 storage: "
    "~22 GB of weights; the dryrun phase serves it at full depth)",
    "spmd: one rank (world 1 on NCCL: NCCL refuses two ranks on one card; the multi-rank "
    "behaviour is the gloo tests')",
    f"spmd (d): minicpm-2b at {SPMD_DP_LAYERS} of its 40 layers, {SPMD_DP_STEPS} steps per dp "
    "step (at 40 the compressed step's residual adds 10.9 GB to the train phase's 70 GB "
    "peak; 8 keeps the phase near a minute)",
    "spmd (e): qwen3-moe-235b-a22b at 1 of its 94 layers (9.66 GB of padded bf16 experts)",
    f"reshard: minicpm-2b's training state at {RESHARD_LAYERS} of its 40 layers (full width; "
    "the restores' host walls, ~100 s at 40, kept the script inside its time limit)",
    "families_train: rwkv6-7b at 4 of its 32 layers, recurrentgemma-9b at 3 of its 38 (one "
    "rec, rec, attn group; its 2.75B parameters hold 44 GB of float32 state), "
    f"{FAMILY_TRAIN_STEPS} steps each on one batch",
]

# flash attention against its plain version: both read the same k/v (bfloat16
# converts to float32 exactly) and compute in float32, so they differ only in
# the order of float32 sums: 2e-5, absolute plus relative, for either k/v
# type.  A key too many or too few at a mask edge moves an output by ~1e-3.
# The serving path's logits: 2e-2 between the
# cached path (k/v rounded to bfloat16) and a cache-free forward, as the
# reference's own decode test holds them (tests/test_models.py:73); card
# against CPU 1e-4 where nothing is rounded to bfloat16 (float32 sums in
# another order), and 2e-2 through the bfloat16 cache, where float32 k/v
# a few ulps apart (cuBLAS against the CPU's matmul) can round to
# neighbouring bfloat16 values.
FLASH_TOL = 2e-5
SERVE_LOGIT_TOL = 2e-2
REDUCED_F32_TOL = 1e-4
# families_check: RWKV's prefill (chunks of 16) against its decode steps (chunk
# 1): float32 sums in another order, the reference's own chunk-invariance
# limit (tests/test_models.py:95).  Griffin's logits are bfloat16: there the
# absolute part of 2e-2 is taken of the largest logit (its products round to
# bfloat16 in another order on the card than on the CPU, as the port's and
# the reference's do; tests/test_torch_families.py).
RWKV_STEP_TOL = 3e-4
# the backward kernel against its plain version from the same o and lse:
# both float32, sums in another order, dk and dv sum up to T x groups terms:
# 1e-4 absolute plus relative.  One key too few moves some gradient by
# ~1e-3 or more.
BWD_TOL = 1e-4
# train_check, card against CPU (cuBLAS against the CPU's float32 products):
# loss 1e-5 relative; gradients of float32 leaves 1e-4 of the leaf's largest
# plus relative; bf16-rounded gradients (every matrix weight: the in-graph
# cast's transpose rounds them) each within one bf16 ulp (2^-7 relative; a
# tied embedding, the sum of two rounded terms, within one ulp of the leaf's
# largest) and >= 99% bit-equal; updated weights within 2 lr (a flipped
# update sign where |g| is tiny) and >= 99.9% within 2 bf16 ulps of lr.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_TOL = 1e-4
BF16_ULP = 2.0**-7

INT32_MAX = 2**31 - 1
# float32 segment sum over rows in [0, 1): a sum whose longest chain of
# float additions has m links errs by at most m * 2**-24 of the total.  The
# plain version (index_add_ atomics) chains up to 50k rows per segment
# (<= 3e-3); the kernel chains 185 warp steps of a 5-level shuffle tree and
# ~10 atomic flushes per segment (<= 1.2e-5).
SEGSUM_F32_RTOL_VS_PLAIN = 4e-3
SEGSUM_F32_RTOL_VS_EXACT = 2e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each repeat.

    ``ms(fn)`` times one launch per event pair.  ``ms(f0, f1, ...)`` launches
    all of them back to back inside one event pair and divides by their
    number: for kernels of well under 0.1 ms, whose single-launch times
    spread by tens of percent.  The callables then work on distinct copies
    of the inputs, so each launch still reads its inputs from HBM.  A sleep
    kernel queued ahead of the start event (~10 ms) keeps the device busy
    while the host enqueues the timed calls, so the pair measures the
    device's time and not the host's rate of launching."""

    SLEEP_CYCLES = 20_000_000

    def __init__(self, torch, reps: int = 10):
        self.torch = torch
        self.reps = reps
        self.scratch = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, *fns) -> float:
        torch = self.torch
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.scratch.zero_()  # 128 MB > the 50 MB L2
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start.record()
            for fn in fns:
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(fns))
        return statistics.median(times)


def bound(nbytes: int, ops: int, engine: str = "fp32", split: int = 1) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``ops`` operations on
    ``engine``, which makes ``split`` products of its type per operation."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = split * ops / OPS_PER_S[engine] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    import os
    import shutil

    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    try:
        import triton

        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.isfile(c):
            return c
    fail("cuobjdump not found: the prefill kernel's SASS cannot be checked")


def sass_count(lib: Path, kernel: str, opcode: str) -> dict[str, int]:
    """For each function of ``lib`` whose mangled name holds ``kernel``, how
    many of its SASS instructions are ``opcode``."""
    out = subprocess.run([find_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    found: dict[str, int] = {}
    for section in out.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if kernel in name:
            found[name] = section.count(opcode)
    return found


def sass_has(lib: Path, kernel: str, opcode: str) -> dict[str, bool]:
    """For each function of ``lib`` whose mangled name holds ``kernel``,
    whether its SASS holds ``opcode``."""
    return {name: n > 0 for name, n in sass_count(lib, kernel, opcode).items()}


def rotating(fn, copies: list, launches: int) -> list:
    """``launches`` calls of ``fn``, cycling over the input ``copies``."""
    return [lambda c=copies[i % len(copies)]: fn(c) for i in range(launches)]


def trace(torch, fn, top: int = 8, groups: dict[str, tuple[str, ...]] | None = None) -> dict:
    """One more run of ``fn`` under ``torch.profiler``: its host wall, the
    device's busy time (the union of kernel, memcpy and memset intervals),
    the idle share of the wall, and the device ops that took longest.  With
    ``groups`` (label -> name substrings, first match wins, "" matches
    all), also the device ms and op count of each group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end  # microseconds
        spans.append((start, end))
        agg = by_name.setdefault(ev.name[:100], [0.0, 0])
        agg[0] += (end - start) / 1e3
        agg[1] += 1
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"wall_s": wall, "device_ops": len(spans), "device_busy_s": busy_us / 1e6,
           "idle_share": 1.0 - busy_us / 1e6 / wall,
           "top_ms": [[name, ms, n] for name, (ms, n) in ranked]}
    if groups:
        sums = {g: [0.0, 0] for g in groups}
        for name, (ms, n) in by_name.items():
            g = next(g for g, keys in groups.items() if any(k in name for k in keys))
            sums[g][0] += ms
            sums[g][1] += n
        out["by_group_ms"] = sums
    return out


def counters(hp_k, jp_k, sr_k, fa_k) -> dict[str, int]:
    return {
        # the row-bucket entry (every shuffle) and the single-column one
        # (hash32: the pipeline's content hash)
        "hash_partition": hp_k.launches + hp_k.single_launches,
        "join_probe": jp_k.launches,
        "segment_reduce": sr_k.launches,
        "flash_attention": fa_k.launches,
        "flash_attention_bwd": fa_k.bwd_launches,
        # the calls of each flash design (each also counted above)
        **{f"flash_attention/{d}": n for d, n in fa_k.fwd_design_launches.items()},
        **{f"flash_attention_bwd/{d}": n for d, n in fa_k.bwd_design_launches.items()},
        # the calls that took the key split (flash_tiled: more than one
        # chunk; bwd_wide: the dS path), the head split (the dK/dV pass) and
        # bf16 k/v as they are, by design
        **{f"key_split/{d}": n for d, n in fa_k.split_launches.items()},
        **{f"head_split/{d}": n for d, n in fa_k.head_split_launches.items()},
        **{f"bf16_kv/{d}": n for d, n in fa_k.bf16_kv_launches.items()},
    }


def reset_counters(hp_k, jp_k, sr_k, fa_k) -> None:
    hp_k.launches = hp_k.single_launches = 0
    jp_k.launches = 0
    sr_k.launches = 0
    fa_k.launches = 0
    fa_k.bwd_launches = 0
    for designs in (fa_k.fwd_design_launches, fa_k.bwd_design_launches, fa_k.split_launches,
                    fa_k.head_split_launches, fa_k.bf16_kv_launches):
        for design in designs:
            designs[design] = 0


def pass_ms(torch, timer, fn, groups, reps=5) -> dict:
    """Device ms of each group of kernels (label -> name substrings, first
    match wins) in one call of ``fn``, and its launches per call:
    ``torch.profiler`` over ``reps`` calls, L2 flushed before each, the
    mean.  Late in this script's process a short session has kept only its
    last kernels (3 of 5 calls missing on an H100), so 64 tiny kernels and a
    sleep kernel lead; where the launches per call still come out
    fractional, the times are not kept ("not measured")."""
    filler = torch.zeros(1, device="cuda")

    def run():
        for _ in range(64):
            filler.add_(1.0)
        torch.cuda._sleep(Timer.SLEEP_CYCLES)
        for _ in range(reps):
            timer.scratch.zero_()  # 128 MB > the 50 MB L2
            fn()
    t = trace(torch, run, groups={**groups, "other": ("",)})
    out = {g: {"ms": ms / reps, "launches": n / reps}
           for g, (ms, n) in t["by_group_ms"].items() if g != "other"}
    seen = [row["launches"] * reps for row in out.values()]
    if not sum(seen) or any(n % reps for n in seen):
        return {"not measured": f"the profiler kept a fraction of the launches: {out}"}
    return out


def flash_work(torch, q, k, *, causal, window, q_offset, kv_len) -> tuple[int, int]:
    """(bytes, operations) one flash-attention call must move and do: q read
    and o written once (float32), k and v read once over the keys some
    query can see, 4 hd operations per visible (query, key) pair; a row that
    sees no key averages all Tk.  Counted from the plain version's mask."""
    from repro_torch.kernels.flash_attention import ref as fa_r

    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    mask = fa_r.key_mask(tq, tk, causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv_len, device=q.device)
    per_row = mask.sum(1)
    pairs = int(torch.where(per_row > 0, per_row, tk).sum()) * b * h
    keys = tk if bool((per_row == 0).any()) else int(mask.any(0).sum())
    nbytes = 2 * q.numel() * 4 + 2 * b * kvh * hd * keys * k.element_size()
    return nbytes, 4 * hd * pairs


def flash_bwd_bytes(q, k, lse, mask) -> int:
    """Bytes one flash-attention backward must move: q, o and dO read and dQ
    written (float32), k and v read over the keys some query can see (all
    Tk where a row sees none, as ``flash_work``), dK and dV written whole
    in k's type, lse read.  ``mask`` is the plain version's [Tq, Tk]."""
    b, _, _, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    keys = tk if bool((mask.sum(1) == 0).any()) else int(mask.any(0).sum())
    return (4 * 4 * q.numel() + 2 * b * kvh * hd * keys * k.element_size()
            + 2 * k.numel() * k.element_size() + 4 * lse.numel())


def sdpa_call(torch, q, k, v, *, causal, window, q_offset, kv_len, expand=False):
    """One ``scaled_dot_product_attention`` call computing the same function
    (the library yardstick; the port never calls it): k/v upcast to float32
    and the mask made outside the timed call.  With ``expand`` (a serving
    rank's call, up to 32,768 x 32,768 scores a head: the math path would
    hold them), k/v repeated to the q heads and no mask where it hides no key
    or is the plain causal one, on the memory-efficient kernel alone."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref as fa_r

    mask = fa_r.key_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len, device=q.device)
    qt, kt, vt = q.transpose(1, 2), k.float().transpose(1, 2), v.float().transpose(1, 2)
    if not expand:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[2] // k.shape[2]
    kt, vt = (t.repeat_interleave(g, 1) for t in (kt, vt))
    whole = bool(mask.all())
    if not (whole or torch.equal(mask, torch.ones_like(mask).tril())):
        fail("sdpa_call(expand=True) takes a mask that hides no key or the plain causal one")
    del mask

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=not whole)
    return call


def flash_bwd_phase(torch, gen, timer, configs, fa_k, fa_r) -> dict:
    """The backward kernel against its plain version at the training path's
    shapes (module doc, phase 6); its summary row with every shape."""
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def within(got, exp) -> bool:
        return all(bool(((a - e).abs() <= BWD_TOL + BWD_TOL * e.abs()).all())
                   for a, e in zip(got, exp))

    def errs(got, exp) -> float:
        return max(float((a - e).abs().max()) for a, e in zip(got, exp))

    mc, gc, hc = (configs.get(a) for a in (TRAIN_ARCH, "gemma3-4b", "h2o-danube-3-4b"))
    shapes = {}
    for cell, b, cfg, window in (
        ("minicpm_train", TRAIN_B, mc, 0),
        ("gemma3_local", 1, gc, gc.sliding_window),
        ("gemma3_global", 1, gc, 0),
        ("h2o_hd120", 1, hc, hc.sliding_window),
    ):
        h, kvh, hd, t = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, TRAIN_SEQ
        q, do = randn(b, t, h, hd), randn(b, t, h, hd)
        k, v = randn(b, t, kvh, hd), randn(b, t, kvh, hd)
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        if not within(got, exp):
            fail(f"flash_attention_bwd differs from the plain version ({cell}): "
                 f"max |err| {errs(got, exp)}")
        err = errs(got, exp)
        del exp
        # one key too few: the oldest in the window (or key 0 for the last row)
        near = dict(kw, window=(window or t) - 1)
        o_n, lse_n = fa_r.attention_lse_ref(q, k, v, **near)
        exp_n = fa_r.attention_bwd_ref(q, k, v, o_n, lse_n, do, **near)
        if within(got, exp_n):
            fail(f"flash_attention_bwd limit {BWD_TOL} does not tell one key too few ({cell})")
        one_key_off = errs(got, exp_n)
        del got, o_n, lse_n, exp_n
        torch.cuda.empty_cache()
        mask = fa_r.key_mask(t, t, causal=True, window=window, q_offset=0, kv_len=t, device=dev)
        pairs = int(mask.sum()) * b * h
        nbytes = flash_bwd_bytes(q, k, lse, mask)
        design = fa_k.bwd_design(hd)
        tms, tby = bound(nbytes, 10 * hd * pairs, "bf16_tensor", fa_k.BWD_SPLIT)
        fms, fby = bound(nbytes, 10 * hd * pairs)
        bms, bby = tms, tby  # both designs run on the tensor cores
        ms = timer.ms(lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        plain_ms = timer.ms(lambda: fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw))
        # the library yardstick: autograd through float32 SDPA (its backward)
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        dout = do.transpose(1, 2)
        library_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
        shapes[cell] = {
            "q": list(q.shape), "kv": list(k.shape), **kw, "design": design, "max_abs_err": err,
            "one_key_off_max_abs_err": one_key_off, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_tensor_ms": tms, "bound_tensor_by": tby, "share_of_tensor_bound": tms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": 10 * hd * pairs, "split": fa_k.BWD_SPLIT,
            "library_ms": library_ms,
        }
        del q, do, k, v, o, lse, leaves, out, dout, mask
        torch.cuda.empty_cache()
    # small cases: a softcap, GQA (2 here; minicpm 1, h2o 4, below), windows,
    # every head width, ragged tiles (200 and 4097 positions)
    small = {}
    for hd, t, h, kvh in ((32, 200, 8, 4), (64, 200, 8, 4), (120, 200, 8, 4), (128, 200, 8, 4),
                          (256, 200, 8, 4), (64, 4097, 4, 4), (120, 300, 8, 2)):
        for softcap, window in ((30.0, 50), (0.0, 0)):
            q, do = randn(2, t, h, hd), randn(2, t, h, hd)
            k, v = randn(2, t, kvh, hd), randn(2, t, kvh, hd)
            kw = dict(causal=True, window=window, softcap=softcap)
            o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
            got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
            if not within(got, exp):
                fail(f"flash_attention_bwd differs from the plain version (hd {hd}, T {t}, "
                     f"groups {h // kvh}, softcap {softcap}): max |err| {errs(got, exp)}")
            small[f"hd{hd}_T{t}_groups{h // kvh}_softcap{softcap:g}_window{window}"] = \
                errs(got, exp)
            del q, do, k, v, o, lse, got, exp
    # the gradient through a partly filled cache and past the keys, through
    # autograd (ops.flash_attention: the backward on k and v cut to kv_len,
    # dk and dv 0 past it, and do / Tk on every row of dv from each row that
    # sees no key): kv_len 1200 of 1536 keys, rows 400 .. 1423 (GQA 2),
    # against attention_bwd_ref at that kv_len and failing it given one key
    # too few; rows past 384 keys with a window of 64 (the last 65 see no
    # key), against the plain forward's autograd
    from repro_torch.kernels.flash_attention import ops as fa_o

    cache = {}
    for cell, (b, tq, tk, h, kvh, hd), kw in (
        ("kv_len_1200", (2, 1024, 1536, 8, 4, 64),
         dict(causal=True, window=0, q_offset=400, kv_len=1200)),
        ("past_the_keys_window", (1, 512, 384, 4, 2, 128),
         dict(causal=True, window=64, q_offset=0, kv_len=None)),
    ):
        q, do = randn(b, tq, h, hd), randn(b, tq, h, hd)
        k, v = randn(b, tk, kvh, hd), randn(b, tk, kvh, hd)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fa_k.bwd_launches
        got = torch.autograd.grad(fa_o.flash_attention(*leaves, **kw), leaves, do)
        if fa_k.bwd_launches != before + 1:
            fail(f"flash_attention's gradient ({cell}) did not launch the backward kernel")
        if kw["kv_len"] is not None:
            o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
            exp = fa_r.attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)
            if bool(got[1][:, kw["kv_len"]:].any()) or bool(got[2][:, kw["kv_len"]:].any()):
                fail(f"flash_attention's gradient ({cell}): dk or dv past kv_len")
            near = dict(kw, kv_len=kw["kv_len"] - 1)
            o_n, lse_n = fa_r.attention_lse_ref(q, k, v, **near)
            if within(got, fa_r.attention_bwd_ref(q, k, v, o_n, lse_n, do, **near)):
                fail(f"flash_attention_bwd limit {BWD_TOL} does not tell one key too few ({cell})")
            del o_r, lse_r, o_n, lse_n
        else:
            plain = [x.clone().requires_grad_() for x in (q, k, v)]
            exp = torch.autograd.grad(fa_r.attention_ref(*plain, **kw), plain, do)
        if not within(got, exp):
            fail(f"flash_attention's gradient ({cell}) differs from the plain version: max |err| "
                 f"{errs(got, exp)}")
        cache[cell] = {"q": [b, tq, h, hd], "kv": [b, tk, kvh, hd], **kw,
                       "max_abs_err": errs(got, exp)}
        del q, do, k, v, leaves, got, exp
    torch.cuda.empty_cache()
    ptx = _ptxas("bwd_")
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:114",
        **shapes["minicpm_train"],
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes.values()),
        "shapes": shapes, "small_checks_max_abs_err": small, "cache_checks": cache,
        "tol": BWD_TOL, "ptxas": ptx,
    }


def one_key_too_few(torch, fa_r, q, k, v, o, lse, do, grads, kw) -> list[float] | None:
    """The plain version given one key too few (causal: each row's oldest
    visible key past a window one shorter than the longest row's reach;
    else the last key, dropped) against a call's forward (o, lse) and
    backward (``grads``) as the kernels gave them: the largest difference
    of each, or None where either stays within FLASH_TOL / BWD_TOL (bf16
    dk, dv plus one rounding), which would not tell the key."""
    if kw["causal"]:
        near, kn, vn = dict(kw, window=(kw["window"] or kw["q_offset"] + q.shape[1]) - 1), k, v
    else:
        near, kn, vn = kw, k[:, :-1], v[:, :-1]
    o_n, lse_n = fa_r.attention_lse_ref(q, kn, vn, **near)
    if all(bool(((a - e).abs() <= FLASH_TOL + FLASH_TOL * e.abs()).all())
           for a, e in ((o, o_n), (lse, lse_n))):
        return None
    fwd = max(float((a - e).abs().max()) for a, e in ((o, o_n), (lse, lse_n)))
    exp = fa_r.attention_bwd_ref(q, kn, vn, o_n, lse_n, do, **near)
    within, bwd = True, 0.0
    for a, e in zip(grads, exp):
        rounded = BF16_ROUND if a.dtype == torch.bfloat16 else 0.0
        err = (a.float()[:, :e.shape[1]] - e).abs()
        bwd = max(bwd, float(err.max()))
        within &= bool((err <= BWD_TOL + (BWD_TOL + rounded) * e.abs()).all())
    return None if within else [fwd, bwd]


def serving_row(torch, gen, timer, fa_k, fa_r, row) -> dict:
    """A serving rank's attention call (a ``TP_RANK_SHAPES`` row whose mask
    names kv_len): q float32 over kv head 0 of a bf16 cache of the row's
    kv heads, the strided view the model hands the kernel.  Held against the
    plain version, whole or, past ``PLAIN_ROWS`` query rows, on the first
    and the last ``PLAIN_ROWS`` (each at its q_offset), within FLASH_TOL
    with v of mean 0 and of mean 1 (|O| ~ 1, where a bias of O would show),
    and failing it given one key too few (kv_len - 1, which the last row
    sees); timed with its bound (the products its operands need, 3 for bf16
    k/v), the plain version over the whole call (``PLAIN_ROWS`` rows at a
    time) and SDPA.  ``{name: row}``."""
    cell, q_shape, kv_shape, kv_dtype, kw, path, _, heads = row
    dev = gen.device
    b, tk, _, hd = kv_shape
    tq = q_shape[1]
    kw = {"softcap": 0.0, **kw}
    q = torch.randn(q_shape, generator=gen, device=dev)
    design = fa_k.fwd_design(hd, torch.bfloat16, tq * q_shape[2] // kv_shape[2])
    blocks = [(0, tq)] if tq <= PLAIN_ROWS else [(0, PLAIN_ROWS), (tq - PLAIN_ROWS, tq)]

    def plain(q, k, v, start, stop, **over):
        return fa_r.attention_ref(q[:, start:stop], k, v,
                                  **dict(kw, q_offset=kw["q_offset"] + start, **over))

    def within(got, exp) -> bool:
        return bool(((got - exp).abs() <= FLASH_TOL + FLASH_TOL * exp.abs()).all())

    out = {}
    for v_mean in (0.0, 1.0):
        k, v = ((torch.randn((b, tk, heads, hd), generator=gen, device=dev) + mean)
                .to(getattr(torch, kv_dtype))[:, :, :1] for mean in (0.0, v_mean))
        before = fa_k.fwd_design_launches[design]
        o = fa_k.flash_attention(q, k, v, **kw)
        if fa_k.fwd_design_launches[design] != before + 1:
            fail(f"{cell}: flash_attention did not run {design}")
        err, signed, scale = 0.0, 0.0, 0.0
        for start, stop in blocks:
            exp = plain(q, k, v, start, stop)
            got = o[:, start:stop]
            if not within(got, exp):
                fail(f"{cell} (v of mean {v_mean:g}): rows [{start}, {stop}) differ from the "
                     f"plain version by {float((got - exp).abs().max())}")
            err = max(err, float((got - exp).abs().max()))
            signed += float(((got - exp) * exp.sign()).sum())
            scale += float(exp.abs().sum())
        out[v_mean] = {"max_abs_err": err, "mean_signed_rel_err": signed / scale}
        if v_mean:
            break
        start, stop = blocks[-1]
        near = plain(q, k, v, start, stop, kv_len=kw["kv_len"] - 1)
        if within(o[:, start:stop], near):
            fail(f"{cell}: the limit {FLASH_TOL} does not tell one key too few")
        out["one_key_off"] = float((o[:, start:stop] - near).abs().max())
        del near
        full = {n: kw[n] for n in ("causal", "window", "q_offset", "kv_len")}
        nbytes, ops = flash_work(torch, q, k, **full)
        split, _ = attn_products(False, True)
        bms, bby = bound(nbytes, ops, "bf16_tensor", split)
        fms, fby = bound(nbytes, ops)
        ms = timer.ms(lambda: fa_k.flash_attention(q, k, v, **kw))
        plain_ms = timer.ms(lambda: [plain(q, k, v, i, min(i + PLAIN_ROWS, tq))
                                     for i in range(0, tq, PLAIN_ROWS)])
        library_ms = timer.ms(sdpa_call(torch, q, k, v, **full, expand=True))
        timed = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                 "share_of_bound": bms / ms, "bound_fp32_ms": fms, "bound_fp32_by": fby,
                 "share_of_fp32_bound": fms / ms, "bytes": nbytes, "operations": ops,
                 "split": split, "library_ms": library_ms}
        del k, v, o
        torch.cuda.empty_cache()
    return {f"flash_attention/{design}@{cell}": {
        "q": list(q_shape), "kv": list(kv_shape), "kv_dtype": kv_dtype, "cache_kv_heads": heads,
        "kv_stride": [tk * heads * hd, heads * hd, hd, 1], **kw, "path": path,
        "design": design, "max_abs_err": max(out[0.0]["max_abs_err"], out[1.0]["max_abs_err"]),
        "checked_rows": blocks, "v_mean_0": out[0.0], "v_mean_1": out[1.0],
        "one_key_off_max_abs_err": out["one_key_off"], "tol": FLASH_TOL, **timed}}


def family_train_rows(torch, gen, timer, fa_k, fa_r, shapes=FAMILY_TRAIN_SHAPES) -> dict:
    """The families' training attention (``FAMILY_TRAIN_SHAPES``, phase 6b;
    ``TP_RANK_SHAPES``, a tensor-parallel rank's): the forward with lse
    (``flash_wgmma`` on bf16 k/v, ``flash_wgmma_split`` on Whisper's float32
    decoder) and the backward (``bwd_wide`` at hd 256 and ``bwd_wgmma`` at
    64, bf16 k/v as they are) against the plain versions
    from the same o and lse; each timed with its bound (the products its
    operands need) and the design's, the plain version and SDPA (autograd
    for the backward); the backward also with its plan (head subsets, k/v
    parts; the cell's own where it names one, else the run fails) and its
    device ms by pass; a serving rank's row, the forward alone
    (``serving_row``).  One row per kernel and shape, named
    ``<kernel>/<design>@<cell>``."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = {}

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for row in shapes:
        if "kv_len" in row[4]:  # a serving rank's call: forward only
            rows.update(serving_row(torch, gen, timer, fa_k, fa_r, row))
            continue
        cell, q_shape, kv_shape, kv_dtype, mask_kw, path, q_bf16, want_plan = row
        kvt = getattr(torch, kv_dtype)
        q, do = randn(q_shape), randn(q_shape)
        if q_bf16:   # the float32 values of bf16 q
            q = q.to(torch.bfloat16).float()
        k, v = randn(kv_shape, kvt), randn(kv_shape, kvt)
        kw = {"softcap": 0.0, "q_offset": 0, **mask_kw}
        hd, rows_per_kv = q_shape[3], q_shape[1] * q_shape[2] // kv_shape[2]
        fdesign = fa_k.fwd_design(hd, kvt, rows_per_kv, lse=True)
        bdesign = fa_k.bwd_design(hd)
        before = dict(fa_k.fwd_design_launches), dict(fa_k.bwd_design_launches)
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        got = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if (fa_k.fwd_design_launches[fdesign] != before[0][fdesign] + 1
                or fa_k.bwd_design_launches[bdesign] != before[1][bdesign] + 1):
            fail(f"family_train {cell}: not {fdesign} and {bdesign}")
        o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
        ferr = max(float((a - e).abs().max()) for a, e in ((o, o_r), (lse, lse_r)))
        if not all(bool(((a - e).abs() <= FLASH_TOL + FLASH_TOL * e.abs()).all())
                   for a, e in ((o, o_r), (lse, lse_r))):
            fail(f"family_train {cell}: the forward differs from the plain version by {ferr}")
        exp = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        berr = 0.0
        for name, a, e in zip(("dq", "dk", "dv"), got, exp):
            rounded = BF16_ROUND if a.dtype == torch.bfloat16 else 0.0
            err = (a.float() - e).abs()
            berr = max(berr, float(err.max()))
            if not bool((err <= BWD_TOL + (BWD_TOL + rounded) * e.abs()).all()):
                fail(f"family_train {cell}: {name} differs from the plain version by "
                     f"{float(err.max())}")
        del o_r, lse_r, exp
        one_key_off = one_key_too_few(torch, fa_r, q, k, v, o, lse, do, got, kw)
        if one_key_off is None:
            fail(f"family_train {cell}: the limits do not tell one key too few")
        del got
        full = dict(causal=kw["causal"], window=kw["window"], q_offset=kw["q_offset"],
                    kv_len=kv_shape[1])
        nbytes, ops = flash_work(torch, q, k, **full)
        nbytes += lse.numel() * 4
        # the bound counts the products the operands need (a bf16 value
        # needs no split); "as_run" counts those the design makes
        f_split, b_split = attn_products(torch.equal(q.to(torch.bfloat16).float(), q),
                                         kvt == torch.bfloat16)
        bms, bby = bound(nbytes, ops, "bf16_tensor", f_split)
        run_ms, _ = bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[fdesign])
        ms = timer.ms(lambda: fa_k.flash_attention_lse(q, k, v, **kw))
        base = {"q": list(q_shape), "kv": list(kv_shape), "kv_dtype": kv_dtype,
                **kw, "path": path}
        rows[f"flash_attention/{fdesign}@{cell}"] = {
            **base, "design": fdesign, "max_abs_err": ferr, "ms": ms,
            "plain_ms": timer.ms(lambda: fa_r.attention_lse_ref(q, k, v, **kw)),
            "one_key_off_max_abs_err": one_key_off[0],
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms, "bytes": nbytes,
            "operations": ops, "split": f_split, "bound_ms_as_run": run_ms,
            "split_as_run": FLASH_SPLIT[fdesign],
            "library_ms": timer.ms(sdpa_call(torch, q, k, v, **full))}
        mask = fa_r.key_mask(q_shape[1], kv_shape[1], causal=kw["causal"], window=kw["window"],
                             q_offset=kw["q_offset"], kv_len=None, device=dev)
        pairs = int(mask.sum()) * q_shape[0] * q_shape[2]
        nbytes = flash_bwd_bytes(q, k, lse, mask)
        bms, bby = bound(nbytes, 10 * hd * pairs, "bf16_tensor", b_split)
        # the instance that runs: its k/v parts give its products
        plan = fa_k.bwd_plan(hd, q_shape[0], q_shape[1], kv_shape[1], q_shape[2], kv_shape[2],
                             causal=kw["causal"], window=kw["window"], q_offset=kw["q_offset"],
                             sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                             kv_bf16=kvt == torch.bfloat16)
        if want_plan is not None and (plan.head_splits, plan.kv_parts) != want_plan:
            fail(f"{cell}: the backward's plan takes {plan.head_splits} head subsets and "
                 f"{plan.kv_parts} k/v parts, want {want_plan}")
        products = fa_k.bwd_products(plan.kv_parts)
        run_split = sum(products.values()) / len(products)
        run_ms, _ = bound(nbytes, 10 * hd * pairs, "bf16_tensor", run_split)
        ms = timer.ms(lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        leaves = [x.float().transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        library_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                          retain_graph=True))
        rows[f"flash_attention_bwd/{bdesign}@{cell}"] = {
            **base, "design": bdesign, "max_abs_err": berr,
            "one_key_off_max_abs_err": one_key_off[1], "ms": ms,
            "plain_ms": timer.ms(lambda: fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms, "bytes": nbytes,
            "operations": 10 * hd * pairs, "split": b_split, "bound_ms_as_run": run_ms,
            "split_as_run": run_split, "head_splits": plan.head_splits, "kv_parts": plan.kv_parts,
            "library_ms": library_ms,
            "passes_ms": pass_ms(torch, timer,
                                 lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                                 BWD_PASSES)}
        del q, do, k, v, o, lse, leaves, out, mask
        torch.cuda.empty_cache()
    return rows


def blocked_pairs_for(world: int, fraction: float, seed: int = 0) -> list[tuple[int, int]]:
    """Deterministic sample of hole-punch-failed pairs at one fraction (the
    rule of ``benchmarks/hybrid_links.py``, copied so that no module of the
    JAX package is imported here)."""
    import numpy as np

    pairs = [(a, b) for a in range(world) for b in range(a + 1, world)]
    k = int(round(fraction * len(pairs)))
    if fraction > 0.0:
        k = max(k, 1)  # a nonzero fraction always blocks at least one pair
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    return [pairs[i] for i in order[:k]]


def event_rows(events) -> list[tuple]:
    """Every field of each priced event, for ``==`` comparisons."""
    return [(e.kind.value, e.world, e.bytes_per_rank, e.raw_bytes, e.algo, e.wire_total,
             e.relay, e.relayed_pairs, e.time_s) for e in events]


def comm_join_phase(torch, seed, left, right, ref_out, launches, hp_k, jp_k, sr_k, fa_k) -> dict:
    """Phase 3's join over four fabrics (module doc, phase 3b): the same rows
    on each, only the modeled price moves."""
    from repro_torch.core import make_communicator
    from repro_torch.core.backends.mediated import redis_communicator, s3_communicator
    from repro_torch.core.session import hybrid_session
    from repro_torch.dataframe import ops_dist

    p = len(left)
    blocked = blocked_pairs_for(p, COMM_BLOCKED_SHARE, seed)
    fabrics = {
        "lambda_direct": lambda: make_communicator(p, "direct"),
        "hybrid_redis": lambda: hybrid_session(p, blocked, relay="redis").communicator(),
        "redis": lambda: redis_communicator(p),
        "s3": lambda: s3_communicator(p),
    }
    out_rows = {}
    for name, make in fabrics.items():
        comm = make()
        received: set[str] = set()
        shuffle = comm.alltoallv

        def alltoallv(sends, algorithm=None, _shuffle=shuffle, _seen=received):
            recvs, counts = _shuffle(sends, algorithm=algorithm)
            _seen.update(b.device.type for row in recvs for b in row)
            return recvs, counts

        comm.alltoallv = alltoallv
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        out = ops_dist.sim_join(left, right, "k", comm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        if got["hash_partition"] != 2 * p or got["join_probe"] != p:
            fail(f"comm join over {name}: launches {got}, want hash == {2 * p}, probe == {p}")
        if received != {"cuda"}:
            fail(f"comm join over {name}: received blocks on {sorted(received)}, want cuda only")
        for kname, c in got.items():
            by = launches.setdefault(kname, {})
            by["comm"] = by.get("comm", 0) + c
        for rank, (a, b) in enumerate(zip(out, ref_out)):
            n = int(a.count)
            if n != int(b.count) or set(a.columns) != set(b.columns) or not all(
                    torch.equal(a.columns[c][:n], b.columns[c][:n]) for c in a.columns):
                fail(f"comm join over {name}: rank {rank}'s rows differ from phase 3's")
        boot = [e for e in comm.events if e.kind.value == "bootstrap"]
        coll = [e for e in comm.events if e.kind.value != "bootstrap"]
        out_rows[name] = {
            "wall_s": wall, "comm_time_s": comm.comm_time_s,
            "bootstrap_time_s": comm.session.bootstrap_time_s,
            "bytes_on_wire": comm.bytes_on_wire,
            "relayed_pairs": len(comm.session.link_map.relayed_pairs()),
            "events": [{"kind": e.kind.value, "bytes_per_rank": e.bytes_per_rank,
                        "algo": e.algo, "relay": e.relay, "relayed_pairs": e.relayed_pairs,
                        "time_s": e.time_s} for e in coll],
            "bootstrap": [{"algo": e.algo, "time_s": e.time_s, "relay": e.relay,
                           "relayed_pairs": e.relayed_pairs} for e in boot],
            "launches": {k: got[k] for k in ("hash_partition", "join_probe")},
            "rows_bit_equal_to_join": True}
        del out
    return {"P": p, "blocked_pairs": blocked, "fabrics": out_rows}


def collectives_check(torch, gen) -> dict:
    """Every collective on CUDA float32 tensors of ``COMM_ELEMS`` elements per
    rank (module doc, phase 3b): results on the card, bit-equal to numpy on
    host copies folded in rank order; each event priced as the same call on
    CPU tensors of the same shapes."""
    import numpy as np

    from repro_torch.core import Communicator

    w, n = COMM_WORLD, COMM_ELEMS
    xs = [torch.randn(n, generator=gen, device="cuda") for _ in range(w)]
    host = [x.cpu().numpy() for x in xs]
    cpu = [torch.from_numpy(h) for h in host]
    lens = [n - r * 4096 for r in range(w)]  # allgatherv: ragged
    part = n // w

    def fold(op, arrays):
        acc = arrays[0].copy()
        for a in arrays[1:]:
            acc = op(acc, a)
        return acc

    def ops(comm, t, binop):
        """(name, call) of each collective; ``binop`` is the elementwise max."""
        sends = lambda: [[t[s][d * part:(d + 1) * part] for d in range(w)] for s in range(w)]  # noqa: E731
        return [
            ("allreduce_add", lambda: comm.allreduce(t)),
            ("allreduce_max", lambda: comm.allreduce(t, op=binop)),
            ("reduce_scatter_add", lambda: comm.reduce_scatter(t)),
            ("reduce_scatter_max", lambda: comm.reduce_scatter(t, op=binop)),
            ("allgather", lambda: comm.allgather(t)),
            ("allgatherv", lambda: comm.allgatherv([x[:m] for x, m in zip(t, lens)])),
            ("bcast", lambda: comm.bcast(t[3], root=3)),
            ("gather", lambda: comm.gather(t, root=2)),
            ("scatter", lambda: comm.scatter(t, root=1)),
            ("send", lambda: comm.send(t[0], dst=5)),
            ("alltoallv", lambda: comm.alltoallv(sends())[0]),
            ("iallreduce_wait", lambda: comm.wait(comm.iallreduce(t))),
            ("iallgatherv_wait", lambda: comm.wait(comm.iallgatherv(t))),
            ("ialltoallv_wait", lambda: comm.wait(comm.ialltoallv(sends()))[0]),
            ("ping", lambda: comm.ping(7)),
        ]

    def expect(name):
        if name in ("allreduce_add", "iallreduce_wait"):
            return [fold(np.add, host)] * w
        if name == "allreduce_max":
            return [fold(np.maximum, host)] * w
        if name.startswith("reduce_scatter"):
            return np.split(fold(np.add if name.endswith("add") else np.maximum, host), w)
        if name in ("allgather", "iallgatherv_wait"):
            return [np.concatenate(host)] * w
        if name == "allgatherv":
            return [np.concatenate([h[:m] for h, m in zip(host, lens)])] * w
        if name == "bcast":
            return [host[3]] * w
        if name == "gather":
            return [None, None, host] + [None] * (w - 3)
        if name == "scatter":
            return host
        if name in ("alltoallv", "ialltoallv_wait"):
            return [[host[s][d * part:(d + 1) * part] for s in range(w)] for d in range(w)]
        return None  # send, ping: priced events only

    def flat(x) -> list:
        if isinstance(x, (list, tuple)):
            return [y for v in x for y in flat(v)]
        return [x]

    dev_comm, cpu_comm = Communicator(w), Communicator(w)
    report = {}
    for (name, run_d), (_, run_c) in zip(ops(dev_comm, xs, torch.maximum),
                                         ops(cpu_comm, cpu, torch.maximum)):
        k0 = len(dev_comm.events)
        got = run_d()
        run_c()
        exp = expect(name)
        if exp is not None:
            g, e = flat(got), flat(exp)
            if len(g) != len(e) or any((a is None) != (b is None) for a, b in zip(g, e)):
                fail(f"collective {name}: result layout differs from numpy's")
            tensors = [a for a in g if a is not None]
            if any(a.device.type != "cuda" for a in tensors):
                fail(f"collective {name}: a result left the card")
            ptrs = [a.data_ptr() for a in tensors]
            if len(set(ptrs)) != len(ptrs):
                fail(f"collective {name}: two ranks share one result buffer")
            seen: dict[int, torch.Tensor] = {}
            for a, b in zip(g, e):
                if a is None:
                    continue
                # replicated outputs: the first copy on the host against
                # numpy, the other ranks' copies against it on the card
                first = seen.get(id(b))
                if first is None:
                    if not np.array_equal(a.cpu().numpy(), b):
                        fail(f"collective {name}: the card's result differs from numpy's")
                    seen[id(b)] = a
                elif not torch.equal(a, first):
                    fail(f"collective {name}: ranks got different copies")
        del got
        ev_d, ev_c = event_rows(dev_comm.events[k0:]), event_rows(cpu_comm.events[k0:])
        if ev_d != ev_c:
            fail(f"collective {name}: events on the card {ev_d} != on the CPU {ev_c}")
        report[name] = {"events": [{"kind": r[0], "bytes_per_rank": r[2], "algo": r[4],
                                    "time_s": r[8]} for r in ev_d],
                        "bit_equal_to_numpy": exp is not None}
    # a 2-colour split: each sub-communicator's allreduce folds its members
    subs = dev_comm.split([r % 2 for r in range(w)])
    for color in (0, 1):
        sub = subs[color]
        members = list(sub.group)
        got = sub.allreduce([xs[r] for r in members])
        exp = fold(np.add, [host[r] for r in members])
        if got[0].device.type != "cuda" or not np.array_equal(got[0].cpu().numpy(), exp):
            fail(f"split colour {color}: allreduce differs from numpy's")
        report[f"split_{color}_allreduce"] = {"group": members,
                                              "time_s": dev_comm.events[-1].time_s,
                                              "bit_equal_to_numpy": True}
    if len(dev_comm.events) != len(cpu_comm.events) + 2:
        fail("split: the sub-communicators did not log on the shared session")
    return {"world": w, "elements_per_rank": n, "dtype": "float32",
            "comm_time_s": dev_comm.comm_time_s, "bytes_on_wire": dev_comm.bytes_on_wire,
            "collectives": report}


def lifecycle_check() -> dict:
    """A world-64 session on the Lambda fabric (module doc, phase 3b): each
    lifecycle step's modeled seconds."""
    from repro_torch.core.session import CommSession

    out = {}
    for policy in ("incremental", "cold"):
        s = CommSession.bootstrap(LIFECYCLE_WORLD, "lambda")
        row = {"bootstrap_s": s.bootstrap_time_s}
        row["expand_s"] = s.expand(16, provider="gcp-cloudrun")
        row["world_after_expand"] = s.world
        row["full_rebootstrap_after_expand_s"] = s.full_rebootstrap_time_s()
        dead = list(range(s.world - 8, s.world))
        row["detect_s"] = s.detect_failure("_".join(f"r{r}" for r in dead))
        row["shrink_s"] = s.shrink(dead, policy=policy)
        row["world_after_shrink"] = s.world
        row["recover_link_s"], row["recover_link_action"] = s.recover_link(0, 1)
        row["recover_link_permanent_s"], row["recover_link_permanent_action"] = \
            s.recover_link(2, 3, permanent=True)
        row["rebootstrap_rank0_s"] = s.rebootstrap_rank(0)
        row["full_rebootstrap_s"] = s.full_rebootstrap_time_s()
        row["events"] = [{"kind": e.kind.value, "algo": e.algo, "time_s": e.time_s}
                         for e in s.events]
        out[policy] = row
    return out


def masked(obj):
    """``obj`` (JSON-able) with each S3 generation id (a random uuid) in its
    keys masked, for ``==`` between two runs."""
    import re
    return json.loads(re.sub(r"/[0-9a-f]{8}/", "/<gen>/", json.dumps(obj)))


def masked_ops(store) -> list:
    """A store's op log (kind, key, bytes, modeled s), generation ids masked."""
    return masked([(op.kind, op.key, op.nbytes, op.time_s) for op in store.ops])


def run_rows(rep) -> dict:
    """Every modeled field of a RunReport: all but the measured compute_s."""
    import dataclasses
    steps = [{k: v for k, v in dataclasses.asdict(s).items() if k != "compute_s"}
             for s in rep.supersteps]
    return {"init_s": rep.init_s, "world": rep.world, "joined_at": rep.joined_at,
            "evicted": rep.evicted, "supersteps": steps}


def bsp_phase(torch, gen, dev, launches, hp_k, jp_k, sr_k, fa_k) -> dict:
    """The paper's weak-scaling join through ``BSPRuntime`` on the card, and
    the recovery drill (module doc, phase 4b)."""
    from repro_torch.analysis import check_trace
    from repro_torch.core import BSPRuntime, Burst, FaultPlan, netsim
    from repro_torch.dataframe import Table, ops_local
    from repro_torch.dist.object_store import S3Store
    from repro_torch.dist.sharding import repartition_states

    def make_states(n, count, device, g):
        """Per rank (left, right): the example's tables of ``n`` int32 rows
        (keys a permutation), capacity 2n."""
        out = []
        for _ in range(count):
            k = torch.randperm(n, generator=g, device=device).to(torch.int32)
            out.append((
                Table.from_dict({"k": k, "v": k * 2}, capacity=2 * n, device=device),
                Table.from_dict({"k": torch.randperm(n, generator=g, device=device)
                                 .to(torch.int32), "w": k}, capacity=2 * n, device=device)))
        return out

    def join_step(rank, state, comm, world):
        left, right = state
        comm.barrier()
        ops_local.join_unique(left, right, "k")
        return state

    world_max = BSP_WORLDS[-1]
    t0 = time.perf_counter()
    card_states = make_states(JOIN_ROWS, world_max, dev, gen)
    cpu_states = make_states(BSP_CPU_ROWS, world_max, torch.device("cpu"),
                             torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    runs, probe = {}, 0
    for pname in BSP_PLATFORMS:
        plat = netsim.resolve_platform(pname)
        for world in BSP_WORLDS:
            reps = []
            for device, states in ((dev, card_states), (torch.device("cpu"), cpu_states)):
                fails = {(0, 1): True}  # examples/serverless_scaling.py's failure
                rt = BSPRuntime(world, platform=plat, device=device)
                torch.cuda.synchronize()
                reset_counters(hp_k, jp_k, sr_k, fa_k)
                t1 = time.perf_counter()
                _, rep = rt.run([("join", join_step)] * BSP_STEPS, states[:world],
                                fail_injector=lambda s, r, f=fails: f.pop((s, r), False))
                wall = time.perf_counter() - t1
                got = counters(hp_k, jp_k, sr_k, fa_k)
                violations = check_trace(rt.tracer, session=rt.session)
                if violations:
                    fail(f"bsp {pname} world {world}: tracecheck {violations[:3]}")
                reps.append((rep, got, wall))
            (rep, got, wall), (cpu_rep, cpu_got, _) = reps
            if got["join_probe"] != BSP_STEPS * world or cpu_got["join_probe"] != 0:
                fail(f"bsp {pname} world {world}: probe launches {got['join_probe']}, "
                     f"want {BSP_STEPS * world} (one per rank per superstep)")
            if run_rows(rep) != run_rows(cpu_rep):
                fail(f"bsp {pname} world {world}: modeled seconds differ from the CPU run")
            probe += got["join_probe"]
            steps = rep.supersteps
            runs[f"{pname}/{world}"] = {
                "platform": pname, "world": world, "init_s": rep.init_s,
                "compute_s": sum(s.compute_s for s in steps),
                "comm_s": sum(s.comm_s for s in steps),
                "barrier_s": sum(s.barrier_s for s in steps),
                "rebootstrap_s": sum(s.rebootstrap_s for s in steps),
                "supersteps_s": sum(s.total_s for s in steps), "total_s": rep.total_s,
                "retries": sum(s.retries for s in steps), "host_wall_s": wall,
                "cpu_compute_s": sum(s.compute_s for s in cpu_rep.supersteps)}
    del card_states, cpu_states
    torch.cuda.empty_cache()
    launches.setdefault("join_probe", {})["bsp"] = probe
    scaling = {}
    for pname in BSP_PLATFORMS:
        t1 = runs[f"{pname}/1"]
        scaling[pname] = {
            "total_ratio_T1_over_TP": {w: t1["total_s"] / runs[f"{pname}/{w}"]["total_s"]
                                       for w in BSP_WORLDS},
            "supersteps_ratio_T1_over_TP": {
                w: t1["supersteps_s"] / runs[f"{pname}/{w}"]["supersteps_s"]
                for w in BSP_WORLDS}}
    lam, ec2 = runs[f"lambda-10gb/{world_max}"], runs[f"ec2-15gb-4vcpu/{world_max}"]
    gap = {"world": world_max,
           "total_gap": lam["total_s"] / ec2["total_s"] - 1.0,
           "supersteps_gap": lam["supersteps_s"] / ec2["supersteps_s"] - 1.0}

    # the recovery drill: world 8, float64 state of DRILL_ROWS per rank,
    # checkpoints in the S3 store, a rank lost at superstep 1 (shrink), a
    # burst of 2 workers at superstep 2, overlapped supersteps; measured
    # compute priced at cpu_scale=0 so the whole report is modeled
    def drill(device, faulted):
        ones = torch.ones(DRILL_ROWS, dtype=torch.float64, device=device)

        def step(rank, state, comm, world):
            if rank == 0:
                comm.allreduce([ones] * world)
            return state * 2.0 + 1.0

        g = torch.Generator().manual_seed(1)
        init = [torch.rand(DRILL_ROWS, dtype=torch.float64, generator=g).to(device)
                for _ in range(DRILL_WORLD)]
        store = S3Store()
        rt = BSPRuntime(DRILL_WORLD, provider="aws-lambda", checkpoint_dir=store,
                        device=device, cpu_scale=0.0)
        kw = dict(faults=FaultPlan(rank_losses=((1, DRILL_WORLD - 1),)),
                  recovery_policy="shrink", overlap=True,
                  burst=Burst(at_step=2, new_ranks=2, repartition=repartition_states)
                  ) if faulted else {}
        out, rep = rt.run([(f"s{i}", step) for i in range(DRILL_STEPS)], init, **kw)
        return torch.cat(out).cpu(), rep, masked_ops(store), rt

    t1 = time.perf_counter()
    clean, _, _, _ = drill(dev, False)
    states, rep, ops, rt = drill(dev, True)
    drill_wall = time.perf_counter() - t1
    cpu_states, cpu_rep, cpu_ops, cpu_rt = drill(torch.device("cpu"), True)
    if not torch.equal(states, clean) or not torch.equal(states, cpu_states):
        fail("bsp drill: the final states differ from the clean run's or the CPU run's")
    if run_rows(rep) != run_rows(cpu_rep) or ops != cpu_ops:
        fail("bsp drill: modeled seconds or the store op log differ from the CPU run's")
    if masked(rt.tracer.to_json()) != masked(cpu_rt.tracer.to_json()):
        fail("bsp drill: the span timeline differs from the CPU run's")
    violations = check_trace(rt.tracer, session=rt.session, report=rep)
    if violations:
        fail(f"bsp drill: tracecheck {violations[:3]}")
    s1 = rep.supersteps[1]
    return {"steps": BSP_STEPS, "worlds": list(BSP_WORLDS), "rows_per_worker": JOIN_ROWS,
            "build_s": build_s, "runs": runs, "scaling": scaling,
            "lambda_vs_ec2": gap, "probe_launches": probe,
            "drill": {"world": DRILL_WORLD, "rows_per_rank": DRILL_ROWS,
                      "final_world": rep.world, "evicted": rep.evicted,
                      "joined_at": rep.joined_at, "recovery_s": s1.recovery_s,
                      "shrink_s": s1.shrink_s, "rollback_s": s1.rollback_s,
                      "expand_s": rep.supersteps[2].expand_s,
                      "overlapped_s": [s.overlapped_s for s in rep.supersteps],
                      "total_s": rep.total_s, "store_ops": len(ops),
                      "store_s": sum(op[3] for op in ops), "wall_s": drill_wall,
                      "states_bit_equal_to_clean": True, "tracecheck_violations": 0}}


def codec_phase(torch, np, left, right, ref_out, join_wall, gk, gv, expected, launches,
                hp_k, jp_k, sr_k, fa_k) -> dict:
    """``compress=True`` on the card (module doc, phase 4c): phase 3's join
    and phase 4's groupby through the columnar codec."""
    from repro_torch.core import make_communicator
    from repro_torch.dataframe import Table, ops_dist
    from repro_torch.dataframe.partition import build_partition_payload
    from repro_torch.dist import compression

    def watched(comm, sends_seen):
        shuffle = comm.compressed_alltoallv

        def compressed_alltoallv(sends, algorithm=None):
            sends_seen.append(sends)
            return shuffle(sends, algorithm=algorithm)
        comm.compressed_alltoallv = compressed_alltoallv
        return comm

    def part_devices(sends_seen) -> set[str]:
        return {part.device.type for sends in sends_seen for row in sends for blk in row
                for col in blk.columns.values() for part in col.parts.values()}

    def event_list(comm):
        return [{"kind": e.kind.value, "wire_bytes": e.bytes_per_rank,
                 "raw_bytes": e.raw_bytes, "ratio": e.compression_ratio, "algo": e.algo,
                 "time_s": e.time_s} for e in comm.events]

    p = len(left)
    seen: list = []
    comm = watched(make_communicator(p, "direct"), seen)
    torch.cuda.synchronize()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    out = ops_dist.sim_join(left, right, "k", comm, compress=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counters(hp_k, jp_k, sr_k, fa_k)
    if got["hash_partition"] != 2 * p or got["join_probe"] != p:
        fail(f"codec join: launches {got}, want hash == {2 * p}, probe == {p}")
    for name, c in got.items():
        launches.setdefault(name, {})["codec_join"] = c
    if part_devices(seen) != {"cuda"}:
        fail(f"codec join: encoded parts on {sorted(part_devices(seen))}, want cuda only")
    for rank, (a, b) in enumerate(zip(out, ref_out)):
        n = int(a.count)
        if n != int(b.count) or set(a.columns) != set(b.columns) or not all(
                torch.equal(a.columns[c][:n], b.columns[c][:n]) for c in a.columns):
            fail(f"codec join: rank {rank}'s rows differ from phase 3's")
    # rank 0's row of blocks (its left table) against the codec on host copies
    payload, counts = build_partition_payload(left[0], p, ["k"])
    host = [compression.encode_block({n: payload[n][d][:c].cpu() for n in sorted(payload)},
                                     {"k"}) for d, c in enumerate(counts.tolist())]

    def kinds(blocks):
        return [{n: (c.kind, c.wire_nbytes) for n, c in b.columns.items()} for b in blocks]
    if kinds(seen[0][0]) != kinds(host):
        fail("codec join: rank 0's blocks encode otherwise on the host")
    join_row = {"P": p, "wall_s": wall, "raw_join_wall_s": join_wall,
                "bytes_on_wire": comm.bytes_on_wire, "raw_bytes_on_wire": comm.raw_bytes_on_wire,
                "comm_time_s": comm.comm_time_s, "events": event_list(comm),
                "rank0_blocks": kinds(seen[0][0]), "launches": got,
                "rows_bit_equal_to_join": True}
    del out, payload, seen

    groupby_rows = {}
    gp, rows = GROUPBY_P, GROUPBY_ROWS
    for combine in (True, False):
        tables = [Table.from_dict({"k": gk[i * rows:(i + 1) * rows],
                                   "v": gv[i * rows:(i + 1) * rows]}, device=gk.device)
                  for i in range(gp)]
        seen = []
        comm = watched(make_communicator(gp, "direct"), seen)
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        res = ops_dist.sim_groupby(tables, "k", {"v": "sum"}, comm, combine=combine,
                                   compress=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        run = f"groupby_combine_{str(combine).lower()}"
        want_seg = launches["segment_reduce"][run]
        if got["segment_reduce"] != want_seg or got["hash_partition"] != gp:
            fail(f"codec groupby combine={combine}: launches {got}, want segment_reduce == "
                 f"{want_seg} (phase 4's), hash == {gp}")
        if part_devices(seen) != {"cuda"}:
            fail(f"codec groupby combine={combine}: encoded parts off the card")
        cols = [t.to_numpy() for t in res]
        k = np.concatenate([c["k"] for c in cols])
        s = np.concatenate([c["v_sum"] for c in cols])
        if not np.array_equal(np.sort(k), np.arange(GROUPS)) or \
                not np.array_equal(s.astype(np.int64), expected[k]):
            fail(f"codec groupby combine={combine}: sums differ from np.bincount")
        for name, c in got.items():
            launches.setdefault(name, {})[f"codec_{run}"] = c
        groupby_rows[run] = {"P": gp, "rows_per_worker": rows, "groups": GROUPS,
                             "wall_s": wall, "bytes_on_wire": comm.bytes_on_wire,
                             "raw_bytes_on_wire": comm.raw_bytes_on_wire,
                             "comm_time_s": comm.comm_time_s, "events": event_list(comm),
                             "launches": got, "sums_equal_bincount": True}
        del tables, res, seen
        torch.cuda.empty_cache()
    return {"join": join_row, "groupby": groupby_rows}


def jobs_phase(torch, np, dev, left, launches, hp_k, jp_k, sr_k, fa_k) -> dict:
    """The serverless executor on the card (module doc, phase 4d): the CSV
    ETL through ``JobExecutor.map`` and a hash-histogram ``map_reduce``."""
    import dataclasses

    from repro_torch.analysis import check_job, check_trace
    from repro_torch.core import FaultPlan
    from repro_torch.dataframe import io
    from repro_torch.dist.object_store import S3Store
    from repro_torch.jobs import JobExecutor
    from repro_torch.kernels.hash_partition import ops as hp_ops, ref as hp_r

    rng = np.random.default_rng(0)
    a = rng.random(JOBS_CSV_ROWS)
    b = rng.integers(0, 50, JOBS_CSV_ROWS).astype(float)
    csv = ("a,b\n" + "".join(f"{x},{y}\n" for x, y in zip(a.tolist(), b.tolist()))).encode()
    store = S3Store()
    store.put_objects_atomic("ds", {"t.csv": csv})
    plan = lambda: FaultPlan(kills=((0, 1),), straggles=((0, 2, 20.0),))  # noqa: E731

    def etl(device, cpu_scale):
        ex = JobExecutor("aws-lambda", device=device, cpu_scale=cpu_scale)
        t0 = time.perf_counter()
        tables = io.etl_csv(store, "ds", "t.csv", chunk_bytes=JOBS_CHUNK_BYTES, executor=ex,
                            faults=plan(), device=device)
        torch.cuda.synchronize()
        return tables, ex, time.perf_counter() - t0

    def report_row(rep) -> dict:
        return {"ntasks": rep.ntasks, "retries": rep.retries,
                "speculative_launched": rep.speculative_launched,
                "speculative_wins": rep.speculative_wins,
                "billed_s": sum(a.billed_s for t in rep.tasks for a in t.attempts),
                "tasks_s": rep.tasks_s, "init_s": rep.init_s, "comm_s": rep.comm_s,
                "reduce_s": rep.reduce_s, "total_s": rep.total_s, "cost_usd": rep.cost_usd}

    def audited(ex, rep, what):
        violations = check_trace(ex.tracer, job=rep) + check_job(rep, ex.tracer)
        if violations:
            fail(f"jobs {what}: tracecheck {violations[:3]}")

    measured, ex1, etl_wall = etl(dev, 1.0)
    modeled, ex0, _ = etl(dev, 0.0)
    cpu_tables, cpu_ex, cpu_wall = etl(torch.device("cpu"), 0.0)
    for tables in (measured, modeled):
        if len(tables) != len(cpu_tables) or not all(
                t.columns[c].device.type == "cuda" for t in tables for c in t.columns):
            fail("jobs etl: the Tables are not one per partition on the card")
        for t, c in zip(tables, cpu_tables):
            n = int(c.count)
            if int(t.count) != n or not all(torch.equal(t.columns[k][:n].cpu(), c.columns[k][:n])
                                            for k in c.columns):
                fail("jobs etl: a Table on the card differs from the CPU parse")
    if sum(int(t.count) for t in cpu_tables) != JOBS_CSV_ROWS:
        fail("jobs etl: rows lost or duplicated")
    if dataclasses.asdict(ex0.reports[-1]) != dataclasses.asdict(cpu_ex.reports[-1]) or \
            ex0.tracer.to_json() != cpu_ex.tracer.to_json():
        fail("jobs etl: the JobReport at cpu_scale=0 differs from the CPU run's")
    for ex, what in ((ex1, "etl measured"), (ex0, "etl modeled")):
        audited(ex, ex.reports[-1], what)

    # map_reduce: each task hash-partitions one slice of rank 0's join keys
    # on the card into the join's P buckets; the reduce sums the histograms
    p = JOIN_P
    keys = left[0].columns["k"][:int(left[0].count)]
    slices = list(torch.tensor_split(keys, JOBS_MAP_TASKS))

    def hist(part):
        count = torch.tensor(part.shape[0], dtype=torch.int32, device=part.device)
        _, h = hp_ops.row_buckets([part], p, count)
        return h[:p].to(torch.int64)

    def reduce(hs):
        return torch.stack([h.to(hs[0].device) for h in hs]).sum(0)

    mr = []
    for device, scale in ((dev, 1.0), (dev, 0.0), (torch.device("cpu"), 0.0)):
        ex = JobExecutor("aws-lambda", device=device, cpu_scale=scale, workers=4)
        parts = [s.to(device) for s in slices]
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        fut = ex.map_reduce(hist, parts, reduce)
        got = counters(hp_k, jp_k, sr_k, fa_k)
        audited(ex, fut.job, f"map_reduce {device.type} cpu_scale={scale}")
        mr.append((fut, ex, got))
    host = keys.cpu()
    _, want = hp_r.row_buckets_ref([host], p, torch.tensor(host.shape[0], dtype=torch.int32))
    (fut1, _, got1), (fut0, ex0m, _), (cfut, cex, _) = mr
    for fut in (fut1, fut0, cfut):
        if not torch.equal(fut.result().cpu(), want[:p].to(torch.int64)):
            fail("jobs map_reduce: the summed histograms differ from the plain version's")
    if got1["hash_partition"] != JOBS_MAP_TASKS:
        fail(f"jobs map_reduce: hash launches {got1['hash_partition']}, want {JOBS_MAP_TASKS}")
    for name, c in got1.items():
        launches.setdefault(name, {})["jobs_map_reduce"] = c
    if dataclasses.asdict(fut0.job) != dataclasses.asdict(cfut.job) or \
            ex0m.tracer.to_json() != cex.tracer.to_json():
        fail("jobs map_reduce: the JobReport at cpu_scale=0 differs from the CPU run's")
    return {"csv_rows": JOBS_CSV_ROWS, "csv_bytes": len(csv), "chunk_bytes": JOBS_CHUNK_BYTES,
            "etl": {"partitions": len(cpu_tables), "card_wall_s": etl_wall,
                    "cpu_wall_s": cpu_wall, "measured": report_row(ex1.reports[-1]),
                    "modeled": report_row(ex0.reports[-1]),
                    "tables_equal_cpu_parse": True},
            "map_reduce": {"tasks": JOBS_MAP_TASKS, "P": p, "histogram": want[:p].tolist(),
                           "measured": report_row(fut1.job), "modeled": report_row(fut0.job),
                           "launches": got1, "sum_equals_plain": True},
            "reports_equal_cpu_at_cpu_scale_0": True, "tracecheck_violations": 0}


def step_flops(cfg, batch: int, seq: int) -> dict[str, int]:
    """FLOPs of one causal training step.  ``model``: 3 x the forward's, the
    forward being 2 per weight of every product per token (q, k, v, o, the
    gated MLP, the head) and 4 hd per visible (query, key) pair per head.
    ``products``: every matrix product the step runs, the layers' forward
    recompute included (the backward's two products per forward one);
    ``attention``: the flash kernels' work (forward and recompute 4 hd per
    pair, backward 10 hd)."""
    d, hd, h, kv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + d * 2 * cfg.d_ff + cfg.d_ff * d
    tokens = batch * seq
    layers = 2 * tokens * cfg.num_layers * per_layer
    head = 2 * tokens * d * cfg.vocab_size
    pairs = h * batch * (seq * (seq + 1) // 2) * cfg.num_layers
    return {"model": 3 * (layers + head + 4 * hd * pairs),
            "products": 4 * layers + 3 * head,
            "attention": (4 + 4 + 10) * hd * pairs}


def train_phase(torch, seed, launches, hp_k, jp_k, sr_k, fa_k) -> None:
    """``launch.train.train`` on minicpm-2b at full width (module doc, phase
    9), counted and timed in one run; then one more step under the profiler."""
    import math

    import tempfile

    from repro_torch import configs
    from repro_torch.core.session import CommSession
    from repro_torch.core.trace import LANES, Tracer
    from repro_torch.launch import train as ltrain
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = configs.get(TRAIN_ARCH)
    dev = torch.device("cuda")
    arrivals, log = [], []
    session = CommSession.bootstrap(TRAIN_COMM_WORLD, "lambda")
    tracer = Tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    params, losses = ltrain.train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq_len=TRAIN_SEQ, lr=TRAIN_LR, log=log.append,
        log_every=1, comm_session=session, tracer=tracer, **TRAIN_BURST_SHRINK,
        device=dev, seed=seed, on_step=lambda step, loss: arrivals.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    lifecycle = [line for line in log if line.startswith(("burst:", "shrink:"))]
    if len(lifecycle) != 2:
        fail(f"train did not log one burst and one shrink: {log}")
    spans = {lane: sum(1 for sp in tracer.spans if sp.lane == lane) for lane in LANES}
    if spans["compute"] != TRAIN_STEPS or spans["comm"] != TRAIN_STEPS:
        fail(f"train's tracer holds {spans}, want {TRAIN_STEPS} compute and comm spans")
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "train_trace.json"
        trace_path.write_text(json.dumps(tracer.to_json()))
        trace_bytes = trace_path.stat().st_size
        if len(Tracer.from_json(json.loads(trace_path.read_text())).spans) != len(tracer.spans):
            fail("train's trace JSON does not round-trip")
    modeled = {"world_start": TRAIN_COMM_WORLD, "world_end": session.world,
               "lifecycle_log": lifecycle, "spans_by_lane": spans,
               "critical_path": tracer.critical_path(), "trace_json_bytes": trace_bytes,
               "comm_lane_s": tracer.lane_time_s("comm"),
               "bootstrap_lane_s": tracer.lane_time_s("bootstrap")}
    got = counters(hp_k, jp_k, sr_k, fa_k)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": TRAIN_STEPS * cfg.num_layers * 2,
            "flash_attention_bwd": TRAIN_STEPS * cfg.num_layers}
    for name, n in want.items():
        if got[name] != n:
            fail(f"train launched {name} {got[name]} times, want {n}")
    designs = {**fa_k.fwd_design_launches, **fa_k.bwd_design_launches}
    if designs["flash_wgmma_split"] != want["flash_attention"]:
        fail(f"train's forward did not run flash_wgmma_split every time: {designs}")
    if designs["bwd_wgmma"] != want["flash_attention_bwd"]:
        fail(f"train's backward did not run bwd_wgmma every time: {designs}")
    if got["hash_partition"] < 1 or got["join_probe"] < 1:
        fail(f"train's pipeline did not reach the dataframe kernels: {got}")
    for name, c in got.items():
        launches.setdefault(name, {})["train"] = c
    if not all(math.isfinite(x) for x in losses) or not losses[-1] <= losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    step_s = [arrivals[0] - t0] + [b - a for a, b in zip(arrivals, arrivals[1:])]
    median_s = statistics.median(step_s[1:])
    flops = step_flops(cfg, TRAIN_B, TRAIN_SEQ)
    emit({"phase": "train", "arch": TRAIN_ARCH, "params": cfg.param_count(), "B": TRAIN_B,
          "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "wall_s": wall,
          "step_s": step_s, "median_step_s_2_to_6": median_s,
          "tokens_per_s": TRAIN_B * TRAIN_SEQ / median_s, "losses": losses,
          "flops_per_step": flops,
          "model_flops_share_of_fp32_cuda_core_peak":
              flops["model"] / median_s / OPS_PER_S["fp32"],
          "peak_mem_bytes": peak, "launches": got, "designs": designs, "log": log,
          "modeled": modeled})
    # one more step under the profiler, from fresh optimizer state
    opt_cfg = opt.OptConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 5),
                            total_steps=TRAIN_STEPS, schedule=cfg.schedule,
                            state_dtype=cfg.opt_state_dtype)
    opt_state = opt.init_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    batch = next(ltrain.data_iter(cfg, TRAIN_B, TRAIN_SEQ, start=TRAIN_STEPS, device=dev))
    emit({"phase": "trace", "cell": "train", **trace(
        torch, lambda: float(step_fn(params, opt_state, batch)[2]["loss"]), top=12,
        groups={"products (gemm)": ("gemm",), "flash_attention_bwd": ("bwd_",),
                "flash_attention": ("flash_", "fwd_prep"), "other": ("",)})})


def train_check_phase(torch, seed) -> dict:
    """Card against CPU for one step at full width (2 layers), float32 and
    int8 moments, and the kill/resume drill on the card (module doc)."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.session import CommSession
    from repro_torch.dist.treepath import flatten_with_path, path_str, tree_map
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _make_grads_of

    def leafwise(tree) -> dict:
        return {path_str(p): t for p, t in flatten_with_path(tree)}

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=2)
    gen = torch.Generator()
    gen.manual_seed(seed)
    p_cpu = api.init_params(cfg, gen, device="cpu", master=True)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))
                                        .astype(np.int32)),
             "mask": torch.from_numpy((rng.uniform(size=(2, 256)) > 0.1).astype(np.float32))}
    grads_of = _make_grads_of(cfg, None, 1, torch.float32)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    loss_d, _, g_d = grads_of(p_dev, {k: v.to(dev) for k, v in batch.items()})
    loss_c, _, g_c = grads_of(p_cpu, batch)
    out = {"a": {"loss_card": float(loss_d), "loss_cpu": float(loss_c)}}
    if abs(float(loss_d) - float(loss_c)) > TRAIN_LOSS_RTOL * abs(float(loss_c)):
        fail(f"train_check: loss on the card {float(loss_d)} vs the CPU {float(loss_c)}")
    matrix = ("wq", "wk", "wv", "wo_att", "wi", "wo", "lm_head", "embed")
    grad_report = {}
    for name, gc in leafwise(g_c).items():
        gd = leafwise(g_d)[name].cpu()
        err = (gd - gc).abs()
        scale = float(gc.abs().max())
        leaf = name.rsplit("/", 1)[-1]
        if leaf in matrix:
            tied = leaf == "embed" and cfg.tie_embeddings
            limit = (BF16_ULP * scale if tied
                     else BF16_ULP * gc.abs() + TRAIN_F32_GRAD_TOL * scale)
            equal = float((gd == gc).float().mean())
            ok = bool((err <= limit).all()) and equal >= 0.99
        else:
            equal = float((gd == gc).float().mean())
            ok = bool((err <= TRAIN_F32_GRAD_TOL * (scale + gc.abs())).all())
        grad_report[name] = {"max_abs_err": float(err.max()), "scale": scale,
                             "bit_equal_share": equal}
        if not ok:
            fail(f"train_check: gradient {name} on the card differs from the CPU's: "
                 f"{grad_report[name]}")
    out["a"]["grads"] = grad_report
    # the update, float32 and int8 moments, from each side's own gradients
    opt_cfg = opt.OptConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS, schedule="wsd")
    lr1 = float(opt.lr_at(torch.tensor(1), opt_cfg))
    for label, state_dtype in (("a", "float32"), ("b", "int8")):
        oc = dataclasses.replace(opt_cfg, state_dtype=state_dtype)
        pc, pd = (tree_map(torch.clone, p) for p in (p_cpu, p_dev))
        pc, sc = opt.apply_updates(pc, g_c, opt.init_state(pc, oc), oc)
        pd, sd = opt.apply_updates(pd, g_d, opt.init_state(pd, oc), oc)
        worst, share = 0.0, 1.0
        for name, wc in leafwise(pc).items():
            err = (leafwise(pd)[name].cpu() - wc).abs()
            worst = max(worst, float(err.max()))
            share = min(share, float((err <= 2 * BF16_ULP * lr1 + 1e-6).float().mean()))
        if worst > 2 * lr1 + 1e-6 or share < 0.999:
            fail(f"train_check ({label}, {state_dtype} moments): updated weights differ: "
                 f"max {worst}, share within 2 bf16 ulps of lr {share}")
        q_equal = 1.0
        for name, mc in leafwise(sc["m"]).items():
            md = leafwise(sd["m"])[name].cpu()
            if md.dtype == torch.int8:
                q_equal = min(q_equal, float((md == mc).float().mean()))
        if q_equal < 0.99:
            fail(f"train_check (b): int8 moments differ in {1 - q_equal} of their entries")
        out.setdefault(label, {}).update({
            "state_dtype": state_dtype, "lr_step1": lr1, "weights_max_abs_err": worst,
            "weights_share_within_2_bf16_ulps_of_lr": share,
            "int8_m_equal_share": q_equal if state_dtype == "int8" else None})
        del pc, pd, sc, sd
    del p_cpu, p_dev, g_c, g_d
    torch.cuda.empty_cache()
    # (c) the kill/resume drill on the card, LocalStore checkpoints, each call
    # with its own modeled session: the resumed one re-bootstraps through it
    rcfg = configs.get(TRAIN_ARCH).reduced()
    kw = dict(batch=2, seq_len=64, ckpt_every=10, device=dev, seed=seed)
    logs: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        _, ref = ltrain.train(rcfg, steps=4, ckpt_dir=f"{tmp}/ref", log=logs.append,
                              comm_session=CommSession.bootstrap(8, "lambda"), **kw)
        _, first = ltrain.train(rcfg, steps=4, stop_after=2, ckpt_dir=f"{tmp}/el",
                                log=logs.append, comm_session=CommSession.bootstrap(8, "lambda"),
                                **kw)
        resumed = CommSession.bootstrap(8, "lambda")
        rlog: list[str] = []
        _, rest = ltrain.train(rcfg, steps=4, ckpt_dir=f"{tmp}/el", resume=True, log=rlog.append,
                               comm_session=resumed, **kw)
    if first + rest != ref:
        fail(f"train_check (c): kill/resume trace {first + rest} != uninterrupted {ref}")
    reboot = [line for line in rlog if line.startswith("re-bootstrap:")]
    if len(reboot) != 1 or resumed.rebootstrap_time_s <= 0.0:
        fail(f"train_check (c): the resumed run did not re-bootstrap its session: {rlog}")
    out["c"] = {"uninterrupted": ref, "killed_and_resumed": first + rest, "bit_equal": True,
                "rebootstrap_log": reboot[0], "rebootstrap_s": resumed.rebootstrap_time_s}
    return out


def reshard_phase(torch, seed) -> dict:
    """minicpm-2b's full-width training state saved once into an ``S3Store``
    and restored onto the card whole and shard by shard (module doc, phase
    10b); then ``shardings_for``'s placements on the spmd group's
    ``make_host_mesh(model=1)``."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist import sharding
    from repro_torch.dist.object_store import S3Store
    from repro_torch.dist.treepath import flatten_with_path, leaves, path_str, tree_map
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=RESHARD_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    params = api.init_params(cfg, gen, device=dev, master=True)
    ocfg = opt.OptConfig(state_dtype="int8")
    state = opt.init_state(params, ocfg)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev), params)
    opt.apply_updates(params, grads, state, ocfg)  # non-zero int8 moments, no backward
    del grads
    tree = {"params": params, "opt": state}
    if not all(bool(state[k]["blocks"]["wi"]["q"].any()) for k in ("m", "v")):
        fail("reshard: the int8 moments are zero after the update")
    tree_bytes = sum(t.numel() * t.element_size() for t in leaves(tree))
    store = S3Store()
    t0 = time.perf_counter()
    ref = ckpt.save(store, 1, tree)
    save_wall = time.perf_counter() - t0

    def same_bits(a, b) -> bool:
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))

    def restored(fn) -> tuple:
        """``fn()``'s tree, its host wall (the card synchronised), its priced
        totals and its op log."""
        store.reset_ops()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        priced = {"host_wall_s": wall, "gets": store.gets, "bytes": store.bytes_got,
                  "modeled_s": store.op_time_s, "usd": store.request_cost_usd()}
        return out, priced, [(o.kind, o.key, o.nbytes, o.time_s) for o in store.ops]

    full, full_ops, _ = restored(lambda: ckpt.restore(ref, tree))
    for (path, a), b in zip(flatten_with_path(full), leaves(tree)):
        if a.device.type != "cuda" or not same_bits(a, b):
            fail(f"reshard: the full restore's {path_str(path)} is not the saved leaf")
    del tree, params, state
    torch.cuda.empty_cache()

    def shares(ops) -> dict:
        return {**ops, "bytes_share": ops["bytes"] / full_ops["bytes"],
                "modeled_s_share": ops["modeled_s"] / full_ops["modeled_s"]}

    def check_shard(shard, specs, sizes, at, what):
        exp = sharding.local_shard(full, specs, sizes, at)
        for (path, a), b in zip(flatten_with_path(shard), leaves(exp)):
            if a.device.type != "cuda" or not same_bits(a, b):
                fail(f"reshard: {what} {at}: {path_str(path)} is not local_shard's block")

    out = {"arch": TRAIN_ARCH, "layers": cfg.num_layers, "params": cfg.param_count(),
           "tree_bytes": tree_bytes,
           "leaves": len(leaves(full)), "save_wall_s": save_wall, "full": full_ops}
    # the reference benchmark's mesh: every model coord, then the reassembly
    sizes = {"data": 1, "model": 4}
    specs = sharding.param_specs(cfg, full, sizes)
    shards, rows, logs = [], [], []
    for m in range(4):
        at = {"data": 0, "model": m}
        shard, ops, log = restored(lambda: ckpt.restore_sharded(ref, full, specs, sizes, at))
        check_shard(shard, specs, sizes, at, "(1, 4)")
        shards.append(shard)
        rows.append({"coords": [0, m], **shares(ops)})
        logs.append(log)
    for i, ((path, whole), spec) in enumerate(zip(flatten_with_path(full), leaves(specs))):
        dim = next((d for d, e in enumerate(spec)
                    if "model" in (e if isinstance(e, tuple) else (e,))), None)
        parts = [leaves(s)[i] for s in shards]
        back = parts[0] if dim is None else torch.cat(parts, dim)
        if not same_bits(back, whole) or (dim is None and not all(same_bits(p, whole)
                                                                 for p in parts)):
            fail(f"reshard: the (1, 4) shards of {path_str(path)} do not reassemble the leaf")
    out["ckpt_store_1x4"] = rows
    # where the leaves land does not change the price: model 0 once more,
    # into a CPU like_tree (zero-storage tensors of the global shapes)
    at0 = {"data": 0, "model": 0}
    cpu_like = tree_map(lambda t: torch.empty((), dtype=t.dtype).expand(t.shape), full)
    cpu_shard, cpu_ops, cpu_log = restored(
        lambda: ckpt.restore_sharded(ref, cpu_like, specs, sizes, at0))
    if cpu_log != logs[0]:
        fail("reshard: restoring (1, 4)'s model 0 into a CPU like_tree changed the op log")
    for (path, a), b in zip(flatten_with_path(cpu_shard), leaves(shards[0])):
        if a.device.type != "cpu" or not same_bits(a, b.cpu()):
            fail(f"reshard: the CPU shard's {path_str(path)} is not the card's")
    out["cpu_like_1x4_model0"] = {**shares(cpu_ops), "op_log_equal": True}
    del shards, cpu_shard, cpu_like
    torch.cuda.empty_cache()
    # the production mesh (16 x 16, ZeRO as minicpm's config has it)
    prod = make_production_mesh()
    specs = sharding.param_specs(cfg, full, prod)
    rows = []
    for d, m in PRODUCTION_COORDS:
        at = {"data": d, "model": m}
        shard, ops, _ = restored(lambda: ckpt.restore_sharded(ref, full, specs, prod, at))
        check_shard(shard, specs, prod, at, "16 x 16")
        rows.append({"coords": [d, m], **shares(ops)})
        del shard
    out["production_16x16"] = rows
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del full
    torch.cuda.empty_cache()
    # shardings_for on the spmd phase's NCCL group: make_host_mesh(model=1)
    if not dist.is_initialized() or dist.get_backend() != "nccl":
        fail("reshard: the spmd phase's NCCL group is not up")
    mesh = make_host_mesh(model=1)
    rcfg = cfg.reduced()
    small = api.init_params(rcfg, gen, device=dev, master=True)
    specs = sharding.param_specs(rcfg, small, mesh)
    placed = sharding.shardings_for(mesh, specs)
    exp = sharding.local_shard(small, specs, mesh, {"data": 0, "model": 0})
    checked = 0
    for (path, leaf), e in zip(flatten_with_path(small), leaves(exp)):
        pl = placed
        for k in path:
            pl = pl[k]
        local = distribute_tensor(leaf, mesh, pl).to_local()
        if local.device.type != "cuda" or not same_bits(local, e):
            fail(f"reshard: distribute_tensor's local {path_str(path)} is not local_shard's")
        checked += 1
    out["nccl_distribute"] = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                              "leaves": checked, "bit_equal": True}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def families_phase(torch, seed, launches, hp_k, jp_k, sr_k, fa_k) -> None:
    """The four families' serve runs (module doc, phase 8b): each one
    ``generate``, counted and timed, then one prefill and one decode step
    under the profiler; each family's weights are freed before the next."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve import serve_step

    dev = torch.device("cuda")
    for run, arch, over, b, prompt, new, want in FAMILY_RUNS:
        cfg = dataclasses.replace(configs.get(arch), **over)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_bytes = sum(t.numel() * t.element_size() for t in api.tree_leaves(params))
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                                         device=dev, dtype=torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = torch.randn((b, cfg.source_positions, cfg.d_model),
                                          generator=gen, device=dev)
        arrivals = []

        def on_step(tok, logits):
            tok.cpu()
            arrivals.append(time.perf_counter())

        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        toks, _ = serve_step.generate(cfg, params, batch, new, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        peak = torch.cuda.max_memory_allocated()
        designs = {d: n for d, n in fa_k.fwd_design_launches.items() if n}
        if designs != want or got["flash_attention"] != sum(want.values()):
            fail(f"families {run}: flash_attention ran {designs} ({got['flash_attention']} "
                 f"calls), want {want}")
        for name, c in got.items():
            launches.setdefault(name, {})[f"families/{run}"] = c
        if toks.shape != (b, new) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"families {run}: tokens out of range: {toks.shape}")
        gaps = [y - x for x, y in zip(arrivals, arrivals[1:])]
        decode_s = arrivals[-1] - arrivals[0]
        emit({"phase": "families", "run": run, "arch": arch, "layers": cfg.num_layers,
              "params": cfg.param_count(), "weight_bytes": weight_bytes, "B": b,
              "prompt": prompt, "new": new, "init_s": init_s, "wall_s": wall,
              "ttft_s": arrivals[0] - t0,
              "token_gap_ms_median": statistics.median(gaps) * 1e3,
              "token_gap_ms_max": max(gaps) * 1e3,
              "decode_tokens_per_s": b * (new - 1) / decode_s,
              "peak_mem_bytes": peak, "launches": got, "designs": designs,
              "tokens_req0": toks[0].tolist()})

        def prefill_and_decode():
            with torch.inference_mode():
                st = api.init_decode_state(cfg, b, prompt + 1, device=dev)
                lg, st = api.prefill_fn(cfg, params, batch, st)
                api.decode_fn(cfg, params, serve_step.greedy_sample(lg), st)

        emit({"phase": "trace", "cell": f"families/{run}", **trace(torch, prefill_and_decode)})
        del params, batch, toks
        torch.cuda.empty_cache()


def families_check(torch, seed) -> dict:
    """Each family at full width and a CPU-sized depth (module doc, phase
    8b): (a) the cache-free forward on the card against the plain versions
    on the CPU from the same weights; (b) on the card, the cached path (a
    ``generate``'s logits at every step) against the cache-free forward of
    the prompt and the generated tokens, each token the argmax of its step."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve import serve_step

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_cpu(v) for v in tree)
        return tree.cpu()

    def close(got, exp, tol, scaled) -> tuple[bool, dict]:
        """Whether ``got`` is within ``tol`` of ``exp`` (bfloat16 logits:
        the absolute part of the largest ``exp``), and the reading."""
        got, exp = got.float().cpu(), exp.float().cpu()
        top = float(exp.abs().max())
        atol = tol * max(1.0, top) if scaled else tol
        err = (got - exp).abs()
        return bool((err <= atol + tol * exp.abs()).all()), {
            "max_abs_err": float(err.max()), "tol": tol, "atol": atol, "rtol": tol,
            "max_abs_logit": top}

    def attn_out(p) -> torch.Tensor:
        """The output projection of Griffin's attention layers in ``p``
        (the planted fault zeroes it)."""
        return p["group"][cfg.block_pattern.index("attn")]["wo_a"]

    dev = torch.device("cuda")
    b, s, new = FAMILY_CHECK_B, FAMILY_CHECK_PROMPT, FAMILY_CHECK_NEW
    out = {}
    for arch, over in FAMILY_CHECK:
        cfg = dataclasses.replace(configs.get(arch), **over)
        bf16_compute = api.compute_dtype(cfg) == torch.bfloat16
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = api.init_params(cfg, gen, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev,
                                         dtype=torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = torch.randn((b, cfg.source_positions, cfg.d_model), generator=gen,
                                          device=dev)
        row = {"layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers}
        # (a) the card against the CPU, the cache-free forward
        tol = SERVE_LOGIT_TOL if bf16_compute else REDUCED_F32_TOL
        cpu_params, cpu_batch = to_cpu(params), to_cpu(batch)
        with torch.inference_mode():
            card, _ = api.logits_fn(cfg, params, batch)
            cpu, _ = api.logits_fn(cfg, cpu_params, cpu_batch)
        scaled = card.dtype == torch.bfloat16
        ok, reading = close(card, cpu, tol, scaled)
        if not ok or not bool(torch.isfinite(card).all()):
            fail(f"families_check {arch}: the card's forward differs from the CPU's: {reading}")
        row["card_vs_cpu"] = {**reading, "logits": list(card.shape), "dtype": str(card.dtype)}
        if cfg.family == "hybrid":
            # the limit scaled by the largest logit must still catch a lost
            # attention layer: the CPU side without its output projection
            attn_out(cpu_params).zero_()
            with torch.inference_mode():
                faulted, _ = api.logits_fn(cfg, cpu_params, cpu_batch)
            caught, reading = close(card, faulted, tol, scaled)
            if caught:
                fail(f"families_check {arch}: the limit passes a zeroed attention output: "
                     f"{reading}")
            row["card_vs_cpu"]["attn_out_zeroed"] = reading
            del faulted
        del card, cpu, cpu_params, cpu_batch
        # (b) the cached path against the cache-free forward, on the card; the
        # MoE at capacity factor 16, so that no pair drops in either (a
        # batched prefill and a decode step drop different pairs at 1.25, as
        # the reference's own decode test notes, tests/test_models.py:57-59)
        ccfg = dataclasses.replace(cfg, capacity_factor=16.0) if cfg.family == "moe" else cfg
        steps = []
        toks, _ = serve_step.generate(ccfg, params, batch, new,
                                      on_step=lambda t, lg: steps.append(lg.float()))
        with torch.inference_mode():
            full, _ = api.logits_fn(ccfg, params, {**batch, "tokens": torch.cat(
                [batch["tokens"], toks], 1)})
        tf = full[:, s - 1: s - 1 + new].float()
        cached = torch.stack(steps, 1)
        tol = RWKV_STEP_TOL if cfg.family == "ssm" else SERVE_LOGIT_TOL
        ok, reading = close(cached, tf, tol, scaled)
        if not ok:
            fail(f"families_check {arch}: cached logits differ from the forward: {reading}")
        if not all(torch.equal(toks[:, i], lg.argmax(-1).to(torch.int32))
                   for i, lg in enumerate(steps)):
            fail(f"families_check {arch}: a greedy token is not its step's argmax")
        row["cached_vs_forward"] = {**reading, "positions": s + new}
        if cfg.family == "hybrid":
            saved = attn_out(params).clone()
            attn_out(params).zero_()
            with torch.inference_mode():
                faulted, _ = api.logits_fn(ccfg, params, {**batch, "tokens": torch.cat(
                    [batch["tokens"], toks], 1)})
            attn_out(params).copy_(saved)
            caught, reading = close(cached, faulted[:, s - 1: s - 1 + new], tol, scaled)
            if caught:
                fail(f"families_check {arch}: the limit passes a zeroed attention output: "
                     f"{reading}")
            row["cached_vs_forward"]["attn_out_zeroed"] = reading
            del faulted, saved
        out[arch] = row
        del params, full, steps
        torch.cuda.empty_cache()
    return out


def family_batch(torch, cfg, b: int, t: int, gen, dev) -> dict:
    """One training batch from ``gen``: tokens, a mask of ones, and Whisper's
    frames."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev,
                                     dtype=torch.int32),
             "mask": torch.ones((b, t), device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, cfg.source_positions, cfg.d_model), generator=gen,
                                      device=dev)
    return batch


def families_train_phase(torch, seed, launches, hp_k, jp_k, sr_k, fa_k, rows) -> None:
    """The families' training at full width (module doc, phase 8c): per
    family ``FAMILY_TRAIN_STEPS`` steps of ``make_train_step`` on one batch,
    counted and timed, each family's state freed before the next."""
    import dataclasses
    import math

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    for run, arch, over, b, t, want in FAMILY_TRAIN:
        cfg = dataclasses.replace(configs.get(arch), **over)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(cfg, gen, device=dev, master=True)
        batch = family_batch(torch, cfg, b, t, gen, dev)
        oc = opt.OptConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=FAMILY_TRAIN_STEPS,
                           schedule="constant", state_dtype=cfg.opt_state_dtype)
        state = opt.init_state(params, oc)
        step = make_train_step(cfg, oc)
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        losses, stamps = [], []
        t0 = time.perf_counter()
        for _ in range(FAMILY_TRAIN_STEPS):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            stamps.append(time.perf_counter())
        got = counters(hp_k, jp_k, sr_k, fa_k)
        peak = torch.cuda.max_memory_allocated()
        designs = {d: n for d, n in {
            **fa_k.fwd_design_launches, **fa_k.bwd_design_launches,
            **{f"head_split/{d}": n for d, n in fa_k.head_split_launches.items()},
            **{f"bf16_kv/{d}": n for d, n in fa_k.bf16_kv_launches.items()}}.items() if n}
        if designs != want:
            fail(f"families_train {run}: flash attention ran {designs}, want {want}")
        for name, c in got.items():
            launches.setdefault(name, {})[f"families_train/{run}"] = c
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"families_train {run}: losses not finite and falling: {losses}")
        if peak > 75e9:
            fail(f"families_train {run}: peak {peak / 1e9:.1f} GB over 75 GB")
        step_s = [stamps[0] - t0] + [y - x for x, y in zip(stamps, stamps[1:])]
        median_s = statistics.median(step_s[1:])
        kernel_ms = {name: {"ms": row["ms"], "bound_ms": row["bound_ms"]}
                     for name, row in rows.items() if row["path"] == f"families_train/{run}"}
        emit({"phase": "families_train", "run": run, "arch": arch, "layers": cfg.num_layers,
              "encoder_layers": cfg.encoder_layers, "params": cfg.param_count(), "B": b,
              "tokens": t, "steps": FAMILY_TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
              "step_s": step_s, "median_step_s_2_to_4": median_s,
              "tokens_per_s": b * t / median_s, "peak_mem_bytes": peak, "launches": got,
              "designs": designs, "attention_kernel_ms": kernel_ms})
        emit({"phase": "trace", "cell": f"families_train/{run}", **trace(
            torch, lambda: float(step(params, state, batch)[2]["loss"]), top=8,
            groups={"products (gemm)": ("gemm",), "flash_attention_bwd": ("bwd_",),
                    "flash_attention": ("flash_", "fwd_prep"), "other": ("",)})})
        del params, state, batch, step
        torch.cuda.empty_cache()


def families_train_check(torch, seed) -> dict:
    """Each training family at reduced(): one step's loss and gradients on
    the card against the CPU's from the same master weights and batch
    (``FAMILY_TRAIN_CHECK_*``), and AdamW's update from the CPU's gradient
    on both (``FAMILY_UPDATE_TOL``)."""
    from repro_torch import configs
    from repro_torch.dist.treepath import flatten_with_path, path_str, tree_map
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _make_grads_of

    def leafwise(tree) -> dict:
        return {path_str(p): t for p, t in flatten_with_path(tree)}

    dev = torch.device("cuda")
    out = {}
    for run, arch, *_ in FAMILY_TRAIN:
        cfg = configs.get(arch).reduced()
        tol = SERVE_LOGIT_TOL if api.compute_dtype(cfg) == torch.bfloat16 else REDUCED_F32_TOL
        gen = torch.Generator()
        gen.manual_seed(seed)
        p_cpu = api.init_params(cfg, gen, device="cpu", master=True)
        batch = family_batch(torch, cfg, FAMILY_TRAIN_CHECK_B, FAMILY_TRAIN_CHECK_T, gen, "cpu")
        grads_of = _make_grads_of(cfg, None, 1, torch.float32)
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        loss_d, _, g_d = grads_of(p_dev, {k: v.to(dev) for k, v in batch.items()})
        loss_c, _, g_c = grads_of(p_cpu, batch)
        row = {"tol": tol, "loss_card": float(loss_d), "loss_cpu": float(loss_c)}
        if abs(float(loss_d) - float(loss_c)) > tol * abs(float(loss_c)):
            fail(f"families_train_check {run}: loss on the card {float(loss_d)} vs the CPU "
                 f"{float(loss_c)}")
        worst = 0.0
        gd_all = leafwise(g_d)
        for name, gc in leafwise(g_c).items():
            rel = float((gd_all[name].cpu() - gc).norm() / gc.norm().clamp(min=1e-30))
            worst = max(worst, rel)
            if not rel <= tol:
                fail(f"families_train_check {run}: gradient {name} differs by {rel} of its norm")
        # AdamW's first step moves each weight by about lr whatever its
        # gradient, so the update is checked from the same gradient: the
        # CPU's, on both sides
        oc = opt.OptConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=1, schedule="constant")
        g_cd = tree_map(lambda t: t.to(dev), g_c)
        pc, sc = opt.apply_updates(p_cpu, g_c, opt.init_state(p_cpu, oc), oc)
        pd, sd = opt.apply_updates(p_dev, g_cd, opt.init_state(p_dev, oc), oc)
        pd_all = leafwise(pd)
        moved = max(float((pd_all[name].cpu() - w).abs().max()) for name, w in leafwise(pc).items())
        if not all(bool(((pd_all[name].cpu() - w).abs()
                         <= FAMILY_UPDATE_TOL * (1 + w.abs())).all())
                   for name, w in leafwise(pc).items()):
            fail(f"families_train_check {run}: AdamW's update from the same gradient differs "
                 f"by {moved} on the card")
        out[run] = {**row, "grad_max_rel_norm_err": worst, "update_max_abs_err": moved,
                    "update_tol": FAMILY_UPDATE_TOL}
        del p_dev, g_d, g_cd, pd, sd
        torch.cuda.empty_cache()
    return out


def spmd_group(torch, tmp: Path):
    """A process group of one rank on NCCL (a FileStore in ``tmp``) and its
    DeviceMesh("cuda", (1,), ("data",))."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "store"), 1), rank=0,
                            world_size=1, timeout=timedelta(seconds=SPMD_PG_TIMEOUT_S))
    # a phase that fails leaves the group up: destroy it at exit, or NCCL's
    # watchdog holds the process until the group's timeout
    atexit.register(lambda: dist.is_initialized() and dist.destroy_process_group())
    if dist.get_backend() != "nccl":
        fail(f"the spmd phase's process group runs {dist.get_backend()}, not nccl")
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    # NCCL sets its communicator up at the first collective: before the walls
    from repro_torch.core.backends import direct

    direct.barrier("data", mesh)
    torch.cuda.synchronize()
    return mesh


def spmd_frames_phase(torch, np, mesh, left, right, gk, gv, launches, hp_k, jp_k, sr_k,
                      fa_k) -> dict:
    """(a) join_spmd on one join worker's tables (raw and compressed) and
    groupby_spmd on one groupby worker's rows (combiner on and off) over the
    mesh's "data" axis; rows and sums exact against numpy (module doc)."""
    import torch.distributed as dist

    from repro_torch.core.backends import direct
    from repro_torch.dataframe import Table, ops_dist

    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    n_l, n_r = int(left.count), int(right.count)
    lk, lv = (left.columns[c][:n_l].cpu().numpy() for c in ("k", "v"))
    rk, rw = (right.columns[c][:n_r].cpu().numpy() for c in ("k", "w"))
    common, li, ri = np.intersect1d(lk, rk, assume_unique=True, return_indices=True)

    def run(name, fn, check):
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        for k, c in got.items():
            launches.setdefault(k, {})[name] = c
        check(res.to_numpy(), got)
        out[name] = {"wall_s": wall, "rows": int(res.count), "launches": got}

    def join_check(tag):
        def check(cols, got):
            order = np.argsort(cols["k"])
            if not (np.array_equal(cols["k"][order], common)
                    and np.array_equal(cols["v"][order], lv[li])
                    and np.array_equal(cols["w"][order], rw[ri])):
                fail(f"join_spmd ({tag}) rows differ from numpy's join")
            if got["hash_partition"] < 2 or got["join_probe"] != 1:
                fail(f"join_spmd ({tag}) launches {got}: want hash >= 2, probe == 1")
        return check

    rows = GROUPBY_ROWS
    expected = np.bincount(gk[:rows].cpu().numpy(), weights=gv[:rows].cpu().numpy(),
                           minlength=GROUPS).astype(np.int64)
    table = Table.from_dict({"k": gk[:rows], "v": gv[:rows]}, device=gk.device)

    def groupby_check(combine):
        def check(cols, got):
            if not (np.array_equal(np.sort(cols["k"]), np.arange(GROUPS))
                    and np.array_equal(cols["v_sum"].astype(np.int64), expected[cols["k"]])):
                fail(f"groupby_spmd combine={combine}: groups or sums differ from np.bincount")
            if got["segment_reduce"] != (2 if combine else 1) or got["hash_partition"] != 1:
                fail(f"groupby_spmd combine={combine} launches {got}")
        return check

    with direct.use_mesh(mesh):
        for compress in (False, True):
            tag = "compressed" if compress else "raw"
            run(f"spmd_join_{tag}", lambda c=compress: ops_dist.join_spmd(
                left, right, "k", "data", compress=c), join_check(tag))
        for combine in (True, False):
            run(f"spmd_groupby_combine_{str(combine).lower()}",
                lambda c=combine: ops_dist.groupby_spmd(table, "k", {"v": "sum"}, "data",
                                                        combine=c), groupby_check(combine))
    out.update(join_rows=len(common), join_rows_per_side=(n_l, n_r), groupby_rows=rows)
    return out


def spmd_model_phase(torch, seed, mesh, launches, hp_k, jp_k, sr_k, fa_k) -> dict:
    """(b) the islands of attention_sharded, (c) head width 112, (d) the dp
    steps, (e) the expert-parallel MoE (module doc); the kernel rows of each
    new flash-attention shape."""
    import contextlib
    import dataclasses

    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ref as fa_r
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    timer = Timer(torch)
    rows, checks = {}, {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def errs(got, exp, tol, what):
        err = max(float((a - e).abs().max()) for a, e in zip(got, exp))
        if not all(bool(((a - e).abs() <= tol + tol * e.abs()).all()) for a, e in zip(got, exp)):
            fail(f"spmd: {what} differs by {err} (limit {tol})")
        return err

    @contextlib.contextmanager
    def path(name):
        """Launches in the block (not the comparisons' own) onto path ``name``."""
        before = counters(hp_k, jp_k, sr_k, fa_k)
        yield
        after = counters(hp_k, jp_k, sr_k, fa_k)
        for k, c in after.items():
            launches.setdefault(k, {})
            launches[k][name] = launches[k].get(name, 0) + c - before[k]

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def fwd_row(name, q, k, v, kw, design):
        """The forward with lse at ``kw`` (q_offset, causal): time, bound
        (its design's engine), the plain version, SDPA; its kernels' device
        times and, for ``flash_tiled``, the key split's chunks."""
        full = dict(causal=kw["causal"], window=0, q_offset=kw["q_offset"], kv_len=k.shape[1])
        nbytes, ops = flash_work(torch, q, k, **full)
        nbytes += 4 * q.shape[0] * q.shape[2] * q.shape[1]  # lse
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[design])
                    if design in FLASH_SPLIT else bound(nbytes, ops))
        ms = timer.ms(lambda: fa_k.flash_attention_lse(q, k, v, **kw))
        rows[name] = {"design": design, "q": list(q.shape), "kv": list(k.shape), **kw,
                      "ms": ms, "plain_ms": timer.ms(lambda: fa_r.attention_lse_ref(q, k, v, **kw)),
                      "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
                      "bytes": nbytes, "operations": ops,
                      "library_ms": timer.ms(sdpa_call(torch, q, k, v, **full)),
                      "passes_ms": pass_ms(torch, timer,
                                           lambda: fa_k.flash_attention_lse(q, k, v, **kw), {
                          "merge": ("flash_tiled_merge",), "prologue": ("fwd_prep_kv",),
                          "kernel": ("flash_",)})}
        if design == "flash_tiled":
            b_, tq_, h_, _ = q.shape
            rows[name]["key_split_chunks"] = fa_k.tiled_plan(
                b_, tq_, k.shape[1], h_, k.shape[2], causal=kw["causal"], window=0,
                q_offset=kw["q_offset"], kv_len=k.shape[1], sms=sms).chunks

    def bwd_row(name, q, k, v, kw):
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        do = randn(*q.shape)
        mask = fa_r.key_mask(q.shape[1], k.shape[1], causal=kw["causal"], window=0,
                             q_offset=kw["q_offset"], kv_len=None, device=dev)
        pairs = int(mask.sum()) * q.shape[0] * q.shape[2]
        nbytes = flash_bwd_bytes(q, k, lse, mask)
        hd = q.shape[3]
        bms, bby = bound(nbytes, 10 * hd * pairs, "bf16_tensor", fa_k.BWD_SPLIT)
        ms = timer.ms(lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        library_ms = timer.ms(lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                                          retain_graph=True))
        rows[name] = {"design": fa_k.bwd_design(hd), "q": list(q.shape), "kv": list(k.shape),
                      **kw, "ms": ms,
                      "plain_ms": timer.ms(lambda: fa_r.attention_bwd_ref(q, k, v, o, lse, do,
                                                                          **kw)),
                      "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
                      "bytes": nbytes, "operations": 10 * hd * pairs, "split": fa_k.BWD_SPLIT,
                      "library_ms": library_ms,
                      # the device time of each pass
                      "passes_ms": pass_ms(
                          torch, timer,
                          lambda: fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                          BWD_PASSES),
                      "key_split_chunks": fa_k.bwd_plan(
                          hd, q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                          causal=kw["causal"], window=0, q_offset=kw["q_offset"],
                          sms=sms).chunks}
        del leaves, out

    def through_port(q_l, k, v, do_l, call):
        """``call`` (the port's entry point) on leaves, forward and backward:
        (o, dq, dk, dv)."""
        leaves = [x.detach().requires_grad_() for x in (q_l, k, v)]
        o = call(*leaves)
        o.backward(do_l)
        return o.detach(), *(x.grad for x in leaves)

    def against_plain(what, q, k, v, do, got, kw):
        """The port's (o, dq, dk, dv) against the plain versions from the
        kernel's own o and lse (the comparisons' launches are not the path's)."""
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
        fe = errs((got[0], o, lse), (o_r, o_r, lse_r), FLASH_TOL, f"{what} forward")
        be = errs(got[1:], fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw), BWD_TOL,
                  f"{what} backward")
        return fe, be

    # -- (b) the islands, each rank's in turn, and whisper's cross-attention
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    for cell, arch, b, tps in SPMD_ISLANDS:
        cfg = configs.get(arch)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, do = randn(b, TRAIN_SEQ, h, hd), randn(b, TRAIN_SEQ, h, hd)
        k, v = randn(b, TRAIN_SEQ, kvh, hd), randn(b, TRAIN_SEQ, kvh, hd)
        plan = L.shard_plan(h, kvh, TRAIN_SEQ, tps)
        if plan != "seq":
            fail(f"spmd {cell}: the reference's rule picks {plan}, not the sequence split")
        tl = TRAIN_SEQ // tps
        parts, dk, dv, fwd_err, bwd_err = [], torch.zeros_like(k), torch.zeros_like(v), 0.0, 0.0
        split_by_island = []
        for r in range(tps):
            sl = slice(r * tl, (r + 1) * tl)
            q_l, do_l = q[:, sl].contiguous(), do[:, sl].contiguous()
            split0 = dict(fa_k.split_launches)
            with path(f"spmd_islands/{cell}"):
                got = through_port(q_l, k, v, do_l, lambda a, b_, c, r=r: L.attention_island(
                    a, b_, c, r, tps, plan="seq", causal=True))
            split_by_island.append({d: n - split0[d] for d, n in fa_k.split_launches.items()})
            fe, be = against_plain(f"{cell} island {r}", q_l, k, v, do_l, got,
                                   dict(causal=True, window=0, softcap=0.0, q_offset=r * tl))
            fwd_err, bwd_err = max(fwd_err, fe), max(bwd_err, be)
            parts.append(got[:2])
            dk += got[2]
            dv += got[3]
        # the islands reassembled against one full-length call
        kw = dict(causal=True, window=0, softcap=0.0)
        o_f, lse_f = fa_k.flash_attention_lse(q, k, v, **kw)
        g_f = fa_k.flash_attention_bwd(q, k, v, o_f, lse_f, do, **kw)
        errs((torch.cat([p_[0] for p_ in parts], 1),), (o_f,), FLASH_TOL, f"{cell} reassembled o")
        whole = errs((torch.cat([p_[1] for p_ in parts], 1), dk, dv), g_f, BWD_TOL,
                     f"{cell} reassembled gradients")
        # the key split (csrc/attn_plan.h): gemma3's 32-block islands split the
        # keys they see past the first island's 256 (forward), and every
        # backward takes the dS path (the first with one chunk); minicpm-2b's
        # (hd 64) never
        wide = hd == 256
        want_split = [{"flash_tiled": int(wide and r > 0), "bwd_wide": int(wide)}
                      for r in range(tps)]
        if split_by_island != want_split:
            fail(f"spmd {cell}: key-split calls by island {split_by_island}, want {want_split}")
        first_bwd = fa_k.bwd_plan(hd, b, tl, TRAIN_SEQ, h, kvh, causal=True, window=0,
                                  q_offset=0, sms=sms).chunks
        if wide and first_bwd != 1:
            fail(f"spmd {cell}: the first island's backward plans {first_bwd} chunks, want 1")
        checks[cell] = {"islands": tps, "rows_each": tl, "plan": plan, "fwd_max_abs_err": fwd_err,
                        "bwd_max_abs_err": bwd_err, "reassembled_max_abs_err": whole,
                        "key_split_by_island": split_by_island}
        # the last island (the most keys) timed, forward and backward, and
        # both kernels repeated: bit-equal
        last = dict(kw, q_offset=TRAIN_SEQ - tl)
        q_l, do_l = q[:, -tl:].contiguous(), do[:, -tl:].contiguous()
        runs = [fa_k.flash_attention_lse(q_l, k, v, **last) for _ in range(2)]
        grads = [fa_k.flash_attention_bwd(q_l, k, v, *runs[0], do_l, **last) for _ in range(2)]
        if not all(torch.equal(a, b_) for a, b_ in (*zip(*runs), *zip(*grads))):
            fail(f"spmd {cell}: the last island's forward or backward does not repeat bit-equal")
        checks[cell]["bit_equal_repeat"] = True
        del runs, grads, do_l
        design = fa_k.fwd_design(hd, torch.float32, tl * h // kvh, lse=True)
        fwd_row(f"flash_attention/{design}@{cell}", q_l, k, v, last, design)
        bwd_row(f"flash_attention_bwd/{fa_k.bwd_design(hd)}@{cell}", q_l, k, v, last)
        del q, do, k, v, parts, dk, dv, g_f, o_f, lse_f, q_l
        torch.cuda.empty_cache()
    arch, b, tq, tk = SPMD_CROSS
    cfg = configs.get(arch)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, do = randn(b, tq, h, hd), randn(b, tq, h, hd)
    k, v = randn(b, tk, kvh, hd), randn(b, tk, kvh, hd)
    kw = dict(causal=False, window=0, softcap=0.0, q_offset=0)
    with path("spmd_islands/whisper_cross"):
        got = through_port(q, k, v, do, lambda a, b_, c: L.attention(a, b_, c, causal=False))
    fe, be = against_plain("whisper cross-attention", q, k, v, do, got, kw)
    checks["whisper_cross"] = {"q": list(q.shape), "kv": list(k.shape), "fwd_max_abs_err": fe,
                               "bwd_max_abs_err": be}
    design = fa_k.fwd_design(hd, torch.float32, tq * h // kvh, lse=True)
    fwd_row(f"flash_attention/{design}@whisper_cross", q, k, v, kw, design)
    bwd_row(f"flash_attention_bwd/{fa_k.bwd_design(hd)}@whisper_cross", q, k, v, kw)
    del q, do, k, v, got
    islands = {d: sum(n for run, n in launches.get(f"flash_attention_bwd/{d}", {}).items()
                      if run.startswith("spmd_islands/"))
               for d in fa_k.bwd_design_launches}
    want = {"bwd_wgmma": SPMD_ISLANDS[0][3] + 1, "bwd_wide": SPMD_ISLANDS[1][3]}
    if islands != want:
        fail(f"spmd islands: backward launches by design {islands}, want {want}")
    torch.cuda.empty_cache()

    # -- (c) head width 112 at kimi-k2's attention
    cfg = configs.get("kimi-k2-1t-a32b")
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, do = randn(1, TRAIN_SEQ, h, hd), randn(1, TRAIN_SEQ, h, hd)
    k, v = randn(1, TRAIN_SEQ, kvh, hd), randn(1, TRAIN_SEQ, kvh, hd)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    kw = dict(causal=True, window=0, softcap=0.0, q_offset=0)
    with path("spmd_hd112/kimi_hd112"):
        o_b = L.attention(q, kb, vb, causal=True)              # serving: flash_wgmma
        got = through_port(q, k, v, do, lambda a, b_, c: L.attention(a, b_, c, causal=True))
    full = dict(causal=True, window=0, q_offset=0, kv_len=TRAIN_SEQ)
    bf16_err = errs((o_b,), (fa_r.attention_ref(q, kb, vb, **full),), FLASH_TOL,
                    "hd 112 bf16 forward")
    fe, be = against_plain("hd 112 training", q, k, v, do, got, kw)
    checks["kimi_hd112"] = {"q": list(q.shape), "kv": list(k.shape), "bf16_fwd_max_abs_err":
                            bf16_err, "fwd_max_abs_err": fe, "bwd_max_abs_err": be}
    nbytes, ops = flash_work(torch, q, kb, **full)
    bms, bby = bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT["flash_wgmma"])
    ms = timer.ms(lambda: fa_k.flash_attention(q, kb, vb, **full))
    rows["flash_attention/flash_wgmma@kimi_hd112"] = {
        "design": "flash_wgmma", "q": list(q.shape), "kv": list(kb.shape), **full, "ms": ms,
        "plain_ms": timer.ms(lambda: fa_r.attention_ref(q, kb, vb, **full)),
        "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms, "bytes": nbytes,
        "operations": ops, "library_ms": timer.ms(sdpa_call(torch, q, kb, vb, **full))}
    fwd_row("flash_attention/flash_wgmma_split@kimi_hd112", q, k, v, kw, "flash_wgmma_split")
    bwd_row("flash_attention_bwd/bwd_wgmma@kimi_hd112", q, k, v, kw)
    del q, do, k, v, kb, vb, o_b, got
    torch.cuda.empty_cache()
    for name, row in rows.items():
        cell = name.split("@")[1]
        row["path"] = ("spmd_hd112/" if cell == "kimi_hd112" else "spmd_islands/") + cell
        row["max_abs_err"] = checks[cell]["bwd_max_abs_err" if "bwd" in name
                                          else "fwd_max_abs_err"]
    rows["flash_attention/flash_wgmma@kimi_hd112"]["max_abs_err"] = bf16_err
    del timer
    torch.cuda.empty_cache()

    # -- (d) the data-parallel steps at world 1
    from repro_torch.core.backends import direct
    from repro_torch.dist.treepath import flatten_with_path, path_str
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api, moe
    from repro_torch.models.transformer import DistContext
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_compressed_dp_train_step, make_train_step

    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=SPMD_DP_LAYERS)
    oc = opt.OptConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 20, 5),
                       total_steps=TRAIN_STEPS, schedule=cfg.schedule,
                       state_dtype=cfg.opt_state_dtype)
    batch = next(ltrain.data_iter(cfg, TRAIN_B, TRAIN_SEQ, device=dev))

    def fresh():
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = api.init_params(cfg, g, device=dev, master=True)
        return params, opt.init_state(params, oc)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, state = fresh()
    step = make_train_step(cfg, oc, ctx=DistContext(mesh=mesh, dp_axes=("data",)))
    losses, t0 = [], time.perf_counter()
    with path("spmd_dp"):
        for _ in range(SPMD_DP_STEPS):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
    dp_wall = time.perf_counter() - t0
    host = {path_str(p_): w.cpu() for p_, w in flatten_with_path(params)}
    del params, state, step
    torch.cuda.empty_cache()
    params, state = fresh()
    ccfg = dataclasses.replace(cfg, grad_compression=True)
    cstep, init_err = make_compressed_dp_train_step(ccfg, oc, mesh)
    err = init_err(params)
    c_losses, t0 = [], time.perf_counter()
    with path("spmd_dp"):
        for _ in range(SPMD_DP_STEPS):
            params, state, err, m = cstep(params, state, err, batch)
            c_losses.append(float(m["loss"]))
    c_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    diff = max(float((w.cpu() - host[path_str(p_)]).abs().max())
               for p_, w in flatten_with_path(params))
    err_max = max(float(e.abs().max()) for _, e in flatten_with_path(err))
    limit = 2 * SPMD_DP_STEPS * TRAIN_LR
    if abs(c_losses[0] - losses[0]) > 1e-6 * abs(losses[0]):
        fail(f"spmd dp: step-0 losses differ: {losses[0]} vs {c_losses[0]}")
    if not diff <= limit:
        fail(f"spmd dp: parameters after {SPMD_DP_STEPS} steps differ by {diff} > {limit}")
    if not 0 < err_max < 1.0:
        fail(f"spmd dp: error-feedback residual {err_max} not in (0, 1)")
    if peak > 75e9:
        fail(f"spmd dp: peak {peak / 1e9:.1f} GB over 75 GB")
    dp = {"arch": TRAIN_ARCH, "layers": SPMD_DP_LAYERS, "B": TRAIN_B, "seq_len": TRAIN_SEQ,
          "steps": SPMD_DP_STEPS, "lr": TRAIN_LR, "losses": losses, "compressed_losses": c_losses,
          "param_max_abs_diff": diff, "limit": limit, "residual_max": err_max,
          "wall_s": dp_wall, "compressed_wall_s": c_wall, "peak_mem_bytes": peak,
          "world": direct.axis_size("data", mesh)}
    del params, state, err, host, batch
    torch.cuda.empty_cache()

    # -- (e) the expert-parallel dispatch on one qwen3-moe layer
    mcfg = configs.get("qwen3-moe-235b-a22b")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    blk = {k: w[0] for k, w in moe.init_moe_block(mcfg, g, 1, dev, dtype=torch.bfloat16).items()}
    x = torch.randn((SPMD_MOE_B, SPMD_MOE_T, mcfg.d_model), generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        y_ep, aux_ep = moe.moe_block(x, blk, mcfg, DistContext(mesh=mesh, ep_axis="data"))
        torch.cuda.synchronize()
        ep_wall = time.perf_counter() - t0
        y_loc, aux_loc = moe.moe_block(x, blk, mcfg, None)
    moe_err = errs((y_ep, aux_ep), (y_loc, aux_loc), 2e-4, "moe _moe_ep against _moe_local")
    del y_ep, y_loc
    # the backward through both dispatches: the gradients of <out, cot> + aux
    # for x, the router, wi and wo at 2e-4 (the bf16-stored leaves' gradients
    # are their float32 sums rounded once, so one rounding more)
    cot = torch.randn(x.shape, generator=g, device=dev)

    def moe_grads(ctx):
        leaves = {k: w.detach().requires_grad_() for k, w in blk.items()}
        xl = x.detach().requires_grad_()
        y, aux = moe.moe_block(xl, leaves, mcfg, ctx)
        ((y * cot).sum() + aux).backward()
        return {"x": xl.grad, **{k: leaves[k].grad for k in ("router", "wi", "wo")}}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_ep = moe_grads(DistContext(mesh=mesh, ep_axis="data"))
    torch.cuda.synchronize()
    ep_bwd_wall = time.perf_counter() - t0
    g_loc = moe_grads(None)
    grad_err = {}
    for name, ge in g_ep.items():
        rounded = BF16_ROUND if ge.dtype == torch.bfloat16 else 0.0
        grad_err[name] = 0.0
        # 2^27 elements at a time: the experts' gradients are 9.66 GB in bf16
        for a, b in zip(ge.reshape(-1).split(1 << 27), g_loc[name].reshape(-1).split(1 << 27)):
            a, b = a.float(), b.float()
            err = (a - b).abs()
            grad_err[name] = max(grad_err[name], float(err.max()))
            if not bool((err <= 2e-4 + (2e-4 + rounded) * b.abs()).all()):
                fail(f"spmd moe: the gradient of {name} through _moe_ep differs from "
                     f"_moe_local's by {grad_err[name]}")
    moe_row = {"arch": "qwen3-moe-235b-a22b", "x": list(x.shape),
               "expert_bytes": sum(w.numel() * w.element_size() for w in blk.values()),
               "max_abs_err": moe_err, "tol": 2e-4, "wall_s": ep_wall,
               "grad_max_abs_err": grad_err, "ep_fwd_bwd_wall_s": ep_bwd_wall}
    del blk, x, g_ep, g_loc
    torch.cuda.empty_cache()
    return {"checks": checks, "rows": rows, "dp": dp, "moe": moe_row}


def _dryrun_figures(rec: dict) -> dict:
    """The figures of a dry-run record that a trace must reproduce."""
    return {"flops": rec["cost_analysis"]["flops"],
            "wire_by_kind": rec["collectives"]["by_kind"],
            "argument_size_bytes": rec["memory_analysis"]["argument_size_bytes"],
            "peak_bytes_per_device": rec["memory_analysis"]["peak_bytes_per_device"]}


def dryrun_trace_child(part: int) -> int:
    """The dryrun phase's part (a), child processes of their own (the fake
    process group must be a process's default group; fake tensors: no
    memory on the card), which run beside phase 1's build and part (b):
    share ``part`` of the cells of ``DRYRUN_CELLS`` so marked (every
    ``DRYRUN_TRACE_CHILDREN``-th from the ``part``-th) traced at rank (0,
    0) on fake CUDA tensors,
    each one's FLOPs, wire bytes by kind, argument bytes and peak equal to
    the committed record (a fake's device changes no shape).  Prints one
    JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    # the flags the card's products run under (layers.check_products refuses
    # Griffin's and Whisper's bf16 products without the second, fakes too)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    marked = [(arch, shape) for arch, shape, on_card in DRYRUN_CELLS if on_card]
    for arch, shape in marked[part::DRYRUN_TRACE_CHILDREN]:
        want = _dryrun_figures(json.loads((dryrun.ARTIFACT_DIR / f"{arch}__{shape}__16x16.json")
                                          .read_text()))
        rec = dryrun.run_cell(arch, shape, coords=DRYRUN_COORDS, device="cuda", save=False)
        got = _dryrun_figures(rec)
        if got != want:
            fail(f"dryrun (a) {arch} {shape}: the fake-CUDA trace {got} != the record {want}")
        out[f"{arch}/{shape}"] = {**got, "trace_s": rec["trace_s"]}
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def _dryrun_setup(seed: int) -> tuple:
    """A dryrun child's card, production mesh, its fake ``DeviceMesh`` at
    ``DRYRUN_COORDS`` (the process's default group) and the ``--seed``
    generator."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    # the reference's bf16 products sum in float32: Griffin's and Whisper's
    # ranks refuse to run on the card without it (layers.check_products)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    mesh = make_production_mesh()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return dev, mesh, dryrun.fake_mesh(mesh, DRYRUN_COORDS, "cuda"), gen


def dryrun_cells(cells, dev, mesh, mesh_dev, gen, traces_done: Path | None,
                 launches: dict) -> dict:
    """Each cell of ``cells`` ((arch, shape, traced on fake CUDA tensors))
    at rank (0, 0), its rank program run for real on the card under the fake
    group (its collectives move nothing, so values are not checked), its
    arguments made one leaf at a time and freed before the next cell.  A
    first step: a cell not traced counts its FLOPs there (``FlopCounterMode``
    alone), which must equal the committed record's (a traced cell's trace
    (a) holds them, and its first step is a plain warm-up);
    ``max_memory_allocated`` within ``DRYRUN_PEAK_TOL`` of the record's
    estimate and under the card's memory; its flash calls by design
    ``DRYRUN_LAUNCHES``'s, its kernel launches added to ``launches``.  Then
    one step timed, with the same launches, once ``traces_done`` exists (the
    traces have ended) but for the cells of ``DRYRUN_BESIDE_TRACES`` (no wait
    without it).  The cells' lines."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.hash_partition import kernel as hp_k
    from repro_torch.kernels.join_probe import kernel as jp_k
    from repro_torch.kernels.segment_reduce import kernel as sr_k
    from repro_torch.launch import dryrun, shapes

    out = {}
    card = torch.cuda.get_device_properties(dev).total_memory
    for arch, shape, traced in cells:
        cfg, cell = configs.get(arch), shapes.SHAPES[shape]
        rc = dryrun.rank_cell(cfg, cell, mesh, DRYRUN_COORDS)
        name = f"{arch}/{shape}"

        def make(t, cfg=cfg, rc=rc):
            if t.dtype == torch.int32:  # tokens from --seed (a 0-d step counter: 0)
                if t.dim() == 0:
                    return torch.zeros((), dtype=torch.int32, device=dev)
                return torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=gen,
                                     device=dev, dtype=torch.int32)
            if not t.dtype.is_floating_point or rc.kind != "train" and t.dim() >= 5:
                return torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev)  # caches, int8
            # drawn in float32 a slice at a time: a bf16 leaf's draw never
            # holds more than one slice beside the leaf
            leaf = torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
            flat = leaf.view(-1)
            for i in range(0, flat.numel(), DRYRUN_MAKE_SLICE):
                n = min(DRYRUN_MAKE_SLICE, flat.numel() - i)
                flat[i:i + n] = torch.randn(n, generator=gen, device=dev).mul_(0.02)
            return leaf

        est = _dryrun_figures(json.loads((dryrun.ARTIFACT_DIR / f"{arch}__{shape}__16x16.json")
                                         .read_text()))
        torch.cuda.empty_cache()
        args = dryrun.materialize(rc, make)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the arguments held, none of their making
        step = dryrun.rank_step(cfg, rc, mesh_dev, args)
        # the step's result holds the rank's parameters and optimizer state
        # (a decode step's, its new state): not kept, so that they do not
        # outlive the cell's arguments

        def run(count: bool) -> tuple[float, float | None]:
            reset_counters(hp_k, jp_k, sr_k, fa_k)
            with contextlib.ExitStack() as stack:
                if rc.kind != "train":
                    stack.enter_context(torch.no_grad())
                mode = stack.enter_context(FlopCounterMode(display=False)) if count else None
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            return wall, None if mode is None else float(mode.get_total_flops())

        first_s, flops = run(not traced)
        peak = torch.cuda.max_memory_allocated()
        got = counters(hp_k, jp_k, sr_k, fa_k)
        if not traced and flops != est["flops"]:
            fail(f"dryrun {arch} {shape}: the card's step counted {flops} FLOPs, "
                 f"the estimate {est['flops']}")
        designs = {n.split("/")[1]: c for n, c in got.items()
                   if n.startswith(("flash_attention/", "flash_attention_bwd/")) and c}
        if designs != DRYRUN_LAUNCHES[name]:
            fail(f"dryrun {arch} {shape}: flash calls by design {designs}, want "
                 f"{DRYRUN_LAUNCHES[name]}")
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        t0 = time.perf_counter()
        while (traces_done is not None and name not in DRYRUN_BESIDE_TRACES
               and not traces_done.exists()):
            if time.perf_counter() - t0 > DRYRUN_TIMEOUT_S:
                fail(f"dryrun {arch} {shape}: the traces did not end")
            time.sleep(0.2)
        waited = time.perf_counter() - t0
        beside_traces = traces_done is not None and not traces_done.exists()
        wall, _ = run(False)
        if counters(hp_k, jp_k, sr_k, fa_k) != got:
            fail(f"dryrun {arch} {shape}: the timed step's launches differ from the first's")
        beside_traces = beside_traces or traces_done is not None and not traces_done.exists()
        first = ({"warmup_step_s": first_s, "flops_held_by": "trace (a)"} if traced else
                 {"flops": flops, "flops_equal": True, "counted_step_s": first_s})
        out[name] = {"record": est, "b": {
            **first, "step_s": wall, "step_beside_traces": beside_traces,
            "waited_for_traces_s": waited, "max_memory_allocated": peak,
            "estimate_peak": est["peak_bytes_per_device"],
            "peak_over_estimate": peak / est["peak_bytes_per_device"],
            "within_tol": abs(peak / est["peak_bytes_per_device"] - 1) <= DRYRUN_PEAK_TOL,
            "launches": {k: v for k, v in got.items() if v}}}
        if not out[name]["b"]["within_tol"] or peak > card:
            fail(f"dryrun {arch} {shape}: max_memory_allocated {peak} B against the "
                 f"estimate {est['peak_bytes_per_device']} B (within {DRYRUN_PEAK_TOL:.0%}) "
                 f"and the card's {card} B")
        del args, step
        torch.cuda.empty_cache()
    return out


def dryrun_serve_child(seed: int) -> int:
    """The dryrun phase's serving ranks (``DRYRUN_SERVE_CELLS``), a child
    process of their own (the fake process group must be its default
    group), started once the run child has ended: ``dryrun_cells``.
    Prints one JSON line."""
    import torch.distributed as dist

    launches: dict[str, int] = {}
    out = {"cells": dryrun_cells(DRYRUN_SERVE_CELLS, *_dryrun_setup(seed), None, launches),
           "launches": launches}
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def dryrun_child(seed: int, traces_done: Path) -> int:
    """The dryrun phase's part (b), a child process (the fake process group
    must be its default group): every cell of ``DRYRUN_CELLS`` through
    ``dryrun_cells``, its timed steps after the traces of part (a) but those
    of ``DRYRUN_BESIDE_TRACES``.  Also the training ranks' attention islands
    (``DRYRUN_ISLANDS``) held against their plain versions.  Prints one JSON
    line."""
    import torch

    dev, mesh, mesh_dev, gen = _dryrun_setup(seed)   # puts src/ on the path
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fa_k, ref as fa_r

    launches: dict[str, int] = {}
    out: dict = {"cells": dryrun_cells(DRYRUN_CELLS, dev, mesh, mesh_dev, gen, traces_done,
                                       launches)}
    # the training ranks' islands: q rows [q_offset, q_offset + 256) of 4096
    # (tp 16, the sequence split) over the whole keys, float32 k/v; model
    # rank 0 at q_offset 0 and, for gemma3-4b, model rank 15 at 3840 (the
    # most keys), on a full-attention layer and on a sliding-window one
    out["islands"] = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for arch, q_off, sliding, fwd_design, bwd_design in DRYRUN_ISLANDS:
        cfg = configs.get(arch)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, do = (torch.randn(4, 256, h, hd, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(4, 4096, kvh, hd, generator=gen, device=dev) for _ in range(2))
        kw = dict(causal=True, window=cfg.sliding_window if sliding else 0, q_offset=q_off)
        before = [dict(c) for c in (fa_k.fwd_design_launches, fa_k.bwd_design_launches,
                                    fa_k.split_launches)]
        o, lse = fa_k.flash_attention_lse(q, k, v, **kw)
        grads = fa_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        designs = tuple({d: n - was[d] for d, n in now.items() if n - was[d]} for now, was in zip(
            (fa_k.fwd_design_launches, fa_k.bwd_design_launches, fa_k.split_launches), before))
        o_r, lse_r = fa_r.attention_lse_ref(q, k, v, **kw)
        grads_r = fa_r.attention_bwd_ref(q, k, v, o, lse, do, **kw)
        fwd_err = max(float((a - e).abs().max()) for a, e in ((o, o_r), (lse, lse_r)))
        bwd_err = max(float((a - e).abs().max()) for a, e in zip(grads, grads_r))
        what = f"dryrun island {arch} at q_offset {q_off}, window {kw['window']}"
        if not all(bool(((a - e).abs() <= FLASH_TOL + FLASH_TOL * e.abs()).all())
                   for a, e in ((o, o_r), (lse, lse_r))):
            fail(f"{what}: the forward differs from the plain version: {fwd_err}")
        if not all(bool(((a - e).abs() <= BWD_TOL + BWD_TOL * e.abs()).all())
                   for a, e in zip(grads, grads_r)):
            fail(f"{what}: the backward differs from the plain version: {bwd_err}")
        off = one_key_too_few(torch, fa_r, q, k, v, o, lse, do, grads, kw)
        if off is None:
            fail(f"{what}: the limits do not tell one key too few")
        # the hd-256 designs: each splits where its plan does; on a
        # full-attention layer the backward takes the dS path (bwd_dq_ds)
        split = {}
        if hd == 256:
            fwd_chunks = fa_k.tiled_plan(4, 256, 4096, h, kvh, kv_len=4096, sms=sms, **kw).chunks
            ds = fa_k.bwd_plan(hd, 4, 256, 4096, h, kvh, sms=sms, **kw).chunks > 0
            if not (ds or sliding):
                fail(f"{what}: the backward's plan leaves the dS path")
            split = {d: 1 for d, on in (("flash_tiled", fwd_chunks > 1), ("bwd_wide", ds)) if on}
        want = ({fwd_design: 1}, {bwd_design: 1}, split)
        if designs != want:
            fail(f"{what} ran {designs}, want {want}")
        out["islands"][f"{arch}@{q_off}" + ("/window" if sliding else "")] = {
            "q": list(q.shape), "kv": list(k.shape), **kw, "designs": designs,
            "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err,
            "one_key_off_max_abs_err": off, "tol": [FLASH_TOL, BWD_TOL]}
        del q, k, v, do, o, lse, grads, o_r, lse_r, grads_r
    # the dispatcher's host cost per flash call: the custom op against the
    # wrapper it dispatches to, at a decode call whose device time is a few
    # us (the host sets the pace), 2,000 calls a side, alternating, median
    from repro_torch.kernels.flash_attention import ops as fa_ops

    qd = torch.randn(1, 1, 8, 256, generator=gen, device=dev)
    kd = torch.randn(1, 64, 4, 256, generator=gen, device=dev).to(torch.bfloat16)
    sides = {"wrapper": lambda: fa_k.flash_attention(qd, kd, kd, kv_len=64),
             "custom_op": lambda: fa_ops.flash_attention(qd, kd, kd, kv_len=64)}
    per_call: dict[str, list[float]] = {name: [] for name in sides}
    for _ in range(3):
        for name, fn in sides.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            per_call[name].append((time.perf_counter() - t0) / 2000 * 1e6)
    med = {name: statistics.median(v) for name, v in per_call.items()}
    out["dispatch_us_per_call"] = {**per_call, "median": med,
                                   "custom_op_minus_wrapper": med["custom_op"] - med["wrapper"]}
    out["launches"] = launches
    print(json.dumps(out), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def child_start(tmp: Path, tag: str, *args: str) -> tuple:
    """This script started again with ``args`` as a child process, its
    output to files under ``tmp``: (the process, its files)."""
    files = tuple(open(tmp / f"{tag}.{n}", "w+") for n in ("out", "err"))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *args],
                            stdout=files[0], stderr=files[1], text=True)
    return proc, files


def child_line(child: tuple, t0: float, what: str) -> dict:
    """Wait for ``child`` of ``child_start`` (at most ``DRYRUN_TIMEOUT_S``
    from ``t0``, killed past it) and read the JSON object of its last
    line."""
    proc, files = child
    try:
        proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{what} ran past {DRYRUN_TIMEOUT_S} s")
    out, err = (f.seek(0) or f.read() for f in files)
    for f in files:
        f.close()
    if proc.returncode != 0:
        fail(f"{what} failed ({proc.returncode}):\n{out[-3000:]}\n{err[-5000:]}")
    return json.loads(out.strip().splitlines()[-1])


def dryrun_trace_start(tmp: Path) -> tuple:
    """Start the ``DRYRUN_TRACE_CHILDREN`` children of ``dryrun_trace_child``:
    ([each one's ``child_start``], the start time)."""
    return [child_start(tmp, f"dryrun_trace{part}", "--dryrun-child", "trace",
                        "--trace-part", str(part))
            for part in range(DRYRUN_TRACE_CHILDREN)], time.perf_counter()


def dryrun_trace_finish(started: tuple, done: Path) -> dict:
    """Wait for the children of ``dryrun_trace_start``, then make ``done``
    (the run child's sign that they have ended); merge their cells."""
    children, t0 = started
    cells = {}
    for child in children:
        cells.update(child_line(child, t0, "a dryrun trace child"))
    wall = time.perf_counter() - t0
    done.touch()
    return {"cells": cells, "wall_s": wall}


def dryrun_start(torch, tmp: Path, seed: int, traces_done: Path | None,
                 child: str = "run") -> tuple:
    """Start ``dryrun_child`` (``child`` "run") or ``dryrun_serve_child``
    ("serve", which takes no ``traces_done``) while this process holds
    nothing on the card: (its ``child_start``, the start time, the bytes
    this process holds)."""
    torch.cuda.empty_cache()
    args = ("--traces-done", str(traces_done)) if child == "run" else ()
    return (child_start(tmp, f"dryrun_{child}", "--dryrun-child", child, "--seed", str(seed),
                        *args),
            time.perf_counter(), torch.cuda.memory_allocated())


def dryrun_finish(started: tuple, launches: dict) -> dict:
    """Wait for the child of ``dryrun_start``; its kernel launches join the
    launch counts under the path ``dryrun_rank``."""
    child, t0, parent_bytes = started
    out = child_line(child, t0, "the dryrun child")
    for name, c in out.pop("launches").items():
        by_path = launches.setdefault(name, {})
        by_path["dryrun_rank"] = by_path.get("dryrun_rank", 0) + c
    return {**out, "parent_allocated_bytes": parent_bytes, "wall_s": time.perf_counter() - t0}


def _ptxas(pattern: str) -> dict:
    """Registers and spills of each built kernel whose name holds ``pattern``."""
    from repro_torch.kernels import _build

    return {name.split("_cu_")[-1]: rep for name, rep in _build.ptxas_report(pattern).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun-child", choices=("trace", "run", "serve"), help=argparse.SUPPRESS)
    ap.add_argument("--trace-part", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--traces-done", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.dryrun_child == "trace":
        return dryrun_trace_child(args.trace_part)
    if args.dryrun_child == "run":
        return dryrun_child(args.seed, args.traces_done)
    if args.dryrun_child == "serve":
        return dryrun_serve_child(args.seed)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import make_communicator
    from repro_torch.dataframe import Table, ops_dist
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_k, ref as fa_r
    from repro_torch.kernels.hash_partition import kernel as hp_k, ref as hp_r
    from repro_torch.kernels.join_probe import kernel as jp_k, ref as jp_r
    from repro_torch.kernels.segment_reduce import kernel as sr_k, ref as sr_r

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    # -- 1. device + build ----------------------------------------------------
    smi = smi_line()
    print(smi, flush=True)
    # phase 1b (a), the dryrun traces on fake tensors (no kernel, nothing on
    # the card), in children of their own from here to the end of phase 1b
    import tempfile

    child_tmp = tempfile.TemporaryDirectory()
    tracing = dryrun_trace_start(Path(child_tmp.name))
    children = list(tracing[0])
    atexit.register(lambda: [p.kill() for p, _ in children if p.poll() is None])
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "size_cuts": SIZE_CUTS})
    # phase 1b (b) from here, while this process holds nothing on the card
    # (the child's rank programs need up to ~62 GB) and checks the build on
    # the host alone (ptxas's report, the SASS)
    traces_done = Path(child_tmp.name) / "traces_done"
    running = dryrun_start(torch, Path(child_tmp.name), args.seed, traces_done)
    children.append(running[0])
    emit({"phase": "ptxas", **{pat: _build.ptxas_report(pat) for pat in (
        "flash_wgmma", "fwd_prep_kv", "flash_decode", "flash_tiled", "bwd_wgmma", "bwd_wide",
        "bwd_dq", "bwd_kv", "bwd_prep", "probe_kernel", "build_index")}})
    # flash_wgmma<HD, false> (bf16 k/v) and <HD, true> (flash_wgmma_split),
    # bwd_wgmma (BWD_WGMMA_INSTANCES), bwd_wide's seven instances and
    # bwd_dq_ds: every instance on the tensor cores
    for name, instances in (("flash_wgmma", ("ELb0E", "ELb1E")),
                            ("bwd_wgmma", BWD_WGMMA_INSTANCES),
                            ("bwd_wide", BWD_WIDE_INSTANCES), ("bwd_dq_ds", ("",))):
        hgmma = sass_has(_build.build(), name, "HGMMA")
        if not all(any(i in f for f in hgmma) for i in instances) or not all(hgmma.values()):
            fail(f"{name}'s SASS holds no HGMMA (tensor-core) instruction: {hgmma}")

    # counter name -> main-path run -> launches (see ``counters``)
    launches: dict[str, dict[str, int]] = {}

    # -- 1b. dryrun: one rank of the 16 x 16 mesh, traced and run for real ----------
    # (a)'s children, then (b)'s, are waited for, so that no busy host
    # process runs beside the timed phases
    dryrun_trace = dryrun_trace_finish(tracing, traces_done)
    dryrun_run = dryrun_finish(running, launches)
    emit({"phase": "dryrun", "part": "run", **dryrun_run})
    emit({"phase": "dryrun", "part": "trace", **dryrun_trace})
    # the serving ranks, in a child of their own once the run child has ended
    serving = dryrun_start(torch, Path(child_tmp.name), args.seed, None, "serve")
    children.append(serving[0])
    emit({"phase": "dryrun", "part": "serve", **dryrun_finish(serving, launches)})
    child_tmp.cleanup()

    timer = Timer(torch)
    kernels: dict[str, dict] = {}

    # -- 2. kernels against their plain versions --------------------------------
    def abs_err(a, b) -> int:
        """Largest |a - b| over two integer (or uint32) tensors, as an int."""
        if a.dtype == torch.uint32:
            a, b = (t.view(torch.int32).long() & 0xFFFFFFFF for t in (a, b))
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    # hash/bucket/histogram at the two shapes the shuffles give it: one join
    # worker's table (capacity int(1.1 * 9.1M) + 8, 9.1M valid rows, P = 8)
    # and one groupby worker's table (50M rows, all valid, P = 4).  Timed 4
    # launches per input copy back to back (see Timer).
    hash_shapes = {}
    for cell, n, valid, parts, copies in (
        ("join", int(1.1 * JOIN_ROWS) + 8, JOIN_ROWS, JOIN_P, 4),
        ("groupby", GROUPBY_ROWS, GROUPBY_ROWS, GROUPBY_P, 2),
    ):
        keys = [torch.randint(-(2**31), INT32_MAX, (n,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(copies)]
        count = torch.tensor(valid, dtype=torch.int32, device=dev)
        _, b_k, hist_k = hp_k.row_buckets([keys[0]], parts, count)
        b_p, hist_p = hp_r.row_buckets_ref([keys[0]], parts, count)
        err = max(abs_err(b_k, b_p), abs_err(hist_k, hist_p))
        if err:
            fail(f"hash_partition row buckets/histogram differ from the plain version ({cell})")
        bms, bby = bound(4 * n + 4 + 4 * n + 4 * (parts + 1), 12 * n)
        hash_shapes[cell] = {
            "n": n, "valid": valid, "P": parts, "max_abs_err": err,
            "ms": timer.ms(*rotating(lambda k, p=parts, c=count: hp_k.row_buckets([k], p, c),
                                     keys, 4 * copies)),
            "plain_ms": timer.ms(lambda p=parts, c=count: hp_r.row_buckets_ref([keys[0]], p, c)),
            "bound_ms": bms, "bound_by": bby,
        }
        if cell == "join":
            h1, b1 = hp_k.hash_partition(keys[0], num_partitions=parts)
            h2, b2 = hp_r.hash_partition_ref(keys[0], num_partitions=parts)
            single_err = max(abs_err(h1, h2), abs_err(b1, b2))
            if single_err:
                fail("hash_partition single-column entry differs from the plain version")
            single = {
                "max_abs_err": single_err,
                "ms": timer.ms(*rotating(lambda k, p=parts: hp_k.hash_partition(k, num_partitions=p),
                                         keys, 4 * copies)),
                "plain_ms": timer.ms(
                    lambda p=parts: hp_r.hash_partition_ref(keys[0], num_partitions=p)),
            }
            del h1, b1, h2, b2
        del keys, b_k, hist_k, b_p, hist_p
    kernels["hash_partition"] = {
        "name": "hash_partition", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hash_partition.cu",
        "replaces": "src/repro/kernels/hash_partition/kernel.py:23",
        **hash_shapes["join"],
        "max_abs_err": max(s["max_abs_err"] for s in hash_shapes.values()),
        "library_ms": None,
        "shapes": hash_shapes,
    }
    emit({"phase": "kernel", **kernels["hash_partition"], "single_column_entry": single})

    # probe: the receive page of a join worker, ~20M int32 of which half are
    # INT32_MAX padding, probed by ~20M left keys
    page = JOIN_P * (int(1.1 * JOIN_ROWS) + 8) // JOIN_P * 2
    key_space = 2 * JOIN_ROWS * JOIN_P
    real = page // 2
    right = torch.randperm(key_space, generator=gen, device=dev)[:real].to(torch.int32)
    right = torch.cat([torch.sort(right).values,
                       torch.full((page - real,), INT32_MAX, dtype=torch.int32, device=dev)])
    left = torch.randint(0, key_space, (page,), generator=gen, device=dev, dtype=torch.int32)
    left[:16] = INT32_MAX  # the sentinel-equal keys join_unique must guard
    i_k, hit_k = jp_k.probe_sorted(right, left)
    i_p, hit_p = jp_r.probe_sorted_ref(right, left)
    if not (torch.equal(i_k, i_p) and torch.equal(hit_k, hit_p)):
        fail(f"join_probe differs from the plain version: {int((i_k != i_p).sum())} positions, "
             f"{int((hit_k != hit_p).sum())} hits")
    steps = max(1, page.bit_length())
    bms, bby = bound(4 * page + 4 * page + 4 * page + page, page * steps)
    kernels["join_probe"] = {
        "name": "join_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_probe.cu",
        "replaces": "src/repro/kernels/join_probe/kernel.py:23",
        "max_abs_err": int((i_k - i_p).abs().max()),
        "ms": timer.ms(lambda: jp_k.probe_sorted(right, left)),
        "plain_ms": timer.ms(lambda: jp_r.probe_sorted_ref(right, left)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": timer.ms(lambda: torch.searchsorted(right, left)),
        "shape": {"page": page, "real": real, "left": page,
                  "hits": int(hit_k.sum())},
    }
    emit({"phase": "kernel", **kernels["join_probe"]})
    del right, left, i_k, hit_k, i_p, hit_p

    # segment sum at the three shapes groupby_agg gives it.  There a table of
    # capacity cap is sorted by key; each valid row's segment id is the rank
    # of its key among the distinct keys, every padding row sits in the
    # overflow segment cap, and num_segments is cap + 1 (so each call also
    # writes 4 * (cap + 1) bytes of output).
    #   combine        a worker's 50M rows over 1000 groups: cap 50M, no padding
    #                  (combiner on, before the shuffle);
    #   merge_combined a received table, cap 2 * sum(cap) / P = 100M, holding
    #                  the ~1000 partial rows of the ~250 groups hashed to it,
    #                  the rest padding (combiner on, after the shuffle);
    #   merge_raw      the same cap holding ~50M raw rows of ~250 groups, the
    #                  rest padding (combiner off, after the shuffle).
    def groupby_segments(cap: int, valid: int, groups: int):
        seg = torch.full((cap,), cap, dtype=torch.int32, device=dev)
        seg[:valid] = torch.sort(torch.randint(0, groups, (valid,), generator=gen, device=dev,
                                               dtype=torch.int32)).values
        return seg

    merge_cap = GROUPBY_P * GROUPBY_ROWS // GROUPBY_P * 2
    seg_shapes = {}
    for cell, cap, valid, groups in (
        ("combine", GROUPBY_ROWS, GROUPBY_ROWS, GROUPS),
        ("merge_combined", merge_cap, GROUPS, GROUPS // GROUPBY_P),
        ("merge_raw", merge_cap, GROUPBY_ROWS, GROUPS // GROUPBY_P),
    ):
        seg = groupby_segments(cap, valid, groups)
        nseg = cap + 1
        vi = torch.randint(0, 100, (cap,), generator=gen, device=dev, dtype=torch.int32)
        s_k = sr_k.segment_sum(seg, vi, nseg)
        s_p = sr_r.segment_sum_ref(seg, vi, nseg)
        err = abs_err(s_k, s_p)
        if err:
            fail(f"segment_reduce int32 differs from the plain version ({cell})")
        acc = torch.zeros(nseg, dtype=torch.int32, device=dev)
        bms, bby = bound(4 * cap + 4 * cap + 4 * nseg, cap)
        seg_shapes[cell] = {
            "n": cap, "num_segments": nseg, "valid": valid, "groups": groups,
            "dtype": "int32", "max_abs_err": err,
            "ms": timer.ms(lambda: sr_k.segment_sum(seg, vi, nseg)),
            "plain_ms": timer.ms(lambda: sr_r.segment_sum_ref(seg, vi, nseg)),
            "bound_ms": bms, "bound_by": bby,
            "library_ms": timer.ms(lambda: acc.index_add_(0, seg, vi)),
        }
        if cell == "combine":
            vf = torch.rand(cap, generator=gen, device=dev)
            f_k = sr_k.segment_sum(seg, vf, nseg).double()
            f_p = sr_r.segment_sum_ref(seg, vf, nseg).double()
            f_x = sr_r.segment_sum_ref(seg, vf.double(), nseg)
            f32_err_plain = float(((f_k - f_p).abs() / f_x.abs().clamp(min=1)).max())
            f32_err_exact = float(((f_k - f_x).abs() / f_x.abs().clamp(min=1)).max())
            if f32_err_plain > SEGSUM_F32_RTOL_VS_PLAIN or f32_err_exact > SEGSUM_F32_RTOL_VS_EXACT:
                fail(f"segment_reduce float32 off: rel err {f32_err_plain} vs plain, "
                     f"{f32_err_exact} vs float64")
            # dense: ~5 rows per segment (far above the Pallas kernel's 128 per block)
            dense = torch.sort(torch.randint(0, cap // 5, (cap,), generator=gen, device=dev,
                                             dtype=torch.int32)).values
            if not torch.equal(sr_k.segment_sum(dense, vi, cap // 5),
                               sr_r.segment_sum_ref(dense, vi, cap // 5)):
                fail("segment_reduce int32 differs from the plain version at 10M segments")
            del vf, f_k, f_p, f_x, dense
        del seg, vi, s_k, s_p, acc
        torch.cuda.empty_cache()
    kernels["segment_reduce"] = {
        "name": "segment_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "replaces": "src/repro/kernels/segment_reduce/kernel.py:23",
        **seg_shapes["merge_combined"],
        "max_abs_err": max(s["max_abs_err"] for s in seg_shapes.values()),
        "f32_max_rel_err_vs_plain": f32_err_plain,
        "f32_max_rel_err_vs_float64": f32_err_exact,
        "f32_rtol": {"vs_plain": SEGSUM_F32_RTOL_VS_PLAIN, "vs_float64": SEGSUM_F32_RTOL_VS_EXACT},
        "shapes": seg_shapes,
    }
    emit({"phase": "kernel", **kernels["segment_reduce"]})
    del timer
    torch.cuda.empty_cache()

    # -- 3. sim_join at the weak-scaling size -----------------------------------
    p, rows = JOIN_P, JOIN_ROWS
    cap = int(rows * 1.1) + 8
    key_space = 2 * rows * p
    lk = torch.randperm(key_space, generator=gen, device=dev)[: rows * p].to(torch.int32)
    rk = torch.randperm(key_space, generator=gen, device=dev)[: rows * p].to(torch.int32)
    lv = torch.randint(0, 1 << 20, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    rw = torch.randint(0, 1 << 20, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    left = [Table.from_dict({"k": lk[i * rows:(i + 1) * rows], "v": lv[i * rows:(i + 1) * rows]},
                            capacity=cap, device=dev) for i in range(p)]
    right = [Table.from_dict({"k": rk[i * rows:(i + 1) * rows], "w": rw[i * rows:(i + 1) * rows]},
                             capacity=cap, device=dev) for i in range(p)]
    comm = make_communicator(p, "direct")
    torch.cuda.synchronize()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    out = ops_dist.sim_join(left, right, "k", comm)
    torch.cuda.synchronize()
    wall = join_wall = time.perf_counter() - t0
    got = counters(hp_k, jp_k, sr_k, fa_k)
    for name, c in got.items():
        launches.setdefault(name, {})["join"] = c
    if got["hash_partition"] < 2 * p or got["join_probe"] != p:
        fail(f"join launches {got}: want hash >= {2 * p}, probe == {p}")
    emit({"phase": "trace", "cell": "join", **trace(
        torch, lambda: ops_dist.sim_join(left, right, "k", make_communicator(p, "direct")))})

    # independent check in numpy: every joined row is (k, left v of k, right w of k)
    lk_h, rk_h, lv_h, rw_h = (t.cpu().numpy() for t in (lk, rk, lv, rw))
    del lk, rk, lv, rw
    v_of = np.zeros(key_space, np.int64)
    w_of = np.zeros(key_space, np.int64)
    v_of[lk_h] = lv_h
    w_of[rk_h] = rw_h
    hit_l = np.isin(lk_h, rk_h, kind="table")
    hit_r = np.isin(rk_h, lk_h, kind="table")
    exp = {"rows": int(hit_l.sum()), "sum_v": int(lv_h[hit_l].sum(dtype=np.int64)),
           "sum_w": int(rw_h[hit_r].sum(dtype=np.int64))}
    seen = np.zeros(key_space, bool)
    res = {"rows": 0, "sum_v": 0, "sum_w": 0}
    for t in out:
        cols = t.to_numpy()
        k = cols["k"].astype(np.int64)
        if not (np.array_equal(cols["v"], v_of[k]) and np.array_equal(cols["w"], w_of[k])):
            fail("sim_join produced a row whose v or w does not belong to its key")
        if seen[k].any():
            fail("sim_join produced a key twice")
        seen[k] = True
        res["rows"] += k.shape[0]
        res["sum_v"] += int(cols["v"].sum(dtype=np.int64))
        res["sum_w"] += int(cols["w"].sum(dtype=np.int64))
    if res != exp:
        fail(f"sim_join result {res} != numpy {exp}")
    emit({"phase": "join", "P": p, "rows_per_worker": rows, "capacity": cap, "wall_s": wall,
          "bytes_on_wire": comm.bytes_on_wire, "comm_time_s": comm.comm_time_s,
          "events": len(comm.events), "launches": got, **res})
    del v_of, w_of, seen, lk_h, rk_h, lv_h, rw_h

    # -- 3b. comm: the join over four fabrics, the collectives, the lifecycle ---
    t0 = time.perf_counter()
    # the join's tables and rows stay for the codec phase (4c)
    join_out = out
    comm_join = comm_join_phase(torch, args.seed, left, right, join_out, launches,
                                hp_k, jp_k, sr_k, fa_k)
    torch.cuda.empty_cache()
    for name, row in comm_join["fabrics"].items():
        emit({"phase": "comm", "part": "join", "fabric": name, "P": comm_join["P"],
              "blocked_pairs": comm_join["blocked_pairs"] if name.startswith("hybrid") else [],
              **row})
    emit({"phase": "comm", "part": "collectives", **collectives_check(torch, gen)})
    torch.cuda.empty_cache()
    emit({"phase": "comm", "part": "lifecycle", "world": LIFECYCLE_WORLD, "fabric": "lambda",
          **lifecycle_check()})
    emit({"phase": "comm", "part": "wall", "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # -- 4. sim_groupby at the §IV-C size --------------------------------------
    p, rows = GROUPBY_P, GROUPBY_ROWS
    gk = torch.randint(0, GROUPS, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    gv = torch.randint(0, 100, (rows * p,), generator=gen, device=dev, dtype=torch.int32)
    expected = np.bincount(gk.cpu().numpy(), weights=gv.cpu().numpy(), minlength=GROUPS)
    expected = expected.astype(np.int64)
    for combine in (True, False):
        tables = [Table.from_dict({"k": gk[i * rows:(i + 1) * rows], "v": gv[i * rows:(i + 1) * rows]},
                                  device=dev) for i in range(p)]
        comm = make_communicator(p, "direct")
        torch.cuda.synchronize()
        reset_counters(hp_k, jp_k, sr_k, fa_k)
        t0 = time.perf_counter()
        out = ops_dist.sim_groupby(tables, "k", {"v": "sum"}, comm, combine=combine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counters(hp_k, jp_k, sr_k, fa_k)
        want_seg = 2 * p if combine else p
        if got["segment_reduce"] != want_seg or got["hash_partition"] != p:
            fail(f"groupby combine={combine} launches {got}: want segment_reduce == "
                 f"{want_seg}, hash == {p}")
        cols = [t.to_numpy() for t in out]
        k = np.concatenate([c["k"] for c in cols])
        s = np.concatenate([c["v_sum"] for c in cols])
        if not np.array_equal(np.sort(k), np.arange(GROUPS)):
            fail(f"sim_groupby combine={combine}: groups are not exactly 0..{GROUPS - 1}")
        if not np.array_equal(s.astype(np.int64), expected[k]):
            fail(f"sim_groupby combine={combine}: sums differ from np.bincount")
        run = f"groupby_combine_{str(combine).lower()}"
        for name, c in got.items():
            launches.setdefault(name, {})[run] = c
        emit({"phase": "groupby", "P": p, "rows_per_worker": rows, "groups": GROUPS,
              "combine": combine, "wall_s": wall, "bytes_on_wire": comm.bytes_on_wire,
              "comm_time_s": comm.comm_time_s, "launches": got})
        del out
        emit({"phase": "trace", "cell": run, **trace(torch, lambda: ops_dist.sim_groupby(
            tables, "k", {"v": "sum"}, make_communicator(p, "direct"), combine=combine))})
        del tables
        torch.cuda.empty_cache()

    # -- 4b. bsp: the weak-scaling join through BSPRuntime, the recovery drill ---
    t0 = time.perf_counter()
    emit({"phase": "bsp", **bsp_phase(torch, gen, dev, launches, hp_k, jp_k, sr_k, fa_k),
          "wall_s": time.perf_counter() - t0})

    # -- 4c. codec: compress=True on phase 3's join and phase 4's groupby -------
    t0 = time.perf_counter()
    emit({"phase": "codec", **codec_phase(torch, np, left, right, join_out, join_wall, gk, gv,
                                          expected, launches, hp_k, jp_k, sr_k, fa_k),
          "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # -- 4e. spmd (a): join_spmd and groupby_spmd on one NCCL rank ---------------
    import tempfile

    spmd_tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    mesh = spmd_group(torch, Path(spmd_tmp.name))
    emit({"phase": "spmd", "part": "frames", **spmd_frames_phase(
        torch, np, mesh, left[0], right[0], gk, gv, launches, hp_k, jp_k, sr_k, fa_k),
        "wall_s": time.perf_counter() - t0})
    del join_out, right, gk, gv
    torch.cuda.empty_cache()

    # -- 4d. jobs: the serverless executor on the card ----------------------------
    t0 = time.perf_counter()
    emit({"phase": "jobs", **jobs_phase(torch, np, dev, left, launches, hp_k, jp_k, sr_k, fa_k),
          "wall_s": time.perf_counter() - t0})
    del left
    torch.cuda.empty_cache()

    # -- 5. flash attention at the serving path's shapes -------------------------
    from repro_torch import configs

    scfg = configs.get(SERVE_ARCH)
    hd, nh, kvh = scfg.resolved_head_dim, scfg.num_heads, scfg.num_kv_heads
    layers = scfg.num_layers
    cache_len = SERVE_PROMPT + SERVE_NEW
    timer = Timer(torch)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def within(got, exp) -> bool:
        return bool(((got - exp).abs() <= FLASH_TOL + FLASH_TOL * exp.abs()).all())

    def flash_err(got, exp) -> float:
        err = float((got - exp).abs().max())
        if not within(got, exp):
            fail(f"flash_attention differs from the plain version: max |err| {err}")
        return err

    # the cache's layer slice [B, prompt + new, KV, hd] bfloat16; 4 copies
    # (4 x 34 MB > the L2) for the decode timings, 16 launches per event pair
    kv_copies = [(randn(SERVE_B, cache_len, kvh, hd, dtype=torch.bfloat16),
                  randn(SERVE_B, cache_len, kvh, hd, dtype=torch.bfloat16)) for _ in range(4)]
    q_prefill = randn(SERVE_B, SERVE_PROMPT, nh, hd)
    q_decode = randn(SERVE_B, 1, nh, hd)
    flash_shapes = {}
    for cell, q, window, q_offset, kv_len in (
        ("prefill_local", q_prefill, scfg.sliding_window, 0, SERVE_PROMPT),
        ("prefill_global", q_prefill, 0, 0, SERVE_PROMPT),
        ("decode", q_decode, 0, SERVE_PROMPT, SERVE_PROMPT + 1),
        ("decode_local", q_decode, scfg.sliding_window, SERVE_PROMPT, SERVE_PROMPT + 1),
    ):
        kw = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
        k, v = kv_copies[0]
        got = fa_k.flash_attention(q, k, v, **kw)
        err = flash_err(got, fa_r.attention_ref(q, k, v, **kw))
        # the limit must see one key too few: the oldest in the window, or
        # the newest in the cache
        near = dict(kw, window=window - 1) if window else dict(kw, kv_len=kv_len - 1)
        exp_near = fa_r.attention_ref(q, k, v, **near)
        if within(got, exp_near):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few ({cell})")
        one_key_off = float((got - exp_near).abs().max())
        del got, exp_near
        nbytes, ops = flash_work(torch, q, k, **kw)
        prefill = q.shape[1] * (nh // kvh) > fa_k.SPLIT_ROWS
        # the design that runs: the bf16 tensor cores at prefill (bf16 k/v),
        # float32 on the CUDA cores at decode (a byte bound either way)
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT["flash_wgmma"]) if prefill
                    else bound(nbytes, ops))
        fms, fby = bound(nbytes, ops)
        per_pair = 16 if q.shape[1] == 1 else 1
        ms = timer.ms(*rotating(lambda c, q=q, kw=kw: fa_k.flash_attention(q, *c, **kw),
                                kv_copies, per_pair))
        flash_shapes[cell] = {
            "q": list(q.shape), "kv": list(k.shape), "kv_dtype": "bfloat16", **kw,
            "design": "flash_wgmma" if prefill else "flash_decode",
            "max_abs_err": err, "one_key_off_max_abs_err": one_key_off, "ms": ms,
            "plain_ms": timer.ms(lambda q=q, kw=kw: fa_r.attention_ref(q, k, v, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, q, k, v, **kw)),
        }
        torch.cuda.empty_cache()
    # gemma3-4b's global layer at 32,768 keys (ROADMAP C 1): 512 queries at
    # q_offset 32,256 over a bf16 cache of 32,768 positions, 1,024 rows per kv
    # head (flash_wgmma, which sums each row's O over 512 key tiles); within
    # the limit and not given one key too few; also with v of mean 1, where
    # |O| ~ 1 and a bias of O toward zero would show against the limit
    lq = randn(1, 512, nh, hd)
    for v_mean in (0.0, 1.0):
        lk = randn(1, 32768, kvh, hd, dtype=torch.bfloat16)
        lv = (randn(1, 32768, kvh, hd) + v_mean).to(torch.bfloat16)
        kw = dict(causal=True, window=0, q_offset=32256, kv_len=32768)
        got = fa_k.flash_attention(lq, lk, lv, **kw)
        exp = fa_r.attention_ref(lq, lk, lv, **kw)
        err = flash_err(got, exp)
        mean_rel = float(((got - exp) * exp.sign()).mean() / exp.abs().mean())
        del exp
        exp_near = fa_r.attention_ref(lq, lk, lv, **dict(kw, kv_len=32767))
        if within(got, exp_near):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few (32k keys)")
        one_key_off = float((got - exp_near).abs().max())
        del got, exp_near
        if v_mean:
            flash_shapes["prefill_global_32k"]["v_mean_1"] = {
                "max_abs_err": err, "mean_signed_rel_err": mean_rel,
                "one_key_off_max_abs_err": one_key_off}
            continue
        nbytes, ops = flash_work(torch, lq, lk, **kw)
        bms, bby = bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT["flash_wgmma"])
        ms = timer.ms(lambda: fa_k.flash_attention(lq, lk, lv, **kw))
        flash_shapes["prefill_global_32k"] = {
            "q": list(lq.shape), "kv": list(lk.shape), "kv_dtype": "bfloat16", **kw,
            "design": "flash_wgmma", "max_abs_err": err, "mean_signed_rel_err": mean_rel,
            "one_key_off_max_abs_err": one_key_off, "ms": ms,
            "plain_ms": timer.ms(lambda: fa_r.attention_ref(lq, lk, lv, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, lq, lk, lv, **kw)),
        }
    del lq, lk, lv
    torch.cuda.empty_cache()
    # rows with no valid key (the uniform mean of v) and a softcap, through
    # the three designs (64 rows: wgmma with bf16 k/v, tiled with float32;
    # 1 row: decode), k/v in both types
    small = {}
    q_small = randn(2, 64, nh, hd)
    for kv_dtype in ("float32", "bfloat16"):
        ks = randn(2, 96, kvh, hd, dtype=getattr(torch, kv_dtype))
        vs = randn(2, 96, kvh, hd, dtype=getattr(torch, kv_dtype))
        for tq in (64, 1):
            for what, kw in (("kv_len_0", dict(kv_len=0)),
                             ("softcap_50", dict(softcap=50.0, kv_len=90, q_offset=90 - tq))):
                q = q_small[:, :tq]
                small[f"{what}_{kv_dtype}_tq{tq}"] = flash_err(
                    fa_k.flash_attention(q, ks, vs, **kw), fa_r.attention_ref(q, ks, vs, **kw))
    del ks, vs
    # the float32-k/v designs, each with its own bound: flash_wgmma_split (k,
    # v split too: six bf16 products per float32 product) at minicpm-2b's
    # train shape (with lse, as the training forward) and h2o-danube-3-4b's
    # hd 120 (q [1, 4096, 32, 120], k/v 8 heads, window 4096; there also the
    # bf16 prefill and decode designs), and flash_tiled (float32 CUDA cores)
    # at gemma3-4b's global layer with float32 k/v (its cache-free and
    # training forward); each within 2e-5, o and lse, and failing it given
    # one key too few
    hcfg = configs.get("h2o-danube-3-4b")
    tcfg = configs.get(TRAIN_ARCH)
    hd120 = {}
    for cell, b_, cfg_, window in (("train_fwd", TRAIN_B, tcfg, 0),
                                   ("h2o_hd120", 1, hcfg, hcfg.sliding_window),
                                   ("gemma3_global_f32", 1, scfg, 0)):
        fq = randn(b_, TRAIN_SEQ, cfg_.num_heads, cfg_.resolved_head_dim)
        fk, fv = (randn(b_, TRAIN_SEQ, cfg_.num_kv_heads, cfg_.resolved_head_dim)
                  for _ in range(2))
        kw = dict(causal=True, window=window)
        design = fa_k.fwd_design(cfg_.resolved_head_dim, torch.float32,
                                 TRAIN_SEQ * cfg_.num_heads // cfg_.num_kv_heads, lse=True)
        before = fa_k.fwd_design_launches[design]
        o, lse = fa_k.flash_attention_lse(fq, fk, fv, **kw)
        if fa_k.fwd_design_launches[design] != before + 1:
            fail(f"flash_attention_lse did not run {design} ({cell})")
        o_r, lse_r = fa_r.attention_lse_ref(fq, fk, fv, **kw)
        err = max(flash_err(o, o_r), flash_err(lse, lse_r))
        del o_r, lse_r
        o_n, _ = fa_r.attention_lse_ref(fq, fk, fv, causal=True, window=(window or TRAIN_SEQ) - 1)
        if within(o, o_n):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few ({cell})")
        one_key_off = float((o - o_n).abs().max())
        del o_n
        o2, lse2 = fa_k.flash_attention_lse(fq, fk, fv, **kw)
        repeat_equal = torch.equal(o, o2) and torch.equal(lse, lse2)
        if not repeat_equal:
            fail(f"flash_attention_lse is not bit-equal across two runs ({cell})")
        del o, lse, o2, lse2
        torch.cuda.empty_cache()
        full = dict(kw, q_offset=0, kv_len=TRAIN_SEQ)
        nbytes, ops = flash_work(torch, fq, fk, **full)
        nbytes += 4 * b_ * cfg_.num_heads * TRAIN_SEQ  # lse
        fms, fby = bound(nbytes, ops)
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[design])
                    if design in FLASH_SPLIT else (fms, fby))
        ms = timer.ms(lambda: fa_k.flash_attention_lse(fq, fk, fv, **kw))
        flash_shapes[cell] = {
            "q": list(fq.shape), "kv": list(fk.shape), "kv_dtype": "float32", **kw,
            "design": design + " (+ lse)", "max_abs_err": err,
            "one_key_off_max_abs_err": one_key_off, "repeat_bit_equal": repeat_equal, "ms": ms,
            "plain_ms": timer.ms(lambda: fa_r.attention_lse_ref(fq, fk, fv, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, fq, fk, fv, **full)),
        }
        if cell != "h2o_hd120":
            del fq, fk, fv
            torch.cuda.empty_cache()
            continue
        # h2o-danube's hd 120 through the bf16 prefill and the decode designs
        hd120["flash_wgmma_split"] = err
        for design, tq in (("flash_wgmma", TRAIN_SEQ), ("flash_decode", 1)):
            kw = dict(causal=True, window=window, q_offset=TRAIN_SEQ - tq, kv_len=TRAIN_SEQ)
            kk, vv = fk.to(torch.bfloat16), fv.to(torch.bfloat16)
            qq = fq[:, -tq:]
            hd120[design] = flash_err(fa_k.flash_attention(qq, kk, vv, **kw),
                                      fa_r.attention_ref(qq, kk, vv, **kw))
            if tq == 1:
                continue
            nbytes, ops = flash_work(torch, qq, kk, **kw)
            bms, bby = bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[design])
            ms = timer.ms(lambda: fa_k.flash_attention(qq, kk, vv, **kw))
            flash_shapes[f"h2o_hd120_{design}"] = {
                "q": list(qq.shape), "kv": list(kk.shape), "kv_dtype": "bfloat16", **kw,
                "design": design, "max_abs_err": hd120[design], "ms": ms,
                "plain_ms": timer.ms(lambda: fa_r.attention_ref(qq, kk, vv, **kw)),
                "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
                "bytes": nbytes, "operations": ops,
                "library_ms": timer.ms(sdpa_call(torch, qq, kk, vv, **kw)),
            }
        del fq, fk, fv, kk, vv, qq
        torch.cuda.empty_cache()
    # the families' attention shapes (phase 8b): whisper-medium's encoder over
    # its 1500 frames (non-causal, a ragged key edge: 23 x 64 + 28) and the
    # cross-attention of its 4-token prompt over them (flash_decode);
    # recurrentgemma-9b's local MQA prefill (16 query heads over 1 kv head of
    # 256, window 2048); decode at 16 rows per kv head, past SPLIT_ROWS, so in
    # flash_wgmma (qwen3-moe's 64 / 4 heads of 128 at its first decode step,
    # recurrentgemma's 16 / 1 past its window); qwen3-moe's prefill (16
    # query heads per kv head, its 2048-token prompt in a 2080-position
    # cache) and whisper's decoder self-attention over its 128-position
    # cache (the 4-token prompt, and the last decode step); the dryrun
    # phase's decode islands (RANK_DECODE_SHAPES); bf16 k/v, each within 2e-5
    # and failing it given one key too few
    for cell, q_shape, kv_shape, kw in (
        ("whisper_encoder", (4, 1500, 16, 64), (4, 1500, 16, 64),
         dict(causal=False, window=0, q_offset=0, kv_len=None)),
        ("whisper_cross", (4, 4, 16, 64), (4, 1500, 16, 64),
         dict(causal=False, window=0, q_offset=0, kv_len=None)),
        ("whisper_self_prompt", (4, 4, 16, 64), (4, 128, 16, 64),
         dict(causal=True, window=0, q_offset=0, kv_len=4)),
        ("whisper_self_decode", (4, 1, 16, 64), (4, 128, 16, 64),
         dict(causal=True, window=0, q_offset=126, kv_len=127)),
        ("qwen3_moe_prefill", (4, 2048, 64, 128), (4, 2080, 4, 128),
         dict(causal=True, window=0, q_offset=0, kv_len=2048)),
        ("griffin_local", (4, 4096, 16, 256), (4, 4096, 1, 256),
         dict(causal=True, window=2048, q_offset=0, kv_len=4096)),
        ("qwen3_moe_decode", (4, 1, 64, 128), (4, 2080, 4, 128),
         dict(causal=True, window=0, q_offset=2048, kv_len=2049)),
        ("griffin_decode", (4, 1, 16, 256), (4, 4128, 1, 256),
         dict(causal=True, window=2048, q_offset=4096, kv_len=4097)),
        *RANK_DECODE_SHAPES,
    ):
        fq = randn(*q_shape)
        copies = [(randn(*kv_shape, dtype=torch.bfloat16), randn(*kv_shape, dtype=torch.bfloat16))
                  for _ in range(4 if q_shape[1] <= 4 else 1)]
        fk, fv = copies[0]
        design = fa_k.fwd_design(q_shape[3], torch.bfloat16, q_shape[1] * q_shape[2] // kv_shape[2])
        before = fa_k.fwd_design_launches[design]
        got = fa_k.flash_attention(fq, fk, fv, **kw)
        if fa_k.fwd_design_launches[design] != before + 1:
            fail(f"flash_attention did not run {design} ({cell})")
        err = flash_err(got, fa_r.attention_ref(fq, fk, fv, **kw))
        if kw["window"]:
            near = dict(kw, window=kw["window"] - 1)
        else:
            near = dict(kw, kv_len=(kw["kv_len"] or kv_shape[1]) - 1)
        exp_near = fa_r.attention_ref(fq, fk, fv, **near)
        if within(got, exp_near):
            fail(f"flash_attention limit {FLASH_TOL} does not tell one key too few ({cell})")
        one_key_off = float((got - exp_near).abs().max())
        del got, exp_near
        nbytes, ops = flash_work(torch, fq, fk, **kw)
        bms, bby = (bound(nbytes, ops, "bf16_tensor", FLASH_SPLIT[design])
                    if design in FLASH_SPLIT else bound(nbytes, ops))
        fms, fby = bound(nbytes, ops)
        ms = timer.ms(*rotating(lambda c, q=fq, kw=kw: fa_k.flash_attention(q, *c, **kw), copies,
                                16 if q_shape[1] <= 4 else 1))
        flash_shapes[cell] = {
            "q": list(q_shape), "kv": list(kv_shape), "kv_dtype": "bfloat16", **kw,
            "design": design, "max_abs_err": err, "one_key_off_max_abs_err": one_key_off,
            "ms": ms, "plain_ms": timer.ms(lambda: fa_r.attention_ref(fq, fk, fv, **kw)),
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / ms,
            "bound_fp32_ms": fms, "bound_fp32_by": fby, "share_of_fp32_bound": fms / ms,
            "bytes": nbytes, "operations": ops,
            "library_ms": timer.ms(sdpa_call(torch, fq, fk, fv, **kw)),
        }
        del fq, fk, fv, copies
        torch.cuda.empty_cache()
    kernels["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        **flash_shapes["prefill_local"],
        "max_abs_err": max(sh["max_abs_err"] for sh in flash_shapes.values()),
        "shapes": flash_shapes,
    }
    emit({"phase": "kernel", **kernels["flash_attention"], "small_checks_max_abs_err": small,
          "hd120_max_abs_err": hd120, "tol": FLASH_TOL})
    del kv_copies, q_prefill, q_decode, q_small
    torch.cuda.empty_cache()

    # -- 6. flash attention backward at the training path's shapes ---------------
    kernels["flash_attention_bwd"] = flash_bwd_phase(torch, gen, timer, configs, fa_k, fa_r)
    emit({"phase": "kernel", **kernels["flash_attention_bwd"]})
    # -- 6b. the families' training attention: bf16 k/v with lse, the backward
    train_rows = family_train_rows(torch, gen, timer, fa_k, fa_r)
    emit({"phase": "kernel", "part": "families_train", "rows": train_rows})
    del timer
    torch.cuda.empty_cache()

    # -- 7. serve: generate on gemma3-4b at full width ---------------------------
    from repro_torch.models import api
    from repro_torch.serve import serve_step

    # the reference's float32 products; PyTorch's default, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    sgen = torch.Generator(device=dev)
    sgen.manual_seed(args.seed)
    t0 = time.perf_counter()
    params = api.init_params(scfg, sgen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, scfg.vocab_size, (SERVE_B, SERVE_PROMPT), generator=sgen,
                            device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    # the counted run is the timed run: each step's tokens reach the host as
    # a server streams them, and its logits are kept for serve_check
    step_logits, arrivals = [], []

    def on_step(tok, logits):
        tok.cpu()
        arrivals.append(time.perf_counter())
        step_logits.append(logits)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(hp_k, jp_k, sr_k, fa_k)
    t0 = time.perf_counter()
    toks, _ = serve_step.generate(scfg, params, batch, SERVE_NEW, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counters(hp_k, jp_k, sr_k, fa_k)
    peak = torch.cuda.max_memory_allocated()
    want = layers + (SERVE_NEW - 1) * layers
    if got["flash_attention"] != want:
        fail(f"serve launched flash_attention {got['flash_attention']} times, want {want}")
    for name, c in got.items():
        launches.setdefault(name, {})["serve"] = c
    ttft = arrivals[0] - t0
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
    decode_s = arrivals[-1] - arrivals[0]
    emit({"phase": "serve", "arch": SERVE_ARCH, "params": scfg.param_count(), "B": SERVE_B,
          "prompt": SERVE_PROMPT, "new": SERVE_NEW, "init_s": init_s, "wall_s": wall,
          "ttft_s": ttft, "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT / ttft,
          "decode_ms_per_step": decode_s / (SERVE_NEW - 1) * 1e3,
          "token_gap_ms_median": statistics.median(gaps) * 1e3,
          "token_gap_ms_max": max(gaps) * 1e3,
          "decode_tokens_per_s": SERVE_B * (SERVE_NEW - 1) / decode_s,
          "peak_mem_bytes": peak, "launches": got, "tokens_req0": toks[0].tolist()})
    emit({"phase": "trace", "cell": "serve", **trace(
        torch, lambda: serve_step.generate(scfg, params, batch, SERVE_NEW))})
    torch.cuda.empty_cache()

    # -- 8. serve_check ----------------------------------------------------------
    # (a) request 0's prompt + generated tokens through the cache-free
    # forward: position 4095 + i holds step i's logits (0 = prefill)
    with torch.inference_mode():
        full, _ = api.logits_fn(scfg, params, {"tokens": torch.cat([prompts[:1], toks[:1]], 1)})
        tf = full[0, SERVE_PROMPT - 1: SERVE_PROMPT - 1 + SERVE_NEW].clone()
        del full
    cached = torch.stack([lg[0] for lg in step_logits])
    err_a = (cached - tf).abs()
    if not bool((err_a <= SERVE_LOGIT_TOL + SERVE_LOGIT_TOL * tf.abs()).all()):
        fail(f"cached logits differ from the teacher-forced forward: {float(err_a.max())}")
    argmax_ok = all(torch.equal(toks[:, i], lg.argmax(-1).to(torch.int32))
                    for i, lg in enumerate(step_logits))
    if not argmax_ok:
        fail("a greedy token is not the argmax of its step's logits")
    check_a = {"positions": SERVE_PROMPT + SERVE_NEW, "max_abs_err": float(err_a.max()),
               "tol": SERVE_LOGIT_TOL, "tokens_are_argmax": argmax_ok}
    del params, step_logits, cached, tf, err_a
    torch.cuda.empty_cache()
    # (b) reduced width, 6 layers (5 local + 1 global): the card against the
    # plain versions on the CPU from the same weights
    import dataclasses

    rcfg = scfg.reduced(num_layers=6)
    rparams = api.init_params(rcfg, sgen, device=dev)
    rparams_cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
                   for k, v in rparams.items()}
    rprompt = torch.randint(0, rcfg.vocab_size, (2, 160), generator=sgen, device=dev,
                            dtype=torch.int32)
    check_b = {}
    # stock bfloat16 config through generate (bfloat16 cache)
    lg_card, lg_cpu = [], []
    t_card, _ = serve_step.generate(rcfg, rparams, {"tokens": rprompt}, 16,
                                    on_step=lambda _, lg: lg_card.append(lg))
    t_cpu, _ = serve_step.generate(rcfg, rparams_cpu, {"tokens": rprompt.cpu()}, 16,
                                   on_step=lambda _, lg: lg_cpu.append(lg))
    if not torch.equal(t_card.cpu(), t_cpu):
        fail(f"reduced generate: card tokens {t_card.tolist()} != CPU {t_cpu.tolist()}")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(lg_card, lg_cpu))
    if err > SERVE_LOGIT_TOL:
        fail(f"reduced generate: card logits differ from the CPU's by {err}")
    check_b["bfloat16_generate"] = {"max_abs_err": err, "tol": SERVE_LOGIT_TOL, "tokens": True}
    # float32 compute and a float32 cache: nothing rounds to bfloat16
    fcfg = dataclasses.replace(rcfg, dtype="float32")

    def steps(p, prompt, device):
        out_t, out_l = [], []
        with torch.inference_mode():
            st = api.init_decode_state(fcfg, 2, 176, torch.float32, device=device)
            lg, st = api.prefill_fn(fcfg, p, {"tokens": prompt}, st)
            for _ in range(16):
                t = serve_step.greedy_sample(lg)
                out_t.append(t.cpu())
                out_l.append(lg[:, -1].cpu())
                lg, st = api.decode_fn(fcfg, p, t, st)
        return torch.cat(out_t, 1), out_l

    f_card, fl_card = steps(rparams, rprompt, dev)
    f_cpu, fl_cpu = steps(rparams_cpu, rprompt.cpu(), torch.device("cpu"))
    if not torch.equal(f_card, f_cpu):
        fail("reduced float32 steps: card tokens differ from the CPU's")
    err = max(float((a - b).abs().max()) for a, b in zip(fl_card, fl_cpu))
    if any(not torch.allclose(a, b, atol=REDUCED_F32_TOL, rtol=REDUCED_F32_TOL)
           for a, b in zip(fl_card, fl_cpu)):
        fail(f"reduced float32 steps: card logits differ from the CPU's by {err}")
    check_b["float32_steps"] = {"max_abs_err": err, "tol": REDUCED_F32_TOL, "tokens": True}
    emit({"phase": "serve_check", "full_width": check_a, "reduced": check_b})
    del rparams, rparams_cpu
    torch.cuda.empty_cache()

    # -- 8b. families: qwen3-moe, rwkv6, recurrentgemma, whisper -----------------
    # the reference's bf16 products sum in float32: Griffin and Whisper
    # refuse to run on the card without this (layers.check_products)
    matmul = torch.backends.cuda.matmul
    reduced_bf16 = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    families_phase(torch, args.seed, launches, hp_k, jp_k, sr_k, fa_k)
    emit({"phase": "families_check", **families_check(torch, args.seed),
          "families_wall_s": time.perf_counter() - t0})
    # -- 8c. families_train: RWKV-6, Griffin, Whisper through make_train_step --------
    t0 = time.perf_counter()
    families_train_phase(torch, args.seed, launches, hp_k, jp_k, sr_k, fa_k, train_rows)
    emit({"phase": "families_train_check", **families_train_check(torch, args.seed),
          "families_train_wall_s": time.perf_counter() - t0})
    matmul.allow_bf16_reduced_precision_reduction = reduced_bf16
    torch.cuda.empty_cache()

    # -- 9. train: minicpm-2b at full width and depth ---------------------------
    train_phase(torch, args.seed, launches, hp_k, jp_k, sr_k, fa_k)
    torch.cuda.empty_cache()

    # -- 10. train_check ----------------------------------------------------------
    emit({"phase": "train_check", **train_check_phase(torch, args.seed)})
    torch.cuda.empty_cache()

    # -- 10b. reshard: minicpm-2b's training state restored shard by shard ---------
    emit({"phase": "reshard", **reshard_phase(torch, args.seed)})
    torch.cuda.empty_cache()

    # -- 11. spmd (b)-(e): the islands, hd 112, the dp steps, the MoE dispatch ------
    import torch.distributed as dist

    t0 = time.perf_counter()
    spmd = spmd_model_phase(torch, args.seed, mesh, launches, hp_k, jp_k, sr_k, fa_k)
    emit({"phase": "spmd", "part": "model", "backend": dist.get_backend(), **spmd,
          "wall_s": time.perf_counter() - t0})
    dist.destroy_process_group()
    spmd_tmp.cleanup()
    torch.cuda.empty_cache()

    # -- 12. kernel (6c): a tensor-parallel training rank's attention, one q head
    # a rank; after the timed end-to-end phases, which run as they ran before
    # it (its profiler sessions come after theirs)
    tp_rows = family_train_rows(torch, gen, Timer(torch), fa_k, fa_r, TP_RANK_SHAPES)
    emit({"phase": "kernel", "part": "dryrun_rank", "rows": tp_rows})
    torch.cuda.empty_cache()

    # the summary: one row per kernel, and for flash attention one per design
    # the main path runs, each at its main-path shape, then the spmd phase's
    # shapes (flash_tiled and bwd_wide run only there)
    summary = {name: kernels[name] for name in ("hash_partition", "join_probe", "segment_reduce")}
    fa, bwd = kernels["flash_attention"], kernels["flash_attention_bwd"]
    for design, shape in (("flash_wgmma", "prefill_local"), ("flash_decode", "decode"),
                          ("flash_wgmma_split", "train_fwd")):
        summary[f"flash_attention/{design}"] = {**fa, **fa["shapes"][shape],
                                                "name": f"flash_attention/{design}"}
    summary["flash_attention_bwd/bwd_wgmma"] = {**bwd, "name": "flash_attention_bwd/bwd_wgmma"}
    # the spmd phase's and the families' training shapes, each counted on its
    # own path
    for name, row in {**spmd["rows"], **train_rows, **tp_rows}.items():
        base = name.split("@")[0]
        src = bwd if base.startswith("flash_attention_bwd") else fa
        summary[name] = {**{k: src[k] for k in ("route", "source", "replaces")}, **row,
                         "name": name}
        launches[name] = {row["path"]: launches.get(base, {}).get(row["path"], 0)}
    for name, row in summary.items():
        by_path = launches.get(name, {})
        if sum(by_path.values()) <= 0:
            fail(f"kernel {name} was not launched on the main path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    # the head split and bf16 k/v as they are: recurrentgemma's training
    # backwards (one attention layer a step), and bf16 k/v also on the
    # recurrentgemma-9b dryrun rank (its groups of one head split nothing);
    # bwd_wgmma's head split on every backward of the kimi-k2 and qwen3-moe
    # ranks; bwd_wgmma on bf16 k/v on Whisper's encoder and cross-attention
    # backwards, in families_train and on the whisper-medium rank; no other
    # path (serve, train, spmd: the gemma3 islands and full layers keep the
    # whole group, kimi-k2's whole layer fills two waves, the whisper cross
    # island's k/v are float32)
    def rank_calls(cells, design):
        return sum(c["b"]["launches"].get(f"flash_attention_bwd/{design}", 0)
                   for name, c in dryrun_run["cells"].items() if name.startswith(cells))
    rank_bwd = rank_calls(("recurrentgemma-9b/",), "bwd_wide")
    split_bwd = rank_calls(DRYRUN_HEAD_SPLIT, "bwd_wgmma")
    rg = {"families_train/recurrentgemma": FAMILY_TRAIN_STEPS}
    whisper = {"families_train/whisper": dict((r[0], r[-1]) for r in FAMILY_TRAIN)["whisper"][
        "bf16_kv/bwd_wgmma"], "dryrun_rank": DRYRUN_BF16_KV_WGMMA}
    for counter, want in (("head_split/bwd_wide", rg),
                          ("bf16_kv/bwd_wide", {**rg, "dryrun_rank": rank_bwd} if rank_bwd else rg),
                          ("head_split/bwd_wgmma", {"dryrun_rank": split_bwd}),
                          ("bf16_kv/bwd_wgmma", whisper)):
        by_path = {run: n for run, n in launches.get(counter, {}).items() if n}
        if by_path != want:
            fail(f"{counter} ran on {by_path}, want {want}")
    emit({"phase": "launches", **launches})

    keys_out = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi_line(), flush=True)
    emit({"kernels": [{k: row[k] for k in keys_out} for row in summary.values()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
